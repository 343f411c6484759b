"""Ring attention + Ulysses sequence parallelism over a mesh axis, port of
fedml_tpu/parallel/ring_attention.py over ``torch.distributed``.

Ring attention (Liu et al.): Q stays put; K/V blocks rotate around the
ring (``ppermute``, fedml_tpu_torch.collectives.ops) while each rank
accumulates its queries' attention with a numerically stable online
softmax. After N steps every query has attended to every key with O(T/N)
memory per rank. Ulysses swaps the sharded axis from sequence to heads
(``all_to_all``), attends over the full sequence for H/N heads, and swaps
back.

The JAX package calls these inside ``shard_map`` with an axis name; the
port calls them on every rank of a world with the axis's handle
(fedml_tpu_torch.mesh.AxisHandle), q/k/v being the rank's sequence block.
The ``*_sharded`` wrappers take the full tensors on every rank, as a
``shard_map`` with ``in_specs=P(None, axis)`` does, and return the full
output (all-gathered).

The flash variants run the hand-written kernels
(fedml_tpu_torch.ops.flash_attention): on a CUDA tensor they launch them,
on a CPU tensor their plain twins. The kernels take no ``block_q`` /
``block_k`` (their tiles are fixed per head dim), so neither do these.

Masking and merging use guarded ``torch.where`` forms throughout: a
``-inf - -inf`` in a branch ``where`` does not take is NaN, and its
backward (0 x NaN) would poison the gradient, so every exponent is made
finite before the ``exp``.

Layouts: block tensors are [B, T_blk, H, D]; scores are [B, H, Tq, Tk].
"""

from __future__ import annotations

import math

import torch

from fedml_tpu_torch.collectives.ops import (
    all_gather,
    all_to_all,
    ppermute,
    shard,
)

NEG_INF = float("-inf")


def full_attention(q, k, v, causal: bool = False):
    """Single-device reference: softmax(QK^T/sqrt(d))V. [B, T, H, D] in/out."""
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(q.shape[-1])
    if causal:
        T, S = scores.shape[-2], scores.shape[-1]
        ok = torch.ones(T, S, dtype=torch.bool, device=q.device).tril()
        scores = scores.masked_fill(~ok, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)


def _online_block_update(q, k, v, o, l, m, q_offset, k_offset, causal,
                         scale):
    """One flash-attention style block accumulation step."""
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale  # [B,H,Tq,Tk]
    if causal:
        Tq, Tk = scores.shape[-2], scores.shape[-1]
        qpos = q_offset + torch.arange(Tq, device=q.device)[:, None]
        kpos = k_offset + torch.arange(Tk, device=q.device)[None, :]
        scores = scores.masked_fill(kpos > qpos, NEG_INF)
    m_new = torch.maximum(m, scores.amax(-1))               # [B,H,Tq]
    # fully masked rows: exp(-inf - -inf) -> 0, with every exponent finite
    safe_m = torch.where(torch.isfinite(m_new), m_new, 0.0)
    p = torch.exp(torch.where(torch.isfinite(scores),
                              scores - safe_m[..., None], NEG_INF))
    corr = torch.exp(m - safe_m)  # 0 where m is -inf; safe_m is finite
    l_new = l * corr + p.sum(-1)
    o_new = (o * corr.transpose(1, 2)[..., None]
             + torch.einsum("bhqk,bkhd->bqhd", p, v))
    return o_new, l_new, m_new


def ring_attention(q, k, v, axis, causal: bool = False):
    """q/k/v are this rank's sequence block [B, T_blk, H, D] along
    ``axis``; returns the attention output for the local queries."""
    n, idx = axis.size, axis.index
    T_blk = q.shape[1]
    scale = 1.0 / math.sqrt(q.shape[-1])
    B, H = q.shape[0], q.shape[2]
    o = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    l = torch.zeros(B, H, T_blk, dtype=torch.float32, device=q.device)
    m = torch.full((B, H, T_blk), NEG_INF, dtype=torch.float32,
                   device=q.device)
    qf = q.float()
    for s in range(n):
        src = (idx - s) % n  # whose block this rank holds at step s
        o, l, m = _online_block_update(qf, k.float(), v.float(), o, l, m,
                                       idx * T_blk, src * T_blk, causal,
                                       scale)
        if s != n - 1:  # the last rotation would only bring them home
            k = ppermute(k, axis)
            v = ppermute(v, axis)
    l_safe = l.clamp_min(1e-20)
    return (o / l_safe.transpose(1, 2)[..., None]).to(q.dtype)


def ulysses_attention(q, k, v, axis, causal: bool = False,
                      use_flash: bool = False):
    """DeepSpeed-Ulysses: all_to_all swaps the sharded axis from sequence
    to heads, each rank computes FULL-sequence attention for H/N heads,
    then swaps back. Requires H % axis.size == 0. ``use_flash`` runs the
    per-rank attention through the flash kernels: O(T) memory for the
    long sequence each rank now holds."""
    # [B, T/N, H, D] -> all_to_all on H -> [B, T, H/N, D]
    qh, kh, vh = (all_to_all(x, axis, split_axis=2, concat_axis=1)
                  for x in (q, k, v))
    if use_flash:
        from fedml_tpu_torch.ops.flash_attention import flash_attention

        oh = flash_attention(qh, kh, vh, causal)
    else:
        oh = full_attention(qh, kh, vh, causal=causal)
    return all_to_all(oh, axis, split_axis=1, concat_axis=2)


def _logaddexp(a, b):
    """log(exp(a) + exp(b)) with a NaN-free gradient where both are -inf
    (torch.logaddexp's backward takes exp(-inf - -inf) there)."""
    mx = torch.maximum(a, b)
    fin = torch.isfinite(mx)
    ms = torch.where(fin, mx, 0.0)
    s = torch.exp(a - ms) + torch.exp(b - ms)
    return torch.where(fin, ms + torch.log(torch.where(fin, s, 1.0)), mx)


def _merge(o, lse, o_b, lse_b):
    """Merge a block's (o_b, lse_b) into the running (o, lse) by logsumexp
    weighting."""
    lse_new = _logaddexp(lse, lse_b)
    fin = torch.isfinite(lse_new)
    base = torch.where(fin, lse_new, 0.0)

    def w(a):  # exp(a - lse_new), 0 where lse_new is -inf; [B,H,Tq]
        return torch.where(fin, torch.exp(a - base), 0.0)

    # weights are [B, H, Tq] -> broadcast over [B, Tq, H, D]
    bc = lambda t: t.transpose(1, 2)[..., None]  # noqa: E731
    return bc(w(lse)) * o + bc(w(lse_b)) * o_b.float(), lse_new


def ring_attention_flash(q, k, v, axis, causal: bool = False):
    """Ring attention with the flash kernels as the per-step block op.

    Same contract as ``ring_attention``. Each rotation computes this
    rank's queries against the currently held K/V block with
    ``flash_attention_with_lse``, then merges into the running result by
    logsumexp weighting:

        lse' = logaddexp(lse, lse_b)
        o'   = exp(lse - lse')*o + exp(lse_b - lse')*o_b

    Causality across blocks is positional: the s=0 rotation (own block)
    uses the kernel's causal mask; for s>0 the block runs the non-causal
    kernel and contributes iff its ring source precedes this rank (src <
    idx), else its lse is -inf and the merge is a no-op. Gradients are
    exact: the lse output carries a true cotangent into the backward
    kernels."""
    from fedml_tpu_torch.ops.flash_attention import flash_attention_with_lse

    n, idx = axis.size, axis.index
    o = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    lse = torch.full((q.shape[0], q.shape[2], q.shape[1]), NEG_INF,
                     dtype=torch.float32, device=q.device)
    kk, vv = k, v
    for s in range(n):
        if s == 0:
            o_b, lse_b = flash_attention_with_lse(q, kk, vv, causal)
        else:
            o_b, lse_b = flash_attention_with_lse(q, kk, vv, False)
            if causal:
                src = (idx - s) % n
                if not src < idx:
                    lse_b = torch.full_like(lse_b, NEG_INF)
        o, lse = _merge(o, lse, o_b, lse_b)
        if s != n - 1:
            kk = ppermute(kk, axis)
            vv = ppermute(vv, axis)
    return o.to(q.dtype)


def _sharded(f, axis, **kw):
    """The ``shard_map(f, in_specs=P(None, axis), out_specs=P(None,
    axis))`` of the reference: full [B, T, H, D] tensors in (the same on
    every rank), this rank's T block to ``f``, the full output out."""

    def run(q, k, v):
        blocks = (shard(x, axis, 1) for x in (q, k, v))
        return all_gather(f(*blocks, axis, **kw), axis, 1)

    return run


def ring_attention_sharded(mesh, axis_name: str = "seq",
                           causal: bool = False):
    """Ring attention over the full tensors (see ``_sharded``)."""
    return _sharded(ring_attention, mesh[axis_name], causal=causal)


def ulysses_attention_sharded(mesh, axis_name: str = "seq",
                              causal: bool = False, use_flash: bool = False):
    return _sharded(ulysses_attention, mesh[axis_name], causal=causal,
                    use_flash=use_flash)


def ring_attention_flash_sharded(mesh, axis_name: str = "seq",
                                 causal: bool = False):
    return _sharded(ring_attention_flash, mesh[axis_name], causal=causal)
