"""Flash attention (forward + backward) as hand-written CUDA kernels.

Port of fedml_tpu/ops/flash_attention.py. The three Pallas TPU kernels
(_fwd_kernel, _bwd_dq_kernel, _bwd_dkv_kernel) become the three CUDA kernels
of ``csrc/flash_attention.cu``; ``jax.custom_vjp`` becomes
``torch.autograd.Function``.

Layout: [B, T, H, D] in and out, as in the JAX package, and lse is
[B, H, T]. The kernels index that layout with strides and mask the ragged
edge themselves, so no transpose or padding copy surrounds them. The JAX
functions' ``block_q`` / ``block_k`` (TPU tile sizes) have no counterpart:
the CUDA kernels' 64-row tiles are compile-time constants.

The autograd functions run under ``torch.func`` (``grad``, ``vmap``): under
vmap the cohort dimension is folded into B, so one launch serves the whole
cohort. Dispatch is by the tensor's device: a CPU tensor runs the plain
PyTorch version below (``dense_fwd`` / ``dense_bwd_dq`` / ``dense_bwd_dkv``,
the ports of the JAX package's jnp twins and the kernels' oracle); a CUDA
tensor launches the kernel or raises. Every kernel wrapper counts its
launches in ``LAUNCHES``.
"""

from __future__ import annotations

import ctypes

import torch

NEG_INF = -1e30
HEAD_DIMS = (16, 32, 64, 128)  # the head dims the kernels are built for

# kernel name -> launches since the last reset_launches()
LAUNCHES = {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "flash_attention_fwd": [_P] * 5 + [_I] * 5 + [ctypes.c_float, _P],
    "flash_attention_bwd_dq": [_P] * 7 + [_I] * 5 + [ctypes.c_float, _P],
    "flash_attention_bwd_dkv": [_P] * 8 + [_I] * 5 + [ctypes.c_float, _P],
}
_lib = None


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _kernels():
    global _lib
    if _lib is None:
        from fedml_tpu_torch.ops.loader import load_library

        lib = load_library("flash_attention.cu")
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _scale(D: int) -> float:
    return 1.0 / (D ** 0.5)


# ------------------------------------------------------------ plain versions
def _masked_scores(q, k, causal):
    """f32 scores [B, H, Tq, Tk] * 1/sqrt(D), masked to NEG_INF above the
    causal diagonal — the kernels' _mask on unpadded tensors."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * _scale(q.shape[-1])
    if causal:
        T = q.shape[1]
        ok = torch.ones(T, T, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~ok, NEG_INF)
    return s


def dense_fwd(q, k, v, causal: bool):
    """Plain version of the forward kernel: (o [B,T,H,D], lse [B,H,T] f32),
    with the kernels' l_safe floor and lse = m + log(l) definition."""
    s = _masked_scores(q, k, causal)
    m = s.amax(-1)
    p = torch.exp(s - m[..., None])
    l_safe = p.sum(-1).clamp_min(1e-30)
    o = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    o = o / l_safe.transpose(1, 2)[..., None]
    return o.to(q.dtype), m + torch.log(l_safe)


def _dense_ds(q, k, v, do, lse, corr, causal):
    """P = exp(S - lse) and dS = P * (dO V^T + corr), [B, H, Tq, Tk]."""
    p = torch.exp(_masked_scores(q, k, causal) - lse[..., None])
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
    return p, p * (dp + corr[..., None])


def dense_bwd_dq(q, k, v, do, lse, corr, causal: bool):
    """Plain version of the dQ kernel. ``corr`` = lse cotangent - delta,
    [B, H, T]."""
    _, ds = _dense_ds(q, k, v, do, lse, corr, causal)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k.float()) * _scale(q.shape[-1])
    return dq.to(q.dtype)


def dense_bwd_dkv(q, k, v, do, lse, corr, causal: bool):
    """Plain version of the dK/dV kernel."""
    p, ds = _dense_ds(q, k, v, do, lse, corr, causal)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, do.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float()) * _scale(q.shape[-1])
    return dk.to(k.dtype), dv.to(v.dtype)


# ------------------------------------------------------------ kernel wrappers
def _check(name, *tensors):
    B, T, H, D = tensors[0].shape
    for t in tensors:
        if not t.is_cuda or t.device != tensors[0].device:
            raise ValueError(f"{name}: every tensor must be on one CUDA device")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: float32 only, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
    for t in tensors[1:]:
        if t.shape not in (tensors[0].shape, (B, H, T)):
            raise ValueError(f"{name}: shape {tuple(t.shape)} does not match "
                             f"[B,T,H,D]={tuple(tensors[0].shape)}")
    if D not in HEAD_DIMS:
        raise ValueError(f"{name}: head dim {D} not in {HEAD_DIMS}")
    if -(-T // 64) > 65535:  # the grid is (B*H, 64-row tiles); its y is ≤ 65535
        raise ValueError(f"{name}: T={T} needs {-(-T // 64)} 64-row tiles, "
                         "more than the grid's 65535")
    return B, T, H, D


def _check_aligned(name, *tensors):
    """The kernels copy [B,T,H,D] rows 16 bytes a thread (cp.async) and
    store 8: a view off a 16-byte boundary must raise here, not fault on
    the card."""
    for t in tensors:
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: [B,T,H,D] tensors must start on a "
                             f"16-byte boundary (storage offset "
                             f"{t.storage_offset()})")


def _launch(name, fn, tensors, dims, causal):
    B, T, H, D = dims
    with torch.cuda.device(tensors[0].device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(*(t.data_ptr() for t in tensors), B, T, H, D, int(causal),
                 _scale(D), stream)
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed (cudaError {err})")
    LAUNCHES[name] += 1


def flash_fwd(q, k, v, causal: bool):
    """Forward kernel: (o [B,T,H,D], lse [B,H,T]) for CUDA float32 q/k/v."""
    dims = _check("flash_fwd", q, k, v)
    _check_aligned("flash_fwd", q, k, v)
    B, T, H, _ = dims
    o = torch.empty_like(q)
    lse = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    _launch("flash_fwd", _kernels().flash_attention_fwd, (q, k, v, o, lse),
            dims, causal)
    return o, lse


def flash_bwd_dq(q, k, v, do, lse, corr, causal: bool):
    """dQ kernel."""
    dims = _check("flash_bwd_dq", q, k, v, do, lse, corr)
    _check_aligned("flash_bwd_dq", q, k, v, do)
    dq = torch.empty_like(q)
    _launch("flash_bwd_dq", _kernels().flash_attention_bwd_dq,
            (q, k, v, do, lse, corr, dq), dims, causal)
    return dq


def flash_bwd_dkv(q, k, v, do, lse, corr, causal: bool):
    """dK/dV kernel."""
    dims = _check("flash_bwd_dkv", q, k, v, do, lse, corr)
    _check_aligned("flash_bwd_dkv", q, k, v, do)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch("flash_bwd_dkv", _kernels().flash_attention_bwd_dkv,
            (q, k, v, do, lse, corr, dk, dv), dims, causal)
    return dk, dv


def _on_cpu(t) -> bool:
    if t.is_cuda:
        return False
    if t.device.type != "cpu":
        raise ValueError(f"flash attention runs on CUDA or the CPU, not "
                         f"{t.device}")
    return True


# ------------------------------------------------------------------ public
def _fold(info, in_dims, tensors):
    """The vmap rule's input side: move each tensor's vmapped dim to the
    front (expanding an unbatched one) and fold it into B, so the kernels
    see [K*B, T, H, D] / [K*B, H, T] plain contiguous tensors; JAX's
    pallas_call batching rule adds a grid axis to the same effect."""
    K = info.batch_size
    out = []
    for t, d in zip(tensors, in_dims):
        t = t.expand(K, *t.shape) if d is None else t.movedim(d, 0)
        out.append(t.reshape(K * t.shape[1], *t.shape[2:]).contiguous())
    return out, K


def _unfold(t, K):
    return t.view(K, t.shape[0] // K, *t.shape[1:])


class FlashAttention(torch.autograd.Function):
    """(out, lse) with a true cotangent for lse: the backward folds it into
    dS = P * (dP + g_lse - delta), as the JAX package's custom_vjp does.

    Written in the ``setup_context`` form with a ``vmap`` rule, so it runs
    under ``torch.func`` (the local fit is ``vmap`` of ``grad``): under
    vmap, the cohort dimension is folded into B and the kernels launch once
    for the whole cohort. The backward goes through ``FlashAttentionBwd``,
    which has its own vmap rule, so the kernels only ever see plain CUDA
    tensors, never functorch's wrappers."""

    @staticmethod
    def forward(q, k, v, causal):
        if _on_cpu(q):
            return dense_fwd(q, k, v, causal)
        return flash_fwd(q, k, v, causal)

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, causal = inputs
        o, lse = output
        ctx.causal = causal
        ctx.save_for_backward(q, k, v, o, lse)

    @staticmethod
    def backward(ctx, g, g_lse):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = FlashAttentionBwd.apply(q, k, v, o, lse, g, g_lse,
                                             ctx.causal)
        return dq, dk, dv, None

    @staticmethod
    def vmap(info, in_dims, q, k, v, causal):
        (q, k, v), K = _fold(info, in_dims[:3], (q, k, v))
        o, lse = FlashAttention.apply(q, k, v, causal)
        return (_unfold(o, K), _unfold(lse, K)), (0, 0)


class FlashAttentionBwd(torch.autograd.Function):
    """The backward kernels as a function of (q, k, v, o, lse, dO, g_lse):
    (dQ, dK, dV). Not differentiable again; its vmap rule folds the cohort
    into B as FlashAttention's does."""

    @staticmethod
    def forward(q, k, v, o, lse, g, g_lse, causal):
        g = g.contiguous()
        # delta_i = sum_d dO_i O_i, the rowwise correction of the softmax vjp
        delta = (g.float() * o.float()).sum(-1).transpose(1, 2)
        corr = (g_lse.float() - delta).contiguous()
        if _on_cpu(q):
            dq = dense_bwd_dq(q, k, v, g, lse, corr, causal)
            dk, dv = dense_bwd_dkv(q, k, v, g, lse, corr, causal)
        else:
            dq = flash_bwd_dq(q, k, v, g, lse, corr, causal)
            dk, dv = flash_bwd_dkv(q, k, v, g, lse, corr, causal)
        return dq, dk, dv

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError("flash attention has no second derivative")

    @staticmethod
    def vmap(info, in_dims, q, k, v, o, lse, g, g_lse, causal):
        folded, K = _fold(info, in_dims[:7], (q, k, v, o, lse, g, g_lse))
        grads = FlashAttentionBwd.apply(*folded, causal)
        return tuple(_unfold(t, K) for t in grads), (0, 0, 0)


def flash_attention_with_lse(q, k, v, causal: bool = False):
    """Flash attention returning (out [B,T,H,D], lse [B,H,T]); lse carries a
    gradient, so a ring merge of partial results stays exact."""
    return FlashAttention.apply(q, k, v, causal)


def flash_attention(q, k, v, causal: bool = False):
    """softmax(QK^T/sqrt(D))V with O(T) memory. [B, T, H, D] in/out; any T."""
    return FlashAttention.apply(q, k, v, causal)[0]
