"""Differentiable collectives over a mesh axis, port of the part of
fedml_tpu/collectives/ops.py (and of ``jax.lax``'s collectives) that the
sequence-parallel path needs.

Each op takes an ``AxisHandle`` (fedml_tpu_torch.mesh) where the JAX
package takes an axis name, and is a ``torch.autograd.Function`` in the
``setup_context`` form with a ``vmap`` rule: the local fit is ``vmap`` of
``grad`` (core/local.py), and c10d cannot see functorch's batched
tensors, so under ``vmap`` the rule moves the vmapped (cohort) dim to the
front and runs one exchange for the whole cohort, as the flash kernels'
rule folds it into B (ops/flash_attention.py). Each backward is itself
such a Function, so the gradient's exchange runs under ``vmap`` too.

- ``psum``: all-reduce (sum). Backward: the identity, which is JAX's
  transpose of a psum whose result is invariant along the axis (the
  sequence task's psum-ed loss).
- ``ppermute``: the ring shift, rank ``i``'s block to ``i + shift``.
  Backward: the inverse shift.
- ``all_to_all(split_axis, concat_axis)``, tiled: chunk ``j`` of
  ``split_axis`` goes to rank ``j``, the received chunks concatenate in
  rank order along ``concat_axis``. Backward: the inverse all_to_all.
- ``seq_invariant``: the identity forward, an all-reduce backward: the
  gradient psum that ``shard_map``'s transpose inserts for parameters
  invariant along the axis (fedml_tpu/core/local.py:183-186). It takes a
  dict of tensors too, and then reduces their gradients in one exchange.
- ``all_gather`` / ``shard`` (the ``*_sharded`` wrappers' boundary): the
  blocks concatenated along ``dim``, backward this rank's block of the
  (invariant) cotangent; and the converse.

The transport follows the group's backend. NCCL takes CUDA tensors as
they are; gloo takes CPU tensors as they are (the CPU tests). Gloo given
CUDA tensors means several ranks share one card, as on a one-GPU machine,
where NCCL refuses two ranks on one device and gloo has no CUDA send /
recv or all_to_all: the exchange then goes through host memory (copied
out, exchanged, copied back). Nothing catches an error to switch
transport.

Every exchange adds its host wall time (staging included) to
``COMM_SECONDS``, by op. A host-staged exchange first waits for the work
already queued on the card (its copy to the host would wait for it
anyway); that wait is device compute, not exchange, and is added to
``COMM_SECONDS["drain"]`` instead.
"""

from __future__ import annotations

import contextlib
import time

import torch
import torch.distributed as dist

COMM_SECONDS = {"psum": 0.0, "ppermute": 0.0, "all_to_all": 0.0,
                "all_gather": 0.0, "drain": 0.0}


def reset_comm_stats() -> None:
    for k in COMM_SECONDS:
        COMM_SECONDS[k] = 0.0


def _staged(axis, t):
    """(tensor to hand c10d, device to copy the result back to or None):
    host staging only for CUDA tensors over gloo (see module docstring)."""
    if t.is_cuda and axis.backend == "gloo":
        return t.detach().cpu().contiguous(), t.device
    return t.detach().contiguous(), None


@contextlib.contextmanager
def _timed(op, axis, t):
    if t.is_cuda and axis.backend == "gloo":
        t0 = time.perf_counter()
        torch.cuda.synchronize(t.device)
        COMM_SECONDS["drain"] += time.perf_counter() - t0
    t0 = time.perf_counter()
    try:
        yield
    finally:
        COMM_SECONDS[op] += time.perf_counter() - t0


# ------------------------------------------------------------ transports
def _all_reduce(x, axis):
    if axis.size == 1:
        return x.clone()
    with _timed("psum", axis, x):
        buf, back = _staged(axis, x)
        buf = buf.clone() if back is None else buf
        dist.all_reduce(buf, group=axis.group)
        return buf if back is None else buf.to(back)


def _shift(x, axis, shift):
    n = axis.size
    if n == 1 or shift % n == 0:
        return x.clone()
    with _timed("ppermute", axis, x):
        buf, back = _staged(axis, x)
        out = torch.empty_like(buf)
        i = axis.index
        ops = [dist.P2POp(dist.isend, buf, axis.ranks[(i + shift) % n],
                          axis.group),
               dist.P2POp(dist.irecv, out, axis.ranks[(i - shift) % n],
                          axis.group)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return out if back is None else out.to(back)


def _exchange(x, axis, split_axis, concat_axis):
    n = axis.size
    if n == 1:
        return x.clone()
    if x.shape[split_axis] % n:
        raise ValueError(f"all_to_all: dim {split_axis} of {tuple(x.shape)} "
                         f"does not split over {n} ranks of {axis.name!r}")
    with _timed("all_to_all", axis, x):
        buf, back = _staged(axis, x)
        send = torch.stack(buf.chunk(n, split_axis))  # [n, ...chunk]
        recv = torch.empty_like(send)
        dist.all_to_all_single(recv, send, group=axis.group)
        out = torch.cat(recv.unbind(0), dim=concat_axis)
        return out if back is None else out.to(back)


def _gather(x, axis, dim):
    if axis.size == 1:
        return x.clone()
    with _timed("all_gather", axis, x):
        buf, back = _staged(axis, x)
        parts = [torch.empty_like(buf) for _ in range(axis.size)]
        dist.all_gather(parts, buf, group=axis.group)
        out = torch.cat(parts, dim=dim)
        return out if back is None else out.to(back)


def _block(x, axis, dim):
    return x.chunk(axis.size, dim)[axis.index].clone()


def _front(info, in_dim, x):
    """The vmap rule's input side: the vmapped dim first (an unbatched
    input expanded over the batch)."""
    return (x.expand(info.batch_size, *x.shape) if in_dim is None
            else x.movedim(in_dim, 0))


# -------------------------------------------------------------- functions
class _GradPsum(torch.autograd.Function):
    """The identity forward, an all-reduce of the gradients backward (one
    exchange for every tensor)."""

    @staticmethod
    def forward(axis, *xs):
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.axis = inputs[0]

    @staticmethod
    def backward(ctx, *gs):
        return (None, *_Psum.apply(ctx.axis, *gs))

    @staticmethod
    def vmap(info, in_dims, axis, *xs):
        xs = [_front(info, d, x) for d, x in zip(in_dims[1:], xs)]
        return _GradPsum.apply(axis, *xs), (0,) * len(xs)


class _Psum(torch.autograd.Function):
    """All-reduce one or several tensors in one exchange (flattened into
    one buffer); the backward is the identity."""

    @staticmethod
    def forward(axis, *xs):
        flat = torch.cat([x.reshape(-1) for x in xs])
        out = _all_reduce(flat, axis).split([x.numel() for x in xs])
        return tuple(o.view_as(x) for o, x in zip(out, xs))

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, *gs):
        return (None, *gs)

    @staticmethod
    def vmap(info, in_dims, axis, *xs):
        xs = [_front(info, d, x) for d, x in zip(in_dims[1:], xs)]
        return _Psum.apply(axis, *xs), (0,) * len(xs)


class _Ppermute(torch.autograd.Function):
    @staticmethod
    def forward(x, axis, shift):
        return _shift(x, axis, shift)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.axis, ctx.shift = inputs[1], inputs[2]

    @staticmethod
    def backward(ctx, g):
        return _Ppermute.apply(g, ctx.axis, -ctx.shift), None, None

    @staticmethod
    def vmap(info, in_dims, x, axis, shift):
        return _Ppermute.apply(_front(info, in_dims[0], x), axis, shift), 0


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(x, axis, split_axis, concat_axis):
        return _exchange(x, axis, split_axis, concat_axis)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.axis, ctx.split, ctx.concat = inputs[1:]

    @staticmethod
    def backward(ctx, g):
        return (_AllToAll.apply(g, ctx.axis, ctx.concat, ctx.split),
                None, None, None)

    @staticmethod
    def vmap(info, in_dims, x, axis, split_axis, concat_axis):
        out = _AllToAll.apply(_front(info, in_dims[0], x), axis,
                              split_axis + 1, concat_axis + 1)
        return out, 0


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(x, axis, dim):
        return _gather(x, axis, dim)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.axis, ctx.dim = inputs[1], inputs[2]

    @staticmethod
    def backward(ctx, g):
        return _Shard.apply(g, ctx.axis, ctx.dim), None, None

    @staticmethod
    def vmap(info, in_dims, x, axis, dim):
        return _AllGather.apply(_front(info, in_dims[0], x), axis, dim + 1), 0


class _Shard(torch.autograd.Function):
    @staticmethod
    def forward(x, axis, dim):
        return _block(x, axis, dim)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.axis, ctx.dim = inputs[1], inputs[2]

    @staticmethod
    def backward(ctx, g):
        return _AllGather.apply(g, ctx.axis, ctx.dim), None, None

    @staticmethod
    def vmap(info, in_dims, x, axis, dim):
        return _Shard.apply(_front(info, in_dims[0], x), axis, dim + 1), 0


# ----------------------------------------------------------------- public
def psum(x, axis):
    """Sum of ``x`` over the ranks of ``axis``; gradient: the identity."""
    return _Psum.apply(axis, x)[0]


def ppermute(x, axis, shift: int = 1):
    """Ring shift: rank ``i`` receives rank ``i - shift``'s ``x``."""
    return _Ppermute.apply(x, axis, shift)


def all_to_all(x, axis, split_axis: int, concat_axis: int):
    """``lax.all_to_all(x, axis, split_axis, concat_axis, tiled=True)``."""
    return _AllToAll.apply(x, axis, split_axis, concat_axis)


def seq_invariant(x, axis):
    """``x`` (a tensor or a dict of tensors) as it is; its gradient summed
    over ``axis`` (one exchange for a whole dict)."""
    if isinstance(x, dict):
        keys = list(x)
        return dict(zip(keys, _GradPsum.apply(axis, *(x[k] for k in keys))))
    return _GradPsum.apply(axis, x)[0]


def all_gather(x, axis, dim: int):
    """The ranks' blocks concatenated along ``dim``, in axis order; the
    gradient is this rank's block of a cotangent invariant along the axis
    (the ``*_sharded`` wrappers' output boundary)."""
    return _AllGather.apply(x, axis, dim)


def shard(x, axis, dim: int):
    """This rank's block of ``x`` along ``dim``; the gradient is the
    gathered blocks' gradients (the ``*_sharded`` wrappers' input
    boundary: ``x`` is the same on every rank)."""
    return _Shard.apply(x, axis, dim)
