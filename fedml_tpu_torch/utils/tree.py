"""State-dict bookkeeping, port of fedml_tpu/utils/tree.py.

The JAX package maps over pytrees; here a model state is a dict of tensors
(a ``state_dict``), and a stacked state holds a leading client axis on
every entry.

``tree_vectorize`` flattens a state into ONE vector in the JAX package's
coordinate order: its flax params (``convert.to_flax_net``: HWIO convolution
kernels, ``[in, out]`` dense kernels, the first dense layer's rows in NHWC
order) raveled leaf by leaf in sorted-path order, then its extras
(BatchNorm statistics) likewise, as ``jax.tree.leaves`` flattens a
``NetState`` (comm/message.net_items). Coordinate k of a port vector is then coordinate k of the
JAX package's vector for the same model, so a flat vector that crosses the
wire (a masked upload) means the same thing to both. The layout change is
one gather over the port's concatenated entries, computed once per model
shape from ``net_items`` of an index-valued state.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def tree_weighted_mean(stacked: dict, weights: torch.Tensor) -> dict:
    """Weighted mean over the leading axis of a stacked state dict.

    ``stacked`` entries have shape [K, ...]; ``weights`` has shape [K] and
    is normalized here, so callers pass raw sample counts (the server's
    per-key weighted average, reference FedAVGAggregator.py:72-80)."""
    w = weights / weights.sum().clamp_min(1e-12)
    return {k: torch.tensordot(w.to(x.dtype), x, dims=([0], [0]))
            for k, x in stacked.items()}


@functools.lru_cache(maxsize=8)
def _flax_order(shapes: tuple, num_heads: int | None) -> np.ndarray:
    """For a state with these sorted ``(key, shape)`` entries: the index,
    into the concatenation of its raveled entries in sorted-key order, of
    each coordinate of the flax-ordered vector (int64)."""
    from fedml_tpu_torch.comm.message import net_items

    state, start = {}, 0
    for key, shape in shapes:
        n = int(np.prod(shape, dtype=np.int64))
        state[key] = torch.arange(start, start + n,
                                  dtype=torch.float64).reshape(shape)
        start += n
    flat = [np.asarray(leaf).reshape(-1)
            for _, leaf in net_items(state, num_heads)]
    order = (np.concatenate(flat) if flat
             else np.zeros(0)).astype(np.int64)
    if not np.array_equal(np.sort(order), np.arange(start)):
        raise ValueError("to_flax_net does not permute this state's "
                         "entries")
    return order


def _order_for(state: dict, lead: int, num_heads, device) -> torch.Tensor:
    shapes = tuple((k, tuple(v.shape[lead:])) for k, v in sorted(state.items()))
    return torch.from_numpy(_flax_order(shapes, num_heads)).to(device)


def tree_vectorize(state: dict, num_heads: int | None = None,
                   stacked: bool = False) -> torch.Tensor:
    """The state as one vector in the JAX package's coordinate order (see
    the module docstring), on the state's device in its dtype. With
    ``stacked`` every entry carries a leading client axis and the result
    is ``[K, n]``. A TransformerLM needs its ``num_heads``."""
    lead = 1 if stacked else 0
    items = sorted(state.items())
    dev = items[0][1].device
    flat = torch.cat([v.reshape(v.shape[:lead] + (-1,)) for _, v in items],
                     dim=lead)
    return flat.index_select(lead, _order_for(state, lead, num_heads, dev))


def tree_unvectorize(vec: torch.Tensor, like: dict,
                     num_heads: int | None = None) -> dict:
    """Inverse of :func:`tree_vectorize` given a template state ``like``:
    each entry in ``like``'s shape and dtype, on ``vec``'s device."""
    order = _order_for(like, 0, num_heads, vec.device)
    port = torch.empty_like(vec)
    port[order] = vec
    out, start = {}, 0
    for key, v in sorted(like.items()):
        n = v.numel()
        out[key] = port[start:start + n].reshape(v.shape).to(v.dtype)
        start += n
    return {k: out[k] for k in like}
