"""flax's per-layer dtype promotion, for models whose params may arrive in
bfloat16 (the bf16 client-compute policy, core/local.py).

A flax layer computes in ``dtype`` when one is set, and otherwise in the
promoted type of its input and its params (``flax.linen.dtypes.
promote_dtype``): an f32 input against bf16 weights computes in f32 on the
bf16-rounded weights. ``F.conv2d`` / ``F.linear`` refuse mixed dtypes, so
a port layer promotes each (input, weight, bias) group itself first. With
every tensor f32 and no ``dtype`` the casts return their inputs: the f32
path runs the ops it ran before the policy existed.
"""

from __future__ import annotations

import torch


def promote_dtype(*tensors, dtype: torch.dtype | None = None) -> list:
    """``tensors`` (None entries pass through) cast to ``dtype``, or to
    their promoted type when ``dtype`` is None."""
    live = [t for t in tensors if t is not None]
    if dtype is None:
        dtype = live[0].dtype
        for t in live[1:]:
            dtype = torch.promote_types(dtype, t.dtype)
    return [None if t is None else t.to(dtype) for t in tensors]
