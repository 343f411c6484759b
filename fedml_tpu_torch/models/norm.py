"""BatchNorm and GroupNorm with flax's semantics, port of
fedml_tpu/models/norm.py and of the flax layers the JAX package's ResNets
build on.

Both are plain tensor ops over a channels-first input ``[N, C, ...]``, so
they run unchanged under the cohort's ``torch.func.vmap`` (``F.batch_norm``
with running buffers refuses there: it updates them in place). flax's
arithmetic, which differs from torch's layers:

- statistics in (at least) float32, ``var = E[x^2] - E[x]^2`` clipped at 0
  (flax's ``use_fast_variance``), the biased variance;
- ``y = (x - mean) * (rsqrt(var + eps) * scale) + bias``, cast to the
  layer's ``dtype`` (else the promoted type of input, scale and bias);
- BatchNorm's running statistics ``ra = momentum * ra + (1 - momentum) *
  batch`` (momentum 0.9: torch's convention is the other way round, and
  torch feeds ``running_var`` the unbiased variance); they are returned,
  not written: in train mode the layer puts the new values into the
  ``stats`` dict under its buffer names (``mean`` / ``var``), which the
  task hands back to the fit as the new extras;
- GroupNorm's eps is flax's default 1e-6 (torch's is 1e-5).

BatchNorm's statistics cover every row of the batch, padded rows
included, whatever the loss mask says: the JAX package's BatchNorm sees
the whole padded batch too, and both data planes zero the padding.
"""

from __future__ import annotations

import torch
from torch import nn

from fedml_tpu_torch.models.dtypes import promote_dtype


def _stats(x: torch.Tensor, dims) -> tuple:
    """flax's ``_compute_stats``: float32 (or wider) mean and
    ``max(0, E[x^2] - E[x]^2)`` over ``dims``."""
    x = x.to(torch.promote_types(x.dtype, torch.float32))
    mean = x.mean(dims)
    var = torch.clamp_min((x * x).mean(dims) - mean * mean, 0.0)
    return mean, var


def _normalize(x, mean, var, scale, bias, eps: float, dtype):
    """flax's ``_normalize`` with ``mean`` / ``var`` / ``scale`` / ``bias``
    already broadcast against ``x``."""
    out_dtype = dtype or promote_dtype(x, scale, bias)[0].dtype
    mul = torch.rsqrt(var + eps) * scale
    return ((x - mean) * mul + bias).to(out_dtype)


def _channel_view(v: torch.Tensor, ndim: int) -> torch.Tensor:
    return v.reshape((1, -1) + (1,) * (ndim - 2))


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm(momentum, epsilon, dtype)`` over dim 1. Params
    ``weight`` (flax's ``scale``) and ``bias``; buffers ``mean`` and
    ``var`` (flax's ``batch_stats``). ``stat_name``, the layer's dotted
    path in its model, prefixes the keys it writes into ``stats``; the
    model sets it (``name_stat_layers``)."""

    def __init__(self, channels: int, momentum: float = 0.9,
                 eps: float = 1e-5, dtype: torch.dtype | None = None):
        super().__init__()
        self.momentum, self.eps, self.dtype = momentum, eps, dtype
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("mean", torch.zeros(channels))
        self.register_buffer("var", torch.ones(channels))
        self.stat_name = ""

    @torch.no_grad()
    def reset_parameters(self):
        self.weight.fill_(1.0)
        self.bias.zero_()
        self.mean.zero_()
        self.var.fill_(1.0)

    def forward(self, x, train: bool = False, stats: dict | None = None):
        nd = x.ndim
        if train:
            mean, var = _stats(x, [0] + list(range(2, nd)))
            if stats is not None:
                m = self.momentum
                stats[self.stat_name + "mean"] = (
                    m * self.mean + (1 - m) * mean).detach()
                stats[self.stat_name + "var"] = (
                    m * self.var + (1 - m) * var).detach()
        else:
            mean, var = self.mean, self.var
        view = lambda v: _channel_view(v, nd)  # noqa: E731
        return _normalize(x, view(mean), view(var), view(self.weight),
                          view(self.bias), self.eps, self.dtype)


class GroupNorm(nn.Module):
    """flax ``nn.GroupNorm(num_groups, epsilon=1e-6, dtype)`` over dim 1:
    statistics per (sample, group) over the group's channels and every
    spatial position; per-channel ``weight`` (flax's ``scale``) and
    ``bias``. No state."""

    def __init__(self, num_groups: int, channels: int, eps: float = 1e-6,
                 dtype: torch.dtype | None = None):
        super().__init__()
        if channels % num_groups:
            raise ValueError(f"{num_groups} groups do not divide "
                             f"{channels} channels")
        self.num_groups, self.eps, self.dtype = num_groups, eps, dtype
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    @torch.no_grad()
    def reset_parameters(self):
        self.weight.fill_(1.0)
        self.bias.zero_()

    def forward(self, x, train: bool = False, stats: dict | None = None):
        N, C = x.shape[:2]
        G = self.num_groups
        grouped = x.reshape((N, G, C // G) + tuple(x.shape[2:]))
        mean, var = _stats(grouped, list(range(2, grouped.ndim)))
        bc = lambda v: v.repeat_interleave(C // G, dim=1).reshape(  # noqa
            (N, C) + (1,) * (x.ndim - 2))
        view = lambda v: _channel_view(v, x.ndim)  # noqa: E731
        return _normalize(x, bc(mean), bc(var), view(self.weight),
                          view(self.bias), self.eps, self.dtype)


def group_norm(num_groups: int = 8):
    """GroupNorm constructor (the JAX package's ``group_norm``): the
    stateless alternative for federated averaging (no running statistics
    to aggregate). ``group_norm(G)(channels)`` builds the layer."""
    return lambda channels, **kw: GroupNorm(num_groups, channels, **kw)


def sync_batchnorm(axis_name, momentum: float = 0.9, epsilon: float = 1e-5):
    """Cross-device synchronized BatchNorm reduces its statistics over a
    mesh axis of the clients' shards; the port has no client-sharded mesh
    yet."""
    raise NotImplementedError(
        "sync_batchnorm is not ported yet: ROADMAP.md queue A, item 12 "
        "(it needs a client-sharded mesh axis)")


def name_stat_layers(model: nn.Module) -> None:
    """Give every BatchNorm of ``model`` its dotted path as ``stat_name``,
    so the statistics it writes land under its buffer names."""
    for name, m in model.named_modules():
        if isinstance(m, BatchNorm):
            m.stat_name = name + "." if name else ""
