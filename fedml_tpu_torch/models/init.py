"""flax's default initializers, drawn on the CPU from an explicit generator.

flax's ``nn.Dense`` and ``nn.Conv`` draw kernels from lecun-normal (a normal
truncated to two standard deviations, variance 1/fan_in) and start biases at
zero. The same seed gives the same weights on every device, though not
flax's bits (tests carry weights over with fedml_tpu_torch.convert).
"""

from __future__ import annotations

import torch
from torch import nn

_TRUNC_STD = 0.87962566103423978  # std of a unit normal truncated to [-2, 2]


@torch.no_grad()
def lecun_normal_(m: nn.Module, generator: torch.Generator | None = None):
    """Redraw a Linear / Conv2d weight from lecun-normal (fan_in =
    in_features, or in_channels x kernel area) and zero its bias."""
    std = m.weight[0].numel() ** -0.5 / _TRUNC_STD
    w = torch.empty(m.weight.shape)
    nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std,
                          generator=generator)
    m.weight.copy_(w)
    if m.bias is not None:
        m.bias.zero_()


def reset_dense_layers(module: nn.Module, generator=None):
    """lecun_normal_ on every Linear / Conv2d of ``module``, in module order."""
    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.Conv2d)):
            lecun_normal_(m, generator)
