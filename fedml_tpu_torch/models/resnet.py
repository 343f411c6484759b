"""CIFAR ResNets, port of fedml_tpu/models/resnet.py (reference:
fedml_api/model/cv/resnet.py): ``ResNetCIFAR(depth=6n+2)``, three stages of
n basic blocks at 16/32/64 channels, with ``norm_type``:

- ``'batch'``: BatchNorm (momentum 0.9, eps 1e-5); its running statistics
  are the model's extras (buffers ``mean`` / ``var``, the JAX package's
  ``batch_stats``), federated-averaged with the params;
- ``'group'``: GroupNorm, 8 groups (flax eps 1e-6), no state;
- ``'none'``: the normalization-free ResNet (resnet_wo_bn): Fixup blocks,
  the residual branch's second conv zero-initialized, learned scalar
  ``bias1`` / ``bias2`` / ``scale``.

The model takes the JAX module's NHWC input ``[bs, H, W, 3]`` and runs
channels-first. Convolutions pad as flax's ``'SAME'``: a stride-2 3x3
convolution on an even input pads one row and column at the END only
(torch's symmetric padding would shift every window by one pixel). The
activations are upcast to float32 before the global mean, and the head is
float32. ``dtype`` (``torch.bfloat16``) is the JAX module's activation
dtype: convolutions and norms compute in it, with float32 params and norm
statistics (models/dtypes.promote_dtype, as flax promotes).

``forward(x, train=False, key=None, stats=None)`` is the signature of the
port's stateful models (core/tasks.py): in train mode BatchNorm writes its
new running statistics into ``stats``. The ResNets draw no randomness
(``key`` is unused).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from fedml_tpu_torch.models.dtypes import promote_dtype
from fedml_tpu_torch.models.init import reset_dense_layers
from fedml_tpu_torch.models.norm import BatchNorm, GroupNorm, name_stat_layers


def same_padding(size: int, k: int, stride: int) -> tuple:
    """flax / XLA ``'SAME'`` padding of one spatial dim: (low, high)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


class Conv(nn.Conv2d):
    """flax ``nn.Conv(features, (k, k), strides, padding='SAME', use_bias,
    dtype)`` on a channels-first input."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1,
                 bias: bool = False, dtype: torch.dtype | None = None):
        super().__init__(cin, cout, k, stride, bias=bias)
        self.dtype = dtype

    def forward(self, x):
        k, s = self.kernel_size[0], self.stride[0]
        (hl, hh), (wl, wh) = (same_padding(x.shape[-2], k, s),
                              same_padding(x.shape[-1], k, s))
        x, w, b = promote_dtype(x, self.weight, self.bias, dtype=self.dtype)
        if hl == hh and wl == wh:
            return F.conv2d(x, w, b, s, (hl, wl))
        return F.conv2d(F.pad(x, (wl, wh, hl, hh)), w, b, s)


def head(fc: nn.Linear, y: torch.Tensor) -> torch.Tensor:
    """Global spatial mean in float32, then the dense head."""
    return F.linear(*promote_dtype(y.float().mean((2, 3)), fc.weight,
                                   fc.bias))


class BasicBlock(nn.Module):
    """conv3x3 -> norm -> relu -> conv3x3 -> norm, plus the input (through
    a strided 1x1 conv and a norm where the shape changes), relu. ``norm``
    builds a norm layer for a channel count (BatchNorm or GroupNorm)."""

    def __init__(self, cin: int, filters: int, stride: int, norm,
                 dtype=None):
        super().__init__()
        self.conv1 = Conv(cin, filters, 3, stride, dtype=dtype)
        self.n1 = norm(filters)
        self.conv2 = Conv(filters, filters, 3, dtype=dtype)
        self.n2 = norm(filters)
        self.shortcut = stride != 1 or cin != filters
        if self.shortcut:
            self.conv3 = Conv(cin, filters, 1, stride, dtype=dtype)
            self.n3 = norm(filters)

    def forward(self, x, train: bool, stats):
        y = F.relu(self.n1(self.conv1(x), train, stats))
        y = self.n2(self.conv2(y), train, stats)
        if self.shortcut:
            x = self.n3(self.conv3(x), train, stats)
        return F.relu(y + x)


class FixupBasicBlock(nn.Module):
    """The norm-free block (resnet_wo_bn): ``relu(scale * conv2(relu(
    conv1(x + bias1)) + bias2) + x')``; conv2 starts at zero, so the block
    starts as the identity. The scalars are float32 params applied in the
    compute dtype."""

    def __init__(self, cin: int, filters: int, stride: int, dtype=None):
        super().__init__()
        self.dtype = dtype
        self.bias1 = nn.Parameter(torch.zeros(1))
        self.conv1 = Conv(cin, filters, 3, stride, bias=True, dtype=dtype)
        self.bias2 = nn.Parameter(torch.zeros(1))
        self.conv2 = Conv(filters, filters, 3, bias=True, dtype=dtype)
        self.scale = nn.Parameter(torch.ones(1))
        self.shortcut = stride != 1 or cin != filters
        if self.shortcut:
            self.conv3 = Conv(cin, filters, 1, stride, bias=True, dtype=dtype)

    @torch.no_grad()
    def reset_parameters(self):
        self.bias1.zero_()
        self.bias2.zero_()
        self.scale.fill_(1.0)
        self.conv2.weight.zero_()
        self.conv2.bias.zero_()

    def forward(self, x, train: bool, stats):
        cd = self.dtype or x.dtype
        y = F.relu(self.conv1(x + self.bias1.to(cd)))
        y = self.conv2(y + self.bias2.to(cd)) * self.scale.to(cd)
        if self.shortcut:
            x = self.conv3(x)
        return F.relu(y + x)


class _GN(nn.Module):
    """The JAX package's ``_GN`` shim (the group-norm ResNet's stem norm):
    a GroupNorm one scope down, ``min(8, channels)`` groups."""

    def __init__(self, channels: int, dtype=None):
        super().__init__()
        self.gn = GroupNorm(min(8, channels), channels, dtype=dtype)

    def forward(self, x, train: bool = False, stats=None):
        return self.gn(x)


def reset_norm_layers(model: nn.Module) -> None:
    """Norm layers and Fixup blocks back to their flax initial values."""
    for m in model.modules():
        if isinstance(m, (BatchNorm, GroupNorm, FixupBasicBlock)):
            m.reset_parameters()


class ResNetCIFAR(nn.Module):
    """depth = 6n + 2 (56: n = 9, 110: n = 18); see the module docstring."""

    stateful_forward = True  # forward(x, train, key, stats): core/tasks.py

    def __init__(self, depth: int = 56, num_classes: int = 10,
                 norm_type: str = "batch", dtype: torch.dtype | None = None):
        super().__init__()
        if (depth - 2) % 6:
            raise ValueError(f"depth must be 6n+2, got {depth}")
        if norm_type not in ("batch", "group", "none"):
            raise ValueError(f"norm_type={norm_type!r} (batch | group | none)")
        n = (depth - 2) // 6
        self.norm_type, self.dtype = norm_type, dtype
        self.conv = Conv(3, 16, 3, bias=norm_type == "none", dtype=dtype)
        if norm_type == "batch":
            self.norm = BatchNorm(16, dtype=dtype)
        elif norm_type == "group":
            self.norm = _GN(16, dtype=dtype)
        blocks, cin = [], 16
        for filters, stride in ((16, 1), (32, 2), (64, 2)):
            for i in range(n):
                s = stride if i == 0 else 1
                if norm_type == "none":
                    blocks.append(FixupBasicBlock(cin, filters, s, dtype))
                else:
                    norm = ((lambda c: BatchNorm(c, dtype=dtype))
                            if norm_type == "batch" else
                            (lambda c: GroupNorm(min(8, c), c, dtype=dtype)))
                    blocks.append(BasicBlock(cin, filters, s, norm, dtype))
                cin = filters
        self.blocks = nn.ModuleList(blocks)
        self.fc = nn.Linear(64, num_classes)
        name_stat_layers(self)
        self.reset_parameters()

    def reset_parameters(self, generator: torch.Generator | None = None):
        reset_dense_layers(self, generator)
        reset_norm_layers(self)

    def forward(self, x, train: bool = False, key=None, stats=None):
        x = x.permute(0, 3, 1, 2)  # NHWC -> NCHW (a view)
        if self.dtype is not None:
            x = x.to(self.dtype)
        y = self.conv(x)
        if self.norm_type != "none":
            y = self.norm(y, train, stats)
        y = F.relu(y)
        for block in self.blocks:
            y = block(y, train, stats)
        return head(self.fc, y)
