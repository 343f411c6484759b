"""ResNet-18 with GroupNorm, the fed_cifar100 model, port of
fedml_tpu/models/resnet_gn.py (reference: fedml_api/model/cv/resnet_gn.py).

ImageNet-style ResNet-18 with GroupNorm (``min(32, channels)`` groups,
flax eps 1e-6) and the GN paper's per-CHANNEL affine, as the JAX package
has it: 11,689,512 params at 1000 classes with ``small_input=False``
(torchvision's resnet18 count), 11,220,132 at 100 classes with the CIFAR
stem (3x3, no max-pool) of ``small_input=True``. No state: the model has no
extras. Input NHWC, as the JAX module's; convolutions and the stem's
max-pool pad as flax's ``'SAME'`` (models/resnet.py).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from fedml_tpu_torch.models.init import reset_dense_layers
from fedml_tpu_torch.models.norm import GroupNorm
from fedml_tpu_torch.models.resnet import (
    BasicBlock,
    Conv,
    head,
    reset_norm_layers,
    same_padding,
)


def _gn(channels: int) -> GroupNorm:
    return GroupNorm(min(32, channels), channels)


class ResNet18GN(nn.Module):
    stateful_forward = True  # forward(x, train, key, stats): core/tasks.py

    def __init__(self, num_classes: int = 100, small_input: bool = True):
        super().__init__()
        self.small_input = small_input
        self.conv = (Conv(3, 64, 3) if small_input else Conv(3, 64, 7, 2))
        self.norm = _gn(64)
        blocks, cin = [], 64
        for filters, stride in ((64, 1), (64, 1), (128, 2), (128, 1),
                                (256, 2), (256, 1), (512, 2), (512, 1)):
            blocks.append(BasicBlock(cin, filters, stride, _gn))
            cin = filters
        self.blocks = nn.ModuleList(blocks)
        self.fc = nn.Linear(512, num_classes)
        self.reset_parameters()

    def reset_parameters(self, generator: torch.Generator | None = None):
        reset_dense_layers(self, generator)
        reset_norm_layers(self)

    def forward(self, x, train: bool = False, key=None, stats=None):
        y = F.relu(self.norm(self.conv(x.permute(0, 3, 1, 2))))
        if not self.small_input:  # flax max_pool 3x3 / 2, 'SAME' (-inf pad)
            (hl, hh), (wl, wh) = (same_padding(y.shape[-2], 3, 2),
                                  same_padding(y.shape[-1], 3, 2))
            y = F.max_pool2d(F.pad(y, (wl, wh, hl, hh), value=-torch.inf),
                             3, 2)
        for block in self.blocks:
            y = block(y, train, stats)
        return head(self.fc, y)
