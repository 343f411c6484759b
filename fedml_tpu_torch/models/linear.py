"""Linear models, port of fedml_tpu/models/linear.py (reference:
fedml_api/model/linear/lr.py:4-11)."""

from __future__ import annotations

import torch.nn.functional as F
from torch import nn

from fedml_tpu_torch.models.dtypes import promote_dtype
from fedml_tpu_torch.models.init import reset_dense_layers


class LogisticRegression(nn.Module):
    """One dense layer over the flattened input; logits out (the
    nonlinearity is folded into the loss, as in the JAX package).

    The input width is taken from the first batch, as flax does: the layer
    is a ``LazyLinear`` until a forward (``classification_task``'s init runs
    one on a sample batch) fixes its shape. Inputs keep the JAX package's
    layout, so the flatten order (NHWC for images) is the same on both sides
    and a converted Dense kernel needs only a transpose."""

    def __init__(self, num_classes: int = 10):
        super().__init__()
        self.linear = nn.LazyLinear(num_classes)

    def reset_parameters(self, generator=None):
        reset_dense_layers(self, generator)

    def forward(self, x):
        if nn.parameter.is_lazy(self.linear.weight):
            return self.linear(x.flatten(1))  # the first call sizes it
        # flax's promotion (models/dtypes.py): bf16 params meet an f32
        # input in f32
        return F.linear(*promote_dtype(x.flatten(1), self.linear.weight,
                                       self.linear.bias))
