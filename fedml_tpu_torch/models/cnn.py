"""FedAvg-paper CNN, port of fedml_tpu/models/cnn.py (reference:
fedml_api/model/cv/cnn.py:26-97).

``CNNOriginalFedAvg``: conv5x5(32, pad 2) -> maxpool 2 -> relu -> conv5x5(64,
pad 2) -> maxpool 2 -> relu -> flatten -> dense 512 -> relu -> dense 62 (10
with ``only_digits``); 1,690,046 params for 62 classes, 1,663,370 for 10.

It takes the JAX module's input, NHWC ``[bs, 28, 28, 1]`` (or ``[bs, 28,
28]``), and runs the convolutions NCHW on cuDNN, conv2's weight gradient
as a float32 GEMM (``conv2d``). It flattens NCHW, where
flax flattens NHWC, so the first dense layer's input columns are a
permutation of flax's rows (fedml_tpu_torch.convert does it).
``CNNDropOut`` is queued in ROADMAP.md (queue A, item 3): its dropout has to
draw from an explicit generator inside the cohort-batched fit.

``dtype`` is the JAX module's activation dtype: ``torch.bfloat16`` runs the
convolutions and the first dense layer in bf16 (the input is cast to it),
and the head takes its input back to float32, so the logits are f32. Each
layer promotes its (input, weight, bias) as flax does
(models/dtypes.promote_dtype), so the bf16 client-compute policy's bf16
params meet an f32 input in f32 when ``dtype`` is None.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from fedml_tpu_torch.models.dtypes import promote_dtype
from fedml_tpu_torch.models.init import reset_dense_layers


def conv2d(x, w, b, padding):
    """``F.conv2d`` at stride 1 whose weight gradient is a float32 GEMM.

    Under the cohort's ``vmap`` every client has its own weights, so the
    convolution becomes a grouped one, and cuDNN serves the weight gradient
    of such a 5x5 convolution with Winograd kernels (~5e-5 relative error
    in a client's update, float32 proper ~1e-6) whatever the TF32 flags
    say. So cuDNN computes the output and the input gradient with the
    weights detached, and the weights enter through a term that is exactly
    zero, the padded input's kh x kw windows times ``w - w.detach()``,
    whose gradient is the windows times the output gradient summed over
    batch and positions: one GEMM (a batched one under vmap). The windows
    are a strided view, not ``F.unfold``, whose CUDA kernel launches once
    per sample. A custom autograd.Function would cost more host time:
    under ``torch.func.grad`` functorch builds a new Function class on
    every call.
    """
    if not torch.is_grad_enabled():  # eval: no gradient to route
        return F.conv2d(x, w, b, padding=padding)
    kh, kw = w.shape[-2:]
    win = F.pad(x.detach(), (padding,) * 4).unfold(2, kh, 1).unfold(3, kw, 1)
    zero = torch.einsum("nchwij,ocij->nohw", win, w - w.detach())
    return F.conv2d(x, w.detach(), b, padding=padding) + zero


class CNNOriginalFedAvg(nn.Module):
    def __init__(self, only_digits: bool = False,
                 dtype: torch.dtype | None = None):
        super().__init__()
        self.dtype = dtype
        self.conv1 = nn.Conv2d(1, 32, 5, padding=2)
        self.conv2 = nn.Conv2d(32, 64, 5, padding=2)
        self.fc1 = nn.Linear(7 * 7 * 64, 512)
        self.fc2 = nn.Linear(512, 10 if only_digits else 62)
        self.reset_parameters()

    def reset_parameters(self, generator=None):
        reset_dense_layers(self, generator)

    def forward(self, x):
        if x.ndim == 3:
            x = x[..., None]
        dt = self.dtype
        if dt is not None:
            x = x.to(dt)
        x = x.permute(0, 3, 1, 2)  # NHWC -> NCHW (a view)
        # conv1 (one input channel a client) runs on PyTorch's depthwise
        # kernels under vmap, whose weight gradient is float32 proper
        x, w, b = promote_dtype(x, self.conv1.weight, self.conv1.bias,
                                dtype=dt)
        x = F.relu(F.max_pool2d(F.conv2d(x, w, b, padding=2), 2))
        x = conv2d(*promote_dtype(x, self.conv2.weight, self.conv2.bias,
                                  dtype=dt), 2)
        x = F.relu(F.max_pool2d(x, 2))
        x = F.relu(F.linear(*promote_dtype(x.flatten(1), self.fc1.weight,
                                           self.fc1.bias, dtype=dt)))
        # the head in float32: the loss and softmax stay full precision
        return F.linear(*promote_dtype(x.float(), self.fc2.weight,
                                       self.fc2.bias))
