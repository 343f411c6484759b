"""Port of fedml_tpu/parallel/ring_attention.py — ``full_attention`` only.

It is the dense oracle of the flash kernels and ``SelfAttention``'s
non-flash branch. ``ring_attention``, ``ring_attention_flash`` and
``ulysses_attention`` (over torch.distributed) wait for a later slice
(ROADMAP.md queue A, item 11).
"""

from __future__ import annotations

import math

import torch


def full_attention(q, k, v, causal: bool = False):
    """Single-device reference: softmax(QK^T/sqrt(d))V. [B, T, H, D] in/out."""
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(q.shape[-1])
    if causal:
        T, S = scores.shape[-2], scores.shape[-1]
        ok = torch.ones(T, S, dtype=torch.bool, device=q.device).tril()
        scores = scores.masked_fill(~ok, float("-inf"))
    p = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)
