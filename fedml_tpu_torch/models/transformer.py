"""Decoder-only transformer, port of fedml_tpu/models/transformer.py.

``SelfAttention``, ``Block`` and ``TransformerLM``: with ``use_flash`` the
attention core is the hand-written flash kernels (fedml_tpu_torch.ops),
else the dense ``full_attention``. With ``seq_axis`` (a mesh axis handle,
fedml_tpu_torch.mesh) the model runs on one rank's sequence block and
attention is sequence-parallel over the axis (parallel/ring_attention.py):
``seq_impl='ring'`` rotates K/V blocks (through the flash kernels with
``use_flash``, merged by logsumexp), ``'ulysses'`` swaps sequence for
heads by all_to_all; ``pos_emb`` is offset by the block's position. The
switch-MoE MLP (``moe_experts``) and ``PipelineLM`` wait for a later slice
(ROADMAP.md queue A, item 12).

Parity with the flax modules, which tests/test_torch_transformer.py holds
on converted weights (fedml_tpu_torch.convert):
- LayerNorm eps is flax's 1e-6; gelu is the tanh approximation (flax's
  ``nn.gelu`` default);
- q/k/v/o projections have no bias; ``mlp_in``, ``mlp_out`` and ``lm_head``
  do; ``pos_emb[:T]`` is added after the token embedding;
- ``reset_parameters`` draws from the distributions of flax's initializers
  (lecun-normal kernels, embedding std 1/sqrt(dim), pos_emb std 0.02),
  on the CPU from an explicit generator: the same seed gives the same
  weights on every device, though not flax's bits.
The parameter names do not depend on ``seq_axis`` / ``seq_impl``, so a
sequence-parallel model takes the plain model's weights unchanged.

Under the bf16 client-compute policy (core/local.py casts the params to
bfloat16) every layer runs in bf16 with flax's dtype rules, which torch's
layers already follow up to rounding: the embedding and ``pos_emb`` add in
bf16 (flax's ``Embed`` keeps its table's dtype); ``nn.LayerNorm`` reduces
and normalizes in float32 and rounds its output to bf16 once (flax's
``_compute_stats`` promotes to float32 and ``_normalize`` casts back to
the input's dtype); the projections, gelu and ``lm_head`` compute in bf16
(flax's ``nn.gelu`` runs in the input's dtype); the flash kernels take
bf16 q/k/v and return bf16 (their lse float32), and the logits are bf16.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from fedml_tpu_torch.models.init import lecun_normal_
from fedml_tpu_torch.ops.flash_attention import flash_attention
from fedml_tpu_torch.parallel.ring_attention import (
    full_attention,
    ring_attention,
    ring_attention_flash,
    ulysses_attention,
)

LN_EPS = 1e-6  # flax.linen.LayerNorm's default


def _unported(option: str, item: str):
    return NotImplementedError(
        f"{option} is not ported yet: ROADMAP.md queue A, item {item}")


class SelfAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int, head_dim: int,
                 causal: bool = True, seq_axis=None,
                 use_flash: bool = False, seq_impl: str = "ring"):
        super().__init__()
        if seq_axis is not None and seq_impl not in ("ring", "ulysses"):
            raise ValueError(
                f"unknown seq_impl {seq_impl!r} (ring | ulysses)")
        self.num_heads, self.head_dim = num_heads, head_dim
        self.causal, self.use_flash = causal, use_flash
        self.seq_axis, self.seq_impl = seq_axis, seq_impl
        inner = num_heads * head_dim
        self.q_proj = nn.Linear(dim, inner, bias=False)
        self.k_proj = nn.Linear(dim, inner, bias=False)
        self.v_proj = nn.Linear(dim, inner, bias=False)
        self.o_proj = nn.Linear(inner, dim, bias=False)

    def forward(self, x):
        B, T, _ = x.shape
        heads = (B, T, self.num_heads, self.head_dim)
        q = self.q_proj(x).view(heads)
        k = self.k_proj(x).view(heads)
        v = self.v_proj(x).view(heads)
        ax = self.seq_axis
        if ax is None:
            attend = flash_attention if self.use_flash else full_attention
            o = attend(q, k, v, self.causal)
        elif self.seq_impl == "ulysses":
            o = ulysses_attention(q, k, v, ax, self.causal, self.use_flash)
        else:
            ring = ring_attention_flash if self.use_flash else ring_attention
            o = ring(q, k, v, ax, self.causal)
        return self.o_proj(o.reshape(B, T, -1))


class Block(nn.Module):
    def __init__(self, dim: int, num_heads: int, head_dim: int,
                 mlp_ratio: int = 4, causal: bool = True,
                 seq_axis=None, use_flash: bool = False,
                 seq_impl: str = "ring", moe_experts: int = 0):
        super().__init__()
        if moe_experts > 0:
            raise _unported("the switch-MoE MLP (moe_experts)", "12")
        self.ln1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = SelfAttention(dim, num_heads, head_dim, causal, seq_axis,
                                  use_flash, seq_impl)
        self.ln2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp_in = nn.Linear(dim, mlp_ratio * dim)
        self.mlp_out = nn.Linear(mlp_ratio * dim, dim)

    def forward(self, x):
        x = x + self.attn(self.ln1(x))
        m = F.gelu(self.mlp_in(self.ln2(x)), approximate="tanh")
        return x + self.mlp_out(m)


class TransformerLM(nn.Module):
    def __init__(self, vocab_size: int = 256, dim: int = 128, depth: int = 2,
                 num_heads: int = 4, max_len: int = 2048, causal: bool = True,
                 seq_axis=None, use_flash: bool = False,
                 seq_impl: str = "ring", moe_experts: int = 0):
        super().__init__()
        self.num_heads, self.seq_axis, self.seq_impl = (num_heads, seq_axis,
                                                        seq_impl)
        self.embed = nn.Embedding(vocab_size, dim)
        self.pos_emb = nn.Parameter(torch.empty(max_len, dim))
        self.blocks = nn.ModuleList(
            Block(dim, num_heads, dim // num_heads, causal=causal,
                  seq_axis=seq_axis, use_flash=use_flash,
                  seq_impl=seq_impl, moe_experts=moe_experts)
            for _ in range(depth))
        self.ln_f = nn.LayerNorm(dim, eps=LN_EPS)
        self.lm_head = nn.Linear(dim, vocab_size)
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None):
        """Redraw every parameter on the CPU from ``generator`` (torch's
        default generator when None) and copy it into place."""

        def draw(shape, std):
            return nn.init.normal_(torch.empty(shape), std=std,
                                   generator=generator)

        for m in self.modules():
            if isinstance(m, nn.Linear):  # flax lecun_normal kernel, zero bias
                lecun_normal_(m, generator)
            elif isinstance(m, nn.LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
            elif isinstance(m, nn.Embedding):
                m.weight.copy_(draw(m.weight.shape, m.embedding_dim ** -0.5))
        self.pos_emb.copy_(draw(self.pos_emb.shape, 0.02))

    def forward(self, tokens):
        T = tokens.shape[1]
        # with seq_axis, T is the rank's block: offset into the global
        # position table by the block's place on the axis
        start = 0 if self.seq_axis is None else self.seq_axis.index * T
        x = self.embed(tokens) + self.pos_emb[start:start + T]
        for block in self.blocks:
            x = block(x)
        return self.lm_head(self.ln_f(x))
