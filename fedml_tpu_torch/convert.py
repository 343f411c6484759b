"""Weight carry-over between the JAX package and the port.

``from_flax`` turns a flax ``TransformerLM`` param tree (nested dicts of
numpy arrays, as ``TransformerLM(...).init(...)["params"]`` prints them)
into the port's ``state_dict`` layout; ``to_flax`` is its inverse. Leaves
are copied exactly, so a round trip is bitwise.

Mapping (flax -> torch):
  Embed_0/embedding [V,C]                    -> embed.weight [V,C]
  pos_emb [L,C]                              -> pos_emb [L,C]
  Block_i/LayerNorm_{0,1}/{scale,bias}       -> blocks.i.ln{1,2}.{weight,bias}
  Block_i/SelfAttention_0/{q,k,v}_proj/kernel [C,H,D]
                                             -> blocks.i.attn.{q,k,v}_proj.weight [H*D,C]
  Block_i/SelfAttention_0/o_proj/kernel [H,D,C]
                                             -> blocks.i.attn.o_proj.weight [C,H*D]
  Block_i/mlp_{in,out}/{kernel [in,out], bias}
                                             -> blocks.i.mlp_{in,out}.{weight [out,in], bias}
  LayerNorm_0/{scale,bias}                   -> ln_f.{weight,bias}
  lm_head/{kernel, bias}                     -> lm_head.{weight, bias}
"""

from __future__ import annotations

import numpy as np
import torch


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True))


def _ln(p) -> tuple:
    return _t(p["scale"]), _t(p["bias"])


def from_flax(params: dict) -> dict:
    """flax TransformerLM params -> the port's state dict (CPU tensors)."""
    sd = {"embed.weight": _t(params["Embed_0"]["embedding"]),
          "pos_emb": _t(params["pos_emb"])}
    depth = sum(1 for k in params if k.startswith("Block_"))
    for i in range(depth):
        blk, pre = params[f"Block_{i}"], f"blocks.{i}."
        attn = blk["SelfAttention_0"]
        sd[pre + "ln1.weight"], sd[pre + "ln1.bias"] = _ln(blk["LayerNorm_0"])
        for name in ("q_proj", "k_proj", "v_proj"):
            kern = np.asarray(attn[name]["kernel"])  # [C, H, D]
            sd[pre + f"attn.{name}.weight"] = _t(
                kern.reshape(kern.shape[0], -1).T)
        kern = np.asarray(attn["o_proj"]["kernel"])  # [H, D, C]
        sd[pre + "attn.o_proj.weight"] = _t(kern.reshape(-1, kern.shape[-1]).T)
        sd[pre + "ln2.weight"], sd[pre + "ln2.bias"] = _ln(blk["LayerNorm_1"])
        for name in ("mlp_in", "mlp_out"):
            sd[pre + f"{name}.weight"] = _t(np.asarray(blk[name]["kernel"]).T)
            sd[pre + f"{name}.bias"] = _t(blk[name]["bias"])
    sd["ln_f.weight"], sd["ln_f.bias"] = _ln(params["LayerNorm_0"])
    sd["lm_head.weight"] = _t(np.asarray(params["lm_head"]["kernel"]).T)
    sd["lm_head.bias"] = _t(params["lm_head"]["bias"])
    return sd


def to_flax(state: dict, num_heads: int) -> dict:
    """The port's state dict -> flax TransformerLM params (numpy arrays)."""
    a = {k: v.detach().cpu().numpy() for k, v in state.items()}
    C = a["pos_emb"].shape[1]
    D = C // num_heads
    ln = lambda pre: {"scale": a[pre + ".weight"], "bias": a[pre + ".bias"]}
    params = {"Embed_0": {"embedding": a["embed.weight"]},
              "pos_emb": a["pos_emb"]}
    depth = sum(1 for k in a if k.endswith(".attn.q_proj.weight"))
    for i in range(depth):
        pre = f"blocks.{i}."
        attn = {name: {"kernel": np.ascontiguousarray(
                    a[pre + f"attn.{name}.weight"].T).reshape(C, num_heads, D)}
                for name in ("q_proj", "k_proj", "v_proj")}
        attn["o_proj"] = {"kernel": np.ascontiguousarray(
            a[pre + "attn.o_proj.weight"].T).reshape(num_heads, D, C)}
        params[f"Block_{i}"] = {
            "LayerNorm_0": ln(pre + "ln1"), "SelfAttention_0": attn,
            "LayerNorm_1": ln(pre + "ln2"),
            **{name: {"kernel": np.ascontiguousarray(a[pre + name + ".weight"].T),
                      "bias": a[pre + name + ".bias"]}
               for name in ("mlp_in", "mlp_out")},
        }
    params["LayerNorm_0"] = ln("ln_f")
    params["lm_head"] = {"kernel": np.ascontiguousarray(a["lm_head.weight"].T),
                         "bias": a["lm_head.bias"]}
    return params
