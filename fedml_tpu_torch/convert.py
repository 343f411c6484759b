"""Weight carry-over between the JAX package and the port.

``from_flax`` turns a flax param tree (nested dicts of numpy arrays, as
``Module(...).init(...)["params"]`` prints them) of ``TransformerLM``,
``CNNOriginalFedAvg`` or ``LogisticRegression`` into the port's
``state_dict`` layout; ``to_flax`` is its inverse. Leaves are copied
exactly, so a round trip is bitwise.

CNNOriginalFedAvg (flax -> torch):
  Conv_{0,1}/kernel [kh,kw,in,out] (HWIO)    -> conv{1,2}.weight [out,in,kh,kw]
  Dense_{0,1}/kernel [in,out]                -> fc{1,2}.weight [out,in]
  biases                                     -> conv{1,2}.bias, fc{1,2}.bias
  flax flattens the last conv's output NHWC, torch NCHW: fc1's column
  c*49 + h*7 + w takes Dense_0's row h*448 + w*64 + c (a plain transpose
  keeps the parameter count and gives the wrong logits).
LogisticRegression: Dense_0/{kernel [in,out], bias} -> linear.{weight
  [out,in], bias}; both sides flatten the same input layout.

TransformerLM (flax -> torch):
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
    if isinstance(a, torch.Tensor):
        return a.contiguous()  # from_flax of device leaves (fused ingest)
    return torch.from_numpy(np.array(a, copy=True))


def _arr(a):
    """A leaf as an array: tensors stay tensors (on their device)."""
    return a if isinstance(a, torch.Tensor) else np.asarray(a)


def _perm(a, axes):
    """``transpose(axes)`` of a numpy array or a tensor."""
    a = _arr(a)
    return a.permute(*axes) if isinstance(a, torch.Tensor) \
        else a.transpose(axes)


def _ln(p) -> tuple:
    return _t(p["scale"]), _t(p["bias"])


def _dense(p) -> tuple:
    return _t(_perm(p["kernel"], (1, 0))), _t(p["bias"])


def _cnn_from_flax(params: dict) -> dict:
    sd = {}
    for i in (0, 1):
        conv = params[f"Conv_{i}"]
        sd[f"conv{i + 1}.weight"] = _t(_perm(conv["kernel"], (3, 2, 0, 1)))
        sd[f"conv{i + 1}.bias"] = _t(conv["bias"])
    kern = _arr(params["Dense_0"]["kernel"])  # [h*w*c, out], NHWC rows
    C = params["Conv_1"]["kernel"].shape[-1]
    hw = int(round((kern.shape[0] // C) ** 0.5))
    nchw = _perm(kern.reshape(hw, hw, C, -1), (2, 0, 1, 3))
    sd["fc1.weight"] = _t(_perm(nchw.reshape(kern.shape), (1, 0)))
    sd["fc1.bias"] = _t(params["Dense_0"]["bias"])
    sd["fc2.weight"], sd["fc2.bias"] = _dense(params["Dense_1"])
    return sd


def _cnn_to_flax(a: dict) -> dict:
    params = {}
    for i in (0, 1):
        params[f"Conv_{i}"] = {
            "kernel": np.ascontiguousarray(
                a[f"conv{i + 1}.weight"].transpose(2, 3, 1, 0)),
            "bias": a[f"conv{i + 1}.bias"]}
    w = a["fc1.weight"]  # [out, c*h*w], NCHW columns
    C = a["conv2.weight"].shape[0]
    hw = int(round((w.shape[1] // C) ** 0.5))
    nhwc = w.T.reshape(C, hw, hw, -1).transpose(1, 2, 0, 3)
    params["Dense_0"] = {"kernel": np.ascontiguousarray(nhwc.reshape(w.T.shape)),
                         "bias": a["fc1.bias"]}
    params["Dense_1"] = {"kernel": np.ascontiguousarray(a["fc2.weight"].T),
                         "bias": a["fc2.bias"]}
    return params


def from_flax(params: dict) -> dict:
    """flax TransformerLM / CNNOriginalFedAvg / LogisticRegression params ->
    the port's state dict (CPU tensors; leaves that are tensors keep their
    device, a pure permutation of their values)."""
    if "Conv_0" in params:
        return _cnn_from_flax(params)
    if set(params) == {"Dense_0"}:
        w, b = _dense(params["Dense_0"])
        return {"linear.weight": w, "linear.bias": b}
    sd = {"embed.weight": _t(params["Embed_0"]["embedding"]),
          "pos_emb": _t(params["pos_emb"])}
    depth = sum(1 for k in params if k.startswith("Block_"))
    for i in range(depth):
        blk, pre = params[f"Block_{i}"], f"blocks.{i}."
        attn = blk["SelfAttention_0"]
        sd[pre + "ln1.weight"], sd[pre + "ln1.bias"] = _ln(blk["LayerNorm_0"])
        for name in ("q_proj", "k_proj", "v_proj"):
            kern = _arr(attn[name]["kernel"])  # [C, H, D]
            sd[pre + f"attn.{name}.weight"] = _t(
                _perm(kern.reshape(kern.shape[0], -1), (1, 0)))
        kern = _arr(attn["o_proj"]["kernel"])  # [H, D, C]
        sd[pre + "attn.o_proj.weight"] = _t(
            _perm(kern.reshape(-1, kern.shape[-1]), (1, 0)))
        sd[pre + "ln2.weight"], sd[pre + "ln2.bias"] = _ln(blk["LayerNorm_1"])
        for name in ("mlp_in", "mlp_out"):
            sd[pre + f"{name}.weight"], sd[pre + f"{name}.bias"] = _dense(
                blk[name])
    sd["ln_f.weight"], sd["ln_f.bias"] = _ln(params["LayerNorm_0"])
    sd["lm_head.weight"], sd["lm_head.bias"] = _dense(params["lm_head"])
    return sd


def num_heads_of(module) -> int | None:
    """The head count ``to_flax`` needs for ``module``'s state: a
    TransformerLM's, None for the models that have no attention."""
    blocks = getattr(module, "blocks", None)
    return int(blocks[0].attn.num_heads) if blocks else None


def to_flax(state: dict, num_heads: int | None = None) -> dict:
    """The port's state dict -> flax params (numpy arrays); a TransformerLM
    needs its ``num_heads``."""
    a = {k: v.detach().cpu().numpy() for k, v in state.items()}
    if "conv1.weight" in a:
        return _cnn_to_flax(a)
    if "linear.weight" in a:
        return {"Dense_0": {"kernel": np.ascontiguousarray(a["linear.weight"].T),
                            "bias": a["linear.bias"]}}
    if num_heads is None:
        raise TypeError("to_flax of a TransformerLM needs its num_heads "
                        "(see num_heads_of)")
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
