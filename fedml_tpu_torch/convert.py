"""Weight carry-over between the JAX package and the port.

``from_flax`` turns a flax param tree (nested dicts of numpy arrays, as
``Module(...).init(...)["params"]`` prints them) of ``TransformerLM``,
``CNNOriginalFedAvg``, ``CNNDropOut``, ``LogisticRegression``,
``ResNetCIFAR`` (all three ``norm_type``s) or ``ResNet18GN``, plus its
extras (``{"batch_stats": ...}``, the JAX package's ``NetState.extra``),
into the port's net layout (params and buffers in one dict); ``to_flax_net``
(params and extras) is its inverse, ``to_flax`` its params half. Leaves
are copied exactly, so a round trip is bitwise.

The families are told apart by structure: a ResNet by its block scopes
(``BasicBlock_i``, ``_GNBasicBlock_i``, ``_FixupBasicBlock_i``,
``GNBlock_i``; the port's ``blocks.i``) before the CNNs' ``Conv_0`` /
``conv1``. CNNOriginalFedAvg and CNNDropOut share their four leaf names;
the first dense layer's row permutation takes its spatial size from the
shapes (7x7x64 rows for the one, 14x14x64 for the other).

ResNets (flax -> torch): ``Conv_j/kernel`` (HWIO) -> ``...conv{j+1}.weight``
(OIHW), a norm's ``scale`` / ``bias`` -> ``weight`` / ``bias``,
``batch_stats/.../{mean,var}`` -> the BatchNorm's ``mean`` / ``var``
buffers, ``Dense_0`` -> ``fc``; the stem is ``Conv_0`` -> ``conv`` and its
norm (``BatchNorm_0``, ``_GN_0/GroupNorm_0`` or ``GroupNorm_0``) ->
``norm``; block ``i`` -> ``blocks.i`` with its norms ``n1``..``n3`` and,
in a Fixup block, ``bias1`` / ``bias2`` / ``scale``.

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


# ResNet flavor -> (block scope, stem norm scope, block norm scope)
_RESNETS = {
    "batch": ("BasicBlock", ("BatchNorm_0",), "BatchNorm"),
    "group": ("_GNBasicBlock", ("_GN_0", "GroupNorm_0"), "GroupNorm"),
    "none": ("_FixupBasicBlock", None, None),
    "gn18": ("GNBlock", ("GroupNorm_0",), "GroupNorm"),
}
_STATS = "batch_stats"


def _norm_entries(port: str, path: tuple, batch: bool) -> list:
    out = [(port + "weight", path + ("scale",), "vec"),
           (port + "bias", path + ("bias",), "vec")]
    if batch:
        out += [(port + s, (_STATS,) + path + (s,), "vec")
                for s in ("mean", "var")]
    return out


def _resnet_entries(flavor: str, shortcuts: list) -> list:
    """``(port key, flax path, kind)`` of every leaf of a ResNet; ``kind``
    'conv' (OIHW <-> HWIO), 'dense' (a transpose) or 'vec' (a copy); paths
    under ``batch_stats`` are extras. ``shortcuts[i]``: block i has the 1x1
    projection."""
    block, stem_norm, norm = _RESNETS[flavor]
    fixup, batch = flavor == "none", flavor == "batch"
    out = [("conv.weight", ("Conv_0", "kernel"), "conv")]
    if fixup:
        out.append(("conv.bias", ("Conv_0", "bias"), "vec"))
    else:
        out += _norm_entries("norm.gn." if flavor == "group" else "norm.",
                             stem_norm, batch)
    for i, shortcut in enumerate(shortcuts):
        pre, scope = f"blocks.{i}.", (f"{block}_{i}",)
        for j in range(3 if shortcut else 2):
            conv = scope + (f"Conv_{j}",)
            out.append((pre + f"conv{j + 1}.weight", conv + ("kernel",),
                        "conv"))
            if fixup:
                out.append((pre + f"conv{j + 1}.bias", conv + ("bias",),
                            "vec"))
            else:
                out += _norm_entries(pre + f"n{j + 1}.",
                                     scope + (f"{norm}_{j}",), batch)
        if fixup:
            out += [(pre + k, scope + (k,), "vec")
                    for k in ("bias1", "bias2", "scale")]
    out += [("fc.weight", ("Dense_0", "kernel"), "dense"),
            ("fc.bias", ("Dense_0", "bias"), "vec")]
    return out


def _flavor_of_flax(params: dict) -> str | None:
    for flavor, (block, _, _) in _RESNETS.items():
        if f"{block}_0" in params:
            return flavor
    return None


def _flavor_of_port(state: dict) -> str | None:
    if "blocks.0.conv1.weight" not in state:
        return None
    if "blocks.0.bias1" in state:
        return "none"
    if "norm.gn.weight" in state:
        return "group"
    return "batch" if "norm.mean" in state else "gn18"


def _get(tree: dict, path: tuple):
    for key in path:
        tree = tree[key]
    return tree


def _resnet_from_flax(params: dict, extra: dict, flavor: str) -> dict:
    block = _RESNETS[flavor][0]
    n = sum(1 for k in params if k.startswith(block + "_"))
    shortcuts = ["Conv_2" in params[f"{block}_{i}"] for i in range(n)]
    sd = {}
    for key, path, kind in _resnet_entries(flavor, shortcuts):
        leaf = _get(extra, path) if path[0] == _STATS else _get(params, path)
        sd[key] = _t(_perm(leaf, (3, 2, 0, 1)) if kind == "conv"
                     else _perm(leaf, (1, 0)) if kind == "dense" else leaf)
    return sd


def _resnet_to_flax(a: dict, flavor: str) -> tuple:
    n = sum(1 for k in a if k.startswith("blocks.")
            and k.endswith(".conv1.weight"))
    shortcuts = [f"blocks.{i}.conv3.weight" in a for i in range(n)]
    params, extra = {}, {}
    for key, path, kind in _resnet_entries(flavor, shortcuts):
        leaf = a[key]
        if kind == "conv":
            leaf = np.ascontiguousarray(leaf.transpose(2, 3, 1, 0))
        elif kind == "dense":
            leaf = np.ascontiguousarray(leaf.T)
        node = extra if path[0] == _STATS else params
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return params, extra


def from_flax(params: dict, extra: dict | None = None) -> dict:
    """flax params (and the model's extras, ``{"batch_stats": ...}``) of
    any model of the module docstring -> the port's net (CPU tensors;
    leaves that are tensors keep their device, a pure permutation of their
    values)."""
    flavor = _flavor_of_flax(params)
    if flavor is not None:
        return _resnet_from_flax(params, extra or {}, flavor)
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
    attn = getattr(blocks[0], "attn", None) if blocks else None
    return int(attn.num_heads) if attn is not None else None


def to_flax_net(state: dict, num_heads: int | None = None) -> tuple:
    """The port's net -> ``(params, extra)`` as the JAX package's
    ``NetState`` holds them (numpy arrays; ``extra`` is ``{}`` for a model
    with no state); a TransformerLM needs its ``num_heads``."""
    flavor = _flavor_of_port(state)
    if flavor is not None:
        return _resnet_to_flax({k: v.detach().cpu().numpy()
                                for k, v in state.items()}, flavor)
    return to_flax(state, num_heads), {}


def to_flax(state: dict, num_heads: int | None = None) -> dict:
    """The port's net -> flax params (numpy arrays); a TransformerLM
    needs its ``num_heads``."""
    if _flavor_of_port(state) is not None:
        return to_flax_net(state)[0]
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
