"""Robust aggregation defenses, port of fedml_tpu/core/robust.py (itself of
fedml_core/robustness/robust_aggregation.py): norm-difference clipping
(:38-49) and weak-DP Gaussian noise (:51-55), as functions of state dicts
on the state's device.

``norm_diff_clipping`` takes one client's state, or under
``torch.func.vmap`` each row of a stacked ``[K, ...]`` cohort: one global
L2 norm per client over every entry. ``add_gaussian_noise`` draws the JAX
package's own noise: the key splits into one key per leaf in the order
``jax.tree.flatten`` takes the flax params (``robust_agg.reference_order``
over ``convert``'s names), each leaf's normals are drawn in its flax layout
(utils/prng, Threefry on the state's device) and moved into the port's
layout by the same index map, so each weight gets the draw the JAX package
gives the same weight.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from fedml_tpu_torch.utils import prng


def norm_diff_clipping(local_net: dict, global_net: dict,
                       norm_bound: float) -> dict:
    """Clip the client->server update (w_local - w_global) to an L2 ball of
    radius ``norm_bound``, then re-add the global weights
    (robust_aggregation.py:38-49)."""
    diff = {k: local_net[k] - global_net[k] for k in local_net}
    sq = sum(torch.sum(d * d) for d in diff.values())
    norm = torch.sqrt(sq)
    scale = torch.clamp_max(norm_bound / torch.clamp_min(norm, 1e-12), 1.0)
    return {k: global_net[k] + diff[k] * scale for k in local_net}


@functools.lru_cache(maxsize=8)
def _leaf_layout(spec: tuple):
    """For a state of ``spec`` = ((key, shape), ...) in dict order: the
    per-leaf sizes in ``jax.tree.flatten`` order of its flax params, and
    the index that takes the concatenated flax-order draw to the port's
    flattened order (None when the two orders agree)."""
    from fedml_tpu_torch.comm.message import _flat_items
    from fedml_tpu_torch.convert import to_flax
    from fedml_tpu_torch.core.robust_agg import _is_model_state

    index, off = {}, 0
    for key, shape in spec:
        n = int(np.prod(shape, dtype=np.int64))
        index[key] = torch.arange(off, off + n).reshape(shape)
        off += n
    tree = to_flax(index, num_heads=1) if _is_model_state(index) else index
    leaves = [np.asarray(leaf).ravel() for _, leaf in _flat_items(tree)]
    sizes = tuple(int(leaf.size) for leaf in leaves)
    perm = np.concatenate(leaves) if leaves else np.zeros(0, np.int64)
    if np.array_equal(perm, np.arange(off)):
        return sizes, None
    inv = np.empty_like(perm)
    inv[perm] = np.arange(off)
    inv.setflags(write=False)  # one cached array serves every caller
    return sizes, inv


@functools.lru_cache(maxsize=8)
def _inv_on(spec: tuple, device: str) -> torch.Tensor:
    return torch.as_tensor(_leaf_layout(spec)[1], device=device)


def gaussian_noise_like(rng, net: dict) -> dict:
    """Unit normals shaped like ``net``: ``jax.random.normal`` of each flax
    leaf under ``split(rng, n_leaves)`` in the JAX treedef's order (see the
    module docstring), drawn on the state's device."""
    spec = tuple((k, tuple(v.shape)) for k, v in net.items())
    device = next(iter(net.values())).device
    sizes, inv = _leaf_layout(spec)
    keys = prng.split(rng, len(sizes))
    flat = prng.normal_from_bits(
        prng.random_bits_multi(keys, sizes, device))
    if inv is not None:
        flat = flat[_inv_on(spec, str(device))]
    out, off = {}, 0
    for k, v in net.items():
        n = v.numel()
        out[k] = flat[off:off + n].reshape(v.shape).to(v.dtype)
        off += n
    return out


def add_gaussian_noise(rng, net: dict, stddev) -> dict:
    """Weak differential privacy: add N(0, stddev^2) to every weight
    (robust_aggregation.py:51-55). ``rng`` is a key's uint32 words
    (utils/prng); ``stddev`` a float or a scalar tensor."""
    noise = gaussian_noise_like(rng, net)
    return {k: v + stddev * noise[k] for k, v in net.items()}
