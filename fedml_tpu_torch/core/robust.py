"""Robust aggregation defenses, port of fedml_tpu/core/robust.py (itself of
fedml_core/robustness/robust_aggregation.py): norm-difference clipping
(:38-49) and weak-DP Gaussian noise (:51-55), as functions of state dicts
on the state's device.

``norm_diff_clipping`` takes one client's state, or under
``torch.func.vmap`` each row of a stacked ``[K, ...]`` cohort: one global
L2 norm per client over every entry. ``add_gaussian_noise`` draws the JAX
package's own noise: the key splits into one key per leaf in the order
``jax.tree.flatten`` takes the flax params (``robust_agg.model_leaves``
over ``convert``'s names), each leaf's normals are drawn in its flax layout
(utils/prng, Threefry on the state's device) and moved into the port's
layout by the same index map, so each weight gets the draw the JAX package
gives the same weight.

A model's extras (BatchNorm statistics, ``extra_keys``) are not weights:
the JAX package clips and noises ``NetState.params`` and passes
``NetState.extra`` through (algorithms/fedavg_robust.py there). Given
``extra_keys``, the clip's norm and scale cover the params alone, and the
noise's key splits over the param leaves alone, so each param's draw stays
the one the JAX package makes for it; the extras come out as they came in.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from fedml_tpu_torch.utils import prng


def norm_diff_clipping(local_net: dict, global_net: dict,
                       norm_bound: float, extra_keys=()) -> dict:
    """Clip the client->server update (w_local - w_global) to an L2 ball of
    radius ``norm_bound``, then re-add the global weights
    (robust_aggregation.py:38-49). Entries named in ``extra_keys`` are
    outside the norm and pass through unclipped."""
    diff = {k: local_net[k] - global_net[k] for k in local_net
            if k not in extra_keys}
    sq = sum(torch.sum(d * d) for d in diff.values())
    norm = torch.sqrt(sq)
    scale = torch.clamp_max(norm_bound / torch.clamp_min(norm, 1e-12), 1.0)
    return {k: local_net[k] if k in extra_keys
            else global_net[k] + diff[k] * scale for k in local_net}


@functools.lru_cache(maxsize=8)
def _leaf_layout(spec: tuple, extra_keys: tuple):
    """For a state of ``spec`` = ((key, shape), ...) in dict order: the
    per-leaf sizes in ``jax.tree.flatten`` order of its flax params (a
    model's extras, named by ``extra_keys``, come after them and draw
    nothing), and the index that takes the concatenated flax-order
    coordinates to the port's flattened order (None when the two orders
    agree)."""
    from fedml_tpu_torch.core.robust_agg import model_leaves

    index, off, n_extra = {}, 0, 0
    for key, shape in spec:
        n = int(np.prod(shape, dtype=np.int64))
        index[key] = torch.arange(off, off + n).reshape(shape)
        off += n
        n_extra += n if key in extra_keys else 0
    leaves = [np.asarray(leaf).ravel() for leaf in model_leaves(index)]
    sizes, total = [], 0
    for leaf in leaves:  # the params' leaves: all but the trailing extras
        if total >= off - n_extra:
            break
        sizes.append(int(leaf.size))
        total += int(leaf.size)
    if total != off - n_extra:
        raise ValueError("the extras are not the trailing leaves of this "
                         "state's flattening")
    perm = np.concatenate(leaves) if leaves else np.zeros(0, np.int64)
    if np.array_equal(perm, np.arange(off)):
        return tuple(sizes), None
    inv = np.empty_like(perm)
    inv[perm] = np.arange(off)
    inv.setflags(write=False)  # one cached array serves every caller
    return tuple(sizes), inv


@functools.lru_cache(maxsize=8)
def _inv_on(spec: tuple, extra_keys: tuple, device: str) -> torch.Tensor:
    return torch.as_tensor(_leaf_layout(spec, extra_keys)[1], device=device)


def gaussian_noise_like(rng, net: dict, extra_keys=()) -> dict:
    """Unit normals shaped like ``net``'s params: ``jax.random.normal`` of
    each flax params leaf under ``split(rng, n_param_leaves)`` in the JAX
    treedef's order (see the module docstring), drawn on the state's
    device. Entries named in ``extra_keys`` get no noise entry."""
    extra_keys = tuple(sorted(extra_keys))
    spec = tuple((k, tuple(v.shape)) for k, v in net.items())
    device = next(iter(net.values())).device
    sizes, inv = _leaf_layout(spec, extra_keys)
    keys = prng.split(rng, len(sizes))
    flat = prng.normal_from_bits(
        prng.random_bits_multi(keys, sizes, device))
    n_total = sum(v.numel() for v in net.values())
    if flat.numel() < n_total:  # the extras' coordinates, after the params
        flat = torch.cat([flat, flat.new_zeros(n_total - flat.numel())])
    if inv is not None:
        flat = flat[_inv_on(spec, extra_keys, str(device))]
    out, off = {}, 0
    for k, v in net.items():
        n = v.numel()
        if k not in extra_keys:
            out[k] = flat[off:off + n].reshape(v.shape).to(v.dtype)
        off += n
    return out


def add_gaussian_noise(rng, net: dict, stddev, extra_keys=()) -> dict:
    """Weak differential privacy: add N(0, stddev^2) to every weight
    (robust_aggregation.py:51-55); entries named in ``extra_keys`` pass
    through untouched. ``rng`` is a key's uint32 words (utils/prng);
    ``stddev`` a float or a scalar tensor."""
    noise = gaussian_noise_like(rng, net, extra_keys)
    return {k: v + stddev * noise[k] if k in noise else v
            for k, v in net.items()}
