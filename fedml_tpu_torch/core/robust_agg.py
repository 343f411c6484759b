"""Byzantine-robust aggregation, port of fedml_tpu/core/robust_agg.py over
stacked state dicts (every entry ``[K, ...]``, one row per uploading
client) and ``[K]`` sample weights (0 = an excluded slot: zero-sample
padding and gate-rejected clients alike). Plain torch ops on the tensors'
device; the reference is XLA-compiled ``jnp`` code with no hand kernel.

Aggregators (each ``fn(stacked, weights) -> (state, info)``):

- ``mean``               the ``tree_weighted_mean`` baseline;
- ``median``             coordinate-wise weighted (lower) median;
- ``trimmed_mean``       coordinate-wise weighted trimmed mean (the outer
                         ``trim`` fraction of total weight cut at each end);
- ``krum`` / ``multi_krum``  Krum scores over the flattened updates: the
                         minimizer, or the sample-weighted mean of the ``m``
                         best; ``info['suspected']`` flags the ``f`` worst;
- ``geometric_median``   a fixed-iteration Weiszfeld loop.

The sanitation gate (``sanitize_updates``) runs before any of them: it
rejects non-finite updates and norm outliers (beyond ``norm_mult`` x the
UNWEIGHTED median norm of the finite participants), replaces a rejected
client's update with the global model and zeroes its weight. The
two-phase composition (``update_evidence`` -> ``evidence_verdicts`` ->
``apply_verdicts`` -> ``pairwise_finalize``) recasts each estimator as
per-slot verdict weights over norms and a fixed-size Rademacher sketch of
each update, and folds the survivors with the canonical pairwise
association (``pairwise_sum``). Per-slot int32 reason codes become
``QuarantineLedger`` entries, the artifact the engine and the
cross-process server must agree on, in this package and with the JAX
package.

Exact correspondences with the reference: sorts are stable (``jnp.argsort``
is), multi-Krum's selection is a stable ascending sort of the scores (what
``lax.top_k`` of their negation returns, lower index first on ties), and
the sketch's ±1 pattern is ``jax.random.rademacher(PRNGKey(0x5EDC0FFE),
(n,))`` reproduced bit for bit by a numpy Threefry-2x32 (``sketch_signs``),
applied to the update flattened in the reference's leaf order and layout
(``reference_order``). Distance matmuls must run in float32 (the engine and
server call these under ``float32_compute``; TF32 moves selections).

The edge tier of the hierarchical runtime (``nonfinite_gate``,
``edge_partial``, ``combine_edge_partials``; distributed/fedavg/
hierarchy.py) folds contiguous power-of-two blocks of cohort slots at the
edges and their partials at the root, bitwise the flat pairwise fold.

Still refused here: ``gated_aggregate(reshard_fn=)`` (the sharded server
state, ROADMAP.md queue A item 12).
"""

from __future__ import annotations

import functools
import threading

import numpy as np
import torch

from fedml_tpu_torch.utils.prng import _threefry2x32
from fedml_tpu_torch.utils.tree import tree_weighted_mean

# per-slot quarantine reason codes (int32 in the gate; names in ledgers),
# the reference's vocabulary and order: 0..3 come from the gate and the
# estimators, the rest are recorded by the server runtimes directly
REASONS = ("ok", "nonfinite", "norm_outlier", "suspected", "undecodable",
           "edge_lost", "secagg_dropout", "secagg_shed", "server_restart")
REASON_OK, REASON_NONFINITE, REASON_NORM_OUTLIER, REASON_SUSPECTED = range(4)

# sanitation default: reject ||update|| > 4x the median norm
DEFAULT_NORM_MULT = 4.0

AGGREGATORS = ("mean", "median", "trimmed_mean", "krum", "multi_krum",
               "geometric_median")


def _first(stacked: dict) -> torch.Tensor:
    return next(iter(stacked.values()))


def _wshape(w, leaf):
    """[K] weights broadcast-shaped against a [K, ...] leaf."""
    return w.reshape((w.shape[0],) + (1,) * (leaf.ndim - 1))


def _as_weights(weights, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(weights, dtype=torch.float32, device=like.device)


def _sorted_with_weights(x, w):
    """Per-coordinate ascending (stable) sort of a [K, ...] leaf with the
    [K] weights carried along each coordinate's order."""
    order = torch.argsort(x, dim=0, stable=True)
    xs = torch.take_along_dim(x, order, dim=0)
    ws = torch.take_along_dim(_wshape(w, x).expand_as(x), order, dim=0)
    return xs, ws


def _median_leaf(x, w):
    xs, ws = _sorted_with_weights(x, w)
    cum = torch.cumsum(ws, 0)
    half = cum[-1:].clamp_min(1e-12) * 0.5
    idx = (cum >= half).to(torch.int8).argmax(0)  # the first slot reaching it
    return torch.take_along_dim(xs, idx[None], dim=0)[0]


def weighted_median(stacked: dict, weights) -> dict:
    """Coordinate-wise weighted (lower) median over the leading client
    axis: the smallest value whose cumulative weight reaches half the
    total. Zero-weight slots contribute nothing."""
    w = _as_weights(weights, _first(stacked))
    return {k: _median_leaf(x, w) for k, x in stacked.items()}


def weighted_trimmed_mean(stacked: dict, weights, trim: float = 0.2) -> dict:
    """Coordinate-wise weighted trimmed mean: each coordinate's sorted
    weight intervals are clipped to the central ``[trim*W, (1-trim)*W]``
    band of total weight ``W`` and averaged with the clipped widths."""
    if not 0.0 <= trim < 0.5:
        raise ValueError(f"trim must be in [0, 0.5), got {trim}")
    w = _as_weights(weights, _first(stacked))

    def tmean(x):
        xs, ws = _sorted_with_weights(x, w)
        cum = torch.cumsum(ws, 0)
        total = cum[-1:]
        lo, hi = trim * total, (1.0 - trim) * total
        eff = (torch.minimum(cum, hi)
               - torch.maximum(cum - ws, lo)).clamp_min(0.0)
        return (xs * eff).sum(0) / eff.sum(0).clamp_min(1e-12)

    return {k: tmean(x) for k, x in stacked.items()}


def _flatten_clients(stacked: dict) -> torch.Tensor:
    """[K, D] matrix of per-client flattened updates (every entry raveled
    past the client axis and concatenated, in float32)."""
    k = _first(stacked).shape[0]
    return torch.cat([x.reshape(k, -1).float() for x in stacked.values()], 1)


def krum_scores(stacked: dict, weights, f: int) -> torch.Tensor:
    """Krum scores: for each valid client, the sum of its ``n - f - 2``
    smallest squared distances to OTHER valid clients (n = the number of
    positive-weight slots). Invalid slots (weight 0) score +inf and are
    never anyone's neighbor."""
    v = _flatten_clients(stacked)
    k = v.shape[0]
    valid = _as_weights(weights, v) > 0
    sq = (v * v).sum(1)
    d2 = (sq[:, None] + sq[None, :] - 2.0 * (v @ v.T)).clamp_min(0.0)
    inf = torch.full_like(d2, float("inf"))
    eye = torch.eye(k, dtype=torch.bool, device=v.device)
    d2 = torch.where(eye | ~valid[None, :], inf, d2)
    n_neighbors = (valid.sum() - f - 2).clamp_min(1)
    ds = torch.sort(d2, dim=1).values
    take = torch.arange(k, device=v.device)[None, :] < n_neighbors
    score = torch.where(take, ds, torch.zeros_like(ds)).sum(1)
    return torch.where(valid, score, torch.full_like(score, float("inf")))


def _krum_suspected(score, valid, f: int):
    """The ``f`` worst-scoring VALID slots (ties broken by slot order);
    invalid slots sort last, so a gate-rejected slot is never reported
    again. Shared by the stacked estimator and the verdict estimator."""
    if f <= 0:
        return torch.zeros(score.shape, dtype=torch.bool, device=score.device)
    key = torch.where(valid, -score, torch.full_like(score, float("inf")))
    rank_from_worst = torch.argsort(torch.argsort(key, stable=True),
                                    stable=True)
    return valid & (rank_from_worst < valid.sum().clamp_max(f))


def _best_slots(score, m: int):
    """The ``m`` best (lowest) scores' slots, lower index first on ties:
    the reference's ``lax.top_k(-score, m)``."""
    return torch.argsort(score, stable=True)[:min(m, score.shape[0])]


def krum(stacked: dict, weights, f: int, m: int = 1):
    """(Multi-)Krum: ``m=1`` returns the single client minimizing the Krum
    score; ``m>1`` sample-weight-averages the ``m`` best-scoring clients.
    ``info['suspected']`` flags the ``f`` WORST-scoring valid clients."""
    score = krum_scores(stacked, weights, f)
    valid = torch.isfinite(score)
    if m <= 1:
        win = torch.argmin(score)
        agg = {k: x[win] for k, x in stacked.items()}
    else:
        sel = _best_slots(score, m)
        w = _as_weights(weights, score)
        sel_w = torch.where(torch.isfinite(score[sel]), w[sel],
                            torch.zeros_like(w[sel]))
        agg = tree_weighted_mean({k: x[sel] for k, x in stacked.items()},
                                 sel_w)
    return agg, {"suspected": _krum_suspected(score, valid, f)}


def geometric_median(stacked: dict, weights, iters: int = 8,
                     eps: float = 1e-8) -> dict:
    """Weighted geometric median by a fixed-iteration Weiszfeld loop,
    initialized at the weighted mean. Zero-weight slots drop out of every
    reweighting."""
    v = _flatten_clients(stacked)
    w = _as_weights(weights, v)
    z = (w @ v) / w.sum().clamp_min(1e-12)
    for _ in range(iters):
        d = ((v - z[None, :]) ** 2).sum(1).sqrt()
        beta = w / d.clamp_min(eps)
        z = (beta @ v) / beta.sum().clamp_min(1e-12)
    out, off = {}, 0
    for key, leaf in stacked.items():
        n = leaf[0].numel()
        out[key] = z[off:off + n].reshape(leaf.shape[1:]).to(leaf.dtype)
        off += n
    return out


def make_robust_aggregator(name: str, n: int, f: int | None = None,
                           trim: float | None = None, m: int | None = None,
                           iters: int = 8):
    """Build ``fn(stacked, weights) -> (state, info)`` for aggregator
    ``name`` over ``n`` client slots. ``f`` is the Byzantine budget
    (default ``(n-3)//2``, Krum's maximum); ``trim`` the per-end trim
    fraction (default ``max(f/n, 0.1)``); ``m`` multi-Krum's selection
    count (default ``n - f - 2``)."""
    if name not in AGGREGATORS:
        raise ValueError(f"unknown aggregator {name!r} (one of {AGGREGATORS})")
    if f is None:
        f = max((n - 3) // 2, 0)
    if not 0 <= f < n:
        raise ValueError(f"f={f} must be in [0, {n})")
    if name == "mean":
        return lambda s, w: (tree_weighted_mean(s, _as_weights(w, _first(s))),
                             {})
    if name == "median":
        return lambda s, w: (weighted_median(s, w), {})
    if name == "trimmed_mean":
        t = max(f / n, 0.1) if trim is None else trim
        return lambda s, w: (weighted_trimmed_mean(s, w, trim=t), {})
    if name in ("krum", "multi_krum"):
        if n < 2 * f + 3:
            raise ValueError(f"krum needs n >= 2f+3 (n={n}, f={f})")
        mm = 1 if name == "krum" else (max(n - f - 2, 1) if m is None
                                       else int(m))
        return functools.partial(krum, f=f, m=mm)
    return lambda s, w: (geometric_median(s, w, iters=iters), {})


# -------------------------------------------------- pairwise association
# The canonical balanced-binary summation: at every level adjacent pairs
# are added (odd tails padded with exact-zero terms), so folding
# contiguous power-of-two blocks and then their partials is bitwise the
# flat fold. Opt-in (``gated_aggregate(pairwise=True)``, the server's
# ``sum_assoc='pairwise'``); the default weighted mean keeps its tensordot.

def pairwise_sum(x: torch.Tensor) -> torch.Tensor:
    """Fold a [N, ...] tensor over dim 0 with the canonical pairwise
    association."""
    n = x.shape[0]
    if n == 0:
        return torch.zeros(x.shape[1:], dtype=x.dtype, device=x.device)
    while n > 1:
        if n % 2:
            x = torch.cat([x, torch.zeros_like(x[:1])])
            n += 1
        x = x[0::2] + x[1::2]
        n //= 2
    return x[0]


def pairwise_weighted_stats(stacked: dict, weights):
    """(weighted-sum state, total weight) over the leading client axis with
    the canonical association: terms ``w_k * u_k`` are formed per slot
    (float32) and pairwise-folded; the weight total folds the same way.
    The slot axis is zero-padded to EVEN length BEFORE the term multiply,
    as the reference does (there it makes XLA's fma contraction of the
    first level independent of K's parity; here torch's separate kernels
    contract nothing, so across packages the folds agree to rounding)."""
    w = _as_weights(weights, _first(stacked))
    if w.shape[0] % 2:
        w = torch.cat([w, w.new_zeros(1)])
        stacked = {k: torch.cat([s, torch.zeros_like(s[:1])])
                   for k, s in stacked.items()}
    wsum = {k: pairwise_sum(s.float() * _wshape(w, s))
            for k, s in stacked.items()}
    return wsum, pairwise_sum(w)


def pairwise_finalize(wsum: dict, total, global_state: dict) -> dict:
    """wsum / total, or the global model when no weight survived: the one
    division site of the pairwise and two-phase paths."""
    alive = total > 0
    den = total.clamp_min(1e-12)
    return {k: torch.where(alive, s / den, global_state[k].to(s.dtype))
            for k, s in wsum.items()}


# ----------------------------------------------------- the edge tier
# An edge aggregator (distributed/fedavg/hierarchy.py) folds its block of
# C cohort slots into one partial; the root folds the E partials. Any
# container of entries in a fixed order serves as a state here: an edge
# passes its workers' wire leaves keyed by position, the root its state
# dicts. With C a power of two the blocks are aligned sub-trees of the
# canonical fold, so the tree's result is bitwise the flat pairwise one.

def nonfinite_gate(stacked: dict, global_state: dict, weights):
    """The per-slot half of ``sanitize_updates``, non-finite rejection
    only: ``(clean_stacked, new_weights, reasons)``. A verdict depends on
    its slot alone, so an edge gating its own children reaches the
    verdicts a flat server reaches for those slots. The single-phase
    tree's whole defense; the cohort statistics (norm rule, estimators)
    cross the tiers through the two-phase evidence/verdict protocol."""
    first = _first(stacked)
    w = _as_weights(weights, first)
    k = w.shape[0]
    finite = torch.ones(k, dtype=torch.bool, device=first.device)
    for s in stacked.values():
        finite &= torch.isfinite(s).reshape(k, -1).all(1)
    reasons = torch.where(finite, REASON_OK, REASON_NONFINITE)
    reasons = torch.where(w > 0, reasons, REASON_OK).to(torch.int32)
    new_w = torch.where(finite, w, torch.zeros_like(w))
    return _replace_rejected(stacked, global_state, ~finite), new_w, reasons


def edge_partial(stacked: dict, global_state: dict, weights):
    """One edge's round step: the non-finite gate over its children, then
    the canonical pairwise partial. Returns ``(wsum_state, total_weight,
    reasons)``: the weighted SUM and its weight ride the uplink (the
    division happens once, at the root), the reasons carry the per-child
    verdicts into the root's ledger."""
    clean, w, reasons = nonfinite_gate(stacked, global_state, weights)
    wsum, total = pairwise_weighted_stats(clean, w)
    return wsum, total, reasons


def combine_edge_partials(partial_stack: dict, totals, global_state: dict):
    """The root's combine: pairwise-fold the stacked ``[E, ...]`` edge
    partials and the ``[E]`` totals, then ``pairwise_finalize``. Returns
    ``(avg_state, total_weight)``."""
    wsum = {k: pairwise_sum(s) for k, s in partial_stack.items()}
    total = pairwise_sum(_as_weights(totals, _first(partial_stack)))
    return pairwise_finalize(wsum, total, global_state), total


# ----------------------------------------- two-phase robust (evidence/verdict)
# phase 1 update_evidence: per-slot norm, finite flag, weight and a
#   fixed-size chunked-Rademacher sketch of the flattened update (per-row
#   reductions only, so a block's rows are the cohort's);
# phase 2 evidence_verdicts: the gate's norm-median rule plus an estimator
#   selection over the sketches -> per-slot verdict weights and reasons;
# phase 3 apply_verdicts: zero-verdict slots replaced by the global model,
#   survivors folded with the canonical pairwise association.
# make_verdict_estimator recasts each aggregator over the evidence: mean
# (the gate's weights), krum (the sketch-space Krum winner, weight 1.0),
# multi_krum (sample weights on the m best), median (the weighted medoid),
# trimmed_mean (winsorized interval weights over the distance-to-center
# order) and geometric_median (the last Weiszfeld reweighting in sketch
# space).

EVIDENCE_SKETCH_DIM = 64  # f32 scalars per client the sketch budget ships
_SKETCH_SEED = 0x5EDC0FFE  # fixed: both runtimes and both packages draw it


@functools.lru_cache(maxsize=4)
def sketch_signs(n: int) -> np.ndarray:
    """The sketch's ±1 pattern of length ``n`` (float32), bit for bit
    ``jax.random.rademacher(jax.random.PRNGKey(0x5EDC0FFE), (n,))`` under
    jax's partitionable Threefry: element i hashes the counter
    (hi32(i), lo32(i)) under the key (0, seed), the two output words are
    XORed, and bit 31 clear means +1."""
    i = np.arange(n, dtype=np.uint64)
    hi = (i >> np.uint64(32)).astype(np.uint32)
    lo = (i & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    a, b = _threefry2x32((_SKETCH_SEED >> 32, _SKETCH_SEED & 0xFFFFFFFF),
                         hi, lo)
    signs = np.where((a ^ b) >> np.uint32(31), np.float32(-1.0),
                     np.float32(1.0)).astype(np.float32)
    signs.setflags(write=False)  # one cached array serves every caller
    return signs


@functools.lru_cache(maxsize=4)
def _signs_on(n: int, device: str) -> torch.Tensor:
    """``sketch_signs(n)`` kept on ``device`` (4 bytes a coordinate)."""
    return torch.tensor(sketch_signs(n), device=device)


@functools.lru_cache(maxsize=4)
def _order_on(spec: tuple, device: str) -> torch.Tensor:
    """``reference_order(spec)`` kept on ``device``."""
    return torch.tensor(reference_order(spec), device=device)


def _is_model_state(keys) -> bool:
    return bool({"conv1.weight", "linear.weight", "pos_emb"} & set(keys))


@functools.lru_cache(maxsize=8)
def reference_order(spec: tuple) -> np.ndarray | None:
    """For a state whose entries are ``spec`` = ((key, per-client shape),
    ...) in dict order: the index that reorders its flattened row into the
    JAX package's flattening of the same state, ``jax.tree.leaves`` of
    the flax params (sorted paths, flax layouts: ``convert.to_flax``), or
    of a plain dict (sorted keys). None when the orders already agree."""
    from fedml_tpu_torch.comm.message import _flat_items
    from fedml_tpu_torch.convert import to_flax

    index, off = {}, 0
    for key, shape in spec:
        n = int(np.prod(shape, dtype=np.int64))
        index[key] = torch.arange(off, off + n).reshape(shape)
        off += n
    # the wire's leaf order (pack_pytree): sorted paths of the flax params;
    # the attention kernels' flattening does not depend on the head count,
    # so any divisor of the width will do
    tree = to_flax(index, num_heads=1) if _is_model_state(index) else index
    leaves = [np.asarray(leaf).ravel() for _, leaf in _flat_items(tree)]
    perm = np.concatenate(leaves) if leaves else np.zeros(0, np.int64)
    if np.array_equal(perm, np.arange(off)):
        return None
    perm.setflags(write=False)  # one cached array serves every caller
    return perm


def update_sketch(stacked: dict, global_state: dict,
                  sketch_dim: int = EVIDENCE_SKETCH_DIM) -> torch.Tensor:
    """``[K, sketch_dim]`` chunked-Rademacher sketch of the flattened
    updates ``u_k = s_k - g`` (flattened as the JAX package flattens the
    same state, see ``reference_order``): coordinates are sign-flipped by
    the fixed ±1 pattern and summed in ``sketch_dim`` contiguous buckets.
    Non-finite entries are masked to zero (those slots die at the gate)."""
    first = _first(stacked)
    k = first.shape[0]
    if sketch_dim <= 0:
        return torch.zeros((k, 0), dtype=torch.float32, device=first.device)
    rows = []
    for key, s in stacked.items():
        d = s.float() - global_state[key].float()[None]
        d = torch.where(torch.isfinite(d), d, torch.zeros_like(d))
        rows.append(d.reshape(k, -1))
    flat = torch.cat(rows, 1)
    spec = tuple((key, tuple(s.shape[1:])) for key, s in stacked.items())
    if reference_order(spec) is not None:
        flat = flat.index_select(1, _order_on(spec, str(flat.device)))
    dsz = flat.shape[1]
    chunk = -(-dsz // sketch_dim)  # ceil: bucket width
    pad = sketch_dim * chunk - dsz
    if pad:
        flat = torch.cat([flat, flat.new_zeros(k, pad)], 1)
    signs = _signs_on(sketch_dim * chunk, str(flat.device))
    return (flat * signs[None, :]).reshape(k, sketch_dim, chunk).sum(-1)


def update_evidence(stacked: dict, global_state: dict, weights,
                    sketch_dim: int = EVIDENCE_SKETCH_DIM) -> dict:
    """Phase 1: the per-slot evidence dict — norm, finite flag, weight and
    sketch row, ``sketch_dim + 3`` scalars a client."""
    finite, norm = _slot_evidence(stacked, global_state)
    return {"norm": norm, "finite": finite,
            "sketch": update_sketch(stacked, global_state, sketch_dim),
            "weight": _as_weights(weights, norm)}


def _scatter_set(w, index, values):
    """A zero [K] tensor with ``values`` at ``index``."""
    return torch.zeros_like(w).index_put((index,), values)


def make_verdict_estimator(name: str, n: int, f: int | None = None,
                           trim: float | None = None, m: int | None = None,
                           iters: int = 8):
    """Build the evidence-phase estimator ``fn(sketch, gate_w) ->
    (verdict_weights, suspected)`` for aggregator ``name`` over ``n``
    cohort slots — the tiered form of :func:`make_robust_aggregator`, with
    its budget defaults and validation."""
    if name not in AGGREGATORS:
        raise ValueError(f"unknown aggregator {name!r} (one of {AGGREGATORS})")
    if f is None:
        f = max((n - 3) // 2, 0)
    if not 0 <= f < n:
        raise ValueError(f"f={f} must be in [0, {n})")

    if name == "mean":
        return lambda sk, w: (w, None)

    if name in ("krum", "multi_krum"):
        if n < 2 * f + 3:
            raise ValueError(f"krum needs n >= 2f+3 (n={n}, f={f})")
        mm = 1 if name == "krum" else (max(n - f - 2, 1) if m is None
                                       else int(m))

        def krum_verdicts(sk, w):
            score = krum_scores({"sketch": sk}, w, f)
            valid = torch.isfinite(score)
            if mm <= 1:
                # weight exactly 1.0 on the winner (x * 1.0 / 1.0 is x);
                # an all-invalid cohort keeps zero weight everywhere
                vw = _scatter_set(w, torch.argmin(score)[None],
                                  w.new_ones(1))
                vw = torch.where(valid.any(), vw, torch.zeros_like(vw))
            else:
                # bounded by the realized slot count, not construction's n
                sel = _best_slots(score, mm)
                selected = _scatter_set(w, sel, w.new_ones(sel.shape[0])) > 0
                vw = torch.where(selected & valid, w, torch.zeros_like(w))
            return vw, _krum_suspected(score, valid, f)

        return krum_verdicts

    if name == "median":
        def medoid_verdicts(sk, w):
            # the weighted MEDOID: argmin_i sum_j w_j ||sk_i - sk_j||
            valid = w > 0
            sq = (sk * sk).sum(1)
            d2 = (sq[:, None] + sq[None, :] - 2.0 * (sk @ sk.T)).clamp_min(0.0)
            cost = d2.sqrt() @ torch.where(valid, w, torch.zeros_like(w))
            cost = torch.where(valid, cost, torch.full_like(cost,
                                                            float("inf")))
            vw = _scatter_set(w, torch.argmin(cost)[None], w.new_ones(1))
            return torch.where(valid.any(), vw, torch.zeros_like(vw)), None

        return medoid_verdicts

    if name == "trimmed_mean":
        t = max(f / n, 0.1) if trim is None else trim
        if not 0.0 <= t < 0.5:
            raise ValueError(f"trim must be in [0, 0.5), got {t}")

        def trimmed_verdicts(sk, w):
            # winsorized interval weights over the distance-to-center
            # order: the farthest 2*trim of total weight is trimmed
            total = w.sum()
            center = (w @ sk) / total.clamp_min(1e-12)
            dist = ((sk - center[None, :]) ** 2).sum(1).sqrt()
            dist = torch.where(w > 0, dist, torch.full_like(dist,
                                                            float("inf")))
            order = torch.argsort(dist, stable=True)
            ws = w[order]
            cum = torch.cumsum(ws, 0)
            hi = (1.0 - 2.0 * t) * total
            eff = (torch.minimum(cum, hi) - (cum - ws)).clamp_min(0.0)
            return _scatter_set(w, order, eff), None

        return trimmed_verdicts

    def weiszfeld_verdicts(sk, w):
        z = (w @ sk) / w.sum().clamp_min(1e-12)
        # iters-1 refinement steps; the final reweighting IS the verdict
        for _ in range(max(iters - 1, 0)):
            d = ((sk - z[None, :]) ** 2).sum(1).sqrt()
            beta = w / d.clamp_min(1e-8)
            z = (beta @ sk) / beta.sum().clamp_min(1e-12)
        d = ((sk - z[None, :]) ** 2).sum(1).sqrt()
        return w / d.clamp_min(1e-8), None

    return weiszfeld_verdicts


def evidence_verdicts(evidence: dict, verdict_fn,
                      norm_mult: float | None = None):
    """Phase 2, the one cohort-global verdict composition: gate
    (``gate_verdicts``) -> estimator selection -> ``suspected`` merged into
    the gate's reasons (gate reasons win). Returns ``(verdict_weights,
    reasons)``, both ``[K]``."""
    w = evidence["weight"].float()
    mult = float("inf") if norm_mult is None else norm_mult
    _, gate_w, reasons = gate_verdicts(evidence["norm"].float(),
                                       evidence["finite"].bool(), w, mult)
    vw, suspected = verdict_fn(evidence["sketch"].float(), gate_w)
    if suspected is not None:
        reasons = torch.where((reasons == REASON_OK) & suspected,
                              REASON_SUSPECTED, reasons).to(torch.int32)
    return vw, reasons


def _replace_rejected(stacked: dict, global_state: dict, replace) -> dict:
    """Slots flagged by ``replace`` take the global model's values."""
    return {k: torch.where(_wshape(replace, s),
                           global_state[k][None].to(s.dtype), s)
            for k, s in stacked.items()}


def apply_verdicts(stacked: dict, global_state: dict, vweights):
    """Phase 3, the survivor fold: zero-verdict slots are replaced by the
    global model (a NaN under a zero weight would still poison ``0 *
    nan``) and fold as exact zero terms; survivors fold with the canonical
    pairwise association. Returns ``(wsum_state, total_weight)``."""
    vw = _as_weights(vweights, _first(stacked))
    return pairwise_weighted_stats(
        _replace_rejected(stacked, global_state, ~(vw > 0)), vw)


def verdict_flush(stacked: dict, global_state: dict, evidence: dict,
                  verdict_fn, norm_mult: float | None = None):
    """The flush half of the two-phase composition: ``evidence_verdicts``
    -> ``apply_verdicts`` -> ``pairwise_finalize`` over precomputed
    evidence rows. Returns ``(avg_state, verdict_weights, reasons)``."""
    vw, reasons = evidence_verdicts(evidence, verdict_fn, norm_mult=norm_mult)
    wsum, total = apply_verdicts(stacked, global_state, vw)
    return pairwise_finalize(wsum, total, global_state), vw, reasons


# ------------------------------------------------------------------ gate
def _slot_evidence(stacked: dict, global_state: dict):
    """Per-slot ``(finite, norm)``: the all-entries-finite flag and
    ``||u_k - g||`` with non-finite entries masked out of the sum (they are
    rejected by the flag already). Per-row reductions only, so a slot's
    values do not depend on how many slots share the stack."""
    first = _first(stacked)
    k, dev = first.shape[0], first.device
    finite = torch.ones(k, dtype=torch.bool, device=dev)
    norm_sq = torch.zeros(k, dtype=torch.float32, device=dev)
    for key, s in stacked.items():
        finite &= torch.isfinite(s).reshape(k, -1).all(1)
        d = s.float() - global_state[key].float()[None]
        d = torch.where(torch.isfinite(d), d, torch.zeros_like(d))
        norm_sq += (d ** 2).reshape(k, -1).sum(1)
    return finite, norm_sq.sqrt()


def gate_verdicts(norm, finite, weights, norm_mult: float):
    """``(replace, new_weights, reasons)`` from per-slot evidence: reject
    non-finite slots, and finite participating slots whose norm exceeds
    ``norm_mult`` x the UNWEIGHTED median norm of the finite participants
    (one vote per client: sample counts are client-reported)."""
    w = weights.float()
    live = finite & (w > 0)
    med = _median_leaf(norm, live.float())
    outlier = live & (norm > norm_mult * med.clamp_min(1e-12))
    replace = ~finite | outlier
    reasons = torch.where(~finite, REASON_NONFINITE,
                          torch.where(outlier, REASON_NORM_OUTLIER, REASON_OK))
    reasons = torch.where(w > 0, reasons, REASON_OK).to(torch.int32)
    return replace, torch.where(replace, torch.zeros_like(w), w), reasons


def sanitize_updates(stacked: dict, global_state: dict, weights,
                     norm_mult: float = DEFAULT_NORM_MULT):
    """The sanitation gate: ``(clean_stacked, new_weights, reasons)``. A
    rejected slot's update is REPLACED by the global model and its weight
    zeroed (weights alone leave NaNs free to poison ``0 * nan`` products;
    values alone leave the reject in the weight mass). ``norm_mult=inf``
    disarms the norm rule and keeps the non-finite one."""
    finite, norm = _slot_evidence(stacked, global_state)
    replace, new_w, reasons = gate_verdicts(
        norm, finite, _as_weights(weights, norm), norm_mult)
    return _replace_rejected(stacked, global_state, replace), new_w, reasons


def gated_aggregate(stacked: dict, global_state: dict, weights,
                    robust_fn=None, norm_mult: float | None = None,
                    reshard_fn=None, pairwise: bool = False, verdict_fn=None,
                    sketch_dim: int = EVIDENCE_SKETCH_DIM):
    """The verdict composition both runtimes share: gate (``norm_mult``
    given; None = off) -> estimator (``robust_fn``, or the weighted mean)
    -> the estimator's ``suspected`` merged into the gate's reasons (gate
    reasons win) -> the global model when every slot was rejected.

    ``pairwise`` folds the weighted mean with the canonical association
    (mean only: robust estimators take their tiered form through
    ``verdict_fn``). ``verdict_fn`` (``make_verdict_estimator``) switches
    to the two-phase composition, ``update_evidence`` ->
    ``verdict_flush``; ``robust_fn`` and ``pairwise`` must stay unset
    with it. ``reshard_fn`` (a sharded server state) is not ported.

    Returns ``(avg_state, surviving_weights, reasons)``; ``reasons`` is
    None only when the gate is off and the estimator reported nothing."""
    if reshard_fn is not None:
        raise NotImplementedError(
            "gated_aggregate(reshard_fn=) serves a sharded server state, "
            "not ported yet: ROADMAP.md queue A, item 12")
    if pairwise and robust_fn is not None:
        raise ValueError("pairwise association is the weighted-mean "
                         "contract — robust estimators' tiered form is "
                         "verdict_fn (make_verdict_estimator)")
    if verdict_fn is not None:
        if robust_fn is not None or pairwise:
            raise ValueError("verdict_fn IS the two-phase composition — "
                             "it does not stack with robust_fn/pairwise")
        ev = update_evidence(stacked, global_state, weights,
                             sketch_dim=sketch_dim)
        return verdict_flush(stacked, global_state, ev, verdict_fn,
                             norm_mult=norm_mult)
    w = _as_weights(weights, _first(stacked))
    reasons = None
    agg_in = stacked
    if norm_mult is not None:
        agg_in, w, reasons = sanitize_updates(stacked, global_state, w,
                                              norm_mult=norm_mult)
    if pairwise:
        wsum, total = pairwise_weighted_stats(agg_in, w)
        return pairwise_finalize(wsum, total, global_state), w, reasons
    if robust_fn is not None:
        avg, info = robust_fn(agg_in, w)
        sus = info.get("suspected")
        if sus is not None:
            base = (reasons if reasons is not None
                    else torch.zeros(sus.shape, dtype=torch.int32,
                                     device=sus.device))
            reasons = torch.where((base == REASON_OK) & sus,
                                  REASON_SUSPECTED, base).to(torch.int32)
    else:
        avg = tree_weighted_mean(agg_in, w)
    if reasons is not None:
        alive = w.sum() > 0
        avg = {k: torch.where(alive, a, global_state[k].to(a.dtype))
               for k, a in avg.items()}
    return avg, w, reasons


# ---------------------------------------------------------------- ledger
class QuarantineLedger:
    """Thread-safe record of per-round gate/aggregator verdicts; ``rank``
    is the 1-based worker rank, which in the engine is the stacked slot
    index + 1 (the client the loopback runtime's rank trains). The
    reference's ledger; the engine's and the server's entries must agree
    for the same adversary plan, and with the JAX package's."""

    def __init__(self):
        self._entries: list[dict] = []
        self._lock = threading.Lock()
        # crash-recovery journal hook: callable(entry_dict) invoked per
        # verdict so the server's WAL carries a forensic trail of
        # mid-round quarantines; the ledger's commit-time authority stays
        # quarantine.json. None = no journaling, zero extra work.
        self.journal = None

    def record(self, round_idx: int, rank: int, reason: str,
               client=None) -> None:
        if reason not in REASONS or reason == "ok":
            raise ValueError(f"unrecordable quarantine reason {reason!r}")
        entry = {
            "round": int(round_idx), "rank": int(rank),
            "reason": reason,
            "client": None if client is None else int(client),
        }
        with self._lock:
            self._entries.append(entry)
        if self.journal is not None:
            self.journal(dict(entry))

    def record_codes(self, round_idx: int, reasons, clients=None,
                     ranks=None) -> None:
        """Fold a round's ``[K]`` reason-code vector into ledger entries;
        also feeds the metric families. Slot ``i`` maps to worker rank
        ``i + 1`` unless ``ranks`` gives the explicit slot->rank map
        (elastic partial rounds aggregate a rank subset)."""
        from fedml_tpu_torch.obs import comm_instrument as _obs

        for slot, code in enumerate(reasons):
            code = int(code)
            if code == REASON_OK:
                continue
            reason = REASONS[code]
            client = None if clients is None else clients[slot]
            rank = (slot + 1) if ranks is None else int(ranks[slot])
            self.record(round_idx, rank, reason, client=client)
            _obs.record_update_rejected(reason)
            _obs.record_suspected_rank(rank)

    def entries(self) -> list[dict]:
        with self._lock:
            return [dict(e) for e in self._entries]

    def restore(self, entries) -> None:
        """Re-install saved entries through :meth:`record` (the reason
        vocabulary stays validated); the metric families are not fed and
        the journal hook is suppressed (restored entries are already
        durable; re-journaling them would grow the WAL per boot)."""
        j, self.journal = self.journal, None
        try:
            for e in entries:
                self.record(int(e["round"]), int(e["rank"]), e["reason"],
                            client=e.get("client"))
        finally:
            self.journal = j

    def canonical(self) -> list[tuple]:
        with self._lock:
            return sorted((e["round"], e["rank"], e["reason"], e["client"])
                          for e in self._entries)

    def for_round(self, round_idx: int) -> list[dict]:
        with self._lock:
            return [dict(e) for e in self._entries
                    if e["round"] == round_idx]

    def counts(self) -> dict[str, int]:
        out: dict[str, int] = {}
        with self._lock:
            for e in self._entries:
                out[e["reason"]] = out.get(e["reason"], 0) + 1
        return out

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)
