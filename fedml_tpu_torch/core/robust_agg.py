"""The sanitation gate and quarantine ledger, port of the gate subset of
fedml_tpu/core/robust_agg.py over stacked state dicts (every entry
``[K, ...]``, one row per uploading client) and ``[K]`` sample weights.

What the cross-process server runs when no robust estimator is armed
(``FedAvgAggregator._aggregate_core``): the gate rejects non-finite
updates unconditionally (the float wire ships the sender's bits verbatim,
so this is where a NaN upload dies) and norm outliers when ``norm_mult``
is finite, replaces a rejected client's update with the global model and
zeroes its weight; the weighted mean then runs over the survivors, and an
all-rejected round keeps the global model. Per-slot reason codes become
``QuarantineLedger`` entries, the artifact both packages must agree on.
The robust estimators (median, trimmed mean, krum, multi-krum, geometric
median), the two-phase verdict composition and ``pairwise_sum`` are queued
in ROADMAP.md (queue A, item 7).
"""

from __future__ import annotations

import threading

import torch

from fedml_tpu_torch.utils.tree import tree_weighted_mean

# per-slot quarantine reason codes (int32 in the gate; names in ledgers),
# the reference's vocabulary and order: 0..3 come from the gate and the
# estimators, the rest are recorded by the server runtimes directly
REASONS = ("ok", "nonfinite", "norm_outlier", "suspected", "undecodable",
           "edge_lost", "secagg_dropout", "secagg_shed", "server_restart")
REASON_OK, REASON_NONFINITE, REASON_NORM_OUTLIER, REASON_SUSPECTED = range(4)


def _weighted_median(x, w):
    """Weighted (lower) median of a [K] vector: the smallest value whose
    cumulative weight reaches half the total."""
    order = torch.argsort(x, stable=True)
    cum = torch.cumsum(w[order], 0)
    half = cum[-1:].clamp_min(1e-12) * 0.5
    return x[order][(cum >= half).int().argmax()]


def _slot_evidence(stacked: dict, global_state: dict):
    """Per-slot ``(finite, norm)``: the all-entries-finite flag and
    ``||u_k - g||`` with non-finite entries masked out of the sum (they are
    rejected by the flag already). Per-row reductions only, so a slot's
    values do not depend on how many slots share the stack."""
    k = next(iter(stacked.values())).shape[0]
    dev = next(iter(stacked.values())).device
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
    med = _weighted_median(norm, live.float())
    outlier = live & (norm > norm_mult * med.clamp_min(1e-12))
    replace = ~finite | outlier
    reasons = torch.where(~finite, REASON_NONFINITE,
                          torch.where(outlier, REASON_NORM_OUTLIER, REASON_OK))
    reasons = torch.where(w > 0, reasons, REASON_OK).to(torch.int32)
    return replace, torch.where(replace, torch.zeros_like(w), w), reasons


def sanitize_updates(stacked: dict, global_state: dict, weights,
                     norm_mult: float):
    """The sanitation gate: ``(clean_stacked, new_weights, reasons)``. A
    rejected slot's update is REPLACED by the global model and its weight
    zeroed (weights alone leave NaNs free to poison ``0 * nan`` products;
    values alone leave the reject in the weight mass). ``norm_mult=inf``
    disarms the norm rule and keeps the non-finite one."""
    finite, norm = _slot_evidence(stacked, global_state)
    replace, new_w, reasons = gate_verdicts(norm, finite, weights, norm_mult)
    clean = {}
    for key, s in stacked.items():
        keep = replace.reshape((-1,) + (1,) * (s.ndim - 1))
        clean[key] = torch.where(keep, global_state[key][None].to(s.dtype), s)
    return clean, new_w, reasons


def gated_aggregate(stacked: dict, global_state: dict, weights,
                    norm_mult: float | None = None):
    """gate (``norm_mult`` given; None = off) -> sample-weighted mean over
    the survivors -> the global model when every slot was rejected.
    Returns ``(avg_state, surviving_weights, reasons)``; ``reasons`` is
    None when the gate is off."""
    w = weights.float()
    reasons = None
    if norm_mult is not None:
        stacked, w, reasons = sanitize_updates(stacked, global_state, w,
                                               norm_mult)
    avg = tree_weighted_mean(stacked, w)
    if reasons is not None:
        alive = w.sum() > 0
        avg = {k: torch.where(alive, a, global_state[k])
               for k, a in avg.items()}
    return avg, w, reasons


class QuarantineLedger:
    """Thread-safe record of per-round gate verdicts; ``rank`` is the
    1-based worker rank. A copy of the reference's ledger, whose entries
    the port's server must reproduce for the same uploads."""

    def __init__(self):
        self._entries: list[dict] = []
        self._lock = threading.Lock()

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
