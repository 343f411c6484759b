"""Top-k sparsified model uplinks with error feedback.

The reference ships the FULL model every client→server upload
(fedml_api/distributed/fedavg/FedAvgClientManager.py:66-70); it has no
update compression anywhere. At cross-silo bandwidth the upload is the
round bottleneck, and the classic fix (Deep Gradient Compression / top-k
with error feedback) applies cleanly to FedAvg:

  * the client uploads only the top-k |entries| of its model DELTA
    (local - global, plus the residual of everything never yet shipped);
  * the untransmitted mass stays in a client-side residual and rides in
    later rounds — error feedback, which is what preserves convergence;
  * the server adds each sparse delta onto the global it broadcast —
    since avg_k(global + d_k) == global + avg_k(d_k), the aggregation
    math is untouched and the dense aggregator is reused as-is.

``ratio=1.0`` transmits every entry — numerically equivalent to the dense
protocol (zero residual; the reconstruction ``g + (w - g)`` carries f32
roundoff, so the oracle in tests/test_comm.py compares at 2e-5, not
bitwise).

Residual OWNERSHIP moved to :mod:`fedml_tpu_torch.comm.ef` (PR 9): the client
manager threads one shared :class:`~fedml_tpu_torch.comm.ef.ErrorFeedback`
through every lossy tier (top-k here, the int8/1-bit delta tiers in
comm/delta.py); ``topk_residual`` remains the top-k shortcut for
``compensated - shipped`` and the conservation oracle. Residuals are
per-RANK (the parameter-server convention): under cross-device
reassignment a rank's residual mixes the clients it hosted — acceptable
in practice and zero extra protocol state; cross-silo (fixed assignment)
is the setting this targets (docs/PERFORMANCE.md §Wire efficiency).

Versioned bases (PR 9): the server densifies a sparse uplink against its
per-version broadcast stash keyed by the upload's round tag — which is
what lets top-k compose with buffered-async dispatch waves
(distributed/fedavg/server_manager._decode_upload).

Non-float leaves (e.g. integer counters in a model's extra state) ship
dense, marked by a sentinel index of [-1].
"""

from __future__ import annotations

import numpy as np

_DENSE_SENTINEL = -1


def topk_delta(local_leaves, global_leaves, residual_leaves=None):
    """The quantity top-k operates on: local - global (float leaves only;
    non-float leaves pass through as-is to ship dense), plus the error-
    feedback residual when given. Owning this here keeps the float-vs-
    dense-leaf convention in ONE module with its encode/decode inverses."""
    out = []
    for i, (w, g) in enumerate(zip(local_leaves, global_leaves)):
        w = np.asarray(w)
        if not np.issubdtype(w.dtype, np.floating):
            out.append(w)
            continue
        d = np.asarray(w, np.float32) - np.asarray(g, np.float32)
        if residual_leaves is not None:
            d = d + residual_leaves[i]
        out.append(d)
    return out


def topk_encode(delta_leaves, ratio: float):
    """Per-leaf top-k by |value|. Returns (idx_list, val_list) of flat
    int32 indices and their values; non-float leaves ship dense with the
    sentinel index."""
    if not (0.0 < ratio <= 1.0):
        raise ValueError(f"ratio must be in (0, 1], got {ratio}")
    idx_list, val_list = [], []
    for d in delta_leaves:
        d = np.asarray(d)
        if not np.issubdtype(d.dtype, np.floating):
            idx_list.append(np.array([_DENSE_SENTINEL], np.int32))
            val_list.append(d)
            continue
        flat = d.ravel()
        k = max(1, int(np.ceil(flat.size * ratio)))
        if k >= flat.size:
            sel = np.arange(flat.size, dtype=np.int32)
        else:
            sel = np.argpartition(np.abs(flat), flat.size - k)[-k:] \
                .astype(np.int32)
        idx_list.append(sel)
        val_list.append(flat[sel])
    return idx_list, val_list


def topk_residual(delta_leaves, idx_list):
    """What did NOT ship: the delta with transmitted entries zeroed —
    next round's error-feedback carryover."""
    out = []
    for d, sel in zip(delta_leaves, idx_list):
        d = np.asarray(d)
        if len(sel) == 1 and sel[0] == _DENSE_SENTINEL:  # shipped dense
            out.append(np.zeros_like(d))
            continue
        flat = np.array(d, np.float32).ravel()
        flat[sel] = 0.0
        out.append(flat.reshape(d.shape))
    return out


def topk_decode(global_leaves, idx_list, val_list):
    """Server side: global + sparse delta -> the client's effective model
    leaves (dense), ready for the unchanged weighted-average aggregator."""
    out = []
    for g, sel, vals in zip(global_leaves, idx_list, val_list):
        g = np.asarray(g)
        sel = np.asarray(sel)
        if len(sel) == 1 and sel[0] == _DENSE_SENTINEL:
            out.append(np.asarray(vals).reshape(g.shape))
            continue
        flat = np.array(g, np.float32).ravel()
        flat[sel] += np.asarray(vals, np.float32)
        out.append(flat.reshape(g.shape).astype(g.dtype))
    return out
