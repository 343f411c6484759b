"""Fused on-device server aggregation, port of fedml_tpu/core/fused_agg.py:
decode -> gate -> pairwise partials, one upload at a time.

The stacked server path densifies every encoded upload on the host
(``server_manager._decode_upload``: zlib and numpy per rank), stacks the
whole cohort per leaf and only then gates and folds the ``[K, ...]``
stack. The fused path instead:

- copies each upload to the device AS ITS RAW WIRE LEAVES (deflated int8
  is inflated on the host to int8, packed sign bytes and sparse idx/val go
  up verbatim) and densifies it there against the device-resident
  broadcast it encoded against (:func:`densify`), replaying the host
  decoders' float32 ops (comm/delta, comm/sparse) bit for bit;
- moves the dense wire leaves into the aggregator's state layout (the
  port's state dict on the server, by ``convert.from_flax`` on the device;
  wire positions at an edge) and runs the per-slot non-finite gate
  (:func:`gate_slot`);
- folds the arrival into the canonical pairwise partial sums: the
  :class:`PairwiseAccumulator` is a binary counter whose nodes are the
  aligned internal nodes of ``robust_agg.pairwise_sum``'s balanced tree,
  so the live partials are O(log K) on the in-order path;
- at flush merges the counter and divides once through the shared
  ``robust_agg.pairwise_finalize``.

Bitwise contract: the fused result is bitwise the stacked route under
``sum_assoc='pairwise'`` over the same arrived slots, reason codes
included. Torch's eager ops contract nothing, so the level-1 combine here,
``c0*w0 + c1*w1`` on two raw slots, is the very sequence of float32 ops
``pairwise_weighted_stats`` runs on each aligned pair of the stack, and
levels >= 2 are plain adds of materialized partials on both routes. (The
reference's jitted combine and its stacked fold can differ by XLA's fma
contraction; here the two compile nothing.)

Robust estimators and the armed norm gate run the STAGED mode: cohort
verdicts need the whole survivor set, so each slot's raw densified state
stays on the device until :func:`make_fused_robust_flush` stacks the slots
in sorted-slot order and runs the stacked route's ``gated_aggregate``
(``update_evidence`` -> ``verdict_flush`` with an estimator). One named
divergence from the reference: the reference computes each slot's
evidence row at arrival, since its per-row reductions are the stacked
cohort's rows bit for bit. Torch's reductions are not: a one-row
sum over the CNN's 1.6M-entry dense kernel splits across threads
differently from the same row inside a ten-row sum (on the CPU as on the
card), so the port computes the evidence over the stacked slots at flush,
and staged fused ≡ stacked holds by construction.

These are plain torch ops on the aggregator's device, as the reference's
are XLA-compiled jnp ops: no Pallas kernel is involved. Structural garbage
never reaches the device (``comm/delta.inflate_update`` raises
``CorruptPayload`` on the host); a NaN scale decodes non-finite on the
device and dies at the gate.
"""

from __future__ import annotations

import numpy as np
import torch

from fedml_tpu_torch.core.robust_agg import (
    REASON_NONFINITE,
    REASON_OK,
    gated_aggregate,
    pairwise_finalize,
)

FUSED_KINDS = ("dense", "delta", "delta-int8", "delta-sign1", "topk")


def _tree_add(a: dict, b: dict) -> dict:
    """A level >= 2 combine: the partials' entrywise sum."""
    return {k: a[k] + b[k] for k in a}


def _pair_combine(c0: dict, w0, c1: dict, w1):
    """Level-1 combine of two RAW slots: the per-pair expression of
    ``pairwise_weighted_stats``'s first fold level, ``c0*w0 + c1*w1``, with
    the weight total ``w0 + w1``."""
    return ({k: c0[k].float() * w0 + c1[k].float() * w1 for k in c0},
            w0 + w1)


class PairwiseAccumulator:
    """Streaming canonical pairwise fold: ``pairwise_sum``'s association,
    one slot at a time.

    A binary counter over push order: level 0 holds (at most) one RAW
    ``(clean_state, weight)`` slot, level ``l >= 1`` one complete ALIGNED
    partial of ``2**l`` consecutive slots. Pushing carry-propagates exactly
    the adjacent combines the stacked fold performs, so after K in-order
    pushes the live nodes ARE the canonical tree's internal nodes (O(log
    K) of them). :meth:`merge` pads the count to the next power of two
    with exact-zero raw slots, which is bitwise the stacked fold's
    zero-padding (its even pre-pad and per-level odd-tail pads)."""

    def __init__(self, zero_fn):
        self._zero_fn = zero_fn  # () -> an exact-zero RAW (state, w) slot
        self._levels: dict[int, tuple] = {}
        self._count = 0
        self.peak_nodes = 0  # live-node high-water mark (memory evidence)

    def __len__(self) -> int:
        return self._count

    @property
    def live_nodes(self) -> int:
        return len(self._levels)

    def push(self, raw) -> None:
        """Append one RAW ``(clean_state, weight)`` slot and carry."""
        if 0 not in self._levels:
            self._levels[0] = raw
        else:
            c0, w0 = self._levels.pop(0)
            c1, w1 = raw
            node, lvl = _pair_combine(c0, w0, c1, w1), 1
            while lvl in self._levels:
                (a, wa), (b, wb) = self._levels.pop(lvl), node
                node = (_tree_add(a, b), wa + wb)
                lvl += 1
            self._levels[lvl] = node
        self._count += 1
        self.peak_nodes = max(self.peak_nodes, len(self._levels))

    def merge(self):
        """Collapse to the single root ``(wsum_state, total)`` partial
        (None when nothing was pushed). The accumulator is spent after."""
        if self._count == 0:
            return None
        target = 1 << max(self._count - 1, 0).bit_length()
        if target == 1:
            target = 2  # the stacked fold pre-pads a lone slot to a pair
        while self._count < target:
            self.push(self._zero_fn())
        (node,) = self._levels.values()
        self._levels = {}
        return node


def term_nbytes(state: dict) -> int:
    """Bytes of ONE partial or slot (every entry f32 in the fold): the
    unit of the fed_agg_stack_bytes{mode=fused} accounting."""
    return int(sum(4 * v.numel() for v in state.values()))


def _dev(a, device, dtype=None) -> torch.Tensor:
    """One wire array on the device (a host copy first: wire arrays may be
    read-only views of a frame), cast to ``dtype`` when given."""
    t = torch.from_numpy(np.array(a)).to(device)
    return t if dtype is None else t.to(dtype)


def _unpack_sign_bits(packed: torch.Tensor, n: int) -> torch.Tensor:
    """Device twin of ``np.unpackbits``: MSB-first bits of each byte,
    truncated to ``n``."""
    shifts = torch.arange(7, -1, -1, dtype=torch.uint8, device=packed.device)
    return ((packed[:, None] >> shifts[None, :]) & 1).reshape(-1)[:n]


def densify(kind: str, payload, scales, base_leaves, meta, device) -> list:
    """One upload's raw wire payload -> the client's effective model as
    wire leaves on ``device``, replaying the host decode path's float32 ops
    bit for bit (``comm/delta`` decoders + ``apply_delta``,
    ``comm/sparse.topk_decode``). ``meta`` is the (shape, numpy dtype) of
    each wire leaf; ``base_leaves`` the device-resident broadcast the
    upload encoded against (unused for ``dense``). Non-float leaves ship
    dense and replace."""
    if kind not in FUSED_KINDS:
        raise ValueError(f"unknown fused payload kind {kind!r} "
                         f"(one of {FUSED_KINDS})")
    if kind == "dense":
        return [_dev(p, device).reshape(shape) for p, (shape, _) in
                zip(payload, meta)]
    out = []
    if kind == "topk":
        idx_list, val_list = payload
        for g, sel, vals, (shape, dtype) in zip(base_leaves, idx_list,
                                                val_list, meta):
            if not np.issubdtype(dtype, np.floating):
                out.append(_dev(vals, device).reshape(shape))
                continue
            sel = _dev(sel, device).long()
            flat = g.float().reshape(-1).clone()
            flat[sel] = flat[sel] + _dev(vals, device, torch.float32)
            out.append(flat.reshape(shape).to(g.dtype))
        return out
    for i, (p, g, (shape, dtype)) in enumerate(zip(payload, base_leaves,
                                                   meta)):
        if not np.issubdtype(dtype, np.floating):
            out.append(_dev(p, device).reshape(shape))
            continue
        s = torch.tensor(float(np.float32(scales[i])), dtype=torch.float32,
                         device=device)
        if kind == "delta":
            d = _dev(p, device, torch.float32).reshape(shape)
        elif kind == "delta-int8":
            d = (_dev(p, device).float() * s).reshape(shape)
        else:  # delta-sign1
            n = int(np.prod(shape, dtype=np.int64)) if shape else 1
            bits = _unpack_sign_bits(_dev(p, device), n)
            d = torch.where(bits.bool(), s, -s).reshape(shape)
        out.append((g.float() + d).to(g.dtype))
    return out


def gate_slot(state: dict, global_state: dict, w):
    """The per-slot half of ``sanitize_updates`` with the norm rule off:
    a non-finite upload is replaced by the global model (a zero weight
    alone would still poison ``0 * nan``) and its weight zeroed; the
    reason is ``nonfinite`` only for a participating (w > 0) slot.
    Returns ``(clean_state, surviving_weight, reason)``."""
    first = next(iter(state.values()))
    finite = torch.ones((), dtype=torch.bool, device=first.device)
    for v in state.values():
        finite &= torch.isfinite(v).all()
    clean = {k: torch.where(finite, v, global_state[k].to(v.dtype))
             for k, v in state.items()}
    w = torch.as_tensor(w, dtype=torch.float32, device=first.device)
    w_out = torch.where(finite, w, torch.zeros_like(w))
    reason = torch.where(w > 0, torch.where(finite, REASON_OK,
                                            REASON_NONFINITE),
                         REASON_OK).to(torch.int32)
    return clean, w_out, reason


def make_fused_densify(kind: str, meta, to_state, device):
    """The arrival-side decode of the ASYNC fused path: densify only, plus
    the door's finiteness verdict (the gate waits for the drain, whose
    flush-time global is the replacement). Returns ``fn(payload, scales,
    base_leaves) -> (raw_state, finite)``; ``to_state`` maps the dense
    wire leaves to the aggregator's state layout."""
    if kind not in FUSED_KINDS:
        raise ValueError(f"unknown fused payload kind {kind!r} "
                         f"(one of {FUSED_KINDS})")

    def fn(payload, scales, base_leaves):
        state = to_state(densify(kind, payload, scales, base_leaves, meta,
                                 device))
        finite = torch.ones((), dtype=torch.bool, device=device)
        for v in state.values():
            finite &= torch.isfinite(v).all()
        return state, finite

    return fn


def make_fused_ingest(kind: str, meta, to_state, device):
    """The per-arrival composition of the plain fused mode: decode ->
    densify -> layout -> non-finite gate. Returns ``fn(payload, scales,
    base, global_state, w) -> (clean_state, surviving_weight, reason)``,
    slot for slot and bit for bit the per-slot half of the stacked
    route's gate."""
    densify_fn = make_fused_densify(kind, meta, to_state, device)

    def ingest(payload, scales, base_leaves, global_state, w):
        state, _ = densify_fn(payload, scales, base_leaves)
        return gate_slot(state, global_state, w)

    return ingest


def make_fused_robust_ingest(kind: str, meta, to_state, device):
    """The per-arrival composition of the STAGED fused mode: decode ->
    densify -> layout; the slot's RAW state stays on the device for the
    flush (see the module docstring for why its evidence row waits).
    Returns ``fn(payload, scales, base, global_state, w) -> raw_state``."""
    densify_fn = make_fused_densify(kind, meta, to_state, device)

    def ingest(payload, scales, base_leaves, global_state, w):
        return densify_fn(payload, scales, base_leaves)[0]

    return ingest


def make_fused_robust_flush(verdict_fn=None, norm_mult: float | None = None,
                            **gagg_kw):
    """The flush of the STAGED fused mode: stack the staged slots (sorted-
    slot order, the stacked route's compacted layout) and their weights,
    then the stacked route's own composition, ``gated_aggregate`` with
    ``verdict_fn`` (``update_evidence`` -> ``verdict_flush``) or, with the
    armed norm gate alone, the gate and the canonical pairwise fold.
    Returns ``fn(slot_states, weights, global_state) -> (avg_state,
    surviving_weights, reasons)``."""

    def flush(slot_states, weights, global_state):
        stacked = {k: torch.stack([s[k] for s in slot_states])
                   for k in slot_states[0]}
        w = torch.tensor([float(x) for x in weights], dtype=torch.float32,
                         device=_device_of(stacked))
        return gated_aggregate(stacked, global_state, w,
                               verdict_fn=verdict_fn, norm_mult=norm_mult,
                               pairwise=verdict_fn is None, **gagg_kw)

    return flush


def _device_of(state: dict) -> torch.device:
    """The device of a state's (or stack's) tensors."""
    return next(iter(state.values())).device


class FusedRoundIngest:
    """One round's device-resident fused ingest state.

    PLAIN mode (``staged=False``): slots are worker indices; gated
    arrivals push into the accumulator strictly in SLOT order (a cursor:
    out-of-order arrivals pend on the device until every lower slot
    arrived or the flush skips the holes), so the fold is the canonical
    pairwise association over the COMPACTED sorted arrival set, the layout
    the stacked route stacks, whatever order the wire delivered.

    STAGED mode (``staged=True``, robust estimators or the armed norm
    gate): each slot's RAW state and weight stay on the device until
    :meth:`flush_robust`. Peak memory is O(K) staged slots, the stacked
    route's stack bytes, reported as ``fed_agg_stack_bytes{mode=
    fused_staged}``; there is still no host densify."""

    def __init__(self, global_state: dict, *, staged: bool = False):
        self._global = global_state
        zero = ({k: torch.zeros_like(v, dtype=torch.float32)
                 for k, v in global_state.items()},
                torch.zeros((), dtype=torch.float32,
                            device=_device_of(global_state)))
        self._acc = PairwiseAccumulator(lambda: zero)
        self._pending: dict[int, tuple] = {}
        self._staged: dict[int, tuple] = {}  # staged: slot -> (raw, w)
        self.staged_mode = bool(staged)
        self._reasons: dict[int, torch.Tensor] = {}
        self._cursor = 0
        self.slots: set[int] = set()
        self.peak_terms = 0

    def add(self, slot: int, ingest_fn, payload, scales, base_leaves,
            weight: float) -> None:
        """Run the per-arrival composition for one upload and fold (plain)
        or stage (staged) the result; ``ingest_fn`` is
        :func:`make_fused_ingest`'s product in plain mode,
        :func:`make_fused_robust_ingest`'s in staged mode. A duplicate
        slot folds once."""
        if slot in self.slots:
            return
        out = ingest_fn(payload, scales, base_leaves, self._global,
                        float(weight))
        self.add_staged(slot, (out, float(weight)) if self.staged_mode
                        else out)

    def add_state(self, slot: int, state: dict, weight: float) -> None:
        """Fold or stage one already-dense state (the async drain: the
        arrival densified it; the gate runs here, against the flush-time
        global, exactly when the stacked route gates its entries)."""
        if slot in self.slots:
            return
        if self.staged_mode:
            self.add_staged(slot, (state, float(weight)))
        else:
            self.add_staged(slot, gate_slot(state, self._global,
                                            float(weight)))

    def add_staged(self, slot: int, entry) -> None:
        """Fold or stage one pre-ingested entry: ``(clean_state, w_out,
        reason)`` in plain mode, ``(raw_state, weight)`` in staged mode."""
        if slot in self.slots:
            return
        self.slots.add(slot)
        if self.staged_mode:
            self._staged[slot] = entry
            self.peak_terms = max(self.peak_terms, len(self._staged))
            return
        clean, w_out, reason = entry
        self._reasons[slot] = reason
        self._pending[slot] = (clean, w_out)
        while self._cursor in self._pending:
            self._acc.push(self._pending.pop(self._cursor))
            self._cursor += 1
        self.peak_terms = max(self.peak_terms,
                              self._acc.live_nodes + len(self._pending))

    def flush(self):
        """Merge -> finalize: ``(new_global_state, reasons)`` with
        ``reasons`` the ``[K']`` int32 codes over the sorted arrived slots
        (the stacked route's compacted layout); ``(None, None)`` when
        nothing arrived. An all-rejected round keeps the global model via
        the shared ``pairwise_finalize``."""
        for slot in sorted(self._pending):  # straggler holes: skip, as
            self._acc.push(self._pending.pop(slot))  # the stacked compact
        node = self._acc.merge()
        if node is None:
            return None, None
        wsum, total = node
        reasons = torch.stack([self._reasons[s] for s in sorted(self.slots)])
        return pairwise_finalize(wsum, total, self._global), reasons

    def flush_robust(self, flush_fn):
        """STAGED-mode flush through :func:`make_fused_robust_flush`'s
        product over the sorted staged slots. Returns
        ``(new_global_state, verdict_weights, reasons)``; all None when
        nothing was staged."""
        order = sorted(self._staged)
        if not order:
            return None, None, None
        return flush_fn([self._staged[s][0] for s in order],
                        [self._staged[s][1] for s in order], self._global)

    # ----------------------------------------------------- edge tier
    def flush_block_partial(self, block_size: int):
        """Edge-tier flush (plain mode): the block's partial WITHOUT the
        final divide, a missing child filled with the global model at zero
        weight AT ITS POSITION (the edge's ``_stack_block`` fill), so the
        block partial is the canonical tree's internal node. Returns
        ``(wsum_state, total, reasons)``; ``reasons`` covers every block
        position (holes report OK, as the stacked gate does for
        zero-weight slots)."""
        hole = (self._global, torch.zeros((), dtype=torch.float32,
                                          device=_device_of(self._global)))
        for local in range(self._cursor, block_size):
            self._acc.push(self._pending.pop(local, hole))
        wsum, total = self._acc.merge()
        ok = torch.zeros((), dtype=torch.int32, device=total.device)
        reasons = torch.stack([self._reasons.get(s, ok)
                               for s in range(block_size)])
        return wsum, total, reasons

    def block_stacked(self, block_size: int):
        """Edge-tier stack (STAGED mode): the block's RAW ``[block_size,
        ...]`` state with the ``_stack_block`` hole fill (the global model
        at weight 0) and the weights, for the edge's evidence and
        verdict folds."""
        dev = _device_of(self._global)
        stacked = {k: torch.stack([self._staged[s][0][k]
                                   if s in self._staged else g
                                   for s in range(block_size)])
                   for k, g in self._global.items()}
        weights = torch.tensor([self._staged[s][1] if s in self._staged
                                else 0.0 for s in range(block_size)],
                               dtype=torch.float32, device=dev)
        return stacked, weights
