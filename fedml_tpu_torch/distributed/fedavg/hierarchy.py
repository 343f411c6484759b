"""Hierarchical 2-tier cross-process FedAvg, port of
fedml_tpu/distributed/fedavg/hierarchy.py: a layer of EDGE AGGREGATOR ranks
between the workers and the root, so the root takes O(edges) update frames
a round instead of O(clients).

Rank layout (world size ``1 + E + W``)::

    rank 0            root server   (HierFedAvgServerManager)
    ranks 1..E        edge aggregators (FedAvgEdgeManager)
    ranks E+1..E+W    workers       (FedAvgClientManager,
                                     server_rank = their edge)

Each edge owns a contiguous block of ``C = W/E`` cohort slots. A round: the
root sends ONE frame per edge (the model and that block's client
assignments); the edge fans it out to its workers, collects their uploads,
gates the non-finite ones (``robust_agg.nonfinite_gate``, per slot, so its
verdicts are a flat server's) and forwards ONE frame: the canonical
pairwise weighted SUM of the survivors and its weight total, in wire order
(the flax layout) and float32. The root pairwise-folds the E partials and
divides once.

**Exactness.** ``C`` must be a power of two: the blocks are then aligned
sub-trees of the canonical pairwise fold (``robust_agg.pairwise_sum``), so
the tree's aggregate is bitwise the flat pairwise aggregate over the same
cohort (``sum_assoc='pairwise'``), model and quarantine ledger alike. The
fold works entry by entry, so the edges' wire layout and the root's state
layout give the same bits.

**Two-phase cross-tier robust gating.** With ``aggregator=`` or
``sanitize=`` armed, an edge first forwards per-slot EVIDENCE (norms,
non-finite flags, a fixed-size sketch of each update:
``robust_agg.update_evidence``) and holds the staged uploads; the root runs
the cohort-wide gate and estimator selection over the gathered evidence
(``evidence_verdicts``, the math a flat two-phase server runs) and answers
each edge with a per-slot VERDICT frame; the edge folds only the survivors
(``apply_verdicts``) and forwards an ordinary partial. Only O(cohort)
scalars of evidence reach the root (``comm_bytes_total{direction=
evidence|verdict}``). An edge lost inside ``round_timeout_s`` leaves its
block out as zero terms, every slot of it ledgered ``edge_lost``.

Each edge stacks and folds on its own device (``device=``, the port's
device rule), under ``float32_compute``, and converts every partial to
numpy before it reaches a frame, so its frames are the JAX package's:
ranks of the two packages mix in one tree.

Root crash recovery is the flat server's (server_manager.py): with
``ckpt_dir`` the root checkpoints and journals its rounds, a chaos crash
rule naming rank 0 kills it at its crash points (an edge partial counts as
the tier's upload), and ``run_simulated_hierarchical`` boots a fresh root
through checkpoint + WAL while the edges and workers run on; the recovered
root probes every rank, and an edge answers with its last-seen round.

The fleet plane (obs/fleet.py): an edge relays the root's ``__telemetry``
marker to its workers (it rebuilds their frames), keeps the latest digest
of each child, and forwards ONE folded blob on its partial (its own digest,
the block's under ``block``), so the root's ingress stays O(edges).

The hierarchical masked tier (secure aggregation with edge-local reveal
recovery) builds on these classes in distributed/turboaggregate.py. With
``fused=True`` an edge ingests its children on the device as they arrive
(core/fused_agg.py): gated and folded into the block's pairwise partial,
or staged for the two-phase evidence; its frames are bitwise the stacked
edge's.
"""

from __future__ import annotations

import dataclasses
import functools
import logging
import threading
import time

import numpy as np
import torch

from fedml_tpu_torch.algorithms.fedavg import float32_compute
from fedml_tpu_torch.comm.managers import DistributedManager
from fedml_tpu_torch.comm.message import Message
from fedml_tpu_torch.core.robust_agg import (
    DEFAULT_NORM_MULT,
    EVIDENCE_SKETCH_DIM,
    apply_verdicts,
    combine_edge_partials,
    edge_partial,
    evidence_verdicts,
    make_verdict_estimator,
    update_evidence,
)
from fedml_tpu_torch.device import resolve_device
from fedml_tpu_torch.distributed.fedavg.aggregator import (
    FedAvgAggregator,
    refuse_unported,
)
from fedml_tpu_torch.distributed.fedavg.message_define import MyMessage
from fedml_tpu_torch.distributed.fedavg.server_manager import FedAvgServerManager
from fedml_tpu_torch.obs import comm_instrument as _obs
from fedml_tpu_torch.obs import perf_instrument as _perf
from fedml_tpu_torch.obs.tracing import TRACE_KEY

log = logging.getLogger("fedml_tpu_torch.distributed.hierarchy")

# the cross-tier control plane's bytes apart from the update traffic they
# bound: comm_bytes_total{direction=evidence} stays within the per-client
# scalar budget (the sketch row + norm/finite/weight), {direction=verdict}
# within a weight and a reason code a slot
_obs.register_direction_override(
    MyMessage.MSG_TYPE_E2S_SEND_EVIDENCE_TO_SERVER, "evidence")
_obs.register_direction_override(
    MyMessage.MSG_TYPE_S2E_SEND_VERDICT_TO_EDGE, "verdict")


@dataclasses.dataclass(frozen=True)
class EdgeTopology:
    """The 2-tier rank map. ``workers % edges == 0`` and the block size
    ``workers // edges`` must be a power of two, the alignment that keeps
    tree == flat bitwise (see the module docstring)."""

    edges: int
    workers: int

    def __post_init__(self):
        if self.edges < 1 or self.workers < 1:
            raise ValueError(f"edges={self.edges} workers={self.workers} "
                             "must both be >= 1")
        if self.workers % self.edges:
            raise ValueError(
                f"workers={self.workers} not divisible by "
                f"edges={self.edges} — edge blocks must be equal")
        c = self.block
        if c & (c - 1):
            raise ValueError(
                f"edge block size {c} (= {self.workers}/{self.edges}) "
                "must be a power of two: blocks are then aligned "
                "sub-trees of the canonical pairwise fold, which is what "
                "keeps tree == flat bitwise")

    @property
    def block(self) -> int:
        return self.workers // self.edges

    @property
    def world_size(self) -> int:
        return 1 + self.edges + self.workers

    def edge_rank(self, edge_idx: int) -> int:
        return 1 + int(edge_idx)

    def worker_rank(self, slot: int) -> int:
        """Cohort slot (0-based) -> transport rank."""
        return 1 + self.edges + int(slot)

    def slot_of(self, worker_rank: int) -> int:
        return int(worker_rank) - 1 - self.edges

    def edge_of_slot(self, slot: int) -> int:
        return int(slot) // self.block

    def slots_of_edge(self, edge_idx: int) -> range:
        return range(int(edge_idx) * self.block,
                     (int(edge_idx) + 1) * self.block)


class HierFedAvgAggregator(FedAvgAggregator):
    """The root's aggregator over EDGE partials: its slots are edges, not
    workers; ``aggregate()`` pairwise-folds the staged (wsum, weight) pairs
    and divides once. The verdicts arrive attributed by cohort slot, so the
    ledger is a flat run's entry for entry.

    ``aggregator=`` / ``sanitize=`` arm the two-phase protocol (module
    docstring) with the flat aggregator's semantics (``sanitize=None``:
    armed iff an estimator is); this class then owns the verdict step,
    ``verdicts(evidence)`` over the cohort evidence the server manager
    gathers."""

    def __init__(self, dataset, task, cfg, topology: EdgeTopology,
                 aggregator: str | None = None,
                 aggregator_params: dict | None = None,
                 sanitize: bool | float | None = None, device=None):
        if cfg.client_num_per_round != topology.workers:
            raise ValueError(
                f"client_num_per_round={cfg.client_num_per_round} != "
                f"topology workers={topology.workers}")
        super().__init__(dataset, task, cfg, worker_num=topology.edges,
                         device=device)
        self.topology = topology
        # edge slot -> (fold total, reasons, slots, clients); model_dict
        # keeps the staged partials so the inherited barrier applies
        self._edge_meta: dict[int, tuple] = {}
        self.fanin_history: list[int] = []
        if sanitize is None:
            sanitize = aggregator is not None
        self.robust_mode = bool(aggregator is not None or sanitize)
        # the mean / sanitize-only verdicts read no distances: edges then
        # ship no sketch (norm, finite flag and weight only)
        self.sketch_dim = EVIDENCE_SKETCH_DIM if aggregator is not None else 0
        self.verdicts = None
        self.last_round_rejected: list[int] | None = None
        if self.robust_mode:
            mult = (float("inf") if sanitize is False
                    else DEFAULT_NORM_MULT if sanitize is True
                    else float(sanitize))
            est = make_verdict_estimator(
                aggregator or "mean", n=topology.workers,
                **(aggregator_params or {}))
            self.verdicts = functools.partial(
                evidence_verdicts, verdict_fn=est, norm_mult=mult)

    def add_edge_result(self, edge_idx: int, wsum_leaves, wtotal: float,
                        reasons, slots, clients,
                        round_idx: int | None = None,
                        samples: float | None = None) -> None:
        """Slot one edge's partial (the e2s_agg frame), with the stale and
        unknown-index rejections of a worker upload. ``wtotal`` is the fold
        total (the division's denominator: verdict-weight mass under the
        two-phase protocol); ``samples`` the raw client-reported mass for
        telemetry (``wtotal`` when absent)."""
        if not self._admit_upload(edge_idx, round_idx):
            return
        self.model_dict[edge_idx] = self._stage_upload(wsum_leaves)
        self.sample_num_dict[edge_idx] = float(
            wtotal if samples is None else samples)
        self._edge_meta[edge_idx] = (
            float(wtotal), np.asarray(reasons, np.int32),
            [int(s) for s in slots], [int(c) for c in clients])
        self.flag_client_model_uploaded[edge_idx] = True

    def _aggregate_core(self):
        t0 = time.perf_counter()
        edges = sorted(self.model_dict)
        if not edges:
            log.warning("round %d: no edge partials — keeping the "
                        "current global model", self.current_round)
            return
        # edge-failure elasticity: a block whose partial never arrived
        # (the round already went on without it) is ledgered slot by slot
        # as edge_lost with the clients it would have trained
        missing = [e for e in range(self.topology.edges)
                   if e not in self.model_dict]
        if missing:
            ids = self.client_sampling(self.current_round)
            for e in missing:
                for s in self.topology.slots_of_edge(e):
                    self.quarantine.record(self.current_round, s + 1,
                                           "edge_lost", client=int(ids[s]))
                    _obs.record_update_rejected("edge_lost")
            log.warning("round %d: edge partial(s) %s lost — their blocks "
                        "fold as zero terms (ledgered edge_lost)",
                        self.current_round, missing)
        # per-edge rejection counts for the hier block: a reporting edge's
        # verdict rejects, a lost edge's whole block
        self.last_round_rejected = [
            int(np.count_nonzero(self._edge_meta[e][1]))
            if e in self._edge_meta else self.topology.block
            for e in range(self.topology.edges)]
        stacked = {k: torch.stack([self.model_dict[e][k] for e in edges])
                   for k in self.net}
        # the division's denominator is the FOLD total each edge shipped;
        # sample_num_dict holds the raw telemetry mass and never steers it
        totals = torch.tensor([self._edge_meta[e][0] for e in edges],
                              dtype=torch.float32, device=self.device)
        with float32_compute():
            avg, total_w = combine_edge_partials(stacked, totals, self.net)
        self.fanin_history.append(len(edges))
        _perf.record_agg_bytes("replicated", self._model_nbytes * len(edges))
        # the verdicts go into the ledger under the COHORT-SLOT rank
        # (slot + 1), a flat server's attribution
        for e in edges:
            _, reasons, slots, clients = self._edge_meta[e]
            if reasons.any():
                self.quarantine.record_codes(
                    self.current_round, reasons,
                    clients=clients, ranks=[s + 1 for s in slots])
        if float(total_w) == 0.0 and any(
                self._edge_meta[e][1].any() for e in edges):
            log.warning("round %d: every child quarantined — keeping the "
                        "current global model", self.current_round)
        self.net = avg
        self.model_dict.clear()
        self.sample_num_dict.clear()
        self._edge_meta.clear()
        log.info("hier aggregate (%d edge partials): %.3fs",
                 len(edges), time.perf_counter() - t0)


def _positions(leaves) -> dict:
    """Dense wire leaves keyed by position: the edge's stack layout."""
    return dict(enumerate(leaves))


class FedAvgEdgeManager(DistributedManager):
    """One edge aggregator rank: relay downlinks to its worker block, fold
    their gated uploads, forward one partial to the root.

    Stateless across rounds but for the held broadcast (the gate's
    replacement value): a restarted edge rejoins at the next broadcast.
    With ``round_timeout_s`` armed, a stalled block forwards a PARTIAL over
    the children that did report (the missing ones carry zero weight and
    the global value: zero terms of the canonical fold)."""

    def __init__(self, rank: int, topology: EdgeTopology,
                 backend: str = "LOOPBACK",
                 round_timeout_s: float | None = None,
                 robust: bool = False,
                 sketch_dim: int = EVIDENCE_SKETCH_DIM,
                 fused: bool = False, device=None, **kw):
        self.topology = topology
        self.edge_idx = rank - 1
        if not 0 <= self.edge_idx < topology.edges:
            raise ValueError(f"rank {rank} is not an edge rank "
                             f"(edges are 1..{topology.edges})")
        self.device = resolve_device(device)
        self._slots = list(topology.slots_of_edge(self.edge_idx))
        self._round: int | None = None
        self._global = None          # held broadcast leaves (gate value)
        self._clients: list[int] = []  # this block's client assignment
        self._uploads: dict[int, tuple] = {}  # local idx -> (leaves, n)
        self._forwarded = False
        self._lock = threading.Lock()
        self._sketch_dim = int(sketch_dim)
        # two-phase gating: forward EVIDENCE first, hold the staged
        # uploads, fold only the survivors the root's verdict names
        self.robust = bool(robust)
        self._evidence_sent = False
        self._staged: tuple | None = None  # (stacked, global) for phase 3
        self._last_partial: tuple | None = None  # retransmit cache
        # fleet plane: the root's downlink marker arms the lazy digest
        # emitter; the children's uplink digests fold into ONE blob on
        # this edge's partial
        self._fleet_marker: dict | None = None
        self._digest = None
        self._child_digests: dict[int, dict] = {}
        # fused on-device ingest at the edge (core/fused_agg.py): each
        # child's upload is copied to the device, gated and folded (or, in
        # the two-phase mode, staged) as it arrives; the block frames are
        # bitwise the stacked edge's, so the root is none the wiser
        self.fused = bool(fused)
        self._fused_round = None  # rebuilt per downlink (new global)
        self._fused_ingest = None
        ts = kw.pop("timeout_s", None)
        self.round_timeout_s = round_timeout_s
        super().__init__(rank, topology.world_size, backend,
                         timeout_s=round_timeout_s or ts, **kw)

    def send_message(self, msg) -> None:
        """Elastic sends: with ``round_timeout_s`` armed an unreachable
        CHILD just misses this round's fan-out (the elastic partial covers
        it) and an unreachable ROOT loses this uplink (the root's watchdog
        owns recovery). Without a deadline a failed delivery stays fatal,
        as on the flat server."""
        try:
            super().send_message(msg)
        except Exception as e:
            if self.round_timeout_s is None or \
                    not FedAvgServerManager._is_transport_error(e):
                raise
            log.warning("edge %d: dropping undeliverable send to rank %s",
                        self.edge_idx, msg.get_receiver_id(), exc_info=True)

    # ------------------------------------------------------------ handlers
    def register_message_receive_handlers(self):
        for msg_type in (MyMessage.MSG_TYPE_S2C_INIT_CONFIG,
                         MyMessage.MSG_TYPE_S2C_SYNC_MODEL_TO_CLIENT):
            self.register_message_receive_handler(
                msg_type, functools.partial(self._handle_downlink, msg_type))
        self.register_message_receive_handler(
            MyMessage.MSG_TYPE_C2S_SEND_MODEL_TO_SERVER,
            self._handle_child_upload)
        self.register_message_receive_handler(
            MyMessage.MSG_TYPE_S2E_SEND_VERDICT_TO_EDGE,
            self._handle_verdict)
        self.register_message_receive_handler(
            MyMessage.MSG_TYPE_S2C_RESUME_PROBE, self._handle_resume_probe)
        self.register_message_receive_handler(
            MyMessage.MSG_TYPE_S2C_FINISH, lambda _m: self.finish())

    def _handle_downlink(self, msg_type: str, msg_params) -> None:
        """Root -> edge: hold the model, fan the same frame type out to
        this block's workers, each with its own client assignment."""
        with self._lock:
            self._round = int(msg_params[MyMessage.MSG_ARG_KEY_ROUND])
            self._global = list(
                msg_params[MyMessage.MSG_ARG_KEY_MODEL_PARAMS])
            self._clients = [
                int(c) for c in
                msg_params[MyMessage.MSG_ARG_KEY_CHILD_CLIENTS]]
            self._uploads = {}
            self._forwarded = False
            self._evidence_sent = False
            self._staged = None
            self._last_partial = None
            if self.fused:
                self._start_fused_round()
            # fleet marker: the edge REBUILDS worker frames, so the
            # marker must be relayed explicitly (like every other
            # side-band key) or the workers never start digesting
            tmark = msg_params.get(MyMessage.MSG_ARG_KEY_TELEMETRY)
            self._fleet_marker = tmark if isinstance(tmark, dict) else None
            self._child_digests = {}
            if self._fleet_marker is not None:
                if self._digest is None:
                    from fedml_tpu_torch.obs.fleet import DigestEmitter

                    self._digest = DigestEmitter(self.rank)
                self._digest.on_downlink(self._fleet_marker)
        for i, slot in enumerate(self._slots):
            msg = Message(msg_type, self.rank,
                          self.topology.worker_rank(slot))
            msg.add_params(MyMessage.MSG_ARG_KEY_MODEL_PARAMS, self._global)
            msg.add_params(MyMessage.MSG_ARG_KEY_CLIENT_INDEX,
                           self._clients[i])
            msg.add_params(MyMessage.MSG_ARG_KEY_ROUND, self._round)
            if self._fleet_marker is not None:
                msg.add_params(MyMessage.MSG_ARG_KEY_TELEMETRY,
                               self._fleet_marker)
            self.send_message(msg)

    def _handle_child_upload(self, msg_params) -> None:
        sender = int(msg_params[Message.MSG_ARG_KEY_SENDER])
        slot = self.topology.slot_of(sender)
        with self._lock:
            if self._round is None:
                return
            # fleet digest: collected on ARRIVAL, before any round/dedup
            # gate — even a stale or late upload proves the rank is alive,
            # and the fold keeps only the latest blob per child
            dig = msg_params.get(MyMessage.MSG_ARG_KEY_TELEMETRY)
            if isinstance(dig, dict):
                self._child_digests[sender] = dig
            tag = msg_params.get(MyMessage.MSG_ARG_KEY_ROUND, self._round)
            if int(tag) != self._round:
                _obs.record_stale_upload("stale")
                log.warning("edge %d: drop stale upload from rank %d "
                            "(round %s, now %d)", self.edge_idx, sender,
                            tag, self._round)
                return
            local = slot - self._slots[0]
            if not 0 <= local < len(self._slots):
                _obs.record_stale_upload("unknown_rank")
                log.warning("edge %d: upload from rank %d outside this "
                            "block (slots %s)", self.edge_idx, sender,
                            self._slots)
                return
            if local in self._uploads or self._forwarded:
                return  # chaos-duplicated upload: exactly-once folding
            if self._evidence_sent:
                # the evidence cut already happened: the root's verdicts
                # scored this slot absent (weight 0), so folding it now
                # would desync the partial from the verdict frame
                _obs.record_stale_upload("stale")
                log.warning("edge %d: drop upload from rank %d — arrived "
                            "after the round %s evidence cut", self.edge_idx,
                            sender, self._round)
                return
            if (MyMessage.MSG_ARG_KEY_SPARSE_IDX in msg_params
                    or MyMessage.MSG_ARG_KEY_UPDATE_CODEC in msg_params):
                raise RuntimeError(
                    "encoded uplinks (top-k / delta / quantized) are not "
                    "wired through edge aggregators — run the flat "
                    "topology or the dense protocol")
            leaves = list(msg_params[MyMessage.MSG_ARG_KEY_MODEL_PARAMS])
            nsamp = float(msg_params[MyMessage.MSG_ARG_KEY_NUM_SAMPLES])
            if self.fused:
                self._fused_round.add(local, self._fused_ingest, leaves,
                                      None, None, nsamp)
                leaves = None  # folded or staged on the device
            self._uploads[local] = (leaves, nsamp)
            if len(self._uploads) == len(self._slots):
                if self.robust:
                    self._forward_evidence()
                else:
                    self._forward_partial()

    def _put(self, a) -> torch.Tensor:
        return torch.from_numpy(np.array(a)).to(self.device)

    def _start_fused_round(self) -> None:
        """A fresh fused ingest against the held broadcast, keyed by wire
        position as the stacked edge keys its stack. Caller holds
        _lock."""
        from fedml_tpu_torch.core import fused_agg as _fused

        glob = {i: self._put(g) for i, g in enumerate(self._global)}
        if self._fused_ingest is None:
            meta = [(tuple(np.shape(g)), np.asarray(g).dtype)
                    for g in self._global]
            build = (_fused.make_fused_robust_ingest if self.robust
                     else _fused.make_fused_ingest)
            self._fused_ingest = build("dense", meta, _positions,
                                       self.device)
        self._fused_round = _fused.FusedRoundIngest(glob,
                                                    staged=self.robust)

    def _stack_block(self):
        """(stacked, global, weights) over this block's slots on the edge's
        device, wire leaves keyed by position: a missing child (elastic
        timeout) carries zero weight and the global value, exact zero
        terms in any later fold. Caller holds _lock."""
        glob = {i: self._put(g) for i, g in enumerate(self._global)}
        stacked = {
            i: torch.stack([self._put(self._uploads[local][0][i])
                            if local in self._uploads else g
                            for local in range(len(self._slots))])
            for i, g in glob.items()}
        weights = torch.tensor(
            [self._uploads[local][1] if local in self._uploads else 0.0
             for local in range(len(self._slots))],
            dtype=torch.float32, device=self.device)
        return stacked, glob, weights

    def _send_partial_frame(self, wsum, total, reasons) -> None:
        """One e2s_agg frame to the root, the same whether the verdicts
        came from the local non-finite gate or the root's verdict frame.
        The payload (host arrays) is cached, so that a verdict retry
        retransmits it bit for bit. Caller holds _lock."""
        self._last_partial = (wsum, total, reasons)
        msg = Message(MyMessage.MSG_TYPE_E2S_SEND_AGG_TO_SERVER,
                      self.rank, 0)
        msg.add_params(MyMessage.MSG_ARG_KEY_EDGE_WSUM, wsum)
        msg.add_params(MyMessage.MSG_ARG_KEY_EDGE_WEIGHT, total)
        # telemetry: the raw sample mass that ARRIVED (before the gate and
        # the verdicts), so the root's round record reads a flat run's
        msg.add_params(MyMessage.MSG_ARG_KEY_EDGE_SAMPLES,
                       float(sum(u[1] for u in self._uploads.values())))
        msg.add_params(MyMessage.MSG_ARG_KEY_EDGE_REASONS, reasons)
        msg.add_params(MyMessage.MSG_ARG_KEY_EDGE_SLOTS,
                       [int(s) for s in self._slots])
        msg.add_params(MyMessage.MSG_ARG_KEY_EDGE_CLIENTS,
                       list(self._clients))
        msg.add_params(MyMessage.MSG_ARG_KEY_ROUND, self._round)
        if self._fleet_marker is not None and self._digest is not None:
            # the folded blob: this edge's own digest + its block's child
            # digests under "block" — ONE side-band payload per edge frame.
            # Built here (not cached) so a verdict-retry retransmit carries
            # fresh liveness; the model payload is still the cached
            # bit-identical partial.
            from fedml_tpu_torch.obs.fleet import attach_digest

            blob = self._digest.digest(self._round)
            blob["block"] = list(self._child_digests.values())
            attach_digest(msg, blob)
        self._forwarded = True
        self.send_message(msg)

    def _send_partial(self, wsum: dict, total, reasons) -> None:
        """The fold's device results to host arrays (wire order, float32),
        then the frame. Caller holds _lock."""
        self._send_partial_frame(
            [wsum[i].cpu().numpy() for i in range(len(wsum))],
            float(total), np.asarray(reasons, np.int32))

    def _forward_partial(self) -> None:
        """Single phase: the local non-finite gate and the canonical
        pairwise partial over this block (fused: the arrivals were gated
        and folded already; the holes fold here at their positions).
        Caller holds _lock."""
        if self.fused:
            wsum, total, reasons = self._fused_round.flush_block_partial(
                len(self._slots))
        else:
            stacked, glob, weights = self._stack_block()
            with float32_compute():
                wsum, total, reasons = edge_partial(stacked, glob, weights)
        self._send_partial(wsum, total, reasons.cpu())

    def _forward_evidence(self) -> None:
        """Phase 1 of the two-phase protocol: per-slot evidence to the
        root; the staged uploads stay here until the verdict frame names
        the survivors. Caller holds _lock."""
        if self.fused:
            stacked, weights = self._fused_round.block_stacked(
                len(self._slots))
            glob = self._fused_round._global
        else:
            stacked, glob, weights = self._stack_block()
        self._staged = (stacked, glob)
        with float32_compute():
            ev = update_evidence(stacked, glob, weights,
                                 sketch_dim=self._sketch_dim)
        host = lambda key, dt: np.asarray(ev[key].cpu().numpy(), dt)
        msg = Message(MyMessage.MSG_TYPE_E2S_SEND_EVIDENCE_TO_SERVER,
                      self.rank, 0)
        msg.add_params(MyMessage.MSG_ARG_KEY_EVIDENCE_NORM,
                       host("norm", np.float32))
        msg.add_params(MyMessage.MSG_ARG_KEY_EVIDENCE_FINITE,
                       host("finite", np.int32))
        msg.add_params(MyMessage.MSG_ARG_KEY_EVIDENCE_SKETCH,
                       host("sketch", np.float32))
        msg.add_params(MyMessage.MSG_ARG_KEY_EVIDENCE_WEIGHT,
                       host("weight", np.float32))
        msg.add_params(MyMessage.MSG_ARG_KEY_EDGE_SLOTS,
                       [int(s) for s in self._slots])
        msg.add_params(MyMessage.MSG_ARG_KEY_EDGE_CLIENTS,
                       list(self._clients))
        msg.add_params(MyMessage.MSG_ARG_KEY_ROUND, self._round)
        self._evidence_sent = True
        self.send_message(msg)

    def _handle_verdict(self, msg_params) -> None:
        """Phase 3: fold ONLY the survivors the root's verdict names
        (zero-weight slots replaced by the held global) and forward the
        ordinary partial. A stale verdict dies at the round tag; a RETRIED
        verdict for a round this edge already folded retransmits the cached
        partial instead (the root cannot tell a dropped verdict from a
        dropped partial, and the fold stays exactly-once either way)."""
        with self._lock:
            if self._round is None:
                return
            tag = msg_params.get(MyMessage.MSG_ARG_KEY_ROUND, self._round)
            if int(tag) != self._round:
                _obs.record_stale_upload("stale")
                log.warning("edge %d: drop stale verdict (round %s, now "
                            "%d)", self.edge_idx, tag, self._round)
                return
            if self._forwarded:
                if self._last_partial is not None:
                    log.warning("edge %d: verdict retry for round %d — "
                                "retransmitting the cached partial",
                                self.edge_idx, self._round)
                    self._send_partial_frame(*self._last_partial)
                return
            if not self._evidence_sent or self._staged is None:
                log.warning("edge %d: verdict for round %d before this "
                            "edge sent evidence — dropped (root retry "
                            "covers it)", self.edge_idx, self._round)
                return
            vw = np.asarray(
                msg_params[MyMessage.MSG_ARG_KEY_VERDICT_WEIGHTS],
                np.float32)
            reasons = np.asarray(
                msg_params[MyMessage.MSG_ARG_KEY_VERDICT_REASONS], np.int32)
            stacked, glob = self._staged
            with float32_compute():
                wsum, total = apply_verdicts(stacked, glob, self._put(vw))
            self._staged = None
            self._send_partial(wsum, total, reasons)

    def on_timeout(self, idle_s: float) -> None:
        """Elastic edge tier: a block stalled past round_timeout_s forwards
        its partial (two-phase: its EVIDENCE, the missing children scored
        absent) over the children that did report."""
        with self._lock:
            if (self._round is None or self._forwarded
                    or self.round_timeout_s is None):
                return
            if self.robust and self._evidence_sent:
                # the verdict frame is the root's to retry
                log.warning("edge %d: round %d evidence sent %.1fs ago, "
                            "no verdict yet — waiting (root watchdog owns "
                            "the retry)", self.edge_idx, self._round,
                            idle_s)
                return
            if not self._uploads:
                log.error("edge %d: round %d stalled %.1fs with no child "
                          "uploads — waiting (root watchdog owns "
                          "recovery)", self.edge_idx, self._round, idle_s)
                return
            missing = [self._slots[0] + i for i in range(len(self._slots))
                       if i not in self._uploads]
            log.warning("edge %d: elastic %s over %d/%d children "
                        "(missing slots %s after %.1fs)", self.edge_idx,
                        "evidence" if self.robust else "partial",
                        len(self._uploads), len(self._slots), missing,
                        idle_s)
            if self.robust:
                self._forward_evidence()
            else:
                self._forward_partial()

    def _handle_resume_probe(self, msg_params) -> None:
        """A recovered root probes EVERY rank (edges included — the root
        can't tell tiers apart at probe time). Answer with this edge's
        last-seen round; workers answer the same probe directly (their
        ack goes to the probe's sender, rank 0, not through this edge)."""
        with self._lock:
            last = -1 if self._round is None else int(self._round)
        msg = Message(MyMessage.MSG_TYPE_C2S_RESUME_ACK, self.rank, 0)
        msg.add_params(MyMessage.MSG_ARG_KEY_LAST_SEEN_ROUND, last)
        msg.add_params(MyMessage.MSG_ARG_KEY_LAST_SEEN_WAVE, -1)
        self.send_message(msg)


class HierFedAvgServerManager(FedAvgServerManager):
    """The root of the 2-tier topology: broadcasts one frame per EDGE and
    advances rounds on E edge partials. The elastic timeout, telemetry and
    tracing (the edge tier is the traced cohort) are the flat server
    manager's."""

    def __init__(self, aggregator: HierFedAvgAggregator, **kw):
        if not isinstance(aggregator, HierFedAvgAggregator):
            raise TypeError("HierFedAvgServerManager needs a "
                            "HierFedAvgAggregator")
        self.topology = aggregator.topology
        for name in ("async_buffer_k", "delta_broadcast",
                     "heartbeat_max_age_s",
                     # rank-level churn: the tree's ranks are
                     # infrastructure slots, not devices
                     "churn_trace"):
            if kw.get(name):
                raise ValueError(
                    f"{name} is not wired through edge aggregators — run "
                    "the flat topology for that mode")
        # two-phase state (touched under _round_lock): per-edge staged
        # evidence, whether this round's verdicts went out and when (the
        # hier record's verdict round trip), the one-retry latch
        self._robust = aggregator.robust_mode
        self._edge_evidence: dict[int, dict] = {}
        self._verdict_pack = None       # (vweights [K], reasons [K])
        self._verdict_sent = False
        self._verdict_retried = False
        self._verdict_t: float | None = None
        self._last_verdict_rtt: float | None = None
        super().__init__(aggregator, **kw)

    def _validate_world_size(self, size: int) -> None:
        if size != self.topology.world_size:
            raise ValueError(
                f"world size {size} != 1 + {self.topology.edges} edges + "
                f"{self.topology.workers} workers")

    def register_message_receive_handlers(self):
        super().register_message_receive_handlers()
        self.register_message_receive_handler(
            MyMessage.MSG_TYPE_E2S_SEND_AGG_TO_SERVER,
            self.handle_message_edge_partial)
        self.register_message_receive_handler(
            MyMessage.MSG_TYPE_E2S_SEND_EVIDENCE_TO_SERVER,
            self.handle_message_edge_evidence)

    def _round_record_extra(self) -> dict:
        hist = self.aggregator.fanin_history
        hier = {"edges": self.topology.edges,
                "block": self.topology.block,
                "fan_in": hist[-1] if hist else 0}
        # per-edge rejection counts and the verdict round trip
        rej = self.aggregator.last_round_rejected
        if rej is not None:
            hier["rejected"] = list(rej)
        if self._robust and self._last_verdict_rtt is not None:
            hier["verdict_rtt_s"] = round(self._last_verdict_rtt, 6)
        return {"hier": hier, **super()._round_record_extra()}

    def _broadcast_model(self, msg_type: str, global_params) -> None:
        """One frame per EDGE (fan-out O(edges)): the model, that edge
        block's client assignments and the round tag, with the flat
        broadcast's crash and journal choreography (the between-commits
        point fires BEFORE any frame leaves; the round opening is
        journaled so recovery knows round r was in flight), the fleet
        marker and the goodput stamps. Nothing in the tree reads a stashed
        broadcast (its uplinks are dense), so none is kept."""
        self._maybe_crash("broadcast")
        self._goodput_round_start()
        if self.wal is not None:
            self.wal.append("broadcast", sync=True, round=self.round_idx)
        self._uploads_this_round = 0
        topo = self.topology
        client_indexes = self.aggregator.client_sampling(self.round_idx)
        self._round_ids = [int(c) for c in client_indexes]
        self.aggregator.begin_round(self.round_idx)
        # a fresh verdict phase: a re-broadcast of a stalled round starts
        # the evidence gathering over (edges reset on the downlink)
        self._edge_evidence = {}
        self._verdict_pack = None
        self._verdict_sent = False
        self._verdict_retried = False
        self._verdict_t = None
        tr = self._dtracer
        if tr is not None:
            tr.begin_round(self.round_idx)
        for e in range(topo.edges):
            rank = topo.edge_rank(e)
            msg = Message(msg_type, self.rank, rank)
            msg.add_params(MyMessage.MSG_ARG_KEY_MODEL_PARAMS,
                           global_params)
            msg.add_params(
                MyMessage.MSG_ARG_KEY_CHILD_CLIENTS,
                [int(client_indexes[s]) for s in topo.slots_of_edge(e)])
            msg.add_params(MyMessage.MSG_ARG_KEY_ROUND, self.round_idx)
            if tr is not None:
                msg.add_params(TRACE_KEY, tr.broadcast_ctx(rank))
            self._add_fleet_marker(msg)
            self.send_message(msg)
        if tr is not None:
            tr.end_broadcast()
        self._goodput_broadcast_end()
        # broadcast out, zero partials accepted — the after_uploads=0 point
        self._maybe_crash("post_broadcast")

    def handle_message_edge_evidence(self, msg_params) -> None:
        """Phase 2 intake: stage one edge's per-slot evidence; once every
        edge reported (the elastic watchdog covers the rest), compute the
        cohort's verdicts and answer each reporting edge."""
        with self._round_lock:
            sender = int(msg_params[Message.MSG_ARG_KEY_SENDER])
            edge_idx = sender - 1
            msg_round = msg_params.get(MyMessage.MSG_ARG_KEY_ROUND,
                                       self.round_idx)
            if int(msg_round) != self.round_idx:
                _obs.record_stale_upload("stale")
                log.warning("drop stale edge evidence from rank %d "
                            "(round %s, now %d)", sender, msg_round,
                            self.round_idx)
                return
            if not 0 <= edge_idx < self.topology.edges:
                _obs.record_stale_upload("unknown_rank")
                log.warning("drop evidence from non-edge rank %d", sender)
                return
            if self._verdict_sent or edge_idx in self._edge_evidence:
                # a chaos duplicate, or evidence limping in after an
                # elastic verdict round: exactly-once staging
                _obs.record_stale_upload("stale")
                log.warning("drop late/duplicate evidence from edge %d "
                            "(round %d)", edge_idx, self.round_idx)
                return
            self._edge_evidence[edge_idx] = {
                key: np.asarray(msg_params[arg], dt)
                for key, arg, dt in (
                    ("norm", MyMessage.MSG_ARG_KEY_EVIDENCE_NORM,
                     np.float32),
                    ("finite", MyMessage.MSG_ARG_KEY_EVIDENCE_FINITE,
                     np.int32),
                    ("sketch", MyMessage.MSG_ARG_KEY_EVIDENCE_SKETCH,
                     np.float32),
                    ("weight", MyMessage.MSG_ARG_KEY_EVIDENCE_WEIGHT,
                     np.float32))}
            if len(self._edge_evidence) == self.topology.edges:
                self._send_verdicts()

    def _send_verdicts(self) -> None:
        """The cohort's verdicts over the gathered evidence (the math a
        flat two-phase server runs, over the same [K] inputs: the bitwise
        half of the tree == flat ledger), one verdict frame per reporting
        edge. A block with no evidence (a lost edge) scores absent: zero
        weight, reason OK here, ledgered edge_lost at the aggregate.
        Caller holds _round_lock."""
        topo = self.topology
        K = topo.workers
        some = next(iter(self._edge_evidence.values()))
        norm = np.zeros((K,), np.float32)
        finite = np.ones((K,), bool)
        sketch = np.zeros((K, some["sketch"].shape[1]), np.float32)
        weight = np.zeros((K,), np.float32)
        for e, ev in self._edge_evidence.items():
            sl = slice(e * topo.block, (e + 1) * topo.block)
            norm[sl] = ev["norm"]
            finite[sl] = ev["finite"] != 0
            sketch[sl] = ev["sketch"]
            weight[sl] = ev["weight"]
        dev = self.aggregator.device
        with float32_compute():
            vw, reasons = self.aggregator.verdicts(
                {"norm": torch.from_numpy(norm).to(dev),
                 "finite": torch.from_numpy(finite).to(dev),
                 "sketch": torch.from_numpy(sketch).to(dev),
                 "weight": torch.from_numpy(weight).to(dev)})
        self._verdict_pack = (vw.cpu().numpy().astype(np.float32),
                              reasons.cpu().numpy().astype(np.int32))
        for e in sorted(self._edge_evidence):
            self._send_verdict_frame(e)
        self._verdict_sent = True
        self._verdict_t = time.monotonic()

    def _send_verdict_frame(self, edge_idx: int) -> None:
        """One s2e_verdict frame: that block's per-slot survivor weights
        and reason codes, re-sent verbatim by the watchdog's retry (the
        edge dedups). Caller holds _round_lock."""
        vw, reasons = self._verdict_pack
        topo = self.topology
        sl = slice(edge_idx * topo.block, (edge_idx + 1) * topo.block)
        msg = Message(MyMessage.MSG_TYPE_S2E_SEND_VERDICT_TO_EDGE,
                      self.rank, topo.edge_rank(edge_idx))
        msg.add_params(MyMessage.MSG_ARG_KEY_VERDICT_WEIGHTS, vw[sl])
        msg.add_params(MyMessage.MSG_ARG_KEY_VERDICT_REASONS, reasons[sl])
        msg.add_params(MyMessage.MSG_ARG_KEY_ROUND, self.round_idx)
        self.send_message(msg)

    def handle_message_edge_partial(self, msg_params) -> None:
        with self._round_lock:
            sender = int(msg_params[Message.MSG_ARG_KEY_SENDER])
            msg_round = msg_params.get(MyMessage.MSG_ARG_KEY_ROUND,
                                       self.round_idx)
            if int(msg_round) != self.round_idx:
                _obs.record_stale_upload("stale")
                log.warning("drop stale edge partial from rank %d "
                            "(round %s, now %d)", sender, msg_round,
                            self.round_idx)
                return
            if self.telemetry is not None:
                # the last counted arrival closes this round's wire_wait
                self._gp_last_arrival_t = time.monotonic()
            if self._dtracer is not None:
                self._dtracer.on_upload(sender, msg_params.get(TRACE_KEY))
            if self._fleet is not None:
                self._fleet.ingest(
                    msg_params.get(MyMessage.MSG_ARG_KEY_TELEMETRY))
            samples = msg_params.get(MyMessage.MSG_ARG_KEY_EDGE_SAMPLES)
            already = bool(self.aggregator.flag_client_model_uploaded.get(
                sender - 1))
            self.aggregator.add_edge_result(
                sender - 1,
                msg_params[MyMessage.MSG_ARG_KEY_EDGE_WSUM],
                float(msg_params[MyMessage.MSG_ARG_KEY_EDGE_WEIGHT]),
                msg_params[MyMessage.MSG_ARG_KEY_EDGE_REASONS],
                msg_params[MyMessage.MSG_ARG_KEY_EDGE_SLOTS],
                msg_params[MyMessage.MSG_ARG_KEY_EDGE_CLIENTS],
                round_idx=int(msg_round),
                samples=None if samples is None else float(samples))
            if (not already and self.aggregator
                    .flag_client_model_uploaded.get(sender - 1)):
                # the accepted partial is this tier's "upload": journal it
                # (fsync'd) so a crash before the commit ledgers the edge's
                # slot server_restart on recovery — and feed the
                # after_uploads crash points, which count edge partials in
                # tree mode (a verdict-retry retransmit stays dedup'd by
                # the `already` flag)
                self._uploads_this_round += 1
                if self.wal is not None:
                    self.wal.append("upload", sync=True,
                                    round=int(msg_round), rank=int(sender))
                self._maybe_crash("upload")
            if self._robust and self._verdict_t is not None:
                # verdict fan-out -> this partial (the last one's arrival
                # is the slowest edge's turn-around)
                self._last_verdict_rtt = time.monotonic() - self._verdict_t
            if not self.aggregator.check_whether_all_receive():
                return
            self._advance_round()

    def on_timeout(self, idle_s: float):
        """Two-phase elastic recovery before the flat watchdog: a round
        stalled in phase 1 computes verdicts over the evidence that did
        arrive (missing blocks score absent); one stalled in phase 2
        re-sends the verdict frames once (chaos may have dropped them; the
        edge dedups). Only then the flat watchdog acts (the partial
        aggregate over the partials that did land, or the re-broadcast)."""
        if self._robust:
            with self._round_lock:
                if (self.round_timeout_s is not None
                        and not self._finished.is_set()
                        and self.round_idx < self.round_num):
                    if self._edge_evidence and not self._verdict_sent:
                        missing = [e for e in range(self.topology.edges)
                                   if e not in self._edge_evidence]
                        log.warning(
                            "round %d: elastic verdicts over %d/%d edges' "
                            "evidence (missing edges %s after %.1fs)",
                            self.round_idx, len(self._edge_evidence),
                            self.topology.edges, missing, idle_s)
                        self._send_verdicts()
                        return
                    if self._verdict_sent and not self._verdict_retried:
                        waiting = [e for e in sorted(self._edge_evidence)
                                   if e not in self.aggregator.model_dict]
                        if waiting:
                            log.warning(
                                "round %d: verdict sent %.1fs ago, no "
                                "partial from edges %s — re-sending "
                                "verdict frames once", self.round_idx,
                                idle_s, waiting)
                            self._verdict_retried = True
                            for e in waiting:
                                self._send_verdict_frame(e)
                            return
        super().on_timeout(idle_s)


def run_simulated_hierarchical(
    dataset, task, cfg, edges: int, backend: str = "LOOPBACK",
    job_id: str = "fedavg-hier-sim", base_port: int = 50000,
    broker_host: str = "127.0.0.1", broker_port: int = 1883,
    ckpt_dir: str | None = None, telemetry=None, chaos_plan=None,
    round_timeout_s: float | None = None, adversary_plan=None,
    warmup: bool = False, aggregator: str | None = None,
    aggregator_params: dict | None = None,
    sanitize: bool | float | None = None, fused_agg: bool = False,
    device=None,
) -> HierFedAvgAggregator:
    """The 2-tier ``run_simulated``: 1 root + E edges + W workers as
    threads over the loopback (or localhost gRPC / MQTT) backend.
    ``cfg.client_num_per_round`` is W; worker slot s trains
    ``client_sampling(round)[s]`` as the flat runtime's rank s + 1 does, so
    the tree's and the flat run's cohorts coincide round for round.

    ``aggregator=`` / ``sanitize=`` arm the two-phase protocol with the
    flat ``run_simulated``'s semantics; an ``adversary_plan``'s 1-based
    ranks match workers by COHORT SLOT (slot + 1), not transport rank, so
    one plan drives a flat and a tree run alike. Chaos crash rules naming
    rank 0 run the flat driver's supervision loop (they need ``ckpt_dir``):
    the root is killed at its crash point and a fresh one recovers through
    checkpoint + WAL while the edges and workers, started once, run on.
    Returns the root's aggregator (``.net``, ``.history``,
    ``.quarantine``, ``.fanin_history``)."""
    from fedml_tpu_torch import chaos as _chaos
    from fedml_tpu_torch.distributed.fedavg.client_manager import (
        FedAvgClientManager,
    )
    from fedml_tpu_torch.distributed.fedavg.trainer import DistributedTrainer
    from fedml_tpu_torch.distributed.utils import backend_kwargs, launch_simulated

    topo = EdgeTopology(edges=edges, workers=cfg.client_num_per_round)
    kw = backend_kwargs(backend, job_id, base_port, broker_host,
                        broker_port)
    if chaos_plan is not None:
        _chaos.install_plan(chaos_plan)
    try:
        from fedml_tpu_torch.distributed.fedavg.api import (
            run_supervised_simulated,
            server_crash_points,
        )

        # chaos crash rules naming rank 0 are supervised root restarts,
        # the flat driver's contract: edges reset their round state on
        # the recovered root's next downlink
        crash_points = server_crash_points(ckpt_dir)

        def build_server():
            root_agg = HierFedAvgAggregator(
                dataset, task, cfg, topo, aggregator=aggregator,
                aggregator_params=aggregator_params, sanitize=sanitize,
                device=device)
            return HierFedAvgServerManager(
                root_agg, rank=0, size=topo.world_size, backend=backend,
                ckpt_dir=ckpt_dir, round_timeout_s=round_timeout_s,
                telemetry=telemetry, **kw)

        server = build_server()
        root_agg = server.aggregator
        # the edge watchdog runs at HALF the root's deadline: a stalled
        # block's evidence or partial goes out strictly before the root's
        # own timeout acts, so a chaos run's replay rests on the seeded
        # schedule, never on which watchdog happened to fire first
        edge_timeout = (round_timeout_s / 2.0
                        if round_timeout_s is not None else None)
        edge_mgrs = [
            # fused_agg is an edge-tier property in the tree: the edges do
            # the fan-in ingest; the root folds O(edges) partial frames
            FedAvgEdgeManager(topo.edge_rank(e), topo, backend=backend,
                              round_timeout_s=edge_timeout,
                              robust=root_agg.robust_mode,
                              sketch_dim=root_agg.sketch_dim,
                              fused=fused_agg, device=device, **kw)
            for e in range(topo.edges)
        ]
        clients = []
        for slot in range(topo.workers):
            rank = topo.worker_rank(slot)
            trainer = DistributedTrainer(rank, dataset, task, cfg,
                                         device=device)
            clients.append(FedAvgClientManager(
                trainer, rank=rank, size=topo.world_size, backend=backend,
                server_rank=topo.edge_rank(topo.edge_of_slot(slot)),
                adversary_plan=adversary_plan,
                adversary_rank=slot + 1, **kw))
        if warmup and clients:
            clients[0].warmup()
        if crash_points:
            # edges and workers run ONCE, spanning every root generation
            server = run_supervised_simulated(
                server, edge_mgrs + clients, crash_points, build_server)
        else:
            launch_simulated(server, edge_mgrs + clients)
    finally:
        if chaos_plan is not None:
            _chaos.install_plan(None)
    return server.aggregator
