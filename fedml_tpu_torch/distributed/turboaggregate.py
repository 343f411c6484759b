"""Distributed TurboAggregate — dropout-tolerant masked secure aggregation,
port of fedml_tpu/distributed/turboaggregate.py.

- Clients upload ONE masked field vector: the weighted params quantized
  into GF(2^31-1) plus cancelling pairwise masks and a Shamir-shared
  self-mask (core/secure_agg.py), masked on the client's device. The
  server never sees cleartext params; its per-upload cost is one
  streaming add mod p on its device (``fold_masked_device``). A model's
  extras (BatchNorm statistics) are not secret: they ride the upload in
  the clear after the masked vector and its shares, and the server takes
  their sample-weighted mean over the round's survivors (the global
  extras stay when no slot survives), as the reference does.
- With ``round_timeout_s`` armed, clients that crash inside the deadline
  degrade the round instead of wedging it: the server asks each survivor
  for its pairwise seeds of exactly the dead slots (``s2c_reveal`` /
  ``c2s_reveal``), strips the orphaned masks and the survivors'
  self-masks, and lands the exact elastic partial aggregate (survivor
  reweighting). Below ``threshold_t + 1`` survivors, or with a reveal lost
  past one retry, the round sheds loudly: every lost slot is ledgered,
  ``fed_secagg_rounds_total{outcome="shed"}`` counts it, and the round is
  re-broadcast.
- ``defense_type='dp'`` runs accounted DP-FedAvg on the masked path:
  clients clip their round delta to C before masking, the server adds
  Gaussian noise ``z*C/m`` over the realized survivor count m (drawn on
  its device: ``prng.normal_torch``, the JAX package's key chain), charges
  the accountant and the per-client ledger (core/privacy.py), and writes
  the WAL ``precharge`` record with the surviving client ids before the
  draw. Noise key and RDP totals ride the server checkpoint.

Every mask seed derives from the session seed (secure_agg.derive_secret),
so a chaos run's masked aggregates, ledger and recovery frames replay
exactly, and the port's frames are the JAX package's: the ranks of the two
packages mix in one job.

Hierarchical tier (``run_simulated(edges=E)``): pairwise masks are drawn
within each edge block (keys and seeds cohort-global, partners restricted
— masks cancel at the edge), so every ``TASecureEdgeManager`` folds its
block mod p, runs the reveal recovery locally for in-block dead slots, and
forwards one unmasked int64 field partial; the root
(``HierTASecureServerManager`` / ``HierTAAggregator``) folds E partials mod
p and decodes once. Mod-p addition is exact and associative, so the tree
is bitwise the flat masked run. A whole edge lost inside
``round_timeout_s`` sheds exactly that block's slots.

A server crash during the reveal fan-out (chaos ``after_uploads=-1``,
the server manager's ``reveal`` point) recovers as a shed round: the WAL's
``secagg_reveal`` record names the slots the reveal was recovering,
they are ledgered ``secagg_shed``, and the round re-runs clean.
"""

from __future__ import annotations

import functools
import logging
import time

import numpy as np
import torch

from fedml_tpu_torch.algorithms.fedavg import FedAvgConfig
from fedml_tpu_torch.comm.message import Message, pack_pytree
from fedml_tpu_torch.core import secure_agg as sa
from fedml_tpu_torch.core.sampling import sample_clients
from fedml_tpu_torch.distributed.fedavg.aggregator import FedAvgAggregator
from fedml_tpu_torch.distributed.fedavg.api import (
    run_supervised_simulated,
    server_crash_points,
)
from fedml_tpu_torch.distributed.fedavg.client_manager import (
    FedAvgClientManager,
)
from fedml_tpu_torch.distributed.fedavg.hierarchy import (
    EdgeTopology,
    FedAvgEdgeManager,
)
from fedml_tpu_torch.distributed.fedavg.message_define import MyMessage
from fedml_tpu_torch.distributed.fedavg.server_manager import (
    FedAvgServerManager,
)
from fedml_tpu_torch.distributed.fedavg.trainer import (
    DistributedTrainer,
    num_batches_for,
)
from fedml_tpu_torch.distributed.utils import backend_kwargs, launch_simulated
from fedml_tpu_torch.obs import comm_instrument as _obs
from fedml_tpu_torch.obs import perf_instrument as _perf
from fedml_tpu_torch.obs.tracing import TRACE_KEY
from fedml_tpu_torch.utils import prng
from fedml_tpu_torch.utils.tree import (
    params_size,
    params_unvectorize,
    params_vectorize,
    tree_weighted_mean,
)

log = logging.getLogger("fedml_tpu_torch.distributed.fedavg")


def _batch_cap(dataset, cfg: FedAvgConfig) -> int:
    """The trainer's num_batches formula (``num_batches_for``) as a sample
    cap: the server must compute the SAME per-client cap to reproduce the
    deterministic cohort weight total (sample counts are public; the
    masked sum is not)."""
    max_count = max(len(v) for v in dataset.train_idx_map.values())
    return num_batches_for(max_count, cfg) * cfg.batch_size


def cohort_sample_counts(round_idx: int, cfg: FedAvgConfig, dataset,
                         cap: int) -> tuple[np.ndarray, list[int]]:
    """(sampled client ids, per-slot sample counts) — computable by every
    party from the deterministic sampler, which is what lets clients
    pre-normalize their weights without a weight-exchange phase."""
    ids = sample_clients(round_idx, cfg.client_num_in_total,
                         cfg.client_num_per_round, cfg.seed)
    counts = [min(len(dataset.train_idx_map[int(i)]), cap) for i in ids]
    return ids, counts


def _secagg_config(cfg: FedAvgConfig, threshold_t: int | None,
                   quant_scale: float, defense_type: str,
                   norm_bound: float,
                   secagg_max_abs: float) -> sa.SecAggConfig:
    """One construction rule for every party: DP mode's clip bound IS the
    capacity promise (||delta||_2 <= C bounds every coordinate); the
    weighted path promises ``secagg_max_abs`` and enforces it at mask
    time. ``threshold_t=None`` adapts to the cohort (min(2, K-1)). Raises
    at construction when the cohort would wrap GF(p)."""
    if threshold_t is None:
        threshold_t = sa.default_threshold_t(cfg.client_num_per_round)
    max_abs = float(norm_bound) if defense_type == "dp" \
        else float(secagg_max_abs)
    return sa.SecAggConfig(cohort=cfg.client_num_per_round,
                           threshold_t=threshold_t,
                           quant_scale=quant_scale, max_abs=max_abs)


class SecureTrainer(DistributedTrainer):
    """DistributedTrainer whose wire format is ``[masked_vec, b_shares,
    *extras]``: the params never leave the client unmasked; a model's
    extras follow in the clear, as wire leaves (the reference's
    ``pack_pytree(net.extra)``). The masking runs on the trainer's
    device."""

    def __init__(self, client_rank, dataset, task, cfg, threshold_t=None,
                 quant_scale=2**16, defense_type: str = "none",
                 norm_bound: float = 30.0, secagg_max_abs: float = 4.0,
                 slot: int | None = None, peers=None, device=None):
        super().__init__(client_rank, dataset, task, cfg, device=device)
        # cohort SLOT (stable per rank), not the per-round client id. The
        # hierarchical tier passes it (worker rank = 1 + edges + slot) and
        # the slot's edge-block ``peers``: pair masks drawn only against
        # block partners cancel AT THE EDGE
        self.slot = (client_rank - 1) if slot is None else int(slot)
        self.peers = None if peers is None \
            else sorted(int(j) for j in peers)
        self.defense_type = defense_type
        self.norm_bound = float(norm_bound)
        self.secagg = _secagg_config(cfg, threshold_t, quant_scale,
                                     defense_type, norm_bound,
                                     secagg_max_abs)
        self._fit_round: int | None = None
        self._fit_n = 0
        self._global_vec = None

    def _round_weight(self, round_idx: int, n: int) -> float:
        """This client's n_k / sum_cohort(n_j), from the public sampler —
        pre-normalized so encoded field values stay inside the capacity
        promise."""
        _, counts = cohort_sample_counts(round_idx, self.cfg, self.dataset,
                                         _batch_cap(self.dataset, self.cfg))
        return n / max(sum(counts), 1)

    def reveal_pair_seeds(self, round_idx: int,
                          dead_slots: list[int]) -> list[int]:
        """The recovery reveal: this survivor's pairwise seeds for exactly
        the DEAD slots — never a seed for a live pair, never the self-mask
        seed."""
        sk = sa.secret_key(self.cfg.seed, round_idx, self.slot,
                           self.secagg.p)
        pks = sa.public_keys(self.cfg.seed, round_idx, self.secagg.cohort,
                             self.secagg.p)
        return [sa.pair_seed(sk, pks[int(j)], self.secagg.p)
                for j in dead_slots]

    def _vector(self) -> torch.Tensor:
        """The params as one float64 vector in the JAX package's order."""
        return params_vectorize(self.net, self.task.extra_keys,
                                self.num_heads).to(torch.float64)

    def fit(self, round_idx: int) -> int:
        if self.defense_type == "dp":
            # the broadcast, before the fit overwrites self.net: the
            # clipped ROUND DELTA is what gets masked
            self._global_vec = self._vector()
        n = super().fit(round_idx)
        self._fit_round, self._fit_n = int(round_idx), n
        return n

    def wire_leaves(self) -> list:
        """The last fit's upload: its masked field vector, the Shamir
        shares of its self-mask seed, and its extras' wire leaves."""
        r = self._fit_round
        if self.defense_type == "dp":
            # clip the ROUND DELTA to the L2 ball C, mask unweighted: the
            # server divides by the realized survivor count and the noise
            # z*C/m assumes exactly this sensitivity
            vec = self._vector() - self._global_vec
            nrm = float(torch.linalg.vector_norm(vec))
            if nrm > self.norm_bound:
                vec = vec * (self.norm_bound / nrm)
            weight = 1.0
        else:
            vec = self._vector()
            weight = self._round_weight(r, self._fit_n)
        masked = sa.mask_update(vec, weight, self.slot, self.cfg.seed, r,
                                self.secagg, peers=self.peers)
        b_shares = sa.self_mask_shares(self.cfg.seed, r, self.slot,
                                       self.secagg)
        return [masked, b_shares, *_extra_leaves(self.net, self.num_heads,
                                                 self.task.extra_keys)]


class TAAggregator(FedAvgAggregator):
    """Folds masked uploads mod p (one add per arrival); decodes only the
    survivor SUM after mask recovery."""

    # masked vectors are int64 field elements, never a state dict
    _stage_uploads_on_arrival = False

    def __init__(self, dataset, task, cfg: FedAvgConfig, worker_num: int,
                 threshold_t=None, quant_scale=2**16,
                 defense_type: str = "none",  # 'none' | 'dp'
                 norm_bound: float = 30.0, noise_multiplier: float = 1.0,
                 secagg_max_abs: float = 4.0, device=None):
        super().__init__(dataset, task, cfg, worker_num, device=device)
        if defense_type not in ("none", "dp"):
            raise ValueError(f"unknown defense_type {defense_type!r} for "
                             "the secure-aggregation tier ('none' | 'dp')")
        self.secagg = _secagg_config(cfg, threshold_t, quant_scale,
                                     defense_type, norm_bound,
                                     secagg_max_abs)
        self.quant_scale = float(quant_scale)
        self.defense_type = defense_type
        self.accountant = None
        self.client_ledger = None
        self._privacy_cache = None
        if defense_type == "dp":
            from fedml_tpu_torch.core.privacy import (
                ClientPrivacyLedger,
                DPAccountant,
            )

            if noise_multiplier <= 0:
                raise ValueError("defense_type='dp' needs noise_multiplier"
                                 f" > 0, got {noise_multiplier}")
            self.accountant = DPAccountant()
            self.client_ledger = ClientPrivacyLedger()
            self._dp_z, self._dp_C = float(noise_multiplier), float(norm_bound)
            self._noise_rng = prng.key(cfg.seed + 7)
            _perf.ensure_client_privacy_family()
        _perf.ensure_secagg_families()
        # per-round fold state, the mod-p accumulator on the server's
        # device (begin_round resets; _frozen parks the
        # fold while a recovery is in flight, so a late upload cannot
        # corrupt the fixed survivor sum)
        self._acc = None
        self._round_slots: set[int] = set()
        self._b_shares: dict[int, np.ndarray] = {}
        self._extras: dict[int, list] = {}
        self._frozen = False
        self._recovery: tuple[list[int], list[int], dict] | None = None

    def begin_round(self, round_idx: int) -> None:
        super().begin_round(round_idx)
        self._acc = None
        self._round_slots = set()
        self._b_shares = {}
        self._extras = {}
        self._frozen = False
        self._recovery = None
        self.sample_num_dict.clear()

    def add_local_trained_result(self, index: int, wire_leaves,
                                 sample_num: int,
                                 round_idx: int | None = None) -> None:
        if not self._admit_upload(index, round_idx):
            return
        if self._frozen:
            # recovery in flight: the survivor set (and the reveal
            # requests out for it) is FIXED; the shed/re-broadcast path
            # gives the rank a fresh shot at the round
            _obs.record_stale_upload("stale")
            log.warning("secagg: dropping late upload from slot %d — "
                        "mask recovery already in flight", index)
            return
        if index in self._round_slots:
            # a chaos-duplicated upload: the fold is additive, so
            # exactly-once matters here (the dense slot overwrite was
            # idempotent)
            _obs.record_stale_upload("stale")
            log.warning("secagg: dropping duplicate upload from slot %d",
                        index)
            return
        masked, b_shares = wire_leaves[0], wire_leaves[1]
        self._acc = sa.fold_masked_device(self._acc, masked, self.secagg.p,
                                          device=self.device)
        self._round_slots.add(index)
        self._b_shares[index] = np.asarray(b_shares, np.int64)
        self._extras[index] = list(wire_leaves[2:])
        self.sample_num_dict[index] = sample_num
        self.flag_client_model_uploaded[index] = True

    def set_recovery(self, survivors, dead,
                     pair_reveals: dict[int, dict[int, int]]) -> None:
        """Fix the survivor/dead split (and the survivors' revealed pair
        seeds) the next ``aggregate()`` decodes with. Dead slots are
        ledgered ``secagg_dropout`` with the clients they would have
        trained."""
        survivors = sorted(int(s) for s in survivors)
        dead = sorted(int(d) for d in dead)
        if len(survivors) < self.secagg.recovery_min:
            raise ValueError(
                f"secagg recovery needs >= {self.secagg.recovery_min} "
                f"survivors, got {len(survivors)}")
        self._recovery = (survivors, dead, dict(pair_reveals))
        if dead:
            ids = self.client_sampling(self.current_round)
            for j in dead:
                self.quarantine.record(self.current_round, j + 1,
                                       "secagg_dropout",
                                       client=int(ids[j]))
                _obs.record_update_rejected("secagg_dropout")
            _perf.record_secagg_dropped(len(dead))

    def aggregate(self):
        if self._recovery is None:
            # full barrier (no elastic manager in the stack): every slot
            self.set_recovery(sorted(self._round_slots), [], {})
        survivors, dead, reveals = self._recovery
        t0 = time.perf_counter()
        # strip the survivors' self-masks (from the shares the SURVIVOR
        # slots hold: >= t+1 by the recovery threshold) and the dead
        # slots' orphaned pair masks (from the survivors' reveals)
        self_seeds = {
            i: sa.recover_self_seed(
                survivors, self._b_shares[i][survivors],
                self.secagg.threshold_t, self.secagg.p)
            for i in survivors}
        vec_sum = sa.unmask_sum(self._acc, survivors, dead, self_seeds,
                                reveals, self.secagg, device=self.device)
        return self._finish_aggregate(vec_sum, survivors, t0)

    def _finish_aggregate(self, vec_sum, survivors, t0):
        """The decode-side tail both tiers share once a round's float64
        survivor SUM exists: the DP noise and charge (with the per-client
        precharge journal) or the elastic survivor reweighting, on the
        server's device; then the fold-state reset."""
        vec_sum = torch.as_tensor(vec_sum).to(self.device, torch.float64)
        nsamp = np.asarray([self.sample_num_dict[i] for i in survivors],
                           np.float64)
        if self.defense_type == "dp":
            # clients masked UNWEIGHTED clipped deltas: the uniform mean
            # over the realized m plus noise z*C/m, the accountant charged
            # with the realized sampling rate
            m = len(survivors)
            delta = vec_sum / m
            sd = self._dp_z * self._dp_C / m
            ids = self.client_sampling(self.current_round)
            client_ids = [int(ids[i]) for i in survivors]
            wal = getattr(self, "wal", None)
            if wal is not None:
                # WAL pre-charge, fsync'd BEFORE the noise key is drawn: a
                # restarted accountant (and the per-client ledgers, from
                # ``clients``) replays it, so ε is never under-reported
                wal.append("precharge", sync=True,
                           round=int(self.current_round),
                           q=float(m / self.cfg.client_num_in_total),
                           z=float(self._dp_z), clip=float(self._dp_C),
                           m=int(m), clients=client_ids)
            self._noise_rng, k = prng.split(self._noise_rng)
            noise = prng.normal_torch(k, tuple(delta.shape),
                                      self.device).to(torch.float64) * sd
            global_vec = params_vectorize(
                self.net, self.task.extra_keys, self.num_heads).to(
                torch.float64)
            new_vec = global_vec + delta + noise
            from fedml_tpu_torch.core.privacy import charge_and_record

            self._privacy_cache = charge_and_record(
                self.accountant, m / self.cfg.client_num_in_total,
                self._dp_z, self._dp_C, realized_m=m,
                client_ledger=self.client_ledger, client_ids=client_ids)
        else:
            # clients pre-normalized by the FULL cohort total T; the
            # decoded sum is sum_S (n_i/T) x_i — rescale by T / sum_S n_i
            # for the exact survivor-weighted mean (the elastic rule)
            _, counts = cohort_sample_counts(
                self.current_round, self.cfg, self.dataset,
                _batch_cap(self.dataset, self.cfg))
            new_vec = vec_sum * (max(sum(counts), 1)
                                 / max(float(nsamp.sum()), 1e-12))
        new_net = params_unvectorize(new_vec.to(torch.float32), self.net,
                                     self.task.extra_keys, self.num_heads)
        if self.task.extra_keys and survivors:
            # the extras are not secret: the plain mean over the
            # survivors' cleartext leaves, weighted by their float32
            # sample counts
            new_net.update(self._extras_mean(survivors, nsamp))
        self.net = new_net
        self._acc, self._recovery = None, None
        self._round_slots, self._b_shares, self._extras = set(), {}, {}
        self.sample_num_dict.clear()
        flush_s = time.perf_counter() - t0
        _perf.record_flush_seconds(flush_s)
        self._last_flush = {"fused": True, "flush_s": round(flush_s, 6)}
        return pack_pytree(self.net, self.num_heads)

    def _extras_mean(self, survivors, nsamp) -> dict:
        """The survivors' extras (wire leaves) staged on the device and
        averaged with the ``nsamp`` weights, in the port's layout."""
        stacked = [torch.stack([torch.from_numpy(np.array(
            self._extras[i][j])) for i in survivors]).to(self.device)
            for j in range(len(self._extras[survivors[0]]))]
        avg = tree_weighted_mean(dict(enumerate(stacked)), torch.tensor(
            nsamp, dtype=torch.float32, device=self.device))
        keys = _extra_keys_of(self.net, self.num_heads, self.task.extra_keys)
        return {k: avg[j].to(self.net[k].dtype) for j, k in enumerate(keys)}

    def privacy_record(self) -> dict | None:
        """The round record's ``privacy`` block (None outside dp mode)."""
        return self._privacy_cache


@functools.lru_cache(maxsize=8)
def _extra_wire_keys(shapes: tuple, num_heads, extra_keys: tuple) -> tuple:
    """The port keys of a net's extras in wire order (the trailing leaves
    of ``net_items``), for a net of these sorted ``(key, shape)`` entries.
    Each extra is a vector the wire copies as it is (``convert``), so a
    leaf is its entry's values."""
    from fedml_tpu_torch.comm.message import net_items

    index = {k: torch.full(shape, float(i), dtype=torch.float64)
             for i, (k, shape) in enumerate(shapes)}
    items = net_items(index, num_heads)
    names = [k for k, _ in shapes]
    keys = tuple(names[int(np.asarray(leaf).reshape(-1)[0])]
                 for _, leaf in items[len(items) - len(extra_keys):])
    if sorted(keys) != sorted(extra_keys):
        raise ValueError("the extras are not the trailing wire leaves")
    return keys


def _extra_keys_of(net: dict, num_heads, extra_keys) -> tuple:
    return _extra_wire_keys(tuple((k, tuple(v.shape))
                                  for k, v in sorted(net.items())),
                            num_heads, tuple(sorted(extra_keys)))


def _extra_leaves(net: dict, num_heads, extra_keys) -> list:
    """A net's extras as wire leaves (host float arrays in wire order, the
    reference's ``pack_pytree(net.extra)``)."""
    if not extra_keys:
        return []
    return [net[k].detach().cpu().numpy()
            for k in _extra_keys_of(net, num_heads, extra_keys)]


def _masked_leaves_ok(leaves, n: int, cohort: int,
                      extra_shapes=()) -> bool:
    """A masked upload's structure: ``[masked int64 [n], shares int64
    [cohort], *extras]``, one float32 leaf of each of ``extra_shapes``."""
    if not isinstance(leaves, list) or len(leaves) != 2 + len(extra_shapes):
        return False
    masked, shares = np.asarray(leaves[0]), np.asarray(leaves[1])
    return (masked.dtype == np.int64 and masked.shape == (n,)
            and shares.dtype == np.int64 and shares.shape == (cohort,)
            and all(np.asarray(e).dtype == np.float32
                    and np.shape(e) == shape
                    for e, shape in zip(leaves[2:], extra_shapes)))


class TASecureClientManager(FedAvgClientManager):
    """FedAvgClientManager that answers mask-recovery reveal requests.

    Reveal requests are retried once by the server's watchdog, so the
    handler caches on (round, dead-set): a retry retransmits the SAME
    seeds verbatim, and the server's exactly-once fold drops the
    duplicate."""

    def register_message_receive_handlers(self):
        super().register_message_receive_handlers()
        self.register_message_receive_handler(
            MyMessage.MSG_TYPE_S2C_REVEAL_REQUEST,
            self.handle_message_reveal_request)

    def handle_message_reveal_request(self, msg_params):
        round_idx = int(msg_params[MyMessage.MSG_ARG_KEY_ROUND])
        dead = [int(d) for d in
                np.asarray(msg_params[MyMessage.MSG_ARG_KEY_SECAGG_DEAD])]
        key = (round_idx, tuple(dead))
        cache = getattr(self, "_reveal_cache", None)
        if cache is None:
            cache = self._reveal_cache = {}
        seeds = cache.get(key)
        if seeds is None:
            seeds = self.trainer.reveal_pair_seeds(round_idx, dead)
            # one recovery in flight at a time: an older entry can never
            # be legitimately re-requested
            cache.clear()
            cache[key] = seeds
        else:
            log.info("secagg: duplicate reveal request for round %d — "
                     "retransmitting the cached reply verbatim", round_idx)
        msg = Message(MyMessage.MSG_TYPE_C2S_REVEAL_SHARES, self.rank,
                      self.server_rank)
        msg.add_params(MyMessage.MSG_ARG_KEY_SECAGG_DEAD,
                       np.asarray(dead, np.int64))
        msg.add_params(MyMessage.MSG_ARG_KEY_SECAGG_PAIR_SEEDS,
                       np.asarray(seeds, np.int64))
        msg.add_params(MyMessage.MSG_ARG_KEY_ROUND, round_idx)
        # reveals bypass the uplink sender: tiny frames, and the round
        # cannot advance until they land
        self.send_message(msg)


class TASecureServerManager(FedAvgServerManager):
    """FedAvgServerManager with the mask-recovery state machine.

    Phases per round: ``uploads`` (the barrier / elastic timeout) -> when
    slots are missing and survivors >= t+1, ``recovery`` (reveal requests
    out, replies folding in) -> aggregate. Below threshold, or with a
    reveal lost past the watchdog's one retry, the round SHEDS: every lost
    slot is ledgered, the outcome metric counts it, and the round
    re-broadcasts."""

    def __init__(self, aggregator: TAAggregator, **kw):
        if kw.get("async_buffer_k") is not None:
            raise ValueError("the masked secure-aggregation tier needs "
                             "the synchronous cohort — async_buffer_k is "
                             "refused")
        if kw.get("delta_broadcast"):
            raise ValueError("delta_broadcast is not wired for the "
                             "masked secure-aggregation tier (uploads "
                             "prove no base version — run dense)")
        if kw.get("heartbeat_max_age_s") is not None:
            raise ValueError("heartbeat cohort admission is not wired for "
                             "the masked secure-aggregation tier (an "
                             "excluded slot's masks would orphan every "
                             "round) — rely on round_timeout_s recovery")
        super().__init__(aggregator, **kw)
        self._phase = "uploads"
        self._reveal: dict | None = None
        self._reveal_retried = True
        if not hasattr(self, "_last_secagg"):
            # crash recovery (_recover_in_flight, run from the base
            # __init__) may already have recorded a shed outcome here
            self._last_secagg: dict | None = None

    def register_message_receive_handlers(self):
        super().register_message_receive_handlers()
        self.register_message_receive_handler(
            MyMessage.MSG_TYPE_C2S_REVEAL_SHARES,
            self.handle_message_reveal_shares)

    def _decode_upload(self, msg_params, sender: int, version: int):
        """A masked upload passes through when its leaves have the masked
        layout (the field vector at the model's width, one share a cohort
        slot); anything else is quarantined ``undecodable`` and counted,
        as the dense check does."""
        agg: TAAggregator = self.aggregator
        leaves = msg_params.get(MyMessage.MSG_ARG_KEY_MODEL_PARAMS)
        extra_keys = agg.task.extra_keys
        n = params_size(agg.net, extra_keys)
        shapes = [tuple(agg.net[k].shape) for k in
                  _extra_keys_of(agg.net, agg.num_heads, extra_keys)]
        if _masked_leaves_ok(leaves, n, agg.secagg.cohort, shapes):
            return leaves
        agg.quarantine.record(self.round_idx, sender, "undecodable")
        _obs.record_update_rejected("undecodable")
        log.warning("quarantining upload from rank %d: not a masked "
                    "field vector of %d elements with %d shares and %d "
                    "extras", sender, n, agg.secagg.cohort, len(shapes))
        return None

    # ------------------------------------------------------------ recovery
    def _advance_round(self):
        """Route through mask recovery before the base aggregate: a full
        cohort decodes at once; missing slots start the reveal phase (or
        shed below threshold). Caller holds _round_lock."""
        agg: TAAggregator = self.aggregator
        survivors = sorted(agg._round_slots)
        dead = [s for s in range(agg.worker_num) if s not in agg._round_slots]
        if not dead:
            agg.set_recovery(survivors, [], {})
            _perf.record_secagg_round("full")
            self._last_secagg = {"outcome": "full", "dead": []}
            super()._advance_round()
            return
        if len(survivors) < agg.secagg.recovery_min:
            self._shed_round(
                survivors, dead,
                f"{len(survivors)} survivors < recovery threshold "
                f"{agg.secagg.recovery_min}")
            return
        self._begin_recovery(survivors, dead)

    def _recover_in_flight(self, committed: int, replay) -> None:
        """Crash recovery x the secagg state machine: the base recovery
        ledgers the accepted masked uploads ``server_restart`` and re-runs
        the open round (a fresh boot holds no fold state, and clients
        re-mask for the re-run, so a half-revealed fold never survives a
        restart). If the WAL shows a reveal in flight, the dead slots it
        was recovering are ledgered ``secagg_shed`` — the live shed
        path's verdict — and the outcome metric counts a shed."""
        super()._recover_in_flight(committed, replay)
        if replay is None or self._resume_round is None:
            return
        reveals = replay.since_last_commit("secagg_reveal")
        if not reveals:
            return
        rec = reveals[-1]
        dead = [int(s) for s in rec.get("dead", [])]
        ids = self.aggregator.client_sampling(self.round_idx)
        for slot in dead:
            self.aggregator.quarantine.record(
                self.round_idx, slot + 1, "secagg_shed",
                client=int(ids[slot]))
            _obs.record_update_rejected("secagg_shed")
        _perf.record_secagg_round("shed")
        _perf.record_secagg_dropped(len(dead))
        self._last_secagg = {"outcome": "shed", "dead": dead}
        log.error("secagg round %d SHED (server crashed mid-reveal): "
                  "lost slots %s ledgered — the resume probe re-runs the "
                  "round clean", self.round_idx, dead)

    def _begin_recovery(self, survivors: list[int], dead: list[int]) -> None:
        agg: TAAggregator = self.aggregator
        agg._frozen = True
        self._phase = "recovery"
        if self.wal is not None:
            # journal the reveal fan-out (fsync'd): a crash from here to
            # the fold recovers as a SHED round, never a half-reveal
            self.wal.append("secagg_reveal", sync=True,
                            round=int(self.round_idx),
                            survivors=[int(s) for s in survivors],
                            dead=[int(d) for d in dead])
        self._maybe_crash("reveal")
        self._reveal = {"survivors": survivors, "dead": dead,
                        "seeds": {}, "t0": time.perf_counter()}
        self._reveal_retried = False
        log.warning("secagg round %d: slots %s dropped — asking %d "
                    "survivors to reveal their pairwise seeds",
                    self.round_idx, dead, len(survivors))
        self._send_reveal_requests(survivors, dead)

    def _send_reveal_requests(self, survivors, dead) -> None:
        """s2c_reveal to the listed survivors: deterministic frames (round
        + dead set), so the watchdog's retry re-sends byte-identical
        requests and the client cache answers them verbatim."""
        for slot in survivors:
            msg = Message(MyMessage.MSG_TYPE_S2C_REVEAL_REQUEST, self.rank,
                          slot + 1)
            msg.add_params(MyMessage.MSG_ARG_KEY_SECAGG_DEAD,
                           np.asarray(dead, np.int64))
            msg.add_params(MyMessage.MSG_ARG_KEY_ROUND, self.round_idx)
            self.send_message(msg)

    def handle_message_reveal_shares(self, msg_params):
        with self._round_lock:
            if self._phase != "recovery" or self._reveal is None:
                _obs.record_stale_upload("stale")
                return
            if int(msg_params.get(MyMessage.MSG_ARG_KEY_ROUND,
                                  self.round_idx)) != self.round_idx:
                _obs.record_stale_upload("stale")
                return
            slot = int(msg_params[Message.MSG_ARG_KEY_SENDER]) - 1
            rv = self._reveal
            if slot not in rv["survivors"] or slot in rv["seeds"]:
                return  # unknown or duplicate reveal: exactly-once fold
            dead = [int(d) for d in np.asarray(
                msg_params[MyMessage.MSG_ARG_KEY_SECAGG_DEAD])]
            seeds = np.asarray(
                msg_params[MyMessage.MSG_ARG_KEY_SECAGG_PAIR_SEEDS],
                np.int64)
            if dead != rv["dead"] or len(seeds) != len(dead):
                log.warning("secagg: reveal from slot %d names dead set "
                            "%s != %s — dropped", slot, dead, rv["dead"])
                return
            rv["seeds"][slot] = {j: int(s) for j, s in zip(dead, seeds)}
            if len(rv["seeds"]) < len(rv["survivors"]):
                return
            # every survivor revealed: strip, decode, and run the base
            # round advance (aggregate -> eval -> ckpt -> next broadcast)
            dt = time.perf_counter() - rv["t0"]
            agg: TAAggregator = self.aggregator
            agg.set_recovery(rv["survivors"], rv["dead"], rv["seeds"])
            _perf.record_secagg_round("recovered")
            _perf.record_secagg_recovery_seconds(dt)
            self._last_secagg = {"outcome": "recovered",
                                 "dead": list(rv["dead"]),
                                 "recovery_s": round(dt, 6)}
            self._phase, self._reveal = "uploads", None
            FedAvgServerManager._advance_round(self)

    def _shed_round(self, survivors: list[int], dead: list[int],
                    why: str) -> None:
        """Below-threshold / reveal-lost: ledger every lost slot, count the
        outcome, re-broadcast the SAME round (a recovered fleet
        re-converges). Caller holds _round_lock."""
        agg: TAAggregator = self.aggregator
        ids = agg.client_sampling(self.round_idx)
        for slot in dead:
            agg.quarantine.record(self.round_idx, slot + 1, "secagg_shed",
                                  client=int(ids[slot]))
            _obs.record_update_rejected("secagg_shed")
        _perf.record_secagg_round("shed")
        _perf.record_secagg_dropped(len(dead))
        log.error("secagg round %d SHED (%s): lost slots %s ledgered — "
                  "re-broadcasting the round", self.round_idx, why, dead)
        self._phase, self._reveal = "uploads", None
        self._last_secagg = {"outcome": "shed", "dead": list(dead)}
        # clear the elastic undeliverable marks (round_idx is not
        # advancing, so the reprobe cadence cannot fire) and re-broadcast;
        # _broadcast_model's begin_round resets the masked fold
        self._undeliverable.clear()
        self._update_alive_gauge()
        self._broadcast_model(MyMessage.MSG_TYPE_S2C_SYNC_MODEL_TO_CLIENT,
                              agg.get_global_model_params())

    def on_timeout(self, idle_s: float):
        with self._round_lock:
            if self._phase == "recovery" and not self._finished.is_set():
                rv = self._reveal or {"survivors": [], "dead": [],
                                      "seeds": {}}
                missing = [s for s in rv["survivors"]
                           if s not in rv["seeds"]]
                if missing and not self._reveal_retried:
                    # one deterministic retry before shedding: the backoff
                    # IS the watchdog cadence (first fire retries, second
                    # sheds), the frames are byte-identical, and the
                    # client cache retransmits the same seeds verbatim
                    self._reveal_retried = True
                    log.warning(
                        "secagg round %d: reveal frames missing from "
                        "slots %s after %.1fs — retrying once",
                        self.round_idx, missing, idle_s)
                    self._send_reveal_requests(missing, rv["dead"])
                    return
                self._shed_round(
                    rv["survivors"], rv["dead"],
                    f"reveal frames lost from slots {missing} after "
                    f"{idle_s:.1f}s (post-retry)")
                return
        super().on_timeout(idle_s)

    def _round_record_extra(self) -> dict:
        extra = super()._round_record_extra()
        if self._last_secagg is not None:
            extra["secagg"] = dict(self._last_secagg)
        return extra


class TASecureEdgeManager(FedAvgEdgeManager):
    """Edge rank of the hierarchical masked tier: folds its block's masked
    uploads mod p (the block's pair masks cancel HERE), runs the reveal
    recovery locally for in-block dead slots, and forwards ONE
    e2s_masked_agg frame carrying the unmasked int64 field partial.

    The edge watchdog arms at HALF the root deadline: in-block recovery,
    its one reveal retry included, resolves before the root's own timeout
    would shed the whole block. Below ``recovery_min`` block survivors (or
    a reveal lost past the retry) the edge sheds its OWN block: an empty
    partial whose dead list names every block slot. The fold and the
    unmask run on the edge's device."""

    def __init__(self, rank: int, topology, cfg: FedAvgConfig,
                 threshold_t=None, quant_scale=2**16,
                 defense_type: str = "none", norm_bound: float = 30.0,
                 secagg_max_abs: float = 4.0, backend: str = "LOOPBACK",
                 round_timeout_s: float | None = None, device=None, **kw):
        self.cfg = cfg
        self.secagg = _secagg_config(cfg, threshold_t, quant_scale,
                                     defense_type, norm_bound,
                                     secagg_max_abs)
        if self.secagg.recovery_min > topology.block:
            raise ValueError(
                f"secagg recovery needs >= {self.secagg.recovery_min} "
                f"survivors, but an edge block holds only "
                f"{topology.block} slots — edge-local reveal could never "
                "succeed; lower threshold_t or enlarge the block")
        super().__init__(rank, topology, backend=backend,
                         round_timeout_s=round_timeout_s, robust=False,
                         device=device, **kw)
        # masked block state (under self._lock; reset on every downlink)
        self._macc = None
        self._mslots: set[int] = set()
        self._mb_shares: dict[int, np.ndarray] = {}
        self._mextras: dict[int, list] = {}
        self._msamples: dict[int, float] = {}
        self._mreveal: dict | None = None

    def register_message_receive_handlers(self):
        super().register_message_receive_handlers()
        self.register_message_receive_handler(
            MyMessage.MSG_TYPE_C2S_REVEAL_SHARES,
            self.handle_message_reveal_shares)

    def _handle_downlink(self, msg_type: str, msg_params) -> None:
        with self._lock:
            self._macc = None
            self._mslots = set()
            self._mb_shares = {}
            self._mextras = {}
            self._msamples = {}
            self._mreveal = None
        super()._handle_downlink(msg_type, msg_params)

    def _handle_child_upload(self, msg_params) -> None:
        """Fold one worker's ``[masked, b_shares, *extras]`` upload, keyed
        by GLOBAL cohort slot so the forwarded frame needs no
        translation."""
        sender = int(msg_params[Message.MSG_ARG_KEY_SENDER])
        slot = self.topology.slot_of(sender)
        with self._lock:
            if self._round is None:
                return
            tag = msg_params.get(MyMessage.MSG_ARG_KEY_ROUND, self._round)
            if int(tag) != self._round:
                _obs.record_stale_upload("stale")
                log.warning("edge %d: drop stale masked upload from rank "
                            "%d (round %s, now %d)", self.edge_idx,
                            sender, tag, self._round)
                return
            if slot not in self._slots:
                _obs.record_stale_upload("unknown_rank")
                log.warning("edge %d: masked upload from rank %d outside "
                            "this block (slots %s)", self.edge_idx,
                            sender, self._slots)
                return
            if self._forwarded or slot in self._mslots:
                _obs.record_stale_upload("stale")
                return  # chaos duplicate / late: exactly-once folding
            if self._mreveal is not None:
                # recovery in flight: the block's survivor set is FIXED
                _obs.record_stale_upload("stale")
                log.warning("edge %d: dropping late upload from slot %d "
                            "— block mask recovery already in flight",
                            self.edge_idx, slot)
                return
            leaves = list(msg_params[MyMessage.MSG_ARG_KEY_MODEL_PARAMS])
            self._macc = sa.fold_masked_device(self._macc, leaves[0],
                                               self.secagg.p,
                                               device=self.device)
            self._mslots.add(slot)
            self._mb_shares[slot] = np.asarray(leaves[1], np.int64)
            self._mextras[slot] = list(leaves[2:])
            self._msamples[slot] = float(
                msg_params[MyMessage.MSG_ARG_KEY_NUM_SAMPLES])
            if len(self._mslots) == len(self._slots):
                self._finish_block()

    # ------------------------------------------------------ block recovery
    def _finish_block(self) -> None:
        """Full block -> unmask and forward; dead slots -> edge-local
        reveal (or shed below threshold). Caller holds _lock."""
        survivors = sorted(self._mslots)
        dead = [s for s in self._slots if s not in self._mslots]
        if not dead:
            field = self._unmask_block(survivors, [], {})
            self._send_masked_frame(field, survivors, [], "full", None)
            return
        if len(survivors) < self.secagg.recovery_min:
            self._shed_block(
                f"{len(survivors)} block survivors < recovery threshold "
                f"{self.secagg.recovery_min}")
            return
        self._begin_block_recovery(survivors, dead)

    def _unmask_block(self, survivors, dead, reveals) -> torch.Tensor:
        """Strip the block's masks, staying in GF(p): self-mask seeds from
        the BLOCK survivors' share entries, orphaned pairs from the
        reveals (every pair of a block-scoped upload is in-block). Caller
        holds _lock."""
        self_seeds = {
            i: sa.recover_self_seed(
                survivors, self._mb_shares[i][survivors],
                self.secagg.threshold_t, self.secagg.p)
            for i in survivors}
        return sa.unmask_partial(self._macc, survivors, dead, self_seeds,
                                 reveals, self.secagg)

    def _begin_block_recovery(self, survivors, dead) -> None:
        self._mreveal = {"survivors": list(survivors), "dead": list(dead),
                         "seeds": {}, "t0": time.perf_counter(),
                         "retried": False}
        log.warning("edge %d round %d: block slots %s dropped — asking "
                    "%d block survivors to reveal their pairwise seeds",
                    self.edge_idx, self._round, dead, len(survivors))
        self._send_block_reveals(survivors, dead)

    def _send_block_reveals(self, survivors, dead) -> None:
        """s2c_reveal to the listed block survivors' worker ranks, naming
        GLOBAL dead slot ids — byte-identical on retry."""
        for slot in survivors:
            msg = Message(MyMessage.MSG_TYPE_S2C_REVEAL_REQUEST, self.rank,
                          self.topology.worker_rank(slot))
            msg.add_params(MyMessage.MSG_ARG_KEY_SECAGG_DEAD,
                           np.asarray(dead, np.int64))
            msg.add_params(MyMessage.MSG_ARG_KEY_ROUND, self._round)
            self.send_message(msg)

    def handle_message_reveal_shares(self, msg_params) -> None:
        with self._lock:
            rv = self._mreveal
            if rv is None or self._forwarded:
                _obs.record_stale_upload("stale")
                return
            if int(msg_params.get(MyMessage.MSG_ARG_KEY_ROUND,
                                  self._round)) != self._round:
                _obs.record_stale_upload("stale")
                return
            slot = self.topology.slot_of(
                int(msg_params[Message.MSG_ARG_KEY_SENDER]))
            if slot not in rv["survivors"] or slot in rv["seeds"]:
                return  # unknown or duplicate reveal: exactly-once fold
            dead = [int(d) for d in np.asarray(
                msg_params[MyMessage.MSG_ARG_KEY_SECAGG_DEAD])]
            seeds = np.asarray(
                msg_params[MyMessage.MSG_ARG_KEY_SECAGG_PAIR_SEEDS],
                np.int64)
            if dead != rv["dead"] or len(seeds) != len(dead):
                log.warning("edge %d: reveal from slot %d names dead set "
                            "%s != %s — dropped", self.edge_idx, slot,
                            dead, rv["dead"])
                return
            rv["seeds"][slot] = {j: int(s) for j, s in zip(dead, seeds)}
            if len(rv["seeds"]) < len(rv["survivors"]):
                return
            dt = time.perf_counter() - rv["t0"]
            field = self._unmask_block(rv["survivors"], rv["dead"],
                                       rv["seeds"])
            self._mreveal = None
            self._send_masked_frame(field, rv["survivors"], rv["dead"],
                                    "recovered", dt)

    def _shed_block(self, why: str) -> None:
        """Below-threshold / reveal-lost: forward an EMPTY partial whose
        dead list names every block slot — the root sheds exactly this
        block and the other blocks' round proceeds. Caller holds
        _lock."""
        log.error("edge %d round %d block SHED (%s): forwarding an empty "
                  "partial — the root ledgers slots %s secagg_shed",
                  self.edge_idx, self._round, why, list(self._slots))
        self._mreveal = None
        self._send_masked_frame(None, [], list(self._slots), "shed", None)

    def _send_masked_frame(self, field, survivors, dead, outcome,
                           recovery_s) -> None:
        """The ONE per-round uplink: the unmasked field partial, the
        block's survivor/dead slots, sample counts, plaintext extras, and
        how the block decoded. The extras (EDGE_EXTRAS) are one empty list
        a survivor for a model with none, the reference's frame, and for
        a model with extras ONE flat list of their wire leaves, survivor
        by survivor in slot order: a frame carries a list of arrays, not a
        list of lists of them. Caller holds _lock."""
        msg = Message(MyMessage.MSG_TYPE_E2S_SEND_MASKED_AGG_TO_SERVER,
                      self.rank, 0)
        msg.add_params(MyMessage.MSG_ARG_KEY_EDGE_FIELD_SUM,
                       np.zeros(0, np.int64) if field is None
                       else field.cpu().numpy())
        msg.add_params(MyMessage.MSG_ARG_KEY_EDGE_SURVIVORS,
                       [int(s) for s in survivors])
        msg.add_params(MyMessage.MSG_ARG_KEY_EDGE_DEAD,
                       [int(d) for d in dead])
        msg.add_params(MyMessage.MSG_ARG_KEY_EDGE_SLOT_SAMPLES,
                       [float(self._msamples[s]) for s in survivors])
        extras = [self._mextras[s] for s in survivors]
        if any(extras):
            # a model with extras: one flat list of wire leaves (a frame
            # carries a list of arrays, not a list of lists of them)
            extras = [leaf for ex in extras for leaf in ex]
        msg.add_params(MyMessage.MSG_ARG_KEY_EDGE_EXTRAS, extras)
        msg.add_params(MyMessage.MSG_ARG_KEY_SECAGG_OUTCOME, str(outcome))
        if recovery_s is not None:
            msg.add_params(MyMessage.MSG_ARG_KEY_SECAGG_RECOVERY_S,
                           float(recovery_s))
        msg.add_params(MyMessage.MSG_ARG_KEY_ROUND, self._round)
        self._forwarded = True
        self.send_message(msg)

    def on_timeout(self, idle_s: float) -> None:
        """Tiered recovery clock: uploads stalled -> the block decision
        (reveal or shed); a reveal stalled -> one deterministic retry, then
        shed. A block with NO uploads waits — the root watchdog owns that
        recovery."""
        with self._lock:
            if (self._round is None or self._forwarded
                    or self.round_timeout_s is None):
                return
            rv = self._mreveal
            if rv is not None:
                missing = [s for s in rv["survivors"]
                           if s not in rv["seeds"]]
                if missing and not rv["retried"]:
                    rv["retried"] = True
                    log.warning("edge %d round %d: reveal frames missing "
                                "from slots %s after %.1fs — retrying "
                                "once", self.edge_idx, self._round,
                                missing, idle_s)
                    self._send_block_reveals(missing, rv["dead"])
                    return
                self._shed_block(f"reveal frames lost from slots "
                                 f"{missing} after {idle_s:.1f}s "
                                 "(post-retry)")
                return
            if not self._mslots:
                log.error("edge %d: round %s stalled %.1fs with no masked "
                          "uploads — waiting (root watchdog owns "
                          "recovery)", self.edge_idx, self._round, idle_s)
                return
            self._finish_block()


class HierTAAggregator(TAAggregator):
    """Root-side aggregator of the hierarchical masked tier: slots are
    EDGES (the barrier counts E frames), the fold state stays keyed by
    GLOBAL cohort slot, each edge's unmasked field partial is one more add
    mod p, and ``aggregate`` decodes ONCE over the union of surviving
    slots — bitwise the flat masked aggregate."""

    def __init__(self, dataset, task, cfg: FedAvgConfig, topology,
                 threshold_t=None, quant_scale=2**16,
                 defense_type: str = "none", norm_bound: float = 30.0,
                 noise_multiplier: float = 1.0,
                 secagg_max_abs: float = 4.0, device=None):
        if cfg.client_num_per_round != topology.workers:
            raise ValueError(
                f"client_num_per_round={cfg.client_num_per_round} != "
                f"topology workers={topology.workers}")
        super().__init__(dataset, task, cfg, worker_num=topology.edges,
                         threshold_t=threshold_t, quant_scale=quant_scale,
                         defense_type=defense_type, norm_bound=norm_bound,
                         noise_multiplier=noise_multiplier,
                         secagg_max_abs=secagg_max_abs, device=device)
        self.topology = topology
        if self.secagg.recovery_min > topology.block:
            raise ValueError(
                f"secagg recovery needs >= {self.secagg.recovery_min} "
                f"survivors, but an edge block holds only "
                f"{topology.block} slots — edge-local reveal could never "
                "succeed; lower threshold_t or enlarge the block")
        self.fanin_history: list[int] = []
        # edge idx -> {survivors, dead, outcome, recovery_s}: the round's
        # secagg record and the tiered ledger attribution
        self._edge_frames: dict[int, dict] = {}

    def begin_round(self, round_idx: int) -> None:
        super().begin_round(round_idx)
        self._edge_frames = {}

    def add_edge_masked_result(self, edge_idx: int, field_sum, survivors,
                               dead, slot_samples, extras, outcome: str,
                               recovery_s=None,
                               round_idx: int | None = None) -> None:
        """Slot one edge's e2s_masked_agg frame: fold the unmasked field
        partial mod p and stage the block's per-slot samples and extras
        under their GLOBAL slot ids (``extras`` nested, one list a
        survivor, or flat, every survivor's leaves in turn: the two forms
        ``TASecureEdgeManager._send_masked_frame`` sends). Stale, unknown
        and duplicate frames are rejected and counted as on the
        per-worker path."""
        edge_idx = int(edge_idx)
        if edge_idx not in self.flag_client_model_uploaded:
            _obs.record_stale_upload("unknown_rank")
            log.warning("reject masked partial for unknown edge index %s "
                        "(edges 0..%d)", edge_idx, self.worker_num - 1)
            return
        if round_idx is not None and int(round_idx) != self.current_round:
            _obs.record_stale_upload("stale")
            log.warning("reject out-of-round masked partial from edge %s "
                        "(tagged round %s, current %d)", edge_idx,
                        round_idx, self.current_round)
            return
        if self.flag_client_model_uploaded.get(edge_idx):
            _obs.record_stale_upload("stale")
            log.warning("drop duplicate masked partial from edge %s",
                        edge_idx)
            return
        survivors = [int(s) for s in survivors]
        extras = list(extras)
        if survivors and extras and not isinstance(extras[0], (list, tuple)):
            # the flat form: each survivor's extras leaves in turn
            n = len(extras) // len(survivors)
            extras = [extras[i * n:(i + 1) * n]
                      for i in range(len(survivors))]
        if survivors:
            self._acc = sa.fold_masked_device(self._acc, field_sum,
                                              self.secagg.p,
                                              device=self.device)
            for s, n, ex in zip(survivors, slot_samples, extras):
                self._round_slots.add(s)
                self.sample_num_dict[s] = float(n)
                self._extras[s] = list(ex)
        self._edge_frames[edge_idx] = {
            "survivors": survivors, "dead": [int(d) for d in dead],
            "outcome": str(outcome),
            "recovery_s": None if recovery_s is None else float(recovery_s)}
        self.flag_client_model_uploaded[edge_idx] = True

    def aggregate(self):
        """Ledger the tiered outcomes (a missing or shed edge's whole
        block -> secagg_shed; an edge-recovered block's dead slots ->
        secagg_dropout: the flat tier's verdicts for the same fates), then
        decode the folded partials ONCE and run the shared tail."""
        t0 = time.perf_counter()
        ids = self.client_sampling(self.current_round)
        missing = [e for e in range(self.topology.edges)
                   if e not in self._edge_frames]
        shed_slots: list[int] = []
        drop_slots: list[int] = []
        for e in missing:
            shed_slots.extend(self.topology.slots_of_edge(e))
        for fr in self._edge_frames.values():
            (shed_slots if fr["outcome"] == "shed"
             else drop_slots).extend(fr["dead"])
        for s in sorted(shed_slots):
            self.quarantine.record(self.current_round, s + 1,
                                   "secagg_shed", client=int(ids[s]))
            _obs.record_update_rejected("secagg_shed")
        for s in sorted(drop_slots):
            self.quarantine.record(self.current_round, s + 1,
                                   "secagg_dropout", client=int(ids[s]))
            _obs.record_update_rejected("secagg_dropout")
        if shed_slots or drop_slots:
            _perf.record_secagg_dropped(len(shed_slots) + len(drop_slots))
        if missing:
            log.warning("hier secagg round %d: edge frame(s) %s lost — "
                        "their blocks shed (ledgered secagg_shed)",
                        self.current_round, missing)
        self.fanin_history.append(len(self._edge_frames))
        survivors = sorted(self._round_slots)
        if not survivors:
            log.warning("hier secagg round %d: every block lost — "
                        "keeping the current global model",
                        self.current_round)
            self._acc, self._recovery = None, None
            self._round_slots, self._b_shares, self._extras = set(), {}, {}
            self.sample_num_dict.clear()
            return pack_pytree(self.net, self.num_heads)
        vec_sum = sa.field_decode_sum(self._acc, self.secagg)
        return self._finish_aggregate(vec_sum, survivors, t0)


class HierTASecureServerManager(FedAvgServerManager):
    """Root manager of the hierarchical masked tier: broadcasts one frame
    per EDGE, advances on E e2s_masked_agg frames. The tiered recovery
    lives at the edges; the root's only dropout duty is the base elastic
    watchdog, whose partial advance sheds a lost edge's block."""

    def __init__(self, aggregator: HierTAAggregator, topology=None, **kw):
        if not isinstance(aggregator, HierTAAggregator):
            raise TypeError("HierTASecureServerManager needs a "
                            "HierTAAggregator")
        self.topology = topology or aggregator.topology
        for flag, name in ((kw.get("async_buffer_k"), "async_buffer_k"),
                           (kw.get("delta_broadcast"), "delta_broadcast"),
                           (kw.get("heartbeat_max_age_s"),
                            "heartbeat_max_age_s")):
            if flag:
                raise ValueError(
                    f"{name} is not wired through the masked edge tier — "
                    "run the flat topology for that mode")
        super().__init__(aggregator, **kw)
        if not hasattr(self, "_last_secagg"):
            self._last_secagg: dict | None = None

    def _validate_world_size(self, size: int) -> None:
        if size != self.topology.world_size:
            raise ValueError(
                f"world size {size} != 1 + {self.topology.edges} edges + "
                f"{self.topology.workers} workers")

    def register_message_receive_handlers(self):
        super().register_message_receive_handlers()
        self.register_message_receive_handler(
            MyMessage.MSG_TYPE_E2S_SEND_MASKED_AGG_TO_SERVER,
            self.handle_message_masked_partial)

    def _broadcast_model(self, msg_type: str, global_params) -> None:
        """One frame per EDGE (fan-out O(edges)): the model, the edge
        block's client assignments and the round, with the flat
        broadcast's crash points and journal record."""
        self._maybe_crash("broadcast")
        self._goodput_round_start()
        if self.wal is not None:
            self.wal.append("broadcast", sync=True, round=self.round_idx)
        self._uploads_this_round = 0
        topo = self.topology
        client_indexes = self.aggregator.client_sampling(self.round_idx)
        self._round_ids = [int(c) for c in client_indexes]
        self.aggregator.begin_round(self.round_idx)
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
        self._maybe_crash("post_broadcast")

    def handle_message_masked_partial(self, msg_params) -> None:
        with self._round_lock:
            sender = int(msg_params[Message.MSG_ARG_KEY_SENDER])
            msg_round = int(msg_params.get(MyMessage.MSG_ARG_KEY_ROUND,
                                           self.round_idx))
            if msg_round != self.round_idx:
                _obs.record_stale_upload("stale")
                log.warning("drop stale masked partial from rank %d "
                            "(round %s, now %d)", sender, msg_round,
                            self.round_idx)
                return
            if self.telemetry is not None:
                self._gp_last_arrival_t = time.monotonic()
            if self._dtracer is not None:
                self._dtracer.on_upload(sender, msg_params.get(TRACE_KEY))
            agg: HierTAAggregator = self.aggregator
            already = bool(agg.flag_client_model_uploaded.get(sender - 1))
            rs = msg_params.get(MyMessage.MSG_ARG_KEY_SECAGG_RECOVERY_S)
            agg.add_edge_masked_result(
                sender - 1,
                msg_params[MyMessage.MSG_ARG_KEY_EDGE_FIELD_SUM],
                msg_params[MyMessage.MSG_ARG_KEY_EDGE_SURVIVORS],
                msg_params[MyMessage.MSG_ARG_KEY_EDGE_DEAD],
                msg_params[MyMessage.MSG_ARG_KEY_EDGE_SLOT_SAMPLES],
                msg_params[MyMessage.MSG_ARG_KEY_EDGE_EXTRAS],
                str(msg_params[MyMessage.MSG_ARG_KEY_SECAGG_OUTCOME]),
                recovery_s=None if rs is None else float(rs),
                round_idx=msg_round)
            if not already and agg.flag_client_model_uploaded.get(
                    sender - 1):
                # the accepted partial is this tier's upload: journaled so
                # a root crash before the commit ledgers it server_restart
                self._uploads_this_round += 1
                if self.wal is not None:
                    self.wal.append("upload", sync=True, round=msg_round,
                                    rank=sender)
                self._maybe_crash("upload")
            if agg.check_whether_all_receive():
                self._advance_round()

    def _advance_round(self):
        """Fix the round's secagg verdict from the edge frames BEFORE the
        base advance consumes them: a missing or shed block makes the round
        a shed; recovered blocks alone make it recovered. Caller holds
        _round_lock."""
        agg: HierTAAggregator = self.aggregator
        frames = agg._edge_frames
        missing = [e for e in range(self.topology.edges)
                   if e not in frames]
        dead = sorted(
            {s for e in missing for s in self.topology.slots_of_edge(e)}
            | {int(d) for fr in frames.values() for d in fr["dead"]})
        outcomes = [fr["outcome"] for fr in frames.values()]
        if missing or "shed" in outcomes:
            outcome = "shed"
        elif dead:
            outcome = "recovered"
        else:
            outcome = "full"
        _perf.record_secagg_round(outcome)
        self._last_secagg = {"outcome": outcome, "dead": dead}
        rts = [fr["recovery_s"] for fr in frames.values()
               if fr["recovery_s"] is not None]
        if rts:
            self._last_secagg["recovery_s"] = round(max(rts), 6)
            _perf.record_secagg_recovery_seconds(max(rts))
        super()._advance_round()

    def _round_record_extra(self) -> dict:
        extra = super()._round_record_extra()
        hist = self.aggregator.fanin_history
        extra["hier"] = {"edges": self.topology.edges,
                         "block": self.topology.block,
                         "fan_in": hist[-1] if hist else 0}
        if self._last_secagg is not None:
            extra["secagg"] = dict(self._last_secagg)
        return extra


def run_simulated(dataset, task, cfg: FedAvgConfig, backend="LOOPBACK",
                  job_id="turboagg-sim", base_port=50000, threshold_t=None,
                  quant_scale=2**16, defense_type: str = "none",
                  norm_bound: float = 30.0, noise_multiplier: float = 1.0,
                  secagg_max_abs: float = 4.0, chaos_plan=None,
                  round_timeout_s: float | None = None, telemetry=None,
                  ckpt_dir: str | None = None,
                  edges: int | None = None,
                  broker_host: str = "127.0.0.1", broker_port: int = 1883,
                  device=None):
    """All ranks as threads (mpirun-on-localhost); returns the server's
    aggregator (``.net``, ``.history``, ``.quarantine``). ``chaos_plan`` +
    ``round_timeout_s`` arm the dropout-recovery scenario; a crash rule
    naming rank 0 (it needs ``ckpt_dir``; ``after_uploads=-1`` dies at the
    reveal fan-out) runs under the supervision loop.
    ``defense_type='dp'`` runs accounted DP on the masked path;
    ``edges=E`` the hierarchical masked tier (bitwise the flat run).
    Every rank runs on ``device`` (the CUDA device when None)."""
    if edges:
        return _run_simulated_tree(
            dataset, task, cfg, backend, job_id, base_port, threshold_t,
            quant_scale, defense_type, norm_bound, noise_multiplier,
            secagg_max_abs, chaos_plan, round_timeout_s, telemetry,
            ckpt_dir, int(edges), broker_host, broker_port, device)
    from fedml_tpu_torch import chaos as _chaos

    size = cfg.client_num_per_round + 1
    kw = backend_kwargs(backend, job_id, base_port, broker_host, broker_port)
    if chaos_plan is not None:  # None must not clobber an installed plan
        _chaos.install_plan(chaos_plan)
    try:
        crash_points = server_crash_points(ckpt_dir)

        def build_server():
            agg = TAAggregator(
                dataset, task, cfg, worker_num=size - 1,
                threshold_t=threshold_t, quant_scale=quant_scale,
                defense_type=defense_type, norm_bound=norm_bound,
                noise_multiplier=noise_multiplier,
                secagg_max_abs=secagg_max_abs, device=device)
            return TASecureServerManager(
                agg, rank=0, size=size, backend=backend,
                round_timeout_s=round_timeout_s, telemetry=telemetry,
                ckpt_dir=ckpt_dir, **kw)

        server = build_server()
        clients = []
        for r in range(1, size):
            trainer = SecureTrainer(
                r, dataset, task, cfg, threshold_t=threshold_t,
                quant_scale=quant_scale, defense_type=defense_type,
                norm_bound=norm_bound, secagg_max_abs=secagg_max_abs,
                device=device)
            clients.append(TASecureClientManager(
                trainer, rank=r, size=size, backend=backend, **kw))
        if crash_points:
            server = run_supervised_simulated(server, clients,
                                              crash_points, build_server)
        else:
            launch_simulated(server, clients)
    finally:
        if chaos_plan is not None:
            _chaos.install_plan(None)
    return server.aggregator


def _run_simulated_tree(dataset, task, cfg: FedAvgConfig, backend, job_id,
                        base_port, threshold_t, quant_scale, defense_type,
                        norm_bound, noise_multiplier, secagg_max_abs,
                        chaos_plan, round_timeout_s, telemetry, ckpt_dir,
                        edges: int, broker_host, broker_port, device):
    """The 2-tier masked runtime: 1 root + E edges + W workers as threads.
    Workers mask against their edge block's peers (global slot ids);
    cohort, slot and client assignments coincide with the flat runtime
    round for round, so tree ≡ flat is bitwise (model and ledger)."""
    from fedml_tpu_torch import chaos as _chaos

    topo = EdgeTopology(edges=edges, workers=cfg.client_num_per_round)
    kw = backend_kwargs(backend, job_id, base_port, broker_host, broker_port)
    if chaos_plan is not None:
        _chaos.install_plan(chaos_plan)
    try:
        crash_points = server_crash_points(ckpt_dir)

        def build_server():
            agg = HierTAAggregator(
                dataset, task, cfg, topo, threshold_t=threshold_t,
                quant_scale=quant_scale, defense_type=defense_type,
                norm_bound=norm_bound, noise_multiplier=noise_multiplier,
                secagg_max_abs=secagg_max_abs, device=device)
            return HierTASecureServerManager(
                agg, rank=0, size=topo.world_size, backend=backend,
                round_timeout_s=round_timeout_s, telemetry=telemetry,
                ckpt_dir=ckpt_dir, **kw)

        server = build_server()
        # edge watchdogs at HALF the root deadline (in-block reveal
        # recovery, its one retry included, resolves before the root's
        # own timeout sheds the whole block)
        edge_timeout = (round_timeout_s / 2.0
                        if round_timeout_s is not None else None)
        peers = [
            TASecureEdgeManager(
                topo.edge_rank(e), topo, cfg, threshold_t=threshold_t,
                quant_scale=quant_scale, defense_type=defense_type,
                norm_bound=norm_bound, secagg_max_abs=secagg_max_abs,
                backend=backend, round_timeout_s=edge_timeout,
                device=device, **kw)
            for e in range(topo.edges)
        ]
        for slot in range(topo.workers):
            rank = topo.worker_rank(slot)
            trainer = SecureTrainer(
                rank, dataset, task, cfg, threshold_t=threshold_t,
                quant_scale=quant_scale, defense_type=defense_type,
                norm_bound=norm_bound, secagg_max_abs=secagg_max_abs,
                slot=slot,
                peers=list(topo.slots_of_edge(topo.edge_of_slot(slot))),
                device=device)
            peers.append(TASecureClientManager(
                trainer, rank=rank, size=topo.world_size, backend=backend,
                server_rank=topo.edge_rank(topo.edge_of_slot(slot)), **kw))
        if crash_points:
            server = run_supervised_simulated(server, peers, crash_points,
                                              build_server)
        else:
            launch_simulated(server, peers)
    finally:
        if chaos_plan is not None:
            _chaos.install_plan(None)
    return server.aggregator
