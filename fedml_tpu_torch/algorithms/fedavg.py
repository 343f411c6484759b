"""FedAvg on one GPU, port of fedml_tpu/algorithms/fedavg.py (``mesh=None``).

Reference behavior (fedml_api/standalone/fedavg/fedavg_api.py:40-115):
per round, sample clients -> each client runs local SGD from the global
weights -> the server takes the sample-weighted average of the returned
weights -> periodic eval (the global test set, or every client's own split).

As in the JAX engine, the cohort's local fits are ONE fit batched over the
clients (core/local.py: ``torch.func.vmap`` of a pure per-client step).
With ``device_data=True`` the train set is parked on the card once and a
round ships only its shuffled index block (core/client_data.IndexBatch);
the rows are gathered on the device, as the reference's block mode does.
``precision="f32"`` holds on the card whatever the process's TF32 flags
say: the engine switches TF32 off around its fits and evals
(``float32_compute``).

Every round times its host phases on ``self.tracer`` (obs/tracing
``RoundTracer``): ``pack`` (sampling, packing, the copy or the device
gather), ``round`` (dispatching the fit and the aggregate; the card runs
on after it), ``eval``. A ``telemetry`` bundle adds one record a round
(clients, spans, the summed metrics and ``round_stats``, comm bytes, and a
DP engine's ``privacy`` block, the ``agg`` server-plane block, the
``pack`` block — batch depth, padding share and packed bytes — and the
``goodput`` block: the wall split into exclusive duty buckets, FLOPs/s and
MFU, obs/goodput.py) and feeds the spans to its tracer. Its one sync is
the wait for the card on the round's outputs before they are floated
(goodput's ``compute`` bucket); the round's FLOP count is taken once per
variant (utils/flops.py). With telemetry off nothing syncs, nothing is
counted and nothing is added to the round.

The key chain is the JAX engine's (utils/prng, host words): ``self.rng``
starts at ``PRNGKey(seed)``, is split once for the init (the port draws
its weights from its own generator, but the chain must match), then each
round splits off a key and splits that three ways into (rng, kh, kp):
``kh`` keys the per-client ``client_result_hook(net_k, net_global, key)``
(vmapped over the cohort, ``split(kh, K)``), ``kp`` the
``post_aggregate_hook(net, key)`` that ``_update_from_aggregate`` applies,
the one server-side composition the round and the async flush share.
DP-FedAvg rides these hooks (algorithms/fedavg_robust.py), and so its
noise is the JAX package's own draw.

Byzantine robustness (core/robust_agg.py, chaos/adversary.py):
``aggregator`` swaps the weighted mean for a robust estimator behind the
sanitation gate (``sanitize``), and ``adversary_plan`` perturbs the
stacked client nets right after the batched fit, slot ``i`` playing worker
rank ``i + 1``. An armed round reads its ``[K]`` reason codes back into
``self.quarantine`` (one sync a round); with all four options at their
defaults the round runs the ops it ran before they existed.

A ``cfg.churn_trace`` (chaos/churn.py) restricts each round's draw to the
trace's available clients, so the cohort, and the batched fit's K, vary
by round. ``run_async`` drives buffered-async updates on a virtual clock
(core/async_buffer.VirtualClockAsyncRunner).

The rest of the reference's per-round driver (bench.py's headline):

- ``bucket_batches`` shrinks each round's batch depth to the smallest rung
  of the ladder ``{ceil(B/d) for d in (8, 4, 2, 1)}`` that covers the
  sampled cohort. A trailing all-masked batch is an exact no-op of the fit
  (core/local.py), so a bucketed round is bitwise the unbucketed one and
  skips the padding's steps.
- ``prefetch`` > 0 arms the pipelined driver (``run_pipelined``, and
  ``train``): a packer thread (core/pipeline.Prefetcher) samples, packs
  and copies round r+1's batch while round r runs; on a CUDA device the
  copy runs on the packer's own stream from pinned buffers, and the
  compute stream waits on the copy's event. Round outputs drain
  ``drain_lag`` rounds behind dispatch (core/pipeline.InflightRing), in
  round order, so ledgers and records equal the synchronous driver's.
- ``warmup`` runs the fit once per bucket depth on an all-masked batch,
  the eager counterpart of the reference's AOT compile pass.
- ``precision='bf16'`` arms the client-compute policy (core/local.py).
- A ``core/client_source.ClientDataSource`` dataset streams the sampled
  cohort's rows from its reader; the device-resident plane refuses one.

Mesh/SPMD round loops and the other engine options are queued in
ROADMAP.md (queue A); passing one raises.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import threading
import time

import numpy as np
import torch

from fedml_tpu_torch.core import optim
from fedml_tpu_torch.core.client_data import (
    ClientBatch,
    FederatedData,
    IndexBatch,
    batch_global,
    pack_client_indices,
    pack_clients,
    pad_batches,
    pad_index_batches,
)
from fedml_tpu_torch.core.client_source import (
    ClientDataSource,
    pack_clients_source,
)
from fedml_tpu_torch.core.pipeline import InflightRing, Prefetcher
from fedml_tpu_torch.core.robust_agg import (
    DEFAULT_NORM_MULT,
    QuarantineLedger,
    gated_aggregate,
    make_robust_aggregator,
)
from fedml_tpu_torch.core.local import (
    COMPUTE_DTYPES,
    LocalSpec,
    Task,
    make_cohort_eval_fn,
    make_eval_fn,
    make_local_update,
)
from fedml_tpu_torch.core.sampling import prepare_sampling, sample_for
from fedml_tpu_torch.device import resolve_device
from fedml_tpu_torch.obs import goodput as _goodput
from fedml_tpu_torch.obs import perf_instrument as _perf
from fedml_tpu_torch.obs.tracing import RoundTracer
from fedml_tpu_torch.utils import prng
from fedml_tpu_torch.utils.tree import tree_weighted_mean

log = logging.getLogger("fedml_tpu_torch.fedavg")


def _tree_bytes(tree: dict) -> int:
    """Bytes of a state dict's tensors."""
    return sum(v.numel() * v.element_size() for v in tree.values())


def agg_weights(nsamp: torch.Tensor, uniform: bool) -> torch.Tensor:
    """Aggregation weights: sample counts (FedAvg default) or, with
    ``uniform``, 1 per participating client / 0 for zero-sample padding."""
    if not uniform:
        return nsamp
    return (nsamp > 0).to(nsamp.dtype)


def _sq_norm(tree: dict) -> torch.Tensor:
    """Global squared L2 norm of a state dict (a device scalar)."""
    return sum(((v * v).sum() for v in tree.values()),
               torch.zeros((), device=next(iter(tree.values())).device))


def _client_drift(nets: dict, avg: dict, nsamp: torch.Tensor):
    """[K] per-client ||net_k - avg|| plus the real-client mask
    (zero-sample padding excluded)."""
    drift_sq = sum(((s - avg[k]) ** 2).flatten(1).sum(1)
                   for k, s in nets.items())
    return drift_sq.sqrt(), (nsamp > 0).to(drift_sq.dtype)


def round_stats(old_net: dict, new_net: dict, nets: dict, avg: dict,
                nsamp: torch.Tensor) -> dict:
    """Telemetry round stats as device scalars (no host read here; they
    ride out with the round's metrics):

    - ``update_norm``: ||new - old|| over params — the aggregate step size
      the server applied;
    - ``client_drift_mean``/``client_drift_max``: per-client ||net_k - avg||
      over the round's REAL clients (zero-sample padding excluded) — the
      non-IID dispersion statistic FedProx/FedNova papers reason about.
    """
    out = {"update_norm": _sq_norm(
        {k: new_net[k] - old_net[k] for k in new_net}).sqrt()}
    drift, real = _client_drift(nets, avg, nsamp)
    out["client_drift_mean"] = (drift * real).sum() / real.sum().clamp_min(1.0)
    out["client_drift_max"] = (drift * real).max()
    return out


class _Float32Policy:
    """The process's float32 flags, held by reference count: the flags are
    process-global, and fits and evals run on several threads at once (the
    cross-process runtime's ranks as threads), so the first entrant saves
    the caller's flags and switches TF32 off, and the last one out puts
    them back. Per-entrant save/restore would let the first thread to
    leave re-enable TF32 under the others, and a thread entering second
    would save the first one's "off" state and restore it for good."""

    def __init__(self):
        self._lock = threading.Lock()
        self._users = 0
        self._saved = None  # (matmul precision, entered cudnn.flags)

    @contextlib.contextmanager
    def __call__(self):
        with self._lock:
            if self._users == 0:
                cudnn = torch.backends.cudnn
                flags = cudnn.flags(enabled=cudnn.enabled,
                                    benchmark=cudnn.benchmark,
                                    deterministic=cudnn.deterministic,
                                    allow_tf32=False)
                self._saved = (torch.get_float32_matmul_precision(), flags)
                flags.__enter__()
                torch.set_float32_matmul_precision("highest")
            self._users += 1
        try:
            yield
        finally:
            with self._lock:
                self._users -= 1
                if self._users == 0:
                    precision, flags = self._saved
                    self._saved = None
                    torch.set_float32_matmul_precision(precision)
                    flags.__exit__(None, None, None)


#: float32 on the card, whatever the process's flags: cuDNN convolutions
#: without TF32 (PyTorch's default lets them take TF32) and matmul
#: precision "highest"; the caller's settings come back when the last
#: thread inside leaves (see _Float32Policy).
float32_compute = _Float32Policy()


def _gather_rows(dev_x, dev_y, idx, mask):
    """Row gather of the device-resident plane: padded slots carry index 0,
    so their rows are zeroed to match the host packer's zero padding."""
    flat = idx.reshape(-1)
    x = dev_x.index_select(0, flat).reshape(idx.shape + dev_x.shape[1:])
    y = dev_y.index_select(0, flat).reshape(idx.shape + dev_y.shape[1:])
    keep = lambda a: (mask > 0).reshape(mask.shape + (1,) * (a.ndim - mask.ndim))
    return (torch.where(keep(x), x, torch.zeros_like(x)),
            torch.where(keep(y), y, torch.zeros_like(y)))


def eval_subset(tx, ty, cfg: "FedAvgConfig", call_idx: int):
    """Apply the eval_max_samples subset policy (see FedAvgConfig).
    ``call_idx`` only matters in 'fresh' mode, where each eval resamples
    (reference FedAVGAggregator.py:99-107)."""
    if cfg.eval_max_samples is None or len(tx) <= cfg.eval_max_samples:
        return tx, ty
    if cfg.eval_subset_mode == "fresh":
        rs = np.random.RandomState((cfg.seed * 1_000_003 + call_idx) & 0x7FFFFFFF)
    elif cfg.eval_subset_mode == "fixed":
        rs = np.random.RandomState(cfg.seed)
    else:
        raise ValueError(f"eval_subset_mode={cfg.eval_subset_mode!r} "
                         "(expected 'fixed' or 'fresh')")
    sel = rs.choice(len(tx), cfg.eval_max_samples, replace=False)
    return tx[sel], ty[sel]


@dataclasses.dataclass(frozen=True)
class FedAvgConfig:
    """Flag surface parity with the reference argparse and with
    fedml_tpu's FedAvgConfig (same fields, same defaults). FedAvgAPI
    raises on the values this slice does not run."""

    comm_round: int = 10
    client_num_in_total: int = 10
    client_num_per_round: int = 10
    epochs: int = 1
    batch_size: int = 32
    client_optimizer: str = "sgd"  # 'sgd' | 'adam'
    lr: float = 0.03
    wd: float = 0.0
    momentum: float = 0.0
    frequency_of_the_test: int = 5
    seed: int = 0
    max_batches: int | None = None  # static per-client batch budget (B)
    ci: bool = False  # truncate eval, reference --ci semantics
    eval_batch_size: int = 256
    eval_max_samples: int | None = None
    remat: bool = False
    eval_subset_mode: str = "fixed"
    sampling: str = "uniform"
    precision: str = "f32"
    local_test_on_all_clients: str = "auto"
    churn_trace: object | None = None


def make_client_optimizer(cfg: FedAvgConfig) -> optim.ClientOptimizer:
    """SGD(momentum) or Adam after add_decayed_weights(wd), as the reference
    builds per client (MyModelTrainer.py:24-32) and the JAX package chains
    in optax (fedml_tpu/algorithms/fedavg.py:296-307)."""
    if cfg.client_optimizer == "sgd":
        return optim.sgd(cfg.lr, momentum=cfg.momentum, wd=cfg.wd)
    if cfg.client_optimizer == "adam":
        return optim.adam(cfg.lr, wd=cfg.wd)
    raise ValueError(cfg.client_optimizer)


def resolve_local_spec(local_spec: LocalSpec | None,
                       cfg: FedAvgConfig) -> LocalSpec:
    """The engine's LocalSpec: the default build honors ``cfg.precision``;
    a passed spec that left ``compute_dtype`` at its default is grafted
    with it, so ``precision='bf16'`` composes with every engine (a spec
    that set its own compute_dtype wins)."""
    prec = cfg.precision
    if prec not in COMPUTE_DTYPES:
        raise ValueError(f"precision={prec!r} (one of "
                         f"{sorted(COMPUTE_DTYPES)})")
    if cfg.remat:
        raise NotImplementedError("remat is not ported yet: ROADMAP.md "
                                  "queue A, item 4")
    if local_spec is None:
        return LocalSpec(optimizer=make_client_optimizer(cfg),
                         epochs=cfg.epochs, compute_dtype=prec)
    if COMPUTE_DTYPES[prec] is not None \
            and local_spec.compute_dtype in ("f32", "float32"):
        return dataclasses.replace(local_spec, compute_dtype=prec)
    return local_spec


def _prec_tag(spec: LocalSpec) -> str:
    """The variant-name precision tag: '' for f32, '_bf16' for bf16."""
    return ("" if spec.compute_dtype in ("f32", "float32")
            else f"_{spec.compute_dtype}")


class _Placed:
    """One round's batch on the device: ``tensors`` are (x, y, mask,
    num_samples), or (idx, mask, num_samples) of the device-resident plane
    (``index``). A copy started on the packer's CUDA stream carries its
    ``event`` and the pinned host buffers it reads (``keep``), which live
    until the round that consumes them has drained."""

    __slots__ = ("tensors", "index", "event", "keep")

    def __init__(self, tensors, index, event=None, keep=()):
        self.tensors, self.index = tuple(tensors), index
        self.event, self.keep = event, keep




class FedAvgAPI:
    """Host-side round driver on one device (``device``: the CUDA device
    when None, see fedml_tpu_torch.device).

    State: ``net`` is the global model, a dict of parameter tensors on the
    device; ``history`` holds one record per eval round. ``device_data``
    parks the train set on the device once (see module docstring)."""

    def __init__(self, dataset: FederatedData, task: Task,
                 config: FedAvgConfig, device=None,
                 local_spec: LocalSpec | None = None,
                 uniform_avg: bool = False, device_data: bool = False,
                 telemetry=None, aggregator=None,
                 aggregator_params: dict | None = None,
                 sanitize: bool | float | None = None,
                 adversary_plan=None, client_result_hook=None,
                 post_aggregate_hook=None, bucket_batches: bool = False,
                 prefetch: int = 0, drain_lag: int = 2, **unported):
        if unported:
            raise NotImplementedError(
                f"FedAvgAPI options {sorted(unported)} are not ported yet: "
                "ROADMAP.md queue A, items 4-6, 8-9 and 12")
        self.data = dataset
        self.task = task
        self.cfg = config
        self.device = resolve_device(device)
        # a streamed ClientDataSource (core/client_source.py) keeps client
        # rows out of host memory: packing reads only the sampled cohort's
        self._source = (dataset if isinstance(dataset, ClientDataSource)
                        else None)
        if self._source is not None and device_data:
            raise ValueError(
                "device_data parks the FULL train set on the device — "
                "incompatible with a streamed ClientDataSource (pass the "
                "host-packed plane, or materialize the dataset)")
        if self._source is not None \
                and config.local_test_on_all_clients == "on":
            raise ValueError(
                "local_test_on_all_clients='on' iterates every client's "
                "own split — not available on a streamed ClientDataSource "
                "(use 'auto'/'off': the global test split is evaluated)")
        self._eval_on_all_clients()  # validates local_test_on_all_clients
        # the pipelined driver: ``prefetch`` batches staged ahead by the
        # packer thread, outputs drained ``drain_lag`` rounds behind
        if prefetch < 0:
            raise ValueError(f"prefetch must be >= 0, got {prefetch}")
        if drain_lag < 0:
            raise ValueError(f"drain_lag must be >= 0, got {drain_lag}")
        self.prefetch = int(prefetch)
        self.drain_lag = int(drain_lag)
        # test hook: observes the pipeline's ("produced" / "got" /
        # "drained", round) events
        self._pipe_on_event = None
        self._h2d_stream = None  # the packer thread's CUDA stream
        # size_weighted sampling pairs with a uniform aggregate
        self.uniform_avg = uniform_avg or config.sampling == "size_weighted"
        self._client_sizes = prepare_sampling(config, dataset)

        # static per-client batch budget, fixed across rounds; a streamed
        # source answers from its size metadata
        if self._source is not None:
            max_count = int(np.max(self._source.client_sizes))
        else:
            max_count = max(len(v) for v in dataset.train_idx_map.values())
        b_needed = int(np.ceil(max_count / config.batch_size))
        self.num_batches = min(config.max_batches or b_needed, b_needed)
        # bucket_batches: each round's depth is the smallest ladder rung
        # covering the cohort's need (the ladder tops out at num_batches)
        self.bucket_batches = bool(bucket_batches)
        ladder = sorted({-(-self.num_batches // d) for d in (8, 4, 2, 1)})
        self._b_ladder = [b for b in ladder if b > 0]

        self.device_data = device_data
        if device_data:
            self._dev_x = torch.from_numpy(dataset.train_x).to(self.device)
            self._dev_y = torch.from_numpy(dataset.train_y).to(self.device)

        self.local_spec = resolve_local_spec(local_spec, config)
        self.local_update = make_local_update(task, self.local_spec)
        self.eval_fn = make_eval_fn(task)
        self._cohort_eval = make_cohort_eval_fn(task)

        # (net_k, net_global, key) -> net_k, vmapped over the cohort; and
        # (net, key) -> net after the aggregate (see module docstring)
        self.client_result_hook = client_result_hook
        self.post_aggregate_hook = post_aggregate_hook
        # the JAX engine's key chain: PRNGKey(seed), one split for the init
        self.rng = prng.split(prng.key(config.seed))[0]
        init = task.init(torch.Generator().manual_seed(config.seed),
                         self._init_batch(config.batch_size))
        self.net = {k: v.to(self.device) for k, v in init.items()}
        # the server optimizer's state: none until FedOpt (item 9)
        self.server_opt_state = ()
        self._test_cache = None
        self._eval_calls = 0
        self.history: list[dict] = []
        # per-round pack accounting, written at pack time and popped into
        # the telemetry round record (only while telemetry is on)
        self._pack_stats: dict[int, dict] = {}
        # server-plane sizing + per-round aggregation bytes
        # (perf_instrument: fed_server_state_bytes{placement} /
        # fed_agg_bytes_total{mode}); one device: replicated
        per_dev = _tree_bytes(self.net)  # + the server opt state: none
        self._state_placement = "replicated"
        self._agg_bytes_round = per_dev * config.client_num_per_round
        _perf.set_server_state_bytes(self._state_placement, per_dev)
        # rides every telemetry round record
        self._agg_record = {
            "mode": self._state_placement,
            "server_state_bytes_per_device": int(per_dev),
            "bytes_per_round": int(self._agg_bytes_round),
        }
        # a mixed-precision run stamps its policy on every round record
        if self.local_spec.compute_dtype not in ("f32", "float32"):
            self._agg_record["prec"] = self.local_spec.compute_dtype
        # telemetry: an obs.Telemetry bundle, or None (no extra work)
        self.telemetry = telemetry
        self._emit_stats = telemetry is not None and telemetry.round_stats
        self._costed: set[str] = set()  # variants whose FLOPs are cached
        # pack/round/eval host spans; with a tracing-enabled Telemetry
        # bundle the same spans also feed its single-rank timeline
        self.tracer = RoundTracer(
            sink=telemetry.tracer if telemetry is not None else None)
        # Byzantine-robust aggregation: ``aggregator`` is a name of
        # robust_agg.AGGREGATORS or a callable ``(stacked, weights) ->
        # (state, info)``; ``sanitize`` fronts it with the gate (True = the
        # default norm multiple, a float = that multiple, False = off,
        # None = on iff an aggregator is set)
        if aggregator is None:
            self._robust_agg = None
        elif callable(aggregator):
            self._robust_agg = aggregator
        else:
            self._robust_agg = make_robust_aggregator(
                aggregator, n=config.client_num_per_round,
                **(aggregator_params or {}))
        if sanitize is None:
            sanitize = self._robust_agg is not None
        self._sanitize_mult = (
            None if sanitize is False
            else DEFAULT_NORM_MULT if sanitize is True else float(sanitize))
        self._needs_stacked = (self._robust_agg is not None
                               or self._sanitize_mult is not None)
        # per-round verdicts; rank = stacked slot + 1, the loopback
        # runtime's worker rank, so the two ledgers compare entry for entry
        self.quarantine = QuarantineLedger()
        # model-space adversaries perturb the stacked nets after the fit,
        # before any server-side defense sees them
        self._adversary = None
        self.adversary_plan = adversary_plan
        if adversary_plan is not None:
            from fedml_tpu_torch.chaos.adversary import make_in_graph_injector

            self._adversary = make_in_graph_injector(
                adversary_plan, config.client_num_per_round)

    # ------------------------------------------------------------------ data
    def _sampled_ids(self, round_idx: int):
        return sample_for(self.cfg, round_idx, self._client_sizes)

    def _init_batch(self, n: int) -> np.ndarray:
        """A model-init sample batch (shapes matter, not values)."""
        if self._source is not None:
            return self._source.init_batch(n)
        return self.data.train_x[:n]

    def _put(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    def _bucketed_B(self, b_needed: int) -> int:
        """Smallest ladder rung covering ``b_needed`` (never above the
        static budget)."""
        for b in self._b_ladder:
            if b >= b_needed:
                return b
        return self.num_batches

    def _pack_round(self, round_idx: int, ids):
        """One round's batch on the host, padded to the round's depth (the
        static budget, or its ladder rung with ``bucket_batches``): an
        IndexBatch on the device-resident plane, else a ClientBatch (the
        C++ packer when it builds; a streamed source reads only the
        cohort's rows). Every call packs into fresh buffers, so the packer
        thread can run ahead of rounds still reading theirs."""
        cfg = self.cfg
        kw = dict(max_batches=self.num_batches, seed=cfg.seed,
                  round_idx=round_idx)
        if self.device_data:
            batch = pack_client_indices(self.data, ids, cfg.batch_size, **kw)
            b_needed = batch.idx.shape[1]
            pad = pad_index_batches
        else:
            if self._source is not None:
                batch = pack_clients_source(self._source, ids,
                                            cfg.batch_size, **kw)
            else:
                batch = pack_clients(self.data, ids, cfg.batch_size, **kw)
            b_needed = batch.num_batches
            pad = pad_batches
        batch = pad(batch, self._bucketed_B(b_needed) if self.bucket_batches
                    else self.num_batches)
        self._record_pack_stats(round_idx, b_needed, batch)
        return batch

    @staticmethod
    def _arrays(batch) -> tuple:
        if isinstance(batch, IndexBatch):
            return batch.idx, batch.mask, batch.num_samples
        return batch.x, batch.y, batch.mask, batch.num_samples

    def _place(self, batch, stream=None) -> _Placed:
        """Copy a packed batch to the device. ``stream`` (a CUDA stream,
        the packer thread's) starts the copies there from pinned buffers
        and records their event; without one the copies are the caller's
        synchronous ``_put``."""
        arrays = self._arrays(batch)
        index = isinstance(batch, IndexBatch)
        if stream is None:
            return _Placed([self._put(a) for a in arrays], index)
        with torch.cuda.stream(stream):
            pinned = [torch.from_numpy(a).pin_memory() for a in arrays]
            dev = [t.to(self.device, non_blocking=True) for t in pinned]
            event = torch.cuda.Event()
            event.record(stream)
        return _Placed(dev, index, event, pinned)

    def _materialize(self, placed: _Placed):
        """(x, y, mask, num_samples) on the device, in the calling thread's
        current stream: it first waits on the copy's event (never a host
        sync) and marks the copied tensors as used by that stream, so the
        caching allocator does not hand their blocks out while it still
        reads them; the device-resident plane then gathers its rows."""
        tensors = placed.tensors
        if placed.event is not None:
            cur = torch.cuda.current_stream(self.device)
            cur.wait_event(placed.event)
            for t in tensors:
                t.record_stream(cur)
        if placed.index:
            idx, mask, nsamp = tensors
            x, y = _gather_rows(self._dev_x, self._dev_y, idx.long(), mask)
            return x, y, mask, nsamp
        return tensors

    def _round_batch(self, round_idx: int, ids):
        """The round's (x, y, mask, num_samples) on the device (the
        synchronous driver's pack, copy and gather)."""
        return self._materialize(self._place(self._pack_round(round_idx,
                                                              ids)))

    def _record_pack_stats(self, round_idx: int, b_needed: int,
                           batch) -> None:
        """One round's pack accounting: the dispatched batch depth, the
        natural depth the cohort needed, the fraction of batch slots that
        are pure padding, and the packed host bytes — the numbers that show
        whether a skewed population is paying for its largest client every
        round."""
        if self.telemetry is None:
            return  # nobody will pop it — don't grow the dict forever
        if isinstance(batch, IndexBatch):
            K, B = batch.idx.shape[0], batch.idx.shape[1]
            nbytes = batch.idx.nbytes + batch.mask.nbytes
        else:
            K, B = batch.x.shape[0], batch.x.shape[1]
            nbytes = batch.x.nbytes + batch.y.nbytes + batch.mask.nbytes
        used = float(np.sum(np.ceil(
            np.asarray(batch.num_samples) / self.cfg.batch_size)))
        slots = float(K * B)
        self._pack_stats[round_idx] = {
            "bucket_B": int(B), "b_needed": int(b_needed),
            "budget_B": int(self.num_batches),
            "pad_frac": round(1.0 - used / slots, 4) if slots else 0.0,
            "bytes": int(nbytes),
        }

    def _pack_extra(self, round_idx: int) -> dict:
        """The optional ``pack`` block a telemetry round record carries —
        absent when nothing was recorded."""
        ps = self._pack_stats.pop(round_idx, None)
        return {"pack": ps} if ps else {}

    # ------------------------------------------------------------------ round
    def _dispatch_round(self, round_idx: int, ids, batch) -> dict:
        """Advance the key chain and run one round on the device batch
        ``(x, y, mask, num_samples)``: the cohort's batched fit,
        sample-weighted mean (the FedAvg server update is the identity on
        the mean). The one call site the synchronous and the pipelined
        drivers share, so their key chains cannot diverge. Returns the
        summed metrics as device tensors; an armed round's ``[K]`` reason
        codes ride along under ``__quarantine`` (``_drain_quarantine``)."""
        x, y, mask, nsamp = batch
        with self.tracer.span("round"), float32_compute():
            # one key a round, split three ways (the JAX round program's)
            self.rng, rk = prng.split(self.rng)
            _, kh, kp = prng.split(rk, 3)
            nets, metrics = self.local_update(self.net, x, y, mask)
            if self._adversary is not None:
                nets = self._adversary(nets, self.net, round_idx)
            if self.client_result_hook is not None:
                nets = self._client_hook(nets, kh, len(ids))
            weights = agg_weights(nsamp, self.uniform_avg)
            reasons = None
            if self._needs_stacked:
                avg, _, reasons = gated_aggregate(
                    nets, self.net, weights, robust_fn=self._robust_agg,
                    norm_mult=self._sanitize_mult)
            else:
                avg = tree_weighted_mean(nets, weights)
            new_net, self.server_opt_state = self._update_from_aggregate(
                self.net, avg, self.server_opt_state, kp)
            metrics = {k: v.sum() for k, v in metrics.items()}
            if self._emit_stats:
                metrics.update(round_stats(self.net, new_net, nets, avg,
                                           nsamp))
            self.net = new_net
            if reasons is not None:
                metrics["__quarantine"] = reasons
        _perf.record_agg_bytes(self._state_placement, self._agg_bytes_round)
        return metrics

    def _drain_quarantine(self, metrics: dict, round_idx: int, ids) -> dict:
        """Pop an armed round's reason codes into the ledger (the round's
        one host read) and return the metrics without them."""
        reasons = metrics.pop("__quarantine", None)
        if reasons is not None:
            self.quarantine.record_codes(round_idx, reasons.cpu().numpy(),
                                         clients=np.asarray(ids).tolist())
        return metrics

    def run_round(self, round_idx: int) -> dict:
        """One round: sample, pack, then ``_dispatch_round``. Returns the
        round's summed training metrics as device tensors (no host read
        unless a telemetry bundle asks for its record)."""
        if self.telemetry is not None:
            t_wall = time.perf_counter()
            spans_before = dict(self.tracer.rounds[-1])
            if self.telemetry.tracer is not None:
                self.telemetry.tracer.begin_round(round_idx)
        with self.tracer.span("pack"):
            ids = self._sampled_ids(round_idx)
            batch = self._round_batch(round_idx, ids)
        metrics = self._dispatch_round(round_idx, ids, batch)
        metrics = self._drain_quarantine(metrics, round_idx, ids)
        if self.telemetry is not None:
            # floating the metrics syncs on the round's outputs — a cost the
            # caller opted into by passing telemetry; the off path returns
            # the device tensors untouched (no sync, dispatch still overlaps)
            wait = self._goodput_wait()
            spans = self._span_delta(spans_before)
            pack_extra = self._pack_extra(round_idx)
            self.telemetry.emit_round(
                round_idx, clients=np.asarray(ids).tolist(),
                spans=spans,
                metrics={k: float(v) for k, v in metrics.items()},
                agg=self._agg_record,
                **self._goodput_extra(
                    time.perf_counter() - t_wall, spans,
                    compute_wait_s=wait, pack_extra=pack_extra),
                **pack_extra,
                **self._quarantine_extra(round_idx),
                **self._privacy_extra())
            if self.telemetry.tracer is not None:
                # close the trace envelope HERE: left open it would absorb
                # inter-round idle and misreport per-round wall-clock
                self.telemetry.tracer.finish_round()
        return metrics

    def _client_hook(self, nets: dict, kh, k: int) -> dict:
        """``client_result_hook`` on each client of the stacked cohort
        (``torch.func.vmap``), client ``i`` keyed by ``split(kh, K)[i]``
        (its uint32 words as an int64 tensor)."""
        keys = torch.as_tensor(prng.split(kh, k).astype(np.int64),
                               device=self.device)
        net = self.net
        return torch.func.vmap(
            lambda n, key: self.client_result_hook(n, net, key))(nets, keys)

    def _update_from_aggregate(self, net: dict, avg: dict,
                               server_opt_state, post_key):
        """The server update (the identity on the aggregate until FedOpt,
        item 9) -> ``post_aggregate_hook(net, post_key)``: the ONE
        server-side composition ``run_round`` and the async flush share.
        Returns ``(new_net, server_opt_state)``."""
        new_net = avg
        if self.post_aggregate_hook is not None:
            new_net = self.post_aggregate_hook(new_net, post_key)
        return new_net, server_opt_state

    def _privacy_extra(self) -> dict:
        """The round record's optional ``privacy`` block: {} here;
        FedAvgRobustAPI's accounted DP returns its accountant's."""
        return {}

    # ------------------------------------------------------ round economics
    def _variant_name(self, B=None) -> str:
        """The reference's jit variant name for this dispatch,
        ``round{prec}_b{B}`` (warmup reports the same names), under which
        the round's FLOP count is cached (obs/goodput.py)."""
        B = self.num_batches if B is None else B
        return f"round{_prec_tag(self.local_spec)}_b{int(B)}"

    def _goodput_wait(self, done=None) -> float:
        """Wait for the card to finish this round's work and return the
        wait — the device-compute backpressure the round loop pays, goodput's
        ``compute`` share beyond the dispatch. ``done``: the CUDA event
        recorded after the round's dispatch (the pipelined drain: later
        rounds are queued behind it), else the whole device. Telemetry
        paths only: they were about to sync on the same outputs anyway
        (emit floats them), so the off path stays sync-free. 0 on the
        CPU."""
        if self.device.type != "cuda":
            return 0.0
        t0 = time.perf_counter()
        if done is not None:
            done.synchronize()
        else:
            torch.cuda.synchronize(self.device)
        return time.perf_counter() - t0

    def _variant_flops(self, variant: str, B: int) -> None:
        """Count the round variant's FLOPs once (utils/flops.py: 3x one
        forward a sample, over every slot of the cohort's K x B x bs
        batch, padded slots included as the reference's round program
        counts them) and cache them under ``variant``."""
        if variant in self._costed:
            return
        from fedml_tpu_torch.utils.flops import forward_flops

        self._costed.add(variant)
        fwd = forward_flops(self.task, self.net, self._init_batch(1))
        _goodput.record_variant_cost(
            variant, None if fwd is None else
            3.0 * fwd * self.cfg.client_num_per_round * B
            * self.cfg.batch_size)

    def _goodput_extra(self, wall_s, spans, *, pipelined: bool = False,
                       compute_wait_s: float = 0.0, pack_extra=None) -> dict:
        """The ``goodput`` block one round record carries (obs/goodput.py):
        exclusive duty-cycle buckets of this round's wall plus FLOPs/s and
        MFU from the variant's FLOP count. {} when the wall was not
        measured."""
        if wall_s is None:
            return {}
        B = ((pack_extra or {}).get("pack") or {}).get("bucket_B")
        variant = self._variant_name(B=B)
        self._variant_flops(variant, self.num_batches if B is None else B)
        buckets = _goodput.buckets_from_spans(
            wall_s, spans, pipelined=pipelined,
            compute_wait_s=compute_wait_s)
        return {"goodput": _goodput.round_goodput(
            wall_s, buckets, variant=variant, n_devices=1)}

    def _goodput_interval(self):
        """Per-round wall in pipelined mode: time since the previous drain
        (one drain per dispatch in steady state). None before the drivers
        seed the stamp."""
        now = time.perf_counter()
        prev = getattr(self, "_gp_prev_drain_t", None)
        self._gp_prev_drain_t = now
        return (now - prev) if prev is not None else None

    def _span_delta(self, before: dict) -> dict:
        """This call's span seconds: current tracer round minus a snapshot
        taken at entry (run_round may be driven without train()'s
        next_round() between calls, so the tracer's round dict
        accumulates)."""
        cur = self.tracer.rounds[-1]
        return {k: v - before.get(k, 0.0) for k, v in cur.items()
                if v - before.get(k, 0.0) > 0.0}

    def _quarantine_extra(self, round_idx: int) -> dict:
        """The round record's ``quarantine`` block: the round's ledger
        entries, absent on clean rounds."""
        entries = self.quarantine.for_round(round_idx)
        return {"quarantine": entries} if entries else {}

    def run_rounds(self, start_round: int, num_rounds: int) -> dict:
        """Rounds ``start_round`` .. ``start_round + num_rounds - 1`` back to
        back, with no host read between them but an armed round's reason
        codes (each round's verdicts land in the ledger as run_round's
        do); per-round metrics stacked along axis 0. Needs
        ``device_data=True``, as the reference's one-program block does.
        It is a loop of ``run_round``, so a churn trace's varying cohort
        needs no refusal here (the reference's scanned block refuses
        one: its shapes are static)."""
        if not self.device_data:
            raise ValueError("run_rounds needs device_data=True")
        ms = [self.run_round(r)
              for r in range(start_round, start_round + num_rounds)]
        return {k: torch.stack([m[k] for m in ms]) for k in ms[0]}

    def _eval_on_all_clients(self) -> bool:
        mode = self.cfg.local_test_on_all_clients
        if mode == "auto":
            return (self.data.test_idx_map is not None
                    and self.cfg.eval_max_samples is None)
        if mode in ("on", "off"):
            return mode == "on"
        raise ValueError(f"local_test_on_all_clients={mode!r} "
                         "(expected 'auto', 'on' or 'off')")

    def eval_record(self, round_idx: int, metrics) -> dict:
        """One eval-round history record: the round's training metrics plus
        either the per-client aggregate (reference _local_test_on_all_clients,
        fedavg_api.py:117-180: the global model scored on every client's own
        train and test split) or the global test-set eval."""
        n = max(float(metrics["count"]), 1.0)
        rec = {"round": round_idx,
               "train_loss": float(metrics["loss_sum"]) / n,
               "train_acc": float(metrics["correct"]) / n}
        with self.tracer.span("eval"):
            if self._eval_on_all_clients():
                _, tr = self.evaluate_per_client("train")
                _, te = self.evaluate_per_client("test")
                rec.update(train_all_loss=tr["loss"], train_all_acc=tr["acc"],
                           test_loss=te["loss"], test_acc=te["acc"])
            else:
                ev = self.evaluate()
                rec.update(test_loss=ev["loss"], test_acc=ev["acc"])
        return rec

    def train(self, num_rounds: int | None = None):
        cfg = self.cfg
        rounds = num_rounds or cfg.comm_round
        if self.telemetry is not None:
            from fedml_tpu_torch.data import dataset_source

            self.telemetry.run_header(dataclasses.asdict(cfg),
                                      engine="standalone",
                                      dataset_source=dataset_source(
                                          self.data))
        if self.prefetch and rounds > 0:
            return self._train_pipelined(rounds)
        for r in range(rounds):
            t0 = time.perf_counter()
            metrics = self.run_round(r)
            if (r % cfg.frequency_of_the_test == 0) or (r == rounds - 1):
                rec = self.eval_record(r, metrics)
                rec["round_time"] = time.perf_counter() - t0
                self.history.append(rec)
                log.info("round %d: %s", r, rec)
                if self.telemetry is not None:
                    self.telemetry.emit_eval(r, rec)
            self.tracer.next_round()
        return self.net

    # --------------------------------------------------------------- pipeline
    def _pack_round_placed(self, round_idx: int):
        """Prefetch producer (the packer thread): sample, pack into fresh
        host buffers and start the copy to the device — on a CUDA device on
        the packer's own stream. Returns (ids, placed batch, spans). The
        packer thread does not touch ``self.tracer`` (its round dict is the
        driver thread's): its spans feed the fed_span_seconds /
        fed_h2d_seconds histograms and ride the round record at drain."""
        t0 = time.perf_counter()
        ids = self._sampled_ids(round_idx)
        batch = self._pack_round(round_idx, ids)
        t1 = time.perf_counter()
        placed = self._place(batch, self._h2d_stream)
        h2d = time.perf_counter() - t1
        _perf.record_span("prefetch_pack", t1 - t0)
        _perf.record_h2d(h2d)
        return ids, placed, {"prefetch_pack": t1 - t0, "h2d": h2d}

    def _drain_round_entry(self, round_idx: int, entry):
        """Materialize one in-flight round's outputs, ``drain_lag`` rounds
        behind dispatch: reason codes into the ledger, metrics to the host,
        the telemetry record — all in round order, so ledgers and records
        equal the synchronous driver's."""
        ids, spans, pipeline, metrics, _placed, done = entry
        if self.telemetry is not None:
            # the drain is the pipeline's one sync: its wait is the device
            # backpressure this round cost; inter-drain time is the wall
            wait = self._goodput_wait(done)
            wall = self._goodput_interval()
        metrics = self._drain_quarantine(metrics, round_idx, ids)
        host = {k: v.cpu().numpy() for k, v in metrics.items()}
        if self.telemetry is not None:
            pack_extra = self._pack_extra(round_idx)
            self.telemetry.emit_round(
                round_idx, clients=np.asarray(ids).tolist(),
                spans=spans, pipeline=pipeline,
                prefetch_stall=spans.get("prefetch_stall", 0.0),
                metrics={k: float(v) for k, v in host.items()},
                agg=self._agg_record,
                **self._goodput_extra(
                    wall, spans, pipelined=True, compute_wait_s=wait,
                    pack_extra=pack_extra),
                **pack_extra,
                **self._quarantine_extra(round_idx),
                **self._privacy_extra())
        return round_idx, host

    def _warn_tracer_unsupported(self):
        """Pipelined drivers overlap rounds, which the sequential per-round
        trace model (obs/tracing.py begin_round..finish_round) cannot
        represent, so they emit no per-round traces: say so once."""
        if (self.telemetry is not None and self.telemetry.tracer is not None
                and not getattr(self, "_tracer_warned", False)):
            self._tracer_warned = True
            log.warning(
                "pipelined drivers do not emit per-round distributed "
                "traces (rounds overlap; the trace model is sequential) — "
                "round records carry prefetch/h2d/stall spans instead; "
                "use the synchronous driver (prefetch=0) for trace runs")

    def _start_pipeline(self, keys):
        """The (Prefetcher, InflightRing) pair over round ``keys``; on a
        CUDA device the packer's copy stream is made here, once."""
        if self.device.type == "cuda" and self._h2d_stream is None:
            self._h2d_stream = torch.cuda.Stream(self.device)
        pf = Prefetcher(self._pack_round_placed, keys,
                        depth=max(1, self.prefetch),
                        on_event=self._pipe_on_event)
        ring = InflightRing(self.drain_lag, self._drain_round_entry,
                            on_event=self._pipe_on_event)
        self._gp_prev_drain_t = time.perf_counter()
        return pf, ring

    def _dispatch_pipelined(self, pf, ring, r: int) -> list:
        """Take round ``r``'s prefetched batch, dispatch it, push its
        outputs into the ring; returns the rounds the push drained."""
        (ids, placed, spans), stall = pf.get(r)
        metrics = self._dispatch_round(r, ids, self._materialize(placed))
        done = None
        if self.telemetry is not None and self.device.type == "cuda":
            # the drain's goodput wait is for this round alone
            done = torch.cuda.Event()
            done.record()
        spans = dict(spans, prefetch_stall=stall)
        return ring.push(r, (ids, spans, {"depth": len(ring) + 1}, metrics,
                             placed, done))

    def run_pipelined(self, start_round: int, num_rounds: int) -> list:
        """Per-round dispatch through the prefetch pipeline: round r+1's
        pack and copy overlap round r, and the drain trails ``drain_lag``
        rounds behind. Bitwise the run_round loop (same packs, same key
        chain, same ledger order). Returns [(round_idx, host metrics)] in
        round order."""
        self._warn_tracer_unsupported()
        pf, ring = self._start_pipeline(
            range(start_round, start_round + num_rounds))
        out = []
        try:
            for r in range(start_round, start_round + num_rounds):
                out.extend(self._dispatch_pipelined(pf, ring, r))
            out.extend(ring.drain_all())
        finally:
            pf.close()
        return out

    def _train_pipelined(self, rounds: int):
        """train() with the pipeline armed: the same eval cadence and
        history records as the synchronous loop; an eval round drains the
        ring (its metrics must be on the host)."""
        self._warn_tracer_unsupported()
        cfg = self.cfg
        pf, ring = self._start_pipeline(range(rounds))
        pending: dict[int, dict] = {}
        try:
            for r in range(rounds):
                t0 = time.perf_counter()
                for k, m in self._dispatch_pipelined(pf, ring, r):
                    pending[k] = m
                if (r % cfg.frequency_of_the_test == 0) or (r == rounds - 1):
                    for k, m in ring.drain_all():
                        pending[k] = m
                    rec = self.eval_record(r, pending[r])
                    rec["round_time"] = time.perf_counter() - t0
                    self.history.append(rec)
                    log.info("round %d: %s", r, rec)
                    if self.telemetry is not None:
                        self.telemetry.emit_eval(r, rec)
                pending = {k: v for k, v in pending.items() if k >= r}
                self.tracer.next_round()
            ring.drain_all()
        finally:
            pf.close()
        return self.net

    # ----------------------------------------------------------------- warmup
    def _warmup_batch(self, B: int):
        """An all-masked zero batch with the shapes and dtypes the round
        sees at depth ``B``."""
        K, bs = self.cfg.client_num_per_round, self.cfg.batch_size
        mask = np.zeros((K, B, bs), np.float32)
        nsamp = np.zeros((K,), np.float32)
        if self.device_data:
            return IndexBatch(idx=np.zeros((K, B, bs), np.int32), mask=mask,
                              num_samples=nsamp)
        if self._source is not None:
            (xs, xd), (ys, yd) = self._source.row_meta()
        else:
            x, y = self.data.train_x, self.data.train_y
            (xs, xd), (ys, yd) = (x.shape[1:], x.dtype), (y.shape[1:],
                                                          y.dtype)
        return ClientBatch(x=np.zeros((K, B, bs) + tuple(xs), xd),
                           y=np.zeros((K, B, bs) + tuple(ys), yd),
                           mask=mask, num_samples=nsamp)

    def warmup(self) -> dict:
        """Run the cohort's fit once per depth this engine can dispatch
        (the ladder's rungs with ``bucket_batches``, else the budget) on
        an all-masked zero batch: the eager counterpart of the reference's
        AOT compile pass. It loads the cuDNN / cuBLAS handles and grows the
        allocator before the first timed round. Only the fit runs (the
        aggregate of zero samples would divide by zero), and an all-masked
        fit is a no-op, so ``net``, the key chain and every ledger stay as
        they were. Eager PyTorch compiles nothing: ``fresh_compiles`` and
        ``cache_hits`` are 0."""
        buckets = (list(self._b_ladder) if self.bucket_batches
                   else [self.num_batches])
        prec = _prec_tag(self.local_spec)
        per_variant = {}
        t_all = time.perf_counter()
        for B in buckets:
            t0 = time.perf_counter()
            x, y, mask, _ = self._materialize(self._place(
                self._warmup_batch(B)))
            with float32_compute():
                self.local_update(self.net, x, y, mask)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            per_variant[f"round{prec}_b{B}"] = time.perf_counter() - t0
        rep = {"variants": list(per_variant), "bucket_depths": buckets,
               "seconds": time.perf_counter() - t_all,
               "per_variant": per_variant,
               "fresh_compiles": 0, "cache_hits": 0}
        log.info("warmup: %d variant(s) in %.2fs", len(per_variant),
                 rep["seconds"])
        if self.telemetry is not None:
            self.telemetry.events.emit(
                "compiles", variants=per_variant, seconds=rep["seconds"],
                fresh=0, cache_hits=0, cache_misses=0, instrumented=False,
                attribution={})
        return rep

    # ------------------------------------------------------------------ state
    def load_state(self, net: dict, server_opt_state=(), rng=None):
        """Install restored state, the reference's signature: a global
        model (a state dict, e.g. converted from the JAX package's params
        by fedml_tpu_torch.convert) on the engine's device, the server
        optimizer's state (``()`` until FedOpt) and the key chain's words
        (None keeps the current chain)."""
        if set(net) != set(self.net):
            raise ValueError(f"state keys {sorted(net)} do not match the "
                             f"model's {sorted(self.net)}")
        self.net = {k: torch.as_tensor(v).to(self.device, self.net[k].dtype)
                    for k, v in net.items()}
        self.server_opt_state = server_opt_state
        if rng is not None:
            self.rng = np.asarray(rng, np.uint32).reshape(2).copy()

    # ------------------------------------------------------------------ async
    def run_async(self, num_updates: int, buffer_k: int,
                  staleness="constant", staleness_bound: int | None = None,
                  deadline_s: float | None = None,
                  capacity: int | None = None, chaos_plan=None,
                  adversary_plan=None, base_duration_s: float = 1.0):
        """Buffered-async rounds on a virtual clock
        (core/async_buffer.VirtualClockAsyncRunner): worker slots train
        continuously against possibly-stale globals, the server aggregates
        every ``buffer_k`` sanitized arrivals with staleness-discounted
        weights through this engine's own gate / estimator /
        ``_update_from_aggregate``, and admission rejects-and-requeues
        updates staler than ``staleness_bound``. A chaos FaultPlan's
        straggle / crash rules drive the virtual durations, so a seeded run
        replays bit for bit. ``buffer_k`` = cohort with
        ``staleness_bound=0`` is bitwise the ``run_round`` loop, model and
        ledger.

        Returns the runner (``.history`` per-update records, ``.stats()``
        wall-clock / staleness / shed summary); the engine's net, key
        chain and quarantine advance as if the updates had run
        synchronously."""
        from fedml_tpu_torch.core.async_buffer import VirtualClockAsyncRunner

        runner = VirtualClockAsyncRunner(
            self, buffer_k, staleness=staleness,
            staleness_bound=staleness_bound, deadline_s=deadline_s,
            capacity=capacity, chaos_plan=chaos_plan,
            adversary_plan=adversary_plan, base_duration_s=base_duration_s)
        runner.run(num_updates)
        return runner

    # ------------------------------------------------------------------ eval
    def evaluate(self) -> dict:
        """Global test-set eval: {'loss', 'acc', 'count'}."""
        fresh = (self.cfg.eval_subset_mode == "fresh"
                 and self.cfg.eval_max_samples is not None
                 and len(self.data.test_x) > self.cfg.eval_max_samples)
        self._eval_calls += 1
        if self._test_cache is None or fresh:
            tx, ty = eval_subset(self.data.test_x, self.data.test_y,
                                 self.cfg, self._eval_calls)
            n = len(tx)
            if self.cfg.ci:
                n = min(n, 512)  # --ci truncation (FedAVGAggregator.py:126-131)
            self._test_cache = tuple(
                self._put(a)
                for a in batch_global(tx[:n], ty[:n], self.cfg.eval_batch_size))
        with float32_compute():
            return self.eval_fn(self.net, *self._test_cache)

    def evaluate_per_client(self, split: str = "test", chunk: int = 64):
        """Every client's own split scored by the global model
        (_local_test_on_all_clients, fedavg_api.py:117-180): clients are
        packed in chunks of ``chunk`` and each chunk is evaluated batched
        over its clients, one host read per chunk.

        Returns (per-client list of {client, loss, acc, count}, aggregate
        weighted by sample counts)."""
        if split == "test" and self.data.test_idx_map is not None:
            view = dataclasses.replace(self.data, train_x=self.data.test_x,
                                       train_y=self.data.test_y,
                                       train_idx_map=self.data.test_idx_map)
        elif split == "test":
            # no per-client test partition: every client shares the global
            # test set (the cross-silo datasets' convention)
            ev = self.evaluate()
            return [], {k: ev[k] for k in ("loss", "acc", "count")}
        else:
            view = self.data

        ids = np.arange(view.num_clients)
        if self.cfg.ci:
            ids = ids[:1]  # --ci truncation (FedAVGAggregator.py:126-131)
        per_client: list[dict] = []
        tot = {"loss_sum": 0.0, "correct": 0.0, "count": 0.0}
        for s in range(0, len(ids), chunk):
            cids = ids[s:s + chunk]
            cb = pack_clients(view, cids, self.cfg.eval_batch_size,
                              seed=self.cfg.seed, round_idx=0)
            with float32_compute():
                m = self._cohort_eval(self.net, self._put(cb.x),
                                      self._put(cb.y), self._put(cb.mask))
            m = {k: v.cpu().numpy() for k, v in m.items()}
            for i, cid in enumerate(cids):
                n = float(max(m["count"][i], 1.0))
                per_client.append({
                    "client": int(cid),
                    "loss": float(m["loss_sum"][i]) / n,
                    "acc": float(m["correct"][i]) / n,
                    "count": float(m["count"][i]),
                })
                for k in tot:
                    tot[k] += float(m[k][i])
        n = max(tot["count"], 1.0)
        return per_client, {"loss": tot["loss_sum"] / n,
                            "acc": tot["correct"] / n, "count": tot["count"]}
