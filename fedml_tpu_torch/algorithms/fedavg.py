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
(clients, spans, the summed metrics and ``round_stats``, comm bytes) and
feeds the spans to its tracer; with telemetry off nothing syncs and
nothing is added to the round. The reference's goodput, privacy and pack
blocks of that record need modules not ported yet and are left out.
Mesh/SPMD round loops, prefetch pipelines, robust aggregation and the
other engine options are queued in ROADMAP.md (queue A, items 5-8);
passing one raises.
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
    FederatedData,
    batch_global,
    pack_client_indices,
    pack_clients,
    pad_batches,
    pad_index_batches,
)
from fedml_tpu_torch.core.local import (
    LocalSpec,
    Task,
    make_cohort_eval_fn,
    make_eval_fn,
    make_local_update,
)
from fedml_tpu_torch.core.sampling import prepare_sampling, sample_for
from fedml_tpu_torch.device import resolve_device
from fedml_tpu_torch.obs.tracing import RoundTracer
from fedml_tpu_torch.utils.tree import tree_weighted_mean

log = logging.getLogger("fedml_tpu_torch.fedavg")


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
    """The engine's LocalSpec: built from the config unless one is passed."""
    if cfg.precision not in ("f32", "float32"):
        raise NotImplementedError(
            f"precision={cfg.precision!r}: only float32 is ported (bf16: "
            "ROADMAP.md queue A, item 7)")
    if cfg.remat:
        raise NotImplementedError("remat is not ported yet: ROADMAP.md "
                                  "queue A, item 4")
    if local_spec is not None:
        return local_spec
    return LocalSpec(optimizer=make_client_optimizer(cfg), epochs=cfg.epochs)




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
                 telemetry=None, **unported):
        if unported:
            raise NotImplementedError(
                f"FedAvgAPI options {sorted(unported)} are not ported yet: "
                "ROADMAP.md queue A, items 5-8")
        if config.churn_trace is not None:
            raise NotImplementedError("churn_trace is not ported yet: "
                                      "ROADMAP.md queue A, item 8")
        self.data = dataset
        self.task = task
        self.cfg = config
        self.device = resolve_device(device)
        self._eval_on_all_clients()  # validates local_test_on_all_clients
        # size_weighted sampling pairs with a uniform aggregate
        self.uniform_avg = uniform_avg or config.sampling == "size_weighted"
        self._client_sizes = prepare_sampling(config, dataset)

        # static per-client batch budget, fixed across rounds
        max_count = max(len(v) for v in dataset.train_idx_map.values())
        b_needed = int(np.ceil(max_count / config.batch_size))
        self.num_batches = min(config.max_batches or b_needed, b_needed)

        self.device_data = device_data
        if device_data:
            self._dev_x = torch.from_numpy(dataset.train_x).to(self.device)
            self._dev_y = torch.from_numpy(dataset.train_y).to(self.device)

        self.local_spec = resolve_local_spec(local_spec, config)
        self.local_update = make_local_update(task, self.local_spec)
        self.eval_fn = make_eval_fn(task)
        self._cohort_eval = make_cohort_eval_fn(task)

        init = task.init(torch.Generator().manual_seed(config.seed),
                         dataset.train_x[:config.batch_size])
        self.net = {k: v.to(self.device) for k, v in init.items()}
        self._test_cache = None
        self._eval_calls = 0
        self.history: list[dict] = []
        # telemetry: an obs.Telemetry bundle, or None (no extra work)
        self.telemetry = telemetry
        self._emit_stats = telemetry is not None and telemetry.round_stats
        # pack/round/eval host spans; with a tracing-enabled Telemetry
        # bundle the same spans also feed its single-rank timeline
        self.tracer = RoundTracer(
            sink=telemetry.tracer if telemetry is not None else None)

    # ------------------------------------------------------------------ data
    def _sampled_ids(self, round_idx: int):
        return sample_for(self.cfg, round_idx, self._client_sizes)

    def _put(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    def _round_batch(self, round_idx: int, ids):
        """The round's (x, y, mask, num_samples) on the device, padded to
        the static batch budget: gathered on the device from an IndexBatch
        (``device_data``), or packed on the host (the C++ packer when it
        builds) and copied over."""
        cfg = self.cfg
        kw = dict(max_batches=self.num_batches, seed=cfg.seed,
                  round_idx=round_idx)
        if self.device_data:
            ib = pad_index_batches(
                pack_client_indices(self.data, ids, cfg.batch_size, **kw),
                self.num_batches)
            mask = self._put(ib.mask)
            x, y = _gather_rows(self._dev_x, self._dev_y,
                                self._put(ib.idx).long(), mask)
            return x, y, mask, self._put(ib.num_samples)
        cb = pad_batches(pack_clients(self.data, ids, cfg.batch_size, **kw),
                         self.num_batches)
        return (self._put(cb.x), self._put(cb.y), self._put(cb.mask),
                self._put(cb.num_samples))

    # ------------------------------------------------------------------ round
    def run_round(self, round_idx: int) -> dict:
        """One round: sample, pack, the cohort's batched local fit,
        sample-weighted mean (the FedAvg server update is the identity on
        the mean). Returns the round's summed training metrics as device
        tensors (no host read unless a telemetry bundle asks for its
        record)."""
        if self.telemetry is not None:
            spans_before = dict(self.tracer.rounds[-1])
            if self.telemetry.tracer is not None:
                self.telemetry.tracer.begin_round(round_idx)
        with self.tracer.span("pack"):
            ids = self._sampled_ids(round_idx)
            x, y, mask, nsamp = self._round_batch(round_idx, ids)
        with self.tracer.span("round"), float32_compute():
            nets, metrics = self.local_update(self.net, x, y, mask)
            avg = tree_weighted_mean(nets, agg_weights(nsamp, self.uniform_avg))
            metrics = {k: v.sum() for k, v in metrics.items()}
            if self._emit_stats:
                metrics.update(round_stats(self.net, avg, nets, avg, nsamp))
            self.net = avg
        if self.telemetry is not None:
            # floating the metrics syncs on the round's outputs — a cost the
            # caller opted into by passing telemetry; the off path returns
            # the device tensors untouched
            self.telemetry.emit_round(
                round_idx, clients=np.asarray(ids).tolist(),
                spans=self._span_delta(spans_before),
                metrics={k: float(v) for k, v in metrics.items()})
            if self.telemetry.tracer is not None:
                # close the trace envelope HERE: left open it would absorb
                # inter-round idle and misreport per-round wall-clock
                self.telemetry.tracer.finish_round()
        return metrics

    def _span_delta(self, before: dict) -> dict:
        """This call's span seconds: current tracer round minus a snapshot
        taken at entry (run_round may be driven without train()'s
        next_round() between calls, so the tracer's round dict
        accumulates)."""
        cur = self.tracer.rounds[-1]
        return {k: v - before.get(k, 0.0) for k, v in cur.items()
                if v - before.get(k, 0.0) > 0.0}

    def run_rounds(self, start_round: int, num_rounds: int) -> dict:
        """Rounds ``start_round`` .. ``start_round + num_rounds - 1`` back to
        back, with no host read between them; per-round metrics stacked
        along axis 0. Needs ``device_data=True``, as the reference's
        one-program block does."""
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

    # ------------------------------------------------------------------ state
    def load_state(self, net: dict):
        """Install a global model (a state dict, e.g. converted from the JAX
        package's params by fedml_tpu_torch.convert) on the engine's
        device."""
        if set(net) != set(self.net):
            raise ValueError(f"state keys {sorted(net)} do not match the "
                             f"model's {sorted(self.net)}")
        self.net = {k: torch.as_tensor(v).to(self.device, self.net[k].dtype)
                    for k, v in net.items()}

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
