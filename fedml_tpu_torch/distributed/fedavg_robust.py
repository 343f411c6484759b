"""Distributed robust FedAvg — defenses applied at the server aggregator;
port of fedml_tpu/distributed/fedavg_robust.py.

Mirror of fedml_api/distributed/fedavg_robust/: the message flow, trainer
and managers are FedAvg's; FedAvgRobustAggregator.py applies the
fedml_core/robustness defenses before / after the weighted average
(--defense_type norm_diff_clipping|weak_dp, --norm_bound, --stddev,
robust_aggregation.py:33-36). Each upload is norm-diff-clipped against the
current global model, and noise is added to the aggregate, with the same
functions the standalone FedAvgRobustAPI runs as engine hooks
(core/robust.py).

``defense_type='dp'`` is ACCOUNTED DP-FedAvg (core/privacy.py): clip to C,
a UNIFORM average over the m clients that actually reported (elastic
rounds shrink m — the noise z·C/m and the accountant's sampling rate both
use the realized m, so the noise's scale is a per-round value), Gaussian
noise on the aggregate, cumulative (ε, δ) via ``epsilon()``. With a WAL
the ``precharge`` record is fsync'd before the noise key is drawn, and the
noise key and RDP totals ride the server's checkpoint, so a resumed job
neither under-reports ε nor replays noise keys. The noise key chain is the
JAX package's (``PRNGKey(seed + 7)``, one split per aggregate), so a
checkpoint of either package resumes in the other.
"""

from __future__ import annotations

from fedml_tpu_torch.algorithms.fedavg import FedAvgConfig, float32_compute
from fedml_tpu_torch.algorithms.fedavg_robust import DEFENSES
from fedml_tpu_torch.comm.message import pack_pytree
from fedml_tpu_torch.core.robust import add_gaussian_noise, norm_diff_clipping
from fedml_tpu_torch.distributed.fedavg.aggregator import FedAvgAggregator
from fedml_tpu_torch.distributed.fedavg.api import (
    init_client,
    run_supervised_simulated,
    server_crash_points,
)
from fedml_tpu_torch.distributed.fedavg.server_manager import (
    FedAvgServerManager,
)
from fedml_tpu_torch.distributed.utils import backend_kwargs, launch_simulated
from fedml_tpu_torch.utils import prng


class FedAvgRobustAggregator(FedAvgAggregator):
    # the clip reworks every upload at the barrier, so arrival-time
    # staging would only move each upload twice
    _stage_uploads_on_arrival = False

    def __init__(self, dataset, task, cfg: FedAvgConfig, worker_num: int,
                 defense_type: str = "norm_diff_clipping",
                 norm_bound: float = 30.0, stddev: float = 0.025,
                 noise_multiplier: float = 1.0, **agg_kw):
        # agg_kw: the base aggregator's robust-aggregation surface
        # (aggregator= / sanitize= / device=) — clipping runs first, then
        # the gate + robust estimator see the clipped stack
        super().__init__(dataset, task, cfg, worker_num, **agg_kw)
        if defense_type not in DEFENSES:
            # an unknown value silently running defenseless would be worse
            # than refusing
            raise ValueError(f"unknown defense_type {defense_type!r} for the "
                             "cross-process robust runtime")
        self.defense_type = defense_type
        self.accountant = None
        if defense_type == "dp":
            from fedml_tpu_torch.core.privacy import DPAccountant

            if noise_multiplier <= 0:
                raise ValueError("defense_type='dp' needs noise_multiplier "
                                 f"> 0, got {noise_multiplier}")
            self.accountant = DPAccountant()
            self._dp_z, self._dp_C = noise_multiplier, norm_bound
        self._privacy_cache = None
        self._noise_rng = prng.key(cfg.seed + 7)
        self._stddev = stddev
        self._norm_bound = norm_bound

    def aggregate(self):
        for r in list(self.model_dict):
            net_r = self._staged(self.model_dict[r])
            if self.defense_type in ("norm_diff_clipping", "weak_dp", "dp"):
                with float32_compute():
                    net_r = norm_diff_clipping(net_r, self.net,
                                               self._norm_bound)
            self.model_dict[r] = net_r
        m_received = len(self.model_dict)
        if self.defense_type == "dp":
            # uniform average: the C/m sensitivity the noise assumes does
            # not survive sample-count weighting on unbalanced data. The
            # DP argument drops the SAMPLE-COUNT half of the weight only —
            # an async flush's staleness discount still applies
            disc = self._async_discounts
            self.sample_num_dict = {
                r: (1 if disc is None else disc.get(r, 1.0))
                for r in self.sample_num_dict}
        self._aggregate_core()  # weighted average -> self.net
        if self.defense_type in ("weak_dp", "dp"):
            if self.defense_type == "dp":
                sd = self._dp_z * self._dp_C / max(m_received, 1)
                from fedml_tpu_torch.core.privacy import charge_and_record

                q = m_received / self.cfg.client_num_in_total
                wal = getattr(self, "wal", None)
                if wal is not None:
                    # WAL pre-charge, fsync'd BEFORE the noise key is
                    # drawn: a crash between charge and commit replays
                    # this record into the restarted accountant, so the
                    # reported ε is never lower than the charges incurred
                    # (a crash between the pre-charge and the noise draw
                    # over-counts one round)
                    wal.append("precharge", sync=True,
                               round=int(self.current_round),
                               q=float(q), z=float(self._dp_z),
                               clip=float(self._dp_C), m=int(m_received))
                self._privacy_cache = charge_and_record(
                    self.accountant, q, self._dp_z, self._dp_C,
                    realized_m=m_received)
            else:
                sd = self._stddev
            self._noise_rng, k = prng.split(self._noise_rng)
            self.net = add_gaussian_noise(k, self.net, sd)
        return pack_pytree(self.net, self.num_heads)

    def epsilon(self, delta: float = 1e-5) -> float:
        """Cumulative (ε, δ)-DP spent so far (defense_type='dp')."""
        if self.accountant is None:
            raise ValueError("defense_type='dp' required for accounting")
        return self.accountant.epsilon(delta)

    def privacy_record(self) -> dict | None:
        """The round record's ``privacy`` block (None outside dp mode) —
        the server manager rides it on every emitted round."""
        return self._privacy_cache


def run_simulated(dataset, task, cfg: FedAvgConfig, backend="LOOPBACK",
                  job_id="fedavg-robust-sim", base_port=50000,
                  ckpt_dir: str | None = None, chaos_plan=None,
                  round_timeout_s: float | None = None, telemetry=None,
                  device=None, **defense_kw):
    """All ranks as threads (mpirun-on-localhost analogue); returns the
    aggregator with .net / .history / .epsilon(). ``defense_kw``:
    ``defense_type``, ``norm_bound``, ``stddev``, ``noise_multiplier`` and
    the base aggregator's ``aggregator=`` / ``sanitize=``. A chaos crash
    rule naming rank 0 (it needs ``ckpt_dir``) kills the server at its
    point and a fresh one recovers through checkpoint + WAL, its
    accountant re-charged from the WAL's pre-charges
    (``run_supervised_simulated``)."""
    from fedml_tpu_torch import chaos as _chaos

    size = cfg.client_num_per_round + 1
    kw = backend_kwargs(backend, job_id, base_port)
    if chaos_plan is not None:
        _chaos.install_plan(chaos_plan)
    try:
        crash_points = server_crash_points(ckpt_dir)

        def build_server():
            agg = FedAvgRobustAggregator(dataset, task, cfg,
                                         worker_num=size - 1, device=device,
                                         **defense_kw)
            return FedAvgServerManager(agg, rank=0, size=size,
                                       backend=backend, ckpt_dir=ckpt_dir,
                                       round_timeout_s=round_timeout_s,
                                       telemetry=telemetry, **kw)

        server = build_server()
        clients = [init_client(dataset, task, cfg, r, size, backend,
                               device=device, **kw)
                   for r in range(1, size)]
        if crash_points:
            server = run_supervised_simulated(server, clients, crash_points,
                                              build_server)
        else:
            launch_simulated(server, clients)
    finally:
        if chaos_plan is not None:
            _chaos.install_plan(None)
    return server.aggregator
