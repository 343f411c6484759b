"""Distributed FedAvg entry, port of fedml_tpu/distributed/fedavg/api.py:
rank dispatch + the in-process simulation helper, flat or (``edges=``)
the hierarchical 2-tier topology of hierarchy.py.

Mirror of fedml_api/distributed/fedavg/FedAvgAPI.py:13-75: rank 0 becomes
the server (aggregator + server manager), rank k the client (trainer +
client manager). ``run_simulated`` stands in for mpirun: it launches all
ranks as threads over the loopback (or localhost gRPC / MQTT) backend.

Every entry point runs on the CUDA device unless ``device`` says otherwise
(``device="cpu"``), and raises with no CUDA device and no such request.
The reference's options this slice does not run raise NotImplementedError
naming their ROADMAP.md item; ``warmup`` is accepted and does nothing
(see DistributedTrainer.warmup). Chaos crash rules naming rank 0 run under
``run_supervised_simulated``: the server is killed at its crash point and
a fresh one recovers through checkpoint + WAL.
"""

from __future__ import annotations

import logging

from fedml_tpu_torch.algorithms.fedavg import FedAvgConfig
from fedml_tpu_torch.core.client_data import FederatedData
from fedml_tpu_torch.core.local import Task
from fedml_tpu_torch.distributed.fedavg.aggregator import (
    FedAvgAggregator,
    refuse_unported,
)
from fedml_tpu_torch.distributed.fedavg.client_manager import FedAvgClientManager
from fedml_tpu_torch.distributed.fedavg.server_manager import (
    FedAvgServerManager,
    SimulatedServerCrash,
)
from fedml_tpu_torch.distributed.fedavg.trainer import DistributedTrainer
from fedml_tpu_torch.distributed.utils import backend_kwargs, launch_simulated

log = logging.getLogger("fedml_tpu_torch.distributed.fedavg")


def init_server(dataset, task, cfg, size, backend, device=None,
                agg_kw: dict | None = None, **kw):
    """The server rank: ``agg_kw`` goes to the FedAvgAggregator (its
    ``aggregator`` / ``aggregator_params`` / ``sanitize`` / ``sum_assoc``),
    ``kw`` to the server manager."""
    aggregator = FedAvgAggregator(dataset, task, cfg, worker_num=size - 1,
                                  device=device, **(agg_kw or {}))
    return FedAvgServerManager(aggregator, rank=0, size=size, backend=backend, **kw)


def init_client(dataset, task, cfg, rank, size, backend, local_spec=None,
                device=None, **kw):
    trainer = DistributedTrainer(rank, dataset, task, cfg,
                                 local_spec=local_spec, device=device)
    return FedAvgClientManager(trainer, rank=rank, size=size, backend=backend, **kw)


def FedML_FedAvg_distributed(
    process_id: int,
    worker_number: int,
    dataset: FederatedData,
    task: Task,
    cfg: FedAvgConfig,
    backend: str = "GRPC",
    device=None,
    **backend_kw,
):
    """Launch this process's role and block until the job finishes.

    Returns the manager (server manager exposes .aggregator.history/.net).
    """
    if process_id == 0:
        mgr = init_server(dataset, task, cfg, worker_number, backend,
                          device=device, **backend_kw)
    else:
        mgr = init_client(dataset, task, cfg, process_id, worker_number,
                          backend, device=device, **backend_kw)
    mgr.run()
    return mgr


def run_simulated(
    dataset: FederatedData,
    task: Task,
    cfg: FedAvgConfig,
    backend: str = "LOOPBACK",
    job_id: str = "fedavg-sim",
    base_port: int = 50000,
    ckpt_dir: str | None = None,
    broker_host: str = "127.0.0.1",
    broker_port: int = 1883,
    sparsify_ratio: float | None = None,
    update_codec: str | None = None,
    error_feedback: bool = True,
    delta_broadcast: bool = False,
    telemetry=None,
    chaos_plan=None,
    round_timeout_s: float | None = None,
    aggregator: str | None = None,
    aggregator_params: dict | None = None,
    sanitize: bool | float | None = None,
    adversary_plan=None,
    warmup: bool = False,
    shard_server_state: bool = False,
    partition_rules=None,
    async_buffer_k: int | None = None,
    staleness="constant",
    staleness_bound: int | None = None,
    buffer_deadline_s: float | None = None,
    buffer_capacity: int | None = None,
    heartbeat_max_age_s: float | None = None,
    sum_assoc: str = "auto",
    edges: int | None = None,
    fused_agg: bool = False,
    churn_trace=None,
    device=None,
) -> FedAvgAggregator:
    """All ranks as threads on one host — the mpirun-on-localhost analogue:
    1 server rank + ``cfg.client_num_per_round`` client ranks, every frame
    through the real wire path of ``backend``. Returns the server's
    aggregator (``.net``, ``.history``, ``.quarantine``).

    ``chaos_plan``: a ``fedml_tpu_torch.chaos.FaultPlan`` installed for the
    duration of the run — every rank's comm manager is wrapped in the
    deterministic fault injector (drops/dups/corruption/partitions per the
    plan's seeded schedule). Pair with ``round_timeout_s`` so dropped
    uplinks degrade to elastic partial aggregation instead of a hang. A
    crash rule naming rank 0 is a supervised server restart (it needs
    ``ckpt_dir``): the server is killed at the scheduled point and a
    fresh one recovers through checkpoint + WAL while the clients run on
    (``run_supervised_simulated``).

    ``ckpt_dir``: checkpoint after every aggregate (the npz layout the
    JAX package reads too) and journal the round lifecycle to the durable
    WAL at ``<ckpt_dir>/wal``; a server booted on it resumes the job.

    ``adversary_plan``: a ``fedml_tpu_torch.chaos.AdversaryPlan`` — the
    listed worker ranks upload model-space attacks on their scheduled
    rounds; pair with ``aggregator=`` ('median', 'krum', ...,
    ``aggregator_params`` such as ``{"f": 2}``), the ``sanitize`` gate and
    ``sum_assoc`` ('pairwise' with an aggregator: the two-phase
    evidence/verdict composition) for a replayable attack-vs-defense run;
    the verdicts land in the returned aggregator's ``quarantine``.

    ``update_codec``: delta/quantized uplink tier ('delta' | 'delta-int8'
    | 'delta-sign1', comm/delta.py) with client-side error feedback
    (``error_feedback=False`` is the convergence-ablation knob only);
    ``sparsify_ratio``: top-k uplinks (comm/sparse.py). ``delta_broadcast``:
    round-delta downlinks to warm clients with a dense fallback for the
    others. ``telemetry``: an ``obs.Telemetry`` bundle the server emits its
    round records (and, when it traces, the stitched cross-rank timeline)
    into.

    ``async_buffer_k``: buffered-async rounds — the server aggregates as
    soon as K sanitized arrivals are staged (or ``buffer_deadline_s``
    fires), weighting each by the ``staleness`` discount ('constant' |
    'poly:A' | 'exp:A'); ``staleness_bound`` rejects-and-requeues staler
    updates (bound 0 = the synchronous barrier expressed async: bitwise
    the sync run at K = cohort); ``buffer_capacity`` bounds the staging
    queue (overflow sheds the stalest, never blocks).
    ``heartbeat_max_age_s`` arms heartbeat-driven cohort admission (sync
    AND async: silent ranks are excluded until a reprobe brings them
    back).

    ``edges``: the hierarchical 2-tier topology (hierarchy.py): 1 root +
    ``edges`` edge aggregator ranks + the workers, root fan-in O(edges),
    bitwise the flat ``sum_assoc='pairwise'`` run; ``aggregator=`` /
    ``sanitize=`` arm its two-phase cross-tier gating. Returns the root's
    aggregator (also ``.fanin_history``).

    ``fused_agg``: fused on-device ingest (core/fused_agg.py): each upload
    is densified, gated and folded on the server's device as it arrives
    (with ``edges``, on the edges' devices), bitwise the stacked
    ``sum_assoc='pairwise'`` run.

    Each option the port does not run yet raises in the constructor it is
    passed to."""
    if edges:
        # the dense synchronous protocol is the tree's contract: these
        # modes are not wired through the edge tier
        unsupported = {
            "sparsify_ratio": sparsify_ratio, "update_codec": update_codec,
            "delta_broadcast": delta_broadcast or None,
            "async_buffer_k": async_buffer_k,
            "shard_server_state": shard_server_state or None,
            "heartbeat_max_age_s": heartbeat_max_age_s,
            "sum_assoc": None if sum_assoc == "auto" else sum_assoc,
            # the async buffer's knobs: the tree is synchronous
            "staleness": None if staleness == "constant" else staleness,
            "staleness_bound": staleness_bound,
            "buffer_deadline_s": buffer_deadline_s,
            "buffer_capacity": buffer_capacity,
        }
        bad = [k for k, v in unsupported.items() if v is not None]
        if bad:
            raise ValueError(
                f"edges={edges} (hierarchical topology) does not compose "
                f"with {bad} — run the flat topology for those modes "
                "(tree aggregation is pairwise by construction)")
        if churn_trace is not None:
            raise ValueError(
                "churn_trace= here is RANK-level scheduled availability, "
                "and the tree's edge/worker ranks are infrastructure "
                "slots, not devices — drive client-level churn through "
                "cfg.churn_trace (cohort sampling), which composes with "
                "edges")
        refuse_unported("run_simulated(edges=)", {
            "partition_rules": (partition_rules is not None, 12)})
        from fedml_tpu_torch.distributed.fedavg.hierarchy import (
            run_simulated_hierarchical,
        )

        return run_simulated_hierarchical(
            dataset, task, cfg, edges=edges, backend=backend,
            job_id=job_id, base_port=base_port, broker_host=broker_host,
            broker_port=broker_port, ckpt_dir=ckpt_dir,
            telemetry=telemetry, chaos_plan=chaos_plan,
            round_timeout_s=round_timeout_s, adversary_plan=adversary_plan,
            warmup=warmup, aggregator=aggregator,
            aggregator_params=aggregator_params, sanitize=sanitize,
            fused_agg=fused_agg, device=device)
    from fedml_tpu_torch import chaos as _chaos

    size = cfg.client_num_per_round + 1
    kw = backend_kwargs(backend, job_id, base_port, broker_host, broker_port)
    if chaos_plan is not None:  # None must not clobber an installed plan
        _chaos.install_plan(chaos_plan)
    try:
        # chaos crash rules naming RANK 0 are server restarts: this driver
        # executes them deterministically — kill the manager at the
        # scheduled point (SimulatedServerCrash, a SIGKILL analogue: no
        # farewell frames, no graceful saves) and boot a FRESH manager
        # through the real checkpoint + WAL recovery path
        crash_points = server_crash_points(ckpt_dir)

        def build_server():
            agg = FedAvgAggregator(dataset, task, cfg, worker_num=size - 1,
                                   aggregator=aggregator,
                                   aggregator_params=aggregator_params,
                                   sanitize=sanitize,
                                   shard_server_state=shard_server_state,
                                   partition_rules=partition_rules,
                                   sum_assoc=sum_assoc, fused_agg=fused_agg,
                                   device=device)
            return FedAvgServerManager(
                agg, rank=0, size=size, backend=backend, ckpt_dir=ckpt_dir,
                round_timeout_s=round_timeout_s, telemetry=telemetry,
                async_buffer_k=async_buffer_k, staleness=staleness,
                staleness_bound=staleness_bound,
                buffer_deadline_s=buffer_deadline_s,
                buffer_capacity=buffer_capacity,
                heartbeat_max_age_s=heartbeat_max_age_s,
                delta_broadcast=delta_broadcast, churn_trace=churn_trace,
                **kw)

        server = build_server()
        clients = [
            init_client(dataset, task, cfg, rank, size, backend,
                        device=device, sparsify_ratio=sparsify_ratio,
                        update_codec=update_codec,
                        error_feedback=error_feedback,
                        adversary_plan=adversary_plan, **kw)
            for rank in range(1, size)
        ]
        if warmup and clients:
            clients[0].warmup()
        if crash_points:
            server = run_supervised_simulated(server, clients,
                                              crash_points, build_server)
        else:
            launch_simulated(server, clients)
    finally:
        if chaos_plan is not None:
            _chaos.install_plan(None)
    return server.aggregator


def server_crash_points(ckpt_dir) -> list:
    """The installed chaos plan's rank-0 crash schedule (``[(round,
    after_uploads)]``, empty without a plan), checked against what the
    supervision loop can run: recovery needs ``ckpt_dir``. The mid-reveal
    point (``after_uploads=-1``) fires only on the masked tier
    (distributed/turboaggregate.py), which has a reveal fan-out."""
    from fedml_tpu_torch import chaos as _chaos

    active = _chaos.active_plan()
    points = active.server_crash_points() if active is not None else []
    if points and ckpt_dir is None:
        raise ValueError(
            "a chaos crash rule naming rank 0 (server restart) needs "
            "ckpt_dir= — recovery replays checkpoint + WAL")
    return points


def run_supervised_simulated(server, clients, crash_points, build_server,
                             join_timeout: float = 60.0):
    """Loopback supervision loop: run the server until a scheduled
    SimulatedServerCrash fires, abandon the dead manager's transport
    WITHOUT any farewell frame (clients observe exactly the silence a dead
    process leaves), and boot a fresh manager — fresh aggregator, fresh
    memory — that recovers through checkpoint + WAL. Each crash point is
    consumed by one kill; the recovered server does not re-crash on it.
    Clients run once, spanning every server generation (they survive the
    outage and answer the resume probe). Returns the last server."""
    import threading

    threads = [threading.Thread(target=c.run, daemon=True) for c in clients]
    for t in threads:
        t.start()
    remaining = list(crash_points)
    while True:
        server._crash_plan = list(remaining)
        try:
            server.run()
        except SimulatedServerCrash as e:
            remaining = remaining[1:]
            log.warning("supervisor: %s — abandoning the dead manager and "
                        "restarting through recovery (%d scheduled "
                        "crash(es) left)", e, len(remaining))
            abandon_simulated_server(server)
            server = build_server()
            continue
        if remaining:
            # the campaign finished with scheduled kills never fired (e.g.
            # an elastic round accepted fewer uploads than the
            # after_uploads threshold) — say so loudly, or a run 'passes'
            # a recovery path that was never exercised
            log.warning("supervisor: run completed with %d scheduled "
                        "crash point(s) never fired: %s — the recovery "
                        "path was NOT exercised", len(remaining),
                        remaining)
        break
    for t in threads:
        t.join(timeout=join_timeout)
    return server


def abandon_simulated_server(server) -> None:
    """SIGKILL analogue for an in-process server manager: free its
    transport registration so the next generation can bind rank 0, close
    its journal handle (post-mortem appends become no-ops), and flag it
    finished so its timers/watchdog exit. Sends NOTHING — a dead process
    says no goodbyes."""
    server._finished.set()
    try:
        cm = server.com_manager
        inner = getattr(cm, "inner", cm)  # unwrap a chaos proxy
        inner.stop_receive_message()
    except Exception:  # noqa: BLE001 — teardown of a "dead" manager must
        # not kill the supervisor; the next boot re-binds rank 0 anyway
        log.warning("supervisor: abandoning dead server transport failed",
                    exc_info=True)
    if server.wal is not None:
        server.wal.close()
