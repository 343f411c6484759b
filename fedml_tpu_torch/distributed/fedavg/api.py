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
(see DistributedTrainer.warmup).
"""

from __future__ import annotations

from fedml_tpu_torch.algorithms.fedavg import FedAvgConfig
from fedml_tpu_torch.core.client_data import FederatedData
from fedml_tpu_torch.core.local import Task
from fedml_tpu_torch.distributed.fedavg.aggregator import (
    FedAvgAggregator,
    refuse_unported,
)
from fedml_tpu_torch.distributed.fedavg.client_manager import FedAvgClientManager
from fedml_tpu_torch.distributed.fedavg.server_manager import FedAvgServerManager
from fedml_tpu_torch.distributed.fedavg.trainer import DistributedTrainer
from fedml_tpu_torch.distributed.utils import backend_kwargs, launch_simulated


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
    crash rule naming rank 0 (a server restart) needs the checkpoint and
    WAL recovery path, which is not ported yet.

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

    ``edges``: the hierarchical 2-tier topology (hierarchy.py): 1 root +
    ``edges`` edge aggregator ranks + the workers, root fan-in O(edges),
    bitwise the flat ``sum_assoc='pairwise'`` run; ``aggregator=`` /
    ``sanitize=`` arm its two-phase cross-tier gating. Returns the root's
    aggregator (also ``.fanin_history``).

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
            "fused_agg": (bool(fused_agg), 7),
            "partition_rules": (partition_rules is not None, 12),
            "staleness": (staleness != "constant", 8),
            "staleness_bound": (staleness_bound is not None, 8),
            "buffer_deadline_s": (buffer_deadline_s is not None, 8),
            "buffer_capacity": (buffer_capacity is not None, 8)})
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
            device=device)
    from fedml_tpu_torch import chaos as _chaos

    size = cfg.client_num_per_round + 1
    kw = backend_kwargs(backend, job_id, base_port, broker_host, broker_port)
    if chaos_plan is not None:  # None must not clobber an installed plan
        _chaos.install_plan(chaos_plan)
    try:
        active = _chaos.active_plan()
        if active is not None and active.server_crash_points():
            raise NotImplementedError(
                "a chaos crash rule naming rank 0 (a server restart) needs "
                "checkpoint + WAL recovery, not ported yet: ROADMAP.md "
                "queue A, item 8")
        agg = FedAvgAggregator(dataset, task, cfg, worker_num=size - 1,
                               aggregator=aggregator,
                               aggregator_params=aggregator_params,
                               sanitize=sanitize,
                               shard_server_state=shard_server_state,
                               partition_rules=partition_rules,
                               sum_assoc=sum_assoc, fused_agg=fused_agg,
                               device=device)
        server = FedAvgServerManager(agg, rank=0, size=size, backend=backend,
                                     ckpt_dir=ckpt_dir,
                                     round_timeout_s=round_timeout_s,
                                     telemetry=telemetry,
                                     async_buffer_k=async_buffer_k,
                                     staleness=staleness,
                                     staleness_bound=staleness_bound,
                                     buffer_deadline_s=buffer_deadline_s,
                                     buffer_capacity=buffer_capacity,
                                     heartbeat_max_age_s=heartbeat_max_age_s,
                                     delta_broadcast=delta_broadcast,
                                     churn_trace=churn_trace, **kw)
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
        launch_simulated(server, clients)
    finally:
        if chaos_plan is not None:
            _chaos.install_plan(None)
    return agg
