"""Cross-process distributed launcher, port of
fedml_tpu/experiments/distributed_launch.py — the mpirun / fed_launch
analogue. Each party is started explicitly, with the same flags and its
own ``--rank``:

    # server, hosting the bundled MQTT broker
    python -m fedml_tpu_torch.experiments.distributed_launch --rank 0 \\
        --world_size 3 --backend mqtt --broker_port 18830 --serve_broker 1 \\
        --dataset femnist --model cnn --batch_size 20 --lr 0.1
    # clients 1..2 likewise (same flags, different --rank)

Routing: --ip_config CSV (receiver_id,ip — grpc_ipconfig.csv parity) or
everything on 127.0.0.1 by default. Rank 0 prints the eval history as one
JSON line when the job completes; the worker count must be
client_num_per_round (one process per sampled client).

Every rank runs on the CUDA device unless ``--device`` names another (the
one flag the reference lacks: the port's device rule). The reference's
other flags are accepted at their defaults; set to anything else, each
raises naming its ROADMAP.md item (``--warmup`` is accepted and does
nothing: eager PyTorch has no program to compile ahead).
"""

from __future__ import annotations

import argparse
import json
import logging
import time

# the reference's flags this slice does not run: dest -> (flag, type,
# default, ROADMAP.md queue A item). Each is parsed so a reference command
# line runs unchanged at the defaults, and refused when set.
_UNPORTED_FLAGS = {
    "algo": ("--algo", str, "fedavg", 9),
    "server_optimizer": ("--server_optimizer", str, "sgd", 9),
    "server_lr": ("--server_lr", float, 1.0, 9),
    "server_momentum": ("--server_momentum", float, 0.9, 9),
    "fedprox_mu": ("--fedprox_mu", float, 0.1, 9),
    "defense_type": ("--defense_type", str, "norm_diff_clipping", 9),
    "norm_bound": ("--norm_bound", float, 30.0, 9),
    "stddev": ("--stddev", float, 0.025, 9),
    "noise_multiplier": ("--noise_multiplier", float, 1.0, 8),
    "secagg_threshold_t": ("--secagg_threshold_t", int, None, 8),
    "secagg_quant_scale": ("--secagg_quant_scale", float, 2.0 ** 16, 8),
    "secagg_max_abs": ("--secagg_max_abs", float, 4.0, 8),
    "edges": ("--edges", int, 0, 7),
    "sum_assoc": ("--sum_assoc", str, "auto", 7),
    "ckpt_dir": ("--ckpt_dir", str, None, 8),
    "supervise": ("--supervise", int, 0, 8),
    "async_buffer_k": ("--async_buffer_k", int, None, 8),
    "staleness": ("--staleness", str, "constant", 8),
    "staleness_bound": ("--staleness_bound", int, None, 8),
    "buffer_deadline_s": ("--buffer_deadline_s", float, None, 8),
    "heartbeat_max_age_s": ("--heartbeat_max_age_s", float, None, 8),
    "aggregator": ("--aggregator", str, None, 7),
    "byzantine_f": ("--byzantine_f", int, None, 7),
    "shard_server_state": ("--shard_server_state", int, 0, 12),
    "partition_rules": ("--partition_rules", str, None, 12),
    "adversary_plan": ("--adversary_plan", str, None, 7),
    "metrics_port": ("--metrics_port", int, None, 8),
    "fleet": ("--fleet", int, 0, 8),
    "fleet_job": ("--fleet_job", str, "", 8),
    "fused_agg": ("--fused_agg", int, 0, 7),
}


def add_args(p: argparse.ArgumentParser):
    p.add_argument("--rank", type=int, required=True, help="0 = server")
    p.add_argument("--world_size", type=int, required=True,
                   help="client_num_per_round + 1")
    p.add_argument("--backend", type=str, default="grpc",
                   choices=["grpc", "loopback", "mqtt"])
    p.add_argument("--base_port", type=int, default=50000)
    p.add_argument("--ip_config", type=str, default=None,
                   help="csv receiver_id,ip (grpc_ipconfig.csv parity)")
    p.add_argument("--broker_host", type=str, default="127.0.0.1",
                   help="mqtt broker address; for multi-host --serve_broker "
                        "runs rank 0 must also widen --broker_bind")
    p.add_argument("--broker_port", type=int, default=1883)
    p.add_argument("--serve_broker", type=int, default=0,
                   help="mqtt: rank 0 also hosts the bundled loopback broker "
                        "(no external mosquitto needed)")
    p.add_argument("--broker_bind", type=str, default="127.0.0.1",
                   help="--serve_broker bind address; the bundled broker is "
                        "unauthenticated, so widen to 0.0.0.0 only on "
                        "networks where every peer is trusted")
    p.add_argument("--job_id", type=str, default=None,
                   help="mqtt: namespaces topics so jobs sharing a "
                        "persistent broker cannot cross-talk; every rank of "
                        "a job must pass the same value")
    p.add_argument("--warmup", type=int, default=1,
                   help="accepted for the reference's command line; eager "
                        "PyTorch has no program to compile ahead, so it "
                        "does nothing")
    p.add_argument("--timeout_s", type=float, default=None,
                   help="failure-detection watchdog (server logs stragglers)")
    p.add_argument("--round_timeout_s", type=float, default=None,
                   help="elastic round deadline: a round idle past this "
                        "aggregates over the clients that DID report and "
                        "moves on (dead/straggler clients are dropped; "
                        "their stale uploads are discarded by round id)")
    p.add_argument("--device", type=str, default=None,
                   help="torch device of this rank (default: the CUDA "
                        "device; with none, the launcher raises — pass "
                        "'cpu' to run on the CPU)")
    # experiment surface (subset of cli.py, same names)
    p.add_argument("--model", type=str, default="lr")
    p.add_argument("--dataset", type=str, default="mnist")
    p.add_argument("--data_dir", type=str, default=None)
    p.add_argument("--partition_method", type=str, default=None)
    p.add_argument("--partition_alpha", type=float, default=0.5)
    p.add_argument("--client_num_in_total", type=int, default=None)
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--client_optimizer", type=str, default="sgd")
    p.add_argument("--lr", type=float, default=0.03)
    p.add_argument("--wd", type=float, default=0.0)
    p.add_argument("--epochs", type=int, default=1)
    p.add_argument("--comm_round", type=int, default=10)
    p.add_argument("--frequency_of_the_test", type=int, default=5)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--ci", type=int, default=0)
    p.add_argument("--precision", type=str, default="f32",
                   choices=["f32", "bf16"],
                   help="client-compute precision policy; only f32 is "
                        "ported (bf16 raises: ROADMAP.md queue A, item 7)")
    p.add_argument("--compression", type=str, default="none",
                   choices=["none", "f16", "q8", "zlib", "f16+zlib",
                            "q8+zlib", "json"],
                   help="wire codec for outgoing frames (comm/message.py): "
                        "f16 halves float32 payloads (lossy ~1e-3 rel), q8 "
                        "quarters them (int8), zlib deflates losslessly; "
                        "json emits the reference's nested-list format; "
                        "receivers auto-detect, so ranks may mix settings")
    p.add_argument("--chaos-plan", "--chaos_plan", dest="chaos_plan",
                   type=str, default=None,
                   help="seeded fault-injection plan (fedml_tpu_torch/chaos):"
                        " a JSON file path or inline JSON with {seed, rules}"
                        " — frame drop/delay/duplicate/reorder/corrupt/"
                        "partition + rank crash/straggle schedules, "
                        "deterministic per seed. Pass the SAME plan to every "
                        "rank; pair with --round_timeout_s so injected "
                        "losses degrade elastically")
    p.add_argument("--telemetry-dir", "--telemetry_dir", dest="telemetry_dir",
                   type=str, default=None,
                   help="rank 0: write the structured run telemetry here — "
                        "events.jsonl (run header + per-round records: "
                        "sampled ids, span timings, update norm, comm "
                        "byte/message counters) and a Prometheus text dump "
                        "at exit")
    p.add_argument("--trace-dir", "--trace_dir", dest="trace_dir",
                   type=str, default=None,
                   help="rank 0: enable cross-rank distributed tracing "
                        "(obs/tracing.py) and write the stitched per-round "
                        "timeline here as Chrome trace-event JSON "
                        "(trace.json). Implies telemetry; clients need no "
                        "flag — trace context propagates in the message "
                        "headers")
    p.add_argument("--sparsify_ratio", "--sparsify-ratio",
                   dest="sparsify_ratio", type=float, default=None,
                   help="top-k sparsified uplinks with error feedback "
                        "(comm/sparse.py): ship only this fraction of the "
                        "model delta per upload; 1.0 = exact dense "
                        "equivalence, unset = dense protocol")
    p.add_argument("--update_codec", "--update-codec", dest="update_codec",
                   type=str, default=None,
                   choices=["dense", "delta", "delta-int8", "delta-sign1"],
                   help="delta/quantized uplink tier (comm/delta.py): "
                        "clients upload local - global@version; "
                        "'delta-int8' quantizes it to deadzoned int8 "
                        "(+deflate), 'delta-sign1' to 1-bit scaled sign, "
                        "both with client-side error feedback. Mutually "
                        "exclusive with --sparsify_ratio")
    p.add_argument("--delta_broadcast", "--delta-broadcast",
                   dest="delta_broadcast", type=int, default=0,
                   help="rank 0: broadcast global@r - global@r-1 to warm "
                        "clients (ranks whose last upload proved they "
                        "hold r-1) with a dense fallback for the others; "
                        "delta payloads ride the frame lossless, so pair "
                        "with --compression zlib, not f16/q8")
    p.add_argument("--error_feedback", "--error-feedback",
                   dest="error_feedback", type=int, default=1,
                   help="client-side error-feedback residual for the "
                        "lossy uplink tiers (comm/ef.py); 0 is the "
                        "convergence-ablation knob, never the production "
                        "setting")
    for dest, (flag, kind, default, item) in _UNPORTED_FLAGS.items():
        # the reference takes most of these in both spellings
        names = [flag] + ([flag.replace("_", "-")] if "_" in flag else [])
        p.add_argument(*names, dest=dest, type=kind, default=default,
                       help=f"not ported yet (ROADMAP.md queue A, item "
                            f"{item}); raises unless left at {default!r}")
    return p


def refuse_unported_flags(args) -> None:
    """Raise NotImplementedError for the first reference flag set off its
    default, naming its ROADMAP.md item."""
    for dest, (flag, _, default, item) in _UNPORTED_FLAGS.items():
        if getattr(args, dest) != default:
            raise NotImplementedError(
                f"{flag}={getattr(args, dest)!r} is not ported yet: "
                f"ROADMAP.md queue A, item {item}")


def _drain_broker(broker, timeout_s: float = 60.0) -> None:
    """Keep the bundled broker serving until every client has disconnected
    (a client does once FINISH reached it): closing it with the server
    would cut off the FINISH frames still in flight and leave the clients
    waiting forever."""
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        with broker._lock:
            if not broker._socks:
                return
        time.sleep(0.05)
    logging.getLogger("fedml_tpu_torch.launch").warning(
        "closing the MQTT broker with clients still connected after %.0f s",
        timeout_s)


def main(argv=None):
    args = add_args(argparse.ArgumentParser(
        "fedml_tpu_torch.distributed")).parse_args(argv)
    logging.basicConfig(
        level=logging.INFO,
        format=f"%(asctime)s rank{args.rank} %(name)s %(levelname)s %(message)s",
    )
    refuse_unported_flags(args)
    from fedml_tpu_torch.device import resolve_device

    device = resolve_device(args.device)

    # unconditional: an explicit --compression none must also OVERRIDE a
    # codec inherited from the FEDML_COMM_CODEC env var
    from fedml_tpu_torch.comm.message import set_wire_codec

    set_wire_codec(args.compression)

    if args.chaos_plan:
        from fedml_tpu_torch import chaos

        plan = chaos.FaultPlan.from_spec(args.chaos_plan)
        chaos.install_plan(plan)
        logging.getLogger("fedml_tpu_torch.launch").warning(
            "CHAOS plan installed (seed=%d, %d rules) — faults will be "
            "injected on purpose", plan.seed, len(plan.rules))

    from fedml_tpu_torch.algorithms.fedavg import FedAvgConfig
    from fedml_tpu_torch.core.tasks import classification_task, sequence_task
    from fedml_tpu_torch.data.registry import DATASETS, load_dataset
    from fedml_tpu_torch.distributed.fedavg.api import init_client, init_server
    from fedml_tpu_torch.models import create_model

    spec = DATASETS[args.dataset]
    data = load_dataset(
        args.dataset, data_dir=args.data_dir, client_num=args.client_num_in_total,
        partition_method=args.partition_method, partition_alpha=args.partition_alpha,
        seed=args.seed,
    )
    if spec.task not in ("classification", "sequence"):
        raise NotImplementedError(f"{spec.task} tasks are not ported yet: "
                                  "ROADMAP.md queue A, item 9")
    model = create_model(args.model, output_dim=spec.num_classes,
                         device=device)
    task = {"classification": classification_task,
            "sequence": sequence_task}[spec.task](model)
    n_total = data.num_clients
    n_workers = args.world_size - 1
    if n_workers < 1:
        raise ValueError(f"--world_size {args.world_size} leaves no worker "
                         "ranks after the server")
    if args.rank != 0 and n_workers == n_total:
        # full participation: rank r always trains client r-1, so this
        # process keeps only its own shard (load_partition_data_distributed_*
        # parity — the reference's per-rank loaders, cifar10/data_loader.py:433)
        from fedml_tpu_torch.core.client_data import subset_clients

        data = subset_clients(data, [args.rank - 1])
    cfg = FedAvgConfig(
        comm_round=args.comm_round, client_num_in_total=n_total,
        client_num_per_round=n_workers, epochs=args.epochs,
        batch_size=args.batch_size, client_optimizer=args.client_optimizer,
        lr=args.lr, wd=args.wd, frequency_of_the_test=args.frequency_of_the_test,
        seed=args.seed, ci=bool(args.ci),
        eval_max_samples=(10_000 if args.dataset.startswith("stackoverflow")
                          else None),
        precision=args.precision,
    )

    backend_kw: dict = {"timeout_s": args.timeout_s}
    broker = None
    if args.backend == "grpc":
        backend_kw.update(base_port=args.base_port, ip_table=args.ip_config)
    elif args.backend == "mqtt":
        backend_kw.update(broker_host=args.broker_host,
                          broker_port=args.broker_port, job_id=args.job_id)
        if args.serve_broker and args.rank == 0:
            from fedml_tpu_torch.comm.mqtt_mini import MiniMqttBroker

            broker = MiniMqttBroker(host=args.broker_bind, port=args.broker_port)
            logging.getLogger("fedml_tpu_torch.launch").info(
                "serving MQTT broker on %s:%d", args.broker_bind, broker.port)
    else:
        backend_kw.update(job_id="launch")

    backend = args.backend.upper()
    telemetry = None
    if args.rank == 0:
        if args.telemetry_dir or args.trace_dir:
            from fedml_tpu_torch.obs.telemetry import Telemetry

            # --trace-dir alone implies telemetry: the event log (with the
            # critical-path round records) lands next to trace.json
            telemetry = Telemetry(log_dir=args.telemetry_dir or args.trace_dir,
                                  trace_dir=args.trace_dir)
        mgr = init_server(data, task, cfg, args.world_size, backend,
                          device=device, round_timeout_s=args.round_timeout_s,
                          delta_broadcast=bool(args.delta_broadcast),
                          telemetry=telemetry, **backend_kw)
    else:
        mgr = init_client(data, task, cfg, args.rank, args.world_size,
                          backend, device=device,
                          sparsify_ratio=args.sparsify_ratio or None,
                          update_codec=args.update_codec,
                          error_feedback=bool(args.error_feedback),
                          **backend_kw)
    try:
        mgr.run()
        if broker is not None:
            _drain_broker(broker)
    finally:
        if telemetry is not None:
            telemetry.close()
        if broker is not None:
            broker.close()
    if args.chaos_plan:
        from fedml_tpu_torch import chaos

        plan = chaos.active_plan()
        if plan is not None:
            logging.getLogger("fedml_tpu_torch.launch").info(
                "chaos: %d faults injected %s", len(plan.ledger),
                plan.ledger.counts())
    if args.rank == 0:
        # stdout IS this CLI's interface: the launching script parses the
        # final eval-history JSON from it
        print(json.dumps(mgr.aggregator.history, default=float))


if __name__ == "__main__":
    main()
