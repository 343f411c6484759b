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
client_num_per_round (one process per sampled client). With ``--edges E``
ranks 1..E are edge aggregators and the workers follow them
(distributed/fedavg/hierarchy.py). ``--algo fedavg_robust`` runs the
robust / accounted-DP server (distributed/fedavg_robust.py) with
``--defense_type``, ``--norm_bound``, ``--stddev`` and
``--noise_multiplier``; ``--algo turboaggregate`` the masked secure tier
(distributed/turboaggregate.py: ``--secagg_threshold_t``,
``--secagg_quant_scale``, ``--secagg_max_abs``, ``--defense_type dp`` for
DP on the masked path, flat or with ``--edges``; ``--fused_agg`` is
accepted there as the reference's spelling: the masked fold always runs
on the server's device); every other ``--algo`` raises naming its item.
``--fused_agg 1`` arms fused on-device ingest (core/fused_agg.py) on the
server, or with ``--edges`` on the edges; ``--precision bf16`` the bf16
client-compute policy on every rank.

Every rank runs on the CUDA device unless ``--device`` names another (the
one flag the reference lacks: the port's device rule). The reference's
other flags are accepted at their defaults; set to anything else, each
raises naming its ROADMAP.md item. ``--warmup 1`` (the default) runs
each client rank's fit once on an all-masked batch before the first
broadcast (DistributedTrainer.warmup).
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
    "server_optimizer": ("--server_optimizer", str, "sgd", 9),
    "server_lr": ("--server_lr", float, 1.0, 9),
    "server_momentum": ("--server_momentum", float, 0.9, 9),
    "fedprox_mu": ("--fedprox_mu", float, 0.1, 9),
    "shard_server_state": ("--shard_server_state", int, 0, 12),
    "partition_rules": ("--partition_rules", str, None, 12),
}


# the algorithms this launcher runs; any other --algo raises naming
# ROADMAP.md queue A item 9
_ALGOS = ("fedavg", "fedavg_robust", "turboaggregate")


def add_args(p: argparse.ArgumentParser):
    p.add_argument("--rank", type=int, required=True, help="0 = server")
    p.add_argument("--algo", type=str, default="fedavg",
                   help="fedavg | fedavg_robust (the robust / accounted-DP "
                        "server) | turboaggregate (masked secure "
                        "aggregation); the reference's others are not "
                        "ported yet (ROADMAP.md queue A, item 9)")
    p.add_argument("--defense_type", type=str, default="norm_diff_clipping",
                   help="--algo fedavg_robust: norm_diff_clipping | "
                        "weak_dp | dp (accounted DP-FedAvg) | none")
    p.add_argument("--norm_bound", type=float, default=30.0,
                   help="the clip radius C")
    p.add_argument("--stddev", type=float, default=0.025,
                   help="weak_dp's noise standard deviation")
    p.add_argument("--noise_multiplier", type=float, default=1.0,
                   help="z for --defense_type dp: noise N(0, (z*C/m)^2) on "
                        "the m-client uniform average, cumulative (eps, "
                        "delta) by an RDP accountant")
    # masked secure aggregation (--algo turboaggregate)
    p.add_argument("--secagg_threshold_t", "--secagg-threshold-t",
                   dest="secagg_threshold_t", type=int, default=None,
                   help="turboaggregate: Shamir threshold t — decoding "
                        "any round needs >= t+1 surviving cohort slots; "
                        "below that the round sheds + re-broadcasts "
                        "(default: min(2, cohort-1))")
    p.add_argument("--secagg_quant_scale", "--secagg-quant-scale",
                   dest="secagg_quant_scale", type=float, default=2**16,
                   help="turboaggregate: fixed-point scale quantizing "
                        "updates into GF(2^31-1); construction refuses "
                        "cohorts that would wrap the field "
                        "(collectives/finite_field.assert_field_capacity)")
    p.add_argument("--secagg_max_abs", "--secagg-max-abs",
                   dest="secagg_max_abs", type=float, default=4.0,
                   help="turboaggregate: promised bound on any masked "
                        "update coordinate (the field-capacity guard's "
                        "max|w|); DP mode uses --norm_bound instead")
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
                   help="client ranks run their fit once on an all-masked "
                        "batch at the population's common depths before "
                        "the first broadcast (0: the first round pays it)")
    p.add_argument("--fused_agg", "--fused-agg", dest="fused_agg", type=int,
                   default=0,
                   help="fused on-device server aggregation (core/"
                        "fused_agg.py): uploads densify, gate and fold on "
                        "the device as they arrive (implies sum_assoc "
                        "pairwise; robust estimators / armed sanitize run "
                        "the staged fused mode; with --edges the edges "
                        "ingest); under --algo turboaggregate the masked "
                        "fold always runs on the device")
    p.add_argument("--timeout_s", type=float, default=None,
                   help="failure-detection watchdog (server logs stragglers)")
    p.add_argument("--round_timeout_s", type=float, default=None,
                   help="elastic round deadline: a round idle past this "
                        "aggregates over the clients that DID report and "
                        "moves on (dead/straggler clients are dropped; "
                        "their stale uploads are discarded by round id)")
    p.add_argument("--ckpt_dir", type=str, default=None,
                   help="server round checkpoints; restart resumes the job "
                        "(also arms the durable round WAL at "
                        "<ckpt_dir>/wal)")
    p.add_argument("--supervise", type=int, default=0, metavar="N",
                   help="rank 0: run the server as a SUPERVISED child "
                        "process and restart it up to N times when it "
                        "dies (SIGKILL, crash, OOM). The child recovers "
                        "through checkpoint + WAL (requires --ckpt_dir); "
                        "clients survive the outage and answer the "
                        "restarted server's resume probe. The child pid is "
                        "published at <ckpt_dir>/server.pid. 0 = run "
                        "in-process (default)")
    p.add_argument("--async_buffer_k", "--async-buffer-k",
                   dest="async_buffer_k", type=int, default=None,
                   help="rank 0: buffered-async rounds — no round barrier; "
                        "clients train continuously and the server "
                        "aggregates every K sanitized arrivals with "
                        "staleness-discounted weights, so stragglers "
                        "degrade throughput instead of serializing the "
                        "fleet. K = cohort with --staleness_bound 0 is "
                        "bitwise the synchronous path. Unset = the "
                        "synchronous barrier")
    p.add_argument("--staleness", type=str, default="constant",
                   help="async staleness discount: 'constant' | 'poly:A' "
                        "((1+s)^-A) | 'exp:A' (e^-As) "
                        "(core/async_buffer.py)")
    p.add_argument("--staleness_bound", "--staleness-bound",
                   dest="staleness_bound", type=int, default=None,
                   help="async admission bound: reject-and-requeue updates "
                        "staler than this many global updates (0 = the "
                        "synchronous barrier expressed async; unset = "
                        "admit any staleness, discount-only)")
    p.add_argument("--buffer_deadline_s", "--buffer-deadline-s",
                   dest="buffer_deadline_s", type=float, default=None,
                   help="async: flush a partially-filled buffer after this "
                        "many seconds from its first arrival (the async "
                        "analogue of --round_timeout_s)")
    p.add_argument("--heartbeat_max_age_s", "--heartbeat-max-age-s",
                   dest="heartbeat_max_age_s", type=float, default=None,
                   help="heartbeat-driven cohort admission (sync AND "
                        "async): exclude ranks whose "
                        "fed_last_heartbeat_age_seconds exceeds this from "
                        "the cohort, with a periodic reprobe so a resumed "
                        "rank rejoins")
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
                   help="client-compute precision policy: bf16 fits on "
                        "bf16 casts of the f32 masters (core/local.py)")
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
    p.add_argument("--metrics_port", "--metrics-port", dest="metrics_port",
                   type=int, default=None, metavar="PORT",
                   help="every rank: serve live /metrics (Prometheus text) "
                        "+ /healthz (JSON run health) over HTTP. Each rank "
                        "binds PORT + rank so one flag covers a single-host "
                        "launch; PORT 0 binds an ephemeral port per rank "
                        "(logged, and in rank 0's run header). Rank 0 "
                        "serves the full health verdict (obs/health.py "
                        "rule table + memory telemetry); client ranks "
                        "serve their process registry")
    p.add_argument("--fleet", type=int, default=0,
                   help="arm the fleet observability plane (obs/fleet.py):"
                        " every uplink piggybacks a compact per-rank digest "
                        "(round/wave, counter deltas, phase-timing sketch, "
                        "ε, memory) and rank 0 serves the merged per-rank "
                        "view as /fleetz. Implies telemetry on rank 0; "
                        "without an explicit --metrics_port rank 0 binds an "
                        "ephemeral HTTP port (logged + in the run header) "
                        "and client ranks run no HTTP server — the in-band "
                        "rollup is their export path. Every rank also arms "
                        "a crash flight recorder (dumps under "
                        "<telemetry-dir|ckpt-dir>/flightrec)")
    p.add_argument("--fleet_job", "--fleet-job", dest="fleet_job",
                   type=str, default="",
                   help="optional job label namespacing the fleet rollup "
                        "metric families (the reserved 'job' label on "
                        "fed_fleet_*)")
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
    p.add_argument("--aggregator", type=str, default=None,
                   choices=["mean", "median", "trimmed_mean", "krum",
                            "multi_krum", "geometric_median"],
                   help="rank 0: Byzantine-robust aggregation strategy "
                        "(core/robust_agg.py) replacing the weighted mean, "
                        "fronted by the sanitation gate (non-finite + "
                        "norm-outlier rejection with survivor reweighting; "
                        "rejections land in the quarantine ledger / "
                        "fed_updates_rejected_total)")
    p.add_argument("--byzantine_f", "--byzantine-f", dest="byzantine_f",
                   type=int, default=None,
                   help="Byzantine budget f for krum/multi_krum/"
                        "trimmed_mean (default (n-3)//2; krum needs "
                        "n >= 2f+3)")
    p.add_argument("--edges", type=int, default=0,
                   help="hierarchical 2-tier topology (distributed/fedavg/"
                        "hierarchy.py): ranks 1..E become EDGE AGGREGATORS "
                        "that fold their worker block's gated uplinks and "
                        "forward ONE pre-aggregated update each, so root "
                        "fan-in is O(edges), bitwise the flat run under "
                        "--sum_assoc pairwise. Pair with --aggregator to "
                        "arm two-phase cross-tier robust gating (edges "
                        "forward per-client evidence, the root returns "
                        "verdict frames, edges fold only the survivors). "
                        "Workers are ranks E+1..world_size-1; the per-edge "
                        "block size (workers/edges) must be a power of "
                        "two. 0 = flat (default). With --algo "
                        "turboaggregate: the hierarchical masked tier "
                        "(edge-local reveal recovery, one unmasked field "
                        "partial an edge)")
    p.add_argument("--sum_assoc", "--sum-assoc", dest="sum_assoc",
                   type=str, default="auto", choices=["auto", "pairwise"],
                   help="rank 0: weighted-mean summation association. "
                        "'pairwise' = the canonical balanced-binary fold "
                        "(robust_agg.pairwise_sum); with --aggregator, the "
                        "two-phase evidence/verdict composition; 'auto' "
                        "keeps the tensordot association")
    p.add_argument("--adversary-plan", "--adversary_plan",
                   dest="adversary_plan", type=str, default=None,
                   help="model-space adversary schedule "
                        "(fedml_tpu_torch/chaos/adversary.py): a JSON file "
                        "path or inline JSON {seed, rules:[{attack, ranks, "
                        "rounds, ...}]} — the listed worker ranks upload "
                        "sign_flip/scale/gaussian/nan/shift attacks on "
                        "their scheduled rounds. Pass the SAME plan to "
                        "every rank (each client applies only its own "
                        "rules); pair with --aggregator on rank 0")
    p.add_argument("--error_feedback", "--error-feedback",
                   dest="error_feedback", type=int, default=1,
                   help="client-side error-feedback residual for the "
                        "lossy uplink tiers (comm/ef.py); 0 is the "
                        "convergence-ablation knob, never the production "
                        "setting")
    for dest, (flag, kind, default, item) in _UNPORTED_FLAGS.items():
        # the reference takes most of these in both spellings
        names = [flag] + ([flag.replace("_", "-")] if "_" in flag else [])
        help_ = (f"not ported yet (ROADMAP.md queue A, item {item}); "
                 f"raises unless left at {default!r}")
        p.add_argument(*names, dest=dest, type=kind, default=default,
                       help=help_)
    return p


def refuse_unported_flags(args) -> None:
    """Raise NotImplementedError for the first reference flag set off its
    default, naming its ROADMAP.md item."""
    for dest, (flag, _, default, item) in _UNPORTED_FLAGS.items():
        if getattr(args, dest) != default:
            raise NotImplementedError(
                f"{flag}={getattr(args, dest)!r} is not ported yet: "
                f"ROADMAP.md queue A, item {item}")


def _load_adversary_plan(spec: str | None):
    """--adversary-plan: a JSON file path or inline JSON (the dual form
    --chaos-plan takes)."""
    if not spec:
        return None
    from fedml_tpu_torch.chaos import AdversaryPlan

    return AdversaryPlan.from_spec(spec)


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


def _supervise(args, argv) -> int:
    """Rank-0 supervision loop: run the real server as a child process,
    restart it up to ``--supervise N`` times when it dies abnormally
    (SIGKILL, crash, OOM). Every restart recovers through checkpoint + WAL
    — the child's OWN boot path, nothing supervisor-special — so the
    supervisor stays a dumb loop: spawn, publish the pid, wait, decide. A
    clean exit (rc 0) ends the job; exhausting the budget forwards the
    child's rc."""
    import os
    import subprocess
    import sys

    from fedml_tpu_torch.core.wal import durable_write

    log = logging.getLogger("fedml_tpu_torch.launch")
    if not args.ckpt_dir:
        raise ValueError("--supervise needs --ckpt_dir: the restarted "
                         "server recovers through checkpoint + WAL")
    child_argv = list(sys.argv[1:] if argv is None else argv)
    # strip --supervise (both '--supervise N' and '--supervise=N' forms)
    # so the child runs the server in-process
    out, skip = [], False
    for tok in child_argv:
        if skip:
            skip = False
            continue
        if tok == "--supervise":
            skip = True
            continue
        if tok.startswith("--supervise="):
            continue
        out.append(tok)
    os.makedirs(args.ckpt_dir, exist_ok=True)
    pid_path = os.path.join(args.ckpt_dir, "server.pid")
    restarts = 0
    while True:
        child = subprocess.Popen(
            [sys.executable, "-m",
             "fedml_tpu_torch.experiments.distributed_launch", *out])
        # the pid file is a chaos driver's kill handle; atomic-replace so
        # a reader never sees a torn pid
        durable_write(pid_path, str(child.pid).encode())
        log.info("supervise: server child pid %d (restart %d/%d)",
                 child.pid, restarts, args.supervise)
        rc = child.wait()
        if rc == 0:
            log.info("supervise: server exited cleanly after %d "
                     "restart(s)", restarts)
            return 0
        restarts += 1
        if restarts > args.supervise:
            log.error("supervise: restart budget %d exhausted (last rc "
                      "%s) — giving up", args.supervise, rc)
            return rc if rc > 0 else 1
        log.warning("supervise: server died (rc %s) — restarting "
                    "(%d/%d); recovery replays checkpoint + WAL",
                    rc, restarts, args.supervise)


def refuse_turboaggregate_compositions(args) -> None:
    """The masked secure tier's refusal matrix (the reference's flags, in
    its order): every unsupported composition is a loud ValueError on
    every rank (ranks share argv). ``--fused_agg`` and ``--edges`` are
    compositions, not refusals."""
    incompatible = [name for name, v in (
        ("--shard_server_state",
         getattr(args, "shard_server_state", 0) or None),
        ("--async_buffer_k", getattr(args, "async_buffer_k", None)),
        ("--update_codec", None if getattr(args, "update_codec", None)
         in (None, "dense") else args.update_codec),
        ("--sparsify_ratio", getattr(args, "sparsify_ratio", None)),
        ("--aggregator", getattr(args, "aggregator", None)),
        ("--byzantine_f", getattr(args, "byzantine_f", None)),
        ("--delta_broadcast",
         getattr(args, "delta_broadcast", 0) or None),
        ("--heartbeat_max_age_s",
         getattr(args, "heartbeat_max_age_s", None)),
        ("--sum_assoc", None if getattr(args, "sum_assoc", "auto")
         == "auto" else args.sum_assoc),
        # a masked upload carries no model-space structure an adversary
        # plan could perturb meaningfully
        ("--adversary_plan", getattr(args, "adversary_plan", None)),
    ) if v is not None]
    if incompatible:
        raise ValueError(
            f"--algo turboaggregate (masked secure aggregation) does "
            f"not compose with {incompatible}: masked field vectors "
            "aggregate mod p — there is no server plane to shard, no "
            "per-update structure for codecs or robust estimators, "
            "and the synchronous cohort is the protocol")


def _secagg_kw(args) -> dict:
    return dict(threshold_t=args.secagg_threshold_t,
                quant_scale=args.secagg_quant_scale,
                defense_type=("dp" if args.defense_type == "dp" else "none"),
                norm_bound=args.norm_bound,
                secagg_max_abs=args.secagg_max_abs)


def _turbo_rank(args, data, task, cfg, backend, device, telemetry,
                backend_kw):
    """This rank's manager on the masked secure tier, flat or (``--edges``)
    hierarchical: rank 0 the server or root, 1..E the edges, the rest
    SecureTrainer clients whose server is rank 0 or their edge."""
    from fedml_tpu_torch.distributed.turboaggregate import (
        HierTAAggregator,
        HierTASecureServerManager,
        SecureTrainer,
        TAAggregator,
        TASecureClientManager,
        TASecureEdgeManager,
        TASecureServerManager,
    )

    secagg_kw = _secagg_kw(args)
    if args.edges:
        from fedml_tpu_torch.distributed.fedavg.hierarchy import EdgeTopology

        topo = EdgeTopology(edges=args.edges,
                            workers=args.world_size - 1 - args.edges)
        if args.rank == 0:
            agg = HierTAAggregator(
                data, task, cfg, topo,
                noise_multiplier=args.noise_multiplier, device=device,
                **secagg_kw)
            return HierTASecureServerManager(
                agg, rank=0, size=args.world_size, backend=backend,
                ckpt_dir=args.ckpt_dir,
                round_timeout_s=args.round_timeout_s,
                telemetry=telemetry, **backend_kw)
        if args.rank <= args.edges:
            # edge watchdog at HALF the root deadline, as on the dense
            # tier: block-local reveal or shed resolves first
            return TASecureEdgeManager(
                args.rank, topo, cfg, backend=backend,
                round_timeout_s=(args.round_timeout_s / 2.0
                                 if args.round_timeout_s else None),
                device=device, **secagg_kw, **backend_kw)
        slot = topo.slot_of(args.rank)
        trainer = SecureTrainer(
            args.rank, data, task, cfg, slot=slot,
            peers=list(topo.slots_of_edge(topo.edge_of_slot(slot))),
            device=device, **secagg_kw)
        return TASecureClientManager(
            trainer, rank=args.rank, size=args.world_size, backend=backend,
            server_rank=topo.edge_rank(topo.edge_of_slot(slot)),
            **backend_kw)
    if args.rank == 0:
        agg = TAAggregator(
            data, task, cfg, worker_num=args.world_size - 1,
            noise_multiplier=args.noise_multiplier, device=device,
            **secagg_kw)
        return TASecureServerManager(
            agg, rank=0, size=args.world_size, backend=backend,
            ckpt_dir=args.ckpt_dir, round_timeout_s=args.round_timeout_s,
            telemetry=telemetry, **backend_kw)
    trainer = SecureTrainer(args.rank, data, task, cfg, device=device,
                            **secagg_kw)
    return TASecureClientManager(trainer, rank=args.rank,
                                 size=args.world_size, backend=backend,
                                 **backend_kw)


def _tree_rank(args, data, task, cfg, backend, device, agg_kw, telemetry,
               backend_kw):
    """This rank's manager in the hierarchical topology: rank 0 the root,
    1..E the edges, the rest workers whose server is their edge."""
    from fedml_tpu_torch.distributed.fedavg.api import init_client
    from fedml_tpu_torch.distributed.fedavg.hierarchy import (
        EdgeTopology,
        FedAvgEdgeManager,
        HierFedAvgAggregator,
        HierFedAvgServerManager,
    )

    topo = EdgeTopology(edges=args.edges,
                        workers=args.world_size - 1 - args.edges)
    if args.rank == 0:
        agg = HierFedAvgAggregator(data, task, cfg, topo, device=device,
                                   **agg_kw)
        return HierFedAvgServerManager(
            agg, rank=0, size=args.world_size, backend=backend,
            ckpt_dir=args.ckpt_dir, round_timeout_s=args.round_timeout_s,
            telemetry=telemetry, **backend_kw)
    if args.rank <= args.edges:
        # every rank shares argv, so the edge reads the two-phase mode off
        # the --aggregator the root arms; its watchdog runs at HALF the
        # root's deadline so a stalled block resolves before the root acts
        return FedAvgEdgeManager(
            args.rank, topo, backend=backend,
            round_timeout_s=(args.round_timeout_s / 2.0
                             if args.round_timeout_s else None),
            robust=bool(args.aggregator), fused=bool(args.fused_agg),
            device=device, **backend_kw)
    slot = topo.slot_of(args.rank)
    return init_client(
        data, task, cfg, args.rank, args.world_size, backend, device=device,
        adversary_plan=_load_adversary_plan(args.adversary_plan),
        server_rank=topo.edge_rank(topo.edge_of_slot(slot)),
        # adversary plans name 1-based COHORT ranks: a tree worker matches
        # by slot + 1, so one plan drives a flat and a tree job alike
        adversary_rank=slot + 1, **backend_kw)


def init_role(args, data, task, cfg, backend_kw, telemetry=None,
              device=None):
    """Construct this rank's manager (does not run it): the server (or
    the tree's root / edge) with the options rank 0 routes, or a client."""
    from fedml_tpu_torch.distributed.fedavg.api import init_client, init_server

    backend = args.backend.upper()
    if args.algo == "turboaggregate":
        refuse_turboaggregate_compositions(args)
        return _turbo_rank(args, data, task, cfg, backend, device,
                           telemetry, backend_kw)
    # robust aggregation: the aggregator's options, as the reference wires
    # them (--byzantine_f only reaches an --aggregator)
    agg_kw: dict = {}
    if args.aggregator:
        agg_kw["aggregator"] = args.aggregator
        if args.byzantine_f is not None:
            agg_kw["aggregator_params"] = {"f": args.byzantine_f}
    if args.edges:
        return _tree_rank(args, data, task, cfg, backend, device, agg_kw,
                          telemetry, backend_kw)
    if args.rank == 0:
        srv_kw: dict = {}
        if args.async_buffer_k is not None:
            srv_kw.update(async_buffer_k=args.async_buffer_k,
                          staleness=args.staleness,
                          staleness_bound=args.staleness_bound,
                          buffer_deadline_s=args.buffer_deadline_s)
        agg_kw["sum_assoc"] = args.sum_assoc
        if args.fused_agg:
            agg_kw["fused_agg"] = True
        if args.algo == "fedavg_robust":
            from fedml_tpu_torch.distributed.fedavg.server_manager import (
                FedAvgServerManager,
            )
            from fedml_tpu_torch.distributed.fedavg_robust import (
                FedAvgRobustAggregator,
            )

            agg = FedAvgRobustAggregator(
                data, task, cfg, worker_num=args.world_size - 1,
                defense_type=args.defense_type, norm_bound=args.norm_bound,
                stddev=args.stddev, noise_multiplier=args.noise_multiplier,
                device=device, **agg_kw)
            return FedAvgServerManager(
                agg, rank=0, size=args.world_size, backend=backend,
                ckpt_dir=args.ckpt_dir, round_timeout_s=args.round_timeout_s,
                heartbeat_max_age_s=args.heartbeat_max_age_s,
                delta_broadcast=bool(args.delta_broadcast),
                telemetry=telemetry, **srv_kw, **backend_kw)
        return init_server(data, task, cfg, args.world_size, backend,
                           device=device, agg_kw=agg_kw,
                           ckpt_dir=args.ckpt_dir,
                           round_timeout_s=args.round_timeout_s,
                           heartbeat_max_age_s=args.heartbeat_max_age_s,
                           delta_broadcast=bool(args.delta_broadcast),
                           telemetry=telemetry, **srv_kw, **backend_kw)
    return init_client(data, task, cfg, args.rank, args.world_size,
                       backend, device=device,
                       sparsify_ratio=args.sparsify_ratio or None,
                       update_codec=args.update_codec,
                       error_feedback=bool(args.error_feedback),
                       adversary_plan=_load_adversary_plan(
                           args.adversary_plan),
                       **backend_kw)


def _live_telemetry(args):
    """Rank 0's ``Telemetry`` bundle and a client rank's bare metrics
    server, from the launch flags: (telemetry or None, server or None).

    ``--metrics_port N``: rank r binds N + r (0 = ephemeral everywhere).
    Rank 0's endpoint rides its Telemetry bundle (health rules + memwatch
    implied); client ranks serve a bare registry endpoint. With ``--fleet``
    and NO explicit ``--metrics_port``, rank 0 still binds an ephemeral
    port (so /fleetz exists; logged + run header) but client ranks run no
    HTTP server — the in-band rollup is their export path. ``--fleet`` also
    arms the crash flight recorder on every rank (rank 0's via its
    Telemetry when a log dir exists)."""
    rank_port = (args.metrics_port + (args.rank if args.metrics_port else 0)
                 if args.metrics_port is not None else None)
    fleet_on = bool(args.fleet)
    log = logging.getLogger("fedml_tpu_torch.launch")
    telemetry = metrics_server = None
    if args.rank == 0 and (args.telemetry_dir or args.trace_dir or fleet_on
                           or rank_port is not None):
        from fedml_tpu_torch.obs import Telemetry

        # --trace-dir alone implies telemetry: the event log (with the
        # critical-path round records) lands next to trace.json;
        # --metrics_port alone gets an in-memory event log (the live
        # endpoints are the output)
        telemetry = Telemetry(log_dir=args.telemetry_dir or args.trace_dir,
                              trace_dir=args.trace_dir,
                              http_port=(0 if rank_port is None and fleet_on
                                         else rank_port),
                              fleet=fleet_on, fleet_job=args.fleet_job)
        if telemetry.http_port is not None:
            log.info("live endpoints: http://127.0.0.1:%d/metrics "
                     "(+ /healthz%s)", telemetry.http_port,
                     ", /fleetz" if fleet_on else "")
    elif args.rank != 0 and rank_port is not None:
        from fedml_tpu_torch.obs import start_metrics_server

        metrics_server = start_metrics_server(port=rank_port)
        log.info("live endpoints: http://127.0.0.1:%d/metrics (+ /healthz)",
                 metrics_server.port)
    if fleet_on:
        import os

        from fedml_tpu_torch.obs.flightrec import (
            active_recorder,
            install_flight_recorder,
            install_sigterm_dump,
        )

        base = args.telemetry_dir or args.ckpt_dir
        if args.rank != 0 and base and active_recorder() is None:
            install_flight_recorder(rank=args.rank,
                                    out_dir=os.path.join(base, "flightrec"))
        install_sigterm_dump()
    return telemetry, metrics_server


def main(argv=None):
    args = add_args(argparse.ArgumentParser(
        "fedml_tpu_torch.distributed")).parse_args(argv)
    logging.basicConfig(
        level=logging.INFO,
        format=f"%(asctime)s rank{args.rank} %(name)s %(levelname)s %(message)s",
    )
    if args.algo not in _ALGOS:
        raise NotImplementedError(
            f"--algo {args.algo} is not ported yet: ROADMAP.md queue A, "
            "item 9")
    if args.algo == "turboaggregate":
        # the reference's matrix comes first: its flags refuse with its
        # words even where the port has not ported the flag itself
        refuse_turboaggregate_compositions(args)
    refuse_unported_flags(args)
    if args.rank == 0 and args.supervise:
        raise SystemExit(_supervise(args, argv))
    if args.edges and args.algo != "turboaggregate":
        if args.algo != "fedavg":
            raise ValueError(f"--edges is wired for fedavg and "
                             f"turboaggregate only (got --algo "
                             f"{args.algo})")
        # the dense synchronous protocol is the tree's contract (the
        # flags of the other unported modes were refused just above)
        incompatible = [name for name, v in (
            ("--sparsify_ratio", args.sparsify_ratio),
            ("--update_codec", None if args.update_codec in (None, "dense")
             else args.update_codec),
            ("--delta_broadcast", args.delta_broadcast or None),
            ("--sum_assoc", None if args.sum_assoc == "auto"
             else args.sum_assoc),  # the tree IS pairwise already
            ("--async_buffer_k", args.async_buffer_k),
            ("--heartbeat_max_age_s", args.heartbeat_max_age_s),
        ) if v is not None]
        if incompatible:
            raise ValueError(f"--edges does not compose with "
                             f"{incompatible} — run the flat topology")
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
    n_workers = args.world_size - 1 - args.edges
    if n_workers < 1:
        raise ValueError(f"--world_size {args.world_size} leaves no worker "
                         f"ranks after {args.edges} edges + 1 server")
    worker_slot = args.rank - 1 - args.edges
    if (args.rank != 0 and worker_slot >= 0 and n_workers == n_total
            and args.algo != "turboaggregate"):
        # turboaggregate excluded: SecureTrainer's pre-normalized weight
        # needs every cohort member's sample count (_round_weight), which
        # a rank-local shard no longer holds.
        # full participation: worker slot s always trains client s, so this
        # process keeps only its own shard (load_partition_data_distributed_*
        # parity — the reference's per-rank loaders, cifar10/data_loader.py:433)
        from fedml_tpu_torch.core.client_data import subset_clients

        data = subset_clients(data, [worker_slot])
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

    telemetry, metrics_server = _live_telemetry(args)
    mgr = init_role(args, data, task, cfg, backend_kw, telemetry=telemetry,
                    device=device)
    if args.warmup and args.rank != 0 and hasattr(mgr, "warmup"):
        # run the fit once before blocking on the first broadcast
        rep = mgr.warmup()
        if rep:
            logging.getLogger("fedml_tpu_torch.launch").info(
                "warmup: %s in %.2fs", rep.get("variants"),
                rep.get("seconds", 0.0))
    try:
        mgr.run()
        if broker is not None:
            _drain_broker(broker)
    finally:
        if telemetry is not None:
            telemetry.close()
        if metrics_server is not None:
            metrics_server.close()
        if args.fleet and args.rank != 0:
            # rank 0's close dump rides telemetry.close(); client and edge
            # ranks flush their ring here so a clean run leaves the full
            # per-rank post-mortem set
            from fedml_tpu_torch.obs.flightrec import dump_active

            dump_active("close")
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
