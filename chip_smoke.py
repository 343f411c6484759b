#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port (fedml_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py                         # every phase, one card
    python3 chip_smoke.py --phases build,kernels  # a subset, for debugging

Phases, in order:
  device   the card's name and power limit (nvidia-smi); TF32 switched off
  build    nvcc builds every kernel source in fedml_tpu_torch/ops/csrc;
           ptxas's registers and spills and the count of tensor-core
           (HMMA) instructions in the built SASS, per instantiation; fails
           if an instantiation of any of the three kernels has none
  kernels  each kernel against its plain PyTorch version on the card, at the
           shape the slice's training steps give it (the cohort folded into
           B), at its eval's shape and at ragged shapes of every head dim
           the kernels take, and run twice for bitwise equal outputs; the
           forward (o and lse) and the backward pair (dQ, dK, dV) against
           float64 at every one of those shapes, each within
           F32_ERR_FACTOR x its plain float32 version's error; its time,
           the plain version's time and scaled_dot_product_attention's,
           whose CUDA kernels are named; a [B,T,H,D] view off a 16-byte
           boundary refused by all three wrappers before any launch
  slice    FedAvg over TransformerLM("transformer_flash", vocab 1024, dim
           256, depth 4, heads 8, T 2048): 2 rounds of 4 clients x 2 local
           SGD steps, the cohort batched (torch.func.vmap) and folded into
           the kernels' B, so each attention call of a step launches once
           for the cohort (launch counters); the same rounds from the same
           weights with plain attention must agree; one more round under
           torch.profiler
  main     the system's main path, bench.py:206-232's workload: FedAvg of
           CNNOriginalFedAvg (62 classes) on FEMNIST-shaped data (3,400
           clients, uint8 pixels parked on the card by device_data), 10
           clients a round, batch 20, SGD lr 0.1, 28 batches. One-step
           rounds and its first two rounds, each from the same weights,
           must agree with the port's CPU run of them (host-packed by the
           C++ packer), client by client for the one-step updates, also
           with the process's TF32 flags at PyTorch's defaults, while a
           control with the engine's float32 policy off and TF32 allowed
           must not; then timed rounds (wall time, samples/s), one round
           under torch.profiler (busy share, top kernels, idle gaps), one
           eval, peak device memory; for each timed round the engine's
           host spans (obs/tracing RoundTracer): pack (sampling, packing,
           the device gather) and round (dispatching the fit and the
           aggregate), and the wait for the card after them
  distributed  the cross-process runtime (fedml_tpu_torch.distributed) at
           main's configuration: (a) one step of each client of rounds 0
           and 1 through ten DistributedTrainers on ten threads at once
           against the engine's batched step on the same batch (bitwise),
           with the engine's flags and with TF32 flags at PyTorch's
           defaults; (b) rounds 0 (run_simulated) and 1 over loopback, one
           server and ten client ranks as threads, each from the engine's
           entering weights, against the engine's rounds, and over gRPC
           where grpcio is installed; wire bytes by direction, one CNN
           frame's encode and decode, rounds 2-4 timed beside the engine's;
           (c) an elastic round with one client rank silent; (d) the
           launcher as 1 server + 2 client processes over MQTT against the
           in-process run of the same configuration, boot and round times;
           (e) a TransformerLM job at the slice's width (1 server and 4
           client ranks over loopback, each client's steps through the
           flash kernels: launch counts) against the engine's batched
           rounds from the same weights
  wire     the wire's tiers at main's configuration, 2 rounds each over
           loopback from the same weights: dense, delta, delta-int8 and
           delta-sign1 with error feedback, top-k (ratio 0.01) with error
           feedback, delta-int8 with round-delta broadcasts: uplink and
           downlink bytes, the reduction against dense (the reference's
           floors: int8 at least 8x, sign1 at least 25x), one frame's
           encode and decode on the host, round times; delta held to dense,
           the lossy tiers finite with empty quarantines. A seeded fault
           plan (drop, corrupt, duplicate, delay) twice on delta-int8: equal
           fault and quarantine ledgers, no duplicate folded twice. One
           traced dense run: each round's spans by rank, its frames grown
           only by the trace parameter. cuDNN deterministic for the phase,
           so the second chaos run and the traced run are held bitwise to
           the first and to the untraced run
  robust   Byzantine-robust aggregation at main's configuration, not cut:
           (a) every estimator behind the gate (median, trimmed mean, krum,
           multi-krum, geometric median), the pairwise mean, the evidence
           and the two-phase flush with the krum and medoid verdicts, over
           one stacked [10, ...] CNN update (two slots x10, one NaN): times
           beside the plain weighted mean's, reason codes equal to the
           port's CPU run of the same inputs, selections bitwise, the rest
           within 1e-5 relative; (b) FedAvgAPI under a seeded plan (ranks
           2 and 5 sign-flip x100, rank 7 NaN in round 1), 3 rounds for the
           gate alone and each estimator beside the plain build and the
           undefended engine: round walls and round spans, every round
           held to the port's CPU run (the gate and estimator over the
           card's own stack: reasons equal, selections bitwise, the rest
           within 1e-5; the round from the same weights: the attackers'
           verdicts equal, its params gap printed), the attackers named
           every round; then
           krum, median, the plain build and the undefended engine on to
           40 rounds on the card: median's eval loss below the initial
           one, the undefended engine's not, krum's pick one honest
           client's model every round; (c) run_simulated over
           loopback under the same plan on the clients, with krum and with
           the two-phase median (sum_assoc='pairwise'): ledgers equal to
           the engine's, each round within 1e-2 of the engine's fit with
           the same composition from the wire's entering weights
  hier     the hierarchical edge tier at main's configuration, not cut: 1
           root, 5 edge aggregator ranks of 2 cohort slots, 10 workers:
           (a) edge partials + the root's combine on one stacked [10, ...]
           CNN update (robust's stack, one slot at weight 0) bitwise the
           flat pairwise fold, and the two-phase split (per-block evidence,
           the cohort's verdicts, per-block folds, the combine) bitwise the
           flat two-phase flush with the krum and medoid verdicts, values
           and reason codes; one edge's partial, the combine and the flat
           fold timed; (b), with cuDNN deterministic from here to the end
           of the phase, one client fitted twice from the same weights
           (are the fits repeatable bit for bit?), then 3 rounds of
           run_simulated(edges=5) over loopback beside the flat
           sum_assoc='pairwise' run from the same weights: params bitwise
           if the fits repeat, else within 1e-2 a round, ledgers equal,
           fan-in 5 a round, round walls and the root's ingress bytes;
           (c) the same under robust's plan with krum and with median
           through the two-phase protocol: ledgers equal and naming the
           attackers, the evidence and verdict bytes within their budgets,
           the hier record's rejections and verdict round trips; (d) edge
           rank 1 crashed (sanitize, 3 s deadline, 6 rounds): its cohort
           ranks ledgered edge_lost in each lost round, fan-in 4 and back
           to 5, each round's num_samples the reporting blocks' mass
  recover  server crash recovery and buffered-async rounds at main's
           configuration, not cut, over loopback, each ckpt_dir a fresh
           temporary directory: (a) the server state's npz (bytes, save:
           device->host, write, fsync, rename; restore: read, host->device;
           median of 7, the round trip bitwise) and one fsync'd WAL append
           (median of 50); (b) 4 rounds uninterrupted without and with
           ckpt_dir (round walls, the save's time, fsyncs a round), a
           crash between commits at round 2 and one mid-round after 3
           uploads at round 1, each within 1e-2 a round of the twin
           (bitwise if the fits repeat), ledgers equal plus exactly the 3
           lost slots ledgered server_restart, 2 restart epochs in the WAL;
           recovery seconds, the probe's round trip, the resumed round's
           wall; (c) async K = 10 with bound 0 beside the sync twin (3
           updates, within 1e-2 a round), then K = 5 unbounded under a
           seeded straggle of ranks 2 and 7 beside the sync rounds under
           the same plan (6 updates each): flushes and rounds a second,
           each flush's staleness, the sheds by reason; (d) a root crash
           mid-round (after 2 edge partials) under hier's 5 x 2 tree, 3
           rounds, against the uninterrupted tree: ledgers equal plus the
           lost slots, every edge answering the probe
  harden   the engine's buffered-async runner, churn-trace cohorts and
           accounted DP-FedAvg at main's configuration, not cut, cuDNN
           deterministic for the phase: (a) FedAvgAPI.run_async with K =
           10 and bound 0 for 3 updates against 3 run_rounds (model, key
           chain and ledger bitwise if a round repeats bit for bit), then
           K = 5 under poly:0.5 with a 0.5 s virtual straggle of slots 2
           and 7 for 6 updates: its virtual wall against
           sync_virtual_wallclock, the host wall an update, the staleness
           seen and the sheds; (b) the engine under a diurnal ChurnTrace
           over the 3,400 clients for 4 rounds: each round's cohort (size
           and ids) equal to the host's sample_available, the batched fit
           run at that K; a loopback job under a rank-level trace for 3
           rounds: no frame to an offline rank, no suspect, nothing
           undeliverable, each record's churn block; (c)
           FedAvgRobustAPI(defense_type='dp') for 3 rounds: ε after each
           round equal to a host DPAccountant stepped alike, the std of
           (noised - clipped mean) within 1 % of z*C/m, the Threefry bits
           drawn on the card bitwise the host's and its normals against
           the host's erfinv, the noise draw's ms beside the round walls of
           a DP, a norm_diff_clipping and a plain engine; (d)
           FedAvgRobustAggregator(defense_type='dp') over loopback with
           ckpt_dir and a server crash after 3 uploads of round 1, 3
           rounds, against the uninterrupted DP run: bitwise if the fits
           repeat (the noise stream continued, not replayed), ε equal or
           above by at most the one round the pre-charge contract allows,
           the recovery ms
  observe  the run-health and round-economics layer (fedml_tpu_torch/obs)
           at main's configuration, not cut, cuDNN deterministic for the
           phase: (a) 3 engine rounds under Telemetry(log_dir, http_port=0,
           memwatch, health) beside 3 unarmed rounds from the same
           weights, interleaved: the model bits bitwise equal; each record's
           goodput block (exclusive duty buckets summing to the wall,
           FLOPs/s from the counted forward, MFU against the card's bf16
           peak), pack and mem blocks; each round's duty split and the
           armed round's wall beside the unarmed one's (telemetry's cost);
           memwatch's device_peak_bytes equal to
           torch.cuda.max_memory_allocated() read at the same point;
           /metrics and /healthz scraped once (status ok); (b) the fleet
           plane over loopback, flat (10 ranks) and under hier's 5 x 2 tree,
           2 rounds each beside a plane-off run: /fleetz rows for every
           rank (the tree's workers through their edges' folded blobs),
           digest bytes a rank a round within the 1,024 B budget, the
           server rounds' duty-only goodput blocks, the model bits bitwise
           the plane-off run's; (c) Telemetry.profile around one engine
           round: a non-empty torch.profiler trace with the round's CUDA
           kernels
  secure   masked secure aggregation over GF(2^31-1) (core/secure_agg.py,
           algorithms/turboaggregate.py, distributed/turboaggregate.py) at
           main's configuration, not cut, cuDNN deterministic for the
           phase, no kernel of its own (plain int64 torch ops on the card):
           (a) a TurboAggregateAPI round and a FedAvgAPI round from the
           same weights within K * 0.5 / 2^16 (+ K float32 ulps of the
           mean); one client's mask_update on the card bitwise the same
           call on the CPU; the ms of mask_update per client, of one PRG
           expansion, of the fold per arrival (host and card) and of
           unmask + decode per round; (b) the flat masked tier over
           loopback, 2 rounds each: a dense run beside a clean masked run
           (round walls, root ingress bytes a round, the share of a round
           spent masking), a client crashed in round 1 by a seeded plan
           (the round's aggregate against the exact survivor-weighted
           mean of the survivors' cleartext vectors, on the host in
           float64, within the quantization bound; the reveal's recovery
           seconds), and a round shed below t + 1 and re-broadcast
           (ledgered secagg_shed; the retry bitwise the clean run if the
           fits repeat); (c) the 5 x 2 tree (t = 1), host fold and fused
           ingest, bitwise the flat clean run if the fits repeat; (d) DP on
           the masked path, 2 rounds: ε equal to a host DPAccountant, the
           noise drawn on the card. Deadlines are driven (on_timeout once
           every upload that can arrive has), never waited out
  pipeline bench.py's per-round driver and the rest of the aggregation and
           pipeline stack at main's configuration, not cut, cuDNN
           deterministic for the phase, no kernel of its own: (a) warmup()
           and run_round(0), then 6 rounds through run_pipelined
           (prefetch 2, the packer's copies on their own CUDA stream from
           pinned buffers) beside the run_round loop from the same state,
           host-packed and device-resident: model, key chain, metrics and
           ledger bitwise; rounds/s and samples/s, the packer's pack and
           copy spans, the driver's stall, the dispatch depth; (b)
           bucket_batches off and on for 6 rounds from the same weights:
           bitwise, each round's bucket depth, need, padding share and
           wall, the warmup's variants; (c) precision='bf16' with the
           model's activation dtype None and bfloat16: one step of each
           client against the port's CPU step (median), round 0 against
           the CPU's within 1e-2, masters float32, round walls beside
           f32's; (d) the stand-in written as packed npy to a temporary
           directory (removed after): the engine over PackedNpySource
           bitwise the in-memory engine for 3 rounds, host RSS before and
           after; (e) fused ingest over loopback, 2 rounds each under a
           NaN adversary: fused vs stacked pairwise, dense and delta-int8,
           the staged median vs the stacked two-phase median (bitwise if
           the fits repeat, ledgers equal), the 5 x 2 tree with fused
           edges vs the fused flat run; aggregate ms and staging bytes
  seq      sequence-parallel long-context FedAvg (FedAvgSeqAPI) at the
           slice's width, its ranks 4 processes sharing the card in one
           gloo world (fedml_tpu_torch.mesh.world; the collectives staged
           through host memory; a failed or late rank fails the phase):
           (a) on a 1 x 2 mesh, ring_attention_flash, ring_attention and
           ulysses_attention with and without flash over [4, 2048, 8, 32],
           causal and not, output and q/k/v grads against the single-rank
           flash kernels or plain attention (3e-5 / 2e-3); (b) 2 rounds on
           a 2 x 2 mesh, ring + flash, each from the same entering weights
           as the single-process FedAvgAPI (flash) round it is held to
           (relative parameter distance within TOL_SEQ_ROUND, count
           exact; the round's update relative to the weights beside):
           wall and train tokens/s beside the single process's, each
           rank's share of the wall in the exchanges and, apart, in the
           device waits before them, device peak and launches (16 of each
           kernel a rank a round: the ring's causal own block and
           non-causal other block, and their backward with the merge's
           lse cotangent); a planted control, round 0 again with
           seq_invariant's gradient all-reduce taken out, must land
           outside TOL_SEQ_ROUND; (c) one Ulysses + flash round on 1 x 2
           against the same oracle; then the three kernels timed at the
           path's shapes ([8, 1024, 8, 32] causal and not, [16, 2048, 4,
           32]) beside their bounds, plain versions and SDPA
Then one JSON line listing every kernel, and as the last line
{"ok": true, "device": {...}}. Any failed phase exits non-zero and prints
no result line. Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import importlib
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from fedml_tpu_torch.ops import loader

# the package re-exports a function of the same name, so fetch the module
fa = importlib.import_module("fedml_tpu_torch.ops.flash_attention")

PHASES = ("device", "build", "kernels", "slice", "main", "distributed",
          "wire", "robust", "hier", "recover", "harden", "observe",
          "secure", "pipeline", "seq")
# H100 SXM peaks (NVIDIA data sheet, 700 W): float32 outside the tensor
# cores, TF32 on the tensor cores (dense), and HBM3 bandwidth. f32-accurate
# work on the tensor cores (3xTF32) takes three TF32 products per product,
# 165 TFLOP/s: the least time the card needs for f32-accurate work, so each
# kernel's bound_ms takes it; the CUDA-core f32 figure is bound_f32_ms.
PEAK_F32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_BYTES_PER_S = 3.35e12
# kernel vs plain, both float32 on the card; allclose(rtol=tol, atol=tol).
# fwd sums <= T products per output in another order than the plain
# einsum; the grads add a second such sum (dS) and sum over T queries.
TOL_FWD = 1e-4
TOL_BWD = 1e-3
# the kernels (3xTF32 on the tensor cores) against a float64 oracle: max
# |err| at most this many times that of their plain float32 versions
F32_ERR_FACTOR = 4
# the slice's rounds, flash kernels vs plain attention from the same
# weights: history metrics (relative) and final params (absolute) are 4
# layers x 4 SGD steps of float32 rounding apart
TOL_SLICE = 1e-3
# the long-context slice: the widest TransformerLM the repository runs
# (scripts/bench_longctx.py:111-114), 4 clients a round of batch 4
SLICE_WIDTHS = dict(vocab_size=1024, dim=256, depth=4, num_heads=8,
                    max_len=2048)
SLICE_FED = dict(client_num_in_total=8, client_num_per_round=4, epochs=1,
                 batch_size=4, max_batches=2, lr=0.1, frequency_of_the_test=1,
                 eval_batch_size=4, seed=0)
_T, _H = SLICE_WIDTHS["max_len"], SLICE_WIDTHS["num_heads"]
_D = SLICE_WIDTHS["dim"] // _H
# every training step launches each kernel once on the whole cohort, the
# clients folded into B; the eval runs the forward on one batch
SLICE_SHAPE = dict(B=SLICE_FED["client_num_per_round"] * SLICE_FED["batch_size"],
                   T=_T, H=_H, D=_D, causal=True)
# the eval's B, ragged T, and every other head dim the kernels are built for
RAGGED_SHAPES = (dict(B=SLICE_FED["eval_batch_size"], T=_T, H=_H, D=_D,
                      causal=True),
                 dict(B=2, T=1000, H=4, D=64, causal=True),
                 dict(B=2, T=1000, H=4, D=64, causal=False),
                 dict(B=1, T=300, H=2, D=16, causal=True),
                 dict(B=1, T=300, H=2, D=128, causal=False))
SLICE_KERNELS = ("flash_fwd_kernel<32,1>", "flash_dq_kernel<32,1>",
                 "flash_dkv_kernel<32,1>")
SOURCE = "fedml_tpu_torch/ops/csrc/flash_attention.cu"
REPLACES = {"flash_fwd": "fedml_tpu/ops/flash_attention.py:79",
            "flash_bwd_dq": "fedml_tpu/ops/flash_attention.py:213",
            "flash_bwd_dkv": "fedml_tpu/ops/flash_attention.py:238"}


def phase_device(report):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[torch.cuda.current_device()])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("tf32: torch.backends.cuda.matmul.allow_tf32=False, "
          "torch.backends.cudnn.allow_tf32=False")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")


def _kernel_label(mangled):
    """kernel<args> from a mangled entry name, every int and bool template
    argument kept in order (flash_dq_kernel<32,1>)."""
    k = re.search(r"_kernelI((?:L[ib]\d+E)+)E", mangled)
    if not k:
        return mangled
    end = k.start() + len("_kernel")
    args = ",".join(re.findall(r"L[ib](\d+)E", k.group(1)))
    for start in range(end - 1, 0, -1):  # the identifier is <length><name>
        if mangled[:start].endswith(str(end - start)):
            return f"{mangled[start:end]}<{args}>"
    return mangled


def _ptxas_report(log):
    """(kernel, registers, spill-store bytes) per compiled entry function,
    from nvcc's -Xptxas=-v log."""
    out, fn, spill = [], None, 0
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            fn = _kernel_label(m.group(1))
            spill = 0
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            out.append((fn, int(m.group(1)), spill))
            fn = None
    return out


def _sass_counts(lib):
    """{kernel<args>: (HMMA instructions, all instructions)} in the
    library's SASS (static counts, loops as compiled)."""
    sass = subprocess.run([loader.cuda_tool("cuobjdump"), "-sass", str(lib)],
                          capture_output=True, text=True, check=True,
                          timeout=120).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\w+)", line)
        if m:
            fn = _kernel_label(m.group(1))
            counts[fn] = [0, 0]
        elif fn and re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+\S", line):
            counts[fn][0] += "HMMA" in line
            counts[fn][1] += 1
    return counts


def phase_build(report):
    t0 = time.perf_counter()
    libs = loader.build_all()
    print(f"build: {len(libs)} source(s) in {time.perf_counter() - t0:.1f} s")
    for lib in libs:
        sass = _sass_counts(lib)
        hmma = {fn: c[0] for fn, c in sass.items()}
        for fn, regs, spill in _ptxas_report(lib.with_suffix(".log").read_text()):
            n_hmma, n_all = sass.get(fn, (0, 0))
            print(f"  ptxas: {fn:28s} {regs:3d} registers, {spill} bytes "
                  f"spilled; SASS {n_hmma} HMMA of {n_all} instructions")
        # every instantiation of the three kernels runs on the tensor
        # cores, the slice's (D=32, causal) first of all
        flash = {fn for fn in hmma
                 if re.match(r"flash_(fwd|dq|dkv)_kernel<", fn)}
        zero = sorted(fn for fn in flash | set(SLICE_KERNELS)
                      if not hmma.get(fn))
        if zero:
            raise AssertionError(f"no tensor-core (HMMA) instruction in the "
                                 f"SASS of {zero}")


def _time_ms(fn, reps=7, inner=5):
    """Median over ``reps`` of CUDA-event time per call, each rep timing
    ``inner`` back-to-back calls so host overhead hides behind the queue."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b) / inner)
    return statistics.median(out)


def _work(B, T, H, D, causal):
    """(flops, bytes) of each kernel on these inputs: matmul flops over the
    unmasked (query, key) pairs (the kernels skip tiles above the causal
    diagonal), each input read once and each output written once."""
    pairs = B * H * (T * (T + 1) // 2 if causal else T * T)
    x, row = 4 * B * T * H * D, 4 * B * H * T  # bytes of one [B,T,H,D] / [B,H,T]
    return {"flash_fwd": (4 * D * pairs, 3 * x + x + row),
            "flash_bwd_dq": (6 * D * pairs, 4 * x + 2 * row + x),
            "flash_bwd_dkv": (8 * D * pairs, 4 * x + 2 * row + 2 * x)}


def _f64_scores(q, k, causal):
    T, scale = q.shape[1], 1 / math.sqrt(q.shape[-1])
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if causal:
        ok = torch.ones(T, T, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~ok, fa.NEG_INF)
    return s


def _f64_fwd(q, k, v, causal):
    """(o, lse) of the same inputs in float64, by kernel name: the yardstick
    of accuracy for the forward kernel and its plain version alike."""
    q, k, v = (x.double() for x in (q, k, v))
    s = _f64_scores(q, k, causal)
    lse = torch.logsumexp(s, -1)
    o = torch.einsum("bhqk,bkhd->bqhd", torch.exp(s - lse[..., None]), v)
    return {"flash_fwd": (o, lse)}


def _f64_bwd(q, k, v, do, lse, corr, causal):
    """dQ and (dK, dV) of the same inputs in float64, by kernel name: the
    yardstick of accuracy for the kernels and their plain versions alike."""
    q, k, v, do, lse, corr = (x.double() for x in (q, k, v, do, lse, corr))
    scale = 1 / math.sqrt(q.shape[-1])
    s = _f64_scores(q, k, causal)
    p = torch.exp(s - lse[..., None])
    del s
    ds = p * (torch.einsum("bqhd,bkhd->bhqk", do, v) + corr[..., None])
    return {"flash_bwd_dq": (torch.einsum("bhqk,bkhd->bqhd", ds, k) * scale,),
            "flash_bwd_dkv": (torch.einsum("bhqk,bqhd->bkhd", ds, q) * scale,
                              torch.einsum("bhqk,bqhd->bkhd", p, do))}


def _max_err(pairs):
    return max(float((a - b).abs().max()) for a, b in pairs)


def _check_close(name, pairs, tol, where):
    for a, b in pairs:
        if not torch.allclose(a, b, rtol=tol, atol=tol):
            raise AssertionError(f"{name} disagrees with its plain version at "
                                 f"{where}: max |err| {_max_err([(a, b)]):.3e}"
                                 f" > tol {tol}")


def check_kernels(B, T, H, D, causal, timed):
    """Each kernel against its plain version on the same inputs and
    against a second run of itself (bitwise), the forward against float64;
    times, SDPA's and the backward pair against float64 too when
    ``timed``. Returns {kernel: stats}."""
    g = torch.Generator(device="cuda").manual_seed(T * 7 + D)
    shape = (B, T, H, D)
    q, k, v, do = (torch.randn(shape, generator=g, device="cuda")
                   for _ in range(4))
    g_lse = torch.randn((B, H, T), generator=g, device="cuda")
    where = f"B={B} T={T} H={H} D={D} causal={causal}"

    o_ref, lse_ref = fa.dense_fwd(q, k, v, causal)
    # the backward kernels get the plain forward's o/lse, as their twins do
    corr = (g_lse - (do * o_ref).sum(-1).transpose(1, 2)).contiguous()
    runs = {
        "flash_fwd": (lambda: fa.flash_fwd(q, k, v, causal),
                      lambda: fa.dense_fwd(q, k, v, causal), TOL_FWD),
        "flash_bwd_dq": (
            lambda: (fa.flash_bwd_dq(q, k, v, do, lse_ref, corr, causal),),
            lambda: (fa.dense_bwd_dq(q, k, v, do, lse_ref, corr, causal),),
            TOL_BWD),
        "flash_bwd_dkv": (
            lambda: fa.flash_bwd_dkv(q, k, v, do, lse_ref, corr, causal),
            lambda: fa.dense_bwd_dkv(q, k, v, do, lse_ref, corr, causal),
            TOL_BWD),
    }
    work = _work(B, T, H, D, causal)
    stats = {}
    for name, (kern, plain, tol) in runs.items():
        got = kern()
        torch.cuda.synchronize()
        pairs = list(zip(got, plain()))
        _check_close(name, pairs, tol, where)
        err = _max_err(pairs)
        again = kern()  # no atomics, a fixed summation order
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"{name} is not deterministic at {where}")
        flops, nbytes = work[name]
        t_flops, t_bytes = 3 * flops / PEAK_TF32_FLOPS, nbytes / PEAK_BYTES_PER_S
        bound = 1e3 * max(t_flops, t_bytes)
        st = {"max_abs_err": err, "tol": tol, "bound_ms": bound,
              "bound_by": "operations" if t_flops >= t_bytes else "bytes",
              "bound_tc_ms": bound,
              "bound_f32_ms": 1e3 * max(flops / PEAK_F32_FLOPS, t_bytes)}
        if timed:
            st["ms"] = _time_ms(kern)
            st["plain_ms"] = _time_ms(plain, reps=3, inner=2)
        stats[name] = st
        line = (f"  {name:14s} {where}: max|err| {err:.3e} (tol {tol:g}), "
                f"bitwise deterministic")
        if timed:
            line += (f"  kernel {st['ms']:.4f} ms  plain {st['plain_ms']:.4f}"
                     f" ms  3xTF32 bound {st['bound_ms']:.4f} ms "
                     f"({st['bound_by']})  f32 CUDA-core bound "
                     f"{st['bound_f32_ms']:.4f} ms")
        print(line)
    _check_f64(runs, _f64_fwd(q, k, v, causal), where)
    _check_f64(runs, _f64_bwd(q, k, v, do, lse_ref, corr, causal), where)
    if timed:
        sdpa = _time_sdpa(q, k, v, do, causal)
        stats["sdpa"] = sdpa
        pair = stats["flash_bwd_dq"]["ms"] + stats["flash_bwd_dkv"]["ms"]
        print(f"  backward pair  dQ + dK/dV {pair:.4f} ms, SDPA backward "
              f"{sdpa['bwd_ms']:.4f} ms, ratio {pair / sdpa['bwd_ms']:.3f}")
    return stats


def _check_f64(runs, exact, where):
    """Each kernel and its plain version against float64, output by
    output: the kernel's max |err| may be at most F32_ERR_FACTOR times the
    plain's."""
    for name, ref in exact.items():
        kern, plain, _ = runs[name]
        outs = [[x.double() for x in f()] for f in (kern, plain)]
        for i, r in enumerate(ref):
            err = [float((out[i] - r).abs().max()) for out in outs]
            print(f"  {name:14s} output {i} vs float64: kernel max|err| "
                  f"{err[0]:.3e}, plain f32 {err[1]:.3e} (max|ref| "
                  f"{float(r.abs().max()):.3f})")
            if err[0] > F32_ERR_FACTOR * err[1]:
                raise AssertionError(
                    f"{name} output {i} at {where}: max |err| vs float64 "
                    f"{err[0]:.3e} > {F32_ERR_FACTOR} x plain f32's "
                    f"{err[1]:.3e}")


def _time_sdpa(q, k, v, do, causal):
    """The library yardstick: one scaled_dot_product_attention call (the
    port never calls it), forward and its backward (dQ, dK, dV together)."""
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
    dot = do.transpose(1, 2)
    fwd_ms = _time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=causal))
    out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)
    bwd_ms = _time_ms(lambda: torch.autograd.grad(
        out, (qt, kt, vt), dot, retain_graph=True))
    print(f"  sdpa           forward {fwd_ms:.4f} ms  backward (dQ+dK+dV) "
          f"{bwd_ms:.4f} ms")
    _name_sdpa_kernels(qt, kt, vt, dot, causal)
    return {"fwd_ms": fwd_ms, "bwd_ms": bwd_ms}


def _name_sdpa_kernels(qt, kt, vt, dot, causal):
    """The CUDA kernels torch.profiler sees for one SDPA forward and one
    backward call on these f32 inputs: which backend serves them."""
    from torch.profiler import ProfilerActivity, profile

    for what in ("forward", "backward"):
        out = None if what == "forward" else F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            if out is None:
                F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)
            else:
                torch.autograd.grad(out, (qt, kt, vt), dot)
            torch.cuda.synchronize()
        names = [e.key for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        print(f"  sdpa {what} CUDA kernels: {names or 'none seen'}")


def phase_kernels(report):
    s = SLICE_SHAPE
    report["kernels"] = check_kernels(s["B"], s["T"], s["H"], s["D"],
                                      s["causal"], timed=True)
    for r in RAGGED_SHAPES:
        check_kernels(r["B"], r["T"], r["H"], r["D"], r["causal"],
                      timed=False)
    check_misaligned()


def check_misaligned(B=1, T=64, H=1, D=32):
    """A contiguous [B,T,H,D] view one float off a 16-byte boundary: each
    wrapper raises ValueError and launches nothing (its kernel copies 16
    bytes a thread)."""
    n = B * T * H * D
    x = torch.randn(n + 1, device="cuda")
    off, ok = x[1:].view(B, T, H, D), x[:n].view(B, T, H, D)
    row = torch.zeros(B, H, T, device="cuda")
    before = dict(fa.LAUNCHES)
    calls = ((fa.flash_fwd, (off, ok, ok, True)),
             (fa.flash_bwd_dq, (off, ok, ok, ok, row, row, True)),
             (fa.flash_bwd_dkv, (off, ok, ok, ok, row, row, True)))
    for fn, args in calls:
        try:
            fn(*args)
        except ValueError as e:
            print(f"  {fn.__name__}: misaligned q raises: {e}")
        else:
            raise AssertionError(f"{fn.__name__} took a misaligned q")
    torch.cuda.synchronize()  # the context is still sound
    if fa.LAUNCHES != before:
        raise AssertionError(f"launches on misaligned input: {fa.LAUNCHES}")


def phase_slice(report):
    from fedml_tpu_torch.algorithms.fedavg import FedAvgAPI, FedAvgConfig
    from fedml_tpu_torch.core.tasks import sequence_task
    from fedml_tpu_torch.data.synthetic import synthetic_sequences
    from fedml_tpu_torch.models import create_model

    widths, T, rounds = SLICE_WIDTHS, _T, 2
    t0 = time.perf_counter()
    data = synthetic_sequences(
        num_clients=SLICE_FED["client_num_in_total"], seq_len=T,
        vocab_size=widths["vocab_size"], samples_per_client=8,
        test_samples=16)
    print(f"slice: synthetic_sequences set-up {time.perf_counter() - t0:.1f} s")
    cfg = FedAvgConfig(comm_round=rounds, **SLICE_FED)
    api = FedAvgAPI(data, sequence_task(create_model("transformer_flash",
                                                     **widths)), cfg)
    start = {k: v.clone() for k, v in api.net.items()}
    n_params = sum(v.numel() for v in start.values())

    fa.reset_launches()
    api.train()
    torch.cuda.synchronize()
    launches = dict(fa.LAUNCHES)
    report["launches"] = launches

    # the cohort is folded into B: one launch per layer and step serves
    # every client of the round
    steps = api.num_batches * widths["depth"]
    evals = widths["depth"] * math.ceil(len(data.test_x) / cfg.eval_batch_size)
    want = {"flash_fwd": rounds * (steps + evals),
            "flash_bwd_dq": rounds * steps, "flash_bwd_dkv": rounds * steps}
    print(f"slice: {n_params} params, launches {launches}, expected {want}")
    if launches != want:
        raise AssertionError(f"kernel launches {launches} != {want}")
    for rec in api.history:
        bad = [k for k, v in rec.items() if not math.isfinite(float(v))]
        if bad:
            raise AssertionError(f"non-finite {bad} in {rec}")
    if not all(bool(torch.isfinite(v).all()) for v in api.net.values()):
        raise AssertionError("non-finite parameters after training")
    tokens = cfg.client_num_per_round * api.num_batches * cfg.batch_size * T
    for rec in api.history:
        print(f"slice: round {rec['round']}: train_loss {rec['train_loss']:.6f}"
              f" test_loss {rec['test_loss']:.6f} test_acc "
              f"{rec['test_acc']:.6f}  {rec['round_time']:.3f} s "
              f"(train + eval), {tokens / rec['round_time']:.0f} train "
              f"tokens/s")

    # the same rounds from the same weights with plain attention
    plain = FedAvgAPI(data, sequence_task(create_model("transformer",
                                                       **widths)), cfg)
    plain.load_state(start)
    plain.train()
    for rec, ref in zip(plain.history, api.history):
        for key in ("train_loss", "train_acc", "test_loss", "test_acc"):
            diff = abs(rec[key] - ref[key])
            print(f"slice: round {rec['round']} {key}: flash {ref[key]:.7f} "
                  f"plain {rec[key]:.7f} |diff| {diff:.2e}")
            if diff > TOL_SLICE * max(1.0, abs(ref[key])):
                raise AssertionError(f"round {rec['round']} {key}: flash "
                                     f"{ref[key]} vs plain {rec[key]}")
    diff = max(float((api.net[k] - plain.net[k]).abs().max()) for k in api.net)
    print(f"slice: params after {rounds} rounds, flash vs plain: max |diff| "
          f"{diff:.3e} (tol {TOL_SLICE})")
    if diff > TOL_SLICE:
        raise AssertionError(f"params differ by {diff} after {rounds} rounds")
    profile_round(api, rounds, tokens, "train tokens",
                  {"flash kernels": "flash_",
                   "matmul": "gemm|cutlass|cublas"})


def profile_round(api, round_idx, units, unit_name, groups):
    """One more round under torch.profiler: device time by kernel group
    (``groups``: label -> regex on the kernel name, first match wins), the
    device's busy share of the round's wall time, the top kernels and the
    idle gaps between device kernels. Returns the busy share (None when the
    profiler saw no device time)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        api.run_round(round_idx)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    cuda = torch.autograd.DeviceType.CUDA
    kernels = [e for e in prof.key_averages() if e.device_type == cuda]
    us = {e.key: getattr(e, "self_device_time_total", 0) for e in kernels}
    busy = sum(us.values()) / 1e6
    print(f"profile: round {round_idx} (train only) wall {wall:.4f} s, "
          f"{units / wall:.0f} {unit_name}/s under the profiler")
    if not busy:
        print("profile: device time not measured (profiler saw no kernels)")
        return None
    by_group = dict.fromkeys([*groups, "other"], 0.0)
    for name, t in us.items():
        g = next((g for g, pat in groups.items()
                  if re.search(pat, name, re.I)), "other")
        by_group[g] += t / 1e6
    print(f"profile: device busy {busy:.4f} s = {busy / wall:.1%} of wall; "
          + ", ".join(f"{g} {t:.4f} s ({t / busy:.1%})"
                      for g, t in by_group.items()))
    top = sorted(us.items(), key=lambda kv: -kv[1])
    calls = {e.key: e.count for e in kernels}
    for name, t in top[:8] + [kv for kv in top[8:] if "flash_" in kv[0]]:
        print(f"profile:   {t / 1e3:9.3f} ms  {calls[name]:5d} launches  "
              f"{name[:100]}")
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.device_type == cuda)
    gaps, end = [], None
    for a, b in spans:
        if end is not None and a > end:
            gaps.append(a - end)
        end = b if end is None else max(end, b)
    if gaps:
        gaps.sort(reverse=True)
        print(f"profile: {len(spans)} device kernels, span {(end - spans[0][0]) / 1e3:.3f} ms; "
              f"idle between them {sum(gaps) / 1e3:.3f} ms in {len(gaps)} gaps "
              f"(>=10 us: {sum(g >= 10 for g in gaps)}; largest "
              + ", ".join(f"{g / 1e3:.3f}" for g in gaps[:5]) + " ms)")
    return busy / wall


# bench.py:206-232's workload: FEMNIST-shaped data at its full population,
# CNNOriginalFedAvg (62 classes), 10 clients a round, batch 20, SGD lr 0.1,
# one local epoch of at most 28 batches
MAIN_CFG = dict(client_num_in_total=3400, client_num_per_round=10, epochs=1,
                batch_size=20, lr=0.1, max_batches=28, seed=0)
# The card's rounds against the port's CPU run of them, both float32,
# summing in other orders (cuDNN / cuBLAS against oneDNN / MKL). The CNN's
# gradient is not continuous: where two values of a max-pool window, or a
# ReLU input and 0, lie within rounding of each other, the two sides may
# route a sample's gradient differently. One client in ten or so meets
# such a point in a step (the CPU's float32 against its float64 as well:
# fedml_tpu_torch/step_gap.py, PERF.md), and over a round of 28 steps at
# lr 0.1 the runs drift apart (the CPU against itself from weights nudged
# by 1e-7: 2.75e-3 in the params after two rounds). So the comparison has
# two parts:
# - sharp: one step of each client of a round from the same weights, on
#   the same batch (gathered on the card, packed on the CPU: bitwise
#   equal). The median over the clients of the update's relative error
#   (||card - CPU|| / ||CPU update||, float32 ~1e-6) within TOL_STEP, and
#   each client's loss within TOL_LOSS, relative. TF32 (a 10-bit mantissa)
#   puts every client 3e-3 to 2e-2 off: the control runs the step with the
#   engine's float32 policy switched off and TF32 allowed, and must land
#   outside;
# - the first two rounds of bench.py's configuration, each from the same
#   entering weights: history (losses relative, accuracies absolute) and
#   params (absolute) within TOL_ROUND, set above that drift.
TOL_STEP = 1e-5
TOL_LOSS = 1e-5
TOL_ROUND = 1e-2
HIST_KEYS = ("train_loss", "train_acc", "test_loss", "test_acc")


def _round_from(api, r, state):
    """Round ``r`` from ``state`` through the engine (run_round, then the
    eval record train() keeps): (history record, params on the CPU)."""
    api.load_state(state)
    rec = api.eval_record(r, api.run_round(r))
    return rec, {k: v.detach().cpu().clone() for k, v in api.net.items()}


def _gaps(a, b):
    """(history, params) gaps of two (record, params) results."""
    (ra, na), (rb, nb) = a, b
    hist = max(abs(ra[k] - rb[k]) / max(1.0, abs(rb[k])) for k in HIST_KEYS)
    par = max(float((na[k] - nb[k]).abs().max()) for k in nb)
    return hist, par


def _client_steps(api, r, state):
    """One local step of each client of round ``r`` from ``state``, as
    run_round takes it: (the round's batch, each client's update
    [K, ...], each client's loss sum [K]), all on the CPU in float64."""
    from fedml_tpu_torch.algorithms import fedavg

    api.load_state(state)
    x, y, mask, _ = api._round_batch(r, api._sampled_ids(r))
    with fedavg.float32_compute():
        nets, metrics = api.local_update(api.net, x, y, mask)
    cpu = lambda t: t.detach().cpu().double()
    return ([t.cpu() for t in (x, y, mask)],
            {k: cpu(v - api.net[k]) for k, v in nets.items()},
            cpu(metrics["loss_sum"]))


def _step_gaps(a, b):
    """(median client update error, largest client loss error, largest
    client update error) of two _client_steps results on one batch."""
    if not all(torch.equal(p, q) for p, q in zip(a[0], b[0])):
        raise AssertionError("the card's and the CPU's batches differ")
    (_, ua, la), (_, ub, lb) = a, b
    sq = lambda u: sum((t.flatten(1) ** 2).sum(1) for t in u.values())
    err = (sq({k: ua[k] - ub[k] for k in ub}) / sq(ub)).sqrt()
    loss = float(((la - lb).abs() / lb.abs()).max())
    return float(err.median()), loss, float(err.max())


def _agree(name, got, tols, phase="main"):
    print(f"{phase}: {name}: " + ", ".join(
        f"{what} {v:.3e} (tol {t:g})" for (what, t), v in zip(tols, got))
        + "".join(f", {what} {v:.3e}" for what, v in zip(
            ("largest client update rel. err",), got[len(tols):])))
    if any(v > t for (_, t), v in zip(tols, got)):
        raise AssertionError(f"{name}: {got} beyond {tols}")


STEP_TOLS = (("median client update rel. err", TOL_STEP),
             ("client loss rel. diff", TOL_LOSS))
ROUND_TOLS = (("history max diff", TOL_ROUND), ("params max |diff|",
                                                TOL_ROUND))


def phase_main(report):
    from unittest import mock

    from fedml_tpu_torch import native
    from fedml_tpu_torch.algorithms import fedavg
    from fedml_tpu_torch.algorithms.fedavg import FedAvgAPI, FedAvgConfig
    from fedml_tpu_torch.core.tasks import classification_task
    from fedml_tpu_torch.data import load_dataset
    from fedml_tpu_torch.models import create_model

    t0 = time.perf_counter()
    data = load_dataset("femnist", seed=0, uint8_pixels=True)
    print(f"main: femnist stand-in {data.num_clients} clients, "
          f"{len(data.train_x)} train samples ({data.train_x.nbytes / 1e6:.1f}"
          f" MB {data.train_x.dtype}), {len(data.test_x)} test; set-up "
          f"{time.perf_counter() - t0:.1f} s")
    cfg = FedAvgConfig(comm_round=2, frequency_of_the_test=1, **MAIN_CFG)
    step_cfg = dataclasses.replace(cfg, max_batches=1)
    cnn = lambda device=None: classification_task(
        create_model("cnn", output_dim=62, device=device))

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    api = FedAvgAPI(data, cnn(), cfg, device_data=True)
    torch.cuda.synchronize()
    print(f"main: engine on the card (train set parked by device_data) in "
          f"{time.perf_counter() - t0:.2f} s; "
          f"{sum(v.numel() for v in api.net.values())} params, "
          f"{api.num_batches} batches a client")
    start = {k: v.detach().cpu().clone() for k, v in api.net.items()}
    fa.reset_launches()
    api.train()
    torch.cuda.synchronize()
    if any(fa.LAUNCHES.values()):
        raise AssertionError(f"flash kernels launched by the CNN path: "
                             f"{fa.LAUNCHES}")
    for rec in api.history:
        print(f"main: round {rec['round']}: train_loss {rec['train_loss']:.6f}"
              f" train_acc {rec['train_acc']:.4f} test_loss "
              f"{rec['test_loss']:.6f} test_acc {rec['test_acc']:.4f} "
              f"({rec['round_time']:.3f} s, train + eval, first rounds)")
        if not all(math.isfinite(float(v)) for v in rec.values()):
            raise AssertionError(f"non-finite metrics {rec}")
    if not all(bool(torch.isfinite(v).all()) for v in api.net.values()):
        raise AssertionError("non-finite parameters after training")

    # the same rounds by the port on the CPU, host-packed by the C++
    # packer, each from the card's weights entering it
    native.CALLS["pack_clients"] = 0
    t0 = time.perf_counter()
    cpu = FedAvgAPI(data, cnn("cpu"), cfg, device="cpu")
    cpu_step = FedAvgAPI(data, cnn("cpu"), step_cfg, device="cpu")
    step = FedAvgAPI(data, cnn(), step_cfg, device_data=True)
    cpu_s0 = _client_steps(cpu_step, 0, start)
    cpu0 = _round_from(cpu, 0, start)
    card0 = _round_from(api, 0, start)
    cpu_s1 = _client_steps(cpu_step, 1, card0[1])
    cpu1 = _round_from(cpu, 1, card0[1])
    print(f"main: CPU rounds in {time.perf_counter() - t0:.1f} s, "
          f"{native.CALLS['pack_clients']} packs by the C++ packer")
    if native.CALLS["pack_clients"] < 4:
        raise AssertionError("the CPU rounds did not pack through the C++ "
                             "packer")
    _agree("one step of round 0's clients, card vs CPU",
           _step_gaps(_client_steps(step, 0, start), cpu_s0), STEP_TOLS)
    _agree("one step of round 1's clients from the card's round-0 weights, "
           "card vs CPU", _step_gaps(_client_steps(step, 1, card0[1]),
                                     cpu_s1), STEP_TOLS)
    _agree("round 0, card vs CPU", _gaps(card0, cpu0), ROUND_TOLS)
    card1 = _round_from(api, 1, card0[1])
    _agree("round 1 from the card's round-0 weights, card vs CPU",
           _gaps(card1, cpu1), ROUND_TOLS)
    # again with the process's TF32 flags at PyTorch's defaults (cuDNN
    # convolutions may take TF32): the engine's own float32 policy holds;
    # the control switches the policy off, allows TF32 in the matmuls too,
    # and must miss
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    flags = cudnn.allow_tf32, matmul.allow_tf32
    cudnn.allow_tf32, matmul.allow_tf32 = True, False
    try:
        _agree("TF32 flags at defaults: one step of round 0's clients, card "
               "vs CPU", _step_gaps(_client_steps(step, 0, start), cpu_s0),
               STEP_TOLS)
        _agree("TF32 flags at defaults: round 0, card vs CPU",
               _gaps(_round_from(api, 0, start), cpu0), ROUND_TOLS)
        _agree("TF32 flags at defaults: round 1, card vs CPU",
               _gaps(_round_from(api, 1, card0[1]), cpu1), ROUND_TOLS)
        matmul.allow_tf32 = True
        with mock.patch.object(fedavg, "float32_compute",
                               contextlib.nullcontext):
            control = _step_gaps(_client_steps(step, 0, start), cpu_s0)
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = flags
    print(f"main: control, the engine's float32 policy off and TF32 allowed:"
          f" one step of round 0's clients: median client update rel. err "
          f"{control[0]:.3e}, client loss rel. diff {control[1]:.3e}, "
          f"largest client update rel. err {control[2]:.3e}")
    if not any(v > t for v, (_, t) in zip(control, STEP_TOLS)):
        raise AssertionError("the one-step check does not see TF32")
    del cpu, cpu_step, step
    first_peak = torch.cuda.max_memory_allocated()

    # timed rounds, then one round under the profiler and one eval
    api.load_state(card1[1])
    torch.cuda.reset_peak_memory_stats()
    per_round = MAIN_CFG["client_num_per_round"] * api.num_batches * \
        MAIN_CFG["batch_size"]
    for r in range(2, 5):
        spans_before = dict(api.tracer.rounds[-1])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = api.run_round(r)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        real = float(m["count"])
        sp = api._span_delta(spans_before)
        print(f"main: round {r}: {wall:.4f} s, {real / wall:.0f} train "
              f"samples/s ({real:.0f} real of {per_round} slots, "
              f"{per_round / wall:.0f} slots/s); host spans: pack "
              f"{sp['pack'] * 1e3:.2f} ms, round (dispatch) "
              f"{sp['round'] * 1e3:.2f} ms, then the wait for the card "
              f"{(wall - sp['pack'] - sp['round']) * 1e3:.2f} ms")
    busy = profile_round(api, 5, per_round, "sample slots", {
        "convolution": "conv|cudnn|fprop|dgrad|wgrad|implicit|im2col",
        "matmul": "gemm|cutlass|cublas|xmma"})
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ev = api.evaluate()
    print(f"main: eval on {int(ev['count'])} test samples in "
          f"{time.perf_counter() - t0:.3f} s: loss {ev['loss']:.6f} acc "
          f"{ev['acc']:.4f}")
    if not (math.isfinite(ev["loss"]) and 0.0 <= ev["acc"] <= 1.0):
        raise AssertionError(f"bad eval {ev}")
    print(f"main: peak device memory {torch.cuda.max_memory_allocated() / 2**20:.1f}"
          f" MiB over the timed rounds, the profiled round and the eval "
          f"({first_peak / 2**20:.1f} MiB over the agreement runs); device "
          f"busy share of the profiled round "
          f"{'not measured' if busy is None else f'{busy:.1%}'}")


# The cross-process runtime at MAIN_CFG: one server rank and ten client
# ranks as threads (run_simulated), each client fitting alone, and a job of
# 1 server + 2 client processes over MQTT. Its checks reuse main's
# tolerances and reasoning: one step of each client held sharply (the
# trainer's fits run on ten threads at once, as the ranks do, so a thread
# race in the float32 policy would put TF32 into some of them), full
# rounds each from the same entering weights within TOL_ROUND.
LAUNCH_TIMEOUT_S = 300
LAUNCH_ROUNDS = 2


def _state_on(state, device):
    return {k: v.to(device) for k, v in state.items()}


def _cpu_state(net):
    return {k: v.detach().cpu().clone() for k, v in net.items()}


def _trainer_steps(trainers, step_api, r, state):
    """One local step of each client of round ``r`` from ``state``, each
    through its own DistributedTrainer (rank k + 1 trains the round's k-th
    client), the ten fits on ten threads at once: (the batches padded to
    the engine's depth, each client's update [K, ...], loss sum [K]), on
    the CPU in float64, _client_steps's format."""
    import threading

    from fedml_tpu_torch.core.client_data import pad_batches

    ids = step_api._sampled_ids(r)
    cbs = []
    for tr, cid in zip(trainers, ids):
        tr.update_dataset(int(cid))
        tr.net = _state_on(state, tr.device)
        cbs.append(pad_batches(tr.pack(r), step_api.num_batches))
    errors = []

    def fit(tr):
        try:
            tr.fit(r)
        except BaseException as e:  # noqa: BLE001 — re-raised below
            errors.append(e)

    threads = [threading.Thread(target=fit, args=(tr,)) for tr in trainers]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    if errors:
        raise errors[0]
    cpu = lambda t: t.detach().cpu().double()
    batch = [torch.from_numpy(np.concatenate([getattr(cb, f) for cb in cbs]))
             for f in ("x", "y", "mask")]
    upd = {k: torch.stack([cpu(tr.net[k]) - state[k].double()
                           for tr in trainers]) for k in state}
    loss = torch.stack([cpu(tr.metrics["loss_sum"][0]) for tr in trainers])
    return batch, upd, loss


def _standalone_round(api, r, state):
    """Round ``r`` from ``state`` through the engine, scored as the
    distributed server scores it (the global test set): (eval, params)."""
    api.load_state(state)
    api.run_round(r)
    return api.evaluate(), _cpu_state(api.net)


def _dist_gaps(dist, ref):
    """(history, params) gaps of a distributed round (its server's eval
    record, params) against the engine's (_standalone_round)."""
    (rec, net), (ev, ref_net) = dist, ref
    hist = max(abs(rec["test_loss"] - ev["loss"]) / max(1.0, abs(ev["loss"])),
               abs(rec["test_acc"] - ev["acc"]))
    return hist, max(float((net[k] - ref_net[k]).abs().max()) for k in ref_net)


def _resumed_rounds(data, task, cfg, first, n, state, backend="LOOPBACK",
                    **backend_kw):
    """Rounds ``first`` .. ``first + n - 1`` over ``backend`` from ``state``
    (the server resumes at round ``first``, as a restarted one would):
    (the server's aggregator, the host time at the end of each round's
    aggregate, the launch's start time)."""
    from fedml_tpu_torch.distributed.fedavg import api as dist_api
    from fedml_tpu_torch.distributed.utils import launch_simulated

    cfg = dataclasses.replace(cfg, comm_round=first + n)
    size = cfg.client_num_per_round + 1
    server = dist_api.init_server(data, task, cfg, size, backend,
                                  **backend_kw)
    agg = server.aggregator
    agg.net = _state_on(state, agg.device)
    server.round_idx = first
    clients = [dist_api.init_client(data, task, cfg, rank, size, backend,
                                    **backend_kw) for rank in range(1, size)]
    stamps, aggregate = [], agg.aggregate

    def stamped():
        out = aggregate()
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        return out

    agg.aggregate = stamped
    t0 = time.perf_counter()
    launch_simulated(server, clients)
    return agg, stamps, t0


def _launch_job(argv, out_dir):
    """1 server + 2 client processes of the launcher, all started together:
    (rank 0's stdout, each rank's stderr, the launch's wall-clock start,
    rank 0's exit time). Every process is killed at LAUNCH_TIMEOUT_S or on
    any failure, and the phase fails."""
    import os

    env = {**os.environ, "PYTHONPATH": str(out_dir.parent)}
    procs, files, rcs = [], [], None
    t0 = time.time()
    try:
        for r in (0, 1, 2):
            out = open(out_dir / f"rank{r}.out", "w")
            err = open(out_dir / f"rank{r}.err", "w")
            files += [out, err]
            procs.append(subprocess.Popen(
                [sys.executable, "-m",
                 "fedml_tpu_torch.experiments.distributed_launch",
                 "--rank", str(r), *argv],
                cwd=out_dir.parent, env=env, stdout=out, stderr=err))
        deadline = time.monotonic() + LAUNCH_TIMEOUT_S
        rcs = [p.wait(timeout=max(1.0, deadline - time.monotonic()))
               for p in procs]
        t_end = time.time()
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in files:
            f.close()
        if rcs is None:  # timed out or failed to start: where each stood
            for r in (0, 1, 2):
                log = (out_dir / f"rank{r}.err").read_text()
                print(f"distributed: (d) rank {r}'s log ends:\n{log[-1500:]}")
    errs = [(out_dir / f"rank{r}.err").read_text() for r in (0, 1, 2)]
    if rcs != [0, 0, 0]:
        raise AssertionError(f"launcher ranks exited {rcs}; rank 0's log "
                             f"ends: {errs[0][-2000:]}")
    return (out_dir / "rank0.out").read_text(), errs, t0, t_end


def _launch_argv():
    """(d)'s launcher job: MAIN_CFG's data and model, 2 clients a round,
    over the bundled MQTT broker on a free port."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    return ["--world_size", "3", "--backend", "mqtt", "--broker_port",
            str(port), "--serve_broker", "1", "--dataset", "femnist",
            "--model", "cnn", "--batch_size", str(MAIN_CFG["batch_size"]),
            "--lr", str(MAIN_CFG["lr"]), "--comm_round", str(LAUNCH_ROUNDS),
            "--client_num_in_total", str(MAIN_CFG["client_num_in_total"]),
            "--frequency_of_the_test", "1", "--seed", "0"]


def _log_time(log, text):
    """Wall-clock time of the first logging line holding ``text``."""
    import datetime

    for line in log.splitlines():
        if text in line:
            stamp = datetime.datetime.strptime(line[:23],
                                               "%Y-%m-%d %H:%M:%S,%f")
            return stamp.timestamp()
    raise AssertionError(f"no log line holds {text!r}")


def phase_distributed(report):
    import importlib.util
    import socket
    import tempfile
    from pathlib import Path

    from fedml_tpu_torch.algorithms.fedavg import FedAvgAPI, FedAvgConfig
    from fedml_tpu_torch.comm.loopback import LoopbackCommManager
    from fedml_tpu_torch.comm.message import Message, pack_pytree, unpack_pytree
    from fedml_tpu_torch.core.tasks import classification_task
    from fedml_tpu_torch.data import load_dataset
    from fedml_tpu_torch.distributed.fedavg import api as dist_api
    from fedml_tpu_torch.distributed.fedavg import run_simulated
    from fedml_tpu_torch.distributed.fedavg.trainer import DistributedTrainer
    from fedml_tpu_torch.distributed.utils import launch_simulated
    from fedml_tpu_torch.models import create_model
    from fedml_tpu_torch.obs.comm_instrument import comm_counters

    data = load_dataset("femnist", seed=0, uint8_pixels=True)
    cfg = FedAvgConfig(comm_round=1, frequency_of_the_test=1, **MAIN_CFG)
    step_cfg = dataclasses.replace(cfg, max_batches=1)
    cnn = lambda: classification_task(create_model("cnn", output_dim=62))
    K = MAIN_CFG["client_num_per_round"]
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()
    api = FedAvgAPI(data, cnn(), cfg, device_data=True)
    start = _cpu_state(api.net)

    # (a) one step of each client of rounds 0 and 1, trainer vs engine
    step = FedAvgAPI(data, cnn(), step_cfg, device_data=True)
    shared = cnn()  # the ranks share one task, as run_simulated's do
    trainers = [DistributedTrainer(rank, data, shared, step_cfg)
                for rank in range(1, K + 1)]
    if not all(torch.equal(trainers[0].net[k].cpu(), start[k]) for k in start):
        raise AssertionError("the trainer's initial weights are not the "
                             "engine's")
    sa0 = _standalone_round(api, 0, start)
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    flags = cudnn.allow_tf32, matmul.allow_tf32
    try:
        for label in ("engine's flags", "TF32 flags at defaults"):
            if label != "engine's flags":
                cudnn.allow_tf32, matmul.allow_tf32 = True, False
            for r, state in ((0, start), (1, sa0[1])):
                _agree(f"{label}: one step of round {r}'s "
                       "clients, DistributedTrainer on 10 threads vs the "
                       "engine's batched step",
                       _step_gaps(_trainer_steps(trainers, step, r, state),
                                  _client_steps(step, r, state)), STEP_TOLS,
                       phase="distributed")
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = flags
    del step, trainers

    # (b) rounds 0 and 1 over loopback, each from the engine's entering
    # weights; the wire bytes of round 0 by direction
    before = comm_counters()
    t0 = time.perf_counter()
    agg = run_simulated(data, cnn(), cfg, job_id="smoke-round0")
    wall0 = time.perf_counter() - t0
    after = comm_counters()
    _agree("loopback round 0 (run_simulated) vs the engine",
           _dist_gaps((agg.history[-1], _cpu_state(agg.net)), sa0),
           ROUND_TOLS, phase="distributed")
    up = after["bytes_uplink"] - before["bytes_uplink"]
    down = after["bytes_downlink"] - before["bytes_downlink"]
    print(f"distributed: round 0 over loopback {wall0:.3f} s (set-up and "
          f"threads included); wire bytes: uplink {up:.0f}, downlink "
          f"{down:.0f} ({after['messages_sent'] - before['messages_sent']:.0f}"
          " frames, FINISH included)")
    sa1 = _standalone_round(api, 1, sa0[1])
    agg1, _, _ = _resumed_rounds(data, cnn(), cfg, 1, 1, sa0[1],
                                 job_id="smoke-round1")
    _agree("loopback round 1 from the engine's round-0 weights "
           "vs the engine", _dist_gaps((agg1.history[-1],
                                        _cpu_state(agg1.net)), sa1),
           ROUND_TOLS, phase="distributed")
    if importlib.util.find_spec("grpc") is None:
        print("distributed: gRPC was not run: grpcio is absent on this "
              "machine")
    else:
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            base = min(s.getsockname()[1], 65535 - 2 * (K + 1))
        agg_g = run_simulated(data, cnn(), cfg, backend="GRPC", base_port=base)
        _agree("gRPC round 0 (run_simulated) vs the engine",
               _dist_gaps((agg_g.history[-1], _cpu_state(agg_g.net)), sa0),
               ROUND_TOLS, phase="distributed")
        agg_g, _, _ = _resumed_rounds(data, cnn(), cfg, 1, 1, sa0[1],
                                      backend="GRPC", base_port=base + K + 1)
        _agree("gRPC round 1 from the engine's round-0 weights vs the "
               "engine", _dist_gaps((agg_g.history[-1],
                                     _cpu_state(agg_g.net)), sa1),
               ROUND_TOLS, phase="distributed")

    # one CNN frame's encode and decode, by step
    leaves = pack_pytree(api.net)
    times = {}

    def timed(name, fn, reps=5):
        out, ts = None, []
        for _ in range(reps):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            ts.append(time.perf_counter() - t1)
        times[name] = statistics.median(ts) * 1e3
        return out

    def build():
        msg = Message("c2s_send_model", 1, 0)
        msg.add_params("model_params", leaves)
        msg.add_params("num_samples", 560)
        msg.add_params("round_idx", 0)
        return msg

    timed("pack_pytree (D2H + to_flax)", lambda: pack_pytree(api.net))
    frame = timed("to_bytes (header + CRC32)", lambda: build().to_bytes())
    back = timed("from_bytes (CRC32 + views)", lambda: Message.from_bytes(frame))
    timed("unpack_pytree (from_flax + H2D)",
          lambda: unpack_pytree(api.net, back.get("model_params")))
    print(f"distributed: one CNN frame {len(frame)} bytes "
          f"({sum(v.nbytes for v in leaves)} of leaves); median of 5, ms: "
          + ", ".join(f"{k} {v:.3f}" for k, v in times.items()))

    # timed rounds 2-4 over loopback and through the engine
    per_round = {}
    for r in range(2, 5):
        ids = api._sampled_ids(r)
        per_round[r] = sum(min(len(data.train_idx_map[int(c)]),
                               MAIN_CFG["max_batches"] * MAIN_CFG["batch_size"])
                           for c in ids)
    agg_t, stamps, t_start = _resumed_rounds(
        data, cnn(), cfg, 2, 3, _cpu_state(agg1.net), job_id="smoke-timed")
    prev = t_start
    for r, t_end in zip(range(2, 5), stamps):
        wall = t_end - prev
        prev = t_end
        print(f"distributed: loopback round {r}: {wall:.4f} s, "
              f"{per_round[r] / wall:.0f} train samples/s "
              f"({per_round[r]} real; round 2 includes the threads' start)")
    api.load_state(_cpu_state(agg1.net))
    for r in range(2, 5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = api.run_round(r)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if int(m["count"]) != per_round[r]:
            raise AssertionError(f"round {r}: engine counts {m['count']}, "
                                 f"expected {per_round[r]}")
        print(f"distributed: engine round {r}: {wall:.4f} s, "
              f"{per_round[r] / wall:.0f} train samples/s")
    del agg_t

    # (c) elastic: rank K registered but silent; the deadline is set well
    # above this card's loopback round so it only fires on the silence
    timeout_s = max(5.0, 3 * wall0)
    size, job = K + 1, "smoke-elastic"
    agg_e = dist_api.FedAvgAggregator(data, cnn(), cfg, worker_num=K)
    server = dist_api.FedAvgServerManager(agg_e, rank=0, size=size,
                                          backend="LOOPBACK",
                                          round_timeout_s=timeout_s,
                                          job_id=job)
    dead = LoopbackCommManager(job, K, size)
    live = [dist_api.init_client(data, cnn(), cfg, rank, size, "LOOPBACK",
                                 job_id=job) for rank in range(1, K)]
    t0 = time.perf_counter()
    try:
        launch_simulated(server, live)
    finally:
        dead.stop_receive_message()
    nbytes = sum(v.numel() * v.element_size() for v in agg_e.net.values())
    if (len(agg_e.history) != 1 or agg_e.quarantine.entries()
            or agg_e._last_flush["stack_bytes"] != (K - 1) * nbytes
            or not all(bool(torch.isfinite(v).all())
                       for v in agg_e.net.values())):
        raise AssertionError(f"elastic round: history {agg_e.history}, "
                             f"flush {agg_e._last_flush}")
    print(f"distributed: elastic round over {K - 1} live ranks (rank {K} "
          f"silent, round_timeout_s {timeout_s:.1f}) in "
          f"{time.perf_counter() - t0:.2f} s: {agg_e.history[-1]}")

    # (d) 1 server + 2 client processes over MQTT against the in-process
    # loopback run of the same configuration (the launcher's float32 data)
    with tempfile.TemporaryDirectory(dir=Path(__file__).resolve().parent) as d:
        out, errs, t_launch, t_exit = _launch_job(_launch_argv(), Path(d))
    history = json.loads(out.strip().splitlines()[-1])
    fdata = load_dataset("femnist", seed=0)
    want = run_simulated(fdata, cnn(), FedAvgConfig(
        comm_round=LAUNCH_ROUNDS, client_num_in_total=MAIN_CFG[
            "client_num_in_total"], client_num_per_round=2,
        batch_size=MAIN_CFG["batch_size"], lr=MAIN_CFG["lr"],
        frequency_of_the_test=1, seed=0), job_id="smoke-launch-ref").history
    if [h["round"] for h in history] != [h["round"] for h in want]:
        raise AssertionError(f"process run history {history} vs {want}")
    gap = max(max(abs(a["test_loss"] - b["test_loss"]) / max(1.0, abs(b["test_loss"])),
                  abs(a["test_acc"] - b["test_acc"]))
              for a, b in zip(history, want))
    _agree("3 processes over MQTT vs the in-process loopback "
           "run", (gap,), (("history max diff", TOL_ROUND),),
           phase="distributed")
    up = [_log_time(errs[0], "server up")] + [
        _log_time(e, "bundled minimal client") for e in errs[1:]]
    evals = [_log_time(errs[0], f"server eval {{'round': {r},")
             for r in range(LAUNCH_ROUNDS)]
    fits = [[float(m) for m in re.findall(r"packed in ([0-9.]+) s", e)]
            for e in errs[1:]]
    print(f"distributed: processes: server up {up[0] - t_launch:.2f} s, "
          f"clients up {up[1] - t_launch:.2f} / {up[2] - t_launch:.2f} s "
          f"after launch; round 0 ends {evals[0] - up[0]:.2f} s after the "
          f"server's broadcast, round 1 takes {evals[1] - evals[0]:.2f} s; "
          f"the clients' fit + pack by round, s: {fits}; rank 0 exits "
          f"{t_exit - t_launch:.2f} s after launch")
    if any(fa.LAUNCHES.values()):
        raise AssertionError(f"flash kernels launched by the distributed "
                             f"CNN path: {fa.LAUNCHES}")
    print(f"distributed: peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB (this "
          "process; the launcher's processes not counted)")
    _transformer_job(report)


def _transformer_job(report):
    """(e) a TransformerLM crosses the wire: the slice's model and
    federation (4 clients a round, 2 SGD steps, T 2048) as 1 server and 4
    client ranks over loopback, each client fitting alone (B = its batch of
    4), every frame 16.8 MB; its rounds against the engine's, the cohort
    batched, from the same weights, within the slice's tolerance."""
    from fedml_tpu_torch.algorithms.fedavg import FedAvgAPI, FedAvgConfig
    from fedml_tpu_torch.core.tasks import sequence_task
    from fedml_tpu_torch.data.synthetic import synthetic_sequences
    from fedml_tpu_torch.distributed.fedavg import run_simulated
    from fedml_tpu_torch.models import create_model

    rounds = 2
    data = synthetic_sequences(
        num_clients=SLICE_FED["client_num_in_total"], seq_len=_T,
        vocab_size=SLICE_WIDTHS["vocab_size"], samples_per_client=8,
        test_samples=16)
    cfg = FedAvgConfig(comm_round=rounds, **SLICE_FED)
    lm = lambda: sequence_task(create_model("transformer_flash",
                                            **SLICE_WIDTHS))
    eng = FedAvgAPI(data, lm(), cfg)
    start, ref = _cpu_state(eng.net), []
    for r in range(rounds):
        eng.run_round(r)
        ref.append((eng.evaluate(), _cpu_state(eng.net)))
    fa.reset_launches()
    t0 = time.perf_counter()
    agg = run_simulated(data, lm(), cfg, job_id="smoke-lm")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(fa.LAUNCHES)
    steps = eng.num_batches * SLICE_WIDTHS["depth"]
    evals = SLICE_WIDTHS["depth"] * math.ceil(len(data.test_x)
                                              / cfg.eval_batch_size)
    K = cfg.client_num_per_round
    want = {"flash_fwd": rounds * (K * steps + evals),
            "flash_bwd_dq": rounds * K * steps,
            "flash_bwd_dkv": rounds * K * steps}
    report["launches_transformer_job"] = launches
    print(f"distributed: TransformerLM job ({sum(v.numel() for v in start.values())}"
          f" params, 1 server + {K} client ranks over loopback, {rounds} "
          f"rounds) in {wall:.2f} s; flash launches {launches}, expected "
          f"{want}")
    if launches != want:
        raise AssertionError(f"TransformerLM job launches {launches} != "
                             f"{want}")
    if [h["round"] for h in agg.history] != list(range(rounds)):
        raise AssertionError(f"TransformerLM job history {agg.history}")
    for rec, (ev, _) in zip(agg.history, ref):
        gap = max(abs(rec["test_loss"] - ev["loss"]) / max(1.0, abs(ev["loss"])),
                  abs(rec["test_acc"] - ev["acc"]))
        print(f"distributed: TransformerLM round {rec['round']}: test_loss "
              f"{rec['test_loss']:.7f} (engine {ev['loss']:.7f}), test_acc "
              f"{rec['test_acc']:.6f} (engine {ev['acc']:.6f}); history "
              f"max diff {gap:.3e} (tol {TOL_SLICE})")
        if gap > TOL_SLICE:
            raise AssertionError(f"TransformerLM round {rec['round']}: "
                                 f"{rec} vs the engine's {ev}")
    net = _cpu_state(agg.net)
    diff = max(float((net[k] - ref[-1][1][k]).abs().max()) for k in net)
    print(f"distributed: TransformerLM params after {rounds} rounds vs the "
          f"engine's: max |diff| {diff:.3e} (tol {TOL_SLICE})")
    if diff > TOL_SLICE:
        raise AssertionError(f"TransformerLM params differ by {diff}")


# The wire's tiers at MAIN_CFG: (label, client options, server options).
# Every run is WIRE_ROUNDS rounds over loopback from the same weights (the
# seed's init). Top-k ships 1 % of each leaf's entries.
WIRE_TIERS = (
    ("dense", {}, {}),
    ("delta", {"update_codec": "delta"}, {}),
    ("delta-int8 + EF", {"update_codec": "delta-int8"}, {}),
    ("delta-sign1 + EF", {"update_codec": "delta-sign1"}, {}),
    ("top-k 0.01 + EF", {"sparsify_ratio": 0.01}, {}),
    ("delta-int8 + delta_broadcast", {"update_codec": "delta-int8"},
     {"delta_broadcast": True}),
)
WIRE_ROUNDS = 2
# the reference's floors on uplink bytes against dense
# (tests/test_wire_codecs.py:516-544)
WIRE_FLOORS = {"delta-int8 + EF": 8.0, "delta-sign1 + EF": 25.0}
# test_wire_codecs.py:491-498's plan (rank 2's round-1 upload dropped,
# rank 1's uploads corrupted on arrival with probability 0.5, rank 3's
# uploads duplicated) plus a delayed downlink to rank 4
WIRE_CHAOS = {"seed": 7, "rules": [
    {"fault": "drop", "direction": "send", "src": [2], "dst": [0],
     "rounds": [1, 2]},
    {"fault": "corrupt", "direction": "recv", "src": [1], "dst": [0],
     "prob": 0.5},
    {"fault": "duplicate", "direction": "send", "src": [3], "dst": [0]},
    {"fault": "delay", "direction": "send", "src": [0], "dst": [4],
     "delay_s": 0.05}]}


def _wire_run(data, cfg, job, client_kw=None, server_kw=None,
              telemetry=None):
    """One loopback job of 1 server and client_num_per_round client ranks
    (threads) at ``cfg``, under whatever chaos plan is installed: the
    server's aggregator, each round's wall time (from the launch or the
    previous aggregate to the end of this one), what each aggregate
    folded (worker indices, summed sample weight), and the wire bytes and
    frames it moved."""
    from fedml_tpu_torch.core.tasks import classification_task
    from fedml_tpu_torch.distributed.fedavg import api as dist_api
    from fedml_tpu_torch.distributed.utils import launch_simulated
    from fedml_tpu_torch.models import create_model
    from fedml_tpu_torch.obs.comm_instrument import comm_counters

    size = cfg.client_num_per_round + 1
    task = classification_task(create_model("cnn", output_dim=62))
    server = dist_api.init_server(data, task, cfg, size, "LOOPBACK",
                                  job_id=job, telemetry=telemetry,
                                  **(server_kw or {}))
    clients = [dist_api.init_client(data, task, cfg, rank, size, "LOOPBACK",
                                    job_id=job, **(client_kw or {}))
               for rank in range(1, size)]
    agg = server.aggregator
    stamps, folds, aggregate = [], [], agg.aggregate

    def stamped():
        folds.append((sorted(agg.model_dict),
                      float(sum(agg.sample_num_dict.values()))))
        out = aggregate()
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        return out

    agg.aggregate = stamped
    before = comm_counters()
    t0 = time.perf_counter()
    launch_simulated(server, clients)
    after = comm_counters()
    delta = {k: after[k] - before[k] for k in
             ("bytes_uplink", "bytes_downlink", "messages_sent")}
    return dict(agg=agg, walls=[b - a for a, b in zip([t0] + stamps, stamps)],
                folds=folds, up=delta["bytes_uplink"],
                down=delta["bytes_downlink"], frames=delta["messages_sent"])


def _frame_ms(label, client_kw, server_kw, local, glob):
    """One upload of ``label``'s tier from a client holding the state
    ``local`` after a fit from the broadcast ``glob`` (state dicts on the
    card): (encode ms: pack_pytree, the tier's encode with its error
    feedback, to_bytes; decode ms: from_bytes, the server's densify
    against its stash, the copy to the card; frame bytes), medians of 5.
    With delta_broadcast, the downlink's round-delta frame is timed
    instead (server encode, client decode)."""
    from fedml_tpu_torch.comm import delta as dl
    from fedml_tpu_torch.comm import sparse
    from fedml_tpu_torch.comm.ef import ErrorFeedback
    from fedml_tpu_torch.comm.message import Message, pack_pytree, unpack_pytree
    from fedml_tpu_torch.distributed.fedavg.message_define import MyMessage as M

    g = pack_pytree(glob)
    codec, ratio = client_kw.get("update_codec"), client_kw.get("sparsify_ratio")
    ef = ErrorFeedback() if codec in ("delta-int8", "delta-sign1") or ratio \
        else None

    def encode():
        msg = Message(M.MSG_TYPE_C2S_SEND_MODEL_TO_SERVER, 1, 0)
        w = pack_pytree(local)
        if server_kw.get("delta_broadcast"):
            d = dl.round_delta(w, g)
            dl.apply_delta(g, d)  # the server's chain value
            msg.add_params(M.MSG_ARG_KEY_DELTA_PARAMS, d)
        elif ratio:
            comp = ef.compensate(sparse.topk_delta(w, g))
            idx, vals = sparse.topk_encode(comp, ratio)
            ef.update_residual(sparse.topk_residual(comp, idx))
            msg.add_params(M.MSG_ARG_KEY_SPARSE_IDX, idx)
            msg.add_params(M.MSG_ARG_KEY_SPARSE_VAL, vals)
        elif codec:
            comp = dl.round_delta(w, g)
            comp = ef.compensate(comp) if ef else comp
            payload, scales = dl.encode_update(comp, codec)
            if ef:
                ef.update(comp, dl.decode_update(payload, scales, codec, w))
            msg.add_params(M.MSG_ARG_KEY_UPDATE_CODEC, codec)
            msg.add_params(M.MSG_ARG_KEY_UPDATE_PAYLOAD, payload)
            msg.add_params(M.MSG_ARG_KEY_UPDATE_SCALE, scales)
        else:
            msg.add_params(M.MSG_ARG_KEY_MODEL_PARAMS, w)
        msg.add_params(M.MSG_ARG_KEY_NUM_SAMPLES, 560)
        msg.add_params(M.MSG_ARG_KEY_ROUND, 0)
        return msg.to_bytes()

    def decode(frame):
        m = Message.from_bytes(frame)
        if server_kw.get("delta_broadcast"):
            leaves = dl.apply_delta(g, m.get(M.MSG_ARG_KEY_DELTA_PARAMS))
        elif ratio:
            leaves = sparse.topk_decode(g, m.get(M.MSG_ARG_KEY_SPARSE_IDX),
                                        m.get(M.MSG_ARG_KEY_SPARSE_VAL))
        elif codec:
            leaves = dl.apply_delta(g, dl.decode_update(
                m.get(M.MSG_ARG_KEY_UPDATE_PAYLOAD), m.get(M.MSG_ARG_KEY_UPDATE_SCALE), codec, g))
        else:
            leaves = m.get(M.MSG_ARG_KEY_MODEL_PARAMS)
        out = unpack_pytree(glob, leaves)
        torch.cuda.synchronize()
        return out

    enc, dec = [], []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        frame = encode()
        t1 = time.perf_counter()
        decode(frame)
        dec.append(time.perf_counter() - t1)
        enc.append(t1 - t0)
    return (statistics.median(enc) * 1e3, statistics.median(dec) * 1e3,
            len(frame))


def _trace_rounds(tel, rounds):
    """Each round's spans by rank from a traced run, ms: {round: {rank:
    {span name: summed ms}}}."""
    from fedml_tpu_torch.obs.tracing import make_trace_id

    tids = {make_trace_id(tel.tracer.run_id, r): r for r in range(rounds)}
    out = {r: {} for r in range(rounds)}
    for s in tel.tracer.spans():
        r = tids.get(s["tid"])
        if r is None:
            continue
        by = out[r].setdefault(s["rank"], {})
        by[s["name"]] = by.get(s["name"], 0.0) + (s["t1"] - s["t0"]) * 1e3
    return out


def phase_wire(report):
    # the chaos pair and the traced run repeat runs that must be the same
    # bits: with cuDNN's default algorithms the card's fits do not repeat
    # (hier's finding), so the phase asks for deterministic ones
    was = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        _wire(report)
    finally:
        torch.backends.cudnn.deterministic = was


def _same_run(label, a, b, phase):
    """Two runs of one job (repeats, not two tiers): params bitwise and
    histories equal, or fail naming the gap."""
    na, nb = _cpu_state(a["agg"].net), _cpu_state(b["agg"].net)
    gap = max(float((na[k] - nb[k]).abs().max()) for k in nb)
    same = _bitwise(na, nb) and a["agg"].history == b["agg"].history
    print(f"{phase}: {label}: bitwise {same} (params max |diff| {gap:.3e})")
    if not same:
        raise AssertionError(f"{label}: not bitwise (max |diff| {gap:.3e})")


def _wire(report):
    from fedml_tpu_torch import chaos
    from fedml_tpu_torch.algorithms.fedavg import FedAvgConfig
    from fedml_tpu_torch.data import load_dataset
    from fedml_tpu_torch.obs.telemetry import Telemetry

    data = load_dataset("femnist", seed=0, uint8_pixels=True)
    cfg = FedAvgConfig(comm_round=WIRE_ROUNDS, frequency_of_the_test=1,
                       **MAIN_CFG)
    K = cfg.client_num_per_round
    fa.reset_launches()
    runs = {}
    for label, client_kw, server_kw in WIRE_TIERS:
        runs[label] = run = _wire_run(data, cfg, f"smoke-wire-{len(runs)}",
                                      client_kw, server_kw)
        agg = run["agg"]
        finite = all(bool(torch.isfinite(v).all()) for v in agg.net.values())
        print(f"wire: {label}: uplink {run['up']:.0f} B, downlink "
              f"{run['down']:.0f} B over {WIRE_ROUNDS} rounds "
              f"({run['frames']:.0f} frames); round walls "
              + ", ".join(f"{w:.3f}" for w in run["walls"])
              + f" s; history {[(h['round'], round(h['test_loss'], 6), round(h['test_acc'], 4)) for h in agg.history]}")
        if (not finite or agg.quarantine.entries()
                or [h["round"] for h in agg.history] != list(range(WIRE_ROUNDS))
                or not all(math.isfinite(h["test_loss"]) for h in agg.history)):
            raise AssertionError(f"{label}: finite params {finite}, "
                                 f"quarantine {agg.quarantine.entries()}, "
                                 f"history {agg.history}")
    dense = runs["dense"]
    start = _cpu_state(_initial_state(data, cfg))
    local = _state_on(_cpu_state(dense["agg"].net), "cuda")
    glob = _state_on(start, "cuda")
    report["wire"] = {}
    for label, client_kw, server_kw in WIRE_TIERS:
        run = runs[label]
        enc, dec, nbytes = _frame_ms(label, client_kw, server_kw, local, glob)
        report["wire"][label] = dict(up=run["up"], down=run["down"],
                                     walls=run["walls"], encode_ms=enc,
                                     decode_ms=dec, frame_bytes=nbytes)
        what = "downlink delta frame" if server_kw else "upload frame"
        print(f"wire: {label}: uplink {dense['up'] / run['up']:.2f}x below "
              f"dense, downlink {dense['down'] / run['down']:.2f}x; one "
              f"{what} {nbytes} B: encode {enc:.2f} ms, decode {dec:.2f} ms "
              f"on the host (median of 5)")
    for label, floor in WIRE_FLOORS.items():
        if dense["up"] / runs[label]["up"] < floor:
            raise AssertionError(f"{label}: uplink only "
                                 f"{dense['up'] / runs[label]['up']:.2f}x "
                                 f"below dense (floor {floor}x)")

    def gaps(a, b):
        ha, hb = a["agg"].history, b["agg"].history
        hist = max(max(abs(x["test_loss"] - y["test_loss"])
                       / max(1.0, abs(y["test_loss"])),
                       abs(x["test_acc"] - y["test_acc"]))
                   for x, y in zip(ha, hb))
        na, nb = _cpu_state(a["agg"].net), _cpu_state(b["agg"].net)
        return hist, max(float((na[k] - nb[k]).abs().max()) for k in nb)

    _agree("lossless delta uplink vs dense, from the same weights",
           gaps(runs["delta"], dense), ROUND_TOLS, phase="wire")

    # a seeded fault plan, twice, on delta-int8
    timeout_s = max(5.0, 4 * max(dense["walls"]))
    chaos_runs = []
    for i in range(2):
        plan = chaos.FaultPlan.from_json(WIRE_CHAOS)
        t0 = time.perf_counter()
        with chaos.installed(plan):
            run = _wire_run(data, cfg, f"smoke-wire-chaos-{i}",
                            {"update_codec": "delta-int8"},
                            {"round_timeout_s": timeout_s})
        run["wall"] = time.perf_counter() - t0
        run["ledger"] = plan.ledger.canonical()
        chaos_runs.append(run)
        agg = run["agg"]
        print(f"wire: chaos run {i} (delta-int8, round_timeout_s "
              f"{timeout_s:.1f}): {run['wall']:.2f} s; faults "
              f"{plan.ledger.counts()}; folds "
              f"{[(len(r), w) for r, w in run['folds']]}; quarantine "
              f"{agg.quarantine.canonical()}; history "
              f"{[(h['round'], round(h['test_loss'], 6)) for h in agg.history]}")
        for r, (ranks, weight) in enumerate(run["folds"]):
            ids = agg.client_sampling(r)
            want = float(sum(min(len(data.train_idx_map[int(ids[i])]),
                                 MAIN_CFG["max_batches"] * MAIN_CFG["batch_size"])
                             for i in ranks))
            if weight != want:
                raise AssertionError(f"chaos run {i} round {r}: folded "
                                     f"weight {weight}, the distinct "
                                     f"uploads of ranks {ranks} hold {want}")
        if not all(bool(torch.isfinite(v).all()) for v in agg.net.values()):
            raise AssertionError(f"chaos run {i}: non-finite params")
    a, b = chaos_runs
    if a["ledger"] != b["ledger"] or not a["ledger"]:
        raise AssertionError(f"fault ledgers differ: {a['ledger']} vs "
                             f"{b['ledger']}")
    if a["agg"].quarantine.canonical() != b["agg"].quarantine.canonical():
        raise AssertionError("quarantine ledgers differ")
    if {e[0] for e in a["ledger"]} != {"drop", "corrupt", "duplicate",
                                        "delay"}:
        raise AssertionError(f"not every fault fired: {a['ledger']}")
    print(f"wire: chaos: the two fault ledgers are equal ({len(a['ledger'])} "
          f"faults), so are the quarantine ledgers; every fold's sample "
          f"weight is its distinct uploads'")
    _same_run("chaos run 1 vs run 0", b, a, "wire")

    # one traced dense run
    tel = Telemetry(trace=True)
    traced = _wire_run(data, cfg, "smoke-wire-trace", telemetry=tel)
    tel.close()
    for r, ranks in _trace_rounds(tel, WIRE_ROUNDS).items():
        srv = ranks.pop(0, {})
        print(f"wire: trace round {r}: server " + ", ".join(
            f"{n} {srv[n]:.2f}" for n in ("round", "broadcast", "decode",
                                          "aggregate", "eval") if n in srv)
              + " ms")
        for rank in sorted(ranks):
            sp = ranks[rank]
            print(f"wire: trace round {r}: rank {rank} " + ", ".join(
                f"{n} {sp[n]:.2f}" for n in ("downlink", "unpack",
                                             "local_fit", "pack", "uplink")
                if n in sp) + " ms")
        if len(ranks) != K or not all({"unpack", "local_fit", "pack"}
                                      <= set(v) for v in ranks.values()):
            raise AssertionError(f"trace round {r}: ranks {ranks}")
    _same_run("traced dense run vs the untraced one", traced, dense, "wire")
    grown = (traced["up"] + traced["down"] - dense["up"] - dense["down"])
    print(f"wire: tracing grew the run's {traced['frames']:.0f} frames by "
          f"{grown:.0f} B in all ({grown / traced['frames']:.0f} B a frame)")
    if traced["frames"] != dense["frames"] or not 0 < grown < \
            4096 * traced["frames"]:
        raise AssertionError(f"traced frames {traced['frames']} vs "
                             f"{dense['frames']}, grown {grown} B")
    if any(fa.LAUNCHES.values()):
        raise AssertionError(f"flash kernels launched by the wire phase: "
                             f"{fa.LAUNCHES}")


# Byzantine-robust aggregation at MAIN_CFG (core/robust_agg.py,
# chaos/adversary.py). The plan: ranks 2 and 5 sign-flip their update
# x100 in every round, rank 7 uploads NaN in round 1. The factor puts the
# flippers past the gate's 4x median norm whatever their client: a client
# of 24 samples fits 2 batches where others fit 28, and x10 of its small
# update stayed inside 4x the median (round 1's rank 2 on the H100, and
# on the CPU from the same weights).
ROBUST_PLAN = {"seed": 5, "rules": [
    {"attack": "sign_flip", "ranks": [2, 5], "factor": 100.0},
    {"attack": "nan", "ranks": [7], "rounds": [1, 2]}]}
ROBUST_ROUNDS = 3
# Each of these rounds is held to the port's CPU run sharply over the
# card's own stack (the gate and estimator on both sides over the same
# fitted nets: reason codes equal, selections bitwise, the rest within
# TOL_ROBUST_REL) and, for the round as a whole from the same entering
# weights, on the attackers' verdicts. The whole round's params gap is
# printed beside main's TOL_ROUND and not held to it: the fits' rounding
# chaos (one client in ten meets a max-pool or ReLU tie a step) put one
# round of the gate-only mean 1.51e-2 off the CPU's on the H100, the same
# round 7.5e-4 off in another run; and an honest client's chaotic fit can
# move krum's suspected set, which rests on honest clients' margins.

# the defended legs' convergence is read after this many rounds (the
# first ROBUST_ROUNDS held to the CPU, the rest on the card alone): the
# CNN's eval loss on the stand-in barely leaves ln 62 in 3 rounds, even
# unattacked, so a verdict on a defense's loss needs the model to learn
ROBUST_CONV_ROUNDS = 40
ROBUST_CONVERGE = ("plain build", "no defense", "krum", "median")
ROBUST_ESTIMATORS = ("median", "trimmed_mean", "krum", "multi_krum",
                     "geometric_median")
# the estimators alone, card vs the port's CPU run of the same inputs:
# reason codes equal, selections (median, krum, the krum and medoid
# verdicts) bitwise, the arithmetic ones within this (max |diff| over max
# |value|; each sums at most 10 terms a coordinate, or 1.69 M a distance)
TOL_ROBUST_REL = 1e-5
ROBUST_BITWISE = ("median", "krum", "verdict_flush krum",
                  "verdict_flush median")


def _robust_stack(state, seed=0):
    """A [10, ...] stacked update of ``state`` (the seed's weights): client
    k's model is state + (1 + 0.1 k) x a seeded Gaussian update of 1e-2 x
    each entry's mean magnitude (scales apart, so no distance ties); slots
    2 and 5 carry their update x10, slot 7 is NaN. Sample weights drawn
    from 50..560 (a FEMNIST client's range at MAIN_CFG's 28 x 20 cap)."""
    rs = np.random.RandomState(seed)
    K = MAIN_CFG["client_num_per_round"]
    scale = (1.0 + 0.1 * np.arange(K, dtype=np.float32))
    scale[[2, 5]] *= 10.0
    stacked = {}
    for key, v in state.items():
        g = v.numpy()
        u = rs.standard_normal((K,) + g.shape).astype(np.float32)
        u *= np.float32(1e-2 * float(np.abs(g).mean()))
        s = g[None] + u * scale.reshape((K,) + (1,) * g.ndim)
        s[7] = np.nan
        stacked[key] = torch.from_numpy(s.astype(np.float32))
    w = torch.from_numpy(rs.randint(50, 561, K).astype(np.float32))
    return stacked, w


def _robust_calls(stacked, glob, w):
    """name -> fn() of each timed composition over the stack, the plain
    weighted mean first; each fn returns (avg, reasons)."""
    from fedml_tpu_torch.core import robust_agg as ra
    from fedml_tpu_torch.utils.tree import tree_weighted_mean

    K = MAIN_CFG["client_num_per_round"]
    mult = ra.DEFAULT_NORM_MULT
    calls = {"plain weighted mean":
             lambda: (tree_weighted_mean(stacked, w), None),
             "gate + weighted mean": lambda: ra.gated_aggregate(
                 stacked, glob, w, norm_mult=mult)[::2]}
    for name in ROBUST_ESTIMATORS:
        fn = ra.make_robust_aggregator(name, n=K)
        calls[name] = (lambda fn=fn: ra.gated_aggregate(
            stacked, glob, w, robust_fn=fn, norm_mult=mult)[::2])
    calls["pairwise mean"] = lambda: ra.gated_aggregate(
        stacked, glob, w, pairwise=True, norm_mult=mult)[::2]
    ev = ra.update_evidence(stacked, glob, w)
    calls["update_evidence"] = lambda: (ra.update_evidence(stacked, glob, w),
                                        None)
    for name in ("krum", "median"):
        vf = ra.make_verdict_estimator(name, n=K)
        calls[f"verdict_flush {name}"] = (lambda vf=vf: ra.verdict_flush(
            stacked, glob, ev, vf, norm_mult=mult)[::2])
    return calls


def _robust_estimators(start):
    """(a): every composition on the card, timed, against the port's CPU
    run of the same inputs."""
    from fedml_tpu_torch.algorithms.fedavg import float32_compute

    stacked, w = _robust_stack(start)
    glob = start
    card = _robust_calls(_state_on(stacked, "cuda"), _state_on(glob, "cuda"),
                         w.cuda())
    cpu = _robust_calls(stacked, glob, w)
    rows = {}
    with float32_compute():
        for name, fn in card.items():
            ms = _time_ms(fn)
            got, reasons = fn()
            if name == "plain weighted mean":
                # the baseline the attack poisons: slot 7's NaN reaches it
                rows[name] = dict(ms=ms)
                finite = all(bool(torch.isfinite(v).all())
                             for v in got.values())
                print(f"robust: {name}: {ms:.3f} ms (CUDA events, median of"
                      f" 7 x 5 calls); finite {finite}")
                if finite:
                    raise AssertionError("the NaN slot did not reach the "
                                         "plain weighted mean")
                continue
            want, want_reasons = cpu[name]()
            if name == "update_evidence":
                got, want = ({"sketch": got["sketch"], "norm": got["norm"]},
                             {"sketch": want["sketch"], "norm": want["norm"]})
            got = _cpu_state(got)
            err = max(float((got[k] - want[k]).abs().max()) for k in want)
            rel = err / max(float(v.abs().max()) for v in want.values())
            codes = None if reasons is None else reasons.cpu().tolist()
            rows[name] = dict(ms=ms, rel_err=rel, codes=codes)
            print(f"robust: {name}: {ms:.3f} ms (CUDA events, median of 7 x"
                  f" 5 calls); reasons {codes}; vs the CPU run: max |diff|"
                  f" {err:.3e}, relative {rel:.3e}")
            if (reasons is None) != (want_reasons is None) or (
                    codes is not None and codes != want_reasons.tolist()):
                raise AssertionError(f"{name}: reasons {codes} on the card, "
                                     f"{want_reasons} on the CPU")
            if name in ROBUST_BITWISE and err != 0.0:
                raise AssertionError(f"{name}: a selection, {err} off the "
                                     "CPU's")
            if name not in ROBUST_BITWISE and rel > TOL_ROBUST_REL:
                raise AssertionError(f"{name}: {rel} relative off the CPU's "
                                     f"(tol {TOL_ROBUST_REL})")
            if name != "update_evidence" and not all(
                    bool(torch.isfinite(v).all()) for v in got.values()):
                raise AssertionError(f"{name}: non-finite result")
    mean_ms = rows["plain weighted mean"]["ms"]
    print("robust: cost over the plain weighted mean: " + ", ".join(
        f"{n} {r['ms'] / mean_ms:.1f}x" for n, r in rows.items()
        if n != "plain weighted mean"))


def _named_every_round(ledger, rounds):
    """The plan's attackers in a round's ledger entries: ranks 2 and 5 as
    norm outliers or suspected in every round, rank 7 nonfinite in round
    1 (and nowhere else)."""
    for r in range(rounds):
        ent = {(e["rank"], e["reason"]) for e in ledger if e["round"] == r}
        for rank in (2, 5):
            if not ent & {(rank, "norm_outlier"), (rank, "suspected")}:
                raise AssertionError(f"round {r}: rank {rank} not named in "
                                     f"{sorted(ent)}")
        if ((7, "nonfinite") in ent) != (r == 1):
            raise AssertionError(f"round {r}: rank 7's nonfinite entry "
                                 f"{sorted(ent)}")


def _robust_wire_run(data, task, cfg, plan, agg_kw):
    """run_simulated over loopback under ``plan`` (the clients perturb their
    wire leaves) with the server's ``agg_kw``: the aggregator, each
    round's wall (from the launch or the previous aggregate to the end of
    this one) and each round's new global model on the CPU (copied after
    the round's time is taken)."""
    from unittest import mock

    from fedml_tpu_torch.distributed.fedavg import run_simulated
    from fedml_tpu_torch.distributed.fedavg.aggregator import FedAvgAggregator

    stamps, nets, aggregate = [], [], FedAvgAggregator.aggregate

    def stamped(self):
        out = aggregate(self)
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        nets.append(_cpu_state(self.net))
        return out

    with mock.patch.object(FedAvgAggregator, "aggregate", stamped):
        t0 = time.perf_counter()
        agg = run_simulated(data, task, cfg,
                            job_id=f"smoke-robust-{agg_kw['aggregator']}",
                            adversary_plan=plan, **agg_kw)
    return dict(agg=agg, nets=nets,
                walls=[b - a for a, b in zip([t0] + stamps, stamps)])


def _card_stack(api, r, state):
    """Round ``r``'s client nets from ``state`` as the engine stacks them
    for its aggregate (the batched fit, then the in-graph adversary), with
    the global model and the weights, on the card."""
    from fedml_tpu_torch.algorithms import fedavg

    api.load_state(state)
    x, y, mask, nsamp = api._round_batch(r, api._sampled_ids(r))
    with fedavg.float32_compute():
        nets, _ = api.local_update(api.net, x, y, mask)
        nets = api._adversary(nets, api.net, r)
    return nets, api.net, fedavg.agg_weights(nsamp, False)


def _composed_round(api, r, state, compose):
    """Round ``r`` of the engine from ``state`` with the aggregate composed
    by ``compose(nets, global, weights) -> (avg, _, reasons)``: (new
    params on the CPU, reason codes)."""
    from fedml_tpu_torch.algorithms import fedavg

    nets, glob, w = _card_stack(api, r, state)
    with fedavg.float32_compute():
        avg, _, reasons = compose(nets, glob, w)
    return _cpu_state(avg), reasons.cpu().tolist()


def _same_stack_gap(api, cpu, r, state):
    """The engine's gate + estimator over its own round-``r`` stack on the
    card against the CPU engine's over the same stack copied: (reason
    codes on the card, on the CPU, max |diff| over max |value|)."""
    from fedml_tpu_torch.algorithms import fedavg
    from fedml_tpu_torch.core import robust_agg as ra

    nets, glob, w = _card_stack(api, r, state)
    with fedavg.float32_compute():
        got, _, codes = ra.gated_aggregate(
            nets, glob, w, robust_fn=api._robust_agg,
            norm_mult=api._sanitize_mult)
    want, _, want_codes = ra.gated_aggregate(
        _cpu_state(nets), _cpu_state(glob), w.cpu(),
        robust_fn=cpu._robust_agg, norm_mult=cpu._sanitize_mult)
    got = _cpu_state(got)
    err = max(float((got[k] - want[k]).abs().max()) for k in want)
    return (codes.cpu().tolist(), want_codes.tolist(),
            err / max(float(v.abs().max()) for v in want.values()))


def _robust_engine(data, cfg, start):
    """(b): the engine under ROBUST_PLAN, one leg a defense beside the plain
    build and the undefended engine, ROBUST_ROUNDS rounds each held to the
    port's CPU run (see ROBUST_ROUNDS' note). Returns ({leg: (engine, its
    ledger, its params) after ROBUST_ROUNDS} for the legs of
    ROBUST_CONVERGE, the eval loss from the seed's weights)."""
    from fedml_tpu_torch import chaos
    from fedml_tpu_torch.algorithms.fedavg import FedAvgAPI
    from fedml_tpu_torch.core.tasks import classification_task
    from fedml_tpu_torch.models import create_model

    cnn = lambda device=None: classification_task(
        create_model("cnn", output_dim=62, device=device))
    legs = [("plain build", {}), ("no defense", {"adversary_plan": True}),
            ("mean (gate only)", {"adversary_plan": True, "sanitize": True})]
    legs += [(n, {"adversary_plan": True, "aggregator": n})
             for n in ROBUST_ESTIMATORS]
    armed = lambda kw: {k: (chaos.AdversaryPlan.from_json(ROBUST_PLAN)
                            if k == "adversary_plan" else v)
                        for k, v in kw.items()}
    engines, losses = {}, {}
    for label, kw in legs:
        matched = []
        api = FedAvgAPI(data, cnn(), cfg, device_data=True, **armed(kw))
        defended = "sanitize" in kw or "aggregator" in kw
        cpu = (FedAvgAPI(data, cnn("cpu"), cfg, device="cpu", **armed(kw))
               if defended else None)
        if label == "plain build":
            losses["initial"] = api.evaluate()["loss"]
        walls, spans, rest, gaps, same = [], [], [], [], []
        for r in range(ROBUST_ROUNDS):
            entering = _cpu_state(api.net)
            if cpu is not None:
                codes, want, rel = _same_stack_gap(api, cpu, r, entering)
                same.append(rel)
                if codes != want or rel > (0.0 if label in ROBUST_BITWISE
                                           else TOL_ROBUST_REL):
                    raise AssertionError(
                        f"{label} round {r}: over the card's own stack, "
                        f"reasons {codes} and the CPU's {want}, relative "
                        f"gap {rel}")
            before = dict(api.tracer.rounds[-1])
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            api.run_round(r)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            sp = api._span_delta(before)
            spans.append(sp["round"])
            # after the spans: an armed round's ledger read (its wait for
            # the card) and the final sync
            rest.append(walls[-1] - sp["round"] - sp.get("pack", 0.0))
            if cpu is None:
                continue
            cpu.load_state(entering)
            cpu.run_round(r)
            card_r, cpu_r = _cpu_state(api.net), _cpu_state(cpu.net)
            gaps.append(max(float((card_r[k] - cpu_r[k]).abs().max())
                            for k in cpu_r))
            attackers = lambda q: [e for e in q.for_round(r)
                                   if e["rank"] in (2, 5, 7)]
            if attackers(api.quarantine) != attackers(cpu.quarantine):
                raise AssertionError(
                    f"{label} round {r}: ledger {api.quarantine.for_round(r)} "
                    f"on the card, {cpu.quarantine.for_round(r)} on the CPU "
                    "from the same weights")
            matched.append(api.quarantine.for_round(r)
                           == cpu.quarantine.for_round(r))
        del cpu
        ev = api.evaluate()
        losses[label] = ev["loss"]
        print(f"robust: engine, {label}: round walls "
              + ", ".join(f"{w:.4f}" for w in walls) + " s, round spans "
              + ", ".join(f"{s * 1e3:.2f}" for s in spans) + " ms, after "
              "the spans (ledger read, the wait for the card) "
              + ", ".join(f"{s * 1e3:.2f}" for s in rest) + " ms; eval loss "
              f"{ev['loss']:.6f} acc {ev['acc']:.4f}"
              + ("" if not gaps else "; over the card's own stack vs the "
                 "CPU, relative gap by round " + ", ".join(
                     f"{g:.3e}" for g in same) + ", reasons equal; the round "
                 "vs the CPU's from the same weights, params by round "
                 + ", ".join(f"{g:.3e}" for g in gaps) + f" (main's "
                 f"{TOL_ROUND:g}, not held: see ROBUST_ROUNDS' note), "
                 f"attackers' verdicts equal, whole ledgers equal {matched}"))
        if defended:
            print(f"robust: engine, {label}: ledger "
                  f"{[(e['round'], e['rank'], e['reason']) for e in api.quarantine.entries()]}")
            _named_every_round(api.quarantine.entries(), ROBUST_ROUNDS)
        if label in ROBUST_CONVERGE:
            engines[label] = (api, api.quarantine.entries(),
                              _cpu_state(api.net))
    l0 = losses["initial"]
    print(f"robust: eval loss from the seed's weights {l0:.6f}; after "
          f"{ROBUST_ROUNDS} rounds: " + ", ".join(
              f"{k} {v:.6f}" for k, v in losses.items() if k != "initial"))
    return engines, l0


def _krum_picks(api):
    """Wrap the engine's krum so that each round records the slots of the
    gated stack its pick equals bitwise, with the stack's weights."""
    picks, krum = [], api._robust_agg

    def recorded(stacked, w):
        agg, info = krum(stacked, w)
        picks.append(([i for i in range(w.shape[0]) if all(
            torch.equal(v[i], agg[k]) for k, v in stacked.items())],
            w.cpu()))
        return agg, info

    api._robust_agg = recorded
    return picks


def _robust_converge(engines, l0):
    """(b), the defense's verdict: the ROBUST_CONVERGE legs go on from
    their ROBUST_ROUNDS-round weights to ROBUST_CONV_ROUNDS rounds on the
    card, read where the unattacked model has learned (at ROBUST_ROUNDS
    rounds the CNN's eval loss has barely left ln 62, the plain build's
    included): median's eval loss below the initial one, the undefended
    engine's not; krum's pick every round one gate-passed honest client's
    model, bitwise, and its eval loss finite. Krum takes one label-skewed
    client's model a round, so its loss is reported, not held below the
    initial one: it hovers around it (4.10-4.50 against 4.16 over 40
    rounds on the H100) while the plain build's falls to 0.02."""
    curves, picks = {}, None
    for label, (api, _, state) in engines.items():
        api.load_state(state)
        if label == "krum":
            picks = _krum_picks(api)
        curves[label] = []
        for r in range(ROBUST_ROUNDS, ROBUST_CONV_ROUNDS):
            api.run_round(r)
            if (r + 1) % 10 == 0:
                curves[label].append(api.evaluate()["loss"])
        print(f"robust: engine, {label}: eval loss after rounds "
              + ", ".join(f"{r}: {v:.6f}" for r, v in zip(
                  range(10, ROBUST_CONV_ROUNDS + 1, 10), curves[label])))
        if label in ("krum", "median"):
            _named_every_round(api.quarantine.entries(), ROBUST_CONV_ROUNDS)
    for r, (slots, w) in enumerate(picks, start=ROBUST_ROUNDS):
        if len(slots) != 1 or w[slots[0]] <= 0 or slots[0] + 1 in (2, 5):
            raise AssertionError(f"krum round {r}: its pick equals slots "
                                 f"{slots} (weights {w.tolist()})")
    print(f"robust: krum's pick, rounds {ROBUST_ROUNDS}-"
          f"{ROBUST_CONV_ROUNDS - 1}: one gate-passed honest client's model "
          f"each round, bitwise (ranks "
          f"{[slots[0] + 1 for slots, _ in picks]})")
    if not all(math.isfinite(v) for v in curves["krum"]):
        raise AssertionError(f"krum: eval losses {curves['krum']}")
    final = {k: v[-1] for k, v in curves.items()}
    if not final["median"] < l0:
        raise AssertionError(f"median: eval loss {final['median']} after "
                             f"{ROBUST_CONV_ROUNDS} rounds not below the "
                             f"initial {l0}")
    if final["no defense"] < l0:
        raise AssertionError(f"the undefended engine's loss "
                             f"{final['no defense']} fell below {l0}")


def _robust_wire(data, cfg, start, engines):
    """(c): run_simulated over loopback under ROBUST_PLAN on the clients,
    with krum and with the two-phase median: ledgers equal to the engine's
    legs', each round within TOL_ROUND of the engine's fit with the same
    composition from the wire's entering weights."""
    from fedml_tpu_torch import chaos
    from fedml_tpu_torch.core import robust_agg as ra
    from fedml_tpu_torch.core.tasks import classification_task
    from fedml_tpu_torch.models import create_model

    K = cfg.client_num_per_round
    wire_legs = (("krum", {"aggregator": "krum"}, "krum"),
                 ("median, sum_assoc='pairwise' (two-phase)",
                  {"aggregator": "median", "sum_assoc": "pairwise"},
                  "median"))
    for label, agg_kw, engine_leg in wire_legs:
        run = _robust_wire_run(
            data, classification_task(create_model("cnn", output_dim=62)),
            cfg, chaos.AdversaryPlan.from_json(ROBUST_PLAN), agg_kw)
        agg, (api, ledger, _) = run["agg"], engines[engine_leg]
        if agg.quarantine.entries() != ledger:
            raise AssertionError(f"wire {label}: ledger "
                                 f"{agg.quarantine.entries()}, the engine's "
                                 f"{ledger}")
        if agg_kw.get("sum_assoc") == "pairwise":
            vf = ra.make_verdict_estimator(agg_kw["aggregator"], n=K)
            compose = lambda n, g, w: ra.gated_aggregate(
                n, g, w, verdict_fn=vf, norm_mult=ra.DEFAULT_NORM_MULT)
        else:
            compose = lambda n, g, w: ra.gated_aggregate(
                n, g, w, robust_fn=api._robust_agg,
                norm_mult=api._sanitize_mult)
        gaps = []
        for r, (entering, got) in enumerate(zip([start] + run["nets"][:-1],
                                                run["nets"])):
            want, codes = _composed_round(api, r, entering, compose)
            gaps.append(max(float((got[k] - want[k]).abs().max())
                            for k in want))
            want_led = [(r, i + 1, ra.REASONS[c]) for i, c in
                        enumerate(codes) if c]
            got_led = [(e["round"], e["rank"], e["reason"])
                       for e in agg.quarantine.for_round(r)]
            if got_led != want_led:
                raise AssertionError(f"wire {label} round {r}: ledger "
                                     f"{got_led}, the engine's fit with "
                                     f"the same composition {want_led}")
        print(f"robust: wire, {label}: round walls "
              + ", ".join(f"{w:.3f}" for w in run["walls"]) + " s; ledger "
              f"equal to the engine's ({len(agg.quarantine)} entries); "
              "params vs the engine's fit + the same composition from the "
              "wire's entering weights, by round "
              + ", ".join(f"{g:.3e}" for g in gaps) + f" (tol {TOL_ROUND:g});"
              f" history {[(h['round'], round(h['test_loss'], 6)) for h in agg.history]}")
        if max(gaps) > TOL_ROUND:
            raise AssertionError(f"wire {label}: params {gaps} beyond "
                                 f"{TOL_ROUND}")


def phase_robust(report):
    from fedml_tpu_torch.algorithms.fedavg import FedAvgConfig
    from fedml_tpu_torch.data import load_dataset

    fa.reset_launches()
    data = load_dataset("femnist", seed=0, uint8_pixels=True)
    cfg = FedAvgConfig(comm_round=ROBUST_ROUNDS, frequency_of_the_test=1,
                       **MAIN_CFG)
    start = _cpu_state(_initial_state(data, cfg))
    _robust_estimators(start)
    engines, l0 = _robust_engine(data, cfg, start)
    _robust_wire(data, cfg, start, engines)
    _robust_converge(engines, l0)
    if any(fa.LAUNCHES.values()):
        raise AssertionError(f"flash kernels launched by the robust phase: "
                             f"{fa.LAUNCHES}")


# The hierarchical edge tier at MAIN_CFG (distributed/fedavg/hierarchy.py):
# 1 root, HIER_EDGES edge aggregator ranks of 2 cohort slots each (a power
# of two), the 10 workers. Tree == flat pairwise holds bitwise where both
# runs feed the folds the same client updates: the fits are probed for
# repeatability first, and (b) and (c) hold the runs bitwise if one client
# fitted twice from the same weights gives the same bits, else to
# TOL_ROUND a round with equal ledgers.
HIER_EDGES = 5
HIER_ROUNDS = 3
# (c)'s two-phase budgets a round: evidence sketch_dim + 3 float32 scalars
# a client, verdicts a weight and a reason code a slot, each plus 2 KiB of
# frame overhead an edge (test_hierarchy_robust.py's budget)
HIER_EVIDENCE_BUDGET = lambda k, e, sk: k * 4 * (sk + 3) + e * 2048
HIER_VERDICT_BUDGET = lambda k, e: k * 8 + e * 2048
# (d): edge rank 1 dark in round 1 (rule windows are half-open); the root
# marks it undeliverable and reprobes it every 4 rounds, so its block is
# lost in rounds 1-4 and back in round 5
HIER_CRASH = {"seed": 5, "rules": [
    {"fault": "crash", "ranks": [1], "rounds": [1, 2]}]}
HIER_CRASH_ROUNDS = 6
HIER_LOST_ROUNDS = (1, 2, 3, 4)
HIER_TIMEOUT_S = 3.0


def _bitwise(a: dict, b: dict) -> bool:
    return all(torch.equal(a[k].view(torch.int32), b[k].view(torch.int32))
               for k in b)


def _hier_folds(start):
    """(a): the edge tier's folds alone on one stacked [10, ...] CNN update
    on the card (robust's stack: slots 2 and 5 x10, slot 7 NaN; slot 4 at
    weight 0): edge partials over the 5 blocks + the root's combine
    against the flat pairwise fold, and the two-phase split against the
    flat two-phase flush with the krum and medoid verdicts, all bitwise,
    values and reason codes; the pieces timed."""
    from fedml_tpu_torch.algorithms.fedavg import float32_compute
    from fedml_tpu_torch.core import robust_agg as ra

    stacked, w = _robust_stack(start)
    w[4] = 0.0
    st, g, w = _state_on(stacked, "cuda"), _state_on(start, "cuda"), w.cuda()
    K = MAIN_CFG["client_num_per_round"]
    C = K // HIER_EDGES
    blocks = [slice(s, s + C) for s in range(0, K, C)]
    rows = lambda b: {k: v[b] for k, v in st.items()}
    mult = ra.DEFAULT_NORM_MULT

    def combine(parts):
        stackp = {k: torch.stack([p[0][k] for p in parts]) for k in g}
        return ra.combine_edge_partials(
            stackp, torch.stack([p[1] for p in parts]), g)[0]

    with float32_compute():
        want, _, want_r = ra.gated_aggregate(st, g, w, pairwise=True,
                                             norm_mult=float("inf"))
        parts = [ra.edge_partial(rows(b), g, w[b]) for b in blocks]
        got, got_r = combine(parts), torch.cat([p[2] for p in parts])
        checks = [("edge partials + combine vs gated_aggregate(pairwise)",
                   got, got_r, want, want_r)]
        full = ra.update_evidence(st, g, w)
        for name in ("krum", "median"):
            vf = ra.make_verdict_estimator(name, n=K)
            flat, _, flat_r = ra.gated_aggregate(st, g, w, verdict_fn=vf,
                                                 norm_mult=mult)
            ev = [ra.update_evidence(rows(b), g, w[b]) for b in blocks]
            cohort = {k: torch.cat([e[k] for e in ev]) for k in ev[0]}
            vw, r = ra.evidence_verdicts(cohort, vf, norm_mult=mult)
            split = combine([ra.apply_verdicts(rows(b), g, vw[b])
                             for b in blocks])
            checks.append((f"two-phase split vs gated_aggregate(verdict_fn="
                           f"{name})", split, r, flat, flat_r))
        same_rows = {k: torch.equal(full[k], cohort[k])
                     for k in ("norm", "finite", "sketch", "weight")}
        ms = {"one edge's partial (2 slots)": _time_ms(
                  lambda: ra.edge_partial(rows(blocks[0]), g, w[blocks[0]])),
              "the root's combine (5 partials)": _time_ms(
                  lambda: combine(parts)),
              "the flat pairwise fold (10 slots, gate)": _time_ms(
                  lambda: ra.gated_aggregate(st, g, w, pairwise=True,
                                             norm_mult=float("inf")))}
    for label, got, got_r, want, want_r in checks:
        same = _bitwise(got, want)
        print(f"hier: (a) {label}: values bitwise {same}, reasons "
              f"{got_r.tolist()} vs {want_r.tolist()}")
        if not same or got_r.tolist() != want_r.tolist():
            raise AssertionError(f"(a) {label}: not bitwise")
    print(f"hier: (a) per-block evidence rows bitwise the cohort's: "
          f"{same_rows}")
    print("hier: (a) " + ", ".join(f"{k} {v:.4f} ms" for k, v in ms.items())
          + " (CUDA events, median of 7 x 5 calls)")
    return ms


def _fit_repeatable(data, cfg, start, label="hier: (b)"):
    """(b)'s probe: one client of round 0 fitted twice on the card from the
    seed's weights by a DistributedTrainer; are the two results bitwise
    equal?"""
    from fedml_tpu_torch.comm.message import pack_pytree
    from fedml_tpu_torch.core.sampling import sample_clients
    from fedml_tpu_torch.core.tasks import classification_task
    from fedml_tpu_torch.distributed.fedavg.trainer import DistributedTrainer
    from fedml_tpu_torch.models import create_model

    trainer = DistributedTrainer(
        1, data, classification_task(create_model("cnn", output_dim=62)), cfg)
    cid = int(sample_clients(0, cfg.client_num_in_total,
                             cfg.client_num_per_round, cfg.seed)[0])
    fits = []
    for _ in range(2):
        trainer.update_model(pack_pytree(start))
        trainer.update_dataset(cid)
        trainer.fit(0)
        fits.append(_cpu_state(trainer.net))
    same = _bitwise(fits[0], fits[1])
    gap = max(float((fits[0][k] - fits[1][k]).abs().max()) for k in start)
    print(f"{label} determinism probe: client {cid} fitted twice from the "
          f"same weights: bitwise equal {same} (max |diff| {gap:.3e})")
    return same


def _hier_run(data, cfg, job, plan=None, telemetry=None, **kw):
    """run_simulated over loopback from the seed's weights (a tree with
    ``edges=``, else flat): the aggregator, each round's new global model
    on the CPU and wall (from the launch or the previous aggregate to the
    end of this one), the wire bytes it moved by direction."""
    from unittest import mock

    from fedml_tpu_torch import chaos
    from fedml_tpu_torch.core.tasks import classification_task
    from fedml_tpu_torch.distributed.fedavg import run_simulated
    from fedml_tpu_torch.distributed.fedavg.aggregator import FedAvgAggregator
    from fedml_tpu_torch.models import create_model
    from fedml_tpu_torch.obs.metrics import REGISTRY

    def by_direction():
        fam = REGISTRY.snapshot().get("comm_bytes_total", {})
        return {d: sum(v for k, v in fam.items() if f"direction={d}" in k)
                for d in ("uplink", "downlink", "evidence", "verdict")}

    stamps, nets, aggregate = [], [], FedAvgAggregator.aggregate

    def stamped(self):
        out = aggregate(self)
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        nets.append(_cpu_state(self.net))
        return out

    task = classification_task(create_model("cnn", output_dim=62))
    adv = None if plan is None else chaos.AdversaryPlan.from_json(plan)
    before = by_direction()
    with mock.patch.object(FedAvgAggregator, "aggregate", stamped):
        t0 = time.perf_counter()
        agg = run_simulated(data, task, cfg, job_id=job, adversary_plan=adv,
                            telemetry=telemetry, **kw)
    after = by_direction()
    return dict(agg=agg, nets=nets,
                walls=[b - a for a, b in zip([t0] + stamps, stamps)],
                bytes={d: after[d] - before[d] for d in after})


def _hier_pair(label, flat, tree, repeatable):
    """The tree against its flat pairwise twin: ledgers equal entry for
    entry; params bitwise every round if the fits repeat, else within
    TOL_ROUND; root fan-in HIER_EDGES a round."""
    rounds = len(tree["nets"])
    gaps = [max(float((a[k] - b[k]).abs().max()) for k in a)
            for a, b in zip(tree["nets"], flat["nets"])]
    bits = [_bitwise(a, b) for a, b in zip(tree["nets"], flat["nets"])]
    led, flat_led = (tree["agg"].quarantine.canonical(),
                     flat["agg"].quarantine.canonical())
    up = {n: r["bytes"]["uplink"] / rounds for n, r in (("tree", tree),
                                                         ("flat", flat))}
    print(f"hier: {label}: round walls tree "
          + ", ".join(f"{w:.3f}" for w in tree["walls"]) + " s, flat "
          + ", ".join(f"{w:.3f}" for w in flat["walls"]) + " s; root ingress"
          f" (update frames to rank 0) a round: tree {up['tree']:.0f} B "
          f"({HIER_EDGES} partials), flat {up['flat']:.0f} B "
          f"({MAIN_CFG['client_num_per_round']} uploads); params tree vs "
          "flat by round " + ", ".join(f"{g:.3e}" for g in gaps)
          + f", bitwise {bits}; ledgers equal {led == flat_led} "
          f"({len(led)} entries); fan-in {tree['agg'].fanin_history}")
    if len(tree["nets"]) != len(flat["nets"]) or led != flat_led:
        raise AssertionError(f"{label}: ledgers tree {led}, flat {flat_led}")
    if tree["agg"].fanin_history != [HIER_EDGES] * rounds:
        raise AssertionError(f"{label}: fan-in {tree['agg'].fanin_history}")
    if repeatable and not all(bits):
        raise AssertionError(f"{label}: the fits repeat, the runs are not "
                             f"bitwise ({gaps})")
    if max(gaps) > TOL_ROUND:
        raise AssertionError(f"{label}: params {gaps} beyond {TOL_ROUND}")


def _hier_crash(data, cfg):
    """(d): edge rank 1 crashed (HIER_CRASH) under the two-phase gate
    (sanitize) with the reference's crash test's deadline: its block's
    cohort ranks 1 and 2 ledgered edge_lost in each lost round, fan-in
    down to HIER_EDGES - 1 and back after the reprobe, each round's
    num_samples the reporting blocks' sample mass (numpy, from
    sample_clients and the packing cap)."""
    from fedml_tpu_torch import chaos
    from fedml_tpu_torch.core.sampling import sample_clients
    from fedml_tpu_torch.distributed.fedavg.trainer import num_batches_for
    from fedml_tpu_torch.obs.telemetry import Telemetry

    ccfg = dataclasses.replace(cfg, comm_round=HIER_CRASH_ROUNDS)
    tel = Telemetry()
    run = _hier_run(data, ccfg, "smoke-hier-crash", edges=HIER_EDGES,
                    sanitize=True, round_timeout_s=HIER_TIMEOUT_S,
                    chaos_plan=chaos.FaultPlan.from_json(HIER_CRASH),
                    telemetry=tel)
    recs = [r for r in tel.events.sink.records if r.get("kind") == "round"]
    tel.close()
    agg, K = run["agg"], cfg.client_num_per_round
    C = K // HIER_EDGES
    cap = cfg.batch_size * num_batches_for(
        max(len(v) for v in data.train_idx_map.values()), cfg)
    lost = sorted((e[0], e[1], e[3]) for e in agg.quarantine.canonical()
                  if e[2] == "edge_lost")
    want_lost, masses = [], []
    for r in range(HIER_CRASH_ROUNDS):
        ids = sample_clients(r, cfg.client_num_in_total, K, cfg.seed)
        gone = range(C) if r in HIER_LOST_ROUNDS else range(0)
        want_lost += [(r, s + 1, int(ids[s])) for s in gone]
        masses.append(float(sum(min(len(data.train_idx_map[int(ids[s])]),
                                    cap) for s in range(K) if s not in gone)))
    got_mass = [r["metrics"]["num_samples"] for r in recs]
    fan = [HIER_EDGES - (r in HIER_LOST_ROUNDS)
           for r in range(HIER_CRASH_ROUNDS)]
    print(f"hier: (d) edge rank 1 crashed in round 1: fan-in "
          f"{agg.fanin_history}; edge_lost {lost}; num_samples by round "
          f"{got_mass} (numpy {masses}); round walls "
          + ", ".join(f"{w:.3f}" for w in run["walls"]) + " s; rejected by "
          f"edge {[r['hier']['rejected'] for r in recs]}")
    if agg.fanin_history != fan or lost != sorted(want_lost):
        raise AssertionError(f"(d): fan-in {agg.fanin_history} (want {fan}),"
                             f" edge_lost {lost} (want {want_lost})")
    if got_mass != masses:
        raise AssertionError(f"(d): num_samples {got_mass}, numpy {masses}")
    return run


def phase_hier(report):
    from fedml_tpu_torch.algorithms.fedavg import FedAvgConfig
    from fedml_tpu_torch.core.robust_agg import EVIDENCE_SKETCH_DIM
    from fedml_tpu_torch.data import load_dataset
    from fedml_tpu_torch.obs.telemetry import Telemetry

    fa.reset_launches()
    data = load_dataset("femnist", seed=0, uint8_pixels=True)
    cfg = FedAvgConfig(comm_round=HIER_ROUNDS, frequency_of_the_test=1,
                       **MAIN_CFG)
    K = cfg.client_num_per_round
    start = _cpu_state(_initial_state(data, cfg))
    hier = report["hier"] = {"folds_ms": _hier_folds(start)}
    # the tree and its flat twin re-run every fit: with cuDNN's
    # nondeterministic algorithms the two drift apart at lr 0.1's chaos
    # (2.98e-08 a fit to 1.56e-2 by round 3 once), so, as in recover, the
    # phase asks cuDNN for deterministic ones and the probe says whether
    # the fits then repeat
    was = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        hier["repeatable"] = rep = _fit_repeatable(data, cfg, start)
        print("hier: (b), (c) hold the tree to the flat run "
              + ("bitwise" if rep else f"within {TOL_ROUND:g} a round, "
                 "ledgers equal (the fits do not repeat bit for bit)"))
        flat = _hier_run(data, cfg, "smoke-hier-flat",
                         sum_assoc="pairwise")
        tree = _hier_run(data, cfg, "smoke-hier-tree", edges=HIER_EDGES)
        _hier_pair("(b) plain", flat, tree, rep)
        for label, kw in (("krum", {"aggregator": "krum",
                                    "aggregator_params": {"f": 2}}),
                          ("median", {"aggregator": "median"})):
            flat = _hier_run(data, cfg, f"smoke-hier-flat-{label}",
                             plan=ROBUST_PLAN, sum_assoc="pairwise", **kw)
            tel = Telemetry()
            tree = _hier_run(data, cfg, f"smoke-hier-tree-{label}",
                             plan=ROBUST_PLAN, edges=HIER_EDGES,
                             telemetry=tel, **kw)
            recs = [r["hier"] for r in tel.events.sink.records
                    if r.get("kind") == "round"]
            tel.close()
            _hier_pair(f"(c) {label}", flat, tree, rep)
            _named_every_round(tree["agg"].quarantine.entries(),
                               HIER_ROUNDS)
            ev, vd = (tree["bytes"][d] / HIER_ROUNDS
                      for d in ("evidence", "verdict"))
            ev_cap = HIER_EVIDENCE_BUDGET(K, HIER_EDGES,
                                          EVIDENCE_SKETCH_DIM)
            vd_cap = HIER_VERDICT_BUDGET(K, HIER_EDGES)
            print(f"hier: (c) {label}: evidence {ev:.0f} B a round "
                  f"(budget {ev_cap}), verdicts {vd:.0f} B (budget "
                  f"{vd_cap}); hier rejected by round "
                  f"{[r['rejected'] for r in recs]}, verdict_rtt_s "
                  f"{[r['verdict_rtt_s'] for r in recs]}")
            if not (0 < ev <= ev_cap and 0 < vd <= vd_cap):
                raise AssertionError(f"(c) {label}: evidence {ev} B, "
                                     f"verdicts {vd} B a round")
            hier[label] = dict(
                evidence_b=ev, verdict_b=vd,
                verdict_rtt_s=[r["verdict_rtt_s"] for r in recs])
        _hier_crash(data, cfg)
    finally:
        torch.backends.cudnn.deterministic = was
    if any(fa.LAUNCHES.values()):
        raise AssertionError(f"flash kernels launched by the hier phase: "
                             f"{fa.LAUNCHES}")


# recover (b): 4 rounds; the crash rules name rank 0 (rule windows are
# half-open, after_uploads counts the round's accepted uploads)
RECOVER_ROUNDS = 4
RECOVER_CRASHES = {
    "between commits at round 2": [
        {"fault": "crash", "ranks": [0], "rounds": [2, 3]}],
    "mid-round after 3 uploads at round 1": [
        {"fault": "crash", "ranks": [0], "rounds": [1, 2],
         "after_uploads": 3}]}
RECOVER_LOST = {"between commits at round 2": 0,
                "mid-round after 3 uploads at round 1": 3}
# (c): K = cohort with bound 0 for 3 updates; K = 5 unbounded for 6 under
# a seeded straggle of ranks 2 and 7 (each uplink held 0.5 s)
ASYNC_PARITY_UPDATES = 3
ASYNC_K = 5
ASYNC_UPDATES = 6
ASYNC_STRAGGLE = {"seed": 3, "rules": [
    {"fault": "straggle", "src": [2, 7], "dst": [0], "delay_s": 0.5}]}
# (d): the root dies after 2 of the 5 edge partials of round 1
RECOVER_TREE_ROUNDS = 3
RECOVER_TREE_CRASH = [{"fault": "crash", "ranks": [0], "rounds": [1, 2],
                       "after_uploads": 2}]
RECOVER_TIMEOUT_S = 30.0  # never reached: every rank answers the probe


def _host_ms(fn, reps):
    """Median host wall of ``reps`` calls of ``fn`` (which syncs the card
    itself where it touches it), in ms."""
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def _durability_costs(start):
    """(a): the server state's npz save and restore on the card's host and
    one fsync'd WAL append."""
    import os
    import shutil
    import tempfile

    from fedml_tpu_torch.core.checkpoint import restore_round, save_round
    from fedml_tpu_torch.core.wal import RoundWAL

    d = tempfile.mkdtemp(prefix="smoke-recover-")
    try:
        net = _state_on(start, "cuda")
        rng = np.zeros(2, np.uint32)
        template = {"net": {k: torch.empty_like(v) for k, v in net.items()},
                    "server_opt_state": (), "rng": rng,
                    "round": np.asarray(0, np.int64)}
        got = {}

        def save():
            torch.cuda.synchronize()
            save_round(d, 0, net, (), rng, keep=1)

        def restore():
            got["state"] = restore_round(d, 0, template)
            torch.cuda.synchronize()

        save_ms = _host_ms(save, 7)
        nbytes = os.path.getsize(os.path.join(d, "round_000000.npz"))
        restore_ms = _host_ms(restore, 7)
        same = _bitwise(got["state"]["net"], net)
        wal = RoundWAL(os.path.join(d, "wal"))
        append_ms = _host_ms(lambda: wal.append(
            "upload", sync=True, round=0, rank=1, client=5, nsamp=560.0), 50)
        wal.close()
    finally:
        shutil.rmtree(d, ignore_errors=True)
    print(f"recover: (a) server state npz {nbytes} B: save (device->host, "
          f"write, fsync, rename) {save_ms:.3f} ms, restore (read, "
          f"host->device) {restore_ms:.3f} ms (median of 7), round trip "
          f"bitwise {same}; one WAL append(sync=True) {append_ms:.3f} ms "
          "(median of 50)")
    if not same:
        raise AssertionError("(a): the checkpoint round trip is not bitwise")
    return dict(npz_bytes=nbytes, save_ms=save_ms, restore_ms=restore_ms,
                wal_append_ms=append_ms)


@contextlib.contextmanager
def _recovery_clock():
    """Time the server's durability and recovery steps while in force:
    each _maybe_save, each boot's _maybe_resume (recovery seconds), each
    resume probe's round trip (probes out -> re-dispatch) and the fsyncs."""
    import os
    from unittest import mock

    from fedml_tpu_torch.distributed.fedavg.server_manager import (
        FedAvgServerManager as S,
    )

    t = dict(save=[], resume=[], probe=[], fsyncs=0)
    fsync, save = os.fsync, S._maybe_save
    resume, probes, complete = (S._maybe_resume, S._send_resume_probes,
                                S._complete_resume)

    def timed(key, fn):
        def wrapper(self, *a):
            t0 = time.perf_counter()
            try:
                return fn(self, *a)
            finally:
                t[key].append(time.perf_counter() - t0)
        return wrapper

    def probe_out(self):
        self._probe_t = time.perf_counter()
        return probes(self)

    def probe_back(self):
        if getattr(self, "_probe_t", None) is not None:
            t["probe"].append(time.perf_counter() - self._probe_t)
            self._probe_t = None
        return complete(self)

    def counted(fd):
        t["fsyncs"] += 1
        return fsync(fd)

    with mock.patch.object(S, "_maybe_save", timed("save", save)), \
            mock.patch.object(S, "_maybe_resume", timed("resume", resume)), \
            mock.patch.object(S, "_send_resume_probes", probe_out), \
            mock.patch.object(S, "_complete_resume", probe_back), \
            mock.patch("os.fsync", counted):
        yield t


def _recover_pair(label, twin, run, repeatable, lost, ranks):
    """A crashed run against its uninterrupted twin: each round's params
    bitwise if the fits repeat, else within TOL_ROUND; the ledger the
    twin's plus exactly ``lost`` server_restart slots of ``ranks``."""
    gaps = [max(float((a[k] - b[k]).abs().max()) for k in a)
            for a, b in zip(run["nets"], twin["nets"])]
    bits = [_bitwise(a, b) for a, b in zip(run["nets"], twin["nets"])]
    led = run["agg"].quarantine.canonical()
    rest = [e for e in led if e[2] != "server_restart"]
    gone = [e for e in led if e[2] == "server_restart"]
    print(f"recover: {label}: params vs the uninterrupted twin by round "
          + ", ".join(f"{g:.3e}" for g in gaps) + f", bitwise {bits}; "
          f"ledger {len(rest)} entries as the twin's "
          f"{rest == twin['agg'].quarantine.canonical()}, server_restart "
          f"{[(e[0], e[1], e[3]) for e in gone]}")
    if len(run["nets"]) != len(twin["nets"]):
        raise AssertionError(f"{label}: {len(run['nets'])} aggregates, "
                             f"twin {len(twin['nets'])}")
    if rest != twin["agg"].quarantine.canonical() or len(gone) != lost \
            or any(e[1] not in ranks for e in gone):
        raise AssertionError(f"{label}: ledger {led}")
    if repeatable and not all(bits):
        raise AssertionError(f"{label}: the fits repeat, the runs are not "
                             f"bitwise ({gaps})")
    if max(gaps) > TOL_ROUND:
        raise AssertionError(f"{label}: params {gaps} beyond {TOL_ROUND}")


def _flat_crashes(data, cfg, repeatable):
    """(b): the uninterrupted twins, then each crash of RECOVER_CRASHES."""
    import shutil
    import tempfile

    from fedml_tpu_torch import chaos
    from fedml_tpu_torch.core.wal import RoundWAL
    from fedml_tpu_torch.obs.metrics import REGISTRY

    out = {}
    twin = _hier_run(data, cfg, "smoke-recover-twin")
    d = tempfile.mkdtemp(prefix="smoke-recover-")
    try:
        with _recovery_clock() as clock:
            durable = _hier_run(data, cfg, "smoke-recover-ckpt", ckpt_dir=d)
    finally:
        shutil.rmtree(d, ignore_errors=True)
    _recover_pair("uninterrupted with ckpt_dir", twin, durable, repeatable,
                  0, ())
    save_ms = statistics.median(clock["save"]) * 1e3
    out["walls_s"] = twin["walls"]
    out["walls_ckpt_s"] = durable["walls"]
    out["save_ms"] = save_ms
    out["fsyncs_a_round"] = clock["fsyncs"] / cfg.comm_round
    print("recover: (b) round walls without ckpt_dir "
          + ", ".join(f"{w:.3f}" for w in twin["walls"]) + " s, with "
          + ", ".join(f"{w:.3f}" for w in durable["walls"]) + " s; "
          f"_maybe_save (npz + quarantine.json + commit) median "
          f"{save_ms:.3f} ms; {clock['fsyncs']} fsyncs in "
          f"{cfg.comm_round} rounds ({out['fsyncs_a_round']:.1f} a round)")
    hist = REGISTRY.histogram("fed_recovery_seconds")
    for label, rules in RECOVER_CRASHES.items():
        d = tempfile.mkdtemp(prefix="smoke-recover-")
        try:
            with _recovery_clock() as clock:
                run = _hier_run(data, cfg, f"smoke-recover-{len(out)}",
                                ckpt_dir=d, round_timeout_s=RECOVER_TIMEOUT_S,
                                chaos_plan=chaos.FaultPlan.from_json(
                                    {"seed": 1, "rules": rules}))
            rep = RoundWAL.replay(d + "/wal")
        finally:
            shutil.rmtree(d, ignore_errors=True)
        _recover_pair(f"(b) crash {label}", twin, run, repeatable,
                      RECOVER_LOST[label], range(1, 11))
        resumed = 2 if "between" in label else 1
        print(f"recover: (b) crash {label}: restart epochs "
              f"{rep.restart_epochs}, last commit {rep.last_commit}; "
              "recovery (checkpoint restore + WAL replay) "
              + ", ".join(f"{s * 1e3:.3f}" for s in clock["resume"])
              + " ms by boot; probe round trip "
              + (", ".join(f"{s * 1e3:.3f} ms" for s in clock["probe"])
                 or "none (no open round)")
              + f"; the resumed round {resumed}'s wall "
              f"{run['walls'][resumed]:.3f} s (twin "
              f"{twin['walls'][resumed]:.3f} s); fed_recovery_seconds "
              f"count {hist.count}")
        if rep.restart_epochs != 2 or rep.last_commit != cfg.comm_round - 1:
            raise AssertionError(f"(b) {label}: WAL epochs "
                                 f"{rep.restart_epochs}, last commit "
                                 f"{rep.last_commit}")
        out[label] = dict(recovery_ms=[s * 1e3 for s in clock["resume"]],
                          probe_rtt_ms=[s * 1e3 for s in clock["probe"]],
                          resumed_wall_s=run["walls"][resumed])
    return twin, out


def _async_runs(data, cfg, twin, repeatable):
    """(c): K = cohort with bound 0 against the sync twin, then K = 5
    unbounded against sync rounds under the same straggle plan."""
    from fedml_tpu_torch import chaos
    from fedml_tpu_torch.obs.telemetry import Telemetry

    K = cfg.client_num_per_round
    pcfg = dataclasses.replace(cfg, comm_round=ASYNC_PARITY_UPDATES)
    par = _hier_run(data, pcfg, "smoke-recover-async-par", async_buffer_k=K,
                    staleness_bound=0)
    head = dict(twin, nets=twin["nets"][:ASYNC_PARITY_UPDATES])
    _recover_pair(f"(c) async K={K} bound 0 vs sync", head, par, repeatable,
                  0, ())
    scfg = dataclasses.replace(cfg, comm_round=ASYNC_UPDATES)
    plan = lambda: chaos.FaultPlan.from_json(ASYNC_STRAGGLE)  # noqa: E731
    sync = _hier_run(data, scfg, "smoke-recover-sync-straggle",
                     chaos_plan=plan())
    tel = Telemetry()
    asy = _hier_run(data, scfg, "smoke-recover-async-straggle",
                    chaos_plan=plan(), async_buffer_k=ASYNC_K,
                    staleness="poly:0.5", telemetry=tel)
    recs = [r["async"] for r in tel.events.sink.records
            if r.get("kind") == "round"]
    tel.close()
    rate = lambda r: len(r["walls"]) / sum(r["walls"])  # noqa: E731
    out = dict(flushes_per_s=rate(asy), sync_rounds_per_s=rate(sync),
               staleness=[r["staleness"] for r in recs],
               shed=recs[-1]["shed"] if recs else {})
    print(f"recover: (c) under the straggle plan (ranks 2, 7 +0.5 s an "
          f"uplink): async K={ASYNC_K} {out['flushes_per_s']:.3f} flushes/s"
          f" ({len(asy['walls'])} in {sum(asy['walls']):.3f} s) vs sync "
          f"{out['sync_rounds_per_s']:.3f} rounds/s ({len(sync['walls'])} "
          f"in {sum(sync['walls']):.3f} s): x"
          f"{out['flushes_per_s'] / out['sync_rounds_per_s']:.2f}; "
          f"staleness by flush {out['staleness']}; sheds {out['shed']}; "
          f"flush fill {[r['buffer_fill_s'] for r in recs]} s")
    if len(asy["walls"]) != ASYNC_UPDATES or not all(
            bool(torch.isfinite(v).all()) for v in asy["nets"][-1].values()):
        raise AssertionError(f"(c): {len(asy['walls'])} flushes")
    return out


def _tree_crash(data, cfg, repeatable):
    """(d): a root crash mid-round under the 5 x 2 tree against the
    uninterrupted tree; every edge answers the recovered root's probe."""
    import shutil
    import tempfile
    from unittest import mock

    from fedml_tpu_torch import chaos
    from fedml_tpu_torch.distributed.fedavg import hierarchy

    tcfg = dataclasses.replace(cfg, comm_round=RECOVER_TREE_ROUNDS)
    twin = _hier_run(data, tcfg, "smoke-recover-tree", edges=HIER_EDGES)
    acks, handle = [], hierarchy.HierFedAvgServerManager.handle_message_resume_ack

    def recording(self, msg_params):
        acks.append(int(msg_params["sender"]))
        return handle(self, msg_params)

    d = tempfile.mkdtemp(prefix="smoke-recover-")
    try:
        with mock.patch.object(hierarchy.HierFedAvgServerManager,
                               "handle_message_resume_ack", recording):
            run = _hier_run(data, tcfg, "smoke-recover-tree-crash",
                            edges=HIER_EDGES, ckpt_dir=d,
                            round_timeout_s=RECOVER_TIMEOUT_S,
                            chaos_plan=chaos.FaultPlan.from_json(
                                {"seed": 1, "rules": RECOVER_TREE_CRASH}))
    finally:
        shutil.rmtree(d, ignore_errors=True)
    edges = set(range(1, HIER_EDGES + 1))
    _recover_pair("(d) tree root crash mid-round after 2 partials", twin,
                  run, repeatable, 2, edges)
    print(f"recover: (d) probe answered by edges {sorted(edges & set(acks))}"
          f" and {len(set(acks) - edges)} workers; fan-in after the "
          f"restart {run['agg'].fanin_history}")
    if not edges <= set(acks):
        raise AssertionError(f"(d): edges {sorted(edges - set(acks))} did "
                             "not answer the probe")


def phase_recover(report):
    from fedml_tpu_torch.algorithms.fedavg import FedAvgConfig
    from fedml_tpu_torch.data import load_dataset

    fa.reset_launches()
    data = load_dataset("femnist", seed=0, uint8_pixels=True)
    cfg = FedAvgConfig(comm_round=RECOVER_ROUNDS, frequency_of_the_test=1,
                       **MAIN_CFG)
    start = _cpu_state(_initial_state(data, cfg))
    rec = report["recover"] = {"durability": _durability_costs(start)}
    # a crashed run re-runs the fits a twin ran once: with cuDNN's
    # nondeterministic algorithms the two drift apart at lr 0.1's chaos
    # (2.98e-08 a fit, PR 8, to ~5e-3 by round 3), so this phase asks
    # cuDNN for deterministic ones and probes whether the fits then repeat
    was = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        rec["repeatable"] = rep = _fit_repeatable(data, cfg, start,
                                                  label="recover: (b)")
        twin, rec["flat"] = _flat_crashes(data, cfg, rep)
        rec["async"] = _async_runs(data, cfg, twin, rep)
        _tree_crash(data, cfg, rep)
    finally:
        torch.backends.cudnn.deterministic = was
    if any(fa.LAUNCHES.values()):
        raise AssertionError(f"flash kernels launched by the recover phase: "
                             f"{fa.LAUNCHES}")


# harden (a): the engine's async runner — K = cohort with bound 0 against
# the sync loop, then K = 5 under recover's straggle of slots 2 and 7
HARDEN_UPDATES = 3
HARDEN_ASYNC_K = 5
HARDEN_ASYNC_UPDATES = 6
# (b): a diurnal client trace thin enough that 3,400 clients leave fewer
# than 10 available in its trough (cohorts 10, 10, 6, 1), and a rank trace
# that holds out ranks {7}, {6, 9}, {8, 9, 10} in rounds 0-2
HARDEN_CHURN = dict(seed=4, base=0.002, amplitude=0.0018, period=4,
                    tz_spread=0.0)
HARDEN_CHURN_ROUNDS = 4
HARDEN_RANK_CHURN = dict(seed=2, rank_base=0.7, rank_amplitude=0.2,
                         period=4)
HARDEN_RANK_ROUNDS = 3
# (c), (d): accounted DP-FedAvg, C = 1, z = 1.1, so sd = z*C/m = 0.11
HARDEN_DP = dict(defense_type="dp", norm_bound=1.0, noise_multiplier=1.1)
HARDEN_DP_ROUNDS = 3
TOL_DP_STD = 0.01
HARDEN_DP_CRASH = [{"fault": "crash", "ranks": [0], "rounds": [1, 2],
                    "after_uploads": 3}]


def _cnn_task():
    from fedml_tpu_torch.core.tasks import classification_task
    from fedml_tpu_torch.models import create_model

    return classification_task(create_model("cnn", output_dim=62))


def _engine_repeatable(data, cfg, start):
    """One engine round from the same weights twice: bitwise equal?"""
    from fedml_tpu_torch.algorithms import FedAvgAPI

    api = FedAvgAPI(data, _cnn_task(), cfg, device_data=True)
    nets = []
    for _ in range(2):
        api.load_state(start)
        api.run_round(0)
        nets.append(_cpu_state(api.net))
    same = _bitwise(nets[0], nets[1])
    print(f"harden: determinism probe: engine round 0 run twice from the "
          f"same weights: bitwise equal {same}")
    return same


def _timed_rounds(api, rounds):
    """Host walls of ``rounds`` engine rounds, each synced on its end."""
    walls = []
    for r in range(rounds):
        t0 = time.perf_counter()
        api.run_round(r)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return walls


def _harden_async(data, cfg, start, repeatable):
    """(a): the engine's VirtualClockAsyncRunner."""
    from fedml_tpu_torch import chaos
    from fedml_tpu_torch.algorithms import FedAvgAPI
    from fedml_tpu_torch.core.async_buffer import sync_virtual_wallclock

    K = cfg.client_num_per_round
    pcfg = dataclasses.replace(cfg, comm_round=HARDEN_UPDATES)
    sync = FedAvgAPI(data, _cnn_task(), pcfg, device_data=True,
                     sanitize=True)
    sync.load_state(start)
    sync_walls = _timed_rounds(sync, HARDEN_UPDATES)
    eng = FedAvgAPI(data, _cnn_task(), pcfg, device_data=True, sanitize=True)
    eng.load_state(start)
    t0 = time.perf_counter()
    runner = eng.run_async(HARDEN_UPDATES, buffer_k=K, staleness="constant",
                           staleness_bound=0)
    torch.cuda.synchronize()
    async_s = time.perf_counter() - t0
    bits = _bitwise(sync.net, eng.net)
    gap = max(float((sync.net[k] - eng.net[k]).abs().max()) for k in eng.net)
    keys = bool(np.array_equal(sync.rng, eng.rng))
    ledger = sync.quarantine.canonical() == eng.quarantine.canonical()
    print(f"harden: (a) run_async K={K} bound 0, {HARDEN_UPDATES} updates "
          f"vs {HARDEN_UPDATES} run_rounds: params bitwise {bits} (max "
          f"|diff| {gap:.3e}), key chain equal {keys}, ledgers equal "
          f"{ledger} ({len(eng.quarantine.canonical())} entries); walls "
          f"sync {sum(sync_walls):.3f} s, async {async_s:.3f} s; "
          f"{runner.stats()}")
    if not (keys and ledger) or (repeatable and not bits) \
            or gap > TOL_ROUND:
        raise AssertionError("(a): run_async K = cohort, bound 0 is not "
                             "its sync twin")
    spec = {"seed": 3, "rules": [{"fault": "straggle", "src": [2, 7],
                                  "dst": [0], "delay_s": 0.5}]}
    scfg = dataclasses.replace(cfg, comm_round=HARDEN_ASYNC_UPDATES)
    eng = FedAvgAPI(data, _cnn_task(), scfg, device_data=True)
    eng.load_state(start)
    t0 = time.perf_counter()
    runner = eng.run_async(HARDEN_ASYNC_UPDATES, buffer_k=HARDEN_ASYNC_K,
                           staleness="poly:0.5",
                           chaos_plan=chaos.FaultPlan.from_json(spec))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    sync_clock = sync_virtual_wallclock(chaos.FaultPlan.from_json(spec), K,
                                        HARDEN_ASYNC_UPDATES)
    st = runner.stats()
    shed = {k: v for k, v in st["shed"].items() if v}
    print(f"harden: (a) run_async K={HARDEN_ASYNC_K} poly:0.5, slots 2 and 7 "
          f"+0.5 s virtual: {st['updates']} updates at virtual "
          f"{runner.clock:.3f} s vs the sync barrier's "
          f"{sync_clock:.3f} s (x{sync_clock / runner.clock:.2f}); host "
          f"wall {wall:.3f} s, {wall / HARDEN_ASYNC_UPDATES:.3f} s an "
          f"update; staleness by update "
          f"{[h['staleness'] for h in runner.history]}; sheds {shed}")
    finite = all(bool(torch.isfinite(v).all()) for v in eng.net.values())
    if st["updates"] != HARDEN_ASYNC_UPDATES or not finite \
            or runner.clock >= sync_clock:
        raise AssertionError(f"(a): {st}, finite {finite}")
    return dict(parity_bitwise=bits, parity_async_s=async_s,
                parity_sync_s=sum(sync_walls), virtual_s=runner.clock,
                sync_virtual_s=sync_clock, host_s_per_update=(
                    wall / HARDEN_ASYNC_UPDATES),
                staleness=[h["staleness"] for h in runner.history],
                shed=shed)


def _harden_churn(data, cfg, start):
    """(b): churned cohorts in the engine, rank-level churn on the wire."""
    from unittest import mock

    from fedml_tpu_torch import chaos
    from fedml_tpu_torch.algorithms import FedAvgAPI
    from fedml_tpu_torch.core.sampling import sample_available
    from fedml_tpu_torch.distributed.fedavg import run_simulated
    from fedml_tpu_torch.distributed.fedavg.message_define import MyMessage
    from fedml_tpu_torch.distributed.fedavg.server_manager import (
        FedAvgServerManager,
    )
    from fedml_tpu_torch.obs.metrics import REGISTRY
    from fedml_tpu_torch.obs.telemetry import Telemetry

    trace = chaos.ChurnTrace(**HARDEN_CHURN)
    ccfg = dataclasses.replace(cfg, comm_round=HARDEN_CHURN_ROUNDS,
                               churn_trace=trace)
    eng = FedAvgAPI(data, _cnn_task(), ccfg, device_data=True)
    eng.load_state(start)
    seen, batch = [], eng._round_batch

    def spy(r, ids):
        out = batch(r, ids)
        seen.append((np.asarray(ids).copy(), int(out[0].shape[0])))
        return out

    eng._round_batch = spy
    walls = _timed_rounds(eng, HARDEN_CHURN_ROUNDS)
    host = [sample_available(ccfg, r, trace)
            for r in range(HARDEN_CHURN_ROUNDS)]
    same = all(a.dtype == b.dtype and np.array_equal(a, b)
               for (a, _), b in zip(seen, host))
    ks = [k for _, k in seen]
    print(f"harden: (b) engine under a diurnal trace over "
          f"{cfg.client_num_in_total} clients: cohort sizes {ks} (host "
          f"{[len(h) for h in host]}), ids bitwise the host's {same}, "
          f"round walls " + ", ".join(f"{w:.3f}" for w in walls) + " s")
    if not same or ks != [len(h) for h in host] or max(ks) == min(ks):
        raise AssertionError(f"(b): cohorts {ks} against {host}")
    rtrace = chaos.ChurnTrace(**HARDEN_RANK_CHURN)
    size = cfg.client_num_per_round + 1
    offline = [rtrace.scheduled_offline_ranks(r, size)
               for r in range(HARDEN_RANK_ROUNDS)]
    sent, servers = [], []
    send, run = FedAvgServerManager.send_message, FedAvgServerManager.run

    def spy_send(self, msg):
        sent.append((self.round_idx, int(msg.get_receiver_id()),
                     msg.get_type()))
        return send(self, msg)

    def spy_run(self):
        servers.append(self)
        return run(self)

    def suspects():
        fam = REGISTRY.snapshot().get("fed_suspected_rank", {})
        return sum(fam.values())

    tel = Telemetry()
    before = suspects()
    rcfg = dataclasses.replace(cfg, comm_round=HARDEN_RANK_ROUNDS,
                               frequency_of_the_test=1)
    t0 = time.perf_counter()
    with mock.patch.object(FedAvgServerManager, "send_message", spy_send), \
            mock.patch.object(FedAvgServerManager, "run", spy_run):
        agg = run_simulated(data, _cnn_task(), rcfg, job_id="smoke-churn",
                            telemetry=tel, churn_trace=rtrace)
    wall = time.perf_counter() - t0
    recs = [r for r in tel.events.sink.records if r.get("kind") == "round"]
    tel.close()
    got = [sorted({rk for rr, rk, ty in sent
                   if rr == r and ty != MyMessage.MSG_TYPE_S2C_FINISH})
           for r in range(HARDEN_RANK_ROUNDS)]
    want = [sorted(set(range(1, size)) - o) for o in offline]
    blocks = [r.get("churn") for r in recs]
    print(f"harden: (b) loopback under a rank trace: offline by round "
          f"{[sorted(o) for o in offline]}, frames sent to "
          f"{[len(g) for g in got]} ranks a round (none to an offline "
          f"one: {got == want}), suspects {suspects() - before}, "
          f"undeliverable {servers[-1]._undeliverable}, ledger "
          f"{agg.quarantine.canonical()}, churn blocks {blocks}; "
          f"{HARDEN_RANK_ROUNDS} rounds in {wall:.3f} s")
    if got != want or suspects() != before or servers[-1]._undeliverable \
            or blocks != [{"scheduled_offline": len(o), "idle_rounds": 0}
                          for o in offline]:
        raise AssertionError("(b): the rank trace's offline ranks were "
                             "not skipped silently")
    return dict(cohorts=ks, engine_walls_s=walls, wire_s=wall,
                offline=[sorted(o) for o in offline])


def _harden_dp_engine(data, cfg, start):
    """(c): accounted DP in the engine, the noise drawn on the card."""
    from fedml_tpu_torch.algorithms import FedAvgAPI, FedAvgRobustAPI
    from fedml_tpu_torch.core.privacy import DPAccountant
    from fedml_tpu_torch.core.robust import gaussian_noise_like
    from fedml_tpu_torch.utils import prng

    dcfg = dataclasses.replace(cfg, comm_round=HARDEN_DP_ROUNDS)
    api = FedAvgRobustAPI(data, _cnn_task(), dcfg, device_data=True,
                          **HARDEN_DP)
    api.load_state(start)
    z, C, m = (HARDEN_DP["noise_multiplier"], HARDEN_DP["norm_bound"],
               cfg.client_num_per_round)
    gaps, hook = [], api.post_aggregate_hook

    def spy(net, key):
        out = hook(net, key)
        gaps.append(torch.cat([(out[k] - net[k]).flatten() for k in net]))
        return out

    api.post_aggregate_hook = spy
    host, eps, walls = DPAccountant(), [], []
    for r in range(HARDEN_DP_ROUNDS):
        t0 = time.perf_counter()
        api.run_round(r)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        host.step(m / cfg.client_num_in_total, z)
        eps.append((api.epsilon(), host.epsilon(1e-5)))
    stds = [float(g.double().std()) for g in gaps]
    sd = z * C / m
    rel = [abs(s / sd - 1.0) for s in stds]
    # the draw alone, on the card, and its bits against the host's
    key = prng.split(prng.key(11))[1]
    noise_ms = _time_ms(lambda: gaussian_noise_like(key, api.net))
    n = sum(v.numel() for v in api.net.values())
    card_bits = prng.random_bits_torch(key, (n,), "cuda").cpu().numpy()
    bits_same = bool(np.array_equal(card_bits.astype(np.uint32),
                                    prng.random_bits(key, (n,))))
    card = prng.normal_torch(key, (n,), "cuda").cpu().numpy()
    ref = prng.normal(key, (n,))
    erf_rel = float(np.max(np.abs(card - ref) / np.maximum(np.abs(ref),
                                                           1e-30)))
    erf_bitwise = float(np.mean(card == ref))
    others = {}
    for name, kw in (("norm_diff_clipping", dict(
            defense_type="norm_diff_clipping", norm_bound=C)),
            ("plain", None)):
        other = (FedAvgRobustAPI(data, _cnn_task(), dcfg, device_data=True,
                                 **kw) if kw is not None
                 else FedAvgAPI(data, _cnn_task(), dcfg, device_data=True))
        other.load_state(start)
        others[name] = _timed_rounds(other, HARDEN_DP_ROUNDS)
    print(f"harden: (c) DP engine (C {C}, z {z}, m {m}): eps by round "
          + ", ".join(f"{a:.6f} (host {b:.6f})" for a, b in eps)
          + f"; std(noised - clipped mean) "
          + ", ".join(f"{s:.6f}" for s in stds)
          + f" vs z*C/m {sd:.6f} (rel {max(rel):.2e}); Threefry bits on "
          f"the card bitwise the host's {bits_same} ({n} words), normals "
          f"vs the host's erfinv max rel {erf_rel:.2e}, {erf_bitwise:.1%} "
          f"bitwise; noise draw {noise_ms:.3f} ms on the card; round walls "
          f"dp " + ", ".join(f"{w:.3f}" for w in walls) + " s, clipping "
          + ", ".join(f"{w:.3f}" for w in others["norm_diff_clipping"])
          + " s, plain " + ", ".join(f"{w:.3f}" for w in others["plain"])
          + " s")
    if any(a != b for a, b in eps) or max(rel) > TOL_DP_STD \
            or not bits_same or erf_rel > 1e-5:
        raise AssertionError("(c): the DP engine is off its contract")
    return dict(eps=[a for a, _ in eps], std_rel=rel, noise_ms=noise_ms,
                erfinv_max_rel=erf_rel, erfinv_bitwise_share=erf_bitwise,
                walls_dp_s=walls, walls_clip_s=others["norm_diff_clipping"],
                walls_plain_s=others["plain"])


def _dp_wire_run(data, cfg, job, **kw):
    """fedavg_robust.run_simulated (dp) over loopback: the aggregator,
    each aggregate's new global model on the CPU, and the walls."""
    from unittest import mock

    from fedml_tpu_torch.distributed import fedavg_robust as dist

    stamps, nets, aggregate = [], [], dist.FedAvgRobustAggregator.aggregate

    def stamped(self):
        out = aggregate(self)
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        nets.append(_cpu_state(self.net))
        return out

    with mock.patch.object(dist.FedAvgRobustAggregator, "aggregate",
                           stamped):
        t0 = time.perf_counter()
        agg = dist.run_simulated(data, _cnn_task(), cfg, job_id=job,
                                 **HARDEN_DP, **kw)
    return dict(agg=agg, nets=nets,
                walls=[b - a for a, b in zip([t0] + stamps, stamps)])


def _harden_dp_wire(data, cfg, repeatable):
    """(d): a crashed DP server against its uninterrupted twin."""
    import shutil
    import tempfile

    from fedml_tpu_torch import chaos
    from fedml_tpu_torch.core.privacy import DPAccountant

    wcfg = dataclasses.replace(cfg, comm_round=HARDEN_DP_ROUNDS,
                               frequency_of_the_test=1)
    twin = _dp_wire_run(data, wcfg, "smoke-harden-dp-twin")
    d = tempfile.mkdtemp(prefix="smoke-harden-")
    try:
        with _recovery_clock() as clock:
            run = _dp_wire_run(data, wcfg, "smoke-harden-dp-crash",
                               ckpt_dir=d, round_timeout_s=RECOVER_TIMEOUT_S,
                               chaos_plan=chaos.FaultPlan.from_json(
                                   {"seed": 1, "rules": HARDEN_DP_CRASH}))
    finally:
        shutil.rmtree(d, ignore_errors=True)
    _recover_pair("(d) DP crash after 3 uploads of round 1", twin, run,
                  repeatable, 3, range(1, cfg.client_num_per_round + 1))
    q = cfg.client_num_per_round / cfg.client_num_in_total
    z = HARDEN_DP["noise_multiplier"]
    e_twin, e_run = twin["agg"].epsilon(), run["agg"].epsilon()
    e_over = DPAccountant().step(q, z, rounds=HARDEN_DP_ROUNDS + 1).epsilon(
        1e-5)
    keys = bool(np.array_equal(twin["agg"]._noise_rng, run["agg"]._noise_rng))
    print(f"harden: (d) DP over loopback: eps {e_run:.6f} vs the "
          f"uninterrupted {e_twin:.6f} (one round more would be "
          f"{e_over:.6f}); noise key equal {keys}; recovery "
          + ", ".join(f"{s * 1e3:.3f}" for s in clock["resume"])
          + " ms by boot; probe round trip "
          + ", ".join(f"{s * 1e3:.3f} ms" for s in clock["probe"])
          + "; walls twin " + ", ".join(f"{w:.3f}" for w in twin["walls"])
          + " s, crashed " + ", ".join(f"{w:.3f}" for w in run["walls"])
          + " s")
    if not (e_twin <= e_run <= e_over) or not keys:
        raise AssertionError(f"(d): eps {e_run} vs {e_twin}")
    return dict(eps=e_run, eps_twin=e_twin, noise_key_equal=keys,
                recovery_ms=[s * 1e3 for s in clock["resume"]],
                walls_twin_s=twin["walls"], walls_crash_s=run["walls"])


def phase_harden(report):
    from fedml_tpu_torch.algorithms.fedavg import FedAvgConfig
    from fedml_tpu_torch.data import load_dataset

    fa.reset_launches()
    data = load_dataset("femnist", seed=0, uint8_pixels=True)
    cfg = FedAvgConfig(comm_round=HARDEN_UPDATES, frequency_of_the_test=100,
                       **MAIN_CFG)
    start = _cpu_state(_initial_state(data, cfg))
    rec = report["harden"] = {}
    # bits on the card need deterministic cuDNN (recover's finding)
    was = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        rep = _engine_repeatable(data, cfg, start)
        rec["async"] = _harden_async(data, cfg, start, rep)
        rec["churn"] = _harden_churn(data, cfg, start)
        rec["dp_engine"] = _harden_dp_engine(data, cfg, start)
        wire_rep = _fit_repeatable(data, cfg, start, label="harden: (d)")
        rec["dp_wire"] = _harden_dp_wire(data, cfg, wire_rep)
    finally:
        torch.backends.cudnn.deterministic = was
    if any(fa.LAUNCHES.values()):
        raise AssertionError(f"flash kernels launched by the harden phase: "
                             f"{fa.LAUNCHES}")


# observe: 3 engine rounds armed and unarmed, 2 rounds a fleet run
OBSERVE_ROUNDS = 3
OBSERVE_FLEET_ROUNDS = 2
# the CNN's forward, FLOPs a sample, as FlopCounterMode counts it (every
# tap of the padded convolutions; utils/flops.py)
CNN_FWD_FLOPS = 24_599_552


def _observe_engine(data, cfg, start):
    """(a): the engine armed with the live bundle beside an unarmed one."""
    import shutil
    import tempfile
    import urllib.request

    from fedml_tpu_torch.algorithms import FedAvgAPI
    from fedml_tpu_torch.obs import Telemetry, goodput
    from fedml_tpu_torch.utils.flops import forward_flops

    d = tempfile.mkdtemp(prefix="smoke-observe-")
    tel = Telemetry(log_dir=d, http_port=0, memwatch=True, health=True)
    plain = FedAvgAPI(data, _cnn_task(), cfg, device_data=True)
    armed = FedAvgAPI(data, _cnn_task(), cfg, device_data=True,
                      telemetry=tel)
    plain.load_state(start)
    armed.load_state(start)
    walls = {"plain": [], "armed": []}
    # the allocator's peak so far is the process's (earlier phases, the
    # set-up): each armed round starts a fresh one, so its record's
    # device_peak_bytes is that round's own
    process_peak = torch.cuda.max_memory_allocated()
    resident = []
    for r in range(OBSERVE_ROUNDS):
        for name, api in (("plain", plain), ("armed", armed)):
            if name == "armed":
                torch.cuda.synchronize()
                resident.append(torch.cuda.memory_allocated())
                torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            api.run_round(r)
            torch.cuda.synchronize()
            walls[name].append(time.perf_counter() - t0)
    # memwatch's peak and the allocator's, read back to back: the same
    # allocator key under memwatch's gpu:<i> label
    block = tel.memwatch.sample()
    peak = torch.cuda.max_memory_allocated()
    scraped = {p: urllib.request.urlopen(tel.httpd.url(p), timeout=10)
               .read().decode() for p in ("/metrics", "/healthz")}
    tel.close()
    with open(f"{d}/events.jsonl") as f:
        recs = [r for r in map(json.loads, f) if r.get("kind") == "round"]
    shutil.rmtree(d, ignore_errors=True)
    same = _bitwise(_cpu_state(plain.net), _cpu_state(armed.net))
    variant = f"round_b{cfg.max_batches}"
    fwd = forward_flops(armed.task, armed.net, data.train_x[:1])
    want = 3.0 * CNN_FWD_FLOPS * cfg.client_num_per_round \
        * cfg.max_batches * cfg.batch_size
    cost = goodput.variant_cost(variant)
    print(f"observe: (a) model bits armed vs unarmed after "
          f"{OBSERVE_ROUNDS} rounds: bitwise {same}; forward {fwd:.0f} "
          f"FLOPs a sample; {variant}: {cost['flops'] / 1e9:.4f} GFLOP a "
          f"round (3 x forward x {cfg.client_num_per_round} x "
          f"{cfg.max_batches} x {cfg.batch_size} = {want / 1e9:.4f})")
    out = dict(bitwise=same, fwd_flops=fwd, round_flops=cost["flops"],
               walls_plain_s=walls["plain"], walls_armed_s=walls["armed"],
               process_peak_bytes=process_peak, resident_bytes=resident,
               rounds=[])
    # a round's peak holds at least what was resident when it began and
    # the cohort's stacked copy of the model (K x the parameters' bytes)
    stack_bytes = cfg.client_num_per_round * sum(
        v.numel() * v.element_size() for v in armed.net.values())
    for r, rec in enumerate(recs):
        gp, pk, mem = rec["goodput"], rec["pack"], rec["mem"]
        total = sum(gp["buckets"].values())
        # compute = the host's dispatch (the round span) + the wait for
        # the card after it
        dispatch = rec["spans"]["round"]
        wait = gp["buckets"]["compute"] - dispatch
        print(f"observe: (a) round {r}: dispatch (round span) "
              f"{dispatch:.4f} s, wait for the card {wait:.4f} s, pack "
              f"{rec['spans']['pack']:.4f} s: dispatch "
              f"{dispatch / gp['wall_s']:.4f} of the wall")
        print(f"observe: (a) round {r}: wall armed {walls['armed'][r]:.4f} "
              f"s, unarmed {walls['plain'][r]:.4f} s; goodput wall "
              f"{gp['wall_s']:.4f} s, buckets " + ", ".join(
                  f"{b} {gp['buckets'][b]:.4f}" for b in goodput.BUCKETS)
              + " s; duty " + ", ".join(
                  f"{b} {gp['duty'][b]:.4f}" for b in goodput.BUCKETS)
              + f"; {gp.get('flops_per_s', 0) / 1e12:.4f} TFLOP/s, mfu "
              f"{gp.get('mfu')}; pack {pk}; mem {mem}")
        out["rounds"].append(dict(goodput=gp, pack=pk, mem=mem,
                                  dispatch_s=dispatch, wait_s=wait))
        if abs(total - gp["wall_s"]) > 1e-5 or "mfu" not in gp \
                or not gp.get("flops_per_s") or gp["variant"] != variant:
            raise AssertionError(f"round {r}: goodput {gp}")
        print(f"observe: (a) round {r}: device peak "
              f"{mem['device_peak_bytes']} B = resident at its start "
              f"{resident[r]} B + {mem['device_peak_bytes'] - resident[r]} "
              f"B (the cohort's stacked model alone {stack_bytes} B)")
        if pk["bucket_B"] != cfg.max_batches or \
                mem.get("device_peak_bytes", 0) < resident[r] + stack_bytes:
            raise AssertionError(f"round {r}: pack {pk}, mem {mem}, "
                                 f"resident {resident[r]}, stack "
                                 f"{stack_bytes}")
    hz = json.loads(scraped["/healthz"])
    print(f"observe: (a) memwatch device_peak_bytes {block['device_peak_bytes']}"
          f" vs torch.cuda.max_memory_allocated() {peak} (the last armed "
          f"round's; the process's before the rounds {process_peak}); "
          f"/metrics "
          f"{len(scraped['/metrics'])} B, /healthz status {hz['status']}, "
          f"round {hz['round']}, alerts {hz['alerts']}")
    out.update(device_peak_bytes=block["device_peak_bytes"],
               max_memory_allocated=peak, healthz=hz["status"])
    if not same or fwd != CNN_FWD_FLOPS or cost["flops"] != want:
        raise AssertionError(f"(a): bitwise {same}, forward {fwd}, cost "
                             f"{cost}")
    if block["device_peak_bytes"] != peak or hz["status"] != "ok" or \
            "fed_goodput_mfu" not in scraped["/metrics"] or \
            len(recs) != OBSERVE_ROUNDS:
        raise AssertionError(f"(a): peak {block['device_peak_bytes']} vs "
                             f"{peak}, healthz {hz}, {len(recs)} records")
    return out


def _observe_fleet(data, cfg):
    """(b): the fleet plane, flat and under the tree, beside plane-off runs
    of the same jobs."""
    import urllib.request

    from fedml_tpu_torch.obs import Telemetry
    from fedml_tpu_torch.obs.fleet import DIGEST_BYTE_BUDGET
    from fedml_tpu_torch.obs.metrics import REGISTRY

    def telemetry_bytes():
        return float(REGISTRY.snapshot().get("comm_bytes_total", {}).get(
            "codec=json,direction=telemetry", 0.0))

    cfg = dataclasses.replace(cfg, comm_round=OBSERVE_FLEET_ROUNDS)
    K, out = cfg.client_num_per_round, {}
    for topo, kw in (("flat", {}), ("tree", {"edges": HIER_EDGES})):
        off = _hier_run(data, cfg, f"smoke-observe-{topo}-off", **kw)
        before = telemetry_bytes()
        tel = Telemetry(fleet=True, http_port=0, memwatch=False)
        on = _hier_run(data, cfg, f"smoke-observe-{topo}-on", telemetry=tel,
                       **kw)
        fz = json.loads(urllib.request.urlopen(
            tel.httpd.url("/fleetz"), timeout=10).read())
        recs = [r for r in tel.events.sink.records
                if r.get("kind") == "round"]
        tel.close()
        nbytes = telemetry_bytes() - before
        ranks = sorted(int(r) for r in fz["ranks"])
        world = 1 + K + (HIER_EDGES if kw else 0)
        per_digest = nbytes / max(fz["digests_total"], 1)
        same = _bitwise(off["nets"][-1], on["nets"][-1])
        duty = [r["goodput"]["duty"] for r in recs]
        print(f"observe: (b) {topo}: /fleetz ranks {ranks}, digests "
              f"{fz['digests_total']} ({nbytes:.0f} B, {per_digest:.1f} B a "
              f"digest, budget {DIGEST_BYTE_BUDGET}), rollup {fz['rollup']};"
              f" server duty by round {duty}; walls plane on "
              + ", ".join(f"{w:.3f}" for w in on["walls"]) + " s, off "
              + ", ".join(f"{w:.3f}" for w in off["walls"])
              + f" s; model bits vs plane off: bitwise {same}")
        out[topo] = dict(ranks=ranks, digests=fz["digests_total"],
                         digest_bytes=per_digest, duty=duty, bitwise=same,
                         walls_on_s=on["walls"], walls_off_s=off["walls"])
        # every rank a row: the flat run's ten workers report directly, the
        # tree's through their edge's folded blob (rank 0's own row too)
        if ranks != list(range(world)) or not same or \
                per_digest > DIGEST_BYTE_BUDGET or \
                len(recs) != cfg.comm_round or any(
                    "flops_per_s" in r["goodput"] or abs(sum(
                        r["goodput"]["buckets"].values())
                        - r["goodput"]["wall_s"]) > 1e-5 for r in recs):
            raise AssertionError(f"(b) {topo}: ranks {ranks}, bitwise "
                                 f"{same}, {per_digest} B a digest, "
                                 f"records {recs}")
    return out


def _observe_profile(data, cfg, start):
    """(c): Telemetry.profile around one engine round."""
    import glob
    import os
    import shutil
    import tempfile

    from fedml_tpu_torch.algorithms import FedAvgAPI
    from fedml_tpu_torch.obs import Telemetry

    api = FedAvgAPI(data, _cnn_task(), cfg, device_data=True)
    api.load_state(start)
    d = tempfile.mkdtemp(prefix="smoke-profile-")
    tel = Telemetry()
    with tel.profile(d):
        api.run_round(0)
        torch.cuda.synchronize()
    tel.close()
    files = glob.glob(os.path.join(d, "*.pt.trace.json"))
    size = sum(os.path.getsize(f) for f in files)
    events = []
    for name in files:
        with open(name) as f:
            events += json.load(f).get("traceEvents", [])
    shutil.rmtree(d, ignore_errors=True)
    kernels = sum(1 for e in events if e.get("cat") == "kernel")
    print(f"observe: (c) profile(): {len(files)} trace file(s), {size} B, "
          f"{len(events)} events, {kernels} CUDA kernel events")
    if len(files) != 1 or not size or not kernels:
        raise AssertionError(f"(c): {files}, {size} B, {kernels} kernels")
    return dict(trace_bytes=size, events=len(events), kernels=kernels)


def phase_observe(report):
    from fedml_tpu_torch.algorithms.fedavg import FedAvgConfig
    from fedml_tpu_torch.data import load_dataset

    fa.reset_launches()
    data = load_dataset("femnist", seed=0, uint8_pixels=True)
    cfg = FedAvgConfig(comm_round=OBSERVE_ROUNDS, frequency_of_the_test=100,
                       **MAIN_CFG)
    start = _cpu_state(_initial_state(data, cfg))
    rec = report["observe"] = {}
    # armed against unarmed and plane on against off are bitwise claims
    was = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        rec["engine"] = _observe_engine(data, cfg, start)
        rec["fleet"] = _observe_fleet(data, cfg)
        rec["profile"] = _observe_profile(data, cfg, start)
    finally:
        torch.backends.cudnn.deterministic = was
    if any(fa.LAUNCHES.values()):
        raise AssertionError(f"flash kernels launched by the observe phase: "
                             f"{fa.LAUNCHES}")


# secure: 2 rounds a loopback job; the crash and shed plans hit round 1
SECURE_ROUNDS = 2
SECURE_SCALE = 2.0 ** 16
SECURE_CRASH = {"seed": 3, "rules": [
    {"fault": "crash", "ranks": [4], "rounds": [1, 2]}]}
# 8 of 10 uploads lost once in round 1: 2 survivors < t + 1 = 3
SECURE_SHED = {"seed": 2, "rules": [
    {"fault": "drop", "direction": "send", "src": [1, 2, 3, 4, 5, 6, 7, 8],
     "dst": [0], "rounds": [1, 2], "max_per_link": 1}]}
SECURE_DP = dict(defense_type="dp", norm_bound=1.0, noise_multiplier=1.1)
# the watchdog is armed (the elastic path needs a deadline) and driven
SECURE_DEADLINE_S = 600.0


def _secure_stalled(s, plan, opened):
    """Would a masked server's deadline fire now? Every upload that can
    still arrive this round has: the rest are crashed (undeliverable) or
    dropped on this attempt of the round."""
    if s._finished.is_set() or s._phase != "uploads":
        return False
    r = s.round_idx
    if r >= s.round_num or not opened.get(r):
        return False
    flags = s.aggregator.flag_client_model_uploaded
    if all(flags.values()):
        return False
    dropped = {}
    for e in plan.ledger.for_round(r, ("drop",)):
        if e["direction"] == "send" and e["dst"] == 0:
            dropped[e["src"]] = dropped.get(e["src"], 0) + 1
    return all(up or (i + 1) in s._undeliverable
               or dropped.get(i + 1, 0) >= opened[r]
               for i, up in flags.items())


@contextlib.contextmanager
def _secure_driven():
    """Every TASecureServerManager run inside under a chaos plan has its
    deadline driven: a thread calls on_timeout once the round is stalled
    (_secure_stalled), so no round waits out SECURE_DEADLINE_S. A run
    with no plan installed gets no thread, as the dense runs get none."""
    import threading
    from unittest import mock

    from fedml_tpu_torch import chaos
    from fedml_tpu_torch.distributed import turboaggregate as ta

    run = ta.TASecureServerManager.run

    def driven(self):
        plan = chaos.active_plan()
        if plan is None:
            return run(self)
        opened, stop = {}, threading.Event()
        begin = self.aggregator.begin_round

        def counted(r):
            opened[int(r)] = opened.get(int(r), 0) + 1
            return begin(r)

        self.aggregator.begin_round = counted

        def drive():
            while not stop.wait(0.002) and not self._finished.is_set():
                with self._round_lock:
                    fire = _secure_stalled(self, plan, opened)
                if fire:
                    self.on_timeout(SECURE_DEADLINE_S)

        t = threading.Thread(target=drive, daemon=True)
        t.start()
        try:
            return run(self)
        finally:
            stop.set()
            t.join()

    with mock.patch.object(ta.TASecureServerManager, "run", driven):
        yield


def _uplink_bytes():
    from fedml_tpu_torch.obs.metrics import REGISTRY

    fam = REGISTRY.snapshot().get("comm_bytes_total", {})
    return sum(v for k, v in fam.items() if "direction=uplink" in k)


def _secure_run(data, cfg, job, dense=False, **kw):
    """A 2-round loopback job (masked, or the dense run_simulated with
    ``dense``): the aggregator, each aggregate's new model on the CPU, the
    round walls, the root's ingress bytes, and per client upload the host
    ms of its masking (the vector, mask_update and the shares, to numpy)
    with the cleartext (round, slot, vector, samples) it masked."""
    from unittest import mock

    from fedml_tpu_torch.distributed import turboaggregate as ta
    from fedml_tpu_torch.distributed.fedavg import run_simulated
    from fedml_tpu_torch.distributed.fedavg.aggregator import FedAvgAggregator
    from fedml_tpu_torch.obs.metrics import REGISTRY

    stamps, nets, masks = [], [], []
    # the masked tiers (flat and tree) share the decode-side tail
    cls, name = ((FedAvgAggregator, "aggregate") if dense
                 else (ta.TAAggregator, "_finish_aggregate"))
    finish, wire = getattr(cls, name), ta.SecureTrainer.wire_leaves
    fold, unmask = ta.TAAggregator.add_local_trained_result, \
        ta.TAAggregator.aggregate
    server = {"fold_ms": [], "aggregate_ms": []}

    def fold_timed(self, *a, **k):
        t0 = time.perf_counter()
        out = fold(self, *a, **k)
        server["fold_ms"].append((time.perf_counter() - t0) * 1e3)
        return out

    def aggregate_timed(self):
        t0 = time.perf_counter()
        out = unmask(self)
        server["aggregate_ms"].append((time.perf_counter() - t0) * 1e3)
        return out

    def stamped(self, *a):
        out = finish(self, *a)
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        nets.append(_cpu_state(self.net))
        return out

    def timed(self):
        t0 = time.perf_counter()
        out = wire(self)
        dt = time.perf_counter() - t0
        masks.append(dict(round=self._fit_round, slot=self.slot,
                          n=self._fit_n, ms=dt * 1e3,
                          vec=self._vector().cpu()))
        return out

    before = _uplink_bytes()
    with mock.patch.object(cls, name, stamped), \
            mock.patch.object(ta.SecureTrainer, "wire_leaves", timed), \
            mock.patch.object(ta.TAAggregator, "add_local_trained_result",
                              fold_timed), \
            mock.patch.object(ta.TAAggregator, "aggregate", aggregate_timed), \
            _secure_driven():
        t0 = time.perf_counter()
        if dense:
            agg = run_simulated(data, _cnn_task(), cfg, job_id=job, **kw)
        else:
            agg = ta.run_simulated(data, _cnn_task(), cfg, job_id=job, **kw)
    rounds = max(len(nets), 1)
    return dict(agg=agg, nets=nets, masks=masks, server=server,
                walls=[b - a for a, b in zip([t0] + stamps, stamps)],
                ingress=(_uplink_bytes() - before) / rounds,
                rounds=REGISTRY.snapshot().get("fed_secagg_rounds_total",
                                               {}))


def _secure_engine(data, cfg, start):
    """(a): the masked engine round against the dense one, mask_update on
    the card against the CPU, and the pieces' times."""
    from fedml_tpu_torch.algorithms import FedAvgAPI
    from fedml_tpu_torch.algorithms.turboaggregate import TurboAggregateAPI
    from fedml_tpu_torch.core import secure_agg as sa
    from fedml_tpu_torch.utils.tree import tree_vectorize

    K = cfg.client_num_per_round
    masked = TurboAggregateAPI(data, _cnn_task(), cfg, device_data=True)
    plain = FedAvgAPI(data, _cnn_task(), cfg, device_data=True)
    # each engine's round 0 twice from the seed's weights, interleaved:
    # the first of each pays the process's cold start
    walls = {"masked": [], "plain": []}
    for _ in range(2):
        for name, api in (("masked", masked), ("plain", plain)):
            api.load_state(start)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            api.run_round(0)
            torch.cuda.synchronize()
            walls[name].append(time.perf_counter() - t0)
    eps32 = float(np.finfo(np.float32).eps)
    gaps, bounds = {}, {}
    for k in plain.net:
        p_k = plain.net[k].double()
        gaps[k] = float((masked.net[k].double() - p_k).abs().max())
        bounds[k] = K * 0.5 / SECURE_SCALE + K * eps32 * float(
            p_k.abs().max())
    worst = max(gaps[k] / bounds[k] for k in gaps)
    print("secure: (a) engine round 0 masked vs FedAvg from the same "
          "weights: max |diff| by tensor "
          + ", ".join(f"{k} {gaps[k]:.3e}" for k in gaps)
          + f" (bound K*0.5/2^16 + K ulps: worst at {worst:.3f} of it); "
          "walls (cold, warm) masked "
          + ", ".join(f"{w:.3f}" for w in walls["masked"]) + " s, plain "
          + ", ".join(f"{w:.3f}" for w in walls["plain"]) + " s")
    if worst > 1.0:
        raise AssertionError(f"(a): masked vs plain {gaps} past {bounds}")
    # one client's upload: the same call on the card and on the CPU
    cfg_sa = masked.secagg
    vec = tree_vectorize(masked.net).double()
    n = int(vec.numel())
    on_card = sa.mask_update(vec, 0.1, 3, cfg.seed, 5, cfg_sa)
    on_cpu = sa.mask_update(vec.cpu(), 0.1, 3, cfg.seed, 5, cfg_sa)
    same = bool(np.array_equal(on_card, on_cpu))
    print(f"secure: (a) mask_update of a {n}-element vector on the card "
          f"bitwise the CPU's: {same}")
    if not same:
        raise AssertionError("(a): mask_update on the card is not the "
                             "CPU's")
    # the server's fold on the card against its numpy oracle, K arrivals
    acc = host = None
    for _ in range(K):
        acc = sa.fold_masked_device(acc, on_card)
        host = sa.fold_masked(host, on_cpu)
    fold_same = bool(np.array_equal(acc.cpu().numpy(), host))
    print(f"secure: (a) {K} arrivals folded on the card bitwise the host "
          f"fold: {fold_same}")
    if not fold_same:
        raise AssertionError("(a): the card's fold is not the host fold")
    seeds = {i: sa.self_mask_seed(cfg.seed, 5, i) for i in range(K)}
    t = dict(
        prg_ms=_time_ms(lambda: sa.prg_expand(seeds[0], n)),
        mask_ms=_time_ms(lambda: sa.mask_update_tensor(
            vec, 0.1, 3, cfg.seed, 5, cfg_sa), reps=5, inner=2),
        mask_to_host_ms=_host_ms(lambda: sa.mask_update(
            vec, 0.1, 3, cfg.seed, 5, cfg_sa), 5),
        fold_card_ms=_time_ms(lambda: sa.fold_masked_device(acc, on_card)),
        fold_host_ms=_host_ms(lambda: sa.fold_masked(on_cpu, on_cpu), 5),
        unmask_decode_ms=_time_ms(lambda: sa.unmask_sum(
            acc, range(K), [], seeds, {}, cfg_sa), reps=5, inner=2))
    print("secure: (a) times: one PRG expansion "
          f"{t['prg_ms']:.3f} ms; mask_update a client {t['mask_ms']:.3f} ms"
          f" on the card ({t['mask_to_host_ms']:.3f} ms host wall with the "
          f"{n * 8} B copy to numpy); fold an arrival "
          f"{t['fold_card_ms']:.3f} ms on the card (host->card copy "
          f"included), {t['fold_host_ms']:.3f} ms on the host; unmask + "
          f"decode a round {t['unmask_decode_ms']:.3f} ms")
    return dict(gaps=gaps, bound_ratio=worst, walls_s=walls,
                mask_bitwise=same, fold_bitwise=fold_same, vector=n, **t)


def _secure_flat(data, cfg, repeatable):
    """(b): dense vs masked over loopback, a crashed client recovered,
    a round shed and re-run."""
    from fedml_tpu_torch import chaos
    from fedml_tpu_torch.distributed.turboaggregate import (
        _batch_cap,
        cohort_sample_counts,
    )
    from fedml_tpu_torch.obs.telemetry import Telemetry

    dense = _secure_run(data, cfg, "smoke-sec-dense", dense=True)
    clean = _secure_run(data, cfg, "smoke-sec-clean")
    share = [sum(m["ms"] for m in clean["masks"] if m["round"] == r) / 1e3
             / w for r, w in enumerate(clean["walls"])]
    print(f"secure: (b) loopback round walls dense "
          + ", ".join(f"{w:.3f}" for w in dense["walls"]) + " s, masked "
          + ", ".join(f"{w:.3f}" for w in clean["walls"]) + " s; root "
          f"ingress a round dense {dense['ingress']:.0f} B, masked "
          f"{clean['ingress']:.0f} B ({clean['ingress'] / dense['ingress']:.3f}"
          "x); masking a client "
          f"{statistics.median(m['ms'] for m in clean['masks']):.3f} ms "
          "(host wall on its rank's thread, median), the clients' masking "
          "summed over a round against its wall "
          + ", ".join(f"{x:.3f}" for x in share) + "; the server's fold "
          "of an arrival on its device, host wall with the copy, "
          f"{statistics.median(clean['server']['fold_ms']):.3f} ms (median),"
          " its aggregate (seeds, unmask, decode, reweight) "
          + ", ".join(f"{x:.3f}" for x in clean["server"]["aggregate_ms"])
          + " ms a round")
    if clean["agg"].quarantine.canonical():
        raise AssertionError(f"(b): clean ledger "
                             f"{clean['agg'].quarantine.canonical()}")
    # a client crashed in round 1: the aggregate against the exact
    # survivor-weighted mean of the survivors' cleartext vectors
    tel = Telemetry()
    crash = _secure_run(data, cfg, "smoke-sec-crash", telemetry=tel,
                        round_timeout_s=SECURE_DEADLINE_S,
                        chaos_plan=chaos.FaultPlan.from_json(SECURE_CRASH))
    tel.close()
    sec = [r.get("secagg", {}) for r in tel.events.sink.records
           if r.get("kind") == "round"]
    ups = [m for m in crash["masks"] if m["round"] == 1]
    ns = np.asarray([m["n"] for m in ups], np.float64)
    want = sum(m["vec"].numpy() * n for m, n in zip(ups, ns)) / ns.sum()
    from fedml_tpu_torch.utils.tree import tree_vectorize

    got = tree_vectorize(crash["nets"][-1]).double().numpy()
    _, counts = cohort_sample_counts(1, cfg, data, _batch_cap(data, cfg))
    bound = (len(ups) * 0.5 / SECURE_SCALE * sum(counts) / ns.sum()
             + float(np.finfo(np.float32).eps) * float(np.abs(want).max()))
    gap = float(np.abs(got - want).max())
    led = crash["agg"].quarantine.canonical()
    print(f"secure: (b) rank 4 crashed in round 1: {len(ups)} survivors, "
          f"the aggregate vs the survivor-weighted mean in float64 "
          f"{gap:.3e} (bound {bound:.3e}); records {sec}; ledger {led}; "
          "round walls " + ", ".join(f"{w:.3f}" for w in crash["walls"])
          + " s")
    recovery_s = sec[1].get("recovery_s") if len(sec) > 1 else None
    if (len(ups) != cfg.client_num_per_round - 1 or gap > bound
            or [s.get("outcome") for s in sec] != ["full", "recovered"]
            or [(e[0], e[1], e[2]) for e in led]
            != [(1, 4, "secagg_dropout")]):
        raise AssertionError(f"(b): crash round off: gap {gap} bound "
                             f"{bound}, records {sec}, ledger {led}")
    # a round shed below t + 1 and re-broadcast
    shed = _secure_run(data, cfg, "smoke-sec-shed",
                       round_timeout_s=SECURE_DEADLINE_S,
                       chaos_plan=chaos.FaultPlan.from_json(SECURE_SHED))
    sled = shed["agg"].quarantine.canonical()
    gaps = [max(float((a[k] - b[k]).abs().max()) for k in a)
            for a, b in zip(shed["nets"], clean["nets"])]
    bits = [_bitwise(a, b) for a, b in zip(shed["nets"], clean["nets"])]
    print(f"secure: (b) round 1 shed (2 survivors < t + 1 = 3) and re-run: "
          f"ledger {[(e[0], e[1], e[2]) for e in sled]}; params vs the "
          "clean run by round " + ", ".join(f"{g:.3e}" for g in gaps)
          + f", bitwise {bits}; walls "
          + ", ".join(f"{w:.3f}" for w in shed["walls"]) + " s")
    if ({(e[0], e[2]) for e in sled} != {(1, "secagg_shed")}
            or sorted(e[1] for e in sled) != list(range(1, 9))):
        raise AssertionError(f"(b): shed ledger {sled}")
    if (repeatable and not all(bits)) or max(gaps) > TOL_ROUND:
        raise AssertionError(f"(b): shed run vs clean {gaps} {bits}")
    return dict(walls_dense_s=dense["walls"], walls_masked_s=clean["walls"],
                server_fold_ms=clean["server"]["fold_ms"],
                server_aggregate_ms=clean["server"]["aggregate_ms"],
                ingress_dense_b=dense["ingress"],
                ingress_masked_b=clean["ingress"],
                mask_client_ms=[m["ms"] for m in clean["masks"]],
                mask_share=share, crash_gap=gap, crash_bound=bound,
                recovery_s=recovery_s, walls_crash_s=crash["walls"],
                walls_shed_s=shed["walls"], clean=clean)


def _secure_tree(data, cfg, clean, repeatable):
    """(c): the 5 x 2 masked tree (t = 1: a 2-slot block holds t + 1)
    against the flat clean run."""
    run = _secure_run(data, cfg, "smoke-sec-tree", edges=HIER_EDGES,
                      threshold_t=1)
    bits = [_bitwise(a, b) for a, b in zip(run["nets"], clean["nets"])]
    gaps = [max(float((a[k] - b[k]).abs().max()) for k in a)
            for a, b in zip(run["nets"], clean["nets"])]
    fan = run["agg"].fanin_history
    print("secure: (c) tree 5 x 2: params vs the flat run by round "
          + ", ".join(f"{g:.3e}" for g in gaps)
          + f", bitwise {bits}; fan-in {fan}; root ingress a round "
          f"{run['ingress']:.0f} B; walls "
          + ", ".join(f"{w:.3f}" for w in run["walls"]) + " s")
    if (fan != [HIER_EDGES] * SECURE_ROUNDS
            or run["agg"].quarantine.canonical()):
        raise AssertionError(f"(c): fan-in {fan}")
    if (repeatable and not all(bits)) or max(gaps) > TOL_ROUND:
        raise AssertionError(f"(c): tree vs flat {gaps}")
    return dict(bitwise=bits, gaps=gaps, walls_s=run["walls"],
                ingress_b=run["ingress"])


def _secure_dp(data, cfg):
    """(d): DP on the masked path, 2 rounds: ε against a host accountant,
    the noise drawn on the card."""
    from unittest import mock

    from fedml_tpu_torch.core.privacy import DPAccountant
    from fedml_tpu_torch.utils import prng

    draws, normal = [], prng.normal_torch

    def seen(k, shape, device):
        t0 = time.perf_counter()
        out = normal(k, shape, device)
        torch.cuda.synchronize()
        draws.append((str(out.device), (time.perf_counter() - t0) * 1e3))
        return out

    with mock.patch.object(prng, "normal_torch", seen):
        run = _secure_run(data, cfg, "smoke-sec-dp", **SECURE_DP)
    q = cfg.client_num_per_round / cfg.client_num_in_total
    want = DPAccountant().step(q, SECURE_DP["noise_multiplier"],
                               rounds=SECURE_ROUNDS).epsilon(1e-5)
    got = run["agg"].accountant.epsilon(1e-5)
    print(f"secure: (d) DP on the masked path: eps {got:.6f} vs a host "
          f"accountant's {want:.6f}; noise draws {draws}; walls "
          + ", ".join(f"{w:.3f}" for w in run["walls"]) + " s; per-client "
          f"ledger {run['agg'].client_ledger.summary()}")
    if (abs(got - want) > 1e-9 * max(1.0, want)
            or len(draws) != SECURE_ROUNDS
            or any(not d.startswith("cuda") for d, _ in draws)):
        raise AssertionError(f"(d): eps {got} vs {want}, draws {draws}")
    return dict(eps=got, eps_host=want, noise_draws=draws,
                walls_s=run["walls"])


def phase_secure(report):
    from fedml_tpu_torch.algorithms.fedavg import FedAvgConfig
    from fedml_tpu_torch.data import load_dataset

    fa.reset_launches()
    data = load_dataset("femnist", seed=0, uint8_pixels=True)
    cfg = FedAvgConfig(comm_round=SECURE_ROUNDS, frequency_of_the_test=100,
                       **MAIN_CFG)
    start = _cpu_state(_initial_state(data, cfg))
    rec = report["secure"] = {}
    # the bitwise claims (tree = flat, retry = clean) need repeating fits
    was = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        rec["engine"] = _secure_engine(data, cfg, start)
        rep = _fit_repeatable(data, cfg, start, label="secure: (b)")
        flat = _secure_flat(data, cfg, rep)
        rec["tree"] = _secure_tree(data, cfg, flat.pop("clean"), rep)
        rec["flat"] = flat
        rec["dp"] = _secure_dp(data, cfg)
    finally:
        torch.backends.cudnn.deterministic = was
    if any(fa.LAUNCHES.values()):
        raise AssertionError(f"flash kernels launched by the secure phase: "
                             f"{fa.LAUNCHES}")


# bench.py's per-round driver at main's configuration, not cut: the
# pipelined driver (prefetch 2, drain lag 2) against the synchronous
# run_round loop, bucketed depth, the bf16 policy, a streamed source and
# fused ingest. cuDNN deterministic for the phase, so every "bitwise"
# below is a claim about the code, not about luck.
PIPE_ROUNDS = 6            # (a): timed rounds of each driver
PIPE_BUCKET_ROUNDS = 6     # (b)
PIPE_STREAM_ROUNDS = 3     # (d)
PIPE_FUSED_ROUNDS = 2      # (e)
PIPE_TREE_EDGES = 5        # (e): hier's 5 x 2 tree
PIPE_NAN = {"seed": 1, "rules": [{"attack": "nan", "ranks": [2]}]}
# (c): one step of each client, card vs CPU, median client update rel.
# err. The card and the CPU round the same values to bf16, so the sound
# gap is small: 3.2e-05 with model dtype None (f32 compute on bf16-rounded
# weights), 4.6e-04 with bf16 activations, on an H100. Each limit is about
# 10x its gap and sits 6x or more under the gap of a card step that skips
# the casts (2.7e-02 and 3.7e-02 against the CPU bf16 step) or, with bf16
# activations, skips only the activation casts (3.0e-02); (c) runs those
# controls and fails if one falls within its limit. The round is held to
# main's TOL_ROUND.
PIPE_BF16_STEP_TOL = {"None": 3e-4, "bfloat16": 5e-3}


def _card_tag():
    """'[name, power limit]' of the current card, for every figure."""
    global _CARD
    if "_CARD" not in globals():
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60)
        _CARD = smi.stdout.strip().splitlines()[torch.cuda.current_device()]
    return f"[{_CARD}]"


def _hist_delta(name, before):
    """(count, sum) of histogram family ``name`` since snapshot
    ``before``, over its label sets."""
    from fedml_tpu_torch.obs.metrics import REGISTRY

    def tot(snap):
        fam = snap.get(name, {})
        return (sum(v.get("count", 0) for v in fam.values()),
                sum(v.get("sum", 0.0) for v in fam.values()))

    (c1, s1), (c0, s0) = tot(REGISTRY.snapshot()), tot(before)
    return c1 - c0, s1 - s0


def _pipe_driver(data, cfg, start):
    """(a): warmup() and run_round(0) as bench.py runs them, then
    PIPE_ROUNDS rounds through run_round and through run_pipelined
    (prefetch 2) from the same state: model, key chain, per-round metrics
    and ledger bitwise; rounds/s and samples/s of each; the packer's pack
    and copy spans, the driver's stall and the dispatch depth a round.
    Host-packed (bench.py's per-round mode) and device-resident."""
    from fedml_tpu_torch.algorithms import FedAvgAPI
    from fedml_tpu_torch.obs.metrics import REGISTRY

    out = {}
    for dd in (False, True):
        plane = "device_data" if dd else "host-packed"
        api = FedAvgAPI(data, _cnn_task(), cfg, device_data=dd)
        api.load_state(start)
        wrep = api.warmup()
        api.run_round(0)
        torch.cuda.synchronize()
        s1, rng1 = _cpu_state(api.net), api.rng.copy()
        rounds = range(1, 1 + PIPE_ROUNDS)
        t0 = time.perf_counter()
        sync = [{k: float(v) for k, v in api.run_round(r).items()}
                for r in rounds]
        torch.cuda.synchronize()
        sync_s = time.perf_counter() - t0
        sync_net, sync_rng = _cpu_state(api.net), api.rng.copy()
        sync_led = api.quarantine.canonical()

        api.load_state(s1, rng=rng1)
        api.prefetch = 2
        spans, depths = [], []
        pack, drain = api._pack_round_placed, api._drain_round_entry

        def packed(r):
            res = pack(r)
            spans.append(res[2])
            return res

        def drained(r, entry):
            depths.append(entry[2]["depth"])
            return drain(r, entry)

        api._pack_round_placed, api._drain_round_entry = packed, drained
        before = REGISTRY.snapshot()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pipe = api.run_pipelined(1, PIPE_ROUNDS)
        torch.cuda.synchronize()
        pipe_s = time.perf_counter() - t0
        stalls = _hist_delta("fed_prefetch_stall_seconds", before)
        got = [{k: float(v) for k, v in m.items()} for _, m in pipe]
        same = (_bitwise(sync_net, _cpu_state(api.net))
                and (sync_rng == api.rng).all() and got == sync
                and [r for r, _ in pipe] == list(rounds)
                and sync_led == api.quarantine.canonical())
        n = sum(m["count"] for m in sync)
        print(f"pipeline: (a) {plane}: warmup {wrep['variants']} in "
              f"{wrep['seconds']:.3f} s; {PIPE_ROUNDS} rounds: run_round "
              f"{PIPE_ROUNDS / sync_s:.2f} rounds/s {n / sync_s:.0f} "
              f"samples/s, run_pipelined {PIPE_ROUNDS / pipe_s:.2f} rounds/s"
              f" {n / pipe_s:.0f} samples/s; a round on the packer: pack "
              + ", ".join(f"{s['prefetch_pack'] * 1e3:.2f}" for s in spans)
              + " ms, h2d call "
              + ", ".join(f"{s['h2d'] * 1e3:.2f}" for s in spans)
              + f" ms; driver stall {stalls[1] * 1e3 / max(stalls[0], 1):.2f}"
              f" ms a round ({stalls[0]} gets); dispatch depth {depths}; "
              f"model, key chain, metrics and ledger bitwise {same} "
              + _card_tag())
        if not same:
            raise AssertionError(f"pipeline: (a) {plane}: run_pipelined is "
                                 "not bitwise the run_round loop")
        out[plane] = dict(
            sync_rounds_per_s=PIPE_ROUNDS / sync_s,
            pipe_rounds_per_s=PIPE_ROUNDS / pipe_s,
            sync_samples_per_s=n / sync_s, pipe_samples_per_s=n / pipe_s,
            pack_ms=[s["prefetch_pack"] * 1e3 for s in spans],
            h2d_ms=[s["h2d"] * 1e3 for s in spans],
            stall_ms=stalls[1] * 1e3 / max(stalls[0], 1), depths=depths,
            warmup_s=wrep["seconds"])
    return out


def _pipe_bucket(data, cfg, start):
    """(b): PIPE_BUCKET_ROUNDS rounds with bucket_batches off and on from
    the same weights (telemetry on both, for the pack blocks): bitwise;
    each round's bucket_B / b_needed / pad_frac and wall, on and off; the
    bucketed warmup's variants and seconds."""
    from fedml_tpu_torch.algorithms import FedAvgAPI
    from fedml_tpu_torch.obs import Telemetry

    res = {}
    for on in (False, True):
        tel = Telemetry()
        try:
            api = FedAvgAPI(data, _cnn_task(), cfg, bucket_batches=on,
                            telemetry=tel)
            api.load_state(start)
            wrep = api.warmup()
            walls = []
            for r in range(PIPE_BUCKET_ROUNDS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                api.run_round(r)
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
            packs = [rec["pack"] for rec in tel.events.sink.records
                     if rec.get("kind") == "round"]
        finally:
            tel.close()
        res[on] = dict(net=_cpu_state(api.net), walls=walls, packs=packs,
                       warmup=wrep, ladder=list(api._b_ladder))
    same = _bitwise(res[False]["net"], res[True]["net"])
    for on in (False, True):
        r = res[on]
        print(f"pipeline: (b) bucket_batches {on}: warmup "
              f"{r['warmup']['variants']} in {r['warmup']['seconds']:.3f} s;"
              " rounds (bucket_B/b_needed/pad_frac, wall): " + "; ".join(
                  f"{p['bucket_B']}/{p['b_needed']}/{p['pad_frac']:.4f}, "
                  f"{w * 1e3:.1f} ms" for p, w in zip(r["packs"],
                                                     r["walls"]))
              + f" {_card_tag()}")
    print(f"pipeline: (b) ladder {res[True]['ladder']}; bucketed rounds "
          f"bitwise the unbucketed {same}; median wall off "
          f"{statistics.median(res[False]['walls']) * 1e3:.1f} ms, on "
          f"{statistics.median(res[True]['walls']) * 1e3:.1f} ms "
          + _card_tag())
    if not same:
        raise AssertionError("pipeline: (b) bucketed rounds are not bitwise "
                             "the unbucketed ones")
    return {("on" if on else "off"): dict(
        walls_ms=[w * 1e3 for w in res[on]["walls"]],
        packs=res[on]["packs"], warmup_s=res[on]["warmup"]["seconds"],
        variants=res[on]["warmup"]["variants"]) for on in (False, True)}


def _pipe_bf16(data, cfg, start):
    """(c): precision='bf16' with the model's activation dtype None and
    bfloat16: one step of each client of round 0 on the card against the
    port's CPU step from the same weights (median client update rel. err
    within PIPE_BF16_STEP_TOL), round 0 from the same weights within
    TOL_ROUND, the masters float32; round walls beside f32's. Controls: a
    card step that skips the casts (precision f32) against each CPU bf16
    step, and a bf16 card step that skips the activation casts (model
    dtype None) against the CPU's bf16-activation step, each outside the
    tolerance it controls, so the check can tell the policy ran."""
    from fedml_tpu_torch.algorithms import FedAvgAPI
    from fedml_tpu_torch.core.tasks import classification_task
    from fedml_tpu_torch.device import resolve_device
    from fedml_tpu_torch.models.cnn import CNNOriginalFedAvg

    cfg16 = dataclasses.replace(cfg, precision="bf16")
    step16 = dataclasses.replace(cfg16, max_batches=1)
    out, card_steps = {}, {}
    f32 = FedAvgAPI(data, _cnn_task(), cfg, device_data=True)
    f32.load_state(start)
    walls = {"f32": _timed_rounds(f32, 3)}
    f32_step = _client_steps(FedAvgAPI(
        data, _cnn_task(), dataclasses.replace(cfg, max_batches=1),
        device_data=True), 0, start)
    for dt in (None, torch.bfloat16):
        name = "None" if dt is None else "bfloat16"
        task = lambda device=None: classification_task(
            CNNOriginalFedAvg(dtype=dt).to(resolve_device(device)))
        card = FedAvgAPI(data, task(), cfg16, device_data=True)
        cpu = FedAvgAPI(data, task("cpu"), cfg16, device="cpu")
        step = FedAvgAPI(data, task(), step16, device_data=True)
        cpu_step = FedAvgAPI(data, task("cpu"), step16, device="cpu")
        card_steps[name] = _client_steps(step, 0, start)
        cpu_s = _client_steps(cpu_step, 0, start)
        gaps = _step_gaps(card_steps[name], cpu_s)
        controls = {"f32 card step": _step_gaps(f32_step, cpu_s)[0]}
        if dt is not None:
            controls["bf16 card step, model dtype None"] = _step_gaps(
                card_steps["None"], cpu_s)[0]
        del cpu_s
        card0, cpu0 = _round_from(card, 0, start), _round_from(cpu, 0, start)
        rgaps = _gaps(card0, cpu0)
        masters = all(v.dtype == torch.float32 for v in card.net.values())
        card.load_state(start)
        walls[f"bf16 (model dtype {name})"] = _timed_rounds(card, 3)
        tol = PIPE_BF16_STEP_TOL[name]
        print(f"pipeline: (c) bf16, model dtype {name}: controls against "
              "the CPU step, median client update rel. err: " + ", ".join(
                  f"{k} {v:.3e}" for k, v in controls.items())
              + f" (each must exceed tol {tol:g}) {_card_tag()}")
        _agree(f"(c) bf16, model dtype {name}: one step of round 0's "
               f"clients, card vs CPU", gaps,
               (("median client update rel. err", tol),), phase="pipeline")
        _agree(f"(c) bf16, model dtype {name}: round 0, card vs CPU", rgaps,
               ROUND_TOLS, phase="pipeline")
        if any(v <= tol for v in controls.values()):
            raise AssertionError(f"pipeline: (c) model dtype {name}: a "
                                 f"control {controls} is within {tol:g}; "
                                 "the check cannot tell the policy ran")
        if not masters:
            raise AssertionError("pipeline: (c) the bf16 masters left f32")
        out[name] = dict(step_median=gaps[0], step_max=gaps[2],
                         loss_rel=gaps[1], controls=controls,
                         round_hist=rgaps[0],
                         round_params=rgaps[1])
    print("pipeline: (c) round walls (3 rounds, ms): " + "; ".join(
        f"{k} " + ", ".join(f"{w * 1e3:.1f}" for w in v)
        for k, v in walls.items()) + f"; masters float32 {_card_tag()}")
    out["walls_ms"] = {k: [w * 1e3 for w in v] for k, v in walls.items()}
    return out


def _pipe_stream(data, cfg, start):
    """(d): the full stand-in written as packed npy (write_packed_npy) to a
    temporary directory the phase removes; the engine over a
    PackedNpySource for PIPE_STREAM_ROUNDS rounds bitwise the in-memory
    engine; the host RSS (memwatch) before and after."""
    import shutil
    import tempfile

    from fedml_tpu_torch.algorithms import FedAvgAPI
    from fedml_tpu_torch.core.client_source import (
        PackedNpySource,
        write_packed_npy,
    )
    from fedml_tpu_torch.obs.memwatch import host_rss_bytes

    mem = FedAvgAPI(data, _cnn_task(), cfg)
    mem.load_state(start)
    for r in range(PIPE_STREAM_ROUNDS):
        mem.run_round(r)
    d = tempfile.mkdtemp(prefix="pipeline-packed-")
    try:
        rss0 = host_rss_bytes()
        t0 = time.perf_counter()
        write_packed_npy(data, d)
        write_s = time.perf_counter() - t0
        size = sum(os.path.getsize(os.path.join(d, f)) for f in os.listdir(d))
        src = PackedNpySource(d)
        try:
            api = FedAvgAPI(src, _cnn_task(), cfg)
            api.load_state(start)
            walls = _timed_rounds(api, PIPE_STREAM_ROUNDS)
            same = _bitwise(_cpu_state(mem.net), _cpu_state(api.net))
        finally:
            src.close()
        rss1 = host_rss_bytes()
    finally:
        shutil.rmtree(d, ignore_errors=True)
    gone = not os.path.exists(d)
    mib = lambda b: "not measured" if b is None else f"{b / 2**20:.1f} MiB"
    print(f"pipeline: (d) write_packed_npy of {src.num_clients} clients: "
          f"{size / 2**20:.1f} MiB in {write_s:.2f} s; {PIPE_STREAM_ROUNDS} "
          f"rounds over PackedNpySource: " + ", ".join(
              f"{w * 1e3:.1f}" for w in walls) + f" ms, bitwise the "
          f"in-memory engine {same}; host RSS before {mib(rss0)}, after "
          f"{mib(rss1)}; temporary directory removed {gone} {_card_tag()}")
    if not same or not gone:
        raise AssertionError(f"pipeline: (d) streamed bitwise {same}, "
                             f"directory removed {gone}")
    return dict(walls_ms=[w * 1e3 for w in walls], rss_before=rss0,
                rss_after=rss1, packed_mib=size / 2**20, write_s=write_s)


def _fused_run(data, cfg, job, records=False, **kw):
    """run_simulated over loopback from the seed's weights: the
    aggregator, each round's new global model on the CPU, each flush's
    seconds and staging bytes (the aggregator's last flush record); with
    ``records`` the server's telemetry round records too (its per-round
    ``decode`` span over the arrivals, ``aggregate`` span and wall)."""
    from unittest import mock

    from fedml_tpu_torch import chaos
    from fedml_tpu_torch.distributed.fedavg import run_simulated
    from fedml_tpu_torch.distributed.fedavg.aggregator import FedAvgAggregator
    from fedml_tpu_torch.obs import Telemetry

    nets, flushes, aggregate = [], [], FedAvgAggregator.aggregate

    def stamped(self):
        out = aggregate(self)
        torch.cuda.synchronize()
        nets.append(_cpu_state(self.net))
        flushes.append(dict(self._last_flush or {}))
        return out

    tel = Telemetry() if records else None
    try:
        with mock.patch.object(FedAvgAggregator, "aggregate", stamped):
            agg = run_simulated(data, _cnn_task(), cfg, job_id=job,
                                adversary_plan=chaos.AdversaryPlan.from_json(
                                    PIPE_NAN), telemetry=tel, **kw)
        recs = ([r for r in tel.events.sink.records
                 if r.get("kind") == "round"] if records else [])
    finally:
        if tel is not None:
            tel.close()
    return dict(agg=agg, nets=nets, flushes=flushes, records=recs)


def _server_round_ms(recs):
    """Per server round: (mean ``decode`` span per arrival, ``aggregate``
    span, wall), in ms. The decode span is host time at arrival: in fused
    mode it holds the densify, gate and fold that stacked mode runs in
    its aggregate."""
    return [(r["spans"].get("decode", 0.0) * 1e3 / max(len(r["clients"]), 1),
             r["spans"].get("aggregate", 0.0) * 1e3,
             r["goodput"]["wall_s"] * 1e3) for r in recs]


def _pipe_fused(data, cfg, repeatable):
    """(e): fused against stacked pairwise over loopback, dense and
    delta-int8 (a NaN adversary on rank 2 fills the ledger), and the
    staged median against the stacked two-phase median: params bitwise
    every round (if the fits repeat), ledgers equal; the 5 x 2 tree with
    fused edges against the fused flat run; the server's aggregate ms and
    staging bytes, and its decode span per arrival and round wall from
    the same runs, fused vs stacked."""
    out = {}
    runs = {}
    legs = (("dense", {}), ("delta-int8", dict(update_codec="delta-int8")),
            ("median", dict(aggregator="median")))
    for leg, kw in legs:
        pair = {}
        for mode, extra in (("stacked", dict(sum_assoc="pairwise")),
                            ("fused", dict(fused_agg=True))):
            pair[mode] = _fused_run(data, cfg, f"pipe-{leg}-{mode}",
                                    records=True, **kw, **extra)
        runs[leg] = pair
        s, f = pair["stacked"], pair["fused"]
        bits = [_bitwise(a, b) for a, b in zip(s["nets"], f["nets"])]
        gaps = [max(float((a[k] - b[k]).abs().max()) for k in a)
                for a, b in zip(s["nets"], f["nets"])]
        led = (s["agg"].quarantine.canonical(),
               f["agg"].quarantine.canonical())
        ms = {m: [x["flush_s"] * 1e3 for x in pair[m]["flushes"]]
              for m in pair}
        nb = {m: [x["stack_bytes"] for x in pair[m]["flushes"]]
              for m in pair}
        srv = {m: _server_round_ms(pair[m]["records"]) for m in pair}
        print(f"pipeline: (e) {leg}: fused vs stacked params by round "
              + ", ".join(f"{g:.3e}" for g in gaps) + f", bitwise {bits}; "
              f"ledgers equal {led[0] == led[1]} ({len(led[0])} entries); "
              f"server aggregate ms stacked " + ", ".join(
                  f"{x:.2f}" for x in ms["stacked"]) + ", fused " + ", ".join(
                  f"{x:.2f}" for x in ms["fused"]) + "; fed_agg_stack_bytes "
              f"stacked {nb['stacked']}, "
              f"{'fused_staged' if leg == 'median' else 'fused'} "
              f"{nb['fused']} {_card_tag()}")
        print(f"pipeline: (e) {leg}: server rounds (decode ms per arrival, "
              "aggregate span ms, round wall ms): " + "; ".join(
                  f"{m} " + ", ".join(f"{d:.2f}/{a:.2f}/{w:.1f}"
                                      for d, a, w in srv[m])
                  for m in srv) + f" {_card_tag()}")
        if led[0] != led[1] or not led[0]:
            raise AssertionError(f"pipeline: (e) {leg}: ledgers {led}")
        if repeatable and not all(bits):
            raise AssertionError(f"pipeline: (e) {leg}: the fits repeat, "
                                 f"fused is not bitwise stacked ({gaps})")
        if max(gaps) > TOL_ROUND:
            raise AssertionError(f"pipeline: (e) {leg}: {gaps}")
        out[leg] = dict(bitwise=bits, stacked_ms=ms["stacked"],
                        fused_ms=ms["fused"], stacked_bytes=nb["stacked"],
                        fused_bytes=nb["fused"], server_rounds_ms=srv)
    flat = runs["dense"]["fused"]
    tree = _fused_run(data, cfg, "pipe-tree-fused", fused_agg=True,
                      edges=PIPE_TREE_EDGES)
    bits = [_bitwise(a, b) for a, b in zip(tree["nets"], flat["nets"])]
    led = (tree["agg"].quarantine.canonical(),
           flat["agg"].quarantine.canonical())
    print(f"pipeline: (e) {PIPE_TREE_EDGES} x "
          f"{MAIN_CFG['client_num_per_round'] // PIPE_TREE_EDGES} tree, "
          f"fused edges, vs the fused flat run: bitwise {bits}, ledgers "
          f"equal {led[0] == led[1]}, fan-in {tree['agg'].fanin_history} "
          + _card_tag())
    if led[0] != led[1] or (repeatable and not all(bits)) or \
            len(bits) != PIPE_FUSED_ROUNDS:
        raise AssertionError(f"pipeline: (e) tree vs flat: bitwise {bits}, "
                             f"ledgers {led}")
    out["tree_bitwise"] = bits
    return out


def phase_pipeline(report):
    from fedml_tpu_torch.algorithms.fedavg import FedAvgConfig
    from fedml_tpu_torch.data import load_dataset

    fa.reset_launches()
    data = load_dataset("femnist", seed=0, uint8_pixels=True)
    cfg = FedAvgConfig(comm_round=PIPE_ROUNDS + 1,
                       frequency_of_the_test=100, **MAIN_CFG)
    start = _cpu_state(_initial_state(data, cfg))
    rec = report["pipeline"] = {}
    was = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        rec["driver"] = _pipe_driver(data, cfg, start)
        rec["bucket"] = _pipe_bucket(data, cfg, start)
        rec["bf16"] = _pipe_bf16(data, cfg, start)
        rec["stream"] = _pipe_stream(data, cfg, start)
        fcfg = dataclasses.replace(cfg, comm_round=PIPE_FUSED_ROUNDS)
        rep = _fit_repeatable(data, fcfg, start, label="pipeline: (e)")
        rec["fused"] = _pipe_fused(data, fcfg, rep)
    finally:
        torch.backends.cudnn.deterministic = was
    if any(fa.LAUNCHES.values()):
        raise AssertionError(f"flash kernels launched by the pipeline "
                             f"phase: {fa.LAUNCHES}")


# the long-context engine over a ('clients', 'seq') mesh of rank processes
# sharing the one card (gloo, host-staged: NCCL refuses two ranks on one
# device). (a) runs on a 1 x 2 mesh, (b) on 2 x 2, (c) on 1 x 2; the
# ranks outside a 1 x 2 mesh wait at the next mesh's groups.
SEQ_WORLD = 4
SEQ_ROUNDS = 2             # (b)
SEQ_DEADLINE_S = 300.0     # the world's join deadline
SEQ_ATTN = dict(B=4, T=_T, H=_H, D=_D)   # (a): [4, 2048, 8, 32] f32
# (a) against the single-rank kernels / plain attention on the card: the
# JAX package's own bounds (tests/test_flash_attention.py:76-137)
TOL_SEQ_OUT = 3e-5
TOL_SEQ_GRAD = 2e-3
# (b) / (c) against the single-process round from the same weights: the
# relative parameter distance. On an H100 sound rounds land near 3e-8
# (ring) and 1e-8 (Ulysses), a round's update is 1.1-1.6e-3 of the weights,
# and the planted control (no gradient all-reduce in seq_invariant) lands
# near 6e-4: the phase runs that control and fails if it lands inside
TOL_SEQ_ROUND = 1e-6
# the seq path's kernel shapes: ring blocks of 2 clients x batch 4 at
# T/2, causal (s = 0) and not (s = 1), and Ulysses' 4 clients x batch 4
# at full T with H/2 heads
SEQ_SHAPES = (dict(B=8, T=_T // 2, H=_H, D=_D, causal=True),
              dict(B=8, T=_T // 2, H=_H, D=_D, causal=False),
              dict(B=16, T=_T, H=_H // 2, D=_D, causal=True))


def _seq_data():
    from fedml_tpu_torch.data.synthetic import synthetic_sequences

    return synthetic_sequences(
        num_clients=SLICE_FED["client_num_in_total"], seq_len=_T,
        vocab_size=SLICE_WIDTHS["vocab_size"], samples_per_client=8,
        test_samples=16)


def _seq_attention(mesh):
    """(a), on the ranks of a 1 x 2 mesh: each sequence-parallel attention
    over the full [4, 2048, 8, 32] tensors (the wrappers slice each
    rank's block and gather the output), forward and the q/k/v grads of
    sum(out * g), against the single-rank kernels (flash) or plain
    attention (dense) on the same inputs."""
    ra = importlib.import_module("fedml_tpu_torch.parallel.ring_attention")
    a = SEQ_ATTN
    gen = torch.Generator(device="cuda").manual_seed(11)
    q, k, v, g = (torch.randn((a["B"], a["T"], a["H"], a["D"]),
                              generator=gen, device="cuda")
                  for _ in range(4))
    out = {}
    for causal in (True, False):
        for name, wrap, kw, ref in (
                ("ring_flash", "ring_attention_flash_sharded", {},
                 fa.flash_attention),
                ("ring", "ring_attention_sharded", {}, ra.full_attention),
                ("ulysses_flash", "ulysses_attention_sharded",
                 {"use_flash": True}, fa.flash_attention),
                ("ulysses", "ulysses_attention_sharded", {},
                 ra.full_attention)):
            f = getattr(ra, wrap)(mesh, "seq", causal=causal, **kw)
            errs = []
            for fn in (f, lambda q, k, v: ref(q, k, v, causal)):
                qq, kk, vv = (t.clone().requires_grad_() for t in (q, k, v))
                o = fn(qq, kk, vv)
                errs.append((o.detach(), torch.autograd.grad(
                    (o * g).sum(), (qq, kk, vv))))
                del o
            (o1, g1), (o2, g2) = errs
            ok = torch.allclose(o1, o2, rtol=TOL_SEQ_OUT, atol=TOL_SEQ_OUT) \
                and all(torch.allclose(x, y, rtol=TOL_SEQ_GRAD,
                                       atol=TOL_SEQ_GRAD)
                        for x, y in zip(g1, g2))
            out[f"{name} {'causal' if causal else 'full'}"] = dict(
                out=_max_err([(o1, o2)]), grads=[_max_err([(x, y)])
                                                 for x, y in zip(g1, g2)],
                ok=ok)
            del errs, o1, o2, g1, g2
    torch.cuda.synchronize()
    return out


def _seq_engine(mesh, work, impl, rounds, tag, control=False):
    """(b) / (c) on this rank: FedAvgSeqAPI at the slice's full width,
    each round timed on its own (counts and the peak reset just before,
    read just after a device sync); rank 0 saves each round's entering
    and resulting weights for the parent's oracle. With ``control``,
    round 0 runs once more from its entering weights with seq_invariant's
    backward all-reduce taken out (each shard keeps its own partial
    gradient), for the parent to show the oracle sees that fault."""
    from fedml_tpu_torch.algorithms import FedAvgConfig, FedAvgSeqAPI
    from fedml_tpu_torch.collectives import ops
    from fedml_tpu_torch.models import create_model
    from fedml_tpu_torch.obs import memwatch

    cfg = FedAvgConfig(comm_round=rounds, **SLICE_FED)
    api = FedAvgSeqAPI(_seq_data(), lambda ax: create_model(
        "transformer_flash", seq_axis=ax, seq_impl=impl, **SLICE_WIDTHS),
        cfg, mesh)
    rank = torch.distributed.get_rank()
    recs = []
    for r in range(rounds):
        if rank == 0:
            torch.save({k: v.cpu() for k, v in api.net.items()},
                       work / f"{tag}-enter{r}.pt")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fa.reset_launches()
        ops.reset_comm_stats()
        t0 = time.perf_counter()
        metrics = api.run_round(r)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        recs.append(dict(
            wall_s=wall, launches=dict(fa.LAUNCHES),
            comm_s=sum(v for k, v in ops.COMM_SECONDS.items()
                       if k != "drain"),
            drain_s=ops.COMM_SECONDS["drain"],
            peak_bytes=memwatch.device_memory_stats()[
                f"gpu:{torch.cuda.current_device()}"]["peak_bytes"],
            metrics={k: float(v) for k, v in metrics.items()}))
        if rank == 0:
            torch.save({k: v.cpu() for k, v in api.net.items()},
                       work / f"{tag}-result{r}.pt")
    finite = all(bool(torch.isfinite(v).all()) for v in api.net.values())
    if control:
        # every rank saw round 0's entering weights saved before its
        # round-0 collectives, so the file is whole here
        api.load_state(torch.load(work / f"{tag}-enter0.pt"))
        reduce_back = ops._GradPsum.backward
        ops._GradPsum.backward = staticmethod(lambda ctx, *gs: (None, *gs))
        try:
            api.run_round(0)
        finally:
            ops._GradPsum.backward = reduce_back
        if rank == 0:
            torch.save({k: v.cpu() for k, v in api.net.items()},
                       work / f"{tag}-control0.pt")
    return dict(num_batches=api.num_batches, rounds=recs, finite=finite)


def seq_rank(work):
    """Every rank of the seq phase's world (fedml_tpu_torch.mesh.world)."""
    from fedml_tpu_torch.mesh import make_2d_mesh

    work = Path(work)
    t0 = time.perf_counter()
    torch.cuda.set_device(0)
    torch.cuda.init()
    out = {"seconds": {"cuda init": time.perf_counter() - t0}}

    def lap(label, fn):
        t = time.perf_counter()
        out[label] = fn()
        out["seconds"][label] = time.perf_counter() - t

    mesh = make_2d_mesh(2, 2, ("clients", "seq"))
    if mesh.member:
        lap("attention", lambda: _seq_attention(mesh))
    mesh = make_2d_mesh(None, 2, ("clients", "seq"))
    lap("ring", lambda: _seq_engine(mesh, work, "ring", SEQ_ROUNDS, "ring",
                                    control=True))
    mesh = make_2d_mesh(2, 2, ("clients", "seq"))
    if mesh.member:
        lap("ulysses", lambda: _seq_engine(mesh, work, "ulysses", 1,
                                           "ulysses"))
    return out


def _seq_rel(a, b):
    num = sum(float((a[k].double() - b[k].double()).square().sum())
              for k in a)
    return (num / sum(float(a[k].double().square().sum()) for k in a)) ** 0.5


def _seq_oracle(work, ranks, tag, rounds, data, cfg):
    """Each round of ``tag`` against the single-process FedAvgAPI (flash)
    from the same entering weights: relative parameter distance within
    TOL_SEQ_ROUND, count exact; the oracle round's update relative to the
    weights (``upd``), its wall and its peak beside. Where the ranks left
    a control round (``_seq_engine``), its distance to the oracle's round
    0 must exceed TOL_SEQ_ROUND."""
    from fedml_tpu_torch.algorithms import FedAvgAPI
    from fedml_tpu_torch.core.tasks import sequence_task
    from fedml_tpu_torch.models import create_model

    api = FedAvgAPI(data, sequence_task(create_model("transformer_flash",
                                                     **SLICE_WIDTHS)), cfg)
    out = []
    for r in range(rounds):
        enter = torch.load(work / f"{tag}-enter{r}.pt")
        api.load_state(enter)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        m = api.run_round(r)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = torch.load(work / f"{tag}-result{r}.pt")
        want = {k: v.cpu() for k, v in api.net.items()}
        rel = _seq_rel(want, got)
        counts = [rk[tag]["rounds"][r]["metrics"]["count"] for rk in ranks
                  if tag in rk]
        out.append(dict(rel=rel, upd=_seq_rel(enter, want),
                        count=float(m["count"]), counts=counts,
                        wall_s=wall, peak_bytes=torch.cuda.max_memory_allocated()))
        if rel > TOL_SEQ_ROUND or any(c != float(m["count"]) for c in counts):
            raise AssertionError(f"seq: {tag} round {r}: rel {rel:.3e} "
                                 f"(tol {TOL_SEQ_ROUND}), count {counts} vs "
                                 f"{float(m['count'])}")
        control = work / f"{tag}-control{r}.pt"
        if control.exists():
            out[-1]["control_rel"] = c = _seq_rel(want, torch.load(control))
            print(f"seq: {tag} round {r}, planted control (seq_invariant's "
                  f"gradient all-reduce taken out): rel {c:.3e}, must exceed "
                  f"{TOL_SEQ_ROUND}")
            if not c > TOL_SEQ_ROUND:
                raise AssertionError(
                    f"seq: {tag}: the control without seq_invariant's "
                    f"reduce lands at rel {c:.3e}, inside TOL_SEQ_ROUND "
                    f"{TOL_SEQ_ROUND}: the oracle cannot see that fault")
    return out


def _shares(per, key):
    return ", ".join(f"{p[key] / p['wall_s']:.1%}" for p in per)


def _seq_want(steps, depth, per_layer):
    """Launches a rank makes in one round: per_layer of each kernel per
    layer and local step."""
    n = steps * depth * per_layer
    return {"flash_fwd": n, "flash_bwd_dq": n, "flash_bwd_dkv": n}


def phase_seq(report):
    from fedml_tpu_torch.algorithms import FedAvgConfig
    from fedml_tpu_torch.mesh.world import spawn

    loader.build_all()  # the ranks load the libraries, never build them
    tmp = tempfile.mkdtemp(prefix="seq-")
    work = Path(tmp)
    try:
        t0 = time.perf_counter()
        ranks = spawn("chip_smoke:seq_rank", SEQ_WORLD, (tmp,),
                      deadline_s=SEQ_DEADLINE_S, workdir=str(work / "world"))
        print(f"seq: world of {SEQ_WORLD} ranks on one card (gloo, "
              f"host-staged) done in {time.perf_counter() - t0:.1f} s; "
              "seconds by rank: " + "; ".join(
                  ", ".join(f"{k} {v:.1f}" for k, v in rk["seconds"].items())
                  for rk in ranks))
        rec = report["seq"] = {"ranks": ranks}
        bad = []
        for r in (0, 1):
            for name, st in ranks[r]["attention"].items():
                print(f"seq: (a) rank {r} {name} {list(SEQ_ATTN.values())}: out "
                      f"max|err| {st['out']:.3e} (tol {TOL_SEQ_OUT:g}), "
                      f"dq/dk/dv " + ", ".join(f"{e:.3e}" for e in st["grads"])
                      + f" (tol {TOL_SEQ_GRAD:g}) {_card_tag()}")
                if not st["ok"]:
                    bad.append(f"rank {r} {name}")
        if bad:
            raise AssertionError(f"seq: (a) disagrees: {bad}")

        data = _seq_data()
        cfg = FedAvgConfig(comm_round=SEQ_ROUNDS, **SLICE_FED)
        depth = SLICE_WIDTHS["depth"]
        tokens = cfg.client_num_per_round * ranks[0]["ring"]["num_batches"] \
            * cfg.batch_size * _T
        for tag, rounds, per_layer, n in (("ring", SEQ_ROUNDS, 2, 4),
                                          ("ulysses", 1, 1, 2)):
            label = "(b) ring + flash, 2 x 2" if tag == "ring" else \
                "(c) Ulysses + flash, 1 x 2"
            oracle = _seq_oracle(work, ranks, tag, rounds, data, cfg)
            rec[f"{tag}_oracle"] = oracle
            want = _seq_want(ranks[0][tag]["num_batches"], depth, per_layer)
            for r in range(rounds):
                per = [rk[tag]["rounds"][r] for rk in ranks[:n]]
                wall = max(p["wall_s"] for p in per)
                print(f"seq: {label} round {r}: rel {oracle[r]['rel']:.3e} "
                      f"(tol {TOL_SEQ_ROUND}; the round's update is "
                      f"{oracle[r]['upd']:.3e} of the weights) count "
                      f"{oracle[r]['count']:.0f}; "
                      f"wall {wall:.4f} s, {tokens / wall:.0f} train tokens/s"
                      f" (single process {oracle[r]['wall_s']:.4f} s, "
                      f"{tokens / oracle[r]['wall_s']:.0f} tokens/s); "
                      f"exchanges {_shares(per, 'comm_s')} of the wall by "
                      f"rank, device waits before them "
                      f"{_shares(per, 'drain_s')}; "
                      f"peak MiB by rank "
                      + ", ".join(f"{p['peak_bytes'] / 2**20:.1f}" for p in per)
                      + f" (single process {oracle[r]['peak_bytes'] / 2**20:.1f})"
                      f"; launches by rank {[p['launches'] for p in per]} "
                      + _card_tag())
                for i, p in enumerate(per):
                    if p["launches"] != want:
                        raise AssertionError(
                            f"seq: {label} rank {i} round {r}: launches "
                            f"{p['launches']} != {want}")
            if not all(rk[tag]["finite"] for rk in ranks[:n]):
                raise AssertionError(f"seq: {label}: non-finite params")
        rec["launches"] = {
            tag: {name: sum(rk[tag]["rounds"][r]["launches"][name]
                            for rk in ranks if tag in rk
                            for r in range(len(rk[tag]["rounds"])))
                  for name in fa.LAUNCHES}
            for tag in ("ring", "ulysses")}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    # the kernels at the seq path's shapes: times beside their bounds and
    # SDPA's (the parent process, after the world has gone)
    rec["shapes"] = []
    for s in SEQ_SHAPES:
        st = check_kernels(s["B"], s["T"], s["H"], s["D"], s["causal"],
                           timed=True)
        rec["shapes"].append(dict(shape=[s["B"], s["T"], s["H"], s["D"]],
                                  causal=s["causal"], stats=st))


def _initial_state(data, cfg):
    """The weights every rank of a job at ``cfg`` starts from (the
    engine's and the aggregator's init from the seed)."""
    from fedml_tpu_torch.core.tasks import classification_task
    from fedml_tpu_torch.models import create_model

    task = classification_task(create_model("cnn", output_dim=62))
    return task.init(torch.Generator().manual_seed(cfg.seed),
                     data.train_x[:cfg.batch_size])


def _seq_rows(report, name):
    """The seq phase's part of a kernel's row: its launches on the seq
    path (summed over the ranks and rounds of (b) and (c)) and its time,
    bounds and SDPA's at each of the path's shapes."""
    seq = report.get("seq", {})
    shapes = []
    for s in seq.get("shapes", []):
        st, sdpa = s["stats"][name], s["stats"]["sdpa"]
        shapes.append({
            "shape": s["shape"], "causal": s["causal"], "ms": st["ms"],
            "plain_ms": st["plain_ms"], "bound_ms": st["bound_ms"],
            "bound_by": st["bound_by"], "max_abs_err": st["max_abs_err"],
            "library_ms": sdpa["fwd_ms"] if name == "flash_fwd" else None,
            "library_pair_ms": None if name == "flash_fwd"
            else sdpa["bwd_ms"]})
    return {"seq_launches": {tag: n[name] for tag, n in
                             seq.get("launches", {}).items()},
            "seq_shapes": shapes}


def kernel_line(report):
    stats, launches = report.get("kernels", {}), report.get("launches", {})
    sdpa = stats.get("sdpa", {})
    pair = sdpa.get("bwd_ms")
    rows = []
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        st = stats.get(name, {})
        rows.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[name], "launches": launches.get(name),
            "max_abs_err": st.get("max_abs_err"), "ms": st.get("ms"),
            "plain_ms": st.get("plain_ms"), "bound_ms": st.get("bound_ms"),
            "bound_by": st.get("bound_by"), "bound_tc_ms": st.get("bound_tc_ms"),
            "bound_f32_ms": st.get("bound_f32_ms"),
            # one library call computes the forward alone; its backward
            # computes dQ, dK and dV together, so it is set against the two
            # backward kernels together and charged to neither alone
            "library_ms": sdpa.get("fwd_ms") if name == "flash_fwd" else None,
            "library_pair_ms": None if name == "flash_fwd" else pair,
            **_seq_rows(report, name),
        })
    return {"kernels": rows}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help=f"comma-separated subset of {','.join(PHASES)}")
    args = ap.parse_args(argv)
    phases = [p for p in args.phases.split(",") if p]
    unknown = set(phases) - set(PHASES)
    if unknown:
        ap.error(f"unknown phases {sorted(unknown)}")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2

    report, failed = {}, []
    for name in PHASES:
        if name not in phases:
            continue
        t0 = time.perf_counter()
        print(f"== {name}", flush=True)
        try:
            globals()[f"phase_{name}"](report)
        except Exception:  # noqa: BLE001 — every phase reports, then exit 1
            traceback.print_exc()
            failed.append(name)
        print(f"== {name}: {'FAILED' if name in failed else 'ok'} in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    if failed:
        print(f"chip_smoke: failed phases {failed}", file=sys.stderr)
        return 1
    print(json.dumps(kernel_line(report)))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
