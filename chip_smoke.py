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
           eval, peak device memory
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
           in-process run of the same configuration, boot and round times
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
import re
import statistics
import subprocess
import sys
import time
import traceback

import numpy as np
import torch
import torch.nn.functional as F

from fedml_tpu_torch.ops import loader

# the package re-exports a function of the same name, so fetch the module
fa = importlib.import_module("fedml_tpu_torch.ops.flash_attention")

PHASES = ("device", "build", "kernels", "slice", "main", "distributed")
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
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = api.run_round(r)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        real = float(m["count"])
        print(f"main: round {r}: {wall:.4f} s, {real / wall:.0f} train "
              f"samples/s ({real:.0f} real of {per_round} slots, "
              f"{per_round / wall:.0f} slots/s)")
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
    procs, files = [], []
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
    errs = [(out_dir / f"rank{r}.err").read_text() for r in (0, 1, 2)]
    if rcs != [0, 0, 0]:
        raise AssertionError(f"launcher ranks exited {rcs}; rank 0's log "
                             f"ends: {errs[0][-2000:]}")
    return (out_dir / "rank0.out").read_text(), errs, t0, t_end


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
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    argv = ["--world_size", "3", "--backend", "mqtt", "--broker_port",
            str(port), "--serve_broker", "1", "--dataset", "femnist",
            "--model", "cnn", "--batch_size", str(MAIN_CFG["batch_size"]),
            "--lr", str(MAIN_CFG["lr"]), "--comm_round", str(LAUNCH_ROUNDS),
            "--client_num_in_total", str(MAIN_CFG["client_num_in_total"]),
            "--frequency_of_the_test", "1", "--seed", "0"]
    with tempfile.TemporaryDirectory(dir=Path(__file__).resolve().parent) as d:
        out, errs, t_launch, t_exit = _launch_job(argv, Path(d))
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
