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
           long-context slice shape and at ragged shapes of every head dim
           the kernels take, and run twice for bitwise equal outputs; the
           forward (o and lse) against float64 at every one of those
           shapes, the backward pair at the slice shape, each within
           F32_ERR_FACTOR x its plain float32 version's error; its time,
           the plain version's time and scaled_dot_product_attention's,
           whose CUDA kernels are named; a [B,T,H,D] view off a 16-byte
           boundary refused by all three wrappers before any launch
  slice    FedAvg over TransformerLM("transformer_flash", vocab 1024, dim
           256, depth 4, heads 8, T 2048): 2 rounds of 4 clients x 2 local
           SGD steps, every attention call through the kernels (launch
           counters); the same rounds from the same weights with plain
           attention must agree; one more round under torch.profiler
Then one JSON line listing every kernel, and as the last line
{"ok": true, "device": {...}}. Any failed phase exits non-zero and prints
no result line. Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import argparse
import importlib
import json
import math
import re
import statistics
import subprocess
import sys
import time
import traceback

import torch
import torch.nn.functional as F

from fedml_tpu_torch.ops import loader

# the package re-exports a function of the same name, so fetch the module
fa = importlib.import_module("fedml_tpu_torch.ops.flash_attention")

PHASES = ("device", "build", "kernels", "slice")
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
SLICE_SHAPE = dict(B=4, T=2048, H=8, D=32, causal=True)
# ragged T, and every other head dim the kernels are built for
RAGGED_SHAPES = (dict(B=2, T=1000, H=4, D=64, causal=True),
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
    if timed:
        _check_f64(runs, _f64_bwd(q, k, v, do, lse_ref, corr, causal),
                   where)
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

    widths = dict(vocab_size=1024, dim=256, depth=4, num_heads=8,
                  max_len=2048)
    T, rounds = 2048, 2
    t0 = time.perf_counter()
    data = synthetic_sequences(num_clients=8, seq_len=T, vocab_size=1024,
                               samples_per_client=8, test_samples=16)
    print(f"slice: synthetic_sequences set-up {time.perf_counter() - t0:.1f} s")
    cfg = FedAvgConfig(comm_round=rounds, client_num_in_total=8,
                       client_num_per_round=4, epochs=1, batch_size=4,
                       max_batches=2, lr=0.1, frequency_of_the_test=1,
                       eval_batch_size=4, seed=0)
    api = FedAvgAPI(data, sequence_task(create_model("transformer_flash",
                                                     **widths)), cfg)
    start = {k: v.clone() for k, v in api.net.items()}
    n_params = sum(v.numel() for v in start.values())

    fa.reset_launches()
    api.train()
    torch.cuda.synchronize()
    launches = dict(fa.LAUNCHES)
    report["launches"] = launches

    steps = cfg.client_num_per_round * api.num_batches * widths["depth"]
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
    profile_round(api, rounds, tokens)


def profile_round(api, round_idx, tokens):
    """One more round under torch.profiler: device time by kernel group
    and the device's busy share of the round's wall time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        api.run_round(round_idx)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    us = {e.key: getattr(e, "self_device_time_total", 0) for e in kernels}
    busy = sum(us.values()) / 1e6
    print(f"profile: round {round_idx} (train only) wall {wall:.4f} s, "
          f"{tokens / wall:.0f} train tokens/s")
    if not busy:
        print("profile: device time not measured (profiler saw no kernels)")
        return
    groups = {"flash kernels": 0.0, "matmul": 0.0, "other": 0.0}
    for name, t in us.items():
        low = name.lower()
        g = ("flash kernels" if "flash_" in low else
             "matmul" if any(s in low for s in ("gemm", "cutlass", "cublas"))
             else "other")
        groups[g] += t / 1e6
    print(f"profile: device busy {busy:.4f} s = {busy / wall:.1%} of wall; "
          + ", ".join(f"{g} {t:.4f} s ({t / busy:.1%})"
                      for g, t in groups.items()))
    top = sorted(us.items(), key=lambda kv: -kv[1])
    calls = {e.key: e.count for e in kernels}
    for name, t in top[:6] + [kv for kv in top[6:] if "flash_" in kv[0]]:
        print(f"profile:   {t / 1e3:9.3f} ms  {calls[name]:4d} launches  "
              f"{name[:90]}")


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
