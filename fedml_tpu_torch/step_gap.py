"""Where one local step of the main path departs from float64, client by
client and tensor by tensor.

    python -m fedml_tpu_torch.step_gap                          # on the card
    python -m fedml_tpu_torch.step_gap --device cpu --clients 200

Takes the first two rounds' clients of bench.py's FEMNIST configuration
(CNNOriginalFedAvg, batch 20, SGD lr 0.1), one batch each, and runs one step
of the cohort's batched fit from the same weights: in float64 on the CPU
(the yardstick), in float32 on the CPU and, on the card, in float32 as the
engine runs it, with cuDNN's own weight gradient in place of the model's
im2col GEMM, and with the engine's float32 policy off and TF32 allowed.
Prints each run's relative error against float64 by parameter tensor and by
client (||update - float64 update|| / ||float64 update||), then, on the
card, the wall time of round 0's whole fit (28 batches) with the model's
weight gradient and with cuDNN's (10 runs each, alternating, after a
warm-up pair).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import statistics
import time
from unittest import mock

import torch
import torch.nn.functional as F

from fedml_tpu_torch.algorithms import fedavg
from fedml_tpu_torch.algorithms.fedavg import FedAvgAPI, FedAvgConfig
from fedml_tpu_torch.core.tasks import classification_task
from fedml_tpu_torch.data import load_dataset
from fedml_tpu_torch.models import cnn, create_model


def _update(api, net, x, y, mask):
    with fedavg.float32_compute():
        nets, _ = api.local_update(net, x, y, mask)
    return {k: (v - net[k]).detach().double().cpu() for k, v in nets.items()}


def _time_fit(api, batch):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with fedavg.float32_compute():
        api.local_update(api.net, *batch)
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def _report(name, got, ref):
    by_tensor = " ".join(f"{k} {float((got[k] - ref[k]).norm() / ref[k].norm()):.1e}"
                         for k in ref)
    sq = lambda u: sum((t.flatten(1) ** 2).sum(1) for t in u.values())
    by_client = (sq({k: got[k] - ref[k] for k in ref}) / sq(ref)).sqrt()
    print(f"  {name:24s} by tensor: {by_tensor}")
    print(f"  {name:24s} by client: "
          + " ".join(f"{float(v):.1e}" for v in by_client))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--clients", type=int, default=None,
                    help="population (default: FEMNIST's 3,400)")
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    data = load_dataset("femnist", seed=0, uint8_pixels=True,
                        client_num=args.clients)
    cfg = FedAvgConfig(client_num_in_total=data.num_clients,
                       client_num_per_round=10, epochs=1, batch_size=20,
                       lr=0.1, max_batches=1, seed=0)
    task = lambda d: classification_task(create_model("cnn", output_dim=62,
                                                      device=d))
    cpu = FedAvgAPI(data, task("cpu"), cfg, device="cpu")
    dev = FedAvgAPI(data, task(args.device), cfg, device=args.device)
    start = {k: v.detach().cpu() for k, v in cpu.net.items()}
    on_dev = lambda ts: [t.to(dev.device) for t in ts]
    for r in (0, 1):
        ids = cpu._sampled_ids(r)
        x, y, mask, _ = cpu._round_batch(r, ids)
        print(f"round {r}: clients {[int(c) for c in ids]}")
        ref = _update(cpu, {k: v.double() for k, v in start.items()},
                      x.double() / 255, y, mask)
        runs = {"cpu f32": _update(cpu, start, x, y, mask)}
        net = {k: v.to(dev.device) for k, v in start.items()}
        runs[f"{args.device} f32"] = _update(dev, net, *on_dev((x, y, mask)))
        with mock.patch.object(cnn, "conv2d", lambda x, w, b, p:
                               F.conv2d(x, w, b, padding=p)):
            runs[f"{args.device} cuDNN wgrad"] = _update(
                dev, net, *on_dev((x, y, mask)))
        flags = (torch.backends.cudnn.allow_tf32,
                 torch.backends.cuda.matmul.allow_tf32)
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            with mock.patch.object(fedavg, "float32_compute",
                                   contextlib.nullcontext):
                runs[f"{args.device} TF32"] = _update(
                    dev, net, *on_dev((x, y, mask)))
        finally:
            (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32) = flags
        for name, got in runs.items():
            _report(name, got, ref)
    if dev.device.type == "cuda":
        fit = FedAvgAPI(data, task(args.device), dataclasses.replace(
            cfg, max_batches=28), device=args.device, device_data=True)
        batch = fit._round_batch(0, fit._sampled_ids(0))[:3]
        variants = {"model": cnn.conv2d, "cuDNN wgrad": lambda x, w, b, p:
                    F.conv2d(x, w, b, padding=p)}
        times = {name: [] for name in variants}
        for rep in range(11):  # alternating, the first pair a warm-up
            for name, conv in variants.items():
                with mock.patch.object(cnn, "conv2d", conv):
                    times[name].append(_time_fit(fit, batch))
        for name, ts in times.items():
            ts = sorted(ts[1:])
            print(f"round 0's fit (28 batches), {name} weight gradient: "
                  f"median {statistics.median(ts) * 1e3:.1f} ms (range "
                  f"{ts[0] * 1e3:.1f}-{ts[-1] * 1e3:.1f}, 10 runs)")


if __name__ == "__main__":
    main()
