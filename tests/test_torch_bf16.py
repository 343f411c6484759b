"""The bf16 client-compute policy in the port (core/local.py
``LocalSpec.compute_dtype``, ``resolve_local_spec``'s grafting, the CNN's
activation ``dtype`` and flax's per-layer dtype promotion) against the JAX
package on the CPU.

The policy casts explicitly, as the reference does (not ``torch.autocast``):
inside the gradient closure the f32 masters and float inputs become bf16,
the gradient comes back f32 through the casts, and the optimizer step, the
upload and the aggregate stay f32. Bounds, measured here on the CPU:

- model ``dtype`` None (the layers promote: an f32 input meets the bf16
  weights in f32, so only the gradient is rounded to bf16 on its way back
  through the promotion): one engine round from the same weights differs
  from the JAX engine's by at most ``2**-8`` (one bf16 rounding) of the
  largest update entry, per tensor (measured: at most 0.16 %);
- model ``dtype=bfloat16`` (convolutions and the first dense layer in
  bf16): the round's mean training loss within 2e-2 of the JAX engine's
  (the reference's own bf16 bound; measured: 2.0e-4), the params within
  ``2**-4`` of the largest update entry per tensor (measured: 2.6 %).
"""

import dataclasses
import io
import json
import threading
import time
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.algorithms.fedavg import FedAvgAPI as JaxFedAvgAPI
from fedml_tpu.algorithms.fedavg import FedAvgConfig as JaxConfig
from fedml_tpu.core.tasks import classification_task as jax_classification_task
from fedml_tpu.data.registry import load_dataset as jax_load_dataset
from fedml_tpu.models.cnn import CNNOriginalFedAvg as JaxCNN
from fedml_tpu_torch import convert
from fedml_tpu_torch.algorithms.fedavg import (
    FedAvgAPI,
    FedAvgConfig,
    resolve_local_spec,
)
from fedml_tpu_torch.core.local import LocalSpec
from fedml_tpu_torch.core.tasks import classification_task
from fedml_tpu_torch.data.registry import load_dataset
from fedml_tpu_torch.data.synthetic import synthetic_lr
from fedml_tpu_torch.models import create_model
from fedml_tpu_torch.models.cnn import CNNOriginalFedAvg

CNN_CFG = dict(comm_round=1, client_num_in_total=4, client_num_per_round=2,
               batch_size=4, max_batches=2, lr=0.1, frequency_of_the_test=1,
               eval_batch_size=8, seed=0)
_MNIST = dict(client_num=4, samples_per_client=8, test_samples=16,
              uint8_pixels=True)


def _lr_cfg(**kw):
    base = dict(comm_round=3, client_num_in_total=8, client_num_per_round=4,
                batch_size=16, lr=0.1, max_batches=3,
                frequency_of_the_test=100)
    base.update(kw)
    return FedAvgConfig(**base)


@pytest.fixture(scope="module")
def lr_data():
    return synthetic_lr(num_clients=8, dim=20, num_classes=5, seed=0)


def _lr_task():
    return classification_task(create_model("lr", output_dim=5,
                                            device="cpu"))


def _same(a: dict, b: dict) -> bool:
    return all(torch.equal(a[k], b[k]) for k in a)


# ------------------------------------------------------------ f32 default
@pytest.mark.parametrize("spelling", ["f32", "float32"])
def test_f32_explicit_is_bitwise_the_default_engine(lr_data, spelling):
    a = FedAvgAPI(lr_data, _lr_task(), _lr_cfg(), device="cpu")
    b = FedAvgAPI(lr_data, _lr_task(), _lr_cfg(precision=spelling),
                  device="cpu")
    for r in range(3):
        a.run_round(r)
        b.run_round(r)
    assert _same(a.net, b.net)
    assert "prec" not in b._agg_record
    assert b._variant_name() == f"round_b{b.num_batches}"


def test_f32_cnn_is_bitwise_the_pre_policy_forward():
    """The CNN's promotion is a no-op in f32: its forward is the plain
    nn.Conv2d / nn.Linear one, bit for bit."""
    torch.manual_seed(0)
    m = CNNOriginalFedAvg(only_digits=True)
    x = torch.rand(3, 28, 28, 1)
    with torch.no_grad():
        h = x.permute(0, 3, 1, 2)
        h = torch.relu(torch.max_pool2d(m.conv1(h), 2))
        h = torch.relu(torch.max_pool2d(m.conv2(h), 2))
        want = m.fc2(torch.relu(m.fc1(h.flatten(1))))
        assert torch.equal(m(x), want)


def test_precision_validation_and_grafting():
    with pytest.raises(ValueError, match="precision"):
        resolve_local_spec(None, FedAvgConfig(precision="fp8"))
    spec = resolve_local_spec(None, FedAvgConfig(precision="bf16"))
    assert spec.compute_dtype == "bf16"
    from fedml_tpu_torch.algorithms.fedavg import make_client_optimizer

    opt = make_client_optimizer(FedAvgConfig())
    passed = LocalSpec(optimizer=opt, prox_mu=0.5)
    grafted = resolve_local_spec(passed, FedAvgConfig(precision="bf16"))
    assert grafted.compute_dtype == "bf16" and grafted.prox_mu == 0.5
    own = LocalSpec(optimizer=opt, compute_dtype="bfloat16")
    assert resolve_local_spec(own, FedAvgConfig()) is own


# ----------------------------------------------------------- bf16 engine
def test_bf16_is_real_masters_stay_f32_and_drivers_agree(lr_data):
    """bf16 changes the bits (the cast is real), the masters stay f32, the
    records stamp the policy, and per round ≡ pipelined ≡ device-resident
    ≡ bucketed, bitwise."""
    a32 = FedAvgAPI(lr_data, _lr_task(), _lr_cfg(), device="cpu")
    cfg = _lr_cfg(precision="bf16")
    a = FedAvgAPI(lr_data, _lr_task(), cfg, device="cpu")
    for r in range(3):
        a32.run_round(r)
        a.run_round(r)
    assert not _same(a32.net, a.net)
    assert all(v.dtype == torch.float32 for v in a.net.values())
    assert a._agg_record["prec"] == "bf16"
    assert a._variant_name(B=3) == "round_bf16_b3"
    assert a.warmup()["variants"] == ["round_bf16_b3"]
    for kw in (dict(prefetch=2), dict(device_data=True),
               dict(bucket_batches=True)):
        b = FedAvgAPI(lr_data, _lr_task(), cfg, device="cpu", **kw)
        if kw.get("prefetch"):
            b.run_pipelined(0, 3)
        else:
            for r in range(3):
                b.run_round(r)
        assert _same(a.net, b.net), kw


def _round_pair(dtype):
    """One bf16 engine round of the 10-class CNN in each package from the
    same weights: (start, port net, JAX net, port metrics, JAX metrics)."""
    jtask = jax_classification_task(JaxCNN(
        only_digits=True, dtype=None if dtype is None else jnp.bfloat16))
    japi = JaxFedAvgAPI(jax_load_dataset("mnist", **_MNIST), jtask,
                        JaxConfig(**CNN_CFG, precision="bf16"))
    start = convert.from_flax(jax.tree.map(np.asarray, japi.net.params))
    jm = japi.run_round(0)
    api = FedAvgAPI(load_dataset("mnist", **_MNIST), classification_task(
        CNNOriginalFedAvg(only_digits=True, dtype=dtype)),
        FedAvgConfig(**CNN_CFG, precision="bf16"), device="cpu")
    api.load_state(start)
    m = api.run_round(0)
    want = convert.from_flax(jax.tree.map(np.asarray, japi.net.params))
    return start, api.net, want, m, jm


def _update_bound(start, got, want, frac):
    for k in got:
        upd = float((want[k] - start[k]).abs().max())
        gap = float((got[k] - want[k]).abs().max())
        assert gap <= frac * upd, (k, gap, upd)


def test_bf16_round_within_one_bf16_rounding_of_jax_dtype_none():
    start, got, want, m, jm = _round_pair(None)
    assert all(v.dtype == torch.float32 for v in got.values())
    _update_bound(start, got, want, 2.0 ** -8)
    loss = float(m["loss_sum"]) / float(m["count"])
    jloss = float(jm["loss_sum"]) / float(jm["count"])
    assert abs(loss - jloss) <= 1e-5


def test_bf16_round_with_bf16_activations_against_jax():
    start, got, want, m, jm = _round_pair(torch.bfloat16)
    loss = float(m["loss_sum"]) / float(m["count"])
    jloss = float(jm["loss_sum"]) / float(jm["count"])
    assert abs(loss - jloss) <= 2e-2
    _update_bound(start, got, want, 2.0 ** -4)


def test_bf16_cnn_returns_f32_logits_and_promotes():
    m = CNNOriginalFedAvg(only_digits=True, dtype=torch.bfloat16)
    x = torch.rand(2, 28, 28, 1)
    assert m(x).dtype == torch.float32
    plain = CNNOriginalFedAvg(only_digits=True)
    params = {k: v.detach().to(torch.bfloat16)
              for k, v in plain.named_parameters()}
    out = torch.func.functional_call(plain, params, (x,))
    assert out.dtype == torch.float32  # f32 input x bf16 weights -> f32


def test_bf16_transformer_refuses_naming_the_item():
    lm = create_model("transformer", output_dim=16, device="cpu", dim=16,
                      depth=1, num_heads=2, max_len=8)
    params = {k: v.detach().to(torch.bfloat16)
              for k, v in lm.named_parameters()}
    with pytest.raises(NotImplementedError, match="item 7"):
        torch.func.functional_call(lm, params,
                                   (torch.zeros(1, 4, dtype=torch.long),))


# -------------------------------------------------------- cross-process
def test_bf16_over_loopback_is_the_engine_and_stamps_prec(lr_data):
    """The distributed trainer honors the policy: a bf16 loopback run is
    bitwise a bf16 pairwise engine-equivalent run of the same trainers
    (fused and stacked agree), and the server's agg record says bf16."""
    from fedml_tpu_torch.distributed.fedavg import run_simulated

    cfg = _lr_cfg(comm_round=2, precision="bf16")
    a = run_simulated(lr_data, _lr_task(), cfg, device="cpu",
                      job_id="tb16-stacked", sum_assoc="pairwise")
    b = run_simulated(lr_data, _lr_task(), cfg, device="cpu",
                      job_id="tb16-fused", fused_agg=True)
    c = run_simulated(lr_data, _lr_task(), dataclasses.replace(
        cfg, precision="f32"), device="cpu", job_id="tb16-f32",
        sum_assoc="pairwise")
    assert _same(a.net, b.net) and not _same(a.net, c.net)
    assert a.agg_record()["prec"] == "bf16"
    assert "prec" not in c.agg_record()


def test_launcher_precision_bf16_over_loopback():
    """``--precision bf16``: a 2-round loopback job of the launcher's
    three ranks as threads, against the same job in f32 (different bits,
    finite histories) and run_simulated's bf16 run (equal histories)."""
    from fedml_tpu_torch.comm import loopback
    from fedml_tpu_torch.experiments import distributed_launch

    def job(prec):
        argv = ["--world_size", "3", "--backend", "loopback",
                "--dataset", "mnist", "--model", "lr", "--comm_round", "2",
                "--client_num_in_total", "4", "--batch_size", "8",
                "--frequency_of_the_test", "1", "--device", "cpu",
                "--precision", prec]
        errors = []

        def rank(r):
            try:
                distributed_launch.main(["--rank", str(r), *argv])
            except BaseException as e:  # noqa: BLE001 — re-raised below
                errors.append(e)

        out = io.StringIO()
        threads = [threading.Thread(target=rank, args=(r,)) for r in (1, 2)]
        try:
            for t in threads:
                t.start()
            deadline = time.monotonic() + 60
            while set(loopback._registry.get("launch", {})) != {1, 2}:
                assert time.monotonic() < deadline and not errors, errors
                time.sleep(0.02)
            with redirect_stdout(out):
                rank(0)
            for t in threads:
                t.join(timeout=0 if errors else 60)
        finally:
            for mgr in list(loopback._registry.get("launch", {}).values()):
                mgr.stop_receive_message()
            for t in threads:
                t.join(timeout=10)
        assert not errors, errors
        return json.loads(out.getvalue().strip().splitlines()[-1])

    h16, h32 = job("bf16"), job("f32")
    assert [h["round"] for h in h16] == [0, 1]
    assert all(np.isfinite(h["test_loss"]) for h in h16)
    assert [h["test_loss"] for h in h16] != [h["test_loss"] for h in h32]
