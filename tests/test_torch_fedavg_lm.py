"""The port's FedAvg engine against the JAX package's on the long-context
slice at a tiny size: TransformerLM + sequence_task, two rounds of 2 of 4
clients from the same converted weights; plus the engine's contracts
(padded-batch no-op, FedProx term, import isolation, device rule)."""

import functools
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from fedml_tpu.algorithms.fedavg import FedAvgAPI as JaxFedAvgAPI
from fedml_tpu.algorithms.fedavg import FedAvgConfig as JaxConfig
from fedml_tpu.algorithms.fedavg import agg_weights as jax_agg_weights
from fedml_tpu.algorithms.fedavg import make_client_optimizer as jax_client_optimizer
from fedml_tpu.core.local import LocalSpec as JaxLocalSpec
from fedml_tpu.core.local import make_local_update as jax_local_update
from fedml_tpu.core.tasks import classification_task as jax_classification_task
from fedml_tpu.core.tasks import sequence_task as jax_sequence_task
from fedml_tpu.models.linear import LogisticRegression
from fedml_tpu.models.transformer import TransformerLM as JaxTransformerLM
from fedml_tpu_torch import convert
from fedml_tpu_torch.algorithms.fedavg import (
    FedAvgAPI,
    FedAvgConfig,
    agg_weights,
    make_client_optimizer,
)
from fedml_tpu_torch.core import optim
from fedml_tpu_torch.core.local import LocalSpec, Task, make_local_update
from fedml_tpu_torch.core.tasks import sequence_task
from fedml_tpu_torch.data.synthetic import synthetic_sequences
from fedml_tpu_torch.models import create_model

WIDTHS = dict(vocab_size=32, dim=32, depth=1, num_heads=2, max_len=64)
# 6 samples per client at batch 4: every client's second batch is half
# padding, so the masks are exercised
CFG = dict(comm_round=2, client_num_in_total=4, client_num_per_round=2,
           batch_size=4, lr=0.1, frequency_of_the_test=1, eval_batch_size=4,
           seed=0)
# float32 on the CPU on both sides; the observed gap is ~1e-7 (summation
# order inside LayerNorm, matmuls and the optimizer update)
TOL = 1e-5


def _data():
    return synthetic_sequences(num_clients=4, seq_len=32, vocab_size=32,
                               samples_per_client=6, test_samples=8)


@functools.lru_cache(maxsize=None)
def _jax_run():
    """Two JAX FedAvg rounds (dense attention: the flash kernels are held
    equal to it by tests/test_flash_attention.py): start params, end
    params and history."""
    task = jax_sequence_task(JaxTransformerLM(**WIDTHS))
    # one jitted init compiles faster than flax's op-by-op eager init
    task = task._replace(init=jax.jit(task.init))
    api = JaxFedAvgAPI(_data(), task, JaxConfig(**CFG))
    start = jax.tree.map(np.asarray, api.net.params)
    api.train()
    return start, jax.tree.map(np.asarray, api.net.params), api.history


@pytest.mark.parametrize("model", ["transformer", "transformer_flash"])
def test_two_rounds_match_jax(model):
    start, end, history = _jax_run()
    api = FedAvgAPI(_data(), sequence_task(create_model(model, device="cpu",
                                                        **WIDTHS)),
                    FedAvgConfig(**CFG), device="cpu")
    api.load_state(convert.from_flax(start))
    api.train()
    want = convert.from_flax(end)
    for k, v in api.net.items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=TOL,
                                   atol=TOL, err_msg=k)
    assert len(api.history) == len(history) == 2
    for rec, ref in zip(api.history, history):
        for key in ("train_loss", "train_acc", "test_loss", "test_acc"):
            np.testing.assert_allclose(rec[key], ref[key], rtol=TOL,
                                       atol=TOL, err_msg=key)


def _fit_inputs(seed=0):
    rs = np.random.RandomState(seed)
    x = rs.randint(1, 32, size=(2, 3, 16))
    return x, (x * 7 + 1) % 31 + 1, np.ones((2, 3), np.float32)


def test_padded_batches_are_noop():
    """A client whose data needs fewer than B batches trains identically
    to the unpadded layout (port of test_fedavg.py's test of that name),
    in a cohort of one through the batched fit."""
    task = sequence_task(create_model("transformer", device="cpu", **WIDTHS))
    net = task.init(torch.Generator().manual_seed(0))
    fit = make_local_update(task, LocalSpec(optimizer=optim.sgd(0.1)))
    x, y, mask = (torch.from_numpy(a)[None] for a in _fit_inputs())
    out1, m1 = fit(net, x, y, mask)
    pad = lambda a: torch.cat(
        [a, torch.zeros((1, 3) + a.shape[2:], dtype=a.dtype)], 1)
    out2, m2 = fit(net, pad(x), pad(y), pad(mask))
    for k in out1:
        assert torch.equal(out1[k], out2[k]), k
    assert float(m1["count"][0]) == float(m2["count"][0]) == 2 * 3 * 16


def _softmax_regression_task():
    """The port-side twin of classification_task(LogisticRegression) for
    the engine test below, which needs no model: params kernel [F, C] and
    bias [C] as flax's Dense keeps them."""

    def loss(params, extra, x, y, mask, key, train):
        logits = x @ params["kernel"] + params["bias"]
        per_ex = F.cross_entropy(logits, y, reduction="none") * mask
        metrics = {"loss_sum": per_ex.sum().detach(),
                   "correct": ((logits.argmax(-1) == y) * mask).sum(),
                   "count": mask.sum()}
        return per_ex.sum() / mask.sum().clamp_min(1.0), extra, metrics

    return Task(None, loss, None, None)


@pytest.mark.parametrize("opt", [
    dict(client_optimizer="sgd", lr=0.1, momentum=0.9, wd=1e-3),
    dict(client_optimizer="adam", lr=0.01, wd=1e-3),
])
def test_local_update_matches_jax(opt):
    """epochs x batches of make_client_optimizer's steps plus the FedProx
    term mu/2 ||w - w_global||^2, with a padded batch, against the JAX
    make_local_update on the same data and weights, in a cohort of one (a
    softmax regression keeps the JAX compile short; the slice's plain SGD
    is held by test_two_rounds_match_jax)."""
    rs = np.random.RandomState(1)
    x = rs.randn(3, 8, 6).astype(np.float32)
    y = rs.randint(0, 3, size=(3, 8))
    mask = np.ones((3, 8), np.float32)
    mask[1, 5:] = 0.0
    mask[2] = 0.0  # a padded batch
    jtask = jax_classification_task(LogisticRegression(num_classes=3))
    jnet = jtask.init(jax.random.PRNGKey(2), x[0])
    jfit = jax_local_update(jtask, JaxLocalSpec(
        optimizer=jax_client_optimizer(JaxConfig(**opt)), epochs=2,
        prox_mu=0.5))
    jout, jm = jfit(jax.random.PRNGKey(0), jnet, x, y, mask)

    start = {k: torch.from_numpy(np.array(v))
             for k, v in jnet.params["Dense_0"].items()}
    fit = make_local_update(_softmax_regression_task(), LocalSpec(
        optimizer=make_client_optimizer(FedAvgConfig(**opt)), epochs=2,
        prox_mu=0.5))
    out, m = fit(start, *(torch.from_numpy(a)[None] for a in (x, y, mask)))
    for k, v in jout.params["Dense_0"].items():
        np.testing.assert_allclose(out[k][0].numpy(), np.asarray(v),
                                   rtol=TOL, atol=TOL, err_msg=k)
    for k in ("loss_sum", "correct", "count"):
        np.testing.assert_allclose(float(m[k][0]), float(jm[k]), rtol=TOL)


@pytest.mark.parametrize("uniform", [False, True])
def test_agg_weights_match_jax(uniform):
    nsamp = np.array([6.0, 0.0, 3.0, 1.0], np.float32)
    got = agg_weights(torch.from_numpy(nsamp), uniform)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jax_agg_weights(nsamp, uniform)))


# the sequence-parallel path's modules, named so that a walk that
# stopped finding them would fail here
SEQ_MODULES = ("fedml_tpu_torch.mesh.mesh", "fedml_tpu_torch.mesh.world",
               "fedml_tpu_torch.collectives.ops",
               "fedml_tpu_torch.parallel.ring_attention",
               "fedml_tpu_torch.algorithms.fedavg_seq")


def test_port_imports_no_jax():
    """Every port module (55 of them: the main path's data plane, native
    packer, models, task, optimizers and engine, the cross-process
    runtime's comm, obs, distributed and launcher modules, and the
    sequence-parallel path's mesh, collectives and engine among them)
    imports without jax, flax, optax or fedml_tpu."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import fedml_tpu_torch as pkg\n"
        "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'flax', 'optax', 'fedml_tpu'))\n"
        "assert not bad, bad\n"
        f"missing = [n for n in {SEQ_MODULES!r} if n not in sys.modules]\n"
        "assert not missing, missing\n"
        "print(len([n for n in sys.modules if n.startswith(pkg.__name__)]))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         cwd=Path(__file__).resolve().parents[1])
    assert out.returncode == 0, out.stderr
    assert int(out.stdout) >= 55  # every module was imported


def test_entry_points_need_a_device_without_cuda():
    """No CUDA and no explicit device: the entry points raise; there is no
    silent CPU path."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        create_model("transformer_flash", **WIDTHS)
    task = sequence_task(create_model("transformer", device="cpu", **WIDTHS))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        FedAvgAPI(_data(), task, FedAvgConfig(**CFG))


# prefetch, precision='bf16' and remat run now (tests/test_torch_pipeline.py,
# tests/test_torch_bf16.py, tests/test_torch_extras.py): their cases pair
# them with an option still refused, the block working set and donate
# (item 5)
@pytest.mark.parametrize("kwargs,cfg", [
    (dict(mesh=object()), {}),
    (dict(prefetch=2, block_working_set=True), {}),
    (dict(donate=True), dict(precision="bf16", remat=True)),
])
def test_unported_engine_options_raise(kwargs, cfg):
    task = sequence_task(create_model("transformer", device="cpu", **WIDTHS))
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        FedAvgAPI(_data(), task, FedAvgConfig(**CFG, **cfg), device="cpu",
                  **kwargs)
