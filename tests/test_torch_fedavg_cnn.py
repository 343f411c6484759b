"""The port's FedAvg engine on the main path against the JAX package's: the
cohort-batched local fit (torch.func) per client against JAX
``local_update`` for SGD + momentum + weight decay, Adam and FedProx; two
CNNOriginalFedAvg rounds against JAX ``FedAvgAPI`` from converted weights;
per-client eval; and ports of the engine oracles of tests/test_fedavg.py on
LogisticRegression (full participation == centralized GD, exact sample
weighting, padded batches as no-ops, deterministic sampling), plus the
device-resident data plane and ``run_rounds``."""

import functools

import jax
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from fedml_tpu.algorithms.fedavg import FedAvgAPI as JaxFedAvgAPI
from fedml_tpu.algorithms.fedavg import FedAvgConfig as JaxConfig
from fedml_tpu.algorithms.fedavg import make_client_optimizer as jax_client_optimizer
from fedml_tpu.core.local import LocalSpec as JaxLocalSpec
from fedml_tpu.core.local import make_local_update as jax_local_update
from fedml_tpu.core.sampling import sample_clients as jax_sample_clients
from fedml_tpu.core.tasks import classification_task as jax_classification_task
from fedml_tpu.models.cnn import CNNOriginalFedAvg as JaxCNN
from fedml_tpu.models.linear import LogisticRegression as JaxLR
from fedml_tpu_torch import convert
from fedml_tpu_torch.algorithms.fedavg import (
    FedAvgAPI,
    FedAvgConfig,
    make_client_optimizer,
)
from fedml_tpu_torch.core.local import LocalSpec, make_local_update
from fedml_tpu_torch.core.sampling import sample_clients
from fedml_tpu_torch.core.tasks import classification_task
from fedml_tpu_torch.data.registry import load_dataset
from fedml_tpu_torch.data.synthetic import synthetic_images, synthetic_lr
from fedml_tpu_torch.models import create_model

# float32 on the CPU on both sides; the observed gaps are ~1e-7 (summation
# order in the convolutions, the dense layers and the optimizer updates)
TOL = 1e-5


def _lr_task(classes):
    return classification_task(create_model("lr", output_dim=classes,
                                            device="cpu"))


@pytest.fixture(scope="module")
def lr_data():
    return synthetic_lr(num_clients=8, dim=20, num_classes=5, seed=0)


def _cohort(seed=1, K=3, B=3, bs=8, dim=6, classes=3):
    """K clients' packed batches: client 1 has a partial batch and a padded
    batch in the middle, the last client a padded last batch."""
    rs = np.random.RandomState(seed)
    x = rs.randn(K, B, bs, dim).astype(np.float32)
    y = rs.randint(0, classes, size=(K, B, bs))
    mask = np.ones((K, B, bs), np.float32)
    mask[1, 0, 5:] = 0.0
    mask[1, 1] = 0.0
    mask[-1, -1] = 0.0
    return x, y, mask


@pytest.mark.parametrize("opt", [
    dict(client_optimizer="sgd", lr=0.1, momentum=0.9, wd=1e-3),
    dict(client_optimizer="adam", lr=0.01, wd=1e-3),
    dict(client_optimizer="sgd", lr=0.1, prox_mu=0.5),
], ids=["sgd-momentum-wd", "adam-wd", "fedprox"])
def test_batched_fit_matches_jax_per_client(opt):
    """The cohort runs through one batched fit; each client's params and
    metric sums equal JAX local_update's on that client's batches."""
    opt = dict(opt)
    mu = opt.pop("prox_mu", 0.0)
    x, y, mask = _cohort()
    jtask = jax_classification_task(JaxLR(num_classes=3))
    jnet = jtask.init(jax.random.PRNGKey(2), x[0, 0])
    jfit = jax_local_update(jtask, JaxLocalSpec(
        optimizer=jax_client_optimizer(JaxConfig(**opt)), epochs=2,
        prox_mu=mu))
    keys = jax.random.split(jax.random.PRNGKey(0), len(x))
    jout, jm = jax.jit(jax.vmap(jfit, in_axes=(0, None, 0, 0, 0)))(
        keys, jnet, x, y, mask)

    fit = make_local_update(_lr_task(3), LocalSpec(
        optimizer=make_client_optimizer(FedAvgConfig(**opt)), epochs=2,
        prox_mu=mu))
    out, m = fit(convert.from_flax(jax.tree.map(np.asarray, jnet.params)),
                 *(torch.from_numpy(a) for a in (x, y, mask)))
    for c in range(len(x)):
        want = convert.from_flax(jax.tree.map(lambda a: np.asarray(a[c]),
                                              jout.params))
        for k, v in out.items():
            np.testing.assert_allclose(v[c].numpy(), want[k].numpy(),
                                       rtol=TOL, atol=TOL, err_msg=k)
    for k in ("loss_sum", "correct", "count"):
        np.testing.assert_allclose(m[k].numpy(), np.asarray(jm[k]),
                                   rtol=TOL, atol=TOL, err_msg=k)


@pytest.mark.parametrize("opt", [
    dict(client_optimizer="sgd", lr=0.1),
    dict(client_optimizer="sgd", lr=0.1, momentum=0.9),
    dict(client_optimizer="adam", lr=0.01),
])
def test_padded_batches_are_noop(opt):
    """Port of test_fedavg.py::test_padded_batches_are_noop through the
    batched fit: all-masked batches, trailing or in the middle of one
    client's batches, leave params and optimizer state (Adam's step count
    included) exactly as if they were not there."""
    x, y, mask = _cohort(seed=3, K=2, B=4)
    mask[:] = 1.0
    task = _lr_task(3)
    net = task.init(torch.Generator().manual_seed(0), x[0, 0])
    fit = make_local_update(task, LocalSpec(
        optimizer=make_client_optimizer(FedAvgConfig(**opt))))
    t = lambda *a: tuple(torch.from_numpy(np.ascontiguousarray(v)) for v in a)
    ref, m_ref = fit(net, *t(x, y, mask))
    # three trailing padded batches for both clients
    pad = lambda a: np.concatenate([a, np.zeros_like(a[:, :3])], 1)
    out, m = fit(net, *t(pad(x), pad(y), pad(mask)))
    for k in ref:
        assert torch.equal(out[k], ref[k]), k
    assert torch.equal(m["count"], m_ref["count"])
    # a padded batch between client 0's first and second batch (client 1
    # gets a trailing one), against client 0 fitted alone
    inside = lambda a: np.stack([
        np.concatenate([a[0, :1], np.zeros_like(a[0, :1]), a[0, 1:]]),
        np.concatenate([a[1], np.zeros_like(a[1, :1])])])
    out, _ = fit(net, *t(inside(x), inside(y), inside(mask)))
    solo, _ = fit(net, *t(x[:1], y[:1], mask[:1]))
    for k in ref:
        assert torch.equal(out[k][0], solo[k][0]), k


def test_client_sampling_deterministic():
    """Port of test_fedavg.py::test_client_sampling_deterministic, and the
    draws equal the JAX package's."""
    a = sample_clients(5, 100, 10, seed=1)
    np.testing.assert_array_equal(a, sample_clients(5, 100, 10, seed=1))
    np.testing.assert_array_equal(a, jax_sample_clients(5, 100, 10, seed=1))
    assert not np.array_equal(a, sample_clients(6, 100, 10, seed=1))
    assert len(np.unique(a)) == 10  # without replacement
    np.testing.assert_array_equal(sample_clients(0, 10, 10, seed=1),
                                  np.arange(10))


def test_fedavg_full_participation_equals_centralized(lr_data):
    """Port of the test of that name: FedAvg with full participation, full
    batch, one epoch of SGD equals centralized full-batch GD."""
    max_n = max(len(v) for v in lr_data.train_idx_map.values())
    cfg = FedAvgConfig(comm_round=3, client_num_in_total=8,
                       client_num_per_round=8, epochs=1, batch_size=max_n,
                       lr=0.1, seed=0, frequency_of_the_test=100)
    task = _lr_task(5)
    api = FedAvgAPI(lr_data, task, cfg, device="cpu")
    params = {k: v.clone().requires_grad_(True) for k, v in api.net.items()}
    for r in range(3):
        api.run_round(r)
    x, y = torch.from_numpy(lr_data.train_x), torch.from_numpy(lr_data.train_y)
    for _ in range(3):
        logits = task.predict(params, x)
        g = torch.autograd.grad(F.cross_entropy(logits, y), list(params.values()))
        params = {k: (v - 0.1 * gk).detach().requires_grad_(True)
                  for (k, v), gk in zip(params.items(), g)}
    params = {k: v.detach() for k, v in params.items()}
    diff = sum(float(((api.net[k] - v) ** 2).sum()) for k, v in params.items())
    scale = sum(float((v ** 2).sum()) for v in params.values())
    assert (diff / scale) ** 0.5 < 1e-4


def test_weighted_aggregation_exact():
    """Port of the test of that name: the round's count is the true sample
    count, not the padded size."""
    data = synthetic_images(num_clients=4, image_shape=(6,), num_classes=3,
                            samples_per_client=20, test_samples=50, seed=0)
    sizes = [len(v) for v in data.train_idx_map.values()]
    assert len(set(sizes)) > 1  # ragged by construction
    cfg = FedAvgConfig(comm_round=1, client_num_in_total=4,
                       client_num_per_round=4, epochs=1, batch_size=8, lr=0.1)
    api = FedAvgAPI(data, _lr_task(3), cfg, device="cpu")
    assert float(api.run_round(0)["count"]) == sum(sizes)


def _image_data(uint8=True):
    return synthetic_images(num_clients=6, image_shape=(8, 8, 1),
                            num_classes=4, samples_per_client=10,
                            test_samples=20, seed=2, as_uint8=uint8)


IMG_CFG = dict(comm_round=3, client_num_in_total=6, client_num_per_round=3,
               batch_size=4, lr=0.1, momentum=0.5, frequency_of_the_test=1,
               eval_batch_size=8)


def test_device_data_plane_matches_host_pack():
    """Port of the test of that name: the index plane, gathered on the
    device, trains exactly the host packer's model (uint8 pixels)."""
    host = FedAvgAPI(_image_data(), _lr_task(4), FedAvgConfig(**IMG_CFG),
                     device="cpu")
    dev = FedAvgAPI(_image_data(), _lr_task(4), FedAvgConfig(**IMG_CFG),
                    device="cpu", device_data=True)
    host.train()
    dev.train()
    for k in host.net:
        assert torch.equal(host.net[k], dev.net[k]), k
    assert host.history == [dict(r, round_time=h["round_time"])
                            for r, h in zip(dev.history, host.history)]


def test_run_rounds_equals_sequential():
    cfg = FedAvgConfig(**IMG_CFG)
    block = FedAvgAPI(_image_data(), _lr_task(4), cfg, device="cpu",
                      device_data=True)
    seq = FedAvgAPI(_image_data(), _lr_task(4), cfg, device="cpu",
                    device_data=True)
    ms = block.run_rounds(0, 3)
    ref = [seq.run_round(r) for r in range(3)]
    for k in block.net:
        assert torch.equal(block.net[k], seq.net[k]), k
    for k, v in ms.items():
        assert v.shape == (3,) and torch.equal(v, torch.stack([m[k] for m in ref]))
    with pytest.raises(ValueError, match="device_data"):
        FedAvgAPI(_image_data(), _lr_task(4), cfg,
                  device="cpu").run_rounds(0, 1)


def test_evaluate_per_client_matches_jax(lr_data):
    """Per-client eval (the 'auto' path for datasets with per-client test
    splits) from the same weights: every client's numbers and the
    sample-weighted aggregate, in chunks smaller than the population."""
    cfg = dict(comm_round=1, client_num_in_total=8, client_num_per_round=4,
               batch_size=16, eval_batch_size=16)
    japi = JaxFedAvgAPI(lr_data, jax_classification_task(JaxLR(num_classes=5)),
                        JaxConfig(**cfg))
    api = FedAvgAPI(lr_data, _lr_task(5), FedAvgConfig(**cfg), device="cpu")
    api.load_state(convert.from_flax(jax.tree.map(np.asarray,
                                                  japi.net.params)))
    assert api._eval_on_all_clients()
    for split in ("train", "test"):
        got, agg = api.evaluate_per_client(split, chunk=3)
        want, jagg = japi.evaluate_per_client(split, chunk=3)
        assert [g["client"] for g in got] == [w["client"] for w in want]
        for g, w in zip(got, want):
            for k in ("loss", "acc", "count"):
                np.testing.assert_allclose(g[k], w[k], rtol=TOL, atol=TOL)
        for k in ("loss", "acc", "count"):
            np.testing.assert_allclose(agg[k], jagg[k], rtol=TOL, atol=TOL)


CNN_CFG = dict(comm_round=2, client_num_in_total=4, client_num_per_round=2,
               batch_size=4, max_batches=2, lr=0.1, frequency_of_the_test=1,
               eval_batch_size=8, seed=0)


def _mnist():
    return load_dataset("mnist", client_num=4, samples_per_client=8,
                        test_samples=16, uint8_pixels=True)


@functools.lru_cache(maxsize=None)
def _jax_cnn_run():
    """Two JAX FedAvg rounds of the 10-class CNN: start params, end params
    and history."""
    from fedml_tpu.data.registry import load_dataset as jax_load_dataset

    task = jax_classification_task(JaxCNN(only_digits=True))
    task = task._replace(init=jax.jit(task.init))
    data = jax_load_dataset("mnist", client_num=4, samples_per_client=8,
                            test_samples=16, uint8_pixels=True)
    api = JaxFedAvgAPI(data, task, JaxConfig(**CNN_CFG))
    start = jax.tree.map(np.asarray, api.net.params)
    api.train()
    return start, jax.tree.map(np.asarray, api.net.params), api.history


@pytest.mark.parametrize("device_data", [False, True])
def test_two_cnn_rounds_match_jax(device_data):
    start, end, history = _jax_cnn_run()
    api = FedAvgAPI(_mnist(), classification_task(create_model(
        "cnn", output_dim=10, device="cpu")), FedAvgConfig(**CNN_CFG),
        device="cpu", device_data=device_data)
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


def test_engine_holds_float32_whatever_the_flags():
    """precision='f32' switches TF32 off around the fits and evals and puts
    the caller's flags back afterwards."""
    cudnn = torch.backends.cudnn
    seen = []
    task = _lr_task(4)
    inner = task.loss

    def loss(*args):
        seen.append((cudnn.allow_tf32, torch.get_float32_matmul_precision()))
        return inner(*args)

    api = FedAvgAPI(_image_data(), task._replace(loss=loss),
                    FedAvgConfig(**IMG_CFG), device="cpu")
    prev = cudnn.allow_tf32, torch.get_float32_matmul_precision()
    cudnn.allow_tf32 = True
    torch.set_float32_matmul_precision("high")
    try:
        api.run_round(0)
        assert (cudnn.allow_tf32, torch.get_float32_matmul_precision()) == (
            True, "high")
    finally:
        cudnn.allow_tf32 = prev[0]
        torch.set_float32_matmul_precision(prev[1])
    assert seen and set(seen) == {(False, "highest")}
