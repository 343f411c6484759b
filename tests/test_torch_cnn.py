"""The port's main-path models against the JAX package's: CNNOriginalFedAvg
and LogisticRegression from converted flax weights give the flax logits,
classification_task gives the same masked metrics, and the weight
conversion round-trips bitwise. Inputs are made from a numpy seed."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from fedml_tpu.core.tasks import classification_task as jax_classification_task
from fedml_tpu.models.cnn import CNNOriginalFedAvg as JaxCNN
from fedml_tpu.models.linear import LogisticRegression as JaxLR
from fedml_tpu_torch import convert
from fedml_tpu_torch.core.tasks import classification_task
from fedml_tpu_torch.models import create_model

# float32 on the CPU on both sides; logits differ by summation order in the
# convolutions and the 3136-wide dense layer (observed ~1e-7)
TOL = 1e-5


@functools.lru_cache(maxsize=None)
def _jax_net(model: str, classes: int):
    module = JaxCNN(only_digits=classes == 10) if model == "cnn" \
        else JaxLR(num_classes=classes)
    task = jax_classification_task(module)
    init = jax.jit(task.init)  # one compile beats flax's op-by-op init
    net = init(jax.random.PRNGKey(3), jnp.zeros((1, 28, 28, 1), jnp.uint8))
    return task, jax.tree.map(np.asarray, net.params)


def _port_task(model, classes, params=None):
    task = classification_task(create_model(model, output_dim=classes,
                                            device="cpu"))
    net = task.init(torch.Generator().manual_seed(0),
                    np.zeros((1, 28, 28, 1), np.uint8))
    if params is not None:
        net = convert.from_flax(params)
    return task, net


def _images(uint8: bool, n=6, seed=0):
    rs = np.random.RandomState(seed)
    if uint8:
        return rs.randint(0, 256, size=(n, 28, 28, 1)).astype(np.uint8)
    return rs.randn(n, 28, 28, 1).astype(np.float32)


def _count(params) -> int:
    return sum(int(np.prod(np.shape(v))) for v in jax.tree.leaves(params))


@pytest.mark.parametrize("model,classes,want", [
    ("cnn", 10, 1_663_370), ("cnn", 62, 1_690_046), ("lr", 10, 7_850)])
def test_param_counts_match_flax(model, classes, want):
    """The counts pinned by tests/test_param_parity.py (LR: 784 x 10 + 10)."""
    _, net = _port_task(model, classes)
    assert sum(v.numel() for v in net.values()) == want
    assert _count(_jax_net(model, classes)[1]) == want


@pytest.mark.parametrize("model,classes", [("cnn", 62), ("cnn", 10),
                                           ("lr", 62)])
@pytest.mark.parametrize("uint8", [True, False])
def test_logits_match_flax(model, classes, uint8):
    jtask, params = _jax_net(model, classes)
    task, net = _port_task(model, classes, params)
    x = _images(uint8)
    want = np.asarray(jtask.predict(params, {}, x))
    got = task.predict(net, torch.from_numpy(x)).detach().numpy()
    assert got.shape == want.shape == (len(x), classes)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_dense_layer_needs_the_flatten_permutation():
    """A plain transpose of flax's first dense kernel keeps the parameter
    count and gives other logits: the NHWC -> NCHW row permutation in
    convert is what makes the CNN flax's."""
    jtask, params = _jax_net("cnn", 62)
    task, net = _port_task("cnn", 62, params)
    naive = dict(net, **{"fc1.weight": torch.from_numpy(
        np.ascontiguousarray(params["Dense_0"]["kernel"].T))})
    assert naive["fc1.weight"].shape == net["fc1.weight"].shape
    x = torch.from_numpy(_images(True))
    want = np.asarray(jtask.predict(params, {}, x.numpy()))
    good = task.predict(net, x).detach().numpy()
    bad = task.predict(naive, x).detach().numpy()
    assert np.abs(good - want).max() < TOL < 1e-2 < np.abs(bad - want).max()


@pytest.mark.parametrize("model", ["cnn", "lr"])
def test_convert_round_trip_is_bitwise(model):
    _, params = _jax_net(model, 62)
    back = convert.to_flax(convert.from_flax(params))
    assert jax.tree.structure(back) == jax.tree.structure(params)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("uint8", [True, False])
def test_classification_task_metrics_match_jax(uint8):
    """loss (sum(per_ex * mask) / max(sum(mask), 1)) and the eval sums with
    a partial mask and with an all-masked batch."""
    jtask, params = _jax_net("cnn", 10)
    task, net = _port_task("cnn", 10, params)
    x = _images(uint8, n=8, seed=1)
    y = np.random.RandomState(2).randint(0, 10, size=8)
    for mask in (np.array([1, 1, 0, 1, 0, 1, 1, 0], np.float32),
                 np.zeros(8, np.float32)):
        jl, _, jm = jtask.loss(params, {}, x, y, mask, None, False)
        je = jtask.eval_batch(params, {}, x, y, mask)
        args = (torch.from_numpy(x), torch.from_numpy(y),
                torch.from_numpy(mask))
        loss, m = task.loss(net, *args, True)
        e = task.eval_batch(net, *args)
        np.testing.assert_allclose(float(loss), float(jl), rtol=TOL, atol=TOL)
        for k in ("loss_sum", "correct", "count"):
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=TOL,
                                       atol=TOL, err_msg=k)
            np.testing.assert_allclose(float(e[k]), float(je[k]), rtol=TOL,
                                       atol=TOL, err_msg=k)


def test_cnn_takes_nhw_and_nhwc_alike():
    task, net = _port_task("cnn", 62)
    x = torch.from_numpy(_images(True))
    assert torch.equal(task.predict(net, x), task.predict(net, x[..., 0]))


@pytest.mark.parametrize("cin,cout,hw", [(1, 32, 28), (32, 64, 14)])
def test_cohort_conv_gradients_match_float64(cin, cout, hw):
    """The CNN's convolution as the batched fit runs it (vmap of grad over
    each client's own weights, so a grouped convolution) gives F.conv2d's
    output and gradients: exactly in float64, and in float32 within float32
    rounding of the float64 ones."""
    from torch.func import grad, vmap

    from fedml_tpu_torch.models.cnn import conv2d

    rs = np.random.RandomState(cin)
    K, bs = 3, 4
    x, w, b, go = (torch.from_numpy(rs.randn(*s)) for s in (
        (K, bs, cin, hw, hw), (K, cout, cin, 5, 5), (K, cout),
        (K, bs, cout, hw, hw)))

    def grads(conv, dtype):
        def loss(x, w, b, go):
            return (conv(x, w, b) * go).sum()
        args = (t.to(dtype) for t in (x, w, b, go))
        return vmap(grad(loss, argnums=(0, 1, 2)))(*args)

    ref = grads(lambda x, w, b: F.conv2d(x, w, b, padding=2), torch.float64)
    got = grads(lambda x, w, b: conv2d(x, w, b, 2), torch.float64)
    for a, r in zip(got, ref):
        torch.testing.assert_close(a, r, rtol=1e-12, atol=1e-12)
    got = grads(lambda x, w, b: conv2d(x, w, b, 2), torch.float32)
    for a, r in zip(got, ref):
        assert float((a.double() - r).norm() / r.norm()) < 1e-5
