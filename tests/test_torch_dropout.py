"""CNNDropOut and the fit's randomness in the port against the JAX package
on the CPU: the key chain (utils/prng), flax's dropout masks, the model,
and FedAvg rounds through the engine and the loopback runtime.

The masks are bitwise flax's (the same Threefry bits, the same fold of
the scope path, drawn in flax's NHWC order); the model and the rounds
within 1e-5 absolute (measured: 3.0e-7 for two rounds of two epochs).
"""

from __future__ import annotations

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.algorithms.fedavg import FedAvgAPI as JaxFedAvgAPI
from fedml_tpu.algorithms.fedavg import FedAvgConfig as JaxConfig
from fedml_tpu.algorithms.fedavg import _make_client_keys
from fedml_tpu.core.tasks import classification_task as jax_task
from fedml_tpu.data.synthetic import synthetic_images as jax_images
from fedml_tpu.models.cnn import CNNDropOut as JaxCNNDropOut
from fedml_tpu_torch import convert
from fedml_tpu_torch.algorithms import FedAvgAPI, FedAvgConfig
from fedml_tpu_torch.core.tasks import classification_task
from fedml_tpu_torch.data.synthetic import synthetic_images
from fedml_tpu_torch.models.cnn import CNNDropOut, flax_dropout
from fedml_tpu_torch.utils import prng

TOL = 1e-5
DATA = dict(num_clients=6, image_shape=(28, 28, 1), num_classes=10,
            samples_per_client=20, test_samples=32, seed=1)
CFG = dict(comm_round=2, client_num_in_total=6, client_num_per_round=3,
           epochs=2, batch_size=8, lr=0.05, frequency_of_the_test=1)


def _words(k) -> torch.Tensor:
    return torch.from_numpy(np.asarray(k, np.uint32).astype(np.int64))


def test_client_and_batch_keys_are_the_jax_chain():
    """fold_in(fold_in(key(seed), round), client), then one split per
    epoch and one per batch: the JAX engine's _make_client_keys and its
    nested lax.scan splits, bitwise."""
    ids = np.array([5, 0, 3])
    keys = prng.client_keys(7, 4, ids)
    want = np.asarray(_make_client_keys(7)(4, jnp.asarray(ids)))
    assert np.array_equal(keys, want)
    got = prng.fit_keys(keys, 2, 3)
    for i in range(3):
        rng = jnp.asarray(want[i])
        for e in range(2):
            rng, carry = jax.random.split(rng)
            for b in range(3):
                carry, sub = jax.random.split(carry)
                assert np.array_equal(got[e, b, i], np.asarray(sub))


class _TwoDropouts(nn.Module):
    """Dropout_0 on an NHWC block, Dropout_1 on a vector: flax's scopes
    and call counts as CNNDropOut draws them."""

    @nn.compact
    def __call__(self, x, v):
        return (nn.Dropout(0.25, deterministic=False)(x),
                nn.Dropout(0.5, deterministic=False)(v))


def test_dropout_masks_are_flax_bitwise_under_vmap():
    """Three clients' masks in one vmapped draw equal flax's per client:
    the NHWC mask transposed onto the channels-first activation."""
    rs = np.random.RandomState(0)
    x = rs.rand(3, 2, 6, 6, 4).astype(np.float32) + 1.0  # no zeros
    v = rs.rand(3, 2, 9).astype(np.float32) + 1.0
    keys = prng.split(prng.key(11), 3)
    got_x, got_v = torch.func.vmap(lambda xc, vc, k: (
        flax_dropout(xc, 0.25, k, "Dropout_0", nhwc=True),
        flax_dropout(vc, 0.5, k, "Dropout_1")))(
        torch.from_numpy(x).permute(0, 1, 4, 2, 3), torch.from_numpy(v),
        _words(keys))
    for i in range(3):
        wx, wv = _TwoDropouts().apply({}, x[i], v[i],
                                      rngs={"dropout": jnp.asarray(keys[i])})
        assert np.array_equal(got_x[i].permute(0, 2, 3, 1).numpy(),
                              np.asarray(wx))
        assert np.array_equal(got_v[i].numpy(), np.asarray(wv))
    assert (got_x == 0).any() and (got_x != 0).any()


@pytest.fixture(scope="module")
def model():
    """The JAX task, the port task, and flax params with the port net of
    them."""
    x = np.zeros((1, 28, 28, 1), np.float32)
    jt = jax_task(JaxCNNDropOut(only_digits=False))
    params = jax.tree.map(np.asarray, jt.init(jax.random.PRNGKey(1),
                                              x).params)
    return jt, classification_task(CNNDropOut(only_digits=False)), params


def test_train_loss_and_gradient_match_flax(model):
    """One batch in train mode under a batch key: the loss and every
    gradient within TOL (a mask off by one element moves the gradient
    far more)."""
    jt, task, params = model
    rs = np.random.RandomState(2)
    x = rs.rand(4, 28, 28, 1).astype(np.float32)
    y, mask = rs.randint(0, 62, 4), np.array([1, 1, 1, 0], np.float32)
    k = jax.random.PRNGKey(5)
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p: jt.loss(p, {}, x, y, mask, k, True)[0]))(params)
    net = convert.from_flax(params)
    args = (torch.from_numpy(x), torch.from_numpy(y),
            torch.from_numpy(mask), _words(k), True)
    loss = task.loss(net, {}, *args)[0]
    g = torch.func.grad(lambda p: task.loss(p, {}, *args)[0])(net)
    np.testing.assert_allclose(float(loss), float(jl), rtol=0, atol=TOL)
    want = convert.from_flax(jax.tree.map(np.asarray, jg))
    for name, t in g.items():
        np.testing.assert_allclose(t.numpy(), want[name].numpy(), rtol=0,
                                   atol=TOL, err_msg=name)
    assert task.needs_key and task.extra_keys == ()


def test_eval_is_deterministic_and_train_draws(model):
    """Eval draws nothing (equal to flax's eval logits, and to itself);
    train mode refuses to run without a key and draws per key."""
    jt, task, params = model
    x = np.random.RandomState(3).rand(2, 28, 28, 1).astype(np.float32)
    net = convert.from_flax(params)
    a = task.predict(net, torch.from_numpy(x))
    assert torch.equal(a, task.predict(net, torch.from_numpy(x)))
    np.testing.assert_allclose(a.numpy(), np.asarray(jt.predict(
        params, {}, x)), rtol=0, atol=TOL)
    with pytest.raises(ValueError, match="key"):
        task.module(torch.from_numpy(x), train=True)
    outs = [task.module(torch.from_numpy(x), True, _words(prng.key(s)))
            for s in (0, 1)]
    assert not torch.equal(outs[0], outs[1])


def test_conversion_dispatches_on_structure(model):
    """CNNDropOut shares CNNOriginalFedAvg's four leaf names; its first
    dense layer's 14x14x64 NHWC rows convert by the shapes, bitwise both
    ways."""
    _, _, params = model
    net = convert.from_flax(params)
    assert net["fc1.weight"].shape == (128, 14 * 14 * 64)
    back = convert.to_flax(net)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        assert np.array_equal(a, b)


@pytest.fixture(scope="module")
def jax_rounds():
    api = JaxFedAvgAPI(jax_images(**DATA), jax_task(JaxCNNDropOut()),
                       JaxConfig(**CFG))
    nets = [convert.from_flax(jax.tree.map(np.asarray, api.net.params))]
    for r in range(2):
        api.run_round(r)
        nets.append(convert.from_flax(jax.tree.map(np.asarray,
                                                   api.net.params)))
    return nets


def test_two_rounds_match_jax(jax_rounds):
    """Two rounds of two epochs through the engine against the JAX
    package's FedAvgAPI: the per-client keys, epoch and batch splits and
    masks line up."""
    api = FedAvgAPI(synthetic_images(**DATA), classification_task(
        CNNDropOut()), FedAvgConfig(**CFG), device="cpu")
    api.load_state(jax_rounds[0])
    for r in range(2):
        api.run_round(r)
        for k, v in jax_rounds[r + 1].items():
            np.testing.assert_allclose(api.net[k].numpy(), v.numpy(),
                                       rtol=0, atol=TOL, err_msg=k)


def test_loopback_trainers_key_as_the_engine():
    """Each DistributedTrainer keys its client's fit as the engine keys
    that client: the loopback round equals the engine's round."""
    from fedml_tpu_torch.distributed.fedavg import run_simulated

    data = synthetic_images(**DATA)
    cfg = FedAvgConfig(**{**CFG, "comm_round": 1})
    task = classification_task(CNNDropOut())
    agg = run_simulated(data, task, cfg, device="cpu")
    api = FedAvgAPI(data, task, cfg, device="cpu")
    api.run_round(0)
    for k in api.net:
        np.testing.assert_allclose(agg.net[k].numpy(), api.net[k].numpy(),
                                   rtol=0, atol=TOL, err_msg=k)
