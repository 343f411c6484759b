"""Model state (extras: BatchNorm statistics) and remat in the port's fit,
engine, wire, checkpoints and flat server, against the JAX package on the
CPU with a depth-8 ResNetCIFAR on 16x16x3 images, 4 clients, batch 8.

Tolerances: a round's params and extras within 1e-5 absolute of the JAX
package's ``FedAvgAPI`` (measured: 2.4e-7); the port's own contracts
(padded batch, remat, device plane) bitwise; the loopback round within
1e-5 of the engine's (the engine vmaps the cohort, a trainer fits one
client: the convolutions sum in another order).
"""

from __future__ import annotations

import dataclasses
import sys

import jax
import numpy as np
import pytest
import torch

from fedml_tpu.algorithms.fedavg import FedAvgAPI as JaxFedAvgAPI
from fedml_tpu.algorithms.fedavg import FedAvgConfig as JaxConfig
from fedml_tpu.comm.message import pack_pytree as jax_pack
from fedml_tpu.core.local import NetState
from fedml_tpu.core.tasks import classification_task as jax_task
from fedml_tpu.data.synthetic import synthetic_images as jax_images
from fedml_tpu.models.resnet import ResNetCIFAR as JaxResNet
from fedml_tpu_torch import convert
from fedml_tpu_torch.algorithms import FedAvgAPI, FedAvgConfig
from fedml_tpu_torch.comm.message import (
    check_wire_leaves,
    pack_pytree,
    unpack_pytree,
)
from fedml_tpu_torch.core import optim
from fedml_tpu_torch.core.local import LocalSpec, make_local_update, split_net
from fedml_tpu_torch.core.tasks import classification_task, sequence_task
from fedml_tpu_torch.data.synthetic import synthetic_images
from fedml_tpu_torch.models.resnet import ResNetCIFAR
from fedml_tpu_torch.utils.tree import tree_unvectorize, tree_vectorize

TOL = 1e-5
DATA = dict(num_clients=4, image_shape=(16, 16, 3), num_classes=4,
            samples_per_client=24, test_samples=32, seed=0,
            size_lognormal=False)
CFG = dict(comm_round=2, client_num_in_total=4, client_num_per_round=4,
           epochs=1, batch_size=8, lr=0.05, frequency_of_the_test=1)


def _task():
    return classification_task(ResNetCIFAR(8, num_classes=4))


def _from_jax(net) -> dict:
    return convert.from_flax(jax.tree.map(np.asarray, net.params),
                             jax.tree.map(np.asarray, net.extra))


@pytest.fixture(scope="module")
def jax_rounds():
    """The JAX package's engine: its initial net and its net after each of
    two rounds (one JAX compile)."""
    api = JaxFedAvgAPI(jax_images(**DATA), jax_task(JaxResNet(
        depth=8, num_classes=4)), JaxConfig(**CFG))
    nets = [_from_jax(api.net)]
    for r in range(2):
        api.run_round(r)
        nets.append(_from_jax(api.net))
    return nets


def _engine(jax_rounds, task=None, **kw) -> FedAvgAPI:
    api = FedAvgAPI(synthetic_images(**DATA), task or _task(),
                    FedAvgConfig(**{**CFG, **kw.pop("cfg", {})}),
                    device="cpu", **kw)
    api.load_state(jax_rounds[0])
    return api


def _gap(a: dict, b: dict, keys=None) -> float:
    return max(float((a[k] - b[k]).abs().max()) for k in (keys or a))


def test_two_rounds_match_jax_params_and_statistics(jax_rounds):
    """Two engine rounds against fedml_tpu's FedAvgAPI from the same net:
    params and BatchNorm statistics (tests/test_models.py's BN round)."""
    api = _engine(jax_rounds)
    stats = api.task.extra_keys
    assert len(stats) == 2 * 9  # 9 BatchNorms at depth 8
    for r in range(2):
        api.run_round(r)
        assert _gap(api.net, jax_rounds[r + 1]) <= TOL
        assert _gap(api.net, jax_rounds[r + 1], stats) <= TOL
    assert not torch.equal(api.net["norm.var"], jax_rounds[0]["norm.var"])


def test_eval_reads_running_statistics(jax_rounds):
    """Eval mode normalizes with the averaged running statistics: moving
    them moves the eval loss; the train-mode loss does not read them."""
    api = _engine(jax_rounds)
    before = api.evaluate()["loss"]
    api.net = {**api.net, "norm.mean": api.net["norm.mean"] + 1.0}
    assert api.evaluate()["loss"] != before


def _fit_inputs(B=2, masked_batch=None):
    rs = np.random.RandomState(4)
    x = torch.from_numpy(rs.rand(2, B, 8, 16, 16, 3).astype(np.float32))
    y = torch.from_numpy(rs.randint(0, 4, (2, B, 8)))
    mask = torch.ones(2, B, 8)
    if masked_batch is not None:
        mask[:, masked_batch] = 0.0
    return x, y, mask


def test_padded_batch_keeps_extras_params_and_state(jax_rounds):
    """An all-masked batch is a no-op for params, optimizer state AND
    extras (local.py:194-200): a fit with a trailing padded batch is
    bitwise the fit without it, momentum and all."""
    task = _task()
    fit = make_local_update(task, LocalSpec(
        optimizer=optim.sgd(0.05, momentum=0.9, wd=1e-3)))
    x, y, mask = _fit_inputs(B=2, masked_batch=1)
    a, _ = fit(jax_rounds[0], x, y, mask)
    b, _ = fit(jax_rounds[0], x[:, :1], y[:, :1], mask[:, :1])
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["norm.mean"][0], jax_rounds[0]["norm.mean"])


def test_optimizer_and_weight_decay_see_params_only(jax_rounds):
    """Weight decay and the optimizer never touch the running statistics:
    they come out of the fit as the BatchNorm momentum update, equal with
    and without decay."""
    task = _task()
    x, y, mask = _fit_inputs(B=1)
    nets = [make_local_update(task, LocalSpec(optimizer=optim.sgd(
        0.05, wd=wd)))(jax_rounds[0], x, y, mask)[0] for wd in (0.0, 0.5)]
    for k in task.extra_keys:
        assert torch.equal(nets[0][k], nets[1][k]), k
    assert not torch.equal(nets[0]["fc.weight"], nets[1]["fc.weight"])


def test_remat_is_bitwise_and_recomputes_the_forward(jax_rounds):
    """remat=True runs the batch's forward again in the backward (twice
    the module calls) and gives the same bits as remat=False."""
    task = _task()
    api = _engine(jax_rounds, task, cfg=dict(remat=True))
    plain = _engine(jax_rounds, task)
    assert api.local_spec.remat and not plain.local_spec.remat
    calls = []
    hook = task.module.register_forward_hook(
        lambda *a: calls.append(1))
    try:
        api.run_round(0)
        n_remat = len(calls)
        calls.clear()
        plain.run_round(0)
        n_plain = len(calls)
    finally:
        hook.remove()
    assert n_remat == 2 * n_plain
    assert all(torch.equal(api.net[k], plain.net[k]) for k in api.net)


def test_bf16_group_norm_resnet_with_remat_trains():
    """precision='bf16' with remat on a bf16 GroupNorm ResNet
    (tests/test_models.py's bf16 ResNet round): finite, f32 params."""
    data = synthetic_images(**DATA)
    api = FedAvgAPI(data, classification_task(ResNetCIFAR(
        8, 4, norm_type="group", dtype=torch.bfloat16)), FedAvgConfig(
        **{**CFG, "remat": True, "precision": "bf16",
           "client_num_per_round": 2}), device="cpu")
    m = api.run_round(0)
    assert np.isfinite(float(m["loss_sum"]))
    assert all(v.dtype == torch.float32 and torch.isfinite(v).all()
               for v in api.net.values())


def test_device_plane_matches_host_plane_with_batch_stats():
    """BatchNorm sees padded rows whatever the loss mask says, so the
    device plane's zeroed padding must equal the host packer's: ragged
    uint8 clients, params and extras bitwise (tests/test_fedavg.py's
    batch-stats case)."""
    data = synthetic_images(num_clients=6, image_shape=(16, 16, 3),
                            num_classes=4, samples_per_client=12,
                            test_samples=16, seed=5, as_uint8=True)
    cfg = FedAvgConfig(**{**CFG, "client_num_in_total": 6,
                          "client_num_per_round": 3,
                          "frequency_of_the_test": 9})
    task = _task()
    host = FedAvgAPI(data, task, cfg, device="cpu")
    dev = FedAvgAPI(data, task, cfg, device="cpu", device_data=True)
    host.train()
    dev.train()
    assert all(torch.equal(host.net[k], dev.net[k]) for k in host.net)


@pytest.fixture(scope="module")
def resnet56():
    """A ResNet-56 NetState of the JAX package with non-trivial
    statistics, and the port's net of it."""
    x = np.zeros((1, 32, 32, 3), np.float32)
    v = jax_task(JaxResNet(depth=56)).init(jax.random.PRNGKey(0), x)
    rs = np.random.RandomState(0)
    net = jax.tree.map(lambda a: np.asarray(a) + rs.rand(
        *np.shape(a)).astype(np.float32), NetState(v.params, v.extra))
    return net, convert.from_flax(net.params, net.extra)


def test_resnet56_wire_leaves_are_the_jax_packages(resnet56):
    """pack_pytree gives jax.tree.leaves(NetState): 287 leaves, every
    params leaf (855,770 values) then every statistic (4,256), bitwise;
    unpack, the wire spec and tree_vectorize follow the same order."""
    jnet, net = resnet56
    want, got = jax_pack(jnet), pack_pytree(net)
    assert len(got) == len(want) == 287
    assert all(a.dtype == b.dtype and np.array_equal(a, b)
               for a, b in zip(got, want))
    n_params = len(jax.tree.leaves(jnet.params))
    assert sum(a.size for a in got[:n_params]) == 855_770
    assert sum(a.size for a in got[n_params:]) == 4_256
    spec = check_wire_leaves(net, want)
    assert spec[n_params][0][0] == "batch_stats"
    assert [p[0] for p, _, _ in spec[:n_params]][:3] == [
        "BasicBlock_0", "BasicBlock_0", "BasicBlock_0"]
    back = unpack_pytree(net, want)
    assert all(torch.equal(back[k], net[k]) for k in net)
    vec = tree_vectorize(net)
    assert np.array_equal(vec.numpy(),
                          np.concatenate([a.ravel() for a in want]))
    assert all(torch.equal(tree_unvectorize(vec, net)[k], net[k])
               for k in net)


def test_checkpoints_cross_packages_with_statistics(resnet56, tmp_path,
                                                    monkeypatch):
    """An npz round checkpoint of the JAX package restores into the port
    with its statistics, and the port's restores into the JAX package."""
    monkeypatch.setitem(sys.modules, "orbax", None)  # the npz layout
    from fedml_tpu.core import checkpoint as jax_ckpt
    from fedml_tpu_torch.core import checkpoint as port_ckpt

    jnet, net = resnet56
    rng = np.array([3, 4], np.uint32)
    jax_ckpt.save_round(str(tmp_path / "j"), 2, jnet, (), rng)
    tmpl = {"net": {k: torch.zeros_like(v) for k, v in net.items()},
            "server_opt_state": (), "rng": np.zeros(2, np.uint32),
            "round": np.asarray(0, np.int64)}
    r, st = port_ckpt.restore_latest(str(tmp_path / "j"), tmpl)
    assert r == 2 and all(torch.equal(st["net"][k], net[k]) for k in net)
    port_ckpt.save_round(str(tmp_path / "p"), 5, net, (), rng)
    jtmpl = {"net": jax.tree.map(np.zeros_like, jnet),
             "server_opt_state": (), "rng": np.zeros(2, np.uint32),
             "round": np.asarray(0, np.int64)}
    r, jst = jax_ckpt.restore_latest(str(tmp_path / "p"), jtmpl)
    assert r == 5
    for a, b in zip(jax.tree.leaves(jst["net"]), jax.tree.leaves(jnet)):
        assert np.array_equal(np.asarray(a), b)


def test_loopback_round_matches_engine_round():
    """1 server + 4 client threads over loopback: the aggregate (params
    and extras, which rode the frames after the params) against the
    engine's round from the same init."""
    from fedml_tpu_torch.distributed.fedavg import run_simulated

    data = synthetic_images(**DATA)
    cfg = FedAvgConfig(**{**CFG, "comm_round": 1})
    agg = run_simulated(data, _task(), cfg, device="cpu")
    api = FedAvgAPI(data, _task(), cfg, device="cpu")
    api.run_round(0)
    assert _gap(agg.net, api.net) <= TOL
    assert _gap(agg.net, api.net, api.task.extra_keys) <= TOL
    assert not torch.equal(agg.net["norm.var"], torch.ones(16))


class _SeqMesh(dict):
    """The two axes FedAvgSeqAPI reads before it builds the task."""

    axis_names = ("clients", "seq")
    shape = {"clients": 1, "seq": 1}


def _keyed_lm(seq_axis):
    from fedml_tpu_torch.models.transformer import TransformerLM

    lm = TransformerLM(vocab_size=16, dim=8, depth=1, num_heads=2,
                       max_len=8, seq_axis=seq_axis)
    lm.needs_key = True  # a sequence model that would draw dropout masks
    return lm


def _refusals():
    from fedml_tpu_torch.algorithms.fedavg_seq import FedAvgSeqAPI
    from fedml_tpu_torch.data.synthetic import synthetic_sequences

    cfg = FedAvgConfig(**{**CFG, "comm_round": 1})
    return {
        "seq_task": lambda: sequence_task(_task().module, seq_axis=object()),
        "seq_engine": lambda: FedAvgSeqAPI(
            synthetic_sequences(num_clients=4, seq_len=8, vocab_size=16,
                                samples_per_client=4, test_samples=4),
            _keyed_lm, cfg, _SeqMesh(clients=None, seq=None),
            device="cpu"),
    }


@pytest.mark.parametrize("name", sorted(_refusals()))
def test_engines_without_extras_refuse_a_stateful_model(name):
    """The sequence-parallel path, the one that does not carry extras or
    keys yet, raises naming ROADMAP item 4 when given a model with
    extras (or one that draws randomness): never a silent drop. Every
    other engine and server carries them (test_torch_extras_engines.py,
    _wire.py and _secure.py)."""
    with pytest.raises(NotImplementedError, match="queue A, item 4"):
        _refusals()[name]()


def test_stateless_models_keep_their_net_layout():
    """A model with no buffers has no extras: its net is its params, its
    wire layout unchanged (the TransformerLM and the CNN)."""
    from fedml_tpu_torch.models import create_model

    task = classification_task(create_model("cnn", 62, device="cpu"))
    assert task.extra_keys == () and not task.needs_key
    net = task.init(torch.Generator().manual_seed(0), None)
    assert split_net(net, task.extra_keys) == (net, {})
    assert len(pack_pytree(net)) == 8
    assert dataclasses.replace(LocalSpec(optimizer=optim.sgd(0.1))).remat \
        is False
