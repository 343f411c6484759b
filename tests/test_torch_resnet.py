"""The port's CIFAR ResNets (fedml_tpu_torch/models/resnet.py, resnet_gn.py,
norm.py) against the JAX package's flax modules on the CPU.

Weights (and BatchNorm statistics) are carried over with
fedml_tpu_torch.convert, so the comparisons are of the computation, not of
the initializers. Tolerances: logits and new batch statistics within 1e-5
absolute (measured: at most 3e-6 at these sizes); a bf16 model within
5e-2 (bf16's epsilon is 7.8e-3, and the two packages round the
convolutions' bf16 sums in different orders).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.core.tasks import classification_task as jax_task
from fedml_tpu.models import create_model as jax_create_model
from fedml_tpu.models.resnet import ResNetCIFAR as JaxResNet
from fedml_tpu.models.resnet_gn import ResNet18GN as JaxResNet18GN
from fedml_tpu_torch import convert
from fedml_tpu_torch.core.local import split_net
from fedml_tpu_torch.core.tasks import classification_task
from fedml_tpu_torch.models import create_model
from fedml_tpu_torch.models.norm import BatchNorm, GroupNorm, sync_batchnorm
from fedml_tpu_torch.models.resnet import ResNetCIFAR
from fedml_tpu_torch.models.resnet_gn import ResNet18GN

TOL = 1e-5
TOL_BF16 = 5e-2


def _n(tree) -> int:
    return sum(int(np.prod(v.shape)) for v in jax.tree.leaves(tree))


@pytest.mark.parametrize("name,classes,params,stats", [
    ("resnet56", 10, 855_770, 4_256),
    ("resnet110", 10, 1_730_714, 8_288),
    ("resnet56_wo_bn", 10, 853_723, 0),
    ("resnet_wo_bn", 10, 853_723, 0),
    ("resnet18_gn", 100, 11_220_132, 0),
    ("cnn_dropout", 62, 1_632_574, 0),
])
def test_param_and_statistic_counts_match_jax(name, classes, params, stats):
    """create_model's counts, pinned and equal to the flax module's (shapes
    from jax.eval_shape: nothing is computed)."""
    model = create_model(name, output_dim=classes, device="cpu")
    assert sum(p.numel() for p in model.parameters()) == params
    assert sum(b.numel() for b in model.buffers()) == stats
    shape = (1, 28, 28, 1) if name == "cnn_dropout" else (1, 32, 32, 3)
    var = jax.eval_shape(jax_create_model(name, output_dim=classes).init,
                         jax.random.PRNGKey(0), jnp.zeros(shape))
    assert _n(var["params"]) == params
    assert _n(var.get("batch_stats", {})) == stats


def test_resnet18_gn_imagenet_stem_count():
    """small_input=False is torchvision's resnet18 count at 1000 classes."""
    m = ResNet18GN(num_classes=1000, small_input=False)
    assert sum(p.numel() for p in m.parameters()) == 11_689_512


@pytest.fixture(scope="module")
def batch():
    rs = np.random.RandomState(0)
    x = rs.rand(4, 16, 16, 3).astype(np.float32)
    return x, rs.randint(0, 10, 4), np.array([1, 1, 1, 0], np.float32)


def _models():
    return {
        "batch": (JaxResNet(depth=8, norm_type="batch"),
                  ResNetCIFAR(8, norm_type="batch")),
        "group": (JaxResNet(depth=8, norm_type="group"),
                  ResNetCIFAR(8, norm_type="group")),
        "none": (JaxResNet(depth=8, norm_type="none"),
                 ResNetCIFAR(8, norm_type="none")),
        "resnet18_gn": (JaxResNet18GN(num_classes=10), ResNet18GN(10)),
    }


@pytest.fixture(scope="module")
def nets():
    """Per model: the JAX task, the port task, flax params (the port's
    init in flax's layout: flax's eager init of ResNet-18 is slow) and
    perturbed extras (so eval mode reads statistics that are not the
    initial ones), and the port net converted back from them."""
    rs = np.random.RandomState(1)
    out = {}
    for key, (jm, tm) in _models().items():
        jt, t = jax_task(jm), classification_task(tm)
        params, extra = convert.to_flax_net(
            t.init(torch.Generator().manual_seed(2)))
        extra = jax.tree.map(
            lambda a: a + rs.rand(*a.shape).astype(np.float32), extra)
        out[key] = (jt, t, params, extra, convert.from_flax(params, extra))
    return out


@pytest.mark.parametrize("kind", ["batch", "group", "none", "resnet18_gn"])
def test_eval_forward_matches_flax(nets, batch, kind):
    """Eval mode (running statistics) on converted weights."""
    jt, t, params, extra, net = nets[kind]
    want = np.asarray(jax.jit(jt.predict)(params, extra, batch[0]))
    got = t.predict(net, torch.from_numpy(batch[0])).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


@pytest.mark.parametrize("kind", ["batch", "group", "none", "resnet18_gn"])
def test_train_forward_and_new_statistics_match_flax(nets, batch, kind):
    """Train mode: the loss, the metrics and the new batch_stats (flax's
    momentum 0.9 over the biased batch variance, padded row included)."""
    jt, t, params, extra, net = nets[kind]
    x, y, mask = batch
    jl, jextra, jm = jax.jit(jt.loss, static_argnums=6)(
        params, extra, x, y, mask, jax.random.PRNGKey(0), True)
    p, e = split_net(net, t.extra_keys)
    loss, new, m = t.loss(p, e, torch.from_numpy(x), torch.from_numpy(y),
                          torch.from_numpy(mask), None, True)
    np.testing.assert_allclose(float(loss), float(jl), rtol=0, atol=TOL)
    for k in ("loss_sum", "correct", "count"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), atol=TOL)
    assert set(new) == set(t.extra_keys)
    want = convert.from_flax(params, jax.tree.map(np.asarray, jextra))
    for k in t.extra_keys:
        np.testing.assert_allclose(new[k].numpy(), want[k].numpy(), rtol=0,
                                   atol=TOL, err_msg=k)
    if kind == "batch":
        assert not torch.equal(new["norm.var"], e["norm.var"])


@pytest.mark.parametrize("kind", ["batch", "group", "none", "resnet18_gn"])
def test_conversion_round_trips_bitwise(nets, kind):
    """from_flax / to_flax_net: every params and batch_stats leaf back to
    its flax layout bit for bit; the port's names are the module's own."""
    jt, t, params, extra, net = nets[kind]
    assert set(net) == set(t.module.state_dict())
    flax_vars = jax.eval_shape(jt.init, jax.random.PRNGKey(0),
                               jnp.zeros((1, 16, 16, 3)))
    assert jax.tree.structure(flax_vars.params) == \
        jax.tree.structure(params)
    assert jax.tree.structure(flax_vars.extra) == jax.tree.structure(extra)
    back_p, back_e = convert.to_flax_net(net)
    assert jax.tree.structure(back_p) == jax.tree.structure(params)
    assert jax.tree.structure(back_e) == jax.tree.structure(extra)
    for a, b in zip(jax.tree.leaves((back_p, back_e)),
                    jax.tree.leaves((params, extra))):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert set(t.extra_keys) == ({k for k in net if k.endswith(
        (".mean", ".var"))} if kind == "batch" else set())


def test_stride_two_convolutions_pad_like_flax():
    """A stride-2 3x3 'SAME' convolution on an even input pads at the end
    only: the port's first downsampling block would otherwise read a
    window shifted by one pixel, which the logits above would not all
    catch at depth 8 with random weights."""
    from fedml_tpu_torch.models.resnet import Conv, same_padding

    assert same_padding(16, 3, 2) == (0, 1)
    assert same_padding(15, 3, 2) == (1, 1)
    assert same_padding(32, 1, 2) == (0, 0)
    assert same_padding(224, 7, 2) == (2, 3)
    conv = Conv(1, 1, 3, 2)
    with torch.no_grad():
        conv.weight.zero_()
        conv.weight[0, 0, 0, 0] = 1.0  # picks the window's top-left pixel
    x = torch.arange(16.0).reshape(1, 1, 4, 4)
    assert torch.equal(conv(x)[0, 0], x[0, 0, ::2, ::2])


@pytest.mark.parametrize("norm", ["batch", "group", "none"])
def test_bf16_resnet_keeps_f32_params_and_matches_flax(norm):
    """dtype=bfloat16: params and norm statistics stay float32, the logits
    come back float32, and they match the flax bf16 module within
    TOL_BF16 (tests/test_models.py's bf16 ResNet test)."""
    x = np.random.RandomState(3).rand(2, 16, 16, 3).astype(np.float32)
    jm = JaxResNet(depth=8, norm_type=norm, dtype=jnp.bfloat16)
    task = classification_task(ResNetCIFAR(8, norm_type=norm,
                                           dtype=torch.bfloat16))
    net = task.init(torch.Generator().manual_seed(0))
    assert all(t.dtype == torch.float32 for t in net.values())
    got = task.predict(net, torch.from_numpy(x))
    assert got.dtype == torch.float32
    params, extra = convert.to_flax_net(net)
    want = np.asarray(jax.jit(jm.apply, static_argnames="train")(
        {"params": params, **extra}, x, train=False))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL_BF16)


def test_norm_layers_follow_flax_conventions():
    """BatchNorm: running statistics returned (never written in place),
    momentum 0.9 on the biased variance; GroupNorm: eps 1e-6."""
    bn = BatchNorm(3)
    bn.stat_name = "bn."
    x = torch.randn(5, 3, 4, 4)
    stats: dict = {}
    bn(x, True, stats)
    assert torch.equal(bn.mean, torch.zeros(3))  # no in-place update
    var = x.var((0, 2, 3), unbiased=False)
    torch.testing.assert_close(stats["bn.var"], 0.9 + 0.1 * var,
                               rtol=0, atol=1e-6)
    assert GroupNorm(2, 4).eps == 1e-6
    with pytest.raises(NotImplementedError, match="item 12"):
        sync_batchnorm("clients")


@pytest.mark.parametrize("name", ["resnet56", "resnet110", "resnet56_wo_bn",
                                  "resnet18_gn", "cnn_dropout"])
def test_create_model_builds_on_the_requested_device(name):
    """Each new name builds on the CPU when asked for it; with no CUDA and
    no request it raises (there is no silent CPU path)."""
    model = create_model(name, output_dim=10, device="cpu")
    assert all(p.device.type == "cpu" for p in model.parameters())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            create_model(name, output_dim=10)
