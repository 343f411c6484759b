"""A model's extras (BatchNorm statistics) and per-client keys (dropout)
through the port's robust, adversarial, hooked, DP and async engines,
against the JAX package on the CPU: tests/test_robust_agg.py's BatchNorm
configuration (ResNet depth 8 on 8x8x3 images, 4 clients, batch 6, two
rounds) and CNNDropOut on 28x28x1 images for the keyed model.

The JAX package treats ``NetState(params, extra)`` as one tree: the
adversary perturbs both, the gate's norms and the estimators cover both,
the clip and the DP noise act on the params and pass the extras through,
the async runner stacks and folds both. Every test below starts both
packages from the JAX package's initial net.

Tolerances: port against JAX 1e-5 absolute on params and extras, leaf by
leaf (both fit in float32 on the CPU, one summation order apart);
quarantine ledgers equal; the port's own contracts (extras passed through
a clip, untouched by the noise, the async runner at K = cohort and bound
0 against sync rounds) bitwise; the fit keys bitwise the JAX chains.
Shared helpers serve test_torch_extras_wire.py and
test_torch_extras_secure.py.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.algorithms.fedavg import FedAvgAPI as JaxFedAvgAPI
from fedml_tpu.algorithms.fedavg import FedAvgConfig as JaxConfig
from fedml_tpu.algorithms.fedavg_robust import FedAvgRobustAPI as JaxRobustAPI
from fedml_tpu.chaos import AdversaryPlan as JaxAdversaryPlan
from fedml_tpu.chaos import FaultPlan as JaxFaultPlan
from fedml_tpu.core import robust as jax_robust
from fedml_tpu.core import robust_agg as jax_agg
from fedml_tpu.core.local import NetState
from fedml_tpu.core.tasks import classification_task as jax_task
from fedml_tpu.data.synthetic import synthetic_images as jax_images
from fedml_tpu.distributed.fedavg import run_simulated as jax_run_simulated
from fedml_tpu.models.cnn import CNNDropOut as JaxCNNDropOut
from fedml_tpu.models.resnet import ResNetCIFAR as JaxResNet
from fedml_tpu_torch import convert
from fedml_tpu_torch.algorithms import FedAvgAPI, FedAvgConfig
from fedml_tpu_torch.algorithms.fedavg_robust import FedAvgRobustAPI
from fedml_tpu_torch.chaos import AdversaryPlan, FaultPlan
from fedml_tpu_torch.core import robust, robust_agg
from fedml_tpu_torch.core.local import split_net
from fedml_tpu_torch.core.tasks import classification_task
from fedml_tpu_torch.data.synthetic import synthetic_images
from fedml_tpu_torch.distributed.fedavg import run_simulated
from fedml_tpu_torch.models.cnn import CNNDropOut
from fedml_tpu_torch.models.resnet import ResNetCIFAR
from fedml_tpu_torch.utils import prng

TOL = 1e-5
DATA = dict(num_clients=4, image_shape=(8, 8, 3), num_classes=3,
            samples_per_client=12, test_samples=24, seed=0)
CFG = dict(comm_round=2, client_num_in_total=4, client_num_per_round=4,
           epochs=1, batch_size=6, lr=0.1, frequency_of_the_test=2, seed=0)
DROP_DATA = dict(num_clients=4, image_shape=(28, 28, 1), num_classes=10,
                 samples_per_client=12, test_samples=24, seed=1)
SIGN_FLIP = {"seed": 3, "rules": [
    {"attack": "sign_flip", "ranks": [2], "factor": 10.0}]}
STRAGGLE = {"seed": 7, "rules": [
    {"fault": "straggle", "src": [2], "delay_s": 2.0}]}


# ------------------------------------------------------------- helpers
def from_jax(net) -> dict:
    """A JAX NetState as the port's net (params and extras)."""
    return convert.from_flax(jax.tree.map(np.asarray, net.params),
                             jax.tree.map(np.asarray, net.extra))


class Model:
    """Both packages' data (bitwise equal) and tasks for one model; the
    port's task inits to the JAX package's initial net, so every engine
    and every rank of both packages starts from the same weights."""

    def __init__(self, kind: str):
        if kind == "resnet":
            data_kw = DATA
            self.jtask = jax_task(JaxResNet(depth=8, num_classes=3))
            module = ResNetCIFAR(8, num_classes=3)
        else:
            data_kw = DROP_DATA
            self.jtask = jax_task(JaxCNNDropOut())
            module = CNNDropOut()
        self.jdata = jax_images(**data_kw)
        self.data = synthetic_images(**data_kw)
        self.jnet0 = jax.tree.map(np.asarray, JaxFedAvgAPI(
            self.jdata, self.jtask, JaxConfig(**CFG)).net)
        self.net0 = from_jax(self.jnet0)
        net0 = self.net0
        self.task = classification_task(module)._replace(
            init=lambda g, x=None: {k: v.clone() for k, v in net0.items()})

    def cfg(self, jax_side=False, **kw):
        return (JaxConfig if jax_side else FedAvgConfig)(**{**CFG, **kw})

    def engine(self, cls=FedAvgAPI, cfg=None, **kw):
        api = cls(self.data, self.task, cfg or self.cfg(), device="cpu",
                  **kw)
        assert all(torch.equal(api.net[k], v) for k, v in self.net0.items())
        return api


_MODELS: dict = {}


def model(kind: str) -> Model:
    """One Model a process (a JAX init each)."""
    if kind not in _MODELS:
        _MODELS[kind] = Model(kind)
    return _MODELS[kind]


def assert_nets_close(got: dict, want: dict, extra_keys, atol=TOL,
                      extra_atol=TOL):
    """Leaf by leaf: params within ``atol``, extras within
    ``extra_atol`` (absolute)."""
    assert set(got) == set(want)
    for k in got:
        tol = extra_atol if k in extra_keys else atol
        np.testing.assert_allclose(got[k].cpu().numpy(), want[k].numpy(),
                                   rtol=0, atol=tol, err_msg=k)


def assert_same_bits(got: dict, want: dict, keys=None) -> None:
    for k in keys or got:
        assert torch.equal(got[k], want[k]), k


def run_rounds(api, n=2):
    for r in range(n):
        api.run_round(r)
    return api


# ------------------------------------------- the gate, sketch and order
def _stacked_resnet(k=5, seed=0):
    """A ResNet-8 global net of the JAX package and ``k`` perturbed client
    nets around it (params AND statistics), stacked, in both packages'
    forms."""
    m = model("resnet")
    rs = np.random.RandomState(seed)
    jnet = m.jnet0
    stacked = jax.tree.map(lambda a: np.stack([
        a + rs.standard_normal(a.shape).astype(np.float32) * 0.1 * (i + 1)
        for i in range(k)]), jnet)
    port = {key: torch.stack([from_jax(jax.tree.map(
        lambda a, i=i: a[i], stacked))[key] for i in range(k)])
        for key in m.net0}
    return jnet, stacked, from_jax(jnet), port


def test_evidence_sketch_walks_the_wire_order():
    """update_evidence over a ResNet net with statistics: the norms, the
    finite flags and the 64-wide Rademacher sketch equal the JAX
    package's over its NetState (params in flax order, then the
    extras). A flattening in any other order gives another sketch."""
    jnet, jstack, net, stack = _stacked_resnet()
    w = np.array([12.0, 7.0, 12.0, 3.0, 9.0], np.float32)
    want = jax.jit(jax_agg.update_evidence)(jstack, jnet, jnp.asarray(w))
    got = robust_agg.update_evidence(stack, net, torch.from_numpy(w))
    for key in ("norm", "sketch"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=1e-5, atol=1e-5, err_msg=key)
    assert np.array_equal(got["finite"].numpy(), np.asarray(want["finite"]))
    # the statistics count: the norms without them are smaller
    params, _ = split_net(stack, model("resnet").task.extra_keys)
    assert (robust_agg._slot_evidence(params, net)[1]
            < got["norm"]).all()
    # and the order matters: the port's own dict order sketches otherwise
    shuffled = dict(sorted(stack.items(), reverse=True))
    flat = torch.cat([(s - net[k][None]).reshape(5, -1)
                      for k, s in shuffled.items()], 1)
    n = flat.shape[1]
    chunk = -(-n // 64)
    flat = torch.cat([flat, flat.new_zeros(5, 64 * chunk - n)], 1)
    other = (flat * torch.from_numpy(robust_agg.sketch_signs(64 * chunk))
             ).reshape(5, 64, chunk).sum(-1)
    assert not np.allclose(other.numpy(), np.asarray(want["sketch"]),
                           atol=1e-3)


@pytest.mark.parametrize("name", ["median", "krum", "trimmed_mean",
                                  "geometric_median"])
def test_gated_aggregate_over_statistics_matches_jax(name):
    """gate -> estimator over the stacked NetState with statistics: the
    port's average (params and extras) within 1e-5 of the JAX package's,
    the surviving weights and reason codes equal."""
    jnet, jstack, net, stack = _stacked_resnet(seed=1)
    w = np.array([12.0, 7.0, 12.0, 3.0, 9.0], np.float32)
    kw = dict(n=5, f=1) if name == "krum" else dict(n=5)
    javg, jw, jreasons = jax.jit(functools.partial(
        jax_agg.gated_aggregate,
        robust_fn=jax_agg.make_robust_aggregator(name, **kw),
        norm_mult=1.5))(jstack, jnet, jnp.asarray(w))
    avg, pw, reasons = robust_agg.gated_aggregate(
        stack, net, torch.from_numpy(w),
        robust_fn=robust_agg.make_robust_aggregator(name, **kw),
        norm_mult=1.5)
    assert np.array_equal(reasons.numpy(), np.asarray(jreasons))
    assert np.array_equal(pw.numpy(), np.asarray(jw))
    assert (reasons.numpy() != 0).any()
    assert_nets_close(avg, from_jax(jax.tree.map(np.asarray, javg)),
                      model("resnet").task.extra_keys)


def test_injector_perturbs_params_and_statistics():
    """The in-graph adversary perturbs every float entry of the attacked
    slot, the statistics included (the reference's full-NetState
    perturbation), and leaves the other slots alone."""
    from fedml_tpu.chaos.adversary import (
        make_in_graph_injector as jax_injector,
    )
    from fedml_tpu_torch.chaos.adversary import make_in_graph_injector

    jnet, jstack, net, stack = _stacked_resnet(k=4, seed=2)
    plan_doc = {"seed": 1, "rules": [
        {"attack": "sign_flip", "ranks": [2], "factor": 10.0},
        {"attack": "shift", "ranks": [3], "z": 1.5}]}
    got = make_in_graph_injector(AdversaryPlan.from_json(plan_doc), 4)(
        stack, net, 0)
    want = jax.jit(jax_injector(JaxAdversaryPlan.from_json(plan_doc), 4))(
        jstack, jnet, jnp.int32(0))
    want = jax.tree.map(np.asarray, want)
    extra_keys = model("resnet").task.extra_keys
    for i in range(4):
        row = from_jax(jax.tree.map(lambda a, i=i: a[i], want))
        assert_nets_close({k: v[i] for k, v in got.items()}, row,
                          extra_keys)
    for k in extra_keys:
        assert torch.equal(got[k][0], stack[k][0])
        assert not torch.equal(got[k][1], stack[k][1])


# ------------------------------------------------ the robust engine
@pytest.fixture(scope="module")
def jax_robust_runs():
    """The JAX package's engine and loopback runtime under the sign-flip
    plan with the median behind the gate (test_robust_agg.py's
    test_runtimes_agree_on_model_with_batch_stats), and its engine under
    the gate alone and the adversary alone."""
    m = model("resnet")
    out = {}
    for case, kw in ENGINE_CASES.items():
        kw = dict(kw)
        if "adversary_plan" in kw:
            kw["adversary_plan"] = JaxAdversaryPlan.from_json(SIGN_FLIP)
        api = JaxFedAvgAPI(m.jdata, m.jtask, m.cfg(True), **kw)
        for r in range(2):
            api.run_round(r)
        out[case] = (from_jax(jax.tree.map(np.asarray, api.net)),
                     api.quarantine.canonical())
    dist = jax_run_simulated(
        m.jdata, m.jtask, m.cfg(True), job_id="x-byz-bn",
        adversary_plan=JaxAdversaryPlan.from_json(SIGN_FLIP),
        aggregator="median")
    out["loopback"] = (from_jax(jax.tree.map(np.asarray, dist.net)),
                       dist.quarantine.canonical())
    return out


ENGINE_CASES = {
    "median_adversary": dict(aggregator="median", adversary_plan=True),
    "sanitize": dict(sanitize=True, adversary_plan=True),
    "adversary": dict(adversary_plan=True),
}


@pytest.mark.parametrize("case", list(ENGINE_CASES))
def test_robust_engine_matches_jax(jax_robust_runs, case):
    """Two engine rounds of ResNet-8 under each robust option: params and
    statistics within 1e-5 of the JAX engine's, the quarantine ledgers
    equal (non-empty where a gate is armed)."""
    m = model("resnet")
    kw = dict(ENGINE_CASES[case])
    if "adversary_plan" in kw:
        kw["adversary_plan"] = AdversaryPlan.from_json(SIGN_FLIP)
    api = run_rounds(m.engine(**kw))
    want, ledger = jax_robust_runs[case]
    assert api.quarantine.canonical() == ledger
    assert (len(ledger) > 0) == (case != "adversary")
    assert_nets_close(api.net, want, m.task.extra_keys)
    assert not torch.equal(api.net["norm.var"], m.net0["norm.var"])


def test_robust_runtimes_agree_with_jax_on_statistics(jax_robust_runs):
    """The engine and the loopback runtime under the same plan and median
    (the JAX package's runtime-parity test on its BatchNorm model): both
    ledgers the JAX loopback run's, both nets within 1e-5 of it."""
    m = model("resnet")
    want, ledger = jax_robust_runs["loopback"]
    agg = run_simulated(m.data, m.task, m.cfg(), job_id="x-byz-bn-port",
                        device="cpu",
                        adversary_plan=AdversaryPlan.from_json(SIGN_FLIP),
                        aggregator="median")
    api = run_rounds(m.engine(aggregator="median",
                              adversary_plan=AdversaryPlan.from_json(
                                  SIGN_FLIP)))
    assert agg.quarantine.canonical() == ledger == api.quarantine.canonical()
    assert len(ledger) > 0
    assert_nets_close(agg.net, want, m.task.extra_keys)
    assert_nets_close(api.net, want, m.task.extra_keys)


def _port_hooks(extra_keys):
    def client_hook(net_k, net_global, key):
        # halve each client's running variance, keep its params
        return {k: v * 0.5 if k.endswith(".var") else v
                for k, v in net_k.items()}

    def post_hook(net, key):
        # shift the averaged running means, keep the params
        return {k: v + 0.25 if k.endswith(".mean") else v
                for k, v in net.items()}

    return dict(client_result_hook=client_hook, post_aggregate_hook=post_hook)


def _jax_hooks():
    def on_stats(tree, leaf, fn):
        return jax.tree_util.tree_map_with_path(
            lambda p, v: fn(v) if p[-1].key == leaf else v, tree)

    def client_hook(net_k, net_global, key):
        return NetState(net_k.params,
                        on_stats(net_k.extra, "var", lambda v: v * 0.5))

    def post_hook(net, key):
        return NetState(net.params,
                        on_stats(net.extra, "mean", lambda v: v + 0.25))

    return dict(client_result_hook=client_hook, post_aggregate_hook=post_hook)


def test_hooks_see_the_extras():
    """A client_result_hook and a post_aggregate_hook that rewrite the
    running statistics: the port's hooks see them in the flat net as the
    JAX package's see NetState.extra, and the rounds agree within 1e-5."""
    m = model("resnet")
    japi = JaxFedAvgAPI(m.jdata, m.jtask, m.cfg(True), **_jax_hooks())
    plain = run_rounds(m.engine(), 1)
    api = run_rounds(m.engine(**_port_hooks(m.task.extra_keys)), 1)
    japi.run_round(0)
    assert_nets_close(api.net, from_jax(jax.tree.map(np.asarray, japi.net)),
                      m.task.extra_keys)
    # the params went through untouched: the plain round's, bitwise
    params, _ = split_net(plain.net, m.task.extra_keys)
    assert_same_bits(api.net, plain.net, params)
    assert not torch.equal(api.net["norm.mean"], plain.net["norm.mean"])


# ------------------------------------------------------ clip and noise
def test_clip_and_noise_leave_the_extras_as_they_arrived():
    """norm_diff_clipping and add_gaussian_noise with ``extra_keys``: the
    norm and the scale over the params alone, the extras passed through
    bitwise; the noise is the JAX package's draw over NetState.params
    (split over the param leaves only), the extras untouched."""
    jnet, jstack, net, stack = _stacked_resnet(k=2, seed=3)
    extra_keys = model("resnet").task.extra_keys
    local = {k: v[1] for k, v in stack.items()}
    jlocal = jax.tree.map(lambda a: a[1], jstack)
    got = robust.norm_diff_clipping(local, net, 1.0, extra_keys)
    want = NetState(jax.jit(jax_robust.norm_diff_clipping,
                            static_argnums=2)(jlocal.params, jnet.params,
                                              1.0), jlocal.extra)
    assert_nets_close(got, from_jax(jax.tree.map(np.asarray, want)),
                      extra_keys, atol=1e-6)
    assert_same_bits(got, local, extra_keys)
    key = prng.key(11)
    noisy = robust.add_gaussian_noise(key, net, 0.5, extra_keys)
    jnoisy = NetState(jax.jit(lambda k, p: jax_robust.add_gaussian_noise(
        k, p, 0.5))(jnp.asarray(key), jnet.params), jnet.extra)
    assert_nets_close(noisy, from_jax(jax.tree.map(np.asarray, jnoisy)),
                      extra_keys, atol=1e-5)
    assert_same_bits(noisy, net, extra_keys)
    assert not torch.equal(noisy["fc.weight"], net["fc.weight"])


@pytest.fixture(scope="module")
def jax_defenses():
    m = model("resnet")
    out = {}
    for defense in ("weak_dp", "dp"):
        api = JaxRobustAPI(m.jdata, m.jtask, m.cfg(True),
                           defense_type=defense, norm_bound=1.0,
                           stddev=0.01, noise_multiplier=1.1)
        api.run_round(0)
        out[defense] = from_jax(jax.tree.map(np.asarray, api.net))
    return out


@pytest.mark.parametrize("defense", ["norm_diff_clipping", "weak_dp", "dp"])
def test_robust_api_clips_and_noises_params_only(jax_defenses, defense):
    """FedAvgRobustAPI on ResNet-8, one round. At a bound that does not
    bind, the clip's round keeps the plain round's statistics bitwise;
    under weak_dp and dp the statistics equal the clip-only round's
    bitwise (the noise leaves them alone) while the params move, and the
    round is the JAX package's within 1e-5."""
    m = model("resnet")
    extra_keys = m.task.extra_keys
    if defense == "norm_diff_clipping":
        plain = run_rounds(m.engine(), 1)
        api = run_rounds(m.engine(FedAvgRobustAPI, defense_type=defense,
                                  norm_bound=1e6), 1)
        assert_same_bits(api.net, plain.net, extra_keys)
        assert_nets_close(api.net, plain.net, extra_keys, atol=1e-6)
        return
    clip = run_rounds(m.engine(
        FedAvgRobustAPI, defense_type="norm_diff_clipping", norm_bound=1.0,
        uniform_avg=defense == "dp"), 1)
    api = run_rounds(m.engine(FedAvgRobustAPI, defense_type=defense,
                              norm_bound=1.0, stddev=0.01,
                              noise_multiplier=1.1), 1)
    assert_same_bits(api.net, clip.net, extra_keys)
    assert not torch.equal(api.net["fc.weight"], clip.net["fc.weight"])
    assert_nets_close(api.net, jax_defenses[defense], extra_keys)


# ------------------------------------------------------ the async runner
@pytest.fixture(scope="module")
def jax_async_runs():
    """The JAX package's async runner under a straggle plan (K = 3,
    poly:0.5) on ResNet-8 and on CNNDropOut."""
    out = {}
    for kind in ("resnet", "dropout"):
        m = model(kind)
        api = JaxFedAvgAPI(m.jdata, m.jtask, m.cfg(True, comm_round=4))
        runner = api.run_async(4, buffer_k=3, staleness="poly:0.5",
                               chaos_plan=JaxFaultPlan.from_json(STRAGGLE))
        out[kind] = (from_jax(jax.tree.map(np.asarray, api.net)),
                     [h["staleness"] for h in runner.history])
    return out


@pytest.mark.parametrize("kind", ["resnet", "dropout"])
def test_async_runner_matches_jax(jax_async_runs, kind):
    """Four buffered updates under a straggler (the staleness is
    exercised): the statistics ride the buffer and fold with the params,
    CNNDropOut's arrivals key on fold_in(fold_in(key(seed), wave),
    client); the net within 1e-5 of the JAX runner's, the staleness
    history equal."""
    m = model(kind)
    api = m.engine(cfg=m.cfg(comm_round=4))
    runner = api.run_async(4, buffer_k=3, staleness="poly:0.5",
                           chaos_plan=FaultPlan.from_json(STRAGGLE))
    want, stale = jax_async_runs[kind]
    assert [h["staleness"] for h in runner.history] == stale
    assert max(max(s) for s in stale) >= 1
    assert_nets_close(api.net, want, m.task.extra_keys)


@pytest.mark.parametrize("kind", ["resnet", "dropout"])
def test_async_k_cohort_bound0_is_sync_bitwise(kind):
    """K = cohort at bound 0 is the barrier: the runner's net is the sync
    engine's bitwise, statistics and dropout keys included."""
    m = model(kind)
    sync = run_rounds(m.engine())
    api = m.engine()
    api.run_async(2, buffer_k=4, staleness="constant", staleness_bound=0)
    assert_same_bits(api.net, sync.net)


def test_async_keys_are_the_reference_chain(monkeypatch):
    """Each arrival's fit keys are fold_in(fold_in(key(seed), wave),
    client) split per epoch and batch: the JAX package's async fit key
    and its scans' splits, bitwise."""
    m = model("dropout")
    api = m.engine()
    seen = []
    fit = api.local_update
    monkeypatch.setattr(api, "local_update", lambda net, x, y, mask, keys:
                        seen.append(keys) or fit(net, x, y, mask, keys))
    runner = api.run_async(1, buffer_k=4, staleness="constant",
                           staleness_bound=0)
    assert runner.version == 1 and len(seen) == 1
    ids = api._sampled_ids(0)
    for i, cid in enumerate(ids):
        rng = jax.random.fold_in(jax.random.fold_in(
            jax.random.PRNGKey(CFG["seed"]), 0), int(cid))
        rng, carry = jax.random.split(rng)
        for b in range(seen[0].shape[1]):
            carry, sub = jax.random.split(carry)
            assert np.array_equal(seen[0][0, b, i].numpy(),
                                  np.asarray(sub).astype(np.int64))
