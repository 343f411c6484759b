"""Accounted DP-FedAvg in the port (utils/prng.py, core/privacy.py,
core/robust.py, algorithms/fedavg_robust.py, distributed/fedavg_robust.py
and the DP half of the server's crash recovery) against the JAX package's,
on tests/test_async_buffer.py's tiny configuration (synthetic images of 8
clients, 6x6x1, 3 classes, 12 samples each, LogisticRegression), from the
same seeded numpy inputs and weights.

Tolerances: the key chain (``key``, ``split``, ``fold_in``) and the random
bits bitwise ``jax.random``'s; ``normal`` within 1e-5 relative of
``jax.random.normal`` (the uniforms are bitwise, the erfinv XLA's own
polynomial: a few float32 ulps apart, whatever the process's float
state); the torch draws bitwise the numpy ones on the CPU;
``privacy.py`` byte-equal to the reference but for its import line, and its
math equal to the reference module's; clipping and noise within 1e-5 of
``fedml_tpu.core.robust``'s on converted weights; whole DP, weak-DP and
clipping runs (engine and wire) within 1e-5 of the JAX package's with ε
equal; inside the port, a crashed DP run bitwise its uninterrupted twin.
No test waits out a deadline: crashes are the supervision loop's.
"""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.algorithms.fedavg import FedAvgConfig as JaxConfig
from fedml_tpu.algorithms.fedavg_robust import FedAvgRobustAPI as JaxRobustAPI
from fedml_tpu.comm.message import pack_pytree as jax_pack
from fedml_tpu.core import privacy as JP
from fedml_tpu.core import robust as JR
from fedml_tpu.core.tasks import classification_task as jax_classification_task
from fedml_tpu.data.synthetic import synthetic_images as jax_synthetic_images
from fedml_tpu.distributed import fedavg_robust as jax_dist
from fedml_tpu.models.linear import LogisticRegression as JaxLR
from fedml_tpu_torch import convert
from fedml_tpu_torch.algorithms import FedAvgConfig, FedAvgRobustAPI
from fedml_tpu_torch.chaos import FaultPlan
from fedml_tpu_torch.comm.message import pack_pytree
from fedml_tpu_torch.core import privacy as P
from fedml_tpu_torch.core import robust as R
from fedml_tpu_torch.core.tasks import classification_task
from fedml_tpu_torch.core.wal import RoundWAL
from fedml_tpu_torch.data.synthetic import synthetic_images
from fedml_tpu_torch.distributed import fedavg_robust as dist
from fedml_tpu_torch.distributed.fedavg.server_manager import (
    FedAvgServerManager,
)
from fedml_tpu_torch.distributed.utils import backend_kwargs
from fedml_tpu_torch.experiments import distributed_launch
from fedml_tpu_torch.models import create_model
from fedml_tpu_torch.obs.metrics import REGISTRY
from fedml_tpu_torch.utils import prng

DATA_KW = dict(num_clients=8, image_shape=(6, 6, 1), num_classes=3,
               samples_per_client=12, test_samples=48, seed=0)
TOL = dict(rtol=1e-5, atol=1e-6)
DP_KW = dict(defense_type="dp", norm_bound=0.5, noise_multiplier=1.1)


def _cfg(rounds=3, per_round=4, freq=1):
    return dict(comm_round=rounds, client_num_in_total=8,
                client_num_per_round=per_round, epochs=1, batch_size=6,
                lr=0.1, frequency_of_the_test=freq, seed=0)


@pytest.fixture(scope="module")
def setup():
    jdata = jax_synthetic_images(**DATA_KW)
    jtask = jax_classification_task(JaxLR(num_classes=3))
    _, key = jax.random.split(jax.random.PRNGKey(0))
    params = jax.tree.map(np.asarray, jtask.init(
        key, jnp.asarray(jdata.train_x[:6])).params)
    state = convert.from_flax(params)
    task = classification_task(create_model("lr", output_dim=3, device="cpu"))
    task = task._replace(init=lambda g, x=None: {k: v.clone()
                                                 for k, v in state.items()})
    return dict(data=synthetic_images(**DATA_KW), task=task, jdata=jdata,
                jtask=jtask)


@pytest.fixture(scope="module")
def no_orbax():
    """The JAX package writes the npz layout (its orbax-less fallback), the
    one the port reads: tests/test_wal.py's force_npz, module-wide."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "orbax", None)
        mp.setitem(sys.modules, "orbax.checkpoint", None)
        yield


def _close(port_net, jax_params):
    for a, b in zip(pack_pytree(port_net), jax.tree.leaves(jax_params)):
        np.testing.assert_allclose(a, np.asarray(b), **TOL)


def _same(a: dict, b: dict) -> bool:
    return all(torch.equal(a[k], b[k]) for k in a)


# ------------------------------------------------------------------ prng
_SEEDS = (0, 7, 123456789, 2 ** 31 + 5)


@pytest.mark.parametrize("seed", _SEEDS)
def test_key_split_fold_in_and_bits_are_jax_bitwise(seed):
    k = jax.random.PRNGKey(seed)
    mine = prng.key(seed)
    assert np.array_equal(np.asarray(k), mine)
    for n in (1, 2, 3, 10):
        assert np.array_equal(np.asarray(jax.random.split(k, n)),
                              prng.split(mine, n))
    for d in (0, 1, 5, 3399, 2 ** 31):
        assert np.array_equal(np.asarray(jax.random.fold_in(k, d)),
                              prng.fold_in(mine, d))
    for shape in ((5,), (3, 4), (2, 3, 5)):
        assert np.array_equal(
            np.asarray(jax.random.bits(k, shape, jnp.uint32)),
            prng.random_bits(mine, shape))


def _jax_normal(seed, n):
    """``jax.random.normal``, compiled here and now: a fresh lowering with
    the persistent compilation cache (tests/conftest.py arms one for every
    test process) off, so the reference is this host's own executable."""
    from jax.experimental.compilation_cache import compilation_cache as cc

    key = jax.random.PRNGKey(seed)
    was = jax.config.jax_enable_compilation_cache
    jax.config.update("jax_enable_compilation_cache", False)
    try:
        fn = jax.jit(lambda k: jax.random.normal(k, (n,), jnp.float32))
        return np.asarray(fn.lower(key).compile()(key))
    finally:
        jax.config.update("jax_enable_compilation_cache", was)
        cc.reset_cache()


@pytest.mark.parametrize("seed", _SEEDS)
def test_normal_within_1e5_relative_of_jax(seed):
    got = prng.normal(prng.key(seed), (20011,))
    np.testing.assert_allclose(got, _jax_normal(seed, 20011), rtol=1e-5,
                               atol=0)


def test_normal_draw_ignores_process_float_state(monkeypatch):
    """ROADMAP C3: the port's normal once drifted 6.6e-5 from JAX's in one
    test process, through torch's float32 erfinv. The draw now runs XLA's
    own erfinv polynomial in plain ops: with the process-wide float state
    the port's tests and engine change (matmul precision and TF32, flush
    denormal, one thread, a float64 default dtype) and torch's erfinv
    unusable, it is bitwise the draw without them and within the present
    bound of JAX's."""
    k = prng.key(7)
    before = prng.normal(k, (20011,))
    bits = prng.normal_torch(k, (301,), "cpu")
    threads = torch.get_num_threads()
    prev = (torch.get_float32_matmul_precision(),
            torch.backends.cudnn.allow_tf32, torch.get_default_dtype())
    monkeypatch.setattr(torch.special, "erfinv", None)
    try:
        torch.set_float32_matmul_precision("high")
        torch.backends.cudnn.allow_tf32 = True
        torch.set_flush_denormal(True)
        torch.set_num_threads(1)
        torch.set_default_dtype(torch.float64)
        got = prng.normal(k, (20011,))
        assert np.array_equal(got, before)
        assert torch.equal(prng.normal_torch(k, (301,), "cpu"), bits)
    finally:
        torch.set_float32_matmul_precision(prev[0])
        torch.backends.cudnn.allow_tf32 = prev[1]
        torch.set_default_dtype(prev[2])
        torch.set_flush_denormal(False)
        torch.set_num_threads(threads)
    np.testing.assert_allclose(got, _jax_normal(7, 20011), rtol=1e-5, atol=0)


def test_torch_draws_are_the_numpy_draws_bitwise():
    k = prng.split(prng.key(3), 4)[2]
    bits = prng.random_bits_torch(k, (7, 9), "cpu").numpy()
    assert np.array_equal(bits.astype(np.uint32), prng.random_bits(k, (7, 9)))
    assert np.array_equal(prng.normal_torch(k, (301,), "cpu").numpy(),
                          prng.normal(k, (301,)))
    # several keys in one hash: each segment is its key's own draw
    keys = prng.split(k, 3)
    multi = prng.random_bits_multi(keys, [4, 0, 6], "cpu").numpy()
    assert np.array_equal(multi.astype(np.uint32), np.concatenate(
        [prng.random_bits(keys[0], (4,)), prng.random_bits(keys[2], (6,))]))


def test_sketch_signs_still_draw_from_the_shared_threefry():
    from fedml_tpu_torch.core import robust_agg

    assert robust_agg._threefry2x32 is prng._threefry2x32


# --------------------------------------------------------------- privacy
def test_privacy_module_is_the_references_but_for_its_import():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ref = open(os.path.join(root, "fedml_tpu/core/privacy.py")).read()
    mine = open(os.path.join(root, "fedml_tpu_torch/core/privacy.py")).read()
    assert mine == ref.replace("from fedml_tpu.obs import perf_instrument",
                               "from fedml_tpu_torch.obs import "
                               "perf_instrument")


@pytest.mark.parametrize("q,z", [(1.0, 0.5), (1.0, 2.0), (0.0, 1.0),
                                 (0.001, 1.0), (0.1, 1.0), (0.5, 1.1),
                                 (3 / 8, 0.8)])
def test_rdp_math_equals_the_references(q, z):
    for a in (2, 5, 32, 256):
        assert P.subsampled_gaussian_rdp(q, z, a) == \
            JP.subsampled_gaussian_rdp(q, z, a)
    acc, jacc = P.DPAccountant(), JP.DPAccountant()
    for _ in range(3):
        acc.step(q, z)
        jacc.step(q, z)
    if q > 0:
        assert acc.epsilon(1e-5) == jacc.epsilon(1e-5)
        assert acc.best_order(1e-5) == jacc.best_order(1e-5)


def test_q1_reduces_to_gaussian():
    for z in (0.5, 1.0, 2.0):
        for a in (2, 5, 32):
            assert P.subsampled_gaussian_rdp(1.0, z, a) == pytest.approx(
                P.gaussian_rdp(z, a))
    assert P.subsampled_gaussian_rdp(0.0, 1.0, 8) == 0.0


def test_composition_is_additive_and_eps_monotone():
    acc1 = P.DPAccountant().step(0.1, 1.0, rounds=10)
    acc2 = P.DPAccountant()
    for _ in range(10):
        acc2.step(0.1, 1.0)
    np.testing.assert_allclose(acc1._rdp, acc2._rdp, rtol=1e-12)
    e10 = acc1.epsilon(1e-5)
    e20 = P.DPAccountant().step(0.1, 1.0, rounds=20).epsilon(1e-5)
    e10_z2 = P.DPAccountant().step(0.1, 2.0, rounds=10).epsilon(1e-5)
    assert e20 > e10 > e10_z2 > 0
    with pytest.raises(ValueError, match="noise_multiplier"):
        P.DPAccountant().step(0.1, -1.0)


def test_client_ledger_math_pins_rdp_oracle():
    def oracle(z, rounds):
        rdp = rounds * np.array([P.gaussian_rdp(z, a)
                                 for a in P.DEFAULT_ALPHAS])
        return P.rdp_to_epsilon(rdp, P.DEFAULT_ALPHAS, P.DEFAULT_DELTA)

    led, jled = P.ClientPrivacyLedger(), JP.ClientPrivacyLedger()
    for ledger in (led, jled):
        ledger.charge([1, 2], noise_multiplier=1.0)
        ledger.charge([2], noise_multiplier=1.0)
    assert led.epsilon(1) == pytest.approx(oracle(1.0, 1), rel=1e-12)
    assert led.epsilon(2) == pytest.approx(oracle(1.0, 2), rel=1e-12)
    assert led.epsilon(99) == 0.0
    assert led.summary() == jled.summary()


def test_charge_and_record_rollup_and_prometheus_family():
    acct, led = P.DPAccountant(), P.ClientPrivacyLedger()
    block = P.charge_and_record(acct, q=0.5, noise_multiplier=1.0, clip=5.0,
                                realized_m=2, client_ledger=led,
                                client_ids=[3, 5])
    jblock = JP.charge_and_record(JP.DPAccountant(), q=0.5,
                                  noise_multiplier=1.0, clip=5.0,
                                  realized_m=2,
                                  client_ledger=JP.ClientPrivacyLedger(),
                                  client_ids=[3, 5])
    assert block == jblock
    text = REGISTRY.to_prometheus()
    assert 'fed_privacy_client_epsilon{stat="count"} 2' in text
    assert "fed_privacy_epsilon" in text


# ------------------------------------------------------- clipping and noise
@pytest.fixture(scope="module")
def cnn_params():
    """A narrow CNNOriginalFedAvg-shaped flax tree (2 and 4 channels, 8
    hidden units): the layouts ``convert`` moves (HWIO kernels, the first
    dense layer's NHWC rows) at a size the CPU draws in milliseconds."""
    rs = np.random.RandomState(0)
    shapes = {"Conv_0": ((5, 5, 1, 2), (2,)), "Conv_1": ((5, 5, 2, 4), (4,)),
              "Dense_0": ((7 * 7 * 4, 8), (8,)), "Dense_1": ((8, 62), (62,))}
    return {name: {"kernel": rs.randn(*k).astype(np.float32),
                   "bias": rs.randn(*b).astype(np.float32)}
            for name, (k, b) in shapes.items()}


@pytest.mark.parametrize("model", ["lr", "cnn"])
def test_clipping_and_noise_match_jax_on_converted_weights(setup, cnn_params,
                                                           model):
    params = (cnn_params if model == "cnn" else jax.tree.map(
        np.asarray, setup["jtask"].init(
            jax.random.PRNGKey(1), jnp.zeros((1, 6, 6, 1))).params))
    glob = jax.tree.map(lambda v: v * np.float32(0.9), params)
    clip, noise = jax.jit(JR.norm_diff_clipping), jax.jit(
        JR.add_gaussian_noise)
    for bound in (1e-3, 1e3):  # clipped and untouched
        want = convert.from_flax(jax.tree.map(
            np.asarray, clip(params, glob, bound)))
        got = R.norm_diff_clipping(convert.from_flax(params),
                                   convert.from_flax(glob), bound)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], **TOL)
    for seed, sd in ((42, 0.5), (3, 0.01)):
        want = convert.from_flax(jax.tree.map(np.asarray, noise(
            jax.random.PRNGKey(seed), params, sd)))
        got = R.add_gaussian_noise(prng.key(seed), convert.from_flax(params),
                                   sd)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], **TOL)


def test_clipping_is_one_norm_per_client_under_vmap():
    g = {"a": torch.zeros(3), "b": torch.zeros(2, 2)}
    nets = {"a": torch.tensor([[3.0, 0, 0], [0.1, 0, 0]]),
            "b": torch.tensor([[[4.0, 0], [0, 0]], [[0, 0], [0, 0]]])}
    out = torch.func.vmap(lambda n: R.norm_diff_clipping(n, g, 1.0))(nets)
    np.testing.assert_allclose(out["a"][0], [0.6, 0, 0], rtol=1e-6)
    np.testing.assert_allclose(out["b"][0, 0, 0], 0.8, rtol=1e-6)
    assert torch.equal(out["a"][1], nets["a"][1])  # inside the ball


# ------------------------------------------------------------ the engine
@pytest.mark.parametrize("defense", [
    dict(defense_type="norm_diff_clipping", norm_bound=0.5),
    dict(defense_type="weak_dp", norm_bound=0.5, stddev=0.01),
    DP_KW], ids=lambda d: d["defense_type"])
def test_robust_engine_matches_jax(setup, defense):
    """Three rounds of each defense: params within 1e-5 of the JAX
    engine's (the noise is its own draw per weight), ε equal, the key
    chains bitwise."""
    cfg = _cfg(freq=100)
    api = FedAvgRobustAPI(setup["data"], setup["task"], FedAvgConfig(**cfg),
                          device="cpu", **defense)
    japi = JaxRobustAPI(setup["jdata"], setup["jtask"], JaxConfig(**cfg),
                        **defense)
    for r in range(3):
        api.run_round(r)
        japi.run_round(r)
        if api.accountant is not None:
            assert api.epsilon() == japi.epsilon()
            assert api._privacy_extra() == japi._privacy_extra()
    _close(api.net, japi.net.params)
    assert np.array_equal(api.rng, np.asarray(japi.rng))
    assert api.uniform_avg == (defense["defense_type"] == "dp")


def test_dp_refusals_and_accounting_surface(setup):
    import dataclasses

    cfg = FedAvgConfig(**_cfg())
    with pytest.raises(ValueError, match="uniform"):
        FedAvgRobustAPI(setup["data"], setup["task"],
                        dataclasses.replace(cfg, sampling="size_weighted"),
                        device="cpu", **DP_KW)
    with pytest.raises(ValueError, match="noise_multiplier"):
        FedAvgRobustAPI(setup["data"], setup["task"], cfg, device="cpu",
                        defense_type="dp", noise_multiplier=0.0)
    weak = FedAvgRobustAPI(setup["data"], setup["task"], cfg, device="cpu",
                           defense_type="weak_dp")
    assert weak.accountant is None
    with pytest.raises(ValueError):
        weak.epsilon()
    # other defenses keep accepting size_weighted (no accountant involved)
    FedAvgRobustAPI(setup["data"], setup["task"],
                    dataclasses.replace(cfg, sampling="size_weighted"),
                    device="cpu", defense_type="norm_diff_clipping")


def test_dp_round_record_and_backdoor_eval(setup):
    from fedml_tpu_torch.obs.telemetry import Telemetry

    tel = Telemetry()
    x = setup["data"].test_x[:16]
    api = FedAvgRobustAPI(setup["data"], setup["task"], FedAvgConfig(**_cfg()),
                          device="cpu", telemetry=tel,
                          poisoned_test=(x, np.zeros(16, np.int64)), **DP_KW)
    api.train(2)
    recs = [r for r in tel.events.sink.records if r.get("kind") == "round"]
    tel.close()
    assert [r["privacy"]["eps"] for r in recs] == [
        round(P.DPAccountant().step(0.5, 1.1, rounds=n).epsilon(1e-5), 6)
        for n in (1, 2)]
    assert recs[-1]["privacy"]["m"] == 4
    bd = api.evaluate_backdoor()
    assert bd["count"] == 16 and 0.0 <= bd["acc"] <= 1.0


# -------------------------------------------------------------- the wire
def _port_dp(s, job, rounds, ckpt=None, rules=(), **kw):
    plan = FaultPlan.from_json({"seed": 1, "rules": list(rules)}) \
        if rules else None
    return dist.run_simulated(s["data"], s["task"],
                              FedAvgConfig(**_cfg(rounds, per_round=3)),
                              job_id=job, ckpt_dir=ckpt, chaos_plan=plan,
                              round_timeout_s=30.0 if rules else None,
                              device="cpu", **dict(DP_KW, **kw))


def _jax_dp(s, job, rounds, ckpt=None):
    return jax_dist.run_simulated(s["jdata"], s["jtask"],
                                  JaxConfig(**_cfg(rounds, per_round=3)),
                                  job_id=job, ckpt_dir=ckpt, **DP_KW)


@pytest.fixture(scope="module")
def dp_runs(setup, no_orbax, tmp_path_factory):
    """Each package's DP run of 4 rounds, and of 2 rounds into a kept
    ckpt_dir (the cross-package resume tests start from those)."""
    d = tmp_path_factory.mktemp("dp")
    return dict(port4=_port_dp(setup, "tp-dp4", 4),
                jax4=_jax_dp(setup, "tp-jdp4", 4),
                port2=(_port_dp(setup, "tp-dp2", 2, str(d / "port")),
                       str(d / "port")),
                jax2=(_jax_dp(setup, "tp-jdp2", 2, str(d / "jax")),
                      str(d / "jax")))


def test_loopback_dp_run_matches_jax(dp_runs):
    port, jx = dp_runs["port4"], dp_runs["jax4"]
    for a, b in zip(pack_pytree(port.net), jax_pack(jx.net)):
        np.testing.assert_allclose(a, np.asarray(b), **TOL)
    assert port.epsilon() == jx.epsilon()
    assert port.epsilon() == P.DPAccountant().step(
        3 / 8, 1.1, rounds=4).epsilon(1e-5)
    assert np.array_equal(port._noise_rng, np.asarray(jx._noise_rng))
    assert port.privacy_record() == jx.privacy_record()
    np.testing.assert_allclose([h["test_acc"] for h in port.history],
                               [h["test_acc"] for h in jx.history],
                               atol=1e-6)


@pytest.mark.parametrize("name,rules,lost", [
    ("between_commits", [{"fault": "crash", "ranks": [0],
                          "rounds": [2, 3]}], 0),
    ("mid_round", [{"fault": "crash", "ranks": [0], "rounds": [1, 2],
                    "after_uploads": 2}], 2)])
def test_crashed_dp_run_is_bitwise_its_uninterrupted_twin(setup, dp_runs,
                                                          tmp_path, name,
                                                          rules, lost):
    """A rank-0 crash of a DP run: the supervised restart restores the
    noise key and the RDP totals, so the job finishes bitwise the
    uninterrupted run (the noise stream continues, it is not replayed) with
    ε equal — these crash points fall before the round's pre-charge; the
    precharge unit test below holds the over-count of one that falls
    after it."""
    twin = dp_runs["port4"]
    agg = _port_dp(setup, f"tp-crash-{name}", 4, str(tmp_path), rules)
    assert _same(agg.net, twin.net)
    assert agg.epsilon() == twin.epsilon()
    assert np.array_equal(agg._noise_rng, twin._noise_rng)
    gone = [e for e in agg.quarantine.entries()
            if e["reason"] == "server_restart"]
    assert len(gone) == lost
    rep = RoundWAL.replay(os.path.join(str(tmp_path), "wal"))
    assert rep.restart_epochs == 2 and len(rep.of_kind("precharge")) >= 4


def test_precharge_past_the_commit_recharges_the_accountant(setup, dp_runs):
    """A WAL holding an UNCOMMITTED round's pre-charge (the crash fell
    between the charge and the commit): the restarted accountant is charged
    for it, ε above the checkpoint's own by exactly that round."""
    import shutil

    src = dp_runs["port2"][1]
    d = src + "-pre"
    shutil.copytree(src, d)
    wal = RoundWAL(os.path.join(d, "wal"))
    wal.append("broadcast", sync=True, round=2)
    wal.append("precharge", sync=True, round=2, q=3 / 8, z=1.1, clip=0.5,
               m=3)
    wal.close()
    agg = dist.FedAvgRobustAggregator(setup["data"], setup["task"],
                                      FedAvgConfig(**_cfg(4, 3)),
                                      worker_num=3, device="cpu", **DP_KW)
    srv = FedAvgServerManager(agg, rank=0, size=4, ckpt_dir=d,
                              **backend_kwargs("LOOPBACK", "tp-pre", 0,
                                               "127.0.0.1", 1))
    try:
        assert srv._resume_round == 2
        assert agg.epsilon() == P.DPAccountant().step(
            3 / 8, 1.1, rounds=3).epsilon(1e-5)
        assert agg.epsilon() > dp_runs["port2"][0].epsilon()
        assert np.array_equal(agg._noise_rng, dp_runs["port2"][0]._noise_rng)
    finally:
        srv.com_manager.stop_receive_message()
        srv.wal.close()


def test_precharge_records_rebuild_a_client_ledger(setup, tmp_path):
    """Per-client ledgers ride no checkpoint: every pre-charge carrying
    client ids re-charges them at boot (the reference's rebuild; in the
    reference only the masked secure tier journals clients)."""
    wal = RoundWAL(os.path.join(str(tmp_path), "wal"))
    wal.append("broadcast", sync=True, round=0)
    wal.append("precharge", sync=True, round=0, q=0.5, z=1.0, clip=5.0,
               m=2, clients=[1, 2])
    wal.append("commit", sync=True, round=0)
    wal.append("broadcast", sync=True, round=1)
    wal.append("precharge", sync=True, round=1, q=0.5, z=1.0, clip=5.0,
               m=2, clients=[2, 3])
    wal.close()
    agg = dist.FedAvgRobustAggregator(setup["data"], setup["task"],
                                      FedAvgConfig(**_cfg(3, 3)),
                                      worker_num=3, device="cpu", **DP_KW)
    agg.client_ledger = P.ClientPrivacyLedger()
    srv = FedAvgServerManager(agg, rank=0, size=4, ckpt_dir=str(tmp_path),
                              **backend_kwargs("LOOPBACK", "tp-led", 0,
                                               "127.0.0.1", 1))
    try:
        jled = JP.ClientPrivacyLedger()
        jled.charge([1, 2], 1.0)
        jled.charge([2, 3], 1.0)
        assert agg.client_ledger.summary() == jled.summary()
        # no checkpoint: the accountant re-charges both pre-charges
        assert agg.epsilon() == P.DPAccountant().step(
            0.5, 1.0, rounds=2).epsilon(1e-5)
    finally:
        srv.com_manager.stop_receive_message()
        srv.wal.close()


def test_each_package_resumes_the_others_dp_ckpt_dir(setup, dp_runs):
    """A 2-round DP run of one package, resumed by the other to 4 rounds:
    within 1e-5 of the 4-round runs, ε equal, the noise key continued (the
    checkpoint's ``rng`` and ``dp_rdp`` mean the same in both)."""
    import shutil

    jd = dp_runs["jax2"][1] + "-to-port"
    shutil.copytree(dp_runs["jax2"][1], jd)
    port = _port_dp(setup, "tp-resume-jax", 4, jd)
    pd = dp_runs["port2"][1] + "-to-jax"
    shutil.copytree(dp_runs["port2"][1], pd)
    jx = _jax_dp(setup, "tp-resume-port", 4, pd)
    for got in (port, jx):
        for a, b in zip(pack_pytree(dp_runs["port4"].net)
                        if got is jx else pack_pytree(got.net),
                        jax_pack(got.net) if got is jx
                        else jax_pack(dp_runs["jax4"].net)):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b), **TOL)
        assert got.epsilon() == dp_runs["jax4"].epsilon()
        assert np.array_equal(np.asarray(got._noise_rng),
                              np.asarray(dp_runs["jax4"]._noise_rng))
    assert [h["round"] for h in port.history] == [0, 1, 2, 3]


def test_launcher_runs_fedavg_robust_dp_over_loopback(setup):
    """``--algo fedavg_robust --defense_type dp --norm_bound --stddev
    --noise_multiplier``: a 2-round loopback job of the launcher's ranks as
    threads in this process; rank 0 prints a finite history and its
    aggregator charged the accountant for both rounds."""
    import contextlib
    import io
    import threading
    import time

    from fedml_tpu_torch.comm import loopback

    argv = ["--world_size", "3", "--backend", "loopback", "--dataset",
            "mnist", "--model", "lr", "--comm_round", "2",
            "--client_num_in_total", "4", "--batch_size", "8",
            "--frequency_of_the_test", "1", "--ci", "1", "--device", "cpu",
            "--algo", "fedavg_robust", "--defense_type", "dp",
            "--norm_bound", "0.5", "--stddev", "0.01",
            "--noise_multiplier", "1.2"]
    errors = []

    def rank(r):
        try:
            distributed_launch.main(["--rank", str(r)] + argv)
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    threads = [threading.Thread(target=rank, args=(r,), daemon=True)
               for r in (1, 2)]
    out = io.StringIO()
    try:
        for t in threads:
            t.start()
        # the server starts once every client listens, as a launch script
        # starts the clients first
        deadline = time.monotonic() + 60
        while set(loopback._registry.get("launch", {})) != {1, 2}:
            assert time.monotonic() < deadline and not errors, errors
            time.sleep(0.02)
        with contextlib.redirect_stdout(out):
            rank(0)
        for t in threads:
            t.join(timeout=0 if errors else 60)
    finally:
        for mgr in list(loopback._registry.get("launch", {}).values()):
            mgr.stop_receive_message()
        for t in threads:
            t.join(timeout=10)
    assert not errors, errors
    hist = json.loads(out.getvalue().strip().splitlines()[-1])
    assert [h["round"] for h in hist] == [0, 1]
    assert all(np.isfinite(h["test_loss"]) for h in hist)
    eps = P.DPAccountant().step(2 / 4, 1.2, rounds=2).epsilon(1e-5)
    assert REGISTRY.gauge("fed_privacy_epsilon").value == round(eps, 6)


def test_dp_entry_points_need_a_device_without_cuda(setup):
    """No CUDA and no explicit device: the DP engine, aggregator and
    simulated job raise; there is no silent CPU path."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = FedAvgConfig(**_cfg())
    for call in (
            lambda: FedAvgRobustAPI(setup["data"], setup["task"], cfg,
                                    **DP_KW),
            lambda: dist.FedAvgRobustAggregator(setup["data"], setup["task"],
                                                cfg, 4, **DP_KW),
            lambda: dist.run_simulated(setup["data"], setup["task"], cfg,
                                       job_id="tp-nodev", **DP_KW)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
