"""Byzantine-robust aggregation in the port (fedml_tpu_torch/core/robust_agg
and chaos/adversary's in-graph injector, the engine's, server's, client's
and launcher's wiring) against the JAX package's on the same seeded numpy
inputs. Mirrors tests/test_robust_agg.py and test_hierarchy_robust.py's
flat cases.

Tolerances: selections (the weighted median, Krum's pick and its
``suspected`` slots, the sketch's signs, every reason code and ledger) are
held bitwise; arithmetic estimators within 1e-6 relative (the two packages
sum in other orders, and XLA contracts the pairwise fold's first level into
an fma where torch's separate kernels do not); the engine's and the
loopback runtime's models within 1e-5, as the plain rounds are held.
"""

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

from fedml_tpu import chaos as jax_chaos
from fedml_tpu.algorithms.fedavg import FedAvgAPI as JaxFedAvgAPI
from fedml_tpu.algorithms.fedavg import FedAvgConfig as JaxConfig
from fedml_tpu.chaos.adversary import make_in_graph_injector as jax_injector
from fedml_tpu.comm.message import pack_pytree as jax_pack
from fedml_tpu.core import robust_agg as J
from fedml_tpu.core.tasks import classification_task as jax_classification_task
from fedml_tpu.data.synthetic import synthetic_images as jax_synthetic_images
from fedml_tpu.distributed.fedavg import api as jax_api
from fedml_tpu.models.linear import LogisticRegression as JaxLR
from fedml_tpu_torch import chaos, convert
from fedml_tpu_torch.algorithms import FedAvgAPI, FedAvgConfig
from fedml_tpu_torch.algorithms import fedavg as port_fedavg
from fedml_tpu_torch.chaos.adversary import make_in_graph_injector
from fedml_tpu_torch.comm import loopback
from fedml_tpu_torch.comm.message import pack_pytree
from fedml_tpu_torch.core import robust_agg as P
from fedml_tpu_torch.core.tasks import classification_task
from fedml_tpu_torch.data.synthetic import synthetic_images
from fedml_tpu_torch.distributed.fedavg import run_simulated
from fedml_tpu_torch.distributed.fedavg.aggregator import FedAvgAggregator
from fedml_tpu_torch.experiments import distributed_launch
from fedml_tpu_torch.models import create_model
from fedml_tpu_torch.utils.tree import tree_weighted_mean

TOL = dict(rtol=1e-6, atol=1e-7)
TOL_RUN = dict(rtol=1e-5, atol=1e-6)
SIGN_FLIP_2_OF_8 = {"seed": 5, "rules": [
    {"attack": "sign_flip", "ranks": [2, 5], "factor": 10.0}]}


# ------------------------------------------------------------------ inputs
def _stack(k, seed=0, poison=False):
    """Leaves of conv, dense and bias shapes (keys in sorted order, so both
    packages flatten them alike), a global model and [K] sample weights
    with zeros among them; slot 6 planted far away."""
    rs = np.random.RandomState(seed)
    st = {"a_conv": rs.randn(k, 3, 3, 1, 4), "b_dense": rs.randn(k, 16, 6),
          "c_bias": rs.randn(k, 6)}
    st = {key: v.astype(np.float32) for key, v in st.items()}
    st["b_dense"][6] += 25.0
    if poison:
        st["c_bias"][3] = np.inf      # a non-finite slot
        st["a_conv"][5] *= 40.0       # a norm outlier
    g = {key: rs.randn(*v.shape[1:]).astype(np.float32)
         for key, v in st.items()}
    w = (np.abs(rs.randn(k)) * 7 + 1).astype(np.float32).round()
    w[[1, k - 1]] = 0.0
    return st, g, w


def _port(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _jax(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def _close(got: dict, want: dict, **tol):
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   err_msg=k, **(tol or TOL))


def _equal(got: dict, want: dict):
    for k in want:
        assert got[k].numpy().tobytes() == np.asarray(want[k]).tobytes(), k


# -------------------------------------------------------------- estimators
@pytest.mark.parametrize("k", [8, 10])
@pytest.mark.parametrize("weights", ["uniform", "with_zeros"])
@pytest.mark.parametrize("name", ["median", "krum"])
def test_selections_are_the_jax_ones_bitwise(name, weights, k):
    """The weighted median and Krum's pick are selections: bitwise the JAX
    package's, and Krum's suspected slots too (the planted slot among
    them)."""
    st, _, w = _stack(k, seed=k)
    if weights == "uniform":
        w = np.ones(k, np.float32)
    if name == "median":
        _equal(P.weighted_median(_port(st), torch.from_numpy(w)),
               J.weighted_median(_jax(st), jnp.asarray(w)))
        return
    got, ginfo = P.krum(_port(st), torch.from_numpy(w), f=2)
    want, winfo = J.krum(_jax(st), jnp.asarray(w), f=2)
    _equal(got, want)
    sus = ginfo["suspected"].numpy()
    np.testing.assert_array_equal(sus, np.asarray(winfo["suspected"]))
    assert sus[6] and sus.sum() == 2


@pytest.mark.parametrize("k", [8, 10])
@pytest.mark.parametrize("name", ["trimmed_mean", "multi_krum",
                                  "geometric_median", "mean"])
def test_arithmetic_estimators_within_tolerance_of_jax(name, k):
    st, _, w = _stack(k, seed=20 + k)
    got, ginfo = P.make_robust_aggregator(name, n=k, f=2)(
        _port(st), torch.from_numpy(w))
    want, winfo = J.make_robust_aggregator(name, n=k, f=2)(
        _jax(st), jnp.asarray(w))
    _close(got, want)
    assert set(ginfo) == set(winfo)
    if "suspected" in winfo:
        np.testing.assert_array_equal(ginfo["suspected"].numpy(),
                                      np.asarray(winfo["suspected"]))


def test_trimmed_mean_matches_numpy_and_refuses_half():
    st, _, _ = _stack(8, seed=2)
    tm = P.weighted_trimmed_mean(_port(st), torch.ones(8), trim=0.25)
    for key in st:
        xs = np.sort(st[key], axis=0)[2:-2]  # drop 2 at each end
        np.testing.assert_allclose(tm[key].numpy(), xs.mean(0), rtol=1e-5,
                                   atol=1e-6)
    with pytest.raises(ValueError, match="trim"):
        P.weighted_trimmed_mean(_port(st), torch.ones(8), trim=0.5)


def test_geometric_median_resists_far_points():
    pts = np.random.RandomState(4).randn(8, 5).astype(np.float32) * 0.1
    pts[6:] += 100.0
    gm = P.geometric_median({"p": torch.from_numpy(pts)}, torch.ones(8),
                            iters=32)
    assert np.linalg.norm(gm["p"].numpy()) < 1.0
    assert np.linalg.norm(pts.mean(0)) > 10.0


@pytest.mark.parametrize("maker", ["make_robust_aggregator",
                                   "make_verdict_estimator"])
@pytest.mark.parametrize("kw", [
    dict(name="mode", n=8), dict(name="krum", n=8, f=3),
    dict(name="multi_krum", n=4, f=1), dict(name="median", n=8, f=8),
    dict(name="mean", n=8, f=-1), dict(name="trimmed_mean", n=8, trim=0.6),
], ids=["unknown", "krum-2f+3", "multi_krum-2f+3", "f-too-big", "f-negative",
        "trim"])
def test_factories_raise_the_jax_errors(maker, kw):
    """Both factories validate as the JAX package's do: the same exception
    type and message, or neither raises."""
    def outcome(mod):
        try:
            getattr(mod, maker)(**kw)
        except ValueError as e:
            return str(e)
        return None

    assert outcome(P) == outcome(J)


def test_quarantine_ledger_api():
    led = P.QuarantineLedger()
    led.record_codes(1, [0, 2, 0, 3], clients=[10, 11, 12, 13])
    assert led.canonical() == [(1, 2, "norm_outlier", 11),
                               (1, 4, "suspected", 13)]
    assert led.counts() == {"norm_outlier": 1, "suspected": 1}
    assert len(led) == 2 and led.for_round(0) == []
    copy = P.QuarantineLedger()
    copy.restore(led.entries())
    assert copy.entries() == led.entries()
    with pytest.raises(ValueError, match="unrecordable"):
        led.record(0, 1, "ok")


# ------------------------------------------------------------- association
@pytest.mark.parametrize("k", [1, 2, 3, 5, 8, 10])
def test_pairwise_association_within_tolerance_of_jax(k):
    st, g, w = _stack(max(k, 8), seed=30 + k)
    st = {key: v[:k] for key, v in st.items()}
    w = w[:k]
    x = st["b_dense"]
    np.testing.assert_allclose(P.pairwise_sum(torch.from_numpy(x)).numpy(),
                               np.asarray(J.pairwise_sum(jnp.asarray(x))),
                               **TOL)
    gws, gtot = P.pairwise_weighted_stats(_port(st), torch.from_numpy(w))
    jws, jtot = J.pairwise_weighted_stats(_jax(st), jnp.asarray(w))
    _close(gws, jws, rtol=1e-6, atol=1e-5)
    assert float(gtot) == float(jtot)
    _close(P.pairwise_finalize(gws, gtot, _port(g)),
           J.pairwise_finalize(jws, jtot, _jax(g)))
    zero = torch.zeros(())
    _equal(P.pairwise_finalize(gws, zero, _port(g)), g)  # nothing survived


@pytest.mark.parametrize("k", range(1, 11))
def test_block_folds_compose_bitwise(k):
    """The canonical association's contract, on the port's ops: folding
    contiguous power-of-two blocks and then the block partials is bitwise
    the flat fold — for the plain sum and for the weighted stats."""
    st, _, w = _stack(10, seed=40 + k)
    st = _port({key: v[:k] for key, v in st.items()})
    w = torch.from_numpy(w[:k])
    flat = P.pairwise_sum(st["b_dense"])
    fws, ftot = P.pairwise_weighted_stats(st, w)
    for block in (1, 2, 4, 8):
        starts = range(0, k, block)
        parts = torch.stack([P.pairwise_sum(st["b_dense"][s:s + block])
                             for s in starts])
        assert torch.equal(P.pairwise_sum(parts), flat), block
        stats = [P.pairwise_weighted_stats(
            {key: v[s:s + block] for key, v in st.items()}, w[s:s + block])
            for s in starts]
        for key in st:
            got = P.pairwise_sum(torch.stack([ws[key] for ws, _ in stats]))
            assert torch.equal(got, fws[key]), (block, key)
        assert torch.equal(P.pairwise_sum(torch.stack(
            [tot for _, tot in stats])), ftot)


# ------------------------------------------------------------------ sketch
@pytest.mark.parametrize("n", [1, 7, 64, 4096, 100_003])
def test_sketch_signs_are_jax_rademacher_bitwise(n):
    want = np.asarray(jax.random.rademacher(
        jax.random.PRNGKey(0x5EDC0FFE), (n,), jnp.float32))
    got = P.sketch_signs(n)
    assert got.dtype == np.float32 and got.tobytes() == want.tobytes()


def _model_state(name, k, seed):
    """A stacked state of a port model (random values) and its global."""
    kw = (dict(vocab_size=32, dim=16, depth=1, num_heads=4, max_len=8)
          if name == "transformer" else dict(output_dim=10))
    module = create_model(name, device="cpu", **kw)
    if name == "lr":
        module(torch.zeros(1, 8, 8, 1))  # materializes the lazy layer
    gen = torch.Generator().manual_seed(seed)
    stacked = {key: torch.randn((k,) + v.shape, generator=gen)
               for key, v in module.state_dict().items()}
    return stacked, {key: torch.randn(v.shape[1:], generator=gen)
                     for key, v in stacked.items()}, module


@pytest.mark.parametrize("name", ["cnn", "lr", "transformer"])
def test_reference_order_is_the_wire_order(name):
    """The sketch flattens a model's update as the JAX package flattens its
    flax params: the reordered row is the concatenated wire leaves."""
    stacked, _, module = _model_state(name, 2, 1)
    spec = tuple((key, tuple(v.shape[1:])) for key, v in stacked.items())
    perm = P.reference_order(spec)
    flat = torch.cat([v.reshape(2, -1) for v in stacked.values()], 1)
    heads = convert.num_heads_of(module)
    for i in range(2):
        want = np.concatenate([np.ravel(leaf) for leaf in pack_pytree(
            {key: v[i] for key, v in stacked.items()}, heads)])
        np.testing.assert_array_equal(flat[i, torch.tensor(perm)].numpy(),
                                      want)


@pytest.mark.parametrize("name", ["plain", "lr", "cnn"])
def test_update_sketch_within_tolerance_of_jax(name):
    if name == "plain":
        st, g, _ = _stack(8, seed=5, poison=True)
        pst, pg, jst, jg = _port(st), _port(g), _jax(st), _jax(g)
    else:
        pst, pg, _ = _model_state(name, 3, 2)
        to_j = lambda s: jax.tree.map(jnp.asarray, convert.to_flax(s))
        jst = jax.tree.map(lambda *xs: jnp.stack(xs), *[
            to_j({key: v[i] for key, v in pst.items()}) for i in range(3)])
        jg = to_j(pg)
    got = P.update_sketch(pst, pg).numpy()
    want = np.asarray(J.update_sketch(jst, jg))
    np.testing.assert_allclose(got, want, rtol=1e-6,
                               atol=1e-6 * np.abs(want).max())
    assert P.update_sketch(pst, pg, sketch_dim=0).shape == (got.shape[0], 0)


@pytest.mark.parametrize("norm_mult", [None, 4.0], ids=["disarmed", "armed"])
@pytest.mark.parametrize("name", P.AGGREGATORS)
def test_evidence_verdicts_match_jax(name, norm_mult):
    """Each verdict estimator over each package's own evidence: the reason
    codes equal, the verdict weights within 1e-6."""
    st, g, w = _stack(10, seed=7, poison=True)
    vw, reasons = P.evidence_verdicts(
        P.update_evidence(_port(st), _port(g), torch.from_numpy(w)),
        P.make_verdict_estimator(name, n=10, f=2), norm_mult=norm_mult)
    jvw, jreasons = J.evidence_verdicts(
        J.update_evidence(_jax(st), _jax(g), jnp.asarray(w)),
        J.make_verdict_estimator(name, n=10, f=2), norm_mult=norm_mult)
    np.testing.assert_array_equal(reasons.numpy(), np.asarray(jreasons))
    np.testing.assert_allclose(vw.numpy(), np.asarray(jvw), rtol=1e-6,
                               atol=1e-6 * float(np.abs(jvw).max()))
    assert reasons.dtype == torch.int32


def test_verdicts_exclude_sign_flippers_without_the_gate():
    rs = np.random.RandomState(3)
    base = rs.randn(6, 2).astype(np.float32)
    rows = np.stack([base + 0.1 * rs.randn(6, 2).astype(np.float32)
                     for _ in range(8)])
    for bad in (1, 4):
        rows[bad] = base - 10.0 * (rows[bad] - base)
    st, g = {"w": torch.from_numpy(rows)}, {"w": torch.from_numpy(base)}
    for name in ("krum", "multi_krum", "median"):
        vw, _ = P.evidence_verdicts(
            P.update_evidence(st, g, torch.ones(8)),
            P.make_verdict_estimator(name, n=8, f=2), norm_mult=None)
        sel = set(np.flatnonzero(vw.numpy() > 0).tolist())
        assert sel and not sel & {1, 4}, (name, sel)


# ---------------------------------------------------------- gated_aggregate
COMBOS = ([("gate", dict(norm_mult=4.0))]
          + [(f"gate+{n}", dict(norm_mult=4.0, robust=n))
             for n in P.AGGREGATORS if n != "mean"]
          + [("krum-ungated", dict(robust="krum")),
             ("pairwise", dict(pairwise=True)),
             ("pairwise+gate", dict(pairwise=True, norm_mult=4.0))]
          + [(f"verdict-{n}", dict(norm_mult=4.0, verdict=n))
             for n in P.AGGREGATORS]
          + [("verdict-krum-ungated", dict(verdict="krum"))])


def _gated(mod, st, g, w, norm_mult=None, robust=None, pairwise=False,
           verdict=None):
    return mod.gated_aggregate(
        st, g, w, norm_mult=norm_mult, pairwise=pairwise,
        robust_fn=None if robust is None else mod.make_robust_aggregator(
            robust, n=10, f=2),
        verdict_fn=None if verdict is None else mod.make_verdict_estimator(
            verdict, n=10, f=2))


@pytest.mark.parametrize("label,kw", COMBOS, ids=[c[0] for c in COMBOS])
def test_gated_aggregate_matches_jax(label, kw):
    """Every composition: the reason codes of the JAX package, the survivor
    weights equal, the average within 1e-6 (finite: no poisoned slot
    reaches it)."""
    st, g, w = _stack(10, seed=9, poison=True)
    avg, w_out, reasons = _gated(P, _port(st), _port(g), torch.from_numpy(w),
                                 **kw)
    javg, jw, jreasons = _gated(J, _jax(st), _jax(g), jnp.asarray(w), **kw)
    if jreasons is None:
        assert reasons is None
    else:
        np.testing.assert_array_equal(reasons.numpy(), np.asarray(jreasons))
    np.testing.assert_allclose(w_out.numpy(), np.asarray(jw), rtol=1e-6,
                               atol=1e-6 * float(np.abs(jw).max()))
    _close(avg, javg, rtol=1e-6, atol=1e-6)
    if kw.get("norm_mult"):
        assert all(bool(torch.isfinite(v).all()) for v in avg.values())


@pytest.mark.parametrize("kw", [dict(norm_mult=4.0),
                                dict(norm_mult=4.0, robust="median"),
                                dict(norm_mult=4.0, verdict="krum"),
                                dict(norm_mult=4.0, pairwise=True)],
                         ids=["gate", "median", "verdict-krum", "pairwise"])
def test_all_rejected_round_keeps_the_global_model(kw):
    st, g, w = _stack(10, seed=11)
    st = {key: np.full_like(v, np.nan) for key, v in st.items()}
    avg, w_out, reasons = _gated(P, _port(st), _port(g), torch.from_numpy(w),
                                 **kw)
    _equal(avg, g)
    assert float(w_out.sum()) == 0.0
    assert set(reasons.numpy()[w > 0].tolist()) == {P.REASON_NONFINITE}


def test_gated_aggregate_refuses_what_the_reference_refuses():
    st, g, w = _stack(8, seed=12)
    st, g, w = _port(st), _port(g), torch.from_numpy(w)
    med = P.make_robust_aggregator("median", n=8)
    vf = P.make_verdict_estimator("krum", n=8, f=2)
    with pytest.raises(ValueError, match="weighted-mean contract"):
        P.gated_aggregate(st, g, w, robust_fn=med, pairwise=True)
    with pytest.raises(ValueError, match="does not stack"):
        P.gated_aggregate(st, g, w, verdict_fn=vf, pairwise=True)
    with pytest.raises(ValueError, match="does not stack"):
        P.gated_aggregate(st, g, w, verdict_fn=vf, robust_fn=med)
    with pytest.raises(NotImplementedError, match="queue A, item 12"):
        P.gated_aggregate(st, g, w, reshard_fn=lambda s: s)


def test_sanitize_survivor_reweighting_is_exact():
    """The gate zeroes the non-finite and the outlier slots; the mean over
    the gated stack is the numpy mean over exactly the survivors."""
    st, g, w = _stack(8, seed=6, poison=True)
    clean, w2, reasons = P.sanitize_updates(_port(st), _port(g),
                                            torch.from_numpy(w))
    codes = reasons.numpy()
    assert codes[3] == P.REASON_NONFINITE and codes[5] == P.REASON_NORM_OUTLIER
    assert codes[6] == P.REASON_NORM_OUTLIER  # the planted slot
    got = tree_weighted_mean(clean, w2)
    keep = [i for i in range(8) if codes[i] == P.REASON_OK]
    assert keep == [0, 1, 2, 4, 7]
    wn = w[keep].astype(np.float64)
    for key in st:
        oracle = np.tensordot(wn / wn.sum(), st[key][keep], axes=([0], [0]))
        np.testing.assert_allclose(got[key].numpy(), oracle, rtol=1e-6,
                                   atol=1e-6)


# ---------------------------------------------------------------- injector
def _attack_pair(spec, k=6, seed=0):
    rs = np.random.RandomState(seed)
    st = {"a": rs.randn(k, 4, 3).astype(np.float32),
          "b": rs.randn(k, 5).astype(np.float32),
          "n": np.arange(k * 2, dtype=np.int32).reshape(k, 2)}
    g = {"a": rs.randn(4, 3).astype(np.float32),
         "b": rs.randn(5).astype(np.float32), "n": np.zeros(2, np.int32)}
    return (make_in_graph_injector(chaos.AdversaryPlan.from_json(spec), k),
            jax_injector(jax_chaos.AdversaryPlan.from_json(spec), k), st, g)


@pytest.mark.parametrize("attack", ["sign_flip", "scale", "nan", "shift"])
def test_injector_matches_jax(attack):
    """Attacks on ranks 2 and 5 in rounds [1, 3): the JAX injector's values
    within 1e-6, NaN exactly where it has NaN, integer leaves and honest
    slots untouched."""
    spec = {"seed": 3, "rules": [{"attack": attack, "ranks": [2, 5],
                                  "rounds": [1, 3], "factor": 7.0,
                                  "z": 1.5}]}
    port, ref, st, g = _attack_pair(spec)
    for rnd in range(4):
        got = port(_port(st), _port(g), rnd)
        want = ref(_jax(st), _jax(g), jnp.int32(rnd))
        for key in st:
            a, b = got[key].numpy(), np.asarray(want[key])
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)
        changed = {i for i in range(6)
                   if not np.array_equal(got["a"].numpy()[i], st["a"][i],
                                         equal_nan=False)}
        assert changed == ({1, 4} if rnd in (1, 2) else set()), rnd
        assert np.array_equal(got["n"].numpy(), st["n"])


def test_injector_slices_the_slot_mask_to_the_stack():
    spec = {"seed": 0, "rules": [{"attack": "nan", "ranks": [2, 6]}]}
    port, _, st, g = _attack_pair(spec)
    small = {key: v[:3] for key, v in st.items()}
    got = port(_port(small), _port(g), 0)
    assert [bool(np.isnan(got["b"].numpy()[i]).all()) for i in range(3)] == \
        [False, True, False]


def test_gaussian_injector_schedule_statistics_and_replay():
    """``gaussian`` draws from torch's generator, not jax's fold_in chain:
    the same slots and rounds are hit as in the JAX package, the draw is
    N(0, sigma^2) (mean within 0.05, std within 3 %), and a replay of the
    same plan is bitwise."""
    spec = {"seed": 9, "rules": [{"attack": "gaussian", "ranks": [1, 4],
                                  "rounds": [0, 2], "sigma": 0.5}]}
    rs = np.random.RandomState(1)
    st = {"w": rs.randn(5, 40, 50).astype(np.float32)}
    g = {"w": np.zeros((40, 50), np.float32)}
    port = make_in_graph_injector(chaos.AdversaryPlan.from_json(spec), 5)
    again = make_in_graph_injector(chaos.AdversaryPlan.from_json(spec), 5)
    ref = jax_injector(jax_chaos.AdversaryPlan.from_json(spec), 5)
    draws = []
    for rnd in range(3):
        got = port(_port(st), _port(g), rnd)["w"].numpy()
        want = np.asarray(ref(_jax(st), _jax(g), jnp.int32(rnd))["w"])
        hit = lambda a: [i for i in range(5) if not np.array_equal(a[i],
                                                                   st["w"][i])]
        assert hit(got) == hit(want) == ([0, 3] if rnd < 2 else [])
        assert got.tobytes() == again(_port(st), _port(g), rnd)["w"] \
            .numpy().tobytes()
        if rnd < 2:
            draws.append((got - st["w"])[[0, 3]])
    noise = np.concatenate([d.ravel() for d in draws])
    assert abs(noise.mean()) < 0.05 and abs(noise.std() / 0.5 - 1) < 0.03
    assert not np.array_equal(draws[0], draws[1])  # a fresh draw a round


# ------------------------------------------------------------------ engine
DATA_KW = dict(num_clients=8, image_shape=(8, 8, 1), num_classes=4,
               samples_per_client=24, test_samples=96, seed=3)


def _cfg(rounds=3, **kw):
    return dict(comm_round=rounds, client_num_in_total=8,
                client_num_per_round=8, epochs=1, batch_size=8, lr=0.1,
                frequency_of_the_test=1, seed=0, **kw)


@pytest.fixture(scope="module")
def lr_setup():
    """Both packages' data (bitwise equal) and tasks; the port's task
    inits to the JAX engine's initial params."""
    jdata = jax_synthetic_images(**DATA_KW)
    jtask = jax_classification_task(JaxLR(num_classes=4))
    _, key = jax.random.split(jax.random.PRNGKey(0))
    params = jax.tree.map(np.asarray, jtask.init(
        key, jnp.asarray(jdata.train_x[:8])).params)
    state = convert.from_flax(params)
    task = classification_task(create_model("lr", output_dim=4, device="cpu"))
    task = task._replace(init=lambda g, x=None: {k: v.clone()
                                                 for k, v in state.items()})
    return dict(data=synthetic_images(**DATA_KW), task=task, jdata=jdata,
                jtask=jtask)


def _plan(spec=SIGN_FLIP_2_OF_8):
    return chaos.AdversaryPlan.from_json(spec)


def _engine(s, rounds=3, **kw):
    api = FedAvgAPI(s["data"], s["task"], FedAvgConfig(**_cfg(rounds)),
                    device="cpu", **kw)
    for r in range(rounds):
        api.run_round(r)
    return api


def _jax_engine(s, rounds=3, **kw):
    api = JaxFedAvgAPI(s["jdata"], s["jtask"], JaxConfig(**_cfg(rounds)), **kw)
    for r in range(rounds):
        api.run_round(r)
    return api


@pytest.mark.parametrize("aggregator,params", [
    ("krum", {"f": 2}), ("median", None), ("multi_krum", {"f": 2}),
    ("trimmed_mean", None), ("geometric_median", None)])
def test_engine_under_attack_matches_jax(lr_setup, aggregator, params):
    """FedAvgAPI under SIGN_FLIP_2_OF_8 behind the default gate: the ledger
    is the JAX engine's entry for entry, the params within 1e-5."""
    kw = dict(aggregator=aggregator, aggregator_params=params)
    port = _engine(lr_setup, adversary_plan=_plan(), **kw)
    ref = _jax_engine(lr_setup, adversary_plan=jax_chaos.AdversaryPlan
                      .from_json(SIGN_FLIP_2_OF_8), **kw)
    assert port.quarantine.canonical() == ref.quarantine.canonical()
    assert {e[1] for e in port.quarantine.canonical()} >= {2, 5}
    for a, b in zip(pack_pytree(port.net), jax_pack(ref.net)):
        np.testing.assert_allclose(a, np.asarray(b), **TOL_RUN)


def test_sign_flip_attack_defense_acceptance(lr_setup):
    """2-of-8 sign-flippers (factor 10): plain FedAvg's eval loss diverges
    while krum and median converge below the initial loss; the krum run
    replays bit for bit; the gate names ranks 2 and 5."""
    l0 = float(_engine(lr_setup, rounds=0).evaluate()["loss"])
    plain = _engine(lr_setup, rounds=4, adversary_plan=_plan())
    l_plain = float(plain.evaluate()["loss"])
    assert not np.isfinite(l_plain) or l_plain > 2.0 * l0
    assert len(plain.quarantine) == 0
    runs = []
    for _ in range(2):
        k = _engine(lr_setup, rounds=4, adversary_plan=_plan(),
                    aggregator="krum", aggregator_params={"f": 2})
        runs.append((pack_pytree(k.net), k.quarantine.canonical(),
                     float(k.evaluate()["loss"])))
    (net_a, led_a, loss_k), (net_b, led_b, _) = runs
    assert all(a.tobytes() == b.tobytes() for a, b in zip(net_a, net_b))
    assert led_a == led_b and len(led_a) > 0 and loss_k < l0
    med = _engine(lr_setup, rounds=4, adversary_plan=_plan(),
                  aggregator="median")
    assert float(med.evaluate()["loss"]) < l0
    flagged = {(e[0], e[1]) for e in med.quarantine.canonical()
               if e[2] == "norm_outlier"}
    assert {(0, 2), (0, 5)} <= flagged


def test_engine_takes_a_callable_aggregator(lr_setup):
    """``aggregator`` may be a ``(stacked, weights) -> (state, info)``
    callable, as in the reference: the median's factory passed as one
    runs the named median's rounds bitwise, gate armed alike."""
    named = _engine(lr_setup, adversary_plan=_plan(), aggregator="median")
    called = _engine(lr_setup, adversary_plan=_plan(),
                     aggregator=P.make_robust_aggregator("median", n=8))
    assert named.quarantine.entries() == called.quarantine.entries()
    assert all(torch.equal(named.net[k], called.net[k]) for k in named.net)


def test_run_rounds_is_the_run_round_loop_bitwise(lr_setup):
    kw = dict(adversary_plan=_plan(), aggregator="krum",
              aggregator_params={"f": 2})
    seq = _engine(lr_setup, rounds=3, **kw)
    blk = FedAvgAPI(lr_setup["data"], lr_setup["task"],
                    FedAvgConfig(**_cfg(3)), device="cpu", device_data=True,
                    **kw)
    ms = blk.run_rounds(0, 3)
    assert ms["count"].shape == (3,) and "__quarantine" not in ms
    assert all(a.tobytes() == b.tobytes()
               for a, b in zip(pack_pytree(seq.net), pack_pytree(blk.net)))
    assert seq.quarantine.canonical() == blk.quarantine.canonical()


def test_default_round_is_the_plain_round(lr_setup, monkeypatch):
    """All four options at their defaults: the round runs the plain ops
    (batched fit -> weighted mean) and nothing of the robust path — no
    gate, no ledger read — and lands on the plain build's params
    bitwise."""
    def refuse(*a, **k):
        raise AssertionError("the default round reached the robust path")

    monkeypatch.setattr(port_fedavg, "gated_aggregate", refuse)
    monkeypatch.setattr(P.QuarantineLedger, "record_codes", refuse)
    api = FedAvgAPI(lr_setup["data"], lr_setup["task"],
                    FedAvgConfig(**_cfg(2)), device="cpu")
    plain = {k: v.clone() for k, v in api.net.items()}
    for r in range(2):
        x, y, mask, nsamp = api._round_batch(r, api._sampled_ids(r))
        nets, _ = api.local_update(plain, x, y, mask)
        plain = tree_weighted_mean(nets, nsamp)
        api.run_round(r)
    assert all(torch.equal(api.net[k], plain[k]) for k in plain)
    assert len(api.quarantine) == 0


def test_telemetry_round_record_carries_the_quarantine(lr_setup):
    from fedml_tpu_torch.obs.telemetry import Telemetry

    tel = Telemetry()
    api = FedAvgAPI(lr_setup["data"], lr_setup["task"],
                    FedAvgConfig(**_cfg(2)), device="cpu", telemetry=tel,
                    adversary_plan=_plan({"seed": 0, "rules": [
                        {"attack": "nan", "ranks": [3], "rounds": [1, 2]}]}),
                    sanitize=True)
    api.run_round(0)
    api.run_round(1)
    rounds = [e for e in tel.events.sink.records if e["kind"] == "round"]
    tel.close()
    assert "quarantine" not in rounds[0]
    assert rounds[1]["quarantine"] == [
        {"round": 1, "rank": 3, "reason": "nonfinite",
         "client": int(api._sampled_ids(1)[2])}]


# ---------------------------------------------------------------- loopback
def test_loopback_krum_ledger_is_the_engines_and_jaxs(lr_setup):
    """run_simulated(aggregator='krum') under SIGN_FLIP_2_OF_8: the ledger
    equals the port's engine's and the JAX package's loopback run's entry
    for entry, a second run replays it and its model bitwise, and the
    models agree within 1e-5."""
    kw = dict(aggregator="krum", aggregator_params={"f": 2})
    runs = [run_simulated(lr_setup["data"], lr_setup["task"],
                          FedAvgConfig(**_cfg()), job_id=f"t-torch-byz-{i}",
                          adversary_plan=_plan(), device="cpu", **kw)
            for i in range(2)]
    ref = jax_api.run_simulated(
        lr_setup["jdata"], lr_setup["jtask"], JaxConfig(**_cfg()),
        job_id="t-jax-byz", adversary_plan=jax_chaos.AdversaryPlan.from_json(
            SIGN_FLIP_2_OF_8), **kw)
    engine = _engine(lr_setup, adversary_plan=_plan(), **kw)
    led = runs[0].quarantine.canonical()
    assert len(led) > 0 and led == runs[1].quarantine.canonical() == \
        ref.quarantine.canonical() == engine.quarantine.canonical()
    leaves = [pack_pytree(a.net) for a in runs]
    assert all(a.tobytes() == b.tobytes() for a, b in zip(*leaves))
    for a, b, c in zip(leaves[0], jax_pack(ref.net), pack_pytree(engine.net)):
        np.testing.assert_allclose(a, np.asarray(b), **TOL_RUN)
        np.testing.assert_allclose(a, c, **TOL_RUN)


def test_loopback_two_phase_median_matches_jax(lr_setup):
    """sum_assoc='pairwise' with an aggregator runs the two-phase
    composition: the medoid verdicts' ledger is the JAX run's and the
    engine cannot run it, so the model is held to the JAX run's."""
    kw = dict(aggregator="median", sum_assoc="pairwise")
    port = run_simulated(lr_setup["data"], lr_setup["task"],
                         FedAvgConfig(**_cfg()), job_id="t-torch-byz-2ph",
                         adversary_plan=_plan(), device="cpu", **kw)
    ref = jax_api.run_simulated(
        lr_setup["jdata"], lr_setup["jtask"], JaxConfig(**_cfg()),
        job_id="t-jax-byz-2ph", adversary_plan=jax_chaos.AdversaryPlan
        .from_json(SIGN_FLIP_2_OF_8), **kw)
    assert port.quarantine.canonical() == ref.quarantine.canonical()
    assert {e[1] for e in port.quarantine.canonical()} >= {2, 5}
    for a, b in zip(pack_pytree(port.net), jax_pack(ref.net)):
        np.testing.assert_allclose(a, np.asarray(b), **TOL_RUN)


@pytest.mark.parametrize("agg_kw", [{}, {"aggregator": "median"},
                                    {"aggregator": "krum",
                                     "sum_assoc": "pairwise"}],
                         ids=["gate", "median", "two-phase-krum"])
def test_nan_upload_never_reaches_the_mean(lr_setup, agg_kw):
    """A NaN upload is quarantined at aggregate time with any estimator
    (and with none): the model stays finite and, for the plain gate,
    equals the sample-weighted mean of the finite uploads only."""
    agg = FedAvgAggregator(lr_setup["data"], lr_setup["task"],
                           FedAvgConfig(**_cfg()), worker_num=8,
                           device="cpu", **agg_kw)
    base = pack_pytree(agg.net)
    agg.begin_round(0)
    ups = {}
    for r in range(8):
        up = [v + np.float32(0.01 * (r + 1)) for v in base]
        if r == 3:
            up = [np.full_like(v, np.nan) for v in up]
        ups[r] = up
        agg.add_local_trained_result(r, up, 10 + r, round_idx=0)
    out = agg.aggregate()
    assert all(np.isfinite(leaf).all() for leaf in out)
    ids = agg.client_sampling(0)
    assert (0, 4, "nonfinite", int(ids[3])) in agg.quarantine.canonical()
    if not agg_kw:
        survivors = [r for r in range(8) if r != 3]
        wn = np.asarray([10 + r for r in survivors], np.float64)
        for i, leaf in enumerate(out):
            oracle = sum(w * ups[r][i].astype(np.float64)
                         for w, r in zip(wn, survivors)) / wn.sum()
            np.testing.assert_allclose(leaf, oracle, rtol=1e-5, atol=1e-6)


def test_all_uploads_quarantined_keeps_the_global_model(lr_setup):
    agg = FedAvgAggregator(lr_setup["data"], lr_setup["task"],
                           FedAvgConfig(**_cfg()), worker_num=8,
                           device="cpu", aggregator="krum",
                           aggregator_params={"f": 2})
    before = pack_pytree(agg.net)
    agg.begin_round(0)
    for r in range(8):
        agg.add_local_trained_result(
            r, [np.full_like(v, np.nan) for v in before], 10, round_idx=0)
    out = agg.aggregate()
    assert all(a.tobytes() == b.tobytes() for a, b in zip(out, before))
    assert agg.quarantine.counts() == {"nonfinite": 8}


def test_server_refuses_an_unknown_sum_assoc(lr_setup):
    with pytest.raises(ValueError, match="sum_assoc"):
        FedAvgAggregator(lr_setup["data"], lr_setup["task"],
                         FedAvgConfig(**_cfg()), worker_num=8, device="cpu",
                         sum_assoc="tree")


# ---------------------------------------------------------------- launcher
def test_launcher_runs_a_robust_job_under_attack(lr_setup):
    """``--aggregator krum --byzantine_f 1 --adversary_plan '<json>'``: a
    2-round loopback job of the launcher's ranks as threads in this
    process (1 server + 5 clients; krum needs n >= 2f + 3); rank 0 prints
    a finite history, and the attacked rank is named in every round."""
    plan = json.dumps({"seed": 2, "rules": [
        {"attack": "sign_flip", "ranks": [3], "factor": 10.0}]})
    argv = ["--world_size", "6", "--backend", "loopback", "--dataset",
            "mnist", "--model", "lr", "--comm_round", "2",
            "--client_num_in_total", "10", "--batch_size", "8",
            "--frequency_of_the_test", "1", "--device", "cpu",
            "--aggregator", "krum", "--byzantine_f", "1",
            "--adversary_plan", plan]
    seen, errors = {}, []
    from fedml_tpu_torch.distributed.fedavg import api as dist_api

    orig = dist_api.init_server

    def spy(*a, **k):
        mgr = orig(*a, **k)
        seen["agg"] = mgr.aggregator
        return mgr

    def rank(r):
        try:
            distributed_launch.main(["--rank", str(r), *argv])
        except BaseException as e:  # noqa: BLE001 — re-raised below
            errors.append(e)

    out = io.StringIO()
    dist_api.init_server = spy
    threads = [threading.Thread(target=rank, args=(r,)) for r in range(1, 6)]
    try:
        for t in threads:
            t.start()
        # the loopback transport delivers only to registered ranks: the
        # server starts once every client listens, as a launch script
        # starts the clients first
        deadline = time.monotonic() + 60
        while set(loopback._registry.get("launch", {})) != {1, 2, 3, 4, 5}:
            assert time.monotonic() < deadline and not errors, errors
            time.sleep(0.02)
        with redirect_stdout(out):
            rank(0)
        for t in threads:
            t.join(timeout=0 if errors else 60)
    finally:
        dist_api.init_server = orig
        for mgr in list(loopback._registry.get("launch", {}).values()):
            mgr.stop_receive_message()  # a failed run must not leave ranks
        for t in threads:
            t.join(timeout=10)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    history = json.loads(out.getvalue().strip().splitlines()[-1])
    assert [h["round"] for h in history] == [0, 1]
    assert all(np.isfinite(h["test_loss"]) for h in history)
    led = seen["agg"].quarantine.canonical()
    assert {(e[0], e[1]) for e in led} >= {(0, 3), (1, 3)}
    assert seen["agg"].sum_assoc == "auto"
