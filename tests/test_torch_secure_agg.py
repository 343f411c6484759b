"""Masked secure aggregation in the port (collectives/finite_field.py,
core/secure_agg.py, utils/prng.randint, utils/tree.tree_vectorize,
algorithms/turboaggregate.py) against the JAX package's, on
tests/test_secure_agg.py's tiny configuration (8 synthetic clients of
6x6x1 images, 3 classes, LogisticRegression).

Tolerances: every integer result bitwise the JAX package's — the PRG (at
the main path's full width too, and for seeds at or past 2^31), pair masks,
masked uploads, Shamir shares (``prng.randint`` is ``jax.random.randint``),
recovered seeds, unmasked and decoded sums, Lagrange coefficients, the
field quantizer; the flat vector in the JAX package's coordinate order
bitwise. The engine within the port's engine tolerance (1e-5) of the JAX
engine, and within the quantization bound K * 0.5 / quant_scale of the
port's own FedAvg round from the same weights. The helpers below
(``secagg_setup``, the stall driver) serve the wire and tree files too.
"""

from __future__ import annotations

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from fedml_tpu.algorithms.fedavg import FedAvgConfig as JaxConfig
from fedml_tpu.algorithms.turboaggregate import TurboAggregateAPI as JaxTA
from fedml_tpu.collectives import finite_field as jff
from fedml_tpu.core import secure_agg as jsa
from fedml_tpu.core.tasks import classification_task as jax_classification_task
from fedml_tpu.data.synthetic import synthetic_images as jax_synthetic_images
from fedml_tpu.models.linear import LogisticRegression as JaxLR
from fedml_tpu.utils.tree import tree_vectorize as jax_tree_vectorize
from fedml_tpu_torch import convert
from fedml_tpu_torch.algorithms import FedAvgAPI, FedAvgConfig
from fedml_tpu_torch.algorithms.turboaggregate import TurboAggregateAPI
from fedml_tpu_torch.collectives import finite_field as ff
from fedml_tpu_torch.comm.message import pack_pytree
from fedml_tpu_torch.core import secure_agg as sa
from fedml_tpu_torch.core.tasks import classification_task
from fedml_tpu_torch.data.synthetic import synthetic_images
from fedml_tpu_torch.models import create_model
from fedml_tpu_torch.utils import prng
from fedml_tpu_torch.utils.tree import tree_unvectorize, tree_vectorize

DATA_KW = dict(num_clients=8, image_shape=(6, 6, 1), num_classes=3,
               samples_per_client=12, test_samples=24, seed=0)
# the port's engines against the JAX package's (test_torch_privacy.py)
TOL = dict(rtol=1e-5, atol=1e-6)
# the main path's vector: CNNOriginalFedAvg's parameter count
MAIN_WIDTH = 1_690_046
# elastic runs arm their watchdogs with this deadline and never wait it
# out: the stall driver calls on_timeout at the state the deadline finds
FAR_DEADLINE_S = 600.0


def cfg_kw(rounds=2, per_round=3, seed=0, freq=1):
    return dict(comm_round=rounds, client_num_in_total=8,
                client_num_per_round=per_round, epochs=1, batch_size=6,
                lr=0.1, frequency_of_the_test=freq, seed=seed)


def secagg_setup():
    """Both packages' data (bitwise equal) and tasks; the port's task
    inits to the JAX run's initial params (its split(PRNGKey(0))[1]
    draw)."""
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


def leaves_close(port_net, jax_params, **tol):
    for a, b in zip(pack_pytree(port_net), jax.tree.leaves(jax_params)):
        np.testing.assert_allclose(a, np.asarray(b), **(tol or TOL))


def same_bits(a: dict, b: dict) -> bool:
    return all(torch.equal(a[k], b[k]) for k in a)


# ------------------------------------------------------------ stall driver
def _crashed(plan, rank, round_idx) -> bool:
    return plan is not None and any(
        r.fault == "crash" and rank in (r.ranks or ())
        and r.in_window(round_idx) for r in plan.rules)


def _uploads_dropped(plan, rank, round_idx) -> int:
    if plan is None:
        return 0
    return sum(1 for e in plan.ledger.for_round(round_idx, ("drop",))
               if e["direction"] == "send" and e["src"] == rank
               and e["dst"] == 0)


def _server_stall(s, plan, opened) -> str | None:
    """What a server's deadline would do now (either package), or None:
    ``backstop`` when only dark ranks owe the resume probe an answer,
    ``timeout`` when every upload that can still arrive this round has
    (the rest crashed, undeliverable, or dropped on this attempt)."""
    if s._finished.is_set():
        return None
    if getattr(s, "_resume_round", None) is not None:
        pend = s._resume_pending
        if pend and all(r in s._undeliverable
                        or _crashed(plan, r, s._resume_round) for r in pend):
            return "backstop"
        return None
    r = s.round_idx
    if (r >= s.round_num or getattr(s, "_phase", "uploads") != "uploads"
            or not opened.get(r)):
        return None
    flags = s.aggregator.flag_client_model_uploaded
    if all(flags.values()):
        return None
    for i, up in flags.items():
        rank = i + 1
        if not (up or rank in s._undeliverable
                or _uploads_dropped(plan, rank, r) >= opened[r]):
            return None
    return "timeout"


def _edge_stall(e, plan) -> bool:
    if (e._round is None or e._forwarded or e._mreveal is not None
            or not e._mslots or len(e._mslots) == len(e._slots)):
        return False
    return all(s in e._mslots
               or _crashed(plan, e.topology.worker_rank(s), e._round)
               for s in e._slots)


def _fire(fn, *args) -> bool:
    """Call a deadline's action as the watchdog thread does: a simulated
    server crash it raises ends this generation (run() re-raises it)."""
    try:
        fn(*args)
    except BaseException as e:  # noqa: BLE001 — the watchdog's contract
        if type(e).__name__ != "SimulatedServerCrash":
            raise
        return False
    return True


def _drive(mgr, plan_of, stop, edge: bool):
    opened: dict[int, int] = {}
    if not edge:
        # count each round's broadcasts (a shed round is re-broadcast):
        # the n-th attempt's uploads are lost only if dropped n times
        begin = mgr.aggregator.begin_round

        def counted(round_idx, begin=begin):
            opened[int(round_idx)] = opened.get(int(round_idx), 0) + 1
            return begin(round_idx)

        mgr.aggregator.begin_round = counted
    while not stop.wait(0.002) and not mgr._finished.is_set():
        plan = plan_of()
        if edge:
            with mgr._lock:
                fire = _edge_stall(mgr, plan)
            if fire:
                mgr.on_timeout(FAR_DEADLINE_S)
            continue
        with mgr._round_lock:
            act = _server_stall(mgr, plan, opened)
        if act == "backstop" and not _fire(mgr._resume_backstop):
            return
        if act == "timeout" and not _fire(mgr.on_timeout, FAR_DEADLINE_S):
            return


def drive_stalls(monkeypatch):
    """Every masked-tier server, root and edge of either package run while
    this is in force has its deadlines driven (``_drive``): no test waits
    one out."""
    from fedml_tpu import chaos as jax_chaos
    from fedml_tpu.distributed import turboaggregate as jta

    from fedml_tpu_torch import chaos as port_chaos
    from fedml_tpu_torch.distributed import turboaggregate as ta

    for mod, chaos in ((ta, port_chaos), (jta, jax_chaos)):
        for name, edge in (("TASecureServerManager", False),
                           ("HierTASecureServerManager", False),
                           ("TASecureEdgeManager", True)):
            cls = getattr(mod, name)
            run = cls.run

            def driven(self, run=run, edge=edge, chaos=chaos):
                stop = threading.Event()
                t = threading.Thread(target=_drive, args=(
                    self, chaos.active_plan, stop, edge), daemon=True)
                t.start()
                try:
                    return run(self)
                finally:
                    stop.set()
                    t.join()

            monkeypatch.setattr(cls, "run", driven)


@pytest.fixture(scope="module")
def setup():
    return secagg_setup()


# --------------------------------------------------------------- the PRG
@pytest.mark.parametrize("seed", [1, 12345, 2**31 - 2, 2**31, 2**40 + 7,
                                  2**63 - 1, 2**64 - 1, "pair"])
def test_prg_expand_bitwise_numpy_oracle_and_jax(seed):
    """The int64 PRG is the uint64 stream of the JAX package's numpy
    oracle and its jitted expansion, for seeds below, at and past 2^31,
    past 2^63, and a DH pair seed."""
    if seed == "pair":
        seed = sa.pair_seed(sa.secret_key(5, 1, 0), sa.public_key(
            sa.secret_key(5, 1, 3)))
    got = sa.prg_expand(seed, 257, device="cpu").numpy()
    assert np.array_equal(got, jsa.prg_expand_np(seed, 257))
    assert np.array_equal(got, np.asarray(jsa.prg_expand(seed, 257)))
    assert np.array_equal(got, sa.prg_expand_np(seed, 257))
    assert got.min() >= 0 and got.max() < sa.P_DEFAULT


def test_prg_expand_bitwise_at_the_main_paths_width():
    seed = sa.self_mask_seed(0, 3, 7)
    got = sa.prg_expand(seed, MAIN_WIDTH, device="cpu")
    assert got.dtype == torch.int64 and got.shape == (MAIN_WIDTH,)
    assert np.array_equal(got.numpy(), jsa.prg_expand_np(seed, MAIN_WIDTH))


def test_prg_refuses_a_field_past_its_reduction():
    with pytest.raises(ValueError, match="p < 2\\^31"):
        sa.prg_expand(3, 4, p=2**31 + 11, device="cpu")


# ------------------------------------------------------- keys and shares
def test_secrets_and_pair_masks_are_the_references(setup):
    for slot in range(5):
        assert sa.secret_key(11, 2, slot) == jsa.secret_key(11, 2, slot)
        assert sa.self_mask_seed(11, 2, slot) == \
            jsa.self_mask_seed(11, 2, slot)
    assert sa.public_keys(11, 2, 5) == jsa.public_keys(11, 2, 5)
    cfg, jcfg = sa.SecAggConfig(cohort=6), jsa.SecAggConfig(cohort=6)
    for slot in range(6):
        for peers in (None, [0, 1, 2], [3, 4, 5]):
            a = sa.pair_masks_for(11, 2, slot, cfg, peers=peers)
            b = jsa.pair_masks_for(11, 2, slot, jcfg, peers=peers)
            assert all(np.array_equal(x, y) and x.dtype == y.dtype
                       for x, y in zip(a, b))


@pytest.mark.parametrize("seed", [0, 5, 2**31 - 3, 123456789])
def test_randint_bitwise_jax(seed):
    k = jax.random.PRNGKey(seed)
    with jax.enable_x64():
        for shape, lo, hi in (((2, 1), 0, 2**31 - 2), ((5,), -7, 100),
                              ((3, 4), 0, 2**40 + 3)):
            want = jax.random.randint(k, shape, lo, hi, dtype=jnp.int64)
            got = prng.randint(prng.key(seed), shape, lo, hi)
            assert got.dtype == np.int64
            assert np.array_equal(got, np.asarray(want))
        assert np.array_equal(prng.random_bits64(prng.key(seed), (9,)),
                              np.asarray(jax.random.bits(k, (9,),
                                                         jnp.uint64)))


@pytest.mark.parametrize("cohort,t", [(3, 1), (10, 2)])
def test_self_mask_shares_bitwise_jax(cohort, t):
    cfg = sa.SecAggConfig(cohort=cohort, threshold_t=t)
    jcfg = jsa.SecAggConfig(cohort=cohort, threshold_t=t)
    for slot in range(cohort):
        got = sa.self_mask_shares(7, 1, slot, cfg)
        want = jsa.self_mask_shares(7, 1, slot, jcfg)
        assert got.dtype == np.int64 and np.array_equal(got, want)


def test_shamir_recovery_bitwise_and_threshold():
    cfg, jcfg = (sa.SecAggConfig(cohort=5, threshold_t=2),
                 jsa.SecAggConfig(cohort=5, threshold_t=2))
    shares = sa.self_mask_shares(42, 0, 3, cfg)
    want = sa.self_mask_seed(42, 0, 3)
    for subset in ([0, 1, 2], [1, 3, 4], [0, 2, 4], [0, 1, 2, 3, 4]):
        got = sa.recover_self_seed(subset, shares[subset], cfg.threshold_t)
        assert got == want
    assert jsa.recover_self_seed([1, 3, 4], shares[[1, 3, 4]],
                                 jcfg.threshold_t) == want
    with pytest.raises(ValueError, match="needs >="):
        sa.recover_self_seed([0, 1], shares[[0, 1]], cfg.threshold_t)


def test_lagrange_and_shamir_bitwise_jax():
    """Lagrange coefficients bitwise the reference's; Shamir shares (held
    bitwise through self_mask_shares above) decode from any t+1 of them."""
    rs = np.random.RandomState(0)
    alphas = rs.choice(np.arange(1, 50), 4, replace=False)
    betas = rs.choice(np.arange(1, 50), 5, replace=False)
    with jax.enable_x64():
        want = np.asarray(jff.lagrange_coeffs(alphas, betas))
    assert np.array_equal(ff.lagrange_coeffs(alphas, betas), want)
    x = rs.randint(0, ff.P_DEFAULT, (3,)).astype(np.int64)
    shares = ff.shamir_encode(x, prng.key(99), 6, 3)
    for rows in ([1, 2, 4, 5], [0, 1, 2, 3], [5, 3, 1, 0]):
        assert np.array_equal(
            ff.shamir_decode(shares[rows], np.asarray(rows) + 1, 3), x)
    assert np.array_equal(ff.mod_inv(np.arange(1, 9)) * np.arange(1, 9)
                          % ff.P_DEFAULT, np.ones(8, np.int64))


def test_field_encode_decode_bitwise_jax():
    """Ties round to even (jnp.round's rule), negatives wrap mod p, the
    decode's sign split at p/2."""
    x = np.asarray([0.0, 0.5 / 2**16, 1.5 / 2**16, 2.5 / 2**16,
                    -0.5 / 2**16, -1.5 / 2**16, 3.999, -3.999, 1e-9,
                    0.123456789, -2.0], np.float64)
    with jax.enable_x64():
        want = np.asarray(jff.field_encode(jnp.asarray(x)))
        wdec = np.asarray(jff.field_decode(jnp.asarray(want)))
    got = ff.field_encode(torch.from_numpy(x))
    assert got.dtype == torch.int64 and np.array_equal(got.numpy(), want)
    dec = ff.field_decode(got)
    assert dec.dtype == torch.float64 and np.array_equal(dec.numpy(), wdec)


# --------------------------------------------------------- mask and fold
@pytest.mark.parametrize("peers", [None, [0, 1, 2, 3]])
def test_mask_update_bitwise_jax(peers):
    """The same float64 vector, slot and round: the port's masked upload
    (on its device) is the JAX package's wire payload, bit for bit."""
    cfg, jcfg = (sa.SecAggConfig(cohort=8, threshold_t=2),
                 jsa.SecAggConfig(cohort=8, threshold_t=2))
    rs = np.random.RandomState(1)
    x = rs.randn(301) * 0.7
    for slot in (0, 3):
        w = float(rs.rand())
        got = sa.mask_update(torch.from_numpy(x), w, slot, 13, 4, cfg,
                             peers=peers)
        want = jsa.mask_update(x, w, slot, 13, 4, jcfg, peers=peers)
        assert got.dtype == np.int64 and np.array_equal(got, want)
    # float32 params upcast exactly: the engine's and the trainer's input
    x32 = x.astype(np.float32)
    assert np.array_equal(
        sa.mask_update(torch.from_numpy(x32), 0.25, 1, 13, 4, cfg),
        jsa.mask_update(x32.astype(np.float64), 0.25, 1, 13, 4, jcfg))


def test_pairwise_masks_cancel_and_device_fold_is_the_host_fold():
    cfg = sa.SecAggConfig(cohort=5, threshold_t=2)
    n, acc, dacc = 40, None, None
    for slot in range(5):
        up = sa.mask_update(torch.zeros(n), 1.0, slot, 3, 0, cfg)
        acc = sa.fold_masked(acc, up, cfg.p)
        dacc = sa.fold_masked_device(dacc, up, cfg.p, device="cpu")
    want = np.zeros(n, np.int64)
    for slot in range(5):
        want = (want + sa.prg_expand_np(sa.self_mask_seed(3, 0, slot), n)) \
            % cfg.p
    assert np.array_equal(acc, want)
    assert dacc.dtype == torch.int64 and np.array_equal(dacc.numpy(), acc)


def test_unmask_sum_after_dropout_bitwise_jax():
    """Fold only the survivors, strip with their reveals: the decoded
    survivor sum is the JAX package's bit for bit (a wire array and the
    device accumulator alike) and the weighted survivor sum to
    quantization."""
    cfg, jcfg = (sa.SecAggConfig(cohort=6, threshold_t=2),
                 jsa.SecAggConfig(cohort=6, threshold_t=2))
    seed, rnd, n = 9, 1, 33
    rs = np.random.RandomState(1)
    xs, ws = rs.randn(6, n) * 0.2, rs.rand(6) / 6.0
    surv, dead = [0, 2, 3, 5], [1, 4]
    acc = dacc = None
    for i in surv:
        up = sa.mask_update(torch.from_numpy(xs[i]), float(ws[i]), i, seed,
                            rnd, cfg)
        acc = sa.fold_masked(acc, up, cfg.p)
        dacc = sa.fold_masked_device(dacc, up, cfg.p, device="cpu")
    pks = sa.public_keys(seed, rnd, 6)
    reveals = {i: {j: sa.pair_seed(sa.secret_key(seed, rnd, i), pks[j])
                   for j in dead} for i in surv}
    seeds = {i: sa.recover_self_seed(
        surv, sa.self_mask_shares(seed, rnd, i, cfg)[surv], 2)
        for i in surv}
    got = sa.unmask_sum(acc, surv, dead, seeds, reveals, cfg,
                        device="cpu").numpy()
    want = jsa.unmask_sum(acc, surv, dead, seeds, reveals, jcfg)
    assert got.dtype == np.float64 and np.array_equal(got, want)
    part = sa.unmask_partial(dacc, surv, dead, seeds, reveals, cfg)
    assert np.array_equal(part.numpy(), jsa.unmask_partial(
        acc, surv, dead, seeds, reveals, jcfg))
    np.testing.assert_allclose(got, (xs[surv] * ws[surv, None]).sum(0),
                               atol=6 * 4 / cfg.quant_scale)


# ------------------------------------------------------ capacity, config
def test_field_capacity_guard_pins_overflow_boundary():
    p, scale = ff.P_DEFAULT, 2**16
    k_max = int(np.floor((p - 1) / (2 * scale)))  # 16383
    frac = ff.assert_field_capacity(k_max, scale, 1.0)
    assert frac == jff.assert_field_capacity(k_max, scale, 1.0)
    assert 0.99 < frac < 1.0
    with pytest.raises(ValueError, match="field capacity exceeded"):
        ff.assert_field_capacity(k_max + 1, scale, 1.0)
    with pytest.raises(ValueError, match="must be > 0"):
        ff.assert_field_capacity(8, 0.0)
    with pytest.raises(ValueError, match="field capacity exceeded"):
        sa.SecAggConfig(cohort=k_max + 1, threshold_t=2, max_abs=1.0)
    # the main path's cohort holds easily: 2 * 10 * 2^16 * 4 of p
    assert sa.SecAggConfig(cohort=10).max_abs == 4.0
    assert ff.assert_field_capacity(10, scale, 4.0) == pytest.approx(
        5_242_880 / p)


def test_mask_update_refuses_a_coordinate_past_max_abs():
    """Past the capacity promise the upload raises (the cohort sum would
    wrap silently); at the promise it masks. Never a clip."""
    cfg = sa.SecAggConfig(cohort=3, threshold_t=1, max_abs=2.0)
    ok = torch.tensor([0.5, -2.0, 1.0], dtype=torch.float64)
    assert sa.mask_update(ok, 1.0, 0, 1, 0, cfg).shape == (3,)
    with pytest.raises(ValueError, match="capacity promise"):
        sa.mask_update(ok, 1.0 + 1e-9, 0, 1, 0, cfg)
    with pytest.raises(ValueError, match="capacity promise"):
        jsa.mask_update(ok.numpy(), 1.0 + 1e-9, 0, 1, 0,
                        jsa.SecAggConfig(cohort=3, threshold_t=1,
                                         max_abs=2.0))


def test_secagg_config_validation():
    for t in (3, 0):
        with pytest.raises(ValueError, match="threshold_t"):
            sa.SecAggConfig(cohort=3, threshold_t=t)
    assert sa.SecAggConfig(cohort=3, threshold_t=2).recovery_min == 3
    for k in (2, 3, 10):
        assert sa.default_threshold_t(k) == jsa.default_threshold_t(k)


def test_entry_points_need_a_device_without_cuda(setup):
    """No CUDA and no device="cpu": every new entry point raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from fedml_tpu_torch.distributed import turboaggregate as ta

    cfg = sa.SecAggConfig(cohort=3, threshold_t=1)
    fcfg = FedAvgConfig(**cfg_kw())
    calls = [
        lambda: sa.prg_expand(1, 4),
        lambda: sa.mask_update(np.zeros(4), 1.0, 0, 0, 0, cfg),
        lambda: sa.fold_masked_device(None, np.zeros(4, np.int64)),
        lambda: sa.unmask_sum(np.zeros(4, np.int64), [0, 1, 2], [],
                              {0: 1, 1: 2, 2: 3}, {}, cfg),
        lambda: TurboAggregateAPI(setup["data"], setup["task"], fcfg),
        lambda: ta.TAAggregator(setup["data"], setup["task"], fcfg, 3),
        lambda: ta.SecureTrainer(1, setup["data"], setup["task"], fcfg),
        lambda: ta.run_simulated(setup["data"], setup["task"], fcfg),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


# -------------------------------------------------- the coordinate order
def test_tree_vectorize_is_the_jax_packages_coordinate_order():
    """CNNOriginalFedAvg (HWIO kernels, NHWC dense rows), a TransformerLM
    (its attention kernels split by head) and LogisticRegression: the port
    vector of a state is the JAX package's tree_vectorize of its params,
    stacked or not, and unvectorize inverts it bitwise."""
    from fedml_tpu_torch.convert import num_heads_of, to_flax
    from fedml_tpu_torch.core.tasks import sequence_task

    g = torch.Generator().manual_seed(0)
    cases = (("cnn", dict(output_dim=62), np.zeros((1, 28, 28, 1),
                                                    np.float32)),
             ("lr", dict(output_dim=3), np.zeros((1, 6, 6, 1), np.float32)),
             ("transformer", dict(vocab_size=32, dim=16, depth=1,
                                  num_heads=2, max_len=8),
              np.zeros((1, 8), np.int32)))
    for name, kw, x in cases:
        module = create_model(name, device="cpu", **kw)
        heads = num_heads_of(module)
        task = (sequence_task if name == "transformer"
                else classification_task)(module)
        st = {k: torch.randn(v.shape, generator=g)
              for k, v in task.init(g, x).items()}
        want = np.asarray(jax_tree_vectorize(
            jax.tree.map(jnp.asarray, to_flax(st, heads))))
        got = tree_vectorize(st, heads)
        assert np.array_equal(got.numpy(), want), name
        assert same_bits(tree_unvectorize(got, st, heads), st)
        stk = {k: torch.stack([v, 2 * v]) for k, v in st.items()}
        assert torch.equal(tree_vectorize(stk, heads, stacked=True)[1],
                           tree_vectorize({k: 2 * v for k, v in st.items()},
                                          heads))
        if name == "cnn":
            assert got.shape == (MAIN_WIDTH,)


# ---------------------------------------------------------------- engine
@pytest.fixture(scope="module")
def jax_engine(setup):
    api = JaxTA(setup["jdata"], setup["jtask"], JaxConfig(**cfg_kw(2, 3)))
    for r in range(2):
        api.run_round(r)
    return api


def test_engine_matches_jax_over_two_rounds(setup, jax_engine):
    """The port's TurboAggregateAPI against the JAX one from the same
    weights: params within the engine tolerance, the key chain equal."""
    api = TurboAggregateAPI(setup["data"], setup["task"],
                            FedAvgConfig(**cfg_kw(2, 3)), device="cpu")
    for r in range(2):
        m = api.run_round(r)
    leaves_close(api.net, jax_engine.net.params)
    assert np.array_equal(api.rng, np.asarray(jax_engine.rng))
    assert float(m["count"]) > 0


def test_engine_masked_round_matches_plain_within_quantization(setup):
    """One masked round and one FedAvg round from the same weights: within
    K * 0.5 / quant_scale (each of K slots rounds once to the grid)."""
    cfg = FedAvgConfig(**cfg_kw(1, 4))
    masked = TurboAggregateAPI(setup["data"], setup["task"], cfg,
                               device="cpu")
    plain = FedAvgAPI(setup["data"], setup["task"], cfg, device="cpu")
    masked.run_round(0)
    plain.run_round(0)
    bound = 4 * 0.5 / masked.quant_scale + 1e-6
    for k in plain.net:
        assert float((masked.net[k] - plain.net[k]).abs().max()) <= bound


@pytest.mark.parametrize("driver", ["run_pipelined", "train_prefetch_set_late"])
def test_engine_pipelined_drivers_mask(setup, driver):
    """Both pipelined entries reach the masked dispatch: the direct
    ``run_pipelined`` call, and bench.py's sequence of ``warmup()``, then
    ``prefetch = 2`` set after construction, then ``train()``. Each is
    bitwise the synchronous masked run, and not the plain weighted mean."""
    cfg = FedAvgConfig(**cfg_kw(3, 4))
    sync = TurboAggregateAPI(setup["data"], setup["task"], cfg, device="cpu")
    piped = TurboAggregateAPI(setup["data"], setup["task"], cfg,
                              device="cpu")
    plain = FedAvgAPI(setup["data"], setup["task"], cfg, device="cpu")
    if driver == "run_pipelined":
        sync_m = [sync.run_round(r) for r in range(3)]
        out = piped.run_pipelined(0, 3)
        assert [r for r, _ in out] == [0, 1, 2]
        for m, (_, h) in zip(sync_m, out):
            assert {k: float(v) for k, v in m.items()} == {
                k: float(v) for k, v in h.items()}
        for r in range(3):
            plain.run_round(r)
    else:
        sync.train()
        piped.warmup()
        piped.prefetch = 2
        piped.train()
        strip = [{k: v for k, v in rec.items() if k != "round_time"}
                 for rec in sync.history]
        assert strip == [{k: v for k, v in rec.items() if k != "round_time"}
                         for rec in piped.history]
        plain.train()
    for k in sync.net:
        assert torch.equal(sync.net[k], piped.net[k])
    assert np.array_equal(sync.rng, piped.rng)
    assert any(not torch.equal(sync.net[k], plain.net[k]) for k in sync.net)


def test_engine_refuses_past_cross_silo_scale(setup):
    cfg = FedAvgConfig(**dict(cfg_kw(1, 3), client_num_per_round=33,
                              client_num_in_total=40))
    with pytest.raises(ValueError, match="cross-silo"):
        TurboAggregateAPI(setup["data"], setup["task"], cfg, device="cpu")
