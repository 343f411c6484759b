"""A model's extras (BatchNorm statistics) and keys through the port's
cross-process runtime, against the JAX package's loopback runs on the
CPU: the flat server's robust, fused (plain and staged), async and
delta-broadcast modes, the client's codecs and adversary, the edge tier
(plain and two-phase), and the DP server. ResNet depth 8 on 8x8x3 images,
4 worker ranks, batch 6, two rounds (test_torch_extras_engines.py's
configuration); CNNDropOut for the keyed model.

The statistics ride every frame after the params (comm/message
.pack_pytree) and every mode treats them as the reference treats its
staged tree: gated, estimated, encoded, perturbed and folded with the
params; the DP server clips and noises the params only.

Tolerances: the port's run within 1e-5 absolute of the JAX package's,
params and extras leaf by leaf, for the lossless modes; the lossy uplink
tiers within one quantization step (test_torch_wire_codecs.py's TIERS: a
value within float32 roundoff of a step boundary rounds the other way,
and error feedback returns it the next round): 2e-3 for delta-int8, and
for top-k the size of an entry at the selection threshold, which the two
packages may keep and drop the other way (1e-2; measured 3.8e-3 on 2 of
432 entries); quarantine ledgers equal; loopback against the engine
1e-5.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest

from fedml_tpu.chaos import AdversaryPlan as JaxAdversaryPlan
from fedml_tpu.distributed import fedavg_robust as jax_dist_robust
from fedml_tpu.distributed.fedavg import run_simulated as jax_run_simulated
from fedml_tpu_torch.chaos import AdversaryPlan
from fedml_tpu_torch.distributed import fedavg_robust as dist_robust
from fedml_tpu_torch.distributed.fedavg import run_simulated
from test_torch_extras_engines import (
    SIGN_FLIP,
    assert_nets_close,
    from_jax,
    model,
    run_rounds,
)

# mode -> (run_simulated options, params/extras tolerance against the
# JAX run); an adversary_plan of True is SIGN_FLIP
MODES = {
    "robust_adversary": (dict(aggregator="median", adversary_plan=True),
                         1e-5),
    "adversary": (dict(adversary_plan=True), 1e-5),
    "two_phase_fused": (dict(fused_agg=True, aggregator="median",
                             adversary_plan=True), 1e-5),
    "fused": (dict(fused_agg=True), 1e-5),
    "async": (dict(async_buffer_k=4, staleness_bound=0), 1e-5),
    "delta_broadcast": (dict(delta_broadcast=True), 1e-5),
    "codec_int8": (dict(update_codec="delta-int8"), 2e-3),
    "topk": (dict(sparsify_ratio=0.3), 1e-2),
    "edges": (dict(edges=2), 1e-5),
    "edges_two_phase": (dict(edges=2, aggregator="median",
                             adversary_plan=True), 1e-5),
}


def _kw(kw: dict, plan_cls) -> dict:
    kw = dict(kw)
    if kw.get("adversary_plan"):
        kw["adversary_plan"] = plan_cls.from_json(SIGN_FLIP)
    return kw


@pytest.fixture(scope="module")
def jax_runs():
    """The JAX package's loopback run of every mode and of the DP server,
    from the same initial net."""
    m = model("resnet")
    out = {}
    for mode, (kw, _) in MODES.items():
        ref = jax_run_simulated(m.jdata, m.jtask, m.cfg(True),
                                job_id=f"xw-jax-{mode}",
                                **_kw(kw, JaxAdversaryPlan))
        out[mode] = (from_jax(jax.tree.map(np.asarray, ref.net)),
                     ref.quarantine.canonical())
    ref = jax_dist_robust.run_simulated(
        m.jdata, m.jtask, m.cfg(True), job_id="xw-jax-dp",
        defense_type="dp", norm_bound=1.0, noise_multiplier=1.1)
    out["dp"] = from_jax(jax.tree.map(np.asarray, ref.net))
    return out


@pytest.mark.parametrize("mode", list(MODES))
def test_flat_and_tree_modes_match_jax(jax_runs, mode):
    """Each server mode and uplink tier over loopback with ResNet-8: the
    port's net within the mode's tolerance of the JAX package's run,
    params and statistics, the quarantine ledgers equal (non-empty where
    an estimator arms the norm gate against the sign-flip plan), the
    statistics moved off their init."""
    m = model("resnet")
    kw, tol = MODES[mode]
    agg = run_simulated(m.data, m.task, m.cfg(), job_id=f"xw-port-{mode}",
                        device="cpu", **_kw(kw, AdversaryPlan))
    want, ledger = jax_runs[mode]
    assert agg.quarantine.canonical() == ledger
    assert (len(ledger) > 0) == ("aggregator" in kw)
    assert_nets_close(agg.net, want, m.task.extra_keys, atol=tol,
                      extra_atol=tol)
    assert not np.array_equal(agg.net["norm.var"].numpy(),
                              m.net0["norm.var"].numpy())


def test_dp_server_clips_and_noises_params_only(jax_runs, monkeypatch):
    """The cross-process DP server (clip each upload to C, uniform mean,
    noise z*C/m, one key split a round from PRNGKey(seed + 7)): two
    rounds within 1e-5 of the JAX package's. In one round, the binding
    clip leaves the statistics the plain server's bitwise, and the noise
    leaves them the noiseless dp server's bitwise while it moves the
    params."""
    m = model("resnet")
    kw = dict(norm_bound=1.0, noise_multiplier=1.1)
    one = m.cfg(comm_round=1)
    plain = run_simulated(m.data, m.task, one, job_id="xw-port-plain1",
                          device="cpu")
    clip = dist_robust.run_simulated(m.data, m.task, one,
                                     job_id="xw-port-clip1", device="cpu",
                                     defense_type="norm_diff_clipping",
                                     norm_bound=1.0)
    dp = dist_robust.run_simulated(m.data, m.task, one,
                                   job_id="xw-port-dp1", device="cpu",
                                   defense_type="dp", **kw)
    with monkeypatch.context() as mp:
        mp.setattr(dist_robust, "add_gaussian_noise",
                   lambda key, net, sd, extra_keys=(): net)
        quiet = dist_robust.run_simulated(m.data, m.task, one,
                                          job_id="xw-port-dp0",
                                          device="cpu", defense_type="dp",
                                          **kw)
    for k in m.task.extra_keys:
        assert np.array_equal(clip.net[k].numpy(), plain.net[k].numpy()), k
        assert np.array_equal(dp.net[k].numpy(), quiet.net[k].numpy()), k
    assert not np.array_equal(clip.net["fc.weight"].numpy(),
                              plain.net["fc.weight"].numpy())
    assert not np.array_equal(dp.net["fc.weight"].numpy(),
                              quiet.net["fc.weight"].numpy())
    agg = dist_robust.run_simulated(m.data, m.task, m.cfg(),
                                    job_id="xw-port-dp", device="cpu",
                                    defense_type="dp", **kw)
    assert_nets_close(agg.net, jax_runs["dp"], m.task.extra_keys)


def test_keyed_model_through_the_async_server_matches_engine():
    """CNNDropOut over loopback with an async buffer at K = cohort, bound
    0 (the barrier): each trainer keys its wave's fit as the engine keys
    its client in that round, so the run lands within 1e-5 of the
    engine's rounds."""
    m = model("dropout")
    eng = run_rounds(m.engine())
    agg = run_simulated(m.data, m.task, m.cfg(), job_id="xw-drop-async",
                        device="cpu", async_buffer_k=4, staleness_bound=0)
    assert_nets_close(agg.net, eng.net, ())
