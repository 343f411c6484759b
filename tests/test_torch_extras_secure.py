"""A model's extras (BatchNorm statistics) and keys through the port's
masked secure aggregation, against the JAX package on the CPU:
TurboAggregateAPI with ResNet-8 and with CNNDropOut, the flat masked
server (full cohort and a dropout recovered by reveal) and the masked
tree (test_torch_extras_engines.py's configuration: 4 worker ranks,
batch 6; one round against the JAX package, two within the port).

Only the params go through the field: each slot's masked vector is
``tree_vectorize(net.params)`` in the JAX package's coordinate order.
The statistics are not secret: they ride the upload in the clear after
the masked vector and its shares, and the server averages the survivors'
with their float32 sample counts. TurboAggregateAPI keys its fits by its
own chain, ``split(split(rng)[1], K)``, not the main engine's.

The JAX package's masked tree cannot carry a model's extras: its edge
ships them as a list of lists of arrays, which its frame encoder refuses
(a TypeError on the edge's receive thread, and the round never closes).
The port's edge ships them as one flat list of wire leaves
(``TASecureEdgeManager._send_masked_frame``), and its tree is held to the
port's flat masked tier, bitwise, which is held to the JAX package's flat
tier.

Tolerances: one round against the JAX package, the params within one
grid step a slot, K / quant_scale, plus the engines' 1e-5 (each slot
quantizes once, and a value within float32 roundoff of a rounding
boundary rounds the other way), and the statistics within 1e-5. (A
second round starts its fits from params a grid step apart, which moves
its statistics by about as much: measured 1.25e-5 on 2 of 32 running
means.) The fit keys, the dropout masks and the tree against the flat
tier bitwise; ledgers equal.
"""

from __future__ import annotations

import flax.linen as nn
import jax
import numpy as np
import pytest
import torch

from fedml_tpu.algorithms.turboaggregate import TurboAggregateAPI as JaxTA
from fedml_tpu.chaos import FaultPlan as JaxFaultPlan
from fedml_tpu.distributed import turboaggregate as jta
from fedml_tpu_torch.algorithms.turboaggregate import TurboAggregateAPI
from fedml_tpu_torch.chaos import FaultPlan
from fedml_tpu_torch.core import secure_agg as sa
from fedml_tpu_torch.distributed import turboaggregate as ta
from fedml_tpu_torch.models.cnn import flax_dropout
from fedml_tpu_torch.utils import prng
from fedml_tpu_torch.utils.tree import params_size, params_vectorize
from test_torch_extras_engines import (
    TOL,
    assert_nets_close,
    assert_same_bits,
    from_jax,
    model,
    run_rounds,
)
from test_torch_secure_agg import FAR_DEADLINE_S, drive_stalls

# one grid step for each of K = 4 slots, plus the engines' tolerance
QUANT_TOL = 4 / 2**16 + TOL
# cohort slot 1 dark in round 0 (flat wire rank 2)
FLAT_DROP = {"seed": 7, "rules": [
    {"fault": "crash", "ranks": [2], "rounds": [0, 1]}]}


def _jax_net(api) -> dict:
    return from_jax(jax.tree.map(np.asarray, api.net))


# --------------------------------------------------------- the engine
@pytest.fixture(scope="module")
def jax_engines():
    out = {}
    for kind in ("resnet", "dropout"):
        m = model(kind)
        api = JaxTA(m.jdata, m.jtask, m.cfg(True))
        rng0 = np.asarray(api.rng)
        api.run_round(0)
        out[kind] = (_jax_net(api), rng0, np.asarray(api.rng))
    return out


@pytest.mark.parametrize("kind", ["resnet", "dropout"])
def test_turboaggregate_engine_matches_jax(jax_engines, kind, monkeypatch):
    """A masked round: each slot masks a vector of the params alone (the
    statistics stay out of the field), and the round lands within the
    quantization bound of the JAX engine's params and 1e-5 of its
    statistics; the key chain ends where the JAX engine's does."""
    m = model(kind)
    widths = []
    mask = sa.mask_update_tensor
    monkeypatch.setattr(sa, "mask_update_tensor", lambda vec, *a, **k: (
        widths.append(int(vec.shape[0])) or mask(vec, *a, **k)))
    api = m.engine(TurboAggregateAPI)
    want, rng0, rng2 = jax_engines[kind]
    assert np.array_equal(api.rng, rng0)
    run_rounds(api, 1)
    assert widths == [params_size(m.net0, m.task.extra_keys)] * 4
    assert_nets_close(api.net, want, m.task.extra_keys, atol=QUANT_TOL)
    assert np.array_equal(api.rng, rng2)
    if m.task.extra_keys:
        assert widths[0] < sum(v.numel() for v in m.net0.values())
        assert not torch.equal(api.net["norm.var"], m.net0["norm.var"])


def test_turboaggregate_extras_are_the_plain_rounds():
    """The statistics take the plain weighted mean: one masked round's
    statistics within 1e-6 of the plain engine's round (the fits are the
    same; only the params are quantized)."""
    m = model("resnet")
    masked = run_rounds(m.engine(TurboAggregateAPI), 1)
    plain = run_rounds(m.engine(), 1)
    assert_nets_close(masked.net, plain.net, m.task.extra_keys,
                      atol=4 * 0.5 / 2**16 + 1e-6, extra_atol=1e-6)


class _Dropouts(nn.Module):
    @nn.compact
    def __call__(self, x, v):
        return (nn.Dropout(0.25, deterministic=False)(x),
                nn.Dropout(0.5, deterministic=False)(v))


def test_turboaggregate_keys_and_masks_are_the_references(monkeypatch):
    """CNNDropOut under TurboAggregateAPI: slot k's fit keys are the
    reference's ``split(rk, K)[k]`` split per epoch and batch (not the
    main engine's client_keys), bitwise, and the dropout masks they draw
    are flax's bitwise."""
    m = model("dropout")
    api = m.engine(TurboAggregateAPI)
    seen = []
    fit = api.local_update
    monkeypatch.setattr(api, "local_update", lambda net, x, y, mask, keys:
                        seen.append(keys) or fit(net, x, y, mask, keys))
    _, rk = jax.random.split(jax.numpy.asarray(api.rng))
    api.run_round(0)
    (keys,) = seen
    slot_keys = jax.random.split(rk, 4)
    rs = np.random.RandomState(0)
    x = rs.rand(2, 6, 6, 4).astype(np.float32) + 1.0
    v = rs.rand(2, 9).astype(np.float32) + 1.0
    for k in range(4):
        rng, carry = jax.random.split(slot_keys[k])
        for b in range(keys.shape[1]):
            carry, sub = jax.random.split(carry)
            assert np.array_equal(keys[0, b, k].numpy(),
                                  np.asarray(sub).astype(np.int64))
        wx, wv = _Dropouts().apply({}, x, v, rngs={"dropout": sub})
        key = keys[0, keys.shape[1] - 1, k]
        gx = flax_dropout(torch.from_numpy(x).permute(0, 3, 1, 2), 0.25,
                          key, "Dropout_0", nhwc=True)
        gv = flax_dropout(torch.from_numpy(v), 0.5, key, "Dropout_1")
        assert np.array_equal(gx.permute(0, 2, 3, 1).numpy(), np.asarray(wx))
        assert np.array_equal(gv.numpy(), np.asarray(wv))
    # the main engine's chain keys the same clients otherwise
    assert not np.array_equal(
        prng.client_keys(0, 0, api._sampled_ids(0))[0],
        np.asarray(slot_keys[0]))


# --------------------------------------------- the cross-process tiers
@pytest.fixture(scope="module")
def jax_masked():
    """The JAX package's flat masked round, full cohort, with slot 1 dark
    (recovered by reveal) and under DP (clipped deltas masked, noise on
    the decoded mean), ResNet-8."""
    m = model("resnet")
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        drive_stalls(mp)
        for name, kw in MASKED.items():
            kw = dict(kw)
            if "chaos_plan" in kw:
                kw["chaos_plan"] = JaxFaultPlan.from_json(kw["chaos_plan"])
            ref = jta.run_simulated(m.jdata, m.jtask,
                                    m.cfg(True, comm_round=1),
                                    job_id=f"xs-jax-{name}", **kw)
            out[name] = (_jax_net(ref), ref.quarantine.canonical())
    return out


MASKED = {
    "flat": dict(),
    "flat_dropout": dict(chaos_plan=FLAT_DROP,
                         round_timeout_s=FAR_DEADLINE_S),
    "flat_dp": dict(defense_type="dp", norm_bound=1.0,
                    noise_multiplier=1.1),
}


@pytest.mark.parametrize("name", list(MASKED))
def test_masked_servers_match_jax(jax_masked, name, monkeypatch):
    """SecureTrainer uploads ``[masked, b_shares, *extras]`` and the flat
    server averages the survivors' statistics in the clear: the params
    within the quantization bound of the JAX package's round, the
    statistics within 1e-5, the ledgers equal (slot 1's secagg_dropout in
    the recovered round, whose statistics are the three survivors'). Under
    DP the masked vector is the clipped params delta and the noise lands
    on the params alone."""
    drive_stalls(monkeypatch)
    m = model("resnet")
    kw = dict(MASKED[name])
    if "chaos_plan" in kw:
        kw["chaos_plan"] = FaultPlan.from_json(kw["chaos_plan"])
    agg = ta.run_simulated(m.data, m.task, m.cfg(comm_round=1),
                           job_id=f"xs-{name}", device="cpu", **kw)
    want, ledger = jax_masked[name]
    assert agg.quarantine.canonical() == ledger
    assert ([e[2] for e in ledger] == ["secagg_dropout"]) == \
        (name == "flat_dropout")
    assert_nets_close(agg.net, want, m.task.extra_keys, atol=QUANT_TOL)
    assert not torch.equal(agg.net["norm.var"], m.net0["norm.var"])


def test_masked_tree_is_the_flat_tier_bitwise():
    """The masked tree (edges forward the survivors' statistics with the
    field partial, as one flat list of leaves) lands on the flat masked
    run's bits, statistics included, at the same threshold."""
    m = model("resnet")
    flat = ta.run_simulated(m.data, m.task, m.cfg(), job_id="xs-flat-t1",
                            device="cpu", threshold_t=1)
    tree = ta.run_simulated(m.data, m.task, m.cfg(), job_id="xs-tree-t1",
                            device="cpu", edges=2, threshold_t=1)
    assert_same_bits(tree.net, flat.net)
    assert tree.fanin_history == [2, 2]


def test_secure_trainer_upload_layout():
    """The upload is the masked params vector, the self-mask shares, then
    the statistics as float32 wire leaves in the wire order; the server
    refuses an upload whose statistics do not fit the model."""
    m = model("resnet")
    trainer = ta.SecureTrainer(1, m.data, m.task, m.cfg(), device="cpu")
    trainer.fit(0)
    leaves = trainer.wire_leaves()
    n = params_size(trainer.net, m.task.extra_keys)
    assert leaves[0].shape == (n,) and leaves[0].dtype == np.int64
    assert leaves[1].shape == (4,)
    from fedml_tpu_torch.comm.message import pack_pytree

    wire = pack_pytree(trainer.net)
    extras = wire[len(wire) - len(m.task.extra_keys):]
    assert len(leaves) == 2 + len(extras)
    assert all(np.array_equal(a, b) for a, b in zip(leaves[2:], extras))
    assert ta._masked_leaves_ok(leaves, n, 4, [e.shape for e in extras])
    assert not ta._masked_leaves_ok(leaves[:-1], n, 4,
                                    [e.shape for e in extras])
    assert params_vectorize(trainer.net, m.task.extra_keys).shape == (n,)
