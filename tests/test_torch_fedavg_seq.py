"""The port's long-context engine, FedAvgSeqAPI over a ('clients', 'seq')
mesh, against the JAX package's FedAvgSeqAPI and the port's single-process
FedAvgAPI, mirroring tests/test_fedavg_seq.py at its configuration
(TransformerLM vocab 32, dim 16, depth 1, 2 heads, T 16; 8 clients, 4 a
round, batch 6) from the same converted weights.

The port runs in one gloo world of 4 CPU processes for the whole file
(tests/test_torch_seq_ranks.engine, a 2 x 2 mesh), which also runs the
port's single-process oracles (one a rank) while the JAX engine runs
here.

The bf16 client-compute policy reaches the seq engine as the reference's
does, through a LocalSpec with compute_dtype 'bf16' (flash ring, 2 rounds):
held to the JAX seq engine given the same spec at tests/test_torch_bf16.py's
bound (each tensor within 2**-4 of its largest update entry; measured 1.3e-2)
and to the port's single-process bf16 round within 1e-2 of the update,
||diff|| / ||update|| (measured 3.7e-3: the ring rounds each block's o to
bf16 and sums bf16 gradients over 'seq', and bf16 training spreads those
flips; the f32 flash ring lands 5.9e-3 from it, so the policy is shown by
every tensor differing from the f32 rounds'). precision='bf16' in the
config without a spec is the f32 round."""

import re
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import test_torch_seq_ranks as ranks
from fedml_tpu.algorithms.fedavg import FedAvgConfig as JaxConfig
from fedml_tpu.algorithms.fedavg import make_client_optimizer as jax_client_optimizer
from fedml_tpu.algorithms.fedavg_seq import FedAvgSeqAPI as JaxFedAvgSeqAPI
from fedml_tpu.core.local import LocalSpec as JaxLocalSpec
from fedml_tpu.data.synthetic import synthetic_sequences as jax_sequences
from fedml_tpu.models.transformer import TransformerLM as JaxTransformerLM
from fedml_tpu_torch import convert
from fedml_tpu_torch.algorithms import FedAvgConfig, FedAvgSeqAPI
from fedml_tpu_torch.core.tasks import sequence_task
from fedml_tpu_torch.mesh.world import World

WORLD = 4
DEADLINE_S = 180.0
TOL = 1e-5        # the reference's bound for the dense paths
TOL_FLASH = 1e-4  # and for flash


def _rel(a: dict, b: dict) -> float:
    """||a - b|| / ||a|| over every parameter."""
    num = sum(float(np.sum((np.asarray(a[k]) - np.asarray(b[k])) ** 2))
              for k in a)
    den = sum(float(np.sum(np.asarray(a[k]) ** 2)) for k in a)
    return (num / den) ** 0.5


def _jax_bf16(jdata, mesh, start):
    """The JAX seq engine, flash ring, under a bf16 LocalSpec: 2 rounds from
    ``start``."""
    jcfg = JaxConfig(**ranks.SEQ_CFG)
    api = JaxFedAvgSeqAPI(
        jdata, lambda ax: JaxTransformerLM(**ranks.SEQ_WIDTHS, seq_axis=ax,
                                           use_flash=True),
        jcfg, mesh=mesh, local_spec=JaxLocalSpec(
            optimizer=jax_client_optimizer(jcfg), epochs=jcfg.epochs,
            compute_dtype="bf16"))
    api.load_state(api.net._replace(params=convert.to_flax(
        start, ranks.SEQ_WIDTHS["num_heads"])), api.server_opt_state, api.rng)
    for r in range(2):
        api.run_round(r)
    return convert.from_flax(jax.tree.map(np.asarray, api.net.params))


def _update_rel(a: dict, b: dict, start: dict) -> float:
    """||a - b|| / ||b - start|| over every parameter."""
    num = sum(float(np.sum((np.asarray(a[k]) - np.asarray(b[k])) ** 2))
              for k in b)
    den = sum(float(np.sum((np.asarray(b[k]) - np.asarray(start[k])) ** 2))
              for k in b)
    return (num / den) ** 0.5


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The port's world (its scenarios, then one single-process FedAvgAPI
    oracle a rank) runs while the JAX engine runs here, from the port's
    seeded initial weights converted to flax."""
    work = tmp_path_factory.mktemp("seq_world")
    data = ranks.seq_data()
    jdata = jax_sequences(**ranks.SEQ_DATA)
    assert np.array_equal(data.train_x, jdata.train_x)
    start = sequence_task(ranks.seq_model(None)).init(
        torch.Generator().manual_seed(0), data.train_x[:6])
    torch.save(start, work / "start.pt")
    with ranks.one_world_at_a_time():
        world = World("test_torch_seq_ranks:engine", WORLD, (str(work),),
                      deadline_s=DEADLINE_S,
                      sys_path=(str(Path(__file__).parent),),
                      workdir=str(work / "world")).start()
        try:
            mesh = jax.sharding.Mesh(
                np.asarray(jax.devices()[:4]).reshape(2, 2),
                ("clients", "seq"))
            jax_api = JaxFedAvgSeqAPI(
                jdata, lambda ax: JaxTransformerLM(**ranks.SEQ_WIDTHS,
                                                   seq_axis=ax),
                JaxConfig(**ranks.SEQ_CFG), mesh=mesh)
            jax_api.load_state(
                jax_api.net._replace(params=convert.to_flax(
                    start, ranks.SEQ_WIDTHS["num_heads"])),
                jax_api.server_opt_state, jax_api.rng)
            jm = [jax_api.run_round(r) for r in range(3)]
            out = {"jax": convert.from_flax(
                       jax.tree.map(np.asarray, jax_api.net.params)),
                   "jax_metrics": {k: float(v) for k, v in jm[-1].items()},
                   "jax_bf16": _jax_bf16(jdata, mesh, start)}
        finally:
            port = world.join()
    dense, sw, prox, train = (p["oracle"] for p in port)
    out.update(start={k: v.numpy() for k, v in start.items()},
               bf16=port[1]["oracle_bf16"]["nets"],
               bf16_ids=port[1]["oracle_bf16"]["ids"])
    out.update(port=port, dense=dense["nets"],
               dense_metrics=dense["metrics"], size_weighted=sw["nets"],
               size_weighted_ids=sw["ids"], size_weighted_uniform=sw["uniform"],
               prox=prox["nets"], history=train["history"])
    return out


def test_two_by_two_matches_the_jax_seq_engine(runs):
    port = runs["port"][0]
    assert _rel(runs["jax"], port["ring"]) < TOL
    got, want = port["ring_metrics"][-1], runs["jax_metrics"]
    assert got["count"] == want["count"]
    np.testing.assert_allclose(got["loss_sum"], want["loss_sum"], rtol=1e-4)


def test_two_by_two_matches_the_single_process_engine(runs):
    port = runs["port"][0]
    assert _rel(runs["dense"][2], port["ring"]) < TOL
    for got, want in zip(port["ring_metrics"], runs["dense_metrics"]):
        assert got["count"] == want["count"]
        assert got["correct"] == want["correct"]
        np.testing.assert_allclose(got["loss_sum"], want["loss_sum"],
                                   rtol=1e-4)


def test_every_rank_ends_with_the_same_model(runs):
    nets = [p["ring"] for p in runs["port"]]
    for net in nets[1:]:
        assert all(np.array_equal(net[k], nets[0][k]) for k in net)


@pytest.mark.parametrize("name,tol", [("ulysses", TOL), ("flash", TOL_FLASH)])
def test_seq_impl_matches_the_single_process_engine(runs, name, tol):
    """Ulysses (all_to_all head scatter) and flash ring attention (the
    kernels' plain twins here, merged by logsumexp) on the 2 x 2 mesh,
    two rounds, against the dense single-process engine."""
    assert _rel(runs["dense"][1], runs["port"][0][name]) < tol


def test_size_weighted_matches_the_single_process_engine(runs):
    port = runs["port"][0]
    assert port["size_weighted_uniform"] and runs["size_weighted_uniform"]
    assert port["size_weighted_ids"] == runs["size_weighted_ids"]
    assert _rel(runs["size_weighted"][1], port["size_weighted"]) < TOL


def test_fedprox_matches_the_single_process_engine(runs):
    port = runs["port"][0]
    assert _rel(runs["prox"][1], port["prox"]) < TOL
    # mu bites: the proximal fit is not plain FedAvg's
    assert _rel(runs["dense"][1], port["prox"]) > 1e-5


def test_bf16_spec_matches_the_jax_seq_engine(runs):
    """A bf16 LocalSpec on the flash ring, 2 rounds, against the JAX seq
    engine given the same spec: each tensor within 2**-4 of its largest
    update entry; the masters stay float32."""
    start, want, got = runs["start"], runs["jax_bf16"], runs["port"][0]["bf16"]
    for k in want:
        assert got[k].dtype == np.float32, k
        upd = np.abs(want[k].numpy() - start[k]).max()
        assert np.abs(got[k] - want[k].numpy()).max() <= 2.0 ** -4 * upd, k


def test_bf16_spec_matches_the_single_process_engine(runs):
    """The same rounds against FedAvgAPI(precision='bf16') on the flash
    model: within 1e-2 of the update; every tensor differs from the f32
    flash rounds' (the policy ran); every rank ends with one model."""
    port = runs["port"]
    assert _update_rel(port[0]["bf16"], runs["bf16"][1], runs["start"]) < 1e-2
    assert all(not np.array_equal(port[0]["bf16"][k], port[0]["flash"][k])
               for k in port[0]["flash"])
    assert port[0]["bf16_ids"] == runs["bf16_ids"]
    for p in port[1:]:
        assert all(np.array_equal(p["bf16"][k], port[0]["bf16"][k])
                   for k in p["bf16"])


def test_precision_without_a_spec_is_the_f32_round(runs):
    """FedAvgConfig(precision='bf16') with no spec: the reference's
    FedAvgSeqAPI builds LocalSpec(optimizer, epochs, remat) and never reads
    the precision, so the round is the f32 round, bitwise."""
    for port in runs["port"]:
        assert port["no_spec_dtype"] == "f32"
        assert port["no_spec_bitwise"]


def test_run_rounds_is_the_run_round_loop_bitwise(runs):
    port = runs["port"][0]
    assert all(np.array_equal(port["block"][k], port["ring"][k])
               for k in port["ring"])
    for k, v in port["block_metrics"].items():
        assert v.shape == (3,)
        assert list(v) == [m[k] for m in port["ring_metrics"]]


def test_load_state_after_a_checkpoint_round_trip_is_bitwise(runs):
    for port in runs["port"]:
        assert port["restored_bitwise"] and port["restored_trains"]


def test_train_history_matches_the_single_process_engine(runs):
    hist, want = runs["port"][0]["history"], runs["history"]
    assert [h["round"] for h in hist] == [h["round"] for h in want] == [0, 2, 3]
    for h, w in zip(hist, want):
        for key in ("train_loss", "train_acc", "test_loss", "test_acc"):
            np.testing.assert_allclose(h[key], w[key], rtol=1e-4, atol=1e-6)
    assert hist[-1]["train_loss"] < hist[0]["train_loss"]
    assert hist[-1]["test_acc"] > 0.0


@pytest.mark.parametrize("case,match", [
    ("axes", r"FedAvgSeqAPI needs axes \('clients','seq'\), got \('data', 'seq'\)"),
    ("seq_length", "sequence length 16 not divisible by seq axis 3"),
    ("cohort", "client_num_per_round=3 must be a multiple of the clients "
               "axis 2"),
    ("ulysses_heads", r"ulysses needs num_heads \(2\) divisible by the seq "
                      r"axis \(4\)"),
    ("seq_impl", r"unknown seq_impl 'striped' \(ring \| ulysses\)"),
])
def test_constructor_refusals_are_the_references(runs, case, match):
    """The reference's ValueErrors, word for word, on every rank (the 1 x 3
    mesh's rank outside the mesh refuses the sequence length too)."""
    for port in runs["port"]:
        kind, msg = port["errors"][case]
        assert kind == "ValueError" and re.fullmatch(match, msg), (kind, msg)


@pytest.mark.parametrize("kwargs", [dict(server_update=lambda o, a, s: (a, s)),
                                    dict(server_opt_init=lambda p: ()),
                                    dict(donate=True)])
def test_server_hooks_and_donate_name_their_items(kwargs):
    with pytest.raises(NotImplementedError, match="items 5 and 9"):
        FedAvgSeqAPI(ranks.seq_data(), ranks.seq_model,
                     FedAvgConfig(**ranks.SEQ_CFG), None, device="cpu",
                     **kwargs)
