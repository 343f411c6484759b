"""Round economics in the port (fedml_tpu_torch/obs/goodput.py,
utils/flops.py, the engine's goodput / pack / agg blocks and the server's
duty-only block) against the JAX package's, on tiny configurations
(synthetic images of 6 clients, 6x6x1, 3 classes, 10-31 samples each,
LogisticRegression; the CNN's FLOP count at batch 1), inputs made from
seeds with numpy.

Tolerances: the decomposition, the span mapping, the round block for the
same cost entry and the pack block are bitwise the reference's; the
port's CNN forward counts exactly 24,599,552 FLOPs a sample, within
[1.10, 1.20] of XLA's count of the same forward (the port charges the
taps in the convolutions' zero padding, XLA does not); telemetry off and
on give bitwise the same model and byte-identical frames.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.algorithms.fedavg import FedAvgAPI as JaxFedAvgAPI
from fedml_tpu.algorithms.fedavg import FedAvgConfig as JaxConfig
from fedml_tpu.core.tasks import classification_task as jax_classification_task
from fedml_tpu.data.synthetic import synthetic_images as jax_synthetic_images
from fedml_tpu.models.cnn import CNNOriginalFedAvg as JaxCNN
from fedml_tpu.models.linear import LogisticRegression as JaxLR
from fedml_tpu.obs import goodput as jax_goodput
from fedml_tpu.obs.telemetry import Telemetry as JaxTelemetry
from fedml_tpu.utils.flops import compiled_flops
from fedml_tpu_torch import convert
from fedml_tpu_torch.algorithms import FedAvgAPI, FedAvgConfig
from fedml_tpu_torch.comm.message import Message, pack_pytree
from fedml_tpu_torch.core.tasks import classification_task
from fedml_tpu_torch.data.synthetic import synthetic_images
from fedml_tpu_torch.distributed.fedavg import run_simulated
from fedml_tpu_torch.models import create_model
from fedml_tpu_torch.obs import goodput
from fedml_tpu_torch.obs import perf_instrument as perf
from fedml_tpu_torch.obs.metrics import REGISTRY
from fedml_tpu_torch.obs.telemetry import Telemetry
from fedml_tpu_torch.utils import flops

DATA_KW = dict(num_clients=6, image_shape=(6, 6, 1), num_classes=3,
               samples_per_client=12, test_samples=24, seed=0)
CNN_FWD = 24_599_552  # conv1 1,254,400 + conv2 20,070,400 + fc 3,274,752


def _cfg(jax_=False, **kw):
    kw = {**dict(comm_round=3, client_num_in_total=6, client_num_per_round=3,
                 batch_size=8, lr=0.1, frequency_of_the_test=100), **kw}
    return (JaxConfig if jax_ else FedAvgConfig)(**kw)


@pytest.fixture(scope="module")
def setup():
    jdata = jax_synthetic_images(**DATA_KW)
    jtask = jax_classification_task(JaxLR(num_classes=3))
    _, key = jax.random.split(jax.random.PRNGKey(0))
    params = jax.tree.map(np.asarray, jtask.init(
        key, jnp.asarray(jdata.train_x[:8])).params)
    state = convert.from_flax(params)
    task = classification_task(create_model("lr", output_dim=3, device="cpu"))
    task = task._replace(init=lambda g, x=None: {k: v.clone()
                                                 for k, v in state.items()})
    return dict(data=synthetic_images(**DATA_KW), task=task, jdata=jdata,
                jtask=jtask)


def _records(tel, kind="round"):
    return [r for r in tel.events.sink.records if r.get("kind") == kind]


def _bits(net: dict):
    return [v.numpy().tobytes() for v in net.values()]


# ------------------------------------------------- decomposition oracle
@pytest.mark.parametrize("seed", range(6))
def test_decompose_is_the_reference_bitwise(seed):
    """Seeded phases, some over-reported past the wall, one wall at or
    below zero: the same exclusive buckets as the reference, bit for bit,
    summing to the wall."""
    rng = np.random.default_rng(seed)
    wall = float(rng.uniform(-0.2, 1.5)) if seed == 5 else \
        float(rng.uniform(0.05, 1.5))
    phases = {b: float(rng.uniform(0.0, 0.6)) for b in goodput.BUCKETS[:-1]}
    mine = goodput.decompose(wall, **phases)
    ref = jax_goodput.decompose(wall, **phases)
    assert mine == ref and list(mine) == list(ref)
    assert sum(mine.values()) == pytest.approx(max(wall, 0.0), abs=1e-12)


@pytest.mark.parametrize("pipelined", [False, True])
@pytest.mark.parametrize("seed", range(2))
def test_buckets_from_spans_is_the_reference_bitwise(seed, pipelined):
    rng = np.random.default_rng(10 + seed)
    spans = {k: float(rng.uniform(0.0, 0.3)) for k in
             ("pack", "h2d", "round", "prefetch_stall", "aggregate")}
    kw = dict(pipelined=pipelined, compute_wait_s=float(rng.uniform(0, .2)),
              wire_wait_s=float(rng.uniform(0, .2)),
              flush_s=float(rng.uniform(0, .1)))
    assert goodput.buckets_from_spans(1.0, spans, **kw) == \
        jax_goodput.buckets_from_spans(1.0, spans, **kw)


class _Exe:
    """An XLA executable's cost analysis, for the reference's recorder."""

    def __init__(self, ca):
        self._ca = ca

    def cost_analysis(self):
        return self._ca


@pytest.mark.parametrize("peak", [None, 1e12])
def test_round_goodput_block_matches_reference(peak):
    """The same FLOP count cached under the same variant gives the same
    block: the port hands in a count, the reference an executable whose
    cost analysis reports no bytes."""
    goodput.clear_variant_costs()
    jax_goodput.clear_variant_costs()
    try:
        assert goodput.record_variant_cost("round_b4", 4e9) == \
            jax_goodput.record_variant_cost(
                "round_b4", _Exe({"flops": 4e9})) == \
            {"flops": 4e9, "bytes": None}
        buckets = goodput.decompose(0.5, compute=0.3, prefetch_stall=0.05)
        kw = dict(variant="round_b4", n_devices=1, peak_flops=peak)
        mine = goodput.round_goodput(0.5, buckets, **kw)
        assert mine == jax_goodput.round_goodput(0.5, buckets, **kw)
        assert mine["flops_per_s"] == 8e9
        assert ("mfu" in mine) == (peak is not None)
    finally:
        goodput.clear_variant_costs()
        jax_goodput.clear_variant_costs()


def test_record_variant_cost_graceful_absence():
    """No count (a module the counter cannot trace), a zero or a junk
    count: None cached, a duty-only block — the reference's block for a
    variant whose backend reports no cost."""
    goodput.clear_variant_costs()
    try:
        for bad in (None, 0.0, "junk"):
            assert goodput.record_variant_cost("v", bad) is None
        assert goodput.variant_cost("v") is None
        assert goodput.variant_cost(None) is None
        buckets = goodput.decompose(1.0, compute=0.5)
        blk = goodput.round_goodput(1.0, buckets, variant="v")
        assert blk == jax_goodput.round_goodput(1.0, buckets, variant="v")
        assert "flops_per_s" not in blk and "mfu" not in blk
    finally:
        goodput.clear_variant_costs()


def test_device_peak_table_substring_match():
    """The card's dense bf16 peak by name, more specific keys first; an
    unknown kind (and this CPU process, which never initializes CUDA)
    reads None, so MFU reads 0 as in the reference."""
    assert goodput.device_peak_flops("NVIDIA H100 80GB HBM3") == 9.894e14
    assert goodput.device_peak_flops("NVIDIA H100 PCIe") == 7.56e14
    assert goodput.device_peak_flops("NVIDIA A100-SXM4-80GB") is None
    assert goodput.device_peak_flops("cpu") is None
    assert goodput.device_peak_flops() is None
    assert not torch.cuda.is_initialized()
    # the reference's own table knows no CUDA card
    assert jax_goodput.device_peak_flops("NVIDIA H100 80GB HBM3") is None


def test_goodput_families_preregister_at_zero():
    """Telemetry() pre-registers the goodput families as the reference's
    does; the reference's fed_xla_variant_* compile families have no
    PyTorch source and are left out (perf_instrument's documented
    absence)."""
    Telemetry().close()
    JaxTelemetry().close()
    from fedml_tpu.obs.metrics import REGISTRY as JAX_REGISTRY

    mine, ref = REGISTRY.snapshot(), JAX_REGISTRY.snapshot()
    fams = {f for f in ref if f.startswith(("fed_goodput_", "fed_duty"))}
    assert fams == {"fed_goodput_flops_per_sec", "fed_goodput_bytes_per_sec",
                    "fed_goodput_mfu", "fed_goodput_rounds_total",
                    "fed_duty_cycle"}
    assert fams <= set(mine)
    assert set(mine["fed_duty_cycle"]) == set(ref["fed_duty_cycle"])
    assert "fed_xla_variant_compiles_total" in ref
    assert not [f for f in mine if f.startswith("fed_xla_")]


def test_compile_observatory_is_a_documented_absence():
    assert perf.install() is False
    with perf.attribute_compiles("round_b4"):
        pass
    assert perf.variant_compile_stats() == {}
    assert perf.ensure_compile_attr_families() is None
    assert perf.compiles_total() == 0.0


# ------------------------------------------------------------ FLOP count
def test_cnn_forward_flops_pin_and_ratio_to_xla():
    """The port's forward count of CNNOriginalFedAvg (no grad, meta) is
    exactly the model's own work; XLA's count of the same forward leaves
    out the padding taps (x1.156); under grad the port's zero-valued
    weight-gradient route would double-count (the pitfall the no-grad
    count avoids)."""
    model = create_model("cnn", output_dim=62, device="cpu")
    task = classification_task(model)
    net = {k: v.detach() for k, v in model.named_parameters()}
    x = np.zeros((1, 28, 28), np.uint8)
    assert flops.forward_flops(task, net, x) == CNN_FWD
    with torch.utils.flop_counter.FlopCounterMode(display=False) as c:
        model(torch.zeros(1, 28, 28, 1))
    assert c.get_total_flops() == 44_669_952
    jmodel = JaxCNN()
    xj = jnp.zeros((1, 28, 28, 1), jnp.float32)
    params = jmodel.init(jax.random.PRNGKey(0), xj)
    xla = compiled_flops(jmodel.apply, params, xj)
    assert xla is not None and 1.10 <= CNN_FWD / xla <= 1.20


def test_forward_flops_never_raises():
    def broken(params, x):
        raise RuntimeError("no meta path")

    task = classification_task(create_model("lr", output_dim=3,
                                            device="cpu"))
    assert flops.forward_flops(task._replace(predict=broken), {},
                               np.zeros((1, 4), np.float32)) is None


# --------------------------------------------------------- engine rounds
def test_round_records_carry_goodput_and_sum_to_wall(setup):
    """Every engine round record carries goodput (buckets summing to its
    wall, the reference's variant name, FLOPs/s from the counted forward),
    pack and agg blocks, the JAX engine's block keys among them."""
    tel, jtel = Telemetry(), JaxTelemetry()
    api = FedAvgAPI(setup["data"], setup["task"], _cfg(), device="cpu",
                    telemetry=tel)
    japi = JaxFedAvgAPI(setup["jdata"], setup["jtask"], _cfg(jax_=True),
                        telemetry=jtel)
    for r in range(3):
        api.run_round(r)
        japi.run_round(r)
    recs, jrecs = _records(tel), _records(jtel)
    tel.close()
    jtel.close()
    assert len(recs) == 3
    for rec, jrec in zip(recs, jrecs):
        gp, jgp = rec["goodput"], jrec["goodput"]
        assert set(gp["buckets"]) == set(goodput.BUCKETS)
        assert sum(gp["buckets"].values()) == pytest.approx(gp["wall_s"],
                                                            abs=1e-5)
        assert sum(gp["duty"].values()) == pytest.approx(1.0, abs=1e-2)
        assert gp["variant"] == jgp["variant"] == "round_b4"
        assert set(jgp) <= set(gp) and gp["flops_per_s"] > 0
        assert rec["agg"] == jrec["agg"]
        assert set(rec) - {"mem"} >= set(jrec) - {"mem"}


def test_round_cost_is_counted_once_per_variant(setup, monkeypatch):
    """The engine counts the round variant's FLOPs once (3 x forward x
    K x B x bs, padded slots included) however many rounds it records."""
    calls = []
    orig = flops.forward_flops

    def counted(*a):
        calls.append(1)
        return orig(*a)

    monkeypatch.setattr(flops, "forward_flops", counted)
    goodput.clear_variant_costs()
    tel = Telemetry()
    api = FedAvgAPI(setup["data"], setup["task"], _cfg(), device="cpu",
                    telemetry=tel)
    for r in range(3):
        api.run_round(r)
    tel.close()
    fwd = orig(setup["task"], api.net, setup["data"].train_x[:1])
    assert fwd == 2 * 36 * 3  # the LR's one matmul, 6x6x1 -> 3
    assert calls == [1]
    assert goodput.variant_cost("round_b4") == {
        "flops": 3.0 * fwd * 3 * 4 * 8, "bytes": None}


def test_instrumentation_off_bitwise_identical_model_bits(setup,
                                                          monkeypatch):
    """Telemetry off vs the full bundle (HTTP, memwatch, health): the same
    model bits, and the off engine counts no FLOPs and waits for no
    device."""
    plain = FedAvgAPI(setup["data"], setup["task"], _cfg(), device="cpu")
    with monkeypatch.context() as mp:
        mp.setattr(flops, "forward_flops", lambda *a: pytest.fail("counted"))
        mp.setattr(FedAvgAPI, "_goodput_wait",
                   lambda self: pytest.fail("synced"))
        for r in range(3):
            plain.run_round(r)
    tel = Telemetry(http_port=0, memwatch=True, health=True)
    armed = FedAvgAPI(setup["data"], setup["task"], _cfg(), device="cpu",
                      telemetry=tel)
    for r in range(3):
        armed.run_round(r)
    tel.close()
    assert _bits(plain.net) == _bits(armed.net)


def _frames(monkeypatch):
    frames = []
    orig = Message.to_bytes
    monkeypatch.setattr(Message, "to_bytes",
                        lambda self, *a, **k: frames.append(
                            f := orig(self, *a, **k)) or f)
    return frames


def test_instrumentation_off_identical_wire_bytes(setup, monkeypatch):
    """A loopback run with and without telemetry: byte-identical frames
    (the ranks' threads interleave, so compared as multisets) and the same
    model bits. Its server rounds carry the
    reference's duty-only goodput block (no FLOP figures: the server runs
    no round program), summing to the round's wall."""
    frames = _frames(monkeypatch)
    off = run_simulated(setup["data"], setup["task"], _cfg(comm_round=2),
                        job_id="tg-off", device="cpu")
    off_frames, frames[:] = list(frames), []
    tel = Telemetry()
    on = run_simulated(setup["data"], setup["task"], _cfg(comm_round=2),
                       job_id="tg-on", device="cpu", telemetry=tel)
    tel.close()
    assert sorted(frames) == sorted(off_frames)
    assert [np.asarray(v).tobytes() for v in pack_pytree(off.net)] == \
        [np.asarray(v).tobytes() for v in pack_pytree(on.net)]
    recs = _records(tel)
    assert len(recs) == 2
    for r in recs:
        gp = r["goodput"]
        assert "flops_per_s" not in gp and "variant" not in gp
        assert sum(gp["buckets"].values()) == pytest.approx(gp["wall_s"],
                                                            abs=1e-5)
        assert gp["buckets"]["wire_wait"] > 0.0


# ------------------------------------------------------------ pack block
@pytest.mark.parametrize("device_data", [True, False])
@pytest.mark.parametrize("max_batches", [None, 2])
def test_pack_block_matches_the_jax_engine(setup, device_data, max_batches):
    """The pack block of the same configuration and seed: bucket_B,
    b_needed, budget_B, pad_frac and bytes bitwise the JAX engine's (the
    port packs the reference's dtypes: int32 indices, float32 masks and
    pixels)."""
    tel, jtel = Telemetry(), JaxTelemetry()
    kw = dict(max_batches=max_batches)
    api = FedAvgAPI(setup["data"], setup["task"], _cfg(**kw), device="cpu",
                    telemetry=tel, device_data=device_data)
    japi = JaxFedAvgAPI(setup["jdata"], setup["jtask"], _cfg(True, **kw),
                        telemetry=jtel, device_data=device_data)
    for r in range(3):
        api.run_round(r)
        japi.run_round(r)
    mine = [r["pack"] for r in _records(tel)]
    ref = [r["pack"] for r in _records(jtel)]
    tel.close()
    jtel.close()
    assert mine == ref and len(mine) == 3
    # the budget of 2 batches fills every client; the natural depth pads
    assert any(p["pad_frac"] > 0 for p in mine) == (max_batches is None)
    assert api._pack_stats == {}  # popped into the records


def test_provenance_block_and_stamp_relay_safety():
    """The port's provenance block: the reference's keys, with torch's
    version and the CUDA toolkit in place of jax / jaxlib; device fields
    None in a process that never initialized CUDA; stamp() never
    overwrites a block."""
    from fedml_tpu.obs.provenance import provenance as jax_provenance
    from fedml_tpu_torch.obs.provenance import provenance, stamp

    mine, ref = provenance(date="d"), jax_provenance(date="d")
    assert set(mine) - {"torch", "cuda"} == set(ref) - {"jax", "jaxlib"}
    assert mine["torch"] == torch.__version__.split("+")[0] or \
        mine["torch"].startswith(torch.__version__.split("+")[0])
    assert mine["git_sha"] == ref["git_sha"]
    assert mine["device_kind"] is None and mine["device_count"] is None
    blob = {"provenance": {"git_sha": "keep"}}
    assert stamp(blob)["provenance"] == {"git_sha": "keep"}
    assert stamp({}, date="x")["provenance"]["date"] == "x"
