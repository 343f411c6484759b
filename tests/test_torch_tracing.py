"""The port's round telemetry and tracing against the JAX package's: the
obs modules are copies (clock, events, tracing, trace_export), the golden
Chrome trace is the reference's byte for byte, ``round_stats`` equals the
JAX function on the same inputs, the engine's pack / round / eval spans
and round records, and the cross-process runtime's stitched per-round
timeline (client unpack / local_fit / pack spans under the server's
broadcast), which leaves the run's result unchanged. Mirrors
tests/test_tracing.py and tests/test_obs.py at a tiny size."""

import json
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.algorithms import fedavg as jax_fedavg
from fedml_tpu.core.local import NetState
from fedml_tpu.core.tasks import classification_task as jax_classification_task
from fedml_tpu.data.synthetic import synthetic_images as jax_synthetic_images
from fedml_tpu.models.linear import LogisticRegression as JaxLR
from fedml_tpu.obs.telemetry import Telemetry as JaxTelemetry
from fedml_tpu_torch import convert
from fedml_tpu_torch.algorithms import FedAvgAPI, FedAvgConfig
from fedml_tpu_torch.algorithms.fedavg import round_stats
from fedml_tpu_torch.comm.message import Message, pack_pytree
from fedml_tpu_torch.core.tasks import classification_task
from fedml_tpu_torch.data.synthetic import synthetic_images
from fedml_tpu_torch.distributed.fedavg import run_simulated
from fedml_tpu_torch.models import create_model
from fedml_tpu_torch.obs.telemetry import Telemetry
from fedml_tpu_torch.obs.trace_export import (
    to_chrome_trace,
    validate_chrome_trace,
    validate_spans,
)
from fedml_tpu_torch.obs.tracing import (
    TRACE_KEY,
    ClientSpanBuffer,
    DistributedTracer,
)

ROOT = Path(__file__).resolve().parents[1]
DATA_KW = dict(num_clients=4, image_shape=(6, 6, 1), num_classes=3,
               samples_per_client=12, test_samples=24, seed=0)
CFG = dict(comm_round=2, client_num_in_total=4, client_num_per_round=2,
           batch_size=6, frequency_of_the_test=1)


def copy_of(path: str) -> str:
    return re.sub(r"\bfedml_tpu\b", "fedml_tpu_torch",
                  (ROOT / "fedml_tpu" / path).read_text())


@pytest.mark.parametrize("path", ["obs/clock.py", "obs/events.py",
                                  "obs/tracing.py", "obs/trace_export.py"])
def test_copied_modules_match_the_reference(path):
    assert (ROOT / "fedml_tpu_torch" / path).read_text() == copy_of(path)


def _golden_trace():
    """test_tracing.py's deterministic trace, built with the port's tracer
    and span buffer on an injected clock."""
    from fedml_tpu_torch.obs import comm_instrument as _ci

    _ci._tls.last_dispatch_s = None  # no queue-wait attr from another test
    t = {"now": 1000.0}

    def clock():
        t["now"] += 0.125
        return t["now"]

    tr = DistributedTracer("golden-run", clock=clock)
    tr.begin_round(0)
    c1, c2 = tr.broadcast_ctx(1), tr.broadcast_ctx(2)
    tr.end_broadcast()
    b1 = ClientSpanBuffer(1, clock=clock)
    b1.on_broadcast(c1)
    for name in ("unpack", "local_fit", "pack"):
        with b1.span(name):
            pass
    tr.on_upload(1, b1.upload_blob())
    b2 = ClientSpanBuffer(2, clock=clock)
    b2.on_broadcast(c2)
    with b2.span("local_fit"):
        pass
    tr.on_upload(2, b2.upload_blob())
    tr.record_span("aggregate", clock(), clock())
    return tr, tr.finish_round()


def test_chrome_trace_export_is_the_reference_golden():
    tr, cp = _golden_trace()
    assert validate_spans(tr.spans()) == []
    doc = to_chrome_trace(tr.spans())
    assert validate_chrome_trace(doc) == []
    golden = json.loads((ROOT / "tests/data/golden_trace.json").read_text())
    assert doc == golden
    assert cp["straggler"] == 2
    assert cp["slack_s"] == {1: 0.625, 2: 0.0}


def test_round_stats_equals_jax():
    """round_stats on the same stacked client params, entering and
    averaged model and sample counts (one client zero-sample padding) as
    the JAX function, float32, within 1e-6 relative."""
    rs = np.random.RandomState(0)
    shapes = {"w": (5, 3), "b": (3,)}
    old = {k: rs.randn(*s).astype(np.float32) for k, s in shapes.items()}
    nets = {k: rs.randn(4, *s).astype(np.float32) for k, s in shapes.items()}
    nsamp = np.array([6.0, 0.0, 3.0, 1.0], np.float32)
    w = nsamp / nsamp.sum()
    avg = {k: np.tensordot(w, v, axes=1).astype(np.float32)
           for k, v in nets.items()}
    t = lambda d: {k: torch.from_numpy(v) for k, v in d.items()}
    got = round_stats(t(old), t(avg), t(nets), t(avg), torch.from_numpy(nsamp))
    net = lambda d: NetState({k: jnp.asarray(v) for k, v in d.items()}, {})
    want = jax_fedavg.round_stats(net(old), net(avg), net(nets), net(avg),
                                  jnp.asarray(nsamp))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-6)


@pytest.fixture(scope="module")
def sim_setup():
    """Both packages' data and tasks at test_tracing.py's sim size, the
    port's task starting from the JAX engine's initial params."""
    jdata = jax_synthetic_images(**DATA_KW)
    jtask = jax_classification_task(JaxLR(num_classes=3))
    japi = jax_fedavg.FedAvgAPI(jdata, jtask, jax_fedavg.FedAvgConfig(**CFG))
    state = convert.from_flax(jax.tree.map(np.asarray, japi.net.params))
    task = classification_task(create_model("lr", output_dim=3, device="cpu"))
    task = task._replace(init=lambda g, x=None: {k: v.clone()
                                                 for k, v in state.items()})
    return dict(data=synthetic_images(**DATA_KW), task=task, jdata=jdata,
                jtask=jtask)


def test_engine_spans_and_round_records_match_jax(sim_setup):
    """The engine times pack / round / eval every round; with a traced
    Telemetry bundle it emits one round record a round whose metrics
    (summed fit metrics and round_stats) equal the JAX engine's record of
    the same rounds within 1e-5, its spans feed a single-rank timeline,
    and its history equals the run without telemetry bitwise."""
    cfg = FedAvgConfig(**CFG)
    plain = FedAvgAPI(sim_setup["data"], sim_setup["task"], cfg, device="cpu")
    plain.train()
    s = plain.tracer.summary()
    assert s["pack"]["count"] == 2 and s["round"]["count"] == 2
    assert "eval" in s
    tel = Telemetry(trace=True)
    api = FedAvgAPI(sim_setup["data"], sim_setup["task"], cfg, device="cpu",
                    telemetry=tel)
    api.train()
    assert api.history == [dict(h, round_time=r["round_time"])
                           for h, r in zip(plain.history, api.history)]
    jtel = JaxTelemetry()
    jax_fedavg.FedAvgAPI(sim_setup["jdata"], sim_setup["jtask"],
                         jax_fedavg.FedAvgConfig(**CFG),
                         telemetry=jtel).train()
    rounds = [r for r in tel.events.sink.records if r["kind"] == "round"]
    jrounds = [r for r in jtel.events.sink.records if r["kind"] == "round"]
    assert [r["round"] for r in rounds] == [0, 1]
    for r, j in zip(rounds, jrounds):
        assert r["clients"] == j["clients"]
        assert {"pack", "round"} <= set(r["spans"])
        assert set(r["metrics"]) == set(j["metrics"])
        for k, v in j["metrics"].items():
            np.testing.assert_allclose(r["metrics"][k], v, rtol=1e-5,
                                       atol=1e-6, err_msg=k)
    assert [r["kind"] for r in tel.events.sink.records][0] == "run"
    spans = tel.tracer.spans()
    assert {s["name"] for s in spans} >= {"pack", "round"}
    assert all(s["rank"] == 0 for s in spans)
    tel.close()
    jtel.close()


def test_loopback_stitch(sim_setup):
    """3 ranks over loopback: one stitched timeline per round — client
    spans parented under the server's broadcast span, wire spans on both
    ends, a critical-path record on every round."""
    tel = Telemetry(trace=True)
    run_simulated(sim_setup["data"], sim_setup["task"], FedAvgConfig(**CFG),
                  job_id="t-torch-stitch", telemetry=tel, device="cpu")
    rounds = [r for r in tel.events.sink.records if r["kind"] == "round"]
    assert [r["round"] for r in rounds] == [0, 1]
    for r in rounds:
        cp = r["critical_path"]
        assert cp["straggler"] in (1, 2)
        assert cp["slack_s"][cp["straggler"]] == 0.0
        assert {"downlink", "unpack", "local_fit", "pack", "uplink",
                "aggregate", "eval"} <= set(cp["phases"])
        assert set(cp["clock_offset_s"]) == {1, 2}
        assert r["metrics"]["num_samples"] > 0 and r["agg"]["mode"]
    spans = tel.tracer.spans()
    assert validate_spans(spans) == []
    assert {s["rank"] for s in spans} == {0, 1, 2}
    by_sid = {s["sid"]: s for s in spans}
    roots = [s for s in spans if s["name"] == "client_round"]
    assert len(roots) == 4
    for root in roots:
        assert by_sid[root["parent"]]["name"] == "broadcast"
    for kid in (s for s in spans if s["name"] in ("unpack", "local_fit",
                                                  "pack")):
        parent = by_sid[kid["parent"]]
        assert parent["name"] == "client_round"
        assert parent["rank"] == kid["rank"]
    tel.close()


def test_tracing_leaves_the_run_unchanged(sim_setup, monkeypatch):
    """With tracing off no frame carries trace context; with it on, the
    frames grow only by the trace parameter and the run's history and
    model are the untraced run's, bitwise."""
    frames = []
    orig = Message.to_bytes
    monkeypatch.setattr(Message, "to_bytes",
                        lambda self, codec=None: frames.append(
                            f := orig(self, codec)) or f)
    run = lambda job, **kw: run_simulated(
        sim_setup["data"], sim_setup["task"], FedAvgConfig(**CFG),
        job_id=job, device="cpu", **kw)
    plain = run("t-torch-trace-off")
    plain_frames, frames[:] = list(frames), []
    assert plain_frames and not any(b"__trace" in f for f in plain_frames)
    tel = Telemetry(trace=True)
    traced = run("t-torch-trace-on", telemetry=tel)
    tel.close()
    traced_frames = list(frames)
    # 2 rounds x 2 clients: a broadcast and an upload each carry context
    assert sum(b"__trace" in f for f in traced_frames) == 8

    def content(frame, drop=()):
        """A frame's params, arrays as (dtype, shape, bytes), sortable."""
        out = []
        for k, v in Message.from_bytes(frame).msg_params.items():
            if k in drop:
                continue
            vs = v if isinstance(v, list) else [v]
            out.append((k, repr([(a.dtype.str, a.shape, a.tobytes())
                                 if isinstance(a, np.ndarray) else a
                                 for a in vs])))
        return sorted(out)

    assert sorted(content(f, (TRACE_KEY,)) for f in traced_frames) == \
        sorted(content(f) for f in plain_frames)
    assert traced.history == plain.history
    for a, b in zip(pack_pytree(plain.net), pack_pytree(traced.net)):
        assert a.tobytes() == b.tobytes()


def test_telemetry_close_writes_trace_and_event_log(sim_setup, tmp_path):
    d = str(tmp_path)
    tel = Telemetry(log_dir=d, trace_dir=d)
    run_simulated(sim_setup["data"], sim_setup["task"], FedAvgConfig(**CFG),
                  job_id="t-torch-trace-file", telemetry=tel, device="cpu")
    tel.close()
    doc = json.loads((tmp_path / "trace.json").read_text())
    assert validate_chrome_trace(doc) == []
    assert any(e.get("name") == "local_fit" for e in doc["traceEvents"])
    kinds = [json.loads(line)["kind"]
             for line in (tmp_path / "events.jsonl").read_text().splitlines()]
    assert kinds[0] == "run" and kinds.count("round") == 2
    assert "fed_span_seconds" in (tmp_path / "metrics.prom").read_text()


@pytest.mark.parametrize("kw", [dict(http_port=0), dict(memwatch=True),
                                dict(health=True), dict(health_rules=[]),
                                dict(fleet=True)],
                         ids=lambda kw: next(iter(kw)))
def test_telemetry_unported_layers_raise(kw):
    """These layers raised until the run-health layer was ported (the name
    is kept): each now arms exactly the layers the JAX package's bundle
    arms for the same arguments."""
    from fedml_tpu.obs.telemetry import Telemetry as JaxTelemetry

    mine, ref = Telemetry(**kw), JaxTelemetry(**kw)
    try:
        for layer in ("httpd", "memwatch", "health", "fleet"):
            assert (getattr(mine, layer) is None) == \
                (getattr(ref, layer) is None), layer
        assert (mine.http_port is None) == (ref.http_port is None)
    finally:
        mine.close()
        ref.close()


def test_telemetry_profile_raises(tmp_path):
    """``profile()`` raised until its torch.profiler bridge was ported
    (the name is kept): it now writes a trace file on the CPU."""
    with Telemetry().profile(str(tmp_path)):
        torch.ones(8) @ torch.ones(8)
    traces = list(tmp_path.glob("*.pt.trace.json"))
    assert len(traces) == 1 and traces[0].stat().st_size > 0
