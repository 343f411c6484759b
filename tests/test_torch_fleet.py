"""The fleet observability plane in the port (fedml_tpu_torch/obs/fleet.py,
the server's marker and ingest, the client's digest, the edge's relay and
fold, /fleetz) against the JAX package's, on tests/test_fleet.py's tiny
configuration (synthetic images of 4 clients, 6x6x1, 3 classes,
LogisticRegression; the tree 1 root + 2 edges + 4 workers).

Digests are JSON header scalars, so the contracts are exact: the same
digests give both collectors equal /fleetz JSON and rollup gauges (on an
injected clock), each package's collector ingests the other's clients'
digests, and a digest stays within DIGEST_BYTE_BUDGET. With the plane off
no frame carries ``__telemetry``; with it on, every frame minus that one
key is byte-identical to the plane-off run's, and the model bits are
equal.
"""

import copy
import json
import time
import types
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fedml_tpu.algorithms.fedavg import FedAvgConfig as JaxConfig
from fedml_tpu.core.tasks import classification_task as jax_classification_task
from fedml_tpu.data.synthetic import synthetic_images as jax_synthetic_images
from fedml_tpu.distributed.fedavg import run_simulated as jax_run_simulated
from fedml_tpu.models.linear import LogisticRegression as JaxLR
from fedml_tpu.obs import fleet as jax_fleet
from fedml_tpu.obs import health as jax_health
from fedml_tpu.obs import httpd as jax_httpd
from fedml_tpu.obs import metrics as jax_metrics
from fedml_tpu.obs.events import EventLog as JaxEventLog
from fedml_tpu.obs.events import MemorySink as JaxMemorySink
from fedml_tpu.obs.telemetry import Telemetry as JaxTelemetry
from fedml_tpu_torch import convert
from fedml_tpu_torch.algorithms import FedAvgConfig
from fedml_tpu_torch.comm.message import Message, pack_pytree
from fedml_tpu_torch.core.tasks import classification_task
from fedml_tpu_torch.data.synthetic import synthetic_images
from fedml_tpu_torch.distributed.fedavg import run_simulated
from fedml_tpu_torch.distributed.fedavg.message_define import MyMessage
from fedml_tpu_torch.models import create_model
from fedml_tpu_torch.obs import fleet, health, httpd, metrics
from fedml_tpu_torch.obs.events import EventLog, MemorySink
from fedml_tpu_torch.obs.fleet import (
    DIGEST_BYTE_BUDGET,
    TELEMETRY_KEY,
    DigestEmitter,
    FleetCollector,
    attach_digest,
)
from fedml_tpu_torch.obs.metrics import REGISTRY
from fedml_tpu_torch.obs.telemetry import Telemetry

DATA_KW = dict(num_clients=4, image_shape=(6, 6, 1), num_classes=3,
               samples_per_client=12, test_samples=24, seed=0)
PKGS = {"port": (fleet, health, metrics, EventLog, MemorySink),
        "jax": (jax_fleet, jax_health, jax_metrics, JaxEventLog,
                JaxMemorySink)}


def _cfg(per_round=2, jax_=False):
    return (JaxConfig if jax_ else FedAvgConfig)(
        comm_round=2, client_num_in_total=4, client_num_per_round=per_round,
        batch_size=6, frequency_of_the_test=1)


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


def _telemetry_bytes() -> float:
    return float(REGISTRY.snapshot().get("comm_bytes_total", {}).get(
        "codec=json,direction=telemetry", 0.0))


def _collector(pkg, clock, **kw):
    f, _, m, _, _ = PKGS[pkg]
    reg = m.MetricsRegistry()
    return f.FleetCollector(run_id="r-x", registry=reg, clock=clock,
                            **kw), reg


def _fleet_gauges(reg) -> dict:
    return {k: v for k, v in reg.snapshot().items()
            if k.startswith("fed_fleet_")}


# ------------------------------------------------------------ digest units
def test_telemetry_key_pinned_to_protocol_vocabulary():
    from fedml_tpu.distributed.fedavg.message_define import (
        MyMessage as JaxMyMessage,
    )

    assert MyMessage.MSG_ARG_KEY_TELEMETRY == TELEMETRY_KEY == \
        jax_fleet.TELEMETRY_KEY == JaxMyMessage.MSG_ARG_KEY_TELEMETRY == \
        "__telemetry"
    assert DIGEST_BYTE_BUDGET == jax_fleet.DIGEST_BYTE_BUDGET == 1024


def test_digest_shape_and_byte_budget():
    """The port's emitter packs the reference's blob within the budget,
    accounts its attach under the telemetry direction, and the reference's
    collector ingests it into the same row the port's collector builds."""
    em = DigestEmitter(rank=3, run_id="r-unit",
                       registry=metrics.MetricsRegistry())
    for _ in range(5):
        with em.phase("local_fit"):
            time.sleep(0.001)
    em.digest(4)
    with em.phase("local_fit"):
        time.sleep(0.001)
    blob = em.digest(5, wave=2, eps=1.25, gflops=12.345)
    assert blob["rank"] == 3 and blob["round"] == 5 and blob["wave"] == 2
    assert blob["run"] == "r-unit" and blob["eps"] == 1.25
    assert blob["gf"] == 12.345 and 0.0 < blob["duty"] <= 1.0
    p50, p95, p99 = blob["spans"]["local_fit"]
    assert 0.0 < p50 <= p95 <= p99
    wire = len(json.dumps(blob, default=float).encode())
    assert wire <= DIGEST_BYTE_BUDGET
    before = _telemetry_bytes()
    msg = types.SimpleNamespace(params={})
    msg.add_params = msg.params.__setitem__
    attach_digest(msg, blob)
    assert msg.params[TELEMETRY_KEY] is blob
    assert _telemetry_bytes() - before == wire
    t = [50.0]
    rows = []
    for pkg in ("port", "jax"):
        col, _ = _collector(pkg, lambda: t[0])
        col.ingest(json.loads(json.dumps(blob)))
        rows.append(col.snapshot())
    assert rows[0] == rows[1] and set(rows[0]["ranks"]) == {"3"}


def test_marker_carries_run_and_job():
    for job in ("", "tenant-a"):
        mine = FleetCollector(run_id="r1", job=job,
                              registry=metrics.MetricsRegistry())
        ref = jax_fleet.FleetCollector(
            run_id="r1", job=job, registry=jax_metrics.MetricsRegistry())
        assert mine.marker() == ref.marker()


def _seeded_digests(seed: int) -> list:
    rng = np.random.default_rng(seed)
    out = []
    for i in range(12):
        rank = int(rng.integers(1, 5))
        d = {"rank": rank, "round": int(i // 3), "run": "r-x",
             "ctr": {"bytes_uplink": int(rng.integers(1, 10_000)),
                     "messages_sent": 1},
             "spans": {"local_fit": sorted(
                 round(float(v), 6) for v in rng.uniform(0, 1, 3))},
             "duty": round(float(rng.uniform(0, 1)), 3)}
        if rng.uniform() < 0.5:
            d["eps"] = round(float(rng.uniform(0, 5)), 6)
        if rng.uniform() < 0.3:  # an edge's folded blob
            d["block"] = [{"rank": 5 + j, "round": int(i // 3),
                           "run": "r-x"} for j in range(2)]
        out.append(d)
    return out


@pytest.mark.parametrize("seed", range(3))
def test_collectors_agree_on_seeded_digests(seed):
    """The same digests (an edge's folded blocks among them) through both
    packages' collectors on one injected clock: equal /fleetz JSON and
    equal fed_fleet_* rollup gauges; a malformed blob never raises."""
    out = {}
    for pkg in ("port", "jax"):
        t = [100.0]
        col, reg = _collector(pkg, lambda: t[0], expected_ranks=6)
        for d in _seeded_digests(seed):
            t[0] += 1.5
            col.ingest(copy.deepcopy(d))
        col.ingest("garbage")
        t[0] += 70.0  # past the staleness threshold
        col.refresh()
        out[pkg] = (col.snapshot(), _fleet_gauges(reg))
    assert out["port"] == out["jax"]
    snap = out["port"][0]
    assert snap["rollup"]["round_max"] == 3
    folded = any("block" in d for d in _seeded_digests(seed))
    assert ({"5", "6"} <= set(snap["ranks"])) == folded


def test_fleet_rules_gate_rampup_then_fire():
    """fleet_quorum stays silent through round-0 ramp-up and fires once
    the fleet reached round 1 with a rank missing; fleet_staleness fires on
    a silent rank — the same transitions in both packages."""
    out = {}
    for pkg in ("port", "jax"):
        f, h, m, log, sink = PKGS[pkg]
        t = [1000.0]
        reg = m.MetricsRegistry()
        col = f.FleetCollector(run_id="rq", registry=reg, expected_ranks=3,
                               clock=lambda: t[0])
        mon = h.HealthMonitor(
            telemetry=types.SimpleNamespace(fleet=col, events=log(sink())),
            registry=reg, expected_ranks=3, clock=lambda: t[0],
            rules=[{"rule": "fleet_quorum", "severity": "critical",
                    "min_fraction": 1.0},
                   {"rule": "fleet_staleness", "severity": "warning",
                    "max_age_s": 30.0}])
        steps = [mon.check()]
        col.ingest({"rank": 1, "round": 0})
        steps.append(mon.check())  # round-0 ramp-up: boot order
        col.ingest({"rank": 2, "round": 0})
        col.ingest({"rank": 1, "round": 1})  # rank 3 never reports
        steps.append(mon.check())
        t[0] += 60.0
        steps.append(mon.check())
        out[pkg] = [[(a["rule"], a["state"], a["value"], a["threshold"])
                     for a in s] for s in steps]
    assert out["port"] == out["jax"]
    assert out["port"][:2] == [[], []]
    assert [a[0] for a in out["port"][2]] == ["fleet_quorum"]
    assert [a[0] for a in out["port"][3]] == ["fleet_staleness"]


# --------------------------------------------------- end-to-end (loopback)
def _capture(monkeypatch):
    """Every frame encoded, and the same frame with the fleet key
    stripped (what the wire would carry with the plane off)."""
    frames, stripped = [], []
    orig = Message.to_bytes

    def spy(self, *a, **k):
        f = orig(self, *a, **k)
        frames.append(f)
        bare = copy.copy(self)
        bare.msg_params = {key: v for key, v in self.msg_params.items()
                           if key != TELEMETRY_KEY}
        stripped.append(orig(bare, *a, **k))
        return f

    monkeypatch.setattr(Message, "to_bytes", spy)
    return frames, stripped


@pytest.mark.parametrize("edges", [None, 2])
def test_fleet_off_wire_and_model_identical(setup, monkeypatch, edges):
    """Plane off: no frame carries ``__telemetry``. Plane on (flat, and the
    tree with its relay and fold): every frame minus that key is
    byte-identical to the plane-off run's (the ranks' threads interleave,
    so compared as multisets) and the model bits are equal."""
    per_round = 4 if edges else 2
    frames, stripped = _capture(monkeypatch)
    off = run_simulated(setup["data"], setup["task"], _cfg(per_round),
                        job_id=f"tf-off-{edges}", edges=edges, device="cpu")
    off_frames = list(frames)
    assert off_frames and not any(b"__telemetry" in f for f in off_frames)
    frames.clear()
    stripped.clear()
    tel = Telemetry(fleet=True)
    on = run_simulated(setup["data"], setup["task"], _cfg(per_round),
                       job_id=f"tf-on-{edges}", edges=edges, device="cpu",
                       telemetry=tel)
    tel.close()
    assert sum(b"__telemetry" in f for f in frames) >= len(frames) // 2
    assert sorted(stripped) == sorted(off_frames)
    assert [np.asarray(v).tobytes() for v in pack_pytree(off.net)] == \
        [np.asarray(v).tobytes() for v in pack_pytree(on.net)]


def test_flat_fleetz_over_http_and_byte_budget(setup):
    """A 3-rank flat run with the plane armed: /fleetz serves a row for
    every rank, the rollup tracks both rounds, the digests' wire bytes
    stay within the budget per rank per round, and the server's round
    records carry the duty-only goodput block."""
    bytes_before = _telemetry_bytes()
    tel = Telemetry(fleet=True, http_port=0, memwatch=False)
    run_simulated(setup["data"], setup["task"], _cfg(), job_id="tf-fleetz",
                  device="cpu", telemetry=tel)
    snap = json.loads(urllib.request.urlopen(tel.httpd.url("/fleetz"),
                                             timeout=5).read())
    overhead = _telemetry_bytes() - bytes_before
    tel.close()
    assert set(snap["ranks"]) == {"0", "1", "2"}
    assert snap["status"] == "ok" and snap["ranks_reporting"] == 3
    assert snap["expected_ranks"] == 2 and snap["run"] == tel.events.run_id
    assert snap["rollup"]["round_max"] == 1
    for r in ("1", "2"):
        assert snap["ranks"][r]["bytes_uplink"] > 0
        assert snap["ranks"][r]["spans"]
    assert snap["digests_total"] == 4  # 2 ranks x 2 rounds
    assert overhead / snap["digests_total"] <= DIGEST_BYTE_BUDGET
    rounds = [r for r in tel.events.sink.records if r["kind"] == "round"]
    assert len(rounds) == 2 and all("goodput" in r for r in rounds)


def test_tree_root_ingests_one_folded_blob_per_edge(setup, monkeypatch):
    """The tree (1 root + 2 edges + 4 workers): each edge forwards ONE
    folded blob a round (its own digest, its block's two under "block"),
    so the root ingests 2 blobs a round, yet /fleetz holds a row for every
    rank."""
    blobs = []
    orig = FleetCollector.ingest
    monkeypatch.setattr(FleetCollector, "ingest",
                        lambda self, b: (blobs.append(b), orig(self, b)))
    tel = Telemetry(fleet=True)
    run_simulated(setup["data"], setup["task"], _cfg(4), edges=2,
                  job_id="tf-tree", device="cpu", telemetry=tel)
    snap = tel.fleet.snapshot()
    tel.close()
    got = [b for b in blobs if isinstance(b, dict)]
    assert len(got) == 4  # 2 edges x 2 rounds
    assert sorted(b["rank"] for b in got) == [1, 1, 2, 2]
    assert all(sorted(c["rank"] for c in b["block"]) ==
               ([3, 4] if b["rank"] == 1 else [5, 6]) for b in got)
    assert set(snap["ranks"]) == {str(r) for r in range(7)}
    assert snap["expected_ranks"] == 6 and snap["rollup"]["round_max"] == 1


@pytest.mark.parametrize("clients", ["port", "jax"])
def test_digests_cross_packages(setup, monkeypatch, clients):
    """A real run's client digests (the port's clients, or the JAX
    package's) ingested by both packages' collectors on one injected
    clock: equal rows, one per client rank."""
    blobs = []
    if clients == "port":
        orig = FleetCollector.ingest
        monkeypatch.setattr(FleetCollector, "ingest",
                            lambda self, b: (blobs.append(b), orig(self, b)))
        tel = Telemetry(fleet=True)
        run_simulated(setup["data"], setup["task"], _cfg(),
                      job_id="tf-x-port", device="cpu", telemetry=tel)
    else:
        orig = jax_fleet.FleetCollector.ingest
        monkeypatch.setattr(jax_fleet.FleetCollector, "ingest",
                            lambda self, b: (blobs.append(b), orig(self, b)))
        tel = JaxTelemetry(fleet=True)
        jax_run_simulated(setup["jdata"], setup["jtask"], _cfg(jax_=True),
                          job_id="tf-x-jax", telemetry=tel)
    tel.close()
    monkeypatch.undo()  # the collectors below must not capture again
    assert len(blobs) == 4
    snaps = []
    for pkg in ("port", "jax"):
        col, reg = _collector(pkg, lambda: 10.0, expected_ranks=2)
        for b in blobs:
            col.ingest(json.loads(json.dumps(b)))
        snaps.append((col.snapshot(), _fleet_gauges(reg)))
    assert snaps[0] == snaps[1]
    assert set(snaps[0][0]["ranks"]) == {"1", "2"}


def test_fleetz_404_without_collector():
    for h, m in ((httpd, metrics), (jax_httpd, jax_metrics)):
        srv = h.MetricsHTTPServer(port=0, registry=m.MetricsRegistry())
        try:
            with pytest.raises(urllib.request.HTTPError) as e:
                urllib.request.urlopen(srv.url("/fleetz"), timeout=5)
            assert e.value.code == 404
        finally:
            srv.close()
