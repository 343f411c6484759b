"""The rest of the port's obs layer (fedml_tpu_torch/obs: health, httpd,
fleet, export, memwatch, provenance, goodput, perf_instrument, telemetry,
and utils/tracing's torch.profiler bridge) against the JAX package's:
the copies byte-equal up to their imports and named divergences, the
exporters equal on the same records, memwatch on the CUDA allocator's
counters (faked here: this process has no card, and must never create a
CUDA context), the metrics.prom families of an armed run, and the
launcher's live endpoints (tests/test_obs.py, test_health.py's memwatch
half and the launcher's flags)."""

import ast
import json
import re
import subprocess
import sys
import threading
import time
import types
import urllib.request
from pathlib import Path

import pytest
import torch

from fedml_tpu.obs import export as jax_export
from fedml_tpu.obs import memwatch as jax_memwatch
from fedml_tpu_torch.algorithms import FedAvgAPI, FedAvgConfig
from fedml_tpu_torch.comm import loopback
from fedml_tpu_torch.core.tasks import classification_task
from fedml_tpu_torch.data.synthetic import synthetic_images
from fedml_tpu_torch.experiments import distributed_launch
from fedml_tpu_torch.models import create_model
from fedml_tpu_torch.obs import export, health, memwatch, metrics
from fedml_tpu_torch.obs.telemetry import Telemetry
from test_torch_comm import cut_named

ROOT = Path(__file__).resolve().parents[1]
DATA_KW = dict(num_clients=6, image_shape=(6, 6, 1), num_classes=3,
               samples_per_client=12, test_samples=24, seed=0)
# copy -> its named divergences (cut_named): the definitions the port
# rewrote because the reference asks JAX there
OBS_COPIES = {
    "obs/health.py": (),
    "obs/httpd.py": (),
    "obs/fleet.py": (),
    "obs/export.py": ("__doc__",),
    "obs/memwatch.py": ("__doc__", "device_memory_stats"),
    "obs/provenance.py": ("__doc__", "_device_info", "provenance"),
    "obs/goodput.py": ("__doc__", "PEAK_FLOPS_BF16", "device_peak_flops",
                       "record_variant_cost"),
    "obs/perf_instrument.py": ("__doc__", "install", "attribute_compiles",
                               "variant_compile_stats",
                               "ensure_compile_attr_families",
                               # its docstring cites the reference's history
                               "set_server_state_bytes"),
    "obs/telemetry.py": ("__doc__", "Telemetry.profile"),
}


def _copy_of(path: str) -> str:
    return re.sub(r"\bfedml_tpu\b", "fedml_tpu_torch",
                  (ROOT / "fedml_tpu" / path).read_text())


@pytest.mark.parametrize("path", sorted(OBS_COPIES))
def test_copied_obs_modules_match_the_reference(path):
    names = OBS_COPIES[path]
    port = (ROOT / "fedml_tpu_torch" / path).read_text()
    assert cut_named(port, names) == cut_named(_copy_of(path), names)


def test_telemetry_profile_differs_only_in_its_docstring():
    """Telemetry.profile is cut from the copy test for its docstring: its
    code is the reference's."""
    def body(src):
        cls = next(n for n in ast.parse(src).body
                   if isinstance(n, ast.ClassDef) and n.name == "Telemetry")
        fn = next(n for n in cls.body if getattr(n, "name", "") == "profile")
        return ast.dump(ast.Module(body=fn.body[1:], type_ignores=[]))

    assert body((ROOT / "fedml_tpu_torch/obs/telemetry.py").read_text()) == \
        body(_copy_of("obs/telemetry.py"))


def test_obs_exports_the_reference_names():
    import fedml_tpu.obs as jax_obs
    import fedml_tpu_torch.obs as obs

    assert obs.__all__ == jax_obs.__all__
    assert all(hasattr(obs, n) for n in obs.__all__)


def test_port_and_chip_smoke_import_no_jax():
    """No module of the port and nothing in chip_smoke.py (or the port's
    MQTT soak script, or the rank-side scenarios of the sequence-parallel
    tests, which run on the port alone) imports jax, a JAX-ecosystem
    package or anything of fedml_tpu (an import statement, at any depth,
    naming one)."""
    banned = re.compile(r"^(jax|jaxlib|flax|optax|orbax|fedml_tpu)(\.|$)")
    files = sorted((ROOT / "fedml_tpu_torch").rglob("*.py")) + \
        [ROOT / "chip_smoke.py", ROOT / "scripts" / "torch_mqtt_soak.py",
         ROOT / "tests" / "test_torch_seq_ranks.py"]
    bad = []
    for f in files:
        for node in ast.walk(ast.parse(f.read_text())):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""]
                     if isinstance(node, ast.ImportFrom) and not node.level
                     else [])
            bad += [f"{f.name}: {n}" for n in names if banned.match(n)]
    assert len(files) > 60 and not bad, bad


# --------------------------------------------------------------- memwatch
def test_memwatch_on_a_cpu_process_reports_no_device():
    """A process with no CUDA context: no device stats (never zeros), the
    host RSS, the reference's block and gauges; sampling creates no CUDA
    context."""
    out = {}
    for mod, m in ((memwatch, metrics),
                   (jax_memwatch, __import__("fedml_tpu.obs.metrics",
                                             fromlist=["x"]))):
        reg = m.MetricsRegistry()
        w = mod.MemoryWatcher(registry=reg).start()
        block = w.sample()
        w.stop()
        out[mod.__name__] = (set(block), set(reg.snapshot()))
        assert mod.device_memory_stats() == {}
        assert block["host_rss_bytes"] > 1 << 20
    mine, ref = out.values()
    assert mine == ref
    assert not torch.cuda.is_initialized()


class _FakeCuda:
    """torch.cuda's allocator counters for two initialized cards."""

    def __init__(self, initialized=True):
        self._init = initialized

    def is_initialized(self):
        return self._init

    def device_count(self):
        return 2

    def memory_stats(self, i):
        return {"allocated_bytes.all.current": 900 + i,
                "allocated_bytes.all.peak": 950 + 10 * i}

    def get_device_properties(self, i):
        return types.SimpleNamespace(total_memory=1000)


def test_memwatch_reads_the_cuda_allocator(monkeypatch):
    """With CUDA initialized, each card is ``gpu:<i>`` (JAX's label for a
    CUDA device) with the allocator's current and peak allocated bytes and
    the card's memory as the limit; the reference's device_memory rule
    fires on those gauges exactly as on the port's monitor. Uninitialized:
    nothing, and no probe of the card."""
    monkeypatch.setattr(torch, "cuda", _FakeCuda())
    assert memwatch.device_memory_stats() == {
        "gpu:0": {"bytes_in_use": 900, "peak_bytes": 950,
                  "bytes_limit": 1000},
        "gpu:1": {"bytes_in_use": 901, "peak_bytes": 960,
                  "bytes_limit": 1000}}
    reg = metrics.MetricsRegistry()
    block = memwatch.MemoryWatcher(registry=reg).sample()
    assert block["device_bytes_in_use"] == 1801
    assert block["device_peak_bytes"] == 960
    from fedml_tpu.obs.health import HealthMonitor as JaxMonitor

    rule = [{"rule": "device_memory", "severity": "critical",
             "max_fraction": 0.9}]
    verdicts = []
    for mon in (health.HealthMonitor(registry=reg, rules=rule),
                JaxMonitor(registry=reg, rules=rule)):
        verdicts.append([(a["rule"], a["state"], a["value"])
                         for a in mon.check()])
    assert verdicts[0] == verdicts[1] == [("device_memory", "fired", 0.901)]
    monkeypatch.setattr(torch, "cuda", _FakeCuda(initialized=False))
    assert memwatch.device_memory_stats() == {}


# ---------------------------------------------------------------- export
@pytest.fixture(scope="module")
def engine_records():
    """Two telemetry rounds and an eval of the port's engine."""
    data = synthetic_images(**DATA_KW)
    task = classification_task(create_model("lr", output_dim=3,
                                            device="cpu"))
    tel = Telemetry(registry=metrics.MetricsRegistry())
    cfg = FedAvgConfig(comm_round=2, client_num_in_total=6,
                       client_num_per_round=3, batch_size=8, lr=0.1,
                       frequency_of_the_test=1)
    FedAvgAPI(data, task, cfg, device="cpu", telemetry=tel).train()
    tel.close()
    return tel.events.sink.records


def test_write_csv_and_bench_blob_match_reference(engine_records, tmp_path):
    cols = export.write_csv(engine_records, str(tmp_path / "a.csv"),
                            kinds=("round", "eval"))
    jcols = jax_export.write_csv(engine_records, str(tmp_path / "b.csv"),
                                 kinds=("round", "eval"))
    assert cols == jcols and "goodput.buckets.compute" in cols
    assert (tmp_path / "a.csv").read_text() == (tmp_path / "b.csv").read_text()
    blob = export.bench_blob(engine_records, platform="gpu")
    assert blob == jax_export.bench_blob(engine_records, platform="gpu")
    assert blob["rounds"] == 2 and blob["basis"] == "span"
    reg = metrics.MetricsRegistry()
    reg.counter("fed_x_total", k="v").inc(3)
    export.write_prometheus(reg, str(tmp_path / "a.prom"))
    jax_export.write_prometheus(reg, str(tmp_path / "b.prom"))
    assert (tmp_path / "a.prom").read_text() == \
        (tmp_path / "b.prom").read_text()


def test_profile_writes_a_trace_around_an_engine_round(tmp_path):
    """Telemetry.profile around one engine round on the CPU: a non-empty
    torch.profiler trace holding the round's annotated region."""
    from fedml_tpu_torch.utils.tracing import annotate

    data = synthetic_images(**DATA_KW)
    task = classification_task(create_model("lr", output_dim=3,
                                            device="cpu"))
    cfg = FedAvgConfig(comm_round=1, client_num_in_total=6,
                       client_num_per_round=3, batch_size=8, lr=0.1)
    api = FedAvgAPI(data, task, cfg, device="cpu")
    with Telemetry().profile(str(tmp_path)), annotate("fed_round"):
        api.run_round(0)
    (trace,) = tmp_path.glob("*.pt.trace.json")
    doc = json.loads(trace.read_text())
    assert any(e.get("name") == "fed_round" for e in doc["traceEvents"])
    assert export.profile_trace is not None


_PROM_RUN = """
import json, os, sys, tempfile
import jax, jax.numpy as jnp, numpy as np
from fedml_tpu.algorithms.fedavg import FedAvgAPI as JA, FedAvgConfig as JC
from fedml_tpu.core.tasks import classification_task as jct
from fedml_tpu.data.synthetic import synthetic_images as jsi
from fedml_tpu.models.linear import LogisticRegression as JLR
from fedml_tpu.obs.telemetry import Telemetry as JT
from fedml_tpu_torch.algorithms import FedAvgAPI, FedAvgConfig
from fedml_tpu_torch.core.tasks import classification_task
from fedml_tpu_torch.data.synthetic import synthetic_images
from fedml_tpu_torch.models import create_model
from fedml_tpu_torch.obs.telemetry import Telemetry
kw = dict(num_clients=6, image_shape=(6, 6, 1), num_classes=3,
          samples_per_client=12, test_samples=24, seed=0)
cfg = dict(comm_round=2, client_num_in_total=6, client_num_per_round=3,
           batch_size=8, lr=0.1, frequency_of_the_test=1)
out = {}
for name, tel_cls, run in (
        ("port", Telemetry, lambda tel: FedAvgAPI(
            synthetic_images(**kw), classification_task(create_model(
                "lr", output_dim=3, device="cpu")), FedAvgConfig(**cfg),
            device="cpu", telemetry=tel).train()),
        ("jax", JT, lambda tel: JA(jsi(**kw), jct(JLR(num_classes=3)),
                                   JC(**cfg), telemetry=tel).train())):
    d = tempfile.mkdtemp()
    tel = tel_cls(log_dir=d, http_port=0, memwatch=True, health=True)
    run(tel)
    tel.close()
    text = open(os.path.join(d, "metrics.prom")).read()
    out[name] = sorted({l.split()[2] for l in text.splitlines()
                        if l.startswith("# TYPE ")})
print(json.dumps(out))
"""


def test_armed_run_exports_the_reference_families():
    """A telemetry-armed engine run (HTTP, memwatch, health) dumps the
    same metric families in metrics.prom as the reference's run of the
    same configuration, but for the fed_xla_* compile families (no
    PyTorch source) — both in one fresh process, so no other test's
    families are in either registry."""
    res = subprocess.run([sys.executable, "-c", _PROM_RUN], cwd=ROOT,
                         capture_output=True, text=True, timeout=240,
                         env={**__import__("os").environ,
                              "JAX_PLATFORMS": "cpu"})
    assert res.returncode == 0, res.stderr[-3000:]
    fams = json.loads(res.stdout.strip().splitlines()[-1])
    ref = {f for f in fams["jax"] if not f.startswith("fed_xla_")}
    assert set(fams["port"]) == ref
    assert {"fed_goodput_mfu", "fed_duty_cycle", "fed_alerts_total",
            "fed_host_rss_bytes", "fed_agg_bytes_total"} <= ref


# -------------------------------------------------------------- launcher
def _scrape(url):
    return urllib.request.urlopen(url, timeout=5).read().decode()


@pytest.mark.parametrize("flags", [["--metrics_port", "0", "--fleet", "1"],
                                   ["--fleet", "1", "--fleet_job", "t"],
                                   ["--metrics_port", "0"]],
                         ids=["metrics_port+fleet", "fleet", "metrics_port"])
def test_launcher_serves_the_live_endpoints(flags, monkeypatch):
    """A 2-round loopback launcher job (rank 0 + 2 client ranks as
    threads): rank 0's /metrics, /healthz and (under --fleet) /fleetz
    answer on an ephemeral port, scraped just before its Telemetry
    closes; with --metrics_port every client rank serves its own
    endpoint, with --fleet alone none does."""
    argv = ["--world_size", "3", "--backend", "loopback", "--dataset",
            "mnist", "--model", "lr", "--comm_round", "2",
            "--client_num_in_total", "4", "--batch_size", "8",
            "--frequency_of_the_test", "1", "--device", "cpu", *flags]
    scraped, servers, errors = {}, [], []
    close = Telemetry.close

    def scrape_then_close(self):
        for path in ("/metrics", "/healthz", "/fleetz"):
            try:
                scraped[path] = _scrape(self.httpd.url(path))
            except urllib.request.HTTPError as e:
                scraped[path] = e.code
        close(self)

    monkeypatch.setattr(Telemetry, "close", scrape_then_close)
    import fedml_tpu_torch.obs as obs

    start = obs.start_metrics_server
    monkeypatch.setattr(obs, "start_metrics_server",
                        lambda **k: servers.append(start(**k)) or servers[-1])

    def rank(r):
        try:
            distributed_launch.main(["--rank", str(r), *argv])
        except BaseException as e:  # noqa: BLE001 — re-raised below
            errors.append(e)

    threads = [threading.Thread(target=rank, args=(r,)) for r in (1, 2)]
    try:
        for t in threads:
            t.start()
        deadline = time.monotonic() + 60
        while set(loopback._registry.get("launch", {})) != {1, 2}:
            assert time.monotonic() < deadline and not errors, errors
            time.sleep(0.02)
        rank(0)
        for t in threads:
            t.join(timeout=60)
    finally:
        for mgr in list(loopback._registry.get("launch", {}).values()):
            mgr.stop_receive_message()
    assert not errors, errors
    fleet = "--fleet" in flags
    assert "fed_goodput_rounds_total" in scraped["/metrics"]
    hz = json.loads(scraped["/healthz"])
    assert hz["status"] == "ok" and hz["round"] == 1
    assert hz["expected_ranks"] == 2
    if fleet:
        fz = json.loads(scraped["/fleetz"])
        assert set(fz["ranks"]) == {"0", "1", "2"}
        assert (fz.get("job") or "") == ("t" if "--fleet_job" in flags
                                         else "")
    else:
        assert scraped["/fleetz"] == 404
    assert len(servers) == (2 if "--metrics_port" in flags else 0)
    for s in servers:  # each client rank's own registry endpoint
        assert s.port > 0
