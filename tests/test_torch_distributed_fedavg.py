"""The port's cross-process FedAvg (fedml_tpu_torch/distributed/fedavg) on
the CPU, at tests/test_comm.py's ``lr_setup`` size (8 clients, 8x8x1
images, 4 classes): loopback equals the port's standalone engine under
every frame codec and the JAX package's run_simulated from the same
weights; torch and JAX ranks share one gRPC job both ways round; elastic
partial aggregation, the non-finite quarantine (ledger equal to the JAX
package's) and the undecodable-upload rule; the launcher as three real
processes over MQTT; the unported options; and the two thread-safety
repairs the ranks-as-threads runtime needs (the float32 policy, a task's
module calls)."""

import json
import os
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.algorithms.fedavg import FedAvgConfig as JaxConfig
from fedml_tpu.comm.message import pack_pytree as jax_pack
from fedml_tpu.core.tasks import classification_task as jax_classification_task
from fedml_tpu.data.synthetic import synthetic_images as jax_synthetic_images
from fedml_tpu.distributed.fedavg import api as jax_api
from fedml_tpu.distributed.fedavg.client_manager import (
    FedAvgClientManager as JaxClientManager,
)
from fedml_tpu.distributed.fedavg.trainer import (
    DistributedTrainer as JaxTrainer,
)
from fedml_tpu.distributed.utils import launch_simulated
from fedml_tpu.models.linear import LogisticRegression as JaxLR
from fedml_tpu_torch import convert
from fedml_tpu_torch.algorithms import FedAvgAPI, FedAvgConfig
from fedml_tpu_torch.algorithms import fedavg as port_fedavg
from fedml_tpu_torch.chaos import FaultPlan
from fedml_tpu_torch.comm.loopback import LoopbackCommManager
from fedml_tpu_torch.comm.message import pack_pytree, set_wire_codec
from fedml_tpu_torch.core.tasks import classification_task
from fedml_tpu_torch.data.synthetic import synthetic_images
from fedml_tpu_torch.distributed.fedavg import api, run_simulated
from fedml_tpu_torch.distributed.fedavg.aggregator import FedAvgAggregator
from fedml_tpu_torch.distributed.fedavg.client_manager import (
    FedAvgClientManager,
)
from fedml_tpu_torch.distributed.fedavg.server_manager import (
    FedAvgServerManager,
)
from fedml_tpu_torch.distributed.fedavg.trainer import DistributedTrainer
from fedml_tpu_torch.experiments import distributed_launch
from fedml_tpu_torch.models import create_model
from test_torch_comm import free_port_block

ROOT = Path(__file__).resolve().parents[1]
DATA_KW = dict(num_clients=8, image_shape=(8, 8, 1), num_classes=4,
               samples_per_client=24, test_samples=96, seed=3)
CFG = dict(comm_round=3, client_num_in_total=8, client_num_per_round=4,
           epochs=1, batch_size=8, lr=0.1, frequency_of_the_test=1, seed=0)
# port against port (one summation order apart) and port against JAX
TOL_EQUIV = dict(rtol=2e-5, atol=1e-6)
TOL_JAX = dict(rtol=1e-5, atol=1e-5)


def _port_task(init_params=None):
    task = classification_task(create_model("lr", output_dim=4, device="cpu"))
    if init_params is None:
        return task
    state = convert.from_flax(init_params)
    return task._replace(init=lambda g, x=None: {k: v.clone()
                                                 for k, v in state.items()})


@pytest.fixture(scope="module")
def setup():
    """Both packages' data (bitwise equal), tasks, and the JAX run's
    initial params (the split(PRNGKey(seed))[1] draw its aggregator makes);
    the port's task inits to those params."""
    jdata = jax_synthetic_images(**DATA_KW)
    jtask = jax_classification_task(JaxLR(num_classes=4))
    _, key = jax.random.split(jax.random.PRNGKey(CFG["seed"]))
    params = jax.tree.map(np.asarray, jtask.init(
        key, jnp.asarray(jdata.train_x[:CFG["batch_size"]])).params)
    return dict(data=synthetic_images(**DATA_KW), jdata=jdata, jtask=jtask,
                task=_port_task(params))


@pytest.fixture(scope="module")
def jax_reference(setup):
    """The all-JAX run over loopback: final wire leaves and history."""
    agg = jax_api.run_simulated(setup["jdata"], setup["jtask"],
                                JaxConfig(**CFG), backend="LOOPBACK",
                                job_id="t-torch-jax-ref")
    return jax_pack(agg.net), agg.history


def _assert_leaves_close(got, want, **tol):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), **tol)


def _assert_history_close(got, want, tol=1e-5):
    assert [r["round"] for r in got] == [r["round"] for r in want]
    for a, b in zip(got, want):
        for k in ("test_loss", "test_acc"):
            assert abs(a[k] - b[k]) <= tol * max(1.0, abs(b[k])), (k, a, b)


@pytest.mark.parametrize("codec", ["none", "zlib", "json", "f16", "f16+zlib",
                                   "q8", "q8+zlib"])
def test_loopback_equals_standalone(setup, codec):
    """The port's loopback runtime (one client per rank, every frame through
    the wire codec) reproduces the port's standalone engine: same sampling,
    shuffles, init and fits. Lossless codecs to a summation order
    (test_comm.py:383-406), f16 to test_comm.py:173's tolerance, q8 to its
    quantization step: each frame moves an entry by at most max|w|/254,
    and 3 rounds pass 2 frames each."""
    standalone = FedAvgAPI(setup["data"], setup["task"], FedAvgConfig(**CFG),
                           device="cpu")
    standalone.train()
    want = pack_pytree(standalone.net)
    tol = TOL_EQUIV
    if "f16" in codec:
        tol = dict(rtol=5e-3, atol=2e-3)
    elif "q8" in codec:
        tol = dict(rtol=0, atol=6 * max(np.abs(w).max() for w in want) / 254)
    set_wire_codec(codec)
    try:
        agg = run_simulated(setup["data"], setup["task"], FedAvgConfig(**CFG),
                            job_id=f"t-torch-codec-{codec}", device="cpu")
    finally:
        set_wire_codec("none")
    _assert_leaves_close(pack_pytree(agg.net), want, **tol)
    assert [r["round"] for r in agg.history] == [0, 1, 2]


def test_port_run_simulated_equals_jax_run_simulated(setup, jax_reference):
    """From the same initial weights the port's loopback run equals the JAX
    package's, params and eval history, within 1e-5."""
    agg = run_simulated(setup["data"], setup["task"], FedAvgConfig(**CFG),
                        job_id="t-torch-vs-jax", device="cpu")
    want_leaves, want_history = jax_reference
    _assert_leaves_close(pack_pytree(agg.net), want_leaves, **TOL_JAX)
    _assert_history_close(agg.history, want_history)


@pytest.mark.parametrize("server_side", ["jax", "torch"])
def test_mixed_grpc_job_equals_all_jax(setup, jax_reference, server_side):
    """One wire: a JAX server with torch clients, and a torch server with
    JAX clients, over gRPC on localhost, complete and equal the all-JAX
    run within 1e-5."""
    pytest.importorskip("grpc")
    size = CFG["client_num_per_round"] + 1
    base = free_port_block(size)
    jcfg, cfg = JaxConfig(**CFG), FedAvgConfig(**CFG)
    if server_side == "jax":
        server = jax_api.init_server(setup["jdata"], setup["jtask"], jcfg,
                                     size, "GRPC", base_port=base)
        clients = [api.init_client(setup["data"], setup["task"], cfg, r, size,
                                   "GRPC", device="cpu", base_port=base)
                   for r in range(1, size)]
    else:
        server = api.init_server(setup["data"], setup["task"], cfg, size,
                                 "GRPC", device="cpu", base_port=base)
        clients = [jax_api.init_client(setup["jdata"], setup["jtask"], jcfg, r,
                                       size, "GRPC", base_port=base)
                   for r in range(1, size)]
    launch_simulated(server, clients)
    net = server.aggregator.net
    got = jax_pack(net) if server_side == "jax" else pack_pytree(net)
    want_leaves, want_history = jax_reference
    _assert_leaves_close(got, want_leaves, **TOL_JAX)
    _assert_history_close(server.aggregator.history, want_history)


def test_elastic_partial_aggregation_survives_dead_client(setup):
    """A client that never reports must not hang the job: with
    round_timeout_s set, the server aggregates over the live subset and
    completes every round (mirror of test_comm.py:543)."""
    cfg = FedAvgConfig(**{**CFG, "comm_round": 2, "client_num_per_round": 3,
                          "seed": 2})
    size, job = 4, "t-torch-elastic"
    aggregator = FedAvgAggregator(setup["data"], setup["task"], cfg,
                                  worker_num=size - 1, device="cpu")
    server = FedAvgServerManager(aggregator, rank=0, size=size,
                                 backend="LOOPBACK", round_timeout_s=1.5,
                                 job_id=job)
    # rank 3 is "dead": registered, so sends to it succeed, never replying
    dead = LoopbackCommManager(job, 3, size)
    live = [api.init_client(setup["data"], setup["task"], cfg, r, size,
                            "LOOPBACK", device="cpu", job_id=job)
            for r in (1, 2)]
    threads = [threading.Thread(target=c.run, daemon=True) for c in live]
    for t in threads:
        t.start()
    server.run()  # returns only if every round completed
    dead.stop_receive_message()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    assert [r["round"] for r in aggregator.history] == [0, 1]


def test_entry_point_runs_each_role(setup):
    """``FedML_FedAvg_distributed`` runs rank 0 as the server and the other
    ranks as clients (here over MQTT, whose retained downlinks let the
    ranks boot in any order), and returns each rank's manager."""
    from fedml_tpu_torch.comm.mqtt_mini import MiniMqttBroker
    from fedml_tpu_torch.distributed.fedavg import FedML_FedAvg_distributed

    cfg = FedAvgConfig(**{**CFG, "comm_round": 1, "client_num_per_round": 2})
    broker = MiniMqttBroker()
    kw = dict(backend="MQTT", device="cpu", broker_port=broker.port,
              job_id="t-torch-entry")
    try:
        clients = [threading.Thread(
            target=FedML_FedAvg_distributed, daemon=True,
            args=(r, 3, setup["data"], setup["task"], cfg), kwargs=kw)
            for r in (1, 2)]
        for t in clients:
            t.start()
        server = FedML_FedAvg_distributed(0, 3, setup["data"], setup["task"],
                                          cfg, **kw)
        for t in clients:
            t.join(timeout=30)
            assert not t.is_alive()
    finally:
        broker.close()
    assert [r["round"] for r in server.aggregator.history] == [0]


def _poisoning(cls, bad_rank):
    """``cls`` (either package's client manager) whose rank ``bad_rank``
    uploads a NaN in its first leaf."""

    class Poisoning(cls):
        def _send_upload(self, msg):
            if self.rank == bad_rank:
                leaves = list(msg.get("model_params"))
                leaves[0] = np.array(leaves[0], copy=True)
                leaves[0].flat[0] = np.nan
                msg.add_params("model_params", leaves)
            super()._send_upload(msg)

    return Poisoning


def test_nonfinite_upload_quarantined_like_the_reference(setup):
    """Rank 2 uploads a NaN every round: both packages' servers record the
    same ``nonfinite`` ledger entries, keep finite models, and agree on
    them within 1e-5."""
    cfg, jcfg = FedAvgConfig(**CFG), JaxConfig(**CFG)
    size = CFG["client_num_per_round"] + 1
    port = api.init_server(setup["data"], setup["task"], cfg, size,
                           "LOOPBACK", device="cpu", job_id="t-torch-nan")
    cls = _poisoning(FedAvgClientManager, 2)
    launch_simulated(port, [
        cls(DistributedTrainer(r, setup["data"], setup["task"], cfg,
                               device="cpu"), rank=r, size=size,
            backend="LOOPBACK", job_id="t-torch-nan")
        for r in range(1, size)])
    ref = jax_api.init_server(setup["jdata"], setup["jtask"], jcfg, size,
                              "LOOPBACK", job_id="t-jax-nan")
    jcls = _poisoning(JaxClientManager, 2)
    launch_simulated(ref, [
        jcls(JaxTrainer(r, setup["jdata"], setup["jtask"], jcfg), rank=r,
             size=size, backend="LOOPBACK", job_id="t-jax-nan")
        for r in range(1, size)])
    got = port.aggregator.quarantine.entries()
    assert got == ref.aggregator.quarantine.entries()
    assert [(e["round"], e["rank"], e["reason"]) for e in got] == \
        [(r, 2, "nonfinite") for r in range(CFG["comm_round"])]
    leaves = pack_pytree(port.aggregator.net)
    assert all(np.isfinite(v).all() for v in leaves)
    _assert_leaves_close(leaves, jax_pack(ref.aggregator.net), **TOL_JAX)


def test_undecodable_upload_quarantined_and_round_completes(setup):
    """An upload whose leaves do not fit the model is quarantined
    ``undecodable`` but still satisfies the round barrier: the round
    aggregates the others (no elastic deadline armed)."""
    cfg = FedAvgConfig(**CFG)
    size, job = CFG["client_num_per_round"] + 1, "t-torch-undecodable"

    class Truncating(FedAvgClientManager):
        def _send_upload(self, msg):
            if self.rank == 3:
                msg.add_params("model_params", msg.get("model_params")[:-1])
            super()._send_upload(msg)

    server = api.init_server(setup["data"], setup["task"], cfg, size,
                             "LOOPBACK", device="cpu", job_id=job)
    launch_simulated(server, [
        Truncating(DistributedTrainer(r, setup["data"], setup["task"], cfg,
                                      device="cpu"),
                   rank=r, size=size, backend="LOOPBACK", job_id=job)
        for r in range(1, size)])
    agg = server.aggregator
    assert [(e["round"], e["rank"], e["reason"])
            for e in agg.quarantine.entries()] == \
        [(r, 3, "undecodable") for r in range(CFG["comm_round"])]
    assert [r["round"] for r in agg.history] == [0, 1, 2]
    assert agg._last_flush["stack_bytes"] == 3 * 4 * (64 * 4 + 4)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launch_three(tmp_path, extra=()):
    """``distributed_launch`` as three real CPU processes over MQTT (rank 0
    hosts the bundled broker) on mnist / lr, 2 rounds of 2 clients: rank
    0's eval history, after every rank exited 0."""
    argv = ["--world_size", "3", "--backend", "mqtt", "--broker_port",
            str(_free_port()), "--serve_broker", "1", "--dataset", "mnist",
            "--model", "lr", "--comm_round", "2", "--client_num_in_total", "6",
            "--frequency_of_the_test", "1", "--device", "cpu", *extra]
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    procs = []
    try:
        for r in (1, 2, 0):
            with open(tmp_path / f"r{r}.out", "w") as out, \
                    open(tmp_path / f"r{r}.err", "w") as err:
                procs.append(subprocess.Popen(
                    [sys.executable, "-m",
                     "fedml_tpu_torch.experiments.distributed_launch",
                     "--rank", str(r), *argv],
                    cwd=ROOT, env=env, stdout=out, stderr=err))
        rcs = [p.wait(timeout=120) for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert rcs == [0, 0, 0], (tmp_path / "r0.err").read_text()[-3000:]
    return json.loads((tmp_path / "r0.out").read_text().splitlines()[-1])


def _launch_reference(job, **kw):
    """The in-process loopback run of _launch_three's configuration."""
    from fedml_tpu_torch.data import load_dataset

    data = load_dataset("mnist", client_num=6)
    return run_simulated(
        data, classification_task(create_model("lr", output_dim=10,
                                               device="cpu")),
        FedAvgConfig(comm_round=2, client_num_in_total=6,
                     client_num_per_round=2, batch_size=32, lr=0.03,
                     frequency_of_the_test=1),
        job_id=job, device="cpu", **kw).history


def test_launcher_runs_three_processes_over_mqtt(tmp_path):
    """``distributed_launch`` as three real CPU processes over MQTT (rank 0
    hosts the bundled broker): rank 0 exits 0 and prints the eval history,
    which equals the in-process loopback run of the same configuration."""
    _assert_history_close(_launch_three(tmp_path),
                          _launch_reference("t-torch-launch-ref"))


def test_launcher_runs_the_wire_flags(tmp_path):
    """The launcher's codec, chaos and trace flags: delta-int8 uplinks with
    error feedback, round-delta downlinks and a duplicate-every-upload
    plan on every rank, rank 0 tracing into --trace_dir. Its history
    equals the in-process run of the same options; trace.json, the event
    log and the metrics dump land in the directory."""
    plan = {"seed": 1, "rules": [{"fault": "duplicate", "direction": "send",
                                  "src": [1], "dst": [0]}]}
    history = _launch_three(tmp_path, [
        "--update_codec", "delta-int8", "--delta_broadcast", "1",
        "--chaos_plan", json.dumps(plan), "--trace_dir", str(tmp_path)])
    want = _launch_reference(
        "t-torch-launch-wire", update_codec="delta-int8",
        delta_broadcast=True, chaos_plan=FaultPlan.from_json(plan))
    _assert_history_close(history, want)
    doc = json.loads((tmp_path / "trace.json").read_text())
    assert any(e.get("name") == "local_fit" for e in doc["traceEvents"])
    kinds = [json.loads(line)["kind"] for line in
             (tmp_path / "events.jsonl").read_text().splitlines()]
    assert kinds[0] == "run" and kinds.count("round") == 2
    assert (tmp_path / "metrics.prom").exists()


@pytest.mark.parametrize("option", [
    dict(ckpt_dir="/nonexistent"),
    # a server restart (a crash rule naming rank 0) needs checkpoint + WAL
    dict(chaos_plan=FaultPlan.from_json(
        {"seed": 0, "rules": [{"fault": "crash", "ranks": [0],
                               "rounds": [1, 2]}]})),
    dict(aggregator="median"),
    dict(aggregator_params={"f": 1}), dict(sanitize=True),
    dict(adversary_plan=object()), dict(shard_server_state=True),
    dict(partition_rules=[]), dict(async_buffer_k=2),
    dict(staleness="poly:0.5"), dict(staleness_bound=1),
    dict(buffer_deadline_s=1.0), dict(buffer_capacity=4),
    dict(heartbeat_max_age_s=1.0), dict(sum_assoc="pairwise"),
    dict(edges=2), dict(fused_agg=True), dict(churn_trace=object()),
], ids=lambda kw: next(iter(kw)))
def test_unported_run_simulated_options_raise(setup, option):
    with pytest.raises(NotImplementedError, match=r"ROADMAP\.md queue A, item"):
        run_simulated(setup["data"], setup["task"], FedAvgConfig(**CFG),
                      device="cpu", **option)


@pytest.mark.parametrize("flag", [
    ["--algo", "fedopt"], ["--edges", "2"], ["--ckpt_dir", "/tmp/x"],
    ["--async_buffer_k", "2"], ["--aggregator", "median"],
    ["--adversary-plan", "{}"], ["--fused_agg", "1"], ["--shard_server_state", "1"], ["--supervise", "1"],
], ids=lambda f: f[0])
def test_unported_launcher_flags_raise(flag):
    with pytest.raises(NotImplementedError, match=r"ROADMAP\.md queue A, item"):
        distributed_launch.main(["--rank", "0", "--world_size", "2",
                                 "--device", "cpu", *flag])


def test_entry_points_need_a_device_without_cuda(setup):
    """No CUDA and no explicit device: every entry point raises; there is
    no silent CPU path."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = FedAvgConfig(**CFG)
    calls = [
        lambda: run_simulated(setup["data"], setup["task"], cfg),
        lambda: FedAvgAggregator(setup["data"], setup["task"], cfg, 4),
        lambda: DistributedTrainer(1, setup["data"], setup["task"], cfg),
        lambda: distributed_launch.main(["--rank", "1", "--world_size", "2"]),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


def test_float32_policy_holds_across_threads():
    """Threads entering and leaving ``float32_compute`` in random
    interleavings each see float32 inside (matmul precision "highest",
    cuDNN without TF32); after the last one leaves, the caller's flags
    are back."""
    cudnn = torch.backends.cudnn
    prev = torch.get_float32_matmul_precision(), cudnn.allow_tf32
    torch.set_float32_matmul_precision("high")
    cudnn.allow_tf32 = True
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    seen, rs = [], np.random.RandomState(0)
    delays = rs.uniform(0, 2e-3, size=(8, 20, 2))

    def worker(i):
        for enter, inside in delays[i]:
            time.sleep(enter)
            with port_fedavg.float32_compute():
                seen.append((torch.get_float32_matmul_precision(),
                             cudnn.allow_tf32))
                time.sleep(inside)
                seen.append((torch.get_float32_matmul_precision(),
                             cudnn.allow_tf32))

    try:
        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
        assert len(seen) == 8 * 20 * 2
        assert set(seen) == {("highest", False)}
        assert (torch.get_float32_matmul_precision(), cudnn.allow_tf32) == \
            ("high", True)
    finally:
        sys.setswitchinterval(interval)
        torch.set_float32_matmul_precision(prev[0])
        cudnn.allow_tf32 = prev[1]


def test_task_module_calls_are_thread_safe():
    """Threads calling one task's model with their own params each get
    their own outputs (``functional_call`` swaps params into the shared
    module: unguarded, threads ran with each other's weights)."""
    task = classification_task(create_model("cnn", output_dim=62,
                                            device="cpu"))
    x = torch.rand(4, 28, 28, 1, generator=torch.Generator().manual_seed(0))
    params = [task.init(torch.Generator().manual_seed(s), x) for s in range(4)]
    want = [task.predict(p, x) for p in params]
    wrong = []
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)

    def worker(i):
        for _ in range(10):
            if not torch.equal(task.predict(params[i], x), want[i]):
                wrong.append(i)

    try:
        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(interval)
    assert wrong == []
