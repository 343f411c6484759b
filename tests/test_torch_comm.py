"""The port's L1 communication layer (fedml_tpu_torch/comm) against the JAX
package's: frames byte-identical for every frame codec and decodable by
either side, ``pack_pytree`` giving the reference's leaves bitwise, the
CRC drop, loopback dispatch, the watchdog, and the gRPC and MQTT
transports. Mirrors the same-named tests of tests/test_comm.py; every
port bound to a socket here is probed free (xdist runs test_comm.py at
the same time)."""

import ast
import re
import socket
import threading
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.comm import message as jax_message
from fedml_tpu.core.tasks import classification_task as jax_classification_task
from fedml_tpu.core.tasks import sequence_task as jax_sequence_task
from fedml_tpu.models.cnn import CNNOriginalFedAvg as JaxCNN
from fedml_tpu.models.linear import LogisticRegression as JaxLR
from fedml_tpu.models.transformer import TransformerLM as JaxTransformerLM
from fedml_tpu_torch import convert
from fedml_tpu_torch.comm.loopback import LoopbackCommManager
from fedml_tpu_torch.comm.managers import ClientManager, ServerManager
from fedml_tpu_torch.comm.message import Message, pack_pytree, unpack_pytree
from fedml_tpu_torch.models import create_model
from fedml_tpu_torch.obs.metrics import REGISTRY

ROOT = Path(__file__).resolve().parents[1]
CODECS = ("none", "f16", "q8", "zlib", "f16+zlib", "q8+zlib", "json")


def free_port_block(n: int) -> int:
    """A base port with ``n`` consecutive free ports (probed by binding)."""
    for _ in range(200):
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            base = s.getsockname()[1]
        if base + n > 65535:
            continue
        socks = []
        try:
            for p in range(base, base + n):
                s = socket.socket()
                socks.append(s)
                s.bind(("0.0.0.0", p))
            return base
        except OSError:
            continue
        finally:
            for s in socks:
                s.close()
    raise RuntimeError(f"no block of {n} free ports")


def _build(cls, arr_like):
    """The same message, built through one package's Message class."""
    rs = np.random.RandomState(0)
    m = cls("c2s_send_model", 3, 0)
    m.add_params("num_samples", 57)
    m.add_params("round_idx", 2)
    m.add_params("tag", "hello")
    m.add_params("arr", arr_like(rs.randn(3, 4).astype(np.float32)))
    m.add_params("model_params", [
        arr_like(rs.randn(5, 5, 1, 32).astype(np.float32)),
        arr_like(np.arange(5, dtype=np.int32)),
        arr_like(rs.randint(0, 256, size=(7,)).astype(np.uint8))])
    return m


@pytest.mark.parametrize("codec", CODECS)
def test_frames_byte_identical_and_cross_decodable(codec):
    """A message built the same way in both packages gives the same bytes
    under every frame codec, and each package decodes the other's frame."""
    port = _build(Message, lambda a: a).to_bytes(codec)
    ref = _build(jax_message.Message, jnp.asarray).to_bytes(codec)
    assert port == ref
    for decode, frame in ((Message.from_bytes, ref),
                          (jax_message.Message.from_bytes, port)):
        got = decode(frame)
        want = jax_message.Message.from_bytes(ref)
        assert got.get("num_samples") == 57 and got.get("tag") == "hello"
        for a, b in zip(got.get("model_params"), want.get("model_params")):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(got.get("arr"), want.get("arr"))


# the TransformerLM case: C1's width (ROADMAP.md queue C)
LM_WIDTHS = dict(vocab_size=90, dim=32, depth=1, num_heads=2, max_len=80)


def _jax_net(model: str):
    if model == "transformer":
        task = jax_sequence_task(JaxTransformerLM(**LM_WIDTHS))
        return jax.jit(task.init)(jax.random.PRNGKey(3),
                                  jnp.zeros((1, 80), jnp.int32))
    module = JaxCNN(only_digits=False) if model == "cnn" \
        else JaxLR(num_classes=10)
    task = jax_classification_task(module)
    return jax.jit(task.init)(jax.random.PRNGKey(3),
                              jnp.zeros((1, 28, 28, 1), jnp.uint8))


def _model_frame(cls, leaves) -> bytes:
    m = cls("s2c_sync_model", 0, 1)
    m.add_params("model_params", leaves)
    m.add_params("round_idx", 1)
    return m.to_bytes()


@pytest.mark.parametrize("model", ["cnn", "lr", "transformer"])
def test_pack_pytree_gives_the_reference_leaves_bitwise(model):
    """The port's wire leaves of a state converted from flax weights are
    the JAX package's pack_pytree(NetState) leaves: order, shape, dtype,
    bytes; a frame of them is byte-equal to the JAX package's frame and
    each side decodes the other's; unpack_pytree inverts them bitwise. A
    TransformerLM needs its head count (convert.num_heads_of)."""
    net = _jax_net(model)
    state = convert.from_flax(jax.tree.map(np.asarray, net.params))
    heads = LM_WIDTHS["num_heads"] if model == "transformer" else None
    want = jax_message.pack_pytree(net)
    got = pack_pytree(state, heads)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert np.ascontiguousarray(a).tobytes() == b.tobytes()
    frame = _model_frame(Message, got)
    assert frame == _model_frame(jax_message.Message, want)
    for a, b in zip(jax_message.Message.from_bytes(frame).get("model_params"),
                    Message.from_bytes(frame).get("model_params")):
        np.testing.assert_array_equal(a, b)
    template = {k: torch.zeros_like(v) for k, v in state.items()}
    back = unpack_pytree(template, want, heads)
    for k in state:
        assert torch.equal(back[k], state[k]), k
    with pytest.raises(ValueError, match="wire leaves"):
        unpack_pytree(template, want[:-1], heads)
    if model == "transformer":
        module = create_model("transformer", device="cpu", **LM_WIDTHS)
        assert convert.num_heads_of(module) == heads
        with pytest.raises(TypeError, match="num_heads"):
            pack_pytree(state)


def test_sequence_run_simulated_matches_jax():
    """C1: a TransformerLM job crosses the wire. The port's loopback
    run_simulated on the shakespeare stand-in's sequence_task (4 clients,
    2 a round, 2 rounds) equals the JAX package's from the same weights,
    params and history within 1e-5 (float32 on the CPU on both sides, one
    summation order apart; before the repair the port raised TypeError at
    its first broadcast)."""
    from fedml_tpu.algorithms.fedavg import FedAvgConfig as JaxConfig
    from fedml_tpu.data import load_dataset as jax_load_dataset
    from fedml_tpu.distributed.fedavg import api as jax_api
    from fedml_tpu_torch.algorithms import FedAvgConfig
    from fedml_tpu_torch.core.tasks import sequence_task
    from fedml_tpu_torch.data import load_dataset
    from fedml_tpu_torch.distributed.fedavg import run_simulated

    cfg = dict(comm_round=2, client_num_in_total=4, client_num_per_round=2,
               batch_size=10, max_batches=2, lr=0.1, frequency_of_the_test=1,
               eval_batch_size=40, seed=0)
    jdata = jax_load_dataset("shakespeare", client_num=4)
    jtask = jax_sequence_task(JaxTransformerLM(**LM_WIDTHS))
    jtask = jtask._replace(init=jax.jit(jtask.init))
    ref = jax_api.run_simulated(jdata, jtask, JaxConfig(**cfg),
                                job_id="t-jax-lm-wire")
    _, key = jax.random.split(jax.random.PRNGKey(cfg["seed"]))
    start = convert.from_flax(jax.tree.map(np.asarray, jtask.init(
        key, jnp.asarray(jdata.train_x[:cfg["batch_size"]])).params))
    task = sequence_task(create_model("transformer", device="cpu",
                                      **LM_WIDTHS))
    task = task._replace(init=lambda g, x=None: {k: v.clone()
                                                 for k, v in start.items()})
    agg = run_simulated(load_dataset("shakespeare", client_num=4), task,
                        FedAvgConfig(**cfg), job_id="t-torch-lm-wire",
                        device="cpu")
    got = pack_pytree(agg.net, LM_WIDTHS["num_heads"])
    want = jax_message.pack_pytree(ref.net)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-5, atol=1e-5)
    assert [r["round"] for r in agg.history] == [0, 1]
    for a, b in zip(agg.history, ref.history):
        for k in ("test_loss", "test_acc"):
            assert abs(a[k] - b[k]) <= 1e-5 * max(1.0, abs(b[k])), (k, a, b)


def test_crc_corrupted_frame_dropped_and_counted():
    """A flipped bit fails the FMT2 CRC: the frame is dropped and counted
    (comm_corrupt_frames_total), and the receive queue stays empty."""
    m = Message("c2s_send_model", 1, 0)
    m.add_params("model_params", [np.ones((64,), np.float32)])
    frame = bytearray(m.to_bytes())
    frame[-3] ^= 0x10
    mgr = LoopbackCommManager("t-torch-crc", 0, 2)
    try:
        before = REGISTRY.total("comm_corrupt_frames_total")
        mgr._receive_frame(bytes(frame))
        assert REGISTRY.total("comm_corrupt_frames_total") == before + 1
        assert mgr._q.empty()
        mgr._receive_frame(m.to_bytes())  # the intact frame is queued
        assert mgr._q.qsize() == 1
    finally:
        mgr.stop_receive_message()


def test_loopback_dispatch_between_managers():
    got = []

    class Echo(ClientManager):
        def register_message_receive_handlers(self):
            self.register_message_receive_handler("ping", self._on_ping)

        def _on_ping(self, params):
            got.append(params["payload"])
            self.finish()

    a = Echo(rank=1, size=2, backend="LOOPBACK", job_id="t-torch-loop")
    b = LoopbackCommManager("t-torch-loop", 0, 2)
    t = threading.Thread(target=a.run, daemon=True)
    t.start()
    msg = Message("ping", 0, 1)
    msg.add_params("payload", 42)
    b.send_message(msg)
    t.join(timeout=10)
    assert not t.is_alive()
    assert got == [42]
    b.stop_receive_message()


def test_manager_watchdog_fires():
    fired = threading.Event()

    class Watched(ServerManager):
        def on_timeout(self, idle_s):
            fired.set()
            self.finish()

    mgr = Watched(rank=0, size=1, backend="LOOPBACK", timeout_s=0.3,
                  job_id="t-torch-watch")
    t = threading.Thread(target=mgr.run, daemon=True)
    t.start()
    assert fired.wait(timeout=5.0)
    t.join(timeout=5)
    assert not t.is_alive()


def test_manager_watchdog_quiet_under_concurrent_traffic():
    """Inbound traffic faster than timeout_s keeps on_timeout quiet, and
    neither the dispatch side nor the watchdog deadlocks the other."""
    fired = threading.Event()

    class Watched(ServerManager):
        def register_message_receive_handlers(self):
            self.register_message_receive_handler("tick", lambda params: None)

        def on_timeout(self, idle_s):
            fired.set()

    mgr = Watched(rank=0, size=1, backend="LOOPBACK", timeout_s=0.4,
                  job_id="t-torch-watch-quiet")
    t = threading.Thread(target=mgr.run, daemon=True)
    t.start()
    deadline = time.monotonic() + 1.5
    while time.monotonic() < deadline:  # ~4 timeout windows of traffic
        mgr.receive_message("tick", {})  # the dispatch-thread entry point
        time.sleep(0.05)
    assert not fired.is_set()
    mgr.finish()
    t.join(timeout=5)
    assert not t.is_alive()


def _serve(mgr, sink):
    mgr.add_observer(sink)
    t = threading.Thread(target=mgr.handle_receive_message, daemon=True)
    t.start()
    return t


def _wait_for(cond, timeout=10.0):
    deadline = time.time() + timeout
    while not cond() and time.time() < deadline:
        time.sleep(0.02)


def test_grpc_backend_roundtrip():
    pytest.importorskip("grpc")
    from fedml_tpu_torch.comm.grpc_backend import GrpcCommManager

    base = free_port_block(2)
    a = GrpcCommManager(rank=0, size=2, base_port=base)
    b = GrpcCommManager(rank=1, size=2, base_port=base)
    got = []

    class Sink:
        def receive_message(self, t, p):
            got.append((t, p["num_samples"], p["model_params"]))

    t = _serve(b, Sink())
    msg = Message("c2s_send_model", 0, 1)
    msg.add_params("num_samples", 7)
    msg.add_params("model_params", [np.full((4, 4), 2.5, np.float32)])
    a.send_message(msg)
    _wait_for(lambda: got)
    b.stop_receive_message()
    a.stop_receive_message()
    t.join(timeout=5)
    assert got and got[0][0] == "c2s_send_model" and got[0][1] == 7
    np.testing.assert_array_equal(got[0][2][0], np.full((4, 4), 2.5, np.float32))


def test_grpc_duplicate_frames_dropped():
    """The (rank, epoch, seq) dedup layer: a redelivered frame (same seq)
    is dropped; a restarted peer's fresh stream (same seqs, new epoch) is
    not."""
    pytest.importorskip("grpc")
    from fedml_tpu_torch.comm.grpc_backend import GrpcCommManager

    base = free_port_block(2)
    a = GrpcCommManager(rank=0, size=2, base_port=base)
    b = GrpcCommManager(rank=1, size=2, base_port=base)
    got = []

    class Sink:
        def receive_message(self, t, p):
            got.append(p["v"])

    t = _serve(b, Sink())
    a2 = None
    try:
        msg = Message("m", 0, 1)
        msg.add_params("v", 1)
        a.send_message(msg)
        a._send_seq -= 1  # simulate redelivery: next frame reuses the seq
        msg2 = Message("m", 0, 1)
        msg2.add_params("v", 2)
        a.send_message(msg2)  # dropped as duplicate
        # restart: same rank, same seqs, fresh boot epoch -> accepted
        a2 = GrpcCommManager(rank=0, size=2, base_port=free_port_block(1))
        a2.ip_table, a2.base_port = a.ip_table, a.base_port  # route to b
        msg3 = Message("m", 0, 1)
        msg3.add_params("v", 3)
        a2.send_message(msg3)
        _wait_for(lambda: len(got) >= 2)
    finally:
        b.stop_receive_message()
        a.stop_receive_message()
        if a2 is not None:
            a2.stop_receive_message()
        t.join(timeout=5)
    assert got == [1, 3], got


def test_mqtt_mini_roundtrip():
    """Bundled MQTT 3.1.1 slice: broker + client pub/sub with the fedml
    topic scheme, Message frames intact."""
    from fedml_tpu_torch.comm.mqtt_backend import MqttCommManager
    from fedml_tpu_torch.comm.mqtt_mini import MiniMqttBroker

    broker = MiniMqttBroker()
    try:
        server = MqttCommManager("127.0.0.1", broker.port, client_id=0, client_num=2)
        c1 = MqttCommManager("127.0.0.1", broker.port, client_id=1, client_num=2)
        got_s, got_c = [], []

        class SinkS:
            def receive_message(self, t, p):
                got_s.append((t, p["w"]))

        class SinkC:
            def receive_message(self, t, p):
                got_c.append((t, p["round"]))

        ts, tc = _serve(server, SinkS()), _serve(c1, SinkC())
        time.sleep(0.3)  # let SUBSCRIBEs land before publishing
        down = Message("s2c_sync", 0, 1)
        down.add_params("round", 7)
        server.send_message(down)
        up = Message("c2s_model", 1, 0)
        up.add_params("w", [np.arange(6, dtype=np.float32).reshape(2, 3)])
        c1.send_message(up)
        _wait_for(lambda: got_s and got_c)
        server.stop_receive_message()
        c1.stop_receive_message()
        ts.join(timeout=5)
        tc.join(timeout=5)
        assert got_c == [("s2c_sync", 7)]
        assert got_s[0][0] == "c2s_model"
        np.testing.assert_array_equal(
            got_s[0][1][0], np.arange(6, dtype=np.float32).reshape(2, 3))
    finally:
        broker.close()


def test_mqtt_retained_init_reaches_late_subscriber():
    """A message published BEFORE the receiver subscribed is delivered from
    the broker's retained store when the subscription lands."""
    from fedml_tpu_torch.comm.mqtt_backend import MqttCommManager
    from fedml_tpu_torch.comm.mqtt_mini import MiniMqttBroker

    broker = MiniMqttBroker()
    try:
        server = MqttCommManager("127.0.0.1", broker.port, client_id=0, client_num=1)
        init = Message("s2c_init", 0, 1)
        init.add_params("round", 0)
        server.send_message(init)  # nobody subscribed to fedml0_1 yet
        time.sleep(0.2)
        got = []
        late = MqttCommManager("127.0.0.1", broker.port, client_id=1, client_num=1)

        class Sink:
            def receive_message(self, t, p):
                got.append((t, p["round"]))

        t = _serve(late, Sink())
        _wait_for(lambda: got)
        server.stop_receive_message()
        late.stop_receive_message()
        t.join(timeout=5)
        assert got == [("s2c_init", 0)]
    finally:
        broker.close()


_SUB = re.compile(r"\bfedml_tpu\.(comm|obs|core|distributed)\b")
COPIES = ["obs/metrics.py", "obs/comm_instrument.py", "comm/observer.py",
          "comm/base.py", "comm/loopback.py", "comm/grpc_backend.py",
          "comm/mqtt_mini.py", "comm/mqtt_backend.py", "distributed/utils.py",
          "distributed/fedavg/message_define.py", "comm/message.py",
          "core/pipeline.py", "core/client_source.py"]


# a copy's named divergences: definitions the port rewrote, each cut out
# of both texts before they are compared (see cut_named)
DIVERGENCES = {
    "comm/mqtt_mini.py": (
        "MiniMqttClient.close", "MiniMqttBroker.__init__",
        "MiniMqttBroker._send", "MiniMqttBroker._drop"),
    # the module docstring (what the port carries) and the logger's name
    "core/pipeline.py": ("__doc__", "log"),
    # the logger's name (the import line maps by _SUB)
    "core/client_source.py": ("log",),
}

# definitions of the reference a copy leaves out, cut from the reference
# alone: compile_concurrently compiles XLA programs, and eager PyTorch has
# none (the engine's warmup runs the fit instead)
REF_ONLY = {"core/pipeline.py": ("compile_concurrently",)}


def cut_named(src: str, names) -> str:
    """``src`` with each named definition replaced by a marker line: a
    top-level function, class or assigned name (``"f"``, ``"NAME"``), a
    method (``"Cls.method"``) or the module docstring (``"__doc__"``), its
    leading comments and decorators included (the cut runs from the end of
    the statement before it). Every name must be found."""
    names = set(names)
    tree = ast.parse(src)
    spans = []

    def walk(body, prefix, prev_end):
        for i, node in enumerate(body):
            name = None
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                name = node.name
            elif isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name):
                name = node.targets[0].id
            elif (not prefix and i == 0 and isinstance(node, ast.Expr)
                  and isinstance(node.value, ast.Constant)
                  and isinstance(node.value.value, str)):
                name = "__doc__"
            full = prefix + name if name else None
            if full in names:
                spans.append((prev_end, node.end_lineno, full))
            elif isinstance(node, ast.ClassDef):
                walk(node.body, full + ".", node.lineno)
            prev_end = node.end_lineno

    walk(tree.body, "", 0)
    assert {f for _, _, f in spans} == names, (sorted(names), spans)
    lines = src.splitlines(keepends=True)
    for start, end, full in sorted(spans, reverse=True):
        lines[start:end] = [f"<cut: {full}>\n"]
    return "".join(lines)


@pytest.mark.parametrize("path", COPIES)
def test_copied_modules_match_the_reference(path):
    """The framework-free modules are the reference's, with their imports
    and logger names pointed at the port (core/pipeline.py: Prefetcher,
    InflightRing and AsyncSender, without compile_concurrently;
    core/client_source.py: whole, up to its logger's name; message.py: its
    wire format, up to the rewritten pack_pytree / unpack_pytree;
    mqtt_mini.py: up to the
    client's close, which drains before closing — see
    test_mqtt_close_after_a_burst_loses_no_frame — and the broker's
    per-socket write lock, kept in __init__, taken in _send and let go in
    _drop — see test_mqtt_broker_fans_out_concurrent_uploads_intact)."""
    ref = _SUB.sub(r"fedml_tpu_torch.\1", (ROOT / "fedml_tpu" / path).read_text())
    port = (ROOT / "fedml_tpu_torch" / path).read_text()
    if path == "comm/message.py":
        cut = lambda s: s[s.index("_MAGIC = "):s.index("def pack_pytree")]
        ref, port = cut(ref), cut(port)
    names = DIVERGENCES.get(path, ())
    ref_only = REF_ONLY.get(path, ())
    ref = cut_named(ref, (*names, *ref_only))
    for name in ref_only:
        ref = ref.replace(f"<cut: {name}>\n", "")
    assert cut_named(port, names) == ref


def test_mqtt_close_after_a_burst_loses_no_frame():
    """A client that publishes a burst of QoS-1 frames and closes at once
    loses none of them. The reference's close (DISCONNECT, then a bare
    socket close) left the broker's PUBACKs unread, the close sent a TCP
    reset, and the broker's kernel dropped the PUBLISH frames it had not
    read yet: a recovered server's FINISH went missing that way. Twelve
    trials of 100 frames; before the port's drain about one trial in three
    lost frames."""
    from fedml_tpu_torch.comm.mqtt_mini import MiniMqttBroker, MiniMqttClient

    n, lost = 100, []
    for trial in range(12):
        broker = MiniMqttBroker()
        got, done = [], threading.Event()

        def on(_topic, payload, got=got, done=done):
            got.append(payload)
            if len(got) == n:
                done.set()

        sub = MiniMqttClient("127.0.0.1", broker.port, f"s{trial}",
                             on_message=on)
        pub = None
        try:
            sub.subscribe("t")
            time.sleep(0.02)  # the SUBSCRIBE lands before the burst
            pub = MiniMqttClient("127.0.0.1", broker.port, f"p{trial}")
            for i in range(n):
                pub.publish("t", bytes([i]) * 16, qos=1)
            pub.close()
            done.wait(1.0)
            lost.append(n - len(got))
            assert got == [bytes([i]) * 16 for i in range(len(got))]
        finally:
            sub.close()
            broker.close()
    assert lost == [0] * 12


def test_mqtt_broker_fans_out_concurrent_uploads_intact():
    """Four clients publish a CNN-sized frame (6,760,184 B, the main
    path's model) at the same instant to topics one subscriber holds:
    every frame arrives whole. The reference's broker wrote each fan-out
    from the publisher's own thread with no lock on the subscriber's
    socket, so concurrent ``sendall`` chunks interleaved and the
    subscriber read a garbled stream — a server whose clients uploaded
    together waited for good. Five trials; the reference's broker garbled
    29 of 30 such trials."""
    from fedml_tpu_torch.comm.mqtt_mini import MiniMqttBroker, MiniMqttClient

    n, topics = 6_760_184, ["a", "b", "c", "d"]
    frames = {t: bytes([i + 1]) * n for i, t in enumerate(topics)}
    for trial in range(5):
        broker = MiniMqttBroker()
        got, done = {}, threading.Event()

        def on(topic, payload, got=got, done=done):
            got[topic] = payload
            if len(got) == len(topics):
                done.set()

        clients = [MiniMqttClient("127.0.0.1", broker.port, f"s{trial}",
                                  on_message=on)]
        try:
            for t in topics:
                clients[0].subscribe(t)
            pubs = [MiniMqttClient("127.0.0.1", broker.port, f"p{t}{trial}")
                    for t in topics]
            clients += pubs
            time.sleep(0.02)  # the SUBSCRIBEs land before the uploads
            go = threading.Barrier(len(topics))

            def upload(c, t):
                go.wait()
                c.publish(t, frames[t], qos=1)

            threads = [threading.Thread(target=upload, args=(c, t))
                       for c, t in zip(pubs, topics)]
            for th in threads:
                th.start()
            for th in threads:
                th.join()
            assert done.wait(5.0), f"trial {trial}: got {sorted(got)}"
            assert all(got[t] == frames[t] for t in topics), trial
        finally:
            for c in clients:
                c.close()
            broker.close()


def test_async_sender_is_the_reference_class():
    import inspect

    from fedml_tpu.core import pipeline as jax_pipeline
    from fedml_tpu_torch.core import pipeline

    assert inspect.getsource(pipeline.AsyncSender) == \
        inspect.getsource(jax_pipeline.AsyncSender)
