"""Rank-side scenarios of the port's sequence-parallel tests
(test_torch_ring_attention.py, test_torch_fedavg_seq.py and
test_torch_transformer.py); it holds no test of its own. Each scenario
runs on every rank of a gloo world on the CPU
(fedml_tpu_torch.mesh.world), once per test file, and returns its
results to the file's fixture. Imports nothing of JAX: the ranks load
only the port."""

from __future__ import annotations

import contextlib
import fcntl
import importlib
import tempfile
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
from torch.func import grad, vmap

from fedml_tpu_torch.collectives import ops
from fedml_tpu_torch.mesh import make_2d_mesh

ra = importlib.import_module("fedml_tpu_torch.parallel.ring_attention")


@contextlib.contextmanager
def one_world_at_a_time():
    """Hold an exclusive lock on a file in the temp directory while a test
    world runs: the files that xdist workers run side by side then start
    their 4-rank worlds in turn, so at most 4 rank processes add to the
    workers' load at any time."""
    path = Path(tempfile.gettempdir()) / "fedml_tpu_torch-test-world.lock"
    with open(path, "a") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)

# name -> (sharded wrapper, keyword arguments, causal)
ATTENTION = {
    f"{impl}-{'causal' if causal else 'full'}": (wrap, kw, causal)
    for impl, wrap, kw in (
        ("ring", "ring_attention_sharded", {}),
        ("ulysses", "ulysses_attention_sharded", {}),
        ("ulysses_flash", "ulysses_attention_sharded", {"use_flash": True}),
        ("ring_flash", "ring_attention_flash_sharded", {}))
    for causal in (False, True)
}

# the collectives' test functions: name -> (x from the inputs, loss)
OPS = ("ppermute", "psum", "all_to_all", "seq_invariant")

# the engine's tiny configuration (tests/test_fedavg_seq.py)
SEQ_WIDTHS = dict(vocab_size=32, dim=16, depth=1, num_heads=2, max_len=16)
SEQ_DATA = dict(num_clients=8, seq_len=16, vocab_size=32,
                samples_per_client=12, test_samples=40, seed=2)
SEQ_CFG = dict(comm_round=3, client_num_in_total=8, client_num_per_round=4,
               epochs=1, batch_size=6, lr=0.1, frequency_of_the_test=100,
               seed=0)
PROX_MU = 0.3
TRAIN_CFG = dict(SEQ_CFG, comm_round=4, lr=0.2, frequency_of_the_test=2,
                 seed=1)

# test_torch_transformer.py's sequence-parallel forward
TF_WIDTHS = dict(vocab_size=50, dim=32, depth=2, num_heads=4, max_len=64)
TF_IMPLS = {"ring": dict(seq_impl="ring"),
            "ring_flash": dict(seq_impl="ring", use_flash=True),
            "ulysses": dict(seq_impl="ulysses"),
            "ulysses_flash": dict(seq_impl="ulysses", use_flash=True)}


def _np(t):
    return t.detach().numpy().copy()


# ------------------------------------------------------------- attention
def op_losses(w, w2):
    """The collectives' test losses on one client's x (``w`` / ``w2`` this
    rank's weights): their gradients are the ops' transposes."""
    return {
        "ppermute": lambda x, ax: (ops.ppermute(x, ax) * w).sum(),
        "psum": lambda x, ax: (ops.psum(x, ax) ** 2).sum() / 2,
        "all_to_all": lambda x, ax: (ops.all_to_all(x, ax, 1, 0) * w2).sum(),
        "seq_invariant": lambda x, ax: (ops.seq_invariant(x, ax) * w).sum(),
    }


def attention(path):
    """Every sharded attention (forward and q/k/v grads of sum(out * g))
    and the collectives under vmap(grad) on a 1 x 4 mesh; the mesh's
    handles and errors."""
    z = np.load(Path(path) / "inputs.npz")
    r = dist.get_rank()
    mesh = make_2d_mesh(None, 4, ("clients", "seq"))
    ax = mesh["seq"]
    q, k, v = (torch.from_numpy(z[n]) for n in "qkv")
    g = torch.from_numpy(z["g"])
    out = {"attention": {}, "ops": {}}
    for name, (wrap, kw, causal) in ATTENTION.items():
        f = getattr(ra, wrap)(mesh, "seq", causal=causal, **kw)
        qq, kk, vv = (t.clone().requires_grad_() for t in (q, k, v))
        o = f(qq, kk, vv)
        grads = torch.autograd.grad((o * g).sum(), (qq, kk, vv))
        out["attention"][name] = (_np(o), [_np(t) for t in grads])
    losses = op_losses(torch.from_numpy(z["w"][r]),
                       torch.from_numpy(z["w2"][r]))
    for name in OPS:
        x = torch.from_numpy(z["x0"] if name == "seq_invariant"
                             else z["x"][r])
        loss = losses[name]
        out["ops"][name] = (_np(vmap(lambda t: loss(t, ax))(x)),
                            _np(vmap(grad(lambda t: loss(t, ax)))(x)))
    # a 2 x 2 mesh's handles, and the reference's two errors
    m2 = make_2d_mesh(None, 2, ("clients", "seq"))
    out["mesh"] = {a: (m2[a].ranks, m2[a].index, m2[a].size)
                   for a in m2.axis_names}
    out["mesh_shape"] = m2.shape
    out["errors"] = {}
    for label, args in (("exceeds", (8, 2)), ("minor", (None, 3))):
        try:
            make_2d_mesh(*args, ("clients", "seq"))
        except ValueError as e:
            out["errors"][label] = str(e)
    return out


# ---------------------------------------------------------------- engine
def seq_model(seq_axis, **kw):
    from fedml_tpu_torch.models.transformer import TransformerLM

    return TransformerLM(**SEQ_WIDTHS, seq_axis=seq_axis, **kw)


def seq_data():
    from fedml_tpu_torch.data.synthetic import synthetic_sequences

    return synthetic_sequences(**SEQ_DATA)


def skewed(data):
    """The skewed client sizes of tests/test_fedavg_seq.py (30..3 rows):
    the uniform aggregate of size_weighted sampling is observable."""
    from fedml_tpu_torch.core.client_data import FederatedData

    rs = np.random.RandomState(0)
    perm = rs.permutation(len(data.train_x))
    cuts = np.cumsum([30, 20, 14, 10, 8, 6, 5])
    idx_map = {c: np.sort(part) for c, part in
               enumerate(np.split(perm, cuts))}
    return FederatedData(data.train_x, data.train_y, data.test_x,
                         data.test_y, idx_map, data.test_idx_map,
                         data.class_num)


def prox_spec(cfg):
    from fedml_tpu_torch.algorithms.fedavg import make_client_optimizer
    from fedml_tpu_torch.core.local import LocalSpec

    return LocalSpec(optimizer=make_client_optimizer(cfg), epochs=cfg.epochs,
                     prox_mu=PROX_MU)


def bf16_spec(cfg):
    """The bf16 client-compute policy as the reference's FedAvgSeqAPI takes
    it: a LocalSpec, not the config's precision."""
    from fedml_tpu_torch.algorithms.fedavg import make_client_optimizer
    from fedml_tpu_torch.core.local import LocalSpec

    return LocalSpec(optimizer=make_client_optimizer(cfg), epochs=cfg.epochs,
                     compute_dtype="bf16")


def flash_model(seq_axis):
    return seq_model(seq_axis, use_flash=True)


def _net(api):
    return {k: _np(v) for k, v in api.net.items()}


def _floats(m):
    return {k: float(v) for k, v in m.items()}


def engine(path):
    """FedAvgSeqAPI on a 2 x 2 mesh from the start weights in ``path``:
    ring (3 rounds, and as run_rounds), Ulysses, size_weighted, flash,
    FedProx and flash under a bf16 LocalSpec (2 rounds), a checkpoint round
    trip, a round with precision='bf16' in the config and no spec, train(),
    and the constructor's refusals."""
    from fedml_tpu_torch.algorithms import FedAvgConfig, FedAvgSeqAPI
    from fedml_tpu_torch.core import checkpoint

    work = Path(path)
    start = torch.load(work / "start.pt")
    data = seq_data()
    cfg = FedAvgConfig(**SEQ_CFG)
    mesh = make_2d_mesh(None, 2, ("clients", "seq"))

    def api(ctor=seq_model, c=cfg, d=data, m=mesh, **kw):
        a = FedAvgSeqAPI(d, ctor, c, m, device="cpu", **kw)
        a.load_state(start)
        return a

    out = {}
    ring = api()
    out["ring_metrics"] = [_floats(ring.run_round(r)) for r in range(3)]
    out["ring"] = _net(ring)
    blk = api()
    out["block_metrics"] = {k: _np(v) for k, v in blk.run_rounds(0, 3).items()}
    out["block"] = _net(blk)
    for name, kw in (("ulysses", dict(ctor=lambda ax: seq_model(
                         ax, seq_impl="ulysses"))),
                     ("flash", dict(ctor=lambda ax: seq_model(
                         ax, use_flash=True))),
                     ("size_weighted", dict(
                         c=FedAvgConfig(**dict(SEQ_CFG,
                                               sampling="size_weighted")),
                         d=skewed(data))),
                     ("prox", dict(local_spec=prox_spec(cfg))),
                     ("bf16", dict(ctor=flash_model,
                                   local_spec=bf16_spec(cfg)))):
        a = api(**kw)
        out[f"{name}_ids"] = [a._sampled_ids(r).tolist() for r in range(2)]
        for r in range(2):
            a.run_round(r)
        out[name] = _net(a)
        out[f"{name}_uniform"] = a.uniform_avg

    # a checkpoint round trip (rank 0 writes, every rank restores)
    first = api()
    first.run_round(0)
    ckpt = str(work / "ckpt")
    if dist.get_rank() == 0:
        checkpoint.save_round(ckpt, 0, first.net, first.server_opt_state,
                              first.rng, num_heads=SEQ_WIDTHS["num_heads"])
    dist.barrier()
    second = FedAvgSeqAPI(data, seq_model, cfg, mesh, device="cpu")
    tmpl = {"net": {k: torch.zeros_like(v) for k, v in second.net.items()},
            "server_opt_state": (), "rng": np.zeros(2, np.uint32),
            "round": np.asarray(0, np.int64)}
    st = checkpoint.restore_round(ckpt, checkpoint.latest_round(ckpt), tmpl,
                                  num_heads=SEQ_WIDTHS["num_heads"])
    second.load_state(st["net"], st["server_opt_state"], st["rng"])
    out["restored_bitwise"] = (
        all(torch.equal(first.net[k], second.net[k]) for k in first.net)
        and np.array_equal(first.rng, second.rng))
    second.run_round(1)
    out["restored_trains"] = all(bool(torch.isfinite(v).all())
                                 for v in second.net.values())

    # the config's precision without a spec: the reference's FedAvgSeqAPI
    # never reads it (fedml_tpu/algorithms/fedavg_seq.py:116-118), so this
    # is round 0 in f32, the same as ``first``'s
    no_spec = api(c=FedAvgConfig(**dict(SEQ_CFG, precision="bf16")))
    out["no_spec_dtype"] = no_spec.local_spec.compute_dtype
    no_spec.run_round(0)
    out["no_spec_bitwise"] = all(torch.equal(first.net[k], no_spec.net[k])
                                 for k in first.net)

    tr = api(c=FedAvgConfig(**TRAIN_CFG))
    tr.train()
    out["history"] = tr.history

    out["errors"] = _refusals(data, cfg, mesh)
    # the single-process oracles, one a rank, side by side
    out["oracle"] = ORACLES[dist.get_rank()](data, cfg, start)
    if dist.get_rank() == 1:
        out["oracle_bf16"] = _oracle_bf16(data, cfg, start)
    return out


def _oracle_engine(data, cfg, start, **kw):
    from fedml_tpu_torch.algorithms import FedAvgAPI
    from fedml_tpu_torch.core.tasks import sequence_task

    api = FedAvgAPI(data, sequence_task(seq_model(None)), cfg, device="cpu",
                    **kw)
    api.load_state(start)
    return api


def _oracle_rounds(api, rounds):
    nets, metrics = [], []
    for r in range(rounds):
        metrics.append(_floats(api.run_round(r)))
        nets.append(_net(api))
    return {"nets": nets, "metrics": metrics,
            "ids": [api._sampled_ids(r).tolist() for r in range(rounds)],
            "uniform": api.uniform_avg}


def _oracle_dense(data, cfg, start):
    return _oracle_rounds(_oracle_engine(data, cfg, start), 3)


def _oracle_size_weighted(data, cfg, start):
    from fedml_tpu_torch.algorithms import FedAvgConfig

    sw = FedAvgConfig(**dict(SEQ_CFG, sampling="size_weighted"))
    return _oracle_rounds(_oracle_engine(skewed(data), sw, start), 2)


def _oracle_prox(data, cfg, start):
    return _oracle_rounds(_oracle_engine(data, cfg, start,
                                         local_spec=prox_spec(cfg)), 2)


def _oracle_bf16(data, cfg, start):
    """FedAvgAPI(precision='bf16') on the flash model, 2 rounds."""
    from fedml_tpu_torch.algorithms import FedAvgAPI, FedAvgConfig
    from fedml_tpu_torch.core.tasks import sequence_task

    api = FedAvgAPI(data, sequence_task(flash_model(None)),
                    FedAvgConfig(**dict(SEQ_CFG, precision="bf16")),
                    device="cpu")
    api.load_state(start)
    return _oracle_rounds(api, 2)


def _oracle_train(data, cfg, start):
    from fedml_tpu_torch.algorithms import FedAvgConfig

    api = _oracle_engine(data, FedAvgConfig(**TRAIN_CFG), start)
    api.train()
    return {"history": api.history}


# rank -> the single-process FedAvgAPI run it holds for the test
ORACLES = (_oracle_dense, _oracle_size_weighted, _oracle_prox,
           _oracle_train)


def _refusals(data, cfg, mesh):
    """The constructor's ValueErrors, by case: (type, message)."""
    from fedml_tpu_torch.algorithms import FedAvgConfig, FedAvgSeqAPI

    cases = {
        "axes": lambda: FedAvgSeqAPI(
            data, seq_model, cfg, make_2d_mesh(None, 2, ("data", "seq")),
            device="cpu"),
        "seq_length": lambda: FedAvgSeqAPI(
            data, seq_model, cfg, make_2d_mesh(3, 3, ("clients", "seq")),
            device="cpu"),
        "cohort": lambda: FedAvgSeqAPI(
            data, seq_model, FedAvgConfig(**dict(SEQ_CFG,
                                                 client_num_per_round=3)),
            mesh, device="cpu"),
        "ulysses_heads": lambda: FedAvgSeqAPI(
            data, lambda ax: seq_model(ax, seq_impl="ulysses"), cfg,
            make_2d_mesh(None, 4, ("clients", "seq")), device="cpu"),
        "seq_impl": lambda: FedAvgSeqAPI(
            data, lambda ax: seq_model(ax, seq_impl="striped"), cfg, mesh,
            device="cpu"),
    }
    out = {}
    for name, make in cases.items():
        try:
            make()
        except Exception as e:  # noqa: BLE001 — the test reads the type
            out[name] = (type(e).__name__, str(e))
        else:
            out[name] = (None, "")
    return out


# ----------------------------------------------------------- transformer
def transformer(path):
    """TransformerLM's sequence-parallel forward on a 1 x 4 mesh: this
    rank's logits block for each seq_impl (the weights drawn from one
    seed on every rank)."""
    from fedml_tpu_torch.models.transformer import TransformerLM

    toks = torch.from_numpy(np.load(Path(path) / "tokens.npy"))
    mesh = make_2d_mesh(None, 4, ("clients", "seq"))
    ax = mesh["seq"]
    tb = toks.shape[1] // ax.size
    block = toks[:, ax.index * tb:(ax.index + 1) * tb]
    out = {}
    for name, kw in TF_IMPLS.items():
        m = TransformerLM(**TF_WIDTHS, seq_axis=ax, **kw)
        m.reset_parameters(torch.Generator().manual_seed(0))
        with torch.no_grad():
            out[name] = _np(m(block))
    return out
