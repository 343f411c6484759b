"""The port's sequence-parallel attention against the JAX package's on the
same numpy inputs: ring, Ulysses (dense and flash) and flash-ring,
causal and not, outputs and q/k/v gradients, and the collectives'
gradients under vmap(grad(...)).

The port runs in one gloo world of 4 CPU processes for the whole file
(tests/test_torch_seq_ranks.attention, a 1 x 4 mesh), started before the
JAX side is computed here on 4 of the conftest's virtual CPU devices. The
port's flash wrappers run their plain twins on CPU tensors; the JAX flash
kernel runs as the JAX package's tests run it (its jnp twin under
shard_map)."""

import importlib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P

import test_torch_seq_ranks as ranks
from fedml_tpu_torch.mesh import make_2d_mesh
from fedml_tpu_torch.mesh.world import World

# the packages re-export a function of the module's name
ra = importlib.import_module("fedml_tpu_torch.parallel.ring_attention")
jra = importlib.import_module("fedml_tpu.parallel.ring_attention")

N = 4                      # ranks / devices on the seq axis
SHAPE = (2, 32, 8, 16)     # [B, T, H, D]
K = 3                      # the vmapped (cohort) dim of the ops' inputs
OUT_TOL = dict(rtol=2e-4, atol=2e-5)
GRAD_TOL = dict(rtol=5e-3, atol=1e-4)
DEADLINE_S = 180.0


def _inputs():
    rs = np.random.RandomState(0)
    f = lambda *s: rs.randn(*s).astype(np.float32)  # noqa: E731
    return dict(q=f(*SHAPE), k=f(*SHAPE), v=f(*SHAPE), g=f(*SHAPE),
                x=f(N, K, 2, 8), x0=f(K, 2, 8), w=f(N, 2, 8), w2=f(N, 8, 2))


def _jax_attention(z, mesh):
    """{name: (out, (dq, dk, dv))} of the JAX package's sharded wrappers:
    the vjp of sum(out * g)."""
    out = {}
    q, k, v, g = (jnp.asarray(z[n]) for n in "qkvg")
    for name, (wrap, kw, causal) in ranks.ATTENTION.items():
        f = getattr(jra, wrap)(mesh, "seq", causal=causal, **kw)

        @jax.jit
        def run(q, k, v, f=f):
            o, vjp = jax.vjp(f, q, k, v)
            return o, vjp(g)

        with jax.set_mesh(mesh):
            o, grads = run(q, k, v)
        out[name] = (np.asarray(o), [np.asarray(t) for t in grads])
    return out


def _vary(x):
    """``x`` typed as varying over 'seq' (a per-device output block)."""
    vma = getattr(jax.typeof(x), "vma", frozenset())
    return x if "seq" in vma else lax.pcast(x, "seq", to="varying")


def _jax_ops(z, mesh):
    """{op: (values, grads)} by device: the same losses as the port's
    (test_torch_seq_ranks.op_losses) under vmap(grad(...)) inside shard_map."""
    perm = [(i, (i + 1) % N) for i in range(N)]
    losses = {
        "ppermute": lambda x, w, w2: jnp.sum(
            lax.ppermute(x, "seq", perm) * w),
        "psum": lambda x, w, w2: jnp.sum(lax.psum(x, "seq") ** 2) / 2,
        "all_to_all": lambda x, w, w2: jnp.sum(lax.all_to_all(
            x, "seq", 1, 0, tiled=True) * w2),
        "seq_invariant": lambda x, w, w2: jnp.sum(
            lax.pcast(x, "seq", to="varying") * w),
    }
    out = {}
    for name, loss in losses.items():
        inv = name == "seq_invariant"

        def body(x, w, w2, loss=loss, inv=inv):
            x = x if inv else x[0]
            w, w2 = w[0], w2[0]
            vals = jax.vmap(lambda t: loss(t, w, w2))(x)
            grads = jax.vmap(jax.grad(lambda t: loss(t, w, w2)))(x)
            return _vary(vals)[None], _vary(grads)[None]

        f = jax.jit(jax.shard_map(
            body, mesh=mesh,
            in_specs=(P() if inv else P("seq"), P("seq"), P("seq")),
            out_specs=(P("seq"), P("seq"))))
        x = z["x0"] if inv else z["x"]
        vals, grads = f(jnp.asarray(x), jnp.asarray(z["w"]),
                        jnp.asarray(z["w2"]))
        out[name] = (np.asarray(vals), np.asarray(grads))
    return out


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """(port results by rank, JAX attention, JAX ops): the port's world
    runs while the JAX side is computed."""
    work = tmp_path_factory.mktemp("ring_world")
    z = _inputs()
    np.savez(work / "inputs.npz", **z)
    with ranks.one_world_at_a_time():
        world = World("test_torch_seq_ranks:attention", N, (str(work),),
                      deadline_s=DEADLINE_S,
                      sys_path=(str(Path(__file__).parent),),
                      workdir=str(work / "world")).start()
        try:
            mesh = Mesh(np.asarray(jax.devices()[:N]), ("seq",))
            ref_attn, ref_ops = _jax_attention(z, mesh), _jax_ops(z, mesh)
        finally:
            port = world.join()
    return port, ref_attn, ref_ops


@pytest.mark.parametrize("name", list(ranks.ATTENTION))
def test_attention_output_matches_jax(both, name):
    port, ref, _ = both
    for r in range(N):  # every rank holds the gathered output
        np.testing.assert_allclose(port[r]["attention"][name][0], ref[name][0],
                                   **OUT_TOL)


@pytest.mark.parametrize("name", list(ranks.ATTENTION))
def test_attention_grads_match_jax(both, name):
    port, ref, _ = both
    for r in range(N):
        for got, want in zip(port[r]["attention"][name][1], ref[name][1]):
            np.testing.assert_allclose(got, want, **GRAD_TOL)


@pytest.mark.parametrize("op", ranks.OPS)
def test_collective_grads_under_vmap_match_jax(both, op):
    """Each op's value and its gradient through vmap(grad(...)) on every
    rank: ppermute's is the inverse shift, all_to_all's the inverse
    exchange, psum's the identity on its invariant cotangent and
    seq_invariant's the psum of the rank-varying cotangent."""
    port, _, ref = both
    vals, grads = ref[op]
    for r in range(N):
        got_v, got_g = port[r]["ops"][op]
        np.testing.assert_allclose(got_v, vals[r], rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(got_g, grads[r], rtol=1e-6, atol=1e-6)


def test_make_2d_mesh_lays_ranks_row_major(both):
    port, _, _ = both
    want = {0: {"clients": ((0, 2), 0, 2), "seq": ((0, 1), 0, 2)},
            1: {"clients": ((1, 3), 0, 2), "seq": ((0, 1), 1, 2)},
            2: {"clients": ((0, 2), 1, 2), "seq": ((2, 3), 0, 2)},
            3: {"clients": ((1, 3), 1, 2), "seq": ((2, 3), 1, 2)}}
    for r in range(N):
        assert port[r]["mesh"] == want[r]
        assert port[r]["mesh_shape"] == {"clients": 2, "seq": 2}


def test_make_2d_mesh_keeps_the_reference_errors(both):
    port, _, _ = both
    errors = port[0]["errors"]
    assert errors["exceeds"] == "--mesh 8 exceeds 4 devices"
    assert errors["minor"].startswith("--mesh 4 not divisible by minor axis 3")


def test_make_2d_mesh_needs_a_world():
    with pytest.raises(RuntimeError, match="init_process_group"):
        make_2d_mesh(None, 2, ("clients", "seq"))


def test_logaddexp_gradient_is_finite_where_both_are_minus_inf():
    a = torch.tensor([-np.inf, -np.inf, 0.5], requires_grad=True)
    b = torch.tensor([-np.inf, 1.0, -np.inf], requires_grad=True)
    out = ra._logaddexp(a, b)
    ga, gb = torch.autograd.grad(out.sum(), (a, b))
    np.testing.assert_allclose(out.detach().numpy(),
                               np.logaddexp(a.detach().numpy(),
                                            b.detach().numpy()))
    assert torch.isfinite(ga).all() and torch.isfinite(gb).all()
    np.testing.assert_allclose(ga.numpy()[1:], [0.0, 1.0])
    np.testing.assert_allclose(gb.numpy()[1:], [1.0, 0.0])


def test_online_block_update_of_a_fully_masked_block_has_finite_grads():
    """A causal block entirely above the diagonal (its keys after every
    query) leaves the running state alone and passes no NaN back."""
    rs = np.random.RandomState(1)
    q, k, v = (torch.tensor(rs.randn(1, 4, 2, 8), dtype=torch.float32,
                            requires_grad=True) for _ in range(3))
    o = torch.zeros(1, 4, 2, 8)
    l, m = torch.zeros(1, 2, 4), torch.full((1, 2, 4), float("-inf"))
    o2, l2, m2 = ra._online_block_update(q, k, v, o, l, m, 0, 4, True,
                                         8 ** -0.5)
    assert torch.equal(o2, o) and torch.equal(l2, l)
    grads = torch.autograd.grad(o2.sum() + l2.sum(), (q, k, v),
                                allow_unused=True)
    assert all(g is None or torch.isfinite(g).all() for g in grads)
