"""fedml_tpu_torch flash attention against the JAX package's.

The port's autograd.Function runs on the CPU (its plain version, the path a
CPU tensor takes) and is held to fedml_tpu's flash_attention_with_lse in
Pallas interpret mode on the same numpy inputs: forward at the tolerance of
tests/test_flash_attention.py:28, gradients (with a nonzero lse cotangent)
at that of :52. The CUDA kernels themselves are held against the same plain
version on the card by chip_smoke.py.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.ops.flash_attention import (
    flash_attention_with_lse as jax_flash_with_lse,
)
from fedml_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_with_lse,
    flash_fwd,
)
from fedml_tpu_torch.parallel.ring_attention import full_attention

SHAPE = (2, 70, 2, 32)  # T=70: ragged against JAX's 32-blocks


def _inputs(seed=0):
    rs = np.random.RandomState(seed)
    B, T, H, D = SHAPE
    q, k, v, g = (rs.randn(B, T, H, D).astype(np.float32) for _ in range(4))
    g_lse = rs.randn(B, H, T).astype(np.float32)
    return q, k, v, g, g_lse


@functools.lru_cache(maxsize=None)
def _jax_reference(causal):
    """JAX (out, lse) and the vjp of (g, g_lse) — computed once per mode."""
    q, k, v, g, g_lse = _inputs()
    (out, lse), vjp = jax.vjp(
        lambda q, k, v: jax_flash_with_lse(q, k, v, causal, 32, 32), q, k, v)
    grads = vjp((jnp.asarray(g), jnp.asarray(g_lse)))
    return np.asarray(out), np.asarray(lse), [np.asarray(x) for x in grads]


def _port(causal):
    q, k, v, g, g_lse = _inputs()
    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    out, lse = flash_attention_with_lse(tq, tk, tv, causal)
    grads = torch.autograd.grad((out, lse), (tq, tk, tv),
                                (torch.tensor(g), torch.tensor(g_lse)))
    return out.detach().numpy(), lse.detach().numpy(), [x.numpy() for x in grads]


@pytest.mark.parametrize("causal", [False, True])
def test_forward_matches_jax_flash(causal):
    out, lse, _ = _port(causal)
    j_out, j_lse, _ = _jax_reference(causal)
    np.testing.assert_allclose(out, j_out, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(lse, j_lse, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("causal", [False, True])
def test_gradients_with_lse_cotangent_match_jax_flash(causal):
    _, _, grads = _port(causal)
    _, _, j_grads = _jax_reference(causal)
    for a, b in zip(grads, j_grads):
        np.testing.assert_allclose(a, b, rtol=5e-4, atol=5e-4)


@pytest.mark.parametrize("causal", [False, True])
def test_autograd_matches_dense_attention(causal):
    """Independent of JAX: out and its gradients equal torch autograd
    through full_attention, and lse equals the masked logsumexp."""
    q, k, v, g, _ = _inputs(1)
    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    rq, rk, rv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    out, lse = flash_attention_with_lse(tq, tk, tv, causal)
    ref = full_attention(rq, rk, rv, causal)
    torch.testing.assert_close(out, ref, rtol=2e-5, atol=2e-5)
    s = torch.einsum("bqhd,bkhd->bhqk", rq, rk) / SHAPE[-1] ** 0.5
    if causal:
        s = s.masked_fill(~torch.ones(SHAPE[1], SHAPE[1], dtype=torch.bool).tril(),
                          float("-inf"))
    torch.testing.assert_close(lse, torch.logsumexp(s, -1), rtol=2e-5, atol=2e-5)
    gt = torch.autograd.grad(out, (tq, tk, tv), torch.tensor(g))
    gr = torch.autograd.grad(ref, (rq, rk, rv), torch.tensor(g))
    for a, b in zip(gt, gr):
        torch.testing.assert_close(a, b, rtol=5e-4, atol=5e-4)


def test_flash_attention_returns_out_only():
    q, k, v, _, _ = _inputs(2)
    tq, tk, tv = (torch.tensor(x) for x in (q, k, v))
    out = flash_attention(tq, tk, tv, True)
    torch.testing.assert_close(out, flash_attention_with_lse(tq, tk, tv, True)[0])
    assert out.shape == SHAPE


def test_kernel_wrapper_never_runs_the_plain_version():
    """The kernel wrapper takes CUDA tensors only: it raises on a CPU
    tensor instead of computing anything itself."""
    q = torch.zeros(SHAPE)
    with pytest.raises(ValueError, match="CUDA"):
        flash_fwd(q, q, q, True)


def test_kernel_library_needs_a_card():
    from fedml_tpu_torch.ops.loader import load_library

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_library("flash_attention.cu")
