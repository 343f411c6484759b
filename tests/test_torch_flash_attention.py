"""fedml_tpu_torch flash attention against the JAX package's.

The port's autograd.Function runs on the CPU (its plain version, the path a
CPU tensor takes) and is held to fedml_tpu's flash_attention_with_lse in
Pallas interpret mode on the same numpy inputs: forward at the tolerance of
tests/test_flash_attention.py:28, gradients (with a nonzero lse cotangent)
at that of :52. The CUDA kernels themselves are held against the same plain
version on the card by chip_smoke.py.

The float32 kernels run their products on the tensor cores at float32
accuracy: the forward and dK/dV as six bf16 passes on operands split into
three bf16 parts, dQ as 3xTF32. test_3xtf32_products_keep_f32_accuracy
(backward) and test_3xtf32_forward_keeps_f32_accuracy emulate both recipes
on the CPU and pin why each pass is needed.
"""

import functools
import importlib
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.ops.flash_attention import (
    flash_attention_with_lse as jax_flash_with_lse,
)
from fedml_tpu_torch.ops.flash_attention import (
    _check_aligned,
    flash_attention,
    flash_attention_with_lse,
    flash_fwd,
)
from fedml_tpu_torch.parallel.ring_attention import full_attention

# the package re-exports a function of the same name, so fetch the module
fa = importlib.import_module("fedml_tpu_torch.ops.flash_attention")
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


@pytest.mark.parametrize("causal", [True, False])
def test_cohort_vmap_folds_into_b_and_unwraps(causal, monkeypatch):
    """Under vmap(grad(...)) (the local fit), the cohort dim is folded into
    B: the kernel entry points run once per call on plain [K*B, ...]
    tensors, never functorch wrappers, and the gradients (an lse term
    included) equal a loop over the clients."""
    seen = []

    def spy(fn):
        def wrapped(*args):
            seen.append((fn.__name__, tuple(args[0].shape), any(
                torch._C._functorch.is_functorch_wrapped_tensor(a)
                for a in args if torch.is_tensor(a))))
            return fn(*args)
        return wrapped

    for name in ("dense_fwd", "dense_bwd_dq", "dense_bwd_dkv"):
        monkeypatch.setattr(fa, name, spy(getattr(fa, name)))
    rs = np.random.RandomState(5)
    K, (B, T, H, D) = 3, (2, 20, 2, 16)
    q, k, v = (torch.from_numpy(rs.randn(K, B, T, H, D).astype(np.float32))
               for _ in range(3))
    w = torch.from_numpy(rs.randn(B, H, T).astype(np.float32))

    def loss(q, k, v):
        out, lse = flash_attention_with_lse(q, k, v, causal)
        return (out ** 2).sum() + (lse * w).sum()

    grads = torch.func.vmap(torch.func.grad(loss, argnums=(0, 1, 2)))(q, k, v)
    assert [(n, shape[0], wrapped) for n, shape, wrapped in seen] == [
        ("dense_fwd", K * B, False), ("dense_bwd_dq", K * B, False),
        ("dense_bwd_dkv", K * B, False)]
    for c in range(K):
        ref = torch.func.grad(loss, argnums=(0, 1, 2))(q[c], k[c], v[c])
        for a, b in zip(grads, ref):
            torch.testing.assert_close(a[c], b, rtol=1e-5, atol=1e-5)


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


def test_backward_wrappers_refuse_views_off_16_byte_boundary():
    """The kernels copy rows 16 bytes a thread: a contiguous view
    one float into its storage is refused before launch (chip_smoke.py
    drives the same refusal through the wrappers on the card)."""
    x = torch.zeros(1 + 64 * 32)
    _check_aligned("t", x[:-1].view(1, 64, 1, 32))
    with pytest.raises(ValueError, match="16-byte boundary"):
        _check_aligned("t", x[1:].view(1, 64, 1, 32))


def test_kernel_library_needs_a_card():
    from fedml_tpu_torch.ops.loader import load_library

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_library("flash_attention.cu")


def _tf32_rna(x):
    """float32 x rounded to TF32 (10-bit mantissa), to nearest with ties away
    from zero, as cvt.rna.tf32.f32 and the kernels' tf32_rna round it."""
    u = x.contiguous().view(torch.int32)
    return ((u + 0x1000) & -0x2000).view(torch.float32)


def _split3(x):
    """float32 x as its (lo, mid, hi) bf16 parts, bitwise the kernels'
    split3: hi = rn(x), mid = rn(x - hi), lo = rn(x - hi - mid), each
    rounded to nearest even, each residual exact in float32."""
    hi = x.to(torch.bfloat16).float()
    mid = (x - hi).to(torch.bfloat16).float()
    return (x - hi - mid).to(torch.bfloat16).float(), mid, hi


# the six bf16 passes of a float32-accurate product, smallest first, as
# (part of a, part of b) of _split3's (lo, mid, hi): lo*hi, hi*lo, mid*mid,
# mid*hi, hi*mid, hi*hi; "5xbf16" drops mid*mid
PASSES = {"6xbf16": ((0, 2), (2, 0), (1, 1), (1, 2), (2, 1), (2, 2)),
          "5xbf16": ((0, 2), (2, 0), (1, 2), (2, 1), (2, 2))}


def _matmul(a, b, mode):
    """a @ b with every product emulated as the tensor cores take it: f32
    (or f64) as is, "1xtf32" from TF32-rounded operands, "3xtf32" as
    big*small + small*big + big*big of each operand's TF32 split; "6xbf16"
    (and "5xbf16") as the bf16 passes of PASSES over each operand's split3
    parts, each pass exact (float64) and rounded once to float32, the
    passes summed in float32 smallest first."""
    if mode in ("f64", "f32"):
        return a @ b
    if mode in PASSES:
        pa, pb = _split3(a), _split3(b)
        out = None
        for i, j in PASSES[mode]:
            part = (pa[i].double() @ pb[j].double()).float()
            out = part if out is None else out + part
        return out
    big_a, big_b = _tf32_rna(a), _tf32_rna(b)
    if mode == "1xtf32":
        return big_a @ big_b
    small_a, small_b = _tf32_rna(a - big_a), _tf32_rna(b - big_b)
    return (big_a @ small_b + small_a @ big_b) + big_a @ big_b


def _emulated_bwd(q, k, v, do, lse, corr, causal, mode):
    """dQ, dK, dV ([BH, T, D]) by the kernels' seven products in ``mode``."""
    dt = torch.float64 if mode == "f64" else torch.float32
    q, k, v, do, lse, corr = (x.to(dt) for x in (q, k, v, do, lse, corr))
    T, scale = q.shape[1], q.shape[-1] ** -0.5
    s = _matmul(q, k.transpose(1, 2), mode) * scale
    if causal:
        s = s.masked_fill(~torch.ones(T, T, dtype=torch.bool).tril(), -1e30)
    p = torch.exp(s - lse[..., None])
    ds = p * (_matmul(do, v.transpose(1, 2), mode) + corr[..., None])
    return (_matmul(ds, k, mode) * scale,
            _matmul(ds.transpose(1, 2), q, mode) * scale,
            _matmul(p.transpose(1, 2), do, mode))


# recipe -> (its mode, the mode short of a pass, and how that one fails: on
# every output past 100x plain f32's error, or past the 4x gate on some
# output): 3xTF32 (dQ) against one TF32 pass; six bf16 passes (the forward
# and dK/dV) against five (no mid*mid)
RECIPES = {"3xtf32": ("3xtf32", "1xtf32", all, 100),
           "6xbf16": ("6xbf16", "5xbf16", any, 4)}


@pytest.mark.parametrize("recipe", sorted(RECIPES))
@pytest.mark.parametrize("causal", [False, True])
def test_3xtf32_products_keep_f32_accuracy(causal, recipe):
    """Against float64, 3xTF32 products, and six bf16 passes on split3's
    parts, give dQ, dK and dV within 4x of plain float32's error. Single-
    pass TF32 is over 100x worse, far outside the kernels' 1e-3 tolerance at
    long T; five bf16 passes (mid*mid dropped) fail the 4x gate (every output
    7.2-21x here), so each of the six is needed.

    This pins the operand split only. Each product here is one exactly
    rounded f32 matmul, so it does not model the tensor cores' truncating
    adds along a long accumulation chain, which the kernels avoid by adding
    each tile's product into an f32 register sum (acc_add). That half is
    held by chip_smoke.py's float64 check on the card (at most 4x plain
    f32's error at T = 2048)."""
    rs = np.random.RandomState(3)
    BH, T, D = 2, 256, 32
    q, k, v, do = (torch.tensor(rs.randn(BH, T, D).astype(np.float32))
                   for _ in range(4))
    g_lse = torch.tensor(rs.randn(BH, T))
    s = (q.double() @ k.double().transpose(1, 2)) * D ** -0.5
    if causal:
        s = s.masked_fill(~torch.ones(T, T, dtype=torch.bool).tril(),
                          float("-inf"))
    lse = torch.logsumexp(s, -1)
    corr = g_lse - (do.double() * (torch.softmax(s, -1) @ v.double())).sum(-1)
    args = (q, k, v, do, lse.float(), corr.float(), causal)
    exact = _emulated_bwd(*args, "f64")
    held, short, fails, worse = RECIPES[recipe]
    err = {mode: [float((x.double() - r).abs().max())
                  for x, r in zip(_emulated_bwd(*args, mode), exact)]
           for mode in ("f32", held, short)}
    for name, f32, good in zip(("dq", "dk", "dv"), err["f32"], err[held]):
        assert good <= 4 * f32, (name, good, f32)
    assert fails(b > worse * f for f, b in zip(err["f32"], err[short])), err


def _emulated_fwd(q, k, v, causal, mode, block=64):
    """o [BH, T, D] and lse [BH, T] by the forward kernel's arithmetic in
    ``mode``: 64-row key tiles, an online softmax in log2 units, S and each
    tile's P V as ``mode`` products, and each tile's P V added into O
    (rescaled by exp(m - m_new)) in f32, or f64 for the exact yardstick."""
    dt = torch.float64 if mode == "f64" else torch.float32
    q, k, v = (x.to(dt) for x in (q, k, v))
    T, D = q.shape[1], q.shape[2]
    scale2 = torch.tensor(D ** -0.5, dtype=dt) * math.log2(math.e)
    m = torch.full(q.shape[:2], -1e30, dtype=dt)
    l = torch.zeros(q.shape[:2], dtype=dt)
    o = torch.zeros_like(q)
    for k0 in range(0, T, block):
        kt, vt = k[:, k0:k0 + block], v[:, k0:k0 + block]
        s = _matmul(q, kt.transpose(1, 2), mode) * scale2
        if causal:
            above = torch.arange(k0, k0 + kt.shape[1]) > torch.arange(T)[:, None]
            s = s.masked_fill(above, -1e30)
        m_new = torch.maximum(m, s.amax(-1))
        corr = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new[..., None])
        l = l * corr + p.sum(-1)
        o = o * corr[..., None] + _matmul(p, vt, mode)
        m = m_new
    l = l.clamp_min(1e-30)
    return o / l[..., None], m * math.log(2) + torch.log(l)


@pytest.mark.parametrize("recipe", sorted(RECIPES))
@pytest.mark.parametrize("causal", [False, True])
def test_3xtf32_forward_keeps_f32_accuracy(causal, recipe):
    """Against float64, the forward kernel's arithmetic with 3xTF32 products
    gives o and lse within 4x of the same arithmetic in plain float32 (1.0-
    1.5x at this seed); single-pass TF32 is over 100x worse (600-2200x).
    Six bf16 passes also land within 4x (0.4-1.1x); five (mid*mid dropped)
    fail the gate (o 8.9-14x).
    Like the backward test, each product here rounds its sums to nearest;
    the tensor cores' truncating adds are held by chip_smoke.py's float64
    check on the card."""
    rs = np.random.RandomState(3)
    BH, T, D = 2, 256, 32
    q, k, v = (torch.tensor(rs.randn(BH, T, D).astype(np.float32))
               for _ in range(3))
    exact = _emulated_fwd(q, k, v, causal, "f64")
    s = (q.double() @ k.double().transpose(1, 2)) * D ** -0.5
    if causal:
        s = s.masked_fill(~torch.ones(T, T, dtype=torch.bool).tril(),
                          float("-inf"))
    torch.testing.assert_close(exact, (torch.softmax(s, -1) @ v.double(),
                                       torch.logsumexp(s, -1)))
    held, short, fails, worse = RECIPES[recipe]
    err = {mode: [float((x.double() - r).abs().max())
                  for x, r in zip(_emulated_fwd(q, k, v, causal, mode), exact)]
           for mode in ("f32", held, short)}
    for name, f32, good in zip(("o", "lse"), err["f32"], err[held]):
        assert good <= 4 * f32, (name, good, f32)
    assert fails(b > worse * f for f, b in zip(err["f32"], err[short])), err


def test_kernel_labels_name_the_f32_wgmma_instantiations():
    """chip_smoke.py's build phase finds each instantiation by the label it
    reads from the mangled name (these from an sm_90a build of
    flash_attention.cu): the float32 wgmma forward and dK/dV of the slice,
    named as the slice's kernels and the kernel line name them."""
    import chip_smoke

    ns = "_ZN51_GLOBAL__N__b69a0f6a_18_flash_attention_cu_2c138979"
    names = {
        "26flash_fwd_wgmma_f32_kernelILi32ELb1EEEv14CUtensorMap_stS1_S1_"
        "PfS2_iif": "flash_fwd_wgmma_f32_kernel<32,1>",
        "26flash_dkv_wgmma_f32_kernelILi32ELb1EEEv14CUtensorMap_stS1_S1_S1_"
        "PKfS3_PfS4_iif": "flash_dkv_wgmma_f32_kernel<32,1>",
    }
    assert {chip_smoke._kernel_label(ns + k) for k in names} == set(names.values())
    assert set(names.values()) <= set(chip_smoke.SLICE_KERNELS)
    assert {chip_smoke.KERNEL_OF[n][0] for n in chip_smoke.F32_WGMMA} == {
        label.split("<")[0] for label in names.values()}
