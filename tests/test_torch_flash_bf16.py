"""The port's bf16 long-context path against the JAX package on the CPU:
the flash kernels' module on bf16 q/k/v/dO, TransformerLM on bf16 weights
(flash on and off), one FedAvgAPI(precision='bf16') round on
transformer_flash, and sequence_task's metrics under bf16 logits.

On the CPU the flash wrappers run their plain versions (float32 math on
bf16 inputs, each output rounded to bf16 once, as the reference's Pallas
kernels do); the CUDA kernels themselves are held to those plain versions
and to float64 on the card by chip_smoke.py's ``kernels`` phase. Each JAX
result is computed once per module. Bounds (measured here, stated beside
each test):

- kernel module against JAX's interpret-mode kernels: o, dq, dk, dv within
  one bf16 ulp of each tensor's largest |entry| (measured: at most a few
  float32 ulps apart, dk's largest gap 2.4e-4 of |dk| up to 9.4); lse
  (float32) within 2e-5 (tests/test_flash_attention.py:28);
- TransformerLM logits on bf16-cast weights within 4 bf16 ulps of the
  largest |logit| (measured: 2 ulps, 0.031 of 3.28, flash off; 1 ulp on);
  the parameter gradients within 2**-4 of each tensor's largest |grad|
  (measured: at most 1.7 %); torch and XLA round bf16 at other places
  (fused or not), so the two sides agree to bf16 rounding, not bitwise;
- one engine round: mean training loss within 2e-2 of the JAX engine's
  (the reference's bf16 bound, tests/test_fused_bf16.py:379; measured
  4.3e-4) and each tensor within 2**-4 of its largest update entry
  (measured: 1.9 %), as tests/test_torch_bf16.py holds the bf16 CNN.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from fedml_tpu.algorithms.fedavg import FedAvgAPI as JaxFedAvgAPI
from fedml_tpu.algorithms.fedavg import FedAvgConfig as JaxConfig
from fedml_tpu.core.tasks import sequence_task as jax_sequence_task
from fedml_tpu.data.synthetic import synthetic_sequences as jax_sequences
from fedml_tpu.models.transformer import TransformerLM as JaxTransformerLM
from fedml_tpu.ops.flash_attention import (
    flash_attention_with_lse as jax_flash_with_lse,
)
from fedml_tpu_torch import convert
from fedml_tpu_torch.algorithms.fedavg import FedAvgAPI, FedAvgConfig
from fedml_tpu_torch.core.tasks import sequence_task
from fedml_tpu_torch.data.synthetic import synthetic_sequences
from fedml_tpu_torch.models import create_model
from fedml_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_with_lse,
    flash_fwd,
)

BF16 = torch.bfloat16
# kernel module cases: (causal, [B, T, H, D]); both T ragged against JAX's
# 32-blocks
CASES = {"causal-T100-D16": (True, (2, 100, 2, 16)),
         "full-T70-D32": (False, (1, 70, 2, 32))}
OUTPUTS = ("o", "lse", "dq", "dk", "dv")
# tests/test_torch_transformer.py's widths
WIDTHS = dict(vocab_size=32, dim=32, depth=1, num_heads=2, max_len=64)
TOKENS = np.random.RandomState(0).randint(0, 32, size=(2, 48))
TARGETS = np.random.RandomState(1).randint(0, 32, size=(2, 48))
# tests/test_torch_fedavg_lm.py's engine configuration, one round
CFG = dict(comm_round=1, client_num_in_total=4, client_num_per_round=2,
           batch_size=4, lr=0.1, frequency_of_the_test=1, eval_batch_size=4,
           seed=0)
DATA = dict(num_clients=4, seq_len=32, vocab_size=32, samples_per_client=6,
            test_samples=8)


def _ulp(x) -> float:
    """One bf16 ulp at the largest |entry| of ``x`` (8 significant bits)."""
    m = float(np.abs(x).max())
    return 2.0 ** (np.floor(np.log2(m)) - 7)


def _f32(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


# --------------------------------------------------------- kernel module
def _kernel_inputs(shape):
    rs = np.random.RandomState(sum(shape))
    B, T, H, D = shape
    q, k, v, g = (rs.randn(B, T, H, D).astype(np.float32) for _ in range(4))
    return q, k, v, g, rs.randn(B, H, T).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _jax_kernels(case):
    """JAX's Pallas kernels (interpret mode) on bf16 inputs: o, lse and the
    vjp of (g, g_lse), as float32 numpy."""
    causal, shape = CASES[case]
    q, k, v, g, g_lse = _kernel_inputs(shape)
    q, k, v, g = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v, g))
    (o, lse), vjp = jax.vjp(
        lambda q, k, v: jax_flash_with_lse(q, k, v, causal, 32, 32), q, k, v)
    dq, dk, dv = vjp((g, jnp.asarray(g_lse)))
    assert o.dtype == dq.dtype == jnp.bfloat16 and lse.dtype == jnp.float32
    return dict(zip(OUTPUTS, (_f32(x) for x in (o, lse, dq, dk, dv))))


@functools.lru_cache(maxsize=None)
def _port_kernels(case):
    causal, shape = CASES[case]
    q, k, v, g, g_lse = _kernel_inputs(shape)
    tq, tk, tv = (torch.from_numpy(x).to(BF16).requires_grad_()
                  for x in (q, k, v))
    o, lse = flash_attention_with_lse(tq, tk, tv, causal)
    grads = torch.autograd.grad((o, lse), (tq, tk, tv),
                                (torch.from_numpy(g).to(BF16),
                                 torch.from_numpy(g_lse)))
    outs = (o, lse, *grads)
    dtypes = [t.dtype for t in outs]
    return dtypes, dict(zip(OUTPUTS, (t.detach().float().numpy()
                                      for t in outs)))


@pytest.mark.parametrize("out", OUTPUTS)
@pytest.mark.parametrize("case", list(CASES))
def test_bf16_kernel_module_matches_jax_interpret(case, out):
    """o, lse and the gradients with a nonzero lse cotangent, on bf16
    q/k/v/dO, against the reference's kernels at the bound in the module
    docstring."""
    got, want = _port_kernels(case)[1][out], _jax_kernels(case)[out]
    if out == "lse":
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    else:
        assert np.abs(got - want).max() <= _ulp(want), (
            np.abs(got - want).max(), _ulp(want))


def test_bf16_outputs_keep_the_reference_dtypes():
    """o, dq, dk, dv in bf16, lse float32, as the reference's out_shape."""
    dtypes, _ = _port_kernels("full-T70-D32")
    assert dtypes == [BF16, torch.float32, BF16, BF16, BF16]


def test_mixed_dtypes_and_cpu_tensors_raise():
    """q, k, v of two dtypes raise on either device; the kernel wrapper
    refuses a CPU bf16 tensor (it never runs the plain version)."""
    x = torch.zeros(1, 8, 1, 16)
    with pytest.raises(TypeError, match="one dtype"):
        flash_attention(x.to(BF16), x, x)
    with pytest.raises(ValueError, match="CUDA"):
        flash_fwd(x.to(BF16), x.to(BF16), x.to(BF16), True)


def _tf32(x):
    u = x.contiguous().view(torch.int32)
    return ((u + 0x1000) & -0x2000).view(torch.float32)


def test_bf16_operands_need_no_small_split():
    """The bf16 kernels leave out every tensor-core pass whose operand split
    is zero: a bf16 value is exact in TF32 (its small part is 0), so Q K^T
    in one TF32 pass and P V (P float32) in two equal the full 3xTF32
    products bitwise, emulated here as the kernels split them."""
    rs = np.random.RandomState(4)
    q, k, v = (torch.from_numpy(rs.randn(64, 32).astype(np.float32))
               .to(BF16).float() for _ in range(3))
    p = torch.softmax(torch.from_numpy(rs.randn(64, 64).astype(np.float32)), -1)
    for x in (q, k, v):
        assert torch.equal(_tf32(x), x)  # small = x - big = 0

    def three(a, b):  # big*small + small*big + big*big
        ba, bb = _tf32(a), _tf32(b)
        sa, sb = _tf32(a - ba), _tf32(b - bb)
        return (ba @ sb + sa @ bb) + ba @ bb

    assert torch.equal(_tf32(q) @ _tf32(k).T, three(q, k.T.contiguous()))
    two = _tf32(p - _tf32(p)) @ _tf32(v) + _tf32(p) @ _tf32(v)
    assert torch.equal(two, three(p, v))


# ---------------------------------------------------------- TransformerLM
@functools.lru_cache(maxsize=None)
def _flax_params():
    model = JaxTransformerLM(**WIDTHS)
    params = jax.jit(model.init)(jax.random.PRNGKey(1), TOKENS)["params"]
    return jax.tree.map(np.asarray, params)


@functools.lru_cache(maxsize=None)
def _flax_bf16(use_flash):
    """flax's logits and mean cross-entropy gradients on the bf16-cast
    weights (the policy's casts), as float32 numpy in the port's names."""
    model = JaxTransformerLM(**WIDTHS, use_flash=use_flash)
    p16 = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), _flax_params())

    def loss(p):
        logits = model.apply({"params": p}, TOKENS)
        ce = optax.softmax_cross_entropy_with_integer_labels(logits, TARGETS)
        return ce.mean(), logits

    grads, logits = jax.jit(jax.grad(loss, has_aux=True))(p16)
    assert logits.dtype == jnp.bfloat16
    return _f32(logits), convert.from_flax(jax.tree.map(_f32, grads))


@functools.lru_cache(maxsize=None)
def _port_bf16(use_flash):
    model = create_model("transformer_flash" if use_flash else "transformer",
                         device="cpu", **WIDTHS)
    p16 = {k: v.to(BF16) for k, v in
           convert.from_flax(_flax_params()).items()}

    def loss(p):
        logits = torch.func.functional_call(model, p,
                                            (torch.from_numpy(TOKENS),))
        ce = F.cross_entropy(logits.flatten(0, 1),
                             torch.from_numpy(TARGETS).flatten())
        return ce, logits

    grads, logits = torch.func.grad(loss, has_aux=True)(p16)
    return logits, grads


@pytest.mark.parametrize("use_flash", [False, True])
def test_bf16_transformer_logits_match_flax(use_flash):
    logits, _ = _port_bf16(use_flash)
    want, _ = _flax_bf16(use_flash)
    assert logits.dtype == BF16
    gap = np.abs(logits.float().numpy() - want).max()
    assert gap <= 4 * _ulp(want), (gap, _ulp(want))


@pytest.mark.parametrize("use_flash", [False, True])
def test_bf16_transformer_grads_match_flax(use_flash):
    _, grads = _port_bf16(use_flash)
    _, want = _flax_bf16(use_flash)
    assert set(grads) == set(want)
    for k, g in grads.items():
        assert g.dtype == BF16, k
        w = want[k].numpy()
        gap = np.abs(g.float().numpy() - w).max()
        assert gap <= 2.0 ** -4 * np.abs(w).max(), (k, gap)


# ----------------------------------------------------------------- engine
@functools.lru_cache(maxsize=None)
def _jax_round():
    """One bf16 round of the JAX engine on TransformerLM(use_flash=True):
    (start, end, metrics)."""
    task = jax_sequence_task(JaxTransformerLM(**WIDTHS, use_flash=True))
    task = task._replace(init=jax.jit(task.init))
    api = JaxFedAvgAPI(jax_sequences(**DATA), task,
                       JaxConfig(**CFG, precision="bf16"))
    start = convert.from_flax(jax.tree.map(np.asarray, api.net.params))
    m = api.run_round(0)
    end = convert.from_flax(jax.tree.map(np.asarray, api.net.params))
    return start, end, {k: float(v) for k, v in m.items()}


@functools.lru_cache(maxsize=None)
def _port_round(precision):
    start, _, _ = _jax_round()
    api = FedAvgAPI(synthetic_sequences(**DATA), sequence_task(create_model(
        "transformer_flash", device="cpu", **WIDTHS)),
        FedAvgConfig(**CFG, precision=precision), device="cpu")
    api.load_state(start)
    m = api.run_round(0)
    return api.net, {k: float(v) for k, v in m.items()}


def test_bf16_round_loss_matches_the_jax_engine():
    _, _, jm = _jax_round()
    _, m = _port_round("bf16")
    assert m["count"] == jm["count"]
    assert abs(m["loss_sum"] / m["count"] - jm["loss_sum"] / jm["count"]) \
        <= 2e-2


def test_bf16_round_params_match_the_jax_engine():
    start, want, _ = _jax_round()
    net, _ = _port_round("bf16")
    for k, v in net.items():
        assert v.dtype == torch.float32, k  # the masters stay f32
        upd = float((want[k] - start[k]).abs().max())
        assert float((v - want[k]).abs().max()) <= 2.0 ** -4 * upd, k


def test_bf16_round_is_not_the_f32_round():
    """The policy ran: the bf16 round's params differ from the f32
    round's, tensor by tensor, from the same weights."""
    net16, _ = _port_round("bf16")
    net32, _ = _port_round("f32")
    assert all(not torch.equal(net16[k], net32[k]) for k in net16)


# ---------------------------------------------------------- sequence_task
@pytest.mark.parametrize("mask_dtype", [torch.float32, BF16])
def test_sequence_task_counts_exactly_and_sums_in_f32_under_bf16(mask_dtype):
    """bf16 logits (the model on bf16 weights): the token mask is float32
    (the reference's, core/tasks.py:122), so the count of 429 unmasked
    tokens is exact (bf16 holds odd integers only to 255) and loss_sum is
    the float32 sum of the bf16 per-token losses (a bf16 sum of 429 of them
    would be ~1e-2 off)."""
    rs = np.random.RandomState(7)
    model = create_model("transformer", device="cpu", **WIDTHS)
    task = sequence_task(model)
    x = torch.from_numpy(rs.randint(0, 32, size=(8, 64)))
    y = torch.from_numpy(rs.randint(0, 32, size=(8, 64)))
    y[0, 0] = 0  # one more pad token: an odd count, no bf16 integer
    mask = torch.tensor([1, 1, 1, 1, 1, 1, 1, 0], dtype=mask_dtype)
    params = {k: v.detach().to(BF16) for k, v in model.named_parameters()}
    _, _, m = task.loss(params, {}, x, y, mask, None, True)
    keep = (y != 0) & (mask[:, None] > 0)
    assert int(keep.sum()) == 429
    assert all(v.dtype == torch.float32 for v in m.values())
    assert float(m["count"]) == 429.0
    logits = torch.func.functional_call(model, params, (x,))
    per_tok = F.cross_entropy(logits.flatten(0, 1), y.flatten(),
                              reduction="none").view_as(y)
    assert per_tok.dtype == BF16
    exact = float(per_tok.double()[keep].sum())
    assert abs(float(m["loss_sum"]) - exact) <= 1e-6 * exact
