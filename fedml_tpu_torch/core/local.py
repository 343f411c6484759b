"""Local client update + evaluation, port of fedml_tpu/core/local.py.

The JAX package writes one client's fit as a pure function and vmaps it
over the cohort. The port does the same with ``torch.func``: one client's
optimizer step on one batch is a pure function

    step(params, opt_state, global_params, x[bs,...], y[bs,...], mask[bs])
        -> (params, opt_state, metrics)

(``torch.func.grad`` over the task's loss, which runs the model through
``functional_call``), and the cohort runs it under ``torch.func.vmap`` on
params and optimizer states stacked ``[K, ...]``. The epoch and batch loops
run outside the vmap, one cohort-wide step per batch:

    local_update(global_params, x[K,B,bs,...], y[K,B,bs,...], mask[K,B,bs])
        -> (params stacked [K, ...], metrics [K])

An all-masked (padded) batch is an exact no-op for params and optimizer
state, Adam's step count included: the update is selected out per client
with ``torch.where``, as the reference's ``lax.select`` does
(local.py:193-200). Nothing inside a fit reads back to the host. The models
ported so far draw no randomness during the fit, so it takes no RNG.

``LocalSpec.compute_dtype='bf16'`` is the reference's client-compute
policy: inside the gradient closure the f32 master params and the float
inputs are cast to bfloat16 (explicit casts, as the reference's
``_cast_floats``, not ``torch.autocast``, whose per-op lists differ), the
gradient flows back through the casts to f32, and the optimizer step, the
upload and the aggregate stay f32. The model's layers promote each
(input, weight) pair as flax does (models/dtypes.py), so uint8 pixels
normalised to f32 meet bf16 weights in f32 unless the model sets its own
activation ``dtype``. The default 'f32' makes no cast at all.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import torch
from torch.func import grad, vmap

from fedml_tpu_torch.core.optim import ClientOptimizer

METRICS = ("loss_sum", "correct", "count")


class Task(NamedTuple):
    """Model + objective bundle (the reference's concrete ModelTrainer).
    ``params`` below is a dict name -> tensor; every function computes one
    client's batch (the fit vmaps it over the cohort)."""

    # (generator, x_sample=None) -> params, drawn on the CPU, on the model's
    # device; x_sample fixes a lazy module's input width
    init: Callable
    # (params, x, y, mask, train) -> (loss, metrics); loss is differentiable
    loss: Callable
    # (params, x) -> model outputs (eval mode)
    predict: Callable
    # (params, x, y, mask) -> metrics dict with 'loss_sum','correct','count'
    eval_batch: Callable
    # the nn.Module the functions call (the wire layout reads a
    # TransformerLM's head count from it: convert.num_heads_of)
    module: object = None


@dataclasses.dataclass(frozen=True)
class LocalSpec:
    """Static configuration of a client's local fit (the reference's
    ``remat`` is queued in ROADMAP.md, queue A item 4). ``compute_dtype``:
    see the module docstring."""

    optimizer: ClientOptimizer  # see fedml_tpu_torch.core.optim
    epochs: int = 1
    prox_mu: float = 0.0  # FedProx proximal coefficient (0 = plain FedAvg)
    compute_dtype: str = "f32"


# accepted spellings of the LocalSpec precision policy -> compute dtype
# (None = no casts at all)
COMPUTE_DTYPES = {"f32": None, "float32": None,
                  "bf16": torch.bfloat16, "bfloat16": torch.bfloat16}


def _cast_floats(tree, dtype):
    """Float leaves of a (nested) dict or a tensor -> ``dtype``; labels,
    masks and integer pixels keep theirs."""
    if isinstance(tree, dict):
        return {k: _cast_floats(v, dtype) for k, v in tree.items()}
    return tree.to(dtype) if torch.is_floating_point(tree) else tree


def _select(keep, new, old):
    """torch.where(keep, new, old) leaf by leaf over (nested) dicts."""
    if isinstance(new, dict):
        return {k: _select(keep, new[k], old[k]) for k in new}
    return torch.where(keep, new, old)


def make_local_step(task: Task, spec: LocalSpec):
    """One client's optimizer step on one batch, a pure function (see the
    module docstring); the FedProx term mu/2 ||w - w_global||^2 joins the
    loss when ``spec.prox_mu > 0``."""
    if spec.compute_dtype not in COMPUTE_DTYPES:
        raise ValueError(f"compute_dtype={spec.compute_dtype!r} (one of "
                         f"{sorted(COMPUTE_DTYPES)})")
    cdt = COMPUTE_DTYPES[spec.compute_dtype]

    def total_loss(params, global_params, x, y, mask):
        if cdt is None:
            loss, metrics = task.loss(params, x, y, mask, True)
        else:
            # bf16 compute, f32 masters: the casts sit inside the grad
            # closure, so the gradient lands f32 through them; the loss and
            # the metrics come back f32
            loss, metrics = task.loss(_cast_floats(params, cdt),
                                      _cast_floats(x, cdt), y, mask, True)
            loss = loss.float()
            metrics = _cast_floats(metrics, torch.float32)
        if spec.prox_mu > 0.0:
            sq = sum(torch.sum((p - global_params[k]) ** 2)
                     for k, p in params.items())
            loss = loss + 0.5 * spec.prox_mu * sq
        return loss, metrics

    grad_fn = grad(total_loss, has_aux=True)

    def step(params, opt_state, global_params, x, y, mask):
        grads, metrics = grad_fn(params, global_params, x, y, mask)
        new_params, new_state = spec.optimizer.update(grads, opt_state, params)
        has_data = mask.sum() > 0  # padded batch: keep params and state
        return (_select(has_data, new_params, params),
                _select(has_data, new_state, opt_state), metrics)

    return step


def make_local_update(task: Task, spec: LocalSpec):
    """Build the cohort's local fit (see module docstring). Every client
    starts from ``global_params``; metrics are 'loss_sum', 'correct' and
    'count' SUMMED over each client's real samples and epochs, shape [K],
    so they aggregate across clients by addition."""
    step = vmap(make_local_step(task, spec), in_dims=(0, 0, None, 0, 0, 0))
    init_state = vmap(spec.optimizer.init)

    def local_update(global_params: dict, x, y, mask):
        K, B = mask.shape[:2]
        params = {k: v.detach().expand(K, *v.shape).clone()
                  for k, v in global_params.items()}
        opt_state = init_state(params)
        sums = {k: torch.zeros(K, device=mask.device) for k in METRICS}
        for _ in range(spec.epochs):
            for b in range(B):
                params, opt_state, metrics = step(
                    params, opt_state, global_params, x[:, b], y[:, b],
                    mask[:, b])
                sums = {k: sums[k] + metrics[k] for k in METRICS}
        return params, sums

    return local_update


def make_eval_fn(task: Task):
    """Masked evaluation over a padded global batch set [B, bs, ...] (the
    server's test_on_server_for_all_clients): one host read at the end."""

    @torch.no_grad()
    def eval_fn(params: dict, xb, yb, mb):
        acc = {k: 0.0 for k in METRICS}
        for b in range(xb.shape[0]):
            metrics = task.eval_batch(params, xb[b], yb[b], mb[b])
            acc = {k: acc[k] + metrics[k] for k in METRICS}
        n = max(float(acc["count"]), 1.0)
        return {"loss": float(acc["loss_sum"]) / n,
                "acc": float(acc["correct"]) / n, "count": float(acc["count"])}

    return eval_fn


def make_cohort_eval_fn(task: Task):
    """Per-client masked evaluation of one model over a chunk of clients
    [K, B, bs, ...], batched over the chunk with ``vmap``: metric sums of
    shape [K], left on the device."""
    batch = vmap(task.eval_batch, in_dims=(None, 0, 0, 0))

    @torch.no_grad()
    def eval_fn(params: dict, x, y, mask):
        K = mask.shape[0]
        acc = {k: torch.zeros(K, device=mask.device) for k in METRICS}
        for b in range(mask.shape[1]):
            metrics = batch(params, x[:, b], y[:, b], mask[:, b])
            acc = {k: acc[k] + metrics[k] for k in METRICS}
        return acc

    return eval_fn
