"""Local client update + evaluation, port of fedml_tpu/core/local.py.

The JAX package writes one client's fit as a pure function and vmaps it
over the cohort. The port does the same with ``torch.func``. A model's
state, the ``net``, is one dict name -> tensor holding its params and its
extras (non-gradient state such as BatchNorm's running statistics: the
module's buffers, ``Task.extra_keys``), the JAX package's ``NetState(
params, extra)``. One client's optimizer step on one batch is a pure
function

    step(params, extra, opt_state, global_params, x[bs,...], y[bs,...],
         mask[bs], key) -> (params, extra, opt_state, metrics)

(``torch.func.grad`` over the task's loss with respect to the params only,
the loss returning the new extras as auxiliary output), and the cohort
runs it under ``torch.func.vmap`` on params, extras and optimizer states
stacked ``[K, ...]``. The epoch and batch loops run outside the vmap, one
cohort-wide step per batch:

    local_update(global_net, x[K,B,bs,...], y[K,B,bs,...], mask[K,B,bs],
                 keys=None) -> (nets stacked [K, ...], metrics [K])

The optimizer, its weight decay and the FedProx term see the params only.
An all-masked (padded) batch is an exact no-op for params, extras and
optimizer state, Adam's step count included: the update is selected out
per client with ``torch.where``, as the reference's ``lax.select`` does
(local.py:193-200). Nothing inside a fit reads back to the host.

A task whose model draws randomness (``Task.needs_key``: dropout) takes
one key a batch: ``keys`` is ``[E, B, K, 2]``, the uint32 words of
utils/prng ``fit_keys`` (per client, split per epoch, then per batch, as
the reference's nested scans split) in int64, on the device. The other
tasks take none, and their fits compute no key.

``LocalSpec.remat`` recomputes the per-batch loss's forward in the
backward instead of keeping its activations (``jax.checkpoint`` of the
reference's whole ``total_loss``): a ``torch.autograd.Function`` whose
forward runs the loss without recording a graph and whose backward reruns
it under ``torch.func.vjp``, with a generated vmap rule for the cohort.
(``torch.utils.checkpoint`` refuses to run under ``torch.func.grad``.) The
same ops on the same inputs: the numerics are those without remat.

``LocalSpec.compute_dtype='bf16'`` is the reference's client-compute
policy: inside the gradient closure the f32 master params, the extras and
the float inputs are cast to bfloat16 (explicit casts, as the reference's
``_cast_floats``, not ``torch.autocast``, whose per-op lists differ), the
gradient flows back through the casts to f32, the new extras return to
their own dtype, and the optimizer step, the upload and the aggregate
stay f32. The model's layers promote each (input, weight) pair as flax
does (models/dtypes.py), so uint8 pixels normalised to f32 meet bf16
weights in f32 unless the model sets its own activation ``dtype``. The
default 'f32' makes no cast at all.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import torch
from torch.func import grad, vmap
from torch.utils._pytree import tree_flatten, tree_unflatten

from fedml_tpu_torch.core.optim import ClientOptimizer

METRICS = ("loss_sum", "correct", "count")


class Task(NamedTuple):
    """Model + objective bundle (the reference's concrete ModelTrainer).
    A ``net`` is a dict name -> tensor of params and extras (module
    docstring); every function computes one client's batch (the fit vmaps
    it over the cohort)."""

    # (generator, x_sample=None) -> net, drawn on the CPU, on the model's
    # device; x_sample fixes a lazy module's input width
    init: Callable
    # (params, extra, x, y, mask, key, train) -> (loss, new_extra,
    # metrics); the loss is differentiable in the params; key is one
    # batch key (int64[2]) or None
    loss: Callable
    # (net, x) -> model outputs (eval mode: running statistics, no dropout)
    predict: Callable
    # (net, x, y, mask) -> metrics dict with 'loss_sum','correct','count'
    eval_batch: Callable
    # the nn.Module the functions call (the wire layout reads a
    # TransformerLM's head count from it: convert.num_heads_of)
    module: object = None
    # the net's extras, by name (the module's buffers); () for a model
    # with no state
    extra_keys: tuple = ()
    # the train-mode forward draws randomness: the fit passes batch keys
    needs_key: bool = False


def split_net(net: dict, extra_keys) -> tuple:
    """``(params, extra)`` of a net (stacked or not) by ``extra_keys``."""
    extra = {k: net[k] for k in extra_keys}
    return {k: v for k, v in net.items() if k not in extra}, extra


def refuse_extras(task: Task, owner: str, options: dict | None = None,
                  key: bool = False) -> None:
    """Raise NotImplementedError, naming ROADMAP.md queue A item 4, when
    ``task``'s model carries extras (or, with ``key``, draws randomness)
    and ``owner`` does not carry them yet: always when ``options`` is
    None, else when one of ``options`` (name -> value; None / False =
    unset) is set. Every engine and server carries them but the
    sequence-parallel path: ``FedAvgSeqAPI`` with a keyed model, and
    ``sequence_task(seq_axis=)`` with a stateful one (no sequence model of
    either package has dropout or running statistics yet)."""
    if not (task.extra_keys or (key and task.needs_key)):
        return
    set_ = [k for k, v in (options or {}).items()
            if v is not None and v is not False]
    if options is None or set_:
        what = owner if options is None else f"{owner} option {set_[0]}"
        raise NotImplementedError(
            f"{what} with a model that carries extras (BatchNorm "
            "statistics) or draws randomness is not ported yet: ROADMAP.md "
            "queue A, item 4")


@dataclasses.dataclass(frozen=True)
class LocalSpec:
    """Static configuration of a client's local fit; ``remat`` and
    ``compute_dtype``: see the module docstring."""

    optimizer: ClientOptimizer  # see fedml_tpu_torch.core.optim
    epochs: int = 1
    prox_mu: float = 0.0  # FedProx proximal coefficient (0 = plain FedAvg)
    remat: bool = False
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


def rematerialize(fn: Callable) -> Callable:
    """``fn(params, *rest) -> (loss, aux)`` whose backward recomputes the
    forward (``jax.checkpoint``): only the inputs are kept for the
    backward. ``params`` is a dict of the tensors to differentiate; ``aux``
    a pytree of tensors, not differentiable."""
    aux_spec = []  # the aux treespec, fixed by the first forward

    def flat_fn(n_params, keys, rest_spec, flat):
        params = dict(zip(keys, flat[:n_params]))
        return fn(params, *tree_unflatten(list(flat[n_params:]), rest_spec))

    class _Remat(torch.autograd.Function):
        generate_vmap_rule = True

        @staticmethod
        def forward(n_params, keys, rest_spec, *flat):
            loss, aux = flat_fn(n_params, keys, rest_spec, flat)
            leaves, spec = tree_flatten(aux)
            if not aux_spec:
                aux_spec.append(spec)
            return (loss, *leaves)

        @staticmethod
        def setup_context(ctx, inputs, output):
            ctx.meta = inputs[:3]
            ctx.save_for_backward(*inputs[3:])
            ctx.mark_non_differentiable(*output[1:])

        @staticmethod
        def backward(ctx, g_loss, *_):
            n_params, keys, rest_spec = ctx.meta
            flat = ctx.saved_tensors
            rest = flat[n_params:]
            _, vjp_fn = torch.func.vjp(
                lambda *p: flat_fn(n_params, keys, rest_spec, p + rest)[0],
                *flat[:n_params])
            return (None, None, None, *vjp_fn(g_loss),
                    *(None,) * len(rest))

    def wrapped(params, *rest):
        keys = tuple(params)
        leaves, rest_spec = tree_flatten(rest)
        out = _Remat.apply(len(keys), keys, rest_spec,
                           *params.values(), *leaves)
        return out[0], tree_unflatten(list(out[1:]), aux_spec[0])

    return wrapped


def make_local_step(task: Task, spec: LocalSpec):
    """One client's optimizer step on one batch, a pure function (see the
    module docstring); the FedProx term mu/2 ||w - w_global||^2 over the
    params joins the loss when ``spec.prox_mu > 0``."""
    if spec.compute_dtype not in COMPUTE_DTYPES:
        raise ValueError(f"compute_dtype={spec.compute_dtype!r} (one of "
                         f"{sorted(COMPUTE_DTYPES)})")
    cdt = COMPUTE_DTYPES[spec.compute_dtype]

    def total_loss(params, extra, global_params, x, y, mask, key):
        if cdt is None:
            loss, new_extra, metrics = task.loss(params, extra, x, y, mask,
                                                 key, True)
        else:
            # bf16 compute, f32 masters: the casts sit inside the grad
            # closure, so the gradient lands f32 through them; the loss,
            # the metrics and the new extras come back in their dtypes
            loss, new_extra, metrics = task.loss(
                _cast_floats(params, cdt), _cast_floats(extra, cdt),
                _cast_floats(x, cdt), y, mask, key, True)
            loss = loss.float()
            new_extra = {k: v.to(extra[k].dtype) for k, v in new_extra.items()}
            metrics = _cast_floats(metrics, torch.float32)
        if spec.prox_mu > 0.0:
            sq = sum(torch.sum((p - global_params[k]) ** 2)
                     for k, p in params.items())
            loss = loss + 0.5 * spec.prox_mu * sq
        return loss, (new_extra, metrics)

    grad_fn = grad(rematerialize(total_loss) if spec.remat else total_loss,
                   has_aux=True)

    def step(params, extra, opt_state, global_params, x, y, mask, key):
        grads, (new_extra, metrics) = grad_fn(params, extra, global_params,
                                              x, y, mask, key)
        new_params, new_state = spec.optimizer.update(grads, opt_state, params)
        has_data = mask.sum() > 0  # padded batch: keep params, extras, state
        return (_select(has_data, new_params, params),
                _select(has_data, new_extra, extra),
                _select(has_data, new_state, opt_state), metrics)

    return step


def make_local_update(task: Task, spec: LocalSpec):
    """Build the cohort's local fit (see module docstring). Every client
    starts from ``global_net``; metrics are 'loss_sum', 'correct' and
    'count' SUMMED over each client's real samples and epochs, shape [K],
    so they aggregate across clients by addition."""
    step = vmap(make_local_step(task, spec),
                in_dims=(0, 0, 0, None, 0, 0, 0,
                         0 if task.needs_key else None))
    init_state = vmap(spec.optimizer.init)

    def local_update(global_net: dict, x, y, mask, keys=None):
        if task.needs_key and keys is None:
            raise ValueError("this task's model draws randomness: pass the "
                             "fit's keys (utils/prng.fit_keys)")
        K, B = mask.shape[:2]
        global_params, _ = split_net(global_net, task.extra_keys)
        params, extra = split_net(
            {k: v.detach().expand(K, *v.shape).clone()
             for k, v in global_net.items()}, task.extra_keys)
        opt_state = init_state(params)
        sums = {k: torch.zeros(K, device=mask.device) for k in METRICS}
        for e in range(spec.epochs):
            for b in range(B):
                params, extra, opt_state, metrics = step(
                    params, extra, opt_state, global_params, x[:, b],
                    y[:, b], mask[:, b],
                    None if keys is None else keys[e, b])
                sums = {k: sums[k] + metrics[k] for k in METRICS}
        nets = {**params, **extra}
        return {k: nets[k] for k in global_net}, sums

    return local_update


def make_eval_fn(task: Task):
    """Masked evaluation over a padded global batch set [B, bs, ...] (the
    server's test_on_server_for_all_clients): one host read at the end."""

    @torch.no_grad()
    def eval_fn(net: dict, xb, yb, mb):
        acc = {k: 0.0 for k in METRICS}
        for b in range(xb.shape[0]):
            metrics = task.eval_batch(net, xb[b], yb[b], mb[b])
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
    def eval_fn(net: dict, x, y, mask):
        K = mask.shape[0]
        acc = {k: torch.zeros(K, device=mask.device) for k in METRICS}
        for b in range(mask.shape[1]):
            metrics = batch(net, x[:, b], y[:, b], mask[:, b])
            acc = {k: acc[k] + metrics[k] for k in METRICS}
        return acc

    return eval_fn
