"""Task builders, port of fedml_tpu/core/tasks.py: ``classification_task``
and ``sequence_task`` wrap a torch module into the (init, loss, predict,
eval_batch) bundle that core.local consumes.

Conventions: x [bs, ...]; y [bs] integer labels (classification) or [bs, T]
tokens (sequence); mask [bs] sample validity. Each function computes one
client's batch, so the local fit runs it under ``torch.func.vmap`` over the
cohort; a net is a dict name -> tensor of the module's params and buffers
(its extras, ``Task.extra_keys``), run through ``functional_call``.

A stateful model (``stateful_forward``: the ResNets, CNNDropOut) takes
``forward(x, train, key, stats)``, as a flax module takes ``train`` and
its ``dropout`` rng: in train mode its BatchNorms write their new running
statistics into ``stats`` (the reference's ``mutable=['batch_stats']``),
which the loss returns as the new extras, and ``key`` (one batch key)
keys its dropout (``Task.needs_key``). Eval mode reads the running
statistics and draws nothing. Other models take ``forward(x)``.

``functional_call`` swaps the params into the module's attributes for the
forward and back after it, so two threads calling one module at once would
each run with the other's weights. The cross-process runtime runs its
ranks as threads over one task, so a task holds a lock around its module's
calls (only the forward: the backward reads the autograd graph).
"""

from __future__ import annotations

import threading

import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call

from fedml_tpu_torch.collectives.ops import psum, seq_invariant
from fedml_tpu_torch.core.local import Task


def _as_float_image(x):
    """Integer pixel blocks (the uint8 transfer path, see
    fedml_tpu_torch/data/registry.py ``uint8_pixels``) become f32/255 on the
    device; float inputs pass through unchanged."""
    if torch.is_floating_point(x):
        return x
    return x.to(torch.float32) / 255.0


def _init_params(module, generator, x_sample):
    """Materialize a lazy module on ``x_sample`` (LogisticRegression takes
    its input width from the first batch, as flax does), then redraw every
    parameter from ``generator`` and reset the buffers. The net: params,
    then buffers."""
    if any(nn.parameter.is_lazy(p) for p in module.parameters()):
        if x_sample is None:
            raise ValueError(f"{type(module).__name__} has lazy parameters: "
                             "pass a sample batch to init")
        dev = next(module.parameters()).device
        with torch.no_grad():
            module(_as_float_image(torch.as_tensor(x_sample[:1]).to(dev)))
    module.reset_parameters(generator)
    named = [*module.named_parameters(), *module.named_buffers()]
    return {k: v.detach().clone() for k, v in named}


def _module_caller(module):
    """``(init, call)`` on ``module`` under one lock (see the module
    docstring): ``call(net, x, train=False, key=None)`` is
    ``functional_call``, returning ``(outputs, new extras)`` (the latter
    {} but in a stateful model's train mode)."""
    lock = threading.Lock()
    stateful = getattr(module, "stateful_forward", False)

    def init(generator: torch.Generator, x_sample=None):
        with lock:
            return _init_params(module, generator, x_sample)

    def call(net, x, train: bool = False, key=None):
        with lock:
            if not stateful:
                return functional_call(module, net, (x,)), {}
            stats: dict = {}
            out = functional_call(module, net, (x,), {
                "train": train, "key": key, "stats": stats})
            return out, stats

    return init, call


def _task(module, init, loss, predict, eval_batch) -> Task:
    return Task(init, loss, predict, eval_batch, module,
                extra_keys=tuple(k for k, _ in module.named_buffers()),
                needs_key=bool(getattr(module, "needs_key", False)))


def _updated(extra: dict, new: dict) -> dict:
    """The extras after a forward: ``new`` entries replace ``extra``'s."""
    return {k: new.get(k, v) for k, v in extra.items()}


def classification_task(module) -> Task:
    """Softmax cross-entropy over integer labels, masked per sample:
    loss = sum(per_ex * mask) / max(sum(mask), 1); metrics 'loss_sum',
    'correct' and 'count' over the unmasked samples."""
    init, call = _module_caller(module)

    def _metrics(net, x, y, mask, train=False, key=None):
        logits, new = call(net, _as_float_image(x), train, key)
        per_ex = F.cross_entropy(logits, y, reduction="none")
        correct = ((logits.argmax(-1) == y) * mask).sum()
        return (per_ex * mask).sum(), correct.detach(), mask.sum(), new

    def loss(params, extra, x, y, mask, key, train):
        loss_sum, correct, count, new = _metrics({**params, **extra}, x, y,
                                                 mask, train, key)
        metrics = {"loss_sum": loss_sum.detach(), "correct": correct,
                   "count": count}
        return loss_sum / count.clamp_min(1.0), _updated(extra, new), metrics

    def predict(net, x):
        return call(net, _as_float_image(x))[0]

    def eval_batch(net, x, y, mask):
        loss_sum, correct, count, _ = _metrics(net, x, y, mask)
        return {"loss_sum": loss_sum, "correct": correct, "count": count}

    return _task(module, init, loss, predict, eval_batch)


def sequence_task(module, pad_id: int = 0, seq_axis=None) -> Task:
    """Next-token prediction: ``module`` maps tokens [bs, T] -> logits
    [bs, T, V]; y [bs, T] holds the targets. Tokens equal to ``pad_id`` are
    masked out of loss and accuracy (the reference masks PAD in nwp,
    my_model_trainer_nwp.py), and so are padded samples (mask [bs] = 0).
    Metrics: 'loss_sum', 'correct' and 'count' over the unmasked tokens.

    ``seq_axis`` (a mesh axis handle, fedml_tpu_torch.mesh): the
    sequence-parallel mode. x / y carry this rank's sequence slice and the
    module runs sequence-parallel attention over the axis, so the loss's
    token count and the three metric sums are psum-ed over it (one
    exchange): every rank then holds the same GLOBAL loss and metrics. The
    params enter the module through ``seq_invariant``, whose backward sums
    the gradient over the axis, as ``shard_map``'s transpose does for the
    reference's seq-invariant params: the gradient on every rank is the
    full-sequence gradient. ``eval_batch`` stays axis-free (the engine
    evaluates on the plain twin)."""
    init, call = _module_caller(module)

    def _metrics(net, x, y, mask, train=False, key=None):
        logits, new = call(net, x, train, key)
        per_tok = F.cross_entropy(logits.flatten(0, 1), y.flatten(),
                                  reduction="none").view_as(y)
        # the token mask in float32 whatever the logits' dtype (the
        # reference's, core/tasks.py:122): under bf16 compute the count stays
        # exact and loss_sum sums bf16 per-token losses in float32
        tm = (y != pad_id).float() * mask[:, None].float()
        correct = ((logits.argmax(-1) == y) * tm).sum()
        return (per_tok * tm).sum(), correct.detach(), tm.sum(), new

    def _seq_metrics(params, x, y, mask):
        sums = torch.stack(_metrics(seq_invariant(params, seq_axis), x, y,
                                    mask)[:3])
        return psum(sums, seq_axis).unbind(0)

    def loss(params, extra, x, y, mask, key, train):
        new = {}
        if seq_axis is None:
            loss_sum, correct, count, new = _metrics({**params, **extra}, x,
                                                     y, mask, train, key)
        else:
            loss_sum, correct, count = _seq_metrics(params, x, y, mask)
            correct, count = correct.detach(), count.detach()
        metrics = {"loss_sum": loss_sum.detach(), "correct": correct,
                   "count": count}
        return loss_sum / count.clamp_min(1.0), _updated(extra, new), metrics

    def predict(net, x):
        return call(net, x)[0]

    def eval_batch(net, x, y, mask):
        loss_sum, correct, count, _ = _metrics(net, x, y, mask)
        return {"loss_sum": loss_sum, "correct": correct, "count": count}

    task = _task(module, init, loss, predict, eval_batch)
    if seq_axis is not None and (task.extra_keys or task.needs_key):
        raise NotImplementedError(
            "the sequence-parallel sequence_task of a model with extras or "
            "randomness is not ported yet: ROADMAP.md queue A, item 4")
    return task
