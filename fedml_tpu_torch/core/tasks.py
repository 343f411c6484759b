"""Task builders, port of fedml_tpu/core/tasks.py: ``classification_task``
and ``sequence_task`` wrap a torch module into the (init, loss, predict,
eval_batch) bundle that core.local consumes.

Conventions: x [bs, ...]; y [bs] integer labels (classification) or [bs, T]
tokens (sequence); mask [bs] sample validity. Each function computes one
client's batch, so the local fit runs it under ``torch.func.vmap`` over the
cohort; params are a dict name -> tensor, run through ``functional_call``.

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
    parameter from ``generator``."""
    if any(nn.parameter.is_lazy(p) for p in module.parameters()):
        if x_sample is None:
            raise ValueError(f"{type(module).__name__} has lazy parameters: "
                             "pass a sample batch to init")
        dev = next(module.parameters()).device
        with torch.no_grad():
            module(_as_float_image(torch.as_tensor(x_sample[:1]).to(dev)))
    module.reset_parameters(generator)
    return {k: v.detach().clone() for k, v in module.named_parameters()}


def _module_caller(module):
    """``(init, call)`` on ``module`` under one lock (see the module
    docstring): ``call(params, x)`` is ``functional_call``."""
    lock = threading.Lock()

    def init(generator: torch.Generator, x_sample=None):
        with lock:
            return _init_params(module, generator, x_sample)

    def call(params, x):
        with lock:
            return functional_call(module, params, (x,))

    return init, call


def classification_task(module) -> Task:
    """Softmax cross-entropy over integer labels, masked per sample:
    loss = sum(per_ex * mask) / max(sum(mask), 1); metrics 'loss_sum',
    'correct' and 'count' over the unmasked samples."""
    init, call = _module_caller(module)

    def _metrics(params, x, y, mask):
        logits = call(params, _as_float_image(x))
        per_ex = F.cross_entropy(logits, y, reduction="none")
        correct = ((logits.argmax(-1) == y) * mask).sum()
        return (per_ex * mask).sum(), correct.detach(), mask.sum()

    def loss(params, x, y, mask, train):
        loss_sum, correct, count = _metrics(params, x, y, mask)
        metrics = {"loss_sum": loss_sum.detach(), "correct": correct,
                   "count": count}
        return loss_sum / count.clamp_min(1.0), metrics

    def predict(params, x):
        return call(params, _as_float_image(x))

    def eval_batch(params, x, y, mask):
        loss_sum, correct, count = _metrics(params, x, y, mask)
        return {"loss_sum": loss_sum, "correct": correct, "count": count}

    return Task(init, loss, predict, eval_batch, module)


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

    def _metrics(params, x, y, mask):
        logits = call(params, x)
        per_tok = F.cross_entropy(logits.flatten(0, 1), y.flatten(),
                                  reduction="none").view_as(y)
        tm = (y != pad_id).to(per_tok.dtype) * mask[:, None]
        correct = ((logits.argmax(-1) == y) * tm).sum()
        return (per_tok * tm).sum(), correct.detach(), tm.sum()

    def _seq_metrics(params, x, y, mask):
        sums = torch.stack(_metrics(seq_invariant(params, seq_axis), x, y,
                                    mask))
        return psum(sums, seq_axis).unbind(0)

    def loss(params, x, y, mask, train):
        if seq_axis is None:
            loss_sum, correct, count = _metrics(params, x, y, mask)
        else:
            loss_sum, correct, count = _seq_metrics(params, x, y, mask)
            correct, count = correct.detach(), count.detach()
        metrics = {"loss_sum": loss_sum.detach(), "correct": correct,
                   "count": count}
        return loss_sum / count.clamp_min(1.0), metrics

    def predict(params, x):
        return call(params, x)

    def eval_batch(params, x, y, mask):
        loss_sum, correct, count = _metrics(params, x, y, mask)
        return {"loss_sum": loss_sum, "correct": correct, "count": count}

    return Task(init, loss, predict, eval_batch, module)
