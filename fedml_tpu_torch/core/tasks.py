"""Task builders, port of fedml_tpu/core/tasks.py — ``sequence_task``.

``classification_task`` (uint8 pixels normalized on device, masked
cross-entropy) comes with the CNN slice (ROADMAP.md queue A, item 3).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.func import functional_call

from fedml_tpu_torch.core.local import Task


def sequence_task(module, pad_id: int = 0,
                  seq_axis: str | None = None) -> Task:
    """Next-token prediction: ``module`` maps tokens [bs, T] -> logits
    [bs, T, V]; y [bs, T] holds the targets. Tokens equal to ``pad_id`` are
    masked out of loss and accuracy (the reference masks PAD in nwp,
    my_model_trainer_nwp.py), and so are padded samples (mask [bs] = 0).
    Metrics: 'loss_sum', 'correct' and 'count' over the unmasked tokens."""
    if seq_axis is not None:
        raise NotImplementedError("sequence-parallel tasks (seq_axis) are "
                                  "not ported yet: ROADMAP.md queue A, "
                                  "item 11")

    def init(generator: torch.Generator):
        module.reset_parameters(generator)
        return {k: v.detach().clone() for k, v in module.named_parameters()}

    def _metrics(params, x, y, mask):
        logits = functional_call(module, params, (x,))
        per_tok = F.cross_entropy(logits.flatten(0, 1), y.flatten(),
                                  reduction="none").view_as(y)
        tm = (y != pad_id).to(per_tok.dtype) * mask[:, None]
        correct = ((logits.argmax(-1) == y) * tm).sum()
        return (per_tok * tm).sum(), correct.detach(), tm.sum()

    def loss(params, x, y, mask, train):
        loss_sum, correct, count = _metrics(params, x, y, mask)
        metrics = {"loss_sum": loss_sum.detach(), "correct": correct,
                   "count": count}
        return loss_sum / count.clamp_min(1.0), metrics

    def predict(params, x):
        return functional_call(module, params, (x,))

    def eval_batch(params, x, y, mask):
        loss_sum, correct, count = _metrics(params, x, y, mask)
        return {"loss_sum": loss_sum, "correct": correct, "count": count}

    return Task(init, loss, predict, eval_batch)
