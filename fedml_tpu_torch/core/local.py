"""Local client update + evaluation, port of fedml_tpu/core/local.py.

The JAX package compiles a client's whole fit into one scanned program; here
the same fit runs eagerly:

    local_update(global_state, x[B,bs,...], y[B,bs,...], mask[B,bs])
        -> (new_state, metrics)

epochs x batches of optimizer steps from ``LocalSpec.optimizer``, with the
FedProx term when ``prox_mu > 0``. A state is a dict of parameter tensors
(the model's ``state_dict`` entries); the model runs through
``torch.func.functional_call``, so one module serves every client.

An all-masked (padded) batch is an exact no-op for params and optimizer
state (local.py:193-200 of the reference): the step is skipped, and its
metrics are zero. The models of this slice draw no randomness during the
fit, so the fit takes no RNG.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import torch


class Task(NamedTuple):
    """Model + objective bundle (the reference's concrete ModelTrainer).
    ``params`` below is a dict name -> tensor."""

    init: Callable  # (generator) -> params, drawn on the CPU, on the model's device
    # (params, x, y, mask, train) -> (loss, metrics); loss is differentiable
    loss: Callable
    # (params, x) -> model outputs (eval mode)
    predict: Callable
    # (params, x, y, mask) -> metrics dict with 'loss_sum','correct','count'
    eval_batch: Callable


@dataclasses.dataclass(frozen=True)
class LocalSpec:
    """Static configuration of a client's local fit: float32 compute, no
    rematerialization (the reference's ``remat`` and bf16 ``compute_dtype``
    are queued in ROADMAP.md, queue A items 4 and 7)."""

    # params (list of leaf tensors) -> torch.optim.Optimizer
    optimizer: Callable
    epochs: int = 1
    prox_mu: float = 0.0  # FedProx proximal coefficient (0 = plain FedAvg)


def make_local_update(task: Task, spec: LocalSpec):
    """Build the local-fit function for one client (see module docstring).

    metrics: 'loss_sum', 'correct' and 'count' SUMMED over the client's real
    samples and epochs, so they aggregate across clients by addition."""

    def local_update(global_params: dict, x, y, mask):
        params = {k: v.detach().clone().requires_grad_(True)
                  for k, v in global_params.items()}
        opt = spec.optimizer(list(params.values()))
        has_data = (mask.sum(dim=1) > 0).tolist()  # one host read per fit
        sums = {"loss_sum": 0.0, "correct": 0.0, "count": 0.0}
        for _ in range(spec.epochs):
            for b in range(x.shape[0]):
                if not has_data[b]:
                    continue  # padded batch: exact no-op
                loss, metr = task.loss(params, x[b], y[b], mask[b], True)
                if spec.prox_mu > 0.0:
                    # FedProx: + mu/2 * ||w - w_global||^2
                    sq = sum(torch.sum((p - global_params[k]) ** 2)
                             for k, p in params.items())
                    loss = loss + 0.5 * spec.prox_mu * sq
                opt.zero_grad(set_to_none=True)
                loss.backward()
                opt.step()
                sums = {k: sums[k] + metr[k] for k in sums}
        return {k: v.detach() for k, v in params.items()}, sums

    return local_update


def make_eval_fn(task: Task):
    """Masked evaluation over a padded global batch set [B, bs, ...] (the
    server's test_on_server_for_all_clients)."""

    @torch.no_grad()
    def eval_fn(params: dict, xb, yb, mb):
        acc = {"loss_sum": 0.0, "correct": 0.0, "count": 0.0}
        for b in range(xb.shape[0]):
            metr = task.eval_batch(params, xb[b], yb[b], mb[b])
            acc = {k: acc[k] + metr[k] for k in acc}
        n = max(float(acc["count"]), 1.0)
        return {"loss": float(acc["loss_sum"]) / n,
                "acc": float(acc["correct"]) / n, "count": float(acc["count"])}

    return eval_fn
