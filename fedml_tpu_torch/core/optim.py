"""Client optimizers as pure functions, the port's counterpart of the optax
transformations that fedml_tpu's ``make_client_optimizer`` chains
(fedml_tpu/algorithms/fedavg.py:296-307).

An optimizer is a pair of functions on ONE client's tensors:

    init(params) -> state
    update(grads, state, params) -> (new_params, new_state)

with params, grads and state dicts of tensors (state may nest). The local
fit runs both under ``torch.func.vmap``, so the cohort's states are stacked
``[K, ...]`` and every client keeps its own (Adam's step count included).
The arithmetic follows optax's: ``add_decayed_weights(wd)`` adds wd * w to
the gradient first; ``sgd`` keeps a momentum trace t = g + momentum * t;
``adam`` has b1 0.9, b2 0.999, eps 1e-8 outside the square root and bias
corrections 1 - b**count.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch


class ClientOptimizer(NamedTuple):
    init: Callable    # params -> state
    update: Callable  # (grads, state, params) -> (new_params, new_state)


def _decay(grads: dict, params: dict, wd: float) -> dict:
    if not wd:
        return grads
    return {k: g + wd * params[k] for k, g in grads.items()}


def sgd(lr: float, momentum: float = 0.0, wd: float = 0.0) -> ClientOptimizer:
    """optax.sgd(lr, momentum or None), after add_decayed_weights(wd)."""

    def init(params):
        if not momentum:
            return {}
        return {"trace": {k: torch.zeros_like(v) for k, v in params.items()}}

    def update(grads, state, params):
        grads = _decay(grads, params, wd)
        if momentum:
            trace = {k: g + momentum * state["trace"][k]
                     for k, g in grads.items()}
            state, grads = {"trace": trace}, trace
        return {k: p - lr * grads[k] for k, p in params.items()}, state

    return ClientOptimizer(init, update)


def adam(lr: float, wd: float = 0.0, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8) -> ClientOptimizer:
    """optax.adam(lr), after add_decayed_weights(wd)."""

    def init(params):
        first = next(iter(params.values()))
        return {"count": torch.zeros((), dtype=torch.int32,
                                     device=first.device),
                "mu": {k: torch.zeros_like(v) for k, v in params.items()},
                "nu": {k: torch.zeros_like(v) for k, v in params.items()}}

    def update(grads, state, params):
        grads = _decay(grads, params, wd)
        count = state["count"] + 1
        mu = {k: (1 - b1) * g + b1 * state["mu"][k] for k, g in grads.items()}
        nu = {k: (1 - b2) * (g * g) + b2 * state["nu"][k]
              for k, g in grads.items()}
        c1, c2 = 1 - b1 ** count, 1 - b2 ** count
        new = {k: p - lr * ((mu[k] / c1) / (torch.sqrt(nu[k] / c2) + eps))
               for k, p in params.items()}
        return new, {"count": count, "mu": mu, "nu": nu}

    return ClientOptimizer(init, update)
