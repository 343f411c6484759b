"""Robust FedAvg — norm clipping + weak-DP noise against poisoning and
backdoors, and accounted DP-FedAvg; port of
fedml_tpu/algorithms/fedavg_robust.py.

Reference: fedml_api/distributed/fedavg_robust/FedAvgRobustAggregator.py
applies fedml_core/robustness/robust_aggregation.py defenses
(--defense_type norm_diff_clipping|weak_dp, --norm_bound, --stddev)
before / after the weighted average, and evaluates backdoor targeted-task
accuracy (:14-80).

Here, as in the JAX package, clipping is the engine's
``client_result_hook`` (vmapped over the stacked cohort, one global norm a
client) and the noise its ``post_aggregate_hook``, keyed by the engine's
key chain: the noise is the JAX package's draw, weight for weight, on the
engine's device (core/robust.py). ``defense_type='dp'`` is DP-FedAvg
(McMahan et al. 2018): clip to C, a UNIFORM average, N(0, (z·C/m)²) on the
m-client mean, and an RDP accountant (core/privacy.py) charged before each
round, so the round record's ``privacy`` block and ``epsilon(delta)``
never under-report. Byzantine-robust aggregation composes through the
inherited ``aggregator=`` / ``sanitize=`` / ``adversary_plan=``.
"""

from __future__ import annotations

import torch

from fedml_tpu_torch.algorithms.fedavg import (
    FedAvgAPI,
    FedAvgConfig,
    float32_compute,
)
from fedml_tpu_torch.core.client_data import batch_global
from fedml_tpu_torch.core.robust import add_gaussian_noise, norm_diff_clipping

DEFENSES = ("norm_diff_clipping", "weak_dp", "dp", "none")


class FedAvgRobustAPI(FedAvgAPI):
    def __init__(self, dataset, task, config: FedAvgConfig, device=None,
                 defense_type: str = "norm_diff_clipping",
                 norm_bound: float = 30.0, stddev: float = 0.025,
                 noise_multiplier: float = 1.0,  # z, for defense_type='dp'
                 poisoned_test: tuple | None = None,  # (x, y_target)
                 **kwargs):
        """``defense_type='dp'``: per-client updates clip to the L2 ball
        ``norm_bound`` (= C), the server adds N(0, (z·C/m)²) to the
        m-client average, and ``self.accountant`` tracks cumulative Rényi
        DP — ``self.epsilon(delta)`` gives the (ε, δ) spent so far."""
        if defense_type not in DEFENSES:
            raise ValueError(f"unknown defense_type {defense_type!r} "
                             f"(one of {DEFENSES})")
        self.defense_type = defense_type
        self.accountant = None
        self._privacy_cache = None
        hooks = {}
        if defense_type in ("norm_diff_clipping", "weak_dp", "dp"):
            def clip_hook(net_k, net_global, key):
                return norm_diff_clipping(net_k, net_global, norm_bound)
            hooks["client_result_hook"] = clip_hook
        if defense_type in ("weak_dp", "dp"):
            if defense_type == "dp":
                from fedml_tpu_torch.core.privacy import DPAccountant

                if noise_multiplier <= 0:
                    raise ValueError("defense_type='dp' needs "
                                     f"noise_multiplier > 0, got "
                                     f"{noise_multiplier}")
                # the accountant charges the Poisson-subsampled-Gaussian
                # bound at q = m/N, which assumes UNIFORM sampling
                if getattr(config, "sampling", "uniform") != "uniform":
                    raise ValueError(
                        "defense_type='dp' requires config.sampling="
                        f"'uniform' (got {config.sampling!r}): the RDP "
                        "accountant's q=m/N subsampling bound does not "
                        "hold for non-uniform client sampling")
                # noise on the AVERAGED update: z * C / m; the C/m
                # sensitivity holds only under a uniform client average
                stddev = (noise_multiplier * norm_bound
                          / config.client_num_per_round)
                kwargs["uniform_avg"] = True
                self.accountant = DPAccountant()
                self._dp_q = (config.client_num_per_round
                              / config.client_num_in_total)
                self._dp_z = noise_multiplier
                self._dp_C = norm_bound

            def noise_hook(net, key):
                return add_gaussian_noise(key, net, stddev)
            hooks["post_aggregate_hook"] = noise_hook

        super().__init__(dataset, task, config, device=device, **hooks,
                         **kwargs)
        self._poisoned = None
        if poisoned_test is not None:
            px, py = poisoned_test
            self._poisoned = tuple(
                torch.from_numpy(a).to(self.device)
                for a in batch_global(px, py, config.eval_batch_size))

    def _charge(self) -> None:
        """Step the accountant one round and refresh the privacy ledger
        surfaces (the round record's block and the live ε gauge)."""
        from fedml_tpu_torch.core.privacy import charge_and_record

        self._privacy_cache = charge_and_record(
            self.accountant, self._dp_q, self._dp_z, self._dp_C,
            realized_m=self.cfg.client_num_per_round)

    def _privacy_extra(self) -> dict:
        return ({"privacy": dict(self._privacy_cache)}
                if self._privacy_cache is not None else {})

    def _dispatch_round(self, round_idx: int, ids, batch):
        # charge BEFORE the dispatch: the round's record must carry the ε
        # that INCLUDES this round's spend (a budget ledger may over-report
        # mid-flight, never under-report). run_round, run_rounds and the
        # pipelined driver all dispatch here, so every round charges once.
        if self.accountant is not None:
            self._charge()
        return super()._dispatch_round(round_idx, ids, batch)

    def epsilon(self, delta: float = 1e-5) -> float:
        """Cumulative (ε, δ)-DP spent by the rounds run so far."""
        if self.accountant is None:
            raise ValueError("defense_type='dp' required for accounting")
        return self.accountant.epsilon(delta)

    def evaluate_backdoor(self):
        """Targeted-task accuracy on the poisoned set: the fraction of
        poisoned inputs classified as the attacker's target label (the
        reference's backdoor test loop, FedAvgRobustAggregator.py:14-80)."""
        if self._poisoned is None:
            raise ValueError("no poisoned_test set provided")
        with float32_compute():
            return self.eval_fn(self.net, *self._poisoned)
