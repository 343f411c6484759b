"""TurboAggregate — pairwise-masked secure aggregation on one device, port
of fedml_tpu/algorithms/turboaggregate.py.

Reference: fedml_api/distributed/turboaggregate/ (Lagrange-coded MPC over a
finite field). As in the JAX package, the engine shares its whole masking
layer with the cross-process tier (core/secure_agg.py): each simulated
client's weighted params vector (``utils.tree.tree_vectorize``: the JAX
package's coordinate order) is quantized into GF(2^31-1) and masked with
its cancelling pairwise masks plus a Shamir-shared self-mask, the masked
vectors are folded mod p, the self-mask seeds are reconstructed from t+1
shares, and only the SUM is decoded. Additive homomorphism makes the
result plain FedAvg up to quantization; no per-client cleartext update
exists on the aggregation path.

The cohort fits once, batched (``local_update`` gives the nets stacked
``[K, ...]``), and each slot is masked, folded, unmasked and decoded on the
engine's device. The key chain is the reference's own, not the main
engine's ``client_keys``: one split a round (``self.rng, rk =
split(self.rng)``), and slot ``k``'s fit is keyed by ``split(rk, K)[k]``,
split per epoch and batch (utils/prng ``fit_keys``), so a dropout model's
masks are flax's. The full-cohort protocol only: a simulated cohort cannot
drop mid-round; dropout recovery lives on the cross-process tier
(distributed/turboaggregate.py).

Only the params go through the masked field (``params_vectorize``, the
JAX package's ``tree_vectorize(net.params)``). A model's extras
(BatchNorm statistics) are not secret: they take the plain weighted mean
with the float32 sample counts, as the reference averages them.
"""

from __future__ import annotations

import numpy as np
import torch

from fedml_tpu_torch.algorithms.fedavg import (
    FedAvgAPI,
    FedAvgConfig,
    float32_compute,
)
from fedml_tpu_torch.convert import num_heads_of
from fedml_tpu_torch.core import secure_agg as sa
from fedml_tpu_torch.utils import prng
from fedml_tpu_torch.utils.tree import (
    params_unvectorize,
    params_vectorize,
    tree_weighted_mean,
)


class TurboAggregateAPI(FedAvgAPI):
    """FedAvg whose aggregation goes through masked field vectors: the
    engine's weighted mean is replaced by a secure sum."""

    def __init__(self, dataset, task, config: FedAvgConfig,
                 threshold_t: int | None = None,
                 quant_scale: float = 2**16,
                 secagg_max_abs: float = 4.0, device=None, **kwargs):
        if config.client_num_per_round > 32:
            raise ValueError("TurboAggregate secure path is for cross-silo "
                             "scale")
        # threshold_t=None adapts to the cohort (min(2, K-1)); an explicit
        # out-of-range t stays a loud error
        if threshold_t is None:
            threshold_t = sa.default_threshold_t(config.client_num_per_round)
        self.quant_scale = quant_scale
        # capacity guard at construction (collectives/finite_field.py)
        self.secagg = sa.SecAggConfig(
            cohort=config.client_num_per_round, threshold_t=threshold_t,
            quant_scale=quant_scale, max_abs=secagg_max_abs)
        super().__init__(dataset, task, config, device=device, **kwargs)
        self.num_heads = num_heads_of(task.module)

    def _dispatch_round(self, round_idx: int, ids, batch) -> dict:
        """One masked round on the device batch: the batched fit, then per
        slot mask + fold, the self-seeds from the full cohort's shares, one
        unmask and one decode. The masking lives at the dispatch, which
        run_round, run_rounds and the pipelined drivers all call, so no
        driver can reach the plain weighted mean. Returns the summed
        metrics (device tensors)."""
        x, y, mask, nsamp = batch
        with self.tracer.span("round"):
            # the reference's chain: rk split K ways keys the fits
            self.rng, rk = prng.split(self.rng)
            K = int(x.shape[0])
            with float32_compute():
                nets, metrics = self.local_update(
                    self.net, x, y, mask, self._slot_keys(rk, K,
                                                          x.shape[1]))
            n = nsamp.to(torch.float64).cpu().numpy()
            wts = n / max(n.sum(), 1e-12)
            extra_keys = self.task.extra_keys
            vecs = params_vectorize(nets, extra_keys, self.num_heads,
                                    stacked=True)
            cfg, seed = self.secagg, self.cfg.seed
            acc = None
            for k in range(K):
                acc = sa.fold_masked_device(acc, sa.mask_update_tensor(
                    vecs[k], float(wts[k]), k, seed, round_idx, cfg), cfg.p,
                    device=self.device)
            # full cohort: every self-mask seed from the t+1-of-K shares;
            # no pairwise mask survives the full sum
            slots = list(range(K))
            self_seeds = {
                i: sa.recover_self_seed(
                    slots, sa.self_mask_shares(seed, round_idx, i,
                                               cfg)[slots],
                    cfg.threshold_t, cfg.p)
                for i in slots}
            vec_sum = sa.unmask_sum(acc, slots, [], self_seeds, {}, cfg)
            new_net = params_unvectorize(vec_sum.to(torch.float32),
                                         self.net, extra_keys,
                                         self.num_heads)
            if extra_keys:
                # the extras are not secret: the plain weighted mean with
                # the float32 sample counts
                new_net.update(tree_weighted_mean(
                    {k: nets[k] for k in extra_keys},
                    nsamp.to(torch.float32)))
            self.net = new_net
            metrics = {k: v.sum() for k, v in metrics.items()}
        return metrics

    def _slot_keys(self, rk, K: int, B: int):
        """The fits' per-batch keys ``[E, B, K, 2]`` on the device, slot
        ``k`` keyed by ``split(rk, K)[k]`` (the reference's chain); None for
        a task that draws no randomness."""
        if not self.task.needs_key:
            return None
        keys = prng.fit_keys(prng.split(rk, K), self.local_spec.epochs, B)
        return torch.from_numpy(keys.astype(np.int64)).to(self.device)
