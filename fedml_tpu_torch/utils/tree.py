"""State-dict bookkeeping, port of fedml_tpu/utils/tree.py.

The JAX package maps over pytrees; here a model state is a dict of tensors
(a ``state_dict``), and a stacked state holds a leading client axis on
every entry.
"""

from __future__ import annotations

import torch


def tree_weighted_mean(stacked: dict, weights: torch.Tensor) -> dict:
    """Weighted mean over the leading axis of a stacked state dict.

    ``stacked`` entries have shape [K, ...]; ``weights`` has shape [K] and
    is normalized here, so callers pass raw sample counts (the server's
    per-key weighted average, reference FedAVGAggregator.py:72-80)."""
    w = weights / weights.sum().clamp_min(1e-12)
    return {k: torch.tensordot(w.to(x.dtype), x, dims=([0], [0]))
            for k, x in stacked.items()}
