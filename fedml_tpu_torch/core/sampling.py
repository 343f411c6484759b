"""Per-round client sampling, port of fedml_tpu/core/sampling.py (host-side
numpy; bitwise equal to the reference).

Reference semantics (FedAVGAggregator.client_sampling): a deterministic
per-round subset, uniform without replacement, numpy seeded by
(seed, round); full participation when every client is drawn. An active
churn trace (chaos/churn.py) restricts the draw to the round's available
clients (``sample_available``), so the cohort shrinks with the curve.
"""

from __future__ import annotations

import numpy as np


def sample_clients(
    round_idx: int,
    client_num_in_total: int,
    client_num_per_round: int,
    seed: int = 0,
    p=None,
) -> np.ndarray:
    """Host-side deterministic sampler (numpy RandomState(seed + round));
    ``p`` optionally weights the draw."""
    if client_num_in_total == client_num_per_round:
        return np.arange(client_num_in_total, dtype=np.int64)
    rng = np.random.RandomState(seed * 1_000_003 + round_idx)
    return np.sort(
        rng.choice(client_num_in_total, client_num_per_round, replace=False,
                   p=p)
    ).astype(np.int64)


def sample_clients_weighted(
    round_idx: int,
    client_sizes,
    client_num_per_round: int,
    seed: int = 0,
) -> np.ndarray:
    """Size-weighted sampler (P(client k) ∝ n_k, without replacement),
    paired with a uniform aggregate (FedAvgConfig.sampling='size_weighted').
    Zero-size clients get a vanishing probability; all-zero sizes fall
    back to uniform."""
    sizes = np.asarray(client_sizes, np.float64)
    return sample_clients(round_idx, len(sizes), client_num_per_round, seed,
                          p=_size_probs(sizes))


def _size_probs(sizes: np.ndarray):
    """The size_weighted probability vector (None = uniform fallback)."""
    if not np.any(sizes > 0):
        return None
    floor = sizes[sizes > 0].min() * 1e-9
    p = np.maximum(sizes, floor)
    return p / p.sum()


def sample_available(cfg, round_idx: int, trace, client_sizes=None
                     ) -> np.ndarray:
    """Churn-aware per-round draw: restrict the population to the trace's
    scheduled-available cohort for this round's window, then run the SAME
    seeded RandomState stream over the restricted index space. Returns
    ``min(client_num_per_round, available)`` sorted ids — under a diurnal
    trough the cohort legitimately shrinks; the trace's min-one floor
    keeps it nonempty. Deterministic: availability draws live on
    ChurnTrace's sha256 stream, the subset draw on sample_clients' numpy
    stream, so churn composes with chaos/adversary plans without draw
    coupling."""
    avail = trace.available_clients(trace.window(round_idx),
                                    cfg.client_num_in_total)
    n = min(cfg.client_num_per_round, len(avail))
    if n == len(avail):
        return avail
    p = None
    if cfg.sampling == "size_weighted":
        if client_sizes is None:
            raise ValueError("size_weighted sampling needs the per-client "
                             "sizes — pass prepare_sampling(cfg, data)")
        p = _size_probs(np.asarray(client_sizes, np.float64)[avail])
    idx = sample_clients(round_idx, len(avail), n, cfg.seed, p=p)
    return np.sort(avail[idx]).astype(np.int64)


def prepare_sampling(cfg, data) -> np.ndarray | None:
    """Construction-time half of the sampling dispatch: validate
    ``cfg.sampling`` and precompute per-client sizes for size_weighted."""
    if cfg.sampling == "size_weighted":
        if hasattr(data, "client_sizes"):
            # streamed ClientDataSource: sizes are metadata, no payload read
            return np.asarray(data.client_sizes)[: cfg.client_num_in_total]
        return np.asarray([len(data.train_idx_map[c])
                           for c in range(cfg.client_num_in_total)])
    if cfg.sampling != "uniform":
        raise ValueError(f"unknown sampling {cfg.sampling!r} "
                         "(uniform | size_weighted)")
    return None


def sample_for(cfg, round_idx: int, client_sizes=None) -> np.ndarray:
    """Per-round half of the dispatch (uniform | size_weighted); an active
    ``cfg.churn_trace`` restricts every draw to the trace's
    scheduled-available cohort for the round's window."""
    if cfg.sampling not in ("uniform", "size_weighted"):
        raise ValueError(f"unknown sampling {cfg.sampling!r} "
                         "(uniform | size_weighted)")
    trace = getattr(cfg, "churn_trace", None)
    if trace is not None:
        return sample_available(cfg, round_idx, trace, client_sizes)
    if cfg.sampling == "size_weighted":
        if client_sizes is None:
            raise ValueError("size_weighted sampling needs the per-client "
                             "sizes — pass prepare_sampling(cfg, data)")
        return sample_clients_weighted(
            round_idx, client_sizes, cfg.client_num_per_round, cfg.seed)
    return sample_clients(round_idx, cfg.client_num_in_total,
                          cfg.client_num_per_round, cfg.seed)
