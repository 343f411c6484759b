"""Non-IID data partitioning, port of fedml_tpu/core/partition.py (host-side
numpy; bitwise equal to the reference, held by tests/test_torch_data_plane.py).

- latent-Dirichlet partition with a min-size retry loop
  (fedml_core/non_iid_partition/noniid_partition.py:6-73 and the CIFAR variant
  fedml_api/data_preprocessing/cifar10/data_loader.py:172-196)
- uniform ("homo") partition (cifar10/data_loader.py:144-148)
- per-client class histogram logging (noniid_partition.py:94-103)

The client->index map is packed per round by
fedml_tpu_torch.core.client_data.
"""

from __future__ import annotations

import numpy as np


def homo_partition(n_samples: int, n_clients: int, seed: int = 0) -> dict[int, np.ndarray]:
    """Uniform IID split: shuffle then equal chunks."""
    rng = np.random.RandomState(seed)
    idxs = rng.permutation(n_samples)
    return {i: np.sort(chunk) for i, chunk in enumerate(np.array_split(idxs, n_clients))}


def dirichlet_partition(
    labels: np.ndarray,
    n_clients: int,
    alpha: float,
    seed: int = 0,
    min_size_floor: int = 10,
) -> dict[int, np.ndarray]:
    """LDA partition: for each class, split its indices among clients by a
    Dirichlet(alpha) draw, retrying until every client has >= min_size_floor
    samples (the reference's `while min_size < 10` loop,
    noniid_partition.py:24-49). Balance correction: a client already holding
    more than n/n_clients samples gets probability 0 for the current class
    (noniid_partition.py:39 / cifar10/data_loader.py:184).
    """
    rng = np.random.RandomState(seed)
    labels = np.asarray(labels).ravel()
    n = labels.shape[0]
    classes = np.unique(labels)
    min_size = 0
    attempts = 0
    while min_size < min_size_floor:
        attempts += 1
        if attempts > 1000:
            # unreachable floor (e.g. n_clients > n_samples): fail loudly
            # instead of the reference's unbounded `while min_size < 10` spin
            raise ValueError(
                f"dirichlet_partition: cannot give {n_clients} clients >= "
                f"{min_size_floor} of {n} samples (alpha={alpha})")
        idx_batch: list[list[int]] = [[] for _ in range(n_clients)]
        for c in classes:
            idx_c = np.where(labels == c)[0]
            rng.shuffle(idx_c)
            props = rng.dirichlet(np.repeat(alpha, n_clients))
            props = np.array(
                [p * (len(b) < n / n_clients) for p, b in zip(props, idx_batch)]
            )
            if props.sum() <= 0:  # every client exactly at capacity
                props = np.full(n_clients, 1.0 / n_clients)
            props = props / props.sum()
            cuts = (np.cumsum(props) * len(idx_c)).astype(int)[:-1]
            for i, part in enumerate(np.split(idx_c, cuts)):
                idx_batch[i].extend(part.tolist())
        min_size = min(len(b) for b in idx_batch)
    out = {}
    for i in range(n_clients):
        rng.shuffle(idx_batch[i])
        out[i] = np.asarray(idx_batch[i], dtype=np.int64)
    return out


def dirichlet_partition_balanced(
    labels: np.ndarray,
    n_clients: int,
    alpha: float = 0.5,
    seed: int = 0,
) -> dict[int, np.ndarray]:
    """Size-balanced LDA — the reference's partition_data_equally stop rule
    (cifar10/data_loader.py:211-321): the shared LDA loop retried until min
    client size >= 0.5*N/n instead of the default absolute floor of 10.
    Label heterogeneity of LDA, near-equal client sizes."""
    n = len(np.asarray(labels).ravel())
    floor = max(1, int(0.5 * n / n_clients))
    return dirichlet_partition(labels, n_clients, alpha, seed,
                               min_size_floor=floor)


# the canonical frozen partition's seed — 'hetero-fix' must give the SAME
# map on every run regardless of --seed (the reference freezes it as a
# checked-in net_dataidx_map.txt, cifar10/data_loader.py:325-330)
_HETERO_FIX_SEED = 2021


def read_net_dataidx_map(path: str) -> dict[int, np.ndarray]:
    """Parse the reference's checked-in fixed-partition txt format
    (read_net_dataidx_map, cifar10/data_loader.py:35-47): lines of
    '<client>: [' opening a client, then comma-separated indices."""
    out: dict[int, list[int]] = {}
    key = None
    with open(path) as f:
        for line in f:
            s = line.strip()
            if not s or s[0] in "{}]":
                continue
            head, _, tail = s.partition(":")
            if tail.strip() == "[":
                key = int(head)
                out[key] = []
            else:
                if key is None:
                    raise ValueError(f"malformed dataidx map {path!r}: "
                                     f"indices before any client header")
                out[key].extend(int(t) for t in s.replace("]", "").split(",") if t.strip())
    return {k: np.asarray(v, dtype=np.int64) for k, v in out.items()}


def partition_data(
    labels: np.ndarray,
    n_clients: int,
    method: str = "hetero",
    alpha: float = 0.5,
    seed: int = 0,
    fix_path: str | None = None,
) -> dict[int, np.ndarray]:
    """Dispatch matching the reference's partition_data
    (cifar10/data_loader.py:140-209): 'homo' | 'hetero' (LDA) |
    'hetero-bal' (size-balanced LDA, partition_data_equally) |
    'hetero-fix' (frozen map: from ``fix_path`` if given — the reference's
    checked-in net_dataidx_map.txt — else LDA with a fixed canonical seed,
    identical on every run regardless of ``seed``)."""
    if fix_path is not None and method != "hetero-fix":
        raise ValueError(
            f"fix_path given but partition method is {method!r}; a frozen "
            "map only applies with method='hetero-fix' (refusing to silently "
            "train on a different partition)")
    if method == "homo":
        return homo_partition(len(labels), n_clients, seed)
    if method in ("hetero", "noniid", "lda"):
        return dirichlet_partition(labels, n_clients, alpha, seed)
    if method in ("hetero-bal", "hetero-equal"):
        return dirichlet_partition_balanced(labels, n_clients, alpha, seed)
    if method == "hetero-fix":
        if fix_path is not None:
            m = read_net_dataidx_map(fix_path)
            n = len(np.asarray(labels).ravel())
            hi = max((int(v.max()) for v in m.values() if len(v)), default=-1)
            if hi >= n:
                raise ValueError(
                    f"{fix_path!r}: index {hi} out of range for {n} samples")
            if set(m) != set(range(n_clients)):
                raise ValueError(
                    f"{fix_path!r} holds clients {sorted(m)[:5]}..., expected "
                    f"exactly 0..{n_clients - 1} (samplers index contiguously)")
            return m
        return dirichlet_partition(labels, n_clients, alpha, _HETERO_FIX_SEED)
    raise ValueError(f"unknown partition method: {method}")


def record_data_stats(labels: np.ndarray, net_dataidx_map: dict[int, np.ndarray]):
    """Per-client class histograms (noniid_partition.py:94-103)."""
    labels = np.asarray(labels).ravel()
    stats = {}
    for cid, idxs in net_dataidx_map.items():
        vals, counts = np.unique(labels[idxs], return_counts=True)
        stats[cid] = {int(v): int(c) for v, c in zip(vals, counts)}
    return stats
