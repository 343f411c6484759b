"""Fixed-shape packing of ragged per-client data, port of
fedml_tpu/core/client_data.py (host-side numpy; bitwise equal to the
reference, held by tests/test_torch_host_plane.py).

A round's sampled clients are packed into one dense block:

  x    [K, B, bs, ...]   K clients, B batches each, bs samples per batch
  y    [K, B, bs, ...]
  mask [K, B, bs]        1.0 for real samples, 0.0 for padding

Padded batches carry mask 0 and are exact no-ops of the local fit; true
sample counts ride along for exact sample-weighted aggregation. The C++
packer (fedml_tpu_torch/native) and the numpy loop give the same bytes.

The device-resident plane ships an ``IndexBatch`` instead: the same
shuffled rows as indices into a train set parked on the card once.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np


@dataclasses.dataclass
class ClientBatch:
    """One round's packed client data. Arrays have leading dim K."""

    x: Any          # [K, B, bs, ...]
    y: Any          # [K, B, bs, ...]
    mask: Any       # [K, B, bs] float32
    num_samples: Any  # [K] float32 — true (unpadded) counts

    @property
    def num_batches(self) -> int:
        return self.x.shape[1]


@dataclasses.dataclass
class FederatedData:
    """Host-side federated dataset: global arrays + the client index map
    (the reference's 8-tuple loader contract in one structure)."""

    train_x: np.ndarray
    train_y: np.ndarray
    test_x: np.ndarray
    test_y: np.ndarray
    train_idx_map: dict[int, np.ndarray]   # client -> indices into train_*
    test_idx_map: dict[int, np.ndarray] | None
    class_num: int

    @property
    def num_clients(self) -> int:
        return len(self.train_idx_map)

    @property
    def train_data_local_num_dict(self) -> dict[int, int]:
        return {c: len(ix) for c, ix in self.train_idx_map.items()}


def subset_clients(data: FederatedData, client_ids) -> FederatedData:
    """A view holding ONLY the given clients' train rows (the reference's
    per-rank ``load_partition_data_distributed_<ds>`` loaders). Client ids
    keep their global numbering; a client outside the subset raises
    KeyError. The global test set is kept whole."""
    client_ids = [int(c) for c in client_ids]
    rows = [np.asarray(data.train_idx_map[c], np.int64) for c in client_ids]
    flat = np.concatenate(rows) if rows else np.zeros((0,), np.int64)
    new_map: dict[int, np.ndarray] = {}
    off = 0
    for c, r in zip(client_ids, rows):
        new_map[c] = np.arange(off, off + len(r), dtype=np.int64)
        off += len(r)
    test_map = None
    if data.test_idx_map is not None:
        test_map = {c: data.test_idx_map[c] for c in client_ids
                    if c in data.test_idx_map}
    return dataclasses.replace(data, train_x=data.train_x[flat],
                               train_y=data.train_y[flat],
                               train_idx_map=new_map, test_idx_map=test_map)


_U64 = (1 << 64) - 1


def _splitmix_shuffle(idx: np.ndarray, seed: int) -> None:
    """In-place Fisher-Yates with splitmix64 — bit-identical to the
    reference's numpy and C++ shuffles.

    The splitmix state at step t is the affine seed + t*GOLDEN, so all mixed
    outputs (and hence all swap targets j) are computed vectorized; only the
    inherently-sequential swap sweep stays in Python."""
    n = len(idx)
    if n <= 1:
        return
    with np.errstate(over="ignore"):
        t = np.arange(1, n, dtype=np.uint64)
        z = np.uint64(seed) + t * np.uint64(0x9E3779B97F4A7C15)
        z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        z = z ^ (z >> np.uint64(31))
        i_vals = np.arange(n - 1, 0, -1, dtype=np.uint64)
        j = (z % (i_vals + np.uint64(1))).astype(np.int64)
    lst = idx.tolist()  # python-list swaps are ~3x faster than ndarray ones
    for t_, i in enumerate(range(n - 1, 0, -1)):
        jj = j[t_]
        lst[i], lst[jj] = lst[jj], lst[i]
    idx[:] = lst


def client_shuffle_seeds(client_ids, seed: int, round_idx: int) -> np.ndarray:
    """Per-client shuffle seeds keyed by (seed, round, CLIENT ID), so a
    client's batches do not depend on which other clients share its pack."""
    base = (seed * 7_919 + round_idx + 1) & _U64
    return np.array(
        [(base * 0x9E3779B97F4A7C15 + int(c) + 1) & _U64 for c in client_ids],
        dtype=np.uint64,
    )


def _shuffled_client_rows(data: FederatedData, cid: int, cseed: int, cap: int):
    """Client cid's row indices for this round: splitmix shuffle, truncate."""
    idx = np.array(data.train_idx_map[int(cid)])
    _splitmix_shuffle(idx, int(cseed))
    return idx[:cap]


def pack_clients(
    data: FederatedData,
    client_ids: np.ndarray,
    batch_size: int,
    max_batches: int | None = None,
    seed: int = 0,
    round_idx: int = 0,
    use_native: bool | None = None,
) -> ClientBatch:
    """Pack the sampled clients' train data into a dense ClientBatch.

    Each client's indices are shuffled per round (splitmix64 Fisher-Yates
    seeded by (seed, round, client id)), then laid into [B, bs] with zero
    padding. B is the max batch count among sampled clients unless
    ``max_batches`` caps it.

    ``use_native``: True forces the C++ packer (fedml_tpu_torch.native),
    False the numpy loop, None takes the C++ packer when it builds."""
    counts = [len(data.train_idx_map[int(c)]) for c in client_ids]
    b_needed = max(int(np.ceil(n / batch_size)) for n in counts)
    B = b_needed if max_batches is None else min(max_batches, b_needed)
    K = len(client_ids)
    bs = batch_size
    seeds = client_shuffle_seeds(client_ids, seed, round_idx)
    xshape = data.train_x.shape[1:]
    yshape = data.train_y.shape[1:]
    if B == 0:  # every sampled client is empty: a legal, empty block
        return ClientBatch(x=np.zeros((K, 0, bs) + xshape, data.train_x.dtype),
                           y=np.zeros((K, 0, bs) + yshape, data.train_y.dtype),
                           mask=np.zeros((K, 0, bs), np.float32),
                           num_samples=np.zeros((K,), np.float32))

    if use_native is not False:
        from fedml_tpu_torch import native

        if native.native_available():
            idx_lists = [np.asarray(data.train_idx_map[int(c)], np.int64)
                         for c in client_ids]
            x, y, mask, num = native.pack_clients_native(
                data.train_x, data.train_y, idx_lists, B * bs, seeds)
            return ClientBatch(x=x.reshape((K, B, bs) + xshape),
                               y=y.reshape((K, B, bs) + yshape),
                               mask=mask.reshape(K, B, bs), num_samples=num)
        if use_native:
            raise RuntimeError("native packer requested but unavailable")

    x = np.zeros((K, B, bs) + xshape, dtype=data.train_x.dtype)
    y = np.zeros((K, B, bs) + yshape, dtype=data.train_y.dtype)
    mask = np.zeros((K, B, bs), dtype=np.float32)
    num = np.zeros((K,), dtype=np.float32)

    for k, cid in enumerate(client_ids):
        idx = _shuffled_client_rows(data, cid, seeds[k], B * bs)
        n = len(idx)
        num[k] = n
        x[k].reshape(B * bs, *xshape)[:n] = data.train_x[idx]
        y[k].reshape(B * bs, *yshape)[:n] = data.train_y[idx]
        mask[k].reshape(B * bs)[:n] = 1.0
    return ClientBatch(x=x, y=y, mask=mask, num_samples=num)


def pad_batches(cb: ClientBatch, num_batches: int) -> ClientBatch:
    """Zero-pad a ClientBatch along the batch axis (axis 1) up to
    ``num_batches``. Padded batches carry mask 0, so they are no-ops."""
    pad = num_batches - cb.x.shape[1]
    if pad <= 0:
        return cb
    z = lambda a: np.concatenate(
        [a, np.zeros((a.shape[0], pad) + a.shape[2:], a.dtype)], 1)
    return ClientBatch(x=z(cb.x), y=z(cb.y), mask=z(cb.mask),
                       num_samples=cb.num_samples)


@dataclasses.dataclass
class IndexBatch:
    """Device-resident data plane: one round's client sample INDICES into a
    train set parked on the card once; the rows are gathered there. Same
    per-client-id shuffle as pack_clients, so both planes give the same
    batches."""

    idx: Any          # [K, B, bs] int32 into train_x/train_y; 0 where padded
    mask: Any         # [K, B, bs] float32
    num_samples: Any  # [K] float32


def pad_index_batches(ib: IndexBatch, num_batches: int) -> IndexBatch:
    """Index-plane analogue of pad_batches: zero-pad idx/mask along the
    batch axis up to ``num_batches`` (padded slots carry mask 0)."""
    pad = num_batches - ib.idx.shape[1]
    if pad <= 0:
        return ib
    z = lambda a: np.concatenate(
        [a, np.zeros((a.shape[0], pad) + a.shape[2:], a.dtype)], 1)
    return IndexBatch(idx=z(ib.idx), mask=z(ib.mask),
                      num_samples=ib.num_samples)


def pack_client_indices(
    data: FederatedData,
    client_ids: np.ndarray,
    batch_size: int,
    max_batches: int | None = None,
    seed: int = 0,
    round_idx: int = 0,
) -> IndexBatch:
    """Index-only variant of pack_clients (same shuffle, same layout)."""
    counts = [len(data.train_idx_map[int(c)]) for c in client_ids]
    b_needed = max(int(np.ceil(n / batch_size)) for n in counts)
    B = b_needed if max_batches is None else min(max_batches, b_needed)
    K, bs = len(client_ids), batch_size
    seeds = client_shuffle_seeds(client_ids, seed, round_idx)
    idx_out = np.zeros((K, B * bs), np.int32)
    mask = np.zeros((K, B * bs), np.float32)
    num = np.zeros((K,), np.float32)
    for k, cid in enumerate(client_ids):
        idx = _shuffled_client_rows(data, cid, seeds[k], B * bs)
        n = len(idx)
        idx_out[k, :n] = idx
        mask[k, :n] = 1.0
        num[k] = n
    return IndexBatch(idx=idx_out.reshape(K, B, bs),
                      mask=mask.reshape(K, B, bs), num_samples=num)


def batch_global(x: np.ndarray, y: np.ndarray, batch_size: int):
    """Pad-and-batch a global dataset into [B, bs, ...] + mask, for eval."""
    n = len(x)
    B = int(np.ceil(n / batch_size))
    xb = np.zeros((B, batch_size) + x.shape[1:], dtype=x.dtype)
    yb = np.zeros((B, batch_size) + y.shape[1:], dtype=y.dtype)
    mb = np.zeros((B, batch_size), dtype=np.float32)
    xb.reshape(B * batch_size, *x.shape[1:])[:n] = x
    yb.reshape(B * batch_size, *y.shape[1:])[:n] = y
    mb.reshape(B * batch_size)[:n] = 1.0
    return xb, yb, mb
