"""Streamed client state — the million-client data plane.

``FederatedData`` materializes the whole population's arrays in host
memory, so standalone cohort scale is bounded by host RSS, not TPU
throughput (ROADMAP open item 4). FedJAX (arXiv:2108.02117) shows the fix:
a *client-indexed* dataset whose per-client shards are read lazily from
disk, with only the sampled cohort's rows ever touching memory. This
module is that abstraction:

- :class:`ClientDataSource` — the contract every engine packs against:
  per-client *sizes* are cheap metadata (``client_sizes``), per-client
  *rows* are fetched on demand (``client_rows``), and the global test
  split stays materialized (it is small and evaluated every round).
- :class:`InMemorySource` — wraps today's ``FederatedData`` (zero-copy
  views); the parity oracle for every out-of-core reader.
- :class:`PackedNpySource` — the out-of-core workhorse: standard ``.npy``
  containers read with plain ``seek``+``read`` (NOT ``mmap`` — resident
  mapped pages would count toward RSS and the flat-memory claim is
  asserted on ``fed_host_rss_bytes``, obs/memwatch.py), so a round's
  host footprint is exactly the sampled cohort's rows.
- :class:`LeafJsonSource` / :class:`TffH5Source` — lazy readers for the
  reference's LEAF-json and TFF-h5 layouts (data/files.py documents the
  formats); one parsed file / open h5 handle at a time.
- :func:`pack_clients_source` — ``pack_clients`` against a source:
  touches ONLY the sampled clients, same (seed, round, CLIENT-ID)
  splitmix shuffle, bit-identical batches (test-enforced).

``write_packed_npy`` converts any source (or ``FederatedData``) to the
packed layout, chunked so the writer's RSS stays flat too.
"""

from __future__ import annotations

import json
import logging
import os
import threading

import numpy as np

from fedml_tpu_torch.core.client_data import (
    ClientBatch,
    FederatedData,
    _splitmix_shuffle,
    client_shuffle_seeds,
)

log = logging.getLogger("fedml_tpu_torch.client_source")


class ClientDataSource:
    """Client-indexed dataset: metadata eager, payload lazy.

    Subclasses set ``class_num``, ``source`` ("real" | "synthetic"),
    ``test_x``/``test_y`` (materialized — the global eval split), and
    implement ``client_sizes`` + ``client_rows``. ``test_idx_map`` stays
    None unless the source carries natural per-client test splits (the
    engines' per-client eval then degrades to the global test set,
    exactly the capped-eval behavior large populations want anyway).
    """

    class_num: int = 0
    source: str = "real"
    test_idx_map = None

    @property
    def num_clients(self) -> int:
        return len(self.client_sizes)

    @property
    def client_sizes(self) -> np.ndarray:
        """[N] int64 per-client sample counts — metadata only, never
        triggers payload reads."""
        raise NotImplementedError

    def client_rows(self, cid: int) -> tuple[np.ndarray, np.ndarray]:
        """One client's (x, y) rows in canonical on-disk order. The
        arrays are fresh host buffers owned by the caller."""
        raise NotImplementedError

    def row_meta(self):
        """((x row shape, x dtype), (y row shape, y dtype)) — cached after
        ONE probe read, so per-round packing never re-reads a client's
        payload just to learn round-invariant shapes. Subclasses with
        metadata on hand (PackedNpySource) override with zero I/O."""
        if getattr(self, "_row_meta_cache", None) is None:
            sizes = self.client_sizes
            first = int(np.argmax(sizes > 0)) if np.any(sizes > 0) else 0
            x, y = self.client_rows(first)
            self._row_meta_cache = ((x.shape[1:], x.dtype),
                                    (y.shape[1:], y.dtype))
        return self._row_meta_cache

    # engines size jit programs and init models from these
    def init_batch(self, batch_size: int) -> np.ndarray:
        """A model-init sample batch (values irrelevant, shapes/dtypes
        matter) — the streamed analogue of ``train_x[:batch_size]``."""
        sizes = self.client_sizes
        first = int(np.argmax(sizes > 0)) if np.any(sizes > 0) else 0
        x, _ = self.client_rows(first)
        if len(x) >= batch_size:
            return x[:batch_size]
        reps = -(-batch_size // max(len(x), 1))
        return np.concatenate([x] * reps)[:batch_size]

    @property
    def train_data_local_num_dict(self) -> dict[int, int]:
        sizes = self.client_sizes
        return {c: int(sizes[c]) for c in range(len(sizes))}


class InMemorySource(ClientDataSource):
    """``FederatedData`` behind the source contract — views, no copies.
    The parity oracle: every out-of-core reader must pack bit-identically
    to this one over the same data."""

    def __init__(self, data: FederatedData):
        self.data = data
        self.class_num = data.class_num
        self.source = ("synthetic"
                       if getattr(data, "synthetic_fallback", False)
                       else "real")
        self.test_x, self.test_y = data.test_x, data.test_y
        self.test_idx_map = data.test_idx_map
        self._sizes = np.asarray(
            [len(data.train_idx_map[c]) for c in range(data.num_clients)],
            np.int64)

    @property
    def client_sizes(self) -> np.ndarray:
        return self._sizes

    def client_rows(self, cid: int):
        idx = np.asarray(self.data.train_idx_map[int(cid)], np.int64)
        return self.data.train_x[idx], self.data.train_y[idx]

    def init_batch(self, batch_size: int) -> np.ndarray:
        return self.data.train_x[:batch_size]


def _npy_header(path: str):
    """(shape, dtype, data_offset) of a standard .npy without mapping or
    loading it — the container stays np.save-compatible while reads go
    through plain seek+read (flat RSS; see module docstring)."""
    with open(path, "rb") as f:
        version = np.lib.format.read_magic(f)
        if version >= (2, 0):
            shape, fortran, dtype = np.lib.format.read_array_header_2_0(f)
        else:
            shape, fortran, dtype = np.lib.format.read_array_header_1_0(f)
        if fortran:
            raise ValueError(f"{path}: fortran-order npy unsupported")
        return shape, dtype, f.tell()


class _NpyColumn:
    """Row-addressable reads out of one .npy file via pread-style
    seek+read under a lock (sources are shared with the prefetch thread)."""

    def __init__(self, path: str):
        self.path = path
        self.shape, self.dtype, self.offset = _npy_header(path)
        self.row_shape = self.shape[1:]
        self.row_bytes = int(np.prod(self.row_shape, dtype=np.int64)
                             * self.dtype.itemsize) or self.dtype.itemsize
        self._f = open(path, "rb")
        self._lock = threading.Lock()

    def rows(self, start: int, stop: int) -> np.ndarray:
        n = max(int(stop) - int(start), 0)
        with self._lock:
            self._f.seek(self.offset + int(start) * self.row_bytes)
            buf = self._f.read(n * self.row_bytes)
        if len(buf) != n * self.row_bytes:
            raise EOFError(f"{self.path}: short read at rows "
                           f"[{start}, {stop})")
        return np.frombuffer(buf, dtype=self.dtype).reshape(
            (n,) + self.row_shape).copy()

    def close(self):
        self._f.close()


class PackedNpySource(ClientDataSource):
    """Out-of-core packed layout::

        <dir>/meta.json      {"format": "fedml-packed-npy", "class_num",
                              "num_clients", "source"}
        <dir>/offsets.npy    int64 [N+1] — client c owns rows
                             [offsets[c], offsets[c+1]) of x/y
        <dir>/x.npy, y.npy   all clients' rows, concatenated
        <dir>/test_x.npy, test_y.npy   the global eval split

    Only ``offsets`` (8(N+1) bytes) and the test split are resident;
    ``client_rows`` reads exactly one client's byte range.
    """

    def __init__(self, path: str, n_clients: int | None = None):
        self.path = path
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        if meta.get("format") != "fedml-packed-npy":
            raise ValueError(f"{path}: not a fedml-packed-npy dir "
                             f"(meta format={meta.get('format')!r})")
        self.class_num = int(meta["class_num"])
        self.source = str(meta.get("source", "real"))
        self._offsets = np.load(os.path.join(path, "offsets.npy"))
        self._x = _NpyColumn(os.path.join(path, "x.npy"))
        self._y = _NpyColumn(os.path.join(path, "y.npy"))
        self.test_x = np.load(os.path.join(path, "test_x.npy"))
        self.test_y = np.load(os.path.join(path, "test_y.npy"))
        if int(meta["num_clients"]) != len(self._offsets) - 1:
            raise ValueError(
                f"{path}: meta names {meta['num_clients']} clients but "
                f"offsets describe {len(self._offsets) - 1}")
        if n_clients is not None:
            # population cap, like the LEAF/h5 readers' n_clients: the
            # first n clients (their rows stay addressable; the rest of
            # the file is simply never read)
            self._offsets = self._offsets[: int(n_clients) + 1]
        self._sizes = np.diff(self._offsets).astype(np.int64)

    @property
    def client_sizes(self) -> np.ndarray:
        return self._sizes

    def row_meta(self):
        # the npy headers already hold this — no payload read at all
        return ((self._x.row_shape, self._x.dtype),
                (self._y.row_shape, self._y.dtype))

    def client_rows(self, cid: int):
        a, b = int(self._offsets[int(cid)]), int(self._offsets[int(cid) + 1])
        return self._x.rows(a, b), self._y.rows(a, b)

    def close(self):
        self._x.close()
        self._y.close()


def write_packed_npy(data, path: str, chunk_clients: int = 1024,
                     source: str | None = None) -> str:
    """Convert ``data`` (FederatedData or any ClientDataSource) to the
    packed-npy layout under ``path``. Streams ``chunk_clients`` clients at
    a time through ``np.lib.format`` so the writer never materializes the
    full population either."""
    src = as_source(data)
    os.makedirs(path, exist_ok=True)
    sizes = src.client_sizes
    n = len(sizes)
    offsets = np.zeros(n + 1, np.int64)
    np.cumsum(sizes, out=offsets[1:])
    total = int(offsets[-1])
    x0, y0 = src.client_rows(int(np.argmax(sizes > 0)))

    def write_column(name, row_shape, dtype, pick):
        p = os.path.join(path, name)
        with open(p, "wb") as f:
            np.lib.format.write_array_header_2_0(
                f, {"descr": np.lib.format.dtype_to_descr(np.dtype(dtype)),
                    "fortran_order": False,
                    "shape": (total,) + tuple(row_shape)})
            for s in range(0, n, chunk_clients):
                block = [pick(c) for c in range(s, min(s + chunk_clients, n))
                         if sizes[c] > 0]
                if block:
                    f.write(np.ascontiguousarray(
                        np.concatenate(block)).tobytes())

    write_column("x.npy", x0.shape[1:], x0.dtype,
                 lambda c: src.client_rows(c)[0])
    write_column("y.npy", y0.shape[1:], y0.dtype,
                 lambda c: src.client_rows(c)[1])
    np.save(os.path.join(path, "offsets.npy"), offsets)
    np.save(os.path.join(path, "test_x.npy"), np.asarray(src.test_x))
    np.save(os.path.join(path, "test_y.npy"), np.asarray(src.test_y))
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump({"format": "fedml-packed-npy", "num_clients": n,
                   "class_num": int(src.class_num),
                   "source": source or src.source}, f)
    return path


class LeafJsonSource(ClientDataSource):
    """Lazy LEAF-json reader (``{train,test}/*.json`` with users/
    user_data — data/files.py ``_load_leaf_json`` documents the format).
    The index pass records (file, user) per client and per-client sizes;
    ``client_rows`` re-parses one json file on demand with a 1-file
    cache, so memory holds at most one shard file's worth of payload."""

    def __init__(self, data_dir: str, input_shape: tuple, class_num: int,
                 n_clients: int | None = None):
        import glob

        self.data_dir = data_dir
        self.class_num = int(class_num)
        self.input_shape = tuple(input_shape)
        self._index: list[tuple[str, str]] = []  # client -> (path, user)
        sizes: list[int] = []
        for p in sorted(glob.glob(os.path.join(data_dir, "train",
                                               "*.json"))):
            with open(p) as f:
                blob = json.load(f)
            for u in blob["users"]:
                self._index.append((p, u))
                sizes.append(len(blob["user_data"][u]["y"]))
            del blob
        if n_clients is not None:
            self._index = self._index[:n_clients]
            sizes = sizes[:n_clients]
        if not self._index:
            raise FileNotFoundError(f"no LEAF train jsons under {data_dir}")
        self._sizes = np.asarray(sizes, np.int64)
        self._cache: tuple[str, dict] | None = None
        self._lock = threading.Lock()
        self.test_x, self.test_y = self._load_test()

    def _load_test(self):
        import glob

        xs, ys = [], []
        for p in sorted(glob.glob(os.path.join(self.data_dir, "test",
                                               "*.json"))):
            with open(p) as f:
                blob = json.load(f)
            for u in blob["users"]:
                ud = blob["user_data"][u]
                xs.append(np.asarray(ud["x"], np.float32))
                ys.append(np.asarray(ud["y"], np.int64))
        if not xs:
            # no test split shipped: fall back to the first train shard —
            # said LOUDLY, because every eval record would otherwise pass
            # training accuracy off as test_acc
            log.warning("%s: no test/*.json — evaluating on the first "
                        "TRAIN shard (test_acc will be training accuracy)",
                        self.data_dir)
            p, u = self._index[0]
            blob = self._parsed(p)
            ud = blob["user_data"][u]
            xs = [np.asarray(ud["x"], np.float32)]
            ys = [np.asarray(ud["y"], np.int64)]
        x = np.concatenate(xs).reshape((-1,) + self.input_shape)
        return x, np.concatenate(ys)

    def _parsed(self, path: str) -> dict:
        with self._lock:
            if self._cache is None or self._cache[0] != path:
                with open(path) as f:
                    self._cache = (path, json.load(f))
            return self._cache[1]

    @property
    def client_sizes(self) -> np.ndarray:
        return self._sizes

    def client_rows(self, cid: int):
        path, user = self._index[int(cid)]
        ud = self._parsed(path)["user_data"][user]
        x = np.asarray(ud["x"], np.float32).reshape(
            (-1,) + self.input_shape)
        return x, np.asarray(ud["y"], np.int64)


class TffH5Source(ClientDataSource):
    """Lazy TFF-h5 reader (``examples/<cid>/{pixels|image, label}`` —
    data/files.py ``_load_tff_h5``). h5py reads one client group per
    ``client_rows`` call; sizes come from the dataset shapes (h5 metadata,
    no payload read). Gated on h5py at construction."""

    def __init__(self, train_path: str, class_num: int,
                 test_path: str | None = None,
                 n_clients: int | None = None):
        import h5py  # ImportError is the caller's gate

        self._h5 = h5py.File(train_path, "r")
        self._lock = threading.Lock()
        self.class_num = int(class_num)
        ex = self._h5["examples"]
        self._cids = sorted(ex.keys())[:n_clients]
        if not self._cids:
            raise ValueError(f"{train_path}: no clients under examples/")
        g0 = ex[self._cids[0]]
        self._xkey = ("pixels" if "pixels" in g0
                      else ("image" if "image" in g0 else "snippets"))
        self._ykey = "label" if "label" in g0 else None
        self._sizes = np.asarray(
            [ex[c][self._xkey].shape[0] for c in self._cids], np.int64)
        self.test_x, self.test_y = self._load_test(
            h5py, test_path, n_clients)

    def _load_test(self, h5py, test_path, n_clients):
        if test_path is None or not os.path.exists(test_path):
            log.warning("%s: no test h5 — evaluating on client 0's TRAIN "
                        "rows (test_acc will be training accuracy)",
                        self._h5.filename)
            x, y = self.client_rows(0)
            return x, y
        xs, ys = [], []
        with h5py.File(test_path, "r") as f:
            ex = f["examples"]
            for c in sorted(ex.keys())[:n_clients]:
                xs.append(self._arrify_x(np.asarray(ex[c][self._xkey])))
                if self._ykey:
                    ys.append(np.asarray(ex[c][self._ykey], np.int64))
        x = np.concatenate(xs)
        y = (np.concatenate(ys) if ys
             else np.zeros((len(x),), np.int64))
        return x, y

    @staticmethod
    def _arrify_x(x: np.ndarray) -> np.ndarray:
        if x.dtype != np.dtype("O"):
            x = x.astype(np.float32)
        if x.ndim == 3:  # [N, H, W] -> NHWC, like _load_tff_h5
            x = x[..., None]
        return x

    @property
    def client_sizes(self) -> np.ndarray:
        return self._sizes

    def client_rows(self, cid: int):
        with self._lock:
            g = self._h5["examples"][self._cids[int(cid)]]
            x = self._arrify_x(np.asarray(g[self._xkey]))
            y = (np.asarray(g[self._ykey], np.int64) if self._ykey
                 else np.zeros((len(x),), np.int64))
        return x, y

    def close(self):
        self._h5.close()


def as_source(data) -> ClientDataSource:
    """Normalize: a ClientDataSource passes through, FederatedData wraps."""
    if isinstance(data, ClientDataSource):
        return data
    if isinstance(data, FederatedData):
        return InMemorySource(data)
    raise TypeError(f"expected FederatedData or ClientDataSource, got "
                    f"{type(data).__name__}")


def open_source(path: str, input_shape=None, class_num: int | None = None,
                n_clients: int | None = None) -> ClientDataSource:
    """Open an on-disk dataset as a streamed source by layout sniffing:
    packed-npy (meta.json), LEAF-json (train/*.json), TFF-h5 (*.h5)."""
    import glob

    if os.path.isfile(os.path.join(path, "meta.json")):
        return PackedNpySource(path, n_clients=n_clients)
    if glob.glob(os.path.join(path, "train", "*.json")):
        if input_shape is None or class_num is None:
            raise ValueError("LEAF-json sources need input_shape= and "
                             "class_num= (no meta.json to read them from)")
        return LeafJsonSource(path, input_shape, class_num,
                              n_clients=n_clients)
    h5s = sorted(glob.glob(os.path.join(path, "*.h5")))
    if h5s:
        if class_num is None:
            raise ValueError("TFF-h5 sources need class_num=")
        train = next((p for p in h5s if "train" in os.path.basename(p)),
                     h5s[0])
        test = next((p for p in h5s if "test" in os.path.basename(p)), None)
        return TffH5Source(train, class_num, test_path=test,
                           n_clients=n_clients)
    raise FileNotFoundError(
        f"{path}: no packed-npy meta.json, LEAF train/*.json, or *.h5")


def pack_clients_source(
    source: ClientDataSource,
    client_ids,
    batch_size: int,
    max_batches: int | None = None,
    seed: int = 0,
    round_idx: int = 0,
) -> ClientBatch:
    """``pack_clients`` against a streamed source: only the SAMPLED
    clients' rows are read, shuffled with the same (seed, round,
    CLIENT-ID) splitmix chain (positions instead of global indices — the
    permutation is identical, so batches are bit-identical to the
    in-memory packer over equivalent data; test-enforced)."""
    sizes = source.client_sizes
    counts = [int(sizes[int(c)]) for c in client_ids]
    b_needed = max(int(np.ceil(n / batch_size)) for n in counts)
    B = b_needed if max_batches is None else min(max_batches, b_needed)
    K, bs = len(client_ids), batch_size
    seeds = client_shuffle_seeds(client_ids, seed, round_idx)

    (xshape, xdtype), (yshape, ydtype) = source.row_meta()
    if B == 0:
        return ClientBatch(
            x=np.zeros((K, 0, bs) + xshape, xdtype),
            y=np.zeros((K, 0, bs) + yshape, ydtype),
            mask=np.zeros((K, 0, bs), np.float32),
            num_samples=np.zeros((K,), np.float32))

    x = np.zeros((K, B, bs) + xshape, dtype=xdtype)
    y = np.zeros((K, B, bs) + yshape, dtype=ydtype)
    mask = np.zeros((K, B, bs), dtype=np.float32)
    num = np.zeros((K,), dtype=np.float32)
    for k, cid in enumerate(client_ids):
        cx, cy = source.client_rows(int(cid))
        pos = np.arange(len(cx), dtype=np.int64)
        _splitmix_shuffle(pos, int(seeds[k]))
        pos = pos[: B * bs]
        n = len(pos)
        num[k] = n
        x[k].reshape(B * bs, *xshape)[:n] = cx[pos]
        y[k].reshape(B * bs, *yshape)[:n] = cy[pos]
        mask[k].reshape(B * bs)[:n] = 1.0
    return ClientBatch(x=x, y=y, mask=mask, num_samples=num)
