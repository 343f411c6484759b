"""The C++ client packer (``packer.cpp``), loaded through ctypes — the port's
own copy of fedml_tpu/native, with the same C interface and the same bytes
out as the numpy packer in ``core/client_data.py``.

It is compiled with g++ at first use into ``fedml_tpu_torch/_build/``
(listed in .gitignore), never next to its source; the library name carries
a hash of the source and the flags, so an edited source is rebuilt. When no
toolchain is present, ``native_available()`` is False and
``pack_clients(use_native=None)`` takes the numpy path, as the reference
does; ``use_native=True`` then raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "packer.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")

# packs served by the C++ packer since the last reset (chip_smoke reads it
# to show that a run went through the native path)
CALLS = {"pack_clients": 0}

_lock = threading.Lock()
_lib = None
_tried = False


def library_path() -> Path:
    digest = hashlib.sha256(
        SRC.read_bytes() + " ".join(GXX_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"packer-{digest}.so"


def _build(out: Path) -> bool:
    BUILD_DIR.mkdir(exist_ok=True)
    # a private temp name, then an atomic rename: concurrent first-use
    # builds from several processes never load half a file
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp")
    cmd = ["g++", *GXX_FLAGS, str(SRC), "-o", str(tmp)]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError):
        tmp.unlink(missing_ok=True)
        return False
    os.replace(tmp, out)
    return True


def get_lib():
    """Load (building if needed) the native library; None if unavailable."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        out = library_path()
        if not out.exists() and not _build(out):
            return None
        try:
            lib = ctypes.CDLL(str(out))
        except OSError:
            return None
        lib.fedml_pack_clients.restype = ctypes.c_int
        lib.fedml_pack_clients.argtypes = [
            ctypes.c_char_p, ctypes.c_int64,        # x, x_row_bytes
            ctypes.c_char_p, ctypes.c_int64,        # y, y_row_bytes
            ctypes.POINTER(ctypes.c_int64),         # idx_concat
            ctypes.POINTER(ctypes.c_int64),         # idx_offsets
            ctypes.c_int64, ctypes.c_int64,         # K, capacity
            ctypes.POINTER(ctypes.c_uint64),        # per-client seeds [K]
            ctypes.c_int,                           # assume_zeroed
            ctypes.c_char_p, ctypes.c_char_p,       # out_x, out_y
            ctypes.POINTER(ctypes.c_float),         # out_mask
            ctypes.POINTER(ctypes.c_float),         # out_num
            ctypes.c_int,                           # n_threads
        ]
        _lib = lib
        return _lib


def native_available() -> bool:
    return get_lib() is not None


def pack_clients_native(train_x: np.ndarray, train_y: np.ndarray,
                        idx_lists: list[np.ndarray], capacity: int,
                        seeds: np.ndarray, n_threads: int = 0):
    """C++ path of core.client_data.pack_clients' inner loop.

    Returns (x [K, capacity, ...], y [K, capacity, ...], mask [K, capacity],
    num [K]) with client k's rows shuffled by splitmix64(seeds[k]); the
    caller derives seeds from client IDs so packing is grouping-invariant.
    """
    lib = get_lib()
    if lib is None:
        raise RuntimeError("native packer unavailable")
    x = np.ascontiguousarray(train_x)
    y = np.ascontiguousarray(train_y)
    K = len(idx_lists)
    offsets = np.zeros(K + 1, np.int64)
    for k, il in enumerate(idx_lists):
        offsets[k + 1] = offsets[k] + len(il)
    idx_concat = (np.concatenate(idx_lists).astype(np.int64) if K
                  else np.zeros(0, np.int64))
    if len(idx_concat) and (idx_concat.min() < 0
                            or idx_concat.max() >= len(x)):
        raise IndexError(f"client indices outside [0, {len(x)})")
    x_row = int(np.prod(x.shape[1:])) * x.itemsize
    y_row = (int(np.prod(y.shape[1:])) if y.ndim > 1 else 1) * y.itemsize
    seeds = np.ascontiguousarray(seeds, np.uint64)

    # np.zeros -> calloc zero pages: padding never gets touched, so the
    # packer only writes real rows (see packer.cpp assume_zeroed)
    out_x = np.zeros((K, capacity) + x.shape[1:], x.dtype)
    out_y = np.zeros((K, capacity) + y.shape[1:], y.dtype)
    out_mask = np.zeros((K, capacity), np.float32)
    out_num = np.empty((K,), np.float32)

    rc = lib.fedml_pack_clients(
        x.ctypes.data_as(ctypes.c_char_p), x_row,
        y.ctypes.data_as(ctypes.c_char_p), y_row,
        idx_concat.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        K, capacity,
        seeds.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)), 1,
        out_x.ctypes.data_as(ctypes.c_char_p),
        out_y.ctypes.data_as(ctypes.c_char_p),
        out_mask.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        out_num.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        int(n_threads),
    )
    if rc != 0:
        raise RuntimeError(f"fedml_pack_clients failed rc={rc}")
    CALLS["pack_clients"] += 1
    return out_x, out_y, out_mask, out_num
