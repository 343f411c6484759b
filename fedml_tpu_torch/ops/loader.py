"""Build the port's CUDA sources with nvcc and load them through ctypes.

Each ``csrc/*.cu`` file exposes a plain C interface and is compiled at first
use, for Hopper only (``sm_90a``), into ``fedml_tpu_torch/_build/`` (listed in
.gitignore). The library name carries a hash of the source and the flags, so
an edited source is rebuilt and a stale library is never loaded. The compiler
log, with ptxas's register and spill report, is kept beside the library.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(home, "bin", "nvcc")):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: the port's kernels are built from "
                       "source (put nvcc on PATH or set CUDA_HOME)")


def library_path(source: str) -> Path:
    """Where the library built from ``csrc/<source>`` lives."""
    src = CSRC / source
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{src.stem}-{digest}.so"


def build(source: str) -> Path:
    """Compile ``csrc/<source>`` unless its library exists; return the path.
    Raises with the compiler's message if nvcc fails."""
    out = library_path(source)
    if out.exists():
        return out
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed on {source}:\n{proc.stderr[-6000:]}")
    os.replace(tmp, out)  # atomic: a concurrent builder never sees half a file
    return out


def build_all() -> list[Path]:
    """Build every source in ``csrc/`` at once, one nvcc process each."""
    sources = sorted(p.name for p in CSRC.glob("*.cu"))
    with concurrent.futures.ThreadPoolExecutor(len(sources)) as pool:
        return list(pool.map(build, sources))


def load_library(source: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<source>``, built on first use. Its
    kernels launch only on the card, so this raises without CUDA."""
    if not torch.cuda.is_available():
        raise RuntimeError(f"{source}: no CUDA device; its kernels launch "
                           "only on the card")
    with _lock:
        lib = _libs.get(source)
        if lib is None:
            lib = _libs[source] = ctypes.CDLL(str(build(source)))
        return lib
