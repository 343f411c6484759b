"""Provenance header for BENCH blobs, port of fedml_tpu/obs/provenance.py —
who/what/where a number came from.

Every bench writer stamps the same ``provenance`` block on its JSON blob
so runs can be indexed and compared across commits:

    {"provenance": {"git_sha": "79fc809", "torch": "2.x", "cuda": "12.x",
                    "device_kind": "NVIDIA H100 80GB HBM3",
                    "device_count": 1, "dataset_source": "synthetic",
                    "date": "2026-08-07"}}

Everything is best-effort and stdlib-only: git absent -> sha None; torch
not imported or CUDA not initialized -> device fields None (this module
NEVER imports torch itself, and never initializes CUDA — a process that
has not touched the card must not create a context to stamp a blob); the
wall-clock ``date`` is PASSED IN by the caller (scripts layer), never read
here, keeping the module importable from clock-disciplined code.
Historical blobs without the block are tolerated everywhere.
"""

from __future__ import annotations

import logging
import os
import subprocess
import sys

log = logging.getLogger("fedml_tpu_torch.obs.provenance")


def git_sha(cwd: str | None = None) -> str | None:
    """The short HEAD sha, or None outside a repo / without git."""
    try:
        out = subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"],
            cwd=cwd or os.path.dirname(os.path.dirname(
                os.path.dirname(os.path.abspath(__file__)))),
            capture_output=True, text=True, timeout=10)
        sha = out.stdout.strip()
        return sha if out.returncode == 0 and sha else None
    except Exception:  # noqa: BLE001 — provenance is best-effort
        log.debug("git sha lookup failed; provenance carries sha=None",
                  exc_info=True)
        return None


def _dist_version(name: str) -> str | None:
    try:
        from importlib import metadata
        return metadata.version(name)
    except Exception:  # noqa: BLE001
        log.debug("version lookup for %s failed", name, exc_info=True)
        return None


def _device_info() -> tuple[str | None, int | None]:
    """(device_kind, device_count) from an ALREADY-IMPORTED torch whose
    CUDA is already initialized, else (None, None). Reading sys.modules
    instead of importing, and asking ``is_initialized`` before anything
    else, keeps a process that never touched the card off it."""
    torch_mod = sys.modules.get("torch")
    if torch_mod is None:
        return None, None
    try:
        if not torch_mod.cuda.is_initialized():
            return None, None
        return (torch_mod.cuda.get_device_name(0),
                torch_mod.cuda.device_count())
    except Exception:  # noqa: BLE001
        log.debug("device enumeration failed; provenance device fields "
                  "are None", exc_info=True)
        return None, None


def provenance(date: str | None = None,
               dataset_source: str | None = None) -> dict:
    """The common provenance block. ``date`` is the caller's wall-clock
    date string (scripts stamp it; nothing here reads a clock). The
    version fields are torch's and the CUDA toolkit it was built with."""
    kind, count = _device_info()
    torch_mod = sys.modules.get("torch")
    return {
        "git_sha": git_sha(),
        "torch": _dist_version("torch"),
        "cuda": (getattr(torch_mod.version, "cuda", None)
                 if torch_mod is not None else None),
        "device_kind": kind,
        "device_count": count,
        "dataset_source": dataset_source,
        "date": date,
    }


def stamp(blob: dict, date: str | None = None,
          dataset_source: str | None = None) -> dict:
    """Attach the provenance block to a BENCH blob in place (and return
    it). Never overwrites an existing block — a relay (bench.py's parent
    re-emitting a child's line) must not clobber the measuring process's
    stamp."""
    if "provenance" not in blob:
        blob["provenance"] = provenance(date=date,
                                        dataset_source=dataset_source)
    return blob
