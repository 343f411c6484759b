"""Round checkpoints, port of fedml_tpu/core/checkpoint.py in torch + numpy:
the server's params + optimizer state + round index + RNG key, written as
the reference's npz layout so that either package restores the other's.

The layout (the reference's orbax-less fallback): one ``round_NNNNNN.npz``
per round holding ``leaf_i`` in ``jax.tree.flatten`` order of the state
dict ``{"net", "rng", "round", "server_opt_state", ...}`` (keys sorted) and
a ``treedef`` string equal to the one the JAX package writes. The net's
leaves are its flax params in sorted-key order (``comm.message.
pack_pytree``: HWIO convolution kernels, ``[in, out]`` dense kernels), and
its treedef is the JAX package's ``NetState`` namedtuple around them —
built here from the same ``convert.to_flax`` names, so a port checkpoint
never loads shifted weights into the JAX package, nor the reverse: the
reader maps leaves by index and checks the treedef string first.

Durability is the reference's: tmp name -> fsync -> atomic rename (+ dir
fsync) through core/wal.py's helpers; a torn newest file is skipped by
:func:`restore_latest` (counted on ``fed_ckpt_torn_total``) and recovery
falls back to the previous round, while a template that disagrees with
what was saved stays a loud ``ValueError``. The JAX package may also
write orbax directories; the port reads only the npz layout and says so.
"""

from __future__ import annotations

import os
import re
from typing import Any

import numpy as np
import torch

from fedml_tpu_torch.comm.message import _flat_items, pack_pytree, unpack_pytree
from fedml_tpu_torch.core.wal import durable_open, durable_replace, durable_write


class TornCheckpoint(Exception):
    """A checkpoint file that cannot even be LOADED (truncated zip, short
    read, crash mid-write) — distinct from a structure mismatch, which is
    a configuration error and stays loud. ``restore_latest`` skips (and
    counts) torn files; direct ``restore_round`` callers see the raise."""


# ------------------------------------------------------------- the layout
def _dict_def(tree) -> str:
    """A nested dict's treedef as ``str(jax.tree.structure)`` prints it."""
    return "{" + ", ".join(
        f"{k!r}: {_dict_def(v) if isinstance(v, dict) else '*'}"
        for k, v in sorted(tree.items())) + "}"


def _net_params(net: dict, num_heads: int | None) -> dict:
    """The flax params tree of the port state ``net``'s model, as zeros of
    its shapes (the structure only: names, nesting and leaf shapes)."""
    from fedml_tpu_torch.convert import to_flax

    return to_flax({k: torch.zeros(tuple(v.shape)) for k, v in net.items()},
                   num_heads)


def _is_net(key: str, value) -> bool:
    return key == "net" and isinstance(value, dict)


def _layout(state: dict, num_heads: int | None):
    """``(leaf shapes, treedef string)`` of a checkpoint state dict in the
    JAX package's ``jax.tree.flatten`` order: top-level keys sorted,
    ``net`` (the port's state dict) as its flax leaves inside the
    reference's ``NetState``, an empty tuple as no leaf, anything else as
    one array leaf."""
    shapes, defs = [], []
    for key in sorted(state):
        value = state[key]
        if _is_net(key, value):
            params = _net_params(value, num_heads)
            shapes += [tuple(leaf.shape) for _, leaf in _flat_items(params)]
            defs.append(f"{key!r}: CustomNode(namedtuple[NetState], "
                        f"[{_dict_def(params)}, {{}}])")
        elif isinstance(value, tuple) and not value:
            defs.append(f"{key!r}: ()")
        else:
            shapes.append(tuple(np.shape(value)))
            defs.append(f"{key!r}: *")
    return shapes, "PyTreeDef({" + ", ".join(defs) + "})"


def flatten_state(state: dict, num_heads: int | None = None):
    """``(leaves, treedef string)`` of a checkpoint state dict, as the JAX
    package's ``jax.tree.flatten`` gives them (see :func:`_layout`)."""
    leaves = []
    for key in sorted(state):
        value = state[key]
        if _is_net(key, value):
            leaves += pack_pytree(value, num_heads)
        elif not (isinstance(value, tuple) and not value):
            if isinstance(value, torch.Tensor):
                value = value.detach().cpu().numpy()
            leaves.append(np.asarray(value))
    return leaves, _layout(state, num_heads)[1]


def _unflatten_state(template: dict, leaves: list,
                     num_heads: int | None) -> dict:
    out, i = {}, 0
    for key in sorted(template):
        value = template[key]
        if _is_net(key, value):
            n = sum(1 for _ in _flat_items(_net_params(value, num_heads)))
            out[key] = unpack_pytree(value, leaves[i:i + n], num_heads)
            i += n
        elif isinstance(value, tuple) and not value:
            out[key] = ()
        else:
            out[key] = leaves[i]
            i += 1
    return out


# ------------------------------------------------------------------- save
def save_round(ckpt_dir: str, round_idx: int, net, server_opt_state, rng,
               history: list | None = None, keep: int = 3,
               extra_state: dict | None = None,
               num_heads: int | None = None):
    """Save one round's checkpoint (the reference's npz layout, see the
    module docstring): ``net`` is the port's state dict (a TransformerLM's
    needs its ``num_heads``), ``rng`` the reference's key bits
    (``uint32[2]``). ``extra_state``: additional top-level entries —
    restore templates must declare the same keys."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, f"round_{round_idx:06d}")
    state = {
        "net": net,
        "server_opt_state": server_opt_state,
        "rng": rng,
        "round": np.asarray(round_idx, np.int64),
    }
    if extra_state:
        state.update(extra_state)
    leaves, treedef = flatten_state(state, num_heads)
    # atomic + durable: write under a tmp name that _completed_rounds
    # ignores, fsync, then rename (+ dir fsync) — a crash mid-save must
    # not leave a loadable-looking file, and a crash right after the
    # rename must not lose the rename
    tmp = path + ".npz.tmp"
    try:
        with durable_open(tmp, "wb") as f:
            np.savez(f, treedef=treedef,
                     **{f"leaf_{i}": x for i, x in enumerate(leaves)})
        durable_replace(tmp, path + ".npz")
    finally:
        if os.path.exists(tmp):  # don't let an orphan eat a _prune slot
            os.unlink(tmp)
    if history is not None:
        import json

        durable_write(os.path.join(ckpt_dir, "history.json"),
                      json.dumps(history).encode())
    _prune(ckpt_dir, keep)
    return path


class AsyncCheckpointer:
    """Round checkpoints written OFF the training thread.

    The caller pays only the device->host snapshot (taken on its own
    thread: the next round may update the tensors in place); the write,
    fsync and pruning overlap the following rounds. One save in flight at
    a time: a second ``save()`` first waits for the previous write
    (backpressure), and a failed background write surfaces on the next
    call rather than being dropped."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        from concurrent.futures import ThreadPoolExecutor

        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self._pool = ThreadPoolExecutor(max_workers=1,
                                        thread_name_prefix="ckpt")
        self._inflight = None

    def save(self, round_idx: int, net, server_opt_state, rng,
             history: list | None = None,
             extra_state: dict | None = None,
             num_heads: int | None = None) -> None:
        host = lambda v: (v.detach().to("cpu", copy=True)  # noqa: E731
                          if isinstance(v, torch.Tensor)
                          else np.array(v, copy=True))
        net = {k: host(v) for k, v in net.items()}
        rng = host(rng)
        extra = ({k: host(v) for k, v in extra_state.items()}
                 if extra_state else None)
        self.wait()  # backpressure + surface a previous write's failure
        self._inflight = self._pool.submit(
            save_round, self.ckpt_dir, round_idx, net, server_opt_state,
            rng, list(history) if history is not None else None, self.keep,
            extra, num_heads)

    def wait(self) -> None:
        if self._inflight is not None:
            fut, self._inflight = self._inflight, None
            fut.result()  # re-raises a failed write

    def close(self) -> None:
        try:
            self.wait()
        finally:
            self._pool.shutdown(wait=True)

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None:
            self.close()
            return
        # already unwinding: a failed background write must not REPLACE
        # the real exception as the propagating error
        try:
            self.close()
        except Exception:  # noqa: BLE001
            import logging

            logging.getLogger("fedml_tpu_torch.checkpoint").exception(
                "async checkpoint write failed while unwinding %r", exc)


# ---------------------------------------------------------------- restore
_ROUND_RE = re.compile(r"^round_(\d{6})(\.npz)?$")


def _completed_rounds(ckpt_dir: str) -> list[int]:
    """Only COMPLETED checkpoints: 'round_NNNNNN' dirs or '.npz' files —
    half-written '.npz.tmp' files from a crash mid-save must not be
    offered for resume."""
    return [int(m.group(1))
            for d in os.listdir(ckpt_dir) if (m := _ROUND_RE.match(d))]


def latest_round(ckpt_dir: str) -> int | None:
    if not os.path.isdir(ckpt_dir):
        return None
    rounds = _completed_rounds(ckpt_dir)
    return max(rounds) if rounds else None


def restore_round(ckpt_dir: str, round_idx: int, template: Any,
                  num_heads: int | None = None):
    """Restore a checkpoint into the structure of ``template`` (a dict
    with net/server_opt_state/rng/round built like in save_round; the
    restored net lands on the template net's device).

    Raises :class:`TornCheckpoint` when the file cannot be LOADED (a crash
    mid-write left a truncated container) — structure/shape mismatches
    against the template stay ValueError (a configuration error, never a
    torn artifact)."""
    path = os.path.join(ckpt_dir, f"round_{round_idx:06d}")
    if os.path.isdir(path):
        raise ValueError(
            f"{path} is an orbax checkpoint directory; the port reads the "
            "npz layout only (write it from the JAX package without orbax)")
    try:
        npz = np.load(path + ".npz", allow_pickle=False)
    except (OSError, EOFError, ValueError) as e:
        raise TornCheckpoint(f"unloadable checkpoint {path}.npz: {e}")
    except Exception as e:  # noqa: BLE001 — np.load raises BadZipFile /
        # zlib.error on truncation; anything else load-phase is torn too
        if type(e).__name__ not in ("BadZipFile", "error"):
            raise
        raise TornCheckpoint(f"unloadable checkpoint {path}.npz: {e}")
    shapes, treedef = _layout(template, num_heads)
    # leaves map to the template purely by index, so a template whose
    # structure differs from the saved one (e.g. a dp run's checkpoint —
    # which carries a dp_rdp leaf that sorts FIRST — resumed without dp)
    # would silently shift every leaf by one; fail loudly instead
    n_saved = sum(1 for k in npz.files if k.startswith("leaf_"))
    if n_saved != len(shapes) or str(npz["treedef"]) != treedef:
        raise ValueError(
            f"checkpoint structure mismatch at {path}.npz: saved "
            f"{n_saved} leaves / treedef {npz['treedef']}, template has "
            f"{len(shapes)} leaves / treedef {treedef} — was the run "
            "configuration changed across resume?")
    try:
        # members decompress lazily — a mid-file truncation that spared
        # the zip directory still surfaces here, as torn, not as a crash
        restored = [npz[f"leaf_{i}"] for i in range(len(shapes))]
    except Exception as e:  # noqa: BLE001 — BadZipFile/zlib.error/EOFError
        raise TornCheckpoint(f"truncated checkpoint member in {path}.npz: {e}")
    for i, (t, r) in enumerate(zip(shapes, restored)):
        if t != np.shape(r):
            raise ValueError(
                f"checkpoint leaf {i} shape mismatch at {path}.npz: "
                f"saved {np.shape(r)}, template {t}")
    return _unflatten_state(template, restored, num_heads)


def restore_latest(ckpt_dir: str, template: Any,
                   num_heads: int | None = None):
    """Restore the newest RESTORABLE checkpoint: a torn newest file is
    skipped — counted on ``fed_ckpt_torn_total`` and warned — and recovery
    falls back to the previous round instead of crashing the restart loop.
    Returns ``(round_idx, state)`` or ``None`` when nothing is
    restorable."""
    import logging

    if not os.path.isdir(ckpt_dir):
        return None
    log = logging.getLogger("fedml_tpu_torch.checkpoint")
    for r in sorted(_completed_rounds(ckpt_dir), reverse=True):
        try:
            return r, restore_round(ckpt_dir, r, template, num_heads)
        except TornCheckpoint as e:
            from fedml_tpu_torch.obs import perf_instrument as _perf

            _perf.record_ckpt_torn()
            log.warning("skipping torn checkpoint round %d: %s "
                        "(falling back to the previous round)", r, e)
    return None


def _prune(ckpt_dir: str, keep: int):
    import shutil

    rounds = sorted(
        d for d in os.listdir(ckpt_dir)
        if d.startswith("round_") and not d.endswith(".tmp")
    )
    for d in rounds[:-keep] if keep else []:
        p = os.path.join(ckpt_dir, d)
        shutil.rmtree(p, ignore_errors=True) if os.path.isdir(p) else os.remove(p)
