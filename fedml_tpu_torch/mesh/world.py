"""A ``torch.distributed`` world of local processes, for a mesh on one
host: a gloo world on the CPU, or several ranks sharing one card.

    results = spawn("pkg.module:function", world_size=4, args=(...),
                    deadline_s=120)
    world = World(...).start(); ...; results = world.join()

starts ``world_size`` fresh Python processes (``python -m
fedml_tpu_torch.mesh.world``), each joining a gloo world through a
``FileStore`` in its own temporary directory, runs ``function(*args)`` on
every rank and returns the ranks' return values in rank order (each saved
with ``torch.save``, so tensors come back on the device they were on).
Any rank that exits non-zero, or a world that misses ``deadline_s``, kills
every rank and raises ``RuntimeError`` with the tail of each rank's log.
A program started by ``torchrun`` calls ``dist.init_process_group``
itself instead.
"""

from __future__ import annotations

import datetime
import importlib
import os
import pickle
import shutil
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path

import torch
import torch.distributed as dist

ROOT = Path(__file__).resolve().parents[2]


def _resolve(target: str):
    module, _, name = target.partition(":")
    return getattr(importlib.import_module(module), name)


class World:
    """A world of local rank processes running ``target`` ("module:
    function"): ``start()`` launches them and returns at once, ``join()``
    waits for them (see ``spawn``)."""

    def __init__(self, target: str, world_size: int, args: tuple = (), *,
                 deadline_s: float, sys_path: tuple = (),
                 workdir: str | None = None):
        self.target, self.world_size, self.args = target, world_size, args
        self.deadline_s = deadline_s
        self.sys_path, self._own = sys_path, workdir is None
        self.work = Path(tempfile.mkdtemp(prefix="world-")
                         if workdir is None else workdir)
        self.procs, self.logs = [], []

    def start(self) -> "World":
        work = self.work
        work.mkdir(parents=True, exist_ok=True)
        spec = work / "spec.pkl"
        spec.write_bytes(pickle.dumps(dict(
            target=self.target, args=self.args,
            world_size=self.world_size, store=str(work / "store"),
            timeout_s=self.deadline_s)))
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            [str(ROOT), *map(str, self.sys_path)]
            + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
        # gloo pairs ranks over the loopback device: a local world needs
        # no other interface (and a sealed machine may resolve no hostname)
        env.setdefault("GLOO_SOCKET_IFNAME", "lo")
        self._end = time.monotonic() + self.deadline_s
        try:
            for r in range(self.world_size):
                log = open(work / f"rank{r}.log", "wb")
                self.logs.append(log)
                self.procs.append(subprocess.Popen(
                    [sys.executable, "-m", "fedml_tpu_torch.mesh.world",
                     str(spec), str(r)],
                    stdout=log, stderr=subprocess.STDOUT,
                    env={**env, "RANK": str(r), "LOCAL_RANK": str(r),
                         "WORLD_SIZE": str(self.world_size)}))
        except BaseException:
            self._stop()
            raise
        return self

    def join(self) -> list:
        """Every rank's return value, in rank order; raises RuntimeError
        (every rank killed) on a failed rank or a missed deadline."""
        try:
            failed = None
            while failed is None:
                codes = [p.poll() for p in self.procs]
                bad = [r for r, c in enumerate(codes) if c not in (None, 0)]
                if bad:
                    failed = (f"rank(s) {bad} exited with "
                              f"{[codes[r] for r in bad]}")
                elif all(c == 0 for c in codes):
                    break
                elif time.monotonic() > self._end:
                    late = [r for r, c in enumerate(codes) if c is None]
                    failed = (f"ranks {late} still running after the "
                              f"{self.deadline_s:g} s deadline")
                else:
                    time.sleep(0.05)
            if failed is not None:
                raise RuntimeError(
                    f"world of {self.world_size} running {self.target}: "
                    f"{failed}\n{_tails(self.work, self.world_size)}")
            return [torch.load(self.work / f"rank{r}.out",
                               weights_only=False)
                    for r in range(self.world_size)]
        finally:
            self._stop()

    def _stop(self):
        for p in self.procs:  # every rank stops, whatever happened
            if p.poll() is None:
                p.kill()
            p.wait()
        for log in self.logs:
            log.close()
        if self._own:
            shutil.rmtree(self.work, ignore_errors=True)


def spawn(target: str, world_size: int, args: tuple = (), *,
          deadline_s: float, sys_path: tuple = (),
          workdir: str | None = None) -> list:
    """Run ``target`` ("module:function") on a world of ``world_size``
    local processes and return the ranks' results; see the module
    docstring. ``sys_path`` entries are put on the ranks' import path (the
    repository root always is)."""
    return World(target, world_size, args, deadline_s=deadline_s,
                 sys_path=sys_path, workdir=workdir).start().join()


def _tails(work: Path, world_size: int, nbytes: int = 3000) -> str:
    out = []
    for r in range(world_size):
        text = (work / f"rank{r}.log").read_bytes()[-nbytes:]
        out.append(f"--- rank {r} ---\n{text.decode(errors='replace')}")
    return "\n".join(out)


def _main(spec_path: str, rank: int) -> int:
    spec = pickle.loads(Path(spec_path).read_bytes())
    # one thread a rank: the ranks share the host's cores (and a test
    # run's workers)
    torch.set_num_threads(1)
    try:
        dist.init_process_group(
            "gloo", store=dist.FileStore(spec["store"], spec["world_size"]),
            rank=rank, world_size=spec["world_size"],
            timeout=datetime.timedelta(seconds=spec["timeout_s"]))
        out = _resolve(spec["target"])(*spec["args"])
        torch.save(out, Path(spec_path).with_name(f"rank{rank}.out"))
        dist.destroy_process_group()
    except BaseException:  # noqa: BLE001 — reported, then a non-zero exit
        traceback.print_exc()
        sys.stdout.flush()
        os._exit(1)  # a peer may be gone: skip the group's teardown
    return 0


if __name__ == "__main__":
    sys.exit(_main(sys.argv[1], int(sys.argv[2])))
