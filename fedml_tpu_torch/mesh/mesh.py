"""Process mesh over an initialized ``torch.distributed`` world, port of
``make_2d_mesh`` (fedml_tpu/mesh/mesh.py:33-48).

The JAX package lays a 2-D ``Mesh`` over the devices of one controller.
The port is multi-controller: every rank of the world runs the same
program, so a mesh is the world's ranks laid out row-major on a
``(major, minor)`` grid, and an axis is, for this rank, the process group
of the ranks that differ from it only along that axis. ``ProcessMesh``
keeps the reference's ``axis_names`` and ``shape`` and gives each axis a
handle (``AxisHandle``): its ``group``, this rank's ``index`` along it and
its ``size``. The collectives (fedml_tpu_torch.collectives.ops) and the
sequence-parallel attentions take a handle where the JAX package takes an
axis name.

Every rank must call ``make_2d_mesh`` with the same arguments: it creates
one group per row and one per column with ``dist.new_group``, in the same
order on every rank, as ``new_group`` requires. A rank of the world past
the mesh's ``n`` ranks joins every ``new_group`` call but holds no
coordinates (``ProcessMesh.member`` is False) and no axis handles.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class AxisHandle:
    """One mesh axis as this rank sees it: the ``group`` of the ranks along
    it (global ranks ``ranks``, in axis order), this rank's ``index`` in
    it and its ``size``."""

    name: str
    group: object
    ranks: tuple
    index: int
    size: int

    @property
    def backend(self) -> str:
        return str(dist.get_backend(self.group))


class ProcessMesh:
    """A 2-D grid of the world's ranks (``devices``, row-major) with named
    axes; ``mesh[name]`` (or ``mesh.axis(name)``) is this rank's handle of
    that axis."""

    def __init__(self, devices: np.ndarray, axis_names: tuple,
                 handles: dict, rank: int):
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, devices.shape))
        self.rank = rank
        self._handles = handles

    @property
    def member(self) -> bool:
        return bool(self._handles)

    def axis(self, name: str) -> AxisHandle:
        if name not in self.axis_names:
            raise KeyError(f"no axis {name!r} in mesh {self.axis_names}")
        if not self.member:
            raise ValueError(f"rank {self.rank} is not in the mesh "
                             f"{self.devices.tolist()}")
        return self._handles[name]

    __getitem__ = axis

    def __repr__(self):
        return (f"ProcessMesh({self.shape}, rank={self.rank}, "
                f"devices={self.devices.tolist()})")


def make_2d_mesh(n_devices: int | None, minor: int,
                 axes: tuple[str, str]) -> ProcessMesh:
    """2-D (major, minor) mesh over the first n_devices ranks of the world
    (None/0 = all). Raises clear errors, in the reference's words, when the
    rank budget is exceeded or not divisible by ``minor``."""
    if not dist.is_initialized():
        raise RuntimeError("make_2d_mesh needs an initialized "
                           "torch.distributed world (init_process_group)")
    avail = dist.get_world_size()
    n = n_devices or avail
    if n > avail:
        raise ValueError(f"--mesh {n} exceeds {avail} devices")
    if n % minor:
        raise ValueError(
            f"--mesh {n} not divisible by minor axis {minor} "
            f"(devices would be silently dropped)")
    grid = np.arange(n).reshape(n // minor, minor)
    rank = dist.get_rank()
    handles = {}
    # one group per column (the major axis), then one per row (the minor
    # axis): the same calls in the same order on every rank of the world
    for ax, lines in ((0, grid.T), (1, grid)):
        for line in lines:
            ranks = tuple(int(r) for r in line)
            group = dist.new_group(list(ranks))
            if rank in ranks:
                handles[axes[ax]] = AxisHandle(
                    axes[ax], group, ranks, ranks.index(rank), len(ranks))
    return ProcessMesh(grid, axes, handles, rank)
