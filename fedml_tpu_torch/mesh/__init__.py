"""Process meshes over a ``torch.distributed`` world, port of
``make_2d_mesh`` from fedml_tpu/mesh (the rest of that module is ROADMAP.md
queue A, item 12), and a local world of processes to run one on
(``world.spawn``)."""

from fedml_tpu_torch.mesh.mesh import AxisHandle, ProcessMesh, make_2d_mesh

__all__ = ["AxisHandle", "ProcessMesh", "make_2d_mesh"]
