"""Mesh conventions of the port (twin of ``repro.distributed``): the axis
names and a world of one device. The chunked collectives and FSDP wait for
their own slice (ROADMAP Queue 1)."""
from repro_torch.distributed.mesh import DATA, MODEL, POD, Mesh, MeshPlan, axis_size, make_mesh

__all__ = ["DATA", "MODEL", "POD", "Mesh", "MeshPlan", "axis_size", "make_mesh"]
