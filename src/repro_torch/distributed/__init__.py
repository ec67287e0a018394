"""Distribution layer, twin of ``repro.distributed``: the mesh axes and the
world of ranks (``mesh``), the chunked collectives over a process group
(``chunked``) and the chunked cross-pod gradient sync (``fsdp``)."""
from repro_torch.distributed.chunked import (
    ag_matmul,
    chunked_all_gather,
    chunked_all_reduce,
    chunked_reduce_scatter,
    default_n_chunks,
    matmul_rs,
)
from repro_torch.distributed.fsdp import cross_pod_mean
from repro_torch.distributed.mesh import (
    DATA, MODEL, POD, Mesh, MeshPlan, axis_size, init_world, make_mesh,
)

__all__ = [
    "ag_matmul", "chunked_all_gather", "chunked_all_reduce",
    "chunked_reduce_scatter", "default_n_chunks", "matmul_rs",
    "cross_pod_mean",
    "DATA", "MODEL", "POD", "Mesh", "MeshPlan", "axis_size", "init_world", "make_mesh",
]
