"""Production mesh construction.

Twin of ``repro.launch.mesh``. A single pod is the reference's 16x16 slice
(256 devices); multi-pod adds a leading "pod" axis (2x16x16, 512 devices).
A mesh of more than one device spans the world of ranks
(``distributed.mesh.make_mesh``): ``make_host_mesh((2, 2, 1), ("pod",
"data", "model"))`` or its default (2, 2) over (data, model) on four
ranks, ``(1, 1)`` on one. The production meshes
raise on fewer ranks, which is every world the port runs today. Defined as
functions so that importing this module touches no device state.
"""
from __future__ import annotations

import math

from repro_torch.distributed.mesh import available_devices, make_mesh, world_size


def _have(n: int, device) -> int:
    """Devices a mesh of ``n`` may use: the world's ranks for more than one,
    else this process's devices."""
    return world_size(device) if n > 1 else len(available_devices(device))


def make_production_mesh(*, multi_pod: bool = False, device="cuda"):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = math.prod(shape)
    have = _have(n, device)
    if have < n:
        raise RuntimeError(
            f"need {n} devices for mesh {shape}, have {have} — the port runs "
            "worlds of one to four ranks (use mesh kind 'one')")
    return make_mesh(shape, axes, device=device)


def make_host_mesh(shape=(2, 2), axes=("data", "model"), device="cuda"):
    """Small mesh over the ranks that exist: (1, 1) on one; on four, (2, 2)
    over ("data", "model") or (2, 2, 1) over ("pod", "data", "model")."""
    n = math.prod(shape)
    have = _have(n, device)
    if have < n:
        raise RuntimeError(f"need {n} devices, have {have}")
    return make_mesh(shape, axes, device=device)
