"""Production mesh construction.

Twin of ``repro.launch.mesh``. A single pod is the reference's 16x16 slice
(256 devices); multi-pod adds a leading "pod" axis (2x16x16, 512 devices).
A mesh of more than one device spans the world of ranks
(``distributed.mesh.make_mesh``): ``make_host_mesh((2, 2, 1), ("pod",
"data", "model"))`` or its default (2, 2) over (data, model) on four
ranks, ``(1, 1)`` on one. The production meshes raise on fewer ranks. The
dry run builds them inside ``fake_world(256)`` or ``fake_world(512)``: this
process is rank 0 of a world whose collectives move nothing
(``torch.testing._internal.distributed.fake_pg``, a private module of
torch, checked on 2.13.0+cpu and 2.11.0+cu128). Defined as functions so
that importing this module touches no device state.
"""
from __future__ import annotations

import contextlib
import math

import torch.distributed as dist

from repro_torch.distributed.mesh import available_devices, make_mesh, world_size


@contextlib.contextmanager
def fake_world(n: int, device="cuda"):
    """This process as rank 0 of a world of ``n`` ranks that exist nowhere:
    every collective returns at once and moves nothing, so a step over a
    production mesh runs (on fake tensors) in one process. Refuses inside a
    real world; the world is destroyed on the way out, whatever happened
    inside, so nothing after it sees a world it did not make. Sets no
    environment variable."""
    available_devices(device)
    if dist.is_initialized():
        raise RuntimeError(
            f"a world of {dist.get_world_size()} ranks ({dist.get_backend()}) is up: "
            "a fake world runs only in a process outside any world")
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", rank=0, world_size=n, store=FakeStore())
    try:
        yield n
    finally:
        dist.destroy_process_group()


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
            f"need {n} devices for mesh {shape}, have {have} — a dry run builds "
            f"it inside fake_world({n})")
    return make_mesh(shape, axes, device=device)


def make_host_mesh(shape=(2, 2), axes=("data", "model"), device="cuda"):
    """Small mesh over the ranks that exist: (1, 1) on one; on four, (2, 2)
    over ("data", "model") or (2, 2, 1) over ("pod", "data", "model")."""
    n = math.prod(shape)
    have = _have(n, device)
    if have < n:
        raise RuntimeError(f"need {n} devices, have {have}")
    return make_mesh(shape, axes, device=device)
