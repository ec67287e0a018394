"""Mesh axis conventions, the world of ranks, and meshes over it.

Twin of ``repro.distributed.mesh``. The axis names are the reference's:

  pod    — cross-pod data parallelism (the slow, WAN-like hop)
  data   — intra-pod data parallelism
  model  — tensor parallelism

The port is multi-controller, PyTorch's idiom: one process a device, and a
``torch.distributed`` process group a mesh axis. ``init_world`` joins this
process to its world (NCCL for the card, gloo for the host: the backend
follows from the device asked for, never from what is installed).
``make_mesh`` over one device is a plain ``Mesh`` of this process; over
more it lays the axes row-major over the world's ranks (as
``jax.make_mesh`` does) with ``init_device_mesh``, and this rank runs on
``cuda:{LOCAL_RANK}`` (or the host). A mesh larger than the world raises
``RuntimeError``, as the reference's ``launch.train.parse_mesh`` does; a
``model`` axis over 1 raises ``NotImplementedError`` until tensor
parallelism is ported (ROADMAP Queue 1). The ``shard_map`` shims of the
reference have no counterpart.
"""
from __future__ import annotations

import dataclasses
import datetime
import math
import os
from typing import Any

import torch
import torch.distributed as dist

POD, DATA, MODEL = "pod", "data", "model"

# A hung ring raises after this long instead of waiting forever.
WORLD_TIMEOUT = datetime.timedelta(seconds=600)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Named axes over ranks. ``devices`` holds what this process drives
    (its one device); ``device_mesh`` is the world's ``DeviceMesh``, None on
    a mesh of one device."""

    shape: dict[str, int]
    devices: tuple[torch.device, ...]
    device_mesh: Any = None

    @property
    def axis_names(self) -> tuple[str, ...]:
        return tuple(self.shape)

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    @property
    def device(self) -> torch.device:
        return self.devices[0]

    def group(self, axis: str):
        """The process group of ``axis`` through this rank (None on a mesh
        of one device)."""
        return None if self.device_mesh is None else self.device_mesh.get_group(axis)

    def rank(self, axis: str) -> int:
        """This rank's index along ``axis``."""
        return 0 if self.device_mesh is None else self.device_mesh.get_local_rank(axis)


def available_devices(device="cuda") -> list[torch.device]:
    """The devices a mesh may use: every card for "cuda", one host for "cpu"."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device!r} requested but no CUDA device is available "
                "(pass device='cpu' to run on the host)")
        if dev.index is not None:
            return [dev]
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    if dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}")
    return [dev]


def _backend(device) -> str:
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def init_world(device="cuda", init_method: str = "env://") -> int:
    """Join this process to its world and return the world's size.

    Reads ``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK`` (the variables
    ``python -m torch.distributed.run`` sets). The backend is NCCL for
    "cuda", with this rank bound to ``cuda:{LOCAL_RANK}`` before the first
    operation, and gloo for "cpu". Every operation of the world times out
    after ``WORLD_TIMEOUT``. A world that is already up is kept, if its
    backend is the device's."""
    available_devices(device)
    want = _backend(device)
    if dist.is_initialized():
        have = dist.get_backend()
        if have != want:
            raise RuntimeError(f"this world runs {have}; device {device!r} needs {want}")
        return dist.get_world_size()
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    kw = {}
    if want == "nccl":
        local = torch.device("cuda", int(os.environ.get("LOCAL_RANK", rank)))
        torch.cuda.set_device(local)
        kw["device_id"] = local
    dist.init_process_group(want, init_method=init_method, rank=rank, world_size=world,
                            timeout=WORLD_TIMEOUT, **kw)
    return world


def world_size(device="cuda") -> int:
    """Ranks in this process's world: the initialised world's, after joining
    the one ``python -m torch.distributed.run`` describes (``WORLD_SIZE``);
    else 1, this process."""
    available_devices(device)
    if not dist.is_initialized() and int(os.environ.get("WORLD_SIZE", "1")) > 1:
        init_world(device)
    return dist.get_world_size() if dist.is_initialized() else 1


def is_primary() -> bool:
    """Rank 0 of the world, or a process outside any world."""
    return not dist.is_initialized() or dist.get_rank() == 0


def make_mesh(axis_shapes, axis_names, *, devices=None, device="cuda") -> Mesh:
    """A ``Mesh`` of ``axis_shapes`` named ``axis_names``: over one device,
    the first of ``devices`` (by default of ``device``); over more, the
    world's ranks, one device each."""
    shapes, names = tuple(int(s) for s in axis_shapes), tuple(axis_names)
    if len(shapes) != len(names):
        raise ValueError(f"{len(shapes)} axis sizes for {len(names)} names")
    n = math.prod(shapes)
    if n == 1:
        devs = list(devices) if devices is not None else available_devices(device)
        if not devs:
            raise RuntimeError(f"mesh {shapes} needs 1 device, have 0")
        return Mesh(dict(zip(names, shapes)), (torch.device(devs[0]),))
    world = world_size(device)
    if world < n:
        raise RuntimeError(f"mesh {shapes} needs {n} devices, have {world}")
    if world != n:
        raise RuntimeError(f"mesh {shapes} of {n} ranks in a world of {world}: "
                           "a mesh spans the whole world")
    if dict(zip(names, shapes)).get(MODEL, 1) > 1:
        raise NotImplementedError(
            f"a model axis of {dict(zip(names, shapes))[MODEL]} needs tensor parallelism, "
            "not ported yet (ROADMAP Queue 1)")
    from torch.distributed.device_mesh import init_device_mesh

    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    dm = init_device_mesh(dev.type, shapes, mesh_dim_names=names)
    return Mesh(dict(zip(names, shapes)), (dev,), dm)


def axis_size(mesh: Mesh, name: str) -> int:
    return mesh.shape[name] if name in mesh.axis_names else 1


@dataclasses.dataclass(frozen=True)
class MeshPlan:
    """Resolved parallelism plan for a given mesh."""

    mesh: Mesh

    @property
    def n_pods(self) -> int:
        return axis_size(self.mesh, POD)

    @property
    def dp(self) -> int:
        return axis_size(self.mesh, DATA)

    @property
    def tp(self) -> int:
        return axis_size(self.mesh, MODEL)

    @property
    def n_devices(self) -> int:
        return self.mesh.size

    def describe(self) -> str:
        return (
            f"mesh{tuple(self.mesh.shape.values())} axes={self.mesh.axis_names} "
            f"pods={self.n_pods} dp={self.dp} tp={self.tp} devices={self.n_devices}"
        )
