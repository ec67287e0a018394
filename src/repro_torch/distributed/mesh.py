"""Mesh axis conventions, and a mesh of one device.

Twin of ``repro.distributed.mesh``. The axis names are the reference's:

  pod    — cross-pod data parallelism (the slow, WAN-like hop)
  data   — intra-pod data parallelism
  model  — tensor parallelism

The port runs a world of one device so far: ``make_mesh`` builds a plain
``Mesh`` over one device and raises for more. A mesh over more devices than
there are raises as the reference's ``launch.train.parse_mesh`` does; a mesh
over several devices that exist raises ``NotImplementedError`` until the
chunked collectives are ported (ROADMAP Queue 1, ``distributed/``). The
``shard_map`` shims of the reference have no counterpart.
"""
from __future__ import annotations

import dataclasses
import math

import torch

POD, DATA, MODEL = "pod", "data", "model"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Named axes over a grid of devices (one device in the port)."""

    shape: dict[str, int]
    devices: tuple[torch.device, ...]

    @property
    def axis_names(self) -> tuple[str, ...]:
        return tuple(self.shape)

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    @property
    def device(self) -> torch.device:
        return self.devices[0]


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


def make_mesh(axis_shapes, axis_names, *, devices=None, device="cuda") -> Mesh:
    """A ``Mesh`` of ``axis_shapes`` named ``axis_names`` over ``devices``
    (by default those of ``device``)."""
    shapes, names = tuple(int(s) for s in axis_shapes), tuple(axis_names)
    if len(shapes) != len(names):
        raise ValueError(f"{len(shapes)} axis sizes for {len(names)} names")
    n = math.prod(shapes)
    devs = list(devices) if devices is not None else available_devices(device)
    if len(devs) < n:
        raise RuntimeError(f"mesh {shapes} needs {n} devices, have {len(devs)}")
    if n > 1:
        raise NotImplementedError(
            f"a mesh over {n} devices needs the chunked collectives of "
            "repro_torch.distributed (ROADMAP Queue 1, distributed/); the port "
            "runs a world of one device")
    return Mesh(dict(zip(names, shapes)), tuple(torch.device(d) for d in devs[:n]))


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
