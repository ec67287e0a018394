"""Production mesh construction.

Twin of ``repro.launch.mesh``. A single pod is the reference's 16x16 slice
(256 devices); multi-pod adds a leading "pod" axis (2x16x16, 512 devices).
The port's world is one device so far: on it the production meshes raise,
and ``make_host_mesh((1, 1))`` is the mesh the dry run walks. Defined as
functions so that importing this module touches no device state.
"""
from __future__ import annotations

import math

from repro_torch.distributed.mesh import available_devices, make_mesh


def make_production_mesh(*, multi_pod: bool = False, device="cuda"):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = math.prod(shape)
    devices = available_devices(device)[:n]
    if len(devices) < n:
        raise RuntimeError(
            f"need {n} devices for mesh {shape}, have {len(devices)} — the port "
            "runs a world of one device until the collectives of "
            "repro_torch.distributed are ported (use mesh kind 'one')")
    return make_mesh(shape, axes, devices=devices)


def make_host_mesh(shape=(2, 2), axes=("data", "model"), device="cuda"):
    """Small mesh over however many devices exist: (1, 1) is the port's world."""
    n = math.prod(shape)
    devices = available_devices(device)[:n]
    if len(devices) < n:
        raise RuntimeError(f"need {n} devices, have {len(devices)}")
    return make_mesh(shape, axes, devices=devices)
