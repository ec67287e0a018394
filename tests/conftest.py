"""Shared test helpers.

IMPORTANT: no global XLA_FLAGS here — unit tests and smoke tests must see the
real single CPU device. Multi-device tests spawn a subprocess with
``--xla_force_host_platform_device_count`` via ``run_multidevice``.
"""
from __future__ import annotations

import os
import subprocess
import sys
import textwrap

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "src")


def run_multidevice(code: str, n_devices: int = 8, timeout: int = 600) -> str:
    """Run a python snippet in a subprocess with N fake CPU devices."""
    env = dict(os.environ)
    env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={n_devices}"
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(code)],
        capture_output=True, text=True, timeout=timeout, env=env,
    )
    if proc.returncode != 0:
        raise AssertionError(
            f"multidevice subprocess failed (rc={proc.returncode}):\n"
            f"--- stdout ---\n{proc.stdout}\n--- stderr ---\n{proc.stderr[-4000:]}"
        )
    return proc.stdout


@pytest.fixture(scope="session")
def rng():
    import numpy as np
    return np.random.default_rng(0)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card; skipped where there is none")
