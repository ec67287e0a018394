"""Build and bind the hand-written CUDA kernels (nvcc + ctypes).

``csrc/checksum.cu`` has a plain ``extern "C"`` interface, so it compiles
with ``nvcc`` alone into a shared library in seconds and loads with
``ctypes`` — no PyTorch headers, no extension build. The library is built
at first use from the sources in this checkout into ``build/repro_torch/``
at the checkout's root (git-ignored); its file name carries a hash of the
source and the flags, so an edited source never loads a stale build.

Nothing here runs at import: the CPU tests import every module, and this
machine may have no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCE = CSRC / "checksum.cu"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
# what the last build did: library path, seconds, ptxas resource summary
BUILD_INFO: dict = {}


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH,
    else the toolkit's default install location."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
        return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path() -> Path:
    key = hashlib.sha256(SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libchecksum-{key.hexdigest()[:12]}.so"


def build() -> Path:
    """Compile ``checksum.cu`` unless this exact source is already built."""
    out = library_path()
    if out.exists():
        BUILD_INFO.update(path=str(out), seconds=0.0, cached=True, log="")
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed (rc={proc.returncode}): {' '.join(cmd)}\n"
            f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)                  # atomic: concurrent builders agree
    BUILD_INFO.update(path=str(out), seconds=seconds, cached=False,
                      log=(proc.stdout + proc.stderr).strip())
    return out


def load() -> ctypes.CDLL:
    """Build if needed, load once, and declare every C signature."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build()))
        vp, ll = ctypes.c_void_p, ctypes.c_longlong
        lib.ck_layout.argtypes = [ctypes.POINTER(ctypes.c_int)]
        lib.ck_layout.restype = ctypes.c_int
        lib.ck_checksum.argtypes = [ctypes.c_int, vp, ll, ll, vp, vp, vp, vp, vp, vp, vp]
        lib.ck_checksum.restype = ctypes.c_int
        lib.ck_error_string.argtypes = [ctypes.c_int]
        lib.ck_error_string.restype = ctypes.c_char_p
        _lib = lib
        return lib


def layout(lib: ctypes.CDLL) -> tuple[int, int, int]:
    """(tile words, threads per tile block, factors per base) of the build."""
    buf = (ctypes.c_int * 3)()
    lib.ck_layout(buf)
    return int(buf[0]), int(buf[1]), int(buf[2])
