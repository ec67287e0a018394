"""Build and bind the hand-written CUDA kernels (nvcc + ctypes).

Every source in ``csrc/`` has a plain ``extern "C"`` interface, so each
compiles with ``nvcc`` alone in seconds and the objects link into one shared
library that loads with ``ctypes`` — no PyTorch headers, no extension build.
The sources compile in parallel (one ``nvcc`` process each, all started
together), then one ``nvcc`` links them. The library is built at first use
from the sources in this checkout into ``build/repro_torch/`` at the
checkout's root (git-ignored); its file name carries a hash of every source
and the flags, so an edited source never loads a stale build.

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
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
COMPILE_FLAGS = (*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LINK_FLAGS = (*ARCH, "-shared")

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


def sources() -> list[Path]:
    """The ``.cu`` files that make up the library, in a fixed order."""
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    """Where the library of these exact sources (and headers) and flags lives."""
    key = hashlib.sha256(" ".join(COMPILE_FLAGS + LINK_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh")):
        key.update(path.name.encode() + b"\0" + path.read_bytes() + b"\0")
    return BUILD_DIR / f"libkernels-{key.hexdigest()[:12]}.so"


def _run(cmds: list[list[str]]) -> str:
    """Run the commands side by side, wait for all, raise if any failed."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for cmd in cmds]
    outs = [p.communicate() for p in procs]
    for cmd, p, (out, err) in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(
                f"nvcc failed (rc={p.returncode}): {' '.join(cmd)}\n{out}\n{err}")
    return "\n".join((out + err).strip() for out, err in outs)


def build() -> Path:
    """Compile and link ``csrc/*.cu`` unless these exact sources are built."""
    out = library_path()
    if out.exists():
        BUILD_INFO.update(path=str(out), seconds=0.0, cached=True, log="")
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}.{threading.get_ident()}"
    nvcc = nvcc_path()
    objs = [BUILD_DIR / f"{src.stem}.{tag}.o" for src in sources()]
    tmp = out.with_name(f"{out.name}.{tag}.tmp")
    t0 = time.perf_counter()
    try:
        log = _run([[nvcc, *COMPILE_FLAGS, "-c", "-o", str(obj), str(src)]
                    for src, obj in zip(sources(), objs)])
        log += "\n" + _run([[nvcc, *LINK_FLAGS, "-o", str(tmp), *map(str, objs)]])
        os.replace(tmp, out)              # atomic: concurrent builders agree
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    BUILD_INFO.update(path=str(out), seconds=time.perf_counter() - t0, cached=False,
                      log=log.strip())
    return out


def load() -> ctypes.CDLL:
    """Build if needed, load once, and declare every C signature."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build()))
        vp, ll, ci = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.ck_layout.argtypes = [ctypes.POINTER(ci)]
        lib.ck_layout.restype = ci
        lib.ck_checksum.argtypes = [ci, vp, ll, ll, vp, vp, vp, vp, vp, vp, vp]
        lib.ck_checksum.restype = ci
        lib.ck_error_string.argtypes = [ci]
        lib.ck_error_string.restype = ctypes.c_char_p
        lib.mm_layout.argtypes = [ctypes.POINTER(ci)]
        lib.mm_layout.restype = ci
        lib.mm_digest.argtypes = [ci, vp, vp, ci, vp, vp, ll, ll, ll, vp, vp, vp, vp, ci, vp]
        lib.mm_digest.restype = ci
        lib.mm_split.argtypes = [ci, vp, vp, ll, ll, ci, vp]
        lib.mm_split.restype = ci
        lib.mm_product.argtypes = [ci, vp, vp, vp, ll, ll, ll, ci, vp]
        lib.mm_product.restype = ci
        _lib = lib
        return lib


def layout(lib: ctypes.CDLL) -> tuple[int, int, int]:
    """(tile words, threads per tile block, factors per base) of the digest build."""
    buf = (ctypes.c_int * 3)()
    lib.ck_layout(buf)
    return int(buf[0]), int(buf[1]), int(buf[2])


def mm_layout(lib: ctypes.CDLL) -> tuple[int, ...]:
    """The matmul build's tiling: (C tile rows, C tile columns, K slab,
    threads, ring stages, row blocks a tile-order group, bf16 terms of a
    float32 B)."""
    buf = (ctypes.c_int * 7)()
    lib.mm_layout(buf)
    return tuple(int(v) for v in buf)
