#!/usr/bin/env python3
"""Where the bf16 matmul_digest kernel's time goes, on one CUDA card.

    python3 tools/matmul_digest_diag.py

Run from the root of a checkout. Builds variants of
``src/repro_torch/kernels/csrc/matmul_digest.cu`` by text substitution
(into ``build/dev/diag/``, git-ignored) and times each, fused and
product-only (``mm_product``), in turns (forward, then backward), at
chip_smoke.py's matmul shape: (14336 x 5120) @ (5120 x 4096) bf16, beside
cuBLAS. The variants: ``production`` (the source as it is); ``no_store``
(the epilogue stores no C: the stores' share of the time); ``group1``,
``group8``, ``group32`` (the tile order's group of row blocks, 16 in the
source: what the L2 order is worth). A variant's C or residues are not
checked; it is a measurement, not a kernel of the port.
"""
import os, sys, time, ctypes
sys.path.insert(0, "src")
import torch
from repro_torch.kernels import _build
from repro_torch.kernels import matmul_digest as mm

src = (_build.CSRC / "matmul_digest.cu").read_text()
STORE = "        if (col < N) {                        // N even: col + 1 < N too"
GROUP = "constexpr int kGroupM = 16;"
assert STORE in src and GROUP in src
variants = {
    "production": src,
    "no_store": src.replace(STORE, "        if (col < 0) {"),
    "group1": src.replace(GROUP, "constexpr int kGroupM = 1;"),
    "group8": src.replace(GROUP, "constexpr int kGroupM = 8;"),
    "group32": src.replace(GROUP, "constexpr int kGroupM = 32;"),
}
nvcc = _build.nvcc_path()
root = _build.BUILD_DIR.parent / "dev" / "diag"
cmds = []
for k, v in variants.items():
    d = root / k; d.mkdir(parents=True, exist_ok=True)
    (d / "matmul_digest.cu").write_text(v)
    cmds.append([nvcc, *_build.COMPILE_FLAGS, "-c", "-o", str(d / "mm.o"),
                 str(d / "matmul_digest.cu")])
cmds.append([nvcc, *_build.COMPILE_FLAGS, "-c", "-o", str(root / "ck.o"),
             str(_build.CSRC / "checksum.cu")])
t0 = time.time()
_build._run(cmds)
print(f"built {len(cmds)} in {time.time() - t0:.1f} s")
_build._run([[nvcc, *_build.LINK_FLAGS, "-o", str(root / k / "lib.so"), str(root / k / "mm.o"),
              str(root / "ck.o")] for k in variants])
vp, ll, ci = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
libs = {}
for k in variants:
    lib = ctypes.CDLL(str(root / k / "lib.so"))
    lib.mm_digest.argtypes = [ci, vp, vp, ci, vp, vp, ll, ll, ll, vp, vp, vp, vp, ci, vp]
    lib.mm_product.argtypes = [ci, vp, vp, vp, ll, ll, ll, ci, vp]
    libs[k] = lib
dev = torch.device("cuda", 0)
gen = torch.Generator(device=dev); gen.manual_seed(5)
M, K, N = 14336, 5120, 4096
A = (torch.randn(M, K, generator=gen, device=dev) * 0.02).to(torch.bfloat16)
B = torch.randn(K, N, generator=gen, device=dev).to(torch.bfloat16)
row_w, col_w16 = mm._factors_on(M, K, 128, 128, dev)
sms = torch.cuda.get_device_properties(dev).multi_processor_count
C = torch.empty(M, N, device=dev); part = torch.empty(sms, 4, dtype=torch.int32, device=dev)
out = torch.empty(4, dtype=torch.int32, device=dev)
stream = torch.cuda.current_stream().cuda_stream
def fused(lib):
    assert lib.mm_digest(0, A.data_ptr(), B.data_ptr(), 0, None, C.data_ptr(), M, N, K,
                         row_w.data_ptr(), col_w16.data_ptr(),
                         part.data_ptr(), out.data_ptr(), sms, stream) == 0
def prod(lib):
    assert lib.mm_product(0, A.data_ptr(), B.data_ptr(), C.data_ptr(), M, N, K, sms, stream) == 0
def ms(fn, it=20):
    fn(); torch.cuda.synchronize()
    s, e = torch.cuda.Event(True), torch.cuda.Event(True)
    s.record()
    for _ in range(it): fn()
    e.record(); e.synchronize()
    return s.elapsed_time(e) / it
calls = {}
for k in variants:
    calls[f"{k} fused"] = (lambda lib=libs[k]: fused(lib))
    calls[f"{k} product"] = (lambda lib=libs[k]: prod(lib))
calls["cublas"] = lambda: torch.mm(A, B, out_dtype=torch.float32)
res = {k: [] for k in calls}
for order in (list(calls), list(reversed(calls))):
    for k in order:
        res[k].append(ms(calls[k]))
for k, v in res.items():
    print(f"diag {k:22s} {sum(v) / len(v):.4f} ms  runs {[round(x, 4) for x in v]}")
