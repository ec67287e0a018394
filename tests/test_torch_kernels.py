"""The port's digest kernels against the JAX package's Pallas kernels.

Same seeded numpy inputs through ``repro.kernels`` (Pallas, interpret mode on
the CPU, as its own tests run it), through ``repro_torch.kernels`` (on the
CPU: the plain PyTorch versions) and through the exact host oracle
``repro.core.integrity.fingerprint_bytes``. Residues and copies must be
equal exactly. The CUDA kernels themselves run only on a card: the tests
marked ``gpu`` hold them against their plain versions there
(``python -m pytest -q -m gpu tests/test_torch_kernels.py``); here they skip.
JAX is imported inside the tests that compare with it, so the card's machine,
which has no JAX, can collect this file.
"""
import shutil

import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings, strategies as st
except ImportError:      # optional dev dep: deterministic fallback examples
    from _hypofallback import given, settings, strategies as st

from repro.core.integrity import fingerprint_bytes
from repro_torch import kernels as tk
from repro_torch.kernels import checksum as tck
from repro_torch.kernels import ref as tref

TILE = 64 * 128  # kernel tile in int32 words

SHAPES = [(TILE,), (TILE + 5,), (3 * TILE,), (17,), (1,), (257, 129), (64, 128, 3)]
DTYPES = [torch.float32, torch.int32, torch.bfloat16]


def _jax():
    import jax.numpy as jnp
    from repro import kernels as jk
    from repro.kernels import checksum as jck
    return jnp, jk, jck


def make(shape, dtype, seed) -> torch.Tensor:
    """Seeded CPU tensor made with numpy (bf16 rounded from float32)."""
    rng = np.random.default_rng(seed)
    if dtype == torch.int32:
        x = rng.integers(-2**31, 2**31 - 1, shape, dtype=np.int64).astype(np.int32)
        return torch.from_numpy(x)
    x = torch.from_numpy(rng.standard_normal(int(np.prod(shape))).astype(np.float32))
    return x.to(dtype).reshape(shape)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """The same bytes as a numpy array for JAX (bf16 through int16 bits)."""
    if t.dtype == torch.bfloat16:
        import ml_dtypes
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def byte_image(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().contiguous().reshape(-1).view(torch.uint8).numpy()


def host_digest(t: torch.Tensor):
    return fingerprint_bytes(byte_image(t))


def residues(r) -> tuple:
    return tuple(int(v) for v in np.asarray(r).reshape(-1))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


# ---------------------------------------------------------------------------
# public API parity: port == JAX kernel == host oracle
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_fingerprint_array_matches_jax_and_host(shape, dtype):
    jnp, jk, _ = _jax()
    x = make(shape, dtype, seed=len(shape) * 1000 + int(np.prod(shape)))
    host = host_digest(x)
    port = tk.digest_of(x)
    jax_res = residues(jk.fingerprint_array(jnp.asarray(to_numpy(x))))
    assert jax_res == host.h
    assert residues(tk.fingerprint_array(x)) == jax_res
    assert port.h == host.h and port.length == host.length == x.numel() * x.element_size()


@pytest.mark.parametrize("shape", [(TILE,), (2 * TILE,), (TILE + 100,), (17,)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_fingerprint_and_copy_matches_jax(shape, dtype):
    jnp, jk, _ = _jax()
    x = make(shape, dtype, seed=7 + int(np.prod(shape)))
    res, copy = tk.fingerprint_and_copy(x)
    jres, jcopy = jk.fingerprint_and_copy(jnp.asarray(to_numpy(x)))
    assert copy.shape == tuple(shape) and copy.dtype == x.dtype
    np.testing.assert_array_equal(byte_image(copy), byte_image(x))
    np.testing.assert_array_equal(byte_image(copy), np.asarray(jcopy).reshape(-1).view(np.uint8))
    assert residues(res) == residues(jres) == host_digest(x).h


def test_checksum_many_words_matches_jax_row_by_row():
    jnp, _, jck = _jax()
    rng = np.random.default_rng(3)
    k, nbytes = 4, 2 * jck.TILE_BYTES
    raw = rng.integers(0, 256, (k, nbytes), dtype=np.uint8)
    words = np.ascontiguousarray(raw).view(np.int32)
    got = tck.checksum_many_words(torch.from_numpy(words.copy()))
    want = np.asarray(jck.checksum_many_words(jnp.asarray(words)))
    assert got.shape == (k, 4) and got.dtype == torch.int32
    for i in range(k):
        assert residues(got[i]) == residues(want[i])
        assert residues(got[i]) == fingerprint_bytes(raw[i].tobytes()).h
        assert residues(tck.checksum_words(torch.from_numpy(words[i].copy()))) == \
            residues(want[i])


@given(st.integers(1, 3 * TILE + 11))
@settings(max_examples=20, deadline=None)
def test_digest_any_length(n):
    rng = np.random.default_rng(n)
    x = rng.standard_normal(n).astype(np.float32)
    t = torch.from_numpy(x)
    assert tk.digest_of(t).h == host_digest(t).h
    assert residues(tref.fingerprint_array_ref(t)) == host_digest(t).h


@pytest.mark.parametrize("dtype", [torch.uint8, torch.int16, torch.float64, torch.bool])
def test_other_dtypes_match_host(dtype):
    raw = np.random.default_rng(11).integers(0, 256, 5 * 8 * 37, dtype=np.uint8)
    x = torch.from_numpy(raw).view(dtype).reshape(5, -1)
    if dtype == torch.bool:
        x = torch.from_numpy(raw % 2 == 1).reshape(5, -1)
    got, want = tk.digest_of(x), host_digest(x)
    assert (got.h, got.length) == (want.h, want.length)


# ---------------------------------------------------------------------------
# the wrappers: checks, plain path on the CPU, launch counts
# ---------------------------------------------------------------------------
def test_tables_are_the_references_tables():
    _, _, jck = _jax()
    for mine, theirs in zip(tck._tables(tck.ROWS), jck._tables(jck.ROWS)):
        np.testing.assert_array_equal(mine, theirs)
    assert (tck.ROWS, tck.LANES, tck.TILE_WORDS, tck.TILE_BYTES) == \
        (jck.ROWS, jck.LANES, jck.TILE_WORDS, jck.TILE_BYTES)


def test_cuda_weight_factorisation_reproduces_w0():
    """The CUDA tile kernel weighs byte p of thread t's step i by G[t]*F[16i+p];
    that must be W0[m] * r^-k for the byte's word m and plane k."""
    w0, rinv, _ = tck._tables(tck.ROWS)
    g, f = tck._kernel_factors()
    T, iters = tck.THREADS, tck.TILE_WORDS // (4 * tck.THREADS)
    assert g.shape == (4, T) and f.shape == (4, 16 * iters)
    w0f = w0.reshape(4, -1).astype(np.int64)
    t = np.arange(T)[:, None, None]
    i = np.arange(iters)[None, :, None]
    p = np.arange(16)[None, None, :]
    m = 4 * t + 4 * T * i + p // 4                  # word of each byte
    for b in range(4):
        kernel_w = g[b].astype(np.int64)[:, None, None] * \
            f[b].reshape(iters, 16).astype(np.int64)[None] % tck.P
        want = w0f[b][m] * rinv[b].astype(np.int64)[p % 4] % tck.P
        np.testing.assert_array_equal(kernel_w, want)


def test_cuda_kernel_arithmetic_emulated():
    """The kernel's integer path, step for step in numpy: 32-bit per-thread
    sums over (step, byte), one reduction, the thread weight, the block
    sum, then the positional combine of tile hashes."""
    rng = np.random.default_rng(5)
    tiles = 3
    raw = rng.integers(0, 256, tiles * tck.TILE_BYTES, dtype=np.uint8)
    g, f = tck._kernel_factors()
    T, iters = tck.THREADS, tck.TILE_WORDS // (4 * tck.THREADS)
    # tile, step i, thread t, byte p  (thread t's vector of step i)
    v = raw.reshape(tiles, iters, T, 16).astype(np.uint64)
    h = np.empty((tiles, 4), np.uint64)
    for b in range(4):
        fb = f[b].reshape(iters, 16).astype(np.uint64)
        acc = (v * fb[None, :, None, :]).sum(axis=(1, 3))        # (tiles, T)
        assert acc.max() < 2**32                                  # 32-bit acc
        tw = acc % tck.P * g[b].astype(np.uint64)[None, :] % tck.P
        h[:, b] = tw.sum(axis=1) % tck.P
    pw = tck._tile_powers_host(tiles).astype(np.uint64)
    out = (h * pw).sum(axis=0) % tck.P
    assert tuple(int(x) for x in out) == fingerprint_bytes(raw.tobytes()).h


@pytest.mark.parametrize("bad, err", [
    (torch.zeros(TILE, dtype=torch.int64), TypeError),
    (torch.zeros(TILE + 1, dtype=torch.int32), ValueError),
    (torch.zeros(0, dtype=torch.int32), ValueError),
    (torch.zeros(2 * TILE, dtype=torch.int32)[::2], ValueError),
    (torch.zeros(2, TILE, dtype=torch.int32), ValueError),
])
def test_wrappers_refuse_what_the_kernel_cannot_take(bad, err):
    with pytest.raises(err):
        tck.checksum_words(bad)
    with pytest.raises(err):
        tck.checksum_copy_words(bad)


@pytest.mark.parametrize("change", ["checksum.cu", "matmul_digest.cu", "new.cuh", "flags"])
def test_library_name_hashes_every_source_and_the_flags(tmp_path, monkeypatch, change):
    from repro_torch.kernels import _build
    for src in _build.CSRC.glob("*.cu"):
        shutil.copy(src, tmp_path / src.name)
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    assert [p.name for p in _build.sources()] == ["checksum.cu", "matmul_digest.cu"]
    before = _build.library_path()
    assert _build.library_path() == before
    if change == "flags":
        monkeypatch.setattr(_build, "COMPILE_FLAGS", _build.COMPILE_FLAGS + ("-lineinfo",))
    else:
        with open(tmp_path / change, "a") as fh:
            fh.write("// edited\n")
    assert _build.library_path() != before
    assert _build.library_path().parent == _build.BUILD_DIR


def test_cpu_tensors_take_the_plain_path_and_count_no_launch():
    tck.reset_launch_counts()
    words = make((2 * TILE,), torch.int32, seed=9)
    tck.checksum_words(words)
    tck.checksum_many_words(words.view(2, TILE))
    res, copy = tck.checksum_copy_words(words)
    assert torch.equal(copy, words) and copy.data_ptr() != words.data_ptr()
    assert tck.launch_counts() == {
        "checksum_words": 0, "checksum_many_words": 0, "checksum_copy_words": 0}


# ---------------------------------------------------------------------------
# on the card: every CUDA kernel against its plain version
# ---------------------------------------------------------------------------
@pytest.mark.gpu
def test_cuda_kernels_match_plain_versions(cuda_device):
    rng = np.random.default_rng(17)
    tables = tck.tables(cuda_device)
    words = torch.from_numpy(rng.integers(-2**31, 2**31 - 1, 5 * TILE,
                                          dtype=np.int64).astype(np.int32)).to(cuda_device)
    tck.reset_launch_counts()
    got = tck.checksum_words(words)
    assert torch.equal(got, tref.checksum_words_ref(words, *tables))
    many = words.view(5, TILE)
    assert torch.equal(tck.checksum_many_words(many),
                       tref.checksum_many_words_ref(many, *tables))
    res, copy = tck.checksum_copy_words(words)
    assert torch.equal(res, got) and torch.equal(copy, words)
    torch.cuda.synchronize()
    assert tck.launch_counts() == {
        "checksum_words": 1, "checksum_many_words": 1, "checksum_copy_words": 1}
    host = fingerprint_bytes(words.cpu().numpy().view(np.uint8))
    assert residues(got.cpu()) == host.h


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
def test_cuda_public_api_matches_host(cuda_device, dtype):
    for shape in SHAPES:
        x = make(shape, dtype, seed=int(np.prod(shape)))
        t = x.to(cuda_device)
        got, want = tk.digest_of(t), host_digest(x)
        assert (got.h, got.length) == (want.h, want.length)
        res, copy = tk.fingerprint_and_copy(t)
        assert residues(res.cpu()) == want.h
        np.testing.assert_array_equal(byte_image(copy), byte_image(x))


@pytest.mark.gpu
def test_cuda_wrappers_refuse_misaligned_tensors(cuda_device):
    words = torch.zeros(TILE + 4, dtype=torch.int32, device=cuda_device)[1:TILE + 1]
    with pytest.raises(ValueError):
        tck.checksum_words(words)
