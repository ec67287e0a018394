"""The port's fused matmul + digest against the JAX package's Pallas kernel.

Same seeded numpy inputs through ``repro.kernels.matmul_with_digest``
(Pallas, interpret mode on the CPU, as ``tests/test_kernels.py`` runs it) and
``repro_torch.kernels.matmul_with_digest`` (on the CPU: the plain PyTorch
version). Residues must be equal exactly, and equal to the host digest of A's
blocked bytes. C must lie within K * 2^-24 * (|A| @ |B|) of the float64
product: the worst case of a float32 sum of K exact products in any order.
A float32 B goes to the card's tensor cores as three bf16 terms
(``split_bf16x3``); the split, the three-term product and the CUDA kernel's
digest arithmetic (for one term and for three) are checked on the CPU, the
kernels themselves only on a card (tests marked ``gpu``). JAX and
``ml_dtypes`` are imported inside the tests that compare with them, so the
card's machine, which has neither, can collect this file.
"""
import numpy as np
import pytest
import torch

from repro.core.integrity import fingerprint_bytes
from repro_torch import kernels as tk
from repro_torch.kernels import matmul_digest as tmm
from repro_torch.kernels import ref as tref

P = 46337

# (M, K, N, bm, bk, bn): the reference's three test shapes, then non-default tiles
CASES = [
    (128, 128, 128, 128, 128, 128),
    (256, 384, 128, 128, 128, 128),
    (128, 512, 256, 128, 128, 128),
    (192, 96, 128, 64, 32, 64),
]


def _jax():
    import jax.numpy as jnp
    import ml_dtypes
    from repro import kernels as jk
    from repro.kernels import matmul_digest as jmm
    return jnp, ml_dtypes, jk, jmm


def make(shape, seed, dtype=torch.bfloat16) -> torch.Tensor:
    """Seeded CPU tensor from numpy normals (bf16 rounded from float32)."""
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return torch.from_numpy(x).to(dtype)


def to_numpy(t: torch.Tensor):
    """The same values as a numpy array for JAX (bf16 through its int16 bits)."""
    if t.dtype == torch.bfloat16:
        import ml_dtypes
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def blocked_bytes(a: torch.Tensor, bm: int, bk: int) -> np.ndarray:
    M, K = a.shape
    u = a.view(torch.int16).numpy().reshape(M // bm, bm, K // bk, bk)
    return np.ascontiguousarray(u.transpose(0, 2, 1, 3)).reshape(-1).view(np.uint8)


def residues(r) -> tuple:
    return tuple(int(v) for v in np.asarray(r).reshape(-1))


def assert_within_f32_bound(c, a: torch.Tensor, b: torch.Tensor) -> None:
    """|C - C64| <= K * 2^-24 * (|A| @ |B|) elementwise."""
    a64, b64 = a.double().numpy(), b.double().numpy()
    bound = a64.shape[1] * 2.0 ** -24 * (np.abs(a64) @ np.abs(b64))
    err = np.abs(np.asarray(c, dtype=np.float64) - a64 @ b64)
    assert np.all(err <= bound), float((err - bound).max())


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


# ---------------------------------------------------------------------------
# port == JAX kernel == host oracle
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("m,k,n,bm,bk,bn", CASES)
def test_matmul_with_digest_matches_jax(m, k, n, bm, bk, bn):
    jnp, _, jk, _ = _jax()
    a, b = make((m, k), seed=m + k), make((k, n), seed=k + n + 1)
    c, dig = tk.matmul_with_digest(a, b, bm=bm, bn=bn, bk=bk)
    jc, jdig = jk.matmul_with_digest(jnp.asarray(to_numpy(a)), jnp.asarray(to_numpy(b)),
                                     bm=bm, bn=bn, bk=bk)
    assert c.shape == (m, n) and c.dtype == torch.float32
    assert dig.shape == (4,) and dig.dtype == torch.int32
    assert residues(dig) == residues(jdig) == fingerprint_bytes(blocked_bytes(a, bm, bk)).h
    assert_within_f32_bound(c.numpy(), a, b)
    assert_within_f32_bound(np.asarray(jc), a, b)


def test_float32_and_other_b_types_match_jax():
    """A float32 B is used as it is; any other type is cast to float32 first."""
    jnp, _, jk, _ = _jax()
    a = make((128, 256), seed=21)
    for b in (make((256, 128), seed=22, dtype=torch.float32),
              make((256, 128), seed=23, dtype=torch.float16),
              torch.from_numpy(np.random.default_rng(24).integers(-3, 4, (256, 128),
                                                                 dtype=np.int32))):
        c, dig = tk.matmul_with_digest(a, b)
        jc, jdig = jk.matmul_with_digest(jnp.asarray(to_numpy(a)), jnp.asarray(b.numpy()))
        assert residues(dig) == residues(jdig)
        assert_within_f32_bound(c.numpy(), a, b.float())
        assert_within_f32_bound(np.asarray(jc), a, b.float())


def test_matmul_digest_detects_operand_corruption():
    """Twin of tests/test_kernels.py::test_matmul_digest_detects_operand_corruption."""
    a, b = make((128, 128), seed=31), make((128, 128), seed=32)
    _, dig1 = tk.matmul_with_digest(a, b)
    a_bad = a.clone()
    a_bad[7, 33] += 1.0
    _, dig2 = tk.matmul_with_digest(a_bad, b)
    assert residues(dig1) != residues(dig2)


# ---------------------------------------------------------------------------
# the CUDA kernel's arithmetic, on the CPU
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("bm,bk", [(128, 128), (64, 32), (32, 64), (256, 8)])
def test_factors_reproduce_the_references_tile_weights(bm, bk):
    """RW[row] * CW[col] must be the reference's weight of the byte:
    r^(T*(tiles-1-t)) times _tables16's tile weight (and r^-1 for hi)."""
    _, _, _, jmm = _jax()
    M, K = 2 * bm, 3 * bk
    row_w, col_w = tmm._digest_factors(M, K, bm, bk)
    w16, rinv1, rpow = jmm._tables16(bm, bk)
    nk, tiles = K // bk, (M // bm) * (K // bk)
    rows, cols = np.arange(M)[:, None], np.arange(K)[None, :]
    t = (rows // bm) * nk + cols // bk
    for b in range(4):
        got_lo = row_w[b].astype(np.int64)[:, None] * col_w[:, b].astype(np.int64)[None] % P
        got_hi = row_w[b].astype(np.int64)[:, None] * col_w[:, 4 + b].astype(np.int64)[None] % P
        tile_w = np.vectorize(lambda e: pow(int(rpow[b, 0]), int(e), P))(tiles - 1 - t)
        want_lo = tile_w * w16[b][rows % bm, cols % bk].astype(np.int64) % P
        np.testing.assert_array_equal(got_lo, want_lo)
        np.testing.assert_array_equal(got_hi, want_lo * int(rinv1[b, 0]) % P)


def tile_coords(t: int, mt: int, nt: int) -> tuple[int, int]:
    """Mirror of ``tile_coords`` in ``csrc/matmul_digest.cu``: tile t of
    mt x nt -> (row block, column block), in groups of ``GROUP_M`` row blocks
    with the row block fastest."""
    group = tmm.GROUP_M * nt
    first = t // group * tmm.GROUP_M
    rows = min(mt - first, tmm.GROUP_M)
    return first + t % group % rows, t % group // rows


def landed_slab(codes: np.ndarray, m: int, kt: int) -> np.ndarray:
    """A's slab (row block m, K slab kt) as TMA lands it: (128 rows, 8
    physical 16-byte chunks, 8 codes), zeros past M and K, and the chunk at
    position p of row r holding logical chunk p ^ (r % 8)."""
    bm, bk = tmm.BLOCK_M, tmm.SLAB_K
    box = np.zeros((bm, bk), np.uint64)
    part = codes[m * bm:(m + 1) * bm, kt * bk:(kt + 1) * bk]
    box[:part.shape[0], :part.shape[1]] = part
    logical = box.reshape(bm, bk // 8, 8)
    phys = np.arange(bk // 8)[None, :] ^ (np.arange(bm) % 8)[:, None]
    return logical[np.arange(bm)[:, None], phys]


def emulate_wgmma_digest(a: torch.Tensor, n_cols: int, bm: int, bk: int, sms: int,
                         terms: int = 1) -> tuple:
    """The kernel's digest, step for step. Block b of the persistent
    grid walks tiles b, b + grid, ...; tile (m, n) digests rows r of its
    row block with r % n_tiles == n. Digest thread dt takes logical chunk
    c = dt // 12 of the rows j = dt % 12, + 12, ... of the tile and reads it
    from the swizzled slab; per base, one dp2a an element sums lo * W_lo +
    hi * W_hi against the packed weights (lo | hi << 16) in 32 bits. The
    first row's chunk sums add into 64 bits over the tile and meet the row
    factor at its end; a further row's chunk sum meets it at once. The
    total is reduced mod P at each tile's end. A block's partial is its 96
    totals summed by warp (mod P) and over the 3 warps (mod P); the
    partials add mod P. With ``terms`` = 3 (a float32 B, its three bf16
    terms) each A slab lands in 3 consecutive stages and is digested in the
    first only: stage kt holds A's slab kt // 3."""
    M, K = a.shape
    row_w, col_w = tmm._digest_factors(M, K, bm, bk)
    row_w = row_w.astype(np.uint64)
    packed = tmm._packed_col_w(col_w).view(np.uint32).astype(np.uint64)
    w_lo, w_hi = packed & 0xFFFF, packed >> 16
    codes = a.view(torch.int16).numpy().astype(np.int64) & 0xFFFF
    mt, nt = -(-M // tmm.BLOCK_M), -(-n_cols // tmm.BLOCK_N)
    grid = tmm.wgmma_grid(M, n_cols, sms)
    threads, warps = tmm.DIGEST_THREADS, tmm.DIGEST_THREADS // 32
    per_chunk = threads // 8                       # 12 threads a chunk position

    def chunk_sum(slab, r, col, c):
        x = slab[r, c ^ (r % 8)].astype(np.uint64)
        lo, hi = (x & 255)[:, None], (x >> 8)[:, None]
        s32 = (lo * w_lo[col:col + 8] + hi * w_hi[col:col + 8]).sum(axis=0)
        assert s32.max() < 2 ** 32
        return s32

    partials = []
    for blk in range(grid):
        tot = np.zeros((threads, 4), np.uint64)
        for t in range(blk, mt * nt, grid):
            m, n = tile_coords(t, mt, nt)
            rows = (tmm.BLOCK_M - 1 - n) // nt + 1 if n < tmm.BLOCK_M else 0
            acc = np.zeros((threads, 4), np.uint64)
            a_slabs = [landed_slab(codes, m, ka) for ka in range(-(-K // tmm.SLAB_K))]
            slabs = [a_slabs[kt // terms] for kt in range(len(a_slabs) * terms)]
            for dt in range(threads):
                c, j0 = dt // per_chunk, dt % per_chunk
                r0 = n + j0 * nt
                if not (j0 < rows and m * tmm.BLOCK_M + r0 < M):
                    continue
                for kt, slab in enumerate(slabs):
                    col = kt // terms * tmm.SLAB_K + 8 * c
                    if kt % terms or col >= K:
                        continue
                    acc[dt] += chunk_sum(slab, r0, col, c)
                    for j in range(j0 + per_chunk, rows, per_chunk):
                        r = n + j * nt
                        if m * tmm.BLOCK_M + r >= M:
                            break
                        tot[dt] += chunk_sum(slab, r, col, c) * row_w[:, m * tmm.BLOCK_M + r]
                tot[dt] += acc[dt] % P * row_w[:, m * tmm.BLOCK_M + r0]
                assert tot.max() < 2 ** 63
            tot %= P
        per_warp = tot.reshape(warps, 32, 4).sum(axis=1) % P
        partials.append(per_warp.sum(axis=0) % P)
    assert len(partials) == grid
    return tuple(int(v) for v in np.sum(partials, axis=0) % P)


def with_neg_inf(a: torch.Tensor) -> torch.Tensor:
    a[0, 0] = torch.tensor(float("-inf"), dtype=torch.bfloat16)   # all-ones hi byte
    return a


# (M, K, N, bm, bk): n_tiles 1, 3 and 16, M, K and N ragged against 128 x 64 x 256
@pytest.mark.parametrize("m,k,n,bm,bk", [(200, 72, 136, 8, 8), (136, 200, 520, 8, 40),
                                         (264, 136, 3848, 8, 8)])
@pytest.mark.parametrize("sms", [5, 132])
def test_cuda_digest_arithmetic_emulated(m, k, n, bm, bk, sms):
    """The bf16 kernel's digest (a persistent grid of 5 blocks, fewer than
    the tiles, or of 132) against the plain version and the host."""
    a = with_neg_inf(make((m, k), seed=m * k))
    want = residues(tref.matmul_digest_ref(a, make((k, 8), seed=1), bm, bk)[1])
    assert emulate_wgmma_digest(a, n, bm, bk, sms) == want
    assert want == fingerprint_bytes(blocked_bytes(a, bm, bk)).h


@pytest.mark.parametrize("m,k,n,bm,bk", [(200, 72, 136, 8, 8), (136, 200, 520, 8, 40),
                                         (264, 136, 3848, 8, 8)])
@pytest.mark.parametrize("sms", [5, 132])
def test_stacked_schedule_digest_emulated(m, k, n, bm, bk, sms):
    """A float32 B's schedule (3 stages an A slab, the digest on the first)
    gives the bf16 kernel's residues, the plain version's and the host's."""
    a = with_neg_inf(make((m, k), seed=m * k + 1))
    want = residues(tref.matmul_digest_ref(a, make((k, 8), seed=1), bm, bk)[1])
    assert emulate_wgmma_digest(a, n, bm, bk, sms, terms=3) == want
    assert emulate_wgmma_digest(a, n, bm, bk, sms) == want
    assert want == fingerprint_bytes(blocked_bytes(a, bm, bk)).h


# ---------------------------------------------------------------------------
# a float32 B as three bf16 terms (split_bf16x3), on the CPU
# ---------------------------------------------------------------------------
def f32_from_bits(bits) -> torch.Tensor:
    return torch.from_numpy(np.asarray(bits, dtype=np.uint32).view(np.float32).copy())


def terms_of(b3: torch.Tensor, K: int) -> np.ndarray:
    """(3, K, N) float64 terms back out of the slab-interleaved layout."""
    N = b3.shape[1]
    t = b3.double().reshape(-1, 3, tmm.SLAB_K, N).permute(1, 0, 2, 3).reshape(3, -1, N)
    return t[:, :K].numpy()


SPECIALS = [0x00000000, 0x80000000, 0x7F7FFFFF, 0xFF7FFFFF, 0x00800000, 0x80800000,
            0x3F800000, 0x3F800001, 0x3FFFFFFF, 0x7F7F8000, 0x7F7F7FFF, 0x097FFFFF,
            0x89000001, 0x0C7FFFFF, 0x1A3C5A7F]   # 0x097FFFFF: |b| < 2^-110 by an ulp


@pytest.mark.parametrize("draw", ["specials", "random_bits", "wide_exponents"])
def test_split_reconstructs_every_finite_float32(draw):
    """b1 + b2 + b3 == b exactly, in float64, for every finite |b| >= 2^-110;
    below, the error is under 2^-133 (bits under bf16's least subnormal)."""
    rng = np.random.default_rng(7)
    if draw == "specials":
        bits = np.array(SPECIALS * 64, np.uint32)
    elif draw == "random_bits":
        bits = rng.integers(0, 2 ** 32, 1 << 20, dtype=np.uint64).astype(np.uint32)
    else:   # sign x 2^[-149, 127] x [1, 2)
        x = rng.choice([-1.0, 1.0], 1 << 18) * np.exp2(rng.uniform(-149, 128, 1 << 18))
        bits = x.astype(np.float32).view(np.uint32)
    b = f32_from_bits(bits).reshape(-1, 64)
    b = b[torch.isfinite(b).all(dim=1)]
    terms = terms_of(tmm.split_bf16x3(b), b.shape[0])
    b64 = b.double().numpy()
    err = np.abs(terms.sum(axis=0) - b64)
    big = np.abs(b64) >= 2.0 ** -110
    assert big.any() and np.all(err[big] == 0)
    assert np.all(err[~big] < 2.0 ** -133)
    # each term is a truncation: same sign as b (or zero), shrinking by >= 2^8
    assert np.all(terms * np.sign(b64) >= 0)
    assert np.all(np.abs(terms[1]) <= np.abs(terms[0]) * 2.0 ** -7)
    assert np.all(np.abs(terms[2]) <= np.abs(terms[1]) * 2.0 ** -7)


@pytest.mark.parametrize("bits, first", [(0x7F800000, 0x7F80), (0xFF800000, 0xFF80),
                                         (0x7FC00000, 0x7FC0), (0x7F800001, 0x7FC0),
                                         (0xFFFFFFFF, 0x7FC0)])
def test_split_maps_non_finite_to_its_first_term(bits, first):
    """inf -> (inf, 0, 0); any NaN, one with its payload in its low 16 bits
    too, -> (canonical NaN, 0, 0), never to an inf."""
    b = f32_from_bits([bits, 0x3F800000] * 4).reshape(1, 8)
    codes = tmm.split_bf16x3(b).view(torch.int16).numpy().astype(np.int64) & 0xFFFF
    assert codes.shape == (3 * 64, 8)
    assert np.all(codes[0, 0::2] == first) and np.all(codes[0, 1::2] == 0x3F80)
    assert np.all(codes[1:] == 0)


@pytest.mark.parametrize("k", [8, 72, 200])
def test_split_layout_interleaves_slabs_and_zero_pads(k):
    """Row 192 s + 64 t + r of the split holds term t of row 64 s + r of B;
    rows past K are zero; split_rows(K) rows in all."""
    n = 16
    b = make((k, n), seed=k, dtype=torch.float32) * 1e3
    b3 = tmm.split_bf16x3(b)
    kp = -(-k // 64) * 64
    assert tref.SPLIT_SLAB == tmm.SLAB_K
    assert b3.shape == (tref.split_rows(k), n) == (3 * kp, n) and b3.dtype == torch.bfloat16
    u = b.contiguous().view(torch.int32).numpy()
    for row in range(k):
        s, r = divmod(row, 64)
        got = [b3[192 * s + 64 * t + r] for t in range(3)]
        assert np.array_equal(got[0].view(torch.int16).numpy().astype(np.int32) & 0xFFFF,
                              (u[row] >> 16) & 0xFFFF)
        assert torch.equal(got[0].double() + got[1].double() + got[2].double(), b[row].double())
    pad = [192 * (row // 64) + 64 * t + row % 64 for row in range(k, kp) for t in range(3)]
    assert not b3[pad].view(torch.int16).any()


def three_term_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The tensor cores' schedule on the CPU, in float32: for each 64-row slab
    of K, A's slab times b1's, then b2's, then b3's slab, added into C."""
    (M, K), N = a.shape, b.shape[1]
    b3 = tmm.split_bf16x3(b).float().reshape(-1, 3, tmm.SLAB_K, N)
    a_pad = torch.zeros((M, b3.shape[0] * tmm.SLAB_K))
    a_pad[:, :K] = a.float()
    c = torch.zeros((M, N))
    for s in range(b3.shape[0]):
        for t in range(3):
            c += a_pad[:, s * tmm.SLAB_K:(s + 1) * tmm.SLAB_K] @ b3[s, t]
    return c


@pytest.mark.parametrize("m,k,n,bm,bk,bn", CASES)
def test_three_term_product_matches_jax_on_f32_b(m, k, n, bm, bk, bn):
    """C from B's three bf16 terms, emulated in float32, and the JAX kernel's
    C on the float32 B both lie within K * 2^-24 * (|A| @ |B|) of float64;
    the residues equal the JAX kernel's and the host's."""
    jnp, _, jk, _ = _jax()
    a = make((m, k), seed=m + k)
    b = make((k, n), seed=k + n + 1, dtype=torch.float32) * 3.0
    c3 = three_term_product(a, b)
    _, dig = tk.matmul_with_digest(a, b, bm=bm, bn=bn, bk=bk)
    jc, jdig = jk.matmul_with_digest(jnp.asarray(to_numpy(a)), jnp.asarray(b.numpy()),
                                     bm=bm, bn=bn, bk=bk)
    assert residues(dig) == residues(jdig) == fingerprint_bytes(blocked_bytes(a, bm, bk)).h
    assert_within_f32_bound(c3.numpy(), a, b)
    assert_within_f32_bound(np.asarray(jc), a, b)


# (mt, nt, SMs): grids smaller than, equal to and larger than the tile count
@pytest.mark.parametrize("mt,nt,sms", [(112, 16, 132), (37, 3, 20), (4, 33, 132), (3, 4, 12),
                                       (7, 16, 132)])
def test_tile_order_covers_every_tile_once(mt, nt, sms):
    """Blocks b = 0 .. grid-1 take tiles b, b + grid, ...: every (m, n) once,
    and the digest's row split gives every row of a row block to one tile."""
    grid = tmm.wgmma_grid(mt * tmm.BLOCK_M, nt * tmm.BLOCK_N, sms)
    assert grid == min(mt * nt, sms)
    seen = [tile_coords(t, mt, nt) for b in range(grid) for t in range(b, mt * nt, grid)]
    assert sorted(seen) == [(m, n) for m in range(mt) for n in range(nt)]
    owners = sorted(r for n in range(nt) for r in range(n, tmm.BLOCK_M, nt))
    assert owners == list(range(tmm.BLOCK_M))


# ---------------------------------------------------------------------------
# the wrapper: checks, plain path on the CPU, launch count
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("a, b, kw, err", [
    (make((128, 128), 1, torch.float32), make((128, 128), 2), {}, TypeError),
    (make((128, 128), 1), make((128, 128), 2, torch.float16), {}, TypeError),
    (make((128, 128), 1), make((256, 128), 2), {}, ValueError),
    (make((96, 128), 1), make((128, 128), 2), {}, ValueError),
    (make((128, 128), 1), make((128, 96), 2), {}, ValueError),
    (make((128,), 1), make((128, 128), 2), {}, ValueError),
    (make((128, 256), 1)[:, ::2], make((128, 128), 2), {}, ValueError),
    (make((128, 128), 1), make((128, 128), 2), {"bk": 0}, ValueError),
    ("not a tensor", make((128, 128), 2), {}, TypeError),
])
def test_wrapper_refuses_what_the_kernel_cannot_take(a, b, kw, err):
    with pytest.raises(err):
        tmm.matmul_digest(a, b, **kw)


def test_public_op_makes_its_inputs_contiguous():
    a, b = make((128, 256), seed=41), make((128, 256), seed=42).t()
    c, dig = tk.matmul_with_digest(a, b)
    c2, dig2 = tmm.matmul_digest(a, b.contiguous())
    assert torch.equal(c, c2) and torch.equal(dig, dig2)


def test_cpu_tensors_take_the_plain_path_and_count_no_launch():
    tmm.reset_launch_counts()
    a, b = make((128, 128), seed=51), make((128, 128), seed=52)
    c, dig = tk.matmul_with_digest(a, b)
    want_c, want_dig = tref.matmul_digest_ref(a, b)
    assert torch.equal(c, want_c) and torch.equal(dig, want_dig)
    assert tmm.launch_counts() == {"matmul_digest": 0}


# ---------------------------------------------------------------------------
# on the card: the CUDA kernel against its plain version
# ---------------------------------------------------------------------------
@pytest.mark.gpu
@pytest.mark.parametrize("m,k,n,bm,bk,bn", CASES + [
    (640, 264, 136, 128, 8, 8),
    (2048, 512, 4608, 128, 128, 128),   # 288 tiles: more than the SMs
    (200, 72, 264, 8, 8, 8),            # ragged against 128 x 64 x 256 in M, K and N
    (128, 40, 136, 32, 8, 8),           # K < 64 and N < 256
])
@pytest.mark.parametrize("b_dtype", [torch.bfloat16, torch.float32])
def test_cuda_kernel_matches_plain_version(cuda_device, m, k, n, bm, bk, bn, b_dtype):
    torch.backends.cuda.matmul.allow_tf32 = False
    a, b = make((m, k), seed=m + k), make((k, n), seed=n, dtype=b_dtype)
    ad, bd = a.to(cuda_device), b.to(cuda_device)
    tmm.reset_launch_counts()
    c, dig = tmm.matmul_digest(ad, bd, bm=bm, bn=bn, bk=bk)
    torch.cuda.synchronize()
    assert tmm.launch_counts() == {"matmul_digest": 1}
    want_c, want_dig = tref.matmul_digest_ref(ad, bd, bm, bk)
    assert torch.equal(dig, want_dig)
    assert residues(dig.cpu()) == fingerprint_bytes(blocked_bytes(a, bm, bk)).h
    assert_within_f32_bound(c.cpu().numpy(), a, b.float())
    assert_within_f32_bound(want_c.cpu().numpy(), a, b.float())


@pytest.mark.gpu
def test_cuda_kernel_refuses_ragged_rows(cuda_device):
    a = make((128, 12), seed=1).to(cuda_device)
    b = make((12, 128), seed=2).to(cuda_device)
    with pytest.raises(ValueError, match="K % 8"):
        tmm.matmul_digest(a, b, bk=4)


@pytest.mark.gpu
@pytest.mark.parametrize("k,n", [(200, 136), (64, 4096), (5120, 264)])
def test_cuda_split_matches_plain_version(cuda_device, k, n):
    """The split kernel bit for bit against split_bf16x3's plain version, on
    random bit patterns (NaNs, infs and subnormals among them) and specials."""
    rng = np.random.default_rng(k + n)
    bits = rng.integers(0, 2 ** 32, k * n, dtype=np.uint64).astype(np.uint32)
    bits[:len(SPECIALS)] = SPECIALS
    bits[len(SPECIALS):len(SPECIALS) + 5] = [0x7F800000, 0xFF800000, 0x7FC00000, 0x7F800001,
                                             0xFFFFFFFF]
    b = f32_from_bits(bits).reshape(k, n)
    got = tmm.split_bf16x3(b.to(cuda_device))
    torch.cuda.synchronize()
    want = tref.split_bf16x3(b)
    assert got.shape == want.shape
    assert torch.equal(got.cpu().view(torch.int16), want.view(torch.int16))


@pytest.mark.gpu
@pytest.mark.parametrize("lo,hi", [(-110, 100), (-110, -100)])
def test_cuda_kernel_keeps_every_exponent(cuda_device, lo, hi):
    """B's entries at 2^[lo, hi): C within K * 2^-24 * (|A| @ |B|) of
    float64. At 2^[-110, -100) the third term and its products are
    subnormal: the tensor cores must keep them."""
    m, k, n = 256, 320, 264
    rng = np.random.default_rng(hi - lo)
    x = rng.choice([-1.0, 1.0], (k, n)) * np.exp2(rng.uniform(lo, hi, (k, n)))
    b = torch.from_numpy(x.astype(np.float32))
    a = make((m, k), seed=3)
    c, dig = tmm.matmul_digest(a.to(cuda_device), b.to(cuda_device), bm=128, bn=8, bk=64)
    torch.cuda.synchronize()
    assert residues(dig.cpu()) == fingerprint_bytes(blocked_bytes(a, 128, 64)).h
    assert_within_f32_bound(c.cpu().numpy(), a, b)


@pytest.mark.gpu
def test_cuda_kernel_with_non_finite_b(cuda_device):
    """±inf and NaN in B: C is non-finite exactly where the plain float32
    product is, and within K * 2^-24 * (|A| @ |B|) of float64 elsewhere."""
    torch.backends.cuda.matmul.allow_tf32 = False
    m, k, n = 256, 200, 136
    a, b = make((m, k), seed=11), make((k, n), seed=12, dtype=torch.float32)
    b[3, 5], b[70, 5], b[150, 40] = float("inf"), float("-inf"), float("inf")
    b[9, 100] = float("nan")
    b[[120, 121], 17] = f32_from_bits([0x7F800001, 0xFFC0FFFF])    # NaN payloads
    c, _ = tmm.matmul_digest(a.to(cuda_device), b.to(cuda_device), bm=8, bn=8, bk=8)
    want, _ = tref.matmul_digest_ref(a.to(cuda_device), b.to(cuda_device), 8, 8)
    c, want = c.cpu(), want.cpu()
    finite = torch.isfinite(want)
    assert torch.equal(torch.isfinite(c), finite)
    assert not finite[:, [5, 40, 100, 17]].any() and finite[:, 0].all()
    fin = finite.all(dim=0)
    assert_within_f32_bound(c[:, fin].numpy(), a, b[:, fin])
