// Hand-written Hopper (sm_90a) kernels: C = A @ B with f32 accumulation, plus
// the GF(46337) digest of A's bytes, taken from the tiles the product reads.
//
// Replaces the Pallas TPU kernel src/repro/kernels/matmul_digest.py:99
// (matmul_digest / _mm_digest_kernel), the "consume-and-verify" product: a
// weight that has just been moved is digested by the matmul that consumes
// it, instead of by a second pass that reads it again.
//
// What it computes. A is (M, K) bf16, B is (K, N) bf16 or f32, C is (M, N)
// f32. The digest is defined over A's bytes in the blocked order of the
// reference (tile (i, k) of (bm, bk) at index i * K/bk + k, ref.blocked_view),
// and the digest is linear:  H = sum_q b_q * r^(Nbytes-1-q) mod P.  For the
// lo byte of element (row, col) the exponent is
//     T*(tiles-1-t) + (T-1) - 2*bk*(row % bm) - 2*(col % bk),
// t = (row/bm)*nk + col/bk, T = 2*bm*bk, and the hi byte weighs one r^-1
// less. Since T*t = T*nk*(row/bm) + T*(col/bk), the weight splits into a row
// factor and a column factor:  W(row, col) = RW[row] * CW[col].  The wrapper
// builds RW (4, M) and CW (K, 8) (lo then hi, per base) on the host. So the
// digest of a row is a sum along K times RW[row]: no ordered combine, and no
// constraint that ties the CUDA tiles to (bm, bk). Any (bm, bk) works.
//
// Bound on this card (H100 SXM), the largest of:
//   product - 2*M*N*K FLOP at 4096 dense bf16 FLOP per SM per clock x 132 SMs
//             x the max SM clock (989.4 TFLOP/s at 1830 MHz, the data sheet),
//             three times over for an f32 B (its three bf16 terms, below);
//   bytes   - A + B + C once each over 3.35 TB/s;
//   digest  - 8 INT32 multiply-adds per A element (2 bytes x 4 bases) over
//             64 INT32 lanes per SM x 132 SMs x clock.
// At M=14336, K=5120, N=4096 the product binds (bf16 B 0.56 ms, f32 B 1.69 ms
// at 1980 MHz, against 0.13-0.14 ms of bytes and 0.04 ms of digest).
//
// The bf16 kernel (mm_digest_wgmma_kernel). A bf16 x bf16 product is exact
// in f32, so C differs from the TPU's f32 dot only in the order of summation.
//   * Tiles and ring. A block computes 128 x 256 tiles of C in K slabs of
//     64, so one A row of a slab is 128 bytes, the width of the 128-byte
//     swizzle. Each of the 4 ring stages holds the A slab (one TMA box of
//     64 x 128, 16 KiB), the B slab (four TMA boxes of 64 N x 64 K, 32 KiB:
//     a swizzled box is at most 128 bytes wide) and the digest's column
//     weights of the slab (1 KiB), 1024-byte aligned as the swizzle and the
//     wgmma descriptors require: 200 KiB in all.
//   * Warp specialisation, 384 threads. Warpgroup 0 gives registers back
//     (setmaxnreg.dec): one thread issues the TMA loads, which report their
//     bytes on the stage's full mbarrier; its other three warps digest.
//     Warpgroups 1 and 2 (setmaxnreg.inc) each compute 64 rows x 256 columns
//     of the tile with wgmma.mma_async m64n256k16 (f32 accumulators, 128
//     registers a thread), keep one wgmma group in flight and then release
//     the previous stage on its empty mbarrier. Stage and phase run on
//     across tiles.
//   * Operands. A (M, K) row-major is K-major. B (K, N) row-major is
//     MN-major: it goes in as it is, through wgmma's transpose-B bit and
//     MN-major descriptors, with no transposing pass. TMA zero-fills boxes
//     past M, N or K (zeros add nothing to C or the digest); stores are
//     masked. K % 8 == 0 and N % 8 == 0: TMA needs 16-byte row strides.
//   * Persistent grid. min(tiles, SMs) blocks walk the tiles in steps of the
//     grid, in the order of tile_coords: groups of 16 row blocks, the row
//     block fastest, so the tiles in flight together share A row blocks and
//     B column blocks in L2. The producer loads the next tile while the
//     consumers store the last one (f32 from registers, masked float2).
//   * The digest, off the tensor cores' path. Tile (m, n) digests the rows r
//     of its row block with (r - m0) % n_tiles == n, over all of K: every
//     row of A is digested once, about 128 / n_tiles rows a tile. The
//     producer warpgroup's three digest warps wait on each stage's full
//     barrier, read their rows' 16-byte chunks of the landed A slab (the
//     chunk at position p of row r holds logical chunk p ^ (r % 8)) and the
//     slab's column weights, and arrive on the stage's empty barrier, which
//     counts them on every slab. The consumers never touch it. The digest
//     warps must keep up with the ring, so each chunk costs few dependent
//     instructions: the wrapper packs the weights as lo | hi << 16 per
//     column and base, (K, 4), so one dp2a gives lo * W_lo + hi * W_hi for
//     an element (8 a chunk and base, < 2^28 in 32 bits). A thread's first
//     row of a tile adds its chunk sums into 64 bits for the whole tile and
//     meets RW[row] once, at the tile's end, so the slab loop reads shared
//     memory only: no mod P, no load from L2. The producer brings the
//     slab's 1 KiB of packed weights into the stage with one bulk copy.
//     (Weights or row factors read from L2 on every slab set the pace: the
//     weight table of K = 5120 is 80 KiB, the L1 beside 200 KiB of shared
//     memory about 28.) Each block adds its rows' residues into one
//     partial; digest_sum_kernel adds those. When N <= 256 one tile
//     digests all 128 rows, and the digest warps may set the pace.
//   * mm_product runs the same kernel without the digest warps (kDigest =
//     false), to time the digest's share.
//
// An f32 B (kTerms = 3). The tensor cores take bf16, so B is split exactly
// into three bf16 terms and the same kernel runs over three times the slabs.
//   * The split (split_bf16x3_kernel), by truncation: b1 = the top 16 bits
//     of b, r1 = b - b1 (exact in f32), b2 = the top 16 bits of r1, b3 = the
//     top 16 bits of r1 - b2. For |b| >= 2^-110 b1 + b2 + b3 == b exactly;
//     below, only bits under 2^-133 (the least bf16 subnormal) are dropped.
//     Truncation never rounds up past bf16's largest finite value. An inf
//     goes to (inf, 0, 0), a NaN to (canonical NaN, 0, 0): inf - inf would
//     be NaN, and a NaN with its payload in its low 16 bits would truncate
//     to inf. A is bf16, so each a * b_i has at most 16 significant bits and
//     is exact in f32: C = A b1 + A b2 + A b3 differs from an f32 FMA
//     product only in the order of summation, as the bf16 path does.
//   * Layout. B3 is (3 * Kp, N) bf16, Kp = K rounded up to the slab of 64,
//     interleaved by slab: rows [192 s, 192 s + 64) hold b1's slab s, the
//     next 64 b2's, the next 64 b3's; rows past K are zero. So slab kt of
//     B3 pairs with A's slab kt / 3, which the producer loads three times
//     (the repeats hit L2); the digest warps digest A on slabs kt % 3 == 0
//     only, with slab kt / 3's column weights, and still wait and arrive on
//     every stage's barriers. The residues are the bf16 kernel's.
//   * The split writes 1.5x B's bytes; the main kernel reads them once. The
//     product (three bf16 products) binds.

#include <cuda.h>              // CUtensorMap and its enums (header only)
#include <cuda_runtime.h>
#include <stdint.h>
#include <limits.h>

namespace {

constexpr uint32_t kP = 46337;
constexpr int kBases = 4;

// bf16 tensor-core kernel
constexpr int kBM = 128;                      // C tile rows
constexpr int kBN = 256;                      // C tile columns
constexpr int kBK = 64;                       // K slab: one 128-byte swizzled row of A
constexpr int kStages = 4;                    // TMA ring depth
constexpr int kGroupM = 16;                   // row blocks in a group of the tile order
constexpr int kThreads = 384;                 // producer warpgroup + 2 consumer warpgroups
constexpr int kDigestWarps = 3;               // warps 1-3 of the producer warpgroup
constexpr int kProducerRegs = 72;             // TMA issue + digest, no spills
constexpr int kConsumerRegs = 216;            // 128 accumulators + addressing, no spills
constexpr int kABytes = kBM * kBK * 2;        // 16 KiB: one box of 64 K x 128 rows
constexpr int kBBoxN = 64;                    // N columns of one B box (128 bytes)
constexpr int kBBoxBytes = kBK * kBBoxN * 2;  // 8 KiB: 64 K rows x 64 N columns
constexpr int kBBytes = kBN / kBBoxN * kBBoxBytes;   // 32 KiB
constexpr int kWBytes = kBK * 16;             // 1 KiB: the slab's packed column weights
constexpr int kStageBytes = 50 * 1024;        // A, B, W; 1024-byte aligned stages
constexpr int kSmemBytes = kStages * kStageBytes + 1024;           // + alignment slack

static_assert(kABytes + kBBytes + kWBytes <= kStageBytes && kStageBytes % 1024 == 0, "stage");

// setmaxnreg moves registers only within what the block got at launch:
// 168 a thread (65,536 / 384, rounded down to 8), so dec + 2 x inc <= 3 x 168,
// or the consumers' setmaxnreg.inc waits for ever.
static_assert(kProducerRegs + 2 * kConsumerRegs <= 3 * 168, "register budget");
static_assert(kSmemBytes <= 232448 - 256, "dynamic shared memory");

// the split of an f32 B and the partial-sum kernel
constexpr int kTerms = 3;                     // bf16 terms of an f32
constexpr int kSumThreads = 256;              // digest_sum_kernel
constexpr int kSplitThreads = 256;            // split_bf16x3_kernel: 4 columns a thread

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// One TMA box at coordinates (c0 innermost, c1) into shared memory at dst;
// its bytes complete a transaction on the mbarrier bar.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// bytes (a multiple of 16) from global src to shared dst, one bulk copy;
// they complete a transaction on the mbarrier bar.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ uint4 ld_shared_v4(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr));
  return v;
}

// wgmma shared-memory descriptor with the 128-byte swizzle (layout type 1 in
// bits 62-63): start address, leading and stride byte offsets, each >> 4.
//   K-major A:  8-row groups of 128-byte rows at sbo = 1024 (lbo unused);
//   MN-major B: the 8-row K groups at sbo = 1024, the 64-column N boxes at
//               lbo = kBBoxBytes.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFFu) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFFu) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFFu) << 32 | 1ull << 62;
}

// D (64 x 256 f32, 128 registers a thread) = A (64 x 16, K-major) *
// B (16 x 256, MN-major: transpose-B = 1) + (scale_d ? D : 0).
__device__ __forceinline__ void wgmma_m64n256k16(float d[128], uint64_t desc_a, uint64_t desc_b,
                                                 uint32_t scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
      "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// Keeps the compiler from moving accumulator reads across a wgmma wait.
__device__ __forceinline__ void fence_acc(float d[128]) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Tile t of mt x nt tiles -> (row block m, column block n). Groups of kGroupM
// row blocks, the row block fastest within a group: the grid's blocks take
// consecutive tiles, so the tiles in flight share A row blocks and B column
// blocks (16 x 8 blocks for a wave of 132 tiles, rather than 16 x 16).
__device__ __forceinline__ void tile_coords(int t, int mt, int nt, int& m, int& n) {
  const int group = kGroupM * nt;
  const int first = t / group * kGroupM;
  const int rows = min(mt - first, kGroupM);
  const int r = t % group;
  m = first + r % rows;
  n = r / rows;
}

// Digest terms of one 16-byte chunk x of a row of A (8 bf16 codes), per
// base, before the row factor. At shared address w the chunk's 8 columns'
// packed weights, 16 bytes a column: per base lo | hi << 16, so one dp2a
// gives lo * W_lo + hi * W_hi for a whole element; 8 terms of
// < 2 * 255 * 46336 fit 32 bits. Little-endian: the element at the lower
// column is the low half of a word.
__device__ __forceinline__ void chunk_sum(uint32_t sum[kBases], uint4 x, uint32_t w) {
  const uint32_t words[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int b = 0; b < kBases; ++b) sum[b] = 0u;
#pragma unroll
  for (int e = 0; e < 8; e += 2) {
    const uint4 w0 = ld_shared_v4(w + 16 * e);         // column e: bytes 0, 1 of the word
    const uint4 w1 = ld_shared_v4(w + 16 * (e + 1));   // column e + 1: bytes 2, 3
    const uint32_t word = words[e / 2];
    sum[0] = __dp2a_hi(w1.x, word, __dp2a_lo(w0.x, word, sum[0]));
    sum[1] = __dp2a_hi(w1.y, word, __dp2a_lo(w0.y, word, sum[1]));
    sum[2] = __dp2a_hi(w1.z, word, __dp2a_lo(w0.z, word, sum[2]));
    sum[3] = __dp2a_hi(w1.w, word, __dp2a_lo(w0.w, word, sum[3]));
  }
}

// bf16 A and B through wgmma; persistent, grid = min(tiles, SMs). With
// kT = kTerms, B is the split of an f32 B (3 * Kp rows, slab-interleaved).
template <bool kDigest, int kT>
__global__ void __launch_bounds__(kThreads, 1)
mm_digest_wgmma_kernel(const __grid_constant__ CUtensorMap map_a,
                       const __grid_constant__ CUtensorMap map_b,
                       float* __restrict__ C, int M, int N, int K,
                       const uint32_t* __restrict__ roww, const uint4* __restrict__ colw16,
                       int4* __restrict__ partial) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[kStages];
  __shared__ __align__(8) uint64_t empty[kStages];
  __shared__ uint32_t red[kBases][kDigestWarps];
  // stage s: the A slab at ring + s * kStageBytes, the four B boxes, the weights
  const uint32_t ring = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int wg = threadIdx.x >> 7;
  const int mt = (M + kBM - 1) / kBM;
  const int nt = (N + kBN - 1) / kBN;
  const int tiles = mt * nt;
  const int ktiles = (K + kBK - 1) / kBK * kT;   // A's slabs, each kT times

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(smem_u32(&full[s]), 1);
      mbar_init(smem_u32(&empty[s]), 2 + (kDigest ? kDigestWarps : 0));
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (warp == 0) {
      // ---- producer: one thread keeps the ring full ----
      if (lane == 0) {
        int it = 0;
        for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
          int m, n;
          tile_coords(t, mt, nt, m, n);
          for (int kt = 0; kt < ktiles; ++kt, ++it) {
            const int s = it % kStages;
            const int ka = kt / kT;             // A's slab; B's is kt
            mbar_wait(smem_u32(&empty[s]), ((it / kStages) & 1) ^ 1);
            const uint32_t bar = smem_u32(&full[s]);
            const bool weights = kDigest && kt % kT == 0;   // the slabs the digest reads
            const int wbytes = weights ? 16 * min(kBK, K - ka * kBK) : 0;
            mbar_expect_tx(bar, kABytes + kBBytes + wbytes);
            const uint32_t dst = ring + s * kStageBytes;
            tma_load(dst, &map_a, bar, ka * kBK, m * kBM);
#pragma unroll
            for (int j = 0; j < kBN / kBBoxN; ++j)
              tma_load(dst + kABytes + j * kBBoxBytes, &map_b, bar, n * kBN + j * kBBoxN,
                       kt * kBK);
            if (weights)
              bulk_load(dst + kABytes + kBBytes, colw16 + static_cast<size_t>(ka) * kBK, wbytes,
                        bar);
          }
        }
      }
    } else if (kDigest) {
      // ---- digest warps: their rows of every landed A slab ----
      // Thread dt takes the logical 16-byte chunk c of each slab row j0,
      // j0 + 12, ... of the tile (row r = n + j * n_tiles): a warp reads the
      // weights of 3 chunks, not 8, and the rows spread over the 3 warps.
      const int dt = threadIdx.x - 32;        // 0 .. 95
      const int c = dt / 12;
      const int j0 = dt % 12;
      uint64_t tot[kBases] = {0u, 0u, 0u, 0u};
      int it = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        int m, n;
        tile_coords(t, mt, nt, m, n);
        const int rows = n < kBM ? (kBM - 1 - n) / nt + 1 : 0;   // r = n + j * nt < kBM
        // the first row's sums stay in acc for the whole tile and meet their
        // row factor (loaded now, used at the end) once: the slab loop reads
        // shared memory only. Further rows (n_tiles < 12) are weighed as
        // they come.
        const int r0 = n + j0 * nt;
        const bool first = j0 < rows && m * kBM + r0 < M;
        uint32_t rw0[kBases] = {0u, 0u, 0u, 0u};
        if (first) {
#pragma unroll
          for (int b = 0; b < kBases; ++b)
            rw0[b] = __ldg(roww + static_cast<size_t>(b) * M + m * kBM + r0);
        }
        uint64_t acc[kBases] = {0u, 0u, 0u, 0u};
        for (int kt = 0; kt < ktiles; ++kt, ++it) {
          const int s = it % kStages;
          mbar_wait(smem_u32(&full[s]), (it / kStages) & 1);
          const uint32_t stage = ring + s * kStageBytes;
          const uint32_t w = stage + kABytes + kBBytes + 128 * c;
          // each A slab once (its first of kT stages); K % 8 == 0: whole chunks only
          if (first && kt % kT == 0 && kt / kT * kBK + 8 * c < K) {
            uint32_t sum[kBases];
            chunk_sum(sum, ld_shared_v4(stage + r0 * 128 + ((c ^ (r0 & 7)) << 4)), w);
#pragma unroll
            for (int b = 0; b < kBases; ++b) acc[b] += sum[b];
            for (int j = j0 + 12; j < rows; j += 12) {
              const int r = n + j * nt;
              if (m * kBM + r >= M) break;
              chunk_sum(sum, ld_shared_v4(stage + r * 128 + ((c ^ (r & 7)) << 4)), w);
#pragma unroll
              for (int b = 0; b < kBases; ++b)
                tot[b] += static_cast<uint64_t>(sum[b]) *
                          __ldg(roww + static_cast<size_t>(b) * M + m * kBM + r);
            }
          }
          __syncwarp();
          if (lane == 0) mbar_arrive(smem_u32(&empty[s]));
          if ((kt & 0xFFFF) == 0xFFFF) {      // < 11 * 2^16 terms of < 2^43 since the last
#pragma unroll
            for (int b = 0; b < kBases; ++b) tot[b] %= kP;
          }
        }
#pragma unroll
        for (int b = 0; b < kBases; ++b) tot[b] = (tot[b] + acc[b] % kP * rw0[b]) % kP;
      }
      // the block's partial: 96 values < P per base
#pragma unroll
      for (int b = 0; b < kBases; ++b) {
        uint32_t v = static_cast<uint32_t>(tot[b]);   // < P
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
        if (lane == 0) red[b][warp - 1] = v % kP;
      }
      asm volatile("bar.sync 1, %0;\n" ::"n"(32 * kDigestWarps) : "memory");
      if (dt == 0) {
        uint32_t h[kBases];
#pragma unroll
        for (int b = 0; b < kBases; ++b) h[b] = (red[b][0] + red[b][1] + red[b][2]) % kP;
        partial[blockIdx.x] = make_int4(static_cast<int>(h[0]), static_cast<int>(h[1]),
                                        static_cast<int>(h[2]), static_cast<int>(h[3]));
      }
    }
  } else {
    // ---- consumers: rows 64 * cw .. 64 * cw + 63 of each tile ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int cw = wg - 1;
    const bool leader = (threadIdx.x & 127) == 0;
    float d[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) d[i] = 0.f;
    int it = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      int m, n;
      tile_coords(t, mt, nt, m, n);
      for (int kt = 0; kt < ktiles; ++kt, ++it) {
        const int s = it % kStages;
        mbar_wait(smem_u32(&full[s]), (it / kStages) & 1);
        const uint32_t a = ring + s * kStageBytes + cw * 64 * 128;
        const uint32_t b = ring + s * kStageBytes + kABytes;
        asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
        for (int ks = 0; ks < kBK / 16; ++ks)   // 16 K a step: 32 bytes of A, 16 rows of B
          wgmma_m64n256k16(d, smem_desc(a + 32 * ks, 16, 1024),
                           smem_desc(b + 16 * 128 * ks, kBBoxBytes, 1024), (kt | ks) != 0);
        asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
        asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
        if (kt > 0 && leader) mbar_arrive(smem_u32(&empty[(it - 1) % kStages]));
      }
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      fence_acc(d);
      if (leader) mbar_arrive(smem_u32(&empty[(it - 1) % kStages]));
      // thread (warp w, lane l) holds rows 16w + l/4 and +8, columns 8j + 2(l%4) and +1
      const int row = m * kBM + cw * 64 + (warp & 3) * 16 + (lane >> 2);
      const int col0 = n * kBN + 2 * (lane & 3);
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j) {
        const int col = col0 + 8 * j;
        if (col < N) {                        // N even: col + 1 < N too
          if (row < M)
            __stcs(reinterpret_cast<float2*>(C + static_cast<size_t>(row) * N + col),
                   make_float2(d[4 * j], d[4 * j + 1]));
          if (row + 8 < M)
            __stcs(reinterpret_cast<float2*>(C + static_cast<size_t>(row + 8) * N + col),
                   make_float2(d[4 * j + 2], d[4 * j + 3]));
        }
      }
    }
  }
}

// One f32 as the bf16 codes of its three terms (the note at the top).
__device__ __forceinline__ void split3(float b, uint32_t& h1, uint32_t& h2, uint32_t& h3) {
  const uint32_t u = __float_as_uint(b);
  if ((u & 0x7F800000u) == 0x7F800000u) {      // inf: (inf, 0, 0); NaN: (NaN, 0, 0)
    h1 = (u & 0x007FFFFFu) ? 0x7FC0u : u >> 16;
    h2 = h3 = 0u;
    return;
  }
  const float r1 = __fsub_rn(b, __uint_as_float(u & 0xFFFF0000u));    // exact
  const uint32_t v = __float_as_uint(r1);
  const float r2 = __fsub_rn(r1, __uint_as_float(v & 0xFFFF0000u));   // exact
  h1 = u >> 16;
  h2 = v >> 16;
  h3 = __float_as_uint(r2) >> 16;
}

// B3 (3 * Kp, N) bf16, slab-interleaved, from B (K, N) f32: each thread
// splits 4 consecutive columns of one row k < Kp (zeros past K) and writes
// them to its rows of the three terms. Grid-stride; N % 4 == 0.
__global__ void __launch_bounds__(kSplitThreads)
split_bf16x3_kernel(const float4* __restrict__ B, uint2* __restrict__ B3, int K, int N, int Kp) {
  const long long n4 = N / 4;
  const long long total = static_cast<long long>(Kp) * n4;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; i < total;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long k = i / n4;
    const long long j = i - k * n4;
    const float4 v = k < K ? __ldg(B + k * n4 + j) : make_float4(0.f, 0.f, 0.f, 0.f);
    const float x[4] = {v.x, v.y, v.z, v.w};
    uint32_t h[kTerms][4];
#pragma unroll
    for (int e = 0; e < 4; ++e) split3(x[e], h[0][e], h[1][e], h[2][e]);
    const long long row = k / kBK * (kTerms * kBK) + k % kBK;   // b1's row; b2, b3 at +64, +128
#pragma unroll
    for (int t = 0; t < kTerms; ++t)      // little-endian: the lower column in the low half
      B3[(row + t * kBK) * n4 + j] = make_uint2(h[t][0] | h[t][1] << 16, h[t][2] | h[t][3] << 16);
  }
}

// One block: out = sum of the blocks' partial residues mod P.
__global__ void __launch_bounds__(kSumThreads)
digest_sum_kernel(const int4* __restrict__ partial, int blocks, int* __restrict__ out) {
  __shared__ uint32_t part[kBases][kSumThreads / 32];
  uint32_t s[kBases] = {0u, 0u, 0u, 0u};
  for (int i = threadIdx.x; i < blocks; i += kSumThreads) {   // < 256 terms of < P each
    const int4 p = partial[i];
    s[0] += static_cast<uint32_t>(p.x);
    s[1] += static_cast<uint32_t>(p.y);
    s[2] += static_cast<uint32_t>(p.z);
    s[3] += static_cast<uint32_t>(p.w);
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int b = 0; b < kBases; ++b) {
    uint32_t t = s[b] % kP;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) t += __shfl_down_sync(0xffffffffu, t, off);
    if (lane == 0) part[b][warp] = t % kP;
  }
  __syncthreads();
  if (threadIdx.x < kBases) {
    uint32_t sum = 0;
    for (int w = 0; w < kSumThreads / 32; ++w) sum += part[threadIdx.x][w];
    out[threadIdx.x] = static_cast<int>(sum % kP);
  }
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled is a driver call. The runtime hands out the
// driver's entry point, so the library links no libcuda.
EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &q);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    const bool ok = err == cudaSuccess && q == cudaDriverEntryPointSuccess;
    return ok ? reinterpret_cast<EncodeTiledFn>(p) : nullptr;
  }();
  return fn;
}

// TMA map of a row-major bf16 (rows, cols) matrix in boxes of (box_rows,
// box_cols), 128-byte swizzle, zeros past the edges.
cudaError_t tma_map(CUtensorMap* map, const void* ptr, long long rows, long long cols,
                    uint32_t box_rows, uint32_t box_cols) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return cudaErrorSymbolNotFound;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * 2};
  const cuuint32_t box[2] = {box_cols, box_rows};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims,
                        strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

cudaError_t check_shape(long long M, long long N, long long K) {
  if (M <= 0 || N <= 0 || K <= 0 || K % 8 != 0 || N % 8 != 0) return cudaErrorInvalidValue;
  if (M > INT_MAX || N > INT_MAX || K > INT_MAX) return cudaErrorInvalidValue;
  return cudaSuccess;
}

// Rows of the split of a K-row B: 3 * Kp, Kp = K rounded up to the slab.
long long split_rows(long long K) { return kTerms * ((K + kBK - 1) / kBK * kBK); }

// Blocks of the persistent bf16 grid: min(tiles, SMs).
long long wgmma_grid(long long M, long long N, int sms) {
  const long long tiles = ((M + kBM - 1) / kBM) * ((N + kBN - 1) / kBN);
  return tiles < sms ? tiles : sms;
}

// b is (K, N) bf16 (kT = 1) or the split of an f32 B, (split_rows(K), N) (kT = kTerms).
template <bool kDigest, int kT>
cudaError_t launch_wgmma(const void* a, const void* b, void* c, long long M, long long N,
                         long long K, const void* roww, const void* colw16, void* partial,
                         int sms, cudaStream_t st) {
  const long long brows = kT == 1 ? K : split_rows(K);
  if (((M + kBM - 1) / kBM) * ((N + kBN - 1) / kBN) > INT_MAX || brows > INT_MAX || sms <= 0)
    return cudaErrorInvalidConfiguration;
  CUtensorMap map_a, map_b;
  cudaError_t err = tma_map(&map_a, a, M, K, kBM, kBK);
  if (err == cudaSuccess) err = tma_map(&map_b, b, brows, N, kBK, kBBoxN);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(mm_digest_wgmma_kernel<kDigest, kT>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return err;
  mm_digest_wgmma_kernel<kDigest, kT>
      <<<static_cast<unsigned>(wgmma_grid(M, N, sms)), kThreads, kSmemBytes, st>>>(
          map_a, map_b, static_cast<float*>(c), static_cast<int>(M), static_cast<int>(N),
          static_cast<int>(K), static_cast<const uint32_t*>(roww),
          static_cast<const uint4*>(colw16), static_cast<int4*>(partial));
  return cudaGetLastError();
}

cudaError_t launch_split(const void* b, void* b3, long long K, long long N, int sms,
                         cudaStream_t st) {
  if (split_rows(K) > INT_MAX || sms <= 0) return cudaErrorInvalidConfiguration;
  const long long threads = split_rows(K) / kTerms * (N / 4);
  long long blocks = (threads + kSplitThreads - 1) / kSplitThreads;
  if (blocks > 16LL * sms) blocks = 16LL * sms;       // grid-stride beyond 16 blocks an SM
  split_bf16x3_kernel<<<static_cast<unsigned>(blocks), kSplitThreads, 0, st>>>(
      static_cast<const float4*>(b), static_cast<uint2*>(b3), static_cast<int>(K),
      static_cast<int>(N), static_cast<int>(split_rows(K) / kTerms));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Layout constants, so the Python wrapper can refuse a library built for
// another tiling: {C tile rows, C tile columns, K slab, threads, ring
// stages, row blocks in a tile-order group, bf16 terms of an f32 B}.
int mm_layout(int* out7) {
  out7[0] = kBM;
  out7[1] = kBN;
  out7[2] = kBK;
  out7[3] = kThreads;
  out7[4] = kStages;
  out7[5] = kGroupM;
  out7[6] = kTerms;
  return 0;
}

// C = A @ B and the digest residues of A's blocked bytes.
//   a        device, (M, K) bf16, 16-byte aligned
//   b        device, (K, N) bf16 (b_f32 == 0) or f32 (b_f32 != 0), 16-byte aligned
//   b3       device scratch for an f32 B, (3 * Kp, N) bf16, Kp = K rounded up
//            to 64: the split (split_bf16x3_kernel); unused for a bf16 B
//   c        device, (M, N) f32 output
//   roww     device, (4, M) int32 row factors
//   colw16   device, (K, 4) int32 column factors, per column and base
//            lo | hi << 16
//   partial  device scratch, (min(ceil(M/128) * ceil(N/256), sms), 4) int32
//   out      device, (4,) int32 residues
//   sms      the card's SM count (the persistent grid's size)
// K % 8 == 0 and N % 8 == 0. Launches on `stream` (the split first for an
// f32 B) and returns the cudaError_t of the launches.
int mm_digest(int device, const void* a, const void* b, int b_f32, void* b3, void* c,
              long long M, long long N, long long K, const void* roww, const void* colw16,
              void* partial, void* out, int sms, void* stream) {
  cudaError_t err = check_shape(M, N, K);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (b_f32) {
    err = launch_split(b, b3, K, N, sms, st);
    if (err == cudaSuccess)
      err = launch_wgmma<true, kTerms>(a, b3, c, M, N, K, roww, colw16, partial, sms, st);
  } else {
    err = launch_wgmma<true, 1>(a, b, c, M, N, K, roww, colw16, partial, sms, st);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  digest_sum_kernel<<<1, kSumThreads, 0, st>>>(static_cast<const int4*>(partial),
                                               static_cast<int>(wgmma_grid(M, N, sms)),
                                               static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}

// The split of an f32 B alone: b (K, N) f32 into b3 (3 * Kp, N) bf16, as
// mm_digest makes it. Exists so the split can be held bit for bit against
// its plain version and timed.
int mm_split(int device, const void* b, void* b3, long long K, long long N, int sms,
             void* stream) {
  cudaError_t err = check_shape(1, N, K);
  if (err == cudaSuccess) err = cudaSetDevice(device);
  if (err == cudaSuccess) err = launch_split(b, b3, K, N, sms, static_cast<cudaStream_t>(stream));
  return static_cast<int>(err);
}

// C = A @ B alone: the bf16 kernel without its digest warps. Takes the same
// a, b, c, M, N, K, sms and stream as mm_digest (bf16 B); it exists to time
// the digest's share of mm_digest.
int mm_product(int device, const void* a, const void* b, void* c, long long M, long long N,
               long long K, int sms, void* stream) {
  cudaError_t err = check_shape(M, N, K);
  if (err == cudaSuccess) err = cudaSetDevice(device);
  if (err == cudaSuccess)
    err = launch_wgmma<false, 1>(a, b, c, M, N, K, nullptr, nullptr, nullptr, sms,
                                 static_cast<cudaStream_t>(stream));
  return static_cast<int>(err);
}

}  // extern "C"
