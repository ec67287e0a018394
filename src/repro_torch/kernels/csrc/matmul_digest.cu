// Hand-written Hopper (sm_90a) kernel: C = A @ B with f32 accumulation, plus
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
// builds RW (4, M) and CW (K, 8) (lo then hi, per base) on the host. So a
// thread sums lo*CW_lo + hi*CW_hi along its row over the whole of K, and
// multiplies by RW once at the end: no ordered combine, no constraint that
// ties the CUDA tiles to (bm, bk). Any (bm, bk) the reference takes works.
//
// Bound on this card (H100 SXM), the largest of:
//   product - 2*M*N*K FLOP at 4096 dense bf16 FLOP per SM per clock x 132 SMs
//             x the max SM clock (989.4 TFLOP/s at 1830 MHz, the data sheet);
//   bytes   - A + B + C once each over 3.35 TB/s;
//   digest  - 8 INT32 multiply-adds per A element (2 bytes x 4 bases) over
//             64 INT32 lanes per SM x 132 SMs x clock.
// At M=14336, K=5120, N=4096 the product binds (0.56 ms at 1980 MHz, against
// 0.13 ms of bytes and 0.04 ms of digest).
//
// The design. The product is bf16 tensor-core work (mma.sync m16n8k16, f32
// accumulate): a bf16 x bf16 product is exact in f32, so C differs from the
// TPU's f32 dot only in the order of summation. One block of 8 warps computes
// a 128 x 128 tile of C; a 4-stage ring of cp.async copies brings 128 x 32
// slabs of A and 32 x 128 slabs of B into padded shared memory (rows of 80
// and 272 bytes, so ldmatrix reads hit 8 distinct 16-byte bank groups), and
// each warp runs 64 x 32 of the tile from ldmatrix fragments. Edges: rows
// past M, columns past N and a K tail past the last whole slab are
// zero-filled by cp.async and masked on store; zeros add nothing to the
// product or the digest. Rows must be 16-byte multiples: K % 8 == 0 and
// N % 8 == 0.
//
// The digest rides on the blocks of the first column of C tiles
// (blockIdx.x == 0): each reads every A slab of its row block once anyway.
// After the slab lands in shared memory, thread t takes row t/2 and 16 of
// the slab's 32 columns: 32 byte terms of at most 255 * 46336 each
// (< 3.8e8), so a 32-bit sum reduced mod P once a slab cannot overflow.
// Its cost: 8 integer multiply-adds per element, plus 2 column-weight loads
// per element (from L1: the slab's 1 KiB of weights is shared by the block),
// which makes a digesting block about twice as slow per slab as a plain one.
// It is one block in N/128 (1 in 32 at N = 4096) and the grid walks column
// blocks fastest, so digesting blocks are spread over every wave.
// digest_sum_kernel then adds the blocks' partial residues mod P.
//
// An f32 B cannot go through the tensor cores (they would round it), so
// mm_digest_fma_kernel is a plain shared-memory kernel of f32 FMAs (128 x 128
// tile, 8 x 8 outputs a thread, slabs of K = 8) with the same digest.
//
// Not yet: wgmma, TMA, warp specialisation and a persistent grid (the
// tensor cores' full rate needs wgmma; mma.sync reaches part of it).

#include <cuda_runtime.h>
#include <stdint.h>
#include <limits.h>

namespace {

constexpr uint32_t kP = 46337;
constexpr int kBases = 4;
constexpr int kThreads = 256;                 // 8 warps
constexpr int kBM = 128;                      // C tile rows (both kernels)
constexpr int kBN = 128;                      // C tile columns (both kernels)
constexpr int kBK = 32;                       // K slab of the tensor-core kernel
constexpr int kStages = 4;                    // cp.async ring depth
constexpr int kALd = kBK + 8;                 // smem row of A: 40 bf16 = 80 B
constexpr int kBLd = kBN + 8;                 // smem row of B: 136 bf16 = 272 B
constexpr int kAStage = kBM * kALd;           // bf16 per A stage
constexpr int kBStage = kBK * kBLd;           // bf16 per B stage
constexpr int kSmemBytes = kStages * (kAStage + kBStage) * 2;   // 75,776 B
constexpr int kFBK = 8;                       // K slab of the FMA kernel

static_assert(kBM * kBK / 8 == 2 * kThreads, "A slab: two 16-byte copies a thread");
static_assert(kBK * kBN / 8 == 2 * kThreads, "B slab: two 16-byte copies a thread");
static_assert(kBM == kThreads / 2, "digest: two threads a row of the slab");

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int bytes = pred ? 16 : 0;             // 0: fill the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const void* smem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4], const void* smem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4], const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Adds the weighted bytes of 2*kWords consecutive bf16 codes of one row
// (columns col, col+1, ...) into acc. colw is (K, 8): per column the lo
// weights of the 4 bases, then the hi weights. Little-endian: the element
// at the lower column is the low half of each 32-bit word.
template <int kWords>
__device__ __forceinline__ void digest_words(uint32_t acc[kBases], const uint32_t* w,
                                             const uint4* __restrict__ colw, int col) {
#pragma unroll
  for (int q = 0; q < kWords; ++q) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint32_t code = (w[q] >> (16 * h)) & 0xFFFFu;
      const uint32_t lo = code & 0xFFu;
      const uint32_t hi = code >> 8;
      const int c = col + 2 * q + h;
      const uint4 wl = __ldg(colw + 2 * c);
      const uint4 wh = __ldg(colw + 2 * c + 1);
      acc[0] += lo * wl.x + hi * wh.x;
      acc[1] += lo * wl.y + hi * wh.y;
      acc[2] += lo * wl.z + hi * wh.z;
      acc[3] += lo * wl.w + hi * wh.w;
    }
  }
}

// Weights the thread's row sum by its row factor and adds the block's sums
// into partial[blockIdx.y]. Called by every thread of a digesting block.
__device__ void digest_finish(const uint32_t acc[kBases], const uint32_t* __restrict__ roww,
                              int M, int row, int4* __restrict__ partial) {
  __shared__ uint32_t part[kBases][kThreads / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int b = 0; b < kBases; ++b) {
    // (P-1)^2 < 2^32; 32 values < P add to < 2^21
    uint32_t t = row < M ? (acc[b] % kP) * __ldg(roww + static_cast<size_t>(b) * M + row) % kP
                         : 0u;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) t += __shfl_down_sync(0xffffffffu, t, off);
    if (lane == 0) part[b][warp] = t % kP;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    uint32_t h[kBases];
#pragma unroll
    for (int b = 0; b < kBases; ++b) {
      uint32_t s = 0;
#pragma unroll
      for (int w = 0; w < kThreads / 32; ++w) s += part[b][w];
      h[b] = s % kP;
    }
    partial[blockIdx.y] = make_int4(static_cast<int>(h[0]), static_cast<int>(h[1]),
                                    static_cast<int>(h[2]), static_cast<int>(h[3]));
  }
}

// Tensor-core kernel: bf16 A and B. Grid (ceil(N/128), ceil(M/128)).
__global__ void __launch_bounds__(kThreads)
mm_digest_mma_kernel(const uint16_t* __restrict__ A, const uint16_t* __restrict__ B,
                     float* __restrict__ C, int M, int N, int K,
                     const uint32_t* __restrict__ roww, const uint4* __restrict__ colw,
                     int4* __restrict__ partial) {
  extern __shared__ __align__(16) uint16_t smem[];
  uint16_t* sA = smem;                          // kStages x kBM x kALd
  uint16_t* sB = smem + kStages * kAStage;      // kStages x kBK x kBLd

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n0 = blockIdx.x * kBN;
  const int m0 = blockIdx.y * kBM;
  const int wm = (warp >> 2) * 64;              // warp tile: 64 rows x 32 columns
  const int wn = (warp & 3) * 32;
  const bool digest = blockIdx.x == 0;
  const int drow = tid >> 1;                    // digest: row of the slab
  const int dcol = (tid & 1) * 16;              //         first of 16 columns

  auto load_stage = [&](int stage, int kt) {
    const int k0 = kt * kBK;
    uint16_t* as = sA + stage * kAStage;
    uint16_t* bs = sB + stage * kBStage;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * kThreads;
      const int row = c >> 2, ch = c & 3;       // 128 rows x 4 chunks of 8 bf16
      const int gr = m0 + row, gc = k0 + ch * 8;
      const bool ok = gr < M && gc < K;
      cp_async16(as + row * kALd + ch * 8, ok ? A + static_cast<size_t>(gr) * K + gc : A, ok);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * kThreads;
      const int row = c >> 4, ch = c & 15;      // 32 rows x 16 chunks of 8 bf16
      const int gr = k0 + row, gc = n0 + ch * 8;
      const bool ok = gr < K && gc < N;
      cp_async16(bs + row * kBLd + ch * 8, ok ? B + static_cast<size_t>(gr) * N + gc : B, ok);
    }
  };

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  uint32_t dacc[kBases] = {0u, 0u, 0u, 0u};

  const int ktiles = (K + kBK - 1) / kBK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < ktiles) load_stage(s, s);
    cp_async_commit();
  }

  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();                            // slab kt landed; slab kt-1 consumed
    const int next = kt + kStages - 1;
    if (next < ktiles) load_stage(next % kStages, next);
    cp_async_commit();

    const uint16_t* as = sA + (kt % kStages) * kAStage;
    const uint16_t* bs = sB + (kt % kStages) * kBStage;

    if (digest) {
      const int col = kt * kBK + dcol;
      const uint4* v = reinterpret_cast<const uint4*>(as + drow * kALd + dcol);
#pragma unroll
      for (int g = 0; g < 2; ++g) {
        if (col + 8 * g < K) {                  // K % 8 == 0: whole groups only
          const uint4 x = v[g];
          const uint32_t w[4] = {x.x, x.y, x.z, x.w};
          digest_words<4>(dacc, w, colw, col + 8 * g);
        }
      }
#pragma unroll
      for (int b = 0; b < kBases; ++b) dacc[b] %= kP;
    }

#pragma unroll
    for (int ks = 0; ks < kBK / 16; ++ks) {
      uint32_t af[4][4];
      uint32_t bfr[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
        ldmatrix_x4(af[mi], as + (wm + mi * 16 + (lane & 15)) * kALd + ks * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int nj = 0; nj < 2; ++nj) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, bs + (ks * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * kBLd + wn +
                                 nj * 16 + (lane >> 4) * 8);
        bfr[2 * nj][0] = r[0];
        bfr[2 * nj][1] = r[1];
        bfr[2 * nj + 1][0] = r[2];
        bfr[2 * nj + 1][1] = r[3];
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_bf16(acc[mi][ni], af[mi], bfr[ni]);
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int row = m0 + wm + mi * 16 + (lane >> 2);
      const int col = n0 + wn + ni * 8 + (lane & 3) * 2;
      if (col < N) {                            // N even: col + 1 < N too
        if (row < M)
          *reinterpret_cast<float2*>(C + static_cast<size_t>(row) * N + col) =
              make_float2(acc[mi][ni][0], acc[mi][ni][1]);
        if (row + 8 < M)
          *reinterpret_cast<float2*>(C + static_cast<size_t>(row + 8) * N + col) =
              make_float2(acc[mi][ni][2], acc[mi][ni][3]);
      }
    }
  }
  if (digest) digest_finish(dacc, roww, M, m0 + drow, partial);
}

// CUDA-core kernel: bf16 A, f32 B, f32 FMAs. Grid (ceil(N/128), ceil(M/128)).
__global__ void __launch_bounds__(kThreads)
mm_digest_fma_kernel(const uint16_t* __restrict__ A, const float* __restrict__ B,
                     float* __restrict__ C, int M, int N, int K,
                     const uint32_t* __restrict__ roww, const uint4* __restrict__ colw,
                     int4* __restrict__ partial) {
  __shared__ __align__(16) float sA[kFBK][kBM];   // A slab, transposed, as f32
  __shared__ __align__(16) float sB[kFBK][kBN];

  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * kBN;
  const int m0 = blockIdx.y * kBM;
  const bool digest = blockIdx.x == 0;
  const int ar = tid >> 1, ah = (tid & 1) * 4;      // A loads: row, 4 of 8 columns
  const int br = tid >> 5, bc = (tid & 31) * 4;     // B loads: row, 4 columns
  const int tx = tid & 15, ty = tid >> 4;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  uint32_t dacc[kBases] = {0u, 0u, 0u, 0u};

  for (int k0 = 0; k0 < K; k0 += kFBK) {            // K % 8 == 0: whole slabs
    uint2 av = make_uint2(0u, 0u);
    if (m0 + ar < M)
      av = *reinterpret_cast<const uint2*>(A + static_cast<size_t>(m0 + ar) * K + k0 + ah);
    float4 bv = make_float4(0.f, 0.f, 0.f, 0.f);
    if (n0 + bc < N)
      bv = *reinterpret_cast<const float4*>(B + static_cast<size_t>(k0 + br) * N + n0 + bc);
    if (digest) {
      const uint32_t w[2] = {av.x, av.y};
      digest_words<2>(dacc, w, colw, k0 + ah);
#pragma unroll
      for (int b = 0; b < kBases; ++b) dacc[b] %= kP;
    }
    __syncthreads();                                 // the last slab is consumed
    // a bf16 code is the top half of its f32 bit pattern
    sA[ah + 0][ar] = __uint_as_float(av.x << 16);
    sA[ah + 1][ar] = __uint_as_float(av.x & 0xFFFF0000u);
    sA[ah + 2][ar] = __uint_as_float(av.y << 16);
    sA[ah + 3][ar] = __uint_as_float(av.y & 0xFFFF0000u);
    *reinterpret_cast<float4*>(&sB[br][bc]) = bv;
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kFBK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&sA[k][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&sA[k][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&sB[k][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&sB[k][64 + tx * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (row >= M) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int col = n0 + half * 64 + tx * 4;
      if (col < N)                                   // N % 8 == 0: whole groups
        *reinterpret_cast<float4*>(C + static_cast<size_t>(row) * N + col) =
            make_float4(acc[i][4 * half], acc[i][4 * half + 1], acc[i][4 * half + 2],
                        acc[i][4 * half + 3]);
    }
  }
  if (digest) digest_finish(dacc, roww, M, m0 + ar, partial);
}

// One block: out = sum of the row blocks' partial residues mod P.
__global__ void __launch_bounds__(kThreads)
digest_sum_kernel(const int4* __restrict__ partial, int blocks, int* __restrict__ out) {
  __shared__ uint32_t part[kBases][kThreads / 32];
  uint32_t s[kBases] = {0u, 0u, 0u, 0u};
  for (int i = threadIdx.x; i < blocks; i += kThreads) {   // < 256 terms of < P each
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
    for (int w = 0; w < kThreads / 32; ++w) sum += part[threadIdx.x][w];
    out[threadIdx.x] = static_cast<int>(sum % kP);
  }
}

}  // namespace

extern "C" {

// Layout constants, so the Python wrapper can refuse a library built for
// another tiling: {C tile rows, C tile columns, tensor-core K slab, threads}.
int mm_layout(int* out4) {
  out4[0] = kBM;
  out4[1] = kBN;
  out4[2] = kBK;
  out4[3] = kThreads;
  return 0;
}

// C = A @ B and the digest residues of A's blocked bytes.
//   a        device, (M, K) bf16, 16-byte aligned
//   b        device, (K, N) bf16 (b_f32 == 0) or f32 (b_f32 != 0), 16-byte aligned
//   c        device, (M, N) f32 output
//   roww     device, (4, M) int32 row factors
//   colw     device, (K, 8) int32 column factors (lo x 4 bases, hi x 4 bases)
//   partial  device scratch, (ceil(M/128), 4) int32
//   out      device, (4,) int32 residues
// K % 8 == 0 and N % 8 == 0. Launches on `stream` and returns the
// cudaError_t of the launches.
int mm_digest(int device, const void* a, const void* b, int b_f32, void* c, long long M,
              long long N, long long K, const void* roww, const void* colw, void* partial,
              void* out, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % 8 != 0 || N % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (M > INT_MAX || N > INT_MAX || K > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long mblocks = (M + kBM - 1) / kBM;
  const long long nblocks = (N + kBN - 1) / kBN;
  if (mblocks > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(nblocks), static_cast<unsigned>(mblocks));
  const uint16_t* a16 = static_cast<const uint16_t*>(a);
  const uint32_t* rw = static_cast<const uint32_t*>(roww);
  const uint4* cw = static_cast<const uint4*>(colw);
  int4* part = static_cast<int4*>(partial);
  if (b_f32) {
    mm_digest_fma_kernel<<<grid, kThreads, 0, st>>>(a16, static_cast<const float*>(b),
                                                    static_cast<float*>(c), static_cast<int>(M),
                                                    static_cast<int>(N), static_cast<int>(K), rw,
                                                    cw, part);
  } else {
    err = cudaFuncSetAttribute(mm_digest_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    mm_digest_mma_kernel<<<grid, kThreads, kSmemBytes, st>>>(
        a16, static_cast<const uint16_t*>(b), static_cast<float*>(c), static_cast<int>(M),
        static_cast<int>(N), static_cast<int>(K), rw, cw, part);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  digest_sum_kernel<<<1, kThreads, 0, st>>>(part, static_cast<int>(mblocks),
                                            static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
