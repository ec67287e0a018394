// Hand-written Hopper (sm_90a) kernels for the mergeable GF(46337) chunk digest.
//
// Digest of a byte stream b_0..b_{n-1} for each of four bases r:
//     H_r = sum_j b_j * r^(n-1-j)  mod P,   P = 46337
// with the merge law H(A || B) = H(A) * r^len(B) + H(B).
//
// Replaces three Pallas TPU kernels of the JAX package:
//   * tile_hash_kernel<false> + combine_kernel, launched by ck_checksum with
//     one stream  -> repro/kernels/checksum.py checksum_words / _checksum_kernel
//   * the same pair over k streams
//                  -> repro/kernels/checksum.py checksum_many_words /
//                     _checksum_many_kernel
//   * tile_hash_kernel<true> + combine_kernel (copy from the same registers)
//                  -> repro/kernels/checksum.py checksum_copy_words /
//                     _checksum_copy_kernel
//
// Bound on this card: the larger of
//   bytes    - each input word read once (and, for the copy, written once)
//              over 3.35 TB/s of HBM3;
//   integer  - 16 multiply-adds a word (4 byte planes x 4 bases) over the
//              card's INT32 rate: 64 INT32 lanes per SM x 132 SMs x clock.
// At the boost clock the two are within 25% of each other (0.32 ms against
// 0.26 ms for 1 GiB), so the design keeps both streams lean:
//   * one block per (stream, 32 KiB tile); every thread issues its 8 coalesced
//     16-byte loads before any arithmetic, so 256 KiB per SM are in flight;
//   * no weight table in memory on the hot loop: the weight of byte p of
//     thread t's 16-byte vector in iteration i is G[t] * F[16 i + p], and the
//     128 factors F ride in the kernel's parameter space, so each
//     multiply-add reads its weight as a constant-bank operand (one IMAD, no
//     load);
//   * accumulation in 32 bits: 128 terms of at most 255 * 46336 stay below
//     2^31, so one reduction mod P per thread, one per block;
//   * the TPU grid walked tiles in order and carried the running digest; a
//     GPU grid runs in no order, so blocks write per-tile hashes h_i and
//     combine_kernel folds them by position, h_i * r^(T * (tiles-1-i)),
//     with the power table computed on the host and cached by tile count.
// No TMA or wgmma yet: the arithmetic is scalar integer work.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>
#include <limits.h>

namespace {

constexpr uint32_t kP = 46337;
constexpr int kBases = 4;
constexpr int kThreads = 256;                        // tile kernel block size
constexpr int kTileWords = 64 * 128;                 // ROWS x LANES: 32 KiB
constexpr int kVecPerTile = kTileWords / 4;          // int4 vectors per tile
constexpr int kIters = kVecPerTile / kThreads;       // 8 vectors per thread
constexpr int kFactors = kIters * 16;                // bytes per thread
constexpr int kCombineThreads = 512;

static_assert(kVecPerTile % kThreads == 0, "tile must split evenly");

// F[b][16 i + p] = r_b^-(16 * kThreads * i + p) mod P: byte p of a thread's
// vector in iteration i, relative to the thread's first byte.
struct Factors {
  uint32_t f[kBases][kFactors];
};
static_assert(sizeof(Factors) <= 3072, "factors must fit the parameter space");

template <bool kCopy>
__global__ void __launch_bounds__(kThreads)
tile_hash_kernel(const int4* __restrict__ words,
                 const uint32_t* __restrict__ g,      // (kBases, kThreads)
                 const Factors fac,
                 int4* __restrict__ tile_hash,        // (blocks,) x 4 residues
                 int4* __restrict__ copy) {
  const size_t tile = blockIdx.x;
  const int tid = threadIdx.x;
  const size_t base = tile * kVecPerTile + tid;

  int4 v[kIters];
#pragma unroll
  for (int i = 0; i < kIters; ++i) v[i] = __ldcs(words + base + i * kThreads);
  if (kCopy) {
#pragma unroll
    for (int i = 0; i < kIters; ++i) __stcs(copy + base + i * kThreads, v[i]);
  }

  uint32_t acc[kBases] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int i = 0; i < kIters; ++i) {
    const uint32_t w[4] = {static_cast<uint32_t>(v[i].x), static_cast<uint32_t>(v[i].y),
                           static_cast<uint32_t>(v[i].z), static_cast<uint32_t>(v[i].w)};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const uint32_t byte = (w[q] >> (8 * k)) & 0xFFu;   // logical shift
#pragma unroll
        for (int b = 0; b < kBases; ++b) acc[b] += byte * fac.f[b][16 * i + 4 * q + k];
      }
    }
  }

  __shared__ uint32_t part[kBases][kThreads / 32];
  const int lane = tid & 31;
  const int warp = tid >> 5;
#pragma unroll
  for (int b = 0; b < kBases; ++b) {
    // < P after the reduction; (P-1)^2 < 2^32; a block sums < 256 P
    uint32_t t = (acc[b] % kP) * __ldg(g + b * kThreads + tid) % kP;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) t += __shfl_down_sync(0xffffffffu, t, off);
    if (lane == 0) part[b][warp] = t;
  }
  __syncthreads();
  if (tid == 0) {
    uint32_t h[kBases];
#pragma unroll
    for (int b = 0; b < kBases; ++b) {
      uint32_t s = 0;
#pragma unroll
      for (int w = 0; w < kThreads / 32; ++w) s += part[b][w];
      h[b] = s % kP;
    }
    tile_hash[tile] = make_int4(static_cast<int>(h[0]), static_cast<int>(h[1]),
                                static_cast<int>(h[2]), static_cast<int>(h[3]));
  }
}

// One block per stream: H = sum_i h_i * r^(T * (tiles-1-i)) mod P.
__global__ void __launch_bounds__(kCombineThreads)
combine_kernel(const int4* __restrict__ tile_hash, long long tiles,
               const int4* __restrict__ powers,      // (tiles,) x 4
               int* __restrict__ out) {               // (streams, 4)
  const size_t s = blockIdx.x;
  const int tid = threadIdx.x;
  uint64_t acc[kBases] = {0, 0, 0, 0};
  for (long long i = tid; i < tiles; i += kCombineThreads) {
    const int4 h = tile_hash[s * tiles + i];
    const int4 p = __ldg(powers + i);
    // each product < P^2 < 2^31: 2^33 of them fit in 64 bits
    acc[0] += static_cast<uint64_t>(h.x) * static_cast<uint64_t>(p.x);
    acc[1] += static_cast<uint64_t>(h.y) * static_cast<uint64_t>(p.y);
    acc[2] += static_cast<uint64_t>(h.z) * static_cast<uint64_t>(p.z);
    acc[3] += static_cast<uint64_t>(h.w) * static_cast<uint64_t>(p.w);
  }
  __shared__ uint32_t part[kBases][kCombineThreads / 32];
  const int lane = tid & 31;
  const int warp = tid >> 5;
#pragma unroll
  for (int b = 0; b < kBases; ++b) {
    uint32_t t = static_cast<uint32_t>(acc[b] % kP);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) t += __shfl_down_sync(0xffffffffu, t, off);
    if (lane == 0) part[b][warp] = t;
  }
  __syncthreads();
  if (tid < kBases) {
    uint32_t sum = 0;
    for (int w = 0; w < kCombineThreads / 32; ++w) sum += part[tid][w];
    out[s * kBases + tid] = static_cast<int>(sum % kP);
  }
}

}  // namespace

extern "C" {

// Layout constants, so the Python wrapper can refuse a library built for
// another tiling: {tile words, threads per tile block, factors per base}.
int ck_layout(int* out3) {
  out3[0] = kTileWords;
  out3[1] = kThreads;
  out3[2] = kFactors;
  return 0;
}

// Digest `streams` equal-length int32 streams of `tiles` tiles each.
//   words      device, (streams, tiles * kTileWords) int32, 16-byte aligned
//   g          device, (kBases, kThreads) int32 per-thread weights
//   factors    HOST,   (kBases, kFactors) int32, copied into the launch
//   powers     device, (tiles, kBases) int32 positional weights
//   tile_hash  device scratch, (streams, tiles, kBases) int32
//   out        device, (streams, kBases) int32
//   copy       device, like words, or null: also store the stream there
// Launches on `stream` and returns the cudaError_t of the launches.
int ck_checksum(int device, const void* words, long long streams, long long tiles,
                const void* g, const void* factors, const void* powers,
                void* tile_hash, void* out, void* copy, void* stream) {
  if (streams <= 0 || tiles <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (streams > INT_MAX || tiles > INT_MAX / streams)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  Factors fac;
  memcpy(&fac, factors, sizeof(fac));
  const unsigned blocks = static_cast<unsigned>(streams * tiles);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int4* w4 = static_cast<const int4*>(words);
  const uint32_t* g32 = static_cast<const uint32_t*>(g);
  int4* th = static_cast<int4*>(tile_hash);
  if (copy != nullptr) {
    tile_hash_kernel<true><<<blocks, kThreads, 0, st>>>(w4, g32, fac, th,
                                                         static_cast<int4*>(copy));
  } else {
    tile_hash_kernel<false><<<blocks, kThreads, 0, st>>>(w4, g32, fac, th, nullptr);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  combine_kernel<<<static_cast<unsigned>(streams), kCombineThreads, 0, st>>>(
      th, tiles, static_cast<const int4*>(powers), static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}

const char* ck_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
