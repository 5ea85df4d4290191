// Block hash for delta migration and chunk keys, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas kernels `block_hash_kernel` (src/repro/kernels/hash_delta/kernel.py:42,
// body `_hash_kernel` :34) and `block_hash_compare_kernel` (:69, body `_hash_compare_kernel` :58).
// Per 1024-element row: premix x <- (x ^ x>>16) * 2654435761, dot with each of two odd weight
// rows mod 2^32, finalize h <- (h ^ h>>15) * 2654435761.  The compare variant also writes a
// per-row `changed` flag against the prior lanes, in the same pass.
//
// What bounds it: bytes.  Each input byte is read once and takes a handful of integer
// operations (one premix, two multiply-adds), far below the H100's integer rate per byte of
// HBM bandwidth; tensor cores take no u32, so the card's memory rate is the roofline.
//
// What the design does about it:
//   * one warp per row, eight rows per 256-thread block: every lane issues 16-byte loads,
//     neighbouring lanes on neighbouring addresses, so each row is read in whole 512-byte
//     warp transactions;
//   * the 8 KiB of weights sit in shared memory, loaded once per block and read as 16-byte
//     vectors (conflict-free for the u32 grid);
//   * sums stay in uint32_t with natural wraparound and are reduced across the warp with
//     __shfl_xor_sync.  Unsigned addition mod 2^32 is exact in any order, so the lanes are
//     bit-identical to the reference's sequential sum;
//   * the element type is a template parameter (uint32_t or uint8_t): the chunk-key path
//     reads the packed payload bytes directly instead of a 4x widened u32 copy.
// The kernel allocates nothing and never synchronises; it runs on the caller's stream.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 1024;        // elements per hash row (hash_delta.ops.BLOCK)
constexpr int kLanes = 2;           // two independent uint32 lanes = one 64-bit identity
constexpr int kRowsPerCta = 8;      // one warp per row
constexpr int kThreads = 32 * kRowsPerCta;
constexpr uint32_t kPrime = 2654435761u;

__device__ __forceinline__ uint32_t premix(uint32_t x) { return (x ^ (x >> 16)) * kPrime; }
__device__ __forceinline__ uint32_t finalize(uint32_t h) { return (h ^ (h >> 15)) * kPrime; }

__device__ __forceinline__ void mac4(uint32_t e0, uint32_t e1, uint32_t e2, uint32_t e3,
                                     const uint4& u, const uint4& v,
                                     uint32_t& a0, uint32_t& a1) {
  uint32_t m;
  m = premix(e0); a0 += m * u.x; a1 += m * v.x;
  m = premix(e1); a0 += m * u.y; a1 += m * v.y;
  m = premix(e2); a0 += m * u.z; a1 += m * v.z;
  m = premix(e3); a0 += m * u.w; a1 += m * v.w;
}

// One lane's share of a row: the elements it loads, times their weights, summed mod 2^32.
template <typename T>
struct RowLoad;

template <>
struct RowLoad<uint32_t> {
  // 1024 u32 = 256 uint4; lane l takes uint4 number l + 32 c for c = 0..7.
  static __device__ __forceinline__ void accumulate(const uint32_t* row, const uint32_t* w0,
                                                    const uint32_t* w1, int lane,
                                                    uint32_t& a0, uint32_t& a1) {
    const uint4* r4 = reinterpret_cast<const uint4*>(row);
    const uint4* u4 = reinterpret_cast<const uint4*>(w0);
    const uint4* v4 = reinterpret_cast<const uint4*>(w1);
#pragma unroll
    for (int c = 0; c < kBlock / 4 / 32; ++c) {
      const int i = lane + 32 * c;
      const uint4 x = __ldg(r4 + i);
      mac4(x.x, x.y, x.z, x.w, u4[i], v4[i], a0, a1);
    }
  }
};

template <>
struct RowLoad<uint8_t> {
  // 1024 bytes = 64 uint4; lane l takes uint4 number l + 32 c for c = 0..1, i.e. the 16
  // elements 16 i .. 16 i + 15, each byte zero-extended (little-endian within a word).
  static __device__ __forceinline__ void accumulate(const uint8_t* row, const uint32_t* w0,
                                                    const uint32_t* w1, int lane,
                                                    uint32_t& a0, uint32_t& a1) {
    const uint4* r4 = reinterpret_cast<const uint4*>(row);
    const uint4* u4 = reinterpret_cast<const uint4*>(w0);
    const uint4* v4 = reinterpret_cast<const uint4*>(w1);
#pragma unroll
    for (int c = 0; c < kBlock / 16 / 32; ++c) {
      const int i = lane + 32 * c;
      const uint4 x = __ldg(r4 + i);
      const uint32_t words[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const uint32_t wd = words[k];
        mac4(wd & 0xffu, (wd >> 8) & 0xffu, (wd >> 16) & 0xffu, wd >> 24,
             u4[4 * i + k], v4[4 * i + k], a0, a1);
      }
    }
  }
};

template <typename T, bool kCompare>
__global__ void __launch_bounds__(kThreads)
hash_rows_kernel(const T* __restrict__ x, const uint32_t* __restrict__ w,
                 const uint32_t* __restrict__ prior, const uint32_t* __restrict__ has_prior,
                 uint32_t* __restrict__ h, uint32_t* __restrict__ changed, long long nb) {
  __shared__ __align__(16) uint32_t sw[kLanes * kBlock];
  const uint4* w4 = reinterpret_cast<const uint4*>(w);
  uint4* sw4 = reinterpret_cast<uint4*>(sw);
  for (int i = threadIdx.x; i < kLanes * kBlock / 4; i += kThreads) sw4[i] = __ldg(w4 + i);
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long row = static_cast<long long>(blockIdx.x) * kRowsPerCta + warp;
  if (row >= nb) return;  // ragged last block: after the only barrier

  uint32_t a0 = 0, a1 = 0;
  RowLoad<T>::accumulate(x + row * kBlock, sw, sw + kBlock, lane, a0, a1);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    a0 += __shfl_xor_sync(0xffffffffu, a0, off);
    a1 += __shfl_xor_sync(0xffffffffu, a1, off);
  }
  if (lane == 0) {
    const uint32_t h0 = finalize(a0), h1 = finalize(a1);
    h[kLanes * row] = h0;
    h[kLanes * row + 1] = h1;
    if (kCompare) {
      const bool same = h0 == prior[kLanes * row] && h1 == prior[kLanes * row + 1] &&
                        has_prior[row] != 0u;
      changed[row] = same ? 0u : 1u;
    }
  }
}

template <typename T, bool kCompare>
int launch(const void* x, const void* w, const void* prior, const void* has_prior, void* h,
           void* changed, long long nb, void* stream) {
  if (nb <= 0) return static_cast<int>(cudaSuccess);
  const long long blocks = (nb + kRowsPerCta - 1) / kRowsPerCta;
  hash_rows_kernel<T, kCompare><<<static_cast<unsigned>(blocks), kThreads, 0,
                                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const uint32_t*>(w),
      static_cast<const uint32_t*>(prior), static_cast<const uint32_t*>(has_prior),
      static_cast<uint32_t*>(h), static_cast<uint32_t*>(changed), nb);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface, loaded with ctypes.  x: (nb, 1024) u32 or u8 rows; w: (2, 1024) u32;
// prior: (nb, 2) u32; has_prior: (nb,) u32; h: (nb, 2) u32 out; changed: (nb,) u32 out.
// Every pointer is 16-byte aligned (the wrapper checks).  Returns cudaGetLastError().
extern "C" {

int hash_rows_u32(const void* x, const void* w, void* h, long long nb, void* stream) {
  return launch<uint32_t, false>(x, w, nullptr, nullptr, h, nullptr, nb, stream);
}

int hash_rows_u8(const void* x, const void* w, void* h, long long nb, void* stream) {
  return launch<uint8_t, false>(x, w, nullptr, nullptr, h, nullptr, nb, stream);
}

int hash_compare_rows_u32(const void* x, const void* w, const void* prior, const void* has_prior,
                          void* h, void* changed, long long nb, void* stream) {
  return launch<uint32_t, true>(x, w, prior, has_prior, h, changed, nb, stream);
}

int hash_compare_rows_u8(const void* x, const void* w, const void* prior, const void* has_prior,
                         void* h, void* changed, long long nb, void* stream) {
  return launch<uint8_t, true>(x, w, prior, has_prior, h, changed, nb, stream);
}

}  // extern "C"
