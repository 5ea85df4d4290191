// Block hash for delta migration, chunk keys and batched leaf digests, hand-written for Hopper
// (sm_90a).
//
// Replaces the Pallas kernels `block_hash_kernel` (src/repro/kernels/hash_delta/kernel.py:42,
// body `_hash_kernel` :34) and `block_hash_compare_kernel` (:69, body `_hash_compare_kernel` :58),
// and, in the fold entry points, also the per-leaf fold that the reference runs in XLA around
// its Pallas call (src/repro/kernels/hash_delta/ops.py:319 `_batched_lanes`, a segment_sum).
// Per 1024-element row: premix x <- (x ^ x>>16) * 2654435761, dot with each of two odd weight
// rows mod 2^32, finalize h <- (h ^ h>>15) * 2654435761.  The compare variant also writes a
// per-row `changed` flag against the prior lanes; the fold variant adds h * idx[row] into the
// lanes of leaf seg[row] instead of writing h.
//
// What bounds it: bytes.  Each input byte is read once and takes two or three integer
// operations, below the H100's integer rate per byte of HBM bandwidth; tensor cores take no
// u32, so the card's memory rate is the roofline.
//
// What the design does about it:
//   * a persistent grid: as many 128-thread blocks as fit on the card at once (SMs times
//     blocks per SM, from the occupancy calculator), capped by the rows; each warp hashes one
//     contiguous range of rows in a loop;
//   * the weights live in registers: under the lane -> column map below a lane always reads
//     the same 32 columns, so it loads its 2 x 32 weights once, straight from global memory,
//     premultiplied by the premix prime (exact mod 2^32), and keeps them for every row.  No
//     shared memory and no barrier;
//   * loads in flight: a stage is 4 KiB a warp (one u32 row or four u8 rows, 16-byte loads,
//     neighbouring lanes on neighbouring addresses, streamed past L1), and the next stage's
//     loads are issued before the current stage's products, so a warp always has a stage in
//     flight.  The per-row side data (prior lanes, has_prior, fold weight, segment) of a
//     stage is loaded with it by the lane that will own the row's result;
//   * sums stay in uint32_t with natural wraparound and are reduced across the warp with
//     __shfl_xor_sync, the stage's 2 x rows values together (warp_sum_transposed: 9 shuffles
//     for a u8 stage instead of 40).  Unsigned addition mod 2^32 is exact in any order, so the
//     lanes are bit-identical to the reference's sequential sum;
//   * the fold: each row slot of a warp (one for u32, four for u8) keeps its running sum for
//     the current segment in its owner lane's registers and flushes it with one atomicAdd per
//     lane of the hash when the segment changes and when the range ends: at most
//     4 x (warps + leaves) atomics, whatever the leaves' sizes, and exact;
//   * the element type is a template parameter (uint32_t or uint8_t): the chunk-key path reads
//     the packed payload bytes directly.  A byte's premix is the byte times the prime (x >> 16
//     is 0), so the u8 route costs one byte extract and two multiply-adds an element.
// The kernel allocates nothing and never synchronises; it runs on the caller's stream.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 1024;        // elements per hash row (hash_delta.ops.BLOCK)
constexpr int kLanes = 2;           // two independent uint32 lanes = one 64-bit identity
constexpr int kWarps = 4;           // warps per block
constexpr int kThreads = 32 * kWarps;
constexpr int kVecs = 8;            // uint4 loads a lane issues per stage (4 KiB a warp)
constexpr int kCols = 32;           // columns a lane owns (weights per lane per hash lane)
constexpr uint32_t kPrime = 2654435761u;
constexpr int kMaxDevices = 64;

enum Mode { kHash = 0, kCompare = 1, kFold = 2 };

__device__ __forceinline__ uint32_t finalize(uint32_t h) { return (h ^ (h >> 15)) * kPrime; }

// A 16-byte streaming load: read-only, not kept in L1, with a 256-byte L2 prefetch.
__device__ __forceinline__ uint4 ld_stream(const void* p) {
  uint4 v;
  asm volatile("ld.global.nc.L1::no_allocate.L2::256B.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p));
  return v;
}

// The lane -> column map of each element type.  A stage holds kRows rows of kVecs / kRows
// uint4 a lane.  Weight vector v of a lane (v = 0..7, four columns each) covers the columns
// whose elements arrive in the lane's load vectors in the same order.
template <typename T>
struct Route;

template <>
struct Route<uint32_t> {
  // 1024 u32 = 256 uint4; lane l takes uint4 number l + 32 c, c = 0..7 (columns 4 (l + 32 c)
  // .. + 3).  One row a stage.
  static constexpr int kRows = 1;
  static __device__ __forceinline__ int weight_vec(int lane, int v) { return lane + 32 * v; }
  static __device__ __forceinline__ const uint4* row_vec(const uint32_t* x, long long row,
                                                         int lane, int c) {
    return reinterpret_cast<const uint4*>(x + row * kBlock) + lane + 32 * c;
  }
  // a0[g], a1[g]: the lane's partial sums of row g of the stage
  static __device__ __forceinline__ void accumulate(const uint4 (&xs)[kVecs],
                                                    const uint32_t (&w0)[kCols],
                                                    const uint32_t (&w1)[kCols],
                                                    uint32_t (&a0)[kRows], uint32_t (&a1)[kRows]) {
    uint32_t s0[4] = {0, 0, 0, 0}, s1[4] = {0, 0, 0, 0};  // four independent chains
#pragma unroll
    for (int c = 0; c < kVecs; ++c) {
      const uint32_t e[4] = {xs[c].x, xs[c].y, xs[c].z, xs[c].w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint32_t m = e[j] ^ (e[j] >> 16);
        s0[j] += m * w0[4 * c + j];
        s1[j] += m * w1[4 * c + j];
      }
    }
    a0[0] = (s0[0] + s0[1]) + (s0[2] + s0[3]);
    a1[0] = (s1[0] + s1[1]) + (s1[2] + s1[3]);
  }
};

template <>
struct Route<uint8_t> {
  // 1024 bytes = 64 uint4; lane l takes uint4 number l + 32 c, c = 0..1 (bytes 16 (l + 32 c)
  // .. + 15, each zero-extended, little-endian within a word).  Four rows a stage.
  static constexpr int kRows = 4;
  static __device__ __forceinline__ int weight_vec(int lane, int v) {
    return 4 * (lane + 32 * (v / 4)) + v % 4;
  }
  static __device__ __forceinline__ const uint4* row_vec(const uint8_t* x, long long row,
                                                         int lane, int c) {
    return reinterpret_cast<const uint4*>(x + row * kBlock) + lane + 32 * c;
  }
  static __device__ __forceinline__ void accumulate(const uint4 (&xs)[kVecs],
                                                    const uint32_t (&w0)[kCols],
                                                    const uint32_t (&w1)[kCols],
                                                    uint32_t (&a0)[kRows], uint32_t (&a1)[kRows]) {
#pragma unroll
    for (int g = 0; g < kRows; ++g) {  // the four rows are four independent chains
      uint32_t s0 = 0, s1 = 0;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const uint4 v = xs[2 * g + c];
        const uint32_t words[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
#pragma unroll
          for (int b = 0; b < 4; ++b) {
            const uint32_t m = __byte_perm(words[q], 0u, 0x4440u + b);  // byte b, zero-extended
            s0 += m * w0[16 * c + 4 * q + b];
            s1 += m * w1[16 * c + 4 * q + b];
          }
        }
      }
      a0[g] = s0;
      a1[g] = s1;
    }
  }
};

// What a mode reads beside the rows, and where it writes.
struct Args {
  const uint32_t* prior;      // kCompare: (nb, 2)
  const uint32_t* has_prior;  // kCompare: (nb,)
  const uint32_t* idx;        // kFold: (nb,) fold weight of each row
  const int32_t* seg;         // kFold: (nb,) leaf of each row
  uint32_t* h;                // kHash, kCompare: (nb, 2)
  uint32_t* changed;          // kCompare: (nb,)
  uint32_t* lanes;            // kFold: (num_leaves, 2), zeroed by the caller
  long long num_leaves;
};

// The lanes' 2 R partial sums of a stage of R rows (value 2 g + k is hash lane k of row g) are
// reduced across the warp by transposing halves: at each of the first log2(2 R) steps a lane
// keeps the half of its values that its lane bit selects and trades the other half with its
// partner; then a plain butterfly over the lane bits left.  2 R values cost 9 shuffles for a
// u8 stage (R = 4) and 5 for u32 (R = 1), instead of 5 each.
// Lane l ends with the full sum of value l / (16 / R): lanes 32 g / R .. hold row g's lane 0,
// the 16 / R lanes after them its lane 1.  The first of those lanes, the row's owner, writes
// the row's results and holds its side data.
template <int kRows>
struct Owner {
  static constexpr int kSpan = 32 / kRows;  // lanes per row after the reduction
  static __device__ __forceinline__ bool owns(int lane) { return lane % kSpan == 0; }
  static __device__ __forceinline__ int row(int lane) { return lane / kSpan; }
};

template <int kValues>
__device__ __forceinline__ uint32_t warp_sum_transposed(uint32_t (&v)[kValues], int lane) {
#pragma unroll
  for (int step = 0; (1 << step) < kValues; ++step) {
    const int half = kValues >> (step + 1);
    const int off = 16 >> step;
    const bool upper = (lane & off) != 0;
#pragma unroll
    for (int j = 0; j < half; ++j) {
      const uint32_t send = upper ? v[j] : v[j + half];
      const uint32_t keep = upper ? v[j + half] : v[j];
      v[j] = keep + __shfl_xor_sync(0xffffffffu, send, off);
    }
  }
  uint32_t s = v[0];
#pragma unroll
  for (int off = 16 / kValues; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  return s;
}

// One stage in registers: the lanes' load vectors and, in each row's owner, its side data.
struct Stage {
  uint4 xs[kVecs];
  uint32_t s0, s1, s2;
};

template <typename T, Mode kMode>
__device__ __forceinline__ void load_stage(const T* __restrict__ x, const Args& a, long long r,
                                           long long end, int lane, Stage& st) {
  using R = Route<T>;
  using O = Owner<R::kRows>;
  constexpr int per_row = kVecs / R::kRows;
#pragma unroll
  for (int g = 0; g < R::kRows; ++g) {
#pragma unroll
    for (int c = 0; c < per_row; ++c) {
      st.xs[per_row * g + c] = r + g < end ? ld_stream(R::row_vec(x, r + g, lane, c))
                                           : make_uint4(0u, 0u, 0u, 0u);
    }
  }
  const long long mine = r + O::row(lane);
  const bool side = O::owns(lane) && mine < end;
  st.s0 = st.s1 = st.s2 = 0u;
  if constexpr (kMode == kCompare) {
    if (side) {
      const uint2 p = __ldg(reinterpret_cast<const uint2*>(a.prior) + mine);
      st.s0 = p.x;
      st.s1 = p.y;
      st.s2 = __ldg(a.has_prior + mine);
    }
  }
  if constexpr (kMode == kFold) {
    if (side) {
      st.s0 = __ldg(a.idx + mine);
      st.s1 = static_cast<uint32_t>(__ldg(a.seg + mine));
    }
  }
}

// The running fold of one row slot of a warp: the segment it is summing and its two lanes'
// partial sums.  Each owner lane keeps its own.
struct Fold {
  long long seg;
  uint32_t f0, f1;
};

__device__ __forceinline__ void flush(const Args& a, const Fold& f) {
  if (f.seg >= 0 && f.seg < a.num_leaves) {
    atomicAdd(a.lanes + kLanes * f.seg, f.f0);
    atomicAdd(a.lanes + kLanes * f.seg + 1, f.f1);
  }
}

template <typename T, Mode kMode>
__device__ __forceinline__ void hash_stage(const Stage& st, const uint32_t (&w0)[kCols],
                                           const uint32_t (&w1)[kCols], const Args& a,
                                           long long r, long long end, int lane, Fold& fold) {
  using R = Route<T>;
  using O = Owner<R::kRows>;
  uint32_t a0[R::kRows], a1[R::kRows], v[2 * R::kRows];
  R::accumulate(st.xs, w0, w1, a0, a1);
#pragma unroll
  for (int g = 0; g < R::kRows; ++g) {
    v[2 * g] = a0[g];
    v[2 * g + 1] = a1[g];
  }
  const uint32_t mine = finalize(warp_sum_transposed(v, lane));
  const uint32_t other = __shfl_xor_sync(0xffffffffu, mine, O::kSpan / 2);
  const long long row = r + O::row(lane);
  if (!O::owns(lane) || row >= end) return;
  const uint32_t h0 = mine, h1 = other;  // an owner holds lane 0 of its row
  if constexpr (kMode == kFold) {
    const long long seg = static_cast<int32_t>(st.s1);
    if (seg != fold.seg) {
      flush(a, fold);
      fold = Fold{seg, 0u, 0u};
    }
    fold.f0 += h0 * st.s0;
    fold.f1 += h1 * st.s0;
  } else {
    *reinterpret_cast<uint2*>(a.h + kLanes * row) = make_uint2(h0, h1);
    if constexpr (kMode == kCompare) {
      a.changed[row] = (h0 == st.s0 && h1 == st.s1 && st.s2 != 0u) ? 0u : 1u;
    }
  }
}

template <typename T, Mode kMode>
__global__ void __launch_bounds__(kThreads)
hash_rows_kernel(const T* __restrict__ x, const uint32_t* __restrict__ w, Args a, long long nb) {
  using R = Route<T>;
  const int lane = threadIdx.x & 31;
  const long long warps = static_cast<long long>(gridDim.x) * kWarps;
  const long long warp = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  const long long begin = nb * warp / warps, end = nb * (warp + 1) / warps;
  if (begin >= end) return;  // fewer rows than warps; the kernel has no barrier

  // this lane's 2 x 32 weights, premultiplied by the premix prime
  uint32_t w0[kCols], w1[kCols];
  const uint4* w4 = reinterpret_cast<const uint4*>(w);
#pragma unroll
  for (int v = 0; v < kCols / 4; ++v) {
    const uint4 u = __ldg(w4 + R::weight_vec(lane, v));
    const uint4 t = __ldg(w4 + kBlock / 4 + R::weight_vec(lane, v));
    w0[4 * v] = u.x * kPrime; w0[4 * v + 1] = u.y * kPrime;
    w0[4 * v + 2] = u.z * kPrime; w0[4 * v + 3] = u.w * kPrime;
    w1[4 * v] = t.x * kPrime; w1[4 * v + 1] = t.y * kPrime;
    w1[4 * v + 2] = t.z * kPrime; w1[4 * v + 3] = t.w * kPrime;
  }

  // two stages in registers: the next one's loads go out before the current one's products
  Fold fold = {-1, 0u, 0u};
  Stage sa, sb;
  load_stage<T, kMode>(x, a, begin, end, lane, sa);
  for (long long r = begin; r < end; r += 2 * R::kRows) {
    if (r + R::kRows < end) load_stage<T, kMode>(x, a, r + R::kRows, end, lane, sb);
    hash_stage<T, kMode>(sa, w0, w1, a, r, end, lane, fold);
    if (r + R::kRows >= end) break;
    if (r + 2 * R::kRows < end) load_stage<T, kMode>(x, a, r + 2 * R::kRows, end, lane, sa);
    hash_stage<T, kMode>(sb, w0, w1, a, r + R::kRows, end, lane, fold);
  }
  if constexpr (kMode == kFold) {
    if (Owner<R::kRows>::owns(lane)) flush(a, fold);
  }
}

// Blocks of the persistent grid on the current device: SMs times resident blocks per SM.
template <typename T, Mode kMode>
cudaError_t grid_blocks(int* out) {
  static int cached[kMaxDevices];  // 0 = not yet known; a race writes the same value
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && cached[dev] > 0) {
    *out = cached[dev];
    return cudaSuccess;
  }
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, hash_rows_kernel<T, kMode>,
                                                      kThreads, 0);
  if (err != cudaSuccess) return err;
  *out = sms * (per_sm > 0 ? per_sm : 1);
  if (dev < kMaxDevices) cached[dev] = *out;
  return cudaSuccess;
}

template <typename T, Mode kMode>
int launch(const void* x, const void* w, const Args& a, long long nb, void* stream) {
  if (nb <= 0) return static_cast<int>(cudaSuccess);
  int blocks = 0;
  const cudaError_t err = grid_blocks<T, kMode>(&blocks);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long need = (nb + kWarps - 1) / kWarps;  // at least one row a warp
  if (need < blocks) blocks = static_cast<int>(need);
  hash_rows_kernel<T, kMode><<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const uint32_t*>(w), a, nb);
  return static_cast<int>(cudaGetLastError());
}

Args hash_args(void* h) { return {nullptr, nullptr, nullptr, nullptr, static_cast<uint32_t*>(h),
                                  nullptr, nullptr, 0}; }

Args compare_args(const void* prior, const void* has_prior, void* h, void* changed) {
  return {static_cast<const uint32_t*>(prior), static_cast<const uint32_t*>(has_prior), nullptr,
          nullptr, static_cast<uint32_t*>(h), static_cast<uint32_t*>(changed), nullptr, 0};
}

Args fold_args(const void* idx, const void* seg, void* lanes_out, long long num_leaves) {
  return {nullptr, nullptr, static_cast<const uint32_t*>(idx), static_cast<const int32_t*>(seg),
          nullptr, nullptr, static_cast<uint32_t*>(lanes_out), num_leaves};
}

}  // namespace

// Plain C interface, loaded with ctypes.  x: (nb, 1024) u32 or u8 rows; w: (2, 1024) u32;
// prior: (nb, 2) u32; has_prior: (nb,) u32; h: (nb, 2) u32 out; changed: (nb,) u32 out;
// idx: (nb,) u32 fold weight of each row; seg: (nb,) i32 leaf of each row, in
// [0, num_leaves) (rows outside are skipped); lanes_out: (num_leaves, 2) u32, zeroed by the
// caller, receives each leaf's sum of h * idx mod 2^32.  x, w, h and lanes_out are 16-byte
// aligned (the wrapper checks).  Returns cudaGetLastError().
extern "C" {

int hash_rows_u32(const void* x, const void* w, void* h, long long nb, void* stream) {
  return launch<uint32_t, kHash>(x, w, hash_args(h), nb, stream);
}

int hash_rows_u8(const void* x, const void* w, void* h, long long nb, void* stream) {
  return launch<uint8_t, kHash>(x, w, hash_args(h), nb, stream);
}

int hash_compare_rows_u32(const void* x, const void* w, const void* prior, const void* has_prior,
                          void* h, void* changed, long long nb, void* stream) {
  return launch<uint32_t, kCompare>(x, w, compare_args(prior, has_prior, h, changed), nb,
                                    stream);
}

int hash_compare_rows_u8(const void* x, const void* w, const void* prior, const void* has_prior,
                         void* h, void* changed, long long nb, void* stream) {
  return launch<uint8_t, kCompare>(x, w, compare_args(prior, has_prior, h, changed), nb, stream);
}

int hash_fold_rows_u32(const void* x, const void* w, const void* idx, const void* seg,
                       void* lanes_out, long long nb, long long num_leaves, void* stream) {
  return launch<uint32_t, kFold>(x, w, fold_args(idx, seg, lanes_out, num_leaves), nb, stream);
}

int hash_fold_rows_u8(const void* x, const void* w, const void* idx, const void* seg,
                      void* lanes_out, long long nb, long long num_leaves, void* stream) {
  return launch<uint8_t, kFold>(x, w, fold_args(idx, seg, lanes_out, num_leaves), nb, stream);
}

// Warps of the persistent grid on the current device for an element size (4 or 1) and a mode
// (0 hash, 1 compare, 2 fold); on failure, the CUDA error code negated.
int hash_grid_warps(int elem_bytes, int mode) {
  int blocks = 0;
  cudaError_t err = cudaErrorInvalidValue;
  if (elem_bytes == 4 && mode == kHash) err = grid_blocks<uint32_t, kHash>(&blocks);
  if (elem_bytes == 4 && mode == kCompare) err = grid_blocks<uint32_t, kCompare>(&blocks);
  if (elem_bytes == 4 && mode == kFold) err = grid_blocks<uint32_t, kFold>(&blocks);
  if (elem_bytes == 1 && mode == kHash) err = grid_blocks<uint8_t, kHash>(&blocks);
  if (elem_bytes == 1 && mode == kCompare) err = grid_blocks<uint8_t, kCompare>(&blocks);
  if (elem_bytes == 1 && mode == kFold) err = grid_blocks<uint8_t, kFold>(&blocks);
  return err == cudaSuccess ? blocks * kWarps : -static_cast<int>(err);
}

}  // extern "C"
