// RG-LRU linear recurrence h_t = a_t * h_{t-1} + b_t along S, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas kernel `rglru_scan_kernel` (src/repro/kernels/rg_lru/kernel.py:40, body
// `_rglru_kernel` :20).  a and b are (B,S,W), contiguous, one dtype (f32 or bf16).  The carry
// starts at zero and stays in f32; every step is a product then a sum, each rounded to f32
// (never a fused multiply-add), as the plain version computes it, so both give the same bits.
// h (B,S,W) and the final state h[:, S-1] (B,W) are stored in a's dtype in the same pass.
// Unlike the Pallas kernel (which asserts S % block_s == 0), any S >= 1 and any W are taken.
//
// The backward (`rglru_scan_bwd_f32`, training; the reference differentiates its associative
// scan with jax.grad, src/repro/models/griffin.py:55-68, and has no Pallas backward) is the same
// recurrence run in reverse: g_{S-1} = dh_{S-1} + dlast, g_t = dh_t + a_{t+1} g_{t+1}, then
// db_t = g_t and da_t = g_t h_{t-1} (h_{-1} = 0).  Each product and sum is rounded to f32 on its
// own, as the plain version (rg_lru/ref.py rglru_scan_bwd_ref) computes, so both give the same
// bits.  f32 only: the model's a and b are f32.
//
// What bounds them: bytes.  One multiply and one add per element over three elements moved
// (forward: a and b read, h written), two multiplies and one add over five (backward: a, h and dh
// read, da and db written): far below the card's balance point.  But each channel's recurrence
// is sequential in S, and S is never split (that would round in another order), so the parallel
// work is only B*W chains: 4,096 at a tensor-parallel rank's training shape.  The HBM rate is
// reached only if enough loads are in flight: about 3.35 TB/s x 0.7 us = 2.3 MB (Little's law),
// some 36-48 steps ahead of every chain at those widths.
//
// What the design does about it:
// - A block owns a band of 16 or 32 channels of one row b, so each step's slice of a tensor is
//   one 64- or 128-byte segment (f32).  The band is 32 where that still gives every SM a block,
//   else 16, so every SM holds work at the model's shapes (256 or 512 blocks at all four).
// - The operands stream through a ring of kStages tiles in shared memory, each kTileSteps steps
//   x band channels of every input, filled by cp.async (tc_sm90.cuh): while warp 0 runs the
//   chains over one tile, kStages - 1 tiles (96 steps) are in flight.  All kWarps warps of the
//   block issue the copies: on the card a one-warp block with the same ring kept its pace
//   however deep the ring (what one warp keeps in flight, not the ring, set it), and four warps
//   come near the HBM rate at every shape (PERF.md section 6).  cp.async and not TMA: a tile is
//   a strided 2-D box, and a tensor map needs libcuda's cuTensorMapEncodeTiled, which the nvcc
//   line does not link; cp.async needs no barrier object either, a wait_group and one
//   __syncthreads a tile suffice.
// - Warp 0 runs one chain a lane.  It reads a whole tile's operands from shared memory into
//   registers before the chain (a full tile's loop has no test a step, so nothing holds the
//   reads back), then stores h, or da and db, straight from registers: one coalesced segment a
//   step.  The backward's shifted operands come from the same tiles: a_{t+1} at a tile's top
//   edge is the tile above's bottom a, carried in a register; h_{t-1} at its bottom edge is the
//   tile below's top row, so the bottom row's da is stored one tile late; nothing is read twice.
// - Rows whose pitch (W x dtype size) is a multiple of 16 bytes are copied 16 bytes at a time
//   (the wrapper checks that every tensor starts 16-byte aligned); other pitches take the same
//   kernel with one-element copies into the same ring: 4-byte cp.async for f32, synchronous
//   loads and stores for bf16.
//
// The kernels allocate nothing and never synchronise; they run on the caller's stream.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tc_sm90.cuh"

namespace {

constexpr int kWarps = 4;          // a block: warp 0 runs the chains, every warp copies
constexpr int kThreads = 32 * kWarps;
constexpr int kTileSteps = 32;     // steps of S in one tile of the ring
constexpr int kStages = 4;         // tiles in the ring
constexpr int kMaxDevices = 64;
// the backward's ring at a band of 32: within the 48 KB of shared memory any kernel may take
static_assert(kStages * 3 * kTileSteps * 32 * 4 <= 48 * 1024, "the ring needs an opt-in");

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// This thread's share of copying one tile (kTileSteps rows x band channels): its column, its
// first row and the rows between its copies, and the bytes of a copy (16, or sizeof(T): one
// element).  A row takes band * sizeof(T) / bytes copies, a power of two, at most 32.
struct Share {
  int col, row, rows, bytes;
};

template <typename T>
__device__ __forceinline__ Share share_of(int band, int bytes, int tid) {
  const int per = bytes / static_cast<int>(sizeof(T));
  const int copies = band / per;
  return {(tid % copies) * per, tid / copies, kThreads / copies, bytes};
}

// Rows t0 .. t0 + kTileSteps - 1 and channels w0 .. w0 + band - 1 of one (S, W) slab (src points
// at its element (0, w0)) into dst (kTileSteps x band, row-major).  Rows at or past S and
// channels at or past W are zero.  The caller commits the cp.async group.
template <typename T>
__device__ __forceinline__ void copy_tile(T* dst, const T* __restrict__ src, int t0, int w0,
                                          int S, int W, int band, const Share& s) {
  const bool col_ok = w0 + s.col < W;
  for (int r = s.row; r < kTileSteps; r += s.rows) {
    const int t = t0 + r;
    const bool ok = col_ok && t < S;
    const T* from = ok ? src + static_cast<long long>(t) * W + s.col : src;
    T* to = dst + r * band + s.col;
    if (s.bytes == 16) {
      tc::cp_async16(to, from, ok);
    } else if (sizeof(T) == 4) {
      tc::cp_async4(to, from, ok);
    } else {  // one bf16: a plain load and store of the raw bits
      const uint16_t v = ok ? *reinterpret_cast<const uint16_t*>(from) : uint16_t{0};
      *reinterpret_cast<uint16_t*>(to) = v;
    }
  }
}

// The forward chain over one tile, for the lane whose column of the stage starts at la (a; b lies
// one tile further): rows 0 .. n-1, every row when kFull.  h_t goes to p + r * W.  Returns the
// carry.
template <bool kFull, typename T>
__device__ __forceinline__ float scan_tile(const T* la, int band, int tile, int n, float carry,
                                           T* p, long long W) {
  float av[kTileSteps], bv[kTileSteps];
#pragma unroll
  for (int r = 0; r < kTileSteps; ++r) {
    av[r] = to_f32(la[r * band]);
    bv[r] = to_f32(la[tile + r * band]);
  }
#pragma unroll
  for (int r = 0; r < kTileSteps; ++r) {
    if (kFull || r < n) {
      carry = __fadd_rn(__fmul_rn(av[r], carry), bv[r]);
      store(p, carry);
    }
    p += W;
  }
  return carry;
}

// The backward chain over one tile, rows n-1 .. 0 (every row when kFull), for the lane whose
// column starts at la (a; h one tile further, dh two).  g carries g_{t+1} in and g_t out; a_up is
// a_{t+1} of the tile's top row, and becomes this tile's bottom a.  db_t goes to pb + r * W, da_t
// to pa + r * W for rows above 0; row 0's da needs h_{t-1}, the next tile's top row: the caller
// stores it then.
template <bool kFull>
__device__ __forceinline__ float scan_tile_bwd(const float* la, int band, int tile, int n,
                                               float g, float& a_up, float* pa, float* pb,
                                               long long W) {
  float av[kTileSteps], hv[kTileSteps], dv[kTileSteps];
#pragma unroll
  for (int r = 0; r < kTileSteps; ++r) {
    av[r] = la[r * band];
    hv[r] = la[tile + r * band];
    dv[r] = la[2 * tile + r * band];
  }
  pa += (kTileSteps - 1) * W;
  pb += (kTileSteps - 1) * W;
#pragma unroll
  for (int r = kTileSteps - 1; r >= 0; --r) {
    if (kFull || r < n) {
      float an = a_up;  // at the tile's top row, and at t = S-1 (a_up is 1 there)
      if (r < kTileSteps - 1 && (kFull || r < n - 1)) an = av[r + 1];
      g = __fadd_rn(dv[r], __fmul_rn(an, g));
      *pb = g;
      if (r > 0) *pa = __fmul_rn(g, hv[r - 1]);
    }
    pa -= W;
    pb -= W;
  }
  a_up = av[0];
  return g;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
rglru_scan_kernel(const T* __restrict__ a, const T* __restrict__ b, T* __restrict__ h,
                  T* __restrict__ last, int S, int W, int band, int bytes) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* const ring = reinterpret_cast<T*>(smem);
  const int tile = kTileSteps * band;  // elements of one input's tile
  const int w0 = blockIdx.x * band;
  const long long slab = static_cast<long long>(blockIdx.y) * S * W;
  const T* const as = a + slab + w0;
  const T* const bs = b + slab + w0;
  const Share share = share_of<T>(band, bytes, threadIdx.x);
  const int nt = (S + kTileSteps - 1) / kTileSteps;

  auto fill = [&](int k) {  // tile k (steps k * kTileSteps ...) into its stage
    if (k < nt) {
      T* const st = ring + (k % kStages) * 2 * tile;
      copy_tile<T>(st, as, k * kTileSteps, w0, S, W, band, share);
      copy_tile<T>(st + tile, bs, k * kTileSteps, w0, S, W, band, share);
    }
    tc::cp_async_commit();
  };
  for (int k = 0; k < kStages - 1; ++k) fill(k);

  const int lane = threadIdx.x;  // the chain's channel, in warp 0
  const int w = w0 + lane;
  const bool mine = lane < band && w < W;
  T* const hw = h + slab + w;
  float carry = 0.f;
  for (int k = 0; k < nt; ++k) {
    tc::cp_async_wait<kStages - 2>();  // tile k has landed (this thread's copies)
    __syncthreads();                   // everyone's copies; and tile k - 1's chains are done
    fill(k + kStages - 1);             // into tile k - 1's stage
    if (mine) {
      const T* const la = ring + (k % kStages) * 2 * tile + lane;
      const int t0 = k * kTileSteps;
      const int n = S - t0;
      T* const p = hw + static_cast<long long>(t0) * W;
      carry = n >= kTileSteps ? scan_tile<true>(la, band, tile, n, carry, p, W)
                              : scan_tile<false>(la, band, tile, n, carry, p, W);
    }
  }
  if (mine) store(last + static_cast<long long>(blockIdx.y) * W + w, carry);
}

__global__ void __launch_bounds__(kThreads)
rglru_scan_bwd_kernel(const float* __restrict__ a, const float* __restrict__ h,
                      const float* __restrict__ dh, const float* __restrict__ dlast,
                      float* __restrict__ da, float* __restrict__ db, int S, int W, int band,
                      int bytes) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* const ring = reinterpret_cast<float*>(smem);
  const int tile = kTileSteps * band;
  const int w0 = blockIdx.x * band;
  const long long slab = static_cast<long long>(blockIdx.y) * S * W;
  const float* const as = a + slab + w0;
  const float* const hs = h + slab + w0;
  const float* const ds = dh + slab + w0;
  const Share share = share_of<float>(band, bytes, threadIdx.x);
  const int nt = (S + kTileSteps - 1) / kTileSteps;

  auto fill = [&](int k) {  // the k-th tile from the end (steps (nt-1-k) * kTileSteps ...)
    if (k < nt) {
      float* const st = ring + (k % kStages) * 3 * tile;
      const int t0 = (nt - 1 - k) * kTileSteps;
      copy_tile<float>(st, as, t0, w0, S, W, band, share);
      copy_tile<float>(st + tile, hs, t0, w0, S, W, band, share);
      copy_tile<float>(st + 2 * tile, ds, t0, w0, S, W, band, share);
    }
    tc::cp_async_commit();
  };
  for (int k = 0; k < kStages - 1; ++k) fill(k);

  const int lane = threadIdx.x;  // the chain's channel, in warp 0
  const int w = w0 + lane;
  const bool mine = lane < band && w < W;
  float* const daw = da + slab + w;
  float* const dbw = db + slab + w;
  // g_{S-1} = dh_{S-1} + 1 * g with g = dlast, or -0 (which leaves dh_{S-1}'s bits as they are)
  float g = mine && dlast != nullptr ? dlast[static_cast<long long>(blockIdx.y) * W + w] : -0.f;
  float a_up = 1.f;  // a_{t+1} for the tile's top row: the tile above's bottom a, 1 at t = S-1
  for (int k = 0; k < nt; ++k) {
    tc::cp_async_wait<kStages - 2>();
    __syncthreads();
    fill(k + kStages - 1);
    if (mine) {
      const float* const la = ring + (k % kStages) * 3 * tile + lane;
      const int t0 = (nt - 1 - k) * kTileSteps;
      // the tile above's bottom step: its h_{t-1} is this tile's top row
      if (k > 0)
        daw[static_cast<long long>(t0 + kTileSteps) * W] =
            __fmul_rn(g, la[tile + (kTileSteps - 1) * band]);
      const int n = S - t0;  // rows of this tile below S
      float* const pa = daw + static_cast<long long>(t0) * W;
      float* const pb = dbw + static_cast<long long>(t0) * W;
      g = n >= kTileSteps ? scan_tile_bwd<true>(la, band, tile, n, g, a_up, pa, pb, W)
                          : scan_tile_bwd<false>(la, band, tile, n, g, a_up, pa, pb, W);
    }
  }
  if (mine) daw[0] = __fmul_rn(g, 0.f);  // t = 0: h_{-1} = 0
}

// Streaming multiprocessors of the current device, asked once per device.
cudaError_t sm_count(int* out) {
  static int cached[kMaxDevices];  // 0 = not yet known; a race writes the same value
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && cached[dev] > 0) {
    *out = cached[dev];
    return cudaSuccess;
  }
  err = cudaDeviceGetAttribute(out, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess && dev < kMaxDevices) cached[dev] = *out;
  return err;
}

// A launch's shape: the band, the bytes a copy, the dynamic shared memory and the grid.
struct Plan {
  int band, bytes, smem;
  dim3 grid;
};

bool bad_sizes(long long B, long long S, long long W) {
  return S <= 0 || B > 65535 || S > INT32_MAX / 2 || W > INT32_MAX / 2;
}

// inputs: the tensors the ring holds (2 forward, 3 backward)
cudaError_t plan(long long B, long long W, int elem, int inputs, Plan* p) {
  int sms = 0;
  const cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  p->band = B * ((W + 31) / 32) >= sms ? 32 : 16;  // a band of 32 if every SM still gets a block
  p->bytes = W * elem % 16 == 0 ? 16 : elem;
  p->smem = kStages * inputs * kTileSteps * p->band * elem;
  p->grid = dim3(static_cast<unsigned>((W + p->band - 1) / p->band), static_cast<unsigned>(B));
  return cudaSuccess;
}

template <typename T>
int launch(const void* a, const void* b, void* h, void* last, long long B, long long S,
           long long W, void* stream) {
  if (B <= 0 || W <= 0) return static_cast<int>(cudaSuccess);
  if (bad_sizes(B, S, W)) return static_cast<int>(cudaErrorInvalidValue);
  Plan p;
  const cudaError_t err = plan(B, W, sizeof(T), 2, &p);
  if (err != cudaSuccess) return static_cast<int>(err);
  rglru_scan_kernel<T><<<p.grid, kThreads, p.smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<T*>(h),
      static_cast<T*>(last), static_cast<int>(S), static_cast<int>(W), p.band, p.bytes);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface, loaded with ctypes.  a/b/h: (B,S,W); last: (B,W); one dtype for all four,
// contiguous, 16-byte aligned (the wrapper checks).  S >= 1.  Returns a cudaError_t.
extern "C" {

int rglru_scan_f32(const void* a, const void* b, void* h, void* last, long long B, long long S,
                   long long W, void* stream) {
  return launch<float>(a, b, h, last, B, S, W, stream);
}

int rglru_scan_bf16(const void* a, const void* b, void* h, void* last, long long B, long long S,
                    long long W, void* stream) {
  return launch<__nv_bfloat16>(a, b, h, last, B, S, W, stream);
}

// a/h/dh/da/db: (B,S,W) f32, contiguous, 16-byte aligned; dlast: (B,W) f32, or null for a zero gradient of the
// final state.  S >= 1.  Returns a cudaError_t.
int rglru_scan_bwd_f32(const void* a, const void* h, const void* dh, const void* dlast, void* da,
                       void* db, long long B, long long S, long long W, void* stream) {
  if (B <= 0 || W <= 0) return static_cast<int>(cudaSuccess);
  if (bad_sizes(B, S, W)) return static_cast<int>(cudaErrorInvalidValue);
  Plan p;
  const cudaError_t err = plan(B, W, 4, 3, &p);
  if (err != cudaSuccess) return static_cast<int>(err);
  rglru_scan_bwd_kernel<<<p.grid, kThreads, p.smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(h),
      static_cast<const float*>(dh), static_cast<const float*>(dlast), static_cast<float*>(da),
      static_cast<float*>(db), static_cast<int>(S), static_cast<int>(W), p.band, p.bytes);
  return static_cast<int>(cudaGetLastError());
}

// The launch the entry points above make on the current device for (B,S,W) inputs: kind 0
// rglru_scan_f32, 1 rglru_scan_bf16, 2 rglru_scan_bwd_f32.  out: int32[6] = grid x, grid y,
// threads a block, dynamic shared memory a block (bytes), band (channels a block), bytes a copy
// (16, 4: one f32 by cp.async, or 2: one bf16 by a synchronous load and store).
int rglru_scan_config(long long B, long long S, long long W, long long kind, void* out) {
  if (B <= 0 || W <= 0 || bad_sizes(B, S, W) || kind < 0 || kind > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  Plan p;
  const cudaError_t err = plan(B, W, kind == 1 ? 2 : 4, kind == 2 ? 3 : 2, &p);
  if (err != cudaSuccess) return static_cast<int>(err);
  int* const o = static_cast<int*>(out);
  o[0] = static_cast<int>(p.grid.x);
  o[1] = static_cast<int>(p.grid.y);
  o[2] = kThreads;
  o[3] = p.smem;
  o[4] = p.band;
  o[5] = p.bytes;
  return static_cast<int>(cudaSuccess);
}

}  // extern "C"
