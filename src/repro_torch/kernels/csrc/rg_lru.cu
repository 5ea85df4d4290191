// RG-LRU linear recurrence h_t = a_t * h_{t-1} + b_t along S, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas kernel `rglru_scan_kernel` (src/repro/kernels/rg_lru/kernel.py:40, body
// `_rglru_kernel` :20).  a and b are (B,S,W), contiguous, one dtype (f32 or bf16).  The carry
// starts at zero and stays in f32; every step is a product then a sum, each rounded to f32
// (never a fused multiply-add), as the plain version computes it, so both give the same bits.
// h (B,S,W) and the final state h[:, S-1] (B,W) are stored in a's dtype in the same pass.
// Unlike the Pallas kernel (which asserts S % block_s == 0), any S >= 1 and any W are taken.
//
// What bounds it: bytes.  One multiply and one add per element over three elements moved (a
// and b read, h written): far below the card's balance point.  But the recurrence is
// sequential in S, so the parallel work is only B*W channels (16,384 at recurrentgemma-9b's
// serve shape, about four warps per SM): the latency of each load, not the HBM rate, sets the
// pace unless many loads are in flight.
//
// What the design does about it (simple and right first; a chunked two-pass scan that splits
// S across blocks comes in a later change): one thread per (b, channel), 128 threads per block
// along W, so a warp's loads and stores of one step are 128 contiguous bytes (f32).  Each
// thread walks S in steps of kUnroll: it starts the loads of the next kUnroll steps of a and b
// into registers before it runs the current steps' dependent chain, so 2*kUnroll loads are in
// flight while the chain runs.
//
// The backward (`rglru_scan_bwd_f32`, training; the reference differentiates its associative
// scan with jax.grad, src/repro/models/griffin.py:55-68, and has no Pallas backward) is the same
// recurrence run in reverse: g_{S-1} = dh_{S-1} + dlast, g_t = dh_t + a_{t+1} g_{t+1}, then
// db_t = g_t and da_t = g_t h_{t-1} (h_{-1} = 0).  It is bounded by bytes as the forward is (a, h
// and dh read, da and db written: five elements moved for two multiplies and one add), and laid
// out as the forward: one thread per (b, channel), 128 channels a block, kUnroll steps of a, h
// and dh loaded ahead of the dependent chain, walking S downwards.  Each product and sum is
// rounded to f32 on its own, as the plain version (rg_lru/ref.py rglru_scan_bwd_ref) computes,
// so both give the same bits.  f32 only: the model's a and b are f32.
//
// The kernels allocate nothing and never synchronise; they run on the caller's stream.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;    // channels per block
constexpr int kUnroll = 16;      // steps of S loaded ahead of the chain

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// Loads steps [t0, t0 + kUnroll) of one channel; steps at or past S get a = 1, b = 0, which
// leave the carry as it is.
template <typename T>
__device__ __forceinline__ void load_steps(float* av, float* bv, const T* __restrict__ a,
                                           const T* __restrict__ b, long long off, int t0,
                                           int S, int W) {
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int t = t0 + u;
    const long long i = off + static_cast<long long>(t) * W;
    av[u] = t < S ? to_f32(a[i]) : 1.f;
    bv[u] = t < S ? to_f32(b[i]) : 0.f;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
rglru_scan_kernel(const T* __restrict__ a, const T* __restrict__ b, T* __restrict__ h,
                  T* __restrict__ last, int S, int W) {
  const int w = blockIdx.x * kThreads + threadIdx.x;
  if (w >= W) return;
  const long long bi = blockIdx.y;
  const long long off = bi * S * W + w;     // element (bi, 0, w)

  float av[kUnroll], bv[kUnroll], an[kUnroll], bn[kUnroll];
  load_steps<T>(av, bv, a, b, off, 0, S, W);
  float carry = 0.f;
  for (int t0 = 0; t0 < S; t0 += kUnroll) {
    if (t0 + kUnroll < S) load_steps<T>(an, bn, a, b, off, t0 + kUnroll, S, W);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      carry = __fadd_rn(__fmul_rn(av[u], carry), bv[u]);
      const int t = t0 + u;
      if (t < S) store(h + off + static_cast<long long>(t) * W, carry);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      av[u] = an[u];
      bv[u] = bn[u];
    }
  }
  store(last + bi * W + w, carry);
}

template <typename T>
int launch(const void* a, const void* b, void* h, void* last, long long B, long long S,
           long long W, void* stream) {
  if (B <= 0 || W <= 0) return static_cast<int>(cudaSuccess);
  if (S <= 0 || B > 65535 || S > INT32_MAX / 2 || W > INT32_MAX / 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>((W + kThreads - 1) / kThreads),
                  static_cast<unsigned>(B));
  rglru_scan_kernel<T><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<T*>(h),
      static_cast<T*>(last), static_cast<int>(S), static_cast<int>(W));
  return static_cast<int>(cudaGetLastError());
}

// Loads steps t0, t0-1, ..., t0-kUnroll+1 of one channel for the backward: dh_t, a_{t+1} (1 at
// t = S-1, where it is not used) and h_{t-1} (0 at t = 0); steps below 0 get dh = 0, a = 1,
// h = 0, and are never stored.
__device__ __forceinline__ void load_steps_bwd(float* av, float* hv, float* dv,
                                               const float* __restrict__ a,
                                               const float* __restrict__ h,
                                               const float* __restrict__ dh, long long off,
                                               int t0, int S, int W) {
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int t = t0 - u;
    const long long i = off + static_cast<long long>(t) * W;
    dv[u] = t >= 0 ? dh[i] : 0.f;
    av[u] = t >= 0 && t + 1 < S ? a[i + W] : 1.f;
    hv[u] = t >= 1 ? h[i - W] : 0.f;
  }
}

__global__ void __launch_bounds__(kThreads)
rglru_scan_bwd_kernel(const float* __restrict__ a, const float* __restrict__ h,
                      const float* __restrict__ dh, const float* __restrict__ dlast,
                      float* __restrict__ da, float* __restrict__ db, int S, int W) {
  const int w = blockIdx.x * kThreads + threadIdx.x;
  if (w >= W) return;
  const long long bi = blockIdx.y;
  const long long off = bi * S * W + w;     // element (bi, 0, w)

  float av[kUnroll], hv[kUnroll], dv[kUnroll], an[kUnroll], hn[kUnroll], dn[kUnroll];
  load_steps_bwd(av, hv, dv, a, h, dh, off, S - 1, S, W);
  float g = 0.f;
  for (int t0 = S - 1; t0 >= 0; t0 -= kUnroll) {
    if (t0 - kUnroll >= 0) load_steps_bwd(an, hn, dn, a, h, dh, off, t0 - kUnroll, S, W);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = t0 - u;
      if (t == S - 1)
        g = dlast ? __fadd_rn(dv[u], dlast[bi * W + w]) : dv[u];
      else
        g = __fadd_rn(dv[u], __fmul_rn(av[u], g));
      if (t >= 0) {
        const long long i = off + static_cast<long long>(t) * W;
        db[i] = g;
        da[i] = __fmul_rn(g, hv[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      av[u] = an[u];
      hv[u] = hn[u];
      dv[u] = dn[u];
    }
  }
}

}  // namespace

// Plain C interface, loaded with ctypes.  a/b/h: (B,S,W); last: (B,W); one dtype for all four,
// contiguous (the wrapper checks).  S >= 1.  Returns a cudaError_t.
extern "C" {

int rglru_scan_f32(const void* a, const void* b, void* h, void* last, long long B, long long S,
                   long long W, void* stream) {
  return launch<float>(a, b, h, last, B, S, W, stream);
}

int rglru_scan_bf16(const void* a, const void* b, void* h, void* last, long long B, long long S,
                    long long W, void* stream) {
  return launch<__nv_bfloat16>(a, b, h, last, B, S, W, stream);
}

// a/h/dh/da/db: (B,S,W) f32, contiguous; dlast: (B,W) f32, or null for a zero gradient of the
// final state.  S >= 1.  Returns a cudaError_t.
int rglru_scan_bwd_f32(const void* a, const void* h, const void* dh, const void* dlast, void* da,
                       void* db, long long B, long long S, long long W, void* stream) {
  if (B <= 0 || W <= 0) return static_cast<int>(cudaSuccess);
  if (S <= 0 || B > 65535 || S > INT32_MAX / 2 || W > INT32_MAX / 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>((W + kThreads - 1) / kThreads),
                  static_cast<unsigned>(B));
  rglru_scan_bwd_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(h),
      static_cast<const float*>(dh), static_cast<const float*>(dlast), static_cast<float*>(da),
      static_cast<float*>(db), static_cast<int>(S), static_cast<int>(W));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
