// Mamba-2 SSD chunk scan (state-space duality), hand-written for Hopper (sm_90a).
//
// Replaces the Pallas kernel `ssd_scan_kernel` (src/repro/kernels/ssd_scan/kernel.py:71, body
// `_ssd_kernel` :26); its inputs are pre-arranged as ssd_scan/ops.py arranges them:
//   xdt (B,H,nc,Q,P) = x*dt, Bm/Cm (B,nc,Q,N) (one group, shared by the heads),
//   cums (B,H,nc,Q) f32 = within-chunk cumsum of dt*A.
// Chunks run in order with an f32 (P,N) state S, from zero.  With L_ij = exp(cums_i - cums_j)
// for i >= j (0 above the diagonal):
//   y     = (C B^T o L) xdt + exp(cums) * (C S^T)          (Q,P), stored in xdt's dtype
//   S    <- exp(cums_last) S + xdt^T (B * exp(cums_last - cums))
// and the final S is stored in f32 (B,H,P,N).  All arithmetic is f32, as `_ssd_kernel` casts.
//
// What bounds it: operations.  Per (b, h, chunk) it does about Q^2 (N+P) + 4 Q N P
// multiply-adds on 2 Q (N+P) inputs, hundreds of operations per byte at mamba2's Q=256,
// N=128, P=64.
//
// What the design does about it (simple and right first; tensor-core tiles come later): one
// 256-thread block per (b, h) walks the chunks in sequence, since blocks run in no order and
// nothing carries between them; the state S lives in shared memory for the whole walk (32 KiB
// at P=64, N=128).  The (Q,Q) matrix C B^T o L does not fit (256 KiB at Q=256, more than a
// block may hold), so it is formed 64x64 tile by tile: for each 64-row tile of C, the tiles of
// B and xdt on or below the diagonal are loaded in turn, their 64x64 product is masked and
// decayed into shared memory and multiplied into the tile's y accumulator, which stays in
// registers (each thread owns rows ty+16a and columns tx+16b).  The state update runs after
// all of the chunk's y tiles, each thread owning entries of S.  Rows are padded by one float
// so the column walks hit distinct banks.  Shared memory: (P + 2*64)(N+1) + 2*64*65 + Q floats
// (130 KiB at mamba2's shapes, above the 48 KiB default, so the launch raises the limit).
//
// The kernel allocates nothing and never synchronises; it runs on the caller's stream.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;    // 16 x 16: ty picks rows, tx picks columns
constexpr int kT = 64;           // rows per tile of C, B and xdt
constexpr int kLdG = kT + 1;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

size_t smem_bytes(int P, int N, int Q) {
  return sizeof(float) * (static_cast<size_t>(P + 2 * kT) * (N + 1) +
                          static_cast<size_t>(kT) * (P + 1) + kT * kLdG + Q);
}

// rows [r0, r0+64) of a (Q, W) row-major chunk, as f32 with row stride ld, row r0+r scaled by
// `scale[r]` when given; rows at or past Q are zero.
template <typename T>
__device__ __forceinline__ void load_rows(float* dst, int ld, const T* __restrict__ src, int r0,
                                          int Q, int W, const float* scale) {
  for (int idx = threadIdx.x; idx < kT * W; idx += kThreads) {
    const int r = idx / W, c = idx % W;
    const int row = r0 + r;
    float val = 0.f;
    if (row < Q) {
      val = to_f32(src[static_cast<long long>(row) * W + c]);
      if (scale) val *= scale[r];
    }
    dst[r * ld + c] = val;
  }
}

template <typename T, int P>
__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const T* __restrict__ xdt, const T* __restrict__ Bm, const T* __restrict__ Cm,
                const float* __restrict__ cums, T* __restrict__ y, float* __restrict__ state,
                int H, int nc, int Q, int N) {
  constexpr int LDX = P + 1;
  constexpr int PPT = P / 16;      // y columns per thread
  const int LDN = N + 1;
  extern __shared__ float smem[];
  float* Ss = smem;                // (P, N) state
  float* Cs = Ss + P * LDN;        // (64, N) rows of C
  float* Bs = Cs + kT * LDN;       // (64, N) rows of B (decayed in the state update)
  float* Xs = Bs + kT * LDN;       // (64, P) rows of xdt
  float* Gs = Xs + kT * LDX;       // (64, 64) tile of C B^T o L
  float* cs = Gs + kT * kLdG;      // (Q,) cums of the chunk
  float* dec = Gs;                 // (64,) exp(last - cums) in the state update (Gs is free)

  const int h = blockIdx.x, b = blockIdx.y;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int PN = P * N;
  const int n_tiles = (Q + kT - 1) / kT;

  for (int idx = threadIdx.x; idx < PN; idx += kThreads) Ss[(idx / N) * LDN + idx % N] = 0.f;

  for (int c = 0; c < nc; ++c) {
    const long long bhc = (static_cast<long long>(b) * H + h) * nc + c;
    const long long bc = static_cast<long long>(b) * nc + c;
    const T* xc = xdt + bhc * Q * P;
    const T* Bc = Bm + bc * Q * N;
    const T* Cc = Cm + bc * Q * N;
    T* yc = y + bhc * Q * P;

    __syncthreads();                       // the previous chunk's state update is done
    for (int i = threadIdx.x; i < Q; i += kThreads) cs[i] = cums[bhc * Q + i];

    for (int it = 0; it < n_tiles; ++it) {
      const int i0 = it * kT;
      __syncthreads();                     // readers of Cs (and cs writes) are done
      load_rows(Cs, LDN, Cc, i0, Q, N, static_cast<const float*>(nullptr));
      __syncthreads();

      // inter-chunk term: exp(cums_i) * (C_i . S_p)
      float acc[4][PPT];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int p = 0; p < PPT; ++p) acc[a][p] = 0.f;
#pragma unroll 4
      for (int n = 0; n < N; ++n) {
        float cv[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) cv[a] = Cs[(ty + 16 * a) * LDN + n];
#pragma unroll
        for (int p = 0; p < PPT; ++p) {
          const float sv = Ss[(tx + 16 * p) * LDN + n];
#pragma unroll
          for (int a = 0; a < 4; ++a) acc[a][p] = fmaf(cv[a], sv, acc[a][p]);
        }
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int gi = i0 + ty + 16 * a;
        const float e = gi < Q ? expf(cs[gi]) : 0.f;
#pragma unroll
        for (int p = 0; p < PPT; ++p) acc[a][p] *= e;
      }

      // intra-chunk term over the tiles of j on or below the diagonal
      for (int jt = 0; jt <= it; ++jt) {
        const int j0 = jt * kT;
        __syncthreads();                   // readers of Bs, Xs and Gs are done
        load_rows(Bs, LDN, Bc, j0, Q, N, static_cast<const float*>(nullptr));
        load_rows(Xs, LDX, xc, j0, Q, P, static_cast<const float*>(nullptr));
        __syncthreads();

        float g[4][4];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int e = 0; e < 4; ++e) g[a][e] = 0.f;
#pragma unroll 4
        for (int n = 0; n < N; ++n) {
          float cv[4], bv[4];
#pragma unroll
          for (int a = 0; a < 4; ++a) cv[a] = Cs[(ty + 16 * a) * LDN + n];
#pragma unroll
          for (int e = 0; e < 4; ++e) bv[e] = Bs[(tx + 16 * e) * LDN + n];
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int e = 0; e < 4; ++e) g[a][e] = fmaf(cv[a], bv[e], g[a][e]);
        }
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const int gi = i0 + ty + 16 * a;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int gj = j0 + tx + 16 * e;
            const float val = (gi < Q && gj <= gi) ? g[a][e] * expf(cs[gi] - cs[gj]) : 0.f;
            Gs[(ty + 16 * a) * kLdG + tx + 16 * e] = val;
          }
        }
        __syncthreads();                   // G is complete

#pragma unroll 4
        for (int j = 0; j < kT; ++j) {
          float gv[4];
#pragma unroll
          for (int a = 0; a < 4; ++a) gv[a] = Gs[(ty + 16 * a) * kLdG + j];
#pragma unroll
          for (int p = 0; p < PPT; ++p) {
            const float xv = Xs[j * LDX + tx + 16 * p];
#pragma unroll
            for (int a = 0; a < 4; ++a) acc[a][p] = fmaf(gv[a], xv, acc[a][p]);
          }
        }
      }

#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int gi = i0 + ty + 16 * a;
        if (gi >= Q) continue;
#pragma unroll
        for (int p = 0; p < PPT; ++p)
          store(yc + static_cast<long long>(gi) * P + tx + 16 * p, acc[a][p]);
      }
    }

    // state update: S <- exp(last) S + xdt^T (B * exp(last - cums))
    const float last = cs[Q - 1];
    __syncthreads();                       // every read of the old S is done
    const float el = expf(last);
    for (int idx = threadIdx.x; idx < PN; idx += kThreads) Ss[(idx / N) * LDN + idx % N] *= el;
    for (int jt = 0; jt < n_tiles; ++jt) {
      const int j0 = jt * kT;
      const int rows = min(kT, Q - j0);
      __syncthreads();                     // readers of Bs, Xs and dec are done
      for (int j = threadIdx.x; j < kT; j += kThreads)
        dec[j] = j < rows ? expf(last - cs[j0 + j]) : 0.f;
      load_rows(Xs, LDX, xc, j0, Q, P, static_cast<const float*>(nullptr));
      __syncthreads();
      load_rows(Bs, LDN, Bc, j0, Q, N, dec);
      __syncthreads();
      for (int idx = threadIdx.x; idx < PN; idx += kThreads) {
        const int p = idx / N, n = idx % N;
        float s = Ss[p * LDN + n];
        for (int j = 0; j < rows; ++j) s = fmaf(Xs[j * LDX + p], Bs[j * LDN + n], s);
        Ss[p * LDN + n] = s;
      }
    }
  }

  __syncthreads();
  float* st = state + (static_cast<long long>(b) * H + h) * PN;
  for (int idx = threadIdx.x; idx < PN; idx += kThreads) st[idx] = Ss[(idx / N) * LDN + idx % N];
}

template <typename T, int P>
int launch_p(const void* xdt, const void* Bm, const void* Cm, const void* cums, void* y,
             void* state, long long B, long long H, long long nc, long long Q, long long N,
             cudaStream_t stream) {
  const size_t smem = smem_bytes(static_cast<int>(P), static_cast<int>(N), static_cast<int>(Q));
  // the only check of this limit (227 KiB, a block's opt-in maximum on H100): the wrapper
  // reports cudaErrorInvalidValue as sizes the kernel does not take
  if (smem > 232448) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(ssd_scan_kernel<T, P>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(H), static_cast<unsigned>(B));
  ssd_scan_kernel<T, P><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(xdt), static_cast<const T*>(Bm), static_cast<const T*>(Cm),
      static_cast<const float*>(cums), static_cast<T*>(y), static_cast<float*>(state),
      static_cast<int>(H), static_cast<int>(nc), static_cast<int>(Q), static_cast<int>(N));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* xdt, const void* Bm, const void* Cm, const void* cums, void* y,
           void* state, long long B, long long H, long long nc, long long Q, long long P,
           long long N, void* stream) {
  if (B <= 0 || H <= 0) return static_cast<int>(cudaSuccess);
  if (nc <= 0 || Q <= 0 || N <= 0 || B > 65535) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (P) {
    case 16: return launch_p<T, 16>(xdt, Bm, Cm, cums, y, state, B, H, nc, Q, N, st);
    case 32: return launch_p<T, 32>(xdt, Bm, Cm, cums, y, state, B, H, nc, Q, N, st);
    case 64: return launch_p<T, 64>(xdt, Bm, Cm, cums, y, state, B, H, nc, Q, N, st);
    case 128: return launch_p<T, 128>(xdt, Bm, Cm, cums, y, state, B, H, nc, Q, N, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Plain C interface, loaded with ctypes.  xdt/y: (B,H,nc,Q,P); Bm/Cm: (B,nc,Q,N), in one dtype;
// cums: (B,H,nc,Q) f32; state: (B,H,P,N) f32; all contiguous (the wrapper checks).
// P in {16, 32, 64, 128}.  Returns a cudaError_t.
extern "C" {

int ssd_scan_f32(const void* xdt, const void* Bm, const void* Cm, const void* cums, void* y,
                 void* state, long long B, long long H, long long nc, long long Q, long long P,
                 long long N, void* stream) {
  return launch<float>(xdt, Bm, Cm, cums, y, state, B, H, nc, Q, P, N, stream);
}

int ssd_scan_bf16(const void* xdt, const void* Bm, const void* Cm, const void* cums, void* y,
                  void* state, long long B, long long H, long long nc, long long Q, long long P,
                  long long N, void* stream) {
  return launch<__nv_bfloat16>(xdt, Bm, Cm, cums, y, state, B, H, nc, Q, P, N, stream);
}

}  // extern "C"
