// Causal or non-causal GQA attention backward, hand-written for Hopper (sm_90a).
//
// The gradient of the function that flash_attention.cu's forward computes: q (B,H,S,hd), k/v
// (B,KV,S,hd), head h reads kv head h / (H/KV), scores scaled by hd^-0.5 and masked with -1e30.
// The reference has no Pallas backward: it differentiates XLA's `full_causal_attention`
// (src/repro/models/attention.py:54) through `jax.value_and_grad` (src/repro/launch/train.py:63),
// whose gradient this kernel computes from the forward's saved output O and row log-sum-exp
// LSE (natural log of the scaled scores, written by the forward):
//
//   P = exp(S * scale - LSE)    D = rowsum(dO o O)    dV = P^T dO    dP = dO V^T
//   dS = P o (dP - D)           dQ = dS K * scale      dK = dS^T Q * scale
//
// dK and dV sum over the query heads of each kv head's group.  Masked entries (above the
// diagonal, or past S in a ragged last tile) get P = 0 exactly, so they add nothing.
//
// What bounds it: operations.  The backward does 2.5x the forward's FLOPs (halved when causal),
// hundreds of operations per byte at training lengths; this first design runs them on the CUDA
// cores in f32 (67 T/s), so it is several times slower than a tensor-core backward would be.
// Speed is later work (wgmma/TMA, ROADMAP queue B); this design is simple and deterministic:
//
// 1. `attn_bwd_dot`: D = rowsum(dO o O) in f32, one warp a row.
// 2. `attn_bwd_dkdv`: one 256-thread block per (key tile, kv head, batch).  K and V of the tile
//    stay in shared memory; the block walks the group's query heads and, for each, the query
//    tiles that can see the tile (from the diagonal on, when causal), recomputing S and dP for
//    the (key, query) tile pair, P and dS from them, and accumulating dK and dV in f32
//    registers.  Every dK/dV element is written by one thread once: no atomics, so GQA needs
//    no reduction pass and two calls give the same bits.
// 3. `attn_bwd_dq`: one block per (query tile, head, batch), walking the key tiles up to the
//    diagonal and accumulating dQ in f32 registers.
//
// Tiles are 64 keys x 64 queries (32 x 32 at hd 256, to stay within 227 KB of shared memory),
// f32 in shared memory with rows padded by one float; each thread holds a 4x4 (2x2) micro-tile
// of the scores and 4 (2) rows x hd/16 columns of its accumulators.  Inputs may be f32 or bf16
// (widened to f32 on load); outputs are written in the input dtype.  P is recomputed with
// expf, never --use_fast_math.  The kernels allocate nothing and never synchronise; they run
// on the caller's stream.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;    // 16 x 16: ty picks rows, tx picks columns

template <int HD>
struct Cfg {
  static constexpr int BT = HD == 256 ? 32 : 64;   // rows of a key tile and of a query tile
  static constexpr int R = BT / 16;                // micro-tile rows (and columns) a thread
  static constexpr int LD = HD + 1;                // f32 row stride of a tile
  static constexpr int LDP = BT + 1;               // f32 row stride of a P / dS tile
  // four (BT, hd) tiles, two (BT, BT) tiles, two rows of BT for LSE and D
  static constexpr size_t SMEM =
      sizeof(float) * (4 * static_cast<size_t>(BT) * LD + 2 * BT * LDP + 2 * BT);
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// BT rows of one head starting at row r0, widened to f32; rows at or past S are zero.
template <int HD, int BT, typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src, int r0, int S) {
  constexpr int LD = HD + 1;
  for (int idx = threadIdx.x; idx < BT * HD; idx += kThreads) {
    const int r = idx / HD, d = idx % HD;
    const int row = r0 + r;
    dst[r * LD + d] = row < S ? to_f(src[static_cast<long long>(row) * HD + d]) : 0.f;
  }
}

// BT entries of a (B*H, S) f32 row starting at r0; entries at or past S are zero.
template <int BT>
__device__ __forceinline__ void load_row(float* dst, const float* __restrict__ src, int r0,
                                         int S) {
  for (int r = threadIdx.x; r < BT; r += kThreads) dst[r] = r0 + r < S ? src[r0 + r] : 0.f;
}

// D = rowsum(dO o O), one warp a row of the (B*H*S, hd) matrices
template <typename T>
__global__ void __launch_bounds__(kThreads)
attn_bwd_dot(const T* __restrict__ o, const T* __restrict__ dout, float* __restrict__ dvec,
             long long rows, int hd) {
  const long long row = static_cast<long long>(blockIdx.x) * (kThreads / 32) + threadIdx.x / 32;
  if (row >= rows) return;
  const int lane = threadIdx.x & 31;
  const T* a = o + row * hd;
  const T* b = dout + row * hd;
  float acc = 0.f;
  for (int d = lane; d < hd; d += 32) acc = fmaf(to_f(a[d]), to_f(b[d]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) dvec[row] = acc;
}

// dK, dV for one (key tile, kv head, batch)
template <int HD, typename T>
__global__ void __launch_bounds__(kThreads)
attn_bwd_dkdv(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
              const T* __restrict__ dout, const float* __restrict__ lse,
              const float* __restrict__ dvec, T* __restrict__ dk, T* __restrict__ dv, int H,
              int KV, int S, int causal, float scale) {
  using C = Cfg<HD>;
  constexpr int BT = C::BT, R = C::R, LD = C::LD, LDP = C::LDP;
  constexpr int DPT = HD / 16;     // accumulator columns a thread
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + BT * LD;
  float* Qs = Vs + BT * LD;
  float* dOs = Qs + BT * LD;
  float* Ps = dOs + BT * LD;
  float* dSs = Ps + BT * LDP;
  float* Ls = dSs + BT * LDP;
  float* Ds = Ls + BT;

  const int kvh = blockIdx.y, b = blockIdx.z;
  const int k0 = blockIdx.x * BT;
  const int G = H / KV;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const long long head = static_cast<long long>(S) * HD;
  const long long kvoff = (static_cast<long long>(b) * KV + kvh) * head;

  load_tile<HD, BT>(Ks, k + kvoff, k0, S);
  load_tile<HD, BT>(Vs, v + kvoff, k0, S);

  float dk_acc[R][DPT], dv_acc[R][DPT];
#pragma unroll
  for (int a = 0; a < R; ++a)
#pragma unroll
    for (int e = 0; e < DPT; ++e) dk_acc[a][e] = dv_acc[a][e] = 0.f;

  const int n_qt = (S + BT - 1) / BT;
  const int qt0 = causal ? blockIdx.x : 0;   // query tiles before the diagonal see no key here
  for (int g = 0; g < G; ++g) {
    const int h = kvh * G + g;
    const long long qoff = (static_cast<long long>(b) * H + h) * head;
    const float* lrow = lse + (static_cast<long long>(b) * H + h) * S;
    const float* drow = dvec + (static_cast<long long>(b) * H + h) * S;
    for (int qt = qt0; qt < n_qt; ++qt) {
      const int q0 = qt * BT;
      __syncthreads();                     // the previous tile's readers are done
      load_tile<HD, BT>(Qs, q + qoff, q0, S);
      load_tile<HD, BT>(dOs, dout + qoff, q0, S);
      load_row<BT>(Ls, lrow, q0, S);
      load_row<BT>(Ds, drow, q0, S);
      __syncthreads();

      // S^T and dP^T for keys j = ty + 16a, queries i = tx + 16c
      float s[R][R], dp[R][R];
#pragma unroll
      for (int a = 0; a < R; ++a)
#pragma unroll
        for (int c = 0; c < R; ++c) s[a][c] = dp[a][c] = 0.f;
#pragma unroll 4
      for (int d = 0; d < HD; ++d) {
        float kv_[R], vv[R], qv[R], dov[R];
#pragma unroll
        for (int a = 0; a < R; ++a) {
          kv_[a] = Ks[(ty + 16 * a) * LD + d];
          vv[a] = Vs[(ty + 16 * a) * LD + d];
        }
#pragma unroll
        for (int c = 0; c < R; ++c) {
          qv[c] = Qs[(tx + 16 * c) * LD + d];
          dov[c] = dOs[(tx + 16 * c) * LD + d];
        }
#pragma unroll
        for (int a = 0; a < R; ++a)
#pragma unroll
          for (int c = 0; c < R; ++c) {
            s[a][c] = fmaf(kv_[a], qv[c], s[a][c]);
            dp[a][c] = fmaf(vv[a], dov[c], dp[a][c]);
          }
      }
#pragma unroll
      for (int a = 0; a < R; ++a) {
        const int kj = k0 + ty + 16 * a;
#pragma unroll
        for (int c = 0; c < R; ++c) {
          const int il = tx + 16 * c, qi = q0 + il;
          const bool ok = kj < S && qi < S && (!causal || kj <= qi);
          const float p = ok ? expf(s[a][c] * scale - Ls[il]) : 0.f;
          Ps[(ty + 16 * a) * LDP + il] = p;
          dSs[(ty + 16 * a) * LDP + il] = p * (dp[a][c] - Ds[il]);
        }
      }
      __syncthreads();                     // P and dS are complete

      // dV += P dO, dK += dS Q for keys j = ty + 16a, columns tx + 16e
#pragma unroll 4
      for (int i = 0; i < BT; ++i) {
        float pv[R], dsv[R];
#pragma unroll
        for (int a = 0; a < R; ++a) {
          pv[a] = Ps[(ty + 16 * a) * LDP + i];
          dsv[a] = dSs[(ty + 16 * a) * LDP + i];
        }
#pragma unroll
        for (int e = 0; e < DPT; ++e) {
          const float dov = dOs[i * LD + tx + 16 * e];
          const float qv = Qs[i * LD + tx + 16 * e];
#pragma unroll
          for (int a = 0; a < R; ++a) {
            dv_acc[a][e] = fmaf(pv[a], dov, dv_acc[a][e]);
            dk_acc[a][e] = fmaf(dsv[a], qv, dk_acc[a][e]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int a = 0; a < R; ++a) {
    const int kj = k0 + ty + 16 * a;
    if (kj >= S) continue;
#pragma unroll
    for (int e = 0; e < DPT; ++e) {
      const long long at = kvoff + static_cast<long long>(kj) * HD + tx + 16 * e;
      dk[at] = from_f<T>(dk_acc[a][e] * scale);
      dv[at] = from_f<T>(dv_acc[a][e]);
    }
  }
}

// dQ for one (query tile, head, batch)
template <int HD, typename T>
__global__ void __launch_bounds__(kThreads)
attn_bwd_dq(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
            const T* __restrict__ dout, const float* __restrict__ lse,
            const float* __restrict__ dvec, T* __restrict__ dq, int H, int KV, int S,
            int causal, float scale) {
  using C = Cfg<HD>;
  constexpr int BT = C::BT, R = C::R, LD = C::LD, LDP = C::LDP;
  constexpr int DPT = HD / 16;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + BT * LD;
  float* Ks = dOs + BT * LD;
  float* Vs = Ks + BT * LD;
  float* dSs = Vs + BT * LD;
  float* Ls = dSs + 2 * BT * LDP;    // the second (BT, BT) region stays unused here
  float* Ds = Ls + BT;

  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = blockIdx.x * BT;
  const int kvh = h / (H / KV);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const long long head = static_cast<long long>(S) * HD;
  const long long qoff = (static_cast<long long>(b) * H + h) * head;
  const long long kvoff = (static_cast<long long>(b) * KV + kvh) * head;

  load_tile<HD, BT>(Qs, q + qoff, q0, S);
  load_tile<HD, BT>(dOs, dout + qoff, q0, S);
  load_row<BT>(Ls, lse + (static_cast<long long>(b) * H + h) * S, q0, S);
  load_row<BT>(Ds, dvec + (static_cast<long long>(b) * H + h) * S, q0, S);

  float dq_acc[R][DPT];
#pragma unroll
  for (int a = 0; a < R; ++a)
#pragma unroll
    for (int e = 0; e < DPT; ++e) dq_acc[a][e] = 0.f;

  // keys [0, kv_end): under the causal mask nothing past the tile's last valid row
  const int q_last = min(q0 + BT, S) - 1;
  const int kv_end = causal ? q_last + 1 : S;
  const int n_kt = (kv_end + BT - 1) / BT;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BT;
    __syncthreads();                       // the previous tile's readers are done
    load_tile<HD, BT>(Ks, k + kvoff, k0, S);
    load_tile<HD, BT>(Vs, v + kvoff, k0, S);
    __syncthreads();

    // S and dP for queries i = ty + 16a, keys j = tx + 16c
    float s[R][R], dp[R][R];
#pragma unroll
    for (int a = 0; a < R; ++a)
#pragma unroll
      for (int c = 0; c < R; ++c) s[a][c] = dp[a][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float qv[R], dov[R], kv_[R], vv[R];
#pragma unroll
      for (int a = 0; a < R; ++a) {
        qv[a] = Qs[(ty + 16 * a) * LD + d];
        dov[a] = dOs[(ty + 16 * a) * LD + d];
      }
#pragma unroll
      for (int c = 0; c < R; ++c) {
        kv_[c] = Ks[(tx + 16 * c) * LD + d];
        vv[c] = Vs[(tx + 16 * c) * LD + d];
      }
#pragma unroll
      for (int a = 0; a < R; ++a)
#pragma unroll
        for (int c = 0; c < R; ++c) {
          s[a][c] = fmaf(qv[a], kv_[c], s[a][c]);
          dp[a][c] = fmaf(dov[a], vv[c], dp[a][c]);
        }
    }
#pragma unroll
    for (int a = 0; a < R; ++a) {
      const int il = ty + 16 * a, qi = q0 + il;
#pragma unroll
      for (int c = 0; c < R; ++c) {
        const int kj = k0 + tx + 16 * c;
        const bool ok = kj < S && qi < S && (!causal || kj <= qi);
        const float p = ok ? expf(s[a][c] * scale - Ls[il]) : 0.f;
        dSs[il * LDP + tx + 16 * c] = p * (dp[a][c] - Ds[il]);
      }
    }
    __syncthreads();                       // dS is complete

    // dQ += dS K for queries i = ty + 16a, columns tx + 16e
#pragma unroll 4
    for (int j = 0; j < BT; ++j) {
      float dsv[R];
#pragma unroll
      for (int a = 0; a < R; ++a) dsv[a] = dSs[(ty + 16 * a) * LDP + j];
#pragma unroll
      for (int e = 0; e < DPT; ++e) {
        const float kv_ = Ks[j * LD + tx + 16 * e];
#pragma unroll
        for (int a = 0; a < R; ++a) dq_acc[a][e] = fmaf(dsv[a], kv_, dq_acc[a][e]);
      }
    }
  }

#pragma unroll
  for (int a = 0; a < R; ++a) {
    const int qi = q0 + ty + 16 * a;
    if (qi >= S) continue;
#pragma unroll
    for (int e = 0; e < DPT; ++e)
      dq[qoff + static_cast<long long>(qi) * HD + tx + 16 * e] = from_f<T>(dq_acc[a][e] * scale);
  }
}

template <int HD, typename T>
int launch(const void* q, const void* k, const void* v, const void* o, const void* lse,
           const void* dout, void* dq, void* dk, void* dv, void* dvec, long long B, long long H,
           long long KV, long long S, int causal, cudaStream_t stream) {
  using C = Cfg<HD>;
  if (H > 65535 || B > 65535) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(attn_bwd_dkdv<HD, T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(C::SMEM));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(attn_bwd_dq<HD, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(C::SMEM));
  if (err != cudaSuccess) return static_cast<int>(err);
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(HD)));  // f32(hd**-0.5)
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  const T* dop = static_cast<const T*>(dout);
  const float* lp = static_cast<const float*>(lse);
  float* dp = static_cast<float*>(dvec);

  const long long rows = B * H * S;
  const long long dot_blocks = (rows + kThreads / 32 - 1) / (kThreads / 32);
  if (dot_blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  attn_bwd_dot<T><<<static_cast<unsigned>(dot_blocks), kThreads, 0, stream>>>(
      static_cast<const T*>(o), dop, dp, rows, HD);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const unsigned n_t = static_cast<unsigned>((S + C::BT - 1) / C::BT);
  attn_bwd_dkdv<HD, T><<<dim3(n_t, static_cast<unsigned>(KV), static_cast<unsigned>(B)),
                         kThreads, C::SMEM, stream>>>(
      qp, kp, vp, dop, lp, dp, static_cast<T*>(dk), static_cast<T*>(dv), static_cast<int>(H),
      static_cast<int>(KV), static_cast<int>(S), causal, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  attn_bwd_dq<HD, T><<<dim3(n_t, static_cast<unsigned>(H), static_cast<unsigned>(B)), kThreads,
                       C::SMEM, stream>>>(qp, kp, vp, dop, lp, dp, static_cast<T*>(dq),
                                          static_cast<int>(H), static_cast<int>(KV),
                                          static_cast<int>(S), causal, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const void* o, const void* lse,
             const void* dout, void* dq, void* dk, void* dv, void* dvec, long long B, long long H,
             long long KV, long long S, long long hd, int causal, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0) return static_cast<int>(cudaSuccess);
  if (KV <= 0 || H % KV != 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16: return launch<16, T>(q, k, v, o, lse, dout, dq, dk, dv, dvec, B, H, KV, S, causal, st);
    case 32: return launch<32, T>(q, k, v, o, lse, dout, dq, dk, dv, dvec, B, H, KV, S, causal, st);
    case 64: return launch<64, T>(q, k, v, o, lse, dout, dq, dk, dv, dvec, B, H, KV, S, causal, st);
    case 128:
      return launch<128, T>(q, k, v, o, lse, dout, dq, dk, dv, dvec, B, H, KV, S, causal, st);
    case 160:
      return launch<160, T>(q, k, v, o, lse, dout, dq, dk, dv, dvec, B, H, KV, S, causal, st);
    case 256:
      return launch<256, T>(q, k, v, o, lse, dout, dq, dk, dv, dvec, B, H, KV, S, causal, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Plain C interface, loaded with ctypes.  q/o/dout/dq: (B,H,S,hd); k/v/dk/dv: (B,KV,S,hd); one
// dtype for all ten, contiguous (the wrapper checks); lse: the forward's f32 (B,H,S) row
// log-sum-exp; dvec: f32 (B,H,S) scratch for D.  hd in {16, 32, 64, 128, 160, 256}.  Returns a
// cudaError_t.
extern "C" {

int flash_attention_bwd_f32(const void* q, const void* k, const void* v, const void* o,
                            const void* lse, const void* dout, void* dq, void* dk, void* dv,
                            void* dvec, long long B, long long H, long long KV, long long S,
                            long long hd, int causal, void* stream) {
  return dispatch<float>(q, k, v, o, lse, dout, dq, dk, dv, dvec, B, H, KV, S, hd, causal,
                         stream);
}

int flash_attention_bwd_bf16(const void* q, const void* k, const void* v, const void* o,
                             const void* lse, const void* dout, void* dq, void* dk, void* dv,
                             void* dvec, long long B, long long H, long long KV, long long S,
                             long long hd, int causal, void* stream) {
  return dispatch<__nv_bfloat16>(q, k, v, o, lse, dout, dq, dk, dv, dvec, B, H, KV, S, hd,
                                 causal, stream);
}

}  // extern "C"
