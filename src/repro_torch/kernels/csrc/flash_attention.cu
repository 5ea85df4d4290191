// Causal or non-causal GQA attention forward with an online softmax, hand-written for Hopper
// (sm_90a).
//
// Replaces the Pallas kernel `flash_attention_kernel` (src/repro/kernels/flash_attention/
// kernel.py:62, body `_flash_kernel` :21).  q (B,H,S,hd), k/v (B,KV,S,hd), all contiguous in
// that layout; head h reads kv head h / (H/KV).  Scores are computed in f32 from f32 or bf16
// inputs (as `_flash_kernel` casts its tiles to f32), scaled by hd^-0.5, masked with -1e30
// (never -inf); the running max m, sum l and the output accumulator stay in f32, and the
// output is acc / max(l, 1e-30) in q's dtype.  Under the causal mask the kv tiles entirely
// above the diagonal are skipped, as the Pallas kernel's `pl.when` skips them.  Unlike the
// Pallas kernel (which asserts S % block == 0), any S >= 1 is taken: the ragged last q and kv
// tiles are masked.
//
// What bounds it: operations.  Causal attention does about 2*B*H*S^2*hd multiply-adds'
// worth of FLOPs over 4*B*H*S*hd elements of input and output, hundreds of operations per
// byte at S in the thousands, far above the card's balance point.
//
// What the design does about it (simple and right first; mma.sync / wgmma and TMA come in a
// later change): one 256-thread block per (64-row q tile, head, batch); the Q tile and each
// 64-row K and V tile are converted to f32 in shared memory, rows padded by one float so the
// column walks hit 32 distinct banks.  Each thread owns a 4x4 micro-tile of the 64x64 score
// tile (rows ty+16i, columns tx+16j) and 4 x hd/16 entries of the output accumulator, so every
// shared-memory load feeds several FMAs.  At hd 256 (recurrentgemma's MQA heads) the tiles take
// (64 + 2*64)*257 + 64*65 floats, 214,016 bytes, under the 232,448 a block may hold, and the
// accumulator is 64 floats a thread.  The 16 threads that share a row are one half-warp:
// row max and row sum are __shfl_xor_sync trees inside it.  P goes through shared memory to
// the P*V product.  All arithmetic is f32 on the CUDA cores, so the kernel sits far below the
// tensor-core bound that PERF.md states for it.
//
// The kernel allocates nothing and never synchronises; it runs on the caller's stream.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;          // q rows per block
constexpr int kBK = 64;          // kv rows per tile
constexpr int kThreads = 256;    // 16 x 16: ty picks rows, tx picks columns
constexpr float kNeg = -1e30f;   // the reference's mask value

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) * (static_cast<size_t>(kBQ + 2 * kBK) * (HD + 1) + kBQ * (kBK + 1));
}

// 64 rows of one head starting at row r0, converted to f32; rows at or past S are zero.
template <typename T, int HD>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src, int r0, int S) {
  constexpr int LD = HD + 1;
  for (int idx = threadIdx.x; idx < kBQ * HD; idx += kThreads) {
    const int r = idx / HD, d = idx % HD;
    const int row = r0 + r;
    dst[r * LD + d] = row < S ? to_f32(src[static_cast<long long>(row) * HD + d]) : 0.f;
  }
}

__device__ __forceinline__ float half_warp_max(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, int H, int KV, int S, int causal, float scale) {
  constexpr int LD = HD + 1;
  constexpr int LDP = kBK + 1;
  constexpr int DPT = HD / 16;     // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + kBQ * LD;
  float* Vs = Ks + kBK * LD;
  float* Ps = Vs + kBK * LD;

  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = blockIdx.x * kBQ;
  const int kvh = h / (H / KV);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const long long head = static_cast<long long>(S) * HD;
  const T* qb = q + (static_cast<long long>(b) * H + h) * head;
  const T* kb = k + (static_cast<long long>(b) * KV + kvh) * head;
  const T* vb = v + (static_cast<long long>(b) * KV + kvh) * head;
  T* ob = o + (static_cast<long long>(b) * H + h) * head;

  load_tile<T, HD>(Qs, qb, q0, S);

  float m[4], l[4], acc[4][DPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNeg;
    l[i] = 0.f;
#pragma unroll
    for (int d = 0; d < DPT; ++d) acc[i][d] = 0.f;
  }

  // keys [0, kv_end): under the causal mask nothing past the tile's last valid row
  const int q_last = min(q0 + kBQ, S) - 1;
  const int kv_end = causal ? q_last + 1 : S;
  const int n_tiles = (kv_end + kBK - 1) / kBK;

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();                       // the previous tile's readers are done
    load_tile<T, HD>(Ks, kb, k0, S);
    load_tile<T, HD>(Vs, vb, k0, S);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty + 16 * i) * LD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + ty + 16 * i;
      float mx = kNeg;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = k0 + tx + 16 * j;
        const bool ok = kj < S && (!causal || kj <= qi);
        s[i][j] = ok ? s[i][j] * scale : kNeg;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], half_warp_max(mx));
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        Ps[(ty + 16 * i) * LDP + tx + 16 * j] = p;
        rs += p;
      }
      l[i] = l[i] * alpha + half_warp_sum(rs);
      m[i] = m_new;
#pragma unroll
      for (int d = 0; d < DPT; ++d) acc[i][d] *= alpha;
    }
    __syncthreads();                       // P is complete

#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty + 16 * i) * LDP + c];
#pragma unroll
      for (int d = 0; d < DPT; ++d) {
        const float vv = Vs[c * LD + tx + 16 * d];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][d] = fmaf(pv[i], vv, acc[i][d]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi >= S) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int d = 0; d < DPT; ++d)
      store(ob + static_cast<long long>(qi) * HD + tx + 16 * d, acc[i][d] / denom);
  }
}

template <typename T, int HD>
int launch_hd(const void* q, const void* k, const void* v, void* o, long long B, long long H,
              long long KV, long long S, int causal, cudaStream_t stream) {
  const size_t smem = smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<T, HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>((S + kBQ - 1) / kBQ), static_cast<unsigned>(H),
                  static_cast<unsigned>(B));
  flash_fwd_kernel<T, HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), static_cast<int>(H), static_cast<int>(KV), static_cast<int>(S),
      causal, static_cast<float>(1.0 / sqrt(static_cast<double>(HD))));  // f32(hd**-0.5)
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, long long B, long long H,
           long long KV, long long S, long long hd, int causal, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0) return static_cast<int>(cudaSuccess);
  if (KV <= 0 || H % KV != 0 || H > 65535 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16: return launch_hd<T, 16>(q, k, v, o, B, H, KV, S, causal, st);
    case 32: return launch_hd<T, 32>(q, k, v, o, B, H, KV, S, causal, st);
    case 64: return launch_hd<T, 64>(q, k, v, o, B, H, KV, S, causal, st);
    case 128: return launch_hd<T, 128>(q, k, v, o, B, H, KV, S, causal, st);
    case 256: return launch_hd<T, 256>(q, k, v, o, B, H, KV, S, causal, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Plain C interface, loaded with ctypes.  q/o: (B,H,S,hd); k/v: (B,KV,S,hd); one dtype for all
// four, contiguous (the wrapper checks).  hd in {16, 32, 64, 128, 256}.  Returns a cudaError_t.
extern "C" {

int flash_attention_f32(const void* q, const void* k, const void* v, void* o, long long B,
                        long long H, long long KV, long long S, long long hd, int causal,
                        void* stream) {
  return launch<float>(q, k, v, o, B, H, KV, S, hd, causal, stream);
}

int flash_attention_bf16(const void* q, const void* k, const void* v, void* o, long long B,
                         long long H, long long KV, long long S, long long hd, int causal,
                         void* stream) {
  return launch<__nv_bfloat16>(q, k, v, o, B, H, KV, S, hd, causal, stream);
}

}  // extern "C"
