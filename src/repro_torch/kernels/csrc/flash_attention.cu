// Causal or non-causal GQA attention forward with an online softmax, hand-written for Hopper
// (sm_90a).
//
// Replaces the Pallas kernel `flash_attention_kernel` (src/repro/kernels/flash_attention/
// kernel.py:62, body `_flash_kernel` :21).  q (B,H,S,hd), k/v (B,KV,S,hd), all contiguous in
// that layout; head h reads kv head h / (H/KV).  Scores are scaled by hd^-0.5 and masked with
// -1e30 (never -inf); the running max m, sum l and the output accumulator stay in f32, and the
// output is acc / max(l, 1e-30) in q's dtype.  Under the causal mask the kv tiles entirely
// above the diagonal are skipped, as the Pallas kernel's `pl.when` skips them.  Unlike the
// Pallas kernel (which asserts S % block == 0), any S >= 1 is taken: the ragged last q and kv
// tiles are masked.
//
// What bounds it: operations.  Causal attention does 4*B*H*(S(S+1)/2)*hd FLOPs over
// 4*B*H*S*hd elements of input and output, hundreds of operations per byte at S in the
// thousands, far above the card's balance point: the bf16 tensor cores (989 TFLOP/s) set the
// bound.
//
// Two routes:
//
// bf16 (`flash_attention_bf16`, the serving path): FlashAttention-2 on the tensor cores.  One
// 128-thread block per (64-row q tile, head, batch); each warp owns 16 q rows.  Both products
// are mma.sync m16n8k16 on bf16 fragments with f32 accumulation.  K and V tiles stay bf16 in
// shared memory, rows padded by 16 bytes so every ldmatrix phase hits 8 distinct 16-byte bank
// groups (ldmatrix for K in Q.K^T, ldmatrix.trans for V in P.V), and arrive by cp.async in two
// stages: tile j+1 is in flight while tile j is used.  At hd <= 128 the Q tile is read once into
// A fragments held in registers (its shared memory is then the second stage); at hd 256
// (recurrentgemma's MQA heads) the 16x256 f32 output accumulator alone takes 128 registers a
// thread, so Q stays in shared memory and is re-read by ldmatrix, and kv tiles are 32 rows, so
// that ptxas spills nothing.  The online softmax runs in registers in the exp2 domain (log2(e)
// folded into the scale): the row max is a shuffle over the four lanes that share a row, P is
// rounded to bf16 straight from the score accumulator into the A fragments of P.V (no shared
// memory round trip), and l is summed from the same rounded P, so the output stays a convex
// combination of V's rows.  Only the diagonal tiles and the ragged last tile are masked; a warp
// skips a kv tile that lies wholly above its rows.  The grid runs the heaviest q tiles first and
// keeps the q heads of one kv head adjacent, so the causal triangle balances over the 132 SMs
// and K/V tiles are reused from L2.  Against the Pallas kernel, which multiplies an f32 P by V,
// the rounding of P to bf16 is the one new source of error (held on the CPU by
// tests/test_torch_flash_attention.py's emulation of it).
//
// f32 (`flash_attention_f32`, the path that matches the reference closely, as the f32 serving
// agreement runs it): CUDA cores.  One 256-thread block per (64-row q tile, head, batch); Q, K
// and V tiles in f32 shared memory (rows padded by one float), each thread a 4x4 micro-tile of
// the scores and 4 x hd/16 output entries, fmaf products, P through shared memory.
//
// The kernels allocate nothing and never synchronise; they run on the caller's stream.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tc_sm90.cuh"

namespace {

constexpr float kNeg = -1e30f;   // the reference's mask value
constexpr float kLog2e = 1.4426950408889634f;

// ------------------------------------------------------------------------------------------
// f32 route: CUDA cores
// ------------------------------------------------------------------------------------------

constexpr int kBQ = 64;          // q rows per block
constexpr int kBK = 64;          // kv rows per tile
constexpr int kThreads = 256;    // 16 x 16: ty picks rows, tx picks columns

template <int HD>
constexpr size_t smem_bytes_f32() {
  return sizeof(float) * (static_cast<size_t>(kBQ + 2 * kBK) * (HD + 1) + kBQ * (kBK + 1));
}

// 64 rows of one head starting at row r0; rows at or past S are zero.
template <int HD>
__device__ __forceinline__ void load_tile(float* dst, const float* __restrict__ src, int r0,
                                          int S) {
  constexpr int LD = HD + 1;
  for (int idx = threadIdx.x; idx < kBQ * HD; idx += kThreads) {
    const int r = idx / HD, d = idx % HD;
    const int row = r0 + r;
    dst[r * LD + d] = row < S ? src[static_cast<long long>(row) * HD + d] : 0.f;
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

template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o, int H, int KV, int S,
                     int causal, float scale) {
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
  const float* qb = q + (static_cast<long long>(b) * H + h) * head;
  const float* kb = k + (static_cast<long long>(b) * KV + kvh) * head;
  const float* vb = v + (static_cast<long long>(b) * KV + kvh) * head;
  float* ob = o + (static_cast<long long>(b) * H + h) * head;

  load_tile<HD>(Qs, qb, q0, S);

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
    load_tile<HD>(Ks, kb, k0, S);
    load_tile<HD>(Vs, vb, k0, S);
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
      ob[static_cast<long long>(qi) * HD + tx + 16 * d] = acc[i][d] / denom;
  }
}

template <int HD>
int launch_f32(const void* q, const void* k, const void* v, void* o, long long B, long long H,
               long long KV, long long S, int causal, cudaStream_t stream) {
  const size_t smem = smem_bytes_f32<HD>();
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_f32_kernel<HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (H > 65535 || B > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>((S + kBQ - 1) / kBQ), static_cast<unsigned>(H),
                  static_cast<unsigned>(B));
  flash_fwd_f32_kernel<HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), static_cast<int>(H), static_cast<int>(KV), static_cast<int>(S),
      causal, static_cast<float>(1.0 / sqrt(static_cast<double>(HD))));  // f32(hd**-0.5)
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------------------------------------------------
// bf16 route: tensor cores (mma.sync m16n8k16, f32 accumulation)
// ------------------------------------------------------------------------------------------

using tc::bf16;

constexpr int kTcBQ = 64;        // q rows per block: 4 warps of 16 rows
constexpr int kTcThreads = 128;

template <int HD>
struct TcCfg {
  static constexpr int BK = HD == 256 ? 32 : 64;   // kv rows per tile
  static constexpr int LD = HD + 8;                // row stride in shared memory (+16 bytes)
  static constexpr bool QREG = HD <= 128;          // Q held as A fragments in registers
  static constexpr int TILE = BK * LD;             // elements of one K or V tile
  // two stages of (K, V); with QREG the Q tile (64 rows <= 2 * BK) is read through stage 1
  // before the pipeline starts, else it keeps its own region after the stages
  static constexpr size_t SMEM = sizeof(bf16) * (4 * TILE + (QREG ? 0 : kTcBQ * LD));
  static_assert(!QREG || kTcBQ <= 2 * BK, "the Q tile must fit in one stage");
};

template <int HD>
__global__ void __launch_bounds__(kTcThreads)
flash_fwd_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, bf16* __restrict__ o, int B, int H, int KV,
                      int S, int n_qt, int causal, float scale_log2) {
  using Cfg = TcCfg<HD>;
  constexpr int BK = Cfg::BK, LD = Cfg::LD, TILE = Cfg::TILE;
  constexpr int NT = BK / 8;     // n8 tiles of a score row block
  constexpr int DT = HD / 8;     // n8 tiles of an output row block
  constexpr int KS = HD / 16;    // k16 steps of Q.K^T
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* const sm = reinterpret_cast<bf16*>(smem_raw);
  bf16* const Qs = Cfg::QREG ? sm + 2 * TILE : sm + 4 * TILE;

  // heaviest q tiles first; inside a q tile, batch, then the heads of one kv head adjacent
  const int h = blockIdx.x % H;
  const int rest = blockIdx.x / H;
  const int b = rest % B;
  const int qt = n_qt - 1 - rest / B;
  const int q0 = qt * kTcBQ;
  const int kvh = h / (H / KV);
  const long long head = static_cast<long long>(S) * HD;
  const bf16* qb = q + (static_cast<long long>(b) * H + h) * head;
  const bf16* kb = k + (static_cast<long long>(b) * KV + kvh) * head;
  const bf16* vb = v + (static_cast<long long>(b) * KV + kvh) * head;
  bf16* ob = o + (static_cast<long long>(b) * H + h) * head;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wrow = q0 + warp * 16;           // the warp's first q row
  const int row0 = wrow + g, row1 = row0 + 8;

  const int q_last = min(q0 + kTcBQ, S) - 1;
  const int kv_end = causal ? q_last + 1 : S;
  const int n_tiles = (kv_end + BK - 1) / BK;

  tc::load_rows_async(Qs, LD, qb, q0, kTcBQ, S, HD);
  tc::cp_async_commit();
  tc::load_rows_async(sm, LD, kb, 0, BK, S, HD);
  tc::load_rows_async(sm + TILE, LD, vb, 0, BK, S, HD);
  tc::cp_async_commit();

  const int a_off = (warp * 16 + tc::frag_a_row(lane)) * LD + tc::frag_a_col(lane);
  uint32_t qf[Cfg::QREG ? KS : 1][4];
  if constexpr (Cfg::QREG) {
    tc::cp_async_wait<1>();                  // Q has landed
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) tc::ldsm_x4(qf[kk], Qs + a_off + kk * 16);
    __syncthreads();                         // stage 1 is free for the pipeline
  }

  float acc[DT][4];
#pragma unroll
  for (int d = 0; d < DT; ++d) acc[d][0] = acc[d][1] = acc[d][2] = acc[d][3] = 0.f;
  float m0 = kNeg, m1 = kNeg, l0 = 0.f, l1 = 0.f;   // l: this lane's share of the row sum

  const int kb_off = tc::frag_bt_row(lane) * LD + tc::frag_bt_col(lane);
  const int v_off = tc::frag_a_row(lane) * LD + tc::frag_a_col(lane);

  for (int kt = 0; kt < n_tiles; ++kt) {
    if (kt + 1 < n_tiles) {
      bf16* nx = sm + ((kt + 1) & 1) * 2 * TILE;
      tc::load_rows_async(nx, LD, kb, (kt + 1) * BK, BK, S, HD);
      tc::load_rows_async(nx + TILE, LD, vb, (kt + 1) * BK, BK, S, HD);
    }
    tc::cp_async_commit();
    tc::cp_async_wait<1>();                  // tile kt has landed
    __syncthreads();
    const bf16* Ks = sm + (kt & 1) * 2 * TILE;
    const bf16* Vs = Ks + TILE;
    const int k0 = kt * BK;

    if (!causal || k0 <= wrow + 15) {        // else every key lies above this warp's rows
      // S = Q K^T
      float s[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t a[4];
        if constexpr (Cfg::QREG) {
#pragma unroll
          for (int r = 0; r < 4; ++r) a[r] = qf[kk][r];
        } else {
          tc::ldsm_x4(a, Qs + a_off + kk * 16);
        }
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          uint32_t bb[4];
          tc::ldsm_x4(bb, Ks + kb_off + np * 16 * LD + kk * 16);
          tc::mma_bf16(s[2 * np], a, bb[0], bb[1]);
          tc::mma_bf16(s[2 * np + 1], a, bb[2], bb[3]);
        }
      }

      // mask only the diagonal and the ragged last tile
      const bool need_mask = k0 + BK > S || (causal && k0 + BK - 1 > wrow);
      if (need_mask) {
#pragma unroll
        for (int j = 0; j < NT; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = k0 + j * 8 + 2 * t + (e & 1);
            const int row = e < 2 ? row0 : row1;
            if (key >= S || (causal && key > row)) s[j][e] = kNeg;
          }
        }
      }

      // online softmax in the exp2 domain (m is the scaled max): the four lanes of a quad
      // share rows g and g + 8; p = 2^(s * scale log2 e - m), one FFMA and one MUFU
      float mx0 = kNeg, mx1 = kNeg;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
        mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
      }
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
      }
      mx0 = fmaxf(m0, mx0 * scale_log2);
      mx1 = fmaxf(m1, mx1 * scale_log2);
      const float al0 = tc::ex2(m0 - mx0), al1 = tc::ex2(m1 - mx1);
      m0 = mx0;
      m1 = mx1;

      // P rounded to bf16 once; the row sum is taken from the same rounded values
      uint32_t pf[NT][2];
      float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const __nv_bfloat162 p01 =
            __floats2bfloat162_rn(tc::ex2(fmaf(s[j][0], scale_log2, -mx0)),
                                  tc::ex2(fmaf(s[j][1], scale_log2, -mx0)));
        const __nv_bfloat162 p23 =
            __floats2bfloat162_rn(tc::ex2(fmaf(s[j][2], scale_log2, -mx1)),
                                  tc::ex2(fmaf(s[j][3], scale_log2, -mx1)));
        const float2 f01 = __bfloat1622float2(p01), f23 = __bfloat1622float2(p23);
        rs0 += f01.x + f01.y;
        rs1 += f23.x + f23.y;
        pf[j][0] = tc::as_u32(p01);
        pf[j][1] = tc::as_u32(p23);
      }
      l0 = l0 * al0 + rs0;
      l1 = l1 * al1 + rs1;
#pragma unroll
      for (int d = 0; d < DT; ++d) {
        acc[d][0] *= al0;
        acc[d][1] *= al0;
        acc[d][2] *= al1;
        acc[d][3] *= al1;
      }

      // O += P V, P straight from the score registers as A fragments
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint32_t a[4] = {pf[2 * kk][0], pf[2 * kk][1], pf[2 * kk + 1][0],
                               pf[2 * kk + 1][1]};
#pragma unroll
        for (int dp = 0; dp < HD / 16; ++dp) {
          uint32_t bb[4];
          tc::ldsm_x4_t(bb, Vs + v_off + kk * 16 * LD + dp * 16);
          tc::mma_bf16(acc[2 * dp], a, bb[0], bb[1]);
          tc::mma_bf16(acc[2 * dp + 1], a, bb[2], bb[3]);
        }
      }
    }
    __syncthreads();                         // every warp is done with this stage
  }

#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
#pragma unroll
  for (int d = 0; d < DT; ++d) {
    const int col = d * 8 + 2 * t;
    if (row0 < S)
      *reinterpret_cast<uint32_t*>(ob + static_cast<long long>(row0) * HD + col) =
          tc::pack_bf16(acc[d][0] / d0, acc[d][1] / d0);
    if (row1 < S)
      *reinterpret_cast<uint32_t*>(ob + static_cast<long long>(row1) * HD + col) =
          tc::pack_bf16(acc[d][2] / d1, acc[d][3] / d1);
  }
}

template <int HD>
int launch_bf16(const void* q, const void* k, const void* v, void* o, long long B, long long H,
                long long KV, long long S, int causal, cudaStream_t stream) {
  using Cfg = TcCfg<HD>;
  const long long n_qt = (S + kTcBQ - 1) / kTcBQ;
  if (n_qt * H * B > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_bf16_kernel<HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(Cfg::SMEM));
  if (err != cudaSuccess) return static_cast<int>(err);
  const float scale_log2 =
      static_cast<float>(1.0 / sqrt(static_cast<double>(HD))) * kLog2e;  // f32(hd**-0.5) log2 e
  flash_fwd_bf16_kernel<HD><<<static_cast<unsigned>(n_qt * H * B), kTcThreads, Cfg::SMEM,
                              stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), static_cast<int>(B), static_cast<int>(H), static_cast<int>(KV),
      static_cast<int>(S), static_cast<int>(n_qt), causal, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

bool bad_sizes(long long H, long long KV) { return KV <= 0 || H % KV != 0; }

}  // namespace

// Plain C interface, loaded with ctypes.  q/o: (B,H,S,hd); k/v: (B,KV,S,hd); one dtype for all
// four, contiguous (the wrapper checks).  hd in {16, 32, 64, 128, 256}.  Returns a cudaError_t.
extern "C" {

int flash_attention_f32(const void* q, const void* k, const void* v, void* o, long long B,
                        long long H, long long KV, long long S, long long hd, int causal,
                        void* stream) {
  if (B <= 0 || S <= 0 || H <= 0) return static_cast<int>(cudaSuccess);
  if (bad_sizes(H, KV)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16: return launch_f32<16>(q, k, v, o, B, H, KV, S, causal, st);
    case 32: return launch_f32<32>(q, k, v, o, B, H, KV, S, causal, st);
    case 64: return launch_f32<64>(q, k, v, o, B, H, KV, S, causal, st);
    case 128: return launch_f32<128>(q, k, v, o, B, H, KV, S, causal, st);
    case 256: return launch_f32<256>(q, k, v, o, B, H, KV, S, causal, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

int flash_attention_bf16(const void* q, const void* k, const void* v, void* o, long long B,
                         long long H, long long KV, long long S, long long hd, int causal,
                         void* stream) {
  if (B <= 0 || S <= 0 || H <= 0) return static_cast<int>(cudaSuccess);
  if (bad_sizes(H, KV)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16: return launch_bf16<16>(q, k, v, o, B, H, KV, S, causal, st);
    case 32: return launch_bf16<32>(q, k, v, o, B, H, KV, S, causal, st);
    case 64: return launch_bf16<64>(q, k, v, o, B, H, KV, S, causal, st);
    case 128: return launch_bf16<128>(q, k, v, o, B, H, KV, S, causal, st);
    case 256: return launch_bf16<256>(q, k, v, o, B, H, KV, S, causal, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
