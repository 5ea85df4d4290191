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
// hundreds of operations per byte at training lengths, so the bf16 tensor cores (989 TFLOP/s)
// set the bound.  Three launches, each deterministic (no atomics: every output element is
// written once by one thread, so two calls give the same bits):
//
// 1. `attn_bwd_dot`: D = rowsum(dO o O) in f32, one warp a row.
// 2. dK/dV: blocks per key tile (and kv head, batch).  K and V of the tile stay in shared
//    memory; the block walks query heads and, for each, the query tiles that can see the tile
//    (from the diagonal on, when causal), recomputing S^T and dP^T for the (key, query) tile
//    pair, P^T and dS^T from them, and accumulating dK and dV in f32 registers.  (At bf16 hd
//    160 and 256 a fourth launch sums the head slices' partials; below.)
// 3. dQ: one block per (query tile, head, batch), walking the key tiles up to the diagonal and
//    accumulating dQ in f32 registers.
// The dK/dV walk re-forms S and dP that the dQ walk forms too: seven tile products where a fused
// backward (dQ summed by atomics) does five; that is the price of the same bits on every call.
//
// Two routes, chosen by dtype in `flash_attention_bwd_bf16` / `_f32` (kernel.py's
// TC_BWD_HEAD_DIMS and bwd_route mirror the choice):
//
// bf16 at every head dim (the training path): tensor cores.  128-thread blocks of 4 warps, each
// warp 16 rows (keys in dK/dV, queries in dQ); every product is mma.sync m16n8k16 on bf16
// fragments with f32 accumulation, through tc_sm90.cuh.  Tiles stay bf16 in shared memory with
// rows padded by 16 bytes (conflict-free ldmatrix), and the walked tiles (Q, dO and their LSE,
// D rows in dK/dV; K, V in dQ) arrive by cp.async in a two-stage ring: tile i+1 is in flight
// while tile i is used.  P and dS are split into bf16 hi + lo (tc::split_bf16) and each half
// multiplies the exact bf16 operand: one bf16 rounding of P and dS alone lands up to 2x outside
// the bf16 tolerance against the plain formulas in f32 (GQA sums many heads' roundings into one
// dK/dV row; tests/test_torch_flash_attention.py emulates both), hi + lo keeps them to about
// 2^-16, at three more products a tile pair.  P is 2^(S scale log2 e - LSE log2 e) by
// ex2.approx; masked entries are set to exactly 0.  The grids run the heaviest tiles first: key
// tiles nearest 0 for dK/dV, query tiles nearest S for dQ, as the forward orders its grid.
//
// - hd 16-128, `attn_bwd_dkdv_tc`: one block per (64-key tile, kv head, batch) walks the
//   group's query heads and, for each, the query tiles that see the key tile.  It forms
//   S^T = K Q^T and dP^T = V dO^T (Q and dO the B operands, stored [query][d], read by
//   ldmatrix), then P^T and dS^T in registers (LSE and D are per query, so they index the C
//   fragment's column), and feeds them straight from the score registers as A fragments into
//   dV += P^T dO and dK += dS^T Q (dO and Q read by ldmatrix.trans), with the forward's pairing
//   of C tiles into A (flash_attention.cu, P.V); P and dS never touch shared memory.  Query
//   tiles are 64 rows (32 at hd 128) so that the two f32 accumulators (16 rows x hd each) and
//   the score tiles fit the registers; at hd <= 64 the warp's K and V rows stay in registers as
//   A fragments for the whole walk.  Ten tile products a (key, query) tile pair with dQ's.
// - hd 160 and 256, `attn_bwd_dkdv_sweep_tc`: the two accumulators would take hd registers a
//   thread (256 at hd 256), so dV and dK are formed in separate sweeps, each by its own block
//   with one accumulator (hd / 2 registers): the dV sweep forms S^T and P^T, dV += P^T dO; the
//   dK sweep forms S^T and dP^T again, dS^T, dK += dS^T Q (eleven tile products a pair with
//   dQ's).  K and V stay in shared memory and are read by ldmatrix at each step; query tiles
//   are 32 rows, and at hd 256 the walk's ring has one stage (below).  MQA and wide GQA groups
//   give too few (key tile, kv head, batch) blocks to fill 132 SMs (recurrentgemma-9b's
//   training shape: 32), so the group's query heads are split into `slices` (kernel.py's
//   bwd_slices: the fewest that give a sweep at least one block an SM); each block of a slice
//   writes its f32 partial to a workspace and `attn_bwd_dkdv_finish` sums the partials in
//   slice order, scales dK and casts to bf16.
//   With one slice the sweeps write the bf16 outputs themselves.  Shared memory a block:
//   101,632 bytes at hd 256, 86,528 at hd 160: two blocks an SM.
// - dQ, `attn_bwd_dq_tc`: one block per (64-query tile, head, batch), walking the key tiles
//   up to the diagonal (64 rows, 32 at hd >= 128); it forms S = Q K^T and dP = dO V^T, dS in
//   registers, and dQ += dS K (K by ldmatrix.trans).  At hd <= 128 the warp's Q and dO rows
//   are held as A fragments; at hd 160 and 256 they stay in shared memory, read by ldmatrix at
//   each step, so that the hd / 2-register accumulator and the score tiles fit.
// - At hd 256 both walks load each tile into a one-stage ring after the previous step's closing
//   barrier, so a block waits for its loads; two stages would take 135 KB a block and leave one
//   4-warp block an SM, which ran 1.35x slower on an H100 than two blocks that overlap each
//   other's loads.  The other head dims keep the two-stage ring.
//
// f32 (the route that matches the reference closely: `train_agree`, the f32 checks): CUDA
// cores, `attn_bwd_dkdv` and `attn_bwd_dq`, 256-thread blocks.  Tiles are 64 keys x 64
// queries (32 x 32 at hd 256, to stay within 227 KB of shared memory), f32 in shared memory
// with rows padded by one float; each thread holds a 4x4 (2x2) micro-tile of the scores and 4
// (2) rows x hd/16 columns of its accumulators.  P is recomputed with expf, never
// --use_fast_math.
//
// Outputs are written in the input dtype.  The kernels allocate nothing and never synchronise;
// they run on the caller's stream.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tc_sm90.cuh"

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

// BT rows of one head starting at row r0, widened to f32; rows at or past S are zero.
template <int HD, int BT>
__device__ __forceinline__ void load_tile(float* dst, const float* __restrict__ src, int r0,
                                          int S) {
  constexpr int LD = HD + 1;
  for (int idx = threadIdx.x; idx < BT * HD; idx += kThreads) {
    const int r = idx / HD, d = idx % HD;
    const int row = r0 + r;
    dst[r * LD + d] = row < S ? src[static_cast<long long>(row) * HD + d] : 0.f;
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
template <int HD>
__global__ void __launch_bounds__(kThreads)
attn_bwd_dkdv(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ dvec,
              float* __restrict__ dk, float* __restrict__ dv, int H,
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
      dk[at] = dk_acc[a][e] * scale;
      dv[at] = dv_acc[a][e];
    }
  }
}

// dQ for one (query tile, head, batch)
template <int HD>
__global__ void __launch_bounds__(kThreads)
attn_bwd_dq(const float* __restrict__ q, const float* __restrict__ k,
            const float* __restrict__ v, const float* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ dvec,
            float* __restrict__ dq, int H, int KV, int S,
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
      dq[qoff + static_cast<long long>(qi) * HD + tx + 16 * e] = dq_acc[a][e] * scale;
  }
}

// ------------------------------------------------------------------------------------------
// bf16 route at hd 16-128: tensor cores (mma.sync m16n8k16, f32 accumulation)
// ------------------------------------------------------------------------------------------

using tc::bf16;

constexpr int kTcThreads = 128;            // 4 warps of 16 rows
constexpr float kLog2e = 1.4426950408889634f;

template <int HD>
struct TcCfg {
  static constexpr int LD = HD + 8;        // bf16 row stride in shared memory (+16 bytes)
  static constexpr int KS = HD / 16;       // k16 steps over the head dim
  static constexpr int DT = HD / 8;        // n8 tiles of an accumulator row block
  // dK/dV: 64 keys a block; the walked query tiles, BQ rows, in two stages
  static constexpr int BKEY = 64;
  static constexpr int BQ = HD >= 128 ? 32 : 64;
  static constexpr bool KVREG = HD <= 64;  // the warp's K and V rows held as A fragments
  // stages of the walked tiles' ring (dK/dV and dQ): one at hd 256, so that two blocks share
  // an SM (two stages: 135,680 bytes a block, one block an SM, 1.35x the device time)
  static constexpr int STAGES = HD == 256 ? 1 : 2;
  // K, V; the stages of (Q, dO) and of the (LSE, D) rows
  static constexpr size_t SMEM_DKDV = sizeof(bf16) * (2 * BKEY * LD + 2 * STAGES * BQ * LD) +
                                      sizeof(float) * 2 * STAGES * BQ;
  // dQ: 64 queries a block; the walked key tiles, BK rows
  static constexpr int BQQ = 64;
  static constexpr int BK = HD >= 128 ? 32 : 64;
  static constexpr bool QREG = HD <= 128;  // the warp's Q and dO rows held as A fragments
  static constexpr size_t SMEM_DQ = sizeof(bf16) * (2 * BQQ * LD + 2 * STAGES * BK * LD);
};

// the A fragments (hi and lo halves) of one k16 step from two C tiles of f32 values, as the
// forward pairs P's C tiles into A: c[half][0..1] row g, c[half][2..3] row g + 8
__device__ __forceinline__ void split_a(const float (&c)[2][4], uint32_t (&hi)[4],
                                        uint32_t (&lo)[4]) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    tc::split_bf16(c[half][0], c[half][1], hi[2 * half], lo[2 * half]);
    tc::split_bf16(c[half][2], c[half][3], hi[2 * half + 1], lo[2 * half + 1]);
  }
}

// acc[2 dp], acc[2 dp + 1] += (hi + lo) * the [k][n] tile at `b` (16 rows of k, 16 of n)
__device__ __forceinline__ void mma_split(float (&acc0)[4], float (&acc1)[4],
                                          const uint32_t (&hi)[4], const uint32_t (&lo)[4],
                                          const bf16* b) {
  uint32_t bb[4];
  tc::ldsm_x4_t(bb, b);
  tc::mma_bf16(acc0, hi, bb[0], bb[1]);
  tc::mma_bf16(acc0, lo, bb[0], bb[1]);
  tc::mma_bf16(acc1, hi, bb[2], bb[3]);
  tc::mma_bf16(acc1, lo, bb[2], bb[3]);
}

// dK, dV for one (64-key tile, kv head, batch)
template <int HD>
__global__ void __launch_bounds__(kTcThreads)
attn_bwd_dkdv_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const bf16* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ dvec,
                 bf16* __restrict__ dk, bf16* __restrict__ dv, int B, int H, int KV, int S,
                 int causal, float scale, float scale_log2) {
  using C = TcCfg<HD>;
  constexpr int LD = C::LD, KS = C::KS, DT = C::DT, BKEY = C::BKEY, BQ = C::BQ;
  constexpr int NT = BQ / 8;               // n8 tiles of a score row block (queries)
  constexpr int QT = BQ * LD;              // elements of one Q or dO tile
  static_assert(C::STAGES == 2, "the walk's ring has two stages");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* const Ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* const Vs = Ks + BKEY * LD;
  bf16* const stages = Vs + BKEY * LD;     // [stage][Q, dO]
  float* const rows = reinterpret_cast<float*>(stages + 4 * QT);   // [stage][LSE, D]

  // heaviest key tiles first (under the causal mask every query tile sees key tile 0); the kv
  // heads of one (key tile, batch) adjacent
  const int kvh = blockIdx.x % KV;
  const int rest = blockIdx.x / KV;
  const int b = rest % B;
  const int k0 = (rest / B) * BKEY;
  const int G = H / KV;
  const long long head = static_cast<long long>(S) * HD;
  const long long kvoff = (static_cast<long long>(b) * KV + kvh) * head;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int kw0 = k0 + warp * 16;          // the warp's first key

  // the walk: the group's query heads, and for each the query tiles that see this key tile
  const int n_qt = (S + BQ - 1) / BQ;
  const int qt0 = causal ? k0 / BQ : 0;
  const int per_head = n_qt - qt0;         // >= 1: k0 < S
  const int n_it = G * per_head;

  // Q, dO, LSE and D of walk step `it` into stage it & 1 (rows past S zero-filled)
  auto issue = [&](int it) {
    const long long bh = static_cast<long long>(b) * H + kvh * G + it / per_head;
    const int q0 = (qt0 + it % per_head) * BQ;
    bf16* const dst = stages + (it & 1) * 2 * QT;
    tc::load_rows_async(dst, LD, q + bh * head, q0, BQ, S, HD);
    tc::load_rows_async(dst + QT, LD, dout + bh * head, q0, BQ, S, HD);
    float* const r = rows + (it & 1) * 2 * BQ;
    for (int i = threadIdx.x; i < 2 * BQ; i += kTcThreads) {
      const int qi = q0 + (i < BQ ? i : i - BQ);
      const bool ok = qi < S;
      tc::cp_async4(r + i, (i < BQ ? lse : dvec) + bh * S + (ok ? qi : 0), ok);
    }
  };

  tc::load_rows_async(Ks, LD, k + kvoff, k0, BKEY, S, HD);
  tc::load_rows_async(Vs, LD, v + kvoff, k0, BKEY, S, HD);
  tc::cp_async_commit();
  issue(0);
  tc::cp_async_commit();

  const int a_off = (warp * 16 + tc::frag_a_row(lane)) * LD + tc::frag_a_col(lane);
  const int bt_off = tc::frag_bt_row(lane) * LD + tc::frag_bt_col(lane);
  const int tr_off = tc::frag_a_row(lane) * LD + tc::frag_a_col(lane);

  uint32_t kf[C::KVREG ? KS : 1][4], vf[C::KVREG ? KS : 1][4];
  float dk_acc[DT][4], dv_acc[DT][4];
#pragma unroll
  for (int d = 0; d < DT; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[d][e] = dv_acc[d][e] = 0.f;

  for (int it = 0; it < n_it; ++it) {
    if (it + 1 < n_it) issue(it + 1);
    tc::cp_async_commit();
    tc::cp_async_wait<1>();                // K, V and walk step it have landed
    __syncthreads();
    if constexpr (C::KVREG) {
      if (it == 0) {
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) {
          tc::ldsm_x4(kf[kk], Ks + a_off + kk * 16);
          tc::ldsm_x4(vf[kk], Vs + a_off + kk * 16);
        }
      }
    }
    const bf16* const Qs = stages + (it & 1) * 2 * QT;
    const bf16* const dOs = Qs + QT;
    const float* const Ls = rows + (it & 1) * 2 * BQ;
    const float* const Ds = Ls + BQ;
    const int q0 = (qt0 + it % per_head) * BQ;

    if (!causal || q0 + BQ - 1 >= kw0) {   // else every query of the tile precedes these keys
      // S^T = K Q^T and dP^T = V dO^T for the warp's 16 keys x BQ queries
      float s[NT][4], dpt[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dpt[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t ak[4], av[4];
        if constexpr (C::KVREG) {
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            ak[r] = kf[kk][r];
            av[r] = vf[kk][r];
          }
        } else {
          tc::ldsm_x4(ak, Ks + a_off + kk * 16);
          tc::ldsm_x4(av, Vs + a_off + kk * 16);
        }
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          uint32_t bb[4];
          tc::ldsm_x4(bb, Qs + bt_off + np * 16 * LD + kk * 16);
          tc::mma_bf16(s[2 * np], ak, bb[0], bb[1]);
          tc::mma_bf16(s[2 * np + 1], ak, bb[2], bb[3]);
          tc::ldsm_x4(bb, dOs + bt_off + np * 16 * LD + kk * 16);
          tc::mma_bf16(dpt[2 * np], av, bb[0], bb[1]);
          tc::mma_bf16(dpt[2 * np + 1], av, bb[2], bb[3]);
        }
      }

      // P^T and dS^T in registers: keys are the fragment's rows (g, g + 8), queries its
      // columns (2t, 2t + 1 of each n8 tile), so LSE and D are read by column
      const bool need_mask = q0 + BQ > S || kw0 + 16 > S || (causal && q0 < kw0 + 15);
#pragma unroll
      for (int kk = 0; kk < NT / 2; ++kk) {   // k16 steps over the tile's queries
        float p[2][4], ds[2][4];
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int j = 2 * kk + half;
          const int c = j * 8 + 2 * t;
          const float2 l2 = *reinterpret_cast<const float2*>(Ls + c);
          const float2 d2 = *reinterpret_cast<const float2*>(Ds + c);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float lv = (e & 1) ? l2.y : l2.x;
            float pe = tc::ex2(fmaf(s[j][e], scale_log2, -lv * kLog2e));
            if (need_mask) {
              const int qi = q0 + c + (e & 1), kj = kw0 + g + (e >> 1) * 8;
              if (qi >= S || kj >= S || (causal && kj > qi)) pe = 0.f;
            }
            p[half][e] = pe;
            ds[half][e] = pe * (dpt[j][e] - ((e & 1) ? d2.y : d2.x));
          }
        }
        uint32_t ph[4], pl[4], dh[4], dl[4];
        split_a(p, ph, pl);
        split_a(ds, dh, dl);
        // dV += P^T dO, dK += dS^T Q (dO and Q stored [query][d]: B by ldmatrix.trans)
#pragma unroll
        for (int dp = 0; dp < HD / 16; ++dp) {
          const int off = tr_off + kk * 16 * LD + dp * 16;
          mma_split(dv_acc[2 * dp], dv_acc[2 * dp + 1], ph, pl, dOs + off);
          mma_split(dk_acc[2 * dp], dk_acc[2 * dp + 1], dh, dl, Qs + off);
        }
      }
    }
    __syncthreads();                       // every warp is done with this stage
  }

  const int r0 = kw0 + g, r1 = r0 + 8;
#pragma unroll
  for (int d = 0; d < DT; ++d) {
    const long long col = kvoff + d * 8 + 2 * t;
    if (r0 < S) {
      *reinterpret_cast<uint32_t*>(dk + col + static_cast<long long>(r0) * HD) =
          tc::pack_bf16(dk_acc[d][0] * scale, dk_acc[d][1] * scale);
      *reinterpret_cast<uint32_t*>(dv + col + static_cast<long long>(r0) * HD) =
          tc::pack_bf16(dv_acc[d][0], dv_acc[d][1]);
    }
    if (r1 < S) {
      *reinterpret_cast<uint32_t*>(dk + col + static_cast<long long>(r1) * HD) =
          tc::pack_bf16(dk_acc[d][2] * scale, dk_acc[d][3] * scale);
      *reinterpret_cast<uint32_t*>(dv + col + static_cast<long long>(r1) * HD) =
          tc::pack_bf16(dv_acc[d][2], dv_acc[d][3]);
    }
  }
}

// dQ for one (64-query tile, head, batch)
template <int HD>
__global__ void __launch_bounds__(kTcThreads)
attn_bwd_dq_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, const bf16* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ dvec,
               bf16* __restrict__ dq, int B, int H, int KV, int S, int n_qt, int causal,
               float scale, float scale_log2) {
  using C = TcCfg<HD>;
  constexpr int LD = C::LD, KS = C::KS, DT = C::DT, BQQ = C::BQQ, BK = C::BK, ST = C::STAGES;
  constexpr int NT = BK / 8;               // n8 tiles of a score row block (keys)
  constexpr int KT = BK * LD;              // elements of one K or V tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* const Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* const dOs = Qs + BQQ * LD;
  bf16* const stages = dOs + BQQ * LD;     // [stage][K, V]

  // heaviest query tiles first; inside a query tile, batch, then the heads of one kv head
  const int h = blockIdx.x % H;
  const int rest = blockIdx.x / H;
  const int b = rest % B;
  const int q0 = (n_qt - 1 - rest / B) * BQQ;
  const int kvh = h / (H / KV);
  const long long head = static_cast<long long>(S) * HD;
  const long long bh = static_cast<long long>(b) * H + h;
  const bf16* const kb = k + (static_cast<long long>(b) * KV + kvh) * head;
  const bf16* const vb = v + (static_cast<long long>(b) * KV + kvh) * head;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wrow = q0 + warp * 16;         // the warp's first query
  const int row0 = wrow + g, row1 = row0 + 8;

  const int q_last = min(q0 + BQQ, S) - 1;
  const int kv_end = causal ? q_last + 1 : S;
  const int n_kt = (kv_end + BK - 1) / BK;

  tc::load_rows_async(Qs, LD, q + bh * head, q0, BQQ, S, HD);
  tc::load_rows_async(dOs, LD, dout + bh * head, q0, BQQ, S, HD);
  tc::cp_async_commit();
  if constexpr (ST == 2) {
    tc::load_rows_async(stages, LD, kb, 0, BK, S, HD);
    tc::load_rows_async(stages + KT, LD, vb, 0, BK, S, HD);
    tc::cp_async_commit();
  }

  // the rows' LSE (in base 2) and D; rows past S are never written
  const float* const lrow = lse + bh * S;
  const float* const drow = dvec + bh * S;
  const float l0 = row0 < S ? lrow[row0] * kLog2e : 0.f;
  const float l1 = row1 < S ? lrow[row1] * kLog2e : 0.f;
  const float d0 = row0 < S ? drow[row0] : 0.f;
  const float d1 = row1 < S ? drow[row1] : 0.f;

  const int a_off = (warp * 16 + tc::frag_a_row(lane)) * LD + tc::frag_a_col(lane);
  const int bt_off = tc::frag_bt_row(lane) * LD + tc::frag_bt_col(lane);
  const int tr_off = tc::frag_a_row(lane) * LD + tc::frag_a_col(lane);

  uint32_t qf[C::QREG ? KS : 1][4], of[C::QREG ? KS : 1][4];
  tc::cp_async_wait<ST - 1>();             // Q and dO have landed
  __syncthreads();
  if constexpr (C::QREG) {
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      tc::ldsm_x4(qf[kk], Qs + a_off + kk * 16);
      tc::ldsm_x4(of[kk], dOs + a_off + kk * 16);
    }
  }

  float dq_acc[DT][4];
#pragma unroll
  for (int d = 0; d < DT; ++d) dq_acc[d][0] = dq_acc[d][1] = dq_acc[d][2] = dq_acc[d][3] = 0.f;

  for (int kt = 0; kt < n_kt; ++kt) {
    // two stages: tile kt + 1 in flight while kt is used; one: tile kt, into the stage the
    // last step's closing barrier freed
    const int ld_kt = kt + ST - 1;
    if (ld_kt < n_kt) {
      bf16* const nx = stages + (ld_kt % ST) * 2 * KT;
      tc::load_rows_async(nx, LD, kb, ld_kt * BK, BK, S, HD);
      tc::load_rows_async(nx + KT, LD, vb, ld_kt * BK, BK, S, HD);
    }
    tc::cp_async_commit();
    tc::cp_async_wait<ST - 1>();           // key tile kt has landed
    __syncthreads();
    const bf16* const Ks = stages + (kt % ST) * 2 * KT;
    const bf16* const Vs = Ks + KT;
    const int k0 = kt * BK;

    if (!causal || k0 <= wrow + 15) {      // else every key lies above this warp's rows
      // S = Q K^T and dP = dO V^T (K and V stored [key][d]: B by ldmatrix)
      float s[NT][4], dpm[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dpm[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t aq[4], ao[4];
        if constexpr (C::QREG) {
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            aq[r] = qf[kk][r];
            ao[r] = of[kk][r];
          }
        } else {
          tc::ldsm_x4(aq, Qs + a_off + kk * 16);
          tc::ldsm_x4(ao, dOs + a_off + kk * 16);
        }
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          uint32_t bb[4];
          tc::ldsm_x4(bb, Ks + bt_off + np * 16 * LD + kk * 16);
          tc::mma_bf16(s[2 * np], aq, bb[0], bb[1]);
          tc::mma_bf16(s[2 * np + 1], aq, bb[2], bb[3]);
          tc::ldsm_x4(bb, Vs + bt_off + np * 16 * LD + kk * 16);
          tc::mma_bf16(dpm[2 * np], ao, bb[0], bb[1]);
          tc::mma_bf16(dpm[2 * np + 1], ao, bb[2], bb[3]);
        }
      }

      // dS in registers, then dQ += dS K (K stored [key][d]: B by ldmatrix.trans)
      const bool need_mask = k0 + BK > S || (causal && k0 + BK - 1 > wrow);
#pragma unroll
      for (int kk = 0; kk < NT / 2; ++kk) {   // k16 steps over the tile's keys
        float ds[2][4];
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int j = 2 * kk + half;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float pe = tc::ex2(fmaf(s[j][e], scale_log2, e < 2 ? -l0 : -l1));
            if (need_mask) {
              const int key = k0 + j * 8 + 2 * t + (e & 1);
              if (key >= S || (causal && key > (e < 2 ? row0 : row1))) pe = 0.f;
            }
            ds[half][e] = pe * (dpm[j][e] - (e < 2 ? d0 : d1));
          }
        }
        uint32_t dh[4], dl[4];
        split_a(ds, dh, dl);
#pragma unroll
        for (int dp = 0; dp < HD / 16; ++dp)
          mma_split(dq_acc[2 * dp], dq_acc[2 * dp + 1], dh, dl,
                    Ks + tr_off + kk * 16 * LD + dp * 16);
      }
    }
    __syncthreads();                       // every warp is done with this stage
  }

  bf16* const dqb = dq + bh * head;
#pragma unroll
  for (int d = 0; d < DT; ++d) {
    const int col = d * 8 + 2 * t;
    if (row0 < S)
      *reinterpret_cast<uint32_t*>(dqb + static_cast<long long>(row0) * HD + col) =
          tc::pack_bf16(dq_acc[d][0] * scale, dq_acc[d][1] * scale);
    if (row1 < S)
      *reinterpret_cast<uint32_t*>(dqb + static_cast<long long>(row1) * HD + col) =
          tc::pack_bf16(dq_acc[d][2] * scale, dq_acc[d][3] * scale);
  }
}

// ------------------------------------------------------------------------------------------
// bf16 route at hd 160 and 256: dV and dK in separate sweeps, over head slices
// ------------------------------------------------------------------------------------------

// One sweep of a (64-key tile, kv head, head slice, batch) block: the slice's query heads and,
// for each, the query tiles that see the key tile.  DK false: dV += P^T dO; DK true:
// dK += dS^T Q.  The warp's 16 keys x hd accumulate in f32 and go out as the bf16 output
// (`part` null: one slice, dK scaled) or as the slice's f32 partial into `part`.
template <int HD, bool DK>
__device__ __forceinline__ void dkdv_sweep(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ dvec,
    bf16* __restrict__ out, float* __restrict__ part, int b, int H, int KV, int S, int kvh,
    int sl, int slices, int k0, int causal, float scale, float scale_log2) {
  using C = TcCfg<HD>;
  constexpr int LD = C::LD, KS = C::KS, DT = C::DT, BKEY = C::BKEY, BQ = C::BQ;
  constexpr int ST = C::STAGES;
  constexpr int NT = BQ / 8;               // n8 tiles of a score row block (queries)
  constexpr int QT = BQ * LD;              // elements of one Q or dO tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* const Ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* const Vs = Ks + BKEY * LD;         // the dK sweep's
  bf16* const stages = Vs + BKEY * LD;     // [stage][Q, dO]
  float* const rows = reinterpret_cast<float*>(stages + 2 * ST * QT);   // [stage][LSE, D]

  const int GS = H / KV / slices;          // query heads a slice
  const long long head = static_cast<long long>(S) * HD;
  const long long kvoff = (static_cast<long long>(b) * KV + kvh) * head;
  const long long bh0 = static_cast<long long>(b) * H + kvh * (H / KV) + sl * GS;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int kw0 = k0 + warp * 16;          // the warp's first key

  const int n_qt = (S + BQ - 1) / BQ;
  const int qt0 = causal ? k0 / BQ : 0;
  const int per_head = n_qt - qt0;         // >= 1: k0 < S
  const int n_it = GS * per_head;

  // Q, dO, LSE and D of walk step `it` into stage it % ST (rows past S zero-filled)
  auto issue = [&](int it) {
    const long long bh = bh0 + it / per_head;
    const int q0 = (qt0 + it % per_head) * BQ;
    bf16* const dst = stages + (it % ST) * 2 * QT;
    tc::load_rows_async(dst, LD, q + bh * head, q0, BQ, S, HD);
    tc::load_rows_async(dst + QT, LD, dout + bh * head, q0, BQ, S, HD);
    float* const r = rows + (it % ST) * 2 * BQ;
    for (int i = threadIdx.x; i < 2 * BQ; i += kTcThreads) {
      const int qi = q0 + (i < BQ ? i : i - BQ);
      const bool ok = qi < S;
      tc::cp_async4(r + i, (i < BQ ? lse : dvec) + bh * S + (ok ? qi : 0), ok);
    }
  };

  tc::load_rows_async(Ks, LD, k + kvoff, k0, BKEY, S, HD);
  if constexpr (DK) tc::load_rows_async(Vs, LD, v + kvoff, k0, BKEY, S, HD);
  tc::cp_async_commit();
  if constexpr (ST == 2) {
    issue(0);
    tc::cp_async_commit();
  }

  const int a_off = (warp * 16 + tc::frag_a_row(lane)) * LD + tc::frag_a_col(lane);
  const int bt_off = tc::frag_bt_row(lane) * LD + tc::frag_bt_col(lane);
  const int tr_off = tc::frag_a_row(lane) * LD + tc::frag_a_col(lane);

  float acc[DT][4];
#pragma unroll
  for (int d = 0; d < DT; ++d) acc[d][0] = acc[d][1] = acc[d][2] = acc[d][3] = 0.f;

  for (int it = 0; it < n_it; ++it) {
    // two stages: step it + 1 in flight while it is used; one: step it, into the stage the
    // last step's closing barrier freed
    if (it + ST - 1 < n_it) issue(it + ST - 1);
    tc::cp_async_commit();
    tc::cp_async_wait<ST - 1>();           // K (and V) and walk step it have landed
    __syncthreads();
    const bf16* const Qs = stages + (it % ST) * 2 * QT;
    const bf16* const dOs = Qs + QT;
    const float* const Ls = rows + (it % ST) * 2 * BQ;
    const float* const Ds = Ls + BQ;
    const int q0 = (qt0 + it % per_head) * BQ;

    if (!causal || q0 + BQ - 1 >= kw0) {   // else every query of the tile precedes these keys
      // S^T = K Q^T (and dP^T = V dO^T) for the warp's 16 keys x BQ queries, K and V read by
      // ldmatrix at each step
      float s[NT][4], dpt[DK ? NT : 1][4];
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
      if constexpr (DK) {
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) dpt[j][e] = 0.f;
      }
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t ak[4];
        tc::ldsm_x4(ak, Ks + a_off + kk * 16);
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          uint32_t bb[4];
          tc::ldsm_x4(bb, Qs + bt_off + np * 16 * LD + kk * 16);
          tc::mma_bf16(s[2 * np], ak, bb[0], bb[1]);
          tc::mma_bf16(s[2 * np + 1], ak, bb[2], bb[3]);
        }
        if constexpr (DK) {
          uint32_t av[4];
          tc::ldsm_x4(av, Vs + a_off + kk * 16);
#pragma unroll
          for (int np = 0; np < NT / 2; ++np) {
            uint32_t bb[4];
            tc::ldsm_x4(bb, dOs + bt_off + np * 16 * LD + kk * 16);
            tc::mma_bf16(dpt[2 * np], av, bb[0], bb[1]);
            tc::mma_bf16(dpt[2 * np + 1], av, bb[2], bb[3]);
          }
        }
      }

      // P^T (dV) or dS^T (dK) in registers, as in attn_bwd_dkdv_tc, then the accumulating
      // product with dO or Q (stored [query][d]: B by ldmatrix.trans)
      const bool need_mask = q0 + BQ > S || kw0 + 16 > S || (causal && q0 < kw0 + 15);
#pragma unroll
      for (int kk = 0; kk < NT / 2; ++kk) {   // k16 steps over the tile's queries
        float x[2][4];
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int j = 2 * kk + half;
          const int c = j * 8 + 2 * t;
          const float2 l2 = *reinterpret_cast<const float2*>(Ls + c);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float lv = (e & 1) ? l2.y : l2.x;
            float pe = tc::ex2(fmaf(s[j][e], scale_log2, -lv * kLog2e));
            if (need_mask) {
              const int qi = q0 + c + (e & 1), kj = kw0 + g + (e >> 1) * 8;
              if (qi >= S || kj >= S || (causal && kj > qi)) pe = 0.f;
            }
            if constexpr (DK) {
              const float2 d2 = *reinterpret_cast<const float2*>(Ds + c);
              pe *= dpt[j][e] - ((e & 1) ? d2.y : d2.x);
            }
            x[half][e] = pe;
          }
        }
        uint32_t hi[4], lo[4];
        split_a(x, hi, lo);
        const bf16* const bsrc = (DK ? Qs : dOs) + tr_off + kk * 16 * LD;
#pragma unroll
        for (int dp = 0; dp < HD / 16; ++dp)
          mma_split(acc[2 * dp], acc[2 * dp + 1], hi, lo, bsrc + dp * 16);
      }
    }
    __syncthreads();                       // every warp is done with this stage
  }

  const int r0 = kw0 + g, r1 = r0 + 8;
  if (part == nullptr) {
    const float m = DK ? scale : 1.f;
#pragma unroll
    for (int d = 0; d < DT; ++d) {
      bf16* const o = out + kvoff + d * 8 + 2 * t;
      if (r0 < S)
        *reinterpret_cast<uint32_t*>(o + static_cast<long long>(r0) * HD) =
            tc::pack_bf16(acc[d][0] * m, acc[d][1] * m);
      if (r1 < S)
        *reinterpret_cast<uint32_t*>(o + static_cast<long long>(r1) * HD) =
            tc::pack_bf16(acc[d][2] * m, acc[d][3] * m);
    }
  } else {
#pragma unroll
    for (int d = 0; d < DT; ++d) {
      float* const o = part + kvoff + d * 8 + 2 * t;
      if (r0 < S)
        *reinterpret_cast<float2*>(o + static_cast<long long>(r0) * HD) =
            make_float2(acc[d][0], acc[d][1]);
      if (r1 < S)
        *reinterpret_cast<float2*>(o + static_cast<long long>(r1) * HD) =
            make_float2(acc[d][2], acc[d][3]);
    }
  }
}

// dV (even blocks) or dK (odd) for one (64-key tile, kv head, head slice, batch); with more
// than one slice, the slice's f32 partial into work[slice][dV, dK] (B, KV, S, hd)
template <int HD>
__global__ void __launch_bounds__(kTcThreads)
attn_bwd_dkdv_sweep_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, const bf16* __restrict__ dout,
                       const float* __restrict__ lse, const float* __restrict__ dvec,
                       bf16* __restrict__ dk, bf16* __restrict__ dv, float* __restrict__ work,
                       int B, int H, int KV, int S, int slices, int causal, float scale,
                       float scale_log2) {
  // heaviest key tiles first; inside one key tile: batch, kv head, slice, then the two sweeps,
  // so that the blocks reading the same Q and dO tiles run side by side
  const int is_dk = blockIdx.x & 1;
  int rest = blockIdx.x >> 1;
  const int sl = rest % slices;
  rest /= slices;
  const int kvh = rest % KV;
  rest /= KV;
  const int b = rest % B;
  const int k0 = (rest / B) * TcCfg<HD>::BKEY;
  const long long n = static_cast<long long>(B) * KV * S * HD;
  float* const part = slices > 1 ? work + (2LL * sl + is_dk) * n : nullptr;
  if (is_dk)
    dkdv_sweep<HD, true>(q, k, v, dout, lse, dvec, dk, part, b, H, KV, S, kvh, sl, slices, k0,
                         causal, scale, scale_log2);
  else
    dkdv_sweep<HD, false>(q, k, v, dout, lse, dvec, dv, part, b, H, KV, S, kvh, sl, slices, k0,
                          causal, scale, scale_log2);
}

// dV and dK from the slices' f32 partials (work: [slice][dV, dK][n4 groups of 4]), summed in
// slice order, dK scaled, cast to bf16
__global__ void __launch_bounds__(kThreads)
attn_bwd_dkdv_finish(const float* __restrict__ work, bf16* __restrict__ dk,
                     bf16* __restrict__ dv, long long n4, int slices, float scale) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n4) return;
  const float4* const w = reinterpret_cast<const float4*>(work);
#pragma unroll
  for (int which = 0; which < 2; ++which) {
    float4 a = w[which * n4 + i];
    for (int sl = 1; sl < slices; ++sl) {
      const float4 x = w[(2LL * sl + which) * n4 + i];
      a.x += x.x;
      a.y += x.y;
      a.z += x.z;
      a.w += x.w;
    }
    const float m = which ? scale : 1.f;
    uint2 o;
    o.x = tc::pack_bf16(a.x * m, a.y * m);
    o.y = tc::pack_bf16(a.z * m, a.w * m);
    reinterpret_cast<uint2*>(which ? dk : dv)[i] = o;
  }
}

// ------------------------------------------------------------------------------------------
// launchers
// ------------------------------------------------------------------------------------------

float head_scale(int hd) { return static_cast<float>(1.0 / sqrt(static_cast<double>(hd))); }

// D = rowsum(dO o O) into dvec
template <typename T>
int launch_dot(const void* o, const void* dout, void* dvec, long long rows, int hd,
               cudaStream_t stream) {
  const long long blocks = (rows + kThreads / 32 - 1) / (kThreads / 32);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  attn_bwd_dot<T><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const T*>(o), static_cast<const T*>(dout), static_cast<float*>(dvec), rows,
      hd);
  return static_cast<int>(cudaGetLastError());
}

// the CUDA-core kernels (f32)
template <int HD>
int launch(const void* q, const void* k, const void* v, const void* o, const void* lse,
           const void* dout, void* dq, void* dk, void* dv, void* dvec, long long B, long long H,
           long long KV, long long S, int causal, cudaStream_t stream) {
  using C = Cfg<HD>;
  if (H > 65535 || B > 65535) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(attn_bwd_dkdv<HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(C::SMEM));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(attn_bwd_dq<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(C::SMEM));
  if (err != cudaSuccess) return static_cast<int>(err);
  const float scale = head_scale(HD);  // f32(hd**-0.5)
  const float* qp = static_cast<const float*>(q);
  const float* kp = static_cast<const float*>(k);
  const float* vp = static_cast<const float*>(v);
  const float* dop = static_cast<const float*>(dout);
  const float* lp = static_cast<const float*>(lse);
  float* dp = static_cast<float*>(dvec);

  int e = launch_dot<float>(o, dout, dvec, B * H * S, HD, stream);
  if (e != 0) return e;

  const unsigned n_t = static_cast<unsigned>((S + C::BT - 1) / C::BT);
  attn_bwd_dkdv<HD><<<dim3(n_t, static_cast<unsigned>(KV), static_cast<unsigned>(B)), kThreads,
                      C::SMEM, stream>>>(qp, kp, vp, dop, lp, dp, static_cast<float*>(dk),
                                         static_cast<float*>(dv), static_cast<int>(H),
                                         static_cast<int>(KV), static_cast<int>(S), causal,
                                         scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  attn_bwd_dq<HD><<<dim3(n_t, static_cast<unsigned>(H), static_cast<unsigned>(B)), kThreads,
                    C::SMEM, stream>>>(qp, kp, vp, dop, lp, dp, static_cast<float*>(dq),
                                       static_cast<int>(H), static_cast<int>(KV),
                                       static_cast<int>(S), causal, scale);
  return static_cast<int>(cudaGetLastError());
}

// the tensor-core kernels (bf16)
template <int HD>
int launch_tc(const void* q, const void* k, const void* v, const void* o, const void* lse,
              const void* dout, void* dq, void* dk, void* dv, void* dvec, long long B,
              long long H, long long KV, long long S, int causal, cudaStream_t stream) {
  using C = TcCfg<HD>;
  const long long n_kt = (S + C::BKEY - 1) / C::BKEY;
  const long long n_qt = (S + C::BQQ - 1) / C::BQQ;
  if (n_kt * KV * B > 0x7fffffffLL || n_qt * H * B > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(attn_bwd_dkdv_tc<HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(C::SMEM_DKDV));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(attn_bwd_dq_tc<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(C::SMEM_DQ));
  if (err != cudaSuccess) return static_cast<int>(err);
  const float scale = head_scale(HD);
  const float scale_log2 = scale * kLog2e;  // as the forward's bf16 route
  const bf16* qp = static_cast<const bf16*>(q);
  const bf16* kp = static_cast<const bf16*>(k);
  const bf16* vp = static_cast<const bf16*>(v);
  const bf16* dop = static_cast<const bf16*>(dout);
  const float* lp = static_cast<const float*>(lse);
  const float* dp = static_cast<const float*>(dvec);

  int e = launch_dot<bf16>(o, dout, dvec, B * H * S, HD, stream);
  if (e != 0) return e;
  attn_bwd_dkdv_tc<HD><<<static_cast<unsigned>(n_kt * KV * B), kTcThreads, C::SMEM_DKDV,
                         stream>>>(
      qp, kp, vp, dop, lp, dp, static_cast<bf16*>(dk), static_cast<bf16*>(dv),
      static_cast<int>(B), static_cast<int>(H), static_cast<int>(KV), static_cast<int>(S),
      causal, scale, scale_log2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  attn_bwd_dq_tc<HD><<<static_cast<unsigned>(n_qt * H * B), kTcThreads, C::SMEM_DQ, stream>>>(
      qp, kp, vp, dop, lp, dp, static_cast<bf16*>(dq), static_cast<int>(B),
      static_cast<int>(H), static_cast<int>(KV), static_cast<int>(S), static_cast<int>(n_qt),
      causal, scale, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

// the tensor-core kernels at hd 160 and 256 (bf16): dK and dV in sweeps over `slices` head
// slices (their f32 partials in `work` when slices > 1), then dQ
template <int HD>
int launch_tc_sweep(const void* q, const void* k, const void* v, const void* o, const void* lse,
                    const void* dout, void* dq, void* dk, void* dv, void* dvec, void* work,
                    long long B, long long H, long long KV, long long S, long long slices,
                    int causal, cudaStream_t stream) {
  using C = TcCfg<HD>;
  const long long n_kt = (S + C::BKEY - 1) / C::BKEY;
  const long long n_qt = (S + C::BQQ - 1) / C::BQQ;
  const long long n4 = B * KV * S * HD / 4;
  if (slices < 1 || (H / KV) % slices != 0 || (slices > 1 && work == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (2 * n_kt * KV * B * slices > 0x7fffffffLL || n_qt * H * B > 0x7fffffffLL ||
      (n4 + kThreads - 1) / kThreads > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(attn_bwd_dkdv_sweep_tc<HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(C::SMEM_DKDV));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(attn_bwd_dq_tc<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(C::SMEM_DQ));
  if (err != cudaSuccess) return static_cast<int>(err);
  const float scale = head_scale(HD);
  const float scale_log2 = scale * kLog2e;
  const bf16* qp = static_cast<const bf16*>(q);
  const bf16* kp = static_cast<const bf16*>(k);
  const bf16* vp = static_cast<const bf16*>(v);
  const bf16* dop = static_cast<const bf16*>(dout);
  const float* lp = static_cast<const float*>(lse);
  const float* dp = static_cast<const float*>(dvec);
  bf16* dkp = static_cast<bf16*>(dk);
  bf16* dvp = static_cast<bf16*>(dv);
  float* wp = static_cast<float*>(work);

  int e = launch_dot<bf16>(o, dout, dvec, B * H * S, HD, stream);
  if (e != 0) return e;
  attn_bwd_dkdv_sweep_tc<HD><<<static_cast<unsigned>(2 * n_kt * KV * B * slices), kTcThreads,
                               C::SMEM_DKDV, stream>>>(
      qp, kp, vp, dop, lp, dp, dkp, dvp, wp, static_cast<int>(B), static_cast<int>(H),
      static_cast<int>(KV), static_cast<int>(S), static_cast<int>(slices), causal, scale,
      scale_log2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (slices > 1) {
    attn_bwd_dkdv_finish<<<static_cast<unsigned>((n4 + kThreads - 1) / kThreads), kThreads, 0,
                           stream>>>(wp, dkp, dvp, n4, static_cast<int>(slices), scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  attn_bwd_dq_tc<HD><<<static_cast<unsigned>(n_qt * H * B), kTcThreads, C::SMEM_DQ, stream>>>(
      qp, kp, vp, dop, lp, dp, static_cast<bf16*>(dq), static_cast<int>(B),
      static_cast<int>(H), static_cast<int>(KV), static_cast<int>(S), static_cast<int>(n_qt),
      causal, scale, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

// the bf16 route's dK/dV and dQ launches at one head dim: {smem bytes, resident blocks an SM}
// of each into out[0..3]
template <int HD, typename DKDV>
int occupancy_tc(DKDV dkdv, int* out) {
  using C = TcCfg<HD>;
  cudaError_t err = cudaFuncSetAttribute(dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(C::SMEM_DKDV));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(attn_bwd_dq_tc<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(C::SMEM_DQ));
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(out + 1, dkdv, kTcThreads,
                                                        C::SMEM_DKDV);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(out + 3, attn_bwd_dq_tc<HD>, kTcThreads,
                                                        C::SMEM_DQ);
  out[0] = static_cast<int>(C::SMEM_DKDV);
  out[2] = static_cast<int>(C::SMEM_DQ);
  return static_cast<int>(err);
}

bool bad_sizes(long long H, long long KV) { return KV <= 0 || H % KV != 0; }

}  // namespace

// Plain C interface, loaded with ctypes.  q/o/dout/dq: (B,H,S,hd); k/v/dk/dv: (B,KV,S,hd); one
// dtype for all ten, contiguous (the wrapper checks); lse: the forward's f32 (B,H,S) row
// log-sum-exp; dvec: f32 (B,H,S) scratch for D.  hd in {16, 32, 64, 128, 160, 256}.  slices
// and work: the bf16 route's head slices at hd 160 and 256 (a divisor of H / KV) and, when
// slices > 1, f32 (slices, 2, B, KV, S, hd) scratch for their partials; read nowhere else.
// Returns a cudaError_t.
extern "C" {

int flash_attention_bwd_f32(const void* q, const void* k, const void* v, const void* o,
                            const void* lse, const void* dout, void* dq, void* dk, void* dv,
                            void* dvec, void* work, long long B, long long H, long long KV,
                            long long S, long long hd, long long slices, int causal,
                            void* stream) {
  if (B <= 0 || S <= 0 || H <= 0) return static_cast<int>(cudaSuccess);
  if (bad_sizes(H, KV)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16: return launch<16>(q, k, v, o, lse, dout, dq, dk, dv, dvec, B, H, KV, S, causal, st);
    case 32: return launch<32>(q, k, v, o, lse, dout, dq, dk, dv, dvec, B, H, KV, S, causal, st);
    case 64: return launch<64>(q, k, v, o, lse, dout, dq, dk, dv, dvec, B, H, KV, S, causal, st);
    case 128:
      return launch<128>(q, k, v, o, lse, dout, dq, dk, dv, dvec, B, H, KV, S, causal, st);
    case 160:
      return launch<160>(q, k, v, o, lse, dout, dq, dk, dv, dvec, B, H, KV, S, causal, st);
    case 256:
      return launch<256>(q, k, v, o, lse, dout, dq, dk, dv, dvec, B, H, KV, S, causal, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// the route table: the tensor cores at every head dim, dK and dV in head-slice sweeps at hd
// 160 and 256
int flash_attention_bwd_bf16(const void* q, const void* k, const void* v, const void* o,
                             const void* lse, const void* dout, void* dq, void* dk, void* dv,
                             void* dvec, void* work, long long B, long long H, long long KV,
                             long long S, long long hd, long long slices, int causal,
                             void* stream) {
  if (B <= 0 || S <= 0 || H <= 0) return static_cast<int>(cudaSuccess);
  if (bad_sizes(H, KV)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16: return launch_tc<16>(q, k, v, o, lse, dout, dq, dk, dv, dvec, B, H, KV, S, causal, st);
    case 32: return launch_tc<32>(q, k, v, o, lse, dout, dq, dk, dv, dvec, B, H, KV, S, causal, st);
    case 64: return launch_tc<64>(q, k, v, o, lse, dout, dq, dk, dv, dvec, B, H, KV, S, causal, st);
    case 128:
      return launch_tc<128>(q, k, v, o, lse, dout, dq, dk, dv, dvec, B, H, KV, S, causal, st);
    case 160:
      return launch_tc_sweep<160>(q, k, v, o, lse, dout, dq, dk, dv, dvec, work, B, H, KV, S,
                                  slices, causal, st);
    case 256:
      return launch_tc_sweep<256>(q, k, v, o, lse, dout, dq, dk, dv, dvec, work, B, H, KV, S,
                                  slices, causal, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

int flash_attention_bwd_bf16_occupancy(long long hd, void* out) {
  int* const o = static_cast<int*>(out);
  switch (hd) {
    case 16: return occupancy_tc<16>(attn_bwd_dkdv_tc<16>, o);
    case 32: return occupancy_tc<32>(attn_bwd_dkdv_tc<32>, o);
    case 64: return occupancy_tc<64>(attn_bwd_dkdv_tc<64>, o);
    case 128: return occupancy_tc<128>(attn_bwd_dkdv_tc<128>, o);
    case 160: return occupancy_tc<160>(attn_bwd_dkdv_sweep_tc<160>, o);
    case 256: return occupancy_tc<256>(attn_bwd_dkdv_sweep_tc<256>, o);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
