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
// and the final S is stored in f32 (B,H,P,N).  All sums are f32, as `_ssd_kernel` casts.
//
// What bounds it: at mamba2's serve shape (B 8, S 2048, H 32, P 64, N 128, Q 256) the function
// does about 2.6e10 FLOPs on 1.5e8 bytes of input and output, about 170 per byte: just under the
// bf16 tensor cores' balance point (295), so bytes bound it, and only if the products run on the
// tensor cores; on the CUDA cores (67 TFLOP/s) the operations would.
//
// Two routes:
//
// bf16 (`ssd_scan_bf16`, the serving path): Mamba-2's chunked decomposition (arXiv:2405.21060
// §6) on the tensor cores, three launches on the caller's stream behind one call:
//   1. chunk states, parallel over ((b, chunk), pair of heads, 128 state columns):
//      s_c = xdt^T (B o decay), a (P, N) f32 tile per (b, h, chunk), into the first half of the
//      caller's workspace;
//   2. state passing, parallel over (b, h, P*N): S_c = exp(cums_last,c) S_{c-1} + s_c in f32,
//      nc small steps a thread; the state entering each chunk goes to the second half of the
//      workspace as bf16 hi + lo (the next step's operand layout), the last state is the output;
//   3. chunk scan, parallel over (64-row tile, block of 8 heads, (b, chunk)): G = C B^T for the
//      tile's rows and the keys at or below them is formed once for the block's heads (the heads
//      share one B/C group) and kept in shared memory; then per head
//      y = (G o L_h) xdt_h + exp(cums) o (C S_{c-1}^T), stored once in xdt's dtype, while the
//      next xdt tile, or the next head's S, cums and first tile, are in flight.
// Every product is mma.sync m16n8k16 with f32 accumulation.  C B^T has two bf16 operands and is
// exact.  The other three have one f32 operand (G o L, the decayed xdt, S), which is split into
// bf16 hi + lo (hi = bf16(v), lo = bf16(v - hi)) and multiplied in two products against the exact
// bf16 operand: v is carried to a relative 2^-16, against TF32's 2^-11, for twice the mma count
// (tests/test_torch_ssd_scan.py emulates the split on the CPU and holds it to the reference).
// Tiles reach shared memory by cp.async, in two stages where a loop streams them, rows padded by
// 16 bytes so ldmatrix is free of bank conflicts; the bands with the most key tiles launch first.
// N must be a multiple of 16 (the mma depth); sizes whose tiles exceed a block's shared memory
// are refused.
//
// f32 (`ssd_scan_f32`, the path that matches the reference closely, as the f32 serving agreement
// runs it): CUDA cores.  One 256-thread block per (b, h) walks the chunks in sequence with S in
// shared memory (32 KiB at P=64, N=128); the (Q,Q) matrix C B^T o L is formed 64x64 tile by tile
// (fmaf products, each thread a 4x4 micro-tile), masked, decayed and multiplied into the tile's
// y accumulator in registers; the state update follows the chunk's y tiles.  Rows are padded by
// one float.  Shared memory: (P + 2*64)(N+1) + 64(P+1) + 64*65 + Q floats (130 KiB at mamba2's
// shapes); above 227 KiB the launch is refused.
//
// The kernels allocate nothing and never synchronise; they run on the caller's stream.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tc_sm90.cuh"

namespace {

// ------------------------------------------------------------------------------------------
// f32 route: CUDA cores
// ------------------------------------------------------------------------------------------

constexpr int kThreads = 256;    // 16 x 16: ty picks rows, tx picks columns
constexpr int kT = 64;           // rows per tile of C, B and xdt
constexpr int kLdG = kT + 1;

size_t smem_bytes_f32(int P, int N, int Q) {
  return sizeof(float) * (static_cast<size_t>(P + 2 * kT) * (N + 1) +
                          static_cast<size_t>(kT) * (P + 1) + kT * kLdG + Q);
}

// rows [r0, r0+64) of a (Q, W) row-major chunk, as f32 with row stride ld, row r0+r scaled by
// `scale[r]` when given; rows at or past Q are zero.
__device__ __forceinline__ void load_rows(float* dst, int ld, const float* __restrict__ src,
                                          int r0, int Q, int W, const float* scale) {
  for (int idx = threadIdx.x; idx < kT * W; idx += kThreads) {
    const int r = idx / W, c = idx % W;
    const int row = r0 + r;
    float val = 0.f;
    if (row < Q) {
      val = src[static_cast<long long>(row) * W + c];
      if (scale) val *= scale[r];
    }
    dst[r * ld + c] = val;
  }
}

template <int P>
__global__ void __launch_bounds__(kThreads)
ssd_scan_f32_kernel(const float* __restrict__ xdt, const float* __restrict__ Bm,
                    const float* __restrict__ Cm, const float* __restrict__ cums,
                    float* __restrict__ y, float* __restrict__ state, int H, int nc,
                    int Q, int N) {
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
    const float* xc = xdt + bhc * Q * P;
    const float* Bc = Bm + bc * Q * N;
    const float* Cc = Cm + bc * Q * N;
    float* yc = y + bhc * Q * P;

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
          yc[static_cast<long long>(gi) * P + tx + 16 * p] = acc[a][p];
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

template <int P>
int launch_f32(const void* xdt, const void* Bm, const void* Cm, const void* cums, void* y,
             void* state, long long B, long long H, long long nc, long long Q, long long N,
             cudaStream_t stream) {
  const size_t smem = smem_bytes_f32(static_cast<int>(P), static_cast<int>(N), static_cast<int>(Q));
  // the only check of this limit (227 KiB, a block's opt-in maximum on H100): the wrapper
  // reports cudaErrorInvalidValue as sizes the kernel does not take
  if (smem > 232448) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(ssd_scan_f32_kernel<P>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(H), static_cast<unsigned>(B));
  ssd_scan_f32_kernel<P><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(xdt), static_cast<const float*>(Bm),
      static_cast<const float*>(Cm), static_cast<const float*>(cums), static_cast<float*>(y),
      static_cast<float*>(state), static_cast<int>(H), static_cast<int>(nc),
      static_cast<int>(Q), static_cast<int>(N));
  return static_cast<int>(cudaGetLastError());
}


// ------------------------------------------------------------------------------------------
// bf16 route: tensor cores (mma.sync m16n8k16, f32 accumulation)
// ------------------------------------------------------------------------------------------

using tc::bf16;

constexpr int kRT = 64;              // chunk positions in a tile
constexpr int kStateThreads = 256;   // chunk states: 8 warps, 4 a head
constexpr int kStateHeads = 2;       // heads of a chunk-state block (they share its B tiles)
constexpr int kSlab = 128;           // state columns of a chunk-state block
constexpr int kScanThreads = 256;    // chunk scan: 8 warps, 4 row groups x 2 halves
constexpr int kHeadBlock = 8;        // heads that share one G band in the chunk scan
constexpr float kLog2e = 1.4426950408889634f;
constexpr size_t kMaxSmem = 232448;  // a block's opt-in maximum on H100 (227 KiB)

// 1. Chunk states: own[b,h,c] = xdt^T (B o exp(last - cums)), (P, N) f32.  The decay goes on
// xdt (f32 after it), split into bf16 hi + lo; both multiply the exact bf16 B.  One block per
// (128 state columns, pair of heads, (b, chunk)): the heads share each B tile, four warps a head,
// each warp a 16-row group of P (two at P = 128) across the 128 columns.  Chunk positions come
// in tiles of 64, the next tile's B and raw xdt in flight (cp.async) while this one is decayed,
// split and multiplied.
template <int P>
__global__ void __launch_bounds__(kStateThreads)
ssd_chunk_state_kernel(const bf16* __restrict__ xdt, const bf16* __restrict__ Bm,
                       const float* __restrict__ cums, float* __restrict__ own, int H, int nc,
                       int Q, int N) {
  constexpr int LDX = P + 8;
  constexpr int LDB = kSlab + 8;
  constexpr int MG = P / 16;          // 16-row groups of a head's (P, 128) output
  constexpr int MW = (MG + 3) / 4;    // groups a warp
  constexpr int NT = kSlab / 8;
  constexpr int XT = kRT * LDX;       // elements of one xdt tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* const bs = reinterpret_cast<bf16*>(smem_raw);            // two B tiles (64, 128)
  bf16* const xr = bs + 2 * kRT * LDB;                           // raw xdt [head][stage]
  bf16* const xh = xr + 2 * kStateHeads * XT;                    // decayed xdt [head]: hi
  bf16* const xl = xh + kStateHeads * XT;                        // and lo
  float* const cs = reinterpret_cast<float*>(xl + kStateHeads * XT);   // [head][Q] cums

  const int n0 = blockIdx.x * kSlab, h0 = blockIdx.y * kStateHeads, bc = blockIdx.z;
  const int nh = min(kStateHeads, H - h0);
  const int b = bc / nc, c = bc - b * nc;
  const long long bhc0 = (static_cast<long long>(b) * H + h0) * nc + c;   // head h0 + k: + k nc
  const bf16* Bc = Bm + static_cast<long long>(bc) * Q * N;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int hw = warp >> 2, wq = warp & 3;   // the warp's head in the pair, its group
  const int g = lane >> 2, t = lane & 3;
  const int xa_off = tc::frag_bt_row(lane) * LDX + tc::frag_bt_col(lane);
  const int bb_off = tc::frag_a_row(lane) * LDB + tc::frag_a_col(lane);

  // B rows q0.., columns n0..n0+127, and each head's raw xdt rows q0..
  auto prefetch = [=](int q0, int buf) {
    for (int idx = threadIdx.x; idx < kRT * (kSlab / 8); idx += kStateThreads) {
      const int r = idx / (kSlab / 8), ch = idx - r * (kSlab / 8);
      const int row = q0 + r, col = n0 + ch * 8;
      const bool ok = row < Q && col < N;
      tc::cp_async16(bs + buf * kRT * LDB + r * LDB + ch * 8,
                     Bc + (ok ? static_cast<long long>(row) * N + col : 0), ok);
    }
    for (int k = 0; k < nh; ++k)
      tc::load_rows_async(xr + (2 * k + buf) * XT, LDX, xdt + (bhc0 + k * nc) * Q * P, q0, kRT,
                          Q, P);
  };

  for (int k = 0; k < nh; ++k)
    for (int i = threadIdx.x; i < Q; i += kStateThreads)
      tc::cp_async4(cs + k * Q + i, cums + (bhc0 + k * nc) * Q + i, true);
  prefetch(0, 0);
  tc::cp_async_commit();

  float acc[MW][NT][4];
#pragma unroll
  for (int mi = 0; mi < MW; ++mi)
#pragma unroll
    for (int j = 0; j < NT; ++j)
      acc[mi][j][0] = acc[mi][j][1] = acc[mi][j][2] = acc[mi][j][3] = 0.f;

  const int n_qt = (Q + kRT - 1) / kRT;
  for (int qt = 0; qt < n_qt; ++qt) {
    if (qt + 1 < n_qt) prefetch((qt + 1) * kRT, (qt + 1) & 1);
    tc::cp_async_commit();
    tc::cp_async_wait<1>();                // tile qt (and cums) has landed
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kStateHeads * kRT * (P / 2) / kStateThreads; ++i) {   // unrolled
      const int idx = threadIdx.x + i * kStateThreads;
      const int k = idx / (kRT * (P / 2)), rc = idx - k * (kRT * (P / 2));
      const int r = rc / (P / 2), cp = rc - r * (P / 2);
      const int row = qt * kRT + r;
      if (k < nh) {
        const float* ck = cs + k * Q;
        const float d = row < Q ? tc::ex2((ck[Q - 1] - ck[row]) * kLog2e) : 0.f;
        const float2 xv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
            xr + (2 * k + (qt & 1)) * XT + r * LDX + 2 * cp));
        uint32_t hi, lo;
        tc::split_bf16(xv.x * d, xv.y * d, hi, lo);
        *reinterpret_cast<uint32_t*>(xh + k * XT + r * LDX + 2 * cp) = hi;
        *reinterpret_cast<uint32_t*>(xl + k * XT + r * LDX + 2 * cp) = lo;
      }
    }
    __syncthreads();                       // the decayed tiles are complete

    if (hw < nh) {
      const bf16* bt = bs + (qt & 1) * kRT * LDB;
      const bf16* xhk = xh + hw * XT;
      const bf16* xlk = xl + hw * XT;
#pragma unroll
      for (int kk = 0; kk < kRT / 16; ++kk) {
        uint32_t ah[MW][4], al[MW][4];
#pragma unroll
        for (int mi = 0; mi < MW; ++mi) {
          if (wq + 4 * mi < MG) {          // A = (decayed xdt)^T: ldmatrix.trans of [q][p]
            const int off = xa_off + kk * 16 * LDX + (wq + 4 * mi) * 16;
            tc::ldsm_x4_t(ah[mi], xhk + off);
            tc::ldsm_x4_t(al[mi], xlk + off);
          }
        }
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          if (n0 + np * 16 >= N) break;    // columns past N
          uint32_t bb[4];                  // B stored [q][n]
          tc::ldsm_x4_t(bb, bt + bb_off + kk * 16 * LDB + np * 16);
#pragma unroll
          for (int mi = 0; mi < MW; ++mi) {
            if (wq + 4 * mi < MG) {
              tc::mma_bf16(acc[mi][2 * np], ah[mi], bb[0], bb[1]);
              tc::mma_bf16(acc[mi][2 * np + 1], ah[mi], bb[2], bb[3]);
              tc::mma_bf16(acc[mi][2 * np], al[mi], bb[0], bb[1]);
              tc::mma_bf16(acc[mi][2 * np + 1], al[mi], bb[2], bb[3]);
            }
          }
        }
      }
    }
    __syncthreads();                       // this stage and the split tiles are free
  }

  if (hw >= nh) return;
  float* wk = own + (bhc0 + hw * nc) * P * N;
#pragma unroll
  for (int mi = 0; mi < MW; ++mi) {
    if (wq + 4 * mi >= MG) continue;
    const int p = (wq + 4 * mi) * 16 + g;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int col = n0 + j * 8 + 2 * t;
      if (col >= N) continue;
      *reinterpret_cast<float2*>(wk + static_cast<long long>(p) * N + col) =
          make_float2(acc[mi][j][0], acc[mi][j][1]);
      *reinterpret_cast<float2*>(wk + static_cast<long long>(p + 8) * N + col) =
          make_float2(acc[mi][j][2], acc[mi][j][3]);
    }
  }
}

size_t state_smem_bytes(int P, int Q) {
  return sizeof(bf16) * (2 * kRT * (kSlab + 8) + 4 * kStateHeads * kRT * (P + 8)) +
         sizeof(float) * kStateHeads * Q;
}

// 2. State passing: per (b, h) and two state entries a thread, in chunk order, carry
// S = exp(cums_last,c) S + own_c in f32, and write the state entering each chunk c >= 1 as bf16
// hi (rows 0..P) and lo (rows P..2P), the operand layout of the chunk scan; the last S is the
// output.  The own states of eight chunks are loaded before any is used.
__global__ void __launch_bounds__(256)
ssd_state_pass_kernel(const float* __restrict__ own, bf16* __restrict__ entering,
                      float* __restrict__ state, const float* __restrict__ cums, int H, int nc,
                      int Q, int PN) {
  const int e = 2 * (blockIdx.x * blockDim.x + threadIdx.x);
  if (e >= PN) return;
  const long long bh = static_cast<long long>(blockIdx.z) * H + blockIdx.y;
  float s0 = 0.f, s1 = 0.f;
  for (int c0 = 0; c0 < nc; c0 += 8) {
    float2 v[8];
    float d[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      if (c0 + u < nc) {
        const long long bhc = bh * nc + c0 + u;
        v[u] = *reinterpret_cast<const float2*>(own + bhc * PN + e);
        d[u] = expf(cums[bhc * Q + Q - 1]);
      }
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int c = c0 + u;
      if (c >= nc) break;
      if (c > 0) {
        uint32_t hi, lo;
        tc::split_bf16(s0, s1, hi, lo);
        bf16* en = entering + (bh * nc + c) * 2 * PN + e;
        *reinterpret_cast<uint32_t*>(en) = hi;
        *reinterpret_cast<uint32_t*>(en + PN) = lo;
      }
      s0 = d[u] * s0 + v[u].x;
      s1 = d[u] * s1 + v[u].y;
    }
  }
  *reinterpret_cast<float2*>(state + bh * PN + e) = make_float2(s0, s1);
}

// shared memory of the chunk scan: C tile, G band, two S buffers (phase 1's B tiles in the
// second), two xdt tiles, two cums rows, the halves' partial y
size_t scan_smem_bytes(int P, int N, int Q) {
  const size_t Qp = static_cast<size_t>((Q + kRT - 1) / kRT) * kRT;
  const size_t ldn = static_cast<size_t>(N) + 8;
  const size_t srows = 2 * static_cast<size_t>(P > kRT ? P : kRT);
  return sizeof(bf16) * kRT * ldn + sizeof(float) * kRT * (Qp + 8) +
         sizeof(bf16) * 2 * srows * ldn + sizeof(bf16) * 2 * kRT * (P + 8) +
         sizeof(float) * 2 * Qp + sizeof(float) * kRT * (P + 8);
}

// 3. Chunk scan: one block per (64-row tile i, block of heads, (b, chunk)); warp w owns rows
// i0 + 16 (w % 4) .. +15 and half w / 4 of the keys of G (phase 1) and of the sums of y
// (phase 2: two of each key tile's four 16-key steps, half of C S^T's depth), so two warps share
// each scheduler; the second half's partial y is added through shared memory.  G = C_i B_j^T for
// the key tiles j <= i is formed once and kept in shared memory (the two warps of a row group
// write and read only its rows); then for each head
// y_i = exp(cums_i) o (C_i S^T) + sum_j (G_ij o L_ij) xdt_j.  Loads run one step ahead: the next
// xdt tile, or at a head's last tile the next head's S, cums and first xdt tile.
template <int P>
__global__ void __launch_bounds__(kScanThreads)
ssd_chunk_scan_kernel(const bf16* __restrict__ xdt, const bf16* __restrict__ Bm,
                      const bf16* __restrict__ Cm, const float* __restrict__ cums,
                      const bf16* __restrict__ entering, bf16* __restrict__ y, int H, int nc,
                      int Q, int N) {
  constexpr int LDX = P + 8;
  constexpr int PT = P / 8;
  constexpr int SROWS = 2 * (P > kRT ? P : kRT);
  const int n_rt = gridDim.x;
  const int it = n_rt - 1 - blockIdx.x;    // the longest bands first
  const int i0 = it * kRT;
  const int Qp = n_rt * kRT;
  const int LDN = N + 8, LDG = i0 + kRT + 8;
  const int h_begin = blockIdx.y * kHeadBlock, nh = min(H - h_begin, kHeadBlock);
  const int bc = blockIdx.z, b = bc / nc, c = bc - b * nc;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* const Cs = reinterpret_cast<bf16*>(smem_raw);              // (64, N) rows of C
  float* const Gs = reinterpret_cast<float*>(Cs + kRT * LDN);      // (64, i0 + 64) band of G
  bf16* const Sb = reinterpret_cast<bf16*>(Gs + kRT * (Qp + 8));   // two S hi + lo buffers
  bf16* const R2 = Sb + 2 * SROWS * LDN;                           // two xdt tiles
  float* const csb = reinterpret_cast<float*>(R2 + 2 * kRT * LDX); // two (Qp,) cums rows
  float* const red = csb + 2 * Qp;                                 // (64, P) partial y

  const bf16* Cc = Cm + static_cast<long long>(bc) * Q * N;
  const bf16* Bc = Bm + static_cast<long long>(bc) * Q * N;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rg = warp & 3, half = warp >> 2;   // row group, half of the keys
  const int g = lane >> 2, t = lane & 3;
  const int wrow = i0 + rg * 16;
  const int r0 = wrow + g, r1 = r0 + 8;
  const int nk = N / 16, kh = (nk + 1) / 2;     // C S^T's depth steps: [0, kh) and [kh, nk)
  const int kk0 = half ? kh : 0, kk1 = half ? nk : kh;
  float* const rrow = red + (rg * 16 + g) * (P + 8) + 2 * t;   // row r0; r1 at + 8 (P + 8)
  const int ca_off = (rg * 16 + tc::frag_a_row(lane)) * LDN + tc::frag_a_col(lane);
  const int bt_off = tc::frag_bt_row(lane) * LDN + tc::frag_bt_col(lane);
  const int xb_off = tc::frag_a_row(lane) * LDX + tc::frag_a_col(lane);
  float* const grow = Gs + (rg * 16 + g) * LDG + 2 * t;   // row r0; r1 at + 8 LDG

  auto bhc_of = [=](int k) {
    return (static_cast<long long>(b) * H + h_begin + k) * nc + c;
  };
  auto prefetch_head = [=](int k) {      // head k's S (c > 0), cums and first xdt tile
    const long long bhc = bhc_of(k);
    if (c > 0)
      tc::load_rows_async(Sb + (k & 1) * SROWS * LDN, LDN, entering + bhc * 2 * P * N, 0,
                          2 * P, 2 * P, N);
    float* cs = csb + (k & 1) * Qp;
    for (int i = threadIdx.x; i < Qp; i += kScanThreads)
      tc::cp_async4(cs + i, cums + bhc * Q + (i < Q ? i : 0), i < Q);
    tc::load_rows_async(R2 + ((k * (it + 1)) & 1) * kRT * LDX, LDX, xdt + bhc * Q * P, 0, kRT,
                        Q, P);
  };

  // -- G band, shared by the block's heads (B tiles in the second S buffer) -----------------
  bf16* const Bt = Sb + SROWS * LDN;
  tc::load_rows_async(Cs, LDN, Cc, i0, kRT, Q, N);
  tc::load_rows_async(Bt, LDN, Bc, 0, kRT, Q, N);
  tc::cp_async_commit();
  prefetch_head(0);
  tc::cp_async_commit();
  for (int jt = 0; jt <= it; ++jt) {
    if (jt < it)
      tc::load_rows_async(Bt + ((jt + 1) & 1) * kRT * LDN, LDN, Bc, (jt + 1) * kRT, kRT, Q, N);
    tc::cp_async_commit();
    tc::cp_async_wait<1>();                // tile jt, C and head 0's loads have landed
    __syncthreads();
    const bf16* Bs = Bt + (jt & 1) * kRT * LDN + half * 32 * LDN;   // this half's 32 keys
    float ga[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) ga[j][0] = ga[j][1] = ga[j][2] = ga[j][3] = 0.f;
    for (int kk = 0; kk < N / 16; ++kk) {
      uint32_t a[4];
      tc::ldsm_x4(a, Cs + ca_off + kk * 16);
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t bb[4];                    // B stored [j][n]: the n-major operand of C B^T
        tc::ldsm_x4(bb, Bs + bt_off + np * 16 * LDN + kk * 16);
        tc::mma_bf16(ga[2 * np], a, bb[0], bb[1]);
        tc::mma_bf16(ga[2 * np + 1], a, bb[2], bb[3]);
      }
    }
    float* gt = grow + jt * kRT + half * 32;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      *reinterpret_cast<float2*>(gt + j * 8) = make_float2(ga[j][0], ga[j][1]);
      *reinterpret_cast<float2*>(gt + 8 * LDG + j * 8) = make_float2(ga[j][2], ga[j][3]);
    }
    __syncthreads();                       // every warp is done with this B tile
  }

  // -- per head ----------------------------------------------------------------------------
  for (int k = 0; k < nh; ++k) {
    const long long bhc = bhc_of(k);
    const bf16* xc = xdt + bhc * Q * P;
    const float* cs = csb + (k & 1) * Qp;
    const bf16* Sk = Sb + (k & 1) * SROWS * LDN;
    float acc[PT][4];
#pragma unroll
    for (int j = 0; j < PT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
    float c0 = 0.f, c1 = 0.f;
    for (int jt = 0; jt <= it; ++jt) {
      const int f = k * (it + 1) + jt;     // the xdt tile's place in the block's sequence
      if (jt < it)
        tc::load_rows_async(R2 + ((f + 1) & 1) * kRT * LDX, LDX, xc, (jt + 1) * kRT, kRT, Q, P);
      else if (k + 1 < nh)
        prefetch_head(k + 1);
      tc::cp_async_commit();
      tc::cp_async_wait<1>();              // this step's tile (and the head's S, cums) landed
      __syncthreads();
      if (jt == 0) {
        c0 = cs[r0];
        c1 = cs[r1];
        if (c > 0) {                       // exp(cums_i) (C_i S^T), this half's depth
          for (int kk = kk0; kk < kk1; ++kk) {
            uint32_t a[4];
            tc::ldsm_x4(a, Cs + ca_off + kk * 16);
#pragma unroll
            for (int np = 0; np < P / 16; ++np) {
              uint32_t bh[4], bl[4];       // S stored [p][n]: the n-major operand of C S^T
              const bf16* sp = Sk + bt_off + np * 16 * LDN + kk * 16;
              tc::ldsm_x4(bh, sp);
              tc::ldsm_x4(bl, sp + P * LDN);
              tc::mma_bf16(acc[2 * np], a, bh[0], bh[1]);
              tc::mma_bf16(acc[2 * np + 1], a, bh[2], bh[3]);
              tc::mma_bf16(acc[2 * np], a, bl[0], bl[1]);
              tc::mma_bf16(acc[2 * np + 1], a, bl[2], bl[3]);
            }
          }
          const float e0 = expf(c0), e1 = expf(c1);
#pragma unroll
          for (int j = 0; j < PT; ++j) {
            acc[j][0] *= e0;
            acc[j][1] *= e0;
            acc[j][2] *= e1;
            acc[j][3] *= e1;
          }
        }
      }

      // (G o L) xdt over this half's two 16-key steps of the tile.  The A fragments (G o L,
      // split) come first, as independent work: regs 0/2 row r0, 1/3 row r1; 0/1 keys +2t,
      // 2/3 keys +8+2t.  Only the diagonal tile is masked (elsewhere every key precedes every
      // row and lies below Q).
      const bf16* Xs = R2 + (f & 1) * kRT * LDX;
      const bool diag = jt == it;
      uint32_t ah[2][4], al[2][4];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int kb = jt * kRT + (2 * half + u) * 16;   // the step's first key
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int j = kb + (r >> 1) * 8 + 2 * t;
          const float crow = (r & 1) ? c1 : c0;
          const float2 gv =
              *reinterpret_cast<const float2*>(grow + (r & 1) * 8 * LDG + kb + (r >> 1) * 8);
          const float2 cj = *reinterpret_cast<const float2*>(cs + j);
          float v0 = gv.x * tc::ex2((crow - cj.x) * kLog2e);
          float v1 = gv.y * tc::ex2((crow - cj.y) * kLog2e);
          if (diag) {
            const int row = (r & 1) ? r1 : r0;
            if (j > row || j >= Q) v0 = 0.f;
            if (j + 1 > row || j + 1 >= Q) v1 = 0.f;
          }
          tc::split_bf16(v0, v1, ah[u][r], al[u][r]);
        }
      }
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int kk = 2 * half + u;
        if (jt * kRT + kk * 16 > wrow + 15) continue;   // every key lies above the warp's rows
#pragma unroll
        for (int np = 0; np < P / 16; ++np) {
          uint32_t bb[4];                  // xdt stored [j][p]
          tc::ldsm_x4_t(bb, Xs + xb_off + kk * 16 * LDX + np * 16);
          tc::mma_bf16(acc[2 * np], ah[u], bb[0], bb[1]);
          tc::mma_bf16(acc[2 * np + 1], ah[u], bb[2], bb[3]);
          tc::mma_bf16(acc[2 * np], al[u], bb[0], bb[1]);
          tc::mma_bf16(acc[2 * np + 1], al[u], bb[2], bb[3]);
        }
      }
      if (diag && half) {                  // the second half's partial y, for the first
#pragma unroll
        for (int j = 0; j < PT; ++j) {
          *reinterpret_cast<float2*>(rrow + j * 8) = make_float2(acc[j][0], acc[j][1]);
          *reinterpret_cast<float2*>(rrow + 8 * (P + 8) + j * 8) =
              make_float2(acc[j][2], acc[j][3]);
        }
      }
      __syncthreads();                     // every warp is done with this step's buffers
    }

    if (half) continue;                    // the first half adds the partial sums and stores
    bf16* yc = y + bhc * Q * P;
#pragma unroll
    for (int j = 0; j < PT; ++j) {
      const int col = j * 8 + 2 * t;
      const float2 p0 = *reinterpret_cast<const float2*>(rrow + j * 8);
      const float2 p1 = *reinterpret_cast<const float2*>(rrow + 8 * (P + 8) + j * 8);
      if (r0 < Q)
        *reinterpret_cast<uint32_t*>(yc + static_cast<long long>(r0) * P + col) =
            tc::pack_bf16(acc[j][0] + p0.x, acc[j][1] + p0.y);
      if (r1 < Q)
        *reinterpret_cast<uint32_t*>(yc + static_cast<long long>(r1) * P + col) =
            tc::pack_bf16(acc[j][2] + p1.x, acc[j][3] + p1.y);
    }
  }
}

template <int P>
int launch_bf16(const void* xdt, const void* Bm, const void* Cm, const void* cums, void* y,
                void* state, void* work, long long B, long long H, long long nc, long long Q,
                long long N, cudaStream_t stream) {
  if (N % 16 != 0 || B * nc > 65535 || H > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = scan_smem_bytes(static_cast<int>(P), static_cast<int>(N),
                                      static_cast<int>(Q));
  const size_t smem_a = state_smem_bytes(static_cast<int>(P), static_cast<int>(Q));
  if (smem > kMaxSmem || smem_a > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(ssd_chunk_scan_kernel<P>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(ssd_chunk_state_kernel<P>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem_a));
  if (err != cudaSuccess) return static_cast<int>(err);
  const bf16* x = static_cast<const bf16*>(xdt);
  const bf16* Bb = static_cast<const bf16*>(Bm);
  const float* cu = static_cast<const float*>(cums);
  // the workspace: the chunks' own states (f32), then the states entering them (bf16 hi, lo)
  float* own = static_cast<float*>(work);
  bf16* entering = reinterpret_cast<bf16*>(own + B * H * nc * P * N);
  const int h = static_cast<int>(H), n = static_cast<int>(nc), q = static_cast<int>(Q),
            nn = static_cast<int>(N);
  ssd_chunk_state_kernel<P><<<dim3(static_cast<unsigned>((N + kSlab - 1) / kSlab),
                                   static_cast<unsigned>((H + kStateHeads - 1) / kStateHeads),
                                   static_cast<unsigned>(B * nc)),
                              kStateThreads, smem_a, stream>>>(x, Bb, cu, own, h, n, q, nn);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int PN = static_cast<int>(P * N);
  ssd_state_pass_kernel<<<dim3(static_cast<unsigned>((PN / 2 + 255) / 256), h,
                               static_cast<unsigned>(B)),
                          256, 0, stream>>>(own, entering, static_cast<float*>(state), cu, h, n,
                                            q, PN);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_chunk_scan_kernel<P><<<dim3(static_cast<unsigned>((Q + kRT - 1) / kRT),
                                  static_cast<unsigned>((H + kHeadBlock - 1) / kHeadBlock),
                                  static_cast<unsigned>(B * nc)),
                             kScanThreads, smem, stream>>>(
      x, Bb, static_cast<const bf16*>(Cm), cu, entering, static_cast<bf16*>(y), h, n, q, nn);
  return static_cast<int>(cudaGetLastError());
}

bool bad_sizes(long long B, long long nc, long long Q, long long N) {
  return nc <= 0 || Q <= 0 || N <= 0 || B > 65535;
}

}  // namespace

// Plain C interface, loaded with ctypes.  xdt/y: (B,H,nc,Q,P); Bm/Cm: (B,nc,Q,N), in one dtype;
// cums: (B,H,nc,Q) f32; state: (B,H,P,N) f32; all contiguous (the wrapper checks).  The bf16
// route also takes `work`, an f32 workspace of 2*B*H*nc*P*N elements that the caller allocates.
// P in {16, 32, 64, 128}.  Returns a cudaError_t.
extern "C" {

int ssd_scan_f32(const void* xdt, const void* Bm, const void* Cm, const void* cums, void* y,
                 void* state, long long B, long long H, long long nc, long long Q, long long P,
                 long long N, void* stream) {
  if (B <= 0 || H <= 0) return static_cast<int>(cudaSuccess);
  if (bad_sizes(B, nc, Q, N)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (P) {
    case 16: return launch_f32<16>(xdt, Bm, Cm, cums, y, state, B, H, nc, Q, N, st);
    case 32: return launch_f32<32>(xdt, Bm, Cm, cums, y, state, B, H, nc, Q, N, st);
    case 64: return launch_f32<64>(xdt, Bm, Cm, cums, y, state, B, H, nc, Q, N, st);
    case 128: return launch_f32<128>(xdt, Bm, Cm, cums, y, state, B, H, nc, Q, N, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

int ssd_scan_bf16(const void* xdt, const void* Bm, const void* Cm, const void* cums, void* y,
                  void* state, void* work, long long B, long long H, long long nc, long long Q,
                  long long P, long long N, void* stream) {
  if (B <= 0 || H <= 0) return static_cast<int>(cudaSuccess);
  if (bad_sizes(B, nc, Q, N)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (P) {
    case 16: return launch_bf16<16>(xdt, Bm, Cm, cums, y, state, work, B, H, nc, Q, N, st);
    case 32: return launch_bf16<32>(xdt, Bm, Cm, cums, y, state, work, B, H, nc, Q, N, st);
    case 64: return launch_bf16<64>(xdt, Bm, Cm, cums, y, state, work, B, H, nc, Q, N, st);
    case 128: return launch_bf16<128>(xdt, Bm, Cm, cums, y, state, work, B, H, nc, Q, N, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
