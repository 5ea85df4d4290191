// Backward of the Mamba-2 SSD chunk scan (ssd_scan.cu), hand-written for Hopper (sm_90a).
//
// The reference has no Pallas backward: it trains by jax.grad through its XLA `ssd_chunked`
// (src/repro/models/ssm.py:43-110), whose forward the Pallas kernel `ssd_scan_kernel`
// (src/repro/kernels/ssd_scan/kernel.py:71) replaces when serving.  This is the transpose of the
// chunked decomposition, on the arranged inputs of ssd_scan/ops.py (xdt (B,H,nc,Q,P), Bm/Cm
// (B,nc,Q,N) shared by the heads, cums (B,H,nc,Q) f32) and dy (B,H,nc,Q,P), the gradient of y,
// and dstate (B,H,P,N) f32, that of the final state (null: zero).  Per (b, h) and chunk c, with
// G = C B^T, L_ij = exp(cu_i - cu_j) for i >= j (0 above), w_j = exp(cu_last - cu_j), s the
// state entering the chunk and dS the gradient of the state leaving it:
//   dX  = (G o L)^T dY + (B o w) dS^T
//   dM  = tril(dY X^T),  dG = dM o L
//   dC  = dG B + (dY s) o exp(cu),   dB = dG^T C + (X dS) o w     (both summed over the heads)
//   dcu = rowsum(dG o G) - colsum(dG o G) + exp(cu) o rowdot(C, dY s) - t,
//         t_j = w_j rowdot(X dS, B)_j, and at the last position + sum_j t_j + exp(cu_last)<dS, s>
//   dS_{c-1} = exp(cu_last) dS_c + dY^T (C o exp(cu))
// (ssd_scan/ref.py ssd_scan_bwd_ref is the same in plain PyTorch).  dxdt, dBm and dCm are stored
// once in the inputs' dtype (f32 or bf16), dcums in f32; every sum is f32.
//
// What bounds it: operations.  At mamba2-370m's training shape (B 4, S 2048, H 32, P 64, N 128,
// Q 256) the formulas need about 2.4e10 multiply-adds on 1.5e8 bytes moved, some 300 FLOPs a
// byte, at the bf16 tensor cores' balance point, and on the CUDA cores (67 TFLOP/s in f32) far
// above it.
//
// Two routes, four launches each on the caller's stream behind one call, no float atomics
// anywhere: every sum has a fixed order, so two calls give the same bits.
//
// f32 (`ssd_scan_bwd_f32`: `train_agree`, the f32 checks): the CUDA cores, every product an f32
// fma from tiles in shared memory, 256-thread blocks of 16 x 16 threads (thread (ty, tx) holds
// rows 4ty..4ty+3 and columns tx + 16k), rows padded by one float:
//   1. chunk products, parallel over (chunk, head, batch): each chunk's own state X^T (B o w)
//      and its state-gradient term dY^T (C o exp(cu)), (P, N) f32 each, into a workspace;
//   2. state passing, one block per (b, h) and 1024 state elements: the forward pass turns the
//      chunk states into the state entering each chunk (recomputed, not taken from the
//      forward: the Function saves only its four inputs), the reverse pass turns the gradient
//      terms into the gradient of the state leaving each chunk, both in place, and each
//      chunk's exp(cu_last)<dS, s> over the block's elements (a fixed-order block sum);
//   3. tile gradients, parallel over (64-row tile T, block of 8 heads, (b, chunk)): for each
//      head, the row pass walks the key tiles J <= T (G_TJ and dM_TJ formed 64x64 from the
//      tiles, masked and decayed into dG_TJ; dC_T += dG_TJ B_J; the row sums), then adds the
//      (dY s) terms; the column pass walks the query tiles I >= T (G o L and dG for the pair;
//      dX_T += (G o L)^T dY_I; dB_T += dG^T C_I; the column sums), then adds the dS terms and
//      t.  dX and dcums of the tile are stored per head; dB and dC are summed over the block's
//      heads in registers and stored as the head block's partial;
//   4. finish: dB and dC summed over the head blocks in order and stored in the inputs' dtype;
//      the last position of each chunk's dcums gets sum_j t_j and exp(cu_last)<dS, s>.
//
// bf16 (`ssd_scan_bwd_bf16`, the training path): the tensor cores, mma.sync m16n8k16 with f32
// accumulation through tc_sm90.cuh, 128-thread blocks of 4 warps, every tile bf16 in shared
// memory with rows padded by 16 bytes (conflict-free ldmatrix), streamed by cp.async in two
// stages.  C B^T and dY X^T take the bf16 inputs as they are (exact products); every f32
// operand (the decayed X and dY of the chunk products, G o L, dG, the state entering a chunk,
// the state's gradient leaving it) enters as bf16 hi + lo (tc::split_bf16), two products
// against the exact bf16 operand, about 16 significant bits; a scale that multiplies rows only
// (w, e) is applied to the f32 result.  One bf16 rounding of those operands instead would miss
// the 1e-4 tolerance of dcums (tests/test_torch_ssd_bwd_tc.py emulates both).
//   1'. chunk products (ssd_bwd_products_tc): one block per (64 state columns, (head, which),
//      (b, chunk)); the scaled X (or dY) A fragments come from ldmatrix.trans of the raw rows,
//      scaled and split in registers;
//   2'. state passing (ssd_bwd_pass_tc): each thread carries 8 consecutive state entries of a
//      (b, h) through the chunks, loading four chunks before it uses any, and leaves each
//      chunk's slot holding s (or dS) as bf16 hi + lo, the tile launch's operand layout; the
//      dot exp(cu_last)<dS, s_hi + s_lo> is a warp shuffle tree, one part a warp;
//   3'. tile gradients (ssd_bwd_tiles_tc, described at the kernel): the row pass and the
//      column pass of route 1 as mma tiles, the score fragments (G, dM and their transposes)
//      kept in registers and fed, split, straight back as A fragments, as flash attention's
//      backward does with P and dS; 110,720 bytes of shared memory at mamba2-370m's shape,
//      two blocks an SM;
//   4. finish, as route 1.
// N must be a multiple of 16 (the mma depth), as the bf16 forward requires.
//
// Sizes: P in {16, 32, 64, 128}; N <= 128; any Q and nc.  A launch whose shared memory exceeds
// a block's 227 KiB (route 1's tile launch takes (2(N+1) + 2(P+1) + 2*65) 64 + Q + 1024 +
// 64*(8+2) floats, 140 KiB at P 64, N 128, Q 256), or N above 128, is refused with
// cudaErrorInvalidValue.
//
// The kernels allocate nothing and never synchronise: the wrapper (ssd_scan/kernel.py) passes
// the workspaces (chunk states and state gradients (2,B,H,nc,P,N) f32, in bf16 rewritten in
// place as hi + lo; head-block partials of dB and dC (2,B,ceil(H/8),nc,Q,N); per chunk each
// tile's sum of t and each state slice's parts of exp(cu_last)<dS, s> (B,H,nc,tiles+slices),
// a slice 1024 elements, one part (f32 route) or one a warp (bf16 route), all f32).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "tc_sm90.cuh"

namespace {

constexpr int kThreads = 256;       // 16 x 16
constexpr int kT = 64;              // rows of a tile
constexpr int kLdT = kT + 1;
constexpr int kNMax = 128;          // widest N: 8 columns a thread
constexpr int kNPT = kNMax / 16;
constexpr int kHeadBlock = 8;       // heads a tile-gradient block walks (they share B and C)
constexpr int kPassElems = 1024;    // state elements a state-passing block walks
constexpr size_t kMaxSmem = 232448; // a block's opt-in maximum on H100 (227 KiB)

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// rows [r0, r0+64) of a (rows, W) row-major matrix as f32 with row stride ld; rows at or past
// `rows` are zero.
template <typename T>
__device__ __forceinline__ void load_rows(float* dst, int ld, const T* __restrict__ src, int r0,
                                          int rows, int W) {
  for (int idx = threadIdx.x; idx < kT * W; idx += kThreads) {
    const int r = idx / W, c = idx % W;
    const int row = r0 + r;
    dst[r * ld + c] = row < rows ? to_f32(src[static_cast<long long>(row) * W + c]) : 0.f;
  }
}

// sum over the 16 threads of a half-warp (the tx of one ty), in a fixed order
__device__ __forceinline__ float sum16(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// ------------------------------------------------------------------------------------------
// 1. chunk products: own = X^T (B o w), gterm = dY^T (C o exp(cu)), (P, N) each
// ------------------------------------------------------------------------------------------

template <typename T, int P>
__device__ void chunk_product(float* __restrict__ out, const T* __restrict__ A,
                              const T* __restrict__ M, const float* scale, float* As, float* Ms,
                              int Q, int N) {
  constexpr int PPT = P / 16;       // rows p = ty + 16r of the (P, N) output
  constexpr int LDA = P + 1;
  const int LDM = N + 1;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float acc[PPT][kNPT];
#pragma unroll
  for (int r = 0; r < PPT; ++r)
#pragma unroll
    for (int k = 0; k < kNPT; ++k) acc[r][k] = 0.f;
  for (int q0 = 0; q0 < Q; q0 += kT) {
    __syncthreads();
    load_rows(As, LDA, A, q0, Q, P);
    load_rows(Ms, LDM, M, q0, Q, N);
    __syncthreads();
    const int nq = min(kT, Q - q0);
    for (int qq = 0; qq < nq; ++qq) {
      const float sc = scale[q0 + qq];
      float av[PPT], mv[kNPT];
#pragma unroll
      for (int r = 0; r < PPT; ++r) av[r] = As[qq * LDA + ty + 16 * r] * sc;
#pragma unroll
      for (int k = 0; k < kNPT; ++k) {
        const int n = tx + 16 * k;
        mv[k] = n < N ? Ms[qq * LDM + n] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < PPT; ++r)
#pragma unroll
        for (int k = 0; k < kNPT; ++k) acc[r][k] = fmaf(av[r], mv[k], acc[r][k]);
    }
  }
#pragma unroll
  for (int r = 0; r < PPT; ++r)
#pragma unroll
    for (int k = 0; k < kNPT; ++k) {
      const int n = tx + 16 * k;
      if (n < N) out[(ty + 16 * r) * N + n] = acc[r][k];
    }
}

size_t products_smem_bytes(int P, int N, int Q) {
  return sizeof(float) * (static_cast<size_t>(kT) * (P + 1) + static_cast<size_t>(kT) * (N + 1) +
                          2 * static_cast<size_t>(Q));
}

template <typename T, int P>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_products(const T* __restrict__ xdt, const T* __restrict__ Bm, const T* __restrict__ Cm,
                 const float* __restrict__ cums, const T* __restrict__ dy,
                 float* __restrict__ own, float* __restrict__ gterm, int H, int nc, int Q,
                 int N) {
  extern __shared__ float smem[];
  float* As = smem;                       // (64, P+1)
  float* Ms = As + kT * (P + 1);          // (64, N+1)
  float* w = Ms + kT * (N + 1);           // (Q,) exp(cu_last - cu)
  float* e = w + Q;                       // (Q,) exp(cu)
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const long long bhc = (static_cast<long long>(b) * H + h) * nc + c;
  const long long bc = static_cast<long long>(b) * nc + c;
  const float* cu = cums + bhc * Q;
  const float last = cu[Q - 1];
  for (int i = threadIdx.x; i < Q; i += kThreads) {
    w[i] = expf(last - cu[i]);
    e[i] = expf(cu[i]);
  }
  const long long PN = static_cast<long long>(P) * N;
  chunk_product<T, P>(own + bhc * PN, xdt + bhc * Q * P, Bm + bc * Q * N, w, As, Ms, Q, N);
  chunk_product<T, P>(gterm + bhc * PN, dy + bhc * Q * P, Cm + bc * Q * N, e, As, Ms, Q, N);
}

// ------------------------------------------------------------------------------------------
// 2. state passing: own -> state entering each chunk; gterm -> gradient of the state leaving it
// ------------------------------------------------------------------------------------------

// one block per (b, h) and slice of kPassElems state elements; the slice's share of
// exp(cu_last)<dS, s> goes to sdot[.., tiles + slice]
__global__ void __launch_bounds__(kThreads)
ssd_bwd_pass(const float* __restrict__ cums, const float* __restrict__ dstate,
             float* __restrict__ own, float* __restrict__ gterm, float* __restrict__ sdot,
             int nc, int Q, int PN, int tiles) {
  constexpr int EPT = kPassElems / kThreads;
  __shared__ float red[kThreads];
  const long long bh = blockIdx.x;
  const int slices = gridDim.y, e0 = blockIdx.y * kPassElems;
  const long long base = bh * nc * PN;
  float v[EPT];
#pragma unroll
  for (int m = 0; m < EPT; ++m) v[m] = 0.f;
  for (int c = 0; c < nc; ++c) {
    const float dec = expf(cums[(bh * nc + c) * Q + Q - 1]);
    float* oc = own + base + static_cast<long long>(c) * PN;
#pragma unroll
    for (int m = 0; m < EPT; ++m) {
      const int idx = e0 + threadIdx.x + kThreads * m;
      if (idx < PN) {
        const float o = oc[idx];
        oc[idx] = v[m];
        v[m] = fmaf(dec, v[m], o);
      }
    }
  }
#pragma unroll
  for (int m = 0; m < EPT; ++m) {
    const int idx = e0 + threadIdx.x + kThreads * m;
    v[m] = dstate && idx < PN ? dstate[bh * PN + idx] : 0.f;
  }
  for (int c = nc - 1; c >= 0; --c) {
    const float dec = expf(cums[(bh * nc + c) * Q + Q - 1]);
    float* gc = gterm + base + static_cast<long long>(c) * PN;
    const float* sc = own + base + static_cast<long long>(c) * PN;
    float dot = 0.f;
#pragma unroll
    for (int m = 0; m < EPT; ++m) {
      const int idx = e0 + threadIdx.x + kThreads * m;
      if (idx < PN) {
        const float g = gc[idx];
        gc[idx] = v[m];
        dot = fmaf(v[m], sc[idx], dot);
        v[m] = fmaf(dec, v[m], g);
      }
    }
    red[threadIdx.x] = dot;
    __syncthreads();
    for (int s = kThreads / 2; s > 0; s >>= 1) {
      if (threadIdx.x < s) red[threadIdx.x] += red[threadIdx.x + s];
      __syncthreads();
    }
    if (threadIdx.x == 0)
      sdot[(bh * nc + c) * (tiles + slices) + tiles + blockIdx.y] = dec * red[0];
    __syncthreads();
  }
}

// ------------------------------------------------------------------------------------------
// 3. tile gradients
// ------------------------------------------------------------------------------------------

size_t tiles_smem_bytes(int P, int N, int Q) {
  return sizeof(float) * (2 * static_cast<size_t>(kT) * (N + 1) +
                          2 * static_cast<size_t>(kT) * (P + 1) + 2 * kT * kLdT + Q +
                          16 * kT + kT * (kHeadBlock + 2));
}

// acc[r][k] += sum_{d < W} X[4ty+r][d] * Y[tx+16k][d]: a 64x64 tile of X Y^T (rows of X and Y
// at stride ldx, ldy)
__device__ __forceinline__ void tile_xyt(float (&acc)[4][4], const float* X, int ldx,
                                         const float* Y, int ldy, int W) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[r][k] = 0.f;
#pragma unroll 4
  for (int d = 0; d < W; ++d) {
    float xv[4], yv[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) xv[r] = X[(4 * ty + r) * ldx + d];
#pragma unroll
    for (int k = 0; k < 4; ++k) yv[k] = Y[(tx + 16 * k) * ldy + d];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[r][k] = fmaf(xv[r], yv[k], acc[r][k]);
  }
}

template <typename T, int P>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_tiles(const T* __restrict__ xdt, const T* __restrict__ Bm, const T* __restrict__ Cm,
              const float* __restrict__ cums, const T* __restrict__ dy,
              const float* __restrict__ s_in, const float* __restrict__ dS_out,
              T* __restrict__ dxdt, float* __restrict__ dcums, float* __restrict__ dBp,
              float* __restrict__ dCp, float* __restrict__ sdot, int H, int nc, int Q, int N,
              int slices) {
  constexpr int LDP = P + 1;
  constexpr int PPT = P / 16;
  const int LDN = N + 1;
  extern __shared__ float smem[];
  float* Rn = smem;                    // (64, N+1) resident: C_T (row pass), B_T (column pass)
  float* Sn = Rn + kT * LDN;           // (64, N+1) streamed: B_J, C_I, rows of s and dS
  float* Rp = Sn + kT * LDN;           // (64, P+1) resident: dY_T (row pass), X_T (column pass)
  float* Sp = Rp + kT * LDP;           // (64, P+1) streamed: X_J, dY_I
  float* At = Sp + kT * LDP;           // (64, 65) dG_TJ (row pass), (G o L)_IT (column pass)
  float* Dt = At + kT * kLdT;          // (64, 65) dG_IT (column pass)
  float* cu = Dt + kT * kLdT;          // (Q,) cums of the head
  float* red = cu + Q;                 // (16, 64) column-sum partials
  float* rowt = red + 16 * kT;         // (8, 64) each head's row terms of dcums
  float* colt = rowt + kHeadBlock * kT;  // (64,) column sums
  float* tts = colt + kT;              // (64,) t of the tile's rows

  const int tile = blockIdx.x, tiles = gridDim.x;
  const int nhb = gridDim.y;
  const int hb = blockIdx.y;
  const int b = blockIdx.z / nc, c = blockIdx.z % nc;
  const int h0 = hb * kHeadBlock, nh = min(kHeadBlock, H - h0);
  const int T0 = tile * kT;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const long long bc = static_cast<long long>(b) * nc + c;
  const long long PN = static_cast<long long>(P) * N;
  const T* Bc = Bm + bc * Q * N;
  const T* Cc = Cm + bc * Q * N;

  // ---- row pass: dC_T (summed over the block's heads) and the row terms of dcums ----
  float accC[4][kNPT];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int k = 0; k < kNPT; ++k) accC[r][k] = 0.f;
  load_rows(Rn, LDN, Cc, T0, Q, N);
  for (int hh = 0; hh < nh; ++hh) {
    const long long bhc = (static_cast<long long>(b) * H + h0 + hh) * nc + c;
    __syncthreads();                   // the previous head's readers of cu and Rp are done
    for (int i = threadIdx.x; i < Q; i += kThreads) cu[i] = cums[bhc * Q + i];
    load_rows(Rp, LDP, dy + bhc * Q * P, T0, Q, P);
    float rs[4] = {0.f, 0.f, 0.f, 0.f};
    for (int J = 0; J <= tile; ++J) {
      const int J0 = J * kT;
      __syncthreads();
      load_rows(Sn, LDN, Bc, J0, Q, N);
      load_rows(Sp, LDP, xdt + bhc * Q * P, J0, Q, P);
      __syncthreads();
      float G[4][4], dM[4][4];
      tile_xyt(G, Rn, LDN, Sn, LDN, N);
      tile_xyt(dM, Rp, LDP, Sp, LDP, P);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = T0 + 4 * ty + r;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int j = J0 + tx + 16 * k;
          const float L = (i < Q && j <= i) ? expf(cu[i] - cu[j]) : 0.f;
          const float dg = dM[r][k] * L;
          rs[r] = fmaf(dg, G[r][k], rs[r]);
          At[(4 * ty + r) * kLdT + tx + 16 * k] = dg;
        }
      }
      __syncthreads();
      // dC_T += dG_TJ B_J
#pragma unroll 4
      for (int jj = 0; jj < kT; ++jj) {
        float gv[4], bv[kNPT];
#pragma unroll
        for (int r = 0; r < 4; ++r) gv[r] = At[(4 * ty + r) * kLdT + jj];
#pragma unroll
        for (int k = 0; k < kNPT; ++k) {
          const int n = tx + 16 * k;
          bv[k] = n < N ? Sn[jj * LDN + n] : 0.f;
        }
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int k = 0; k < kNPT; ++k) accC[r][k] = fmaf(gv[r], bv[k], accC[r][k]);
      }
    }
    // dY_T s, with s streamed 64 rows of P at a time
    float ys[4][kNPT];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int k = 0; k < kNPT; ++k) ys[r][k] = 0.f;
    for (int p0 = 0; p0 < P; p0 += kT) {
      __syncthreads();
      load_rows(Sn, LDN, s_in + bhc * PN, p0, P, N);
      __syncthreads();
      const int np = min(kT, P - p0);
      for (int pp = 0; pp < np; ++pp) {
        float yv[4], sv[kNPT];
#pragma unroll
        for (int r = 0; r < 4; ++r) yv[r] = Rp[(4 * ty + r) * LDP + p0 + pp];
#pragma unroll
        for (int k = 0; k < kNPT; ++k) {
          const int n = tx + 16 * k;
          sv[k] = n < N ? Sn[pp * LDN + n] : 0.f;
        }
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int k = 0; k < kNPT; ++k) ys[r][k] = fmaf(yv[r], sv[k], ys[r][k]);
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = T0 + 4 * ty + r;
      const float e = i < Q ? expf(cu[i]) : 0.f;
      float rd = 0.f;
#pragma unroll
      for (int k = 0; k < kNPT; ++k) {
        const int n = tx + 16 * k;
        if (n < N) {
          accC[r][k] = fmaf(ys[r][k], e, accC[r][k]);
          rd = fmaf(Rn[(4 * ty + r) * LDN + n], ys[r][k], rd);
        }
      }
      const float row = sum16(rs[r]) + e * sum16(rd);
      if (tx == 0) rowt[hh * kT + 4 * ty + r] = row;
    }
  }
  {
    float* out = dCp + ((static_cast<long long>(b) * nhb + hb) * nc + c) * Q * N;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = T0 + 4 * ty + r;
#pragma unroll
      for (int k = 0; k < kNPT; ++k) {
        const int n = tx + 16 * k;
        if (i < Q && n < N) out[static_cast<long long>(i) * N + n] = accC[r][k];
      }
    }
  }

  // ---- column pass: dX_T and dB_T (summed over the heads), the rest of dcums ----
  float accB[4][kNPT];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int k = 0; k < kNPT; ++k) accB[r][k] = 0.f;
  __syncthreads();                     // the row pass's readers of Rn are done
  load_rows(Rn, LDN, Bc, T0, Q, N);
  for (int hh = 0; hh < nh; ++hh) {
    const long long bhc = (static_cast<long long>(b) * H + h0 + hh) * nc + c;
    __syncthreads();
    for (int i = threadIdx.x; i < Q; i += kThreads) cu[i] = cums[bhc * Q + i];
    load_rows(Rp, LDP, xdt + bhc * Q * P, T0, Q, P);
    float accX[4][PPT];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int k = 0; k < PPT; ++k) accX[r][k] = 0.f;
    float cs[4] = {0.f, 0.f, 0.f, 0.f};
    for (int I = tile; I < tiles; ++I) {
      const int I0 = I * kT;
      __syncthreads();
      load_rows(Sn, LDN, Cc, I0, Q, N);
      load_rows(Sp, LDP, dy + bhc * Q * P, I0, Q, P);
      __syncthreads();
      float G[4][4], dM[4][4];
      tile_xyt(G, Sn, LDN, Rn, LDN, N);     // rows i of C_I, columns j of B_T
      tile_xyt(dM, Sp, LDP, Rp, LDP, P);    // rows i of dY_I, columns j of X_T
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = I0 + 4 * ty + r;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int j = T0 + tx + 16 * k;
          const float L = (i < Q && j <= i) ? expf(cu[i] - cu[j]) : 0.f;
          const float dg = dM[r][k] * L;
          cs[k] = fmaf(dg, G[r][k], cs[k]);
          At[(4 * ty + r) * kLdT + tx + 16 * k] = G[r][k] * L;
          Dt[(4 * ty + r) * kLdT + tx + 16 * k] = dg;
        }
      }
      __syncthreads();
      // dX_T[j] += sum_i (G o L)[i, j] dY_I[i];  dB_T[j] += sum_i dG[i, j] C_I[i]
#pragma unroll 2
      for (int ii = 0; ii < kT; ++ii) {
        float av[4], dv[4], yv[PPT], cv[kNPT];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          av[r] = At[ii * kLdT + 4 * ty + r];
          dv[r] = Dt[ii * kLdT + 4 * ty + r];
        }
#pragma unroll
        for (int k = 0; k < PPT; ++k) yv[k] = Sp[ii * LDP + tx + 16 * k];
#pragma unroll
        for (int k = 0; k < kNPT; ++k) {
          const int n = tx + 16 * k;
          cv[k] = n < N ? Sn[ii * LDN + n] : 0.f;
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
#pragma unroll
          for (int k = 0; k < PPT; ++k) accX[r][k] = fmaf(av[r], yv[k], accX[r][k]);
#pragma unroll
          for (int k = 0; k < kNPT; ++k) accB[r][k] = fmaf(dv[r], cv[k], accB[r][k]);
        }
      }
    }
    // the column sums: each thread's partial over its 4 rows, then over the 16 ty in order
#pragma unroll
    for (int k = 0; k < 4; ++k) red[ty * kT + tx + 16 * k] = cs[k];
    __syncthreads();
    if (threadIdx.x < kT) {
      float sum = 0.f;
      for (int y = 0; y < 16; ++y) sum += red[y * kT + threadIdx.x];
      colt[threadIdx.x] = sum;
    }
    // the dS terms, with dS streamed 64 rows of P at a time: dX_T += (B_T o w) dS^T and
    // X_T dS (for dB_T and t)
    const float last = cu[Q - 1];
    float wj[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int j = T0 + 4 * ty + r;
      wj[r] = j < Q ? expf(last - cu[j]) : 0.f;
    }
    float xs[4][kNPT];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int k = 0; k < kNPT; ++k) xs[r][k] = 0.f;
    for (int p0 = 0; p0 < P; p0 += kT) {
      __syncthreads();
      load_rows(Sn, LDN, dS_out + bhc * PN, p0, P, N);
      __syncthreads();
      const int np = min(kT, P - p0);
#pragma unroll
      for (int k = 0; k < PPT; ++k) {
        const int p = tx + 16 * k;
        if (p < p0 || p >= p0 + np) continue;
        const float* drow = Sn + (p - p0) * LDN;
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float* brow = Rn + (4 * ty + r) * LDN;
          float sum = 0.f;
#pragma unroll 4
          for (int n = 0; n < N; ++n) sum = fmaf(brow[n], drow[n], sum);
          accX[r][k] = fmaf(wj[r], sum, accX[r][k]);
        }
      }
      for (int pp = 0; pp < np; ++pp) {
        float xv[4], dv[kNPT];
#pragma unroll
        for (int r = 0; r < 4; ++r) xv[r] = Rp[(4 * ty + r) * LDP + p0 + pp];
#pragma unroll
        for (int k = 0; k < kNPT; ++k) {
          const int n = tx + 16 * k;
          dv[k] = n < N ? Sn[pp * LDN + n] : 0.f;
        }
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int k = 0; k < kNPT; ++k) xs[r][k] = fmaf(xv[r], dv[k], xs[r][k]);
      }
    }
    const long long bhcQ = bhc * Q;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int jl = 4 * ty + r, j = T0 + jl;
      float tdot = 0.f;
#pragma unroll
      for (int k = 0; k < kNPT; ++k) {
        const int n = tx + 16 * k;
        if (n < N) {
          accB[r][k] = fmaf(xs[r][k], wj[r], accB[r][k]);
          tdot = fmaf(xs[r][k], Rn[jl * LDN + n], tdot);
        }
      }
      const float t = wj[r] * sum16(tdot);
      if (tx == 0) {
        tts[jl] = t;
        if (j < Q) dcums[bhcQ + j] = rowt[hh * kT + jl] - colt[jl] - t;
      }
#pragma unroll
      for (int k = 0; k < PPT; ++k)
        if (j < Q) store(dxdt + (bhcQ + j) * P + tx + 16 * k, accX[r][k]);
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      float sum = 0.f;
      for (int j = 0; j < kT; ++j) sum += tts[j];
      sdot[bhc * (tiles + slices) + tile] = sum;
    }
  }
  float* out = dBp + ((static_cast<long long>(b) * nhb + hb) * nc + c) * Q * N;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = T0 + 4 * ty + r;
#pragma unroll
    for (int k = 0; k < kNPT; ++k) {
      const int n = tx + 16 * k;
      if (i < Q && n < N) out[static_cast<long long>(i) * N + n] = accB[r][k];
    }
  }
}

// ------------------------------------------------------------------------------------------
// 4. finish: dB and dC over the head blocks; the last position of each chunk's dcums
// ------------------------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_finish(const float* __restrict__ dBp, const float* __restrict__ dCp,
               const float* __restrict__ sdot, T* __restrict__ dB, T* __restrict__ dC,
               float* __restrict__ dcums, long long n_bc, long long n_bhc, int nhb, int nc,
               int Q, int N, int tiles, int slices) {
  const long long idx = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (idx < n_bc) {                         // idx over (b, c, q, n)
    const long long per_b = static_cast<long long>(nc) * Q * N;
    const long long b = idx / per_b, cqn = idx % per_b;
    float sb = 0.f, sc = 0.f;
    for (int hb = 0; hb < nhb; ++hb) {
      const long long i = (b * nhb + hb) * per_b + cqn;
      sb += dBp[i];
      sc += dCp[i];
    }
    store(dB + idx, sb);
    store(dC + idx, sc);
  } else if (idx < n_bc + n_bhc) {          // idx over (b, h, c)
    const long long bhc = idx - n_bc;
    const float* sd = sdot + bhc * (tiles + slices);
    float t = 0.f, e = 0.f;
    for (int i = 0; i < tiles; ++i) t += sd[i];
    for (int i = 0; i < slices; ++i) e += sd[tiles + i];
    dcums[bhc * Q + Q - 1] += t + e;
  }
}

template <typename T, int P>
int launch(const void* xdt, const void* Bm, const void* Cm, const void* cums, const void* dy,
           const void* dstate, void* dxdt, void* dB, void* dC, void* dcums, void* states,
           void* parts, void* sdot, long long B, long long H, long long nc, long long Q,
           long long N, cudaStream_t stream) {
  const size_t smem1 = products_smem_bytes(P, static_cast<int>(N), static_cast<int>(Q));
  const size_t smem3 = tiles_smem_bytes(P, static_cast<int>(N), static_cast<int>(Q));
  if (smem1 > kMaxSmem || smem3 > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncSetAttribute(ssd_bwd_products<T, P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(smem1));
  cudaFuncSetAttribute(ssd_bwd_tiles<T, P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(smem3));
  const int h = static_cast<int>(H), n = static_cast<int>(nc), q = static_cast<int>(Q),
            nn = static_cast<int>(N);
  const int tiles = (q + kT - 1) / kT;
  const int nhb = (h + kHeadBlock - 1) / kHeadBlock;
  const long long PN = static_cast<long long>(P) * N;
  const long long n_state = B * H * nc * PN;
  float* own = static_cast<float*>(states);
  float* gterm = own + n_state;
  const long long n_part = B * nhb * nc * Q * N;
  float* dBp = static_cast<float*>(parts);
  float* dCp = dBp + n_part;
  const T* x = static_cast<const T*>(xdt);
  const T* Bb = static_cast<const T*>(Bm);
  const T* Cb = static_cast<const T*>(Cm);
  const T* g = static_cast<const T*>(dy);
  const float* cu = static_cast<const float*>(cums);
  float* sd = static_cast<float*>(sdot);

  ssd_bwd_products<T, P><<<dim3(static_cast<unsigned>(nc), static_cast<unsigned>(H),
                               static_cast<unsigned>(B)),
                           kThreads, smem1, stream>>>(x, Bb, Cb, cu, g, own, gterm, h, n, q, nn);
  int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  const int slices = static_cast<int>((PN + kPassElems - 1) / kPassElems);
  ssd_bwd_pass<<<dim3(static_cast<unsigned>(B * H), static_cast<unsigned>(slices)), kThreads, 0,
                 stream>>>(cu, static_cast<const float*>(dstate), own, gterm, sd, n, q,
                           static_cast<int>(PN), tiles);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  ssd_bwd_tiles<T, P><<<dim3(static_cast<unsigned>(tiles), static_cast<unsigned>(nhb),
                            static_cast<unsigned>(B * nc)),
                       kThreads, smem3, stream>>>(
      x, Bb, Cb, cu, g, own, gterm, static_cast<T*>(dxdt), static_cast<float*>(dcums), dBp, dCp,
      sd, h, n, q, nn, slices);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  const long long n_bc = B * nc * Q * N, n_bhc = B * H * nc;
  const long long total = n_bc + n_bhc;
  ssd_bwd_finish<T><<<static_cast<unsigned>((total + kThreads - 1) / kThreads), kThreads, 0,
                      stream>>>(dBp, dCp, sd, static_cast<T*>(dB), static_cast<T*>(dC),
                                static_cast<float*>(dcums), n_bc, n_bhc, nhb, n, q, nn, tiles, slices);
  return static_cast<int>(cudaGetLastError());
}

// ==========================================================================================
// bf16 route: tensor cores (mma.sync m16n8k16, bf16 in, f32 accumulate, through tc_sm90.cuh)
// ==========================================================================================

using tc::bf16;

constexpr int kTcThreads = 128;      // 4 warps; in the tile launch warp w owns rows 16w..16w+15
constexpr int kSlabN = 64;           // state columns of a chunk-products block
constexpr int kTcPassChunks = 4;     // chunks a state-passing thread loads before it uses any
constexpr int kTcPassElems = kTcThreads * 8;   // state entries of a state-passing block
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float2 bf2_at(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// The A fragments (hi and lo halves) of one k16 step from two C tiles of f32 values: c0 gives
// the step's columns 0-7, c1 its columns 8-15 (rows g in [0..1], g + 8 in [2..3]).
__device__ __forceinline__ void split_a(const float (&c0)[4], const float (&c1)[4],
                                        uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  tc::split_bf16(c0[0], c0[1], hi[0], lo[0]);
  tc::split_bf16(c0[2], c0[3], hi[1], lo[1]);
  tc::split_bf16(c1[0], c1[1], hi[2], lo[2]);
  tc::split_bf16(c1[2], c1[3], hi[3], lo[3]);
}

// acc0 += a * (b0, b1) and acc1 += a * (b2, b3): the n tiles 0 and 1 of an ldmatrix.x4 pair
__device__ __forceinline__ void mma_pair(float (&acc0)[4], float (&acc1)[4],
                                         const uint32_t (&a)[4], const uint32_t (&b)[4]) {
  tc::mma_bf16(acc0, a, b[0], b[1]);
  tc::mma_bf16(acc1, a, b[2], b[3]);
}

// v += the other three lanes of its quad (t = 0..3): a row's sum over a C fragment's columns
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// the two bf16 of a 32-bit word as f32 (exact: a bf16 is the top half of an f32)
__device__ __forceinline__ float2 bf2_bits(uint32_t w) {
  return make_float2(__uint_as_float(w << 16), __uint_as_float(w & 0xffff0000u));
}

// 8 f32 values as bf16 hi (16 bytes) then lo (16 bytes), in place of the 32 bytes they held;
// every access to these buffers is f32-typed, the bf16 pairs carried in f32 bit patterns
__device__ __forceinline__ void store_hilo(float* dst, const float (&v)[8]) {
  uint32_t hi[4], lo[4];
#pragma unroll
  for (int m = 0; m < 4; ++m) tc::split_bf16(v[2 * m], v[2 * m + 1], hi[m], lo[m]);
  reinterpret_cast<float4*>(dst)[0] = make_float4(__uint_as_float(hi[0]), __uint_as_float(hi[1]),
                                                  __uint_as_float(hi[2]), __uint_as_float(hi[3]));
  reinterpret_cast<float4*>(dst)[1] = make_float4(__uint_as_float(lo[0]), __uint_as_float(lo[1]),
                                                  __uint_as_float(lo[2]), __uint_as_float(lo[3]));
}

__device__ __forceinline__ void load8(float (&v)[8], const float* src) {
  const float4 a = reinterpret_cast<const float4*>(src)[0];
  const float4 b = reinterpret_cast<const float4*>(src)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

// ------------------------------------------------------------------------------------------
// 1'. chunk products: own = (X o w)^T B and gterm = (dY o e)^T C, (P, N) f32 per (b, h, chunk)
// ------------------------------------------------------------------------------------------

size_t products_tc_smem_bytes(int P, int Q) {
  const size_t Qp = static_cast<size_t>((Q + kT - 1) / kT) * kT;
  return sizeof(bf16) * 2 * kT * (static_cast<size_t>(P + 8) + kSlabN + 8) + sizeof(float) * Qp;
}

// One block per (64 state columns, (head, which), (b, chunk)); warp w computes the 16-row groups
// w and w + 4 of P across the 64 columns.  Chunk positions come 64 at a time, the next rows of
// X (or dY) and B (or C) in flight while these are used.  The row scale (w or e, f32) goes on
// the P-side operand in registers: its A fragment, read by ldmatrix.trans from the raw [q][p]
// rows, is scaled and split into bf16 hi + lo, both halves against the exact bf16 B or C.
template <int P>
__global__ void __launch_bounds__(kTcThreads)
ssd_bwd_products_tc(const bf16* __restrict__ xdt, const bf16* __restrict__ Bm,
                    const bf16* __restrict__ Cm, const float* __restrict__ cums,
                    const bf16* __restrict__ dy, float* __restrict__ own,
                    float* __restrict__ gterm, int H, int nc, int Q, int N) {
  constexpr int LDA = P + 8;
  constexpr int LDM = kSlabN + 8;
  constexpr int MG = P / 16;           // 16-row groups of P
  constexpr int MW = (MG + 3) / 4;     // groups a warp
  constexpr int AT = kT * LDA, MT = kT * LDM;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* const As = reinterpret_cast<bf16*>(smem_raw);       // [stage] (64, P) rows of X or dY
  bf16* const Ms = As + 2 * AT;                              // [stage] (64, 64) rows of B or C
  float* const sc = reinterpret_cast<float*>(Ms + 2 * MT);   // (Qp,) the row scales

  const int n0 = blockIdx.x * kSlabN;
  const int h = blockIdx.y >> 1, which = blockIdx.y & 1;
  const int bc = blockIdx.z, b = bc / nc, c = bc - b * nc;
  const long long bhc = (static_cast<long long>(b) * H + h) * nc + c;
  const bf16* const A = (which ? dy : xdt) + bhc * Q * P;
  const bf16* const M = (which ? Cm : Bm) + static_cast<long long>(bc) * Q * N;
  const float* const cu = cums + bhc * Q;
  const int n_qt = (Q + kT - 1) / kT;
  const int nw = min(kSlabN, N - n0);  // the block's columns, a multiple of 16

  auto prefetch = [=](int qt) {
    const int q0 = qt * kT;
    bf16* const mt = Ms + (qt & 1) * MT;
    tc::load_rows_async(As + (qt & 1) * AT, LDA, A, q0, kT, Q, P);
    for (int idx = threadIdx.x; idx < kT * (kSlabN / 8); idx += kTcThreads) {
      const int r = idx / (kSlabN / 8), ch = idx - r * (kSlabN / 8);
      const int row = q0 + r;
      const bool ok = row < Q && ch * 8 < nw;
      tc::cp_async16(mt + r * LDM + ch * 8,
                     M + (ok ? static_cast<long long>(row) * N + n0 + ch * 8 : 0), ok);
    }
  };
  prefetch(0);
  tc::cp_async_commit();
  const float last = cu[Q - 1];
  for (int i = threadIdx.x; i < n_qt * kT; i += kTcThreads)
    sc[i] = i < Q ? expf(which ? cu[i] : last - cu[i]) : 0.f;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int a_off = tc::frag_bt_row(lane) * LDA + tc::frag_bt_col(lane);   // A^T from [q][p]
  const int m_off = tc::frag_a_row(lane) * LDM + tc::frag_a_col(lane);     // B from [q][n]

  float acc[MW][kSlabN / 8][4];
#pragma unroll
  for (int mi = 0; mi < MW; ++mi)
#pragma unroll
    for (int j = 0; j < kSlabN / 8; ++j)
      acc[mi][j][0] = acc[mi][j][1] = acc[mi][j][2] = acc[mi][j][3] = 0.f;

  for (int qt = 0; qt < n_qt; ++qt) {
    if (qt + 1 < n_qt) prefetch(qt + 1);
    tc::cp_async_commit();
    tc::cp_async_wait<1>();                // rows qt (and the scales) are in place
    __syncthreads();
    const bf16* const at = As + (qt & 1) * AT;
    const bf16* const mt = Ms + (qt & 1) * MT;
#pragma unroll
    for (int kk = 0; kk < kT / 16; ++kk) {
      const int q = qt * kT + kk * 16 + 2 * t;
      const float2 s0 = *reinterpret_cast<const float2*>(sc + q);       // a0, a1: positions q..
      const float2 s1 = *reinterpret_cast<const float2*>(sc + q + 8);   // a2, a3: q + 8..
      uint32_t ah[MW][4], al[MW][4];
#pragma unroll
      for (int mi = 0; mi < MW; ++mi) {
        const int mg = warp + 4 * mi;
        if (mg < MG) {
          uint32_t a[4];
          tc::ldsm_x4_t(a, at + a_off + kk * 16 * LDA + mg * 16);
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const float2 v = bf2_bits(a[r]);
            const float2 s = r < 2 ? s0 : s1;
            tc::split_bf16(v.x * s.x, v.y * s.y, ah[mi][r], al[mi][r]);
          }
        }
      }
#pragma unroll
      for (int np = 0; np < kSlabN / 16; ++np) {
        if (np * 16 < nw) {
          uint32_t bb[4];
          tc::ldsm_x4_t(bb, mt + m_off + kk * 16 * LDM + np * 16);
#pragma unroll
          for (int mi = 0; mi < MW; ++mi) {
            if (warp + 4 * mi < MG) {
              mma_pair(acc[mi][2 * np], acc[mi][2 * np + 1], ah[mi], bb);
              mma_pair(acc[mi][2 * np], acc[mi][2 * np + 1], al[mi], bb);
            }
          }
        }
      }
    }
    __syncthreads();                       // every warp is done with this stage
  }

  float* const out = (which ? gterm : own) + bhc * P * N;
#pragma unroll
  for (int mi = 0; mi < MW; ++mi) {
    const int mg = warp + 4 * mi;
    if (mg >= MG) continue;
    const int p = mg * 16 + g;
#pragma unroll
    for (int j = 0; j < kSlabN / 8; ++j) {
      if (j * 8 >= nw) continue;
      const int col = n0 + j * 8 + 2 * t;
      *reinterpret_cast<float2*>(out + static_cast<long long>(p) * N + col) =
          make_float2(acc[mi][j][0], acc[mi][j][1]);
      *reinterpret_cast<float2*>(out + static_cast<long long>(p + 8) * N + col) =
          make_float2(acc[mi][j][2], acc[mi][j][3]);
    }
  }
}

// ------------------------------------------------------------------------------------------
// 2'. state passing: own -> the state entering each chunk, gterm -> the gradient of the state
//     leaving it, each as bf16 hi + lo in place; each chunk's exp(cu_last)<dS, s> by warp
// ------------------------------------------------------------------------------------------

// One block per (b, h) and kTcPassElems state entries; each thread carries 8 consecutive
// entries (32 bytes of each chunk's slot) through the chunks, loading kTcPassChunks chunks
// before it uses any.  Its slot of chunk c then holds the 8 values as bf16 hi (16 bytes) and lo
// (16 bytes), the layout the tile launch loads.  The forward walk writes s, the reverse walk dS
// and, per chunk and warp, exp(cu_last) sum dS (s_hi + s_lo) (a fixed-order sum: the thread's 8
// entries, then a shuffle tree) into sdot[.., tiles + 4 * blockIdx.y + warp].
__global__ void __launch_bounds__(kTcThreads)
ssd_bwd_pass_tc(const float* __restrict__ cums, const float* __restrict__ dstate,
                float* __restrict__ own, float* __restrict__ gterm, float* __restrict__ sdot,
                int nc, int Q, int PN, int tiles, int slices) {
  const long long bh = blockIdx.x;
  const int e = blockIdx.y * kTcPassElems + threadIdx.x * 8;
  const bool ok = e < PN;
  const int slice = blockIdx.y * (kTcThreads / 32) + (threadIdx.x >> 5);
  const long long base = bh * nc * PN + e;        // entry e of chunk 0's slot
  const float* const cl = cums + bh * nc * Q + Q - 1;   // cu_last of chunk c at c * Q

  float v[8];
#pragma unroll
  for (int m = 0; m < 8; ++m) v[m] = 0.f;
  for (int c0 = 0; c0 < nc; c0 += kTcPassChunks) {
    float o[kTcPassChunks][8], d[kTcPassChunks];
#pragma unroll
    for (int u = 0; u < kTcPassChunks; ++u) {
      const int c = c0 + u;
      if (c < nc) {
        d[u] = expf(cl[static_cast<long long>(c) * Q]);
        if (ok) load8(o[u], own + base + static_cast<long long>(c) * PN);
      }
    }
#pragma unroll
    for (int u = 0; u < kTcPassChunks; ++u) {
      const int c = c0 + u;
      if (c >= nc) break;
      if (ok) {
        store_hilo(own + base + static_cast<long long>(c) * PN, v);
#pragma unroll
        for (int m = 0; m < 8; ++m) v[m] = fmaf(d[u], v[m], o[u][m]);
      }
    }
  }

  if (ok && dstate) {
    load8(v, dstate + bh * PN + e);
  } else {
#pragma unroll
    for (int m = 0; m < 8; ++m) v[m] = 0.f;
  }
  for (int c1 = nc - 1; c1 >= 0; c1 -= kTcPassChunks) {
    float gv[kTcPassChunks][8], sv[kTcPassChunks][8], d[kTcPassChunks];
#pragma unroll
    for (int u = 0; u < kTcPassChunks; ++u) {
      const int c = c1 - u;
      if (c >= 0) {
        d[u] = expf(cl[static_cast<long long>(c) * Q]);
        if (ok) {
          load8(gv[u], gterm + base + static_cast<long long>(c) * PN);
          load8(sv[u], own + base + static_cast<long long>(c) * PN);   // s: hi words, lo words
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kTcPassChunks; ++u) {
      const int c = c1 - u;
      if (c < 0) break;
      float dot = 0.f;
      if (ok) {
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          const float2 hs = bf2_bits(__float_as_uint(sv[u][m]));
          const float2 ls = bf2_bits(__float_as_uint(sv[u][4 + m]));
          dot = fmaf(v[2 * m], hs.x + ls.x, dot);
          dot = fmaf(v[2 * m + 1], hs.y + ls.y, dot);
        }
        store_hilo(gterm + base + static_cast<long long>(c) * PN, v);
#pragma unroll
        for (int m = 0; m < 8; ++m) v[m] = fmaf(d[u], v[m], gv[u][m]);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o);
      if ((threadIdx.x & 31) == 0)
        sdot[(bh * nc + c) * (tiles + slices) + tiles + slice] = d[u] * dot;
    }
  }
}

// ------------------------------------------------------------------------------------------
// 3'. tile gradients
// ------------------------------------------------------------------------------------------

constexpr int kSC = 32;              // state columns a state step of the tile launch takes
constexpr int kLdS = kSC + 8;        // row stride of a state step's hi and lo rows

// Shared memory of the tile launch.  A stage holds one step's streamed tiles: slot N (a 64-row
// tile of B or C, or a state step's hi and lo rows) and slot P (a 64-row tile of X or dY).
__host__ __device__ __forceinline__ int tc_slot_n(int P, int N) {   // elements
  const int tile = kT * (N + 8), state = 2 * P * kLdS;
  return tile > state ? tile : state;
}

// C_T and B_T, two resident tiles of P (dY_T or X_T of a head), two stages, two cums rows, the
// block's row terms of dcums, the warps' sums of t
size_t tiles_tc_smem_bytes(int P, int N, int Q) {
  const size_t Qp = static_cast<size_t>((Q + kT - 1) / kT) * kT;
  return sizeof(bf16) * (2 * static_cast<size_t>(kT) * (N + 8) +
                         2 * static_cast<size_t>(kT) * (P + 8) +
                         2 * (static_cast<size_t>(tc_slot_n(P, N)) + kT * (P + 8))) +
         sizeof(float) * (2 * Qp + kHeadBlock * kT + kHeadBlock * 4);
}

// One block per (64-row tile T, block of 8 heads, (b, chunk)), 4 warps, warp w owning rows
// T0 + 16w .. + 15 (queries i where T is the query tile, keys j where it is the key tile).
// C_T and B_T stay in shared memory; per head the block walks steps, each streaming its tiles
// by cp.async into one of two stages while the previous step computes; a head's first step
// also loads its resident tile of P and its cums (double-buffered by head).  Three sweeps over
// the block's heads:
//   R (T the query tile, dY_T resident): state steps (32 columns of s as hi and lo rows:
//     tmp = dY_T s[:, cols], dC_T += tmp o e, the row dot of tmp with C_T); key tiles
//     J = 0..T (B_J, X_J), in sub-steps of 32 keys: G = C_T B_J^T and dM = dY_T X_J^T on the
//     tensor cores, dG = dM o L and the row sums of dG o G in registers, dC_T += dG B_J with
//     dG split hi + lo straight from the accumulators;
//   X (T the key tile, X_T resident): state steps (dX_T += B_T[:, cols] dS[:, cols]^T), then
//     dX_T *= w; query tiles I = T.. (C_I, dY_I): G^T = B_T C_I^T, dM^T = X_T dY_I^T,
//     dX_T += (G o L)^T dY_I with (G o L)^T split from the accumulators, the row sums of
//     dG^T o G^T (dcums' column terms); dX stored;
//   B (X_T resident): state steps (tmp = X_T dS[:, cols], dB_T += tmp o w, t = w o (tmp's row
//     dot with B_T), the tile's sum of t); query tiles: dM^T again, dB_T += dG^T C_I.
// Splitting the key-tile work into X and B keeps dX_T and dB_T from being live together: the
// accumulators then fit the registers with room (one more P-deep product a tile pair).  dC_T
// and dB_T are summed over the block's heads in registers and stored as the block's partials;
// dX and dcums are stored per head, the tile's sum of t per head into sdot.  Sub-steps of 32
// keys (queries) that lie wholly above (below) the warp's rows are skipped.
// G depends on (b, chunk) and the tile pair only, not on the head, yet it is formed again for
// every head: keeping the block's band of G in shared memory instead (tiles x 16 KiB) leaves one
// block an SM at Q 256, and was slower on the card.
// Two blocks an SM (its shared memory admits two): said to ptxas, which otherwise aims at three
// at P 16, caps the registers at 168 and spills.
template <int P>
__global__ void __launch_bounds__(kTcThreads, 2)
ssd_bwd_tiles_tc(const bf16* __restrict__ xdt, const bf16* __restrict__ Bm,
                 const bf16* __restrict__ Cm, const float* __restrict__ cums,
                 const bf16* __restrict__ dy, const float* __restrict__ s_hl,
                 const float* __restrict__ dS_hl, bf16* __restrict__ dxdt,
                 float* __restrict__ dcums, float* __restrict__ dBp, float* __restrict__ dCp,
                 float* __restrict__ sdot, int H, int nc, int Q, int N, int slices,
                 int has_dstate) {
  constexpr int LDP = P + 8;
  constexpr int PT = P / 8;            // n8 tiles of a (16, P) accumulator
  constexpr int NT = kNMax / 8;        // n8 tiles of a (16, N) accumulator
  constexpr int KW = 32;               // keys (queries) of a sub-step
  constexpr int KT = KW / 8;           // n8 tiles of a sub-step's scores
  constexpr int NS = kT / KW;          // sub-steps of a tile pair
  constexpr int ST = kSC / 8;          // n8 tiles of a state step's columns
  const int LDN = N + 8;
  const int tile = blockIdx.x, tiles = gridDim.x;
  const int Qp = tiles * kT;
  const int SLOTN = tc_slot_n(P, N);
  const int STAGE = SLOTN + kT * LDP;  // elements
  const int nhb = gridDim.y, hb = blockIdx.y;
  const int bc = blockIdx.z, b = bc / nc, c = bc - b * nc;
  const int h0 = hb * kHeadBlock, nh = min(kHeadBlock, H - h0);
  const int T0 = tile * kT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* const Cs = reinterpret_cast<bf16*>(smem_raw);             // (64, N) C_T
  bf16* const Bs = Cs + kT * LDN;                                  // (64, N) B_T
  bf16* const Rp = Bs + kT * LDN;                                  // [2] (64, P) dY_T or X_T
  bf16* const stages = Rp + 2 * kT * LDP;                          // [2] slot N, slot P
  float* const cub = reinterpret_cast<float*>(stages + 2 * STAGE); // [2] (Qp,) cums of a head
  float* const rowt = cub + 2 * Qp;                                // (8, 64) dcums' terms
  float* const tsum = rowt + kHeadBlock * kT;                      // (8, 4) the warps' t sums

  const bf16* const Bc = Bm + static_cast<long long>(bc) * Q * N;
  const bf16* const Cc = Cm + static_cast<long long>(bc) * Q * N;
  auto bhc_of = [=](int hh) { return (static_cast<long long>(b) * H + h0 + hh) * nc + c; };

  // the steps: per head of R nsr state steps and T + 1 key tiles, per head of X and of B nsc
  // state steps and tiles - T query tiles (a zero s or dS takes no state step)
  const int nst = (N + kSC - 1) / kSC;
  const int nsr = c > 0 ? nst : 0;
  const int nsc = (c < nc - 1 || has_dstate) ? nst : 0;
  const int nI = tiles - tile;
  const int SR = nsr + tile + 1, SC = nsc + nI;
  const int total = nh * (SR + 2 * SC);

  // the loads of step fi into stage fi & 1; a head's first step also loads its resident tile
  // and cums into buffer hs & 1, hs counting the heads of the three sweeps in order
  auto issue = [&](int fi) {
    const int sweep = fi < nh * SR ? 0 : fi < nh * (SR + SC) ? 1 : 2;
    const int r = fi - (sweep == 0 ? 0 : sweep == 1 ? nh * SR : nh * (SR + SC));
    const int per = sweep ? SC : SR, ns = sweep ? nsc : nsr;
    const int hh = r / per, idx = r - hh * per;
    const int hs = sweep * nh + hh;
    const long long bhc = bhc_of(hh);
    bf16* const sn = stages + (fi & 1) * STAGE;
    bf16* const sp = sn + SLOTN;
    if (idx == 0) {
      tc::load_rows_async(Rp + (hs & 1) * kT * LDP, LDP, (sweep ? xdt : dy) + bhc * Q * P, T0,
                          kT, Q, P);
      float* const cu = cub + (hs & 1) * Qp;
      for (int i = threadIdx.x; i < Qp; i += kTcThreads)
        tc::cp_async4(cu + i, cums + bhc * Q + (i < Q ? i : 0), i < Q);
    }
    if (idx < ns) {                        // columns kSC idx.. of s or dS: hi rows, lo rows
      const int n0 = idx * kSC, ng = min(kSC, N - n0) / 8;
      const float* const src = (sweep ? dS_hl : s_hl) + bhc * P * N + n0;
      for (int i = threadIdx.x; i < P * ng; i += kTcThreads) {
        const int p = i / ng, gi = i - p * ng;
        const float* const grp = src + static_cast<long long>(p) * N + 8 * gi;
        tc::cp_async16(sn + p * kLdS + 8 * gi, grp, true);
        tc::cp_async16(sn + (P + p) * kLdS + 8 * gi, grp + 4, true);
      }
    } else {                               // a 64-row tile of B and X, or of C and dY
      const int row0 = (sweep ? tile + idx - ns : idx - ns) * kT;
      tc::load_rows_async(sn, LDN, sweep ? Cc : Bc, row0, kT, Q, N);
      tc::load_rows_async(sp, LDP, (sweep ? dy : xdt) + bhc * Q * P, row0, kT, Q, P);
    }
  };

  tc::load_rows_async(Cs, LDN, Cc, T0, kT, Q, N);
  tc::load_rows_async(Bs, LDN, Bc, T0, kT, Q, N);
  issue(0);
  tc::cp_async_commit();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wl = warp * 16;
  const int l0 = wl + g, l1 = l0 + 8;      // the lane's rows in the tile
  const int r0 = T0 + l0, r1 = T0 + l1;    // and in the chunk
  const int an = (wl + tc::frag_a_row(lane)) * LDN + tc::frag_a_col(lane);   // A of C_T, B_T
  const int ap = (wl + tc::frag_a_row(lane)) * LDP + tc::frag_a_col(lane);   // A of Rp
  const int btn = tc::frag_bt_row(lane) * LDN + tc::frag_bt_col(lane);       // B of [n][k]
  const int btp = tc::frag_bt_row(lane) * LDP + tc::frag_bt_col(lane);
  const int bts = tc::frag_bt_row(lane) * kLdS + tc::frag_bt_col(lane);
  const int trn = tc::frag_a_row(lane) * LDN + tc::frag_a_col(lane);        // B of [k][n]
  const int trp = tc::frag_a_row(lane) * LDP + tc::frag_a_col(lane);
  const int trs = tc::frag_a_row(lane) * kLdS + tc::frag_a_col(lane);
  const int nk = N / 16;

  if (t == 0) {                            // each lane's two rows, for every head
    for (int hh = 0; hh < kHeadBlock; ++hh) rowt[hh * kT + l0] = rowt[hh * kT + l1] = 0.f;
  }
  if (lane == 0) {
    for (int hh = 0; hh < kHeadBlock; ++hh) tsum[hh * 4 + warp] = 0.f;
  }

  int f = 0;
  auto advance = [&]() {                   // step f's tiles have landed; f + 1's are in flight
    if (f + 1 < total) issue(f + 1);
    tc::cp_async_commit();
    tc::cp_async_wait<1>();
    __syncthreads();
  };
  auto retire = [&]() {                    // every warp is done with step f's stage
    __syncthreads();
    ++f;
  };
  auto stage_n = [&]() { return stages + (f & 1) * STAGE; };
  auto stage_p = [&]() { return stages + (f & 1) * STAGE + SLOTN; };
  // the lanes t == 0 add v0, v1 (each already its quad's sum) to head hh's rows
  auto add_rows = [&](int hh, float v0, float v1) {
    if (t == 0) {
      rowt[hh * kT + l0] += v0;
      rowt[hh * kT + l1] += v1;
    }
  };
  // acc (16, kSC) += the warp's rows of a resident tile of P x a state step's hi + lo rows
  auto state_product = [&](float (&acc)[ST][4], const bf16* a_p, const bf16* st, int cw) {
#pragma unroll
    for (int kk = 0; kk < P / 16; ++kk) {
      uint32_t a[4];
      tc::ldsm_x4(a, a_p + ap + kk * 16);
#pragma unroll
      for (int np = 0; np < ST / 2; ++np) {
        if (np * 16 < cw) {
          uint32_t bh[4], bl[4];           // stored [p][n]
          tc::ldsm_x4_t(bh, st + trs + kk * 16 * kLdS + np * 16);
          tc::ldsm_x4_t(bl, st + trs + (P + kk * 16) * kLdS + np * 16);
          mma_pair(acc[2 * np], acc[2 * np + 1], a, bh);
          mma_pair(acc[2 * np], acc[2 * np + 1], a, bl);
        }
      }
    }
  };
  // s (16, 32) = the warp's rows of a_s (A, at a_off) x rows kb..kb+31 of b_s (stored
  // [row][k], ld), depth `depth`
  auto scores = [&](float (&s)[KT][4], const bf16* a_s, int a_off, const bf16* b_s, int b_off,
                    int ld, int kb, int depth) {
#pragma unroll
    for (int j = 0; j < KT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    for (int kk = 0; kk < depth / 16; ++kk) {
      uint32_t a[4];
      tc::ldsm_x4(a, a_s + a_off + kk * 16);
#pragma unroll
      for (int np = 0; np < KT / 2; ++np) {
        uint32_t bb[4];
        tc::ldsm_x4(bb, b_s + b_off + (kb + np * 16) * ld + kk * 16);
        mma_pair(s[2 * np], s[2 * np + 1], a, bb);
      }
    }
  };
  auto tr_of = [&](int ld) { return ld == LDP ? trp : trn; };   // LDP == LDN: the same
  // acc (16, 8 x its n8 tiles, ntile of them used) += v, split hi + lo, x rows kb.. of b_s
  // (stored [k][n], ld)
  auto product_split = [&](auto& acc, const float (&v)[KT][4], const bf16* b_s, int ld, int kb,
                           int ntile) {
    constexpr int NP = static_cast<int>(sizeof(acc) / sizeof(acc[0])) / 2;
#pragma unroll
    for (int kk2 = 0; kk2 < KW / 16; ++kk2) {
      uint32_t hi[4], lo[4];
      split_a(v[2 * kk2], v[2 * kk2 + 1], hi, lo);
#pragma unroll
      for (int np = 0; np < NP; ++np) {
        if (np * 2 < ntile) {
          uint32_t bb[4];
          tc::ldsm_x4_t(bb, b_s + tr_of(ld) + (kb + kk2 * 16) * ld + np * 16);
          mma_pair(acc[2 * np], acc[2 * np + 1], hi, bb);
          mma_pair(acc[2 * np], acc[2 * np + 1], lo, bb);
        }
      }
    }
  };
  // one element (jj, q) of a sub-step's L (or L^T): exp(cu_i - cu_j) where i >= j and i, j < Q,
  // else 0; rows are the warp's (queries when `rows_are_queries`, their cums c0 and c1),
  // columns the sub-step's from cb
  auto decay = [&](const float* cu, float c0, float c1, int cb, int jj, int q,
                   bool rows_are_queries) {
    const int row = q < 2 ? r0 : r1;
    const int col = cb + jj * 8 + 2 * t + (q & 1);
    const int i = rows_are_queries ? row : col, j = rows_are_queries ? col : row;
    const float ci = rows_are_queries ? (q < 2 ? c0 : c1) : cu[col];
    const float cj = rows_are_queries ? cu[col] : (q < 2 ? c0 : c1);
    return (i >= j && i < Q && j < Q) ? tc::ex2((ci - cj) * kLog2e) : 0.f;
  };

  // ---- R: dC_T (summed over the block's heads) and the row terms of dcums ----
  float accC[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) accC[j][0] = accC[j][1] = accC[j][2] = accC[j][3] = 0.f;
  for (int hh = 0; hh < nh; ++hh) {
    const float* const cu = cub + (hh & 1) * Qp;
    const bf16* const Ys = Rp + (hh & 1) * kT * LDP;          // dY_T
    float rd0 = 0.f, rd1 = 0.f;
#pragma unroll
    for (int k = 0; k < kNMax / kSC; ++k) {
      if (k >= nsr) continue;
      advance();
      const int cw = min(kSC, N - k * kSC);
      float tmp[ST][4];
#pragma unroll
      for (int j = 0; j < ST; ++j) tmp[j][0] = tmp[j][1] = tmp[j][2] = tmp[j][3] = 0.f;
      state_product(tmp, Ys, stage_n(), cw);                   // dY_T s[:, kSC k..]
      const float e0 = r0 < Q ? expf(cu[r0]) : 0.f, e1 = r1 < Q ? expf(cu[r1]) : 0.f;
#pragma unroll
      for (int jj = 0; jj < ST; ++jj) {
        if (jj * 8 < cw) {
          const int n = k * kSC + jj * 8 + 2 * t;
          const float2 c0 = bf2_at(Cs + l0 * LDN + n), c1 = bf2_at(Cs + l1 * LDN + n);
          rd0 = fmaf(c0.x, tmp[jj][0], fmaf(c0.y, tmp[jj][1], rd0));
          rd1 = fmaf(c1.x, tmp[jj][2], fmaf(c1.y, tmp[jj][3], rd1));
          const int o = k * (kSC / 8) + jj;   // a constant once unrolled
          accC[o][0] = fmaf(e0, tmp[jj][0], accC[o][0]);
          accC[o][1] = fmaf(e0, tmp[jj][1], accC[o][1]);
          accC[o][2] = fmaf(e1, tmp[jj][2], accC[o][2]);
          accC[o][3] = fmaf(e1, tmp[jj][3], accC[o][3]);
        }
      }
      if (k == nsr - 1) add_rows(hh, e0 * quad_sum(rd0), e1 * quad_sum(rd1));
      retire();
    }
    for (int J = 0; J <= tile; ++J) {
      advance();
      const bf16* const Sn = stage_n();                        // B_J
      float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
      for (int jh = 0; jh < NS; ++jh) {
        const int jb = jh * KW;            // the sub-step's first key in the tile
        if (J * kT + jb > T0 + wl + 15) continue;   // every key lies above the warp's rows
        float G[KT][4], dG[KT][4];
        scores(G, Cs, an, Sn, btn, LDN, jb, N);                // G = C_T B_J^T
        scores(dG, Ys, ap, stage_p(), btp, LDP, jb, P);        // dM = dY_T X_J^T
        const float c0 = cu[r0], c1 = cu[r1];
#pragma unroll
        for (int jj = 0; jj < KT; ++jj)
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            dG[jj][q] *= decay(cu, c0, c1, J * kT + jb, jj, q, true);
            if (q < 2) rs0 = fmaf(dG[jj][q], G[jj][q], rs0);
            else rs1 = fmaf(dG[jj][q], G[jj][q], rs1);
          }
        product_split(accC, dG, Sn, LDN, jb, 2 * nk);          // dC_T += dG B_J
      }
      add_rows(hh, quad_sum(rs0), quad_sum(rs1));
      retire();
    }
  }
  {
    float* const out = dCp + ((static_cast<long long>(b) * nhb + hb) * nc + c) * Q * N;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int n = j * 8 + 2 * t;
      if (n >= N) continue;
      if (r0 < Q)
        *reinterpret_cast<float2*>(out + static_cast<long long>(r0) * N + n) =
            make_float2(accC[j][0], accC[j][1]);
      if (r1 < Q)
        *reinterpret_cast<float2*>(out + static_cast<long long>(r1) * N + n) =
            make_float2(accC[j][2], accC[j][3]);
    }
  }

  // ---- X: dX_T per head and the column terms of dcums ----
  for (int hh = 0; hh < nh; ++hh) {
    const int hs = nh + hh;
    const float* const cu = cub + (hs & 1) * Qp;
    const bf16* const Xs = Rp + (hs & 1) * kT * LDP;          // X_T
    float accX[PT][4];
#pragma unroll
    for (int j = 0; j < PT; ++j) accX[j][0] = accX[j][1] = accX[j][2] = accX[j][3] = 0.f;
#pragma unroll
    for (int k = 0; k < kNMax / kSC; ++k) {
      if (k >= nsc) continue;
      advance();
      const bf16* const st = stage_n();
      const int cw = min(kSC, N - k * kSC);
      // dX_T += B_T[:, kSC k..] dS[:, kSC k..]^T (dS stored [p][n]: the n-major operand)
#pragma unroll
      for (int kk2 = 0; kk2 < kSC / 16; ++kk2) {
        if (kk2 * 16 < cw) {
          uint32_t a[4];
          tc::ldsm_x4(a, Bs + an + k * kSC + kk2 * 16);
#pragma unroll
          for (int np = 0; np < P / 16; ++np) {
            uint32_t bh[4], bl[4];
            tc::ldsm_x4(bh, st + bts + np * 16 * kLdS + kk2 * 16);
            tc::ldsm_x4(bl, st + bts + (P + np * 16) * kLdS + kk2 * 16);
            mma_pair(accX[2 * np], accX[2 * np + 1], a, bh);
            mma_pair(accX[2 * np], accX[2 * np + 1], a, bl);
          }
        }
      }
      if (k == nsc - 1) {                  // dX_T = w o (B_T dS^T) so far
        const float last = cu[Q - 1];
        const float w0 = r0 < Q ? expf(last - cu[r0]) : 0.f;
        const float w1 = r1 < Q ? expf(last - cu[r1]) : 0.f;
#pragma unroll
        for (int j = 0; j < PT; ++j) {
          accX[j][0] *= w0;
          accX[j][1] *= w0;
          accX[j][2] *= w1;
          accX[j][3] *= w1;
        }
      }
      retire();
    }
    for (int I = tile; I < tiles; ++I) {
      advance();
      const bf16* const Sn = stage_n();                        // C_I
      const bf16* const Sp = stage_p();                        // dY_I
      float cs0 = 0.f, cs1 = 0.f;
#pragma unroll
      for (int ih = 0; ih < NS; ++ih) {
        const int ib = ih * KW;            // the sub-step's first query in the tile
        if (I * kT + ib + KW - 1 < T0 + wl) continue;   // every query precedes the warp's keys
        float Gt[KT][4], dGt[KT][4];
        scores(Gt, Bs, an, Sn, btn, LDN, ib, N);               // G^T = B_T C_I^T
        scores(dGt, Xs, ap, Sp, btp, LDP, ib, P);              // dM^T = X_T dY_I^T
        const float c0 = cu[r0], c1 = cu[r1];
#pragma unroll
        for (int jj = 0; jj < KT; ++jj)
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float l = decay(cu, c0, c1, I * kT + ib, jj, q, false);
            dGt[jj][q] *= l;
            if (q < 2) cs0 = fmaf(dGt[jj][q], Gt[jj][q], cs0);
            else cs1 = fmaf(dGt[jj][q], Gt[jj][q], cs1);
            Gt[jj][q] *= l;
          }
        product_split(accX, Gt, Sp, LDP, ib, PT);              // dX_T += (G o L)^T dY_I
      }
      add_rows(hh, -quad_sum(cs0), -quad_sum(cs1));
      retire();
    }
    bf16* const dx = dxdt + bhc_of(hh) * Q * P;
#pragma unroll
    for (int j = 0; j < PT; ++j) {
      const int col = j * 8 + 2 * t;
      if (r0 < Q)
        *reinterpret_cast<uint32_t*>(dx + static_cast<long long>(r0) * P + col) =
            tc::pack_bf16(accX[j][0], accX[j][1]);
      if (r1 < Q)
        *reinterpret_cast<uint32_t*>(dx + static_cast<long long>(r1) * P + col) =
            tc::pack_bf16(accX[j][2], accX[j][3]);
    }
  }

  // ---- B: dB_T (summed over the block's heads) and t ----
  float accB[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) accB[j][0] = accB[j][1] = accB[j][2] = accB[j][3] = 0.f;
  for (int hh = 0; hh < nh; ++hh) {
    const int hs = 2 * nh + hh;
    const float* const cu = cub + (hs & 1) * Qp;
    const bf16* const Xs = Rp + (hs & 1) * kT * LDP;          // X_T
    float td0 = 0.f, td1 = 0.f;            // t's row dot before w
#pragma unroll
    for (int k = 0; k < kNMax / kSC; ++k) {
      if (k >= nsc) continue;
      advance();
      const int cw = min(kSC, N - k * kSC);
      float tmp[ST][4];
#pragma unroll
      for (int j = 0; j < ST; ++j) tmp[j][0] = tmp[j][1] = tmp[j][2] = tmp[j][3] = 0.f;
      state_product(tmp, Xs, stage_n(), cw);                   // X_T dS[:, 32k..]
      const float last = cu[Q - 1];
      const float w0 = r0 < Q ? expf(last - cu[r0]) : 0.f;
      const float w1 = r1 < Q ? expf(last - cu[r1]) : 0.f;
#pragma unroll
      for (int jj = 0; jj < ST; ++jj) {
        if (jj * 8 < cw) {
          const int n = k * kSC + jj * 8 + 2 * t;
          const float2 b0 = bf2_at(Bs + l0 * LDN + n), b1 = bf2_at(Bs + l1 * LDN + n);
          td0 = fmaf(b0.x, tmp[jj][0], fmaf(b0.y, tmp[jj][1], td0));
          td1 = fmaf(b1.x, tmp[jj][2], fmaf(b1.y, tmp[jj][3], td1));
          const int o = k * ST + jj;       // a constant once unrolled
          accB[o][0] = fmaf(w0, tmp[jj][0], accB[o][0]);
          accB[o][1] = fmaf(w0, tmp[jj][1], accB[o][1]);
          accB[o][2] = fmaf(w1, tmp[jj][2], accB[o][2]);
          accB[o][3] = fmaf(w1, tmp[jj][3], accB[o][3]);
        }
      }
      if (k == nsc - 1) {                  // t out of dcums; the tile's sum of t: the warp's
        const float t0 = w0 * quad_sum(td0), t1 = w1 * quad_sum(td1);   // rows by a tree
        add_rows(hh, -t0, -t1);
        float ts = t == 0 ? t0 + t1 : 0.f;
        ts += __shfl_xor_sync(0xffffffffu, ts, 4);
        ts += __shfl_xor_sync(0xffffffffu, ts, 8);
        ts += __shfl_xor_sync(0xffffffffu, ts, 16);
        if (lane == 0) tsum[hh * 4 + warp] = ts;
      }
      retire();
    }
    for (int I = tile; I < tiles; ++I) {
      advance();
      const bf16* const Sn = stage_n();                        // C_I
#pragma unroll
      for (int ih = 0; ih < NS; ++ih) {
        const int ib = ih * KW;
        if (I * kT + ib + KW - 1 < T0 + wl) continue;   // every query precedes the warp's keys
        float dGt[KT][4];
        scores(dGt, Xs, ap, stage_p(), btp, LDP, ib, P);       // dM^T = X_T dY_I^T
        const float c0 = cu[r0], c1 = cu[r1];
#pragma unroll
        for (int jj = 0; jj < KT; ++jj)
#pragma unroll
          for (int q = 0; q < 4; ++q) dGt[jj][q] *= decay(cu, c0, c1, I * kT + ib, jj, q, false);
        product_split(accB, dGt, Sn, LDN, ib, 2 * nk);         // dB_T += dG^T C_I
      }
      retire();
    }
  }
  {
    float* const out = dBp + ((static_cast<long long>(b) * nhb + hb) * nc + c) * Q * N;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int n = j * 8 + 2 * t;
      if (n >= N) continue;
      if (r0 < Q)
        *reinterpret_cast<float2*>(out + static_cast<long long>(r0) * N + n) =
            make_float2(accB[j][0], accB[j][1]);
      if (r1 < Q)
        *reinterpret_cast<float2*>(out + static_cast<long long>(r1) * N + n) =
            make_float2(accB[j][2], accB[j][3]);
    }
  }
  if (t == 0) {                            // dcums of the lane's rows: the terms summed above
    for (int hh = 0; hh < nh; ++hh) {
      const long long bhcQ = bhc_of(hh) * Q;
      if (r0 < Q) dcums[bhcQ + r0] = rowt[hh * kT + l0];
      if (r1 < Q) dcums[bhcQ + r1] = rowt[hh * kT + l1];
    }
  }
  __syncthreads();
  if (threadIdx.x < nh) {
    const float* const ts = tsum + threadIdx.x * 4;
    sdot[bhc_of(threadIdx.x) * (tiles + slices) + tile] = ((ts[0] + ts[1]) + ts[2]) + ts[3];
  }
}

template <int P>
int launch_tc(const void* xdt, const void* Bm, const void* Cm, const void* cums, const void* dy,
              const void* dstate, void* dxdt, void* dB, void* dC, void* dcums, void* states,
              void* parts, void* sdot, long long B, long long H, long long nc, long long Q,
              long long N, cudaStream_t stream) {
  if (N % 16 != 0 || 2 * H > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const int h = static_cast<int>(H), n = static_cast<int>(nc), q = static_cast<int>(Q),
            nn = static_cast<int>(N);
  const size_t smem1 = products_tc_smem_bytes(P, q);
  const size_t smem3 = tiles_tc_smem_bytes(P, nn, q);
  if (smem1 > kMaxSmem || smem3 > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(ssd_bwd_products_tc<P>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem1));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(ssd_bwd_tiles_tc<P>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem3));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (q + kT - 1) / kT;
  const int nhb = (h + kHeadBlock - 1) / kHeadBlock;
  const long long PN = static_cast<long long>(P) * N;
  const long long n_state = B * H * nc * PN;
  float* own = static_cast<float*>(states);
  float* gterm = own + n_state;
  const long long n_part = B * nhb * nc * Q * N;
  float* dBp = static_cast<float*>(parts);
  float* dCp = dBp + n_part;
  const bf16* x = static_cast<const bf16*>(xdt);
  const bf16* Bb = static_cast<const bf16*>(Bm);
  const bf16* Cb = static_cast<const bf16*>(Cm);
  const bf16* g = static_cast<const bf16*>(dy);
  const float* cu = static_cast<const float*>(cums);
  float* sd = static_cast<float*>(sdot);

  ssd_bwd_products_tc<P><<<dim3(static_cast<unsigned>((N + kSlabN - 1) / kSlabN),
                                static_cast<unsigned>(2 * H), static_cast<unsigned>(B * nc)),
                           kTcThreads, smem1, stream>>>(x, Bb, Cb, cu, g, own, gterm, h, n, q,
                                                        nn);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = static_cast<int>((PN + kTcPassElems - 1) / kTcPassElems);
  const int slices = blocks * (kTcThreads / 32);
  ssd_bwd_pass_tc<<<dim3(static_cast<unsigned>(B * H), static_cast<unsigned>(blocks)),
                    kTcThreads, 0, stream>>>(cu, static_cast<const float*>(dstate), own, gterm,
                                             sd, n, q, static_cast<int>(PN), tiles, slices);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_bwd_tiles_tc<P><<<dim3(static_cast<unsigned>(tiles), static_cast<unsigned>(nhb),
                            static_cast<unsigned>(B * nc)),
                       kTcThreads, smem3, stream>>>(
      x, Bb, Cb, cu, g, own, gterm, static_cast<bf16*>(dxdt), static_cast<float*>(dcums), dBp,
      dCp, sd, h, n, q, nn, slices, dstate != nullptr);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long n_bc = B * nc * Q * N, n_bhc = B * H * nc;
  const long long total = n_bc + n_bhc;
  ssd_bwd_finish<bf16><<<static_cast<unsigned>((total + kThreads - 1) / kThreads), kThreads, 0,
                         stream>>>(dBp, dCp, sd, static_cast<bf16*>(dB), static_cast<bf16*>(dC),
                                   static_cast<float*>(dcums), n_bc, n_bhc, nhb, n, q, nn,
                                   tiles, slices);
  return static_cast<int>(cudaGetLastError());
}

// the shared memory a block and the resident blocks an SM of the three tensor-core launches
template <int P>
int occupancy_tc(int N, int Q, int* out) {
  const size_t smem1 = products_tc_smem_bytes(P, Q), smem3 = tiles_tc_smem_bytes(P, N, Q);
  if (smem1 > kMaxSmem || smem3 > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(ssd_bwd_products_tc<P>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem1));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(ssd_bwd_tiles_tc<P>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem3));
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(out + 1, ssd_bwd_products_tc<P>,
                                                        kTcThreads, smem1);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(out + 3, ssd_bwd_pass_tc, kTcThreads, 0);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(out + 5, ssd_bwd_tiles_tc<P>,
                                                        kTcThreads, smem3);
  out[0] = static_cast<int>(smem1);
  out[2] = 0;
  out[4] = static_cast<int>(smem3);
  return static_cast<int>(err);
}

// ------------------------------------------------------------------------------------------
// dispatch
// ------------------------------------------------------------------------------------------

template <typename T, int P>
int launch_route(const void* xdt, const void* Bm, const void* Cm, const void* cums,
                 const void* dy, const void* dstate, void* dxdt, void* dB, void* dC, void* dcums,
                 void* states, void* parts, void* sdot, long long B, long long H, long long nc,
                 long long Q, long long N, cudaStream_t stream) {
  if constexpr (std::is_same<T, float>::value)
    return launch<float, P>(xdt, Bm, Cm, cums, dy, dstate, dxdt, dB, dC, dcums, states, parts,
                            sdot, B, H, nc, Q, N, stream);
  else
    return launch_tc<P>(xdt, Bm, Cm, cums, dy, dstate, dxdt, dB, dC, dcums, states, parts, sdot,
                        B, H, nc, Q, N, stream);
}

template <typename T>
int dispatch(const void* xdt, const void* Bm, const void* Cm, const void* cums, const void* dy,
             const void* dstate, void* dxdt, void* dB, void* dC, void* dcums, void* states,
             void* parts, void* sdot, long long B, long long H, long long nc, long long Q,
             long long P, long long N, void* stream) {
  if (B <= 0 || H <= 0 || nc <= 0 || Q <= 0 || N <= 0) return static_cast<int>(cudaSuccess);
  if (N > kNMax || B > 65535 || H > 65535 || nc > 65535 || B * nc > 65535 ||
      B * H > INT32_MAX || Q > (1 << 20))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  switch (P) {
    case 16: return launch_route<T, 16>(xdt, Bm, Cm, cums, dy, dstate, dxdt, dB, dC, dcums,
                                        states, parts, sdot, B, H, nc, Q, N, s);
    case 32: return launch_route<T, 32>(xdt, Bm, Cm, cums, dy, dstate, dxdt, dB, dC, dcums,
                                        states, parts, sdot, B, H, nc, Q, N, s);
    case 64: return launch_route<T, 64>(xdt, Bm, Cm, cums, dy, dstate, dxdt, dB, dC, dcums,
                                        states, parts, sdot, B, H, nc, Q, N, s);
    case 128: return launch_route<T, 128>(xdt, Bm, Cm, cums, dy, dstate, dxdt, dB, dC, dcums,
                                          states, parts, sdot, B, H, nc, Q, N, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Plain C interface, loaded with ctypes.  xdt/dy/dxdt (B,H,nc,Q,P) and Bm/Cm/dBm/dCm (B,nc,Q,N)
// in one dtype; cums/dcums (B,H,nc,Q), dstate (B,H,P,N) (or null) and the workspaces f32; all
// contiguous (the wrapper checks).  Returns a cudaError_t.
extern "C" {

int ssd_scan_bwd_f32(const void* xdt, const void* Bm, const void* Cm, const void* cums,
                     const void* dy, const void* dstate, void* dxdt, void* dB, void* dC,
                     void* dcums, void* states, void* parts, void* sdot, long long B, long long H,
                     long long nc, long long Q, long long P, long long N, void* stream) {
  return dispatch<float>(xdt, Bm, Cm, cums, dy, dstate, dxdt, dB, dC, dcums, states, parts, sdot,
                         B, H, nc, Q, P, N, stream);
}

int ssd_scan_bwd_bf16(const void* xdt, const void* Bm, const void* Cm, const void* cums,
                      const void* dy, const void* dstate, void* dxdt, void* dB, void* dC,
                      void* dcums, void* states, void* parts, void* sdot, long long B,
                      long long H, long long nc, long long Q, long long P, long long N,
                      void* stream) {
  return dispatch<__nv_bfloat16>(xdt, Bm, Cm, cums, dy, dstate, dxdt, dB, dC, dcums, states,
                                 parts, sdot, B, H, nc, Q, P, N, stream);
}

// Six ints into `out`: the dynamic shared memory (bytes) a block and the resident blocks an SM of
// the bf16 route's chunk-products, state-passing and tile launches at (P, N, Q), on the current
// device.  Returns a cudaError_t (cudaErrorInvalidValue for sizes the route does not take).
int ssd_scan_bwd_bf16_occupancy(long long P, long long N, long long Q, void* out) {
  if (N <= 0 || N > kNMax || N % 16 != 0 || Q <= 0 || Q > (1 << 20))
    return static_cast<int>(cudaErrorInvalidValue);
  int* const o = static_cast<int*>(out);
  const int n = static_cast<int>(N), q = static_cast<int>(Q);
  switch (P) {
    case 16: return occupancy_tc<16>(n, q, o);
    case 32: return occupancy_tc<32>(n, q, o);
    case 64: return occupancy_tc<64>(n, q, o);
    case 128: return occupancy_tc<128>(n, q, o);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
