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
// byte, above even the bf16 tensor cores' balance point, and on the CUDA cores (67 TFLOP/s in
// f32) far above it.
//
// What the design does about it (simple and right first, on the CUDA cores, every product an
// f32 fma from tiles in shared memory; the tensor cores are a later change).  Four launches on
// the caller's stream behind one call:
//   1. chunk products, parallel over (chunk, head, batch): each chunk's own state X^T (B o w)
//      and its state-gradient term dY^T (C o exp(cu)), (P, N) f32 each, into a workspace;
//   2. state passing, one block per (b, h) and 1024 state elements: the forward pass turns the chunk states into the
//      state entering each chunk (recomputed, not taken from the forward: the forward keeps no
//      workspace on its f32 route, and this keeps the saved tensors to the four inputs), the
//      reverse pass turns the gradient terms into the gradient of the state leaving each chunk,
//      both in place, and each chunk's exp(cu_last)<dS, s> over the block's elements (a
//      fixed-order block sum);
//   3. tile gradients, parallel over (64-row tile T, block of 8 heads, (b, chunk)): for each
//      head, the row pass walks the key tiles J <= T (G_TJ and dM_TJ formed 64x64 from the
//      tiles, masked and decayed into dG_TJ; dC_T += dG_TJ B_J; the row sums), then adds the
//      (dY s) terms; the column pass walks the query tiles I >= T (G o L and dG for the pair;
//      dX_T += (G o L)^T dY_I; dB_T += dG^T C_I; the column sums), then adds the dS terms and
//      t.  dX and dcums of the tile are stored per head; dB and dC are summed over the block's
//      heads in registers and stored as the head block's partial;
//   4. finish: dB and dC summed over the head blocks in order and stored in the inputs' dtype;
//      the last position of each chunk's dcums gets sum_j t_j and exp(cu_last)<dS, s>.
// No float atomics anywhere: every sum has a fixed order, so two calls give the same bits.
// Thread layout of every 64-row product: 256 threads as 16 x 16, thread (ty, tx) holds rows
// 4ty..4ty+3 and columns tx + 16k; tiles in shared memory are rows padded by one float, so a
// half-warp reading 16 rows at one column hits 16 banks.
//
// Sizes: P in {16, 32, 64, 128}; N <= 128; any Q and nc.  Shared memory of launch 3 is
// (2(N+1) + 2(P+1) + 2*65) 64 + Q + 1024 + 64*(8+2) floats (140 KiB at P 64, N 128, Q 256);
// above a block's 227 KiB, or N above 128, the call is refused with cudaErrorInvalidValue.
//
// The kernels allocate nothing and never synchronise: the wrapper (ssd_scan/kernel.py) passes
// the workspaces (chunk states and state gradients (2,B,H,nc,P,N), head-block partials of dB and
// dC (2,B,ceil(H/8),nc,Q,N), per chunk each tile's sum of t and each 1024-element slice's share of
// exp(cu_last)<dS, s> (B,H,nc,tiles+slices), all f32).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
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
    case 16: return launch<T, 16>(xdt, Bm, Cm, cums, dy, dstate, dxdt, dB, dC, dcums, states,
                                  parts, sdot, B, H, nc, Q, N, s);
    case 32: return launch<T, 32>(xdt, Bm, Cm, cums, dy, dstate, dxdt, dB, dC, dcums, states,
                                  parts, sdot, B, H, nc, Q, N, s);
    case 64: return launch<T, 64>(xdt, Bm, Cm, cums, dy, dstate, dxdt, dB, dC, dcums, states,
                                  parts, sdot, B, H, nc, Q, N, s);
    case 128: return launch<T, 128>(xdt, Bm, Cm, cums, dy, dstate, dxdt, dB, dC, dcums, states,
                                    parts, sdot, B, H, nc, Q, N, s);
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

}  // extern "C"
