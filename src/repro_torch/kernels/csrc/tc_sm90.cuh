// Tensor-core building blocks shared by the bf16 routes of flash_attention.cu and ssd_scan.cu:
// cp.async copies into shared memory, ldmatrix fragment loads and the bf16 mma.sync with f32
// accumulation (m16n8k16).  Fragment layouts (PTX ISA, "mma.m16n8k16"), for lane l with
// g = l / 4 and t = l % 4:
//   A (16x16, row):  a0 = (g, 2t..2t+1)  a1 = (g+8, 2t..)  a2 = (g, 2t+8..)  a3 = (g+8, 2t+8..)
//   B (16x8, col):   b0 = (k 2t..2t+1, n g)  b1 = (k 2t+8.., n g)
//   C (16x8, f32):   c0,c1 = (g, 2t..2t+1)  c2,c3 = (g+8, 2t..2t+1)
// Each 32-bit register holds two bf16, the lower column (or k) index in the low half.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tc {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory; with `valid` false the destination is zero-filled and
// nothing is read (src must still be a valid address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(n)
               : "memory");
}

// 4 bytes, as cp_async16 (for arrays whose rows are not 16-byte aligned)
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  const int n = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows [r0, r0 + rows) of a row-major (n_rows, width) bf16 matrix into shared memory with row
// stride `ld` (elements), by 16-byte cp.async; rows at or past n_rows are zero.  width and ld
// are multiples of 8; the caller commits the group.
__device__ __forceinline__ void load_rows_async(bf16* dst, int ld, const bf16* __restrict__ src,
                                                int r0, int rows, int n_rows, int width) {
  const int cpr = width >> 3;  // 16-byte chunks a row
  for (int idx = threadIdx.x; idx < rows * cpr; idx += blockDim.x) {
    const int r = idx / cpr, ch = idx - r * cpr;
    const int row = r0 + r;
    const bool ok = row < n_rows;
    cp_async16(dst + r * ld + ch * 8, src + static_cast<long long>(ok ? row : 0) * width + ch * 8,
               ok);
  }
}

// four 8x8 b16 matrices; lanes 8i..8i+7 give the row addresses of matrix i
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

// Lane addresses for ldsm_x4 / ldsm_x4_t, as (row, column) offsets inside a 16x16 block of a
// row-major tile:
//  - frag_a: an A fragment of rows m, columns k (non-trans), or a pair of B fragments
//    (n tiles 0 and 1) of a tile stored [k][n] (trans, V in P.V);
//  - frag_bt: a pair of B fragments (n tiles 0 and 1) of a tile stored [n][k] (non-trans, K
//    in Q.K^T), or an A fragment of a tile stored [k][m] (trans).
__device__ __forceinline__ int frag_a_row(int lane) { return (lane & 7) + ((lane >> 3) & 1) * 8; }
__device__ __forceinline__ int frag_a_col(int lane) { return (lane >> 4) * 8; }
__device__ __forceinline__ int frag_bt_row(int lane) { return (lane & 7) + (lane >> 4) * 8; }
__device__ __forceinline__ int frag_bt_col(int lane) { return ((lane >> 3) & 1) * 8; }

// c += a * b  (m16n8k16, bf16 inputs, f32 accumulation)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x in one MUFU instruction (relative error about 2^-22; results below 2^-126 flush to 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// (x, y) rounded to bf16, x in the low half
__device__ __forceinline__ uint32_t pack_bf16(float x, float y) {
  return as_u32(__floats2bfloat162_rn(x, y));
}

// (x, y) as hi + lo, each a bf16 pair: hi = bf16(v), lo = bf16(v - hi).  hi + lo carries about
// 16 significant bits of v, so a product of lo and hi with an exact bf16 operand, summed in
// f32, keeps v to a relative 2^-16 or so.
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  hi = as_u32(h);
  lo = pack_bf16(x - hf.x, y - hf.y);
}

}  // namespace tc
