// Block-wise int8 quantize / dequantize for the quant8+zstd codec, hand-written for Hopper
// (sm_90a).
//
// Replaces the Pallas kernels `quantize_kernel` (src/repro/kernels/quant_blockwise/kernel.py:27,
// body `_quant_kernel` :15) and `dequantize_kernel` (:42, body `_dequant_kernel` :23).
// Per 1024-element row: amax = max|x| in f32 (NaN propagates, as jnp.max does);
// scale = amax * f32(1/127), or 1.0 unless amax > 0 (the reference's XLA rewrites its
// amax / 127 into that product, which differs from IEEE division in the last bit);
// q = clip(round-half-even(x / scale), -127, 127) as int8, with a NaN quotient stored
// as 0 (XLA's float->int conversion).  Dequantize is
// x = q * scale in f32, cast to the output type (round to nearest even for bf16).
//
// What bounds it: bytes.  Quantize reads 4 (f32) or 2 (bf16) bytes and writes 1 per element,
// with one division each; dequantize the reverse.  Both sit far below the card's f32 rate per
// byte, so the HBM rate is the roofline.
//
// What the design does about it: one 256-thread block per row, each thread moves its four
// elements with one vector load and one vector store (16 B of f32, 8 B of bf16, 4 B of int8),
// neighbouring threads on neighbouring addresses.  amax is reduced in registers, across the
// warp with __shfl_xor_sync, then across the eight warps through shared memory.
//
// Numerics: the quotient x / scale is an IEEE division (__fdiv_rn), rounded with rintf.
// The file must never be compiled with --use_fast_math: q has to match the reference at
// the ties, and the chunk keys hash q.
// The kernel allocates nothing and never synchronises; it runs on the caller's stream.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 1024;       // elements per row (quant_blockwise.ops.BLOCK)
constexpr int kThreads = 256;      // four elements per thread
constexpr int kWarps = kThreads / 32;
constexpr float kInv127 = 1.0f / 127.0f;   // correctly rounded f32, as XLA folds it

// max that propagates NaN, like jnp.max (fmaxf would drop it)
__device__ __forceinline__ float nanmax(float a, float b) {
  return (a > b || isnan(a)) ? a : b;
}

__device__ __forceinline__ float4 load4(const float* row, int t) {
  return reinterpret_cast<const float4*>(row)[t];
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* row, int t) {
  // bf16 -> f32 is exact: the 16 bits become the high half of the f32 word
  const uint2 raw = reinterpret_cast<const uint2*>(row)[t];
  return make_float4(__uint_as_float(raw.x << 16), __uint_as_float(raw.x & 0xffff0000u),
                     __uint_as_float(raw.y << 16), __uint_as_float(raw.y & 0xffff0000u));
}

__device__ __forceinline__ void store4(float* row, int t, float a, float b, float c, float d) {
  reinterpret_cast<float4*>(row)[t] = make_float4(a, b, c, d);
}

__device__ __forceinline__ uint32_t bf16_bits(float v) {
  const __nv_bfloat16 b = __float2bfloat16_rn(v);
  return static_cast<uint32_t>(*reinterpret_cast<const unsigned short*>(&b));
}

__device__ __forceinline__ void store4(__nv_bfloat16* row, int t, float a, float b, float c,
                                       float d) {
  reinterpret_cast<uint2*>(row)[t] =
      make_uint2(bf16_bits(a) | (bf16_bits(b) << 16), bf16_bits(c) | (bf16_bits(d) << 16));
}

__device__ __forceinline__ signed char quant1(float x, float scale) {
  const float r = rintf(__fdiv_rn(x, scale));
  if (isnan(r)) return 0;
  return static_cast<signed char>(fminf(fmaxf(r, -127.f), 127.f));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
quantize_rows_kernel(const T* __restrict__ x, int8_t* __restrict__ q, float* __restrict__ scale) {
  __shared__ float warp_max[kWarps];
  const long long row = blockIdx.x;
  const int t = threadIdx.x;
  const float4 v = load4(x + row * kBlock, t);
  float m = nanmax(nanmax(fabsf(v.x), fabsf(v.y)), nanmax(fabsf(v.z), fabsf(v.w)));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) m = nanmax(m, __shfl_xor_sync(0xffffffffu, m, off));
  if ((t & 31) == 0) warp_max[t >> 5] = m;
  __syncthreads();
  float amax = warp_max[0];
#pragma unroll
  for (int i = 1; i < kWarps; ++i) amax = nanmax(amax, warp_max[i]);
  const float s = amax > 0.f ? __fmul_rn(amax, kInv127) : 1.f;
  char4 out;
  out.x = quant1(v.x, s);
  out.y = quant1(v.y, s);
  out.z = quant1(v.z, s);
  out.w = quant1(v.w, s);
  reinterpret_cast<char4*>(q + row * kBlock)[t] = out;
  if (t == 0) scale[row] = s;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
dequantize_rows_kernel(const int8_t* __restrict__ q, const float* __restrict__ scale,
                       T* __restrict__ x) {
  const long long row = blockIdx.x;
  const int t = threadIdx.x;
  const float s = scale[row];
  const char4 c = reinterpret_cast<const char4*>(q + row * kBlock)[t];
  store4(x + row * kBlock, t, __fmul_rn(static_cast<float>(c.x), s),
         __fmul_rn(static_cast<float>(c.y), s), __fmul_rn(static_cast<float>(c.z), s),
         __fmul_rn(static_cast<float>(c.w), s));
}

template <typename T>
int launch_quantize(const void* x, void* q, void* scale, long long nb, void* stream) {
  if (nb <= 0) return static_cast<int>(cudaSuccess);
  quantize_rows_kernel<T><<<static_cast<unsigned>(nb), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<int8_t*>(q), static_cast<float*>(scale));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_dequantize(const void* q, const void* scale, void* x, long long nb, void* stream) {
  if (nb <= 0) return static_cast<int>(cudaSuccess);
  dequantize_rows_kernel<T><<<static_cast<unsigned>(nb), kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(q), static_cast<const float*>(scale), static_cast<T*>(x));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface, loaded with ctypes.  x: (nb, 1024) f32 or bf16; q: (nb, 1024) int8;
// scale: (nb,) f32.  Every pointer is 16-byte aligned (the wrapper checks).
// Returns cudaGetLastError().
extern "C" {

int quantize_rows_f32(const void* x, void* q, void* scale, long long nb, void* stream) {
  return launch_quantize<float>(x, q, scale, nb, stream);
}

int quantize_rows_bf16(const void* x, void* q, void* scale, long long nb, void* stream) {
  return launch_quantize<__nv_bfloat16>(x, q, scale, nb, stream);
}

int dequantize_rows_f32(const void* q, const void* scale, void* x, long long nb, void* stream) {
  return launch_dequantize<float>(q, scale, x, nb, stream);
}

int dequantize_rows_bf16(const void* q, const void* scale, void* x, long long nb, void* stream) {
  return launch_dequantize<__nv_bfloat16>(q, scale, x, nb, stream);
}

}  // extern "C"
