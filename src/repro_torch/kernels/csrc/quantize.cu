// Symmetric per-row int8 quantizer and dequantizer for Hopper (sm_90a).
//
// quantize_rows replaces: src/repro/kernels/quantize/kernel.py
// `quantize_fwd` (body `_quant_kernel`): scale = amax/127 (1 where the row
// is all zeros), q = clip(round(x / scale), -127, 127). On the serve path it
// quantizes each decoded token's k/v rows (rows = slots x kv heads, cols =
// head_dim) and the prefill cache at the KV pool's boundary; on DDL's
// compressed pod hop each [rows, 1024] slice of a gradient shard.
//
// dequantize_rows replaces: the same file's `dequantize_fwd` (body
// `_dequant_kernel`): out = (f32(q) * scale[row]) cast to out's type. DDL's
// pod hop runs it once per pod on each compressed slice it receives.
//
// Bound on this card: bytes. A row is read, its codes written and one
// scale written: (in_bytes + 1) * cols + 4 bytes for ~4 operations per
// element, far below the ~295 operations per byte where HBM stops being
// the limit. The design keeps each row in one warp: the amax is a warp
// shuffle reduction with no shared memory and no block barrier, and the
// second pass re-reads the row from L1. Loads are lane-interleaved, so a
// warp reads 32 neighbouring elements per step.
//
// Codes and scales must equal the plain version's bitwise. The scale is
// amax times the f32 constant 1/127, because XLA compiles the JAX
// package's `amax / 127.0` into exactly that multiplication; x / scale is
// an IEEE division (no fast math); rintf rounds half to even as
// torch.round and jnp.round do; the clamp and int8 conversion are exact.
// Non-finite rows take the reference's values: the amax keeps a NaN (as
// jnp.max and torch.amax do), so a row holding one gets scale 1; a NaN
// quotient (a NaN element, or an infinity over an infinite scale) gets
// code 0, as the JAX package's jitted float -> int8 conversion gives; so a
// row holding an infinity and no NaN gets scale inf and all codes 0.

#include "common.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr float kInv127 = 1.0f / 127.0f;   // rounded to f32 at compile time

// max that returns NaN when either operand is one (fmaxf drops it)
__device__ __forceinline__ float max_nan(float a, float b) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

template <typename T>
__global__ void quantize_rows_kernel(const T* __restrict__ x, int8_t* __restrict__ q,
                                     float* __restrict__ scale, int rows, int cols) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;
  const T* xr = x + static_cast<size_t>(row) * cols;
  float amax = 0.f;
  for (int c = lane; c < cols; c += 32) amax = max_nan(amax, fabsf(repro::to_f32(xr[c])));
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) amax = max_nan(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  const float s = amax > 0.f ? amax * kInv127 : 1.f;   // NaN > 0 is false: scale 1
  int8_t* qr = q + static_cast<size_t>(row) * cols;
  for (int c = lane; c < cols; c += 32) {
    const float v = rintf(repro::to_f32(xr[c]) / s);
    qr[c] = v != v ? 0 : static_cast<int8_t>(fminf(fmaxf(v, -127.f), 127.f));
  }
  if (lane == 0) scale[row] = s;
}

template <typename T>
void launch(const void* x, int8_t* q, float* s, int rows, int cols, cudaStream_t stream) {
  const int blocks = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  quantize_rows_kernel<T><<<blocks, kWarpsPerBlock * 32, 0, stream>>>(
      static_cast<const T*>(x), q, s, rows, cols);
}

// ---------------------------------------------------------------------------
// dequantize_rows
//
// Bound on this card: bytes. Each code is read once (1 B) and each output
// written once (4 B for f32, 2 for bf16), plus 4 B of scale a row, for one
// multiply an element. So each thread takes 16 codes: one 16-byte load,
// 16 multiplies by its row's scale, and 16-byte stores (four for f32, two
// for bf16), neighbouring threads on neighbouring addresses. The scale is
// read once a thread, from L1/L2 after the row's first thread. Rows whose
// width is not a multiple of 16, or buffers not 16-byte aligned, take a
// thread per element instead.
//
// The output must equal the plain version's bitwise: f32(q) is exact, the
// product is one IEEE multiply rounded to nearest (__fmul_rn, so the
// compiler cannot fuse it), and the bf16 cast rounds to nearest even, as
// torch's and JAX's casts do.

constexpr int kDequantThreads = 256;

template <typename T>
__device__ __forceinline__ void store16(T* out, const float (&v)[16]);

template <>
__device__ __forceinline__ void store16<float>(float* out, const float (&v)[16]) {
  float4* o = reinterpret_cast<float4*>(out);
#pragma unroll
  for (int k = 0; k < 4; ++k) o[k] = make_float4(v[4 * k], v[4 * k + 1], v[4 * k + 2], v[4 * k + 3]);
}

template <>
__device__ __forceinline__ void store16<__nv_bfloat16>(__nv_bfloat16* out, const float (&v)[16]) {
  __align__(16) __nv_bfloat16 b[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) b[k] = __float2bfloat16_rn(v[k]);
  const int4* src = reinterpret_cast<const int4*>(b);
  int4* o = reinterpret_cast<int4*>(out);
  o[0] = src[0];
  o[1] = src[1];
}

// one thread per 16 codes of a row: n16 = rows * cols / 16 groups
template <typename T>
__global__ void dequantize_rows_vec16_kernel(const int8_t* __restrict__ q,
                                             const float* __restrict__ scale,
                                             T* __restrict__ out, int64_t n16, int groups_per_row) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kDequantThreads + threadIdx.x;
  if (i >= n16) return;
  const float s = scale[i / groups_per_row];
  const int4 packed = reinterpret_cast<const int4*>(q)[i];
  const int8_t* c = reinterpret_cast<const int8_t*>(&packed);
  float v[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) v[k] = __fmul_rn(static_cast<float>(c[k]), s);
  store16<T>(out + i * 16, v);
}

// one thread per element, for any width and alignment
template <typename T>
__global__ void dequantize_rows_scalar_kernel(const int8_t* __restrict__ q,
                                              const float* __restrict__ scale,
                                              T* __restrict__ out, int64_t n, int cols) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kDequantThreads + threadIdx.x;
  if (i >= n) return;
  out[i] = repro::from_f32<T>(__fmul_rn(static_cast<float>(q[i]), scale[i / cols]));
}

template <typename T>
void launch_dequant(const int8_t* q, const float* s, void* out, int rows, int cols,
                    cudaStream_t stream) {
  T* o = static_cast<T*>(out);
  const int64_t n = static_cast<int64_t>(rows) * cols;
  const bool aligned = (reinterpret_cast<uintptr_t>(q) % 16 == 0) &&
                       (reinterpret_cast<uintptr_t>(out) % 16 == 0);
  if (cols % 16 == 0 && aligned) {
    const int64_t n16 = n / 16;
    const int64_t blocks = (n16 + kDequantThreads - 1) / kDequantThreads;
    dequantize_rows_vec16_kernel<T><<<static_cast<unsigned>(blocks), kDequantThreads, 0, stream>>>(
        q, s, o, n16, cols / 16);
  } else {
    const int64_t blocks = (n + kDequantThreads - 1) / kDequantThreads;
    dequantize_rows_scalar_kernel<T><<<static_cast<unsigned>(blocks), kDequantThreads, 0, stream>>>(
        q, s, o, n, cols);
  }
}

}  // namespace

int repro::dequantize_rows(const int8_t* q, const float* s, void* out, DType out_dtype, int rows,
                           int cols, void* stream) {
  if (rows <= 0 || cols <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (out_dtype) {
    case kF32: launch_dequant<float>(q, s, out, rows, cols, st); break;
    case kBF16: launch_dequant<__nv_bfloat16>(q, s, out, rows, cols, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

int repro::quantize_rows(const void* x, DType x_dtype, int8_t* q, float* s, int rows,
                         int cols, void* stream) {
  if (rows <= 0 || cols <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (x_dtype) {
    case kF32: launch<float>(x, q, s, rows, cols, st); break;
    case kBF16: launch<__nv_bfloat16>(x, q, s, rows, cols, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
