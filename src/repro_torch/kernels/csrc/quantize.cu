// Symmetric per-row int8 quantizer for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/quantize/kernel.py `quantize_fwd` (body
// `_quant_kernel`): scale = amax/127 (1 where the row is all zeros),
// q = clip(round(x / scale), -127, 127). On the serve path it quantizes each
// decoded token's k/v rows (rows = slots x kv heads, cols = head_dim) and
// the prefill cache at the KV pool's boundary.
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

#include "common.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr float kInv127 = 1.0f / 127.0f;   // rounded to f32 at compile time

template <typename T>
__global__ void quantize_rows_kernel(const T* __restrict__ x, int8_t* __restrict__ q,
                                     float* __restrict__ scale, int rows, int cols) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;
  const T* xr = x + static_cast<size_t>(row) * cols;
  float amax = 0.f;
  for (int c = lane; c < cols; c += 32) amax = fmaxf(amax, fabsf(repro::to_f32(xr[c])));
  amax = repro::warp_max(amax);
  const float s = amax > 0.f ? amax * kInv127 : 1.f;
  int8_t* qr = q + static_cast<size_t>(row) * cols;
  for (int c = lane; c < cols; c += 32) {
    const float v = rintf(repro::to_f32(xr[c]) / s);
    qr[c] = static_cast<int8_t>(fminf(fmaxf(v, -127.f), 127.f));
  }
  if (lane == 0) scale[row] = s;
}

template <typename T>
void launch(const void* x, int8_t* q, float* s, int rows, int cols, cudaStream_t stream) {
  const int blocks = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  quantize_rows_kernel<T><<<blocks, kWarpsPerBlock * 32, 0, stream>>>(
      static_cast<const T*>(x), q, s, rows, cols);
}

}  // namespace

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
