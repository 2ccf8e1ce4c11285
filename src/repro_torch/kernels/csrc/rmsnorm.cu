// RMSNorm forward for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/rmsnorm/kernel.py `rmsnorm_fwd` (body
// `_rmsnorm_kernel`): out = x * rsqrt(mean(x^2) + eps) * scale, in f32,
// written in x's dtype. On the port's paths it is every RMSNorm of the
// dense and Mamba-2 stacks (models/layers.py `apply_norm`): ln1 and ln2 of
// each attention layer, ln1 of each SSD layer and the final norm, in the
// train step (forward and the checkpointed layers' recompute), the forward
// pass, prefill and decode.
//
// Bound on this card: bytes. Each row is read and written once (2 * d
// elements) for ~4 operations per element, far below the ~295 operations
// per byte where HBM stops being the limit: at [4096, 5120] bf16 that is
// 2 * 2 * 4096 * 5120 + 4 * 5120 bytes, 0.025 ms at 3.35 TB/s.
//
// Design. One row per warp, 8 warps per block, as quantize.cu does: the
// sum of squares is a warp shuffle reduction with no shared memory and no
// block barrier. Where the row and the pointers allow, each lane moves 16
// bytes at a time (8 bf16 or 4 f32), neighbouring lanes on neighbouring
// vectors; otherwise elements one by one. The sum of squares is f32; then
// mean = sum / d (an IEEE division, as jnp.mean divides) and r = rsqrt(mean
// + eps); a second pass re-reads the row (from L1/L2 where it is still
// there) and writes (x * r) * scale in that order, rounded to x's type
// once. The TPU kernel holds a block of rows whole in VMEM; here a row
// stays in one warp and nothing is kept in shared memory.

#include "common.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;

template <typename T, bool kVector>
__global__ void rmsnorm_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                               T* __restrict__ out, int rows, int d, float eps) {
  constexpr int kVec = 16 / sizeof(T);   // elements per 16-byte vector
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;
  const T* xr = x + static_cast<size_t>(row) * d;
  T* orow = out + static_cast<size_t>(row) * d;

  float ss = 0.f;
  if (kVector) {
    const uint4* xv = reinterpret_cast<const uint4*>(xr);
    for (int i = lane; i < d / kVec; i += 32) {
      const uint4 raw = xv[i];
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int u = 0; u < kVec; ++u) {
        const float f = repro::to_f32(e[u]);
        ss += f * f;
      }
    }
  } else {
    for (int c = lane; c < d; c += 32) {
      const float f = repro::to_f32(xr[c]);
      ss += f * f;
    }
  }
  ss = repro::warp_sum(ss);
  const float r = rsqrtf(ss / static_cast<float>(d) + eps);

  if (kVector) {
    const uint4* xv = reinterpret_cast<const uint4*>(xr);
    const float4* sv = reinterpret_cast<const float4*>(scale);
    uint4* ov = reinterpret_cast<uint4*>(orow);
    for (int i = lane; i < d / kVec; i += 32) {
      const uint4 raw = xv[i];
      const T* e = reinterpret_cast<const T*>(&raw);
      float s[kVec];
#pragma unroll
      for (int w = 0; w < kVec / 4; ++w) {
        const float4 f4 = sv[i * (kVec / 4) + w];
        s[4 * w] = f4.x;
        s[4 * w + 1] = f4.y;
        s[4 * w + 2] = f4.z;
        s[4 * w + 3] = f4.w;
      }
      alignas(16) T o[kVec];
#pragma unroll
      for (int u = 0; u < kVec; ++u) o[u] = repro::from_f32<T>((repro::to_f32(e[u]) * r) * s[u]);
      ov[i] = *reinterpret_cast<const uint4*>(o);
    }
  } else {
    for (int c = lane; c < d; c += 32)
      orow[c] = repro::from_f32<T>((repro::to_f32(xr[c]) * r) * scale[c]);
  }
}

template <typename T>
void launch(const void* x, const float* scale, void* out, int rows, int d, float eps,
            cudaStream_t stream) {
  const auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  const bool vector = (d * sizeof(T)) % 16 == 0 && aligned(x) && aligned(scale) && aligned(out);
  const int blocks = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const T* xt = static_cast<const T*>(x);
  T* ot = static_cast<T*>(out);
  if (vector)
    rmsnorm_kernel<T, true><<<blocks, kWarpsPerBlock * 32, 0, stream>>>(xt, scale, ot, rows, d,
                                                                        eps);
  else
    rmsnorm_kernel<T, false><<<blocks, kWarpsPerBlock * 32, 0, stream>>>(xt, scale, ot, rows,
                                                                         d, eps);
}

}  // namespace

int repro::rmsnorm(const void* x, DType dtype, const float* scale, void* out, int rows, int d,
                   float eps, void* stream) {
  if (rows <= 0 || d <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32: launch<float>(x, scale, out, rows, d, eps, st); break;
    case kBF16: launch<__nv_bfloat16>(x, scale, out, rows, d, eps, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
