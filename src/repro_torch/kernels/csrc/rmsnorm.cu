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
// Design (the row-in-registers path, rows of 16-byte vectors on 16-byte
// aligned pointers). Each row is read from memory once: a group of W warps
// holds it in registers, each lane up to kMaxV vectors (d 5120 in bf16:
// one warp, 20 vectors = 160 values a lane), every load of the row issued
// by one fully unrolled loop before the reduction, so a warp has the whole
// row in flight. The sum of squares is a warp shuffle reduction and, for
// W > 1 (f32 at d 5120: two warps; d up to 8192 and beyond), a sum of the
// group's W warp sums through shared memory in a fixed order. Then mean =
// sum / d (an IEEE division, as jnp.mean divides), r = rsqrt(mean + eps),
// and (x * r) * scale in that order, rounded to x's type once, written from
// the registers. Blocks are persistent, a few an SM, and walk the rows at a
// grid stride; each stages the f32 scale into shared memory once, while its
// first rows' loads are in flight, instead of every warp re-reading it from
// L2 for every row. `ops.rmsnorm_layout` picks W (the fewest warps whose
// lanes hold the row in at most 20 vectors) and passes it here.
//
// Other rows (a width that is not a whole number of vectors, an unaligned
// pointer, a row wider than a block's registers) take the element path:
// one row a warp, element by element, the sum of squares on a first pass
// and the output on a second. The TPU kernel holds a block of rows whole in
// VMEM; here a row stays in its warps' registers.

#include "common.cuh"

namespace {

constexpr int kWarps = 8;                     // warps of a block
constexpr int kThreads = kWarps * 32;
constexpr int kMaxSmem = 232448;

// ---- row-in-registers path -------------------------------------------------

template <typename T, int kMaxV>
__global__ void __launch_bounds__(kThreads)
    rmsnorm_rows_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                        T* __restrict__ out, int rows, int d, int W, float eps) {
  constexpr int kVec = 16 / sizeof(T);        // elements per 16-byte vector
  extern __shared__ __align__(16) float4 scale_s[];   // [d / 4]
  __shared__ float part[2][kWarps];           // warp sums, by parity of the row step
  const int nvec = d / kVec;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int group = warp / W;                 // the row group of this warp
  const int gl = (warp - group * W) * 32 + lane;   // lane within the group
  const int gthreads = W * 32;
  const int rpb = kWarps / W;                 // rows a block takes a step
  bool staged = false;
  int parity = 0;
  // every block takes at least one step and all its threads take the same
  // steps, so the barriers below are reached by the whole block
  for (int base = blockIdx.x * rpb; base < rows; base += gridDim.x * rpb) {
    const int row = base + group;
    const bool live = row < rows;
    const uint4* xr = reinterpret_cast<const uint4*>(x + static_cast<size_t>(live ? row : 0) * d);
    uint4 v[kMaxV];
#pragma unroll
    for (int u = 0; u < kMaxV; ++u) {
      const int i = gl + u * gthreads;
      v[u] = live && i < nvec ? __ldcs(xr + i) : make_uint4(0, 0, 0, 0);
    }
    if (!staged) {   // the scale, once a block, while the first rows are in flight
      const float4* s4 = reinterpret_cast<const float4*>(scale);
      for (int i = threadIdx.x; i < d / 4; i += kThreads) scale_s[i] = s4[i];
      __syncthreads();
      staged = true;
    }
    float ss = 0.f;
#pragma unroll
    for (int u = 0; u < kMaxV; ++u) {
      const T* e = reinterpret_cast<const T*>(&v[u]);
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        const float f = repro::to_f32(e[k]);
        ss += f * f;
      }
    }
    ss = repro::warp_sum(ss);
    if (W > 1) {
      if (lane == 0) part[parity][warp] = ss;
      __syncthreads();
      ss = 0.f;
      for (int w = 0; w < W; ++w) ss += part[parity][group * W + w];
      parity ^= 1;
    }
    const float r = rsqrtf(ss / static_cast<float>(d) + eps);
    uint4* orow = reinterpret_cast<uint4*>(out + static_cast<size_t>(live ? row : 0) * d);
#pragma unroll
    for (int u = 0; u < kMaxV; ++u) {
      const int i = gl + u * gthreads;
      if (!live || i >= nvec) continue;
      const T* e = reinterpret_cast<const T*>(&v[u]);
      alignas(16) T o[kVec];
#pragma unroll
      for (int w = 0; w < kVec / 4; ++w) {
        const float4 s = scale_s[i * (kVec / 4) + w];
        o[4 * w] = repro::from_f32<T>((repro::to_f32(e[4 * w]) * r) * s.x);
        o[4 * w + 1] = repro::from_f32<T>((repro::to_f32(e[4 * w + 1]) * r) * s.y);
        o[4 * w + 2] = repro::from_f32<T>((repro::to_f32(e[4 * w + 2]) * r) * s.z);
        o[4 * w + 3] = repro::from_f32<T>((repro::to_f32(e[4 * w + 3]) * r) * s.w);
      }
      __stcs(orow + i, *reinterpret_cast<const uint4*>(o));
    }
  }
}

// Launch with the smallest kMaxV bucket holding v vectors a lane. Blocks:
// as many as fit on the card at once, at most one per step of rows.
template <typename T, int kMaxV>
int launch_rows(const T* x, const float* scale, T* out, int rows, int d, int W,
                float eps, cudaStream_t stream) {
  auto kernel = rmsnorm_rows_kernel<T, kMaxV>;
  const size_t smem = static_cast<size_t>(d) * 4;
  static size_t opted_in = 48 * 1024;
  if (smem > opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in = smem;
  }
  // SMs of the card and blocks an SM at this shared memory, asked once
  static int sms = 0, per_sm = 0;
  static size_t per_sm_smem = 0;
  if (!sms) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (per_sm_smem != smem) {
    const cudaError_t err =
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    per_sm_smem = smem;
  }
  const int rpb = kWarps / W;
  const int steps = (rows + rpb - 1) / rpb;
  const int resident = sms * (per_sm > 0 ? per_sm : 1);
  const int blocks = steps < resident ? steps : resident;
  kernel<<<blocks, kThreads, smem, stream>>>(x, scale, out, rows, d, W, eps);
  return 0;
}

// ---- element path ----------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads)
    rmsnorm_elements_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                            T* __restrict__ out, int rows, int d, float eps) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  const T* xr = x + static_cast<size_t>(row) * d;
  T* orow = out + static_cast<size_t>(row) * d;
  float ss = 0.f;
  for (int c = lane; c < d; c += 32) {
    const float f = repro::to_f32(xr[c]);
    ss += f * f;
  }
  ss = repro::warp_sum(ss);
  const float r = rsqrtf(ss / static_cast<float>(d) + eps);
  for (int c = lane; c < d; c += 32)
    orow[c] = repro::from_f32<T>((repro::to_f32(xr[c]) * r) * scale[c]);
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <typename T>
int launch(const void* x, const float* scale, void* out, int rows, int d, int W, float eps,
           cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  T* ot = static_cast<T*>(out);
  if (W == 0) {
    rmsnorm_elements_kernel<T><<<(rows + kWarps - 1) / kWarps, kThreads, 0, stream>>>(
        xt, scale, ot, rows, d, eps);
    return 0;
  }
  // the row-in-registers path: what ops.rmsnorm_layout promised, checked
  constexpr int kVec = 16 / sizeof(T);
  if ((W != 1 && W != 2 && W != 4 && W != 8) || d % kVec || static_cast<size_t>(d) * 4 > kMaxSmem ||
      !aligned16(x) || !aligned16(scale) || !aligned16(out))
    return static_cast<int>(cudaErrorInvalidValue);
  const int v = (d / kVec + 32 * W - 1) / (32 * W);   // vectors a lane
  if (v <= 4) return launch_rows<T, 4>(xt, scale, ot, rows, d, W, eps, stream);
  if (v <= 8) return launch_rows<T, 8>(xt, scale, ot, rows, d, W, eps, stream);
  if (v <= 12) return launch_rows<T, 12>(xt, scale, ot, rows, d, W, eps, stream);
  if (v <= 16) return launch_rows<T, 16>(xt, scale, ot, rows, d, W, eps, stream);
  if (v <= 20) return launch_rows<T, 20>(xt, scale, ot, rows, d, W, eps, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

int repro::rmsnorm(const void* x, DType dtype, const float* scale, void* out, int rows, int d,
                   int warps_per_row, float eps, void* stream) {
  if (rows <= 0 || d <= 0 || warps_per_row < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int err;
  switch (dtype) {
    case kF32: err = launch<float>(x, scale, out, rows, d, warps_per_row, eps, st); break;
    case kBF16:
      err = launch<__nv_bfloat16>(x, scale, out, rows, d, warps_per_row, eps, st);
      break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != 0) return err;
  return static_cast<int>(cudaGetLastError());
}
