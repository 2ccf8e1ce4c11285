// Symmetric per-row int8 quantizer and dequantizer for Hopper (sm_90a).
//
// quantize_rows replaces: src/repro/kernels/quantize/kernel.py
// `quantize_fwd` (body `_quant_kernel`): scale = amax/127 (1 where the row
// is all zeros), q = clip(round(x / scale), -127, 127). It serves the KV
// pool's quantize of a prefill cache at its boundary ([rows, head_dim]
// bf16) and DDL's compressed pod hop ([rows, 1024] f32 slices of a
// gradient shard).
//
// quantize_kv_write is the same quantizer fused with the decode step's
// cache write: each slot's new k and v rows [B, 1, K, D] quantized, and
// codes and scales written into the int8 cache at the slot's position, in
// one launch, where the plain step quantizes k and v and then writes the
// codes and the scales with four gather/where/scatter passes.
//
// dequantize_rows replaces: the same file's `dequantize_fwd` (body
// `_dequant_kernel`): out = (f32(q) * scale[row]) cast to out's type; it
// serves error feedback's local dequantize. dequantize_sum_rows is its pod
// sum: out[i] = ((0 + q_0[i] s_0) + q_1[i] s_1) + ... in pod order, the
// whole of the pod hop's dequantize-and-add loop in one pass.
//
// Bound on this card: bytes, for all four. A quantized row is read once,
// its codes written and one scale written: (in_bytes + 1) * cols + 4 bytes
// for ~5 operations an element; a dequantized element reads 1 B of code
// per pod and writes 4 B (f32) or 2 B (bf16) for a multiply and an add per
// pod; both are far below the ~295 operations per byte where HBM stops
// being the limit.
//
// Design of the quantizer (the row-in-registers path: rows of whole
// 16-byte vectors on aligned pointers). A row is held by a group of L
// lanes (a power of two, L <= 32, groups aligned in the warp), each lane
// holding up to V 16-byte vectors in registers, all loads made by one
// unrolled loop: [*, 1024] f32 is one warp a row, 8 vectors (32 values) a
// lane; [*, 128] bf16 half a warp a row, one vector a lane, two rows a
// warp. Lane g of a group holds vectors g, g + L, ..., so each load of a
// warp reads one contiguous span. The amax is a `max.NaN` shuffle reduction
// over the group; then each lane writes the codes of a vector as one 4-byte
// (f32) or 8-byte (bf16) store, neighbouring lanes on neighbouring bytes.
// Rows are read and codes written with the evict-first cache hint (__ldcs,
// __stcs): each byte is touched once, and at the pod-hop slice the hints
// measured faster than plain loads and stores.
// `ops.quantize_layout` picks (L, V). Other rows (a width of no whole
// number of vectors, an unaligned pointer, a row wider than 32 lanes x 8
// vectors) take the element path: one row a warp, element by element, the
// amax on a first pass and the codes on a second that re-reads the row
// from L1.
//
// quantize_kv_write runs the same row code on 2 x B x K rows (K then V,
// each slot, each kv head), read through the rows' strides; a slot's
// destination is (table[b, pos / ps], pos % ps) of the cache's pages, or,
// with no table (slot-contiguous caches, one page a slot of ps = Smax
// positions), (b, min(pos, ps - 1)). An inactive slot writes nothing: the
// plain write puts the current value back, which leaves the same bytes.
// A position or table entry outside the cache traps (a device-side error,
// as the plain indexing raises), so the kernel never writes outside it. It
// reads positions, activity and the table on the device: the wrapper needs
// no value of them on the host.
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
//
// Design of the dequantizers (rows of a multiple of 4 codes on aligned
// pointers): one warp a row at a time, the warps walking the rows at a
// grid stride. A lane takes 4 codes (one 4-byte load) of each 128-code
// segment and writes them as one 16-byte f32 (8-byte bf16) store, so each
// load and each store of a warp is one contiguous span (128 B of codes,
// 512 B of f32); a lane starts the loads of up to 8 segments of a pod
// before it uses them, and reads a pod's row scale once per row. Outputs
// are written with the evict-first hint (__stcs), and the grid holds a
// warp a row up to 16 blocks an SM: both measured faster than plain
// stores and an occupancy-sized persistent grid. Other
// rows take an element a thread. Each product is one IEEE multiply
// (__fmul_rn) and each add of the pod sum one IEEE add (__fadd_rn), so the
// compiler cannot contract them into an FMA; the bf16 cast rounds to
// nearest even, as torch's and JAX's casts do.

#include <algorithm>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kInv127 = 1.0f / 127.0f;   // rounded to f32 at compile time

// max that returns NaN when either operand is one (fmaxf drops it)
__device__ __forceinline__ float max_nan(float a, float b) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

// the max over the `lanes` lanes of an aligned group (a power of two);
// every lane of the warp takes part
__device__ __forceinline__ float group_max(float v, int lanes) {
  for (int o = lanes >> 1; o > 0; o >>= 1) v = max_nan(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float row_scale(float amax) {
  return amax > 0.f ? amax * kInv127 : 1.f;   // NaN > 0 is false: scale 1
}

__device__ __forceinline__ int8_t code_of(float x, float s) {
  const float v = rintf(x / s);
  return v != v ? 0 : static_cast<int8_t>(fminf(fmaxf(v, -127.f), 127.f));
}

__device__ __forceinline__ uint32_t byte_of(float x, float s, int shift) {
  return static_cast<uint32_t>(static_cast<uint8_t>(code_of(x, s))) << shift;
}

// one 16-byte vector of a row: its elements as f32, and its codes as one store
template <typename T> struct Vec;

template <> struct Vec<float> {
  static constexpr int E = 4;
  __device__ static void load(const float* p, float (&f)[4]) {
    const float4 v = __ldcs(reinterpret_cast<const float4*>(p));
    f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w;
  }
  __device__ static void store_codes(int8_t* q, const float (&f)[4], float s) {
    __stcs(reinterpret_cast<unsigned int*>(q),
           byte_of(f[0], s, 0) | byte_of(f[1], s, 8) | byte_of(f[2], s, 16) | byte_of(f[3], s, 24));
  }
};

template <> struct Vec<__nv_bfloat16> {
  static constexpr int E = 8;
  __device__ static void load(const __nv_bfloat16* p, float (&f)[8]) {
    const uint4 v = __ldcs(reinterpret_cast<const uint4*>(p));
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {        // a bf16's f32 value is its bits << 16
      f[2 * k] = __uint_as_float(w[k] << 16);
      f[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
    }
  }
  __device__ static void store_codes(int8_t* q, const float (&f)[8], float s) {
    uint2 c;
    c.x = byte_of(f[0], s, 0) | byte_of(f[1], s, 8) | byte_of(f[2], s, 16) | byte_of(f[3], s, 24);
    c.y = byte_of(f[4], s, 0) | byte_of(f[5], s, 8) | byte_of(f[6], s, 16) | byte_of(f[7], s, 24);
    __stcs(reinterpret_cast<uint2*>(q), c);
  }
};

// Quantize one row held by a group of `lanes` lanes, V vectors a lane (g:
// the lane in the group); with V == 0, by one warp element by element (g:
// the lane). Rows with `live` false take part in the group's shuffles
// only: no load, no store.
template <typename T, int V>
__device__ __forceinline__ void quantize_row(const T* __restrict__ xr, int8_t* __restrict__ qr,
                                             float* __restrict__ sr, int g, int lanes, int cols,
                                             bool live) {
  if constexpr (V == 0) {
    float amax = 0.f;
    if (live)
      for (int c = g; c < cols; c += 32) amax = max_nan(amax, fabsf(repro::to_f32(xr[c])));
    const float s = row_scale(group_max(amax, 32));
    if (!live) return;
    for (int c = g; c < cols; c += 32) qr[c] = code_of(repro::to_f32(xr[c]), s);
    if (g == 0) *sr = s;
  } else {
    constexpr int E = Vec<T>::E;
    const int nvec = cols / E;
    float v[V][E];
    float amax = 0.f;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const int j = g + k * lanes;
      if (live && j < nvec) {
        Vec<T>::load(xr + j * E, v[k]);
#pragma unroll
        for (int e = 0; e < E; ++e) amax = max_nan(amax, fabsf(v[k][e]));
      }
    }
    const float s = row_scale(group_max(amax, lanes));
    if (!live) return;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const int j = g + k * lanes;
      if (j < nvec) Vec<T>::store_codes(qr + j * E, v[k], s);
    }
    if (g == 0) *sr = s;
  }
}

// the thread's row and its lane in the row's group: `lanes` lanes a row
// (the whole warp on the element path)
struct RowLane {
  int64_t row;
  int g;
};

template <int V>
__device__ __forceinline__ RowLane row_lane(int lanes) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int l = V == 0 ? 32 : lanes;
  return {t / l, static_cast<int>(t % l)};
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    quantize_rows_kernel(const T* __restrict__ x, int8_t* __restrict__ q,
                         float* __restrict__ scale, int rows, int cols, int lanes) {
  const RowLane rl = row_lane<V>(lanes);
  const bool live = rl.row < rows;
  const int64_t r = live ? rl.row : 0;
  quantize_row<T, V>(x + r * cols, q + r * cols, scale + r, rl.g, lanes, cols, live);
}

// the decode step's write: 2 x B x K rows, K's then V's
struct KVWrite {
  const void* x[2];                  // k, v [B, 1, K, D], rows through their strides
  int64_t stride_b[2], stride_h[2];  // elements
  int8_t* codes[2];                  // [pages, ps, K, D]
  float* scales[2];                  // [pages, ps, K]
  const int32_t* table;              // [B, max_pages], or null: page b is slot b's
  const int32_t* positions;          // [B]
  const bool* active;                // [B]
  int B, K, D, ps, max_pages, pages;
};

// the cache row (page * ps + position in the page) slot b writes; traps on
// a position or table entry outside the cache
__device__ __forceinline__ int64_t kv_dest(const KVWrite& a, int b) {
  const int pos = a.positions[b];
  if (pos < 0) __trap();
  if (a.table == nullptr) return static_cast<int64_t>(b) * a.ps + min(pos, a.ps - 1);
  const int j = pos / a.ps;
  if (j >= a.max_pages) __trap();
  const int page = a.table[static_cast<int64_t>(b) * a.max_pages + j];
  if (page < 0 || page >= a.pages) __trap();
  return static_cast<int64_t>(page) * a.ps + pos % a.ps;
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads) quantize_kv_write_kernel(KVWrite a, int lanes) {
  const RowLane rl = row_lane<V>(lanes);
  const int64_t per = static_cast<int64_t>(a.B) * a.K;
  const bool live = rl.row < 2 * per;
  const int64_t r = live ? rl.row : 0;
  const int t = static_cast<int>(r / per);                // 0: k, 1: v
  const int b = static_cast<int>(r % per / a.K);
  const int h = static_cast<int>(r % a.K);
  const int64_t dst = live ? kv_dest(a, b) : 0;
  const bool write = live && a.active[b];
  // selects, not a runtime index into the parameter arrays
  const T* xr = static_cast<const T*>(t ? a.x[1] : a.x[0]) +
                b * (t ? a.stride_b[1] : a.stride_b[0]) + h * (t ? a.stride_h[1] : a.stride_h[0]);
  const int64_t cache_row = dst * a.K + h;
  quantize_row<T, V>(xr, (t ? a.codes[1] : a.codes[0]) + cache_row * a.D,
                     (t ? a.scales[1] : a.scales[0]) + cache_row, rl.g, lanes, a.D, write);
}

unsigned blocks_for(int64_t rows, int lanes) {
  return static_cast<unsigned>((rows * lanes + kThreads - 1) / kThreads);
}

template <typename T, int V>
void launch_quantize(const void* x, int8_t* q, float* s, int rows, int cols, int lanes,
                     cudaStream_t stream) {
  quantize_rows_kernel<T, V><<<blocks_for(rows, V == 0 ? 32 : lanes), kThreads, 0, stream>>>(
      static_cast<const T*>(x), q, s, rows, cols, lanes);
}

template <typename T, int V>
void launch_kv_write(const KVWrite& a, int lanes, cudaStream_t stream) {
  const int64_t rows = 2 * static_cast<int64_t>(a.B) * a.K;
  quantize_kv_write_kernel<T, V>
      <<<blocks_for(rows, V == 0 ? 32 : lanes), kThreads, 0, stream>>>(a, lanes);
}

// the instance for `vectors` a lane (0: the element path); false for a
// count no instance takes
template <typename T>
bool launch_quantize_as(int vectors, const void* x, int8_t* q, float* s, int rows, int cols,
                        int lanes, cudaStream_t st) {
  switch (vectors) {
    case 0: launch_quantize<T, 0>(x, q, s, rows, cols, lanes, st); return true;
    case 1: launch_quantize<T, 1>(x, q, s, rows, cols, lanes, st); return true;
    case 2: launch_quantize<T, 2>(x, q, s, rows, cols, lanes, st); return true;
    case 4: launch_quantize<T, 4>(x, q, s, rows, cols, lanes, st); return true;
    case 8: launch_quantize<T, 8>(x, q, s, rows, cols, lanes, st); return true;
    default: return false;
  }
}

template <typename T>
bool launch_kv_write_as(int vectors, const KVWrite& a, int lanes, cudaStream_t st) {
  switch (vectors) {
    case 0: launch_kv_write<T, 0>(a, lanes, st); return true;
    case 1: launch_kv_write<T, 1>(a, lanes, st); return true;
    case 2: launch_kv_write<T, 2>(a, lanes, st); return true;
    case 4: launch_kv_write<T, 4>(a, lanes, st); return true;
    case 8: launch_kv_write<T, 8>(a, lanes, st); return true;
    default: return false;
  }
}

bool valid_group(int lanes, int vectors) {
  return vectors == 0 || (lanes > 0 && lanes <= 32 && (lanes & (lanes - 1)) == 0);
}

// ---------------------------------------------------------------------------
// dequantize_rows and dequantize_sum_rows

template <typename T> __device__ __forceinline__ void store4(T* out, const float (&v)[4]);

template <> __device__ __forceinline__ void store4<float>(float* out, const float (&v)[4]) {
  __stcs(reinterpret_cast<float4*>(out), make_float4(v[0], v[1], v[2], v[3]));
}

template <> __device__ __forceinline__ void store4<__nv_bfloat16>(__nv_bfloat16* out,
                                                                  const float (&v)[4]) {
  uint32_t h[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) h[e] = __bfloat16_as_ushort(__float2bfloat16_rn(v[e]));
  __stcs(reinterpret_cast<uint2*>(out), make_uint2(h[0] | h[1] << 16, h[2] | h[3] << 16));
}

constexpr int kSegments = 8;   // 128-code segments a lane has in flight

// One warp a row, the warps at a grid stride over the rows. kSum: out =
// the sum over `pods` (q, scale) planes [pods][rows, cols] in pod order
// from +0, only out[0, n); else out = q * scale[row] (pods 1, n = rows *
// cols).
template <typename T, bool kSum>
__global__ void __launch_bounds__(kThreads)
    dequantize_rows_kernel(const int8_t* __restrict__ q, const float* __restrict__ scale,
                           T* __restrict__ out, int pods, int64_t rows, int cols, int64_t n) {
  const int lane = threadIdx.x & 31;
  const int64_t warps = static_cast<int64_t>(gridDim.x) * kWarps;
  const int64_t plane = rows * cols;
  for (int64_t r = static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5); r < rows;
       r += warps) {
    for (int c0 = 0; c0 < cols; c0 += 128 * kSegments) {
      float acc[kSegments][4] = {};
      for (int p = 0; p < pods; ++p) {
        const float s = scale[p * rows + r];
        const int8_t* qr = q + p * plane + r * cols;
        uint32_t w[kSegments];
#pragma unroll
        for (int u = 0; u < kSegments; ++u) {
          const int c = c0 + u * 128 + lane * 4;
          w[u] = c < cols ? *reinterpret_cast<const uint32_t*>(qr + c) : 0u;
        }
#pragma unroll
        for (int u = 0; u < kSegments; ++u) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float x = __fmul_rn(static_cast<float>(static_cast<int8_t>(w[u] >> (8 * e))), s);
            acc[u][e] = kSum ? __fadd_rn(acc[u][e], x) : x;
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kSegments; ++u) {
        const int c = c0 + u * 128 + lane * 4;
        const int64_t i = r * cols + c;
        if (c >= cols || i >= n) continue;
        if (i + 4 <= n) {
          store4<T>(out + i, acc[u]);
        } else {   // the end of the sum's last row
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (i + e < n) out[i + e] = repro::from_f32<T>(acc[u][e]);
        }
      }
    }
  }
}

// an element a thread, for any width and alignment
template <typename T, bool kSum>
__global__ void __launch_bounds__(kThreads)
    dequantize_elements_kernel(const int8_t* __restrict__ q, const float* __restrict__ scale,
                               T* __restrict__ out, int pods, int64_t rows, int cols, int64_t n) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  const int64_t r = i / cols;
  float acc = 0.f;
  for (int p = 0; p < pods; ++p) {
    const float x = __fmul_rn(static_cast<float>(q[p * rows * cols + i]), scale[p * rows + r]);
    acc = kSum ? __fadd_rn(acc, x) : x;
  }
  out[i] = repro::from_f32<T>(acc);
}

template <typename T, bool kSum>
cudaError_t launch_dequant(const int8_t* q, const float* s, void* out, int pods, int rows,
                           int cols, int64_t n, bool vector, cudaStream_t stream) {
  T* o = static_cast<T*>(out);
  if (vector) {
    int dev = 0, sms = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    // a warp a row up to 16 blocks (128 warps) an SM, more rows at the grid stride
    const int64_t blocks = std::min<int64_t>((rows + kWarps - 1) / kWarps, 16LL * sms);
    dequantize_rows_kernel<T, kSum><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
        q, s, o, pods, rows, cols, n);
  } else {
    const int64_t blocks = (n + kThreads - 1) / kThreads;
    dequantize_elements_kernel<T, kSum><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
        q, s, o, pods, rows, cols, n);
  }
  return cudaGetLastError();
}

}  // namespace

int repro::quantize_rows(const void* x, DType x_dtype, int8_t* q, float* s, int rows, int cols,
                         int lanes, int vectors, void* stream) {
  if (rows <= 0 || cols <= 0 || !valid_group(lanes, vectors))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool ok =
      x_dtype == kF32 ? launch_quantize_as<float>(vectors, x, q, s, rows, cols, lanes, st)
      : x_dtype == kBF16
          ? launch_quantize_as<__nv_bfloat16>(vectors, x, q, s, rows, cols, lanes, st)
          : false;
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

int repro::quantize_kv_write(const void* k, const void* v, DType dtype, const int64_t* k_strides,
                             const int64_t* v_strides, int8_t* k_codes, int8_t* v_codes,
                             float* k_scale, float* v_scale, const int32_t* table,
                             const int32_t* positions, const bool* active, int B, int K, int D,
                             int ps, int max_pages, int pages, int lanes, int vectors,
                             void* stream) {
  if (B <= 0 || K <= 0 || D <= 0 || ps <= 0 || pages <= 0 || !valid_group(lanes, vectors) ||
      (table != nullptr && max_pages <= 0))
    return static_cast<int>(cudaErrorInvalidValue);
  KVWrite a{{k, v}, {k_strides[0], v_strides[0]}, {k_strides[1], v_strides[1]},
            {k_codes, v_codes}, {k_scale, v_scale}, table, positions, active,
            B, K, D, ps, max_pages, pages};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool ok = dtype == kF32    ? launch_kv_write_as<float>(vectors, a, lanes, st)
                  : dtype == kBF16 ? launch_kv_write_as<__nv_bfloat16>(vectors, a, lanes, st)
                                   : false;
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

int repro::dequantize_rows(const int8_t* q, const float* s, void* out, DType out_dtype, int rows,
                           int cols, bool vector, void* stream) {
  if (rows <= 0 || cols <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t n = static_cast<int64_t>(rows) * cols;
  switch (out_dtype) {
    case kF32:
      return static_cast<int>(
          launch_dequant<float, false>(q, s, out, 1, rows, cols, n, vector, st));
    case kBF16:
      return static_cast<int>(
          launch_dequant<__nv_bfloat16, false>(q, s, out, 1, rows, cols, n, vector, st));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

int repro::dequantize_sum_rows(const int8_t* q, const float* s, float* out, int pods, int rows,
                               int cols, int64_t n, bool vector, void* stream) {
  if (pods <= 0 || rows <= 0 || cols <= 0 || n <= 0 || n > static_cast<int64_t>(rows) * cols)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_dequant<float, true>(q, s, out, pods, rows, cols, n, vector,
                                                     static_cast<cudaStream_t>(stream)));
}
