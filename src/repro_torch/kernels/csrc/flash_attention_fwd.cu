// Flash attention forward (prefill) for Hopper (sm_90a) on the CUDA cores:
// the route for f32 inputs and for head widths other than 64, 128 and 256.
// bf16 at those widths (every config's prefill) takes the tensor-core
// kernel, flash_attention_wgmma.cu; the wrapper
// (kernels/flash_attention/ops.py `flash_attention_cuda`) picks the route.
//
// Replaces: src/repro/kernels/flash_attention/kernel.py `flash_attention_fwd`
// (body `_fa_kernel`), reached by the whole-prompt prefill of
// attention(impl="pallas"): the static loop's prefill and the serve engine's
// prefill when prefill_chunk=0.
//
// Computes, for query row i of (b, h) at absolute position p = i + q_offset
// and kv head kvh = h * K / H (grouped KV is never expanded):
//   o[b, i, h] = softmax_t((q[b, i, h] / sqrt(D)) . k[b, t, kvh]) . v[b, t, kvh]
// over the keys t < Skv that the masks leave: t <= p when causal, and
// t > p - window when window > 0. A row with no such key returns the mean
// of v over all Skv keys of its kv head, as the JAX package's oracle
// `flash_attention_ref` does (its masked scores are a finite -1e30, so such
// a row's softmax is uniform); the TPU kernel masks the padded keys of a
// ragged last block too, and there averages over the padded length. q, k, v
// and o stay in the model layout
// [B, S, heads, D]: the kernel computes each row's offset from the strides
// of that layout, so the call needs no transposes.
//
// Bound on this card: bytes for short prompts, operations for long ones.
// A causal query row costs 4 * D flops per visible key (~S / 2 of them)
// against ~4 * D bytes of its q and o rows (plus k/v shared by G heads),
// so at the bf16 tensor-core rate the work outweighs the bytes from a few
// hundred tokens on: at S = 128 (the static and engine prefill) the bytes
// bound, at S = 4096 the operations, by far. This first version computes
// on the CUDA cores in f32 (wgmma and TMA are later work), so its own
// ceiling is the 67 TFLOP/s f32 rate, 15x below the tensor-core one.
//
// Design. One block per (q tile of 64 rows, q head, batch row), 256
// threads as a 16 x 16 grid: thread (ty, tx) owns query rows ty + 16i
// (i < 4), key columns tx + 16j (j < 4) of each score tile and output
// columns tx + 16j (j < D / 16). The TPU kernel walks kv blocks as a
// sequential grid axis with (m, l, acc) in VMEM scratch; here the block
// loops over kv tiles of 64 rows itself. It stages its q tile once in
// shared memory, scaled by 1/sqrt(D) in f32 as kernel.py:41 does, then for
// each kv tile its rows can see stages K and V (in the input type, 16 KB
// each in bf16 at D = 128), never reading a row >= Skv — that replaces
// the TPU's zeroing of padded v rows. Tiles wholly above the causal
// diagonal or wholly before the window are skipped, not computed masked.
// Per tile: scores by 4 x 4 register outer products over D; masked scores
// become -inf; each row's max and sum reduce over the 16 threads of its
// half-warp by shuffles; m and l live in registers (each of the 16 holds
// the row's copy) and acc in registers, all f32; the probabilities pass
// through shared memory to the P . V product. A row whose softmax sum
// stays 0 saw no key: if a block has one, its threads then sum v over all
// Skv rows for their output columns, in f32, and such rows take that sum
// over Skv. The blocks of the last q tiles, which see the most keys under
// the causal mask, start first.

#include <math_constants.h>

#include "common.cuh"

namespace {

constexpr int kBQ = 64;          // query rows per block
constexpr int kBK = 64;          // kv rows per tile
constexpr int kThreads = 256;    // a 16 x 16 grid
constexpr int kMaxD = 256;
constexpr int kMaxCols = kMaxD / 16;   // output columns a thread owns
constexpr float kNegInf = -1e30f;

// row padding of the K tile in shared memory, in elements: with it the 16
// keys a half-warp reads at one d fall in 16 different banks
template <typename T> struct KPad;
template <> struct KPad<float> { static constexpr int value = 1; };
template <> struct KPad<__nv_bfloat16> { static constexpr int value = 2; };

// V tile [kBK, D] and K tile [kBK, D + pad] in T, q tile [kBQ, D + 1] and
// probabilities [kBQ, kBK + 1] in f32
template <typename T>
size_t smem_bytes(int D) {
  return sizeof(T) * (kBK * D + kBK * (D + KPad<T>::value)) +
         sizeof(float) * (kBQ * (D + 1) + kBQ * (kBK + 1));
}

// max and sum over the 16 lanes of a half-warp (xor offsets stay inside it)
__device__ __forceinline__ float half_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float half_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    fa_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                  T* __restrict__ out, int Sq, int Skv, int H, int K, int D, bool causal,
                  int window, int q_offset, float sm_scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int kVec = 16 / sizeof(T);   // elements per 16-byte load
  const int kld = D + KPad<T>::value;
  const int qld = D + 1;
  constexpr int pld = kBK + 1;
  T* v_s = reinterpret_cast<T*>(smem_raw);
  T* k_s = v_s + kBK * D;
  float* q_s = reinterpret_cast<float*>(k_s + kBK * kld);
  float* p_s = q_s + kBQ * qld;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h * K / H;
  const int nq = min(kBQ, Sq - q0);
  const int tid = threadIdx.x;
  const int ty = tid >> 4;
  const int tx = tid & 15;
  const int nd = D >> 4;           // output columns of this thread
  const int vpr = D / kVec;        // 16-byte vectors per row

  // row r of q/o is at qb + r * H * D; row t of k/v at kb + t * K * D
  const size_t q_stride = static_cast<size_t>(H) * D;
  const size_t kv_stride = static_cast<size_t>(K) * D;
  const T* qb = q + (static_cast<size_t>(b) * Sq * H + h) * D;
  const T* kb = k + (static_cast<size_t>(b) * Skv * K + kvh) * D;
  const T* vb = v + (static_cast<size_t>(b) * Skv * K + kvh) * D;

  for (int i = tid; i < kBQ * vpr; i += kThreads) {
    const int r = i / vpr;
    const int c = (i % vpr) * kVec;
    float* dst = q_s + r * qld + c;
    if (r < nq) {
      const uint4 raw = *reinterpret_cast<const uint4*>(qb + (q0 + r) * q_stride + c);
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int u = 0; u < kVec; ++u) dst[u] = repro::to_f32(e[u]) * sm_scale;
    } else {
#pragma unroll
      for (int u = 0; u < kVec; ++u) dst[u] = 0.f;
    }
  }

  // the keys some row of this tile can see: [lo, hi)
  int hi = Skv;
  if (causal) hi = min(hi, q0 + nq + q_offset);
  int lo = 0;
  if (window > 0)
    lo = static_cast<int>(max(0LL, static_cast<long long>(q0) + q_offset - window + 1));

  float m[4], l[4], acc[4][kMaxCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kMaxCols; ++c) acc[i][c] = 0.f;
  }

  for (int t0 = (lo / kBK) * kBK; t0 < hi; t0 += kBK) {
    const int n = min(kBK, Skv - t0);
    __syncthreads();   // the previous tile's readers are done with k_s, v_s, p_s
    for (int i = tid; i < n * vpr; i += kThreads) {
      const int r = i / vpr;
      const int c = (i % vpr) * kVec;
      const size_t off = (t0 + r) * kv_stride + c;
      const uint4 kraw = *reinterpret_cast<const uint4*>(kb + off);
      const uint4 vraw = *reinterpret_cast<const uint4*>(vb + off);
      // a padded K row is 4-byte aligned: store the vector as four words
      uint32_t* kd = reinterpret_cast<uint32_t*>(k_s + r * kld + c);
      kd[0] = kraw.x;
      kd[1] = kraw.y;
      kd[2] = kraw.z;
      kd[3] = kraw.w;
      *reinterpret_cast<uint4*>(v_s + r * D + c) = vraw;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      float a[4], kk[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = q_s[(ty + 16 * i) * qld + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kk[j] = repro::to_f32(k_s[(tx + 16 * j) * kld + d]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], kk[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int p = q0 + ty + 16 * i + q_offset;   // the row's absolute position
      float mx = -CUDART_INF_F;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int u = tx + 16 * j;
        const int t = t0 + u;
        bool ok = u < n;                       // never a row >= Skv
        if (causal) ok = ok && t <= p;
        if (window > 0) ok = ok && p - t < window;
        s[i][j] = ok ? s[i][j] : -CUDART_INF_F;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = half_max(mx);
      const float m_new = fmaxf(m[i], mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float e = expf(s[i][j] - m_new);   // masked: exp(-inf) = 0
        p_s[(ty + 16 * i) * pld + tx + 16 * j] = e;
        sum += e;
      }
      sum = half_sum(sum);
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kMaxCols; ++c)
        if (c < nd) acc[i][c] *= corr;
    }
    __syncthreads();

    for (int u = 0; u < n; ++u) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = p_s[(ty + 16 * i) * pld + u];
#pragma unroll
      for (int c = 0; c < kMaxCols; ++c) {
        if (c < nd) {
          const float vv = repro::to_f32(v_s[u * D + tx + 16 * c]);
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(pv[i], vv, acc[i][c]);
        }
      }
    }
  }

  // rows with no visible key (l stays 0: a visible key's exp(0) adds 1)
  // take the mean of v over every key of the kv head
  bool no_key = false;
#pragma unroll
  for (int i = 0; i < 4; ++i) no_key |= ty + 16 * i < nq && l[i] == 0.f;
  if (__syncthreads_or(no_key)) {
    float vsum[kMaxCols];
#pragma unroll
    for (int c = 0; c < kMaxCols; ++c) vsum[c] = 0.f;
    for (int t = 0; t < Skv; ++t) {
#pragma unroll
      for (int c = 0; c < kMaxCols; ++c)
        if (c < nd) vsum[c] += repro::to_f32(vb[t * kv_stride + tx + 16 * c]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (l[i] != 0.f) continue;
      l[i] = static_cast<float>(Skv);
#pragma unroll
      for (int c = 0; c < kMaxCols; ++c) acc[i][c] = vsum[c];
    }
  }

  T* ob = out + (static_cast<size_t>(b) * Sq * H + h) * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (r >= nq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < kMaxCols; ++c)
      if (c < nd) ob[(q0 + r) * q_stride + tx + 16 * c] = repro::from_f32<T>(acc[i][c] / denom);
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, int B, int Sq, int Skv,
           int H, int K, int D, bool causal, int window, int q_offset, float sm_scale,
           cudaStream_t stream) {
  const size_t smem = smem_bytes<T>(D);
  // above 48 KB a kernel must opt in to its dynamic shared memory
  static size_t opted_in = 0;
  if (smem > opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        fa_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in = smem;
  }
  const dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  fa_fwd_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), Sq, Skv, H, K, D, causal, window, q_offset, sm_scale);
  return 0;
}

}  // namespace

int repro::flash_attention(const void* q, const void* k, const void* v, void* out,
                           DType dtype, int B, int Sq, int Skv, int H, int K, int D,
                           bool causal, int window, int q_offset, float sm_scale,
                           void* stream) {
  // the wrapper checks these too; a bad call must never reach the launch
  if (B <= 0 || Sq <= 0 || Skv <= 0 || K <= 0 || H % K != 0 || H > 65535 || B > 65535 ||
      D <= 0 || D % 32 != 0 || D > kMaxD || window < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  // the kernel reads and writes rows as 16-byte vectors
  const auto misaligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 != 0; };
  if (misaligned(q) || misaligned(k) || misaligned(v) || misaligned(out))
    return static_cast<int>(cudaErrorMisalignedAddress);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int err;
  switch (dtype) {
    case kF32:
      err = launch<float>(q, k, v, out, B, Sq, Skv, H, K, D, causal, window, q_offset,
                          sm_scale, st);
      break;
    case kBF16:
      err = launch<__nv_bfloat16>(q, k, v, out, B, Sq, Skv, H, K, D, causal, window, q_offset,
                                  sm_scale, st);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != 0) return err;
  return static_cast<int>(cudaGetLastError());
}
