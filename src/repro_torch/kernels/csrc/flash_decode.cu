// Flash-decode for Hopper (sm_90a): one query token per slot against the
// slot's first kv_len cached positions, for the two cache layouts of the
// serve path. One kernel body, templated on the address rule that says
// which cache row holds position t of slot b:
//
//   PagedRows       arena row table[b, t / ps] * ps + t % ps   (launcher
//                   flash_decode_paged: arenas [pages, ps, K, D])
//   ContiguousRows  row b * Smax + t                            (launcher
//                   flash_decode: caches [B, Smax, K, D])
//
// Replaces: src/repro/kernels/flash_attention/decode_kernel.py
// `flash_decode_paged_fwd` (:155, the serve engine's decode) and
// `flash_decode_fwd` (:233, the static loop's decode_step and slot decode
// without a page arena), each with its two bodies: `_fd_kernel` for caches
// of q's type and `_fd_kernel_int8` for int8 codes with f32 per-row scales.
//
// Computes, for slot b and query head h = kvh * G + g (G = H / K):
//   o[b, h] = softmax_t((q[b, h] / sqrt(D)) . k[row(b, t), kvh])
//             . v[row(b, t), kvh],   t < min(kv_len[b], capacity)
// (times each row's scale for int8). Rows with kv_len == 0 come out as
// exact zeros. No position >= kv_len is ever read, so stale or garbage
// rows (the null page, freed pages, unwritten cache) cannot reach the
// output: this replaces the TPU kernel's index clamp and its zeroing of
// masked v rows.
//
// Bound on this card: bytes. Each slot's kv_len rows of k and v are read
// once (2 * kv_len * K * D * bytes, plus 8 bytes of scales per row for
// int8) for 4 * G flops per element read, far below the ~295 operations
// per byte at which the tensor cores would become the limit; at G = 5 the
// work is not worth a tensor-core tile, so it runs on the CUDA cores in f32.
//
// Design. One block per (slot, kv head), D threads (a multiple of 32). The
// TPU kernel walks KV blocks as a sequential grid axis with (m, l, acc) in
// VMEM scratch; here one block loops over tiles of kTile positions and
// keeps the online softmax state in shared memory (m, l) and in registers
// (acc: thread d owns column d of every query row of its group). A tile
// first resolves its positions into cache rows through the address rule,
// then each warp scores positions lane-interleaved over D (coalesced row
// reads) and reduces the G dots by shuffle, one warp per query row updates
// (m, l) and turns the tile's scores into probabilities, and finally every
// thread accumulates p . v for its column. The query rows are scaled by
// 1/sqrt(D) in f32 before the dot, as the TPU body does. Split-KV across
// blocks, cp.async/TMA loads and wgmma are later work.

#include "common.cuh"

namespace {

constexpr int kTile = 64;   // kv positions per tile
constexpr int kMaxG = 8;    // query rows per kv head a block holds
constexpr float kNegInf = -1e30f;

// position t of slot b lives at arena row table[b, t / ps] * ps + t % ps
struct PagedRows {
  const int* table;
  int max_pages, ps;
  __device__ int capacity() const { return max_pages * ps; }
  __device__ int row(int b, int t) const {
    return table[static_cast<size_t>(b) * max_pages + t / ps] * ps + t % ps;
  }
};

// position t of slot b lives at row b * Smax + t
struct ContiguousRows {
  int smax;
  __device__ int capacity() const { return smax; }
  __device__ int row(int b, int t) const { return b * smax + t; }
};

template <typename QT, typename KVT, bool kQuant, typename Rows>
__global__ void fd_kernel(const QT* __restrict__ q, const KVT* __restrict__ kc,
                          const KVT* __restrict__ vc, const float* __restrict__ ks,
                          const float* __restrict__ vs, const int* __restrict__ kv_len,
                          Rows rows, QT* __restrict__ out, int H, int K, int D,
                          float sm_scale) {
  extern __shared__ float smem[];
  const int G = H / K;
  float* q_s = smem;               // [G, D] scaled query rows
  float* p_s = q_s + G * D;        // [G, kTile] scores, then probabilities
  float* m_s = p_s + G * kTile;    // [G] running max
  float* l_s = m_s + G;            // [G] running sum
  float* c_s = l_s + G;            // [G] this tile's rescale of acc
  int* row_s = reinterpret_cast<int*>(c_s + G);  // [kTile] cache row index

  const int b = blockIdx.x / K;
  const int kvh = blockIdx.x % K;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const int d = tid;               // this thread's column of acc

  for (int g = 0; g < G; ++g)
    q_s[g * D + d] = repro::to_f32(q[(static_cast<size_t>(b) * H + kvh * G + g) * D + d]) *
                     sm_scale;
  if (tid < G) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  float acc[kMaxG];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) acc[g] = 0.f;

  // never past the cache's capacity, never below zero
  const int len = max(0, min(kv_len[b], rows.capacity()));
  __syncthreads();

  for (int t0 = 0; t0 < len; t0 += kTile) {
    const int n = min(kTile, len - t0);
    for (int t = tid; t < n; t += blockDim.x) row_s[t] = rows.row(b, t0 + t);
    __syncthreads();

    // scores: warp w takes positions w, w + nwarps, ...
    for (int t = warp; t < n; t += nwarps) {
      const size_t row = static_cast<size_t>(row_s[t]) * K + kvh;
      const KVT* kr = kc + row * D;
      const float ksc = kQuant ? ks[row] : 1.f;
      float part[kMaxG];
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) part[g] = 0.f;
      for (int c = lane; c < D; c += 32) {
        const float kv = repro::to_f32(kr[c]) * ksc;
#pragma unroll
        for (int g = 0; g < kMaxG; ++g)
          if (g < G) part[g] += q_s[g * D + c] * kv;
      }
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) {
        if (g < G) {
          const float s = repro::warp_sum(part[g]);
          if (lane == 0) p_s[g * kTile + t] = s;
        }
      }
    }
    __syncthreads();

    // online softmax: warp w updates query rows w, w + nwarps, ...
    for (int g = warp; g < G; g += nwarps) {
      float* pg = p_s + g * kTile;
      float mx = kNegInf;
      for (int t = lane; t < n; t += 32) mx = fmaxf(mx, pg[t]);
      mx = repro::warp_max(mx);
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int t = lane; t < n; t += 32) {
        const float e = expf(pg[t] - m_new);
        pg[t] = e;
        sum += e;
      }
      sum = repro::warp_sum(sum);
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        l_s[g] = l_s[g] * corr + sum;
        m_s[g] = m_new;
        c_s[g] = corr;
      }
    }
    __syncthreads();

    // acc[g] = acc[g] * corr[g] + sum_t p[g, t] * v[t, d]
#pragma unroll
    for (int g = 0; g < kMaxG; ++g)
      if (g < G) acc[g] *= c_s[g];
    for (int t = 0; t < n; ++t) {
      const size_t row = static_cast<size_t>(row_s[t]) * K + kvh;
      const float vv = repro::to_f32(vc[row * D + d]) * (kQuant ? vs[row] : 1.f);
#pragma unroll
      for (int g = 0; g < kMaxG; ++g)
        if (g < G) acc[g] += p_s[g * kTile + t] * vv;
    }
    __syncthreads();   // the next tile overwrites row_s and p_s
  }

  for (int g = 0; g < G; ++g)
    out[(static_cast<size_t>(b) * H + kvh * G + g) * D + d] =
        repro::from_f32<QT>(acc[g] / fmaxf(l_s[g], 1e-30f));
}

template <typename QT, typename KVT, bool kQuant, typename Rows>
void launch(const void* q, const void* k, const void* v, const float* ks, const float* vs,
            const int32_t* kv_len, Rows rows, void* out, int B, int H, int K, int D,
            float sm_scale, cudaStream_t stream) {
  const int G = H / K;
  const size_t smem = sizeof(float) * (G * D + G * kTile + 3 * G) + sizeof(int) * kTile;
  fd_kernel<QT, KVT, kQuant, Rows><<<B * K, D, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const KVT*>(k), static_cast<const KVT*>(v), ks,
      vs, kv_len, rows, static_cast<QT*>(out), H, K, D, sm_scale);
}

// caches of q's type, or int8 codes with f32 scales
template <typename QT, typename Rows>
int dispatch_kv(repro::DType q_dtype, repro::DType kv_dtype, const void* q, const void* k,
                const void* v, const float* ks, const float* vs, const int32_t* kv_len,
                Rows rows, void* out, int B, int H, int K, int D, float sm_scale,
                cudaStream_t st) {
  if (kv_dtype == repro::kI8)
    launch<QT, int8_t, true>(q, k, v, ks, vs, kv_len, rows, out, B, H, K, D, sm_scale, st);
  else if (kv_dtype == q_dtype)
    launch<QT, QT, false>(q, k, v, ks, vs, kv_len, rows, out, B, H, K, D, sm_scale, st);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

template <typename Rows>
int decode(const void* q, repro::DType q_dtype, const void* k, const void* v,
           repro::DType kv_dtype, const float* ks, const float* vs, const int32_t* kv_len,
           Rows rows, void* out, int B, int H, int K, int D, float sm_scale, void* stream) {
  // the wrappers check these too; a bad call must never reach the launch
  if (B <= 0 || K <= 0 || H % K != 0 || H / K > kMaxG || D % 32 != 0 || D <= 0 || D > 1024 ||
      (kv_dtype == repro::kI8) != (ks != nullptr && vs != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int err;
  switch (q_dtype) {
    case repro::kF32:
      err = dispatch_kv<float>(q_dtype, kv_dtype, q, k, v, ks, vs, kv_len, rows, out, B, H, K,
                               D, sm_scale, st);
      break;
    case repro::kBF16:
      err = dispatch_kv<__nv_bfloat16>(q_dtype, kv_dtype, q, k, v, ks, vs, kv_len, rows, out,
                                       B, H, K, D, sm_scale, st);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != 0) return err;
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

int repro::flash_decode_paged(const void* q, DType q_dtype, const void* k, const void* v,
                              DType kv_dtype, const float* k_scale, const float* v_scale,
                              const int32_t* kv_len, const int32_t* table, void* out, int B,
                              int H, int K, int D, int ps, int max_pages, float sm_scale,
                              void* stream) {
  if (ps <= 0 || max_pages <= 0) return static_cast<int>(cudaErrorInvalidValue);
  return decode(q, q_dtype, k, v, kv_dtype, k_scale, v_scale, kv_len,
                PagedRows{table, max_pages, ps}, out, B, H, K, D, sm_scale, stream);
}

int repro::flash_decode(const void* q, DType q_dtype, const void* k, const void* v,
                        DType kv_dtype, const float* k_scale, const float* v_scale,
                        const int32_t* kv_len, void* out, int B, int H, int K, int D,
                        int smax, float sm_scale, void* stream) {
  if (smax < 0) return static_cast<int>(cudaErrorInvalidValue);
  return decode(q, q_dtype, k, v, kv_dtype, k_scale, v_scale, kv_len, ContiguousRows{smax},
                out, B, H, K, D, sm_scale, stream);
}
