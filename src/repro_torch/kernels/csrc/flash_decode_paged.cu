// Paged flash-decode for Hopper (sm_90a): one query token per slot against
// a shared page arena, read through a per-slot page table.
//
// Replaces: src/repro/kernels/flash_attention/decode_kernel.py
// `flash_decode_paged_fwd` (bodies `_fd_paged_kernel` -> `_fd_kernel`, and
// `_fd_paged_kernel_int8` -> `_fd_kernel_int8` when the arenas hold int8
// codes with f32 per-row scales). It runs on every layer of every decode
// tick of the serve engine.
//
// Computes, for slot b and query head h = kvh * G + g (G = H / K):
//   o[b, h] = softmax_t((q[b, h] / sqrt(D)) . k[b, t]) . v[b, t],  t < kv_len[b]
// where position t lives at arena[table[b, t / ps], t % ps, kvh, :]
// (times its row scale for int8). Rows with kv_len == 0 come out as exact
// zeros. No position >= kv_len is ever read, so stale or garbage pages
// (the null page, freed pages) cannot reach the output.
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
// first resolves its page-table entries into arena row indices (each block
// reads its own table entries), then each warp scores positions
// lane-interleaved over D (coalesced row reads) and reduces the G dots by
// shuffle, one warp per query row updates (m, l) and turns the tile's
// scores into probabilities, and finally every thread accumulates p . v
// for its column. The query rows are scaled by 1/sqrt(D) in f32 before the
// dot, as the TPU body does. Split-KV across blocks, cp.async/TMA page
// loads and wgmma are later work.

#include "common.cuh"

namespace {

constexpr int kTile = 64;   // kv positions per tile
constexpr int kMaxG = 8;    // query rows per kv head a block holds
constexpr float kNegInf = -1e30f;

template <typename QT, typename KVT, bool kQuant>
__global__ void fd_paged_kernel(const QT* __restrict__ q, const KVT* __restrict__ kp,
                                const KVT* __restrict__ vp, const float* __restrict__ ks,
                                const float* __restrict__ vs, const int* __restrict__ kv_len,
                                const int* __restrict__ table, QT* __restrict__ out, int H,
                                int K, int D, int ps, int max_pages, float sm_scale) {
  extern __shared__ float smem[];
  const int G = H / K;
  float* q_s = smem;               // [G, D] scaled query rows
  float* p_s = q_s + G * D;        // [G, kTile] scores, then probabilities
  float* m_s = p_s + G * kTile;    // [G] running max
  float* l_s = m_s + G;            // [G] running sum
  float* c_s = l_s + G;            // [G] this tile's rescale of acc
  int* row_s = reinterpret_cast<int*>(c_s + G);  // [kTile] arena row index

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

  // never past the table's capacity, never below zero
  const int len = max(0, min(kv_len[b], max_pages * ps));
  const int* tab = table + static_cast<size_t>(b) * max_pages;
  __syncthreads();

  for (int t0 = 0; t0 < len; t0 += kTile) {
    const int n = min(kTile, len - t0);
    for (int t = tid; t < n; t += blockDim.x) {
      const int pos = t0 + t;
      row_s[t] = tab[pos / ps] * ps + pos % ps;
    }
    __syncthreads();

    // scores: warp w takes positions w, w + nwarps, ...
    for (int t = warp; t < n; t += nwarps) {
      const size_t row = static_cast<size_t>(row_s[t]) * K + kvh;
      const KVT* kr = kp + row * D;
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
      const float vv = repro::to_f32(vp[row * D + d]) * (kQuant ? vs[row] : 1.f);
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

template <typename QT, typename KVT, bool kQuant>
void launch(const void* q, const void* k, const void* v, const void* ks, const void* vs,
            const void* kv_len, const void* table, void* out, int B, int H, int K, int D,
            int ps, int max_pages, float sm_scale, cudaStream_t stream) {
  const int G = H / K;
  const size_t smem = sizeof(float) * (G * D + G * kTile + 3 * G) + sizeof(int) * kTile;
  fd_paged_kernel<QT, KVT, kQuant><<<B * K, D, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const KVT*>(k), static_cast<const KVT*>(v),
      static_cast<const float*>(ks), static_cast<const float*>(vs),
      static_cast<const int*>(kv_len), static_cast<const int*>(table), static_cast<QT*>(out),
      H, K, D, ps, max_pages, sm_scale);
}

template <typename QT>
int dispatch_kv(repro::DType kv_dtype, const void* q, const void* k, const void* v,
                const void* ks, const void* vs, const void* kv_len, const void* table,
                void* out, int B, int H, int K, int D, int ps, int max_pages, float sm_scale,
                cudaStream_t st) {
  switch (kv_dtype) {
    case repro::kF32:
      launch<QT, float, false>(q, k, v, ks, vs, kv_len, table, out, B, H, K, D, ps, max_pages,
                               sm_scale, st);
      break;
    case repro::kBF16:
      launch<QT, __nv_bfloat16, false>(q, k, v, ks, vs, kv_len, table, out, B, H, K, D, ps,
                                       max_pages, sm_scale, st);
      break;
    case repro::kI8:
      launch<QT, int8_t, true>(q, k, v, ks, vs, kv_len, table, out, B, H, K, D, ps, max_pages,
                               sm_scale, st);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return 0;
}

}  // namespace

int repro::flash_decode_paged(const void* q, DType q_dtype, const void* k, const void* v,
                              DType kv_dtype, const float* k_scale, const float* v_scale,
                              const int32_t* kv_len, const int32_t* table, void* out, int B,
                              int H, int K, int D, int ps, int max_pages, float sm_scale,
                              void* stream) {
  // the wrapper checks these too; a bad call must never reach the launch
  if (B <= 0 || K <= 0 || H % K != 0 || H / K > kMaxG || D % 32 != 0 || D <= 0 || D > 1024 ||
      ps <= 0 || max_pages <= 0 || (kv_dtype == kI8) != (k_scale != nullptr && v_scale != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int err;
  switch (q_dtype) {
    case kF32:
      err = dispatch_kv<float>(kv_dtype, q, k, v, k_scale, v_scale, kv_len, table, out, B, H,
                               K, D, ps, max_pages, sm_scale, st);
      break;
    case kBF16:
      err = dispatch_kv<__nv_bfloat16>(kv_dtype, q, k, v, k_scale, v_scale, kv_len, table,
                                       out, B, H, K, D, ps, max_pages, sm_scale, st);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != 0) return err;
  return static_cast<int>(cudaGetLastError());
}
