// Mamba-2 SSD chunked scan (forward) for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/ssd_scan/kernel.py `ssd_scan_fwd` (body
// `_ssd_kernel`), reached by Model(cfg, ssd_impl="pallas").forward / loss
// through apply_ssm's scan of every "ssd" layer.
//
// Computes, per (batch row b, head h) with a = A[h], group g = h * G / H,
// over chunks of q = min(chunk, L) rows (rows >= L count as dt = 0 and
// x = B = C = 0, and none is read):
//   cum_i  = sum_{k <= i} dt_k * a                   (within the chunk)
//   y_i    = sum_{j <= i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j
//            + exp(cum_i) C_i . h_prev
//   h_next = exp(cum_last) h_prev + sum_i exp(cum_last - cum_i) dt_i x_i ⊗ B_i
// with the state h [p, n] in f32, zero before the first chunk. y is
// written in x's type. Where h_final is not null, the state after the last
// row (the partial last chunk's rows included) is written there in f32,
// [batch, H, P, N]: what the serve path's prefill hands to decode
// (ssd_scan_fwd returns none; the JAX prefill takes the plain scan for it).
//
// Bound on this card: at the main path's shape (4 x 2048 tokens, 64 heads
// of p = 64, n = 128, chunk 256) the work, ~43 GFLOP of causal-useful
// products, and the bytes, ~140 MB, give about the same least time at the
// bf16 tensor-core rate and the HBM rate (~0.04 ms each). This first
// version computes on the CUDA cores in f32 (wgmma and TMA are later
// work), so its own ceiling is the 67 TFLOP/s f32 rate.
//
// Design. The TPU kernel carries h in VMEM scratch across a sequential
// ("arbitrary") chunk axis of its grid; Hopper runs blocks in no order, so
// one block per (head, batch row) walks the chunks itself and keeps h in
// shared memory. A chunk's [q, q] score matrix (256 KB in f32 at q = 256)
// does not fit in a block's 227 KB, so the chunk is cut into row tiles of
// 64: for output tile I the block stages C_I once, starts its 64 x p
// accumulator with the inter-chunk readout, then for each tile J <= I
// stages B_J and dt_J x_J, forms the 64 x 64 scores, applies the decay
// (masked before the exp, so a masked pair never overflows) and adds
// S . (dt x)_J. Tiles above the diagonal are skipped, not computed masked.
// After the last output tile, the chunk's contributions to the state are
// summed tile by tile and h is decayed and updated in place. 256 threads
// as a 16 x 16 grid: thread (ty, tx) owns rows ty + 16i and columns
// tx + 16c of each 64-row tile, and rows ty + 16i, columns tx + 16j of the
// state. The prefix sums run in one warp in f64 and are rounded once, so
// each cum is the f32 value nearest the exact sum of the f32 products
// dt_k * a (ssd_scan.cuh, shared with the tensor-core route). x, B and C
// are read in place through their strides (the model hands over views of
// the convolution's output): no transposes, no copies.

#include "common.cuh"
#include "ssd_scan.cuh"

namespace {

constexpr int kR = 64;          // rows of a chunk tile
constexpr int kThreads = 256;   // a 16 x 16 grid
constexpr int kMaxP = 64;       // head_dim: columns a thread owns, kMaxP / 16
constexpr int kMaxN = 128;      // state size: state columns a thread owns, kMaxN / 16
constexpr int kMaxSmem = 232448;

// shared memory, all f32: h [p, n + 1], C and B tiles [kR, n + 1], the
// dt * x tile [kR, p + 1], the scores [kR, kR + 1], dt and cum [q] each
size_t smem_floats(int P, int N, int Q) {
  return static_cast<size_t>(P) * (N + 1) + 2 * kR * (N + 1) + kR * (P + 1) + kR * (kR + 1) +
         2 * Q;
}

// rows [r0, r0 + nr) of a [rows, n] operand of token stride st into
// dst [kR, n + 1] in f32; rows >= nr become zeros
template <typename T>
__device__ __forceinline__ void stage_rows(float* dst, const T* src, int64_t st, int r0, int nr,
                                           int N) {
  for (int i = threadIdx.x; i < kR * N; i += kThreads) {
    const int r = i / N;
    const int k = i - r * N;
    dst[r * (N + 1) + k] = r < nr ? repro::to_f32(src[(r0 + r) * st + k]) : 0.f;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                    const float* __restrict__ A, const T* __restrict__ Bm,
                    const T* __restrict__ Cm, T* __restrict__ y, float* __restrict__ h_final,
                    int L, int H, int G, int P,
                    int N, int Q, int64_t x_sb, int64_t x_st, int64_t x_sh, int64_t dt_sb,
                    int64_t dt_st, int64_t dt_sh, int64_t b_sb, int64_t b_st, int64_t b_sg,
                    int64_t c_sb, int64_t c_st, int64_t c_sg) {
  extern __shared__ __align__(16) float smem[];
  const int ldn = N + 1;
  const int ldp = P + 1;
  constexpr int lds = kR + 1;
  float* h_s = smem;                 // [P, ldn]
  float* c_s = h_s + P * ldn;        // [kR, ldn]
  float* b_s = c_s + kR * ldn;       // [kR, ldn]
  float* xdt_s = b_s + kR * ldn;     // [kR, ldp]
  float* s_s = xdt_s + kR * ldp;     // [kR, lds]
  float* dt_s = s_s + kR * lds;      // [Q]
  float* cum_s = dt_s + Q;           // [Q]

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int g = h * G / H;
  const int tid = threadIdx.x;
  const int ty = tid >> 4;
  const int tx = tid & 15;
  const int lane = tid & 31;
  const float a = A[h];

  const T* xb = x + b * x_sb + h * x_sh;
  const float* dtb = dt + b * dt_sb + h * dt_sh;
  const T* bb = Bm + b * b_sb + g * b_sg;
  const T* cb = Cm + b * c_sb + g * c_sg;
  const int64_t y_st = static_cast<int64_t>(H) * P;
  T* yb = y + static_cast<int64_t>(b) * L * y_st + static_cast<int64_t>(h) * P;

  for (int i = tid; i < P * ldn; i += kThreads) h_s[i] = 0.f;

  for (int c0 = 0; c0 < L; c0 += Q) {
    const int nv = min(Q, L - c0);   // valid rows of this chunk
    __syncthreads();                 // the previous chunk is done with dt_s, cum_s, h_s
    for (int i = tid; i < Q; i += kThreads) dt_s[i] = i < nv ? dtb[(c0 + i) * dt_st] : 0.f;
    __syncthreads();
    if (tid < 32) repro::ssd_chunk_cum(dt_s, cum_s, Q, a, lane);
    __syncthreads();
    const float cum_last = cum_s[Q - 1];

    // ---- outputs, one 64-row tile at a time ------------------------------
    for (int r0 = 0; r0 < nv; r0 += kR) {
      const int nr = min(kR, nv - r0);
      __syncthreads();   // the previous tile is done with c_s
      stage_rows(c_s, cb + static_cast<int64_t>(c0) * c_st, c_st, r0, nr, N);
      __syncthreads();

      // inter-chunk readout: exp(cum_i) C_i . h_prev
      float acc[4][kMaxP / 16];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < kMaxP / 16; ++c) acc[i][c] = 0.f;
      for (int k = 0; k < N; ++k) {
        float cv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) cv[i] = c_s[(ty + 16 * i) * ldn + k];
#pragma unroll
        for (int c = 0; c < kMaxP / 16; ++c) {
          if (tx + 16 * c < P) {
            const float hv = h_s[(tx + 16 * c) * ldn + k];
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(cv[i], hv, acc[i][c]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = r0 + ty + 16 * i;
        const float e = r < nv ? expf(cum_s[r]) : 0.f;
#pragma unroll
        for (int c = 0; c < kMaxP / 16; ++c) acc[i][c] *= e;
      }

      // intra-chunk: the tiles J <= I
      for (int j0 = 0; j0 <= r0; j0 += kR) {
        const int nj = min(kR, nv - j0);
        __syncthreads();   // the previous tile J is done with b_s, xdt_s, s_s
        stage_rows(b_s, bb + static_cast<int64_t>(c0) * b_st, b_st, j0, nj, N);
        for (int i = tid; i < kR * P; i += kThreads) {
          const int r = i / P;
          const int pc = i - r * P;
          xdt_s[r * ldp + pc] =
              r < nj ? repro::to_f32(xb[(c0 + j0 + r) * x_st + pc]) * dt_s[j0 + r] : 0.f;
        }
        __syncthreads();

        float s[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
        for (int k = 0; k < N; ++k) {
          float cv[4], bv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) cv[i] = c_s[(ty + 16 * i) * ldn + k];
#pragma unroll
          for (int j = 0; j < 4; ++j) bv[j] = b_s[(tx + 16 * j) * ldn + k];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) s[i][j] = fmaf(cv[i], bv[j], s[i][j]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = r0 + ty + 16 * i;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int t = j0 + tx + 16 * j;
            // masked before the exp: a pair with t > r never reaches expf
            const float w = (r < nv && t < nv && t <= r) ? expf(cum_s[r] - cum_s[t]) : 0.f;
            s_s[(ty + 16 * i) * lds + tx + 16 * j] = s[i][j] * w;
          }
        }
        __syncthreads();
        for (int u = 0; u < nj; ++u) {
          float sv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) sv[i] = s_s[(ty + 16 * i) * lds + u];
#pragma unroll
          for (int c = 0; c < kMaxP / 16; ++c) {
            if (tx + 16 * c < P) {
              const float xv = xdt_s[u * ldp + tx + 16 * c];
#pragma unroll
              for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(sv[i], xv, acc[i][c]);
            }
          }
        }
      }

#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty + 16 * i;
        if (r >= nr) continue;
#pragma unroll
        for (int c = 0; c < kMaxP / 16; ++c)
          if (tx + 16 * c < P)
            yb[(c0 + r0 + r) * y_st + tx + 16 * c] = repro::from_f32<T>(acc[i][c]);
      }
    }

    // ---- state: h = exp(cum_last) h + sum_i exp(cum_last - cum_i) dt_i x_i ⊗ B_i
    float hacc[kMaxP / 16][kMaxN / 16];
#pragma unroll
    for (int i = 0; i < kMaxP / 16; ++i)
#pragma unroll
      for (int j = 0; j < kMaxN / 16; ++j) hacc[i][j] = 0.f;
    for (int j0 = 0; j0 < nv; j0 += kR) {
      const int nj = min(kR, nv - j0);
      __syncthreads();   // the readers of b_s and xdt_s are done
      stage_rows(b_s, bb + static_cast<int64_t>(c0) * b_st, b_st, j0, nj, N);
      for (int i = tid; i < kR * P; i += kThreads) {
        const int r = i / P;
        const int pc = i - r * P;
        xdt_s[r * ldp + pc] =
            r < nj ? expf(cum_last - cum_s[j0 + r]) *
                         (repro::to_f32(xb[(c0 + j0 + r) * x_st + pc]) * dt_s[j0 + r])
                   : 0.f;
      }
      __syncthreads();
      for (int u = 0; u < nj; ++u) {
        float xv[kMaxP / 16];
#pragma unroll
        for (int i = 0; i < kMaxP / 16; ++i)
          xv[i] = ty + 16 * i < P ? xdt_s[u * ldp + ty + 16 * i] : 0.f;
#pragma unroll
        for (int j = 0; j < kMaxN / 16; ++j) {
          if (tx + 16 * j < N) {
            const float bv = b_s[u * ldn + tx + 16 * j];
#pragma unroll
            for (int i = 0; i < kMaxP / 16; ++i) hacc[i][j] = fmaf(xv[i], bv, hacc[i][j]);
          }
        }
      }
    }
    __syncthreads();   // every reader of h_s in this chunk is done
    const float decay = expf(cum_last);
#pragma unroll
    for (int i = 0; i < kMaxP / 16; ++i) {
      const int pr = ty + 16 * i;
      if (pr >= P) continue;
#pragma unroll
      for (int j = 0; j < kMaxN / 16; ++j) {
        const int k = tx + 16 * j;
        if (k < N) h_s[pr * ldn + k] = decay * h_s[pr * ldn + k] + hacc[i][j];
      }
    }
  }

  if (h_final != nullptr) {   // the state after the last row, [P, N] of (b, h)
    __syncthreads();
    float* hf = h_final + (static_cast<int64_t>(b) * H + h) * P * N;
    for (int i = tid; i < P * N; i += kThreads) {
      const int pr = i / N;
      hf[i] = h_s[pr * ldn + (i - pr * N)];
    }
  }
}

template <typename T>
int launch(const void* x, const float* dt, const float* A, const void* B, const void* C, void* y,
           float* h_final, int Bsz, int L, int H, int G, int P, int N, int Q, const int64_t* xs,
           const int64_t* dts, const int64_t* bs, const int64_t* cs, cudaStream_t stream) {
  const size_t smem = smem_floats(P, N, Q) * sizeof(float);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  // above 48 KB a kernel must opt in to its dynamic shared memory
  static size_t opted_in = 0;
  if (smem > opted_in) {
    const cudaError_t err =
        cudaFuncSetAttribute(ssd_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in = smem;
  }
  const dim3 grid(H, Bsz);
  ssd_scan_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), dt, A, static_cast<const T*>(B), static_cast<const T*>(C),
      static_cast<T*>(y), h_final, L, H, G, P, N, Q, xs[0], xs[1], xs[2], dts[0], dts[1],
      dts[2], bs[0], bs[1], bs[2], cs[0], cs[1], cs[2]);
  return 0;
}

}  // namespace

int repro::ssd_scan(const void* x, const float* dt, const float* A, const void* B,
                    const void* C, void* y, float* h_final, DType dtype, int batch, int L,
                    int H, int G, int P, int N, int chunk, const int64_t* x_strides,
                    const int64_t* dt_strides, const int64_t* b_strides,
                    const int64_t* c_strides, void* stream) {
  // the wrapper checks these too; a bad call must never reach the launch
  if (batch <= 0 || batch > 65535 || L <= 0 || H <= 0 || G <= 0 || H % G != 0 || P <= 0 ||
      P > kMaxP || N <= 0 || N > kMaxN || chunk <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int Q = chunk < L ? chunk : L;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int err;
  switch (dtype) {
    case kF32:
      err = launch<float>(x, dt, A, B, C, y, h_final, batch, L, H, G, P, N, Q, x_strides,
                          dt_strides, b_strides, c_strides, st);
      break;
    case kBF16:
      err = launch<__nv_bfloat16>(x, dt, A, B, C, y, h_final, batch, L, H, G, P, N, Q, x_strides,
                                  dt_strides, b_strides, c_strides, st);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != 0) return err;
  return static_cast<int>(cudaGetLastError());
}
