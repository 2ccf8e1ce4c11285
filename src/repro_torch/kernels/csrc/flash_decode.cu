// Flash-decode for Hopper (sm_90a): one query token per slot against the
// slot's first kv_len cached positions, for the two cache layouts of the
// serve path. Every kernel here is templated on the address rule that says
// which cache row holds position t of slot b:
//
//   PagedRows       arena row table[b, t / ps] * ps + t % ps   (launchers
//                   flash_decode_paged*: arenas [pages, ps, K, D])
//   ContiguousRows  row b * Smax + t                            (launchers
//                   flash_decode*: caches [B, Smax, K, D])
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
// per byte at which the tensor cores become the limit. At long context
// (16 slots of 2-4k positions, 8 kv heads) that is 202 MB of bf16, 0.060
// ms at 3.35 TB/s: the kernel must keep the whole card's memory system
// busy, which one block per (slot, kv head) walking its positions in
// series cannot (128 blocks of scalar loads, ~3% of the rate).
//
// Two routes, chosen by the wrapper (kernels/flash_attention/ops.py) by
// dtype and shape alone:
//
// tensor_core (bf16 q, bf16 or int8 caches, D in {64, 128, 256}, G <= 16):
// - Split-KV over the card (flash-decoding). The grid is (slot x kv head,
//   split); split s owns positions [s * chunk, (s + 1) * chunk), chunk a
//   multiple of kTile that the wrapper derives from host-known sizes only
//   (B, K, the capacity, the SM count), so the launch never reads kv_len on
//   the host. Each split writes its partial (m, l, acc[G, D]) in f32 to
//   scratch, and fd_combine_kernel merges them with log-sum-exp weights
//   into o; with one split the block writes o itself and there is no
//   second launch. A split wholly past kv_len writes m = -1e30 (finite, so
//   exp2(m_s - M) has no NaN when every split of a slot is empty), l = 0,
//   acc = 0; a kv_len == 0 slot then combines to exact zeros.
// - Loads. Each of a block's four warps streams its own 16-position
//   sub-tiles (warp w takes sub-tiles w, w + 4, ... of its split) through a
//   private ring in shared memory with 16-byte cp.async.cg, so two (bf16)
//   or four (int8, whose sub-tiles are half the bytes) sub-tiles are in
//   flight while one is scored, and no block barrier sits in the loop.
//   Paged rows resolve through the page table as the sub-tile is issued
//   (one table read per row, by lanes 0-15, shared by shuffle). Rows past
//   kv_len are zero-filled (src-size 0), never read. Every shared row is
//   padded by 16 bytes, so ldmatrix's eight rows fall in distinct bank
//   groups. int8 rows come in with their f32 scales; ldmatrix reads their
//   codes as bytes straight into registers, where they become bf16 codes
//   (exact, since |c| <= 127) by integer ops; the shared q tile's columns
//   are permuted to match the bytes' order (q_column, o_column).
// - Products on the tensor cores with mma.sync.m16n8k16 (bf16 in, f32
//   accumulate): the G query rows of the kv head fill one m16 tile (rows
//   G..15 zero), so S = Q K^T of a sub-tile is two n8 tiles and needs no
//   shuffle reductions. 1/sqrt(D) (with log2 e, for exp2) and the int8 k
//   scale apply to the f32 scores after the product; the TPU body scales q
//   in f32 before it, so the two differ by f32 roundings only.
// - Softmax online per warp, on the score fragment (each thread holds two
//   rows, reduced over a quad by two shuffles). P goes from the score
//   registers straight to the A fragment of P.V (the layouts agree),
//   rounded to bf16; for int8 it carries the v scale (p * v_scale, rounded
//   once). l sums the P actually multiplied (for int8, each weight divided
//   back by its scale), so each row's weights sum to one.
// - The four warps' (m, l, O) merge in shared memory at the end of the
//   split.
//
// cuda_core (everything else the launchers take: f32 q, other head widths,
// G <= 8): one block per (slot, kv head), D threads, the online softmax
// state in shared memory and registers, all in f32 (fd_kernel below). No
// configuration of the repo's serve paths reaches it (all are bf16 at D
// 64, 128 or 256).

#include "common.cuh"
#include "mma.cuh"

namespace {

constexpr float kNegInf = -1e30f;

// position t of slot b lives at arena row table[b, t / ps] * ps + t % ps
struct PagedRows {
  const int* table;
  int max_pages, ps;
  __host__ __device__ int capacity() const { return max_pages * ps; }
  __device__ int row(int b, int t) const {
    return table[static_cast<size_t>(b) * max_pages + t / ps] * ps + t % ps;
  }
};

// position t of slot b lives at row b * Smax + t
struct ContiguousRows {
  int smax;
  __host__ __device__ int capacity() const { return smax; }
  __device__ int row(int b, int t) const { return b * smax + t; }
};

// ---- tensor_core route ---------------------------------------------------------

namespace tc {

constexpr int kWarps = 4;               // warps of a block
constexpr int kRows = 16;               // kv positions a warp takes at a time (a sub-tile)
constexpr int kTile = kWarps * kRows;   // positions a block takes at a time (ops.py DECODE_TILE)
constexpr int kThreads = kWarps * 32;
constexpr int kMaxG = 16;               // query rows of a kv head: one m16 tile
constexpr int kPad = 16;                // bytes after each shared row (bank groups)
constexpr float kLog2e = 1.4426950408889634f;

// Shared memory, in bytes: the q tile (16 bf16 rows), then per warp its
// ring, per stage a sub-tile of K rows and one of V rows (and for int8
// their 16 + 16 scales). int8 stages are half the bytes, so its rings are
// deeper: the same bytes in flight. The merge at the end reuses the space.
template <int D, typename KVT>
struct Layout {
  static constexpr bool kQuant = sizeof(KVT) == 1;
  static constexpr int kStages = kQuant ? 5 : 3;      // depth of each warp's cp.async ring
  static constexpr int kChunks = D * static_cast<int>(sizeof(KVT)) / 16;  // per cached row
  static constexpr int kRowBytes = D * static_cast<int>(sizeof(KVT)) + kPad;
  static constexpr int kQRowBytes = D * 2 + kPad;
  static constexpr int kSub = kRows * kRowBytes;      // one sub-tile of K or of V
  static constexpr int kStage = 2 * kSub + (kQuant ? 2 * kRows * 4 : 0);
  static constexpr int kQ = kMaxG * kQRowBytes;
  static constexpr int kLoop = kQ + kWarps * kStages * kStage;
  static constexpr int kOStride = D + 8;              // floats per row of a warp's O
  static constexpr int kMerge = kWarps * kMaxG * (2 + kOStride) * 4;
  static constexpr int kBytes = kLoop > kMerge ? kLoop : kMerge;
};

using repro::bits;
using repro::cp_async16;
using repro::cp_async4;
using repro::cp_async_commit;
using repro::cp_async_wait;
using repro::ldsm_x4;
using repro::ldsm_x4_trans;
using repro::mma_bf16;
using repro::smem_u32;

// Two int8 codes of the 32-bit word w, picked by the byte selector `sel`,
// as a bf16 pair: exact, and without conversion instructions. With m = c &
// 0x7f and s = c's sign bit, c = (128 + m) - (128 + 128 s), and both terms
// are bf16 bit patterns, 0x4300 | m and 0x4300 | (c & 0x80): the selector
// puts each code in the low byte of a 16-bit lane and 0x43 in its high
// byte, two masks make the terms, and c being a bf16 value (|c| <= 128
// needs 8 significant bits) makes the bf16x2 subtraction exact.
__device__ __forceinline__ uint32_t codes_bf16(uint32_t w, uint32_t sel) {
  const uint32_t pair = __byte_perm(w, 0x43434343u, sel);
  uint32_t x = pair & 0xff7fff7fu;
  uint32_t y = pair & 0xff80ff80u;
  return bits(__hsub2(*reinterpret_cast<__nv_bfloat162*>(&x),
                      *reinterpret_cast<__nv_bfloat162*>(&y)));
}

// 2^x, flushing results below 2^-126 to zero (softmax weights that small
// are zero to f32 sums of weights near one)
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float rcp_ftz(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Column of q (and k) that the shared q tile holds at column c. For int8
// caches the kernel reads K's codes by ldmatrix as bytes, so the B fragment
// of a thread holds four consecutive columns 4 tig .. 4 tig + 3 of each
// 16-column step; q's columns are stored permuted to match (the product
// sums over the same pairs of columns, in another order).
template <bool kQuant>
__device__ __forceinline__ int q_column(int c) {
  if (!kQuant) return c;
  const int j = c & 15;
  return (c & ~15) + (j < 8 ? 4 * (j >> 1) + (j & 1) : 4 * ((j - 8) >> 1) + 2 + (j & 1));
}

// Column of the output that accumulator o[n][e] (e = 0, 1; rows grp and
// grp + 8 alike) holds: n8 tile n of columns for bf16; for int8, whose V
// codes come by a transposed ldmatrix of bytes, tile 2 k + p holds the
// columns 16 k + 2 j + p of its 16-column block k
template <bool kQuant>
__device__ __forceinline__ int o_column(int n, int tig, int e) {
  if (!kQuant) return 8 * n + 2 * tig + e;
  return 16 * (n >> 1) + 2 * (2 * tig + e) + (n & 1);
}

template <int D, typename KVT, typename Rows>
__global__ void __launch_bounds__(kThreads)
    fd_mma_kernel(const __nv_bfloat16* __restrict__ q, const KVT* __restrict__ kc,
                  const KVT* __restrict__ vc, const float* __restrict__ ks,
                  const float* __restrict__ vs, const int* __restrict__ kv_len, Rows rows,
                  __nv_bfloat16* __restrict__ out, float* __restrict__ part_ml,
                  float* __restrict__ part_acc, int H, int K, int chunk, float scale_log2) {
  using L = Layout<D, KVT>;
  constexpr int kStages = L::kStages;
  extern __shared__ __align__(128) unsigned char smem[];
  const int pair = blockIdx.x, split = blockIdx.y, splits = gridDim.y;
  const int b = pair / K, kvh = pair % K, G = H / K;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int grp = lane >> 2, tig = lane & 3;
  const size_t q_row0 = static_cast<size_t>(b) * H + kvh * G;   // first of the G query rows
  const size_t part = static_cast<size_t>(pair) * splits + split;
  // never past the cache's capacity, never below zero
  const int len = max(0, min(kv_len[b], rows.capacity()));
  const int t_begin = split * chunk;
  const int t_end = min(len, t_begin + chunk);

  if (t_begin >= t_end) {   // wholly past kv_len: an empty partial (zeros if alone)
    for (int i = tid; i < G * D; i += kThreads) {
      if (splits == 1)
        out[q_row0 * D + i] = __float2bfloat16_rn(0.f);
      else
        part_acc[part * G * D + i] = 0.f;
    }
    if (splits > 1 && tid < G) {
      part_ml[part * 2 * G + tid] = kNegInf;
      part_ml[part * 2 * G + G + tid] = 0.f;
    }
    return;
  }

  // the G query rows as bf16 (columns as q_column says), rows G..15 zero
  unsigned char* q_s = smem;
  if constexpr (L::kQuant) {   // a 16-column block a thread, permuted in registers
    for (int c = tid; c < kMaxG * (D / 16); c += kThreads) {
      const int g = c / (D / 16), blk = c % (D / 16);
      int4 src[2] = {make_int4(0, 0, 0, 0), make_int4(0, 0, 0, 0)};
      if (g < G) {
        const int4* from = reinterpret_cast<const int4*>(q + (q_row0 + g) * D + blk * 16);
        src[0] = from[0];
        src[1] = from[1];
      }
      const __nv_bfloat16* v = reinterpret_cast<const __nv_bfloat16*>(src);
      int4 dst[2];
      __nv_bfloat16* w = reinterpret_cast<__nv_bfloat16*>(dst);
#pragma unroll
      for (int j = 0; j < 16; ++j) w[j] = v[q_column<true>(j)];
      int4* to = reinterpret_cast<int4*>(q_s + g * L::kQRowBytes + blk * 32);
      to[0] = dst[0];
      to[1] = dst[1];
    }
  } else {   // in 16-byte chunks
    for (int c = tid; c < kMaxG * (D / 8); c += kThreads) {
      const int g = c / (D / 8), cc = c % (D / 8);
      int4 val = make_int4(0, 0, 0, 0);
      if (g < G) val = *reinterpret_cast<const int4*>(q + (q_row0 + g) * D + cc * 8);
      *reinterpret_cast<int4*>(q_s + g * L::kQRowBytes + cc * 16) = val;
    }
  }
  __syncthreads();

  unsigned char* wbase = smem + L::kQ + warp * kStages * L::kStage;
  const int first = t_begin + warp * kRows;   // this warp's first position
  const int n_sub = first < t_end ? (t_end - first + kTile - 1) / kTile : 0;

  // sub-tile i of this warp (positions first + i * kTile + [0, 16)) into its stage
  auto issue = [&](int i) {
    const int t0 = first + i * kTile;
    unsigned char* st = wbase + (i % kStages) * L::kStage;
    int my_row = 0;
    if (lane < kRows && t0 + lane < t_end) my_row = rows.row(b, t0 + lane);
#pragma unroll
    for (int c = lane; c < kRows * L::kChunks; c += 32) {
      const int r = c / L::kChunks, cc = c % L::kChunks;
      const int row = __shfl_sync(0xffffffffu, my_row, r);
      const bool valid = t0 + r < t_end;
      const size_t off = (static_cast<size_t>(row) * K + kvh) * D + cc * (16 / sizeof(KVT));
      cp_async16(smem_u32(st + r * L::kRowBytes + cc * 16), kc + off, valid);
      cp_async16(smem_u32(st + L::kSub + r * L::kRowBytes + cc * 16), vc + off, valid);
    }
    if constexpr (L::kQuant) {   // lanes 0-15: k scales, 16-31: v scales
      const int r = lane & (kRows - 1);
      const int row = __shfl_sync(0xffffffffu, my_row, r);
      const float* src = (lane < kRows ? ks : vs) + static_cast<size_t>(row) * K + kvh;
      cp_async4(smem_u32(st + 2 * L::kSub + lane * 4), src, t0 + r < t_end);
    }
  };

  // the warp's unnormalised output (columns as o_column says) and softmax
  // state, for rows grp and grp + 8
  float o[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  // ldmatrix row addresses: q (A), V (B, transposed) and int8 K (B, as
  // bytes) by row = lane % 8 + 8 * (lane / 8 % 2), 16 bytes times lane / 16
  // along it; bf16 K (B) by row = lane % 8 + 8 * (lane / 16), 16 bytes times
  // lane / 8 % 2 along it
  const int a_row = (lane & 7) + 8 * ((lane >> 3) & 1), a_byte = 16 * (lane >> 4);
  const int k_row = L::kQuant ? a_row : (lane & 7) + 8 * (lane >> 4);
  const int k_byte = L::kQuant ? a_byte : 16 * ((lane >> 3) & 1);
  const uint32_t q_addr = smem_u32(q_s) + a_row * L::kQRowBytes + a_byte;

#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < n_sub) issue(i);
    cp_async_commit();
  }
  for (int i = 0; i < n_sub; ++i) {
    __syncwarp();   // every lane is done with the stage the next issue refills
    if (i + kStages - 1 < n_sub) issue(i + kStages - 1);
    cp_async_commit();
    cp_async_wait<kStages - 1>();
    __syncwarp();   // every lane's copies of sub-tile i have landed
    const unsigned char* st = wbase + (i % kStages) * L::kStage;
    const uint32_t k_addr = smem_u32(st) + k_row * L::kRowBytes + k_byte;
    const uint32_t v_addr = smem_u32(st + L::kSub) + a_row * L::kRowBytes + a_byte;
    const float* ksc = reinterpret_cast<const float*>(st + 2 * L::kSub);
    const float* vsc = ksc + kRows;

    // S = Q K^T: rows grp, grp + 8; positions 8 * n + 2 * tig + {0, 1}
    float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    if constexpr (L::kQuant) {
      // codes[0, 1]: positions 0-7, 8-15 of 16-column step kk; [2, 3]: step kk + 1
#pragma unroll
      for (int kk = 0; kk < D / 16; kk += 2) {
        uint32_t codes[4];
        ldsm_x4(codes, k_addr + kk * 16);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          uint32_t a[4];
          ldsm_x4(a, q_addr + (kk + h) * 32);
          mma_bf16(s[0], a, codes_bf16(codes[2 * h], 0x4140), codes_bf16(codes[2 * h], 0x4342));
          mma_bf16(s[1], a, codes_bf16(codes[2 * h + 1], 0x4140),
                   codes_bf16(codes[2 * h + 1], 0x4342));
        }
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t a[4], bk[4];
        ldsm_x4(a, q_addr + kk * 32);
        ldsm_x4(bk, k_addr + kk * 32);
        mma_bf16(s[0], a, bk[0], bk[1]);
        mma_bf16(s[1], a, bk[2], bk[3]);
      }
    }

    // scores in log2 units; positions past kv_len masked
    const int t0 = first + i * kTile;
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int n = 0; n < 2; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = 8 * n + 2 * tig + (e & 1);
        float x = s[n][e] * scale_log2;
        if constexpr (L::kQuant) x *= ksc[r];
        if (t0 + r >= t_end) x = kNegInf;
        s[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float corr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m[h], mx[h]);
      corr[h] = exp2_ftz(m[h] - m_new);
      m[h] = m_new;
      l[h] *= corr[h];
    }
    // int8: 1 / v scale of this thread's positions 2 tig + {0, 1} (+ 8), 0 past kv_len
    float rv[2][2];
    if constexpr (L::kQuant) {
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int r = 8 * n + 2 * tig + e;
          rv[n][e] = t0 + r < t_end ? rcp_ftz(vsc[r]) : 0.f;
        }
    }

    // P as the A fragment of P.V: register 2 * n + h holds row grp + 8 h,
    // positions 8 n + 2 tig + {0, 1}
    uint32_t pa[4];
#pragma unroll
    for (int n = 0; n < 2; ++n) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = 8 * n + 2 * tig;
        float p0 = exp2_ftz(s[n][2 * h] - m[h]);
        float p1 = exp2_ftz(s[n][2 * h + 1] - m[h]);
        if constexpr (L::kQuant) {
          p0 *= vsc[r];
          p1 *= vsc[r + 1];
        }
        const __nv_bfloat162 pb = __floats2bfloat162_rn(p0, p1);
        const float b0 = __low2float(pb), b1 = __high2float(pb);
        if constexpr (L::kQuant) {   // the weight of v = code * scale is P / scale
          l[h] += b0 * rv[n][0] + b1 * rv[n][1];
        } else {
          l[h] += b0 + b1;
        }
        pa[2 * n + h] = bits(pb);
      }
    }
    if (__any_sync(0xffffffffu, corr[0] != 1.f || corr[1] != 1.f)) {   // a max moved
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        o[n][0] *= corr[0];
        o[n][1] *= corr[0];
        o[n][2] *= corr[1];
        o[n][3] *= corr[1];
      }
    }

    // O += P V
    if constexpr (L::kQuant) {
      // codes[0, 1]: positions 0-7, 8-15 of 16-column block kb; [2, 3]: block
      // kb + 1; in each 32-bit register, bytes 0 and 2 are column 2 grp of
      // positions 2 tig and 2 tig + 1, bytes 1 and 3 column 2 grp + 1
#pragma unroll
      for (int kb = 0; kb < D / 16; kb += 2) {
        uint32_t codes[4];
        ldsm_x4_trans(codes, v_addr + kb * 16);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          mma_bf16(o[2 * (kb + h)], pa, codes_bf16(codes[2 * h], 0x4240),
                   codes_bf16(codes[2 * h + 1], 0x4240));
          mma_bf16(o[2 * (kb + h) + 1], pa, codes_bf16(codes[2 * h], 0x4341),
                   codes_bf16(codes[2 * h + 1], 0x4341));
        }
      }
    } else {   // n8 tiles of columns, two per ldmatrix
#pragma unroll
      for (int n = 0; n < D / 8; n += 2) {
        uint32_t bv[4];
        ldsm_x4_trans(bv, v_addr + n * 16);
        mma_bf16(o[n], pa, bv[0], bv[1]);
        mma_bf16(o[n + 1], pa, bv[2], bv[3]);
      }
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }

  // merge the four warps' (m, l, O) in shared memory
  cp_async_wait<0>();
  __syncthreads();   // the ring and q are free
  float* cm = reinterpret_cast<float*>(smem);   // [kWarps][16]
  float* cl = cm + kWarps * kMaxG;              // [kWarps][16]
  float* co = cl + kWarps * kMaxG;              // [kWarps][16][kOStride]
  if (tig == 0) {
    cm[warp * kMaxG + grp] = m[0];
    cm[warp * kMaxG + grp + 8] = m[1];
    cl[warp * kMaxG + grp] = l[0];
    cl[warp * kMaxG + grp + 8] = l[1];
  }
  float* ow = co + warp * kMaxG * L::kOStride;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    if constexpr (L::kQuant) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = o_column<true>(n, tig, e);
        ow[grp * L::kOStride + col] = o[n][e];
        ow[(grp + 8) * L::kOStride + col] = o[n][2 + e];
      }
    } else {   // columns 2 tig, 2 tig + 1 of tile n side by side
      const int col = o_column<false>(n, tig, 0);
      *reinterpret_cast<float2*>(ow + grp * L::kOStride + col) = make_float2(o[n][0], o[n][1]);
      *reinterpret_cast<float2*>(ow + (grp + 8) * L::kOStride + col) =
          make_float2(o[n][2], o[n][3]);
    }
  }
  __syncthreads();
  for (int i = tid; i < G * D; i += kThreads) {
    const int g = i / D, d = i % D;
    float mm = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mm = fmaxf(mm, cm[w * kMaxG + g]);
    float ll = 0.f, acc = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = exp2f(cm[w * kMaxG + g] - mm);
      ll += cl[w * kMaxG + g] * f;
      acc += co[(w * kMaxG + g) * L::kOStride + d] * f;
    }
    if (splits == 1) {
      out[q_row0 * D + i] = __float2bfloat16_rn(acc / fmaxf(ll, 1e-30f));
    } else {
      part_acc[part * G * D + i] = acc;
      if (d == 0) {
        part_ml[part * 2 * G + g] = mm;
        part_ml[part * 2 * G + G + g] = ll;
      }
    }
  }
}

// o = sum_s acc_s 2^(m_s - M) / max(sum_s l_s 2^(m_s - M), 1e-30), M = max_s m_s,
// over the splits of one (slot, kv head): a block per query row, a thread
// per column
__global__ void fd_combine_kernel(const float* __restrict__ part_ml,
                                  const float* __restrict__ part_acc,
                                  __nv_bfloat16* __restrict__ out, int H, int K, int D,
                                  int splits) {
  const int row = blockIdx.x, d = threadIdx.x;   // row = b * H + h
  const int G = H / K, b = row / H, h = row % H, g = h % G;
  const size_t pair = static_cast<size_t>(b) * K + h / G;
  const float* ml = part_ml + pair * splits * 2 * G;
  const float* acc = part_acc + (pair * splits * G + g) * D + d;
  float mm = kNegInf;
  for (int s = 0; s < splits; ++s) mm = fmaxf(mm, ml[s * 2 * G + g]);
  float ll = 0.f, a = 0.f;
  for (int s = 0; s < splits; ++s) {
    const float f = exp2f(ml[s * 2 * G + g] - mm);
    ll += ml[s * 2 * G + G + g] * f;
    a += acc[static_cast<size_t>(s) * G * D] * f;
  }
  out[static_cast<size_t>(row) * D + d] = __float2bfloat16_rn(a / fmaxf(ll, 1e-30f));
}

template <int D, typename KVT, typename Rows>
int launch(const void* q, const void* k, const void* v, const float* ks, const float* vs,
           const int32_t* kv_len, Rows rows, void* out, float* part_ml, float* part_acc, int B,
           int H, int K, int splits, int chunk, float sm_scale, cudaStream_t stream) {
  using L = Layout<D, KVT>;
  auto kernel = fd_mma_kernel<D, KVT, Rows>;
  // above 48 KB of dynamic shared memory only after opting in, once
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  kernel<<<dim3(B * K, splits), kThreads, L::kBytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const KVT*>(k),
      static_cast<const KVT*>(v), ks, vs, kv_len, rows, static_cast<__nv_bfloat16*>(out),
      part_ml, part_acc, H, K, chunk, sm_scale * kLog2e);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  fd_combine_kernel<<<B * H, D, 0, stream>>>(part_ml, part_acc,
                                            static_cast<__nv_bfloat16*>(out), H, K, D,
                                            splits);
  return static_cast<int>(cudaGetLastError());
}

template <int D, typename Rows>
int dispatch_kv(repro::DType kv_dtype, const void* q, const void* k, const void* v,
                const float* ks, const float* vs, const int32_t* kv_len, Rows rows, void* out,
                float* part_ml, float* part_acc, int B, int H, int K, int splits, int chunk,
                float sm_scale, cudaStream_t st) {
  if (kv_dtype == repro::kI8)
    return launch<D, int8_t>(q, k, v, ks, vs, kv_len, rows, out, part_ml, part_acc, B, H, K,
                             splits, chunk, sm_scale, st);
  if (kv_dtype == repro::kBF16)
    return launch<D, __nv_bfloat16>(q, k, v, ks, vs, kv_len, rows, out, part_ml, part_acc, B,
                                    H, K, splits, chunk, sm_scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename Rows>
int decode(const void* q, const void* k, const void* v, repro::DType kv_dtype,
           const float* ks, const float* vs, const int32_t* kv_len, Rows rows, void* out,
           float* part_ml, float* part_acc, int B, int H, int K, int D, int splits, int chunk,
           float sm_scale, void* stream) {
  // the wrappers check these too; a bad call must never reach the launch
  if (B <= 0 || K <= 0 || H % K != 0 || H / K > kMaxG || splits <= 0 || splits > 65535 ||
      chunk <= 0 || static_cast<long long>(splits) * chunk < rows.capacity() ||
      (splits > 1) != (part_ml != nullptr && part_acc != nullptr) ||
      (kv_dtype == repro::kI8) != (ks != nullptr && vs != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return dispatch_kv<64>(kv_dtype, q, k, v, ks, vs, kv_len, rows, out, part_ml, part_acc,
                             B, H, K, splits, chunk, sm_scale, st);
    case 128:
      return dispatch_kv<128>(kv_dtype, q, k, v, ks, vs, kv_len, rows, out, part_ml, part_acc,
                              B, H, K, splits, chunk, sm_scale, st);
    case 256:
      return dispatch_kv<256>(kv_dtype, q, k, v, ks, vs, kv_len, rows, out, part_ml, part_acc,
                              B, H, K, splits, chunk, sm_scale, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace tc

// ---- cuda_core route -----------------------------------------------------------

namespace cuda_core {

constexpr int kTile = 64;   // kv positions per tile
constexpr int kMaxG = 8;    // query rows per kv head a block holds

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

}  // namespace cuda_core

}  // namespace

int repro::flash_decode_paged(const void* q, DType q_dtype, const void* k, const void* v,
                              DType kv_dtype, const float* k_scale, const float* v_scale,
                              const int32_t* kv_len, const int32_t* table, void* out, int B,
                              int H, int K, int D, int ps, int max_pages, float sm_scale,
                              void* stream) {
  if (ps <= 0 || max_pages <= 0) return static_cast<int>(cudaErrorInvalidValue);
  return cuda_core::decode(q, q_dtype, k, v, kv_dtype, k_scale, v_scale, kv_len,
                           PagedRows{table, max_pages, ps}, out, B, H, K, D, sm_scale, stream);
}

int repro::flash_decode(const void* q, DType q_dtype, const void* k, const void* v,
                        DType kv_dtype, const float* k_scale, const float* v_scale,
                        const int32_t* kv_len, void* out, int B, int H, int K, int D,
                        int smax, float sm_scale, void* stream) {
  if (smax < 0) return static_cast<int>(cudaErrorInvalidValue);
  return cuda_core::decode(q, q_dtype, k, v, kv_dtype, k_scale, v_scale, kv_len,
                           ContiguousRows{smax}, out, B, H, K, D, sm_scale, stream);
}

int repro::flash_decode_paged_mma(const void* q, const void* k, const void* v, DType kv_dtype,
                                  const float* k_scale, const float* v_scale,
                                  const int32_t* kv_len, const int32_t* table, void* out,
                                  float* part_ml, float* part_acc, int B, int H, int K, int D,
                                  int ps, int max_pages, int splits, int chunk, float sm_scale,
                                  void* stream) {
  if (ps <= 0 || max_pages <= 0) return static_cast<int>(cudaErrorInvalidValue);
  return tc::decode(q, k, v, kv_dtype, k_scale, v_scale, kv_len, PagedRows{table, max_pages, ps},
                    out, part_ml, part_acc, B, H, K, D, splits, chunk, sm_scale, stream);
}

int repro::flash_decode_mma(const void* q, const void* k, const void* v, DType kv_dtype,
                            const float* k_scale, const float* v_scale, const int32_t* kv_len,
                            void* out, float* part_ml, float* part_acc, int B, int H, int K,
                            int D, int smax, int splits, int chunk, float sm_scale,
                            void* stream) {
  if (smax < 0) return static_cast<int>(cudaErrorInvalidValue);
  return tc::decode(q, k, v, kv_dtype, k_scale, v_scale, kv_len, ContiguousRows{smax}, out,
                    part_ml, part_acc, B, H, K, D, splits, chunk, sm_scale, stream);
}
