// Mamba-2 SSD chunked scan (forward) on Hopper's tensor cores (sm_90a):
// the route of bf16 x with head_dim P and state N multiples of 16, P <= 64,
// N <= 128 and chunks of at most 2048 rows (every Mamba-2 config of the
// repo: P 64, N 128, chunk 256). f32 and other shapes keep ssd_scan.cu on
// the CUDA cores; kernels/ssd_scan/ops.py `ssd_route` picks.
//
// Replaces: src/repro/kernels/ssd_scan/kernel.py `ssd_scan_fwd` (body
// `_ssd_kernel`), reached by Model(cfg, ssd_impl="pallas").forward / loss
// through apply_ssm's scan of every "ssd" layer, and by the serve path's
// prefill, which also takes the final state. It computes what ssd_scan.cu
// computes (see its note): y in x's type, rows >= L counted as dt = 0 and
// x = B = C = 0 and never read, and, where h_final is not null, the state
// after the last row in f32 [batch, H, P, N].
//
// Bound on this card: at the main path's shape (4 x 2048 tokens, 64 heads
// of P 64, N 128, chunk 256) the causal-useful products, ~43 GFLOP, take
// 0.0435 ms at the bf16 tensor-core rate, and the inputs and y, ~140 MB,
// ~0.042 ms at the HBM rate. The chunk states' workspace (f32 [batch,
// chunks - 1, H, P, N], 59 MB there) is written by step 1, read and
// rewritten by step 2 and read by step 3: ~0.07 ms more where none of it
// stays in the 50 MB L2. The hi + lo operands below double the products.
//
// Design: the chunked decomposition of Mamba-2's own GPU kernels, where
// only the middle step is sequential, over chunks of Q rows:
//   1. ssd_chunk_state_kernel, one warpgroup per (head, chunk, batch row)
//      for every chunk but the last (every chunk, the partial last one
//      included, where the final state is asked for): the chunk's prefix
//      sums cum of dt * a
//      (f64, rounded once, ssd_scan.cuh), its own contribution to the state
//      S_c = sum_i exp(cum_last - cum_i) dt_i x_i ⊗ B_i [P, N] by wgmma
//      m64n128k16 (A = (w o x)^T in registers, built from x's transposed
//      ldmatrix fragments; B = the B rows, MN-major), and its decay
//      exp(cum_last), into the workspace;
//   2. ssd_state_pass_kernel, one thread per eight state elements of a
//      (batch row, head): h_{c+1} = exp(cum_last,c) h_c + S_c in f32,
//      walking the chunks in order and writing each state in place over the
//      S it consumed, already split into the bf16 hi and lo step 3 takes;
//      the final state, where asked for, is the state after the last chunk's
//      own step, written whole in f32 to h_final instead (its workspace slot
//      is read by no chunk: the workspace holds nc slots then, nc - 1 else);
//   3. ssd_chunk_out_kernel, one block per (head, chunk, batch row), two
//      warpgroups: y_I = sum_{J <= I} ((C_I B_J^T) o exp(cum_I - cum_J) o
//      dt_J) x_J + exp(cum_I) (C_I h^T) for each 64-row tile I, h the state
//      entering the chunk. A warpgroup takes tiles (0, 3) or (1, 2), so both
//      have five tile pairs (I, J <= I); the state, dt, cum, the C tiles and
//      every tile J of B and x are staged once for the chunk and stay, so no
//      barrier separates the pairs. Scores and the inter-chunk term by
//      wgmma m64n64k16 from shared memory (C, B and h K-major); S' x_J by
//      wgmma with S' in registers (the scores' accumulator layout is the A
//      fragment's) and x_J MN-major. Left of a warp's 16 rows the decay is
//      exp(cum_i - cum_R) exp(cum_R - cum_j), R the warp's first row: both
//      factors <= 1, since cum falls along the chunk, one exp a row and one
//      a column instead of one a pair, and a pair off the diagonal tile
//      takes no branch; on the warp's 16 x 16 diagonal block it is one exp
//      a pair, masked before the exp, so a masked pair never overflows;
//      right of it zero. A longer chunk is taken four tiles at a
//      time (I-groups), its J tiles four at a time (J-groups).
// At the main shape: 1,792 blocks of 4 warps for step 1, 2,048 of 8 for
// step 3, against ssd_scan.cu's 256. Operands come by cp.async: into
// 128-byte swizzled panels of 64 rows (the 16-byte piece k of row r at
// (k ^ r % 8) * 16, as TMA's 128-byte swizzle lays them out and wgmma
// reads them), and x for step 1's ldmatrix into rows padded by 16 bytes.
// Step 3's block takes 197 KB of shared memory, one an SM (its two
// warpgroups run independently, as two blocks would); step 1's 53 KB.
// A block per 64-row tile would stage the same state, dt and tiles once a
// tile, and a barrier per J would leave most warps idle (the triangle):
// hence a block a chunk, balanced tile pairs, every J tile resident. A
// block per tile pair with one warpgroup streaming its J tiles (~100 KB,
// two an SM) was slower in bring-up builds.
// scripts/ssd_scan_ablation.py times this source with parts of the output
// kernel taken out (its loads alone, no S' x_J, no lo halves).
//
// Precision. x, B and C are bf16 inputs and enter a bf16 product exactly.
// The three operands that are f32 values — step 1's w o x (w = exp(cum_last
// - cum_i) dt_i, on x's side), step 3's scores S o decay o dt and the state
// h — enter as a bf16 pair hi + lo, hi the nearest bf16 and lo the nearest
// bf16 to what hi leaves: two products into one f32 accumulator, ~16
// significant bits of the operand. A single bf16 rounding of them moves y
// by about half a bf16 ulp of each (batch, head)'s max |y| before y's own
// rounding (another half), which breaks the one-ulp check against the
// plain scan; the pair moves it by less than a hundredth of that ulp
// (kernels/ssd_scan/ref.py `ssd_scan_chunked_ref`, the plain model of this
// route; tests/test_torch_ssm.py holds both).

#include "common.cuh"
#include "mma.cuh"
#include "ssd_scan.cuh"
#include "wgmma.cuh"

namespace {

using bf16 = __nv_bfloat16;
using repro::bits;
using repro::cp_async16;
using repro::cp_async_commit;
using repro::cp_async_wait;
using repro::ldsm_x4_trans;
using repro::smem_u32;
using repro::fence_regs;
using repro::smem_desc;
using repro::wgmma_commit;
using repro::wgmma_fence;
using repro::wgmma_rs;
using repro::wgmma_ss;
using repro::wgmma_wait_all;

constexpr int kR = 64;                  // rows of a chunk tile
constexpr int kWarps = 4;               // a tile's warps, each 16 rows of it
constexpr int kThreads = kWarps * 32;   // step 1's block
constexpr int kGroup = 4;               // tiles step 3's block takes at once
constexpr int kOutWarps = 8;            // step 3's: two warpgroups, a tile each at a time
constexpr int kPanel = kR * 128;        // a 128-byte swizzled panel of kR rows
constexpr int kOutThreads = kOutWarps * 32;
constexpr int kMaxP = 64;
constexpr int kMaxN = 128;
constexpr int kPad = 8;                 // bf16 after each shared row: 16 bytes
constexpr int kMaxSmem = 232448;

__host__ __device__ __forceinline__ int round_up(int v, int m) { return (v + m - 1) / m * m; }

// Shared memory of the two tiled kernels, in bytes. Step 1: two B tiles of
// two 128-byte swizzled panels, two x tiles of rows of P + kPad bf16, dt
// (later w) and cum of Qp = Q rounded up to kR floats each, 1024 bytes to
// align the panels. Step 3: swizzled panels (C and B tiles two each, x tiles
// one, the state's hi and lo two each), dt and cum, kR column factors a
// warp, and the 1024 bytes.
size_t state_smem(int P, int Qp) {
  return static_cast<size_t>(4 * kPanel + 2 * kR * (P + kPad) * 2 + 2 * Qp * 4 + 1024);
}
size_t out_smem(int Qp) {
  return static_cast<size_t>(5 * kGroup + 4) * kPanel + (2 * Qp + kOutWarps * kR) * 4 + 1024;
}

// hi = the nearest bf16 pair to (a, b), lo = the nearest to what hi leaves
__device__ __forceinline__ void split2(float a, float b, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  hi = bits(h);
  lo = bits(__floats2bfloat162_rn(a - hf.x, b - hf.y));
}

// the bf16 pair in r, times (w0, w1) in f32, split into hi and lo
__device__ __forceinline__ void split_scaled(uint32_t r, float w0, float w1, uint32_t& hi,
                                             uint32_t& lo) {
  const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&r));
  split2(f.x * w0, f.y * w1, hi, lo);
}

// rows [r0, r0 + kR) of a bf16 operand with `cols` columns and row stride
// st (elements) into dst [kR][cols + kPad] by cp.async; rows >= nr are
// zero-filled and not read
__device__ __forceinline__ void stage_tile(bf16* dst, const bf16* src, int64_t st, int r0,
                                           int nr, int cols) {
  const int per_row = cols / 8;   // 16-byte pieces
  for (int i = threadIdx.x; i < kR * per_row; i += blockDim.x) {
    const int r = i / per_row;
    const int c = i - r * per_row;
    const bool valid = r < nr;
    const bf16* s = valid ? src + (r0 + r) * st + c * 8 : src;
    cp_async16(smem_u32(dst + r * (cols + kPad) + c * 8), s, valid);
  }
}

// dt of the chunk's rows [0, nv) into dt_s [Qp] by cp.async (zeros after),
// as one commit group
__device__ __forceinline__ void stage_dt(float* dt_s, const float* dtb, int64_t dt_st, int nv,
                                         int Qp) {
  for (int i = threadIdx.x; i < Qp; i += blockDim.x)
    repro::cp_async4(smem_u32(dt_s + i), i < nv ? dtb + i * dt_st : dtb, i < nv);
  cp_async_commit();
}

// cum_s from dt_s by warp 0, once the dt group is in (every group after it
// may still be in flight); ends with the block's barrier
template <int kLater>
__device__ __forceinline__ void chunk_cum(const float* dt_s, float* cum_s, int Q, float a) {
  cp_async_wait<kLater>();
  __syncthreads();
  if (threadIdx.x < 32) repro::ssd_chunk_cum(dt_s, cum_s, Q, a, threadIdx.x);
  __syncthreads();
}

// rows [r0, r0 + kR) of a bf16 operand with `cols` columns into kPanels
// 128-byte swizzled panels of kR rows (panel p holds columns [64 p, 64 p +
// 64), row r's 16-byte piece k at (k ^ r % 8) * 16, as wgmma reads them);
// rows >= nr and columns >= cols are zero-filled and not read
template <int kPanels>
__device__ __forceinline__ void stage_swizzled(unsigned char* dst, const bf16* src, int64_t st,
                                               int r0, int nr, int cols) {
  constexpr int kPieces = kPanels * 8;   // 16-byte pieces a row
  for (int i = threadIdx.x; i < kR * kPieces; i += blockDim.x) {
    const int r = i / kPieces;
    const int k = i % kPieces;
    const bool valid = r < nr && k * 8 < cols;
    cp_async16(smem_u32(dst + (k >> 3) * kPanel + r * 128 + (((k & 7) ^ (r & 7)) << 4)),
               valid ? src + (r0 + r) * st + k * 8 : src, valid);
  }
}

// ---- step 1: each chunk's own contribution to the state ------------------
// One warpgroup a (head, chunk, batch row) for every chunk but the last (and
// for the last, partial or whole, where the final state is asked for):
// S [P, N] = (w o x)^T B over the chunk's rows by wgmma m64n128k16, A = (w o
// x)^T in registers as hi + lo (built from x's transposed ldmatrix
// fragments), B = the B rows MN-major from 128-byte swizzled panels.
__global__ void __launch_bounds__(kThreads)
    ssd_chunk_state_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
                           const float* __restrict__ A, const bf16* __restrict__ Bm,
                           float* __restrict__ states, float* __restrict__ decays, int L, int H,
                           int G, int P, int N, int Q, int64_t x_sb, int64_t x_st, int64_t x_sh,
                           int64_t dt_sb, int64_t dt_st, int64_t dt_sh, int64_t b_sb,
                           int64_t b_st, int64_t b_sg) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  unsigned char* b_s = smem_raw + (((raw + 1023u) & ~1023u) - raw);   // [2][2 panels]
  const int ldp = P + kPad;
  const int Qp = round_up(Q, kR);
  bf16* x_s = reinterpret_cast<bf16*>(b_s + 4 * kPanel);         // [2][kR][ldp]
  float* w_s = reinterpret_cast<float*>(x_s + 2 * kR * ldp);     // [Qp]: dt, then w
  float* cum_s = w_s + Qp;                                       // [Qp]

  const int h = blockIdx.x;
  const int c = blockIdx.y;
  const int b = blockIdx.z;
  // the workspace's slots a batch row: every chunk that hands on a state
  // (all but the last, all whole), and the last where the final state is
  // asked for, which may be partial: its rows >= L take dt = 0 and zeros
  const int nws = gridDim.y;
  const int g = h * G / H;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t c0 = static_cast<int64_t>(c) * Q;
  const int nv = L - c0 < Q ? static_cast<int>(L - c0) : Q;   // valid rows
  const int tiles = (nv + kR - 1) / kR;
  const bf16* xb = x + b * x_sb + h * x_sh + c0 * x_st;
  const bf16* bb = Bm + b * b_sb + g * b_sg + c0 * b_st;

  stage_dt(w_s, dt + b * dt_sb + h * dt_sh + c0 * dt_st, dt_st, nv, Qp);
  stage_tile(x_s, xb, x_st, 0, min(kR, nv), P);
  stage_swizzled<2>(b_s, bb, b_st, 0, min(kR, nv), N);
  cp_async_commit();
  chunk_cum<1>(w_s, cum_s, Q, A[h]);
  const float cum_last = cum_s[Q - 1];
  for (int i = threadIdx.x; i < Q; i += kThreads)
    w_s[i] = expf(cum_last - cum_s[i]) * w_s[i];   // rows >= Q keep w = dt = 0
  if (threadIdx.x == 0) decays[(static_cast<int64_t>(b) * nws + c) * H + h] = expf(cum_last);

  // d[4 j + 2 r + e] is S's row (of P) 16 warp + lane / 4 + 8 r, column
  // (of N) 8 j + 2 (lane % 4) + e
  float d[64];
#pragma unroll
  for (int k = 0; k < 64; ++k) d[k] = 0.f;
  const bool rows_of_p = warp * 16 < P;   // a warp past P feeds zeros
  const int mi = lane >> 3;   // the 8x8 matrix whose row address this lane gives
  const int mr = lane & 7;
  for (int t = 0; t < tiles; ++t) {
    if (t + 1 < tiles) {
      const int r0 = (t + 1) * kR;
      const int nxt = (t + 1) & 1;
      stage_tile(x_s + nxt * kR * ldp, xb, x_st, r0, min(kR, nv - r0), P);
      stage_swizzled<2>(b_s + nxt * 2 * kPanel, bb, b_st, r0, min(kR, nv - r0), N);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();   // tile t (and, at t = 0, w) is in
    const bf16* xt = x_s + (t & 1) * kR * ldp;
    const int rows = min(kR, nv - t * kR);
    // A = (w o x)^T for the tile's k16 steps: x is stored [row][P], so a
    // transposed ldmatrix gives x^T's fragment, scaled and split in registers
    uint32_t ahi[kR / 16][4], alo[kR / 16][4];
#pragma unroll
    for (int kk = 0; kk < kR / 16; ++kk) {
      uint32_t ax[4] = {0u, 0u, 0u, 0u};
      if (rows_of_p && kk * 16 < rows)
        ldsm_x4_trans(ax, smem_u32(xt + (kk * 16 + (mi >> 1) * 8 + mr) * ldp + warp * 16 +
                                   (mi & 1) * 8));
      const int i0 = t * kR + kk * 16 + (lane & 3) * 2;
      const float w0 = w_s[i0], w1 = w_s[i0 + 1], w8 = w_s[i0 + 8], w9 = w_s[i0 + 9];
      split_scaled(ax[0], w0, w1, ahi[kk][0], alo[kk][0]);
      split_scaled(ax[1], w0, w1, ahi[kk][1], alo[kk][1]);
      split_scaled(ax[2], w8, w9, ahi[kk][2], alo[kk][2]);
      split_scaled(ax[3], w8, w9, ahi[kk][3], alo[kk][3]);
    }
    const uint32_t ba = smem_u32(b_s + (t & 1) * 2 * kPanel);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kR / 16; ++kk) {
      if (kk * 16 >= rows) break;
      wgmma_rs(d, ahi[kk], smem_desc(ba + kk * 16 * 128, kPanel, 1024));
      wgmma_rs(d, alo[kk], smem_desc(ba + kk * 16 * 128, kPanel, 1024));
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(d);
    fence_regs(ahi);
    fence_regs(alo);
    __syncthreads();   // everyone is done with buffer t & 1 before it is refilled
  }

  if (rows_of_p) {
    float* sb = states + ((static_cast<int64_t>(b) * nws + c) * H + h) * P * N;
    const int p0 = warp * 16 + (lane >> 2);
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int n = 8 * j + (lane & 3) * 2;
      if (n >= N) break;
      *reinterpret_cast<float2*>(sb + p0 * N + n) = make_float2(d[4 * j], d[4 * j + 1]);
      *reinterpret_cast<float2*>(sb + (p0 + 8) * N + n) = make_float2(d[4 * j + 2], d[4 * j + 3]);
    }
  }
}

// ---- step 2: the states entering chunks 1 .. nc - 1 ----------------------
// Slot c of the workspace holds S_c (f32 [P, N]) on entry and h_{c+1} =
// exp(cum_last,c) h_c + S_c (h_0 = 0, summed in f32) on exit, split as step
// 3 takes it: each run of 8 elements (32 bytes) becomes their 8 bf16 hi
// (16 bytes) then their 8 bf16 lo, in place. With h_final, the last of the
// nws slots is the last chunk's: the state after it goes to h_final [batch,
// H, P, N] whole in f32, and the slot is left as it is. One thread a run
// of 8.
__global__ void __launch_bounds__(256)
    ssd_state_pass_kernel(float* __restrict__ states, const float* __restrict__ decays,
                          float* __restrict__ h_final, int batch, int nws, int H, int PN8) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= static_cast<int64_t>(batch) * H * PN8) return;
  const int e = static_cast<int>(i % PN8);
  const int64_t bh = i / PN8;
  const int h = static_cast<int>(bh % H);
  const int64_t b = bh / H;
  float run[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int c = 0; c < nws; ++c) {
    const int64_t slot = (b * nws + c) * H + h;
    uint4* p = reinterpret_cast<uint4*>(states) + (slot * PN8 + e) * 2;
    const float d = decays[slot];
    const uint4 s0 = p[0];
    const uint4 s1 = p[1];
    const float s[8] = {__uint_as_float(s0.x), __uint_as_float(s0.y), __uint_as_float(s0.z),
                        __uint_as_float(s0.w), __uint_as_float(s1.x), __uint_as_float(s1.y),
                        __uint_as_float(s1.z), __uint_as_float(s1.w)};
    uint32_t hi[4], lo[4];
#pragma unroll
    for (int k = 0; k < 8; ++k) run[k] = fmaf(d, run[k], s[k]);
    if (h_final != nullptr && c == nws - 1) {
      float4* f = reinterpret_cast<float4*>(h_final + (bh * PN8 + e) * 8);
      f[0] = make_float4(run[0], run[1], run[2], run[3]);
      f[1] = make_float4(run[4], run[5], run[6], run[7]);
      break;
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) split2(run[2 * k], run[2 * k + 1], hi[k], lo[k]);
    p[0] = make_uint4(hi[0], hi[1], hi[2], hi[3]);
    p[1] = make_uint4(lo[0], lo[1], lo[2], lo[3]);
  }
}

// ---- step 3: y, one chunk a block, on wgmma --------------------------------
// The chunk's 64-row tiles are taken kGroup at a time (an I-group), a tile
// a warpgroup: warpgroup w takes tiles I_0 = g0 + w and I_1 = g0 + 3 - w,
// so both have the same number of tile pairs (I, J <= I): 1 + 4 or 2 + 3.
// nws is the workspace's slots a batch row (step 2's).
// Tiles J of B and x are staged kGroup at a time (a J-group) and stay while
// each warpgroup takes the pairs it needs, with no barrier between them;
// only the first tile of a J-group is waited for before the work starts.
__global__ void __launch_bounds__(kOutThreads, 1)
    ssd_chunk_out_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
                         const float* __restrict__ A, const bf16* __restrict__ Bm,
                         const bf16* __restrict__ Cm, const float* __restrict__ states,
                         bf16* __restrict__ y, int nws, int L, int H, int G, int P, int N, int Q,
                         int64_t x_sb, int64_t x_st, int64_t x_sh, int64_t dt_sb, int64_t dt_st,
                         int64_t dt_sh, int64_t b_sb, int64_t b_st, int64_t b_sg, int64_t c_sb,
                         int64_t c_st, int64_t c_sg) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // the swizzled panels need a 1024-byte aligned base
  const uint32_t raw = smem_u32(smem_raw);
  unsigned char* c_s = smem_raw + (((raw + 1023u) & ~1023u) - raw);   // [kGroup][2 panels]
  unsigned char* h_s = c_s + kGroup * 2 * kPanel;   // [hi, lo][2 panels]: the state [P][N]
  unsigned char* b_s = h_s + 4 * kPanel;            // [kGroup][2 panels]: the J-group's B
  unsigned char* x_s = b_s + kGroup * 2 * kPanel;   // [kGroup][1 panel]: its x
  const int Qp = round_up(Q, kR);
  float* dt_s = reinterpret_cast<float*>(x_s + kGroup * kPanel);   // [Qp]
  float* cum_s = dt_s + Qp;                                         // [Qp]
  float* g_s = cum_s + Qp;                                          // [kOutWarps][kR]

  const int h = blockIdx.x;
  const int c = blockIdx.y;
  const int b = blockIdx.z;
  const int64_t c0 = static_cast<int64_t>(c) * Q;
  const int nv = L - c0 < Q ? static_cast<int>(L - c0) : Q;   // valid rows
  const int tiles = (nv + kR - 1) / kR;
  const int g = h * G / H;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int wg = warp / 4;   // the warpgroup
  const int wq = warp % 4;   // the warp's 16 rows of each of the warpgroup's tiles
  const int qc = (lane & 3) * 2;
  const bf16* xb = x + b * x_sb + h * x_sh + c0 * x_st;
  const bf16* bb = Bm + b * b_sb + g * b_sg + c0 * b_st;
  const bf16* cb = Cm + b * c_sb + g * c_sg + c0 * c_st;
  float* gw = g_s + warp * kR;
  const uint32_t c_a = smem_u32(c_s);
  const uint32_t h_a = smem_u32(h_s);
  const uint32_t b_a = smem_u32(b_s);
  const uint32_t x_a = smem_u32(x_s);

  stage_dt(dt_s, dt + b * dt_sb + h * dt_sh + c0 * dt_st, dt_st, nv, Qp);
  if (c > 0) {   // the state entering the chunk, as step 2 split it
    const char* hs = reinterpret_cast<const char*>(
        states + ((static_cast<int64_t>(b) * nws + c - 1) * H + h) * P * N);
    const int per_row = N / 4;   // 16-byte pieces a row of h: hi and lo of N / 8 runs
    for (int i = threadIdx.x; i < P * per_row; i += blockDim.x) {
      const int row = i / per_row;
      const int col = ((i - row * per_row) >> 1) * 8;   // the piece's first column
      cp_async16(smem_u32(h_s + ((i & 1) * 2 + (col >> 6)) * kPanel + row * 128 +
                          ((((col & 63) >> 3) ^ (row & 7)) << 4)),
                 hs + i * 16, true);
    }
  }
  for (int g0 = 0; g0 < tiles; g0 += kGroup) {
    const int last = min(g0 + kGroup, tiles) - 1;   // the I-group's last tile
    const int It[2] = {g0 + wg, g0 + kGroup - 1 - wg};   // the warpgroup's two tiles
    const bool act[2] = {It[0] <= last, It[1] <= last};
    float o[2][32];   // y of the two tiles: o[t][4 j + 2 r + e] is row 16 wq + lane / 4 + 8 r,
                      // column 8 j + qc + e
    float er[2][2] = {{0.f, 0.f}, {0.f, 0.f}};   // exp(cum_i - cum_R) <= 1, R the warp's first row

    if (g0 > 0) __syncthreads();   // the last I-group is done with the C tiles
    for (int t = g0; t <= last; ++t)
      stage_swizzled<2>(c_s + (t - g0) * 2 * kPanel, cb, c_st, t * kR, min(kR, nv - t * kR), N);
    for (int j0 = 0; j0 <= last; j0 += kGroup) {
      const int jlast = min(j0 + kGroup - 1, last);   // the J-group's last tile
      if (j0 > 0) __syncthreads();   // the last J-group is done with the tiles
      for (int J = j0; J <= jlast; ++J) {   // the first tile, then the rest
        const int nr = min(kR, nv - J * kR);
        stage_swizzled<2>(b_s + (J - j0) * 2 * kPanel, bb, b_st, J * kR, nr, N);
        stage_swizzled<1>(x_s + (J - j0) * kPanel, xb, x_st, J * kR, nr, P);
        if (J == j0 || J == jlast) cp_async_commit();
      }
      if (jlast == j0) cp_async_commit();   // an empty second group keeps the count
      if (g0 == 0 && j0 == 0) chunk_cum<2>(dt_s, cum_s, Q, A[h]);
      cp_async_wait<1>();
      __syncthreads();   // the C tiles, the state and the J-group's first tile are in

      if (j0 == 0) {
#pragma unroll
        for (int t = 0; t < 2; ++t) {
#pragma unroll
          for (int k = 0; k < 32; ++k) o[t][k] = 0.f;
          if (!act[t]) continue;
          const int R = It[t] * kR + 16 * wq;
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int i = R + 8 * r + (lane >> 2);
            if (i < nv) er[t][r] = expf(cum_s[i] - cum_s[R]);
          }
          if (c > 0) {   // exp(cum_i) C_I h^T over N in k16 steps, h as hi + lo
            const uint32_t ca = c_a + (It[t] - g0) * 2 * kPanel;
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < kMaxN / 16; ++kk) {
              if (kk * 16 >= N) break;
              const uint32_t off = (kk >> 2) * kPanel + (kk & 3) * 32;
              wgmma_ss(o[t], smem_desc(ca + off, 16, 1024), smem_desc(h_a + off, 16, 1024),
                       kk > 0);
              wgmma_ss(o[t], smem_desc(ca + off, 16, 1024),
                       smem_desc(h_a + 2 * kPanel + off, 16, 1024), 1);
            }
            wgmma_commit();
            wgmma_wait_all();
            fence_regs(o[t]);
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              const int i = It[t] * kR + 16 * wq + 8 * r + (lane >> 2);
              const float f = i < nv ? expf(cum_s[i]) : 0.f;
#pragma unroll
              for (int j = 0; j < 8; ++j) {
                o[t][4 * j + 2 * r] *= f;
                o[t][4 * j + 2 * r + 1] *= f;
              }
            }
          }
        }
      }

      for (int J = j0; J <= jlast; ++J) {
        if (J == j0 + 1) {   // the rest of the J-group
          cp_async_wait<0>();
          __syncthreads();
        }
        const int jb = J * kR;
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          if (!act[t] || J > It[t]) continue;
          const int R = It[t] * kR + 16 * wq;   // the warp's first row
          const int diag = J == It[t] ? wq : kR / 16;   // the warp's diagonal block, if any
          // column factors exp(cum_R - cum_j) dt_j <= dt_j of the columns left
          // of the warp's rows; its diagonal block is taken whole below
#pragma unroll
          for (int k = lane; k < kR; k += 32) {
            const int j = jb + k;
            gw[k] = j < R && j < nv ? expf(cum_s[R] - cum_s[j]) * dt_s[j] : 0.f;
          }
          __syncwarp();
          // scores C_I B_J^T over N in k16 steps
          float sc[32];
          const uint32_t ca = c_a + (It[t] - g0) * 2 * kPanel;
          const uint32_t ba = b_a + (J - j0) * 2 * kPanel;
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < kMaxN / 16; ++kk) {
            if (kk * 16 >= N) break;
            const uint32_t off = (kk >> 2) * kPanel + (kk & 3) * 32;
            wgmma_ss(sc, smem_desc(ca + off, 16, 1024), smem_desc(ba + off, 16, 1024), kk > 0);
          }
          wgmma_commit();
          wgmma_wait_all();
          fence_regs(sc);
          // o exp(cum_i - cum_j) o dt_j where j <= i < nv: left of the warp's
          // rows as exp(cum_i - cum_R) exp(cum_R - cum_j) dt_j, both factors
          // <= 1 (cum falls along the chunk); on its diagonal block whole,
          // masked before the exp; right of it zero. Then as hi + lo pairs,
          // laid out as the A fragments of S' x_J
          uint32_t ph[4][4], pl[4][4];
          if (J < It[t]) {   // left of every row of the tile: all factored, no branch
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              const float2 gk = *reinterpret_cast<const float2*>(gw + 8 * j + qc);
#pragma unroll
              for (int r = 0; r < 2; ++r)
                split2(sc[4 * j + 2 * r] * er[t][r] * gk.x, sc[4 * j + 2 * r + 1] * er[t][r] * gk.y,
                       ph[j / 2][2 * (j % 2) + r], pl[j / 2][2 * (j % 2) + r]);
            }
          } else {
#pragma unroll
            for (int j = 0; j < 8; ++j)
#pragma unroll
              for (int r = 0; r < 2; ++r) {
                float v[2];
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                  const int k = 8 * j + qc + e;
                  const float s = sc[4 * j + 2 * r + e];
                  if (j / 2 < diag) {
                    v[e] = s * er[t][r] * gw[k];
                  } else if (j / 2 == diag) {
                    const int i = R + 8 * r + (lane >> 2);
                    const int jj = jb + k;
                    v[e] = i < nv && jj <= i ? s * expf(cum_s[i] - cum_s[jj]) * dt_s[jj] : 0.f;
                  } else {
                    v[e] = 0.f;
                  }
                }
                // A fragment of k16 step j / 2: register 2 (j % 2) + r
                split2(v[0], v[1], ph[j / 2][2 * (j % 2) + r], pl[j / 2][2 * (j % 2) + r]);
              }
          }
          __syncwarp();   // the warp is done with gw before its next pair writes it
          // y_I += S' x_J over the tile's rows in k16 steps, x_J MN-major
          const uint32_t xa = x_a + (J - j0) * kPanel;
          wgmma_fence();
#pragma unroll
          for (int st = 0; st < kR / 16; ++st) {
            wgmma_rs(o[t], ph[st], smem_desc(xa + st * 16 * 128, kPanel, 1024));
            wgmma_rs(o[t], pl[st], smem_desc(xa + st * 16 * 128, kPanel, 1024));
          }
          wgmma_commit();
          wgmma_wait_all();
          fence_regs(o[t]);
          fence_regs(ph);
          fence_regs(pl);
        }
      }
      cp_async_wait<0>();   // (a J-group of one tile leaves an empty group)
    }

    const int64_t y_st = static_cast<int64_t>(H) * P;
    bf16* yb = y + (static_cast<int64_t>(b) * L + c0) * y_st + static_cast<int64_t>(h) * P;
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      if (!act[t]) continue;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int i = It[t] * kR + 16 * wq + 8 * r + (lane >> 2);
        if (i >= nv) continue;
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (8 * j < P)
            *reinterpret_cast<__nv_bfloat162*>(yb + i * y_st + 8 * j + qc) =
                __floats2bfloat162_rn(o[t][4 * j + 2 * r], o[t][4 * j + 2 * r + 1]);
      }
    }
  }
}

// above 48 KB a kernel must opt in to its dynamic shared memory
template <typename Kernel>
cudaError_t opt_in(Kernel kernel, size_t smem, size_t& opted) {
  if (smem <= opted) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err == cudaSuccess) opted = smem;
  return err;
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

int repro::ssd_scan_mma(const void* x, const float* dt, const float* A, const void* B,
                        const void* C, void* y, float* states, float* decays, float* h_final,
                        int batch, int L, int H, int G, int P, int N, int chunk, const int64_t* xs,
                        const int64_t* dts, const int64_t* bs, const int64_t* cs,
                        void* stream) {
  // the wrapper checks these too; a bad call must never reach the launch
  if (batch <= 0 || batch > 65535 || L <= 0 || H <= 0 || G <= 0 || H % G != 0 || P <= 0 ||
      P > kMaxP || P % 16 || N <= 0 || N > kMaxN || N % 16 || chunk <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  // 16-byte rows for cp.async
  for (int k = 0; k < 3; ++k)
    if (xs[k] % 8 || bs[k] % 8 || cs[k] % 8) return static_cast<int>(cudaErrorMisalignedAddress);
  if (!aligned16(x) || !aligned16(B) || !aligned16(C) || !aligned16(y) ||
      (h_final != nullptr && !aligned16(h_final)))
    return static_cast<int>(cudaErrorMisalignedAddress);
  const int Q = chunk < L ? chunk : L;
  const int nc = (L + Q - 1) / Q;
  const int Qp = round_up(Q, kR);
  // the workspace's slots a batch row: the last chunk's too for the final state
  const int nws = h_final != nullptr ? nc : nc - 1;
  if (nc > 65535) return static_cast<int>(cudaErrorInvalidValue);
  if (nws > 0 && (states == nullptr || decays == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem1 = state_smem(P, Qp);
  const size_t smem3 = out_smem(Qp);
  if (smem1 > kMaxSmem || smem3 > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  static size_t opted1 = 0, opted3 = 0;
  cudaError_t err = opt_in(ssd_chunk_state_kernel, smem1, opted1);
  if (err == cudaSuccess) err = opt_in(ssd_chunk_out_kernel, smem3, opted3);
  if (err != cudaSuccess) return static_cast<int>(err);

  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16* xt = static_cast<const bf16*>(x);
  const bf16* bt = static_cast<const bf16*>(B);
  const bf16* ct = static_cast<const bf16*>(C);
  if (nws > 0) {
    ssd_chunk_state_kernel<<<dim3(H, nws, batch), kThreads, smem1, st>>>(
        xt, dt, A, bt, states, decays, L, H, G, P, N, Q, xs[0], xs[1], xs[2], dts[0], dts[1],
        dts[2], bs[0], bs[1], bs[2]);
    const int pn8 = P * N / 8;
    const int64_t threads = static_cast<int64_t>(batch) * H * pn8;
    ssd_state_pass_kernel<<<static_cast<unsigned>((threads + 255) / 256), 256, 0, st>>>(
        states, decays, h_final, batch, nws, H, pn8);
  }
  ssd_chunk_out_kernel<<<dim3(H, nc, batch), kOutThreads, smem3, st>>>(
      xt, dt, A, bt, ct, states, static_cast<bf16*>(y), nws, L, H, G, P, N, Q, xs[0], xs[1], xs[2],
      dts[0], dts[1], dts[2], bs[0], bs[1], bs[2], cs[0], cs[1], cs[2]);
  return static_cast<int>(cudaGetLastError());
}
