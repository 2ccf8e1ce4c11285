// Flash attention forward (prefill) on Hopper's tensor cores (sm_90a): bf16
// q, k, v with head_dim 64, 128 or 256. f32 inputs and other head widths
// take flash_attention_fwd.cu on the CUDA cores; the wrapper
// (kernels/flash_attention/ops.py `flash_attention_cuda`) picks the route.
//
// Replaces: src/repro/kernels/flash_attention/kernel.py `flash_attention_fwd`
// (body `_fa_kernel`), reached by the whole-prompt prefill of
// attention(impl="pallas"): the static loop's prefill, the serve engine's
// prefill when prefill_chunk=0, and Model.forward.
//
// Computes, for query row i of (b, h) at absolute position p = i + q_offset
// and kv head kvh = h * K / H (grouped KV is never expanded):
//   o[b, i, h] = softmax_t((q[b, i, h] . k[b, t, kvh]) / sqrt(D)) . v[b, t, kvh]
// over the keys t < Skv that the masks leave: t <= p when causal, and
// t > p - window when window > 0. q_offset may be negative and Sq may
// exceed Skv. A row with no such key returns the mean of v over all Skv
// keys of its kv head, as the JAX package's oracle `flash_attention_ref`
// does (its masked scores are a finite -1e30, so the softmax of such a row
// is uniform). The JAX Pallas kernel departs from that when Skv is not a
// multiple of its block_k: it also masks the padded positions with -1e30
// and so divides by the padded length. q, k, v and o stay in the model
// layout [B, S, heads, D]: the tensor maps read the rows through the
// layout's strides, so the call needs no transposes.
//
// Numerics. QK^T takes the bf16 q and k as they are (the products are exact
// and summed in f32); 1/sqrt(D) is applied to the f32 scores, folded with
// log2(e) into exp2f. The TPU kernel scales q in f32 before the product, so
// the two differ by f32 roundings only. m, l and the output accumulator are
// f32 in registers. P is rounded to bf16 for the P.V product, the one
// rounding the TPU kernel (which keeps P in f32) does not make; l sums the
// rounded P, so each row's weights still sum to one. The output is
// acc / max(l, 1e-30), rounded once to bf16.
//
// Bound on this card. A causal query row costs 4 * D flops per visible key
// against ~4 * D bytes of its q and o rows (k and v are shared by the G
// query heads of a kv head). At 128 tokens (the static and engine prefill)
// the bytes bound it; at 4096 the operations, by far (344 GFLOP for 2 x
// 4096 tokens of qwen2.5-14b's 40 heads against 0.35 ms at 989 TFLOP/s).
// So the products run on the tensor cores, and the loads overlap them.
//
// Design (one block per (q tile, q head, batch row); the heaviest causal
// tiles start first):
// - Warps. Two consumer warpgroups of 64 query rows each (a q tile of 128
//   rows), one at D = 256 so that the output accumulator fits in
//   registers, then one producer warp.
// - Loads. The producer loads the q tile once by TMA, then streams K and V
//   tiles of kBK rows through a 2-stage ring in shared memory, with a full
//   and an empty mbarrier per stage. Each tile is cut into 64-column (128
//   byte) boxes stored with the 128-byte swizzle that wgmma reads. The
//   tensor maps describe the [B, S, heads, D] tensors as 4-d arrays, so a
//   box never crosses into the next batch row: TMA fills rows >= S with
//   zeros. The masks still send t >= Skv to -inf (a zero key scores 0).
// - Scores. S = Q K^T by wgmma m64n{kBK}k16 with both operands read from
//   shared memory (K-major descriptors), f32 accumulators in registers.
// - Softmax. Online, on the accumulator fragment: each thread holds two
//   rows (row = 16 * warp + lane / 4 + 8 * r), whose max and sum reduce
//   over the four lanes of a quad by shuffles. Masks apply only to tiles
//   that cross the causal diagonal, the window's edge or Skv; a tile that
//   is wholly masked for a warpgroup's rows is skipped, and tiles wholly
//   masked for the whole block are never loaded.
// - P.V. O += P V by wgmma with P as the A operand in registers: the score
//   fragment's layout is the A fragment's, so P is converted in place to
//   bf16 pairs and never goes through shared memory. V is the B operand
//   read from shared memory with the transposed (MN-major) layout bit.
// - Epilogue. Divide by l, round to bf16, store each thread's column pairs.
// - Rows with no visible key (l == 0) sum v over all Skv rows from device
//   memory in a separate pass at the end; the model's prefill never has
//   one.
// Shared memory at D = 128: q 32 KB, each stage K + V 64 KB, 160 KB in all.
// Later work: ping-pong between the two warpgroups (one's softmax under the
// other's products), the G query heads of a kv head in one block, a
// persistent scheduler, fp8.

#include <cuda.h>
#include <math_constants.h>

#include "common.cuh"
#include "wgmma.cuh"

namespace {

constexpr int kStages = 2;
constexpr int kPanelCols = 64;     // bf16 columns of a 128-byte swizzled box
constexpr int kRowBytes = 128;     // one row of a box
constexpr float kLog2e = 1.4426950408889634f;

template <int D> struct Tiling;
template <> struct Tiling<64> { static constexpr int kWarpgroups = 2, kBK = 128; };
template <> struct Tiling<128> { static constexpr int kWarpgroups = 2, kBK = 128; };
template <> struct Tiling<256> { static constexpr int kWarpgroups = 1, kBK = 64; };

// Shared memory layout, in bytes from a 1024-byte aligned base: the q tile,
// then per stage a K tile and a V tile, then the barriers. A tile is D / 64
// panels of rows x 128 bytes.
template <int D>
struct Layout {
  static constexpr int kWarpgroups = Tiling<D>::kWarpgroups;
  static constexpr int kBQ = 64 * kWarpgroups;
  static constexpr int kBK = Tiling<D>::kBK;
  static constexpr int kThreads = 128 * kWarpgroups + 32;
  static constexpr int kPanels = D / kPanelCols;
  static constexpr int kQPanel = kBQ * kRowBytes;
  static constexpr int kKPanel = kBK * kRowBytes;
  static constexpr int kQ = kQPanel * kPanels;
  static constexpr int kTile = kKPanel * kPanels;
  static constexpr int kStage = 2 * kTile;
  static constexpr int kBarriers = kQ + kStages * kStage;
  // q_full, full[kStages], empty[kStages]; 1024 bytes of slack to align
  static constexpr int kBytes = kBarriers + 8 * (1 + 2 * kStages) + 1024;
  // the output accumulator as column halves of at most 128 (one wgmma each)
  static constexpr int kON = D < 128 ? D : 128;
  static constexpr int kOHalves = D / kON;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers --------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// wait until the phase of the given parity has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// ---- TMA --------------------------------------------------------------------

// one box of a 4-d tensor map at coordinates (c0 innermost .. c3) into
// shared memory, completing `bar`'s transaction count
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

using repro::fence_regs;
using repro::smem_desc;
using repro::wgmma_commit;
using repro::wgmma_fence;
using repro::wgmma_rs;
using repro::wgmma_ss;
using repro::wgmma_wait_all;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi, float& lo_r, float& hi_r) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  lo_r = __low2float(p);
  hi_r = __high2float(p);
  return *reinterpret_cast<const uint32_t*>(&p);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

template <int D>
__global__ void __launch_bounds__(Layout<D>::kThreads, 1)
    fa_wgmma_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv, const __nv_bfloat16* __restrict__ v,
                    __nv_bfloat16* __restrict__ out, int Sq, int Skv, int H, int K, bool causal,
                    int window, int q_offset, float scale_log2) {
  using L = Layout<D>;
  constexpr int kBQ = L::kBQ, kBK = L::kBK, kON = L::kON, kOHalves = L::kOHalves;
  constexpr int kSteps = kBK / 16;        // k16 steps of P.V
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t bar_q = base + L::kBarriers;
  const uint32_t bar_full = bar_q + 8;
  const uint32_t bar_empty = bar_full + 8 * kStages;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h * K / H;
  const int nq = min(kBQ, Sq - q0);

  // the keys some row of this tile can see: [lo, hi); whole tiles from t_begin
  int hi = Skv;
  if (causal) hi = static_cast<int>(min(static_cast<long long>(hi),
                                        static_cast<long long>(q0) + nq + q_offset));
  int lo = 0;
  if (window > 0)
    lo = static_cast<int>(max(0LL, static_cast<long long>(q0) + q_offset - window + 1));
  const int t_begin = (lo / kBK) * kBK;
  const int n_tiles = hi > t_begin ? (hi - t_begin + kBK - 1) / kBK : 0;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, L::kWarpgroups);   // one arrival per consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (warp == 4 * L::kWarpgroups) {
    // producer: the q tile once, then K and V tiles through the ring
    if (lane == 0) {
      mbar_expect_tx(bar_q, L::kQ);
      for (int p = 0; p < L::kPanels; ++p)
        tma_load(base + p * L::kQPanel, &tq, bar_q, p * kPanelCols, h, q0, b);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % kStages;
        mbar_wait(bar_empty + 8 * s, ((i / kStages) & 1) ^ 1);
        mbar_expect_tx(bar_full + 8 * s, L::kStage);
        const int t0 = t_begin + i * kBK;
        const uint32_t kdst = base + L::kQ + s * L::kStage;
        for (int p = 0; p < L::kPanels; ++p) {
          tma_load(kdst + p * L::kKPanel, &tk, bar_full + 8 * s, p * kPanelCols, kvh, t0, b);
          tma_load(kdst + L::kTile + p * L::kKPanel, &tv, bar_full + 8 * s, p * kPanelCols,
                   kvh, t0, b);
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg owns query rows [64 wg, 64 wg + 64) of the tile
  const int wg = warp / 4;
  const int w = warp % 4;
  const int quad = lane / 4;          // row within the warp's 8-row half
  const int qc = 2 * (lane % 4);      // first of the thread's column pair
  const int pos0 = q0 + 64 * wg + q_offset;       // position of the warpgroup's first row
  const int prow = pos0 + 16 * w + quad;          // position of the thread's row r = 0

  float o[kOHalves][kON / 2];
#pragma unroll
  for (int hh = 0; hh < kOHalves; ++hh)
#pragma unroll
    for (int i = 0; i < kON / 2; ++i) o[hh][i] = 0.f;
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F};
  float l[2] = {0.f, 0.f};

  mbar_wait(bar_q, 0);
  const uint32_t qa = base + wg * 64 * kRowBytes;

  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % kStages;
    mbar_wait(bar_full + 8 * s, (i / kStages) & 1);
    const int t0 = t_begin + i * kBK;
    const uint32_t ka = base + L::kQ + s * L::kStage;
    const uint32_t va = ka + L::kTile;
    const bool skip = (causal && t0 > pos0 + 63) ||
                      (window > 0 && t0 + kBK - 1 <= pos0 - window);
    if (!skip) {
      // S = Q K^T over D in k16 steps: 4 per 128-byte panel, 32 bytes apart
      float sc[kBK / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk % 4) * 32;
        wgmma_ss(sc, smem_desc(qa + (kk / 4) * L::kQPanel + off, 16, 1024),
                 smem_desc(ka + (kk / 4) * L::kKPanel + off, 16, 1024), kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sc);

      // sc[4j + 2r + c] is row prow + 8r, key t0 + 8j + qc + c
      const bool need_mask = (causal && t0 + kBK - 1 > pos0) ||
                             (window > 0 && t0 <= pos0 + 63 - window) || t0 + kBK > Skv;
      if (need_mask) {
#pragma unroll
        for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
          for (int r = 0; r < 2; ++r)
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              const int t = t0 + 8 * j + qc + c;
              const int p = prow + 8 * r;
              const bool ok = t < Skv && (!causal || t <= p) && (window == 0 || p - t < window);
              if (!ok) sc[4 * j + 2 * r + c] = -CUDART_INF_F;
            }
      }

      float corr[2], msc[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = -CUDART_INF_F;
#pragma unroll
        for (int j = 0; j < kBK / 8; ++j)
          mx = fmaxf(mx, fmaxf(sc[4 * j + 2 * r], sc[4 * j + 2 * r + 1]));
        const float m_new = fmaxf(m[r], quad_max(mx));
        // a row that has seen no key yet keeps m = -inf: subtract 0 instead
        const float m_use = m_new == -CUDART_INF_F ? 0.f : m_new;
        msc[r] = m_use * scale_log2;
        corr[r] = exp2f(m[r] * scale_log2 - msc[r]);
        m[r] = m_new;
      }
      // P in place as bf16 pairs, laid out as the A fragments of P.V
      uint32_t pa[kSteps][4];
      float rs[2] = {0.f, 0.f};
#pragma unroll
      for (int st = 0; st < kSteps; ++st)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int idx = 8 * st + 2 * e;            // e: (j = 2 st + e / 2, r = e % 2)
          const int r = e % 2;
          const float p0 = exp2f(fmaf(sc[idx], scale_log2, -msc[r]));
          const float p1 = exp2f(fmaf(sc[idx + 1], scale_log2, -msc[r]));
          float r0, r1;
          pa[st][e] = pack_bf16(p0, p1, r0, r1);
          rs[r] += r0 + r1;
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + quad_sum(rs[r]);
#pragma unroll
      for (int hh = 0; hh < kOHalves; ++hh)
#pragma unroll
        for (int idx = 0; idx < kON / 2; ++idx) o[hh][idx] *= corr[(idx / 2) % 2];

      // O += P V: k16 steps over the tile's keys, 2048 bytes (16 rows) apart
      wgmma_fence();
#pragma unroll
      for (int st = 0; st < kSteps; ++st)
#pragma unroll
        for (int hh = 0; hh < kOHalves; ++hh)
          wgmma_rs(o[hh], pa[st],
                   smem_desc(va + hh * (kON / kPanelCols) * L::kKPanel + st * 16 * kRowBytes,
                             L::kKPanel, 1024));
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int hh = 0; hh < kOHalves; ++hh) fence_regs(o[hh]);
      fence_regs(pa);
    }
    // this warpgroup is done with the stage
    if (threadIdx.x % 128 == 0) mbar_arrive(bar_empty + 8 * s);
  }

  // rows with no visible key (l stays 0: a visible key's exp2(0) adds 1)
  // take the mean of v over every key of the kv head
  const bool none0 = l[0] == 0.f;
  const bool none1 = l[1] == 0.f;
  if (none0 || none1) {
    const __nv_bfloat16* vb = v + (static_cast<size_t>(b) * Skv * K + kvh) * D + qc;
    for (int t = 0; t < Skv; ++t) {
      const __nv_bfloat16* vr = vb + static_cast<size_t>(t) * K * D;
#pragma unroll
      for (int hh = 0; hh < kOHalves; ++hh)
#pragma unroll
        for (int j = 0; j < kON / 8; ++j) {
          const float2 x =
              __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(vr + hh * kON + 8 * j));
          if (none0) {
            o[hh][4 * j] += x.x;
            o[hh][4 * j + 1] += x.y;
          }
          if (none1) {
            o[hh][4 * j + 2] += x.x;
            o[hh][4 * j + 3] += x.y;
          }
        }
    }
    if (none0) l[0] = static_cast<float>(Skv);
    if (none1) l[1] = static_cast<float>(Skv);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + 64 * wg + 16 * w + quad + 8 * r;
    if (row >= Sq) continue;
    const float denom = fmaxf(l[r], 1e-30f);
    __nv_bfloat16* orow = out + ((static_cast<size_t>(b) * Sq + row) * H + h) * D + qc;
#pragma unroll
    for (int hh = 0; hh < kOHalves; ++hh)
#pragma unroll
      for (int j = 0; j < kON / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(orow + hh * kON + 8 * j) = __floats2bfloat162_rn(
            o[hh][4 * j + 2 * r] / denom, o[hh][4 * j + 2 * r + 1] / denom);
  }
}

// ---- host side --------------------------------------------------------------

// cuTensorMapEncodeTiled, reached through the runtime so nothing links -lcuda
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) ==
            cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// [B, S, heads, D] bf16 as a 4-d tensor map (D innermost), boxes of 64
// columns x `rows` rows of one head and batch row, 128-byte swizzled
bool encode(CUtensorMap* map, const void* ptr, int B, int S, int heads, int D, int rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(S), static_cast<cuuint64_t>(B)};
  const cuuint64_t row = static_cast<cuuint64_t>(D) * sizeof(__nv_bfloat16);
  const cuuint64_t strides[3] = {row, row * heads, row * heads * S};
  const cuuint32_t box[4] = {kPanelCols, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides,
            box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out, int B, int Sq, int Skv,
           int H, int K, bool causal, int window, int q_offset, float sm_scale,
           cudaStream_t stream) {
  using L = Layout<D>;
  CUtensorMap tq, tk, tv;
  if (!encode(&tq, q, B, Sq, H, D, L::kBQ) || !encode(&tk, k, B, Skv, K, D, L::kBK) ||
      !encode(&tv, v, B, Skv, K, D, L::kBK))
    return static_cast<int>(cudaErrorInvalidValue);
  // above 48 KB a kernel must opt in to its dynamic shared memory
  static bool opted_in = false;
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        fa_wgmma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in = true;
  }
  const dim3 grid((Sq + L::kBQ - 1) / L::kBQ, H, B);
  fa_wgmma_kernel<D><<<grid, L::kThreads, L::kBytes, stream>>>(
      tq, tk, tv, static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out), Sq,
      Skv, H, K, causal, window, q_offset, sm_scale * kLog2e);
  return 0;
}

}  // namespace

int repro::flash_attention_wgmma(const void* q, const void* k, const void* v, void* out, int B,
                                 int Sq, int Skv, int H, int K, int D, bool causal, int window,
                                 int q_offset, float sm_scale, void* stream) {
  // the wrapper checks these too; a bad call must never reach the launch
  if (B <= 0 || Sq <= 0 || Skv <= 0 || K <= 0 || H % K != 0 || H > 65535 || B > 65535 ||
      window < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  // TMA reads from 16-byte aligned addresses; rows are stored as bf16 pairs
  const auto misaligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 != 0; };
  if (misaligned(q) || misaligned(k) || misaligned(v) || misaligned(out))
    return static_cast<int>(cudaErrorMisalignedAddress);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int err;
  switch (D) {
    case 64:
      err = launch<64>(q, k, v, out, B, Sq, Skv, H, K, causal, window, q_offset, sm_scale, st);
      break;
    case 128:
      err = launch<128>(q, k, v, out, B, Sq, Skv, H, K, causal, window, q_offset, sm_scale, st);
      break;
    case 256:
      err = launch<256>(q, k, v, out, B, Sq, Skv, H, K, causal, window, q_offset, sm_scale, st);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != 0) return err;
  return static_cast<int>(cudaGetLastError());
}
