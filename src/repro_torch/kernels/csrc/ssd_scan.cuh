// What the SSD scan's two routes (ssd_scan.cu, ssd_scan_mma.cu) share: the
// chunk's prefix sums of dt * a, computed the same way by both, so every
// kernel of either route sees the same decays.
#pragma once

#include <cuda_runtime.h>

namespace repro {

// cum[i] = sum_{k <= i} dt[k] * a over the Q rows of dt_s, each the f32
// value nearest the f64 sum of the f32 products dt_k * a: each lane sums a
// run of rows, a warp scan in f64 adds the lower lanes' runs. Run by one
// whole warp (lane = its lane). cum[i] depends only on dt[0..i].
__device__ __forceinline__ void ssd_chunk_cum(const float* dt_s, float* cum_s, int Q, float a,
                                              int lane) {
  const int per = (Q + 31) / 32;
  const int i0 = lane * per;
  double run = 0.0;
  for (int u = 0; u < per && i0 + u < Q; ++u) run += static_cast<double>(dt_s[i0 + u] * a);
  double incl = run;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const double v = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += v;
  }
  const double before = __shfl_up_sync(0xffffffffu, incl, 1);
  double acc = lane ? before : 0.0;   // the sum of the lower lanes' runs
  for (int u = 0; u < per && i0 + u < Q; ++u) {
    acc += static_cast<double>(dt_s[i0 + u] * a);
    cum_s[i0 + u] = static_cast<float>(acc);
  }
}

}  // namespace repro
