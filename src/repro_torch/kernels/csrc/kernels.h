// C++ interface of the port's CUDA kernels: the launchers the .cu sources
// define and binding.cpp calls. Plain types only, so the kernel sources
// compile without PyTorch's headers; both sides include this header, so a
// launcher whose definition drifts from its declaration fails to link.
#pragma once

#include <cstdint>

namespace repro {

// element types of the tensors a launcher takes
enum DType : int { kF32 = 0, kBF16 = 1, kI8 = 2 };

// Each launcher enqueues its kernel on `stream` (a cudaStream_t) and returns
// the cudaError_t of the launch: 0 on success.

// Flash attention forward (flash_attention_fwd.cu). q/out [B,Sq,H,D], k/v
// [B,Skv,K,D], all of `dtype` (f32 or bf16), contiguous and 16-byte
// aligned; query row i sits at kv position i + q_offset; window 0 = none.
int flash_attention(const void* q, const void* k, const void* v, void* out, DType dtype, int B,
                    int Sq, int Skv, int H, int K, int D, bool causal, int window, int q_offset,
                    float sm_scale, void* stream);
// Its tensor-core route (flash_attention_wgmma.cu): the same contract for
// bf16 tensors with D 64, 128 or 256.
int flash_attention_wgmma(const void* q, const void* k, const void* v, void* out, int B, int Sq,
                          int Skv, int H, int K, int D, bool causal, int window, int q_offset,
                          float sm_scale, void* stream);

// Flash-decode (flash_decode.cu), the CUDA-core route: q/out [B,H,D]
// (f32 or bf16, H / K <= 8, D a multiple of 32); caches of q's dtype, or
// int8 codes with f32 per-row scales; kv_len [B].
// Paged: k/v arenas [pages,ps,K,D], scales [pages,ps,K], table
// [B,max_pages] arena row ids.
int flash_decode_paged(const void* q, DType q_dtype, const void* k, const void* v,
                       DType kv_dtype, const float* k_scale, const float* v_scale,
                       const int32_t* kv_len, const int32_t* table, void* out, int B, int H,
                       int K, int D, int ps, int max_pages, float sm_scale, void* stream);
// Slot-contiguous: k/v caches [B,Smax,K,D], scales [B,Smax,K].
int flash_decode(const void* q, DType q_dtype, const void* k, const void* v, DType kv_dtype,
                 const float* k_scale, const float* v_scale, const int32_t* kv_len, void* out,
                 int B, int H, int K, int D, int smax, float sm_scale, void* stream);
// Its tensor-core route: bf16 q/out, caches of bf16 or int8 codes with f32
// scales, D 64, 128 or 256, H / K <= 16; all 16-byte aligned. Split s of
// `splits` covers positions [s * chunk, (s + 1) * chunk), and splits * chunk
// must cover the capacity. With splits > 1, part_ml [B,K,splits,2,G] and
// part_acc [B,K,splits,G,D] (f32) take the partials and a second kernel
// combines them into out; with one split both are null.
int flash_decode_paged_mma(const void* q, const void* k, const void* v, DType kv_dtype,
                           const float* k_scale, const float* v_scale, const int32_t* kv_len,
                           const int32_t* table, void* out, float* part_ml, float* part_acc,
                           int B, int H, int K, int D, int ps, int max_pages, int splits,
                           int chunk, float sm_scale, void* stream);
int flash_decode_mma(const void* q, const void* k, const void* v, DType kv_dtype,
                     const float* k_scale, const float* v_scale, const int32_t* kv_len,
                     void* out, float* part_ml, float* part_acc, int B, int H, int K, int D,
                     int smax, int splits, int chunk, float sm_scale, void* stream);

// Symmetric per-row int8 quantizer (quantize.cu). x [rows,cols] f32 or
// bf16, contiguous -> q int8 [rows,cols], scale f32 [rows]. vectors V > 0
// takes the row-in-registers path, a row held by `lanes` lanes (a power of
// two <= 32) in at most V (1, 2, 4 or 8) 16-byte vectors a lane, which
// needs cols a whole number of vectors and 16-byte aligned x and q; V = 0
// the element path, which takes any row.
int quantize_rows(const void* x, DType x_dtype, int8_t* q, float* scale, int rows, int cols,
                  int lanes, int vectors, void* stream);
// The decode step's int8 cache write (quantize.cu): the rows of k and v
// [B,1,K,D] (f32 or bf16; strides in elements {batch, head}, the last
// dimension contiguous) quantized as quantize_rows does, and each active
// slot b's codes and scales written into k_codes/v_codes [pages,ps,K,D]
// and k_scale/v_scale [pages,ps,K] (contiguous) at (table[b, pos / ps],
// pos % ps), pos = positions[b]; with a null table (pages = B, ps = Smax)
// at (b, min(pos, ps - 1)). Inactive slots write nothing; a negative
// position, or a page or table entry outside the cache, traps. lanes and
// vectors as for quantize_rows (at width D), which the vector path needs
// of every row and cache pointer.
int quantize_kv_write(const void* k, const void* v, DType dtype, const int64_t* k_strides,
                      const int64_t* v_strides, int8_t* k_codes, int8_t* v_codes, float* k_scale,
                      float* v_scale, const int32_t* table, const int32_t* positions,
                      const bool* active, int B, int K, int D, int ps, int max_pages, int pages,
                      int lanes, int vectors, void* stream);
// Its inverse (quantize.cu): q int8 [rows,cols], scale f32 [rows] -> out
// [rows,cols] of out_dtype (f32 or bf16) = q * scale[row], contiguous.
// `vector`: one warp a row, 4 codes a lane a store, which needs cols a
// multiple of 4 and 16-byte aligned q and out; else an element a thread.
int dequantize_rows(const int8_t* q, const float* scale, void* out, DType out_dtype, int rows,
                    int cols, bool vector, void* stream);
// The pod sum (quantize.cu): q int8 [pods,rows,cols], scale f32 [pods,rows]
// -> out f32 [n] (n <= rows * cols), out[i] = the sum over pods p in order,
// from +0, of q[p].flat[i] * scale[p, i / cols], each product and each add
// rounded once. `vector` as for dequantize_rows.
int dequantize_sum_rows(const int8_t* q, const float* scale, float* out, int pods, int rows,
                        int cols, int64_t n, bool vector, void* stream);

// RMSNorm forward (rmsnorm.cu). x/out [rows,d] f32 or bf16, scale [d] f32,
// contiguous: out = (x * rsqrt(mean(x^2) + eps)) * scale in x's dtype.
// warps_per_row W > 0 takes the row-in-registers path, a row held by W
// warps (1, 2, 4 or 8) in at most 20 16-byte vectors a lane, which needs d a
// whole number of vectors and 16-byte aligned pointers; W = 0 the element
// path, which takes any row.
int rmsnorm(const void* x, DType dtype, const float* scale, void* out, int rows, int d,
            int warps_per_row, float eps, void* stream);

// Mamba-2 SSD chunked scan (ssd_scan.cu). x [batch,L,H,P] f32 or bf16,
// dt [batch,L,H] f32, A [H] f32, B/C [batch,L,G,N] of x's type -> y
// [batch,L,H,P] of x's type, contiguous, and, where h_final is not null,
// the state after the last row into h_final [batch,H,P,N] (f32,
// contiguous). x, dt, B and C are read through their strides in elements
// (batch, token, head or group; the last dimension is contiguous); A
// contiguous. P <= 64, N <= 128, H % G == 0.
int ssd_scan(const void* x, const float* dt, const float* A, const void* B, const void* C,
             void* y, float* h_final, DType dtype, int batch, int L, int H, int G, int P,
             int N, int chunk, const int64_t* x_strides, const int64_t* dt_strides,
             const int64_t* b_strides, const int64_t* c_strides, void* stream);
// Its tensor-core route (ssd_scan_mma.cu): the same contract for bf16 x, B
// and C with P and N multiples of 16, P <= 64, N <= 128, min(chunk, L) <=
// 2048, and x, B, C and y 16-byte aligned with strides in multiples of 8
// elements, h_final (where not null) 16-byte aligned. With nc = ceil(L /
// min(chunk, L)) chunks, states [batch,nws,H,P,N] and decays [batch,nws,H]
// (f32, contiguous) are its workspace, nws = nc with h_final and nc - 1
// without; with nws = 0 both may be null.
int ssd_scan_mma(const void* x, const float* dt, const float* A, const void* B, const void* C,
                 void* y, float* states, float* decays, float* h_final, int batch, int L,
                 int H, int G, int P, int N, int chunk, const int64_t* x_strides,
                 const int64_t* dt_strides, const int64_t* b_strides, const int64_t* c_strides,
                 void* stream);

}  // namespace repro
