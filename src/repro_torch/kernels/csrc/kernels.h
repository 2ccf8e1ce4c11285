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

// Paged flash-decode (flash_decode_paged.cu). q/out [B,H,D]; k/v arenas
// [pages,ps,K,D] of q's dtype, or int8 codes with f32 scales [pages,ps,K];
// kv_len [B]; table [B,max_pages] arena row ids.
int flash_decode_paged(const void* q, DType q_dtype, const void* k, const void* v,
                       DType kv_dtype, const float* k_scale, const float* v_scale,
                       const int32_t* kv_len, const int32_t* table, void* out, int B, int H,
                       int K, int D, int ps, int max_pages, float sm_scale, void* stream);

// Symmetric per-row int8 quantizer (quantize.cu). x [rows,cols] f32 or
// bf16 -> q int8 [rows,cols], scale f32 [rows].
int quantize_rows(const void* x, DType x_dtype, int8_t* q, float* scale, int rows, int cols,
                  void* stream);

}  // namespace repro
