// Python binding of the port's CUDA kernels: the one source that includes
// PyTorch's headers. Each function takes the tensors its Python wrapper
// checked and allocated, reads the sizes off their shapes and the element
// types off their dtypes, launches on the current stream of the tensors'
// card, and raises if the launch failed.
#include <ATen/cuda/CUDAContext.h>
#include <c10/cuda/CUDAGuard.h>
#include <cuda_runtime.h>
#include <torch/extension.h>

#include "kernels.h"

namespace {

repro::DType dtype_of(const torch::Tensor& t) {
  switch (t.scalar_type()) {
    case torch::kFloat32: return repro::kF32;
    case torch::kBFloat16: return repro::kBF16;
    case torch::kInt8: return repro::kI8;
    default: TORCH_CHECK(false, "no kernel takes dtype ", t.scalar_type());
  }
}

void check_launch(int err, const char* what) {
  TORCH_CHECK(err == 0, what, ": CUDA launch failed: ",
              cudaGetErrorString(static_cast<cudaError_t>(err)));
}

void* current_stream() { return at::cuda::getCurrentCUDAStream().stream(); }

void flash_attention(const torch::Tensor& q, const torch::Tensor& k, const torch::Tensor& v,
                     torch::Tensor out, bool causal, int64_t window, int64_t q_offset,
                     double sm_scale) {
  const c10::cuda::CUDAGuard guard(q.device());
  const int err = repro::flash_attention(
      q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dtype_of(q), q.size(0),
      q.size(1), k.size(1), q.size(2), k.size(2), q.size(3), causal, static_cast<int>(window),
      static_cast<int>(q_offset), static_cast<float>(sm_scale), current_stream());
  check_launch(err, "flash_attention");
}

void flash_attention_wgmma(const torch::Tensor& q, const torch::Tensor& k,
                           const torch::Tensor& v, torch::Tensor out, bool causal,
                           int64_t window, int64_t q_offset, double sm_scale) {
  const c10::cuda::CUDAGuard guard(q.device());
  TORCH_CHECK(q.scalar_type() == torch::kBFloat16, "flash_attention_wgmma takes bf16");
  const int err = repro::flash_attention_wgmma(
      q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), q.size(0), q.size(1),
      k.size(1), q.size(2), k.size(2), q.size(3), causal, static_cast<int>(window),
      static_cast<int>(q_offset), static_cast<float>(sm_scale), current_stream());
  check_launch(err, "flash_attention_wgmma");
}

// an optional f32 tensor's data, or null
float* f32_ptr(const std::optional<torch::Tensor>& t) {
  return t.has_value() ? t->data_ptr<float>() : nullptr;
}

void flash_decode_paged(const torch::Tensor& q, const torch::Tensor& k, const torch::Tensor& v,
                        const std::optional<torch::Tensor>& k_scale,
                        const std::optional<torch::Tensor>& v_scale,
                        const torch::Tensor& kv_len, const torch::Tensor& table,
                        torch::Tensor out, double sm_scale) {
  const c10::cuda::CUDAGuard guard(q.device());
  const int err = repro::flash_decode_paged(
      q.data_ptr(), dtype_of(q), k.data_ptr(), v.data_ptr(), dtype_of(k), f32_ptr(k_scale),
      f32_ptr(v_scale), kv_len.data_ptr<int32_t>(), table.data_ptr<int32_t>(), out.data_ptr(),
      q.size(0), q.size(1), k.size(2), q.size(2), k.size(1), table.size(1),
      static_cast<float>(sm_scale), current_stream());
  check_launch(err, "flash_decode_paged");
}

void flash_decode(const torch::Tensor& q, const torch::Tensor& k, const torch::Tensor& v,
                  const std::optional<torch::Tensor>& k_scale,
                  const std::optional<torch::Tensor>& v_scale, const torch::Tensor& kv_len,
                  torch::Tensor out, double sm_scale) {
  const c10::cuda::CUDAGuard guard(q.device());
  const int err = repro::flash_decode(
      q.data_ptr(), dtype_of(q), k.data_ptr(), v.data_ptr(), dtype_of(k), f32_ptr(k_scale),
      f32_ptr(v_scale), kv_len.data_ptr<int32_t>(), out.data_ptr(), q.size(0), q.size(1),
      k.size(2), q.size(2), k.size(1), static_cast<float>(sm_scale), current_stream());
  check_launch(err, "flash_decode");
}

// the splits of the tensor-core decode: part_acc [B,K,splits,G,D], or one
int splits_of(const std::optional<torch::Tensor>& part_acc) {
  return part_acc.has_value() ? static_cast<int>(part_acc->size(2)) : 1;
}

void flash_decode_paged_mma(const torch::Tensor& q, const torch::Tensor& k,
                            const torch::Tensor& v, const std::optional<torch::Tensor>& k_scale,
                            const std::optional<torch::Tensor>& v_scale,
                            const torch::Tensor& kv_len, const torch::Tensor& table,
                            torch::Tensor out, const std::optional<torch::Tensor>& part_ml,
                            const std::optional<torch::Tensor>& part_acc, int64_t chunk,
                            double sm_scale) {
  const c10::cuda::CUDAGuard guard(q.device());
  TORCH_CHECK(q.scalar_type() == torch::kBFloat16, "flash_decode_paged_mma takes bf16 q");
  const int err = repro::flash_decode_paged_mma(
      q.data_ptr(), k.data_ptr(), v.data_ptr(), dtype_of(k), f32_ptr(k_scale),
      f32_ptr(v_scale), kv_len.data_ptr<int32_t>(), table.data_ptr<int32_t>(),
      out.data_ptr(), f32_ptr(part_ml), f32_ptr(part_acc), q.size(0), q.size(1), k.size(2),
      q.size(2), k.size(1), table.size(1), splits_of(part_acc), static_cast<int>(chunk),
      static_cast<float>(sm_scale), current_stream());
  check_launch(err, "flash_decode_paged_mma");
}

void flash_decode_mma(const torch::Tensor& q, const torch::Tensor& k, const torch::Tensor& v,
                      const std::optional<torch::Tensor>& k_scale,
                      const std::optional<torch::Tensor>& v_scale, const torch::Tensor& kv_len,
                      torch::Tensor out, const std::optional<torch::Tensor>& part_ml,
                      const std::optional<torch::Tensor>& part_acc, int64_t chunk,
                      double sm_scale) {
  const c10::cuda::CUDAGuard guard(q.device());
  TORCH_CHECK(q.scalar_type() == torch::kBFloat16, "flash_decode_mma takes bf16 q");
  const int err = repro::flash_decode_mma(
      q.data_ptr(), k.data_ptr(), v.data_ptr(), dtype_of(k), f32_ptr(k_scale),
      f32_ptr(v_scale), kv_len.data_ptr<int32_t>(), out.data_ptr(), f32_ptr(part_ml),
      f32_ptr(part_acc), q.size(0), q.size(1), k.size(2), q.size(2), k.size(1),
      splits_of(part_acc), static_cast<int>(chunk), static_cast<float>(sm_scale),
      current_stream());
  check_launch(err, "flash_decode_mma");
}

void quantize_rows(const torch::Tensor& x, torch::Tensor q, torch::Tensor scale, int64_t lanes,
                   int64_t vectors) {
  const c10::cuda::CUDAGuard guard(x.device());
  const int err = repro::quantize_rows(x.data_ptr(), dtype_of(x), q.data_ptr<int8_t>(),
                                       scale.data_ptr<float>(), x.size(0), x.size(1),
                                       static_cast<int>(lanes), static_cast<int>(vectors),
                                       current_stream());
  check_launch(err, "quantize_rows");
}

void quantize_kv_write(const torch::Tensor& k, const torch::Tensor& v, torch::Tensor k_codes,
                       torch::Tensor v_codes, torch::Tensor k_scale, torch::Tensor v_scale,
                       const std::optional<torch::Tensor>& table,
                       const torch::Tensor& positions, const torch::Tensor& active,
                       int64_t lanes, int64_t vectors) {
  const c10::cuda::CUDAGuard guard(k.device());
  const int64_t ks[2] = {k.stride(0), k.stride(2)};
  const int64_t vs[2] = {v.stride(0), v.stride(2)};
  const int err = repro::quantize_kv_write(
      k.data_ptr(), v.data_ptr(), dtype_of(k), ks, vs, k_codes.data_ptr<int8_t>(),
      v_codes.data_ptr<int8_t>(), k_scale.data_ptr<float>(), v_scale.data_ptr<float>(),
      table.has_value() ? table->data_ptr<int32_t>() : nullptr,
      positions.data_ptr<int32_t>(), active.data_ptr<bool>(), k.size(0), k.size(2), k.size(3),
      k_codes.size(1), table.has_value() ? table->size(1) : 0, k_codes.size(0),
      static_cast<int>(lanes), static_cast<int>(vectors), current_stream());
  check_launch(err, "quantize_kv_write");
}

void dequantize_rows(const torch::Tensor& q, const torch::Tensor& scale, torch::Tensor out,
                     bool vector) {
  const c10::cuda::CUDAGuard guard(q.device());
  const int err = repro::dequantize_rows(q.data_ptr<int8_t>(), scale.data_ptr<float>(),
                                         out.data_ptr(), dtype_of(out), q.size(0), q.size(1),
                                         vector, current_stream());
  check_launch(err, "dequantize_rows");
}

void dequantize_sum_rows(const torch::Tensor& q, const torch::Tensor& scale, torch::Tensor out,
                         bool vector) {
  const c10::cuda::CUDAGuard guard(q.device());
  const int err = repro::dequantize_sum_rows(q.data_ptr<int8_t>(), scale.data_ptr<float>(),
                                             out.data_ptr<float>(), q.size(0), q.size(1),
                                             q.size(2), out.numel(), vector, current_stream());
  check_launch(err, "dequantize_sum_rows");
}

void rmsnorm(const torch::Tensor& x, const torch::Tensor& scale, torch::Tensor out,
             double eps, int64_t warps_per_row) {
  const c10::cuda::CUDAGuard guard(x.device());
  const int err = repro::rmsnorm(x.data_ptr(), dtype_of(x), scale.data_ptr<float>(),
                                 out.data_ptr(), x.size(0), x.size(1),
                                 static_cast<int>(warps_per_row), static_cast<float>(eps),
                                 current_stream());
  check_launch(err, "rmsnorm");
}

// h_final: the final state's output, or an empty tensor for none
float* final_state_ptr(torch::Tensor& h_final) {
  return h_final.numel() ? h_final.data_ptr<float>() : nullptr;
}

void ssd_scan(const torch::Tensor& x, const torch::Tensor& dt, const torch::Tensor& A,
              const torch::Tensor& B, const torch::Tensor& C, torch::Tensor y, int64_t chunk,
              torch::Tensor h_final) {
  const c10::cuda::CUDAGuard guard(x.device());
  const int64_t xs[3] = {x.stride(0), x.stride(1), x.stride(2)};
  const int64_t dts[3] = {dt.stride(0), dt.stride(1), dt.stride(2)};
  const int64_t bs[3] = {B.stride(0), B.stride(1), B.stride(2)};
  const int64_t cs[3] = {C.stride(0), C.stride(1), C.stride(2)};
  const int err = repro::ssd_scan(
      x.data_ptr(), dt.data_ptr<float>(), A.data_ptr<float>(), B.data_ptr(), C.data_ptr(),
      y.data_ptr(), final_state_ptr(h_final), dtype_of(x), x.size(0), x.size(1), x.size(2),
      B.size(2), x.size(3), B.size(3), static_cast<int>(chunk), xs, dts, bs, cs,
      current_stream());
  check_launch(err, "ssd_scan");
}

void ssd_scan_mma(const torch::Tensor& x, const torch::Tensor& dt, const torch::Tensor& A,
                  const torch::Tensor& B, const torch::Tensor& C, torch::Tensor y,
                  torch::Tensor states, torch::Tensor decays, int64_t chunk,
                  torch::Tensor h_final) {
  const c10::cuda::CUDAGuard guard(x.device());
  TORCH_CHECK(x.scalar_type() == torch::kBFloat16, "ssd_scan_mma takes bf16");
  const int64_t xs[3] = {x.stride(0), x.stride(1), x.stride(2)};
  const int64_t dts[3] = {dt.stride(0), dt.stride(1), dt.stride(2)};
  const int64_t bs[3] = {B.stride(0), B.stride(1), B.stride(2)};
  const int64_t cs[3] = {C.stride(0), C.stride(1), C.stride(2)};
  const int err = repro::ssd_scan_mma(
      x.data_ptr(), dt.data_ptr<float>(), A.data_ptr<float>(), B.data_ptr(), C.data_ptr(),
      y.data_ptr(), states.numel() ? states.data_ptr<float>() : nullptr,
      decays.numel() ? decays.data_ptr<float>() : nullptr, final_state_ptr(h_final),
      x.size(0), x.size(1), x.size(2), B.size(2), x.size(3), B.size(3),
      static_cast<int>(chunk), xs, dts, bs, cs, current_stream());
  check_launch(err, "ssd_scan_mma");
}

}  // namespace

PYBIND11_MODULE(TORCH_EXTENSION_NAME, m) {
  m.def("flash_attention", &flash_attention, "flash attention forward into out");
  m.def("flash_attention_wgmma", &flash_attention_wgmma,
        "flash attention forward on the tensor cores (bf16) into out");
  m.def("flash_decode", &flash_decode, "slot-contiguous flash-decode into out");
  m.def("flash_decode_paged", &flash_decode_paged, "paged flash-decode into out");
  m.def("flash_decode_mma", &flash_decode_mma,
        "slot-contiguous flash-decode on the tensor cores (bf16 q) into out");
  m.def("flash_decode_paged_mma", &flash_decode_paged_mma,
        "paged flash-decode on the tensor cores (bf16 q) into out");
  m.def("quantize_rows", &quantize_rows, "per-row int8 quantize into q, scale");
  m.def("quantize_kv_write", &quantize_kv_write,
        "the decode step's k/v rows quantized into the int8 cache, in place");
  m.def("dequantize_rows", &dequantize_rows, "per-row int8 dequantize into out");
  m.def("dequantize_sum_rows", &dequantize_sum_rows,
        "the sum over pods of per-row int8 dequantizes into out (f32)");
  m.def("rmsnorm", &rmsnorm, "RMSNorm forward into out");
  m.def("ssd_scan", &ssd_scan,
        "Mamba-2 SSD chunked scan into y (and the final state into h_final, if not empty)");
  m.def("ssd_scan_mma", &ssd_scan_mma,
        "Mamba-2 SSD chunked scan on the tensor cores (bf16) into y, with its workspace "
        "(and the final state into h_final, if not empty)");
}
