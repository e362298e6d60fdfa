// What the library's registered operators (torch_ops.cpp, ops_conv.cpp,
// ops_packed.cpp) share: the dtype codes of tensors, the narrowing of
// schema ints, the checks of their tensor arguments, the alignment copy and
// the launch check. Host code only: the .cu files never include it.
#pragma once

#include <ATen/core/Tensor.h>
#include <c10/core/ScalarType.h>
#include <c10/util/Exception.h>
#include <cuda_runtime_api.h>

#include <cstdint>
#include <limits>
#include <optional>
#include <vector>

#include "dtypes.h"

namespace df_ops {

// The DT_* code of a scalar type, 0 for a type no kernel takes.
inline int dt_code(at::ScalarType t) {
  switch (t) {
    case at::kFloat: return DT_F32;
    case at::kInt: return DT_S32;
    case at::kChar: return DT_S8;
    case at::kByte: return DT_U8;
    default: return 0;
  }
}

// The scalar type of a DT_* code.
inline at::ScalarType scalar_type(int dt, const char* op) {
  switch (dt) {
    case DT_F32: return at::kFloat;
    case DT_S32: return at::kInt;
    case DT_S8: return at::kChar;
    case DT_U8: return at::kByte;
    default: break;
  }
  TORCH_CHECK(false, op, ": no dtype has the code ", dt);
  return at::ScalarType::Undefined;
}

// A schema int (int64_t) as the launcher's int, refused outside its range.
inline int narrow(int64_t v, const char* op, const char* what) {
  TORCH_CHECK(v >= std::numeric_limits<int>::min() &&
                  v <= std::numeric_limits<int>::max(),
              op, ": ", what, " = ", v, " does not fit a 32-bit int");
  return static_cast<int>(v);
}

// A schema int[] of exactly `len` values, each narrowed.
inline std::vector<int> narrow(at::IntArrayRef v, size_t len, const char* op,
                               const char* what) {
  TORCH_CHECK(v.size() == len, op, ": ", what, " takes ", len,
              " ints, got ", v.size());
  std::vector<int> out(len);
  for (size_t i = 0; i < len; ++i) out[i] = narrow(v[i], op, what);
  return out;
}

// Contiguous and 16-byte aligned, as the kernels' vector loads and TMA
// need: the tensor itself where it already is, else a copy.
inline at::Tensor aligned(const at::Tensor& t) {
  at::Tensor c = t.contiguous();
  if (reinterpret_cast<uintptr_t>(c.data_ptr()) % 16 != 0)
    c = c.clone(at::MemoryFormat::Contiguous);
  return c;
}

// t is a CUDA tensor on `dev` of scalar type `st` with `dim` dimensions.
inline void check_tensor(const at::Tensor& t, const c10::Device& dev,
                         at::ScalarType st, int64_t dim, const char* op,
                         const char* what) {
  TORCH_CHECK(t.is_cuda() && t.device() == dev, op, ": ", what,
              " must be on ", dev, ", it is on ", t.device());
  TORCH_CHECK(t.scalar_type() == st, op, ": ", what, " must be ", st,
              ", it is ", t.scalar_type());
  TORCH_CHECK(t.dim() == dim, op, ": ", what, " must have ", dim,
              " dimensions, it has shape ", t.sizes());
}

// A per-channel operand (bias, scale, correction): a contiguous vector on
// `dev` of scalar type `st` with at least `lanes` values.
inline const void* lanes_of(const at::Tensor& t, const c10::Device& dev,
                            at::ScalarType st, int64_t lanes, const char* op,
                            const char* what) {
  check_tensor(t, dev, st, 1, op, what);
  TORCH_CHECK(t.is_contiguous() && t.numel() >= lanes, op, ": ", what,
              " must be a contiguous vector of at least ", lanes,
              " values, it has shape ", t.sizes());
  return t.data_ptr();
}

// The same for an operand that only a fused op has: null when not fused,
// required when fused.
inline const void* lanes_of(const std::optional<at::Tensor>& t, bool fused,
                            const c10::Device& dev, at::ScalarType st,
                            int64_t lanes, const char* op,
                            const char* what) {
  if (!fused) return nullptr;
  TORCH_CHECK(t.has_value(), op, ": a fused op needs ", what);
  return lanes_of(*t, dev, st, lanes, op, what);
}

// A K-major weight matrix: a contiguous 2-D s8 CUDA tensor on `dev`.
inline void check_kmajor(const at::Tensor& w, const c10::Device& dev,
                         const char* op, const char* what) {
  check_tensor(w, dev, at::kChar, 2, op, what);
  TORCH_CHECK(w.is_contiguous(), op, ": ", what, " must be contiguous");
}

// The host buffer of an op's encoded weight maps: a contiguous CPU uint8
// tensor of `bytes` bytes, which the launcher copies byte for byte into
// its aligned CUtensorMaps.
inline const void* host_maps(const at::Tensor& wmaps, int64_t bytes,
                             const char* op) {
  TORCH_CHECK(wmaps.device().is_cpu() && wmaps.scalar_type() == at::kByte &&
                  wmaps.is_contiguous() && wmaps.numel() == bytes,
              op, ": the weight maps must be a contiguous CPU uint8 tensor "
              "of ", bytes, " bytes, got ", wmaps.scalar_type(), " ",
              wmaps.sizes(), " on ", wmaps.device());
  return wmaps.data_ptr();
}

// Raise if a launcher reported an error, naming the kernel.
inline void check_launch(cudaError_t rc, const char* kernel) {
  TORCH_CHECK(rc == cudaSuccess, kernel, ": CUDA error ",
              static_cast<int>(rc), " (", cudaGetErrorString(rc), ")");
}

}  // namespace df_ops
