// The kernel library's PyTorch operators, registered with the dispatcher
// when the library is loaded (torch.ops.load_library, _build.kernels()).
//
//   deepfusion_torch::concat_relu(Tensor[] srcs, bool relu) -> (Tensor, int)
//     launches concat_relu_kernel (concat.cu) through concat_relu_launch
//     (concat.h): NHWC channel concat with an optional true ReLU, of any
//     number of inputs (one launch per group of CONCAT_MAX_IN). Returns the
//     output and the kernel launches the launcher made, which the Python
//     wrapper adds to its launch count.
//
// Host code only, the one source of the library that includes PyTorch's
// headers: the .cu files keep out of them. _build.py compiles it with
// PyTorch's include paths and the ABI torch was built with, and links the
// library against libtorch. The checks, the alignment copy, the device
// guard, the output's allocation, the stream lookup and the launch all run
// here, behind the dispatcher, so a call pays none of them in Python.
//
// Only a CUDA kernel is registered: a CPU tensor raises in the dispatcher.
// The plain version for the CPU is ops/concat.py:concat_plain.
#include <ATen/core/Tensor.h>
#include <ATen/ops/empty.h>
#include <c10/cuda/CUDAGuard.h>
#include <c10/cuda/CUDAStream.h>
#include <torch/library.h>

#include <cstdint>
#include <tuple>
#include <vector>

#include "concat.h"

namespace {

int dt_code(at::ScalarType t) {
  switch (t) {
    case at::kFloat: return DT_F32;
    case at::kInt: return DT_S32;
    case at::kChar: return DT_S8;
    case at::kByte: return DT_U8;
    default: return 0;
  }
}

std::tuple<at::Tensor, int64_t> concat_relu(at::TensorList srcs,
                                             bool relu) {
  const int64_t n_in = static_cast<int64_t>(srcs.size());
  TORCH_CHECK(n_in >= 1, "concat_relu takes at least one input");
  const at::Tensor& s0 = srcs[0];
  const int dt = dt_code(s0.scalar_type());
  TORCH_CHECK(dt != 0, "concat_relu takes u8, s8, s32 or f32 tensors, got ",
              s0.scalar_type());
  TORCH_CHECK(s0.dim() == 4, "concat_relu inputs must be NHWC, input 0 is ",
              s0.sizes());
  // contiguous and 16-byte aligned, as the kernel's vector loads need
  std::vector<at::Tensor> ins(n_in);
  std::vector<const void*> ptrs(n_in);
  std::vector<int> row_bytes(n_in);
  const int64_t elem = s0.element_size();
  int64_t oc = 0;
  for (int64_t i = 0; i < n_in; ++i) {
    const at::Tensor& s = srcs[i];
    TORCH_CHECK(s.scalar_type() == s0.scalar_type(),
                "concat_relu inputs must share dtype: input ", i, " is ",
                s.scalar_type(), ", input 0 ", s0.scalar_type());
    TORCH_CHECK(s.device() == s0.device(),
                "concat_relu inputs must share a device: input ", i,
                " is on ", s.device(), ", input 0 on ", s0.device());
    TORCH_CHECK(s.dim() == 4 && s.size(0) == s0.size(0) &&
                    s.size(1) == s0.size(1) && s.size(2) == s0.size(2),
                "concat_relu inputs must share N, H and W: input ", i,
                " is ", s.sizes(), ", input 0 ", s0.sizes());
    TORCH_CHECK(s.size(3) * elem % 16 == 0, "concat_relu: input ", i,
                "'s pixel rows are ", s.size(3) * elem,
                " bytes, not a multiple of 16");
    ins[i] = s.contiguous();
    if (reinterpret_cast<uintptr_t>(ins[i].data_ptr()) % 16 != 0) {
      ins[i] = ins[i].clone(at::MemoryFormat::Contiguous);
    }
    ptrs[i] = ins[i].data_ptr();
    row_bytes[i] = static_cast<int>(s.size(3) * elem);
    oc += s.size(3);
  }
  const int64_t pixels = s0.size(0) * s0.size(1) * s0.size(2);
  TORCH_CHECK(pixels * (oc * elem / 16) < (int64_t{1} << 31),
              "concat_relu: the output has ", pixels * oc * elem,
              " bytes, the kernel takes fewer than 2^31 16-byte units");
  c10::cuda::CUDAGuard guard(s0.device());
  at::Tensor out =
      at::empty({s0.size(0), s0.size(1), s0.size(2), oc}, s0.options());
  int launches = 0;
  const cudaError_t rc = concat_relu_launch(
      ptrs.data(), row_bytes.data(), static_cast<int>(n_in), out.data_ptr(),
      pixels, relu, dt, c10::cuda::getCurrentCUDAStream().stream(),
      &launches);
  TORCH_CHECK(rc == cudaSuccess, "concat_relu_kernel: CUDA error ",
              static_cast<int>(rc), " (", cudaGetErrorString(rc), ")");
  return {out, launches};
}

}  // namespace

TORCH_LIBRARY(deepfusion_torch, m) {
  m.def("concat_relu(Tensor[] srcs, bool relu) -> (Tensor, int)");
}

TORCH_LIBRARY_IMPL(deepfusion_torch, CUDA, m) {
  m.impl("concat_relu", &concat_relu);
}
