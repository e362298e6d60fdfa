// The kernel library's PyTorch operators, registered with the dispatcher
// when the library is loaded (torch.ops.load_library, _build.kernels()).
// This file declares the namespace (TORCH_LIBRARY) and its small kernels;
// ops_conv.cpp and ops_packed.cpp add the conv and packed-domain families
// (TORCH_LIBRARY_FRAGMENT).
//
//   deepfusion_torch::concat_relu(Tensor[] srcs, bool relu) -> (Tensor, int)
//     launches concat_relu_kernel (concat.cu) through concat_relu_launch
//     (concat.h): NHWC channel concat with an optional true ReLU, of any
//     number of inputs (one launch per group of CONCAT_MAX_IN). Returns the
//     output and the kernel launches the launcher made, which the Python
//     wrapper adds to its launch count.
//   deepfusion_torch::pool(Tensor x, int[] geo) -> Tensor
//     launches pool.cu's kernels through pool_launch (pool.h): max /
//     avg_inc / avg_exc pooling of NHWC x; geo = ih, iw, oh, ow, kh, kw, sh,
//     sw, ph, pw, kind, down (ops/pool.py:_pool_geo).
//   deepfusion_torch::sum_relu(Tensor a, Tensor b, bool relu) -> Tensor
//     launches sum_relu_kernel (sum_relu.cu) through sum_relu_launch
//     (pool.h): a + b (+ ReLU), saturating for integers.
//   deepfusion_torch::depthwise(Tensor src, Tensor wcols, Tensor bias,
//                               Tensor scale, int[] geo) -> Tensor
//     launches depthwise_kernel (depthwise.cu) through depthwise_launch
//     (depthwise.h): a 3x3 depthwise conv of NHWC u8 src into u8 with the
//     exact requant; wcols the (3, c) weight words of ops/depthwise.py,
//     bias and scale f32 over c; geo = ih, iw, oh, ow, c, stride
//     (ops/depthwise.py:depthwise_geo).
//   deepfusion_torch::empty_launches(int calls) -> int
//     launches empty_kernel (empty.cu), which does nothing, `calls` times
//     on the current device's current stream and returns the count: the
//     floor of a launch, through the op and in a loop in C++
//     (tools/kernel_times.py).
//     No tensor, so one kernel for every backend.
//
// Host code only: the .cu files keep out of PyTorch's headers, and this
// side reaches them through their launchers' headers. _build.py compiles
// every .cpp of csrc/ with PyTorch's include paths and the ABI torch was
// built with, and links the library against libtorch. The checks, the
// alignment copy, the device guard, the output's allocation, the stream
// lookup and the launch all run here, behind the dispatcher, so a call pays
// none of them in Python.
//
// Only CUDA kernels are registered: a CPU tensor raises in the dispatcher.
// The plain versions for the CPU are ops/concat.py:concat_plain,
// ops/pool.py:pool_plain and sum_relu_plain, and
// ops/depthwise.py:depthwise_plain.
#include <ATen/ops/empty.h>
#include <c10/cuda/CUDAGuard.h>
#include <c10/cuda/CUDAStream.h>
#include <torch/library.h>

#include <tuple>

#include "concat.h"
#include "depthwise.h"
#include "empty.h"
#include "pool.h"
#include "torch_ops.h"

namespace {

using df_ops::aligned;
using df_ops::check_launch;
using df_ops::dt_code;
using df_ops::narrow;

std::tuple<at::Tensor, int64_t> concat_relu_op(at::TensorList srcs,
                                                bool relu) {
  const int64_t n_in = static_cast<int64_t>(srcs.size());
  TORCH_CHECK(n_in >= 1, "concat_relu takes at least one input");
  const at::Tensor& s0 = srcs[0];
  const int dt = dt_code(s0.scalar_type());
  TORCH_CHECK(dt != 0, "concat_relu takes u8, s8, s32 or f32 tensors, got ",
              s0.scalar_type());
  TORCH_CHECK(s0.dim() == 4, "concat_relu inputs must be NHWC, input 0 is ",
              s0.sizes());
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
    ins[i] = aligned(s);
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
  check_launch(concat_relu_launch(
                   ptrs.data(), row_bytes.data(), static_cast<int>(n_in),
                   out.data_ptr(), pixels, relu, dt,
                   c10::cuda::getCurrentCUDAStream().stream(), &launches),
               "concat_relu_kernel");
  return {out, launches};
}

// ops/pool.py:_pool_geo's order
enum PoolGeo { P_IH, P_IW, P_OH, P_OW, P_KH, P_KW, P_SH, P_SW, P_PH, P_PW,
               P_KIND, P_DOWN, POOL_GEO_INTS };

at::Tensor pool_op(const at::Tensor& x, at::IntArrayRef geo) {
  const auto g = narrow(geo, POOL_GEO_INTS, "pool", "geo");
  const int dt = dt_code(x.scalar_type());
  TORCH_CHECK(dt != 0, "pool takes u8, s8, s32 or f32 tensors, got ",
              x.scalar_type());
  df_ops::check_tensor(x, x.device(), x.scalar_type(), 4, "pool", "x");
  TORCH_CHECK(x.size(1) == g[P_IH] && x.size(2) == g[P_IW],
              "pool: x is ", x.sizes(), ", the config's image ", g[P_IH],
              " x ", g[P_IW]);
  const int n = narrow(x.size(0), "pool", "batch");
  const int c = narrow(x.size(3), "pool", "channels");
  const at::Tensor xa = aligned(x);
  c10::cuda::CUDAGuard guard(x.device());
  at::Tensor out = at::empty({n, g[P_OH], g[P_OW], c}, x.options());
  check_launch(pool_launch(xa.data_ptr(), out.data_ptr(), n, g[P_IH],
                           g[P_IW], c, g[P_OH], g[P_OW], g[P_KH], g[P_KW],
                           g[P_SH], g[P_SW], g[P_PH], g[P_PW], g[P_KIND],
                           g[P_DOWN], dt,
                           c10::cuda::getCurrentCUDAStream().stream()),
               "pool_kernel");
  return out;
}

at::Tensor sum_relu_op(const at::Tensor& a, const at::Tensor& b,
                       bool relu) {
  const int dt = dt_code(a.scalar_type());
  TORCH_CHECK(dt != 0, "sum_relu takes u8, s8, s32 or f32 tensors, got ",
              a.scalar_type());
  TORCH_CHECK(a.is_cuda(), "sum_relu: a must be a CUDA tensor, it is on ",
              a.device());
  df_ops::check_tensor(b, a.device(), a.scalar_type(), a.dim(), "sum_relu",
                       "b");
  TORCH_CHECK(a.sizes() == b.sizes(), "sum_relu: a is ", a.sizes(),
              ", b ", b.sizes());
  const at::Tensor aa = aligned(a), ba = aligned(b);
  c10::cuda::CUDAGuard guard(a.device());
  at::Tensor out = at::empty(a.sizes(), a.options());
  check_launch(sum_relu_launch(aa.data_ptr(), ba.data_ptr(), out.data_ptr(),
                               a.numel() * a.element_size(), relu, dt,
                               c10::cuda::getCurrentCUDAStream().stream()),
               "sum_relu_kernel");
  return out;
}

// ops/depthwise.py:depthwise_geo's order
enum DepthwiseGeo { D_IH, D_IW, D_OH, D_OW, D_C, D_STRIDE,
                    DEPTHWISE_GEO_INTS };

at::Tensor depthwise_op(const at::Tensor& src, const at::Tensor& wcols,
                        const at::Tensor& bias, const at::Tensor& scale,
                        at::IntArrayRef geo) {
  const char* op = "depthwise";
  const auto g = narrow(geo, DEPTHWISE_GEO_INTS, op, "geo");
  const c10::Device dev = src.device();
  df_ops::check_tensor(src, dev, at::kByte, 4, op, "src");
  TORCH_CHECK(src.size(1) == g[D_IH] && src.size(2) == g[D_IW] &&
                  src.size(3) == g[D_C],
              op, ": src is ", src.sizes(), ", the config's (n, ", g[D_IH],
              ", ", g[D_IW], ", ", g[D_C], ")");
  const int n = narrow(src.size(0), op, "batch");
  df_ops::check_tensor(wcols, dev, at::kInt, 2, op, "wcols");
  TORCH_CHECK(wcols.size(0) == 3 && wcols.size(1) == g[D_C], op,
              ": wcols is ", wcols.sizes(), ", it must be (3, ", g[D_C], ")");
  df_ops::lanes_of(bias, dev, at::kFloat, g[D_C], op, "bias");
  df_ops::lanes_of(scale, dev, at::kFloat, g[D_C], op, "scale");
  const at::Tensor x = aligned(src), w = aligned(wcols), b = aligned(bias),
                   s = aligned(scale);
  c10::cuda::CUDAGuard guard(dev);
  at::Tensor out =
      at::empty({src.size(0), g[D_OH], g[D_OW], g[D_C]}, src.options());
  check_launch(depthwise_launch(x.data_ptr(), w.data_ptr(), b.data_ptr(),
                                s.data_ptr(), out.data_ptr(), n, g[D_IH],
                                g[D_IW], g[D_OH], g[D_OW], g[D_C],
                                g[D_STRIDE],
                                c10::cuda::getCurrentCUDAStream().stream()),
               "depthwise_kernel");
  return out;
}

int64_t empty_launches_op(int64_t calls) {
  check_launch(empty_launch(narrow(calls, "empty_launches", "calls"),
                            c10::cuda::getCurrentCUDAStream().stream()),
               "empty_kernel");
  return calls;
}

}  // namespace

TORCH_LIBRARY(deepfusion_torch, m) {
  m.def("concat_relu(Tensor[] srcs, bool relu) -> (Tensor, int)");
  m.def("pool(Tensor x, int[] geo) -> Tensor");
  m.def("sum_relu(Tensor a, Tensor b, bool relu) -> Tensor");
  m.def("depthwise(Tensor src, Tensor wcols, Tensor bias, Tensor scale, "
        "int[] geo) -> Tensor");
  m.def("empty_launches(int calls) -> int");
}

TORCH_LIBRARY_IMPL(deepfusion_torch, CUDA, m) {
  m.impl("concat_relu", &concat_relu_op);
  m.impl("pool", &pool_op);
  m.impl("sum_relu", &sum_relu_op);
  m.impl("depthwise", &depthwise_op);
}

// no tensor argument, so no backend to dispatch on: one kernel for all
TORCH_LIBRARY_IMPL(deepfusion_torch, CompositeExplicitAutograd, m) {
  m.impl("empty_launches", &empty_launches_op);
}
