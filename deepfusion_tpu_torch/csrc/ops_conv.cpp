// The dense conv family's operators in torch.ops.deepfusion_torch (the
// namespace is declared in torch_ops.cpp):
//
//   conv_fused(Tensor src, Tensor wmaps, Tensor bias0, Tensor scale0,
//              Tensor? bias1, Tensor? scale1, Tensor? sum_src, int[] geo,
//              float sum_scale, bool emit_acc1) -> Tensor
//     launches conv_fused_kernel (conv.cu) through conv_fused_launch; an
//     s8 src (an unfused conv into u8) conv_fused_s8src_kernel;
//   convpool(Tensor src, Tensor wmaps, Tensor bias0, Tensor scale0,
//            Tensor? sum_src, int[] geo, float sum_scale) -> Tensor
//     launches convpool_kernel (conv.cu) through convpool_launch;
//   conv_weight_maps(Tensor w0k, Tensor? w1k, bool pool) -> Tensor
//     the TMA maps of an op's K-major weights, a CPU uint8 tensor (6, 128)
//     that ops/conv.py keeps per op and hands to every launch;
//   conv_plan(int[] geo) -> int[]
//     the plan the launcher would run (conv.h: conv_plan), no launch;
//   unfold_cols(Tensor src, int[] geo) -> Tensor
//     launches unfold_cols_kernel (unfold.cu) through unfold_cols_launch:
//     the input of a conv whose column taps are folded into its channels
//     (ops/conv.py: unfold_cols), (n, ih, ow, cp) from NHWC u8 src.
//
// geo is the op's configuration, computed by ops/conv.py (conv_geo and
// convpool_geo once per op, _unfold_geo) in the orders of ConvGeo,
// ConvPoolGeo and UnfoldGeo below; the batch comes from src. The launch
// ops check, make the inputs contiguous and aligned, allocate the output,
// guard the device, take the current stream and launch; a launch error
// raises, naming the kernel. Host code only (see torch_ops.cpp).
#include <ATen/ops/empty.h>
#include <c10/cuda/CUDAGuard.h>
#include <c10/cuda/CUDAStream.h>
#include <torch/library.h>

#include "conv.h"
#include "torch_ops.h"
#include "unfold.h"

namespace {

using df_ops::aligned;
using df_ops::check_launch;
using df_ops::lanes_of;
using df_ops::narrow;

// ops/conv.py:conv_geo's order
enum ConvGeo { C_IH, C_IW, C_IC, C_OH, C_OW, C_KH, C_KW, C_SH, C_SW, C_PH,
               C_PW, C_OC0, C_OC0P, C_OC1, C_OC1P, C_RELU0, C_RELU1,
               C_DOWN0, C_DOWN1, C_HAS_BIAS0, C_HAS_BIAS1, C_FUSE, C_DST_DT,
               C_SUM_DT, CONV_GEO_INTS };

// ops/convpool.py:convpool_geo's order
enum ConvPoolGeo { Q_IH, Q_IW, Q_IC, Q_OH, Q_OW, Q_KH, Q_KW, Q_SH, Q_SW, Q_PH,
               Q_PW, Q_OC0, Q_OC0P, Q_RELU0, Q_DOWN0, Q_HAS_BIAS0, Q_DST_DT,
               Q_SUM_DT, Q_AVG, Q_POOL_DOWN, CONVPOOL_GEO_INTS };

// ops/conv.py:_unfold_geo's order
enum UnfoldGeo { U_OW, U_KW, U_SW, U_PW, U_CP, UNFOLD_GEO_INTS };

// src: NHWC (n, ih, iw, ic) of `st` on a CUDA device; returns n.
int check_src(const at::Tensor& src, int ih, int iw, int ic, const char* op,
              at::ScalarType st = at::kByte) {
  df_ops::check_tensor(src, src.device(), st, 4, op, "src");
  TORCH_CHECK(src.size(1) == ih && src.size(2) == iw && src.size(3) == ic,
              op, ": src is ", src.sizes(), ", the kernel runs (n, ", ih,
              ", ", iw, ", ", ic, ")");
  return narrow(src.size(0), op, "batch");
}

// The sum operand, NHWC (n, oh, ow, oc) of the code sum_dt, aligned; an
// undefined tensor when there is none.
at::Tensor sum_operand(const std::optional<at::Tensor>& sum,
                       const at::Tensor& src, int sum_dt, int n, int oh,
                       int ow, int oc, const char* op) {
  if (!sum.has_value()) return at::Tensor();
  df_ops::check_tensor(*sum, src.device(), df_ops::scalar_type(sum_dt, op),
                       4, op, "sum_src");
  TORCH_CHECK(sum->size(0) == n && sum->size(1) == oh &&
                  sum->size(2) == ow && sum->size(3) == oc,
              op, ": sum_src is ", sum->sizes(), ", the output (", n, ", ",
              oh, ", ", ow, ", ", oc, ")");
  return aligned(*sum);
}

at::Tensor conv_fused_op(const at::Tensor& src, const at::Tensor& wmaps,
                         const at::Tensor& bias0, const at::Tensor& scale0,
                         const std::optional<at::Tensor>& bias1,
                         const std::optional<at::Tensor>& scale1,
                         const std::optional<at::Tensor>& sum_src,
                         at::IntArrayRef geo, double sum_scale,
                         bool emit_acc1) {
  const char* op = "conv_fused";
  const auto g = narrow(geo, CONV_GEO_INTS, op, "geo");
  // the source's dtype is the tensor's: u8, or s8 (conv.h)
  const at::ScalarType src_st =
      src.scalar_type() == at::kChar ? at::kChar : at::kByte;
  const int n = check_src(src, g[C_IH], g[C_IW], g[C_IC], op, src_st);
  const bool fuse = g[C_FUSE] != 0;
  const c10::Device dev = src.device();
  const void* maps = df_ops::host_maps(wmaps, CONV_WMAPS_BYTES, op);
  const void* b0 = lanes_of(bias0, dev, at::kFloat, g[C_OC0P], op, "bias0");
  const void* s0 = lanes_of(scale0, dev, at::kFloat, g[C_OC0P], op, "scale0");
  const void* b1 = lanes_of(bias1, fuse, dev, at::kFloat, g[C_OC1P], op,
                            "bias1");
  const void* s1 = lanes_of(scale1, fuse, dev, at::kFloat, g[C_OC1P], op,
                            "scale1");
  const int out_oc = fuse ? g[C_OC1] : g[C_OC0];
  const at::Tensor sum = sum_operand(sum_src, src, g[C_SUM_DT], n, g[C_OH],
                                     g[C_OW], out_oc, op);
  const int dst_dt = emit_acc1 ? DT_ACC : g[C_DST_DT];
  const at::Tensor x = aligned(src);
  c10::cuda::CUDAGuard guard(dev);
  at::Tensor out = at::empty(
      {src.size(0), g[C_OH], g[C_OW], out_oc},
      src.options().dtype(emit_acc1 ? at::kInt
                                    : df_ops::scalar_type(dst_dt, op)));
  check_launch(
      conv_fused_launch(
          x.data_ptr(), maps, b0, s0, b1, s1, out.data_ptr(),
          sum.defined() ? sum.data_ptr() : nullptr, n, g[C_IH], g[C_IW],
          g[C_IC], g[C_OH], g[C_OW], g[C_KH], g[C_KW], g[C_SH], g[C_SW],
          g[C_PH], g[C_PW], g[C_OC0], g[C_OC0P], g[C_OC1], g[C_OC1P],
          g[C_RELU0], g[C_RELU1], g[C_DOWN0], g[C_DOWN1], g[C_HAS_BIAS0],
          g[C_HAS_BIAS1], g[C_FUSE], dst_dt, g[C_SUM_DT],
          static_cast<float>(sum_scale), df_ops::dt_code(src_st),
          c10::cuda::getCurrentCUDAStream().stream()),
      "conv_fused_kernel");
  return out;
}

at::Tensor convpool_op(const at::Tensor& src, const at::Tensor& wmaps,
                       const at::Tensor& bias0, const at::Tensor& scale0,
                       const std::optional<at::Tensor>& sum_src,
                       at::IntArrayRef geo, double sum_scale) {
  const char* op = "convpool";
  const auto g = narrow(geo, CONVPOOL_GEO_INTS, op, "geo");
  const int n = check_src(src, g[Q_IH], g[Q_IW], g[Q_IC], op);
  const c10::Device dev = src.device();
  const void* maps = df_ops::host_maps(wmaps, CONV_WMAPS_BYTES, op);
  const void* b0 = lanes_of(bias0, dev, at::kFloat, g[Q_OC0P], op, "bias0");
  const void* s0 = lanes_of(scale0, dev, at::kFloat, g[Q_OC0P], op, "scale0");
  const at::Tensor sum = sum_operand(sum_src, src, g[Q_SUM_DT], n, g[Q_OH],
                                     g[Q_OW], g[Q_OC0], op);
  const at::Tensor x = aligned(src);
  c10::cuda::CUDAGuard guard(dev);
  at::Tensor out = at::empty(
      {src.size(0), g[Q_OH] / 2, g[Q_OW] / 2, g[Q_OC0]},
      src.options().dtype(df_ops::scalar_type(g[Q_DST_DT], op)));
  check_launch(
      convpool_launch(
          x.data_ptr(), maps, b0, s0, out.data_ptr(),
          sum.defined() ? sum.data_ptr() : nullptr, n, g[Q_IH], g[Q_IW],
          g[Q_IC], g[Q_OH], g[Q_OW], g[Q_KH], g[Q_KW], g[Q_SH], g[Q_SW],
          g[Q_PH], g[Q_PW], g[Q_OC0], g[Q_OC0P], g[Q_RELU0], g[Q_DOWN0],
          g[Q_HAS_BIAS0], g[Q_DST_DT], g[Q_SUM_DT], g[Q_AVG],
          g[Q_POOL_DOWN], static_cast<float>(sum_scale),
          c10::cuda::getCurrentCUDAStream().stream()),
      "convpool_kernel");
  return out;
}

at::Tensor conv_weight_maps_op(const at::Tensor& w0k,
                               const std::optional<at::Tensor>& w1k,
                               bool pool) {
  const char* op = "conv_weight_maps";
  TORCH_CHECK(w0k.is_cuda(), op, ": w0k must be a CUDA tensor, it is on ",
              w0k.device());
  df_ops::check_kmajor(w0k, w0k.device(), op, "w0k");
  if (w1k.has_value()) df_ops::check_kmajor(*w1k, w0k.device(), op, "w1k");
  c10::cuda::CUDAGuard guard(w0k.device());
  at::Tensor out = at::empty({6, 128}, at::TensorOptions().dtype(at::kByte));
  check_launch(
      conv_weight_maps(
          w0k.data_ptr(), narrow(w0k.size(1), op, "k0"),
          narrow(w0k.size(0), op, "oc0p"),
          w1k.has_value() ? w1k->data_ptr() : nullptr,
          w1k.has_value() ? narrow(w1k->size(1), op, "k1") : 0,
          w1k.has_value() ? narrow(w1k->size(0), op, "oc1p") : 0, pool,
          out.data_ptr()),
      op);
  return out;
}

std::vector<int64_t> conv_plan_op(at::IntArrayRef geo) {
  const auto in = narrow(geo, CONV_PLAN_IN, "conv_plan", "geo");
  int out[CONV_PLAN_OUT];
  check_launch(conv_plan(in.data(), out), "conv_plan");
  return std::vector<int64_t>(out, out + CONV_PLAN_OUT);
}

at::Tensor unfold_cols_op(const at::Tensor& src, at::IntArrayRef geo) {
  const char* op = "unfold_cols";
  const auto g = narrow(geo, UNFOLD_GEO_INTS, op, "geo");
  df_ops::check_tensor(src, src.device(), at::kByte, 4, op, "src");
  const int iw = narrow(src.size(2), op, "iw");
  const int ic = narrow(src.size(3), op, "ic");
  TORCH_CHECK(g[U_CP] % 16 == 0 && g[U_CP] >= int64_t{g[U_KW]} * ic, op,
              ": cp = ", g[U_CP], " must be a multiple of 16 and at least "
              "kw * ic = ", int64_t{g[U_KW]} * ic);
  const at::Tensor x = aligned(src);
  c10::cuda::CUDAGuard guard(src.device());
  at::Tensor out =
      at::empty({src.size(0), src.size(1), g[U_OW], g[U_CP]}, src.options());
  check_launch(unfold_cols_launch(
                   x.data_ptr(), out.data_ptr(), src.size(0) * src.size(1),
                   iw, ic, g[U_OW], g[U_KW], g[U_SW], g[U_PW], g[U_CP],
                   c10::cuda::getCurrentCUDAStream().stream()),
               "unfold_cols_kernel");
  return out;
}

}  // namespace

TORCH_LIBRARY_FRAGMENT(deepfusion_torch, m) {
  m.def("conv_fused(Tensor src, Tensor wmaps, Tensor bias0, Tensor scale0, "
        "Tensor? bias1, Tensor? scale1, Tensor? sum_src, int[] geo, "
        "float sum_scale, bool emit_acc1) -> Tensor");
  m.def("convpool(Tensor src, Tensor wmaps, Tensor bias0, Tensor scale0, "
        "Tensor? sum_src, int[] geo, float sum_scale) -> Tensor");
  m.def("conv_weight_maps(Tensor w0k, Tensor? w1k, bool pool) -> Tensor");
  m.def("conv_plan(int[] geo) -> int[]");
  m.def("unfold_cols(Tensor src, int[] geo) -> Tensor");
}

TORCH_LIBRARY_IMPL(deepfusion_torch, CUDA, m) {
  m.impl("conv_fused", &conv_fused_op);
  m.impl("convpool", &convpool_op);
  m.impl("conv_weight_maps", &conv_weight_maps_op);
  m.impl("unfold_cols", &unfold_cols_op);
}

// no tensor argument, so no backend to dispatch on: one kernel for all
TORCH_LIBRARY_IMPL(deepfusion_torch, CompositeExplicitAutograd, m) {
  m.impl("conv_plan", &conv_plan_op);
}
