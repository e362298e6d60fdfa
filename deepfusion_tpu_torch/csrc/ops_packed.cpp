// The packed-domain family's operators in torch.ops.deepfusion_torch (the
// namespace is declared in torch_ops.cpp):
//
//   packed_conv(Tensor[] srcs, int[] cps, Tensor corr0, Tensor bias0,
//               Tensor scale0, Tensor? bias1, Tensor? scale1, Tensor wmaps,
//               Tensor? sum, int[] geo, int[] rows, bool raw,
//               float sum_scale) -> Tensor
//     launches packed_conv_kernel (packed_conv.cu) through
//     packed_conv_launch;
//   packed_weight_maps(Tensor w0k, Tensor? w1k) -> Tensor
//     the TMA maps of an op's K-major weights, a CPU uint8 tensor (6, 128)
//     that ops/packed.py keeps per op and hands to every launch;
//   packed_plan(int[] geo) -> int[]
//     the plan packed_conv_launch would run, no launch;
//   packed_sum_pool(Tensor[] ys, Tensor? r, int rows, int iwp, bool pool)
//       -> (Tensor, int)
//     launches packed_maxpool2_kernel (the pool alone) or
//     packed_sum_pool_kernel (packed_sum_pool.cu, any count of inputs of
//     any lanes, one launch per group of SUM_POOL_MAX_IN) through
//     packed_sum_pool_launch; returns the output and the kernel launches
//     it made, which the Python wrapper adds to its launch count;
//   pair_conv(Tensor src, Tensor corr0_a, Tensor bias0_a, Tensor scale0_a,
//             Tensor? bias1_a, Tensor? scale1_a, Tensor wmaps_a,
//             Tensor bias0_b, Tensor scale0_b, Tensor? bias1_b,
//             Tensor? scale1_b, Tensor wmaps_b, int[] layer_a,
//             int[] layer_b, int[] geo, int[] rows) -> Tensor
//     launches pair_conv_kernel (pair_conv.cu) through pair_conv_launch;
//   pair_plan(int[] layer_a, int[] layer_b, int[] geo) -> int[]
//     the plan pair_conv_launch would run, no launch.
//
// geo and layer_a/layer_b are an op's configuration, computed once per op
// by ops/packed.py (packed_geo) and ops/mega.py (_layer_ints, pair_geo) in
// the orders of the enums below; rows is what depends on the call (the
// output row range and the input slice); the batch and the input rows come
// from the inputs. The launch ops check, make the inputs contiguous and
// aligned, allocate the output, guard the device, take the current stream
// and launch; a launch error raises, naming the kernel. Host code only (see
// torch_ops.cpp).
#include <ATen/ops/empty.h>
#include <c10/cuda/CUDAGuard.h>
#include <c10/cuda/CUDAStream.h>
#include <torch/library.h>

#include "packed_conv.h"
#include "packed_sum_pool.h"
#include "pair_conv.h"
#include "torch_ops.h"

namespace {

using df_ops::aligned;
using df_ops::check_launch;
using df_ops::lanes_of;
using df_ops::narrow;

// ops/packed.py:packed_geo's order
enum PackedGeo { K_IWP, K_COL_OFF_IN, K_COL_OFF_OUT, K_OH, K_OW, K_KH, K_KW,
                 K_PH, K_PW, K_OC0, K_OC0P, K_OC1, K_OC1P, K_DOWN0, K_DOWN1,
                 K_HAS_BIAS0, K_HAS_BIAS1, K_FUSE, K_ROWS_SUM, K_HALO_SUM,
                 K_POOL2, K_MERGE_POOL, PACKED_GEO_INTS };
// the call's rows, ops/packed.py:packed_conv_cuda's order
enum PackedRows { R_HALO_IN, R_ROWS_OUT, R_HALO_OUT, R_OY0, R_NOY,
                  PACKED_ROWS_INTS };

// A packed array: a 3-D s8 CUDA tensor (n, slots, lanes) on `dev`.
void check_packed(const at::Tensor& t, const c10::Device& dev, int64_t n,
                  int64_t slots, int64_t lanes, const char* op,
                  const char* what) {
  df_ops::check_tensor(t, dev, at::kChar, 3, op, what);
  TORCH_CHECK(t.size(0) == n && t.size(1) == slots && t.size(2) == lanes,
              op, ": ", what, " is ", t.sizes(), ", the kernel reads (", n,
              ", ", slots, ", ", lanes, ")");
}

// The rows of a packed input (n, rows * iwp, lanes): srcs[0]'s slots over
// iwp, which must divide them.
int rows_of(const at::Tensor& t, int iwp, const char* op) {
  TORCH_CHECK(t.dim() == 3 && iwp > 0 && t.size(1) % iwp == 0, op,
              ": the input is ", t.sizes(), ", not rows of ", iwp,
              " slots");
  return narrow(t.size(1) / iwp, op, "input rows");
}

at::Tensor packed_conv_op(at::TensorList srcs, at::IntArrayRef cps,
                          const at::Tensor& corr0, const at::Tensor& bias0,
                          const at::Tensor& scale0,
                          const std::optional<at::Tensor>& bias1,
                          const std::optional<at::Tensor>& scale1,
                          const at::Tensor& wmaps,
                          const std::optional<at::Tensor>& sum,
                          at::IntArrayRef geo, at::IntArrayRef rows,
                          bool raw, double sum_scale) {
  const char* op = "packed_conv";
  const auto g = narrow(geo, PACKED_GEO_INTS, op, "geo");
  const auto r = narrow(rows, PACKED_ROWS_INTS, op, "rows");
  const int n_src = static_cast<int>(srcs.size());
  TORCH_CHECK(n_src >= 1 && n_src <= PACKED_MAX_SRC, op, " takes 1 to ",
              PACKED_MAX_SRC, " inputs, got ", n_src);
  const auto src_cps = narrow(cps, srcs.size(), op, "cps");
  const at::Tensor& s0 = srcs[0];
  TORCH_CHECK(s0.is_cuda(), op, ": srcs[0] must be a CUDA tensor, it is on ",
              s0.device());
  const c10::Device dev = s0.device();
  const int rows_in = rows_of(s0, g[K_IWP], op);
  const int64_t n = s0.size(0);
  std::vector<at::Tensor> ins(n_src);
  std::vector<const void*> ptrs(n_src);
  for (int i = 0; i < n_src; ++i) {
    check_packed(srcs[i], dev, n, s0.size(1), src_cps[i], op, "an input");
    ins[i] = aligned(srcs[i]);
    ptrs[i] = ins[i].data_ptr();
  }
  const bool fuse = g[K_FUSE] != 0;
  const int cp_out = fuse ? g[K_OC1P] : g[K_OC0P];
  const void* c0 = lanes_of(corr0, dev, at::kInt, g[K_OC0P], op, "corr0");
  const void* b0 = lanes_of(bias0, dev, at::kFloat, g[K_OC0P], op, "bias0");
  const void* s0p = lanes_of(scale0, dev, at::kFloat, g[K_OC0P], op,
                             "scale0");
  const void* b1 = lanes_of(bias1, fuse, dev, at::kFloat, g[K_OC1P], op,
                            "bias1");
  const void* s1 = lanes_of(scale1, fuse, dev, at::kFloat, g[K_OC1P], op,
                            "scale1");
  const void* maps = df_ops::host_maps(wmaps, PACKED_WMAPS_BYTES, op);
  at::Tensor sum_a;
  if (sum.has_value()) {
    check_packed(*sum, dev, n, int64_t{g[K_ROWS_SUM]} * g[K_IWP], cp_out, op,
                 "sum");
    sum_a = aligned(*sum);
  }
  const bool pool2 = g[K_POOL2] != 0;
  const int64_t slots = pool2
                            ? int64_t{r[R_ROWS_OUT] / 2} * (g[K_IWP] / 2)
                            : int64_t{r[R_ROWS_OUT]} * g[K_IWP];
  c10::cuda::CUDAGuard guard(dev);
  at::Tensor out =
      at::empty({n, slots, cp_out}, s0.options().dtype(raw ? at::kInt
                                                            : at::kChar));
  check_launch(
      packed_conv_launch(
          ptrs.data(), src_cps.data(), n_src, c0, b0, s0p, b1, s1, maps,
          out.data_ptr(), sum_a.defined() ? sum_a.data_ptr() : nullptr,
          narrow(n, op, "batch"), rows_in, g[K_IWP], r[R_HALO_IN],
          g[K_COL_OFF_IN], r[R_ROWS_OUT], r[R_HALO_OUT], g[K_COL_OFF_OUT],
          g[K_OH], g[K_OW], g[K_KH], g[K_KW], g[K_PH], g[K_PW], g[K_OC0],
          g[K_OC0P], g[K_OC1], g[K_OC1P], g[K_DOWN0], g[K_DOWN1],
          g[K_HAS_BIAS0], g[K_HAS_BIAS1], g[K_FUSE], g[K_ROWS_SUM],
          g[K_HALO_SUM], g[K_POOL2], g[K_MERGE_POOL], raw ? 1 : 0,
          r[R_OY0], r[R_NOY],
          static_cast<float>(sum_scale),
          c10::cuda::getCurrentCUDAStream().stream()),
      "packed_conv_kernel");
  return out;
}

at::Tensor packed_weight_maps_op(const at::Tensor& w0k,
                                 const std::optional<at::Tensor>& w1k) {
  const char* op = "packed_weight_maps";
  TORCH_CHECK(w0k.is_cuda(), op, ": w0k must be a CUDA tensor, it is on ",
              w0k.device());
  df_ops::check_kmajor(w0k, w0k.device(), op, "w0k");
  if (w1k.has_value()) df_ops::check_kmajor(*w1k, w0k.device(), op, "w1k");
  c10::cuda::CUDAGuard guard(w0k.device());
  at::Tensor out = at::empty({6, 128}, at::TensorOptions().dtype(at::kByte));
  check_launch(
      packed_weight_maps(
          w0k.data_ptr(), narrow(w0k.size(1), op, "k0"),
          narrow(w0k.size(0), op, "oc0p"),
          w1k.has_value() ? w1k->data_ptr() : nullptr,
          w1k.has_value() ? narrow(w1k->size(0), op, "oc1p") : 0,
          out.data_ptr()),
      op);
  return out;
}

std::vector<int64_t> packed_plan_op(at::IntArrayRef geo) {
  const auto in = narrow(geo, PACKED_PLAN_IN, "packed_plan", "geo");
  int out[PACKED_PLAN_OUT];
  check_launch(packed_plan(in.data(), out), "packed_plan");
  return std::vector<int64_t>(out, out + PACKED_PLAN_OUT);
}

std::tuple<at::Tensor, int64_t> packed_sum_pool_op(
    at::TensorList ys, const std::optional<at::Tensor>& r, int64_t rows,
    int64_t iwp, bool pool) {
  const char* op = "packed_sum_pool";
  const int n_y = static_cast<int>(ys.size());
  TORCH_CHECK(n_y >= 1, op, " takes at least one input");
  const at::Tensor& y0 = ys[0];
  TORCH_CHECK(y0.is_cuda(), op, ": ys[0] must be a CUDA tensor, it is on ",
              y0.device());
  TORCH_CHECK(y0.dim() == 3, op, ": ys[0] is ", y0.sizes());
  const c10::Device dev = y0.device();
  const int64_t n = y0.size(0), slots = rows * iwp;
  std::vector<at::Tensor> ins(n_y);
  std::vector<const void*> ptrs(n_y);
  std::vector<int> cps(n_y);
  int64_t cp = 0;
  for (int i = 0; i < n_y; ++i) {
    TORCH_CHECK(ys[i].dim() == 3, op, ": an input is ", ys[i].sizes());
    check_packed(ys[i], dev, n, slots, ys[i].size(2), op, "an input");
    ins[i] = aligned(ys[i]);
    ptrs[i] = ins[i].data_ptr();
    cps[i] = narrow(ys[i].size(2), op, "input lanes");
    cp += cps[i];
  }
  at::Tensor ra;
  if (r.has_value()) {
    check_packed(*r, dev, n, slots, cp, op, "r");
    ra = aligned(*r);
  }
  c10::cuda::CUDAGuard guard(dev);
  at::Tensor out = at::empty(
      {n, pool ? rows / 2 * (iwp / 2) : slots, cp}, y0.options());
  int launches = 0;
  check_launch(
      packed_sum_pool_launch(
          ptrs.data(), cps.data(), n_y, ra.defined() ? ra.data_ptr() : nullptr,
          out.data_ptr(), narrow(n, op, "batch"), narrow(rows, op, "rows"),
          narrow(iwp, op, "iwp"), narrow(cp, op, "lanes"), r.has_value(),
          pool, c10::cuda::getCurrentCUDAStream().stream(), &launches),
      "packed_sum_pool_kernel");
  return {out, launches};
}

// ops/mega.py:_layer_ints's order (pair_conv.cu: make_layer)
enum PairLayer { L_KH, L_KW, L_PH, L_PW, L_KP, L_OC0, L_OC0P, L_OC1, L_OC1P,
                 L_DOWN0, L_DOWN1, L_HAS_BIAS0, L_HAS_BIAS1, L_FUSE };
static_assert(L_FUSE + 1 == PAIR_LAYER_INTS, "pair_conv.h");
// ops/mega.py:pair_geo's order, and the call's rows (pair_conv_cuda)
enum PairGeo { G_IWP, G_COL_OFF_IN, G_MH, G_MW, G_OH, G_OW, G_COL_OFF_OUT,
               G_POOL2, PAIR_CFG_INTS };
enum PairRows { PR_HALO_IN, PR_ROWS_OUT, PR_HALO_OUT, PR_OY0, PR_NOY, PR_MLO,
                PR_MHI, PAIR_ROWS_INTS };

at::Tensor pair_conv_op(
    const at::Tensor& src, const at::Tensor& corr0_a,
    const at::Tensor& bias0_a, const at::Tensor& scale0_a,
    const std::optional<at::Tensor>& bias1_a,
    const std::optional<at::Tensor>& scale1_a, const at::Tensor& wmaps_a,
    const at::Tensor& bias0_b, const at::Tensor& scale0_b,
    const std::optional<at::Tensor>& bias1_b,
    const std::optional<at::Tensor>& scale1_b, const at::Tensor& wmaps_b,
    at::IntArrayRef layer_a, at::IntArrayRef layer_b, at::IntArrayRef geo,
    at::IntArrayRef rows) {
  const char* op = "pair_conv";
  const auto la = narrow(layer_a, PAIR_LAYER_INTS, op, "layer_a");
  const auto lb = narrow(layer_b, PAIR_LAYER_INTS, op, "layer_b");
  const auto g = narrow(geo, PAIR_CFG_INTS, op, "geo");
  const auto r = narrow(rows, PAIR_ROWS_INTS, op, "rows");
  TORCH_CHECK(src.is_cuda(), op, ": src must be a CUDA tensor, it is on ",
              src.device());
  const c10::Device dev = src.device();
  const int rows_in = rows_of(src, g[G_IWP], op);
  const int64_t n = src.size(0);
  check_packed(src, dev, n, src.size(1), la[L_KP], op, "src");
  const bool fa = la[L_FUSE] != 0, fb = lb[L_FUSE] != 0;
  const void* ops_a[PAIR_LAYER_PTRS] = {
      lanes_of(corr0_a, dev, at::kInt, la[L_OC0P], op, "corr0_a"),
      lanes_of(bias0_a, dev, at::kFloat, la[L_OC0P], op, "bias0_a"),
      lanes_of(scale0_a, dev, at::kFloat, la[L_OC0P], op, "scale0_a"),
      lanes_of(bias1_a, fa, dev, at::kFloat, la[L_OC1P], op, "bias1_a"),
      lanes_of(scale1_a, fa, dev, at::kFloat, la[L_OC1P], op, "scale1_a"),
      df_ops::host_maps(wmaps_a, PACKED_WMAPS_BYTES, op)};
  // layer b reads no correction: its input is the u8 intermediate
  const void* ops_b[PAIR_LAYER_PTRS] = {
      nullptr,
      lanes_of(bias0_b, dev, at::kFloat, lb[L_OC0P], op, "bias0_b"),
      lanes_of(scale0_b, dev, at::kFloat, lb[L_OC0P], op, "scale0_b"),
      lanes_of(bias1_b, fb, dev, at::kFloat, lb[L_OC1P], op, "bias1_b"),
      lanes_of(scale1_b, fb, dev, at::kFloat, lb[L_OC1P], op, "scale1_b"),
      df_ops::host_maps(wmaps_b, PACKED_WMAPS_BYTES, op)};
  const int full[PAIR_GEO_INTS] = {
      narrow(n, op, "batch"), g[G_IWP], rows_in, r[PR_HALO_IN],
      g[G_COL_OFF_IN], g[G_MH], g[G_MW], g[G_OH], g[G_OW], r[PR_ROWS_OUT],
      r[PR_HALO_OUT], g[G_COL_OFF_OUT], g[G_POOL2], r[PR_OY0], r[PR_NOY],
      r[PR_MLO], r[PR_MHI]};
  const int cp_out = fb ? lb[L_OC1P] : lb[L_OC0P];
  const int64_t slots = g[G_POOL2]
                            ? int64_t{r[PR_ROWS_OUT] / 2} * (g[G_IWP] / 2)
                            : int64_t{r[PR_ROWS_OUT]} * g[G_IWP];
  const at::Tensor x = aligned(src);
  c10::cuda::CUDAGuard guard(dev);
  at::Tensor out = at::empty({n, slots, cp_out}, src.options());
  check_launch(pair_conv_launch(x.data_ptr(), ops_a, ops_b, out.data_ptr(),
                                la.data(), lb.data(), full,
                                c10::cuda::getCurrentCUDAStream().stream()),
               "pair_conv_kernel");
  return out;
}

std::vector<int64_t> pair_plan_op(at::IntArrayRef layer_a,
                                  at::IntArrayRef layer_b,
                                  at::IntArrayRef geo) {
  const char* op = "pair_plan";
  const auto la = narrow(layer_a, PAIR_LAYER_INTS, op, "layer_a");
  const auto lb = narrow(layer_b, PAIR_LAYER_INTS, op, "layer_b");
  const auto g = narrow(geo, PAIR_GEO_INTS, op, "geo");
  int out[PAIR_PLAN_OUT];
  check_launch(pair_plan(la.data(), lb.data(), g.data(), out), op);
  return std::vector<int64_t>(out, out + PAIR_PLAN_OUT);
}

}  // namespace

TORCH_LIBRARY_FRAGMENT(deepfusion_torch, m) {
  m.def("packed_conv(Tensor[] srcs, int[] cps, Tensor corr0, Tensor bias0, "
        "Tensor scale0, Tensor? bias1, Tensor? scale1, Tensor wmaps, "
        "Tensor? sum, int[] geo, int[] rows, bool raw, float sum_scale) "
        "-> Tensor");
  m.def("packed_weight_maps(Tensor w0k, Tensor? w1k) -> Tensor");
  m.def("packed_plan(int[] geo) -> int[]");
  m.def("packed_sum_pool(Tensor[] ys, Tensor? r, int rows, int iwp, "
        "bool pool) -> (Tensor, int)");
  m.def("pair_conv(Tensor src, Tensor corr0_a, Tensor bias0_a, "
        "Tensor scale0_a, Tensor? bias1_a, Tensor? scale1_a, "
        "Tensor wmaps_a, Tensor bias0_b, Tensor scale0_b, Tensor? bias1_b, "
        "Tensor? scale1_b, Tensor wmaps_b, int[] layer_a, int[] layer_b, "
        "int[] geo, int[] rows) -> Tensor");
  m.def("pair_plan(int[] layer_a, int[] layer_b, int[] geo) -> int[]");
}

TORCH_LIBRARY_IMPL(deepfusion_torch, CUDA, m) {
  m.impl("packed_conv", &packed_conv_op);
  m.impl("packed_weight_maps", &packed_weight_maps_op);
  m.impl("packed_sum_pool", &packed_sum_pool_op);
  m.impl("pair_conv", &pair_conv_op);
}

// no tensor argument, so no backend to dispatch on: one kernel for all
TORCH_LIBRARY_IMPL(deepfusion_torch, CompositeExplicitAutograd, m) {
  m.impl("packed_plan", &packed_plan_op);
  m.impl("pair_plan", &pair_plan_op);
}
