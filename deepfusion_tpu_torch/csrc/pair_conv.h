// The launcher of pair_conv_kernel (pair_conv.cu) and its planner: plain
// C++ functions that the registered ops deepfusion_torch::pair_conv and
// pair_plan (ops_packed.cpp) call. Neither side of it includes a PyTorch
// header in the other.
#pragma once

#include <cuda_runtime_api.h>

// Ints of one layer (make_layer), of the geometry (make_args) and of the
// plan pair_plan writes.
constexpr int PAIR_LAYER_INTS = 14;
constexpr int PAIR_GEO_INTS = 17;
constexpr int PAIR_PLAN_OUT = 10;
// Pointers of one layer: corr0, bias0, scale0, bias1, scale1, wmaps.
constexpr int PAIR_LAYER_PTRS = 6;

// src: the packed input (rows_in rows of iwp slots of ia's kp lanes);
// ops_a/ops_b: each layer's PAIR_LAYER_PTRS pointers corr0 (layer b's is
// not read), bias0, scale0, bias1, scale1 (device memory, null when the
// layer is not fused) and wmaps (host memory: PackedConvOp's 6 maps of its
// K-major weights, packed_weight_maps); ia/ib: each layer's
// PAIR_LAYER_INTS ints kh, kw, ph, pw, kp (the lanes of its one input),
// oc0, oc0p, oc1, oc1p, down0, down1, has_bias0, has_bias1, fuse; geo:
// PAIR_GEO_INTS ints n, iwp, rows_in, halo_in, col_off_in, mh, mw, oh, ow,
// rows_out, halo_out, col_off_out, pool2, oy0, noy, mlo, mhi
// (rows_in/halo_in and rows_out/halo_out those of the slice and of the
// output range, the halos re-based; [mlo, mhi) the intermediate's rows
// that layer b reads as image). dst: the packed output (rows of it),
// pooled when pool2. Launches pair_conv_kernel on `stream` and returns
// cudaGetLastError(), or the error that kept it from launching.
cudaError_t pair_conv_launch(const void* src, const void* const* ops_a,
                             const void* const* ops_b, void* dst,
                             const int* ia, const int* ib, const int* geo,
                             cudaStream_t stream);

// The plan pair_conv_launch would launch, for the record: out = the output
// tile's rows and columns, split, tiles, blocks, ring stages, shared bytes,
// the widest K chunk, the window's pixels (layer a's M rows of a tile),
// layer a's m64 blocks per tile. Launches nothing.
cudaError_t pair_plan(const int* ia, const int* ib, const int* geo,
                      int* out);
