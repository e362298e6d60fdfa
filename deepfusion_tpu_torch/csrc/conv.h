// The launchers of conv_fused_kernel and convpool_kernel (conv.cu), the
// encoder of their weights' tensor maps and their planner: plain C++
// functions that the registered ops deepfusion_torch::conv_fused,
// convpool, conv_weight_maps and conv_plan (ops_conv.cpp) call. Neither
// side of it includes a PyTorch header in the other.
#pragma once

#include <cuda_runtime_api.h>

#include "dtypes.h"

// The dst code of the fused kernel's raw s32 1x1 accumulator (emit_acc1):
// not a dtype code.
constexpr int DT_ACC = 0;
// Bytes of the six tensor maps conv_weight_maps writes (6 x 128).
constexpr int CONV_WMAPS_BYTES = 6 * 128;
// Ints conv_plan reads and writes.
constexpr int CONV_PLAN_IN = 17;
constexpr int CONV_PLAN_OUT = 16;

// The weight maps of an op, encoded once (ops/conv.py caches them): out[0,
// 3) the maps of w0k (oc0p rows x k0 bytes), out[3, 6) those of w1k (oc1p
// rows x k1 bytes) when w1k is not null. out holds CONV_WMAPS_BYTES. pool:
// the maps convpool_launch reads (w0k's boxes of at most 64 rows).
cudaError_t conv_weight_maps(const void* w0k, int k0, int oc0p,
                             const void* w1k, int k1, int oc1p, bool pool,
                             void* out);

// in: n, ih, iw, ic, oh, ow, kh, kw, sh, sw, ph, pw, oc0p, oc1p, fuse,
// dst_dt, pool; out: tile rows of M, tile rows and columns of pixels,
// split, tiles, blocks, stages, shared bytes, nb0, nb1, passes of each
// stage, K chunks per tap, K bytes per tap, gemm (the 1x1 run as a GEMM),
// work items. Returns cudaErrorInvalidValue if the kernel cannot run the
// conv. Launches nothing.
cudaError_t conv_plan(const int* in, int* out);

// src: NHWC u8, or s8 where src_dt is DT_S8 (an unfused conv into u8
// only), ic a multiple of 16; wmaps: conv_weight_maps' maps of the
// op's K-major weights (host memory); bias/scale: f32 over oc0p (oc1p)
// lanes. sum: null, or the NHWC sum operand of sum_dt (the dst dtype
// codes). dst_dt DT_ACC (fused only): dst is the raw s32 1x1 accumulator,
// (n, oh, ow, oc1) int32, and bias1, scale1, relu1, down1 and sum are not
// read. Strides 1..8. Launches conv_fused_kernel (conv_fused_s8src_kernel
// for an s8 src) on `stream` and returns cudaGetLastError(), or the error
// that kept it from launching.
cudaError_t conv_fused_launch(
    const void* src, const void* wmaps, const void* bias0,
    const void* scale0, const void* bias1, const void* scale1, void* dst,
    const void* sum, int n, int ih, int iw, int ic, int oh, int ow, int kh,
    int kw, int sh, int sw, int ph, int pw, int oc0, int oc0p, int oc1,
    int oc1p, int relu0, int relu1, int down0, int down1, int has_bias0,
    int has_bias1, int fuse, int dst_dt, int sum_dt, float sum_scale,
    int src_dt, cudaStream_t stream);

// Pool mode: the conv (+ sum) then a 2x2/s2 pool (avg, else max, its
// integer average rounded down when pool_down). dst: NHWC (n, oh / 2,
// ow / 2, oc0) of dst_dt; sum: null, or the NHWC (n, oh, ow, oc0) sum
// operand of sum_dt; wmaps: conv_weight_maps' maps with pool set. oh and
// ow even; an s32 average is refused, as pool2_fusable refuses it.
// Launches convpool_kernel on `stream`.
cudaError_t convpool_launch(
    const void* src, const void* wmaps, const void* bias0,
    const void* scale0, void* dst, const void* sum, int n, int ih, int iw,
    int ic, int oh, int ow, int kh, int kw, int sh, int sw, int ph, int pw,
    int oc0, int oc0p, int relu0, int down0, int has_bias0, int dst_dt,
    int sum_dt, int avg, int pool_down, float sum_scale,
    cudaStream_t stream);
