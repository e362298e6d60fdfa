// The launcher of packed_conv_kernel (packed_conv.cu), the encoder of its
// weights' tensor maps and its planner: plain C++ functions that the
// registered ops deepfusion_torch::packed_conv, packed_weight_maps and
// packed_plan (ops_packed.cpp) call. Neither side of it includes a PyTorch
// header in the other.
#pragma once

#include <cuda_runtime_api.h>

// Inputs of one launch (packed_dst.cuh MAX_SRC).
constexpr int PACKED_MAX_SRC = 4;
// Bytes of the six tensor maps packed_weight_maps writes (6 x 128).
constexpr int PACKED_WMAPS_BYTES = 6 * 128;
// Ints packed_plan reads and writes.
constexpr int PACKED_PLAN_IN = 15;
constexpr int PACKED_PLAN_OUT = 12;

// The weight maps of an op, encoded once (ops/packed.py caches them):
// out[0, 3) the maps of w0k (oc0p rows x k0 bytes, the kernel's K order),
// out[3, 6) those of w1k (oc1p rows x oc0p bytes) when w1k is not null.
// out holds PACKED_WMAPS_BYTES.
cudaError_t packed_weight_maps(const void* w0k, int k0, int oc0p,
                               const void* w1k, int oc1p, void* out);

// in: n, noy, ow, n_src, cp[0..3], kh, kw, oc0p, oc1p, fuse, pool2,
// merge; out:
// the tile rows and columns, blocks, stages, shared bytes, nb0, nb1,
// passes of each stage, K chunks per tap, K bytes per tap, tiles. Returns
// cudaErrorInvalidValue if the kernel cannot run the op. Launches nothing.
cudaError_t packed_plan(const int* in, int* out);

// srcs/src_cps: n_src input arrays and their lane counts (each a multiple
// of 16, summing to icp, a multiple of 32); corr0 [oc0p] s32, 128 * sum(w0)
// per channel; wmaps: packed_weight_maps' maps of the op's K-major weights
// (host memory); the output lane count is oc0p unfused, oc1p fused.
// sum: null, or a packed array of rows_sum rows with the output's iwp,
// col_off and lanes and halo_sum >= halo_out. pool2: the output is the
// pooled spec (rows_out / 2 rows of iwp / 2, halo_out / 2, col_off_out / 2);
// oh, ow, halo_out, col_off_out and iwp must then be even. merge (with
// pool2; an unfused 1x1 with no padding, no sum, every input's lanes a
// multiple of 32 and their sum oc0p): the input's lane o at each pixel
// joins the clamped u8 value of channel o by a saturating add before the
// pool (packed_conv.cu). raw (fused, no
// pool, no sum): dst is s32, the raw 1x1 accumulator. Row range: the image
// rows [oy0, oy0 + noy) (noy >= 1; both even with pool2) are computed;
// rows_out/halo_out describe the rows of dst (halo_out re-based, may be
// negative) and rows_in/halo_in the input slice (halo_in re-based).
// Launches packed_conv_kernel on `stream` and returns cudaGetLastError(),
// or the error that kept it from launching.
cudaError_t packed_conv_launch(
    const void* const* srcs, const int* src_cps, int n_src, const void* corr0,
    const void* bias0, const void* scale0, const void* bias1,
    const void* scale1, const void* wmaps, void* dst, const void* sum, int n,
    int rows_in, int iwp, int halo_in, int col_off_in, int rows_out,
    int halo_out, int col_off_out, int oh, int ow, int kh, int kw, int ph,
    int pw, int oc0, int oc0p, int oc1, int oc1p, int down0, int down1,
    int has_bias0, int has_bias1, int fuse, int rows_sum, int halo_sum,
    int pool2, int merge, int raw, int oy0, int noy, float sum_scale,
    cudaStream_t stream);
