// The output of the packed conv kernels (packed_conv.cu, pair_conv.cu): a
// packed image, or a row range of one, and the fill of its non-image slots.
//
// Packed domain (deepfusion_tpu_torch/ops/packed.py): an image is an int8
// array (n, rows * iwp, cp), rows = h + 2 * halo, whose byte at an image
// slot is u8 ^ 0x80 and whose every other slot (halo rows, margin columns,
// lanes >= c) holds 0x80 = -128, u8 zero.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int MAX_SRC = 4;               // inputs of one packed conv
constexpr uint32_t CENTER4 = 0x80808080u;

// A kernel's final output: a packed image (the pooled spec when it pools),
// or rows [r0, r0 + rows) of one, with halo = the image's halo - r0 (so it
// may be negative); bytes per lane 1, or 4 for a raw s32 accumulator.
struct PackedDst {
  uint8_t* dst;
  int n, rows, iwp, cp, halo, h, col_off, w;
};

// Fill the output's non-image slots with the byte 0x80, or with LANE_BYTES
// = 4 the s32 zero, one array row (iwp slots) per warp: rows first, first +
// stride, ... of the n * rows; a halo row whole, an image row's two
// margins, each a contiguous run of 16-byte units that the warp's lanes
// store side by side. The host checks that n * rows * iwp fits an int.
template <int LANE_BYTES = 1>
__device__ __forceinline__ void fill_pad_rows(const PackedDst& d, int first,
                                              int stride) {
  const int lane = threadIdx.x & 31;
  const int upp = d.cp * LANE_BYTES / 16, urow = d.iwp * upp;
  const uint32_t word = LANE_BYTES == 1 ? CENTER4 : 0u;
  const uint4 pad = make_uint4(word, word, word, word);
  for (int r = first; r < d.n * d.rows; r += stride) {
    const int row = r % d.rows;
    const bool img = row >= d.halo && row < d.halo + d.h;
    // the image's units [lo, hi) of the row; none in a halo row
    const int lo = img ? d.col_off * upp : urow;
    const int hi = img ? (d.col_off + d.w) * upp : urow;
    uint4* out = reinterpret_cast<uint4*>(d.dst) + (size_t)r * urow;
    for (int u = lane; u < lo; u += 32) out[u] = pad;
    for (int u = hi + lane; u < urow; u += 32) out[u] = pad;
  }
}

}  // namespace
