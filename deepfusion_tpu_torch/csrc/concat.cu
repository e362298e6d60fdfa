// concat_relu_kernel<DT>: NHWC channel concat with an optional true ReLU.
//
// Replaces deepfusion_tpu/ops/concat.py:_concat_kernel (launcher
// _concat_call).
//
// Launched by the registered op deepfusion_torch::concat_relu
// (torch_ops.cpp) through concat_relu_launch (concat.h).
//
// What bounds it on the H100: device-memory bytes. Every element is read
// once and written once, so the floor is 2 x output bytes / 3.35 TB/s.
//
// Design. The TPU kernel makes one full-width store per tile, because
// per-source partial-lane stores stalled its write pipeline
// (concat.py:61-75). Here a block owns a tile of whole output pixel rows
// and streams it: thread (tx, ty) holds output column tx (a 16-byte unit;
// its input found once by a binary search over the inputs' column table)
// and pixels ty, ty + by, ... of the tile. It loads its units straight
// from the input (UNROLL loads in flight), applies the ReLU on 32-bit
// words (relu_word<DT>) and stores them. With bx = the row's units (up to
// the block), consecutive threads hold consecutive columns, so every warp
// stores consecutive addresses, the tile leaves as one contiguous run, and
// a warp's loads of one input are the input's contiguous units. No
// integer divide per unit.
// The input table (pointer, units, first column: 16 bytes an input, 2 KB
// for CONCAT_MAX_IN) is a __grid_constant__ parameter, so any count up to
// CONCAT_MAX_IN takes one launch; more launch once per group, each writing
// its columns of every output row. A row wider than the block loops over
// its columns.
//
// A version that staged each input's slice of the tile in shared memory
// first, then stored the tile from there (16-byte loads, or 1-D bulk
// copies on an mbarrier), ran its block's phases one after the other and
// was slower at FusionNet's branch merge (PERF.md §6, K2; the variants
// lived in tools/stage_variants/concat_staged.cu until commit c5dd817).
//
// ConcatConfig's legality (channels divisible by 16 for 1-byte types, by 4
// for 4-byte types) makes every input row a multiple of 16 bytes, and the
// op hands in 16-byte-aligned tensors, so no unit straddles two inputs.
// ReLU is true ReLU per dtype; the reference's lane quirks Q1/Q2
// (deepfusion_tpu/ops/ref.py:23-27) are not reproduced.
#include <cuda_runtime.h>

#include <cstdint>

#include "concat.h"
#include "requant.cuh"

namespace {

constexpr int NT = 256;
constexpr int UNROLL = 4;  // loads in flight per thread: pixels of a tile
                           // per row of threads

struct ConcatIn {
  const uint4* src;  // 16-byte aligned, pixel rows contiguous
  int units;         // 16-byte units per pixel row
  int col;           // first unit of the input in the group's columns
};

struct ConcatArgs {
  ConcatIn in[CONCAT_MAX_IN];
  int n_in;
  int out_units;  // units per output pixel row: the output's row stride
  int col0;       // the group's first unit in the output row
  int width;      // the group's units per pixel row
  int pixels;
  int tile_px;    // pixels of a tile
  uint4* dst;
};

template <int DT>
__device__ __forceinline__ uint32_t relu_word(uint32_t w) {
  if constexpr (DT == DT_S8) {
    return __vmaxs4(w, 0u);
  } else if constexpr (DT == DT_S32) {
    return static_cast<int32_t>(w) < 0 ? 0u : w;
  } else if constexpr (DT == DT_F32) {
    return __float_as_uint(relu_f32(__uint_as_float(w)));
  } else {
    return w;  // u8: ReLU is the identity
  }
}

// one block per tile of tile_px pixels; concat_relu_launch refuses
// pixels * out_units >= 2^31, so every unit index fits an int
template <int DT>
__global__ void __launch_bounds__(NT)
    concat_relu_kernel(const __grid_constant__ ConcatArgs a, int relu) {
  __shared__ const uint4* s_src[CONCAT_MAX_IN];
  __shared__ int s_col[CONCAT_MAX_IN], s_end[CONCAT_MAX_IN];
  const int tid = threadIdx.x;
  // a warp reads one entry of the table at a time: the parameter lives in
  // the constant bank, which serializes a warp's reads of distinct
  // addresses
  for (int i = tid >> 5; i < a.n_in; i += NT / 32) {
    const ConcatIn in = a.in[i];
    if ((tid & 31) == 0) {
      s_src[i] = in.src;
      s_col[i] = in.col;
      s_end[i] = in.col + in.units;
    }
  }
  __syncthreads();
  const int pix0 = blockIdx.x * a.tile_px;
  const int pt = min(a.tile_px, a.pixels - pix0);
  const int bx = min(a.width, NT), by = NT / bx;
  const int tx = tid % bx, ty = tid / bx;
  if (ty >= by) return;
  for (int c = tx; c < a.width; c += bx) {
    int lo = 0, hi = a.n_in - 1;  // the input holding column c
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (s_end[mid] > c) hi = mid;
      else lo = mid + 1;
    }
    const int w = s_end[lo] - s_col[lo];
    const uint4* s = s_src[lo] + pix0 * w + (c - s_col[lo]);
    uint4* d = a.dst + pix0 * a.out_units + a.col0 + c;
    for (int p0 = ty; p0 < pt; p0 += UNROLL * by) {
      uint4 v[UNROLL];
#pragma unroll
      for (int k = 0; k < UNROLL; ++k) {
        const int p = p0 + k * by;
        if (p < pt) v[k] = __ldg(s + p * w);
      }
#pragma unroll
      for (int k = 0; k < UNROLL; ++k) {
        const int p = p0 + k * by;
        if (p >= pt) break;
        if (relu) {
          v[k].x = relu_word<DT>(v[k].x);
          v[k].y = relu_word<DT>(v[k].y);
          v[k].z = relu_word<DT>(v[k].z);
          v[k].w = relu_word<DT>(v[k].w);
        }
        d[p * a.out_units] = v[k];
      }
    }
  }
}

template <int DT>
cudaError_t launch(const ConcatArgs& a, int relu, long long tiles,
                   cudaStream_t s) {
  concat_relu_kernel<DT><<<(unsigned)tiles, NT, 0, s>>>(a, relu);
  return cudaGetLastError();
}

}  // namespace

cudaError_t concat_relu_launch(const void* const* srcs, const int* row_bytes,
                               int n_in, void* dst, long long pixels,
                               bool relu, int dt, cudaStream_t s,
                               int* launches) {
  *launches = 0;
  if (n_in < 1) return cudaErrorInvalidValue;
  if (dt != DT_F32 && dt != DT_S32 && dt != DT_S8 && dt != DT_U8)
    return cudaErrorInvalidValue;
  long long out_units = 0;
  for (int i = 0; i < n_in; ++i) {
    if (row_bytes[i] < 0 || row_bytes[i] % 16) return cudaErrorInvalidValue;
    out_units += row_bytes[i] / 16;
  }
  const long long total = pixels * out_units;
  if (total >= (1LL << 31)) return cudaErrorInvalidValue;
  if (total == 0) return cudaSuccess;
  const int r = relu ? 1 : 0;
  // one launch per group of up to CONCAT_MAX_IN inputs, each writing the
  // group's columns of every output row
  int col0 = 0;
  for (int g0 = 0; g0 < n_in; g0 += CONCAT_MAX_IN) {
    const int n = n_in - g0 < CONCAT_MAX_IN ? n_in - g0 : CONCAT_MAX_IN;
    ConcatArgs a;
    a.n_in = n;
    a.out_units = (int)out_units;
    a.col0 = col0;
    a.pixels = (int)pixels;
    a.dst = static_cast<uint4*>(dst);
    int width = 0;
    for (int i = 0; i < n; ++i) {
      a.in[i].src = static_cast<const uint4*>(srcs[g0 + i]);
      a.in[i].units = row_bytes[g0 + i] / 16;
      a.in[i].col = width;
      width += a.in[i].units;
    }
    col0 += width;
    if (width == 0) continue;
    a.width = width;
    // a tile: UNROLL pixels for each row of threads
    a.tile_px = (width < NT ? NT / width : 1) * UNROLL;
    const long long tiles = (pixels + a.tile_px - 1) / a.tile_px;
    cudaError_t rc;
    switch (dt) {
      case DT_F32: rc = launch<DT_F32>(a, r, tiles, s); break;
      case DT_S32: rc = launch<DT_S32>(a, r, tiles, s); break;
      case DT_S8: rc = launch<DT_S8>(a, r, tiles, s); break;
      default: rc = launch<DT_U8>(a, r, tiles, s); break;
    }
    ++*launches;
    if (rc != cudaSuccess) return rc;
  }
  return cudaSuccess;
}
