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
// Design: one pass. Grid row y copies input y: its threads walk the input's
// 16-byte units in order (contiguous reads), apply the ReLU on 32-bit lanes
// and store each unit at its pixel's row offset in the output. More than
// CONCAT_MAX_IN inputs take one launch per group of that many, each
// writing its group's columns of every output row (the input offsets count
// from the start of the whole row, and the row stride is the whole row). ConcatConfig's
// legality (channels divisible by 16 for
// 1-byte types, by 4 for 4-byte types) makes every input row a multiple of
// 16 bytes, and the wrapper hands in 16-byte-aligned tensors, so no unit
// straddles two inputs. ReLU is true ReLU per dtype; the reference's lane
// quirks Q1/Q2 (deepfusion_tpu/ops/ref.py:23-27) are not reproduced.
#include <cuda_runtime.h>

#include <cstdint>

#include "concat.h"
#include "requant.cuh"

namespace {

constexpr int NT = 256;

struct ConcatArgs {
  const uint4* src[CONCAT_MAX_IN];
  int units[CONCAT_MAX_IN];   // 16-byte units per pixel row of input i
  int offset[CONCAT_MAX_IN];  // first unit of input i in the output row
  int out_units;
  int pixels;
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

// grid: (x blocks, inputs of the group); concat_relu_launch refuses
// pixels * out_units >= 2^31.
template <int DT>
__global__ void __launch_bounds__(NT) concat_relu_kernel(ConcatArgs a,
                                                         int relu) {
  const int i = blockIdx.y;
  const uint4* src = a.src[i];
  const int units = a.units[i];
  const int total = a.pixels * units;
  for (int u = blockIdx.x * NT + threadIdx.x; u < total;
       u += gridDim.x * NT) {
    const int pix = u / units;
    uint4 v = src[u];
    if (relu) {
      v.x = relu_word<DT>(v.x);
      v.y = relu_word<DT>(v.y);
      v.z = relu_word<DT>(v.z);
      v.w = relu_word<DT>(v.w);
    }
    a.dst[pix * a.out_units + a.offset[i] + (u - pix * units)] = v;
  }
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
    if (row_bytes[i] % 16) return cudaErrorInvalidValue;
    out_units += row_bytes[i] / 16;
  }
  const long long total = pixels * out_units;
  if (total >= (1LL << 31)) return cudaErrorInvalidValue;
  if (total == 0) return cudaSuccess;
  const int r = relu ? 1 : 0;
  // one launch per group of up to CONCAT_MAX_IN inputs: each input's
  // offset is its first unit in the whole output row, and every launch
  // strides the output by the whole row
  int base = 0;
  for (int g0 = 0; g0 < n_in; g0 += CONCAT_MAX_IN) {
    const int n = n_in - g0 < CONCAT_MAX_IN ? n_in - g0 : CONCAT_MAX_IN;
    ConcatArgs a;
    a.out_units = (int)out_units;
    a.pixels = (int)pixels;
    a.dst = static_cast<uint4*>(dst);
    int widest = 0;  // enough blocks for the widest input; narrower ones
                     // loop less
    for (int i = 0; i < n; ++i) {
      a.src[i] = static_cast<const uint4*>(srcs[g0 + i]);
      a.units[i] = row_bytes[g0 + i] / 16;
      a.offset[i] = base;
      base += a.units[i];
      widest = a.units[i] > widest ? a.units[i] : widest;
    }
    if (widest == 0) continue;
    long long bx = (pixels * widest + NT - 1) / NT;
    if (bx > 132 * 16) bx = 132 * 16;
    const dim3 grid((unsigned)bx, (unsigned)n);
    switch (dt) {
      case DT_F32: concat_relu_kernel<DT_F32><<<grid, NT, 0, s>>>(a, r); break;
      case DT_S32: concat_relu_kernel<DT_S32><<<grid, NT, 0, s>>>(a, r); break;
      case DT_S8: concat_relu_kernel<DT_S8><<<grid, NT, 0, s>>>(a, r); break;
      default: concat_relu_kernel<DT_U8><<<grid, NT, 0, s>>>(a, r); break;
    }
    ++*launches;
    const cudaError_t rc = cudaGetLastError();
    if (rc != cudaSuccess) return rc;
  }
  return cudaSuccess;
}
