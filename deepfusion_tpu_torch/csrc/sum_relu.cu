// sum_relu_kernel<DT>: elementwise a + b (+ ReLU), saturating for integers.
//
// Replaces deepfusion_tpu/ops/pool.py:_sum_relu_kernel (launcher
// _sum_relu_call).
//
// What bounds it on the H100: device-memory bytes (two reads and one write
// per element, no reuse). Floor: 3 x bytes / 3.35 TB/s.
//
// Design: one pass over 16-byte units, four 32-bit lanes each. u8 and s8
// use the byte-SIMD saturating adds (__vaddus4, __vaddss4) and the byte max
// for the ReLU, so 16 elements cost a handful of instructions; s32 adds in
// int64 and clamps (the same result as the sign identity in the JAX kernel,
// pool.py:231-242); f32 is one __fadd_rn and the jnp.maximum-style ReLU.
// Bytes past the last full unit are done one element at a time.
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "pool.h"
#include "requant.cuh"

namespace {

constexpr int NT = 256;

template <int DT>
__device__ __forceinline__ uint32_t sum_word(uint32_t a, uint32_t b,
                                             int relu) {
  if constexpr (DT == DT_U8) {
    return __vaddus4(a, b);
  } else if constexpr (DT == DT_S8) {
    const uint32_t s = __vaddss4(a, b);
    return relu ? __vmaxs4(s, 0u) : s;
  } else if constexpr (DT == DT_S32) {
    long long s = (long long)static_cast<int32_t>(a) + static_cast<int32_t>(b);
    if (s > INT_MAX) s = INT_MAX;
    if (s < INT_MIN) s = INT_MIN;
    if (relu && s < 0) s = 0;
    return static_cast<uint32_t>(static_cast<int32_t>(s));
  } else {
    float s = __fadd_rn(__uint_as_float(a), __uint_as_float(b));
    if (relu) s = relu_f32(s);
    return __float_as_uint(s);
  }
}

template <int DT>
__device__ __forceinline__ uint8_t sum_byte(uint8_t a, uint8_t b, int relu) {
  if constexpr (DT == DT_U8) {
    const int s = int(a) + int(b);
    return uint8_t(s > 255 ? 255 : s);
  } else {
    int s = int(int8_t(a)) + int(int8_t(b));
    if (relu && s < 0) s = 0;
    s = s > 127 ? 127 : (s < -128 ? -128 : s);
    return uint8_t(int8_t(s));
  }
}

template <int DT>
__global__ void __launch_bounds__(NT) sum_relu_kernel(
    const uint8_t* __restrict__ a, const uint8_t* __restrict__ b,
    uint8_t* __restrict__ out, long long nbytes, int relu) {
  const long long nvec = nbytes / 16;
  const long long stride = (long long)gridDim.x * NT;
  const long long start = blockIdx.x * (long long)NT + threadIdx.x;
  const uint4* a4 = reinterpret_cast<const uint4*>(a);
  const uint4* b4 = reinterpret_cast<const uint4*>(b);
  uint4* o4 = reinterpret_cast<uint4*>(out);
  for (long long v = start; v < nvec; v += stride) {
    const uint4 x = a4[v], y = b4[v];
    uint4 r;
    r.x = sum_word<DT>(x.x, y.x, relu);
    r.y = sum_word<DT>(x.y, y.y, relu);
    r.z = sum_word<DT>(x.z, y.z, relu);
    r.w = sum_word<DT>(x.w, y.w, relu);
    o4[v] = r;
  }
  // tail: fewer than 16 bytes
  constexpr int ES = (DT == DT_U8 || DT == DT_S8) ? 1 : 4;
  const long long tail = nvec * 16 + start * ES;
  if (tail < nbytes) {
    if constexpr (ES == 1) {
      out[tail] = sum_byte<DT>(a[tail], b[tail], relu);
    } else {
      const uint32_t r = sum_word<DT>(
          *reinterpret_cast<const uint32_t*>(a + tail),
          *reinterpret_cast<const uint32_t*>(b + tail), relu);
      *reinterpret_cast<uint32_t*>(out + tail) = r;
    }
  }
}

}  // namespace

cudaError_t sum_relu_launch(const void* a, const void* b, void* out,
                            long long nbytes, bool relu, int dt,
                            cudaStream_t s) {
  if (nbytes == 0) return cudaSuccess;
  long long blocks = (nbytes / 16 + NT - 1) / NT;
  if (blocks < 1) blocks = 1;
  if (blocks > 132 * 32) blocks = 132 * 32;
  const uint8_t* pa = static_cast<const uint8_t*>(a);
  const uint8_t* pb = static_cast<const uint8_t*>(b);
  uint8_t* po = static_cast<uint8_t*>(out);
  const int r = relu ? 1 : 0;
  const unsigned g = (unsigned)blocks;
  switch (dt) {
    case DT_F32: sum_relu_kernel<DT_F32><<<g, NT, 0, s>>>(pa, pb, po, nbytes, r); break;
    case DT_S32: sum_relu_kernel<DT_S32><<<g, NT, 0, s>>>(pa, pb, po, nbytes, r); break;
    case DT_S8: sum_relu_kernel<DT_S8><<<g, NT, 0, s>>>(pa, pb, po, nbytes, r); break;
    case DT_U8: sum_relu_kernel<DT_U8><<<g, NT, 0, s>>>(pa, pb, po, nbytes, r); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}
