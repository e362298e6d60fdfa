// Requantization epilogue as device functions, shared by the kernels.
//
// The same chain as deepfusion_tpu/ops/requant.py (requant, and
// requant_to_u8_centered without the -128 centering) and as the plain
// PyTorch version in deepfusion_tpu_torch/ops/requant.py:
//
//   f32(acc) -> +bias -> *scale -> ReLU (forced for u8) -> round -> saturate
//
// Every step is one correctly rounded IEEE operation, so the result is
// bitwise that of the JAX package as long as nothing is contracted or
// approximated: the library is compiled with --fmad=false, the adds and
// multiplies are spelled __fadd_rn/__fmul_rn anyway, int->f32 is
// __int2float_rn, rounding is rintf (half to even) or floorf, and every
// float->int conversion is clamped first. The f32->s32 saturation is an
// explicit clamp to [INT_MIN, INT_MAX], as the JAX kernels saturate
// (ROADMAP finding C1: a plain convert would wrap to INT_MIN).
//
// The eltwise-sum post-op joins after rounding, in the exact integer domain
// (deepfusion_tpu/ops/requant.py:72-84): for an integer dst
// round(x) + round(sum * sum_scale), then ReLU, then saturate; for an f32
// dst an f32 add, then ReLU. The operand widens exactly from u8/s8 and
// converts with __int2float_rn from s32.
//
// requant_u8 and requant_int do the same in the integer domain for a 1-byte
// dst: one conversion a value (the accumulator's), rounding by an add of
// 1.5 * 2^23, the sum join, ReLU and saturation as integer operations;
// requant_u8_small without that conversion, for accumulators below 2^22.
#pragma once

#include <climits>
#include <cstdint>

#include "dtypes.h"

template <int DT> struct dt_traits;
template <> struct dt_traits<DT_F32> { using T = float; };
template <> struct dt_traits<DT_S32> { using T = int32_t; };
template <> struct dt_traits<DT_S8> { using T = int8_t; };
template <> struct dt_traits<DT_U8> { using T = uint8_t; };

// ReLU as jnp.maximum(x, 0.0) computes it: -0.0 becomes +0.0, NaN stays NaN.
__device__ __forceinline__ float relu_f32(float x) {
  return x <= 0.0f ? 0.0f : x;
}

__device__ __forceinline__ float round_f32(float x, bool down) {
  return down ? floorf(x) : rintf(x);
}

// f32 holding an integral value -> saturated integer of the dst type.
template <int DT>
__device__ __forceinline__ typename dt_traits<DT>::T saturate(float x) {
  if constexpr (DT == DT_F32) {
    return x;
  } else if constexpr (DT == DT_S32) {
    if (x >= 2147483648.0f) return INT_MAX;
    if (x <= -2147483648.0f) return INT_MIN;
    return static_cast<int32_t>(x);
  } else if constexpr (DT == DT_S8) {
    x = fminf(fmaxf(x, -128.0f), 127.0f);
    return static_cast<int8_t>(static_cast<int32_t>(x));
  } else {
    x = fminf(fmaxf(x, 0.0f), 255.0f);
    return static_cast<uint8_t>(static_cast<int32_t>(x));
  }
}

// f32(acc) [+ bias] * scale
__device__ __forceinline__ float scale_acc(int32_t acc, bool has_bias,
                                           float bias, float scale) {
  float x = __int2float_rn(acc);
  if (has_bias) x = __fadd_rn(x, bias);
  return __fmul_rn(x, scale);
}

// The full epilogue (deepfusion_tpu/ops/requant.py:requant without sum).
template <int DT>
__device__ __forceinline__ typename dt_traits<DT>::T requant(
    int32_t acc, bool has_bias, float bias, float scale, bool relu,
    bool down) {
  float x = scale_acc(acc, has_bias, bias, scale);
  if (relu || DT == DT_U8) x = relu_f32(x);
  if constexpr (DT == DT_F32) {
    return x;
  } else {
    return saturate<DT>(round_f32(x, down));
  }
}

// One element of the sum operand, times sum_scale: f32(src[idx]) * scale.
__device__ __forceinline__ float load_sum(const void* src, size_t idx,
                                          int dt, float scale) {
  float v;
  if (dt == DT_U8)
    v = __int2float_rn(static_cast<const uint8_t*>(src)[idx]);
  else if (dt == DT_S8)
    v = __int2float_rn(static_cast<const int8_t*>(src)[idx]);
  else if (dt == DT_S32)
    v = __int2float_rn(static_cast<const int32_t*>(src)[idx]);
  else
    v = static_cast<const float*>(src)[idx];
  return __fmul_rn(v, scale);
}

// requant with the sum post-op: the f32 value before the final cast,
// already clipped to the dst's range (integral for integer dsts)
// (deepfusion_tpu/ops/convpool.py:_requant_presat).
template <int DT>
__device__ __forceinline__ float requant_presat(int32_t acc, bool has_bias,
                                                float bias, float scale,
                                                bool relu, bool down,
                                                bool has_sum, float st) {
  float x = scale_acc(acc, has_bias, bias, scale);
  relu = relu || DT == DT_U8;
  if (has_sum && DT != DT_F32) {
    x = __fadd_rn(round_f32(x, down), round_f32(st, down));
    if (relu) x = relu_f32(x);
  } else {
    if (has_sum) x = __fadd_rn(x, st);
    if (relu) x = relu_f32(x);
    if (DT != DT_F32) x = round_f32(x, down);
  }
  if constexpr (DT == DT_S32) {
    x = fminf(fmaxf(x, -2147483648.0f), 2147483648.0f);
  } else if constexpr (DT == DT_S8) {
    x = fminf(fmaxf(x, -128.0f), 127.0f);
  } else if constexpr (DT == DT_U8) {
    x = fminf(fmaxf(x, 0.0f), 255.0f);
  }
  return x;
}

// The full epilogue with the sum post-op (requant(..., sum_term=)).
template <int DT>
__device__ __forceinline__ typename dt_traits<DT>::T requant_sum(
    int32_t acc, bool has_bias, float bias, float scale, bool relu,
    bool down, float st) {
  return saturate<DT>(
      requant_presat<DT>(acc, has_bias, bias, scale, relu, down, true, st));
}

// The fused path's intermediate: always ReLU, always u8
// (deepfusion_tpu/ops/requant.py:requant_to_u8_centered, uncentered).
__device__ __forceinline__ uint8_t requant_to_u8(int32_t acc, bool has_bias,
                                                 float bias, float scale,
                                                 bool down) {
  return requant<DT_U8>(acc, has_bias, bias, scale, true, down);
}

// requant_to_u8 (with a bias; a missing one is +0.0, which changes no f32
// value of an integer) in one conversion instead of three: ReLU, then
// adding 1.5 * 2^23 rounds to an integer (half to even, or down with
// __fadd_rd) exactly below 2^22, where the sum's low mantissa bits hold the
// integer; from 2^22 on the sum's bits exceed 255 and the clamp saturates,
// as it must. Bitwise requant_to_u8, and so requant<DT_U8>, for every int32
// acc and finite bias and scale. With plus (0..255) it is the saturating sum
// min(requant_to_u8 + plus, 255), in the same clamp: the integer before the
// clamp is never negative.
__device__ __forceinline__ uint32_t requant_u8(int32_t acc, float bias,
                                               float scale, bool down,
                                               int plus = 0) {
  const float x =
      fmaxf(__fmul_rn(__fadd_rn(__int2float_rn(acc), bias), scale), 0.0f);
  const float y = down ? __fadd_rd(x, 12582912.0f) : __fadd_rn(x, 12582912.0f);
  return uint32_t(min(int(__float_as_uint(y)) - 0x4B400000 + plus, 255));
}

// 1.5 * 2^23 and its bits: for |x| <= 2^22, x + MAGIC lies in [2^23, 2^24],
// where the f32 grid is the integers (2^24 itself is one), so the one
// correctly rounded add rounds x to an integer, half to even (MAGIC is
// even) or down with __fadd_rd, and the sum's bits less MAGIC_BITS are
// that integer.
constexpr float MAGIC = 12582912.0f;
constexpr int MAGIC_BITS = 0x4B400000;

__device__ __forceinline__ int magic_round(float x, bool down) {
  return __float_as_int(down ? __fadd_rd(x, MAGIC) : __fadd_rn(x, MAGIC)) -
         MAGIC_BITS;
}

// The largest |sum_scale| at which requant_int is bitwise requant_sum.
constexpr float INT_SUM_SCALE_MAX = 8192.0f;

// The final stage's requant into a 1-byte dst in the integer domain:
// requant<DT> (without a sum), or requant_sum<DT> with a 1-byte sum operand
// whose byte, u8 or s8, is v (widened: -128..255), at sum_scale. Bitwise
// theirs for every int32 acc and finite bias and scale, and with a sum for
// |sum_scale| <= INT_SUM_SCALE_MAX:
//  * x = (f32(acc) + bias) * scale, as scale_acc: the one conversion.
//  * v widens to f32 exactly from its bits, v + MAGIC_BITS being the bits
//    of MAGIC + v; st = f32(v) * sum_scale as load_sum.
//  * x is clamped to +-C, C = 2^21, and C, st (|st| <= 255 * 8192 < 2^21)
//    round exactly by magic_round: R = round(st), |R| <= S = 255 * 8192.
//  * |x| <= C: round(x) + R is an integer of magnitude below 2^22, exact in
//    f32 as in int32, so the old path's f32 join equals the integer add,
//    and ReLU then the clamp to [lo, hi] is one integer min/max.
//  * x > C (+inf too): the old path's round(x) >= C, so its join is at
//    least C - S (rounding is monotone, C - S an f32 integer); here C + R
//    >= C - S too. C - S = 8192 > 255, so both saturate to hi. x < -C
//    likewise to lo (or 0 with ReLU), since -C + S < -128.
// That holds while S <= 2^21 - 255, |sum_scale| <= 8223.1; the bound is
// the power of two below. A larger sum_scale keeps requant_sum (the kernel
// chooses per call: conv.cu, int_sum). Without a sum R = 0.
template <int DT>
__device__ __forceinline__ typename dt_traits<DT>::T requant_int(
    int32_t acc, float bias, float scale, bool relu, bool down,
    bool has_sum, int v, float sum_scale) {
  const float x = __fmul_rn(__fadd_rn(__int2float_rn(acc), bias), scale);
  int r = magic_round(fminf(fmaxf(x, -2097152.0f), 2097152.0f), down);
  if (has_sum)
    r += magic_round(
        __fmul_rn(__fsub_rn(__int_as_float(v + MAGIC_BITS), MAGIC), sum_scale),
        down);
  const int lo = relu || DT == DT_U8 ? 0 : -128;
  return typename dt_traits<DT>::T(min(max(r, lo), DT == DT_U8 ? 255 : 127));
}

// A 1-byte sum operand's byte b as requant_int takes it: s8 if s8, else
// u8, widened by integer operations alone.
__device__ __forceinline__ int sum_byte(uint32_t b, bool s8) {
  return s8 ? int(b ^ 0x80u) - 0x80 : int(b);
}

// requant_u8 for |acc| < 2^22 without the conversion unit (the depthwise
// conv's accumulators: at most 9 * 255 * 128): MAGIC_BITS + acc are the bits
// of MAGIC + acc, an integer of [2^23, 2^24), where the f32 grid is the
// integers, so less MAGIC it is f32(acc) exactly. Bitwise requant_u8 there.
// Rounds half to even.
__device__ __forceinline__ uint32_t requant_u8_small(int32_t acc, float bias,
                                                     float scale) {
  const float a = __fsub_rn(__int_as_float(acc + MAGIC_BITS), MAGIC);
  const float x = fmaxf(__fmul_rn(__fadd_rn(a, bias), scale), 0.0f);
  return uint32_t(min(magic_round(x, false), 255));
}
