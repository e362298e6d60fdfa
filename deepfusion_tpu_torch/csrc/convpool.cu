// convpool_kernel<DST>: INT8 convolution, requantization (+ the eltwise-sum
// post-op) and a 2x2/s2 max or average pool in one kernel; the conv output
// never reaches device memory.
//
// Replaces deepfusion_tpu/ops/convpool.py:_convpool_kernel (launcher
// _convpool_call).
//
// What it computes, per pooled pixel (n, py, px) and channel o, with the
// four conv pixels (2py + dy, 2px + dx) of its window:
//   x_dydx = requant_presat(acc0 [, sum at the conv pixel]): f32 clipped to
//            the dst's range, integral for integer dsts (requant.cuh)
//   max:   y = max(max(x00, x01), max(x10, x11))
//   avg:   y = (((x00 + x01) + x10) + x11) * 0.25f, rounded with the pool's
//          round mode for integer dsts (f32 adds in that order)
//   dst = saturate(y), the one cast
// This is bitwise _requant_presat + the pool + saturate_to of the JAX
// kernel: max commutes with the monotone saturation, and an integer dst's
// four values are integers below 2^24, so their f32 sum is exact.
//
// What bounds it on the H100: int8 multiply-adds, as for every conv
// (ResFusionNet's downsample conv is 1.2 G MAC at batch 8); it writes a
// quarter of the conv's output bytes.
//
// Design: the mma.sync K loop of conv_common.cuh (conv_pass) with M
// ordered so that the four pixels of a window are four consecutive
// rows: M row 4q + e of a block is conv pixel (dy, dx) = (e >> 1, e & 1) of
// the block's q-th window. Stride and padding stay in the copy's
// addressing. In an mma.sync accumulator fragment, thread lane = 4g + t
// holds rows g and g + 8, so a window's four rows sit in the lanes 4g + t
// with the same g >> 2 and t, which differ in lane bits 2 and 3. A max, or
// the sum of an integer dst's four integral values (exact in any order),
// is two xor-shuffles; an f32 average gathers x00..x11 with four shuffles
// and adds them in the JAX order. The lane with e = 0 stores.
#include <cuda_runtime.h>

#include <cstdint>

#include "conv_common.cuh"

namespace {

struct PoolArgs {
  int avg;   // 0: max, 1: average
  int down;  // the pool's round mode for an integer average: floor
};

// Pool the warp's tile (channels n0 + [0, nb)) and store it. With SUM each
// conv value first joins the sum operand's element at its conv pixel, which
// s_sum holds per M row. The caller picks SUM with one uniform branch.
template <int DST, bool SUM>
__device__ __forceinline__ void pool_store(const ConvArgs& a,
                                           const PoolArgs& pa,
                                           const int32_t (&acc)[MI][NI][4],
                                           const int* s_sum, long long q0,
                                           int n0, int ntiles) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3, e = g & 3;
  const int wr = warp / a.wc, wc = warp % a.wc;
  const long long windows = (long long)a.n * (a.oh / 2) * (a.ow / 2);
  const int src_lane = lane & ~12;  // lane of this window's e = 0 row
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni) {
      if (ni >= ntiles) continue;  // warp-uniform
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int p = wr * 32 + mi * 16 + g + (r >> 1) * 8;
        const int o = n0 + wc * 64 + ni * 8 + 2 * t + (r & 1);
        const long long q = q0 + p / 4;
        // the same for the four lanes of a window
        const bool valid = q < windows && o < a.oc0;
        float x = 0.0f;
        if (valid) {
          float st = 0.0f;
          if constexpr (SUM)
            st = load_sum(a.sum, (size_t)s_sum[p] * a.oc0 + o, a.sum_dt,
                          a.sum_scale);
          x = requant_presat<DST>(acc[mi][ni][r], a.has_bias0, a.bias0[o],
                                  a.scale0[o], a.relu0, a.down0, SUM, st);
        }
        float y;
        if (!pa.avg) {
          y = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 4));
          y = fmaxf(y, __shfl_xor_sync(0xffffffffu, y, 8));
        } else if (DST == DT_F32) {
          const float x00 = __shfl_sync(0xffffffffu, x, src_lane);
          const float x01 = __shfl_sync(0xffffffffu, x, src_lane | 4);
          const float x10 = __shfl_sync(0xffffffffu, x, src_lane | 8);
          const float x11 = __shfl_sync(0xffffffffu, x, src_lane | 12);
          y = __fmul_rn(__fadd_rn(__fadd_rn(__fadd_rn(x00, x01), x10), x11),
                        0.25f);
        } else {
          y = __fadd_rn(x, __shfl_xor_sync(0xffffffffu, x, 4));
          y = __fadd_rn(y, __shfl_xor_sync(0xffffffffu, y, 8));
          y = round_f32(__fmul_rn(y, 0.25f), pa.down);
        }
        if (valid && e == 0)
          store_out<DST>(a.dst, (size_t)q * a.oc0 + o, saturate<DST>(y));
      }
    }
}

template <int DST>
__global__ void __launch_bounds__(NT, 2) convpool_kernel(ConvArgs a,
                                                         PoolArgs pa) {
  extern __shared__ __align__(16) uint32_t smem[];
  const Smem L(a);
  uint32_t* s_in[2] = {smem, smem + L.in_words};
  uint32_t* s_w[2] = {smem + 2 * L.in_words,
                      smem + 2 * L.in_words + L.w_words};
  int* s_pix = reinterpret_cast<int*>(smem + 2 * (L.in_words + L.w_words));
  int* s_sum = s_pix + 3 * L.m;  // conv pixel (n * oh + y) * ow + x per row

  const int tid = threadIdx.x;
  const int wc = (tid >> 5) % a.wc;
  const int ph2 = a.oh / 2, pw2 = a.ow / 2;
  const long long windows = (long long)a.n * ph2 * pw2;
  const long long q0 = (long long)blockIdx.x * (L.m / 4);

  for (int p = tid; p < L.m; p += NT) {
    const long long q = q0 + p / 4;
    int nn = -1, y0 = 0, x0 = 0, cp = 0;
    if (q < windows) {
      const int px = int(q % pw2);
      const long long r = q / pw2;
      const int py = int(r % ph2);
      nn = int(r / ph2);
      const int cy = 2 * py + ((p & 3) >> 1), cx = 2 * px + (p & 1);
      y0 = cy * a.sh - a.ph;
      x0 = cx * a.sw - a.pw;
      cp = (nn * a.oh + cy) * a.ow + cx;
    }
    s_pix[3 * p] = nn;
    s_pix[3 * p + 1] = y0;
    s_pix[3 * p + 2] = x0;
    s_sum[p] = cp;
  }
  __syncthreads();

  int32_t acc[MI][NI][4];
  for (int n0 = 0; n0 < a.oc0p; n0 += L.nb) {
    const int nbv = min(L.nb, a.oc0p - n0);   // valid columns of the pass
    const int ntiles = min(NI, max(0, (nbv - wc * 64) / 8));
    conv_pass(a, L, s_in, s_w, s_pix, n0, nbv, ntiles, acc);
    if (a.sum)
      pool_store<DST, true>(a, pa, acc, s_sum, q0, n0, ntiles);
    else
      pool_store<DST, false>(a, pa, acc, s_sum, q0, n0, ntiles);
  }
}

template <int DST>
int launch(const ConvArgs& a, const PoolArgs& pa, cudaStream_t stream) {
  const Smem L(a);
  const size_t smem = L.bytes(false) + 4 * (size_t)L.m;  // + s_sum
  if (int e = allow_smem(convpool_kernel<DST>, smem)) return e;
  const long long windows = (long long)a.n * (a.oh / 2) * (a.ow / 2);
  const int per_block = L.m / 4;
  const unsigned blocks = (unsigned)((windows + per_block - 1) / per_block);
  convpool_kernel<DST><<<blocks, NT, smem, stream>>>(a, pa);
  return (int)cudaGetLastError();
}

}  // namespace

// dst: NHWC (n, oh / 2, ow / 2, oc0) of dst_dt; sum: null, or the NHWC
// (n, oh, ow, oc0) sum operand of sum_dt; avg with an s32 dst is refused,
// as pool2_fusable refuses it.
extern "C" int df_convpool(const void* src, const void* w0, const void* bias0,
                           const void* scale0, void* dst, const void* sum,
                           int n, int ih, int iw, int ic, int oh, int ow,
                           int kh, int kw, int sh, int sw, int ph, int pw,
                           int oc0, int oc0p, int relu0, int down0,
                           int has_bias0, int dst_dt, int sum_dt, int avg,
                           int pool_down, float sum_scale, void* stream) {
  if (ic % 16 || oc0p % 8 || oc0p <= 0 || oh % 2 || ow % 2 ||
      (avg && dst_dt == DT_S32) || (long long)n * oh * ow > INT32_MAX)
    return (int)cudaErrorInvalidValue;
  if (sum && sum_dt != DT_F32 && sum_dt != DT_S32 && sum_dt != DT_S8 &&
      sum_dt != DT_U8)
    return (int)cudaErrorInvalidValue;
  ConvArgs a = {};
  a.src = static_cast<const uint8_t*>(src);
  a.w0 = static_cast<const int32_t*>(w0);
  a.bias0 = static_cast<const float*>(bias0);
  a.scale0 = static_cast<const float*>(scale0);
  a.dst = dst;
  a.sum = sum;
  a.sum_dt = sum_dt;
  a.sum_scale = sum_scale;
  a.n = n; a.ih = ih; a.iw = iw; a.ic = ic; a.oh = oh; a.ow = ow;
  a.kh = kh; a.kw = kw; a.sh = sh; a.sw = sw; a.ph = ph; a.pw = pw;
  a.oc0 = oc0; a.oc0p = oc0p;
  a.relu0 = relu0; a.down0 = down0; a.has_bias0 = has_bias0;
  pick_tiles(a);
  const PoolArgs pa = {avg, pool_down};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dst_dt) {
    case DT_F32: return launch<DT_F32>(a, pa, s);
    case DT_S32: return launch<DT_S32>(a, pa, s);
    case DT_S8: return launch<DT_S8>(a, pa, s);
    case DT_U8: return launch<DT_U8>(a, pa, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
