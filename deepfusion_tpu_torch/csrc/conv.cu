// conv_fused_kernel<FUSE, DST>: direct INT8 convolution with the
// requantization epilogue and, when FUSE, the deep-fused 1x1 tail.
//
// Replaces deepfusion_tpu/ops/conv.py:_conv_kernel and
// deepfusion_tpu/ops/conv.py:_conv_fused_kernel (launcher _conv_pallas),
// with the eltwise-sum post-op and emit_acc1: with DST = DT_ACC the fused
// kernel stores the raw s32 1x1 accumulator, NHWC (n, oh, ow, oc1), with no
// bias, scale or requant (deepfusion_tpu/ops/conv.py:conv_fused_acc1, the
// tensor-parallel local step).
//
// What it computes, per output pixel p and channel o:
//   acc0[p,o] = sum_{ki,kj,c} src_u8[n, y*sh-ph+ki, x*sw-pw+kj, c] * w0[o,c,ki,kj]
//   (taps outside the image read 0: zero padding is exact in the u8 domain,
//   so there is no -128 shift and no correction term)
//   not fused: dst = requant(acc0 [, sum])
//   fused:     mid = requant_to_u8(acc0); acc1 = mid . w1;
//              dst = requant(acc1 [, sum])
// The optional sum operand is NHWC (n, oh, ow, out_oc) of u8, s8, s32 or
// f32; the final stage's epilogue reads it at the output pixel and joins it
// in the JAX package's order (requant.cuh: requant_sum). Whether there is
// one is a uniform branch around the store loop, and its dtype a switch
// inside it, so it adds no kernel instantiations.
//
// What bounds it on the H100: int8 multiply-adds. At FusionNet's full width
// a forward is about 11 G MACs against a few MB of activations, so once its
// operands sit in shared memory the kernel is bound by the tensor cores and
// by the shared-memory loads that feed them. It multiplies u8 x s8 on the
// tensor cores with mma.sync m16n8k32 (s32 accumulators); wgmma and TMA,
// which the card's full int8 rate needs, are later work.
//
// Design:
// * A block owns M = 32*WR consecutive output pixels (flattened over
//   n, oh, ow) and the output channels in passes of nb = 64*WC <= 512 (one
//   pass for FusionNet), WR*WC = 8 warps. Each warp owns a 32 x 64 tile:
//   2 x 8 mma tiles of s32 accumulators in registers.
// * K streams through shared memory one tap and up to 128 input channels
//   (four mma k-steps) at a time: an M x kcw-word input tile and the
//   matching kcw x nb weight words, copied with cp.async into two buffers so
//   the next chunk loads while this one multiplies. Taps outside the image
//   and channels past ic are zero-filled by the copy itself, so padding
//   and stride are only addressing. Row pitches are padded so the fragment
//   loads are free of bank conflicts.
// * Fused: the u8 intermediate tile (M x oc0p bytes, 16 KB for FusionNet's
//   block2) stays in shared memory and is the A operand of the 1x1 product
//   (w1 streams through shared memory like w0); it never reaches device
//   memory. This is the on-chip residency the TPU kernel keeps in VMEM.
//
// The argument struct, the layouts and the K loop are in conv_common.cuh,
// shared with convpool.cu.
#include <cuda_runtime.h>

#include <cstdint>

#include "conv_common.cuh"

namespace {

// The DST of the fused kernel's raw 1x1 accumulator store (not a dtype code)
constexpr int DT_ACC = 0;

// Store the warp's tile of the raw s32 accumulator: pixels p0 + [0, L.m),
// channels n0 + [0, nb) of oc, NHWC.
__device__ __forceinline__ void store_acc(const ConvArgs& a,
                                          const int32_t (&acc)[MI][NI][4],
                                          long long p0, long long total,
                                          int n0, int oc, int ntiles) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wr = warp / a.wc, wc = warp % a.wc;
  int32_t* dst = static_cast<int32_t*>(a.dst);
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni) {
      if (ni >= ntiles) continue;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const long long gp = p0 + wr * 32 + mi * 16 + g + (r >> 1) * 8;
        const int o = n0 + wc * 64 + ni * 8 + 2 * t + (r & 1);
        if (gp < total && o < oc) dst[(size_t)gp * oc + o] = acc[mi][ni][r];
      }
    }
}

// Requantize the warp's tile of the final stage and store it (with the sum
// operand's element at the same index when SUM): pixels p0 + [0, L.m),
// channels n0 + [0, nb) of oc. The caller picks SUM with one uniform
// branch, so the unrolled loop carries no per-element test.
template <int DST, bool SUM>
__device__ __forceinline__ void store_tile(
    const ConvArgs& a, const int32_t (&acc)[MI][NI][4], long long p0,
    long long total, int n0, int oc, bool has_bias, const float* bias,
    const float* scale, bool relu, bool down, int ntiles) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wr = warp / a.wc, wc = warp % a.wc;
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni) {
      if (ni >= ntiles) continue;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const long long gp = p0 + wr * 32 + mi * 16 + g + (r >> 1) * 8;
        const int o = n0 + wc * 64 + ni * 8 + 2 * t + (r & 1);
        if (gp >= total || o >= oc) continue;
        const size_t idx = (size_t)gp * oc + o;
        if constexpr (SUM)
          store_out<DST>(a.dst, idx,
                         requant_sum<DST>(acc[mi][ni][r], has_bias, bias[o],
                                          scale[o], relu, down,
                                          load_sum(a.sum, idx, a.sum_dt,
                                                   a.sum_scale)));
        else
          store_out<DST>(a.dst, idx,
                         requant<DST>(acc[mi][ni][r], has_bias, bias[o],
                                      scale[o], relu, down));
      }
    }
}

template <int DST>
__device__ __forceinline__ void store_final(
    const ConvArgs& a, const int32_t (&acc)[MI][NI][4], long long p0,
    long long total, int n0, int oc, bool has_bias, const float* bias,
    const float* scale, bool relu, bool down, int ntiles) {
  if constexpr (DST == DT_ACC)
    store_acc(a, acc, p0, total, n0, oc, ntiles);
  else if (a.sum)
    store_tile<DST, true>(a, acc, p0, total, n0, oc, has_bias, bias, scale,
                          relu, down, ntiles);
  else
    store_tile<DST, false>(a, acc, p0, total, n0, oc, has_bias, bias, scale,
                           relu, down, ntiles);
}

template <bool FUSE, int DST>
__global__ void __launch_bounds__(NT, 2) conv_fused_kernel(ConvArgs a) {
  extern __shared__ __align__(16) uint32_t smem[];
  const Smem L(a);
  uint32_t* s_in[2] = {smem, smem + L.in_words};
  uint32_t* s_w[2] = {smem + 2 * L.in_words,
                      smem + 2 * L.in_words + L.w_words};
  int* s_pix = reinterpret_cast<int*>(smem + 2 * (L.in_words + L.w_words));
  uint32_t* s_mid = reinterpret_cast<uint32_t*>(s_pix + 3 * L.m);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wr = warp / a.wc, wc = warp % a.wc;  // this warp's 32 x 64 tile
  const long long total = (long long)a.n * a.oh * a.ow;
  const long long p0 = (long long)blockIdx.x * L.m;

  for (int p = tid; p < L.m; p += NT) {
    const long long gp = p0 + p;
    int nn = -1, y0 = 0, x0 = 0;
    if (gp < total) {
      const int ox = int(gp % a.ow);
      const long long q = gp / a.ow;
      const int oy = int(q % a.oh);
      nn = int(q / a.oh);
      y0 = oy * a.sh - a.ph;
      x0 = ox * a.sw - a.pw;
    }
    s_pix[3 * p] = nn;
    s_pix[3 * p + 1] = y0;
    s_pix[3 * p + 2] = x0;
  }
  if (FUSE) {  // channels [oc0, k1) of the intermediate stay 0
    for (size_t e = tid; e < L.mid_words; e += NT) s_mid[e] = 0u;
  }
  __syncthreads();

  int32_t acc[MI][NI][4];

  for (int n0 = 0; n0 < a.oc0p; n0 += L.nb) {
    const int nbv = min(L.nb, a.oc0p - n0);   // valid columns of the pass
    const int ntiles = min(NI, max(0, (nbv - wc * 64) / 8));
    conv_pass(a, L, s_in, s_w, s_pix, n0, nbv, ntiles, acc);

    if constexpr (FUSE) {
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int ni = 0; ni < NI; ++ni) {
          if (ni >= ntiles) continue;
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int p = wr * 32 + mi * 16 + g + (r >> 1) * 8;
            const int o = n0 + wc * 64 + ni * 8 + 2 * t + (r & 1);
            if (o < a.oc0)
              reinterpret_cast<uint8_t*>(s_mid)[(size_t)p * L.ldm * 4 + o] =
                  requant_to_u8(acc[mi][ni][r], a.has_bias0, a.bias0[o],
                                a.scale0[o], a.down0);
          }
        }
    } else {
      store_final<DST>(a, acc, p0, total, n0, a.oc0, a.has_bias0, a.bias0,
                       a.scale0, a.relu0, a.down0, ntiles);
    }
  }

  if constexpr (FUSE) {
    // 1x1 tail: A = the u8 tile in shared memory, B = w1 words streamed
    // through shared memory 32 K-words at a time, double-buffered
    const int k1w = a.k1 / 4;
    const int nk = (k1w + KCW - 1) / KCW;
    __syncthreads();  // the intermediate is complete
    for (int n0 = 0; n0 < a.oc1p; n0 += L.nb) {
      const int nbv = min(L.nb, a.oc1p - n0);
      const int ntiles = min(NI, max(0, (nbv - wc * 64) / 8));
      auto issue = [&](int c, int b) {
        issue_rows(s_w[b], L.ldw, a.w1 + (size_t)c * KCW * a.oc1p + n0,
                   a.oc1p, min(KCW, k1w - c * KCW), nbv, warp, lane);
        cp_async_commit();
      };
      zero(acc);
      issue(0, 0);
      for (int c = 0; c < nk; ++c) {
        if (c + 1 < nk) {
          issue(c + 1, (c + 1) & 1);
          cp_async_wait<1>();
        } else {
          cp_async_wait<0>();
        }
        __syncthreads();
        mma_chunk(acc, s_mid + wr * 32 * L.ldm + c * KCW, L.ldm,
                  s_w[c & 1] + wc * 64, L.ldw, min(KCW, k1w - c * KCW) / 8,
                  ntiles, g, t);
        __syncthreads();
      }
      store_final<DST>(a, acc, p0, total, n0, a.oc1, a.has_bias1, a.bias1,
                       a.scale1, a.relu1, a.down1, ntiles);
    }
  }
}

template <bool FUSE, int DST>
int launch(const ConvArgs& a, cudaStream_t stream) {
  const Smem L(a);
  const size_t smem = L.bytes(FUSE);
  if (int e = allow_smem(conv_fused_kernel<FUSE, DST>, smem)) return e;
  const long long total = (long long)a.n * a.oh * a.ow;
  const unsigned blocks = (unsigned)((total + L.m - 1) / L.m);
  conv_fused_kernel<FUSE, DST><<<blocks, NT, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <bool FUSE>
int launch_dst(const ConvArgs& a, int dst_dt, cudaStream_t stream) {
  switch (dst_dt) {
    case DT_ACC:
      if constexpr (FUSE) return launch<true, DT_ACC>(a, stream);
      return (int)cudaErrorInvalidValue;
    case DT_F32: return launch<FUSE, DT_F32>(a, stream);
    case DT_S32: return launch<FUSE, DT_S32>(a, stream);
    case DT_S8: return launch<FUSE, DT_S8>(a, stream);
    case DT_U8: return launch<FUSE, DT_U8>(a, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// sum: null, or the NHWC sum operand of sum_dt (the dst dtype codes).
// dst_dt 0 (fused only): dst is the raw s32 1x1 accumulator, (n, oh, ow,
// oc1) int32, and bias1, scale1, relu1, down1 and sum are not read.
extern "C" int df_conv(const void* src, const void* w0, const void* bias0,
                       const void* scale0, const void* w1, const void* bias1,
                       const void* scale1, void* dst, const void* sum, int n,
                       int ih, int iw, int ic, int oh, int ow, int kh, int kw,
                       int sh, int sw, int ph, int pw, int oc0, int oc0p,
                       int oc1, int oc1p, int relu0, int relu1, int down0,
                       int down1, int has_bias0, int has_bias1, int fuse,
                       int dst_dt, int sum_dt, float sum_scale,
                       void* stream) {
  if (ic % 16 || oc0p % 8 || oc0p <= 0 || (fuse && (oc1p % 8 || oc1p <= 0)))
    return (int)cudaErrorInvalidValue;
  if (dst_dt == DT_ACC && (!fuse || sum)) return (int)cudaErrorInvalidValue;
  if (sum && sum_dt != DT_F32 && sum_dt != DT_S32 && sum_dt != DT_S8 &&
      sum_dt != DT_U8)
    return (int)cudaErrorInvalidValue;
  ConvArgs a;
  a.src = static_cast<const uint8_t*>(src);
  a.w0 = static_cast<const int32_t*>(w0);
  a.bias0 = static_cast<const float*>(bias0);
  a.scale0 = static_cast<const float*>(scale0);
  a.w1 = static_cast<const int32_t*>(w1);
  a.bias1 = static_cast<const float*>(bias1);
  a.scale1 = static_cast<const float*>(scale1);
  a.dst = dst;
  a.sum = sum;
  a.sum_dt = sum_dt;
  a.sum_scale = sum_scale;
  a.n = n; a.ih = ih; a.iw = iw; a.ic = ic; a.oh = oh; a.ow = ow;
  a.kh = kh; a.kw = kw; a.sh = sh; a.sw = sw; a.ph = ph; a.pw = pw;
  a.oc0 = oc0; a.oc0p = oc0p; a.oc1 = oc1; a.oc1p = oc1p;
  a.relu0 = relu0; a.relu1 = relu1; a.down0 = down0; a.down1 = down1;
  a.has_bias0 = has_bias0; a.has_bias1 = has_bias1;
  pick_tiles(a);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return fuse ? launch_dst<true>(a, dst_dt, s) : launch_dst<false>(a, dst_dt, s);
}

extern "C" const char* df_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
