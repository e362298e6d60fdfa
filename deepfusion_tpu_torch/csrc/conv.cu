// conv_fused_kernel<FUSE, DST>: direct INT8 convolution with the
// requantization epilogue and, when FUSE, the deep-fused 1x1 tail.
//
// Replaces deepfusion_tpu/ops/conv.py:_conv_kernel and
// deepfusion_tpu/ops/conv.py:_conv_fused_kernel (launcher _conv_pallas).
//
// What it computes, per output pixel p and channel o:
//   acc0[p,o] = sum_{ki,kj,c} src_u8[n, y*sh-ph+ki, x*sw-pw+kj, c] * w0[o,c,ki,kj]
//   (taps outside the image read 0: zero padding is exact in the u8 domain,
//   so there is no -128 shift and no correction term)
//   not fused: dst = requant(acc0)
//   fused:     mid = requant_to_u8(acc0); acc1 = mid . w1; dst = requant(acc1)
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
// Layouts (deepfusion_tpu_torch/ops/layout.py): the input is NHWC u8 with
// ic a multiple of 16 (the wrapper pads other counts); w0 is int32 words
// [kh*kw][icp/4][oc0p], each word 4 s8 weights of 4 consecutive input
// channels (byte b = channel 4k+b), icp = ic rounded up to 32, oc0p = oc
// rounded up to 8, zero padded; w1 is [k1/4][oc1p] the same way, with k1 =
// oc0p rounded up to 32. A word is exactly one register of an mma.sync
// fragment: A = (pixel row, 4 channels), B = (4 channels, output channel).
#include <cuda_runtime.h>

#include <cstdint>

#include "mma_sync.cuh"
#include "requant.cuh"

namespace {

struct ConvArgs {
  const uint8_t* src;
  const int32_t* w0;
  const float* bias0;
  const float* scale0;
  const int32_t* w1;
  const float* bias1;
  const float* scale1;
  void* dst;
  int n, ih, iw, ic, oh, ow, kh, kw, sh, sw, ph, pw;
  int oc0, oc0p, oc1, oc1p;
  int relu0, relu1, down0, down1, has_bias0, has_bias1;
  int wc;    // warps along the channels; 8 / wc along the pixels
  int kcw;   // K words per chunk of the conv: 8, 16 or 32
  int k1;    // K of the fused 1x1: oc0p rounded up to 32
};

template <int DST>
__device__ __forceinline__ void store_out(void* dst, size_t idx,
                                          typename dt_traits<DST>::T v) {
  static_cast<typename dt_traits<DST>::T*>(dst)[idx] = v;
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

  const int icp4 = ((a.ic + 31) / 32) * 8;  // K words per tap
  const int cpt = icp4 / a.kcw;             // chunks per tap
  const int nchunks = a.kh * a.kw * cpt;
  const int upp = a.kcw / 4;                // 16-byte units per pixel row
  int32_t acc[MI][NI][4];

  for (int n0 = 0; n0 < a.oc0p; n0 += L.nb) {
    const int nbv = min(L.nb, a.oc0p - n0);   // valid columns of the pass
    const int ntiles = min(NI, max(0, (nbv - wc * 64) / 8));
    // copy chunk c (one tap, kcw words of channels) into buffer b
    auto issue = [&](int c, int b) {
      const int tap = c / cpt, c40 = (c - tap * cpt) * a.kcw;
      const int ki = tap / a.kw, kj = tap - ki * a.kw;
      for (int e = tid; e < L.m * upp; e += NT) {
        const int p = e / upp, u = e - p * upp;
        const int nn = s_pix[3 * p];
        const int iy = s_pix[3 * p + 1] + ki, ix = s_pix[3 * p + 2] + kj;
        const int ch = (c40 + 4 * u) * 4;
        const bool ok = nn >= 0 && iy >= 0 && iy < a.ih && ix >= 0 &&
                        ix < a.iw && ch < a.ic;
        const uint8_t* src =
            ok ? a.src + (((size_t)nn * a.ih + iy) * a.iw + ix) * a.ic + ch
               : a.src;
        cp_async16(s_in[b] + p * L.lda + 4 * u, src, ok ? 16 : 0);
      }
      issue_rows(s_w[b], L.ldw,
                 a.w0 + ((size_t)tap * icp4 + c40) * a.oc0p + n0, a.oc0p,
                 a.kcw, nbv, warp, lane);
      cp_async_commit();
    };
    zero(acc);
    issue(0, 0);
    for (int c = 0; c < nchunks; ++c) {
      if (c + 1 < nchunks) {
        issue(c + 1, (c + 1) & 1);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      mma_chunk(acc, s_in[c & 1] + wr * 32 * L.lda, L.lda,
                s_w[c & 1] + wc * 64, L.ldw, a.kcw / 8, ntiles, g, t);
      __syncthreads();  // buffer c&1 is refilled by the next issue
    }

#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) {
        if (ni >= ntiles) continue;
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int p = wr * 32 + mi * 16 + g + (r >> 1) * 8;
          const int o = n0 + wc * 64 + ni * 8 + 2 * t + (r & 1);
          if constexpr (FUSE) {
            if (o < a.oc0)
              reinterpret_cast<uint8_t*>(s_mid)[(size_t)p * L.ldm * 4 + o] =
                  requant_to_u8(acc[mi][ni][r], a.has_bias0, a.bias0[o],
                                a.scale0[o], a.down0);
          } else {
            const long long gp = p0 + p;
            if (gp < total && o < a.oc0)
              store_out<DST>(a.dst, (size_t)gp * a.oc0 + o,
                             requant<DST>(acc[mi][ni][r], a.has_bias0,
                                          a.bias0[o], a.scale0[o], a.relu0,
                                          a.down0));
          }
        }
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
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int ni = 0; ni < NI; ++ni) {
          if (ni >= ntiles) continue;
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const long long gp = p0 + wr * 32 + mi * 16 + g + (r >> 1) * 8;
            const int o = n0 + wc * 64 + ni * 8 + 2 * t + (r & 1);
            if (gp < total && o < a.oc1)
              store_out<DST>(a.dst, (size_t)gp * a.oc1 + o,
                             requant<DST>(acc[mi][ni][r], a.has_bias1,
                                          a.bias1[o], a.scale1[o], a.relu1,
                                          a.down1));
          }
        }
    }
  }
}

template <bool FUSE, int DST>
int launch(const ConvArgs& a, cudaStream_t stream) {
  const Smem L(a);
  const size_t smem = L.bytes(FUSE);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        conv_fused_kernel<FUSE, DST>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const long long total = (long long)a.n * a.oh * a.ow;
  const unsigned blocks = (unsigned)((total + L.m - 1) / L.m);
  conv_fused_kernel<FUSE, DST><<<blocks, NT, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <bool FUSE>
int launch_dst(const ConvArgs& a, int dst_dt, cudaStream_t stream) {
  switch (dst_dt) {
    case DT_F32: return launch<FUSE, DT_F32>(a, stream);
    case DT_S32: return launch<FUSE, DT_S32>(a, stream);
    case DT_S8: return launch<FUSE, DT_S8>(a, stream);
    case DT_U8: return launch<FUSE, DT_U8>(a, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

int round_up(int x, int m) { return (x + m - 1) / m * m; }

}  // namespace

extern "C" int df_conv(const void* src, const void* w0, const void* bias0,
                       const void* scale0, const void* w1, const void* bias1,
                       const void* scale1, void* dst, int n, int ih, int iw,
                       int ic, int oh, int ow, int kh, int kw, int sh, int sw,
                       int ph, int pw, int oc0, int oc0p, int oc1, int oc1p,
                       int relu0, int relu1, int down0, int down1,
                       int has_bias0, int has_bias1, int fuse, int dst_dt,
                       void* stream) {
  if (ic % 16 || oc0p % 8 || oc0p <= 0 || (fuse && (oc1p % 8 || oc1p <= 0)))
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
  a.n = n; a.ih = ih; a.iw = iw; a.ic = ic; a.oh = oh; a.ow = ow;
  a.kh = kh; a.kw = kw; a.sh = sh; a.sw = sw; a.ph = ph; a.pw = pw;
  a.oc0 = oc0; a.oc0p = oc0p; a.oc1 = oc1; a.oc1p = oc1p;
  a.relu0 = relu0; a.relu1 = relu1; a.down0 = down0; a.down1 = down1;
  a.has_bias0 = has_bias0; a.has_bias1 = has_bias1;
  // channels per pass: the smallest of 64, 128, 256, 512 covering oc0p
  a.wc = 1;
  while (a.wc < 8 && 64 * a.wc < oc0p) a.wc *= 2;
  const int icp4 = round_up(ic, 32) / 4;
  a.kcw = icp4 % 32 == 0 ? 32 : icp4 % 16 == 0 ? 16 : 8;
  a.k1 = round_up(oc0p, 32);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return fuse ? launch_dst<true>(a, dst_dt, s) : launch_dst<false>(a, dst_dt, s);
}

extern "C" const char* df_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
