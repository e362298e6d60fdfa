// The fused conv+pool kernel's arguments and its mma.sync K loop
// (convpool_kernel, convpool.cu).
//
// Layouts (deepfusion_tpu_torch/ops/layout.py): the input is NHWC u8 with
// ic a multiple of 16 (the wrapper pads other counts); w0 is int32 words
// [kh*kw][icp/4][oc0p], each word 4 s8 weights of 4 consecutive input
// channels (byte b = channel 4k+b), icp = ic rounded up to 32, oc0p = oc
// rounded up to 8, zero padded. A word is exactly one register of an
// mma.sync fragment: A = (pixel row, 4 channels), B = (4 channels, output
// channel).
#pragma once

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
  void* dst;
  const void* sum;  // the sum operand, or null
  float sum_scale;
  int sum_dt;
  int n, ih, iw, ic, oh, ow, kh, kw, sh, sw, ph, pw;
  int oc0, oc0p;
  int relu0, down0, has_bias0;
  int wc;    // warps along the channels; 8 / wc along the pixels
  int kcw;   // K words per chunk of the conv: 8, 16 or 32
  int k1;    // oc0p rounded up to 32: Smem (mma_sync.cuh) sizes rows by it
};

int round_up(int x, int m) { return (x + m - 1) / m * m; }

// The tiling the wrappers' shapes pick: channels per pass the smallest of
// 64, 128, 256, 512 covering oc0p, and the largest K chunk dividing a tap.
void pick_tiles(ConvArgs& a) {
  a.wc = 1;
  while (a.wc < 8 && 64 * a.wc < a.oc0p) a.wc *= 2;
  const int icp4 = round_up(a.ic, 32) / 4;
  a.kcw = icp4 % 32 == 0 ? 32 : icp4 % 16 == 0 ? 16 : 8;
  a.k1 = round_up(a.oc0p, 32);
}

template <int DST>
__device__ __forceinline__ void store_out(void* dst, size_t idx,
                                          typename dt_traits<DST>::T v) {
  static_cast<typename dt_traits<DST>::T*>(dst)[idx] = v;
}

// acc = the 3x3 (kh x kw) conv of the block's L.m pixels over output
// channels [n0, n0 + nbv). s_pix holds (n, y0, x0) per pixel: its batch
// (-1 past the last pixel) and the input row and column of its tap (0, 0).
// K streams through shared memory one tap and kcw words of channels at a
// time, copied with cp.async into two buffers so the next chunk loads
// while this one multiplies; taps outside the image and channels past ic
// are zero-filled by the copy itself, so padding and stride are only
// addressing.
__device__ __forceinline__ void conv_pass(const ConvArgs& a, const Smem& L,
                                          uint32_t* const (&s_in)[2],
                                          uint32_t* const (&s_w)[2],
                                          const int* s_pix, int n0, int nbv,
                                          int ntiles,
                                          int32_t (&acc)[MI][NI][4]) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wr = warp / a.wc, wc = warp % a.wc;  // this warp's 32 x 64 tile
  const int icp4 = ((a.ic + 31) / 32) * 8;  // K words per tap
  const int cpt = icp4 / a.kcw;             // chunks per tap
  const int nchunks = a.kh * a.kw * cpt;
  const int upp = a.kcw / 4;                // 16-byte units per pixel row
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
}

// Set the dynamic shared memory limit of `kernel` when it needs more than
// the default 48 KB.
template <class K>
int allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace
