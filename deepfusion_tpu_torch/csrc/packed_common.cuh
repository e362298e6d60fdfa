// Device code of the conv pair kernel, pair_conv_kernel (pair_conv.cu),
// on the mma.sync K loop (mma_sync.cuh): one conv stage's operands, the K
// loop over a packed input, the fused 1x1 tail, the u8 requant into shared
// memory, the final store (plain or with the fused 2x2/s2 max pool), and
// each block's share of the fill of the output's non-image slots.
//
// Packed domain (deepfusion_tpu_torch/ops/packed.py): an image is an int8
// array (n, rows * iwp, cp), rows = h + 2 * halo, whose byte at an image
// slot is u8 ^ 0x80 and whose every other slot (halo rows, margin columns,
// lanes >= c) holds 0x80 = -128, u8 zero.
//
// Per M row p of a block, s_pix holds three ints: [3p] the row's source
// (the flat input slot of its tap (0, 0)), [3p + 1] its destination (the
// flat output slot, the pooled one when the kernel pools), [3p + 2] -1
// (the pair has no sum operand); -1 where the row has none.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "mma_sync.cuh"
#include "packed_dst.cuh"
#include "requant.cuh"

namespace {

// A packed conv input: 1..MAX_SRC sources whose lane join is the conv input.
struct PackedSrc {
  const uint8_t* src[MAX_SRC];
  int src_cp[MAX_SRC];   // lanes of each source
  int src_off[MAX_SRC];  // first K lane of each source
  int n_src;
};

// One conv stage: w0 [kh*kw][icp/4][oc0p] words and, when fused, w1
// [k1/4][oc1p] words (ops/layout.py), their biases and scales, and the
// block tiling Smem reads: wc warps along the channels, kcw K words per
// chunk, k1 = oc0p the K of the fused 1x1.
struct Stage {
  const int32_t* w0;
  const float* bias0;
  const float* scale0;
  const int32_t* w1;
  const float* bias1;
  const float* scale1;
  int kh, kw, ph, pw;
  int icp;  // K lanes per tap
  int oc0, oc0p, oc1, oc1p;
  int down0, down1, has_bias0, has_bias1, fuse;
  int wc, kcw, k1;
};

// Fill in the stage's tiling from its shapes: channels per pass the
// smallest of 64, 128, 256, 512 covering oc0p, the largest K chunk dividing
// a tap.
inline void pick_stage_tiles(Stage& s) {
  s.wc = 1;
  while (s.wc < 8 && 64 * s.wc < s.oc0p) s.wc *= 2;
  const int icp4 = s.icp / 4;
  s.kcw = icp4 % 32 == 0 ? 32 : icp4 % 16 == 0 ? 16 : 8;
  s.k1 = s.oc0p;
}

// Fill block fb's share (of nfb) of the output's non-image slots with the
// byte 0x80, 16 bytes at a time.
__device__ void fill_pads(const PackedDst& d, int fb, int nfb) {
  const int upp = d.cp / 16;
  const long long total = (long long)d.n * d.rows * d.iwp * upp;
  const uint4 pad = make_uint4(CENTER4, CENTER4, CENTER4, CENTER4);
  uint4* out = reinterpret_cast<uint4*>(d.dst);
  for (long long e = (long long)fb * NT + threadIdx.x; e < total;
       e += (long long)nfb * NT) {
    const long long q = e / upp;
    const int col = int(q % d.iwp);
    const int row = int((q / d.iwp) % d.rows);
    const bool img = row >= d.halo && row < d.halo + d.h &&
                     col >= d.col_off && col < d.col_off + d.w;
    if (!img) out[e] = pad;
  }
}

// acc = the stage's conv of the block's L.m rows over output channels
// [n0, n0 + nbv), reading the packed input: K streams one tap and kcw words
// of lanes at a time through s_in (cp.async, two buffers), each 16-byte
// unit copied from the source that holds its lanes, so a joined input never
// exists. A fragments are XOR-ed with 0x80808080, so stored bytes read as
// u8 and pads as u8 0. Rows with no source are zero-filled; their results
// are dropped by the stores.
__device__ __forceinline__ void packed_pass(
    const PackedSrc& in, const Stage& st, int iwp, const Smem& L,
    uint32_t* const (&s_in)[2], uint32_t* const (&s_w)[2], const int* s_pix,
    int n0, int nbv, int ntiles, int32_t (&acc)[MI][NI][4]) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wr = warp / st.wc, wc = warp % st.wc;
  const int icp4 = st.icp / 4;         // K words per tap
  const int cpt = icp4 / st.kcw;       // chunks per tap
  const int nchunks = st.kh * st.kw * cpt;
  const int upp = st.kcw / 4;          // 16-byte units per pixel row
  // copy chunk c (one tap, kcw words of lanes) into buffer b
  auto issue = [&](int c, int b) {
    const int tap = c / cpt, c40 = (c - tap * cpt) * st.kcw;
    const int ki = tap / st.kw, kj = tap - ki * st.kw;
    const int toff = ki * iwp + kj;
    for (int e = tid; e < L.m * upp; e += NT) {
      const int p = e / upp, u = e - p * upp;
      const int pix = s_pix[3 * p];
      const int ch = (c40 + 4 * u) * 4;   // K lane of this 16-byte unit
      const uint8_t* base = in.src[0];
      int cp = in.src_cp[0], l0 = ch;
#pragma unroll
      for (int s = 1; s < MAX_SRC; ++s) {
        if (s < in.n_src && ch >= in.src_off[s]) {
          base = in.src[s];
          cp = in.src_cp[s];
          l0 = ch - in.src_off[s];
        }
      }
      const bool ok = pix >= 0;
      const uint8_t* src =
          ok ? base + (size_t)(pix + toff) * cp + l0 : in.src[0];
      cp_async16(s_in[b] + p * L.lda + 4 * u, src, ok ? 16 : 0);
    }
    issue_rows(s_w[b], L.ldw,
               st.w0 + ((size_t)tap * icp4 + c40) * st.oc0p + n0, st.oc0p,
               st.kcw, nbv, warp, lane);
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
    mma_chunk<CENTER4>(acc, s_in[c & 1] + wr * 32 * L.lda, L.lda,
                       s_w[c & 1] + wc * 64, L.ldw, st.kcw / 8, ntiles, g,
                       t);
    __syncthreads();  // buffer c&1 is refilled by the next issue
  }
}

// acc = the stage's fused 1x1 over channels [n0, n0 + nbv): A is the u8
// 3x3 output of the block's rows in s_mid (row pitch L.ldm words), B the
// w1 words streamed through s_w KCW K-words at a time, double-buffered.
__device__ __forceinline__ void conv1x1_pass(const Stage& st, const Smem& L,
                                             const uint32_t* s_mid,
                                             uint32_t* const (&s_w)[2],
                                             int n0, int nbv, int ntiles,
                                             int32_t (&acc)[MI][NI][4]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wr = warp / st.wc, wc = warp % st.wc;
  const int k1w = st.k1 / 4;
  const int nk = (k1w + KCW - 1) / KCW;
  auto issue = [&](int c, int b) {
    issue_rows(s_w[b], L.ldw, st.w1 + (size_t)c * KCW * st.oc1p + n0,
               st.oc1p, min(KCW, k1w - c * KCW), nbv, warp, lane);
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
}

// Requantize the warp's tile (channels n0 + [0, nb), wcn warps along the
// channels) to plain u8 in shared memory, lanes >= oc as 0. Row p goes to
// base + idx * ldb bytes, idx = p, or with ROWS idx = s_pix[3p + 1] (rows
// where it is -1 are skipped).
template <bool ROWS>
__device__ __forceinline__ void store_u8(uint8_t* base, int ldb,
                                         const int* s_pix,
                                         const int32_t (&acc)[MI][NI][4],
                                         int n0, int wcn, int oc,
                                         bool has_bias, const float* bias,
                                         const float* scale, bool down,
                                         int ntiles) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wr = warp / wcn, wc = warp % wcn;
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni) {
      if (ni >= ntiles) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = wr * 32 + mi * 16 + g + h * 8;
        const int idx = ROWS ? s_pix[3 * p + 1] : p;
        if (idx < 0) continue;
        const int o = n0 + wc * 64 + ni * 8 + 2 * t;
        uint8_t* d = base + (size_t)idx * ldb + o;
#pragma unroll
        for (int j = 0; j < 2; ++j)
          d[j] = o + j < oc ? requant_to_u8(acc[mi][ni][2 * h + j], has_bias,
                                            bias[o + j], scale[o + j], down)
                            : 0;
      }
    }
}

// The final stage's store: requantize the warp's tile to u8 (lanes >= oc
// as 0), then store it ^ 0x80 at the row's destination slot, two lanes per
// 16-bit store. With POOL the four rows 4q..4q+3 of the M tile are one 2x2
// window: their values meet in the lanes 4g + t that differ in lane bits 2
// and 3, two xor-shuffles take the max of each byte, and the window's first
// row stores at its (pooled) slot. A max over clamped u8 values is the JAX
// pool over the clamped f32 values: the pack is monotone, and so is
// rounding (requant.py:138-187). The caller picks POOL with one uniform
// branch, so the unrolled loop carries no per-element test.
template <bool POOL>
__device__ __forceinline__ void store_out(const PackedDst& d,
                                          const int32_t (&acc)[MI][NI][4],
                                          const int* s_pix, int n0, int wcn,
                                          int oc, bool has_bias,
                                          const float* bias,
                                          const float* scale, bool down,
                                          int ntiles) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wr = warp / wcn, wc = warp % wcn;
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni) {
      if (ni >= ntiles) continue;  // warp-uniform
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = wr * 32 + mi * 16 + g + h * 8;
        const int slot = s_pix[3 * p + 1];  // one value per pool window
        const int o = n0 + wc * 64 + ni * 8 + 2 * t;
        uint32_t v = 0;  // byte j: the u8 value of channel o + j
        if (slot >= 0) {
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int oo = o + j;
            if (oo < oc)   // pad lanes stay u8 0
              v |= uint32_t(requant_to_u8(acc[mi][ni][2 * h + j], has_bias,
                                          bias[oo], scale[oo], down))
                   << (8 * j);
          }
        }
        if constexpr (POOL) {
          v = __vmaxu4(v, __shfl_xor_sync(0xffffffffu, v, 4));
          v = __vmaxu4(v, __shfl_xor_sync(0xffffffffu, v, 8));
          if (g & 3) continue;
        }
        if (slot >= 0)
          *reinterpret_cast<uint16_t*>(d.dst + (size_t)slot * d.cp + o) =
              static_cast<uint16_t>(v ^ 0x8080u);
      }
    }
}

}  // namespace
