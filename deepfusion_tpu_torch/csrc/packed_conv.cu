// packed_conv_kernel<FUSE>: stride-1 INT8 convolution in the packed domain,
// with the requantization epilogue and, when FUSE, the deep-fused 1x1 tail.
//
// Replaces deepfusion_tpu/ops/packed.py:_packed_kernel (launcher
// _packed_call) for 1..n inputs, u8 destination, with the packed sum
// operand, without the fused 2x2 pool, sparse-phase taps, emit_acc1 and the
// tile range. A strided conv reaches it as a stride-1 conv on the s2d grid
// (ops/packed.py: PackedConvOp.pack_input), as in the JAX package.
//
// Packed domain (deepfusion_tpu_torch/ops/packed.py): an image is an int8
// array (n, rows * iwp, cp), rows = h + 2 * halo, whose byte at an image
// slot is u8 ^ 0x80 and whose every other slot (halo rows, margin columns,
// lanes >= c) holds 0x80 = -128, u8 zero.
//
// What it computes, per image pixel (y, x) of the output and channel o:
//   acc0[o] = sum_{ki,kj,k} u8(src[halo_in + y - ph + ki, col_off_in + x - pw
//             + kj, k]) * w0[o, k, ki, kj]      (k over the joined sources)
//   not fused: out = requant_to_u8(acc0) ^ 0x80
//   fused:     mid = requant_to_u8(acc0); out = requant_to_u8(mid . w1) ^ 0x80
// written at row halo_out + y, column col_off_out + x; lanes >= oc and every
// non-image slot of the output get 0x80. This is bitwise
// requant_to_u8_centered (deepfusion_tpu/ops/requant.py) with the TPU
// kernel's zero mask and zero pad-lane scales.
// With a sum operand (a packed image of the output's image, columns and
// lanes, whose halo may be deeper), the final stage joins
//   sum_rounded = round(f32(u8(sum[halo_sum + y, col_off_out + x, o]))
//                       * sum_scale)
// after its own round: min(max(round(x) + sum_rounded, 0), 255). The
// operand is read at its own halo, so a producer's deeper halo needs no
// repack; its slots outside the image are never read.
//
// What bounds it on the H100: int8 multiply-adds, as for conv.cu (the block1
// layer is 4.1 G MAC against 4 MB of packed input at batch 8). It runs on
// the tensor cores with mma.sync m16n8k32 u8 x s8 and cp.async double
// buffering (mma_sync.cuh); wgmma and TMA are later work.
//
// Design:
// * The dense kernel's tiling: a block owns M = 32 * 8 / wc image pixels
//   (flattened over n, oh, ow) and all output lanes in passes of 64 * wc;
//   K streams through shared memory one tap and up to 128 lanes at a time.
// * Input: a stored byte is u8 ^ 0x80, so each A-fragment register is
//   XOR-ed with 0x80808080 before its mma. Halo, margin and pad-lane slots
//   then read as u8 0, the conv's zero padding, and no correction term is
//   needed. The validated geometry keeps every tap of an image pixel inside
//   the input (halo_in >= ph, col_off_in >= pw, right margin >= kw-1-pw), so
//   the copy never zero-fills an image pixel's tap: zero bytes would read as
//   u8 128. Only the pixels past the last one of the last block are
//   zero-filled, and their outputs are dropped.
// * Multi-input (the concat-free branch merge): K runs over (tap, source 0
//   lanes, source 1 lanes, ...); each 16-byte unit is copied from the
//   source that holds its lanes, so the joined input never exists.
// * Output: only image pixels are computed (the TPU kernel computes the
//   whole padded space and masks it). Each block first writes 0x80 over its
//   share of the output's non-image slots, so the result is a valid packed
//   image with no second pass and no extra blocks.
#include <cuda_runtime.h>

#include <cstdint>

#include "mma_sync.cuh"
#include "requant.cuh"

namespace {

constexpr int MAX_SRC = 4;
constexpr uint32_t CENTER4 = 0x80808080u;

struct PackedArgs {
  const uint8_t* src[MAX_SRC];
  int src_cp[MAX_SRC];    // lanes of each source
  int src_off[MAX_SRC];   // first K lane of each source
  int n_src;
  const int32_t* w0;
  const float* bias0;
  const float* scale0;
  const int32_t* w1;
  const float* bias1;
  const float* scale1;
  uint8_t* dst;
  const uint8_t* sum;     // the packed sum operand, or null
  float sum_scale;
  int rows_sum, halo_sum;
  int n, rows_in, iwp, halo_in, col_off_in;
  int rows_out, halo_out, col_off_out, oh, ow;
  int kh, kw, ph, pw;
  int icp;                // K lanes per tap: the sum of src_cp
  int oc0, oc0p, oc1, oc1p, cp_out;
  int down0, down1, has_bias0, has_bias1;
  int wc;                 // warps along the channels; 8 / wc along the pixels
  int kcw;                // K words per chunk: 8, 16 or 32
  int k1;                 // K of the fused 1x1 (= oc0p)
};

// Fill block fb's share (of nfb) of the output's non-image slots with
// 0x80, 16 bytes at a time.
__device__ void fill_pads(const PackedArgs& a, int fb, int nfb) {
  const int upp = a.cp_out / 16;
  const long long total = (long long)a.n * a.rows_out * a.iwp * upp;
  const uint4 pad = make_uint4(CENTER4, CENTER4, CENTER4, CENTER4);
  uint4* out = reinterpret_cast<uint4*>(a.dst);
  for (long long e = (long long)fb * NT + threadIdx.x; e < total;
       e += (long long)nfb * NT) {
    const long long q = e / upp;
    const int col = int(q % a.iwp);
    const int row = int((q / a.iwp) % a.rows_out);
    const bool img = row >= a.halo_out && row < a.halo_out + a.oh &&
                     col >= a.col_off_out && col < a.col_off_out + a.ow;
    if (!img) out[e] = pad;
  }
}

// Two adjacent output lanes (o, o + 1) of one pixel as one 16-bit store.
__device__ __forceinline__ void store_pair(uint8_t* dst, size_t idx,
                                           uint8_t b0, uint8_t b1) {
  *reinterpret_cast<uint16_t*>(dst + idx) =
      static_cast<uint16_t>(b0 | (static_cast<uint16_t>(b1) << 8));
}

// Requantize the warp's tile of the final stage to u8 and store it, ^ 0x80,
// at each pixel's output slot: channels n0 + [0, nb), lanes >= oc get 0x80.
// With SUM each value joins the sum operand's byte at the pixel's sum slot.
// The caller picks SUM with one uniform branch, so the unrolled loop
// carries no per-element test.
template <bool SUM>
__device__ __forceinline__ void store_tile(
    const PackedArgs& a, const int32_t (&acc)[MI][NI][4], const int* s_pix,
    int n0, int oc, bool has_bias, const float* bias, const float* scale,
    bool down, int ntiles) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wr = warp / a.wc, wc = warp % a.wc;
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni) {
      if (ni >= ntiles) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = wr * 32 + mi * 16 + g + h * 8;
        const int out_pix = s_pix[3 * p + 1];
        if (out_pix < 0) continue;
        const int o = n0 + wc * 64 + ni * 8 + 2 * t;
        uint8_t v[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int oo = o + j;
          const int32_t x = acc[mi][ni][2 * h + j];
          if (oo >= oc) {
            v[j] = 0;
          } else if constexpr (SUM) {
            const float sv = __int2float_rn(
                a.sum[(size_t)s_pix[3 * p + 2] * a.cp_out + oo] ^ 0x80);
            // sum_rounded is integral, so requant_sum's round of it is
            // exact: this is requant_to_u8_centered(..., sum_rounded=)
            v[j] = requant_sum<DT_U8>(x, has_bias, bias[oo], scale[oo], true,
                                      down,
                                      round_f32(__fmul_rn(sv, a.sum_scale),
                                                down));
          } else {
            v[j] = requant_to_u8(x, has_bias, bias[oo], scale[oo], down);
          }
        }
        store_pair(a.dst, (size_t)out_pix * a.cp_out + o, v[0] ^ 0x80,
                   v[1] ^ 0x80);
      }
    }
}

__device__ __forceinline__ void store_final(
    const PackedArgs& a, const int32_t (&acc)[MI][NI][4], const int* s_pix,
    int n0, int oc, bool has_bias, const float* bias, const float* scale,
    bool down, int ntiles) {
  if (a.sum)
    store_tile<true>(a, acc, s_pix, n0, oc, has_bias, bias, scale, down,
                     ntiles);
  else
    store_tile<false>(a, acc, s_pix, n0, oc, has_bias, bias, scale, down,
                      ntiles);
}

template <bool FUSE>
__global__ void __launch_bounds__(NT, 2) packed_conv_kernel(PackedArgs a) {
  fill_pads(a, blockIdx.x, gridDim.x);
  extern __shared__ __align__(16) uint32_t smem[];
  const Smem L(a);
  uint32_t* s_in[2] = {smem, smem + L.in_words};
  uint32_t* s_w[2] = {smem + 2 * L.in_words,
                      smem + 2 * L.in_words + L.w_words};
  // per pixel of the block: the flat input slot of its tap (0, 0), its
  // flat output slot and its flat sum operand slot, all -1 past the last
  // pixel
  int* s_pix = reinterpret_cast<int*>(smem + 2 * (L.in_words + L.w_words));
  uint32_t* s_mid = reinterpret_cast<uint32_t*>(s_pix + 3 * L.m);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wr = warp / a.wc, wc = warp % a.wc;  // this warp's 32 x 64 tile
  const long long total = (long long)a.n * a.oh * a.ow;
  const long long p0 = (long long)blockIdx.x * L.m;

  for (int p = tid; p < L.m; p += NT) {
    const long long gp = p0 + p;
    int in_pix = -1, out_pix = -1, sum_pix = -1;
    if (gp < total) {
      const int ox = int(gp % a.ow);
      const long long q = gp / a.ow;
      const int oy = int(q % a.oh);
      const int nn = int(q / a.oh);
      in_pix = (nn * a.rows_in + a.halo_in + oy - a.ph) * a.iwp +
               a.col_off_in + ox - a.pw;
      out_pix = (nn * a.rows_out + a.halo_out + oy) * a.iwp +
                a.col_off_out + ox;
      sum_pix = (nn * a.rows_sum + a.halo_sum + oy) * a.iwp +
                a.col_off_out + ox;
    }
    s_pix[3 * p] = in_pix;
    s_pix[3 * p + 1] = out_pix;
    s_pix[3 * p + 2] = sum_pix;
  }
  if (FUSE) {  // channels [oc0, k1) of the intermediate stay 0
    for (size_t e = tid; e < L.mid_words; e += NT) s_mid[e] = 0u;
  }
  __syncthreads();

  const int icp4 = a.icp / 4;          // K words per tap
  const int cpt = icp4 / a.kcw;        // chunks per tap
  const int nchunks = a.kh * a.kw * cpt;
  const int upp = a.kcw / 4;           // 16-byte units per pixel row
  int32_t acc[MI][NI][4];

  for (int n0 = 0; n0 < a.oc0p; n0 += L.nb) {
    const int nbv = min(L.nb, a.oc0p - n0);   // valid columns of the pass
    const int ntiles = min(NI, max(0, (nbv - wc * 64) / 8));
    // copy chunk c (one tap, kcw words of lanes) into buffer b
    auto issue = [&](int c, int b) {
      const int tap = c / cpt, c40 = (c - tap * cpt) * a.kcw;
      const int ki = tap / a.kw, kj = tap - ki * a.kw;
      const int toff = ki * a.iwp + kj;
      for (int e = tid; e < L.m * upp; e += NT) {
        const int p = e / upp, u = e - p * upp;
        const int pix = s_pix[3 * p];
        const int ch = (c40 + 4 * u) * 4;   // K lane of this 16-byte unit
        const uint8_t* base = a.src[0];
        int cp = a.src_cp[0], l0 = ch;
#pragma unroll
        for (int s = 1; s < MAX_SRC; ++s) {
          if (s < a.n_src && ch >= a.src_off[s]) {
            base = a.src[s];
            cp = a.src_cp[s];
            l0 = ch - a.src_off[s];
          }
        }
        const bool ok = pix >= 0;
        const uint8_t* src =
            ok ? base + (size_t)(pix + toff) * cp + l0 : a.src[0];
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
      mma_chunk<CENTER4>(acc, s_in[c & 1] + wr * 32 * L.lda, L.lda,
                         s_w[c & 1] + wc * 64, L.ldw, a.kcw / 8, ntiles, g,
                         t);
      __syncthreads();  // buffer c&1 is refilled by the next issue
    }

    if constexpr (FUSE) {
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int ni = 0; ni < NI; ++ni) {
          if (ni >= ntiles) continue;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int p = wr * 32 + mi * 16 + g + h * 8;
            const int o = n0 + wc * 64 + ni * 8 + 2 * t;
            uint8_t* mid = reinterpret_cast<uint8_t*>(s_mid) +
                           (size_t)p * L.ldm * 4 + o;
#pragma unroll
            for (int j = 0; j < 2; ++j)
              mid[j] = o + j < a.oc0
                           ? requant_to_u8(acc[mi][ni][2 * h + j],
                                           a.has_bias0, a.bias0[o + j],
                                           a.scale0[o + j], a.down0)
                           : 0;
          }
        }
    } else {
      store_final(a, acc, s_pix, n0, a.oc0, a.has_bias0, a.bias0, a.scale0,
                  a.down0, ntiles);
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
      store_final(a, acc, s_pix, n0, a.oc1, a.has_bias1, a.bias1, a.scale1,
                  a.down1, ntiles);
    }
  }
}

template <bool FUSE>
int launch(const PackedArgs& a, cudaStream_t stream) {
  const Smem L(a);
  const size_t smem = L.bytes(FUSE);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        packed_conv_kernel<FUSE>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const long long total = (long long)a.n * a.oh * a.ow;
  const unsigned blocks = (unsigned)((total + L.m - 1) / L.m);
  packed_conv_kernel<FUSE><<<blocks, NT, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// srcs/src_cps: n_src input arrays and their lane counts (each a multiple
// of 16, summing to icp); w0 [kh*kw][icp/4][oc0p] words, w1 [oc0p/4][oc1p]
// words (ops/layout.py); the output lane count is oc0p unfused, oc1p fused.
// sum: null, or a packed array of rows_sum rows with the output's iwp,
// col_off and lanes and halo_sum >= halo_out.
extern "C" int df_packed_conv(
    const void* const* srcs, const int* src_cps, int n_src, const void* w0,
    const void* bias0, const void* scale0, const void* w1, const void* bias1,
    const void* scale1, void* dst, const void* sum, int n, int rows_in,
    int iwp, int halo_in, int col_off_in, int rows_out, int halo_out,
    int col_off_out, int oh, int ow, int kh, int kw, int ph, int pw, int oc0,
    int oc0p, int oc1, int oc1p, int down0, int down1, int has_bias0,
    int has_bias1, int fuse, int rows_sum, int halo_sum, float sum_scale,
    void* stream) {
  if (n_src < 1 || n_src > MAX_SRC || oc0p % 32 || oc0p <= 0 ||
      (fuse && (oc1p % 32 || oc1p <= 0)))
    return (int)cudaErrorInvalidValue;
  // every flat slot index must fit an int
  if ((long long)n * rows_in * iwp >= (1LL << 31) ||
      (long long)n * rows_out * iwp >= (1LL << 31) ||
      (sum && ((long long)n * rows_sum * iwp >= (1LL << 31) ||
               halo_sum < halo_out || rows_sum - halo_sum < oh)))
    return (int)cudaErrorInvalidValue;
  PackedArgs a = {};
  int icp = 0;
  for (int s = 0; s < n_src; ++s) {
    if (src_cps[s] <= 0 || src_cps[s] % 16) return (int)cudaErrorInvalidValue;
    a.src[s] = static_cast<const uint8_t*>(srcs[s]);
    a.src_cp[s] = src_cps[s];
    a.src_off[s] = icp;
    icp += src_cps[s];
  }
  if (icp % 32) return (int)cudaErrorInvalidValue;
  a.n_src = n_src;
  a.w0 = static_cast<const int32_t*>(w0);
  a.bias0 = static_cast<const float*>(bias0);
  a.scale0 = static_cast<const float*>(scale0);
  a.w1 = static_cast<const int32_t*>(w1);
  a.bias1 = static_cast<const float*>(bias1);
  a.scale1 = static_cast<const float*>(scale1);
  a.dst = static_cast<uint8_t*>(dst);
  a.sum = static_cast<const uint8_t*>(sum);
  a.sum_scale = sum_scale;
  a.rows_sum = rows_sum;
  a.halo_sum = halo_sum;
  a.n = n; a.rows_in = rows_in; a.iwp = iwp; a.halo_in = halo_in;
  a.col_off_in = col_off_in; a.rows_out = rows_out; a.halo_out = halo_out;
  a.col_off_out = col_off_out; a.oh = oh; a.ow = ow;
  a.kh = kh; a.kw = kw; a.ph = ph; a.pw = pw; a.icp = icp;
  a.oc0 = oc0; a.oc0p = oc0p; a.oc1 = oc1; a.oc1p = oc1p;
  a.cp_out = fuse ? oc1p : oc0p;
  a.down0 = down0; a.down1 = down1;
  a.has_bias0 = has_bias0; a.has_bias1 = has_bias1;
  // channels per pass: the smallest of 64, 128, 256, 512 covering oc0p
  a.wc = 1;
  while (a.wc < 8 && 64 * a.wc < oc0p) a.wc *= 2;
  const int icp4 = icp / 4;
  a.kcw = icp4 % 32 == 0 ? 32 : icp4 % 16 == 0 ? 16 : 8;
  a.k1 = oc0p;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return fuse ? launch<true>(a, s) : launch<false>(a, s);
}
