// packed_conv_kernel<FUSE>: stride-1 INT8 convolution in the packed domain,
// with the requantization epilogue and, when FUSE, the deep-fused 1x1 tail.
//
// Replaces deepfusion_tpu/ops/packed.py:_packed_kernel (launcher
// _packed_call) for 1..n inputs, u8 destination, with the packed sum
// operand, the fused 2x2/s2 max pool, the raw 1x1 accumulator (emit_acc1)
// and an output row range (t_range/row0_off), without sparse-phase taps. A
// strided conv reaches it as a stride-1 conv on the s2d grid
// (ops/packed.py: PackedConvOp.pack_input), as in the JAX package.
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
// With pool2 the output is the 2x2/s2 max of those u8 values (the sum
// joined first, at full resolution), stored ^ 0x80 at the pooled spec's
// slot (halo_out / 2 + y / 2, col_off_out / 2 + x / 2) of rows iwp / 2 wide.
// With RAW (fused, no pool, no sum: the tensor-parallel local step) the
// output is an s32 array of the output spec holding acc1 = mid . w1 at
// image slots (pad lanes 0: their w1 columns are 0) and 0 elsewhere.
// Row range (sequence-parallel interior/boundary split): the kernel
// computes the image rows [oy0, oy0 + noy) only and writes an array of the
// output rows [r0, r0 + rows) (pooled rows with pool2); the input may be a
// row slice of the full array. The host passes rows_out, halo_out and
// halo_in re-based by the range's first row and the slice's first row, so
// the kernel's addressing is unchanged; every tap of the computed pixels
// must lie in the slice.
//
// What bounds it on the H100: int8 multiply-adds, as for conv.cu (the block1
// layer is 4.1 G MAC against 4 MB of packed input at batch 8). It runs on
// the tensor cores with mma.sync m16n8k32 u8 x s8 and cp.async double
// buffering (mma_sync.cuh); wgmma and TMA are later work.
//
// Design (the K loop and the stores live in packed_common.cuh, shared with
// pair_conv.cu):
// * The dense kernel's tiling: a block owns M = 32 * 8 / wc image pixels
//   (flattened over n, oh, ow) and all output lanes in passes of 64 * wc;
//   K streams through shared memory one tap and up to 128 lanes at a time.
//   With pool2 (the kernel's POOL), M runs over 2x2 windows, four
//   consecutive rows each, so the pool is two warp shuffles in the store.
//   POOL is a template parameter, so the unpooled kernel carries no pool
//   code.
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

#include "packed_common.cuh"

namespace {

struct PackedArgs {
  PackedSrc in;
  Stage st;
  PackedDst out;          // the output spec (pooled with pool2)
  const uint8_t* sum;     // the packed sum operand, or null
  float sum_scale;
  int rows_sum, halo_sum;
  int n, rows_in, iwp, halo_in, col_off_in;
  int rows_out, halo_out, col_off_out, oh, ow;  // the unpooled output
  int oy0, noy;  // the image rows computed
};

template <bool FUSE, bool POOL, bool RAW>
__global__ void __launch_bounds__(NT, 2) packed_conv_kernel(PackedArgs a) {
  fill_pads<RAW ? 4 : 1>(a.out, blockIdx.x, gridDim.x);
  extern __shared__ __align__(16) uint32_t smem[];
  const Stage& st = a.st;
  const Smem L(st);
  uint32_t* s_in[2] = {smem, smem + L.in_words};
  uint32_t* s_w[2] = {smem + 2 * L.in_words,
                      smem + 2 * L.in_words + L.w_words};
  int* s_pix = reinterpret_cast<int*>(smem + 2 * (L.in_words + L.w_words));
  uint32_t* s_mid = reinterpret_cast<uint32_t*>(s_pix + 3 * L.m);

  const int tid = threadIdx.x;
  const int wc = (tid >> 5) % st.wc;
  const long long total = (long long)a.n * a.noy * a.ow;
  const long long p0 = (long long)blockIdx.x * L.m;
  const int nh2 = a.noy / 2, ow2 = a.ow / 2;

  for (int p = tid; p < L.m; p += NT) {
    const long long gp = p0 + p;
    int in_pix = -1, out_pix = -1, sum_pix = -1;
    if (gp < total) {
      int nn, oy, ox;
      if constexpr (POOL) {  // gp = 4 * window + (dy, dx)
        const long long q = gp >> 2;
        const int px = int(q % ow2);
        const long long r = q / ow2;
        const int py = a.oy0 / 2 + int(r % nh2);
        nn = int(r / nh2);
        oy = 2 * py + int((gp >> 1) & 1);
        ox = 2 * px + int(gp & 1);
        out_pix = (nn * a.out.rows + a.out.halo + py) * a.out.iwp +
                  a.out.col_off + px;
      } else {
        ox = int(gp % a.ow);
        const long long q = gp / a.ow;
        oy = a.oy0 + int(q % a.noy);
        nn = int(q / a.noy);
        out_pix = (nn * a.rows_out + a.halo_out + oy) * a.iwp +
                  a.col_off_out + ox;
      }
      in_pix = (nn * a.rows_in + a.halo_in + oy - st.ph) * a.iwp +
               a.col_off_in + ox - st.pw;
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

  int32_t acc[MI][NI][4];
  for (int n0 = 0; n0 < st.oc0p; n0 += L.nb) {
    const int nbv = min(L.nb, st.oc0p - n0);   // valid columns of the pass
    const int ntiles = min(NI, max(0, (nbv - wc * 64) / 8));
    packed_pass(a.in, st, a.iwp, L, s_in, s_w, s_pix, n0, nbv, ntiles, acc);
    if constexpr (FUSE) {
      store_u8<false>(reinterpret_cast<uint8_t*>(s_mid), L.ldm * 4, s_pix,
                      acc, n0, st.wc, st.oc0, st.has_bias0, st.bias0,
                      st.scale0, st.down0, ntiles);
    } else {
      store_final<POOL>(a.out, a.sum, a.sum_scale, acc, s_pix, n0, st.wc,
                        st.oc0, st.has_bias0, st.bias0, st.scale0, st.down0,
                        ntiles);
    }
  }

  if constexpr (FUSE) {
    __syncthreads();  // the intermediate is complete
    for (int n0 = 0; n0 < st.oc1p; n0 += L.nb) {
      const int nbv = min(L.nb, st.oc1p - n0);
      const int ntiles = min(NI, max(0, (nbv - wc * 64) / 8));
      conv1x1_pass(st, L, s_mid, s_w, n0, nbv, ntiles, acc);
      if constexpr (RAW)
        store_acc(a.out, acc, s_pix, n0, st.wc, ntiles);
      else
        store_final<POOL>(a.out, a.sum, a.sum_scale, acc, s_pix, n0, st.wc,
                          st.oc1, st.has_bias1, st.bias1, st.scale1,
                          st.down1, ntiles);
    }
  }
}

template <bool FUSE, bool POOL, bool RAW = false>
int launch(const PackedArgs& a, cudaStream_t stream) {
  const Smem L(a.st);
  const size_t smem = L.bytes(FUSE);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        packed_conv_kernel<FUSE, POOL, RAW>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const long long total = (long long)a.n * a.noy * a.ow;
  const unsigned blocks = (unsigned)((total + L.m - 1) / L.m);
  packed_conv_kernel<FUSE, POOL, RAW><<<blocks, NT, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// srcs/src_cps: n_src input arrays and their lane counts (each a multiple
// of 16, summing to icp); w0 [kh*kw][icp/4][oc0p] words, w1 [oc0p/4][oc1p]
// words (ops/layout.py); the output lane count is oc0p unfused, oc1p fused.
// sum: null, or a packed array of rows_sum rows with the output's iwp,
// col_off and lanes and halo_sum >= halo_out. pool2: the output is the
// pooled spec (rows_out / 2 rows of iwp / 2, halo_out / 2, col_off_out / 2);
// oh, ow, halo_out, col_off_out and iwp must then be even. raw (fused, no
// pool, no sum): dst is s32, the raw 1x1 accumulator. Row range: the image
// rows [oy0, oy0 + noy) (noy >= 1; both even with pool2) are computed;
// rows_out/halo_out describe the rows of dst (halo_out re-based, may be
// negative) and rows_in/halo_in the input slice (halo_in re-based).
extern "C" int df_packed_conv(
    const void* const* srcs, const int* src_cps, int n_src, const void* w0,
    const void* bias0, const void* scale0, const void* w1, const void* bias1,
    const void* scale1, void* dst, const void* sum, int n, int rows_in,
    int iwp, int halo_in, int col_off_in, int rows_out, int halo_out,
    int col_off_out, int oh, int ow, int kh, int kw, int ph, int pw, int oc0,
    int oc0p, int oc1, int oc1p, int down0, int down1, int has_bias0,
    int has_bias1, int fuse, int rows_sum, int halo_sum, int pool2, int raw,
    int oy0, int noy, float sum_scale, void* stream) {
  if (n_src < 1 || n_src > MAX_SRC || oc0p % 32 || oc0p <= 0 ||
      (fuse && (oc1p % 32 || oc1p <= 0)))
    return (int)cudaErrorInvalidValue;
  if (pool2 && (oh % 2 || ow % 2 || halo_out % 2 || col_off_out % 2 ||
                iwp % 16 || oy0 % 2 || noy % 2))
    return (int)cudaErrorInvalidValue;
  if (raw && (!fuse || pool2 || sum)) return (int)cudaErrorInvalidValue;
  if (noy < 1 || oy0 < 0 || oy0 + noy > oh) return (int)cudaErrorInvalidValue;
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
    a.in.src[s] = static_cast<const uint8_t*>(srcs[s]);
    a.in.src_cp[s] = src_cps[s];
    a.in.src_off[s] = icp;
    icp += src_cps[s];
  }
  if (icp % 32) return (int)cudaErrorInvalidValue;
  a.in.n_src = n_src;
  Stage& st = a.st;
  st.w0 = static_cast<const int32_t*>(w0);
  st.bias0 = static_cast<const float*>(bias0);
  st.scale0 = static_cast<const float*>(scale0);
  st.w1 = static_cast<const int32_t*>(w1);
  st.bias1 = static_cast<const float*>(bias1);
  st.scale1 = static_cast<const float*>(scale1);
  st.kh = kh; st.kw = kw; st.ph = ph; st.pw = pw; st.icp = icp;
  st.oc0 = oc0; st.oc0p = oc0p; st.oc1 = oc1; st.oc1p = oc1p;
  st.down0 = down0; st.down1 = down1;
  st.has_bias0 = has_bias0; st.has_bias1 = has_bias1; st.fuse = fuse;
  pick_stage_tiles(st);
  const int cp_out = fuse ? oc1p : oc0p;
  a.out = pool2 ? PackedDst{static_cast<uint8_t*>(dst), n, rows_out / 2,
                            iwp / 2, cp_out, halo_out / 2, oh / 2,
                            col_off_out / 2, ow / 2}
                : PackedDst{static_cast<uint8_t*>(dst), n, rows_out, iwp,
                            cp_out, halo_out, oh, col_off_out, ow};
  a.sum = static_cast<const uint8_t*>(sum);
  a.sum_scale = sum_scale;
  a.rows_sum = rows_sum;
  a.halo_sum = halo_sum;
  a.n = n; a.rows_in = rows_in; a.iwp = iwp; a.halo_in = halo_in;
  a.col_off_in = col_off_in; a.rows_out = rows_out; a.halo_out = halo_out;
  a.col_off_out = col_off_out; a.oh = oh; a.ow = ow;
  a.oy0 = oy0; a.noy = noy;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (raw) return launch<true, false, true>(a, s);
  if (pool2)
    return fuse ? launch<true, true>(a, s) : launch<false, true>(a, s);
  return fuse ? launch<true, false>(a, s) : launch<false, false>(a, s);
}
