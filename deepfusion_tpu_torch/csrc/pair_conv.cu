// pair_conv_kernel<FUSE_A, FUSE_B>: two chained stride-1 packed convs,
// each 3x3 (+ the fused 1x1), and an optional 2x2/s2 max pool, in one
// launch; the intermediate image never reaches device memory.
//
// Replaces deepfusion_tpu/ops/mega.py:_pair_kernel (launcher _pair_call):
// VGGFusion's conv3x3+ReLU -> conv3x3+ReLU -> maxpool2 block, with the
// sequence-parallel modes (mid_bounds, t_range/row0_off/offs).
//
// What it computes: out = op_b(op_a(x)), then the 2x2/s2 max pool when
// pool2, where op_a and op_b are packed convs (packed_conv.cu) and op_a's
// output is the intermediate image: layer b reads it with u8 zero outside
// the image, its conv padding. The input x is a packed image (the bytes
// layer a reads: the taps of the intermediate's image pixels, pads
// included); the output is a packed image at sout, or at its pooled spec,
// with 0x80 in every non-image slot. Bitwise the composition of the two
// packed conv kernels through any intermediate spec.
// Sequence-parallel modes (ops/mega.py: PackedConvPairOp.forward): the
// intermediate's image rows are [mlo, mhi) (default [0, mh)); a shard
// widens them past its own image so layer b reads rows layer a computes
// from the exchanged halo. Layer b computes its image rows [oy0, oy0 +
// noy) only, into an array of a row range of the output; the input may be
// a row slice. The host re-bases halo_in and halo_out as for K5
// (packed_conv.cu), and every row layer a reads must lie in the slice.
//
// What bounds it on the H100: int8 multiply-adds (VGGFusion's pairs are
// 1.39 G MAC each at batch 8, against 0.4-0.8 MB of packed input). The
// pair keeps the layer boundary on chip: one packed read and one (pooled)
// packed write instead of two of each, for layer a's recompute of the
// output tile's halo.
//
// Design:
// * A block owns a TR x TC tile of output pixels of one image and all
//   output lanes. The host picks the tile (pick_tile): the largest of a few
//   even shapes whose shared memory fits and that fills the card.
// * Stage 1, layer a: every intermediate pixel of the tile's window (the
//   tile widened by kh_b - 1 rows and kw_b - 1 columns), clipped to the
//   intermediate image, computed in M passes of 32 * 8 / wc pixels with
//   K5's machinery (packed_common.cuh: the packed K loop with the 0x80
//   XOR, the fused 1x1), requantized to plain u8 into a shared-memory tile
//   of the whole window, all lanes. Window slots outside the intermediate
//   image hold 0, the padding layer b must see.
// * Stage 2, layer b: M passes over the output tile; the A fragments come
//   straight from the shared tile, four rows per thread at the tile index
//   of their tap (no copy, no XOR); B streams through shared memory in K
//   chunks, double-buffered, as in K5 (a 3x3 over 256 lanes is 576 KB of
//   weights, which cannot stay resident). Epilogue: requant (+ the 1x1),
//   then K5's store: plain at sout, or, with pool2, M ordered so a 2x2
//   window is four consecutive rows and pooled by two warp shuffles.
// * Each block also writes 0x80 over its share of the output's pads.
// * Later work: thread-block clusters sharing halo rows through distributed
//   shared memory (no recompute), wgmma and TMA.
#include <cuda_runtime.h>

#include <cstdint>

#include "packed_common.cuh"

namespace {

struct PairArgs {
  const uint8_t* src;  // the packed input: n x rows_in x iwp x a.icp
  Stage a, b;
  PackedDst out;       // the output spec (pooled with pool2)
  int n, iwp, rows_in, halo_in, col_off_in;
  int mh, mw;          // the intermediate image
  int oh, ow;          // layer b's output image
  int rows_out, halo_out, col_off_out;  // the unpooled output spec
  int pool2;
  int oy0, noy;        // layer b's image rows computed
  int mlo, mhi;        // the intermediate's image rows
  int tr, tc;          // the output tile of a block
  int ldt;             // row pitch of the shared tile in words
};

// Shared memory of a block, the same on host and device: the two weight
// buffers (pitch ldw, the wider stage's), layer a's two input buffers, the
// fused 1x1's u8 buffer (the larger stage's), the per-row ints and the tile.
struct PairSmem {
  Smem la, lb;
  size_t w_words, mid1_words, pix_ints, tile_words;
  __host__ __device__ explicit PairSmem(const PairArgs& a)
      : la(a.a), lb(a.b) {
    const int ldw = la.ldw > lb.ldw ? la.ldw : lb.ldw;
    la.ldw = lb.ldw = ldw;
    w_words = (size_t)KCW * ldw;
    const size_t ma = a.a.fuse ? la.mid_words : 0;
    const size_t mb = a.b.fuse ? lb.mid_words : 0;
    mid1_words = ma > mb ? ma : mb;
    pix_ints = 3 * (size_t)(la.m > lb.m ? la.m : lb.m);
    tile_words = (size_t)(a.tr + a.b.kh - 1) * (a.tc + a.b.kw - 1) * a.ldt;
  }
  __host__ __device__ size_t bytes() const {
    return 4 * (2 * w_words + 2 * la.in_words + mid1_words + pix_ints +
                tile_words);
  }
};

// The window of output tile (ty, tx): the intermediate pixels layer a
// computes for it, the tile widened by kh_b - 1 rows and kw_b - 1 columns
// (origin y0, x0), of which rows [ylo, ylo + vr) and columns [xlo, xlo +
// vc) lie inside the intermediate image (rows [mlo, mhi)) and are read by
// an output row of the range.
struct Window {
  int y0, x0, ylo, xlo, vr, vc;
  __host__ __device__ Window(const PairArgs& a, int ty, int tx) {
    y0 = a.oy0 + ty * a.tr - a.b.ph;
    x0 = tx * a.tc - a.b.pw;
    ylo = y0 > a.mlo ? y0 : a.mlo;
    xlo = x0 > 0 ? x0 : 0;
    const int need = a.oy0 + a.noy - a.b.ph + a.b.kh - 1;
    int yhi = y0 + a.tr + a.b.kh - 1;
    yhi = yhi < need ? yhi : need;
    const int xhi = x0 + a.tc + a.b.kw - 1;
    vr = (yhi < a.mhi ? yhi : a.mhi) - ylo;
    vc = (xhi < a.mw ? xhi : a.mw) - xlo;
    vr = vr > 0 ? vr : 0;
    vc = vc > 0 ? vc : 0;
  }
};

// acc += A[32 rows of the warp, ksteps*32 channels] * B[.., 64 columns],
// where the thread's four A rows (mi * 16 + g + 8h) start at r[mi][h].
__device__ __forceinline__ void mma_rows(int32_t (&acc)[MI][NI][4],
                                         const uint32_t* const (&r)[MI][2],
                                         const uint32_t* B, int ldb,
                                         int ksteps, int ntiles, int g,
                                         int t) {
  for (int ks = 0; ks < ksteps; ++ks) {
    uint32_t af[MI][4];
#pragma unroll
    for (int mi = 0; mi < MI; ++mi) {
      af[mi][0] = r[mi][0][ks * 8 + t];
      af[mi][1] = r[mi][1][ks * 8 + t];
      af[mi][2] = r[mi][0][ks * 8 + t + 4];
      af[mi][3] = r[mi][1][ks * 8 + t + 4];
    }
    const uint32_t* b = B + (ks * 8 + t) * ldb + g;
#pragma unroll
    for (int ni = 0; ni < NI; ++ni) {
      if (ni < ntiles) {  // warp-uniform
        const uint32_t b0 = b[ni * 8], b1 = b[4 * ldb + ni * 8];
#pragma unroll
        for (int mi = 0; mi < MI; ++mi) mma_u8s8(acc[mi][ni], af[mi], b0, b1);
      }
    }
  }
}

// acc = layer b's conv of the block's L.m rows over channels [n0, n0 +
// nbv): row p's tap (ki, kj) is tile pixel s_pix[3p] + ki * mc + kj, read
// in place from the u8 tile (pitch ldt words); the weights stream through
// s_w one tap and kcw words at a time.
__device__ __forceinline__ void tile_pass(const Stage& st, const Smem& L,
                                          const uint32_t* s_tile, int ldt,
                                          int mc, uint32_t* const (&s_w)[2],
                                          const int* s_pix, int n0, int nbv,
                                          int ntiles,
                                          int32_t (&acc)[MI][NI][4]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wr = warp / st.wc, wc = warp % st.wc;
  int rowi[MI][2];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      rowi[mi][h] = s_pix[3 * (wr * 32 + mi * 16 + g + 8 * h)];
  const int icp4 = st.icp / 4;
  const int cpt = icp4 / st.kcw;
  const int nchunks = st.kh * st.kw * cpt;
  auto issue = [&](int c, int b) {
    const int tap = c / cpt, c40 = (c - tap * cpt) * st.kcw;
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
    const int tap = c / cpt, c40 = (c - tap * cpt) * st.kcw;
    const int ki = tap / st.kw, kj = tap - ki * st.kw;
    const int toff = ki * mc + kj;
    const uint32_t* r[MI][2];
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        r[mi][h] = s_tile + (size_t)(rowi[mi][h] + toff) * ldt + c40;
    mma_rows(acc, r, s_w[c & 1] + wc * 64, L.ldw, st.kcw / 8, ntiles, g, t);
    __syncthreads();  // buffer c&1 is refilled by the next issue
  }
}

// Layer b's final store: K5's store loop without a sum operand, plain or
// pooled, picked by one uniform branch.
__device__ __forceinline__ void store_b(const PairArgs& a,
                                        const int32_t (&acc)[MI][NI][4],
                                        const int* s_pix, int n0, int wcn,
                                        int oc, bool has_bias,
                                        const float* bias, const float* scale,
                                        bool down, int ntiles) {
  if (a.pool2)
    store_out<true>(a.out, acc, s_pix, n0, wcn, oc, has_bias, bias, scale,
                    down, ntiles);
  else
    store_out<false>(a.out, acc, s_pix, n0, wcn, oc, has_bias, bias, scale,
                     down, ntiles);
}

template <bool FUSE_A, bool FUSE_B>
__global__ void __launch_bounds__(NT, 1) pair_conv_kernel(PairArgs a) {
  fill_pads(a.out, blockIdx.x, gridDim.x);
  extern __shared__ __align__(16) uint32_t smem[];
  const PairSmem S(a);
  const Smem& La = S.la;
  const Smem& Lb = S.lb;
  uint32_t* s_w[2] = {smem, smem + S.w_words};
  uint32_t* s_in[2] = {smem + 2 * S.w_words,
                       smem + 2 * S.w_words + La.in_words};
  uint32_t* s_mid1 = smem + 2 * (S.w_words + La.in_words);
  int* s_pix = reinterpret_cast<int*>(s_mid1 + S.mid1_words);
  uint32_t* s_tile = reinterpret_cast<uint32_t*>(s_pix + S.pix_ints);
  uint8_t* tile8 = reinterpret_cast<uint8_t*>(s_tile);

  const int tid = threadIdx.x;
  const Stage& A = a.a;
  const Stage& B = a.b;
  const int tiles_x = (a.ow + a.tc - 1) / a.tc;
  const int tiles_y = (a.noy + a.tr - 1) / a.tr;
  const int tx = blockIdx.x % tiles_x;
  const int ty = (blockIdx.x / tiles_x) % tiles_y;
  const int nn = blockIdx.x / (tiles_x * tiles_y);
  const int ty0 = a.oy0 + ty * a.tr, tx0 = tx * a.tc;
  const int mr = a.tr + B.kh - 1, mc = a.tc + B.kw - 1;  // the tile window
  const Window W(a, ty, tx);
  const int y0 = W.y0, x0 = W.x0, ylo = W.ylo, xlo = W.xlo, vc = W.vc;

  // window slots outside the intermediate image (rows [mlo, mhi)): u8 0,
  // layer b's padding
  const int wpp = B.icp / 4;  // words of one intermediate pixel
  for (int e = tid; e < mr * mc * wpp; e += NT) {
    const int px = e / wpp;
    const int my = px / mc, mx = px - my * mc;
    const int y = y0 + my, x = x0 + mx;
    if (y < a.mlo || y >= a.mhi || x < 0 || x >= a.mw)
      s_tile[(size_t)px * a.ldt + (e - px * wpp)] = 0u;
  }
  if (FUSE_A || FUSE_B) {  // channels [oc0, k1) of the 1x1's input stay 0
    for (size_t e = tid; e < S.mid1_words; e += NT) s_mid1[e] = 0u;
  }

  PackedSrc in = {};
  in.src[0] = a.src;
  in.src_cp[0] = A.icp;
  in.n_src = 1;
  int32_t acc[MI][NI][4];
  const int wca = (tid >> 5) % A.wc, wcb = (tid >> 5) % B.wc;

  // stage 1: layer a over the window's image pixels, La.m rows at a time
  const int cnt = W.vr * vc;
  for (int base = 0; base < cnt; base += La.m) {
    __syncthreads();  // s_pix and s_mid1 are free again
    for (int p = tid; p < La.m; p += NT) {
      const int i = base + p;
      int src = -1, idx = -1;
      if (i < cnt) {
        const int y = ylo + i / vc, x = xlo + i % vc;
        src = (nn * a.rows_in + a.halo_in + y - A.ph) * a.iwp +
              a.col_off_in + x - A.pw;
        idx = (y - y0) * mc + (x - x0);
      }
      s_pix[3 * p] = src;
      s_pix[3 * p + 1] = idx;
      s_pix[3 * p + 2] = -1;
    }
    __syncthreads();
    for (int n0 = 0; n0 < A.oc0p; n0 += La.nb) {
      const int nbv = min(La.nb, A.oc0p - n0);
      const int ntiles = min(NI, max(0, (nbv - wca * 64) / 8));
      packed_pass(in, A, a.iwp, La, s_in, s_w, s_pix, n0, nbv, ntiles, acc);
      if constexpr (FUSE_A)
        store_u8<false>(reinterpret_cast<uint8_t*>(s_mid1), La.ldm * 4,
                        s_pix, acc, n0, A.wc, A.oc0, A.has_bias0, A.bias0,
                        A.scale0, A.down0, ntiles);
      else
        store_u8<true>(tile8, a.ldt * 4, s_pix, acc, n0, A.wc, A.oc0,
                       A.has_bias0, A.bias0, A.scale0, A.down0, ntiles);
    }
    if constexpr (FUSE_A) {
      for (int n0 = 0; n0 < A.oc1p; n0 += La.nb) {
        const int nbv = min(La.nb, A.oc1p - n0);
        const int ntiles = min(NI, max(0, (nbv - wca * 64) / 8));
        conv1x1_pass(A, La, s_mid1, s_w, n0, nbv, ntiles, acc);
        store_u8<true>(tile8, a.ldt * 4, s_pix, acc, n0, A.wc, A.oc1,
                       A.has_bias1, A.bias1, A.scale1, A.down1, ntiles);
      }
    }
  }

  // stage 2: layer b over the output tile, Lb.m rows at a time
  const int npx = a.tr * a.tc;
  const int tc2 = a.tc / 2;
  for (int base = 0; base < npx; base += Lb.m) {
    __syncthreads();  // the tile is complete; s_pix and s_mid1 are free
    for (int p = tid; p < Lb.m; p += NT) {
      const int r = base + p;
      int idx = 0, slot = -1;
      if (r < npx) {
        int ry, rx;
        if (a.pool2) {  // r = 4 * window + (dy, dx)
          const int q = r >> 2;
          ry = 2 * (q / tc2) + ((r >> 1) & 1);
          rx = 2 * (q % tc2) + (r & 1);
        } else {
          ry = r / a.tc;
          rx = r - ry * a.tc;
        }
        idx = ry * mc + rx;
        const int oy = ty0 + ry, ox = tx0 + rx;
        if (oy < a.oy0 + a.noy && ox < a.ow)
          slot = a.pool2 ? (nn * a.out.rows + a.out.halo + oy / 2) *
                                   a.out.iwp + a.out.col_off + ox / 2
                         : (nn * a.rows_out + a.halo_out + oy) * a.iwp +
                               a.col_off_out + ox;
      }
      s_pix[3 * p] = idx;
      s_pix[3 * p + 1] = slot;
      s_pix[3 * p + 2] = -1;
    }
    __syncthreads();
    for (int n0 = 0; n0 < B.oc0p; n0 += Lb.nb) {
      const int nbv = min(Lb.nb, B.oc0p - n0);
      const int ntiles = min(NI, max(0, (nbv - wcb * 64) / 8));
      tile_pass(B, Lb, s_tile, a.ldt, mc, s_w, s_pix, n0, nbv, ntiles, acc);
      if constexpr (FUSE_B)
        store_u8<false>(reinterpret_cast<uint8_t*>(s_mid1), Lb.ldm * 4,
                        s_pix, acc, n0, B.wc, B.oc0, B.has_bias0, B.bias0,
                        B.scale0, B.down0, ntiles);
      else
        store_b(a, acc, s_pix, n0, B.wc, B.oc0, B.has_bias0, B.bias0,
                B.scale0, B.down0, ntiles);
    }
    if constexpr (FUSE_B) {
      for (int n0 = 0; n0 < B.oc1p; n0 += Lb.nb) {
        const int nbv = min(Lb.nb, B.oc1p - n0);
        const int ntiles = min(NI, max(0, (nbv - wcb * 64) / 8));
        conv1x1_pass(B, Lb, s_mid1, s_w, n0, nbv, ntiles, acc);
        store_b(a, acc, s_pix, n0, B.wc, B.oc1, B.has_bias1, B.bias1,
                B.scale1, B.down1, ntiles);
      }
    }
  }
}

// The output tiles tried, largest first; all even, for the pool.
constexpr int TILES[][2] = {{16, 16}, {16, 8}, {8, 8}, {8, 4},
                            {4, 4},   {4, 2},  {2, 2}};

int blocks_of(const PairArgs& a) {
  return a.n * ((a.noy + a.tr - 1) / a.tr) * ((a.ow + a.tc - 1) / a.tc);
}

// Pick a.tr, a.tc: among the tiles whose shared memory fits, the first
// that holds at least one M pass of layer b and makes one block per SM,
// else, among those holding an M pass, the one with the most blocks, else
// the largest that fits. Returns 0, or an error if none fits.
int pick_tile(PairArgs& a) {
  int dev = 0, sms = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (e != cudaSuccess) return (int)e;
  const int mb = Smem(a.b).m;
  int best = -1, best_blocks = -1, first_fit = -1;
  for (int i = 0; i < int(sizeof(TILES) / sizeof(TILES[0])); ++i) {
    a.tr = TILES[i][0];
    a.tc = TILES[i][1];
    if (PairSmem(a).bytes() > (size_t)optin) continue;
    if (first_fit < 0) first_fit = i;
    if (a.tr * a.tc < mb) continue;
    const int blocks = blocks_of(a);
    if (blocks >= sms) {
      best = i;
      break;
    }
    if (blocks > best_blocks) {
      best = i;
      best_blocks = blocks;
    }
  }
  if (best < 0) best = first_fit;
  if (best < 0) return (int)cudaErrorInvalidConfiguration;
  a.tr = TILES[best][0];
  a.tc = TILES[best][1];
  return 0;
}

template <bool FA, bool FB>
int launch(const PairArgs& a, cudaStream_t stream) {
  const size_t smem = PairSmem(a).bytes();
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        pair_conv_kernel<FA, FB>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  pair_conv_kernel<FA, FB><<<blocks_of(a), NT, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// One stage from its ints: kh, kw, ph, pw, icp, oc0, oc0p, oc1, oc1p,
// down0, down1, has_bias0, has_bias1, fuse; and its six operand pointers
// w0, bias0, scale0, w1, bias1, scale1.
bool make_stage(Stage& s, const int* v, const void* const* ops) {
  s.kh = v[0]; s.kw = v[1]; s.ph = v[2]; s.pw = v[3]; s.icp = v[4];
  s.oc0 = v[5]; s.oc0p = v[6]; s.oc1 = v[7]; s.oc1p = v[8];
  s.down0 = v[9]; s.down1 = v[10]; s.has_bias0 = v[11]; s.has_bias1 = v[12];
  s.fuse = v[13];
  s.w0 = static_cast<const int32_t*>(ops[0]);
  s.bias0 = static_cast<const float*>(ops[1]);
  s.scale0 = static_cast<const float*>(ops[2]);
  s.w1 = static_cast<const int32_t*>(ops[3]);
  s.bias1 = static_cast<const float*>(ops[4]);
  s.scale1 = static_cast<const float*>(ops[5]);
  if (s.icp <= 0 || s.icp % 32 || s.oc0p <= 0 || s.oc0p % 32 ||
      (s.fuse && (s.oc1p <= 0 || s.oc1p % 32)))
    return false;
  pick_stage_tiles(s);
  return true;
}

// geo: n, iwp, rows_in, halo_in, col_off_in, mh, mw, oh, ow, rows_out,
// halo_out, col_off_out, pool2, oy0, noy, mlo, mhi (rows_in/halo_in and
// rows_out/halo_out those of the slice and of the output range, the halos
// re-based).
int make_args(PairArgs& a, const void* src, const void* const* ops_a,
              const void* const* ops_b, void* dst, const int* ia,
              const int* ib, const int* geo) {
  a = {};
  if (!make_stage(a.a, ia, ops_a) || !make_stage(a.b, ib, ops_b))
    return (int)cudaErrorInvalidValue;
  a.src = static_cast<const uint8_t*>(src);
  a.n = geo[0]; a.iwp = geo[1]; a.rows_in = geo[2]; a.halo_in = geo[3];
  a.col_off_in = geo[4]; a.mh = geo[5]; a.mw = geo[6]; a.oh = geo[7];
  a.ow = geo[8]; a.rows_out = geo[9]; a.halo_out = geo[10];
  a.col_off_out = geo[11]; a.pool2 = geo[12];
  a.oy0 = geo[13]; a.noy = geo[14]; a.mlo = geo[15]; a.mhi = geo[16];
  if (a.noy < 1 || a.oy0 < 0 || a.oy0 + a.noy > a.oh || a.mlo >= a.mhi ||
      (a.pool2 && (a.oy0 % 2 || a.noy % 2)))
    return (int)cudaErrorInvalidValue;
  const int cp_mid = a.a.fuse ? a.a.oc1p : a.a.oc0p;
  if (cp_mid != a.b.icp) return (int)cudaErrorInvalidValue;
  a.ldt = cp_mid / 4 + 4;  // == 4 mod 8: eight tile rows hit 32 banks
  if (a.pool2 && (a.oh % 2 || a.ow % 2 || a.halo_out % 2 ||
                  a.col_off_out % 2 || a.iwp % 16))
    return (int)cudaErrorInvalidValue;
  if ((long long)a.n * a.rows_in * a.iwp >= (1LL << 31) ||
      (long long)a.n * a.rows_out * a.iwp >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const int cp_out = a.b.fuse ? a.b.oc1p : a.b.oc0p;
  uint8_t* d = static_cast<uint8_t*>(dst);
  a.out = a.pool2 ? PackedDst{d, a.n, a.rows_out / 2, a.iwp / 2, cp_out,
                              a.halo_out / 2, a.oh / 2, a.col_off_out / 2,
                              a.ow / 2}
                  : PackedDst{d, a.n, a.rows_out, a.iwp, cp_out, a.halo_out,
                              a.oh, a.col_off_out, a.ow};
  return pick_tile(a);
}

}  // namespace

// src: the packed input; ops_a/ops_b: each stage's six operand pointers
// (ops/layout.py layouts, as df_packed_conv takes them; the 1x1's null
// when not fused); ia/ib: each stage's 14 ints (make_stage); geo: 17 ints
// (make_args). dst: the packed output (rows of it), pooled when pool2.
extern "C" int df_pair_conv(const void* src, const void* const* ops_a,
                            const void* const* ops_b, void* dst,
                            const int* ia, const int* ib, const int* geo,
                            void* stream) {
  PairArgs a;
  if (int e = make_args(a, src, ops_a, ops_b, dst, ia, ib, geo)) return e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a.a.fuse)
    return a.b.fuse ? launch<true, true>(a, s) : launch<true, false>(a, s);
  return a.b.fuse ? launch<false, true>(a, s) : launch<false, false>(a, s);
}

// The tiling df_pair_conv would launch, for the record: out[0..4] = the
// output tile's rows and columns, the number of blocks, the shared memory
// bytes of a block, and the intermediate pixels layer a computes for one
// image (every tile's Window). No launch.
extern "C" int df_pair_plan(const int* ia, const int* ib, const int* geo,
                            int* out) {
  const void* none[6] = {};
  PairArgs a;
  if (int e = make_args(a, nullptr, none, none, nullptr, ia, ib, geo))
    return e;
  out[0] = a.tr;
  out[1] = a.tc;
  out[2] = blocks_of(a);
  out[3] = (int)PairSmem(a).bytes();
  out[4] = 0;
  for (int ty = 0; ty < (a.noy + a.tr - 1) / a.tr; ++ty)
    for (int tx = 0; tx < (a.ow + a.tc - 1) / a.tc; ++tx) {
      const Window w(a, ty, tx);
      out[4] += w.vr * w.vc;
    }
  return 0;
}
