// pair_conv_kernel<FUSE_A, FUSE_B>: two chained stride-1 packed convs,
// each 3x3 (+ the fused 1x1), and an optional 2x2/s2 max pool, in one
// launch; the intermediate image never reaches device memory. wgmma on
// tiles that TMA brings into shared memory.
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
// (packed_conv.cu), and every row layer a reads for an output row of the
// range lies in the slice.
//
// What bounds it on the H100: int8 multiply-adds (VGGFusion's pairs are
// 1.39 G MAC each at batch 8, against 0.4-0.8 MB of packed input; bench.py's
// --pair shape 166.4 G MAC). The pair keeps the layer boundary on chip: one
// packed read and one (pooled) packed write instead of two of each, for
// layer a's recompute of each output tile's halo.
//
// Design (K5's, csrc/packed_conv.cu, with layer b reading layer a's output
// from shared memory):
// * A tile is tr x 8 output pixels of one image (tr = 16: M = 128, each
//   consumer warpgroup on 8 image rows; tr = 8, "split": M = 64, both
//   warpgroups on the 8 rows and half of each pass's lanes), and all output
//   lanes. The host picks tr (make_plan: the least waves of SMS tiles times
//   the wgmma rows a tile runs). One producer warp keeps TMA loads in
//   flight through a ring of `stages` slots with full/empty mbarriers; the
//   producer warpgroup's other three warps write 0x80 over the block's share
//   of the output's non-image slots. At most one block runs on an SM, each
//   walking the same number of tiles give or take one, the ring running on
//   from one tile into the next.
// * Layer a computes the tile's window of the intermediate: mr x mc = (tr +
//   kh_b - 1) x (8 + kw_b - 1) pixels, as M rows in window order, in m64
//   blocks (a warpgroup per block, two blocks an m-pass). Its A operand, per
//   tap and K chunk, is one TMA box of the packed input (a 4-D tensor, the
//   box (kc, mc, mr, 1)) holding the whole window, read as s8 with K5's
//   exact correction 128 * sum(w0) (op_a.corr0); B is op_a's K-major
//   weights. The validated geometry keeps every tap of an intermediate image
//   pixel inside the input array, so TMA's zero fill (u8 128 read as s8 0)
//   reaches only window pixels that are zeroed or whose results feed only
//   dropped outputs. Its requantized plain u8 goes into the window buffer,
//   one plane of window pixels x 16 bytes per 16 lanes; window pixels
//   outside the intermediate image or outside [mlo, mhi) get 0, layer b's
//   padding. The fused 1x1 runs as in K5, from a K-major u8 buffer.
// * Layer b's A comes straight from the window, no copy: for tap (ki, kj)
//   the 8-row core-matrix group of output row r is window row r + ki from
//   column kj, 8 consecutive pixels, 16 bytes apart. So the no-swizzle
//   descriptor starts at that pixel, its SBO (the stride between 8-row
//   groups) is a window row (mc * 16 bytes) and its LBO (between the two
//   16-byte K halves) a plane: every M row is an output pixel, with no junk
//   columns. It multiplies plain u8 (.u8.s8), no correction; B streams
//   op_b's K-major weights through the ring (a 3x3 over 256 lanes is 576 KB,
//   which cannot stay resident).
// * Epilogue: parameters in shared memory, requant_u8; a warp's 16 rows are
//   two output rows of 8 pixels, so the 2x2 pool is one in-thread max and
//   one exchange with the lane 4 away, through shared memory; the unpooled
//   store is staged and stored 16 bytes a lane.
// * No lane shuffle: one makes ptxas serialize every wgmma of the kernel
//   (its C7520 note), and no branch around a wgmma depends on the
//   thread.
// * The producer thread's work per ring slot and the consumers' per chunk
//   sit on the critical path of the small layers, so neither recomputes a
//   chunk's width and offset (the host's KChunks tables in Layer, as every
//   conv kernel reads them) or divides to find a tap.
#include <cuda.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>
#include <cstring>

#include "packed_dst.cuh"
#include "pair_conv.h"
#include "requant.cuh"
#include "wgmma_tma.cuh"

namespace {

constexpr int TC = 8;               // output tile columns: one 8-row group
constexpr int TM = 128;             // rows of the fused 1x1's buffer
constexpr int NTH = 384;            // two consumer warpgroups + the producer's
constexpr int MAX_STAGES = 8;
constexpr int SMEM_LIMIT = 232448;  // opt-in shared memory of a block
constexpr int SMS = 132;            // the H100 SXM's SMs
constexpr int MAX_BOX = 256;        // TMA box elements per dimension
constexpr int MAX_CHUNKS = 32;      // K chunks of a tap, or of a 1x1

int round_up(int x, int m) { return (x + m - 1) / m * m; }

// One layer of the pair, as its PackedConvOp holds it: a kh x kw conv over
// kp lanes per tap (+ the fused 1x1 over oc0p), output lanes oc0p (oc1p).
struct Layer {
  const int32_t* corr0;  // 128 * sum(w0) per channel: layer a only
  const float *bias0, *scale0, *bias1, *scale1;
  int kh, kw, ph, pw, kp;
  int oc0, oc0p, oc1, oc1p, fuse;
  int down0, down1, has_bias0, has_bias1;
  int nb0, npass0, nb1, npass1;  // lanes per pass and passes
  KChunks<MAX_CHUNKS> ch0, ch1;  // K chunks of a tap's kp and the 1x1's oc0p
};

// The block plan, the same on host and device.
struct Plan {
  int tr, split;            // the output tile: tr x TC pixels
  int mr, mc, ma;           // the window: mr x mc pixels, ma = mr * mc
  int mblk, mpass;          // layer a's m64 blocks, in m-passes of two
  int tiles_x, tiles_y, tiles, blocks;
  int kcap;                 // the widest K chunk
  int plane;                // bytes of a window plane (16 lanes)
  int slot_a, slot, stages;
  int win_off, mid_off, stage_off, par_off, xchg_off, bar_off, smem;
};

struct KArgs {
  Plan p;
  Layer la, lb;
  PackedDst out;                  // the output spec (pooled with pool2)
  int iwp, halo_in, col_off_in;   // the input slice
  int mh, mw;                     // the intermediate image
  int oh, ow;                     // layer b's output image
  int pool2;
  int oy0, noy;                   // layer b's image rows computed
  int mlo, mhi;                   // the intermediate's image rows
};

// Tensor maps: a[w] the input with boxes of 32 << w lanes of the window;
// the layers' K-major weights with boxes of 32 << w K bytes by the pass
// width (PackedConvOp's maps, ops/packed.py:_weight_maps).
struct __align__(64) Maps {
  CUtensorMap a[3];
  CUtensorMap wa0[3], wa1[3], wb0[3], wb1[3];
};

// ------------------------------------------------------------ host plan
// A layer's passes and its K chunk tables with chunks of at most cap bytes;
// false if a table would overflow.
bool set_layer_passes(Layer& l, int cap) {
  l.nb0 = pass_width(l.oc0p);
  l.npass0 = (l.oc0p + l.nb0 - 1) / l.nb0;
  l.ch0 = {};
  if (!l.ch0.add(l.kp, 0, cap)) return false;
  if (l.fuse) {
    l.nb1 = pass_width(l.oc1p);
    l.npass1 = (l.oc1p + l.nb1 - 1) / l.nb1;
    l.ch1 = {};
    if (!l.ch1.add(l.oc0p, 0, cap)) return false;
  }
  return true;
}

// Shared memory of a plan whose tile and chunk tables are set: the ring, the
// window, the fused 1x1's buffer, the staging rows of the unpooled store,
// the parameters, the pool's exchange words (a word per consumer thread),
// the barriers. False if fewer than 2 stages fit.
bool layout_smem(Plan& p, const Layer& la, const Layer& lb, bool pool2) {
  p.slot_a = round_up(p.mblk * 64 * la.ch0.widest(), 1024);
  int b = la.nb0 * la.ch0.widest();
  b = std::max(b, lb.nb0 * lb.ch0.widest());
  if (la.fuse) b = std::max(b, la.nb1 * la.ch1.widest());
  if (lb.fuse) b = std::max(b, lb.nb1 * lb.ch1.widest());
  p.slot = p.slot_a + b;  // b is a multiple of 1024
  p.plane = p.ma * 16;
  const int win = (lb.kp / 16) * p.plane;
  const int k1 = std::max(la.fuse ? la.oc0p : 0, lb.fuse ? lb.oc0p : 0);
  const int mid = TM * k1;
  // the final store's staging rows: the 1x1 buffer's own, once the last
  // 1x1 pass has read them, else rows of their own
  const int nbf = lb.fuse ? lb.nb1 : lb.nb0;
  const bool in_mid = lb.fuse && lb.npass1 == 1 && nbf <= lb.oc0p;
  const int stage = pool2 || in_mid ? 0 : TM * nbf;
  const int par = 4 * (3 * la.oc0p + 2 * la.oc1p + 2 * lb.oc0p + 2 * lb.oc1p);
  const int xchg = pool2 ? 4 * 256 : 0;
  const int fixed = 1024 + win + mid + stage + par + xchg + 2 * MAX_STAGES * 8;
  p.stages = std::min(MAX_STAGES, (SMEM_LIMIT - fixed) / p.slot);
  if (p.stages < 2) return false;
  p.win_off = p.stages * p.slot;
  p.mid_off = p.win_off + win;
  p.stage_off = in_mid ? p.mid_off : p.mid_off + mid;
  p.par_off = p.mid_off + mid + stage;
  p.xchg_off = p.par_off + par;
  p.bar_off = p.xchg_off + xchg;
  p.smem = 1024 + p.bar_off + 2 * p.stages * 8;
  return true;
}

// The wgmma work of a layer per M row: K bytes times the lanes its passes
// run, for the 3x3 and the 1x1.
long long row_work(const Layer& l) {
  const long long w =
      (long long)l.kh * l.kw * l.kp * l.npass0 * l.nb0;
  return w + (l.fuse ? (long long)l.oc0p * l.npass1 * l.nb1 : 0);
}

// The plan: tr = 16 or 8 (split, where each warpgroup's half of layer b's
// passes is a wgmma width, nb >= 64), whichever makes the waves of SMS
// tiles times a tile's wgmma rows (layer a's m64 blocks and layer b's
// tile, each weighted by its work per row) least; then the widest chunk
// cap (128, 64, 32 bytes) that fits 3 ring stages, else 2.
bool make_plan(Plan& p, Layer& la, Layer& lb, int n, int noy, int ow,
               bool pool2) {
  bool found = false;
  long long best = 0;
  for (int split = 0; split < 2; ++split) {
    Plan q{};
    q.tr = split ? 8 : 16;
    q.split = split;
    if (!set_layer_passes(la, 32) || !set_layer_passes(lb, 32)) continue;
    if (split && (lb.nb0 < 64 || (lb.fuse && lb.nb1 < 64))) continue;
    q.mr = q.tr + lb.kh - 1;
    q.mc = TC + lb.kw - 1;
    if (q.mr > MAX_BOX || q.mc > MAX_BOX) continue;
    q.ma = q.mr * q.mc;
    q.mblk = (q.ma + 63) / 64;
    q.mpass = (q.mblk + 1) / 2;
    q.tiles_x = (ow + TC - 1) / TC;
    q.tiles_y = (noy + q.tr - 1) / q.tr;
    const long long tiles = (long long)n * q.tiles_x * q.tiles_y;
    if (tiles >= (1LL << 31)) continue;
    q.tiles = (int)tiles;
    bool fits = false;
    for (int least = 3; least >= 2 && !fits; --least)
      for (int cap = 128; cap >= 32 && !fits; cap /= 2) {
        q.kcap = cap;
        set_layer_passes(la, cap);
        set_layer_passes(lb, cap);
        fits = layout_smem(q, la, lb, pool2) && q.stages >= least;
      }
    if (!fits) continue;
    const long long cost =
        (tiles + SMS - 1) / SMS *
        (64LL * q.mblk * row_work(la) + (long long)q.tr * TC * row_work(lb));
    if (found && cost >= best) continue;
    found = true;
    best = cost;
    p = q;
  }
  if (!found) return false;
  set_layer_passes(la, p.kcap);
  set_layer_passes(lb, p.kcap);
  const int per = (p.tiles + SMS - 1) / SMS;
  p.blocks = (p.tiles + per - 1) / per;
  return true;
}

// ------------------------------------------------------------ device
// Tile t's image and the origin of its output pixels and of its window.
struct Tile {
  int nn, oy, ox, wy0, wx0;
};
__device__ __forceinline__ Tile tile_at(const KArgs& a, int t) {
  const Plan& p = a.p;
  Tile tl;
  tl.nn = t / (p.tiles_x * p.tiles_y);
  tl.oy = a.oy0 + p.tr * ((t / p.tiles_x) % p.tiles_y);
  tl.ox = TC * (t % p.tiles_x);
  tl.wy0 = tl.oy - a.lb.ph;
  tl.wx0 = tl.ox - a.lb.pw;
  return tl;
}

// Every chunk of every tile of the block, in the order the consumers take
// them.
__device__ __forceinline__ void produce(const Maps& maps, const KArgs& a,
                                        uint8_t* smem, uint64_t* full,
                                        uint64_t* empty) {
  const Plan& p = a.p;
  const Layer &la = a.la, &lb = a.lb;
  int stage = 0;
  uint32_t phase = 0;
  auto slot = [&](int bytes) {
    mbar_wait(&empty[stage], phase ^ 1);
    mbar_expect_tx(&full[stage], bytes);
    return smem + stage * p.slot;
  };
  auto next = [&] {
    if (++stage == p.stages) {
      stage = 0;
      phase ^= 1;
    }
  };
  // the B boxes of a 1x1's passes
  auto conv1x1 = [&](const Layer& l, const CUtensorMap* m) {
    for (int ps = 0; ps < l.npass1; ++ps)
      for (int c = 0; c < l.ch1.n; ++c) {
        const KChunk ch = l.ch1.c[c];
        uint8_t* s = slot(l.nb1 * (32 << ch.wcode));
        tma_load_2d(s + p.slot_a, &m[ch.wcode], &full[stage], ch.koff,
                    ps * l.nb1);
        next();
      }
  };
  for (int t = blockIdx.x; t < p.tiles; t += gridDim.x) {
    const Tile tl = tile_at(a, t);
    for (int mp = 0; mp < p.mpass; ++mp) {
      for (int ps = 0; ps < la.npass0; ++ps)
        for (int ki = 0; ki < la.kh; ++ki)
          for (int kj = 0; kj < la.kw; ++kj)
            for (int c = 0; c < la.ch0.n; ++c) {
              const int w = la.ch0.c[c].wcode, koff = la.ch0.c[c].koff;
              uint8_t* s = slot((p.ma + la.nb0) * (32 << w));
              tma_load_4d(s, &maps.a[w], &full[stage], koff,
                          a.col_off_in + tl.wx0 - la.pw + kj,
                          a.halo_in + tl.wy0 - la.ph + ki, tl.nn);
              tma_load_2d(s + p.slot_a, &maps.wa0[w], &full[stage],
                          (ki * la.kw + kj) * la.kp + koff, ps * la.nb0);
              next();
            }
      if (la.fuse) conv1x1(la, maps.wa1);
    }
    for (int ps = 0; ps < lb.npass0; ++ps)
      for (int tap = 0; tap < lb.kh * lb.kw; ++tap)
        for (int c = 0; c < lb.ch0.n; ++c) {
          const KChunk ch = lb.ch0.c[c];
          uint8_t* s = slot(lb.nb0 * (32 << ch.wcode));
          tma_load_2d(s + p.slot_a, &maps.wb0[ch.wcode], &full[stage],
                      tap * lb.kp + ch.koff, ps * lb.nb0);
          next();
        }
    if (lb.fuse) conv1x1(lb, maps.wb1);
  }
}

// The epilogue's per-channel parameters in shared memory, copied once per
// block by the consumers: layer a's corr0, bias0, scale0 over oc0p lanes,
// its bias1, scale1 over oc1p, then layer b's. A missing bias is zeros:
// adding +0.0 changes no f32 value of an integer.
struct Params {
  const int32_t* corr_a;
  const float *b0a, *s0a, *b1a, *s1a, *b0b, *s0b, *b1b, *s1b;
};
__device__ __forceinline__ Params stage_params(const KArgs& a,
                                               uint8_t* par) {
  const Layer &la = a.la, &lb = a.lb;
  int32_t* corr = reinterpret_cast<int32_t*>(par);
  float* f = reinterpret_cast<float*>(par) + la.oc0p;
  Params pr;
  pr.corr_a = corr;
  float* at[8];
  const Layer* ls[2] = {&la, &lb};
  for (int l = 0; l < 2; ++l) {
    const Layer& L = *ls[l];
    at[4 * l] = f;
    at[4 * l + 1] = f + L.oc0p;
    at[4 * l + 2] = f + 2 * L.oc0p;
    at[4 * l + 3] = f + 2 * L.oc0p + L.oc1p;
    for (int i = threadIdx.x; i < L.oc0p; i += 256) {
      at[4 * l][i] = L.has_bias0 ? L.bias0[i] : 0.0f;
      at[4 * l + 1][i] = L.scale0[i];
    }
    for (int i = threadIdx.x; i < L.oc1p; i += 256) {
      at[4 * l + 2][i] = L.has_bias1 ? L.bias1[i] : 0.0f;
      at[4 * l + 3][i] = L.scale1[i];
    }
    f += 2 * (L.oc0p + L.oc1p);
  }
  for (int i = threadIdx.x; i < la.oc0p; i += 256) corr[i] = la.corr0[i];
  pr.b0a = at[0]; pr.s0a = at[1]; pr.b1a = at[2]; pr.s1a = at[3];
  pr.b0b = at[4]; pr.s0b = at[5]; pr.b1b = at[6]; pr.s1b = at[7];
  return pr;
}

// The u8 values of the thread's accumulators of one pass (lanes col0 +
// [0, nbw) below lim, lanes >= oc as 0), corr added when not null, as byte
// pairs: the 16-bit half j % 2 of q[h][j / 2] holds lanes col0 + 8j + 2t
// and + 1 of row h. The parameters are read before the caller stores
// anything.
__device__ __forceinline__ void requant_pass(
    const int32_t (&acc)[128], const int32_t* corr, const float* bias,
    const float* scale, bool down, int col0, int nbw, int lim, int oc,
    uint32_t (&q)[2][16]) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    if (8 * j >= nbw || col0 + 8 * j >= lim) break;  // warp-uniform
    const int o = col0 + 8 * j + 2 * t;  // even: the pairs are aligned
    const float2 b = *reinterpret_cast<const float2*>(bias + o);
    const float2 sc = *reinterpret_cast<const float2*>(scale + o);
    const int2 c = corr ? *reinterpret_cast<const int2*>(corr + o)
                        : make_int2(0, 0);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      uint32_t v = 0;
      if (o < oc)
        v = requant_u8(acc[4 * j + 2 * h] + c.x, b.x, sc.x, down);
      if (o + 1 < oc)
        v |= requant_u8(acc[4 * j + 2 * h + 1] + c.y, b.y, sc.y, down) << 8;
      q[h][j >> 1] = (j & 1) ? q[h][j >> 1] | (v << 16) : v;
    }
  }
}

// Store q's byte pairs (XOR-ed with x) in a no-swizzle K-major layout of
// planes of `plane` bytes: byte (m, k) at (k / 16) * plane + m * 16 + k %
// 16, lanes k = kst + 8j + 2t below lim, rows m[0], m[1] (skipped where
// < 0).
__device__ __forceinline__ void store_planes(uint8_t* buf, int plane,
                                             const uint32_t (&q)[2][16],
                                             int nbw, int kst, int lim,
                                             const int (&m)[2], uint32_t x) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    if (8 * j >= nbw || kst + 8 * j >= lim) break;  // warp-uniform
    const int k = kst + 8 * j + 2 * t;
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (m[h] >= 0)
        *reinterpret_cast<uint16_t*>(buf + (k >> 4) * plane + m[h] * 16 +
                                     (k & 15)) =
            static_cast<uint16_t>((q[h][j >> 1] >> (16 * (j & 1))) ^ x);
  }
}

// Layer a's window pixels of rows m[h] (-1 past the window): 1 inside the
// intermediate image and [mlo, mhi), else its value is layer b's padding.
__device__ __forceinline__ bool window_pixel(const KArgs& a, const Tile& tl,
                                             int m) {
  const int y = tl.wy0 + m / a.p.mc, x = tl.wx0 + m % a.p.mc;
  return y >= a.mlo && y < a.mhi && x >= 0 && x < a.mw;
}

// Layer b's final store of the warpgroup's pass (lanes col0 + [0, nbw)):
// u8 ^ 0x80. With pool2 the max of the 2x2 window (rows h = 0, 1 in the
// thread, columns g, g ^ 1 in lanes 4 apart) goes to its pooled slot, two
// lanes per 16-bit store; a max over clamped u8 values is the JAX pool over
// the clamped f32 values: the pack is monotone, and so is rounding. The
// lanes 4 apart swap their column maxima through the warp's 32 words xw,
// not a shuffle: a shuffle makes ptxas serialize every wgmma of the kernel.
// Else the warp stages its 16 pixels in `stage` (K-major, TM rows, lanes
// kst + ..) and stores them 16 bytes a lane: lane i takes row i % 16 of
// granule i / 16.
__device__ __forceinline__ void write_out(const KArgs& a,
                                          const uint32_t (&q)[2][16],
                                          int col0, int nbw, int kst,
                                          const Tile& tl, int m0,
                                          uint8_t* stage, uint32_t* xw) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const PackedDst& d = a.out;
  const int y = tl.oy + m0 / 8, x = tl.ox + g;  // the thread's rows y, y + 1
  if (a.pool2) {
    const bool ok = !(g & 1) && x < a.ow && y < a.oy0 + a.noy;
    const int slot =
        (tl.nn * d.rows + d.halo + y / 2) * d.iwp + d.col_off + x / 2;
    uint8_t* out = d.dst + (size_t)slot * d.cp + col0 + 2 * t;
    // word i of q[h] holds n8 blocks 2i and 2i + 1; nbw, col0 and cp are
    // multiples of 16, so both blocks of a word are in or out together. The
    // loop's exit depends on nbw alone: col0 depends on the warpgroup, and
    // a __syncwarp in a loop whose exit ptxas cannot prove uniform
    // serializes the kernel's wgmma as a shuffle there does
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      if (16 * i >= nbw) break;
      const uint32_t v = __vmaxu4(q[0][i], q[1][i]);
      xw[lane] = v;
      __syncwarp();
      const uint32_t m = __vmaxu4(v, xw[lane ^ 4]) ^ 0x80808080u;
      __syncwarp();
      if (ok && col0 + 16 * i < d.cp) {
        *reinterpret_cast<uint16_t*>(out + 16 * i) =
            static_cast<uint16_t>(m);
        *reinterpret_cast<uint16_t*>(out + 16 * i + 8) =
            static_cast<uint16_t>(m >> 16);
      }
    }
    return;
  }
  const int rows[2] = {m0 + g, m0 + g + 8};
  store_planes(stage, TM * 16, q, nbw, kst, kst + d.cp - col0, rows,
               0x8080u);
  __syncwarp();
  const int ng = min(nbw, d.cp - col0) / 16;  // granules of the pass
  const int r = lane & 15;
  const int yy = tl.oy + (m0 + r) / 8, xx = tl.ox + (m0 + r) % 8;
  const bool in = xx < a.ow && yy < a.oy0 + a.noy;
  const int slot = (tl.nn * d.rows + d.halo + yy) * d.iwp + d.col_off + xx;
  for (int i0 = 0; i0 < 16 * ng; i0 += 32) {  // warp-uniform
    const int gi = (i0 + lane) >> 4;
    if (in && gi < ng)
      *reinterpret_cast<uint4*>(d.dst + (size_t)slot * d.cp + col0 +
                                16 * gi) =
          *reinterpret_cast<const uint4*>(
              stage + ((kst >> 4) + gi) * (TM * 16) + (m0 + r) * 16);
  }
  __syncwarp();  // the staging rows are free for the next pass
}

template <bool FUSE_A, bool FUSE_B>
__device__ __forceinline__ void consume(const KArgs& a, uint8_t* smem,
                                        uint64_t* full, uint64_t* empty) {
  const Plan& p = a.p;
  const Layer &la = a.la, &lb = a.lb;
  const int wg = threadIdx.x >> 7;
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2;
  uint8_t* win = smem + p.win_off;
  uint8_t* mid = smem + p.mid_off;
  uint8_t* stg = smem + p.stage_off;
  uint32_t* xw = reinterpret_cast<uint32_t*>(smem + p.xchg_off) +
                 32 * (threadIdx.x >> 5);  // the warp's exchange words
  const Params pr = stage_params(a, smem + p.par_off);
  named_barrier(3, 256);  // the consumers' copy of the parameters
  int stage = 0, rstage = 0;
  uint32_t phase = 0;
  auto acquire = [&] {
    mbar_wait(&full[stage], phase);
    __syncwarp();  // wgmma is .aligned: the warp issues it together
    return smem + stage * p.slot;
  };
  auto release = [&] {
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[rstage]);
    if (++rstage == p.stages) rstage = 0;
  };
  int32_t acc[128];
  // One pass's K loop of n chunks: chunk c's slot, then the wgmma group of
  // step(c, slot). Slots are released `depth` chunks late: two groups stay
  // in flight while the next one is issued (one where the ring has only two
  // stages, which the consumer must not hold both of). Both warpgroups
  // issue every group (an idle one multiplies a block again and stores
  // nothing), so no branch around a wgmma depends on the thread.
  const int depth = p.stages > 2 ? 2 : 1;
  auto k_loop = [&](int n, auto step) {
    fence_regs(acc);
    for (int c = 0; c < n; ++c) {
      uint8_t* s = acquire();
      wgmma_fence();
      step(c, s, c == 0);
      wgmma_commit();
      if (++stage == p.stages) {
        stage = 0;
        phase ^= 1;
      }
      if (depth == 2) wgmma_wait<2>();
      else wgmma_wait<1>();
      if (c >= depth) release();
    }
    wgmma_wait<0>();
    fence_regs(acc);
    for (int c = 0; c < n && c < depth; ++c) release();
  };
  // the 1x1 of a layer over the warpgroup's rows of `mid` (row0 + [0, 64)),
  // its passes' lanes [kst, kst + nbw); out(col0, nbw) stores each pass
  auto conv1x1 = [&](const Layer& l, int row0, int nbw, int kst, auto out) {
    const uint32_t sm = smem_u32(mid) + row0 * 16;
    for (int ps = 0; ps < l.npass1; ++ps) {
      k_loop(l.ch1.n, [&](int c, uint8_t* s, bool first) {
        const KChunk ch = l.ch1.c[c];
        const int kc = 32 << ch.wcode;
        const uint32_t sb = smem_u32(s + p.slot_a) + kst * kc;
        for (int kk = 0; kk < kc / 32; ++kk) {
          const int k = ch.koff + 32 * kk;
          wgmma_step<true>(acc, smem_desc(sm + (k >> 4) * (TM * 16), TM * 16,
                                          128, 0),
                           swizzled_desc(sb, kc, kk), nbw, !(first && kk == 0));
        }
      });
      out(ps * l.nb1 + kst, nbw);
    }
  };
  // ---- the tiles
  const bool split = p.split;
  const int nbwb0 = split ? lb.nb0 / 2 : lb.nb0;  // layer b's lanes a pass
  const int nbwb1 = split ? lb.nb1 / 2 : lb.nb1;
  const int kst0 = split ? wg * nbwb0 : 0, kst1 = split ? wg * nbwb1 : 0;
  const int rowb = split ? 0 : 64 * wg;  // layer b's M rows of the warpgroup
  for (int t = blockIdx.x; t < p.tiles; t += gridDim.x) {
    const Tile tl = tile_at(a, t);
    named_barrier(4, 256);  // layer b of the last tile is done with the window
    // layer a: the window, m64 block 2 mp + wg of each m-pass; a warpgroup
    // past the last block multiplies block 0 again and stores nothing
    for (int mp = 0; mp < p.mpass; ++mp) {
      const int blk = 2 * mp + wg;
      const int ablk = blk < p.mblk ? blk : 0;
      int wm[2];    // the thread's window rows, -1 past the window
      bool in[2];   // inside the intermediate image and [mlo, mhi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = 64 * blk + 16 * warp + g + 8 * h;
        wm[h] = m < p.ma ? m : -1;
        in[h] = wm[h] >= 0 && window_pixel(a, tl, wm[h]);
      }
      const int mrow[2] = {64 * wg + 16 * warp + g,
                           64 * wg + 16 * warp + g + 8};
      // the window's values of one pass of lanes [col0, col0 + nb): 0
      // outside the image and [mlo, mhi), layer b's padding
      auto to_window = [&](const int32_t* corr, const float* bias,
                           const float* scale, bool down, int col0, int nb,
                           int oc) {
        uint32_t q[2][16];
        requant_pass(acc, corr, bias, scale, down, col0, nb, lb.kp, oc, q);
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int i = 0; i < 16; ++i) q[h][i] = in[h] ? q[h][i] : 0u;
        store_planes(win, p.plane, q, nb, col0, lb.kp, wm, 0u);
      };
      for (int ps = 0; ps < la.npass0; ++ps) {
        int ci = 0;  // chunk c's index within its tap
        k_loop(la.kh * la.kw * la.ch0.n,
               [&](int c, uint8_t* s, bool first) {
                 const int kc = 32 << la.ch0.c[ci].wcode;
                 if (++ci == la.ch0.n) ci = 0;
                 const uint32_t sa = smem_u32(s) + ablk * 64 * kc;
                 const uint32_t sb = smem_u32(s + p.slot_a);
                 for (int kk = 0; kk < kc / 32; ++kk)
                   wgmma_step<false>(acc, swizzled_desc(sa, kc, kk),
                                     swizzled_desc(sb, kc, kk), la.nb0,
                                     !(first && kk == 0));
               });
        if constexpr (FUSE_A) {
          uint32_t q[2][16];
          requant_pass(acc, pr.corr_a, pr.b0a, pr.s0a, la.down0,
                       ps * la.nb0, la.nb0, la.oc0p, la.oc0, q);
          store_planes(mid, TM * 16, q, la.nb0, ps * la.nb0, la.oc0p, mrow,
                       0u);
        } else {
          to_window(pr.corr_a, pr.b0a, pr.s0a, la.down0, ps * la.nb0, la.nb0,
                    la.oc0);
        }
      }
      if constexpr (FUSE_A) {
        fence_async_shared();  // the 1x1's input, for wgmma
        named_barrier(1 + wg, 128);
        conv1x1(la, 64 * wg, la.nb1, 0, [&](int col0, int nb) {
          to_window(nullptr, pr.b1a, pr.s1a, la.down1, col0, nb, la.oc1);
        });
        named_barrier(1 + wg, 128);  // the next m-pass rewrites these rows
      }
    }
    fence_async_shared();  // the window, for wgmma
    named_barrier(4, 256);
    // layer b: A from the window, tap (ki, kj) at window row r + ki of
    // output row r, column kj
    const int mrow[2] = {rowb + 16 * warp + g, rowb + 16 * warp + g + 8};
    auto store_final = [&](const float* bias, const float* scale, bool down,
                           int col0, int nbw, int kst, int oc) {
      uint32_t q[2][16] = {};
      requant_pass(acc, nullptr, bias, scale, down, col0, nbw, a.out.cp, oc,
                   q);
      write_out(a, q, col0, nbw, kst, tl, rowb + 16 * warp, stg, xw);
    };
    const uint32_t sw = smem_u32(win) + (rowb / 8) * p.mc * 16;
    for (int ps = 0; ps < lb.npass0; ++ps) {
      int ci = 0, ki = 0, kj = 0;  // chunk c's index in its tap, the tap
      k_loop(lb.kh * lb.kw * lb.ch0.n,
             [&](int c, uint8_t* s, bool first) {
               const KChunk ch = lb.ch0.c[ci];
               const int kc = 32 << ch.wcode;
               const uint32_t sa = sw + (ki * p.mc + kj) * 16;
               if (++ci == lb.ch0.n) {
                 ci = 0;
                 if (++kj == lb.kw) {
                   kj = 0;
                   ++ki;
                 }
               }
               const uint32_t sb = smem_u32(s + p.slot_a) + kst0 * kc;
               for (int kk = 0; kk < kc / 32; ++kk) {
                 const int k = ch.koff + 32 * kk;
                 wgmma_step<true>(acc,
                                  smem_desc(sa + (k >> 4) * p.plane, p.plane,
                                            p.mc * 16, 0),
                                  swizzled_desc(sb, kc, kk), nbwb0,
                                  !(first && kk == 0));
               }
             });
      const int col0 = ps * lb.nb0 + kst0;
      if constexpr (FUSE_B) {
        uint32_t q[2][16];
        requant_pass(acc, nullptr, pr.b0b, pr.s0b, lb.down0, col0, nbwb0,
                     lb.oc0p, lb.oc0, q);
        store_planes(mid, TM * 16, q, nbwb0, col0, lb.oc0p, mrow, 0u);
      } else {
        store_final(pr.b0b, pr.s0b, lb.down0, col0, nbwb0, kst0, lb.oc0);
      }
    }
    if constexpr (FUSE_B) {
      fence_async_shared();  // the 1x1's input, for wgmma
      if (split) named_barrier(4, 256);
      else named_barrier(1 + wg, 128);
      conv1x1(lb, rowb, nbwb1, kst1, [&](int col0, int nb) {
        // the staging rows may be the 1x1 buffer's: every warp that reads
        // them is past its last read
        if (!a.pool2 && p.stage_off == p.mid_off) {
          if (split) named_barrier(4, 256);
          else named_barrier(1 + wg, 128);
        }
        store_final(pr.b1b, pr.s1b, lb.down1, col0, nb, kst1, lb.oc1);
      });
    }
  }
}

template <bool FUSE_A, bool FUSE_B>
__global__ void __launch_bounds__(NTH, 1)
    pair_conv_kernel(const __grid_constant__ Maps maps,
                     const __grid_constant__ KArgs a) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = smem_u32(smem_raw);
  uint8_t* smem = smem_raw + (((base + 1023) & ~1023u) - base);
  const Plan& p = a.p;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + p.bar_off);
  uint64_t* empty = full + p.stages;
  if (threadIdx.x == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();
  if (threadIdx.x >= 256) {  // the producer warpgroup
    setmaxnreg_dec<56>();
    const int w = (threadIdx.x - 256) >> 5;
    if (w == 0) {
      if (threadIdx.x == 256) produce(maps, a, smem, full, empty);
    } else {  // three warps fill the block's rows of the output's pads
      fill_pad_rows(a.out, blockIdx.x * 3 + w - 1, gridDim.x * 3);
    }
  } else {
    setmaxnreg_inc<224>();
    consume<FUSE_A, FUSE_B>(a, smem, full, empty);
  }
}

template <bool FA, bool FB>
int launch(const Maps& maps, const KArgs& a, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      pair_conv_kernel<FA, FB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      a.p.smem);
  if (e != cudaSuccess) return (int)e;
  pair_conv_kernel<FA, FB><<<a.p.blocks, NTH, a.p.smem, stream>>>(maps, a);
  return (int)cudaGetLastError();
}

// One layer from its ints: kh, kw, ph, pw, kp (K bytes per tap: the
// input's lanes), oc0, oc0p, oc1, oc1p, down0, down1, has_bias0,
// has_bias1, fuse; and its operand pointers corr0, bias0, scale0, bias1,
// scale1 (the 1x1's null when not fused).
bool make_layer(Layer& l, const int* v, const void* const* ops) {
  l = Layer{};
  l.kh = v[0]; l.kw = v[1]; l.ph = v[2]; l.pw = v[3]; l.kp = v[4];
  l.oc0 = v[5]; l.oc0p = v[6]; l.oc1 = v[7]; l.oc1p = v[8];
  l.down0 = v[9]; l.down1 = v[10]; l.has_bias0 = v[11]; l.has_bias1 = v[12];
  l.fuse = v[13];
  if (!l.fuse) l.oc1p = 0;
  l.corr0 = static_cast<const int32_t*>(ops[0]);
  l.bias0 = static_cast<const float*>(ops[1]);
  l.scale0 = static_cast<const float*>(ops[2]);
  l.bias1 = static_cast<const float*>(ops[3]);
  l.scale1 = static_cast<const float*>(ops[4]);
  return l.kh > 0 && l.kw > 0 && l.kp > 0 && l.kp % 32 == 0 && l.oc0p > 0 &&
         l.oc0p % 32 == 0 && (!l.fuse || (l.oc1p > 0 && l.oc1p % 32 == 0));
}

// geo: n, iwp, rows_in, halo_in, col_off_in, mh, mw, oh, ow, rows_out,
// halo_out, col_off_out, pool2, oy0, noy, mlo, mhi (rows_in/halo_in and
// rows_out/halo_out those of the slice and of the output range, the halos
// re-based).
int make_args(KArgs& a, const void* const* ops_a, const void* const* ops_b,
              void* dst, const int* ia, const int* ib, const int* geo) {
  a = KArgs{};
  if (!make_layer(a.la, ia, ops_a) || !make_layer(a.lb, ib, ops_b))
    return (int)cudaErrorInvalidValue;
  const int n = geo[0];
  a.iwp = geo[1];
  const int rows_in = geo[2];
  a.halo_in = geo[3]; a.col_off_in = geo[4];
  a.mh = geo[5]; a.mw = geo[6]; a.oh = geo[7]; a.ow = geo[8];
  const int rows_out = geo[9], halo_out = geo[10], col_off_out = geo[11];
  a.pool2 = geo[12];
  a.oy0 = geo[13]; a.noy = geo[14]; a.mlo = geo[15]; a.mhi = geo[16];
  if (a.noy < 1 || a.oy0 < 0 || a.oy0 + a.noy > a.oh || a.mlo >= a.mhi ||
      (a.pool2 && (a.oy0 % 2 || a.noy % 2)))
    return (int)cudaErrorInvalidValue;
  const int cp_mid = a.la.fuse ? a.la.oc1p : a.la.oc0p;
  if (cp_mid != a.lb.kp) return (int)cudaErrorInvalidValue;
  if (a.pool2 && (a.oh % 2 || a.ow % 2 || halo_out % 2 || col_off_out % 2 ||
                  a.iwp % 16))
    return (int)cudaErrorInvalidValue;
  if ((long long)n * rows_in * a.iwp >= (1LL << 31) ||
      (long long)n * rows_out * a.iwp >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const int cp_out = a.lb.fuse ? a.lb.oc1p : a.lb.oc0p;
  uint8_t* d = static_cast<uint8_t*>(dst);
  a.out = a.pool2 ? PackedDst{d, n, rows_out / 2, a.iwp / 2, cp_out,
                              halo_out / 2, a.oh / 2, col_off_out / 2,
                              a.ow / 2}
                  : PackedDst{d, n, rows_out, a.iwp, cp_out, halo_out, a.oh,
                              col_off_out, a.ow};
  return make_plan(a.p, a.la, a.lb, n, a.noy, a.ow, a.pool2 != 0)
             ? 0
             : (int)cudaErrorInvalidValue;
}

}  // namespace

cudaError_t pair_conv_launch(const void* src, const void* const* ops_a,
                             const void* const* ops_b, void* dst,
                             const int* ia, const int* ib, const int* geo,
                             cudaStream_t stream) {
  KArgs a;
  if (int e = make_args(a, ops_a, ops_b, dst, ia, ib, geo))
    return static_cast<cudaError_t>(e);
  Maps maps;
  memset(&maps, 0, sizeof(maps));
  // each layer's six maps, copied byte for byte from the host buffer
  constexpr size_t MAP3 = 3 * sizeof(CUtensorMap);
  const char* wa = static_cast<const char*>(ops_a[5]);
  const char* wb = static_cast<const char*>(ops_b[5]);
  memcpy(maps.wa0, wa, MAP3);
  memcpy(maps.wb0, wb, MAP3);
  if (a.la.fuse) memcpy(maps.wa1, wa + MAP3, MAP3);
  if (a.lb.fuse) memcpy(maps.wb1, wb + MAP3, MAP3);
  const cuuint64_t cp = (cuuint64_t)a.la.kp;
  const cuuint64_t dims[4] = {cp, (cuuint64_t)a.iwp, (cuuint64_t)geo[2],
                              (cuuint64_t)geo[0]};
  const cuuint64_t strides[3] = {cp, cp * a.iwp, cp * a.iwp * geo[2]};
  for (int w = 0; w < 3; ++w) {
    const cuuint32_t box[4] = {32u << w, (cuuint32_t)a.p.mc,
                               (cuuint32_t)a.p.mr, 1};
    if (a.la.ch0.uses(w) && !encode(&maps.a[w], src, 4, dims, strides, box))
      return cudaErrorInvalidValue;
  }
  int e;
  if (a.la.fuse)
    e = a.lb.fuse ? launch<true, true>(maps, a, stream)
                  : launch<true, false>(maps, a, stream);
  else
    e = a.lb.fuse ? launch<false, true>(maps, a, stream)
                  : launch<false, false>(maps, a, stream);
  return static_cast<cudaError_t>(e);
}

cudaError_t pair_plan(const int* ia, const int* ib, const int* geo,
                      int* out) {
  const void* none[PAIR_LAYER_PTRS] = {};
  KArgs a;
  if (int e = make_args(a, none, none, nullptr, ia, ib, geo))
    return static_cast<cudaError_t>(e);
  const Plan& p = a.p;
  const int v[PAIR_PLAN_OUT] = {p.tr, TC, p.split, p.tiles, p.blocks,
                                p.stages, p.smem, p.kcap, p.ma, p.mblk};
  memcpy(out, v, sizeof(v));
  return cudaSuccess;
}
