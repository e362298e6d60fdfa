// conv_fused_kernel<FUSE, DST>: direct INT8 convolution with the
// requantization epilogue and, when FUSE, the deep-fused 1x1 tail; wgmma on
// tiles that TMA brings into shared memory. convpool_kernel<DST>: the same
// kernel in pool mode, the conv (+ sum) followed by a 2x2/s2 pool in the
// epilogue.
//
// Replaces deepfusion_tpu/ops/conv.py:_conv_kernel and
// deepfusion_tpu/ops/conv.py:_conv_fused_kernel (launcher _conv_pallas),
// with the eltwise-sum post-op and emit_acc1: with DST = DT_ACC the fused
// kernel stores the raw s32 1x1 accumulator, NHWC (n, oh, ow, oc1), with no
// bias, scale or requant (deepfusion_tpu/ops/conv.py:conv_fused_acc1, the
// tensor-parallel local step). In pool mode it replaces
// deepfusion_tpu/ops/convpool.py:_convpool_kernel (launcher
// _convpool_call). conv_fused_s8src_kernel<DST>: the unfused kernel over an
// s8 source (a linear bottleneck's output), its first stage's wgmma s8 x s8;
// the same body, so the u8-source instances are compiled as they were.
//
// Pool mode, per pooled pixel (n, py, px) and channel o, with the four conv
// pixels (2py + dy, 2px + dx) of its window:
//   x_dydx = requant_presat(acc0 [, sum at the conv pixel]): f32 clipped to
//            the dst's range, integral for integer dsts (requant.cuh)
//   max:   y = max(max(x00, x10), max(x01, x11))
//   avg:   y = (((x00 + x01) + x10) + x11) * 0.25f, rounded with the pool's
//          round mode for integer dsts (f32 adds in that order)
//   dst = saturate(y), the one cast
// This is bitwise _requant_presat + the pool + saturate_to of the JAX
// kernel: max commutes with the monotone saturation and is exact in any
// order, and an integer dst's four values are integers below 2^24, so their
// f32 sum is exact. dst is f32, s32, s8 or u8 (an s32 average is refused).
// The tile is 8 pixels wide with even rows and origin, so a warp's 16 rows
// of M are two image rows of 8 pixels: a thread's rows g and g + 8 are the
// window's vertical pair, and its horizontal partner is the lane 4 away
// (an exchange through shared memory: a shuffle would make ptxas serialize
// the kernel's wgmma). Pool mode also splits the output lanes over the
// grid where pixel tiles alone leave SMs idle (make_plan: work items are
// (pixel tile, lane pass) pairs, and the pass may be narrower than a
// wgmma's widest N); the weight maps then have boxes of at most 64 rows,
// and a pass loads nb0 / 64 of them.
//
// What it computes, per output pixel p and channel o:
//   acc0[p,o] = sum_{ki,kj,c} src[n, y*sh-ph+ki, x*sw-pw+kj, c] * w0[o,c,ki,kj]
//   (src u8, or s8 in conv_fused_s8src_kernel; taps outside the image read
//   0: zero padding is exact in either domain, so there is no -128 shift
//   and no correction term)
//   not fused: dst = requant(acc0 [, sum])
//   fused:     mid = requant_to_u8(acc0); acc1 = mid . w1;
//              dst = requant(acc1 [, sum])
// The optional sum operand is NHWC (n, oh, ow, out_oc) of u8, s8, s32 or
// f32; the final stage's epilogue reads it at the output pixel and joins it
// in the JAX package's order (requant.cuh: requant_sum). Whether there is
// one is a uniform branch around the epilogue, and its dtype a switch
// inside it, so it adds no kernel instantiations. The fused kernel with a
// 1-byte dst reads a 1-byte sum whose pitch is a multiple of 16 bytes as
// whole tiles (tiled_sum): each warp copies its rows and lanes of a pass
// into the staging rows with 16-byte cp.async, issued as soon as those rows
// are free (before the tile's 3x3 for the first pass, after the previous
// pass's store for the others), so the copy lands under the wgmma; the
// epilogue waits once and reads each value where its result will be
// staged. Every other sum (4-byte dsts, s32/f32 sums, a ragged pitch, the
// unfused kernel, pool mode) is read a value at a time (load_sum).
//
// What bounds it on the H100: int8 multiply-adds. At FusionNet's full width
// a forward is about 11 G MACs against a few MB of activations, and
// bench.py's dense layer (8x126x126x256 -> 3x3:256 -> 1x1:256) is 83.2 G MAC,
// 0.084 ms at the 1,979 TOP/s dense int8 peak. Only wgmma reaches that
// rate; every block reads all of the weights from L2, so a block covers many
// pixels per weight byte; and the small layers (FusionNet's block2: 6,272
// pixels) must still give every SM a tile.
//
// Design (the packed conv's, csrc/packed_conv.cu, on the dense layout):
// * A tile is tr x tc output pixels of one image, tm = 128 or 64 rows of M.
//   tm = 128: two consumer warpgroups own 64 rows each and all lanes of a
//   pass; tm = 64 ("split"): both own the 64 rows and half the pass's lanes
//   each, so a layer has twice the tiles. The host picks tm (make_plan:
//   64 where 128-pixel tiles fill less than 3/4 of their waves of 132) and
//   the tile's tr x tc pixels (tile_plan: the fewest waves, then tiles).
//   One producer warp keeps TMA loads in flight through a ring of `stages`
//   slots with full/empty mbarriers; setmaxnreg moves registers from the
//   producer warpgroup to the consumers (128 s32 accumulators each). At most
//   one block runs on an SM, so the grid is at most 132 blocks, each walking
//   the same number of work items give or take one (an item is a tile with
//   all its passes; in pool mode one pass of a tile); the ring runs on from
//   one item into the next, so the next item's loads overlap this epilogue.
//   Pool mode's lane split and stacked weight boxes are compiled into its
//   own instances only (the POOL template).
// * A by TMA, one box per tap and K chunk: the NHWC input as a 4-D tensor
//   (c, x, y, n), the box (kc, tc, tr, 1) at (c0, x0*sw - pw + kj,
//   y0*sh - ph + ki, n), every sw-th column and sh-th row (TMA's element
//   strides, at most 8; the wrapper gathers larger strides away). TMA's zero
//   fill outside the tensor is the conv's zero padding, exactly, and reads
//   zeros for the channels past ic of a 32-byte k-step. A 1x1 conv with
//   stride 1 and no padding is a plain GEMM over the flattened pixels: the
//   host runs it as one image of one row, so its tiles are tm consecutive
//   pixels and cross image and batch boundaries.
// * B by TMA from the K-major copies of the weights that ConvOp derives
//   once (ops/layout.py:dense_kmajor_weights): oc0p rows x kh*kw*icp bytes
//   and oc1p rows x k1 bytes. Rows past oc0p (oc1p) up to the pass width
//   read TMA's zero fill. Their tensor maps are encoded once per op
//   (conv_weight_maps); the input's maps at every call (1.7 us each).
// * K runs over (tap, the input's channels padded to a multiple of 32) in
//   chunks of 128, 64 and 32 bytes, each chunk one A box and one B box
//   swizzled to its width; the plan holds the chunks' table (KChunks,
//   wgmma_tma.cuh). wgmma multiplies u8 x s8 (.u8.s8), or with an s8 source
//   s8 x s8 (.s8.s8; S8SRC, the first stage only).
// * The fused intermediate (tm x k1 u8) stays in shared memory in the
//   no-swizzle K-major layout the 1x1's wgmma reads; its channels
//   [oc0, k1) are written as 0.
// * Epilogue: the per-channel parameters sit in shared memory, copied once
//   per block (a missing bias is zeros: adding +0.0 changes no f32 value
//   of an integer), and a pass loads them before it stores anything. A
//   1-byte dst's requant takes one conversion a value: requant_u8 for u8
//   without a sum, else requant_int (the join, ReLU and saturation in
//   integers) with no sum or a 1-byte sum where it is exact (int_sum),
//   else requant_sum. 1-byte dsts
//   are staged in shared memory (the intermediate's own rows when the 1x1
//   needs them no more) and stored 16 bytes a lane where the dst's row
//   pitch oc allows it, byte by byte where it does not; 4-byte dsts go out
//   from the registers, two lanes per 8-byte store where oc is even.
#include <cuda.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>
#include <cstring>

#include "conv.h"
#include "requant.cuh"
#include "wgmma_tma.cuh"

namespace {

constexpr int NTH = 384;            // two consumer warpgroups + the producer's
constexpr int MAX_STAGES = 8;
constexpr int SMEM_LIMIT = 232448;  // opt-in shared memory of a block
constexpr int SMS = 132;            // the H100 SXM's SMs
constexpr int MAX_BOX = 256;        // TMA box elements per dimension
constexpr int MAX_ESTRIDE = 8;      // TMA element stride
constexpr int MAX_CHUNKS = 32;      // K chunks of a tap or of the 1x1

// The conv's geometry as the kernel runs it (a 1x1 GEMM as one image of
// one row of n*oh*ow pixels).
struct Geo {
  int n, ih, iw, ic, oh, ow, kh, kw, sh, sw, ph, pw;
  bool gemm;
};

// The block plan, the same on host and device.
struct Plan {
  int tm, tr, tc, split;         // rows of a tile, its tr x tc pixels
  int tiles_x, tiles_y, tiles;
  int items, blocks;             // blocks walk the work items in turn
  int nb0, nb1, npass0, npass1;  // lanes per pass and passes of each stage
  int bh0;                       // rows of a w0 box: nb0 / bh0 boxes a pass
  int np0, np1;                  // lanes of the staged parameters
  int kp, k1;                    // K bytes per tap and of the 1x1
  KChunks<MAX_CHUNKS> ch0, ch1;  // their K chunks
  int slot_a, slot, stages, mid_off, stage_off, par_off, xchg_off, bar_off;
  int smem;
};

struct KArgs {
  Plan p;
  const float* bias0;
  const float* scale0;
  const float* bias1;
  const float* scale1;
  void* dst;
  const void* sum;  // the sum operand, or null
  float sum_scale;
  int sum_dt;
  int oh, ow, kh, kw, sh, sw, ph, pw;
  int oc0, oc0p, oc1p, out_oc;  // out_oc: the dst's lanes and pitch
  int relu0, relu1, down0, down1, has_bias0, has_bias1;
  int pool_avg, pool_down;      // pool mode: average (else max), its round
};

// Tensor maps: a[w] the input with boxes of 32 << w channels; b0[w], b1[w]
// the K-major w0 and w1 with boxes of 32 << w K bytes by nb0 / nb1 rows.
struct __align__(64) Maps {
  CUtensorMap a[3];
  CUtensorMap b0[3], b1[3];
};

int round_up(int x, int m) { return (x + m - 1) / m * m; }

// pool: pool mode, whose tiles must keep the image's rows (never a GEMM).
Geo geometry(int n, int ih, int iw, int ic, int oh, int ow, int kh, int kw,
             int sh, int sw, int ph, int pw, bool pool) {
  const long long px = (long long)n * oh * ow;
  if (!pool && kh == 1 && kw == 1 && sh == 1 && sw == 1 && ph == 0 &&
      pw == 0 && px < (1LL << 31))
    return Geo{1, 1, (int)px, ic, 1, (int)px, 1, 1, 1, 1, 0, 0, true};
  return Geo{n, ih, iw, ic, oh, ow, kh, kw, sh, sw, ph, pw, false};
}

// Ring slots, the intermediate, the staging rows, the parameters, pool
// mode's exchange (a float4 per consumer thread) and the barriers of a plan
// whose tiling is set; false if they do not fit.
bool layout_smem(Plan& p, bool fuse, bool staged, bool pool) {
  const int kc = p.ch0.widest();
  int b_bytes = p.nb0 * kc;
  if (fuse) b_bytes = std::max(b_bytes, p.nb1 * p.ch1.widest());
  p.slot_a = round_up(p.tm * kc, 1024);  // b_bytes is a multiple of 1024
  p.slot = p.slot_a + b_bytes;
  const int mid = fuse ? p.tm * p.k1 : 0;
  // the final stage's staging rows: the intermediate's own, once the last
  // 1x1 pass has read them, else a buffer of their own
  const int nbf = fuse ? p.nb1 : p.nb0;
  const bool in_mid = fuse && p.npass1 == 1 && nbf <= p.k1;
  const int stage = staged && !in_mid ? p.tm * nbf : 0;
  const int par = 8 * (p.np0 + p.np1);  // bias and scale per lane
  const int xchg = pool ? 16 * 256 : 0;
  const int fixed = 1024 + mid + stage + par + xchg + 2 * MAX_STAGES * 8;
  p.stages = std::min(MAX_STAGES, (SMEM_LIMIT - fixed) / p.slot);
  if (p.stages < 2) return false;
  p.mid_off = p.stages * p.slot;
  p.stage_off = in_mid ? p.mid_off : p.mid_off + mid;
  p.par_off = p.mid_off + mid + stage;
  p.xchg_off = p.par_off + par;
  p.bar_off = p.xchg_off + xchg;
  p.smem = 1024 + p.bar_off + 2 * p.stages * 8;
  return true;
}

// Work items: a tile with all its passes, or in pool mode one pass of a
// tile.
long long item_count(const Plan& p, long long tiles, bool pool) {
  return pool ? tiles * p.npass0 : tiles;
}

// The tiling of one tile size tm: every tc with tr = the most rows that fit
// (tr * tc a multiple of 8, the boxes within TMA's 256 elements); the plan
// with the fewest waves of SMS work items, then the fewest tiles, then the
// fewest input pixels per output pixel. Pool mode takes tc = 8 and tr = tm
// / 8 only (pool_store). False if tm does not fit.
bool tile_plan(Plan& q, const Geo& g, int tm, bool fuse, bool staged,
               bool pool) {
  q.tm = tm;
  q.split = tm == 64;
  if (!layout_smem(q, fuse, staged, pool)) return false;
  bool found = false;
  long long best[3] = {0, 0, 0};
  const int tc_lo = pool ? 8 : 1;
  const int tc_hi = pool ? 8 : std::min(tm, std::min(g.ow, MAX_BOX / g.sw));
  for (int tc = tc_lo; tc <= tc_hi; ++tc) {
    int tr = std::min(tm / tc, MAX_BOX / g.sh);
    while (tr > 0 && (tr * tc) % 8) --tr;
    if (tr == 0 || (pool && tr * tc != tm)) continue;
    const long long tx = (g.ow + tc - 1) / tc, ty = (g.oh + tr - 1) / tr;
    const long long tiles = (long long)g.n * tx * ty;
    const long long items = item_count(q, tiles, pool);
    if (items >= (1LL << 31)) continue;
    const long long key[3] = {
        (items + SMS - 1) / SMS, tiles,
        1024LL * (tr + g.kh - 1) * (tc + g.kw - 1) / (tr * tc)};
    if (found && !std::lexicographical_compare(key, key + 3, best, best + 3))
      continue;
    found = true;
    std::copy(key, key + 3, best);
    q.tr = tr;
    q.tc = tc;
    q.tiles_x = (int)tx;
    q.tiles_y = (int)ty;
    q.tiles = (int)tiles;
    q.items = (int)items;
  }
  return found;
}

// Lanes per pass of a stage of ocp lanes with passes of nb: their count and
// the lanes of the staged parameters.
void set_passes(Plan& p, int ocp, int nb) {
  p.nb0 = nb;
  p.npass0 = (ocp + nb - 1) / nb;
  p.np0 = p.npass0 * nb;
}

// Pool mode's plan: every tile size (128, or 64 split where each
// warpgroup's half of a pass is at least 32 lanes) and every pass width
// from the widest down to the weight box's bh0 rows; the plan whose waves
// of work items times its widest wgmma N per warpgroup (at least 64: a
// narrower wgmma is bound by its shared-memory reads) is least, then the
// fewest items, then 128-pixel tiles. A narrower pass gives more items at
// no cost in bytes: every pass reads the input's boxes again anyway.
bool pool_plan(Plan& p, const Geo& g, int oc0p) {
  const Plan base = p;
  bool found = false;
  long long best[3] = {0, 0, 0};
  for (int tm = 128; tm >= 64; tm -= 64)
    for (int nb = pass_width(oc0p); nb >= base.bh0; nb /= 2) {
      const int nbw = tm == 64 ? nb / 2 : nb;
      if (nbw < 32) continue;
      Plan q = base;
      set_passes(q, oc0p, nb);
      if (!tile_plan(q, g, tm, false, false, true)) continue;
      const long long key[3] = {(q.items + SMS - 1) / SMS * std::max(nbw, 64),
                                q.items, tm == 64};
      if (found && !std::lexicographical_compare(key, key + 3, best, best + 3))
        continue;
      found = true;
      std::copy(key, key + 3, best);
      p = q;
    }
  return found;
}

// The plan: tiles of tm = 128, unless they fill less than 3/4 of their
// waves of SMS and each warpgroup's half of a pass is a wgmma width (nb >=
// 64): then tm = 64 ("split"), twice the tiles. The split narrows each
// wgmma and reads the weights twice as often per pixel, so it pays only
// where the last wave of 128-pixel tiles leaves many SMs idle.
// staged: the dst is 1 byte (its epilogue stages through shared memory).
// pool: pool mode (pool_plan; never fused), whose w0 boxes have bh0 rows.
bool make_plan(Plan& p, const Geo& g, int oc0p, int oc1p, bool fuse,
               bool staged, bool pool, int bh0) {
  p = Plan{};
  p.kp = round_up(g.ic, 32);
  if (!p.ch0.add(p.kp, 0)) return false;
  p.bh0 = bh0;
  set_passes(p, oc0p, pass_width(oc0p));
  if (fuse) {
    p.k1 = round_up(oc0p, 32);
    if (!p.ch1.add(p.k1, 0)) return false;
    p.nb1 = pass_width(oc1p);
    p.npass1 = (oc1p + p.nb1 - 1) / p.nb1;
    p.np1 = p.npass1 * p.nb1;
  }
  if ((long long)g.kh * g.kw * p.kp >= (1LL << 31)) return false;
  if (g.sh > MAX_ESTRIDE || g.sw > MAX_ESTRIDE) return false;
  if (pool) {
    if (fuse || !pool_plan(p, g, oc0p)) return false;
  } else {
    const bool can_split = p.nb0 >= 64 && (!fuse || p.nb1 >= 64);
    Plan wide = p, split = p;
    const bool has_wide = tile_plan(wide, g, 128, fuse, staged, false);
    const bool has_split =
        can_split && tile_plan(split, g, 64, fuse, staged, false);
    if (has_wide &&
        !(has_split && 4LL * wide.items <
                           3LL * SMS * ((wide.items + SMS - 1) / SMS)))
      p = wide;
    else if (has_split)
      p = split;
    else
      return false;
  }
  const int per = (p.items + SMS - 1) / SMS;
  p.blocks = (p.items + per - 1) / per;
  return true;
}

// Tile t's image nn and first output row and column.
struct Tile {
  int nn, y0, x0;
};
__device__ __forceinline__ Tile tile_at(const Plan& p, int t) {
  return Tile{t / (p.tiles_x * p.tiles_y),
              p.tr * ((t / p.tiles_x) % p.tiles_y), p.tc * (t % p.tiles_x)};
}
// Work item w: its tile and its passes [ps0, ps1) of the first stage.
struct Item {
  int t, ps0, ps1;
};
template <bool POOL>
__device__ __forceinline__ Item item_at(const Plan& p, int w) {
  if constexpr (POOL) return Item{w / p.npass0, w % p.npass0, w % p.npass0 + 1};
  return Item{w, 0, p.npass0};
}
// The flat NHWC pixel of row m of a tile, -1 if none.
__device__ __forceinline__ long long pixel_of(const KArgs& a, const Tile& tl,
                                              int m) {
  const Plan& p = a.p;
  if (m >= p.tr * p.tc) return -1;
  const int y = tl.y0 + m / p.tc, x = tl.x0 + m % p.tc;
  if (y >= a.oh || x >= a.ow) return -1;
  return ((long long)tl.nn * a.oh + y) * a.ow + x;
}

// ------------------------------------------------------------ producer
// Every chunk of every work item of the block, in the order the consumers
// take them: the ring runs on from one item into the next. In pool mode a
// pass's w0 rows come in nb0 / bh0 boxes, stacked: bh0 is a multiple of 8
// rows, so the stack is the swizzled layout of one box of nb0 rows.
template <bool FUSE, bool POOL>
__device__ __forceinline__ void produce(const Maps& maps, const KArgs& a,
                                        uint8_t* smem, uint64_t* full,
                                        uint64_t* empty) {
  const Plan& p = a.p;
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
  const int box_px = p.tr * p.tc;
  for (int w = blockIdx.x; w < p.items; w += gridDim.x) {
    const Item it = item_at<POOL>(p, w);
    const Tile tl = tile_at(p, it.t);
    for (int ps = it.ps0; ps < it.ps1; ++ps)
      for (int ki = 0; ki < a.kh; ++ki)
        for (int kj = 0; kj < a.kw; ++kj)
          for (int c = 0; c < p.ch0.n; ++c) {
            const KChunk ch = p.ch0.c[c];
            const int kc = 32 << ch.wcode;
            const int kb = (ki * a.kw + kj) * p.kp + ch.koff;
            uint8_t* s = slot((box_px + p.nb0) * kc);
            tma_load_4d(s, &maps.a[ch.wcode], &full[stage], ch.koff,
                        tl.x0 * a.sw - a.pw + kj, tl.y0 * a.sh - a.ph + ki,
                        tl.nn);
            if constexpr (POOL) {
              for (int r = 0; r < p.nb0; r += p.bh0)
                tma_load_2d(s + p.slot_a + r * kc, &maps.b0[ch.wcode],
                            &full[stage], kb, ps * p.nb0 + r);
            } else {
              tma_load_2d(s + p.slot_a, &maps.b0[ch.wcode], &full[stage], kb,
                          ps * p.nb0);
            }
            next();
          }
    if constexpr (!FUSE) continue;
    for (int ps = 0; ps < p.npass1; ++ps)
      for (int c = 0; c < p.ch1.n; ++c) {
        const KChunk ch = p.ch1.c[c];
        uint8_t* s = slot(p.nb1 * (32 << ch.wcode));
        tma_load_2d(s + p.slot_a, &maps.b1[ch.wcode], &full[stage], ch.koff,
                    ps * p.nb1);
        next();
      }
  }
}

// ------------------------------------------------------------ epilogues
// A thread's accumulator registers of a pass: for n8 block j, register
// 4j + 2h + e holds row m0 + g + 8h (h = 0, 1), lane col0 + 8j + 2t + e.

// How the final stage reads the sum operand: none, a value at a time from
// global memory (load_sum), or from the tile that sum_tile_load copied
// into the staging rows.
enum SumRead { SUM_NONE, SUM_GLOBAL, SUM_TILE };

// Whether the final stage into a 1-byte dst joins its sum operand in the
// integer domain (requant_int): a 1-byte sum (u8 or s8) at |sum_scale| <=
// INT_SUM_SCALE_MAX, the bound of its exactness. Without a sum an s8 dst
// always takes requant_int, a u8 dst requant_u8. What the call shows
// decides, nothing else (ops/conv.py: int_requant counts these launches).
__device__ __forceinline__ bool int_sum(const KArgs& a) {
  return (a.sum_dt == DT_U8 || a.sum_dt == DT_S8) &&
         fabsf(a.sum_scale) <= INT_SUM_SCALE_MAX;
}

// Whether the fused kernel's final stage, into a 1-byte dst, reads the sum
// operand as whole tiles (sum_tile_load): a 1-byte sum joined in the
// integer domain (int_sum) whose pitch out_oc is a multiple of 16 (16-byte
// copies). What the call shows decides, nothing else (ops/conv.py:
// tiled_sum counts these launches).
__device__ __forceinline__ bool tiled_sum(const KArgs& a) {
  return a.sum && int_sum(a) && a.out_oc % 16 == 0;
}

// The sum operand's bytes of the warp's rows m0 + [0, 16) and its lanes
// col0 + [0, nbw) of a pass, copied into the staging rows `stage` where the
// pass's results will be staged (K-major, column kst + the lane's offset):
// lane i takes row i % 16 of granule i / 16, as write_bytes' store does, so
// each 32-byte sector is read whole by two lanes. 16-byte cp.async: the
// copy holds no registers and completes at write_bytes' wait. oc is a
// multiple of 16 (tiled_sum).
__device__ __forceinline__ void sum_tile_load(const KArgs& a, int col0,
                                              int nbw, int kst,
                                              long long spix, uint8_t* stage,
                                              int m0) {
  const int lane = threadIdx.x & 31;
  const int oc = a.out_oc, tm = a.p.tm;
  if (spix < 0 || col0 >= oc) return;
  const int ng = min(nbw, oc - col0) / 16;  // granules
  const uint8_t* src = static_cast<const uint8_t*>(a.sum) + spix * oc + col0;
  const uint32_t s =
      smem_u32(stage + (kst >> 4) * (tm * 16) + (m0 + (lane & 15)) * 16);
  for (int gi = lane >> 4; gi < ng; gi += 2)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                     s + gi * (tm * 16)),
                 "l"(src + 16 * gi) : "memory");
}

// Requantize the warpgroup's pass (lanes col0 + [0, nbw)) to plain u8 into
// the intermediate's K-major layout, byte (m, k) at (k / 16) * tm * 16 +
// m * 16 + k % 16; lanes in [oc0, k1) as 0.
__device__ __forceinline__ void write_mid(const KArgs& a, const float* bias,
                                          const float* scale, uint8_t* mid,
                                          const int32_t (&acc)[128], int col0,
                                          int nbw, int m0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int tm = a.p.tm;
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    if (8 * j >= nbw || col0 + 8 * j >= a.p.k1) break;  // warp-uniform
    const int o = col0 + 8 * j + 2 * t;  // even: the pairs are aligned
    const float2 b = *reinterpret_cast<const float2*>(bias + o);
    const float2 sc = *reinterpret_cast<const float2*>(scale + o);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      uint32_t v = 0;
      if (o < a.oc0) v = requant_u8(acc[4 * j + 2 * h], b.x, sc.x, a.down0);
      if (o + 1 < a.oc0)
        v |= requant_u8(acc[4 * j + 2 * h + 1], b.y, sc.y, a.down0) << 8;
      *reinterpret_cast<uint16_t*>(mid + (o >> 4) * (tm * 16) +
                                   (m0 + g + 8 * h) * 16 + (o & 15)) =
          static_cast<uint16_t>(v);
    }
  }
}

// One value of the final stage, with the sum operand's element at idx when
// SUM.
template <int DST, bool SUM>
__device__ __forceinline__ typename dt_traits<DST>::T final_value(
    const KArgs& a, int32_t x, float b, float s, bool relu, bool down,
    long long idx) {
  if constexpr (SUM)
    return requant_sum<DST>(x, true, b, s, relu, down,
                            load_sum(a.sum, (size_t)idx, a.sum_dt,
                                     a.sum_scale));
  else
    return requant<DST>(x, true, b, s, relu, down);
}

// The final stage's store of a 1-byte dst: requantize the warp's pass into
// byte pairs, stage them in `stage` (the K-major layout, column kst + 8j +
// 2t of the pass, the warp's rows m0 + [0, 16)) and store them 16 bytes a
// lane: lane i takes row i % 16 of granule i / 16, so a warp's shared loads
// meet no bank conflict and each global store fills 32-byte sectors. A
// pitch oc that is no multiple of 16 stores byte by byte. With SUM_TILE
// each value's sum byte sits where its result will be staged
// (sum_tile_load): the warp waits for its copies, then each thread reads
// its byte pairs before it writes any. Each value by requant_int (a 1-byte
// sum's byte widened by sum_byte), but a u8 value without a sum by
// requant_u8, and one with a sum int_sum refuses by requant_sum.
template <int DST, int SUM>
__device__ __forceinline__ void write_bytes(
    const KArgs& a, const int32_t (&acc)[128], const float* bias,
    const float* scale, bool relu, bool down, int col0, int nbw, int kst,
    const long long (&pix)[2], long long spix, uint8_t* stage, int m0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int oc = a.out_oc, tm = a.p.tm;
  const bool sum_s8 = a.sum_dt == DT_S8, ints = int_sum(a);
  if constexpr (SUM == SUM_TILE) {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncwarp();  // the warp's copies, made by other lanes
  }
  uint32_t q[2][16];
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    if (8 * j >= nbw || col0 + 8 * j >= oc) break;  // warp-uniform
    const int o = col0 + 8 * j + 2 * t;
    const int k = kst + 8 * j + 2 * t;
    const float2 b = *reinterpret_cast<const float2*>(bias + o);
    const float2 sc = *reinterpret_cast<const float2*>(scale + o);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      uint32_t sv = 0;  // the two sum bytes (SUM_TILE)
      if constexpr (SUM == SUM_TILE)
        sv = *reinterpret_cast<const uint16_t*>(
            stage + (k >> 4) * (tm * 16) + (m0 + g + 8 * h) * 16 + (k & 15));
      uint32_t v = 0;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (o + e >= oc || (SUM != SUM_NONE && pix[h] < 0)) continue;
        const int32_t x = acc[4 * j + 2 * h + e];
        const float be = e ? b.y : b.x, se = e ? sc.y : sc.x;
        const long long idx = pix[h] * oc + o + e;
        uint8_t u;
        if constexpr (SUM == SUM_TILE)  // tiled_sum: int_sum holds
          u = static_cast<uint8_t>(requant_int<DST>(
              x, be, se, relu, down, true,
              sum_byte((sv >> (8 * e)) & 0xffu, sum_s8), a.sum_scale));
        else if constexpr (SUM == SUM_NONE && DST == DT_U8)
          u = static_cast<uint8_t>(requant_u8(x, be, se, down));
        else if constexpr (SUM == SUM_NONE)
          u = static_cast<uint8_t>(
              requant_int<DST>(x, be, se, relu, down, false, 0, 0.0f));
        else if (ints)  // uniform
          u = static_cast<uint8_t>(requant_int<DST>(
              x, be, se, relu, down, true,
              sum_byte(static_cast<const uint8_t*>(a.sum)[idx], sum_s8),
              a.sum_scale));
        else
          u = static_cast<uint8_t>(
              final_value<DST, true>(a, x, be, se, relu, down, idx));
        v |= uint32_t(u) << (8 * e);
      }
      q[h][j >> 1] = (j & 1) ? q[h][j >> 1] | (v << 16) : v;
    }
  }
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    if (8 * j >= nbw || col0 + 8 * j >= oc) break;  // warp-uniform
    const int k = kst + 8 * j + 2 * t;
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<uint16_t*>(stage + (k >> 4) * (tm * 16) +
                                   (m0 + g + 8 * h) * 16 + (k & 15)) =
          static_cast<uint16_t>(q[h][j >> 1] >> (16 * (j & 1)));
  }
  __syncwarp();
  const int ng = (min(nbw, oc - col0) + 15) / 16;  // granules
  const bool vec = oc % 16 == 0;
  uint8_t* dst = static_cast<uint8_t*>(a.dst);
  for (int i = lane; i < 16 * ng; i += 32) {
    if (spix < 0) break;  // the lane's row, the same at every i
    const int gi = i >> 4;
    const uint8_t* s =
        stage + ((kst >> 4) + gi) * (tm * 16) + (m0 + (lane & 15)) * 16;
    uint8_t* d = dst + spix * oc + col0 + 16 * gi;
    if (vec) {
      *reinterpret_cast<uint4*>(d) = *reinterpret_cast<const uint4*>(s);
    } else {
      for (int e = 0; e < 16 && col0 + 16 * gi + e < oc; ++e) d[e] = s[e];
    }
  }
  __syncwarp();  // the staging rows are free for the next pass
}

// The final stage's store of a 4-byte dst (or the raw accumulator) from
// the registers: two lanes per 8-byte store where oc is even.
template <int DST, bool SUM>
__device__ __forceinline__ void write_words(
    const KArgs& a, const int32_t (&acc)[128], const float* bias,
    const float* scale, bool relu, bool down, int col0, int nbw,
    const long long (&pix)[2]) {
  using T = typename dt_traits<DST == DT_ACC ? DT_S32 : DST>::T;
  const int t = threadIdx.x & 3;
  const int oc = a.out_oc;
  const bool pairs = oc % 2 == 0;
  T* dst = static_cast<T*>(a.dst);
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    if (8 * j >= nbw || col0 + 8 * j >= oc) break;  // warp-uniform
    const int o = col0 + 8 * j + 2 * t;
    const float2 b = *reinterpret_cast<const float2*>(bias + o);
    const float2 sc = *reinterpret_cast<const float2*>(scale + o);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (o >= oc || pix[h] < 0) continue;
      const long long idx = pix[h] * oc + o;
      T v[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int32_t x = acc[4 * j + 2 * h + e];
        if constexpr (DST == DT_ACC)
          v[e] = x;
        else
          v[e] = o + e < oc ? final_value<DST, SUM>(a, x, e ? b.y : b.x,
                                                    e ? sc.y : sc.x, relu,
                                                    down, idx + e)
                            : T(0);
      }
      if (pairs) {
        if constexpr (DST == DT_F32)
          *reinterpret_cast<float2*>(dst + idx) = make_float2(v[0], v[1]);
        else
          *reinterpret_cast<int2*>(dst + idx) = make_int2(v[0], v[1]);
      } else {
        dst[idx] = v[0];
        if (o + 1 < oc) dst[idx + 1] = v[1];
      }
    }
  }
}

// tile: the sum operand was copied into the staging rows (tiled_sum).
template <int DST>
__device__ __forceinline__ void write_final(
    const KArgs& a, const int32_t (&acc)[128], const float* bias,
    const float* scale, bool relu, bool down, int col0, int nbw, int kst,
    const long long (&pix)[2], long long spix, uint8_t* stage, int m0,
    bool tile) {
  if constexpr (DST == DT_U8 || DST == DT_S8) {
    // uniform branches: the unrolled loops carry no test
    if (tile)
      write_bytes<DST, SUM_TILE>(a, acc, bias, scale, relu, down, col0, nbw,
                                 kst, pix, spix, stage, m0);
    else if (a.sum)
      write_bytes<DST, SUM_GLOBAL>(a, acc, bias, scale, relu, down, col0,
                                   nbw, kst, pix, spix, stage, m0);
    else
      write_bytes<DST, SUM_NONE>(a, acc, bias, scale, relu, down, col0, nbw,
                                 kst, pix, spix, stage, m0);
  } else if constexpr (DST == DT_ACC) {
    write_words<DST, false>(a, acc, bias, scale, relu, down, col0, nbw, pix);
  } else {
    if (a.sum)
      write_words<DST, true>(a, acc, bias, scale, relu, down, col0, nbw, pix);
    else
      write_words<DST, false>(a, acc, bias, scale, relu, down, col0, nbw,
                              pix);
  }
}

// Pool mode's store of the warpgroup's pass: requant_presat each conv value
// (with SUM joined with the sum operand at its conv pixel), pool the 2x2
// window (rows h = 0, 1 in the thread, the odd column in the lane 4 away:
// the tile is 8 pixels wide with even rows, tile_plan), saturate once, and
// store from the window's even-column lane at the pooled pixel, two lanes
// per store where the pitch oc is even. The f32 average adds in the JAX
// order; an integer dst's values are exact integers, so any order is. The
// lanes 4 apart swap their values through the warp's 32 float4s xw, not a
// shuffle: a shuffle makes ptxas serialize every wgmma of the kernel.
template <int DST, bool SUM>
__device__ __forceinline__ void write_pool(const KArgs& a,
                                           const int32_t (&acc)[128],
                                           const float* bias,
                                           const float* scale, int col0,
                                           int nbw, const Tile& tl, int m0,
                                           const long long (&pix)[2],
                                           float4* xw) {
  using T = typename dt_traits<DST>::T;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int oc = a.out_oc;
  const int py = (tl.y0 + m0 / 8) >> 1, px = (tl.x0 + g) >> 1;
  const long long q =
      ((long long)tl.nn * (a.oh >> 1) + py) * (a.ow >> 1) + px;
  const bool store = !(g & 1) && pix[0] >= 0;  // the window is in the image
  T* dst = static_cast<T*>(a.dst);
  // The loop's exit depends on nbw alone (col0 depends on the warpgroup, and
  // a __syncwarp in a loop whose exit ptxas cannot prove uniform serializes
  // the kernel's wgmma); lanes o >= oc read parameters inside the np0
  // staged lanes and store nothing.
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    if (8 * j >= nbw) break;
    const int o = col0 + 8 * j + 2 * t;
    const float2 b = *reinterpret_cast<const float2*>(bias + o);
    const float2 sc = *reinterpret_cast<const float2*>(scale + o);
    float x[2][2];  // [e][h]: lane o + e of rows h
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float st = 0.0f;
        if constexpr (SUM)
          if (pix[h] >= 0 && o + e < oc)
            st = load_sum(a.sum, (size_t)(pix[h] * oc + o + e), a.sum_dt,
                          a.sum_scale);
        x[e][h] = requant_presat<DST>(acc[4 * j + 2 * h + e], true,
                                      e ? b.y : b.x, e ? sc.y : sc.x,
                                      a.relu0, a.down0, SUM, st);
      }
    xw[lane] = make_float4(x[0][0], x[0][1], x[1][0], x[1][1]);
    __syncwarp();
    const float4 pp = xw[lane ^ 4];  // the window's other column
    __syncwarp();
    const float px0[2] = {pp.x, pp.z}, px1[2] = {pp.y, pp.w};
    T v[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float y;
      if (!a.pool_avg) {
        y = fmaxf(fmaxf(x[e][0], x[e][1]), fmaxf(px0[e], px1[e]));
      } else {
        y = __fmul_rn(__fadd_rn(__fadd_rn(__fadd_rn(x[e][0], px0[e]),
                                          x[e][1]),
                                px1[e]),
                      0.25f);
        if constexpr (DST != DT_F32) y = round_f32(y, a.pool_down);
      }
      v[e] = saturate<DST>(y);
    }
    if (!store || o >= oc) continue;
    const long long idx = q * oc + o;
    if (oc % 2 == 0) {
      if constexpr (DST == DT_F32)
        *reinterpret_cast<float2*>(dst + idx) = make_float2(v[0], v[1]);
      else if constexpr (DST == DT_S32)
        *reinterpret_cast<int2*>(dst + idx) = make_int2(v[0], v[1]);
      else
        *reinterpret_cast<uint16_t*>(dst + idx) = static_cast<uint16_t>(
            uint8_t(v[0]) | (uint16_t(uint8_t(v[1])) << 8));
    } else {
      dst[idx] = v[0];
      if (o + 1 < oc) dst[idx + 1] = v[1];
    }
  }
}

// ------------------------------------------------------------ consumers
template <bool FUSE, int DST, bool POOL, bool S8SRC>
__device__ __forceinline__ void consume(const KArgs& a, uint8_t* smem,
                                        uint64_t* full, uint64_t* empty) {
  constexpr bool STAGED = DST == DT_U8 || DST == DT_S8;
  const Plan& p = a.p;
  const int wg = threadIdx.x >> 7;
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const bool split = p.split;
  const int row0 = split ? 0 : 64 * wg;  // the warpgroup's rows of M
  const int m0 = row0 + 16 * warp;       // the warp's rows of M
  uint8_t* mid = smem + p.mid_off;
  uint8_t* stg = smem + p.stage_off;  // the final stage's staging rows
  float4* xw = reinterpret_cast<float4*>(smem + p.xchg_off) +
               32 * (threadIdx.x >> 5);  // the warp's exchange (pool mode)
  // the per-channel parameters: bias0, scale0 over np0 lanes, then bias1,
  // scale1 over np1 lanes; lanes past oc0p / oc1p are never used
  float* par = reinterpret_cast<float*>(smem + p.par_off);
  float* par1 = par + 2 * p.np0;
  for (int i = threadIdx.x; i < p.np0; i += 256) {
    const bool in = i < a.oc0p;
    par[i] = in && a.has_bias0 ? a.bias0[i] : 0.0f;
    par[p.np0 + i] = in ? a.scale0[i] : 1.0f;
  }
  for (int i = threadIdx.x; i < p.np1; i += 256) {
    const bool in = i < a.oc1p;
    par1[i] = in && a.has_bias1 ? a.bias1[i] : 0.0f;
    par1[p.np1 + i] = in ? a.scale1[i] : 1.0f;
  }
  named_barrier(3, 256);  // the consumers' copy of the parameters
  // Slots are read in ring order (stage, phase) and released in the same
  // order one chunk later (rstage): a chunk's wgmma group stays in flight
  // while the next chunk's is issued.
  int stage = 0, rstage = 0;
  uint32_t phase = 0;
  auto acquire = [&] {
    mbar_wait(&full[stage], phase);
    __syncwarp();  // wgmma is .aligned: the warp issues it together
    return smem + stage * p.slot;
  };
  auto advance = [&] {
    if (++stage == p.stages) {
      stage = 0;
      phase ^= 1;
    }
  };
  auto release = [&] {
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[rstage]);
    if (++rstage == p.stages) rstage = 0;
  };
  // both warpgroups, or this one, are past their reads of the shared rows
  auto sync_rows = [&] {
    if (split)
      named_barrier(4, 256);
    else
      named_barrier(1 + wg, 128);
  };
  int32_t acc[128];
  const int ntaps = a.kh * a.kw;
  const int nbw0 = split ? p.nb0 / 2 : p.nb0;  // this warpgroup's lanes
  const int nbw1 = split ? p.nb1 / 2 : p.nb1;
  const int kst0 = split ? wg * nbw0 : 0;  // and their offset in the pass
  const int kst1 = split ? wg * nbw1 : 0;
  for (int w = blockIdx.x; w < p.items; w += gridDim.x) {
    const Item it = item_at<POOL>(p, w);
    const Tile tl = tile_at(p, it.t);
    long long pix[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) pix[h] = pixel_of(a, tl, m0 + g + 8 * h);
    const long long spix = pixel_of(a, tl, m0 + (lane & 15));
    // the staging rows are the intermediate's: a sum tile may come in only
    // once the pass's 1x1 has read them
    const bool tile = FUSE && STAGED && tiled_sum(a);
    const bool tile_in_mid = tile && p.stage_off == p.mid_off;
    if (tile && !tile_in_mid)  // the first 1x1 pass's, under the 3x3
      sum_tile_load(a, kst1, nbw1, kst1, spix, stg, m0);
    for (int ps = it.ps0; ps < it.ps1; ++ps) {
      fence_regs(acc);
      bool first = true;
      for (int tap = 0; tap < ntaps; ++tap)
        for (int c = 0; c < p.ch0.n; ++c) {
          const int kc = 32 << p.ch0.c[c].wcode;
          uint8_t* s = acquire();
          const uint32_t sa = smem_u32(s) + row0 * kc;
          const uint32_t sb = smem_u32(s + p.slot_a) + kst0 * kc;
          wgmma_fence();
          for (int kk = 0; kk < kc / 32; ++kk)
            wgmma_step<!S8SRC>(acc, swizzled_desc(sa, kc, kk),
                               swizzled_desc(sb, kc, kk), nbw0,
                               !(first && kk == 0));
          wgmma_commit();
          advance();
          wgmma_wait<1>();  // the previous chunk is done with its slot
          if (!first) release();
          first = false;
        }
      wgmma_wait<0>();
      fence_regs(acc);
      release();
      const int col0 = ps * p.nb0 + kst0;
      if constexpr (FUSE) {
        // in split, the other warpgroup reads these rows in its 1x1 of
        // the last tile
        if (split && ps == 0) named_barrier(4, 256);
        write_mid(a, par, par + p.np0, mid, acc, col0, nbw0, m0);
      } else if constexpr (POOL) {
        // no test of col0 (it depends on the warpgroup) around the pool's
        // __syncwarp: lanes past oc store nothing
        if (a.sum)  // one uniform branch: the unrolled loop carries no test
          write_pool<DST, true>(a, acc, par, par + p.np0, col0, nbw0, tl, m0,
                                pix, xw);
        else
          write_pool<DST, false>(a, acc, par, par + p.np0, col0, nbw0, tl,
                                 m0, pix, xw);
      } else if (col0 < a.out_oc) {
        write_final<DST>(a, acc, par, par + p.np0, a.relu0, a.down0, col0,
                         nbw0, kst0, pix, spix, stg, m0, false);
      }
    }
    if constexpr (FUSE) {
      fence_async_shared();  // the intermediate, for wgmma
      sync_rows();
      const uint32_t sm = smem_u32(mid) + row0 * 16;
      for (int ps = 0; ps < p.npass1; ++ps) {
        fence_regs(acc);
        bool first = true;
        for (int c = 0; c < p.ch1.n; ++c) {
          const KChunk ch = p.ch1.c[c];
          const int kc = 32 << ch.wcode;
          const uint32_t sb = smem_u32(acquire() + p.slot_a) + kst1 * kc;
          wgmma_fence();
          for (int kk = 0; kk < kc / 32; ++kk) {
            const int k = ch.koff + 32 * kk;  // two 16-byte granules
            wgmma_step<true>(acc,
                             smem_desc(sm + (k >> 4) * (p.tm * 16),
                                       p.tm * 16, 128, 0),
                             swizzled_desc(sb, kc, kk), nbw1,
                             !(first && kk == 0));
          }
          wgmma_commit();
          advance();
          wgmma_wait<1>();
          if (!first) release();
          first = false;
        }
        wgmma_wait<0>();
        fence_regs(acc);
        release();
        const int col0 = ps * p.nb1 + kst1;
        // the staging rows may be the intermediate's: every warp that
        // reads them is past its last read
        if (STAGED && p.stage_off == p.mid_off) sync_rows();
        if (tile_in_mid) sum_tile_load(a, col0, nbw1, kst1, spix, stg, m0);
        if (col0 < a.out_oc)
          write_final<DST>(a, acc, par1, par1 + p.np1, a.relu1, a.down1,
                           col0, nbw1, kst1, pix, spix, stg, m0, tile);
        // the next pass's sum tile, under its 1x1
        if (tile && !tile_in_mid && ps + 1 < p.npass1)
          sum_tile_load(a, col0 + p.nb1, nbw1, kst1, spix, stg, m0);
      }
    }
  }
}

// The kernel body, shared by conv_fused_kernel, conv_fused_s8src_kernel
// and convpool_kernel.
template <bool FUSE, int DST, bool POOL, bool S8SRC>
__device__ __forceinline__ void run(const Maps& maps, const KArgs& a) {
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
    setmaxnreg_dec<40>();
    if (threadIdx.x == 256) produce<FUSE, POOL>(maps, a, smem, full, empty);
  } else {
    setmaxnreg_inc<232>();
    consume<FUSE, DST, POOL, S8SRC>(a, smem, full, empty);
  }
}

template <bool FUSE, int DST>
__global__ void __launch_bounds__(NTH, 1)
    conv_fused_kernel(const __grid_constant__ Maps maps,
                      const __grid_constant__ KArgs a) {
  run<FUSE, DST, false, false>(maps, a);
}

// The unfused conv over an s8 source (MobileNetV2's expands and last 1x1,
// which read a linear bottleneck's s8 output).
template <int DST>
__global__ void __launch_bounds__(NTH, 1)
    conv_fused_s8src_kernel(const __grid_constant__ Maps maps,
                            const __grid_constant__ KArgs a) {
  run<false, DST, false, true>(maps, a);
}

template <int DST>
__global__ void __launch_bounds__(NTH, 1)
    convpool_kernel(const __grid_constant__ Maps maps,
                    const __grid_constant__ KArgs a) {
  run<false, DST, true, false>(maps, a);
}

template <class K>
int launch(K kernel, const Maps& maps, const KArgs& a, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, a.p.smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<a.p.blocks, NTH, a.p.smem, stream>>>(maps, a);
  return (int)cudaGetLastError();
}

template <bool FUSE>
int launch_dst(const Maps& maps, const KArgs& a, int dst_dt,
               cudaStream_t stream) {
  switch (dst_dt) {
    case DT_ACC:
      if constexpr (FUSE)
        return launch(conv_fused_kernel<true, DT_ACC>, maps, a, stream);
      return (int)cudaErrorInvalidValue;
    case DT_F32: return launch(conv_fused_kernel<FUSE, DT_F32>, maps, a, stream);
    case DT_S32: return launch(conv_fused_kernel<FUSE, DT_S32>, maps, a, stream);
    case DT_S8: return launch(conv_fused_kernel<FUSE, DT_S8>, maps, a, stream);
    case DT_U8: return launch(conv_fused_kernel<FUSE, DT_U8>, maps, a, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

int launch_pool(const Maps& maps, const KArgs& a, int dst_dt,
                cudaStream_t stream) {
  switch (dst_dt) {
    case DT_F32: return launch(convpool_kernel<DT_F32>, maps, a, stream);
    case DT_S32: return launch(convpool_kernel<DT_S32>, maps, a, stream);
    case DT_S8: return launch(convpool_kernel<DT_S8>, maps, a, stream);
    case DT_U8: return launch(convpool_kernel<DT_U8>, maps, a, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

bool staged_dst(int dst_dt) { return dst_dt == DT_U8 || dst_dt == DT_S8; }

// The rows of a w0 box: the pass width, or in pool mode at most 64, so the
// plan may split the lanes over the grid (pool_plan).
int box_rows(int oc0p, bool pool) {
  return pool ? std::min(64, pass_width(oc0p)) : pass_width(oc0p);
}

// The checks, the plan and the maps shared by conv_fused_launch and
// convpool_launch.
int setup(KArgs& a, Maps& maps, const void* src, const void* wmaps,
          const Geo& g, int oc0p, int oc1p, bool fuse, int dst_dt,
          const void* sum, int sum_dt, bool pool) {
  if (g.ic % 16 || g.ic <= 0 || oc0p % 8 || oc0p <= 0 ||
      (fuse && (oc1p % 8 || oc1p <= 0)))
    return (int)cudaErrorInvalidValue;
  if (sum && sum_dt != DT_F32 && sum_dt != DT_S32 && sum_dt != DT_S8 &&
      sum_dt != DT_U8)
    return (int)cudaErrorInvalidValue;
  if (g.sh < 1 || g.sw < 1 || g.sh > MAX_ESTRIDE || g.sw > MAX_ESTRIDE)
    return (int)cudaErrorInvalidValue;
  a = KArgs{};
  if (!make_plan(a.p, g, oc0p, oc1p, fuse, staged_dst(dst_dt), pool,
                 box_rows(oc0p, pool)))
    return (int)cudaErrorInvalidValue;
  memset(&maps, 0, sizeof(maps));
  memcpy(maps.b0, wmaps, 3 * sizeof(CUtensorMap));
  if (fuse)
    memcpy(maps.b1,
           static_cast<const char*>(wmaps) + 3 * sizeof(CUtensorMap),
           3 * sizeof(CUtensorMap));
  const cuuint64_t c = (cuuint64_t)g.ic;
  const cuuint64_t dims[4] = {c, (cuuint64_t)g.iw, (cuuint64_t)g.ih,
                              (cuuint64_t)g.n};
  const cuuint64_t strides[3] = {c, c * g.iw, c * g.iw * g.ih};
  const cuuint32_t estrides[4] = {1, (cuuint32_t)g.sw, (cuuint32_t)g.sh, 1};
  for (int w = 0; w < 3; ++w) {
    const cuuint32_t box[4] = {32u << w, (cuuint32_t)(a.p.tc * g.sw),
                               (cuuint32_t)(a.p.tr * g.sh), 1};
    if (a.p.ch0.uses(w) &&
        !encode(&maps.a[w], src, 4, dims, strides, box, estrides))
      return (int)cudaErrorInvalidValue;
  }
  a.sum = sum;
  a.sum_dt = sum_dt;
  a.oh = g.oh; a.ow = g.ow; a.kh = g.kh; a.kw = g.kw;
  a.sh = g.sh; a.sw = g.sw; a.ph = g.ph; a.pw = g.pw;
  a.oc0p = oc0p; a.oc1p = fuse ? oc1p : 0;
  return 0;
}

}  // namespace

cudaError_t conv_weight_maps(const void* w0k, int k0, int oc0p,
                             const void* w1k, int k1, int oc1p, bool pool,
                             void* out) {
  CUtensorMap m[6] = {};
  if (!encode_weights(m, w0k, k0, oc0p, box_rows(oc0p, pool)) ||
      (w1k && !encode_weights(m + 3, w1k, k1, oc1p, pass_width(oc1p))))
    return cudaErrorInvalidValue;
  memcpy(out, m, sizeof(m));
  return cudaSuccess;
}

cudaError_t conv_plan(const int* in, int* out) {
  const bool pool = in[16] != 0;
  const Geo g = geometry(in[0], in[1], in[2], in[3], in[4], in[5], in[6],
                         in[7], in[8], in[9], in[10], in[11], pool);
  Plan p;
  if (!make_plan(p, g, in[12], in[13], in[14] != 0, staged_dst(in[15]), pool,
                 box_rows(in[12], pool)))
    return cudaErrorInvalidValue;
  const int v[CONV_PLAN_OUT] = {p.tm, p.tr, p.tc, p.split, p.tiles,
                                p.blocks, p.stages, p.smem, p.nb0, p.nb1,
                                p.npass0, p.npass1, p.ch0.n, p.kp,
                                g.gemm ? 1 : 0, p.items};
  memcpy(out, v, sizeof(v));
  return cudaSuccess;
}

cudaError_t conv_fused_launch(
    const void* src, const void* wmaps, const void* bias0,
    const void* scale0, const void* bias1, const void* scale1, void* dst,
    const void* sum, int n, int ih, int iw, int ic, int oh, int ow, int kh,
    int kw, int sh, int sw, int ph, int pw, int oc0, int oc0p, int oc1,
    int oc1p, int relu0, int relu1, int down0, int down1, int has_bias0,
    int has_bias1, int fuse, int dst_dt, int sum_dt, float sum_scale,
    int src_dt, cudaStream_t stream) {
  if (dst_dt == DT_ACC && (!fuse || sum)) return cudaErrorInvalidValue;
  // an s8 source: the unfused kernel into u8, its one instance
  if (src_dt != DT_U8 && (src_dt != DT_S8 || fuse || dst_dt != DT_U8))
    return cudaErrorInvalidValue;
  const Geo g =
      geometry(n, ih, iw, ic, oh, ow, kh, kw, sh, sw, ph, pw, false);
  KArgs a;
  Maps maps;
  if (int e = setup(a, maps, src, wmaps, g, oc0p, oc1p, fuse != 0, dst_dt,
                    sum, sum_dt, false))
    return static_cast<cudaError_t>(e);
  a.bias0 = static_cast<const float*>(bias0);
  a.scale0 = static_cast<const float*>(scale0);
  a.bias1 = static_cast<const float*>(bias1);
  a.scale1 = static_cast<const float*>(scale1);
  a.dst = dst;
  a.sum_scale = sum_scale;
  a.oc0 = oc0;
  a.out_oc = fuse ? oc1 : oc0;
  a.relu0 = relu0; a.relu1 = relu1; a.down0 = down0; a.down1 = down1;
  a.has_bias0 = has_bias0; a.has_bias1 = has_bias1;
  if (src_dt == DT_S8)
    return static_cast<cudaError_t>(
        launch(conv_fused_s8src_kernel<DT_U8>, maps, a, stream));
  return static_cast<cudaError_t>(
      fuse ? launch_dst<true>(maps, a, dst_dt, stream)
           : launch_dst<false>(maps, a, dst_dt, stream));
}

cudaError_t convpool_launch(
    const void* src, const void* wmaps, const void* bias0,
    const void* scale0, void* dst, const void* sum, int n, int ih, int iw,
    int ic, int oh, int ow, int kh, int kw, int sh, int sw, int ph, int pw,
    int oc0, int oc0p, int relu0, int down0, int has_bias0, int dst_dt,
    int sum_dt, int avg, int pool_down, float sum_scale,
    cudaStream_t stream) {
  if (oh % 2 || ow % 2 || (avg && dst_dt == DT_S32))
    return cudaErrorInvalidValue;
  const Geo g = geometry(n, ih, iw, ic, oh, ow, kh, kw, sh, sw, ph, pw, true);
  KArgs a;
  Maps maps;
  if (int e = setup(a, maps, src, wmaps, g, oc0p, 0, false, dst_dt, sum,
                    sum_dt, true))
    return static_cast<cudaError_t>(e);
  a.bias0 = static_cast<const float*>(bias0);
  a.scale0 = static_cast<const float*>(scale0);
  a.dst = dst;
  a.sum_scale = sum_scale;
  a.oc0 = oc0;
  a.out_oc = oc0;
  a.relu0 = relu0; a.down0 = down0; a.has_bias0 = has_bias0;
  a.pool_avg = avg; a.pool_down = pool_down;
  return static_cast<cudaError_t>(launch_pool(maps, a, dst_dt, stream));
}

