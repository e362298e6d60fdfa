// packed_conv_kernel<MODE>: stride-1 INT8 convolution in the packed domain,
// with the requantization epilogue and, when fused, the deep-fused 1x1
// tail; wgmma on tiles that TMA brings into shared memory.
//
// Replaces deepfusion_tpu/ops/packed.py:_packed_kernel (launcher
// _packed_call) for 1..4 inputs, u8 destination, with the packed sum
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
// operand is read at its own halo; its slots outside the image are never
// read.
// With pool2 the output is the 2x2/s2 max of those u8 values (the sum
// joined first, at full resolution), stored ^ 0x80 at the pooled spec's
// slot (halo_out / 2 + y / 2, col_off_out / 2 + x / 2) of rows iwp / 2 wide.
// With merge (a pooled, unfused 1x1 with no padding whose output lanes are
// its joined input lanes: FusionNet's residual conv) the residual sum joins
// before the pool, after the clamp:
//   v = min(requant_to_u8(acc0) + u8(src[halo_in + y, col_off_in + x, o]),
//           255)
// (lanes >= oc: the input byte alone), and the output is the 2x2/s2 max of
// v: bitwise packed_sum_relu_maxpool2 of the inputs and the conv's output.
// The input byte is read from the A tile in shared memory, which holds
// exactly those pixels and lanes: the pass keeps its ring slots until its
// epilogue has read them.
// With RAW (fused, no pool, no sum: the tensor-parallel local step) the
// output is an s32 array of the output spec holding acc1 = mid . w1 at
// image slots (pad lanes 0: their w1 columns are 0) and 0 elsewhere.
// Row range (sequence-parallel interior/boundary split): the kernel
// computes the image rows [oy0, oy0 + noy) only and writes an array of the
// output rows [r0, r0 + rows) (pooled rows with pool2); the input may be a
// row slice of the full array. The host passes rows_out, halo_out and
// halo_in re-based by the range's first row and the slice's first row
// (either may be negative); every tap of the computed pixels lies in the
// slice.
//
// What bounds it on the H100: int8 multiply-adds. bench.py's default layer
// (8x126x126x256 -> 3x3:256 -> 1x1:256) is 83.2 G MAC, 0.084 ms at the
// 1,979 TOP/s dense int8 peak, against 33 MB of packed input and output.
// Only wgmma reaches that rate; and every block reads all of the weights
// (655 KB for that layer) from L2, so a block must cover many pixels per
// weight byte. Next to the K loop, the epilogue is the cost: it turns
// every accumulator into a u8 through f32 (twice when fused), and a first
// version of this kernel spent more time there than in its wgmma.
//
// Design:
// * A block owns a TR x TC = 16 x 8 tile of output pixels of one image
//   (M = 128) and all output lanes, in passes of nb0 <= 256 lanes. Two
//   consumer warpgroups each own 64 rows of M (8 image rows) and issue
//   wgmma m64n{nb}k32; one producer warp keeps TMA loads in flight through
//   a ring of `stages` slots with full/empty mbarriers; the producer
//   warpgroup's other three warps write 0x80 over the block's share of the
//   output's non-image slots, a row of the array per warp. setmaxnreg moves
//   registers from the producer warpgroup to the consumers (128 s32
//   accumulators each). At most one block runs on an SM (its shared
//   memory), so the grid is at most 132 blocks, each walking the same
//   number of tiles give or take one; the ring runs on from one tile into
//   the next, so the next tile's loads overlap this tile's epilogue.
// * A by TMA, without an index list: for tap (ki, kj) and a K chunk of one
//   source's lanes, the A operand of the tile is one box of the source
//   viewed as a 4-D tensor (n, rows, iwp, cp), at (n, halo_in + y0 - ph +
//   ki, col_off_in + x0 - pw + kj, lane0). The validated geometry (halo_in
//   >= ph, col_off_in >= pw, right margin >= kw - 1 - pw) puts every tap of
//   an image pixel inside the array, so TMA's zero fill (outside the array)
//   reaches only pixels past the image or the row range, whose results are
//   dropped: a zero byte would read as u8 128.
// * The stored bytes are read as s8 (u8 - 128) by wgmma .s8.s8, and the
//   accumulator gets the exact correction 128 * sum(w0) per output channel
//   (ops/layout.py:u8_shift_correction, the JAX package's device): u8 =
//   s8 + 128 holds for every stored byte, image, pad or junk, so the
//   accumulator is bitwise the u8 one. The fused 1x1 reads the plain u8
//   intermediate the kernel wrote itself, with .u8.s8 and no correction.
// * K runs over (tap, source, the source's lanes padded to a multiple of
//   32): a 16-lane remainder of a source reads 16 lanes of TMA zero fill
//   against zero weights, so no 32-byte k-step straddles two sources. Each
//   source's lanes go in chunks of 128, then 64, then 32 bytes, each chunk
//   one A box and one B box swizzled to its width.
// * B by TMA from K-major copies of the weights that PackedConvOp derives
//   once (ops/layout.py:kmajor_weights): N rows x K bytes in the kernel's K
//   order. Their tensor maps are encoded once per op
//   (packed_weight_maps); the activations' maps are encoded per call.
//   cuTensorMapEncodeTiled is reached through cudaGetDriverEntryPoint, so
//   the library needs no link to the driver library.
// * The fused intermediate (M x oc0p u8) stays in shared memory in the
//   no-swizzle K-major layout the 1x1's wgmma reads. Each consumer
//   warpgroup writes and reads only its own 64 rows of it.
// * Epilogue: per warp, 16 rows of M are two image rows of 8 pixels, so a
//   thread's registers of rows g and g + 8 are the two rows of one column:
//   the 2x2 pool is one in-thread max and one __shfl_xor_sync(.., 4). The
//   per-channel parameters (correction, bias, scale) sit in shared memory,
//   copied once per block: read from global memory at every value they
//   cost more than the requant itself. A pass loads its parameters before
//   it stores anything, and the u8 requant takes one int-to-float
//   conversion (requant_u8: the rounding and the clamp by a magic-number
//   add and integer ops, bitwise requant_to_u8). The final stage stages
//   its pixels in shared memory (the intermediate's own rows when the 1x1
//   needs them no more) and stores 16 bytes a lane, full 32-byte sectors.
#include <cuda.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>
#include <cstring>

#include "packed_conv.h"
#include "packed_dst.cuh"
#include "requant.cuh"
#include "wgmma_tma.cuh"

namespace {

constexpr int TR = 16, TC = 8, TM = TR * TC;  // a block's output tile
constexpr int NTH = 384;            // two consumer warpgroups + the producer's
constexpr int MAX_CHUNKS = 16;      // K chunks per tap or 1x1
constexpr int MAX_STAGES = 8;
constexpr int SMEM_LIMIT = 232448;  // opt-in shared memory of a block
constexpr int SMS = 132;            // the H100 SXM's SMs
constexpr int MODE_FUSE = 1, MODE_POOL = 2, MODE_RAW = 4, MODE_MERGE = 8;

// The block plan, the same on host and device.
struct Plan {
  int tiles_x, tiles_y, tiles, blocks;  // blocks walk the tiles in turn
  int nb0, nb1, npass0, npass1;  // lanes per pass and passes of each stage
  int kp;                        // K bytes per tap
  // K chunks (wgmma_tma.cuh): kc = 32 << wcode bytes of source src's lanes
  // from lane0, at K offset koff of the tap (of oc0p for the 1x1, src -1)
  KChunks<MAX_CHUNKS> ch0, ch1;
  int slot_a, slot, stages, mid_off, stage_off, par_off, bar_off, smem;
};

struct KArgs {
  Plan p;
  const int32_t* corr0;  // 128 * sum(w0) per output channel
  const float* bias0;
  const float* scale0;
  const float* bias1;
  const float* scale1;
  PackedDst out;          // the output spec (pooled with pool2)
  const uint8_t* sum;     // the packed sum operand, or null
  float sum_scale;
  int rows_sum, halo_sum;
  int iwp, halo_in, col_off_in, col_off_out, ow;
  int kh, kw, ph, pw;
  int oc0, oc0p, oc1, oc1p;  // oc1p 0 unfused
  int down0, down1, has_bias0, has_bias1;
  int oy0, noy;  // the image rows computed
};

// Tensor maps: a[s][w] source s with boxes of 32 << w lanes; b0[w], b1[w]
// the K-major w0 and w1 with boxes of 32 << w K bytes by nb0 / nb1 rows.
struct __align__(64) Maps {
  CUtensorMap a[MAX_SRC][3];
  CUtensorMap b0[3], b1[3];
};

// staged: the final stage stores through shared memory (not pooled, not
// the raw accumulator). merge: a pass holds its chunks' slots until its
// epilogue, so the ring must hold them all.
bool make_plan(Plan& p, int n, int noy, int ow, int n_src, const int* cps,
               int kh, int kw, int oc0p, int oc1p, bool fuse, bool staged,
               bool merge) {
  p = Plan{};
  p.tiles_x = (ow + TC - 1) / TC;
  p.tiles_y = (noy + TR - 1) / TR;
  const long long tiles = (long long)n * p.tiles_x * p.tiles_y;
  if (tiles >= (1LL << 31)) return false;
  p.tiles = (int)tiles;
  // at most one block per SM (its shared memory), each the same number of
  // tiles give or take one
  const int per = (p.tiles + SMS - 1) / SMS;
  p.blocks = (p.tiles + per - 1) / per;
  p.kp = 0;
  for (int s = 0; s < n_src; ++s) {
    const int kpad = (cps[s] + 31) / 32 * 32;
    if (!p.ch0.add(kpad, p.kp, 128, s)) return false;
    p.kp += kpad;
  }
  if ((long long)kh * kw * p.kp >= (1LL << 31)) return false;
  p.nb0 = pass_width(oc0p);
  p.npass0 = (oc0p + p.nb0 - 1) / p.nb0;
  const int kc = p.ch0.widest();
  int b_bytes = p.nb0 * kc;
  if (fuse) {
    if (!p.ch1.add(oc0p, 0, 128, -1)) return false;
    p.nb1 = pass_width(oc1p);
    p.npass1 = (oc1p + p.nb1 - 1) / p.nb1;
    b_bytes = std::max(b_bytes, p.nb1 * p.ch1.widest());
  }
  p.slot_a = TM * kc;              // a multiple of 1024, as is b_bytes
  p.slot = p.slot_a + b_bytes;
  const int mid = fuse ? TM * oc0p : 0;
  // the final stage's staging rows: the intermediate's own, once the last
  // 1x1 pass has read them, else a buffer of their own
  const int nbf = fuse ? p.nb1 : p.nb0;
  const bool in_mid = fuse && p.npass1 == 1 && nbf <= oc0p;
  const int stage = staged && !in_mid ? TM * nbf : 0;
  // the epilogue's per-channel parameters (stage_params)
  const int par = (3 * oc0p + (fuse ? 2 * oc1p : 0)) * 4;
  const int fixed = 1024 + mid + stage + par + 2 * MAX_STAGES * 8;
  p.stages = std::min(MAX_STAGES, (SMEM_LIMIT - fixed) / p.slot);
  if (p.stages < 2 || (merge && p.stages < kh * kw * p.ch0.n)) return false;
  p.mid_off = p.stages * p.slot;
  p.stage_off = in_mid ? p.mid_off : p.mid_off + mid;
  p.par_off = p.mid_off + mid + stage;
  p.bar_off = p.par_off + par;
  p.smem = 1024 + p.bar_off + 2 * p.stages * 8;
  return true;
}

// Tile t's image nn and first output row and column.
struct Tile {
  int nn, y0, x0;
};
__device__ __forceinline__ Tile tile_at(const KArgs& a, int t) {
  const Plan& p = a.p;
  return Tile{t / (p.tiles_x * p.tiles_y),
              a.oy0 + TR * ((t / p.tiles_x) % p.tiles_y),
              TC * (t % p.tiles_x)};
}

// ------------------------------------------------------------ producer
// Every chunk of every tile of the block, in the order the consumers take
// them: the ring runs on from one tile into the next, so the next tile's
// loads are in flight while the consumers finish the last one.
__device__ __forceinline__ void produce(const Maps& maps, const KArgs& a,
                                        uint8_t* smem, uint64_t* full,
                                        uint64_t* empty, bool fuse) {
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
  for (int t = blockIdx.x; t < p.tiles; t += gridDim.x) {
    const Tile tl = tile_at(a, t);
    for (int ps = 0; ps < p.npass0; ++ps)
      for (int ki = 0; ki < a.kh; ++ki)
        for (int kj = 0; kj < a.kw; ++kj)
          for (int c = 0; c < p.ch0.n; ++c) {
            const KChunk ch = p.ch0.c[c];
            const int kc = 32 << ch.wcode;
            uint8_t* s = slot((TM + p.nb0) * kc);
            tma_load_4d(s, &maps.a[ch.src][ch.wcode], &full[stage], ch.lane0,
                        a.col_off_in + tl.x0 - a.pw + kj,
                        a.halo_in + tl.y0 - a.ph + ki, tl.nn);
            tma_load_2d(s + p.slot_a, &maps.b0[ch.wcode], &full[stage],
                        (ki * a.kw + kj) * p.kp + ch.koff, ps * p.nb0);
            next();
          }
    if (!fuse) continue;
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
// A thread's pixels: rows y (h = 0) and y + 1 (h = 1) of column x.
struct Pix {
  int y, x;
  bool ok[2];
};

// The epilogue's per-channel parameters, copied into shared memory once
// per block by the consumers: corr0, bias0, scale0 over the oc0p lanes,
// then bias1, scale1 over the oc1p lanes when fused. A missing bias is
// zeros: adding +0.0 changes no f32 value of an integer.
struct Params {
  const int32_t* corr0;
  const float *bias0, *scale0, *bias1, *scale1;
};
__device__ __forceinline__ Params stage_params(const KArgs& a,
                                               uint8_t* par) {
  int32_t* corr0 = reinterpret_cast<int32_t*>(par);
  float* f = reinterpret_cast<float*>(par + 4 * a.oc0p);
  for (int i = threadIdx.x; i < a.oc0p; i += 256) {
    corr0[i] = a.corr0[i];
    f[i] = a.has_bias0 ? a.bias0[i] : 0.0f;
    f[a.oc0p + i] = a.scale0[i];
  }
  for (int i = threadIdx.x; i < a.oc1p; i += 256) {
    f[2 * a.oc0p + i] = a.has_bias1 ? a.bias1[i] : 0.0f;
    f[2 * a.oc0p + a.oc1p + i] = a.scale1[i];
  }
  return Params{corr0, f, f + a.oc0p, f + 2 * a.oc0p,
                f + 2 * a.oc0p + a.oc1p};
}

// Requantize the thread's accumulators of one pass (lanes n0 + [0, nb),
// those below lim) to u8, lanes >= oc as 0: the 16-bit half j % 2 of
// q[h][j / 2] holds lanes n0 + 8j + 2t and + 1 of row h. corr may be null
// (no correction). With SUM the sum operand's byte joins after the round
// (requant_to_u8_centered(..., sum_rounded=)). The parameters come from
// shared memory, and every load comes before the caller's first store.
template <bool SUM>
__device__ __forceinline__ void requant_pass(
    const KArgs& a, const int32_t (&acc)[128], const int32_t* corr,
    const float* bias, const float* scale, bool down, int n0, int nb,
    int lim, int oc, const int (&sslot)[2], const Pix& px,
    uint32_t (&q)[2][16]) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    if (8 * j >= nb || n0 + 8 * j >= lim) break;  // warp-uniform
    const int o = n0 + 8 * j + 2 * t;  // even: the pairs below are aligned
    const float2 b = *reinterpret_cast<const float2*>(bias + o);
    const float2 sc = *reinterpret_cast<const float2*>(scale + o);
    const int2 c = corr ? *reinterpret_cast<const int2*>(corr + o)
                        : make_int2(0, 0);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      uint32_t v = 0;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (o + e >= oc) continue;  // pad lanes stay u8 0
        const int32_t x = acc[4 * j + 2 * h + e] + (e ? c.y : c.x);
        const float be = e ? b.y : b.x, se = e ? sc.y : sc.x;
        uint32_t u;
        if constexpr (SUM) {
          if (!px.ok[h]) continue;  // no sum slot: the value is dropped
          const float sv = __int2float_rn(
              a.sum[(size_t)sslot[h] * a.out.cp + o + e] ^ 0x80);
          // sum_rounded is integral, so requant_sum's round of it is
          // exact: this is requant_to_u8_centered(..., sum_rounded=)
          u = requant_sum<DT_U8>(x, true, be, se, true, down,
                                 round_f32(__fmul_rn(sv, a.sum_scale), down));
        } else {
          u = requant_u8(x, be, se, down);
        }
        v |= u << (8 * e);
      }
      q[h][j >> 1] = (j & 1) ? q[h][j >> 1] | (v << 16) : v;
    }
  }
}

// requant_pass for MERGE (no sum, lim the output's lanes): each value
// joined after the clamp by the input's byte of its lane and row,
// min(u + s, 255) (lanes >= oc: the byte alone). The input's lanes o, o + 1
// at the thread's rows m0 + g and + 8 come from the A tile of the K chunk
// that holds them (a merge conv's K offset of a lane is the lane, and its
// chunks hold whole 32-lane groups): chunk c of the pass sits in ring slot
// s0 + c modulo the stages, where TMA wrote byte (r, k) of a kc-byte row at
// r * kc + k, the 16-byte unit's index XOR-ed with bits 7 and up of that
// offset (the 32-, 64- and 128-byte swizzles), which for k < kc are those
// of r * kc: one XOR per row and chunk. Returns the max of the two rows
// (the pool's vertical pair): the 16-bit half j % 2 of q[j / 2] holds lanes
// n0 + 8j + 2t and + 1.
__device__ __forceinline__ void requant_merge(
    const KArgs& a, const int32_t (&acc)[128], const int32_t* corr,
    const float* bias, const float* scale, bool down, int n0, int nb,
    int oc, const uint8_t* ring, int s0, int m0, uint32_t (&q)[16]) {
  const Plan& p = a.p;
  const int t = threadIdx.x & 3, m = m0 + ((threadIdx.x & 31) >> 2);
  // the chunk of lanes n0 + 8j: index, first lane past it, its first lane,
  // and the thread's rows m, m + 8 of its A tile with their swizzle
  int c = -1, end = 0, koff = 0;
  const uint8_t* row[2] = {ring, ring};
  int swz[2] = {0, 0};
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    if (8 * j >= nb || n0 + 8 * j >= a.out.cp) break;  // warp-uniform
    const int o = n0 + 8 * j + 2 * t;
    if ((j & 3) == 0) {
      while (n0 + 8 * j >= end) {   // warp-uniform
        const KChunk ch = p.ch0.c[++c];
        const int kc = 32 << ch.wcode;
        koff = ch.koff;
        end = koff + kc;
        const uint8_t* slot =
            ring + (s0 + c < p.stages ? s0 + c : s0 + c - p.stages) * p.slot;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          row[h] = slot + (m + 8 * h) * kc;
          swz[h] = (((m + 8 * h) * kc >> 7) & (kc / 16 - 1)) << 4;
        }
      }
    }
    const float2 b = *reinterpret_cast<const float2*>(bias + o);
    const float2 sc = *reinterpret_cast<const float2*>(scale + o);
    const int2 cr = *reinterpret_cast<const int2*>(corr + o);
    // each row's two stored bytes: s8 values, u8 = s8 + 128
    uint32_t in[2];
#pragma unroll
    for (int h = 0; h < 2; ++h)
      in[h] =
          *reinterpret_cast<const uint16_t*>(row[h] + ((o - koff) ^ swz[h]));
    uint32_t v = 0;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      uint32_t u[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int s = int(int8_t(in[h] >> (8 * e))) + 128;
        u[h] = o + e >= oc
                   ? uint32_t(s)
                   : requant_u8(acc[4 * j + 2 * h + e] + (e ? cr.y : cr.x),
                                e ? b.y : b.x, e ? sc.y : sc.x, down, s);
      }
      v |= max(u[0], u[1]) << (8 * e);
    }
    q[j >> 1] = (j & 1) ? q[j >> 1] | (v << 16) : v;
  }
}

// The merge conv's store of the warpgroup's pass: requant_merge's maxima
// of the vertical pairs, then the max with the horizontal partner (the
// lane 4 away), XOR 0x80, at the pooled slot, four lanes per 32-bit word:
// two per 16-bit store.
__device__ __forceinline__ void write_merge(const KArgs& a, const Params& pr,
                                            const int32_t (&acc)[128],
                                            int n0, int nb, int nn,
                                            const Pix& px,
                                            const uint8_t* ring, int s0,
                                            int m0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const PackedDst& d = a.out;
  uint32_t q[16];
  requant_merge(a, acc, pr.corr0, pr.bias0, pr.scale0, a.down0, n0, nb,
                a.oc0, ring, s0, m0, q);
  uint8_t* dst = d.dst + (size_t)((nn * d.rows + d.halo + px.y / 2) * d.iwp +
                                  d.col_off + px.x / 2) * d.cp + n0 + 2 * t;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    if (16 * i >= nb || n0 + 16 * i >= d.cp) break;  // warp-uniform
    const uint32_t w =
        __vmaxu4(q[i], __shfl_xor_sync(0xffffffffu, q[i], 4)) ^ CENTER4;
    if (!(g & 1) && px.ok[0]) {
      *reinterpret_cast<uint16_t*>(dst + 16 * i) = static_cast<uint16_t>(w);
      *reinterpret_cast<uint16_t*>(dst + 16 * i + 8) =
          static_cast<uint16_t>(w >> 16);
    }
  }
}

// Store q's bytes (XOR-ed with x) in the no-swizzle K-major layout of the
// fused intermediate: byte (m, k) at (k / 16) * TM * 16 + m * 16 + k % 16,
// rows m0 + g and m0 + g + 8, lanes k = 8j + 2t - n0 of the pass.
__device__ __forceinline__ void store_kmajor(uint8_t* buf,
                                             const uint32_t (&q)[2][16],
                                             int nb, int lim, int n0, int m0,
                                             uint32_t x) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    if (8 * j >= nb || n0 + 8 * j >= lim) break;  // warp-uniform
    const int k = 8 * j + 2 * t;
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<uint16_t*>(buf + (k >> 4) * (TM * 16) +
                                   (m0 + g + 8 * h) * 16 + (k & 15)) =
          static_cast<uint16_t>((q[h][j >> 1] >> (16 * (j & 1))) ^ x);
  }
}

// Requantize the warpgroup's pass to plain u8 into the intermediate (lanes
// n0 + [0, nb) of the K-major layout), lanes >= oc0 as 0.
__device__ __forceinline__ void write_mid(const KArgs& a, const Params& pr,
                                          uint8_t* mid,
                                          const int32_t (&acc)[128], int n0,
                                          int nb, int m0, const Pix& px) {
  uint32_t q[2][16];
  const int none[2] = {0, 0};
  requant_pass<false>(a, acc, pr.corr0, pr.bias0, pr.scale0, a.down0, n0,
                      nb, a.oc0p, a.oc0, none, px, q);
  store_kmajor(mid + (n0 >> 4) * (TM * 16), q, nb, a.oc0p, n0, m0, 0u);
}

// The final stage's store of the warpgroup's pass: requantize to u8 (lanes
// >= oc as 0; with SUM joined with the sum operand's byte), XOR 0x80. With
// POOL the max of the 2x2 window (rows h = 0, 1 in the thread, columns g,
// g ^ 1 in lanes 4 apart) goes to its pooled slot, two lanes per 16-bit
// store; a max over clamped u8 values is the JAX pool over the clamped f32
// values: the pack is monotone, and so is rounding. Without POOL the warp
// stages its 16 pixels in `stage` (the K-major layout, its own rows m0 +
// [0, 16)) and stores them 16 bytes a lane: lane i takes row i % 16 of
// granule i / 16, so a warp's shared loads meet no bank conflict and each
// of its global stores fills 32-byte sectors.
template <bool SUM, bool POOL>
__device__ __forceinline__ void write_out(
    const KArgs& a, const int32_t (&acc)[128], const int32_t* corr,
    const float* bias, const float* scale, bool down, int n0, int nb, int oc,
    int nn, const Pix& px, uint8_t* stage, int m0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const PackedDst& d = a.out;
  int sslot[2];
#pragma unroll
  for (int h = 0; h < 2; ++h)
    sslot[h] = (nn * a.rows_sum + a.halo_sum + px.y + h) * a.iwp +
               a.col_off_out + px.x;
  uint32_t q[2][16];
  requant_pass<SUM>(a, acc, corr, bias, scale, down, n0, nb, d.cp, oc, sslot,
                    px, q);
  if constexpr (POOL) {
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      if (8 * j >= nb || n0 + 8 * j >= d.cp) break;  // warp-uniform
      const int sh = 16 * (j & 1);
      uint32_t m = __vmaxu4((q[0][j >> 1] >> sh) & 0xffffu,
                            (q[1][j >> 1] >> sh) & 0xffffu);
      m = __vmaxu4(m, __shfl_xor_sync(0xffffffffu, m, 4));
      if (!(g & 1) && px.ok[0]) {
        const int ps = (nn * d.rows + d.halo + px.y / 2) * d.iwp +
                       d.col_off + px.x / 2;
        const size_t at = (size_t)ps * d.cp + n0 + 8 * j + 2 * t;
        *reinterpret_cast<uint16_t*>(d.dst + at) =
            static_cast<uint16_t>(m ^ 0x8080u);
      }
    }
  } else {
    store_kmajor(stage, q, nb, d.cp, n0, m0, 0x8080u);
    __syncwarp();
    const int ng = (min(nb, d.cp - n0) + 15) / 16;  // granules of the pass
    const int x0 = px.x - g;
    for (int i = lane; i < 16 * ng; i += 32) {
      const int r = i & 15, gi = i >> 4, y = px.y + (r >> 3), x = x0 + (r & 7);
      if (x >= a.ow || y >= a.oy0 + a.noy) continue;
      const uint4 v = *reinterpret_cast<const uint4*>(
          stage + gi * (TM * 16) + (m0 + r) * 16);
      const int slot = (nn * d.rows + d.halo + y) * d.iwp + d.col_off + x;
      *reinterpret_cast<uint4*>(d.dst + (size_t)slot * d.cp + n0 + 16 * gi) = v;
    }
    __syncwarp();   // the stage rows are free for the next pass
  }
}

// The raw s32 1x1 accumulator at the pixels' slots, two lanes per 8 bytes.
__device__ __forceinline__ void write_acc(const KArgs& a,
                                          const int32_t (&acc)[128], int n0,
                                          int nb, int nn, const Pix& px) {
  const int t = threadIdx.x & 3;
  const PackedDst& d = a.out;
  int32_t* dst = reinterpret_cast<int32_t*>(d.dst);
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    if (8 * j >= nb || n0 + 8 * j >= d.cp) break;  // warp-uniform
    const int o = n0 + 8 * j + 2 * t;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int slot =
          (nn * d.rows + d.halo + px.y + h) * d.iwp + d.col_off + px.x;
      if (px.ok[h])
        *reinterpret_cast<int2*>(dst + (size_t)slot * d.cp + o) =
            make_int2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    }
  }
}

template <bool POOL>
__device__ __forceinline__ void write_final(
    const KArgs& a, const int32_t (&acc)[128], const int32_t* corr,
    const float* bias, const float* scale, bool down, int n0, int nb, int oc,
    int nn, const Pix& px, uint8_t* stage, int m0) {
  if (a.sum)  // one uniform branch: the unrolled loops carry no test
    write_out<true, POOL>(a, acc, corr, bias, scale, down, n0, nb, oc, nn, px,
                          stage, m0);
  else
    write_out<false, POOL>(a, acc, corr, bias, scale, down, n0, nb, oc, nn,
                           px, stage, m0);
}

// ------------------------------------------------------------ consumers
template <int MODE>
__device__ __forceinline__ void consume(const KArgs& a, uint8_t* smem,
                                        uint64_t* full, uint64_t* empty) {
  constexpr bool FUSE = MODE & MODE_FUSE, POOL = MODE & MODE_POOL,
                 RAW = MODE & MODE_RAW, MERGE = MODE & MODE_MERGE;
  const Plan& p = a.p;
  const int wg = threadIdx.x >> 7;            // 0 or 1: rows 64 wg + [0, 64)
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  uint8_t* mid = smem + p.mid_off;
  uint8_t* stg = smem + p.stage_off;  // the final stage's staging rows
  const int m0 = 64 * wg + 16 * warp;   // the warp's rows of M
  const Params pr = stage_params(a, smem + p.par_off);
  named_barrier(3, 256);   // the consumers' copy of the parameters
  // Slots are read in ring order (stage, phase) and released in the same
  // order one chunk later (rstage): a chunk's wgmma group stays in flight
  // while the next chunk's is issued.
  int stage = 0, rstage = 0;
  uint32_t phase = 0;
  auto acquire = [&] {
    mbar_wait(&full[stage], phase);
    __syncwarp();   // wgmma is .aligned: the warp issues it together
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
  int32_t acc[128];
  const int ntaps = a.kh * a.kw;
  for (int t = blockIdx.x; t < p.tiles; t += gridDim.x) {
    const Tile tl = tile_at(a, t);
    const int nn = tl.nn;
    Pix px;
    px.y = tl.y0 + 8 * wg + 2 * warp;
    px.x = tl.x0 + (lane >> 2);
#pragma unroll
    for (int h = 0; h < 2; ++h)
      px.ok[h] = px.x < a.ow && px.y + h < a.oy0 + a.noy;
    for (int ps = 0; ps < p.npass0; ++ps) {
      fence_regs(acc);
      bool first = true;
      const int s0 = stage;   // the ring slot of the pass's first chunk
      for (int tap = 0; tap < ntaps; ++tap)
        for (int c = 0; c < p.ch0.n; ++c) {
          const int kc = 32 << p.ch0.c[c].wcode;
          uint8_t* s = acquire();
          const uint32_t sa = smem_u32(s) + wg * 64 * kc;
          const uint32_t sb = smem_u32(s + p.slot_a);
          wgmma_fence();
          for (int kk = 0; kk < kc / 32; ++kk)
            wgmma_step<false>(acc, swizzled_desc(sa, kc, kk),
                              swizzled_desc(sb, kc, kk), p.nb0,
                              !(first && kk == 0));
          wgmma_commit();
          advance();
          wgmma_wait<1>();        // the previous chunk is done with its slot
          if (!first && !MERGE) release();
          first = false;
        }
      wgmma_wait<0>();
      fence_regs(acc);
      if constexpr (!MERGE) release();
      const int n0 = ps * p.nb0;
      if constexpr (FUSE) {
        write_mid(a, pr, mid, acc, n0, p.nb0, m0, px);
      } else if constexpr (MERGE) {
        write_merge(a, pr, acc, n0, p.nb0, nn, px, smem, s0, m0);
        for (int i = 0; i < ntaps * p.ch0.n; ++i) release();
      } else {
        write_final<POOL>(a, acc, pr.corr0, pr.bias0, pr.scale0, a.down0, n0,
                          p.nb0, a.oc0, nn, px, stg, m0);
      }
    }
    if constexpr (FUSE) {
      fence_async_shared();   // the intermediate, for wgmma
      named_barrier(1 + wg, 128);
      const uint32_t sm = smem_u32(mid) + wg * 64 * 16;
      for (int ps = 0; ps < p.npass1; ++ps) {
        fence_regs(acc);
        bool first = true;
        for (int c = 0; c < p.ch1.n; ++c) {
          const KChunk ch = p.ch1.c[c];
          const int kc = 32 << ch.wcode;
          const uint32_t sb = smem_u32(acquire() + p.slot_a);
          wgmma_fence();
          for (int kk = 0; kk < kc / 32; ++kk) {
            const int k = ch.koff + 32 * kk;   // two 16-byte granules
            wgmma_step<true>(acc,
                             smem_desc(sm + (k >> 4) * (TM * 16), TM * 16, 128,
                                       0),
                             swizzled_desc(sb, kc, kk), p.nb1,
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
        const int n0 = ps * p.nb1;
        // the staging rows may be the intermediate's: every warp of the
        // warpgroup is past its last read of them
        if constexpr (!RAW && !POOL) named_barrier(1 + wg, 128);
        if constexpr (RAW)
          write_acc(a, acc, n0, p.nb1, nn, px);
        else
          write_final<POOL>(a, acc, nullptr, pr.bias1, pr.scale1, a.down1,
                            n0, p.nb1, a.oc1, nn, px, stg, m0);
      }
    }
  }
}

template <int MODE>
__global__ void __launch_bounds__(NTH, 1)
    packed_conv_kernel(const __grid_constant__ Maps maps,
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
      mbar_init(&empty[s], 8);   // one arrival per consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();
  if (threadIdx.x >= 256) {   // the producer warpgroup
    setmaxnreg_dec<56>();
    const int w = (threadIdx.x - 256) >> 5;
    if (w == 0) {
      if (threadIdx.x == 256)
        produce(maps, a, smem, full, empty, MODE & MODE_FUSE);
    } else {   // three warps fill the block's rows of the output's pads
      fill_pad_rows<(MODE & MODE_RAW) ? 4 : 1>(a.out, blockIdx.x * 3 + w - 1,
                                               gridDim.x * 3);
    }
  } else {
    setmaxnreg_inc<224>();
    consume<MODE>(a, smem, full, empty);
  }
}

template <int MODE>
int launch(const Maps& maps, const KArgs& a, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      packed_conv_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      a.p.smem);
  if (e != cudaSuccess) return (int)e;
  packed_conv_kernel<MODE><<<a.p.blocks, NTH, a.p.smem, stream>>>(maps, a);
  return (int)cudaGetLastError();
}

}  // namespace

static_assert(PACKED_MAX_SRC == MAX_SRC, "packed_conv.h and packed_dst.cuh");

cudaError_t packed_weight_maps(const void* w0k, int k0, int oc0p,
                               const void* w1k, int oc1p, void* out) {
  CUtensorMap m[6] = {};
  if (!encode_weights(m, w0k, k0, oc0p, pass_width(oc0p)) ||
      (w1k && !encode_weights(m + 3, w1k, oc0p, oc1p, pass_width(oc1p))))
    return cudaErrorInvalidValue;
  memcpy(out, m, sizeof(m));
  return cudaSuccess;
}

cudaError_t packed_plan(const int* in, int* out) {
  Plan p;
  if (!make_plan(p, in[0], in[1], in[2], in[3], in + 4, in[8], in[9], in[10],
                 in[11], in[12] != 0, in[13] == 0, in[14] != 0))
    return cudaErrorInvalidValue;
  const int v[PACKED_PLAN_OUT] = {TR, TC, p.blocks, p.stages, p.smem, p.nb0,
                                  p.nb1, p.npass0, p.npass1, p.ch0.n, p.kp,
                                  p.tiles};
  memcpy(out, v, sizeof(v));
  return cudaSuccess;
}

cudaError_t packed_conv_launch(
    const void* const* srcs, const int* src_cps, int n_src, const void* corr0,
    const void* bias0, const void* scale0, const void* bias1,
    const void* scale1, const void* wmaps, void* dst, const void* sum, int n,
    int rows_in, int iwp, int halo_in, int col_off_in, int rows_out,
    int halo_out, int col_off_out, int oh, int ow, int kh, int kw, int ph,
    int pw, int oc0, int oc0p, int oc1, int oc1p, int down0, int down1,
    int has_bias0, int has_bias1, int fuse, int rows_sum, int halo_sum,
    int pool2, int merge, int raw, int oy0, int noy, float sum_scale,
    cudaStream_t stream) {
  if (n_src < 1 || n_src > MAX_SRC || oc0p % 32 || oc0p <= 0 ||
      (fuse && (oc1p % 32 || oc1p <= 0)))
    return cudaErrorInvalidValue;
  if (pool2 && (oh % 2 || ow % 2 || halo_out % 2 || col_off_out % 2 ||
                iwp % 16 || oy0 % 2 || noy % 2))
    return cudaErrorInvalidValue;
  if (raw && (!fuse || pool2 || sum)) return cudaErrorInvalidValue;
  if (noy < 1 || oy0 < 0 || oy0 + noy > oh) return cudaErrorInvalidValue;
  // every flat slot index must fit an int
  if ((long long)n * rows_in * iwp >= (1LL << 31) ||
      (long long)n * rows_out * iwp >= (1LL << 31) ||
      (sum && ((long long)n * rows_sum * iwp >= (1LL << 31) ||
               halo_sum < halo_out || rows_sum - halo_sum < oh)))
    return cudaErrorInvalidValue;
  int icp = 0;
  for (int s = 0; s < n_src; ++s) {
    if (src_cps[s] <= 0 || src_cps[s] % 16) return cudaErrorInvalidValue;
    icp += src_cps[s];
  }
  if (icp % 32) return cudaErrorInvalidValue;
  // merge: K offset o is lane o of the joined input and of the output
  if (merge) {
    if (!pool2 || fuse || raw || sum || kh != 1 || kw != 1 || ph || pw ||
        icp != oc0p)
      return cudaErrorInvalidValue;
    for (int s = 0; s < n_src; ++s)
      if (src_cps[s] % 32) return cudaErrorInvalidValue;
  }
  KArgs a = {};
  if (!make_plan(a.p, n, noy, ow, n_src, src_cps, kh, kw, oc0p, oc1p,
                 fuse != 0, !pool2 && !raw, merge != 0))
    return cudaErrorInvalidValue;
  Maps maps;
  memset(&maps, 0, sizeof(maps));
  memcpy(maps.b0, wmaps, 3 * sizeof(CUtensorMap));
  if (fuse)
    memcpy(maps.b1,
           static_cast<const char*>(wmaps) + 3 * sizeof(CUtensorMap),
           3 * sizeof(CUtensorMap));
  for (int s = 0; s < n_src; ++s) {
    const cuuint64_t cp = (cuuint64_t)src_cps[s];
    const cuuint64_t dims[4] = {cp, (cuuint64_t)iwp, (cuuint64_t)rows_in,
                                (cuuint64_t)n};
    const cuuint64_t strides[3] = {cp, cp * iwp, cp * iwp * rows_in};
    for (int w = 0; w < 3; ++w) {
      const cuuint32_t box[4] = {32u << w, TC, TR, 1};
      if (a.p.ch0.uses(w, s) && !encode(&maps.a[s][w], srcs[s], 4, dims, strides, box))
        return cudaErrorInvalidValue;
    }
  }
  a.corr0 = static_cast<const int32_t*>(corr0);
  a.bias0 = static_cast<const float*>(bias0);
  a.scale0 = static_cast<const float*>(scale0);
  a.bias1 = static_cast<const float*>(bias1);
  a.scale1 = static_cast<const float*>(scale1);
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
  a.iwp = iwp; a.halo_in = halo_in; a.col_off_in = col_off_in;
  a.col_off_out = col_off_out; a.ow = ow;
  a.kh = kh; a.kw = kw; a.ph = ph; a.pw = pw;
  a.oc0 = oc0; a.oc0p = oc0p; a.oc1 = oc1; a.oc1p = fuse ? oc1p : 0;
  a.down0 = down0; a.down1 = down1;
  a.has_bias0 = has_bias0; a.has_bias1 = has_bias1;
  a.oy0 = oy0; a.noy = noy;
  int e;
  if (raw)
    e = launch<MODE_FUSE | MODE_RAW>(maps, a, stream);
  else if (merge)
    e = launch<MODE_POOL | MODE_MERGE>(maps, a, stream);
  else if (pool2)
    e = fuse ? launch<MODE_FUSE | MODE_POOL>(maps, a, stream)
             : launch<MODE_POOL>(maps, a, stream);
  else
    e = fuse ? launch<MODE_FUSE>(maps, a, stream)
             : launch<0>(maps, a, stream);
  return static_cast<cudaError_t>(e);
}
