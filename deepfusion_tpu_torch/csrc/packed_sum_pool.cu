// Saturating residual sum and/or 2x2/s2 max pool of packed-domain images.
//
// Replaces, in deepfusion_tpu/ops/packed.py:
//   _sum_pool_kernel (launcher _sum_pool_call)   as packed_sum_pool_kernel
//                                                   <true, G>
//   _packed_sum_kernel (launcher _packed_sum_call) as packed_sum_pool_kernel
//                                                   <false, G>
//   _maxpool2_kernel (launcher _maxpool2_call)     as packed_maxpool2_kernel
//
// What it computes over the WHOLE padded array (n, rows * iwp, cp), stored
// bytes s = u8 ^ 0x80 (ops/packed.py):
//   y   = the lane join of 1..n inputs (lanes [0, cp0) from the first, ...)
//   SUM:  v = clip(y + r + 128, -128, 127)   the u8 saturating sum, centered
//   POOL: out[R, C] = max over rows 2R, 2R+1 and flat columns 2C, 2C+1
// so the pooled output has rows / 2 rows of iwp / 2 slots and the same
// lanes. Pad slots hold -128 in every input and so stay -128: -128 + -128
// + 128 clips to -128, and a validated 2x2 window never mixes image and pad
// slots (even halo, col_off, h and w).
//
// What bounds it on the H100: device-memory bytes, no reuse. The FusionNet
// residual (batch 8) reads 2 x 7.9 MB and writes 2 MB; floor about 5.3 us at
// 3.35 TB/s. ResFusionNet's pool (batch 8) reads 1.8 MB and writes 0.44 MB,
// so there a launch's fixed costs and one round trip to memory weigh as
// much as the bytes.
//
// packed_sum_pool_kernel<POOL, G> (the sums, K6 and K8): the JAX kernel
// joins any number of inputs of any lane width inside its body, so the
// branch-merge concat never exists in memory; so does this one, with no
// join at all. Its element is G bytes of lanes, G the widest power of two
// up to 16 that divides every input's lanes, so an element lies in one
// input. A block owns a tile of output slots (SUM: `tile` consecutive
// slots; POOL: `tile` columns of one output row); thread (tx, ty) holds
// element tx of the lanes, whose input it finds once by a binary search
// over the lane table (copied from the kernel parameter to shared memory
// once a block), and output slots ty, ty + by, ...: it loads the y and r
// elements of its slot (POOL: of its 2x2 window's four slots) straight
// from device memory, all in flight at once, adds them with the byte-SIMD
// saturating __vaddus4 on XOR-centered words and XORs back (__vaddss4 on
// the stored bytes would give clip(y + r), not clip(y + r + 128)), takes
// the 2x2 max with __vmaxs4 on the stored bytes (the centering is
// monotone) and stores the element. Consecutive threads hold consecutive
// elements, so a warp's loads of one input and its stores are contiguous.
// One launch takes up to SUM_POOL_MAX_IN inputs (the input table, 16 bytes
// an input, is a __grid_constant__ parameter); more launch once per group,
// each computing its inputs' lanes. No pad lanes, no join, no slice.
// A version that stages the tile's runs of every input and of r in shared
// memory first (the join built there, byte exact), sums from there into a
// staged output tile and stores it as 16-byte units
// (tools/stage_variants/packed_sum_staged.cu until commit c5dd817) ran
// 1.60-1.84x this kernel's time warm
// and 1.31-1.46x cold at FusionNet's residual (K8 and K6) and the three
// C13 shapes at 56x56 on an H100 (NVIDIA H100 80GB HBM3, 700.00 W;
// PERF.md §6): a block's phases (stage, sum, store) run one after the
// other, so an SM's loads and stores do not overlap.
//
// packed_maxpool2_kernel (the pool alone, one input): one block per
// (image, output row, column chunk). An output row's two input rows lie
// next to each other in the array; a chunk is the whole row where both
// rows hold at most POOL_BYTES (ResFusionNet: 12 KB, FusionNet's residual:
// 32 KB), so the grid (n x rows / 2 x chunks: 144 blocks at ResFusionNet,
// 240 at FusionNet's residual) covers the SMs and every thread has its
// four 16-byte loads in flight at once. A thread's lane unit and first
// column are fixed by its (x, y) index: its index math is a few 32-bit
// adds, and the block's base offsets are computed once. Staging the rows
// in shared memory with two 1-D bulk copies (the copy engine, one mbarrier)
// ran 7-18% slower than these direct loads on the H100 (PERF.md §6). It
// takes lanes in multiples of 16; ops/packed.py pads narrower ones.
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

#include "packed_sum_pool.h"

namespace {

constexpr int NT = 256;
constexpr int SUM_ROWS = 4;   // SUM: output slots of a tile per thread row
constexpr int POOL_ROWS = 1;  // POOL: output columns of a tile per row
constexpr int MAX_IN = SUM_POOL_MAX_IN;
constexpr uint32_t CENTER4 = 0x80808080u;

struct SumPoolIn {
  const uint8_t* y;  // (n, rows * iwp, cp), 16-byte aligned
  int cp;            // its lanes
  int lane;          // its first lane in the join
};

struct SumPoolArgs {
  SumPoolIn in[MAX_IN];
  int n_y;
  int lo, hi;          // the join's lanes this launch computes
  const uint8_t* r;    // (n, rows * iwp, cp)
  uint8_t* out;
  int cp;              // lanes of r and of the output
  long long slots;     // n * rows * iwp
  int iwp;
  int tile;            // SUM: slots of a tile; POOL: output columns
  int chunks;          // POOL: tiles per output row
};

__device__ __forceinline__ uint32_t sat_sum(uint32_t y, uint32_t r) {
  return __vaddus4(y ^ CENTER4, r ^ CENTER4) ^ CENTER4;
}

__device__ __forceinline__ uint4 max4(uint4 a, uint4 b) {
  return make_uint4(__vmaxs4(a.x, b.x), __vmaxs4(a.y, b.y),
                    __vmaxs4(a.z, b.z), __vmaxs4(a.w, b.w));
}

// G bytes at p in device memory (G-aligned), through the read-only cache,
// in the low bytes of a uint4; and a uint4's low G bytes stored at p
template <int G>
__device__ __forceinline__ uint4 ldg_el(const uint8_t* p) {
  if constexpr (G == 16) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  } else if constexpr (G == 8) {
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
    return make_uint4(v.x, v.y, 0u, 0u);
  } else if constexpr (G == 4) {
    return make_uint4(__ldg(reinterpret_cast<const uint32_t*>(p)), 0u, 0u,
                      0u);
  } else {
    return make_uint4(__ldg(p), 0u, 0u, 0u);
  }
}

template <int G>
__device__ __forceinline__ void store_el(uint8_t* p, uint4 v) {
  if constexpr (G == 16) {
    *reinterpret_cast<uint4*>(p) = v;
  } else if constexpr (G == 8) {
    *reinterpret_cast<uint2*>(p) = make_uint2(v.x, v.y);
  } else if constexpr (G == 4) {
    *reinterpret_cast<uint32_t*>(p) = v.x;
  } else {
    *p = static_cast<uint8_t>(v.x);
  }
}

template <int G>
__device__ __forceinline__ uint4 summed(const uint8_t* y, const uint8_t* r) {
  const uint4 a = ldg_el<G>(y), b = ldg_el<G>(r);
  return make_uint4(sat_sum(a.x, b.x), sat_sum(a.y, b.y), sat_sum(a.z, b.z),
                    sat_sum(a.w, b.w));
}

// one block per tile (see the note above); the op narrows every size to
// int, and byte offsets are 64-bit
template <bool POOL, int G>
__global__ void __launch_bounds__(NT)
    packed_sum_pool_kernel(const __grid_constant__ SumPoolArgs a) {
  __shared__ const uint8_t* s_y[MAX_IN];
  __shared__ int s_cp[MAX_IN], s_lane[MAX_IN];
  const int tid = threadIdx.x;
  // a warp reads one entry of the input table at a time: the parameter
  // lives in the constant bank, which serializes a warp's reads of
  // distinct addresses
  for (int i = tid >> 5; i < a.n_y; i += NT / 32) {
    const SumPoolIn in = a.in[i];
    if ((tid & 31) == 0) {
      s_y[i] = in.y;
      s_cp[i] = in.cp;
      s_lane[i] = in.lane;
    }
  }
  __syncthreads();
  int qt;
  long long q0, s0;  // the tile's first output slot and first input slot
  if constexpr (POOL) {
    const int half = a.iwp / 2;
    const int orow = blockIdx.x / a.chunks;  // one divide per block
    const int c0 = (blockIdx.x - orow * a.chunks) * a.tile;
    qt = min(a.tile, half - c0);
    q0 = (long long)orow * half + c0;
    s0 = 2LL * orow * a.iwp + 2 * c0;
  } else {
    s0 = q0 = (long long)blockIdx.x * a.tile;
    qt = (int)min((long long)a.tile, a.slots - s0);
  }
  const int nl = (a.hi - a.lo) / G;
  const int bx = min(nl, NT), by = NT / bx;
  const int tx = tid % bx, ty = tid / bx;
  if (ty >= by) return;
  const long long cr = a.cp;
  for (int l = tx; l < nl; l += bx) {
    const int lane = a.lo + l * G;
    int lo = 0, hi = a.n_y - 1;  // the input holding `lane`
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (s_lane[mid] + s_cp[mid] > lane) hi = mid;
      else lo = mid + 1;
    }
    const long long cy = s_cp[lo];
    const uint8_t* yb = s_y[lo] + (lane - s_lane[lo]);
    const uint8_t* rb = a.r + lane;
    uint8_t* ob = a.out + lane;
#pragma unroll 2
    for (int q = ty; q < qt; q += by) {
      uint4 v;
      if constexpr (POOL) {
        const long long s = s0 + 2 * q, t = s + a.iwp;
        v = max4(max4(summed<G>(yb + s * cy, rb + s * cr),
                      summed<G>(yb + (s + 1) * cy, rb + (s + 1) * cr)),
                 max4(summed<G>(yb + t * cy, rb + t * cr),
                      summed<G>(yb + (t + 1) * cy, rb + (t + 1) * cr)));
      } else {
        const long long s = s0 + q;
        v = summed<G>(yb + s * cy, rb + s * cr);
      }
      store_el<G>(ob + (q0 + q) * cr, v);
    }
  }
}

constexpr int POOL_BYTES = 32 << 10;   // both input rows of a chunk
constexpr int POOL_NT = 256;

// out (n, rows / 2 * iwp / 2, cp) = the 2x2/s2 max of y (n, rows * iwp,
// cp); block (x: lane unit, y: output column), grid (chunk, output row,
// image); a chunk is cc input columns (even) of both input rows.
__global__ void __launch_bounds__(POOL_NT)
    packed_maxpool2_kernel(const uint8_t* __restrict__ y,
                           uint8_t* __restrict__ out, int rows, int iwp,
                           int cp, int cc) {
  const int c0 = blockIdx.x * cc;
  const int ocols = min(cc, iwp - c0) / 2, upp = cp / 16;
  const uint8_t* row0 =
      y + (((size_t)blockIdx.z * rows + 2 * blockIdx.y) * iwp + c0) * cp;
  const uint8_t* row1 = row0 + (size_t)iwp * cp;
  uint4* dst = reinterpret_cast<uint4*>(
      out + (((size_t)blockIdx.z * (rows / 2) + blockIdx.y) * (iwp / 2) +
             c0 / 2) * cp);
  for (int oc = threadIdx.y; oc < ocols; oc += blockDim.y) {
    for (int u = threadIdx.x; u < upp; u += blockDim.x) {
      const int off = 2 * oc * cp + 16 * u;
      const uint4 a =
          max4(__ldg(reinterpret_cast<const uint4*>(row0 + off)),
               __ldg(reinterpret_cast<const uint4*>(row0 + off + cp)));
      const uint4 b =
          max4(__ldg(reinterpret_cast<const uint4*>(row1 + off)),
               __ldg(reinterpret_cast<const uint4*>(row1 + off + cp)));
      dst[oc * upp + u] = max4(a, b);
    }
  }
}

int launch_maxpool2(const uint8_t* y, uint8_t* out, int n, int rows, int iwp,
                    int cp, cudaStream_t stream) {
  // the widest even column chunk whose two rows hold at most POOL_BYTES
  const int cc = std::min(iwp, std::max(2, POOL_BYTES / (2 * cp)) & ~1);
  const int chunks = (iwp + cc - 1) / cc;
  if (rows / 2 > 65535 || n > 65535) return (int)cudaErrorInvalidValue;
  const int tx = std::min(cp / 16, POOL_NT);
  const int ty = std::max(1, std::min(cc / 2, POOL_NT / tx));
  packed_maxpool2_kernel<<<dim3(chunks, rows / 2, n), dim3(tx, ty), 0,
                           stream>>>(y, out, rows, iwp, cp, cc);
  return (int)cudaGetLastError();
}

template <bool POOL, int G>
cudaError_t launch_sum(const SumPoolArgs& a, long long tiles,
                       cudaStream_t stream) {
  packed_sum_pool_kernel<POOL, G><<<(unsigned)tiles, NT, 0, stream>>>(a);
  return cudaGetLastError();
}

template <bool POOL>
cudaError_t launch_sum(const SumPoolArgs& a, int g, long long tiles,
                       cudaStream_t stream) {
  switch (g) {
    case 16: return launch_sum<POOL, 16>(a, tiles, stream);
    case 8: return launch_sum<POOL, 8>(a, tiles, stream);
    case 4: return launch_sum<POOL, 4>(a, tiles, stream);
    default: return launch_sum<POOL, 1>(a, tiles, stream);
  }
}

}  // namespace

cudaError_t packed_sum_pool_launch(const void* const* ys, const int* y_cps,
                                   int n_y, const void* r, void* out, int n,
                                   int rows, int iwp, int cp, bool sum,
                                   bool pool, cudaStream_t stream,
                                   int* launches) {
  *launches = 0;
  if (n_y < 1 || cp <= 0 || n < 0 || rows < 0 || iwp < 0 ||
      (!sum && !pool) || (sum && r == nullptr) ||
      (pool && (rows % 2 || iwp % 2)) || (!sum && (n_y != 1 || cp % 16)))
    return cudaErrorInvalidValue;
  long long lanes = 0;
  int g = 16;  // the element: the widest power of two dividing every input
  for (int s = 0; s < n_y; ++s) {
    if (y_cps[s] <= 0) return cudaErrorInvalidValue;
    lanes += y_cps[s];
    while (y_cps[s] % g) g /= 2;
  }
  if (lanes != cp) return cudaErrorInvalidValue;
  const long long slots = (long long)n * rows * iwp;
  if (slots == 0) return cudaSuccess;
  if (!sum) {
    *launches = 1;
    return static_cast<cudaError_t>(launch_maxpool2(
        static_cast<const uint8_t*>(ys[0]), static_cast<uint8_t*>(out), n,
        rows, iwp, cp, stream));
  }
  if (g == 2) g = 1;
  SumPoolArgs a;
  a.r = static_cast<const uint8_t*>(r);
  a.out = static_cast<uint8_t*>(out);
  a.cp = cp;
  a.slots = slots;
  a.iwp = iwp;
  // a tile: SUM_ROWS (POOL_ROWS) output slots for each row of threads
  const long long nl = cp / g, by = nl < NT ? NT / nl : 1;
  long long tiles;
  if (pool) {
    const long long half = iwp / 2, orows = slots / (2LL * iwp);
    a.tile = (int)std::min(by * POOL_ROWS, half);
    a.chunks = (int)((half + a.tile - 1) / a.tile);
    tiles = orows * a.chunks;
  } else {
    a.tile = (int)(by * SUM_ROWS);
    a.chunks = 1;
    tiles = (slots + a.tile - 1) / a.tile;
  }
  if (tiles >= (1LL << 31)) return cudaErrorInvalidValue;
  // one launch per group of up to MAX_IN inputs, each computing its lanes
  int lane = 0;
  for (int g0 = 0; g0 < n_y; g0 += MAX_IN) {
    const int k = std::min(n_y - g0, MAX_IN);
    a.n_y = k;
    a.lo = lane;
    for (int s = 0; s < k; ++s) {
      a.in[s].y = static_cast<const uint8_t*>(ys[g0 + s]);
      a.in[s].cp = y_cps[g0 + s];
      a.in[s].lane = lane;
      lane += y_cps[g0 + s];
    }
    a.hi = lane;
    const cudaError_t e = pool ? launch_sum<true>(a, g, tiles, stream)
                               : launch_sum<false>(a, g, tiles, stream);
    ++*launches;
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}
