// Saturating residual sum and/or 2x2/s2 max pool of packed-domain images.
//
// Replaces, in deepfusion_tpu/ops/packed.py:
//   _sum_pool_kernel (launcher _sum_pool_call)   as packed_sum_pool_kernel
//                                                   <true, true>
//   _packed_sum_kernel (launcher _packed_sum_call) as packed_sum_pool_kernel
//                                                   <true, false>
//   _maxpool2_kernel (launcher _maxpool2_call)     as packed_maxpool2_kernel
//
// What it computes over the WHOLE padded array (n, rows * iwp, cp), stored
// bytes s = u8 ^ 0x80 (ops/packed.py):
//   y   = the lane join of 1..n inputs (lanes [0, c0) from the first, ...)
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
// packed_sum_pool_kernel (the sums): one thread per 16-byte unit of the
// output, 16-byte loads and stores. The sum XORs both operands to u8, adds
// with the byte-SIMD saturating __vaddus4 and XORs back (__vaddss4 on the
// stored bytes would give clip(y + r), not clip(y + r + 128)); the pool is
// __vmaxs4 on the stored bytes, since the centering is monotone. Each
// 16-byte unit of the joined operand is read straight from the input that
// holds its lanes, so the join never exists in memory.
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
// ran 7-18% slower than these direct loads on the H100 (PERF.md §6).
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

#include "packed_sum_pool.h"

namespace {

constexpr int NT = 256;
constexpr int MAX_IN = 4;
constexpr uint32_t CENTER4 = 0x80808080u;

struct SumPoolArgs {
  const uint8_t* y[MAX_IN];
  int y_cp[MAX_IN];
  int y_off[MAX_IN];
  int n_y;
  const uint8_t* r;  // right operand of the sum (cp lanes), or null
  uint8_t* out;
  int n, rows, iwp, cp;
};

__device__ __forceinline__ uint32_t sat_sum(uint32_t y, uint32_t r) {
  return __vaddus4(y ^ CENTER4, r ^ CENTER4) ^ CENTER4;
}

__device__ __forceinline__ uint4 max4(uint4 a, uint4 b) {
  return make_uint4(__vmaxs4(a.x, b.x), __vmaxs4(a.y, b.y),
                    __vmaxs4(a.z, b.z), __vmaxs4(a.w, b.w));
}

template <bool SUM, bool POOL>
__global__ void __launch_bounds__(NT) packed_sum_pool_kernel(SumPoolArgs a) {
  const int upp = a.cp / 16;
  const int rows_o = POOL ? a.rows / 2 : a.rows;
  const int iwp_o = POOL ? a.iwp / 2 : a.iwp;
  const long long total = (long long)a.n * rows_o * iwp_o * upp;
  uint4* out = reinterpret_cast<uint4*>(a.out);
  for (long long e = (long long)blockIdx.x * NT + threadIdx.x; e < total;
       e += (long long)gridDim.x * NT) {
    const int u = int(e % upp);
    const long long q = e / upp;
    const int col = int(q % iwp_o);
    const long long q2 = q / iwp_o;
    const int row = int(q2 % rows_o);
    const long long nn = q2 / rows_o;
    const int lane = 16 * u;
    const uint8_t* yb = a.y[0];
    int ycp = a.y_cp[0], l0 = lane;
#pragma unroll
    for (int s = 1; s < MAX_IN; ++s) {
      if (s < a.n_y && lane >= a.y_off[s]) {
        yb = a.y[s];
        ycp = a.y_cp[s];
        l0 = lane - a.y_off[s];
      }
    }
    uint4 res;
#pragma unroll
    for (int k = 0; k < (POOL ? 4 : 1); ++k) {
      const int ir = POOL ? 2 * row + (k >> 1) : row;
      const int ic = POOL ? 2 * col + (k & 1) : col;
      const size_t pix = ((size_t)nn * a.rows + ir) * a.iwp + ic;
      uint4 v = __ldg(reinterpret_cast<const uint4*>(yb + pix * ycp + l0));
      if constexpr (SUM) {
        const uint4 r =
            __ldg(reinterpret_cast<const uint4*>(a.r + pix * a.cp + lane));
        v = make_uint4(sat_sum(v.x, r.x), sat_sum(v.y, r.y),
                       sat_sum(v.z, r.z), sat_sum(v.w, r.w));
      }
      res = k == 0 ? v : max4(res, v);
    }
    out[e] = res;
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
  if (n == 0 || rows == 0 || iwp == 0) return (int)cudaSuccess;
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

template <bool SUM, bool POOL>
int launch(const SumPoolArgs& a, cudaStream_t stream) {
  const long long total = (long long)a.n * (POOL ? a.rows / 2 : a.rows) *
                          (POOL ? a.iwp / 2 : a.iwp) * (a.cp / 16);
  if (total == 0) return (int)cudaSuccess;
  long long blocks = (total + NT - 1) / NT;
  if (blocks > 132 * 32) blocks = 132 * 32;
  packed_sum_pool_kernel<SUM, POOL><<<(unsigned)blocks, NT, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

static_assert(SUM_POOL_MAX_IN == MAX_IN, "packed_sum_pool.h");

cudaError_t packed_sum_pool_launch(const void* const* ys, const int* y_cps,
                                   int n_y, const void* r, void* out, int n,
                                   int rows, int iwp, int cp, bool sum,
                                   bool pool, cudaStream_t stream) {
  if (n_y < 1 || n_y > MAX_IN || cp <= 0 || cp % 16 || (!sum && !pool) ||
      (sum && r == nullptr) || (pool && (rows % 2 || iwp % 2)) ||
      (!sum && n_y != 1))
    return cudaErrorInvalidValue;
  SumPoolArgs a = {};
  int off = 0;
  for (int s = 0; s < n_y; ++s) {
    if (y_cps[s] <= 0 || y_cps[s] % 16) return cudaErrorInvalidValue;
    a.y[s] = static_cast<const uint8_t*>(ys[s]);
    a.y_cp[s] = y_cps[s];
    a.y_off[s] = off;
    off += y_cps[s];
  }
  if (off != cp) return cudaErrorInvalidValue;
  a.n_y = n_y;
  a.r = static_cast<const uint8_t*>(r);
  a.out = static_cast<uint8_t*>(out);
  a.n = n; a.rows = rows; a.iwp = iwp; a.cp = cp;
  int e;
  if (sum && pool)
    e = launch<true, true>(a, stream);
  else if (sum)
    e = launch<true, false>(a, stream);
  else
    e = launch_maxpool2(a.y[0], a.out, n, rows, iwp, cp, stream);
  return static_cast<cudaError_t>(e);
}
