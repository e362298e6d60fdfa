// max / avg-include-pad / avg-exclude-pad pooling over NHWC with any
// window, stride and padding.
//
// Replaces deepfusion_tpu/ops/pool.py:_pool_kernel (launcher _pool_pallas)
// and the avg_exc epilogue that pool.py:_pool_call_avg_exc runs outside
// the Pallas kernel (a Mosaic limit, pool.py:168-173): here the
// reciprocal-count multiply, the rounding and the saturation happen inside.
//
// What bounds it on the H100: device-memory bytes. A 2x2/s2 max pool reads
// each input byte once and writes a quarter as many; the global average
// pool reads the whole input once and writes one value per channel, and is
// so small (0.8 MB for FusionNet's) that latency, not bandwidth, sets its
// time: it has to be spread over many SMs.
//
// Numerics, to match the JAX kernel bit for bit:
// * padded taps hold the identity (max: the dtype's minimum or -inf;
//   average: 0). For integers the identity changes neither a max nor a
//   wrapping sum, so the vector kernels skip padded taps;
// * integer sums wrap in 32 bits like the JAX kernel's int32 adds; integer
//   max and wrapping sums do not depend on the order of the taps, so the
//   integer kernels may split a window and combine the parts exactly;
// * f32 sums add the taps one by one in (ki, kj) order, as the JAX kernel
//   does, so f32 windows always use the thread-per-output kernel;
// * avg_inc multiplies by the f32 reciprocal of kh*kw (__frcp_rn): the JAX
//   kernel writes a division by the constant kh*kw, which XLA compiles as
//   that multiplication, and a true quotient differs in the last bit;
//   avg_exc multiplies by the reciprocal of the window's in-image tap
//   count, computed in the kernel as pool.py:104-114 computes it: a double
//   quotient 1.0/cnt rounded to f32.
//
// Three kernels, by what the call needs:
// * pool_vec_kernel (integer dtypes, rows of c a multiple of 16 bytes):
//   a thread owns one 16-byte unit of one output pixel's channels and
//   loads that unit once per tap (uint4); the 8-bit max is __vmaxu4 /
//   __vmaxs4 on whole words, sums widen each lane to 32 bits. 32-bit index
//   math (the host checks that the arrays' units fit).
// * pool_split_kernel (the same dtypes and rows, windows of at least
//   SPLIT_TAPS taps with too few output units to fill the card, such as
//   the global average pools): a cluster of up to 8 blocks shares each
//   (output pixel, group of units); each block reduces its share of the
//   taps over its threads, and the cluster's first block combines the
//   blocks' parts through distributed shared memory and finishes. One
//   launch, no scratch in device memory.
// * pool_kernel: one thread per output element, taps in (ki, kj) order;
//   every f32 window, and integer rows that are not a multiple of 16 bytes
//   (a 16-byte load there would be misaligned).
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <climits>
#include <cstdint>

#include "pool.h"
#include "requant.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int NT = 256;
constexpr int KIND_MAX = 0, KIND_AVG_INC = 1, KIND_AVG_EXC = 2;
constexpr int SPLIT_TAPS = 16;   // windows at least this large may split
constexpr int MAX_CLUSTER = 8;   // the portable cluster size
constexpr int SMS = 132;         // the H100 SXM's SMs

struct PoolArgs {
  const void* x;
  void* out;
  int n, ih, iw, c, oh, ow, kh, kw, sh, sw, ph, pw;
  int down;
  int units;                 // 16-byte units of a pixel's channels
  int ug, groups, splits;    // split kernel: units a block, unit groups,
                             // blocks a cluster
};

template <int DT>
__device__ __forceinline__ typename dt_traits<DT>::T max_pad() {
  if constexpr (DT == DT_F32) return __uint_as_float(0xff800000u);  // -inf
  else if constexpr (DT == DT_S32) return INT_MIN;
  else if constexpr (DT == DT_S8) return int8_t(-128);
  else return uint8_t(0);
}

// jnp.maximum: NaN propagates
__device__ __forceinline__ float max_f32(float m, float v) {
  return (v > m || v != v) ? v : m;
}

// avg_inc: f * f32(1/(kh*kw)); avg_exc: f * f32(1.0/cnt), cnt the taps of
// the window that lie inside the image; then round and saturate.
template <int DT, int KIND>
__device__ __forceinline__ typename dt_traits<DT>::T finish_avg(
    float f, const PoolArgs& a, int oy, int ox) {
  float inv;
  if constexpr (KIND == KIND_AVG_INC) {
    inv = __frcp_rn(float(a.kh * a.kw));
  } else {
    const int y0 = oy * a.sh - a.ph, x0 = ox * a.sw - a.pw;
    const int ny = max(0, min(y0 + a.kh, a.ih) - max(y0, 0));
    const int nx = max(0, min(x0 + a.kw, a.iw) - max(x0, 0));
    inv = __double2float_rn(1.0 / double(ny * nx));
  }
  const float val = __fmul_rn(f, inv);
  if constexpr (DT == DT_F32) {
    return val;
  } else {
    return saturate<DT>(round_f32(val, a.down));
  }
}

// ------------------------------------------------------ integer units
// The running max or wrapping sum of one 16-byte unit of L lanes: max
// keeps the four words (lanes packed as stored), a sum one u32 per lane.
template <int DT, int KIND>
struct UnitAcc {
  using T = typename dt_traits<DT>::T;
  static constexpr int L = 16 / int(sizeof(T));
  static constexpr bool MAX = KIND == KIND_MAX;
  // the dtype's minimum in every lane of a word
  static constexpr uint32_t MIN_WORD =
      DT == DT_S32 ? 0x80000000u : DT == DT_S8 ? 0x80808080u : 0u;
  uint32_t w[MAX ? 4 : L];

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int i = 0; i < (MAX ? 4 : L); ++i) w[i] = MAX ? MIN_WORD : 0u;
  }
  // lane i of a unit's words, as int32
  __device__ __forceinline__ static int32_t lane(const uint32_t* v, int i) {
    if constexpr (DT == DT_S32) {
      return static_cast<int32_t>(v[i]);
    } else {
      const uint32_t b = (v[i >> 2] >> (8 * (i & 3))) & 0xffu;
      return DT == DT_S8 ? int32_t(int8_t(b)) : int32_t(b);
    }
  }
  __device__ __forceinline__ void add(const uint4& u) {
    const uint32_t v[4] = {u.x, u.y, u.z, u.w};
    if constexpr (MAX) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if constexpr (DT == DT_U8) w[i] = __vmaxu4(w[i], v[i]);
        else if constexpr (DT == DT_S8) w[i] = __vmaxs4(w[i], v[i]);
        else w[i] = uint32_t(max(int32_t(w[i]), int32_t(v[i])));
      }
    } else {
#pragma unroll
      for (int i = 0; i < L; ++i) w[i] += uint32_t(lane(v, i));
    }
  }
  // lane i's max, or its wrapped sum, as int32
  __device__ __forceinline__ int32_t get(int i) const {
    if constexpr (MAX) return lane(w, i);
    else return int32_t(w[i]);
  }
  __device__ __forceinline__ static int32_t combine(int32_t x, int32_t y) {
    if constexpr (MAX) return max(x, y);
    else return int32_t(uint32_t(x) + uint32_t(y));
  }
};

// A lane's pooled value: the max as is, the sum through finish_avg.
template <int DT, int KIND>
__device__ __forceinline__ typename dt_traits<DT>::T finish(
    int32_t v, const PoolArgs& a, int oy, int ox) {
  if constexpr (KIND == KIND_MAX)
    return static_cast<typename dt_traits<DT>::T>(v);
  else
    return finish_avg<DT, KIND>(__int2float_rn(v), a, oy, ox);
}

// Integer dtypes, c * size % 16 == 0. One thread per (output pixel, unit).
template <int DT, int KIND>
__global__ void __launch_bounds__(NT) pool_vec_kernel(PoolArgs a) {
  using Acc = UnitAcc<DT, KIND>;
  using T = typename Acc::T;
  const int idx = blockIdx.x * NT + threadIdx.x;
  if (idx >= a.n * a.oh * a.ow * a.units) return;
  const int u = idx % a.units;
  int pix = idx / a.units;
  const int ox = pix % a.ow;
  pix /= a.ow;
  const int oy = pix % a.oh;
  const int nn = pix / a.oh;
  const uint4* x = static_cast<const uint4*>(a.x);
  const int y0 = oy * a.sh - a.ph, x0 = ox * a.sw - a.pw;
  Acc acc;
  acc.init();
  for (int ki = 0; ki < a.kh; ++ki) {
    const int iy = y0 + ki;
    if (iy < 0 || iy >= a.ih) continue;
    const int row = (nn * a.ih + iy) * a.iw;
#pragma unroll 4
    for (int kj = 0; kj < a.kw; ++kj) {
      const int ix = x0 + kj;
      if (ix >= 0 && ix < a.iw) acc.add(__ldg(&x[(row + ix) * a.units + u]));
    }
  }
  union {
    uint4 v;
    T t[Acc::L];
  } o;
#pragma unroll
  for (int i = 0; i < Acc::L; ++i)
    o.t[i] = finish<DT, KIND>(acc.get(i), a, oy, ox);
  static_cast<uint4*>(a.out)[idx] = o.v;
}

// Integer dtypes, c * size % 16 == 0. grid: splits * groups * (n*oh*ow)
// blocks in clusters of `splits`; a block's threads are tls = NT / ug tap
// lanes of ug units (ug a power of two). Block r of a cluster takes taps
// r * tls + tl, then every splits * tls-th. The parts in shared memory are
// lane-major (part[i * NT + thread]), so a warp's accesses meet no bank
// conflict.
template <int DT, int KIND>
__global__ void __launch_bounds__(NT) pool_split_kernel(PoolArgs a) {
  using Acc = UnitAcc<DT, KIND>;
  using T = typename Acc::T;
  constexpr int L = Acc::L;
  __shared__ int32_t part[NT * L];
  cg::cluster_group cluster = cg::this_cluster();
  const int r = int(cluster.block_rank());
  const int og = blockIdx.x / a.splits;
  const int g = og % a.groups, pix = og / a.groups;
  const int ox = pix % a.ow, oy = (pix / a.ow) % a.oh;
  const int nn = pix / (a.ow * a.oh);
  const int tls = NT / a.ug;
  const int ul = threadIdx.x % a.ug, tl = threadIdx.x / a.ug;
  const int u = g * a.ug + ul;
  Acc acc;
  acc.init();
  if (u < a.units) {
    const uint4* x = static_cast<const uint4*>(a.x);
    const int y0 = oy * a.sh - a.ph, x0 = ox * a.sw - a.pw;
    const int taps = a.kh * a.kw;
#pragma unroll 2
    for (int t = r * tls + tl; t < taps; t += a.splits * tls) {
      const int iy = y0 + t / a.kw, ix = x0 + t % a.kw;
      if (iy >= 0 && iy < a.ih && ix >= 0 && ix < a.iw)
        acc.add(__ldg(&x[((nn * a.ih + iy) * a.iw + ix) * a.units + u]));
    }
  }
#pragma unroll
  for (int i = 0; i < L; ++i) part[i * NT + threadIdx.x] = acc.get(i);
  // the block's tap lanes, halved until lane 0 holds the block's part
  for (int s = tls / 2; s > 0; s >>= 1) {
    __syncthreads();
    if (tl < s) {
#pragma unroll
      for (int i = 0; i < L; ++i) {
        int32_t* p = &part[i * NT + threadIdx.x];
        *p = Acc::combine(*p, p[s * a.ug]);
      }
    }
  }
  cluster.sync();   // every block's part is in its shared memory
  if (r == 0) {
    for (int i = threadIdx.x; i < a.ug * L; i += NT) {
      const int ul0 = i % a.ug, lane = i / a.ug, uu = g * a.ug + ul0;
      if (uu >= a.units) continue;
      const int at = lane * NT + ul0;   // tap lane 0 of unit ul0
      int32_t v = part[at];
      for (int q = 1; q < a.splits; ++q)
        v = Acc::combine(v, cluster.map_shared_rank(part, q)[at]);
      static_cast<T*>(a.out)[(size_t)pix * a.c + uu * L + lane] =
          finish<DT, KIND>(v, a, oy, ox);
    }
  }
  cluster.sync();   // no block leaves while the first reads its part
}

// Any dtype, any rows: one thread per output element, taps in order.
template <int DT, int KIND>
__global__ void __launch_bounds__(NT) pool_kernel(PoolArgs a) {
  using T = typename dt_traits<DT>::T;
  const T* x = static_cast<const T*>(a.x);
  T* out = static_cast<T*>(a.out);
  const long long total = (long long)a.n * a.oh * a.ow * a.c;
  for (long long idx = blockIdx.x * (long long)NT + threadIdx.x; idx < total;
       idx += (long long)gridDim.x * NT) {
    const int ch = int(idx % a.c);
    long long t = idx / a.c;
    const int ox = int(t % a.ow);
    t /= a.ow;
    const int oy = int(t % a.oh);
    const int nn = int(t / a.oh);
    const T pad = KIND == KIND_MAX ? max_pad<DT>() : T(0);
    T m = pad;
    uint32_t si = 0;  // integer sum, wrapping
    float sf = 0.0f;  // f32 sum
    bool first = true;
    for (int ki = 0; ki < a.kh; ++ki) {
      const int iy = oy * a.sh - a.ph + ki;
      for (int kj = 0; kj < a.kw; ++kj) {
        const int ix = ox * a.sw - a.pw + kj;
        T v = pad;
        if (iy >= 0 && iy < a.ih && ix >= 0 && ix < a.iw)
          v = x[(((size_t)nn * a.ih + iy) * a.iw + ix) * a.c + ch];
        if constexpr (KIND == KIND_MAX) {
          if constexpr (DT == DT_F32) m = first ? v : max_f32(m, v);
          else m = first ? v : (v > m ? v : m);
        } else {
          if constexpr (DT == DT_F32) sf = first ? v : __fadd_rn(sf, v);
          else si += static_cast<uint32_t>(static_cast<int32_t>(v));
        }
        first = false;
      }
    }
    if constexpr (KIND == KIND_MAX) {
      out[idx] = m;
    } else {
      const float f = DT == DT_F32 ? sf : __int2float_rn(int32_t(si));
      out[idx] = finish_avg<DT, KIND>(f, a, oy, ox);
    }
  }
}

// The split kernel's shape: the largest power-of-two units a block (at
// most 32) whose grid reaches SMS blocks, else the one with the most
// blocks; blocks a cluster at most MAX_CLUSTER and at most one per tls
// taps.
void plan_split(PoolArgs& a) {
  const int pixels = a.n * a.oh * a.ow, taps = a.kh * a.kw;
  int top = 1;
  while (top * 2 <= a.units && top * 2 <= 32) top *= 2;
  long long best = -1;
  for (int ug = top; ug >= 1; ug /= 2) {
    const int tls = NT / ug, groups = (a.units + ug - 1) / ug;
    const int splits = std::min(MAX_CLUSTER, (taps + tls - 1) / tls);
    const long long blocks = (long long)pixels * groups * splits;
    if (blocks > best) {
      best = blocks;
      a.ug = ug;
      a.groups = groups;
      a.splits = splits;
    }
    if (blocks >= SMS) break;
  }
}

template <int DT, int KIND>
int launch(PoolArgs a, cudaStream_t s) {
  const long long outs = (long long)a.n * a.oh * a.ow * a.c;
  const int size = int(sizeof(typename dt_traits<DT>::T));
  // the integer kernels: whole 16-byte units, 32-bit unit indices
  const bool vec = DT != DT_F32 && (a.c * size) % 16 == 0 &&
                   (long long)a.n * a.ih * a.iw * a.c * size < (1LL << 31) &&
                   outs * size < (1LL << 31);
  if (vec) {
    a.units = a.c * size / 16;
    const long long work = (long long)a.n * a.oh * a.ow * a.units;
    if (a.kh * a.kw >= SPLIT_TAPS && work < (long long)SMS * NT / 4) {
      plan_split(a);
      cudaLaunchConfig_t cfg = {};
      cfg.gridDim = dim3((unsigned)((long long)a.n * a.oh * a.ow * a.groups *
                                    a.splits));
      cfg.blockDim = dim3(NT);
      cfg.stream = s;
      cudaLaunchAttribute attr[1];
      attr[0].id = cudaLaunchAttributeClusterDimension;
      attr[0].val.clusterDim.x = (unsigned)a.splits;
      attr[0].val.clusterDim.y = 1;
      attr[0].val.clusterDim.z = 1;
      cfg.attrs = attr;
      cfg.numAttrs = 1;
      const cudaError_t e =
          cudaLaunchKernelEx(&cfg, pool_split_kernel<DT, KIND>, a);
      return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
    }
    pool_vec_kernel<DT, KIND>
        <<<(unsigned)((work + NT - 1) / NT), NT, 0, s>>>(a);
    return (int)cudaGetLastError();
  }
  long long blocks = (outs + NT - 1) / NT;
  if (blocks > SMS * 32) blocks = SMS * 32;
  pool_kernel<DT, KIND><<<(unsigned)blocks, NT, 0, s>>>(a);
  return (int)cudaGetLastError();
}

template <int DT>
int launch_kind(const PoolArgs& a, int kind, cudaStream_t s) {
  switch (kind) {
    case KIND_MAX: return launch<DT, KIND_MAX>(a, s);
    case KIND_AVG_INC: return launch<DT, KIND_AVG_INC>(a, s);
    case KIND_AVG_EXC: return launch<DT, KIND_AVG_EXC>(a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

cudaError_t pool_launch(const void* x, void* out, int n, int ih, int iw,
                        int c, int oh, int ow, int kh, int kw, int sh, int sw,
                        int ph, int pw, int kind, int down, int dt,
                        cudaStream_t stream) {
  if ((long long)n * oh * ow * c == 0) return cudaSuccess;
  PoolArgs a = {};
  a.x = x;
  a.out = out;
  a.n = n; a.ih = ih; a.iw = iw; a.c = c; a.oh = oh; a.ow = ow;
  a.kh = kh; a.kw = kw; a.sh = sh; a.sw = sw; a.ph = ph; a.pw = pw;
  a.down = down;
  int e;
  switch (dt) {
    case DT_F32: e = launch_kind<DT_F32>(a, kind, stream); break;
    case DT_S32: e = launch_kind<DT_S32>(a, kind, stream); break;
    case DT_S8: e = launch_kind<DT_S8>(a, kind, stream); break;
    case DT_U8: e = launch_kind<DT_U8>(a, kind, stream); break;
    default: e = (int)cudaErrorInvalidValue;
  }
  return static_cast<cudaError_t>(e);
}
