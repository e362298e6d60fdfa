// pool_kernel<DT, KIND>: max / avg-include-pad / avg-exclude-pad pooling
// over NHWC with any window, stride and padding.
//
// Replaces deepfusion_tpu/ops/pool.py:_pool_kernel (launcher _pool_pallas)
// and the avg_exc epilogue that pool.py:_pool_call_avg_exc runs outside
// the Pallas kernel (a Mosaic limit, pool.py:168-173): here the
// reciprocal-count multiply, the rounding and the saturation happen inside.
//
// What bounds it on the H100: device-memory bytes. A 2x2/s2 max pool reads
// each input byte once and writes a quarter as many; the global average
// pool reads the whole input once and writes one value per channel.
//
// Numerics, to match the JAX kernel bit for bit:
// * padded taps hold the identity (max: the dtype's minimum or -inf;
//   average: 0) and take part in the max or the sum, in window order;
// * integer sums wrap in 32 bits like the JAX kernel's int32 adds;
// * f32 sums add the taps one by one in (ki, kj) order, as the JAX kernel
//   does, so f32 windows always use the thread-per-output kernel;
// * avg_inc multiplies by the f32 reciprocal of kh*kw (__frcp_rn): the JAX
//   kernel writes a division by the constant kh*kw, which XLA compiles as
//   that multiplication, and a true quotient differs in the last bit;
//   avg_exc multiplies by the reciprocal of the window's in-image tap
//   count, computed in the kernel as pool.py:104-114 computes it: a double
//   quotient 1.0/cnt rounded to f32.
//
// Two kernels:
// * pool_kernel: one thread per output element (neighbouring threads on
//   neighbouring channels, so loads and stores coalesce). Used for small
//   windows and for every f32 window.
// * pool_reduce_kernel: one block per (output pixel, group of 32 channels);
//   8 warps split the window's taps and reduce through shared memory. Used
//   for integer windows of at least REDUCE_TAPS taps, such as FusionNet's
//   28x28 global average pool, where a thread per output would make 784
//   serial loads. Integer max and wrapping integer sums do not depend on
//   the order, so the split is exact.
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "requant.cuh"

namespace {

constexpr int NT = 256;
constexpr int KIND_MAX = 0, KIND_AVG_INC = 1, KIND_AVG_EXC = 2;
constexpr int RY = 8;  // warps splitting the window in pool_reduce_kernel

struct PoolArgs {
  const void* x;
  void* out;
  int n, ih, iw, c, oh, ow, kh, kw, sh, sw, ph, pw;
  int down;
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

// Integer dtypes only. grid: (oh*ow*n, ceil(c/32)); block: (32, RY).
template <int DT, int KIND>
__global__ void __launch_bounds__(32 * RY) pool_reduce_kernel(PoolArgs a) {
  using T = typename dt_traits<DT>::T;
  __shared__ int32_t part[RY][32];
  const T* x = static_cast<const T*>(a.x);
  T* out = static_cast<T*>(a.out);
  const int pix = blockIdx.x;  // (n, oy, ox)
  const int ox = pix % a.ow;
  const int oy = (pix / a.ow) % a.oh;
  const int nn = pix / (a.ow * a.oh);
  const int ch = blockIdx.y * 32 + threadIdx.x;
  const bool live = ch < a.c;
  const int32_t pad = KIND == KIND_MAX ? int32_t(max_pad<DT>()) : 0;
  int32_t m = pad;
  uint32_t s = 0;
  for (int t = threadIdx.y; t < a.kh * a.kw; t += RY) {
    const int iy = oy * a.sh - a.ph + t / a.kw;
    const int ix = ox * a.sw - a.pw + t % a.kw;
    int32_t v = pad;
    if (live && iy >= 0 && iy < a.ih && ix >= 0 && ix < a.iw)
      v = x[(((size_t)nn * a.ih + iy) * a.iw + ix) * a.c + ch];
    if constexpr (KIND == KIND_MAX) m = v > m ? v : m;
    else s += static_cast<uint32_t>(v);
  }
  part[threadIdx.y][threadIdx.x] =
      KIND == KIND_MAX ? m : static_cast<int32_t>(s);
  __syncthreads();
  if (threadIdx.y != 0 || !live) return;
  for (int r = 1; r < RY; ++r) {
    const int32_t v = part[r][threadIdx.x];
    if constexpr (KIND == KIND_MAX) m = v > m ? v : m;
    else s += static_cast<uint32_t>(v);
  }
  const size_t o = ((size_t)pix) * a.c + ch;
  if constexpr (KIND == KIND_MAX) {
    out[o] = static_cast<T>(m);
  } else {
    out[o] = finish_avg<DT, KIND>(__int2float_rn(int32_t(s)), a, oy, ox);
  }
}

constexpr int REDUCE_TAPS = 64;

template <int DT, int KIND>
int launch(const PoolArgs& a, cudaStream_t s) {
  if constexpr (DT != DT_F32) {
    if (a.kh * a.kw >= REDUCE_TAPS) {
      const dim3 grid((unsigned)a.n * a.oh * a.ow,
                      (unsigned)((a.c + 31) / 32));
      pool_reduce_kernel<DT, KIND><<<grid, dim3(32, RY), 0, s>>>(a);
      return (int)cudaGetLastError();
    }
  }
  const long long total = (long long)a.n * a.oh * a.ow * a.c;
  long long blocks = (total + NT - 1) / NT;
  if (blocks > 132 * 32) blocks = 132 * 32;
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

extern "C" int df_pool(const void* x, void* out, int n, int ih, int iw, int c, int oh, int ow, int kh, int kw,
                       int sh, int sw, int ph, int pw, int kind, int down,
                       int dt, void* stream) {
  if ((long long)n * oh * ow * c == 0) return (int)cudaSuccess;
  PoolArgs a;
  a.x = x;
  a.out = out;
  a.n = n; a.ih = ih; a.iw = iw; a.c = c; a.oh = oh; a.ow = ow;
  a.kh = kh; a.kw = kw; a.sh = sh; a.sw = sw; a.ph = ph; a.pw = pw;
  a.down = down;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dt) {
    case DT_F32: return launch_kind<DT_F32>(a, kind, s);
    case DT_S32: return launch_kind<DT_S32>(a, kind, s);
    case DT_S8: return launch_kind<DT_S8>(a, kind, s);
    case DT_U8: return launch_kind<DT_U8>(a, kind, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
