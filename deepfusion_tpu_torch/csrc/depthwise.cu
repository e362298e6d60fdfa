// depthwise_kernel<S>: a 3x3 depthwise INT8 conv, padding 1, stride S (1 or
// 2), over NHWC u8, requantized exactly into u8 with ReLU.
//
// Replaces no TPU kernel: deepfusion_tpu has no depthwise conv (its conv
// config refuses groups other than 1). MobileNetV2's 17 inverted residual
// blocks run one each (models/mobilenetv2.py).
//
// What it computes, per output pixel (n, y, x) and channel o:
//   acc = sum_{ki,kj} src[n, y*S - 1 + ki, x*S - 1 + kj, o] * w[o, ki, kj]
//   (taps outside the image read 0), an s32 of magnitude at most
//   9 * 255 * 128 < 2^22;
//   dst = f32(acc) + bias[o], * scale[o], ReLU, rounded half to even,
//   saturated to 255 (requant.cuh: requant_u8_small), bitwise
//   ops/depthwise.py:depthwise_plain.
//
// What bounds it on the H100: device-memory bytes. A layer reads its input
// once and writes its output once, 9 multiply-adds an output byte
// (MobileNetV2's 17 at batch 256: 1.55 GB for 5.3 G MACs, 0.46 ms at 3.35
// TB/s), and only the CUDA cores can do them (no tensor-core shape takes a
// product per channel), so the arithmetic must stay under the bytes.
//
// Design: a thread owns one 4-channel word w of one output row (n, y) and
// walks the row's ow pixels, keeping the 3x3 window in registers as it
// slides: each step loads only the S new input columns (three rows' words
// each, straight from device memory through the L1), so every input word
// is loaded three times (once per output row that reads it), not nine.
// The next step's words are loaded before this step's arithmetic, so the
// loads overlap it. A column's three row words are transposed by six byte
// permutes into one word a channel (rows 0, 1, 2 in bytes 0, 1, 2), which
// serves the three outputs that read that column; each output channel then
// takes one dp4a (u8 x s8) per column against the column's weight word,
// whose byte 3 is 0. The thread's 12 weight words, 4 biases and 4 scales
// stay in registers. Consecutive threads take consecutive words of a
// pixel, then the next output row, so a warp's loads and stores fill whole
// 32-byte sectors. The requant takes no conversion instruction
// (requant_u8_small), and the four results are one 32-bit store.
// (A first version staged each tile's input rows in shared memory; with a
// block's loads and arithmetic in series and every block in step, it ran
// at about a third of the bound: PERF.md §6, the row DW.)
#include <cuda_runtime.h>

#include <cstdint>

#include "depthwise.h"
#include "requant.cuh"

namespace {

constexpr int NT = 256;  // threads a block

struct DwArgs {
  const uint32_t* src;  // NHWC u8 as words: wpp a pixel
  const uint4* wcols;   // (3, wpp): four channels' words of a column
  const float4* bias;
  const float4* scale;
  uint32_t* dst;
  long long rows;  // n * oh * wpp: one thread each
  int ih, iw, oh, ow, wpp;
};

// d = c + the dot product of a's four u8 and b's four s8 bytes.
__device__ __forceinline__ int dp4a_u8s8(uint32_t a, uint32_t b, int c) {
  int d;
  asm("dp4a.u32.s32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

// One input column's three row words, 0 outside the image.
struct Raw {
  uint32_t r0, r1, r2;
};
// The same column as one word a channel: rows 0, 1, 2 in bytes 0, 1, 2.
struct Col {
  uint32_t c0, c1, c2, c3;
};

__device__ __forceinline__ Raw load_col(const uint32_t* row0, int xi,
                                        int iw, int wpp, bool in0, bool in2) {
  Raw r{0u, 0u, 0u};
  if (xi >= 0 && xi < iw) {
    const uint32_t* p = row0 + (long long)xi * wpp;
    const long long pitch = (long long)iw * wpp;
    if (in0) r.r0 = __ldg(p);
    r.r1 = __ldg(p + pitch);
    if (in2) r.r2 = __ldg(p + 2 * pitch);
  }
  return r;
}

__device__ __forceinline__ Col transpose(const Raw& r) {
  const uint32_t lo = __byte_perm(r.r0, r.r1, 0x5140);  // a0 b0 a1 b1
  const uint32_t hi = __byte_perm(r.r0, r.r1, 0x7362);  // a2 b2 a3 b3
  return Col{__byte_perm(lo, r.r2, 0x0410), __byte_perm(lo, r.r2, 0x0532),
             __byte_perm(hi, r.r2, 0x0610), __byte_perm(hi, r.r2, 0x0732)};
}

template <int S>
__global__ void __launch_bounds__(NT)
    depthwise_kernel(const __grid_constant__ DwArgs a) {
  const long long t = (long long)blockIdx.x * NT + threadIdx.x;
  if (t >= a.rows) return;
  const int w = (int)(t % a.wpp);  // the thread's word of a pixel
  const long long ny = t / a.wpp;
  const int y = (int)(ny % a.oh);
  const long long nn = ny / a.oh;
  const uint4 wk0 = a.wcols[w], wk1 = a.wcols[a.wpp + w],
              wk2 = a.wcols[2 * a.wpp + w];
  const float4 bi = a.bias[w], sc = a.scale[w];
  // the window's rows y*S - 1 .. y*S + 1; row0 points at the first, which
  // is read only where it is in the image (in0), as the last (in2)
  const int iy = y * S - 1;
  const bool in0 = iy >= 0, in2 = iy + 2 < a.ih;
  const uint32_t* row0 =
      a.src + ((nn * a.ih + iy) * a.iw) * (long long)a.wpp + w;
  uint32_t* out = a.dst + ((nn * a.oh + y) * a.ow) * (long long)a.wpp + w;
  // the window's columns: left, middle, right of output x
  Col cl{0u, 0u, 0u, 0u}, cm, cr;
  Raw next[S];
  if constexpr (S == 1) {
    cm = transpose(load_col(row0, 0, a.iw, a.wpp, in0, in2));
    next[0] = load_col(row0, 1, a.iw, a.wpp, in0, in2);
  } else {
    next[0] = load_col(row0, 0, a.iw, a.wpp, in0, in2);
    next[1] = load_col(row0, 1, a.iw, a.wpp, in0, in2);
  }
  for (int x = 0; x < a.ow; ++x) {
    if constexpr (S == 1) {
      cr = transpose(next[0]);
      next[0] = load_col(row0, x + 2, a.iw, a.wpp, in0, in2);
    } else {
      cm = transpose(next[0]);
      cr = transpose(next[1]);
      next[0] = load_col(row0, 2 * x + 2, a.iw, a.wpp, in0, in2);
      next[1] = load_col(row0, 2 * x + 3, a.iw, a.wpp, in0, in2);
    }
    const int acc0 = dp4a_u8s8(cl.c0, wk0.x, dp4a_u8s8(cm.c0, wk1.x,
                                                      dp4a_u8s8(cr.c0, wk2.x, 0)));
    const int acc1 = dp4a_u8s8(cl.c1, wk0.y, dp4a_u8s8(cm.c1, wk1.y,
                                                      dp4a_u8s8(cr.c1, wk2.y, 0)));
    const int acc2 = dp4a_u8s8(cl.c2, wk0.z, dp4a_u8s8(cm.c2, wk1.z,
                                                      dp4a_u8s8(cr.c2, wk2.z, 0)));
    const int acc3 = dp4a_u8s8(cl.c3, wk0.w, dp4a_u8s8(cm.c3, wk1.w,
                                                      dp4a_u8s8(cr.c3, wk2.w, 0)));
    out[(long long)x * a.wpp] = requant_u8_small(acc0, bi.x, sc.x) |
                                requant_u8_small(acc1, bi.y, sc.y) << 8 |
                                requant_u8_small(acc2, bi.z, sc.z) << 16 |
                                requant_u8_small(acc3, bi.w, sc.w) << 24;
    if constexpr (S == 1) {
      cl = cm;
      cm = cr;
    } else {
      cl = cr;
    }
  }
}

}  // namespace

cudaError_t depthwise_launch(const void* src, const void* wcols,
                             const void* bias, const void* scale, void* dst,
                             int n, int ih, int iw, int oh, int ow, int c,
                             int stride, cudaStream_t stream) {
  if (n < 0 || c <= 0 || c % 16 || ih < 1 || iw < 1 ||
      (stride != 1 && stride != 2) || oh != (ih - 1) / stride + 1 ||
      ow != (iw - 1) / stride + 1)
    return cudaErrorInvalidValue;
  DwArgs a;
  a.src = static_cast<const uint32_t*>(src);
  a.wcols = static_cast<const uint4*>(wcols);
  a.bias = static_cast<const float4*>(bias);
  a.scale = static_cast<const float4*>(scale);
  a.dst = static_cast<uint32_t*>(dst);
  a.wpp = c / 4;
  a.rows = (long long)n * oh * a.wpp;
  a.ih = ih; a.iw = iw; a.oh = oh; a.ow = ow;
  if (a.rows == 0) return cudaSuccess;
  const long long blocks = (a.rows + NT - 1) / NT;
  if (blocks >= (1LL << 31)) return cudaErrorInvalidValue;
  if (stride == 1)
    depthwise_kernel<1><<<(unsigned)blocks, NT, 0, stream>>>(a);
  else
    depthwise_kernel<2><<<(unsigned)blocks, NT, 0, stream>>>(a);
  return cudaGetLastError();
}
