// unfold_cols_kernel: a conv's kw column taps folded into its channels.
//
// Replaces no TPU kernel: deepfusion_tpu/ops/conv.py pads a narrow input's
// channels and runs its taps as they are. The dense conv kernel
// (csrc/conv.cu) reads K as taps x the input's channels rounded up to one
// 32-byte wgmma k-step, so a 7x7 conv over 3 channels (ResNet-50's stem)
// executes 49 k-steps of 32 bytes for 147 real ones: 10.7x its MACs. Over
// this kernel's output the same conv is a kh x 1 conv of stride (sh, 1)
// over round_up(kw * ic, 32) channels (ops/conv.py: unfold_cols,
// _kernel_geometry): 7 k-steps, 224 K bytes a pixel (1.52x), the same
// integer sums, so the same answer bit for bit.
//
// What bounds it on the H100: device-memory bytes, the image read once and
// the unfolded rows written once (ResNet-50's stem at batch 256: 38.5 MB
// in, 205.5 MB out, the size of the 16-channel pad it replaces; 0.073 ms at
// 3.35 TB/s). No arithmetic to speak of.
//
// Design: a block owns `rpb` consecutive input rows (n * ih rows in all).
// It stages each row in shared memory once, by coalesced byte loads, behind
// pw * ic zero bytes and followed by zeros, so every output pixel's window
// is one contiguous run of the staged row: output pixel ox's byte j < kw *
// ic is staged byte ox * sw * ic + j, with no test of the image's edge.
// Then each thread builds 16-byte output units (a pixel's cp bytes are cp /
// 16 units; consecutive threads, consecutive units) from five aligned
// 32-bit shared loads and four funnel shifts, zeroes the bytes past kw * ic
// and stores the unit with one 16-byte store.
#include <cuda_runtime.h>

#include <cstdint>

#include "unfold.h"

namespace {

constexpr int NT = 256;
constexpr int MAX_RPB = 8;            // rows a block
constexpr int SMEM_MAX = 48 * 1024;   // static-limit dynamic shared memory
constexpr int OVERREAD = 32;          // bytes a unit may read past its row

__global__ void __launch_bounds__(NT) unfold_cols_kernel(
    const uint8_t* __restrict__ src, uint8_t* __restrict__ dst,
    long long rows, int rpb, int span, int iw, int ic, int ow, int kw,
    int sw, int pw, int cp) {
  extern __shared__ uint32_t staged[];
  uint8_t* sb = reinterpret_cast<uint8_t*>(staged);
  const long long r0 = (long long)blockIdx.x * rpb;
  const int nr = (int)(rows - r0 < rpb ? rows - r0 : rpb);
  const int rb = iw * ic, lead = pw * ic;
  for (int r = 0; r < nr; ++r) {
    const uint8_t* in = src + (r0 + r) * rb;
#pragma unroll 4
    for (int i = threadIdx.x; i < span; i += NT) {
      const int j = i - lead;
      sb[r * span + i] = (j >= 0 && j < rb) ? in[j] : 0;
    }
  }
  __syncthreads();
  const int units = cp / 16, per_row = ow * units;
  const int k = kw * ic, step = sw * ic;
  uint4* out = reinterpret_cast<uint4*>(dst) + r0 * per_row;
  for (int u = threadIdx.x; u < nr * per_row; u += NT) {
    const int r = u / per_row, rem = u - r * per_row;
    const int ox = rem / units, j0 = (rem - ox * units) * 16;
    const int v = k - j0;   // the unit's real bytes, if below 16
    uint32_t w[4] = {0u, 0u, 0u, 0u};
    if (v > 0) {
      const int off = r * span + ox * step + j0;
      const uint32_t* p = staged + (off >> 2);
      const int sh = (off & 3) * 8;
      uint32_t a[5];
#pragma unroll
      for (int q = 0; q < 5; ++q) a[q] = p[q];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const uint32_t x = __funnelshift_r(a[q], a[q + 1], sh);
        const int b = v - 4 * q;   // real bytes of word q, if below 4
        w[q] = b >= 4 ? x : b <= 0 ? 0u : x & ((1u << (8 * b)) - 1u);
      }
    }
    out[u] = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

}  // namespace

cudaError_t unfold_cols_launch(const void* src, void* dst, long long rows,
                               int iw, int ic, int ow, int kw, int sw, int pw,
                               int cp, cudaStream_t stream) {
  if (rows < 0 || iw < 1 || ic < 1 || ow < 1 || kw < 1 || sw < 1 || pw < 0 ||
      cp % 16 || cp < kw * ic)
    return cudaErrorInvalidValue;
  if (rows == 0) return cudaSuccess;
  // a staged row: the zeros before it, the row, and every output pixel's
  // window, rounded up to 16 bytes so that each row starts aligned
  long long span = (long long)(pw + iw) * ic;
  const long long last = (long long)(ow - 1) * sw * ic + (long long)kw * ic;
  if (last > span) span = last;
  span = (span + 15) / 16 * 16;
  if (span + OVERREAD > SMEM_MAX) return cudaErrorInvalidValue;
  int rpb = (int)((SMEM_MAX - OVERREAD) / span);
  if (rpb > MAX_RPB) rpb = MAX_RPB;
  const long long blocks = (rows + rpb - 1) / rpb;
  if (blocks >= (1LL << 31) || (long long)rpb * ow * (cp / 16) >= (1LL << 31))
    return cudaErrorInvalidValue;
  const size_t smem = (size_t)(rpb * span + OVERREAD);
  unfold_cols_kernel<<<(unsigned)blocks, NT, smem, stream>>>(
      static_cast<const uint8_t*>(src), static_cast<uint8_t*>(dst), rows, rpb,
      (int)span, iw, ic, ow, kw, sw, pw, cp);
  return cudaGetLastError();
}
