// A variant of csrc/concat.cu for tools/stage_ab.py, which copies the
// package and puts this file in place of csrc/concat.cu; nothing builds it
// otherwise. concat_relu_kernel<DT> as a staged copy:
//
// Design. The TPU kernel makes one full-width store per tile, because
// per-source partial-lane stores stalled its write pipeline
// (concat.py:61-75). Here a block owns a tile of P whole output pixel rows,
// whose output is one contiguous run of 16-byte units:
//   1. stage: each input's slice of the tile's pixels is contiguous in that
//      input; the block copies the slices into shared memory one after the
//      other (input i at P x its first column, plus i units so that
//      neighbouring narrow inputs fall in other banks), 16-byte loads
//      spread over all its threads. A thread finds the slice of its unit
//      by walking the slices' ends, which only moves forward: no divide.
//   2. store: thread (tx, ty) holds output column tx (found in the inputs'
//      column table once, by a binary search) and pixels ty, ty + by, ...;
//      it reads its unit from the staged slice, applies the ReLU on 32-bit
//      words (relu_word<DT>) and stores it. With bx = the row's units (up
//      to the block), consecutive threads store consecutive units: every
//      warp writes consecutive addresses and the tile leaves as one run.
// The input table (pointer, units, first column: 16 bytes an input, 2 KB
// for CONCAT_MAX_IN) is a __grid_constant__ parameter, so any count up to
// CONCAT_MAX_IN takes one launch; more launch once per group, each writing
// its columns of every output row. A row wider than TILE_UNITS is split
// into column chunks of one pixel (each input's part of one pixel row is
// contiguous too). P is chosen so that the grid gives each SM several
// blocks where the image allows (FusionNet's branch merge: 523 tiles of 48
// pixels; the reference's 244x244 s8 set: 11,341 of 21).
//
// Staging with 1-D bulk copies (cp.async.bulk, one per input slice, all
// issued by one thread, completing on one mbarrier) in place of the loads
// is STAGE_BULK; tools/stage_ab.py builds it as the variant "bulk".

#include <cuda_runtime.h>

#include <cstdint>

#include "concat.h"
#include "requant.cuh"
#include "wgmma_tma.cuh"

namespace {

constexpr int NT = 256;
constexpr int SMS = 132;
constexpr int BLOCKS_PER_SM = 4;   // the tile size aims at this many blocks
constexpr int TILE_UNITS = 1024;   // staged units of a tile: 16 KB
constexpr int UNROLL = 4;          // loads in flight per thread
constexpr bool STAGE_BULK = false;

struct ConcatIn {
  const uint4* src;  // 16-byte aligned, pixel rows contiguous
  int units;         // 16-byte units per pixel row
  int col;           // first unit of the input in the group's columns
};

struct ConcatArgs {
  ConcatIn in[CONCAT_MAX_IN];
  int n_in;
  int out_units;  // units per output pixel row: the output's row stride
  int col0;       // the group's first unit in the output row
  int width;      // the group's units per pixel row
  int pixels;
  int tile_px;    // P: pixels of a tile
  int chunk;      // units of a tile's column chunk (width unless P is 1)
  int chunks;     // column chunks per pixel range
  uint4* dst;
};

template <int DT>
__device__ __forceinline__ uint32_t relu_word(uint32_t w) {
  if constexpr (DT == DT_S8) {
    return __vmaxs4(w, 0u);
  } else if constexpr (DT == DT_S32) {
    return static_cast<int32_t>(w) < 0 ? 0u : w;
  } else if constexpr (DT == DT_F32) {
    return __float_as_uint(relu_f32(__uint_as_float(w)));
  } else {
    return w;  // u8: ReLU is the identity
  }
}

__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// one block per tile: (pixel range, column chunk); concat_relu_launch
// refuses pixels * out_units >= 2^31, so every unit index fits an int
template <int DT>
__global__ void __launch_bounds__(NT)
    concat_relu_kernel(const __grid_constant__ ConcatArgs a, int relu) {
  extern __shared__ uint4 stage[];
  __shared__ int s_cs[CONCAT_MAX_IN], s_ce[CONCAT_MAX_IN];
  __shared__ const uint4* s_run[CONCAT_MAX_IN];
  __shared__ uint64_t bar;
  const int tid = threadIdx.x;
  const int range = a.chunks == 1 ? blockIdx.x : blockIdx.x / a.chunks;
  const int c0 = (blockIdx.x - range * a.chunks) * a.chunk;
  const int pix0 = range * a.tile_px;
  const int pt = min(a.tile_px, a.pixels - pix0);
  const int wt = min(a.chunk, a.width - c0);
  // each input's part of the chunk [c0, c0 + wt), in the chunk's columns,
  // and the first unit of its slice (a slice is contiguous: whole rows of
  // the input, or a part of one pixel row when P is 1). A warp reads one
  // entry of the table at a time: the parameter lives in the constant
  // bank, which serializes a warp's reads of distinct addresses.
  for (int i = tid >> 5; i < a.n_in; i += NT / 32) {
    const ConcatIn in = a.in[i];
    if ((tid & 31) == 0) {
      const int cs = min(max(in.col - c0, 0), wt);
      s_cs[i] = cs;
      s_ce[i] = min(max(in.col + in.units - c0, 0), wt);
      s_run[i] = in.src + (size_t)pix0 * in.units + (c0 + cs - in.col);
    }
  }
  if (STAGE_BULK && tid == 0) {
    mbar_init(&bar, 1);
    mbar_init_fence();
  }
  __syncthreads();

  const int total = pt * wt;
  if constexpr (STAGE_BULK) {
    if (tid == 0) {
      mbar_expect_tx(&bar, total * 16u);
      for (int i = 0; i < a.n_in; ++i) {
        const int len = pt * (s_ce[i] - s_cs[i]);
        if (len > 0) bulk_copy(stage + pt * s_cs[i] + i, s_run[i], len * 16u,
                               &bar);
      }
    }
    mbar_wait(&bar, 0);
  } else {
    int i = 0;  // the slice of this thread's unit: only moves forward
    for (int g0 = tid; g0 < total; g0 += UNROLL * NT) {
      uint4 v[UNROLL];
      int at[UNROLL];
#pragma unroll
      for (int k = 0; k < UNROLL; ++k) {
        const int g = g0 + k * NT;
        at[k] = -1;
        if (g < total) {
          while (g >= pt * s_ce[i]) ++i;
          at[k] = g + i;
          v[k] = __ldg(s_run[i] + (g - pt * s_cs[i]));
        }
      }
#pragma unroll
      for (int k = 0; k < UNROLL; ++k)
        if (at[k] >= 0) stage[at[k]] = v[k];
    }
    __syncthreads();
  }

  const int bx = min(wt, NT), by = NT / bx;
  const int tx = tid % bx, ty = tid / bx;
  if (ty >= by) return;
  for (int c = tx; c < wt; c += bx) {
    int lo = 0, hi = a.n_in - 1;  // the input holding column c
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (s_ce[mid] > c) hi = mid;
      else lo = mid + 1;
    }
    const int w = s_ce[lo] - s_cs[lo];
    const uint4* s = stage + pt * s_cs[lo] + lo + (c - s_cs[lo]);
    uint4* d = a.dst + pix0 * a.out_units + a.col0 + c0 + c;
    for (int p = ty; p < pt; p += by) {
      uint4 v = s[p * w];
      if (relu) {
        v.x = relu_word<DT>(v.x);
        v.y = relu_word<DT>(v.y);
        v.z = relu_word<DT>(v.z);
        v.w = relu_word<DT>(v.w);
      }
      d[p * a.out_units] = v;
    }
  }
}

template <int DT>
cudaError_t launch(const ConcatArgs& a, int relu, long long tiles,
                   size_t smem, cudaStream_t s) {
  concat_relu_kernel<DT><<<(unsigned)tiles, NT, smem, s>>>(a, relu);
  return cudaGetLastError();
}

}  // namespace

cudaError_t concat_relu_launch(const void* const* srcs, const int* row_bytes,
                               int n_in, void* dst, long long pixels,
                               bool relu, int dt, cudaStream_t s,
                               int* launches) {
  *launches = 0;
  if (n_in < 1) return cudaErrorInvalidValue;
  if (dt != DT_F32 && dt != DT_S32 && dt != DT_S8 && dt != DT_U8)
    return cudaErrorInvalidValue;
  long long out_units = 0;
  for (int i = 0; i < n_in; ++i) {
    if (row_bytes[i] < 0 || row_bytes[i] % 16) return cudaErrorInvalidValue;
    out_units += row_bytes[i] / 16;
  }
  const long long total = pixels * out_units;
  if (total >= (1LL << 31)) return cudaErrorInvalidValue;
  if (total == 0) return cudaSuccess;
  const int r = relu ? 1 : 0;
  // one launch per group of up to CONCAT_MAX_IN inputs, each writing the
  // group's columns of every output row
  int col0 = 0;
  for (int g0 = 0; g0 < n_in; g0 += CONCAT_MAX_IN) {
    const int n = n_in - g0 < CONCAT_MAX_IN ? n_in - g0 : CONCAT_MAX_IN;
    ConcatArgs a;
    a.n_in = n;
    a.out_units = (int)out_units;
    a.col0 = col0;
    a.pixels = (int)pixels;
    a.dst = static_cast<uint4*>(dst);
    int width = 0;
    for (int i = 0; i < n; ++i) {
      a.in[i].src = static_cast<const uint4*>(srcs[g0 + i]);
      a.in[i].units = row_bytes[g0 + i] / 16;
      a.in[i].col = width;
      width += a.in[i].units;
    }
    col0 += width;
    if (width == 0) continue;
    a.width = width;
    if (width > TILE_UNITS) {  // a row wider than a tile: one pixel, chunks
      a.tile_px = 1;
      a.chunk = TILE_UNITS;
      a.chunks = (width + TILE_UNITS - 1) / TILE_UNITS;
    } else {
      const long long fill =
          (pixels + SMS * BLOCKS_PER_SM - 1) / (SMS * BLOCKS_PER_SM);
      const int fit = TILE_UNITS / width;
      a.tile_px = (int)(fill < fit ? (fill < 1 ? 1 : fill) : fit);
      a.chunk = width;
      a.chunks = 1;
    }
    const long long tiles =
        (pixels + a.tile_px - 1) / a.tile_px * (long long)a.chunks;
    const size_t smem = (size_t)(a.tile_px * a.chunk + n) * 16;
    cudaError_t rc;
    switch (dt) {
      case DT_F32: rc = launch<DT_F32>(a, r, tiles, smem, s); break;
      case DT_S32: rc = launch<DT_S32>(a, r, tiles, smem, s); break;
      case DT_S8: rc = launch<DT_S8>(a, r, tiles, smem, s); break;
      default: rc = launch<DT_U8>(a, r, tiles, smem, s); break;
    }
    ++*launches;
    if (rc != cudaSuccess) return rc;
  }
  return cudaSuccess;
}
