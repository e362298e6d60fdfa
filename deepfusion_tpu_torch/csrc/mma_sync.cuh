// Tensor-core building blocks shared by the mma.sync conv kernels, the
// fused conv+pool (convpool.cu) and the conv pair (pair_conv.cu): u8 x s8
// mma.sync m16n8k32, cp.async copies, the shared-memory geometry of a
// block, and the chunked multiply over one K chunk held in shared memory.
//
// A block has NT = 256 threads, 8 warps; each warp owns a 32 x 64 output
// tile (MI x NI mma tiles of s32 accumulators in registers). K streams
// through shared memory at most KCW int32 words (4*KCW input channels) at a
// time, in two buffers, so the next chunk loads while this one multiplies.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int NT = 256;      // threads per block: 8 warps
constexpr int MI = 2;        // m16 tiles per warp (32 pixel rows)
constexpr int NI = 8;        // n8 tiles per warp (64 output channels)
constexpr int KCW = 32;      // max K words (128 channels) per chunk

// D += A (16x32 u8, row) * B (32x8 s8, col), s32 accumulators.
__device__ __forceinline__ void mma_u8s8(int32_t (&d)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.u8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16-byte global -> shared copy; src_bytes 0 writes zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Shared-memory geometry of one block, the same on host and device. Args
// carries wc (warps along the channels), kcw (K words per chunk) and k1 (K
// of the fused 1x1).
struct Smem {
  int m, nb, lda, ldw, ldm;
  size_t in_words, w_words, mid_words;
  template <class Args>
  __host__ __device__ explicit Smem(const Args& a) {
    m = 32 * (8 / a.wc);
    nb = 64 * a.wc;
    lda = a.kcw + 4;                       // == 4 mod 8: conflict-free A
    ldw = nb + 8;                          // == 8 mod 32: conflict-free B
    ldm = (a.k1 / 4 + 31) / 32 * 32 + 4;   // == 4 mod 32
    in_words = (size_t)m * lda;
    w_words = (size_t)KCW * ldw;
    mid_words = (size_t)m * ldm;
  }
  __host__ __device__ size_t bytes(bool fuse) const {
    return 4 * (2 * (in_words + w_words) + 3 * (size_t)m +
                (fuse ? mid_words : 0));
  }
};

// rows x nbv words of a row-major int32 matrix (row pitch `pitch`) into
// shared memory (row pitch `ldw`), 16 bytes per copy.
__device__ __forceinline__ void issue_rows(uint32_t* dst, int ldw,
                                           const int32_t* src, size_t pitch,
                                           int rows, int nbv, int warp,
                                           int lane) {
  for (int k = warp; k < rows; k += NT / 32)
    for (int o4 = lane; o4 < nbv / 4; o4 += 32)
      cp_async16(dst + k * ldw + o4 * 4, src + k * pitch + o4 * 4, 16);
}

// acc += A[32 rows of the warp, ksteps*32 channels] * B[.., 64 columns].
// Each A register is XOR-ed with AXOR as it is loaded: 0x80808080 turns
// stored centered-s8 bytes (u8 ^ 0x80) back into u8 values.
template <uint32_t AXOR = 0u>
__device__ __forceinline__ void mma_chunk(int32_t (&acc)[MI][NI][4],
                                          const uint32_t* A, int lda,
                                          const uint32_t* B, int ldb,
                                          int ksteps, int ntiles, int g,
                                          int t) {
  for (int ks = 0; ks < ksteps; ++ks) {
    uint32_t af[MI][4];
#pragma unroll
    for (int mi = 0; mi < MI; ++mi) {
      const uint32_t* r0 = A + (mi * 16 + g) * lda + ks * 8;
      af[mi][0] = r0[t] ^ AXOR;
      af[mi][1] = r0[8 * lda + t] ^ AXOR;
      af[mi][2] = r0[t + 4] ^ AXOR;
      af[mi][3] = r0[8 * lda + t + 4] ^ AXOR;
    }
    const uint32_t* b = B + (ks * 8 + t) * ldb + g;
#pragma unroll
    for (int ni = 0; ni < NI; ++ni) {
      if (ni < ntiles) {  // warp-uniform
        const uint32_t b0 = b[ni * 8], b1 = b[4 * ldb + ni * 8];
#pragma unroll
        for (int mi = 0; mi < MI; ++mi) mma_u8s8(acc[mi][ni], af[mi], b0, b1);
      }
    }
  }
}

__device__ __forceinline__ void zero(int32_t (&acc)[MI][NI][4]) {
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mi][ni][r] = 0;
}

}  // namespace
