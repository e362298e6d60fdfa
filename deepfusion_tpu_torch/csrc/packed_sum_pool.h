// The launcher of packed_sum_pool.cu's kernels (packed_sum_pool_kernel,
// packed_maxpool2_kernel): a plain C++ function that the registered op
// deepfusion_torch::packed_sum_pool (ops_packed.cpp) calls. Neither side of
// it includes a PyTorch header in the other.
#pragma once

#include <cuda_runtime_api.h>

// Inputs of one launch of packed_sum_pool_kernel (its input table, 16
// bytes an input, is a kernel parameter); packed_sum_pool_launch launches
// once per group of up to this many inputs.
constexpr int SUM_POOL_MAX_IN = 128;

// ys/y_cps: n_y inputs joined along the lanes (any lane counts >= 1,
// summing to cp; one input of a multiple of 16 lanes for the pool alone);
// r: the sum's right operand with cp lanes (null without sum); rows, iwp:
// the inputs' padded geometry; out: (n, rows * iwp, cp), or with pool (n,
// rows / 2 * iwp / 2, cp). All 16-byte aligned and contiguous. Launches
// packed_maxpool2_kernel for the pool alone, else packed_sum_pool_kernel
// (once per group of SUM_POOL_MAX_IN inputs), on `stream` (none for an
// empty output) and returns cudaGetLastError() after the last, or the
// error that kept it from launching. *launches: the kernel launches it
// made, set on every return.
cudaError_t packed_sum_pool_launch(const void* const* ys, const int* y_cps,
                                   int n_y, const void* r, void* out, int n,
                                   int rows, int iwp, int cp, bool sum,
                                   bool pool, cudaStream_t stream,
                                   int* launches);
