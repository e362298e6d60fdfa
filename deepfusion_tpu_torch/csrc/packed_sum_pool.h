// The launcher of packed_sum_pool.cu's kernels (packed_sum_pool_kernel,
// packed_maxpool2_kernel): a plain C++ function that the registered op
// deepfusion_torch::packed_sum_pool (ops_packed.cpp) calls. Neither side of
// it includes a PyTorch header in the other.
#pragma once

#include <cuda_runtime_api.h>

// Inputs of one launch.
constexpr int SUM_POOL_MAX_IN = 4;

// ys/y_cps: n_y inputs joined along the lanes (each lane count a multiple
// of 16, summing to cp; one input for the pool alone); r: the sum's right
// operand with cp lanes (null without sum); rows, iwp: the inputs' padded
// geometry; out: (n, rows * iwp, cp), or with pool (n, rows / 2 * iwp / 2,
// cp). Launches packed_maxpool2_kernel for the pool alone, else
// packed_sum_pool_kernel, on `stream` (none for an empty output) and
// returns cudaGetLastError(), or the error that kept it from launching.
cudaError_t packed_sum_pool_launch(const void* const* ys, const int* y_cps,
                                   int n_y, const void* r, void* out, int n,
                                   int rows, int iwp, int cp, bool sum,
                                   bool pool, cudaStream_t stream);
