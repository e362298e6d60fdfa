// The launchers of pool.cu's kernels (pool_vec_kernel, pool_split_kernel,
// pool_kernel) and sum_relu.cu's sum_relu_kernel: plain C++ functions that
// the registered ops deepfusion_torch::pool and sum_relu (ops_pool.cpp)
// call. Neither side of it includes a PyTorch header in the other.
#pragma once

#include <cuda_runtime_api.h>

#include "dtypes.h"

// x: NHWC (n, ih, iw, c) of dtype code dt, contiguous and 16-byte aligned;
// out: NHWC (n, oh, ow, c) of dt. kind: 0 max, 1 avg_inc, 2 avg_exc (as
// ops/pool.py numbers them); down: an integer average rounds down, else to
// nearest even. Launches one of pool.cu's
// kernels on `stream` (none for an empty output) and returns
// cudaGetLastError(), or the error that kept it from launching.
cudaError_t pool_launch(const void* x, void* out, int n, int ih, int iw,
                        int c, int oh, int ow, int kh, int kw, int sh, int sw,
                        int ph, int pw, int kind, int down, int dt,
                        cudaStream_t stream);

// out = a + b (+ ReLU) over nbytes bytes of dtype code dt, saturating for
// integers; all three contiguous and 16-byte aligned. Launches
// sum_relu_kernel on `stream` (none for no bytes).
cudaError_t sum_relu_launch(const void* a, const void* b, void* out,
                            long long nbytes, bool relu, int dt,
                            cudaStream_t stream);
