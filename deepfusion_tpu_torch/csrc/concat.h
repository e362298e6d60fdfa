// The launcher of concat_relu_kernel (concat.cu): a plain C++ function that
// the registered op deepfusion_torch::concat_relu (torch_ops.cpp) calls.
// Neither side of it includes a PyTorch header in the other.
#pragma once

#include <cuda_runtime_api.h>

#include "dtypes.h"

// Inputs of one launch of concat_relu_kernel (its input table, 16 bytes an
// input, is a kernel parameter); concat_relu_launch launches once per group
// of up to this many inputs.
constexpr int CONCAT_MAX_IN = 128;

// srcs, row_bytes: host arrays of n_in >= 1 device pointers (16-byte
// aligned, rows contiguous) and of their pixel rows' widths in bytes
// (multiples of 16); dst: pixels rows of sum(row_bytes) bytes; dt: a DT_*
// code. Launches on `stream` once per group of up to CONCAT_MAX_IN inputs
// that holds any bytes, each writing its own columns of every output row,
// and returns cudaGetLastError() after the last, or cudaErrorInvalidValue
// for arguments the kernel does not take. *launches: the kernel launches
// it made (0 for an empty output), set on every return.
cudaError_t concat_relu_launch(const void* const* srcs, const int* row_bytes,
                               int n_in, void* dst, long long pixels,
                               bool relu, int dt, cudaStream_t stream,
                               int* launches);
