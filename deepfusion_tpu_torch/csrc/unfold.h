// The launcher of unfold.cu's unfold_cols_kernel: a plain C++ function that
// the registered op deepfusion_torch::unfold_cols (ops_conv.cpp) calls.
// Neither side of it includes a PyTorch header in the other.
#pragma once

#include <cuda_runtime_api.h>

// src: u8 NHWC rows (rows = n * ih, each iw * ic bytes), contiguous and
// 16-byte aligned; dst: u8 (rows, ow, cp), cp a multiple of 16 and at least
// kw * ic. Writes dst[r][ox][kj * ic + c] = src[r][ox * sw - pw + kj][c]
// (0 outside the row) for kj < kw, and 0 in the bytes past kw * ic: the
// input of a conv whose kw column taps were folded into its channels
// (ops/conv.py: unfold_cols). Launches unfold_cols_kernel on `stream` (none
// for no rows) and returns cudaGetLastError(), or cudaErrorInvalidValue
// for arguments it does not take (a row window over the shared memory of a
// block, 48 KB).
cudaError_t unfold_cols_launch(const void* src, void* dst, long long rows,
                               int iw, int ic, int ow, int kw, int sw, int pw,
                               int cp, cudaStream_t stream);
