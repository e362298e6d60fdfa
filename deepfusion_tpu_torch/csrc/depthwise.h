// The launcher of depthwise.cu's depthwise_kernel: a plain C++ function that
// the registered op deepfusion_torch::depthwise (torch_ops.cpp) calls.
// Neither side of it includes a PyTorch header in the other.
#pragma once

#include <cuda_runtime_api.h>

// src: NHWC u8 (n, ih, iw, c), c a multiple of 16, contiguous and 16-byte
// aligned; wcols: (3, c) 32-bit words, word [kj][o] holding channel o's
// weights of column kj, rows 0, 1, 2 in its bytes 0, 1, 2 (s8) and 0 in
// byte 3 (ops/depthwise.py: column_words); bias, scale: f32 over c; dst:
// NHWC u8 (n, oh, ow, c). A 3x3 depthwise conv, padding 1, stride 1 or 2,
// with the exact requant into u8 (ReLU, round half to even, saturate).
// Launches depthwise_kernel on `stream` (none for an empty batch) and
// returns cudaGetLastError(), or cudaErrorInvalidValue for arguments it
// does not take.
cudaError_t depthwise_launch(const void* src, const void* wcols,
                             const void* bias, const void* scale, void* dst,
                             int n, int ih, int iw, int oh, int ow, int c,
                             int stride, cudaStream_t stream);
