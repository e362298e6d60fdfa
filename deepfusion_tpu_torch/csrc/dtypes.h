// dtype codes: the values of deepfusion_tpu_torch.types.dtype. Shared by the
// kernels (requant.cuh) and by the host-only op registration
// (torch_ops.cpp), which maps a tensor's scalar type onto them.
#pragma once

enum : int { DT_F32 = 1, DT_S32 = 2, DT_S8 = 3, DT_U8 = 4 };
