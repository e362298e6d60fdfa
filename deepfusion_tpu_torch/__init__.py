"""deepfusion_tpu_torch — the PyTorch / CUDA port of deepfusion_tpu.

Fused INT8 inference primitives for NVIDIA Hopper (sm_90a), written as CUDA
kernels by hand (``csrc/``), with the JAX package ``deepfusion_tpu`` as the
reference they are held against bit for bit. Each op runs its CUDA kernel on
CUDA tensors and its plain PyTorch version on CPU tensors.

Ported so far: FusionNet's dense serving path — ``ops.conv`` (with the
deep-fused 1x1), ``ops.concat``, ``ops.pool`` (pooling and
eltwise-sum+ReLU), ``models.FusionNet`` and ``serving.BatchServer`` — and
its packed serving path: ``ops.packed`` (the packed conv with 1..n inputs,
the packed residual sum and 2x2 max pool) and ``FusionNet.packed_call``;
and ResFusionNet's serving paths, dense and packed: the conv sum post-op,
strided packed convs on the space-to-depth grid, ``ops.convpool`` (the
fused conv+pool kernel), ``ops.pool.conv_relu_pool`` and
``models.ResFusionNet``; VGGFusion's serving paths (``ops.mega``, the conv
pair in one kernel, and ``models.VGGFusion``); and the sharded path
``parallel`` (dp / tp / sp wrappers over a mesh of torch devices, and
``parallel.plan.three_stage_plan``, and ``parallel.distributed``, the
process group over ``torch.distributed``).

Two API layers, as in the JAX package:
  * functional: ``deepfusion_tpu_torch.ops.concat/conv/pool/...`` over
    torch tensors;
  * object (reference parity): ``deepfusion_tpu_torch.memory`` + the
    factories ``concat()/conv()/pool()/eltwise_sum_relu()``, which return
    ops with ``submit()`` (``api.py``, ``include/deepfusion.h:105-145``).
"""
from . import config, ops, serving, types, utils  # noqa: F401
from .api import concat, conv, eltwise_sum_relu, op, pool  # noqa: F401
from .config import (ConcatConfig, ConvConfig, PoolConfig,  # noqa: F401
                     device_capabilities)
from .types import (dtype, f32, format, memory, round_mode, s8,  # noqa: F401
                    s32, u8)

__version__ = "0.1.0"
