"""Requantization epilogue, plain PyTorch.

The same chain as ``deepfusion_tpu/ops/requant.py`` (``requant`` and
``requant_to_u8_centered``) and as the kernels' device functions in
``csrc/requant.cuh``:

    s32 acc -> f32 -> +bias -> *scale -> ReLU (forced for u8) -> round -> saturate

Each step is one correctly rounded IEEE operation on float32 tensors, so
the result is bitwise that of the JAX package. Rounding is half-to-even
(``torch.round``) or floor. The f32 -> s32 conversion saturates at
[-2^31, 2^31-1] as the JAX kernels do, with an explicit clamp: a plain
``.to(torch.int32)`` wraps to -2^31 on overflow (ROADMAP finding C1).
"""
from __future__ import annotations

import torch

from ..types import dtype, round_mode

_S32_MAX_F32 = 2147483520.0  # largest f32 below 2^31


def relu_f32(x: torch.Tensor) -> torch.Tensor:
    """ReLU as ``jnp.maximum(x, 0.0)``: -0.0 becomes +0.0, NaN stays NaN
    (``torch.clamp_min`` would keep -0.0)."""
    return torch.where(x <= 0, torch.zeros((), dtype=x.dtype,
                                           device=x.device), x)


def round_f32(x: torch.Tensor, mode: round_mode) -> torch.Tensor:
    return torch.round(x) if mode == round_mode.nearest else torch.floor(x)


def saturate(x: torch.Tensor, dst: dtype) -> torch.Tensor:
    """f32 holding integral values -> dst with saturation."""
    if dst == dtype.f32:
        return x
    if dst == dtype.s32:
        y = x.clamp(-2147483648.0, _S32_MAX_F32).to(torch.int32)
        return torch.where(x >= 2147483648.0,
                           torch.full((), 2147483647, dtype=torch.int32,
                                      device=x.device), y)
    lo, hi = (-128.0, 127.0) if dst == dtype.s8 else (0.0, 255.0)
    return x.clamp(lo, hi).to(torch.int32).to(dst.torch)


def requant(acc: torch.Tensor, bias, scale: torch.Tensor, with_relu: bool,
            mode: round_mode, dst: dtype) -> torch.Tensor:
    """acc: (..., oc) int32; bias: (oc,) f32 or None; scale: (oc,) f32."""
    x = acc.to(torch.float32)
    if bias is not None:
        x = x + bias
    x = x * scale
    if with_relu or dst == dtype.u8:
        x = relu_f32(x)
    if dst == dtype.f32:
        return x
    return saturate(round_f32(x, mode), dst)


def requant_to_u8(acc: torch.Tensor, bias, scale: torch.Tensor,
                  mode: round_mode) -> torch.Tensor:
    """The fused conv's intermediate: ReLU always, u8 always."""
    return requant(acc, bias, scale, True, mode, dtype.u8)
