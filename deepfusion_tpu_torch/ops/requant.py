"""Requantization epilogue, plain PyTorch.

The same chain as ``deepfusion_tpu/ops/requant.py`` (``requant`` and
``requant_to_u8_centered``) and as the kernels' device functions in
``csrc/requant.cuh``:

    s32 acc -> f32 -> +bias -> *scale -> ReLU (forced for u8) -> round -> saturate

With the eltwise-sum post-op the sum joins after rounding, in the exact
integer domain, as the JAX package orders it (``requant.py:72-84``): for
an integer dst ``round(x) + round(sum * sum_scale)``, then ReLU, then
saturate; for an f32 dst an f32 add, then ReLU.

Each step is one correctly rounded IEEE operation on float32 tensors, so
the result is bitwise that of the JAX package. Rounding is half-to-even
(``torch.round``) or floor. The f32 -> s32 conversion saturates at
[-2^31, 2^31-1] as the JAX kernels do, with an explicit clamp: a plain
``.to(torch.int32)`` wraps to -2^31 on overflow (ROADMAP finding C1).
"""
from __future__ import annotations

import numpy as np
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


def sum_term(src: torch.Tensor, sum_scale: float) -> torch.Tensor:
    """The f32 eltwise-sum operand: ``f32(src) * f32(sum_scale)``. 8-bit
    and f32 operands convert exactly, s32 rounds to nearest."""
    return src.to(torch.float32) * float(np.float32(sum_scale))


def requant_presat(acc: torch.Tensor, bias, scale: torch.Tensor,
                   with_relu: bool, mode: round_mode, dst: dtype,
                   sum_term=None) -> torch.Tensor:
    """requant() up to the final cast: f32 values clipped to dst's range,
    integral for an integer dst (``convpool.py:_requant_presat``).

    acc: (..., oc) int32; bias: (oc,) f32 or None; scale: (oc,) f32;
    sum_term: f32 like acc, or None."""
    x = acc.to(torch.float32)
    if bias is not None:
        x = x + bias
    x = x * scale
    relu = with_relu or dst == dtype.u8
    if sum_term is not None and dst != dtype.f32:
        x = round_f32(x, mode) + round_f32(sum_term, mode)
        if relu:
            x = relu_f32(x)
    else:
        if sum_term is not None:
            x = x + sum_term
        if relu:
            x = relu_f32(x)
        if dst != dtype.f32:
            x = round_f32(x, mode)
    if dst == dtype.s32:
        return x.clamp(-2147483648.0, 2147483648.0)
    if dst != dtype.f32:
        lo, hi = (-128.0, 127.0) if dst == dtype.s8 else (0.0, 255.0)
        return x.clamp(lo, hi)
    return x


def requant(acc: torch.Tensor, bias, scale: torch.Tensor, with_relu: bool,
            mode: round_mode, dst: dtype, sum_term=None) -> torch.Tensor:
    """The full epilogue: ``requant_presat``, then the saturating cast."""
    return saturate(requant_presat(acc, bias, scale, with_relu, mode, dst,
                                   sum_term), dst)


def requant_to_u8(acc: torch.Tensor, bias, scale: torch.Tensor,
                  mode: round_mode, sum_rounded=None) -> torch.Tensor:
    """The fused conv's intermediate and the packed output: ReLU always, u8
    always. ``sum_rounded`` (f32, integral, so its own round is exact)
    joins after this stage's round, as ``requant_to_u8_centered``'s packed
    sum does."""
    return requant(acc, bias, scale, True, mode, dtype.u8, sum_rounded)
