"""Single-kernel conv(+ReLU)(+sum) + 2x2/s2 pool: ``ConvPoolOp``.

The PyTorch counterpart of ``deepfusion_tpu/ops/convpool.py``. The conv
output is requantized to f32 values clipped to the dst's range
(``requant_presat``), pooled in f32 (max, or the average with the pool's
round mode) and cast once, so the result is bitwise ``pool(conv(...))``
while the conv output never reaches device memory. Calling the op on a
CUDA tensor launches ``convpool_kernel``, the pool mode of the dense conv
kernel (``csrc/conv.cu``: wgmma on TMA tiles, the pool in the epilogue);
on a CPU tensor it runs ``convpool_plain``, the plain PyTorch version of
the same function. Nothing else selects the path. The op derives the
K-major copy of its weights that the kernel's TMA reads, as ``ConvOp``
does, and ``convpool_plan`` reports the kernel's tiling for a call.

Legality (``pool2_fusable``) is the JAX rule's semantic part: not fused
with a 1x1, pool 2x2 / stride 2 / pad 0, even conv output h and w, and max
or a dst other than s32 (an s32 average can leave f32's exact-integer
range). Strided convs qualify; the kernel takes stride in its addressing (TMA's
element strides; the wrapper gathers strides above 8 away, as for
``ConvOp``). The JAX rule's VMEM clause (``_even_tile_unchunked``: a TPU
row tile that fits unchunked) describes TPU tiling and has no counterpart
here: the CUDA kernel's tiles hold whole 2x2 windows at every shape.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from .. import _build
from ..config import ConvConfig, PoolConfig
from ..types import dtype, round_mode
from ..utils.device import as_tensor, default_device
from ..utils.logger import check, check_eq
from ..utils.persist import dump_configs, load_configs
from . import layout
from .conv import (_kernel_geometry, _kernel_src, _weight_maps,
                   check_sum_src, conv_acc, conv_plan)
from .requant import requant_presat, round_f32, saturate, sum_term

_OPERAND_KEYS = ("w0", "bias0", "scale0")


def pool2_fusable(cfg: ConvConfig, pc: PoolConfig) -> bool:
    """Can (cfg, pc) run as one kernel? (See the module docstring.)"""
    return (not cfg.fuse_conv1x1
            and (pc.kh, pc.kw, pc.sh, pc.sw) == (2, 2, 2, 2)
            and (pc.ph, pc.pw, pc.pb, pc.pr) == (0, 0, 0, 0)
            and cfg.oh % 2 == 0 and cfg.ow % 2 == 0
            and (pc.kind == "max" or cfg.dst_dt != dtype.s32))


class ConvPoolOp(nn.Module):
    """Pre-packed fused conv(+ReLU)(+sum) + 2x2/s2 pool (one kernel)."""

    def __init__(self, cfg: ConvConfig, pc: PoolConfig, wei, bia=None,
                 device=None):
        super().__init__()
        check(pool2_fusable(cfg, pc), "geometry not single-kernel fusable "
                                      "(see convpool.pool2_fusable)")
        check_eq(tuple(np.shape(wei)), (cfg.oc, cfg.ic, cfg.kh, cfg.kw),
                 "conv weight shape (OIHW)")
        ocp = layout.conv_ocp(cfg.oc)
        ops = {"w0": layout.pack_conv_weights(wei, layout.conv_icp(cfg.ic),
                                              ocp),
               "bias0": layout.widen_bias(bia, ocp),
               "scale0": layout.widen_scales(cfg.conv0_scales, cfg.oc, ocp)}
        self._set_state(cfg, pc, ops, device)

    def _set_state(self, cfg: ConvConfig, pc: PoolConfig, ops: dict, device):
        self.cfg, self.pc = cfg, pc
        device = default_device(device)
        for k, shape in _operand_shapes(cfg).items():
            check_eq(tuple(ops[k].shape), shape, f"packed operand {k}")
            self.register_buffer(k, torch.as_tensor(np.asarray(ops[k]),
                                                    device=device))
        # the kernel's B operand, derived from the words as ConvOp derives
        # it: a non-persistent buffer, so save/load keep the word format
        self.register_buffer("w0k", layout.dense_kmajor_weights(
            self.w0, cfg.kh, cfg.kw), persistent=False)
        self.w1k = None
        self._wmaps = None   # (device pointers, their encoded tensor maps)
        self._geo = convpool_geo(cfg, pc)

    @property
    def device(self) -> torch.device:
        return self.w0.device

    def forward(self, src: torch.Tensor, sum_src=None) -> torch.Tensor:
        cfg = self.cfg
        src = as_tensor(src, self.device)
        check_eq(src.dtype, torch.uint8, "convpool src dtype")
        check_eq(tuple(src.shape[1:]), (cfg.ih, cfg.iw, cfg.ic),
                 "convpool src shape (NHWC, any batch)")
        check_eq(src.device, self.device, "convpool src device")
        sum_src = check_sum_src(cfg, src, sum_src)
        if src.device.type == "cpu":
            return convpool_plain(self, src, sum_src)
        return convpool_cuda(self, src, sum_src)

    def save(self, path: str):
        """Save the packed operands and the conv and pool configs."""
        arrs = {k: getattr(self, k).cpu().numpy() for k in _OPERAND_KEYS}
        np.savez(path, __cfg__=dump_configs(cfg=self.cfg, pc=self.pc),
                 **arrs)

    @classmethod
    def load(cls, path: str, device=None) -> "ConvPoolOp":
        with np.load(path, allow_pickle=False) as data:
            cfgs = load_configs(data["__cfg__"], cfg=ConvConfig,
                                pc=PoolConfig)
            ops = {k: data[k] for k in _OPERAND_KEYS}
        op = cls.__new__(cls)
        nn.Module.__init__(op)
        op._set_state(cfgs["cfg"], cfgs["pc"], ops, device)
        return op


def _operand_shapes(cfg: ConvConfig) -> dict:
    ocp = layout.conv_ocp(cfg.oc)
    return {"w0": (cfg.kh * cfg.kw, layout.conv_icp(cfg.ic) // 4, ocp),
            "bias0": (ocp,), "scale0": (ocp,)}


def convpool_plain(op: ConvPoolOp, src: torch.Tensor,
                   sum_src=None) -> torch.Tensor:
    """The plain PyTorch version of ``convpool_kernel``."""
    cfg, pc = op.cfg, op.pc
    w0 = layout.unpack_weights(op.w0, cfg.oc, cfg.ic, cfg.kh, cfg.kw)
    acc = conv_acc(src, w0, (cfg.sh, cfg.sw), (cfg.ph, cfg.pw))
    x = requant_presat(
        acc, op.bias0[:cfg.oc] if cfg.conv0_with_bias else None,
        op.scale0[:cfg.oc], cfg.conv0_relu, cfg.conv0_round, cfg.dst_dt,
        None if sum_src is None else sum_term(sum_src, cfg.sum_scale))
    n = x.shape[0]
    x = x.reshape(n, cfg.oh // 2, 2, cfg.ow // 2, 2, cfg.oc)
    x00, x01 = x[:, :, 0, :, 0], x[:, :, 0, :, 1]
    x10, x11 = x[:, :, 1, :, 0], x[:, :, 1, :, 1]
    if pc.kind == "max":
        y = torch.maximum(torch.maximum(x00, x01), torch.maximum(x10, x11))
    else:
        y = (((x00 + x01) + x10) + x11) * 0.25
        if cfg.dst_dt != dtype.f32:
            y = round_f32(y, pc.round)
    return saturate(y, cfg.dst_dt)


def convpool_plan(op: ConvPoolOp, n: int) -> dict:
    """The kernel's plan for a call at batch n, without launching
    (``conv.conv_plan`` of the pool mode): the tile (8 pixels wide, 16 or 8
    rows), lanes per pass and passes (a pass narrower than the widest wgmma
    N splits the lanes over the grid), work items (tile x pass), blocks,
    ring stages, shared bytes."""
    return conv_plan(op, n, pool=True)


def convpool_geo(cfg: ConvConfig, pc: PoolConfig) -> tuple:
    """The op's ints as ``torch.ops.deepfusion_torch.convpool`` takes them
    (``csrc/ops_conv.cpp``, ``ConvPoolGeo``), computed once per op: the
    kernel's geometry, channels and lanes, the epilogue's flags, the dst and
    sum dtype codes, the pool's kind and round mode."""
    ih, iw, ic, kh, kw, sh, sw, ph, pw = _kernel_geometry(cfg, unfold=False)
    return (ih, iw, ic, cfg.oh, cfg.ow, kh, kw, sh, sw, ph, pw,
            cfg.oc, layout.conv_ocp(cfg.oc), int(cfg.conv0_relu),
            int(cfg.conv0_round == round_mode.down),
            int(cfg.conv0_with_bias), cfg.dst_dt.value,
            cfg.sum_dt.value if cfg.with_sum else 0, int(pc.kind != "max"),
            int(pc.round == round_mode.down))


def convpool_cuda(op: ConvPoolOp, src: torch.Tensor,
                  sum_src=None) -> torch.Tensor:
    """Launch ``convpool_kernel`` on the current stream through
    ``torch.ops.deepfusion_torch.convpool``, which checks the arguments,
    aligns the inputs, allocates the output and launches in C++."""
    out = _build.op("convpool")(
        _kernel_src(op.cfg, src, unfold=False), _weight_maps(op, pool=True),
        op.bias0, op.scale0, sum_src, op._geo, op.cfg.sum_scale)
    _build.count_launch("convpool")
    return out
