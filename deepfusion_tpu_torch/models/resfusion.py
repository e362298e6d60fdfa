"""ResFusionNet: the ResNet-style INT8 CNN, dense and packed-domain forwards.

The PyTorch counterpart of ``deepfusion_tpu/models/resfusion.py``: the same
layers and the same numpy-RNG weight draw (``_mkconv``, in the order stem,
block1, down, block2, head), so ``ResFusionNet(cfg)`` in both packages holds
the same weights for the same seed. It runs the op families FusionNet
bypasses: a strided 3x3/s2 stem, a fused 3x3+1x1 block whose epilogue adds
the block input (the conv sum post-op), and the single-kernel
conv+ReLU+maxpool downsample (``ConvPoolOp``). Weights made by the JAX
package cross over with ``ResFusionNet.from_numpy_params``.

``packed_call`` is the same forward with every activation in the packed
domain, bitwise equal to the dense one: the stem runs on the s2d grid, the
residual joins block1's epilogue as a packed sum operand, the downsample is
a packed conv and the packed 2x2 max pool. ``packed_module()`` wraps it for
``serving.BatchServer``; ``jit()`` and ``jit_packed()`` are the two forwards
as compiled callables (``models/graphed.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
from torch import nn

from ..config import PoolConfig
from ..ops import layout
from ..ops.conv import ConvOp
from ..ops.convpool import ConvPoolOp, pool2_fusable
from ..ops.packed import (PackedConvOp, PackedSpec, packed_global_avgpool,
                          packed_maxpool2)
from ..ops.pool import pool
from ..utils.logger import check
from .fusionnet import PackedFusionNet, _conv_config, _mkconv
from .graphed import GraphedForward

LAYERS = ("stem", "block1", "down", "block2", "head")


@dataclasses.dataclass
class ResFusionNetConfig:
    batch: int = 8
    hw: int = 64          # input resolution (even; the stem halves it)
    in_ch: int = 32
    width: int = 128
    num_classes: int = 128
    seed: int = 1


class ResFusionNet(nn.Module):
    """INT8 CNN: strided stem -> residual fused block (sum post-op) ->
    fused conv+ReLU+maxpool downsample -> fused block -> global average
    pool -> f32 head.

    The forward takes any batch size; ``cfg.batch`` is the batch that
    ``input_shape`` and ``example_input`` use."""

    def __init__(self, cfg: ResFusionNetConfig = ResFusionNetConfig(),
                 device=None, params: Optional[dict] = None):
        super().__init__()
        self.cfg = cfg
        if params is None:
            params = self.random_params(cfg)
        self.params = params
        n, hw = cfg.batch, cfg.hw
        hw1 = hw // 2
        self._in_hw = dict(stem=hw, block1=hw1, down=hw1, block2=hw1 // 2,
                           head=1)
        self._stride = dict(stem=2, block1=1, down=1, block2=1, head=1)
        for name in ("stem", "block1", "block2", "head"):
            p = params[name]
            self.add_module(name, ConvOp(
                self._conv_cfg(name), p["wei"], p.get("bia"),
                p.get("wei1"), p.get("bia1"), device=device))
        dn = self._conv_cfg("down")
        pc = PoolConfig.make("max", (dn.oh, dn.ow), (2, 2), (2, 2), (0, 0))
        check(pool2_fusable(dn, pc), "ResFusionNet downsample must fuse")
        self.down = ConvPoolOp(dn, pc, params["down"]["wei"],
                               params["down"].get("bia"), device=device)
        self._in_shape = (n, hw, hw, cfg.in_ch)
        self._packed = None

    def _conv_cfg(self, name: str):
        return _conv_config(self.cfg.batch, self._in_hw[name],
                            self.params[name], self._stride[name])

    @staticmethod
    def random_params(cfg: ResFusionNetConfig) -> dict:
        """The JAX package's weight draw for `cfg.seed`."""
        rng = np.random.default_rng(cfg.seed)
        c, w = cfg.in_ch, cfg.width
        # raw u8 input has std ~74
        stem = _mkconv(rng, 3, c, w, "u8", in_std=74.0)
        # the residual joins block1's 1x1 epilogue as a u8 sum operand
        block1 = dict(_mkconv(rng, 3, w, w, "u8", oc1x1=w), sum_dt="u8",
                      sum_scale=1.0)
        return dict(stem=stem, block1=block1,
                    down=_mkconv(rng, 3, w, w, "u8"),
                    block2=_mkconv(rng, 3, w, w, "u8", oc1x1=w),
                    head=_mkconv(rng, 1, w, cfg.num_classes, "f32",
                                 relu=False))

    @classmethod
    def from_numpy_params(cls, cfg: ResFusionNetConfig, params: dict,
                          device=None) -> "ResFusionNet":
        """Build from parameters given as numpy arrays, one dict per layer
        name in ``LAYERS``, with the keys of ``FusionNet.from_numpy_params``
        and, for block1, ``sum_dt`` and ``sum_scale``."""
        return cls(cfg, device=device, params=params)

    @property
    def device(self) -> torch.device:
        return self.stem.device

    @property
    def input_shape(self):
        return self._in_shape

    def example_input(self, rng: Optional[np.random.Generator] = None):
        rng = rng or np.random.default_rng(7)
        return rng.integers(0, 256, self._in_shape, dtype=np.uint8)

    def forward(self, x_u8) -> torch.Tensor:
        x = self.stem(torch.as_tensor(x_u8, device=self.device))  # 3x3/s2
        y = self.block1(x, sum_src=x)               # residual via sum post-op
        y = self.down(y)                            # one-kernel conv+pool
        y = self.block2(y)
        h, w = y.shape[1], y.shape[2]
        y = pool(y, "avg_exc", (h, w), (h, w), (0, 0))  # global avg
        logits = self.head(y)                       # (n,1,1,classes) f32
        return logits.reshape(logits.shape[0], -1)

    def jit(self) -> GraphedForward:
        """The dense forward as a compiled callable (the JAX package's
        ``ResFusionNet.jit``): on the card one CUDA graph per input shape,
        replayed per call (``models/graphed.py``); on the CPU the forward
        itself."""
        return GraphedForward(self.forward)

    # ------------------------------------------ packed-domain forward path

    def build_packed(self) -> nn.ModuleDict:
        """The layout-persistent pipeline, built once on the model's device,
        with the JAX package's specs (``resfusion.py:105-136``): the stem
        runs on the s2d grid (its output is already packed for block1), the
        residual joins block1's epilogue as a packed sum operand read at
        the stem output's halo 4 while block1 emits halo 3, the downsample
        is a packed conv and the packed 2x2 max pool, and the only relayout
        is the boundary pack of the input image. iwp = 48 because the max
        pool needs iwp % 16 == 0; the halos erode 4 -> 3 -> 2 (even, for
        the pool) -> pool -> 1 -> 0."""
        if self._packed is not None:
            return self._packed

        def op(name, sin, col_off_out, halo_out, sum_spec=None):
            p = self.params[name]
            return PackedConvOp(
                self._conv_cfg(name), p["wei"], p.get("bia"), p.get("wei1"),
                p.get("bia1"), sin=sin, col_off_out=col_off_out,
                halo_out=halo_out, sum_spec=sum_spec, device=self.device)

        cfg2 = layout.s2d_cfg(self._conv_cfg("stem"))
        sin0 = PackedSpec(h=cfg2.ih, w=cfg2.iw, c=cfg2.ic,
                          cp=layout.conv_icp(cfg2.ic), halo=4, col_off=2,
                          iwp=48)
        stem = op("stem", sin0, 2, 4)
        block1 = op("block1", stem.sout, 2, 3, sum_spec=stem.sout)
        down = op("down", block1.sout, 2, 2)
        so = down.sout
        block2 = op("block2", PackedSpec(h=so.h // 2, w=so.w // 2, c=so.c,
                                         cp=so.cp, halo=1, col_off=1,
                                         iwp=so.iwp // 2), 1, 0)
        self._packed = nn.ModuleDict(dict(stem=stem, block1=block1,
                                          down=down, block2=block2))
        return self._packed

    def packed_call(self, x_u8) -> torch.Tensor:
        """Forward pass bitwise equal to ``forward``: the packed sum joins in
        the same exact integer domain as the dense one, and max pooling
        commutes with the -128 centering."""
        P = self.build_packed()
        x = P["stem"].pack_input(torch.as_tensor(x_u8, device=self.device))
        x = P["stem"](x)                            # packed s2d conv
        y = P["block1"](x, sum_arr=x)               # residual sum post-op
        y = P["down"](y)
        y, _ = packed_maxpool2(y, P["down"].sout)
        y = P["block2"](y)
        y = packed_global_avgpool(y, P["block2"].sout)
        logits = self.head(y)
        return logits.reshape(logits.shape[0], -1)

    def jit_packed(self) -> GraphedForward:
        """The packed forward as a compiled callable (the JAX package's
        ``ResFusionNet.jit_packed``), as ``jit()``."""
        self.build_packed()
        return GraphedForward(self.packed_call)

    def packed_module(self) -> PackedFusionNet:
        """The packed forward as a module to serve eagerly (``jit_packed()``
        is its compiled callable)."""
        self.build_packed()
        return PackedFusionNet(self)
