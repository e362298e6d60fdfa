"""FusionNet: the flagship INT8 CNN, dense and packed-domain forwards.

The PyTorch counterpart of ``deepfusion_tpu/models/fusionnet.py``: the same
layers, the same numpy-RNG weight draw (``_mkconv``), so ``FusionNet(cfg)``
in both packages holds the same weights for the same seed, and the same
dense forward: stem -> fused block -> branch concat -> residual ->
downsample -> fused block -> global average pool -> f32 head. Weights made
by the JAX package cross over with ``FusionNet.from_numpy_params``.

``packed_call`` is the same forward with every activation in the packed
domain (``ops/packed.py``), bitwise equal to the dense one;
``packed_module()`` wraps it for ``serving.BatchServer``; ``jit()`` and
``jit_packed()`` are the two forwards as compiled callables (one CUDA graph
per input shape, ``models/graphed.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
from torch import nn

from ..config import ConvConfig
from ..ops import layout
from ..ops.concat import concat
from ..ops.conv import ConvOp
from ..ops.packed import (PackedConvOp, PackedSpec, pack_image,
                          packed_global_avgpool)
from ..ops.pool import eltwise_sum_relu, pool
from ..utils.mathutil import conv_output_size
from .graphed import GraphedForward

LAYERS = ("stem", "block1", "branch", "res", "block2", "head")


def _mkconv(rng, k, ic, oc, dst_dt, *, oc1x1=None, relu=True, in_std=30.0):
    """Random int8 weights with analytically calibrated scales (scale ~
    48 / std(acc) keeps u8 activations alive through deep stacks); the same
    draws, in the same order, as the JAX package's ``_mkconv``. Returns one
    layer's parameters as a dict of numpy arrays and flags."""
    wei = rng.integers(-16, 17, (oc, ic, k, k)).astype(np.int8)
    wei_std = 16.0 / np.sqrt(3.0)
    acc_std = np.sqrt(k * k * ic) * in_std * wei_std
    bia = rng.integers(-int(acc_std * 0.05) - 1, int(acc_std * 0.05) + 2,
                       (oc,)).astype(np.int32)
    sc0 = (rng.uniform(0.8, 1.2, oc).astype(np.float32)
           * np.float32(48.0 / acc_std))
    p = dict(wei=wei, bia=bia, conv0_scales=sc0, conv0_relu=relu,
             dst_dt=dst_dt)
    if oc1x1 is None:
        return p
    wei1 = rng.integers(-16, 17, (oc1x1, oc, 1, 1)).astype(np.int8)
    acc1_std = np.sqrt(oc) * 30.0 * wei_std
    bia1 = rng.integers(-int(acc1_std * 0.05) - 1, int(acc1_std * 0.05) + 2,
                        (oc1x1,)).astype(np.int32)
    sc1 = (rng.uniform(0.8, 1.2, oc1x1).astype(np.float32)
           * np.float32(48.0 / acc1_std))
    p.update(wei1=wei1, bia1=bia1, conv0_relu=True, conv1_scales=sc1,
             conv1_relu=relu)
    return p


def _conv_config(n: int, hw: int, p: dict, stride: int = 1) -> ConvConfig:
    """ConvConfig of one layer from its parameters: padding k // 2 (same
    padding at stride 1), the given stride, the source's ``src_dt`` (u8
    unless named), and the sum post-op when the parameters name a
    ``sum_dt`` (with ``sum_scale``, default 1)."""
    oc, ic, k, _ = np.shape(p["wei"])
    pad = k // 2
    o = conv_output_size(hw, k, stride, pad)
    fuse = p.get("wei1") is not None
    out_oc = np.shape(p["wei1"])[0] if fuse else oc
    bia, bia1 = p.get("bia"), p.get("bia1")
    return ConvConfig.make(
        (n, hw, hw, ic), (oc, ic, k, k),
        None if bia is None else np.asarray(bia).dtype, (stride, stride),
        (pad, pad), (n, o, o, out_oc), p["dst_dt"],
        conv0_relu=bool(p["conv0_relu"]), conv0_scales=p["conv0_scales"],
        wei1x1_shape=tuple(np.shape(p["wei1"])) if fuse else None,
        bia1x1_dt=None if bia1 is None else np.asarray(bia1).dtype,
        conv1_relu=bool(p.get("conv1_relu", False)),
        conv1_scales=p.get("conv1_scales", (1.0,)),
        src_dt=p.get("src_dt", "u8"), sum_dt=p.get("sum_dt"),
        sum_scale=p.get("sum_scale", 1.0))


@dataclasses.dataclass
class FusionNetConfig:
    batch: int = 8
    hw: int = 56
    in_ch: int = 32
    width: int = 128
    num_classes: int = 128
    seed: int = 0


class FusionNet(nn.Module):
    """INT8 CNN: stem -> fused block -> branch concat -> residual ->
    downsample -> fused block -> global pool -> f32 head.

    The forward takes any batch size; ``cfg.batch`` is the batch that
    ``input_shape`` and ``example_input`` use."""

    def __init__(self, cfg: FusionNetConfig = FusionNetConfig(),
                 device=None, params: Optional[dict] = None):
        super().__init__()
        self.cfg = cfg
        if params is None:
            params = self.random_params(cfg)
        n, hw = cfg.batch, cfg.hw
        in_hw = dict(stem=hw, block1=hw, branch=hw, res=hw, block2=hw // 2,
                     head=1)
        self.params = params
        for name in LAYERS:
            p = params[name]
            op = ConvOp(_conv_config(n, in_hw[name], p), p["wei"],
                        p.get("bia"), p.get("wei1"), p.get("bia1"),
                        device=device)
            self.add_module(name, op)
        self._stem_in_shape = (n, hw, hw, cfg.in_ch)
        self._in_hw = in_hw
        self._packed = None

    @staticmethod
    def random_params(cfg: FusionNetConfig) -> dict:
        """The JAX package's weight draw for `cfg.seed`."""
        rng = np.random.default_rng(cfg.seed)
        c, w = cfg.in_ch, cfg.width
        return dict(
            # raw u8 input has std ~74
            stem=_mkconv(rng, 3, c, w, "u8", in_std=74.0),
            block1=_mkconv(rng, 3, w, w, "u8", oc1x1=w),
            branch=_mkconv(rng, 1, w, w, "u8"),
            res=_mkconv(rng, 1, 2 * w, 2 * w, "u8"),
            block2=_mkconv(rng, 3, 2 * w, 2 * w, "u8", oc1x1=w),
            head=_mkconv(rng, 1, w, cfg.num_classes, "f32", relu=False))

    @classmethod
    def from_numpy_params(cls, cfg: FusionNetConfig, params: dict,
                          device=None) -> "FusionNet":
        """Build from parameters given as numpy arrays, one dict per layer
        name in ``LAYERS``: ``wei``, ``bia``, ``conv0_scales``,
        ``conv0_relu``, ``dst_dt`` and, for the fused blocks, ``wei1``,
        ``bia1``, ``conv1_scales``, ``conv1_relu``."""
        return cls(cfg, device=device, params=params)

    @property
    def device(self) -> torch.device:
        return self.stem.device

    @property
    def input_shape(self):
        return self._stem_in_shape

    def example_input(self, rng: Optional[np.random.Generator] = None):
        rng = rng or np.random.default_rng(42)
        return rng.integers(0, 256, self._stem_in_shape, dtype=np.uint8)

    def forward(self, x_u8) -> torch.Tensor:
        x = self.stem(torch.as_tensor(x_u8, device=self.device))
        a = self.block1(x)                          # fused 3x3+1x1
        b = self.branch(x)                          # 1x1 branch
        y = concat([a, b], post_relu=True)          # (n, hw, hw, 2w)
        r = self.res(y)                             # 1x1 on merged
        y = eltwise_sum_relu(y, r)                  # residual + relu
        y = pool(y, "max", (2, 2), (2, 2), (0, 0))  # downsample
        y = self.block2(y)                          # fused 3x3+1x1 -> w
        h, w = y.shape[1], y.shape[2]
        y = pool(y, "avg_exc", (h, w), (h, w), (0, 0))  # global avg
        logits = self.head(y)                       # (n,1,1,classes) f32
        return logits.reshape(logits.shape[0], -1)

    def jit(self) -> GraphedForward:
        """The dense forward as a compiled callable (the JAX package's
        ``FusionNet.jit``): on the card one CUDA graph per input shape,
        replayed per call (``models/graphed.py``); on the CPU the forward
        itself."""
        return GraphedForward(self.forward)

    # ------------------------------------------ packed-domain forward path

    def build_packed(self) -> nn.ModuleDict:
        """The layout-persistent pipeline (ops/packed.py), built once on the
        model's device: every activation stays in the packed domain (conv,
        concat, residual sum, the 2x2 maxpool and the global avg pool all
        read packed arrays), so the only relayout in the model is the
        boundary pack of the input image."""
        if self._packed is not None:
            return self._packed
        hw, c = self.cfg.hw, self.cfg.in_ch

        def op(name, sin, col_off_out, halo_out, merge_pool=False):
            p = self.params[name]
            return PackedConvOp(
                _conv_config(self.cfg.batch, self._in_hw[name], p),
                p["wei"], p.get("bia"), p.get("wei1"), p.get("bia1"),
                sin=sin, col_off_out=col_off_out, halo_out=halo_out,
                merge_pool=merge_pool, device=self.device)

        # Halo budget (erosion scheme): each 3x3 conv consumes one halo row
        # (halo_out = halo_in - ph), so every tap of an image pixel reads
        # inside its input. The 2x2 maxpool needs its input halo even; the
        # chain 4 -> 3 -> 2 (even) -> pool -> 1 -> 0 satisfies every
        # consumer exactly.
        sin0 = PackedSpec.make(hw, hw, c, cp=layout.conv_icp(c),
                               halo=4, col_off=2)
        stem = op("stem", sin0, 2, 3)
        block1 = op("block1", stem.sout, 2, 2)
        branch = op("branch", stem.sout, 2, 2)
        # concat-free branch merge: the 1x1 residual conv reads both
        # branches as K segments, and its epilogue adds them to its own
        # output and pools (merge_pool), so neither the 2w-channel concat
        # nor the full-resolution residual exists in memory; the JAX
        # package writes the residual and joins it in a second kernel
        res = op("res", (block1.sout, branch.sout), 2, 2, merge_pool=True)
        block2 = op("block2", res.sout_final, 1, 0)
        self._packed = nn.ModuleDict(dict(stem=stem, block1=block1,
                                          branch=branch, res=res,
                                          block2=block2))
        return self._packed

    def packed_call(self, x_u8) -> torch.Tensor:
        """Forward pass bitwise equal to ``forward`` (u8 ReLU is the
        identity through the concat; max pooling and the saturating
        residual sum commute exactly with the -128 centering, see
        ops/packed.py)."""
        P = self.build_packed()
        x = pack_image(torch.as_tensor(x_u8, device=self.device),
                       P["stem"].sin)
        x = P["stem"](x)
        a = P["block1"](x)
        b = P["branch"](x)
        y = P["res"]((a, b))    # relu(a|b + res(a|b)), 2x2 max-pooled
        y = P["block2"](y)
        # global avg pool straight off the packed array: the -128 fill
        # makes non-image slots contribute 0 to the u8 sum
        y = packed_global_avgpool(y, P["block2"].sout)
        logits = self.head(y)
        return logits.reshape(logits.shape[0], -1)

    def jit_packed(self) -> GraphedForward:
        """The packed forward as a compiled callable (the JAX package's
        ``FusionNet.jit_packed``), as ``jit()``."""
        self.build_packed()
        return GraphedForward(self.packed_call)

    def packed_module(self) -> "PackedFusionNet":
        """The packed forward as a module to serve eagerly (``jit_packed()``
        is its compiled callable)."""
        self.build_packed()
        return PackedFusionNet(self)


class PackedFusionNet(nn.Module):
    """A model's ``packed_call`` (FusionNet's, ResFusionNet's or
    VGGFusion's) as a module that carries ``device`` and ``input_shape``,
    so ``BatchServer`` stages each batch on the model's device (a bound
    method has no ``device``: the batch would stay on the CPU)."""

    def __init__(self, net: nn.Module):
        super().__init__()
        self.net = net

    @property
    def device(self) -> torch.device:
        return self.net.device

    @property
    def input_shape(self):
        return self.net.input_shape

    def forward(self, x_u8) -> torch.Tensor:
        return self.net.packed_call(x_u8)
