"""VGGFusion: the VGG-style INT8 CNN whose blocks are conv pairs.

The PyTorch counterpart of ``deepfusion_tpu/models/vggfusion.py``: three
blocks of conv3x3+ReLU -> conv3x3+ReLU -> maxpool2x2/s2, then a global
average pool and an f32 head, with the same numpy-RNG weight draw
(``_mkconv``, per block conv1 then conv2, then the head), so
``VGGFusion(cfg)`` in both packages holds the same weights for the same
seed. Weights made by the JAX package cross over with
``VGGFusion.from_numpy_params``.

Three forwards, bitwise equal:

* ``forward`` (dense): per block a ``ConvOp`` and the single-kernel
  conv+ReLU+maxpool ``ConvPoolOp``;
* ``packed_call``: each block one ``PackedConvPairOp(pool2=True)``, one
  launch of the pair kernel per block, the layer boundary kept on chip;
* ``hybrid_call``: the first (largest) block on the pair kernel, one
  ``unpack_image`` at the seam, the dense tail.

``packed_module()`` wraps ``packed_call`` for ``serving.BatchServer``;
``jit()`` and ``jit_packed()`` are the dense and packed forwards as compiled
callables (``models/graphed.py``); the hybrid forward has none, as in the
JAX package.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
from torch import nn

from ..config import PoolConfig
from ..ops.conv import ConvOp
from ..ops.convpool import ConvPoolOp, pool2_fusable
from ..ops.mega import PackedConvPairOp
from ..ops.packed import PackedSpec, packed_global_avgpool, unpack_image
from ..ops.pool import pool
from ..utils.logger import check
from ..utils.mathutil import round_up
from .fusionnet import PackedFusionNet, _conv_config, _mkconv
from .graphed import GraphedForward

N_BLOCKS = 3
LAYERS = tuple(f"block{b}_conv{i}" for b in range(1, N_BLOCKS + 1)
               for i in (1, 2)) + ("head",)


@dataclasses.dataclass
class VGGFusionConfig:
    batch: int = 8
    hw: int = 56            # divisible by 2^3 (three pooled blocks)
    in_ch: int = 32
    width: int = 64         # block widths: w, 2w, 4w
    num_classes: int = 128
    seed: int = 0


class VGGFusion(nn.Module):
    """INT8 VGG-style CNN: 3 x [conv3x3+relu, conv3x3+relu, maxpool2]
    -> global avg pool -> f32 head.

    The forward takes any batch size; ``cfg.batch`` is the batch that
    ``input_shape`` and ``example_input`` use."""

    def __init__(self, cfg: VGGFusionConfig = VGGFusionConfig(),
                 device=None, params: Optional[dict] = None):
        super().__init__()
        check(cfg.hw % (2 ** N_BLOCKS) == 0,
              "hw must be divisible by 2^n_blocks")
        self.cfg = cfg
        if params is None:
            params = self.random_params(cfg)
        self.params = params
        self._in_hw = {f"block{b}_conv{i}": cfg.hw >> (b - 1)
                       for b in range(1, N_BLOCKS + 1) for i in (1, 2)}
        self._in_hw["head"] = 1
        self.conv1 = nn.ModuleList()
        self.convpool2 = nn.ModuleList()
        for b in range(1, N_BLOCKS + 1):
            p1, p2 = params[f"block{b}_conv1"], params[f"block{b}_conv2"]
            self.conv1.append(ConvOp(self._conv_cfg(f"block{b}_conv1"),
                                     p1["wei"], p1.get("bia"),
                                     device=device))
            c2 = self._conv_cfg(f"block{b}_conv2")
            pc = PoolConfig.make("max", (c2.oh, c2.ow), (2, 2), (2, 2),
                                 (0, 0))
            check(pool2_fusable(c2, pc), "block not pool-fusable")
            self.convpool2.append(ConvPoolOp(c2, pc, p2["wei"], p2.get("bia"),
                                             device=device))
        p = params["head"]
        self.head = ConvOp(self._conv_cfg("head"), p["wei"], p.get("bia"),
                           device=device)
        self._in_shape = (cfg.batch, cfg.hw, cfg.hw, cfg.in_ch)
        self._packed = None

    def _conv_cfg(self, name: str):
        return _conv_config(self.cfg.batch, self._in_hw[name],
                            self.params[name])

    @staticmethod
    def random_params(cfg: VGGFusionConfig) -> dict:
        """The JAX package's weight draw for `cfg.seed`."""
        rng = np.random.default_rng(cfg.seed)
        chans = [cfg.in_ch] + [cfg.width << b for b in range(N_BLOCKS)]
        params = {}
        for b in range(N_BLOCKS):
            # raw u8 input has std ~74
            params[f"block{b + 1}_conv1"] = _mkconv(
                rng, 3, chans[b], chans[b + 1], "u8",
                in_std=74.0 if b == 0 else 30.0)
            params[f"block{b + 1}_conv2"] = _mkconv(
                rng, 3, chans[b + 1], chans[b + 1], "u8")
        params["head"] = _mkconv(rng, 1, chans[-1], cfg.num_classes, "f32",
                                 relu=False)
        return params

    @classmethod
    def from_numpy_params(cls, cfg: VGGFusionConfig, params: dict,
                          device=None) -> "VGGFusion":
        """Build from parameters given as numpy arrays, one dict per layer
        name in ``LAYERS``, with the keys of ``FusionNet.from_numpy_params``
        (no fused 1x1)."""
        return cls(cfg, device=device, params=params)

    @property
    def device(self) -> torch.device:
        return self.head.device

    @property
    def input_shape(self):
        return self._in_shape

    def example_input(self, rng: Optional[np.random.Generator] = None):
        rng = rng or np.random.default_rng(42)
        return rng.integers(0, 256, self._in_shape, dtype=np.uint8)

    def _tail(self, y, blocks) -> torch.Tensor:
        """Dense blocks `blocks`, the global average pool and the head."""
        for b in blocks:
            y = self.convpool2[b](self.conv1[b](y))
        h, w = y.shape[1], y.shape[2]
        y = pool(y, "avg_exc", (h, w), (h, w), (0, 0))   # global avg
        logits = self.head(y)                            # (n,1,1,classes)
        return logits.reshape(logits.shape[0], -1)

    def forward(self, x_u8) -> torch.Tensor:
        return self._tail(torch.as_tensor(x_u8, device=self.device),
                          range(N_BLOCKS))

    def jit(self) -> GraphedForward:
        """The dense forward as a compiled callable (the JAX package's
        ``VGGFusion.jit``): on the card one CUDA graph per input shape,
        replayed per call (``models/graphed.py``); on the CPU the forward
        itself."""
        return GraphedForward(self.forward)

    # ------------------------------------------------ packed (pair) forward

    def build_packed(self) -> nn.ModuleList:
        """One ``PackedConvPairOp(pool2=True)`` per block, built once on the
        model's device, with the JAX package's specs
        (``vggfusion.py:109-131``): the input iwp is a multiple of
        8 * 2^n_blocks so every pooled row stays aligned, each block writes
        halo 2 / col_off 2 (even, for the pool) and pools them to 1 / 1,
        and the last block writes halo 0."""
        if self._packed is not None:
            return self._packed
        cfg = self.cfg
        iwp0 = round_up(cfg.hw + 4, 8 * 2 ** N_BLOCKS)
        spec = PackedSpec.make(cfg.hw, cfg.hw, cfg.in_ch, halo=2, col_off=2,
                               iwp=iwp0)
        pairs = nn.ModuleList()
        for b in range(1, N_BLOCKS + 1):
            p1, p2 = self.params[f"block{b}_conv1"], \
                self.params[f"block{b}_conv2"]
            pair = PackedConvPairOp(
                self._conv_cfg(f"block{b}_conv1"), (p1["wei"], p1.get("bia")),
                self._conv_cfg(f"block{b}_conv2"), (p2["wei"], p2.get("bia")),
                sin=spec, halo_out=0 if b == N_BLOCKS else 2, col_off_out=2,
                pool2=True, device=self.device)
            pairs.append(pair)
            spec = pair.sout_pooled
        self._packed = pairs
        return pairs

    def packed_call(self, x_u8) -> torch.Tensor:
        """Forward pass bitwise equal to ``forward``: three pair launches,
        the packed global average pool and the head."""
        pairs = self.build_packed()
        x = pairs[0].pack_input(torch.as_tensor(x_u8, device=self.device))
        for pair in pairs:
            x = pair(x)
        y = packed_global_avgpool(x, pairs[-1].sout_pooled)
        logits = self.head(y)
        return logits.reshape(logits.shape[0], -1)

    def hybrid_call(self, x_u8) -> torch.Tensor:
        """The first block on the pair kernel, one unpack at the seam, the
        dense tail; bitwise equal to both other forwards."""
        pairs = self.build_packed()
        x = pairs[0].pack_input(torch.as_tensor(x_u8, device=self.device))
        y = unpack_image(pairs[0](x), pairs[0].sout_pooled)
        return self._tail(y.contiguous(), range(1, N_BLOCKS))

    def jit_packed(self) -> GraphedForward:
        """The packed forward as a compiled callable (the JAX package's
        ``VGGFusion.jit_packed``), as ``jit()``."""
        self.build_packed()
        return GraphedForward(self.packed_call)

    def packed_module(self) -> PackedFusionNet:
        """The packed forward as a module to serve eagerly (``jit_packed()``
        is its compiled callable)."""
        self.build_packed()
        return PackedFusionNet(self)
