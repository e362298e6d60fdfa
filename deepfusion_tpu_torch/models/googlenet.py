"""GoogLeNet (Inception-v1) on the dense path: nine Inception modules.

Szegedy et al., "Going Deeper with Convolutions" (arXiv:1409.4842, Table 1;
Caffe's ``bvlc_googlenet``): a 7x7/s2 stem, a 3x3/s2 max pool, a 1x1
reduce and a 3x3 to 192 channels, a 3x3/s2 max pool, modules 3a-3b at
28x28, a 3x3/s2 max pool, 4a-4e at 14x14, a 3x3/s2 max pool, 5a-5b at 7x7,
a 7x7 global average pool and the classifier. A module feeds one input to
four branches (a 1x1; a 1x1 reduce then a 3x3; a 1x1 reduce then a 5x5; a
3x3/s1/p1 max pool then a 1x1 pool projection) and joins their outputs
along the channels. The 3x3/s2 pools have no padding and take ceil mode's
output size: 112 -> 56 -> 28 -> 14 -> 7.

On the port's ops, one ``ConvOp`` per conv, each u8 with ReLU:

* ``stem``: 7x7/s2/p3 over 3 channels (run as a 7x1 conv over the input's
  seven column taps folded into 32 channels, ``ops/conv.py:
  unfold_cols``), then ``pool(..., "max", (3, 3), (2, 2), (0, 0))`` in
  ceil mode;
* ``conv2_reduce`` (1x1, 64) and ``conv2`` (3x3/p1, 192), then the same
  pool;
* per module ``m``: ``{m}_1x1``, ``{m}_3x3_reduce``, ``{m}_3x3``,
  ``{m}_5x5_reduce``, ``{m}_5x5`` (5x5/p2) and, after the branch pool
  ``pool(..., "max", (3, 3), (1, 1), (1, 1))``, ``{m}_pool_proj``; the
  four branch outputs joined by ``ops/concat.concat`` (K2) with no ReLU:
  the values are u8;
* the global ``avg_exc`` pool and the f32 ``head``.

Departures from the published model, as in ``portbench/reference/
googlenet.py``: no local response normalization (LRN is not an integer op;
the batch-norm era's implementations, torchvision's ``googlenet`` among
them, drop it); batch norm folded into each conv's bias and scale; no
auxiliary classifiers (training only); dropout the identity; no softmax
after the logits; branch 3 the paper's 5x5 (torchvision's ``googlenet``
runs a 3x3 there, a known discrepancy kept for its weights' sake).

Each layer of an eager forward is a ``model.layer`` span (attrs ``name``
and ``kind``: stem, maxpool, reduce, conv, b1x1, b3x3_reduce, b3x3,
b5x5_reduce, b5x5, branch_pool, pool_proj, concat, avgpool, head; a
concat also ``inputs`` and ``lanes``) while a ``torch.profiler`` records
(``utils/profiler.py``); a graph replay runs none of them. ``jit()`` is
the forward as a compiled callable (``models/graphed.py``); there is no
packed path.

``random_params`` draws the models' ``_mkconv`` calibration from a numpy
generator, each layer for its input's rms; ``from_numpy_params`` takes any
weights by layer name.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch
from torch import nn

from ..ops.concat import concat
from ..ops.conv import ConvOp
from ..ops.pool import pool
from ..utils.mathutil import conv_output_size, pool_output_size
from ..utils.profiler import span
from .fusionnet import _conv_config, _mkconv
from .graphed import GraphedForward

# Table 1's modules: name, #1x1, #3x3 reduce, #3x3, #5x5 reduce, #5x5,
# pool proj
MODULES = (("3a", 64, 96, 128, 16, 32, 32),
           ("3b", 128, 128, 192, 32, 96, 64),
           ("4a", 192, 96, 208, 16, 48, 64),
           ("4b", 160, 112, 224, 24, 64, 64),
           ("4c", 128, 128, 256, 24, 64, 64),
           ("4d", 112, 144, 288, 32, 64, 64),
           ("4e", 256, 160, 320, 32, 128, 128),
           ("5a", 256, 160, 320, 32, 128, 128),
           ("5b", 384, 192, 384, 48, 128, 128))
POOLED_BEFORE = ("4a", "5a")    # a 3x3/s2 max pool runs before these
BRANCH_KINDS = ("b1x1", "b3x3_reduce", "b3x3", "b5x5_reduce", "b5x5",
                "pool_proj")
# The rms the weights are calibrated for (``_mkconv``'s in_std), measured
# layer by layer on the calibrated network at 224x224 (two seeds): u8
# images uniform over 0..255; the stem's pooled output; a conv's u8 output
# after ReLU (and so a module's concat); a 3x3 max pool of a module's
# input that is such an output; the branch pool of a module's input that
# is itself pooled (a max of maxes); the global average of the last
# module.
IMAGE_RMS, STEM_POOL_RMS, CONV_RMS, POOL_RMS, POOL_POOL_RMS, AVG_RMS = \
    147.0, 57.0, 34.0, 41.0, 47.0, 29.0


@dataclasses.dataclass
class GoogLeNetConfig:
    batch: int = 8
    hw: int = 224
    in_ch: int = 3
    num_classes: int = 1000
    seed: int = 0


class Layer(NamedTuple):
    """One conv of the network: its name and kind, kernel, channels,
    stride, input resolution, destination, ReLU and the input rms its
    weights are calibrated for."""
    name: str
    kind: str
    k: int
    ic: int
    oc: int
    stride: int
    in_hw: int
    dst: str
    relu: bool
    in_std: float


def pooled(hw: int) -> int:
    """The output size of a 3x3/s2 max pool with no padding, ceil mode."""
    return pool_output_size(hw, 3, 2, 0)


def layer_plan(cfg: GoogLeNetConfig) -> list:
    """The 58 layers (57 convs and the head) in the order the forward runs
    them and ``random_params`` draws them."""
    def conv(name, kind, k, ic, oc, hw, std=CONV_RMS, stride=1):
        return Layer(name, kind, k, ic, oc, stride, hw, "u8", True, std)
    out = [conv("stem", "stem", 7, cfg.in_ch, 64, cfg.hw, IMAGE_RMS, 2)]
    hw = pooled(conv_output_size(cfg.hw, 7, 2, 3))
    out += [conv("conv2_reduce", "reduce", 1, 64, 64, hw, STEM_POOL_RMS),
            conv("conv2", "conv", 3, 64, 192, hw)]
    hw, cin, pooled_in = pooled(hw), 192, True
    for m, n1, r3, n3, r5, n5, pp in MODULES:
        if m in POOLED_BEFORE:
            hw, pooled_in = pooled(hw), True
        std = POOL_RMS if pooled_in else CONV_RMS
        widths = ((1, cin, n1, std), (1, cin, r3, std), (3, r3, n3, CONV_RMS),
                  (1, cin, r5, std), (5, r5, n5, CONV_RMS),
                  (1, cin, pp, POOL_POOL_RMS if pooled_in else POOL_RMS))
        for kind, (k, ic, oc, s) in zip(BRANCH_KINDS, widths):
            out.append(conv(f"{m}_{kind.removeprefix('b')}", kind, k, ic, oc,
                            hw, s))
        cin, pooled_in = n1 + n3 + n5 + pp, False
    out.append(Layer("head", "head", 1, cin, cfg.num_classes, 1, 1, "f32",
                     False, AVG_RMS))
    return out


class GoogLeNet(nn.Module):
    """INT8 GoogLeNet: stem -> max pool -> 1x1 -> 3x3 -> max pool -> nine
    Inception modules (with two max pools) -> global average pool -> f32
    head.

    The forward takes any batch size; ``cfg.batch`` is the batch that
    ``input_shape`` and ``example_input`` use."""

    def __init__(self, cfg: GoogLeNetConfig = GoogLeNetConfig(), device=None,
                 params: Optional[dict] = None):
        super().__init__()
        self.cfg = cfg
        if params is None:
            params = self.random_params(cfg)
        self.convs = nn.ModuleDict()
        for layer in layer_plan(cfg):
            p = params[layer.name]
            self.convs[layer.name] = ConvOp(
                _conv_config(cfg.batch, layer.in_hw, p, layer.stride),
                p["wei"], p.get("bia"), device=device)
        self._in_shape = (cfg.batch, cfg.hw, cfg.hw, cfg.in_ch)

    @staticmethod
    def random_params(cfg: GoogLeNetConfig) -> dict:
        """``_mkconv``'s draw for `cfg.seed`, layer by layer in
        ``layer_plan``'s order."""
        rng = np.random.default_rng(cfg.seed)
        return {l.name: _mkconv(rng, l.k, l.ic, l.oc, l.dst, relu=l.relu,
                                in_std=l.in_std)
                for l in layer_plan(cfg)}

    @classmethod
    def from_numpy_params(cls, cfg: GoogLeNetConfig, params: dict,
                          device=None) -> "GoogLeNet":
        """Build from parameters given as numpy arrays, one dict per layer
        name of ``layer_plan`` (``wei``, ``bia``, ``conv0_scales``,
        ``conv0_relu``, ``dst_dt``)."""
        return cls(cfg, device=device, params=params)

    @property
    def device(self) -> torch.device:
        return self.convs["head"].device

    @property
    def input_shape(self):
        return self._in_shape

    def example_input(self, rng: Optional[np.random.Generator] = None):
        rng = rng or np.random.default_rng(1409)
        return rng.integers(0, 256, self._in_shape, dtype=np.uint8)

    def _conv(self, name: str, kind: str, x: torch.Tensor) -> torch.Tensor:
        with span("model.layer", name=name, kind=kind):
            return self.convs[name](x)

    @staticmethod
    def _maxpool(name: str, x: torch.Tensor) -> torch.Tensor:
        """A 3x3/s2 max pool, no padding, ceil mode."""
        with span("model.layer", name=name, kind="maxpool"):
            return pool(x, "max", (3, 3), (2, 2), (0, 0))

    def inception(self, m: str, x: torch.Tensor) -> torch.Tensor:
        """Module `m`: its four branches, then their concat."""
        b1 = self._conv(f"{m}_1x1", "b1x1", x)
        b2 = self._conv(f"{m}_3x3", "b3x3",
                        self._conv(f"{m}_3x3_reduce", "b3x3_reduce", x))
        b3 = self._conv(f"{m}_5x5", "b5x5",
                        self._conv(f"{m}_5x5_reduce", "b5x5_reduce", x))
        with span("model.layer", name=f"{m}_pool", kind="branch_pool"):
            p = pool(x, "max", (3, 3), (1, 1), (1, 1))
        b4 = self._conv(f"{m}_pool_proj", "pool_proj", p)
        branches = (b1, b2, b3, b4)
        lanes = sum(b.shape[-1] for b in branches)
        with span("model.layer", name=f"{m}_concat", kind="concat",
                  inputs=len(branches), lanes=lanes):
            return concat(branches)

    def forward(self, x_u8) -> torch.Tensor:
        x = torch.as_tensor(x_u8, device=self.device)
        x = self._maxpool("pool1", self._conv("stem", "stem", x))
        x = self._conv("conv2", "conv",
                       self._conv("conv2_reduce", "reduce", x))
        x = self._maxpool("pool2", x)
        for m, *_ in MODULES:
            if m in POOLED_BEFORE:
                x = self._maxpool(f"pool{int(m[0]) - 1}", x)
            x = self.inception(m, x)
        with span("model.layer", name="avgpool", kind="avgpool"):
            h, w = x.shape[1], x.shape[2]
            x = pool(x, "avg_exc", (h, w), (h, w), (0, 0))
        logits = self._conv("head", "head", x)      # (n, 1, 1, classes)
        return logits.reshape(logits.shape[0], -1)

    def jit(self) -> GraphedForward:
        """The forward as a compiled callable: on the card one CUDA graph
        per input shape, replayed per call (``models/graphed.py``); on the
        CPU the forward itself."""
        return GraphedForward(self.forward)
