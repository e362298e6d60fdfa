"""Two-layer packed conv pair: two chained packed convs in one kernel launch.

The PyTorch counterpart of ``deepfusion_tpu/ops/mega.py``. One launch of
``pair_conv_kernel`` (``csrc/pair_conv.cu``) computes

    packed in --conv_a(3x3[+1x1])--> on-chip intermediate
              --conv_b(3x3[+1x1])--> packed out (optionally 2x2/s2 max pooled)

so the layer boundary never reaches device memory: two convs share one read
of the packed input and one write of the (pooled) packed output. With
``pool2`` this is VGGFusion's block, conv3x3+ReLU -> conv3x3+ReLU ->
maxpool2, as one kernel.

Semantics: the output equals ``op_b(op_a(x))`` for the two ``PackedConvOp``
s with the pair's intermediate spec ``smid`` (then the fused pool), which is
what ``pair_conv_plain`` computes on the CPU. The intermediate is an image,
not an array: layer b reads it with u8 zero outside the image, so
``smid.halo`` only names where the JAX package places it. The op holds the
two layers as ``PackedConvOp`` submodules (``op_a``: sin -> smid, ``op_b``:
smid -> sout), so the operands are packed once, in the layout both kernels
read.

Of the JAX package's legality checks (``validate_packed_pair``) the port
keeps the semantic ones and drops the TPU tiling ones: the byte-shift range
|d| < 4 of the column taps, the row tile and the boundary rolls
(``_pair_row_tile_cands``). The port accepts every geometry the JAX package
accepts. Not ported, as TPU schedule knobs: ``split_kh``, ``msplit``,
``grid_order``, ``reuse_mid``, ``vmem_budget``, ``row_tile``. Left for
``parallel/``: ``reheight``, ``mid_bounds`` and the tile range.
"""
from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch
from torch import nn

from .. import _build
from ..config import ConvConfig
from ..types import dtype, round_mode
from ..utils.logger import check, check_eq
from ..utils.persist import dump_configs, load_configs
from . import layout
from .packed import (PackedConvOp, PackedSpec, _operand_shapes,
                     _pooled_spec, pack_image, packed_conv_plain,
                     validate_packed_maxpool2)


def _out_c(cfg: ConvConfig):
    """(channels, lanes) of a layer's packed output."""
    c = cfg.oc1x1 if cfg.fuse_conv1x1 else cfg.oc
    return c, layout.packed_cp(c)


def validate_packed_pair(cfg_a: ConvConfig, cfg_b: ConvConfig,
                         sin: PackedSpec, smid: PackedSpec,
                         sout: PackedSpec):
    """Legality of running cfg_a then cfg_b in one kernel: the JAX
    package's semantic checks, with its messages."""
    for cfg, name in ((cfg_a, "cfg_a"), (cfg_b, "cfg_b")):
        check(cfg.sh == 1 and cfg.sw == 1,
              f"megakernel requires stride 1 ({name})")
        check(cfg.dst_dt == dtype.u8,
              f"megakernel requires u8 destinations ({name})")
        check(not cfg.with_sum,
              f"megakernel does not take sum post-ops ({name})")
    # chain compatibility: a's output image is b's input image
    out_c_a, ocp_a = _out_c(cfg_a)
    check((cfg_a.oh, cfg_a.ow) == (cfg_b.ih, cfg_b.iw),
          "layer-a output image must be layer-b input image")
    check(out_c_a == cfg_b.ic and ocp_a == layout.conv_icp(cfg_b.ic),
          "layer-a output channels must match layer-b input channels")
    check((sin.h, sin.w, sin.c, sin.cp)
          == (cfg_a.ih, cfg_a.iw, cfg_a.ic, layout.conv_icp(cfg_a.ic)),
          "input spec does not match cfg_a")
    check((smid.h, smid.w, smid.c, smid.cp)
          == (cfg_a.oh, cfg_a.ow, out_c_a, ocp_a),
          "intermediate spec does not match cfg_a output")
    check((sout.h, sout.w, sout.c, sout.cp) == (cfg_b.oh, cfg_b.ow)
          + _out_c(cfg_b), "output spec does not match cfg_b output")
    check(sin.iwp == smid.iwp == sout.iwp,
          "megakernel needs one flat row stride across all three specs")
    for cfg, si, name in ((cfg_a, sin, "a"), (cfg_b, smid, "b")):
        check(si.col_off >= cfg.pw,
              f"layer-{name} input col_off too small for kernel width")
        check(si.iwp - si.col_off - si.w >= cfg.kw - 1 - cfg.pw,
              f"layer-{name} input right margin too small")
    check(sin.halo >= cfg_a.ph, "input halo too small for layer a")


class PackedConvPairOp(nn.Module):
    """Two chained packed convs in one kernel launch (module docstring).

    Usage::

        pair = PackedConvPairOp(cfg_a, (wa, ba, wa1, ba1),
                                cfg_b, (wb, bb, wb1, bb1), device=dev)
        x = pair.pack_input(src_u8)
        y = pair(x)          # == op_b(op_a(x)), one kernel launch

    ``weights_a``/``weights_b`` are ``(wei, bia[, wei1x1, bia1x1])``. The
    defaults of ``sin``, ``halo_out``, ``col_off_out`` and ``halo_mid`` are
    the JAX package's. With ``pool2`` the op returns an array of
    ``sout_pooled``.
    """

    def __init__(self, cfg_a: ConvConfig, weights_a, cfg_b: ConvConfig,
                 weights_b, sin: PackedSpec = None, halo_out: int = None,
                 col_off_out: int = None, halo_mid: int = None,
                 pool2: bool = False, device="cpu"):
        super().__init__()
        if sin is None:
            sin = PackedSpec.make(cfg_a.ih, cfg_a.iw, cfg_a.ic,
                                  cp=layout.conv_icp(cfg_a.ic),
                                  halo=max(cfg_a.ph, 1),
                                  col_off=max(cfg_a.pw, 1))
        if halo_out is None:
            halo_out = sin.halo        # self-chain-friendly default
        if col_off_out is None:
            col_off_out = sin.col_off
        if halo_mid is None:
            halo_mid = max(cfg_b.ph, 1)
        out_c_a, ocp_a = _out_c(cfg_a)
        smid = PackedSpec(h=cfg_a.oh, w=cfg_a.ow, c=out_c_a, cp=ocp_a,
                          halo=halo_mid, col_off=sin.col_off, iwp=sin.iwp)
        out_c_b, ocp_b = _out_c(cfg_b)
        sout = PackedSpec(h=cfg_b.oh, w=cfg_b.ow, c=out_c_b, cp=ocp_b,
                          halo=halo_out, col_off=col_off_out, iwp=sin.iwp)
        kmid = self._check(cfg_a, cfg_b, sin, smid, sout, pool2)
        wa = (tuple(weights_a) + (None,) * 4)[:4]
        wb = (tuple(weights_b) + (None,) * 4)[:4]
        self.op_a = PackedConvOp(cfg_a, *wa, sin=sin, col_off_out=kmid.col_off,
                                 halo_out=kmid.halo, device=device)
        self.op_b = PackedConvOp(cfg_b, *wb, sin=kmid,
                                 col_off_out=sout.col_off,
                                 halo_out=sout.halo, pool2=pool2,
                                 device=device)

    def _check(self, cfg_a, cfg_b, sin, smid, sout, pool2) -> PackedSpec:
        """The constructor's checks and specs, shared with ``load``; returns
        the intermediate spec the submodules use: ``smid`` with a halo deep
        enough for layer b's taps (the kernel keeps no halo, the image is
        what counts)."""
        validate_packed_pair(cfg_a, cfg_b, sin, smid, sout)
        if pool2:
            validate_packed_maxpool2(sout)
        self.cfg_a, self.cfg_b = cfg_a, cfg_b
        self.sin, self.smid, self.sout = sin, smid, sout
        self.pool2 = bool(pool2)
        return dataclasses.replace(smid, halo=max(smid.halo, cfg_b.ph))

    @property
    def device(self) -> torch.device:
        return self.op_a.device

    @property
    def sout_pooled(self) -> PackedSpec:
        """Output spec of the fused pool2 epilogue (valid when pool2)."""
        return _pooled_spec(self.sout)

    @property
    def sout_final(self) -> PackedSpec:
        """The spec of what the op returns."""
        return self.sout_pooled if self.pool2 else self.sout

    def pack_input(self, src_u8) -> torch.Tensor:
        """Model-boundary pack: dense NHWC u8 (tensor on any device, or
        numpy) -> this op's packed input on the same device."""
        return pack_image(src_u8, self.sin)

    def forward(self, packed_arr) -> torch.Tensor:
        arr = torch.as_tensor(packed_arr)
        check_eq(arr.dtype, torch.int8, "packed pair input dtype")
        check_eq(tuple(arr.shape), self.sin.array_shape(arr.shape[0]),
                 "input does not match the op's packed spec")
        check_eq(arr.device, self.device, "packed pair input device")
        if arr.device.type == "cpu":
            return pair_conv_plain(self, arr)
        return pair_conv_cuda(self, arr)

    def save(self, path: str):
        """Save both layers' packed operands, the configs, the specs and
        pool2 to .npz."""
        arrs = {f"{name}_{k}": getattr(op, k).cpu().numpy()
                for name, op in (("a", self.op_a), ("b", self.op_b))
                for k in _operand_shapes(op.cfg)}
        np.savez(path, __cfg__=dump_configs(
            cfg_a=self.cfg_a, cfg_b=self.cfg_b, sin=self.sin,
            smid=self.smid, sout=self.sout),
            __pool2__=np.bool_(self.pool2), **arrs)

    @classmethod
    def load(cls, path: str, device="cpu") -> "PackedConvPairOp":
        """Rebuild a saved op, re-running every check of the constructor
        (the JAX package's ``load`` skips them: ROADMAP C2)."""
        with np.load(path, allow_pickle=False) as data:
            cfgs = load_configs(data["__cfg__"], cfg_a=ConvConfig,
                                cfg_b=ConvConfig, sin=PackedSpec,
                                smid=PackedSpec, sout=PackedSpec)
            pool2 = bool(data["__pool2__"])
            ops = {name: {k: data[f"{name}_{k}"]
                          for k in _operand_shapes(cfgs[f"cfg_{name}"])}
                   for name in ("a", "b")}
        op = cls.__new__(cls)
        nn.Module.__init__(op)
        sin, sout = cfgs["sin"], cfgs["sout"]
        kmid = op._check(cfgs["cfg_a"], cfgs["cfg_b"], sin, cfgs["smid"],
                         sout, pool2)
        op.op_a = PackedConvOp.__new__(PackedConvOp)
        nn.Module.__init__(op.op_a)
        op.op_a._set_state(cfgs["cfg_a"], (sin,), kmid, ops["a"], device)
        op.op_b = PackedConvOp.__new__(PackedConvOp)
        nn.Module.__init__(op.op_b)
        op.op_b._set_state(cfgs["cfg_b"], (kmid,), sout, ops["b"], device,
                           pool2=pool2)
        return op


def pair_conv_plain(op: PackedConvPairOp, arr) -> torch.Tensor:
    """The plain PyTorch version of ``pair_conv_kernel``: the two packed
    convs' plain versions through the intermediate spec, then the fused
    pool of ``op_b``."""
    mid = packed_conv_plain(op.op_a, (arr,))
    return packed_conv_plain(op.op_b, (mid,))


def _stage_ints(pop: PackedConvOp):
    """One layer's ints as ``csrc/pair_conv.cu:make_stage`` reads them."""
    cfg = pop.cfg
    fuse = cfg.fuse_conv1x1
    v = [cfg.kh, cfg.kw, cfg.ph, cfg.pw, layout.conv_icp(cfg.ic), cfg.oc,
         layout.packed_cp(cfg.oc), cfg.oc1x1,
         layout.packed_cp(cfg.oc1x1) if fuse else 0,
         int(cfg.conv0_round == round_mode.down),
         int(cfg.conv1_round == round_mode.down),
         int(cfg.conv0_with_bias), int(cfg.conv1_with_bias), int(fuse)]
    return (ctypes.c_int * len(v))(*v)


def _stage_ptrs(pop: PackedConvOp):
    keys = ("w0", "bias0", "scale0") + (
        ("w1", "bias1", "scale1") if pop.cfg.fuse_conv1x1 else ())
    ptrs = [getattr(pop, k).data_ptr() for k in keys]
    return (ctypes.c_void_p * 6)(*(ptrs + [None] * (6 - len(ptrs))))


def _geo_ints(op: PackedConvPairOp, n: int):
    sin, sout = op.sin, op.sout
    v = [n, sin.iwp, sin.rows, sin.halo, sin.col_off, op.cfg_a.oh,
         op.cfg_a.ow, op.cfg_b.oh, op.cfg_b.ow, sout.rows, sout.halo,
         sout.col_off, int(op.pool2)]
    return (ctypes.c_int * len(v))(*v)


def pair_conv_cuda(op: PackedConvPairOp, arr) -> torch.Tensor:
    """Launch ``pair_conv_kernel`` on the current stream."""
    arr = _build.aligned(arr)
    n = arr.shape[0]
    out = torch.empty(op.sout_final.array_shape(n), dtype=torch.int8,
                      device=arr.device)
    with torch.cuda.device(out.device):
        rc = _build.kernels().df_pair_conv(
            arr.data_ptr(), _stage_ptrs(op.op_a), _stage_ptrs(op.op_b),
            out.data_ptr(), _stage_ints(op.op_a), _stage_ints(op.op_b),
            _geo_ints(op, n), _build.stream_of(out))
    _build.check(rc, "pair_conv_kernel")
    _build.count_launch("pair_conv")
    return out


def pair_conv_plan(op: PackedConvPairOp, n: int) -> dict:
    """The tiling the kernel launches at batch n, as ``df_pair_plan`` (the
    kernel's own tile choice and windows) reports it; needs the kernel
    library and a card: the output tile, the number of blocks, the shared
    memory of a block, and the MACs executed relative to the pair's own
    (layer a recomputes each tile's halo of intermediate pixels)."""
    res = (ctypes.c_int * 5)()
    rc = _build.kernels().df_pair_plan(_stage_ints(op.op_a),
                                       _stage_ints(op.op_b),
                                       _geo_ints(op, n), res)
    _build.check(rc, "pair_conv plan")
    tr, tc, blocks, smem, mid = list(res)
    a, b = op.cfg_a, op.cfg_b

    def macs(cfg, pixels):
        m = cfg.kh * cfg.kw * cfg.ic * cfg.oc
        return pixels * (m + (cfg.oc * cfg.oc1x1 if cfg.fuse_conv1x1 else 0))

    pair = macs(a, a.oh * a.ow) + macs(b, b.oh * b.ow)
    done = macs(a, mid) + macs(b, b.oh * b.ow)
    return dict(tile=(tr, tc), blocks=blocks, smem_bytes=smem,
                layer_a_ratio=mid / (a.oh * a.ow),
                executed_mac_ratio=done / pair)
