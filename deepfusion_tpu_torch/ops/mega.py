"""Two-layer packed conv pair: two chained packed convs in one kernel launch.

The PyTorch counterpart of ``deepfusion_tpu/ops/mega.py``. One launch of
``pair_conv_kernel`` (``csrc/pair_conv.cu``) computes

    packed in --conv_a(3x3[+1x1])--> on-chip intermediate
              --conv_b(3x3[+1x1])--> packed out (optionally 2x2/s2 max pooled)

so the layer boundary never reaches device memory: two convs share one read
of the packed input and one write of the (pooled) packed output. With
``pool2`` this is VGGFusion's block, conv3x3+ReLU -> conv3x3+ReLU ->
maxpool2, as one kernel. The kernel runs wgmma on TMA tiles: layer a as
the packed conv kernel does, on a window of the intermediate kept in
shared memory, and layer b with its A operand read from that window; its
B operands and their tensor maps are the two ``PackedConvOp``s' own
(``packed._weight_maps``).

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
``grid_order``, ``reuse_mid``, ``vmem_budget``, ``row_tile``.

For ``parallel.shard.sp_packed`` the pair takes the intermediate's image
rows at run time (``mid_bounds``: a shard widens them into its neighbours'
rows, which layer a computes from the exchanged input halo), computes a
range of output rows from a row slice of its input (``rows``/``row0_off``,
in rows where the JAX package counts row tiles and passes ``offs``), and
``reheight`` makes the pair of one shard's slab.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from .. import _build
from ..config import ConvConfig, replace_geometry
from ..types import dtype, round_mode
from ..utils.device import as_tensor
from ..utils.logger import check, check_eq
from ..utils.persist import dump_configs, load_configs
from . import layout
from .packed import (PackedConvOp, PackedSpec, _embed, _operand_shapes,
                     _place, _pooled_spec, _rows_of, _stage_plain,
                     _weight_maps, check_slice, pack_image, row_plan,
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
                 pool2: bool = False, device=None):
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
        self._layers = (_layer_ints(cfg_a), _layer_ints(cfg_b))
        self._geo = pair_geo(self)
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

    def reheight(self, h: int) -> "PackedConvPairOp":
        """The pair on an h-row horizontal slab of the image, with the same
        columns, lanes and operand buffers: the per-shard local op of
        ``parallel.shard.sp_packed``. Needs oh == ih and ow == iw on both
        layers so shard boundaries align."""
        for cfg, name in ((self.cfg_a, "a"), (self.cfg_b, "b")):
            check(cfg.oh == cfg.ih and cfg.ow == cfg.iw,
                  f"reheight requires oh == ih on layer {name}")
        op = PackedConvPairOp.__new__(PackedConvPairOp)
        nn.Module.__init__(op)
        op._check(replace_geometry(self.cfg_a, ih=h, oh=h),
                  replace_geometry(self.cfg_b, ih=h, oh=h),
                  dataclasses.replace(self.sin, h=h),
                  dataclasses.replace(self.smid, h=h),
                  dataclasses.replace(self.sout, h=h), self.pool2)
        op.op_a = self.op_a.reheight(h)
        op.op_b = self.op_b.reheight(h)
        return op

    def forward(self, packed_arr, *, rows=None, row0_off: int = 0,
                mid_bounds=None) -> torch.Tensor:
        """The packed output (``sout_final``) of the packed input.

        mid_bounds=(lo, hi): the intermediate's image rows, default
        (0, h): layer a computes rows [lo, hi) (reading the input's halo
        rows where they reach past the image) and layer b reads u8 0
        outside them. rows/row0_off: as ``PackedConvOp.forward``, a range
        of the returned array's rows from a row slice of the input."""
        arr = as_tensor(packed_arr, self.device)
        check_eq(arr.dtype, torch.int8, "packed pair input dtype")
        n = arr.shape[0]
        if rows is None and row0_off == 0:
            check_eq(tuple(arr.shape), self.sin.array_shape(n),
                     "input does not match the op's packed spec")
        y0, y1 = self._mid_rows(rows, mid_bounds)
        check_slice(arr, self.sin, n,
                    self.sin.halo - row0_off + y0 - self.cfg_a.ph,
                    y1 - y0 + self.cfg_a.kh - 1 if y1 > y0 else 0)
        check_eq(arr.device, self.device, "packed pair input device")
        fn = pair_conv_plain if arr.device.type == "cpu" else pair_conv_cuda
        return fn(self, arr, rows=rows, row0_off=row0_off,
                  mid_bounds=mid_bounds)

    def _row_plan(self, rows):
        """As ``PackedConvOp._row_plan``, for layer b's output."""
        return row_plan(self.sout_final, self.sout.halo, self.cfg_b.oh,
                        self.pool2, rows)

    def _mid_rows(self, rows, mid_bounds):
        """The intermediate rows [y0, y1) layer a computes for the output
        range: those layer b's image rows read, inside the bounds."""
        _, _, oy0, oy1 = self._row_plan(rows)
        lo, hi = self._bounds(mid_bounds)
        cb = self.cfg_b
        return (max(oy0 - cb.ph, lo),
                min(oy1 - cb.ph + cb.kh - 1, hi) if oy1 > oy0 else lo)

    def _bounds(self, mid_bounds):
        lo, hi = (0, self.cfg_a.oh) if mid_bounds is None else mid_bounds
        check(lo < hi, f"empty intermediate bounds {mid_bounds}")
        return int(lo), int(hi)

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
    def load(cls, path: str, device=None) -> "PackedConvPairOp":
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


def pair_conv_plain(op: PackedConvPairOp, arr, *, rows=None,
                    row0_off: int = 0, mid_bounds=None) -> torch.Tensor:
    """The plain PyTorch version of ``pair_conv_kernel``: layer a's plain
    stage over the intermediate rows [lo, hi) of ``mid_bounds`` (default
    the image's), layer b's over the whole image with u8 0 around those
    rows, then the fused pool of ``op_b``. With the defaults,
    ``op_b(op_a(x))``. rows/row0_off as in ``PackedConvOp.forward``,
    computed without the wrapper's range plan: the input slice goes to row
    row0_off of a whole input array (u8 0 around it), the whole output is
    computed, and rows [r0, r1) of it are returned."""
    ca, cb, sin = op.cfg_a, op.cfg_b, op.sin
    n = arr.shape[0]
    lo, hi = (0, ca.oh) if mid_bounds is None else mid_bounds
    u = (arr.view(torch.uint8) ^ 0x80).reshape(n, -1, sin.iwp, sin.cp)
    # whole rows, with `top` more above the array where layer a's taps of
    # rows [lo, hi) reach past its first row
    top = max(0, ca.ph - lo - sin.halo)
    u = _embed(u, top + row0_off,
               top + max(sin.rows, row0_off + u.shape[1],
                         sin.halo - ca.ph + hi + ca.kh - 1))
    mid = _stage_plain(op.op_a, u.to(torch.float64),
                       top + sin.halo - ca.ph + lo, sin.col_off - ca.pw,
                       hi - lo, ca.ow)
    # layer b's window: intermediate rows [-ph_b, oh_b - ph_b + kh_b - 1)
    win = torch.zeros((n, cb.oh + cb.kh - 1, ca.ow + 2 * cb.pw,
                       layout.conv_icp(cb.ic)), dtype=torch.float64,
                      device=arr.device)
    m0, m1 = max(lo, -cb.ph), min(hi, cb.oh - cb.ph + cb.kh - 1)
    win[:, m0 + cb.ph:m1 + cb.ph, cb.pw:cb.pw + ca.ow, :mid.shape[-1]] = \
        mid[:, m0 - lo:m1 - lo].to(torch.float64)
    val = _stage_plain(op.op_b, win, 0, 0, cb.oh, cb.ow)
    row = op.sout.halo
    if op.pool2:
        val = val.reshape(n, cb.oh // 2, 2, cb.ow // 2, 2,
                          cb.out_oc).amax(dim=(2, 4))
        row //= 2
    so = op.sout_final
    return _rows_of(_place(val, so, so.rows, row, cb.out_oc, False), so,
                    rows)


def _layer_ints(cfg: ConvConfig) -> tuple:
    """One layer's ints as ``csrc/pair_conv.cu:make_layer`` reads them (the
    fifth, K bytes per tap, is the lanes of the layer's one input)."""
    fuse = cfg.fuse_conv1x1
    return (cfg.kh, cfg.kw, cfg.ph, cfg.pw, layout.conv_icp(cfg.ic), cfg.oc,
            layout.packed_cp(cfg.oc), cfg.oc1x1,
            layout.packed_cp(cfg.oc1x1) if fuse else 0,
            int(cfg.conv0_round == round_mode.down),
            int(cfg.conv1_round == round_mode.down),
            int(cfg.conv0_with_bias), int(cfg.conv1_with_bias), int(fuse))


def pair_geo(op: PackedConvPairOp) -> tuple:
    """The pair's ints as ``torch.ops.deepfusion_torch.pair_conv`` takes
    them (``csrc/ops_packed.cpp``, ``PairGeo``), computed once per op: the
    specs' row stride and columns, the intermediate's and the output's
    image sizes, the fused pool."""
    a, b = op.cfg_a, op.cfg_b
    return (op.sin.iwp, op.sin.col_off, a.oh, a.ow, b.oh, b.ow,
            op.sout.col_off, int(op.pool2))


def _pair_rows(op: PackedConvPairOp, plan, row0_off: int = 0,
               mid_bounds=None) -> tuple:
    """What depends on the call (``PairRows``), from the range's
    ``_row_plan``: the input slice's halo, the output range's rows and halo
    (both re-based), its first image row and row count, and the
    intermediate's bounds."""
    u0, u1, oy0, oy1 = plan
    lo, hi = op._bounds(mid_bounds)
    return (op.sin.halo - row0_off, u1 - u0, op.sout.halo - u0, oy0,
            oy1 - oy0, lo, hi)


def pair_conv_cuda(op: PackedConvPairOp, arr, *, rows=None,
                   row0_off: int = 0, mid_bounds=None) -> torch.Tensor:
    """Launch ``pair_conv_kernel`` on the current stream through
    ``torch.ops.deepfusion_torch.pair_conv``, which checks, aligns,
    allocates and launches in C++."""
    so = op.sout_final
    plan = op._row_plan(rows)
    u0, u1, oy0, oy1 = plan
    if oy1 == oy0:   # a range of pad rows only: nothing to compute
        return torch.full((arr.shape[0], (u1 - u0) // (2 if op.pool2 else 1)
                           * so.iwp, so.cp), -128, dtype=torch.int8,
                          device=arr.device)
    a, b = op.op_a, op.op_b
    fa, fb = a.cfg.fuse_conv1x1, b.cfg.fuse_conv1x1
    out = _build.op("pair_conv")(
        arr, a.corr0, a.bias0, a.scale0, a.bias1 if fa else None,
        a.scale1 if fa else None, _weight_maps(a), b.bias0, b.scale0,
        b.bias1 if fb else None, b.scale1 if fb else None, _weight_maps(b),
        op._layers[0], op._layers[1], op._geo,
        _pair_rows(op, plan, row0_off, mid_bounds))
    modes = (("rows",) if rows is not None or row0_off else ()) + (
        ("bounds",) if mid_bounds is not None else ())
    _build.count_launch("pair_conv", *modes)
    return out


def pair_conv_plan(op: PackedConvPairOp, n: int) -> dict:
    """The plan the kernel launches at batch n (the whole output), as
    ``torch.ops.deepfusion_torch.pair_plan`` (the launcher's own planning)
    reports it; needs the kernel library: the output tile (tr x 8 pixels;
    split: 8 rows, each consumer warpgroup on half of layer b's lanes), the
    tiles, the blocks (at most one per SM of the H100's 132, each walking
    its share of the tiles), ring stages, shared bytes, the widest K chunk,
    the window of intermediate pixels layer a computes per tile and its m64
    blocks; then layer a's M rows per intermediate pixel
    (``layer_a_ratio``: the halo of every tile and the last block's rows
    past the window), the share of layer b's M rows that are no output
    pixel (tiles past the image's edge), and the MACs executed relative to
    the pair's own."""
    iwp, col_in, mh, mw, oh, ow, col_out, pool2 = op._geo
    halo_in, rows_out, halo_out, oy0, noy, lo, hi = _pair_rows(
        op, op._row_plan(None))
    # the whole geometry in pair_conv.cu:make_args's order
    geo = (n, iwp, op.sin.rows, halo_in, col_in, mh, mw, oh, ow, rows_out,
           halo_out, col_out, pool2, oy0, noy, lo, hi)
    keys = ("tile_rows", "tile_cols", "split", "tiles", "blocks", "stages",
            "smem_bytes", "k_chunk", "window_pixels", "layer_a_blocks")
    plan = dict(zip(keys, _build.op("pair_plan")(*op._layers, geo)))
    a, b = op.cfg_a, op.cfg_b

    def macs(cfg, pixels):
        m = cfg.kh * cfg.kw * cfg.ic * cfg.oc
        return pixels * (m + (cfg.oc * cfg.oc1x1 if cfg.fuse_conv1x1 else 0))

    rows_a = plan["tiles"] * plan["layer_a_blocks"] * 64
    rows_b = plan["tiles"] * plan["tile_rows"] * plan["tile_cols"]
    pair = macs(a, n * a.oh * a.ow) + macs(b, n * b.oh * b.ow)
    plan.update(tile=(plan["tile_rows"], plan["tile_cols"]),
                layer_a_ratio=rows_a / (n * a.oh * a.ow),
                layer_b_junk_share=1 - n * b.oh * b.ow / rows_b,
                executed_mac_ratio=(macs(a, rows_a) + macs(b, rows_b)) / pair)
    return plan
