"""Packed-domain ops: the layout FusionNet's packed forward keeps between
layers.

The PyTorch counterpart of ``deepfusion_tpu/ops/packed.py``. An image of
logical shape (N, H, W, C) u8 is stored as an int8 array of shape
``(N, (H + 2*halo) * iwp, cp)`` (``PackedSpec``) where

* the stored byte is ``u8 ^ 0x80`` viewed as int8, which is ``u8 - 128``,
* the image occupies rows ``[halo, halo+H)`` and, within each row of ``iwp``
  flat positions, columns ``[col_off, col_off+W)`` and lanes ``[0, C)``,
* every non-image slot holds -128 (u8 zero, the conv's padding value),
* ``iwp`` is a multiple of 8.

A conv writes its output straight into this layout with the halo and column
offset its consumer needs, so activations cross no relayout between layers;
``pack_image``/``unpack_image`` convert at the model boundary only.

On CUDA tensors ``PackedConvOp`` launches ``packed_conv_kernel``
(``csrc/packed_conv.cu``) and the residual sum and 2x2 max pool launch
``packed_sum_pool_kernel`` or, for the pool alone,
``packed_maxpool2_kernel`` (``csrc/packed_sum_pool.cu``). On CPU tensors
they run ``packed_conv_plain`` and ``packed_sum_pool_plain``, which read the
packed arrays themselves (stored ^ 0x80 as u8, pad slots included), so each
is the same function as its kernel even where a pad slot does not hold
-128. Nothing else selects the path. The sum/pool kernel takes any count of
inputs of any lane widths and reads each lane group straight from the
input that holds it, so the join never exists in memory, as in the JAX
kernel's body. The packed conv takes at most ``MAX_INPUTS``
inputs of multiples of ``LANE_UNIT`` lanes; the JAX package takes any
count and width, so before its launch the op joins groups of consecutive
inputs (``kernel_groups``, ``join_groups``: plain lane concatenation, the
glue the JAX package also writes in ``jnp``). Inputs that fit, as on every
path of the three models, launch as they are. The pool alone pads lanes
to a multiple of ``LANE_UNIT``.

The conv takes the packed eltwise-sum operand (``sum_spec``/``sum_arr``):
a packed image of the output's image, columns and lanes whose halo may be
deeper, read at its own halo and joined after the final stage's round, as
``requant_to_u8_centered(..., sum_rounded=)``. A strided conv runs, as in
the JAX package, as a stride-1 conv on the space-to-depth grid: the op's
``cfg`` and ``sin`` describe that grid, ``cfg_orig`` the strided conv, and
``pack_input`` regroups a dense image at the model boundary. The JAX
package's sparse-phase taps (for ic a multiple of 128) compute the same
accumulator with fewer MACs and are not ported: the dense s2d lowering
runs for every strided conv.

``pool2=True`` fuses the 2x2/s2 max pool into the conv's epilogue: the
op returns the pooled image at ``sout_pooled``, the max of the final u8
values (after the sum operand joins, at full resolution), as the JAX
package pools the clamped values before the byte pack.

``merge_pool=True`` fuses a residual merge and the pool into the epilogue
of a stride-1 unfused 1x1 conv whose output lanes are its joined input
lanes and whose output has its inputs' geometry (FusionNet's residual
conv): the op returns, at ``sout_pooled``,
``packed_sum_relu_maxpool2(inputs, conv(inputs))``. The kernel adds each
pixel's input byte, which its A tile already holds, to the clamped u8
value (``validate_merge_pool``). The JAX package has no such fusion: it
runs the conv, then ``packed_sum_relu_maxpool2``.

For the sharded wrappers (``parallel/shard.py``) the conv also returns its
raw 1x1 accumulator (``emit_acc1``), computes a range of output rows from
a row slice of its input (``rows``/``row0_off``, in rows where the JAX
package counts row tiles), and ``reheight`` makes the op of one shard's
slab; ``pack_image_sharded``/``unpack_image_sharded`` convert the sharded
format. The JAX package's ``operands=`` override exists for ``jax.jit``
and has no counterpart. Of the JAX package's
legality checks, the row-tile and boundary-roll ones
(``packed.py:222-237``) describe TPU tiling and are dropped: the CUDA
kernel has no row tile and reads every tap of an image pixel inside the
input.
"""
from __future__ import annotations

import dataclasses
import json

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .. import _build
from ..config import ConvConfig, replace_geometry
from ..types import dtype, round_mode
from ..utils.device import as_tensor, default_device
from ..utils.logger import check, check_eq
from ..utils.persist import dump_configs, load_configs
from . import layout
from .requant import requant_to_u8, round_f32, saturate, sum_term

MAX_INPUTS = 4  # csrc/packed_dst.cuh MAX_SRC: the packed conv's inputs
LANE_UNIT = 16  # the conv and the pool alone move 16 lanes at a time


@dataclasses.dataclass(frozen=True)
class PackedSpec:
    """Static description of a packed-domain image (see module docstring)."""

    h: int        # logical image height
    w: int        # logical image width
    c: int        # logical channels
    cp: int       # stored channels (lane-padded); lanes >= c hold -128
    halo: int     # pad rows above AND below the image
    col_off: int  # first image column within a flat row
    iwp: int      # flat positions per row (multiple of 8)

    def __post_init__(self):
        check(self.iwp % 8 == 0, "packed iwp must be sublane-aligned")
        check(self.col_off + self.w <= self.iwp, "image exceeds packed row")

    @property
    def rows(self) -> int:
        return self.h + 2 * self.halo

    def array_shape(self, n: int):
        return (n, self.rows * self.iwp, self.cp)

    @staticmethod
    def make(h: int, w: int, c: int, *, cp=None, halo: int = 1,
             col_off: int = 1, iwp=None) -> "PackedSpec":
        if cp is None:
            cp = layout.packed_cp(c)
        if iwp is None:
            iwp = -(-(w + 2 * col_off) // 8) * 8
        return PackedSpec(h=h, w=w, c=c, cp=cp, halo=halo,
                          col_off=col_off, iwp=iwp)


def _pooled_spec(s: PackedSpec) -> PackedSpec:
    return PackedSpec(h=s.h // 2, w=s.w // 2, c=s.c, cp=s.cp,
                      halo=s.halo // 2, col_off=s.col_off // 2,
                      iwp=s.iwp // 2)


def pack_image(src_u8, spec: PackedSpec, device=None) -> torch.Tensor:
    """NHWC u8 -> packed int8 array (model-boundary cost only): a tensor on
    its own device, a numpy array on ``device`` (by default the current
    CUDA device, ``utils/device.py``)."""
    src = as_tensor(src_u8, device)
    n, h, w, c = src.shape
    check((h, w) == (spec.h, spec.w) and c == spec.c,
          "pack_image: shape does not match spec")
    check_eq(src.dtype, torch.uint8, "pack_image source dtype")
    out = F.pad((src ^ 0x80).view(torch.int8),
                (0, spec.cp - c, spec.col_off, spec.iwp - spec.col_off - w,
                 spec.halo, spec.halo), value=-128)
    return out.reshape(spec.array_shape(n))


def unpack_image(arr, spec: PackedSpec) -> torch.Tensor:
    """Packed int8 array -> NHWC u8 on the same device."""
    arr = torch.as_tensor(arr)
    n = arr.shape[0]
    img = arr.reshape(n, spec.rows, spec.iwp, spec.cp)[
        :, spec.halo:spec.halo + spec.h,
        spec.col_off:spec.col_off + spec.w, :spec.c]
    return img.view(torch.uint8) ^ 0x80


def validate_packed_conv(cfg: ConvConfig, sins, sout: PackedSpec,
                         ssum: PackedSpec = None):
    """Legality of running cfg from sins to sout (init_conf-style checks).

    sins is a tuple of input specs: a single entry for a plain conv, or
    several whose lane-concatenation forms the conv input (concat-free
    branch merge: the kernel reads each source separately, so the channel
    concat never exists in memory). ssum (exactly when cfg has a sum
    post-op) is the packed sum operand's spec: the output's image, columns
    and lane padding, with a halo at least the output's."""
    sins = sins if isinstance(sins, (tuple, list)) else (sins,)
    sin = sins[0]
    for s in sins[1:]:
        check((s.h, s.w, s.halo, s.col_off, s.iwp)
              == (sin.h, sin.w, sin.halo, sin.col_off, sin.iwp),
              "multi-input packed conv needs uniform image geometry")
    for s in sins[:-1]:
        check(s.cp == s.c, "non-final input has pad lanes (cp > c) which "
                           "would split the conv input's image lanes")
    check(cfg.sh == 1 and cfg.sw == 1,
          "packed path requires stride 1 (strided configs are s2d-lowered "
          "by PackedConvOp before reaching here)")
    check(cfg.dst_dt == dtype.u8, "packed path requires a u8 destination")
    check(cfg.with_sum == (ssum is not None),
          "pass ssum exactly when cfg has a sum post-op")
    if ssum is not None:
        check(cfg.sum_dt == dtype.u8,
              "packed sum post-op requires a u8 sum operand")
        check((ssum.h, ssum.w, ssum.c) == (cfg.oh, cfg.ow, cfg.out_oc),
              "sum operand spec does not match the output image")
        check((ssum.col_off, ssum.iwp) == (sout.col_off, sout.iwp),
              "sum operand must share the output's column geometry")
        check(ssum.cp == layout.packed_cp(cfg.out_oc),
              "sum operand lane padding must match the output's")
        check(ssum.halo >= sout.halo,
              "sum operand halo must cover the output halo")
    check((sin.h, sin.w) == (cfg.ih, cfg.iw),
          "input spec does not match conv geometry")
    check(sum(s.c for s in sins) == cfg.ic,
          "input channels must sum to cfg.ic")
    check(sum(s.cp for s in sins) == layout.conv_icp(cfg.ic),
          "input lane padding must sum to cfg.icp (ic rounded up to 32)")
    check((sout.h, sout.w, sout.c) == (cfg.oh, cfg.ow, cfg.out_oc),
          "output spec does not match conv geometry")
    check(sout.cp == layout.packed_cp(cfg.out_oc),
          "output lane padding must match cfg")
    check(sin.halo >= cfg.ph, "input halo too small for kernel height")
    check(sin.col_off >= cfg.pw, "input col_off too small for kernel width")
    margin = sin.iwp - sin.col_off - sin.w
    check(margin >= cfg.kw - 1 - cfg.pw,
          "input right margin too small for kernel width")
    # a tap past the row's end would read the next row's first slots
    check(margin >= cfg.pw, "input right margin too small for the padding")
    check(sin.iwp == sout.iwp, "packed conv needs iwp_in == iwp_out")


def validate_merge_pool(cfg: ConvConfig, sins, sout: PackedSpec,
                        kernel_cps, ssum=None, cfg_orig=None):
    """Legality of ``merge_pool``: a stride-1 1x1 conv with no padding,
    not fused, no sum operand, whose output has its inputs' image geometry
    and as many channels and lanes as their join, each kernel input a
    multiple of 32 lanes (so the kernel's K offset of a lane is the lane),
    and whose output takes the 2x2 pool."""
    check(cfg_orig is None and cfg.sh == 1 and cfg.sw == 1,
          "merge_pool needs a stride-1 conv")
    check((cfg.kh, cfg.kw, cfg.ph, cfg.pw) == (1, 1, 0, 0),
          "merge_pool needs a 1x1 conv without padding")
    check(not cfg.fuse_conv1x1, "merge_pool needs an unfused conv")
    check(ssum is None, "merge_pool takes no sum operand")
    check(cfg.out_oc == sum(s.c for s in sins)
          and sout.cp == sum(s.cp for s in sins),
          "merge_pool needs the output's channels and lanes to be the "
          "joined inputs'")
    _same_image_geometry(list(sins) + [sout])
    check(all(cp % 32 == 0 for cp in kernel_cps),
          "merge_pool needs each kernel input's lanes a multiple of 32")
    validate_packed_maxpool2(sout)


def _same_image_geometry(specs):
    s0 = specs[0]
    for s in specs[1:]:
        check((s.h, s.w, s.halo, s.col_off, s.iwp)
              == (s0.h, s0.w, s0.halo, s0.col_off, s0.iwp),
              "packed operands must share image geometry")


def packed_concat(arrs, specs, post_relu: bool = True):
    """Channel concat in the packed domain = lane concatenation.

    ReLU on u8 is the identity, so the reference's concat+relu costs nothing
    beyond the lane copy here; ``post_relu`` is kept for API parity. All
    inputs must share image geometry, and every input but the last needs
    ``cp == c`` so the output's image lanes stay contiguous in
    ``[0, sum(c))``.

    Returns ``(packed_array, PackedSpec)``.
    """
    del post_relu  # identity on u8 images (see docstring)
    check(len(arrs) == len(specs) and len(arrs) >= 1,
          "packed_concat needs one array per spec")
    _same_image_geometry(specs)
    for s in specs[:-1]:
        check(s.cp == s.c, "packed_concat: non-final input has pad lanes "
                           "(cp > c) which would split the output image")
    out = torch.cat([torch.as_tensor(a) for a in arrs], dim=-1)
    return out, joined_spec(specs)


def repack(arr, sin: PackedSpec, sout: PackedSpec) -> torch.Tensor:
    """Convert between packed specs of the same logical image (glue; use
    only at geometry seams the fused ops cannot bridge)."""
    check((sin.h, sin.w, sin.c) == (sout.h, sout.w, sout.c),
          "repack cannot change the logical image")
    return pack_image(unpack_image(arr, sin), sout)


def kernel_groups(cps) -> list:
    """The packed conv kernel's inputs as index ranges of consecutive
    inputs of ``cps`` lanes each: at most ``MAX_INPUTS`` groups, each of a
    multiple of ``LANE_UNIT`` lanes but perhaps the last. Inputs the kernel
    takes as they are (at most ``MAX_INPUTS``, each of a multiple of
    ``LANE_UNIT`` lanes) make one group each. A group of
    several inputs is their lane join (``join_groups``): the JAX package
    takes any count and width, and every input but the last has ``cp ==
    c``, so the join keeps the channel order."""
    groups, start, width = [], 0, 0
    for i, cp in enumerate(cps):
        width += cp
        if width % LANE_UNIT == 0:
            groups.append(range(start, i + 1))
            start, width = i + 1, 0
    if start < len(cps):
        groups.append(range(start, len(cps)))
    if len(groups) > MAX_INPUTS:
        groups[MAX_INPUTS - 1:] = [range(groups[MAX_INPUTS - 1].start,
                                         len(cps))]
    return groups


def join_groups(arrs, groups) -> list:
    """The packed conv kernel's inputs: each group's lane join (the input
    itself for a group of one, no copy)."""
    return [arrs[g.start] if len(g) == 1
            else torch.cat([arrs[i] for i in g], dim=-1) for g in groups]


def joined_spec(specs) -> PackedSpec:
    """The spec of the lane join of packed images of ``specs``."""
    s0, sl = specs[0], specs[-1]
    ctot = sum(s.c for s in specs)
    return PackedSpec(h=s0.h, w=s0.w, c=ctot, cp=ctot - sl.c + sl.cp,
                      halo=s0.halo, col_off=s0.col_off, iwp=s0.iwp)


# ------------------------------------------------ K6/K7/K8: sum and pool

def packed_sum_pool_plain(ys, r, pool: bool, rows: int,
                          iwp: int) -> torch.Tensor:
    """The plain PyTorch version of ``packed_sum_pool_kernel``: the lane
    join of ys, then ``clip(y + r + 128)`` when r is given, then the 2x2/s2
    max over (row pair, flat-column pair) when pool."""
    y = ys[0] if len(ys) == 1 else torch.cat(list(ys), dim=-1)
    if r is not None:
        y = (y.to(torch.int32) + r.to(torch.int32) + 128).clamp(
            -128, 127).to(torch.int8)
    if pool:
        n, _, cp = y.shape
        y = y.reshape(n, rows // 2, 2, iwp // 2, 2, cp).amax(dim=(2, 4))
        y = y.reshape(n, (rows // 2) * (iwp // 2), cp)
    return y


def packed_sum_pool_cuda(ys, r, pool: bool, rows: int,
                         iwp: int) -> torch.Tensor:
    """Launch on the current stream ``packed_sum_pool_kernel`` (the sums,
    with or without the pool) or ``packed_maxpool2_kernel`` (the pool
    alone, one input) through ``torch.ops.deepfusion_torch.packed_sum_pool``,
    which checks, aligns, allocates and launches in C++. The sums take the
    inputs as they are, any count and lane widths: the kernel reads each
    lane group from its input. The pool alone moves 16 lanes at a time: an
    input of narrower lanes is padded with -128 and the pad cut from the
    result. The op returns the launches it made, and each is counted."""
    check(r is not None or len(ys) == 1,
          "the packed pool without a sum takes one input")
    check(r is not None or pool, "the packed sum/pool needs r or the pool")
    op = _build.op("packed_sum_pool")
    if r is not None:
        out, launches = op(list(ys), r, rows, iwp, pool)
    else:
        cp = ys[0].shape[-1]
        pad = -cp % LANE_UNIT
        y = F.pad(ys[0], (0, pad), value=-128) if pad else ys[0]
        out, launches = op([y], None, rows, iwp, pool)
        if pad:
            out = out[..., :cp].contiguous()
    for _ in range(launches):
        _build.count_launch("packed_sum_pool")
    return out


def _sum_pool(ys, r, pool: bool, rows: int, iwp: int) -> torch.Tensor:
    for t in list(ys) + ([r] if r is not None else []):
        check_eq(t.dtype, torch.int8, "packed operand dtype")
        check(t.device == ys[0].device, "packed operands must share a device")
    if ys[0].device.type == "cpu":
        return packed_sum_pool_plain(ys, r, pool, rows, iwp)
    return packed_sum_pool_cuda(ys, r, pool, rows, iwp)


def packed_sum_relu(a, b, spec: PackedSpec,
                    with_relu: bool = True) -> torch.Tensor:
    """Eltwise-sum+ReLU in the packed domain (ops/pool.py semantics).

    For u8 operands the dense op is ``sat_u8(relu(xa + xb))``; since
    xa, xb >= 0 the ReLU is the identity and the saturating sum maps to the
    centered domain as ``clip(sa + sb + 128, -128, 127)``. Non-image slots
    hold sa = sb = -128, which lands back on exactly -128, so halo and
    margins stay valid and the result needs no re-packing.
    """
    del with_relu  # identity for u8 operands (see docstring)
    a, b = torch.as_tensor(a), torch.as_tensor(b)
    check(a.shape == b.shape, "packed_sum_relu operand shapes differ")
    check(tuple(a.shape) == spec.array_shape(a.shape[0]),
          "packed_sum_relu: arrays do not match spec")
    return _sum_pool([a], b, False, spec.rows, spec.iwp)


def validate_packed_maxpool2(spec: PackedSpec):
    check(spec.h % 2 == 0 and spec.w % 2 == 0,
          "packed maxpool2 needs even image h and w")
    check(spec.halo % 2 == 0 and spec.col_off % 2 == 0,
          "packed maxpool2 needs even halo and col_off "
          "(pass col_off_out=2 to the producing PackedConvOp)")
    check(spec.iwp % 16 == 0, "packed maxpool2 needs iwp % 16 == 0")


def packed_maxpool2(arr, spec: PackedSpec):
    """2x2/stride-2 max pooling in the packed domain.

    Max pooling commutes with the -128 centering (it is monotone), so the
    pool runs directly on the stored s8 values: pair rows, pair flat
    columns, take the max. Legality: h, w, halo, col_off all even (so 2x2
    windows align with the image region and halo/margins map to
    halo/margins) and iwp % 16 == 0 (so the halved row stays 8-aligned).
    Non-image slots pool to -128, keeping the output a valid packed image
    with ``halo/2``, ``col_off/2``, ``iwp/2``.

    Returns ``(packed_array, PackedSpec)``.
    """
    validate_packed_maxpool2(spec)
    arr = torch.as_tensor(arr)
    check(tuple(arr.shape) == spec.array_shape(arr.shape[0]),
          "packed_maxpool2: array does not match spec")
    return _sum_pool([arr], None, True, spec.rows, spec.iwp), \
        _pooled_spec(spec)


def packed_sum_relu_maxpool2(ys, r, yspecs, rspec: PackedSpec,
                             with_relu: bool = True):
    """Fused (concat . sum+ReLU . 2x2/s2 maxpool) in the packed domain.

    ``ys`` is a list of packed arrays whose lane-concatenation forms the
    left sum operand (the branch-merge concat never exists in memory) and
    ``r`` the right operand. Semantics = ``packed_maxpool2(packed_sum_relu(
    packed_concat(ys), r))``: the saturating clip commutes with the
    monotone max.

    Returns ``(packed_array, PackedSpec)``.
    """
    del with_relu  # identity for u8 operands (see packed_sum_relu)
    yspecs = tuple(yspecs) if isinstance(yspecs, (tuple, list)) \
        else (yspecs,)
    ys = [torch.as_tensor(a) for a in (ys if isinstance(ys, (tuple, list))
                                       else (ys,))]
    r = torch.as_tensor(r)
    check(len(ys) == len(yspecs), "one array per spec")
    _same_image_geometry(list(yspecs) + [rspec])
    for s in yspecs[:-1]:
        check(s.cp == s.c, "non-final input has pad lanes (cp > c)")
    check(sum(s.cp for s in yspecs) == rspec.cp,
          "summed lane widths must match the right operand")
    check(sum(s.c for s in yspecs) == rspec.c,
          "summed channels must match the right operand")
    validate_packed_maxpool2(rspec)
    n = r.shape[0]
    for a, s in zip(ys, yspecs):
        check(tuple(a.shape) == s.array_shape(n),
              "packed_sum_relu_maxpool2: array does not match its spec")
    check(tuple(r.shape) == rspec.array_shape(n),
          "packed_sum_relu_maxpool2: right operand does not match rspec")
    return _sum_pool(ys, r, True, rspec.rows, rspec.iwp), _pooled_spec(rspec)


def packed_global_avgpool(arr, spec: PackedSpec, round=None) -> torch.Tensor:
    """Global average pool (avg-exclude-padding) straight off a packed
    array, as ``deepfusion_tpu/ops/packed.py:packed_global_avgpool``:

        sum_u8(image) = sum_s8(all slots) + 128 * n_slots

    because every non-image slot holds -128 (u8 zero). Then the avg_exc
    epilogue: f32 sums times the f32 reciprocal of h*w (a multiply, as XLA
    compiles the JAX package's constant division, ROADMAP C3), round,
    saturate to u8. Returns (n, 1, 1, c) u8 for the classification head.
    Plain PyTorch on every device, as the JAX package leaves it to XLA."""
    mode = round_mode.nearest if round is None else round_mode.from_any(round)
    arr = torch.as_tensor(arr)
    n = arr.shape[0]
    check(tuple(arr.shape) == spec.array_shape(n),
          "packed_global_avgpool: array does not match spec")
    n_slots = spec.rows * spec.iwp
    sums = arr.sum(dim=1, dtype=torch.int32) + 128 * n_slots
    # a Python float holding the f32 value exactly: an f32 multiply on
    # every device, with no host-to-device copy
    inv = float(np.float32(1.0 / (spec.h * spec.w)))
    out = saturate(round_f32(sums.to(torch.float32) * inv, mode), dtype.u8)
    return out[:, :spec.c].reshape(n, 1, 1, spec.c)


# ------------------------------------------------------- K5: packed conv

_OPERAND_KEYS = ("w0", "bias0", "scale0", "w1", "bias1", "scale1")


def _operand_shapes(cfg: ConvConfig) -> dict:
    """Packed operands: K = conv_icp(ic) lanes per tap, N = packed_cp(oc)
    for the 3x3 (the fused intermediate's lanes) and packed_cp(oc1x1) for
    the 1x1 (ops/layout.py)."""
    n0 = layout.packed_cp(cfg.oc)
    shapes = {"w0": (cfg.kh * cfg.kw, layout.conv_icp(cfg.ic) // 4, n0),
              "bias0": (n0,), "scale0": (n0,)}
    if cfg.fuse_conv1x1:
        n1 = layout.packed_cp(cfg.oc1x1)
        shapes.update(w1=(n0 // 4, n1), bias1=(n1,), scale1=(n1,))
    return shapes


class PackedConvOp(nn.Module):
    """A conv op whose activations stay in the packed domain.

    Usage::

        pop = PackedConvOp(cfg, wei, bia, wei1, bia1, device=dev)
        x   = pack_image(src_u8, pop.sin)
        y   = pop(x)                        # packed, feeds the next conv
        out = unpack_image(y, pop.sout)

    ``sin`` is one input spec, or a tuple of them whose lane join is the
    conv input; ``col_off_out`` and ``halo_out`` place the output for its
    consumer (default: ``max(pw, 1)`` and the input's halo). ``sum_spec``
    adds the sum post-op (pass ``sum_arr`` to each call). ``pool2`` fuses
    the 2x2/s2 max pool: the op then returns an array of ``sout_pooled``,
    and ``sout`` must satisfy ``validate_packed_maxpool2``.
    ``merge_pool`` fuses the residual merge and the pool (module
    docstring, ``validate_merge_pool``): the op returns, at
    ``sout_pooled``, the inputs' lane join plus its output, saturated,
    2x2-pooled; it implies ``pool2``. A strided
    ``cfg`` runs on the s2d grid: ``sin`` then describes the packed s2d
    image, which ``pack_input`` makes from a dense one.
    """

    def __init__(self, cfg: ConvConfig, wei, bia=None, wei1x1=None,
                 bia1x1=None, sin=None, col_off_out: int = None,
                 halo_out: int = None, sum_spec: PackedSpec = None,
                 pool2: bool = False, merge_pool: bool = False,
                 device=None):
        super().__init__()
        check_eq(tuple(np.shape(wei)), (cfg.oc, cfg.ic, cfg.kh, cfg.kw),
                 "conv weight shape (OIHW)")
        cfg_orig = None
        if cfg.sh > 1 or cfg.sw > 1:
            cfg_orig = cfg
            wei = layout.s2d_weights(cfg, np.asarray(wei))
            cfg = layout.s2d_cfg(cfg)
        if sin is None:
            sin = PackedSpec.make(cfg.ih, cfg.iw, cfg.ic,
                                  cp=layout.conv_icp(cfg.ic),
                                  halo=max(cfg.ph, 1),
                                  col_off=max(cfg.pw, 1))
        sins = tuple(sin) if isinstance(sin, (tuple, list)) else (sin,)
        if col_off_out is None:
            col_off_out = max(cfg.pw, 1)
        if halo_out is None:
            halo_out = sins[0].halo     # self-chain-friendly default
        sout = PackedSpec(h=cfg.oh, w=cfg.ow, c=cfg.out_oc,
                          cp=layout.packed_cp(cfg.out_oc), halo=halo_out,
                          col_off=col_off_out, iwp=sins[0].iwp)
        n0 = layout.packed_cp(cfg.oc)
        ops = {"w0": layout.pack_conv_weights(wei, layout.conv_icp(cfg.ic),
                                              n0),
               "bias0": layout.widen_bias(bia, n0),
               "scale0": layout.widen_scales(cfg.conv0_scales, cfg.oc, n0)}
        if cfg.fuse_conv1x1:
            check_eq(tuple(np.shape(wei1x1)), (cfg.oc1x1, cfg.oc, 1, 1),
                     "conv1x1 weight shape (OIHW)")
            n1 = layout.packed_cp(cfg.oc1x1)
            ops.update(w1=layout.pack_1x1_weights(wei1x1, n0, n1),
                       bias1=layout.widen_bias(bia1x1, n1),
                       scale1=layout.widen_scales(cfg.conv1_scales,
                                                  cfg.oc1x1, n1))
        self._set_state(cfg, sins, sout, ops, device, cfg_orig, sum_spec,
                        pool2, merge_pool)

    def _set_state(self, cfg, sins, sout, ops: dict, device, cfg_orig=None,
                   ssum=None, pool2=False, merge_pool=False):
        """The constructor's checks and state, shared with ``load``."""
        validate_packed_conv(cfg, sins, sout, ssum)
        # the kernel's inputs (kernel_groups): the lane joins of groups of
        # sins, whose K lanes the weights and maps below follow
        groups = kernel_groups([s.cp for s in sins])
        kernel_sins = tuple(joined_spec(sins[g.start:g.stop])
                            for g in groups)
        if merge_pool:
            validate_merge_pool(cfg, sins, sout,
                                [s.cp for s in kernel_sins], ssum, cfg_orig)
        elif pool2:
            # the halved result must itself be a valid packed image
            validate_packed_maxpool2(sout)
        self.merge_pool = bool(merge_pool)
        self.pool2 = bool(pool2 or merge_pool)
        self.cfg = cfg
        self.cfg_orig = cfg_orig
        self.sins = sins
        self.sin = sins[0]
        self.kernel_groups = groups
        self.kernel_sins = kernel_sins
        self.sout = sout
        self.ssum = ssum
        device = default_device(device)
        for k, shape in _operand_shapes(cfg).items():
            check_eq(tuple(ops[k].shape), shape, f"packed operand {k}")
            t = ops[k]
            self.register_buffer(k, t if isinstance(t, torch.Tensor) else
                                 torch.as_tensor(np.asarray(t),
                                                 device=device))
        # the kernel's K-major copies of the weights and the correction of
        # the s8 read (ops/layout.py), derived from the words above: they
        # are not operands, so save/load and reheight keep their format;
        # non-persistent buffers, so .to() moves them with the words
        w0k = layout.kmajor_weights(self.w0, cfg.kh, cfg.kw,
                                    [s.cp for s in self.kernel_sins])
        derived = {"w0k": w0k, "corr0": layout.u8_shift_correction(w0k),
                   "w1k": layout.kmajor_weights(
                       self.w1, 1, 1, [layout.packed_cp(cfg.oc)])
                   if cfg.fuse_conv1x1 else None}
        for k, t in derived.items():
            self.register_buffer(k, t, persistent=False)
        self._wmaps = None   # (device pointers, their encoded tensor maps)
        self._cps = tuple(s.cp for s in self.kernel_sins)
        self._geo = packed_geo(self)

    @property
    def device(self) -> torch.device:
        return self.w0.device

    @property
    def sout_pooled(self) -> PackedSpec:
        """Output spec of the fused pool2 epilogue (valid when pool2)."""
        return _pooled_spec(self.sout)

    @property
    def sout_final(self) -> PackedSpec:
        """The spec of what the op returns: ``sout_pooled`` with pool2,
        else ``sout``."""
        return self.sout_pooled if self.pool2 else self.sout

    def pack_input(self, src_u8) -> torch.Tensor:
        """Model-boundary pack: dense NHWC u8 (tensor on any device, or
        numpy) -> this op's packed input on the same device, regrouped onto
        the s2d grid first for a strided op."""
        check(len(self.sins) == 1,
              "pack_input only supports single-input ops")
        src_u8 = as_tensor(src_u8, self.device)
        if self.cfg_orig is not None:
            src_u8 = layout.s2d_image_u8(self.cfg_orig, src_u8)
        return pack_image(src_u8, self.sin)

    def reheight(self, h: int) -> "PackedConvOp":
        """The op on an h-row horizontal slab of the image, with the same
        columns, lanes and operand buffers: the per-shard local op of
        ``parallel.shard.sp_packed``. Needs stride 1 and oh == ih, ow == iw
        so shard boundaries align."""
        check(self.cfg_orig is None,
              "reheight does not support s2d-lowered strided ops")
        cfg = self.cfg
        check(cfg.oh == cfg.ih and cfg.ow == cfg.iw,
              "reheight requires oh == ih (stride-1 SAME geometry)")
        op = PackedConvOp.__new__(PackedConvOp)
        nn.Module.__init__(op)
        op._set_state(
            replace_geometry(cfg, ih=h, oh=h),
            tuple(dataclasses.replace(s, h=h) for s in self.sins),
            dataclasses.replace(self.sout, h=h),
            {k: getattr(self, k) for k in _operand_shapes(cfg)}, self.device,
            ssum=None if self.ssum is None
            else dataclasses.replace(self.ssum, h=h), pool2=self.pool2,
            merge_pool=self.merge_pool)
        return op

    def forward(self, packed_arr, sum_arr=None, *, emit_acc1: bool = False,
                rows=None, row0_off: int = 0) -> torch.Tensor:
        """The packed output (``sout_final``) of the packed input(s).

        emit_acc1: (fused, one input, no sum operand, no pool2) the raw
        s32 1x1 accumulator instead, an int32 array of ``sout``: image
        slots hold the accumulator (0 in lanes >= oc1x1), every other slot
        0. Partial accumulators over slices of the intermediate's channels
        add up to the whole op's (the tensor-parallel local step).
        rows=(r0, r1): only rows [r0, r1) of the returned array (of
        ``sout_final``); row0_off: the inputs are row slices of the full
        input arrays, starting at that row, holding every row the image
        rows of the range read. The sum operand stays whole. Together they
        are ``sp_packed``'s interior/boundary split (the JAX package's
        ``t_range``/``row0_off`` in its row tiles)."""
        arrs = (tuple(packed_arr) if isinstance(packed_arr, (tuple, list))
                else (packed_arr,))
        arrs = tuple(as_tensor(a, self.device) for a in arrs)
        check(len(arrs) == len(self.sins),
              "op expects one array per input spec")
        n = arrs[0].shape[0]
        sliced = rows is not None or row0_off != 0
        _, _, oy0, oy1 = self._row_plan(rows)
        for a, s in zip(arrs, self.sins):
            check_eq(a.dtype, torch.int8, "packed conv input dtype")
            if sliced:
                check_slice(a, s, n, self.sin.halo - row0_off + oy0
                            - self.cfg.ph,
                            oy1 - oy0 + self.cfg.kh - 1 if oy1 > oy0 else 0)
            else:
                check_eq(tuple(a.shape), s.array_shape(n),
                         "packed conv input shape (its spec's array)")
            check_eq(a.device, self.device, "packed conv input device")
        check((sum_arr is not None) == (self.ssum is not None),
              "pass sum_arr exactly when the op has a sum post-op")
        if emit_acc1:
            check(self.cfg.fuse_conv1x1,
                  "emit_acc1 needs the fused config")
            check(len(self.sins) == 1 and self.ssum is None
                  and not self.pool2,
                  "tp_packed_fused: single input, no sum post-op, no pool2")
        if sum_arr is not None:
            sum_arr = as_tensor(sum_arr, self.device)
            check_eq(sum_arr.dtype, torch.int8, "packed sum operand dtype")
            check_eq(tuple(sum_arr.shape), self.ssum.array_shape(n),
                     "sum_arr does not match the sum spec")
            check_eq(sum_arr.device, self.device, "packed sum operand device")
        fn = packed_conv_plain if arrs[0].device.type == "cpu" \
            else packed_conv_cuda
        return fn(self, arrs, sum_arr, emit_acc1=emit_acc1, rows=rows,
                  row0_off=row0_off)

    def _row_plan(self, rows):
        """(u0, u1, oy0, oy1): the unpooled output rows [u0, u1) of the
        range ``rows`` (rows of ``sout_final``) and the image rows
        [oy0, oy1) among them."""
        return row_plan(self.sout_final, self.sout.halo, self.cfg.oh,
                        self.pool2, rows)

    def save(self, path: str):
        """Save the packed operands, the config (and a strided op's original
        config), the specs and the fused epilogue's flags to .npz."""
        specs = {"cfg": self.cfg, "sout": self.sout}
        for i, s in enumerate(self.sins):
            specs[f"sin{i}"] = s
        if self.cfg_orig is not None:
            specs["cfg_orig"] = self.cfg_orig
        if self.ssum is not None:
            specs["ssum"] = self.ssum
        arrs = {k: getattr(self, k).cpu().numpy()
                for k in _operand_shapes(self.cfg)}
        np.savez(path, __cfg__=dump_configs(**specs),
                 __n_sins__=np.int64(len(self.sins)),
                 __pool2__=np.bool_(self.pool2),
                 __merge_pool__=np.bool_(self.merge_pool), **arrs)

    @classmethod
    def load(cls, path: str, device=None) -> "PackedConvOp":
        with np.load(path, allow_pickle=False) as data:
            n_sins = int(data["__n_sins__"])
            present = set(json.loads(str(data["__cfg__"])))
            check({"cfg", "sout"} <= present, "not a saved PackedConvOp")
            classes = {"cfg": ConvConfig, "sout": PackedSpec}
            classes.update({f"sin{i}": PackedSpec for i in range(n_sins)})
            if "cfg_orig" in present:
                classes["cfg_orig"] = ConvConfig
            if "ssum" in present:
                classes["ssum"] = PackedSpec
            cfgs = load_configs(data["__cfg__"], **classes)
            ops = {k: data[k] for k in _operand_shapes(cfgs["cfg"])}
            pool2 = "__pool2__" in data and bool(data["__pool2__"])
            merge_pool = ("__merge_pool__" in data
                          and bool(data["__merge_pool__"]))
        op = cls.__new__(cls)
        nn.Module.__init__(op)
        op._set_state(cfgs["cfg"], tuple(cfgs[f"sin{i}"]
                                         for i in range(n_sins)),
                      cfgs["sout"], ops, device, cfgs.get("cfg_orig"),
                      cfgs.get("ssum"), pool2, merge_pool)
        return op


def row_plan(so: PackedSpec, halo_out: int, oh: int, pool2: bool, rows):
    """(u0, u1, oy0, oy1) of an output row range: ``rows`` (default all)
    counts rows of the returned array ``so``, pooled rows with pool2;
    [u0, u1) are the unpooled output rows and [oy0, oy1) the image rows
    among them."""
    r0, r1 = (0, so.rows) if rows is None else rows
    check(0 <= r0 < r1 <= so.rows,
          f"output row range {rows} outside [0, {so.rows})")
    f = 2 if pool2 else 1
    u0, u1 = f * r0, f * r1
    return (u0, u1, min(max(u0 - halo_out, 0), oh),
            min(max(u1 - halo_out, 0), oh))


def check_slice(arr, spec: PackedSpec, n: int, first: int, count: int):
    """A row slice of a packed array of `spec`: `count` rows from row
    `first` of the slice must lie in it."""
    check(arr.dim() == 3 and arr.shape[0] == n and arr.shape[2] == spec.cp
          and arr.shape[1] % spec.iwp == 0,
          "packed input slice must be (n, rows * iwp, cp) of its spec")
    check(count <= 0 or (first >= 0
                         and first + count <= arr.shape[1] // spec.iwp),
          "input slice does not hold every row the output range reads")


def _stage_plain(op: PackedConvOp, u: torch.Tensor, r0: int, c0: int,
                 nrows: int, ncols: int, sum_rounded=None,
                 emit_acc1: bool = False) -> torch.Tensor:
    """One packed conv stage (the 3x3, its fused 1x1) in plain PyTorch over
    u, (n, R, C, icp) float64 u8 values padding included: output pixel
    (i, x) reads u[:, r0 + i + ki, c0 + x + kj]. Accumulates tap by tap in
    float64 (every partial sum is an integer below 2^53, so the sum is
    exact). Returns the u8 values (n, nrows, ncols, out_oc), the sum joined
    after the final round, or with emit_acc1 the s32 1x1 accumulator over
    all packed_cp(oc1x1) lanes."""
    cfg = op.cfg
    n = u.shape[0]
    n0 = layout.packed_cp(cfg.oc)
    w = layout.unpack_weights(op.w0, n0, layout.conv_icp(cfg.ic), cfg.kh,
                              cfg.kw).to(torch.float64)
    acc = torch.zeros((n, nrows, ncols, n0), dtype=torch.float64,
                      device=u.device)
    for ki in range(cfg.kh):
        for kj in range(cfg.kw):
            patch = u[:, r0 + ki:r0 + ki + nrows, c0 + kj:c0 + kj + ncols]
            acc += patch @ w[:, :, ki, kj].T
    acc = acc.to(torch.int32)[..., :cfg.oc]
    bias0 = op.bias0[:cfg.oc] if cfg.conv0_with_bias else None
    val = requant_to_u8(acc, bias0, op.scale0[:cfg.oc], cfg.conv0_round,
                        None if cfg.fuse_conv1x1 else sum_rounded)
    if not cfg.fuse_conv1x1:
        return val
    n1 = layout.packed_cp(cfg.oc1x1) if emit_acc1 else cfg.oc1x1
    w1 = layout.unpack_weights(op.w1, n1, cfg.oc, 1, 1)
    acc1 = (val.to(torch.float64) @ w1[:, :, 0, 0].to(torch.float64).T
            ).to(torch.int32)
    if emit_acc1:
        return acc1
    bias1 = op.bias1[:cfg.oc1x1] if cfg.conv1_with_bias else None
    return requant_to_u8(acc1, bias1, op.scale1[:cfg.oc1x1],
                         cfg.conv1_round, sum_rounded)


def _place(val: torch.Tensor, so: PackedSpec, nrows: int, row: int,
           lanes: int, emit_acc1: bool) -> torch.Tensor:
    """An output array of nrows rows of `so` (its rows re-based so the
    image starts at row so.halo - r0): -128 (or the s32 zero) everywhere
    but val's pixels, stored ^ 0x80 (or as they are) from row `row` of the
    array at column so.col_off, lanes [0, lanes)."""
    n = val.shape[0]
    out = torch.full((n, nrows, so.iwp, so.cp), 0 if emit_acc1 else -128,
                     dtype=torch.int32 if emit_acc1 else torch.int8,
                     device=val.device)
    out[:, row:row + val.shape[1], so.col_off:so.col_off + val.shape[2],
        :lanes] = val if emit_acc1 else (val ^ 0x80).view(torch.int8)
    return out.reshape(n, nrows * so.iwp, so.cp)


def _embed(u: torch.Tensor, first: int, total: int) -> torch.Tensor:
    """u (n, rows, ...) as rows [first, first + rows) of `total` rows, u8
    0 in the others."""
    if first == 0 and u.shape[1] == total:
        return u
    whole = u.new_zeros((u.shape[0], total) + tuple(u.shape[2:]))
    whole[:, first:first + u.shape[1]] = u
    return whole


def _rows_of(out: torch.Tensor, so: PackedSpec, rows) -> torch.Tensor:
    """Rows [r0, r1) (default all) of a whole output array of `so`."""
    if rows is None:
        return out
    r0, r1 = rows
    return out[:, r0 * so.iwp:r1 * so.iwp]


def packed_conv_plain(op: PackedConvOp, arrs, sum_arr=None, *,
                      emit_acc1: bool = False, rows=None,
                      row0_off: int = 0) -> torch.Tensor:
    """The plain PyTorch version of ``packed_conv_kernel``.

    Reads the packed inputs themselves: the lane join of the sources, each
    stored byte ^ 0x80 as u8, windowed over the flat rows exactly as the
    kernel addresses them (``_stage_plain``). The sum operand is read at
    its image pixels and lanes < c, as stored. Writes image pixels at
    (halo_out + y, col_off_out + x) and -128 everywhere else; with pool2
    the 2x2/s2 max of the u8 values first, at the pooled spec; with
    merge_pool ``packed_sum_pool_plain`` (sum and pool) of the joined
    inputs' image pixels, every lane as stored, and the conv's output
    (-128 in lanes >= oc), at the pooled spec; with
    emit_acc1 the raw 1x1 accumulator and 0 elsewhere. rows/row0_off as in
    ``PackedConvOp.forward``, computed without its range plan: the input
    slices go to row row0_off of whole input arrays (u8 0 around them),
    the whole output is computed, and rows [r0, r1) of it are returned."""
    cfg, sin = op.cfg, op.sin
    n = arrs[0].shape[0]
    u = torch.cat([a.view(torch.uint8) for a in arrs], dim=-1) ^ 0x80
    u = u.reshape(n, -1, sin.iwp, layout.conv_icp(cfg.ic))
    u = _embed(u, row0_off, max(sin.rows, row0_off + u.shape[1]))
    sum_rounded = None
    if sum_arr is not None:
        ss = op.ssum
        sv = (sum_arr.view(torch.uint8) ^ 0x80).reshape(
            n, ss.rows, ss.iwp, ss.cp)[
            :, ss.halo:ss.halo + cfg.oh, ss.col_off:ss.col_off + cfg.ow,
            :cfg.out_oc]
        fin = cfg.conv1_round if cfg.fuse_conv1x1 else cfg.conv0_round
        sum_rounded = round_f32(sum_term(sv, cfg.sum_scale), fin)
    val = _stage_plain(op, u.to(torch.float64), sin.halo - cfg.ph,
                       sin.col_off - cfg.pw, cfg.oh, cfg.ow, sum_rounded,
                       emit_acc1)
    row = op.sout.halo
    lanes = op.sout.cp if emit_acc1 else cfg.out_oc
    if op.merge_pool:
        # the image pixels as packed arrays of their own (no halo, no
        # margins): the conv's output r, -128 in lanes >= oc, and the
        # joined inputs' y, every lane as stored; their sum, pooled
        lanes = op.sout.cp
        r = torch.full((n, cfg.oh * cfg.ow, lanes), -128, dtype=torch.int8,
                       device=val.device)
        r[..., :cfg.out_oc] = (val ^ 0x80).view(torch.int8).reshape(
            n, -1, cfg.out_oc)
        y = (u[:, sin.halo:sin.halo + cfg.oh,
               sin.col_off:sin.col_off + cfg.ow] ^ 0x80).reshape(r.shape)
        val = packed_sum_pool_plain([y.view(torch.int8)], r, True, cfg.oh,
                                    cfg.ow).view(torch.uint8).reshape(
            n, cfg.oh // 2, cfg.ow // 2, lanes) ^ 0x80
        row //= 2
    elif op.pool2:
        val = val.reshape(n, cfg.oh // 2, 2, cfg.ow // 2, 2,
                          cfg.out_oc).amax(dim=(2, 4))
        row //= 2
    so = op.sout_final
    return _rows_of(_place(val, so, so.rows, row, lanes, emit_acc1),
                    so, rows)


def _weight_maps(op: PackedConvOp) -> torch.Tensor:
    """The TMA tensor maps of the op's K-major weights, a CPU uint8 tensor
    (6, 128) encoded once for their device pointers
    (``torch.ops.deepfusion_torch.packed_weight_maps``); a copy of the op on
    other buffers (``dp_shard``) encodes its own."""
    w1k = op.w1k
    key = (op.w0k.data_ptr(), None if w1k is None else w1k.data_ptr())
    if op._wmaps is None or op._wmaps[0] != key:
        op._wmaps = (key, _build.op("packed_weight_maps")(op.w0k, w1k))
    return op._wmaps[1]


def packed_geo(op: PackedConvOp) -> tuple:
    """The op's ints as ``torch.ops.deepfusion_torch.packed_conv`` takes
    them (``csrc/ops_packed.cpp``, ``PackedGeo``), computed once per op:
    the specs' geometry, the conv's, channels and lanes, the epilogue's
    flags, the sum operand's rows and halo, the fused pool and merge."""
    cfg, sin, sout, ss = op.cfg, op.sin, op.sout, op.ssum
    fuse = cfg.fuse_conv1x1
    return (sin.iwp, sin.col_off, sout.col_off, cfg.oh, cfg.ow, cfg.kh,
            cfg.kw, cfg.ph, cfg.pw, cfg.oc, layout.packed_cp(cfg.oc),
            cfg.oc1x1, layout.packed_cp(cfg.oc1x1) if fuse else 0,
            int(cfg.conv0_round == round_mode.down),
            int(cfg.conv1_round == round_mode.down),
            int(cfg.conv0_with_bias), int(cfg.conv1_with_bias), int(fuse),
            0 if ss is None else ss.rows, 0 if ss is None else ss.halo,
            int(op.pool2), int(op.merge_pool))


def packed_conv_plan(op: PackedConvOp, n: int, rows=None) -> dict:
    """The packed conv kernel's plan for a call at batch n (and row range
    ``rows``), without launching: its output tile, the tiles, the blocks
    (at most one per SM of the H100's 132, each walking its share of the
    tiles), ring stages, shared bytes, lanes per pass and passes of each
    stage, K chunks and bytes per tap
    (``torch.ops.deepfusion_torch.packed_plan``, the launcher's own
    planning)."""
    cfg = op.cfg
    _, _, oy0, oy1 = op._row_plan(rows)
    ks = op.kernel_sins
    cps = [s.cp for s in ks] + [0] * (MAX_INPUTS - len(ks))
    fuse = cfg.fuse_conv1x1
    vals = [n, oy1 - oy0, cfg.ow, len(ks), *cps, cfg.kh, cfg.kw,
            layout.packed_cp(cfg.oc),
            layout.packed_cp(cfg.oc1x1) if fuse else 0, int(fuse),
            int(op.pool2), int(op.merge_pool)]
    keys = ("tile_rows", "tile_cols", "blocks", "stages", "smem_bytes",
            "nb0", "nb1", "passes0", "passes1", "chunks_per_tap",
            "k_per_tap", "tiles")
    return dict(zip(keys, _build.op("packed_plan")(vals)))


def packed_conv_cuda(op: PackedConvOp, arrs, sum_arr=None, *,
                     emit_acc1: bool = False, rows=None,
                     row0_off: int = 0) -> torch.Tensor:
    """Launch ``packed_conv_kernel`` on the current stream, on the inputs
    joined as ``op.kernel_groups`` says (the inputs themselves where each
    group holds one), through ``torch.ops.deepfusion_torch.packed_conv``,
    which checks, aligns, allocates and launches in C++. Only the output's
    row range and the input slice depend on the call."""
    cfg = op.cfg
    u0, u1, oy0, oy1 = op._row_plan(rows)
    if oy1 == oy0:   # a range of pad rows only: nothing to compute
        so = op.sout_final
        nrows = (u1 - u0) // (2 if op.pool2 else 1)
        return torch.full((arrs[0].shape[0], nrows * so.iwp, so.cp),
                          0 if emit_acc1 else -128,
                          dtype=torch.int32 if emit_acc1 else torch.int8,
                          device=arrs[0].device)
    if len(arrs) != len(op.kernel_groups):
        arrs = join_groups(arrs, op.kernel_groups)
    fuse = cfg.fuse_conv1x1
    out = _build.op("packed_conv")(
        arrs, op._cps, op.corr0, op.bias0, op.scale0,
        op.bias1 if fuse else None, op.scale1 if fuse else None,
        _weight_maps(op), sum_arr, op._geo,
        (op.sin.halo - row0_off, u1 - u0, op.sout.halo - u0, oy0, oy1 - oy0),
        emit_acc1, cfg.sum_scale)
    modes = (("acc1",) if emit_acc1 else ()) + (
        ("rows",) if rows is not None or row0_off else ()) + (
        ("merge_pool",) if op.merge_pool else ())
    _build.count_launch("packed_conv", *modes)
    return out


# -------------------------------------------- sharded packed images

def pack_image_sharded(src_u8, spec_local: PackedSpec, n_shards: int,
                       device=None) -> torch.Tensor:
    """NHWC u8 -> the sharded packed format: H split into n_shards equal
    slabs, each packed with ``spec_local`` (whose ``h`` is a shard's
    height), joined on the flat-row dim, on the source's device (a numpy
    source's as ``pack_image``). Split on that dim, each shard is a valid
    packed image whose halo rows ``parallel.shard.sp_packed`` fills from
    its neighbours."""
    src = as_tensor(src_u8, device)
    check(src.shape[1] == spec_local.h * n_shards,
          "pack_image_sharded: H does not split into n_shards local specs")
    return torch.cat([pack_image(x, spec_local)
                      for x in src.split(spec_local.h, dim=1)], dim=1)


def unpack_image_sharded(arr, spec_local: PackedSpec,
                         n_shards: int) -> torch.Tensor:
    """Inverse of pack_image_sharded (image rows only; the shards' halo
    rows are dropped)."""
    arr = torch.as_tensor(arr)
    rl = spec_local.rows * spec_local.iwp
    check(arr.shape[1] == rl * n_shards,
          "unpack_image_sharded: array does not hold n_shards local specs")
    return torch.cat([unpack_image(a, spec_local)
                      for a in arr.split(rl, dim=1)], dim=1)
