"""The composed dp x sp x tp execution plan (three sharded stages).

The PyTorch counterpart of ``deepfusion_tpu/parallel/plan.py``, with the
same weights from the same seeded draws:

  stage 1: a fused conv3x3+1x1 (u8 -> u8), the batch over ``dp`` and H
           over ``sp`` with the halo exchange (``shard.sp_conv``);
  stage 2: a fused conv with the 3x3's output channels over ``tp``, the
           1x1's contraction completed by ``psum_scatter`` before the
           requant (``shard.tp_fused_conv``);
  stage 3: the conv pair with its fused 2x2 pool over dp x sp
           (``PackedConvPairOp`` under ``shard.sp_packed``), fed by
           ``pack_image_sharded`` and unpacked to a dense u8 image at the
           end, so the plan's output does not depend on the mesh's shape.

On a mesh that spans processes each process passes its block of the input
(the batch rows of its dp rows by the H rows of its sp shards, as
``shard.sp_conv`` takes it) and gets its block of the output. Between the
stages the plan reshards as XLA does for the JAX plan: stage 1's block is
all-gathered over the processes of its sp line (``gathered``), so that
stage 2 runs on every H row of the process's batch rows, and stage 3 takes
the process's sp shards of stage 2's output.
"""
from __future__ import annotations

import numpy as np

from ..config import ConvConfig
from ..ops.conv import ConvOp
from ..ops.mega import PackedConvPairOp
from ..ops.packed import (PackedSpec, pack_image_sharded,
                          unpack_image_sharded)
from ..utils.logger import check
from ..utils.mathutil import round_up
from .shard import sp_conv, sp_packed, tp_fused_conv


def three_stage_plan(mesh, mb: int, hw: int, ic: int, oc: int, oc1: int,
                     rng=None, magnitude: int = 10):
    """Build the composed plan at the given shape, its ops on the device of
    this process's first slot of the mesh.

    Returns ``(step, pair, cfg2)``: ``step(src_u8_nhwc)`` -> the dense u8
    (mb, hw/2, hw/2, oc1) output (on a mesh that spans processes, this
    process's block of input and output, ``step.block``: its dp rows and
    sp shards, as ``shard._sp_wrapper`` gives them); ``pair``, the stage-3
    op; ``cfg2``, the stage-2 config (for ``tp_wire_bytes``). Shape legality:
    ``mb % dp == 0``, ``hw % (2*sp) == 0``, ``oc % tp == 0``; across
    processes, a tp line that spans processes needs dp == 1, so that every
    process of the line holds the same batch rows.
    """
    rng = rng or np.random.default_rng(0)
    dp, sp, tp = (mesh.shape[a] for a in ("dp", "sp", "tp"))
    check(mb % dp == 0, f"batch {mb} not divisible by dp={dp}")
    check(hw % max(2 * sp, 2) == 0,
          f"hw {hw} must be divisible by 2*sp (sp shards + pool2)")
    check(oc % tp == 0, f"oc {oc} not divisible by tp={tp}")
    check(dp == 1 or mesh.line("tp", **mesh.home("tp")).group is None,
          "three_stage_plan: a tp line that spans processes needs dp == 1")
    m = magnitude
    dev = mesh.device(**mesh.home())

    wei = rng.integers(-m, m + 1, (oc, ic, 3, 3)).astype(np.int8)
    bia = rng.integers(-m, m + 1, (oc,)).astype(np.int32)
    wei1 = rng.integers(-m, m + 1, (oc1, oc, 1, 1)).astype(np.int8)
    bia1 = rng.integers(-m, m + 1, (oc1,)).astype(np.int32)

    # stage 1: dp x sp sharded fused conv (u8 -> u8), halo exchange on sp
    cfg1 = ConvConfig.make(
        (mb, hw, hw, ic), (oc, ic, 3, 3), bia.dtype, (1, 1), (1, 1),
        (mb, hw, hw, oc1), "u8", conv0_scales=(0.02,),
        wei1x1_shape=(oc1, oc, 1, 1), bia1x1_dt=bia1.dtype,
        conv1_relu=True, conv1_scales=(0.2,))
    op1 = ConvOp(cfg1, wei, bia, wei1, bia1, device=dev)
    stage1 = sp_conv(op1, mesh, axis="sp", dp_axis="dp")

    # stage 2: tp-sharded fused conv (collective before requant)
    wei2 = rng.integers(-m, m + 1, (oc, oc1, 3, 3)).astype(np.int8)
    wei21 = rng.integers(-m, m + 1, (oc1, oc, 1, 1)).astype(np.int8)
    cfg2 = ConvConfig.make(
        (mb, hw, hw, oc1), (oc, oc1, 3, 3), None, (1, 1), (1, 1),
        (mb, hw, hw, oc1), "u8", conv0_scales=(0.02,),
        wei1x1_shape=(oc1, oc, 1, 1), conv1_relu=True,
        conv1_scales=(0.2,))
    stage2 = tp_fused_conv(cfg2, wei2, None, wei21, None, mesh,
                           wire="reduce_scatter")

    # stage 3: dp x sp sharded pool2 conv pair (halo exchange in the
    # packed domain; input halo halo_out + ph_a + ph_b)
    wei3a = rng.integers(-m, m + 1, (oc1, oc1, 3, 3)).astype(np.int8)
    wei3b = rng.integers(-m, m + 1, (oc1, oc1, 3, 3)).astype(np.int8)
    cfg3 = ConvConfig.make(
        (mb, hw, hw, oc1), (oc1, oc1, 3, 3), None, (1, 1), (1, 1),
        (mb, hw, hw, oc1), "u8", conv0_relu=True, conv0_scales=(0.05,))
    sin3 = PackedSpec.make(hw, hw, oc1, halo=4, col_off=2,
                           iwp=round_up(hw + 4, 16))
    pair = PackedConvPairOp(cfg3, (wei3a, None), cfg3, (wei3b, None),
                            sin=sin3, halo_out=2, col_off_out=2,
                            pool2=True, device=dev)
    stage3 = sp_packed(pair, mesh, axis="sp", dp_axis="dp")
    (c0, c1), h_l = stage3.block[1], hw // sp

    def step(s):
        y = stage2(stage1.gathered(s))[:, c0 * h_l:c1 * h_l]
        z = stage3(pack_image_sharded(y, stage3.local_spec, c1 - c0))
        # unpack the sharded pooled output to a dense u8 image, the same
        # for every mesh shape
        return unpack_image_sharded(z, stage3.local_out_spec, c1 - c0)

    step.block = stage3.block
    return step, pair, cfg2
