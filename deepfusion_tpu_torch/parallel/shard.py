"""Sharded execution wrappers: DP / TP / SP over a mesh of torch devices.

The PyTorch counterpart of ``deepfusion_tpu/parallel/shard.py``:

* ``dp_shard``: the batch split over ``dp``, no collectives.
* ``tp_fused_conv`` / ``tp_packed_fused``: the 3x3's output channels (and
  the 1x1's input channels) split over ``tp``; each shard computes the raw
  s32 1x1 accumulator of its channel slice, and a ``psum`` (or a
  ``psum_scatter`` over the 1x1's lanes, then an ``all_gather`` of the
  requantized bytes) completes the contraction before the nonlinear
  requant. int32 adds are exact in any order, so the result is the
  single-device op's, bit for bit.
* ``sp_conv`` / ``sp_packed``: H split over ``sp``; the halo rows a shard
  needs from its neighbours come by ``ppermute``, posted before the
  interior rows run; the boundary rows run once they have landed.

A wrapper runs, in each process, the shards of that process's slots, each
on its slot's device, one after another, and joins their outputs on the
device of its first slot; ``fn.shards(...)`` returns the per-slot outputs,
each on its own device. On a mesh of one process that is every shard: the
wrapper takes the whole input and returns the whole output, as
``shard_map`` on one host. On a mesh that spans the processes of a group
(``mesh.make_mesh``), the shards of different processes run at the same
time, and each wrapper says what part of the input and output a process
holds. A collective between slots of one process moves tensors device to
device (``.to(dev, non_blocking=True)``); between processes it goes over
the group of the slots' line. On a mesh whose slots are all one card every
shard launches the real kernel modes; the results are a multi-card run's,
the times are not.
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from ..config import ConvConfig
from ..ops import layout
from ..ops.conv import ConvOp, conv_fused_acc1
from ..ops.convpool import ConvPoolOp
from ..ops.mega import PackedConvPairOp
from ..ops.packed import PackedConvOp
from ..ops.requant import requant, requant_to_u8
from ..utils.logger import check, check_eq
from ..utils.mathutil import round_up
from .mesh import Line, Mesh

# ------------------------------------------------------------ collectives
# Each takes the parts of this process's slots on a line (one tensor per
# slot of ``line.mine``, in that order) and returns one tensor per slot of
# this process, on its device. Between processes they go over the line's
# group: NCCL moves card memory; gloo moves host memory, so over gloo a
# tensor on a card is staged through a host buffer, the wire the caller
# chose. The wire takes contiguous tensors and splits and joins on dim 0.


def _to(t: torch.Tensor, dev) -> torch.Tensor:
    return t.to(dev, non_blocking=True)


def _wire(t: torch.Tensor, line: Line) -> torch.Tensor:
    """t as the line's group takes it: contiguous, in host memory over
    gloo."""
    t = t.contiguous()
    if t.is_cuda and dist.get_backend(line.group) == "gloo":
        return t.cpu()
    return t


def _processes(line: Line) -> int:
    """The processes of the line, each holding an equal run of its slots
    in rank order (what the wire's equal chunks need)."""
    procs = sorted(set(line.ranks))
    check(list(line.ranks) == [r for r in procs
                               for _ in range(len(line.mine))],
          f"the processes of a line must hold equal runs of its slots "
          f"(ranks {line.ranks})")
    return len(procs)


def _local_sum(parts, dev) -> torch.Tensor:
    total = _to(parts[0], dev).clone()
    for p in parts[1:]:
        total += _to(p, dev)
    return total


def psum(parts, line: Line):
    """The elementwise sum of the line's int32 tensors, on every slot: this
    process's parts summed on its first slot's device, then all-reduced
    over the processes, then copied."""
    devs = [line.devices[i] for i in line.mine]
    total = _local_sum(parts, devs[0])
    if line.group is not None:
        buf = _wire(total, line)
        dist.all_reduce(buf, group=line.group)
        g = len(set(line.ranks))
        line.mesh.wire_bytes += 2 * (g - 1) * buf.nbytes // g
        total = _to(buf, devs[0])
    return [_to(total, d) for d in devs]


def psum_scatter(parts, line: Line, dim: int):
    """Slot i gets chunk i (of equal chunks along `dim`) of the sum. Across
    processes: this process's parts summed, `dim` moved to the front for
    ``reduce_scatter_tensor``, which gives this process the chunks of its
    slots, and moved back."""
    devs = [line.devices[i] for i in line.mine]
    c = parts[0].shape[dim] // len(line.devices)
    if line.group is None:
        out = []
        for i, d in enumerate(devs):
            chunk = _to(parts[0].narrow(dim, i * c, c), d).clone()
            for p in parts[1:]:
                chunk += _to(p.narrow(dim, i * c, c), d)
            out.append(chunk)
        return out
    g = _processes(line)
    t = _wire(_local_sum(parts, devs[0]).movedim(dim, 0), line)
    out = t.new_empty((t.shape[0] // g,) + tuple(t.shape[1:]))
    dist.reduce_scatter_tensor(out, t, group=line.group)
    line.mesh.wire_bytes += (g - 1) * t.nbytes // g
    out = _to(out, devs[0]).movedim(0, dim)
    return [_to(ch.contiguous(), d) for ch, d in zip(out.split(c, dim), devs)]


def _gather_processes(t: torch.Tensor, line: Line, dim: int):
    """t, this process's part of the line, joined along `dim` with every
    other process's, in slot order (``all_gather_into_tensor`` with `dim`
    moved to the front), on t's device."""
    g = _processes(line)
    w = _wire(t.movedim(dim, 0), line)
    out = w.new_empty((g * w.shape[0],) + tuple(w.shape[1:]))
    dist.all_gather_into_tensor(out, w, group=line.group)
    line.mesh.wire_bytes += (g - 1) * out.nbytes // g
    return _to(out, t.device).movedim(0, dim).contiguous()


def all_gather(parts, line: Line, dim: int):
    """Every slot gets the line's tensors joined along `dim`."""
    devs = [line.devices[i] for i in line.mine]
    if line.group is None:
        return [torch.cat([_to(p, d) for p in parts], dim=dim) for d in devs]
    full = _gather_processes(
        torch.cat([_to(p, devs[0]) for p in parts], dim=dim), line, dim)
    return [_to(full, d) for d in devs]


def ppermute(parts, line: Line, perm, tag: int = 0):
    """Slot j gets slot i's tensor for each (i, j) in perm; None where no
    pair sends to j. Every receiver's tensor has the shape and dtype of its
    own part. Posts the copies and returns ``wait``: call it before using
    what it returns, the list of received tensors. Between processes the
    sends and receives go out together (``batch_isend_irecv``); `tag`
    keeps apart exchanges in flight at the same time (gloo matches
    messages by it)."""
    mine = dict(zip(line.mine, parts))
    out = dict.fromkeys(line.mine)
    ops, recvs, n = [], [], len(line.devices)
    for i, j in perm:
        if i in mine and j in mine:
            out[j] = _to(mine[i], line.devices[j])
        elif i in mine:
            buf = _wire(mine[i], line)
            ops.append(dist.P2POp(dist.isend, buf, line.ranks[j],
                                  line.group, tag * n + i))
            line.mesh.wire_bytes += buf.nbytes
        elif j in mine:
            buf = _wire(torch.empty_like(mine[j]), line)
            ops.append(dist.P2POp(dist.irecv, buf, line.ranks[i],
                                  line.group, tag * n + i))
            recvs.append((j, buf))
    works = dist.batch_isend_irecv(ops) if ops else []

    def wait():
        for w in works:
            w.wait()
        ops.clear()             # the posted buffers lived until here
        for j, buf in recvs:
            out[j] = _to(buf, line.devices[j])
        return [out[j] for j in line.mine]
    return wait


# ------------------------------------------------------------- helpers

def _wrapper(split, local, join, device, n_in: int = 1,
             has_sum: bool = False):
    """The sharded callable ``fn(src, sum_src=None)``: ``src`` one tensor
    or n_in of them, ``sum_src`` exactly when the op has a sum operand;
    ``fn = join(local(split(*inputs)))``, and ``fn.shards`` returns the
    outputs of this process's slots, each on its device. ``fn.device`` is
    ``device``, where ``join`` lands (this process's first slot's), so
    that ``BatchServer`` (``serving.model_device``) serves ``fn`` as it
    serves a model."""
    def inputs(src, sum_src):
        check((sum_src is not None) == has_sum,
              "pass sum_src exactly when the op has a sum post-op")
        srcs = tuple(src) if n_in > 1 else (src,)
        check(len(srcs) == n_in, "op expects one array per input spec")
        return [torch.as_tensor(a)
                for a in srcs + ((sum_src,) if has_sum else ())]

    def run(src, sum_src=None):
        return join(local(split(*inputs(src, sum_src))))

    run.shards = lambda src, sum_src=None: local(split(*inputs(src,
                                                              sum_src)))
    run.device = torch.device(device)
    return run


def _on(op, dev):
    """op (or model), or a copy of it on dev: ``.to`` moves its buffers,
    and each op's cached tensor maps, keyed by its buffers' pointers, are
    encoded again for the copy's."""
    return op if op.device == torch.device(dev) else \
        copy.deepcopy(op).to(dev)


def _split(a: torch.Tensor, n: int, dim: int, what: str):
    check(a.shape[dim] % n == 0,
          f"{what} {a.shape[dim]} not divisible by this process's {n} "
          f"slots")
    return a.chunk(n, dim=dim)


# ------------------------------------------------------------------ DP

_OP_FAMILIES = (ConvOp, ConvPoolOp, PackedConvOp, PackedConvPairOp)


def dp_shard(op, mesh: Mesh, axis: str = "dp"):
    """Wrap an op or a model so the batch dim is sharded over `axis`.

    Every repeated-submission op family: ``ConvOp`` (strided and sum
    post-op configs included), ``ConvPoolOp``, ``PackedConvOp``
    (multi-input branch merges and packed sum operands included) and
    ``PackedConvPairOp``; and a model: an ``nn.Module`` with a ``device``
    and a one-input ``forward`` of any batch (``FusionNet``,
    ``ResFusionNet``, ``VGGFusion`` or their ``packed_module()``), the
    JAX package's ``shard_map`` of ``net.__call__`` over ``dp``. Weights
    are replicated, a copy on each slot's device; no collectives. The
    returned callable takes the op's arguments (``src`` and, for sum
    configs, ``sum_src``), and carries ``device`` (this process's first
    slot's), so ``BatchServer`` serves it. On a mesh of one process the
    arguments are whole, split on the batch dim into equal shards; on a
    mesh that spans processes each process passes its part of the global
    batch, the rows of its slots on the ``dp`` line through its first
    slot (``Mesh.home``), and gets their outputs back.
    """
    model = not isinstance(op, _OP_FAMILIES)
    check(not model or (isinstance(op, nn.Module)
                        and getattr(op, "device", None) is not None),
          f"dp_shard does not support {type(op).__name__}: an op of "
          f"{', '.join(c.__name__ for c in _OP_FAMILIES)} or a model (an "
          "nn.Module with a device and a one-input forward)")
    n_shard = mesh.shape[axis]
    is_pair = isinstance(op, PackedConvPairOp)
    packed = isinstance(op, PackedConvOp) or is_pair
    n_in, has_sum = 1, False
    if not model:
        cfg = op.cfg_a if is_pair else op.cfg
        check(cfg.bs % n_shard == 0,
              f"batch {cfg.bs} not divisible by {axis}")
        n_in = len(op.sins) if isinstance(op, PackedConvOp) else 1
        has_sum = False if is_pair else (
            op.ssum is not None if packed else cfg.with_sum)
    line = mesh.line(axis, **mesh.home(axis))
    devs = [line.devices[i] for i in line.mine]
    ops = [_on(op, d) for d in devs]

    def split(*args):
        return list(zip(*[[_to(c, d) for c, d in zip(
            _split(a, len(devs), 0, "batch"), devs)] for a in args]))

    def local(shard_args):
        outs = []
        for o, a in zip(ops, shard_args):
            src = a[:n_in] if n_in > 1 else a[0]
            if has_sum:
                outs.append(o(src, a[n_in]) if packed
                            else o(src, sum_src=a[n_in]))
            else:
                outs.append(o(src))
        return outs

    def join(outs):
        return torch.cat([_to(o, devs[0]) for o in outs], dim=0)

    return _wrapper(split, local, join, devs[0], n_in, has_sum)


# ------------------------------------------------------------------ TP

def _acc_lanes(oc1x1: int, n_shard: int, wire: str) -> int:
    """Lanes of the accumulator on the wire: oc1x1 (the JAX package pads
    to 128), padded to a multiple of the shards for the scatter."""
    return round_up(oc1x1, n_shard) if wire == "reduce_scatter" else oc1x1


def tp_wire_bytes(cfg: ConvConfig, n_shard: int, wire: str) -> int:
    """Analytic per-device interconnect bytes of one tp_fused_conv call.

    Ring cost model: an all-reduce (psum) of B bytes moves 2*(N-1)/N * B
    per device; the reduce_scatter wire moves (N-1)/N * B of the s32
    scatter plus (N-1)/N of the gather of the requantized output. Across
    processes, one slot each, this is what ``Mesh.wire_bytes`` counts."""
    elems = cfg.bs * cfg.oh * cfg.ow * _acc_lanes(cfg.oc1x1, n_shard, wire)
    if wire == "psum":
        return int(2 * (n_shard - 1) / n_shard * elems * 4)
    return int((n_shard - 1) / n_shard * elems * (4 + cfg.dst_dt.size))


def _check_tp(cfg: ConvConfig, n_shard: int, axis: str, wire: str, what):
    check(cfg.fuse_conv1x1, f"{what} needs the fused config")
    check(wire in ("psum", "reduce_scatter"),
          f"unknown tp wire {wire!r} (psum | reduce_scatter)")
    check(cfg.oc % n_shard == 0, f"oc {cfg.oc} not divisible by {axis}")


def _slice_cfg(cfg: ConvConfig, sl: slice) -> ConvConfig:
    """cfg for the 3x3 output channels `sl` (their scales with them)."""
    sc = cfg.conv0_scales
    return dataclasses.replace(cfg, oc=sl.stop - sl.start,
                               conv0_scales=sc[sl] if len(sc) > 1 else sc)


def _epilogue_lanes(vec: torch.Tensor, lanes: int, fill: float):
    return torch.cat([vec, vec.new_full((lanes - vec.shape[0],), fill)])


def _tp_collect(accs, line: Line, lanes: int, wire: str, finish):
    """Complete the int32 contraction over the line's shards and
    requantize: psum then ``finish(acc, shard, 0, lanes)`` on every shard
    of this process, or scatter the lanes, finish each shard's lanes
    [lo, hi) and gather. Returns this process's shards' outputs."""
    if wire == "psum":
        return [finish(a, i, 0, lanes)
                for i, a in zip(line.mine, psum(accs, line))]
    c = lanes // len(line.devices)
    pad = lanes - accs[0].shape[-1]
    if pad:
        accs = [torch.nn.functional.pad(a, (0, pad)) for a in accs]
    parts = psum_scatter(accs, line, dim=accs[0].dim() - 1)
    res = [finish(p, i, i * c, (i + 1) * c)
           for i, p in zip(line.mine, parts)]
    return all_gather(res, line, dim=res[0].dim() - 1)


def tp_fused_conv(cfg: ConvConfig, wei, bia, wei1x1, bia1x1, mesh: Mesh,
                  axis: str = "tp", wire: str = "reduce_scatter"):
    """Tensor-parallel fused conv3x3+1x1: the 3x3's output channels over
    `axis`.

    Shard d runs ``conv_fused_acc1`` (K1b's raw accumulator) of its
    channel slice: its 3x3 weights, biases and scales, and the matching
    input rows of the 1x1. The collective completes the 1x1's contraction
    before the requant (which is nonlinear: requantizing partial sums
    would be wrong).

    wire = "reduce_scatter" (default): scatter the s32 accumulator over
    the 1x1's lanes, requantize each shard's lanes, gather the narrow
    result. wire = "psum": all-reduce the accumulator, requantize on every
    shard. The requant after the collective is plain PyTorch, as the JAX
    package writes it in ``jnp``. Each process builds the ops of its own
    slots on the line through its first slot; it takes the whole input
    and returns the whole output (replicated after the collective) on its
    first slot's device.
    """
    _check_tp(cfg, mesh.shape[axis], axis, wire, "tp_fused_conv")
    n_shard = mesh.shape[axis]
    oc_l = cfg.oc // n_shard
    line = mesh.line(axis, **mesh.home(axis))
    mine = line.mine
    devs = [line.devices[d] for d in mine]
    wei, w1 = np.asarray(wei), np.asarray(wei1x1)
    ops = []
    for d, dev in zip(mine, devs):
        sl = slice(d * oc_l, (d + 1) * oc_l)
        ops.append(ConvOp(_slice_cfg(cfg, sl), wei[sl],
                          None if bia is None else np.asarray(bia)[sl],
                          w1[:, sl],
                          device=dev))
    lanes = _acc_lanes(cfg.oc1x1, n_shard, wire)
    bias1 = {d: _epilogue_lanes(torch.from_numpy(
        layout.widen_bias(bia1x1, cfg.oc1x1)), lanes, 0.0).to(dev)
        for d, dev in zip(mine, devs)}
    scale1 = {d: _epilogue_lanes(torch.from_numpy(layout.widen_scales(
        cfg.conv1_scales, cfg.oc1x1, cfg.oc1x1)), lanes, 1.0).to(dev)
        for d, dev in zip(mine, devs)}

    def split(src):
        return [_to(src, d) for d in devs]

    def local(srcs):
        accs = [conv_fused_acc1(o, s) for o, s in zip(ops, srcs)]

        def finish(acc, d, lo, hi):
            return requant(acc, bias1[d][lo:hi] if cfg.conv1_with_bias
                           else None, scale1[d][lo:hi], cfg.conv1_relu,
                           cfg.conv1_round, cfg.dst_dt)
        outs = _tp_collect(accs, line, lanes, wire, finish)
        return [o[..., :cfg.oc1x1] for o in outs]

    return _wrapper(split, local, lambda outs: outs[0], devs[0])


def tp_packed_fused(op, mesh: Mesh, axis: str = "tp",
                    wire: str = "reduce_scatter"):
    """Tensor-parallel packed fused conv: the 3x3's output channels over
    `axis`, the packed twin of ``tp_fused_conv``.

    Shard d runs K5 in its ``emit_acc1`` mode on an op built from its slice
    of the weights (``layout.unpack_weights`` of the op's words; the 1x1's
    input rows with them). After the collective, the final stage runs as
    the kernel's epilogue does: requant to u8, the 0x80 byte pack, -128 in
    every non-image slot (the s32 accumulator's pad lanes hold 0, which
    requantizes to u8 0). Needs a fused op with one input, no sum operand
    and no pool2; oc divisible by the shard count. Each process builds the
    ops of its own slots, takes the whole packed input and returns the
    whole packed output on its first slot's device, as ``tp_fused_conv``.
    """
    check(type(op) is PackedConvOp, "tp_packed_fused needs a PackedConvOp")
    cfg = op.cfg
    check(cfg.fuse_conv1x1, "tp_packed_fused needs the fused config")
    check(len(op.sins) == 1 and op.ssum is None and not op.pool2,
          "tp_packed_fused: single input, no sum post-op, no pool2")
    n_shard = mesh.shape[axis]
    _check_tp(cfg, n_shard, axis, wire, "tp_packed_fused")
    oc_l = cfg.oc // n_shard
    sin, sout = op.sin, op.sout
    n0, cp1 = layout.packed_cp(cfg.oc), sout.cp
    line = mesh.line(axis, **mesh.home(axis))
    mine = line.mine
    devs = [line.devices[d] for d in mine]
    w0 = layout.unpack_weights(op.w0.cpu(), n0, layout.conv_icp(cfg.ic),
                               cfg.kh, cfg.kw)[:cfg.oc, :cfg.ic].numpy()
    w1 = layout.unpack_weights(op.w1.cpu(), cfg.oc1x1, cfg.oc, 1,
                               1).numpy()
    bias0 = op.bias0.cpu().numpy()[:cfg.oc] if cfg.conv0_with_bias else None
    ops = []
    for d, dev in zip(mine, devs):
        sl = slice(d * oc_l, (d + 1) * oc_l)
        ops.append(PackedConvOp(
            _slice_cfg(cfg, sl), w0[sl], None if bias0 is None else bias0[sl],
            w1[:, sl], sin=sin, col_off_out=sout.col_off,
            halo_out=sout.halo, device=dev))
    lanes = _acc_lanes(cp1, n_shard, wire)
    bias1 = {d: _epilogue_lanes(op.bias1, lanes, 0.0).to(dev)
             for d, dev in zip(mine, devs)}
    scale1 = {d: _epilogue_lanes(op.scale1, lanes, 1.0).to(dev)
              for d, dev in zip(mine, devs)}
    pos = torch.arange(sout.rows * sout.iwp)
    col, row = pos % sout.iwp, pos // sout.iwp
    image = ((col >= sout.col_off) & (col < sout.col_off + sout.w)
             & (row >= sout.halo) & (row < sout.halo + sout.h))[None, :, None]
    masks = {d: image.to(dev) for d, dev in zip(mine, devs)}

    def split(src):
        return [_to(src, d) for d in devs]

    def local(xs):
        accs = [o(x, emit_acc1=True) for o, x in zip(ops, xs)]

        def finish(acc, d, lo, hi):
            val = requant_to_u8(acc, bias1[d][lo:hi] if cfg.conv1_with_bias
                                else None, scale1[d][lo:hi],
                                cfg.conv1_round)
            return torch.where(masks[d], (val ^ 0x80).view(torch.int8),
                               torch.tensor(-128, dtype=torch.int8,
                                            device=acc.device))
        outs = _tp_collect(accs, line, lanes, wire, finish)
        return [o[..., :cp1] for o in outs]

    return _wrapper(split, local, lambda outs: outs[0], devs[0])


# ------------------------------------------------------------------ SP

def _sp_wrapper(mesh, axis, dp_axis, bs, run_row, n_in=1, has_sum=False,
                out_rows=None, shard_rows=None):
    """The (dp, sp) grid of the mesh's slice through this process's first
    slot, one ``sp`` line per ``dp`` row; this process's slots on it must
    form a block: rows [r0, r1) by columns [c0, c1) (``run.block``). Split
    each input, this process's block of the whole (batch rows by H rows;
    on a mesh of one process, the whole), over the block's rows (batch)
    and columns (dim 1), run ``run_row(shards, line)`` on each row's
    shards, join the outputs back; the output rows past out_rows (of the
    whole, each shard giving shard_rows) are dropped. ``shards`` gives the
    outputs per dp row of the block, per sp shard; ``gathered`` the block's
    dp rows of the output, every H row, all-gathered over each row's
    processes (the reshard of a (dp, sp)-split array to a dp-split one)."""
    at = mesh.home(axis, *([dp_axis] if dp_axis else []))
    n_dp = 1 if dp_axis is None else mesh.shape[dp_axis]
    lines = [mesh.line(axis, **{**at, **({dp_axis: i} if dp_axis else {})})
             for i in range(n_dp)]
    if dp_axis is not None:
        check(bs % n_dp == 0, f"batch {bs} not divisible by {dp_axis}")
    rows = [i for i, line in enumerate(lines) if line.mine]
    cols = lines[rows[0]].mine
    check(rows == list(range(rows[0], rows[-1] + 1))
          and all(lines[i].mine == cols for i in rows),
          f"this process's slots of the {dp_axis} x {axis} grid must form "
          "a block")
    grid = [lines[i] for i in rows]
    dev = grid[0].devices[cols[0]]

    def split(*args):
        per = [[_split(r, len(cols), 1, "rows")
                for r in _split(a, len(rows), 0, "batch")] for a in args]
        return [[[_to(p[ri][ci], line.devices[j]) for p in per]
                 for ci, j in enumerate(cols)]
                for ri, line in enumerate(grid)]

    def local(parts):
        return [run_row(r, line) for r, line in zip(parts, grid)]

    def trim(out):
        if out_rows is None:
            return out
        return out[:, :max(out_rows - cols[0] * shard_rows, 0)]

    def join(outs):
        return trim(torch.cat([torch.cat([_to(o, dev) for o in row], dim=1)
                               for row in outs], dim=0))

    run = _wrapper(split, local, join, dev, n_in, has_sum)

    def gathered(src, sum_src=None):
        full = []
        for row, line in zip(run.shards(src, sum_src), grid):
            out = torch.cat([_to(o, dev) for o in row], dim=1)
            if line.group is not None:
                out = _gather_processes(out, line, 1)
            full.append(out)
        out = torch.cat(full, dim=0)
        return out if out_rows is None else out[:, :out_rows]

    run.gathered = gathered
    run.block = ((rows[0], rows[-1] + 1), (cols[0], cols[-1] + 1))
    return run


def sp_conv(conv_op, mesh: Mesh, axis: str = "sp",
            dp_axis: Optional[str] = None):
    """Spatially sharded conv: H split over `axis`, the halo rows by
    ``ppermute``, posted before the interior rows run.

    Per shard: (1) both halo ppermutes posted (the outer edges get the
    conv's zero padding); (2) the interior output rows [ph, ih_l - kb),
    which read local rows only; (3) once the halos have landed, the top ph
    and bottom kb rows on slabs of the halo and the edge rows; (4) the
    rows joined. Any ph < kh with stride_h 1 and ih % shards == 0; each
    shard computes ih_l rows against a zero-extended bottom edge, and the
    output is the first oh rows. stride_w may be > 1 (the kernel takes
    stride in its addressing). A sum post-op needs oh == ih; its operand
    is split with the output. ``dp_axis`` also splits the batch over a
    second axis. On a mesh that spans processes, each process passes its
    block of the input (and of the sum operand): the batch rows of its dp
    rows by the H rows of its sp shards (``_sp_wrapper``), and gets its
    block of the output.
    """
    check(type(conv_op) is ConvOp,
          f"sp_conv supports ConvOp (got {type(conv_op).__name__}); "
          "spatially sharding pooled/packed ops is not implemented; "
          "use dp_shard for those families")
    cfg = conv_op.cfg
    n_shard = mesh.shape[axis]
    check_eq(cfg.sh, 1, "sp_conv requires stride_h == 1")
    check(cfg.ih % n_shard == 0, f"ih {cfg.ih} not divisible by {axis}")
    with_sum = cfg.with_sum
    if with_sum:
        check_eq(cfg.oh, cfg.ih, "sp_conv with a sum post-op requires "
                                 "oh == ih (aligned shard boundaries)")
    ih_l = cfg.ih // n_shard
    ph, kh = cfg.ph, cfg.kh
    kb = kh - 1 - ph            # halo rows needed from below
    check(ih_l >= kh - 1, "shard too thin for the kernel height")
    ops = {}

    def slab_op(dev, rows, oh):
        """The conv over a slab of `rows` input rows, no row padding."""
        key = (dev, rows)
        if key not in ops:
            ops[key] = _on(conv_op, dev).with_geometry(ph=0, ih=rows, oh=oh)
        return ops[key]

    def run_row(shards, line):
        srcs = dict(zip(line.mine, (s[0] for s in shards)))
        sums = dict(zip(line.mine, (s[1] if with_sum else None
                                    for s in shards)))
        last = len(line.devices) - 1

        def rows(j, lo, hi):
            return None if sums[j] is None else sums[j][:, lo:hi]
        # 1. both halo exchanges in flight
        tops = bots = None
        if ph > 0:
            tops = ppermute([s[:, -ph:] for s in srcs.values()], line,
                            [(i, i + 1) for i in range(last)], tag=0)
        if kb > 0:
            bots = ppermute([s[:, :kb] for s in srcs.values()], line,
                            [(i + 1, i) for i in range(last)], tag=1)
        # 2. interior rows [ph, ih_l - kb) from local rows alone
        mids = {}
        if ih_l - kh + 1 > 0:
            for j, src in srcs.items():
                mids[j] = slab_op(line.devices[j], ih_l, ih_l - kh + 1)(
                    src, rows(j, ph, ih_l - kb))
        # 3. the boundary rows once the halos land; the outer edges get
        #    zero padding
        tops = dict(zip(line.mine, tops())) if ph > 0 else {}
        bots = dict(zip(line.mine, bots())) if kb > 0 else {}
        outs = []
        for j, src in srcs.items():
            dev = line.devices[j]
            parts = [mids[j]] if j in mids else []
            if ph > 0:
                top = tops[j] if j > 0 else src.new_zeros(src[:, :ph].shape)
                slab = torch.cat([top, src[:, :kh - 1]], dim=1)
                parts.insert(0, slab_op(dev, ph + kh - 1, ph)(
                    slab, rows(j, 0, ph)))
            if kb > 0:
                bot = bots[j] if j < last else \
                    src.new_zeros(src[:, :kb].shape)
                slab = torch.cat([src[:, ih_l - kh + 1:], bot], dim=1)
                parts.append(slab_op(dev, kb + kh - 1, kb)(
                    slab, rows(j, ih_l - kb, ih_l)))
            # 4. ih_l output rows per shard
            outs.append(torch.cat(parts, dim=1))
        return outs

    # shards compute n*ih_l = ih rows; the output is the first oh
    return _sp_wrapper(mesh, axis, dp_axis, cfg.bs, run_row,
                       has_sum=with_sum, out_rows=cfg.oh, shard_rows=ih_l)


def sp_packed(op, mesh: Mesh, axis: str = "sp",
              dp_axis: Optional[str] = None):
    """Spatially sharded packed conv: H split over `axis`, the halo rows
    by ``ppermute`` into each shard's own halo band.

    Distributed format: ``pack_image_sharded``'s join of per-shard packed
    images (each of height h / shards with its own halo band), split on
    the flat-row dim. Per shard:

      1. post the ppermutes of the neighbours' edge image rows (the outer
         shards keep the -128 padding);
      2. run the interior output rows, which read local image rows only,
         on the array before the exchange (``rows``);
      3. once the rows have landed, run the two boundary row ranges on row
         slices of the exchanged rows (``rows``/``row0_off``);
      4. join the three ranges.

    ``PackedConvOp`` (sum operand, multi-input, pool2) and
    ``PackedConvPairOp``; for a pair layer a computes the intermediate's
    rows past the shard's image from the exchanged halo (``mid_bounds``
    widened by ph_b on the sides inside the image). The sum operand comes
    in the same sharded format and needs no exchange. The output is in the
    sharded format of the op's output (the pooled spec with pool2). On a
    mesh that spans processes, each process passes its block: the batch
    rows of its dp rows by the local packed images of its sp shards
    (``_sp_wrapper``), and gets its block of the output.
    """
    is_pair = isinstance(op, PackedConvPairOp)
    check(is_pair or type(op) is PackedConvOp,
          f"sp_packed supports PackedConvOp/PackedConvPairOp "
          f"(got {type(op).__name__})")
    n_shard = mesh.shape[axis]
    check(op.sin.h % n_shard == 0,
          f"image height {op.sin.h} not divisible by {axis}={n_shard}")
    h_loc = op.sin.h // n_shard
    local = op.reheight(h_loc)
    sin_l, sout_l, so = local.sin, local.sout, local.sout_final
    halo, iwp = sin_l.halo, sin_l.iwp
    if is_pair:
        ca, cb = local.cfg_a, local.cfg_b
        dep_t, dep_b = ca.ph + cb.ph, (ca.kh - 1 - ca.ph) + (cb.kh - 1 - cb.ph)
        # a shard's boundary rows read ph_a + ph_b neighbour rows, which
        # the input's halo band must hold; the JAX package also needs the
        # roll-free erosion geometry for its tile clamps
        erosion = sin_l.halo - sout_l.halo
        check(halo >= dep_t and erosion >= dep_t and erosion >= dep_b,
              "sp_packed pair requires roll-free erosion geometry: "
              "sin.halo >= ph_a + ph_b and "
              "sin.halo - sout.halo >= ph_a + ph_b "
              "(construct the pair with a deeper sin halo, e.g. "
              "sin.halo = halo_out + ph_a + ph_b)")
    else:
        c = local.cfg
        dep_t, dep_b = c.ph, c.kh - 1 - c.ph
    check(h_loc >= max(dep_t, dep_b),
          f"shard height {h_loc} below the halo rows it sends "
          f"({max(dep_t, dep_b)})")
    has_sum = (not is_pair) and local.ssum is not None
    n_in = 1 if is_pair else len(local.sins)
    sins_l = (sin_l,) if is_pair else tuple(local.sins)
    # output rows (of the returned array, pooled with pool2): the top
    # boundary's image rows [0, a) and the bottom's [h_loc - b, h_loc)
    f = 2 if local.pool2 else 1
    a, b = round_up(dep_t, f), round_up(dep_b, f)
    ho = sout_l.halo
    can_split = a + b < h_loc
    cuts = [0, (ho + a) // f if a else 0,
            (ho + h_loc - b) // f if b else so.rows, so.rows]

    def run_row(shards, line):
        xs_all = dict(zip(line.mine, (s[:n_in] for s in shards)))
        sums = dict(zip(line.mine, (s[n_in] if has_sum else None
                                    for s in shards)))
        last = len(line.devices) - 1
        ops_ = {}
        # 1. every halo exchange in flight first: the last dep_t image
        #    rows go down a shard, the first dep_b image rows up a shard
        tops = [ppermute([x[k][:, (halo + h_loc - dep_t) * iwp:
                               (halo + h_loc) * iwp]
                          for x in xs_all.values()], line,
                         [(i, i + 1) for i in range(last)], tag=2 * k)
                for k in range(n_in)]
        bots = [ppermute([x[k][:, halo * iwp:(halo + dep_b) * iwp]
                          for x in xs_all.values()], line,
                         [(i + 1, i) for i in range(last)], tag=2 * k + 1)
                for k in range(n_in)]

        def call(j, arrs, rows, row0_off=0):
            dev = line.devices[j]
            if dev not in ops_:
                ops_[dev] = _on(local, dev)
            lop = ops_[dev]
            src = arrs[0] if n_in == 1 else arrs
            if has_sum:
                return lop(src, sums[j], rows=rows, row0_off=row0_off)
            kw = {}
            if is_pair:
                ph_b = local.cfg_b.ph
                kw["mid_bounds"] = (-ph_b if j > 0 else 0,
                                    h_loc + (ph_b if j < last else 0))
            return lop(src, rows=rows, row0_off=row0_off, **kw)

        # 2. interior rows on the arrays before the exchange
        mids = {j: call(j, list(xs), (cuts[1], cuts[2]))
                for j, xs in xs_all.items()} if can_split else {}
        tops = [dict(zip(line.mine, w())) for w in tops]
        bots = [dict(zip(line.mine, w())) for w in bots]

        def landed(j, k, lo, hi):
            """Input k's rows [lo, hi) of shard j's exchanged array: the
            halo band rows from the neighbours (-128 at the outer edges),
            the image rows from the shard's own array."""
            x = xs_all[j][k]
            parts = []
            if lo < halo:
                top = tops[k][j] if j > 0 else x.new_full(
                    (x.shape[0], dep_t * iwp, x.shape[2]), -128)
                parts.append(top[:, (lo - halo + dep_t) * iwp:])
            parts.append(x[:, max(lo, halo) * iwp:
                           min(hi, halo + h_loc) * iwp])
            if hi > halo + h_loc:
                bot = bots[k][j] if j < last else x.new_full(
                    (x.shape[0], dep_b * iwp, x.shape[2]), -128)
                parts.append(bot[:, :(hi - halo - h_loc) * iwp])
            return torch.cat(parts, dim=1)

        outs = []
        for j in xs_all:
            if not can_split:
                lo, hi = halo - dep_t, halo + h_loc + dep_b
                outs.append(call(j, [landed(j, k, lo, hi)
                                     for k in range(n_in)],
                                 (0, so.rows), lo))
                continue
            parts = [mids[j]]
            # 3. the boundary ranges on slices of the exchanged rows
            if a:
                lo, hi = halo - dep_t, halo + min(a + dep_b, h_loc)
                parts.insert(0, call(j, [landed(j, k, lo, hi)
                                         for k in range(n_in)],
                                     (0, cuts[1]), lo))
            if b:
                lo, hi = halo + h_loc - b - dep_t, halo + h_loc + dep_b
                parts.append(call(j, [landed(j, k, lo, hi)
                                      for k in range(n_in)],
                                  (cuts[2], so.rows), lo))
            # 4. stitch the ranges
            outs.append(torch.cat(parts, dim=1))
        return outs

    cfg = local.cfg_a if is_pair else local.cfg
    run = _sp_wrapper(mesh, axis, dp_axis, cfg.bs, run_row, n_in, has_sum)
    run.local_spec, run.local_specs = sin_l, sins_l
    run.local_out_spec, run.n_shards = so, n_shard
    return run
