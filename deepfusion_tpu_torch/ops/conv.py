"""INT8 conv(+ReLU)(+deep-fused conv1x1+ReLU): ``ConvOp`` and ``conv()``.

The PyTorch counterpart of ``deepfusion_tpu/ops/conv.py``. A ``ConvOp`` packs
its weights once (``ops/layout.py``) and holds them as buffers on its device
(by default the current CUDA device, ``utils/device.py``), with the K-major
copies the kernel's TMA reads derived from them. Calling it on a CUDA tensor
launches ``conv_fused_kernel`` (``csrc/conv.cu``, wgmma on TMA tiles); on a
CPU tensor it runs ``conv_plain``, the plain PyTorch version of the same
function, which reads the same packed buffers. Nothing else selects the path.

Stride and padding are handled in the kernel's addressing (TMA's zero fill
and element strides; the wrapper gathers strides above 8 away). A conv over
fewer than 16 channels with a kernel wider than 1 runs as a kh x 1 conv over
its input's column taps folded into the channels (``unfold_cols``). The
eltwise-sum post-op (``sum_src``, NHWC at the output's shape) joins the
final stage's epilogue, fused or not. The source is u8, or s8 (a linear
bottleneck's output, which an unfused conv into u8 reads on the card:
``conv_fused_s8src_kernel``, the mode ``conv_fused.s8_src``). Zero padding
is 0 in either domain. ``conv_fused_acc1`` stops the fused
conv at its 1x1 product and returns the raw s32 accumulator, the
tensor-parallel local step (``parallel/shard.py``). ``conv_plan`` reports
the kernel's tiling for a call without launching it.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .. import _build
from ..config import ConvConfig, replace_geometry
from ..types import dtype, round_mode
from ..utils.device import as_tensor, default_device
from ..utils.logger import check, check_eq
from ..utils.mathutil import conv_output_size, round_up
from ..utils.persist import dump_config, load_config
from . import layout
from .requant import requant, requant_to_u8, sum_term

_ACC1 = 0  # the dst code of the raw 1x1 accumulator (csrc/conv.h DT_ACC)
_MAX_STRIDE = 8   # TMA's element stride: larger strides are gathered away


def _operand_shapes(cfg: ConvConfig) -> dict:
    oc0p = layout.conv_ocp(cfg.oc)
    shapes = {"w0": (cfg.kh * cfg.kw, layout.conv_icp(cfg.ic) // 4, oc0p),
              "bias0": (oc0p,), "scale0": (oc0p,)}
    if cfg.fuse_conv1x1:
        oc1p = layout.conv_ocp(cfg.oc1x1)
        shapes.update(w1=(layout.fused_k(oc0p) // 4, oc1p), bias1=(oc1p,),
                      scale1=(oc1p,))
    return shapes


def conv_acc(src: torch.Tensor, wei_oihw: torch.Tensor, stride,
             padding) -> torch.Tensor:
    """Exact u8 (or s8) x s8 -> s32 convolution accumulator, NHWC in and
    out, zero padded.

    Accumulates tap by tap in float64: every product and partial sum is an
    integer below 2^53 (|acc| <= 255 * 128 * kh * kw * ic), so the sum is
    exact whatever the order of the matrix product."""
    n, ih, iw, ic = src.shape
    oc, _, kh, kw = wei_oihw.shape
    (sh, sw), (ph, pw) = stride, padding
    oh = conv_output_size(ih, kh, sh, ph)
    ow = conv_output_size(iw, kw, sw, pw)
    x = F.pad(src.to(torch.float64), (0, 0, pw, pw, ph, ph))
    w = wei_oihw.to(torch.float64)
    acc = torch.zeros((n, oh, ow, oc), dtype=torch.float64,
                      device=src.device)
    for ki in range(kh):
        for kj in range(kw):
            patch = x[:, ki:ki + (oh - 1) * sh + 1:sh,
                      kj:kj + (ow - 1) * sw + 1:sw, :]
            acc += patch @ w[:, :, ki, kj].T
    return acc.to(torch.int32)


class ConvOp(nn.Module):
    """Pre-packed, pre-configured conv op (the analogue of constructing
    ``op_conv`` once and calling ``submit()`` per batch,
    ``src/op_conv.h:34-96``)."""

    def __init__(self, cfg: ConvConfig, wei, bia=None, wei1x1=None,
                 bia1x1=None, device=None):
        super().__init__()
        check_eq(tuple(np.shape(wei)), (cfg.oc, cfg.ic, cfg.kh, cfg.kw),
                 "conv weight shape (OIHW)")
        oc0p = layout.conv_ocp(cfg.oc)
        ops = {"w0": layout.pack_conv_weights(wei, layout.conv_icp(cfg.ic),
                                              oc0p),
               "bias0": layout.widen_bias(bia, oc0p),
               "scale0": layout.widen_scales(cfg.conv0_scales, cfg.oc, oc0p)}
        if cfg.fuse_conv1x1:
            check_eq(tuple(np.shape(wei1x1)), (cfg.oc1x1, cfg.oc, 1, 1),
                     "conv1x1 weight shape (OIHW)")
            oc1p = layout.conv_ocp(cfg.oc1x1)
            ops.update(
                w1=layout.pack_1x1_weights(wei1x1, layout.fused_k(oc0p),
                                           oc1p),
                bias1=layout.widen_bias(bia1x1, oc1p),
                scale1=layout.widen_scales(cfg.conv1_scales, cfg.oc1x1, oc1p))
        self._set_operands(cfg, ops, device)

    def _set_operands(self, cfg: ConvConfig, ops: dict, device):
        self.cfg = cfg
        device = default_device(device)
        for k, shape in _operand_shapes(cfg).items():
            check_eq(tuple(ops[k].shape), shape, f"packed operand {k}")
            t = ops[k]
            self.register_buffer(k, t if isinstance(t, torch.Tensor) else
                                 torch.as_tensor(np.asarray(t),
                                                 device=device))
        # the kernel's B operands (ops/layout.py), derived from the words:
        # not operands, so save/load and with_geometry keep their format;
        # non-persistent buffers, so .to() moves them with the words
        self._unfold = unfold_cols(cfg)
        self.register_buffer("w0k", layout.unfolded_kmajor_weights(
            self.w0, cfg.kh, cfg.kw, cfg.ic) if self._unfold else
            layout.dense_kmajor_weights(self.w0, cfg.kh, cfg.kw),
            persistent=False)
        self.register_buffer("w1k", layout.dense_kmajor_weights(
            self.w1, 1, 1) if cfg.fuse_conv1x1 else None, persistent=False)
        self._wmaps = None   # (device pointers, their encoded tensor maps)
        self._geo = conv_geo(cfg)
        self._sum_tile = tiled_sum(cfg)
        self._int_requant = int_requant(cfg)

    def with_geometry(self, **kw) -> "ConvOp":
        """The op at another geometry (``replace_geometry``: image and
        output sizes, padding, batch) on the same operand buffers; the
        weights' layout does not depend on it. The spatially sharded
        wrapper runs its row slabs through these."""
        op = ConvOp.__new__(ConvOp)
        nn.Module.__init__(op)
        op._set_operands(replace_geometry(self.cfg, **kw),
                         {k: getattr(self, k)
                          for k in _operand_shapes(self.cfg)}, self.device)
        return op

    @property
    def device(self) -> torch.device:
        return self.w0.device

    def forward(self, src: torch.Tensor, sum_src=None) -> torch.Tensor:
        cfg = self.cfg
        check_eq(src.dtype, cfg.src_dt.torch, "conv src dtype")
        check_eq(tuple(src.shape[1:]), (cfg.ih, cfg.iw, cfg.ic),
                 "conv src shape (NHWC, any batch)")
        check_eq(src.device, self.device, "conv src device")
        sum_src = check_sum_src(cfg, src, sum_src)
        if src.device.type == "cpu":
            return conv_plain(self, src, sum_src)
        return conv_cuda(self, src, sum_src)

    def save(self, path: str):
        """Save the packed operands and the config to an .npz archive."""
        arrs = {k: getattr(self, k).cpu().numpy()
                for k in _operand_shapes(self.cfg)}
        np.savez(path, __cfg__=dump_config(self.cfg), **arrs)

    @classmethod
    def load(cls, path: str, device=None) -> "ConvOp":
        with np.load(path, allow_pickle=False) as data:
            cfg = load_config(data["__cfg__"], ConvConfig)
            ops = {k: data[k] for k in _operand_shapes(cfg)}
        op = cls.__new__(cls)
        nn.Module.__init__(op)
        op._set_operands(cfg, ops, device)
        return op


def check_sum_src(cfg: ConvConfig, src: torch.Tensor, sum_src):
    """The sum operand as a tensor on src's device, checked against cfg:
    given exactly when cfg has the post-op, NHWC (n, oh, ow, out_oc) of
    cfg.sum_dt."""
    if cfg.with_sum and sum_src is None:
        raise ValueError("config has a sum post-op; pass sum_src")
    check(cfg.with_sum or sum_src is None,
          "config has no sum post-op; sum_src must be None")
    if sum_src is None:
        return None
    sum_src = torch.as_tensor(sum_src)
    check_eq(sum_src.dtype, cfg.sum_dt.torch, "sum operand dtype")
    check_eq(tuple(sum_src.shape),
             (src.shape[0], cfg.oh, cfg.ow, cfg.out_oc),
             "sum operand shape (NHWC, the output's)")
    check_eq(sum_src.device, src.device, "sum operand device")
    return sum_src


def conv_fused_acc1(op: ConvOp, src: torch.Tensor) -> torch.Tensor:
    """The fused conv's raw s32 1x1 accumulator, NHWC (n, oh, ow, oc1x1):
    the u8 intermediate times w1, with no bias, scale or requant (the JAX
    package's ``conv_fused_acc1``, which returns ``oc1x1p`` lanes, the
    extra ones zero). Partial sums over slices of the intermediate's
    channels add up to the whole op's accumulator."""
    cfg = op.cfg
    check(cfg.fuse_conv1x1, "conv_fused_acc1 needs the fused config")
    check(not cfg.with_sum, "conv_fused_acc1 takes no sum post-op")
    check_eq(src.dtype, cfg.src_dt.torch, "conv src dtype")
    check_eq(tuple(src.shape[1:]), (cfg.ih, cfg.iw, cfg.ic),
             "conv src shape (NHWC, any batch)")
    check_eq(src.device, op.device, "conv src device")
    if src.device.type == "cpu":
        return conv_plain(op, src, emit_acc1=True)
    return conv_cuda(op, src, emit_acc1=True)


def conv_plain(op: ConvOp, src: torch.Tensor, sum_src=None,
               emit_acc1: bool = False) -> torch.Tensor:
    """The plain PyTorch version of ``conv_fused_kernel`` (with
    ``emit_acc1``, up to the 1x1 product)."""
    cfg = op.cfg
    w0 = layout.unpack_weights(op.w0, cfg.oc, cfg.ic, cfg.kh, cfg.kw)
    acc = conv_acc(src, w0, (cfg.sh, cfg.sw), (cfg.ph, cfg.pw))
    bias0 = op.bias0[:cfg.oc] if cfg.conv0_with_bias else None
    scale0 = op.scale0[:cfg.oc]
    st = None if sum_src is None else sum_term(sum_src, cfg.sum_scale)
    if not cfg.fuse_conv1x1:
        return requant(acc, bias0, scale0, cfg.conv0_relu, cfg.conv0_round,
                       cfg.dst_dt, st)
    mid = requant_to_u8(acc, bias0, scale0, cfg.conv0_round)
    w1 = layout.unpack_weights(op.w1, cfg.oc1x1, cfg.oc, 1, 1)
    acc1 = conv_acc(mid, w1, (1, 1), (0, 0))
    if emit_acc1:
        return acc1
    bias1 = op.bias1[:cfg.oc1x1] if cfg.conv1_with_bias else None
    return requant(acc1, bias1, op.scale1[:cfg.oc1x1], cfg.conv1_relu,
                   cfg.conv1_round, cfg.dst_dt, st)


def _gather_stride(x: torch.Tensor, dim: int, o: int, k: int, s: int,
                   p: int) -> torch.Tensor:
    """The input rows (dim 1) or columns (dim 2) that a stride-s conv of
    kernel k and padding p reads, o * s - p + i for output o and tap i < k,
    as rows o * k + i of a new input (zeros outside the image): a stride-k
    conv without padding reads them exactly."""
    n = x.shape[dim]
    after = max(0, (o - 1) * s - p + k - n)
    pad = [0, 0, 0, 0, 0, 0]
    pad[2 * (3 - dim)], pad[2 * (3 - dim) + 1] = p, after
    # built on x's device: no host-to-device copy, so a CUDA graph can
    # capture the call
    idx = (torch.arange(o, device=x.device)[:, None] * s
           + torch.arange(k, device=x.device)).reshape(-1)
    return F.pad(x, pad).index_select(dim, idx)


def _kernel_geometry(cfg: ConvConfig, unfold: bool) -> tuple:
    """The geometry (ih, iw, ic, kh, kw, sh, sw, ph, pw) the kernel runs:
    ic padded to 16 with zero channels (exact), strides above TMA's 8
    gathered away; with `unfold` (``unfold_cols``; ``ConvPoolOp`` never
    unfolds) a kh x 1 conv of stride (sh, 1) over (ih, ow,
    ``layout.unfold_icp(kw, ic)``), the column taps folded into the
    channels (``_kernel_src``)."""
    ih, iw, ic = cfg.ih, cfg.iw, round_up(cfg.ic, 16)
    kh, kw, sh, sw, ph, pw = cfg.kh, cfg.kw, cfg.sh, cfg.sw, cfg.ph, cfg.pw
    if sh > _MAX_STRIDE:
        check(cfg.kh <= _MAX_STRIDE, "stride and kernel height both above 8")
        ih, sh, ph = cfg.oh * cfg.kh, cfg.kh, 0
    if unfold:
        iw, ic, kw, sw, pw = cfg.ow, layout.unfold_icp(cfg.kw, cfg.ic), 1, 1, 0
    elif sw > _MAX_STRIDE:
        check(cfg.kw <= _MAX_STRIDE, "stride and kernel width both above 8")
        iw, sw, pw = cfg.ow * cfg.kw, cfg.kw, 0
    return ih, iw, ic, kh, kw, sh, sw, ph, pw


def _kernel_src(cfg: ConvConfig, src: torch.Tensor,
                unfold: bool) -> torch.Tensor:
    """The input of ``_kernel_geometry``: ic padded to 16 with zero
    channels, strides above 8 gathered (``_gather_stride``); with `unfold`
    the column taps folded into the channels (``unfold_cols_cuda`` on the
    card, ``unfold_cols_plain`` on the CPU)."""
    if cfg.ic % 16 and not unfold:
        src = F.pad(src, (0, round_up(cfg.ic, 16) - cfg.ic))
    if cfg.sh > _MAX_STRIDE:
        src = _gather_stride(src, 1, cfg.oh, cfg.kh, cfg.sh, cfg.ph)
    if unfold:
        fn = unfold_cols_plain if src.device.type == "cpu" else \
            unfold_cols_cuda
        return fn(src, _unfold_geo(cfg))
    if cfg.sw > _MAX_STRIDE:
        src = _gather_stride(src, 2, cfg.ow, cfg.kw, cfg.sw, cfg.pw)
    return src


def _unfold_geo(cfg: ConvConfig) -> tuple:
    """The unfold's ints as ``torch.ops.deepfusion_torch.unfold_cols`` takes
    them (``csrc/ops_conv.cpp``, ``UnfoldGeo``): ow, kw, sw, pw and the
    unfolded channels."""
    return (cfg.ow, cfg.kw, cfg.sw, cfg.pw,
            layout.unfold_icp(cfg.kw, cfg.ic))


def unfold_cols_plain(src: torch.Tensor, geo) -> torch.Tensor:
    """The plain PyTorch version of ``unfold_cols_kernel``: NHWC u8 (n, ih,
    iw, ic) -> (n, ih, ow, cp), channel kj * ic + c of pixel (y, ox) the
    input's channel c at (y, ox * sw - pw + kj), 0 outside the image and
    past kw * ic."""
    ow, kw, sw, pw, cp = geo
    n, ih, _, ic = src.shape
    x = _gather_stride(src, 2, ow, kw, sw, pw).reshape(n, ih, ow, kw * ic)
    return F.pad(x, (0, cp - kw * ic))


def unfold_cols_cuda(src: torch.Tensor, geo) -> torch.Tensor:
    """Launch ``unfold_cols_kernel`` (``csrc/unfold.cu``) on the current
    stream through ``torch.ops.deepfusion_torch.unfold_cols``."""
    out = _build.op("unfold_cols")(src, geo)
    _build.count_launch("unfold_cols")
    return out


def _ocps(cfg: ConvConfig):
    return (layout.conv_ocp(cfg.oc),
            layout.conv_ocp(cfg.oc1x1) if cfg.fuse_conv1x1 else 0)


def conv_geo(cfg: ConvConfig) -> tuple:
    """The op's ints as ``torch.ops.deepfusion_torch.conv_fused`` takes
    them (``csrc/ops_conv.cpp``, ``ConvGeo``), computed once per op: the
    kernel's geometry, channels and lanes, the epilogue's flags, the dst
    and sum dtype codes."""
    oc0p, oc1p = _ocps(cfg)
    ih, iw, ic, kh, kw, sh, sw, ph, pw = _kernel_geometry(cfg,
                                                          unfold_cols(cfg))
    return (ih, iw, ic, cfg.oh, cfg.ow, kh, kw, sh, sw, ph, pw,
            cfg.oc, oc0p, cfg.oc1x1, oc1p, int(cfg.conv0_relu),
            int(cfg.conv1_relu), int(cfg.conv0_round == round_mode.down),
            int(cfg.conv1_round == round_mode.down),
            int(cfg.conv0_with_bias), int(cfg.conv1_with_bias),
            int(cfg.fuse_conv1x1), cfg.dst_dt.value,
            cfg.sum_dt.value if cfg.with_sum else 0)


def tiled_sum(cfg: ConvConfig) -> bool:
    """Whether the kernel's final stage reads the sum operand as whole tiles
    copied into shared memory, not a value at a time from device memory
    (the kernel decides it from what the call shows, ``csrc/conv.cu``:
    ``tiled_sum``; this is its host side, for the launch count): the fused
    conv with a 1-byte sum operand joined in the integer domain
    (``int_requant``) into a 1-byte dst whose pitch is a multiple of 16
    bytes. The launches that do are counted as the mode
    ``conv_fused.sum_tile``."""
    return bool(cfg.fuse_conv1x1 and cfg.with_sum and int_requant(cfg)
                and cfg.out_oc % 16 == 0)


# the largest |sum_scale| at which the kernel joins a 1-byte sum in the
# integer domain (csrc/requant.cuh: INT_SUM_SCALE_MAX)
INT_SUM_SCALE_MAX = 8192.0


def int_requant(cfg: ConvConfig) -> bool:
    """Whether the kernel's final stage requantizes in the integer domain,
    one conversion a value (``csrc/requant.cuh``: ``requant_int``; the
    kernel decides it from what the call shows, ``csrc/conv.cu``:
    ``int_sum``; this is its host side, for the launch count): a 1-byte dst
    with a 1-byte sum operand at |sum_scale| <= ``INT_SUM_SCALE_MAX`` (the
    bound of its exactness; past it the f32 path), or an s8 dst with no
    sum. A u8 dst with no sum takes ``requant_u8``, one conversion already,
    and is not counted. The launches that do are counted as the mode
    ``conv_fused.int_requant``."""
    if cfg.dst_dt.size != 1:
        return False
    if not cfg.with_sum:
        return cfg.dst_dt == dtype.s8
    return bool(cfg.sum_dt.size == 1 and
                abs(np.float32(cfg.sum_scale)) <= INT_SUM_SCALE_MAX)


def unfold_cols(cfg: ConvConfig) -> bool:
    """Whether ``ConvOp`` runs the conv over its input's column taps folded
    into the channels (``_kernel_geometry``, ``_kernel_src``, the weights
    ``layout.unfolded_kmajor_weights``): an input of fewer than 16 channels
    under a kernel wider than 1, where every tap would otherwise take a
    32-byte k-step of mostly zero channels (ResNet-50's 7x7 stem over 3
    channels: 7 k-steps, not 49). The integer sums are the same. The
    launches that do are counted as the mode ``conv_fused.unfold``."""
    return cfg.ic < 16 and cfg.kw > 1


def _weight_maps(op, pool: bool = False) -> torch.Tensor:
    """The TMA tensor maps of the op's K-major weights (a ``ConvOp``, or
    with ``pool`` a ``ConvPoolOp``, whose w0 boxes are at most 64 rows), a
    CPU uint8 tensor (6, 128) encoded once for their device pointers
    (``torch.ops.deepfusion_torch.conv_weight_maps``); a copy of the op on
    other buffers (``dp_shard``) encodes its own."""
    w1k = op.w1k
    key = (op.w0k.data_ptr(), None if w1k is None else w1k.data_ptr())
    if op._wmaps is None or op._wmaps[0] != key:
        op._wmaps = (key, _build.op("conv_weight_maps")(op.w0k, w1k, pool))
    return op._wmaps[1]


def conv_plan(op, n: int, emit_acc1: bool = False,
              pool: bool = False) -> dict:
    """The conv kernel's plan for a call at batch n, without launching
    (``torch.ops.deepfusion_torch.conv_plan``, the launcher's own
    planning): rows of M per tile (128, or 64 with each consumer warpgroup
    on half the lanes: split), the tile's output rows x columns, the tiles,
    the blocks (at most one per SM of the H100's 132, each walking its
    share of the work items: a tile with all its passes, in pool mode a
    pass of a tile), ring stages, shared bytes, lanes per pass and passes
    of each stage, K chunks and bytes per tap, whether the 1x1 runs as a
    GEMM over the flattened pixels, and the work items. ``pool``: the plan
    of the pool mode (``ConvPoolOp``)."""
    cfg = op.cfg
    ih, iw, ic, kh, kw, sh, sw, ph, pw = _kernel_geometry(
        cfg, not pool and unfold_cols(cfg))
    vals = [n, ih, iw, ic, cfg.oh, cfg.ow, kh, kw, sh, sw, ph, pw,
            *_ocps(cfg), int(cfg.fuse_conv1x1),
            _ACC1 if emit_acc1 else cfg.dst_dt.value, int(pool)]
    keys = ("tile_m", "tile_rows", "tile_cols", "split", "tiles", "blocks",
            "stages", "smem_bytes", "nb0", "nb1", "passes0", "passes1",
            "chunks_per_tap", "k_per_tap", "gemm", "items")
    return dict(zip(keys, _build.op("conv_plan")(vals)))


def conv_cuda(op: ConvOp, src: torch.Tensor, sum_src=None,
              emit_acc1: bool = False) -> torch.Tensor:
    """Launch ``conv_fused_kernel`` on the current stream (with
    ``emit_acc1``, its raw 1x1 accumulator store; with an s8 source
    ``conv_fused_s8src_kernel``) through
    ``torch.ops.deepfusion_torch.conv_fused``, which checks the arguments,
    aligns the inputs, allocates the output and launches in C++."""
    cfg = op.cfg
    fuse = cfg.fuse_conv1x1
    s8 = cfg.src_dt == dtype.s8
    out = _build.op("conv_fused")(
        _kernel_src(cfg, src, op._unfold), _weight_maps(op), op.bias0,
        op.scale0, op.bias1 if fuse else None, op.scale1 if fuse else None,
        sum_src, op._geo, cfg.sum_scale, emit_acc1)
    modes = ("acc1",) if emit_acc1 else (
        ("sum_tile",) * op._sum_tile + ("int_requant",) * op._int_requant
        + ("s8_src",) * s8)
    _build.count_launch("conv_fused", *modes,
                        *(("unfold",) if op._unfold else ()))
    return out


def conv(src, wei, bia=None, stride=(1, 1), padding=(0, 0), *,
         dst_dtype, conv0_relu=False, conv0_scales=(1.0,),
         conv0_round_mode=round_mode.nearest,
         wei1x1=None, bia1x1=None, conv1_relu=False, conv1_scales=(1.0,),
         conv1_round_mode=round_mode.nearest, groups=1,
         sum_src=None, sum_scale=1.0, device=None):
    """Functional conv3x3(+relu)(+conv1x1+relu), NHWC u8 (or s8) in.

    API parity with ``deepfusion::conv`` (``include/deepfusion.h:120-145``)
    and with the JAX package's ``conv()``. ``src`` is a tensor (the op runs
    on its device) or a numpy array, which goes to ``device``: by default
    the current CUDA device, ``"cpu"`` for the plain PyTorch version. The
    weights and biases are numpy arrays or CPU tensors.
    """
    src = as_tensor(src, device)
    wei = np.asarray(wei)
    n, ih, iw, ic = src.shape
    oc, _, kh, kw = wei.shape
    oh = conv_output_size(ih, kh, stride[0], padding[0])
    ow = conv_output_size(iw, kw, stride[1], padding[1])
    out_oc = np.shape(wei1x1)[0] if wei1x1 is not None else oc
    cfg = ConvConfig.make(
        (n, ih, iw, ic), tuple(wei.shape),
        None if bia is None else np.asarray(bia).dtype,
        stride, padding, (n, oh, ow, out_oc), dst_dtype,
        conv0_relu=conv0_relu, conv0_scales=conv0_scales,
        conv0_round=conv0_round_mode,
        wei1x1_shape=None if wei1x1 is None else tuple(np.shape(wei1x1)),
        bia1x1_dt=None if bia1x1 is None else np.asarray(bia1x1).dtype,
        conv1_relu=conv1_relu, conv1_scales=conv1_scales,
        conv1_round=conv1_round_mode, groups=groups, src_dt=src.dtype,
        sum_dt=None if sum_src is None else torch.as_tensor(sum_src).dtype,
        sum_scale=sum_scale)
    op = ConvOp(cfg, wei, bia, wei1x1, bia1x1, device=src.device)
    return op(src, sum_src=None if sum_src is None
              else torch.as_tensor(sum_src, device=src.device))
