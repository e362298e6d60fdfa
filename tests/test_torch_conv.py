"""Conv of the PyTorch port vs the JAX package, bitwise (CPU).

The port's ``conv()`` (its plain PyTorch version, which reads the weights
back from the kernel's packed layout) against ``deepfusion_tpu.ops.conv.conv``
in Pallas interpret mode: 3x3 and 1x1, fused and unfused, all dst types,
both round modes, every bias type, scalar and per-channel scales, on
full-range u8 inputs and s8 weights (-128..127). Tolerance: bitwise.

Also what the CUDA kernel's wrapper prepares on the CPU: the K-major
weights its TMA reads (``layout.dense_kmajor_weights``) against the JAX
package's packed weights and the port's own unpacking, with their zero
padding; the gather that takes strides above TMA's 8 away; the column
taps of a narrow input folded into its channels (``unfold_cols``); and the
device rule (``utils/device.py``): without CUDA, no device means an error,
never the CPU.
"""
import numpy as np
import pytest
import torch

from deepfusion_tpu.ops.conv import conv as jconv
from deepfusion_tpu_torch.config import ConvConfig
from deepfusion_tpu_torch.ops import layout
from deepfusion_tpu_torch.ops.conv import ConvOp
from deepfusion_tpu_torch.ops.conv import conv as tconv
from deepfusion_tpu_torch.utils.logger import CheckError
from deepfusion_tpu_torch.utils.mathutil import conv_output_size

torch.set_num_threads(2)

# (k, stride, pad, ic, oc, oc1x1, dst, round0, round1, bias, per_oc)
CASES = {
    "3x3-u8-rne-s32bias-peroc": (3, 1, 1, 16, 32, None, "u8", "nearest",
                                 "nearest", "s32", True),
    "3x3-s8-floor-s8bias-scalar": (3, 1, 1, 16, 24, None, "s8", "down",
                                   "nearest", "s8", False),
    "3x3-s32-rne-nobias": (3, 1, 1, 8, 16, None, "s32", "nearest",
                           "nearest", None, True),
    "3x3-f32-f32bias": (3, 1, 1, 16, 16, None, "f32", "nearest", "nearest",
                        "f32", True),
    "1x1-u8-floor-u8bias": (1, 1, 0, 32, 16, None, "u8", "down", "nearest",
                            "u8", True),
    "1x1-s8-rne-f32bias-scalar": (1, 1, 0, 24, 40, None, "s8", "nearest",
                                  "nearest", "f32", False),
    "fused-u8-rne": (3, 1, 1, 16, 32, 16, "u8", "nearest", "nearest",
                     "s32", True),
    "fused-s8-floor-floor": (3, 1, 1, 16, 16, 24, "s8", "down", "down",
                             "s8", True),
    "fused-s32-nobias-scalar": (3, 1, 1, 8, 32, 8, "s32", "nearest", "down",
                                None, False),
    "fused-f32-u8bias": (3, 1, 1, 16, 16, 16, "f32", "down", "nearest",
                         "u8", True),
    "3x3-stride2-odd-ic": (3, 2, 1, 3, 16, None, "u8", "nearest", "nearest",
                           "s32", True),
    "5x5-pad2-s8": (5, 1, 2, 4, 8, None, "s8", "nearest", "nearest", "s32",
                    True),
}


def _bias(rng, kind, n):
    if kind is None:
        return None
    if kind == "f32":
        return (rng.standard_normal(n) * 300).astype(np.float32)
    lo, hi = {"u8": (0, 256), "s8": (-128, 128),
              "s32": (-20000, 20000)}[kind]
    return rng.integers(lo, hi, n).astype({"u8": np.uint8, "s8": np.int8,
                                           "s32": np.int32}[kind])


def _case(name):
    k, s, p, ic, oc, oc1, dst, r0, r1, bias, per_oc = CASES[name]
    rng = np.random.default_rng(sorted(CASES).index(name))
    n, hw = 2, 7
    src = rng.integers(0, 256, (n, hw, hw, ic), dtype=np.uint8)
    wei = rng.integers(-128, 128, (oc, ic, k, k)).astype(np.int8)
    # scales that keep most outputs inside the u8/s8 range, some saturating
    sc = 1.0 / (k * k * ic * 40)
    kw = dict(dst_dtype=dst, conv0_relu=dst != "s8", conv0_round_mode=r0,
              conv0_scales=(rng.uniform(0.5, 1.5, oc) * sc).astype(np.float32)
              if per_oc else (sc,))
    bia = _bias(rng, bias, oc)
    if oc1 is not None:
        kw.update(wei1x1=rng.integers(-128, 128, (oc1, oc, 1, 1)
                                      ).astype(np.int8),
                  bia1x1=_bias(rng, bias, oc1), conv1_relu=dst == "u8",
                  conv1_round_mode=r1,
                  conv1_scales=(rng.uniform(0.5, 1.5, oc1) / (oc * 40)
                                ).astype(np.float32)
                  if per_oc else (1.0 / (oc * 40),))
    return src, wei, bia, (s, s), (p, p), kw


@pytest.mark.parametrize("name", sorted(CASES))
def test_conv_matches_jax(name):
    src, wei, bia, stride, pad, kw = _case(name)
    want = np.asarray(jconv(src, wei, bia, stride, pad, **kw))
    got = tconv(src, wei, bia, stride, pad, **kw, device="cpu").numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_conv_torch_input_and_numpy_input_agree():
    src, wei, bia, stride, pad, kw = _case("fused-u8-rne")
    a = tconv(src, wei, bia, stride, pad, **kw, device="cpu")
    b = tconv(torch.from_numpy(src), wei, bia, stride, pad, **kw, device="cpu")
    assert torch.equal(a, b)


@pytest.mark.parametrize("kh,kw,ic,oc", [(3, 3, 5, 9), (1, 1, 64, 16),
                                         (5, 3, 33, 8)])
def test_weight_pack_roundtrip(kh, kw, ic, oc):
    rng = np.random.default_rng(0)
    w = rng.integers(-128, 128, (oc, ic, kh, kw)).astype(np.int8)
    words = layout.pack_conv_weights(w, layout.conv_icp(ic),
                                     layout.conv_ocp(oc))
    assert words.dtype == np.int32
    assert words.shape == (kh * kw, layout.conv_icp(ic) // 4,
                           layout.conv_ocp(oc))
    back = layout.unpack_weights(torch.from_numpy(words), oc, ic, kh, kw)
    np.testing.assert_array_equal(back.numpy(), w)
    # byte b of word [t, k, o] is w[o, 4k + b, t // kw, t % kw]
    t = kh * kw - 1
    assert (words[t, 1, 2] & 0xFF) == (int(w[2, 4, kh - 1, kw - 1]) & 0xFF)
    assert (words[t, 0, 2] >> 8 & 0xFF) == \
        (int(w[2, 1, kh - 1, kw - 1]) & 0xFF)


def test_save_load_roundtrip(tmp_path):
    src, wei, bia, stride, pad, kw = _case("fused-s8-floor-floor")
    n, ih, iw, ic = src.shape
    oc = wei.shape[0]
    oc1 = kw["wei1x1"].shape[0]
    o = conv_output_size(ih, 3, 1, 1)
    cfg = ConvConfig.make(
        (n, ih, iw, ic), wei.shape, bia.dtype, stride, pad, (n, o, o, oc1),
        "s8", conv0_relu=True, conv0_scales=kw["conv0_scales"],
        conv0_round="down", wei1x1_shape=kw["wei1x1"].shape,
        bia1x1_dt=kw["bia1x1"].dtype, conv1_scales=kw["conv1_scales"],
        conv1_round="down")
    op = ConvOp(cfg, wei, bia, kw["wei1x1"], kw["bia1x1"], device="cpu")
    path = str(tmp_path / "op.npz")
    op.save(path)
    op2 = ConvOp.load(path, device="cpu")
    assert op2.cfg == op.cfg
    x = torch.from_numpy(src)
    assert torch.equal(op(x), op2(x))
    assert oc == op2.cfg.oc


def test_rejects_bad_geometry_like_jax():
    with pytest.raises(CheckError, match="output h size mismatch"):
        ConvConfig.make((1, 8, 8, 4), (8, 4, 3, 3), None, (1, 1), (1, 1),
                        (1, 7, 8, 8), "u8")
    with pytest.raises(CheckError, match="input channels must match"):
        ConvConfig.make((1, 8, 8, 4), (8, 5, 3, 3), None, (1, 1), (1, 1),
                        (1, 8, 8, 8), "u8")
    with pytest.raises(CheckError, match="scales length"):
        ConvConfig.make((1, 8, 8, 4), (8, 4, 3, 3), None, (1, 1), (1, 1),
                        (1, 8, 8, 8), "u8", conv0_scales=(1.0, 2.0))


def test_op_rejects_wrong_input():
    src, wei, bia, stride, pad, kw = _case("3x3-s32-rne-nobias")
    n, ih, iw, ic = src.shape
    cfg = ConvConfig.make((n, ih, iw, ic), wei.shape, None, stride, pad,
                          (n, ih, iw, wei.shape[0]), "s32")
    op = ConvOp(cfg, wei, device="cpu")
    with pytest.raises(CheckError):
        op(torch.from_numpy(src).to(torch.int32))
    with pytest.raises(CheckError):
        op(torch.from_numpy(src[:, :5]))


# --------------------------------- K1b's raw 1x1 accumulator (emit_acc1)

@pytest.mark.parametrize("name", ["fused-u8-rne", "fused-s8-floor-floor",
                                  "fused-s32-nobias-scalar"])
def test_conv_fused_acc1_matches_jax(name):
    """conv_fused_acc1: the raw s32 1x1 accumulator, against the JAX
    package's on its first oc1x1 lanes (JAX pads to oc1x1p; its u8 shift
    correction is folded in, the port multiplies u8 by s8 directly)."""
    from deepfusion_tpu.config import ConvConfig as JConvConfig
    from deepfusion_tpu.ops.conv import ConvOp as JConvOp
    from deepfusion_tpu.ops.conv import conv_fused_acc1 as jacc1
    from deepfusion_tpu_torch.ops.conv import conv_fused_acc1
    src, wei, bia, stride, pad, kw = _case(name)
    n, hw, _, ic = src.shape
    oc, oc1 = wei.shape[0], kw["wei1x1"].shape[0]
    args = ((n, hw, hw, ic), wei.shape, None if bia is None else bia.dtype,
            stride, pad, (n, hw, hw, oc1), kw["dst_dtype"])
    ckw = dict(conv0_relu=kw["conv0_relu"], conv0_scales=kw["conv0_scales"],
               conv0_round=kw["conv0_round_mode"],
               wei1x1_shape=kw["wei1x1"].shape,
               bia1x1_dt=None if kw["bia1x1"] is None
               else kw["bia1x1"].dtype, conv1_scales=kw["conv1_scales"])
    jop = JConvOp(JConvConfig.make(*args, **ckw), wei, bia, kw["wei1x1"],
                  kw["bia1x1"])
    want = np.asarray(jacc1(jop.cfg, src, *jop._operands[:6]))
    op = ConvOp(ConvConfig.make(*args, **ckw), wei, bia, kw["wei1x1"],
                kw["bia1x1"], device="cpu")
    got = conv_fused_acc1(op, torch.from_numpy(src)).numpy()
    assert got.dtype == np.int32 and got.shape == (n, hw, hw, oc1)
    np.testing.assert_array_equal(got, want[..., :oc1])
    assert oc % 2 == 0
    # partial accumulators over halves of the 3x3's channels add up
    halves = []
    for sl in (slice(0, oc // 2), slice(oc // 2, oc)):
        sc = kw["conv0_scales"]
        c = ConvConfig.make(*((n, hw, hw, ic), (oc // 2,) + wei.shape[1:],
                              *args[2:]),
                            **{**ckw, "conv0_scales": sc[sl] if len(sc) > 1
                               else sc,
                               "wei1x1_shape": (oc1, oc // 2, 1, 1)})
        h = ConvOp(c, wei[sl], None if bia is None else bia[sl],
                   kw["wei1x1"][:, sl], device="cpu")
        halves.append(conv_fused_acc1(h, torch.from_numpy(src)))
    np.testing.assert_array_equal((halves[0] + halves[1]).numpy(), got)


def test_conv_fused_acc1_refuses_unfused():
    from deepfusion_tpu_torch.ops.conv import conv_fused_acc1
    src, wei, bia, stride, pad, kw = _case("3x3-u8-rne-s32bias-peroc")
    n, hw, _, ic = src.shape
    cfg = ConvConfig.make((n, hw, hw, ic), wei.shape, bia.dtype, stride,
                          pad, (n, hw, hw, wei.shape[0]), "u8")
    with pytest.raises(CheckError, match="needs the fused config"):
        conv_fused_acc1(ConvOp(cfg, wei, bia, device="cpu"),
                        torch.from_numpy(src))


# ----------------------------- what the CUDA kernel's wrapper prepares

@pytest.mark.parametrize("kh,kw,ic,oc", [(3, 3, 32, 128), (3, 3, 3, 20),
                                         (1, 1, 256, 256), (5, 5, 48, 136),
                                         (3, 3, 16, 8), (1, 1, 128, 1040)])
def test_dense_kmajor_weights_match_jax(kh, kw, ic, oc):
    """K1's B operand: row o holds output channel o's weights, K tap by
    tap (ki, kj), each tap's icp channels; equal to the JAX package's
    packed weights ((kw, kh, ic) rows) reordered, to the port's own
    unpacking, and zero past ic and oc."""
    import deepfusion_tpu.ops.layout as JL
    rng = np.random.default_rng(kh * 1000 + ic + oc)
    w = rng.integers(-128, 128, (oc, ic, kh, kw)).astype(np.int8)
    icp, ocp = layout.conv_icp(ic), layout.conv_ocp(oc)
    words = torch.from_numpy(layout.pack_conv_weights(w, icp, ocp))
    got = layout.dense_kmajor_weights(words, kh, kw)
    assert got.dtype == torch.int8 and got.shape == (ocp, kh * kw * icp)
    want = JL.pack_conv_weights(w, icp, ocp).reshape(kw, kh, icp, ocp)
    want = want.transpose(3, 1, 0, 2).reshape(ocp, kh * kw * icp)
    np.testing.assert_array_equal(got.numpy(), want)
    taps = got.reshape(ocp, kh, kw, icp)
    unpacked = layout.unpack_weights(words, oc, ic, kh, kw)
    assert torch.equal(taps[:oc, :, :, :ic], unpacked.permute(0, 2, 3, 1))
    assert not taps[:, :, :, ic:].any() and not taps[oc:].any()


@pytest.mark.parametrize("oc0,oc1", [(128, 128), (256, 128), (20, 40),
                                     (1032, 40), (8, 72)])
def test_dense_kmajor_1x1_weights_match_jax(oc0, oc1):
    """The fused 1x1's B operand: (oc1p, k1), K the intermediate's k1 =
    oc0p rounded up to 32 lanes, zero in [oc0, k1) and past oc1."""
    import deepfusion_tpu.ops.layout as JL
    rng = np.random.default_rng(oc0 + oc1)
    w1 = rng.integers(-128, 128, (oc1, oc0, 1, 1)).astype(np.int8)
    k1 = layout.fused_k(layout.conv_ocp(oc0))
    oc1p = layout.conv_ocp(oc1)
    words = torch.from_numpy(layout.pack_1x1_weights(w1, k1, oc1p))
    got = layout.dense_kmajor_weights(words, 1, 1)
    assert got.dtype == torch.int8 and got.shape == (oc1p, k1)
    np.testing.assert_array_equal(got.numpy(),
                                  JL.pack_1x1_weights(w1, k1, oc1p).T)
    unpacked = layout.unpack_weights(words, oc1, oc0, 1, 1)
    assert torch.equal(got[:oc1, :oc0], unpacked[:, :, 0, 0])
    assert not got[:, oc0:].any() and not got[oc1:].any()


@pytest.mark.parametrize("k,s,p,hw", [(1, 9, 0, 20), (3, 10, 1, 23),
                                      (5, 12, 2, 30), ((3, 1), (9, 2),
                                                       (1, 0), 19)])
def test_strides_above_eight_are_gathered_exactly(k, s, p, hw):
    """TMA steps at most 8 elements: for a larger stride the wrapper
    gathers the rows (columns) each output reads, and a stride-k conv
    without padding over them gives the same accumulator."""
    from deepfusion_tpu_torch.ops.conv import (_kernel_geometry, _kernel_src,
                                               conv_acc, unfold_cols)
    kh, kw = (k, k) if isinstance(k, int) else k
    sh, sw = (s, s) if isinstance(s, int) else s
    ph, pw = (p, p) if isinstance(p, int) else p
    rng = np.random.default_rng(kh + sh + hw)
    ic, oc, n = 20, 8, 2
    oh, ow = (conv_output_size(hw, kh, sh, ph),
              conv_output_size(hw, kw, sw, pw))
    w = rng.integers(-128, 128, (oc, ic, kh, kw)).astype(np.int8)
    cfg = ConvConfig.make((n, hw, hw, ic), w.shape, None, (sh, sw),
                          (ph, pw), (n, oh, ow, oc), "s32")
    x = torch.from_numpy(rng.integers(0, 256, (n, hw, hw, ic),
                                      dtype=np.uint8))
    assert not unfold_cols(cfg)
    x2 = _kernel_src(cfg, x, False)
    ih2, iw2, ic2, kh2, kw2, sh2, sw2, ph2, pw2 = _kernel_geometry(cfg, False)
    assert (kh2, kw2) == (kh, kw)
    assert max(sh2, sw2) <= 8 and ic2 % 16 == 0
    assert tuple(x2.shape) == (n, ih2, iw2, ic2)
    assert conv_output_size(ih2, kh, sh2, ph2) == oh
    assert conv_output_size(iw2, kw, sw2, pw2) == ow
    w2 = np.zeros((oc, ic2, kh, kw), np.int8)
    w2[:, :ic] = w
    got = conv_acc(x2, torch.from_numpy(w2), (sh2, sw2), (ph2, pw2))
    want = conv_acc(x, torch.from_numpy(w), (sh, sw), (ph, pw))
    assert torch.equal(got, want)


# (ic, kernel, stride, padding): ResNet-50's stem, then narrow inputs under
# kernels 3 and 5 wide at column strides 1 and 2
UNFOLD_CASES = [(3, (7, 7), (2, 2), (3, 3))] + [
    (ic, (3, kw), (2, sw), (1, kw // 2)) for ic in (1, 4, 8)
    for kw in (3, 5) for sw in (1, 2)]


@pytest.mark.parametrize("ic,k,s,p", UNFOLD_CASES)
def test_narrow_inputs_run_over_their_column_taps_folded_into_channels(
        ic, k, s, p):
    """A conv over fewer than 16 channels with a kernel wider than 1 runs
    as a kh x 1 conv of stride (sh, 1) over the input's kw column taps
    folded into round_up(kw * ic, 32) channels: the unfolded input
    (``_kernel_src``, here its plain version) at ``_kernel_geometry`` with
    the op's derived K-major weights, unpacked, gives the original conv's
    accumulator exactly; the unfold puts the input's channel c at column
    ox * sw - pw + kj into channel kj * ic + c of pixel ox, zero outside
    the image and past kw * ic; the op's ints carry that geometry."""
    from deepfusion_tpu_torch.ops.conv import (_kernel_geometry, _kernel_src,
                                               conv_acc, conv_geo,
                                               unfold_cols)
    (kh, kw), (sh, sw), (ph, pw) = k, s, p
    n, oc, hw = 2, 24, 13
    rng = np.random.default_rng(ic * 100 + kw * 10 + sw)
    oh, ow = (conv_output_size(hw, kh, sh, ph),
              conv_output_size(hw, kw, sw, pw))
    w = rng.integers(-128, 128, (oc, ic, kh, kw)).astype(np.int8)
    cfg = ConvConfig.make((n, hw, hw, ic), w.shape, None, (sh, sw),
                          (ph, pw), (n, oh, ow, oc), "s32")
    op = ConvOp(cfg, w, device="cpu")
    assert unfold_cols(cfg) and op._unfold
    xn = rng.integers(0, 256, (n, hw, hw, ic), dtype=np.uint8)
    x = torch.from_numpy(xn)
    x2 = _kernel_src(cfg, x, True)
    geo = _kernel_geometry(cfg, True)
    ih2, iw2, ic2, kh2, kw2, sh2, sw2, ph2, pw2 = geo
    cp = layout.unfold_icp(kw, ic)
    assert (ih2, iw2, ic2, kh2, kw2, sh2, sw2, ph2, pw2) == (
        hw, ow, cp, kh, 1, sh, 1, ph, 0)
    assert cp % 32 == 0 and cp - kw * ic < 32
    assert tuple(x2.shape) == (n, ih2, iw2, ic2)
    assert conv_output_size(ih2, kh2, sh2, ph2) == oh
    assert conv_output_size(iw2, kw2, sw2, pw2) == ow
    g = conv_geo(cfg)
    assert g[:3] == (ih2, iw2, ic2) and g[5:11] == (kh2, kw2, sh2, sw2,
                                                     ph2, pw2)
    want_x = np.zeros((n, hw, ow, cp), np.uint8)
    for ox in range(ow):
        for kj in range(kw):
            col = ox * sw - pw + kj
            if 0 <= col < hw:
                want_x[:, :, ox, kj * ic:(kj + 1) * ic] = xn[:, :, col]
    np.testing.assert_array_equal(x2.numpy(), want_x)
    ocp = op.w0k.shape[0]
    assert tuple(op.w0k.shape) == (ocp, kh * cp)
    w2 = op.w0k.reshape(ocp, kh2, kw2, ic2).permute(0, 3, 1, 2)[:oc]
    assert not w2[:, kw * ic:].any()
    got = conv_acc(x2, w2, (sh2, sw2), (ph2, pw2))
    want = conv_acc(x, torch.from_numpy(w), (sh, sw), (ph, pw))
    assert torch.equal(got, want)


@pytest.mark.parametrize("model", ["FusionNet", "ResFusionNet", "VGGFusion",
                                   "ResNet50"])
def test_only_resnet50s_stem_unfolds(model):
    """Of the dense convs of the four models at their default configs, the
    column taps are folded into the channels at ResNet-50's stem (3
    channels under 7x7) alone: every other conv takes 32 channels or more,
    and ``ConvPoolOp`` never unfolds."""
    from deepfusion_tpu_torch import models
    from deepfusion_tpu_torch.ops.conv import unfold_cols
    from deepfusion_tpu_torch.ops.convpool import ConvPoolOp
    net = getattr(models, model)(getattr(models, f"{model}Config")(),
                                 device="cpu")
    convs = {name: op for name, op in net.named_modules()
             if isinstance(op, (ConvOp, ConvPoolOp))}
    unfolded = [name for name, op in convs.items() if unfold_cols(op.cfg)]
    assert unfolded == (["convs.stem"] if model == "ResNet50" else [])
    assert all(op._unfold == (name in unfolded)
               for name, op in convs.items() if isinstance(op, ConvOp))


def _no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _small_conv():
    rng = np.random.default_rng(7)
    w = rng.integers(-128, 128, (16, 16, 3, 3)).astype(np.int8)
    cfg = ConvConfig.make((1, 6, 6, 16), w.shape, None, (1, 1), (1, 1),
                          (1, 6, 6, 16), "u8")
    return cfg, w


@pytest.mark.parametrize("what", ["ConvOp", "ConvOp.load", "ConvPoolOp",
                                  "PackedConvOp", "PackedConvPairOp",
                                  "FusionNet", "ResFusionNet", "VGGFusion"])
def test_no_device_without_cuda_raises(what, monkeypatch, tmp_path):
    """The port runs on the card unless asked for the CPU: without CUDA a
    constructor or load given no device raises, naming device="cpu", and
    the same call with device="cpu" builds on the CPU."""
    from deepfusion_tpu_torch.config import PoolConfig
    from deepfusion_tpu_torch.models import (FusionNet, FusionNetConfig,
                                             ResFusionNet,
                                             ResFusionNetConfig, VGGFusion,
                                             VGGFusionConfig)
    from deepfusion_tpu_torch.ops.convpool import ConvPoolOp
    from deepfusion_tpu_torch.ops.mega import PackedConvPairOp
    from deepfusion_tpu_torch.ops.packed import PackedConvOp
    cfg, w = _small_conv()
    path = str(tmp_path / "op.npz")
    ConvOp(cfg, w, device="cpu").save(path)
    small = dict(batch=1, hw=8)
    build = {
        "ConvOp": lambda **d: ConvOp(cfg, w, **d),
        "ConvOp.load": lambda **d: ConvOp.load(path, **d),
        "ConvPoolOp": lambda **d: ConvPoolOp(
            cfg, PoolConfig.make("max", (6, 6), (2, 2), (2, 2), (0, 0)), w,
            **d),
        "PackedConvOp": lambda **d: PackedConvOp(cfg, w, **d),
        "PackedConvPairOp": lambda **d: PackedConvPairOp(cfg, (w,), cfg,
                                                         (w,), **d),
        "FusionNet": lambda **d: FusionNet(
            FusionNetConfig(width=16, in_ch=8, num_classes=8, **small), **d),
        "ResFusionNet": lambda **d: ResFusionNet(
            ResFusionNetConfig(width=16, in_ch=8, num_classes=8, **small),
            **d),
        "VGGFusion": lambda **d: VGGFusion(
            VGGFusionConfig(width=8, in_ch=8, num_classes=8, **small), **d),
    }[what]
    _no_cuda(monkeypatch)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        build()
    built = build(device="cpu")
    assert next(built.buffers()).device.type == "cpu"


@pytest.mark.parametrize("fn", ["conv", "conv_relu_pool", "pool",
                                "eltwise_sum_relu", "concat", "pack_image"])
def test_numpy_input_without_device_needs_cuda(fn, monkeypatch):
    """A functional entry point puts a numpy input on the current CUDA
    device: without CUDA it raises unless device="cpu" is given; a tensor
    input runs on its own device either way."""
    from deepfusion_tpu_torch.ops.concat import concat
    from deepfusion_tpu_torch.ops.packed import PackedSpec, pack_image
    from deepfusion_tpu_torch.ops.pool import (conv_relu_pool,
                                               eltwise_sum_relu, pool)
    cfg, w = _small_conv()
    x = np.random.default_rng(8).integers(0, 256, (1, 6, 6, 16),
                                          dtype=np.uint8)
    call = {
        "conv": lambda a, **d: tconv(a, w, None, (1, 1), (1, 1),
                                     dst_dtype="u8", **d),
        "conv_relu_pool": lambda a, **d: conv_relu_pool(
            a, w, None, (1, 1), (1, 1), dst_dtype="u8", **d),
        "pool": lambda a, **d: pool(a, "max", (2, 2), (2, 2), (0, 0), **d),
        "eltwise_sum_relu": lambda a, **d: eltwise_sum_relu(a, a, **d),
        "concat": lambda a, **d: concat([a, a], **d),
        "pack_image": lambda a, **d: pack_image(
            a, PackedSpec.make(6, 6, 16, halo=1, col_off=1), **d),
    }[fn]
    _no_cuda(monkeypatch)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        call(x)
    got = call(x, device="cpu")
    assert got.device.type == "cpu"
    assert torch.equal(call(torch.from_numpy(x)), got)


def test_numpy_conv_on_the_cpu_matches_jax(monkeypatch):
    """conv() of a numpy input with device="cpu" is the JAX conv(), with
    CUDA unavailable: nothing needs the card."""
    _no_cuda(monkeypatch)
    src, wei, bia, stride, pad, kw = _case("fused-u8-rne")
    want = np.asarray(jconv(src, wei, bia, stride, pad, **kw))
    got = tconv(src, wei, bia, stride, pad, **kw, device="cpu")
    assert got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), want)
