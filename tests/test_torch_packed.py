"""Packed-domain ops of the PyTorch port vs the JAX package, bitwise (CPU).

The same numpy inputs, made from a seed, go through
``deepfusion_tpu.ops.packed`` (Pallas interpret mode) and through the port's
``ops/packed.py`` (its plain PyTorch versions). Whole packed arrays are
compared, halo rows, margin columns and pad lanes included: both write -128
to every non-image slot. Tolerance: bitwise.
"""
import numpy as np
import pytest
import torch

import deepfusion_tpu.ops.packed as J
from deepfusion_tpu.config import ConvConfig as JConvConfig
from deepfusion_tpu.utils.logger import CheckError as JCheckError
from deepfusion_tpu_torch.config import ConvConfig
from deepfusion_tpu_torch.ops import packed as T
from deepfusion_tpu_torch.utils.logger import CheckError
from deepfusion_tpu_torch.utils.mathutil import conv_output_size

torch.set_num_threads(2)


def jspec(s: T.PackedSpec) -> J.PackedSpec:
    return J.PackedSpec(**{f: getattr(s, f) for f in
                           ("h", "w", "c", "cp", "halo", "col_off", "iwp")})


def _cfgs(mb, hw, ic, oc, k=3, pad=1, oc1=None, bias=True, per_oc=False,
          rnd="nearest", dst="u8", stride=1, seed=0, sum_scale=None):
    """(port cfg, JAX cfg, wei, bia, wei1, bia1) from one seeded draw, with
    full-range s8 weights and scales that keep most outputs in u8 range."""
    rng = np.random.default_rng(seed)
    o = conv_output_size(hw, k, stride, pad)
    wei = rng.integers(-128, 128, (oc, ic, k, k)).astype(np.int8)
    bia = rng.integers(-20000, 20000, (oc,)).astype(np.int32) \
        if bias else None
    sc = 1.0 / (k * k * ic * 40)
    sc0 = (rng.uniform(0.5, 1.5, oc) * sc).astype(np.float32) \
        if per_oc else (sc,)
    kw = dict(conv0_relu=True, conv0_scales=sc0, conv0_round=rnd)
    if sum_scale is not None:
        kw.update(sum_dt="u8", sum_scale=sum_scale)
    wei1 = bia1 = None
    if oc1 is not None:
        wei1 = rng.integers(-128, 128, (oc1, oc, 1, 1)).astype(np.int8)
        bia1 = rng.integers(-20000, 20000, (oc1,)).astype(np.int32) \
            if bias else None
        sc1 = (rng.uniform(0.5, 1.5, oc1) / (oc * 40)).astype(np.float32) \
            if per_oc else (1.0 / (oc * 40),)
        kw.update(wei1x1_shape=(oc1, oc, 1, 1),
                  bia1x1_dt=None if bia1 is None else bia1.dtype,
                  conv1_relu=True, conv1_scales=sc1, conv1_round=rnd)
    args = ((mb, hw, hw, ic), (oc, ic, k, k),
            None if bia is None else bia.dtype, (stride, stride), (pad, pad),
            (mb, o, o, oc1 or oc), dst)
    return (ConvConfig.make(*args, **kw), JConvConfig.make(*args, **kw),
            wei, bia, wei1, bia1)


def _u8(rng, n, spec):
    return rng.integers(0, 256, (n, spec.h, spec.w, spec.c), dtype=np.uint8)


def _run_both(cfgs, sins, col_off_out=None, halo_out=None, n=2, seed=0):
    """Pack the same random images for both packages, run both ops, return
    (port output, JAX output) as numpy."""
    cfg, jcfg, wei, bia, wei1, bia1 = cfgs
    top = T.PackedConvOp(cfg, wei, bia, wei1, bia1, sin=sins,
                         col_off_out=col_off_out, halo_out=halo_out,
                         device="cpu")
    jop = J.PackedConvOp(jcfg, wei, bia, wei1, bia1,
                         sin=tuple(jspec(s) for s in top.sins),
                         col_off_out=col_off_out, halo_out=halo_out)
    assert jspec(top.sout) == jop.sout
    rng = np.random.default_rng(seed)
    imgs = [_u8(rng, n, s) for s in top.sins]
    got = top(tuple(T.pack_image(x, s, device="cpu")
                    for x, s in zip(imgs, top.sins)))
    want = jop(tuple(J.pack_image(x, jspec(s))
                     for x, s in zip(imgs, top.sins)))
    return got.numpy(), np.asarray(want), top


def test_pack_unpack_matches_jax():
    rng = np.random.default_rng(1)
    spec = T.PackedSpec.make(13, 11, 40, halo=3, col_off=2)
    src = rng.integers(0, 256, (2, 13, 11, 40), dtype=np.uint8)
    got = T.pack_image(src, spec, device="cpu")
    want = J.pack_image(src, jspec(spec))
    assert got.dtype == torch.int8 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(T.unpack_image(got, spec).numpy(), src)
    np.testing.assert_array_equal(T.unpack_image(want, spec).numpy(),
                                  J.unpack_image(want, jspec(spec)))
    # a tensor input packs on its own device and equals the numpy path
    assert torch.equal(T.pack_image(torch.from_numpy(src), spec,
                                    device="cpu"), got)


def test_packed_spec_make_matches_jax():
    for args, kw in [((13, 13, 32), dict(halo=3, col_off=1)),
                     ((56, 56, 32), dict(cp=32, halo=4, col_off=2)),
                     ((7, 9, 5), {}), ((28, 28, 200), dict(halo=0))]:
        assert jspec(T.PackedSpec.make(*args, **kw)) == \
            J.PackedSpec.make(*args, **kw)


# the validation cases of tests/test_packed.py:123-145, in both packages
@pytest.mark.parametrize("case", ["halo<ph", "s8 dst", "iwp unaligned",
                                  "image exceeds row", "channels"])
def test_validation_matches_jax(case):
    cfg, jcfg, wei, bia, _, _ = _cfgs(1, 13, 32, 32)
    if case == "iwp unaligned":
        for mod, err in ((T, CheckError), (J, JCheckError)):
            with pytest.raises(err, match="sublane-aligned"):
                mod.PackedSpec(h=4, w=4, c=32, cp=32, halo=1, col_off=1,
                               iwp=12)
        return
    if case == "image exceeds row":
        for mod, err in ((T, CheckError), (J, JCheckError)):
            with pytest.raises(err, match="image exceeds packed row"):
                mod.PackedSpec(h=4, w=8, c=32, cp=32, halo=1, col_off=1,
                               iwp=8)
        return
    sin = T.PackedSpec.make(13, 13, 32, halo=0, col_off=1)
    if case == "s8 dst":
        cfg, jcfg, wei, bia, _, _ = _cfgs(1, 13, 32, 32, dst="s8")
        sin = None
    elif case == "channels":
        sin = T.PackedSpec.make(13, 13, 64, halo=1, col_off=1)
    with pytest.raises(CheckError) as e:
        T.PackedConvOp(cfg, wei, bia, sin=sin, device="cpu")
    with pytest.raises(JCheckError) as je:
        J.PackedConvOp(jcfg, wei, bia,
                       sin=None if sin is None else jspec(sin))
    assert str(e.value).split(" (")[0] == str(je.value).split(" (")[0]


@pytest.mark.parametrize("hw,ph", [(13, 1), (13, 0), (12, 1)])
def test_packed_conv_single_matches_jax(hw, ph):
    got, want, _ = _run_both(_cfgs(2, hw, 32, 32, pad=ph, seed=hw + ph),
                             None)
    np.testing.assert_array_equal(got, want)


# (label, _cfgs kwargs)
CONV_CASES = {
    "fused": dict(oc1=64),
    "fused per-oc scales": dict(oc1=32, per_oc=True),
    "per-oc scales": dict(per_oc=True),
    "round down": dict(rnd="down", per_oc=True),
    "fused round down": dict(oc1=40, rnd="down"),
    "no bias scalar scale": dict(bias=False),
    "fused no bias": dict(oc1=32, bias=False),
    "pad lanes oc=40": dict(),          # oc set below
    "1x1": dict(k=1, pad=0),
    "5x5 pad 2": dict(k=5, pad=2),
}


@pytest.mark.parametrize("label", sorted(CONV_CASES))
def test_packed_conv_matches_jax(label):
    oc = 40 if "oc=40" in label else 32
    kw = CONV_CASES[label]
    pad = kw.get("pad", 1)
    sin = T.PackedSpec.make(12, 12, 32, halo=max(pad, 1) + 1,
                            col_off=max(pad, 1))
    got, want, op = _run_both(_cfgs(2, 12, 32, oc, seed=len(label), **kw),
                              sin, halo_out=max(pad, 1))
    np.testing.assert_array_equal(got, want)
    img = got.reshape(2, op.sout.rows, op.sout.iwp, op.sout.cp)
    assert (img[..., op.sout.c:] == -128).all()


@pytest.mark.parametrize("cs", [(32, 32), (32, 64), (64, 32, 32)])
def test_packed_conv_multi_input_matches_jax(cs):
    """Concat-free branch merge (tests/test_packed.py:224): the conv reads
    its input as lane segments of 2 or 3 sources."""
    ic = sum(cs)
    specs = tuple(T.PackedSpec.make(12, 12, c, halo=2, col_off=1)
                  for c in cs)
    got, want, _ = _run_both(_cfgs(2, 12, ic, 64, seed=ic), specs,
                             halo_out=1)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("halo_in,halo_out", [(1, 1), (2, 1), (3, 1),
                                              (4, 3), (2, 0)])
def test_packed_conv_halo_erosion_matches_jax(halo_in, halo_out):
    sin = T.PackedSpec.make(12, 12, 32, halo=halo_in, col_off=2)
    got, want, _ = _run_both(_cfgs(1, 12, 32, 32, oc1=32, seed=halo_in),
                             sin, col_off_out=2, halo_out=halo_out, n=1)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("off_in,off_out", [(3, 1), (1, 3), (4, 1), (1, 6)])
def test_packed_conv_large_tap_shifts_matches_jax(off_in, off_out):
    """Column offsets whose taps shift by |d| >= 2, up to the JAX kernel's
    output-roll formulation for |d| >= 4 (tests/test_packed.py:384)."""
    hw = 12
    iwp = ((hw + off_in + off_out + 6) // 8 + 1) * 8
    sin = T.PackedSpec.make(hw, hw, 32, halo=3, col_off=off_in, iwp=iwp)
    got, want, _ = _run_both(_cfgs(1, hw, 32, 32, seed=off_in + off_out),
                             sin, col_off_out=off_out, halo_out=2, n=1)
    np.testing.assert_array_equal(got, want)


def test_packed_conv_reads_pad_slots_as_stored():
    """The plain version reads the pad slots themselves: junk in them
    changes the result exactly as the JAX kernel's s8 x s8 + correction
    does, which is what the CUDA kernel is held to on the card."""
    cfg, jcfg, wei, bia, _, _ = _cfgs(1, 12, 32, 32, seed=3)
    sin = T.PackedSpec.make(12, 12, 32, halo=2, col_off=2)
    top = T.PackedConvOp(cfg, wei, bia, sin=sin, col_off_out=2, halo_out=1,
                         device="cpu")
    jop = J.PackedConvOp(jcfg, wei, bia, sin=jspec(sin), col_off_out=2,
                         halo_out=1)
    junk = np.random.default_rng(4).integers(
        -128, 128, sin.array_shape(1), dtype=np.int8)
    got = top(torch.from_numpy(junk)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jop(junk)))
    clean = top(T.pack_image(T.unpack_image(junk, sin), sin,
                             device="cpu")).numpy()
    assert not np.array_equal(got, clean)


@pytest.mark.parametrize("feature", ["emit_acc1", "t_range"])
def test_unported_features_raise(feature):
    """The raw accumulator needs the fused config; the JAX package's
    t_range (TPU row tiles) has no counterpart: the port takes ``rows``,
    rows of the output array."""
    cfg, _, wei, bia, _, _ = _cfgs(1, 12, 32, 32)
    op = T.PackedConvOp(cfg, wei, bia, device="cpu")
    x = torch.full(op.sin.array_shape(1), -128, dtype=torch.int8)
    if feature == "emit_acc1":
        with pytest.raises(CheckError, match="emit_acc1 needs the fused"):
            op(x, emit_acc1=True)
    else:
        with pytest.raises(TypeError, match="t_range"):
            op(x, t_range=(0, 1))


# ------------------------------------------ K5's fused 2x2 pool (pool2)

def _pool2_ops(fused, halo_out, rnd="nearest", sum_scale=None, seed=0):
    """Port and JAX pool2 ops and the port's op without the pool, on the
    geometry of tests/test_packed.py:410-460."""
    cfg, jcfg, wei, bia, wei1, bia1 = _cfgs(
        2, 12, 32, 32, oc1=32 if fused else None, rnd=rnd, per_oc=True,
        seed=seed, sum_scale=sum_scale)
    sin = T.PackedSpec.make(12, 12, 32, halo=max(halo_out + 1, 1),
                            col_off=2, iwp=16)
    ssum = None if sum_scale is None else T.PackedSpec.make(
        12, 12, 32, halo=halo_out + 1, col_off=2, iwp=16)
    kw = dict(col_off_out=2, halo_out=halo_out)
    ops = [T.PackedConvOp(cfg, wei, bia, wei1, bia1, sin=sin, sum_spec=ssum,
                          pool2=pool2, **kw,
                          device="cpu") for pool2 in (True, False)]
    jop = J.PackedConvOp(jcfg, wei, bia, wei1, bia1, sin=jspec(sin),
                         sum_spec=None if ssum is None else jspec(ssum),
                         pool2=True, **kw)
    assert jspec(ops[0].sout_pooled) == jop.sout_pooled
    return ops[0], jop, ops[1]


def _pool2_check(top, jop, plain, seed):
    rng = np.random.default_rng(seed)
    img = _edge_u8(rng, (2, 12, 12, 32))
    x = T.pack_image(img, top.sin, device="cpu")
    kw, jkw = {}, {}
    if top.ssum is not None:
        res = _edge_u8(rng, (2, 12, 12, top.ssum.c))
        kw = dict(sum_arr=T.pack_image(res, top.ssum, device="cpu"))
        jkw = dict(sum_arr=J.pack_image(res, jspec(top.ssum)))
    got = top(x, **kw)
    assert tuple(got.shape) == top.sout_pooled.array_shape(2)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jop(J.pack_image(img, jspec(top.sin)),
                                    **jkw)))
    want, wspec = T.packed_maxpool2(plain(x, **kw), plain.sout)
    assert wspec == top.sout_pooled
    assert torch.equal(got, want)


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("halo_out", [2, 0])
def test_packed_conv_pool2_matches_jax(fused, halo_out):
    """The fused 2x2/s2 max pool equals the JAX op with pool2 and
    packed_maxpool2 of the unpooled conv, for deep and zero output
    halos."""
    _pool2_check(*_pool2_ops(fused, halo_out, seed=40 + fused + halo_out),
                 seed=halo_out)


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("rnd", ["nearest", "down"])
def test_packed_conv_pool2_with_sum_matches_jax(rnd, fused):
    """The sum operand joins at full resolution, before the pool."""
    _pool2_check(*_pool2_ops(fused, 2, rnd=rnd, sum_scale=0.8,
                             seed=50 + fused), seed=7)


def test_packed_conv_pool2_save_load(tmp_path):
    import json
    top, _, _ = _pool2_ops(True, 2, seed=60)
    path = str(tmp_path / "pp.npz")
    top.save(path)
    back = T.PackedConvOp.load(path, device="cpu")
    assert back.pool2 and back.sout_pooled == top.sout_pooled
    x = T.pack_image(_u8(np.random.default_rng(3), 2, top.sin), top.sin,
                     device="cpu")
    assert torch.equal(back(x), top(x))
    # a hand-edited checkpoint with a pool-illegal output fails at load
    data = dict(np.load(path, allow_pickle=False))
    cfgs = json.loads(str(data["__cfg__"]))
    cfgs["sout"]["col_off"] = 3
    data["__cfg__"] = np.str_(json.dumps(cfgs))
    np.savez(path, **data)
    with pytest.raises(CheckError, match="maxpool2"):
        T.PackedConvOp.load(path, device="cpu")


def test_packed_conv_pool2_validation():
    cfg, _, wei, bia, _, _ = _cfgs(1, 12, 32, 32)
    sin = T.PackedSpec.make(12, 12, 32, halo=2, col_off=2, iwp=16)
    with pytest.raises(CheckError, match="even halo and col_off"):
        T.PackedConvOp(cfg, wei, bia, sin=sin, col_off_out=1, halo_out=2,
                       pool2=True, device="cpu")


# ------------------ K5's residual merge and 2x2 pool (merge_pool)

def _merge_ops(cs, k=1, oc=None, oc1=None, stride=1, merge_pool=True,
               sum_scale=None, seed=0):
    """A packed conv over inputs of cs lanes (8x8 images, halo 2, col_off
    2), its output placed alike, scales that drive round(x) well below 0
    and above 255."""
    rng = np.random.default_rng(seed)
    ic = sum(cs)
    oc = oc or ic
    wei = rng.integers(-128, 128, (oc, ic, k, k)).astype(np.int8)
    bia = rng.integers(-20000, 20000, (oc,)).astype(np.int32)
    kw = dict(conv0_relu=True, conv0_scales=(1.0 / 300,))
    if sum_scale is not None:
        kw.update(sum_dt="u8", sum_scale=sum_scale)
    wei1 = None
    if oc1 is not None:
        wei1 = rng.integers(-128, 128, (oc1, oc, 1, 1)).astype(np.int8)
        kw.update(wei1x1_shape=wei1.shape, conv1_relu=True,
                  conv1_scales=(1.0 / 300,))
    o = conv_output_size(8, k, stride, k // 2)
    cfg = ConvConfig.make((2, 8, 8, ic), wei.shape, bia.dtype,
                          (stride, stride), (k // 2, k // 2),
                          (2, o, o, oc1 or oc), "u8", **kw)
    sins = None if stride > 1 else tuple(
        T.PackedSpec.make(8, 8, c, halo=2, col_off=2, iwp=16) for c in cs)
    ssum = None if sum_scale is None else T.PackedSpec.make(
        8, 8, ic, halo=2, col_off=2, iwp=16)
    return T.PackedConvOp(cfg, wei, bia, wei1, None, sin=sins,
                          col_off_out=2, halo_out=2, sum_spec=ssum,
                          merge_pool=merge_pool, device="cpu")


MERGE_REFUSALS = {"3x3": (dict(k=3), "1x1"),
                  "fused": (dict(oc1=64), "unfused"),
                  "strided": (dict(cs=(64,), stride=2), "stride-1"),
                  "lane mismatch": (dict(oc=32), "channels and lanes")}


@pytest.mark.parametrize("case", ["FusionNet res", "saturating"]
                         + sorted(MERGE_REFUSALS))
def test_packed_conv_merge_pool(case):
    """merge_pool is bitwise packed_sum_relu_maxpool2 of the inputs and the
    unmerged conv's output: at FusionNet's residual conv, and where round(x)
    falls below 0 and above 255 and the sum saturates, which tells its
    clamp-then-add order from the conv sum post-op's add-then-clamp. A 3x3,
    fused, strided or lane-mismatched conv is refused."""
    if case in MERGE_REFUSALS:
        kw, match = MERGE_REFUSALS[case]
        with pytest.raises(CheckError, match=match):
            _merge_ops(**{"cs": (32, 32), **kw})
        return
    if case == "FusionNet res":
        from deepfusion_tpu_torch.models import FusionNet, FusionNetConfig
        net = FusionNet(FusionNetConfig(batch=2), device="cpu")
        top = net.build_packed()["res"]
        p = net.params["res"]
        plain = T.PackedConvOp(top.cfg, p["wei"], p["bia"], sin=top.sins,
                               col_off_out=2, halo_out=2, device="cpu")
    else:
        top = _merge_ops((32, 32))
        plain = _merge_ops((32, 32), merge_pool=False)
    assert top.merge_pool and top.pool2 and not plain.pool2
    rng = np.random.default_rng(11)
    xs = [T.pack_image(_edge_u8(rng, (2, s.h, s.w, s.c)), s, device="cpu")
          for s in top.sins]
    got = top(xs)
    r = plain(xs)
    want, wspec = T.packed_sum_relu_maxpool2(xs, r, top.sins, plain.sout)
    assert wspec == top.sout_final == top.sout_pooled
    assert torch.equal(got, want)
    if case == "saturating":
        ru = T.unpack_image(r, plain.sout).to(torch.int32)
        su = T.unpack_image(torch.cat(xs, dim=-1),
                            T.joined_spec(top.sins)).to(torch.int32)
        assert (ru == 0).any() and (ru == 255).any()
        assert ((ru + su > 255) & (ru < 255) & (su < 255)).any()
        # the sum post-op joins the input before the clamp: another result
        sop = _merge_ops((32, 32), merge_pool=False, sum_scale=1.0)
        other, _ = T.packed_maxpool2(sop(xs, sum_arr=torch.cat(xs, dim=-1)),
                                     sop.sout)
        assert not torch.equal(got, other)


def test_packed_conv_merge_pool_save_load_reheight(tmp_path):
    top = _merge_ops((32, 32), seed=3)
    path = str(tmp_path / "merge.npz")
    top.save(path)
    back = T.PackedConvOp.load(path, device="cpu")
    assert back.merge_pool and back.sout_final == top.sout_final
    rng = np.random.default_rng(4)
    xs = [T.pack_image(_edge_u8(rng, (2, 8, 8, s.c)), s, device="cpu")
          for s in top.sins]
    assert torch.equal(back(xs), top(xs))
    half = top.reheight(4)
    assert half.merge_pool and half.sout_final.h == 2


def _sum_op_pair(delta, rnd, fused, seed):
    """Port and JAX ops with a packed sum operand whose halo is the
    output's plus delta."""
    out_c = 32 if fused else 40
    cfg, jcfg, wei, bia, wei1, bia1 = _cfgs(
        2, 12, 32, 40, oc1=32 if fused else None, rnd=rnd, per_oc=True,
        seed=seed, sum_scale=0.8 if delta else 1.0)
    sin = T.PackedSpec.make(12, 12, 32, halo=2, col_off=2)
    ssum = T.PackedSpec.make(12, 12, out_c, halo=1 + delta, col_off=2,
                             iwp=sin.iwp)
    top = T.PackedConvOp(cfg, wei, bia, wei1, bia1, sin=sin, col_off_out=2,
                         halo_out=1, sum_spec=ssum, device="cpu")
    jop = J.PackedConvOp(jcfg, wei, bia, wei1, bia1, sin=jspec(sin),
                         col_off_out=2, halo_out=1, sum_spec=jspec(ssum))
    assert jspec(top.sout) == jop.sout
    return top, jop


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("rnd", ["nearest", "down"])
@pytest.mark.parametrize("delta", [0, 1])
def test_packed_conv_sum_matches_jax(delta, rnd, fused):
    """The packed sum post-op (ResFusionNet's residual): the operand's halo
    is the output's (delta 0) or one deeper (delta 1), read at its own
    rows; sum_scale != 1 with the deeper halo."""
    top, jop = _sum_op_pair(delta, rnd, fused, seed=10 + 4 * delta + fused)
    rng = np.random.default_rng(delta + 2 * fused)
    img = _edge_u8(rng, (2, 12, 12, 32))
    res = _edge_u8(rng, (2, 12, 12, top.ssum.c))
    got = top(T.pack_image(img, top.sin, device="cpu"),
              sum_arr=T.pack_image(res, top.ssum, device="cpu")).numpy()
    want = jop(J.pack_image(img, jspec(top.sin)),
               sum_arr=J.pack_image(res, jspec(top.ssum)))
    np.testing.assert_array_equal(got, np.asarray(want))


def test_packed_sum_validation_matches_jax():
    cfg, jcfg, wei, bia, _, _ = _cfgs(1, 12, 32, 32, sum_scale=1.0)
    sin = T.PackedSpec.make(12, 12, 32, halo=2, col_off=2)
    shallow = T.PackedSpec.make(12, 12, 32, halo=0, col_off=2, iwp=sin.iwp)
    for ssum, match in ((None, "pass ssum exactly"),
                        (shallow, "halo must cover")):
        with pytest.raises(CheckError, match=match):
            T.PackedConvOp(cfg, wei, bia, sin=sin, col_off_out=2,
                           halo_out=1, sum_spec=ssum, device="cpu")
        with pytest.raises(JCheckError, match=match):
            J.PackedConvOp(jcfg, wei, bia, sin=jspec(sin), col_off_out=2,
                           halo_out=1,
                           sum_spec=None if ssum is None else jspec(ssum))
    top, _ = _sum_op_pair(0, "nearest", False, seed=3)
    x = T.pack_image(np.zeros((2, 12, 12, 32), np.uint8), top.sin,
                     device="cpu")
    with pytest.raises(CheckError, match="pass sum_arr"):
        top(x)


@pytest.mark.parametrize("ic,hw,oc1", [(16, 13, None), (32, 14, 32),
                                       (128, 9, None)])
def test_strided_pack_input_matches_jax(ic, hw, oc1):
    """A 3x3/s2 conv runs on the s2d grid: pack_input regroups the dense
    image and the op's specs are the JAX op's. ic = 128 is where the JAX
    op takes its sparse-phase taps; the port's dense s2d lowering computes
    the same accumulator."""
    cfg, jcfg, wei, bia, wei1, bia1 = _cfgs(2, hw, ic, 32, oc1=oc1,
                                            stride=2, per_oc=True, seed=ic)
    top = T.PackedConvOp(cfg, wei, bia, wei1, bia1, device="cpu")
    jop = J.PackedConvOp(jcfg, wei, bia, wei1, bia1)
    assert (jspec(top.sin), jspec(top.sout)) == (jop.sin, jop.sout)
    assert top.cfg_orig == cfg and top.cfg.sh == 1 and top.cfg.ic == 4 * ic
    assert (jop.sparse_taps is not None) == (ic % 128 == 0)
    img = _edge_u8(np.random.default_rng(ic), (2, hw, hw, ic))
    x = top.pack_input(img)
    jx = jop.pack_input(img)
    np.testing.assert_array_equal(x.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(top(x).numpy(), np.asarray(jop(jx)))


def test_s2d_helpers_match_jax():
    from deepfusion_tpu.ops import layout as JL
    from deepfusion_tpu_torch.ops import layout as TL
    for k, s, p, hw in ((3, 2, 1, 13), (7, 2, 3, 16), (3, 3, 1, 11),
                        (1, 2, 0, 8)):
        cfg, jcfg, wei, *_ = _cfgs(2, hw, 5, 8, k=k, pad=p, stride=s,
                                   seed=k + s)
        assert TL.s2d_taps(cfg) == JL.s2d_taps(jcfg)
        c2, j2 = TL.s2d_cfg(cfg), JL.s2d_cfg(jcfg)
        for f in ("ih", "iw", "ic", "oh", "ow", "kh", "kw", "sh", "ph"):
            assert getattr(c2, f) == getattr(j2, f), (k, s, f)
        np.testing.assert_array_equal(TL.s2d_weights(cfg, wei),
                                      JL.s2d_weights(jcfg, wei))
        img = np.random.default_rng(k).integers(0, 256, (2, hw, hw, 5),
                                                dtype=np.uint8)
        np.testing.assert_array_equal(TL.s2d_image_u8(cfg, img).numpy(),
                                      JL.s2d_image_u8(jcfg, img))


def test_save_load_strided_and_sum_ops(tmp_path):
    cfg, _, wei, bia, _, _ = _cfgs(2, 13, 16, 32, stride=2, seed=5)
    ops = [T.PackedConvOp(cfg, wei, bia,
                          device="cpu"), _sum_op_pair(1, "down", True, 6)[0]]
    rng = np.random.default_rng(11)
    for i, op in enumerate(ops):
        path = str(tmp_path / f"op{i}.npz")
        op.save(path)
        op2 = T.PackedConvOp.load(path, device="cpu")
        assert (op2.cfg, op2.cfg_orig, op2.sins, op2.sout, op2.ssum) == \
            (op.cfg, op.cfg_orig, op.sins, op.sout, op.ssum)
        x = T.pack_image(_u8(rng, 2, op.sin), op.sin, device="cpu")
        kw = {} if op.ssum is None else dict(
            sum_arr=T.pack_image(_u8(rng, 2, op.ssum), op.ssum, device="cpu"))
        assert torch.equal(op(x, **kw), op2(x, **kw))


def test_save_load_roundtrip(tmp_path):
    cfg, _, wei, bia, wei1, bia1 = _cfgs(2, 12, 64, 32, oc1=32, rnd="down",
                                         per_oc=True)
    sins = (T.PackedSpec.make(12, 12, 32, halo=2, col_off=2),
            T.PackedSpec.make(12, 12, 32, halo=2, col_off=2))
    op = T.PackedConvOp(cfg, wei, bia, wei1, bia1, sin=sins, col_off_out=2,
                        halo_out=1, device="cpu")
    path = str(tmp_path / "pop.npz")
    op.save(path)
    op2 = T.PackedConvOp.load(path, device="cpu")
    assert (op2.cfg, op2.sins, op2.sout) == (op.cfg, op.sins, op.sout)
    rng = np.random.default_rng(2)
    xs = tuple(T.pack_image(_u8(rng, 2, s), s, device="cpu") for s in sins)
    assert torch.equal(op(xs), op2(xs))


# ------------------------------------------------ K6/K7/K8 and the glue

def test_packed_concat_matches_jax():
    rng = np.random.default_rng(5)
    specs = [T.PackedSpec.make(8, 12, 32, halo=2, col_off=2),
             T.PackedSpec.make(8, 12, 40, halo=2, col_off=2)]
    imgs = [_u8(rng, 2, s) for s in specs]
    got, gspec = T.packed_concat([T.pack_image(x, s, device="cpu")
                                  for x, s in zip(imgs, specs)], specs)
    want, wspec = J.packed_concat([J.pack_image(x, jspec(s))
                                   for x, s in zip(imgs, specs)],
                                  [jspec(s) for s in specs])
    assert jspec(gspec) == wspec
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    with pytest.raises(CheckError):
        T.packed_concat([T.pack_image(imgs[1], specs[1], device="cpu")] * 2,
                        [specs[1]] * 2)


def _edge_u8(rng, shape):
    """Full-range u8 with both saturation edges present."""
    x = rng.integers(0, 256, shape, dtype=np.uint8)
    flat = x.reshape(-1)
    flat[:4] = [0, 255, 255, 0]
    return x


def test_packed_sum_relu_matches_jax():
    rng = np.random.default_rng(6)
    spec = T.PackedSpec.make(6, 10, 32, halo=2, col_off=2)
    a, b = _edge_u8(rng, (2, 6, 10, 32)), _edge_u8(rng, (2, 6, 10, 32))
    got = T.packed_sum_relu(T.pack_image(a, spec, device="cpu"),
                            T.pack_image(b, spec, device="cpu"), spec)
    want = J.packed_sum_relu(J.pack_image(a, jspec(spec)),
                             J.pack_image(b, jspec(spec)), jspec(spec))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_packed_maxpool2_matches_jax():
    rng = np.random.default_rng(7)
    spec = T.PackedSpec.make(8, 12, 48, halo=2, col_off=2, iwp=16)
    src = _edge_u8(rng, (2, 8, 12, 48))
    got, gspec = T.packed_maxpool2(T.pack_image(src, spec, device="cpu"), spec)
    want, wspec = J.packed_maxpool2(J.pack_image(src, jspec(spec)),
                                    jspec(spec))
    assert jspec(gspec) == wspec
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    odd = T.PackedSpec.make(8, 12, 32, halo=2, col_off=1, iwp=16)
    with pytest.raises(CheckError, match="even halo and col_off"):
        T.packed_maxpool2(T.pack_image(_u8(rng, 1, odd), odd,
                                       device="cpu"), odd)


def test_packed_maxpool2_at_resfusion_down_matches_jax():
    """The one main-path launch of the pool alone: ResFusionNet's packed
    forward pools its downsample conv's output (``down.sout``), here at
    batch 1."""
    rng = np.random.default_rng(11)
    spec = T.PackedSpec.make(32, 32, 128, halo=2, col_off=2, iwp=48)
    src = _edge_u8(rng, (1, 32, 32, 128))
    got, gspec = T.packed_maxpool2(T.pack_image(src, spec, device="cpu"), spec)
    want, wspec = J.packed_maxpool2(J.pack_image(src, jspec(spec)),
                                    jspec(spec))
    assert jspec(gspec) == wspec
    assert tuple(got.shape) == (1, 18 * 24, 128)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("cs", [(64,), (32, 32), (32, 64, 32)])
def test_packed_sum_relu_maxpool2_matches_jax(cs):
    rng = np.random.default_rng(len(cs))
    yspecs = [T.PackedSpec.make(8, 12, c, halo=2, col_off=2, iwp=16)
              for c in cs]
    rspec = T.PackedSpec.make(8, 12, sum(cs), halo=2, col_off=2, iwp=16)
    ys = [_edge_u8(rng, (2, 8, 12, c)) for c in cs]
    r = _edge_u8(rng, (2, 8, 12, sum(cs)))
    got, gspec = T.packed_sum_relu_maxpool2(
        [T.pack_image(y, s, device="cpu") for y, s in zip(ys, yspecs)],
        T.pack_image(r, rspec, device="cpu"), yspecs, rspec)
    want, wspec = J.packed_sum_relu_maxpool2(
        [J.pack_image(y, jspec(s)) for y, s in zip(ys, yspecs)],
        J.pack_image(r, jspec(rspec)), [jspec(s) for s in yspecs],
        jspec(rspec))
    assert jspec(gspec) == wspec
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("rnd", ["nearest", "down"])
def test_packed_global_avgpool_matches_jax(rnd):
    from deepfusion_tpu.types import round_mode as jround
    rng = np.random.default_rng(8)
    spec = T.PackedSpec.make(9, 13, 40, halo=3, col_off=2)
    x = rng.integers(0, 256, (3, 9, 13, 40), dtype=np.uint8)
    got = T.packed_global_avgpool(T.pack_image(x, spec,
                                               device="cpu"), spec, round=rnd)
    want = J.packed_global_avgpool(J.pack_image(x, jspec(spec)),
                                   jspec(spec), round=jround[rnd])
    assert got.dtype == torch.uint8 and tuple(got.shape) == (3, 1, 1, 40)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_repack_matches_jax():
    rng = np.random.default_rng(9)
    s1 = T.PackedSpec.make(5, 9, 24, halo=1, col_off=1)
    s2 = T.PackedSpec.make(5, 9, 24, cp=64, halo=3, col_off=4, iwp=24)
    src = _u8(rng, 2, s1)
    got = T.repack(T.pack_image(src, s1, device="cpu"), s1, s2)
    want = J.repack(J.pack_image(src, jspec(s1)), jspec(s1), jspec(s2))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ------------------------------- K5's modes for the sharded wrappers

def _acc1_ops(seed, per_oc):
    cfg, jcfg, wei, bia, wei1, bia1 = _cfgs(2, 12, 32, 64, oc1=40,
                                            per_oc=per_oc, seed=seed)
    sin = T.PackedSpec.make(12, 12, 32, halo=2, col_off=2, iwp=16)
    kw = dict(halo_out=1, col_off_out=2)
    return (T.PackedConvOp(cfg, wei, bia, wei1, bia1, sin=sin, **kw,
                           device="cpu"),
            J.PackedConvOp(jcfg, wei, bia, wei1, bia1, sin=jspec(sin), **kw))


@pytest.mark.parametrize("seed", [0, 1])
def test_emit_acc1_matches_jax_on_image_slots(seed):
    """The raw 1x1 accumulator against JAX's _packed_call(emit_acc1=True):
    equal on the image slots, every lane; 0 on every other slot (the JAX
    kernel computes pad rows like image rows)."""
    top, jop = _acc1_ops(seed, per_oc=bool(seed))
    s = top.sout
    x = np.asarray(J.pack_image(_edge_u8(np.random.default_rng(seed),
                                         (2, 12, 12, 32)), jspec(top.sin)))
    got = top(torch.from_numpy(x), emit_acc1=True).numpy()
    want = np.asarray(J._packed_call(jop.cfg, jop.sins, jop.sout, (x,),
                                     *jop._operands, emit_acc1=True))
    assert got.dtype == np.int32 and got.shape == s.array_shape(2)
    assert want.shape == got.shape
    g, w = (a.reshape(2, s.rows, s.iwp, s.cp) for a in (got, want))
    img = np.zeros(g.shape[:3], bool)
    img[:, s.halo:s.halo + s.h, s.col_off:s.col_off + s.w] = True
    np.testing.assert_array_equal(g[img], w[img])
    assert (g[~img] == 0).all() and (g[img][:, 40:] == 0).all()


@pytest.mark.parametrize("what", ["sum", "pool2", "two inputs", "unfused"])
def test_emit_acc1_refusals(what):
    cfg, _, wei, bia, wei1, bia1 = _cfgs(
        1, 12, 64, 32, oc1=None if what == "unfused" else 32,
        sum_scale=1.0 if what == "sum" else None)
    sin = T.PackedSpec.make(12, 12, 64, halo=2, col_off=2, iwp=16)
    if what == "two inputs":
        sin = (T.PackedSpec.make(12, 12, 32, halo=2, col_off=2, iwp=16),) * 2
    ssum = T.PackedSpec.make(12, 12, 32, halo=2, col_off=2, iwp=16) \
        if what == "sum" else None
    op = T.PackedConvOp(cfg, wei, bia, wei1, bia1, sin=sin, halo_out=2,
                        col_off_out=2, sum_spec=ssum, pool2=what == "pool2",
                        device="cpu")
    xs = [torch.full(s.array_shape(1), -128, dtype=torch.int8)
          for s in op.sins]
    sm = None if ssum is None else torch.full(ssum.array_shape(1), -128,
                                              dtype=torch.int8)
    msg = "needs the fused config" if what == "unfused" else \
        "single input, no sum post-op, no pool2"
    with pytest.raises(CheckError, match=msg):
        op(xs, sm, emit_acc1=True)


def _range_op(halo_in, pool2, with_sum, n_in, seed=0):
    cs = (32,) * n_in
    cfg, _, wei, bia, wei1, bia1 = _cfgs(
        2, 12, sum(cs), 32, oc1=32, per_oc=True, seed=seed,
        sum_scale=0.75 if with_sum else None)
    sins = tuple(T.PackedSpec.make(12, 12, c, halo=halo_in, col_off=2,
                                   iwp=16) for c in cs)
    ssum = T.PackedSpec.make(12, 12, 32, halo=3, col_off=2, iwp=16) \
        if with_sum else None
    return T.PackedConvOp(cfg, wei, bia, wei1, bia1, sin=sins, halo_out=2,
                          col_off_out=2, sum_spec=ssum, pool2=pool2,
                          device="cpu")


@pytest.mark.parametrize("halo_in,pool2,with_sum,n_in",
                         [(1, False, False, 1), (3, False, True, 1),
                          (2, True, False, 2), (4, True, True, 1)])
def test_row_ranges_from_slices_stitch_to_the_output(halo_in, pool2,
                                                     with_sum, n_in):
    """Output row ranges (rows of sout_final), each computed from the
    smallest input row slice that holds its taps (halos deeper than ph and
    equal to it), joined, are the whole output bitwise."""
    op = _range_op(halo_in, pool2, with_sum, n_in)
    rng = np.random.default_rng(halo_in)
    xs = [T.pack_image(torch.from_numpy(_edge_u8(rng, (2, 12, 12, s.c))), s,
                       device="cpu")
          for s in op.sins]
    sm = T.pack_image(torch.from_numpy(_edge_u8(rng, (2, 12, 12, 32))),
                      op.ssum, device="cpu") if with_sum else None
    want = op(xs if n_in > 1 else xs[0], sm)
    so, iwp = op.sout_final, op.sin.iwp
    cuts = [0, 1, 3, so.rows - 2, so.rows]
    parts = []
    for r0, r1 in zip(cuts, cuts[1:]):
        _, _, oy0, oy1 = op._row_plan((r0, r1))
        lo = op.sin.halo + oy0 - 1          # the first row a tap reads
        hi = op.sin.halo + oy1 + 1 if oy1 > oy0 else lo
        sl = [x[:, lo * iwp:hi * iwp] for x in xs]
        parts.append(op(sl if n_in > 1 else sl[0], sm, rows=(r0, r1),
                        row0_off=lo))
        assert parts[-1].shape[1] == (r1 - r0) * so.iwp
    torch.testing.assert_close(torch.cat(parts, dim=1), want, rtol=0, atol=0)


def test_row_range_slice_must_hold_the_taps():
    op = _range_op(1, False, False, 1)
    x = torch.full(op.sin.array_shape(1), -128, dtype=torch.int8)
    iwp = op.sin.iwp
    with pytest.raises(CheckError, match="does not hold every row"):
        op(x[:, 2 * iwp:6 * iwp], rows=(3, 6), row0_off=2)
    with pytest.raises(CheckError, match="outside"):
        op(x, rows=(0, op.sout.rows + 1))


def test_reheight_matches_jax():
    cfg, jcfg, wei, bia, wei1, bia1 = _cfgs(2, 12, 32, 32, oc1=32,
                                            per_oc=True, sum_scale=0.5)
    sin = T.PackedSpec.make(12, 12, 32, halo=2, col_off=2, iwp=16)
    ssum = T.PackedSpec.make(12, 12, 32, halo=3, col_off=2, iwp=16)
    kw = dict(halo_out=2, col_off_out=2, pool2=True)
    top = T.PackedConvOp(cfg, wei, bia, wei1, bia1, sin=sin, sum_spec=ssum,
                         **kw, device="cpu").reheight(6)
    jop = J.PackedConvOp(jcfg, wei, bia, wei1, bia1, sin=jspec(sin),
                         sum_spec=jspec(ssum), **kw).reheight(6)
    assert (jspec(top.sin), jspec(top.sout), jspec(top.ssum)) == \
        (jop.sin, jop.sout, jop.ssum)
    assert (top.cfg.ih, top.cfg.oh) == (jop.cfg.ih, jop.cfg.oh) == (6, 6)
    rng = np.random.default_rng(3)
    x = np.asarray(J.pack_image(_edge_u8(rng, (2, 6, 12, 32)), jop.sin))
    s = np.asarray(J.pack_image(_edge_u8(rng, (2, 6, 12, 32)), jop.ssum))
    np.testing.assert_array_equal(
        top(torch.from_numpy(x), torch.from_numpy(s)).numpy(),
        np.asarray(jop(x, s)))


@pytest.mark.parametrize("case", ["strided", "valid"])
def test_reheight_checks_match_jax(case):
    stride, pad = (2, 1) if case == "strided" else (1, 0)
    cfg, jcfg, wei, bia, *_ = _cfgs(1, 12, 16, 32, stride=stride, pad=pad)
    msg = {"strided": "reheight does not support s2d-lowered strided ops",
           "valid": "reheight requires oh == ih"}[case]
    with pytest.raises(CheckError, match=msg):
        T.PackedConvOp(cfg, wei, bia, device="cpu").reheight(4)
    with pytest.raises(JCheckError, match=msg):
        J.PackedConvOp(jcfg, wei, bia).reheight(4)


def test_pack_image_sharded_matches_jax():
    rng = np.random.default_rng(5)
    src = _edge_u8(rng, (2, 12, 10, 40))
    spec = T.PackedSpec.make(4, 10, 40, halo=2, col_off=2, iwp=16)
    got = T.pack_image_sharded(torch.from_numpy(src), spec, 3, device="cpu")
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(J.pack_image_sharded(src, jspec(spec), 3)))
    np.testing.assert_array_equal(
        T.unpack_image_sharded(got, spec, 3).numpy(), src)
    with pytest.raises(CheckError, match="does not split"):
        T.pack_image_sharded(torch.from_numpy(src), spec, 2, device="cpu")


# ---------------------------------------------------- any count and width
# The JAX package takes any number of packed inputs of any lane width
# (every input but the last with cp == c). The sum/pool kernel takes them
# as they are; the packed conv takes at most MAX_INPUTS of multiples of 16
# lanes, so the port joins groups of consecutive inputs (kernel_groups)
# before its launch.

GROUP_CASES = {
    "fit": ([32, 64, 16, 48], [[0], [1], [2], [3]]),
    "one narrow": ([8], [[0]]),
    "8 + 24": ([8, 24], [[0, 1]]),
    "five of 32": ([32] * 5, [[0], [1], [2], [3, 4]]),
    "six mixed": ([8, 8, 16, 32, 24, 8], [[0, 1], [2], [3], [4, 5]]),
    "nine, narrow tail": ([16] * 8 + [8], [[0], [1], [2],
                                           [3, 4, 5, 6, 7, 8]]),
}


@pytest.mark.parametrize("label", sorted(GROUP_CASES))
def test_kernel_groups(label):
    cps, want = GROUP_CASES[label]
    groups = T.kernel_groups(cps)
    assert [list(g) for g in groups] == want
    assert len(groups) <= T.MAX_INPUTS
    widths = [sum(cps[i] for i in g) for g in groups]
    assert all(w % T.LANE_UNIT == 0 for w in widths[:-1])


# (channels of each input, cp of the last), every other cp == c
MANY_CONV_CASES = {
    "five inputs of 32": ((32, 32, 32, 32, 32), None),
    "8 + 24 lanes": ((8, 24), None),
    "six mixed widths": ((8, 8, 16, 32, 24, 8), None),
    "six mixed, fused": ((8, 8, 16, 32, 16, 8), 16),
}


@pytest.mark.parametrize("label", sorted(MANY_CONV_CASES))
def test_packed_conv_any_inputs_matches_jax(label):
    """Inputs the kernel does not take as they are (more than 4, or lane
    widths no multiple of 16): bitwise against the JAX package, and the
    plain version on the kernel's grouped, joined inputs (the op's
    derived ``kernel_sins``) equals it too; an op built on the joined
    specs has the same K-major weights."""
    cs, last_cp = MANY_CONV_CASES[label]
    fused = "fused" in label
    ic = sum(cs)
    cps = list(cs[:-1]) + [last_cp or cs[-1]]
    specs = tuple(T.PackedSpec.make(10, 10, c, cp=cp, halo=2, col_off=1)
                  for c, cp in zip(cs, cps))
    cfgs = _cfgs(2, 10, ic, 48, oc1=40 if fused else None, seed=ic)
    got, want, op = _run_both(cfgs, specs, halo_out=1)
    np.testing.assert_array_equal(got, want)
    assert len(op.kernel_sins) <= T.MAX_INPUTS
    assert all(s.cp % T.LANE_UNIT == 0 for s in op.kernel_sins)
    assert sum(s.cp for s in op.kernel_sins) == sum(s.cp for s in op.sins)
    rng = np.random.default_rng(ic)
    arrs = [T.pack_image(_u8(rng, 2, s), s, device="cpu") for s in op.sins]
    whole = op(tuple(arrs))
    joined = T.join_groups(arrs, op.kernel_groups)
    assert [tuple(a.shape) for a in joined] == \
        [s.array_shape(2) for s in op.kernel_sins]
    assert torch.equal(T.packed_conv_plain(op, joined), whole)
    cfg, _, wei, bia, wei1, bia1 = cfgs
    jop = T.PackedConvOp(cfg, wei, bia, wei1, bia1, sin=op.kernel_sins,
                         halo_out=1, device="cpu")
    assert torch.equal(jop.w0k, op.w0k) and torch.equal(jop.corr0, op.corr0)
    assert torch.equal(jop(tuple(joined)), whole)


# (channels of each left input, cp of r)
MANY_SUM_POOL_CASES = {
    "five inputs": ((32, 32, 32, 32, 32), None),
    "narrow 8 + 24": ((8, 24), None),
    "narrow 8 + 8, 16 lanes": ((8, 8), None),
    "one input of 8 lanes": ((8,), None),
    "six narrow, padded to 64": ((8, 8, 16, 8, 8, 8), 64),
    "six mixed widths": ((8, 8, 16, 32, 64, 128), None),
    "r of 40 lanes": ((8, 32), None),
}


@pytest.mark.parametrize("label", sorted(MANY_SUM_POOL_CASES))
def test_packed_sum_relu_maxpool2_any_inputs_matches_jax(label):
    """K8 at any input count and lane widths: bitwise against the JAX
    package; the plain version on the inputs as they are (the operands
    the kernel takes: no join, no pad lanes) equals it, and without the
    pool (K6's sum of the lane join) equals the JAX sum of the joined
    image."""
    cs, rcp = MANY_SUM_POOL_CASES[label]
    rng = np.random.default_rng([len(cs), sum(cs)])
    ctot = sum(cs)
    rcp = rcp or ctot
    cps = list(cs[:-1]) + [rcp - sum(cs[:-1])]
    yspecs = [T.PackedSpec.make(8, 12, c, cp=cp, halo=2, col_off=2, iwp=16)
              for c, cp in zip(cs, cps)]
    rspec = T.PackedSpec.make(8, 12, ctot, cp=rcp, halo=2, col_off=2, iwp=16)
    ys = [T.pack_image(_edge_u8(rng, (2, 8, 12, c)), s, device="cpu")
          for c, s in zip(cs, yspecs)]
    r = T.pack_image(_edge_u8(rng, (2, 8, 12, ctot)), rspec, device="cpu")
    got, gspec = T.packed_sum_relu_maxpool2(ys, r, yspecs, rspec)
    want, wspec = J.packed_sum_relu_maxpool2(
        [y.numpy() for y in ys], r.numpy(), [jspec(s) for s in yspecs],
        jspec(rspec))
    assert jspec(gspec) == wspec
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    plain = T.packed_sum_pool_plain(ys, r, True, rspec.rows, rspec.iwp)
    assert torch.equal(plain, got)
    summed = T.packed_sum_pool_plain(ys, r, False, rspec.rows, rspec.iwp)
    want = J.packed_sum_relu(np.concatenate([y.numpy() for y in ys], -1),
                             r.numpy(), jspec(rspec))
    np.testing.assert_array_equal(summed.numpy(), np.asarray(want))


def test_packed_maxpool2_and_sum_relu_of_narrow_lanes_match_jax():
    """K7 (its input padded to 16 lanes for the kernel) and K6 on an image
    of 8 lanes."""
    rng = np.random.default_rng(8)
    spec = T.PackedSpec.make(8, 12, 8, cp=8, halo=2, col_off=2, iwp=16)
    a, b = (T.pack_image(_edge_u8(rng, (2, 8, 12, 8)), spec, device="cpu")
            for _ in range(2))
    got, gspec = T.packed_maxpool2(a, spec)
    want, wspec = J.packed_maxpool2(a.numpy(), jspec(spec))
    assert jspec(gspec) == wspec
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    got = T.packed_sum_relu(a, b, spec)
    want = J.packed_sum_relu(a.numpy(), b.numpy(), jspec(spec))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
