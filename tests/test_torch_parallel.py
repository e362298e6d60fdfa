"""Sharded wrappers of the PyTorch port (``deepfusion_tpu_torch.parallel``),
bitwise (CPU).

Every wrapper runs on a mesh whose slots are all the CPU
(``make_mesh(..., devices=[cpu] * n)``), each shard through the port's
plain versions, and must give the single-device op's bits: int32 adds are
exact in any order and halo rows replace padding exactly. A few cases are
also held against the JAX wrappers on the 8 virtual CPU devices that
``tests/conftest.py`` sets up (Pallas interpret mode, so only a handful).
Each shard's output must lie on its slot's device. Tolerance: bitwise.
"""
import numpy as np
import pytest
import torch

import deepfusion_tpu.parallel as JP
from deepfusion_tpu.config import ConvConfig as JConvConfig
from deepfusion_tpu.ops.conv import ConvOp as JConvOp
from deepfusion_tpu.ops.packed import PackedConvOp as JPackedConvOp
from deepfusion_tpu.ops.packed import pack_image_sharded as jpack_sharded
from deepfusion_tpu.utils.logger import CheckError as JCheckError
from deepfusion_tpu_torch.config import ConvConfig, PoolConfig
from deepfusion_tpu_torch.ops.conv import ConvOp
from deepfusion_tpu_torch.ops.convpool import ConvPoolOp
from deepfusion_tpu_torch.ops.mega import PackedConvPairOp
from deepfusion_tpu_torch.ops.packed import (PackedConvOp, PackedSpec,
                                             pack_image, pack_image_sharded,
                                             unpack_image,
                                             unpack_image_sharded)
from deepfusion_tpu_torch.parallel import (dp_shard, factorize_mesh,
                                           make_mesh, sp_conv, sp_packed,
                                           tp_fused_conv, tp_packed_fused)
from deepfusion_tpu_torch.parallel.plan import three_stage_plan
from deepfusion_tpu_torch.parallel.shard import tp_wire_bytes
from deepfusion_tpu_torch.utils.logger import CheckError

from test_torch_packed import _cfgs, _edge_u8, jspec

torch.set_num_threads(2)
CPU = torch.device("cpu")


def cpu_mesh(dp=1, sp=1, tp=1):
    return make_mesh(dp, sp, tp, devices=[CPU] * (dp * sp * tp))


def jmesh(dp=1, sp=1, tp=1):
    return JP.make_mesh(dp=dp, sp=sp, tp=tp)


def fused(mb=4, ic=16, hw=12, oc=32, oc1=16, ph=1, sw=1, seed=0,
          with_sum=False):
    """(port cfg, JAX cfg, src, wei, bia, wei1, bia1[, sum]) of a fused
    conv3x3+1x1 with a u8 output, tests/test_parallel.py's geometry."""
    rng = np.random.default_rng(seed)
    src = _edge_u8(rng, (mb, hw, hw, ic))
    wei = rng.integers(-128, 128, (oc, ic, 3, 3)).astype(np.int8)
    bia = rng.integers(-20000, 20000, (oc,)).astype(np.int32)
    wei1 = rng.integers(-128, 128, (oc1, oc, 1, 1)).astype(np.int8)
    bia1 = rng.integers(-20000, 20000, (oc1,)).astype(np.int32)
    oh, ow = hw + 2 * ph - 2, (hw + 2 * ph - 3) // sw + 1
    args = ((mb, hw, hw, ic), (oc, ic, 3, 3), bia.dtype, (1, sw), (ph, ph),
            (mb, oh, ow, oc1), "u8")
    kw = dict(conv0_scales=(rng.uniform(0.5, 1.5, oc) / (9 * ic * 40)
                            ).astype(np.float32),
              wei1x1_shape=(oc1, oc, 1, 1), bia1x1_dt=bia1.dtype,
              conv1_relu=True, conv1_scales=(0.4 / (oc * 40),))
    if with_sum:
        kw.update(sum_dt="u8", sum_scale=0.5)
    out = [ConvConfig.make(*args, **kw), JConvConfig.make(*args, **kw), src,
           wei, bia, wei1, bia1]
    if with_sum:
        out.append(_edge_u8(rng, (mb, oh, ow, oc1)))
    return out


def _shard_devices(fn, *args):
    outs = fn.shards(*args)
    flat = [o for row in outs for o in row] if isinstance(outs[0], list) \
        else outs
    assert flat and all(o.device == CPU for o in flat)


# ---------------------------------------------------------------- mesh

def test_make_mesh_needs_devices():
    mesh = cpu_mesh(2, 2, 2)
    assert mesh.shape == {"dp": 2, "sp": 2, "tp": 2}
    assert mesh.device(sp=1) == CPU and mesh.devices.shape == (2, 2, 2)
    if torch.cuda.device_count() < 64:
        with pytest.raises(ValueError, match="need 64 devices"):
            make_mesh(dp=64)
    with pytest.raises(ValueError, match="need 4 devices, have 2"):
        make_mesh(2, 2, devices=[CPU] * 2)


def test_factorize_mesh_matches_jax():
    for n in range(1, 33):
        assert factorize_mesh(n) == JP.factorize_mesh(n)


# ------------------------------------------------------------------ DP

def test_dp_shard_conv_ops():
    cfg, _, src, wei, bia, wei1, bia1 = fused(mb=4)
    op = ConvOp(cfg, wei, bia, wei1, bia1, device="cpu")
    fn = dp_shard(op, cpu_mesh(dp=2))
    x = torch.from_numpy(src)
    assert torch.equal(fn(x), op(x))
    _shard_devices(fn, x)
    cfg, _, src, wei, bia, wei1, bia1 = fused(mb=4, sw=2, seed=1)
    op = ConvOp(cfg, wei, bia, wei1, bia1, device="cpu")
    assert torch.equal(dp_shard(op, cpu_mesh(dp=4))(torch.from_numpy(src)),
                       op(torch.from_numpy(src)))


def test_dp_shard_conv_sum_and_convpool():
    cfg, _, src, wei, bia, wei1, bia1, sm = fused(mb=4, with_sum=True)
    op = ConvOp(cfg, wei, bia, wei1, bia1, device="cpu")
    x, s = torch.from_numpy(src), torch.from_numpy(sm)
    assert torch.equal(dp_shard(op, cpu_mesh(dp=2))(x, s), op(x, sum_src=s))
    rng = np.random.default_rng(3)
    c = ConvConfig.make((4, 8, 8, 16), (32, 16, 3, 3), np.int32, (1, 1),
                        (1, 1), (4, 8, 8, 32), "u8", conv0_relu=True,
                        conv0_scales=(1 / 6000,))
    pop = ConvPoolOp(c, PoolConfig.make("max", (8, 8), (2, 2), (2, 2),
                                        (0, 0)),
                     rng.integers(-128, 128, (32, 16, 3, 3)).astype(np.int8),
                     rng.integers(-5000, 5000, (32,)).astype(np.int32),
                     device="cpu")
    x = torch.from_numpy(_edge_u8(rng, (4, 8, 8, 16)))
    assert torch.equal(dp_shard(pop, cpu_mesh(dp=2))(x), pop(x))


def test_dp_shard_packed_multi_input_sum_and_pair():
    cfg, _, wei, bia, wei1, bia1 = _cfgs(4, 8, 64, 32, oc1=32,
                                         sum_scale=0.75, per_oc=True)
    sins = (PackedSpec.make(8, 8, 32, halo=1, col_off=1),) * 2
    ssum = PackedSpec.make(8, 8, 32, halo=2, col_off=1)
    op = PackedConvOp(cfg, wei, bia, wei1, bia1, sin=sins, sum_spec=ssum,
                      device="cpu")
    rng = np.random.default_rng(4)
    xs = [pack_image(torch.from_numpy(_edge_u8(rng, (4, 8, 8, 32))), s,
                     device="cpu")
          for s in sins]
    s = pack_image(torch.from_numpy(_edge_u8(rng, (4, 8, 8, 32))), ssum,
                   device="cpu")
    fn = dp_shard(op, cpu_mesh(dp=2))
    assert torch.equal(fn(xs, s), op(xs, s))
    _shard_devices(fn, xs, s)
    ca = _cfgs(4, 12, 32, 32, seed=1)
    cb = _cfgs(4, 12, 32, 32, seed=2)
    sin = PackedSpec.make(12, 12, 32, halo=2, col_off=2, iwp=16)
    pair = PackedConvPairOp(ca[0], ca[2:], cb[0], cb[2:], sin=sin,
                            halo_out=2, col_off_out=2, pool2=True,
                            device="cpu")
    x = pack_image(torch.from_numpy(_edge_u8(rng, (4, 12, 12, 32))), sin,
                   device="cpu")
    assert torch.equal(dp_shard(pair, cpu_mesh(dp=2))(x), pair(x))


def test_dp_shard_fail_fast():
    cfg, _, src, wei, bia, wei1, bia1 = fused(mb=3)
    with pytest.raises(CheckError, match="batch 3 not divisible by dp"):
        dp_shard(ConvOp(cfg, wei, bia, wei1, bia1,
                        device="cpu"), cpu_mesh(dp=2))
    with pytest.raises(CheckError, match="does not support Linear"):
        dp_shard(torch.nn.Linear(2, 2), cpu_mesh(dp=2))


# ------------------------------------------------------------------ TP

@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("wire", ["psum", "reduce_scatter"])
def test_tp_fused_conv_bitwise(n, wire):
    cfg, _, src, wei, bia, wei1, bia1 = fused(oc=16 * n, seed=n)
    want = ConvOp(cfg, wei, bia, wei1, bia1,
                  device="cpu")(torch.from_numpy(src))
    fn = tp_fused_conv(cfg, wei, bia, wei1, bia1, cpu_mesh(tp=n), wire=wire)
    assert torch.equal(fn(torch.from_numpy(src)), want)
    _shard_devices(fn, torch.from_numpy(src))


def test_tp_fused_conv_pads_the_scatter_lanes():
    """oc1x1 = 10 over 4 shards: the scatter pads the lanes to 12."""
    cfg, _, src, wei, bia, wei1, bia1 = fused(oc=32, oc1=10, seed=7)
    want = ConvOp(cfg, wei, bia, wei1, bia1,
                  device="cpu")(torch.from_numpy(src))
    got = tp_fused_conv(cfg, wei, bia, wei1, bia1, cpu_mesh(tp=4))(
        torch.from_numpy(src))
    assert torch.equal(got, want)


@pytest.mark.parametrize("wire", ["psum", "reduce_scatter"])
def test_tp_fused_conv_matches_jax(wire):
    cfg, jcfg, src, wei, bia, wei1, bia1 = fused(seed=11)
    want = np.asarray(JP.tp_fused_conv(jcfg, wei, bia, wei1, bia1,
                                       jmesh(tp=2), wire=wire)(src))
    got = tp_fused_conv(cfg, wei, bia, wei1, bia1, cpu_mesh(tp=2),
                        wire=wire)(torch.from_numpy(src))
    np.testing.assert_array_equal(got.numpy(), want)


def test_tp_wire_bytes_accounting():
    cfg, *_ = fused()
    ps = tp_wire_bytes(cfg, 4, "psum")
    rs = tp_wire_bytes(cfg, 4, "reduce_scatter")
    assert ps / rs == pytest.approx(8 / 5)


def _packed_tp_op(n, oc1=40, seed=0):
    cfg, jcfg, wei, bia, wei1, bia1 = _cfgs(2, 10, 32, 16 * n, oc1=oc1,
                                            per_oc=True, seed=seed)
    sin = PackedSpec.make(10, 10, 32, halo=2, col_off=2, iwp=16)
    kw = dict(halo_out=1, col_off_out=2)
    op = PackedConvOp(cfg, wei, bia, wei1, bia1, sin=sin, **kw, device="cpu")
    jop = JPackedConvOp(jcfg, wei, bia, wei1, bia1, sin=jspec(sin), **kw)
    x = pack_image(torch.from_numpy(_edge_u8(np.random.default_rng(seed),
                                             (2, 10, 10, 32))), sin,
                   device="cpu")
    return op, jop, x


@pytest.mark.parametrize("n", [2, 3, 4])
@pytest.mark.parametrize("wire", ["psum", "reduce_scatter"])
def test_tp_packed_fused_bitwise(n, wire):
    op, _, x = _packed_tp_op(n, seed=n)
    fn = tp_packed_fused(op, cpu_mesh(tp=n), wire=wire)
    assert torch.equal(fn(x), op(x))
    _shard_devices(fn, x)


@pytest.mark.parametrize("wire", ["psum", "reduce_scatter"])
def test_tp_packed_fused_matches_jax(wire):
    op, jop, x = _packed_tp_op(2, seed=5)
    want = np.asarray(JP.tp_packed_fused(jop, jmesh(tp=2), wire=wire)(
        x.numpy()))
    np.testing.assert_array_equal(
        tp_packed_fused(op, cpu_mesh(tp=2), wire=wire)(x).numpy(), want)


@pytest.mark.parametrize("case", ["unfused", "sum", "pool2", "two inputs",
                                  "wire", "oc", "type"])
def test_tp_fail_fast_matches_jax(case):
    """Each refusal with the JAX package's message, from both packages."""
    kw = {}
    sins = (PackedSpec.make(12, 12, 32, halo=2, col_off=2, iwp=32),)
    if case == "two inputs":
        sins = sins * 2
    cfg, jcfg, wei, bia, wei1, bia1 = _cfgs(
        1, 12, 32 * len(sins), 32, oc1=None if case == "unfused" else 32,
        sum_scale=0.5 if case == "sum" else None)
    ssum = PackedSpec.make(12, 12, 32, halo=2, col_off=2, iwp=32) \
        if case == "sum" else None
    mk = dict(halo_out=2, col_off_out=2, pool2=case == "pool2")
    op = PackedConvOp(cfg, wei, bia, wei1, bia1, sin=sins, sum_spec=ssum,
                      **mk, device="cpu")
    jop = JPackedConvOp(jcfg, wei, bia, wei1, bia1,
                        sin=tuple(jspec(s) for s in sins),
                        sum_spec=None if ssum is None else jspec(ssum), **mk)
    n = 2
    if case == "wire":
        kw["wire"] = "ring"
    if case == "oc":
        n = 3
    msg = {"unfused": "needs the fused config",
           "sum": "single input, no sum post-op, no pool2",
           "pool2": "single input, no sum post-op, no pool2",
           "two inputs": "single input, no sum post-op, no pool2",
           "wire": "unknown tp wire 'ring'",
           "oc": "oc 32", "type": "needs a PackedConvOp"}[case]
    if case == "type":
        op, jop = ConvOp(fused()[0], *fused()[3:7], device="cpu"), object()
    with pytest.raises(CheckError, match=msg):
        tp_packed_fused(op, cpu_mesh(tp=n), **kw)
    with pytest.raises(JCheckError, match=msg):
        JP.tp_packed_fused(jop, jmesh(tp=n), **kw)


# ------------------------------------------------------------------ SP

@pytest.mark.parametrize("n,ph,sw,with_sum",
                         [(2, 1, 1, False), (4, 1, 1, False),
                          (2, 0, 1, False), (4, 0, 1, False),
                          (2, 1, 2, False), (2, 1, 1, True)])
def test_sp_conv_bitwise(n, ph, sw, with_sum):
    """SAME and VALID padding, strided W, the sum post-op."""
    got = fused(hw=16, ph=ph, sw=sw, with_sum=with_sum, seed=n + ph)
    cfg, _, src, wei, bia, wei1, bia1 = got[:7]
    op = ConvOp(cfg, wei, bia, wei1, bia1, device="cpu")
    x = torch.from_numpy(src)
    args = (x,) if not with_sum else (x, torch.from_numpy(got[7]))
    fn = sp_conv(op, cpu_mesh(sp=n))
    want = op(x) if not with_sum else op(x, sum_src=args[1])
    assert torch.equal(fn(*args), want)
    _shard_devices(fn, *args)


def test_sp_conv_dp_axis():
    cfg, _, src, wei, bia, wei1, bia1 = fused(mb=4, hw=12, seed=9)
    op = ConvOp(cfg, wei, bia, wei1, bia1, device="cpu")
    x = torch.from_numpy(src)
    fn = sp_conv(op, cpu_mesh(dp=2, sp=2), dp_axis="dp")
    assert torch.equal(fn(x), op(x))


def test_sp_conv_matches_jax():
    cfg, jcfg, src, wei, bia, wei1, bia1 = fused(hw=12, seed=12)
    want = np.asarray(JP.sp_conv(JConvOp(jcfg, wei, bia, wei1, bia1),
                                 jmesh(sp=2))(src))
    got = sp_conv(ConvOp(cfg, wei, bia, wei1, bia1,
                         device="cpu"), cpu_mesh(sp=2))(
        torch.from_numpy(src))
    np.testing.assert_array_equal(got.numpy(), want)


def test_sp_conv_fail_fast_matches_jax():
    cfg, jcfg, src, wei, bia, wei1, bia1 = fused(hw=12)
    pc = PoolConfig.make("max", (12, 12), (2, 2), (2, 2), (0, 0))
    c = ConvConfig.make((4, 12, 12, 16), (32, 16, 3, 3), np.int32, (1, 1),
                        (1, 1), (4, 12, 12, 32), "u8")
    msg = "sp_conv supports ConvOp \\(got ConvPoolOp\\)"
    with pytest.raises(CheckError, match=msg):
        sp_conv(ConvPoolOp(c, pc, wei, bia, device="cpu"), cpu_mesh(sp=2))
    with pytest.raises(CheckError, match="ih 12 not divisible by sp"):
        sp_conv(ConvOp(cfg, wei, bia, wei1, bia1,
                       device="cpu"), cpu_mesh(sp=5))
    with pytest.raises(JCheckError, match="ih 12 not divisible by sp"):
        JP.sp_conv(JConvOp(jcfg, wei, bia, wei1, bia1), jmesh(sp=5))


def _sp_packed_check(op, n_shard, dp=1, seed=0, with_sum=False):
    """sp_packed(op) must give the single-device op's image rows (the
    sharded format drops only the shards' halo bands)."""
    rng = np.random.default_rng(seed)
    mb = op.sin.array_shape(2)[0] * dp
    imgs = [torch.from_numpy(_edge_u8(rng, (mb, s.h, s.w, s.c)))
            for s in (op.sins if isinstance(op, PackedConvOp)
                      else (op.sin,))]
    xg = [pack_image(i, s, device="cpu") for i, s in zip(
        imgs, op.sins if isinstance(op, PackedConvOp) else (op.sin,))]
    sm = None
    args = []
    fn = sp_packed(op, cpu_mesh(dp=dp, sp=n_shard),
                   dp_axis="dp" if dp > 1 else None)
    xs = [pack_image_sharded(i, s, n_shard, device="cpu")
          for i, s in zip(imgs, fn.local_specs)]
    if with_sum:
        simg = torch.from_numpy(_edge_u8(rng, (mb, op.ssum.h, op.ssum.w,
                                               op.ssum.c)))
        sm = pack_image(simg, op.ssum, device="cpu")
        from dataclasses import replace
        args = [pack_image_sharded(simg, replace(op.ssum,
                                                 h=op.ssum.h // n_shard),
                                   n_shard, device="cpu")]
    src = xg if len(xg) > 1 else xg[0]
    want = op(src, sm) if with_sum else op(src)
    want_img = unpack_image(want, op.sout_final)
    got = fn(xs if len(xs) > 1 else xs[0], *args)
    got_img = unpack_image_sharded(got, fn.local_out_spec, n_shard)
    assert torch.equal(got_img, want_img)
    outs = fn.shards(xs if len(xs) > 1 else xs[0], *args)
    assert all(o.device == CPU for row in outs for o in row)
    return fn, xs, args


def _conv_op(hw=16, halo=1, pool2=False, oc1=32, seed=0, iwp=None):
    cfg, _, wei, bia, wei1, bia1 = _cfgs(2, hw, 32, 32, oc1=oc1,
                                         per_oc=True, seed=seed)
    sin = PackedSpec.make(hw, hw, 32, halo=halo, col_off=2, iwp=iwp)
    return PackedConvOp(cfg, wei, bia, wei1, bia1, sin=sin,
                        halo_out=2 if pool2 else 1, col_off_out=2,
                        pool2=pool2, device="cpu")


@pytest.mark.parametrize("n,halo", [(2, 1), (4, 1), (2, 3), (4, 2)])
def test_sp_packed_conv_bitwise(n, halo):
    """Input halos equal to ph and deeper."""
    _sp_packed_check(_conv_op(halo=halo, seed=n), n)


def test_sp_packed_conv_pool2_and_dp():
    _sp_packed_check(_conv_op(halo=2, pool2=True, iwp=32), 2, dp=2)
    _sp_packed_check(_conv_op(hw=24, halo=2, pool2=True, iwp=32), 4)


def test_sp_packed_sum_and_multi_input():
    cfg, _, wei, bia, wei1, bia1 = _cfgs(2, 16, 64, 32, oc1=32, per_oc=True,
                                         sum_scale=0.75)
    sins = (PackedSpec.make(16, 16, 32, halo=1, col_off=1),) * 2
    ssum = PackedSpec.make(16, 16, 32, halo=2, col_off=1)
    op = PackedConvOp(cfg, wei, bia, wei1, bia1, sin=sins, sum_spec=ssum,
                      device="cpu")
    for n in (2, 4):
        _sp_packed_check(op, n, seed=n, with_sum=True)


def _pair_op(hw=16, halo=4, pool2=True, seed=0, iwp=32):
    ca = _cfgs(2, hw, 32, 64, per_oc=True, seed=seed)
    cb = _cfgs(2, hw, 64, 32, per_oc=True, seed=seed + 1)
    sin = PackedSpec.make(hw, hw, 32, halo=halo, col_off=2, iwp=iwp)
    return PackedConvPairOp(ca[0], ca[2:], cb[0], cb[2:], sin=sin,
                            halo_out=2 if pool2 else 1, col_off_out=2,
                            pool2=pool2, device="cpu")


@pytest.mark.parametrize("n,pool2", [(2, True), (4, True), (2, False)])
def test_sp_packed_pair_bitwise(n, pool2):
    _sp_packed_check(_pair_op(pool2=pool2, halo=4 if pool2 else 3, seed=n),
                     n)


def test_sp_packed_pair_matches_jax():
    """The pair with pool2 at sp=2, against the JAX wrapper's array (the
    whole sharded array, halo bands included)."""
    import dataclasses
    ca = _cfgs(2, 12, 32, 32, seed=1)
    cb = _cfgs(2, 12, 32, 32, seed=2)
    sin = PackedSpec.make(12, 12, 32, halo=4, col_off=2, iwp=16)
    kw = dict(sin=sin, halo_out=2, col_off_out=2, pool2=True)
    pair = PackedConvPairOp(ca[0], ca[2:], cb[0], cb[2:], **kw, device="cpu")
    from deepfusion_tpu.ops.mega import PackedConvPairOp as JPair
    jpair = JPair(ca[1], ca[2:], cb[1], cb[2:],
                  **{**kw, "sin": jspec(sin)})
    fn = sp_packed(pair, cpu_mesh(sp=2))
    jfn = JP.sp_packed(jpair, jmesh(sp=2))
    assert jspec(fn.local_spec) == jfn.local_spec
    assert jspec(fn.local_out_spec) == jfn.local_out_spec
    img = _edge_u8(np.random.default_rng(8), (2, 12, 12, 32))
    xs = pack_image_sharded(torch.from_numpy(img), fn.local_spec, 2,
                            device="cpu")
    jxs = np.asarray(jpack_sharded(img, jfn.local_spec, 2))
    np.testing.assert_array_equal(xs.numpy(), jxs)
    np.testing.assert_array_equal(fn(xs).numpy(), np.asarray(jfn(jxs)))
    assert dataclasses.replace(fn.local_spec, h=12) == sin


def test_sp_packed_fail_fast_matches_jax():
    pair = _pair_op(halo=2)
    msg = "sp_packed pair requires roll-free erosion geometry"
    with pytest.raises(CheckError, match=msg):
        sp_packed(pair, cpu_mesh(sp=2))
    ca = _cfgs(2, 16, 32, 64, per_oc=True)
    cb = _cfgs(2, 16, 64, 32, per_oc=True, seed=1)
    from deepfusion_tpu.ops.mega import PackedConvPairOp as JPair
    jpair = JPair(ca[1], ca[2:], cb[1], cb[2:],
                  sin=jspec(PackedSpec.make(16, 16, 32, halo=2, col_off=2,
                                            iwp=32)),
                  halo_out=2, col_off_out=2, pool2=True)
    with pytest.raises(JCheckError, match=msg):
        JP.sp_packed(jpair, jmesh(sp=2))
    with pytest.raises(CheckError, match="image height 16 not divisible"):
        sp_packed(_conv_op(), cpu_mesh(sp=3))
    with pytest.raises(CheckError, match="sp_packed supports"):
        sp_packed(ConvOp(fused()[0], *fused()[3:7],
                         device="cpu"), cpu_mesh(sp=2))
    with pytest.raises(CheckError, match="shard height 1 below"):
        sp_packed(_pair_op(hw=8, pool2=False, halo=3), cpu_mesh(sp=8))


# ---------------------------------------------------------------- plan

def _plan(mesh, jax_side=False):
    mb, hw, ic, oc, oc1 = 4, 16, 16, 32, 32
    src = np.random.default_rng(1234).integers(
        0, 17, (mb, hw, hw, ic)).astype(np.uint8)
    if jax_side:
        from deepfusion_tpu.parallel.plan import three_stage_plan as jplan
        step, _, _ = jplan(mesh, mb, hw, ic, oc, oc1,
                           rng=np.random.default_rng(7))
        return np.asarray(step(src))
    step, _, _ = three_stage_plan(mesh, mb, hw, ic, oc, oc1,
                                  rng=np.random.default_rng(7))
    out = step(torch.from_numpy(src))
    assert out.shape == (mb, hw // 2, hw // 2, oc1)
    return out.numpy()


def test_three_stage_plan_mesh_invariant():
    outs = [_plan(cpu_mesh(*m)) for m in ((1, 1, 1), (2, 2, 2), (1, 2, 4),
                                          (4, 1, 2))]
    for o in outs[1:]:
        np.testing.assert_array_equal(o, outs[0])


@pytest.mark.parametrize("m", [(1, 1, 1), (2, 2, 2)])
def test_three_stage_plan_matches_jax(m):
    np.testing.assert_array_equal(_plan(cpu_mesh(*m)),
                                  _plan(jmesh(*m), jax_side=True))
