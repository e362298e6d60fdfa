"""The port's conv pair (ops/mega.py) vs the JAX package's, bitwise (CPU).

The same numpy inputs, made from a seed, go through
``deepfusion_tpu.ops.mega.PackedConvPairOp`` (Pallas interpret mode) and
through the port's ``PackedConvPairOp`` (its plain PyTorch version, the two
packed convs' plain versions through the intermediate spec). Whole packed
arrays are compared, pads included. Mirrors tests/test_mega.py.
Tolerance: bitwise.
"""
import json

import numpy as np
import pytest
import torch

import deepfusion_tpu.ops.mega as JM
import deepfusion_tpu.ops.packed as J
from deepfusion_tpu.utils.logger import CheckError as JCheckError
from deepfusion_tpu_torch.ops import mega as TM
from deepfusion_tpu_torch.ops import packed as T
from deepfusion_tpu_torch.utils.logger import CheckError

from test_torch_packed import _cfgs, _edge_u8, jspec

torch.set_num_threads(2)


def _pair(ca, cb, sin=None, **kw):
    """Port and JAX pairs of the layers ca, cb (each a _cfgs tuple)."""
    cfg_a, jcfg_a, *wa = ca
    cfg_b, jcfg_b, *wb = cb
    top = TM.PackedConvPairOp(cfg_a, wa, cfg_b, wb, sin=sin, **kw,
                              device="cpu")
    jop = JM.PackedConvPairOp(jcfg_a, wa, jcfg_b, wb,
                              sin=None if sin is None else jspec(sin), **kw)
    assert (jspec(top.sin), jspec(top.smid), jspec(top.sout)) == \
        (jop.sin, jop.smid, jop.sout)
    if top.pool2:
        assert jspec(top.sout_pooled) == jop.sout_pooled
    return top, jop


def _input(top, n, seed, junk=False):
    rng = np.random.default_rng(seed)
    if junk:
        return rng.integers(-128, 128, top.sin.array_shape(n), dtype=np.int8)
    s = top.sin
    return np.asarray(J.pack_image(_edge_u8(rng, (n, s.h, s.w, s.c)),
                                   jspec(s)))


def _check(top, jop, n=2, seed=0, junk=False):
    x = _input(top, n, seed, junk)
    got = top(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jop(x)))
    s = top.sout_final
    img = got.reshape(n, s.rows, s.iwp, s.cp)
    assert (img[:, :s.halo] == -128).all()
    assert (img[:, s.halo + s.h:] == -128).all()
    assert (img[:, :, :s.col_off] == -128).all()
    assert (img[:, :, s.col_off + s.w:] == -128).all()
    return got


@pytest.mark.parametrize("fused_a,fused_b", [(True, True), (True, False),
                                             (False, True), (False, False)])
def test_pair_matches_jax(fused_a, fused_b):
    ca = _cfgs(2, 12, 32, 32, oc1=32 if fused_a else None, seed=1)
    cb = _cfgs(2, 12, 32, 32, oc1=32 if fused_b else None, seed=2)
    _check(*_pair(ca, cb))


def test_pair_channel_change():
    """a: 32 -> 3x3:48 -> 1x1:64; b: 64 -> 3x3:32 -> 1x1:32."""
    ca = _cfgs(1, 10, 32, 48, oc1=64, seed=3)
    cb = _cfgs(1, 10, 64, 32, oc1=32, seed=4)
    _check(*_pair(ca, cb), n=1)


@pytest.mark.parametrize("fused", [False, True])
def test_pair_round_down_per_oc_scales(fused):
    oc1 = 32 if fused else None
    ca = _cfgs(2, 12, 32, 32, oc1=oc1, rnd="down", per_oc=True, seed=5)
    cb = _cfgs(2, 12, 32, 40, oc1=oc1, rnd="down", per_oc=True, seed=6)
    _check(*_pair(ca, cb))


def test_pair_deep_input_halo():
    """Halo erosion: a deeper input halo, a shallower output halo."""
    ca = _cfgs(1, 12, 32, 32, oc1=32, seed=7)
    cb = _cfgs(1, 12, 32, 32, oc1=32, seed=8)
    sin = T.PackedSpec.make(12, 12, 32, halo=3, col_off=1)
    _check(*_pair(ca, cb, sin=sin, halo_out=1), n=1)


def test_pair_self_chain():
    """sin == sout geometry: the op chains with itself."""
    ca = _cfgs(1, 12, 32, 32, oc1=32, seed=9)
    cb = _cfgs(1, 12, 32, 32, oc1=32, seed=10)
    top, jop = _pair(ca, cb)
    assert jspec(top.sin) == jspec(top.sout)
    x = _input(top, 1, 11)
    got = top(top(torch.from_numpy(x))).numpy()
    np.testing.assert_array_equal(got, np.asarray(jop(jop(x))))


@pytest.mark.parametrize("halo_mid", [0, 1, 3])
def test_pair_intermediate_halo_is_not_semantic(halo_mid):
    """The intermediate is an image: its halo moves the JAX kernel's
    virtual rows, not the result."""
    ca = _cfgs(2, 12, 32, 32, seed=12)
    cb = _cfgs(2, 12, 32, 32, seed=13)
    sin = T.PackedSpec.make(12, 12, 32, halo=3, col_off=2, iwp=24)
    top, jop = _pair(ca, cb, sin=sin, halo_out=1, halo_mid=halo_mid)
    got = _check(top, jop)
    ref, _ = _pair(ca, cb, sin=sin, halo_out=1)
    x = _input(top, 2, 0)
    np.testing.assert_array_equal(got, ref(torch.from_numpy(x)).numpy())


def test_pair_shallow_to_deep_halo():
    """halo_in < halo_out on a tiny image (tests/test_mega.py:322-344):
    the port needs no boundary rolls, so it takes the geometry and equals
    the JAX package's two sequential packed convs."""
    ca = _cfgs(1, 4, 32, 32, seed=14)
    cb = _cfgs(1, 4, 32, 32, seed=15)
    sin = T.PackedSpec.make(4, 4, 32, halo=1, col_off=1, iwp=16)
    top = TM.PackedConvPairOp(ca[0], ca[2:], cb[0], cb[2:], sin=sin,
                              halo_out=2, col_off_out=2, device="cpu")
    j_a = J.PackedConvOp(ca[1], *ca[2:], sin=jspec(sin),
                         halo_out=top.smid.halo,
                         col_off_out=top.smid.col_off)
    j_b = J.PackedConvOp(cb[1], *cb[2:], sin=jspec(top.smid),
                         halo_out=2, col_off_out=2)
    assert j_b.sout == jspec(top.sout)
    x = _input(top, 1, 16)
    np.testing.assert_array_equal(top(torch.from_numpy(x)).numpy(),
                                  np.asarray(j_b(j_a(x))))


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("halo_out", [2, 0])
def test_pair_pool2_matches_jax(fused, halo_out):
    """The fused 2x2/s2 max pool: equal to the JAX pair with pool2 and to
    packed_maxpool2 of the unpooled pair."""
    oc1 = 32 if fused else None
    ca = _cfgs(2, 12, 32, 32, oc1=oc1, seed=17)
    cb = _cfgs(2, 12, 32, 32, oc1=oc1, seed=18)
    sin = T.PackedSpec.make(12, 12, 32, halo=2, col_off=2, iwp=16)
    top, jop = _pair(ca, cb, sin=sin, halo_out=halo_out, col_off_out=2,
                     pool2=True)
    got = _check(top, jop)
    plain, _ = _pair(ca, cb, sin=sin, halo_out=halo_out, col_off_out=2)
    x = torch.from_numpy(_input(top, 2, 0))
    want, wspec = T.packed_maxpool2(plain(x), plain.sout)
    assert wspec == top.sout_pooled
    np.testing.assert_array_equal(got, want.numpy())


@pytest.mark.parametrize("pool2", [False, True])
def test_pair_junk_pads_match_jax(pool2):
    """Random bytes in every input slot: both read the pad slots layer a's
    taps touch exactly as stored."""
    ca = _cfgs(2, 12, 32, 32, seed=19)
    cb = _cfgs(2, 12, 32, 32, oc1=32, seed=20)
    sin = T.PackedSpec.make(12, 12, 32, halo=2, col_off=2, iwp=16)
    _check(*_pair(ca, cb, sin=sin, halo_out=2, col_off_out=2, pool2=pool2),
           junk=True)


@pytest.mark.parametrize("case", ["channels", "stride", "sum", "iwp",
                                  "halo", "pool2 odd col_off"])
def test_pair_validation_matches_jax(case):
    ca = _cfgs(1, 12, 32, 32, oc1=32, seed=21)
    cb = _cfgs(1, 12, 32, 32, seed=22)
    kw = {}
    if case == "channels":
        cb = _cfgs(1, 12, 64, 32, seed=22)
    elif case == "stride":
        ca = cb = _cfgs(1, 12, 32, 32, stride=2, seed=23)
    elif case == "sum":
        cb = _cfgs(1, 12, 32, 32, sum_scale=1.0, seed=22)
    elif case == "iwp":
        kw = dict(sin=T.PackedSpec.make(12, 12, 32, halo=1, col_off=1,
                                        iwp=24))
    elif case == "halo":
        kw = dict(sin=T.PackedSpec.make(12, 12, 32, halo=0, col_off=1))
    else:
        kw = dict(sin=T.PackedSpec.make(12, 12, 32, halo=2, col_off=2,
                                        iwp=16), halo_out=2, col_off_out=1,
                  pool2=True)
    if case == "iwp":
        # the specs share sin's iwp by construction; a hand-made smid differs
        cfg_a, cfg_b = ca[0], cb[0]
        smid = T.PackedSpec.make(12, 12, 32, halo=1, col_off=1, iwp=32)
        with pytest.raises(CheckError, match="one flat row stride"):
            TM.validate_packed_pair(cfg_a, cfg_b, kw["sin"], smid,
                                    T.PackedSpec.make(12, 12, 32, iwp=24))
        with pytest.raises(JCheckError, match="one flat row stride"):
            JM.validate_packed_pair(
                JM._narrow_cfg(ca[1]), JM._narrow_cfg(cb[1]),
                jspec(kw["sin"]), jspec(smid),
                jspec(T.PackedSpec.make(12, 12, 32, iwp=24)))
        return
    with pytest.raises(CheckError) as e:
        TM.PackedConvPairOp(ca[0], ca[2:], cb[0], cb[2:], **kw, device="cpu")
    with pytest.raises(JCheckError) as je:
        JM.PackedConvPairOp(ca[1], ca[2:], cb[1], cb[2:],
                            **{k: jspec(v) if k == "sin" else v
                               for k, v in kw.items()})
    assert str(e.value).split(" (")[0] == str(je.value).split(" (")[0]


@pytest.mark.parametrize("pool2", [False, True])
def test_pair_save_load_roundtrip(tmp_path, pool2):
    ca = _cfgs(1, 12, 32, 32, oc1=32, rnd="down", per_oc=True, seed=24)
    cb = _cfgs(1, 12, 32, 32, seed=25)
    sin = T.PackedSpec.make(12, 12, 32, halo=2, col_off=2, iwp=16)
    top = TM.PackedConvPairOp(ca[0], ca[2:], cb[0], cb[2:], sin=sin,
                              halo_out=2, col_off_out=2, pool2=pool2,
                              device="cpu")
    path = str(tmp_path / "pair.npz")
    top.save(path)
    back = TM.PackedConvPairOp.load(path, device="cpu")
    assert (back.cfg_a, back.cfg_b, back.sin, back.smid, back.sout,
            back.pool2) == (top.cfg_a, top.cfg_b, top.sin, top.smid,
                            top.sout, top.pool2)
    x = torch.from_numpy(_input(top, 1, 26))
    assert torch.equal(back(x), top(x))


@pytest.mark.parametrize("field,value", [("col_off", 3), ("halo", 1)])
def test_pair_load_rejects_tampered_geometry(tmp_path, field, value):
    """A hand-edited pool2 checkpoint whose output geometry the pool cannot
    take fails at load, as the constructor would (ROADMAP C2: the JAX
    package's load skips the pair checks)."""
    ca = _cfgs(1, 12, 32, 32, oc1=32, seed=27)
    cb = _cfgs(1, 12, 32, 32, oc1=32, seed=28)
    sin = T.PackedSpec.make(12, 12, 32, halo=2, col_off=2, iwp=16)
    top = TM.PackedConvPairOp(ca[0], ca[2:], cb[0], cb[2:], sin=sin,
                              halo_out=2, col_off_out=2, pool2=True,
                              device="cpu")
    path = str(tmp_path / "pair.npz")
    top.save(path)
    data = dict(np.load(path, allow_pickle=False))
    cfgs = json.loads(str(data["__cfg__"]))
    cfgs["sout"][field] = value            # pair-legal but pool-illegal
    data["__cfg__"] = np.str_(json.dumps(cfgs))
    np.savez(path, **data)
    with pytest.raises(CheckError, match="maxpool2"):
        TM.PackedConvPairOp.load(path, device="cpu")


def test_pair_load_rejects_bad_pair_geometry(tmp_path):
    ca = _cfgs(1, 12, 32, 32, seed=29)
    cb = _cfgs(1, 12, 32, 32, seed=30)
    top = TM.PackedConvPairOp(ca[0], ca[2:], cb[0], cb[2:], device="cpu")
    path = str(tmp_path / "pair.npz")
    top.save(path)
    data = dict(np.load(path, allow_pickle=False))
    cfgs = json.loads(str(data["__cfg__"]))
    cfgs["sin"]["halo"] = 0
    data["__cfg__"] = np.str_(json.dumps(cfgs))
    np.savez(path, **data)
    with pytest.raises(CheckError, match="input halo too small"):
        TM.PackedConvPairOp.load(path, device="cpu")


def test_pair_plain_is_the_two_packed_convs():
    """pair_conv_plain is op_b(op_a(x)) through the intermediate spec."""
    ca = _cfgs(2, 12, 32, 32, oc1=32, seed=31)
    cb = _cfgs(2, 12, 32, 32, seed=32)
    top = TM.PackedConvPairOp(ca[0], ca[2:], cb[0], cb[2:], device="cpu")
    assert top.op_a.sout == top.smid and top.op_b.sin == top.smid
    x = torch.from_numpy(_input(top, 2, 33))
    assert torch.equal(top(x), top.op_b(top.op_a(x)))


# ------------------------- K10's modes for the sharded wrappers

def _shard_pair(pool2=True, fused_b=False):
    """A 12-row pair with the input halo sp_packed needs (halo_out + ph_a
    + ph_b), and its JAX twin."""
    ca = _cfgs(2, 12, 32, 64, per_oc=True, seed=1)
    cb = _cfgs(2, 12, 64, 32, oc1=48 if fused_b else None, per_oc=True,
               seed=2)
    sin = T.PackedSpec.make(12, 12, 32, halo=4, col_off=2, iwp=16)
    return _pair(ca, cb, sin=sin, halo_out=2, col_off_out=2, pool2=pool2)


@pytest.mark.parametrize("pool2,fused_b", [(True, False), (False, True)])
def test_widened_bounds_give_the_shards_rows(pool2, fused_b):
    """A shard's pair (reheight) on its slab of the whole input, halo band
    holding the neighbours' rows, with the intermediate's bounds widened
    by ph_b on the inside sides, gives the whole pair's output rows of
    the slab; the default bounds would pad there instead."""
    top, _ = _shard_pair(pool2, fused_b)
    x = torch.from_numpy(_input(top, 2, 0))
    want = T.unpack_image(top(x), top.sout_final)
    h, halo, iwp = 6, top.sin.halo, top.sin.iwp
    local = top.reheight(h)
    f = 2 if pool2 else 1
    for j, bounds in ((0, (0, h + 1)), (1, (-1, h))):
        xl = x[:, j * h * iwp:(j * h + h + 2 * halo) * iwp]
        got = T.unpack_image(local(xl, mid_bounds=bounds),
                             local.sout_final)
        np.testing.assert_array_equal(
            got.numpy(), want[:, j * h // f:(j + 1) * h // f].numpy())
        plain = T.unpack_image(local(xl), local.sout_final)
        assert not torch.equal(plain, got)


def test_pair_row_ranges_from_slices_stitch_to_the_output():
    """Row ranges of a shard's pair, each from the input rows its layer a
    reads (bounds widened on both sides), join to the full-call output."""
    top, _ = _shard_pair(pool2=True)
    local = top.reheight(6)
    x = torch.from_numpy(_input(local, 2, 4))
    bounds = (-1, 7)
    want = local(x, mid_bounds=bounds)
    so, iwp, halo = local.sout_final, local.sin.iwp, local.sin.halo
    parts = []
    cuts = [0, 2, 4, so.rows]
    for r0, r1 in zip(cuts, cuts[1:]):
        y0, y1 = local._mid_rows((r0, r1), bounds)
        lo = halo + y0 - 1
        hi = halo + y1 + 1 if y1 > y0 else lo
        parts.append(local(x[:, lo * iwp:hi * iwp], rows=(r0, r1),
                           row0_off=lo, mid_bounds=bounds))
    torch.testing.assert_close(torch.cat(parts, dim=1), want, rtol=0,
                               atol=0)
    with pytest.raises(CheckError, match="does not hold every row"):
        local(x[:, (halo - 1) * iwp:(halo + 3) * iwp], rows=(0, 2),
              row0_off=halo - 1, mid_bounds=bounds)


def test_pair_reheight_matches_jax():
    top, jop = _shard_pair(pool2=True)
    tl, jl = top.reheight(6), jop.reheight(6)
    assert (jspec(tl.sin), jspec(tl.smid), jspec(tl.sout)) == \
        (jl.sin, jl.smid, jl.sout)
    x = _input(tl, 2, 5)
    np.testing.assert_array_equal(tl(torch.from_numpy(x)).numpy(),
                                  np.asarray(jl(x)))


def test_pair_reheight_check_matches_jax():
    ca = _cfgs(1, 12, 32, 32, pad=0, seed=1)
    cb = _cfgs(1, 10, 32, 32, seed=2)
    top, jop = _pair(ca, cb)
    msg = "reheight requires oh == ih on layer a"
    with pytest.raises(CheckError, match=msg):
        top.reheight(6)
    with pytest.raises(JCheckError, match=msg):
        jop.reheight(6)
