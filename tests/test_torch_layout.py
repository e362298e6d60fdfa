"""The algebra the packed conv kernel (``csrc/packed_conv.cu``) relies on.

The kernel multiplies the stored packed bytes read as s8 (u8 - 128, pads
and junk pad bytes included) by K-major copies of the weights that the op
derives once (``layout.kmajor_weights``), and adds the exact correction
``128 * sum(w0)`` per output channel (``layout.u8_shift_correction``, the
JAX package's device). These tests hold, on the CPU:

* the port's correction against ``deepfusion_tpu.ops.layout.
  u8_shift_correction`` on the same OIHW weights (the two packings order
  K differently; the sums over K must not differ): bitwise;
* the derived K-major matrices against the OIHW weights, K in the order
  the kernel walks (tap, then each source's lanes padded to 32): bitwise;
* a float64 emulation of the kernel's arithmetic (s8 bytes times the
  derived weights, plus the correction; the fused 1x1 on the plain u8
  intermediate) against the u8 accumulators of the plain version
  (``ops/packed.py:_stage_plain``, the 3x3 captured at its requant, the 1x1
  through ``emit_acc1``): bitwise, with random bytes in every pad slot.
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import deepfusion_tpu.ops.layout as JL
from deepfusion_tpu.config import ConvConfig as JConvConfig
from deepfusion_tpu_torch.config import ConvConfig
from deepfusion_tpu_torch.ops import layout
from deepfusion_tpu_torch.ops import packed as T
from deepfusion_tpu_torch.utils.mathutil import conv_output_size

torch.set_num_threads(2)

# name: (hw, input channels per source (cp = c unless given), oc, k,
#        stride, oc1 of the fused 1x1 or None)
CASES = {
    "3x3": (9, [64], 64, 3, 1, None),
    "5x5 pad lanes": (9, [40], 40, 5, 1, None),
    "1x1 three inputs": (7, [32, 64, 48], 64, 1, 1, None),
    "3x3 four inputs, one of 16 lanes": (7, [32, (16, 16), 64, (48, 48)],
                                         72, 3, 1, None),
    "fused 3x3 pad lanes": (8, [40], 72, 3, 1, 40),
    "s2d stem 3x3/s2": (12, [3], 32, 3, 2, None),
}


def _build(name, seed=0):
    """(port op, OIHW weights of the conv the op runs (on the s2d grid for
    a strided case), the 1x1's OIHW weights or None)."""
    hw, srcs, oc, k, s, oc1 = CASES[name]
    rng = np.random.default_rng(seed)
    cs = [c if isinstance(c, int) else c[0] for c in srcs]
    ic, p = sum(cs), k // 2
    o = conv_output_size(hw, k, s, p)
    wei = rng.integers(-128, 128, (oc, ic, k, k)).astype(np.int8)
    bia = rng.integers(-5000, 5000, (oc,)).astype(np.int32)
    kw = dict(conv0_relu=True, conv0_scales=(1.0 / (k * k * ic * 60),))
    wei1 = bia1 = None
    if oc1 is not None:
        wei1 = rng.integers(-128, 128, (oc1, oc, 1, 1)).astype(np.int8)
        bia1 = rng.integers(-5000, 5000, (oc1,)).astype(np.int32)
        kw.update(wei1x1_shape=(oc1, oc, 1, 1), bia1x1_dt=np.int32,
                  conv1_relu=True, conv1_scales=(1.0 / (oc * 60),))
    args = ((2, hw, hw, ic), (oc, ic, k, k), np.int32, (s, s), (p, p),
            (2, o, o, oc1 or oc), "u8")
    cfg = ConvConfig.make(*args, **kw)
    sin = None
    if s == 1:
        sin = tuple(T.PackedSpec.make(hw, hw, c if isinstance(c, int)
                                      else c[0],
                                      cp=None if isinstance(c, int) else c[1],
                                      halo=k // 2 + 1, col_off=k // 2 + 1)
                    for c in srcs)
    op = T.PackedConvOp(cfg, wei, bia, wei1, bia1, sin=sin, device="cpu")
    eff = wei
    if s > 1:   # the JAX package's own s2d weights, an independent source
        eff = JL.s2d_weights(JConvConfig.make(*args, **kw), wei)
    return op, eff, wei1


def _junk(op, n, seed):
    """Random bytes in every slot of every input, pads included."""
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.integers(-128, 128, s.array_shape(n),
                                          dtype=np.int64).astype(np.int8))
            for s in op.sins]


@pytest.mark.parametrize("name", list(CASES))
def test_u8_shift_correction_matches_jax(name):
    op, eff, _ = _build(name)
    cfg = op.cfg
    icp = layout.conv_icp(cfg.ic)
    want = JL.u8_shift_correction(JL.pack_conv_weights(eff, icp, cfg.oc))
    got = op.corr0.numpy()
    assert got.dtype == np.int32   # numpy's sum widens the JAX one
    np.testing.assert_array_equal(got[:cfg.oc], want)
    assert not got[cfg.oc:].any()
    # with the 1x1's words too: the correction of any K-major matrix is the
    # JAX one of the same weights
    if op.w1k is not None:
        w1 = JL.pack_1x1_weights(_build(name)[2], cfg.oc, cfg.oc1x1)
        np.testing.assert_array_equal(
            layout.u8_shift_correction(op.w1k).numpy()[:cfg.oc1x1],
            JL.u8_shift_correction(w1))


@pytest.mark.parametrize("name", list(CASES))
def test_kmajor_weights_match_oihw(name):
    op, eff, wei1 = _build(name)
    cfg = op.cfg
    ocp = layout.packed_cp(cfg.oc)
    kp = sum(layout.source_k(s.cp) for s in op.sins)
    w0k = op.w0k.numpy()
    assert w0k.dtype == np.int8
    assert w0k.shape == (ocp, cfg.kh * cfg.kw * kp)
    want = np.zeros((ocp, cfg.kh, cfg.kw, kp), np.int8)
    koff = coff = 0
    for s in op.sins:
        want[:cfg.oc, :, :, koff:koff + s.c] = np.transpose(
            eff[:, coff:coff + s.c], (0, 2, 3, 1))
        koff += layout.source_k(s.cp)
        coff += s.c
    np.testing.assert_array_equal(w0k, want.reshape(ocp, -1))
    if wei1 is None:
        assert op.w1k is None
        return
    n1 = layout.packed_cp(cfg.oc1x1)
    want1 = np.zeros((n1, ocp), np.int8)
    want1[:cfg.oc1x1, :cfg.oc] = wei1[:, :, 0, 0]
    np.testing.assert_array_equal(op.w1k.numpy(), want1)


def _emulate_acc0(op, arrs):
    """The kernel's 3x3 accumulator in float64: every stored byte as s8,
    each source's lanes padded with zeros to source_k (TMA's fill past the
    source), times the K-major weights, plus the correction."""
    cfg, sin = op.cfg, op.sin
    n = arrs[0].shape[0]
    x = torch.cat([F.pad(a.reshape(n, s.rows, s.iwp, s.cp).to(torch.float64),
                         (0, layout.source_k(s.cp) - s.cp))
                   for a, s in zip(arrs, op.sins)], dim=-1)
    kp = x.shape[-1]
    w = op.w0k.to(torch.float64).reshape(-1, cfg.kh * cfg.kw, kp)
    r0, c0 = sin.halo - cfg.ph, sin.col_off - cfg.pw
    acc = torch.zeros((n, cfg.oh, cfg.ow, w.shape[0]), dtype=torch.float64)
    for ki in range(cfg.kh):
        for kj in range(cfg.kw):
            acc += x[:, r0 + ki:r0 + ki + cfg.oh,
                     c0 + kj:c0 + kj + cfg.ow] @ w[:, ki * cfg.kw + kj].T
    return acc + op.corr0.to(torch.float64)


@pytest.mark.parametrize("name", list(CASES))
def test_s8_read_with_correction_equals_u8_accumulator(name, monkeypatch):
    op, _, _ = _build(name)
    cfg = op.cfg
    arrs = _junk(op, 2, seed=len(name))
    seen = []
    real = T.requant_to_u8

    def capture(acc, *a, **kw):
        out = real(acc, *a, **kw)
        seen.append((acc, out))
        return out
    monkeypatch.setattr(T, "requant_to_u8", capture)
    T.packed_conv_plain(op, arrs)
    acc0, mid = seen[0]
    emu = _emulate_acc0(op, arrs)
    assert torch.equal(emu[..., :cfg.oc].to(torch.int32), acc0)
    assert torch.equal(emu[..., :cfg.oc], acc0.to(torch.float64))
    if not cfg.fuse_conv1x1:
        return
    # the 1x1 reads the plain u8 intermediate (lanes >= oc zero) against
    # w1k with no correction; the plain version's raw accumulator
    n0 = layout.packed_cp(cfg.oc)
    emu1 = F.pad(mid.to(torch.float64), (0, n0 - cfg.oc)) @ \
        op.w1k.to(torch.float64).T
    so = op.sout
    raw = T.packed_conv_plain(op, arrs, emit_acc1=True).reshape(
        2, so.rows, so.iwp, so.cp)[:, so.halo:so.halo + cfg.oh,
                                   so.col_off:so.col_off + cfg.ow]
    assert torch.equal(emu1.to(torch.int32), raw)
