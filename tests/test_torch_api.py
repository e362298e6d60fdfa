"""The object API of the PyTorch port (``memory`` + factories + ``submit``)
vs the JAX package's, bitwise (CPU).

The cases of ``tests/test_api.py`` and the env, profiling and capability
cases of ``tests/test_observability.py``, each run through both packages
on the same ``fill_random`` data (one numpy seed gives both packages the
same bytes). The port's ops run on ``device="cpu"`` (the plain PyTorch
versions); their results stay torch tensors on the op's device. Also: the
``memory`` container itself (shape check, ``nchw2format``, the upload of
host data, a tensor on another device), the profiler's trace, and the
logger and math helpers the package exports.
"""
import logging

import numpy as np
import pytest
import torch

import deepfusion_tpu as jdf
import deepfusion_tpu_torch as df
from deepfusion_tpu.utils import mathutil as jmath
from deepfusion_tpu_torch.utils import env, logger, mathutil
from deepfusion_tpu_torch.utils.logger import CheckError
from deepfusion_tpu_torch.utils.profiler import device_trace, submit_timer

torch.set_num_threads(2)
CPU = torch.device("cpu")


def mems(pkg, seed, *specs):
    """One memory per (nchw dims, format name, dtype name), filled with
    ``fill_random`` from one generator, or zeros for a dst (fill=False)."""
    rng = np.random.default_rng(seed)
    out = []
    for dims, fmt, dt, fill in specs:
        m = pkg.memory(dims, getattr(pkg.format, fmt), getattr(pkg, dt))
        out.append(m.fill_random(rng) if fill else m)
    return out


def same(got: "df.memory", want):
    """The port's result: a torch tensor on the CPU op's device, bitwise
    the JAX package's."""
    assert isinstance(got.data, torch.Tensor), type(got.data)
    assert got.data.device == CPU
    w = np.asarray(want.data)
    assert got.numpy().dtype == w.dtype and got.numpy().shape == w.shape
    np.testing.assert_array_equal(got.numpy(), w)


CONCAT = (([2, 64, 4, 4], "nhwc", "s8", True),
          ([2, 32, 4, 4], "nhwc", "s8", True),
          ([2, 96, 4, 4], "nhwc", "s8", False))


def test_concat_object_api():
    a, b, dst = mems(df, 0, *CONCAT)
    ja, jb, jdst = mems(jdf, 0, *CONCAT)
    df.concat([a, b], dst, post_relu=True, device="cpu").submit()
    jdf.concat([ja, jb], jdst, post_relu=True).submit()
    same(dst, jdst)


def _weights(pkg, seed, oihw):
    rng = np.random.default_rng(seed)
    w = pkg.memory(oihw, pkg.format.OIhw4i16o4i, pkg.s8)
    w.data = rng.integers(-10, 11, oihw).astype(np.int8)
    return w


def test_conv_object_api_standalone():
    specs = (([2, 16, 9, 9], "nhwc", "u8", True), ([32], "x", "s32", True),
             ([2, 32, 9, 9], "nhwc", "s8", False))
    results = []
    for pkg, kw in ((df, {"device": "cpu"}), (jdf, {})):
        src, bia, dst = mems(pkg, 1, *specs)
        wei = _weights(pkg, 2, (32, 16, 3, 3))
        pkg.conv(src, wei, bia, (1, 1), (1, 1), dst, conv0_relu=True,
                 conv0_scales=(0.1,), **kw).submit()
        results.append(dst)
    same(*results)


def test_conv_object_api_fused():
    specs = (([1, 16, 8, 8], "nhwc", "u8", True),
             ([1, 16, 8, 8], "nhwc", "u8", False))
    results = []
    for pkg, kw in ((df, {"device": "cpu"}), (jdf, {})):
        src, dst = mems(pkg, 3, *specs)
        wei = _weights(pkg, 4, (32, 16, 3, 3))
        wei1 = _weights(pkg, 5, (16, 32, 1, 1))
        # positional style: conv(src, wei, bia, stride, pad, wei1x1,
        # bia1x1, dst, ...) like the 13-argument reference overload
        pkg.conv(src, wei, None, (1, 1), (1, 1), wei1, None, dst, False,
                 (0.02,), pkg.round_mode.nearest, True, (0.3,),
                 **kw).submit()
        results.append(dst)
    same(*results)


def test_pool_object_api():
    specs = (([1, 32, 8, 8], "nhwc", "u8", True),
             ([1, 32, 4, 4], "nhwc", "u8", False))
    results = []
    for pkg, kw in ((df, {"device": "cpu"}), (jdf, {})):
        src, dst = mems(pkg, 6, *specs)
        pkg.pool(src, dst, "max", (2, 2), (2, 2), (0, 0), **kw).submit()
        results.append(dst)
    same(*results)


def test_eltwise_object_api():
    specs = (([1, 16, 4, 4], "nhwc", "s8", True),
             ([1, 16, 4, 4], "nhwc", "s8", True),
             ([1, 16, 4, 4], "nhwc", "s8", False))
    results = []
    for pkg, kw in ((df, {"device": "cpu"}), (jdf, {})):
        a, b, dst = mems(pkg, 7, *specs)
        pkg.eltwise_sum_relu(a, b, dst, **kw).submit()
        results.append(dst)
    same(*results)


def test_factory_rejects_dtype_mismatch():
    a, dst = mems(df, 8, ([2, 16, 4, 4], "nhwc", "s8", True),
                  ([2, 16, 4, 4], "nhwc", "u8", False))
    with pytest.raises(CheckError):
        df.concat([a], dst, device="cpu")


def test_conv_dispatch_rejects_malformed_calls():
    """The conv factory resolves its two reference overloads by operand
    type at each position; anything else raises, never mis-dispatches."""
    specs = (([2, 16, 9, 9], "nhwc", "u8", True), ([32], "x", "s32", True),
             ([2, 16, 9, 9], "nhwc", "u8", False))
    results = []
    for pkg, kw in ((df, {"device": "cpu"}), (jdf, {})):
        src, bia, dst = mems(pkg, 9, *specs)
        wei = _weights(pkg, 10, (32, 16, 3, 3))
        wei1 = _weights(pkg, 11, (16, 32, 1, 1))
        # the fused shape with dst as a keyword resolves to the fused one
        pkg.conv(src, wei, bia, (1, 1), (1, 1), wei1, None, dst=dst,
                 conv0_scales=(0.1,), conv1_relu=True, conv1_scales=(0.2,),
                 **kw).submit()
        results.append(dst)
    same(*results)
    src, bia, dst = mems(df, 9, *specs)
    wei = _weights(df, 10, (32, 16, 3, 3))
    wei1 = _weights(df, 11, (16, 32, 1, 1))
    # the plain shape with a trailing stray memory raises
    with pytest.raises(CheckError):
        df.conv(src, wei, bia, (1, 1), (1, 1), dst, wei1, device="cpu")
    # dst must be a memory
    with pytest.raises(CheckError):
        df.conv(src, wei, bia, (1, 1), (1, 1), "dst", device="cpu")


def test_object_api_results_stay_on_device():
    """Chained ops feed each other tensors on their device, with no host
    round trip; ``numpy()`` is the explicit host copy."""
    specs = (([2, 64, 4, 4], "nhwc", "s8", True),
             ([2, 64, 4, 4], "nhwc", "s8", True),
             ([2, 128, 4, 4], "nhwc", "s8", False),
             ([2, 128, 4, 4], "nhwc", "s8", False))
    a, b, mid, dst = mems(df, 12, *specs)
    ja, jb, jmid, jdst = mems(jdf, 12, *specs)
    df.concat([a, b], mid, post_relu=True, device="cpu").submit()
    assert isinstance(mid.data, torch.Tensor)
    df.eltwise_sum_relu(mid, mid, dst, device="cpu").submit()
    assert isinstance(dst.data, torch.Tensor) and dst.data.device == CPU
    jdf.concat([ja, jb], jmid, post_relu=True).submit()
    jdf.eltwise_sum_relu(jmid, jmid, jdst).submit()
    same(dst, jdst)


# ------------------------------------------------------------- memory

def test_memory_setter_checks_the_shape():
    m = df.memory([2, 16, 4, 4], df.format.nhwc, df.u8)
    assert m.actual_dims() == [2, 4, 4, 16] and m.std_dims() == [2, 16, 4, 4]
    with pytest.raises(ValueError, match="shape mismatch"):
        m.data = np.zeros((2, 16, 4, 4), np.uint8)
    with pytest.raises(ValueError, match="shape mismatch"):
        m.data = torch.zeros((2, 4, 4, 8), dtype=torch.uint8)
    m.data = [[[[1] * 16] * 4] * 4] * 2       # lists take the memory dtype
    assert m.data.dtype == np.uint8 and m.numpy().sum() == 2 * 4 * 4 * 16
    t = torch.ones((2, 4, 4, 16), dtype=torch.uint8)
    m.data = t
    assert m.data is t and m.numpy().sum() == 2 * 4 * 4 * 16


@pytest.mark.parametrize("fmt", ["nchw", "nhwc", "OIhw4i16o4i", "x",
                                 "gOIhw4i16o4i", "undef"])
def test_nchw2format_matches_jax(fmt):
    dims = [2, 3, 5, 7]
    want = got = None
    try:
        want = jdf.types.nchw2format(dims, getattr(jdf.format, fmt))
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e)):
            df.types.nchw2format(dims, getattr(df.format, fmt))
    else:
        got = df.types.nchw2format(dims, getattr(df.format, fmt))
        assert got == want
    assert getattr(df.format, fmt).value == getattr(jdf.format, fmt).value
    # the weight layout: the JAX package's tpu_pack is the port's mma_pack
    assert df.format.mma_pack.value == jdf.format.tpu_pack.value


@pytest.mark.parametrize("dt", ["u8", "s8", "s32", "f32"])
def test_fill_random_matches_jax(dt):
    m = df.memory([2, 8, 3, 3], df.format.nhwc, getattr(df, dt))
    jm = jdf.memory([2, 8, 3, 3], jdf.format.nhwc, getattr(jdf, dt))
    m.fill_random(np.random.default_rng(5))
    jm.fill_random(np.random.default_rng(5))
    assert m.numpy().dtype == jm.numpy().dtype
    np.testing.assert_array_equal(m.numpy(), jm.numpy())


def test_host_memory_is_uploaded_once_to_the_op_device():
    """A host-filled memory read by a CPU op becomes a tensor on the op's
    device, kept in the memory: a second submit reads the same tensor."""
    a, b, dst = mems(df, 13, *CONCAT)
    host = a.data
    op = df.concat([a, b], dst, post_relu=True, device="cpu")
    assert op.device == CPU and isinstance(a.data, np.ndarray)
    op.submit()
    assert isinstance(a.data, torch.Tensor) and a.data.device == CPU
    np.testing.assert_array_equal(a.numpy(), host)
    kept = a.data
    op.submit()
    assert a.data is kept
    assert a.tensor(CPU) is kept


def test_memory_on_another_device_raises():
    """An op never moves a memory's tensor between devices (nor runs the
    plain path for a tensor it was not built for)."""
    a, b, dst = mems(df, 14, *CONCAT)
    a.data = torch.empty(a.actual_dims(), dtype=torch.int8, device="meta")
    op = df.concat([a, b], dst, post_relu=True, device="cpu")
    with pytest.raises(ValueError, match="memory holds a tensor on meta"):
        op.submit()


def test_factories_follow_the_device_rule(monkeypatch):
    """device=None is the current CUDA device: without CUDA it raises,
    naming device="cpu"."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    a, b, dst = mems(df, 15, *CONCAT)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        df.concat([a, b], dst)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        df.device_capabilities()


def test_conv_config_multi_oc_scale_matches_jax():
    for sc in ((0.5,), (0.5, 0.25)):
        args = ((1, 6, 6, 16), (2, 16, 3, 3), None, (1, 1), (1, 1),
                (1, 6, 6, 2), "u8")
        kw = dict(conv0_scales=sc, wei1x1_shape=(2, 2, 1, 1),
                  conv1_scales=sc)
        c = df.ConvConfig.make(*args, **kw)
        jc = jdf.ConvConfig.make(*args, **kw)
        assert (c.conv0_multi_oc_scale, c.conv1_multi_oc_scale) == \
            (jc.conv0_multi_oc_scale, jc.conv1_multi_oc_scale) == \
            (len(sc) > 1,) * 2


# ------------------------------------------------ env, profile, capabilities

def test_env_flags(monkeypatch):
    monkeypatch.setenv("DEEPFUSION_PROFILE", "1")
    assert env.is_profiling()
    monkeypatch.setenv("DEEPFUSION_PROFILE", "0")
    assert not env.is_profiling()
    monkeypatch.setenv("DEEPFUSION_DUMP_CODE", "true")
    assert env.dump_code()
    monkeypatch.delenv("DEEPFUSION_DUMP_CODE")
    assert not env.dump_code()


def test_profile_logs_submit(monkeypatch, caplog):
    monkeypatch.setenv("DEEPFUSION_PROFILE", "1")
    a, dst = mems(df, 16, ([1, 16, 2, 2], "nhwc", "s8", True),
                  ([1, 16, 2, 2], "nhwc", "s8", False))
    op = df.concat([a], dst, post_relu=True, device="cpu")
    with caplog.at_level(logging.INFO, logger="deepfusion_tpu_torch"):
        op.submit()
    assert any("_concat_op infer" in r.getMessage()
               and r.getMessage().endswith(" ms") for r in caplog.records)


def test_submit_timer_off_neither_logs_nor_touches_the_card(monkeypatch,
                                                            caplog):
    """With profiling off a submit on a CUDA op records no event and never
    synchronises (no CUDA call at all)."""
    monkeypatch.delenv("DEEPFUSION_PROFILE", raising=False)

    def no_cuda(*a, **k):
        raise AssertionError("submit_timer touched CUDA with profiling off")
    monkeypatch.setattr(torch.cuda, "Event", no_cuda)
    monkeypatch.setattr(torch.cuda, "current_stream", no_cuda)
    ran = []
    with caplog.at_level(logging.INFO, logger="deepfusion_tpu_torch"):
        with submit_timer("op", torch.device("cuda", 0)):
            ran.append(1)
    assert ran == [1] and not caplog.records


def test_device_trace_writes_a_chrome_trace(tmp_path):
    with device_trace(str(tmp_path / "trace")) as prof:
        torch.ones(64).sum()
    assert prof is not None
    path = tmp_path / "trace" / "trace.json"
    assert path.exists() and path.stat().st_size > 0


def test_device_capabilities():
    caps = df.device_capabilities("cpu")
    jcaps = jdf.device_capabilities()
    assert caps["num_devices"] >= 1
    assert caps["platform"] == jcaps["platform"] == "cpu"
    assert set(caps) == {"platform", "device_kind", "num_devices",
                         "int8_native", "sm_count", "capability"}
    assert caps["int8_native"] is False


# --------------------------------------------------- logger and math helpers

@pytest.mark.parametrize("name,a,b", [("check_ne", 1, 1), ("check_lt", 2, 1),
                                      ("check_le", 2, 1), ("check_gt", 1, 2),
                                      ("check_ge", 1, 2)])
def test_check_helpers(name, a, b):
    fn = getattr(df.utils, name)
    with pytest.raises(CheckError, match=name):
        fn(a, b)
    fn(b, a) if name != "check_ne" else fn(a, b + 1)


def test_logger_helpers(caplog):
    with caplog.at_level(logging.DEBUG, logger="deepfusion_tpu_torch"):
        logger.warning("w %d", 1)
        logger.debug("d %d", 2)
        with pytest.raises(CheckError, match="fatal 3"):
            logger.error_and_exit("fatal %d", 3)
    msgs = [r.getMessage() for r in caplog.records]
    assert any(m.endswith("w 1") for m in msgs)
    assert any(m.endswith("d 2") for m in msgs)
    assert any(m.endswith("fatal 3") for m in msgs)
    t0 = logger.get_current_ms()
    assert logger.get_current_ms() >= t0


def test_math_helpers_match_jax():
    for n, hi in ((12, 5), (7, 3), (16, 16), (1, 4)):
        assert mathutil.find_dividable(n, hi) == jmath.find_dividable(n, hi)
        assert mathutil.dividable_of(n, 5, 4, 3) == \
            jmath.dividable_of(n, 5, 4, 3)
    assert mathutil.all_true(1, True, "x") and not mathutil.all_true(1, 0)
    dims = (2, 3, 4)
    assert list(mathutil.nd_range(3, 19, dims)) == \
        list(jmath.nd_range(3, 19, dims))
    c = mathutil.nd_iterator_init(23, dims)
    assert c == jmath.nd_iterator_init(23, dims) == [1, 2, 3]
    assert not mathutil.nd_iterator_step(c, dims) and c == [0, 0, 0]
