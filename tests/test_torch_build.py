"""The ctypes boundary of the kernel library, and the operands it is given.

No CUDA here: these hold, on the CPU, what the kernels' C entry points
expect of the Python side. Every argument list that ``_build`` declares
must match the parameter count of the ``extern "C"`` function in
``csrc/*.cu`` (ctypes would pass a misdeclared call silently), the library
is built, opened and declared once per process however many threads ask
for it, and the K-major weights that ``ConvPoolOp`` derives for the pool
mode of the dense conv kernel must be ``ConvOp``'s and survive
``save``/``load``.
"""
import ctypes
import re
import threading
import time

import numpy as np
import pytest
import torch

from deepfusion_tpu_torch import _build
from deepfusion_tpu_torch.config import ConvConfig, PoolConfig
from deepfusion_tpu_torch.ops.conv import ConvOp
from deepfusion_tpu_torch.ops.convpool import ConvPoolOp


def _c_params(name: str):
    """The parameter list of `extern "C" int name(...)` in csrc/*.cu, one
    string per parameter; None if no source defines it."""
    found = []
    for f in sorted(_build.CSRC.glob("*.cu")):
        src = f.read_text()
        for m in re.finditer(r'extern "C" int ' + re.escape(name) + r"\(",
                             src):
            depth, i = 1, m.end()
            while depth:
                depth += {"(": 1, ")": -1}.get(src[i], 0)
                i += 1
            body = " ".join(src[m.end():i - 1].split())
            found.append([p.strip() for p in body.split(",") if p.strip()])
    assert len(found) <= 1, f"{name} defined {len(found)} times"
    return found[0] if found else None


@pytest.mark.parametrize("name", sorted(_build._SIGNATURES))
def test_signature_matches_the_c_entry_point(name):
    params = _c_params(name)
    assert params is not None, f'no extern "C" int {name}( in csrc/*.cu'
    assert len(params) == len(_build._SIGNATURES[name]), (name, params)


def _ctype_of(param: str):
    """The ctypes type a C parameter must be passed as."""
    if "*" in param:
        return "pointer"
    kind = param.rsplit(" ", 1)[0].replace("const ", "")
    return {"int": ctypes.c_int, "long long": ctypes.c_longlong,
            "float": ctypes.c_float}[kind]


@pytest.mark.parametrize("name", sorted(_build._SIGNATURES))
def test_argument_types_match_the_c_parameters(name):
    """Pointers as pointers (a ctypes int would cut them to 32 bits), ints,
    64-bit ints and floats as themselves."""
    for param, arg in zip(_c_params(name), _build._SIGNATURES[name]):
        want = _ctype_of(param)
        if want == "pointer":
            assert arg is ctypes.c_void_p or issubclass(
                arg, ctypes._Pointer), (name, param, arg)
        else:
            assert arg is want, (name, param, arg)


def test_every_c_entry_point_is_declared():
    """Each extern "C" function of the library but the error string has
    its argument types in _build._SIGNATURES."""
    names = set()
    for f in _build.CSRC.glob("*.cu"):
        names |= set(re.findall(r'extern "C" int (\w+)\(', f.read_text()))
    assert names == set(_build._SIGNATURES)


def _pool_case(oc, ic, k, dst="u8", kind="max"):
    rng = np.random.default_rng(oc * 31 + ic)
    w = rng.integers(-128, 128, (oc, ic, k, k)).astype(np.int8)
    b = rng.integers(-500, 500, (oc,)).astype(np.int32)
    cfg = ConvConfig.make((2, 8, 8, ic), w.shape, b.dtype, (1, 1),
                          (k // 2, k // 2), (2, 8, 8, oc), dst,
                          conv0_relu=True, conv0_scales=(1.0 / 3000,))
    pc = PoolConfig.make(kind, (8, 8), (2, 2), (2, 2), (0, 0))
    return cfg, pc, w, b


@pytest.mark.parametrize("oc,ic,k", [(8, 16, 3), (40, 3, 3), (264, 32, 1),
                                     (128, 64, 3)])
def test_convpool_kmajor_weights_are_convops(oc, ic, k):
    cfg, pc, w, b = _pool_case(oc, ic, k)
    op = ConvPoolOp(cfg, pc, w, b, device="cpu")
    ref = ConvOp(cfg, w, b, device="cpu")
    assert op.w0k.dtype == torch.int8
    assert torch.equal(op.w0k, ref.w0k)
    assert op.w1k is None


def test_convpool_kmajor_weights_survive_save_load(tmp_path):
    cfg, pc, w, b = _pool_case(48, 24, 3, "f32", "avg_exc")
    op = ConvPoolOp(cfg, pc, w, b, device="cpu")
    path = str(tmp_path / "convpool.npz")
    op.save(path)
    with np.load(path) as data:
        assert sorted(data.files) == ["__cfg__", "bias0", "scale0", "w0"]
    back = ConvPoolOp.load(path, device="cpu")
    assert torch.equal(back.w0k, op.w0k)
    assert set(dict(back.named_buffers())) == {"w0", "bias0", "scale0",
                                               "w0k"}
    assert set(back.state_dict()) == {"w0", "bias0", "scale0"}


class _FakeFn:
    """An entry point of the fake library; counts its declarations."""

    def __init__(self, lib):
        self._lib = lib

    def __setattr__(self, key, value):
        if key == "argtypes":
            self._lib.declared += 1
        object.__setattr__(self, key, value)

    def __call__(self, rc):
        return b"fake error %d" % rc


class _FakeLib:
    def __init__(self):
        self.declared = 0
        self.fns = {}

    def __getattr__(self, name):
        return self.fns.setdefault(name, _FakeFn(self))


@pytest.fixture
def fake_library(monkeypatch):
    """_build with no library loaded yet, a build() that takes a while and
    a ctypes.CDLL that hands out fake libraries, both counting their
    calls."""
    calls = {"build": 0, "open": 0, "libs": []}

    def build():
        calls["build"] += 1
        time.sleep(0.05)   # long enough for a second thread to arrive
        return _build.BUILD_DIR / "libdf_kernels-fake.so"

    def cdll(path):
        calls["open"] += 1
        lib = _FakeLib()
        calls["libs"].append(lib)
        return lib

    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(_build, "build", build)
    monkeypatch.setattr(ctypes, "CDLL", cdll)
    return calls


def test_library_is_built_opened_and_declared_once(fake_library):
    """Many kernels() calls, two threads among them asking at the same
    moment, build, open and declare the library once and all get it."""
    got, start = [], threading.Barrier(2)

    def ask():
        start.wait()
        got.append(_build.kernels())
    threads = [threading.Thread(target=ask) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    got += [_build.kernels() for _ in range(1000)]
    assert fake_library["build"] == 1 and fake_library["open"] == 1
    lib = fake_library["libs"][0]
    assert all(g is lib for g in got)
    assert lib.declared == len(_build._SIGNATURES) + 1   # + df_error_string


def test_check_reports_through_the_loaded_library(fake_library):
    lib = _build.kernels()
    _build.check(0, "none")
    with pytest.raises(RuntimeError,
                       match=r"k7: CUDA error 9 \(fake error 9\)"):
        _build.check(9, "k7")
    assert _build.kernels() is lib
    assert fake_library["build"] == 1 and fake_library["open"] == 1
