"""The boundaries of the kernel library, and the operands it is given.

No CUDA here: these hold, on the CPU, what the kernels' C entry points and
the library's registered operators expect of the Python side. Every
argument list that ``_build`` declares must match the parameter count of
the ``extern "C"`` function in ``csrc/*.cu`` (ctypes would pass a
misdeclared call silently); the schema that ``csrc/torch_ops.cpp``
registers must take the arguments its wrapper passes; the one source that
includes PyTorch's headers must be compiled with PyTorch's ABI, include
paths and libraries, and the library rebuilt for another PyTorch; the
library is built, loaded and declared once per process however many
threads ask for it; and the K-major weights that ``ConvPoolOp`` derives for
the pool mode of the dense conv kernel must be ``ConvOp``'s and survive
``save``/``load``.
"""
import ctypes
import inspect
import re
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.utils import cpp_extension

from deepfusion_tpu_torch import _build
from deepfusion_tpu_torch.config import ConcatConfig, ConvConfig, PoolConfig
from deepfusion_tpu_torch.ops.concat import (concat_cuda, concat_op,
                                             concat_plain)
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
    """_build with no library loaded yet, a build() that takes a while, a
    torch.ops.load_library that registers nothing and a ctypes.CDLL that
    hands out fake libraries, all counting their calls (`order`: "load"
    and "open" as they came)."""
    calls = {"build": 0, "load": 0, "open": 0, "libs": [], "order": []}

    def build():
        calls["build"] += 1
        time.sleep(0.05)   # long enough for a second thread to arrive
        return _build.BUILD_DIR / "libdf_kernels-fake.so"

    def load_library(path):
        calls["load"] += 1
        calls["order"].append(("load", path))

    def cdll(path):
        calls["open"] += 1
        calls["order"].append(("open", path))
        lib = _FakeLib()
        calls["libs"].append(lib)
        return lib

    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(_build, "build", build)
    monkeypatch.setattr(torch.ops, "load_library", load_library)
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


def test_ops_library_is_loaded_once_before_ctypes_opens_it(fake_library):
    """Two threads' first kernels() load the library's operators exactly
    once, before ctypes opens the same file (one dlopen handle, so
    TORCH_LIBRARY registers once)."""
    start = threading.Barrier(2)

    def ask():
        start.wait()
        _build.kernels()
    threads = [threading.Thread(target=ask) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    _build.kernels()
    path = str(_build.BUILD_DIR / "libdf_kernels-fake.so")
    assert fake_library["load"] == 1
    assert fake_library["order"] == [("load", path), ("open", path)]


def test_check_reports_through_the_loaded_library(fake_library):
    lib = _build.kernels()
    _build.check(0, "none")
    with pytest.raises(RuntimeError,
                       match=r"k7: CUDA error 9 \(fake error 9\)"):
        _build.check(9, "k7")
    assert _build.kernels() is lib
    assert fake_library["build"] == 1 and fake_library["open"] == 1


def _torch_ops_source() -> str:
    return (_build.CSRC / "torch_ops.cpp").read_text()


def test_torch_ops_registers_what_the_wrappers_call():
    """One namespace, the schema of each op, and a CUDA kernel (and no
    other) for each: what ``torch.ops.deepfusion_torch.<op>`` names."""
    src = _torch_ops_source()
    assert re.findall(r"TORCH_LIBRARY\((\w+), m\)", src) == [
        "deepfusion_torch"]
    assert re.findall(r"TORCH_LIBRARY_IMPL\((\w+), (\w+), m\)", src) == [
        ("deepfusion_torch", "CUDA")]
    defs = re.findall(r'm\.def\("(\w+)\(', src)
    impls = re.findall(r'm\.impl\("(\w+)"', src)
    assert defs == impls == ["concat_relu"]


def test_concat_relu_schema_takes_what_concat_cuda_passes(monkeypatch):
    """The schema registered in torch_ops.cpp, defined here with a CPU
    kernel that records its arguments, bound by the dispatcher to the call
    that concat_cuda makes: same namespace and name, the inputs as the
    Tensor[] and cfg.with_relu as the bool; the launches the op returns
    are what concat_cuda adds to K2's count, and nothing else."""
    schema = re.search(r'm\.def\("([^"]+)"\)', _torch_ops_source()).group(1)
    parsed = torch._C.parse_schema(schema)
    assert [str(a.type) for a in parsed.arguments] == ["List[Tensor]",
                                                       "bool"]
    assert [str(r.type) for r in parsed.returns] == ["Tensor", "int"]
    seen = []

    def cpu_kernel(srcs, relu):
        seen.append((list(srcs), relu))
        # a launch count no formula of the inputs gives
        return torch.cat(srcs, dim=-1), 3 + len(seen)

    monkeypatch.setattr(_build, "kernels", lambda: None)
    concat_op.cache_clear()
    try:
        with torch.library._scoped_library("deepfusion_torch", "DEF") as lib:
            lib.define(schema)
            lib.impl("concat_relu", cpu_kernel, "CPU")
            rng = np.random.default_rng(0)
            xs = [torch.from_numpy(rng.integers(0, 256, (2, 3, 5, ic),
                                                dtype=np.uint8))
                  for ic in (16, 48)]
            for relu in (True, False):
                cfg = ConcatConfig.make([tuple(x.shape) for x in xs],
                                        torch.uint8, relu)
                before = _build.launch_counts()["concat_relu"]
                got = concat_cuda(xs, cfg)
                assert _build.launch_counts()["concat_relu"] - before == \
                    3 + len(seen)
                assert torch.equal(got, concat_plain(xs, cfg))
                srcs, flag = seen[-1]
                assert flag is relu
                assert len(srcs) == 2 and all(
                    a.data_ptr() == b.data_ptr() for a, b in zip(srcs, xs))
    finally:
        concat_op.cache_clear()


def test_torch_ops_compile_command_carries_torch_abi_and_headers():
    src = _build.CSRC / "torch_ops.cpp"
    cmd = _build.compile_cmd("/cuda/bin/nvcc", src, Path("/tmp/o.o"))
    abi = int(torch._C._GLIBCXX_USE_CXX11_ABI)
    assert f"-D_GLIBCXX_USE_CXX11_ABI={abi}" in cmd
    for p in cpp_extension.include_paths():
        assert f"-I{p}" in cmd
    assert f"-I{_build._cuda_home() / 'include'}" in cmd
    std = [c for c in cmd if c.startswith("-std=")]
    assert len(std) == 1
    # the standard that torch.utils.cpp_extension passes
    assert std[0] in inspect.getsource(cpp_extension)
    assert cmd[:1] == ["/cuda/bin/nvcc"] and cmd[-4:] == [
        "-c", "-o", "/tmp/o.o", str(src)]


@pytest.mark.parametrize("name", ["concat.cu", "conv.cu"])
def test_cu_compile_commands_keep_their_flags(name):
    """The .cu files keep nvcc's flags and no PyTorch header or ABI."""
    src = _build.CSRC / name
    cmd = _build.compile_cmd("/cuda/bin/nvcc", src, Path("/tmp/o.o"))
    assert cmd == ["/cuda/bin/nvcc", *_build._flags(), "-c", "-o",
                   "/tmp/o.o", str(src)]
    assert not any("GLIBCXX" in c or "torch" in c for c in cmd[:-1])


def test_link_command_links_libtorch():
    objs = [Path("/tmp/a.o"), Path("/tmp/torch_ops.o")]
    cmd = _build.link_cmd("/cuda/bin/nvcc", objs, Path("/tmp/lib.so"))
    lib = cpp_extension.library_paths()[0]
    assert f"-L{lib}" in cmd
    for name in ("torch", "torch_cpu", "torch_cuda", "c10", "c10_cuda"):
        assert f"-l{name}" in cmd
    i = cmd.index("-Xlinker")
    assert cmd[i + 1] == f"-rpath={lib}"
    assert cmd[cmd.index("-o") + 1] == "/tmp/lib.so"
    assert all(str(o) in cmd for o in objs)


def test_every_source_is_compiled():
    names = {f.name for f in _build._sources()}
    assert "torch_ops.cpp" in names
    assert names == {f.name for f in _build.CSRC.glob("*.cu")} | {
        "torch_ops.cpp"}


def test_library_path_tracks_the_installed_torch(monkeypatch):
    """Another PyTorch (version, ABI or headers) builds another library
    instead of loading one built against other headers."""
    base = _build.library_path()
    monkeypatch.setattr(torch, "__version__", "0.0.0+other")
    assert _build.library_path() != base
    monkeypatch.undo()
    assert _build.library_path() == base
    monkeypatch.setattr(torch._C, "_GLIBCXX_USE_CXX11_ABI",
                        not torch._C._GLIBCXX_USE_CXX11_ABI)
    assert _build.library_path() != base
    monkeypatch.undo()
    monkeypatch.setattr(cpp_extension, "include_paths",
                        lambda *a, **k: ["/elsewhere/include"])
    assert _build.library_path() != base
