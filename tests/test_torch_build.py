"""The boundaries of the kernel library, and the operands it is given.

No CUDA here: these hold, on the CPU, what the library's registered
operators expect of the Python side. Every schema that ``csrc/*.cpp``
registers (``m.def``) is defined here with a CPU kernel that records its
arguments and bound by the dispatcher to the call that its real wrapper
makes, argument by argument against the configuration (the ints of an
``int[]`` in the order of the C++ enum that reads them); the C++ function
that each ``m.impl`` names must take the schema's arguments, by name, in
the same order and of matching kinds; each op has one kernel, CUDA where it
takes a tensor, and no C entry point or ``ctypes`` is left. The sources
that include PyTorch's headers must be compiled with PyTorch's ABI, include
paths and libraries, and the library rebuilt for another PyTorch; the
library is built and loaded once per process however many threads ask for
it; and the K-major weights that ``ConvPoolOp`` derives for the pool mode
of the dense conv kernel must be ``ConvOp``'s and survive
``save``/``load``.
"""
import ast
import functools
import importlib
import inspect
import re
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.utils import cpp_extension

import deepfusion_tpu_torch
from deepfusion_tpu_torch import _build
from deepfusion_tpu_torch.config import ConcatConfig, ConvConfig, PoolConfig
from deepfusion_tpu_torch.ops import layout
from deepfusion_tpu_torch.ops.concat import concat_cuda, concat_plain
from deepfusion_tpu_torch.ops.conv import ConvOp
from deepfusion_tpu_torch.ops.convpool import ConvPoolOp
from deepfusion_tpu_torch.types import dtype, round_mode
from deepfusion_tpu_torch.utils.logger import CheckError

# the op modules (ops/__init__ exports functions named conv and pool)
C, CP, D, M, P, PL = (
    importlib.import_module(f"deepfusion_tpu_torch.ops.{m}")
    for m in ("conv", "convpool", "depthwise", "mega", "packed", "pool"))


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
    """ConvPoolOp derives its K-major weights as ConvOp does, except where
    ConvOp folds a narrow input's column taps into the channels (3
    channels under 3x3): the pool mode never unfolds, so there it keeps
    the taps as they are."""
    cfg, pc, w, b = _pool_case(oc, ic, k)
    op = ConvPoolOp(cfg, pc, w, b, device="cpu")
    ref = ConvOp(cfg, w, b, device="cpu")
    assert op.w0k.dtype == torch.int8
    assert ref._unfold == (ic < 16 and k > 1)
    want = layout.dense_kmajor_weights(ref.w0, k, k) if ref._unfold \
        else ref.w0k
    assert torch.equal(op.w0k, want)
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


@pytest.fixture
def fake_library(monkeypatch):
    """_build with no library loaded yet, a build() that takes a while and
    a torch.ops.load_library that registers nothing, both counting their
    calls (`loaded`: the paths loaded, in order)."""
    calls = {"build": 0, "loaded": []}

    def build():
        calls["build"] += 1
        time.sleep(0.05)   # long enough for a second thread to arrive
        return _build.BUILD_DIR / "libdf_kernels-fake.so"

    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(_build, "build", build)
    monkeypatch.setattr(torch.ops, "load_library",
                        lambda path: calls["loaded"].append(path))
    return calls


def test_library_is_built_opened_and_declared_once(fake_library):
    """Many kernels() calls, two threads among them asking at the same
    moment, build the library and load it (its operators registered) once,
    and all get its path."""
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
    path = _build.BUILD_DIR / "libdf_kernels-fake.so"
    assert fake_library["build"] == 1
    assert fake_library["loaded"] == [str(path)]
    assert all(g is got[0] for g in got) and got[0] == path


# ---------------------------------------------- the registered operators

# every op of torch.ops.deepfusion_torch, as the wrappers call them (and
# empty_launches, the floor of a launch that tools/kernel_times.py times)
OPS = ("concat_relu", "pool", "sum_relu", "conv_fused", "convpool",
       "conv_weight_maps", "conv_plan", "packed_conv", "packed_weight_maps",
       "packed_plan", "packed_sum_pool", "pair_conv", "pair_plan",
       "empty_launches", "unfold_cols", "depthwise")


def _cpp_sources() -> dict:
    return {f.name: f.read_text() for f in sorted(_build.CSRC.glob("*.cpp"))}


def _schemas() -> dict:
    """Every ``m.def`` of csrc/*.cpp, its adjacent string literals joined:
    op name -> schema."""
    out = {}
    for src in _cpp_sources().values():
        for m in re.finditer(r'm\.def\(((?:\s*"[^"]*")+)\s*\);', src):
            schema = "".join(re.findall(r'"([^"]*)"', m.group(1)))
            assert schema.split("(")[0] not in out, schema
            out[schema.split("(")[0]] = schema
    return out


def _impls() -> list:
    """Every ``m.impl`` of csrc/*.cpp: (dispatch key, op, C++ function)."""
    out = []
    for src in _cpp_sources().values():
        for blk in re.finditer(r"TORCH_LIBRARY_IMPL\(deepfusion_torch, "
                               r"(\w+), m\) \{(.*?)\n\}", src, re.S):
            out += [(blk.group(1), name, fn) for name, fn in re.findall(
                r'm\.impl\("(\w+)", &(\w+)\);', blk.group(2))]
    return out


def _takes_tensors(schema) -> bool:
    return any("Tensor" in str(a.type) for a in schema.arguments)


def _kernel_key(name: str) -> str:
    """The dispatch key of an op's one kernel: CUDA where it takes a tensor;
    an op of ints alone has no backend to dispatch on."""
    parsed = torch._C.parse_schema(_schemas()[name])
    return "CUDA" if _takes_tensors(parsed) else "CompositeExplicitAutograd"


def test_torch_ops_registers_what_the_wrappers_call():
    """One namespace, declared once (torch_ops.cpp) and added to by the
    other sources, the schema of each op the wrappers call and nothing
    else: what ``torch.ops.deepfusion_torch.<op>`` names."""
    srcs = _cpp_sources()
    libs = {name: re.findall(r"TORCH_LIBRARY\((\w+), m\)", src)
            for name, src in srcs.items()}
    assert libs.pop("torch_ops.cpp") == ["deepfusion_torch"]
    assert all(v == [] for v in libs.values())
    for name, src in srcs.items():
        if name != "torch_ops.cpp" and "m.def(" in src:
            assert re.findall(r"TORCH_LIBRARY_FRAGMENT\((\w+), m\)",
                              src) == ["deepfusion_torch"]
    assert sorted(_schemas()) == sorted(OPS)


@pytest.mark.parametrize("name", OPS)
def test_every_op_has_one_kernel(name):
    """Exactly one ``m.impl`` per op: a CUDA kernel for an op that takes a
    tensor (a CPU tensor raises in the dispatcher: no CPU kernel is
    registered, no path falls back), CompositeExplicitAutograd for a plan
    (ints in, ints out)."""
    impls = [(key, fn) for key, op, fn in _impls() if op == name]
    assert [key for key, _ in impls] == [_kernel_key(name)]


def test_no_c_entry_point_is_left():
    """The kernels are reached through their ops alone: no source of csrc/
    exports a C function."""
    for f in sorted(_build.CSRC.iterdir()):
        assert 'extern "C"' not in f.read_text(), f.name


def test_no_module_imports_ctypes():
    root = Path(deepfusion_tpu_torch.__file__).parent
    for f in sorted(root.rglob("*.py")):
        for node in ast.walk(ast.parse(f.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            assert not any(n.split(".")[0] == "ctypes" for n in names), f


# the C++ type of each schema type, for arguments and for returns
_CPP_ARG = {"Tensor": "const at::Tensor&",
            "Optional[Tensor]": "const std::optional<at::Tensor>&",
            "List[Tensor]": "at::TensorList", "List[int]": "at::IntArrayRef",
            "int": "int64_t", "float": "double", "bool": "bool"}
_CPP_RETURN = {("Tensor",): "at::Tensor",
               ("List[int]",): "std::vector<int64_t>", ("int",): "int64_t",
               ("Tensor", "int"): "std::tuple<at::Tensor, int64_t>"}


def _cpp_function(fn: str):
    """(return type, [(type, name), ...]) of the definition of the C++
    function `fn` in csrc/*.cpp."""
    found = []
    for src in _cpp_sources().values():
        for m in re.finditer(r"^(\S[^\n(]*?)\s+" + re.escape(fn) + r"\(",
                             src, re.M):
            depth, i = 1, m.end()
            while depth:
                depth += {"(": 1, ")": -1}.get(src[i], 0)
                i += 1
            params = " ".join(src[m.end():i - 1].split())
            found.append((m.group(1).strip(), [
                tuple(p.strip().rsplit(" ", 1)) for p in params.split(",")]))
    assert len(found) == 1, (fn, found)
    return found[0]


@pytest.mark.parametrize("name", OPS)
def test_cpp_function_takes_the_schema_arguments(name):
    """The C++ function that ``m.impl`` binds takes the schema's arguments
    in the same order, under the same names and of the kinds the
    dispatcher unboxes them to (a schema float is a double, an int an
    int64_t), and returns the schema's returns."""
    parsed = torch._C.parse_schema(_schemas()[name])
    (fn,) = [fn for _, op, fn in _impls() if op == name]
    ret, params = _cpp_function(fn)
    assert [(_CPP_ARG[str(a.type)], a.name) for a in parsed.arguments] == \
        params
    assert _CPP_RETURN[tuple(str(r.type) for r in parsed.returns)] == ret


def _enum_fields(enum: str) -> list:
    """The fields of the C++ enum `enum` of csrc/*.cpp, which name the ints
    of an int[] argument in order: each name lower-cased without its
    prefix, the count (``..._INTS``) left out."""
    for src in _cpp_sources().values():
        m = re.search(r"enum " + enum + r" \{([^}]*)\};", src)
        if m:
            names = [n.strip() for n in m.group(1).split(",") if n.strip()]
            return [n.split("_", 1)[1].lower() for n in names
                    if not n.endswith("_INTS")]
    raise AssertionError(f"no enum {enum} in csrc/*.cpp")


# the enum that orders each int[] argument of the launch ops
ENUMS = {("pool", "geo"): "PoolGeo", ("conv_fused", "geo"): "ConvGeo",
         ("convpool", "geo"): "ConvPoolGeo",
         ("packed_conv", "geo"): "PackedGeo",
         ("packed_conv", "rows"): "PackedRows",
         ("pair_conv", "layer_a"): "PairLayer",
         ("pair_conv", "layer_b"): "PairLayer",
         ("pair_conv", "geo"): "PairGeo", ("pair_conv", "rows"): "PairRows",
         ("unfold_cols", "geo"): "UnfoldGeo",
         ("depthwise", "geo"): "DepthwiseGeo"}


@pytest.fixture
def recorded_ops(monkeypatch):
    """Every schema of csrc/*.cpp defined with a kernel (CPU, or for a plan
    CompositeExplicitAutograd) that records its arguments by name and what
    it returned: op name -> [{"args": {...}, "out": ...}, ...]. The
    wrappers find these ops as they find the library's."""
    calls = {name: [] for name in OPS}
    monkeypatch.setattr(_build, "kernels", lambda: None)
    _build.op.cache_clear()

    def kernel(name, parsed):
        def run(*args):
            if name.endswith("_plan"):
                out = list(range(100, 120))
            elif name.endswith("_weight_maps"):
                out = torch.zeros((6, 128), dtype=torch.uint8)
            elif name == "empty_launches":
                out = args[0]
            else:
                out = torch.empty(0)
            rec = {"args": dict(zip([a.name for a in parsed.arguments],
                                    args)), "out": out}
            calls[name].append(rec)
            return (out, 1) if name in ("concat_relu", "packed_sum_pool") \
                else out
        return run

    try:
        with torch.library._scoped_library("deepfusion_torch", "DEF") as lib:
            for name, schema in _schemas().items():
                parsed = torch._C.parse_schema(schema)
                lib.define(schema)
                lib.impl(name, kernel(name, parsed),
                         "CPU" if _takes_tensors(parsed)
                         else "CompositeExplicitAutograd")
            yield calls
    finally:
        _build.op.cache_clear()


def _u8(rng, shape):
    return torch.from_numpy(rng.integers(0, 256, shape, dtype=np.uint8))


def _s8(rng, shape):
    return torch.from_numpy(rng.integers(-128, 128, shape, dtype=np.int8))


# The cases below give neighbouring ints of each int[] different values
# where the op allows it, so that two fields read in each other's place
# show.

def _fused_conv():
    """A fused conv with every flag away from its default: ic 20 (padded to
    32), a 3x5 kernel, strides (2, 1), conv0 round-down with bias, conv1
    without, s8 dst, an s32 sum operand."""
    rng = np.random.default_rng(21)
    w = rng.integers(-128, 128, (20, 20, 3, 5)).astype(np.int8)
    w1 = rng.integers(-128, 128, (36, 20, 1, 1)).astype(np.int8)
    b = rng.integers(-500, 500, (20,)).astype(np.int32)
    cfg = ConvConfig.make((2, 9, 8, 20), w.shape, b.dtype, (2, 1), (1, 0),
                          (2, 5, 4, 36), "s8", conv0_relu=True,
                          conv0_scales=(1 / 3000,), conv0_round="down",
                          wei1x1_shape=w1.shape, conv1_scales=(1 / 700,),
                          sum_dt="s32", sum_scale=0.375)
    return ConvOp(cfg, w, b, w1, device="cpu"), rng


def _packed_conv():
    """A fused packed conv of two inputs (32 and 16 channels), a 3x5
    kernel, conv0 round-down with bias, conv1 without, a u8 sum operand of
    a deeper halo than the output's."""
    rng = np.random.default_rng(22)
    w = rng.integers(-128, 128, (40, 48, 3, 5)).astype(np.int8)
    w1 = rng.integers(-128, 128, (24, 40, 1, 1)).astype(np.int8)
    b = rng.integers(-500, 500, (40,)).astype(np.int32)
    cfg = ConvConfig.make((2, 6, 5, 48), w.shape, b.dtype, (1, 1), (1, 2),
                          (2, 6, 5, 24), "u8", conv0_relu=True,
                          conv0_scales=(1 / 3000,), conv0_round="down",
                          wei1x1_shape=w1.shape, conv1_scales=(1 / 500,),
                          sum_dt="u8", sum_scale=0.375)
    sins = (P.PackedSpec.make(6, 5, 32, halo=2, col_off=2, iwp=16),
            P.PackedSpec.make(6, 5, 16, halo=2, col_off=2, iwp=16))
    ssum = P.PackedSpec.make(6, 5, 24, halo=2, col_off=3, iwp=16)
    return P.PackedConvOp(cfg, w, b, w1, None, sin=sins, col_off_out=3,
                          halo_out=1, sum_spec=ssum, device="cpu"), rng


def _pair():
    """A pair with a fused layer a (3x5, a round-down 1x1 with bias) and an
    unfused 1x3 layer b without padding rows or bias, with the fused 2x2
    pool."""
    rng = np.random.default_rng(23)
    ca = ConvConfig.make((2, 8, 10, 32), (40, 32, 3, 5), np.int32, (1, 1),
                         (1, 2), (2, 8, 10, 48), "u8", conv0_relu=True,
                         conv0_scales=(1 / 3000,), wei1x1_shape=(48, 40, 1, 1),
                         bia1x1_dt=np.int32, conv1_scales=(1 / 700,),
                         conv1_round="down")
    cb = ConvConfig.make((2, 8, 10, 48), (24, 48, 1, 3), None, (1, 1), (0, 1),
                         (2, 8, 10, 24), "u8", conv0_relu=True,
                         conv0_scales=(1 / 3000,))
    wa = (rng.integers(-128, 128, (40, 32, 3, 5)).astype(np.int8),
          rng.integers(-500, 500, (40,)).astype(np.int32),
          rng.integers(-128, 128, (48, 40, 1, 1)).astype(np.int8),
          rng.integers(-9, 9, (48,)).astype(np.int32))
    wb = (rng.integers(-128, 128, (24, 48, 1, 3)).astype(np.int8),)
    sin = P.PackedSpec.make(8, 10, 32, halo=3, col_off=2, iwp=16)
    return M.PackedConvPairOp(ca, wa, cb, wb, sin=sin, halo_out=2,
                              col_off_out=2, pool2=True, device="cpu"), rng


def _maps_of(calls, name, w0k):
    """What the weight-maps op returned for the weights w0k."""
    (rec,) = [r for r in calls[name] if r["args"]["w0k"] is w0k]
    return rec["out"]


def _case_concat_relu(calls):
    rng = np.random.default_rng(1)
    xs = [_u8(rng, (2, 3, 5, c)) for c in (16, 48)]
    concat_cuda(xs, ConcatConfig.make([tuple(x.shape) for x in xs],
                                      torch.uint8, True))
    return {"srcs": xs, "relu": True}


def _case_pool(calls):
    x = _s8(np.random.default_rng(2), (2, 9, 7, 32))
    pc = PoolConfig.make("avg_exc", (9, 7), (5, 4), (2, 3), (2, 1),
                         round_mode.down)
    PL.pool_cuda(x, pc, dtype.s8)
    return {"x": x, "geo": dict(ih=9, iw=7, oh=5, ow=3, kh=5, kw=4, sh=2,
                                sw=3, ph=2, pw=1, kind=2, down=1)}


def _case_sum_relu(calls):
    rng = np.random.default_rng(3)
    a, b = (torch.from_numpy(rng.integers(-9, 9, (2, 3, 4, 8),
                                          dtype=np.int32)) for _ in "ab")
    PL.sum_relu_cuda(a, b, dtype.s32, False)
    return {"a": a, "b": b, "relu": False}


def _case_conv_fused(calls):
    op, rng = _fused_conv()
    x = _u8(rng, (2, 9, 8, 20))
    s = torch.from_numpy(rng.integers(-99, 99, (2, 5, 4, 36), dtype=np.int32))
    C.conv_cuda(op, x, s)
    return {"src": torch.nn.functional.pad(x, (0, 12)),
            "wmaps": _maps_of(calls, "conv_weight_maps", op.w0k),
            "bias0": op.bias0, "scale0": op.scale0, "bias1": op.bias1,
            "scale1": op.scale1, "sum_src": s,
            "geo": dict(ih=9, iw=8, ic=32, oh=5, ow=4, kh=3, kw=5, sh=2,
                        sw=1, ph=1, pw=0, oc0=20, oc0p=layout.conv_ocp(20),
                        oc1=36, oc1p=layout.conv_ocp(36), relu0=1, relu1=0,
                        down0=1, down1=0, has_bias0=1, has_bias1=0, fuse=1,
                        dst_dt=dtype.s8.value, sum_dt=dtype.s32.value),
            "sum_scale": 0.375, "emit_acc1": False}


def _case_convpool(calls):
    rng = np.random.default_rng(4)
    w = rng.integers(-128, 128, (36, 24, 5, 3)).astype(np.int8)
    b = rng.integers(-500, 500, (36,)).astype(np.int32)
    cfg = ConvConfig.make((2, 14, 12, 24), w.shape, b.dtype, (1, 2), (0, 1),
                          (2, 10, 6, 36), "u8", conv0_relu=True,
                          conv0_scales=(1 / 3000,), sum_dt="s8",
                          sum_scale=0.5)
    pc = PoolConfig.make("avg_inc", (10, 6), (2, 2), (2, 2), (0, 0),
                         round_mode.down)
    op = ConvPoolOp(cfg, pc, w, b, device="cpu")
    x, s = _u8(rng, (2, 14, 12, 24)), _s8(rng, (2, 10, 6, 36))
    CP.convpool_cuda(op, x, s)
    (maps,) = calls["conv_weight_maps"]
    assert maps["args"]["pool"] is True
    return {"src": torch.nn.functional.pad(x, (0, 8)), "wmaps": maps["out"],
            "bias0": op.bias0, "scale0": op.scale0, "sum_src": s,
            "geo": dict(ih=14, iw=12, ic=32, oh=10, ow=6, kh=5, kw=3, sh=1,
                        sw=2, ph=0, pw=1, oc0=36, oc0p=layout.conv_ocp(36),
                        relu0=1, down0=0, has_bias0=1,
                        dst_dt=dtype.u8.value, sum_dt=dtype.s8.value, avg=1,
                        pool_down=1),
            "sum_scale": 0.5}


def _case_conv_weight_maps(calls):
    """Encoded once per op: a second launch reuses the maps."""
    op, _ = _fused_conv()
    first = C._weight_maps(op)
    assert C._weight_maps(op) is first and len(calls["conv_weight_maps"]) == 1
    return {"w0k": op.w0k, "w1k": op.w1k, "pool": False}


def _case_conv_plan(calls):
    op, _ = _fused_conv()
    plan = C.conv_plan(op, 3, emit_acc1=True)
    assert plan["tile_m"] == 100 and plan["items"] == 115
    return {"geo": [3, 9, 8, 32, 5, 4, 3, 5, 2, 1, 1, 0,
                    layout.conv_ocp(20), layout.conv_ocp(36), 1, 0, 0]}


def _case_packed_conv(calls):
    """A row range of the output from a row slice of the inputs."""
    op, rng = _packed_conv()
    xs = [_s8(rng, s.array_shape(2))[:, 16:] for s in op.sins]
    s = _s8(rng, op.ssum.array_shape(2))
    P.packed_conv_cuda(op, xs, s, rows=(2, 5), row0_off=1)
    # output array rows [2, 5) of a spec with halo 1: image rows [1, 4)
    return {"srcs": xs, "cps": [32, 32], "corr0": op.corr0,
            "bias0": op.bias0, "scale0": op.scale0, "bias1": op.bias1,
            "scale1": op.scale1,
            "wmaps": _maps_of(calls, "packed_weight_maps", op.w0k),
            "sum": s,
            "geo": dict(iwp=16, col_off_in=2, col_off_out=3, oh=6, ow=5,
                        kh=3, kw=5, ph=1, pw=2, oc0=40,
                        oc0p=layout.packed_cp(40), oc1=24,
                        oc1p=layout.packed_cp(24), down0=1, down1=0,
                        has_bias0=1, has_bias1=0, fuse=1, rows_sum=10,
                        halo_sum=2, pool2=0, merge_pool=0),
            "rows": dict(halo_in=1, rows_out=3, halo_out=-1, oy0=1, noy=3),
            "raw": False, "sum_scale": 0.375}


def _case_packed_weight_maps(calls):
    op, _ = _packed_conv()
    first = P._weight_maps(op)
    assert P._weight_maps(op) is first
    assert len(calls["packed_weight_maps"]) == 1
    return {"w0k": op.w0k, "w1k": op.w1k}


def _case_packed_plan(calls):
    op, _ = _packed_conv()
    plan = P.packed_conv_plan(op, 3)
    assert plan["tile_rows"] == 100 and plan["tiles"] == 111
    return {"geo": [3, 6, 5, 2, 32, 32, 0, 0, 3, 5, layout.packed_cp(40),
                    layout.packed_cp(24), 1, 0, 0]}


def _case_packed_sum_pool(calls):
    rng = np.random.default_rng(5)
    ys = [_s8(rng, (2, 10 * 16, c)) for c in (32, 16)]
    r = _s8(rng, (2, 10 * 16, 48))
    P.packed_sum_pool_cuda(ys, r, True, 10, 16)
    return {"ys": ys, "r": r, "rows": 10, "iwp": 16, "pool": True}


def _case_empty_launches(calls):
    assert _build.op("empty_launches")(3) == 3
    return {"calls": 3}


def _narrow_conv():
    """A conv over 3 channels under a 5x7 kernel at strides (2, 3), whose
    column taps the wrapper folds into 32 channels (7 x 3 = 21 real)."""
    rng = np.random.default_rng(24)
    w = rng.integers(-128, 128, (20, 3, 5, 7)).astype(np.int8)
    cfg = ConvConfig.make((2, 11, 16, 3), w.shape, None, (2, 3), (2, 3),
                          (2, 6, 6, 20), "u8", conv0_relu=True,
                          conv0_scales=(1 / 3000,))
    return ConvOp(cfg, w, device="cpu"), rng


def _case_unfold_cols(calls):
    op, rng = _narrow_conv()
    x = _u8(rng, (2, 11, 16, 3))
    C.unfold_cols_cuda(x, C._unfold_geo(op.cfg))
    return {"src": x, "geo": dict(ow=6, kw=7, sw=3, pw=3, cp=32)}


def _case_depthwise(calls):
    """A depthwise conv at stride 2 over an odd image."""
    rng = np.random.default_rng(26)
    w = rng.integers(-128, 128, (48, 1, 3, 3)).astype(np.int8)
    b = rng.integers(-99, 99, (48,)).astype(np.int32)
    sc = rng.uniform(0.5, 1.5, 48).astype(np.float32) / np.float32(700.0)
    cfg = D.DepthwiseConfig.make((2, 9, 7, 48), w.shape, 2, sc)
    op = D.DepthwiseOp(cfg, w, b, device="cpu")
    x = _u8(rng, (2, 9, 7, 48))
    D.depthwise_cuda(op, x)
    return {"src": x, "wcols": op.wcols, "bias": op.bias,
            "scale": op.scale,
            "geo": dict(ih=9, iw=7, oh=5, ow=4, c=48, stride=2)}


def _layer(cfg, kp):
    fuse = cfg.fuse_conv1x1
    return dict(kh=cfg.kh, kw=cfg.kw, ph=cfg.ph, pw=cfg.pw, kp=kp,
                oc0=cfg.oc, oc0p=layout.packed_cp(cfg.oc), oc1=cfg.oc1x1,
                oc1p=layout.packed_cp(cfg.oc1x1) if fuse else 0,
                down0=0, down1=int(fuse), has_bias0=int(cfg.conv0_with_bias),
                has_bias1=int(fuse), fuse=int(fuse))


def _case_pair_conv(calls):
    """A row range of the output from a row slice of the input, inside
    widened intermediate bounds."""
    op, rng = _pair()
    x = _s8(rng, op.sin.array_shape(2))[:, 16:]
    M.pair_conv_cuda(op, x, rows=(2, 4), row0_off=1, mid_bounds=(1, 7))
    a, b = op.op_a, op.op_b
    # pooled output rows [2, 4) of a pooled spec with halo 1: unpooled array
    # rows [4, 8), image rows [2, 6)
    return {"src": x, "corr0_a": a.corr0, "bias0_a": a.bias0,
            "scale0_a": a.scale0, "bias1_a": a.bias1, "scale1_a": a.scale1,
            "wmaps_a": _maps_of(calls, "packed_weight_maps", a.w0k),
            "bias0_b": b.bias0, "scale0_b": b.scale0, "bias1_b": None,
            "scale1_b": None,
            "wmaps_b": _maps_of(calls, "packed_weight_maps", b.w0k),
            "layer_a": _layer(op.cfg_a, 32), "layer_b": _layer(op.cfg_b, 64),
            "geo": dict(iwp=16, col_off_in=2, mh=8, mw=10, oh=8, ow=10,
                        col_off_out=2, pool2=1),
            "rows": dict(halo_in=2, rows_out=4, halo_out=-2, oy0=2, noy=4,
                         mlo=1, mhi=7)}


def _case_pair_plan(calls):
    op, _ = _pair()
    order = _enum_fields("PairLayer")
    plan = M.pair_conv_plan(op, 3)
    assert plan["tile_rows"] == 100 and plan["layer_a_blocks"] == 109
    return {"layer_a": [_layer(op.cfg_a, 32)[f] for f in order],
            "layer_b": [_layer(op.cfg_b, 64)[f] for f in order],
            "geo": [3, 16, 14, 3, 2, 8, 10, 8, 10, 12, 2, 2, 1, 0, 8, 0, 8]}


def _assert_passed(name, arg, got, want):
    what = f"{name}({arg})"
    if isinstance(want, dict):
        fields = _enum_fields(ENUMS[name, arg])
        assert sorted(fields) == sorted(want), what
        want = [want[f] for f in fields]
    if want is None:
        assert got is None, what
    elif isinstance(want, torch.Tensor):
        assert isinstance(got, torch.Tensor) and got.dtype == want.dtype, what
        assert torch.equal(got, want), what
    elif isinstance(want, (list, tuple)) and isinstance(want[0],
                                                        torch.Tensor):
        assert len(got) == len(want), what
        for g, w in zip(got, want):
            _assert_passed(name, arg, g, w)
    elif isinstance(want, (list, tuple)):
        assert list(got) == list(want), what
    else:
        assert type(got) is type(want) and got == want, what


@pytest.mark.parametrize("name", OPS)
def test_wrapper_passes_the_config_to_the_schema(name, recorded_ops):
    """Each op's schema (as csrc/*.cpp registers it), defined here with a
    CPU kernel that records its arguments, bound by the dispatcher to the
    call that the op's real wrapper makes on CPU tensors: every argument,
    name by name, is the config's value (an int[]'s ints in the order of
    the C++ enum that reads them), the buffers the op's own, one launch
    counted per launch op."""
    before = _build.launch_counts()
    want = globals()[f"_case_{name}"](recorded_ops)
    rec = recorded_ops[name][-1]["args"]
    parsed = torch._C.parse_schema(_schemas()[name])
    assert [a.name for a in parsed.arguments] == list(want)
    for arg in parsed.arguments:
        _assert_passed(name, arg.name, rec[arg.name], want[arg.name])
    counted = {k: v - before[k] for k, v in _build.launch_counts().items()
               if v != before[k]}
    kernel = {"conv_fused": "conv_fused", "convpool": "convpool",
              "pool": "pool", "sum_relu": "sum_relu",
              "packed_conv": "packed_conv", "concat_relu": "concat_relu",
              "packed_sum_pool": "packed_sum_pool",
              "pair_conv": "pair_conv", "unfold_cols": "unfold_cols",
              "depthwise": "depthwise"}.get(name)
    assert counted == ({kernel: 1} if kernel else {})


def test_concat_relu_schema_takes_what_concat_cuda_passes(monkeypatch):
    """The schema registered in torch_ops.cpp, defined here with a CPU
    kernel that records its arguments, bound by the dispatcher to the call
    that concat_cuda makes: same namespace and name, the inputs as the
    Tensor[] and cfg.with_relu as the bool; the launches the op returns
    are what concat_cuda adds to K2's count, and nothing else."""
    schema = _schemas()["concat_relu"]
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
    _build.op.cache_clear()
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
        _build.op.cache_clear()


@pytest.mark.parametrize("n_in", [2, 17, 40, 130])
def test_concat_cuda_hands_the_op_every_input_in_one_call(n_in,
                                                          recorded_ops):
    """However many inputs there are, concat_cuda makes one call of the
    op with all of them, as they are and in order: the launcher, not the
    wrapper, decides how many launches they take."""
    rng = np.random.default_rng(n_in)
    xs = [_u8(rng, (1, 2, 3, 16 * (1 + i % 3))) for i in range(n_in)]
    cfg = ConcatConfig.make([tuple(x.shape) for x in xs], torch.uint8, True)
    concat_cuda(xs, cfg)
    calls = recorded_ops["concat_relu"]
    assert len(calls) == 1
    srcs = calls[0]["args"]["srcs"]
    assert len(srcs) == n_in and all(
        a.data_ptr() == b.data_ptr() and a.shape == b.shape
        for a, b in zip(srcs, xs))


# (lane widths of the left inputs, lanes of r)
UNJOINED_SUM_POOL = {
    "five inputs of 32": ((32,) * 5, 160),
    "8 + 24 lanes": ((8, 24), 32),
    "six mixed widths": ((8, 8, 16, 32, 64, 128), 256),
    "r of 40 lanes": ((8, 32), 40),
}


@pytest.mark.parametrize("pool", [True, False])
@pytest.mark.parametrize("label", sorted(UNJOINED_SUM_POOL))
def test_packed_sum_pool_hands_the_op_its_inputs_unjoined(label, pool,
                                                          recorded_ops):
    """The sums take any count of inputs of any lane widths: the wrapper
    hands the op its inputs and r as they are (no lane join, no pad
    lanes) in one call, and counts one launch."""
    cps, rcp = UNJOINED_SUM_POOL[label]
    rng = np.random.default_rng(rcp)
    ys = [_s8(rng, (2, 4 * 16, c)) for c in cps]
    r = _s8(rng, (2, 4 * 16, rcp))
    before = _build.launch_counts()["packed_sum_pool"]
    P.packed_sum_pool_cuda(ys, r, pool, 4, 16)
    assert _build.launch_counts()["packed_sum_pool"] - before == 1
    calls = recorded_ops["packed_sum_pool"]
    assert len(calls) == 1
    args = calls[0]["args"]
    assert len(args["ys"]) == len(ys) and all(
        a.data_ptr() == b.data_ptr() and a.shape == b.shape
        for a, b in zip(args["ys"], ys))
    assert args["r"].data_ptr() == r.data_ptr() and args["r"].shape == r.shape
    assert (args["rows"], args["iwp"], args["pool"]) == (4, 16, pool)


@pytest.mark.parametrize("cp", [16, 8])
def test_packed_pool_alone_hands_the_op_pool_and_refuses_neither(
        cp, recorded_ops):
    """Without r the wrapper hands the op the pool (narrow lanes padded to
    16) and one launch; a call that asks for neither the sum nor the pool
    is refused before the op."""
    y = _s8(np.random.default_rng(cp), (2, 4 * 16, cp))
    P.packed_sum_pool_cuda([y], None, True, 4, 16)
    calls = recorded_ops["packed_sum_pool"]
    assert len(calls) == 1
    args = calls[0]["args"]
    assert args["r"] is None and args["pool"] is True
    assert len(args["ys"]) == 1 and args["ys"][0].shape == (2, 64, 16)
    with pytest.raises(CheckError, match="needs r or the pool"):
        P.packed_sum_pool_cuda([y], None, False, 4, 16)
    assert len(calls) == 1


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


@pytest.mark.parametrize("name", ["concat.cu", "conv.cu", "unfold.cu"])
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
    assert names == {f.name for f in _build.CSRC.glob("*.cu")} | set(
        _cpp_sources())


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


def _tiled_case(sum_dt, dst, oc1, sum_scale=1.0):
    """A small conv (3x3, 32 lanes; fused with a 1x1 of oc1 lanes where
    oc1 is set) into dst, with a sum operand of sum_dt at sum_scale or
    none."""
    rng = np.random.default_rng(23)
    oc = oc1 or 32
    w = rng.integers(-128, 128, (32, 16, 3, 3)).astype(np.int8)
    w1 = rng.integers(-128, 128, (oc1, 32, 1, 1)).astype(np.int8) \
        if oc1 else None
    cfg = ConvConfig.make((2, 6, 6, 16), w.shape, None, (1, 1), (1, 1),
                          (2, 6, 6, oc), dst, conv0_scales=(1 / 3000,),
                          wei1x1_shape=None if w1 is None else w1.shape,
                          sum_dt=sum_dt, sum_scale=sum_scale)
    op = ConvOp(cfg, w, None, w1, device="cpu")
    s = None if sum_dt is None else torch.zeros(
        (2, 6, 6, oc), dtype=dtype.from_any(sum_dt).torch)
    return op, _u8(rng, (2, 6, 6, 16)), s


@pytest.mark.parametrize("sum_dt, dst, oc1, tiled, sum_scale", [
    ("u8", "u8", 32, True, 1.0), ("s8", "s8", 48, True, 1.0),
    ("s8", "u8", 256, True, 1.0), ("s32", "u8", 32, False, 1.0),
    ("f32", "s8", 32, False, 1.0), ("u8", "u8", 40, False, 1.0),
    ("u8", "s32", 32, False, 1.0), ("u8", "f32", 32, False, 1.0),
    ("u8", "u8", None, False, 1.0), (None, "u8", 32, False, 1.0),
    ("u8", "u8", 32, True, 8192.0), ("s8", "u8", 32, False, 9000.0)])
def test_conv_cuda_counts_the_tiled_sum_mode(recorded_ops, sum_dt, dst, oc1,
                                            tiled, sum_scale):
    """The launches that read the sum operand as tiles are those of the
    fused conv with a 1-byte sum into a 1-byte dst whose pitch is a
    multiple of 16, joined in the integer domain (|sum_scale| up to 8192;
    csrc/conv.cu: tiled_sum), counted as the mode
    conv_fused.sum_tile beside the launch; the launch passes the sum's
    dtype code and its scale, from which the kernel decides the same."""
    op, x, s = _tiled_case(sum_dt, dst, oc1, sum_scale)
    assert C.tiled_sum(op.cfg) is tiled
    _build.reset_launch_counts()
    C.conv_cuda(op, x, s)
    assert _build.launch_counts()["conv_fused"] == 1
    assert _build.mode_counts()["conv_fused.sum_tile"] == int(tiled)
    (rec,) = recorded_ops["conv_fused"]
    assert rec["args"]["geo"][-1] == (
        0 if sum_dt is None else dtype.from_any(sum_dt).value)


_PAST = float(np.nextafter(np.float32(C.INT_SUM_SCALE_MAX),
                           np.float32(np.inf)))


@pytest.mark.parametrize("sum_dt, dst, oc1, sum_scale, ints", [
    ("u8", "u8", 32, 1.0, True), ("s8", "u8", 256, 1.0, True),
    ("s8", "s8", 48, -0.5, True), ("u8", "u8", 40, 1.0, True),
    ("u8", "s8", None, 2.0, True), (None, "s8", 32, 1.0, True),
    (None, "s8", None, 1.0, True), ("u8", "u8", 32, 8192.0, True),
    ("s8", "u8", 32, -8192.0, True), ("u8", "u8", 32, _PAST, False),
    ("s8", "s8", None, -_PAST, False), ("s32", "u8", 32, 1.0, False),
    ("f32", "s8", 32, 1.0, False), ("u8", "s32", 32, 1.0, False),
    ("u8", "f32", None, 1.0, False), (None, "u8", 32, 1.0, False),
    (None, "u8", None, 1.0, False), (None, "s32", 32, 1.0, False)])
def test_conv_cuda_counts_the_integer_requant_mode(recorded_ops, sum_dt, dst,
                                                   oc1, sum_scale, ints):
    """The launches whose final stage requantizes in the integer domain are
    those into a 1-byte dst with a 1-byte sum at |sum_scale| up to the
    bound (8192), or into s8 with no sum (csrc/conv.cu: int_sum), fused or
    not, tiled or not, counted as the mode conv_fused.int_requant beside
    the launch; the launch passes the sum's dtype code and its scale, from
    which the kernel decides the same. A u8 dst without a sum
    (requant_u8) is not counted."""
    op, x, s = _tiled_case(sum_dt, dst, oc1, sum_scale)
    assert C.int_requant(op.cfg) is ints
    _build.reset_launch_counts()
    C.conv_cuda(op, x, s)
    assert _build.launch_counts()["conv_fused"] == 1
    modes = _build.mode_counts()
    assert modes["conv_fused.int_requant"] == int(ints)
    assert modes["conv_fused.sum_tile"] == int(C.tiled_sum(op.cfg))
    (rec,) = recorded_ops["conv_fused"]
    assert rec["args"]["geo"][-1] == (
        0 if sum_dt is None else dtype.from_any(sum_dt).value)
    assert rec["args"]["sum_scale"] == np.float32(sum_scale)


@pytest.mark.parametrize("dst, relu, sum_dt", [("u8", True, None),
                                                ("s8", False, None),
                                                ("s8", False, "s8")])
def test_conv_cuda_hands_an_s8_source_over_and_counts_the_mode(
        recorded_ops, dst, relu, sum_dt):
    """A conv whose config reads an s8 source takes the s8 tensor itself
    to the launch (the op reads its dtype from it), counted as the mode
    conv_fused.s8_src; a u8 tensor is refused before any launch. The card
    runs such a conv unfused into u8 only (conv_fused_s8src_kernel), and
    the config refuses it into s8, so neither path computes it."""
    rng = np.random.default_rng(27)
    w = rng.integers(-128, 128, (32, 48, 1, 1)).astype(np.int8)
    make = functools.partial(
        ConvConfig.make, (2, 5, 5, 48), w.shape, None, (1, 1), (0, 0),
        (2, 5, 5, 32), dst, src_dt="s8", conv0_relu=relu,
        conv0_scales=(1 / 900,), sum_dt=sum_dt)
    if dst != "u8":
        with pytest.raises(CheckError, match="s8 conv source"):
            make()
        return
    op = ConvOp(make(), w, device="cpu")
    x = _s8(rng, (2, 5, 5, 48))
    s = None if sum_dt is None else _s8(rng, (2, 5, 5, 32))
    with pytest.raises(CheckError, match="conv src dtype"):
        op(x.view(torch.uint8), sum_src=s)
    _build.reset_launch_counts()
    C.conv_cuda(op, x, s)
    assert _build.launch_counts()["conv_fused"] == 1
    assert {k: v for k, v in _build.mode_counts().items() if v} == {
        "conv_fused.s8_src": 1}
    (rec,) = recorded_ops["conv_fused"]
    assert rec["args"]["src"] is x


def test_conv_cuda_acc1_counts_no_integer_requant(recorded_ops):
    """The raw 1x1 accumulator's launch (emit_acc1) has no final requant,
    whatever its config's dst: counted as conv_fused.acc1 alone."""
    op, x, _ = _tiled_case(None, "s8", 32)
    _build.reset_launch_counts()
    C.conv_cuda(op, x, emit_acc1=True)
    assert {k: v for k, v in _build.mode_counts().items() if v} == {
        "conv_fused.acc1": 1}


def test_conv_cuda_unfolds_a_narrow_input_and_counts_the_mode(recorded_ops,
                                                             monkeypatch):
    """A conv over fewer than 16 channels under a kernel wider than 1: its
    input goes through the unfold op, whose output the conv launch takes
    at the unfolded geometry (a kh x 1 conv of stride (sh, 1), 32
    channels, no column padding) with the op's derived weights; one launch
    of each, and the conv's counted as the mode conv_fused.unfold. Here on
    CPU tensors, the unfold's plain version stood in by its wrapper."""
    op, rng = _narrow_conv()
    x = _u8(rng, (2, 11, 16, 3))
    monkeypatch.setattr(C, "unfold_cols_plain", C.unfold_cols_cuda)
    _build.reset_launch_counts()
    C.conv_cuda(op, x)
    counts, modes = _build.launch_counts(), _build.mode_counts()
    _build.reset_launch_counts()
    assert {k: v for k, v in counts.items() if v} == {"conv_fused": 1,
                                                      "unfold_cols": 1}
    assert {k: v for k, v in modes.items() if v} == {"conv_fused.unfold": 1}
    (unf,) = recorded_ops["unfold_cols"]
    (rec,) = recorded_ops["conv_fused"]
    assert unf["args"]["src"] is x and rec["args"]["src"] is unf["out"]
    fields = _enum_fields("ConvGeo")
    geo = dict(zip(fields, rec["args"]["geo"]))
    assert {k: geo[k] for k in ("ih", "iw", "ic", "oh", "ow", "kh", "kw",
                                "sh", "sw", "ph", "pw")} == dict(
        ih=11, iw=6, ic=32, oh=6, ow=6, kh=5, kw=1, sh=2, sw=1, ph=2, pw=0)
    (maps,) = recorded_ops["conv_weight_maps"]
    assert maps["args"]["w0k"] is op.w0k
    assert tuple(op.w0k.shape) == (layout.conv_ocp(20), 5 * 32)
