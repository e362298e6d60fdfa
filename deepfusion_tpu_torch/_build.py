"""Build and load the package's CUDA kernels, and count their launches.

``csrc/*.cu`` and ``csrc/*.cpp`` are compiled at first use by ``nvcc``, one
process per source, all started together, and linked into one shared
library, ``_build/libdf_kernels-<hash>.so``. The ``.cu`` files keep out of
PyTorch's headers: each kernel family has a plain C++ launcher, declared in
its ``csrc/*.h``. The ``.cpp`` files register the library's PyTorch
operators (``torch.ops.deepfusion_torch``), one per launch entry point,
which call those launchers: they are compiled with PyTorch's include paths,
the C++ standard the installed PyTorch builds its extensions with and its
``_GLIBCXX_USE_CXX11_ABI``, and the library is linked against libtorch. The
name carries a hash of the sources, the flags, the PyTorch version, its ABI
and its include paths, so an edit or another PyTorch rebuilds; the library
is written under a temporary name and moved into place with ``os.replace``,
so a process never loads a half-written file. A failed build or load
raises: there is no fallback to the plain PyTorch versions. The sources and
the flags (``DEEPFUSION_DUMP_CODE``) are read once per process, at the first
``kernels()``, which also loads the library with ``torch.ops.load_library``
(which runs its operator registrations); every later call returns the path
it loaded, so a launch hashes and opens nothing.

An operator checks its arguments, allocates its output, guards the device,
takes the current stream and launches in C++, and raises itself; ``op``
looks one up once. Each wrapper counts its launches per kernel
(``launch_counts``) and, for the modes the sharded wrappers use and the
packed conv's merge_pool, per mode (``mode_counts``); ``snapshot_counts``
and ``add_counts`` move a captured forward's counts to its replays.
"""
from __future__ import annotations

import functools
import hashlib
import inspect
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path

import torch

from .utils import env

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH_FLAGS + ("-std=c++17", "-O3", "--fmad=false", "-Xcompiler",
                           "-fPIC", "-I/usr/local/cutlass/include")
# the PyTorch libraries the operator registrations (csrc/*.cpp) call into
TORCH_LIBS = ("torch", "torch_cpu", "torch_cuda", "c10", "c10_cuda")

KERNELS = ("conv_fused", "concat_relu", "pool", "sum_relu", "packed_conv",
           "packed_sum_pool", "convpool", "pair_conv", "unfold_cols",
           "depthwise")
# kernel modes counted on their own: the raw 1x1 accumulator (emit_acc1),
# an output row range (or input row slice), the widened intermediate
# bounds, the packed conv's residual merge and pool (merge_pool), the
# dense conv's sum operand read as tiles (ops/conv.py: tiled_sum), the
# dense conv over its column taps folded into channels (unfold_cols), its
# final stage requantized in the integer domain (int_requant), the dense
# conv over an s8 source (s8_src)
MODES = ("conv_fused.acc1", "packed_conv.acc1", "packed_conv.rows",
         "pair_conv.rows", "pair_conv.bounds", "packed_conv.merge_pool",
         "conv_fused.sum_tile", "conv_fused.unfold", "conv_fused.int_requant",
         "conv_fused.s8_src")

_counts_lock = threading.Lock()
_counts = dict.fromkeys(KERNELS, 0)
_modes = dict.fromkeys(MODES, 0)


def count_launch(name: str, *modes: str) -> None:
    """Add one to `name`'s launch count and to each of its `modes`; each
    wrapper calls this right after its kernel launched."""
    with _counts_lock:
        _counts[name] += 1
        for m in modes:
            _modes[f"{name}.{m}"] += 1


def launch_counts() -> dict:
    with _counts_lock:
        return dict(_counts)


def mode_counts() -> dict:
    with _counts_lock:
        return dict(_modes)


def reset_launch_counts() -> None:
    with _counts_lock:
        for d in (_counts, _modes):
            for k in d:
                d[k] = 0


def snapshot_counts() -> dict:
    """Every launch and mode count in one dict (kernel names and
    ``kernel.mode`` names never collide): the base of a delta that
    ``add_counts`` can take out or put back."""
    with _counts_lock:
        return {**_counts, **_modes}


def add_counts(delta: dict, times: int = 1) -> None:
    """Add `times` x `delta` (a difference of two ``snapshot_counts``) to
    the counts. A CUDA graph runs its wrappers' ``count_launch`` once, at
    capture, when the card runs nothing: the graphed callable takes that
    delta out after the capture (``times=-1``) and puts it back at every
    replay, so the counts keep saying what ran on the card."""
    with _counts_lock:
        for k, v in delta.items():
            (_counts if k in _counts else _modes)[k] += v * times


def _cuda_home() -> Path:
    """$CUDA_HOME, else /usr/local/cuda, else the toolkit of the nvcc on
    the PATH."""
    home = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    found = shutil.which("nvcc")
    if not (home / "bin" / "nvcc").exists() and found is not None:
        home = Path(found).parent.parent
    return home


def _nvcc() -> str:
    nvcc = _cuda_home() / "bin" / "nvcc"
    if not nvcc.exists():
        raise RuntimeError("nvcc not found: the CUDA kernels of "
                           "deepfusion_tpu_torch need the CUDA toolkit")
    return str(nvcc)


def _flags() -> tuple:
    return NVCC_FLAGS + (("-Xptxas", "-v") if env.dump_code() else ())


def _torch_cxx_std() -> str:
    """The C++ standard the installed PyTorch compiles its own extensions
    with (``torch.utils.cpp_extension``), which its headers need."""
    from torch.utils import cpp_extension
    found = re.findall(r"-std=c\+\+(\d\d)", inspect.getsource(cpp_extension))
    return f"c++{max(found, default='17')}"


def torch_flags() -> tuple:
    """nvcc's flags for the .cpp sources, the only ones that include
    PyTorch's headers: its standard, its ABI, its include paths and the
    CUDA runtime's."""
    from torch.utils import cpp_extension
    incs = (*cpp_extension.include_paths(), str(_cuda_home() / "include"))
    return (f"-std={_torch_cxx_std()}", "-O2", "-Xcompiler", "-fPIC",
            f"-D_GLIBCXX_USE_CXX11_ABI={int(torch._C._GLIBCXX_USE_CXX11_ABI)}",
            *(f"-I{p}" for p in incs))


def torch_link_flags() -> tuple:
    """The link's flags for libtorch: its directory, its libraries and an
    rpath to them."""
    from torch.utils import cpp_extension
    lib = cpp_extension.library_paths()[0]
    return (f"-L{lib}", *(f"-l{name}" for name in TORCH_LIBS), "-Xlinker",
            f"-rpath={lib}")


def compile_cmd(nvcc: str, src: Path, obj: Path) -> list:
    """The nvcc command that compiles one source of csrc/ into `obj`."""
    flags = torch_flags() if src.suffix == ".cpp" else _flags()
    return [nvcc, *flags, "-c", "-o", str(obj), str(src)]


def link_cmd(nvcc: str, objs, out: Path) -> list:
    """The nvcc command that links the objects into the library."""
    return [nvcc, *ARCH_FLAGS, "-shared", "-o", str(out),
            *[str(o) for o in objs], *torch_link_flags()]


def _sources() -> list:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cpp"))


def library_path() -> Path:
    """Where the library for the current sources, flags and PyTorch
    lives."""
    h = hashlib.sha256(" ".join(_flags() + torch_flags() + torch_link_flags()
                                + (torch.__version__,)).encode())
    for f in sorted(CSRC.iterdir()):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"libdf_kernels-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile csrc/*.cu and csrc/*.cpp into the library unless it
    already exists: one nvcc process per source, all running at once, then
    one link."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    tmp = out.with_name(f"{tag}.tmp.so")
    objs = BUILD_DIR / f"{tag}.obj"
    objs.mkdir(exist_ok=True)
    try:
        nvcc = _nvcc()
        jobs = []
        for f in _sources():
            cmd = compile_cmd(nvcc, f, objs / f"{f.stem}.o")
            jobs.append((cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)))
        logs = [proc.communicate()[1] for _, proc in jobs]
        for (cmd, proc), err in zip(jobs, logs):
            _raise_if_failed(proc.returncode, cmd, err)
        cmd = link_cmd(nvcc, sorted(objs.glob("*.o")), tmp)
        proc = subprocess.run(cmd, capture_output=True, text=True)
        _raise_if_failed(proc.returncode, cmd, proc.stderr)
        if env.dump_code():
            out.with_suffix(".ptxas.txt").write_text("".join(logs))
        os.replace(tmp, out)
    finally:
        tmp.unlink(missing_ok=True)
        shutil.rmtree(objs, ignore_errors=True)
    return out


def _raise_if_failed(rc: int, cmd: list, err: str) -> None:
    if rc != 0:
        raise RuntimeError(f"nvcc failed ({rc}):\n{' '.join(cmd)}\n{err}")


_lib = None
_lib_lock = threading.Lock()


def kernels() -> Path:
    """The loaded kernel library's path. The process's first call, under a
    lock (``BatchServer`` launches from its own thread), builds the library
    if needed and loads it once, which registers its operators; every later
    call returns that same path and reads no file."""
    global _lib
    if _lib is None:
        with _lib_lock:
            if _lib is None:
                path = build()
                torch.ops.load_library(str(path))
                _lib = path
    return _lib


@functools.cache
def op(name: str):
    """The default overload of ``torch.ops.deepfusion_torch.<name>``,
    looked up once the kernel library (which registers it) is loaded."""
    kernels()
    return getattr(torch.ops.deepfusion_torch, name).default
