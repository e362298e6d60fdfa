"""The PyTorch port stands alone: no JAX, no JAX package, no CPU fallback.

Importing ``deepfusion_tpu_torch`` and every module of the ported slice must
load neither ``jax`` nor ``deepfusion_tpu``, and must build no kernel. A
tensor that is not on the CPU never takes the plain path: it goes to the
kernel wrapper, which launches or raises.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from deepfusion_tpu_torch import _build
from deepfusion_tpu_torch.ops.concat import concat
from deepfusion_tpu_torch.ops.pool import eltwise_sum_relu, pool

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODULES = [
    "deepfusion_tpu_torch", "deepfusion_tpu_torch.types",
    "deepfusion_tpu_torch.config", "deepfusion_tpu_torch._build",
    "deepfusion_tpu_torch.utils.logger", "deepfusion_tpu_torch.utils.mathutil",
    "deepfusion_tpu_torch.utils.env", "deepfusion_tpu_torch.utils.persist",
    "deepfusion_tpu_torch.ops.layout", "deepfusion_tpu_torch.ops.requant",
    "deepfusion_tpu_torch.ops.conv", "deepfusion_tpu_torch.ops.concat",
    "deepfusion_tpu_torch.ops.pool", "deepfusion_tpu_torch.ops.packed",
    "deepfusion_tpu_torch.ops.convpool", "deepfusion_tpu_torch.ops.mega",
    "deepfusion_tpu_torch.models.fusionnet",
    "deepfusion_tpu_torch.models.resfusion",
    "deepfusion_tpu_torch.models.vggfusion",
    "deepfusion_tpu_torch.models.graphed",
    "deepfusion_tpu_torch.serving", "deepfusion_tpu_torch.parallel",
    "deepfusion_tpu_torch.parallel.mesh",
    "deepfusion_tpu_torch.parallel.shard",
    "deepfusion_tpu_torch.parallel.plan",
    "deepfusion_tpu_torch.api", "deepfusion_tpu_torch.utils.profiler",
    "deepfusion_tpu_torch.utils.device",
    "deepfusion_tpu_torch.parallel.distributed",
]


def test_port_imports_no_jax():
    code = (
        "import importlib, sys\n"
        f"for m in {MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules\n"
        "             if k == 'jax' or k.startswith('jax.')\n"
        "             or k == 'deepfusion_tpu' or k.startswith('deepfusion_tpu.'))\n"
        "assert not bad, bad\n"
        "from deepfusion_tpu_torch import _build\n"
        "assert _build._lib is None\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("op", ["conv", "concat", "pool", "sum_relu",
                                "packed_conv", "packed_sum_pool",
                                "convpool", "pair_conv", "sharded",
                                "object_api", "packed_conv_grouped"])
def test_non_cpu_tensors_never_take_the_plain_path(op, monkeypatch):
    """On a tensor that is not on the CPU each op goes to its kernel
    wrapper; with no kernel library to be had, it raises."""
    def no_kernels():
        raise RuntimeError("kernel library requested")

    monkeypatch.setattr(_build, "kernels", no_kernels)
    x = torch.zeros((1, 4, 4, 16), dtype=torch.uint8, device="meta")
    with pytest.raises((RuntimeError, ValueError, NotImplementedError)):
        if op == "conv":
            from deepfusion_tpu_torch.ops.conv import conv
            conv(x, np.zeros((16, 16, 1, 1), np.int8), dst_dtype="u8",
                 device="cpu")
        elif op == "concat":
            concat([x, x], post_relu=True, device="cpu")
        elif op == "pool":
            pool(x, "max", (2, 2), (2, 2), (0, 0), device="cpu")
        elif op == "sum_relu":
            eltwise_sum_relu(x, x, device="cpu")
        elif op == "convpool":
            from deepfusion_tpu_torch.ops.pool import conv_relu_pool
            conv_relu_pool(x, np.zeros((16, 16, 3, 3), np.int8), None,
                           (1, 1), (1, 1), dst_dtype="u8", device="cpu")
        elif op == "sharded":
            from deepfusion_tpu_torch.config import ConvConfig
            from deepfusion_tpu_torch.parallel import make_mesh, tp_fused_conv
            cfg = ConvConfig.make((1, 4, 4, 16), (16, 16, 3, 3), None,
                                  (1, 1), (1, 1), (1, 4, 4, 16), "u8",
                                  wei1x1_shape=(16, 16, 1, 1))
            w = np.zeros((16, 16, 3, 3), np.int8)
            fn = tp_fused_conv(cfg, w, None, w[:, :, :1, :1], None,
                               make_mesh(tp=2, devices=["meta"] * 2))
            fn(x)
        elif op == "object_api":
            # host data, an op built for another device: uploaded there,
            # then the kernel wrapper (never the plain version)
            import deepfusion_tpu_torch as df
            a = df.memory([1, 16, 4, 4], df.format.nhwc, df.u8)
            dst = df.memory([1, 32, 4, 4], df.format.nhwc, df.u8)
            df.concat([a, a], dst, post_relu=True, device="meta").submit()
        elif op == "packed_conv_grouped":
            # five inputs of 8 lanes: joined into the kernel's inputs, then
            # the kernel wrapper
            from deepfusion_tpu_torch.config import ConvConfig
            from deepfusion_tpu_torch.ops.packed import (PackedConvOp,
                                                         PackedSpec)
            cfg = ConvConfig.make((1, 4, 4, 40), (16, 40, 1, 1), None,
                                  (1, 1), (0, 0), (1, 4, 4, 16), "u8")
            sins = tuple(PackedSpec.make(4, 4, 8, cp=8) for _ in range(4)) \
                + (PackedSpec.make(4, 4, 8, cp=32),)
            pop = PackedConvOp(cfg, np.zeros((16, 40, 1, 1), np.int8),
                               sin=sins, device="meta")
            assert len(pop.kernel_sins) == 3
            pop(tuple(torch.zeros(s.array_shape(1), dtype=torch.int8,
                                  device="meta") for s in sins))
        elif op == "pair_conv":
            from deepfusion_tpu_torch.config import ConvConfig
            from deepfusion_tpu_torch.ops.mega import PackedConvPairOp
            cfg = ConvConfig.make((1, 4, 4, 16), (16, 16, 3, 3), None,
                                  (1, 1), (1, 1), (1, 4, 4, 16), "u8")
            w = (np.zeros((16, 16, 3, 3), np.int8),)
            pair = PackedConvPairOp(cfg, w, cfg, w, device="meta")
            pair(torch.zeros(pair.sin.array_shape(1), dtype=torch.int8,
                             device="meta"))
        elif op == "packed_conv":
            from deepfusion_tpu_torch.config import ConvConfig
            from deepfusion_tpu_torch.ops.packed import PackedConvOp
            cfg = ConvConfig.make((1, 4, 4, 16), (16, 16, 1, 1), None,
                                  (1, 1), (0, 0), (1, 4, 4, 16), "u8")
            pop = PackedConvOp(cfg, np.zeros((16, 16, 1, 1), np.int8),
                               device="meta")
            pop(torch.zeros(pop.sin.array_shape(1), dtype=torch.int8,
                            device="meta"))
        else:
            from deepfusion_tpu_torch.ops.packed import (PackedSpec,
                                                         packed_sum_relu)
            spec = PackedSpec.make(4, 4, 32)
            a = torch.zeros(spec.array_shape(1), dtype=torch.int8,
                            device="meta")
            packed_sum_relu(a, a, spec)


def test_failed_build_raises(tmp_path, monkeypatch):
    """No nvcc: the build raises; nothing falls back."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.build()
    assert not list(tmp_path.glob("_build/*.so"))


def test_library_name_tracks_sources():
    a = _build.library_path()
    assert a.parent == _build.BUILD_DIR
    assert a.name.startswith("libdf_kernels-") and a.suffix == ".so"
    assert _build.library_path() == a


def test_launch_counts_reset():
    _build.reset_launch_counts()
    _build.count_launch("pool")
    assert _build.launch_counts()["pool"] == 1
    _build.reset_launch_counts()
    assert set(_build.launch_counts().values()) == {0}
    assert set(_build.launch_counts()) == set(_build.KERNELS)
