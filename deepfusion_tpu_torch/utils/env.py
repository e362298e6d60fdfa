"""Environment-variable feature toggles.

Reference parity: ``util/scaffold.cc:56-82``. ``DEEPFUSION_DUMP_CODE`` keeps
the compiler's register and shared-memory report (``nvcc -Xptxas -v``) of
the kernel build beside the built library (``_build.py``): that report
takes the place of the JAX package's dump of lowered code
(``maybe_dump_lowered``, not ported). ``DEEPFUSION_PROFILE`` asks for
per-submit timing, which the object API's ``op.submit()`` logs
(``utils/profiler.py:submit_timer``). Neither changes which path an op
takes: a CPU tensor runs the plain PyTorch version, a CUDA tensor runs the
kernel.
"""
from __future__ import annotations

import os

_TRUTHY = ("1", "true", "yes", "on")


def _env_flag(name: str) -> bool:
    return os.environ.get(name, "").lower() in _TRUTHY


def is_profiling() -> bool:
    """Reference: ``utils::is_profiling`` (util/scaffold.cc:56-66)."""
    return _env_flag("DEEPFUSION_PROFILE")


def dump_code() -> bool:
    """Reference: ``utils::jit_dump_code`` (util/scaffold.cc:71-82)."""
    return _env_flag("DEEPFUSION_DUMP_CODE")
