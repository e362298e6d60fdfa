"""Logging and fail-fast check helpers.

Reference parity: ``util/log.h:26-65``. A failed check raises ``CheckError``
before any kernel is launched, so a misconfigured op never runs.
"""
from __future__ import annotations

import inspect
import logging
import os
import sys

_logger = logging.getLogger("deepfusion_tpu_torch")
if not _logger.handlers:
    _h = logging.StreamHandler(sys.stderr)
    _h.setFormatter(logging.Formatter(
        "%(asctime)s [%(levelname)s] %(message)s", datefmt="%H:%M:%S"))
    _logger.addHandler(_h)
    _logger.setLevel(os.environ.get("DEEPFUSION_LOG", "INFO").upper())


def _loc() -> str:
    fr = inspect.stack()[2]
    return f"{os.path.basename(fr.filename)}:{fr.lineno}"


def info(fmt, *args):
    _logger.info("%s %s", _loc(), (fmt % args) if args else fmt)


class CheckError(ValueError):
    """Raised by the check* validators (reference: fatal exit at
    util/log.h:38-42)."""


def check(cond, msg="check failed"):
    if not cond:
        raise CheckError(msg)


def check_eq(a, b, msg=""):
    if not a == b:
        raise CheckError(f"check_eq failed: {a!r} != {b!r} {msg}")
