"""Logging and fail-fast check helpers.

Reference parity: ``util/log.h:26-65``. A failed check raises ``CheckError``
before any kernel is launched, so a misconfigured op never runs.
"""
from __future__ import annotations

import inspect
import logging
import os
import sys
import time

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


def warning(fmt, *args):
    _logger.warning("%s %s", _loc(), (fmt % args) if args else fmt)


def debug(fmt, *args):
    _logger.debug("%s %s", _loc(), (fmt % args) if args else fmt)


class CheckError(ValueError):
    """Raised by the check* validators (reference: fatal exit at
    util/log.h:38-42)."""


def error_and_exit(fmt, *args):
    """Log the error and raise ``CheckError`` (the reference exits)."""
    msg = (fmt % args) if args else str(fmt)
    _logger.error("%s %s", _loc(), msg)
    raise CheckError(msg)


def check(cond, msg="check failed"):
    if not cond:
        raise CheckError(msg)


def check_eq(a, b, msg=""):
    if not a == b:
        raise CheckError(f"check_eq failed: {a!r} != {b!r} {msg}")


def check_ne(a, b, msg=""):
    if a == b:
        raise CheckError(f"check_ne failed: {a!r} == {b!r} {msg}")


def check_lt(a, b, msg=""):
    if not a < b:
        raise CheckError(f"check_lt failed: {a!r} >= {b!r} {msg}")


def check_le(a, b, msg=""):
    if not a <= b:
        raise CheckError(f"check_le failed: {a!r} > {b!r} {msg}")


def check_gt(a, b, msg=""):
    if not a > b:
        raise CheckError(f"check_gt failed: {a!r} <= {b!r} {msg}")


def check_ge(a, b, msg=""):
    if not a >= b:
        raise CheckError(f"check_ge failed: {a!r} < {b!r} {msg}")


def get_current_ms() -> float:
    """Wall clock in ms (reference: ``util/deepfusion_utils.h:257-261``)."""
    return time.perf_counter() * 1e3
