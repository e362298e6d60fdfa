"""Output-size formulas and partition helpers.

Reference parity: ``util/math_func.cc:22-28`` and
``util/deepfusion_utils.h:91-208``.
"""
from __future__ import annotations

from typing import Tuple


def conv_output_size(image: int, kernel: int, stride: int, padding: int) -> int:
    """(i + 2p - k) / s + 1 (``util/math_func.cc:22-24``)."""
    return (image + 2 * padding - kernel) // stride + 1


def pool_output_size(image: int, kernel: int, stride: int, padding: int) -> int:
    """Ceil-mode pooling output size (``util/math_func.cc:26-28``)."""
    return (image + 2 * padding - kernel + stride - 1) // stride + 1


def div_up(a: int, b: int) -> int:
    return -(-a // b)


def round_up(a: int, b: int) -> int:
    return div_up(a, b) * b


def one_of(x, *args) -> bool:
    return x in args


def balance211(amount: int, team: int, member: int) -> Tuple[int, int]:
    """Near-equal contiguous split of `amount` items over `team` workers;
    returns the [start, end) range of `member`
    (``util/deepfusion_utils.h:190-208``)."""
    if team <= 1 or amount <= 1:
        return (0, amount) if member == 0 else (amount, amount)
    base = amount // team
    extra = amount % team
    if member < extra:
        start = member * (base + 1)
        end = start + base + 1
    else:
        start = extra * (base + 1) + (member - extra) * base
        end = start + base
    return start, end
