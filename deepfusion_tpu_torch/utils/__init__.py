from . import device, env, logger, mathutil, profiler  # noqa: F401
from .logger import (  # noqa: F401
    CheckError, check, check_eq, check_ge, check_gt, check_le, check_lt,
    check_ne, debug, error_and_exit, get_current_ms, info, warning)
from .mathutil import (  # noqa: F401
    all_true, balance211, conv_output_size, div_up, dividable_of,
    find_dividable, nd_iterator_init, nd_iterator_step, nd_range, one_of,
    pool_output_size, round_up)
