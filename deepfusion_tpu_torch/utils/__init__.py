from . import device, env, logger, mathutil  # noqa: F401
from .logger import CheckError, check, check_eq, info  # noqa: F401
from .mathutil import (  # noqa: F401
    balance211, conv_output_size, div_up, one_of, pool_output_size, round_up)
