from .concat import concat  # noqa: F401
from .conv import ConvOp, conv  # noqa: F401
from .pool import eltwise_sum_relu, pool  # noqa: F401
