"""Sharded execution over a (dp, sp, tp) mesh of torch devices, and the
process group of a job of several processes: the PyTorch counterpart of
``deepfusion_tpu.parallel``."""
from . import distributed, mesh, shard  # noqa: F401
from .mesh import factorize_mesh, make_mesh  # noqa: F401
from .shard import (dp_shard, sp_conv, sp_packed, tp_fused_conv,  # noqa: F401
                    tp_packed_fused)
