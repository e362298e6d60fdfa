"""Sharded execution over a (dp, sp, tp) mesh of torch devices: the
PyTorch counterpart of ``deepfusion_tpu.parallel``. The JAX package's
``distributed`` (processes across hosts) is not ported yet."""
from . import mesh, shard  # noqa: F401
from .mesh import factorize_mesh, make_mesh  # noqa: F401
from .shard import (dp_shard, sp_conv, sp_packed, tp_fused_conv,  # noqa: F401
                    tp_packed_fused)
