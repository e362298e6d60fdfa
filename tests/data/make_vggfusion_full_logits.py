"""Write ``vggfusion_full_logits.npz``: golden VGGFusion logits from the JAX
package at the full published width (``VGGFusionConfig()`` defaults).

The logits come from the JAX package's dense forward
(``VGGFusion.__call__``) run on the CPU, with its Pallas kernels in
interpret mode. The input is
``VGGFusion.example_input(np.random.default_rng(INPUT_SEED))``; both the
seed and the model seed are stored beside the logits so a reader can
rebuild the same input and weights.

    JAX_PLATFORMS=cpu python tests/data/make_vggfusion_full_logits.py
"""
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

INPUT_SEED = 42
OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                   "vggfusion_full_logits.npz")


def main():
    import jax

    jax.config.update("jax_platforms", "cpu")
    from deepfusion_tpu.models import VGGFusion, VGGFusionConfig

    cfg = VGGFusionConfig()
    net = VGGFusion(cfg)
    x = net.example_input(np.random.default_rng(INPUT_SEED))
    t0 = time.perf_counter()
    logits = np.asarray(net(x))
    print(f"JAX dense forward (CPU, interpret mode): "
          f"{time.perf_counter() - t0:.1f} s, logits {logits.shape}")
    np.savez(OUT, logits=logits, input_seed=np.int64(INPUT_SEED),
             model_seed=np.int64(cfg.seed),
             source=np.str_("deepfusion_tpu VGGFusion.__call__ "
                            "(Pallas interpret mode, CPU)"))
    print(f"wrote {OUT}")


if __name__ == "__main__":
    main()
