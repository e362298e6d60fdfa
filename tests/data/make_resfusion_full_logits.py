"""Write ``resfusion_full_logits.npz``: golden ResFusionNet logits from the
JAX package at the full published width (``ResFusionNetConfig()`` defaults).

The logits come from the JAX package's dense forward
(``ResFusionNet.__call__``) run on the CPU, with its Pallas kernels in
interpret mode. The input is
``ResFusionNet.example_input(np.random.default_rng(INPUT_SEED))``; both the
seed and the model seed are stored beside the logits so a reader can
rebuild the same input and weights.

    JAX_PLATFORMS=cpu python tests/data/make_resfusion_full_logits.py
"""
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

INPUT_SEED = 7
OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                   "resfusion_full_logits.npz")


def main():
    import jax

    jax.config.update("jax_platforms", "cpu")
    from deepfusion_tpu.models import ResFusionNet, ResFusionNetConfig

    cfg = ResFusionNetConfig()
    net = ResFusionNet(cfg)
    x = net.example_input(np.random.default_rng(INPUT_SEED))
    t0 = time.perf_counter()
    logits = np.asarray(net(x))
    print(f"JAX dense forward (CPU, interpret mode): "
          f"{time.perf_counter() - t0:.1f} s, logits {logits.shape}")
    np.savez(OUT, logits=logits, input_seed=np.int64(INPUT_SEED),
             model_seed=np.int64(cfg.seed),
             source=np.str_("deepfusion_tpu ResFusionNet.__call__ "
                            "(Pallas interpret mode, CPU)"))
    print(f"wrote {OUT}")


if __name__ == "__main__":
    main()
