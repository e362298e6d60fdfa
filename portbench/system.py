"""The system under test: the port's models, built as a cell asks.

The only place the harness reaches into the program (besides
``serving.BatchServer``, which the served loops drive): the model class
that the configuration names, built from the benchmark's own weights with
``from_numpy_params`` at the traffic's batch, and its compiled callable
that the traffic's ``entry`` names (``jit`` or ``jit_packed``); and the
kernel launch counters.
"""
from __future__ import annotations

import dataclasses


def build(cfg: dict, mix: dict, params: dict, device):
    from deepfusion_tpu_torch import models
    cls = getattr(models, cfg["model"])
    cfg_cls = getattr(models, cfg["model"] + "Config")
    names = {f.name for f in dataclasses.fields(cfg_cls)} - {"batch"}
    net_cfg = cfg_cls(batch=mix["batch"],
                      **{k: v for k, v in cfg.items() if k in names})
    net = cls.from_numpy_params(net_cfg, params, device=device)
    return getattr(net, mix["entry"])()


def launch_counts() -> dict:
    """The program's kernel launches so far, by kernel."""
    from deepfusion_tpu_torch import _build
    return _build.launch_counts()


def batch_server(entry, mix: dict, image_shape):
    """A started ``BatchServer`` over `entry` at the traffic's batch (and
    its ``max_delay_ms`` where the mix names one)."""
    from deepfusion_tpu_torch.serving import BatchServer
    kw = {"max_delay_ms": mix["max_delay_ms"]} if "max_delay_ms" in mix \
        else {}
    return BatchServer(entry, batch=mix["batch"], input_shape=image_shape,
                       **kw).start()
