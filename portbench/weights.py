"""A configuration's weights and inputs, drawn from the run's seed.

The calibration is the models' ``_mkconv``
(``deepfusion_tpu_torch/models/fusionnet.py``), copied: int8 weights
uniform in [-16, 16], an int32 bias within about 5% of the accumulator's
spread, and per-channel f32 scales ``U(0.8, 1.2) * 48 / std(acc)``, so u8
activations stay alive through deep stacks. All layers are drawn together
from one ``torch.Generator`` on the run's device, in three calls, and
handed over as numpy arrays: the same arrays go to the program
(``from_numpy_params``) and to the reference.
"""
from __future__ import annotations

import math

import numpy as np
import torch

WEI_STD = 16.0 / math.sqrt(3.0)   # std of U{-16..16}
MID_STD = 30.0                    # u8 activations' spread inside the net


def generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed))


def _bias(u: np.ndarray, acc_std: float) -> np.ndarray:
    lo = -int(acc_std * 0.05) - 1
    hi = int(acc_std * 0.05) + 2          # exclusive, as rng.integers
    return (lo + np.floor(u * (hi - lo))).astype(np.int32)


def _scales(u: np.ndarray, acc_std: float) -> np.ndarray:
    return ((np.float32(0.8) + np.float32(0.4) * u).astype(np.float32)
            * np.float32(48.0 / acc_std))


def draw(layers: list, gen: torch.Generator, device) -> dict:
    """{layer name: parameters} in the layout ``from_numpy_params`` takes
    (``wei``, ``bia``, ``conv0_scales``, ``conv0_relu``, ``dst_dt`` and
    for a fused layer ``wei1``, ``bia1``, ``conv1_scales``,
    ``conv1_relu``)."""
    n_wei = sum(l["oc"] * l["ic"] * l["k"] ** 2 + (l["oc1x1"] or 0) * l["oc"]
                for l in layers)
    n_ch = sum(l["oc"] + (l["oc1x1"] or 0) for l in layers)
    wei = torch.randint(-16, 17, (n_wei,), generator=gen, device=device,
                        dtype=torch.int8).cpu().numpy()
    ub = torch.rand(n_ch, generator=gen, device=device,
                    dtype=torch.float64).cpu().numpy()
    us = torch.rand(n_ch, generator=gen, device=device,
                    dtype=torch.float32).cpu().numpy()
    params, w0, c0 = {}, 0, 0
    for l in layers:
        k, ic, oc, oc1 = l["k"], l["ic"], l["oc"], l["oc1x1"]
        n = oc * ic * k * k
        acc_std = math.sqrt(k * k * ic) * l["in_std"] * WEI_STD
        p = dict(wei=wei[w0:w0 + n].reshape(oc, ic, k, k),
                 bia=_bias(ub[c0:c0 + oc], acc_std),
                 conv0_scales=_scales(us[c0:c0 + oc], acc_std),
                 conv0_relu=bool(l["relu"]), dst_dt=l["dst"])
        w0, c0 = w0 + n, c0 + oc
        if oc1:
            acc1_std = math.sqrt(oc) * MID_STD * WEI_STD
            p.update(wei1=wei[w0:w0 + oc1 * oc].reshape(oc1, oc, 1, 1),
                     bia1=_bias(ub[c0:c0 + oc1], acc1_std),
                     conv1_scales=_scales(us[c0:c0 + oc1], acc1_std),
                     conv0_relu=True, conv1_relu=bool(l["relu"]))
            w0, c0 = w0 + oc1 * oc, c0 + oc1
        params[l["name"]] = p
    return params


def images(gen: torch.Generator, shape, device) -> torch.Tensor:
    """u8 NHWC images uniform over 0..255 (spread about 74, the stem's
    calibration), made on the device."""
    return torch.randint(0, 256, tuple(shape), generator=gen, device=device,
                         dtype=torch.uint8)


def int4_control(params: dict) -> dict:
    """The same layers one precision lower: every weight rounded to int4
    (``round(w / 2)`` clipped to [-8, 7]) and its scales doubled, so the
    outputs keep their size."""
    out = {}
    for name, p in params.items():
        q = dict(p)
        for w, s in (("wei", "conv0_scales"), ("wei1", "conv1_scales")):
            if p.get(w) is None:
                continue
            q[w] = np.clip(np.rint(p[w] / 2.0), -8, 7).astype(np.int8)
            q[s] = (p[s] * np.float32(2.0)).astype(np.float32)
        out[name] = q
    return out
