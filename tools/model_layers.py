"""Where an eager model forward's device time goes, by layer kind.

    python3 tools/model_layers.py [--model ResNet50|GoogLeNet|MobileNetV2] \
        [--batch 256] [--out model_layers.json]

Builds the model that ``--model`` names (a class of
``deepfusion_tpu_torch.models`` whose forward marks each layer with a
``model.layer`` span: ``ResNet50``, ``GoogLeNet``, ``MobileNetV2``) at its
default config
and ``--batch``, and runs eager forwards on cuda:0 under
``torch.profiler``; each kernel's device time is given to the
``model.layer`` span whose host range launched it (the launch's
correlation id), then summed per forward by the span's kind (ResNet-50:
stem, maxpool, reduce, proj, fused, avgpool, head; GoogLeNet: stem,
maxpool, reduce, conv, b1x1, b3x3_reduce, b3x3, b5x5_reduce, b5x5,
branch_pool, pool_proj, concat, avgpool, head; MobileNetV2: stem, expand,
depthwise, project, project_sum, last, avgpool, head), by layer and by
kernel name. Writes the split as one JSON object to ``--out``
and prints it; kernels no span launched are counted as unattributed.
(Kernel parity at the model's shapes is ``chip_smoke.py``'s; the graphed
forward's time is the benchmark cell's ``model.forward_ms``.)
"""
import argparse
import bisect
import json
import os
import sys
import tempfile
from collections import defaultdict
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import oncard  # noqa: E402
from deepfusion_tpu_torch import models  # noqa: E402
from deepfusion_tpu_torch.utils import profiler  # noqa: E402

# the models whose forward marks its layers with model.layer spans
SPANNED = ("ResNet50", "GoogLeNet", "MobileNetV2")


def build(name: str, batch: int, seed: int = 13, device="cuda:0"):
    """The model class `name` at its default config, `batch` and `seed`."""
    if name not in SPANNED:
        raise ValueError(f"{name!r} marks no model.layer spans; one of "
                         f"{SPANNED}")
    cfg = getattr(models, name + "Config")(batch=batch, seed=seed)
    return getattr(models, name)(cfg, device=device)


def split(net, x: torch.Tensor, forwards: int = 3) -> dict:
    """Per forward: device ms by layer kind, layer and kernel name, from
    the ``model.layer`` spans that launched each kernel."""
    with torch.inference_mode():
        net(x)
        torch.cuda.synchronize()
        profiler.clear_spans()
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(forwards):
                net(x)
            torch.cuda.synchronize()
    recs = sorted((r for r in profiler.spans() if r.name == "model.layer"),
                  key=lambda r: r.start_ns)
    profiler.clear_spans()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    spans = sorted((e for e in events if e.get("ph") == "X"
                    and e.get("name") == "model.layer"
                    and e.get("cat") != "gpu_user_annotation"),
                   key=lambda e: e["ts"])
    if len(spans) != len(recs):
        raise RuntimeError(f"{len(spans)} model.layer ranges in the trace, "
                           f"{len(recs)} records")
    starts = [s["ts"] for s in spans]
    launch_span = {}
    for e in events:
        corr = (e.get("args") or {}).get("correlation")
        if e.get("cat") != "cuda_runtime" or corr is None:
            continue
        i = bisect.bisect_right(starts, e["ts"]) - 1
        if i >= 0 and e["ts"] <= spans[i]["ts"] + spans[i]["dur"]:
            launch_span[corr] = i
    by_kind, by_kernel, by_layer = (defaultdict(float) for _ in range(3))
    unattributed = total = 0.0
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in ("kernel", "gpu_memcpy",
                                                      "gpu_memset"):
            continue
        d = e["dur"] / 1e3 / forwards     # ms per forward
        total += d
        i = launch_span.get((e.get("args") or {}).get("correlation"))
        if i is None:
            unattributed += d
            continue
        attrs = recs[i].attrs
        by_kind[attrs["kind"]] += d
        by_layer[attrs["name"]] += d
        by_kernel[f"{attrs['kind']}: {e['name'][:70]}"] += d
    return {"forwards": forwards, "device_ms_per_forward": total,
            "unattributed_ms": unattributed, "by_kind_ms": dict(by_kind),
            "by_kernel_ms": dict(by_kernel), "by_layer_ms": dict(by_layer)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", choices=SPANNED, default="ResNet50")
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--out", default="model_layers.json")
    args = ap.parse_args()
    net = build(args.model, args.batch)
    x = torch.from_numpy(net.example_input()).cuda()
    out = dict(card=oncard.card(), torch=torch.__version__, model=args.model,
               batch=args.batch, **split(net, x))
    print("split:", json.dumps({k: v for k, v in out.items()
                                if k not in ("by_kernel_ms", "by_layer_ms")}),
          flush=True)
    for k, v in sorted(out["by_kernel_ms"].items(), key=lambda kv: -kv[1]):
        print(f"kernel: {v:.4f} ms  {k}")
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
