"""The check's two readings: sound runs of the program, and its control.

    python3 portbench/control.py --workload <cell> --seconds <s> \\
        --program-seeds <n>... --control-seeds <n>...

The control is the plain reference put in the program's place, one
precision below the configuration's int8: every weight rounded to int4 and
its scales doubled (``weights.int4_control``). It runs through the same
loop, batcher and check as the program. Each seed prints one JSON line with
the numbers the check compared: the program's give the lower readings of
each limit, the control's the upper ones. Everything runs in one process,
so the set-up is paid once per seed and the library is loaded once. The
benchmark's own runs never run this.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


class ReferenceModel:
    """The plain reference of a configuration as a callable over a batch
    of u8 images on `device`, with the ``device`` and ``input_shape`` that
    ``BatchServer`` reads."""

    def __init__(self, ref, params: dict, device, input_shape):
        self.ref, self.params = ref, params
        self.device = device
        self.input_shape = tuple(input_shape)

    def __call__(self, x):
        import torch

        from portbench.reference import ops
        ops.strict_fp32()
        with torch.inference_mode():
            return self.ref.forward(
                self.params, torch.as_tensor(x, device=self.device))


def build_control(cfg: dict, mix: dict, params: dict, device):
    """``system.build``'s place: the int4 reference at the traffic's
    batch."""
    from portbench import spec, weights
    shape = (mix["batch"], cfg["hw"], cfg["hw"], cfg["in_ch"])
    return ReferenceModel(spec.reference(cfg),
                          weights.int4_control(params), device, shape)


def readings(bench, cell_name, seeds, seconds, device, control: bool,
             root=None):
    """One (seed, correct, checks) per seed."""
    from portbench import harness, spec, system
    out = []
    for seed in seeds:
        res, _ = harness.run_cell(
            bench, cell_name, seed, seconds, False, device,
            time.perf_counter(),
            build=build_control if control else system.build,
            root=root or spec.ROOT)
        out.append((seed, res["correct"], res["checks"]))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--program-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from portbench import spec
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    bench = spec.load(ROOT)
    for who, seeds in (("program", args.program_seeds),
                       ("control", args.control_seeds)):
        for seed, correct, checks in readings(
                bench, args.workload, seeds, args.seconds, "cuda:0",
                who == "control"):
            print(json.dumps({"who": who, "seed": seed, "correct": correct,
                              "checks": checks}), flush=True)
    print(f"control: {time.perf_counter() - T_START:.1f} s in all",
          file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
