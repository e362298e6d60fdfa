"""The port's benchmark: one run of one cell.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Runs the cell that ``BENCHMARK.json`` names on the first CUDA device: set-up
(weights and inputs from the seed, the program's kernels and compiled
callable, warm-up), a measured window of ``--seconds``, and with
``--trace 1`` a traced stretch after it; then the check against the plain
reference. Prints the cell's end-to-end metrics (``--trace 0``) or
per-layer metrics (``--trace 1``) as one JSON object on the last line of
standard output, and each number the check compared beside its limit as
the last lines of standard error. Exits non-zero, printing no result,
without enough CUDA devices, where the program is not in this checkout, or
where JAX or the JAX package was loaded.
"""
import time

T_START = time.perf_counter()   # set-up is timed from here

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "deepfusion_tpu")


def loaded_forbidden() -> list:
    """Forbidden modules in ``sys.modules``, by whole top-level name."""
    return sorted({m.partition(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    sys.path.insert(0, str(ROOT))
    from portbench import harness, spec
    bench = spec.load(ROOT)
    cell = spec.cell(bench, args.workload)

    import torch
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < cell["chips"]:
        print(f"portbench: {args.workload} needs {cell['chips']} CUDA "
              f"device(s), found {have}", file=sys.stderr)
        return 2
    import deepfusion_tpu_torch
    if ROOT not in Path(deepfusion_tpu_torch.__file__).resolve().parents:
        print(f"portbench: the program was imported from "
              f"{deepfusion_tpu_torch.__file__}, not this checkout",
              file=sys.stderr)
        return 2

    out, run = harness.run_cell(bench, args.workload, args.seed,
                                args.seconds, bool(args.trace), "cuda:0",
                                T_START)
    bad = loaded_forbidden()
    if bad:
        print(f"portbench: loaded {bad}", file=sys.stderr)
        return 3
    if run.calls:
        per = {k: v / run.calls for k, v in run.launches.items()}
        print(f"launches per forward over {run.calls} forwards:",
              json.dumps(per))
    print("set-up, seconds from the start to the end of each phase:",
          json.dumps(run.setup_phases))
    print("garbage collections over the run:", json.dumps(run.gc))
    for k, v in out["checks"].items():
        print(f"check {k}: {v['value']} (limit {v['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
