"""The knee of an open-loop cell: the highest offered rate it sustains.

    python3 portbench/knee.py --workload <cell> --seed <n> --seconds <s> \\
        --rates <r1> <r2> ...

Builds the cell once and offers its Poisson traffic at each rate in turn
for ``--seconds``, printing one JSON line per rate: the requests answered
within the window per second, the latency median and 95th percentile, the
median of the window's first and last thirds (a backlog that grows shows
as a last third far above the first), and how late the sender ran. The
knee is the highest rate whose last third stays near its first; a served
cell's ``rate_per_s`` is set once, by hand, from such a sweep, and the
benchmark's own runs never search.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def sweep(bench, cell_name, seed, seconds, rates, device, root=None):
    """One dict per rate (see the module's doc)."""
    import numpy as np
    import torch

    from portbench import harness, spec
    from portbench.stats import percentile
    made = harness.prepare(bench, cell_name, seed, device,
                           root=root or spec.ROOT)
    loop = made.loop
    loop.warm()
    out = []
    try:
        for rate in rates:
            loop.mix = dict(made.mix, rate_per_s=rate)
            run = harness.Run(cell=cell_name, batch=made.mix["batch"],
                              layers=made.layers, seconds=seconds)
            loop.run(run, seconds, False)
            lat = run.latencies_s
            first, _, last = np.array_split(lat, 3)
            out.append(dict(
                rate=rate, requests=len(lat),
                answered_in_window_per_s=None if run.completed is None
                else run.completed / seconds,
                p50_ms=1e3 * percentile(lat, 50),
                p95_ms=1e3 * percentile(lat, 95),
                first_third_p50_ms=1e3 * percentile(first, 50),
                last_third_p50_ms=1e3 * percentile(last, 50),
                late_p95_ms=1e3 * percentile(run.late_s, 95),
                flushes=run.server_delta["flushes"],
                padded_rows=run.server_delta["padded_rows"]))
            loop.answered.clear()
            if torch.device(device).type == "cuda":
                torch.cuda.synchronize()
    finally:
        loop.close()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from portbench import spec
    if not torch.cuda.is_available():
        print("knee: no CUDA device", file=sys.stderr)
        return 2
    bench = spec.load(ROOT)
    for row in sweep(bench, args.workload, args.seed, args.seconds,
                     args.rates, "cuda:0"):
        print(json.dumps(row), flush=True)
    print(f"knee: {time.perf_counter() - T_START:.1f} s in all",
          file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
