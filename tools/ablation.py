"""The driver of the kernel ablation tools (tools/k1_ablation.py,
tools/k5_ablation.py): copies of this checkout's deepfusion_tpu_torch with
one part of a kernel taken out, built at once, then timed in turns on one
card. A tool gives its variants (source edits) and ``run_tree``, which
times the kernel of the package at a tree's root and prints one JSON line
``{"tree": ..., "device_ms": {entry: ms}}``.

    python3 tools/<tool>.py [--dir DIR]

Each variant's tree is DIR/<variant> (by default under chip_checkout/,
which .gitignore lists). The checkout and every variant run in their own
process, in turns: the checkout, the variants, the variants in reverse, the
checkout. A variant computes wrong values: only its time means anything.
An edit whose text is no longer in the source stops the script, so the
variants follow the kernel or fail loudly.
"""
import json
import os
import shutil
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def make_tree(base, name, edits):
    """DIR/name: a copy of the package with the edits (file under csrc/,
    old text, new text) applied."""
    tree = os.path.join(base, name)
    pkg = os.path.join(tree, "deepfusion_tpu_torch")
    shutil.rmtree(tree, ignore_errors=True)
    shutil.copytree(os.path.join(ROOT, "deepfusion_tpu_torch"), pkg,
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    for fname, old, new in edits:
        path = os.path.join(pkg, "csrc", fname)
        with open(path) as f:
            src = f.read()
        if old not in src:
            sys.exit(f"{name}: the edit's text is not in {fname}: {old!r}")
        with open(path, "w") as f:
            f.write(src.replace(old, new))
    return tree


def build_all(trees):
    """Build every tree's kernels at once, each in its own process."""
    code = "from deepfusion_tpu_torch import _build; _build.kernels()"
    procs = [subprocess.Popen([sys.executable, "-c", code], cwd=t)
             for t in trees]
    for p in procs:
        if p.wait():
            sys.exit(f"a build failed (exit {p.returncode})")


def main(tool, variants, run_tree, default_dir):
    """The command line of a tool (its file ``tool``): ``--run TREE`` times
    one tree in this process; else the variants' trees under ``--dir DIR``
    or ``default_dir`` are made, built and timed in turns, and each entry's
    median per tree is printed beside its ratio to the checkout's."""
    if len(sys.argv) == 3 and sys.argv[1] == "--run":
        run_tree(sys.argv[2])
        return
    sys.path.insert(0, ROOT)
    import chip_smoke as cs  # this checkout's; imports no package

    base = sys.argv[2] if len(sys.argv) == 3 and sys.argv[1] == "--dir" \
        else default_dir
    trees = {"kernel": ROOT}
    trees.update({name: make_tree(base, name, edits)
                  for name, edits in variants.items()})
    build_all(trees.values())
    order = list(trees) + list(trees)[::-1]
    runs = {}
    for name in order:
        out = subprocess.run([sys.executable, tool, "--run", trees[name]],
                             capture_output=True, text=True, check=True)
        line = out.stdout.strip().splitlines()[-1]
        print(line, flush=True)
        runs.setdefault(name, []).append(json.loads(line)["device_ms"])
    print(f"card: {cs.card()}")
    for entry in runs["kernel"][0]:
        meds = {n: statistics.median(r[entry] for r in rs)
                for n, rs in runs.items()}
        print(f"{entry}: " + " ".join(
            f"{n}={m:.5f}({m / meds['kernel']:.3f})" for n, m in meds.items()))
