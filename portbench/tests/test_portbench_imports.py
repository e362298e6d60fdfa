"""Nothing the benchmark runs imports JAX or the JAX package, and its
reference imports nothing of the program: every module under portbench/,
read with ``ast``, by whole top-level name (the port's name begins with the
JAX package's)."""
import ast
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "deepfusion_tpu"}
MODULES = sorted(p for p in HERE.rglob("*.py") if "__pycache__" not in p.parts)


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.partition(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.partition(".")[0])
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", None) == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            names.add(node.args[0].value.partition(".")[0])
    return names


def test_the_walk_sees_every_module():
    names = {p.relative_to(HERE).as_posix() for p in MODULES}
    assert {"run.py", "harness.py", "reference/ops.py",
            "traffic/poisson.py", "metrics/model.mfu.py"} <= names


@pytest.mark.parametrize("path", MODULES,
                         ids=lambda p: p.relative_to(HERE).as_posix())
def test_no_jax(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((HERE / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert "deepfusion_tpu_torch" not in top_level_imports(path)
    text = path.read_text()
    assert "deepfusion_tpu" not in text.replace(
        "deepfusion_tpu/models/", "")


def test_the_walk_catches_a_jax_import(tmp_path):
    p = tmp_path / "m.py"
    p.write_text("import deepfusion_tpu.ops as o\nfrom jax import numpy\n")
    assert top_level_imports(p) == {"deepfusion_tpu", "jax"}
    p.write_text("import deepfusion_tpu_torch\n")
    assert not top_level_imports(p) & FORBIDDEN


def test_a_run_loads_no_jax(tmp_path):
    """A whole run (on the CPU, cut down) leaves neither JAX nor the JAX
    package in ``sys.modules``: what the port loads counts too."""
    code = f"""
import sys
sys.path[:0] = [{str(HERE.parent)!r}, {str(HERE / 'tests')!r}]
from pathlib import Path
from conftest import tiny_copy
from portbench import harness, spec
sys.path.insert(0, {str(HERE)!r})
from run import loaded_forbidden
root = tiny_copy(Path({str(tmp_path)!r}))
out, _ = harness.run_cell(spec.load(root), "vggfusion-dense-served-closed64",
                          9, 0.3, False, "cpu", 0.0, root=root)
assert out["correct"]
print("FORBIDDEN", loaded_forbidden(), "deepfusion_tpu_torch" in sys.modules)
"""
    import subprocess
    import sys
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-2000:]
    assert "FORBIDDEN [] True" in p.stdout
