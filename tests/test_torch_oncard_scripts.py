"""The on-card scripts import on the CPU, and their imports point one way.

``chip_smoke.py`` and every ``tools/*.py`` run only on the card, so a broken
import there would otherwise show only on a chip run. Each imports here
with ``tools/`` on ``sys.path``, as its own command line has it; no card is
needed, since nothing of these modules touches the device at import time.
The imports point one way: chip_smoke.py and the tools import
``tools/oncard.py`` (chip_smoke.py nothing else of ``tools/``), oncard
imports none of them, no tool imports chip_smoke.py, and none imports JAX
or the JAX package.
"""
import ast
import importlib.util
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
TOOLS = ROOT / "tools"
SCRIPTS = [ROOT / "chip_smoke.py"] + sorted(TOOLS.glob("*.py"))
TOOL_NAMES = {p.stem for p in TOOLS.glob("*.py")}


def imported(path: Path) -> set:
    """The top-level module names a file imports, at any depth."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", SCRIPTS, ids=lambda p: p.name)
def test_script_imports_on_the_cpu(path, monkeypatch):
    monkeypatch.setattr(sys, "path", [str(TOOLS), str(ROOT)] + sys.path)
    before = set(sys.modules)
    try:
        spec = importlib.util.spec_from_file_location(
            f"_oncard_script_{path.stem}", path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
    finally:
        for name in set(sys.modules) - before:
            if name in TOOL_NAMES or name == "chip_smoke":
                del sys.modules[name]
    if path.parent == TOOLS and path.stem != "oncard":
        assert hasattr(module, "run_tree") or hasattr(module, "main")


@pytest.mark.parametrize("path", SCRIPTS, ids=lambda p: p.name)
def test_script_imports_point_one_way(path):
    names = imported(path)
    assert not names & {"jax", "jaxlib", "deepfusion_tpu"}, names
    assert "chip_smoke" not in names
    if path.name == "chip_smoke.py":
        assert names & TOOL_NAMES == {"oncard"}
    elif path.stem == "oncard":
        assert not names & TOOL_NAMES
    else:
        assert names & TOOL_NAMES == {"oncard"}


def test_the_layer_split_takes_each_spanned_model_by_name(monkeypatch):
    """``tools/model_layers.py`` builds the model its ``--model`` names, at
    the default config and the given batch, for each model whose forward
    marks its layers with ``model.layer`` spans, and refuses any other."""
    monkeypatch.setattr(sys, "path", [str(TOOLS), str(ROOT)] + sys.path)
    spec = importlib.util.spec_from_file_location(
        "_oncard_script_model_layers", TOOLS / "model_layers.py")
    tool = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(tool)
    finally:
        sys.modules.pop("oncard", None)
    assert tool.SPANNED == ("ResNet50", "GoogLeNet", "MobileNetV2")
    for name in tool.SPANNED:
        net = tool.build(name, batch=2, device="cpu")
        assert type(net).__name__ == name
        assert net.input_shape == (2, 224, 224, 3) and net.cfg.seed == 13
    with pytest.raises(ValueError, match="no model.layer spans"):
        tool.build("VGGFusion", batch=2, device="cpu")


def _variants():
    """(tool, variant, its edits) of every ablation under tools/."""
    out = []
    for tool in ("k1_ablation", "k5_ablation"):
        spec = importlib.util.spec_from_file_location(
            f"_variants_{tool}", TOOLS / f"{tool}.py")
        module = importlib.util.module_from_spec(spec)
        sys.path.insert(0, str(TOOLS))
        try:
            spec.loader.exec_module(module)
        finally:
            sys.path.remove(str(TOOLS))
        out += [(tool, v, e) for v, e in module.VARIANTS.items()]
    return out


@pytest.mark.parametrize("tool, variant, edits", _variants(),
                         ids=lambda a: a if isinstance(a, str) else "")
def test_every_ablation_edit_applies_to_the_sources(tool, variant, edits):
    """An ablation variant is the kernel with one part taken out by text
    edits (``oncard.make_tree``), which stop the script on the card where
    their text is gone: each edit's text is in its csrc/ file."""
    csrc = ROOT / "deepfusion_tpu_torch" / "csrc"
    for fname, old, new in edits:
        assert old in (csrc / fname).read_text(), (fname, old)
