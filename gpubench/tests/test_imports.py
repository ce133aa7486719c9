"""Nothing the benchmark runs imports JAX or the JAX package, compared by
whole top-level names (phylign_tpu_torch is not phylign_tpu); the plain
reference imports nothing of the program either."""

import ast
import subprocess
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "phylign_tpu"}


def _imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(node.func, "id", "")) in (
            "import_module", "__import__"
        ) and node.args and isinstance(node.args[0], ast.Constant) and isinstance(node.args[0].value, str):
            names.add(node.args[0].value.split(".")[0])
    return names


def _sources():
    return [p for p in BENCH.rglob("*.py") if "tests" not in p.parts]


def test_static_scan():
    assert _sources()
    for p in _sources():
        assert not _imports(p) & FORBIDDEN, p
    for p in (BENCH / "reference").rglob("*.py"):
        assert "phylign_tpu_torch" not in _imports(p), p


def test_names_compared_whole():
    assert "phylign_tpu_torch".split(".")[0] not in FORBIDDEN
    assert "phylign_tpu.ops".split(".")[0] in FORBIDDEN


def test_fresh_interpreter():
    metrics = sorted(str(p) for p in (BENCH / "metrics").glob("*.py"))
    code = (
        "import sys, runpy, importlib.util\n"
        f"sys.path.insert(0, {str(BENCH.parent)!r})\n"
        "import gpubench.run, gpubench.check, gpubench.fixtures, gpubench.trace, gpubench.bounds\n"
        "import gpubench.reference.cobs_ref, gpubench.reference.align_ref\n"
        "import phylign_tpu_torch.pipeline.stages, phylign_tpu_torch.align.engine\n"
        f"for p in {metrics!r}:\n"
        "    s = importlib.util.spec_from_file_location('m', p); importlib.util.module_from_spec(s)\n"
        "    s.loader.exec_module(importlib.util.module_from_spec(s))\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True).stdout
    loaded = set(eval(out.strip().splitlines()[-1]))
    assert not loaded & FORBIDDEN
    assert "phylign_tpu_torch" in loaded


def test_reference_alone():
    code = (
        "import sys\n"
        f"sys.path.insert(0, {str(BENCH.parent)!r})\n"
        "import gpubench.reference.cobs_ref, gpubench.reference.align_ref\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True).stdout
    assert "phylign_tpu_torch" not in set(eval(out.strip().splitlines()[-1]))
