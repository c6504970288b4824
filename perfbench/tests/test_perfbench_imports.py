"""The benchmark's boundaries: no module under ``perfbench/`` imports JAX
or the JAX package (``repro``; top-level names compared whole, so the port
``repro_torch`` is not caught by ``repro``), the references import nothing
of the port either, and nothing reads the JAX package's benchmark folder."""
import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
JAX_BENCH_DIR = "bench" + "marks"          # the JAX package's folder


def _sources():
    return sorted(BENCH.rglob("*.py"))


def _top_level_imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call):       # importlib.import_module("x")
            f = node.func
            if (getattr(f, "attr", getattr(f, "id", None))
                    in ("import_module", "__import__") and node.args
                    and isinstance(node.args[0], ast.Constant)):
                yield str(node.args[0].value).split(".")[0]


def test_the_names_are_compared_whole():
    assert "repro_torch".split(".")[0] not in FORBIDDEN
    assert "repro.models".split(".")[0] in FORBIDDEN


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_no_module_imports_jax_or_the_jax_package(path):
    bad = set(_top_level_imports(path)) & FORBIDDEN
    assert not bad, f"{path} imports {bad}"


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_the_references_import_nothing_of_the_port(path):
    names = set(_top_level_imports(path))
    assert "repro_torch" not in names
    assert names <= {"__future__", "math", "torch", "perfbench"}, names
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.ImportFrom) and node.module.startswith(
                "perfbench"):
            assert node.module.startswith("perfbench.reference"), node.module


def test_nothing_reads_the_jax_packages_benchmarks():
    for path in BENCH.rglob("*"):
        if path.is_file() and path.suffix in (".py", ".json", ".sh", ".txt") \
                and path != Path(__file__).resolve():
            text = path.read_text()
            assert f"{JAX_BENCH_DIR}/" not in text, path
            assert f"{JAX_BENCH_DIR}." not in text, path


def test_a_run_loads_no_jax_module():
    code = ("import sys, json\n"
            f"sys.path[:0] = [{str(ROOT / 'src')!r}, {str(ROOT)!r}]\n"
            "import perfbench.harness.cell, perfbench.harness.manifest\n"
            "from perfbench.harness.manifest import load\n"
            f"c = load({str(ROOT)!r}, 'qwen2-0.5b.decode')\n"
            "c.adapter()\n"
            f"c2 = load({str(ROOT)!r}, 'resnet50.poisson')\n"
            "c2.adapter()\n"
            "for m in c.per_layer + c2.per_layer + c.end_to_end:\n"
            "    c.reader(m)\n"
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not loaded & FORBIDDEN
    assert "repro_torch" in loaded
