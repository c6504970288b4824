"""Guards on the port's boundaries: ``repro_torch`` imports without JAX and
loads no module of ``repro``; its copied control-plane modules stay equal to
their originals up to the package prefix; its configs equal the reference's."""
import dataclasses
import importlib
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"

COPIED = [
    "core/actions.py", "core/clock.py", "core/pagecache.py",
    "core/predictor.py", "core/scheduler.py", "core/worker.py",
    "core/controller.py", "telemetry/events.py", "telemetry/recorder.py",
    "telemetry/reports.py", "telemetry/profile_store.py",
]
ARCHS = ["seamless-m4t-medium", "llava-next-mistral-7b", "mamba2-130m",
         "gemma2-27b", "starcoder2-3b", "phi4-mini-3.8b", "qwen2-0.5b",
         "qwen3-moe-235b-a22b", "llama4-maverick-400b-a17b",
         "recurrentgemma-2b"]


def _port_modules():
    pkg = SRC / "repro_torch"
    for path in sorted(pkg.rglob("*.py")):
        parts = path.relative_to(SRC).with_suffix("").parts
        if parts[-1] == "__init__":
            parts = parts[:-1]
        yield ".".join(parts)


def test_port_imports_without_jax_or_repro():
    code = (
        "import importlib, json, sys\n"
        "sys.modules['jax'] = None\n"
        f"for m in {list(_port_modules())!r}:\n"
        "    importlib.import_module(m)\n"
        "print(json.dumps(sorted(m for m in sys.modules\n"
        "                 if m == 'repro' or m.startswith('repro.'))))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=ROOT,
                         env={**os.environ, "PYTHONPATH": str(SRC)})
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "[]"


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(ROOT)) for p in (SRC / "repro_torch").rglob("*.py"))
    + ["chip_smoke.py"])
def test_no_jax_or_repro_import_in_source(path):
    text = (ROOT / path).read_text()
    bad = re.findall(r"^\s*(?:import|from) (?:jax|repro)\b.*$", text,
                     flags=re.M)
    assert not bad, bad


@pytest.mark.parametrize("rel", COPIED)
def test_copied_control_plane_matches_original(rel):
    original = (SRC / "repro" / rel).read_text()
    copy = (SRC / "repro_torch" / rel).read_text()
    assert copy == original.replace("from repro.", "from repro_torch.")


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_equal_reference(arch):
    ref = importlib.import_module("repro.configs")
    port = importlib.import_module("repro_torch.configs")
    assert set(ref._MODULES) == set(port._MODULES) == set(ARCHS)
    assert (dataclasses.asdict(port.get_config(arch))
            == dataclasses.asdict(ref.get_config(arch)))
    assert (dataclasses.asdict(port.get_smoke_config(arch))
            == dataclasses.asdict(ref.get_smoke_config(arch)))
