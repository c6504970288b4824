"""Guards on the port's boundaries: ``repro_torch`` imports without JAX or
``ml_dtypes`` (neither is installed where the card is) and loads no module
of ``repro``; its copied control-plane modules stay equal to
their originals up to the package prefix (in imports, in ``python -m``
module paths and in quoted module names, so that no copy imports, spawns or
names a module of ``repro``); its configs equal the reference's. The
control-plane files that carry the port's in-program timing (``Phases``
on the ``Result``, the dispatch stamps and phases on the ``ActionRecord``)
differ from the reference's; ``test_torch_tracing.py`` holds their
decisions equal instead."""
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
    "core/clock.py", "core/pagecache.py", "core/scheduler.py",
    "telemetry/reports.py", "telemetry/profile_store.py",
    "core/baselines.py", "core/scheduler_reference.py",
    "serving/workload.py", "serving/simulator.py",
    "runtime/__init__.py", "runtime/transport.py",
    "runtime/client.py", "runtime/controller.py", "runtime/worker.py",
    "runtime/harness.py", "runtime/loadgen.py",
    "data/pipeline.py",
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


def _import_with_jax_blocked(modules):
    """Import ``modules`` in a fresh interpreter where ``import jax`` and
    ``import ml_dtypes`` fail; assert it succeeds and loaded no module of
    ``repro``."""
    code = (
        "import importlib, json, sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['ml_dtypes'] = None\n"
        f"for m in {list(modules)!r}:\n"
        "    importlib.import_module(m)\n"
        "print(json.dumps(sorted(m for m in sys.modules\n"
        "                 if m == 'repro' or m.startswith('repro.'))))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=ROOT,
                         env={**os.environ, "PYTHONPATH": str(SRC)})
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "[]"


def test_port_imports_without_jax_or_repro():
    _import_with_jax_blocked(_port_modules())


# the slices' modules, each imported on its own
SLICE_MODULES = [
    "repro_torch.kernels.flash_attention", "repro_torch.kernels.ssd_scan",
    "repro_torch.kernels.ops", "repro_torch.models.ssm",
    "repro_torch.models.lm", "repro_torch.distributed.steps",
    "repro_torch.models.resnet", "repro_torch.telemetry.profiler",
    "repro_torch.runtime.harness", "repro_torch.models.rglru",
    "repro_torch.models.moe", "repro_torch.models.encdec",
    "repro_torch.data.pipeline", "repro_torch.training.compression",
    "repro_torch.training.optimizer", "repro_torch.checkpoint.checkpoint",
    "repro_torch.launch.train", "repro_torch.configs.shapes",
    "repro_torch.distributed.sharding", "repro_torch.launch.mesh",
    "repro_torch.launch.dryrun", "repro_torch.models.flash_xla",
    "repro_torch.distributed.vocab",
]


@pytest.mark.parametrize("module", SLICE_MODULES)
def test_slice_module_imports_alone_without_jax_or_repro(module):
    assert module in set(_port_modules())
    _import_with_jax_blocked([module])


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(ROOT)) for p in (SRC / "repro_torch").rglob("*.py"))
    + ["chip_smoke.py", "examples/train_lm_torch.py",
       "examples/quickstart_torch.py"])
def test_no_jax_or_repro_import_in_source(path):
    text = (ROOT / path).read_text()
    bad = re.findall(r"^\s*(?:import|from) (?:jax|repro|ml_dtypes)\b.*$",
                     text, flags=re.M)
    assert not bad, bad


@pytest.mark.parametrize("rel", COPIED)
def test_copied_control_plane_matches_original(rel):
    original = (SRC / "repro" / rel).read_text()
    copy = (SRC / "repro_torch" / rel).read_text()
    assert copy == re.sub(r'(from |-m\s+|")repro\.', r"\1repro_torch.",
                          original)


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_equal_reference(arch):
    ref = importlib.import_module("repro.configs")
    port = importlib.import_module("repro_torch.configs")
    assert set(ref._MODULES) == set(port._MODULES) == set(ARCHS)
    assert (dataclasses.asdict(port.get_config(arch))
            == dataclasses.asdict(ref.get_config(arch)))
    assert (dataclasses.asdict(port.get_smoke_config(arch))
            == dataclasses.asdict(ref.get_smoke_config(arch)))
