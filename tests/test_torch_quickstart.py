"""examples/quickstart_torch.py at smoke size on the CPU: the reduced
ResNet-50 and qwen2 decode engine served through the copied Clockwork
controller and worker over a TorchBackend, twice, the second run seeded from
the ProfileStore the first one wrote (no warmup re-measurement).

The example serves on the host's real clock against a 2 s SLO, so the test
runs it on one torch thread: beside other test processes, torch's default
of one thread per core oversubscribes the cores and can stretch the reduced
ResNet's INFER past the SLO."""
import importlib.util
import os

import pytest
import torch

from repro_torch.telemetry import ProfileStore

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _quickstart():
    spec = importlib.util.spec_from_file_location(
        "quickstart_torch", os.path.join(ROOT, "examples",
                                         "quickstart_torch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_quickstart_serves_and_persists_profiles(tmp_path, capsys,
                                                 one_thread):
    qs = _quickstart()
    store = str(tmp_path / "profiles.json")
    ok, done = qs.main(["--device", "cpu", "--store", store])
    assert done == 30 and ok >= 27
    first = capsys.readouterr().out
    assert "on cpu (no card" in first and "seeding profiles" not in first
    saved = ProfileStore.load_if_exists(store)
    assert saved is not None
    ok, done = qs.main(["--device", "cpu", "--store", store])
    assert done == 30 and ok >= 27
    assert "seeding profiles from" in capsys.readouterr().out
