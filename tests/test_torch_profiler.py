"""The port's offline profiler (``repro_torch.telemetry.profiler``) on the
CPU: the port of the three profiler tests in tests/test_telemetry.py, and
its registered models named as the reference's."""
import math

import pytest

from repro.telemetry import ProfileStore as JaxProfileStore
from repro.telemetry import profiler as jax_profiler
from repro_torch.core.actions import Request
from repro_torch.core.clock import EventLoop, RealClock
from repro_torch.core.controller import Controller
from repro_torch.core.scheduler import ClockworkScheduler
from repro_torch.core.worker import Worker
from repro_torch.serving.engine import (TorchBackend, make_resnet_model,
                                        seed_engines, update_store)
from repro_torch.telemetry import ProfileStore
from repro_torch.telemetry import profiler as profcli


def _mk():
    return make_resnet_model("rt", scale=8, img=32, batches=(1,),
                             device="cpu")


def test_offline_profile_store_enables_zero_warmup_serving(tmp_path):
    """build_store writes a store; a serving run seeded from it performs
    zero warmup re-measurements and still serves."""
    store_path = str(tmp_path / "profiles.json")
    store = profcli.build_store([("rt", _mk)], reps=1)
    assert {k for k, _ in store.items()} == {("INFER", "rt", 1),
                                             ("LOAD", "rt", 1)}
    store.save(store_path)

    store2 = ProfileStore.load(store_path)
    tm = _mk()
    assert tm.warmup_count == 0
    profiles = seed_engines({"rt": tm}, store2)
    models = {"rt": tm.modeldef()}
    tm.compile()            # untimed — distinct from re-measurement
    assert tm.warmup_count == 0, "modeldef() re-measured despite store"
    assert profiles[("INFER", "rt", 1)] == \
        pytest.approx(store2.get("INFER", "rt", 1).estimate)

    loop = EventLoop(RealClock())
    w = Worker("w0", loop, TorchBackend({"rt": tm}), models, n_gpus=1)
    c = Controller(loop, models, ClockworkScheduler(), action_delay=1e-4)
    c.add_worker(w, profiles)
    done = []
    c.on_response = done.append
    for _ in range(4):
        c.on_request(Request(model_id="rt", arrival=loop.now(), slo=10.0))
        loop.run_until(loop.now() + 0.05)
    loop.run_until(loop.now() + 3.0)
    ok = [r for r in done if r.status == "ok"]
    assert len(ok) >= 3, [r.status for r in done]
    assert tm.warmup_count == 0, "serving run re-measured the model"
    spans = [s for s in c.recorder.iter_spans() if s.status == "ok"]
    assert spans and all(not math.isnan(s.exec_end) for s in spans)


def test_update_store_never_recycles_seeded_estimates():
    """A store covering INFER but missing LOAD forces one load measurement;
    the INFER estimate it seeded must not be folded back as a sample."""
    store = ProfileStore()
    store.update("INFER", "rt", 1, [0.004])   # no ("LOAD", "rt", 1) entry
    tm = _mk()
    seed_engines({"rt": tm}, store)
    assert tm.warmup_count > 0                # it had to measure LOAD
    fresh = tm.fresh_profiles()
    assert ("LOAD", "rt", 1) in fresh
    assert ("INFER", "rt", 1) not in fresh    # seeded, not measured

    before = store.get("INFER", "rt", 1)
    update_store({"rt": tm}, store)
    after = store.get("INFER", "rt", 1)
    assert after.count == before.count == 1   # no echo folded back
    assert store.get("LOAD", "rt", 1) is not None


def test_profiler_cli_main_writes_store_the_reference_loads(tmp_path):
    out = str(tmp_path / "cli_profiles.json")
    rc = profcli.main(["--quick", "--reps", "1", "--batches", "1",
                       "--out", out, "--device", "cpu"])
    assert rc == 0
    store, ref = ProfileStore.load(out), JaxProfileStore.load(out)
    keys = {k for k, _ in store.items()}
    assert keys == {k for k, _ in ref.items()} == {
        ("INFER", "resnet_tiny", 1), ("LOAD", "resnet_tiny", 1)}
    for k in keys:
        assert ref.get(*k).estimate == store.get(*k).estimate > 0


@pytest.mark.parametrize("quick", [True, False])
def test_default_specs_name_the_references_models(quick):
    assert ([n for n, _ in profcli.default_specs(quick, device="cpu")]
            == [n for n, _ in jax_profiler.default_specs(quick)])
