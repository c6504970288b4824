"""The port's serving engine: a real (non-simulated) round-trip through the
copied Clockwork controller and worker with a TorchBackend on the CPU (the
port of tests/test_system.py::test_real_jax_serving_roundtrip), the
ProfileStore format shared with ``repro``, and no silent fallback to the CPU
when a card is asked for."""
import pytest
import torch

from repro.telemetry import ProfileStore as JaxProfileStore
from repro_torch.core.actions import Request
from repro_torch.core.clock import EventLoop, RealClock
from repro_torch.core.controller import Controller
from repro_torch.core.scheduler import ClockworkScheduler
from repro_torch.core.worker import Worker
from repro_torch.serving.engine import (TorchBackend, make_lm_decode_model,
                                        seed_engines, update_store)
from repro_torch.telemetry import ProfileStore


def test_torch_serving_roundtrip():
    """Controller + worker + real qwen2-0.5b (smoke) decode steps on the CPU:
    requests go in, on-time responses come out, measured latencies feed the
    profiler."""
    loop = EventLoop(RealClock())
    tm = make_lm_decode_model("qwen2_decode", batches=(1, 2, 4), device="cpu")
    models = {"qwen2_decode": tm.modeldef()}
    backend = TorchBackend({"qwen2_decode": tm})
    w = Worker("w0", loop, backend, models, n_gpus=1)
    controller = Controller(loop, models, ClockworkScheduler(),
                            action_delay=1e-4)
    controller.add_worker(w, profiles=tm.seed_profiles())
    done = []
    controller.on_response = done.append
    for _ in range(12):
        controller.on_request(Request(model_id="qwen2_decode",
                                      arrival=loop.now(), slo=5.0))
        loop.run_until(loop.now() + 0.02)
    loop.run_until(loop.now() + 3.0)
    ok = [r for r in done if r.status == "ok"]
    assert len(ok) >= 10, [r.status for r in done]
    est = controller.profiler.estimate("INFER", "qwen2_decode", 1)
    assert est is not None and est > 0


def test_decode_model_answers_logits():
    tm = make_lm_decode_model("q", batches=(1, 2), device="cpu")
    tm.load()
    with torch.inference_mode():
        logits = tm.forward(tm.device_params, tm.make_input(2))
    cfg_vocab = 503                       # qwen2-0.5b smoke vocab
    assert logits.shape == (2, 1, 512) and logits.dtype == torch.float32
    assert torch.isfinite(logits[..., :cfg_vocab]).all()
    assert (logits[..., cfg_vocab:] == torch.finfo(torch.float32).min).all()
    assert tm.weights_bytes == sum(
        t.nelement() * t.element_size()
        for t in torch.utils._pytree.tree_leaves(tm.host_params))


def test_decode_model_serves_recurrentgemma():
    """The factory builds any decoder-only arch: recurrentgemma-2b (smoke)
    with its RG-LRU state and ring-window cache, one INFER per bucket."""
    tm = make_lm_decode_model("rg", arch="recurrentgemma-2b", batches=(1, 2),
                              ctx=32, device="cpu")
    tm.load()
    for b in tm.batches:
        with torch.inference_mode():
            logits = tm.forward(tm.device_params, tm.make_input(b))
        assert logits.shape == (b, 1, 512) and torch.isfinite(
            logits[..., :503]).all()
        assert tm.run(b) > 0


def test_profile_store_written_by_port_loads_in_reference(tmp_path):
    tm = make_lm_decode_model("qwen2_decode", batches=(1, 2), device="cpu")
    store = ProfileStore()
    seed_engines({"qwen2_decode": tm})
    update_store({"qwen2_decode": tm}, store)
    path = store.save(str(tmp_path / "profiles.json"))
    ref = JaxProfileStore.load(path)
    assert len(ref) == len(store) == 3           # INFER x2 buckets + LOAD
    for b in (1, 2):
        assert ref.get("INFER", "qwen2_decode", b).estimate == \
            store.get("INFER", "qwen2_decode", b).estimate > 0
    # and a store-seeded engine re-measures nothing
    tm2 = make_lm_decode_model("qwen2_decode", batches=(1, 2), device="cpu")
    assert tm2.seed_from_store(ProfileStore.load(path))
    seed_engines({"qwen2_decode": tm2}, ProfileStore.load(path))
    assert tm2.warmup_count == 0


def test_default_device_needs_a_card():
    """The entry point's default is the card, and without one it raises
    rather than running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="cuda"):
        make_lm_decode_model("qwen2_decode")
