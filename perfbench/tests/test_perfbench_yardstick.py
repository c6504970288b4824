"""The yardstick's frozen pieces: the open-loop generator with due times, the percentile and goodput arithmetic, the FLOP and byte
formulas, and the busy-interval union."""
import json
import math
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

from perfbench.harness import roofline, stats
from perfbench.harness import trace as tr
from perfbench.harness import traffic as tf

CELLS = Path(__file__).resolve().parents[1] / "cells"
CONFIGS = Path(__file__).resolve().parents[1] / "configs"


def _traffic(cell):
    return json.loads((CELLS / f"{cell}.json").read_text())["traffic"]


# ------------------------------------------------------------ generators

@pytest.mark.parametrize("cell,n", [("resnet50.poisson", 4),
                                    ("qwen2-0.5b.decode", 1)])
def test_same_seed_same_schedule_and_fixed_counts(cell, n):
    t = _traffic(cell)
    big = 2 ** 31 + 12345
    d1, m1 = tf.schedule(t, n, big, 30)
    d2, m2 = tf.schedule(t, n, big, 30)
    d3, m3 = tf.schedule(t, n, big + 1, 30)
    assert np.array_equal(d1, d2) and np.array_equal(m1, m2)
    assert not np.array_equal(d1, d3)
    assert np.all(np.diff(d1) >= 0)
    warm = t["warmup_s"]
    for d, m in ((d1, m1), (d3, m3)):            # the same work per seed
        inside = (d >= warm) & (d < warm + 30)
        counts = np.bincount(m[inside], minlength=n)
        assert counts.tolist() == tf.expected_counts(t, n, 30)["window"]
    total = sum(tf.expected_counts(t, n, 30)["window"])
    assert abs(total - t["rate"] * 30) <= n


# ------------------------------------------------- percentiles and goodput

def _req(due, completion, status):
    return SimpleNamespace(due=due, completion=completion, status=status)


def test_percentile_is_nearest_rank():
    assert stats.percentile(range(1, 101), 99) == 99
    assert stats.percentile(range(1, 101), 50) == 50
    assert stats.percentile([5.0], 99) == 5.0
    assert stats.percentile([], 99) is None


def test_a_stall_inside_the_window_moves_the_tail():
    # 1,000 requests due every ms, each answered 5 ms after it was due
    calm = [_req(i * 1e-3, i * 1e-3 + 5e-3, "ok") for i in range(1000)]
    # a 50 ms stall of the sender at t=0.5: the 50 requests due in it are
    # sent and answered only after it; measured from when they were due,
    # their wait shows
    stalled = [_req(r.due, max(r.completion, 0.555) if 0.5 <= r.due < 0.55
                    else r.completion, "ok") for r in calm]
    assert stats.tail_ms(calm) == pytest.approx(5.0)
    assert stats.tail_ms(stalled) > 40.0


def test_unanswered_and_refused_requests_count_against_goodput():
    reqs = ([_req(0, 0.01, "ok")] * 90 + [_req(0, 0.2, "timeout")] * 4
            + [_req(0, 0.0, "rejected")] * 3 + [_req(0, None, None)] * 3)
    assert stats.goodput(reqs, 10.0) == pytest.approx(9.0)
    assert stats.unanswered(reqs) == 3
    # the tail is over answered requests only (ok and timed out)
    assert stats.tail_ms(reqs) == pytest.approx(200.0)


def test_outstanding_counts_due_and_not_completed():
    reqs = [_req(0.0, 1.0, "ok"), _req(0.5, None, None), _req(2.0, 3.0, "ok")]
    assert stats.outstanding(reqs, 0.75) == 2
    assert stats.outstanding(reqs, 2.5) == 2


# --------------------------------------------------------------- formulas

def test_resnet50_flops_by_the_ports_own_shapes():
    from repro_torch.models import params as ps
    from repro_torch.models.resnet import resnet50_spec
    sizes = json.loads((CONFIGS / "resnet50.json").read_text())
    spec = resnet50_spec(num_classes=sizes["num_classes"])
    # count every conv's multiply-adds from the served spec's HWIO shapes
    # at the output sizes of XLA's SAME padding (stride on the 3x3 conv)
    n = math.ceil(224 / 2)
    kh, kw, ci, co = spec["stem"].shape
    flops = 2 * kh * kw * ci * co * n * n
    n = math.ceil(n / 2)
    for si in range(4):
        for bi, blk in enumerate(spec[f"stage{si}"]):
            m = math.ceil(n / (2 if bi == 0 and si > 0 else 1))
            for name, size in (("conv1", n), ("conv2", m), ("conv3", m),
                               ("proj", m)):
                if name in blk:
                    kh, kw, ci, co = blk[name].shape
                    flops += 2 * kh * kw * ci * co * size * size
            n = m
    flops += 2 * math.prod(spec["head"].shape)
    assert roofline.resnet50_flops(sizes) == flops
    assert flops == 8_178_368_512            # 4.09 GMAC an image
    assert ps.param_count(spec) == 25_556_032


def test_qwen2_decode_flops_count_each_matmul_once():
    sizes = json.loads((CONFIGS / "qwen2-0.5b.json").read_text())
    d, ff, L = 896, 4864, 24
    params_per_layer = d * 14 * 64 + 2 * d * 2 * 64 + 14 * 64 * d + 3 * d * ff
    attention = 4 * 14 * 1025 * 64
    want = L * (2 * params_per_layer + attention) + 2 * d * 151936
    assert roofline.qwen2_decode_flops(sizes, 1024) == want
    assert roofline.decode_attention_live(1024) == 1025


def test_flash_decode_work_reads_live_slots_once():
    b, f = roofline.flash_decode_work(32, 14, 2, 64, slots=2048, live=1025)
    assert b == 2 * 32 * 14 * 64 * 2 + 2 * 32 * 1025 * 2 * 64 * 2 + 2048 * 4
    assert f == 4 * 32 * 14 * 1025 * 64
    # bytes bound: 16.9 MB at 3.35 TB/s
    assert roofline.bound_s(b, f) == pytest.approx(b / 3.35e12)


# ------------------------------------------------------ busy-interval union

def _dev(*spans, name="k", kind="kernel"):
    return [(s, e, name, kind) for s, e in spans]


@pytest.mark.parametrize("device,window,busy", [
    (_dev((0, 10), (5, 15), (20, 30)), (0, 100), 25),      # overlapping
    (_dev((0, 50), (10, 20), (30, 40)), (0, 100), 50),     # nested
    (_dev((-20, 10), (90, 150), (200, 300)), (0, 100), 20),  # outside
    (_dev((0, 100), (0, 100)), (0, 100), 100),             # twice the same
    (_dev((10, 20), name="m", kind="gpu_memcpy") + _dev((15, 25)),
     (0, 100), 15),                                         # copies count
])
def test_busy_is_the_union_inside_the_window(device, window, busy):
    t = tr.summarize(device, window)
    assert t.busy_s == pytest.approx(busy / 1e9)
    assert 0 < t.busy_s <= t.window_s == pytest.approx(
        (window[1] - window[0]) / 1e9)
    assert tr.union_length([(s, e) for s, e, _, _ in device],
                           *window) == pytest.approx(busy)


def test_many_overlapping_streams_never_exceed_the_window():
    rng = np.random.default_rng(0)
    starts = rng.uniform(-1e6, 2e6, 5000)
    device = _dev(*[(s, s + rng.uniform(0, 1e5)) for s in starts])
    t = tr.summarize(device, (0, 1e6))
    assert 0 < t.busy_s <= t.window_s
    assert sum(t.by_name.values()) > t.window_s     # a plain sum would


def test_a_trace_with_no_device_record_fails():
    with pytest.raises(tr.TraceError):
        tr.summarize([], (0, 100))
    with pytest.raises(tr.TraceError):
        tr.summarize(_dev((200, 300)), (0, 100))
    with pytest.raises(tr.TraceError):
        tr.summarize(_dev((0, 10)), (100, 100))


def test_idle_gaps_are_labelled_by_the_innermost_open_span():
    us = 1000                                    # the trace counts ns
    device = _dev((0, 10 * us), (100 * us, 110 * us), (200 * us, 210 * us),
                  (215 * us, 216 * us))
    spans = [(5 * us, 150 * us, "backend.exec"),
             (40 * us, 80 * us, "model.make_input")]
    t = tr.summarize(device, (0, 300 * us), spans)
    # 10..100 us (mid 55: make_input inside exec), 110..200 (mid 155:
    # none), 210..215 (short), 216..300 (none)
    assert t.idle_by_span == pytest.approx(
        {"model.make_input": 90e-6, tr.NO_SPAN: 174e-6,
         "gaps_under_10us": 5e-6})
    assert t.kernels == 4



def test_a_trace_that_lost_its_records_fails_and_a_full_one_is_kept():
    from perfbench.harness.cell import _validate_trace
    deploy = SimpleNamespace(port_kernels_per_infer=lambda: {"k": 1})
    infers = [SimpleNamespace(t0=t, bucket=1) for t in (0.5, 1.5, 2.5)]

    def rec(kernels, err=None):
        t = None if err else tr.summarize(_dev(*[(i, i + 1)
                                                  for i in range(kernels)]),
                                           (0, 1e9))
        return SimpleNamespace(window_trace=(t, 1.0, 3.0, err),
                               infers=infers, trace=None, traced_infers=[])
    kept, notes = rec(20), []
    _validate_trace(kept, {1: 10}, deploy, notes)
    assert kept.trace.kernels == 20
    assert kept.traced_infers == infers[1:]
    with pytest.raises(tr.TraceError):
        _validate_trace(rec(3), {1: 10}, deploy, [])
    with pytest.raises(tr.TraceError):
        _validate_trace(rec(0, "no device record"), {1: 10}, deploy, [])


class _Event:
    def __init__(self, name, start, dur, on_card, annotation):
        self._v = (name, start, dur, on_card, annotation)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2]

    def device_type(self):
        from torch.autograd import DeviceType
        return DeviceType.CUDA if self._v[3] else DeviceType.CPU

    def is_user_annotation(self):
        return self._v[4]


def test_read_profile_keeps_device_records_and_the_benchmarks_spans():
    events = [_Event("perfbench.window", 0, 100, False, True),
              _Event("pb.model.forward", 10, 20, False, True),
              _Event("aten::mm", 11, 5, False, False),
              _Event("cudaLaunchKernel", 12, 1, False, False),
              _Event("perfbench.window", 0, 100, True, True),   # on the GPU
              _Event("sm90_xmma_gemm", 20, 30, True, False),
              _Event("Memcpy HtoD (Pinned -> Device)", 5, 3, True, False),
              _Event("Memset (Device)", 60, 2, True, False)]
    prof = SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: events)))
    device, window, spans = tr.read_profile(prof)
    assert window == (0, 100)
    assert spans == [(10, 30, "model.forward")]
    assert [(d[2], d[3]) for d in device] == [
        ("sm90_xmma_gemm", "kernel"),
        ("Memcpy HtoD (Pinned -> Device)", "gpu_memcpy"),
        ("Memset (Device)", "gpu_memset")]
