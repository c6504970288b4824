"""A configuration, a cell (its traffic mix) and two metrics added as
files and manifest entries only, in a temporary copy of the benchmark, are
found by name and run at a tiny size on the CPU; no file of the harness
is edited."""
import json
import shutil
import time
from pathlib import Path

import torch

from perfbench.harness import manifest, serve
from perfbench.harness.cell import run_cell
from perfbench.tests.tiny import TINY_LIMITS

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def _copy(tmp: Path) -> Path:
    root = tmp / "checkout"
    shutil.copytree(BENCH, root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    return root


def _add_files(root: Path):
    sizes = json.loads((root / "perfbench/configs/resnet50.json").read_text())
    sizes.update({"name": "resnet50-tiny", "widths": [8, 8, 16, 32],
                  "image_size": 32, "num_classes": 10, "buckets": [1, 2, 4],
                  "input_pool": 16, "limits": TINY_LIMITS})
    (root / "perfbench/configs/resnet50-tiny.json").write_text(
        json.dumps(sizes))
    (root / "perfbench/cells/resnet50-tiny.steady.json").write_text(
        json.dumps({"config": "resnet50-tiny", "instances": 2,
                    "traffic": {"shape": "poisson", "rate": 30,
                                "slo_ms": 200, "warmup_s": 1}}))
    (root / "perfbench/metrics/answered_per_s.py").write_text(
        "def read(rec):\n"
        "    done = [s for s in rec.requests if s.status in ('ok', 'timeout')]\n"
        "    return len(done) / rec.seconds\n")
    (root / "perfbench/metrics/rows_per_infer.py").write_text(
        "def read(rec):\n"
        "    if not rec.infers:\n"
        "        return None\n"
        "    return sum(i.bucket for i in rec.infers) / len(rec.infers)\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "resnet50-tiny", "source": "test",
                             "file": "perfbench/configs/resnet50-tiny.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "resnet50-tiny.steady",
                               "config": "resnet50-tiny",
                               "traffic": "steady", "chips": 1,
                               "why": "test"})
    bench["end_to_end"].append({"name": "answered_per_s", "unit": "req/s",
                                "better": "higher", "bound": 0.25,
                                "source": "host_clock",
                                "workloads": ["resnet50-tiny.steady"]})
    bench["per_layer"].append({"name": "rows_per_infer", "unit": "rows",
                               "better": "higher",
                               "source": "program_counter",
                               "layer": "scheduler (core/scheduler.py)",
                               "moves": "answered_per_s",
                               "workloads": ["resnet50-tiny.steady"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))


def test_added_files_are_found_and_run(tmp_path):
    root = _copy(tmp_path)
    harness_before = {p: p.read_bytes()
                      for p in (root / "perfbench/harness").rglob("*.py")}
    _add_files(root)
    out = run_cell(root, "resnet50-tiny.steady", 2 ** 31 + 3, 3, False,
                   device="cpu")
    r = out.result
    assert set(r["metrics"]) == {"goodput", "setup_s", "answered_per_s"}
    assert r["metrics"]["answered_per_s"]["unit"] == "req/s"
    assert r["attempted"] == 90 and r["failed"] == 0
    assert r["metrics"]["answered_per_s"]["value"] > 0
    assert list(r["checks"]) == ["logit_err", "unanswered"]
    assert list(r)[-1] == "checks"
    # the per-layer metric: found for the new cell and read from a run
    c = manifest.load(root, "resnet50-tiny.steady")
    assert [m["name"] for m in c.per_layer] == ["rows_per_infer"]
    deploy = c.adapter().build(c.sizes, c.cell, 5, torch.device("cpu"))
    rec = serve.run(deploy, c.cell["traffic"], 5, 2, traced=False,
                    t_start=time.monotonic())
    assert c.reader(c.per_layer[0])(rec) >= 1
    assert harness_before == {p: p.read_bytes() for p in
                              (root / "perfbench/harness").rglob("*.py")}


def test_each_cell_reports_what_the_manifest_gives_it():
    names = {w["name"] for w in json.loads(
        (ROOT / "BENCHMARK.json").read_text())["workloads"]}
    for w in names:
        c = manifest.load(ROOT, w)
        e2e = {m["name"] for m in c.end_to_end}
        per = {m["name"] for m in c.per_layer}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert any(n.startswith("idle_pct.") for n in per)
        assert any(n.startswith("mfu_pct.") for n in per)
        for m in c.per_layer:
            assert m["moves"] in e2e, (w, m["name"])
            assert (BENCH / "metrics" / f"{m['name']}.py").is_file()
        assert (BENCH / "cells" / f"{w}.json").is_file()
