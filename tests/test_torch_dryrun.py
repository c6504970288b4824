"""The port's dry run (``launch/dryrun.py``) on ``fake`` process groups: no
device, no allocation (DTensors whose local shards are fake tensors).

* The counterpart of test_system.py::test_dryrun_cell_machinery_small_mesh:
  smoke gemma2 on a fake 8-rank (2, 4) mesh, train shape (64, 8), chunk
  32: per-rank flops > 0 and collectives > 0, an all_reduce among them.
* ``python -m repro_torch.launch.dryrun`` on a production cell (qwen2-0.5b
  decode_32k on the 256-rank single mesh) writes an ``ok`` record under the
  reference's file name with every key the port measures, and ``null``
  for the ones it cannot.
* The reference's skip record for a cell ``shape_applicable`` rules out.
* Wire bytes by the reference's formulas (smoke gemma2 on the (2, 4)
  mesh, a train and a decode cell): each collective's from its operand,
  result and group size, the per-kind and total sums equal, and the
  vocab-parallel layer in the records: no all_gather of the table's shard
  (128 of 512 rows), no collective of a (B, S, V) or (B, S, V/4) operand
  but decode's gather of the (B, 1, V/4) row ``greedy_sample`` samples,
  the lookup's sum of (B/2, S, d) f32 rows over the 4 model ranks (a
  microbatch's rows in the train cell).

Each process group lives in a subprocess with a 240 s timeout.
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _python(args, timeout=240):
    out = subprocess.run([sys.executable, *args], capture_output=True,
                         text=True, timeout=timeout, cwd=ROOT,
                         env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


def test_dryrun_cell_machinery_small_mesh():
    code = textwrap.dedent("""
        import json
        from repro_torch.configs import get_smoke_config
        from repro_torch.configs.base import ShapeSpec
        from repro_torch.distributed.steps import build_sharded_step
        from repro_torch.launch import dryrun
        from repro_torch.launch.mesh import make_mesh
        with dryrun.fake_group(8):
            mesh = make_mesh((2, 4), ("data", "model"), device_type="cpu")
            cfg = get_smoke_config("gemma2-27b")
            step = build_sharded_step(cfg, mesh, ShapeSpec("t", "train", 64, 8),
                                      chunk=32)
            res = dryrun.measure(step)
        print(json.dumps(res))
    """)
    res = json.loads(_python(["-c", code]).strip().splitlines()[-1])
    assert res["mode"] == "heads" and res["devices"] == 8
    assert res["cost"]["flops"] > 0
    n = sum(c["count"] for c in res["collectives"].values())
    assert n > 0 and res["collective_operand_bytes"] > 0
    assert "all_reduce" in res["collectives"]
    mem = res["memory"]
    assert 0 < mem["argument_bytes"] < mem["peak_per_device"]


def test_dryrun_main_writes_production_cell(tmp_path):
    _python(["-m", "repro_torch.launch.dryrun", "--arch", "qwen2-0.5b",
             "--shape", "decode_32k", "--mesh", "single", "--out",
             str(tmp_path)])
    rec = json.loads((tmp_path / "qwen2-0.5b__decode_32k__single.json")
                     .read_text())
    assert rec["status"] == "ok", rec.get("error")
    assert (rec["arch"], rec["shape"], rec["mesh"]) == (
        "qwen2-0.5b", "decode_32k", "single")
    assert rec["mode"] == "context" and rec["devices"] == 256
    for k in ("argument_bytes", "output_bytes", "peak_per_device"):
        assert rec["memory"][k] > 0, k
    assert rec["memory"]["temp_bytes"] is None
    assert rec["cost"]["flops"] > 0
    assert rec["cost"]["bytes_accessed"] is None
    assert rec["cost"]["transcendentals"] is None
    assert rec["hlo_bytes"] is None and rec["unmeasured"]
    assert rec["looped"]["flops"] == rec["cost"]["flops"]
    assert rec["looped"]["coll_operand_bytes"] == rec[
        "collective_operand_bytes"] > 0
    assert rec["looped"]["coll_count"] == sum(
        c["count"] for c in rec["collectives"].values())
    # context mode decode at batch 128: the cache is gathered over the
    # sequence before the local kernel call
    assert rec["context_attention"] == "segmented"
    assert "all_gather_into_tensor" in rec["collectives"]


def test_dryrun_skip_record():
    from repro_torch.launch.dryrun import run_cell
    rec = run_cell("qwen2-0.5b", "long_500k", "single")
    assert rec["status"] == "skipped" and rec["reason"]


def test_dryrun_counts_expert_all_to_all_and_segmented_attention():
    """Smoke qwen3-moe on a fake 4-rank (2, 2) mesh: the expert-parallel
    path's all_to_all goes through the fake group and is counted; smoke
    qwen2 (7 heads on a model axis of 2: context mode) records the
    segment-parallel attention, whose merge all-reduces the outputs."""
    code = textwrap.dedent("""
        import json
        from repro_torch.configs import get_smoke_config
        from repro_torch.configs.base import ShapeSpec
        from repro_torch.distributed.steps import build_sharded_step
        from repro_torch.launch import dryrun
        from repro_torch.launch.mesh import make_mesh
        out = {}
        with dryrun.fake_group(4):
            mesh = make_mesh((2, 2), ("data", "model"), device_type="cpu")
            for arch in ("qwen3-moe-235b-a22b", "qwen2-0.5b"):
                step = build_sharded_step(get_smoke_config(arch), mesh,
                                          ShapeSpec("t", "train", 32, 8))
                out[arch] = dryrun.measure(step)
        print(json.dumps(out))
    """)
    res = json.loads(_python(["-c", code]).strip().splitlines()[-1])
    moe, dense = res["qwen3-moe-235b-a22b"], res["qwen2-0.5b"]
    assert moe["collectives"]["all_to_all_single"]["count"] > 0
    assert moe["collectives"]["all_to_all_single"]["operand_bytes"] > 0
    assert moe["context_attention"] is None
    assert dense["mode"] == "context"
    assert dense["context_attention"] == "segmented"
    assert "all_to_all_single" not in dense["collectives"]
    assert dense["collectives"]["all_reduce"]["count"] > 0


def test_dryrun_wire_bytes_and_vocab_parallel_small_mesh():
    code = textwrap.dedent("""
        import json
        from repro_torch.configs import get_smoke_config
        from repro_torch.configs.base import ShapeSpec
        from repro_torch.distributed.steps import build_sharded_step
        from repro_torch.launch import dryrun
        from repro_torch.launch.mesh import make_mesh
        recs, base = [], dryrun._Recorder

        class Kept(base):           # every op's record, not only the top
            def __init__(self, *args):
                super().__init__(*args)
                recs.append(self)
        dryrun._Recorder = Kept
        out = {}
        cfg = get_smoke_config("gemma2-27b")
        with dryrun.fake_group(8):
            mesh = make_mesh((2, 4), ("data", "model"), device_type="cpu")
            for shape in (ShapeSpec("t", "train", 64, 8),
                          ShapeSpec("d", "decode", 64, 8)):
                res = dryrun.measure(build_sharded_step(cfg, mesh, shape))
                out[shape.kind] = (res, recs[-1].collectives)
        print(json.dumps(out))
    """)
    res = json.loads(_python(["-c", code]).strip().splitlines()[-1])
    v, d = 512, 64
    for kind, (rec, ops) in res.items():
        assert rec["collective_wire_bytes"] == sum(
            c["wire_bytes"] for c in rec["collectives"].values()) == sum(
            o["wire_bytes"] for o in ops) > 0
        assert rec["looped"]["coll_wire_bytes"] == rec[
            "collective_wire_bytes"]
        assert rec["collective_operand_bytes"] == sum(
            o["operand_bytes"] for o in ops)
        assert len(rec["top_collectives"]) <= 12
        for o in ops:
            op, res_b, g = o["operand_bytes"], o["result_bytes"], o["group"]
            assert g in (2, 4, 8), o
            want = {"all_gather_into_tensor": res_b - op,
                    "reduce_scatter_tensor": op - res_b,
                    "all_reduce": 2 * res_b * (g - 1) // g,
                    "all_to_all_single": res_b * (g - 1) // g}[o["kind"]]
            assert o["wire_bytes"] == want, o
            if o["kind"] == "all_gather_into_tensor":
                assert res_b == op * g and o["shape"] != [v // 4, d], o
            shape = o["shape"]
            if len(shape) == 3 and shape[-1] in (v, v // 4):
                # decode's greedy_sample gathers the one row it samples
                assert kind == "decode" and shape == [4, 1, v // 4], o
        # 8 rows over 2 data ranks; train in 4 microbatches of 64 tokens
        b, s = (4, 1) if kind == "decode" else (1, 64)
        assert {"kind": "all_reduce", "shape": [b, s, d], "dtype": "float32",
                "group": 4} in [{k: o[k] for k in ("kind", "shape", "dtype",
                                                    "group")} for o in ops]
