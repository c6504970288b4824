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

* Smoke gemma2, qwen3-moe (Adafactor) and mamba2 (AdamW) train cells on a
  (2, 4) mesh beside the JAX package's own ``run_cell`` on 8 forced host
  devices: the same arguments, the port's peak and collective operand
  bytes within 1.5x of the reference's, its flops within 1.2x (not the
  MoE's, padded to 64-row expert blocks), and no
  all_gather or reduce_scatter of a stacked weight matrix over its
  layers.

Each process group lives in a subprocess with a 240 s timeout.
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

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


_REF_CELL = """
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax
jax.devices()       # 8 host devices, before the dry run asks for 512
from repro.configs import get_smoke_config
from repro.configs.base import ShapeSpec
from repro.launch import dryrun
from repro.launch.mesh import make_mesh
dryrun.get_config = get_smoke_config
dryrun.SHAPES = {"t": ShapeSpec("t", sys.argv[2], 32, 8)}
dryrun.make_production_mesh = lambda multi_pod=False: make_mesh(
    (2, 4), ("data", "model"))
print(json.dumps(dryrun.run_cell(sys.argv[1], "t", "single")))
"""

_PORT_CELL = """
import json, math, sys
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.distributed.steps import build_sharded_step
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.registry import get_bundle
recs, base = [], dryrun._Recorder

class Kept(base):           # every op's record, not only the top
    def __init__(self, *args):
        super().__init__(*args)
        recs.append(self)
dryrun._Recorder = Kept
with dryrun.fake_group(8):
    mesh = make_mesh((2, 4), ("data", "model"), device_type="cpu")
    step = build_sharded_step(get_smoke_config(sys.argv[1]), mesh,
                              ShapeSpec("t", sys.argv[2], 32, 8))
    res = dryrun.measure(step)
stacked = []                # each stacked matrix's local shape but L
spec = dryrun.tree_leaves(step.abstract[0])
axes = dryrun.tree_leaves_like(get_bundle(get_smoke_config(sys.argv[1]))
                               .spec(), step.abstract[0])
for t, pl, sp in zip(spec, dryrun.tree_leaves_like(step.in_shardings[0],
                                                   step.abstract[0]), axes):
    shape = list(t.shape)
    for i, p in enumerate(pl):
        if p.is_shard():
            shape[p.dim] //= mesh.size(i)
    if sp.axes[0] == "layers" and len(shape) >= 3:
        stacked.append(shape[1:])
print(json.dumps({"res": res, "ops": recs[-1].collectives,
                  "stacked": stacked}))
"""


def _cells_beside(arch, kind):
    """(the port's child output, the reference's record, the port's
    record) of one smoke (8, 32) cell on the (2, 4) mesh; the peak and
    collective operand bytes held within 1.5x of the reference's."""
    ref = json.loads(_python(["-c", _REF_CELL, arch, kind]).strip()
                     .splitlines()[-1])
    port = json.loads(_python(["-c", _PORT_CELL, arch, kind]).strip()
                      .splitlines()[-1])
    res = port["res"]
    assert ref["status"] == "ok" and ref["devices"] == res["devices"] == 8
    peak, ref_peak = (res["memory"]["peak_per_device"],
                      ref["memory"]["peak_per_device"])
    coll, ref_coll = (res["looped"]["coll_operand_bytes"],
                      ref["looped"]["coll_operand_bytes"])
    assert 0 < peak <= 1.5 * ref_peak, (peak, ref_peak)
    assert 0 < coll <= 1.5 * ref_coll, (coll, ref_coll)
    return port, ref, res


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "phi4-mini-3.8b",
                                  "mamba2-130m"])
def test_dryrun_prefill_cell_beside_reference_small_mesh(arch):
    """Smoke prefill cells, (8, 32) on the (2, 4) mesh, beside the
    reference's ``run_cell``: the same arguments, the peak and collective
    operand bytes within 1.5x. The peak holds each kernel call's outputs,
    not its plain version's (B, H, Sq, Skv) f32 scores (which made smoke
    qwen2's 1.85x the reference's)."""
    _, ref, res = _cells_beside(arch, "prefill")
    assert res["memory"]["argument_bytes"] == (
        ref["memory"]["argument_bytes"])


_LAYOUTS = """
import json, torch
from torch.distributed.tensor import DTensor, Shard
from torch.distributed.tensor.experimental import implicit_replication
from torch._subclasses.fake_tensor import FakeTensorMode
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.distributed import sharding
from repro_torch.distributed.steps import build_sharded_step
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import attention, ssm
out = {}
with dryrun.fake_group(8):
    mesh = make_mesh((2, 4), ("data", "model"), device_type="cpu")
    fake = FakeTensorMode(allow_non_fake_inputs=True)
    with fake:
        x = DTensor.from_local(torch.empty(4, 32, 8, 4, dtype=torch.bfloat16),
                               mesh, (Shard(0), Shard(3)))
        kern = DTensor.from_local(torch.empty(4, 8, 4, dtype=torch.bfloat16),
                                  mesh, (sharding.Replicate(), Shard(2)))
    rec = dryrun._Recorder(fake)
    with dryrun._dtensor_internals_unrecorded(rec), fake, rec, \
            implicit_replication():     # as use_rules enters it
        y = ssm.causal_conv(x, kern)
    out["conv"] = {"peak": rec.peak, "global_f32": 8 * 32 * 8 * 16 * 4,
                   "placements": str(y.placements)}
    cfg = get_smoke_config("phi4-mini-3.8b")
    shape = ShapeSpec("t", "prefill", 32, 8)
    step = build_sharded_step(cfg, mesh, shape)
    dec = sharding.make_rules(mesh, cfg, "decode", shape)
    made, pack = [], attention.prefill_into_cache

    def recorded(*args, **kwargs):
        c = pack(*args, **kwargs)
        made.append([str(c["k"].placements), str(sharding.placements(
            mesh, sharding.spec_for(dec, attention.cache_axes(),
                                    tuple(c["k"].shape))))])
        return c
    from repro_torch.models import lm
    lm.prefill_into_cache = recorded
    dryrun.measure(step)
    out["cache"] = made
print(json.dumps(out))
"""


def test_dryrun_layouts_of_conv_and_prefill_cache():
    """Under a (2, 4) fake mesh: the causal conv's f32 accumulator is laid
    out as its input (it held the global shape on every rank: mamba2-130m
    prefill_32k's peak was 4.1x the reference's); and each layer's prefill
    cache is laid out as decode reads it when it is made (phi4-mini, whose
    K/V heads do not split: the stack held every layer's whole K/V, its
    prefill_32k peak 3.5x the reference's)."""
    out = json.loads(_python(["-c", _LAYOUTS]).strip().splitlines()[-1])
    conv = out["conv"]
    assert conv["peak"] < conv["global_f32"], conv
    assert "Shard(dim=3)" in conv["placements"], conv
    assert out["cache"], "no prefill cache made"
    for got, want in out["cache"]:
        assert got == want and "Shard" in want, (got, want)


@pytest.mark.parametrize("arch", ["gemma2-27b", "qwen3-moe-235b-a22b",
                                  "mamba2-130m"])
def test_dryrun_train_cell_beside_reference_small_mesh(arch):
    """Smoke gemma2 and qwen3-moe (both Adafactor) and mamba2 (AdamW)
    train cells, (8, 32) on a (2, 4) mesh (32 tokens: no activation shares
    a stacked weight's shape, whose d_model is 64): the port's dry run on a fake group beside the JAX
    package's ``run_cell`` (its production config, shape and mesh swapped
    for these) on 8 forced host devices in a child. The same arguments
    (the reference also counts its int32 step), and the port's peak and
    collective operand bytes within 1.5x of the reference's (the issue's
    limit for a production cell; all are below 1x here), and, but for
    the MoE (whose expert products run over the capacity padded to 64-row
    blocks, which at this size is most of their rows), its flops within
    1.2x: the kernels' formulas beside XLA's dots, where a backward product
    on the whole width of a sharded dim made mamba2's 1.24x. No all_gather or
    reduce_scatter has the local shape of a stacked weight matrix but for
    its layers dim: the gradients are reduced once, in the parameter dtype,
    and the optimizer's norms and means reduce local shards."""
    port, ref, res = _cells_beside(arch, "train")
    assert res["memory"]["argument_bytes"] == (
        ref["memory"]["argument_bytes"] - 4)
    flops, ref_flops = res["cost"]["flops"], ref["looped"]["flops"]
    if arch != "qwen3-moe-235b-a22b":
        assert 0 < flops <= 1.2 * ref_flops, (flops, ref_flops)
    for op in port["ops"]:
        if op["kind"] in ("all_gather_into_tensor", "reduce_scatter_tensor"):
            assert op["shape"][1:] not in port["stacked"], op
