"""Multi-pod dry run (port of ``repro.launch.dryrun``): run every
(architecture x input-shape) cell's sharded step on the production meshes
and record memory, flops and collectives per rank, with no device and no
allocation.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma2-27b \\
        --shape decode_32k --mesh single --out experiments/dryrun

or every cell with --all, one process per cell.

A cell initialises a ``fake`` process group whose world size is the mesh's
size (256 or 512), builds the production mesh of CPU ranks and runs
``build_sharded_step``'s ``fn`` once, as rank 0, on DTensors whose local
shards are fake tensors (``FakeTensorMode``): every op runs on shapes only,
so a 400B-parameter cell takes a few GB of host memory. Collectives run
through the fake group and move nothing. The step is eager, so every layer
runs and there is no loop nest to correct (the reference's ``looped``
totals equal the plain ones here, and the reference's HLO parser has no
counterpart). What it records, per rank, as rank 0 sees it:

* flops: each kernel's own work by its formula (``kernels/work.py``: CPU
  shards run the kernels' plain versions, whose ops are not counted), and
  every other local op's count by ``torch.utils.flop_counter``'s formulas;
* collectives: every functional collective the step issues, DTensor's
  and the model's own (``all_reduce``, ``all_gather_into_tensor``,
  ``reduce_scatter_tensor``, the expert-parallel MoE's differentiable
  ``all_to_all_single``, the context attention's merge, the vocab-parallel
  sums, ...) by kind, with its input bytes and the bytes a rank sends over
  the wire, by the reference's formulas from the group size (all-gather:
  result - operand; reduce-scatter: operand - result; all-reduce:
  2·result·(g-1)/g; all-to-all: result·(g-1)/g); and the (kind, shape)
  groups with the most bytes;
* memory: the local bytes of the arguments and outputs, and the peak: the
  arguments plus the most bytes the step's own local tensors held at once.

These are counts on the CPU's fake group, not measurements of any device.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time
import traceback
import weakref

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves as pytree_leaves

from repro_torch.configs import ARCH_NAMES, SHAPES, get_config
from repro_torch.configs.base import shape_applicable
from repro_torch.configs.shapes import decode_cache_len
from repro_torch.distributed.steps import build_sharded_step
from repro_torch.kernels import work
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.utils import tree_leaves, tree_leaves_like, tree_unflatten

TOP = 12
TRACE_TOP = 40
FLOPS_NOTE = ("the kernels' own work by their formulas (kernels/work.py: "
              "4·D flops a live (q, k) pair and head forward, 10·D "
              "backward; the SSD scan's least operations), every other op "
              "by torch.utils.flop_counter's formulas; forward, remat's "
              "recompute and backward, every layer")
UNMEASURED = ("no compiled program: the eager step's bytes accessed, "
              "transcendentals, temporary buffers and HLO text are not "
              "counted")


@contextlib.contextmanager
def fake_group(world_size: int):
    """A ``fake`` process group of ``world_size`` ranks, this process as
    rank 0, destroyed on exit."""
    import torch.testing._internal.distributed.fake_pg  # noqa: F401  registers "fake"
    dist.init_process_group("fake", store=dist.HashStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in pytree_leaves(tree)
               if isinstance(t, torch.Tensor))


def _group_size(func, args, kwargs) -> int:
    """The size of a functional collective's process group, from its
    ``group_name`` argument."""
    named = dict(zip((a.name for a in func._schema.arguments), args))
    group = {**named, **kwargs}["group_name"]
    if isinstance(group, str):
        group = dist.distributed_c10d._resolve_process_group(group)
    return group.size()


# Bytes a rank sends over the wire, from the operand and result bytes and
# the group size g: the reference's formulas (``repro.launch.dryrun``).
_WIRE = {
    "all_gather_into_tensor": lambda op, res, g: res - op,
    "reduce_scatter_tensor": lambda op, res, g: op - res,
    "all_reduce": lambda op, res, g: 2 * res * (g - 1) // g,
    "all_to_all_single": lambda op, res, g: res * (g - 1) // g,
}


def _frame():
    """``file:line function`` of the innermost caller in the port's own
    code (outside this module and ``kernels/work.py``), or None."""
    f = sys._getframe(1)
    while f is not None:
        name = f.f_code.co_filename
        if "repro_torch" in name and not name.endswith(("dryrun.py",
                                                         "work.py")):
            return (f"{name[name.rindex('repro_torch'):]}:{f.f_lineno} "
                    f"{f.f_code.co_name}")
        f = f.f_back
    return None


def _collective(func, kind, args, kwargs, x, out) -> dict:
    """One functional collective's record: its kind, operand (shape,
    dtype, bytes), group size, result and wire bytes."""
    g = _group_size(func, args, kwargs)
    op, res = x.numel() * x.element_size(), _nbytes(out)
    return {"kind": kind, "shape": list(x.shape),
            "dtype": str(x.dtype).removeprefix("torch."), "group": g,
            "operand_bytes": op, "result_bytes": res,
            "wire_bytes": _WIRE.get(kind, lambda op, res, g: res)(op, res, g)}


class _Recorder(TorchDispatchMode):
    """Per-rank flops, collectives and memory of the local ops on one fake
    mode's tensors (with ``fake_mode`` None, on real tensors: the gloo
    tests read a step's collectives so). An op on DTensors is handed back
    to DTensor (NotImplemented), whose local ops then come through here;
    nothing is counted while ``paused`` (DTensor's propagation of global
    shapes). The
    peak is the most bytes the storages made by counted ops held at once,
    each freed when its storage dies (``MemTracker`` would count the
    global-shape tensors of the propagation too)."""

    TRACE_MIN = 2**20       # trace storages and collectives of 1 MiB up

    def __init__(self, fake_mode, trace: bool = False):
        super().__init__()
        self.fake_mode = fake_mode
        self.paused = 0
        self.flops = 0
        self.collectives = []
        self.live, self.peak, self._sizes = 0, 0, {}
        # with ``trace``: (bytes, shape, dtype, frame) of each live storage
        # of TRACE_MIN bytes up, and those live at the last snapshot taken
        # as the peak rose (by 0.25% or more since the one before)
        self.trace, self._meta, self.at_peak, self._snap = trace, {}, [], 0
        self.flops_by_site = {}     # with ``trace``: (op, frame) -> flops
        self.in_kernel = 0          # inside a kernel's plain version

    def __enter__(self):
        self._counting = work.counting(self)
        self._counting.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        self._counting.__exit__(*exc)
        return super().__exit__(*exc)

    def _add_flops(self, key, n):
        self.flops += n
        if self.trace:
            self.flops_by_site[key] = self.flops_by_site.get(key, 0) + n

    def kernel_outputs(self, out):
        """A kernel's outputs, made inside its plain version."""
        self._track(out)

    def kernel(self, name, n):
        """A kernel's operations by its formula (``kernels/work.py``)."""
        self._add_flops((f"kernel:{name}", _frame() if self.trace else None),
                        n)

    def held(self, tree):
        """Count the storages of ``tree`` (the step's arguments, counted
        apart) as held already: an op whose output aliases one (a
        parameter's ``detach``, a view, a cache written in place) adds
        nothing to the peak."""
        for t in pytree_leaves(tree):
            if isinstance(t, DTensor):
                t = t.to_local()
            if isinstance(t, torch.Tensor):
                self._sizes.setdefault(t.untyped_storage()._cdata, 0)

    def _free(self, key):
        self.live -= self._sizes.pop(key)
        self._meta.pop(key, None)

    def _track(self, out):
        for t in pytree_leaves(out):
            if not (isinstance(t, torch.Tensor)
                    and getattr(t, "fake_mode", None) is self.fake_mode):
                continue
            st = t.untyped_storage()
            if st._cdata in self._sizes:
                continue
            self._sizes[st._cdata] = st.nbytes()
            self.live += st.nbytes()
            if self.trace and st.nbytes() >= self.TRACE_MIN:
                self._meta[st._cdata] = (st.nbytes(), list(t.shape),
                                         str(t.dtype).removeprefix("torch."),
                                         _frame())
            if self.live > self.peak:
                self.peak = self.live
                if self.trace and self.live > 1.0025 * self._snap:
                    self._snap, self.at_peak = self.live, list(
                        self._meta.values())
            weakref.finalize(st, self._free, st._cdata)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.utils.flop_counter import flop_registry
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if self.paused:
            return out
        ts = [t for t in pytree_leaves((args, kwargs))
              if isinstance(t, torch.Tensor)]
        if ts and all(getattr(t, "fake_mode", None) is self.fake_mode
                      for t in ts):
            if not self.in_kernel:
                self._track(out)
            packet = func._overloadpacket
            name = packet.__name__
            if (func.namespace in ("_c10d_functional",
                                   "_c10d_functional_autograd")
                    and name != "wait_tensor"
                    and not name.startswith("_")):   # _wrap_tensor_autograd
                op = _collective(func, name, args, kwargs, ts[0], out)
                if self.trace and op["operand_bytes"] >= self.TRACE_MIN:
                    op["frame"] = _frame()
                self.collectives.append(op)
            elif packet in flop_registry and not self.in_kernel:
                n = int(flop_registry[packet](*args, **kwargs, out_val=out))
                self._add_flops((name, _frame() if self.trace else None), n)
        return out


def _local_bytes(tree) -> int:
    return sum(t.to_local().numel() * t.to_local().element_size()
               if isinstance(t, DTensor) else t.numel() * t.element_size()
               for t in tree_leaves(tree) if isinstance(t, torch.Tensor))


def fake_arguments(step, fake_mode):
    """``step.abstract`` as DTensors on ``step.mesh`` laid out by
    ``step.in_shardings``, each local shard a fake tensor of its local
    shape: nothing is allocated."""
    mesh = step.mesh

    def one(abs_tree, sh_tree):
        out = []
        for t, pl in zip(tree_leaves(abs_tree),
                         tree_leaves_like(sh_tree, abs_tree)):
            local_shape = list(t.shape)     # the rules shard evenly
            for i, p in enumerate(pl):
                if p.is_shard():
                    local_shape[p.dim] //= mesh.size(i)
            with fake_mode:
                local = torch.empty(local_shape, dtype=t.dtype)
            out.append(DTensor.from_local(local, mesh, pl))
        return tree_unflatten(abs_tree, out)

    return tuple(one(a, s) if s is not None else a
                 for a, s in zip(step.abstract, step.in_shardings))


@contextlib.contextmanager
def _dtensor_internals_unrecorded(rec):
    """Keep two pieces of DTensor's own machinery out of the counts.

    * Sharding propagation runs each new op once on fake tensors of its
      global shape, to learn the output's shape; it takes the active fake
      mode, so ``rec`` pauses while it runs.
    * DTensor finds a strided shard's offsets with ``torch.arange(n)`` and
      ``.tolist()``, which a fake mode cannot answer: that helper runs
      outside the fake mode (its tensors are index lists of one dim)."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    from torch.distributed.tensor.placement_types import _StridedShard
    offsets = _StridedShard.local_shard_size_and_offset
    shapes = ShardingPropagator._propagate_tensor_meta_non_cached

    def unfaked(self, *args, **kwargs):
        with unset_fake_temporarily():
            return offsets(self, *args, **kwargs)

    def paused(self, *args, **kwargs):
        rec.paused += 1
        try:
            return shapes(self, *args, **kwargs)
        finally:
            rec.paused -= 1

    _StridedShard.local_shard_size_and_offset = unfaked
    ShardingPropagator._propagate_tensor_meta_non_cached = paused
    try:
        yield
    finally:
        _StridedShard.local_shard_size_and_offset = offsets
        ShardingPropagator._propagate_tensor_meta_non_cached = shapes


def _traced(rec) -> dict:
    """With ``trace``: the storages live at the peak and the large
    collectives, each grouped by (shape, dtype, the port's frame that made
    it), most bytes first; the flops by (op, frame), most first."""
    live = {}
    for nbytes, shape, dtype, frame in rec.at_peak:
        e = live.setdefault((tuple(shape), dtype, frame),
                            {"shape": shape, "dtype": dtype, "frame": frame,
                             "count": 0, "bytes": 0})
        e["count"] += 1
        e["bytes"] += nbytes
    colls = {}
    for op in rec.collectives:
        if "frame" not in op:
            continue
        e = colls.setdefault(
            (op["kind"], tuple(op["shape"]), op["dtype"], op["group"],
             op["frame"]),
            {k: op[k] for k in ("kind", "shape", "dtype", "group", "frame")}
            | {"count": 0, "operand_bytes": 0})
        e["count"] += 1
        e["operand_bytes"] += op["operand_bytes"]
    sites = [{"op": op, "frame": frame, "flops": n}
             for (op, frame), n in rec.flops_by_site.items()]
    return {"at_peak_bytes": sum(e["bytes"] for e in live.values()),
            "flops_by_site": sorted(sites, key=lambda e: -e["flops"]),
            "live_at_peak": sorted(live.values(),
                                   key=lambda e: -e["bytes"])[:TRACE_TOP],
            "collective_frames": sorted(
                colls.values(), key=lambda e: -e["operand_bytes"])[:TRACE_TOP]}


def measure(step, cur_index: int = 0, trace: bool = False) -> dict:
    """Run ``step.fn`` once on fake arguments; the per-rank counts (with
    ``trace``, also ``_traced``'s lists under "trace")."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    fake_mode = FakeTensorMode(allow_non_fake_inputs=True)
    args = list(fake_arguments(step, fake_mode))
    if step.kind in ("train", "decode"):       # step / cur_index: an int
        args[-1] = cur_index
    rec = _Recorder(fake_mode, trace)
    rec.held(args)
    t0 = time.time()
    with _dtensor_internals_unrecorded(rec), fake_mode, rec:
        out = step.fn(*args)
    arg_bytes = _local_bytes(args)
    by_kind, by_shape = {}, {}
    for op in rec.collectives:
        e = by_kind.setdefault(op["kind"], {"count": 0, "operand_bytes": 0,
                                            "wire_bytes": 0})
        key = (op["kind"], tuple(op["shape"]), op["dtype"], op["group"])
        f = by_shape.setdefault(key, {"kind": op["kind"],
                                      "shape": op["shape"],
                                      "dtype": op["dtype"],
                                      "group": op["group"], "count": 0,
                                      "operand_bytes": 0})
        for agg in (e, f):
            agg["count"] += 1
            agg["operand_bytes"] += op["operand_bytes"]
        e["wire_bytes"] += op["wire_bytes"]
    coll_bytes = sum(op["operand_bytes"] for op in rec.collectives)
    wire_bytes = sum(op["wire_bytes"] for op in rec.collectives)
    return {
        "mode": step.rules.get("_mode"),
        # context mode's K/V (or cache) stay split over the sequence: each
        # rank's partial softmax, merged once by lse, as the reference's
        "context_attention": ("segmented" if step.rules.get("_mode")
                              == "context" else None),
        "devices": int(step.mesh.size()),
        "run_s": round(time.time() - t0, 2),
        "memory": {
            "argument_bytes": arg_bytes,
            "output_bytes": _local_bytes(out),
            "temp_bytes": None,
            "peak_per_device": arg_bytes + rec.peak,
        },
        "cost": {"flops": rec.flops, "bytes_accessed": None,
                 "transcendentals": None,
                 "flops_note": FLOPS_NOTE},
        "looped": {"flops": rec.flops,
                   "coll_operand_bytes": coll_bytes,
                   "coll_wire_bytes": wire_bytes,
                   "coll_count": len(rec.collectives)},
        "collectives": by_kind,
        "collective_operand_bytes": coll_bytes,
        "collective_wire_bytes": wire_bytes,
        # the collectives of one (kind, operand shape, dtype, group size)
        # with the most operand bytes, largest first
        "top_collectives": sorted(by_shape.values(),
                                  key=lambda e: -e["operand_bytes"])[:TOP],
        "hlo_bytes": None,
        "unmeasured": UNMEASURED,
        "counts_from": "fake process group on the CPU, not a device",
        **({"trace": _traced(rec)} if trace else {}),
    }


def run_cell(arch: str, shape_name: str, mesh_kind: str, chunk: int = 1024,
             trace: bool = False):
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    if not shape_applicable(cfg, shape):
        return {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
                "status": "skipped",
                "reason": "long_500k requires sub-quadratic attention "
                          "(pure full-attention arch; DESIGN.md §4)"}
    multi = mesh_kind == "multi"
    with fake_group(512 if multi else 256):
        mesh = make_production_mesh(multi_pod=multi, device_type="cpu")
        t0 = time.time()
        step = build_sharded_step(cfg, mesh, shape, chunk=chunk)
        t_build = time.time() - t0
        # decode writes its token at the last slot of the shape's cache
        res = measure(step, cur_index=decode_cache_len(cfg, shape)[0] - 1,
                      trace=trace)
    return {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
            "status": "ok", "build_s": round(t_build, 2), **res}


def _run_and_write(arch, shape, meshk, out_dir, chunk, trace=False):
    tag = f"{arch}__{shape}__{meshk}"
    try:
        res = run_cell(arch, shape, meshk, chunk=chunk, trace=trace)
    except Exception as e:  # noqa: BLE001 - report, don't crash the sweep
        res = {"arch": arch, "shape": shape, "mesh": meshk,
               "status": "error", "error": f"{type(e).__name__}: {e}",
               "traceback": traceback.format_exc()[-4000:]}
    with open(os.path.join(out_dir, tag + ".json"), "w") as f:
        json.dump(res, f, indent=1)
    extra = ""
    if res["status"] == "ok":
        extra = (f" peak/dev={res['memory']['peak_per_device']/2**30:.2f}GiB"
                 f" flops={res['cost']['flops']:.3e}"
                 f" coll={res['collective_operand_bytes']/2**20:.1f}MiB"
                 f" wire={res['collective_wire_bytes']/2**20:.1f}MiB"
                 f" run={res['run_s']}s")
    print(f"[dryrun] {tag}: {res['status']}{extra}", flush=True)
    return res["status"] != "error"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, choices=list(ARCH_NAMES))
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--mesh", default=None, choices=["single", "multi"],
                    help="default single; with --all, both unless given")
    ap.add_argument("--out", default="experiments/dryrun")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--chunk", type=int, default=1024)
    ap.add_argument("--trace", action="store_true",
                    help="also record the storages live at the peak and "
                         "the frames of the large collectives")
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    if not args.all:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape or --all")
        ok = _run_and_write(args.arch, args.shape, args.mesh or "single",
                            args.out, args.chunk, args.trace)
        return 0 if ok else 1
    ok = True
    for a in ARCH_NAMES:        # one process per cell
        for s in SHAPES:
            for m in ((args.mesh,) if args.mesh else ("single", "multi")):
                r = subprocess.run(
                    [sys.executable, "-m", "repro_torch.launch.dryrun",
                     "--arch", a, "--shape", s, "--mesh", m, "--out",
                     args.out, "--chunk", str(args.chunk)]
                    + (["--trace"] if args.trace else []))
                ok &= r.returncode == 0
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
