"""Set the port's dry run beside the JAX package's, cell by cell.

    # the two sweeps (one record a cell in each directory)
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh single \\
        --trace --out experiments/dryrun_port
    PYTHONPATH=src JAX_PLATFORMS=cpu python -m repro.launch.dryrun --all \\
        --out experiments/dryrun_ref
    # one markdown table of both
    python tools/dryrun_compare.py table experiments/dryrun_port \\
        experiments/dryrun_ref [--mesh single]
    # the reference's looped flops of one cell by HLO dot, grouped by pass
    # (forward, backward, recompute) and the einsum that made it
    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/dryrun_compare.py \\
        ref-flops mamba2-130m train_4k
    # the port's flops of one traced record by op and call site
    python tools/dryrun_compare.py port-flops \\
        experiments/dryrun_port/mamba2-130m__train_4k__single.json

``table`` and ``port-flops`` read JSON only; ``ref-flops`` imports the JAX
package (and its HLO parser, ``repro.launch.hloparse``), so it needs JAX.
Both dry runs count on the CPU: rank 0's share of a fake group (the port)
or XLA's per-device program on forced host devices (the reference), not
device measurements.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import re
import sys

GiB = 2**30


def _load(d, mesh):
    out = {}
    for f in glob.glob(os.path.join(d, f"*__{mesh}.json")):
        with open(f) as fh:
            r = json.load(fh)
        out[(r["arch"], r["shape"])] = r
    return out


def _ratio(a, b):
    return "n/a" if not b else f"{a / b:.2f}"


def table(port_dir, ref_dir, mesh="single"):
    """Markdown rows: collective operand GiB / count, wire GiB, peak GiB,
    looped flops and host seconds of both packages, and the port's ratios
    to the reference's for peak and collective bytes."""
    port, ref = _load(port_dir, mesh), _load(ref_dir, mesh)
    rows = ["| Cell | Port coll. GiB / n | Ref. coll. GiB / n | Port wire "
            "| Ref. wire | Port peak | Ref. peak | Peak × | Coll. × | Port "
            "flops | Ref. flops | Flops × | Port s | Ref. s |",
            "| --- " * 15 + "|"]
    for key in sorted(set(port) | set(ref)):
        p, r = port.get(key), ref.get(key)
        name = f"{key[0]} {key[1]}"
        ps, rs = (p or {}).get("status"), (r or {}).get("status")
        if ps != "ok" or rs != "ok":
            rows.append(f"| {name} | {ps} | {rs} |" + " |" * 12)
            continue
        pc, rc = p["looped"], r["looped"]
        pp = p["memory"]["peak_per_device"]
        rp = r["memory"]["peak_per_device"]
        rows.append(
            f"| {name} | {pc['coll_operand_bytes']/GiB:.4g} / "
            f"{pc['coll_count']} | {rc['coll_operand_bytes']/GiB:.4g} / "
            f"{int(rc['coll_count'])} | {pc['coll_wire_bytes']/GiB:.4g} | "
            f"{rc['coll_wire_bytes']/GiB:.4g} | {pp/GiB:.2f} | "
            f"{rp/GiB:.2f} | {pp/rp:.2f} | "
            f"{_ratio(pc['coll_operand_bytes'], rc['coll_operand_bytes'])} | "
            f"{pc['flops']:.4g} | {rc['flops']:.4g} | "
            f"{_ratio(pc['flops'], rc['flops'])} | "
            f"{p['run_s'] + p.get('build_s', 0):.1f} | "
            f"{r['lower_s'] + r['compile_s']:.1f} |")
    return "\n".join(rows)


def port_flops(path, top=25):
    """A traced port record's flops by (op, call site), most first."""
    with open(path) as fh:
        r = json.load(fh)
    sites = r["trace"]["flops_by_site"]
    total = r["cost"]["flops"]
    lines = [f"total {total:.4g}"]
    for e in sites[:top]:
        lines.append(f"{e['flops']:.4g} {100 * e['flops'] / total:5.1f}% "
                     f"{e['op']} {e['frame']}")
    return "\n".join(lines)


# ------------------------------------------------ the reference's HLO flops

_META = re.compile(r'op_name="([^"]*)"')


def _pass_of(op_name: str) -> str:
    if "rematted_computation" in op_name:
        return "recompute"
    if "transpose(" in op_name:
        return "backward"
    return "forward"


def _label(op_name: str) -> str:
    """The op's own name: the einsum or function before ``/dot_general``."""
    parts = [p for p in op_name.split("/") if p != "dot_general"]
    return parts[-1] if parts else "?"


def ref_flops(arch, shape_name, mesh_kind="single", top=25):
    """The reference's looped flops of one cell by dot instruction,
    multiplied through the loop nest exactly as ``hloparse.analyze`` does,
    grouped by (pass, the op's einsum): the pass is "recompute" inside a
    rematted computation, "backward" inside a transpose, else
    "forward"."""
    from repro.launch import dryrun as _dr   # sets the forced device count
    from repro.configs import SHAPES, get_config
    from repro.distributed.steps import build_sharded_step
    from repro.launch import hloparse as hp
    from repro.launch.mesh import make_production_mesh
    del _dr
    cfg = get_config(arch)
    mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"))
    step = build_sharded_step(cfg, mesh, SHAPES[shape_name])
    hlo = step.jitted.lower(*step.abstract).compile().as_text()
    comps = hp.parse_computations(hlo)
    entry = comps.pop("__entry_name__")
    comps.pop("__entry__", None)
    groups, by_pass = {}, {}

    def dot_flops(i, table):
        out = sum(_prod(d) for _, d in hp._shape_list(i.type_str))
        k = 1
        ctr = hp.CONTRACT_RE.search(i.rest)
        ops = hp.OPERAND_RE.findall(i.rest.split(")", 1)[0])
        if ctr and ops and ops[0] in table:
            shp = hp._shape_list(table[ops[0]])
            if shp:
                for ci in ctr.group(1).split(","):
                    if ci and int(ci) < len(shp[0][1]):
                        k *= shp[0][1][int(ci)]
        return 2.0 * out * k

    def visit(name, mult, depth=0):
        if name not in comps or depth > 50:
            return
        instrs = comps[name]
        table_ = {i.name: i.type_str for i in instrs}
        whiles = {}
        for i in instrs:
            if i.op == "dot":
                f = dot_flops(i, table_) * mult
                m = _META.search(i.rest)
                op_name = m.group(1) if m else ""
                key = (_pass_of(op_name), _label(op_name))
                groups[key] = groups.get(key, 0.0) + f
                by_pass[key[0]] = by_pass.get(key[0], 0.0) + f
            for attr in ("to_apply", "calls"):
                for cm in re.finditer(attr + r"=%?([\w.-]+)", i.rest):
                    visit(cm.group(1), mult, depth + 1)
            bm = re.search(r"body=%?([\w.-]+)", i.rest)
            cm_ = re.search(r"condition=%?([\w.-]+)", i.rest)
            if bm:
                whiles[i.name] = (bm.group(1), cm_.group(1) if cm_ else None)
            brm = hp.BRANCH_RE.search(i.rest)
            if brm:
                for b in brm.group(1).split(","):
                    visit(b.strip().lstrip("%"), mult, depth + 1)
        for body, cond in whiles.values():
            trips = hp._trip_count(comps[cond]) if cond in comps else 1
            visit(body, mult * trips, depth + 1)

    visit(entry, 1.0)
    total = sum(groups.values())
    lines = [f"total {total:.4g} (hloparse.analyze: "
             f"{hp.analyze(hlo)['flops']:.4g})"]
    for k, v in sorted(by_pass.items(), key=lambda kv: -kv[1]):
        lines.append(f"pass {k}: {v:.4g} ({100 * v / total:.1f}%)")
    for (ps, src), v in sorted(groups.items(), key=lambda kv: -kv[1])[:top]:
        lines.append(f"{v:.4g} {100 * v / total:5.1f}% {ps} {src}")
    return "\n".join(lines)


def _prod(dims):
    n = 1
    for d in dims:
        n *= d
    return n


def main(argv=None):
    ap = argparse.ArgumentParser()
    sub = ap.add_subparsers(dest="cmd", required=True)
    t = sub.add_parser("table")
    t.add_argument("port_dir")
    t.add_argument("ref_dir")
    t.add_argument("--mesh", default="single")
    r = sub.add_parser("ref-flops")
    r.add_argument("arch")
    r.add_argument("shape")
    r.add_argument("--mesh", default="single")
    p = sub.add_parser("port-flops")
    p.add_argument("record")
    args = ap.parse_args(argv)
    if args.cmd == "table":
        print(table(args.port_dir, args.ref_dir, args.mesh))
    elif args.cmd == "ref-flops":
        print(ref_flops(args.arch, args.shape, args.mesh))
    else:
        print(port_flops(args.record))
    return 0


if __name__ == "__main__":
    sys.exit(main())
