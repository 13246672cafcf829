"""Render the dry-run and roofline tables (markdown) from the JSON
artifacts that ``repro_torch.launch.dryrun`` and
``repro_torch.launch.roofline`` write under ``build/launch/``.

    PYTHONPATH=src python -m repro_torch.launch.report > build/launch/report.md

Port of the JAX package's ``repro.launch.report``. The headings name the
H100 meshes and the spec-sheet constants of ``repro_torch.launch.mesh``.
"""
from __future__ import annotations

import glob
import json
import os

from repro_torch.launch.dryrun import OUT_ROOT
from repro_torch.launch.mesh import DATA_AXES, HBM_BW, HBM_BYTES, NET_BW, NVLINK_BW, PEAK_FLOPS_BF16

DRYRUN_DIR = str(OUT_ROOT / "dryrun")
ROOFLINE_DIR = str(OUT_ROOT / "roofline")
SHAPE_ORDER = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]
_DOM = {"compute": "C", "memory": "M", "collective": "X"}
MESHES = {"32x8": 256, "2x32x8": 512}


def _load(dirname):
    """Every JSON record under ``dirname``."""
    recs = []
    for path in sorted(glob.glob(os.path.join(dirname, "*.json"))):
        with open(path) as f:
            recs.append(json.load(f))
    return recs


def _key(r):
    return r["arch"], SHAPE_ORDER.index(r["shape"])


def _fix_hint(rec) -> str:
    dom, kind = rec["dominant"], rec["kind"]
    if dom == "collective":
        if kind == "train":
            return "overlap FSDP all-gathers with layer compute / shrink seq-parallel gathers"
        return "replicate weights over data axis (kill per-step FSDP gathers) or widen TP"
    if dom == "memory":
        if kind == "decode":
            return "cache is the traffic: shrink KV (synapse/MLA) or widen batch to amortize weights"
        return "bigger per-rank batch or fuse ops to cut re-read traffic"
    return "compute-bound: at roofline; gains only from sparsity/quantization"


def _gb(b) -> str:
    return f"{b / 1e9:.2f}"


def dryrun_tables(dirname: str = DRYRUN_DIR) -> str:
    recs = [r for r in _load(dirname) if "shape" in r]
    out = ["### Dry run (one step on meta DTensors over a fake group)\n"]
    for mesh, ranks in MESHES.items():
        rows = [r for r in recs if r.get("mesh") == mesh]
        if not rows:
            continue
        count = {s: sum(r["status"] == s for r in rows) for s in ("OK", "SKIP", "FAIL")}
        out.append(f"\n**Mesh {mesh} ({ranks} H100s, {mesh.split('x')[-1]} per host)**: {count['OK']} OK, "
                   f"{count['SKIP']} SKIP, {count['FAIL']} FAIL. Per rank; **bold**: over the card's "
                   f"{HBM_BYTES / 1e9:.0f} GB.\n")
        out.append("| arch | shape | status | kind | cache | args/rank GB | saved/rank GB | model-axis coll GB "
                   "| data-axes coll GB | host s |")
        out.append("|---|---|---|---|---|---|---|---|---|---|")
        for r in sorted(rows, key=_key):
            if r["status"] != "OK":
                why = r.get("reason") or r.get("error", "")
                out.append(f"| {r['arch']} | {r['shape']} | {r['status']} {why[:60]} | | | | | | | |")
                continue
            mem, axis = r["memory"], r["collectives"]["per_axis"]
            args, saved = mem["argument_bytes"], mem.get("saved_bytes", 0)
            mark = lambda b, s: f"**{s}**" if b > HBM_BYTES else s
            net = sum(b for a, b in axis.items() if a in DATA_AXES)
            out.append(f"| {r['arch']} | {r['shape']} | OK | {r['kind']} | {r.get('cache_kind', '')} "
                       f"| {mark(args, _gb(args))} | {mark(args + saved, _gb(saved))} | {_gb(axis.get('model', 0))} "
                       f"| {_gb(net)} | {r.get('step_s', 0):.1f} |")
    return "\n".join(out)


def roofline_table(dirname: str = ROOFLINE_DIR) -> str:
    recs = [r for r in _load(dirname) if r.get("status") == "OK"]
    out = [
        f"### Roofline (32x8 mesh, 256 H100 SXM; spec sheet: {PEAK_FLOPS_BF16 / 1e12:.0f} TF/s bf16, "
        f"{HBM_BW / 1e12:.2f} TB/s HBM, NVLink {NVLINK_BW / 1e9:.0f} GB/s on the model axis, "
        f"{NET_BW / 1e9:.0f} GB/s network on the data axes)\n",
        "| arch | shape | compute ms | memory ms | collective ms | dominant | useful FLOPs ratio "
        "| what would move the dominant term |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for r in sorted(recs, key=_key):
        out.append(f"| {r['arch']} | {r['shape']} | {r['compute_s'] * 1e3:.1f} | {r['memory_s'] * 1e3:.1f} "
                   f"| {r['collective_s'] * 1e3:.1f} | **{r['dominant']}** | {r['useful_flops_ratio']:.2f} "
                   f"| {_fix_hint(r)} |")
    doms: dict = {}
    for r in recs:
        doms[r["dominant"]] = doms.get(r["dominant"], 0) + 1
    out.append(f"\nDominant-term census: {doms}\n")
    return "\n".join(out)


def summary_table(dry_dir: str = DRYRUN_DIR, roof_dir: str = ROOFLINE_DIR) -> str:
    """One row per arch, one cell per shape, of the (32, 8) mesh: the dry
    run's argument + saved GB per rank, then the roofline's compute /
    memory / collective ms and the dominant term (C, M or X)."""
    dry = {(r["arch"], r["shape"]): r for r in _load(dry_dir) if r.get("mesh") == "32x8"}
    roof = {(r["arch"], r["shape"]): r for r in _load(roof_dir) if r.get("status") == "OK"}
    out = ["| arch | " + " | ".join(SHAPE_ORDER) + " |", "|---|" + "---|" * len(SHAPE_ORDER)]
    for arch in sorted({a for a, _ in dry}):
        cells = []
        for shape in SHAPE_ORDER:
            r, t = dry.get((arch, shape)), roof.get((arch, shape))
            if r is None or r["status"] != "OK":
                cells.append(r["status"] if r else "")
                continue
            args, saved = r["memory"]["argument_bytes"], r["memory"].get("saved_bytes", 0)
            cell = f"{_gb(args)} + {_gb(saved)}"
            cell = f"**{cell}**" if args + saved > HBM_BYTES else cell
            if t is not None:
                cell += (f" · {t['compute_s'] * 1e3:.1f} / {t['memory_s'] * 1e3:.1f} / "
                         f"{t['collective_s'] * 1e3:.1f} ({_DOM[t['dominant']]})")
            cells.append(cell)
        out.append(f"| {arch} | " + " | ".join(cells) + " |")
    return "\n".join(out)


def main():
    print(summary_table())
    print()
    print(dryrun_tables())
    print()
    print(roofline_table())


if __name__ == "__main__":
    main()
