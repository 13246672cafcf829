"""Roofline of every (arch x shape) on the (32, 8) H100 mesh.

Per rank, from one dry-run step (``repro_torch.launch.dryrun``):

    compute_s    = FLOPs per rank / 989e12                 (H100 SXM, dense bf16)
    memory_s     = bytes per rank / 3.35e12                 (HBM3)
    collective_s = model-axis bytes / 450e9                 (NVLink 4, per direction)
                 + data/pod-axis bytes / 50e9               (one 400 Gb/s NDR port)

The constants are the H100 SXM's spec-sheet values
(``repro_torch.launch.mesh``), not measurements. The FLOPs are
``FlopCounterMode``'s formulas over the local aten ops each rank runs, the
bytes each op's inputs and outputs (eager PyTorch runs every op as its own
kernel: this is the port's traffic model, where the reference read XLA's
fused count), the collective bytes those the step's redistributions
produce on the rank. The reference's TPU v5e had one interconnect; an H100
cluster has two tiers, and the model axis stays inside one host's NVLink.

Port of the JAX package's ``repro.launch.roofline``: ``depth_variant``,
``_depths``, ``model_flops`` and ``model_bytes_floor`` unchanged. Each
pair runs at TWO shallow depths L1 < L2 (same group pattern) and each
count is fitted linearly in depth and extrapolated to the full depth: the
step is linear in depth, and the fit bounds the host time of a 110B dry
run. Floors: ``max(measured, analytic / 256)``, as in the reference.

    PYTHONPATH=src python -m repro_torch.launch.roofline --all
    PYTHONPATH=src python -m repro_torch.launch.roofline --arch qwen3-8b --shape train_4k

Artifacts go under ``build/launch/roofline/``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

from repro_torch.configs import get_config, list_archs
from repro_torch.launch import dryrun
from repro_torch.launch import specs as specs_lib
from repro_torch.launch.mesh import DATA_AXES, HBM_BW, MODEL_AXIS, NET_BW, NVLINK_BW, PEAK_FLOPS_BF16
from repro_torch.models import model as model_lib
from repro_torch.models.config import ModelConfig

CHIPS = 256  # the single-pod roofline mesh, (32, 8)
OUT = str(dryrun.OUT_ROOT / "roofline")
KEYS = ("flops", "bytes", "coll_model", "coll_net")


def depth_variant(cfg: ModelConfig, n_layers: int) -> ModelConfig:
    """Shallow variant preserving the group pattern."""
    kw: dict = {"n_layers": n_layers, "scan_layers": False}
    if cfg.is_moe and cfg.first_k_dense:
        kw["first_k_dense"] = min(cfg.first_k_dense, max(1, n_layers - 1))
    return dataclasses.replace(cfg, **kw)


def _depths(cfg: ModelConfig) -> tuple[int, int]:
    if cfg.shared_attn_every > 0:
        e = cfg.shared_attn_every
        return e, 2 * e  # 1 vs 2 shared invocations
    if cfg.is_moe and cfg.first_k_dense:
        return 2, 4
    return 1, 3


def step_counts(cfg: ModelConfig, plan: specs_lib.ShapePlan, mesh, *, fsdp_on: bool = True,
                synapse_token_shard: bool = True, act_mode: str = "auto") -> dict:
    """One rank's FLOPs, bytes and collective bytes (model axis, data and
    pod axes) for one step of ``plan`` on ``mesh`` (a fake production
    mesh; None: one device, plain meta tensors, the same local ops a mesh
    of (1, 1) runs)."""
    fn, args, _ = dryrun.build_lowerable(cfg.name, plan.shape, mesh, cfg=cfg,
                                         fsdp_on=fsdp_on, synapse_token_shard=synapse_token_shard,
                                         act_mode=act_mode, plan=plan)
    try:
        rec = dryrun.measure(fn, args, mesh, train=plan.kind == "train")
    finally:
        model_lib.set_activation_sharding(None)
    axis = rec["collectives"]["per_axis"]
    return {"flops": float(rec["flops"]), "bytes": float(rec["bytes"]),
            "coll_model": float(axis.get(MODEL_AXIS, 0)),
            "coll_net": float(sum(b for a, b in axis.items() if a in DATA_AXES))}


def times(per: dict) -> dict:
    """The three roofline terms (seconds) of per-rank counts, and the dominant one."""
    t = {"compute_s": per["flops"] / PEAK_FLOPS_BF16, "memory_s": per["bytes"] / HBM_BW,
         "collective_s": per["coll_model"] / NVLINK_BW + per["coll_net"] / NET_BW}
    t["dominant"] = max(("compute", t["compute_s"]), ("memory", t["memory_s"]),
                        ("collective", t["collective_s"]), key=lambda kv: kv[1])[0]
    return t


def model_flops(cfg: ModelConfig, plan: specs_lib.ShapePlan) -> float:
    """Analytic MODEL_FLOPS (global, forward only unless train)."""
    n_active = cfg.active_param_count()
    if plan.kind == "train":
        tokens = plan.seq * plan.batch
        base = 6.0 * n_active * tokens  # fwd+bwd
        attn = 0.0
        if cfg.block_kind == "attn":
            attn = 3 * 2 * 2 * cfg.n_layers * plan.batch * plan.seq**2 * cfg.n_heads * cfg.d_head * 0.5
        return base + attn
    if plan.kind == "prefill":
        tokens = plan.seq * plan.batch
        base = 2.0 * n_active * tokens
        attn = 0.0
        if cfg.block_kind == "attn":
            attn = 2 * 2 * cfg.n_layers * plan.batch * plan.seq**2 * cfg.n_heads * cfg.d_head * 0.5
        return base + attn
    # decode: one token per lane
    base = 2.0 * n_active * plan.batch
    attn = 0.0
    if cfg.block_kind == "attn" and plan.cache_kind == "full":
        attn = 2 * 2 * cfg.n_layers * plan.batch * plan.seq * cfg.n_heads * cfg.d_head
    elif cfg.block_kind == "attn" and plan.cache_kind == "synapse":
        T = specs_lib.LONG_LANDMARKS + specs_lib.LONG_WINDOW + specs_lib.LONG_INJECT
        attn = 2 * 2 * cfg.n_layers * plan.batch * T * cfg.n_heads * cfg.d_head
    return base + attn


def model_bytes_floor(cfg: ModelConfig, plan: specs_lib.ShapePlan) -> float:
    """Global HBM-traffic lower bound per step: every weight byte is read
    once (bf16 compute copies), plus full KV/state cache read+write for
    decode, plus one read+write of the token activations per layer."""
    wbytes = cfg.param_count() * 2  # bf16 compute copies
    if plan.kind == "train":
        wbytes = cfg.param_count() * (2 + 2 + 4 * 3)  # fwd+bwd reads + grad + adam m,v,p f32
    tokens = plan.seq * plan.batch if plan.kind != "decode" else plan.batch
    act = 2 * cfg.n_layers * tokens * cfg.d_model * 2  # stream in+out per layer, bf16
    cache = 0.0
    if plan.kind == "decode":
        cache = dryrun.local_bytes(specs_lib.abstract_caches(cfg, plan)[0])
    return float(wbytes + act + cache)


def fitted_counts(cfg_full: ModelConfig, plan: specs_lib.ShapePlan, mesh, **kw) -> tuple[dict, list]:
    """Per-rank counts at the full depth, fitted from the two shallow
    depths of :func:`_depths`: (counts, [L1, L2])."""
    L1, L2 = _depths(cfg_full)
    costs = [step_counts(depth_variant(cfg_full, L), plan, mesh, **kw) for L in (L1, L2)]
    per = {}
    for key in KEYS:
        b = (costs[1][key] - costs[0][key]) / (L2 - L1)
        a = costs[0][key] - b * L1
        per[key] = max(a + b * cfg_full.n_layers, 0.0)
    return per, [L1, L2]


def analyze_pair(arch: str, shape_name: str, out_dir: str, *, cfg_transform=None, fsdp_on: bool = True,
                 synapse_token_shard: bool = True, act_mode: str = "auto", variant: str = "baseline") -> dict:
    cfg_full = get_config(arch)
    if cfg_transform is not None:
        cfg_full = cfg_transform(cfg_full)
    plan = specs_lib.plan_for(cfg_full, shape_name)
    rec = {"arch": arch, "shape": shape_name, "mesh": "32x8", "variant": variant}
    if plan.skip:
        rec.update(status="SKIP", reason=plan.skip)
        return rec
    mesh = dryrun.fake_mesh(False)
    t0 = time.time()
    per, depths = fitted_counts(cfg_full, plan, mesh, fsdp_on=fsdp_on,
                                synapse_token_shard=synapse_token_shard, act_mode=act_mode)
    # analytic floors: MODEL_FLOPS and a params+cache byte floor
    floor_flops = model_flops(cfg_full, plan) / CHIPS
    floor_bytes = model_bytes_floor(cfg_full, plan) / CHIPS
    measured = dict(per)
    per["flops"] = max(per["flops"], floor_flops)
    per["bytes"] = max(per["bytes"], floor_bytes)
    t = times(per)
    mf_per_chip = model_flops(cfg_full, plan) / CHIPS
    useful = mf_per_chip / per["flops"] if per["flops"] else 0.0
    rec.update(status="OK", kind=plan.kind, cache_kind=plan.cache_kind, depths=depths, per_chip=per,
               measured_per_chip=measured, floors={"flops": floor_flops, "bytes": floor_bytes}, **t,
               model_flops_per_chip=mf_per_chip, useful_flops_ratio=useful, wall_s=round(time.time() - t0, 1))
    os.makedirs(out_dir, exist_ok=True)
    suffix = "" if variant == "baseline" else f"__{variant}"
    with open(os.path.join(out_dir, f"{arch}__{shape_name}{suffix}.json"), "w") as f:
        json.dump(rec, f, indent=1)
    print(f"[roofline] {variant:16s} {arch:20s} {shape_name:12s} C {t['compute_s'] * 1e3:9.3f}ms  "
          f"M {t['memory_s'] * 1e3:9.3f}ms  X {t['collective_s'] * 1e3:9.3f}ms  dom={t['dominant']:10s} "
          f"useful={useful:5.2f}")
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args(argv)
    archs = [args.arch] if args.arch else [a for a in list_archs() if a != "qwen2.5-0.5b"]
    shapes = [args.shape] if args.shape else list(specs_lib.SHAPES)
    recs = []
    for a in archs:
        for s in shapes:
            try:
                recs.append(analyze_pair(a, s, args.out))
            except Exception as e:  # recorded; the census goes on
                print(f"[roofline] {a} x {s}: FAIL {type(e).__name__}: {e}")
                recs.append({"arch": a, "shape": s, "status": "FAIL", "error": str(e)})
    print(f"[roofline] {sum(r['status'] == 'OK' for r in recs)} OK / {len(recs)}")
    return recs


if __name__ == "__main__":
    main()
