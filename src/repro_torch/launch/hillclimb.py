"""Hillclimb runner: named variants of the chosen pairs, each re-run and
re-analysed by the roofline on the (32, 8) H100 mesh; results land in
``build/launch/hillclimb/``.

Port of the JAX package's ``repro.launch.hillclimb``, the same campaigns
and variants over the port's config fields (``moe_dispatch``,
``param_dtype``, ``remat_policy``) and the roofline's ``fsdp_on``,
``synapse_token_shard`` and ``act_mode`` flags:

  * qwen3-moe-30b-a3b x train_4k: the MoE dispatch;
  * qwen1.5-110b x train_4k: f32 master weights gathered over the data axes;
  * qwen3-8b x long_500k: the paper's technique (synapse decode), where
    per-token FSDP weight gathers dwarf the small synapse cache traffic;
  * qwen3-8b x decode_32k: a cheap sanity campaign.

    PYTHONPATH=src python -m repro_torch.launch.hillclimb --pair moe|dense110|synapse|decode32
"""
from __future__ import annotations

import argparse
import dataclasses

from repro_torch.launch.dryrun import OUT_ROOT
from repro_torch.launch.roofline import analyze_pair

OUT = str(OUT_ROOT / "hillclimb")


def _cfgmod(**kw):
    return lambda cfg: dataclasses.replace(cfg, **kw)


# pair -> (arch, shape, [(variant, cfg_transform, fsdp_on[, synapse_token_shard[, act_mode]])])
CAMPAIGNS = {
    "moe": (
        "qwen3-moe-30b-a3b",
        "train_4k",
        [
            ("baseline_global_dispatch", _cfgmod(moe_dispatch="global"), True),
            ("per_lane_dispatch", _cfgmod(moe_dispatch="per_lane"), True),
            ("per_lane+bf16_params", _cfgmod(moe_dispatch="per_lane", param_dtype="bfloat16"), True),
            ("per_lane+bf16+dots", _cfgmod(moe_dispatch="per_lane", param_dtype="bfloat16", remat_policy="dots"),
             True),
            ("per_lane+act_batch", _cfgmod(moe_dispatch="per_lane"), True, True, "batch"),
            ("per_lane+ep_pin+act_batch", _cfgmod(moe_dispatch="per_lane"), True, True, "batch"),
            ("global+act_batch", _cfgmod(moe_dispatch="global"), True, True, "batch"),
        ],
    ),
    "dense110": (
        "qwen1.5-110b",
        "train_4k",
        [
            ("baseline_f32_master", None, True),
            ("bf16_params", _cfgmod(param_dtype="bfloat16"), True),
            ("bf16+remat_dots", _cfgmod(param_dtype="bfloat16", remat_policy="dots"), True),
            ("act_batch_only", None, True, True, "batch"),
        ],
    ),
    "synapse": (
        "qwen3-8b",
        "long_500k",
        [
            ("baseline_fsdp_weights", None, True, True),
            ("tp_weights", None, False, True),
            ("tp_weights+bf16", _cfgmod(param_dtype="bfloat16"), False, True),
            ("replicated_synapse", None, True, False),
            ("replicated_synapse+tp+bf16", _cfgmod(param_dtype="bfloat16"), False, False),
            ("flashdecode_shardmap", None, True, True),
            ("flashdecode+bf16", _cfgmod(param_dtype="bfloat16"), True, True),
        ],
    ),
    "decode32": (
        "qwen3-8b",
        "decode_32k",
        [
            ("baseline_fsdp_weights", None, True),
            ("tp_weights", None, False),
        ],
    ),
}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--pair", required=True, choices=list(CAMPAIGNS))
    ap.add_argument("--variant", default=None)
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args(argv)
    arch, shape, variants = CAMPAIGNS[args.pair]
    recs = []
    for v in variants:
        name, transform, fsdp_on = v[0], v[1], v[2]
        syn_shard = v[3] if len(v) > 3 else True
        act_mode = v[4] if len(v) > 4 else "auto"
        if args.variant and name != args.variant:
            continue
        recs.append(analyze_pair(arch, shape, args.out, cfg_transform=transform, fsdp_on=fsdp_on,
                                 synapse_token_shard=syn_shard, act_mode=act_mode, variant=name))
    return recs


if __name__ == "__main__":
    main()
