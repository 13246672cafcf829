"""The port's dry run, roofline counts and registry accounting on the CPU.

The dry run runs in a subprocess (rank 0 of a fake group of 256 ranks, the
(32, 8) production mesh; the process imports no JAX) on one reduced config
per shape kind: train, prefill, decode over a full cache, decode over the
synapse cache (Qwen2.5-0.5B reduced, in bf16 as the full config computes),
plus the encoder's decode shapes, which skip. Held to:

* every combo ``OK`` but the skips, and each skip the reference's
  (``repro.launch.specs.plan_for``, with its reason);
* the argument bytes per rank equal the sum, over every argument, of the
  shard each rank holds under the specs (shape over the mesh axes each dim
  names), worked out here from the specs alone;
* the train step records the bytes saved for backward, every step its
  FLOPs and op bytes, and collectives named by their mesh axis (both
  axes in the train step);
* the roofline's two-depth fit of the FLOPs equals the FLOP count of the
  full-depth step (within 1e-9 relative: the step is linear in depth);
* ``run_registry``'s ``per_agent_snapshot_bytes`` and ``weight_bytes``
  equal the reference's exactly for Qwen2.5-0.5B;
* ``model_flops`` and ``model_bytes_floor`` equal the reference's for
  every arch x shape.
"""
import importlib
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import pytest

from repro import configs as jconfigs
from repro.launch import specs as jspecs
from repro_torch.configs import get_config, list_archs
from repro_torch.launch import roofline
from repro_torch.launch import specs as specs_lib

ROOT = Path(__file__).resolve().parents[1]
COMBOS = [("qwen2.5-0.5b", "train_4k"), ("qwen2.5-0.5b", "prefill_32k"), ("qwen2.5-0.5b", "decode_32k"),
          ("qwen2.5-0.5b", "long_500k"), ("hubert-xlarge", "decode_32k"), ("hubert-xlarge", "long_500k")]

SCRIPT = """
import dataclasses, json, math, sys
import torch
from repro_torch.configs import get_config
from repro_torch.launch import dryrun, roofline, sharding, specs
from repro_torch.models import model as model_lib
from repro_torch.training.trainer import abstract_train_state

def shard_bytes(tree, spec_tree, sizes):
    total = []
    def one(names, t):
        spec = sharding._lookup(spec_tree, names)
        n = t.element_size()
        for dim, axes in zip(t.shape, tuple(spec) + (None,) * t.dim()):
            axes = () if axes is None else ((axes,) if isinstance(axes, str) else axes)
            n *= dim // math.prod(sizes[a] for a in axes)
        total.append(n)
    sharding._map_with_names(one, tree)
    return sum(total)

out = []
for arch, shape in COMBOS:
    mesh = dryrun.fake_mesh(False)  # as run_one asks for it, once a combo
    sizes = sharding.axis_sizes(mesh)
    cfg = dataclasses.replace(get_config(arch, reduced=True), compute_dtype="bfloat16")
    plan = specs.plan_for(cfg, shape)
    rec = {"arch": arch, "shape": shape}
    if plan.skip:
        rec.update(status="SKIP", reason=plan.skip)
        out.append(rec)
        continue
    fn, args, _ = dryrun.build_lowerable(arch, shape, mesh, cfg=cfg)
    try:
        rec.update(dryrun.measure(fn, args, mesh, train=plan.kind == "train"), status="OK")
    finally:
        model_lib.set_activation_sharding(None)
    if plan.kind == "train":
        state = abstract_train_state(cfg)
        batch = specs.train_batch_specs(cfg, plan.seq, plan.batch)
        want = (shard_bytes(state, sharding.param_specs(state, cfg, sizes), sizes)
                + shard_bytes(batch, sharding.batch_specs(batch, cfg, sizes), sizes))
    else:
        params = model_lib.abstract_params(cfg)
        inputs, _ = specs.input_specs(cfg, plan)
        caches, _ = specs.abstract_caches(cfg, plan)
        want = (shard_bytes(params, sharding.param_specs(params, cfg, sizes), sizes)
                + shard_bytes(inputs, sharding.batch_specs(inputs, cfg, sizes), sizes)
                + shard_bytes(caches, sharding.cache_specs(caches, cfg, sizes), sizes))
    rec["spec_bytes"] = want
    out.append(rec)
# the roofline's fit against the full-depth count, one device
cfg = dataclasses.replace(get_config("qwen2.5-0.5b", reduced=True), compute_dtype="bfloat16", n_layers=4)
plan = dataclasses.replace(specs.plan_for(cfg, "train_4k"), seq=64, batch=2)
fit, depths = roofline.fitted_counts(cfg, plan, None)
full = roofline.step_counts(cfg, plan, None)
out.append({"fit": fit, "full": full, "depths": depths})
reg = dryrun.run_registry(10_000, arch="qwen2.5-0.5b", out_dir=None)
out.append({"registry": {k: reg[k] for k in ("per_agent_snapshot_bytes", "weight_bytes")}})
print("RESULT " + json.dumps(out))
"""


def _reference(module: str):
    """``repro.launch.<module>``, imported with ``XLA_FLAGS`` left as it was:
    the reference's dry-run modules force 512 host devices at import, for
    their own entry points (the backend here is already up)."""
    saved = os.environ.get("XLA_FLAGS")
    jax.devices()
    try:
        return importlib.import_module(f"repro.launch.{module}")
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved


@pytest.fixture(scope="module")
def result():
    code = f"COMBOS = {COMBOS!r}\n" + textwrap.dedent(SCRIPT)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    line = next(ln for ln in out.stdout.splitlines() if ln.startswith("RESULT "))
    recs = json.loads(line[len("RESULT "):])
    return recs[:len(COMBOS)], recs[len(COMBOS)], recs[len(COMBOS) + 1]["registry"]


def test_every_kind_runs_and_skips_as_the_reference(result):
    recs, _, _ = result
    for rec in recs:
        jplan = jspecs.plan_for(jconfigs.get_config(rec["arch"], reduced=True), rec["shape"])
        if jplan.skip:
            assert rec["status"] == "SKIP" and rec["reason"] == jplan.skip, rec
        else:
            assert rec["status"] == "OK", rec
    assert sum(r["status"] == "OK" for r in recs) == 4


def test_argument_bytes_are_the_shards_the_specs_give(result):
    recs, _, _ = result
    for rec in recs:
        if rec["status"] == "OK":
            assert rec["memory"]["argument_bytes"] == rec["spec_bytes"], rec["shape"]


def test_each_step_records_its_work(result):
    recs, _, _ = result
    ok = {r["shape"]: r for r in recs if r["status"] == "OK"}
    assert ok["train_4k"]["memory"]["saved_bytes"] > 0
    for rec in ok.values():
        assert rec["flops"] > 0 and rec["bytes"] > 0 and rec["n_ops"] > 0
        assert rec["collectives"]["total_bytes"] > 0
        # every collective named by its mesh axis, in every combo of the run
        assert set(rec["collectives"]["per_axis"]) <= {"data", "model"}, rec["shape"]
    assert {"data", "model"} <= set(ok["train_4k"]["collectives"]["per_axis"])


def test_roofline_fit_equals_the_full_depth_count(result):
    _, fit, _ = result
    assert fit["depths"] == [1, 3]
    assert abs(fit["fit"]["flops"] - fit["full"]["flops"]) <= 1e-9 * fit["full"]["flops"]


def test_registry_accounting_equals_the_reference(result):
    _, _, reg = result
    ref = _reference("dryrun").run_registry(10_000, arch="qwen2.5-0.5b", out_dir=None)
    assert reg == {k: ref[k] for k in ("per_agent_snapshot_bytes", "weight_bytes")}


@pytest.mark.parametrize("arch", list_archs())
def test_analytic_floors_equal_the_reference(arch):
    jroofline = _reference("roofline")
    jcfg, cfg = jconfigs.get_config(arch), get_config(arch)
    for shape in specs_lib.SHAPES:
        jplan, plan = jspecs.plan_for(jcfg, shape), specs_lib.plan_for(cfg, shape)
        assert roofline.model_flops(cfg, plan) == jroofline.model_flops(jcfg, jplan)
        if plan.skip:
            continue
        assert roofline.model_bytes_floor(cfg, plan) == jroofline.model_bytes_floor(jcfg, jplan)
