"""The port's train step over a (data, model) mesh on the CPU.

A gloo job of 4 ranks on the (2, 2) debug mesh (``make_debug_mesh``,
spawned like the lane tests through ``torch_mesh_jobs``) runs two train
steps of each of three reduced configs in f32: Qwen2.5-0.5B (dense),
qwen3-moe (experts over ``model``, the per-lane dispatch) and zamba2 (the
shared block's LoRA, Mamba2's conv). Weights are the reference's
``init_params`` (seed 0) through ``bridge``; batches ``make_batch``
seeds 0 and 1 (seq 32, batch 4). Held to:

* the port's ``--mesh debug`` step (the same weights and batches, one
  device): every metric of both steps within 1e-5 (rtol and atol); the
  params gathered whole after them within 1e-5 where the first step's
  gradient is above 1e-3 x its leaf's largest, elsewhere within twice the
  learning rates of the two steps. Adam's first step is lr * g / (|g| +
  eps), about lr * sign(g), and the sign of a near-zero gradient may
  differ between a sharded and an unsharded sum, as
  ``tests/test_torch_train_families.py`` allows between the packages;
* the reference's single-device ``make_train_step``: the first step's
  loss, ce and lb_loss within rtol = atol = 1e-5, the tolerance of
  ``tests/test_torch_train_families.py``;
* each rank holds its shards only: params and moments under 0.35 of the
  whole (about a quarter on 2 x 2; norms and biases replicate).

The same ranks run RWKV6's recurrence, the decode step and the scan, on
their blocks of lanes and heads against the plain one: within 1e-6 (f32).

Also ``launch.train --mesh multi`` on a world that two pods cannot split
is refused, and ``--mesh single`` on a world of one trains as ``--mesh
debug`` does, bitwise.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from test_torch_families import _one_torch_thread  # noqa: F401 (autouse: one intra-op thread)

import torch_lane_jobs
import torch_mesh_jobs as jobs
from repro import configs as jconfigs
from repro.data import pipeline as jpipeline
from repro.models import model as jmodel
from repro.training import trainer as jtrainer
from repro_torch.checkpoint.io import tree_flatten_with_path
from repro_torch.launch import train as launch_train
from repro_torch.training import optimizer as topt

ARCHS = ("qwen2.5-0.5b", "qwen3-moe-30b-a3b", "zamba2-1.2b")


def _reference_config(arch):
    return dataclasses.replace(jconfigs.get_config(arch, reduced=True), compute_dtype="float32")


def _reference_params(arch):
    """numpy params of the reference's ``init_params`` (seed 0, jitted)."""
    jcfg = _reference_config(arch)
    return jax.tree.map(np.asarray, jax.jit(lambda k: jmodel.init_params(k, jcfg))(jax.random.key(0)))


def _reference_metrics(arch, params):
    """The reference's first step's metrics from ``params``."""
    jcfg = _reference_config(arch)
    batch = jpipeline.make_batch(jcfg, jpipeline.DataConfig(seq_len=jobs.SEQ, batch_size=jobs.BATCH, seed=0))
    _, metrics = jax.jit(lambda p, b: jtrainer.loss_fn(p, jcfg, b))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    return {k: float(v) for k, v in metrics.items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """arch -> {"ref": reference metrics, "debug": the one-device run,
    "ranks": every rank's run on the (2, 2) mesh}, and "wkv": every rank's
    ``torch_mesh_jobs.wkv_parity``. The ranks start as soon
    as the weights are made; the reference's step and the one-device runs
    go here meanwhile."""
    params = {arch: _reference_params(arch) for arch in ARCHS}
    job = torch_lane_jobs.Ranks(jobs.train_job, 4, tmp_path_factory.mktemp("mesh"), params_by_arch=params)
    refs = {arch: _reference_metrics(arch, params[arch]) for arch in ARCHS}
    debug = {arch: jobs.train(jobs.reduced_cfg(arch), params[arch], None) for arch in ARCHS}
    ranks = job.results()
    out = {arch: {"ref": refs[arch], "debug": debug[arch], "ranks": [r[arch] for r in ranks]} for arch in ARCHS}
    out["wkv"] = [r["wkv"] for r in ranks]
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_step_matches_the_debug_step(runs, arch):
    run = runs[arch]
    got, want = run["ranks"][0], run["debug"]
    assert len(got["metrics"]) == len(want["metrics"]) == jobs.STEPS
    for step, (g, w) in enumerate(zip(got["metrics"], want["metrics"])):
        assert g.keys() == w.keys()
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=1e-5, atol=1e-5, err_msg=f"step {step} {k}")
    for rank in run["ranks"][1:]:
        assert [m["loss"] for m in rank["metrics"]] == [m["loss"] for m in got["metrics"]]
    g_leaves, w_leaves = tree_flatten_with_path(got["params"]), tree_flatten_with_path(want["params"])
    grads = dict(tree_flatten_with_path(want["grad0"]))
    assert [k for k, _ in g_leaves] == [k for k, _ in w_leaves]
    opt = topt.AdamWConfig(**jobs.OPT)
    lr_sum = sum(float(topt.lr_at(opt, s + 1)) for s in range(jobs.STEPS))
    for (k, g), (_, w) in zip(g_leaves, w_leaves):
        big = np.abs(grads[k]) > 1e-3 * np.abs(grads[k]).max()
        np.testing.assert_allclose(g[big], w[big], rtol=1e-5, atol=1e-5, err_msg=k)
        np.testing.assert_allclose(g[~big], w[~big], rtol=0, atol=2 * lr_sum, err_msg=k)


@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_step_loss_matches_the_reference(runs, arch):
    run = runs[arch]
    got = run["ranks"][0]["metrics"][0]
    for k in ("loss", "ce", "lb_loss"):
        np.testing.assert_allclose(got[k], run["ref"][k], rtol=1e-5, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("arch", ARCHS)
def test_each_rank_holds_its_shards(runs, arch):
    for rank in runs[arch]["ranks"]:
        assert rank["shard_bytes"] < 0.35 * rank["full_bytes"], (rank["shard_bytes"], rank["full_bytes"])


def test_rwkv6_recurrence_per_shard_matches_the_plain_one(runs):
    for rank in runs["wkv"]:
        assert len(rank) == 4 and max(rank) <= 1e-6, rank


def test_launcher_refuses_multi_on_a_world_two_pods_cannot_split():
    with pytest.raises(SystemExit, match="multi-pod mesh of 1 ranks"):
        launch_train.main(["--device", "cpu", "--steps", "1", "--mesh", "multi"])


def test_launcher_single_on_a_world_of_one_trains_as_debug():
    argv = ["--device", "cpu", "--steps", "2", "--seq", "16", "--batch", "2"]
    mesh = launch_train.main(argv + ["--mesh", "single"])
    plain = launch_train.main(argv)
    assert mesh["mesh"] == (1, 1) and plain["mesh"] is None
    assert mesh["losses"] == plain["losses"]
