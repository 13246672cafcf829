"""One train step of every architecture against the JAX package's, on the
reduced configs in f32 with bridged weights: the port's counterpart of
``tests/test_configs_smoke.py::test_reduced_train_step``, held to the
reference's loss, gradients and updated params.

Weights come from the reference's ``init_train_state`` through
``bridge.params_from_jax``; the batch from ``make_batch`` (seq 32, batch
2), the same numpy arrays on both sides. The reference's step is one jit
per arch (value_and_grad of ``loss_fn``, then ``adamw_update``) in a module
fixture. Tolerances:

* loss, ce, lb_loss: rtol = atol = 1e-5; drop_frac equal;
* each gradient leaf: atol = 1e-4 x that leaf's max |g_ref|, rtol = 1e-3
  (summation order: rwkv6's recurrence spreads it most);
* the global gradient norm: relative 1e-4;
* the params after the step: within 1e-5 where |g_ref| > 1e-3 x the
  leaf's max |g_ref|; elsewhere within 2 lr_at(1). Adam's first step is
  lr * g / (|g| + eps), about lr * sign(g), and where a gradient is near
  zero its sign may differ between the two packages.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.data import pipeline as jpipeline
from repro.models import model as jmodel
from repro.training import optimizer as jopt
from repro.training import trainer as jtrainer
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.data import pipeline
from repro_torch.models import model as tmodel
from repro_torch.training import optimizer as topt
from repro_torch.training import trainer as ttrainer

ARCHS = list(jconfigs.ARCHS)
OPT = dict(warmup_steps=1, total_steps=10)  # the reference smoke test's optimizer
SEQ, BATCH = 32, 2


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Small CPU ops run fastest on one thread; a parallel test run puts
    several workers on few cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(arch, **kw):
    kw = {"compute_dtype": "float32", **kw}
    return (dataclasses.replace(jconfigs.get_config(arch, reduced=True), **kw),
            dataclasses.replace(get_config(arch, reduced=True), **kw))


def _reference_step(jcfg):
    opt = jopt.AdamWConfig(**OPT)

    def step(state, batch):
        (_, metrics), grads = jax.value_and_grad(jtrainer.loss_fn, has_aux=True)(state.params, jcfg, batch)
        new_params, _, opt_metrics = jopt.adamw_update(opt, state.params, grads, state.opt)
        return {**metrics, **opt_metrics}, grads, new_params

    return jax.jit(step)


@pytest.fixture(scope="module")
def runs():
    """arch -> the reference's and the port's step on the same weights and
    batch, computed once per arch."""
    cache = {}

    def get(arch):
        if arch in cache:
            return cache[arch]
        jcfg, cfg = _cfgs(arch)
        state = jtrainer.init_train_state(jax.random.key(0), jcfg)
        batch = jpipeline.make_batch(jcfg, jpipeline.DataConfig(seq_len=SEQ, batch_size=BATCH))
        metrics, grads, new_params = _reference_step(jcfg)(state, {k: jnp.asarray(v) for k, v in batch.items()})
        np_params = jax.tree.map(np.asarray, state.params)
        port_state = ttrainer.train_state(bridge.params_from_jax(np_params, cfg, "cpu"))
        port_batch = pipeline.batch_to(pipeline.make_batch(cfg, pipeline.DataConfig(seq_len=SEQ, batch_size=BATCH)),
                                       "cpu")
        cache[arch] = dict(
            cfg=cfg, batch=port_batch, state=port_state,
            ref_metrics={k: float(v) for k, v in metrics.items()},
            ref_params=jax.tree.leaves(np_params),
            ref_grads=[np.asarray(g) for g in jax.tree.leaves(grads)],
            ref_new=[np.asarray(p) for p in jax.tree.leaves(new_params)],
            ref_new_tree=jax.tree.map(np.asarray, new_params), ref_batch=batch,
        )
        return cache[arch]

    return get


def _port_grads(run):
    leaves = tmodel.tree_leaves(run["state"].params)
    loss, metrics = ttrainer.loss_fn(run["state"].params, run["cfg"], run["batch"])
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    metrics = {k: v.detach() for k, v in metrics.items()}
    return metrics, [np.zeros(p.shape, np.float32) if g is None else g.numpy() for p, g in zip(leaves, grads)]


@pytest.mark.parametrize("arch", ARCHS)
def test_batches_equal_the_reference(arch):
    jcfg, cfg = _cfgs(arch)
    for seed in (0, 3):
        ref = jpipeline.make_batch(jcfg, jpipeline.DataConfig(seq_len=SEQ, batch_size=BATCH, seed=seed))
        got = pipeline.make_batch(cfg, pipeline.DataConfig(seq_len=SEQ, batch_size=BATCH, seed=seed))
        assert ref.keys() == got.keys()
        for k in ref:
            assert ref[k].dtype == got[k].dtype and ref[k].shape == got[k].shape, k
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_the_reference(arch, runs):
    run = runs(arch)
    metrics, grads = _port_grads(run)
    ref = run["ref_metrics"]
    for k in ("loss", "ce", "lb_loss"):
        np.testing.assert_allclose(float(metrics[k]), ref[k], rtol=1e-5, atol=1e-5, err_msg=k)
    assert float(metrics["drop_frac"]) == ref["drop_frac"]
    assert len(grads) == len(run["ref_grads"])
    for i, (g, r) in enumerate(zip(grads, run["ref_grads"])):
        assert g.shape == r.shape
        np.testing.assert_allclose(g, r, rtol=1e-3, atol=1e-4 * float(np.abs(r).max()), err_msg=f"leaf {i}")
    norm = float(topt.global_norm([torch.from_numpy(g) for g in grads]))
    np.testing.assert_allclose(norm, ref["grad_norm"], rtol=1e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_the_reference(arch, runs):
    """The port's whole train step: finite loss, step 1, the reference's
    metrics, and params that moved as the reference's did."""
    run = runs(arch)
    step = ttrainer.make_train_step(run["cfg"], topt.AdamWConfig(**OPT))
    new, metrics = step(run["state"], run["batch"])
    assert torch.isfinite(metrics["loss"]) and int(new.step) == 1 and int(new.opt.step) == 1
    ref = run["ref_metrics"]
    for k in ("loss", "ce", "lb_loss"):
        np.testing.assert_allclose(float(metrics[k]), ref[k], rtol=1e-5, atol=1e-5, err_msg=k)
    assert float(metrics["drop_frac"]) == ref["drop_frac"]
    np.testing.assert_allclose(float(metrics["grad_norm"]), ref["grad_norm"], rtol=1e-4)
    np.testing.assert_allclose(float(metrics["lr"]), ref["lr"], rtol=1e-6)
    lr1 = float(topt.lr_at(topt.AdamWConfig(**OPT), 1))
    leaves = tmodel.tree_leaves(new.params)
    assert all(p.requires_grad and p.dtype == torch.float32 for p in leaves)
    moved = 0.0
    for i, (p, r, g, p0) in enumerate(zip(leaves, run["ref_new"], run["ref_grads"], run["ref_params"])):
        p = p.detach().numpy()
        # where the gradient is near zero its sign, and so Adam's first
        # step (~ lr * sign(g)), may differ between the packages
        big = np.abs(g) > 1e-3 * np.abs(g).max()
        np.testing.assert_allclose(p[big], r[big], rtol=0, atol=1e-5, err_msg=f"leaf {i}")
        np.testing.assert_allclose(p[~big], r[~big], rtol=0, atol=2 * lr1, err_msg=f"leaf {i}")
        moved = max(moved, float(np.abs(p - p0).max()))
    assert moved > 0.0


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_policies_agree_bitwise(arch, runs):
    """Remat off, full and dots give bitwise-equal losses and gradients:
    the recomputation repeats the same CPU arithmetic."""
    run = runs(arch)
    out = []
    for remat, policy in ((False, "full"), (True, "full"), (True, "dots")):
        cfg = dataclasses.replace(run["cfg"], remat=remat, remat_policy=policy)
        metrics, grads = _port_grads(dict(run, cfg=cfg))
        out.append((float(metrics["loss"]), grads))
    for loss, grads in out[1:]:
        assert loss == out[0][0]
        for a, b in zip(grads, out[0][1]):
            np.testing.assert_array_equal(a, b)


def test_zamba2_decode_after_a_step_skips_the_shared_lora_as_the_reference(runs):
    """The shared block decodes without its per-invocation LoRA in both
    packages (``repro/models/model.py:581-587``): invisible while lora_b is
    0, as both initialise it. After one train step lora_b moves, and then
    zamba2's decode no longer matches its forward, in the reference and in
    the port alike. The port's decode is held to the reference's (1e-4),
    and both are shown to part from the forward by more than that."""
    run = runs("zamba2-1.2b")
    jcfg, cfg = _cfgs("zamba2-1.2b")
    new = run["ref_new_tree"]  # the params after the reference's step
    assert float(np.abs(new["shared_attn"]["attn"]["lora_b"]).max()) > 0.0
    jp = jax.tree.map(jnp.asarray, new)
    tp = bridge.params_from_jax(new, cfg, "cpu")
    tokens = run["ref_batch"]["tokens"][:, :12]
    P = 8  # prefill, then teacher-forced decode of tokens P..11
    jfwd = np.asarray(jax.jit(lambda p, t: jmodel.forward(p, jcfg, {"tokens": t})[0])(jp, jnp.asarray(tokens)))
    spec = jmodel.CacheSpec(kind="full", capacity=16)
    tspec = tmodel.CacheSpec(kind="full", capacity=16)
    jc = jmodel.init_caches(jcfg, BATCH, spec)
    _, _, jc = jax.jit(lambda p, t, c: jmodel.prefill(p, jcfg, {"tokens": t}, c, spec=spec))(
        jp, jnp.asarray(tokens[:, :P]), jc)
    tc = tmodel.init_caches(cfg, BATCH, tspec, device="cpu")
    with torch.no_grad():
        tmodel.prefill(tp, cfg, {"tokens": torch.from_numpy(tokens[:, :P])}, tc, spec=tspec)
    jdec = jax.jit(lambda p, i, c: jmodel.decode_step(p, jcfg, i, c, spec=spec))
    part_ref = part_port = 0.0
    for t in range(P, tokens.shape[1]):
        pos = np.full((BATCH,), t, np.int32)
        jl, _, jc = jdec(jp, {"tokens": jnp.asarray(tokens[:, t]), "positions": jnp.asarray(pos)}, jc)
        with torch.no_grad():
            tl, _, tc = tmodel.decode_step(tp, cfg, {"tokens": torch.from_numpy(tokens[:, t]),
                                                     "positions": torch.from_numpy(pos)}, tc, spec=tspec)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4, atol=1e-4)
        part_ref = max(part_ref, float(np.abs(np.asarray(jl) - jfwd[:, t]).max()))
        part_port = max(part_port, float(np.abs(tl.numpy() - jfwd[:, t]).max()))
    assert part_ref > 1e-3 and part_port > 1e-3, (part_ref, part_port)
