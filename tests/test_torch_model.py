"""The port's model, synapse and injection against the JAX package, on the
reduced Qwen2.5-0.5B in f32 with bridged weights.

Tolerances: logits and hidden states start from atol = rtol = 1e-4; the
two packages run the same f32 arithmetic in different summation orders,
and the largest error observed on these inputs is ~2e-6 (logits) and
~8e-6 (cache leaves), so 1e-4 leaves a wide margin without hiding a wrong
formula (a wrong mask or rope moves logits by O(1e-1)). Integer leaves,
landmark indices and promote masks must be equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core import injection as jinj
from repro.core import synapse as jsyn
from repro.models import model as jmodel
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.core import injection as tinj
from repro_torch.core import synapse as tsyn
from repro_torch.models import attention as tattn
from repro_torch.models import model as tmodel

TOL = dict(rtol=1e-4, atol=1e-4)
ARCH = "qwen2.5-0.5b"


@pytest.fixture(scope="module")
def models():
    jcfg = dataclasses.replace(jax_get_config(ARCH, reduced=True), compute_dtype="float32")
    tcfg = dataclasses.replace(get_config(ARCH, reduced=True), compute_dtype="float32")
    jp = jmodel.init_params(jax.random.key(0), jcfg)
    tp = bridge.params_from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    return jcfg, tcfg, jp, tp


def _specs(kind, **kw):
    args = dict(kind=kind, capacity=64, n_landmarks=8, window=8, n_inject=4) | kw
    return jmodel.CacheSpec(**args), tmodel.CacheSpec(**args)


def assert_cache_close(jc, tc, tol=TOL):
    """Every leaf: integers equal, floats within ``tol``, -inf where -inf."""
    for name, a in bridge.cache_to_numpy(tc).items():
        ref = np.asarray(getattr(jc, name))
        assert ref.shape == a.shape, name
        if np.issubdtype(ref.dtype, np.integer):
            np.testing.assert_array_equal(a, ref, err_msg=name)
        else:
            np.testing.assert_allclose(a, ref.astype(np.float32), err_msg=name, **tol)


def assert_caches_close(jcs, tcs):
    for jc, tc in zip(jcs.groups, tcs.groups):
        assert_cache_close(jc, tc)


def _tokens(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape).astype(np.int32)


@pytest.mark.parametrize("kind", ["full", "synapse"])
def test_prefill_then_decode_matches_jax(models, kind):
    """Prefill and N teacher-forced decode steps: logits, hidden states and
    caches agree; the synapse spec graduates tokens into landmarks."""
    jcfg, tcfg, jp, tp = models
    jspec, tspec = _specs(kind, window=4)
    B, S, N = 2, 20, 10
    toks = _tokens((B, S), 0)
    jc = jmodel.init_caches(jcfg, B, jspec)
    jl, jh, jc = jmodel.prefill(jp, jcfg, {"tokens": jnp.asarray(toks)}, jc, spec=jspec)
    tc = tmodel.init_caches(tcfg, B, tspec, device="cpu")
    tl, th, tc = tmodel.prefill(tp, tcfg, {"tokens": torch.from_numpy(toks)}, tc, spec=tspec)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)
    assert_caches_close(jc, tc)
    pos = np.full((B,), S, np.int32)
    for _ in range(N):
        tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)  # the reference's tokens, forced
        inp = lambda f: {"tokens": f(tok), "positions": f(pos)}
        jl, jh, jc = jmodel.decode_step(jp, jcfg, inp(jnp.asarray), jc, spec=jspec)
        tl, th, tc = tmodel.decode_step(tp, tcfg, inp(torch.from_numpy), tc, spec=tspec)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)
        pos = pos + 1
    assert_caches_close(jc, tc)


def test_decode_past_capacity_matches_jax_dropped_scatter(models):
    """Idle lanes keep counting past capacity; JAX drops the out-of-bounds
    scatter and the port masks it, with ``length`` growing in both."""
    jcfg, tcfg, jp, tp = models
    jspec, tspec = _specs("full", capacity=8)
    B = 2
    toks = _tokens((B, 6), 1)
    jc = jmodel.init_caches(jcfg, B, jspec)
    _, _, jc = jmodel.prefill(jp, jcfg, {"tokens": jnp.asarray(toks)}, jc, spec=jspec)
    tc = tmodel.init_caches(tcfg, B, tspec, device="cpu")
    tmodel.prefill(tp, tcfg, {"tokens": torch.from_numpy(toks)}, tc, spec=tspec)
    for step in range(5):  # lengths 6 -> 11 against capacity 8
        tok = _tokens((B,), 10 + step)
        pos = np.full((B,), 6 + step, np.int32)
        jl, _, jc = jmodel.decode_step(jp, jcfg, {"tokens": jnp.asarray(tok), "positions": jnp.asarray(pos)}, jc, spec=jspec)
        tl, _, tc = tmodel.decode_step(tp, tcfg, {"tokens": torch.from_numpy(tok), "positions": torch.from_numpy(pos)}, tc, spec=tspec)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    assert int(tc.groups[0].length[0, 0]) == 11
    assert_caches_close(jc, tc)


def _prefilled_full(models, B=2, S=24, seed=2):
    jcfg, tcfg, jp, tp = models
    jspec, tspec = _specs("full")
    toks = _tokens((B, S), seed)
    jc = jmodel.init_caches(jcfg, B, jspec)
    _, jh, jc = jmodel.prefill(jp, jcfg, {"tokens": jnp.asarray(toks)}, jc, spec=jspec)
    tc = tmodel.init_caches(tcfg, B, tspec, device="cpu")
    _, th, tc = tmodel.prefill(tp, tcfg, {"tokens": torch.from_numpy(toks)}, tc, spec=tspec)
    return jc, tc, jh, th


def _layer0(tree):
    return jax.tree.map(lambda a: a[0], tree)


@pytest.mark.parametrize("with_query", [True, False])
def test_compress_picks_same_landmarks(models, with_query):
    jcfg, tcfg, jp, tp = models
    jc, tc, _, _ = _prefilled_full(models, S=24)
    jfull = _layer0(jc.groups[0])
    tfull = tmodel.layer_cache(tc.groups[0], 0)
    q = np.random.default_rng(3).standard_normal((2, tcfg.n_heads, tcfg.d_head), dtype=np.float32)
    for K in (8, 32):  # 32 > 24 valid keys: short-prompt picks go last
        js = jsyn.compress(jcfg, jfull, jnp.asarray(q) if with_query else None, K, 8, 4)
        ts = tsyn.compress(tcfg, tfull, torch.from_numpy(q) if with_query else None, K, 8, 4)
        np.testing.assert_array_equal(ts.lm_pos.numpy(), np.asarray(js.lm_pos))
        assert_cache_close(js, ts)


def test_select_landmarks_ties_take_first_index(models):
    """Equal scores everywhere: argmax keeps the first index, as jnp.argmax."""
    B, T, Hkv, D, K = 1, 12, 2, 8, 5
    keys = np.zeros((B, T, Hkv, D), np.float32)
    dens = np.ones((B, T), np.float32)
    valid = np.ones((B, T), bool)
    pol_j, pol_t = jsyn.SynapsePolicy(), tsyn.SynapsePolicy()
    ji, js, jv = jsyn.select_landmarks(jnp.asarray(keys), jnp.asarray(valid), jnp.asarray(dens), K, pol_j)
    ti, ts, tv = tsyn.select_landmarks(torch.from_numpy(keys), torch.from_numpy(valid), torch.from_numpy(dens), K, pol_t)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(ti.numpy()[0], np.arange(K))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_synapse_decode_run_matches_jax(models):
    """A run of synapse decode steps from a compressed cache with a small
    window, so tokens graduate and evict: every SynapseCache leaf and every
    step's promote mask agree."""
    jcfg, tcfg, jp, tp = models
    jc, tc, _, _ = _prefilled_full(models, S=24)
    jfull, tfull = _layer0(jc.groups[0]), tmodel.layer_cache(tc.groups[0], 0)
    js = jsyn.compress(jcfg, jfull, None, 6, 4, 4)
    ts = tsyn.compress(tcfg, tfull, None, 6, 4, 4)
    jap = jax.tree.map(lambda a: a[0], jp["groups"][0]["attn"])
    tap = {k: v[0] for k, v in tp["groups"][0]["attn"].items()}
    rng = np.random.default_rng(4)
    promoted_any = False
    for step in range(14):
        x = rng.standard_normal((2, 1, tcfg.d_model), dtype=np.float32)
        pos = np.full((2,), 24 + step, np.int32)
        jy, js, jst = jsyn.synapse_decode(jap, jcfg, jnp.asarray(x), js, jnp.asarray(pos))
        ty, ts, tst = tsyn.synapse_decode(tap, tcfg, torch.from_numpy(x), ts, torch.from_numpy(pos))
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
        np.testing.assert_array_equal(tst["promoted"].numpy(), np.asarray(jst["promoted"]))
        promoted_any |= bool(tst["promoted"].any())
    assert promoted_any
    assert_cache_close(js, ts)


@pytest.mark.parametrize("theta,near_capacity", [(-1.0, False), (2.0, False), (-1.0, True)])
def test_merge_thought_matches_jax(models, theta, near_capacity):
    """Encode + gate + inject: accept, score and the main caches agree. Near
    capacity the reference clamps the slice start, overwriting the last T
    slots; the port clamps the same way."""
    jcfg, tcfg, jp, tp = models
    jc, tc, jh, th = _prefilled_full(models, S=60 if near_capacity else 24)
    T = 8
    thought = _tokens((2, T), 5)
    vpos = np.array([24, 30], np.int32)
    mask = np.array([True, False])
    jc2, jacc, jscore = jinj.merge_thought(jp, jcfg, jc, jh, jnp.asarray(thought), jnp.asarray(vpos), jnp.asarray(mask), theta)
    tc2, tacc, tscore = tinj.merge_thought(tp, tcfg, tc, th, torch.from_numpy(thought), torch.from_numpy(vpos), torch.from_numpy(mask), theta)
    np.testing.assert_array_equal(tacc.numpy(), np.asarray(jacc))
    np.testing.assert_allclose(tscore.numpy(), np.asarray(jscore), **TOL)
    assert bool(tacc[0]) == (theta < 0)
    assert_caches_close(jc2, tc2)


def test_inject_synapse_matches_jax(models):
    jcfg, tcfg, jp, tp = models
    jspec, tspec = _specs("synapse", n_inject=4)
    toks = _tokens((2, 16), 6)
    jc = jmodel.init_caches(jcfg, 2, jspec)
    _, _, jc = jmodel.prefill(jp, jcfg, {"tokens": jnp.asarray(toks)}, jc, spec=jspec)
    tc = tmodel.init_caches(tcfg, 2, tspec, device="cpu")
    tmodel.prefill(tp, tcfg, {"tokens": torch.from_numpy(toks)}, tc, spec=tspec)
    thought = _tokens((2, 6), 7)  # 6 > J = 4: the oldest thought tokens drop
    vpos = np.array([16, 16], np.int32)
    accept = np.array([True, False])
    jt, _ = jinj.encode_thought_kv(jp, jcfg, jnp.asarray(thought), jnp.asarray(vpos))
    tt, _ = tinj.encode_thought_kv(tp, tcfg, torch.from_numpy(thought), torch.from_numpy(vpos))
    assert_caches_close(jt, tt)
    jc = jinj.inject(jcfg, jc, jt, jnp.asarray(accept))
    tinj.inject(tcfg, tc, tt, torch.from_numpy(accept))
    assert_caches_close(jc, tc)


def test_unsupported_families_raise():
    cfg = dataclasses.replace(get_config(ARCH, reduced=True), attn_kind="mla")
    with pytest.raises(NotImplementedError, match="item 13"):
        tmodel.init_params(cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="item 13"):
        tattn.check_supported(dataclasses.replace(get_config(ARCH, reduced=True), n_experts=4, experts_per_token=2))


def test_init_params_layout_matches_reference(models):
    """The port's own seeded init has the reference's tree, shapes and dtypes."""
    jcfg, tcfg, jp, _ = models
    tp = tmodel.init_params(tcfg, seed=3, device="cpu")
    shapes = lambda tree: jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype).replace("torch.", "")), tree)
    assert shapes(bridge.params_to_numpy(tp)) == shapes(jax.tree.map(np.asarray, jp))


@pytest.mark.parametrize("n_inject", [0, 16])
def test_synapse_bytes_matches_reference(n_inject):
    """The per-agent synapse footprint (the paper's ~10 MB claim) at full width."""
    jcfg, tcfg = jax_get_config(ARCH), get_config(ARCH)
    assert tsyn.synapse_bytes(tcfg, 64, 64, n_inject) == jsyn.synapse_bytes(jcfg, 64, 64, n_inject)
