"""The port's Topological Synapse (``repro_torch.core.synapse``) against the
JAX package's: the seven cases of ``tests/test_synapse.py``, each held both
to the reference test's property and to the reference function's output
on the same numpy arrays (made from a seed).

Ported cases: ``test_selection_invariants`` (hypothesis, 20 examples),
``test_pure_density_selects_top_attention``,
``test_pure_coverage_is_farthest_point``, ``test_coverage_reduces_hausdorff``,
``test_compress_respects_short_prompt``, ``test_compression_ratio_is_98_percent``
(byte formulas on the ``meta`` device: no full-size tensor is allocated)
and ``test_streaming_eviction_promotes_high_scores`` (bridged weights). None
had a near counterpart among the port's tests.

Tolerances: 1e-5 for the unit functions (densities, scores, distances),
1e-4 for the model-level caches of the streaming case; indices, counts and
positions must be equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from conftest import hypothesis_tools
from test_torch_families import _one_torch_thread  # noqa: F401 (autouse: one intra-op thread)

from repro.configs import get_config as jax_get_config
from repro.core import synapse as jsyn
from repro.models import cache as jcache
from repro.models import model as jmodel
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.core import synapse as tsyn
from repro_torch.models import cache as tcache
from repro_torch.models import model as tmodel

given, settings, st = hypothesis_tools()

UNIT = dict(rtol=1e-5, atol=1e-5)
MODEL = dict(rtol=1e-4, atol=1e-4)
# the reference jitted: one compile per shape, where its eager loop compiles op by op
J_DENSITY = jax.jit(jsyn.attention_density)
J_SELECT = jax.jit(jsyn.select_landmarks, static_argnums=(3, 4))


def _arrays(seed, B, T, hkv, d, n_heads, length=None):
    """Keys, values, positions, scores, lengths and a query, as numpy."""
    rng = np.random.default_rng(seed)
    return dict(
        k=rng.standard_normal((B, T, hkv, d), dtype=np.float32),
        v=rng.standard_normal((B, T, hkv, d), dtype=np.float32),
        pos=np.broadcast_to(np.arange(T, dtype=np.int32), (B, T)).copy(),
        score=rng.random((B, T), dtype=np.float32),
        length=np.full((B,), T if length is None else length, np.int32),
        q=rng.standard_normal((B, n_heads, d), dtype=np.float32),
    )


def _select(a, k, alpha, cap=4.0):
    """(port, reference) select_landmarks on the same arrays, each over its
    own package's attention density; returns both densities too."""
    B, T = a["pos"].shape
    valid = np.ones((B, T), bool)
    tq, tk, tv = torch.from_numpy(a["q"]), torch.from_numpy(a["k"]), torch.from_numpy(valid)
    t_dens = tsyn.attention_density(tq, tk, tv)
    t_out = tsyn.select_landmarks(tk, tv, t_dens, k, tsyn.SynapsePolicy(alpha=alpha, coverage_cap=cap))
    jq, jk, jv = jnp.asarray(a["q"]), jnp.asarray(a["k"]), jnp.asarray(valid)
    j_dens = J_DENSITY(jq, jk, jv)
    j_out = J_SELECT(jk, jv, j_dens, k, jsyn.SynapsePolicy(alpha=alpha, coverage_cap=cap))
    return [o.numpy() for o in (t_dens, *t_out)], [np.asarray(o) for o in (j_dens, *j_out)]


def _assert_same_selection(got, ref):
    np.testing.assert_allclose(got[0], ref[0], **UNIT)           # density
    np.testing.assert_array_equal(got[1], ref[1])                 # indices
    np.testing.assert_allclose(got[2], ref[2], **UNIT)           # hybrid scores
    np.testing.assert_array_equal(got[3], ref[3])                 # real picks


@settings(max_examples=20, deadline=None)
@given(
    T=st.integers(8, 64),
    k=st.integers(1, 16),
    alpha=st.floats(0.0, 1.0),
    seed=st.integers(0, 2**31 - 1),
)
def test_selection_invariants(T, k, alpha, seed):
    """Selected indices are unique, valid, and k of them (T >= k), and the
    same as the reference's selection on the same arrays."""
    k = min(k, T)
    a = _arrays(seed, 2, T, 2, 16, 4)
    got, ref = _select(a, k, alpha)
    idx = got[1]
    assert idx.shape == (2, k)
    for b in range(2):
        assert len(set(idx[b].tolist())) == k
        assert (idx[b] >= 0).all() and (idx[b] < T).all()
    assert got[3].all()
    _assert_same_selection(got, ref)


def test_pure_density_selects_top_attention():
    """alpha = 1 reduces to the paper's top-k of the summed attention mass."""
    a = _arrays(0, 1, 32, 1, 16, 2)
    got, ref = _select(a, 4, 1.0)
    expect = np.argsort(-got[0], axis=-1, kind="stable")[:, :4]
    assert set(got[1][0].tolist()) == set(expect[0].tolist())
    _assert_same_selection(got, ref)


def test_pure_coverage_is_farthest_point():
    """alpha = 0: greedy maxmin, each new landmark the farthest point from
    the current set."""
    k = 6
    a = _arrays(3, 1, 24, 1, 8, 2)
    got, ref = _select(a, k, 0.0, cap=1e9)
    pooled = a["k"].mean(axis=2)[0]
    chosen = got[1][0].tolist()
    sel = [chosen[0]]
    for step in range(1, k):
        dmin = np.min(np.linalg.norm(pooled[:, None, :] - pooled[np.asarray(sel)][None], axis=-1), axis=1)
        dmin[np.asarray(sel)] = -np.inf
        assert dmin[chosen[step]] == pytest.approx(np.max(dmin), rel=1e-5), step
        sel.append(chosen[step])
    _assert_same_selection(got, ref)


def test_coverage_reduces_hausdorff():
    """Pure-coverage landmarks lie closer (Hausdorff) to the key cloud than
    pure-density top-k, in both packages."""
    a = _arrays(7, 1, 128, 1, 16, 2)
    pooled = a["k"].mean(axis=2)[0]

    def hausdorff(idx):
        lm = pooled[idx[0]]
        return float(np.max(np.min(np.linalg.norm(pooled[:, None] - lm[None], axis=-1), axis=1)))

    dens, dens_ref = _select(a, 8, 1.0)
    cov, cov_ref = _select(a, 8, 0.0, cap=1e9)
    assert hausdorff(cov[1]) <= hausdorff(dens[1]) + 1e-6
    _assert_same_selection(dens, dens_ref)
    _assert_same_selection(cov, cov_ref)


def test_compress_respects_short_prompt():
    """k > T: only the valid prefix becomes landmarks; the compressed cache
    equals the reference's field by field."""
    cfg = dataclasses.replace(get_config("qwen3-8b", reduced=True), compute_dtype="float32")
    jcfg = dataclasses.replace(jax_get_config("qwen3-8b", reduced=True), compute_dtype="float32")
    B, T, K = 2, 16, 32
    a = _arrays(0, B, T, cfg.n_kv_heads, cfg.d_head, cfg.n_heads, length=10)
    fields = {f: a[f] for f in ("k", "v", "pos", "score", "length")}
    syn = tsyn.compress(cfg, tcache.FullCache(**{f: torch.from_numpy(x) for f, x in fields.items()}),
                        torch.from_numpy(a["q"]), K, window=8, n_inject=2)
    assert int(syn.lm_count[0]) == 10
    assert syn.lm_k.shape[1] == K
    ref = jsyn.compress(jcfg, jcache.FullCache(**{f: jnp.asarray(x) for f, x in fields.items()}),
                        jnp.asarray(a["q"]), K, window=8, n_inject=2)
    got = bridge.cache_to_numpy(syn)
    for name, want in bridge.cache_to_numpy(bridge.cache_from_numpy(jax.tree.map(np.asarray, ref), "cpu")).items():
        if np.issubdtype(want.dtype, np.integer):
            np.testing.assert_array_equal(got[name], want, err_msg=name)
        else:
            np.testing.assert_allclose(got[name], want, err_msg=name, **UNIT)


def _ref_bytes(tree) -> int:
    """A reference cache's bytes from its shapes alone (nothing allocated)."""
    return sum(np.prod(x.shape) * x.dtype.itemsize for x in jax.tree.leaves(tree))


def test_compression_ratio_is_98_percent():
    """Paper claim: k = 64 of a 4k context is a 98.4 % token reduction, and
    the synapse's bytes shrink accordingly. Shapes only (meta tensors); the
    byte counts equal the reference's."""
    cfg, jcfg = get_config("qwen2.5-0.5b"), jax_get_config("qwen2.5-0.5b")
    L_ctx = 4096
    full = tcache.cache_bytes(tcache.init_full_cache(cfg, 1, L_ctx, device="meta"))
    syn = tcache.cache_bytes(tcache.init_synapse_cache(cfg, 1, 64, 1, 1, device="meta"))
    assert 1 - 64 / L_ctx > 0.98
    assert syn < full * 0.05
    assert full == _ref_bytes(jax.eval_shape(lambda: jcache.init_full_cache(jcfg, 1, L_ctx)))
    assert syn == _ref_bytes(jax.eval_shape(lambda: jcache.init_synapse_cache(jcfg, 1, 64, 1, 1)))
    assert tsyn.synapse_bytes(cfg, 64, 64, 8) == jsyn.synapse_bytes(jcfg, 64, 64, 8)


def test_streaming_eviction_promotes_high_scores():
    """Window overflows graduate tokens into the landmarks; after 24 steps
    every cache leaf equals the reference's (bridged weights, the same
    tokens)."""
    jcfg = dataclasses.replace(jax_get_config("qwen3-8b", reduced=True), compute_dtype="float32")
    cfg = dataclasses.replace(get_config("qwen3-8b", reduced=True), compute_dtype="float32")
    jp = jax.jit(lambda k: jmodel.init_params(k, jcfg))(jax.random.key(0))
    params = bridge.params_from_jax(jax.tree.map(np.asarray, jp), cfg, "cpu")
    B, W, K, n = 1, 8, 4, 24
    tokens = np.random.default_rng(2).integers(0, cfg.vocab_size, (B, n)).astype(np.int32)
    spec = tmodel.CacheSpec(kind="synapse", n_landmarks=K, window=W, n_inject=1)
    jspec = jmodel.CacheSpec(kind="synapse", n_landmarks=K, window=W, n_inject=1)
    c = tmodel.init_caches(cfg, B, spec, device="cpu")
    jc = jmodel.init_caches(jcfg, B, jspec)
    jstep = jax.jit(lambda p, t, pos, c: jmodel.decode_step(p, jcfg, {"tokens": t, "positions": pos}, c,
                                                            spec=jspec))
    for t in range(n):
        pos = np.full((B,), t, np.int32)
        tl, _, c = tmodel.decode_step(params, cfg, {"tokens": torch.from_numpy(tokens[:, t]),
                                                    "positions": torch.from_numpy(pos)}, c, spec=spec)
        jl, _, jc = jstep(jp, jnp.asarray(tokens[:, t]), jnp.asarray(pos), jc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), err_msg=f"logits, step {t}", **MODEL)
    assert int(c.groups[0].lm_count[0, 0]) > 0  # graduation populated landmarks
    assert int(c.groups[0].length[0, 0]) == n
    got = bridge.caches_to_numpy(c)["groups"][0]
    for name, want in bridge.cache_to_numpy(bridge.cache_from_numpy(
            jax.tree.map(np.asarray, jc.groups[0]), "cpu")).items():
        if np.issubdtype(want.dtype, np.integer):
            np.testing.assert_array_equal(got[name], want, err_msg=name)
        else:
            np.testing.assert_allclose(got[name], want, err_msg=name, **MODEL)
