"""Referential Injection (paper §3.6) and the Validation Gate (§3.5) of the
port against the JAX package's: the six cases of
``tests/test_injection_gate.py``, each held to the reference test's
property and to the reference function's output on the same arrays
(weights bridged from the reference's, inputs made from a seed with numpy).

Ported cases: ``test_injection_changes_output_only_for_accepted_lanes``,
``test_injection_preserves_stream_positions``, ``test_synapse_injection_slots``,
``test_ssm_state_blend`` (``injection.blend_state`` through ``inject`` on
rwkv6), ``test_gate_eq2`` and ``test_gate_scale_invariance``
(``core/gate.py``). ``test_torch_model.py::test_merge_thought_matches_jax``
already holds the fused encode + gate + inject step; these cases hold its
parts. The port's inject and decode write the caches in place, so each case
clones what it reads again.

Tolerances: 1e-5 for the gate and the state blend, 1e-4 for logits and
cache floats; lengths, counts and positions must be equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_families import _one_torch_thread  # noqa: F401 (autouse: one intra-op thread)

from repro.configs import get_config as jax_get_config
from repro.core import gate as jgate
from repro.core import injection as jinj
from repro.models import cache as jcache
from repro.models import model as jmodel
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.core import gate as tgate
from repro_torch.core import injection as tinj
from repro_torch.models import cache as tcache
from repro_torch.models import model as tmodel

UNIT = dict(rtol=1e-5, atol=1e-5)
MODEL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def models():
    """arch -> (jax cfg, jax params, port cfg, port params), reduced, f32."""
    out = {}
    for arch in ("qwen3-8b", "rwkv6-1.6b"):
        jcfg = dataclasses.replace(jax_get_config(arch, reduced=True), compute_dtype="float32")
        cfg = dataclasses.replace(get_config(arch, reduced=True), compute_dtype="float32")
        jp = jax.jit(lambda k: jmodel.init_params(k, jcfg))(jax.random.key(0))
        out[arch] = (jcfg, jp, cfg, bridge.params_from_jax(jax.tree.map(np.asarray, jp), cfg, "cpu"))
    return out


def _tokens(seed, shape, vocab):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


def _clone(caches):
    return caches.map(lambda c: tcache.map_cache(torch.clone, c))


def _prefilled(m, B, S, spec_kw, seed=1):
    """(port caches, reference caches) after the same prompt's prefill."""
    jcfg, jp, cfg, params = m
    tok = _tokens(seed, (B, S), cfg.vocab_size)
    spec, jspec = tmodel.CacheSpec(**spec_kw), jmodel.CacheSpec(**spec_kw)
    c = tmodel.init_caches(cfg, B, spec, device="cpu")
    _, _, c = tmodel.prefill(params, cfg, {"tokens": torch.from_numpy(tok)}, c, spec=spec)
    jc = jmodel.init_caches(jcfg, B, jspec)
    _, _, jc = jax.jit(lambda p, t, c: jmodel.prefill(p, jcfg, {"tokens": t}, c, spec=jspec))(
        jp, jnp.asarray(tok), jc)
    return c, jc, spec, jspec


def _thought(m, B, T, vpos, seed=2):
    """(port thought caches, reference thought caches) at virtual positions."""
    jcfg, jp, cfg, params = m
    th = _tokens(seed, (B, T), cfg.vocab_size)
    vp = np.full((B,), vpos, np.int32)
    tc, _ = tinj.encode_thought_kv(params, cfg, torch.from_numpy(th), torch.from_numpy(vp))
    jc, _ = jax.jit(lambda p, t, v: jinj.encode_thought_kv(p, jcfg, t, v))(jp, jnp.asarray(th), jnp.asarray(vp))
    return tc, jc


def _assert_caches_equal(c, jc, tol):
    got = bridge.caches_to_numpy(c)["groups"]
    ref = bridge.caches_to_numpy(bridge.caches_from_numpy(jax.tree.map(np.asarray, jc), "cpu"))["groups"]
    for g, r in zip(got, ref):
        for name in r:
            if np.issubdtype(r[name].dtype, np.integer):
                np.testing.assert_array_equal(g[name], r[name], err_msg=name)
            else:
                np.testing.assert_allclose(g[name], r[name], err_msg=name, **tol)


def _decode(m, c, jc, spec, jspec, B, pos):
    """One decode step of token 0 at ``pos`` in both packages (the port's
    on a clone: decode writes its cache)."""
    jcfg, jp, cfg, params = m
    tok, p = np.zeros((B,), np.int32), np.full((B,), pos, np.int32)
    lg, _, _ = tmodel.decode_step(params, cfg, {"tokens": torch.from_numpy(tok), "positions": torch.from_numpy(p)},
                                  _clone(c), spec=spec)
    jlg, _, _ = jax.jit(lambda pr, t, q, c: jmodel.decode_step(pr, jcfg, {"tokens": t, "positions": q}, c,
                                                              spec=jspec))(jp, jnp.asarray(tok), jnp.asarray(p), jc)
    np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), **MODEL)
    return lg


def test_injection_changes_output_only_for_accepted_lanes(models):
    m = models["qwen3-8b"]
    B, S = 2, 16
    c, jc, spec, jspec = _prefilled(m, B, S, dict(kind="full", capacity=S + 16))
    tc, jtc = _thought(m, B, 4, S)
    accept = np.asarray([True, False])
    injected = tinj.inject(m[2], _clone(c), tc, torch.from_numpy(accept))
    jinjected = jinj.inject(m[0], jc, jtc, jnp.asarray(accept))
    _assert_caches_equal(injected, jinjected, MODEL)
    lengths = injected.groups[0].length.numpy()  # [L, B]
    assert (lengths[:, 0] == S + 4).all() and (lengths[:, 1] == S).all()
    lg_base = _decode(m, c, jc, spec, jspec, B, S)
    lg_inj = _decode(m, injected, jinjected, spec, jspec, B, S)
    assert float((lg_inj[0] - lg_base[0]).abs().max()) > 1e-4, "the accepted lane must feel the thought"
    assert float((lg_inj[1] - lg_base[1]).abs().max()) < 1e-6, "the rejected lane must be untouched"


def test_injection_preserves_stream_positions(models):
    """The stream's positions are not shifted: the thought lives at virtual
    positions."""
    m = models["qwen3-8b"]
    B, S = 1, 12
    c, jc, _, _ = _prefilled(m, B, S, dict(kind="full", capacity=S + 16))
    tc, jtc = _thought(m, B, 4, 1000)
    injected = tinj.inject(m[2], c, tc, torch.tensor([True]))
    _assert_caches_equal(injected, jinj.inject(m[0], jc, jtc, jnp.asarray([True])), MODEL)
    pos = injected.groups[0].pos[0, 0].numpy()  # layer 0, lane 0
    assert (pos[:S] == np.arange(S)).all()
    assert (pos[S:S + 4] == np.arange(1000, 1004)).all()


def test_synapse_injection_slots(models):
    m = models["qwen3-8b"]
    jcfg, _, cfg, _ = m
    B = 1
    kw = dict(kind="synapse", n_landmarks=8, window=8, n_inject=4)
    spec, jspec = tmodel.CacheSpec(**kw), jmodel.CacheSpec(**kw)
    c, jc = tmodel.init_caches(cfg, B, spec, device="cpu"), jmodel.init_caches(jcfg, B, jspec)
    tc, jtc = _thought(m, B, 3, 50)
    injected = tinj.inject(cfg, _clone(c), tc, torch.tensor([True]))
    jinjected = jinj.inject(jcfg, jc, jtc, jnp.asarray([True]))
    _assert_caches_equal(injected, jinjected, MODEL)
    assert int(injected.groups[0].inj_count[0, 0]) == 3
    # the injected keys are visible to the next synapse decode step
    lg0 = _decode(m, c, jc, spec, jspec, B, 0)
    lg1 = _decode(m, injected, jinjected, spec, jspec, B, 0)
    assert float((lg1 - lg0).abs().max()) > 1e-5


def test_ssm_state_blend(models):
    """An accepted thought's terminal wkv state is blended in as
    0.7 m + 0.3 t (``injection.blend_state``, beta = BLEND_BETA)."""
    m = models["rwkv6-1.6b"]
    B, S = 1, 12
    c, jc, _, _ = _prefilled(m, B, S, dict(kind="full", capacity=S))
    tc, jtc = _thought(m, B, 4, 0)
    before = _clone(c)
    assert tinj.BLEND_BETA == 0.3
    injected = tinj.inject(m[2], c, tc, torch.tensor([True]))
    w0, wt, w1 = (x.groups[0].wkv.numpy() for x in (before, tc, injected))
    np.testing.assert_allclose(w1, 0.7 * w0 + 0.3 * wt, rtol=1e-5, atol=1e-6)
    # the reference's blend of the same arrays (unit), and its whole inject
    # over its own prefill and thought (model level)
    as_ref = lambda st: jcache.RWKV6State(**{f: jnp.asarray(a) for f, a in bridge.cache_to_numpy(st).items()})
    ref = jinj.blend_state(as_ref(before.groups[0]), as_ref(tc.groups[0]), jnp.asarray([True]), beta=0.3)
    np.testing.assert_allclose(w1, np.asarray(ref.wkv), **UNIT)
    _assert_caches_equal(injected, jinj.inject(m[0], jc, jtc, jnp.asarray([True]), beta=0.3), MODEL)


def test_gate_eq2():
    h = np.asarray([[1.0, 0.0], [1.0, 0.0], [1.0, 0.0]], np.float32)
    t = np.asarray([[1.0, 0.0], [0.0, 1.0], [-1.0, 0.0]], np.float32)
    accept, score = tgate.validate(torch.from_numpy(h), torch.from_numpy(t), theta=0.5)
    np.testing.assert_allclose(score.numpy(), [1.0, 0.0, -1.0], atol=1e-6)
    assert accept.tolist() == [True, False, False]
    j_accept, j_score = jgate.validate(jnp.asarray(h), jnp.asarray(t), theta=0.5)
    np.testing.assert_allclose(score.numpy(), np.asarray(j_score), **UNIT)
    assert accept.tolist() == np.asarray(j_accept).tolist()


def test_gate_scale_invariance():
    rng = np.random.default_rng(0)
    h = rng.standard_normal((4, 32), dtype=np.float32)
    t = rng.standard_normal((4, 32), dtype=np.float32)
    _, s1 = tgate.validate(torch.from_numpy(h), torch.from_numpy(t))
    _, s2 = tgate.validate(torch.from_numpy(h * 100.0), torch.from_numpy(t * 0.01))
    np.testing.assert_allclose(s1.numpy(), s2.numpy(), atol=1e-5)
    np.testing.assert_allclose(s1.numpy(), np.asarray(jgate.cosine_score(jnp.asarray(h), jnp.asarray(t))), **UNIT)
