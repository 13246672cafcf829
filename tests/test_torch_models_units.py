"""The port's model units against the JAX package's: MoE dispatch (both
paths, drops and ties), the Mamba2 chunked SSD and its oracle, the RWKV6
recurrence, MLA, M-RoPE, the shared block's LoRA and blocked attention.

A port of ``tests/test_models_units.py``: each of its checks runs on the
port, and each unit is also held against the JAX function on the same
inputs (numpy-seeded) with weights made by the JAX initialisers and
bridged. Floats agree within 1e-4 (the same f32 arithmetic in other
summation orders; the largest error seen here is ~1e-5); expert choices,
drop counts and cache integers are equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.kernels.ref import mamba2_chunk_ref as jax_mamba2_chunk_ref
from repro.models import attention as jattn, cache as jcache, layers as jlayers
from repro.models import mamba2 as jmamba2, mla as jmla, moe as jmoe, rwkv6 as jrwkv6
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.kernels.ref import mamba2_chunk_ref
from repro_torch.models import attention, cache as cache_lib, mamba2, mla, moe, rwkv6
from repro_torch.models import model as tmodel
from repro_torch.models.layers import apply_mrope, apply_rope

TOL = dict(rtol=1e-4, atol=1e-4)



@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Small CPU ops run fastest on one thread; a parallel test run puts
    several workers on few cores, where each worker's intra-op thread
    pool would contend with the others'."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

def _both(arch, **kw):
    """(jax cfg, port cfg), reduced, f32, with the same overrides."""
    kw = {"compute_dtype": "float32", **kw}
    return (dataclasses.replace(jax_get_config(arch, reduced=True), **kw),
            dataclasses.replace(get_config(arch, reduced=True), **kw))


def _port(tree):
    """A JAX params subtree -> the port's tensors on the CPU."""
    return tmodel.tree_map(lambda a: bridge.to_torch(a, "cpu"), jax.tree.map(np.asarray, tree))


def _randn(seed, *shape, scale=1.0):
    a = (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)
    return jnp.asarray(a), torch.from_numpy(a)


def _jit(fn, cfg, **kw):
    """``fn(params, cfg, *args, **kw)`` of the JAX package, jitted with cfg
    and ``kw`` fixed: one compile instead of one per eager op."""
    return jax.jit(lambda p, *a: fn(p, cfg, *a, **kw))


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **(tol or TOL))


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------
def _moe_cfgs(E=4, k=2, dm=32, ff=64, **kw):
    """Dropless (capacity factor 100) unless ``kw`` says otherwise."""
    kw = {"n_shared_experts": 0, "moe_capacity_factor": 100.0, **kw}
    return _both("qwen3-moe-30b-a3b", n_experts=E, experts_per_token=k, d_model=dm, d_ff=ff, **kw)


def _moe_params(jcfg, seed=0):
    jp = jmoe.moe_init(jax.random.key(seed), jcfg, jnp.float32)
    return jp, _port(jp)


def _dense_moe(p, cfg, x):
    """Per-token explicit expert evaluation (no dispatch tricks)."""
    probs = torch.softmax(x @ p["router"], -1)
    g, idx = moe.top_k(probs, cfg.experts_per_token)
    g = g / g.sum(-1, keepdim=True)
    out = torch.zeros_like(x)
    for t in range(x.shape[0]):
        for j in range(cfg.experts_per_token):
            e = int(idx[t, j])
            h = torch.nn.functional.silu(x[t] @ p["experts"]["gate"][e]) * (x[t] @ p["experts"]["up"][e])
            out[t] += g[t, j] * (h @ p["experts"]["down"][e])
    return out


@pytest.mark.parametrize("dispatch", ["per_lane", "global"])
def test_moe_dispatch_matches_dense_reference_and_jax(dispatch):
    jcfg, cfg = _moe_cfgs(moe_dispatch=dispatch)
    jp, tp = _moe_params(jcfg)
    jx, tx = _randn(1, 1, 12, cfg.d_model)
    y, aux = moe.moe_forward(tp, cfg, tx)
    _close(y[0], _dense_moe(tp, cfg, tx[0]), rtol=2e-4, atol=2e-4)
    assert float(aux["drop_frac"]) == 0.0
    jy, jaux = _jit(jmoe.moe_forward, jcfg)(jp, jx)
    _close(y, jy)
    _close(aux["lb_loss"], jaux["lb_loss"])


@pytest.mark.parametrize("dispatch,shape", [("per_lane", (2, 64)), ("global", (1, 64)), ("global", (8, 1))])
def test_moe_capacity_drops_match_jax(dispatch, shape):
    """Capacity 0.25: tokens overflow their experts. The port drops the same
    assignments: the drop fraction is equal, the outputs agree."""
    jcfg, cfg = _moe_cfgs(moe_capacity_factor=0.25, moe_dispatch=dispatch)
    jp, tp = _moe_params(jcfg)
    jx, tx = _randn(1, *shape, cfg.d_model)
    y, aux = moe.moe_forward(tp, cfg, tx)
    jy, jaux = _jit(jmoe.moe_forward, jcfg)(jp, jx)
    if shape[0] * shape[1] > 8:
        assert float(aux["drop_frac"]) > 0.0
    assert float(aux["drop_frac"]) == float(jaux["drop_frac"])
    _close(y, jy)
    _close(aux["lb_loss"], jaux["lb_loss"])


def test_moe_lb_loss_uniform_is_one():
    """With near-uniform routing the switch loss is about k, never below."""
    jcfg, cfg = _moe_cfgs(E=8, k=2)
    jp, tp = _moe_params(jcfg)
    jx, tx = _randn(5, 4, 128, cfg.d_model)
    _, aux = moe.moe_forward(tp, cfg, tx)
    assert float(aux["lb_loss"]) >= cfg.experts_per_token * 0.98
    _close(aux["lb_loss"], _jit(jmoe.moe_forward, jcfg)(jp, jx)[1]["lb_loss"])


def test_moe_shared_expert_added():
    jcfg, cfg = _moe_cfgs(n_shared_experts=1)
    jp, tp = _moe_params(jcfg)
    jx, tx = _randn(1, 1, 8, cfg.d_model)
    y_with, _ = moe.moe_forward(tp, cfg, tx)
    zeroed = {**tp, "shared": {k: torch.zeros_like(a) for k, a in tp["shared"].items()}}
    y_zero, _ = moe.moe_forward(zeroed, cfg, tx)
    assert float((y_with - y_zero).abs().max()) > 1e-5
    _close(y_with, _jit(jmoe.moe_forward, jcfg)(jp, jx)[0])


def test_top_k_breaks_ties_as_jax():
    """Ties take the lower index first, in jax.lax.top_k's order."""
    rng = np.random.default_rng(3)
    probs = rng.integers(0, 4, (64, 16)).astype(np.float32) / 4  # many ties
    jv, ji = jax.lax.top_k(jnp.asarray(probs), 5)
    tv, ti = moe.top_k(torch.from_numpy(probs), 5)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


@pytest.mark.parametrize("dispatch", ["per_lane", "global"])
def test_moe_tied_router_matches_jax(dispatch):
    """A zero router gives every expert the same probability: the top-k,
    the sort dispatch and the drops must follow the reference's tie
    order exactly (a capacity that drops, so a different order would move
    which tokens are kept)."""
    jcfg, cfg = _moe_cfgs(moe_dispatch=dispatch, moe_capacity_factor=0.5)
    jp, tp = _moe_params(jcfg)
    jp = {**jp, "router": jnp.zeros_like(jp["router"])}
    tp = {**tp, "router": torch.zeros_like(tp["router"])}
    jx, tx = _randn(2, 2, 24, cfg.d_model)
    y, aux = moe.moe_forward(tp, cfg, tx)
    jy, jaux = _jit(jmoe.moe_forward, jcfg)(jp, jx)
    assert float(aux["drop_frac"]) == float(jaux["drop_frac"]) > 0.0
    _close(y, jy)


# ---------------------------------------------------------------------------
# Mamba2: chunked SSD vs the recurrence, and vs the JAX package
# ---------------------------------------------------------------------------
def _mamba_setup(chunk, seed=0):
    jcfg, cfg = _both("zamba2-1.2b", ssm_chunk=chunk, shared_attn_every=0)
    jp = jmamba2.mamba2_init(jax.random.key(seed), jcfg, jnp.float32)
    # a_log and dt_bias start at 0 in both packages: move them so the
    # decays differ per head
    rng = np.random.default_rng(seed)
    jp = {**jp, "a_log": jnp.asarray(rng.standard_normal(cfg.ssm_n_heads).astype(np.float32) * 0.5),
          "dt_bias": jnp.asarray(rng.standard_normal(cfg.ssm_n_heads).astype(np.float32) * 0.5)}
    return jcfg, cfg, jp, _port(jp)


@pytest.mark.parametrize("S,chunk", [(32, 8), (64, 16), (48, 16)])
def test_mamba2_chunked_matches_recurrence_and_jax(S, chunk):
    jcfg, cfg, jp, tp = _mamba_setup(chunk)
    B = 2
    jx, tx = _randn(1, B, S, cfg.d_model, scale=0.5)
    y_chunked = mamba2.mamba2_forward(tp, cfg, tx)
    state = cache_lib.init_mamba2_state(cfg, B, torch.float32, device="cpu")
    outs = []
    for t in range(S):
        yt, state = mamba2.mamba2_decode(tp, cfg, tx[:, t:t + 1], state)
        outs.append(yt)
    _close(y_chunked, torch.cat(outs, dim=1), rtol=2e-3, atol=2e-3)
    if S == 64:  # one shape against the JAX package (its eager ops compile per shape)
        _close(y_chunked, _jit(jmamba2.mamba2_forward, jcfg)(jp, jx))


def test_mamba2_terminal_state_matches_decode_chain_and_jax():
    jcfg, cfg, jp, tp = _mamba_setup(8)
    B, S = 1, 24
    jx, tx = _randn(1, B, S, cfg.d_model, scale=0.5)
    _, st = mamba2.mamba2_forward(tp, cfg, tx, return_state=True)
    state = cache_lib.init_mamba2_state(cfg, B, torch.float32, device="cpu")
    for t in range(S):
        _, state = mamba2.mamba2_decode(tp, cfg, tx[:, t:t + 1], state)
    _close(st.ssm, state.ssm, rtol=2e-3, atol=2e-3)
    _close(st.conv, state.conv, rtol=1e-4, atol=1e-5)
    _, jst = _jit(jmamba2.mamba2_forward, jcfg, return_state=True)(jp, jx)
    _close(st.ssm, jst.ssm)
    _close(st.conv, jst.conv)
    jstate = jcache.init_mamba2_state(jcfg, B, jnp.float32)
    _, jstate = _jit(jmamba2.mamba2_decode, jcfg)(jp, jx[:, :1], jstate)
    _, one = mamba2.mamba2_decode(tp, cfg, tx[:, :1], cache_lib.init_mamba2_state(cfg, B, torch.float32, device="cpu"))
    _close(one.ssm, jstate.ssm)
    _close(one.conv, jstate.conv)


def test_mamba2_refuses_a_ragged_sequence_as_jax():
    """S must be a multiple of the chunk (or shorter): the reference's assert."""
    jcfg, cfg, jp, tp = _mamba_setup(16)
    jx, tx = _randn(1, 1, 24, cfg.d_model)
    with pytest.raises(AssertionError):
        jmamba2.mamba2_forward(jp, jcfg, jx)
    with pytest.raises(AssertionError):
        mamba2.mamba2_forward(tp, cfg, tx)


def test_mamba2_chunk_ref_oracle():
    """The oracle agrees with an independent numpy loop and with the JAX
    package's oracle."""
    B, S, nh, dh, ds = 1, 16, 2, 4, 3
    rng = np.random.default_rng(2)
    x = rng.standard_normal((B, S, nh, dh)).astype(np.float32)
    la = -rng.random((B, S, nh)).astype(np.float32)
    b = rng.standard_normal((B, S, ds)).astype(np.float32)
    c = rng.standard_normal((B, S, ds)).astype(np.float32)
    y = mamba2_chunk_ref(*(torch.from_numpy(a) for a in (x, la, b, c)), chunk=4).numpy()
    state = np.zeros((nh, dh, ds))
    for t in range(S):
        state = state * np.exp(la[0, t])[:, None, None] + np.einsum("hd,s->hds", x[0, t], b[0, t])
        np.testing.assert_allclose(y[0, t], np.einsum("hds,s->hd", state, c[0, t]), rtol=1e-4, atol=1e-5)
    _close(y, jax_mamba2_chunk_ref(*(jnp.asarray(a) for a in (x, la, b, c)), chunk=4))


# ---------------------------------------------------------------------------
# RWKV6
# ---------------------------------------------------------------------------
def test_rwkv6_forward_matches_decode_chain_and_jax():
    jcfg, cfg = _both("rwkv6-1.6b")
    jtp = jrwkv6.rwkv6_tmix_init(jax.random.key(0), jcfg, jnp.float32)
    jcp = jrwkv6.rwkv6_cmix_init(jax.random.key(1), jcfg, jnp.float32)
    tp, cp = _port(jtp), _port(jcp)
    B, S = 2, 20
    jx, tx = _randn(2, B, S, cfg.d_model, scale=0.5)
    y_fwd, (shift, wkv) = rwkv6.rwkv6_tmix_forward(tp, cfg, tx)
    state = cache_lib.init_rwkv6_state(cfg, B, torch.float32, device="cpu")
    outs = []
    for t in range(S):
        yt, state = rwkv6.rwkv6_tmix_decode(tp, cfg, tx[:, t:t + 1], state)
        outs.append(yt)
    _close(y_fwd, torch.cat(outs, 1), rtol=2e-4, atol=2e-4)
    _close(wkv, state.wkv, rtol=2e-4, atol=2e-4)
    jy, (jshift, jwkv) = _jit(jrwkv6.rwkv6_tmix_forward, jcfg)(jtp, jx)
    _close(y_fwd, jy)
    _close(wkv, jwkv)
    _close(shift, jshift)

    yc_fwd, last = rwkv6.rwkv6_cmix_forward(cp, cfg, tx)
    state2 = cache_lib.init_rwkv6_state(cfg, B, torch.float32, device="cpu")
    outs = []
    for t in range(S):
        yt, state2 = rwkv6.rwkv6_cmix_decode(cp, cfg, tx[:, t:t + 1], state2)
        outs.append(yt)
    _close(yc_fwd, torch.cat(outs, 1), rtol=2e-4, atol=2e-4)
    _close(yc_fwd, _jit(jrwkv6.rwkv6_cmix_forward, jcfg)(jcp, jx)[0])


def test_rwkv6_decay_in_unit_interval_and_group_norm_as_jax():
    jcfg, cfg = _both("rwkv6-1.6b")
    jtp = jrwkv6.rwkv6_tmix_init(jax.random.key(0), jcfg, jnp.float32)
    tp = _port(jtp)
    jx, tx = _randn(1, 1, 8, cfg.d_model)
    *_, w = rwkv6._tmix_projections(tp, cfg, tx, torch.zeros_like(tx))
    assert float(w.min()) > 0.0 and float(w.max()) < 1.0
    *_, jw = _jit(jrwkv6._tmix_projections, jcfg)(jtp, jx, jnp.zeros_like(jx))
    _close(w, jw)
    # the group norm is a population variance (JAX's var), not torch's
    # default unbiased one
    _close(rwkv6._group_norm(tx, tp["ln_x"], cfg.rwkv_n_heads),
           jrwkv6._group_norm(jx, jtp["ln_x"], cfg.rwkv_n_heads))


# ---------------------------------------------------------------------------
# MLA
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("q_lora", [True, False])
def test_mla_forward_and_absorbed_decode_match_jax(q_lora):
    jcfg, cfg = _both("deepseek-v2-236b", **({} if q_lora else {"q_lora_rank": 0}))
    jp = jmla.mla_init(jax.random.key(0), jcfg, jnp.float32)
    tp = _port(jp)
    B, S, cap = 2, 12, 12
    jx, tx = _randn(3, B, S, cfg.d_model)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    y, (ckv, krope) = mla.mla_forward(tp, cfg, tx, torch.from_numpy(pos), chunk=5)
    jy, (jckv, jkrope) = _jit(jmla.mla_forward, jcfg, chunk=5)(jp, jx, jnp.asarray(pos))
    for a, b in ((y, jy), (ckv, jckv), (krope, jkrope)):
        _close(a, b)
    # decode from a cache holding the first S - 1 tokens, then past capacity
    jc = jcache.init_mla_cache(jcfg, B, cap, jnp.float32)
    tc = cache_lib.init_mla_cache(cfg, B, cap, torch.float32, device="cpu")
    n = S - 1
    jc = jcache.MLACache(jc.ckv.at[:, :n].set(jckv[:, :n]), jc.krope.at[:, :n].set(jkrope[:, :n]), jc.score,
                         jnp.full((B,), n, jnp.int32))
    tc.ckv[:, :n], tc.krope[:, :n], tc.length[:] = ckv[:, :n], krope[:, :n], n
    jdecode = _jit(jmla.mla_decode, jcfg)
    for step in range(cap - n + 2):  # one step fills the cache, two write past it
        jxt, txt = _randn(10 + step, B, 1, cfg.d_model)
        p = np.full((B,), n + step, np.int32)
        ty, tc, tmass = mla.mla_decode(tp, cfg, txt, tc, torch.from_numpy(p))
        jyt, jc, jmass = jdecode(jp, jxt, jc, jnp.asarray(p))
        _close(ty, jyt)
        _close(tmass, jmass)
    for name, a in bridge.cache_to_numpy(tc).items():
        _close(a, getattr(jc, name))


# ---------------------------------------------------------------------------
# rope / mrope / attention
# ---------------------------------------------------------------------------
def test_rope_relative_property():
    """q.k after rope depends only on the relative distance."""
    d = 32
    q = torch.from_numpy(np.random.default_rng(0).standard_normal((1, 1, 1, d)).astype(np.float32))
    k = torch.from_numpy(np.random.default_rng(1).standard_normal((1, 1, 1, d)).astype(np.float32))

    def score(tq, tk):
        return float((apply_rope(q, torch.tensor([[tq]]), 10000.0) * apply_rope(k, torch.tensor([[tk]]), 10000.0)).sum())
    assert score(5, 3) == pytest.approx(score(105, 103), rel=1e-4)
    assert score(5, 3) != pytest.approx(score(5, 4), rel=1e-3)


def test_mrope_reduces_to_rope_for_text():
    d = 32
    _, x = _randn(0, 2, 6, 4, d)
    pos = torch.arange(6, dtype=torch.int32)[None].expand(2, 6)
    a = apply_rope(x, pos, 10000.0)
    b = apply_mrope(x, pos[:, None, :].expand(2, 3, 6), 10000.0, (4, 6, 6))
    _close(a, b, rtol=1e-5, atol=1e-6)


def test_mrope_with_distinct_axes_matches_jax():
    d = 32
    jx, tx = _randn(0, 2, 6, 4, d)
    pos = np.random.default_rng(1).integers(0, 50, (2, 3, 6)).astype(np.int32)
    _close(apply_mrope(tx, torch.from_numpy(pos), 10000.0, (4, 6, 6)),
           jlayers.apply_mrope(jx, jnp.asarray(pos), 10000.0, (4, 6, 6)))


def test_shared_block_lora_qkv_matches_jax():
    """The per-invocation LoRA on the fused qkv (non-zero B matrices, so
    every invocation's adapter moves q, k and v)."""
    jcfg, cfg = _both("zamba2-1.2b")
    jp = jattn.attn_init(jax.random.key(0), jcfg, jnp.float32, n_lora=3)
    rng = np.random.default_rng(4)
    jp = {**jp, "lora_b": jnp.asarray(rng.standard_normal(jp["lora_b"].shape).astype(np.float32) * 0.1)}
    tp = _port(jp)
    jx, tx = _randn(5, 2, 7, cfg.d_model)
    for idx in (None, 0, 2):
        got = attention._project_qkv(tp, cfg, tx, idx)
        want = _jit(jattn._project_qkv, jcfg)(jp, jx, idx)
        for a, b in zip(got, want):
            _close(a, b)
    assert not torch.allclose(attention._project_qkv(tp, cfg, tx, 0)[0], attention._project_qkv(tp, cfg, tx, 2)[0])


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S,chunk", [(4, 4), (17, 8), (33, 16), (48, 1024)])
def test_blocked_attention_matches_naive_and_jax(S, chunk, causal):
    B, H, Hkv, D = 1, 4, 2, 16
    (jq, q), (jk, k), (jv, v) = (_randn(42 + i, *s) for i, s in
                                 enumerate(((B, S, H, D), (B, S, Hkv, D), (B, S, Hkv, D))))
    out = attention.blocked_attention(q, k, v, causal=causal, chunk=chunk)
    G = H // Hkv
    s = torch.einsum("bqkgd,btkd->bkgqt", q.reshape(B, S, Hkv, G, D), k) / np.sqrt(D)
    if causal:
        s = torch.where(torch.tril(torch.ones(S, S, dtype=torch.bool)), s, torch.full_like(s, -1e30))
    want = torch.einsum("bkgqt,btkd->bqkgd", torch.softmax(s, -1), v).reshape(B, S, H, D)
    _close(out, want, rtol=2e-4, atol=2e-4)
    _close(out, jax.jit(lambda *a: jattn.blocked_attention(*a, causal=causal, chunk=chunk))(jq, jk, jv))
