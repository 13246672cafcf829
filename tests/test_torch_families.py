"""Every architecture of the port against the JAX package, on the reduced
configs in f32 with bridged weights: the registry and configs, the
parameter layout, forward, prefill and decode logits and every cache leaf,
and the port's counterparts of ``tests/test_configs_smoke.py`` and of the
per-family cases of ``tests/test_decode_consistency.py``.

Tolerances: logits and cache floats within rtol = atol = 1e-4. The largest
errors seen on these inputs are ~6e-5 (rwkv6's forward over 24 tokens: its
recurrence and per-head group norm amplify the summation-order noise) and
below 1e-5 elsewhere; integer leaves must be equal. The JAX side is jitted
(one compile per function and arch, not one per eager op).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import model as jmodel
from repro_torch import bridge, configs
from repro_torch.configs import get_config
from repro_torch.core.engine import CortexEngine
from repro_torch.core.prism import Prism
from repro_torch.data.tokenizer import ByteTokenizer
from repro_torch.models import model as tmodel
from repro_torch.serving.server import BatchServer

ARCHS = list(jconfigs.ARCHS)
TOL = dict(rtol=1e-4, atol=1e-4)
B, S, P = 2, 24, 16  # batch, sequence, prompt (S - P decode steps)



@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Small CPU ops run fastest on one thread; a parallel test run puts
    several workers on few cores, where each worker's intra-op thread
    pool would contend with the others'."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

def _cfgs(arch, **kw):
    kw = {"compute_dtype": "float32", **kw}
    return (dataclasses.replace(jconfigs.get_config(arch, reduced=True), **kw),
            dataclasses.replace(get_config(arch, reduced=True), **kw))


def _inputs(cfg, n, seed=1):
    """Token ids, or frame embeddings for the models without an embedding
    input, as (jax inputs, port inputs)."""
    rng = np.random.default_rng(seed)
    if cfg.embed_inputs:
        a = rng.integers(0, cfg.vocab_size, (B, n)).astype(np.int32)
        return {"tokens": jnp.asarray(a)}, {"tokens": torch.from_numpy(a)}
    a = rng.standard_normal((B, n, cfg.d_model)).astype(np.float32)
    return {"embeds": jnp.asarray(a)}, {"embeds": torch.from_numpy(a)}


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **TOL)


def _assert_caches_close(jc, tc):
    """Every leaf of every part (groups and shared): integers equal, floats
    within TOL, -inf where the reference has -inf."""
    ref = bridge.caches_to_numpy(bridge.caches_from_numpy(jax.tree.map(np.asarray, jc), "cpu"))
    got = bridge.caches_to_numpy(tc)
    assert (ref["shared"] is None) == (got["shared"] is None)
    for r, g in zip(ref["groups"] + [ref["shared"] or {}], got["groups"] + [got["shared"] or {}]):
        assert r.keys() == g.keys()
        for name in r:
            assert r[name].shape == g[name].shape, name
            if np.issubdtype(r[name].dtype, np.integer):
                np.testing.assert_array_equal(g[name], r[name], err_msg=name)
            else:
                np.testing.assert_allclose(g[name], r[name], err_msg=name, **TOL)


@pytest.fixture(scope="module", params=ARCHS)
def family(request):
    arch = request.param
    return (arch, *_weights(arch))


def _weights(arch):
    """(jax cfg, port cfg, JAX params, the port's bridged params)."""
    jcfg, cfg = _cfgs(arch)
    jp = jax.jit(lambda: jmodel.init_params(jax.random.key(0), jcfg))()
    return jcfg, cfg, jp, bridge.params_from_jax(jax.tree.map(np.asarray, jp), cfg, "cpu")


# ---------------------------------------------------------------------------
# registry, configs, parameter layout
# ---------------------------------------------------------------------------
def test_registry_and_configs_equal_the_reference():
    assert list(configs.ARCHS) == ARCHS == configs.list_archs()
    for arch in ARCHS:
        for reduced in (False, True):
            assert (dataclasses.asdict(get_config(arch, reduced))
                    == dataclasses.asdict(jconfigs.get_config(arch, reduced))), (arch, reduced)
        cfg, jcfg = get_config(arch), jconfigs.get_config(arch)
        assert cfg.param_count() == jcfg.param_count()
        assert cfg.active_param_count() == jcfg.active_param_count()
        assert cfg.n_shared_attn_invocations == jcfg.n_shared_attn_invocations
        assert ([dataclasses.astuple(g) for g in cfg.layer_groups()]
                == [dataclasses.astuple(g) for g in jcfg.layer_groups()])
        assert ([dataclasses.astuple(s) for s in tmodel.build_segments(cfg)]
                == [dataclasses.astuple(s) for s in jmodel.build_segments(jcfg)])


def test_exact_assigned_configs():
    """The full configs match the assignment table exactly."""
    rows = {
        "zamba2-1.2b": (38, 2048, 32, 32, 8192, 32000),
        "qwen2-vl-72b": (80, 8192, 64, 8, 29568, 152064),
        "rwkv6-1.6b": (24, 2048, 32, 32, 7168, 65536),
        "qwen3-moe-30b-a3b": (48, 2048, 32, 4, 768, 151936),
        "qwen1.5-110b": (80, 8192, 64, 8, 49152, 152064),
        "qwen3-8b": (36, 4096, 32, 8, 12288, 151936),
        "hubert-xlarge": (48, 1280, 16, 16, 5120, 504),
        "deepseek-v2-236b": (60, 5120, 128, 128, 1536, 102400),
        "qwen3-4b": (36, 2560, 32, 8, 9728, 151936),
        "smollm-135m": (30, 576, 9, 3, 1536, 49152),
    }
    for arch, (L, d, h, kv, ff, v) in rows.items():
        cfg = get_config(arch)
        assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_ff, cfg.vocab_size) == (
            L, d, h, kv, ff, v), arch
    assert get_config("zamba2-1.2b").ssm_state_size == 64
    assert get_config("zamba2-1.2b").n_shared_attn_invocations == 6
    assert get_config("qwen3-moe-30b-a3b").n_experts == 128
    assert get_config("qwen3-moe-30b-a3b").experts_per_token == 8
    ds = get_config("deepseek-v2-236b")
    assert ds.kv_lora_rank == 512 and ds.n_experts == 160 and ds.experts_per_token == 6
    assert ds.n_shared_experts == 2 and ds.attn_kind == "mla"
    assert get_config("qwen2-vl-72b").rope_kind == "mrope"
    assert not get_config("hubert-xlarge").causal


def test_param_counts_plausible():
    """Analytic counts land near the advertised sizes."""
    approx = {
        "smollm-135m": (0.134e9, 0.35), "qwen3-8b": (8.2e9, 0.35), "qwen1.5-110b": (111e9, 0.25),
        "deepseek-v2-236b": (236e9, 0.35), "qwen3-moe-30b-a3b": (30.5e9, 0.35),
        "rwkv6-1.6b": (1.6e9, 0.5), "zamba2-1.2b": (1.2e9, 0.6),
    }
    for arch, (target, tol) in approx.items():
        n = get_config(arch).param_count()
        assert abs(n - target) / target < tol, (arch, n, target)
    moe_cfg = get_config("qwen3-moe-30b-a3b")
    assert moe_cfg.active_param_count() < moe_cfg.param_count() * 0.25
    assert 2e9 < moe_cfg.active_param_count() < 5e9  # "A3B"


@pytest.mark.parametrize("arch", ARCHS)
def test_param_layout_equals_the_reference(arch):
    """The port's own init_params: the reference's tree, leaf by leaf (the
    same keys, shapes and dtypes), so weights bridge both ways."""
    jcfg, cfg = jconfigs.get_config(arch, reduced=True), get_config(arch, reduced=True)
    ref = jax.tree_util.tree_flatten_with_path(jax.eval_shape(lambda: jmodel.init_params(jax.random.key(0), jcfg)))[0]
    ours = tmodel.init_params(cfg, seed=0, device="cpu")
    ours_np = bridge.params_to_numpy(ours)
    got = jax.tree_util.tree_flatten_with_path(ours_np)[0]
    assert [jax.tree_util.keystr(k) for k, _ in got] == [jax.tree_util.keystr(k) for k, _ in ref]
    for (k, a), (_, b) in zip(got, ref):
        assert a.shape == b.shape and a.dtype == b.dtype, jax.tree_util.keystr(k)
    # and the bridge takes the reference's tree back bitwise
    back = bridge.params_to_numpy(bridge.params_from_jax(ours_np, cfg, "cpu"))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(ours_np)):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# the port against the JAX package, every arch
# ---------------------------------------------------------------------------
def _prefix(cfg, inputs, n):
    out = {k: v[:, :n] for k, v in inputs.items()}
    if cfg.rope_kind == "mrope":
        pos = np.broadcast_to(np.arange(n, dtype=np.int32)[None, None], (B, 3, n)).copy()
        out["positions"] = pos
    return out


def _step(cfg, inputs, t):
    pos = np.full((B, 3) if cfg.rope_kind == "mrope" else (B,), t, np.int32)
    if cfg.embed_inputs:
        return {"tokens": inputs["tokens"][:, t], "positions": pos}
    return {"embeds": inputs["embeds"][:, t], "positions": pos}


def _as_jax(d):
    return {k: jnp.asarray(np.asarray(v)) for k, v in d.items()}


def _as_torch(d):
    return {k: v if isinstance(v, torch.Tensor) else torch.from_numpy(np.asarray(v)) for k, v in d.items()}


def _run_both(family, kind):
    """Prefill P tokens and decode S - P more on both packages; returns the
    worst logit errors and the final caches."""
    arch, jcfg, cfg, jp, tp = family
    jin, tin = _inputs(cfg, S)
    spec_kw = dict(kind=kind, capacity=S + 8, n_landmarks=8, window=8, n_inject=4)
    jspec, tspec = jmodel.CacheSpec(**spec_kw), tmodel.CacheSpec(**spec_kw)
    jprefill = jax.jit(lambda p, i, c: jmodel.prefill(p, jcfg, i, c, spec=jspec))
    jdecode = jax.jit(lambda p, i, c: jmodel.decode_step(p, jcfg, i, c, spec=jspec))
    jc = jmodel.init_caches(jcfg, B, jspec)
    tc = tmodel.init_caches(cfg, B, tspec, device="cpu")
    pj, pt = _prefix(cfg, jin, P), _prefix(cfg, tin, P)
    lj, hj, jc = jprefill(jp, _as_jax(pj), jc)
    lt, ht, tc = tmodel.prefill(tp, cfg, _as_torch(pt), tc, spec=tspec)
    _close(lt, lj)
    _close(ht, hj)
    for t in range(P, S):
        lj, _, jc = jdecode(jp, _as_jax(_step(cfg, jin, t)), jc)
        lt, _, tc = tmodel.decode_step(tp, cfg, _as_torch(_step(cfg, tin, t)), tc, spec=tspec)
        _close(lt, lj)
    return jc, tc


def test_forward_matches_jax(family):
    arch, jcfg, cfg, jp, tp = family
    jin, tin = _inputs(cfg, S)
    jl, jaux = jax.jit(lambda p, i: jmodel.forward(p, jcfg, i))(jp, jin)
    tl, taux = tmodel.forward(tp, cfg, tin)
    assert tl.shape == (B, S, cfg.vocab_size) and bool(torch.isfinite(tl).all())
    _close(tl, jl)
    for k in ("lb_loss", "drop_frac", "hidden_last"):
        _close(taux[k], jaux[k])


def test_prefill_decode_and_caches_match_jax(family):
    arch, jcfg, cfg = family[:3]
    if not cfg.causal:  # encoder-only: no prefill or decode, in both packages
        with pytest.raises(AssertionError, match="encoder-only"):
            _run_both(family, "full")
        return
    jc, tc = _run_both(family, "full")
    _assert_caches_close(jc, tc)


@pytest.mark.parametrize("arch", ["zamba2-1.2b", "qwen2-vl-72b", "qwen3-moe-30b-a3b"])
def test_synapse_caches_match_jax(arch):
    """Synapse-kind caches: zamba2's shared invocations (compressed from its
    stacked shared cache), M-RoPE positions in the window, MoE."""
    jc, tc = _run_both((arch, *_weights(arch)), "synapse")
    _assert_caches_close(jc, tc)


def test_encoder_and_mrope_refusals_follow_the_reference():
    """The reference asserts at an encoder's prefill and its decode fails on
    one position per lane for M-RoPE; the port's model asserts the same
    way, and its serving entry points refuse both families at once."""
    jcfg, cfg = _cfgs("hubert-xlarge")
    spec = tmodel.CacheSpec(capacity=8)
    with pytest.raises(AssertionError, match="encoder-only"):
        jmodel.prefill({}, jcfg, {"embeds": jnp.zeros((1, 4, cfg.d_model))}, None, spec=jmodel.CacheSpec())
    with pytest.raises(AssertionError, match="encoder-only"):
        tmodel.prefill({}, cfg, {"embeds": torch.zeros(1, 4, cfg.d_model)}, None, spec=spec)
    vcfg = dataclasses.replace(jconfigs.get_config("qwen2-vl-72b", reduced=True), compute_dtype="float32")
    jp = jmodel.init_params(jax.random.key(0), vcfg)
    jc = jmodel.init_caches(vcfg, 1, jmodel.CacheSpec(capacity=8))
    with pytest.raises(IndexError):
        jmodel.decode_step(jp, vcfg, {"tokens": jnp.zeros((1,), jnp.int32), "positions": jnp.zeros((1,), jnp.int32)},
                           jc, spec=jmodel.CacheSpec(capacity=8))
    tok = ByteTokenizer(512)
    for arch in ("hubert-xlarge", "qwen2-vl-72b"):
        c = get_config(arch, reduced=True)
        p = tmodel.init_params(c, device="cpu")
        with pytest.raises(ValueError, match=c.name):
            CortexEngine(Prism(p, c, device="cpu"), tok, n_main=1, max_side=1, device="cpu")
        with pytest.raises(ValueError, match=c.name):
            BatchServer(p, c, tok, n_lanes=1, capacity=16, device="cpu")


# ---------------------------------------------------------------------------
# the port's own consistency: prefill + decode reproduce the forward
# (tests/test_decode_consistency.py, on the port)
# ---------------------------------------------------------------------------
DC_TOL = 5e-4


def _roundtrip(cfg, P_frac=0.75, S=32, B=2, spec=None):
    params = tmodel.init_params(cfg, seed=0, device="cpu")
    tok = torch.randint(0, cfg.vocab_size, (B, S), generator=torch.Generator().manual_seed(1), dtype=torch.int32)
    logits_ref, _ = tmodel.forward(params, cfg, {"tokens": tok})
    spec = spec or tmodel.CacheSpec(kind="full", capacity=S + 8)
    caches = tmodel.init_caches(cfg, B, spec, device="cpu")
    P = int(S * P_frac)
    lg, _, caches = tmodel.prefill(params, cfg, {"tokens": tok[:, :P]}, caches, spec=spec)
    errs = [float((lg - logits_ref[:, P - 1]).abs().max())]
    for t in range(P, S):
        pos = torch.full((B,), t, dtype=torch.int32)
        lg, _, caches = tmodel.decode_step(params, cfg, {"tokens": tok[:, t], "positions": pos}, caches, spec=spec)
        errs.append(float((lg - logits_ref[:, t]).abs().max()))
    return errs


@pytest.mark.parametrize(
    "arch", ["qwen3-8b", "qwen1.5-110b", "smollm-135m", "qwen2.5-0.5b", "zamba2-1.2b", "rwkv6-1.6b"])
def test_decode_matches_forward(arch):
    cfg = dataclasses.replace(get_config(arch, reduced=True), compute_dtype="float32")
    errs = _roundtrip(cfg)
    assert max(errs) < DC_TOL, errs


def test_mla_decode_matches_forward():
    # MLA alone, without MoE router top-k flips
    cfg = dataclasses.replace(get_config("deepseek-v2-236b", reduced=True), compute_dtype="float32",
                              n_experts=0, n_shared_experts=0, experts_per_token=0, first_k_dense=0)
    errs = _roundtrip(cfg)
    assert max(errs) < DC_TOL, errs


def test_moe_decode_router_agreement():
    """Dropless MoE: the prefill is exact; decode (the global dispatch) stays
    finite (its router may flip on ~1e-6 perturbations)."""
    cfg = dataclasses.replace(get_config("deepseek-v2-236b", reduced=True), compute_dtype="float32",
                              moe_capacity_factor=100.0)
    errs = _roundtrip(cfg)
    assert all(np.isfinite(errs)), errs
    assert errs[0] < DC_TOL


def test_synapse_cache_exact_when_lossless():
    """k >= prompt length and window >= generated: the synapse cache is exact."""
    cfg = dataclasses.replace(get_config("qwen3-8b", reduced=True), compute_dtype="float32")
    spec = tmodel.CacheSpec(kind="synapse", n_landmarks=64, window=64, n_inject=4)
    errs = _roundtrip(cfg, S=48, spec=spec)
    assert max(errs) < DC_TOL, errs


def test_vlm_decode_runs():
    cfg = dataclasses.replace(get_config("qwen2-vl-72b", reduced=True), compute_dtype="float32")
    Bv, Sv = 2, 16
    params = tmodel.init_params(cfg, seed=0, device="cpu")
    emb = torch.randn((Bv, Sv, cfg.d_model), generator=torch.Generator().manual_seed(1))
    pos = torch.arange(Sv, dtype=torch.int32)[None, None].expand(Bv, 3, Sv)
    spec = tmodel.CacheSpec(kind="full", capacity=Sv + 4)
    caches = tmodel.init_caches(cfg, Bv, spec, device="cpu")
    tmodel.prefill(params, cfg, {"embeds": emb, "positions": pos}, caches, spec=spec)
    lg, _, _ = tmodel.decode_step(params, cfg, {"tokens": torch.zeros(Bv, dtype=torch.int32),
                                                "positions": torch.full((Bv, 3), Sv, dtype=torch.int32)},
                                  caches, spec=spec)
    assert lg.shape == (Bv, cfg.vocab_size) and bool(torch.isfinite(lg).all())


@pytest.mark.parametrize("arch", ARCHS)
def test_reduced_forward(arch):
    """tests/test_configs_smoke.py::test_reduced_forward on the port."""
    cfg = get_config(arch, reduced=True)
    assert cfg.n_layers <= 2 and cfg.d_model <= 512
    if cfg.is_moe:
        assert cfg.n_experts <= 4
    params = tmodel.init_params(cfg, seed=0, device="cpu")
    _, inputs = _inputs(cfg, 32)
    logits, _ = tmodel.forward(params, cfg, inputs)
    assert logits.shape == (B, 32, cfg.vocab_size)
    assert bool(torch.isfinite(logits).all())
