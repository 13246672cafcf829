"""The bridge between the JAX package and the port: parameter and cache
round trips are bitwise exact, in f32 and bf16."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import cache as jcache
from repro.models import model as jmodel
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.models import cache as tcache


def _bitwise_equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype
    assert np.array_equal(a.view(np.uint8), b.view(np.uint8))


@pytest.mark.parametrize("arch", ["qwen2.5-0.5b", "smollm-135m"])
def test_params_round_trip_bitwise(arch):
    jcfg = jax_get_config(arch, reduced=True)
    np_tree = jax.tree.map(np.asarray, jmodel.init_params(jax.random.key(1), jcfg))
    params = bridge.params_from_jax(np_tree, get_config(arch, reduced=True), "cpu")
    assert params["groups"][0]["attn"]["wq"].shape == np_tree["groups"][0]["attn"]["wq"].shape
    back = bridge.params_to_numpy(params)
    jax.tree.map(_bitwise_equal, np_tree, back)


def test_params_bf16_round_trip_bitwise():
    jcfg = dataclasses.replace(jax_get_config("qwen2.5-0.5b", reduced=True), param_dtype="bfloat16")
    np_tree = jax.tree.map(np.asarray, jmodel.init_params(jax.random.key(2), jcfg))
    params = bridge.params_from_jax(np_tree, get_config("qwen2.5-0.5b", reduced=True), "cpu")
    assert params["embed"].dtype == torch.bfloat16
    back = bridge.params_to_numpy(params)
    jax.tree.map(lambda a, b: _bitwise_equal(a.astype(np.float32), b), np_tree, back)


def test_params_keys_are_checked():
    cfg = get_config("qwen2.5-0.5b", reduced=True)
    np_tree = jax.tree.map(np.asarray, jmodel.init_params(jax.random.key(0), jax_get_config("qwen2.5-0.5b", reduced=True)))
    np_tree["head"] = np_tree["embed"].T  # tied config: no head
    with pytest.raises(ValueError):
        bridge.params_from_jax(np_tree, cfg, "cpu")


def _random_leaves(cache, seed):
    """The reference cache with every leaf filled from a numpy seed."""
    rng = np.random.default_rng(seed)

    def fill(a):
        if jnp.issubdtype(a.dtype, jnp.floating):
            return jnp.asarray(rng.standard_normal(a.shape, dtype=np.float32)).astype(a.dtype)
        return jnp.asarray(rng.integers(0, 100, a.shape).astype(np.int32))

    return jax.tree.map(fill, cache)


@pytest.mark.parametrize("kind", ["full", "synapse"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_caches_round_trip_bitwise(kind, dtype):
    jcfg = dataclasses.replace(jax_get_config("qwen2.5-0.5b", reduced=True), compute_dtype=dtype)
    spec = jmodel.CacheSpec(kind=kind, capacity=32, n_landmarks=8, window=8, n_inject=4)
    ref = _random_leaves(jmodel.init_caches(jcfg, 3, spec), 0)
    np_side = jax.tree.map(np.asarray, ref)
    caches = bridge.caches_from_numpy(np_side, "cpu")
    assert isinstance(caches.groups[0], tcache.SynapseCache if kind == "synapse" else tcache.FullCache)
    back = bridge.caches_to_numpy(caches)
    for g_ref, g_back in zip(np_side.groups, back["groups"]):
        for f, a in g_back.items():
            _bitwise_equal(np.asarray(getattr(g_ref, f)).astype(a.dtype), a)
    # and back into the reference's own dataclasses
    cls = jcache.SynapseCache if kind == "synapse" else jcache.FullCache
    rebuilt = cls(**{f: jnp.asarray(v).astype(getattr(np_side.groups[0], f).dtype) for f, v in back["groups"][0].items()})
    jax.tree.map(_bitwise_equal, jax.tree.map(np.asarray, rebuilt), np_side.groups[0])


def _bridge_inputs():
    jcfg = jax_get_config("qwen2.5-0.5b", reduced=True)
    np_tree = jax.tree.map(np.asarray, jmodel.init_params(jax.random.key(3), jcfg))
    spec = jmodel.CacheSpec(kind="synapse", capacity=16, n_landmarks=4, window=4, n_inject=2)
    np_caches = jax.tree.map(np.asarray, _random_leaves(jmodel.init_caches(jcfg, 2, spec), 1))
    return np_tree, np_caches


_ENTRY_POINTS = {
    "params_from_jax": lambda t, c, **kw: bridge.params_from_jax(t, get_config("qwen2.5-0.5b", reduced=True), **kw),
    "cache_from_numpy": lambda t, c, **kw: bridge.cache_from_numpy(c.groups[0], **kw),
    "caches_from_numpy": lambda t, c, **kw: bridge.caches_from_numpy(c, **kw),
}


@pytest.mark.parametrize("entry", sorted(_ENTRY_POINTS))
def test_bridge_without_device_asks_for_the_card(entry, monkeypatch):
    """No device named means the card: with none, the bridge raises instead
    of handing back CPU tensors."""
    np_tree, np_caches = _bridge_inputs()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _ENTRY_POINTS[entry](np_tree, np_caches)


@pytest.mark.parametrize("entry", sorted(_ENTRY_POINTS))
def test_bridge_cpu_device_round_trips_bitwise(entry):
    np_tree, np_caches = _bridge_inputs()
    got = _ENTRY_POINTS[entry](np_tree, np_caches, device="cpu")
    if entry == "params_from_jax":
        assert got["embed"].device.type == "cpu"
        jax.tree.map(_bitwise_equal, np_tree, bridge.params_to_numpy(got))
        return
    groups = [got] if entry == "cache_from_numpy" else list(got.groups)
    for g_ref, g in zip(np_caches.groups, groups):
        for f, a in bridge.cache_to_numpy(g).items():
            assert getattr(g, f).device.type == "cpu"
            _bitwise_equal(np.asarray(getattr(g_ref, f)).astype(a.dtype), a)
