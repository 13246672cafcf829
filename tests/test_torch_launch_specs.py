"""The port's placement rules and input tables against the reference's.

For all eleven archs at full size, on meshes known by their shape alone
(the reference's ``jax.sharding.AbstractMesh``, a ``{axis: size}``
mapping on the port's side) of (16, 16), (2, 16, 16), (32, 8), (2, 32, 8)
and (2, 2): ``param_specs`` of the whole train state, ``cache_specs``
(both ``synapse_token_shard`` values) of every plan's caches,
``batch_specs`` of the train batch and ``fit_spec`` give, leaf by leaf and
dim by dim, the axes the reference's give. For every arch x shape:
``plan_for`` equal, and the abstract caches' shapes and dtypes equal.
Everything is abstract on both sides (``jax.eval_shape``, ``meta``).
"""
import functools

import jax
import pytest
from jax.sharding import AbstractMesh
from jax.sharding import PartitionSpec as P

from repro import configs as jconfigs
from repro.launch import sharding as jsharding
from repro.launch import specs as jspecs
from repro.training import trainer as jtrainer
from repro_torch.configs import get_config, list_archs
from repro_torch.launch import sharding, specs
from repro_torch.training.trainer import abstract_train_state

ARCHS = list_archs()
MESHES = {"16x16": (16, 16), "2x16x16": (2, 16, 16), "32x8": (32, 8), "2x32x8": (2, 32, 8), "2x2": (2, 2)}


def _names(shape):
    return ("pod", "data", "model") if len(shape) == 3 else ("data", "model")


def _meshes(name):
    shape = MESHES[name]
    return AbstractMesh(shape, _names(shape)), dict(zip(_names(shape), shape))


def _entry(e):
    return tuple(e) if isinstance(e, (tuple, list)) else e


def _ref_specs(tree) -> dict:
    leaves = jax.tree_util.tree_flatten_with_path(tree, is_leaf=lambda x: isinstance(x, P))[0]
    return {tuple(jsharding._path_names(path)): tuple(_entry(e) for e in spec) for path, spec in leaves}


def _port_specs(tree) -> dict:
    out = {}
    sharding._map_with_names(lambda names, spec: out.__setitem__(tuple(names), tuple(_entry(e) for e in spec)), tree)
    return out


def _assert_same(got: dict, want: dict):
    assert got.keys() == want.keys(), sorted(set(got) ^ set(want))[:5]
    for k in want:
        # a PartitionSpec drops trailing Nones the port keeps: compare padded
        g, w = got[k], want[k] + (None,) * (len(got[k]) - len(want[k]))
        assert g == w, (k, g, w)


@functools.cache
def _abstract(arch):
    """(reference train state, port train state) abstract, full size."""
    return jtrainer.abstract_train_state(jconfigs.get_config(arch)), abstract_train_state(get_config(arch))


@functools.cache
def _caches(arch, shape):
    jcfg, cfg = jconfigs.get_config(arch), get_config(arch)
    jplan, plan = jspecs.plan_for(jcfg, shape), specs.plan_for(cfg, shape)
    if plan.skip or plan.cache_kind == "none":
        return None
    return jspecs.abstract_caches(jcfg, jplan)[0], specs.abstract_caches(cfg, plan)[0]


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_match_the_reference(arch, mesh):
    jmesh, pmesh = _meshes(mesh)
    jstate, state = _abstract(arch)
    for fsdp_on in (True, False):
        want = _ref_specs(jsharding.param_specs(jstate, jconfigs.get_config(arch), jmesh, fsdp_on=fsdp_on))
        _assert_same(_port_specs(sharding.param_specs(state, get_config(arch), pmesh, fsdp_on=fsdp_on)), want)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_and_batch_specs_match_the_reference(arch, mesh):
    jmesh, pmesh = _meshes(mesh)
    jcfg, cfg = jconfigs.get_config(arch), get_config(arch)
    for shape in specs.SHAPES:
        pair = _caches(arch, shape)
        if pair is None:
            continue
        for tok in (True, False):
            want = _ref_specs(jsharding.cache_specs(pair[0], jcfg, jmesh, synapse_token_shard=tok))
            _assert_same(_port_specs(sharding.cache_specs(pair[1], cfg, pmesh, synapse_token_shard=tok)), want)
    jbatch = jspecs.train_batch_specs(jcfg, 4096, 256)
    batch = specs.train_batch_specs(cfg, 4096, 256)
    _assert_same(_port_specs(sharding.batch_specs(batch, cfg, pmesh)),
                 _ref_specs(jsharding.batch_specs(jbatch, jcfg, jmesh)))


@pytest.mark.parametrize("mesh", list(MESHES))
def test_fit_spec_matches_the_reference(mesh):
    jmesh, pmesh = _meshes(mesh)
    dp = tuple(a for a in _names(MESHES[mesh]) if a != "model")
    for shape in ((256, 151936), (1, 4096), (32, 2048), (128, 9), (6, 7, 8)):
        for axes in ([dp, None], [None, "model"], [dp, "model"], ["model", dp], [("pod", "data") if
                                                                            len(dp) == 2 else "data", None]):
            axes = (axes + [None] * len(shape))[:len(shape)]
            want = tuple(_entry(e) for e in jsharding.fit_spec(jmesh, shape, axes))
            got = tuple(_entry(e) for e in sharding.fit_spec(pmesh, shape, axes))
            assert got == want + (None,) * (len(got) - len(want)), (shape, axes)


@pytest.mark.parametrize("arch", ARCHS)
def test_plans_and_abstract_caches_match_the_reference(arch):
    jcfg, cfg = jconfigs.get_config(arch), get_config(arch)
    for shape in specs.SHAPES:
        jplan, plan = jspecs.plan_for(jcfg, shape), specs.plan_for(cfg, shape)
        assert (plan.arch, plan.shape, plan.kind, plan.seq, plan.batch, plan.cache_kind, plan.skip) == (
            jplan.arch, jplan.shape, jplan.kind, jplan.seq, jplan.batch, jplan.cache_kind, jplan.skip)
        want_inputs, want_spec = jspecs.input_specs(jcfg, jplan) if not jplan.skip else (None, None)
        if plan.skip:
            continue
        got_inputs, got_spec = specs.input_specs(cfg, plan)
        assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1]) for k, v in got_inputs.items()} == {
            k: (tuple(v.shape), str(v.dtype)) for k, v in want_inputs.items()}
        assert (got_spec is None) == (want_spec is None)
        pair = _caches(arch, shape)
        if pair is None:
            continue
        want = {k: (tuple(v.shape), str(v.dtype)) for k, v in _flat_ref(pair[0]).items()}
        got = {}
        sharding._map_with_names(lambda n, t: got.__setitem__(tuple(n), (tuple(t.shape), str(t.dtype).split(".")[-1])),
                                 pair[1])
        assert got == want


def _flat_ref(tree) -> dict:
    return {tuple(jsharding._path_names(p)): leaf for p, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}
