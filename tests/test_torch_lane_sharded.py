"""The port's lane groups on the CPU: the nine cases of
``tests/test_lane_sharded.py``, the lane-mesh cases of
``tests/test_memory_tiers.py`` (``test_mesh1_*``, ``test_mesh8_*``) and
``tests/test_resilience.py`` (``*_on_mesh``), and a stochastic river.

A lane group of 2 and one of 4 ranks (gloo, one process per rank, spawned
by the module's fixture: ``torch_lane_jobs``) each run every scenario once,
with ``max_side = 8``; the test functions assert on the ranks' readings
against the same scenarios on the port's ``mesh=None`` engine, run here.
The reference's multi-device cases need eight forced XLA devices; its
mesh-of-one cases fail under the installed JAX (a sharding error at
``repro/models/model.py:344``), so, as those tests do, the port's lane
engine is held to the ``mesh=None`` engine, and the mesh of one (a gloo
group of one, in this process) also to the reference's ``mesh=None``
greedy tokens.

* PARITY — greedy river and side streams, spawns, merges (verdicts and gate
  scores bitwise) and the dispatch accounting equal the plain engine's, on
  every rank, across hibernate/wake (sides woken into another rank's
  lanes) and across a kill and restart (a store per rank);
* DISPATCH COUNT — ``run(n)`` issues ``ceil(n / sync_every)`` windows;
* NO HOST READ INSIDE A WINDOW — the window runs with every host read of a
  tensor refused; its drain makes one host sync and one ring all-gather;
* PLACEMENT — a rank allocates its block of side lanes only, the river
  whole; the memory report equals the plain engine's;
* a stochastic river is equal on every rank and repeats.
"""
import dataclasses
import math

import jax
import numpy as np
import pytest
import torch.distributed as dist
from test_torch_families import _one_torch_thread  # noqa: F401 (autouse: one intra-op thread)

import torch_lane_jobs as jobs
from repro.configs import get_config as jax_get_config
from repro.core.engine import CortexEngine as JaxEngine
from repro.core.prism import Prism as JaxPrism
from repro.data.tokenizer import ByteTokenizer as JaxTokenizer
from repro.models import model as jmodel
from repro.serving.sampler import SamplingParams as JaxSampling
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.launch.mesh import make_lane_mesh
from repro_torch.launch.sharding import lane_owner

WORLDS = (2, 4)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{world: [each rank's readings]} and the plain engine's readings."""
    root = tmp_path_factory.mktemp("lanes")
    started = {w: jobs.Ranks(jobs.lane_engine_job, w, root / f"w{w}", cold_root=str(root / f"cold{w}"))
               for w in WORLDS}
    setup = jobs.reduced()
    plain = {
        "pair": jobs.pair_run(setup, None),
        "ceil": jobs.ceil_run(setup, None),
        "placement": jobs.placement(jobs.engine(setup, None)),
        "hibernate": jobs.hibernate_script(setup, None, max_side=8),
        "side_swap": {w: jobs.side_swap_script(setup, None, max_side=w) for w in WORLDS},
        "spread": {w: jobs.spread_run(setup, None, max_side=w) for w in WORLDS},
        "kill_restart": jobs.kill_restart(setup, None, str(root / "cold_plain")),
        "batch": {p: jobs.batch_run(setup, None, p) for p in (True, False)},
    }
    return {w: job.results() for w, job in started.items()}, plain


@pytest.mark.parametrize("world", WORLDS)
def test_lane_sharded_matches_single_device_bitwise(runs, world):
    ranks, plain = runs
    want = {k: plain["pair"][k] for k in ("mains", "sides", "history", "stats")}
    assert any(e[0] == "merge" for e in want["history"]) and any(e[0] == "spawn" for e in want["history"])
    for r in ranks[world]:
        assert {k: r["pair"][k] for k in want} == want, r["rank"]


@pytest.mark.parametrize("world", WORLDS)
def test_lane_dispatch_count_is_ceil(runs, world):
    ranks, plain = runs
    assert plain["ceil"] == [math.ceil(n / 4) for n in (8, 7, 3, 1)]
    for r in ranks[world]:
        assert r["pair"]["dispatches"] == 24 // 4
        assert r["ceil"] == plain["ceil"]


@pytest.mark.parametrize("world", WORLDS)
def test_zero_host_syncs_inside_sharded_window(runs, world):
    """A window dispatched with every host read of a tensor refused: one
    dispatch, no host sync, no collective; its drain makes one host sync
    and one all-gather of the side rings, and lands sync_every tokens."""
    ranks, _ = runs
    for r in ranks[world]:
        w = r["window"]
        assert (w["dispatches"], w["syncs_inside"], w["gathers_inside"]) == (1, 0, 0)
        assert (w["syncs_drain"], w["gathers_drain"]) == (1, 1)
        assert w["new_tokens"] == w["sync_every"]


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_donation_no_peak_doubling(runs, world):
    """The memory report of the lane engine is the plain engine's (agents,
    per-agent cache bytes, totals), and more windows leave it unchanged."""
    ranks, plain = runs
    want = plain["pair"]["memory"]
    for r in ranks[world]:
        assert r["pair"]["memory"] == want
        assert r["pair"]["memory_after"] == want["total"]


@pytest.mark.parametrize("world", WORLDS)
def test_side_state_is_lane_sharded(runs, world):
    """Each rank allocates max_side / world side lanes (caches on their
    lane dim, dim 1) and the whole river; the river's generator starts
    alike on every rank, the sides' differently; the side attend goes
    through piece_attend."""
    ranks, plain = runs
    want = plain["placement"]
    for r in ranks[world]:
        p = r["placement"]
        assert p["side_tok"] == (8 // world,) and p["side_cache_lanes"] == [8 // world]
        assert p["side_bytes"] * world == want["side_bytes"]
        assert p["main_bytes"] == want["main_bytes"] and p["main_tok"] == want["main_tok"]
        assert p["river_gen"] == want["river_gen"] and p["lane_mesh_shape"] == (world,)
        assert p["side_attend"] == "piece" and want["side_attend"] == "kernel"
    assert len({tuple(r["placement"]["side_gen"]) for r in ranks[world]}) == world


@pytest.mark.parametrize("world", WORLDS)
def test_max_side_must_divide_lane_axis(runs, world):
    ranks, _ = runs
    for r in ranks[world]:
        assert r["refused"] is not None and "multiple of the lane-axis" in r["refused"]


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("pipeline", [True, False])
def test_batch_server_lane_placement(runs, world, pipeline):
    """Request lanes split over the ranks; greedy outputs bitwise the
    unsharded server's, on both loops."""
    ranks, plain = runs
    for r in ranks[world]:
        assert r["batch"][pipeline] == plain["batch"][pipeline]


def test_property_lane_sharded_equals_single_device(runs):
    """The reference's hypothesis property at world 2: random prompts,
    windows and spawn/merge interleavings, the lane engine equal to a plain
    engine token for token, with ceil(n / sync_every) dispatches (the
    examples are derandomised, so both ranks run the same ones)."""
    ranks, _ = runs
    records = [r["property"] for r in ranks[2]]
    if records[0] is None:
        pytest.skip("hypothesis not installed")
    assert records[0] == records[1] and len(records[0]) == 4
    for rec in records[0]:
        assert rec["main_equal"] and rec["sides_equal"], rec
        assert rec["dispatches"] == rec["want_dispatches"], rec


@pytest.mark.parametrize("world", WORLDS)
def test_mesh8_hibernate_wake_parity(runs, world):
    """``test_mesh8_hibernate_wake_parity`` on a lane group of ``world``:
    a river hibernated and woken is bitwise the plain engine's."""
    ranks, plain = runs
    for r in ranks[world]:
        assert r["hibernate"] == plain["hibernate"]


@pytest.mark.parametrize("world", WORLDS)
def test_sides_woken_into_each_others_lanes_across_ranks(runs, world):
    """Two sides hibernated mid-decode, each woken into the lane the other
    held (a lane of another rank): streams, history and accounting bitwise
    the plain engine's."""
    ranks, plain = runs
    want = plain["side_swap"][world]
    (before, after) = want["lanes"]
    assert after == {a: before[b] for a, b in zip(before, reversed(list(before)))}
    assert len({lane_owner(lane, world, world) for lane in before.values()}) == 2
    for r in ranks[world]:
        assert r["side_swap"] == want


@pytest.mark.parametrize("world", WORLDS)
def test_sides_on_every_rank_merge_in_turn(runs, world):
    """One side per rank (max_side = world), merging at different drains:
    each merge stops its own lane only; every stream, merge and gate score
    bitwise the plain engine's."""
    ranks, plain = runs
    want = plain["spread"][world]
    merges = [e for e in want["history"] if e[0] == "merge"]
    assert len(merges) == min(3, world)  # a side beyond max_side is dropped
    for r in ranks[world]:
        assert r["spread"] == want


@pytest.mark.parametrize("world", WORLDS)
def test_kill_and_restart_replays_bitwise_on_mesh(runs, world):
    """A store per rank: the hibernated river goes cold on every rank, a new
    store recovers it, a new lane engine adopts and wakes it, and its
    stream is the never-killed run's, and the plain engine's."""
    ranks, plain = runs
    for r in ranks[world]:
        kr = r["kill_restart"]
        assert kr["tier"] == "cold" and kr["recovered"] == ["alice"] and kr["adopted"] == ["alice"]
        assert kr["hibernated"] and kr["recoveries"] == 1
        assert kr["restarted"] == kr["ref"] == plain["kill_restart"]["ref"]


@pytest.mark.parametrize("world", WORLDS)
def test_stochastic_river_is_equal_on_every_rank_and_repeats(runs, world):
    """Temperature sampling with sides spawned and merged: the river draws
    from a generator seeded alike on every rank, each rank's sides from
    their own, so every rank holds the same river, the same gathered side
    streams and the same history, and a second run repeats the first."""
    ranks, _ = runs
    first = ranks[world][0]["stochastic"][0]
    assert any(e[0] == "merge" for e in first["history"])
    for r in ranks[world]:
        assert r["stochastic"][0] == r["stochastic"][1] == first


# ---------------------------------------------------------------------------
# the mesh of one: a gloo group of one rank, in this process
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def mesh1(tmp_path_factory):
    path = tmp_path_factory.mktemp("mesh1") / "store"
    dist.init_process_group("gloo", store=dist.FileStore(str(path), 1), rank=0, world_size=1)
    yield make_lane_mesh(device="cpu")
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def bridged():
    """The reference's reduced weights, and the port's copy of them."""
    jcfg = dataclasses.replace(jax_get_config("qwen2.5-0.5b", reduced=True), compute_dtype="float32")
    jp = jmodel.init_params(jax.random.key(0), jcfg)
    cfg = dataclasses.replace(get_config("qwen2.5-0.5b", reduced=True), compute_dtype="float32")
    return jcfg, jp, (cfg, bridge.params_from_jax(jax.tree.map(np.asarray, jp), cfg, "cpu"))


def test_mesh_of_one_matches_plain_engine(mesh1, bridged):
    """The whole lane path (gloo group, piece attend, ring gather, split
    generators, local lane indexing) on one rank equals the port's plain
    engine bitwise, and the reference's ``mesh=None`` greedy tokens."""
    jcfg, jp, setup = bridged
    prompt = "mesh of one [TASK: go] probe"
    lane = jobs.engine(setup, mesh1, max_side=2)
    ref = jobs.engine(setup, None, max_side=2)
    jeng = JaxEngine(JaxPrism(jp, jcfg), JaxTokenizer(jcfg.vocab_size), max_side=2, side_max_steps=6,
                     sampling=JaxSampling(greedy=True), sync_every=4, **jobs.ENGINE_KW)
    for e in (lane, ref, jeng):
        e.submit(prompt, lane=0)
        e.run(12)
    assert jobs.streams(lane) == jobs.streams(ref)
    assert lane.stats["ring_gathers"] == lane.stats["drains"] > 0
    assert lane.mains[0].tokens == ref.mains[0].tokens == list(jeng.mains[0].tokens)
    for sl, sr, sj in zip(lane.sides, ref.sides, jeng.sides):
        assert sl.tokens == sr.tokens == list(sj.tokens)


def test_mesh1_hibernate_wake_parity(mesh1):
    """The reference's ``test_mesh1_hibernate_wake_parity``: hibernate and
    wake through the lane gather and scatter on a group of one."""
    setup = jobs.reduced()
    assert jobs.hibernate_script(setup, mesh1, max_side=2) == jobs.hibernate_script(setup, None, max_side=2)


def test_make_lane_mesh_takes_the_first_ranks(runs):
    """``make_lane_mesh(2)`` on 4 ranks: the first two form the group, the
    others are refused."""
    ranks, _ = runs
    got = [r["subgroup"] for r in ranks[4]]
    assert got[:2] == [(0, 2, [10, 11]), (1, 2, [10, 11])]
    assert all("outside the 2-lane group" in g for g in got[2:])


def test_make_lane_mesh_refuses_a_group_smaller_than_asked(mesh1):
    with pytest.raises(ValueError, match="2 lanes > 1 ranks"):
        make_lane_mesh(2, device="cpu")
    assert make_lane_mesh(1, device="cpu").world == 1 and mesh1.shape == {"lane": 1}
