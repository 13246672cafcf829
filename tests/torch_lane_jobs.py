"""Lane-group jobs for the CPU tests: the port's lane-sharded engine and
BatchServer run on N gloo ranks, each a process spawned by the test.

:class:`Ranks` starts one job (one process per rank, ``spawn``, one
intra-op thread each, a process group over a file under the test's
directory) and :meth:`Ranks.results` joins it with a deadline: a rank that
fails, or a job that overruns, kills every rank and fails the test with
each rank's traceback. Every rank builds the reduced Qwen2.5-0.5B (f32)
from the same seed and runs the same scenario; what it returns is pickled
to a file the parent reads. The scenarios take ``mesh=None`` too: the
parent runs them on the plain engine and compares.

This module imports torch and the port only, so the ranks start without
JAX.
"""
from __future__ import annotations

import dataclasses
import datetime
import math
import multiprocessing as mp
import pickle
import sys
import time
import traceback
from pathlib import Path

import torch
import torch.distributed as dist

DEADLINE_S = 120.0
ENGINE_KW = dict(n_main=1, main_capacity=128, inject_tokens=8, theta=-1.0)
PROMPT = "hello [TASK: go] world"
PROMPT_A = "calm text with no tags at all"
PROMPT_B = "another quiet prompt, still tagless"


# ---------------------------------------------------------------------------
# the job runner
# ---------------------------------------------------------------------------
def _rank_main(fn, rank: int, world: int, out_dir: str, kwargs: dict):
    torch.set_num_threads(1)
    status, value = "ok", None
    try:
        dist.init_process_group("gloo", init_method=f"file://{out_dir}/init", rank=rank, world_size=world,
                                timeout=datetime.timedelta(seconds=DEADLINE_S))
        value = fn(**kwargs)
    except BaseException:  # reported to the parent, which fails the test
        status, value = "error", traceback.format_exc()
    with open(f"{out_dir}/rank{rank}.pkl", "wb") as f:
        pickle.dump((status, value), f)
    if dist.is_initialized():
        dist.destroy_process_group()
    sys.exit(0 if status == "ok" else 1)


class Ranks:
    """One job: ``fn(**kwargs)`` on ``world`` gloo ranks, started now."""

    def __init__(self, fn, world: int, out_dir: Path, **kwargs):
        self.name, self.world, self.dir = fn.__name__, world, Path(out_dir)
        self.dir.mkdir(parents=True, exist_ok=True)
        ctx = mp.get_context("spawn")
        self.procs = [ctx.Process(target=_rank_main, args=(fn, r, world, str(self.dir), kwargs), daemon=True)
                      for r in range(world)]
        for p in self.procs:
            p.start()
        self.t0 = time.monotonic()

    def results(self, deadline_s: float = DEADLINE_S) -> list:
        """Every rank's return value, in rank order."""
        while time.monotonic() - self.t0 < deadline_s:
            codes = [p.exitcode for p in self.procs]
            if all(c is not None for c in codes) or any(c not in (None, 0) for c in codes):
                break
            time.sleep(0.05)
        overran = [r for r, p in enumerate(self.procs) if p.exitcode is None]
        for p in self.procs:
            if p.is_alive():
                p.kill()
            p.join(10)
        outs, errors = [], []
        for r in range(self.world):
            path = self.dir / f"rank{r}.pkl"
            if not path.exists():
                errors.append(f"rank {r}: no result" + (" (killed)" if r in overran else ""))
                continue
            with open(path, "rb") as f:
                status, value = pickle.load(f)
            if status != "ok":
                errors.append(f"rank {r}:\n{value}")
            outs.append(value)
        if errors:
            raise AssertionError(f"lane job {self.name} on {self.world} ranks failed"
                                 f"{' (deadline ' + str(deadline_s) + ' s)' if overran else ''}:\n"
                                 + "\n".join(errors))
        return outs


# ---------------------------------------------------------------------------
# shared pieces of the scenarios
# ---------------------------------------------------------------------------
def reduced():
    """(cfg, params): the reduced Qwen2.5-0.5B in f32, weights from seed 0."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as tm

    cfg = dataclasses.replace(get_config("qwen2.5-0.5b", reduced=True), compute_dtype="float32")
    return cfg, tm.init_params(cfg, seed=0, device="cpu")


def engine(setup, mesh, *, sync_every=4, max_side=8, side_max_steps=6, sampling=None, **kw):
    from repro_torch.core.engine import CortexEngine
    from repro_torch.core.prism import Prism
    from repro_torch.data.tokenizer import ByteTokenizer
    from repro_torch.serving.sampler import SamplingParams

    cfg, params = setup
    kw = {**ENGINE_KW, **kw}
    return CortexEngine(Prism(params, cfg, device="cpu"), ByteTokenizer(cfg.vocab_size), max_side=max_side,
                        side_max_steps=side_max_steps, sampling=sampling or SamplingParams(greedy=True),
                        sync_every=sync_every, mesh=mesh, device="cpu", **kw)


def streams(eng) -> dict:
    """What the parity checks compare: every lane's tokens, the history
    (spawns, merges with their verdicts and gate scores, hibernates,
    wakes) and the dispatch accounting."""
    keys = ("ticks", "tick_dispatches", "macro_dispatches", "aux_dispatches", "host_syncs", "drains",
            "overlapped_drains", "window_hist", "hibernates", "wakes")
    return {"mains": [list(m.tokens) for m in eng.mains], "sides": [list(s.tokens) for s in eng.sides],
            "history": [(e["event"], e.get("agent"), e.get("lane"), e.get("accepted"), e.get("gate_score"))
                        for e in eng.history],
            "stats": {k: eng.stats[k] for k in keys}}


class NoHostReads:
    """Makes every host read of a tensor raise (``.item()``, ``.tolist()``,
    ``.cpu()``, ``.numpy()``, ``bool``/``int``/``float`` of a tensor): on
    the card each of them would wait for the device."""
    NAMES = ("item", "tolist", "cpu", "numpy", "__bool__", "__int__", "__float__")

    def __enter__(self):
        self.saved = {n: getattr(torch.Tensor, n) for n in self.NAMES}
        for name in self.NAMES:
            def refuse(*a, _name=name, **k):
                raise AssertionError(f"host read of a tensor ({_name}) inside the window")
            setattr(torch.Tensor, name, refuse)
        return self

    def __exit__(self, *exc):
        for n, f in self.saved.items():
            setattr(torch.Tensor, n, f)


def placement(eng) -> dict:
    """Where the engine's state lives on this rank: its side leaves, its
    river leaves, the generators' states."""
    st = eng.state
    side = [st.side_tok, st.side_pos, st.side_active, st.side_step, st.side_plen, st.side_prompt,
            st.side_hidden, st.side_ring, *st.side_caches.tensors()]
    main = [st.main_tok, st.main_pos, st.main_hidden, st.main_ring, *st.main_caches.tensors()]
    nbytes = lambda ts: sum(a.numel() * a.element_size() for a in ts)
    return {"side_tok": tuple(st.side_tok.shape),
            "side_cache_lanes": sorted({a.shape[1] for a in st.side_caches.tensors()}),
            "side_bytes": nbytes(side), "main_bytes": nbytes(main), "main_tok": tuple(st.main_tok.shape),
            "river_gen": st.gen.get_state().tolist(),
            "side_gen": None if st.side_gen is None else st.side_gen.get_state().tolist(),
            "lane_mesh_shape": eng.lane_mesh_shape}


# ---------------------------------------------------------------------------
# scenarios: each takes mesh=None (the plain engine) or a lane group
# ---------------------------------------------------------------------------
def pair_run(setup, mesh) -> dict:
    """The reference's ``pair``: theta=-1 accepts merges, so the side
    thoughts change the replicated river mid-run."""
    eng = engine(setup, mesh)
    eng.submit(PROMPT, lane=0)
    base = eng.stats["tick_dispatches"]
    eng.run(24)
    out = streams(eng)
    out["dispatches"] = eng.stats["tick_dispatches"] - base
    rep = eng.memory_report()
    out["memory"] = {"n_agents": rep["n_agents"], "cache_bytes": rep["total_bytes"] - rep["serving_weight_bytes"],
                     "per_agent": rep["per_agent_bytes"], "total": rep["total_bytes"]}
    eng.run(8)
    out["memory_after"] = eng.memory_report()["total_bytes"]
    return out


def ceil_run(setup, mesh) -> list:
    """Dispatches of partial trailing windows on a fresh engine."""
    eng = engine(setup, mesh, theta=2.0)
    eng.submit("ceil probe", lane=0)
    out = []
    for n in (8, 7, 3, 1):
        b = eng.stats["tick_dispatches"]
        eng.run(n)
        out.append(eng.stats["tick_dispatches"] - b)
    return out


def hibernate_script(setup, mesh, max_side: int) -> tuple:
    """The reference's ``_hibernate_script`` (two rivers)."""
    eng = engine(setup, mesh, n_main=2, max_side=max_side, side_max_steps=50)
    eng.submit(PROMPT_A, lane=0, agent_id="alice")
    eng.run(8)
    eng.hibernate("alice")
    eng.submit(PROMPT_B, lane=0, agent_id="bob")
    eng.run(4)
    eng.wake("alice", wait=True)
    eng.run(8)
    return (list(eng.mains[0].tokens), list(eng.mains[1].tokens),
            [(e["event"], e.get("agent")) for e in eng.history])


def side_swap_script(setup, mesh, max_side: int) -> dict:
    """Two sides hibernated mid-decode and woken into each other's lanes
    (on a lane group of two ranks: into the other rank's block)."""
    eng = engine(setup, mesh, max_side=max_side, side_max_steps=50)
    m = eng.submit(PROMPT_A, lane=0, agent_id="alice")
    a = eng._spawn_side(m, "probe the claim")
    eng.run(4)
    b = eng._spawn_side(m, "weigh the evidence")
    eng.run(24)
    lanes_before = {a.agent_id: a.lane, b.agent_id: b.lane}
    eng.hibernate(a.agent_id)
    eng.hibernate(b.agent_id)
    eng.run(4)
    wb = eng.wake(b.agent_id, wait=True)
    wa = eng.wake(a.agent_id, wait=True)
    eng.run(12)
    out = streams(eng)
    out["lanes"] = (lanes_before, {a.agent_id: wa.lane, b.agent_id: wb.lane})
    return out


def spread_run(setup, mesh, max_side: int) -> dict:
    """Three sides with task prompts of different lengths, so they merge at
    different drains; with ``max_side`` the world size, each on its own rank
    (a merge must stop its own lane only)."""
    eng = engine(setup, mesh, max_side=max_side)
    eng.submit("spread [TASK: a] then [TASK: a longer task prompt here] and [TASK: the longest task prompt "
               "of the three, by far] end", lane=0)
    eng.run(96)
    return streams(eng)


def kill_restart(setup, mesh, cold_dir: str) -> dict:
    """The reference's ``_run_kill_restart``: a river hibernated to disk,
    the process state dropped, a new store and engine recover and wake it."""
    from repro_torch.memory import HIBERNATED, SynapseStore

    n_side = 2 if mesh is None else mesh.world
    store = lambda: SynapseStore(warm_capacity_bytes=1, cold_dir=cold_dir, wake_backoff_s=0.001)
    ref = engine(setup, mesh, n_main=2, max_side=n_side, side_max_steps=50)
    ref.submit(PROMPT_A, lane=0, agent_id="alice")
    ref.submit(PROMPT_B, lane=1, agent_id="bob")
    ref.run(12)
    ref.hibernate("alice")
    ref.run(8)
    ref.wake("alice", wait=True)
    ref.run(12)
    ref_alice = next(m for m in ref.mains if m.agent_id == "alice")

    s1 = store()
    e1 = engine(setup, mesh, n_main=2, max_side=n_side, side_max_steps=50, store=s1)
    e1.submit(PROMPT_A, lane=0, agent_id="alice")
    e1.submit(PROMPT_B, lane=1, agent_id="bob")
    e1.run(12)
    e1.hibernate("alice")
    tier = s1.tier_of("alice")
    del e1, s1  # the crash: every piece of process state is gone

    s2 = store()
    recovered = s2.recover(cold_dir)["recovered"]
    e2 = engine(setup, mesh, n_main=2, max_side=n_side, side_max_steps=50, store=s2)
    adopted = e2.adopt_hibernated()
    status = e2.registry.get("alice").status
    e2.submit(PROMPT_B, lane=1, agent_id="bob")
    e2.run(20)
    e2.wake("alice", wait=True)
    e2.run(12)
    alice = next(m for m in e2.mains if m.active and m.agent_id == "alice")
    return {"tier": tier, "recovered": recovered, "adopted": adopted, "hibernated": status == HIBERNATED,
            "recoveries": e2.stats["recoveries"], "ref": (ref_alice.tokens, ref_alice.text),
            "restarted": (alice.tokens, alice.text)}


def stochastic_run(setup, mesh) -> dict:
    """A stochastic river (temperature 0.8) with sides spawned and merged."""
    from repro_torch.serving.sampler import SamplingParams

    eng = engine(setup, mesh, sampling=SamplingParams(temperature=0.8), side_max_steps=8)
    eng.submit("think [TASK: one] and [TASK: two] on", lane=0)
    eng.run(40)
    return streams(eng)


def batch_run(setup, mesh, pipeline: bool) -> list:
    """The reference's BatchServer lane placement: six requests over eight
    lanes, greedy."""
    from repro_torch.data.tokenizer import ByteTokenizer
    from repro_torch.serving.sampler import SamplingParams
    from repro_torch.serving.server import BatchServer

    cfg, params = setup
    srv = BatchServer(params, cfg, ByteTokenizer(cfg.vocab_size), n_lanes=8, capacity=128,
                      sampling=SamplingParams(greedy=True), seed=0, mesh=mesh, device="cpu")
    for i in range(6):
        srv.submit(f"request {i}", max_new_tokens=12)
    done = srv.run_until_done(pipeline=pipeline)
    return sorted((r.rid, tuple(r.tokens)) for r in done)


def property_examples(setup, mesh) -> list | None:
    """The reference's hypothesis property, run on every rank with the same
    derandomised examples (so the ranks stay in step): random prompts,
    window sizes and spawn/merge interleavings, the lane engine against a
    plain engine on the same rank. Returns one record per example (nothing
    is asserted here: a failure would make the ranks part), or None without
    hypothesis."""
    try:
        from hypothesis import HealthCheck, given, settings, strategies as st
    except ImportError:
        return None
    engines, records = {}, []

    def prop_engine(sync_every, kind):
        key = (sync_every, kind)
        if key not in engines:
            engines[key] = engine(setup, mesh if kind == "lane" else None, sync_every=sync_every,
                                  side_max_steps=4)
        eng = engines[key]
        for s in eng.sides:  # clear streams left over from the previous example
            if s.active:
                eng.retire_side(s.lane)
        return eng

    @settings(max_examples=4, deadline=None, derandomize=True, database=None,
              suppress_health_check=list(HealthCheck))
    @given(prompt=st.text(alphabet="abcdef ", min_size=1, max_size=12), with_task=st.booleans(),
           sync_every=st.sampled_from([2, 4]), n_windows=st.integers(min_value=1, max_value=2),
           extra=st.integers(min_value=0, max_value=1))
    def prop(prompt, with_task, sync_every, n_windows, extra):
        text = prompt + (" [TASK: check] tail" if with_task else "")
        n = n_windows * sync_every + extra
        lane, ref = prop_engine(sync_every, "lane"), prop_engine(sync_every, "ref")
        ml, mr = lane.submit(text, lane=0), ref.submit(text, lane=0)
        base = lane.stats["tick_dispatches"]
        lane.run(n)
        ref.run(n)
        records.append({"text": text, "n": n, "main_equal": ml.tokens == mr.tokens,
                        "sides_equal": all(a.tokens == b.tokens for a, b in zip(lane.sides, ref.sides)),
                        "dispatches": lane.stats["tick_dispatches"] - base,
                        "want_dispatches": math.ceil(n / sync_every)})

    prop()
    return records


# ---------------------------------------------------------------------------
# the jobs
# ---------------------------------------------------------------------------
def lane_engine_job(cold_root: str) -> dict:
    """Every lane-group reading of ``tests/test_torch_lane_sharded.py`` at
    this world size, on this rank."""
    from repro_torch.launch.mesh import make_lane_mesh

    mesh = make_lane_mesh(device="cpu")
    setup = reduced()
    world, out = mesh.world, {"rank": mesh.rank, "world": mesh.world}
    out["pair"] = pair_run(setup, mesh)
    out["ceil"] = ceil_run(setup, mesh)

    # no host read inside a window; one gather and one host sync per drain
    eng = engine(setup, mesh, theta=2.0)
    m = eng.submit("transfer guard probe [TASK: think] x", lane=0)
    eng.run(8)
    base, n_tok = dict(eng.stats), len(m.tokens)
    with NoHostReads():
        eng._dispatch_window(eng.sync_every)
    mid = dict(eng.stats)
    eng.drain()
    out["window"] = {"dispatches": mid["tick_dispatches"] - base["tick_dispatches"],
                     "syncs_inside": mid["host_syncs"] - base["host_syncs"],
                     "gathers_inside": mid["ring_gathers"] - base["ring_gathers"],
                     "syncs_drain": eng.stats["host_syncs"] - mid["host_syncs"],
                     "gathers_drain": eng.stats["ring_gathers"] - mid["ring_gathers"],
                     "new_tokens": len(m.tokens) - n_tok, "sync_every": eng.sync_every}

    out["placement"] = placement(engine(setup, mesh))
    try:
        engine(setup, mesh, max_side=6 if world == 4 else 2 * world - 1)
        out["refused"] = None
    except ValueError as e:
        out["refused"] = str(e)

    out["hibernate"] = hibernate_script(setup, mesh, max_side=8)
    out["side_swap"] = side_swap_script(setup, mesh, max_side=world)
    out["spread"] = spread_run(setup, mesh, max_side=world)
    out["kill_restart"] = kill_restart(setup, mesh, f"{cold_root}/rank{mesh.rank}")
    out["stochastic"] = [stochastic_run(setup, mesh) for _ in range(2)]
    out["batch"] = {p: batch_run(setup, mesh, p) for p in (True, False)}
    out["property"] = property_examples(setup, mesh) if world == 2 else None
    out["subgroup"] = subgroup_of_two(mesh) if world == 4 else None
    return out


def subgroup_of_two(mesh):
    """``make_lane_mesh(2)`` on a group of four: ranks 0 and 1 form the lane
    group (and all-gather over it), ranks 2 and 3 are refused."""
    from repro_torch.launch.mesh import make_lane_mesh
    from repro_torch.launch.sharding import gather_lanes

    try:
        sub = make_lane_mesh(2, device="cpu")
    except ValueError as e:
        return str(e)
    out = torch.empty(2, dtype=torch.int32)
    gather_lanes(sub, out, torch.tensor([10 + mesh.rank], dtype=torch.int32))
    return (sub.rank, sub.world, out.tolist())


def piece_attend_job(seed: int) -> dict:
    """``piece_attend`` with a token axis over this rank's half of every
    piece's keys (``tests/test_torch_synapse_sharded.py``)."""
    import numpy as np

    from repro_torch.core import synapse_sharded as sh
    from repro_torch.launch.mesh import make_lane_mesh

    mesh = make_lane_mesh(device="cpu")
    q, pieces, valids = sharded_inputs(seed)
    own = lambda a: a.chunk(mesh.world, dim=1)[mesh.rank]
    local = [(own(k), own(v)) for k, v in pieces]
    out, masses = sh.piece_attend(q, local, [own(m) for m in valids], 1.0 / q.shape[-1] ** 0.5,
                                  ctx=sh.ShardContext("lane", mesh))
    return {"out": out.numpy(), "masses": [np.asarray(m) for m in masses]}


def sharded_inputs(seed: int):
    """q [2,4,16]; pieces of 8 and 4 keys, [2,T,2,16]; the last key of the
    second piece masked (f32, from a numpy seed)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    B, H, Hkv, D = 2, 4, 2, 16
    t = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
    q = t(B, H, D)
    pieces, valids = [], []
    for i, T in enumerate((8, 4)):
        pieces.append((t(B, T, Hkv, D), t(B, T, Hkv, D)))
        valid = torch.ones((B, T), dtype=torch.bool)
        valid[:, -1] = i == 0
        valids.append(valid)
    return q, pieces, valids
