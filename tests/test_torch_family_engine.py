"""The Cortex main path on the other families, on the CPU: the port's
CortexEngine against the JAX package's (serial loop) with bridged weights
on reduced zamba2 (hybrid: Mamba2 layers and a shared attention block with
its stacked caches), rwkv6 (attention-free: spawn copies the state, merge
blends it) and qwen3-moe (MoE: the global decode dispatch); then, on
reduced zamba2, the ModelCaches traversal that carries ``shared`` along,
the BatchServer's rollback, hibernate and wake, and the launcher.

Greedy equality is asserted only where no sampled step sits on a near-tie:
the run records the top-2 logit margin of every greedy lane that lands in a
ring and holds it above MARGIN (the logit tolerance, 1e-4). Gate scores
agree within 1e-4. A Mamba2 prefill takes at most ``ssm_chunk`` tokens (32
here) or a multiple, as in the reference, so prompts stay short.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core.engine import CortexEngine as JaxEngine
from repro.core.prism import Prism as JaxPrism
from repro.data.tokenizer import ByteTokenizer as JaxTokenizer
from repro.models import model as jmodel
from repro.serving.sampler import SamplingParams as JaxSampling
from repro_torch import bridge
from repro_torch.checkpoint import io as tio
from repro_torch.configs import get_config
from repro_torch.core import engine as tengine
from repro_torch.core.engine import CortexEngine
from repro_torch.core.prism import Prism
from repro_torch.data.tokenizer import ByteTokenizer
from repro_torch.memory import SynapseStore
from repro_torch.models import cache as cache_lib
from repro_torch.models import model as tmodel
from repro_torch.serving import server as tserver
from repro_torch.serving.sampler import SamplingParams
from repro_torch.serving.server import BatchServer

MARGIN = 1e-4
GATE_TOL = 1e-4
KW = dict(n_main=2, max_side=2, main_capacity=128, side_max_steps=6, inject_tokens=8, theta=-1.0, sync_every=4)
PROMPTS = ["hi [TASK: check it] ok", "go [TASK: two] on"]  # 23 and 19 tokens with the BOS
N_TICKS = 28
ENGINE_ARCHS = ["zamba2-1.2b", "rwkv6-1.6b", "qwen3-moe-30b-a3b"]



@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Small CPU ops run fastest on one thread; a parallel test run puts
    several workers on few cores, where each worker's intra-op thread
    pool would contend with the others'."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

def _weights(arch):
    jcfg = jax_get_config(arch, reduced=True)
    jp = jax.jit(lambda: jmodel.init_params(jax.random.key(0), jcfg))()
    cfg = get_config(arch, reduced=True)
    return jcfg, jp, cfg, bridge.params_from_jax(jax.tree.map(np.asarray, jp), cfg, "cpu")


def _engine(params, cfg, **kw):
    return CortexEngine(Prism(params, cfg, device="cpu"), ByteTokenizer(cfg.vocab_size),
                        sampling=SamplingParams(greedy=True), pipeline=False, device="cpu", **{**KW, **kw})


def _drive(eng, n=N_TICKS):
    for lane, p in enumerate(PROMPTS):
        eng.submit(p, lane=lane)
    eng.run(n)
    return eng


@pytest.fixture(scope="module", params=ENGINE_ARCHS)
def pair(request):
    """(reference engine, port engine, the port's greedy margins) after the
    same run."""
    jcfg, jp, cfg, params = _weights(request.param)
    ref = _drive(JaxEngine(JaxPrism(jp, jcfg), JaxTokenizer(jcfg.vocab_size),
                           sampling=JaxSampling(greedy=True), pipeline=False, **KW))
    eng = _engine(params, cfg)
    margins = []
    real = tengine.sample_lanes

    def recording(gen, logits, lanes, **kw):
        st = eng.state
        kept = [st.main_active]
        if logits.shape[0] > st.main_active.shape[0]:
            kept.append(st.side_active & (st.side_step >= st.side_plen - 1))
        top2 = torch.topk(logits, 2, dim=-1).values
        margins.extend((top2[:, 0] - top2[:, 1])[torch.cat(kept)].tolist())
        return real(gen, logits, lanes, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tengine, "sample_lanes", recording)
        _drive(eng)
    return ref, eng, margins


def test_engine_greedy_margins_clear_the_tolerance(pair):
    _, _, margins = pair
    assert len(margins) > 40
    assert min(margins) > MARGIN, f"near-tie: min top-2 margin {min(margins):.3g}"


def test_engine_streams_history_and_gates_equal_jax(pair):
    ref, eng, _ = pair
    for a, b in zip(ref.mains + ref.sides, eng.mains + eng.sides):
        assert b.tokens == a.tokens, a.agent_id
        assert (b.active, b.position, b.steps) == (a.active, a.position, a.steps)
    events = [(e["event"], e["agent"]) for e in ref.history]
    assert [e for e, _ in events].count("spawn") == 2 and [e for e, _ in events].count("merge") == 2
    assert [(e["event"], e["agent"]) for e in eng.history] == events
    for a, b in zip(ref.history, eng.history):
        if a["event"] == "merge":
            assert b["accepted"] == a["accepted"] and b["thought"] == a["thought"]
            assert abs(b["gate_score"] - a["gate_score"]) < GATE_TOL
    # the port's own counters (the reference has none): spawns, the side
    # lanes decoded, how ticks were issued, the bytes of caches and states
    # and the Mamba2 layer steps, held to the reference's history
    own = {"spawns", "spawns_dropped", "side_lane_ticks", "live_side_lane_ticks",
           "graph_ticks", "eager_ticks", "graph_captures",
           "recurrent_state_bytes", "attn_cache_bytes", "state_copy_bytes", "state_blend_bytes",
           "mamba_steps", "mamba_kernel_steps"}
    for key, val in eng.stats.items():
        if key not in own:
            assert val == ref.stats[key], key
    assert eng.stats["spawns"] == 2 and eng.stats["spawns_dropped"] == 0
    assert 0 < eng.stats["live_side_lane_ticks"] <= eng.stats["side_lane_ticks"]
    # each spawn copies, and each merge blends, one river lane's recurrent state
    held = eng.stats["recurrent_state_bytes"] + eng.stats["attn_cache_bytes"]
    assert held == sum(t.numel() * t.element_size()
                       for c in (eng.state.main_caches, eng.state.side_caches) for t in c.tensors())
    lane = eng.stats["recurrent_state_bytes"] // (eng.n_main + eng.max_side)
    assert eng.stats["state_copy_bytes"] == eng.stats["state_blend_bytes"] == 2 * lane
    # on the CPU every dispatched tick is eager
    hist = eng.stats["window_hist"]
    assert eng.stats["eager_ticks"] == sum(n * c for n, c in hist.items()) > 0
    assert eng.stats["graph_ticks"] == eng.stats["graph_captures"] == 0
    # each Mamba2 layer of the river's decode every tick and of the sides'
    # on the ticks that step them; the CPU takes the plain step
    layers = sum(g.count for g in eng.cfg.layer_groups() if g.kind == "mamba2")
    side_ticks = eng.stats["side_lane_ticks"] // eng.max_side
    assert eng.stats["mamba_steps"] == layers * (eng.stats["eager_ticks"] + side_ticks)
    assert (eng.stats["mamba_steps"] > 0) == (eng.cfg.block_kind == "mamba2")
    assert eng.stats["mamba_kernel_steps"] == 0


def test_engine_caches_and_per_agent_bytes_equal_jax(pair):
    """Every river cache leaf after the merges (the shared caches, blended
    recurrent states, MoE layers' caches) and each agent's device bytes,
    which count the shared caches too."""
    ref, eng, _ = pair
    want = bridge.caches_to_numpy(bridge.caches_from_numpy(jax.tree.map(np.asarray, ref.state.main_caches), "cpu"))
    got = bridge.caches_to_numpy(eng.state.main_caches)
    for a, b in zip(jax.tree.leaves(want), jax.tree.leaves(got)):
        if np.issubdtype(a.dtype, np.integer):
            np.testing.assert_array_equal(b, a)
        else:
            np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-4)
    assert eng.memory_report()["per_agent_bytes"] == ref.memory_report()["per_agent_bytes"]


# ---------------------------------------------------------------------------
# reduced zamba2: the shared cache everywhere
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def zamba():
    cfg = get_config("zamba2-1.2b", reduced=True)
    f32 = dataclasses.replace(cfg, compute_dtype="float32")
    return cfg, tmodel.init_params(f32, seed=0, device="cpu")


def test_model_caches_traversal_covers_shared(zamba):
    """lane_caches, write_lane, the engine's lane slice, spawn_caches and the
    bridge all carry ``shared`` (the [n_inv, B, ...] stacked invocations)."""
    cfg, _ = zamba
    spec = tmodel.CacheSpec(kind="full", capacity=16)
    caches = tmodel.init_caches(cfg, 3, spec, device="cpu")
    assert isinstance(caches.shared, cache_lib.FullCache)
    assert caches.shared.k.shape[:2] == (cfg.n_shared_attn_invocations, 3)
    assert len(caches.parts()) == len(caches.groups) + 1
    for i, a in enumerate(caches.tensors()):
        a.copy_(torch.full_like(a, i + 1))
    lane = tmodel.lane_caches(caches, 1)
    assert lane.shared is not None and lane.shared.k.shape[1] == 1
    fresh = tmodel.init_caches(cfg, 3, spec, device="cpu")
    tmodel.write_lane(fresh, lane, 2)
    for a, b in zip(fresh.tensors(), caches.tensors()):
        assert torch.equal(a[:, 2], b[:, 1]) and not torch.equal(a[:, 0], b[:, 1])
    assert len(tengine._lane_slice(caches, 0)) == len(caches.tensors())
    # a spawn compresses the shared cache into synapse caches and hands the
    # Mamba2 states over
    caches.shared.length.fill_(10)
    side = tengine.spawn_caches(cfg, tmodel.lane_caches(caches, 0), tmodel.CacheSpec(
        kind="synapse", n_landmarks=4, window=4, n_inject=2))
    assert isinstance(side.shared, cache_lib.SynapseCache) and isinstance(side.groups[0], cache_lib.Mamba2State)
    assert side.groups[0] is not None and torch.equal(side.groups[0].ssm, caches.groups[0].ssm[:, 0:1])
    back = bridge.caches_from_numpy(bridge.caches_to_numpy(caches), "cpu")
    assert all(torch.equal(a, b) for a, b in zip(back.tensors(), caches.tensors()))


def test_hibernate_snapshot_key_paths_equal_the_reference(zamba):
    """The snapshot's leaf paths (the cold codec's keys) are the reference's:
    ``['caches'].shared.k`` beside ``['caches'].groups[0].conv``."""
    cfg, _ = zamba
    jcfg = jax_get_config("zamba2-1.2b", reduced=True)
    spec = dict(kind="full", capacity=16)
    ours = tio.tree_flatten_with_path({"caches": tmodel.lane_caches(
        tmodel.init_caches(cfg, 2, tmodel.CacheSpec(**spec), device="cpu"), 0)})
    ref = jax.tree_util.tree_flatten_with_path(
        {"caches": jax.eval_shape(lambda: jmodel.init_caches(jcfg, 1, jmodel.CacheSpec(**spec)))})[0]
    assert [k for k, _ in ours] == [jax.tree_util.keystr(k) for k, _ in ref]
    assert "['caches'].shared.k" in [k for k, _ in ours]


def _greedy_eos(params, cfg, tok, cache_kind):
    """A token the model emits greedily mid-stream: as the EOS id it ends
    greedy requests by surprise, so the pipelined loop must roll back."""
    srv = BatchServer(params, cfg, tok, n_lanes=2, capacity=64, sampling=SamplingParams(greedy=True),
                      cache_kind=cache_kind, device="cpu")
    srv.submit("probe the stream", max_new_tokens=12)
    done = srv.run_until_done(pipeline=False)
    return done[0].tokens[done[0].prompt_len:][3]


@pytest.mark.parametrize("cache_kind", ["full", "synapse"])
def test_batchserver_pipeline_matches_serial_through_rollbacks(zamba, cache_kind):
    """Pipelined == serial, bitwise, through surprise-EOS rollbacks: the
    undo restores the Mamba2 states and the shared caches with the rest."""
    cfg, params = zamba
    tok = ByteTokenizer(cfg.vocab_size)
    tok.eos_id = _greedy_eos(params, cfg, tok, cache_kind)
    reqs = [("first request", 6, SamplingParams(greedy=True)), ("second", 9, SamplingParams(temperature=0.9)),
            ("probe the stream", 12, SamplingParams(greedy=True)), ("probe the stream", 30, SamplingParams(greedy=True))]
    outs = []
    for pipeline in (True, False):
        srv = BatchServer(params, cfg, tok, n_lanes=2, capacity=64, sampling=SamplingParams(temperature=1.0),
                          seed=7, cache_kind=cache_kind, device="cpu")
        for prompt, mnt, sp in reqs:
            srv.submit(prompt, max_new_tokens=mnt, sampling=sp)
        done = srv.run_until_done(max_ticks=300, pipeline=pipeline)
        outs.append(sorted((r.rid, tuple(r.tokens), r.text, r.status) for r in done))
        if pipeline:
            assert srv.stats["rollbacks"] >= 1 and srv.stats["overlapped"] > 0
    assert outs[0] == outs[1] and len(outs[0]) == len(reqs)


@pytest.mark.parametrize("arch", ["zamba2-1.2b", "deepseek-v2-236b"])
def test_undo_record_restores_every_part_bitwise(arch):
    """One in-place decode step, then its undo: every tensor as it was —
    Mamba2 states and the shared cache (zamba2), MLA latents (deepseek)."""
    cfg = get_config(arch, reduced=True)
    params = tmodel.init_params(dataclasses.replace(cfg, compute_dtype="float32"), seed=0, device="cpu")
    srv = BatchServer(params, cfg, ByteTokenizer(cfg.vocab_size), n_lanes=2, capacity=64,
                      sampling=SamplingParams(greedy=True), device="cpu")
    srv.submit("undo probe", max_new_tokens=8)
    srv._admit()
    before = [a.clone() for a in srv.caches.tensors()]
    rec = tserver._undo_record(srv.caches)
    srv._step(srv._host_toks())
    after = srv.caches.tensors()
    changed = [not torch.equal(a, b) for a, b in zip(before, after)]
    assert any(changed)
    if srv.caches.shared is not None:
        n_shared = len(cache_lib.tensors(srv.caches.shared))
        assert any(changed[-n_shared:])  # the shared cache moved too
    tserver._undo(srv.caches, rec)
    for a, b in zip(before, after):
        assert torch.equal(a, b)


@pytest.mark.parametrize("tier", ["warm", "cold"])
def test_hibernate_wake_round_trip_is_bitwise(zamba, tier, tmp_path):
    """A side (mid-decode) and a river without children hibernate and wake
    at the same boundary: every stream, spawn and merge (gate scores
    included) equals a never-hibernated run's."""
    cfg, params = zamba

    def run(hibernate):
        store = SynapseStore(cold_dir=str(tmp_path / "cold"), warm_capacity_bytes=1) if tier == "cold" else None
        eng = CortexEngine(Prism(params, cfg, device="cpu"), ByteTokenizer(cfg.vocab_size),
                           sampling=SamplingParams(greedy=True), device="cpu", store=store,
                           **{**KW, "side_max_steps": 10})
        eng.submit(PROMPTS[0], lane=0, agent_id="alice")
        eng.submit("plain river bob", lane=1, agent_id="bob")
        eng.run(12)
        if hibernate:
            side = next(s for s in eng.sides if s.active)
            assert side.steps > 0
            eng.hibernate(side.agent_id)
            eng.hibernate("bob")
            if tier == "cold":
                assert store.tier_of("bob") == "cold"
            eng.wake("bob", wait=True)
            eng.wake(side.agent_id, wait=True)
        eng.run(32)
        return ([list(v.tokens) for v in eng.mains + eng.sides],
                [(e["event"], e.get("agent"), e.get("gate_score")) for e in eng.history
                 if e["event"] in ("spawn", "merge")])

    want, got = run(False), run(True)
    assert got == want
    assert [e for e, *_ in want[1]].count("merge") == 1


@pytest.mark.parametrize("mode", ["cortex", "batch"])
@pytest.mark.parametrize("arch", ["zamba2-1.2b", "deepseek-v2-236b"])
def test_launcher_serves_the_family_on_the_cpu(arch, mode, capsys):
    """``python -m repro_torch.launch.serve --device cpu --arch <id>``."""
    from repro_torch.launch import serve

    m = serve.main(["--device", "cpu", "--arch", arch, "--mode", mode, "--max-new-tokens", "4", "--no-stream"])
    assert m["completed"] == 2
    assert "serving on cpu: 2 completed" in capsys.readouterr().out
