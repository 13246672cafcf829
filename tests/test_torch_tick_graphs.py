"""The engine's graphed tick (``core/tick_graphs.py``) where the CPU can
hold it: where graphs engage, how a captured tick is cut around the
``synapse_attention`` calls, that a capturing tick computes what the eager
tick computes, the device-cursor ring append, the recapture of a rebound
state, and the benchmark's reader of the counters.

Graphs themselves need the card: ``tests/test_torch_cuda.py`` replays them
there against the eager tick. Here a recorder stands in for the capture
backend: a "capture" issues the work eagerly on the CPU and a "replay"
issues nothing, so what it records is the order of pieces and calls.
"""
import contextlib
import dataclasses
import importlib.util
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core import tick_graphs
from repro_torch.core.engine import CortexEngine
from repro_torch.core.prism import Prism
from repro_torch.data.tokenizer import ByteTokenizer
from repro_torch.kernels import ops
from repro_torch.models import model as tmodel
from repro_torch.serving.sampler import SamplingParams

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    cfg = dataclasses.replace(get_config("qwen2.5-0.5b", reduced=True), compute_dtype="float32", n_layers=3)
    return cfg, tmodel.init_params(cfg, seed=0, device="cpu")


class Recorder:
    """The capture backend's calls in order, with the kernel wrapper's."""

    def __init__(self):
        self.log = []
        self.n = 0

    @contextlib.contextmanager
    def scope(self):
        yield

    def begin(self, generators):
        self.n += 1
        self.log.append(("begin", self.n))
        return self.n

    def end(self, g):
        self.log.append(("end", g))

    def replay(self, g):
        self.log.append(("replay", g))


def _engine(cfg, params, **kw):
    eng = CortexEngine(Prism(params, cfg, device="cpu"), ByteTokenizer(cfg.vocab_size), n_main=2, max_side=3,
                       main_capacity=128, side_max_steps=64, inject_tokens=8, theta=-1.0,
                       sampling=SamplingParams(greedy=True),
                       side_sampling=SamplingParams(temperature=0.9, top_k=20), seed=5, device="cpu", **kw)
    eng.submit("calm words [TASK: look closer] more calm words", lane=0)
    eng.submit("a second [TASK: count the stones] river", lane=1)
    assert sum(s.active for s in eng.sides) == 2
    return eng


def _recorded(eng, monkeypatch):
    rec = Recorder()
    eng._graphs = tick_graphs.TickGraphs("cpu", make_backend=lambda device: rec)
    wrapped = ops.synapse_attention

    def call(*a, **k):
        rec.log.append(("call", tuple(t.shape for t in a)))
        return wrapped(*a, **k)
    monkeypatch.setattr(ops, "synapse_attention", call)
    return rec


def _state(eng):
    st = eng.state
    return [st.rings, st.main_tok, st.main_pos, st.main_hidden, st.side_tok, st.side_pos, st.side_step,
            st.side_hidden, *st.main_caches.tensors(), *st.side_caches.tensors()]


def test_engine_stays_eager_on_the_cpu_and_counts_eager_ticks(setup):
    cfg, params = setup
    eng = _engine(cfg, params, sync_every=4)
    assert eng._graphs is None
    eng.run(8)
    assert eng.stats["eager_ticks"] == eng.stats["ticks"] == 8
    assert (eng.stats["graph_ticks"], eng.stats["graph_captures"]) == (0, 0)


@pytest.mark.parametrize("arch,engages", [
    ("qwen2.5-0.5b", True), ("qwen3-8b", True), ("smollm-135m", True),
    ("zamba2-1.2b", False), ("rwkv6-1.6b", False), ("qwen3-moe-30b-a3b", False), ("deepseek-v2-236b", False),
])
def test_graphs_engage_on_a_card_for_proven_layer_kinds_only(arch, engages):
    cfg = get_config(arch, reduced=True)
    assert tick_graphs.engages(cfg, "cuda", None) is engages
    assert not tick_graphs.engages(cfg, "cpu", None)
    assert not tick_graphs.engages(cfg, "cuda", object())  # a lane group


def test_side_tick_is_cut_around_each_kernel_call(setup, monkeypatch):
    """Warm-up tick: eager, the n calls alone. Capture: the river one piece,
    then n + 1 side pieces around n wrapper calls, each piece run as soon as
    it is captured. Replay: the same pieces in order, the n calls between."""
    cfg, params = setup
    n = cfg.n_layers
    eng = _engine(cfg, params, sync_every=8)
    rec = _recorded(eng, monkeypatch)
    eng._dispatch_window(1)
    assert [e[0] for e in rec.log] == ["call"] * n and eng.stats["eager_ticks"] == 1

    rec.log.clear()
    eng._dispatch_window(1)
    assert eng.stats["graph_captures"] == 1 and eng.stats["graph_ticks"] == 1
    want = [("begin", 1), ("end", 1), ("replay", 1)]  # the river
    for p in range(2, n + 2):
        want += [("begin", p), ("end", p), ("replay", p), "call"]
    want += [("begin", n + 2), ("end", n + 2), ("replay", n + 2)]
    got = [e if e[0] != "call" else "call" for e in rec.log]
    assert got == want
    B, S, H, D = 3, eng.side_spec, cfg.n_heads, cfg.d_head
    T = S.n_landmarks + S.window + S.n_inject
    calls = [e for e in rec.log if e[0] == "call"]
    assert all(c[1] == ((B, H, D), (B, T, cfg.n_kv_heads, D), (B, T, cfg.n_kv_heads, D), (B, T)) for c in calls)

    rec.log.clear()
    eng._dispatch_window(1)
    assert eng.stats["graph_ticks"] == 2 and eng.stats["graph_captures"] == 1
    want = [("replay", 1)]
    for p in range(2, n + 2):
        want += [("replay", p), "call"]
    want += [("replay", n + 2)]
    assert [e if e[0] != "call" else "call" for e in rec.log] == want


def test_river_only_tick_is_two_pieces(setup, monkeypatch):
    cfg, params = setup
    eng = CortexEngine(Prism(params, cfg, device="cpu"), ByteTokenizer(cfg.vocab_size), n_main=1, max_side=2,
                       main_capacity=64, sampling=SamplingParams(greedy=True), sync_every=4, device="cpu")
    eng.submit("a calm river with no tags", lane=0)
    rec = _recorded(eng, monkeypatch)
    eng._dispatch_window(2)
    assert rec.log == [("begin", 1), ("end", 1), ("replay", 1), ("begin", 2), ("end", 2), ("replay", 2)]


def test_capturing_tick_computes_the_eager_tick(setup, monkeypatch):
    """On the CPU a capture issues its work at once, so the capturing tick's
    state is the eager tick's, bitwise: the cut, the static attend buffers
    and the device cursor change nothing (greedy rivers, sampled sides)."""
    cfg, params = setup
    eager = _engine(cfg, params, sync_every=8)
    graphed = _engine(cfg, params, sync_every=8)
    _recorded(graphed, monkeypatch)
    for eng in (eager, graphed):
        eng._dispatch_window(1)  # graphed: the warm-up tick
        eng._dispatch_window(1)  # graphed: the capture
    assert graphed.stats["graph_captures"] == 1
    assert (eager.state.rings[:, 1] >= 0).any()
    for a, b in zip(_state(eager), _state(graphed)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("R", [1, 8])
def test_device_cursor_ring_append_writes_the_int_cursor_rings(R):
    g = torch.Generator().manual_seed(0)
    rings = torch.full((5, R), -1, dtype=torch.int32)
    by_int, by_dev = rings.clone(), rings.clone()
    cur = torch.zeros(1, dtype=torch.int64)
    for c in range(R):
        vals = torch.randint(-1, 300, (5,), generator=g, dtype=torch.int32)
        for rows in (slice(0, 2), slice(2, 5)):
            ops.ring_append(by_int[rows], vals[rows], c)
            cur.fill_(c)
            ops.ring_append(by_dev[rows], vals[rows].long(), cur)
        assert torch.equal(by_int, by_dev)
    assert (by_int >= -1).all() and not torch.equal(by_int, rings)


def test_a_rebound_state_tensor_recaptures(setup, monkeypatch):
    cfg, params = setup
    eng = _engine(cfg, params, sync_every=8)
    _recorded(eng, monkeypatch)
    eng._dispatch_window(1)
    eng._dispatch_window(1)
    eng._dispatch_window(1)
    assert (eng.stats["graph_captures"], eng.stats["graph_ticks"]) == (1, 2)
    eng.state.side_tok = eng.state.side_tok.clone()  # rebound: the graphs' address is stale
    eng._dispatch_window(1)
    assert (eng.stats["graph_captures"], eng.stats["graph_ticks"]) == (2, 3)
    eng._dispatch_window(1)
    assert (eng.stats["graph_captures"], eng.stats["graph_ticks"]) == (2, 4)


def test_synapse_attention_writes_given_outputs():
    g = torch.Generator().manual_seed(1)
    q = torch.randn(2, 4, 8, generator=g)
    k, v = torch.randn(2, 6, 2, 8, generator=g), torch.randn(2, 6, 2, 8, generator=g)
    valid = torch.tensor([[1, 1, 1, 0, 0, 0], [1, 1, 1, 1, 1, 1]], dtype=torch.bool)
    want = ops.synapse_attention(q, k, v, valid)
    out, mass = torch.empty_like(q), torch.empty(2, 6)
    got = ops.synapse_attention(q, k, v, valid, out=out, mass=mass)
    assert got[0] is out and got[1] is mass
    assert torch.equal(out, want[0]) and torch.equal(mass, want[1])
    with pytest.raises(ValueError, match="mass"):
        ops.synapse_attention(q, k, v, valid, mass=torch.empty(2, 5))


def _reader(name):
    path = ROOT / "cortex_bench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@pytest.mark.parametrize("stats,want", [
    ({"graph_ticks": 297, "eager_ticks": 3}, 99.0),
    ({"graph_ticks": 0, "eager_ticks": 40}, 0.0),
    ({"ticks": 40}, None),  # a program without the counters
    ({"graph_ticks": 0, "eager_ticks": 0}, None),
])
def test_graphed_tick_pct_reader(stats, want):
    assert _reader("graphed_tick_pct.agents")(SimpleNamespace(engine={"stats": stats})) == want
