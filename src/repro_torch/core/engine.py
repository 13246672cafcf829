"""The Cortex Engine — River & Stream topology on one card.

Port of the JAX package's ``repro.core.engine``. One Prism (shared weights)
drives:

* the river lanes, decoding over full KV caches;
* the stream (side) lanes, decoding over landmark-compressed synapse caches
  through the ``synapse_attention`` kernel;
* per-lane sampling, and small on-device token rings.

A window is up to ``max_window`` virtual ticks: a Python loop of ticks
whose sampled tokens go to the rings, with no host sync inside it (no
``.item()``, ``.tolist()``, ``.cpu()`` or boolean-mask indexing). Each
drain copies the rings to the host once, then runs the host-side control
plane: UTF-8 decoding, the router, spawns and merges.

* PIPELINED DRAINS: ``run(n)`` fetches window *t*'s rings (the one
  blocking copy per window) and, when a conservative gate on the raw ring
  bytes proves window *t* carries no router trigger and completes no side,
  dispatches window *t+1* BEFORE window *t*'s host post-processing. The
  rings of the window in flight are copied into pinned host memory as soon
  as it finishes (an event marks the copy), so the next fetch waits only for
  that copy. A failed gate falls back to the serial order for one window;
  ``pipeline=False`` keeps the serial loop (``_run_serial``), the parity
  reference.
* ADAPTIVE WINDOWS: :class:`AdaptiveWindow` lengthens the window over the
  ladder ``sync_every × {1, 2, 4, …} ≤ max_window`` while drains stay quiet
  and snaps back on any trigger, spawn, merge or admission; windows are
  capped where a side's step budget completes, so control ops land on the
  same virtual tick as in the pinned engine, and every stream is bitwise the
  same.
* Spawn = hybrid landmark compression of the parent lane only (paper §3.3),
  every layer at once through ONE ``landmark_score`` launch;
* merge = Validation Gate (§3.5) + Referential Injection (§3.6) in one step
  (``injection.merge_thought``).
* CUDA GRAPHS: on the card, with no lane group and layer kinds proven
  capture-safe, each tick replays CUDA graphs captured from the same eager
  tick, broken only at each ``synapse_attention`` call, which its wrapper
  still launches (``core/tick_graphs.py``); everywhere else the tick runs
  eagerly. ``stats`` counts ``graph_ticks``, ``eager_ticks`` and
  ``graph_captures``.
* Serving hooks: ``stream_tap(view, chunk, toks)`` fires in the drain
  post-processing for every lane that received tokens; ``admission_hook``
  runs in :meth:`CortexEngine._boundary_ops`, at window boundaries with
  nothing in flight, so a front end's admissions never flush a window.
  Agents carry identities in an :class:`~repro_torch.memory.AgentRegistry`.
* Memory tiers: agents outlive lane slots. :meth:`CortexEngine.hibernate`
  copies a lane's caches and per-lane scalars off the card (one host sync,
  at a drain boundary) into a :class:`~repro_torch.memory.SynapseStore`
  (warm host memory, cold framed blobs on disk) and frees the lane;
  :meth:`CortexEngine.wake` prefetches the snapshot back on the store's
  worker thread (non-blocking copies on a stream of their own) and commits
  it into a free lane at a window boundary, between the ring fetch and the
  next dispatch, without flushing the pipeline: the commit makes the
  engine's stream wait for the copies' event, so no host sync. Lanes woken
  after a fetched window skip that window's post-processing once
  (``_fresh_wakes``). ``submit_agent`` hibernates the least recently bound
  river when every lane is taken, ``hibernate_idle_ticks`` demotes idle
  rivers at boundaries, and :meth:`CortexEngine.adopt_hibernated` re-adopts
  the agents a recovered store holds after a restart.
* Lane groups (``mesh=``, a :class:`~repro_torch.launch.mesh.LaneMesh`):
  every rank is one process on one device, runs this same host code and
  holds only its own block of ``max_side / world`` side lanes, while the
  river is replicated and stepped on every rank. A window issues no
  collective; each drain all-gathers the side rings into one buffer before
  the ring copy, so every rank's router, gate, window policy and spawn and
  merge decisions see the same tokens. A spawn compresses the (replicated)
  parent and writes the side lane on its owner only; a merge touches the
  river only. Hibernate and wake move a side lane through
  ``launch.sharding.lane_gather``/``lane_scatter``; whether a wake is ready
  is agreed over the ranks. The river samples from a generator seeded
  alike on every rank and the local sides from one seeded per rank, so a
  stochastic river stays equal on every rank; greedy streams equal the
  ``mesh=None`` engine's.

Caches and per-lane state are updated in place where the reference donated
its buffers. ``stats`` keeps the reference's accounting: a window counts as
one tick dispatch, each ring fetch, each merge decision and each hibernate
as one host sync.
"""
from __future__ import annotations

import dataclasses
import functools
from dataclasses import dataclass, field

import torch

from repro_torch import trace
from repro_torch.core import injection
from repro_torch.core import synapse as synapse_lib
from repro_torch.core import tick_graphs
from repro_torch.core.prism import Prism, tree_bytes
from repro_torch.core.router import CortexRouter
from repro_torch.data.tokenizer import ByteTokenizer
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.kernels.ops import ring_append
from repro_torch.launch import sharding as lane_rules
from repro_torch.launch.mesh import lane_axis
from repro_torch.memory import (
    ACTIVE, HIBERNATED, LOST, REGISTERED, AgentRegistry, SnapshotLostError, SynapseStore,
)
from repro_torch.memory.store import device_put_fn, ready_on_stream
from repro_torch.models import cache as cache_lib
from repro_torch.models import mamba2
from repro_torch.models import model as model_lib
from repro_torch.models.config import ModelConfig
from repro_torch.serving.sampler import (
    LaneSampling, SamplingParams, cat_lanes, lane_params, lane_values,
    sample_lanes, static_flags,
)


def _lane_slice(caches: model_lib.ModelCaches, lane: int) -> list:
    """Views of one batch lane's tensors (axis 1; axis 0 is the stacked
    layer dim), the shared caches included."""
    return [a[:, lane] for a in caches.tensors()]


def spawn_caches(cfg: ModelConfig, main_caches: model_lib.ModelCaches, spec: model_lib.CacheSpec):
    """Compress a main agent's caches into fresh side-agent caches.

    Attention full caches (the groups' and the hybrid's shared ones): hybrid
    landmark compression with the density term from the ``landmark_score``
    kernel. The paper's Q_t (the parent's current query) is approximated by
    the newest resident key, broadcast to the query heads, as in the
    reference. The stacked layer (or invocation) axis is folded into the
    batch axis, so a stack compresses in ONE kernel launch. Recurrent
    states and MLA latent caches are handed over as they are, as the
    reference does (the side lane receives a copy when it is written).
    """
    return main_caches.map(
        lambda c: _compress_stacked(cfg, c, spec) if isinstance(c, cache_lib.FullCache) else c)


def _compress_stacked(cfg: ModelConfig, c: cache_lib.FullCache, spec: model_lib.CacheSpec):
    """[L, B, ...] FullCache -> [L, B, ...] SynapseCache, layers folded into
    the batch axis (one scoring sweep for the whole stack)."""
    L, B = c.pos.shape[:2]
    # one lane of several rivers is a strided slice: the landmark_score
    # kernel reads contiguous keys, so the fold copies it where it must
    flat = cache_lib.map_cache(lambda a: a.reshape((L * B,) + a.shape[2:]).contiguous(), c)
    last = torch.clamp(flat.length.long() - 1, 0, flat.k.shape[1] - 1)
    k_last = flat.k[torch.arange(L * B, device=last.device), last]  # [LB, Hkv, D]
    g = cfg.n_heads // k_last.shape[1]
    q_proxy = torch.repeat_interleave(k_last, g, dim=1).contiguous()  # [LB, H, D] — Q_t ~ K_t proxy
    comp = synapse_lib.compress(
        cfg, flat, q_proxy, spec.n_landmarks, spec.window, spec.n_inject, spec.policy
    )
    return cache_lib.map_cache(lambda a: a.reshape((L, B) + a.shape[1:]), comp)


# ---------------------------------------------------------------------------
# device-resident tick state
# ---------------------------------------------------------------------------
@dataclass
class TickState:
    """Everything a tick reads and writes; updated in place."""

    gen: torch.Generator    # device generator of the stochastic lanes
    rings: torch.Tensor     # [M+S, R] int32 — main_ring and side_ring are views of it
    # river lanes
    main_tok: torch.Tensor     # [M] int32 — last token per lane
    main_pos: torch.Tensor     # [M] int32 — next rope position
    main_active: torch.Tensor  # [M] bool
    main_hidden: torch.Tensor  # [M, d] f32 — gate input
    main_ring: torch.Tensor    # [M, R] int32 — sampled tokens awaiting drain (-1 = none)
    main_samp: LaneSampling
    main_caches: model_lib.ModelCaches
    # stream lanes
    side_tok: torch.Tensor     # [S] int32
    side_pos: torch.Tensor     # [S] int32
    side_active: torch.Tensor  # [S] bool
    side_step: torch.Tensor    # [S] int32 — ticks since spawn
    side_plen: torch.Tensor    # [S] int32 — teacher-forced prompt length
    side_prompt: torch.Tensor  # [S, P] int32 — on-device prompt buffer
    side_hidden: torch.Tensor  # [S, d] f32
    side_ring: torch.Tensor    # [S, R] int32
    side_samp: LaneSampling
    side_caches: model_lib.ModelCaches
    # on a lane group: the generator of this rank's stream lanes (``gen``
    # then draws the river's only, alike on every rank); None: ``gen``
    # draws every lane's in one pass
    side_gen: torch.Generator | None = None


def init_tick_state(cfg: ModelConfig, *, n_main: int, max_side: int, main_spec, side_spec,
                    ring_capacity: int, side_prompt_cap: int, main_sampling: SamplingParams,
                    side_sampling: SamplingParams, seed: int, device, side_seed: int | None = None) -> TickState:
    """``max_side`` is the stream lanes this process holds (its block on a
    lane group); ``side_seed`` gives them a generator of their own."""
    d = cfg.d_model
    M, S, R, P = n_main, max_side, ring_capacity, side_prompt_cap
    # the meta device (the dry run's byte counts) has no generator
    meta = torch.device(device).type == "meta"
    gen = None if meta else torch.Generator(device=device).manual_seed(seed)
    zi = lambda *s: torch.zeros(s, dtype=torch.int32, device=device)
    # one ring buffer for every lane, at a fixed address: a drain copies it
    # to the host in one transfer
    rings = torch.full((M + S, R), -1, dtype=torch.int32, device=device)
    return TickState(
        gen=gen, rings=rings,
        main_tok=zi(M), main_pos=zi(M),
        main_active=torch.zeros(M, dtype=torch.bool, device=device),
        main_hidden=torch.zeros((M, d), dtype=torch.float32, device=device),
        main_ring=rings[:M],
        main_samp=lane_params(main_sampling, M, device=device),
        main_caches=model_lib.init_caches(cfg, M, main_spec, device=device),
        side_tok=zi(S), side_pos=zi(S),
        side_active=torch.zeros(S, dtype=torch.bool, device=device),
        side_step=zi(S), side_plen=zi(S), side_prompt=zi(S, P),
        side_hidden=torch.zeros((S, d), dtype=torch.float32, device=device),
        side_ring=rings[M:],
        side_samp=lane_params(side_sampling, S, device=device),
        side_caches=model_lib.init_caches(cfg, S, side_spec, device=device),
        side_gen=None if side_seed is None or meta else torch.Generator(device=device).manual_seed(side_seed),
    )


def gather_main_lane(st: TickState, lane: int) -> dict:
    """One river lane's device state, as the reference snapshots it
    (views: the store copies them)."""
    return {"caches": model_lib.lane_caches(st.main_caches, lane), "tok": st.main_tok[lane],
            "pos": st.main_pos[lane], "hidden": st.main_hidden[lane]}


def one_tick(params, st: TickState, cursor: int, *, cfg: ModelConfig, main_spec, side_spec,
             step_sides: bool, use_filters: bool, any_greedy: bool, graphs=None) -> str:
    """One scheduler tick on the device, in place: river decode, side
    decode (synapse caches, the ``synapse_attention`` kernel), per-lane
    sampling, ring column ``cursor``. Reads no device value on the host.

    Inactive lanes decode garbage harmlessly (their cursors are frozen and
    their caches are rewritten on admission). ``step_sides=False`` is the
    river-only tick, used while no stream is live.

    ``graphs`` (a :class:`~repro_torch.core.tick_graphs.TickGraphs`): the
    same tick, issued from CUDA graphs captured for these flags (broken at
    each ``synapse_attention`` call, which stays eager), or captured into
    them. Returns how it was issued: "eager", "capture" or "replay".
    """
    with trace.span("engine.tick"):
        body = functools.partial(_tick_body, params, st, cfg=cfg, main_spec=main_spec, side_spec=side_spec,
                                 step_sides=step_sides, use_filters=use_filters, any_greedy=any_greedy)
        if graphs is None:
            body(cursor, None)
            return "eager"
        gens = [g for g in (st.gen, st.side_gen) if g is not None]
        return graphs.tick((step_sides, use_filters, any_greedy), cursor, body, gens)


def _tick_body(params, st: TickState, cursor, cut, *, cfg: ModelConfig, main_spec, side_spec,
               step_sides: bool, use_filters: bool, any_greedy: bool):
    """:func:`one_tick`'s work; ``cut`` (a capture's) is called where the
    river's decode ends, and ``cursor`` may be a device scalar."""
    m_act, s_act = st.main_active, st.side_active
    M = m_act.shape[0]
    with trace.span("tick.river"):
        logits_m, hidden_m, _ = model_lib.decode_step(
            params, cfg, {"tokens": st.main_tok, "positions": st.main_pos}, st.main_caches, spec=main_spec,
        )
    if cut is not None:
        cut()
    if step_sides:
        with trace.span("tick.side"):
            # teacher-force the on-device task prompt, then free-run from
            # the last sampled token; the sampled token counts from the
            # last forced step on
            forced = st.side_step < st.side_plen
            pidx = torch.clamp(st.side_step, 0, st.side_prompt.shape[1] - 1).long()
            prompt_tok = torch.gather(st.side_prompt, 1, pidx[:, None])[:, 0]
            zero = torch.zeros_like(st.side_tok)
            in_tok = torch.where(s_act, torch.where(forced, prompt_tok, st.side_tok), zero)
            in_pos = torch.where(s_act, st.side_pos, zero)
            logits_s, hidden_s, _ = model_lib.decode_step(
                params, cfg, {"tokens": in_tok, "positions": in_pos}, st.side_caches, spec=side_spec,
            )
    with trace.span("tick.sample"):
        if not step_sides:
            samp_m = sample_lanes(st.gen, logits_m, st.main_samp, use_filters=use_filters,
                                  any_greedy=any_greedy)
        elif st.side_gen is None:
            samp = sample_lanes(
                st.gen, torch.cat([logits_m, logits_s]), cat_lanes(st.main_samp, st.side_samp),
                use_filters=use_filters, any_greedy=any_greedy,
            )
            samp_m, samp_s = samp[:M], samp[M:]
        else:
            samp_m = sample_lanes(st.gen, logits_m, st.main_samp, use_filters=use_filters,
                                  any_greedy=any_greedy)
            samp_s = sample_lanes(st.side_gen, logits_s, st.side_samp, use_filters=use_filters,
                                  any_greedy=any_greedy)
    with trace.span("tick.commit"):
        ring_append(st.main_ring, torch.where(m_act, samp_m, torch.full_like(samp_m, -1)), cursor)
        st.main_tok.copy_(torch.where(m_act, samp_m, st.main_tok))
        st.main_pos.add_(m_act.to(torch.int32))
        st.main_hidden.copy_(hidden_m.float())
        if not step_sides:
            return
        keep = s_act & (st.side_step >= st.side_plen - 1)
        ring_append(st.side_ring, torch.where(keep, samp_s, torch.full_like(samp_s, -1)), cursor)
        st.side_tok.copy_(torch.where(keep, samp_s, st.side_tok))
        st.side_pos.add_(s_act.to(torch.int32))
        st.side_step.add_(s_act.to(torch.int32))
        st.side_hidden.copy_(hidden_s.float())


# byte values the conservative drain gate inspects on the raw token rings
# (ByteTokenizer: ids 0..255 are raw bytes; every router tag needs them both)
_OPEN_BRACKET, _CLOSE_BRACKET = ord("["), ord("]")

class AdaptiveWindow:
    """Window-length policy: lengthen ``sync_every`` while drains are quiet.

    Proposals come from a fixed ladder ``base * {1, 2, 4, ...}`` capped at
    ``max_window``. The policy climbs one rung per quiet drain (no router
    trigger, no spawn, merge or completion, no admission) and snaps back to
    the base window on any such event. ``max_window == base`` is the pinned
    policy.
    """

    def __init__(self, base: int, max_window: int | None = None):
        self.base = max(1, base)
        requested = max(self.base, max_window or self.base)
        # every rung is base * 2^k: the engine's boundary math (side budget
        # caps, drain alignment with the pinned engine) assumes windows are
        # base multiples, so an off-ladder max_window rounds DOWN to a rung
        ladder = [self.base]
        while ladder[-1] * 2 <= requested:
            ladder.append(ladder[-1] * 2)
        self.ladder = tuple(ladder)
        self.max_window = ladder[-1]
        self._rung = 0

    def propose(self) -> int:
        return self.ladder[self._rung]

    def on_quiet_drain(self):
        self._rung = min(self._rung + 1, len(self.ladder) - 1)

    def on_event(self):
        self._rung = 0


@dataclass
class AgentView:
    """Host-side bookkeeping for one agent lane (refreshed at drain time)."""

    agent_id: str
    lane: int
    kind: str                  # "main" | "side"
    parent_lane: int = -1
    task: str = ""
    text: str = ""
    tokens: list = field(default_factory=list)
    position: int = 0          # next rope position (drain-time mirror)
    active: bool = False
    steps: int = 0
    prompt_len: int = 0


# the durable part of an AgentView: what crash recovery needs to rebuild the
# host-side view of a hibernated agent (lane and active are set at wake)
_VIEW_META_FIELDS = (
    "agent_id", "kind", "parent_lane", "task", "text", "tokens",
    "position", "steps", "prompt_len",
)


def _view_to_meta(view: AgentView) -> dict:
    out = {f: getattr(view, f) for f in _VIEW_META_FIELDS}
    out["tokens"] = [int(t) for t in out["tokens"]]
    return out


def _view_from_meta(meta: dict) -> AgentView:
    view = AgentView(meta["agent_id"], -1, meta["kind"])
    for f in _VIEW_META_FIELDS[2:]:
        setattr(view, f, meta[f])
    view.tokens = list(meta["tokens"])
    view.active = False
    return view


class CortexEngine:
    def __init__(
        self,
        prism: Prism,
        tokenizer: ByteTokenizer,
        *,
        n_main: int = 1,
        max_side: int = 8,
        main_capacity: int = 1024,
        side_spec: model_lib.CacheSpec | None = None,
        theta: float = 0.5,
        inject_tokens: int = 16,
        side_max_steps: int = 64,
        sampling: SamplingParams = SamplingParams(temperature=0.8),
        side_sampling: SamplingParams | None = None,
        seed: int = 0,
        sync_every: int = 1,
        max_window: int | None = None,
        pipeline: bool = True,
        side_prompt_cap: int = 64,
        compute_dtype: str | None = None,
        store: SynapseStore | None = None,
        hibernate_idle_ticks: int | None = None,
        wake_deadline_s: float | None = None,
        mesh=None,
        device=None,
    ):
        """Runs on ``device``, the card unless ``device="cpu"``, which must
        be where the Prism holds the weights. On the CPU the compute dtype
        defaults to f32 (as the reference's CPU serving policy); on the card
        it is the config's (bf16 for the paper's model).

        ``max_window`` lets the pipelined ``run`` lengthen windows up to that
        many ticks while drains are quiet (None pins them at ``sync_every``;
        off-ladder values round down to ``sync_every * 2^k``).
        ``pipeline=False`` keeps the serial dispatch → drain loop, whose
        windows stay pinned.

        ``store`` holds hibernated agents (a fresh warm-only
        :class:`~repro_torch.memory.SynapseStore` by default);
        ``hibernate_idle_ticks`` hibernates a river whose last submit or wake
        is that many virtual ticks old, at a window boundary;
        ``wake_deadline_s`` bounds every wake's promotion unless a wake
        names its own deadline.

        ``mesh``: a lane group (``launch.mesh.make_lane_mesh``) on the
        engine's device. Every rank of it builds this engine with the same
        arguments and makes the same calls; the side lanes split over the
        ranks in contiguous blocks (``max_side`` must be a multiple of the
        world size) and the river is replicated."""
        self.device = resolve_device(device)
        if prism.device != self.device:
            raise ValueError(f"the Prism's weights are on {prism.device}, the engine runs on {self.device}")
        if mesh is not None and lane_axis(mesh) is None:
            raise ValueError("mesh= takes a lane group (repro_torch.launch.mesh.make_lane_mesh)")
        if mesh is not None and mesh.device != self.device:
            raise ValueError(f"the lane group runs on {mesh.device}, the engine on {self.device}")
        self.mesh = mesh
        self._lanes = lane_rules.tick_state_specs(self.mesh, max_side)
        self.prism = prism
        cfg = prism.cfg
        model_lib.check_servable(cfg, "CortexEngine")
        if compute_dtype is None and cfg.compute_dtype == "bfloat16" and self.device.type == "cpu":
            compute_dtype = "float32"
        if compute_dtype is not None:
            cfg = dataclasses.replace(cfg, compute_dtype=compute_dtype)
        self.cfg = cfg
        self.tok = tokenizer
        self.theta = theta
        self.inject_tokens = inject_tokens
        self.side_max_steps = side_max_steps
        self.sampling = sampling
        self.side_sampling = side_sampling if side_sampling is not None else sampling
        self.sync_every = max(1, sync_every)
        self.side_prompt_cap = side_prompt_cap
        self.window = AdaptiveWindow(self.sync_every, max_window if pipeline else None)
        self.max_window = self.window.max_window
        self.pipeline = pipeline
        # the router's overlap tail covers the longest round-tripped tag and
        # one drain window of text (8 bytes/token bounds UTF-8 expansion)
        self.router = CortexRouter(tail=max(256, 8 * self.max_window, side_prompt_cap + 16))
        self.main_spec = model_lib.CacheSpec(kind="full", capacity=main_capacity)
        side_spec = side_spec or model_lib.CacheSpec(
            kind="synapse", n_landmarks=64, window=64, n_inject=inject_tokens
        )
        self.side_spec = side_spec
        self.n_main, self.max_side = n_main, max_side
        self.mains = [AgentView(f"main{i}", i, "main") for i in range(n_main)]
        self.sides = [AgentView(f"side{i}", i, "side") for i in range(max_side)]
        self.registry = AgentRegistry()
        self._agent_seq = 0
        # memory tiers: hibernated contexts park in the store, the registry
        # keeps identity and LRU order, and wakes land through prefetch
        # tickets committed at window boundaries
        self.store = store if store is not None else SynapseStore()
        self.hibernate_idle_ticks = hibernate_idle_ticks
        self.wake_deadline_s = wake_deadline_s
        self._wake_tickets: dict[str, object] = {}
        self._pending_wakes: list[str] = []
        # (kind, lane) pairs woken between a ring fetch and that window's
        # post-processing: they were not on the device for the fetched
        # window, so its post-processing skips them
        self._fresh_wakes: set[tuple[str, int]] = set()
        self._put = device_put_fn(self.device)
        # host mirrors of the per-lane sampling tensors: they pick the
        # sampler's fast path without reading the device
        self._main_sp: list[SamplingParams] = [self.sampling] * n_main
        self._side_sp: list[SamplingParams] = [self.side_sampling] * max_side
        # per-agent incremental UTF-8 decoders: a codepoint split across a
        # window boundary never becomes U+FFFD in the agent's text
        self._decoders: dict[str, object] = {}
        # serving front-end hooks: ``stream_tap(view, chunk, toks)`` fires
        # in the drain post-processing for every lane that received tokens;
        # ``admission_hook()`` runs with the window-boundary control plane
        # (:meth:`_boundary_ops`), never inside a window
        self.stream_tap = None
        self.admission_hook = None
        self.history: list[dict] = []
        self.stats = {
            "ticks": 0, "tick_dispatches": 0, "macro_dispatches": 0,
            "aux_dispatches": 0, "host_syncs": 0, "drains": 0,
            # drains whose host post-processing overlapped the next window,
            # and the dispatched window lengths (window_hist[w] = count)
            "overlapped_drains": 0, "window_hist": {},
            "hibernates": 0, "wakes": 0,
            # wake_failures: the snapshot is intact and the agent stays
            # hibernated (retryable); lost_agents: the snapshot is gone and
            # the agent is LOST; recoveries: agents re-adopted after a restart
            "wake_failures": 0, "lost_agents": 0, "recoveries": 0,
            # [TASK] triggers given a side lane, and dropped for want of one
            "spawns": 0, "spawns_dropped": 0,
            # side lanes decoded, summed over the ticks that step sides, and
            # the live ones among them (the rest decode garbage harmlessly)
            "side_lane_ticks": 0, "live_side_lane_ticks": 0,
            # ticks issued from CUDA graphs (replayed, or captured and run)
            # and eagerly, and the captures (a key's first, or anew after a
            # rebound state)
            "graph_ticks": 0, "eager_ticks": 0, "graph_captures": 0,
            # bytes the lanes' recurrent states and attention caches hold
            # (set below), and the state bytes copied at spawns and
            # blended at merges
            "recurrent_state_bytes": 0, "attn_cache_bytes": 0, "state_copy_bytes": 0, "state_blend_bytes": 0,
            # Mamba2 layer steps the ticks' decodes issued (each layer of each
            # decode batch), and those that went through the hand-written step
            "mamba_steps": 0, "mamba_kernel_steps": 0,
        }
        if self.mesh is not None:
            self.stats["ring_gathers"] = 0  # the all-gathers of the side rings: one per drain
        self._pending = 0  # ticks since last drain (== ring cursor)
        # serving-dtype weights, cast once; the Prism's copy stays the master
        self._params = model_lib.cast_params(prism.params, cfg)
        # rings hold the longest adaptive window
        self.state = init_tick_state(
            cfg, n_main=n_main, max_side=self._lanes.block, main_spec=self.main_spec,
            side_spec=self.side_spec, ring_capacity=self.max_window,
            side_prompt_cap=side_prompt_cap, main_sampling=self.sampling,
            side_sampling=self.side_sampling, seed=seed, device=self.device,
            side_seed=None if self.mesh is None else seed * 1_000_003 + 1 + self.mesh.rank,
        )
        held = [model_lib.held_bytes(c) for c in (self.state.main_caches, self.state.side_caches)]
        self.stats["recurrent_state_bytes"] = sum(r for r, _ in held)
        self.stats["attn_cache_bytes"] = sum(a for _, a in held)
        # one river lane's recurrent state: what a spawn copies, a merge blends
        self._lane_state_bytes = held[0][0] // n_main
        # on a lane group, every rank's rings gathered at a fixed address
        rows = (n_main + max_side, self.max_window)
        self._ring_all = None if self.mesh is None else torch.full(rows, -1, dtype=torch.int32, device=self.device)
        # the host side of the ring copy: pinned on the card, so the copy of
        # the window in flight runs while the host works; an event marks its
        # end, and the fetch waits for that event only
        on_card = self.device.type == "cuda"
        self._ring_host = torch.empty(rows, dtype=torch.int32, pin_memory=on_card)
        self._ring_event = torch.cuda.Event() if on_card else None
        self._prefetched = False
        # on the card, with no lane group and layer kinds proven capture-safe,
        # ticks replay from CUDA graphs (core/tick_graphs.py); None: eager
        self._graphs = (tick_graphs.TickGraphs(self.device)
                        if tick_graphs.engages(cfg, self.device, self.mesh) else None)

    @property
    def lane_mesh_shape(self) -> tuple[int, ...] | None:
        """The lane group's shape when lane-sharded (recorded by the benches)."""
        return None if self.mesh is None else (self.mesh.world,)

    def _sampler_flags(self, step_sides: bool) -> tuple[bool, bool]:
        """(use_filters, any_greedy) over the lanes a tick samples, from the
        host mirrors only."""
        ps = [self._main_sp[m.lane] for m in self.mains if m.active]
        if step_sides:
            ps += [self._side_sp[s.lane] for s in self.sides if s.active]
        return static_flags(ps)

    def _decoder(self, agent_id: str):
        dec = self._decoders.get(agent_id)
        if dec is None:
            dec = self._decoders[agent_id] = self.tok.stream_decoder()
        return dec

    def agent_text(self, agent_id: str) -> str:
        """The agent's full text as of the last drain, including what the
        decoder would flush of a codepoint left incomplete at the window
        boundary: exactly ``tok.decode(tokens)`` of the same stream. The
        decoder keeps its state, so the live stream stays bitwise."""
        for v in (*self.mains, *self.sides):
            if v.agent_id == agent_id:
                dec = self._decoders.get(agent_id)
                return v.text + (dec.tail() if dec is not None else "")
        raise KeyError(agent_id)

    # ------------------------------------------------------------------
    def submit(self, prompt: str, lane: int = 0, sampling: SamplingParams | None = None,
               agent_id: str | None = None):
        """Start (or restart) a main agent on ``lane`` with ``prompt``:
        prefill in place into the lane's cache. ``sampling`` overrides the
        engine default for this lane only. ``agent_id`` names the agent in
        the registry; omitted, the per-lane identity ``main{lane}`` is used
        when free. Tags in the prompt spawn at once."""
        self.drain()  # align host mirrors to a window boundary
        self.window.on_event()  # admission: back to the base window
        aid = self._claim_main_identity(lane, agent_id)
        ids = self.tok.encode(prompt, bos=True)
        toks = torch.tensor([ids], dtype=torch.int32, device=self.device)
        st = self.state
        with trace.span("engine.prefill", agent=aid, tokens=len(ids)):
            _, hidden, _ = model_lib.prefill_lane(
                self._params, self.cfg, {"tokens": toks}, st.main_caches, lane, spec=self.main_spec
            )
        self._main_sp[lane] = sampling if sampling is not None else self.sampling
        st.main_tok[lane] = ids[-1]
        st.main_pos[lane] = len(ids)
        st.main_active[lane] = True
        st.main_hidden[lane] = hidden[0].float()
        st.main_samp.set_lane(lane, *lane_values(self._main_sp[lane]))
        self.stats["aux_dispatches"] += 2
        m = AgentView(aid, lane, "main")
        self.mains[lane] = m
        m.text, m.tokens = prompt, list(ids)
        m.position, m.active, m.steps = len(ids), True, 0
        m.prompt_len = len(ids)
        self._decoders[aid] = self.tok.stream_decoder()
        self.prism.acquire(m.agent_id)
        rec = self.registry.bind(aid, lane)
        rec.bound_tick = self.stats["ticks"]
        self.router.reset(m.agent_id)
        for tr in self.router.feed(m.agent_id, prompt):
            if tr.kind == "task":
                self._spawn_task(m, tr.payload)
        return m

    def _claim_main_identity(self, lane: int, agent_id: str | None) -> str:
        """The agent_id a main-lane submit binds; the lane's previous
        occupant loses its context and its registry binding."""
        cur = self.mains[lane]
        if cur.active:
            self.prism.release(cur.agent_id)
            self.registry.release(cur.agent_id)
            self.router.reset(cur.agent_id)
            self._decoders.pop(cur.agent_id, None)
        if agent_id is None:
            agent_id = f"main{lane}"
            if agent_id in self.registry:
                rec = self.registry.get(agent_id)
                if rec.status == HIBERNATED or (rec.status == ACTIVE and rec.lane != lane):
                    # the per-lane identity is alive elsewhere (parked, or
                    # woken into another lane): mint a fresh one instead of
                    # clobbering it
                    agent_id = f"main{lane}.{self._agent_seq}"
                    self._agent_seq += 1
        elif agent_id in self.registry:
            rec = self.registry.get(agent_id)
            if rec.status == ACTIVE and rec.lane != lane:
                raise ValueError(f"agent {agent_id!r} is already active on lane {rec.lane}")
            if rec.status == HIBERNATED:
                # re-submitting replaces the parked context outright
                self.store.drop(agent_id)
                self._wake_tickets.pop(agent_id, None)
                if agent_id in self._pending_wakes:
                    self._pending_wakes.remove(agent_id)
        self.registry.register(agent_id, "main")
        return agent_id

    def submit_agent(self, prompt: str, agent_id: str | None = None,
                     sampling: SamplingParams | None = None):
        """Lane-less submit: place a (new or registered) agent on a free
        main lane, hibernating the least recently bound resident when every
        river lane is taken: ``n_main`` bounds the *active* agents, not the
        registered ones."""
        lane = self._free_main_lane()
        if lane < 0:
            if self._evict_lru_main() is None:
                raise RuntimeError("no free main lane and no evictable resident "
                                   "(all mains have live side streams)")
            lane = self._free_main_lane()
            assert lane >= 0
        if agent_id is None:
            agent_id = f"agent{self._agent_seq}"
            self._agent_seq += 1
        return self.submit(prompt, lane=lane, sampling=sampling, agent_id=agent_id)

    # ------------------------------------------------------------------
    def _any_active(self) -> bool:
        return any(m.active for m in self.mains) or any(s.active for s in self.sides)

    def tick(self):
        """One scheduler tick: one dispatch, no host sync. Spawns, merges and
        router triggers are handled at drain boundaries, every
        ``sync_every`` ticks."""
        if not self._any_active():
            self.stats["ticks"] += 1
            return
        self._dispatch_window(1)
        if self._pending >= self.sync_every:
            self.drain()

    def macro_tick(self):
        """One window of ``sync_every`` virtual ticks, then the drain."""
        if not self._any_active():
            self.stats["ticks"] += self.sync_every
            return
        if self._pending:
            self.drain()  # align the ring cursor to a window boundary
        self._dispatch_window(self.sync_every)
        self.drain()

    def _dispatch_window(self, n: int):
        """Advance ``n <= max_window - pending`` virtual ticks. No drain, no
        host sync — callers close the window."""
        assert self._pending + n <= self.max_window
        step_sides = any(s.active for s in self.sides)
        use_filters, any_greedy = self._sampler_flags(step_sides)
        # side lanes decoded (the whole block this process holds) and the
        # live ones among them, from the host views
        live = sum(s.active for s in self.sides[self._lanes.span]) if step_sides else 0
        if step_sides:
            self.stats["side_lane_ticks"] += n * self._lanes.block
            self.stats["live_side_lane_ticks"] += n * live
        if self._graphs is not None:
            self._graphs.check(tick_graphs.fingerprint(self.state, self._params))
        # the Mamba2 steps the decode issues and the kernel's launches, as the
        # Python runs them (a tick replayed from graphs would run neither; the
        # graphed ticks have no Mamba2 layer)
        steps, kernel_steps = mamba2.decode_steps, ops.launch_counts()["mamba2_step"]
        with trace.span("engine.dispatch", ticks=n, rivers=sum(m.active for m in self.mains), sides=live):
            for i in range(n):
                how = one_tick(
                    self._params, self.state, self._pending + i, cfg=self.cfg,
                    main_spec=self.main_spec, side_spec=self.side_spec, step_sides=step_sides,
                    use_filters=use_filters, any_greedy=any_greedy, graphs=self._graphs,
                )
                self.stats["eager_ticks" if how == "eager" else "graph_ticks"] += 1
                self.stats["graph_captures"] += how == "capture"
        self.stats["mamba_steps"] += mamba2.decode_steps - steps
        self.stats["mamba_kernel_steps"] += ops.launch_counts()["mamba2_step"] - kernel_steps
        self.stats["ticks"] += n
        self.stats["tick_dispatches"] += 1
        if n > 1:
            self.stats["macro_dispatches"] += 1
        hist = self.stats["window_hist"]
        hist[n] = hist.get(n, 0) + 1
        self._pending += n

    def _next_window(self, remaining: int, pending=None) -> int:
        """Length of the next window: the adaptive proposal, capped (a) at
        the serial-path boundary where an active side's step budget
        completes (a multiple of the base window, so the merge lands on the
        pinned engine's virtual tick) and (b) to the base window while the
        router's retained tail of any agent holds an unclosed ``[``. Every
        cap keeps the window a base multiple except the run's trailing
        partial window (``remaining``).

        ``pending=(rings, n)``: window *t* was fetched but not yet
        post-processed (the overlapped branch), so the side views' tokens and
        steps are one window stale; the budget cap counts window *t*'s ring
        tokens, or the boundary lands a window late and the merge drifts
        off the serial tick."""
        base = self.sync_every
        w = self.window.propose()
        if w > base:
            for s in self.sides:
                if not s.active:
                    continue
                generated = len(s.tokens) - s.prompt_len
                steps = s.steps
                if pending is not None:
                    rings, p_n = pending
                    toks = rings[1][s.lane, :p_n]
                    generated += int((toks >= 0).sum())
                    steps += p_n
                forced_left = max(0, (s.prompt_len - 1) - steps)
                t_budget = forced_left + max(1, self.side_max_steps - generated)
                boundary = base * -(-t_budget // base)  # ceil to a base multiple
                w = min(w, boundary)
            if any(self.router.plausible(a.agent_id) for a in (*self.mains, *self.sides) if a.active):
                w = base
        return min(w, remaining)

    def _gate(self, rings, n: int) -> bool:
        """May window ``t+1`` be dispatched before window ``t``'s host
        post-processing? Only when that post-processing provably issues no
        control op. Byte-level, on the fetched rings: a ``[`` could open a
        tag; a ``]`` closes one only while the router tail holds an unclosed
        ``[``; a side reaching its step budget merges. Every trigger needs
        those bytes and budgets are host arithmetic, so a True verdict keeps
        the serial drain order's result bitwise."""
        main_ring, side_ring = rings
        for m in self.mains:
            if not m.active:
                continue
            toks = main_ring[m.lane, :n]
            toks = toks[toks >= 0]
            if (toks == _OPEN_BRACKET).any():
                return False
            if (toks == _CLOSE_BRACKET).any() and self.router.plausible(m.agent_id):
                return False
        for s in self.sides:
            if not s.active:
                continue
            toks = side_ring[s.lane, :n]
            toks = toks[toks >= 0]
            if (toks == _OPEN_BRACKET).any():
                return False
            if (toks == _CLOSE_BRACKET).any() and self.router.plausible(s.agent_id):
                return False
            if len(s.tokens) - s.prompt_len + toks.size >= self.side_max_steps:
                return False
        return True

    def run(self, n_ticks: int):
        """Advance ``n_ticks`` virtual ticks in at most
        ``ceil(n_ticks/sync_every)`` windows (exactly that many with a
        pinned window).

        Pipelined (default): after fetching window *t*'s rings, the one
        blocking sync per window, :meth:`_gate` decides whether window *t+1*
        is dispatched before window *t*'s host post-processing.
        ``pipeline=False`` runs the serial loop (the parity reference)."""
        if not self.pipeline:
            return self._run_serial(n_ticks)
        with trace.span("engine.run", ticks=n_ticks):
            remaining = n_ticks
            # close a partly filled window (tick() interleavings) as the serial
            # path would before entering the pipeline at a boundary
            while 0 < remaining and self._pending and self._any_active():
                w = min(self.sync_every - self._pending, remaining)
                self._dispatch_window(w)
                remaining -= w
                if self._pending >= self.sync_every:
                    self.drain()
            if self._pending:
                self.drain()

            inflight = 0  # virtual ticks of the window on the device
            while remaining or inflight:
                if not inflight:
                    # window boundary, nothing in flight: idle-tick demotions,
                    # ready wakes and admissions land here (an idle engine
                    # waits for its prefetches, so a wake-only run progresses)
                    self._boundary_ops(wait=not self._any_active())
                    if not self._any_active():
                        self.stats["ticks"] += remaining
                        return
                    inflight = self._next_window(remaining)
                    self._dispatch_window(inflight)
                    self._prefetch_rings()
                    remaining -= inflight
                    continue
                rings, nwin = self._fetch_rings(), inflight
                inflight = 0
                # ready wakes commit between the ring fetch and the next
                # dispatch: window t+1 carries the woken lanes, and nothing is
                # flushed (no demotions here: window t's views are still stale)
                self._commit_ready_wakes(mark_fresh=True)
                if remaining and self._any_active() and self._gate(rings, nwin):
                    # overlap: the device runs window t+1 while the host does
                    # window t's decoding and router work (control-free by the
                    # gate); the window policy counts window t's ring tokens
                    inflight = self._next_window(remaining, pending=(rings, nwin))
                    self._dispatch_window(inflight)
                    self._prefetch_rings()
                    remaining -= inflight
                    self._postprocess(rings, nwin, overlapped=True)
                    self.stats["overlapped_drains"] += 1
                else:
                    self._postprocess(rings, nwin)
            self._boundary_ops()

    def _run_serial(self, n_ticks: int):
        """The serial loop: dispatch → drain → dispatch, pinned
        ``sync_every`` windows. The bitwise parity reference."""
        with trace.span("engine.run", ticks=n_ticks):
            remaining = n_ticks
            while remaining > 0:
                if self._pending == 0:
                    self._boundary_ops(wait=not self._any_active())
                if not self._any_active():
                    self.stats["ticks"] += remaining
                    break
                w = min(self.sync_every - self._pending, remaining)
                if w <= 1:
                    self.tick()  # drains itself when the window closes
                    remaining -= 1
                    continue
                self._dispatch_window(w)
                remaining -= w
                if self._pending >= self.sync_every:
                    self.drain()
            self.drain()
            self._boundary_ops()

    def _boundary_ops(self, *, wait: bool = False) -> int:
        """Window-boundary control plane, run with nothing in flight:
        idle-tick demotions, then wake commits, then the front end's
        admission hook (retire finished request lanes, admit queued ones).
        ``wait=True`` blocks on outstanding prefetch tickets (an engine with
        nothing else to do). Returns how many operations landed."""
        with trace.span("engine.boundary") as sp:
            did = self._auto_hibernate()
            did += self._commit_ready_wakes(wait=wait and bool(self._pending_wakes))
            if self.admission_hook is not None:
                did += int(bool(self.admission_hook()))
            sp.set(ops=did)
        return did

    # ------------------------------------------------------------------
    def drain(self):
        """Copy the device token rings to the host (ONE transfer), update
        the agent views, and run the router/spawn/merge control plane."""
        n = self._pending
        if n == 0:
            return
        self._postprocess(self._fetch_rings(), n)

    def _prefetch_rings(self):
        """Enqueue the copy of the rings into pinned host memory behind the
        window just dispatched, and mark its end with an event: the fetch
        that follows the overlapped host work waits only for the rest of
        that window. Issued only where a fetch follows (the pipelined run);
        no device value is read."""
        self._ring_host.copy_(self._gathered_rings(), non_blocking=True)
        if self._ring_event is not None:
            self._ring_event.record()
        self._prefetched = True

    def _gathered_rings(self):
        """Every lane's ring rows on the device, in global lane order. On a
        lane group: the river rows copied and ONE all-gather of the ranks'
        side rows into the fixed-address buffer, both ordered on the device
        after the window (no host sync)."""
        if self.mesh is None:
            return self.state.rings
        M = self.n_main
        self._ring_all[:M].copy_(self.state.main_ring)
        lane_rules.gather_lanes(self.mesh, self._ring_all[M:], self.state.side_ring)
        self.stats["ring_gathers"] += 1
        return self._ring_all

    def _fetch_rings(self):
        """The pipeline's sync point: the rings on the host (ONE blocking
        transfer, or the wait for the prefetched one), as a host copy the
        next window's prefetch cannot overwrite. Resets the ring cursor."""
        with trace.span("engine.fetch", prefetched=self._prefetched):
            if self._prefetched:
                if self._ring_event is not None:
                    self._ring_event.synchronize()
            else:
                self._ring_host.copy_(self._gathered_rings())
        self._prefetched = False
        rings = self._ring_host.numpy().copy()
        self.stats["host_syncs"] += 1
        self._pending = 0
        return rings[: self.n_main], rings[self.n_main:]

    def _postprocess(self, rings, n: int, *, overlapped: bool = False):
        """Window ``t``'s host-side control plane over the fetched rings:
        decode text, feed the router, complete/merge sides, spawn the
        rivers' tasks, then the window policy. With ``overlapped=True`` the
        next window is already on the device, so any control op here would
        be a gate violation (asserted; the gate makes it unreachable)."""
        with trace.span("engine.postprocess", overlapped=overlapped):
            main_ring, side_ring = rings
            self.stats["drains"] += 1
            quiet = True

            # 1. rivers: append the window's tokens (incremental UTF-8 decode)
            main_chunks: dict[int, str] = {}
            for m in self.mains:
                if not m.active or ("main", m.lane) in self._fresh_wakes:
                    continue  # a fresh wake was not on the device for this window
                toks = [int(t) for t in main_ring[m.lane, :n] if t >= 0]
                chunk = self._decoder(m.agent_id).feed(toks)
                m.tokens.extend(toks)
                m.text += chunk
                m.position += len(toks)
                m.steps += len(toks)
                main_chunks[m.lane] = chunk
                if self.stream_tap is not None and toks:
                    self.stream_tap(m, chunk, toks)

            # 2. streams: append, detect completion (trigger or step budget)
            finished = []
            for s in self.sides:
                if not s.active or ("side", s.lane) in self._fresh_wakes:
                    continue  # a fresh wake was not on the device for this window
                s.steps += n
                s.position += n
                raw = [int(t) for t in side_ring[s.lane, :n] if t >= 0]
                allowed = max(0, self.side_max_steps - (len(s.tokens) - s.prompt_len))
                raw = raw[:allowed]
                s.tokens.extend(raw)
                chunk = self._decoder(s.agent_id).feed(raw)
                s.text += chunk
                if self.stream_tap is not None and raw:
                    self.stream_tap(s, chunk, raw)
                all_trig = self.router.feed(s.agent_id, chunk)
                quiet = quiet and not all_trig
                trig = [t for t in all_trig if t.kind in ("done", "answer")]
                generated = len(s.tokens) - s.prompt_len
                if trig or generated >= self.side_max_steps:
                    # end of stream: flush so s.text equals the one-shot decode
                    s.text += self._decoder(s.agent_id).flush()
                    answer = next((t.payload for t in trig if t.kind == "answer"), None)
                    if answer is not None:
                        thought = answer
                    elif trig:
                        # spans are absolute offsets into the generated stream:
                        # cut what the lane produced after the trigger
                        thought = s.text[: trig[0].span[1]]
                    else:
                        thought = s.text
                    finished.append((s, thought))

            # 3. merges (free lanes before new spawns claim them)
            assert not (overlapped and finished), "pipeline gate violated: merge"
            for s, thought in finished:
                self._merge_side(s, thought)
            quiet = quiet and not finished

            # 4. river triggers spawn new streams
            for m in self.mains:
                if not m.active or m.lane not in main_chunks:
                    continue
                for tr in self.router.feed(m.agent_id, main_chunks[m.lane]):
                    quiet = False
                    assert not overlapped, "pipeline gate violated: trigger"
                    if tr.kind == "task":
                        self._spawn_task(m, tr.payload)

            # 5. window policy: quiet drains earn longer windows, any control
            # event snaps back to the base window
            if quiet:
                self.window.on_quiet_drain()
            else:
                self.window.on_event()
            self._fresh_wakes.clear()  # the next window has the woken lanes aboard

    # ------------------------------------------------------------------
    def _free_side_lane(self) -> int:
        for s in self.sides:
            if not s.active:
                return s.lane
        return -1

    def _free_main_lane(self) -> int:
        for m in self.mains:
            if not m.active:
                return m.lane
        return -1

    def _lanes_with_children(self) -> set[int]:
        """Main lanes some side stream (live or hibernated) will merge
        into. Hibernating or retiring such a main would let another agent
        claim the lane and receive the child's injection."""
        lanes = {s.parent_lane for s in self.sides if s.active}
        for rec in self.registry.with_status(HIBERNATED, "side"):
            lanes.add(rec.saved["view"].parent_lane)
        return lanes

    def _spawn_lane(self, parent_lane: int, side_lane: int):
        """Compress ONE parent lane into ONE side lane, in place, on the
        rank that holds the side lane (the parent is on every rank)."""
        i = self._lanes.local(side_lane)
        if i is None:
            return
        st = self.state
        with trace.span("spawn.compress"):
            comp = spawn_caches(self.cfg, model_lib.lane_caches(st.main_caches, parent_lane), self.side_spec)
        with trace.span("spawn.write"):
            model_lib.write_lane(st.side_caches, comp, i, recurrent=False)
        if self._lane_state_bytes:
            with trace.span("spawn.state"):
                model_lib.write_lane(st.side_caches, comp, i, recurrent=True)
            self.stats["state_copy_bytes"] += self._lane_state_bytes

    def _spawn_task(self, parent: AgentView, task: str):
        """A river's ``[TASK: ...]`` trigger: counted in ``spawns`` when it
        gets a side lane, in ``spawns_dropped`` when none is free."""
        s = self._spawn_side(parent, task)
        self.stats["spawns" if s is not None else "spawns_dropped"] += 1

    def _spawn_side(self, parent: AgentView, task: str, sampling: SamplingParams | None = None):
        lane = self._free_side_lane()
        if lane < 0:
            return None  # admission policy: drop when streams are saturated
        with trace.span("engine.spawn", parent=parent.agent_id) as sp:
            self._spawn_lane(parent.lane, lane)
            # keep the HEAD on overflow and close the frame: the '[TASK: ... ]'
            # framing is what conditions the stream
            ids = self.tok.encode(f"[TASK: {task}]")
            truncated = len(ids) > self.side_prompt_cap
            if truncated:
                close = self.tok.encode("]")
                ids = ids[: self.side_prompt_cap - len(close)] + close
            padded = ids + [0] * (self.side_prompt_cap - len(ids))
            self._side_sp[lane] = sampling if sampling is not None else self.side_sampling
            i = self._lanes.local(lane)
            if i is not None:
                st = self.state
                with trace.span("spawn.write"):
                    st.side_prompt[i] = torch.tensor(padded, dtype=torch.int32, device=self.device)
                    st.side_plen[i] = len(ids)
                    st.side_step[i] = 0
                    st.side_tok[i] = ids[-1]
                    st.side_pos[i] = parent.position
                    st.side_active[i] = True
                    st.side_samp.set_lane(i, *lane_values(self._side_sp[lane]))
            self.stats["aux_dispatches"] += 2
            s = self.sides[lane]
            if s.agent_id in self.registry and self.registry.get(s.agent_id).status != REGISTERED:
                # the per-lane identity is still bound elsewhere: mint a fresh one
                s = AgentView(f"side{lane}.{self._agent_seq}", lane, "side")
                self._agent_seq += 1
                self.sides[lane] = s
            sp.set(agent=s.agent_id)
            s.task, s.text = task, ""
            self._decoders[s.agent_id] = self.tok.stream_decoder()
            s.parent_lane = parent.lane
            s.tokens = list(ids)
            s.position = parent.position  # continues the parent's positional frame
            s.active, s.steps = True, 0
            s.prompt_len = len(ids)
            self.prism.acquire(s.agent_id)
            self.registry.register(s.agent_id, "side")
            rec = self.registry.bind(s.agent_id, lane)
            rec.bound_tick = self.stats["ticks"]
            self.history.append(
                {"event": "spawn", "agent": s.agent_id, "task": task, "task_truncated": truncated}
            )
        return s

    # ------------------------------------------------------------------
    def retire_side(self, lane: int):
        """Cancel a stream without merging its thought."""
        s = self.sides[lane]
        if not s.active:
            return
        self.drain()
        self.window.on_event()  # composition change: back to the base window
        self._deactivate_side(lane)
        self.stats["aux_dispatches"] += 1
        self.router.reset(s.agent_id)
        self.prism.release(s.agent_id)
        self.registry.release(s.agent_id)
        self._decoders.pop(s.agent_id, None)
        s.active = False
        self.history.append({"event": "retire", "agent": s.agent_id})

    def retire_main(self, lane: int):
        """Retire a river lane without replacing it (the serving front end
        frees a finished request's lane this way); refused while side
        streams still target the lane for their merge."""
        m = self.mains[lane]
        if not m.active:
            return
        if lane in self._lanes_with_children():
            raise ValueError(f"cannot retire main lane {lane}: side streams still target it for their merge")
        self.drain()
        self.window.on_event()  # composition change: back to the base window
        self.state.main_active[lane] = False
        self.stats["aux_dispatches"] += 1
        m.text += self._decoder(m.agent_id).flush()  # final text == decode(tokens)
        self.router.reset(m.agent_id)
        self.prism.release(m.agent_id)
        self.registry.release(m.agent_id)
        self._decoders.pop(m.agent_id, None)
        m.active = False
        self.history.append({"event": "retire", "agent": m.agent_id})

    # ------------------------------------------------------------------
    # memory tiers: hibernate parks an agent's lane in the store (card →
    # warm host memory → cold disk); wake prefetches it back on the store's
    # worker thread and commits it at a window boundary
    # ------------------------------------------------------------------
    def _gather_main_lane(self, lane: int) -> dict:
        return gather_main_lane(self.state, lane)

    def _gather_side_lane(self, lane: int) -> dict:
        """On a lane group every rank gets the lane: a broadcast from its
        owner (the other ranks' own lane 0 gives the shapes)."""
        i = self._lanes.local(lane)
        j, st = 0 if i is None else i, self.state
        snap = {"caches": model_lib.lane_caches(st.side_caches, j), "tok": st.side_tok[j],
                "pos": st.side_pos[j], "step": st.side_step[j], "plen": st.side_plen[j],
                "prompt": st.side_prompt[j], "hidden": st.side_hidden[j]}
        if self.mesh is not None:
            snap = lane_rules.lane_gather(self.mesh, snap, self._lanes.owner(lane))
        return snap

    def _deactivate_side(self, lane: int):
        i = self._lanes.local(lane)
        if i is not None:
            self.state.side_active[i] = False

    def _evict_lru_main(self) -> str | None:
        blocked = self._lanes_with_children()
        cands = [r for r in self.registry.with_status(ACTIVE, "main") if r.lane not in blocked]
        if not cands:
            return None
        rec = min(cands, key=lambda r: r.last_event)
        self.hibernate(rec.agent_id)
        return rec.agent_id

    def hibernate(self, agent_id: str):
        """Move an agent's lane off the card: copy its caches and per-lane
        scalars into the store's warm tier (ONE host sync, at a drain
        boundary, never inside a window) and free the lane. The router's
        retained tail and the UTF-8 decoder's pending bytes stay with the
        agent, so a tag or a codepoint split across the hibernation still
        completes after the wake."""
        rec = self.registry.get(agent_id)
        if rec.status != ACTIVE:
            raise ValueError(f"agent {agent_id!r} is not active (status={rec.status})")
        lane, kind = rec.lane, rec.kind
        view = (self.mains if kind == "main" else self.sides)[lane]
        assert view.agent_id == agent_id
        if kind == "main" and lane in self._lanes_with_children():
            raise ValueError(f"cannot hibernate {agent_id!r}: side streams still target "
                             f"main lane {lane} for their merge")
        self.drain()  # boundary-align: no host sync inside a window
        self.window.on_event()
        snap = self._gather_main_lane(lane) if kind == "main" else self._gather_side_lane(lane)
        sp = (self._main_sp if kind == "main" else self._side_sp)[lane]
        # durable bookkeeping rides the snapshot (and a cold blob's frame
        # metadata): what a restarted process needs to re-adopt the agent
        meta = {
            "kind": kind,
            "view": _view_to_meta(view),
            "sampling": dataclasses.asdict(sp),
            "router": self.router.export_state(agent_id),
            "hibernate_tick": self.stats["ticks"],
            "utf8_pending": list(self._decoder(agent_id).pending),
        }
        self.store.put(agent_id, snap, meta=meta)  # the copy off the card: the one sync
        if kind == "main":
            self.state.main_active[lane] = False
            self.mains[lane] = AgentView(f"main{lane}", lane, "main")
        else:
            self._deactivate_side(lane)
            self.sides[lane] = AgentView(f"side{lane}", lane, "side")
        self.stats["aux_dispatches"] += 2
        self.stats["host_syncs"] += 1
        self.stats["hibernates"] += 1
        view.active, view.lane = False, -1
        self.registry.hibernate(agent_id, {"view": view, "sampling": sp})
        self.prism.release(agent_id)
        self.history.append({"event": "hibernate", "agent": agent_id, "kind": kind})

    def wake(self, agent_id: str, *, wait: bool = False, deadline_s: float | None = None):
        """Bring a hibernated agent back toward a lane. Returns at once after
        starting the prefetch (the store's worker reads the warm or cold
        snapshot and enqueues its copy to the card); the wake *commits* into
        a free lane at the next window boundary inside :meth:`run`, without
        flushing the pipeline. ``wait=True`` blocks until the agent is live.

        Failures degrade: transient read failures retry inside the store;
        ``deadline_s`` (default ``wake_deadline_s``) bounds the promotion. A
        wake that fails with the snapshot intact leaves the agent HIBERNATED
        (counted in ``stats["wake_failures"]``); a lost snapshot marks it
        LOST, frees no lane, and the engine keeps ticking."""
        rec = self.registry.get(agent_id)
        if rec.status == ACTIVE:
            return (self.mains if rec.kind == "main" else self.sides)[rec.lane]
        if rec.status != HIBERNATED:
            raise ValueError(f"agent {agent_id!r} has no hibernated context (status={rec.status})")
        if agent_id not in self._wake_tickets:
            self._wake_tickets[agent_id] = self.store.prefetch(
                agent_id, self._put,
                deadline_s=self.wake_deadline_s if deadline_s is None else deadline_s,
            )
            self._pending_wakes.append(agent_id)
        if wait:
            self.flush_wakes()
            rec = self.registry.get(agent_id)
            if rec.status != ACTIVE:
                if rec.status == LOST:
                    raise SnapshotLostError(agent_id, "context permanently lost during wake")
                raise RuntimeError(f"wake of {agent_id!r} did not land "
                                   f"(status={rec.status}: lane-starved or wake failed)")
            return (self.mains if rec.kind == "main" else self.sides)[rec.lane]
        return rec

    def flush_wakes(self):
        """Block until every pending wake has committed (or is lane-starved)."""
        self.drain()
        self._commit_ready_wakes(wait=True)

    def _commit_ready_wakes(self, *, wait: bool = False, mark_fresh: bool = False) -> int:
        """Land the prefetched wakes whose tickets are ready (all of them
        with ``wait=True``). Callers guarantee a window boundary (ring
        cursor 0): the scatters here join the stream before the next
        window. ``mark_fresh``: a fetched window is still to be
        post-processed, which the woken lanes were not part of."""
        if not self._pending_wakes:
            return 0
        assert self._pending == 0, "wake commit must happen at a window boundary"
        # supervision: a dead prefetch thread fails its in-flight ticket
        # here (instead of hanging a waiter) and is respawned
        self.store.heal_worker()
        tickets = [self._wake_tickets[aid] for aid in self._pending_wakes]
        for ticket in tickets:
            ticket.expire()  # host-side deadline: a stuck worker cannot block this
            if wait and not ticket.ready():
                try:
                    ticket.result(timeout=ticket.remaining())
                except Exception:
                    pass  # the terminal state is recorded on the ticket
                ticket.expire()
        # on a lane group every rank takes the same branch: a wake fails
        # (or is lost) if it did on any rank, and commits once ready on all
        failed = lane_rules.agree(self.mesh, [t.failed() for t in tickets], every=False)
        lost = lane_rules.agree(self.mesh, [t.failed() and (isinstance(t.error, KeyError) or aid not in self.store)
                                            for aid, t in zip(self._pending_wakes, tickets)], every=False)
        ready = lane_rules.agree(self.mesh, [t.ready() for t in tickets], every=True)
        committed, still = 0, []
        for aid, ticket, f, gone, r in zip(self._pending_wakes, tickets, failed, lost, ready):
            if f:
                self._fail_wake(aid, ticket.error, lost=gone)
                continue  # degraded, not pending: the engine keeps ticking
            if not r:
                still.append(aid)
                continue
            if self._commit_wake(aid, ticket, mark_fresh=mark_fresh):
                committed += 1
            else:
                still.append(aid)  # lane-starved: stays pending
        self._pending_wakes = still
        return committed

    def _fail_wake(self, agent_id: str, err: BaseException | None, *, lost: bool) -> None:
        """A wake ticket failed. A KeyError-family failure (quarantined
        blob, vanished file, dropped snapshot) means the context is gone:
        the agent is LOST (``lost``, agreed over a lane group). Anything
        else (deadline, dead worker, exhausted retries) leaves the snapshot
        intact: the agent stays HIBERNATED and a later wake may succeed."""
        self._wake_tickets.pop(agent_id, None)
        if lost:
            self.registry.mark_lost(agent_id)
            self.store.drop(agent_id)
            self.router.reset(agent_id)
            self._decoders.pop(agent_id, None)
            self.stats["lost_agents"] += 1
            self.history.append({"event": "lost", "agent": agent_id, "error": repr(err)})
        else:
            self.stats["wake_failures"] += 1
            self.history.append({"event": "wake_failed", "agent": agent_id, "error": repr(err)})

    def _commit_wake(self, agent_id: str, ticket, *, mark_fresh: bool = False) -> bool:
        """Scatter a prefetched snapshot into a free lane, in place. The
        stream waits for the prefetch's copies (no host sync) and the
        prefetched tensors stay reserved until the scatters that read them
        have run."""
        rec = self.registry.get(agent_id)
        kind = rec.kind
        lane = self._free_main_lane() if kind == "main" else self._free_side_lane()
        if lane < 0:
            return False
        part = ready_on_stream(*ticket.result(), self.device)
        del self._wake_tickets[agent_id]
        view, sp = rec.saved["view"], rec.saved["sampling"]
        st = self.state
        if kind == "main":
            self._main_sp[lane] = sp
            model_lib.write_lane(st.main_caches, part["caches"], lane)
            for dst, key in ((st.main_tok, "tok"), (st.main_pos, "pos"), (st.main_hidden, "hidden")):
                dst[lane].copy_(part[key])
            st.main_active[lane].fill_(True)  # a fill: no host sync in the commit
            st.main_samp.set_lane(lane, *lane_values(sp))
            self.mains[lane] = view
        else:
            self._side_sp[lane] = sp
            # on a lane group every rank holds the snapshot; its owner
            # writes the lane, which may be another rank's than before
            i = lane_rules.lane_scatter(self._lanes, st.side_caches, part["caches"], lane)
            if i is not None:
                for dst, key in ((st.side_tok, "tok"), (st.side_pos, "pos"), (st.side_step, "step"),
                                 (st.side_plen, "plen"), (st.side_prompt, "prompt"), (st.side_hidden, "hidden")):
                    dst[i].copy_(part[key])
                st.side_active[i].fill_(True)
                st.side_samp.set_lane(i, *lane_values(sp))
            self.sides[lane] = view
        view.lane, view.active = lane, True
        self.stats["aux_dispatches"] += 2 if kind == "main" else 3
        self.stats["wakes"] += 1
        self.prism.acquire(agent_id)
        self.registry.bind(agent_id, lane).bound_tick = self.stats["ticks"]
        self.store.drop(agent_id)
        self.window.on_event()
        if mark_fresh:
            self._fresh_wakes.add((kind, lane))
        self.history.append({"event": "wake", "agent": agent_id, "lane": lane})
        return True

    def adopt_hibernated(self) -> list[str]:
        """Crash recovery: after ``store.recover()`` rebuilt the cold index
        from disk, re-register every snapshot whose metadata names an agent
        this engine does not hold, with its view, sampling parameters, router
        tail and UTF-8 pending bytes. Adopted agents come back HIBERNATED; a
        :meth:`wake` makes them live, and their greedy streams continue
        bitwise. Returns the adopted ids."""
        adopted = []
        for key in self.store.keys():
            meta = self.store.meta_of(key)
            if not isinstance(meta, dict) or meta.get("kind") not in ("main", "side"):
                continue
            if key in self.registry and self.registry.get(key).status in (ACTIVE, HIBERNATED):
                continue  # a live identity wins over its stale snapshot
            view = _view_from_meta(meta["view"])
            sp = SamplingParams(**meta["sampling"])
            self.registry.register(key, meta["kind"])
            self.registry.hibernate(key, {"view": view, "sampling": sp})
            if meta.get("router"):
                self.router.restore_state(key, meta["router"])
            if meta.get("utf8_pending"):
                self._decoder(key).restore(bytes(meta["utf8_pending"]))
            self.stats["recoveries"] += 1
            self.history.append({"event": "adopt", "agent": key})
            adopted.append(key)
        return adopted

    def _auto_hibernate(self) -> int:
        """Idle-tick demotion: rivers whose last submit or wake is
        ``hibernate_idle_ticks`` virtual ticks old or more go to the warm
        tier. Runs at boundaries with nothing in flight."""
        if self.hibernate_idle_ticks is None:
            return 0
        blocked = self._lanes_with_children()
        due = [r for r in self.registry.with_status(ACTIVE, "main")
               if self.stats["ticks"] - r.bound_tick >= self.hibernate_idle_ticks and r.lane not in blocked]
        for r in due:
            self.hibernate(r.agent_id)
        return len(due)

    # ------------------------------------------------------------------
    def _merge_side(self, s: AgentView, thought: str):
        with trace.span("engine.merge", parent=self.mains[s.parent_lane].agent_id, agent=s.agent_id) as sp:
            ids = self.tok.encode(thought)[-self.inject_tokens:]
            ids = ids + [self.tok.pad_id] * (self.inject_tokens - len(ids))
            dev = self.device
            toks = torch.tensor([ids] * self.n_main, dtype=torch.int32, device=dev)
            vpos = torch.tensor([m.position for m in self.mains], dtype=torch.int32, device=dev)  # virtual index
            lane_mask = torch.arange(self.n_main, device=dev) == s.parent_lane
            st = self.state
            _, accept, score = injection.merge_thought(
                self._params, self.cfg, st.main_caches, st.main_hidden, toks, vpos, lane_mask, self.theta,
            )
            self._deactivate_side(s.lane)
            self.stats["aux_dispatches"] += 2
            self.stats["state_blend_bytes"] += self._lane_state_bytes
            with trace.span("merge.sync"):
                decision = torch.stack([accept.float(), score]).cpu()  # drain-time sync
            self.stats["host_syncs"] += 1
            accepted = bool(decision[0, s.parent_lane])
            sp.set(accepted=accepted)
            self.history.append({
                "event": "merge",
                "agent": s.agent_id,
                "accepted": accepted,
                "gate_score": float(decision[1, s.parent_lane]),
                "thought": thought[:80],
            })
            self.router.reset(s.agent_id)
            self.prism.release(s.agent_id)
            self.registry.release(s.agent_id)
            self._decoders.pop(s.agent_id, None)
            s.active = False

    # ------------------------------------------------------------------
    def memory_report(self) -> dict:
        """Eq. 1 accounting over the live lanes (drains first), with the
        memory tiers' bytes and the registry's agent counts."""
        self.drain()
        per_agent = {}
        for m in self.mains:
            if m.active:
                per_agent[m.agent_id] = tree_bytes(_lane_slice(self.state.main_caches, m.lane))
        for s in self.sides:
            if s.active:
                # every side lane has the same shapes: a lane this rank holds
                i = self._lanes.local(s.lane)
                per_agent[s.agent_id] = tree_bytes(_lane_slice(self.state.side_caches, 0 if i is None else i))
        # hibernated agents are absent from per_agent: their device share
        # is zero; the tiers report their host and disk bytes
        rep = self.prism.memory_report(per_agent, store_report=self.store.report(),
                                       agents=self.registry.counts())
        rep["per_agent_bytes"] = dict(per_agent)
        # the serving-dtype cast is a real resident copy where the compute
        # dtype differs from the parameter dtype (shared leaves cost 0)
        cast_extra = sum(
            b.numel() * b.element_size()
            for a, b in zip(model_lib.tree_leaves(self.prism.params), model_lib.tree_leaves(self._params))
            if b.data_ptr() != a.data_ptr()
        )
        rep["serving_weight_bytes"] = cast_extra
        rep["total_bytes"] += cast_extra
        return rep
