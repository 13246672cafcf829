"""The Cortex Engine — River & Stream topology on one card.

Port of the JAX package's ``repro.core.engine`` (the serial dispatch→drain
loop). One Prism (shared weights) drives:

* the river lanes, decoding over full KV caches;
* the stream (side) lanes, decoding over landmark-compressed synapse caches
  through the ``synapse_attention`` kernel;
* per-lane sampling, and small on-device token rings.

A window is ``sync_every`` virtual ticks: a Python loop of ticks whose
sampled tokens go to the rings, with no host sync inside it (no
``.item()``, ``.tolist()``, ``.cpu()`` or boolean-mask indexing). Each
drain copies the rings to the host once, then runs the host-side control
plane: UTF-8 decoding, the router, spawns and merges.

* Spawn = hybrid landmark compression of the parent lane only (paper §3.3),
  every layer at once through ONE ``landmark_score`` launch;
* merge = Validation Gate (§3.5) + Referential Injection (§3.6) in one step
  (``injection.merge_thought``).

Caches and per-lane state are updated in place where the reference donated
its buffers. ``stats`` keeps the reference's accounting: a window counts as
one tick dispatch, each ring fetch and each merge decision as one host sync.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field

import torch

from repro_torch.core import injection
from repro_torch.core import synapse as synapse_lib
from repro_torch.core.prism import Prism, tree_bytes
from repro_torch.core.router import CortexRouter
from repro_torch.data.tokenizer import ByteTokenizer
from repro_torch.device import resolve_device
from repro_torch.kernels.ops import ring_append
from repro_torch.models import cache as cache_lib
from repro_torch.models import model as model_lib
from repro_torch.models.config import ModelConfig
from repro_torch.serving.sampler import (
    LaneSampling, SamplingParams, cat_lanes, lane_params, lane_values,
    sample_lanes, static_flags,
)


def _lane_slice(caches: model_lib.ModelCaches, lane: int) -> list:
    """Views of one batch lane's tensors (axis 1; axis 0 is the stacked
    layer dim)."""
    return [a[:, lane] for c in caches.groups for a in cache_lib.tensors(c)]


def spawn_caches(cfg: ModelConfig, main_caches: model_lib.ModelCaches, spec: model_lib.CacheSpec):
    """Compress a main agent's caches into fresh side-agent synapse caches.

    Hybrid landmark compression with the density term from the
    ``landmark_score`` kernel. The paper's Q_t (the parent's current query)
    is approximated by the newest resident key, broadcast to the query
    heads, as in the reference. The stacked layer axis is folded into the
    batch axis, so every layer compresses in ONE kernel launch.
    """
    return model_lib.ModelCaches(groups=tuple(
        _compress_stacked(cfg, c, spec) for c in main_caches.groups
    ))


def _compress_stacked(cfg: ModelConfig, c: cache_lib.FullCache, spec: model_lib.CacheSpec):
    """[L, B, ...] FullCache -> [L, B, ...] SynapseCache, layers folded into
    the batch axis (one scoring sweep for the whole stack)."""
    L, B = c.pos.shape[:2]
    flat = cache_lib.map_cache(lambda a: a.reshape((L * B,) + a.shape[2:]), c)
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


def init_tick_state(cfg: ModelConfig, *, n_main: int, max_side: int, main_spec, side_spec,
                    ring_capacity: int, side_prompt_cap: int, main_sampling: SamplingParams,
                    side_sampling: SamplingParams, seed: int, device) -> TickState:
    d = cfg.d_model
    M, S, R, P = n_main, max_side, ring_capacity, side_prompt_cap
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    zi = lambda *s: torch.zeros(s, dtype=torch.int32, device=device)
    return TickState(
        gen=gen,
        main_tok=zi(M), main_pos=zi(M),
        main_active=torch.zeros(M, dtype=torch.bool, device=device),
        main_hidden=torch.zeros((M, d), dtype=torch.float32, device=device),
        main_ring=torch.full((M, R), -1, dtype=torch.int32, device=device),
        main_samp=lane_params(main_sampling, M, device=device),
        main_caches=model_lib.init_caches(cfg, M, main_spec, device=device),
        side_tok=zi(S), side_pos=zi(S),
        side_active=torch.zeros(S, dtype=torch.bool, device=device),
        side_step=zi(S), side_plen=zi(S), side_prompt=zi(S, P),
        side_hidden=torch.zeros((S, d), dtype=torch.float32, device=device),
        side_ring=torch.full((S, R), -1, dtype=torch.int32, device=device),
        side_samp=lane_params(side_sampling, S, device=device),
        side_caches=model_lib.init_caches(cfg, S, side_spec, device=device),
    )


def one_tick(params, st: TickState, cursor: int, *, cfg: ModelConfig, main_spec, side_spec,
             step_sides: bool, use_filters: bool, any_greedy: bool):
    """One scheduler tick on the device, in place: river decode, side
    decode (synapse caches, the ``synapse_attention`` kernel), per-lane
    sampling, ring column ``cursor``. Reads no device value on the host.

    Inactive lanes decode garbage harmlessly (their cursors are frozen and
    their caches are rewritten on admission). ``step_sides=False`` is the
    river-only tick, used while no stream is live.
    """
    m_act, s_act = st.main_active, st.side_active
    M = m_act.shape[0]
    logits_m, hidden_m, _ = model_lib.decode_step(
        params, cfg, {"tokens": st.main_tok, "positions": st.main_pos}, st.main_caches, spec=main_spec,
    )
    if step_sides:
        # teacher-force the on-device task prompt, then free-run from the
        # last sampled token; the sampled token counts from the last forced
        # step on
        forced = st.side_step < st.side_plen
        pidx = torch.clamp(st.side_step, 0, st.side_prompt.shape[1] - 1).long()
        prompt_tok = torch.gather(st.side_prompt, 1, pidx[:, None])[:, 0]
        zero = torch.zeros_like(st.side_tok)
        in_tok = torch.where(s_act, torch.where(forced, prompt_tok, st.side_tok), zero)
        in_pos = torch.where(s_act, st.side_pos, zero)
        logits_s, hidden_s, _ = model_lib.decode_step(
            params, cfg, {"tokens": in_tok, "positions": in_pos}, st.side_caches, spec=side_spec,
        )
        samp = sample_lanes(
            st.gen, torch.cat([logits_m, logits_s]), cat_lanes(st.main_samp, st.side_samp),
            use_filters=use_filters, any_greedy=any_greedy,
        )
        samp_m, samp_s = samp[:M], samp[M:]
    else:
        samp_m = sample_lanes(st.gen, logits_m, st.main_samp, use_filters=use_filters, any_greedy=any_greedy)

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
        side_prompt_cap: int = 64,
        compute_dtype: str | None = None,
        device=None,
    ):
        """Runs on ``device``, the card unless ``device="cpu"``, which must
        be where the Prism holds the weights. On the CPU the compute dtype
        defaults to f32 (as the reference's CPU serving policy); on the card
        it is the config's (bf16 for the paper's model)."""
        self.device = resolve_device(device)
        if prism.device != self.device:
            raise ValueError(f"the Prism's weights are on {prism.device}, the engine runs on {self.device}")
        self.prism = prism
        cfg = prism.cfg
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
        # the router's overlap tail covers the longest round-tripped tag and
        # one drain window of text (8 bytes/token bounds UTF-8 expansion)
        self.router = CortexRouter(tail=max(256, 8 * self.sync_every, side_prompt_cap + 16))
        self.main_spec = model_lib.CacheSpec(kind="full", capacity=main_capacity)
        self.side_spec = side_spec or model_lib.CacheSpec(
            kind="synapse", n_landmarks=64, window=64, n_inject=inject_tokens
        )
        self.n_main, self.max_side = n_main, max_side
        self.mains = [AgentView(f"main{i}", i, "main") for i in range(n_main)]
        self.sides = [AgentView(f"side{i}", i, "side") for i in range(max_side)]
        # host mirrors of the per-lane sampling tensors: they pick the
        # sampler's fast path without reading the device
        self._main_sp: list[SamplingParams] = [self.sampling] * n_main
        self._side_sp: list[SamplingParams] = [self.side_sampling] * max_side
        # per-agent incremental UTF-8 decoders: a codepoint split across a
        # window boundary never becomes U+FFFD in the agent's text
        self._decoders: dict[str, object] = {}
        self.history: list[dict] = []
        self.stats = {
            "ticks": 0, "tick_dispatches": 0, "macro_dispatches": 0,
            "aux_dispatches": 0, "host_syncs": 0, "drains": 0, "window_hist": {},
        }
        self._pending = 0  # ticks since last drain (== ring cursor)
        # serving-dtype weights, cast once; the Prism's copy stays the master
        self._params = model_lib.cast_params(prism.params, cfg)
        self.state = init_tick_state(
            cfg, n_main=n_main, max_side=max_side, main_spec=self.main_spec,
            side_spec=self.side_spec, ring_capacity=self.sync_every,
            side_prompt_cap=side_prompt_cap, main_sampling=self.sampling,
            side_sampling=self.side_sampling, seed=seed, device=self.device,
        )

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

    # ------------------------------------------------------------------
    def submit(self, prompt: str, lane: int = 0, sampling: SamplingParams | None = None):
        """Start (or restart) the main agent on ``lane`` with ``prompt``:
        prefill in place into the lane's cache. ``sampling`` overrides the
        engine default for this lane only. Tags in the prompt spawn at once."""
        self.drain()  # align host mirrors to a window boundary
        cur = self.mains[lane]
        if cur.active:  # whoever held the lane loses its context
            self.prism.release(cur.agent_id)
            self.router.reset(cur.agent_id)
            self._decoders.pop(cur.agent_id, None)
        ids = self.tok.encode(prompt, bos=True)
        toks = torch.tensor([ids], dtype=torch.int32, device=self.device)
        st = self.state
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
        m = AgentView(f"main{lane}", lane, "main")
        self.mains[lane] = m
        m.text, m.tokens = prompt, list(ids)
        m.position, m.active, m.steps = len(ids), True, 0
        m.prompt_len = len(ids)
        self._decoders[m.agent_id] = self.tok.stream_decoder()
        self.prism.acquire(m.agent_id)
        self.router.reset(m.agent_id)
        for tr in self.router.feed(m.agent_id, prompt):
            if tr.kind == "task":
                self._spawn_side(m, tr.payload)
        return m

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
        """Advance ``n <= sync_every - pending`` virtual ticks. No drain, no
        host sync — callers close the window."""
        assert self._pending + n <= self.sync_every
        step_sides = any(s.active for s in self.sides)
        use_filters, any_greedy = self._sampler_flags(step_sides)
        for i in range(n):
            one_tick(
                self._params, self.state, self._pending + i, cfg=self.cfg,
                main_spec=self.main_spec, side_spec=self.side_spec, step_sides=step_sides,
                use_filters=use_filters, any_greedy=any_greedy,
            )
        self.stats["ticks"] += n
        self.stats["tick_dispatches"] += 1
        if n > 1:
            self.stats["macro_dispatches"] += 1
        hist = self.stats["window_hist"]
        hist[n] = hist.get(n, 0) + 1
        self._pending += n

    def run(self, n_ticks: int):
        """Advance ``n_ticks`` virtual ticks in ``ceil(n_ticks/sync_every)``
        windows: the serial dispatch → drain → dispatch loop."""
        remaining = n_ticks
        while remaining > 0:
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

    # ------------------------------------------------------------------
    def drain(self):
        """Copy the device token rings to the host (ONE transfer), update
        the agent views, and run the router/spawn/merge control plane."""
        n = self._pending
        if n == 0:
            return
        self._postprocess(self._fetch_rings(), n)

    def _fetch_rings(self):
        st = self.state
        rings = torch.cat([st.main_ring, st.side_ring]).cpu().numpy()
        self.stats["host_syncs"] += 1
        self._pending = 0
        return rings[: self.n_main], rings[self.n_main:]

    def _postprocess(self, rings, n: int):
        """The window's host-side control plane over the fetched rings:
        decode text, feed the router, complete/merge sides, spawn the
        rivers' tasks."""
        main_ring, side_ring = rings
        self.stats["drains"] += 1

        # 1. rivers: append the window's tokens (incremental UTF-8 decode)
        main_chunks: dict[int, str] = {}
        for m in self.mains:
            if not m.active:
                continue
            toks = [int(t) for t in main_ring[m.lane, :n] if t >= 0]
            chunk = self._decoder(m.agent_id).feed(toks)
            m.tokens.extend(toks)
            m.text += chunk
            m.position += len(toks)
            m.steps += len(toks)
            main_chunks[m.lane] = chunk

        # 2. streams: append, detect completion (trigger or step budget)
        finished = []
        for s in self.sides:
            if not s.active:
                continue
            s.steps += n
            s.position += n
            raw = [int(t) for t in side_ring[s.lane, :n] if t >= 0]
            allowed = max(0, self.side_max_steps - (len(s.tokens) - s.prompt_len))
            raw = raw[:allowed]
            s.tokens.extend(raw)
            chunk = self._decoder(s.agent_id).feed(raw)
            s.text += chunk
            trig = [t for t in self.router.feed(s.agent_id, chunk) if t.kind in ("done", "answer")]
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
        for s, thought in finished:
            self._merge_side(s, thought)

        # 4. river triggers spawn new streams
        for m in self.mains:
            if not m.active or m.lane not in main_chunks:
                continue
            for tr in self.router.feed(m.agent_id, main_chunks[m.lane]):
                if tr.kind == "task":
                    self._spawn_side(m, tr.payload)

    # ------------------------------------------------------------------
    def _free_side_lane(self) -> int:
        for s in self.sides:
            if not s.active:
                return s.lane
        return -1

    def _spawn_lane(self, parent_lane: int, side_lane: int):
        """Compress ONE parent lane into ONE side lane, in place."""
        st = self.state
        parent = model_lib.ModelCaches(groups=tuple(
            cache_lib.map_cache(lambda a: a[:, parent_lane:parent_lane + 1], c)
            for c in st.main_caches.groups
        ))
        comp = spawn_caches(self.cfg, parent, self.side_spec)
        for dst, src in zip(st.side_caches.groups, comp.groups):
            for a, b in zip(cache_lib.tensors(dst), cache_lib.tensors(src)):
                a[:, side_lane:side_lane + 1].copy_(b)

    def _spawn_side(self, parent: AgentView, task: str, sampling: SamplingParams | None = None):
        lane = self._free_side_lane()
        if lane < 0:
            return None  # admission policy: drop when streams are saturated
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
        st = self.state
        st.side_prompt[lane] = torch.tensor(padded, dtype=torch.int32, device=self.device)
        st.side_plen[lane] = len(ids)
        st.side_step[lane] = 0
        st.side_tok[lane] = ids[-1]
        st.side_pos[lane] = parent.position
        st.side_active[lane] = True
        st.side_samp.set_lane(lane, *lane_values(self._side_sp[lane]))
        self.stats["aux_dispatches"] += 2
        s = self.sides[lane]
        s.task, s.text = task, ""
        self._decoders[s.agent_id] = self.tok.stream_decoder()
        s.parent_lane = parent.lane
        s.tokens = list(ids)
        s.position = parent.position  # continues the parent's positional frame
        s.active, s.steps = True, 0
        s.prompt_len = len(ids)
        self.prism.acquire(s.agent_id)
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
        self.state.side_active[lane] = False
        self.stats["aux_dispatches"] += 1
        self.router.reset(s.agent_id)
        self.prism.release(s.agent_id)
        self._decoders.pop(s.agent_id, None)
        s.active = False
        self.history.append({"event": "retire", "agent": s.agent_id})

    def retire_main(self, lane: int):
        """Retire a river lane without replacing it; refused while side
        streams still target the lane for their merge."""
        m = self.mains[lane]
        if not m.active:
            return
        if any(s.active and s.parent_lane == lane for s in self.sides):
            raise ValueError(f"cannot retire main lane {lane}: side streams still target it for their merge")
        self.drain()
        self.state.main_active[lane] = False
        self.stats["aux_dispatches"] += 1
        m.text += self._decoder(m.agent_id).flush()  # final text == decode(tokens)
        self.router.reset(m.agent_id)
        self.prism.release(m.agent_id)
        self._decoders.pop(m.agent_id, None)
        m.active = False
        self.history.append({"event": "retire", "agent": m.agent_id})

    # ------------------------------------------------------------------
    def _merge_side(self, s: AgentView, thought: str):
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
        st.side_active[s.lane] = False
        self.stats["aux_dispatches"] += 2
        decision = torch.stack([accept.float(), score]).cpu()  # drain-time sync
        self.stats["host_syncs"] += 1
        self.history.append({
            "event": "merge",
            "agent": s.agent_id,
            "accepted": bool(decision[0, s.parent_lane]),
            "gate_score": float(decision[1, s.parent_lane]),
            "thought": thought[:80],
        })
        self.router.reset(s.agent_id)
        self.prism.release(s.agent_id)
        self._decoders.pop(s.agent_id, None)
        s.active = False

    # ------------------------------------------------------------------
    def memory_report(self) -> dict:
        """Eq. 1 accounting over the live lanes (drains first)."""
        self.drain()
        per_agent = {}
        for m in self.mains:
            if m.active:
                per_agent[m.agent_id] = tree_bytes(_lane_slice(self.state.main_caches, m.lane))
        for s in self.sides:
            if s.active:
                per_agent[s.agent_id] = tree_bytes(_lane_slice(self.state.side_caches, s.lane))
        rep = self.prism.memory_report(per_agent)
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
