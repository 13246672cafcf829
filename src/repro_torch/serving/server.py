"""Continuous-batching single-model server (no multi-agent logic).

Port of the JAX package's ``repro.serving.server``: the plain-serving
baseline the paper compares against. N requests = N full KV caches. Lanes
are recycled as requests finish; prefill is per admission, decode is one
batched step per tick.

Pipelined drain (the default of :meth:`BatchServer.run_until_done`): the
sampled tokens stay on the device and feed the next decode step, so step
*t+1* is dispatched BEFORE step *t*'s tokens are copied to the host;
detokenisation, EOS checks and admission bookkeeping overlap the device's
next step. Completions by ``max_new_tokens`` are host-predictable, so the
server speculates only while no lane is at its budget; a surprise EOS
rolls the speculative step back and re-runs it from the corrected lane
composition, so the streams are bitwise those of the serial ``tick()``
loop.

The decode step writes the caches in place (the reference's decode did not
donate, and kept the old caches for its rollback). The undo record taken
before a speculative step is therefore what that step changes: per cache,
the ``length`` cursors, the whole ``score`` row (every step rescales it),
and the one k/v/pos slot each lane writes; for synapse caches, every
tensor (they are small). The generator state and the host positions are
restored with them.

Per-lane sampling tensors ride a :class:`~repro_torch.serving.sampler.SampCache`,
invalidated on EVERY lane-composition change (admission, completion and
:meth:`BatchServer.cancel`): a stale cache would hand a recycled lane the
previous request's sampling parameters.

Parking: an idle request can be :meth:`BatchServer.park`-ed: a copy of
its lane's KV slice and its position moves into a
:class:`~repro_torch.memory.SynapseStore` (warm host memory, cold disk
under pressure) and the lane frees for other traffic.
:meth:`BatchServer.unpark` prefetches the slice back on the store's worker
thread; the request re-enters at the next admission boundary (where nothing
is in flight, so no undo record spans a park or an unpark) with its exact
cache bytes and position, and its greedy continuation is unchanged.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.data.tokenizer import ByteTokenizer
from repro_torch.device import resolve_device, to_device
from repro_torch.memory import SynapseStore
from repro_torch.memory.store import device_put_fn, ready_on_stream
from repro_torch.models import cache as cache_lib
from repro_torch.models import model as model_lib
from repro_torch.models.config import ModelConfig
from repro_torch.serving.sampler import SampCache, SamplingParams, sample_lanes


@dataclass
class Request:
    rid: int
    prompt: str
    max_new_tokens: int = 64
    sampling: SamplingParams | None = None  # None -> server default
    tokens: list = field(default_factory=list)
    text: str = ""
    done: bool = False
    lane: int = -1
    prompt_len: int = 0  # len(encode(prompt, bos=True)), set at admission
    error: str | None = None
    # how the request left the server: "" while live, then "ok" (EOS or
    # budget), "cancelled" (a cancel is an observable completion) or "error"
    status: str = ""
    # stateful UTF-8 decoder: a codepoint split across steps never becomes
    # U+FFFD in ``text``
    decoder: object = field(default=None, repr=False)


def _undo_record(caches: model_lib.ModelCaches) -> list:
    """What one in-place decode step will change, copied: per full cache
    the length cursors, the score rows and the k/v/pos slot at each lane's
    cursor; per synapse cache every tensor."""
    rec = []
    for c in caches.groups:
        if isinstance(c, cache_lib.FullCache):
            slot = c.length.clamp(max=c.capacity - 1).long()  # [L, B]
            L, B = slot.shape
            li = torch.arange(L, device=slot.device)[:, None]
            bi = torch.arange(B, device=slot.device)[None, :]
            rows = tuple(a[li, bi, slot].clone() for a in (c.k, c.v, c.pos))
            rec.append((slot, rows, c.score.clone(), c.length.clone()))
        else:
            rec.append([a.clone() for a in cache_lib.tensors(c)])
    return rec


def _undo(caches: model_lib.ModelCaches, rec: list) -> None:
    """In place: the caches as they were when ``rec`` was taken."""
    for c, r in zip(caches.groups, rec):
        if isinstance(c, cache_lib.FullCache):
            slot, rows, score, length = r
            L, B = slot.shape
            li = torch.arange(L, device=slot.device)[:, None]
            bi = torch.arange(B, device=slot.device)[None, :]
            for a, row in zip((c.k, c.v, c.pos), rows):
                a[li, bi, slot] = row
            c.score.copy_(score)
            c.length.copy_(length)
        else:
            for a, b in zip(cache_lib.tensors(c), r):
                a.copy_(b)


class BatchServer:
    def __init__(
        self,
        params,
        cfg: ModelConfig,
        tokenizer: ByteTokenizer,
        *,
        n_lanes: int = 8,
        capacity: int = 1024,
        sampling: SamplingParams = SamplingParams(temperature=0.8),
        cache_kind: str = "full",
        seed: int = 0,
        store: SynapseStore | None = None,
        wake_deadline_s: float | None = None,
        device=None,
    ):
        """Runs on ``device``, the card unless ``device="cpu"``; ``params``
        must already be there. Decodes in the config's compute dtype.
        ``store`` holds parked requests (a fresh warm-only store by
        default); ``wake_deadline_s`` bounds every unpark's promotion unless
        the call names its own deadline."""
        self.device = resolve_device(device)
        if params["embed"].device != self.device:
            raise ValueError(f"the weights are on {params['embed'].device}, the server runs on {self.device}")
        self.params = model_lib.cast_params(params, cfg)
        self.cfg, self.tok = cfg, tokenizer
        self.sampling = sampling
        self.spec = model_lib.CacheSpec(kind=cache_kind, capacity=capacity)
        self.caches = model_lib.init_caches(cfg, n_lanes, self.spec, device=self.device)
        self.n_lanes = n_lanes
        self.lanes: list[Request | None] = [None] * n_lanes
        self.positions = np.zeros(n_lanes, np.int64)
        self.queue: list[Request] = []
        self.finished: list[Request] = []
        # parked requests: lane-less, their KV slice in the store's tiers
        self.store = store if store is not None else SynapseStore()
        self.wake_deadline_s = wake_deadline_s
        self.parked: dict[int, Request] = {}
        self._resume: list[tuple[Request, object]] = []  # (request, WakeTicket)
        self._put = device_put_fn(self.device)
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(seed)
        self._rid = 0
        # per-lane sampling tensors and fast-path flags, rebuilt only when
        # the lane composition changes (see SampCache)
        self._samp_cache = SampCache(self.device)
        self.stats = {"steps": 0, "overlapped": 0, "rollbacks": 0, "lost_requests": 0, "cancelled": 0}
        # serving front-end hooks. ``taps[rid]`` is called as
        # tap(req, chunk, toks, done) when a step's tokens land on the host;
        # chunks are incremental-decoder output, so their concatenation is
        # the final text. ``admission_hook`` runs at the top of every
        # admission boundary, where nothing is in flight.
        self.taps: dict[int, object] = {}
        self.admission_hook = None

    def submit(self, prompt: str, max_new_tokens: int = 64,
               sampling: SamplingParams | None = None) -> int:
        """``sampling`` overrides the server default for this request only:
        per-lane parameters share one sampling pass."""
        self._rid += 1
        req = Request(self._rid, prompt, max_new_tokens, sampling)
        req.decoder = self.tok.stream_decoder()
        self.queue.append(req)
        return self._rid

    def _finish(self, req: Request, status: str, error: str | None = None):
        """Every terminal path: the request is done with its outcome, its
        decoder flushes (final text == one-shot decode), it lands in
        ``finished``, and its tap fires once more with done=True."""
        if error is not None:
            req.error = error
        req.status = status
        req.done = True
        tail = req.decoder.flush()
        req.text += tail
        self.finished.append(req)
        tap = self.taps.pop(req.rid, None)
        if tap is not None:
            tap(req, tail, [], True)

    def cancel(self, rid: int) -> bool:
        """Retire a queued, decoding, parked or resuming request. A freed
        lane is a composition change, so the samp cache is invalidated. The
        request finishes with status "cancelled" and is counted."""
        req = None
        for i, r in enumerate(self.queue):
            if r.rid == rid:
                req = self.queue.pop(i)
                break
        if req is None:
            for lane, r in enumerate(self.lanes):
                if r is not None and r.rid == rid:
                    req = r
                    self.lanes[lane] = None
                    self._samp_cache.invalidate()
                    break
        if req is None and rid in self.parked:
            req = self.parked.pop(rid)
            self.store.drop(f"req{rid}")
        if req is None:
            for i, (r, _) in enumerate(self._resume):
                if r.rid == rid:
                    req = r
                    self._resume.pop(i)
                    self.store.drop(f"req{rid}")
                    break
        if req is None:
            return False
        self.stats["cancelled"] += 1
        self._finish(req, "cancelled")
        return True

    # ------------------------------------------------------------------
    def park(self, rid: int) -> bool:
        """Move a decoding request off its lane: a copy of the lane's KV
        slice and its position go to the store (host memory, spilling to
        disk by the store's LRU policy) and the lane frees. Call it between
        steps (nothing in flight). The restore is bitwise, so the request's
        greedy stream continues where it stopped."""
        for lane, req in enumerate(self.lanes):
            if req is not None and req.rid == rid:
                pos = int(self.positions[lane])
                snap = {"caches": model_lib.lane_caches(self.caches, lane),
                        "position": torch.tensor(pos, dtype=torch.int64)}
                # the meta repeats the position, so the unpark reads it
                # without waiting for the card
                self.store.put(f"req{rid}", snap, meta={"kind": "request", "rid": rid, "position": pos})
                self.lanes[lane] = None
                req.lane = -1
                self._samp_cache.invalidate()
                self.parked[rid] = req
                return True
        return False

    def unpark(self, rid: int, *, deadline_s: float | None = None) -> bool:
        """Start the prefetch of a parked request; it re-enters at the next
        admission boundary, before queued prompts (it already paid its
        prefill). ``deadline_s`` (default ``wake_deadline_s``) bounds THIS
        request's promotion: past it the request fails with a recorded
        error; every other stream is untouched."""
        req = self.parked.pop(rid, None)
        if req is None:
            return False
        if deadline_s is None:
            deadline_s = self.wake_deadline_s
        self._resume.append((req, self.store.prefetch(f"req{rid}", self._put, deadline_s=deadline_s)))
        return True

    def _fail_resume(self, req: Request, err: BaseException | None) -> None:
        """The parked snapshot could not be promoted (quarantined blob,
        deadline, dead worker): the request finishes with ``error`` set."""
        self.store.drop(f"req{req.rid}")
        self.stats["lost_requests"] += 1
        self._finish(req, "error", repr(err) if err is not None else "wake failed")

    def _admit_unparked(self, *, wait: bool = False):
        """Land the resume tickets whose prefetch is ready (all of them with
        ``wait=True``) into free lanes. A failed ticket (loss, deadline, a
        dead prefetch worker, healed here) retires its request with
        ``error`` set instead of raising mid-admission."""
        if self._resume:
            self.store.heal_worker()
        still = []
        for req, ticket in self._resume:
            ticket.expire()
            if not ticket.failed():
                lane = next((i for i, r in enumerate(self.lanes) if r is None), -1)
                if lane < 0 or not (wait or ticket.ready()):
                    still.append((req, ticket))
                    continue
                if not ticket.ready():
                    try:
                        ticket.result(timeout=ticket.remaining())
                    except Exception:
                        pass  # the terminal state is recorded on the ticket
                    ticket.expire()
            if ticket.failed():
                self._fail_resume(req, ticket.error)
                continue
            part = ready_on_stream(*ticket.result(), self.device)
            model_lib.write_lane(self.caches, part["caches"], lane)
            self.positions[lane] = self.store.meta_of(f"req{req.rid}")["position"]
            req.lane = lane
            self.lanes[lane] = req
            self._samp_cache.invalidate()
            self.store.drop(f"req{req.rid}")
        self._resume = still

    def _admit(self):
        if self.admission_hook is not None:
            # front-end admission control runs at this boundary only: the
            # hook may push into ``queue`` but never touches device state
            self.admission_hook()
        self._admit_unparked()
        for lane in range(self.n_lanes):
            if self.lanes[lane] is None and self.queue:
                req = self.queue.pop(0)
                ids = self.tok.encode(req.prompt, bos=True)
                toks = torch.tensor([ids], dtype=torch.int32, device=self.device)
                # a fresh lane cache, prefilled, overwrites the lane
                model_lib.prefill_lane(self.params, self.cfg, {"tokens": toks}, self.caches, lane, spec=self.spec)
                req.tokens = list(ids)
                req.lane = lane
                req.prompt_len = len(ids)
                self.positions[lane] = len(ids)
                self.lanes[lane] = req
                self._samp_cache.invalidate()

    # ------------------------------------------------------------------
    def _lane_params(self):
        # empty lanes get the server default: their draws are discarded, so
        # they must not force the greedy path on everyone else
        return [(r.sampling or self.sampling) if r else self.sampling for r in self.lanes]

    def _step(self, toks):
        """ONE batched decode and sampling pass. ``toks`` is a device tensor
        (the host's last tokens, or the previous step's sampled tokens on
        the pipelined path). Returns the sampled tokens on the device and
        advances the occupied lanes' positions. Reads no device value."""
        pos = to_device(self.positions, torch.int32, self.device)
        logits, _, _ = model_lib.decode_step(
            self.params, self.cfg, {"tokens": toks, "positions": pos}, self.caches, spec=self.spec
        )
        lanes_samp, use_filters, any_greedy = self._samp_cache.get(self._lane_params)
        sampled = sample_lanes(self._gen, logits, lanes_samp, use_filters=use_filters, any_greedy=any_greedy)
        for lane, req in enumerate(self.lanes):
            if req is not None:
                self.positions[lane] += 1
        self.stats["steps"] += 1
        return sampled

    def _host_toks(self):
        return to_device([r.tokens[-1] if r else 0 for r in self.lanes], torch.int32, self.device)

    def _commit(self, new_np) -> bool:
        """Apply one step's sampled tokens to the requests; True when the
        lane composition changed (a request finished). Text accrues through
        each request's incremental UTF-8 decoder."""
        changed = False
        for lane, req in enumerate(self.lanes):
            if req is None:
                continue
            t = int(new_np[lane])
            req.tokens.append(t)
            chunk = req.decoder.feed([t])
            req.text += chunk
            gen = len(req.tokens) - req.prompt_len
            tap = self.taps.get(req.rid)
            if tap is not None:
                tap(req, chunk, [t], False)
            if t == self.tok.eos_id or gen >= req.max_new_tokens:
                self.lanes[lane] = None
                self._samp_cache.invalidate()
                changed = True
                self._finish(req, "ok")
        return changed

    def _can_speculate(self) -> bool:
        """The next step may go out before this step's tokens reach the host
        only if the composition provably cannot change: no queued request
        waits for a free lane, and no lane is at its token budget. EOS
        completions stay unpredictable: those cost a rollback instead."""
        if (self.queue or self._resume) and any(r is None for r in self.lanes):
            return False
        for req in self.lanes:
            if req is not None:
                # generated count AFTER the in-flight step commits
                if len(req.tokens) + 1 - req.prompt_len >= req.max_new_tokens:
                    return False
        return True

    def tick(self):
        """One serial step: decode, sample, copy the tokens, commit."""
        self._admit()
        if not any(self.lanes):
            return
        self._commit(self._step(self._host_toks()).cpu().numpy())

    def run_until_done(self, max_ticks: int = 4096, *, pipeline: bool = True):
        """Drive admissions and decode until queue and lanes are empty.

        ``pipeline=True`` (default) keeps the sampled tokens on the device
        and dispatches step *t+1* before step *t*'s tokens are copied; a
        surprise EOS undoes the speculative step and re-runs it from the
        corrected composition, so the streams match the serial loop
        bitwise. ``pipeline=False`` is the serial reference."""
        if not pipeline:
            for _ in range(max_ticks):
                if not self.queue and not any(self.lanes):
                    if not self._resume:
                        break
                    self._admit_unparked(wait=True)  # idle: wait for the tickets
                self.tick()
            return self.finished

        inflight = None  # device tokens of the dispatched, uncommitted step
        ticks = 0
        while ticks < max_ticks:
            if inflight is None:
                self._admit()
                if not any(self.lanes):
                    if self._resume:
                        self._admit_unparked(wait=True)  # idle: wait for the tickets
                        continue
                    break
                inflight = self._step(self._host_toks())
                ticks += 1
                continue
            if self._can_speculate():
                # the undo record makes the speculative step revocable
                snap = (self._gen.get_state(), _undo_record(self.caches), self.positions.copy())
                occupied = to_device([r is not None for r in self.lanes], torch.bool, self.device)
                spec = self._step(torch.where(occupied, inflight, torch.zeros_like(inflight)))
                new_np = inflight.cpu().numpy()  # waits for step t only
                if self._commit(new_np):
                    # surprise EOS: undo the in-flight step and re-enter with
                    # the recycled composition
                    gen_state, rec, self.positions = snap
                    _undo(self.caches, rec)
                    self._gen.set_state(gen_state)
                    self.stats["rollbacks"] += 1
                    self.stats["steps"] -= 1
                    inflight = None
                else:
                    self.stats["overlapped"] += 1
                    inflight = spec
                    ticks += 1
            else:
                self._commit(inflight.cpu().numpy())
                inflight = None
        if inflight is not None:
            self._commit(inflight.cpu().numpy())
        return self.finished

