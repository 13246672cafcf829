"""Serving front end: admission control, token streaming, weighted
fairness and SLO accounting over both serving backends.

Port of the JAX package's ``repro.serving.frontend`` (framework-free: the
code is the reference's, over the port's ``BatchServer`` and
``CortexEngine``). Three pieces:

* :class:`FairQueue` — per-tenant weighted-fair admission. Each admission
  charges the tenant's virtual time by the request's token budget over its
  weight, and the next admission goes to the backlogged tenant with the
  smallest virtual time, so over a busy period token shares converge to the
  weight ratio (start-time fair queuing). A higher priority class preempts
  that order, and a **starvation bound** caps the damage: a request that
  has waited ``starvation_rounds`` admission decisions is admitted next.
* :class:`TokenStream` — the per-request stream handle. The backends feed
  it at commit granularity (every step on the BatchServer path, every drain
  window on the engine path) with incremental-decoder output, so its text
  is bitwise the end-of-run ``decode(tokens)``. Handles are thread-safe.
* :class:`ServingFrontend` — ties them to a backend. Admissions happen ONLY
  through the backend's boundary hooks (``BatchServer._admit`` /
  ``CortexEngine._boundary_ops``), which the pipelined loops invoke with
  nothing in flight, so an admission never flushes a window. Per-request
  SLO metrics (TTFT, time per output token, queue wait), per-tenant
  aggregates and p50/p99 tick latency come out of
  :meth:`ServingFrontend.metrics`.

The wire protocol lives in :mod:`repro_torch.serving.transport`.
"""
from __future__ import annotations

import math
import threading
import time
from dataclasses import dataclass, field

from repro_torch.core.engine import CortexEngine
from repro_torch.serving.sampler import SamplingParams
from repro_torch.serving.server import BatchServer


class AdmissionError(RuntimeError):
    """The admission queue is full — the request was rejected, not queued.
    Back-pressure is explicit: callers retry or shed load themselves."""


class BackendFailed(RuntimeError):
    """The backend raised out of a step. It may be half changed, so it is
    never stepped again: every request the front end held ended with status
    "error", and later submits and steps raise this."""


class ServeStalled(RuntimeError):
    """`serve()` exhausted its tick budget (or could make no progress at
    all) with requests still pending. ``stuck`` lists their rids — e.g. a
    lane whose retirement keeps being refused because side streams still
    target it."""

    def __init__(self, message: str, stuck: list[int]):
        super().__init__(message)
        self.stuck = stuck


def percentile(samples, q: float) -> float:
    """Deterministic nearest-rank percentile (rank ``ceil(q/100 · n)``,
    1-based); 0.0 on an empty sample set. ``int(round(...))`` is NOT used:
    banker's rounding picks inconsistent ranks on even-length samples."""
    if not samples:
        return 0.0
    s = sorted(samples)
    rank = min(len(s), max(1, math.ceil(q / 100.0 * len(s))))
    return float(s[rank - 1])


class TokenStream:
    """Thread-safe per-request stream handle.

    Iterating yields decoded text chunks as the backend commits them and
    stops when the request finishes (any status). ``text`` is the
    accumulated stream so far; after completion it is bitwise equal to the
    backend's final request text, which the incremental decoder makes
    bitwise equal to ``tokenizer.decode(generated_tokens)``.

    **Consumer back-pressure**: the handle tracks how far its
    consumer has read (``__iter__`` / :meth:`next_chunk` advance a shared
    cursor). When ``max_buffered_chars`` is set and the unread backlog
    exceeds it — a stalled socket writer, a consumer thread that died —
    ``on_overflow(rid)`` fires ONCE, outside the lock, from the producer
    (pump) thread. The front-end maps it to a request cancel, so a stalled
    consumer sheds exactly its own request instead of growing the backlog
    without bound or ever blocking the pump.
    """

    def __init__(self, rid: int, *, max_buffered_chars: int | None = None,
                 on_overflow=None):
        self.rid = rid
        self.max_buffered_chars = max_buffered_chars
        self.on_overflow = on_overflow
        self._chunks: list[str] = []
        self._nread = 0              # chunks consumed via iter/next_chunk
        self._unread_chars = 0       # pushed minus consumed (backlog)
        self._overflowed = False
        self._cond = threading.Condition()
        self._closed = False
        self.status: str = ""        # "", then "ok" | "cancelled" | "error"
        self.error: str | None = None

    # -- producer side (frontend taps) ---------------------------------
    def _push(self, chunk: str) -> None:
        cb = None
        with self._cond:
            self._chunks.append(chunk)
            self._unread_chars += len(chunk)
            if (self.max_buffered_chars is not None and not self._overflowed
                    and self._unread_chars > self.max_buffered_chars):
                self._overflowed = True
                cb = self.on_overflow
            self._cond.notify_all()
        if cb is not None:
            cb(self.rid)

    def _close(self, status: str, error: str | None = None) -> None:
        with self._cond:
            self.status = status or "ok"
            self.error = error
            self._closed = True
            self._cond.notify_all()

    # -- consumer side ---------------------------------------------------
    @property
    def text(self) -> str:
        with self._cond:
            return "".join(self._chunks)

    @property
    def done(self) -> bool:
        with self._cond:
            return self._closed

    @property
    def overflowed(self) -> bool:
        with self._cond:
            return self._overflowed

    def next_chunk(self, timeout: float | None = None) -> str | None:
        """Next unread chunk; ``""`` on timeout with the stream still open,
        ``None`` once it is closed and fully drained. The polling primitive
        a socket writer needs: it can interleave disconnect checks between
        bounded waits instead of blocking forever in ``__iter__``."""
        with self._cond:
            self._cond.wait_for(
                lambda: self._nread < len(self._chunks) or self._closed, timeout
            )
            if self._nread >= len(self._chunks):
                return None if self._closed else ""
            chunk = self._chunks[self._nread]
            self._nread += 1
            self._unread_chars -= len(chunk)
            return chunk

    def __iter__(self):
        """Yield chunks until the stream closes (blocking mid-stream)."""
        while True:
            chunk = self.next_chunk()
            if chunk is None:
                return
            if chunk:
                yield chunk

    def result(self, timeout: float | None = None) -> str:
        """Block until the stream closes; returns the full text."""
        with self._cond:
            if not self._cond.wait_for(lambda: self._closed, timeout):
                raise TimeoutError(f"stream {self.rid} still open")
            return "".join(self._chunks)


@dataclass
class FrontRequest:
    """Front-end view of one request: identity, stream handle, SLO clocks."""

    rid: int
    prompt: str
    tenant: str
    priority: int = 0
    max_new_tokens: int = 64
    sampling: SamplingParams | None = None
    stream: TokenStream = None
    # SLO timestamps (frontend clock; None until the event happens)
    t_submit: float = 0.0
    t_admit: float | None = None
    t_first: float | None = None
    t_done: float | None = None
    tokens_out: int = 0
    status: str = ""             # "", "queued", "running", then terminal
    submit_round: int = 0        # FairQueue round at enqueue (starvation age)
    seq: int = 0                 # global arrival order (starvation FIFO key)
    backend_id: object = None    # BatchServer rid | engine agent_id
    streamed_chars: int = 0      # engine mode: chars already pushed
    cancel_requested: bool = False

    def slo_row(self) -> dict:
        ttft = (self.t_first - self.t_submit) if self.t_first is not None else None
        tpot = None
        if self.t_done is not None and self.t_first is not None and self.tokens_out > 1:
            tpot = (self.t_done - self.t_first) / (self.tokens_out - 1)
        return {
            "rid": self.rid,
            "tenant": self.tenant,
            "priority": self.priority,
            "status": self.status,
            "tokens_out": self.tokens_out,
            "queue_wait_s": (self.t_admit - self.t_submit)
            if self.t_admit is not None else None,
            "ttft_s": ttft,
            "tpot_s": tpot,
            "e2e_s": (self.t_done - self.t_submit)
            if self.t_done is not None else None,
        }


@dataclass
class TenantState:
    name: str
    weight: float = 1.0
    vtime: float = 0.0       # served budget / weight — WFQ virtual time
    tokens_out: int = 0
    admitted: int = 0
    rejected: int = 0
    queue: list = field(default_factory=list)  # FIFO of FrontRequest


class FairQueue:
    """Weighted-fair admission with priorities and a starvation bound.

    Scheduling order at each :meth:`pop` (one admission decision):

    1. **Starvation bound** — if any queued request is aged
       ``starvation_rounds`` or more (its age at a decision counts that
       decision: a request enqueued at round R has age ``k`` at the k-th
       decision after enqueue), the longest-waiting such request is
       admitted now. This bounds worst-case queue delay for ANY request at
       ``starvation_rounds`` admission decisions, whatever its weight or
       priority: a request aged exactly ``starvation_rounds`` is promoted.
    2. **Priority** — among queue heads, only the highest priority class
       present competes (higher = sooner).
    3. **WFQ** — within that class, the tenant with the smallest virtual
       time wins; ties break by name for determinism. The winner's vtime
       advances by ``max_new_tokens / weight`` (start-time fair queuing
       with the token budget as the quantum), so over a saturated period
       admitted token budgets — and hence served tokens — converge to the
       weight ratio.

    A tenant going idle does not bank credit: on enqueue its vtime is
    floored to the current virtual floor, the standard WFQ guard against a
    returning tenant monopolizing the lanes.
    """

    def __init__(self, weights: dict[str, float] | None = None, *,
                 default_weight: float = 1.0, starvation_rounds: int = 32):
        self.tenants: dict[str, TenantState] = {}
        self.default_weight = default_weight
        self.starvation_rounds = max(1, starvation_rounds)
        self.rounds = 0              # admission decisions taken
        self.starvation_promotions = 0
        self._vfloor = 0.0
        self._seq = 0                # global arrival counter
        self._lock = threading.RLock()
        for name, w in (weights or {}).items():
            self.tenant(name, weight=w)

    def tenant(self, name: str, weight: float | None = None) -> TenantState:
        with self._lock:
            t = self.tenants.get(name)
            if t is None:
                t = self.tenants[name] = TenantState(
                    name, weight if weight is not None else self.default_weight
                )
            elif weight is not None:
                t.weight = weight
            return t

    def __len__(self) -> int:
        with self._lock:
            return sum(len(t.queue) for t in self.tenants.values())

    def push(self, req: FrontRequest) -> None:
        with self._lock:
            t = self.tenant(req.tenant)
            if not t.queue:
                t.vtime = max(t.vtime, self._vfloor)
            req.submit_round = self.rounds
            req.seq = self._seq
            self._seq += 1
            t.queue.append(req)

    def remove(self, rid: int) -> FrontRequest | None:
        with self._lock:
            for t in self.tenants.values():
                for i, r in enumerate(t.queue):
                    if r.rid == rid:
                        return t.queue.pop(i)
        return None

    def pop(self) -> FrontRequest | None:
        """One admission decision (None when nothing is queued)."""
        with self._lock:
            backlogged = [t for t in self.tenants.values() if t.queue]
            if not backlogged:
                return None
            self.rounds += 1
            # the normal order: highest priority class present wins outright,
            # then weighted-fair within it — smallest virtual time, ties by
            # name for determinism
            top = max(t.queue[0].priority for t in backlogged)
            cands = [t for t in backlogged if t.queue[0].priority == top]
            normal = min(cands, key=lambda t: (t.vtime, t.name))
            # starvation bound: if any head has reached the bound, the
            # oldest such request (global arrival order) is admitted instead —
            # a promotion only counts when it actually overrides normal order.
            # `rounds` was just incremented, so `rounds - submit_round` is the
            # head's age AT this decision; `>=` admits a request aged exactly
            # `starvation_rounds` (a `>` would promote one decision late,
            # past the documented bound)
            aged = [
                t for t in backlogged
                if self.rounds - t.queue[0].submit_round >= self.starvation_rounds
            ]
            if aged:
                t = min(aged, key=lambda t: t.queue[0].seq)
                if t is not normal:
                    self.starvation_promotions += 1
                return self._take(t)
            return self._take(normal)

    def _take(self, t: TenantState) -> FrontRequest:
        req = t.queue.pop(0)
        t.vtime += req.max_new_tokens / max(t.weight, 1e-9)
        self._vfloor = max(
            self._vfloor,
            min((x.vtime for x in self.tenants.values() if x.queue), default=t.vtime),
        )
        t.admitted += 1
        return req

    def charge(self, tenant: str, tokens: int) -> None:
        with self._lock:
            self.tenant(tenant).tokens_out += tokens


class ServingFrontend:
    """Admission + streaming + fairness + SLOs over a serving backend.

    ``backend`` is a :class:`~repro_torch.serving.server.BatchServer` or a
    :class:`~repro_torch.core.engine.CortexEngine`; the front-end installs its
    admission hook and stream taps and never touches device state itself.

    BatchServer mode: a request is one server request (EOS or
    ``max_new_tokens`` completes it); streams advance every commit.
    Engine mode: a request is a main agent (``submit``-ed into a free
    river lane at a window boundary, ``retire_main``-ed when its budget is
    met); streams advance every drain, so token counts are window-granular
    — a request completes at the first boundary where its budget is met,
    overshooting it by at most the pipelined windows in flight (the engine
    is never flushed mid-window to enforce an exact count).

    ``max_queue`` bounds the admission backlog; a submit past it raises
    :class:`AdmissionError` (explicit back-pressure, counted per tenant).
    """

    def __init__(self, backend, *, tenants: dict[str, float] | None = None,
                 default_weight: float = 1.0, max_queue: int = 256,
                 starvation_rounds: int = 32, default_max_new_tokens: int = 64,
                 clock=time.monotonic):
        self.backend = backend
        self.clock = clock
        self.max_queue = max_queue
        self.default_max_new_tokens = default_max_new_tokens
        self.fq = FairQueue(tenants, default_weight=default_weight,
                            starvation_rounds=starvation_rounds)
        self.requests: dict[int, FrontRequest] = {}
        self.live: dict[object, FrontRequest] = {}  # backend_id -> request
        self._rid = 0
        self._lock = threading.RLock()
        # the thread that owns the backend (set by serve()/step() and the
        # transport pump). Backend state is NOT thread-safe: a cancel from
        # any other thread is deferred — flagged on the request and applied
        # at the next admission boundary inside the pump's own loop.
        self._pump_thread: threading.Thread | None = None
        # tick-latency sampling: (clock, backend step counter) at the last
        # commit observation; each later commit contributes
        # (dt / dsteps) samples — amortized per-tick latency as a caller
        # actually experiences it, pipelining and drain batching included
        self._tick_samples: list[float] = []
        self._last_mark: tuple[float, int] | None = None
        # why the backend failed (see :meth:`fail`); None while it is sound
        self.failed: str | None = None

        if isinstance(backend, BatchServer):
            self._mode = "batch"
            backend.admission_hook = self._admit_batch
        elif isinstance(backend, CortexEngine):
            self._mode = "engine"
            backend.admission_hook = self._admit_engine
            backend.stream_tap = self._engine_tap
        else:
            raise TypeError(f"unsupported backend: {type(backend).__name__}")

    # ------------------------------------------------------------------
    def submit(self, prompt: str, *, tenant: str = "default", priority: int = 0,
               max_new_tokens: int | None = None,
               sampling: SamplingParams | None = None,
               max_buffered_chars: int | None = None) -> TokenStream:
        """Queue a request; returns its stream handle immediately. Raises
        :class:`AdmissionError` when the backlog is at ``max_queue``.

        ``max_buffered_chars`` bounds the stream's unread backlog: a consumer that stalls past it — a socket writer stuck on a
        dead client — gets its request cancelled at the next boundary
        instead of buffering without bound. ``None`` (default) keeps the
        in-process unbounded behavior."""
        with self._lock:
            if self.failed is not None:
                raise BackendFailed(f"the backend failed: {self.failed}")
            if len(self.fq) >= self.max_queue:
                self.fq.tenant(tenant).rejected += 1
                raise AdmissionError(
                    f"admission queue full ({self.max_queue}); tenant {tenant!r}"
                )
            self._rid += 1
            req = FrontRequest(
                self._rid, prompt, tenant, priority,
                max_new_tokens or self.default_max_new_tokens, sampling,
                TokenStream(self._rid, max_buffered_chars=max_buffered_chars,
                            on_overflow=self._overflow),
                t_submit=self.clock(), status="queued",
            )
            self.requests[req.rid] = req
            self.fq.push(req)
            return req.stream

    def _overflow(self, rid: int) -> None:
        """A stream's unread backlog crossed its bound (fired from the pump
        thread mid-commit): flag the request for a boundary cancel — never
        re-enter the backend from inside its own tap."""
        with self._lock:
            req = self.requests.get(rid)
            if req is not None and req.status not in ("ok", "cancelled", "error"):
                req.cancel_requested = True

    def _foreign_pump(self) -> bool:
        t = self._pump_thread
        return (t is not None and t.is_alive()
                and t is not threading.current_thread())

    def cancel(self, rid: int) -> bool:
        """Cancel a queued or running request; its stream closes with
        status "cancelled" (queued immediately, running at the next
        boundary in engine mode / via BatchServer.cancel in batch mode).
        Called from a thread that does not own the backend — a transport
        handler racing the pump — the running-request cancel is deferred to
        the next admission boundary in BOTH modes."""
        with self._lock:
            req = self.requests.get(rid)
            if req is None or req.status in ("ok", "cancelled", "error"):
                return False
            if self.fq.remove(rid) is not None:
                self._finish(req, "cancelled")
                return True
            if self._mode == "batch" and not self._foreign_pump():
                return self.backend.cancel(req.backend_id)  # tap closes stream
            req.cancel_requested = True  # honored at the next boundary
            return True

    def pending(self) -> int:
        with self._lock:
            return len(self.fq) + len(self.live)

    # ------------------------------------------------------------------
    def step(self, ticks: int | None = None, *, pipeline: bool = True) -> int:
        """Drive the backend for ONE bounded chunk; returns the backend
        ticks it actually advanced. The transport pump loops this forever
        (deferred cancels land at each chunk's admission boundary);
        :meth:`serve` loops it until idle under a total budget."""
        if self.failed is not None:
            raise BackendFailed(f"the backend failed: {self.failed}")
        self._pump_thread = threading.current_thread()
        try:
            if self._mode == "batch":
                before = self.backend.stats["steps"]
                self.backend.run_until_done(
                    max_ticks=ticks if ticks is not None else 256, pipeline=pipeline
                )
                return max(0, self.backend.stats["steps"] - before)
            eng = self.backend
            before = eng.stats["ticks"]
            eng.run(ticks if ticks is not None else 8 * eng.sync_every)
            return max(0, eng.stats["ticks"] - before)
        except BaseException as e:
            self.fail(f"{type(e).__name__}: {e}")
            raise

    def fail(self, error: str) -> list[int]:
        """The backend raised out of a step (a kernel refused its input, a
        launch failed): end every queued and live request with status
        "error", its stream closing with ``error``, and refuse all later
        submits and steps with :class:`BackendFailed`. Nothing retries a
        step on a backend that a failed step may have left half changed.
        Returns the rids ended."""
        with self._lock:
            self.failed = error
            queued = [r for t in self.fq.tenants.values() for r in t.queue]
            for req in queued:
                self.fq.remove(req.rid)
            ended = queued + list(self.live.values())
            for req in ended:
                self._finish(req, "error", error)
            return sorted(r.rid for r in ended)

    def serve(self, *, max_ticks: int = 100_000, pipeline: bool = True) -> None:
        """Pump the backend until every queued/live request completes.
        Admissions, retirements, and stream delivery all happen inside the
        backend's own loop via the installed hooks — this method just
        drives it and returns when the front-end is idle.

        ``max_ticks`` is a TOTAL tick budget across the whole call (a
        request may never retire, e.g. a lane whose ``retire_main`` keeps
        refusing while side streams target it). Exhausting it — or a chunk that provably cannot advance — raises
        :class:`ServeStalled` with the stuck rids."""
        spent = 0
        while self.pending():
            chunk = max_ticks - spent
            if chunk <= 0:
                self._raise_stalled(f"serve() exhausted max_ticks={max_ticks}")
            if self._mode == "engine":
                chunk = min(chunk, 8 * self.backend.sync_every)
            advanced = self.step(chunk, pipeline=pipeline)
            spent += advanced
            if advanced == 0 and self.pending():
                self._raise_stalled(
                    "serve() made no progress (backend refuses to run)"
                )

    def _raise_stalled(self, why: str):
        with self._lock:
            stuck = sorted(
                {r.rid for r in self.live.values()}
                | {r.rid for t in self.fq.tenants.values() for r in t.queue}
            )
        raise ServeStalled(f"{why}; stuck rids: {stuck}", stuck)

    # ------------------------------------------------------------------
    def _finish(self, req: FrontRequest, status: str, error: str | None = None):
        req.status = status
        req.t_done = self.clock()
        req.stream._close(status, error)
        self.live.pop(req.backend_id, None)

    def _note_progress(self, now: float, steps: int) -> None:
        if self._last_mark is not None:
            t0, s0 = self._last_mark
            if steps > s0 and now > t0:
                self._tick_samples.append((now - t0) / (steps - s0))
        self._last_mark = (now, steps)

    # -- BatchServer backend -------------------------------------------
    def _admit_batch(self) -> int:
        """Admission-boundary hook: fill free lanes from the fair queue.
        Runs inside ``BatchServer._admit`` — always at a step boundary with
        nothing in flight, so admission never costs a flush. Deferred
        cancels (transport disconnects, stream-backlog overflow — flagged
        from threads that do not own the backend) are applied here first,
        so the lanes they free are refilled in the same boundary."""
        srv = self.backend
        admitted = 0
        for req in list(self.live.values()):
            if req.cancel_requested:
                srv.cancel(req.backend_id)  # tap -> _finish: observable
        while True:
            free = sum(r is None for r in srv.lanes) - len(srv.queue)
            if free <= 0:
                break
            with self._lock:
                req = self.fq.pop()
                if req is None:
                    break
                rid = srv.submit(req.prompt, req.max_new_tokens, req.sampling)
                req.backend_id = rid
                req.t_admit = self.clock()
                req.status = "running"
                self.live[rid] = req
                srv.taps[rid] = self._batch_tap(req)
            admitted += 1
        return admitted

    def _batch_tap(self, req: FrontRequest):
        def tap(sreq, chunk: str, toks, done: bool):
            now = self.clock()
            self._note_progress(now, self.backend.stats["steps"])
            if toks:
                if req.t_first is None:
                    req.t_first = now
                req.tokens_out += len(toks)
                self.fq.charge(req.tenant, len(toks))
            if chunk:
                req.stream._push(chunk)
            if done:
                self._finish(req, sreq.status or "ok", sreq.error)
        return tap

    # -- CortexEngine backend ------------------------------------------
    def _admit_engine(self) -> int:
        """Window-boundary hook (runs in ``CortexEngine._boundary_ops``):
        retire request lanes whose budget is met (or cancelled), then admit
        queued requests into the freed river lanes. Both are boundary ops —
        the pipelined window is never flushed by an admission."""
        eng = self.backend
        did = 0
        for req in list(self.live.values()):
            if req.cancel_requested or req.tokens_out >= req.max_new_tokens:
                try:
                    self._retire_engine_req(req)
                except ValueError:
                    continue  # side streams still target the lane; next boundary
                did += 1
        while True:
            lane = eng._free_main_lane()
            if lane < 0:
                break
            with self._lock:
                req = self.fq.pop()
                if req is None:
                    break
                aid = f"fe{req.rid}"
                req.backend_id = aid
                req.t_admit = self.clock()
                req.status = "running"
                self.live[aid] = req
                eng.submit(req.prompt, lane=lane, sampling=req.sampling,
                           agent_id=aid)
            did += 1
        return did

    def _retire_engine_req(self, req: FrontRequest) -> None:
        eng = self.backend
        rec = eng.registry.get(req.backend_id)
        view = eng.mains[rec.lane]
        eng.retire_main(rec.lane)  # flushes the decoder into view.text
        # deliver the flush tail (text beyond what the taps streamed):
        # stream text ends bitwise equal to the final decode
        prompt_chars = len(req.prompt)
        tail = view.text[prompt_chars + req.streamed_chars:]
        if tail:
            req.stream._push(tail)
        self._finish(req, "cancelled" if req.cancel_requested else "ok")

    def _engine_tap(self, view, chunk: str, toks) -> None:
        req = self.live.get(view.agent_id)
        if req is None or view.kind != "main":
            return  # side streams and non-frontend agents pass through
        now = self.clock()
        self._note_progress(now, self.backend.stats["ticks"])
        if toks:
            # guard like _batch_tap: a drain callback with
            # no tokens for this lane must not stamp TTFT — t_first means "a
            # generated token exists", not "a drain happened"
            if req.t_first is None:
                req.t_first = now
            req.tokens_out += len(toks)
            self.fq.charge(req.tenant, len(toks))
        if chunk:
            req.stream._push(chunk)
            req.streamed_chars += len(chunk)

    # ------------------------------------------------------------------
    def metrics(self) -> dict:
        """Per-request SLO rows, per-tenant aggregates (token shares,
        TTFT percentiles, fairness counters), and tick-latency percentiles
        — what a serving benchmark records."""
        with self._lock:
            rows = [r.slo_row() for r in self.requests.values()]
            total_tokens = sum(t.tokens_out for t in self.fq.tenants.values())
            tenants = {}
            for name, t in self.fq.tenants.items():
                ttfts = [r["ttft_s"] for r in rows
                         if r["tenant"] == name and r["ttft_s"] is not None]
                tenants[name] = {
                    "weight": t.weight,
                    "tokens_out": t.tokens_out,
                    "token_share": t.tokens_out / total_tokens if total_tokens else 0.0,
                    "admitted": t.admitted,
                    "rejected": t.rejected,
                    "queued": len(t.queue),
                    "ttft_p50_s": percentile(ttfts, 50),
                    "ttft_p99_s": percentile(ttfts, 99),
                }
            ttfts = [r["ttft_s"] for r in rows if r["ttft_s"] is not None]
            done = [r for r in rows if r["status"] in ("ok", "cancelled", "error")]
            return {
                "requests": rows,
                "tenants": tenants,
                "fairness": {
                    "admission_rounds": self.fq.rounds,
                    "starvation_promotions": self.fq.starvation_promotions,
                    "starvation_rounds": self.fq.starvation_rounds,
                },
                "ttft_s": {"p50": percentile(ttfts, 50),
                           "p99": percentile(ttfts, 99)},
                "tick_latency_s": {
                    "p50": percentile(self._tick_samples, 50),
                    "p99": percentile(self._tick_samples, 99),
                    "n": len(self._tick_samples),
                },
                "completed": len(done),
                "backend": self._mode,
            }
