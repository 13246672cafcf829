"""Deterministic fault injection for the tiered synapse memory (a copy of
the JAX package's ``repro.memory.faults``, which holds no framework code).

The `SynapseStore` exposes three I/O boundaries where real systems break:
the cold **write** (torn by a crash mid-`write()`), the cold **read**
(flipped bits from bad media, transient ``OSError`` from a flaky mount),
and the worker-thread **promotion** (a slow or blocked host-to-device copy,
or the thread dying outright). A :class:`FaultInjector` attached via
``SynapseStore(faults=...)`` (or ``store.faults = ...``) fires scripted
faults at exactly those boundaries — and nowhere else, so the injected
failure modes are the ones production code actually has to survive.

Everything is deterministic: rules fire on the Nth *matching* call (per
rule counter), never on wall-clock or RNG state, so a failing resilience
test replays exactly. Every fired fault is recorded in ``events`` and
summarized by :meth:`report`.

Rule matching: ``key`` is an exact agent key or ``"*"``; ``nth`` is
1-based over matching calls; ``times`` repeats the fault for that many
consecutive matching calls (so ``nth=1, times=2`` = "fail the first two
reads" — exercising retry-until-success).
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional


class WorkerKill(BaseException):
    """Raised inside the prefetch worker to simulate the thread dying.

    Deliberately a ``BaseException``: the store's worker loop (correctly)
    catches only ``Exception``, so this escapes, kills the thread, and
    exercises the `heal_worker` supervision path end to end."""


@dataclass
class FaultEvent:
    op: str      # "cold_write" | "cold_read" | "put_fn"
    key: str
    fault: str   # "torn_write" | "flip" | "fail_read" | "slow_put" | "kill_worker"
    call: int    # which matching call fired (1-based)
    detail: str = ""


@dataclass
class _Rule:
    op: str
    key: str          # exact key or "*"
    fault: str
    nth: int          # fire on the nth matching call...
    times: int        # ...and for this many consecutive matches
    params: Dict[str, Any] = field(default_factory=dict)
    seen: int = 0     # matching calls observed so far

    def matches(self, key: str) -> bool:
        return self.key == "*" or self.key == key

    def should_fire(self) -> bool:
        # called with seen already incremented for this call
        return self.nth <= self.seen < self.nth + self.times


class FaultInjector:
    """Scripted, deterministic faults at the store's I/O boundaries."""

    def __init__(self) -> None:
        self._rules: List[_Rule] = []
        self._lock = threading.Lock()
        self.events: List[FaultEvent] = []

    # -- rule registration (chainable) ------------------------------------
    def _add(self, op: str, key: str, fault: str, nth: int, times: int,
             **params) -> "FaultInjector":
        if nth < 1 or times < 1:
            raise ValueError("nth and times are 1-based counts")
        self._rules.append(_Rule(op, key, fault, nth, times, params))
        return self

    def torn_write(self, key: str = "*", *, frac: float = 0.5,
                   nth: int = 1, times: int = 1) -> "FaultInjector":
        """Truncate the blob to ``frac`` of its bytes before it hits disk —
        what a crash mid-write leaves behind (the atomic rename still
        happens, as it would if power died just after)."""
        return self._add("cold_write", key, "torn_write", nth, times, frac=frac)

    def flip_write(self, key: str = "*", *, offset: Optional[int] = None,
                   nth: int = 1, times: int = 1) -> "FaultInjector":
        """XOR one byte of the blob on its way to disk (silent media
        corruption). ``offset`` indexes into the payload region by default
        (past the header+meta, so the digest — not the header parse —
        catches it); negative offsets index from the end."""
        return self._add("cold_write", key, "flip", nth, times, offset=offset)

    def fail_read(self, key: str = "*", *, nth: int = 1, times: int = 1,
                  error: type = OSError) -> "FaultInjector":
        """Raise ``error`` on the nth..nth+times-1 matching cold reads —
        ``OSError`` (default) is what the store treats as transient and
        retries; pass a different type to test permanent-failure paths."""
        return self._add("cold_read", key, "fail_read", nth, times, error=error)

    def flip_read(self, key: str = "*", *, offset: Optional[int] = None,
                  nth: int = 1, times: int = 1) -> "FaultInjector":
        """XOR one byte of the blob as it is read back (bad sector)."""
        return self._add("cold_read", key, "flip", nth, times, offset=offset)

    def truncate_read(self, key: str = "*", *, frac: float = 0.5,
                      nth: int = 1, times: int = 1) -> "FaultInjector":
        """Return only the first ``frac`` of the blob's bytes (short read)."""
        return self._add("cold_read", key, "torn_write", nth, times, frac=frac)

    def kill_worker_on_read(self, key: str = "*", *, nth: int = 1,
                            times: int = 1) -> "FaultInjector":
        """Raise :class:`WorkerKill` (a BaseException) from the read hook:
        kills the prefetch thread dead, in-flight ticket and all."""
        return self._add("cold_read", key, "kill_worker", nth, times)

    def slow_put(self, key: str = "*", *, seconds: float,
                 nth: int = 1, times: int = 1) -> "FaultInjector":
        """Sleep inside the worker just before ``put_fn`` — a stalled
        host->device copy. Pair with a wake deadline to test host-side
        expiry of a blocked promotion."""
        return self._add("put_fn", key, "slow_put", nth, times, seconds=seconds)

    def block_put(self, key: str = "*", *, release: threading.Event,
                  timeout: float = 30.0, nth: int = 1,
                  times: int = 1) -> "FaultInjector":
        """Block ``put_fn`` until the test sets ``release`` (bounded by
        ``timeout`` so a buggy test can't hang the suite)."""
        return self._add("put_fn", key, "block_put", nth, times,
                         release=release, timeout=timeout)

    # -- hooks called by SynapseStore -------------------------------------
    def _fire(self, op: str, key: str) -> List[_Rule]:
        with self._lock:
            fired = []
            for rule in self._rules:
                if rule.op != op or not rule.matches(key):
                    continue
                rule.seen += 1
                if rule.should_fire():
                    fired.append(rule)
                    self.events.append(FaultEvent(
                        op, key, rule.fault, rule.seen,
                        detail=str({k: v for k, v in rule.params.items()
                                    if not isinstance(v, threading.Event)}),
                    ))
            return fired

    @staticmethod
    def _mangle(data: bytes, rule: _Rule) -> bytes:
        if rule.fault == "torn_write":
            return data[: max(1, int(len(data) * rule.params["frac"]))]
        if rule.fault == "flip":
            offset = rule.params.get("offset")
            # default: flip a byte well into the blob — inside the payload
            # region for any realistic frame, so the digest check (not the
            # header parse) is what must catch it
            i = (len(data) - 8) if offset is None else offset
            i = i % len(data)
            return data[:i] + bytes([data[i] ^ 0x80]) + data[i + 1:]
        return data

    def on_cold_write(self, key: str, blob: bytes) -> bytes:
        for rule in self._fire("cold_write", key):
            blob = self._mangle(blob, rule)
        return blob

    def on_cold_read(self, key: str, data: bytes) -> bytes:
        for rule in self._fire("cold_read", key):
            if rule.fault == "fail_read":
                raise rule.params["error"](f"injected read failure for {key!r}")
            if rule.fault == "kill_worker":
                raise WorkerKill(f"injected worker death reading {key!r}")
            data = self._mangle(data, rule)
        return data

    def on_put_fn(self, key: str) -> None:
        for rule in self._fire("put_fn", key):
            if rule.fault == "slow_put":
                time.sleep(rule.params["seconds"])
            elif rule.fault == "block_put":
                rule.params["release"].wait(rule.params["timeout"])

    # -- reporting --------------------------------------------------------
    def report(self) -> dict:
        """Summary for test assertions."""
        with self._lock:
            by_fault: Dict[str, int] = {}
            for ev in self.events:
                by_fault[ev.fault] = by_fault.get(ev.fault, 0) + 1
            return {
                "events": [
                    {"op": e.op, "key": e.key, "fault": e.fault,
                     "call": e.call, "detail": e.detail}
                    for e in self.events
                ],
                "fired_total": len(self.events),
                "fired_by_fault": by_fault,
                "rules": len(self._rules),
            }
