"""Cortex Router (paper §3.4): regex intent extraction on the decoded stream.

Host-side by design (it inspects sampled text, not device tensors). Triggers:
  [TASK: <description>]   -> spawn a side agent with <description> as prompt
  [DONE]                  -> side agent self-terminates
  [ANSWER: <text>]        -> side agent reports its thought
"""
from __future__ import annotations

import re
from dataclasses import dataclass

TASK_RE = re.compile(r"\[TASK:\s*([^\]]+)\]")
DONE_RE = re.compile(r"\[DONE\]")
ANSWER_RE = re.compile(r"\[ANSWER:\s*([^\]]+)\]")


@dataclass(frozen=True)
class Trigger:
    kind: str          # "task" | "done" | "answer"
    payload: str
    span: tuple[int, int]


class CortexRouter:
    """Incremental scanner: feed decoded text, get new triggers exactly once.

    Two APIs: :meth:`scan` takes the agent's FULL text each call (legacy);
    :meth:`feed` takes only the newly drained chunk and keeps a bounded
    overlap tail internally, so the per-drain cost is O(len(chunk))
    regardless of stream length — the fused engine's control-plane path.

    ``tail`` is the overlap kept between feeds so tags split across drain
    boundaries still match. The engine scales it with its macro-tick window
    (one drain per window feeds the whole window's decoded text in a single
    chunk). **Tail-size contract**: a tag longer than ``tail`` characters can
    straddle a drain boundary with its opening ``[`` already evicted from the
    retained overlap, and is then silently missed — so the engine must size
    ``tail`` at least as large as the longest tag it can round-trip
    (``[TASK: <side_prompt_cap bytes>]`` plus framing) and at least one full
    drain window of text (``8 * max_window`` bytes covers the worst-case
    UTF-8 expansion). The JAX package's router tests pin both sides of this contract.

    :meth:`plausible` is the pipelined engine's trigger-plausibility hint: an
    unclosed ``[`` in the retained tail means the next drained chunk could
    complete a tag, so the adaptive-window policy must keep the window short
    and the pipelined drain must process that lane serially.
    """

    def __init__(self, tail: int = 256):
        self._tail = tail
        self._scanned = {}
        self._tails = {}  # agent_id -> (tail_text, absolute_offset_of_tail)

    def feed(self, agent_id: str, chunk: str) -> list[Trigger]:
        """Scan a newly drained chunk against the retained tail. Trigger
        spans are absolute offsets into the agent's full stream."""
        tail, base = self._tails.get(agent_id, ("", 0))
        text = tail + chunk
        scanned = self._scanned.get(agent_id, 0)
        triggers: list[Trigger] = []
        for regex, kind, payload in (
            (TASK_RE, "task", True), (DONE_RE, "done", False), (ANSWER_RE, "answer", True),
        ):
            for m in regex.finditer(text):
                if base + m.end() > scanned:
                    triggers.append(
                        Trigger(kind, m.group(1).strip() if payload else "",
                                (base + m.start(), base + m.end()))
                    )
        end = base + len(text)
        self._scanned[agent_id] = end
        keep = min(len(text), self._tail)
        self._tails[agent_id] = (text[len(text) - keep:], end - keep)
        triggers.sort(key=lambda t: t.span)
        return triggers

    def scan(self, agent_id: str, text: str) -> list[Trigger]:
        """Full-text convenience wrapper: feeds only the unseen suffix."""
        seen = self._scanned.get(agent_id, 0)
        return self.feed(agent_id, text[min(seen, len(text)):])

    def plausible(self, agent_id: str) -> bool:
        """True when the retained tail ends with an unclosed ``[`` — i.e. a
        trigger tag may be in flight across the drain boundary. Conservative
        by construction: every tag this router matches needs a ``[`` before
        its closing ``]``, so ``plausible() == False`` plus a bracket-free
        next chunk guarantees :meth:`feed` on that chunk returns nothing."""
        tail, _ = self._tails.get(agent_id, ("", 0))
        return "[" in tail[tail.rfind("]") + 1:]

    def reset(self, agent_id: str):
        self._scanned.pop(agent_id, None)
        self._tails.pop(agent_id, None)

    def export_state(self, agent_id: str) -> dict | None:
        """Plain-data snapshot of one agent's scan state (tail + offsets) —
        persisted with its hibernation blob so crash recovery restores a
        tag split across the hibernate boundary, not just the caches."""
        if agent_id not in self._scanned and agent_id not in self._tails:
            return None
        tail, base = self._tails.get(agent_id, ("", 0))
        return {"scanned": self._scanned.get(agent_id, 0), "tail": tail, "base": base}

    def restore_state(self, agent_id: str, state: dict) -> None:
        self._scanned[agent_id] = int(state.get("scanned", 0))
        self._tails[agent_id] = (state.get("tail", ""), int(state.get("base", 0)))
