"""The benchmark's own spans, counters and records, installed around calls
into the program from outside it (module attributes and the engine's
methods are wrapped; no file of the program changes), and removed again.

Always on (they feed the check of what the window served):

* each token delivered to an agent, with its time (the engine's stream
  tap, which the front end installs);
* each spawn's landmark pick (``core.synapse.select_landmarks``; a copy of
  the pick order stays on the device) and each side agent's task;
* each merge: which side, and how many tokens its river had served
  (``CortexEngine._merge_side``), and the program's gate score.

With tracing on, also: host time in ``core.engine.one_tick``, of each
merge (up to the engine's own sync after it), of each spawn and each
prompt prefill (synchronised at their end), the lanes each tick decodes
and the keys they read, and profiler ranges around the two kernels'
entry points with the valid keys of each call.
"""
from __future__ import annotations

import time
from collections import defaultdict

import torch

clock = time.perf_counter


class Probes:
    def __init__(self, *, trace: bool):
        self.trace = trace
        self._undo = []
        self.tokens = []                         # (t, n, kind)
        self.rivers = defaultdict(list)          # rid -> served tokens
        self.river_times = defaultdict(list)     # rid -> (t, tokens served by then)
        self.sides = []                          # side records in spawn order
        self._live_side = {}                     # agent_id -> side record
        self._picks = []
        self.merges = []                         # {rid, side, at, gate}
        self.spans = defaultdict(list)           # name -> [(t0, t1)]
        self.ticks = []                          # per tick of the stretch: Probes.lanes
        self.kernel_calls = defaultdict(list)    # name -> [(shapes, valid keys on the device)]
        self.in_stretch = False
        self.on_tick = None                      # called after each traced tick
        self.merged = defaultdict(int)           # rid -> merges so far

    # -- plumbing -------------------------------------------------------
    def _wrap(self, owner, name, make):
        orig = getattr(owner, name)
        setattr(owner, name, make(orig))
        self._undo.append((owner, name, orig))

    def remove(self):
        for owner, name, orig in reversed(self._undo):
            setattr(owner, name, orig)
        self._undo.clear()

    def _span(self, name, fn, *, sync=False):
        def run(*a, **k):
            t0 = clock()
            with torch.profiler.record_function(f"cb.{name}"):
                out = fn(*a, **k)
            if sync and torch.cuda.is_available() and torch.cuda.is_initialized():
                torch.cuda.synchronize()
            self.spans[name].append((t0, clock()))
            return out
        return run

    # -- installation -----------------------------------------------------
    def install(self, eng, fe):
        from repro_torch.core import engine as engine_mod
        from repro_torch.core import synapse as synapse_mod
        from repro_torch.kernels import ops
        from repro_torch.models import model as model_mod

        def picks(orig):
            def select(*a, **k):
                out = orig(*a, **k)
                self._picks.append(out[0].clone())
                return out
            return select
        self._wrap(synapse_mod, "select_landmarks", picks)

        def spawn(orig):
            def run(parent, task, *a, **k):
                n = len(self._picks)
                s = orig(parent, task, *a, **k)
                if s is not None:
                    rec = {"rid": _rid(parent.agent_id), "task": task, "tokens": [],
                           "picks": self._picks[n] if len(self._picks) > n else None}
                    self.sides.append(rec)
                    self._live_side[s.agent_id] = rec
                return s
            return run
        self._wrap(eng, "_spawn_side", spawn)

        def merge(orig):
            def run(s, thought):
                rec = self._live_side.pop(s.agent_id)
                river = eng.mains[s.parent_lane]
                at = len(river.tokens) - river.prompt_len
                t0 = clock()
                out = orig(s, thought)
                if self.trace:
                    self.spans["merge"].append((t0, clock()))
                gate = eng.history[-1]["gate_score"]
                self.merges.append({"rid": rec["rid"], "side": rec, "at": at, "gate": gate})
                self.merged[rec["rid"]] += 1
                return out
            return run
        self._wrap(eng, "_merge_side", merge)

        def tap(orig):
            def run(view, chunk, toks):
                self.tokens.append((clock(), len(toks), view.kind))
                if view.kind == "main":
                    rid = _rid(view.agent_id)
                    self.rivers[rid].extend(int(t) for t in toks)
                    self.river_times[rid].append((self.tokens[-1][0], len(self.rivers[rid])))
                else:
                    rec = self._live_side.get(view.agent_id)
                    if rec is not None:
                        rec["tokens"].extend(int(t) for t in toks)
                return orig(view, chunk, toks)
            return run
        self._wrap(eng, "stream_tap", tap)

        if not self.trace:
            return
        self._wrap(engine_mod, "spawn_caches", lambda f: self._span("spawn", f, sync=True))
        self._wrap(model_mod, "prefill_lane", lambda f: self._span("prefill", f, sync=True))

        def tick(orig):
            def run(params, st, cursor, **k):
                t0 = clock()
                with torch.profiler.record_function("cb.dispatch"):
                    out = orig(params, st, cursor, **k)
                t1 = clock()
                self.spans["dispatch"].append((t0, t1))
                if self.in_stretch:
                    self.ticks.append(self.lanes(eng, cursor, k["step_sides"]))
                if self.on_tick is not None:
                    self.on_tick()
                return out
            return run
        self._wrap(engine_mod, "one_tick", tick)
        self._wrap(eng, "_fetch_rings", lambda f: self._span("fetch", f))
        self._wrap(eng, "_postprocess", lambda f: self._span("postprocess", f))

        for name, pos_valid in (("synapse_attention", 3), ("landmark_score", 3)):
            def kern(orig, name=name, pos_valid=pos_valid):
                def run(*a, **k):
                    if not self.in_stretch:
                        return orig(*a, **k)
                    valid = a[pos_valid] if len(a) > pos_valid else k.get("valid")
                    with torch.profiler.record_function(f"cb.{name}"):
                        out = orig(*a, **k)
                    shapes = (tuple(a[0].shape), tuple(a[1].shape), a[0].element_size())
                    self.kernel_calls[name].append((shapes, valid.sum(dtype=torch.int64)))
                    return out
                return run
            self._wrap(ops, name, kern)

    def lanes(self, eng, cursor: int, step_sides: bool) -> tuple[int, int, int, int]:
        """(live rivers, keys they read, live sides, keys they read) in a
        tick, from the engine's host mirrors (a window stale at most:
        ``cursor`` ticks are added)."""
        mains = [m for m in eng.mains if m.active]
        river_keys = sum(m.position + cursor + eng.inject_tokens * self.merged[_rid(m.agent_id)] for m in mains)
        sides = [s for s in eng.sides if s.active] if step_sides else []
        K, W = eng.side_spec.n_landmarks, eng.side_spec.window
        side_keys = sum(K + min(W, s.steps + cursor + 1) for s in sides)
        return len(mains), river_keys, len(sides), side_keys


def _rid(agent_id: str) -> int:
    """The front end names a request's river ``fe<rid>``."""
    return int(agent_id[2:].split(".")[0])


