"""The served system's semantics, replayed in plain PyTorch over one request.

A request is a river (its prompt, the tokens it served) and the side
agents its tags spawned (each one's task and served tokens), with the
points at which each side's thought was merged back. The replay
teacher-forces every served token and reads the reference's logits at
each position, so the served tokens can be judged; it works out again
everything the program derived: the river's cache, each spawn's landmark
pick, each side's synapse cache while its window ring fills, each thought's
keys and states and their injection, and the gate's score.

Semantics (the paper's mechanism as the system runs it):

* The river's prompt fills its cache; the first decode step feeds the
  prompt's last token once more, at position P, and each later step the
  token sampled before it, at the next position.
* A spawn picks K landmarks of each attention cache greedily by
  ``alpha * density + (1 - alpha) * coverage``; density is the softmax mass
  of the newest key (as the query of every head of its group), summed
  over heads and scaled by its largest value; coverage is each key's
  head-mean distance to the nearest landmark picked so far, capped.
  A side's recurrent states are the parent's.
* A side teacher-forces ``[TASK: <task>]`` from the parent's position, then
  decodes over [landmarks; a window ring of its own keys]; its tokens are
  judged while the ring fills, before any key graduates into the
  landmarks (see ``_sides``).
* A merge encodes the last ``inject`` bytes of the side's text (padded) as
  its own sequence at the river's next position, appends those keys to the
  river's caches and blends its terminal recurrent state into the river's
  (weight ``BLEND``); the gate's score is the cosine of the two final
  hidden states.
"""
from __future__ import annotations

import time

import torch

from cortex_bench.reference.model import RefModel

BOS, PAD = 257, 256
BLEND = 0.3


def side_prompt_ids(task: str, cap: int) -> list[int]:
    ids = list(f"[TASK: {task}]".encode())
    if len(ids) > cap:
        ids = ids[: cap - 1] + [ord("]")]
    return ids


def thought_ids(tokens, n: int) -> list[int]:
    """The ids a merge encodes: the side's text (its byte tokens decoded
    as UTF-8, invalid sequences replaced) re-encoded, the last ``n``,
    padded at the end."""
    text = bytes(t for t in tokens if 0 <= t < 256).decode("utf-8", errors="replace")
    ids = list(text.encode())[-n:]
    return ids + [PAD] * (n - len(ids))


def _pool(k):
    return k.mean(dim=-2)


def _dist(a, b):
    """a [..., T, D], b [..., D] -> [..., T]: ||a - b|| / sqrt(D)."""
    return torch.sqrt(((a - b[..., None, :]) ** 2).sum(-1) / a.shape[-1])


def density(m: RefModel, keys):
    """keys [A, T, Hkv, D] -> [A, T]: the newest key's softmax mass as the
    query of each head, summed over heads."""
    A, T, Hkv, D = keys.shape
    q = torch.repeat_interleave(keys[:, -1], m.H // Hkv, dim=1)
    valid = torch.ones(A, T, dtype=torch.bool, device=keys.device)
    return m.attend(q, keys, keys, valid)[1]


def pick_landmarks(m: RefModel, keys, n: int, policy: dict, given=None):
    """Greedy hybrid pick over keys [A, T, Hkv, D] (every key valid).
    ``given`` [A, n]: judge that pick order instead of choosing. Returns
    (picks [A, n] in pick order, the largest regret: how far a pick's
    score lies below the best score at its step)."""
    A, T = keys.shape[:2]
    dev = keys.device
    dens = density(m, keys)
    dens = dens / (dens.amax(-1, keepdim=True) + 1e-9)
    pooled = _pool(keys)
    cap, alpha = policy["coverage_cap"], policy["alpha"]
    min_d = torch.full((A, T), float("inf"), device=dev)
    taken = torch.zeros(A, T, dtype=torch.bool, device=dev)
    picks = torch.zeros(A, n, dtype=torch.long, device=dev)
    regret = torch.zeros(A, device=dev)
    lane = torch.arange(A, device=dev)
    for i in range(n):
        s = alpha * dens + (1 - alpha) * torch.clamp(min_d, max=cap) / cap
        s = torch.where(taken, torch.full_like(s, -1e30), s)
        best, arg = s.max(-1)
        idx = arg if given is None else given[:, i].long()
        got = s[lane, idx]
        regret = torch.maximum(regret, best - got)
        min_d = torch.minimum(min_d, _dist(pooled, pooled[lane, idx]))
        taken[lane, idx] = True
        picks[:, i] = idx
    return picks, float(regret.max())


class SynapseMemory:
    """The side agents' attention cache of one layer, batched over the
    sides: K landmarks and a W-slot window ring filling behind them, no
    injected keys. Only the steps before the ring is full are replayed
    (see ``_sides``), so no key graduates."""

    def __init__(self, lm_k, lm_v, window: int):
        B = lm_k.shape[0]
        self.lm_k, self.lm_v = lm_k, lm_v
        self.W = window
        self.win_k = torch.zeros((B, window, *lm_k.shape[2:]), device=lm_k.device)
        self.win_v = torch.zeros_like(self.win_k)
        self.n = 0

    def step(self, m: RefModel, q, k, v, pos):
        B, K, W = q.shape[0], self.lm_k.shape[1], self.W
        self.win_k[:, self.n], self.win_v[:, self.n] = k, v
        self.n += 1
        valid = torch.arange(K + W, device=q.device)[None].expand(B, -1) < K + self.n
        out, _ = m.attend(q, torch.cat([self.lm_k, self.win_k], 1), torch.cat([self.lm_v, self.win_v], 1), valid)
        return out


class Tally:
    """What the replay reads at each judged position: the reference's best
    logit, its choice, the logit of the token served there, and of any other
    token given for that position; ``keys`` names each row's agent."""

    def __init__(self):
        self.top, self.served, self.other, self.best, self.keys = [], [], [], [], []

    def add(self, logits, served, other=None, keys=None):
        best, top = logits.max(-1)
        self.best.append(best)
        self.top.append(top)
        self.served.append(logits.gather(-1, served[:, None].to(logits.device))[:, 0])
        if other is not None:
            self.other.append(logits.gather(-1, other[:, None].to(logits.device))[:, 0])
        self.keys.extend(keys or [None] * logits.shape[0])

    def gap(self, which: str = "served") -> float:
        vals = self.served if which == "served" else self.other
        if not vals:
            return 0.0
        return float((torch.cat(self.best) - torch.cat(vals)).max())

    def tops(self) -> list[int]:
        return torch.cat(self.top).tolist() if self.top else []


def _spawn(m: RefModel, req: dict, eng: dict, picks) -> dict:
    """The river's prefill and its spawns' picks: one pick per distinct
    order given (all the sides of a request spawn from the same prompt
    cache)."""
    dev = m.dev
    prompt = [BOS] + list(req["prompt"].encode())
    P = len(prompt)
    hid, kv, states = m.prefill(torch.tensor([prompt], device=dev), torch.arange(P, device=dev)[None])
    keys = torch.stack([k[0] for k, _ in kv])      # [A, P, Hkv, D]
    vals = torch.stack([v[0] for _, v in kv])
    regret, side_picks, seen = 0.0, [], {}
    for j in range(len(req["sides"])):
        given = None if picks is None else picks[j]
        key = None if given is None else given.cpu().numpy().tobytes()
        if key not in seen:
            seen[key] = pick_landmarks(m, keys, eng["n_landmarks"], eng["policy"], given)
        got, rg = seen[key]
        regret = max(regret, rg)
        side_picks.append(got)
    return {"prompt": prompt, "P": P, "h": hid[0, -1], "keys": keys, "vals": vals, "states": states,
            "picks": side_picks, "regret": regret, "gates": []}


class LaneMemory:
    """The rivers' attention cache of one layer, batched over the rivers:
    each lane's keys in slot order, up to its own length."""

    def __init__(self, ks, vs, cap: int):
        B, (Hkv, D) = len(ks), ks[0].shape[1:]
        self.k = torch.zeros(B, cap, Hkv, D, device=ks[0].device)
        self.v = torch.zeros_like(self.k)
        for r, (k, v) in enumerate(zip(ks, vs)):
            self.k[r, :len(k)], self.v[r, :len(v)] = k, v
        self.n = [len(k) for k in ks]
        self.nd = torch.tensor(self.n, device=ks[0].device)

    def append(self, r: int, k, v):
        n, T = self.n[r], k.shape[0]
        self.k[r, n:n + T], self.v[r, n:n + T] = k, v
        self.n[r] += T
        self.nd[r] += T

    def step(self, m: RefModel, q, k, v, pos):
        lane = torch.arange(q.shape[0], device=q.device)
        self.k[lane, self.nd], self.v[lane, self.nd] = k, v
        valid = torch.arange(self.k.shape[1], device=q.device)[None] <= self.nd[:, None]
        self.n = [n + 1 for n in self.n]
        self.nd += 1
        return m.attend(q, self.k, self.v, valid)[0]


def _rivers(m: RefModel, reqs: list, starts: list, eng: dict, others, tally: Tally) -> None:
    """Every river, decoded as one batch, with each merge at its point:
    the thought encoded as its own sequence at the river's next position,
    its keys appended, its terminal states blended in, the gate's score
    taken."""
    dev = m.dev
    J, B = eng["inject_tokens"], len(reqs)
    rivers = [r["river"] for r in reqs]
    steps = max(len(t) for t in rivers)
    cap = max(s["P"] + len(t) + J * len(r["merges"]) for s, t, r in zip(starts, rivers, reqs)) + steps + 1
    mems = [LaneMemory([s["keys"][a] for s in starts], [s["vals"][a] for s in starts], cap)
            for a in range(starts[0]["keys"].shape[0])]
    states = [[torch.cat([s["states"][i][c] for s in starts]) for c in range(2)]
              for i in range(len(starts[0]["states"]))]
    at = {}
    for r, req in enumerate(reqs):
        for mg in req["merges"]:
            at.setdefault(mg["at"], []).append((r, mg))
    pad = lambda t, n: t + [0] * (n - len(t))
    fed = torch.tensor([[s["prompt"][-1]] + pad(t[:-1], steps - 1) for s, t in zip(starts, rivers)], device=dev).T
    P = torch.tensor([s["P"] for s in starts], device=dev)
    h_last = torch.stack([s["h"] for s in starts])
    for k in range(steps + 1):
        todo = at.get(k, [])
        if todo:
            th = torch.tensor([thought_ids(reqs[r]["sides"][mg["side"]]["tokens"], J) for r, mg in todo], device=dev)
            tpos = torch.stack([P[r] + k for r, _ in todo])[:, None] + torch.arange(J, device=dev)[None]
            t_hid, t_kv, t_st = m.prefill(th, tpos)
            for i, (r, _) in enumerate(todo):
                a, b = h_last[r], t_hid[i, -1]
                starts[r]["gates"].append(float((a * b).sum() / (a.norm() * b.norm() + 1e-8)))
                for mem, (tk, tv) in zip(mems, t_kv):
                    mem.append(r, tk[i], tv[i])
                for st, ts in zip(states, t_st):
                    for c in range(2):
                        st[c][r] = (1 - BLEND) * st[c][r] + BLEND * ts[c][i]
        if k == steps:
            break
        logits, h_last = m.step(fed[k], P + k, mems, states)
        rows = [r for r in range(B) if k < len(rivers[r])]
        other = None if others is None else torch.tensor([others[r]["river"][k] for r in rows])
        tally.add(logits[torch.tensor(rows, device=dev)], torch.tensor([rivers[r][k] for r in rows]), other,
                  keys=[(r, k) for r in rows])


def _sides(m: RefModel, reqs: list, starts: list, eng: dict, others, tally: Tally) -> None:
    """Every side of every request, decoded as one batch from its spawn,
    up to the step at which its window ring is full. From there on the
    key that leaves the ring graduates into the landmarks, or not, by a
    comparison of attention-mass averages, and which landmark it evicts by
    another; in every lane some of these comparisons tie to within
    rounding (PERF.md), so the program's cache and the reference's part
    by whole keys, and a served token there cannot be judged by its
    logit."""
    dev = m.dev
    lanes = [(r, j) for r, req in enumerate(reqs) for j in range(len(req["sides"]))]
    if not lanes:
        return
    tasks = [side_prompt_ids(reqs[r]["sides"][j]["task"], eng["side_prompt_cap"]) for r, j in lanes]
    toks = [reqs[r]["sides"][j]["tokens"] for r, j in lanes]
    mems = []
    for a in range(starts[0]["keys"].shape[0]):
        lm = []
        for r, j in lanes:
            st = starts[r]
            order = torch.argsort(st["picks"][j][a])
            idx = st["picks"][j][a][order]
            lm.append((st["keys"][a][idx], st["vals"][a][idx]))
        mems.append(SynapseMemory(*(torch.stack(t) for t in zip(*lm)), eng["window"]))
    n_states = len(starts[0]["states"])
    states = [[torch.cat([starts[r]["states"][i][c] for r, _ in lanes]) for c in range(2)] for i in range(n_states)]
    pos0 = torch.tensor([starts[r]["P"] for r, _ in lanes], device=dev)
    steps = min(max(len(t) - 1 + len(g) for t, g in zip(tasks, toks)), eng["window"])
    # each lane's input at each step: its task teacher-forced, then what it served
    feed = torch.tensor([[task[t] if t < len(task) else (g[t - len(task)] if t - len(task) < len(g) else 0)
                          for task, g in zip(tasks, toks)] for t in range(steps)], device=dev)
    for t in range(steps):
        logits, _ = m.step(feed[t], pos0 + t, mems, states)
        rows = [b for b in range(len(lanes)) if 0 <= t - len(tasks[b]) + 1 < len(toks[b])]
        if not rows:
            continue
        gi = [t - len(tasks[b]) + 1 for b in rows]
        other = None
        if others is not None:
            other = torch.tensor([others[lanes[b][0]]["sides"][lanes[b][1]][g] for b, g in zip(rows, gi)])
        tally.add(logits[torch.tensor(rows, device=dev)], torch.tensor([toks[b][g] for b, g in zip(rows, gi)]),
                  other, keys=[lanes[b] for b in rows])


def replay(m: RefModel, reqs: list, eng: dict, *, picks=None, others=None) -> dict:
    """Teacher-forced replay of the judged requests.

    Each request: prompt (str), river (served token ids), sides (list of
    {task, tokens}) in spawn order, merges (list of {side, at, gate}: the
    side's index, the river's served-token count when it merged, the
    program's gate score) in merge order. ``eng``: inject_tokens,
    n_landmarks, window, side_prompt_cap, policy. ``picks``: per request,
    per side, the pick order [n_attn, K] to judge (None: the reference
    picks). ``others``: per request {"river": [...], "sides": [[...], ...]},
    further tokens to read at each served position (the control's choices).

    Returns the tallies of the rivers and of the sides, each request's
    picks and reference gate scores, and the largest pick regret."""
    river, sides = Tally(), Tally()
    t0 = time.perf_counter()
    starts = [_spawn(m, req, eng, None if picks is None else picks[r]) for r, req in enumerate(reqs)]
    _rivers(m, reqs, starts, eng, others, river)
    t1 = time.perf_counter()
    _sides(m, reqs, starts, eng, others, sides)
    t2 = time.perf_counter()
    return {"river": river, "sides": sides, "picks": [s["picks"] for s in starts],
            "gates": [s["gates"] for s in starts], "regret": max((s["regret"] for s in starts), default=0.0),
            "seconds": {"rivers": t1 - t0, "sides": t2 - t1}}


def control_choices(out: dict, reqs: list) -> list[dict]:
    """The control's own tokens at each served position (its argmax), per
    request in the layout ``replay(others=...)`` takes."""
    res = [{"river": [], "sides": [[] for _ in req["sides"]]} for req in reqs]
    for (r, _), t in zip(out["river"].keys, out["river"].tops()):
        res[r]["river"].append(t)
    for (r, j), t in zip(out["sides"].keys, out["sides"].tops()):
        res[r]["sides"][j].append(t)
    return res
