"""The one traffic generator: a mix is a data file, ``traffic/<mix>.json``.

A mix gives the loop (``closed``: the front end's queue is kept
``queue_depth`` deep; ``open``: arrivals at ``rate_per_s``, in bursts of
``burst`` requests due together whose starts are a Poisson process, 1 by
default), the prompt sizes, the ``[TASK: ...]`` tags a request carries,
each request's token budget, its tenant (``tenants``: name -> {"weight":
its weight in the front end's fair queue, "share": its share of the
requests}; one tenant, ``default``, where the mix names none), and the
engine settings of the cell (``engine``).

Every seed gets the same sizes and arrivals in another order: sizes and
inter-arrival gaps are the stratified quantiles of their distributions
(``pool`` of them, so each ``pool`` consecutive requests hold every size
once), which the seed shuffles; a tag's length follows from its word
count; the seed also draws the words.
A prompt is ``<preamble> [TASK: w w w] [TASK: w w w w] ...``, its byte
tokens after a BOS at most ``prompt_limit`` long:

    prompt_limit = main_capacity - max_tags * inject_tokens - river_margin

so that a river's prompt, every thought merged into it and the tokens it
decodes while its sides run fit its cache. A configuration whose prefill
takes only whole chunks (``prompt_multiple``) gets prompts of that many
tokens, or a multiple of it.
"""
from __future__ import annotations

import json
import math
import random
from dataclasses import dataclass
from pathlib import Path
from statistics import NormalDist

HERE = Path(__file__).resolve().parent

# words of three to five letters: a tag's bytes stay under the side
# prompt cap (64) at eight words
WORDS = (
    "ant arc ash bay bee cap cod cue dam den dew dot elm fig fin fog gap gem hat hay ink ivy jam jet key kit "
    "lab lid log map mat mix net nut oak orb owl pad pan pen pig pod ram ray rod rug sap saw sea sky sun tab "
    "tag tan tin tip toe urn van vat web wig yak zip acre apex aqua arch atom aura bark beam bell bolt bond "
    "cave cell chip clay coal code coil cork crab crew dawn deck dial dune dust echo edge fern film flag flux "
    "foam fork gate gear glow gold grid gust halo harp hawk haze helm hill hive horn iris iron jade kiln knot "
    "lake lamp lava leaf lens lime line lion loom loop mast mesa mild mint mist moat moss moth nest node note "
    "oath opal oven palm path peak pier pine plum pond port pulp quay rain reed reef rime ring rock roof root "
    "rope ruby sage sail salt sand seed silk slab snow soil star stem tide tile toad tone tram tree tusk vale "
    "vane veil vine void wave weld well whey wick wind wing wolf yarn zinc zone amber anvil apple arrow aspen "
    "badge baker basin beach berry birch blade bloom board bough brick brook brush cabin cable canal cedar "
    "chalk charm chest cider cliff cloud clove coast comet coral crane creek crest crown delta depot diver "
    "dough drift eagle earth ember fable fence ferry field flame flint flock flora forge frost fruit gable "
    "glade glass globe grain grape grove guild heron hinge honey ivory jewel kayak knoll lance larch latch "
    "lemon level light lilac linen lodge lotus maple marsh medal mirth model moose mound nexus noble north "
    "ocean olive orbit otter oxide paint panel pearl pedal petal piano pilot plank plaza plume polar poppy "
    "prism quail quartz quill raven ridge river robin rover sable scale shade shell shore slate sloth solar "
    "spark spire spoon spray stone storm straw sugar swift table thorn tiger torch tower trail trout tulip "
    "umber valve vapor vault viola wagon whale wheat wharf wheel willow wren yacht yeast zebra"
).split()
WORDS = [w for w in WORDS if 3 <= len(w) <= 5]
BY_LEN = {n: [w for w in WORDS if len(w) == n] for n in (3, 4, 5)}


@dataclass
class Request:
    i: int
    prompt: str
    tasks: list[str]
    max_new_tokens: int
    due: float | None = None    # seconds after the window opens (open loop)
    tenant: str = "default"


def load_mix(name: str, root: Path = HERE) -> dict:
    path = root / "traffic" / f"{name}.json"
    if not path.exists():
        raise FileNotFoundError(f"no traffic mix {name!r} ({path})")
    return json.loads(path.read_text())


def prompt_limit(mix: dict) -> int:
    e = mix["engine"]
    return e["main_capacity"] - mix["tags"]["count"][1] * e["inject_tokens"] - mix["river_margin"]


def _quantiles(n: int, inv) -> list[float]:
    return [inv((k + 0.5) / n) for k in range(n)]


def size_pool(spec: dict, n: int) -> list[int]:
    """``n`` stratified sizes of a distribution spec: uniform (lo, hi) or
    lognormal (median, sigma) clipped to [lo, hi]."""
    lo, hi = spec["lo"], spec["hi"]
    if spec.get("dist", "uniform") == "uniform":
        vals = _quantiles(n, lambda u: lo + u * (hi - lo))
    else:
        nd = NormalDist(math.log(spec["median"]), spec["sigma"])
        vals = _quantiles(n, lambda u: math.exp(nd.inv_cdf(u)))
    return [int(round(min(hi, max(lo, v)))) for v in vals]


def tenant_weights(mix: dict) -> dict[str, float]:
    """The front end's weight of each tenant the mix names."""
    return {k: float(v["weight"]) for k, v in mix.get("tenants", {}).items()}


def gap_pool(rate: float, n: int) -> list[float]:
    """``n`` stratified exponential inter-arrival gaps of mean 1/rate."""
    return _quantiles(n, lambda u: -math.log(1.0 - u) / rate)


class Traffic:
    """Requests of a mix for one seed, made on demand: ``request(i)``."""

    def __init__(self, mix: dict, seed: int, *, prompt_multiple: int = 1):
        self.mix = mix
        self.seed = int(seed)
        self.multiple = max(1, int(prompt_multiple))
        pool = mix.get("pool", 16)
        rnd = random.Random(self.seed)
        t = mix["tags"]
        self.pre = size_pool(mix["preamble_bytes"], pool)
        self.budget = size_pool({"lo": mix["max_new_tokens"][0], "hi": mix["max_new_tokens"][1]}, pool)
        self.ntags = size_pool({"lo": t["count"][0], "hi": t["count"][1]}, pool)
        n_tagged = round(t["share"] * pool)
        self.tagged = [k < n_tagged for k in range(pool)]
        self.tenant = []
        for name, ten in mix.get("tenants", {"default": {"share": 1.0}}).items():
            self.tenant += [name] * round(ten["share"] * pool)
        if len(self.tenant) != pool:
            raise ValueError(f"tenant shares give {len(self.tenant)} of a pool of {pool} requests")
        for lst in (self.pre, self.budget, self.ntags, self.tagged, self.tenant):
            rnd.shuffle(lst)
        self.burst = int(mix.get("burst", 1))
        # the gaps between the starts of bursts
        self.gaps = gap_pool(mix["rate_per_s"] / self.burst, pool) if mix["loop"] == "open" else None
        if self.gaps:
            rnd.shuffle(self.gaps)
        self.limit = prompt_limit(mix)
        self.pool = pool
        self._due = [0.0]

    def _words(self, rnd: random.Random, n_bytes: int) -> str:
        out = ""
        while len(out) < n_bytes:
            out += rnd.choice(WORDS) + " "
        return out[:n_bytes]

    def due(self, i: int) -> float | None:
        """When request ``i`` is due: the start of its burst."""
        if self.gaps is None:
            return None
        b = i // self.burst
        while len(self._due) <= b:
            self._due.append(self._due[-1] + self.gaps[len(self._due) % self.pool])
        return self._due[b]

    def request(self, i: int) -> Request:
        k = i % self.pool
        rnd = random.Random(self.seed * 1_000_003 + i)
        t = self.mix["tags"]
        tasks = []
        if self.tagged[k]:
            lo, hi = t["words"]
            counts = [lo + (c % (hi - lo + 1)) for c in range(self.ntags[k])]
            rnd.shuffle(counts)
            # word j of a tag has 3 + j % 3 letters: a tag's length follows
            # from its word count alone, so every seed's tags are as long
            tasks = [" ".join(rnd.choice(BY_LEN[3 + j % 3]) for j in range(c)) for c in counts]
        tags = " ".join(f"[TASK: {w}]" for w in tasks)
        tag_bytes = len(tags) + (1 if tags else 0)
        total = 1 + self.pre[k] + tag_bytes          # BOS, preamble, " " + tags
        m = self.multiple
        if m > 1 and total > m:
            total = -(-total // m) * m
            if total > self.limit:
                total -= m
        elif m > 1:
            total = m
        total = min(total, self.limit)
        pre = self._words(rnd, total - 1 - tag_bytes)
        prompt = pre + (" " + tags if tags else "")
        assert len(prompt.encode()) + 1 == total, (len(prompt.encode()) + 1, total)
        return Request(i, prompt, tasks, self.budget[k], self.due(i), self.tenant[k])
