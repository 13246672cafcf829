"""One run of one cell: set-up, warm-up, the measured window, the traced
stretch, and the check of what the window served.

The window drives ``repro_torch.serving.frontend.ServingFrontend`` over
``repro_torch.core.engine.CortexEngine`` in this process: requests go in
by ``submit`` and the front end is stepped in its own chunks, as its
transport's pump does. Sampling is greedy, so a seed fixes the work.
"""
from __future__ import annotations

import gc
import importlib.util
import json
import random
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path

import torch

from cortex_bench import probes as probes_lib
from cortex_bench import yardstick
from cortex_bench.traffic import Traffic, load_mix, prompt_limit, tenant_weights

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
clock = time.perf_counter

STRETCH_ARM_S = 3.0   # the traced stretch starts at the first admission after this far into the window
STRETCH_S = 4.0       # and lasts this long
WAIT_AFTER_S = 60.0   # how long past the window's close a sampled request may take to finish
CHECKED = 2           # requests judged per run: the longest finished one and one drawn from the seed
POLICY = {"alpha": 0.5, "coverage_cap": 4.0}  # the landmark pick's policy, as the engine runs it


@dataclass
class RunData:
    """What a run collected; the metric readers take their numbers from it."""

    arch: dict
    window_s: float
    setup_s: float
    peak_bytes: int
    tokens: list                  # (t, n, kind) relative to the window's start
    requests: list                # per request: due, admit, first, done, budget, tokens_out, times
    spans: dict = field(default_factory=dict)     # name -> [seconds] outside the traced stretch
    ticks: int = 0
    stretch: dict = field(default_factory=dict)   # the profiled stretch's readings
    engine: dict = field(default_factory=dict)


def load_bench(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def config_entry(bench: dict, cell: dict) -> dict:
    return next(c for c in bench["configs"] if c["name"] == cell["config"])


def cell_of(bench: dict, name: str, root: Path = ROOT):
    cell = next((w for w in bench["workloads"] if w["name"] == name), None)
    if cell is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    conf = json.loads((root / config_entry(bench, cell)["file"]).read_text())
    return cell, conf, load_mix(cell["traffic"])


def decode_count_of(bench: dict, cell: dict, conf: dict) -> yardstick.DecodeCount:
    """A decode token's work in the cell's configuration, counted from its
    file's ``published`` keys and refused where its entry lists a cut."""
    return yardstick.decode_count(conf["published"], config_entry(bench, cell)["reduced"])


def reference_of(conf: dict):
    """The plain reference module a configuration file names (``reference``,
    a path from the checkout's root)."""
    path = ROOT / conf["reference"]
    spec = importlib.util.spec_from_file_location(f"cortex_bench_ref_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def model_config(conf: dict):
    from repro_torch.models.config import ModelConfig

    return ModelConfig(**conf["model"])


def warm_prompt(n_tokens: int) -> str:
    tag = " [TASK: warm the path]"
    return ("w" * (n_tokens - 1 - len(tag))) + tag


def make_engine(prism, tok, mix: dict, seed: int, device):
    from repro_torch.core.engine import CortexEngine
    from repro_torch.serving.sampler import SamplingParams

    return CortexEngine(prism, tok, sampling=SamplingParams(greedy=True), seed=seed % (1 << 31),
                        device=device, **mix["engine"])


def warm_up(prism, tok, mix, seed, device):
    """One prefill, one spawn, one window of ticks at the cell's lane
    counts and one merge, on an engine of the cell's shapes that is then
    dropped."""
    eng = make_engine(prism, tok, mix, seed, device)
    eng.submit(warm_prompt(128), lane=0)
    eng.run(eng.sync_every)
    side = next(s for s in eng.sides if s.active)
    eng._merge_side(side, "warm thought")
    eng.drain()
    if device.type == "cuda":
        torch.cuda.synchronize()
    del eng
    gc.collect()


def process_start() -> float:
    """This process's start on the ``time.time()`` clock (Linux /proc)."""
    import os

    try:
        ticks = os.sysconf("SC_CLK_TCK")
        start = int(Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()[19]) / ticks
        btime = next(int(l.split()[1]) for l in Path("/proc/stat").read_text().splitlines() if l.startswith("btime"))
        return btime + start
    except (OSError, ValueError, StopIteration):
        return time.time()


def host_reading() -> dict:
    """This process's CPU seconds and involuntary context switches, the
    machine's stolen CPU seconds (the hypervisor's other guests) and its
    load: logged around the window, to tell the host's speed from the
    program's."""
    import os
    import resource

    ru = resource.getrusage(resource.RUSAGE_SELF)
    out = {"cpu_s": ru.ru_utime + ru.ru_stime, "invol": ru.ru_nivcsw, "steal_s": 0.0, "load": 0.0}
    try:
        f = Path("/proc/stat").read_text().splitlines()[0].split()
        out["steal_s"] = int(f[8]) / os.sysconf("SC_CLK_TCK") if len(f) > 8 else 0.0
        out["load"] = float(Path("/proc/loadavg").read_text().split()[0])
    except (OSError, ValueError, IndexError):
        pass
    return out


class Stretch:
    """The traced run's profiled stretch: armed after ``STRETCH_ARM_S``,
    started at the next admission (so it holds a prefill and its spawns)
    or, where none comes, late enough to end with the window; stopped after
    ``STRETCH_S``."""

    def __init__(self, pr, t0: float, t_end: float):
        self.pr, self.arm, self.prof, self.t = pr, t0 + STRETCH_ARM_S, None, None
        self.late = t_end - STRETCH_S - 1.0
        self.done = False

    def maybe_start(self, force: bool = False):
        now = clock()
        if self.done or self.prof is not None or now < self.arm or (force and now < self.late):
            return
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
        self.prof = profile(activities=acts)
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.t = [clock(), None, None]
        self.prof.start()
        self.pr.in_stretch = True
        self.pr.on_tick = self.maybe_stop

    def maybe_stop(self, force: bool = False):
        if self.prof is None or self.done:
            return
        if not force and clock() - self.t[0] < STRETCH_S:
            return
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.t[1] = clock()
        self.pr.in_stretch = False
        self.pr.on_tick = None
        self.prof.stop()
        self.t[2] = clock()
        self.done = True


def run_window(fe, eng, traffic: Traffic, mix: dict, seconds: float, pr, trace: bool):
    """Drive the front end for ``seconds`` and to the end of the step then
    running. Returns (t0, the window's close, requests submitted as {rid:
    (Request, due on the clock)}, the stretch)."""
    from repro_torch.serving.sampler import SamplingParams

    greedy = SamplingParams(greedy=True)
    subs = {}
    t0 = clock()
    t_end = t0 + seconds
    stretch = Stretch(pr, t0, t_end) if trace else None
    if stretch is not None:
        submit = eng.submit

        def submit_traced(*a, **k):
            stretch.maybe_start()
            return submit(*a, **k)
        eng.submit = submit_traced

    def put(i):
        r = traffic.request(i)
        due = t0 + r.due if r.due is not None else clock()
        st = fe.submit(r.prompt, tenant=r.tenant, max_new_tokens=r.max_new_tokens, sampling=greedy)
        subs[st.rid] = (r, due)

    stop = threading.Event()

    def arrivals():
        # open loop: each request is submitted at its due time from this
        # thread, as a transport's handlers do, while the pump steps
        i = 0
        while not stop.is_set():
            wait = t0 + traffic.due(i) - clock()
            if wait > 0 and stop.wait(wait):
                return
            put(i)
            i += 1

    i = 0
    if mix["loop"] == "open":
        feeder = threading.Thread(target=arrivals, daemon=True)
        feeder.start()
    elif mix.get("stagger_ticks"):
        # the rivers enter one at a time, ``stagger_ticks`` apart, so that
        # their request cycles (spawns, merges, admissions) interleave
        for k in range(eng.n_main):
            put(i)
            i += 1
            if k < eng.n_main - 1:
                fe.step(mix["stagger_ticks"])
    while clock() < t_end:
        if mix["loop"] == "closed":
            while len(fe.fq) < mix["queue_depth"]:
                put(i)
                i += 1
        elif not fe.pending():
            time.sleep(0.001)
            continue
        if stretch is not None:
            stretch.maybe_start(force=True)
        fe.step()
    if mix["loop"] == "open":
        stop.set()
        feeder.join()
    if stretch is not None:
        stretch.maybe_stop(force=True)
        eng.submit = submit
    # the window closes where the step that crossed ``seconds`` returned: the
    # engine is drained there, so every token generated in it is delivered
    return t0, clock(), subs, stretch


def request_rows(fe, pr, subs, t0):
    """Per request, on the window's clock: when it was due, admitted, got
    its first token, its budget-th token, and finished."""
    rows = []
    for rid, (r, due) in subs.items():
        q = fe.requests[rid]
        rel = lambda t: None if t is None else t - t0
        at_budget = next((t for t, n in pr.river_times[rid] if n >= r.max_new_tokens), None)
        rows.append({"rid": rid, "due": due - t0, "admit": rel(q.t_admit), "first": rel(q.t_first),
                     "budget_at": rel(at_budget), "done": rel(q.t_done), "status": q.status,
                     "budget": r.max_new_tokens, "tokens_out": q.tokens_out, "tags": len(r.tasks),
                     "tenant": r.tenant})
    return rows


def is_device_work(e) -> bool:
    """Whether a profiler event is work on the device (a kernel, a copy, a
    fill), chosen by its kind: a range's device-side copy (an annotation,
    the benchmark's or the program's own) is not work."""
    from torch.autograd import DeviceType

    if e.device_type != DeviceType.CUDA:
        return False
    return not (getattr(e, "is_user_annotation", False) or getattr(e, "activity_type", None) == "gpu_user_annotation")


def read_stretch(stretch, pr, count: yardstick.DecodeCount, log=print) -> dict:
    """Device busy time, kernel time under the benchmark's ranges, the
    bound of those calls, the decode operations of the stretch (by
    ``count``, a decode token's work), and the breakdown, from the
    profiler's events."""
    from torch.autograd import DeviceType

    t_a, t_b = stretch.t[0], stretch.t[1]
    events = stretch.prof.events()
    dev, host, kinds = [], [], {}
    for e in events:
        if is_device_work(e):
            dev.append(e)
        elif e.device_type != DeviceType.CUDA and e.name.startswith("cb."):  # the benchmark's host spans
            host.append((e.time_range.start, e.time_range.end, e.name[3:]))
        if e.device_type == DeviceType.CUDA:
            k = (getattr(e, "activity_type", None), bool(getattr(e, "is_user_annotation", False)), is_device_work(e))
            kinds[k] = kinds.get(k, 0) + 1
    log("device events (kind, annotation, counted): " + ", ".join(f"{k}: {n}" for k, n in sorted(kinds.items(), key=str)))
    iv = [(e.time_range.start, e.time_range.end) for e in dev]
    # the profiler's clock: microseconds; the stretch's wall from the host clock
    w0 = min((a for a, _ in iv), default=0.0)
    wall_us = (t_b - t_a) * 1e6
    busy_us = yardstick.union_length(iv)
    out = {"window_s": t_b - t_a, "busy_s": busy_us * 1e-6}
    by_name = {}
    for e in dev:
        by_name[e.name] = by_name.get(e.name, 0.0) + (e.time_range.end - e.time_range.start)
    out["device_ops"] = sorted(([k[:80], v * 1e-6] for k, v in by_name.items()), key=lambda kv: -kv[1])[:10]
    for name, cost in (("synapse_attention", yardstick.synapse_attention_cost),
                       ("landmark_score", yardstick.landmark_score_cost)):
        calls = pr.kernel_calls.get(name, [])
        if not calls:
            continue
        counts = torch.stack([c for _, c in calls]).tolist()
        bound = sum(yardstick.bound_s(*cost(s[0], s[1], s[2], n)) for (s, _), n in zip(calls, counts))
        # the kernel is launched from its library, outside any PyTorch op: its
        # device events are found by the kernel's name
        t_dev = sum(v for k, v in by_name.items() if f"{name}_kernel" in k) * 1e-6
        out[f"{name}_bound_s"], out[f"{name}_device_s"], out[f"{name}_calls"] = bound, t_dev, len(calls)
    # decode operations of the lanes live in each traced tick; a lane reads
    # the same keys in each attention layer
    toks = sum(r + s for r, _, s, _ in pr.ticks)
    keys = sum(rk + sk for _, rk, _, sk in pr.ticks)
    out["decode_tokens"] = toks
    out["decode_flops"] = yardstick.decode_flops(count, toks, keys)
    # idle gaps named by the benchmark span open on the host at their middle
    gaps = yardstick.idle_gaps(iv, w0, w0 + wall_us)[:10]
    named = []
    for a, b in gaps:
        mid = (a + b) / 2
        open_ = [(s, n) for s, e, n in host if s <= mid <= e]
        named.append([max(open_)[1] if open_ else "host (no span)", (b - a) * 1e-6])
    out["idle_gaps"] = named
    return out


def served_requests(fe, pr, subs, t_end, seed: int) -> list[dict]:
    """The requests to judge: the finished one with the most served tokens
    and one more drawn from the seed, each with what it served."""
    done = [rid for rid in subs if fe.requests[rid].status == "ok" and fe.requests[rid].t_done <= t_end]
    if not done:
        return []
    size = lambda rid: len(pr.rivers[rid]) + sum(len(s["tokens"]) for s in pr.sides if s["rid"] == rid)
    pick = [max(done, key=size)]
    rest = sorted(set(done) - set(pick))
    if rest and CHECKED > 1:
        pick += random.Random(seed).sample(rest, min(len(rest), CHECKED - 1))
    out = []
    for rid in pick:
        r, _ = subs[rid]
        sides = [s for s in pr.sides if s["rid"] == rid]
        index = {id(s): j for j, s in enumerate(sides)}
        merges = [{"side": index[id(m["side"])], "at": m["at"], "gate": m["gate"]}
                  for m in pr.merges if m["rid"] == rid]
        out.append({"rid": rid, "prompt": r.prompt, "river": list(pr.rivers[rid]),
                    "sides": [{"task": s["task"], "tokens": list(s["tokens"])} for s in sides],
                    "picks": [s["picks"] for s in sides], "merges": merges})
    return out


def _gate_gap(ref_gates, got_gates) -> float:
    """The largest gap between two lists (per request) of gate scores; a
    request whose merges differ in number fails outright."""
    gap = 0.0
    for a, b in zip(ref_gates, got_gates):
        if len(a) != len(b):
            return float("inf")
        gap = max([gap] + [abs(x - y) for x, y in zip(a, b)])
    return gap


def judge(conf: dict, mix: dict, weights, reqs: list[dict], *, control: bool = False) -> dict:
    """The numbers compared: the widest logit gap of a served river token
    and of a side token served before its window ring was full (see
    ``reference.replay._sides``) under the reference, the largest regret of
    a spawn's landmark pick, and the largest gap between the program's gate
    score and the reference's. With ``control``, the same numbers of the
    reference put in the program's place at fp8."""
    from cortex_bench.reference.replay import control_choices, replay

    RefModel = reference_of(conf).RefModel

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    e = mix["engine"]
    eng = {"inject_tokens": e["inject_tokens"], "n_landmarks": 64, "window": 64,
           "side_prompt_cap": e.get("side_prompt_cap", 64), "policy": POLICY}
    ref = RefModel(conf["model"], weights)
    nums = {}
    with torch.no_grad():
        out = replay(ref, reqs, eng, picks=[r["picks"] for r in reqs])
        nums = {"river_gap": out["river"].gap(), "side_gap": out["sides"].gap(), "pick_regret": out["regret"],
                "gate_gap": _gate_gap(out["gates"], [[mg["gate"] for mg in r["merges"]] for r in reqs])}
        ctrl = None
        if control:
            low = RefModel(conf["model"], weights, low=True)
            lo = replay(low, reqs, eng)
            del low
            judged = replay(ref, reqs, eng, picks=lo["picks"], others=control_choices(lo, reqs))
            ctrl = {"river_gap": judged["river"].gap("other"), "side_gap": judged["sides"].gap("other"),
                    "pick_regret": judged["regret"], "gate_gap": _gate_gap(judged["gates"], lo["gates"])}
    n_tok = len(out["river"].keys) + len(out["sides"].keys)
    return {"numbers": nums, "control": ctrl, "tokens_judged": n_tok, "seconds": out["seconds"],
            "requests_judged": len(reqs)}


def run(workload: str, seed: int, seconds: float, trace: bool, *, device: str = "cuda",
        control: bool = False, overrides: dict | None = None, log=print) -> dict:
    """One run. ``overrides`` (tests only) replaces fields of the
    configuration, its ``model`` block and the mix."""
    t_start = process_start()
    bench = load_bench()
    cell, conf, mix = cell_of(bench, workload)
    if overrides:  # {"model": ..., "conf": ..., "mix": ...}: each merged over the cell's own
        conf = {**conf, **overrides.get("conf", {}), "model": {**conf["model"], **overrides.get("model", {})}}
        mix = {**mix, **overrides.get("mix", {})}
    # before set-up: a configuration the yardstick cannot count is refused here
    count = decode_count_of(bench, cell, conf)
    dev = torch.device(device)
    from repro_torch.core.prism import Prism
    from repro_torch.data.tokenizer import ByteTokenizer
    from repro_torch.serving.frontend import ServingFrontend

    from cortex_bench.weights import make_weights

    marks = [("imported", time.time() - t_start)]
    if dev.type == "cuda":
        from repro_torch.kernels import ops
        ops.build_kernels()
        marks.append(("kernels", time.time() - t_start))
    cfg = model_config(conf)
    traffic = Traffic(mix, seed, prompt_multiple=conf.get("prompt_multiple", 1))
    weights = make_weights(cfg, seed, dev)
    prism = Prism(weights, cfg, device=dev)
    tok = ByteTokenizer(cfg.vocab_size)
    marks.append(("weights", time.time() - t_start))
    warm_up(prism, tok, mix, seed, dev)
    marks.append(("warm-up", time.time() - t_start))
    eng = make_engine(prism, tok, mix, seed, dev)
    # a backlog shows as waiting, never as refusals
    fe = ServingFrontend(eng, tenants=tenant_weights(mix), clock=clock, max_queue=1 << 20)
    pr = probes_lib.Probes(trace=trace)
    pr.install(eng, fe)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    torch.set_num_threads(1)
    gc.collect()
    gc.freeze()  # the set-up's objects stay out of the window's collections
    setup_s = time.time() - t_start
    log("set-up: " + ", ".join(f"{k} {v:.2f} s" for k, v in marks + [("engine", setup_s)]))
    h0 = host_reading()
    t0, t_end, subs, stretch = run_window(fe, eng, traffic, mix, seconds, pr, trace)
    t_close = clock()
    h1 = host_reading()
    log(f"window host: {h1['cpu_s'] - h0['cpu_s']:.2f} CPU s of {t_end - t0:.2f} s, "
        f"{h1['invol'] - h0['invol']} involuntary switches, {h1['steal_s'] - h0['steal_s']:.2f} s stolen, "
        f"load {h0['load']:.2f} -> {h1['load']:.2f}")
    peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
    gc.unfreeze()
    # the requests to judge; wait for one to finish where none has
    reqs = served_requests(fe, pr, subs, t_end, seed)
    t_wait = clock()
    while not reqs and clock() - t_wait < WAIT_AFTER_S and fe.pending():
        fe.step()
        reqs = served_requests(fe, pr, subs, float("inf"), seed)
    rows = request_rows(fe, pr, subs, t0)
    data = RunData(arch=conf["model"], window_s=t_end - t0, setup_s=setup_s, peak_bytes=peak,
                   tokens=[(t - t0, n, k) for t, n, k in pr.tokens], requests=rows,
                   engine={"stats": dict(eng.stats), "spawns": len(pr.sides), "merges": len(pr.merges),
                           "prompt_limit": prompt_limit(mix)})
    if trace:
        cut = (stretch.t[0], stretch.t[2]) if stretch and stretch.t else (0.0, 0.0)
        data.spans = {k: [b - a for a, b in v if b <= cut[0] or a >= cut[1]] for k, v in pr.spans.items()}
        data.ticks = len(data.spans.get("dispatch", []))
        if stretch and stretch.t:
            data.stretch = read_stretch(stretch, pr, count, log=log)
            inside = {k: sum(1 for a, b in v if a >= cut[0] and b <= cut[1]) for k, v in pr.spans.items()}
            log(f"stretch: {data.stretch['window_s']:.2f} s from {stretch.t[0] - t0:.2f} s into the window, "
                f"{len(pr.ticks)} ticks, {data.stretch['decode_tokens']} decode tokens, spans {inside}, "
                f"read in {clock() - t_close:.1f} s")
    pr.remove()
    del fe, eng, pr, prism
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    log(f"window: {len(subs)} requests submitted, {sum(r['status'] == 'ok' for r in rows)} finished, "
        f"{data.engine['spawns']} spawns, {data.engine['merges']} merges, {data.engine['stats'].get('ticks')} ticks; "
        f"judging {len(reqs)}")
    t_j = clock()
    verdict = judge(conf, mix, weights, reqs, control=control) if reqs else None
    log(f"reference: {clock() - t_j:.1f} s" + (f" ({verdict['seconds']})" if verdict else ""))
    return {"cell": cell, "conf": conf, "mix": mix, "data": data, "verdict": verdict,
            "attempted": len(subs), "failed": sum(r["status"] == "error" for r in rows)}
