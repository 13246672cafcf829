"""Serving launcher: the front end over either backend, on the card.

Port of the JAX package's ``repro.launch.serve``:

    # multi-tenant, streaming, weighted-fair — the cortex engine backend
    PYTHONPATH=src python -m repro_torch.launch.serve --mode cortex \\
        --tenants gold:4,free:1 \\
        --request "gold:0:Question: what scales? [TASK: verify memory math] Answer:" \\
        --request "free:0:Summarize the architecture."

    # plain continuous batching behind the same front end
    PYTHONPATH=src python -m repro_torch.launch.serve --mode batch

    # the same requests over sockets: an HTTP/1.1 + SSE server fronts the
    # front end and each request becomes a loopback client
    PYTHONPATH=src python -m repro_torch.launch.serve --listen 127.0.0.1:0

    # on the CPU (the default is the card; without one it raises)
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --mode batch

Requests stream: decoded chunks print as the backend commits them, and a
final SLO summary (TTFT, p50/p99 tick latency, token shares, fairness
counters) follows. Weights are random, from ``init_params`` seeded 0;
``--reduced`` (the default) is the small smoke variant of the config,
``--full`` the published widths. :func:`main` returns the front end's
metrics.

Crash recovery: point ``--cold-dir`` at a persistent directory and a later
run with ``--recover`` rebuilds the cold tier from disk (integrity-checked;
corrupt blobs quarantined), re-adopts the agents it finds and wakes them:
their streams continue bitwise where the dead process stopped.
``--wake-deadline`` bounds every tier promotion (engine ``wake`` and server
``unpark``), so a stalled disk degrades to a counted failure instead of a
hang:

    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --cold-dir /tmp/cold
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --cold-dir /tmp/cold --recover
"""
from __future__ import annotations

import argparse
import threading

from repro_torch.configs import ARCHS, get_config
from repro_torch.core.engine import CortexEngine
from repro_torch.core.prism import Prism
from repro_torch.data.tokenizer import ByteTokenizer
from repro_torch.device import resolve_device
from repro_torch.memory import SynapseStore
from repro_torch.models import model as model_lib
from repro_torch.serving.frontend import ServingFrontend
from repro_torch.serving.sampler import SamplingParams
from repro_torch.serving.server import BatchServer

DEFAULT_REQUESTS = [
    "gold:0:Question: what makes this system scale? [TASK: verify memory math] Answer:",
    "free:0:Summarize the warp-cortex architecture in one line.",
]


def parse_tenants(spec: str) -> dict[str, float]:
    """"gold:4,free:1" -> {"gold": 4.0, "free": 1.0}."""
    out = {}
    for part in spec.split(","):
        name, _, w = part.strip().partition(":")
        out[name] = float(w) if w else 1.0
    return out


def parse_request(spec: str) -> tuple[str, int, str]:
    """"tenant:priority:prompt" -> (tenant, priority, prompt); the prompt may
    itself contain colons."""
    tenant, _, rest = spec.partition(":")
    prio, _, prompt = rest.partition(":")
    return tenant, int(prio or 0), prompt


def _serve_over_sockets(fe, args, lock):
    """--listen: the same requests, each a loopback HTTP client reading an
    SSE stream; the summary metrics come back over ``GET /v1/metrics``."""
    from repro_torch.serving.transport import SSEClient, TransportServer, http_json

    host, _, port = args.listen.partition(":")
    srv = TransportServer(fe, host or "127.0.0.1", int(port or 0))
    srv.start()
    print(f"listening on {srv.url} (POST /v1/generate, GET /v1/metrics, "
          f"POST /v1/cancel/<rid>)")

    def client(tenant, prio, prompt):
        c = SSEClient(srv.host, srv.port)
        try:
            status, _ = c.generate(prompt, tenant=tenant, priority=prio,
                                   max_new_tokens=args.max_new_tokens)
            if status != 200:
                with lock:
                    print(f"[{tenant}] HTTP {status}: {c.body_json()}")
                return
            rid, final = "?", {}
            for ev in c.events():
                if "rid" in ev:
                    rid = ev["rid"]
                elif "text" in ev and not args.no_stream:
                    with lock:
                        print(f"[{rid}/{tenant}] {ev['text']!r}")
                elif ev.get("done"):
                    final = ev
            with lock:
                print(f"[{rid}/{tenant}] <{final.get('status')}>")
        finally:
            c.close()

    clients = []
    for spec in args.request or DEFAULT_REQUESTS:
        tenant, prio, prompt = parse_request(spec)
        t = threading.Thread(target=client, args=(tenant, prio, prompt), daemon=True)
        t.start()
        clients.append(t)
    for t in clients:
        t.join()
    code, m = http_json(srv.host, srv.port, "GET", "/v1/metrics")
    ts = dict(srv.stats)
    srv.stop()
    print(f"transport: {ts['http_requests']} http requests, "
          f"{ts['streams_ok']}/{ts['streams_opened']} streams ok, "
          f"{ts['rejected_429']} rejected (429), "
          f"{ts['disconnects']} disconnects")
    if code != 200:
        raise RuntimeError(f"GET /v1/metrics answered {code}")
    return m


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-0.5b", choices=list(ARCHS))
    ap.add_argument("--mode", default="cortex", choices=["cortex", "batch"])
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--tenants", default="gold:4,free:1",
                    help="weighted-fair tenant spec, e.g. 'gold:4,free:1'")
    ap.add_argument("--request", action="append", default=None,
                    metavar="TENANT:PRIORITY:PROMPT",
                    help="a request to serve (repeatable); higher priority "
                         "admits sooner within the starvation bound")
    ap.add_argument("--max-new-tokens", type=int, default=32)
    ap.add_argument("--no-stream", action="store_true",
                    help="print only final texts instead of live chunks")
    ap.add_argument("--listen", default=None, metavar="HOST:PORT",
                    help="serve the requests over sockets: start the HTTP/SSE "
                         "transport there and drive each request through a "
                         "loopback client (port 0 = ephemeral)")
    ap.add_argument("--device", default=None,
                    help="torch device to serve on (default: the card; 'cpu' "
                         "to run on the CPU)")
    ap.add_argument("--wake-deadline", type=float, default=None, metavar="SECONDS",
                    help="bound every cold->device promotion: engine wake() "
                         "and server unpark() fail observably past this")
    ap.add_argument("--cold-dir", default=None,
                    help="directory for the cold (disk) tier; enables --recover")
    ap.add_argument("--recover", action="store_true",
                    help="rebuild the cold tier from --cold-dir and re-adopt "
                         "the hibernated agents found there before serving")
    args = ap.parse_args(argv)
    if args.recover and not args.cold_dir:
        ap.error("--recover requires --cold-dir")

    device = resolve_device(args.device)
    cfg = get_config(args.arch, reduced=args.reduced)
    params = model_lib.init_params(cfg, seed=0, device=device)
    tok = ByteTokenizer(cfg.vocab_size)
    store = SynapseStore(cold_dir=args.cold_dir) if args.cold_dir else None
    tenants = parse_tenants(args.tenants)

    engine = None
    if args.mode == "batch":
        backend = BatchServer(params, cfg, tok, n_lanes=4, capacity=512,
                              sampling=SamplingParams(temperature=0.9), store=store,
                              wake_deadline_s=args.wake_deadline, device=device)
    else:
        engine = CortexEngine(Prism(params, cfg, device=device), tok, n_main=2, max_side=4,
                              main_capacity=512, side_max_steps=12, theta=-1.0,
                              sampling=SamplingParams(temperature=1.0), store=store,
                              wake_deadline_s=args.wake_deadline, device=device)
        if args.recover:
            rec_report = engine.store.recover(args.cold_dir)
            adopted = engine.adopt_hibernated()
            print(f"recover: {len(rec_report['recovered'])} cold entries rebuilt "
                  f"({len(rec_report['orphans_adopted'])} orphan blobs), "
                  f"{len(rec_report['quarantined'])} quarantined, "
                  f"{len(rec_report['lost'])} lost; "
                  f"{len(adopted)} agents re-adopted: {adopted}")
            for aid in adopted:
                engine.wake(aid)
        backend = engine

    fe = ServingFrontend(backend, tenants=tenants, default_max_new_tokens=args.max_new_tokens)
    lock = threading.Lock()  # interleaved chunk prints stay line-atomic

    if args.listen is not None:
        m = _serve_over_sockets(fe, args, lock)
    else:
        def pump(rid, tenant, stream):
            for chunk in stream:
                with lock:
                    print(f"[{rid}/{tenant}] {chunk!r}")
            with lock:
                print(f"[{rid}/{tenant}] <{stream.status}>")

        printers = []
        for spec in args.request or DEFAULT_REQUESTS:
            tenant, prio, prompt = parse_request(spec)
            s = fe.submit(prompt, tenant=tenant, priority=prio)
            if not args.no_stream:
                t = threading.Thread(target=pump, args=(s.rid, tenant, s), daemon=True)
                t.start()
                printers.append(t)
        fe.serve()
        for t in printers:
            t.join(timeout=10)
        m = fe.metrics()
    if args.no_stream:
        for rid, req in sorted(fe.requests.items()):
            print(f"[{rid}/{req.tenant}] <{req.status}> {req.stream.text!r}")
    print(f"\nserving on {device}: {m['completed']} completed | "
          f"ttft p50 {m['ttft_s']['p50']*1e3:.1f}ms p99 {m['ttft_s']['p99']*1e3:.1f}ms | "
          f"tick p50 {m['tick_latency_s']['p50']*1e3:.2f}ms "
          f"p99 {m['tick_latency_s']['p99']*1e3:.2f}ms")
    for name, t in m["tenants"].items():
        print(f"tenant {name}: weight {t['weight']:g}, share {t['token_share']:.2f} "
              f"({t['tokens_out']} toks), admitted {t['admitted']}, "
              f"rejected {t['rejected']}, ttft p50 {t['ttft_p50_s']*1e3:.1f}ms")
    f = m["fairness"]
    print(f"fairness: {f['admission_rounds']} admission rounds, "
          f"{f['starvation_promotions']} starvation promotions "
          f"(bound {f['starvation_rounds']})")

    if engine is not None:
        rep = engine.memory_report()
        tiers, agents = rep["tiers"], rep["agents"]
        print(f"memory: weights {rep['weight_bytes']/1e6:.1f}MB shared across "
              f"{rep['n_agents']} agents; ctx/agent {rep['context_bytes_per_agent']/1e6:.2f}MB")
        print(f"tiers:  hot {tiers['hot_bytes']/1e6:.2f}MB (device) | "
              f"warm {tiers['warm_bytes']/1e6:.2f}MB (host, {tiers['n_warm']} agents) | "
              f"cold {tiers['cold_bytes']/1e6:.2f}MB (disk, {tiers['n_cold']} agents)")
        print(f"agents: {agents['registered']} registered, {agents['active']} active, "
              f"{agents['hibernated']} hibernated, {agents['lost']} lost")
        # resilience counters: all zeros on a healthy run; nonzero values are
        # the memory hierarchy degrading instead of crashing
        srep = engine.store.report()
        print(f"faults: {srep['stat_quarantined']} quarantined, "
              f"{srep['stat_wake_retries']} wake retries, "
              f"{srep['stat_recovered']} recovered, "
              f"{srep['stat_prefetch_errors']} prefetch errors, "
              f"{srep['stat_worker_respawns']} worker respawns; "
              f"engine: {engine.stats['wake_failures']} wake failures, "
              f"{engine.stats['lost_agents']} lost, "
              f"{engine.stats['recoveries']} recoveries")
    return m


if __name__ == "__main__":
    main()
