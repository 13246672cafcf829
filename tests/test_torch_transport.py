"""The port's HTTP/SSE transport over its serving front end, on loopback
sockets on the CPU (port of tests/test_transport.py), reduced Qwen2.5-0.5B
in f32 with random weights from a seed.

* PARITY — the concatenated ``text`` fields of a ``POST /v1/generate``
  SSE stream equal the in-process :class:`TokenStream` text, bitwise, on
  both port backends, multi-byte codepoints included;
* BACK-PRESSURE — a full queue answers 429 with ``Retry-After``; a client
  that stalls mid-stream gets only its own request cancelled;
* DISCONNECT — a client that closes mid-stream has only its request
  cancelled, observably; the survivor's stream is unchanged;
* CONTROL PLANE — ``/v1/metrics``, ``/healthz``, ``/v1/cancel/<rid>``,
  400 on malformed bodies, 404 on unknown paths; sampling parameters ride
  the wire.
"""
import dataclasses
import threading
import time

import pytest

from repro_torch.configs import get_config
from repro_torch.core.engine import CortexEngine
from repro_torch.core.prism import Prism
from repro_torch.data.tokenizer import ByteTokenizer
from repro_torch.models import model as model_lib
from repro_torch.serving.frontend import BackendFailed, ServingFrontend
from repro_torch.serving.sampler import SamplingParams
from repro_torch.serving.server import BatchServer
from repro_torch.serving.transport import (
    SSEClient,
    TransportServer,
    generate_sync,
    http_json,
)


@pytest.fixture(scope="module")
def setup():
    cfg = dataclasses.replace(get_config("qwen2.5-0.5b", reduced=True), compute_dtype="float32")
    return cfg, model_lib.init_params(cfg, seed=0, device="cpu")


def _batch_frontend(cfg, params, *, n_lanes=2, **kw):
    srv = BatchServer(params, cfg, ByteTokenizer(cfg.vocab_size), n_lanes=n_lanes, capacity=256,
                      sampling=SamplingParams(greedy=True), device="cpu")
    return ServingFrontend(srv, **kw)


def _wait(pred, timeout=90.0, step=0.05) -> bool:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(step)
    return False


# ---------------------------------------------------------------------------
# parity
# ---------------------------------------------------------------------------

def test_concurrent_clients_bitwise_parity_batch(setup):
    cfg, params = setup
    fe = _batch_frontend(cfg, params)
    with TransportServer(fe) as srv:
        results = [None] * 4

        def client(i):
            results[i] = generate_sync(
                srv.host, srv.port, f"wire prompt {i} é∑",
                tenant="gold" if i % 2 == 0 else "free", max_new_tokens=16,
            )

        threads = [threading.Thread(target=client, args=(i,)) for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)

        finished = {r.rid: r for r in fe.backend.finished}
        for i, out in enumerate(results):
            assert out["http_status"] == 200
            assert out["status"] == "ok" and out["error"] is None
            req = fe.requests[out["rid"]]
            # wire text == in-process stream text == one-shot decode, bitwise
            assert out["text"] == req.stream.text
            fin = finished[req.backend_id]
            assert out["text"] == fe.backend.tok.decode(
                fin.tokens[fin.prompt_len:]
            )
        assert srv.stats["streams_opened"] == 4
        assert srv.stats["streams_ok"] == 4
        assert srv.stats["disconnects"] == 0


def test_stream_parity_engine_backend(setup):
    cfg, params = setup
    tok = ByteTokenizer(cfg.vocab_size)
    eng = CortexEngine(
        Prism(params, cfg, device="cpu"), tok, n_main=2, max_side=2, main_capacity=128,
        inject_tokens=8, theta=-1.0, sampling=SamplingParams(greedy=True),
        sync_every=4, max_window=16, pipeline=True, device="cpu",
    )
    fe = ServingFrontend(eng, tenants={"t": 1.0})
    with TransportServer(fe) as srv:
        out = generate_sync(srv.host, srv.port, "engine wire prompt é∑",
                            tenant="t", max_new_tokens=10)
        assert out["http_status"] == 200 and out["status"] == "ok"
        req = fe.requests[out["rid"]]
        assert out["text"] == req.stream.text
        view = next(m for m in eng.mains if m.agent_id == req.backend_id)
        # wire text == final view text minus prompt == one-shot decode
        assert out["text"] == view.text[len(req.prompt):] \
            == tok.decode(view.tokens[view.prompt_len:])


def test_sse_event_shape(setup):
    cfg, params = setup
    fe = _batch_frontend(cfg, params)
    with TransportServer(fe) as srv:
        out = generate_sync(srv.host, srv.port, "shape check",
                            max_new_tokens=8)
        evs = out["events"]
        assert evs[0] == {"rid": out["rid"]}
        assert evs[-1]["done"] is True and evs[-1]["status"] == "ok"
        for ev in evs[1:-1]:
            assert set(ev) == {"text"}
        assert out["headers"]["x-request-id"] == str(out["rid"])
        assert out["headers"]["content-type"].startswith("text/event-stream")


# ---------------------------------------------------------------------------
# back-pressure: 429 on a full queue
# ---------------------------------------------------------------------------

def test_full_queue_answers_429_with_retry_after(setup):
    cfg, params = setup
    fe = _batch_frontend(cfg, params, n_lanes=1, max_queue=1)
    with TransportServer(fe, retry_after_s=2.5) as srv:
        # A occupies the single lane (first text event proves admission) ...
        a = SSEClient(srv.host, srv.port)
        a.generate("occupy the lane", max_new_tokens=512)
        a_events = a.events()
        a_rid = next(a_events)["rid"]
        assert "text" in next(a_events)
        # ... B fills the one-deep admission queue (rid event is immediate,
        # admission is not — A holds the lane) ...
        b = SSEClient(srv.host, srv.port)
        b.generate("wait in queue", max_new_tokens=512)
        b_rid = next(b.events())["rid"]
        assert _wait(lambda: len(fe.fq) == 1, timeout=10)
        # ... so C is rejected on the wire with explicit retry advice
        out = generate_sync(srv.host, srv.port, "one too many",
                            max_new_tokens=8)
        assert out["http_status"] == 429
        assert out["headers"]["retry-after"] == "2.5"
        assert "admission queue full" in out["body"]["error"]
        assert srv.stats["rejected_429"] == 1
        assert fe.metrics()["tenants"]["default"]["rejected"] == 1

        # cancel A (running: deferred to a boundary) and B (queued:
        # immediate) over the wire; both streams end observably
        code, body = http_json(srv.host, srv.port, "POST",
                               f"/v1/cancel/{b_rid}")
        assert code == 200 and body["cancelled"] is True
        code, _ = http_json(srv.host, srv.port, "POST", f"/v1/cancel/{a_rid}")
        assert code == 200
        for client, events in ((a, a_events), (b, b.events())):
            last = None
            for ev in events:
                last = ev
            assert last["done"] is True and last["status"] == "cancelled"
            client.close()
        assert _wait(lambda: fe.pending() == 0, timeout=30)
        code, body = http_json(srv.host, srv.port, "POST", "/v1/cancel/999")
        assert code == 404 and body["cancelled"] is False


# ---------------------------------------------------------------------------
# disconnect and stalled clients
# ---------------------------------------------------------------------------

def test_midstream_disconnect_cancels_only_that_request(setup):
    cfg, params = setup
    fe = _batch_frontend(cfg, params)
    with TransportServer(fe, poll_s=0.02, pump_ticks=16) as srv:
        # reference run first, alone, on the SAME transport: greedy decoding
        # is lane-composition invariant, so this is the bitwise yardstick
        ref = generate_sync(srv.host, srv.port, "survivor prompt é∑",
                            max_new_tokens=24)
        assert ref["status"] == "ok"

        # victim stream opens, reads its rid, then vanishes mid-generation
        victim = SSEClient(srv.host, srv.port)
        victim.generate("doomed client", max_new_tokens=4096)
        v_rid = next(victim.events())["rid"]
        assert _wait(lambda: fe.requests[v_rid].status == "running",
                     timeout=30)
        victim.close()  # abrupt: no FIN handshake beyond the TCP close

        # the survivor runs while the disconnect is being detected/applied
        out = generate_sync(srv.host, srv.port, "survivor prompt é∑",
                            max_new_tokens=24)
        assert out["status"] == "ok"
        assert out["text"] == ref["text"]  # neighbor's death changed nothing

        assert _wait(lambda: fe.requests[v_rid].status == "cancelled",
                     timeout=60)
        vreq = fe.requests[v_rid]
        fin = {r.rid: r for r in fe.backend.finished}[vreq.backend_id]
        assert fin.status == "cancelled"  # observable in finished/stats
        assert fe.backend.stats["cancelled"] == 1
        assert _wait(lambda: srv.stats["disconnects"] >= 1, timeout=10)
        assert _wait(lambda: fe.pending() == 0, timeout=30)


def test_stalled_client_cancelled_others_fine(setup):
    cfg, params = setup
    fe = _batch_frontend(cfg, params)
    # tiny kernel buffers + short write timeout + bounded stream backlog:
    # a reader that never drains trips back-pressure within a few hundred
    # tokens instead of a few MB
    with TransportServer(fe, sndbuf=4096, write_timeout_s=0.5,
                         max_buffered_chars=256, poll_s=0.02,
                         pump_ticks=16) as srv:
        stalled = SSEClient(srv.host, srv.port, rcvbuf=2048)
        stalled.generate("stalled reader", max_new_tokens=4096)
        # read NOTHING further: the socket fills, the handler's writes
        # time out (or the unread stream backlog overflows), and only
        # this request dies
        assert _wait(lambda: any(r.prompt == "stalled reader"
                                 for r in fe.requests.values()), timeout=30)
        s_rid = next(r.rid for r in fe.requests.values()
                     if r.prompt == "stalled reader")

        healthy = generate_sync(srv.host, srv.port, "healthy reader",
                                max_new_tokens=16)
        assert healthy["status"] == "ok"
        hreq = fe.requests[healthy["rid"]]
        assert healthy["text"] == hreq.stream.text  # parity, undisturbed

        assert _wait(lambda: fe.requests[s_rid].status == "cancelled",
                     timeout=90)
        assert _wait(lambda: fe.pending() == 0, timeout=30)
        # at least one back-pressure mechanism observably fired
        assert (srv.stats["stalled_writes"] >= 1
                or srv.stats["disconnects"] >= 1
                or fe.requests[s_rid].stream.overflowed)
        stalled.close()


# ---------------------------------------------------------------------------
# control plane
# ---------------------------------------------------------------------------

def test_metrics_healthz_and_errors(setup):
    cfg, params = setup
    fe = _batch_frontend(cfg, params, tenants={"gold": 4.0})
    with TransportServer(fe) as srv:
        out = generate_sync(srv.host, srv.port, "metrics seed",
                            tenant="gold", max_new_tokens=8)
        assert out["status"] == "ok"

        code, m = http_json(srv.host, srv.port, "GET", "/v1/metrics")
        assert code == 200
        assert m["backend"] == "batch" and m["completed"] == 1
        assert m["tenants"]["gold"]["tokens_out"] == 8
        assert {"requests", "fairness", "ttft_s", "tick_latency_s"} <= set(m)

        code, h = http_json(srv.host, srv.port, "GET", "/healthz")
        assert code == 200 and h["ok"] is True and h["pending"] == 0

        code, body = http_json(srv.host, srv.port, "POST", "/v1/generate",
                               {"tenant": "gold"})  # no prompt
        assert code == 400 and "bad request" in body["error"]
        code, body = http_json(srv.host, srv.port, "POST", "/v1/generate",
                               {"prompt": "x", "sampling": {"beam": 4}})
        assert code == 400 and "beam" in body["error"]
        code, _ = http_json(srv.host, srv.port, "GET", "/v1/nope")
        assert code == 404
        code, _ = http_json(srv.host, srv.port, "POST", "/v1/cancel/abc")
        assert code == 400


class _PlantedFault(RuntimeError):
    pass


@pytest.mark.parametrize("mode", ["cortex", "batch"])
def test_backend_failure_ends_every_request_and_stops_the_pump(setup, mode):
    """A backend step that raises (as a kernel that refuses its input
    would) is never retried: the queued and the running requests all end
    with status "error", later requests answer 503, and stopping the
    transport raises with the fault as its cause."""
    cfg, params = setup
    calls = []

    def boom(*a, **k):
        calls.append(a)
        raise _PlantedFault("planted kernel failure")

    if mode == "batch":
        fe = _batch_frontend(cfg, params, tenants={"t": 1.0})
        fe.backend._step = boom
    else:
        eng = CortexEngine(
            Prism(params, cfg, device="cpu"), ByteTokenizer(cfg.vocab_size), n_main=2, max_side=2,
            main_capacity=128, inject_tokens=8, sampling=SamplingParams(greedy=True),
            sync_every=4, max_window=16, device="cpu",
        )
        fe = ServingFrontend(eng, tenants={"t": 1.0})
        eng._dispatch_window = boom
    # three requests for two lanes: two are running and one is queued when
    # the first step fails
    streams = [fe.submit(f"request {i}", tenant="t", max_new_tokens=8) for i in range(3)]
    srv = TransportServer(fe)
    with pytest.raises(RuntimeError, match="pump stopped") as info:
        with srv:
            assert _wait(lambda: all(s.done for s in streams))
            assert [s.status for s in streams] == ["error"] * 3
            assert all("planted kernel failure" in s.error for s in streams)
            assert sorted(r.status for r in fe.requests.values()) == ["error"] * 3
            assert srv.stats["pump_errors"] == 1 and len(calls) == 1
            out = generate_sync(srv.host, srv.port, "after the fault", tenant="t")
            assert out["http_status"] == 503 and "planted" in out["body"]["error"]
            code, h = http_json(srv.host, srv.port, "GET", "/healthz")
            assert code == 503 and h["ok"] is False
    assert isinstance(info.value.__cause__, _PlantedFault)
    with pytest.raises(BackendFailed):
        fe.step(4)
    with pytest.raises(BackendFailed):
        fe.submit("in process", tenant="t")
    assert len(calls) == 1


def test_sampling_params_ride_the_wire(setup):
    cfg, params = setup
    fe = _batch_frontend(cfg, params)
    with TransportServer(fe) as srv:
        out = generate_sync(srv.host, srv.port, "sampled over http",
                            max_new_tokens=8,
                            sampling={"greedy": True})
        assert out["status"] == "ok"
        req = fe.requests[out["rid"]]
        assert req.sampling is not None and req.sampling.greedy is True


@pytest.mark.parametrize("mode", ["cortex", "batch"])
def test_launcher_serves_over_sockets_on_the_cpu(mode, capsys):
    """``python -m repro_torch.launch.serve --device cpu --listen
    127.0.0.1:0`` in both modes: every request through a loopback SSE
    client, the summary metrics fetched over ``GET /v1/metrics``."""
    from repro_torch.launch import serve

    m = serve.main(["--device", "cpu", "--mode", mode, "--listen", "127.0.0.1:0",
                    "--max-new-tokens", "6", "--no-stream"])
    assert m["completed"] == 2 and m["backend"] == ("engine" if mode == "cortex" else "batch")
    out = capsys.readouterr().out
    assert "2/2 streams ok" in out and "serving on cpu: 2 completed" in out
