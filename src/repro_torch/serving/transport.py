"""Socket transport for the serving front end: HTTP/1.1 + SSE.

Port of the JAX package's ``repro.serving.transport`` (standard library
only, over the port's :class:`~repro_torch.serving.frontend.ServingFrontend`):

* ``POST /v1/generate`` — JSON body (``prompt``, ``tenant``,
  ``priority``, ``max_new_tokens``, ``sampling``) answered with an SSE
  stream. Every event is one ``data: <json>`` line: first
  ``{"rid": N}``, then ``{"text": ...}`` chunks whose concatenated
  ``text`` fields are **bitwise equal** to the in-process
  :class:`TokenStream` text (chunks are JSON-escaped, so multi-byte
  codepoints and control bytes survive the wire exactly), finally
  ``{"done": true, "status": ..., "error": ...}``.
* ``GET /v1/metrics`` — the front end's :meth:`metrics` as JSON;
  ``GET /healthz``.
* ``POST /v1/cancel/<rid>`` — maps to :meth:`ServingFrontend.cancel`.

Robustness contract:

* a full :class:`FairQueue` (``AdmissionError``) maps to **HTTP 429**
  with a ``Retry-After`` header;
* **slow or stalled clients** cost only themselves: each connection has
  its own handler thread, socket writes carry a timeout, and the request's
  stream has a bounded unread backlog (``max_buffered_chars``). When either
  trips, the request is flagged for a boundary cancel and the connection
  closes;
* a **client disconnect mid-stream** (a write failure, or a zero-byte
  read polled between chunk waits) becomes an observable cancel.

ONE pump thread drives the backend, looping :meth:`ServingFrontend.step`
in bounded chunks; every device operation runs on it, on its current CUDA
stream. Handler threads touch only the front end's queue and stream
handles, never the backend's tensors: their cancels are deferred to the
pump's next admission boundary.

A minimal standard-library client (:class:`SSEClient`,
:func:`generate_sync`, :func:`http_json`) lives here too.
"""
from __future__ import annotations

import json
import select
import socket
import sys
import threading
import traceback
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from repro_torch.serving.frontend import AdmissionError, BackendFailed, ServingFrontend
from repro_torch.serving.sampler import SamplingParams

_SAMPLING_KEYS = ("temperature", "top_k", "top_p", "greedy")


def _parse_sampling(obj) -> SamplingParams | None:
    if not obj:
        return None
    bad = set(obj) - set(_SAMPLING_KEYS)
    if bad:
        raise ValueError(f"unknown sampling keys: {sorted(bad)}")
    return SamplingParams(**obj)


class TransportServer:
    """Threaded HTTP/SSE front door over a :class:`ServingFrontend`.

        fe = ServingFrontend(backend, tenants={"gold": 4.0, "free": 1.0})
        with TransportServer(fe, port=0) as srv:   # port=0 -> ephemeral
            print(srv.url)                          # http://127.0.0.1:PORT
            ...

    ``start()`` launches two daemon threads: the socket accept loop
    (``ThreadingHTTPServer`` — one handler thread per connection) and the
    pump, which drives the backend in ``pump_ticks`` chunks whenever
    requests are pending. ``write_timeout_s`` bounds every socket write;
    ``max_buffered_chars`` bounds every stream's unread backlog — a
    client stalled past either gets its request cancelled at the next
    boundary. ``sndbuf`` shrinks the kernel send buffer per connection
    (tests use it to trip back-pressure quickly).
    """

    def __init__(self, frontend: ServingFrontend, host: str = "127.0.0.1",
                 port: int = 0, *, pump_ticks: int = 32, pipeline: bool = True,
                 poll_s: float = 0.05, write_timeout_s: float = 10.0,
                 max_buffered_chars: int = 1 << 20, retry_after_s: float = 1.0,
                 sndbuf: int | None = None):
        self.fe = frontend
        self.pump_ticks = pump_ticks
        self.pipeline = pipeline
        self.poll_s = poll_s
        self.write_timeout_s = write_timeout_s
        self.max_buffered_chars = max_buffered_chars
        self.retry_after_s = retry_after_s
        self.sndbuf = sndbuf
        self.stats = {"http_requests": 0, "streams_opened": 0, "streams_ok": 0,
                      "rejected_429": 0, "disconnects": 0, "stalled_writes": 0,
                      "cancels": 0, "pump_errors": 0}
        self._stats_lock = threading.Lock()
        # the exception that stopped the pump (see _pump_loop)
        self.error: BaseException | None = None
        self._stop = threading.Event()
        self._work = threading.Event()
        self._pump: threading.Thread | None = None
        self._serve: threading.Thread | None = None

        transport = self

        class Handler(_Handler):
            server_transport = transport

        class Server(ThreadingHTTPServer):
            daemon_threads = True

            def server_bind(inner):
                if sndbuf is not None:
                    # accepted sockets inherit the listener's buffer size,
                    # so a tiny SNDBUF here makes a stalled client exert
                    # TCP back-pressure after a few KB instead of a few MB
                    inner.socket.setsockopt(
                        socket.SOL_SOCKET, socket.SO_SNDBUF, sndbuf
                    )
                super().server_bind()

        self.httpd = Server((host, port), Handler)
        self.host, self.port = self.httpd.server_address[:2]

    # ------------------------------------------------------------------
    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def _bump(self, key: str, n: int = 1) -> None:
        with self._stats_lock:
            self.stats[key] += n

    def start(self) -> "TransportServer":
        self._serve = threading.Thread(
            target=self.httpd.serve_forever, name="transport-accept", daemon=True
        )
        self._pump = threading.Thread(
            target=self._pump_loop, name="transport-pump", daemon=True
        )
        self._serve.start()
        self._pump.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        self._work.set()
        self.httpd.shutdown()
        self.httpd.server_close()
        if self._pump is not None:
            self._pump.join(timeout=30)
        if self.error is not None:
            raise RuntimeError("the transport's pump stopped: the backend raised") from self.error

    def __enter__(self) -> "TransportServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # ------------------------------------------------------------------
    def _pump_loop(self) -> None:
        """The ONLY thread that drives the backend. Bounded chunks so
        deferred cancels (disconnects, stalled writers) land at admission
        boundaries with latency capped at one chunk; it never writes to a
        socket, so no client can stall it.

        A step that raises ends the pump: the front end has already ended
        every request with status "error" (:meth:`ServingFrontend.fail`),
        the traceback goes to stderr, later generates answer 503, and
        :meth:`stop` raises with the error as its cause."""
        while not self._stop.is_set():
            if self.fe.pending():
                try:
                    self.fe.step(self.pump_ticks, pipeline=self.pipeline)
                except BaseException as e:
                    self.error = e
                    self._bump("pump_errors")
                    traceback.print_exc(file=sys.stderr)
                    return
            else:
                self._work.wait(self.poll_s)
                self._work.clear()

    def kick(self) -> None:
        """Wake the pump (a request was just submitted)."""
        self._work.set()


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    server_transport: TransportServer = None  # bound by TransportServer

    # -- plumbing -------------------------------------------------------
    def log_message(self, *args) -> None:  # tests drive hundreds of requests
        pass

    def _json(self, code: int, obj, extra_headers: dict | None = None) -> None:
        body = json.dumps(obj, ensure_ascii=True, default=str).encode("ascii")
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        for k, v in (extra_headers or {}).items():
            self.send_header(k, v)
        self.send_header("Connection", "close")
        self.close_connection = True
        self.end_headers()
        self.wfile.write(body)

    def _body(self) -> dict:
        n = int(self.headers.get("Content-Length") or 0)
        raw = self.rfile.read(n) if n else b""
        if not raw:
            return {}
        return json.loads(raw.decode("utf-8"))

    # -- routes ---------------------------------------------------------
    def do_GET(self) -> None:
        t = self.server_transport
        t._bump("http_requests")
        if self.path == "/v1/metrics":
            self._json(200, t.fe.metrics())
        elif self.path == "/healthz":
            ok = t.error is None
            self._json(200 if ok else 503, {"ok": ok, "pending": t.fe.pending()})
        else:
            self._json(404, {"error": f"no such endpoint: {self.path}"})

    def do_POST(self) -> None:
        t = self.server_transport
        t._bump("http_requests")
        if self.path == "/v1/generate":
            self._generate(t)
        elif self.path.startswith("/v1/cancel/"):
            try:
                rid = int(self.path.rsplit("/", 1)[1])
            except ValueError:
                self._json(400, {"error": "rid must be an integer"})
                return
            ok = t.fe.cancel(rid)
            if ok:
                t._bump("cancels")
            self._json(200 if ok else 404, {"rid": rid, "cancelled": ok})
        else:
            self._json(404, {"error": f"no such endpoint: {self.path}"})

    # -- the SSE stream -------------------------------------------------
    def _generate(self, t: TransportServer) -> None:
        try:
            body = self._body()
            prompt = body["prompt"]
            sampling = _parse_sampling(body.get("sampling"))
        except (KeyError, ValueError, json.JSONDecodeError) as e:
            self._json(400, {"error": f"bad request: {e!r}"})
            return
        try:
            stream = t.fe.submit(
                prompt,
                tenant=body.get("tenant", "default"),
                priority=int(body.get("priority", 0)),
                max_new_tokens=body.get("max_new_tokens"),
                sampling=sampling,
                max_buffered_chars=t.max_buffered_chars,
            )
        except AdmissionError as e:
            # explicit wire back-pressure: the queue is full, retry later
            t._bump("rejected_429")
            self._json(429, {"error": str(e)},
                       {"Retry-After": f"{t.retry_after_s:g}"})
            return
        except BackendFailed as e:
            self._json(503, {"error": str(e)})
            return
        t.kick()
        t._bump("streams_opened")

        self.send_response(200)
        self.send_header("Content-Type", "text/event-stream; charset=utf-8")
        self.send_header("Cache-Control", "no-cache")
        self.send_header("X-Request-Id", str(stream.rid))
        self.send_header("Connection", "close")
        self.close_connection = True
        self.end_headers()
        if t.sndbuf is not None:
            self.connection.setsockopt(socket.SOL_SOCKET, socket.SO_SNDBUF,
                                       t.sndbuf)
        self.connection.settimeout(t.write_timeout_s)

        if not self._emit({"rid": stream.rid}, t, stream):
            return
        while True:
            chunk = stream.next_chunk(timeout=t.poll_s)
            if chunk is None:
                break  # closed and fully drained
            if chunk == "":
                # idle poll: the cheap moment to notice a vanished client,
                # BEFORE more tokens are generated for it
                if self._client_gone():
                    t._bump("disconnects")
                    self._cancel(t, stream)
                    return
                continue
            if not self._emit({"text": chunk}, t, stream):
                return
        self._emit({"done": True, "status": stream.status,
                    "error": stream.error}, t, stream)
        t._bump("streams_ok")

    def _emit(self, obj, t: TransportServer, stream) -> bool:
        """Write one SSE event; on a stalled (timeout) or dead socket,
        cancel ONLY this request and close. Returns False when the
        connection is over."""
        data = b"data: " + json.dumps(obj, ensure_ascii=True).encode("ascii") \
            + b"\n\n"
        try:
            self.wfile.write(data)
            self.wfile.flush()
            return True
        except (TimeoutError, socket.timeout):
            t._bump("stalled_writes")
        except OSError:
            t._bump("disconnects")
        self._cancel(t, stream)
        return False

    def _cancel(self, t: TransportServer, stream) -> None:
        """Route a dead/stalled connection through the observable-cancel
        path (deferred: applied at the pump's next admission boundary)."""
        if t.fe.cancel(stream.rid):
            t._bump("cancels")
        self.close_connection = True

    def _client_gone(self) -> bool:
        """True when the peer closed its end: the socket polls readable
        and a peek reads zero bytes. Stray pipelined bytes are ignored
        (peeked, not consumed)."""
        try:
            r, _, _ = select.select([self.connection], [], [], 0)
            if not r:
                return False
            return self.connection.recv(1, socket.MSG_PEEK) == b""
        except OSError:
            return True


# ---------------------------------------------------------------------------
# minimal stdlib client — tests, benchmarks, and protocol documentation
# ---------------------------------------------------------------------------

class SSEClient:
    """Blocking HTTP/SSE client over one raw socket.

        c = SSEClient(host, port)
        status, headers = c.generate("prompt", tenant="gold")
        for ev in c.events():      # dicts: {"rid"}, {"text"}, {"done", ...}
            ...
        c.close()

    Raw socket on purpose: tests need to close mid-stream to simulate an
    abrupt client disconnect, and to shrink ``rcvbuf`` so a stalled reader
    exerts real TCP back-pressure.
    """

    def __init__(self, host: str, port: int, *, timeout: float = 120.0,
                 rcvbuf: int | None = None):
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        if rcvbuf is not None:
            self.sock.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, rcvbuf)
        self.sock.settimeout(timeout)
        self.sock.connect((host, port))
        self._fp = self.sock.makefile("rb")
        self.status: int | None = None
        self.headers: dict[str, str] = {}

    def post(self, path: str, payload: dict) -> tuple[int, dict[str, str]]:
        body = json.dumps(payload).encode("utf-8")
        head = (f"POST {path} HTTP/1.1\r\nHost: x\r\n"
                f"Content-Type: application/json\r\n"
                f"Content-Length: {len(body)}\r\n\r\n").encode("ascii")
        self.sock.sendall(head + body)
        status_line = self._fp.readline().decode("ascii", "replace")
        self.status = int(status_line.split(" ", 2)[1])
        self.headers = {}
        while True:
            line = self._fp.readline().decode("ascii", "replace").rstrip("\r\n")
            if not line:
                break
            k, _, v = line.partition(":")
            self.headers[k.strip().lower()] = v.strip()
        return self.status, self.headers

    def generate(self, prompt: str, *, tenant: str = "default",
                 priority: int = 0, max_new_tokens: int | None = None,
                 sampling: dict | None = None) -> tuple[int, dict[str, str]]:
        payload = {"prompt": prompt, "tenant": tenant, "priority": priority}
        if max_new_tokens is not None:
            payload["max_new_tokens"] = max_new_tokens
        if sampling is not None:
            payload["sampling"] = sampling
        return self.post("/v1/generate", payload)

    def events(self):
        """Yield decoded SSE events until the server closes the stream."""
        datas: list[str] = []
        while True:
            raw = self._fp.readline()
            if not raw:
                return  # EOF
            line = raw.decode("utf-8").rstrip("\r\n")
            if not line:
                if datas:
                    yield json.loads("\n".join(datas))
                    datas = []
                continue
            if line.startswith("data:"):
                datas.append(line[5:].lstrip(" "))

    def body_json(self) -> dict:
        """Read a Content-Length JSON body (non-SSE responses: 429s,
        metrics, cancels)."""
        n = int(self.headers.get("content-length") or 0)
        return json.loads(self._fp.read(n).decode("utf-8")) if n else {}

    def close(self) -> None:
        """Abrupt close — mid-stream this is the client-disconnect the
        server must detect and turn into a cancel."""
        try:
            self._fp.close()
        except OSError:
            pass
        try:
            self.sock.close()
        except OSError:
            pass


def generate_sync(host: str, port: int, prompt: str, **kw) -> dict:
    """One blocking request: returns ``{"http_status", "headers", "rid",
    "text", "status", "error", "events"}`` where ``text`` is the
    concatenation of every event's ``text`` field — the bytes the parity
    tests compare against the in-process handle."""
    c = SSEClient(host, port)
    try:
        status, headers = c.generate(prompt, **kw)
        out = {"http_status": status, "headers": headers, "rid": None,
               "text": "", "status": None, "error": None, "events": []}
        if status != 200:
            out["body"] = c.body_json()
            return out
        for ev in c.events():
            out["events"].append(ev)
            if "rid" in ev:
                out["rid"] = ev["rid"]
            if "text" in ev:
                out["text"] += ev["text"]
            if ev.get("done"):
                out["status"], out["error"] = ev.get("status"), ev.get("error")
        return out
    finally:
        c.close()


def http_json(host: str, port: int, method: str, path: str,
              payload: dict | None = None) -> tuple[int, dict]:
    """Plain JSON request helper (metrics, cancel, healthz)."""
    import http.client

    conn = http.client.HTTPConnection(host, port, timeout=60)
    try:
        body = json.dumps(payload).encode("utf-8") if payload is not None else None
        conn.request(method, path, body=body,
                     headers={"Content-Type": "application/json"} if body else {})
        resp = conn.getresponse()
        data = resp.read()
        return resp.status, (json.loads(data) if data else {})
    finally:
        conn.close()
