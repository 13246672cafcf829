"""CUDA graphs of the engine's tick, broken at the ``synapse_attention`` launch.

A tick of the engine (:func:`repro_torch.core.engine.one_tick`) issues
thousands of small kernels (6,585 on Qwen2.5-0.5B with a full side batch);
on the card the host's issue of them, not the device, sets the tick's
time. :class:`TickGraphs` captures one tick into a sequence of CUDA graphs
that share one memory pool, and replays them on later ticks, in capture
order, on the current stream:

* the river's decode;
* per side layer, the work up to its ``synapse_attention`` call, then the
  work after it up to the next call; sampling and the ring commit ride the
  last piece.

The hand-written kernel stays out of the graphs: between two pieces its
wrapper, ``ops.synapse_attention``, launches it eagerly on static buffers
that the piece before fills and the piece after reads (one set for every
call of one shape: the pieces run in turn). Each launch is counted, and
seen by whatever wraps the wrapper, as on an eager tick.

A capture runs its tick once for real: each piece is replayed as soon as it
is captured and the kernel runs on what it wrote, so the capturing tick
advances the state as an eager tick does. A key of graphs
(``(step_sides, use_filters, any_greedy)``) is captured on its second
tick; its first runs eagerly and warms what a capture must not do for the
first time (the kernels' build, lazily cached device constants).

What the graphs read stays at one address: the tick state, the caches, the
parameters, the static buffers, and the ring cursor, a device scalar set
before each replay. The tick's generators are registered with every graph,
so the random stream is the eager one's. :meth:`TickGraphs.check` compares
a fingerprint of those addresses at each window and drops every graph
where one was rebound: the next tick of each key captures anew.
"""
from __future__ import annotations

import contextlib
import dataclasses

import torch

from repro_torch.core import synapse_sharded as sharded
from repro_torch.kernels import ops

# (block kind, mlp) of the layer groups whose decode a test on the card
# captured and replayed bitwise against the eager tick
# (tests/test_torch_cuda.py); other families tick eagerly
CAPTURED_LAYERS = frozenset({("attn", "dense")})


def engages(cfg, device, mesh) -> bool:
    """Whether an engine ticks from graphs: on a CUDA device, with no lane
    group, and only layer kinds in :data:`CAPTURED_LAYERS` (grouped-query
    attention, no shared block)."""
    return (torch.device(device).type == "cuda" and mesh is None and cfg.attn_kind == "gqa"
            and cfg.shared_attn_every == 0 and all((g.kind, g.mlp) in CAPTURED_LAYERS for g in cfg.layer_groups()))


def fingerprint(st, params) -> tuple:
    """The addresses and shapes a captured tick reads and writes: every
    tensor of the tick state ``st`` (its caches and per-lane sampling
    tensors) and of ``params``, and which generators it draws from."""
    out = []

    def add(v):
        if isinstance(v, torch.Tensor):
            out.append((v.data_ptr(), tuple(v.shape)))
        elif dataclasses.is_dataclass(v) and not isinstance(v, type):
            for f in dataclasses.fields(v):
                add(getattr(v, f.name))
        elif isinstance(v, (list, tuple)):
            for x in v:
                add(x)
        elif isinstance(v, dict):
            for x in v.values():
                add(x)
        elif v is not None and not isinstance(v, (int, float, str, bool)):
            out.append(id(v))

    add(st)
    add(params)
    return tuple(out)


@dataclasses.dataclass
class AttendBuffers:
    """Static inputs and outputs of the kernel calls of one shape."""

    q: torch.Tensor       # [B, H, D]
    keys: torch.Tensor    # [B, T, Hkv, D] — [landmarks; window; inject]
    values: torch.Tensor
    valid: torch.Tensor   # [B, T] bool
    out: torch.Tensor     # [B, H, D]
    mass: torch.Tensor    # [B, T] f32

    @classmethod
    def like(cls, q, pieces) -> "AttendBuffers":
        k0, v0 = pieces[0]
        T = sum(k.shape[1] for k, _ in pieces)
        B = q.shape[0]
        return cls(
            q=torch.empty_like(q),
            keys=torch.empty((B, T, *k0.shape[2:]), dtype=k0.dtype, device=q.device),
            values=torch.empty((B, T, *v0.shape[2:]), dtype=v0.dtype, device=q.device),
            valid=torch.empty((B, T), dtype=torch.bool, device=q.device),
            out=torch.empty_like(q),
            mass=torch.empty((B, T), dtype=torch.float32, device=q.device),
        )

    def fill(self, q, pieces, valids):
        """The concatenation ``piece_attend`` makes, into the buffers."""
        self.q.copy_(q)
        sharded.cat_pieces(pieces, valids, out=(self.keys, self.values, self.valid))

    def launch(self, scale: float):
        """The kernel through its wrapper, looked up at each call (so that a
        wrapper installed around it sees the call), (q, keys, values, valid)
        positional."""
        return ops.synapse_attention(self.q, self.keys, self.values, self.valid, scale=scale,
                                     out=self.out, mass=self.mass)


class CudaGraphs:
    """The capture backend on the card: a ``torch.cuda.CUDAGraph`` per
    piece, every one in one memory pool, captured on a side stream (the
    default stream cannot be captured) and replayed on the current one."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.stream = torch.cuda.Stream(self.device)
        self.pool = torch.cuda.graph_pool_handle()

    @contextlib.contextmanager
    def scope(self):
        """A capture: work issued inside runs on the capture stream, ordered
        after what the current stream holds and before what it is given
        next.

        cuBLAS keeps a workspace (32 MiB on the H100) per stream it runs a
        product on, allocated at the stream's first product and held for
        the process: the capture stream's would stay allocated beside the
        current stream's. So the workspaces are dropped before a capture,
        which makes the capture stream's come from the graphs' pool and
        frees the current stream's until its next product, and again after
        it, which hands the capture stream's back to the pool. The graphs'
        products keep that memory as their scratch; whatever a later
        capture places there is dead between ticks, as everything in the
        pool but the static buffers is, and those are refilled within the
        tick that reads them."""
        torch._C._cuda_clearCublasWorkspaces()
        cur = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(cur)
        try:
            with torch.cuda.stream(self.stream):
                yield
        finally:
            cur.wait_stream(self.stream)
            torch._C._cuda_clearCublasWorkspaces()

    def begin(self, generators):
        g = torch.cuda.CUDAGraph()
        for gen in generators:
            g.register_generator_state(gen)
        # thread_local: the memory tiers' worker thread may copy to the
        # card meanwhile
        g.capture_begin(pool=self.pool, capture_error_mode="thread_local")
        return g

    def end(self, g):
        g.capture_end()

    def replay(self, g):
        g.replay()


class _Capture:
    """A tick being captured: opens a piece, cuts it at the river's end and
    at each kernel call (``attend``, the ``synapse_sharded.attend_break`` hook).
    ``steps``: each piece's graph and the kernel call that follows it,
    (AttendBuffers, scale), or None (after the river's piece and the last)."""

    def __init__(self, backend, generators, buffers: dict):
        self.backend, self.generators, self.buffers = backend, generators, buffers
        self.steps = []
        self.open = None

    def begin(self):
        self.open = self.backend.begin(self.generators)

    def end(self):
        """Close the open piece and run it (the capturing tick is a real one)."""
        g, self.open = self.open, None
        self.backend.end(g)
        self.backend.replay(g)
        self.steps.append((g, None))

    def cut(self):
        self.end()
        self.begin()

    def attend(self, q, pieces, valids, scale):
        key = (tuple(q.shape), q.dtype, tuple(tuple(k.shape) for k, _ in pieces))
        bufs = self.buffers.get(key)
        if bufs is None:
            bufs = self.buffers[key] = AttendBuffers.like(q, pieces)
        bufs.fill(q, pieces, valids)
        self.end()
        out, mass = bufs.launch(scale)
        self.steps[-1] = (self.steps[-1][0], (bufs, scale))
        self.begin()
        return out, list(torch.split(mass, [k.shape[1] for k, _ in pieces], dim=1))

    def abort(self):
        """End a capture left open by an error, so the stream is usable."""
        if self.open is not None:
            g, self.open = self.open, None
            with contextlib.suppress(RuntimeError):
                self.backend.end(g)


class TickGraphs:
    """An engine's captured ticks, one entry per key, and the device
    cursor their ring appends read. ``make_backend(device)`` makes the
    capture backend at the first capture and after each drop
    (:class:`CudaGraphs`: a fresh stream and pool); tests substitute a
    recorder."""

    def __init__(self, device, *, make_backend=CudaGraphs):
        self.device = torch.device(device)
        self.cursor = torch.zeros(1, dtype=torch.int64, device=self.device)
        self._make_backend = make_backend
        self._backend = None
        self._graphs: dict[tuple, list] = {}
        self._buffers: dict[tuple, AttendBuffers] = {}
        self._warm: set[tuple] = set()
        self._fingerprint = None

    def check(self, fp: tuple) -> None:
        """Drop every graph (and the pool and buffers they share) where the
        addresses ``fp`` differ from those they were captured over."""
        if fp != self._fingerprint:
            self._fingerprint = fp
            if self._graphs:
                self._graphs, self._buffers, self._backend = {}, {}, None

    def tick(self, key: tuple, cursor: int, body, generators) -> str:
        """One tick of ``key``: ``body(cursor, cut)`` issues it (``cut``
        None on an eager tick; else called where the river's decode ends).
        Returns "replay" (its graphs replayed), "capture" (captured and run)
        or "eager" (the key's first tick, which warms the capture)."""
        steps = self._graphs.get(key)
        if steps is not None:
            self.cursor.fill_(cursor)
            for g, call in steps:
                self._backend.replay(g)
                if call is not None:
                    call[0].launch(call[1])
            return "replay"
        if key not in self._warm:
            self._warm.add(key)
            body(cursor, None)
            return "eager"
        if self._backend is None:
            self._backend = self._make_backend(self.device)
        with self._backend.scope():
            self.cursor.fill_(cursor)
            run = _Capture(self._backend, generators, self._buffers)
            run.begin()
            try:
                with sharded.attend_break(run.attend):
                    body(self.cursor, run.cut)
                run.end()
            except BaseException:
                run.abort()
                raise
        self._graphs[key] = run.steps
        return "capture"
