"""SynapseStore: the warm and cold tiers of the agent-memory hierarchy.

Port of the JAX package's ``repro.memory.store``. Tiers:

* **hot**  — a live lane of the engine's tick state on the card. Not stored
  here; the store only sees agents once they leave the device.
* **warm** — host memory: the agent's cache slice plus its per-lane
  scalars, as a tree of CPU tensors (a COPY of the device bytes: the port
  writes its caches in place, so a view of a lane would change under the
  lane's next occupant). Leaves that come off the card land in pinned
  memory, so the copy back to the card can run without the host waiting.
* **cold** — disk: the same tree through the ``repro_torch.checkpoint.io``
  FRAMED codec (magic, version, checksummed zstd or zlib payload), one blob
  per agent; only a skeleton of (shape, dtype name) records stays in memory.

Demotion warm→cold is LRU, triggered when ``warm_capacity_bytes`` is
exceeded (and on explicit :meth:`SynapseStore.demote`); without a
``cold_dir`` entries stay warm and the skip is counted in the report.

Promotion is asynchronous: :meth:`SynapseStore.prefetch` hands back a
:class:`WakeTicket`, and a daemon worker thread reads the blob or the warm
tree and lands it on the device through the caller's ``put_fn``
(:func:`device_put_fn`: non-blocking copies from pinned memory on a CUDA
stream of its own, and an event that marks their end). The worker never
waits for the device, so it cannot trip a sync check
(``torch.cuda.set_sync_debug_mode`` is process-wide, unlike JAX's
thread-local transfer guard); the engine *commits* the prefetched tensors
at a window boundary by making its stream wait for that event
(:func:`ready_on_stream`).

Resilience: the hierarchy must degrade, never crash.

* every cold read verifies the frame checksum; a corrupt or truncated blob
  is moved into ``cold_dir/quarantine/`` and surfaces as a typed
  :class:`SnapshotLostError` (a ``KeyError`` subclass), never a raw codec
  exception mid-wake;
* the cold index is mirrored in an atomic on-disk manifest, and every blob
  embeds its own key, skeleton and bookkeeping in the frame metadata, so
  :meth:`SynapseStore.recover` rebuilds the tier after a process restart
  (manifest first, then orphan blobs from a crash mid-demotion);
* :meth:`SynapseStore.prefetch` retries transient I/O (``OSError``) with
  bounded exponential backoff; tickets carry an optional deadline and a
  terminal *failed* state; :meth:`SynapseStore.heal_worker` detects a dead
  worker thread, fails its in-flight ticket and respawns the thread;
* a :class:`repro_torch.memory.faults.FaultInjector` can be attached
  (``faults=``) to inject torn writes, bit flips, failed reads, slow
  promotions and worker death at the I/O boundaries production code uses.

Interchange with the JAX package is at the codec level: either package's
``loads_framed`` reads the other's payload, given a template of the tree.
A blob's metadata section is pickled bookkeeping of the package that wrote
it (the reference pickles JAX types there), so each store recovers only
the blobs its own package wrote; this one unpickles no foreign type.

Snapshots are stored bitwise: a wake must reproduce the exact greedy
stream of a lane that never hibernated, so nothing here re-quantises.
"""
from __future__ import annotations

import io
import os
import pickle
import queue
import threading
import time
import zlib
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

import torch

from ..checkpoint import io as ckpt_io

WARM = "warm"
COLD = "cold"

BLOB_SUFFIX = ".synapse.blob"
MANIFEST_NAME = "MANIFEST.pkl"
QUARANTINE_DIR = "quarantine"
MANIFEST_VERSION = 1


class SnapshotLostError(KeyError):
    """A snapshot that the index believed existed is permanently gone
    (corrupt/truncated blob quarantined, or its file vanished while still
    indexed). Subclasses ``KeyError`` so legacy callers that treated every
    miss as a key error keep working; new callers can tell loss (was there,
    now unrecoverable) from a plain miss (never there / already dropped)."""

    def __str__(self) -> str:  # KeyError quotes its arg; keep messages readable
        return ": ".join(str(a) for a in self.args)


class ForeignBlobError(pickle.UnpicklingError):
    """A blob's metadata names a type of another package (the JAX package
    pickles JAX types there): this store does not read it."""


class _OwnTypesUnpickler(pickle.Unpickler):
    """Unpickles plain data and this package's own types only."""

    def find_class(self, module, name):
        if module == "repro_torch" or module.startswith("repro_torch."):
            return super().find_class(module, name)
        raise ForeignBlobError(f"{module}.{name}")


def _loads_own(data: bytes):
    return _OwnTypesUnpickler(io.BytesIO(data)).load()


class WorkerDiedError(RuntimeError):
    """The prefetch worker thread died while this ticket was in flight."""


def _host_tree(tree):
    """A host copy of a tree (card, CPU or numpy leaves) as CPU tensors.
    Leaves on the card are copied into pinned memory: the copies are
    enqueued on the current stream and waited for once, all together."""
    cards = []

    def copy(leaf):
        t = ckpt_io.as_tensor(leaf)
        if t.device.type == "cuda":
            dst = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            dst.copy_(t, non_blocking=True)
            cards.append(t.device)
            return dst
        return t.clone(memory_format=torch.contiguous_format) if t is leaf else t

    host = ckpt_io.tree_map(copy, tree)
    if cards:
        torch.cuda.current_stream(cards[0]).synchronize()
    return host


def _skeleton(tree):
    """Shape and dtype only: what stays in memory for a cold agent."""
    return ckpt_io.tree_map(ckpt_io.spec_of, tree)


def tree_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for _, t in ckpt_io.tree_flatten_with_path(tree))


def device_put_fn(device) -> Callable[[Any], tuple]:
    """A ``put_fn`` for :meth:`SynapseStore.prefetch` that lands a host tree
    on ``device``; the ticket's value is ``(tree, event)``.

    On the card the copies run from pinned memory on a CUDA stream of their
    own and are only enqueued: the worker thread does not wait for them, and
    ``event`` marks their end. On the CPU the host tree is handed on as it
    is, with no event."""
    device = torch.device(device)
    if device.type != "cuda":
        return lambda host: (host, None)
    stream = torch.cuda.Stream(device)

    def put(host):
        with torch.cuda.stream(stream):
            tree = ckpt_io.tree_map(
                lambda t: (t if t.is_pinned() else t.pin_memory()).to(device, non_blocking=True), host
            )
            event = torch.cuda.Event()
            event.record(stream)
        return tree, event

    return put


def ready_on_stream(tree, event, device):
    """Order ``device``'s current stream after the copies that ``event``
    marks (a stream wait, no host sync), and tie the tree's memory to that
    stream, so the caching allocator does not reuse it while work queued
    there still reads it. Returns the tree."""
    if event is None:
        return tree
    stream = torch.cuda.current_stream(device)
    stream.wait_event(event)
    for _, t in ckpt_io.tree_flatten_with_path(tree):
        t.record_stream(stream)
    return tree


@dataclass
class ColdEntry:
    """RAM-side record of one cold blob (the blob itself is on disk)."""

    path: str
    skeleton: Any          # LeafSpec tree (decode template)
    comp_bytes: int        # framed file size on disk
    raw_bytes: int         # uncompressed snapshot bytes (accounting)
    meta: Optional[dict] = None  # caller bookkeeping (engine: view/sampling)


class WakeTicket:
    """Handle for an in-flight asynchronous promotion (wake prefetch).

    Terminal states are *ready* (``result()`` returns the value) and
    *failed* (``result()`` raises the stored error). Transitions are
    first-wins: a worker resolving a ticket the host already expired — or
    vice versa — is a no-op, so a blocked worker can be abandoned safely
    and finish into the void."""

    def __init__(self, key: str, *, deadline: Optional[float] = None):
        self.key = key
        self.deadline = deadline  # absolute time.monotonic() timestamp
        self._done = threading.Event()
        self._lock = threading.Lock()
        self._value: Any = None
        self._error: Optional[BaseException] = None
        self.resolved_at: Optional[float] = None  # time.perf_counter() when the value landed

    def _resolve(self, value: Any) -> bool:
        with self._lock:
            if self._done.is_set():
                return False
            self._value = value
            self.resolved_at = time.perf_counter()
            self._done.set()
            return True

    def _fail(self, err: BaseException) -> bool:
        with self._lock:
            if self._done.is_set():
                return False
            self._error = err
            self._done.set()
            return True

    # -- state queries -----------------------------------------------------
    def ready(self) -> bool:
        """Terminal (resolved OR failed) — 'nothing left to wait for'."""
        return self._done.is_set()

    def failed(self) -> bool:
        return self._done.is_set() and self._error is not None

    @property
    def error(self) -> Optional[BaseException]:
        return self._error

    @property
    def state(self) -> str:
        if not self._done.is_set():
            return "pending"
        return "failed" if self._error is not None else "ready"

    # -- deadlines ---------------------------------------------------------
    def remaining(self, now: Optional[float] = None) -> Optional[float]:
        if self.deadline is None:
            return None
        return max(0.0, self.deadline - (time.monotonic() if now is None else now))

    def expired(self, now: Optional[float] = None) -> bool:
        return (
            self.deadline is not None
            and (time.monotonic() if now is None else now) >= self.deadline
        )

    def expire(self, now: Optional[float] = None) -> bool:
        """Host-side deadline enforcement: fail the ticket if its deadline
        passed and no terminal state was reached (e.g. the worker is stuck
        in a blocked ``put_fn``). Returns True if THIS call failed it."""
        if not self.expired(now) or self._done.is_set():
            return False
        return self._fail(
            TimeoutError(f"wake deadline exceeded for {self.key!r}")
        )

    def result(self, timeout: Optional[float] = None) -> Any:
        if not self._done.wait(timeout):
            raise TimeoutError(f"wake prefetch for {self.key!r} still in flight")
        if self._error is not None:
            raise self._error
        return self._value


class SynapseStore:
    """Warm (host RAM) + cold (framed disk) storage for hibernated agents."""

    def __init__(
        self,
        *,
        warm_capacity_bytes: Optional[int] = None,
        cold_dir: Optional[str] = None,
        cold_level: int = 3,
        wake_retries: int = 3,
        wake_backoff_s: float = 0.02,
        wake_backoff_cap_s: float = 1.0,
        faults=None,
    ):
        self.warm_capacity_bytes = warm_capacity_bytes
        self.cold_dir = cold_dir
        self.cold_level = cold_level  # zstd/zlib level of a cold blob
        self.wake_retries = wake_retries
        self.wake_backoff_s = wake_backoff_s
        self.wake_backoff_cap_s = wake_backoff_cap_s  # longest sleep between two retried cold reads
        self.faults = faults  # FaultInjector | None — test/chaos hook
        self._lock = threading.RLock()
        # key -> tree of CPU tensors; insertion order doubles as LRU order
        self._warm: Dict[str, Any] = {}
        self._warm_bytes: Dict[str, int] = {}
        self._warm_meta: Dict[str, Optional[dict]] = {}
        self._cold: Dict[str, ColdEntry] = {}
        self.stats = {
            "puts": 0,
            "demotions": 0,
            "demotions_skipped": 0,
            "prefetches": 0,
            "cold_reads": 0,
            # resilience telemetry
            "quarantined": 0,      # corrupt/truncated blobs moved aside
            "lost": 0,             # indexed snapshots found unrecoverable
            "wake_retries": 0,     # transient read failures retried
            "prefetch_errors": 0,  # tickets that ended in the failed state
            "worker_respawns": 0,  # dead prefetch threads resurrected
            "recovered": 0,        # cold entries rebuilt by recover()
        }
        self._work: "queue.SimpleQueue" = queue.SimpleQueue()
        self._worker: Optional[threading.Thread] = None
        self._inflight: Optional[WakeTicket] = None  # ticket the worker holds

    # -- tier plumbing ----------------------------------------------------
    @property
    def cold_enabled(self) -> bool:
        # the framed codec falls back to zlib, so a cold_dir alone is enough
        return self.cold_dir is not None

    def _cold_path(self, key: str) -> str:
        safe = "".join(c if (c.isalnum() or c in "._-") else "_" for c in key)
        # the crc suffix keeps two keys that mangle identically ("a b" vs
        # "a_b") from silently sharing one blob file
        tag = zlib.crc32(key.encode()) & 0xFFFFFFFF
        return os.path.join(self.cold_dir, f"{safe}-{tag:08x}{BLOB_SUFFIX}")

    def quarantine_dir(self) -> Optional[str]:
        if self.cold_dir is None:
            return None
        return os.path.join(self.cold_dir, QUARANTINE_DIR)

    def warm_bytes(self) -> int:
        with self._lock:
            return sum(self._warm_bytes.values())

    def keys(self):
        with self._lock:
            return list(self._warm) + list(self._cold)

    def __contains__(self, key: str) -> bool:
        with self._lock:
            return key in self._warm or key in self._cold

    def tier_of(self, key: str) -> Optional[str]:
        with self._lock:
            if key in self._warm:
                return WARM
            if key in self._cold:
                return COLD
            return None

    def meta_of(self, key: str) -> Optional[dict]:
        """Caller bookkeeping attached at put() time (survives demotion and
        :meth:`recover` — it rides the blob's frame metadata)."""
        with self._lock:
            if key in self._warm:
                return self._warm_meta.get(key)
            entry = self._cold.get(key)
            return entry.meta if entry is not None else None

    # -- demotion (device -> warm -> cold) --------------------------------
    def put(self, key: str, tree, meta: Optional[dict] = None) -> None:
        """Park a snapshot in the warm tier (demoting LRU entries to cold
        if over capacity). `tree` may hold card, CPU or numpy leaves; the
        store keeps a copy. ``meta`` is small picklable bookkeeping (agent
        kind, view, sampling) persisted with the blob so a crashed process
        can re-adopt the agent."""
        host = _host_tree(tree)
        with self._lock:
            stale = self._cold.pop(key, None)
            self._warm.pop(key, None)  # re-put refreshes LRU position
            self._warm[key] = host
            self._warm_bytes[key] = tree_bytes(host)
            self._warm_meta[key] = meta
            self.stats["puts"] += 1
            if stale is not None:
                # superseded cold blob must not leak on disk. Unlinked under
                # the lock: demotion recreates the SAME path, so an unlocked
                # stale unlink could race a concurrent re-demotion and delete
                # the fresh blob out from under the index.
                try:
                    os.remove(stale.path)
                except OSError:
                    pass
                self._write_manifest_locked()
            self._enforce_capacity_locked()

    def _enforce_capacity_locked(self) -> None:
        if self.warm_capacity_bytes is None:
            return
        while sum(self._warm_bytes.values()) > self.warm_capacity_bytes and self._warm:
            oldest = next(iter(self._warm))
            if not self._demote_locked(oldest):
                self.stats["demotions_skipped"] += 1
                break  # no cold backing: stay warm rather than drop state

    def demote(self, key: str) -> bool:
        """Explicitly push one warm entry to the cold tier."""
        with self._lock:
            return self._demote_locked(key)

    def demote_lru(self) -> Optional[str]:
        with self._lock:
            if not self._warm:
                return None
            oldest = next(iter(self._warm))
            return oldest if self._demote_locked(oldest) else None

    def _demote_locked(self, key: str) -> bool:
        if key not in self._warm or not self.cold_enabled:
            return False
        host = self._warm[key]
        raw = self._warm_bytes[key]
        meta = self._warm_meta.get(key)
        skel = _skeleton(host)
        # the blob is self-describing: key + skeleton + bookkeeping ride the
        # checksummed frame metadata, so recover() can re-adopt an orphan
        # blob whose manifest entry never landed (crash mid-demotion)
        frame_meta = pickle.dumps(
            {"key": key, "skeleton": skel, "meta": meta, "raw": raw},
            protocol=pickle.HIGHEST_PROTOCOL,
        )
        blob = ckpt_io.dumps_framed(host, level=self.cold_level, meta=frame_meta)
        if self.faults is not None:
            blob = self.faults.on_cold_write(key, blob)  # torn-write injection
        os.makedirs(self.cold_dir, exist_ok=True)
        path = self._cold_path(key)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(blob)
        os.replace(tmp, path)
        self._cold[key] = ColdEntry(path, skel, len(blob), raw, meta)
        del self._warm[key]
        del self._warm_bytes[key]
        self._warm_meta.pop(key, None)
        self.stats["demotions"] += 1
        self._write_manifest_locked()
        return True

    # -- manifest + recovery ---------------------------------------------
    def _manifest_path(self) -> str:
        return os.path.join(self.cold_dir, MANIFEST_NAME)

    def _write_manifest_locked(self) -> None:
        """Atomically mirror the cold index to disk. The manifest is the
        authoritative key->file map (collision-proof vs filename mangling)
        and the fast path for :meth:`recover`; blobs stay self-describing
        as the fallback."""
        if self.cold_dir is None:
            return
        os.makedirs(self.cold_dir, exist_ok=True)
        entries = {
            key: {
                "file": os.path.basename(e.path),
                "comp": e.comp_bytes,
                "raw": e.raw_bytes,
            }
            for key, e in self._cold.items()
        }
        payload = pickle.dumps(
            {"version": MANIFEST_VERSION, "entries": entries},
            protocol=pickle.HIGHEST_PROTOCOL,
        )
        tmp = self._manifest_path() + ".tmp"
        with open(tmp, "wb") as f:
            f.write(payload)
        os.replace(tmp, self._manifest_path())

    def _load_manifest(self) -> dict:
        try:
            with open(self._manifest_path(), "rb") as f:
                data = _loads_own(f.read())
            if data.get("version") != MANIFEST_VERSION:
                return {"entries": {}}
            return data
        except FileNotFoundError:
            return {"entries": {}}
        except Exception:
            # a torn manifest write never happened (atomic replace), but a
            # corrupted file must not block recovery: blobs self-describe
            return {"entries": {}, "corrupt": True}

    def recover(self, cold_dir: Optional[str] = None, *,
                verify_payloads: bool = False) -> dict:
        """Rebuild the cold index (skeletons included) from disk after a
        process restart. Manifest entries are adopted first; blob files the
        manifest does not know about (a crash between the blob write and
        the manifest write) are adopted from their embedded frame metadata.
        Unreadable/corrupt blobs are quarantined, manifest entries whose
        file vanished are counted lost — recovery itself never raises on
        bad data. Blobs another package wrote are listed as ``foreign`` and
        left where they are. By default recovery reads only each blob's
        header and metadata, and payload digests are checked when a blob is
        read back (:meth:`get_host`); ``verify_payloads=True`` additionally
        checks every payload digest up front (reads every blob fully)."""
        if cold_dir is not None:
            self.cold_dir = cold_dir
        report = {
            "recovered": [], "quarantined": [], "lost": [],
            "orphans_adopted": [], "foreign": [], "manifest_corrupt": False,
        }
        if self.cold_dir is None or not os.path.isdir(self.cold_dir):
            return report
        manifest = self._load_manifest()
        report["manifest_corrupt"] = bool(manifest.get("corrupt"))
        seen_files = set()
        for key, ent in manifest.get("entries", {}).items():
            fname = ent.get("file", "")
            seen_files.add(fname)
            path = os.path.join(self.cold_dir, fname)
            if not os.path.exists(path):
                report["lost"].append(key)
                with self._lock:
                    self.stats["lost"] += 1
                continue
            self._adopt_blob(path, report, verify=verify_payloads)
        # orphan blobs: written, crashed before their manifest update
        try:
            listing = sorted(os.listdir(self.cold_dir))
        except OSError:
            listing = []
        for fname in listing:
            if not fname.endswith(BLOB_SUFFIX) or fname in seen_files:
                continue
            adopted = self._adopt_blob(os.path.join(self.cold_dir, fname), report, verify=verify_payloads)
            if adopted is not None:
                report["orphans_adopted"].append(adopted)
        with self._lock:
            self.stats["recovered"] += len(report["recovered"])
            self._write_manifest_locked()
        return report

    def _adopt_blob(self, path: str, report: dict, *, verify: bool = False) -> Optional[str]:
        """Validate one blob file and (re)index it; quarantine on any
        integrity failure (with ``verify``, a payload whose digest is wrong
        too). Returns the adopted key, or None."""
        try:
            meta_bytes = ckpt_io.read_frame_meta(path)
            info = _loads_own(meta_bytes)
            key = info["key"]
            skel, meta, raw = info["skeleton"], info.get("meta"), info["raw"]
            if verify:
                with open(path, "rb") as f:
                    ckpt_io.unframe(f.read(), verify=True)
        except FileNotFoundError:
            report["lost"].append(os.path.basename(path))
            with self._lock:
                self.stats["lost"] += 1
            return None
        except ForeignBlobError:
            report["foreign"].append(os.path.basename(path))
            return None
        except Exception as e:  # CorruptBlobError, bad pickle, short file...
            q = self._quarantine_file(path)
            report["quarantined"].append(
                {"file": os.path.basename(path), "reason": repr(e),
                 "quarantined_to": q}
            )
            return None
        with self._lock:
            if key in self._warm or key in self._cold:
                return None  # live state wins over a stale on-disk copy
            self._cold[key] = ColdEntry(
                path, skel, os.path.getsize(path), raw, meta
            )
        report["recovered"].append(key)
        return key

    def _quarantine_file(self, path: str) -> Optional[str]:
        """Move a bad blob into ``cold_dir/quarantine/`` (never delete —
        the bytes may matter for forensics). Returns the new path."""
        qdir = self.quarantine_dir()
        if qdir is None:
            try:
                os.remove(path)
            except OSError:
                pass
            with self._lock:
                self.stats["quarantined"] += 1
            return None
        try:
            os.makedirs(qdir, exist_ok=True)
            dest = os.path.join(qdir, os.path.basename(path))
            os.replace(path, dest)
        except OSError:
            dest = None
        with self._lock:
            self.stats["quarantined"] += 1
        return dest

    # -- promotion (cold/warm -> host pytree -> device) -------------------
    def _read_cold_blob(self, key: str, path: str) -> bytes:
        with open(path, "rb") as f:
            data = f.read()
        if self.faults is not None:
            data = self.faults.on_cold_read(key, data)  # may raise / mutate
        return data

    def get_host(self, key: str, *, verify: bool = True):
        """Synchronously read a snapshot back as a tree of CPU tensors (no tier
        mutation — the entry stays parked until `drop()`).

        Every cold read verifies the blob's frame checksum (``verify=False``
        skips the payload digest: a benchmark's overhead-measurement arm
        only). A corrupt or
        truncated blob is quarantined and surfaces as
        :class:`SnapshotLostError`; a concurrent ``drop()``/re-``put()``
        that unlinks the file mid-read resolves to the CURRENT state of the
        key (warm copy, or a clean ``KeyError``) instead of leaking
        ``FileNotFoundError``."""
        with self._lock:
            if key in self._warm:
                return self._warm[key]
            if key in self._cold:
                entry = self._cold[key]
            else:
                raise KeyError(f"no hibernated snapshot for {key!r}")
        try:
            blob = self._read_cold_blob(key, entry.path)
        except FileNotFoundError:
            return self._resolve_vanished(key, entry)
        with self._lock:
            cur = self._cold.get(key)
            if cur is not entry:
                # raced a re-put/drop while reading: the bytes we hold are
                # stale — defer to whatever the key is NOW
                if key in self._warm:
                    return self._warm[key]
                if cur is None:
                    raise KeyError(f"no hibernated snapshot for {key!r}")
                entry = cur  # re-demoted: fall through and decode fresh index
        try:
            tree = ckpt_io.loads_framed(blob, entry.skeleton, verify=verify)
        except ckpt_io.CorruptBlobError as e:
            with self._lock:
                if self._cold.get(key) is entry:
                    del self._cold[key]
                    self.stats["lost"] += 1
                    self._write_manifest_locked()
            self._quarantine_file(entry.path)
            raise SnapshotLostError(
                key, f"cold blob failed integrity check ({e}); quarantined"
            ) from e
        with self._lock:
            self.stats["cold_reads"] += 1
        return tree

    def _resolve_vanished(self, key: str, entry: ColdEntry):
        """The blob file disappeared mid-read. A concurrent drop/re-put is
        benign (the key's CURRENT state answers); a file missing while the
        index still points at it is permanent loss."""
        with self._lock:
            if key in self._warm:
                return self._warm[key]
            cur = self._cold.get(key)
            if cur is None:
                raise KeyError(f"no hibernated snapshot for {key!r}")
            if cur is entry:
                del self._cold[key]
                self.stats["lost"] += 1
                self._write_manifest_locked()
                raise SnapshotLostError(key, "cold blob file missing")
        # the entry was replaced (re-demoted) while we read: try the new one
        return self.get_host(key)

    def prefetch(
        self,
        key: str,
        put_fn: Optional[Callable[[Any], Any]] = None,
        *,
        retries: Optional[int] = None,
        backoff_s: Optional[float] = None,
        deadline_s: Optional[float] = None,
    ) -> WakeTicket:
        """Kick off an async promotion; `put_fn` (if given) runs on the
        worker thread — pass :func:`device_put_fn` so the host-to-device
        copy overlaps the window in flight.

        Transient I/O failures (``OSError``) retry up to ``retries`` times
        with exponential backoff (``backoff_s * 2**attempt``, capped);
        permanent failures — missing key, quarantined blob, exhausted
        retries, a raising ``put_fn`` — land the ticket in the terminal
        *failed* state, surfaced at ``result()`` / ``failed()``.
        ``deadline_s`` bounds the whole promotion: an overdue ticket fails
        with ``TimeoutError`` even if the worker is stuck."""
        if key not in self:
            raise KeyError(f"no hibernated snapshot for {key!r}")
        deadline = None if deadline_s is None else time.monotonic() + deadline_s
        ticket = WakeTicket(key, deadline=deadline)
        with self._lock:
            self.stats["prefetches"] += 1
        self._ensure_worker()
        self._work.put((
            ticket,
            put_fn,
            self.wake_retries if retries is None else retries,
            self.wake_backoff_s if backoff_s is None else backoff_s,
        ))
        return ticket

    def _ensure_worker(self) -> None:
        with self._lock:
            if self._worker is None or not self._worker.is_alive():
                self._worker = threading.Thread(
                    target=self._worker_loop, name="synapse-prefetch", daemon=True
                )
                self._worker.start()

    def heal_worker(self) -> int:
        """Supervision: if the prefetch worker thread died (an injected
        ``BaseException``, a segfaulting extension, ...), fail the ticket it
        was holding — its waiter must see a terminal state, not hang — and
        respawn the thread so queued tickets keep draining. Returns the
        number of tickets failed. Safe to call any time; a healthy worker
        makes this a no-op."""
        with self._lock:
            worker, inflight = self._worker, self._inflight
            if worker is None or worker.is_alive():
                return 0
            self._inflight = None
            self.stats["worker_respawns"] += 1
        failed = 0
        if inflight is not None and not inflight.ready():
            if inflight._fail(WorkerDiedError(
                f"prefetch worker died while promoting {inflight.key!r}"
            )):
                failed += 1
                with self._lock:
                    self.stats["prefetch_errors"] += 1
        self._ensure_worker()
        return failed

    def _worker_loop(self) -> None:
        while True:
            ticket, put_fn, retries, backoff = self._work.get()
            with self._lock:
                self._inflight = ticket
            try:
                self._run_prefetch(ticket, put_fn, retries, backoff)
            except Exception as e:  # surfaced at ticket.result()/failed()
                # NOT BaseException: KeyboardInterrupt/SystemExit must kill
                # the thread (heal_worker resurrects it and fails the
                # ticket) instead of being swallowed into a ticket error
                if ticket._fail(e):
                    with self._lock:
                        self.stats["prefetch_errors"] += 1
            with self._lock:
                self._inflight = None

    def _run_prefetch(self, ticket: WakeTicket, put_fn, retries: int,
                      backoff: float) -> None:
        attempt = 0
        while True:
            if ticket.ready():
                return  # expired host-side while queued/retrying
            if ticket.expire():
                with self._lock:
                    self.stats["prefetch_errors"] += 1
                return
            try:
                host = self.get_host(ticket.key)
                if self.faults is not None and put_fn is not None:
                    self.faults.on_put_fn(ticket.key)  # slow/blocked put
                # the copies are only enqueued: whoever commits the value
                # orders its own stream after them
                value = put_fn(host) if put_fn is not None else host
                if ticket._resolve(value):
                    return
                return  # lost the race to a host-side expiry
            except KeyError:
                raise  # SnapshotLostError / plain miss: permanent, no retry
            except OSError:
                attempt += 1
                if attempt > retries:
                    raise
                with self._lock:
                    self.stats["wake_retries"] += 1
                delay = min(backoff * (2 ** (attempt - 1)), self.wake_backoff_cap_s)
                if ticket.deadline is not None:
                    rem = ticket.remaining()
                    if rem is not None:
                        delay = min(delay, rem)
                time.sleep(delay)

    def drop(self, key: str) -> None:
        """Forget a snapshot (agent is hot again, or discarded)."""
        with self._lock:
            self._warm.pop(key, None)
            self._warm_bytes.pop(key, None)
            self._warm_meta.pop(key, None)
            entry = self._cold.pop(key, None)
            if entry is not None:
                # under the lock for the same reason as put(): a concurrent
                # re-put could re-demote to the same path between our pop and
                # an unlocked unlink, losing the new blob
                try:
                    os.remove(entry.path)
                except OSError:
                    pass
                self._write_manifest_locked()

    # -- accounting -------------------------------------------------------
    def report(self) -> Dict[str, Any]:
        with self._lock:
            cold_disk = sum(e.comp_bytes for e in self._cold.values())
            cold_raw = sum(e.raw_bytes for e in self._cold.values())
            return {
                "n_warm": len(self._warm),
                "n_cold": len(self._cold),
                "warm_bytes": sum(self._warm_bytes.values()),
                "cold_bytes": cold_disk,
                "cold_raw_bytes": cold_raw,
                "cold_enabled": self.cold_enabled,
                **{f"stat_{k}": v for k, v in self.stats.items()},
            }
