"""The port's SynapseStore, AgentRegistry and FaultInjector (the store,
registry and fault cases of tests/test_memory_tiers.py and
tests/test_resilience.py, on ``repro_torch.memory``). No model is needed.

* TIERS — warm snapshots are bitwise COPIES held as CPU tensors (the port's
  caches are written in place, so a view would change under the lane's next
  occupant); LRU demotion to the framed cold tier; skipped (and counted)
  demotions without a cold directory; asynchronous prefetch tickets.
* FAULTS — corrupt and torn blobs are quarantined and surface as
  ``SnapshotLostError``; transient reads retry with backoff; exhausted
  retries, deadlines and a dead worker fail the ticket terminally and the
  worker heals; the get/drop race resolves to the key's current state;
  concurrent churn leaves no orphan file and exact accounting.
* RECOVERY — a fresh store rebuilds the cold index from the manifest and
  from orphan blobs, survives a bad manifest, quarantines damage, counts
  missing files, and leaves blobs the JAX package wrote where they are
  (it unpickles no foreign type).
"""
import os
import threading
import time

import numpy as np
import pytest
import torch

from repro.memory import SynapseStore as JaxStore
from repro_torch.checkpoint import io as tio
from repro_torch.memory import (
    HIBERNATED,
    REGISTERED,
    AgentRegistry,
    FaultInjector,
    SnapshotLostError,
    SynapseStore,
    WorkerDiedError,
)
from repro_torch.memory import store as tstore


def _snap(seed, kb=4):
    g = torch.Generator().manual_seed(seed)
    return {
        "caches": torch.randn(kb * 256, generator=g),
        "tok": torch.tensor(seed, dtype=torch.int32),
        "pos": torch.tensor(seed * 10, dtype=torch.int64),
    }


def _nbytes(tree):
    return sum(t.numel() * t.element_size() for _, t in tio.tree_flatten_with_path(tree))


def _bitwise(a, b):
    la, lb = tio.tree_flatten_with_path(a), tio.tree_flatten_with_path(b)
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (_, x), (_, y) in zip(la, lb):
        x, y = tio.as_tensor(x), tio.as_tensor(y)
        assert x.dtype == y.dtype and x.shape == y.shape
        assert tio.leaf_bytes(x) == tio.leaf_bytes(y)


def _cold_store(tmp_path, **kw):
    """warm_capacity_bytes=1 forces every put straight through to disk."""
    kw.setdefault("wake_backoff_s", 0.001)
    return SynapseStore(warm_capacity_bytes=1, cold_dir=str(tmp_path), **kw)


# ---------------------------------------------------------------------------
# tiers
# ---------------------------------------------------------------------------
def test_store_warm_roundtrip_bitwise():
    store = SynapseStore()
    snap = _snap(1)
    store.put("a", snap)
    assert store.tier_of("a") == "warm"
    _bitwise(snap, store.get_host("a"))
    rep = store.report()
    assert rep["n_warm"] == 1 and rep["n_cold"] == 0
    assert rep["warm_bytes"] == _nbytes(snap)
    store.drop("a")
    assert store.tier_of("a") is None and "a" not in store


def test_store_keeps_a_copy_not_a_view():
    """The warm tier holds a copy: the source (a lane of a cache written in
    place) may change after the put without changing the snapshot."""
    store = SynapseStore()
    full = torch.arange(24, dtype=torch.float32).reshape(2, 3, 4)
    lane = full[:, 1:2]  # a strided view, as a lane of a stacked cache is
    store.put("a", {"caches": lane, "scalar": np.int32(5)})
    kept = lane.clone()
    full.zero_()
    got = store.get_host("a")
    assert torch.equal(got["caches"], kept) and got["caches"].is_contiguous()
    assert got["scalar"].dtype == torch.int32 and int(got["scalar"]) == 5
    assert all(isinstance(t, torch.Tensor) for _, t in tio.tree_flatten_with_path(got))


def test_store_lru_demotes_to_cold(tmp_path):
    one = _nbytes(_snap(0))
    store = SynapseStore(warm_capacity_bytes=2 * one, cold_dir=str(tmp_path))
    snaps = {k: _snap(i) for i, k in enumerate("abc")}
    for k, s in snaps.items():
        store.put(k, s)
    # capacity fits two: the LRU entry ("a") spilled to disk
    assert store.tier_of("a") == "cold"
    assert store.tier_of("b") == "warm" and store.tier_of("c") == "warm"
    rep = store.report()
    assert rep["n_cold"] == 1 and rep["cold_bytes"] > 0
    assert rep["cold_raw_bytes"] == one
    for k, s in snaps.items():  # the cold read is bitwise too
        _bitwise(s, store.get_host(k))
    store.put("b", snaps["b"])  # LRU refresh
    store.put("a", snaps["a"])  # back to warm; the oldest spills
    assert store.stats["demotions"] >= 2
    for k in "abc":
        store.drop(k)
    # only the manifest may remain: every blob and tmp file is gone
    leftovers = [p.name for p in tmp_path.iterdir()
                 if p.suffix != ".tmp" and p.name not in ("MANIFEST.pkl", "quarantine")]
    assert not leftovers, leftovers


def test_store_demotion_skipped_without_cold_backing():
    """No cold_dir: over-capacity entries stay warm and the skip is COUNTED;
    state is never dropped, nothing raises mid-run."""
    one = _nbytes(_snap(0))
    store = SynapseStore(warm_capacity_bytes=one)
    store.put("a", _snap(1))
    store.put("b", _snap(2))
    assert store.tier_of("a") == "warm" and store.tier_of("b") == "warm"
    assert store.stats["demotions_skipped"] >= 1
    assert store.report()["warm_bytes"] == 2 * one


def test_store_prefetch_async_ticket():
    store = SynapseStore()
    snap = _snap(3)
    store.put("a", snap)
    put = tstore.device_put_fn("cpu")
    before = time.perf_counter()
    ticket = store.prefetch("a", put)
    tree, event = ticket.result(timeout=30)
    assert before <= ticket.resolved_at <= time.perf_counter()  # when the value landed
    assert event is None  # on the CPU the host tree is handed on as it is
    _bitwise(snap, tree)
    assert tstore.ready_on_stream(tree, event, torch.device("cpu")) is tree
    with pytest.raises(KeyError):
        store.prefetch("missing")
    # a failing put_fn surfaces at result(), not on the engine thread
    bad = store.prefetch("a", lambda host: (_ for _ in ()).throw(RuntimeError("boom")))
    with pytest.raises(RuntimeError, match="boom"):
        bad.result(timeout=30)
    assert bad.resolved_at is None


def test_registry_transitions_and_lru():
    reg = AgentRegistry()
    for aid in ("a", "b", "c"):
        reg.register(aid, "main")
    assert reg.counts() == {"registered": 3, "active": 0, "hibernated": 0, "lost": 0, "dormant": 3}
    reg.bind("a", 0)
    reg.bind("b", 1)
    assert reg.agent_at(1, "main").agent_id == "b"
    assert reg.lru_active("main").agent_id == "a"
    assert reg.lru_active("main", exclude=("a",)).agent_id == "b"
    reg.hibernate("a", {"x": 1})
    assert reg.get("a").status == HIBERNATED and reg.get("a").saved == {"x": 1}
    assert reg.counts()["hibernated"] == 1 and reg.counts()["dormant"] == 2
    reg.release("a")
    assert reg.get("a").status == REGISTERED and reg.get("a").saved is None
    reg.forget("c")
    assert "c" not in reg and reg.counts()["registered"] == 2


# ---------------------------------------------------------------------------
# quarantine, retries, deadlines, worker supervision
# ---------------------------------------------------------------------------
def test_corrupt_cold_blob_quarantined(tmp_path):
    store = _cold_store(tmp_path, faults=FaultInjector().flip_write("a"))
    snap = _snap(1)
    store.put("a", snap)
    store.put("b", snap)  # written clean: must survive its neighbour's loss
    assert store.tier_of("a") == "cold"
    with pytest.raises(SnapshotLostError):
        store.get_host("a")
    assert store.tier_of("a") is None
    assert [p.name for p in (tmp_path / "quarantine").iterdir()] and store.stats["quarantined"] == 1
    with pytest.raises(KeyError):  # a later access is a plain miss, not a loss
        store.get_host("a")
    _bitwise(snap, store.get_host("b"))


def test_torn_write_detected(tmp_path):
    store = _cold_store(tmp_path, faults=FaultInjector().torn_write("a", frac=0.6))
    store.put("a", _snap(1))
    with pytest.raises(SnapshotLostError):
        store.get_host("a")
    assert store.stats["lost"] == 1


def test_transient_read_failures_retry_through(tmp_path):
    store = _cold_store(tmp_path, faults=FaultInjector().fail_read("a", times=2))
    snap = _snap(4)
    store.put("a", snap)
    _bitwise(snap, store.prefetch("a").result(timeout=30))
    assert store.stats["wake_retries"] == 2
    assert store.stats["prefetch_errors"] == 0


def test_exhausted_retries_fail_ticket_terminally(tmp_path):
    store = _cold_store(tmp_path, faults=FaultInjector().fail_read("a", times=99))
    store.put("a", _snap(4))
    ticket = store.prefetch("a", retries=2)
    with pytest.raises(OSError):
        ticket.result(timeout=30)
    assert ticket.failed() and ticket.state == "failed"
    assert store.stats["prefetch_errors"] == 1
    assert store.stats["wake_retries"] == 2
    assert "a" in store  # the snapshot itself is intact: retryable later


def test_ticket_result_timeout_does_not_fail_ticket(tmp_path):
    """``result(timeout=)`` is the CALLER's timeout, not the ticket's: the
    promotion keeps going and can still succeed afterwards."""
    store = _cold_store(tmp_path, faults=FaultInjector().slow_put("a", seconds=0.3))
    snap = _snap(5)
    store.put("a", snap)
    ticket = store.prefetch("a", put_fn=lambda h: h)
    with pytest.raises(TimeoutError):
        ticket.result(timeout=0.01)
    assert not ticket.ready()  # still in flight, not failed
    _bitwise(snap, ticket.result(timeout=30))


def test_deadline_expires_blocked_promotion(tmp_path):
    """A worker stuck in put_fn cannot outlive the ticket's deadline: the
    host expires the ticket and the worker's late resolve loses the
    first-wins race — no crash, no hang."""
    release = threading.Event()
    store = _cold_store(tmp_path, faults=FaultInjector().block_put("a", release=release, timeout=30))
    store.put("a", _snap(6))
    ticket = store.prefetch("a", put_fn=lambda h: h, deadline_s=0.05)
    deadline = time.monotonic() + 30
    while not ticket.ready() and time.monotonic() < deadline:
        ticket.expire()
        time.sleep(0.01)
    assert ticket.failed() and isinstance(ticket.error, TimeoutError)
    release.set()  # un-stick the worker; its resolve must be a no-op
    time.sleep(0.2)
    assert ticket.failed() and isinstance(ticket.error, TimeoutError)
    with pytest.raises(TimeoutError):
        ticket.result()
    store.faults = None  # the worker survived: the next wake works
    assert store.prefetch("a").result(timeout=30) is not None


@pytest.mark.filterwarnings("ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_worker_death_detected_and_healed(tmp_path):
    store = _cold_store(tmp_path, faults=FaultInjector().kill_worker_on_read("a"))
    snap = _snap(7)
    store.put("a", snap)
    ticket = store.prefetch("a")
    deadline = time.monotonic() + 30
    while store._worker.is_alive() and time.monotonic() < deadline:
        time.sleep(0.01)
    assert not store._worker.is_alive()
    assert store.heal_worker() == 1  # fails the orphaned in-flight ticket
    assert ticket.failed() and isinstance(ticket.error, WorkerDiedError)
    assert store.stats["worker_respawns"] == 1 and store.stats["prefetch_errors"] == 1
    store.faults = None  # the respawned worker drains new tickets normally
    _bitwise(snap, store.prefetch("a").result(timeout=30))
    assert store.heal_worker() == 0  # a healthy worker: supervision is a no-op


def test_get_host_drop_race_resolves_to_current_state(tmp_path):
    """The blob file vanishes between the index lookup and the read: a
    concurrent drop() is a clean KeyError, a concurrent re-put() returns the
    NEW bytes, and only a file missing while still indexed is a loss."""
    snap_old, snap_new = _snap(8), _snap(9)

    class RaceHook:
        def __init__(self, store, action):
            self.store, self.action, self.fired = store, action, False

        def on_cold_write(self, key, blob):
            return blob

        def on_put_fn(self, key):
            pass

        def on_cold_read(self, key, data):
            if not self.fired:
                self.fired = True
                self.action(self.store, key)  # mutate AFTER the file read...
                raise FileNotFoundError(key)  # ...and pretend the read lost
            return data

    s1 = _cold_store(tmp_path / "d")
    s1.put("k", snap_old)
    s1.faults = RaceHook(s1, lambda st, k: st.drop(k))
    with pytest.raises(KeyError) as ei:
        s1.get_host("k")
    assert not isinstance(ei.value, SnapshotLostError)
    assert s1.stats["lost"] == 0 and s1.stats["quarantined"] == 0

    s2 = _cold_store(tmp_path / "r")
    s2.put("k", snap_old)
    s2.faults = RaceHook(s2, lambda st, k: st.put(k, snap_new))
    _bitwise(snap_new, s2.get_host("k"))

    s3 = _cold_store(tmp_path / "l")
    s3.put("k", snap_old)
    os.remove(s3._cold_path("k"))
    with pytest.raises(SnapshotLostError):
        s3.get_host("k")
    assert "k" not in s3 and s3.stats["lost"] == 1


def test_concurrent_store_churn_no_orphans(tmp_path):
    """put/prefetch/drop/demote_lru from threads: no deadlock (bounded
    join), no orphaned .tmp or blob file, and a report that accounts for
    exactly the keys that remain."""
    one = _nbytes(_snap(0))
    store = SynapseStore(warm_capacity_bytes=3 * one, cold_dir=str(tmp_path), wake_backoff_s=0.001)
    snaps = {f"k{i}": _snap(i) for i in range(8)}
    stop = time.monotonic() + 3.0
    errors = []

    def churn(tid):
        rng = np.random.default_rng(tid)
        try:
            while time.monotonic() < stop:
                key = f"k{int(rng.integers(8))}"
                op = int(rng.integers(4))
                if op == 0:
                    store.put(key, snaps[key])
                elif op == 1:
                    try:
                        store.prefetch(key).result(timeout=0.02)  # the expiry path too
                    except (KeyError, TimeoutError, OSError):
                        pass
                elif op == 2:
                    store.drop(key)
                else:
                    store.demote_lru()
        except Exception as e:  # anything else is a real bug
            errors.append(e)

    threads = [threading.Thread(target=churn, args=(t,)) for t in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive(), "churn thread deadlocked"
    assert not errors, errors

    store.heal_worker()  # drain the prefetch queue so no writer races the audit
    for key in list(store.keys()):
        try:
            store.prefetch(key).result(timeout=30)
        except KeyError:
            pass
    rep = store.report()
    keys = store.keys()
    assert rep["n_warm"] + rep["n_cold"] == len(keys)
    assert rep["warm_bytes"] == one * rep["n_warm"]
    on_disk = {p.name for p in tmp_path.iterdir() if p.name not in ("MANIFEST.pkl", "quarantine")}
    assert not {n for n in on_disk if n.endswith(".tmp")}, "orphaned tmp files"
    assert on_disk == {os.path.basename(store._cold[k].path) for k in store._cold}
    for key in keys:
        _bitwise(snaps[key], store.get_host(key))


# ---------------------------------------------------------------------------
# crash recovery: manifest + blob-embedded metadata
# ---------------------------------------------------------------------------
def test_recover_rebuilds_index_and_skeletons(tmp_path):
    store = _cold_store(tmp_path)
    snaps = {k: _snap(i) for i, k in enumerate(("alpha", "beta"))}
    for k, s in snaps.items():
        store.put(k, s, meta={"kind": "main", "tag": k})
    del store  # process death: only the directory survives

    fresh = SynapseStore(warm_capacity_bytes=1)
    report = fresh.recover(str(tmp_path))
    assert sorted(report["recovered"]) == ["alpha", "beta"]
    assert not report["quarantined"] and not report["lost"] and not report["foreign"]
    assert fresh.stats["recovered"] == 2
    for k, s in snaps.items():
        assert fresh.tier_of(k) == "cold"
        assert fresh.meta_of(k) == {"kind": "main", "tag": k}
        _bitwise(s, fresh.get_host(k))


def test_recover_adopts_orphans_and_survives_bad_manifest(tmp_path):
    store = _cold_store(tmp_path)
    store.put("a", _snap(1), meta={"kind": "main"})
    store.put("b", _snap(2), meta={"kind": "main"})
    # a crash before the manifest caught up: garbage manifest, blobs intact
    (tmp_path / "MANIFEST.pkl").write_bytes(b"not a pickle at all")
    fresh = SynapseStore(warm_capacity_bytes=1)
    report = fresh.recover(str(tmp_path))
    assert report["manifest_corrupt"]
    assert sorted(report["recovered"]) == ["a", "b"]
    assert sorted(report["orphans_adopted"]) == ["a", "b"]
    # and recover() rewrote a good manifest: a second restart is fast-path
    r2 = SynapseStore(warm_capacity_bytes=1).recover(str(tmp_path))
    assert sorted(r2["recovered"]) == ["a", "b"] and not r2["orphans_adopted"]


def test_recover_quarantines_corrupt_counts_missing(tmp_path):
    store = _cold_store(tmp_path)
    for i, k in enumerate(("good", "torn", "gone")):
        store.put(k, _snap(i), meta={"kind": "main"})
    good_snap = store.get_host("good")
    torn_path = store._cold_path("torn")
    blob = open(torn_path, "rb").read()
    open(torn_path, "wb").write(blob[: len(blob) // 2])
    os.remove(store._cold_path("gone"))
    del store

    fresh = SynapseStore(warm_capacity_bytes=1)
    report = fresh.recover(str(tmp_path))
    assert report["recovered"] == ["good"]
    assert len(report["quarantined"]) == 1 and report["lost"] == ["gone"]
    assert fresh.stats["quarantined"] == 1 and fresh.stats["lost"] == 1
    assert (tmp_path / "quarantine").exists()
    _bitwise(good_snap, fresh.get_host("good"))


def test_recover_leaves_the_reference_blobs_alone(tmp_path, monkeypatch):
    """A directory the JAX package wrote into: its blobs pickle JAX types in
    their metadata, so the port lists them as foreign, leaves the files in
    place and unpickles none of their types; its own blobs beside them
    recover."""
    ref = JaxStore(warm_capacity_bytes=1, cold_dir=str(tmp_path))
    ref.put("ref", {"x": np.ones(3, np.float32)}, meta={"kind": "main"})
    ref_file = os.path.basename(ref._cold_path("ref"))
    port = _cold_store(tmp_path)
    port.put("port", _snap(1), meta={"kind": "main"})
    found = []
    real = tstore._OwnTypesUnpickler.find_class
    monkeypatch.setattr(tstore._OwnTypesUnpickler, "find_class",
                        lambda self, m, n: (found.append(m), real(self, m, n))[1])
    fresh = SynapseStore(warm_capacity_bytes=1)
    report = fresh.recover(str(tmp_path))
    assert report["recovered"] == ["port"] and report["foreign"] == [ref_file]
    assert not report["quarantined"] and (tmp_path / ref_file).exists()
    assert any(m.startswith("jax") for m in found)  # refused, never loaded
    _bitwise(_snap(1), fresh.get_host("port"))
