"""Object-plane tests: arena routing, zero-copy descriptors, spill/restore,
descriptor pinning (plasma's in-use semantics), full-store fallbacks, and
stale-arena reaping.

Reference parity: plasma store semantics — seal-once immutability, in-use
pinning during client reads, LRU eviction/spill, restore on access
(``src/ray/object_manager/plasma/``, ``LocalObjectManager`` spill —
SURVEY.md §1 layer 6, §2.1 plasma row; mount empty).
"""

import os
import threading

import pytest

from ray_tpu_torch.common.ids import ObjectID
from ray_tpu_torch.native import Arena
from ray_tpu_torch.runtime.object_store import (MemoryStore,
                                                ObjectStoreFullError, ShmEntry,
                                                SpillEntry)
from ray_tpu_torch.runtime.serialization import deserialize, serialize

# Port copy of tests/test_object_store.py: the reference's file with
# ``ray_tpu`` renamed to ``ray_tpu_torch``.  Deviations, none of which
# loosens a check:
# - the autouse fixture below resets the port's process-global state
#   (Config, chaos, breakers, the clock and transport seams) as
#   tests/conftest.py resets the reference's, and sets
#   RT_SCHEDULER_DEVICE=cpu: the port's device programs run on the GPU
#   unless asked for the CPU (subprocesses inherit the variable).


@pytest.fixture(autouse=True)
def _port_state(monkeypatch):
    from ray_tpu_torch.common import clock
    from ray_tpu_torch.common.config import Config as PortConfig
    from ray_tpu_torch.rpc import breaker, chaos, transport
    monkeypatch.setenv("RT_SCHEDULER_DEVICE", "cpu")
    PortConfig.reset()
    chaos.disable()
    breaker.reset_registry()
    yield
    clock.uninstall()
    transport.uninstall()
    chaos.disable()
    breaker.reset_registry()
    PortConfig.reset()


CAP = 1 << 20           # 1 MiB arena for unit tests
THRESHOLD = 1024        # payloads above this route to the arena


@pytest.fixture
def store(tmp_path):
    arena = Arena(str(tmp_path / "arena"), CAP, create=True)
    s = MemoryStore(arena=arena, spill_dir=str(tmp_path / "spill"),
                    direct_call_threshold=THRESHOLD, spill_threshold=0.8)
    yield s
    arena.close()


def _payload(n: int, fill: bytes = b"x") -> bytes:
    """Serialized bytes whose deserialized value is checkable."""
    return serialize(fill * n)


def _oid() -> ObjectID:
    return ObjectID.from_random()


# -- routing ---------------------------------------------------------------

def test_small_payload_stays_in_band(store):
    oid = _oid()
    store.put_serialized(oid, _payload(10))
    assert isinstance(store._objects[oid], bytes)  # deserialized value
    assert store.stats()["num_shm"] == 0
    assert store.get([oid])[0] == b"x" * 10


def test_large_payload_routes_to_arena(store):
    oid = _oid()
    store.put_serialized(oid, _payload(10_000))
    assert isinstance(store._objects[oid], ShmEntry)
    assert store.stats()["arena_bytes_in_use"] > 0
    assert store.get([oid])[0] == b"x" * 10_000


def test_seal_once(store):
    oid = _oid()
    store.put_serialized(oid, _payload(10_000))
    store.put_serialized(oid, serialize(b"other"))   # second seal ignored
    assert store.get([oid])[0] == b"x" * 10_000


def test_descriptor_shapes(store):
    big, small = _oid(), _oid()
    store.put_serialized(big, _payload(10_000))
    store.put_serialized(small, _payload(10))
    d_big = store.descriptor_of(big)
    d_small = store.descriptor_of(small)
    assert d_big[0] == "s" and d_big[2] == len(_payload(10_000))
    assert d_small[0] == "v" and d_small[1] == b"x" * 10
    # the descriptor's view deserializes to the sealed value
    assert deserialize(store.arena.view(d_big[1], d_big[2])) == b"x" * 10_000
    store.unpin([big])


# -- spill / restore -------------------------------------------------------

def test_spill_under_pressure_and_restore(store):
    n_each = 200_000            # 5 objects ~= 1 MiB: must spill
    oids = [_oid() for _ in range(6)]
    for i, oid in enumerate(oids):
        store.put_serialized(oid, serialize(bytes([i]) * n_each))
    stats = store.stats()
    assert stats["num_spilled"] > 0, "pressure must have spilled LRU objects"
    assert stats["spilled_bytes"] > 0
    # every object restores to its exact sealed value (spilled ones come
    # back through the restore path)
    for i, oid in enumerate(oids):
        assert store.get([oid])[0] == bytes([i]) * n_each
    assert store.restored_bytes > 0


def test_spill_files_removed_on_delete(store, tmp_path):
    oids = [_oid() for _ in range(6)]
    for i, oid in enumerate(oids):
        store.put_serialized(oid, serialize(bytes([i]) * 200_000))
    spill_dir = tmp_path / "spill"
    assert len(os.listdir(spill_dir)) > 0
    store.delete(oids)
    assert len(os.listdir(spill_dir)) == 0
    assert store.stats()["arena_bytes_in_use"] == 0


# -- full-store fallback (waiters must never hang) -------------------------

def test_oversized_payload_seals_via_disk(store):
    """A payload bigger than the whole arena cannot raise out of
    put_serialized: it seals as a direct-to-disk spill entry and get
    works (advisor round-2 medium: ObjectStoreFullError used to strand
    every waiter)."""
    oid = _oid()
    store.put_serialized(oid, serialize(b"z" * (2 * CAP)))
    assert isinstance(store._objects[oid], SpillEntry)
    assert store.get([oid], timeout=1)[0] == b"z" * (2 * CAP)


def test_oversized_payload_without_spill_dir_goes_in_band(tmp_path):
    arena = Arena(str(tmp_path / "a2"), CAP, create=True)
    store = MemoryStore(arena=arena, spill_dir=None,
                        direct_call_threshold=THRESHOLD)
    try:
        oid = _oid()
        store.put_serialized(oid, serialize(b"z" * (2 * CAP)))
        assert store.get([oid], timeout=1)[0] == b"z" * (2 * CAP)
    finally:
        arena.close()


# -- pinning (the round-2 use-after-free) ----------------------------------

def test_pinned_object_survives_spill_pressure(store):
    """THE regression test for the unpinned-spill use-after-free: hand out
    a descriptor, then slam the store until everything unpinned has
    spilled; the pinned block must still hold the original bytes."""
    pinned_oid = _oid()
    payload = serialize(b"precious" * 20_000)       # ~160 KB
    store.put_serialized(pinned_oid, payload)
    desc = store.descriptor_of(pinned_oid)          # pins
    assert desc[0] == "s"
    # fill: enough traffic to spill + reuse every unpinned byte of the
    # arena several times over
    for i in range(40):
        store.put_serialized(_oid(), serialize(bytes([i]) * 150_000))
    entry = store._objects[pinned_oid]
    assert isinstance(entry, ShmEntry), "pinned entry must not be spilled"
    assert bytes(store.arena.view(desc[1], desc[2])) == payload, \
        "pinned block was reallocated under a live descriptor"
    # release: now it may spill
    store.unpin([pinned_oid])
    for i in range(10):
        store.put_serialized(_oid(), serialize(bytes([i]) * 150_000))
    assert isinstance(store._objects[pinned_oid], SpillEntry), \
        "unpinned LRU entry should spill under pressure"
    assert store.get([pinned_oid])[0] == b"precious" * 20_000


def test_unpinned_spill_would_corrupt(store):
    """Sanity check that the pressure pattern above actually reallocates
    blocks when the pin is NOT taken — i.e. the pinned test is load-
    bearing, not vacuously green."""
    oid = _oid()
    payload = serialize(b"precious" * 20_000)
    store.put_serialized(oid, payload)
    entry = store._objects[oid]
    off, size = entry.offset, entry.size            # descriptor, unpinned
    for i in range(40):
        store.put_serialized(_oid(), serialize(bytes([i]) * 150_000))
    assert bytes(store.arena.view(off, size)) != payload, \
        "without a pin the block must get reused by later puts"


def test_delete_while_pinned_defers_free(store):
    oid = _oid()
    store.put_serialized(oid, _payload(50_000))
    desc = store.descriptor_of(oid)
    in_use_before = store.stats()["arena_bytes_in_use"]
    store.delete([oid])
    assert not store.contains(oid)
    # block still allocated: a worker may read it
    assert store.stats()["arena_bytes_in_use"] == in_use_before
    assert deserialize(store.arena.view(desc[1], desc[2])) == b"x" * 50_000
    store.unpin([oid])
    assert store.stats()["arena_bytes_in_use"] == 0


def test_pin_counts_are_per_descriptor(store):
    oid = _oid()
    store.put_serialized(oid, _payload(50_000))
    store.descriptor_of(oid)
    store.descriptor_of(oid)                        # two handouts
    store.unpin([oid])
    assert store._objects[oid].pins == 1
    assert not store._spill_one_locked()            # still pinned
    store.unpin([oid])
    assert store._objects[oid].pins == 0


def test_unpin_with_offset_targets_zombie_not_reput(store):
    """A deleted-while-pinned block and a later re-seal of the SAME object
    id must keep separate pin books: the old descriptor's unpin (keyed by
    offset) frees the zombie and never decrements the new entry."""
    oid = _oid()
    store.put_serialized(oid, _payload(50_000))
    desc_old = store.descriptor_of(oid)
    store.delete([oid])                             # -> zombie, pinned
    store.put_serialized(oid, serialize(b"n" * 60_000))   # re-seal same id
    desc_new = store.descriptor_of(oid)
    assert desc_new[1] != desc_old[1]               # distinct blocks
    store.unpin([(oid, desc_old[1])])               # old descriptor done
    assert not store._zombies                       # zombie freed
    assert store._objects[oid].pins == 1            # new pin untouched
    store.unpin([(oid, desc_new[1])])
    assert store._objects[oid].pins == 0


# -- concurrency stress ----------------------------------------------------

def test_concurrent_put_get_spill_stress(store):
    """Hammer the store from several threads: puts force spills while
    readers re-materialize; every read must be exact."""
    errors = []

    def worker(seed: int):
        try:
            for i in range(30):
                oid = _oid()
                val = bytes([seed]) * (50_000 + i)
                store.put_serialized(oid, serialize(val))
                got = store.get([oid], timeout=10)[0]
                assert got == val, f"corrupt read thread={seed} i={i}"
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(s,)) for s in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors


def test_concurrent_descriptor_pin_stress(store):
    """Descriptor readers race spilling writers; every descriptor view
    must deserialize to its object's exact value while pinned."""
    errors = []
    stop = threading.Event()

    def writer():
        i = 0
        while not stop.is_set():
            store.put_serialized(_oid(), serialize(bytes([i % 256]) * 120_000))
            i += 1

    def reader(seed: int):
        try:
            for i in range(25):
                oid = _oid()
                val = bytes([seed]) * 90_000
                store.put_serialized(oid, serialize(val))
                desc = store.descriptor_of(oid)
                if desc[0] == "s":
                    got = deserialize(bytes(store.arena.view(desc[1],
                                                             desc[2])))
                    store.unpin([oid])
                else:           # restored in-band under pressure
                    got = deserialize(desc[1]) if desc[0] == "b" else desc[1]
                assert got == val, f"corrupt descriptor thread={seed} i={i}"
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    wt = threading.Thread(target=writer)
    wt.start()
    readers = [threading.Thread(target=reader, args=(s,)) for s in range(4)]
    for t in readers:
        t.start()
    for t in readers:
        t.join()
    stop.set()
    wt.join()
    assert not errors, errors


# -- stale-arena reaping ---------------------------------------------------

def test_reap_stale_arenas(tmp_path):
    from ray_tpu_torch.cluster_utils import reap_stale_arenas
    shm = tmp_path / "shm"
    shm.mkdir()
    # dead-owner file (pid 2^22-ish is vanishingly unlikely to be alive)
    dead = shm / "rt_arena_4193999_deadbeef"
    dead.write_bytes(b"\0" * 64)
    # live-owner file (our own pid is skipped)
    live = shm / f"rt_arena_{os.getpid()}_cafecafe"
    live.write_bytes(b"\0" * 64)
    # non-arena file untouched
    other = shm / "unrelated"
    other.write_bytes(b"\0")
    reaped = reap_stale_arenas(str(shm))
    assert reaped == 1
    assert not dead.exists()
    assert live.exists() and other.exists()


# -- end-to-end through the runtime ----------------------------------------

def test_zero_copy_arg_and_result_end_to_end():
    """Large put -> task arg (zero-copy descriptor) -> large result ->
    driver get, through the real cluster runtime."""
    import ray_tpu_torch

    ray_tpu_torch.init(resources={"CPU": 4}, num_workers=2,
                 system_config={"object_store_memory_mb": 32})
    try:
        big = b"q" * 300_000

        @ray_tpu_torch.remote
        def echo_len(x):
            return (len(x), x[:10], x[-10:])

        @ray_tpu_torch.remote
        def make_big(n):
            return b"r" * n

        ref = ray_tpu_torch.put(big)
        n, head, tail = ray_tpu_torch.get(echo_len.remote(ref), timeout=30)
        assert (n, head, tail) == (len(big), big[:10], big[-10:])
        out = ray_tpu_torch.get(make_big.remote(250_000), timeout=30)
        assert out == b"r" * 250_000
        rt = ray_tpu_torch.api._get_runtime()
        assert rt.store.stats()["num_shm"] >= 1
    finally:
        ray_tpu_torch.shutdown()


def test_spill_restore_end_to_end():
    """Put enough large objects to exceed the arena; every one must still
    read back exactly (spill under the configured threshold + restore),
    and worker-side gets of spilled objects must work too."""
    import ray_tpu_torch

    ray_tpu_torch.init(resources={"CPU": 4}, num_workers=2,
                 system_config={"object_store_memory_mb": 2,
                                "object_spilling_threshold": 0.7})
    try:
        refs = [ray_tpu_torch.put(bytes([i]) * 400_000) for i in range(10)]
        rt = ray_tpu_torch.api._get_runtime()
        assert rt.store.stats()["num_spilled"] > 0

        @ray_tpu_torch.remote
        def first_byte(x):
            return x[0]

        outs = ray_tpu_torch.get([first_byte.remote(r) for r in refs],
                                 timeout=60)
        assert outs == list(range(10))
        for i, r in enumerate(refs):
            assert ray_tpu_torch.get(r, timeout=30) == bytes([i]) * 400_000
    finally:
        ray_tpu_torch.shutdown()
