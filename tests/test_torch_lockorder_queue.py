"""The port's lock-order recorder (``common/lockorder.py``) and
actor-backed queue (``util/queue.py``) against the JAX package's, and
the port's two runtime recorders installed around a serve workload.

Scenario sources: ``TestRuntimeLockOrder`` in ``tests/test_rtlint.py``,
``TestQueue`` and the queue regression in
``tests/test_util_pool_queue.py``, and the recorder fixtures of
``tests/conftest.py`` (which install the JAX package's recorders; the
port's are installed here, by ``_port_recorders``).  Each lock-order
case runs under one package's recorder at a time (each patches
``threading.Lock``), and each queue case once through each package's
runtime (the port with ``scheduler_device="cpu"``); the port must give
exactly what the reference gives, down to the cycle of a seeded lock
inversion.
"""

import importlib
import threading
import time

import pytest

from ray_tpu.common.config import Config as RefConfig
from ray_tpu_torch.common import lockorder as port_lockorder
from ray_tpu_torch.common import locksets as port_locksets
from ray_tpu_torch.common.config import Config as PortConfig

PKGS = ("ray_tpu", "ray_tpu_torch")


def _install_recorders():
    """Install the port's recorders whose knobs are on; returns which."""
    return (port_lockorder.maybe_install_from_config(),
            port_locksets.maybe_install_from_config())


def _check_recorders(installed):
    """After a test: the observed lock-order digraph is acyclic and no
    tracked attribute was written from two threads under disjoint
    locksets; then both recorders forget what they saw."""
    lock_order, lock_sets = installed
    try:
        if lock_order:
            port_lockorder.assert_acyclic()
        if lock_sets:
            port_locksets.assert_no_races()
    finally:
        port_lockorder.reset()
        port_locksets.reset()


@pytest.fixture(autouse=True)
def _port_recorders():
    """The port's runtime recorders for every test of this file when
    their knobs are on (``RT_RTLINT_RUNTIME_LOCK_ORDER=1``,
    ``RT_RTLINT_RUNTIME_LOCKSETS=1``); off by default."""
    PortConfig.reset()
    installed = _install_recorders()
    yield
    _check_recorders(installed)
    PortConfig.reset()


# -- lock order ------------------------------------------------------------------

def _inversion(lockorder):
    lockorder.reset()
    # one lock per line: a lock's identity is its allocation site
    a = threading.Lock()
    b = threading.Lock()
    with a:
        with b:
            pass
    before = lockorder.find_cycle()
    n_edges = len(lockorder.edges())
    with b:
        with a:
            pass
    cycle = lockorder.find_cycle()
    try:
        lockorder.assert_acyclic()
        message = None
    except AssertionError as e:
        message = str(e)
    return before, n_edges, cycle, message


def _condition_wait(lockorder):
    lockorder.reset()
    lk = threading.Lock()
    cv = threading.Condition(lk)
    other = threading.Lock()
    hits = []

    def side():
        with other:
            hits.append(1)
        with cv:
            cv.notify_all()

    t = threading.Thread(target=side, daemon=True)
    with cv:
        t.start()
        cv.wait(2.0)
    t.join(2.0)
    with other:
        pass
    return hits, lockorder.find_cycle()


def _rlock_reentry(lockorder):
    lockorder.reset()
    rl = threading.RLock()
    with rl:
        with rl:
            pass
    return lockorder.edges(), lockorder.self_edges()


def _consistent_order(lockorder):
    lockorder.reset()
    ledger = threading.Lock()
    accounts = [[threading.Lock(), 0] for _ in range(4)]

    def worker(seed):
        for i in range(50):
            acct = accounts[(seed + i) % len(accounts)]
            with ledger:
                with acct[0]:
                    acct[1] += 1
            time.sleep(0)

    ts = [threading.Thread(target=worker, args=(k,), daemon=True)
          for k in range(8)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(10.0)
    return (sum(a[1] for a in accounts), lockorder.find_cycle(),
            len(lockorder.edges()))


def _config_gate(name, lockorder):
    config = importlib.import_module(f"{name}.common.config").Config
    try:
        config.reset()
        off = lockorder.maybe_install_from_config()
        config.reset({"rtlint_runtime_lock_order": True})
        on = lockorder.maybe_install_from_config()
        return off, on, lockorder.installed()
    finally:
        config.reset()


def _under(name, case):
    """``case`` with package ``name``'s recorder the only one installed
    (each patches ``threading.Lock``); the recorders installed before
    (by ``tests/conftest.py``, then by ``_port_recorders``) come back
    after, in that order."""
    mods = {n: importlib.import_module(f"{n}.common.lockorder")
            for n in PKGS}
    was = {n: m.installed() for n, m in mods.items()}
    if case is _config_gate and any(was.values()):
        pytest.skip("a recorder is already installed for the suite")
    for m in mods.values():
        m.uninstall()
    lockorder = mods[name]
    try:
        if case is _config_gate:
            return case(name, lockorder)
        lockorder.install()
        return case(lockorder)
    finally:
        lockorder.uninstall()
        lockorder.reset()
        for n in PKGS:
            if was[n]:
                mods[n].install()


@pytest.mark.parametrize("case", [_inversion, _condition_wait,
                                  _rlock_reentry, _consistent_order,
                                  _config_gate],
                         ids=lambda c: c.__name__.strip("_"))
def test_lock_order_as_the_reference(case):
    want = _under("ray_tpu", case)
    got = _under("ray_tpu_torch", case)
    assert got == want
    if case is _inversion:
        before, n_edges, cycle, message = got
        assert before is None and n_edges == 1
        assert cycle is not None and len(set(cycle)) == 2
        assert "lock-order cycle" in message
    if case is _consistent_order:
        assert got[:2] == (400, None)


def test_tracked_locks_answer_what_the_stdlib_asks():
    """Built while the recorder is installed, the stdlib's own locks are
    the recorder's: Python 3.12's multiprocessing resource tracker asks
    its RLock for ``_recursion_count()`` on every spawn, and
    ``concurrent.futures.thread`` registers its lock's
    ``_at_fork_reinit`` at import.  (The JAX package's copy lacks both:
    ROADMAP C, found in the reference.)"""
    mods = {n: importlib.import_module(f"{n}.common.lockorder")
            for n in PKGS}
    was = {n: m.installed() for n, m in mods.items()}
    for m in mods.values():
        m.uninstall()
    port_lockorder.install()
    try:
        rl = threading.RLock()
        counts = [rl._recursion_count()]
        with rl:
            with rl:
                counts.append(rl._recursion_count())
        counts.append(rl._recursion_count())
        lk = threading.Lock()
        lk.acquire()
        lk._at_fork_reinit()
        reinit = lk.locked()
    finally:
        port_lockorder.uninstall()
        port_lockorder.reset()
        for n in PKGS:
            if was[n]:
                mods[n].install()
    assert counts == [0, 2, 0] and reinit is False


# -- the queue ---------------------------------------------------------------------

def fifo_across_processes(p):
    rt, q = p.rt, p.queue.Queue()
    try:
        @rt.remote
        def producer(q, n):
            for i in range(n):
                q.put(i)
            return "done"

        @rt.remote
        def consumer(q, n):
            return [q.get(timeout=30) for _ in range(n)]

        pr, co = producer.remote(q, 5), consumer.remote(q, 5)
        return rt.get(pr, timeout=60), rt.get(co, timeout=60)
    finally:
        q.shutdown()


def nowait_and_exceptions(p):
    q = p.queue.Queue(maxsize=1)
    try:
        out = [q.put_nowait("a")]
        for bad in (lambda: q.put_nowait("b"), lambda: None):
            try:
                bad()
            except p.queue.Full:
                out.append("Full")
        out += [q.full(), q.qsize(), q.get_nowait(), q.empty()]
        try:
            q.get_nowait()
        except p.queue.Empty:
            out.append("Empty")
        return out
    finally:
        q.shutdown()


def blocking_get_wakes_on_put(p):
    q = p.queue.Queue()
    try:
        got = []
        t = threading.Thread(target=lambda: got.append(q.get(timeout=30)))
        t.start()
        time.sleep(0.2)
        q.put("wake")
        t.join(timeout=30)
        try:
            q.get(timeout=0.3)
            timed_out = None
        except p.queue.Empty:
            timed_out = "Empty"
        return got, timed_out
    finally:
        q.shutdown()


def batches_are_atomic(p):
    q = p.queue.Queue(maxsize=3)
    try:
        q.put_nowait("x")
        out = []
        try:
            q.put_nowait_batch(["a", "b", "c"])
        except p.queue.Full:
            out.append(("Full", q.qsize()))
        q.put_nowait_batch(["a", "b"])
        out.append(q.qsize())
        try:
            q.get_nowait_batch(4)
        except p.queue.Empty:
            out.append(("Empty", q.qsize()))
        out.append(q.get_nowait_batch(3))
        return out
    finally:
        q.shutdown()


QUEUE_CASES = [fifo_across_processes, nowait_and_exceptions,
               blocking_get_wakes_on_put, batches_are_atomic]


class _Pkg:
    def __init__(self, name):
        self.rt = importlib.import_module(name)
        self.queue = importlib.import_module(f"{name}.util.queue")


@pytest.fixture(scope="module")
def queue_runs():
    out = {}
    for name in PKGS:
        p = _Pkg(name)
        port = name == "ray_tpu_torch"
        p.rt.init(resources={"CPU": 4, "memory": 4}, num_workers=2,
                  system_config={"scheduler_device": "cpu"}
                  if port else None)
        res = out[name] = {}
        try:
            for case in QUEUE_CASES:
                try:
                    res[case.__name__] = case(p)
                except Exception as e:      # noqa: BLE001 — compared
                    res[case.__name__] = e
        finally:
            p.rt.shutdown()
            (PortConfig if port else RefConfig).reset()
    return out


@pytest.mark.parametrize("case", QUEUE_CASES, ids=lambda c: c.__name__)
def test_queue_as_the_reference(queue_runs, case):
    want = queue_runs["ray_tpu"][case.__name__]
    got = queue_runs["ray_tpu_torch"][case.__name__]
    if isinstance(want, Exception):
        raise want
    if isinstance(got, Exception):
        raise got
    assert got == want


def test_queue_cases_show_fifo_and_bounds(queue_runs):
    got = queue_runs["ray_tpu_torch"]
    assert got["fifo_across_processes"] == ("done", [0, 1, 2, 3, 4])
    assert got["nowait_and_exceptions"] == [None, "Full", True, 1, "a",
                                            True, "Empty"]
    assert got["blocking_get_wakes_on_put"] == (["wake"], "Empty")
    assert got["batches_are_atomic"] == [("Full", 1), 3, ("Empty", 3),
                                         ["x", "a", "b"]]


# -- both recorders around a serve workload ---------------------------------------

def test_recorders_see_an_acyclic_serve_workload():
    """Both knobs on, both recorders installed before ``init`` (they
    instrument only what is built after), a serve deployment under
    concurrent callers: the observed lock order is acyclic and the
    tracked attributes race-free (checked by ``_check_recorders``)."""
    import ray_tpu_torch as rt
    from ray_tpu_torch import serve
    was = port_lockorder.installed(), port_locksets.installed()
    PortConfig.reset({"scheduler_device": "cpu",
                      "rtlint_runtime_lock_order": True,
                      "rtlint_runtime_locksets": True})
    installed = _install_recorders()
    assert installed == (True, True)
    port_lockorder.reset()
    rt.init(resources={"CPU": 4, "memory": 4}, num_workers=2,
            system_config={"scheduler_device": "cpu",
                           "rtlint_runtime_lock_order": True,
                           "rtlint_runtime_locksets": True})
    try:
        @serve.deployment(num_replicas=2, max_ongoing_requests=2)
        class Echo:
            def __call__(self, x):
                return x + 1

        handle = serve.run(Echo.bind())
        out = {}

        def client(k):
            out[k] = rt.get([handle.remote(10 * k + i) for i in range(5)],
                            timeout=60)

        ts = [threading.Thread(target=client, args=(k,)) for k in range(4)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(60)
        assert out == {k: [10 * k + i + 1 for i in range(5)]
                       for k in range(4)}
        serve.shutdown()
    finally:
        rt.shutdown()
    # the recorder saw the runtime's nesting, and found no cycle
    assert port_lockorder.edges()
    assert port_lockorder.find_cycle() is None
    _check_recorders(installed)
    if not was[0]:
        port_lockorder.uninstall()
    if not was[1]:
        port_locksets.uninstall()
