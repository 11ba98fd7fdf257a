"""rtlint — the concurrency & invariant analyzer — and its runtime
lock-order complement, for the port: the reference's
``tests/test_rtlint.py`` run against ``ray_tpu_torch.tools.rtlint``, the
port's live package, and the port's ``common/lockorder.py`` and
``common/locksets.py``.

Three layers, as in the reference:

1. fixture snippets: each rule both FIRES on a violating snippet and
   stays QUIET on the corrected twin (the analyzer's contract);
2. the live package: `ray_tpu_torch lint` must be green (real fixes +
   explicit baseline only) and the static lock digraph acyclic;
3. the dynamic mode: the instrumented lock wrapper observes real
   acquisition order and the cycle check works both ways.

Deviations from the reference file, and no others:

- fixture trees of the path-scoped rules (W5, W6, W8) are named
  ``ray_tpu_torch/...`` and analysed as that package; the live package,
  its config, baseline and recorders are the port's;
- W6 is written for torch, so its fixtures are in torch idiom: each
  pattern (``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()``,
  ``.to("cpu")``, ``torch.cuda.synchronize``, an event's or a stream's
  ``.synchronize()`` and ``.elapsed_time()``, numpy coercion of a
  tensor) fires on a fixture and stays quiet on its corrected twin; the
  port's W6 sites are all inline pragmas, none baselined, so the live
  W6 test holds them to that;
- the live analysis runs once, in the module-scoped fixture ``live``
  (every rule, after clearing the parse cache, which is also the
  single-parse check's first run), and each test takes its rules'
  findings from it: a rule's findings do not depend on the other rules
  run beside it.  A full run costs ~8 s of CPU;
- the CLI: ``python -m ray_tpu_torch lint --format=json`` runs in a
  subprocess once (the gate, exit 0); the new-findings case runs it in a
  subprocess on a copy of the package with one planted W6 finding
  (``--rules=W6``, exit 1) and in-process with ``--no-baseline``; the
  SARIF cases run in-process (``scripts.cli.main``), on the parse cache
  the fixture warmed.

Added: the port's analyzer run with ``package="ray_tpu"`` equals the
reference's ``tools/rtlint`` finding for finding for every rule but W6;
a violation planted under each scoped prefix of a throwaway
``ray_tpu_torch/`` tree fires W3, W5, W6 and W8; the analyzer's own
directory lints clean; the chip's sync attribution
(``tools/rtlint/card_syncs.py``) on recorded observations.

All of this is tier-1: pure AST + threads, no cluster, no JAX, no card.
"""

import json
import os
import shutil
import subprocess
import sys
import textwrap
import threading
import time

import pytest

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO_ROOT) if REPO_ROOT not in sys.path else None

from ray_tpu_torch.common.config import Config as PortConfig  # noqa: E402
from ray_tpu_torch.tools.rtlint import analyzer  # noqa: E402
from ray_tpu_torch.tools.rtlint import baseline as baseline_mod  # noqa: E402
from ray_tpu_torch.tools.rtlint import (card_syncs, rules_knobs,  # noqa: E402
                                        scopes)

PKG = "ray_tpu_torch"
BASELINE = os.path.join(REPO_ROOT, PKG, "tools", "rtlint", "baseline.json")


@pytest.fixture(autouse=True)
def _port_config():
    PortConfig.reset()
    yield
    PortConfig.reset()


@pytest.fixture(scope="module")
def live():
    """Every rule over the live package once: (findings, parses of that
    run, the package's files)."""
    analyzer.clear_cache()
    before = analyzer.parse_count()
    findings = analyzer.run_analysis(REPO_ROOT, PKG)
    files = analyzer.iter_package_files(os.path.join(REPO_ROOT, PKG))
    return findings, analyzer.parse_count() - before, files


def live_check(live, rules=analyzer.ALL_RULES, baseline_path=BASELINE):
    """``analyzer.check`` over the live package, from the fixture's run:
    (new, baselined, stale, all_findings) of ``rules``."""
    findings = [f for f in live[0] if f.rule in rules]
    accepted = baseline_mod.load(baseline_path) if baseline_path else {}
    new, based, stale = baseline_mod.split(findings, accepted)
    return new, based, stale, findings


# -- fixture harness ---------------------------------------------------------

CONFIG_STUB = '''
_CONFIG_DEFS = {
    "used_knob": (int, 1, "a documented, referenced knob"),
    "dead_knob": (int, 2, "defined but never read"),
    "undocumented_knob": (bool, False, ""),
}

def get_config():
    return None
'''


def lint_snippet(tmp_path, source, rules=("W1", "W2", "W3", "W4"),
                 config_defs=CONFIG_STUB):
    """Run the analyzer over one module + a config stub, as a package."""
    pkg = tmp_path / "fixturepkg"
    (pkg / "common").mkdir(parents=True)
    (pkg / "common" / "config.py").write_text(config_defs)
    (pkg / "mod.py").write_text(textwrap.dedent(source))
    findings = analyzer.run_analysis(str(tmp_path), package="fixturepkg",
                                     rules=rules)
    return [f for f in findings if f.rule != "E0"]


def details(findings):
    return [(f.rule, f.detail or f.message) for f in findings]


# -- W1: blocking-call-under-lock -------------------------------------------

class TestW1:
    def test_fires_on_sleep_rpc_join_socket_under_lock(self, tmp_path):
        fs = lint_snippet(tmp_path, '''
            import threading, time

            class Svc:
                def __init__(self, client, sock, thread):
                    self._lock = threading.Lock()
                    self.client = client
                    self.sock = sock
                    self.reader_thread = thread

                def bad_sleep(self):
                    with self._lock:
                        time.sleep(1.0)

                def bad_rpc(self):
                    with self._lock:
                        return self.client.call("stats")

                def bad_result(self):
                    with self._lock:
                        return self.client.call_async("stats").result(5)

                def bad_join(self):
                    with self._lock:
                        self.reader_thread.join(2.0)

                def bad_socket(self):
                    with self._lock:
                        return self.sock.recv(4096)
            ''', rules=("W1",))
        kinds = {d for _, d in details(fs)}
        assert any("time.sleep@" in d for d in kinds), kinds
        assert any(".call@" in d for d in kinds), kinds
        assert any(".result" in d for d in kinds), kinds
        assert any(".join@" in d for d in kinds), kinds
        assert any(".recv@" in d for d in kinds), kinds
        assert len(fs) == 5

    def test_quiet_when_blocking_moved_outside(self, tmp_path):
        fs = lint_snippet(tmp_path, '''
            import threading, time

            class Svc:
                def __init__(self, client):
                    self._lock = threading.Lock()
                    self.client = client
                    self.pending = []

                def good(self):
                    with self._lock:
                        batch = list(self.pending)
                        self.pending.clear()
                    # blocking work AFTER the critical section
                    time.sleep(0.01)
                    return self.client.call("flush", batch)
            ''', rules=("W1",))
        assert fs == []

    def test_cv_wait_idiom_is_quiet_but_foreign_wait_fires(self, tmp_path):
        fs = lint_snippet(tmp_path, '''
            import threading

            class Store:
                def __init__(self, event):
                    self._lock = threading.Lock()
                    self._cv = threading.Condition(self._lock)
                    self._ev = event

                def good_wait(self):
                    with self._cv:
                        self._cv.wait(1.0)

                def good_alias_wait(self):
                    # Condition wraps _lock: waiting RELEASES the lock
                    with self._lock:
                        self._cv.wait(1.0)

                def bad_event_wait(self):
                    with self._lock:
                        self._ev.wait(1.0)
            ''', rules=("W1",))
        ds = details(fs)
        assert len(fs) == 1, ds
        assert "._ev.wait" in ds[0][1]

    def test_interprocedural_one_level(self, tmp_path):
        fs = lint_snippet(tmp_path, '''
            import threading, time

            class Svc:
                def __init__(self):
                    self._lock = threading.Lock()

                def _slow_helper(self):
                    time.sleep(0.5)

                def bad(self):
                    with self._lock:
                        self._slow_helper()
            ''', rules=("W1",))
        assert len(fs) == 1
        assert "via-_slow_helper" in fs[0].detail

    def test_closure_under_lock_is_deferred_not_flagged(self, tmp_path):
        fs = lint_snippet(tmp_path, '''
            import threading, time

            class Svc:
                def __init__(self):
                    self._lock = threading.Lock()

                def ok(self):
                    with self._lock:
                        cb = lambda: time.sleep(1.0)
                        def later():
                            time.sleep(2.0)
                    return cb, later
            ''', rules=("W1",))
        assert fs == []

    def test_inline_suppression(self, tmp_path):
        fs = lint_snippet(tmp_path, '''
            import threading, time

            class Svc:
                def __init__(self):
                    self._wlock = threading.Lock()

                def serialized_write(self, sock, frame):
                    with self._wlock:
                        sock.sendall(frame)    # rtlint: disable=W1
            ''', rules=("W1",))
        assert fs == []


# -- W2: lock-order cycles ---------------------------------------------------

class TestW2:
    def test_fires_on_ab_ba_cycle_with_witnesses(self, tmp_path):
        fs = lint_snippet(tmp_path, '''
            import threading

            class Svc:
                def __init__(self):
                    self._a_lock = threading.Lock()
                    self._b_lock = threading.Lock()

                def path_one(self):
                    with self._a_lock:
                        with self._b_lock:
                            return 1

                def path_two(self):
                    with self._b_lock:
                        with self._a_lock:
                            return 2
            ''', rules=("W2",))
        assert len(fs) == 1
        msg = fs[0].message
        assert "lock-order cycle" in msg
        # both witness paths printed
        assert "path_one" in msg and "path_two" in msg
        assert "Svc._a_lock" in msg and "Svc._b_lock" in msg

    def test_quiet_on_consistent_order(self, tmp_path):
        fs = lint_snippet(tmp_path, '''
            import threading

            class Svc:
                def __init__(self):
                    self._a_lock = threading.Lock()
                    self._b_lock = threading.Lock()

                def path_one(self):
                    with self._a_lock:
                        with self._b_lock:
                            return 1

                def path_two(self):
                    with self._a_lock:
                        with self._b_lock:
                            return 2
            ''', rules=("W2",))
        assert fs == []

    def test_cycle_through_method_call(self, tmp_path):
        fs = lint_snippet(tmp_path, '''
            import threading

            class Svc:
                def __init__(self):
                    self._a_lock = threading.Lock()
                    self._b_lock = threading.Lock()

                def _takes_a(self):
                    with self._a_lock:
                        return 0

                def path_one(self):
                    with self._a_lock:
                        with self._b_lock:
                            return 1

                def path_two(self):
                    with self._b_lock:
                        return self._takes_a()
            ''', rules=("W2",))
        assert len(fs) == 1
        assert "via self._takes_a()" in fs[0].message


# -- W3: config-knob discipline ---------------------------------------------

class TestW3:
    SOURCE = '''
        from .common.config import get_config

        def reads():
            cfg = get_config()
            a = cfg.used_knob
            b = cfg.typo_knob
            c = getattr(cfg, "undocumented_knob", None)
            d = get_config().another_typo
            return a, b, c, d
        '''

    def test_unknown_unused_and_empty_doc(self, tmp_path):
        ds = details(lint_snippet(tmp_path, self.SOURCE, rules=("W3",)))
        assert ("W3", "unknown-knob:typo_knob") in ds
        assert ("W3", "unknown-knob:another_typo") in ds
        assert ("W3", "unused-knob:dead_knob") in ds
        assert ("W3", "empty-doc:undocumented_knob") in ds
        # used_knob is referenced + documented: nothing else fires
        assert len(ds) == 4

    def test_string_literal_counts_as_reference(self, tmp_path):
        fs = lint_snippet(tmp_path, '''
            def dynamic():
                # a to_dict()-driven consumer names the knob as a string
                return ["dead_knob", "used_knob", "undocumented_knob"]
            ''', rules=("W3",))
        assert not any("unused-knob" in d for _, d in details(fs))

    def test_live_defs_parse(self):
        defs = rules_knobs.load_defs(
            os.path.join(REPO_ROOT, PKG, "common", "config.py"))
        assert "scheduler_spread_threshold" in defs
        assert "rtlint_runtime_lock_order" in defs
        assert all(info["doc"].strip() for info in defs.values()), \
            "every live knob must carry a doc string"


# -- W4: thread lifecycle ----------------------------------------------------

class TestW4:
    def test_non_daemon_unjoined_fires(self, tmp_path):
        fs = lint_snippet(tmp_path, '''
            import threading

            def fire_and_forget(fn):
                threading.Thread(target=fn).start()
            ''', rules=("W4",))
        assert len(fs) == 1
        assert "non-daemon" in fs[0].detail

    def test_daemon_or_joined_is_quiet(self, tmp_path):
        fs = lint_snippet(tmp_path, '''
            import threading

            class Svc:
                def start(self, fn):
                    self._t = threading.Thread(target=fn)
                    self._t.start()
                def stop(self):
                    self._t.join(5.0)

            def ok(fn):
                threading.Thread(target=fn, daemon=True).start()
            ''', rules=("W4",))
        assert fs == []

    def test_silent_pump_swallow_fires(self, tmp_path):
        fs = lint_snippet(tmp_path, '''
            import threading

            class Pump:
                def start(self):
                    threading.Thread(target=self._loop, daemon=True).start()

                def _loop(self):
                    while True:
                        try:
                            self._step()
                        except Exception:
                            pass
            ''', rules=("W4",))
        assert len(fs) == 1
        assert "swallow" in fs[0].detail

    def test_logged_handler_is_quiet_and_bare_except_fires(self, tmp_path):
        fs = lint_snippet(tmp_path, '''
            import logging, threading

            class Pump:
                def start(self):
                    threading.Thread(target=self._loop, daemon=True).start()
                    threading.Thread(target=self._bad, daemon=True).start()

                def _loop(self):
                    while True:
                        try:
                            self._step()
                        except Exception:
                            logging.getLogger(__name__).debug(
                                "step failed", exc_info=True)

                def _bad(self):
                    try:
                        self._step()
                    except:
                        pass
            ''', rules=("W4",))
        ds = details(fs)
        assert len(fs) == 1, ds
        assert "swallow:bare" in fs[0].detail

    def test_specific_exception_pass_is_quiet(self, tmp_path):
        fs = lint_snippet(tmp_path, '''
            import threading

            class Pump:
                def start(self):
                    threading.Thread(target=self._loop, daemon=True).start()

                def _loop(self):
                    while True:
                        try:
                            self._step()
                        except (EOFError, OSError):
                            break
            ''', rules=("W4",))
        assert fs == []


# -- the live package --------------------------------------------------------

def _lint(*args, cwd=REPO_ROOT, env=None):
    """``python -m ray_tpu_torch lint ...`` in a subprocess."""
    return subprocess.run(
        [sys.executable, "-m", PKG, "lint", *args], capture_output=True,
        text=True, timeout=300, cwd=cwd, env=env)


def _lint_in_process(capsys, *args):
    """``ray_tpu_torch lint ...`` through the CLI's ``main`` (the parse
    cache the fixture warmed): (exit code, stdout)."""
    from ray_tpu_torch.scripts.cli import main
    capsys.readouterr()
    rc = main(["lint", *args])
    return rc, capsys.readouterr().out


class TestLivePackage:
    def test_lint_green_over_package(self, live):
        """The acceptance gate: real fixes + explicit baseline only."""
        new, based, stale, _ = live_check(live)
        assert new == [], "non-baselined findings:\n" + "\n".join(
            f.format_text() for f in new)
        assert stale == [], f"stale baseline entries: {stale}"

    def test_static_lock_graph_acyclic_and_nonempty(self, live):
        adj = analyzer.lock_graph(REPO_ROOT)
        assert sum(len(v) for v in adj.values()) >= 3, \
            "lock graph suspiciously empty — detection broken?"
        from ray_tpu_torch.tools.rtlint import rules_locks
        assert rules_locks.find_cycles(adj) == []

    def test_cli_json_gate(self):
        """`ray_tpu_torch lint --format=json` is the CI gate: exit 0 +
        valid JSON while green."""
        proc = _lint("--format=json")
        assert proc.returncode == 0, proc.stdout + proc.stderr
        report = json.loads(proc.stdout)
        assert report["counts"]["new"] == 0
        assert report["counts"]["baselined"] >= 1

    def test_cli_nonzero_on_new_findings(self, tmp_path, live, capsys):
        """A new finding must exit 1 — proving the gate actually gates:
        one W6 sync planted in a copy of the package, and the live
        package without its baseline."""
        shutil.copytree(os.path.join(REPO_ROOT, PKG), tmp_path / PKG,
                        ignore=shutil.ignore_patterns(
                            "__pycache__", "build", "csrc", "*.so"))
        (tmp_path / PKG / "ops" / "planted.py").write_text(textwrap.dedent(
            '''
            import torch

            def hidden(t):
                return t.sum().item()
            '''))
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        proc = _lint("--format=json", "--rules=W6", cwd=tmp_path, env=env)
        assert proc.returncode == 1, proc.stdout + proc.stderr
        report = json.loads(proc.stdout)
        assert [(f["path"], f["rule"]) for f in report["new"]] == \
            [(f"{PKG}/ops/planted.py", "W6")]
        rc, out = _lint_in_process(capsys, "--format=json", "--no-baseline")
        assert rc == 1
        report = json.loads(out)
        assert report["counts"]["new"] >= 1

    def test_analyzer_directory_lints_clean(self, live):
        """The package walk includes ``tools/rtlint``: the analyzer's own
        modules carry no finding, baselined or not."""
        own = [f for f in live[0] if f.path.startswith(f"{PKG}/tools/")]
        assert own == [], [f.format_text() for f in own]
        assert any(p.endswith(os.path.join("tools", "rtlint",
                                           "analyzer.py")) for p in live[2])

    def test_baseline_per_rule_within_the_reference(self, live):
        """Per rule, the port's baseline holds no more findings than the
        reference's, at counterpart paths, and none of W2-W4, W6 or W8:
        every W6 site of the port is an inline pragma."""
        ref = baseline_mod.load(os.path.join(REPO_ROOT, "tools", "rtlint",
                                             "baseline.json"))
        port = baseline_mod.load(BASELINE)
        for rule in analyzer.ALL_RULES:
            mine = sorted(v["path"].replace(f"{PKG}/", "ray_tpu/", 1)
                          for v in port.values() if v["rule"] == rule)
            theirs = sorted(v["path"] for v in ref.values()
                            if v["rule"] == rule)
            assert len(mine) <= len(theirs), rule
            assert set(mine) <= set(theirs), rule
        assert not any(v["rule"] in ("W2", "W3", "W4", "W6", "W8")
                       for v in port.values())


# -- held against the reference analyzer -------------------------------------

class TestHeldAgainstReference:
    RULES = ("W1", "W2", "W3", "W4", "W5", "W7", "W8")

    def test_port_analyzer_on_ray_tpu_equals_tools_rtlint(self):
        """Every rule but W6 (rewritten for torch): the port's analyzer
        run on the JAX package is the reference analyzer, finding for
        finding (rule, path, line, message, fingerprint)."""
        from tools.rtlint import analyzer as ref_analyzer

        def rows(findings):
            return [(f.rule, f.path, f.line, f.message, f.fingerprint)
                    for f in findings]

        ref = ref_analyzer.run_analysis(REPO_ROOT, "ray_tpu",
                                        rules=self.RULES)
        port = analyzer.run_analysis(REPO_ROOT, "ray_tpu", rules=self.RULES)
        assert ref, "the reference analyzer found nothing — broken?"
        assert rows(port) == rows(ref)

    @pytest.mark.parametrize("rule,relpath,source", [
        ("W3", "mod.py", '''
            from .common.config import get_config

            def reads():
                return get_config().typo_knob
            '''),
        ("W5", "runtime/mod.py", '''
            import time

            def deadline():
                return time.monotonic() + 5.0
            '''),
        ("W5", "leasing/mod.py", '''
            from ..rpc.client import RpcClient

            def make(addr):
                return RpcClient(addr)
            '''),
        ("W6", "ops/mod.py", '''
            def readback(t):
                return t.cpu()
            '''),
        ("W6", "runtime/raylet.py", '''
            def readback(t):
                return t.sum().item()
            '''),
        ("W8", "sim/mod.py", '''
            import random

            def jitter():
                return random.random()
            '''),
        ("W8", "rpc/chaos.py", '''
            def key(obj):
                return id(obj)
            '''),
    ])
    def test_scopes_are_live_under_the_port(self, tmp_path, rule, relpath,
                                            source):
        """A violation planted under a scoped path of a throwaway
        ``ray_tpu_torch/`` tree fires its rule: the scopes are built from
        the package, so they cannot go silent on the port."""
        pkg = tmp_path / PKG
        (pkg / "common").mkdir(parents=True)
        (pkg / "common" / "config.py").write_text(
            '_CONFIG_DEFS = {"used_knob": (int, 1, "documented")}\n'
            'def get_config():\n    return None\n')
        target = pkg / relpath
        target.parent.mkdir(parents=True, exist_ok=True)
        target.write_text(textwrap.dedent(source))
        fs = analyzer.run_analysis(str(tmp_path), PKG, rules=(rule,))
        fired = [f for f in fs if f.rule == rule and
                 f.path == f"{PKG}/{relpath}"]
        assert len(fired) == 1, [f.format_text() for f in fs]

    def test_every_scope_is_under_the_package(self):
        """Each prefix and file of the scoped rules, built for the port,
        names a path of the port that exists."""
        for rels in (scopes.CLOCK, scopes.TRANSPORT, scopes.SEAMS,
                     scopes.DEVICE, scopes.DEVICE_FILES, scopes.REPLAY,
                     scopes.REPLAY_FILES):
            for p in scopes.under(PKG, rels):
                assert p.startswith(f"{PKG}/")
                assert os.path.exists(os.path.join(REPO_ROOT, p)), p


# -- baseline ratchet --------------------------------------------------------

class TestBaseline:
    def test_update_round_trips_deterministically(self, tmp_path, live):
        findings = live[0]
        p1, p2 = tmp_path / "b1.json", tmp_path / "b2.json"
        baseline_mod.save(str(p1), findings)
        baseline_mod.save(str(p2), list(reversed(findings)))
        assert p1.read_bytes() == p2.read_bytes(), \
            "--update-baseline must be input-order independent"
        # keys sorted
        doc = json.loads(p1.read_text())
        keys = list(doc["findings"])
        assert keys == sorted(keys)
        # and loading back suppresses exactly those findings
        accepted = baseline_mod.load(str(p1))
        new, based, stale = baseline_mod.split(findings, accepted)
        assert new == [] and stale == []
        assert len(based) == len(findings)

    def test_checked_in_baseline_matches_regeneration(self, live):
        """The checked-in file IS what --update-baseline emits today."""
        on_disk = open(BASELINE).read()
        assert on_disk == baseline_mod.render(live[0])

    def test_fingerprint_survives_line_drift(self, tmp_path):
        src = '''
            import threading, time

            class Svc:
                def __init__(self):
                    self._lock = threading.Lock()

                def bad(self):
                    with self._lock:
                        time.sleep(1.0)
            '''
        f1 = lint_snippet(tmp_path / "a", src, rules=("W1",))
        # blank lines shift every statement down without altering indent
        f2 = lint_snippet(tmp_path / "b", "\n\n\n" + src, rules=("W1",))
        assert f1[0].fingerprint == f2[0].fingerprint
        assert f1[0].line != f2[0].line


# -- runtime lock-order mode -------------------------------------------------

class TestRuntimeLockOrder:
    @pytest.fixture(autouse=True)
    def _clean(self):
        from ray_tpu_torch.common import lockorder
        was = lockorder.installed()
        yield
        if not was:
            lockorder.uninstall()
        lockorder.reset()

    def test_config_gate(self):
        from ray_tpu_torch.common import lockorder
        from ray_tpu_torch.common.config import Config
        if lockorder.installed():
            pytest.skip("suite already runs with the recorder installed")
        Config.reset()
        assert lockorder.maybe_install_from_config() is False
        Config.reset(system_config={"rtlint_runtime_lock_order": True})
        assert lockorder.maybe_install_from_config() is True
        assert lockorder.installed()

    def test_observes_real_nesting_and_detects_inversion(self):
        from ray_tpu_torch.common import lockorder
        lockorder.install()
        lockorder.reset()
        # separate lines: lock identity is the allocation site, and two
        # locks born on one line would collapse into a single node
        a = threading.Lock()
        b = threading.Lock()
        with a:
            with b:
                pass
        assert lockorder.find_cycle() is None
        assert len(lockorder.edges()) == 1
        with b:
            with a:
                pass
        cyc = lockorder.find_cycle()
        assert cyc is not None
        with pytest.raises(AssertionError, match="lock-order cycle"):
            lockorder.assert_acyclic()

    def test_condition_wait_does_not_leak_held_state(self):
        """cv.wait() releases the lock: acquisitions made by OTHER
        threads while we wait must not edge off our lock."""
        from ray_tpu_torch.common import lockorder
        lockorder.install()
        lockorder.reset()
        lk = threading.Lock()
        cv = threading.Condition(lk)
        other = threading.Lock()
        hits = []

        def side():
            # runs while main waits; held-stack of THIS thread is empty
            with other:
                hits.append(1)
            with cv:
                cv.notify_all()

        t = threading.Thread(target=side, daemon=True)
        with cv:
            t.start()
            cv.wait(2.0)
        t.join(2.0)
        assert hits == [1]
        # after the wait round-trip our thread can nest again cleanly
        with other:
            pass
        assert lockorder.find_cycle() is None

    def test_rlock_reentry_records_nothing(self):
        from ray_tpu_torch.common import lockorder
        lockorder.install()
        lockorder.reset()
        rl = threading.RLock()
        with rl:
            with rl:
                pass
        assert lockorder.edges() == {}
        assert lockorder.self_edges() == {}

    def test_multithreaded_runtime_workload_stays_acyclic(self):
        """A miniature of what the chaos suite exercises: many threads
        hammering nested-lock structures in one consistent order."""
        from ray_tpu_torch.common import lockorder
        lockorder.install()
        lockorder.reset()

        class Account:
            def __init__(self):
                self.lock = threading.Lock()
                self.bal = 0

        ledger_lock = threading.Lock()
        accounts = [Account() for _ in range(4)]

        def worker(seed):
            for i in range(50):
                acct = accounts[(seed + i) % len(accounts)]
                with ledger_lock:       # global before per-account
                    with acct.lock:
                        acct.bal += 1
                time.sleep(0)

        ts = [threading.Thread(target=worker, args=(k,), daemon=True)
              for k in range(8)]
        [t.start() for t in ts]
        [t.join(10.0) for t in ts]
        assert sum(a.bal for a in accounts) == 8 * 50
        assert lockorder.find_cycle() is None
        lockorder.assert_acyclic()
        # the ledger->account ordering was actually observed
        assert any("ledger" not in a and "ledger" not in b or True
                   for (a, b) in lockorder.edges())
        assert len(lockorder.edges()) >= 1


# -- W5: clock/transport seam discipline -------------------------------------

class TestW5:
    def _lint(self, tmp_path, relpath, source):
        """W5 scopes by real package paths, so fixtures are written
        under a throwaway ``ray_tpu_torch/`` tree."""
        target = tmp_path / relpath
        target.parent.mkdir(parents=True, exist_ok=True)
        target.write_text(textwrap.dedent(source))
        findings = analyzer.run_analysis(
            str(tmp_path), package=PKG, rules=("W5",),
            files=[str(target)])
        return [f for f in findings if f.rule != "E0"]

    def test_fires_on_direct_time_in_runtime(self, tmp_path):
        fs = self._lint(tmp_path, f"{PKG}/runtime/mod.py", '''
            import time
            import time as _time
            from time import sleep

            def deadline():
                return time.monotonic() + 5.0

            def stamp():
                return _time.time()

            def pause():
                sleep(0.1)

            def legal():
                return time.perf_counter()
            ''')
        details = sorted(f.detail for f in fs)
        assert len(fs) == 3, details
        assert any(d.startswith("clock:monotonic@deadline")
                   for d in details), details
        assert any(d.startswith("clock:time@stamp") for d in details)
        assert any(d.startswith("clock:sleep@pause") for d in details)

    def test_fires_on_direct_rpc_ctor_in_runtime(self, tmp_path):
        fs = self._lint(tmp_path, f"{PKG}/runtime/mod.py", '''
            from ..rpc.client import RpcClient
            from ..rpc.server import RpcServer

            def make(addr):
                c = RpcClient(addr)
                s = RpcServer({})
                return c, s
            ''')
        details = sorted(f.detail for f in fs)
        assert len(fs) == 2, details
        assert "transport:RpcClient@make" in details
        assert "transport:RpcServer@make" in details

    def test_quiet_when_routed_through_seams(self, tmp_path):
        fs = self._lint(tmp_path, f"{PKG}/runtime/mod.py", '''
            from ..common import clock as _clk
            from ..rpc import transport as _transport

            def deadline():
                return _clk.monotonic() + 5.0

            def make(addr):
                return _transport.connect(addr)
            ''')
        assert fs == []

    def test_out_of_scope_and_suppressed_sites_quiet(self, tmp_path):
        # outside runtime//rpc/: free to use wall time
        fs = self._lint(tmp_path, f"{PKG}/serve/mod.py", '''
            import time

            def stamp():
                return time.time()
            ''')
        assert fs == []
        # rpc/ ctor use is the transport's own implementation detail
        fs = self._lint(tmp_path, f"{PKG}/rpc/mod.py", '''
            def make(addr):
                return RpcClient(addr)
            ''')
        assert fs == []
        # deliberate wall-clock site, visibly annotated
        fs = self._lint(tmp_path, f"{PKG}/runtime/mod.py", '''
            import time

            def stamp():
                return time.time()  # rtlint: disable=W5
            ''')
        assert fs == []

    def test_live_package_w5_is_baselined_only(self, live):
        """The seam audit itself: no NEW control-plane code bypasses
        the clock/transport seams (worker-subprocess sites are the
        explicit baseline)."""
        new, based, stale, _ = live_check(live, rules=("W5",))
        assert new == [], [f.format_text() for f in new]
        assert all(f.path.endswith("runtime/worker.py") for f in based)


# -- W6: heartbeat host<->device sync discipline ------------------------------

class TestW6:
    def _lint(self, tmp_path, relpath, source):
        """W6 scopes by real package paths (ops/, scheduling/,
        runtime/raylet.py), so fixtures mirror that tree."""
        target = tmp_path / relpath
        target.parent.mkdir(parents=True, exist_ok=True)
        target.write_text(textwrap.dedent(source))
        findings = analyzer.run_analysis(
            str(tmp_path), package=PKG, rules=("W6",),
            files=[str(target)])
        return [f for f in findings if f.rule != "E0"]

    def test_fires_on_explicit_syncs(self, tmp_path):
        fs = self._lint(tmp_path, f"{PKG}/ops/mod.py", '''
            import torch
            from torch.cuda import synchronize

            def fetch(x):
                return x.cpu()

            def stall(dev):
                torch.cuda.synchronize(dev)

            def stall2():
                synchronize()

            def wait(ev):
                ev.synchronize()
            ''')
        details = sorted(f.detail for f in fs)
        assert len(fs) == 4, details
        assert "sync:cpu@fetch" in details
        assert "sync:cuda_synchronize@stall" in details
        assert "sync:cuda_synchronize@stall2" in details
        assert "sync:synchronize@wait" in details

    def test_fires_on_np_coercion_only_of_torch_values(self, tmp_path):
        fs = self._lint(tmp_path, f"{PKG}/scheduling/mod.py", '''
            import numpy as np

            def device_beat(x):
                import torch
                y = torch.as_tensor(x, device="cuda")
                return np.asarray(y)        # implicit sync

            def host_only(v):
                return np.asarray(v)        # plain numpy: legal
            ''')
        details = sorted(f.detail for f in fs)
        assert len(fs) == 1, details
        assert "sync:asarray@device_beat" in details

    # each torch sync pattern: (violating snippet, its kind, corrected twin)
    PATTERNS = {
        "item": ('''
            import torch

            def total(x):
                t = torch.as_tensor(x, device="cuda")
                return t.sum().item()
            ''', '''
            import numpy as np
            import torch

            def total(x):
                t = torch.as_tensor(x, device="cuda")
                return t.sum()                  # stays on the card

            def host_total(v):
                return np.asarray(v).sum().item()   # numpy: host data
            '''),
        "tolist": ('''
            import torch

            def rows(t):
                return torch.nonzero(t).tolist()
            ''', '''
            import numpy as np

            def rows(v):
                a = np.asarray(v)
                return np.nonzero(a)[0].tolist()
            '''),
        "cpu": ('''
            def readback(t):
                return t.cpu()
            ''', '''
            def keep(t):
                return t.clone()
            '''),
        "numpy": ('''
            def view(t):
                return t.numpy()
            ''', '''
            import torch

            def view(a):
                return torch.from_numpy(a)
            '''),
        "to_cpu": ('''
            import torch

            def down(t, u, w):
                return (t.to("cpu"), u.to(torch.device("cpu")),
                        w.to(device="cpu:0"))
            ''', '''
            import torch

            def up(t, u, dev):
                return t.to("cuda"), u.to(torch.device("cuda", 0)), \\
                    t.to(dev, non_blocking=True)
            '''),
        "cuda_synchronize": ('''
            import torch as th

            def barrier():
                th.cuda.synchronize()
            ''', '''
            import torch as th

            def barrier():
                ev = th.cuda.Event()
                ev.record()                 # ordered by the next readback
                return ev
            '''),
        "synchronize": ('''
            import torch

            def fence(stream):
                torch.cuda.current_stream().synchronize()
                stream.synchronize()
            ''', '''
            def fence(ev):
                return ev.query()           # asks, never waits
            '''),
        "elapsed_time": ('''
            def timed(start, stop):
                return start.elapsed_time(stop)
            ''', '''
            import time

            def timed(t0):
                return time.perf_counter() - t0
            '''),
        "array": ('''
            import numpy as np
            import torch

            def copy(x):
                return np.array(torch.as_tensor(x) * 2)
            ''', '''
            import numpy as np

            def copy(x):
                return np.array(np.asarray(x) * 2)
            '''),
    }

    @pytest.mark.parametrize("kind", sorted(PATTERNS))
    def test_torch_pattern_fires_and_twin_is_quiet(self, tmp_path, kind):
        bad, good = self.PATTERNS[kind]
        fs = self._lint(tmp_path / "bad", f"{PKG}/ops/mod.py", bad)
        assert fs, kind
        assert {f.detail.split("@")[0] for f in fs} == {f"sync:{kind}"}, \
            [f.detail for f in fs]
        assert self._lint(tmp_path / "good", f"{PKG}/ops/mod.py",
                          good) == []

    def test_cpu_then_numpy_is_one_finding(self, tmp_path):
        fs = self._lint(tmp_path, f"{PKG}/ops/mod.py", '''
            def readback(t):
                return t.cpu().numpy(), t.to("cpu").numpy()
            ''')
        assert sorted(f.detail for f in fs) == [
            "sync:cpu@readback", "sync:to_cpu@readback"]

    def test_host_data_coercion_is_quiet(self, tmp_path):
        """``policy.py``'s ``np.asarray(group_reqs, np.int32)``: numpy
        coercion of host data (an argument, a list, a numpy array) is not
        a sync."""
        fs = self._lint(tmp_path, f"{PKG}/scheduling/mod.py", '''
            import numpy as np
            import torch

            def beat(group_reqs, counts, dev):
                group_reqs = np.ascontiguousarray(
                    np.asarray(group_reqs, np.int32))
                rows = [1, 2]
                t = torch.as_tensor(group_reqs, device=dev)
                return (np.asarray(counts, np.int32), np.array(rows),
                        np.asarray(group_reqs), t)
            ''')
        assert fs == [], [f.detail for f in fs]

    def test_out_of_scope_and_suppressed_sites_quiet(self, tmp_path):
        # outside ops//scheduling//raylet: free to sync
        fs = self._lint(tmp_path, f"{PKG}/serve/mod.py", '''
            def fetch(x):
                return x.cpu().numpy()
            ''')
        assert fs == []
        # the sanctioned per-beat readback, visibly annotated
        fs = self._lint(tmp_path, f"{PKG}/ops/mod.py", '''
            import numpy as np
            import torch

            def beat(x):
                y = torch.as_tensor(x, device="cuda")
                return np.asarray(y)  # rtlint: disable=W6
            ''')
        assert fs == []

    def test_sites_keep_the_suppressed_ones(self, tmp_path):
        """``rules_device.sites`` returns pragma'd sites too (what the
        card's sync attribution holds observed syncs to), with the
        fingerprints ``scan_file`` gives."""
        from ray_tpu_torch.tools.rtlint import rules_device
        target = tmp_path / PKG / "ops" / "mod.py"
        target.parent.mkdir(parents=True)
        target.write_text(textwrap.dedent('''
            def beat(t, u):
                a = t.cpu()  # rtlint: disable=W6
                return a, u.cpu(), u.item()
            '''))
        ctx = analyzer.get_ctx(str(target), f"{PKG}/ops/mod.py")
        sites = rules_device.sites(ctx, PKG)
        assert [(f.line, quiet) for f, quiet in sites] == \
            [(3, True), (4, False), (4, False)]
        assert [f for f, quiet in sites if not quiet] == \
            rules_device.scan_file(ctx, PKG)

    def test_live_heartbeat_path_w6_is_baselined_only(self, live):
        """The data-path audit itself: every host<->device sync in the
        live heartbeat path is a known, deliberate readback site — in
        the port, each one an inline pragma, none baselined."""
        new, based, stale, _ = live_check(live, rules=("W6",))
        assert new == [], [f.format_text() for f in new]
        assert based == []
        sites = card_syncs.w6_sites(REPO_ROOT)
        assert sites, "expected the sanctioned readback sites"
        assert {s["how"] for s in sites} == {"pragma"}
        # the steady beat's: the counts readback and the staging fence;
        # the profile-mode timers of both engines
        where = {(s["symbol"], s["kind"]) for s in sites}
        assert {("DeltaScheduler._d2h", "cpu"),
                ("DeltaScheduler._wait_slot", "synchronize"),
                ("DeltaScheduler._sync", "cuda_synchronize"),
                ("ShardedDeltaScheduler._sync", "cuda_synchronize")} <= where

    def test_new_knobs_pass_w3(self, live):
        """The delta-beat knobs (scheduler_delta_beats,
        scheduler_delta_max_dirty_fraction) and the sharding knobs
        (scheduler_shards, scheduler_shard_reduce) are documented and
        referenced — W3 stays clean on the live package."""
        new, _based, _stale, _ = live_check(live, rules=("W3",))
        assert new == [], [f.format_text() for f in new]

    def test_sharded_beat_modules_in_scope_with_zero_baseline(self):
        """The shard-reduce plane is inside W6's scope (its paths
        match the ops//scheduling/ prefixes) AND contributes zero
        baseline entries: every sanctioned sync in the new modules is
        inline-annotated, none is grandfathered."""
        new_modules = (f"{PKG}/ops/shard_reduce.py",
                       f"{PKG}/scheduling/sharded_delta.py")
        for mod in new_modules:
            assert os.path.exists(os.path.join(REPO_ROOT, mod))
            assert scopes.in_scope(mod, PKG, scopes.DEVICE)
        accepted = baseline_mod.load(BASELINE)
        for key in accepted:
            assert not any(m in key for m in new_modules), \
                f"grandfathered finding in a new module: {key}"
        # and the scope is live, not vacuous: a sync planted in the
        # module's path fires
        findings = analyzer.run_analysis(
            REPO_ROOT, package=PKG, rules=("W6",),
            files=[os.path.join(REPO_ROOT, m) for m in new_modules])
        assert [f for f in findings if f.rule != "E0"] == [], \
            "new sharded modules must stay sync-free"

    def test_hunt_modules_in_w5_w6_scope_with_zero_baseline(self):
        """The hunt/minimize modules are inside W5's clock-seam
        scope (the search must be a pure function of its seed — no
        wall-clock reads) AND W6's device-sync scope, and contribute
        zero baseline entries."""
        new_modules = (f"{PKG}/sim/hunt.py", f"{PKG}/sim/minimize.py")
        for mod in new_modules:
            assert os.path.exists(os.path.join(REPO_ROOT, mod))
            assert scopes.in_scope(mod, PKG, scopes.CLOCK)
            assert mod in scopes.under(PKG, scopes.DEVICE_FILES)
        accepted = baseline_mod.load(BASELINE)
        for key in accepted:
            assert not any(m in key for m in new_modules), \
                f"grandfathered finding in a new module: {key}"
        # live, not vacuous: the modules pass W5+W6 as they stand
        findings = analyzer.run_analysis(
            REPO_ROOT, package=PKG, rules=("W5", "W6"),
            files=[os.path.join(REPO_ROOT, m) for m in new_modules])
        assert [f for f in findings if f.rule != "E0"] == [], \
            "hunt/minimize must stay clock- and sync-free"

    def test_budget_beat_modules_in_w5_w6_scope_with_zero_baseline(self):
        """The budget-emission seam — the CPU oracle twin in
        contract.py and the beat->grantor board — is inside W6's
        device-sync scope, the board additionally inside W5's
        clock-seam scope (leasing/ prefix), and contributes zero
        grandfathered baseline entries: budgets ride the beat's one
        sanctioned readback, they never add a sync or a clock read."""
        board = f"{PKG}/leasing/board.py"
        contract = f"{PKG}/scheduling/contract.py"
        for mod in (board, contract):
            assert os.path.exists(os.path.join(REPO_ROOT, mod))
            assert scopes.in_scope(mod, PKG, scopes.DEVICE)
        assert scopes.in_scope(board, PKG, scopes.CLOCK)
        accepted = baseline_mod.load(BASELINE)
        for key in accepted:
            assert board not in key and contract not in key, \
                f"grandfathered finding in a budget module: {key}"
        # live, not vacuous: both pass W5+W6 as they stand
        findings = analyzer.run_analysis(
            REPO_ROOT, package=PKG, rules=("W5", "W6"),
            files=[os.path.join(REPO_ROOT, m) for m in (board, contract)])
        assert [f for f in findings if f.rule != "E0"] == [], \
            "budget seam must stay clock- and sync-free"

    def test_versioning_modules_in_scope_with_zero_baseline(self):
        """The model-version plane (``versioning/``) is inside W5's
        clock-seam scope (rollout timings must go through the seam so
        the sim twin replays) AND W6's device-sync scope, and
        contributes zero grandfathered baseline entries."""
        new_modules = (f"{PKG}/versioning/registry.py",
                       f"{PKG}/versioning/rollout.py",
                       f"{PKG}/versioning/phases.py")
        for mod in new_modules:
            assert os.path.exists(os.path.join(REPO_ROOT, mod))
            assert scopes.in_scope(mod, PKG, scopes.CLOCK)
            assert scopes.in_scope(mod, PKG, scopes.DEVICE)
        accepted = baseline_mod.load(BASELINE)
        for key in accepted:
            assert f"{PKG}/versioning/" not in key, \
                f"grandfathered finding in a new module: {key}"
        # live, not vacuous: the package passes W5+W6 as it stands
        findings = analyzer.run_analysis(
            REPO_ROOT, package=PKG, rules=("W5", "W6"),
            files=[os.path.join(REPO_ROOT, m) for m in new_modules])
        assert [f for f in findings if f.rule != "E0"] == [], \
            "versioning plane must stay clock- and sync-free"

    def test_train_modules_in_w5_w6_scope_with_zero_baseline(self):
        """The elastic training plane — the live controller and its
        simulator twin — is inside W5's clock-seam scope (restart and
        drain timings must go through the seam so goodput accounting
        replays) AND W6's device-sync scope, and contributes zero
        grandfathered baseline entries."""
        new_modules = (f"{PKG}/train/elastic.py", f"{PKG}/sim/train.py")
        for mod in new_modules:
            assert os.path.exists(os.path.join(REPO_ROOT, mod))
            assert scopes.in_scope(mod, PKG, scopes.CLOCK)
            assert mod in scopes.under(PKG, scopes.DEVICE_FILES)
        accepted = baseline_mod.load(BASELINE)
        for key in accepted:
            assert not any(m in key for m in new_modules), \
                f"grandfathered finding in a new module: {key}"
        # live, not vacuous: both pass W5+W6 as they stand
        findings = analyzer.run_analysis(
            REPO_ROOT, package=PKG, rules=("W5", "W6"),
            files=[os.path.join(REPO_ROOT, m) for m in new_modules])
        assert [f for f in findings if f.rule != "E0"] == [], \
            "elastic training plane must stay clock- and sync-free"


# -- W7: lockset race detection ----------------------------------------------

class TestW7:
    def test_fires_with_both_witness_paths(self, tmp_path):
        fs = lint_snippet(tmp_path, '''
            import threading

            class Svc:
                def __init__(self):
                    self._lock = threading.Lock()
                    self.count = 0

                def bump(self):
                    self.count += 1

                def read(self):
                    return self.count
            ''', rules=("W7",))
        assert len(fs) == 1, details(fs)
        f = fs[0]
        assert f.detail == "race:Svc.count"
        # both witness access paths in the message
        assert "bump" in f.message and "read" in f.message
        assert "write at" in f.message
        assert "holding no lock" in f.message

    def test_quiet_when_guarded_by_one_lock(self, tmp_path):
        fs = lint_snippet(tmp_path, '''
            import threading

            class Svc:
                def __init__(self):
                    self._lock = threading.Lock()
                    self.count = 0

                def bump(self):
                    with self._lock:
                        self.count += 1

                def read(self):
                    with self._lock:
                        return self.count
            ''', rules=("W7",))
        assert fs == []

    def test_fires_on_thread_target_vs_api(self, tmp_path):
        fs = lint_snippet(tmp_path, '''
            import threading

            class Pump:
                def __init__(self):
                    self._lock = threading.Lock()
                    self.beats = 0
                    self._t = threading.Thread(target=self._loop,
                                               daemon=True)

                def _loop(self):
                    self.beats += 1

                def stats(self):
                    with self._lock:
                        return self.beats
            ''', rules=("W7",))
        assert len(fs) == 1, details(fs)
        assert "thread target" in fs[0].message

    def test_fires_on_timer_callback_context(self, tmp_path):
        fs = lint_snippet(tmp_path, '''
            import threading

            class Beat:
                def __init__(self, clk):
                    self._lock = threading.Lock()
                    self.ticks = 0
                    clk.call_later(1.0, self._tick)

                def _tick(self):
                    self.ticks += 1

                def read(self):
                    with self._lock:
                        return self.ticks
            ''', rules=("W7",))
        assert len(fs) == 1, details(fs)
        assert "timer callback" in fs[0].message

    def test_fires_on_escaped_handler_context(self, tmp_path):
        fs = lint_snippet(tmp_path, '''
            import threading

            class Handlers:
                def __init__(self, server):
                    self._lock = threading.Lock()
                    self.hits = 0
                    server.register({"hit": self._on_hit})

                def _on_hit(self):
                    self.hits += 1

                def read(self):
                    with self._lock:
                        return self.hits
            ''', rules=("W7",))
        assert len(fs) == 1, details(fs)
        assert "registered callback" in fs[0].message

    def test_locked_helper_propagation_is_quiet(self, tmp_path):
        """One-level interprocedural: a write inside a private helper
        called with the lock held inherits the caller's lockset."""
        fs = lint_snippet(tmp_path, '''
            import threading

            class Svc:
                def __init__(self):
                    self._lock = threading.Lock()
                    self.count = 0

                def _bump_locked(self):
                    self.count += 1

                def bump(self):
                    with self._lock:
                        self._bump_locked()

                def read(self):
                    with self._lock:
                        return self.count
            ''', rules=("W7",))
        assert fs == []

    def test_nonblocking_acquire_try_finally_is_locked(self, tmp_path):
        """The tick() idiom: acquire(blocking=False) + try/finally is
        a critical section even without a with-block."""
        fs = lint_snippet(tmp_path, '''
            import threading

            class Ticker:
                def __init__(self):
                    self._lock = threading.Lock()
                    self.ticks = 0

                def tick(self):
                    if not self._lock.acquire(blocking=False):
                        return
                    try:
                        self.ticks += 1
                    finally:
                        self._lock.release()

                def read(self):
                    with self._lock:
                        return self.ticks
            ''', rules=("W7",))
        assert fs == []

    def test_condition_aliasing_same_lock_is_quiet(self, tmp_path):
        """Condition(self._lock) IS self._lock for lockset purposes."""
        fs = lint_snippet(tmp_path, '''
            import threading

            class Q:
                def __init__(self):
                    self._lock = threading.Lock()
                    self._cv = threading.Condition(self._lock)
                    self.depth = 0

                def put(self):
                    with self._cv:
                        self.depth += 1
                        self._cv.notify()

                def drain(self):
                    with self._lock:
                        self.depth = 0
            ''', rules=("W7",))
        assert fs == []

    def test_assign_once_immutable_publish_is_quiet(self, tmp_path):
        """__init__-only writes are the immutable-publish escape."""
        fs = lint_snippet(tmp_path, '''
            import threading

            class Frozen:
                def __init__(self, rows):
                    self._lock = threading.Lock()
                    self.rows = tuple(rows)

                def read(self):
                    return self.rows

                def also_read(self):
                    return len(self.rows)
            ''', rules=("W7",))
        assert fs == []

    def test_lockless_class_out_of_scope(self, tmp_path):
        """W7 only audits classes that own at least one lock (the W1
        scope rule): plain single-threaded state holders stay quiet."""
        fs = lint_snippet(tmp_path, '''
            class Bag:
                def __init__(self):
                    self.n = 0

                def bump(self):
                    self.n += 1

                def read(self):
                    return self.n
            ''', rules=("W7",))
        assert fs == []

    def test_inline_suppression(self, tmp_path):
        fs = lint_snippet(tmp_path, '''
            import threading

            class Gauge:
                def __init__(self):
                    self._lock = threading.Lock()
                    self.hits = 0

                def bump(self):
                    # deliberately racy monotonic gauge
                    self.hits += 1  # rtlint: disable=W7

                def read(self):
                    with self._lock:
                        return self.hits
            ''', rules=("W7",))
        assert fs == []


# -- W8: replay-determinism discipline ----------------------------------------

class TestW8:
    def _lint(self, tmp_path, relpath, source):
        """W8 scopes by real package paths (sim/, chaos, the routed
        entropy seams), so fixtures mirror that tree."""
        target = tmp_path / relpath
        target.parent.mkdir(parents=True, exist_ok=True)
        target.write_text(textwrap.dedent(source))
        findings = analyzer.run_analysis(
            str(tmp_path), package=PKG, rules=("W8",),
            files=[str(target)])
        return [f for f in findings if f.rule != "E0"]

    def test_fires_on_global_stream_draws(self, tmp_path):
        fs = self._lint(tmp_path, f"{PKG}/sim/mod.py", '''
            import os
            import random
            import uuid
            import numpy as np
            from random import randint

            def draws():
                a = random.random()
                b = np.random.rand(3)
                c = uuid.uuid4()
                d = os.urandom(8)
                e = randint(0, 9)
                return a, b, c, d, e
            ''')
        ds = sorted(f.detail for f in fs)
        assert len(fs) == 5, ds
        assert any(d.startswith("entropy:random.random@") for d in ds)
        assert any(d.startswith("entropy:np.random.rand@") for d in ds)
        assert any(d.startswith("entropy:uuid.uuid4@") for d in ds)
        assert any(d.startswith("entropy:os.urandom@") for d in ds)
        assert any(d.startswith("entropy:random.randint@") for d in ds)

    def test_quiet_on_injected_seeded_streams(self, tmp_path):
        fs = self._lint(tmp_path, f"{PKG}/sim/mod.py", '''
            import random
            import numpy as np

            def sanctioned(seed):
                rng = random.Random(seed)
                gen = np.random.Generator(np.random.Philox(key=[seed]))
                return rng.random(), gen.random(4), rng.randint(0, 9)
            ''')
        assert fs == []

    def test_fires_on_id_and_hash(self, tmp_path):
        fs = self._lint(tmp_path, f"{PKG}/sim/mod.py", '''
            def keys(obj, name):
                return id(obj), hash(name)
            ''')
        ds = sorted(f.detail for f in fs)
        assert len(fs) == 2, ds
        assert any(d.startswith("identity:id@") for d in ds)
        assert any(d.startswith("identity:hash@") for d in ds)

    def test_fires_on_set_iteration_feeding_consumers(self, tmp_path):
        fs = self._lint(tmp_path, f"{PKG}/sim/mod.py", '''
            PENDING = {"a", "b", "c"}

            def schedule(emit):
                for name in PENDING:
                    emit(name)

            def through_list(emit):
                for name in list(PENDING):
                    emit(name)

            def comprehended():
                return [n.upper() for n in PENDING]
            ''')
        assert len(fs) == 3, sorted(f.detail for f in fs)
        assert all(d.startswith("setiter:") for _, d in details(fs))

    def test_sorted_and_setcomp_and_dict_are_quiet(self, tmp_path):
        fs = self._lint(tmp_path, f"{PKG}/sim/mod.py", '''
            PENDING = {"a", "b", "c"}
            TABLE = {"x": 1}

            def sorted_loop(emit):
                for name in sorted(PENDING):
                    emit(name)

            def sorted_genexp():
                return sorted(n.upper() for n in PENDING)

            def to_set():
                return {n.upper() for n in PENDING}

            def dict_loop(emit):
                # plain dicts are insertion-ordered: legal
                for k, v in TABLE.items():
                    emit(k, v)
            ''')
        assert fs == [], details(fs)

    def test_out_of_scope_and_suppressed_sites_quiet(self, tmp_path):
        # outside sim scope: free to draw
        fs = self._lint(tmp_path, f"{PKG}/serve/mod.py", '''
            import random

            def jitter():
                return random.random()
            ''')
        assert fs == []
        # deliberate process-local identity, visibly annotated
        fs = self._lint(tmp_path, f"{PKG}/sim/mod.py", '''
            def pace_key(sock):
                return id(sock)  # rtlint: disable=W8
            ''')
        assert fs == []


# -- W7/W8 over the live package ---------------------------------------------

class TestW7W8LivePackage:
    def test_w7_green_and_satellite_files_unbaselined(self, live):
        """The race fixes are real fixes, not baseline entries: the
        serve/loaning/metrics counters and the other files the
        reference repaired contribute ZERO grandfathered W7 findings."""
        new, based, stale, _ = live_check(live, rules=("W7",))
        assert new == [], [f.format_text() for f in new]
        assert based, "W7 found nothing on the live package — broken?"
        fixed = (f"{PKG}/serve/loaning.py", f"{PKG}/serve/gossip.py",
                 f"{PKG}/serve/router.py",
                 f"{PKG}/scheduling/cluster_resources.py",
                 f"{PKG}/runtime/runtime_env.py",
                 f"{PKG}/runtime/job_manager.py")
        for f in based:
            assert f.path not in fixed, \
                f"grandfathered W7 in a repaired file: {f.fingerprint}"

    def test_w8_green_with_zero_baseline(self, live):
        """Every W8 finding was FIXED (entropy routed through seams,
        set iterations sorted) or inline-justified — none
        grandfathered."""
        new, based, stale, _ = live_check(live, rules=("W8",))
        assert new == [], [f.format_text() for f in new]
        assert based == [], [f.fingerprint for f in based]
        accepted = baseline_mod.load(BASELINE)
        assert not any(k.startswith("W8:") for k in accepted)


# -- runtime lockset recorder -------------------------------------------------

class TestRuntimeLocksets:
    @pytest.fixture(autouse=True)
    def _clean(self):
        from ray_tpu_torch.common import locksets
        was = locksets.installed()
        yield
        if not was:
            locksets.uninstall()
        locksets.reset()

    def test_config_gate(self):
        from ray_tpu_torch.common import locksets
        from ray_tpu_torch.common.config import Config
        if locksets.installed():
            pytest.skip("suite already runs with the recorder installed")
        Config.reset()
        assert locksets.maybe_install_from_config() is False
        Config.reset(system_config={"rtlint_runtime_locksets": True})
        assert locksets.maybe_install_from_config() is True
        assert locksets.installed()

    def test_seeded_race_detected(self):
        from ray_tpu_torch.common import locksets

        @locksets.track("x", "y")
        class Box:
            def __init__(self):
                self._lock = threading.Lock()
                self.x = 0
                self.y = 0

            def locked_bump(self):
                with self._lock:
                    self.x += 1
                    self.y += 1

            def racy_bump(self):
                self.x += 1     # the seeded race

        locksets.install()
        locksets.reset()
        b = Box()
        t1 = threading.Thread(
            target=lambda: [b.locked_bump() for _ in range(100)])
        t2 = threading.Thread(
            target=lambda: [b.racy_bump() for _ in range(100)])
        t1.start(); t2.start(); t1.join(5.0); t2.join(5.0)
        v = locksets.violations()
        assert any("Box.x" in s for s in v), v
        assert not any("Box.y" in s for s in v), v
        with pytest.raises(AssertionError, match="empty-lockset"):
            locksets.assert_no_races()

    def test_clean_class_stays_quiet(self):
        from ray_tpu_torch.common import locksets

        @locksets.track("n")
        class Clean:
            def __init__(self):
                self._lock = threading.Lock()
                self.n = 0

            def bump(self):
                with self._lock:
                    self.n += 1

        locksets.install()
        locksets.reset()
        c = Clean()
        ts = [threading.Thread(
            target=lambda: [c.bump() for _ in range(100)])
            for _ in range(4)]
        [t.start() for t in ts]
        [t.join(5.0) for t in ts]
        assert c.n == 400
        assert locksets.violations() == []
        locksets.assert_no_races()

    def test_init_writes_are_immutable_publish(self):
        """Constructor writes never sample: assign-once publish stays
        quiet even when another thread writes later WITH the lock."""
        from ray_tpu_torch.common import locksets

        @locksets.track("rows")
        class Pub:
            def __init__(self, rows):
                self._lock = threading.Lock()
                self.rows = tuple(rows)     # unlocked: __init__ only

            def replace(self, rows):
                with self._lock:
                    self.rows = tuple(rows)

        locksets.install()
        locksets.reset()
        p = Pub([1, 2])
        t = threading.Thread(target=lambda: p.replace([3]))
        t.start(); t.join(5.0)
        p.replace([4])
        # two threads wrote, but all SAMPLED writes held the lock
        assert locksets.violations() == []

    def test_tracked_serve_boards_register(self):
        """The live serve boards opted in: constructing them under the
        recorder samples their counters (clean single-threaded use)."""
        from ray_tpu_torch.common import locksets
        from ray_tpu_torch.serve.gossip import LoadBoard
        locksets.install()
        locksets.reset()
        board = LoadBoard()
        board.fold("base", {0: {b"k": 1}}, {b"k"})
        assert board.folds == 1
        assert locksets.violations() == []


# -- SARIF output -------------------------------------------------------------

class TestSarif:
    def _run(self, capsys, *extra):
        rc, out = _lint_in_process(capsys, "--format=sarif", *extra)
        return rc, json.loads(out)

    def test_green_run_emits_suppressed_baseline(self, live, capsys):
        rc, doc = self._run(capsys)
        assert rc == 0
        assert doc["version"] == "2.1.0"
        run = doc["runs"][0]
        assert run["tool"]["driver"]["name"] == "rtlint"
        rule_ids = {r["id"] for r in run["tool"]["driver"]["rules"]}
        assert {"W7", "W8"} <= rule_ids
        results = run["results"]
        assert results, "baselined findings must still be emitted"
        for r in results:
            assert r["suppressions"][0]["kind"] == "external"
            assert r["level"] == "note"
            assert r["partialFingerprints"]["rtlint/v1"]
            loc = r["locations"][0]["physicalLocation"]
            assert loc["artifactLocation"]["uri"].startswith(f"{PKG}/")

    def test_no_baseline_run_emits_warnings(self, live, capsys):
        rc, doc = self._run(capsys, "--no-baseline", "--rules=W7")
        assert rc == 1
        results = doc["runs"][0]["results"]
        assert results
        for r in results:
            assert r["level"] == "warning"
            assert "suppressions" not in r


# -- AST cache: single parse per file -----------------------------------------

class TestAstCache:
    def test_full_run_parses_each_file_once(self, live):
        findings, parses, files = live
        assert parses == len(files), \
            f"{parses} parses for {len(files)} files — cache broken"
        # a second full run re-parses NOTHING (content unchanged)
        before = analyzer.parse_count()
        assert analyzer.run_analysis(REPO_ROOT, PKG) == findings
        assert analyzer.parse_count() == before

    def test_cache_invalidates_on_content_change(self, tmp_path):
        mod = tmp_path / "fixturepkg" / "mod.py"
        mod.parent.mkdir(parents=True)
        (mod.parent / "common").mkdir()
        (mod.parent / "common" / "config.py").write_text(CONFIG_STUB)
        mod.write_text("x = 1\n")
        analyzer.run_analysis(str(tmp_path), package="fixturepkg",
                              rules=("W4",))
        before = analyzer.parse_count()
        analyzer.run_analysis(str(tmp_path), package="fixturepkg",
                              rules=("W4",))
        assert analyzer.parse_count() == before     # warm hit
        mod.write_text("x = 2\n")
        analyzer.run_analysis(str(tmp_path), package="fixturepkg",
                              rules=("W4",))
        assert analyzer.parse_count() == before + 1  # re-parsed once


# -- the card's syncs held to W6, on recorded observations -------------------

class TestCardSyncs:
    """``card_syncs.hold`` on observations shaped as ``observe`` returns
    them (the profiler's spans in microseconds) against the live W6
    sites: the attribution ``chip_smoke.py``'s beat phase runs, without
    the card."""

    @pytest.fixture(scope="class")
    def sites(self):
        return card_syncs.w6_sites(REPO_ROOT)

    @staticmethod
    def _site(sites, symbol, kind):
        (site,) = [s for s in sites
                   if s["symbol"] == symbol and s["kind"] == kind]
        return site

    @staticmethod
    def _def_line(path, symbol):
        from ray_tpu_torch.tools.rtlint import rules_device
        ctx = analyzer.get_ctx(os.path.join(REPO_ROOT, path), path)
        (line,) = [n.lineno for n, q in
                   rules_device._qualname_index(ctx.tree).items()
                   if q == symbol]
        return line

    def _frames(self, path, *symbols):
        """Nested frames of ``symbols``, outermost first, each inside the
        last."""
        return [(100 + 10 * i, 900 - 10 * i, path,
                 self._def_line(path, sym), sym.split(".")[-1])
                for i, sym in enumerate(symbols)]

    @staticmethod
    def _obs(syncs, frames, warned=None, ccalls=(), steps=((0, 1000),)):
        return {"calls": 1, "warned": dict(warned or {}),
                "syncs": list(syncs), "frames": list(frames),
                "ccalls": list(ccalls), "steps": list(steps),
                "runtime_calls": {"cudaLaunchKernelExC": 3}}

    def test_readback_falls_on_the_d2h_line(self, sites):
        d2h = self._site(sites, "DeltaScheduler._d2h", "cpu")
        path = d2h["path"]
        line = f"{path}:{d2h['line']}"
        obs = self._obs(
            [(500, 520, "cudaStreamSynchronize")],
            self._frames(path, "DeltaScheduler.beat",
                         "DeltaScheduler._d2h"),
            warned={line: 1}, ccalls=[(490, 525, "cpu")])
        rep = card_syncs.hold(obs, sites, REPO_ROOT)
        assert rep["ok"], rep
        assert rep["syncs"] == 1 and rep["syncs_per_call"] == 1.0
        assert rep["by_site"] == {line: {"count": 1, "how": "pragma"}}
        assert rep["by_call"] == {"cudaStreamSynchronize": 1}

    def test_fence_and_profile_timers_fall_on_their_pragmas(self, sites):
        fence = self._site(sites, "DeltaScheduler._wait_slot",
                           "synchronize")
        timer = self._site(sites, "DeltaScheduler._sync",
                           "cuda_synchronize")
        path = fence["path"]
        obs = self._obs(
            [(500, 510, "cudaEventSynchronize")],
            self._frames(path, "DeltaScheduler._upload",
                         "DeltaScheduler._h2d",
                         "DeltaScheduler._wait_slot")
            # torch's own Python frame around the call: not the package
            + [(495, 515, "torch/cuda/streams.py", 200, "synchronize")])
        rep = card_syncs.hold(obs, sites, REPO_ROOT)
        assert rep["ok"], rep
        assert list(rep["by_site"]) == [f"{path}:{fence['line']}"]
        obs = self._obs([(500, 510, "cudaDeviceSynchronize")],
                        self._frames(path, "DeltaScheduler._phase",
                                     "DeltaScheduler._sync"))
        rep = card_syncs.hold(obs, sites, REPO_ROOT)
        assert rep["ok"], rep
        assert list(rep["by_site"]) == [f"{path}:{timer['line']}"]

    def test_sync_that_w6_does_not_see_fails(self, sites):
        """A stream sync in a package function with no W6 site of its
        kind (an H2D copy from pageable memory, say) is unattributed."""
        path = f"{PKG}/scheduling/policy.py"
        obs = self._obs([(500, 510, "cudaStreamSynchronize")],
                        self._frames(path, "DeltaScheduler._put"))
        rep = card_syncs.hold(obs, sites, REPO_ROOT)
        assert not rep["ok"]
        assert rep["unattributed"] == [
            f"cudaStreamSynchronize in {path}"
            f"({self._def_line(path, 'DeltaScheduler._put')}): "
            "DeltaScheduler._put"]

    def test_warned_line_that_is_no_site_fails(self, sites):
        d2h = self._site(sites, "DeltaScheduler._d2h", "cpu")
        stray = f"{d2h['path']}:{d2h['line'] - 1}"
        rep = card_syncs.hold(self._obs([], [], warned={stray: 1}),
                              sites, REPO_ROOT)
        assert not rep["ok"] and rep["unsanctioned"] == [stray]
        assert rep["syncs"] == 0

    def test_new_site_is_unsanctioned(self, sites):
        d2h = self._site(sites, "DeltaScheduler._d2h", "cpu")
        new = [dict(s, how="new") if s is d2h else s for s in sites]
        path = d2h["path"]
        obs = self._obs([(500, 520, "cudaStreamSynchronize")],
                        self._frames(path, "DeltaScheduler._d2h"))
        rep = card_syncs.hold(obs, new, REPO_ROOT)
        assert not rep["ok"]
        assert rep["unsanctioned"] == [f"{path}:{d2h['line']}"]

    def test_outside_the_package_fails_and_between_steps_is_ignored(
            self, sites):
        obs = self._obs([(500, 510, "cudaDeviceSynchronize"),
                         (1500, 1510, "cudaDeviceSynchronize")],
                        [(400, 600, "chip_smoke.py", 10, "step")])
        rep = card_syncs.hold(obs, sites, REPO_ROOT)
        assert not rep["ok"] and rep["syncs"] == 1
        assert rep["unattributed"] == [
            "cudaDeviceSynchronize outside the package"]

    def test_a_run_without_runtime_calls_is_not_ok(self, sites):
        obs = dict(self._obs([], []), runtime_calls={})
        assert not card_syncs.hold(obs, sites, REPO_ROOT)["ok"]

    def test_frame_names_parse(self):
        pat = card_syncs._frame_pattern(PKG)
        for name in (f"{PKG}/scheduling/policy.py(389): beat",
                     f"/x/y/{PKG}/scheduling/policy.py(389): beat"):
            m = pat.search(name)
            assert m.groups() == (f"{PKG}/scheduling/policy.py", "389",
                                  "beat")
        assert pat.search("torch/cuda/streams.py(200): synchronize") is None
