"""W7 per-class lockset race detection (Eraser/RacerD tradition).

For every class that owns at least one lock (the same W1 scope that
makes it a shared-mutable object by its own declaration), compute which
``self._attr`` reads/writes occur under which ``with self._lock``
regions, then flag attributes that are written from one thread-reachable
context and touched from a second one with an EMPTY lockset
intersection — the Eraser criterion: no single lock consistently
guards the data.

What counts as a thread-reachable entry point:

- a method passed as a ``Thread(target=...)`` — a pump thread;
- a method reference that ESCAPES (``self._handle`` stored in a handler
  dict, registered as a clock ``call_later`` callback, passed to any
  registrar) — RPC handlers and timer callbacks run on other threads;
- every public method — the API surface is callable from any thread
  (dispatcher beats, ``/metrics`` scrape threads, test fixtures);
- functions decorated ``@pytest.fixture`` (conftest-known fixtures
  drive class methods from the pytest runner thread).

Each entry point is its own *context*.  Accesses are propagated through
the intra-class call graph (``self.m()`` under lock L credits every
access in ``m`` with L — the same one-level discipline W1/W2 use,
iterated to a fixed point, which also covers the ``*_locked``-suffix
helper convention: a helper only ever invoked under the lock inherits
it at every call site).  ``lock.acquire()``/``release()`` pairs inside
one method body (the non-reentrant ``tick()`` idiom) are tracked
linearly: statements after the acquire and before the release hold the
lock.

Escape hatches:

- **immutable publish**: an attribute only ever assigned in
  ``__init__`` (assign-once ``tuple``/config/handle wiring) never
  fires — construction is single-threaded;
- reads/writes on a line carrying ``# rtlint: disable=W7`` are dropped
  (the place to justify a deliberately-racy monotonic gauge);
- a ``# rtlint: disable=W7`` on the ``class`` line exempts the whole
  class.

Findings carry BOTH witness access paths (method, line, locks held) so
the reader sees the two racing stacks, not just the attribute name.
"""

from __future__ import annotations

import ast
import re

from .finding import Finding
from . import rules_locks

# receiver-method names that mutate the receiver in place: a call
# ``self._attr.append(x)`` is a WRITE to the shared structure
_MUTATORS = {
    "append", "appendleft", "extend", "insert", "remove", "discard",
    "pop", "popleft", "popitem", "clear", "update", "setdefault",
    "add", "sort", "reverse",
}

# timer/callback registrars whose function argument runs on another
# thread (the shared clock's timer wheel, pubsub, executor submits)
_REGISTRARS = {"call_later", "call_at", "submit", "subscribe",
               "register", "add_done_callback"}


class _Access:
    __slots__ = ("attr", "write", "lockset", "method", "line")

    def __init__(self, attr, write, lockset, method, line):
        self.attr = attr
        self.write = write
        self.lockset = lockset      # frozenset of lock ids held
        self.method = method
        self.line = line


class _MethodSummary:
    __slots__ = ("name", "accesses", "calls", "lineno")

    def __init__(self, name, lineno):
        self.name = name
        self.lineno = lineno
        self.accesses: list[_Access] = []
        # (callee_name, frozenset(held), line)
        self.calls: list[tuple] = []


def _suppressed(ctx, lineno) -> bool:
    line = ctx.lines[lineno - 1] if 0 < lineno <= len(ctx.lines) else ""
    m = re.search(r"rtlint:\s*disable=([\w,]+)", line)
    return bool(m and ("W7" in m.group(1).split(",") or
                       "all" in m.group(1).split(",")))


def _is_fixture_decorated(fn) -> bool:
    for dec in fn.decorator_list:
        d = dec.func if isinstance(dec, ast.Call) else dec
        if rules_locks._terminal_name(d) == "fixture":
            return True
    return False


class _ClassScan:
    """Lockset bookkeeping for one class definition."""

    def __init__(self, ctx, cls_node, lockpass):
        self.ctx = ctx
        self.cls = cls_node
        self.lockpass = lockpass        # rules_locks._FilePass (lock ids)
        self.methods: dict[str, _MethodSummary] = {}
        # entry method name -> kind ("thread" | "timer" | "callback" |
        # "api" | "fixture")
        self.entries: dict[str, str] = {}
        self.lock_attrs = set(lockpass.class_locks.get(cls_node.name, ()))
        self.lock_attrs |= set(lockpass.class_alias.get(cls_node.name, ()))

    # -- collection ----------------------------------------------------------

    def collect(self):
        for node in self.cls.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                summ = _MethodSummary(node.name, node.lineno)
                self.methods[node.name] = summ
                self._visit_stmts(node.body, summ, held=[])
                if not node.name.startswith("_") or \
                        _is_fixture_decorated(node):
                    kind = "fixture" if _is_fixture_decorated(node) \
                        else "api"
                    if not node.name.startswith("__"):
                        self.entries.setdefault(node.name, kind)
        self._collect_escapes()

    def _collect_escapes(self):
        """Method references that leave the object: Thread targets,
        timer callbacks, handler-dict values, registrar arguments."""
        for node in ast.walk(self.cls):
            if not isinstance(node, ast.Call):
                continue
            fname = rules_locks._terminal_name(node.func)
            refs = []
            for arg in list(node.args) + [kw.value for kw in node.keywords]:
                refs.extend(self._method_refs(arg))
            if not refs:
                continue
            if fname == "Thread":
                kind = "thread"
            elif fname in ("call_later", "call_at"):
                kind = "timer"
            else:
                kind = "callback"
            for m in refs:
                # thread/timer beats a plain callback classification
                if kind == "thread" or m not in self.entries or \
                        self.entries[m] == "api":
                    self.entries[m] = kind

    def _method_refs(self, expr):
        """``self.m`` references inside ``expr`` (incl. dict values)."""
        out = []
        for node in ast.walk(expr) if isinstance(expr, ast.AST) else ():
            if isinstance(node, ast.Attribute) and \
                    isinstance(node.value, ast.Name) and \
                    node.value.id == "self" and \
                    isinstance(node.ctx, ast.Load) and \
                    node.attr in {m.name for m in self.cls.body
                                  if isinstance(m, (ast.FunctionDef,
                                                    ast.AsyncFunctionDef))}:
                out.append(node.attr)
        return out

    # -- per-method statement walk ------------------------------------------

    def _lock_id(self, expr):
        return self.lockpass.lock_id(expr, self.cls.name)

    def _visit_stmts(self, stmts, summ, held):
        """Linear scan so ``lock.acquire()`` mid-block extends the
        lockset for the REMAINING statements (tick()-style critical
        sections that cannot use ``with``)."""
        pushed = 0
        for st in stmts:
            acq = self._acquire_in(st)
            self._visit_stmt(st, summ, held)
            if acq is not None:
                held.append(acq)
                pushed += 1
            rel = self._release_in(st)
            if rel is not None and held and held[-1] == rel and pushed:
                held.pop()
                pushed -= 1
        for _ in range(pushed):
            held.pop()

    def _acquire_in(self, st):
        """Lock id acquired by this statement (``x.acquire(...)`` in an
        expression statement or an ``if`` test), else None.  A guarded
        early return (``if not lock.acquire(): return``) still means
        the rest of the block runs WITH the lock."""
        for node in self._own_exprs(st):
            for call in rules_locks._walk_pruned(node):
                if isinstance(call, ast.Call) and \
                        isinstance(call.func, ast.Attribute) and \
                        call.func.attr == "acquire":
                    lid = self._lock_id(call.func.value)
                    if lid is not None:
                        return lid
        return None

    def _release_in(self, st):
        for node in self._own_exprs(st):
            for call in rules_locks._walk_pruned(node):
                if isinstance(call, ast.Call) and \
                        isinstance(call.func, ast.Attribute) and \
                        call.func.attr == "release":
                    lid = self._lock_id(call.func.value)
                    if lid is not None:
                        return lid
        return None

    def _own_exprs(self, st):
        for field, value in ast.iter_fields(st):
            if field in ("body", "orelse", "finalbody", "handlers"):
                continue
            yield from rules_locks._iter_exprs(value)

    def _visit_stmt(self, st, summ, held):
        if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef,
                           ast.Lambda, ast.ClassDef)):
            return          # deferred bodies: not this critical section
        if isinstance(st, (ast.With, ast.AsyncWith)):
            acquired = []
            for item in st.items:
                lid = self._lock_id(item.context_expr)
                if lid is not None:
                    acquired.append(lid)
                else:
                    self._scan_expr(item.context_expr, summ, held)
                if item.optional_vars is not None:
                    self._scan_expr(item.optional_vars, summ, held)
            held.extend(acquired)
            self._visit_stmts(st.body, summ, held)
            for _ in acquired:
                held.pop()
            return
        # finally-blocks run with the same locks the try body holds
        for field in ("body", "orelse", "finalbody"):
            sub = getattr(st, field, None)
            if sub:
                self._visit_stmts(sub, summ, list(held))
        for h in getattr(st, "handlers", []):
            self._visit_stmts(h.body, summ, list(held))
        # assignment targets: writes
        if isinstance(st, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
            targets = st.targets if isinstance(st, ast.Assign) else \
                [st.target]
            for t in targets:
                self._record_target(t, summ, held)
            value = st.value
            if value is not None:
                self._scan_expr(value, summ, held)
            if isinstance(st, ast.AugAssign):
                # x += 1 also READS x; the Store record above covers the
                # write — the read shares its lockset, nothing to add
                pass
            return
        if isinstance(st, ast.Delete):
            for t in st.targets:
                self._record_target(t, summ, held)
            return
        for expr in self._own_exprs(st):
            self._scan_expr(expr, summ, held)

    def _record_target(self, t, summ, held):
        if isinstance(t, (ast.Tuple, ast.List)):
            for e in t.elts:
                self._record_target(e, summ, held)
            return
        if isinstance(t, ast.Attribute) and \
                isinstance(t.value, ast.Name) and t.value.id == "self":
            self._record(t.attr, True, summ, held, t.lineno)
            return
        if isinstance(t, ast.Subscript):
            # self._x[k] = v mutates the structure self._x refers to
            v = t.value
            if isinstance(v, ast.Attribute) and \
                    isinstance(v.value, ast.Name) and v.value.id == "self":
                self._record(v.attr, True, summ, held, t.lineno)
                self._scan_expr(t.slice, summ, held)
                return
        self._scan_expr(t, summ, held)

    def _scan_expr(self, expr, summ, held):
        if expr is None or not isinstance(expr, ast.AST):
            return
        for node in rules_locks._walk_pruned(expr):
            if isinstance(node, ast.Call):
                f = node.func
                if isinstance(f, ast.Attribute) and \
                        isinstance(f.value, ast.Name) and \
                        f.value.id == "self":
                    # self.m(...): intra-class call edge
                    summ.calls.append((f.attr, frozenset(held),
                                       node.lineno))
                elif isinstance(f, ast.Attribute) and \
                        f.attr in _MUTATORS and \
                        isinstance(f.value, ast.Attribute) and \
                        isinstance(f.value.value, ast.Name) and \
                        f.value.value.id == "self":
                    # self._x.append(...): in-place write
                    self._record(f.value.attr, True, summ, held,
                                 node.lineno)
            elif isinstance(node, ast.Attribute) and \
                    isinstance(node.value, ast.Name) and \
                    node.value.id == "self" and \
                    isinstance(node.ctx, ast.Load):
                if not self._is_call_func(node, expr) and \
                        not self._is_mutator_receiver(node, expr):
                    self._record(node.attr, False, summ, held,
                                 node.lineno)

    def _is_call_func(self, attr_node, root):
        for node in ast.walk(root):
            if isinstance(node, ast.Call) and node.func is attr_node:
                return True
        return False

    def _is_mutator_receiver(self, attr_node, root):
        for node in ast.walk(root):
            if isinstance(node, ast.Call) and \
                    isinstance(node.func, ast.Attribute) and \
                    node.func.value is attr_node and \
                    node.func.attr in _MUTATORS:
                return True
        return False

    def _record(self, attr, write, summ, held, line):
        if attr in self.lock_attrs or rules_locks._LOCKY.search(attr):
            return          # the locks themselves are not shared data
        if _suppressed(self.ctx, line):
            return
        summ.accesses.append(_Access(attr, write, frozenset(held),
                                     summ.name, line))

    # -- reachability + the Eraser check -------------------------------------

    def findings(self) -> list[Finding]:
        if _suppressed(self.ctx, self.cls.lineno):
            return []
        if not self.lockpass.class_locks.get(self.cls.name):
            return []       # lock-free class: outside W7 scope
        # context -> list of (access, eff_lockset)
        per_attr: dict[str, list] = {}
        for entry, kind in sorted(self.entries.items()):
            for meth, extra in self._reachable(entry):
                summ = self.methods.get(meth)
                if summ is None:
                    continue
                for acc in summ.accesses:
                    eff = acc.lockset | extra
                    per_attr.setdefault(acc.attr, []).append(
                        ((entry, kind), acc, eff))
        out = []
        for attr in sorted(per_attr):
            recs = per_attr[attr]
            writes = [r for r in recs if r[1].write]
            if not writes:
                continue    # immutable publish / read-only: quiet
            contexts = {r[0] for r in recs}
            if len(contexts) < 2:
                continue    # single entry context: no concurrency shown
            inter = None
            for _, _, eff in recs:
                inter = set(eff) if inter is None else inter & eff
            if inter:
                continue    # one lock consistently guards every access
            w = min(writes, key=lambda r: (bool(r[1].lockset),
                                           r[1].line))
            other = self._second_witness(recs, w)
            if other is None:
                continue
            out.append(self._finding(attr, w, other))
        return out

    def _second_witness(self, recs, w):
        """An access from a DIFFERENT context whose lockset is disjoint
        from the write's (the pair that actually races)."""
        best = None
        for r in recs:
            if r[0] == w[0]:
                continue
            if not (r[2] & w[2]):
                if best is None or (best[1].write < r[1].write):
                    best = r        # prefer a write/write witness
        return best

    def _reachable(self, entry):
        """(method, locks-held-at-entry) states reachable from one
        entry point through the intra-class call graph."""
        seen = set()
        stack = [(entry, frozenset())]
        while stack:
            meth, held = stack.pop()
            if (meth, held) in seen:
                continue
            seen.add((meth, held))
            yield meth, held
            summ = self.methods.get(meth)
            if summ is None:
                continue
            for callee, call_held, _line in summ.calls:
                if callee in self.methods and callee != "__init__":
                    stack.append((callee, held | call_held))

    def _finding(self, attr, w, other) -> Finding:
        (wentry, wkind), wacc, wlocks = w
        (oentry, okind), oacc, olocks = other
        cls = self.cls.name

        def fmt(entry, kind, acc, locks):
            via = f"{cls}.{acc.method}" if acc.method != entry else \
                f"{cls}.{entry}"
            reach = {"thread": "thread target", "timer": "timer callback",
                     "callback": "registered callback", "api": "public API",
                     "fixture": "pytest fixture"}[kind]
            lk = ", ".join(sorted(locks)) if locks else "no lock"
            tail = f" (reached from {cls}.{entry}, a {reach})" \
                if acc.method != entry else f" (a {reach})"
            return (f"{'write' if acc.write else 'read'} at "
                    f"{self.ctx.path}:{acc.line} in {via}{tail} "
                    f"holding {lk}")

        return Finding(
            rule="W7", path=self.ctx.path, line=wacc.line,
            symbol=f"{cls}.{wacc.method}",
            message=(f"`self.{attr}` is shared between thread-reachable "
                     f"contexts with no common lock: "
                     f"{fmt(wentry, wkind, wacc, wlocks)}; "
                     f"{fmt(oentry, okind, oacc, olocks)}"),
            hint=(f"guard every access with the same lock (e.g. the "
                  f"class's own), or publish an immutable snapshot; a "
                  f"deliberately-racy monotonic gauge gets "
                  f"`# rtlint: disable=W7` with a justification"),
            detail=f"race:{cls}.{attr}")


def scan_file(ctx, lockpass=None) -> list[Finding]:
    """W7 over one file.  ``lockpass`` reuses the W1/W2 walk's lock
    discovery (Condition aliasing, class/module lock ids) when the
    analyzer already ran it; otherwise a fresh pass is made."""
    if lockpass is None:
        lockpass = rules_locks._FilePass(ctx)
        lockpass.collect_lock_attrs()
    out: list[Finding] = []
    for node in ast.walk(ctx.tree):
        if isinstance(node, ast.ClassDef):
            scan = _ClassScan(ctx, node, lockpass)
            scan.collect()
            out.extend(scan.findings())
    return out
