"""W1 blocking-call-under-lock and W2 lock-order-cycle.

Both rules share one walk.  Lock identity is what makes the graph
meaningful across files:

- ``self._lock`` / ``cls._lock`` inside class ``C``  ->  ``C._lock``
- module-global ``_lock``                            ->  ``mod.<name>``
- anything else lock-shaped (``handle._lock``)       ->  ``?.<attr>``

``?.``-ids participate in W1 (a blocking call under ANY lock is the
bug) but are excluded from the W2 digraph: merging every ``._lock`` of
unknown class into one node would fabricate cycles.

The walk never descends into nested ``def``/``lambda`` while holding a
lock: a closure body defined under a lock runs later, on some other
thread, not inside the critical section.

W2 is one level interprocedural: ``self.m()`` called while holding A
contributes A -> L for every lock L that method ``m`` of the same class
acquires directly.  Deeper chains are deliberately out of scope (the
runtime lock-order recorder covers what static analysis can't see).
"""

from __future__ import annotations

import ast
import re

from .finding import Finding

# attribute / variable names that read as locks even without seeing the
# threading.Lock() assignment (constructor-injected locks etc.)
_LOCKY = re.compile(r"(lock|mutex)$|(^|_)(cv|cond)$", re.IGNORECASE)

_LOCK_FACTORIES = {"Lock", "RLock", "Condition", "Semaphore",
                   "BoundedSemaphore"}

# receivers whose .join() blocks (threads / processes / queues), vs the
# ubiquitous str.join / os.path.join
_JOINABLE = re.compile(
    r"thread|proc|reader|pump|worker|ticker|monitor|queue", re.IGNORECASE)

# project-native wire-level blocking functions (rpc/wire.py)
_BLOCKING_FUNCS = {"send_frame", "recv_reply", "recv_exact",
                   "send_raw_reply", "recv_frame", "sleep"}

_SOCKET_METHODS = {"recv", "recv_into", "recvmsg", "recv_bytes", "accept",
                   "connect", "connect_ex", "sendall", "sendmsg"}

_HINTS = {
    "rpc": ("snapshot the needed state under the lock, release it, then "
            "issue the RPC (as DeploymentHandle._refresh does)"),
    "sleep": "sleep outside the critical section (or use cv.wait(timeout))",
    "join": "join after releasing the lock; the dying thread may need it",
    "socket": ("do socket I/O outside the lock, or baseline it if this "
               "lock IS the connection's write-serializer"),
    "wait": ("waiting on an event while holding an unrelated lock stalls "
             "every contender; wait first, then take the lock"),
}


def _terminal_name(node: ast.AST) -> str:
    """Best-effort rightmost identifier of an expression."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Call):
        return _terminal_name(node.func)
    if isinstance(node, ast.Subscript):
        return _terminal_name(node.value)
    return ""


def _is_lock_factory(call: ast.AST) -> bool:
    if not isinstance(call, ast.Call):
        return False
    f = call.func
    if isinstance(f, ast.Attribute) and f.attr in _LOCK_FACTORIES:
        return True
    if isinstance(f, ast.Name) and f.id in _LOCK_FACTORIES:
        return True
    return False


def _expr_repr(node: ast.AST) -> str:
    try:
        return ast.unparse(node)
    except Exception:       # pragma: no cover - unparse is total on 3.9+
        return _terminal_name(node)


class _FilePass:
    def __init__(self, ctx):
        self.ctx = ctx
        self.findings: list[Finding] = []
        # W2 exports
        self.edges: list[tuple] = []        # (src, dst, path, line, qual, via)
        self.method_acquires: dict[tuple, set] = {}   # (cls, meth) -> {lockid}
        self.calls_under_lock: list[tuple] = []       # (cls, meth, held, line, qual)
        self._counts: dict[tuple, int] = {}           # fingerprint de-dup index
        self.class_locks: dict[str, dict] = {}
        self.class_alias: dict[str, dict] = {}        # Condition(self.X) wraps X
        self.module_locks: set[str] = set()
        # (cls, meth) -> [(cat, desc, line)] blocking calls NOT under any
        # lock inside that method — W1's one-level call propagation
        self.method_blocking: dict[tuple, list] = {}

    # -- lock attribute discovery -------------------------------------------

    def collect_lock_attrs(self):
        tree = self.ctx.tree
        for node in tree.body:
            if isinstance(node, ast.Assign) and _is_lock_factory(node.value):
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        self.module_locks.add(t.id)
        for cls in ast.walk(tree):
            if not isinstance(cls, ast.ClassDef):
                continue
            attrs = self.class_locks.setdefault(cls.name, {})
            alias = self.class_alias.setdefault(cls.name, {})
            for node in ast.walk(cls):
                if isinstance(node, ast.Assign) and \
                        _is_lock_factory(node.value):
                    for t in node.targets:
                        if isinstance(t, ast.Attribute) and \
                                isinstance(t.value, ast.Name) and \
                                t.value.id in ("self", "cls"):
                            attrs[t.attr] = True
                        elif isinstance(t, ast.Name):
                            # class-body assignment: ``_lock = Lock()``
                            attrs[t.id] = True
                    # ``self._cv = Condition(self._lock)``: the condition
                    # IS the lock — one node, and cv.wait() under
                    # ``with self._lock`` is the idiom, not a violation
                    v = node.value
                    if _terminal_name(v.func) == "Condition" and v.args \
                            and isinstance(v.args[0], ast.Attribute) and \
                            isinstance(v.args[0].value, ast.Name) and \
                            v.args[0].value.id == "self":
                        for t in node.targets:
                            if isinstance(t, ast.Attribute):
                                alias[t.attr] = v.args[0].attr

    # -- lock identification -------------------------------------------------

    def lock_id(self, expr: ast.AST, cls_name: str | None) -> str | None:
        """Stable id of a lock-shaped ``with`` item, or None."""
        if isinstance(expr, ast.Attribute) and \
                isinstance(expr.value, ast.Name) and \
                expr.value.id in ("self", "cls"):
            attr = expr.attr
            if cls_name:
                attr = self.class_alias.get(cls_name, {}).get(attr, attr)
            known = cls_name and attr in self.class_locks.get(cls_name, {})
            if known or _LOCKY.search(attr):
                return f"{cls_name}.{attr}" if cls_name else f"?.{attr}"
            return None
        if isinstance(expr, ast.Name):
            if expr.id in self.module_locks or _LOCKY.search(expr.id):
                return f"{self.ctx.module}.{expr.id}"
            return None
        if isinstance(expr, ast.Attribute) and _LOCKY.search(expr.attr):
            return f"?.{expr.attr}"        # W1-only identity
        return None

    # -- blocking-call classification ---------------------------------------

    def classify_blocking(self, call: ast.Call, held: list[tuple],
                          cls_name: str | None = None):
        """Return (category, description) if ``call`` blocks, else None.

        ``held`` is the stack of (lock_id, with_expr_src) currently held.
        """
        f = call.func
        if isinstance(f, ast.Name):
            if f.id in _BLOCKING_FUNCS:
                cat = "sleep" if f.id == "sleep" else "socket"
                return cat, f.id
            return None
        if not isinstance(f, ast.Attribute):
            return None
        attr = f.attr
        recv = f.value
        recv_name = _terminal_name(recv)
        if attr == "sleep" and recv_name == "time":
            return "sleep", "time.sleep"
        if attr == "select" and recv_name == "select":
            return "socket", "select.select"
        if attr == "call":
            return "rpc", f"{_expr_repr(recv)}.call"
        if attr == "result":
            # x.result(), client.call_async(...).result()
            return "rpc", f"{_expr_repr(f)}"
        if attr == "join" and not isinstance(recv, ast.Constant) and \
                _JOINABLE.search(recv_name or ""):
            return "join", f"{_expr_repr(recv)}.join"
        if attr in _SOCKET_METHODS:
            return "socket", f"{_expr_repr(recv)}.{attr}"
        if attr in ("wait", "wait_for"):
            # cv.wait() on the ONLY held lock releases it: that is the
            # condition-variable idiom, not a blocking call under lock.
            # Alias-aware: ``self._freed = Condition(self._lock)`` makes
            # ``self._freed.wait()`` under ``with self._lock`` the idiom.
            recv_src = _expr_repr(recv)
            if len(held) == 1:
                if held[0][1] == recv_src:
                    return None
                recv_lid = self.lock_id(recv, cls_name)
                if recv_lid is not None and held[0][0] == recv_lid:
                    return None
            return "wait", f"{recv_src}.{attr}"
        return None

    # -- the walk ------------------------------------------------------------

    def run(self):
        self.collect_lock_attrs()
        tree = self.ctx.tree
        self._walk_scope(tree.body, cls_name=None, qual="<module>")

    def _walk_scope(self, body, cls_name, qual):
        """Visit statements of one def/module scope, entering nested
        defs with a FRESH (empty) lock stack."""
        for node in body:
            if isinstance(node, ast.ClassDef):
                self._walk_scope(node.body, cls_name=node.name,
                                 qual=node.name)
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                q = f"{qual}.{node.name}" if qual != "<module>" else node.name
                self._visit_stmts(node.body, cls_name, q, held=[])
            # module-level statements with locks are rare; skip

    def _visit_stmts(self, stmts, cls_name, qual, held):
        for st in stmts:
            self._visit_stmt(st, cls_name, qual, held)

    def _visit_stmt(self, st, cls_name, qual, held):
        if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef)):
            q = f"{qual}.{st.name}"
            self._visit_stmts(st.body, cls_name, q, held=[])
            return
        if isinstance(st, ast.ClassDef):
            self._walk_scope([st], cls_name, qual)
            return
        if isinstance(st, (ast.With, ast.AsyncWith)):
            acquired = []
            for item in st.items:
                lid = self.lock_id(item.context_expr, cls_name)
                if lid is not None and not self._suppressed(st, "W2"):
                    self._record_acquire(lid, held, st, qual)
                if lid is not None:
                    acquired.append((lid, _expr_repr(item.context_expr)))
                else:
                    # non-lock context managers: still scan their
                    # expressions for blocking calls
                    self._scan_expr(item.context_expr, cls_name, qual, held)
            held.extend(acquired)
            self._visit_stmts(st.body, cls_name, qual, held)
            for _ in acquired:
                held.pop()
            return
        # compound statements: recurse into bodies, scan their exprs
        for field in ("body", "orelse", "finalbody"):
            sub = getattr(st, field, None)
            if sub:
                self._visit_stmts(sub, cls_name, qual, held)
        for h in getattr(st, "handlers", []):
            self._visit_stmts(h.body, cls_name, qual, held)
        # scan expressions hanging off this statement (test/value/etc.)
        for field, value in ast.iter_fields(st):
            if field in ("body", "orelse", "finalbody", "handlers"):
                continue
            for expr in _iter_exprs(value):
                self._scan_expr(expr, cls_name, qual, held)

    def _scan_expr(self, expr, cls_name, qual, held):
        if expr is None or not isinstance(expr, ast.AST):
            return
        for node in _walk_pruned(expr):
            if isinstance(node, ast.Call):
                self._check_call(node, cls_name, qual, held)

    def _check_call(self, call, cls_name, qual, held):
        # record self-method calls under lock for W2 propagation
        f = call.func
        if held and isinstance(f, ast.Attribute) and \
                isinstance(f.value, ast.Name) and f.value.id == "self" and \
                cls_name:
            self.calls_under_lock.append(
                (cls_name, f.attr, [h[0] for h in held], call.lineno, qual))
        got = self.classify_blocking(call, held, cls_name)
        if got is None:
            return
        cat, desc = got
        if not held:
            # not under a lock HERE — but record it so a caller that
            # invokes this method while holding a lock gets flagged
            # (one-level propagation, mirroring W2's).  For waits, carry
            # the receiver's lock id: a `_locked`-suffix helper waiting
            # on the cv its CALLER holds is the split CV idiom.
            parts = qual.split(".")
            if cls_name and len(parts) == 2 and parts[0] == cls_name:
                recv_lid = None
                if cat == "wait" and isinstance(call.func, ast.Attribute):
                    recv_lid = self.lock_id(call.func.value, cls_name)
                self.method_blocking.setdefault(
                    (cls_name, parts[1]), []).append(
                        (cat, desc, call.lineno, recv_lid))
            return
        if self._suppressed(call, "W1"):
            return
        lockid = held[-1][0]
        key = ("W1", qual, f"{desc}@{lockid}")
        idx = self._counts.get(key, 0)
        self._counts[key] = idx + 1
        detail = f"{desc}@{lockid}" + (f"#{idx}" if idx else "")
        self.findings.append(Finding(
            rule="W1", path=self.ctx.path, line=call.lineno, symbol=qual,
            message=f"blocking call `{desc}(...)` while holding `{lockid}`",
            hint=_HINTS.get(cat, ""), detail=detail))

    def _record_acquire(self, lid, held, node, qual):
        stable = not lid.startswith("?.")
        # method-acquisition table for one-level call propagation
        parts = qual.split(".")
        if len(parts) >= 2 and parts[0] in self.class_locks and stable:
            self.method_acquires.setdefault(
                (parts[0], parts[1]), set()).add(lid)
        if not stable:
            return
        for h, _src in held:
            if h.startswith("?.") or h == lid:
                continue
            self.edges.append((h, lid, self.ctx.path, node.lineno, qual, ""))

    def _suppressed(self, node, rule):
        return self._suppressed_line(node.lineno, rule)

    def _suppressed_line(self, lineno, rule):
        line = self.ctx.lines[lineno - 1] if \
            0 < lineno <= len(self.ctx.lines) else ""
        m = re.search(r"rtlint:\s*disable=([\w,]+)", line)
        return bool(m and (rule in m.group(1).split(",") or
                           "all" in m.group(1).split(",")))


def _iter_exprs(value):
    if isinstance(value, ast.AST):
        yield value
    elif isinstance(value, list):
        for v in value:
            yield from _iter_exprs(v)


def _walk_pruned(root):
    """``ast.walk`` that does NOT descend into deferred-execution bodies
    (lambdas, nested defs): code inside them runs later, not under the
    enclosing lock."""
    stack = [root]
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            continue
        yield node
        stack.extend(ast.iter_child_nodes(node))


def scan_file(ctx):
    """Run the shared walk; returns (w1_findings, file_pass) — the pass
    object carries the W2 edge data for the cross-file step."""
    p = _FilePass(ctx)
    p.run()
    return p.findings, p


def interprocedural_w1(passes) -> list[Finding]:
    """One-level call propagation for W1: ``self.m()`` invoked while
    holding a lock, where method ``m`` (same class) contains a blocking
    call that is NOT under a lock of its own."""
    table: dict[tuple, list] = {}
    for p in passes:
        for k, v in p.method_blocking.items():
            table.setdefault(k, []).extend(v)
    out: list[Finding] = []
    counts: dict[tuple, int] = {}
    for p in passes:
        for cls, meth, held, line, qual in p.calls_under_lock:
            for cat, desc, _bl, recv_lid in table.get((cls, meth), ()):
                if p._suppressed_line(line, "W1"):
                    continue
                if cat == "wait" and recv_lid is not None and \
                        len(held) == 1 and held[-1] == recv_lid:
                    continue    # waiting on the (only) lock we hold
                                # releases it: split CV idiom
                lockid = held[-1]
                key = (qual, f"{desc}@{lockid}:via-{meth}")
                idx = counts.get(key, 0)
                counts[key] = idx + 1
                detail = key[1] + (f"#{idx}" if idx else "")
                out.append(Finding(
                    rule="W1", path=p.ctx.path, line=line, symbol=qual,
                    message=(f"blocking call `{desc}(...)` reached via "
                             f"self.{meth}() while holding `{lockid}`"),
                    hint=_HINTS.get(cat, ""), detail=detail))
    return out


def build_graph(passes) -> tuple[dict, list]:
    """Merge per-file data into the global acquires-while-holding
    digraph.  Returns (adjacency, edge_witnesses)."""
    adj: dict[str, dict[str, tuple]] = {}
    # union the method-acquisition tables (class name collisions across
    # modules merge conservatively — same-named classes share a node)
    acq: dict[tuple, set] = {}
    for p in passes:
        for k, v in p.method_acquires.items():
            acq.setdefault(k, set()).update(v)
    for p in passes:
        for src, dst, path, line, qual, via in p.edges:
            adj.setdefault(src, {}).setdefault(dst, (path, line, qual, via))
        for cls, meth, held, line, qual in p.calls_under_lock:
            for lid in acq.get((cls, meth), ()):
                for h in held:
                    if h.startswith("?.") or h == lid:
                        continue
                    adj.setdefault(h, {}).setdefault(
                        lid, (p.ctx.path, line, qual,
                              f"via self.{meth}()"))
    return adj


def find_cycles(adj: dict) -> list[list[str]]:
    """All elementary cycles found by DFS back-edge detection, deduped
    by node set.  Deterministic: nodes visited in sorted order."""
    cycles, seen_sets = [], set()
    WHITE, GRAY, BLACK = 0, 1, 2
    color = {n: WHITE for n in adj}
    stack: list[str] = []

    def dfs(n):
        color[n] = GRAY
        stack.append(n)
        for m in sorted(adj.get(n, ())):
            if color.get(m, WHITE) == WHITE:
                dfs(m)
            elif color.get(m) == GRAY:
                i = stack.index(m)
                cyc = stack[i:] + [m]
                key = frozenset(cyc)
                if key not in seen_sets:
                    seen_sets.add(key)
                    cycles.append(cyc)
        stack.pop()
        color[n] = BLACK

    for n in sorted(adj):
        if color[n] == WHITE:
            dfs(n)
    return cycles


def cycle_findings(adj: dict) -> list[Finding]:
    out = []
    for cyc in find_cycles(adj):
        hops = []
        first_path, first_line = "", 0
        for a, b in zip(cyc, cyc[1:]):
            path, line, qual, via = adj[a][b]
            tag = f" ({via})" if via else ""
            hops.append(f"{a} -> {b} at {path}:{line} in {qual}{tag}")
            if not first_path:
                first_path, first_line = path, line
        out.append(Finding(
            rule="W2", path=first_path, line=first_line,
            symbol="<lock-graph>",
            message="lock-order cycle: " + "; ".join(hops),
            hint=("pick one global order for these locks and acquire in "
                  "that order everywhere, or narrow one critical section "
                  "so the nesting disappears"),
            detail="cycle:" + "|".join(sorted(set(cyc)))))
    return out
