"""W5 seam discipline: control-plane code must not bypass the clock
and transport seams.

Two checks, scoped to the package's ``runtime/``, ``rpc/``,
``broadcast/``, ``leasing/``, ``versioning/`` and the serve-plane
control modules ``serve/gossip.py`` / ``serve/loaning.py`` (the code
the in-process simulator runs under a virtual clock — loan reclaim
deadlines and gossip staleness both ride the clock seam), plus the
hunt and the elastic training plane (``scopes.CLOCK``):

- **clock bypass**: a direct call to ``time.time()``,
  ``time.monotonic()`` or ``time.sleep()`` — including through an
  import alias (``import time as _time``) or a ``from time import
  sleep`` name.  Under simulation these read the *wall* clock, so a
  deadline computed from one silently never fires (or a sleep blocks
  the single-threaded event loop for real).  Route through
  ``<package>.common.clock`` (``_clk.now()/_clk.monotonic()/
  _clk.sleep()``).  ``time.perf_counter`` and friends stay legal:
  measuring *real* elapsed wall time (benchmarks, logs of actual
  latency) is not a control-plane deadline.
- **transport bypass** (``runtime/``, ``broadcast/`` and ``leasing/``):
  constructing ``RpcClient(...)``/``RpcServer(...)`` directly instead
  of going through ``rpc.transport.connect()/serve()`` welds that
  control path to real sockets and cuts it out of the simulator.  The
  ``rpc/`` package itself is exempt — it *implements* the transport.

``common/clock.py`` and ``rpc/transport.py`` (the seams) and anything
outside the scoped trees are never flagged.  Suppress a deliberate site
with ``# rtlint: disable=W5`` (e.g. worker-subprocess code that
genuinely wants wall time).
"""

from __future__ import annotations

import ast
import re

from . import scopes
from .finding import Finding

_CLOCK_FNS = ("time", "monotonic", "sleep")


def _suppressed(ctx, lineno) -> bool:
    line = ctx.lines[lineno - 1] if 0 < lineno <= len(ctx.lines) else ""
    m = re.search(r"rtlint:\s*disable=([\w,]+)", line)
    return bool(m and ("W5" in m.group(1).split(",") or
                       "all" in m.group(1).split(",")))


def _qualname_index(tree):
    quals = {}

    def rec(body, prefix):
        for node in body:
            if isinstance(node, ast.ClassDef):
                rec(node.body, f"{prefix}{node.name}.")
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                quals[node] = f"{prefix}{node.name}"
                rec(node.body, f"{prefix}{node.name}.")

    rec(tree.body, "")
    return quals


def _enclosing(quals, tree, target):
    """Qualname of the innermost function containing ``target``."""
    best = "<module>"
    best_span = None
    for fn, qual in quals.items():
        end = getattr(fn, "end_lineno", fn.lineno)
        if fn.lineno <= target.lineno <= end:
            span = end - fn.lineno
            if best_span is None or span < best_span:
                best, best_span = qual, span
    return best


def scan_file(ctx, package: str) -> list[Finding]:
    path = ctx.path
    if not scopes.in_scope(path, package, scopes.CLOCK) or \
            scopes.in_scope(path, package, files=scopes.SEAMS):
        return []
    transport_scoped = scopes.in_scope(path, package, scopes.TRANSPORT)
    tree = ctx.tree
    quals = _qualname_index(tree)
    findings: list[Finding] = []

    # names bound to the time module / its seam functions, anywhere in
    # the file (module level or function-local `import time as _time`)
    time_aliases = set()
    bare_names = {}             # local name -> time-module function
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name == "time":
                    time_aliases.add(a.asname or "time")
        elif isinstance(node, ast.ImportFrom) and node.module == "time":
            for a in node.names:
                if a.name in _CLOCK_FNS:
                    bare_names[a.asname or a.name] = a.name

    per_sym: dict[tuple, int] = {}

    def emit(call, fname, shape):
        if _suppressed(ctx, call.lineno):
            return
        sym = _enclosing(quals, tree, call)
        n = per_sym.get((sym, fname), 0)
        per_sym[(sym, fname)] = n + 1
        seam = {"time": "_clk.now()", "monotonic": "_clk.monotonic()",
                "sleep": "_clk.sleep()"}[fname]
        findings.append(Finding(
            rule="W5", path=path, line=call.lineno, symbol=sym,
            message=(f"direct {shape} bypasses the clock seam — under "
                     f"simulation this is wall time, not virtual time"),
            hint=f"use {package}.common.clock ({seam})",
            detail=f"clock:{fname}@{sym}" + (f"#{n}" if n else "")))

    def emit_transport(call, ctor):
        if _suppressed(ctx, call.lineno):
            return
        sym = _enclosing(quals, tree, call)
        n = per_sym.get((sym, ctor), 0)
        per_sym[(sym, ctor)] = n + 1
        fn = "connect" if ctor == "RpcClient" else "serve"
        findings.append(Finding(
            rule="W5", path=path, line=call.lineno, symbol=sym,
            message=(f"direct {ctor}(...) construction bypasses the "
                     f"transport seam — this endpoint cannot run under "
                     f"the in-process simulator"),
            hint=f"use rpc.transport.{fn}(...)",
            detail=f"transport:{ctor}@{sym}" + (f"#{n}" if n else "")))

    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        f = node.func
        if isinstance(f, ast.Attribute) and f.attr in _CLOCK_FNS and \
                isinstance(f.value, ast.Name) and \
                f.value.id in time_aliases:
            alias = f.value.id
            emit(node, f.attr, f"{alias}.{f.attr}()")
        elif isinstance(f, ast.Name) and f.id in bare_names:
            emit(node, bare_names[f.id], f"{f.id}()")
        elif transport_scoped and isinstance(f, ast.Name) \
                and f.id in ("RpcClient", "RpcServer"):
            emit_transport(node, f.id)
    return findings
