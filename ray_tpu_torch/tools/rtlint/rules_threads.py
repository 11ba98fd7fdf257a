"""W4 thread-lifecycle discipline.

Two checks:

- **non-daemon spawn**: every ``threading.Thread(...)`` must either be
  ``daemon=True`` at the spawn site or visibly owned — assigned to a
  name that some code in the same module ``.join()``s (a stop path).
  A non-daemon thread with neither wedges interpreter shutdown.
- **silent pump death**: in a function used as a thread target, an
  ``except:`` / ``except Exception:`` handler whose body is only
  ``pass``/``continue`` inside a loop keeps the pump spinning after
  the error it just ate — the reader-death-swallowing shape.  Bare
  ``except:`` is flagged anywhere in a thread target (it also eats
  SystemExit/KeyboardInterrupt on that thread).
"""

from __future__ import annotations

import ast
import re

from .finding import Finding


def _is_thread_ctor(call: ast.Call) -> bool:
    f = call.func
    if isinstance(f, ast.Attribute) and f.attr == "Thread" and \
            isinstance(f.value, ast.Name) and f.value.id == "threading":
        return True
    if isinstance(f, ast.Name) and f.id == "Thread":
        return True
    return False


def _suppressed(ctx, lineno, rule):
    line = ctx.lines[lineno - 1] if 0 < lineno <= len(ctx.lines) else ""
    m = re.search(r"rtlint:\s*disable=([\w,]+)", line)
    return bool(m and (rule in m.group(1).split(",") or
                       "all" in m.group(1).split(",")))


def _qualname_index(tree):
    """Map each function node to its dotted qualname."""
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


def scan_file(ctx) -> list[Finding]:
    findings = []
    tree = ctx.tree
    src = "\n".join(ctx.lines)
    quals = _qualname_index(tree)

    # -- collect spawn sites + thread-target names ---------------------------
    spawns = []                 # (call_node, assigned_name or None)
    target_names = set()        # simple names / method names given as target=
    for node in ast.walk(tree):
        call = None
        assigned = None
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call) \
                and _is_thread_ctor(node.value):
            call = node.value
            t = node.targets[0]
            if isinstance(t, ast.Name):
                assigned = t.id
            elif isinstance(t, ast.Attribute):
                assigned = t.attr
        elif isinstance(node, ast.Call) and _is_thread_ctor(node):
            call = node
        if call is None:
            continue
        if not any(c is call for c, _ in spawns):
            spawns.append((call, assigned))
        for kw in call.keywords:
            if kw.arg == "target":
                v = kw.value
                if isinstance(v, ast.Name):
                    target_names.add(v.id)
                elif isinstance(v, ast.Attribute):
                    target_names.add(v.attr)

    # join targets seen anywhere in the module: "x.join(" / "self._x.join("
    joined = set(re.findall(r"(\w+)\s*\.\s*join\(", src))

    spawn_idx: dict[str, int] = {}
    for call, assigned in spawns:
        daemon = None
        for kw in call.keywords:
            if kw.arg == "daemon" and isinstance(kw.value, ast.Constant):
                daemon = bool(kw.value.value)
        if daemon:
            continue
        if assigned is not None and assigned in joined:
            continue
        if _suppressed(ctx, call.lineno, "W4"):
            continue
        name = assigned or "<unassigned>"
        n = spawn_idx.get(name, 0)
        spawn_idx[name] = n + 1
        findings.append(Finding(
            rule="W4", path=ctx.path, line=call.lineno,
            symbol=name,
            message=("thread spawned without daemon=True and without a "
                     "visible join/stop path"),
            hint=("pass daemon=True, or keep the handle and join it on "
                  "shutdown"),
            detail=f"non-daemon:{name}" + (f"#{n}" if n else "")))

    # -- silent pump death ---------------------------------------------------
    for fn, qual in quals.items():
        if fn.name not in target_names:
            continue
        findings.extend(_scan_pump(ctx, fn, qual))
    return findings


def _handler_is_silent(handler: ast.ExceptHandler) -> bool:
    for st in handler.body:
        if isinstance(st, (ast.Pass, ast.Continue)):
            continue
        if isinstance(st, ast.Expr) and isinstance(st.value, ast.Constant):
            continue            # a docstring/ellipsis is still silent
        return False
    return True


def _exc_kind(handler: ast.ExceptHandler) -> str | None:
    """'bare', 'broad' (Exception/BaseException) or None (specific)."""
    t = handler.type
    if t is None:
        return "bare"
    names = []
    if isinstance(t, ast.Tuple):
        names = [e.id for e in t.elts if isinstance(e, ast.Name)]
    elif isinstance(t, ast.Name):
        names = [t.id]
    if any(n in ("Exception", "BaseException") for n in names):
        return "broad"
    return None


def _scan_pump(ctx, fn, qual) -> list[Finding]:
    out = []
    idx = 0

    def rec(body, in_loop):
        nonlocal idx
        for st in body:
            if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            is_loop = isinstance(st, (ast.While, ast.For))
            if isinstance(st, ast.Try):
                for h in st.handlers:
                    kind = _exc_kind(h)
                    if kind is None:
                        continue
                    silent = _handler_is_silent(h)
                    fire = (kind == "bare") or (silent and in_loop)
                    if not fire or _suppressed(ctx, h.lineno, "W4"):
                        continue
                    what = "bare `except:`" if kind == "bare" else \
                        f"silent `except {ast.unparse(h.type)}`"
                    idx += 1
                    out.append(Finding(
                        rule="W4", path=ctx.path, line=h.lineno,
                        symbol=qual,
                        message=(f"{what} in thread target `{qual}` "
                                 f"{'inside its pump loop ' if in_loop else ''}"
                                 f"swallows the error that killed the "
                                 f"iteration"),
                        hint=("log the exception (and decide: continue, "
                              "back off, or let the pump die visibly)"),
                        detail=f"swallow:{kind}#{idx}"))
            for field in ("body", "orelse", "finalbody"):
                sub = getattr(st, field, None)
                if sub:
                    rec(sub, in_loop or is_loop)
            for h in getattr(st, "handlers", []):
                rec(h.body, in_loop or is_loop)

    rec(fn.body, False)
    return out
