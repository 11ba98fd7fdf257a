"""W6 heartbeat data-path discipline: no unsanctioned host<->device
syncs in the scheduler's device code, in torch idiom.

The delta-heartbeat contract (scheduling/policy.py DeltaScheduler,
ops/hybrid_kernel.py) allows exactly ONE device->host readback per
beat — the packed counts fetch.  Every other sync point stalls the
double-buffered pipeline: the host blocks, the staged upload for beat
N+1 loses its overlap window, and the "delta" path quietly degrades
to lock-step dispatch.  These bugs do not fail tests (results are
identical); they only show up as a flat phase profile.

Scoped to the package's ``ops/``, ``scheduling/``, ``leasing/``,
``versioning/``, ``runtime/raylet.py`` and the sim search and training
planes (``scopes.DEVICE``; the code the heartbeat runs, the sharded beat
included).  The rule flags:

- ``<x>.item()`` / ``<x>.tolist()`` — a tensor's values to Python: a
  copy to the host that waits for the card (quiet when ``x`` is numpy:
  a ``np.*`` expression or a name the same function bound from one);
- ``<x>.cpu()`` / ``<x>.to("cpu")`` / ``<x>.to(torch.device("cpu"))``
  — a device->host copy the host waits on;
- ``<x>.numpy()`` — a tensor's host memory as numpy (quiet right after
  a ``.cpu()``, which is the finding);
- ``torch.cuda.synchronize(...)`` — the host waits for the card;
- ``<event or stream>.synchronize()`` and ``<event>.elapsed_time(...)``
  — the host waits for the card's work up to a point;
- ``np.asarray(x)`` / ``np.array(x)`` where ``x`` is a torch expression
  or a name the same function bound from one — numpy coercion of a
  tensor copies it off the card and waits (the most common accidental
  sync).  numpy coercion of host data (lists, numpy arrays, arguments)
  is not a finding.

Deliberate sites — the per-beat counts readback, the ``*_np`` host
wrappers, the profile-mode phase timers — are either suppressed with
``# rtlint: disable=W6`` or carried in the baseline; anything new is
a finding.  ``sites()`` returns the suppressed sites too, so a run on
the card can hold the syncs it observes to them.
"""

from __future__ import annotations

import ast
import re

from . import scopes
from .finding import Finding

_HOST_METHODS = ("item", "tolist", "cpu", "numpy")
_NP_COERCIONS = ("asarray", "array")
# methods whose result lives on the host (numpy or Python values)
_TO_HOST = ("numpy", "tolist", "item")


def _suppressed(ctx, lineno) -> bool:
    line = ctx.lines[lineno - 1] if 0 < lineno <= len(ctx.lines) else ""
    m = re.search(r"rtlint:\s*disable=([\w,]+)", line)
    return bool(m and ("W6" in m.group(1).split(",") or
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


def _enclosing_fn(quals, target):
    """Innermost function node containing ``target`` (None = module)."""
    best = None
    best_span = None
    for fn in quals:
        end = getattr(fn, "end_lineno", fn.lineno)
        if fn.lineno <= target.lineno <= end:
            span = end - fn.lineno
            if best_span is None or span < best_span:
                best, best_span = fn, span
    return best


def _aliases(tree):
    """Names bound to torch (``import torch``, ``from torch import
    cuda``, function-local imports included), to numpy, and bare
    ``from torch.cuda import synchronize`` bindings."""
    torch_names, np_names, bare_sync = set(), set(), set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name == "torch" or a.name.startswith("torch."):
                    torch_names.add(a.asname or "torch")
                elif a.name == "numpy":
                    np_names.add(a.asname or "numpy")
        elif isinstance(node, ast.ImportFrom) and node.module and \
                (node.module == "torch" or node.module.startswith("torch.")):
            for a in node.names:
                if node.module == "torch.cuda" and a.name == "synchronize":
                    bare_sync.add(a.asname or a.name)
                else:
                    torch_names.add(a.asname or a.name)
    return torch_names, np_names, bare_sync


def _origin(e, torch_names, np_names, bound):
    """"torch" when ``e`` is built from torch (a ``torch.*`` call, a
    method chain on a tensor), "numpy" when its value lives on the host,
    else None (unknown: an argument, an attribute of ``self``)."""
    while True:
        if isinstance(e, ast.Call):
            f = e.func
            if isinstance(f, ast.Attribute) and f.attr in _TO_HOST:
                return "numpy"
            e = f
        elif isinstance(e, (ast.Attribute, ast.Subscript, ast.Starred)):
            e = e.value
        elif isinstance(e, ast.BinOp):
            sides = (_origin(e.left, torch_names, np_names, bound),
                     _origin(e.right, torch_names, np_names, bound))
            return "torch" if "torch" in sides else \
                ("numpy" if "numpy" in sides else None)
        elif isinstance(e, ast.Name):
            if e.id in torch_names:
                return "torch"
            if e.id in np_names:
                return "numpy"
            return bound.get(e.id)
        else:
            return None


def _own_nodes(fn):
    """The nodes of ``fn``'s body, nested functions and lambdas left out
    (their names are their own)."""
    stack = list(fn.body) if hasattr(fn, "body") else []
    while stack:
        node = stack.pop()
        yield node
        for child in ast.iter_child_nodes(node):
            if not isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                      ast.Lambda, ast.ClassDef)):
                stack.append(child)


def _bindings(scope, torch_names, np_names) -> dict[str, str]:
    """name -> origin of what ``scope`` binds it to; a name bound from
    torch anywhere in the scope stays "torch"."""
    bound: dict[str, str] = {}

    def bind(target, origin):
        for el in ast.walk(target):
            if isinstance(el, ast.Name) and origin and \
                    bound.get(el.id) != "torch":
                bound[el.id] = origin

    assigns = sorted((n for n in _own_nodes(scope)
                      if isinstance(n, (ast.Assign, ast.AnnAssign, ast.For,
                                        ast.withitem, ast.NamedExpr))),
                     key=lambda n: (getattr(n, "lineno", 0),
                                    getattr(n, "col_offset", 0)))
    for n in assigns:
        if isinstance(n, ast.Assign):
            o = _origin(n.value, torch_names, np_names, bound)
            for t in n.targets:
                bind(t, o)
        elif isinstance(n, ast.AnnAssign) and n.value is not None:
            bind(n.target, _origin(n.value, torch_names, np_names, bound))
        elif isinstance(n, ast.For):
            bind(n.target, _origin(n.iter, torch_names, np_names, bound))
        elif isinstance(n, ast.withitem) and n.optional_vars is not None:
            bind(n.optional_vars,
                 _origin(n.context_expr, torch_names, np_names, bound))
        elif isinstance(n, ast.NamedExpr):
            bind(n.target, _origin(n.value, torch_names, np_names, bound))
    return bound


def _is_cpu_device(e, torch_names) -> bool:
    """``"cpu"`` / ``"cpu:0"`` or ``torch.device("cpu")``."""
    if isinstance(e, ast.Constant) and isinstance(e.value, str):
        return e.value.split(":")[0] == "cpu"
    if isinstance(e, ast.Call) and isinstance(e.func, ast.Attribute) and \
            e.func.attr == "device" and isinstance(e.func.value, ast.Name) \
            and e.func.value.id in torch_names:
        args = list(e.args) + [k.value for k in e.keywords
                               if k.arg == "type"]
        return bool(args) and _is_cpu_device(args[0], torch_names)
    return False


def _to_cpu(call, torch_names) -> bool:
    f = call.func
    if not (isinstance(f, ast.Attribute) and f.attr == "to"):
        return False
    args = call.args[:1] + [k.value for k in call.keywords
                            if k.arg == "device"]
    return any(_is_cpu_device(a, torch_names) for a in args)


def _is_torch_cuda(e, torch_names) -> bool:
    return isinstance(e, ast.Attribute) and e.attr == "cuda" and \
        isinstance(e.value, ast.Name) and e.value.id in torch_names


def sites(ctx, package: str) -> list[tuple[Finding, bool]]:
    """Every sync site of the file as (finding, suppressed by its line's
    pragma).  Fingerprints count the unsuppressed sites only, so they
    equal ``scan_file``'s."""
    path = ctx.path
    if not scopes.in_scope(path, package, scopes.DEVICE,
                           scopes.DEVICE_FILES):
        return []
    tree = ctx.tree
    quals = _qualname_index(tree)
    torch_names, np_names, bare_sync = _aliases(tree)
    binds = {None: _bindings(tree, torch_names, np_names)}
    for fn in quals:
        binds[fn] = _bindings(fn, torch_names, np_names)

    per_sym: dict[tuple, int] = {}
    out: list[tuple[Finding, bool]] = []

    def emit(call, kind, shape, hint):
        quiet = _suppressed(ctx, call.lineno)
        fn = _enclosing_fn(quals, call)
        sym = quals.get(fn, "<module>")
        n = 0
        if not quiet:
            n = per_sym.get((sym, kind), 0)
            per_sym[(sym, kind)] = n + 1
        out.append((Finding(
            rule="W6", path=path, line=call.lineno, symbol=sym,
            message=(f"{shape} is a host<->device sync in the heartbeat "
                     f"path — it stalls the double-buffered beat "
                     f"pipeline"),
            hint=hint,
            detail=f"sync:{kind}@{sym}" + (f"#{n}" if n else "")), quiet))

    batch_hint = ("batch into the one sanctioned per-beat counts "
                  "readback, or mark a deliberate site with "
                  "# rtlint: disable=W6")
    calls = sorted((n for n in ast.walk(tree) if isinstance(n, ast.Call)),
                   key=lambda n: (n.lineno, n.col_offset))
    for node in calls:
        f = node.func
        bound = binds[_enclosing_fn(quals, node)]
        if isinstance(f, ast.Name) and f.id in bare_sync:
            emit(node, "cuda_synchronize", f"{f.id}(...)", batch_hint)
            continue
        if not isinstance(f, ast.Attribute):
            continue
        recv = f.value
        if f.attr in _HOST_METHODS:
            if f.attr in ("item", "tolist") and \
                    _origin(recv, torch_names, np_names, bound) == "numpy":
                continue
            if f.attr == "numpy" and isinstance(recv, ast.Call) and (
                    (isinstance(recv.func, ast.Attribute) and
                     recv.func.attr == "cpu") or
                    _to_cpu(recv, torch_names)):
                continue        # the .cpu() / .to("cpu") is the finding
            emit(node, f.attr, f"<tensor>.{f.attr}()", batch_hint)
        elif _to_cpu(node, torch_names):
            emit(node, "to_cpu", "<tensor>.to(\"cpu\")", batch_hint)
        elif f.attr == "synchronize":
            if _is_torch_cuda(recv, torch_names):
                emit(node, "cuda_synchronize",
                     f"{recv.value.id}.cuda.synchronize(...)", batch_hint)
            else:
                emit(node, "synchronize", "<event|stream>.synchronize()",
                     batch_hint)
        elif f.attr == "elapsed_time":
            emit(node, "elapsed_time", "<event>.elapsed_time(...)",
                 batch_hint)
        elif f.attr in _NP_COERCIONS and isinstance(recv, ast.Name) \
                and recv.id in np_names and node.args and \
                _origin(node.args[0], torch_names, np_names,
                        bound) == "torch":
            emit(node, f.attr, f"{recv.id}.{f.attr}(<tensor>)",
                 "numpy coercion of a tensor copies it off the card and "
                 "waits; " + batch_hint)
    return out


def scan_file(ctx, package: str) -> list[Finding]:
    return [f for f, quiet in sites(ctx, package) if not quiet]
