"""W8 replay-determinism discipline.

Bit-identical replay (SIM_r06) and the adversarial hunt (sim/hunt.py)
rest on one invariant: everything that can affect a campaign trace is a
pure function of the campaign's Philox streams and the virtual clock.  W8
statically audits the sim/trace-affecting scope for the three ways code
breaks that:

- **entropy bypass**: a draw from a default/global stream —
  ``random.*`` module functions, ``np.random.*`` legacy global-state
  draws, ``uuid.uuid4``/``uuid1``, ``os.urandom`` — is seeded from the
  OS, not the campaign seed, so the same seed stops replaying the same
  trace.  Instance draws on an injected ``random.Random(seed)`` /
  ``np.random.Generator(Philox(seed))`` stream are the sanctioned
  pattern and never flagged.
- **identity leak**: ``id(...)`` is an address (varies per run) and
  ``hash(...)`` of str/bytes is salted per interpreter
  (PYTHONHASHSEED); either one feeding a trace key, an event ordering,
  or a schedule makes replay machine-dependent.
- **iteration-order hazard**: iterating a ``set``/``frozenset`` (or a
  ``list()``/``tuple()`` conversion of one) feeds whatever consumes the
  loop in memory-address order.  ``sorted(...)`` is the fix and is
  recognized; plain dicts are insertion-ordered in CPython and stay
  legal.

Scope (``scopes.REPLAY``): the package's ``sim/`` (cluster, campaign,
hunt, minimize, invariants, the serve/train/rollout overlays), the
seeded fault plane ``rpc/chaos.py``, and the sim-reachable entropy
sites the W8 cleanup routed through seams (``runtime/job_manager.py``,
``util/collective.py``).  Suppress a deliberate site with
``# rtlint: disable=W8`` (e.g. a process-local identity map that never
reaches the trace hash).
"""

from __future__ import annotations

import ast
import re

from . import scopes
from .finding import Finding
from .rules_time import _enclosing, _qualname_index

# module-level ``random.<fn>`` draws on the hidden global Mersenne
# Twister (random.Random(...) instance streams are sanctioned)
_RANDOM_FNS = {
    "random", "randint", "randrange", "uniform", "choice", "choices",
    "sample", "shuffle", "getrandbits", "randbytes", "gauss",
    "normalvariate", "lognormvariate", "expovariate", "betavariate",
    "gammavariate", "triangular", "vonmisesvariate", "paretovariate",
    "weibullvariate", "seed",
}

# legacy ``np.random.<fn>`` global-state draws; the Generator/Philox
# constructors are the sanctioned stream factories
_NP_RANDOM_FNS = {
    "rand", "randn", "randint", "random", "random_sample", "ranf",
    "sample", "uniform", "choice", "shuffle", "permutation", "normal",
    "standard_normal", "beta", "binomial", "poisson", "exponential",
    "gamma", "bytes", "seed", "get_state", "set_state",
}

_UUID_FNS = {"uuid1", "uuid4"}

# wrappers that preserve the underlying iteration order (stripping them
# exposes the set underneath); ``sorted`` is the one that FIXES it
_ORDER_PRESERVING = {"list", "tuple", "enumerate", "reversed", "iter"}


def _suppressed(ctx, lineno) -> bool:
    line = ctx.lines[lineno - 1] if 0 < lineno <= len(ctx.lines) else ""
    m = re.search(r"rtlint:\s*disable=([\w,]+)", line)
    return bool(m and ("W8" in m.group(1).split(",") or
                       "all" in m.group(1).split(",")))


def _collect_aliases(tree):
    """Names bound to the random/numpy/uuid/os modules and the bare
    from-imported entropy functions, anywhere in the file."""
    random_aliases, np_aliases, uuid_aliases, os_aliases = \
        set(), set(), set(), set()
    bare = {}           # local name -> ("random"|"uuid"|"os", fn)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                tgt = a.asname or a.name
                if a.name == "random":
                    random_aliases.add(tgt)
                elif a.name == "numpy":
                    np_aliases.add(tgt)
                elif a.name == "uuid":
                    uuid_aliases.add(tgt)
                elif a.name == "os":
                    os_aliases.add(tgt)
                elif a.name == "numpy.random":
                    # ``import numpy.random as npr``
                    np_aliases.add(tgt + ".__direct__")
        elif isinstance(node, ast.ImportFrom):
            if node.module == "random":
                for a in node.names:
                    if a.name in _RANDOM_FNS:
                        bare[a.asname or a.name] = ("random", a.name)
            elif node.module == "uuid":
                for a in node.names:
                    if a.name in _UUID_FNS:
                        bare[a.asname or a.name] = ("uuid", a.name)
            elif node.module == "os":
                for a in node.names:
                    if a.name == "urandom":
                        bare[a.asname or a.name] = ("os", "urandom")
            elif node.module == "numpy.random":
                for a in node.names:
                    if a.name in _NP_RANDOM_FNS:
                        bare[a.asname or a.name] = ("np.random", a.name)
            elif node.module == "numpy":
                for a in node.names:
                    if a.name == "random":
                        # ``from numpy import random`` binds the module
                        np_aliases.add((a.asname or "random") +
                                       ".__direct__")
    return random_aliases, np_aliases, uuid_aliases, os_aliases, bare


def _known_sets(tree):
    """Names statically known to hold a set: module/class/self
    assignments whose value is a set literal, ``set(...)`` or
    ``frozenset(...)``."""
    known = set()
    for node in ast.walk(tree):
        if not isinstance(node, (ast.Assign, ast.AnnAssign)):
            continue
        value = node.value
        if value is None:
            continue
        is_set = isinstance(value, ast.Set) or (
            isinstance(value, ast.Call) and
            isinstance(value.func, ast.Name) and
            value.func.id in ("set", "frozenset"))
        targets = node.targets if isinstance(node, ast.Assign) else \
            [node.target]
        for t in targets:
            name = _target_name(t)
            if name is None:
                continue
            if is_set:
                known.add(name)
            else:
                known.discard(name)     # rebound to something else
    return known


def _target_name(t):
    if isinstance(t, ast.Name):
        return t.id
    if isinstance(t, ast.Attribute) and isinstance(t.value, ast.Name) \
            and t.value.id == "self":
        return f"self.{t.attr}"
    return None


def _expr_name(e):
    if isinstance(e, ast.Name):
        return e.id
    if isinstance(e, ast.Attribute) and isinstance(e.value, ast.Name) \
            and e.value.id == "self":
        return f"self.{e.attr}"
    return None


def _is_set_expr(e, known):
    if isinstance(e, ast.Set):
        return "set literal"
    if isinstance(e, ast.Call) and isinstance(e.func, ast.Name) and \
            e.func.id in ("set", "frozenset"):
        return f"{e.func.id}(...)"
    name = _expr_name(e)
    if name is not None and name in known:
        return name
    # set algebra on known sets: (a | b), (a - b), (a & b)
    if isinstance(e, ast.BinOp) and isinstance(
            e.op, (ast.BitOr, ast.BitAnd, ast.Sub, ast.BitXor)):
        if _is_set_expr(e.left, known) or _is_set_expr(e.right, known):
            return "set expression"
    return None


def _unwrap_order_preserving(e):
    while isinstance(e, ast.Call) and isinstance(e.func, ast.Name) and \
            e.func.id in _ORDER_PRESERVING and e.args:
        e = e.args[0]
    return e


def scan_file(ctx, package: str) -> list[Finding]:
    path = ctx.path
    if not scopes.in_scope(path, package, scopes.REPLAY,
                           scopes.REPLAY_FILES):
        return []
    tree = ctx.tree
    quals = _qualname_index(tree)
    random_aliases, np_aliases, uuid_aliases, os_aliases, bare = \
        _collect_aliases(tree)
    known_sets = _known_sets(tree)
    findings: list[Finding] = []
    per_sym: dict[tuple, int] = {}

    def emit(node, kind, name, message, hint):
        if _suppressed(ctx, node.lineno):
            return
        sym = _enclosing(quals, tree, node)
        n = per_sym.get((sym, kind, name), 0)
        per_sym[(sym, kind, name)] = n + 1
        findings.append(Finding(
            rule="W8", path=path, line=node.lineno, symbol=sym,
            message=message, hint=hint,
            detail=f"{kind}:{name}@{sym}" + (f"#{n}" if n else "")))

    def check_entropy_call(node):
        f = node.func
        # bare from-imports: sleep-style direct names
        if isinstance(f, ast.Name) and f.id in bare:
            mod, fn = bare[f.id]
            emit(node, "entropy", f"{mod}.{fn}",
                 f"`{f.id}(...)` draws OS/global-stream entropy in "
                 f"trace-affecting code — the campaign seed no longer "
                 f"replays the trace",
                 "draw from an injected seeded stream "
                 "(random.Random(seed) / Philox), or move the entropy "
                 "out of sim scope")
            return
        if not isinstance(f, ast.Attribute):
            return
        recv = f.value
        # random.<fn>(...)
        if isinstance(recv, ast.Name) and recv.id in random_aliases and \
                f.attr in _RANDOM_FNS:
            emit(node, "entropy", f"random.{f.attr}",
                 f"`{recv.id}.{f.attr}(...)` draws from the global "
                 f"Mersenne Twister — not the campaign Philox streams",
                 "draw from an injected random.Random(seed) stream")
            return
        # np.random.<fn>(...) legacy global state
        if isinstance(recv, ast.Attribute) and recv.attr == "random" and \
                isinstance(recv.value, ast.Name) and \
                recv.value.id in np_aliases and f.attr in _NP_RANDOM_FNS:
            emit(node, "entropy", f"np.random.{f.attr}",
                 f"`{recv.value.id}.random.{f.attr}(...)` draws from "
                 f"numpy's legacy global state — not the campaign "
                 f"Philox streams",
                 "use np.random.Generator(np.random.Philox(seed))")
            return
        # ``import numpy.random as npr`` -> npr.<fn>
        if isinstance(recv, ast.Name) and \
                (recv.id + ".__direct__") in np_aliases and \
                f.attr in _NP_RANDOM_FNS:
            emit(node, "entropy", f"np.random.{f.attr}",
                 f"`{recv.id}.{f.attr}(...)` draws from numpy's legacy "
                 f"global state — not the campaign Philox streams",
                 "use np.random.Generator(np.random.Philox(seed))")
            return
        # uuid.uuid4() / uuid.uuid1()
        if isinstance(recv, ast.Name) and recv.id in uuid_aliases and \
                f.attr in _UUID_FNS:
            emit(node, "entropy", f"uuid.{f.attr}",
                 f"`{recv.id}.{f.attr}()` is OS entropy (and uuid1 "
                 f"leaks host+time) — ids in trace-affecting code must "
                 f"come from the seeded stream",
                 "derive ids from the campaign stream or a counter, or "
                 "mint them outside sim scope (common/ids.py)")
            return
        # os.urandom(n)
        if isinstance(recv, ast.Name) and recv.id in os_aliases and \
                f.attr == "urandom":
            emit(node, "entropy", "os.urandom",
                 f"`{recv.id}.urandom(...)` is OS entropy in "
                 f"trace-affecting code",
                 "derive bytes from the campaign stream, or mint them "
                 "outside sim scope (common/ids.py)")

    def check_identity_call(node):
        f = node.func
        if isinstance(f, ast.Name) and f.id in ("id", "hash") and \
                len(node.args) == 1:
            what = "an address that varies per run" if f.id == "id" \
                else "salted per interpreter (PYTHONHASHSEED)"
            emit(node, "identity", f.id,
                 f"`{f.id}(...)` is {what} — feeding it into trace "
                 f"keys or event scheduling makes replay "
                 f"machine-dependent",
                 "key on a stable id (ids.py binary ids, row indexes, "
                 "names); a process-local-only map gets "
                 "`# rtlint: disable=W8` with a justification")

    def check_iteration(iter_expr, node):
        e = _unwrap_order_preserving(iter_expr)
        if isinstance(e, ast.Call) and isinstance(e.func, ast.Name) and \
                e.func.id == "sorted":
            return
        what = _is_set_expr(e, known_sets)
        if what is None:
            return
        emit(node, "setiter", what.replace(" ", "-"),
             f"iterating `{what}` feeds consumers in memory-address "
             f"order — a trace hash or event schedule built from it "
             f"will not replay",
             "wrap the iterable in sorted(...) (sets have no stable "
             "order), or keep an insertion-ordered dict/list")

    # a comprehension handed straight to sorted() is order-safe: the
    # sort swallows whatever order the set yields (walk visits the
    # Call before its argument, so the mark lands in time)
    sanctified: set[int] = set()
    comps = (ast.ListComp, ast.SetComp, ast.DictComp, ast.GeneratorExp)
    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            if isinstance(node.func, ast.Name) and \
                    node.func.id == "sorted":
                sanctified.update(
                    id(a) for a in node.args if isinstance(a, comps))
            check_entropy_call(node)
            check_identity_call(node)
        elif isinstance(node, (ast.For, ast.AsyncFor)):
            check_iteration(node.iter, node)
        elif isinstance(node, comps):
            # a set-comprehension's RESULT is a set: the iteration
            # order it consumed cannot leak through it
            if id(node) in sanctified or isinstance(node, ast.SetComp):
                continue
            for comp in node.generators:
                check_iteration(comp.iter, node)
    return findings
