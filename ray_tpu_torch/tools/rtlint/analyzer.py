"""The analysis: file discovery, rule dispatch, baseline filtering.

Parsing and the per-file rule walks are the cost of a full-package run,
so ``FileCtx`` construction goes through a content-hash-keyed cache:
every rule — and every repeated ``run_analysis``/``lock_graph``/``check``
call in one process (the test suite runs dozens) — reuses one parsed
AST per distinct file content, and each rule's per-file result is kept
on that ``FileCtx`` (``FileCtx.memo``; a rule's per-file result depends
on the file and the package only), so a repeated run redoes only the
cross-file steps.  ``parse_count()`` exposes the real ``ast.parse``
invocations so a test can assert the single-parse property.

The port's copy of ``tools/rtlint``: ``package`` defaults to
``ray_tpu_torch`` and every path-scoped rule builds its scope from the
package it is handed (``scopes``), so a run with ``package="ray_tpu"``
is the reference analyzer's run for every rule but W6, which is written
for torch.  The package walk includes this directory: the analyzer's
own modules lint clean.
"""

from __future__ import annotations

import ast
import hashlib
import os

from . import baseline as baseline_mod
from . import (rules_determinism, rules_device, rules_knobs, rules_locks,
               rules_races, rules_threads, rules_time)
from .finding import Finding, sort_key

ALL_RULES = ("W1", "W2", "W3", "W4", "W5", "W6", "W7", "W8")

_PARSE_COUNT = 0
# (abspath, relpath) -> (content sha256, FileCtx)
_CTX_CACHE: dict[tuple[str, str], tuple[str, "FileCtx"]] = {}


class FileCtx:
    """One parsed source file handed to every rule."""

    def __init__(self, abspath: str, relpath: str, src: str):
        global _PARSE_COUNT
        self.abspath = abspath
        self.path = relpath.replace(os.sep, "/")
        self.module = os.path.splitext(os.path.basename(relpath))[0]
        self.lines = src.splitlines()
        _PARSE_COUNT += 1
        self.tree = ast.parse(src, filename=abspath)
        # (rule, package, ...) -> the rule's result for this file
        self.memo: dict[tuple, object] = {}

    def once(self, key: tuple, fn):
        """``fn()``, computed once per key for this file content."""
        if key not in self.memo:
            self.memo[key] = fn()
        return self.memo[key]


def get_ctx(abspath: str, relpath: str) -> FileCtx:
    """Cached FileCtx: re-parse only when the file content changed."""
    with open(abspath, "r", encoding="utf-8") as f:
        src = f.read()
    sha = hashlib.sha256(src.encode("utf-8")).hexdigest()
    key = (abspath, relpath)
    hit = _CTX_CACHE.get(key)
    if hit is not None and hit[0] == sha:
        return hit[1]
    ctx = FileCtx(abspath, relpath, src)
    _CTX_CACHE[key] = (sha, ctx)
    return ctx


def parse_count() -> int:
    """Total ``ast.parse`` calls this process (single-parse assert)."""
    return _PARSE_COUNT


def clear_cache() -> None:
    _CTX_CACHE.clear()


def repo_root() -> str:
    """The checkout that holds the port: the parent directory of
    ``ray_tpu_torch/``."""
    import ray_tpu_torch
    return os.path.dirname(os.path.dirname(
        os.path.abspath(ray_tpu_torch.__file__)))


def iter_package_files(pkg_dir: str) -> list[str]:
    out = []
    for dirpath, dirnames, filenames in os.walk(pkg_dir):
        dirnames[:] = sorted(d for d in dirnames if d != "__pycache__")
        for fn in sorted(filenames):
            if fn.endswith(".py"):
                out.append(os.path.join(dirpath, fn))
    return out


def run_analysis(repo_root: str, package: str = "ray_tpu_torch",
                 rules=ALL_RULES, files=None) -> list[Finding]:
    """Run the selected rules over ``<repo_root>/<package>``; returns
    ALL findings (baseline not applied here).

    ``files``: optional explicit file list (absolute paths) — used by
    the fixture tests to lint snippets without a package tree.
    """
    pkg_dir = os.path.join(repo_root, package)
    if files is None:
        files = iter_package_files(pkg_dir)
    ctxs = []
    findings: list[Finding] = []
    for path in files:
        rel = os.path.relpath(path, repo_root)
        try:
            ctxs.append(get_ctx(path, rel))
        except SyntaxError as e:
            findings.append(Finding(
                rule="E0", path=rel.replace(os.sep, "/"),
                line=e.lineno or 0, symbol="<parse>",
                message=f"syntax error: {e.msg}", detail="syntax-error"))

    need_lockpass = bool({"W1", "W2", "W7"} & set(rules))
    lock_passes = []
    knob_refs: set[str] = set()
    knob_strings: set[str] = set()
    config_abs = os.path.join(pkg_dir, "common", "config.py")
    config_rel = os.path.relpath(config_abs, repo_root).replace(os.sep, "/")
    defs = rules_knobs.load_defs(config_abs) if \
        ("W3" in rules and os.path.exists(config_abs)) else {}

    knob_key = ("W3", config_rel, tuple(sorted(defs)))
    for ctx in ctxs:
        if need_lockpass:
            w1, fpass = ctx.once(("lockpass",),
                                 lambda: rules_locks.scan_file(ctx))
            lock_passes.append(fpass)
            if "W1" in rules:
                findings.extend(w1)
            if "W7" in rules:
                findings.extend(ctx.once(
                    ("W7",), lambda: rules_races.scan_file(ctx, fpass)))
        if defs:
            kf, refs, strings = ctx.once(
                knob_key,
                lambda: rules_knobs.scan_file(ctx, defs, config_rel))
            # config.py itself mentions every knob as a dict key: its
            # string constants must not count as references
            if not ctx.path.endswith("common/config.py"):
                findings.extend(kf)
                knob_refs |= refs
                knob_strings |= strings
        if "W4" in rules:
            findings.extend(ctx.once(
                ("W4",), lambda: rules_threads.scan_file(ctx)))
        if "W5" in rules:
            findings.extend(ctx.once(
                ("W5", package), lambda: rules_time.scan_file(ctx, package)))
        if "W6" in rules:
            findings.extend(ctx.once(
                ("W6", package),
                lambda: rules_device.scan_file(ctx, package)))
        if "W8" in rules:
            findings.extend(ctx.once(
                ("W8", package),
                lambda: rules_determinism.scan_file(ctx, package)))

    if "W1" in rules and lock_passes:
        findings.extend(rules_locks.interprocedural_w1(lock_passes))
    if "W2" in rules and lock_passes:
        adj = rules_locks.build_graph(lock_passes)
        findings.extend(rules_locks.cycle_findings(adj))
    if defs:
        findings.extend(rules_knobs.global_findings(
            defs, knob_refs, knob_strings, config_rel))

    return sorted(findings, key=sort_key)


def lock_graph(repo_root: str, package: str = "ray_tpu_torch") -> dict:
    """The static acquires-while-holding digraph (for tests/tools)."""
    pkg_dir = os.path.join(repo_root, package)
    passes = []
    for path in iter_package_files(pkg_dir):
        ctx = get_ctx(path, os.path.relpath(path, repo_root))
        _, p = ctx.once(("lockpass",), lambda: rules_locks.scan_file(ctx))
        passes.append(p)
    return rules_locks.build_graph(passes)


def check(repo_root: str, package: str = "ray_tpu_torch", rules=ALL_RULES,
          baseline_path: str | None = None):
    """Full run + baseline split.

    Returns (new, baselined, stale, all_findings).
    """
    findings = run_analysis(repo_root, package, rules)
    accepted = baseline_mod.load(baseline_path) if baseline_path else {}
    new, based, stale = baseline_mod.split(findings, accepted)
    return new, based, stale, findings
