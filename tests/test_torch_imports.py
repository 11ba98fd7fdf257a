"""The port's import graph: no JAX, nothing of the JAX package, and every
relative import names a module of the port.

An AST walk, so imports inside functions and inside ``try`` blocks count
too: a lazy import of a module the port has not copied would otherwise
fail only when its branch runs (``runtime/health.py`` imports
``serve.gossip`` inside ``except Exception``, where a missing copy would
fail silently).
"""

from __future__ import annotations

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "ray_tpu_torch"
FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imports(path: Path):
    """(lineno, absolute module name or None, relative level, module,
    names) for every import statement in ``path``."""
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name, 0, None, ()
        elif isinstance(node, ast.ImportFrom):
            names = tuple(a.name for a in node.names)
            if node.level == 0:
                yield node.lineno, node.module, 0, None, names
            else:
                yield node.lineno, None, node.level, node.module, names


def _package_of(path: Path) -> Path:
    return path.parent


def _resolves(base: Path, module: str | None, name: str | None) -> bool:
    """Does ``module`` (dotted, relative to package dir ``base``) name a
    module or package of the port, or ``name`` a submodule of it, or an
    attribute its ``__init__``/module defines?"""
    target = base
    if module:
        for part in module.split("."):
            target = target / part
    mod_file = target.with_suffix(".py")
    pkg_init = target / "__init__.py"
    if module and not (mod_file.exists() or pkg_init.exists()):
        return False
    if name is None:
        return True
    if pkg_init.exists() or not module:
        # `from . import x` / `from .pkg import x`: a submodule, or a name
        # the package's __init__ binds
        if (target / f"{name}.py").exists() or \
                (target / name / "__init__.py").exists():
            return True
        init = pkg_init if module else base / "__init__.py"
        return init.exists() and _binds(init, name)
    return _binds(mod_file, name)


def _binds(path: Path, name: str) -> bool:
    """Whether module ``path`` binds ``name`` at its top level."""
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)) and node.name == name:
            return True
        if isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            for t in targets:
                for el in ast.walk(t):
                    if isinstance(el, ast.Name) and el.id == name:
                        return True
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            for a in node.names:
                if (a.asname or a.name.split(".")[0]) == name:
                    return True
        if isinstance(node, (ast.If, ast.Try)):
            # names bound under a top-level guard
            for sub in ast.walk(node):
                if isinstance(sub, (ast.FunctionDef, ast.ClassDef)) and \
                        sub.name == name:
                    return True
                if isinstance(sub, ast.Name) and sub.id == name and \
                        isinstance(sub.ctx, ast.Store):
                    return True
    return False


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_and_no_reference_import(path):
    bad = []
    for lineno, absolute, _level, _mod, _names in _imports(path):
        if absolute is None:
            continue
        top = absolute.split(".")[0]
        if top in ("jax", "jaxlib") or top == "ray_tpu":
            bad.append(f"{path.name}:{lineno}: import {absolute}")
    assert not bad, bad


@pytest.mark.parametrize("path", [p for p in FILES if PORT in p.parents],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_relative_imports_resolve(path):
    bad = []
    for lineno, _abs, level, module, names in _imports(path):
        if level == 0:
            continue
        base = _package_of(path)
        for _ in range(level - 1):
            base = base.parent
        if PORT != base and PORT not in base.parents:
            bad.append(f"{lineno}: relative import leaves the port")
            continue
        for name in names or (None,):
            if name == "*":
                name = None
            if not _resolves(base, module, name):
                bad.append(f"{lineno}: from {'.' * level}{module or ''} "
                           f"import {name}")
    assert not bad, f"{path.relative_to(ROOT)}: {bad}"


def test_walk_covers_the_port():
    # the walk sees the runtime, not only the scheduling slice
    names = {str(p.relative_to(PORT)) for p in FILES if PORT in p.parents}
    for must in ("api.py", "runtime/raylet.py", "runtime/worker.py",
                 "ops/locality_kernel.py", "serve/gossip.py",
                 "native/__init__.py"):
        assert must in names, must
