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
        if top in ("jax", "jaxlib", "optax") or top == "ray_tpu":
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


# the modules of the autoscaler, top-k and daemon slice
SLICE_MODULES = ("ops/binpack_kernel.py", "autoscaler/__init__.py",
                 "autoscaler/demand.py", "autoscaler/autoscaler.py",
                 "autoscaler/sdk.py", "runtime/head.py",
                 "runtime/node_agent.py", "runtime/standby.py",
                 "runtime/job_manager.py", "rpc/xlang.py",
                 "rpc/xlang_gateway.py", "cross_language.py",
                 "util/client.py", "util/state.py",
                 "experimental/__init__.py", "experimental/internal_kv.py",
                 "scripts/__init__.py", "scripts/cli.py", "__main__.py")


@pytest.mark.parametrize("module", SLICE_MODULES)
def test_slice_modules_are_walked(module):
    assert PORT / module in FILES


def test_daemon_side_imports_neither_jax_nor_torch():
    """Importing the daemon, agent, client and CLI modules pulls in no
    JAX, nothing of the JAX package, and no torch (an agent process must
    never load it)."""
    import subprocess
    import sys
    mods = [f"ray_tpu_torch.{m[:-3].replace('/', '.')}"
            for m in SLICE_MODULES
            if m.split("/")[0] in ("runtime", "rpc", "util", "scripts",
                                   "experimental", "cross_language.py")]
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'ray_tpu', 'torch'))\n"
            "print(bad)\nassert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr[-2000:]


# the modules of the training slice: collectives, train, tune, rllib
TRAIN_MODULES = ("util/collective.py", "train/__init__.py",
                 "train/checkpoint.py", "train/trainer.py",
                 "train/elastic.py", "train/mesh.py", "tune/__init__.py",
                 "tune/search.py", "tune/tuner.py", "rllib/__init__.py",
                 "rllib/algorithm.py")


@pytest.mark.parametrize("module", TRAIN_MODULES)
def test_train_modules_are_walked(module):
    assert PORT / module in FILES


def test_training_modules_import_no_torch_until_used():
    """A worker unpickles gang loops, trials and rollout workers from
    these modules: importing them pulls in no JAX, nothing of the JAX
    package, no optax and no torch (torch loads only where a function
    that computes with it runs)."""
    import subprocess
    import sys
    mods = [f"ray_tpu_torch.{m[:-3].replace('/', '.')}"
            .replace(".__init__", "") for m in TRAIN_MODULES]
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'optax', 'ray_tpu', 'torch'))\n"
            "print(bad)\nassert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr[-2000:]


# the port's rtlint (the analyzer behind ``python -m ray_tpu_torch lint``)
RTLINT_FILES = sorted((PORT / "tools").rglob("*.py"))


def test_rtlint_files_are_walked():
    names = {str(p.relative_to(PORT)) for p in RTLINT_FILES}
    for must in ("tools/__init__.py", "tools/rtlint/analyzer.py",
                 "tools/rtlint/rules_device.py", "tools/rtlint/scopes.py",
                 "tools/rtlint/card_syncs.py"):
        assert must in names, must
        assert PORT / must in FILES


@pytest.mark.parametrize("path", RTLINT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_rtlint_imports_neither_tools_nor_the_reference(path):
    """Nothing under ``ray_tpu_torch/tools/`` imports ``tools`` (the
    reference's rtlint), ``ray_tpu`` or JAX: the port keeps its own
    copy."""
    bad = [f"{path.name}:{lineno}: import {absolute}"
           for lineno, absolute, _level, _mod, _names in _imports(path)
           if absolute is not None and absolute.split(".")[0] in
           ("tools", "ray_tpu", "jax", "jaxlib")]
    assert not bad, bad


def test_rtlint_loads_no_torch_jax_or_reference():
    """Importing the port's rtlint (its CLI, every rule, the card's sync
    attribution) loads no torch, no JAX, no ``tools`` and nothing of the
    JAX package: ``lint`` is host work."""
    import subprocess
    import sys
    mods = [f"ray_tpu_torch.{str(p.relative_to(PORT))[:-3]}"
            .replace("/", ".").replace(".__init__", "")
            for p in RTLINT_FILES]
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'ray_tpu', 'tools', 'torch'))\n"
            "print(bad)\nassert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr[-2000:]
