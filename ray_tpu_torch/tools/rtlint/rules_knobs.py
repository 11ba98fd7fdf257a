"""W3 config-knob discipline.

Three checks against ``_CONFIG_DEFS`` in ``<package>/common/config.py``:

- **unknown knob**: an attribute read off a config-shaped receiver
  (``get_config().X``, or a variable assigned from ``get_config()`` /
  ``Config.instance()`` / ``Config.reset()``) that names no defined
  knob.  This is the typo'd ``RT_*`` override that silently no-ops.
- **unused knob**: a defined knob no package file ever reads — via
  attribute, ``getattr(cfg, "name")``, or a string literal mention
  (covers dynamic ``to_dict()``-driven consumers).
- **empty doc**: a knob whose doc string is empty/whitespace.
"""

from __future__ import annotations

import ast

from .finding import Finding

# attributes on Config that are API, not knobs
_CONFIG_API = {"instance", "reset", "defs", "to_dict", "to_json",
               "_instance", "_lock"}

_CFG_CALLS = {"get_config"}
_CFG_CLASS_METHODS = {"instance", "reset"}


def load_defs(config_path: str) -> dict[str, dict]:
    """Parse ``_CONFIG_DEFS`` -> {knob: {"line": n, "doc": str}}."""
    with open(config_path, "r", encoding="utf-8") as f:
        tree = ast.parse(f.read(), filename=config_path)
    for node in ast.walk(tree):
        targets = []
        if isinstance(node, ast.Assign):
            targets = [t.id for t in node.targets if isinstance(t, ast.Name)]
        elif isinstance(node, ast.AnnAssign) and \
                isinstance(node.target, ast.Name):
            targets = [node.target.id]
        if "_CONFIG_DEFS" not in targets or node.value is None:
            continue
        if not isinstance(node.value, ast.Dict):
            break
        out = {}
        for k, v in zip(node.value.keys, node.value.values):
            if not (isinstance(k, ast.Constant) and isinstance(k.value, str)):
                continue
            doc = ""
            if isinstance(v, ast.Tuple) and len(v.elts) >= 3:
                d = v.elts[2]
                # doc may be an implicit-concat of strings => Constant
                if isinstance(d, ast.Constant) and isinstance(d.value, str):
                    doc = d.value
                elif isinstance(d, ast.JoinedStr):
                    doc = "f-string"
            out[k.value] = {"line": k.lineno, "doc": doc}
        return out
    raise ValueError(f"_CONFIG_DEFS dict not found in {config_path}")


def _is_config_call(call: ast.AST) -> bool:
    if not isinstance(call, ast.Call):
        return False
    f = call.func
    if isinstance(f, ast.Name) and f.id in _CFG_CALLS:
        return True
    if isinstance(f, ast.Attribute):
        if f.attr in _CFG_CALLS:                      # config.get_config()
            return True
        if f.attr in _CFG_CLASS_METHODS and \
                isinstance(f.value, ast.Name) and f.value.id == "Config":
            return True
    return False


class _Scan(ast.NodeVisitor):
    def __init__(self, ctx, defs, config_rel):
        self.ctx = ctx
        self.defs = defs
        self.config_rel = config_rel
        self.refs: set[str] = set()
        self.strings: set[str] = set()
        self.findings: list[Finding] = []
        self.cfg_names: set[str] = set()     # vars bound to a Config
        self.cfg_attrs: set[str] = set()     # self.X bound to a Config
        self._qual: list[str] = []

    # -- scope bookkeeping ---------------------------------------------------
    def _sym(self):
        return ".".join(self._qual) or "<module>"

    def visit_ClassDef(self, node):
        self._qual.append(node.name)
        self.generic_visit(node)
        self._qual.pop()

    def visit_FunctionDef(self, node):
        self._qual.append(node.name)
        self.generic_visit(node)
        self._qual.pop()

    visit_AsyncFunctionDef = visit_FunctionDef

    # -- binding config receivers -------------------------------------------
    def visit_Assign(self, node):
        if _is_config_call(node.value):
            for t in node.targets:
                if isinstance(t, ast.Name):
                    self.cfg_names.add(t.id)
                elif isinstance(t, ast.Attribute) and \
                        isinstance(t.value, ast.Name) and t.value.id == "self":
                    self.cfg_attrs.add(t.attr)
        self.generic_visit(node)

    def _is_config_receiver(self, node) -> bool:
        if _is_config_call(node):
            return True
        if isinstance(node, ast.Name) and node.id in self.cfg_names:
            return True
        if isinstance(node, ast.Attribute) and \
                isinstance(node.value, ast.Name) and \
                node.value.id == "self" and node.attr in self.cfg_attrs:
            return True
        return False

    # -- the checks ----------------------------------------------------------
    def visit_Attribute(self, node):
        if self._is_config_receiver(node.value):
            name = node.attr
            if name in self.defs:
                self.refs.add(name)
            elif name not in _CONFIG_API and not name.startswith("__"):
                self.findings.append(Finding(
                    rule="W3", path=self.ctx.path, line=node.lineno,
                    symbol=self._sym(),
                    message=(f"config read `.{name}` names no knob in "
                             f"_CONFIG_DEFS (typo'd RT_* overrides "
                             f"silently no-op)"),
                    hint=(f"add the knob to _CONFIG_DEFS in "
                          f"{self.config_rel}, or fix the name"),
                    detail=f"unknown-knob:{name}"))
        self.generic_visit(node)

    def visit_Call(self, node):
        # getattr(cfg, "knob"[, default])
        if isinstance(node.func, ast.Name) and node.func.id == "getattr" \
                and len(node.args) >= 2 and \
                self._is_config_receiver(node.args[0]) and \
                isinstance(node.args[1], ast.Constant) and \
                isinstance(node.args[1].value, str):
            name = node.args[1].value
            if name in self.defs:
                self.refs.add(name)
            elif name not in _CONFIG_API and not name.startswith("__"):
                self.findings.append(Finding(
                    rule="W3", path=self.ctx.path, line=node.lineno,
                    symbol=self._sym(),
                    message=(f"getattr(cfg, {name!r}) names no knob in "
                             f"_CONFIG_DEFS"),
                    hint="add the knob or fix the name",
                    detail=f"unknown-knob:{name}"))
        self.generic_visit(node)

    def visit_Constant(self, node):
        if isinstance(node.value, str) and node.value in self.defs:
            self.strings.add(node.value)


def scan_file(ctx, defs, config_rel):
    """Returns (findings, referenced_knobs, string_mentions);
    ``config_rel`` is the repo-relative path of the config module."""
    s = _Scan(ctx, defs, config_rel)
    s.visit(ctx.tree)
    return s.findings, s.refs, s.strings


def global_findings(defs, refs: set, strings: set,
                    config_rel_path: str) -> list[Finding]:
    """Cross-file checks: unused knobs and empty docs."""
    out = []
    for name in sorted(defs):
        info = defs[name]
        if name not in refs and name not in strings:
            out.append(Finding(
                rule="W3", path=config_rel_path, line=info["line"],
                symbol="_CONFIG_DEFS",
                message=(f"knob `{name}` is defined but never read by any "
                         f"package module (dead RT_* surface)"),
                hint="wire it up or delete the definition",
                detail=f"unused-knob:{name}"))
        if not info["doc"].strip():
            out.append(Finding(
                rule="W3", path=config_rel_path, line=info["line"],
                symbol="_CONFIG_DEFS",
                message=f"knob `{name}` has an empty doc string",
                hint="document what the knob does and its units",
                detail=f"empty-doc:{name}"))
    return out
