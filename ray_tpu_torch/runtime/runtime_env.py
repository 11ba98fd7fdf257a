"""Runtime environments: per-task/actor worker environment provisioning.

Reference parity: ``python/ray/_private/runtime_env/`` — a per-node agent
stages ``runtime_env`` resources (working_dir/py_modules URIs into a
local cache, pip/conda environments), workers start inside the staged
environment, and staged URIs are cached/reference-counted per node
(SURVEY.md §1 layer 10; mount empty).

In-process form: the ``RuntimeEnvManager`` stages into
``<session>/runtime_resources/<digest>/`` (content-addressed cache, the
URI-cache analogue) and produces a *payload* the spawned worker applies
at startup (env vars, chdir into the staged working_dir, sys.path for
py_modules).

``pip`` requests REALLY provision when ``runtime_env_wheelhouse``
points at a local wheel directory: requirements install offline
(``pip install --no-index --find-links <wheelhouse> --target``) into a
digest-keyed package dir that workers put on ``sys.path`` — per-env
package isolation without egress, cache hits skip the install, and an
unsatisfiable requirement fails staging with ``RuntimeEnvSetupError``
(the reference's pip plugin provisions a virtualenv the same way).
Without a wheelhouse, pip/conda requests are validated against the
already-present interpreter environment (zero-egress fallback).
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading

from .serialization import RayError


class RuntimeEnvSetupError(RayError):
    """Staging a runtime_env failed (reference:
    ``ray.exceptions.RuntimeEnvSetupError``)."""


_ALLOWED_KEYS = {"env_vars", "working_dir", "py_modules", "pip", "conda"}


def normalize(env: dict | None) -> tuple | None:
    """Canonical hashable form (the worker-pool cache key).  Raises
    ValueError for ANY malformed env — including non-JSON values, which
    json.dumps reports as TypeError: callers catch ValueError to fail
    the task, and an uncaught TypeError after resource admission would
    leak the reservation every scheduling round."""
    if not env:
        return None
    unknown = set(env) - _ALLOWED_KEYS
    if unknown:
        raise ValueError(f"unsupported runtime_env keys: {sorted(unknown)}")
    try:
        return tuple(sorted(
            (k, json.dumps(env[k], sort_keys=True)) for k in env))
    except TypeError as e:
        raise ValueError(f"runtime_env is not JSON-serializable: {e}") \
            from e


def env_key(env: dict | None) -> str | None:
    norm = normalize(env)
    if norm is None:
        return None
    return hashlib.sha256(repr(norm).encode()).hexdigest()[:16]


def merge_runtime_env(job_env: dict | None,
                      task_env: dict | None) -> dict | None:
    """Task/actor env over job env; ``env_vars`` merge key-wise
    (reference runtime_env inheritance semantics).  Idempotent, so it is
    safe for a spec to cross more than one merge point."""
    if not job_env:
        return task_env
    if not task_env:
        return job_env
    merged = {**job_env, **task_env}
    if "env_vars" in job_env or "env_vars" in task_env:
        merged["env_vars"] = {**(job_env.get("env_vars") or {}),
                              **(task_env.get("env_vars") or {})}
    return merged


def _python_pin_satisfied(pin: str) -> bool:
    """Does the RUNNING interpreter satisfy a conda ``python`` pin?

    Handles the operator properly (``python>=3.8`` on 3.12 passes;
    ``python=3.1`` on 3.12 fails — component comparison, not string
    prefix).  Unparseable pins pass (don't invent failures for exotic
    conda syntax this deployment can't evaluate)."""
    import re
    import sys
    m = re.match(r"python\s*(>=|<=|==|!=|~=|=|>|<)?\s*([0-9.]+)?\s*$",
                 pin)
    if m is None or not m.group(2):
        return True
    op = m.group(1) or "="
    want = tuple(int(p) for p in m.group(2).strip(".").split("."))
    have = tuple(sys.version_info[:3])
    trunc = have[:len(want)]            # compare at the pin's precision
    if op in ("=", "==", "~="):
        # conda '=' / '~=' prefix semantics: 3.12.x matches '3.12'
        return trunc == want
    if op == "!=":
        return trunc != want
    if op == ">=":
        return trunc >= want
    if op == "<=":
        return trunc <= want
    if op == ">":
        return trunc > want
    return trunc < want                 # op == "<"


class RuntimeEnvManager:
    def __init__(self, session_dir: str):
        self._root = os.path.join(session_dir, "runtime_resources")
        self._lock = threading.Lock()
        self._cache: dict[str, dict] = {}       # key -> staged payload
        self._errors: dict[str, str] = {}       # key -> staging error
        self._inflight: dict[str, threading.Event] = {}  # key -> staging
        self.num_staged = 0
        self.num_pip_installs = 0       # real provisioning runs (cache
        #                                 hits do NOT increment)

    def get_if_ready(self, key: str | None) -> dict | None:
        """Cached payload for an env key, or None while unstaged/staging
        (the raylet's non-blocking dispatch probe).  Raises the cached
        RuntimeEnvSetupError for a known-bad env."""
        if key is None:
            return None
        with self._lock:
            if key in self._errors:
                raise RuntimeEnvSetupError(self._errors[key])
            return self._cache.get(key)

    def stage(self, env: dict | None) -> dict | None:
        """Stage (or fetch from cache) a runtime_env.  Returns the worker
        payload ``{"env_vars", "working_dir", "py_modules"}`` or None for
        the empty env.  Raises RuntimeEnvSetupError on failure (cached:
        repeated submissions fail fast like the reference's agent).
        Concurrent stagers of the same key wait for the first — two
        copytrees into one destination would hand a worker a
        half-written tree."""
        key = env_key(env)
        if key is None:
            return None
        while True:
            with self._lock:
                if key in self._errors:
                    raise RuntimeEnvSetupError(self._errors[key])
                cached = self._cache.get(key)
                if cached is not None:
                    return cached
                ev = self._inflight.get(key)
                if ev is None:
                    ev = threading.Event()
                    self._inflight[key] = ev
                    break
            ev.wait()       # another thread is staging this key
        try:
            payload = self._stage_fresh(key, env)
        except Exception as e:
            # EVERY failure is cached and surfaced as a setup error —
            # an uncached OSError (copytree, disk full) would otherwise
            # send the async staging path into a re-stage loop
            msg = str(e) if isinstance(e, RuntimeEnvSetupError) \
                else f"{type(e).__name__}: {e}"
            with self._lock:
                self._errors[key] = msg
            raise RuntimeEnvSetupError(msg) from e
        else:
            with self._lock:
                self._cache[key] = payload
                self.num_staged += 1
            return payload
        finally:
            with self._lock:
                self._inflight.pop(key, None)
            ev.set()

    def _stage_fresh(self, key: str, env: dict) -> dict:
        payload: dict = {"env_vars": dict(env.get("env_vars") or {}),
                         "working_dir": None, "py_modules": []}
        for k, v in payload["env_vars"].items():
            if not isinstance(k, str) or not isinstance(v, str):
                raise RuntimeEnvSetupError(
                    f"env_vars must be str->str, got {k!r}: {v!r}")
        stage_dir = os.path.join(self._root, key)
        self._provision_pip(env, stage_dir, payload)
        wd = env.get("working_dir")
        if wd:
            if not os.path.isdir(wd):
                raise RuntimeEnvSetupError(
                    f"working_dir {wd!r} does not exist")
            dst = os.path.join(stage_dir, "working_dir")
            if not os.path.isdir(dst):
                shutil.copytree(wd, dst, dirs_exist_ok=True)
            payload["working_dir"] = dst
        for mod in env.get("py_modules") or []:
            if not os.path.exists(mod):
                raise RuntimeEnvSetupError(
                    f"py_modules entry {mod!r} does not exist")
            name = os.path.basename(mod.rstrip("/"))
            dst = os.path.join(stage_dir, "py_modules", name)
            if not os.path.exists(dst):
                if os.path.isdir(mod):
                    shutil.copytree(mod, dst, dirs_exist_ok=True)
                else:
                    os.makedirs(os.path.dirname(dst), exist_ok=True)
                    shutil.copy2(mod, dst)
            # both shapes import from the staging dir: it is the parent
            # of a copied package dir and the holder of a copied file
            payload["py_modules"].append(os.path.dirname(dst))
        return payload

    @staticmethod
    def _pip_requirements(env: dict) -> list[str]:
        """Requirement strings in PIP syntax.  Conda dependencies
        translate: conda's single-``=`` version pins become pip ``==``
        pins; interpreter pins (``python=3.x``) are VALIDATED against
        the running interpreter (this deployment cannot materialize a
        different Python — no conda binary, no egress; see the README
        capability matrix) and fail staging loudly on mismatch rather
        than silently dropping."""
        import re
        import sys
        reqs = list(env.get("pip") or [])
        conda = env.get("conda")
        if isinstance(conda, dict):
            for d in conda.get("dependencies", ()):
                if not isinstance(d, str):
                    continue
                name = re.split(r"[=<>!~\[;\s]", d.strip(), 1)[0]
                if name == "python":
                    if not _python_pin_satisfied(d.strip()):
                        raise RuntimeEnvSetupError(
                            f"conda interpreter pin {d!r} does not "
                            f"match the running Python "
                            f"{'.'.join(map(str, sys.version_info[:3]))}"
                            " — this deployment provisions conda specs "
                            "through the pip wheelhouse and cannot "
                            "install a different interpreter (no conda "
                            "binary, no egress)")
                    continue
                # name=1.2 (conda) -> name==1.2 (pip); leave ==/>=/etc
                reqs.append(re.sub(r"(?<![=<>!~])=(?!=)", "==", d))
        return reqs

    def _provision_pip(self, env: dict, stage_dir: str,
                       payload: dict) -> None:
        """Install pip requirements OFFLINE from the configured local
        wheelhouse into ``<stage>/pip_pkgs`` (digest-keyed: a cache hit
        skips the install entirely) and put it on the worker path.
        Falls back to present-interpreter validation when no wheelhouse
        is configured (reference: ``python/ray/_private/runtime_env/``
        pip plugin; SURVEY.md §1 layer 10 — mount empty)."""
        import subprocess
        import sys

        from ..common.config import get_config
        reqs = self._pip_requirements(env)
        if not reqs:
            return
        wheelhouse = get_config().runtime_env_wheelhouse
        if not wheelhouse:
            self._check_requirements(env)
            return
        target = os.path.join(stage_dir, "pip_pkgs")
        if not os.path.isdir(target):
            tmp = target + ".tmp"
            shutil.rmtree(tmp, ignore_errors=True)
            proc = subprocess.run(
                [sys.executable, "-m", "pip", "install", "--no-index",
                 "--find-links", wheelhouse, "--target", tmp,
                 "--quiet", *reqs],
                capture_output=True, text=True, timeout=600)
            if proc.returncode != 0:
                shutil.rmtree(tmp, ignore_errors=True)
                tail = (proc.stderr or proc.stdout or "").strip()
                raise RuntimeEnvSetupError(
                    f"pip provisioning failed for {reqs!r} from "
                    f"wheelhouse {wheelhouse!r}: {tail[-800:]}")
            os.makedirs(stage_dir, exist_ok=True)
            os.rename(tmp, target)      # visible only when complete
            # Monotonic gauge bumped outside _lock on purpose: a lost
            # increment only undercounts a diagnostic, and taking _lock
            # here would hold it across slow pip subprocess cleanup.
            self.num_pip_installs += 1  # rtlint: disable=W7
        payload["py_modules"].append(target)

    def _check_requirements(self, env: dict) -> None:
        """Zero-egress pip/conda: requirements must already be present in
        the interpreter environment.  Checked against the DISTRIBUTION
        namespace first (pip requirements name distributions, and import
        names can differ: scikit-learn/sklearn, pillow/PIL), with an
        import-name probe as fallback."""
        import importlib.util
        import re
        from importlib import metadata
        reqs = list(env.get("pip") or [])
        conda = env.get("conda")
        if isinstance(conda, dict):
            reqs += [d for d in conda.get("dependencies", ())
                     if isinstance(d, str)]
        for req in reqs:
            name = re.split(r"[=<>!~\[;\s]", req.strip(), 1)[0]
            try:
                metadata.version(name)
                continue
            except metadata.PackageNotFoundError:
                pass
            try:
                found = importlib.util.find_spec(
                    name.replace("-", "_")) is not None
            except (ImportError, ValueError):
                found = False
            if not found:
                raise RuntimeEnvSetupError(
                    f"runtime_env requirement {req!r} is not installed "
                    "and this deployment has no package egress "
                    "(pip/conda provisioning is validation-only here)")

    def stats(self) -> dict:
        with self._lock:
            return {"num_staged": self.num_staged,
                    "num_cached": len(self._cache),
                    "num_failed": len(self._errors),
                    "num_pip_installs": self.num_pip_installs}


def apply_payload(payload: dict | None) -> None:
    """Worker-side: enter the staged environment (env vars, working dir,
    module paths) before executing any task."""
    if not payload:
        return
    import sys
    os.environ.update(payload.get("env_vars") or {})
    for p in payload.get("py_modules") or []:
        if p not in sys.path:
            sys.path.insert(0, p)
    wd = payload.get("working_dir")
    if wd:
        os.chdir(wd)
        if wd not in sys.path:
            sys.path.insert(0, wd)
