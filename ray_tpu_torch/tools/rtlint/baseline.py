"""Baseline ratchet: grandfathered findings live in ``baseline.json``.

The file maps fingerprint -> a human-readable record (rule, path,
symbol, message) so a reader can audit WHAT was accepted without
re-running the tool.  ``--update-baseline`` regenerates it from the
current findings with sorted keys and a trailing newline, so the
round-trip is byte-deterministic (a regression test asserts this).
"""

from __future__ import annotations

import json
import os

from .finding import Finding, sort_key

_VERSION = 1


def load(path: str) -> dict[str, dict]:
    if not os.path.exists(path):
        return {}
    with open(path, "r", encoding="utf-8") as f:
        data = json.load(f)
    if data.get("version") != _VERSION:
        raise ValueError(
            f"baseline {path} has version {data.get('version')!r}, "
            f"expected {_VERSION}; regenerate with --update-baseline")
    return data.get("findings", {})


def render(findings: list[Finding]) -> str:
    """Deterministic baseline text for the given findings."""
    table = {}
    for f in sorted(findings, key=sort_key):
        table[f.fingerprint] = {
            "rule": f.rule,
            "path": f.path,
            "symbol": f.symbol,
            "message": f.message,
        }
    doc = {"version": _VERSION, "findings": dict(sorted(table.items()))}
    return json.dumps(doc, indent=2, sort_keys=True) + "\n"


def save(path: str, findings: list[Finding]) -> None:
    with open(path, "w", encoding="utf-8") as f:
        f.write(render(findings))


def split(findings: list[Finding], accepted: dict[str, dict]) -> tuple[
        list[Finding], list[Finding], list[str]]:
    """Partition into (new, baselined) findings + stale fingerprints.

    Stale entries (accepted but no longer firing) are reported so the
    baseline can ratchet DOWN, but they do not fail the run.
    """
    new, base = [], []
    seen = set()
    for f in findings:
        seen.add(f.fingerprint)
        (base if f.fingerprint in accepted else new).append(f)
    stale = sorted(fp for fp in accepted if fp not in seen)
    return new, base, stale
