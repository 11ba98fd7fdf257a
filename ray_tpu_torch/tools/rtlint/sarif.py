"""SARIF 2.1.0 rendering for editor/CI ingestion.

One run, one ``tool.driver`` with per-rule metadata; every finding
becomes a ``result`` with a repo-relative location and the rtlint
fingerprint under ``partialFingerprints`` (so SARIF consumers dedup
across runs the same way the baseline ratchet does).  Baselined
findings are still emitted — marked with an ``external`` suppression —
so an editor shows the accepted debt greyed out instead of hiding it.
"""

from __future__ import annotations

import json

from .finding import Finding

_SCHEMA = ("https://raw.githubusercontent.com/oasis-tcs/sarif-spec/"
           "master/Schemata/sarif-schema-2.1.0.json")

RULE_META = {
    "W1": ("blocking-call-under-lock",
           "A blocking call (RPC, sleep, join, subprocess) runs while "
           "holding a lock."),
    "W2": ("static-lock-order-cycle",
           "The static acquires-while-holding digraph has a cycle."),
    "W3": ("config-knob-discipline",
           "A config knob is undocumented, unreferenced, or accessed "
           "outside the Config surface."),
    "W4": ("thread-lifecycle",
           "A thread is constructed without a name/daemon flag or "
           "joined without a timeout."),
    "W5": ("virtual-clock-discipline",
           "Time flows from time.* instead of the clock seam in "
           "sim-reachable code."),
    "W6": ("device-transfer-discipline",
           "A device transfer or blocking readback sits on a hot path."),
    "W7": ("lockset-race",
           "An attribute is accessed from two thread-reachable "
           "contexts whose lockset intersection is empty (Eraser)."),
    "W8": ("replay-determinism",
           "Trace-affecting code draws OS/global-stream entropy or "
           "iterates an unordered set into the trace or schedule."),
    "E0": ("parse-error", "The file does not parse."),
}


def _result(f: Finding, suppressed: bool) -> dict:
    out = {
        "ruleId": f.rule,
        "level": "note" if suppressed else "warning",
        "message": {"text": f.message + (f"\nhint: {f.hint}"
                                         if f.hint else "")},
        "locations": [{
            "physicalLocation": {
                "artifactLocation": {"uri": f.path,
                                     "uriBaseId": "REPOROOT"},
                "region": {"startLine": max(f.line, 1)},
            },
            "logicalLocations": [{"fullyQualifiedName": f.symbol}],
        }],
        "partialFingerprints": {"rtlint/v1": f.fingerprint},
    }
    if suppressed:
        out["suppressions"] = [{"kind": "external",
                                "justification": "baseline.json"}]
    return out


def render(new: list[Finding], baselined: list[Finding],
           rules=()) -> str:
    """The SARIF document for one rtlint run (deterministic text)."""
    used = sorted({f.rule for f in new} | {f.rule for f in baselined}
                  | set(rules))
    driver = {
        "name": "rtlint",
        "informationUri": "ray_tpu_torch/tools/rtlint",
        "rules": [{
            "id": r,
            "name": RULE_META.get(r, (r, ""))[0],
            "shortDescription": {"text": RULE_META.get(r, (r, r))[1]},
        } for r in used],
    }
    doc = {
        "$schema": _SCHEMA,
        "version": "2.1.0",
        "runs": [{
            "tool": {"driver": driver},
            "results": [_result(f, False) for f in new] +
                       [_result(f, True) for f in baselined],
        }],
    }
    return json.dumps(doc, indent=2, sort_keys=True)
