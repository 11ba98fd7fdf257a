"""The host<->device syncs code makes on the card, each put on a line of
the package and held to W6.

W6 reads the source; this module watches a run.  ``observe(step, n)``
calls ``step()`` ``n`` times with torch's sync debug mode at "warn" (a
torch-side sync names the package line that made it) under the profiler
with Python stacks (every CUDA runtime call that blocks the host —
``cudaStreamSynchronize``, ``cudaDeviceSynchronize``,
``cudaEventSynchronize`` and the synchronous ``cudaMemcpy*``, ctypes'
included — inside the package function that made it).  ``hold(obs)``
puts each blocking call on the W6 site of that function it came from
(``w6_sites``: every site, pragma'd or baselined ones too) and fails
each one W6 does not sanction or does not see at all.

torch is imported inside the functions: the CPU tests import this
module, and no card is needed until ``observe`` runs.
"""

from __future__ import annotations

import collections
import json
import os
import re
import sys
import tempfile
import warnings

from . import analyzer, baseline as baseline_mod, rules_device

# runtime calls that block the host until the card has caught up
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize", "cudaMemcpy", "cudaMemcpy2D",
              "cudaMemcpy3D", "cudaMemcpyPeer", "cudaMemcpyFromSymbol",
              "cudaMemcpyToSymbol")
# the W6 kinds a blocking call can come from; a stream sync or a
# synchronous copy ends every tensor readback
_COPY_KINDS = ("cpu", "to_cpu", "item", "tolist", "numpy", "asarray",
               "array", "synchronize")
_KINDS = {"cudaDeviceSynchronize": ("cuda_synchronize",),
          "cudaEventSynchronize": ("synchronize", "elapsed_time")}
# the method a Python-level C call names -> the W6 kind it is
_CALL_KIND = {"cpu": "cpu", "to": "to_cpu", "item": "item",
              "tolist": "tolist", "numpy": "numpy", "asarray": "asarray",
              "array": "array", "synchronize": "synchronize",
              "_cuda_synchronize": "cuda_synchronize",
              "elapsed_time": "elapsed_time"}
_CCALL = re.compile(r"<built-in (?:method|function) (\w+)")
STEP = "rtlint.card_syncs.step"


def w6_sites(root=None, package="ray_tpu_torch",
             baseline_path=None) -> list[dict]:
    """Every W6 site of the package: ``path``, ``line``, ``symbol``,
    ``kind`` and ``how`` it is sanctioned ("pragma", "baseline") or
    "new" (a finding of ``lint``)."""
    root = os.path.abspath(root or analyzer.repo_root())
    accepted = baseline_mod.load(baseline_path or os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "baseline.json"))
    out = []
    for path in analyzer.iter_package_files(os.path.join(root, package)):
        ctx = analyzer.get_ctx(path, os.path.relpath(path, root))
        for f, quiet in rules_device.sites(ctx, package):
            out.append({"path": f.path, "line": f.line, "symbol": f.symbol,
                        "kind": f.detail.split(":", 1)[1].split("@", 1)[0],
                        "how": "pragma" if quiet else (
                            "baseline" if f.fingerprint in accepted
                            else "new")})
    return out


def _frame_pattern(package: str):
    return re.compile(rf"(?:^|/)({re.escape(package)}/[^()]*\.py)"
                      rf"\((\d+)\): (.+)$")


def observe(step, n: int, root=None, package="ray_tpu_torch") -> dict:
    """``step()`` ``n`` times under torch's sync debug mode ("warn") and
    the profiler (CPU and CUDA, Python stacks).  Returns the raw
    observation: ``warned`` ({"path:line": count} of the package lines
    torch warned at inside the steps), and the profiler's blocking
    runtime calls (``syncs``), package Python frames (``frames``),
    Python-level C calls (``ccalls``) and step windows (``steps``) as
    (start_us, end_us, ...) tuples, with ``runtime_calls``, the count of
    every CUDA runtime call by name (none at all: the profiler saw no
    device activity).  Calls are put in frames by time, so ``step`` runs
    on this thread while no other thread runs the package."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    root = os.path.abspath(root or analyzer.repo_root())
    pkg_dir = os.path.join(root, package) + os.sep
    warned: collections.Counter = collections.Counter()
    inside = [False]

    def show(message, category, filename, lineno, file=None, line=None):
        if not inside[0] or "synchroniz" not in str(message):
            return
        f = sys._getframe(1)
        while f is not None and \
                not f.f_code.co_filename.startswith(pkg_dir):
            f = f.f_back
        warned["<outside the package>" if f is None else
               f"{os.path.relpath(f.f_code.co_filename, root)}:"
               f"{f.f_lineno}"] += 1

    torch.cuda.synchronize()
    mode = torch.cuda.get_sync_debug_mode()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = show
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     with_stack=True) as prof:
            for _ in range(n):
                with record_function(STEP):
                    torch.cuda.set_sync_debug_mode("warn")
                    inside[0] = True
                    try:
                        step()
                    finally:
                        inside[0] = False
                        torch.cuda.set_sync_debug_mode(mode)
    torch.cuda.synchronize()
    obs = _from_trace(prof, package)
    obs.update(calls=n, warned=dict(warned))
    return obs


def _from_trace(prof, package) -> dict:
    """The observation from the profiler's trace: its CUDA runtime calls,
    step annotations and Python function events with their spans (the
    trace holds these where ``prof.events()`` may not: torch 2.11's
    does not)."""
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    events = trace.get("traceEvents", []) if isinstance(trace, dict) \
        else trace
    frame = _frame_pattern(package)
    obs = {"syncs": [], "frames": [], "ccalls": [], "steps": [],
           "runtime_calls": collections.Counter()}
    for ev in events:
        if ev.get("ph") != "X" or "ts" not in ev:
            continue
        t0 = float(ev["ts"])
        t1 = t0 + float(ev.get("dur", 0))
        name = ev.get("name", "")
        if ev.get("cat") == "cuda_runtime":
            obs["runtime_calls"][name] += 1
            if name in SYNC_CALLS:
                obs["syncs"].append((t0, t1, name))
        elif name == STEP:
            obs["steps"].append((t0, t1))
        elif (m := frame.search(name)) is not None:
            obs["frames"].append((t0, t1, m.group(1), int(m.group(2)),
                                  m.group(3)))
        elif (m := _CCALL.match(name)) is not None:
            obs["ccalls"].append((t0, t1, m.group(1)))
    obs["runtime_calls"] = dict(obs["runtime_calls"])
    return obs


def _def_lines(root: str, path: str) -> dict[int, str]:
    """{first line of a def (its decorator's, if any) or its ``def``
    line: qualified name} for one package file."""
    ctx = analyzer.get_ctx(os.path.join(root, path), path)
    out = {}
    for node, qual in rules_device._qualname_index(ctx.tree).items():
        out[node.lineno] = qual
        for dec in getattr(node, "decorator_list", ()):
            out.setdefault(dec.lineno, qual)
    return out


def _innermost(spans, t0, t1):
    """The span of ``spans`` that holds [t0, t1] and started last."""
    best = None
    for s in spans:
        if s[0] <= t0 and t1 <= s[1] and (best is None or s[0] >= best[0]):
            best = s
    return best


def attribute(obs: dict, sites: list[dict], root=None,
              package="ray_tpu_torch") -> dict:
    """Each blocking call of ``obs`` put on a W6 site: the innermost
    package function around it, then its sites of a kind that call can
    come from, narrowed by the C call around it and, where several
    remain, by the lines torch warned at.  Returns ``calls`` (the names
    of the blocking calls inside the steps), ``by_site`` ({"path:line":
    count}), ``unattributed`` (calls with no such site: syncs W6 does
    not see) and ``outside`` (calls in a step but in no package
    function)."""
    root = os.path.abspath(root or analyzer.repo_root())
    by_fn: dict[tuple, list] = {}
    for s in sites:
        by_fn.setdefault((s["path"], s["symbol"]), []).append(s)
    warned_lines = set(obs["warned"])
    defs: dict[str, dict] = {}
    by_site: collections.Counter = collections.Counter()
    frames = [f for f in obs["frames"] if f[2].startswith(f"{package}/")]
    calls, unattributed, outside = [], [], []
    for t0, t1, name in obs["syncs"]:
        if _innermost(obs["steps"], t0, t1) is None:
            continue            # the profiler's own, between steps
        calls.append(name)
        fr = _innermost(frames, t0, t1)
        if fr is None:
            outside.append(name)
            continue
        path, first = fr[2], fr[3]
        if path not in defs:
            defs[path] = _def_lines(root, path)
        qual = defs[path].get(first, fr[4])
        kinds = _KINDS.get(name, _COPY_KINDS)
        cands = [s for s in by_fn.get((path, qual), ())
                 if s["kind"] in kinds]
        cc = _innermost([c for c in obs["ccalls"] if c[0] >= fr[0]],
                        t0, t1)
        if cc is not None and len(cands) > 1:
            named = [s for s in cands if s["kind"] == _CALL_KIND.get(cc[2])]
            cands = named or cands
        if len(cands) > 1:
            cands = [s for s in cands
                     if f"{s['path']}:{s['line']}" in warned_lines] or cands
        if not cands:
            unattributed.append(f"{name} in {path}({first}): {qual}")
            continue
        by_site[f"{cands[0]['path']}:{cands[0]['line']}"] += 1
    return {"calls": calls, "by_site": dict(by_site),
            "unattributed": unattributed, "outside": outside}


def hold(obs: dict, sites: list[dict] | None = None, root=None,
         package="ray_tpu_torch") -> dict:
    """``obs`` held to W6: every blocking call attributed to a sanctioned
    site (pragma or baseline), every line torch warned at one too.
    ``ok`` is False on a sync W6 does not see, an unsanctioned site, or
    a run in which the profiler saw no CUDA runtime call."""
    sites = w6_sites(root, package) if sites is None else sites
    how = {f"{s['path']}:{s['line']}": s["how"] for s in sites}
    att = attribute(obs, sites, root, package)
    seen = set(att["by_site"]) | set(obs["warned"])
    unsanctioned = sorted(s for s in seen
                          if how.get(s) not in ("pragma", "baseline"))
    n_syncs = len(att["calls"])
    return {"syncs": n_syncs, "syncs_per_call": n_syncs / obs["calls"],
            "by_call": dict(collections.Counter(att["calls"])),
            "by_site": {s: {"count": c, "how": how.get(s, "not a W6 site")}
                        for s, c in sorted(att["by_site"].items())},
            "warned": dict(sorted(obs["warned"].items())),
            "unattributed": att["unattributed"] + [
                f"{name} outside the package" for name in att["outside"]],
            "unsanctioned": unsanctioned,
            "runtime_calls_seen": sum(obs["runtime_calls"].values()),
            "ok": bool(obs["runtime_calls"]) and not att["unattributed"]
            and not att["outside"] and not unsanctioned}
