"""The files each path-scoped rule audits, written once, relative to the
package.

A rule is handed the package it runs on and builds its prefixes here
(``in_scope``), so the same rules audit ``ray_tpu_torch`` and, run with
``package="ray_tpu"``, the JAX package's tree.  A prefix ending in ``/``
scopes a directory, one ending in ``.py`` a file.
"""

from __future__ import annotations

# W5 clock seam: the code the in-process simulator runs under a virtual
# clock.  Loan reclaim deadlines and gossip staleness ride the clock
# seam; the hunt must be a pure function of its Philox seed (callers
# time it themselves); the elastic training plane schedules restarts and
# drains off the shared clock (live) or the virtual clock (sim), and raw
# wall-clock reads would skew goodput accounting.
CLOCK = ("runtime/", "rpc/", "broadcast/", "leasing/", "versioning/",
         "serve/gossip.py", "serve/loaning.py",
         "sim/hunt.py", "sim/minimize.py",
         "train/elastic.py", "sim/train.py")
# W5 transport seam: endpoints built here must go through rpc.transport
TRANSPORT = ("runtime/", "broadcast/", "leasing/")
# the seams themselves, never flagged by W5
SEAMS = ("common/clock.py", "rpc/transport.py")

# W6: the code the heartbeat runs.  Single files join the scope without
# their whole package: the sim search loop (hunt/minimize) must never
# touch a device, since thousands of probe runs a hunt would serialize
# on any sync point
DEVICE = ("ops/", "scheduling/", "leasing/", "versioning/")
DEVICE_FILES = ("runtime/raylet.py", "sim/hunt.py", "sim/minimize.py",
                "train/elastic.py", "sim/train.py")

# W8: sim/trace-affecting code, the seeded fault plane and the
# sim-reachable entropy sites routed through seams
REPLAY = ("sim/",)
REPLAY_FILES = ("rpc/chaos.py", "runtime/job_manager.py",
                "util/collective.py")


def under(package: str, rels) -> tuple[str, ...]:
    """``rels`` as repo-relative paths of ``package``."""
    return tuple(f"{package}/{r}" for r in rels)


def in_scope(path: str, package: str, prefixes=(), files=()) -> bool:
    """Whether repo-relative ``path`` starts with one of ``prefixes`` or
    is one of ``files``, both relative to ``package``."""
    return path.startswith(under(package, prefixes)) or \
        path in under(package, files)
