"""rtlint — project-native concurrency & invariant analyzer for
ray_tpu_torch.

A stdlib-``ast`` static pass over the package that enforces the
invariants this codebase has already paid for in bugs:

    W1  blocking-call-under-lock   RPC / socket / sleep / join lexically
                                   inside a ``with <lock>`` block
    W2  lock-order-cycle           the global acquires-while-holding
                                   digraph must stay acyclic
    W3  config-knob-discipline     every config attribute read must name
                                   a ``_CONFIG_DEFS`` knob; every knob
                                   must be read somewhere; docs non-empty
    W4  thread-lifecycle           spawned threads are daemon or joined;
                                   pump loops don't silently swallow
                                   their own death
    W5  virtual-clock-discipline   sim-reachable code takes time from
                                   the clock seam, never ``time.*``
    W6  device-transfer            no hidden host<->device syncs on the
                                   scheduling hot path (torch idiom:
                                   .item/.tolist/.cpu/.numpy, .to("cpu"),
                                   synchronize, elapsed_time, numpy
                                   coercion of a tensor)
    W7  lockset-race               per-class Eraser: attributes shared
                                   between thread-reachable contexts
                                   must have a non-empty lockset
                                   intersection
    W8  replay-determinism         sim/trace-affecting code draws no
                                   OS/global-stream entropy and feeds
                                   no set-iteration order into the
                                   trace hash or event schedule

Run it:

    python -m ray_tpu_torch lint            # CLI wrapper
    python -m ray_tpu_torch.tools.rtlint    # same thing, explicit

Path-scoped rules (W5, W6, W8) take their scopes from ``scopes``,
relative to the package they are run on.

Existing accepted sites live in ``baseline.json`` beside this module
(``--update-baseline`` regenerates it deterministically); anything NOT
in the baseline fails the run, so the suite starts green and ratchets.

The dynamic complements live in ``ray_tpu_torch/common/lockorder.py`` (W2:
config-gated ``rtlint_runtime_lock_order`` lock wrapper that records
REAL acquisition order) and ``ray_tpu_torch/common/locksets.py`` (W7:
config-gated ``rtlint_runtime_locksets`` Eraser recorder that samples
per-thread held-sets at tracked attribute writes) — both armed during
the chaos/drain tests: static analysis proposes, the chaos plane
disposes.
"""

from .finding import Finding
from .analyzer import run_analysis, iter_package_files

__all__ = ["Finding", "run_analysis", "iter_package_files"]

__version__ = "1.0"
