"""ddmin delta debugging over fault schedules.

Bit-identical replay makes every probe exactly one deterministic sim
run: a subset of a failing schedule either still reproduces the failure
signature or it does not, with no flakiness to average over.  That
turns Zeller's ddmin into a practical minimizer for chaos campaigns —
a 40-op failing schedule typically shrinks to the 2–3 ops that matter
in a few dozen probes.

The algorithm here is the classic one (test subsets, then complements,
then double the granularity) followed by a one-minimality sweep: drop
each remaining item individually and keep the drop if the failure
still reproduces.  The sweep guarantees the result is 1-minimal —
removing ANY single op breaks reproduction — which is the property the
committed regression artifacts advertise.

Probes are memoised on the index subset, so the sweep never re-runs a
configuration ddmin already tried.
"""

from __future__ import annotations

__all__ = ["ddmin"]


def _split(idx: list, n: int) -> list:
    """``idx`` in ``n`` contiguous chunks, sizes differing by <= 1."""
    k, m = divmod(len(idx), n)
    out, pos = [], 0
    for i in range(n):
        size = k + (1 if i < m else 0)
        if size:
            out.append(idx[pos:pos + size])
        pos += size
    return out


def ddmin(items: list, test, progress=None) -> tuple[list, dict]:
    """Minimize ``items`` such that ``test(subset)`` stays True.

    ``test`` takes a sub-list of ``items`` (order preserved) and returns
    True iff the failure still reproduces; it must be True for the full
    list (asserted).  Returns ``(minimized_items, stats)`` where stats
    counts executed probes and memo hits.  The minimized list is
    1-minimal: dropping any single element stops reproduction.
    """
    stats = {"probes": 0, "cache_hits": 0}
    cache: dict = {}

    def probe(ids: tuple) -> bool:
        if ids in cache:
            stats["cache_hits"] += 1
            return cache[ids]
        stats["probes"] += 1
        r = bool(test([items[i] for i in ids]))
        cache[ids] = r
        if progress:
            progress(f"ddmin probe {stats['probes']}: "
                     f"{len(ids)}/{len(items)} ops -> "
                     f"{'fail' if r else 'pass'}")
        return r

    idx = tuple(range(len(items)))
    if not probe(idx):
        raise ValueError("ddmin: full input does not reproduce the "
                         "failure — nothing to minimize")

    n = 2
    while len(idx) >= 2:
        chunks = _split(list(idx), n)
        reduced = False
        for c in chunks:                    # try each subset alone
            if probe(tuple(c)):
                idx, n, reduced = tuple(c), 2, True
                break
        if not reduced and n > 2:
            for c in chunks:                # try each complement
                rest = tuple(i for i in idx if i not in set(c))
                if rest and probe(rest):
                    idx, n, reduced = rest, max(n - 1, 2), True
                    break
        if not reduced:
            if n >= len(idx):
                break
            n = min(2 * n, len(idx))

    # one-minimality sweep: every survivor must be load-bearing
    changed = True
    while changed and len(idx) > 1:
        changed = False
        for i in idx:
            rest = tuple(j for j in idx if j != i)
            if probe(rest):
                idx, changed = rest, True
                break

    return [items[i] for i in idx], stats
