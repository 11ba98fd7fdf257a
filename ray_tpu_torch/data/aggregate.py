"""Grouped aggregation + file IO for ray_tpu_torch.data.

Reference parity: ``ray.data``'s ``Dataset.groupby(key).count()/sum()/
mean()/aggregate(AggregateFn)`` runs a distributed aggregation
(per-block partial accumulation, then a merge stage), and its read/write
layer maps files to blocks (``read_text``/``read_csv``/
``Dataset.write_json`` — ``python/ray/data/grouped_data.py``,
``read_api.py``; SURVEY.md §1 layer 14; mount empty).

Shapes here:
- partial aggregation is one task per block (dict: key -> accumulator),
- partials merge on workers in a binary tree (the driver never funnels
  the full key space),
- the result is a normal ``Dataset`` of ``(key, value)`` rows sorted by
  key, so further transforms compose.
"""

from __future__ import annotations

import builtins
import csv
import json
import os
from typing import Any, Callable


from .dataset import _api


# -- task bodies (run in workers) --------------------------------------------

def _partial_agg(key_fn, init, accumulate, block):
    out: dict = {}
    for row in block:
        k = key_fn(row) if key_fn is not None else row
        if k not in out:
            out[k] = init(k)
        out[k] = accumulate(out[k], row)
    return out


def _merge_partials(merge, a: dict, b: dict) -> dict:
    out = dict(a)
    for k, v in b.items():
        out[k] = merge(out[k], v) if k in out else v
    return out


def _read_text_file(path: str):
    with open(path, "r", encoding="utf-8") as f:
        return [line.rstrip("\r\n") for line in f]


def _read_csv_file(path: str):
    with open(path, "r", encoding="utf-8", newline="") as f:
        return [dict(row) for row in csv.DictReader(f)]


def _write_json_block(block, path: str):
    rows = [r.tolist() if hasattr(r, "tolist") else r for r in block]
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(rows, f)
    os.replace(tmp, path)
    return path


# -- grouped dataset ---------------------------------------------------------

class GroupedDataset:
    """What ``Dataset.groupby(key_fn)`` returns; finish with an
    aggregation."""

    def __init__(self, dataset, key_fn: Callable | None):
        self._ds = dataset
        self._key_fn = key_fn

    def aggregate(self, *, init: Callable[[Any], Any],
                  accumulate: Callable[[Any, Any], Any],
                  merge: Callable[[Any, Any], Any]):
        """General distributed aggregation (the AggregateFn shape):
        ``init(key)`` makes an accumulator, ``accumulate(acc, row)``
        folds a row in, ``merge(a, b)`` combines two partials."""
        from .dataset import Dataset, _from_rows
        rt = _api()
        partial = rt.remote(_partial_agg)
        partials = [partial.remote(self._key_fn, init, accumulate, b)
                    for b in self._ds._blocks]
        merger = rt.remote(_merge_partials)
        while len(partials) > 1:        # binary merge tree, on workers
            nxt = [merger.remote(merge, partials[i], partials[i + 1])
                   for i in builtins.range(0, len(partials) - 1, 2)]
            if len(partials) % 2:
                nxt.append(partials[-1])
            partials = nxt
        final = rt.get(partials[0], timeout=300) if partials else {}
        try:
            rows = sorted(final.items())
        except TypeError:       # mixed/unorderable keys: stable fallback
            rows = sorted(final.items(), key=lambda kv: repr(kv[0]))
        return _from_rows(rows, max(min(8, len(rows)), 1))

    def count(self):
        return self.aggregate(init=lambda k: 0,
                              accumulate=lambda acc, row: acc + 1,
                              merge=lambda a, b: a + b)

    def sum(self, fn: Callable | None = None):
        take = fn if fn is not None else (lambda row: row)
        return self.aggregate(init=lambda k: 0,
                              accumulate=lambda acc, row: acc + take(row),
                              merge=lambda a, b: a + b)

    def mean(self, fn: Callable | None = None):
        take = fn if fn is not None else (lambda row: row)
        sums = self.aggregate(
            init=lambda k: (0, 0),
            accumulate=lambda acc, row: (acc[0] + take(row), acc[1] + 1),
            merge=lambda a, b: (a[0] + b[0], a[1] + b[1]))
        return sums.map(lambda kv: (kv[0], kv[1][0] / kv[1][1]))


# -- file IO -----------------------------------------------------------------

def read_text(paths: str | list[str]):
    """One block per file, rows are lines."""
    return _read_files(paths, _read_text_file)


def read_csv(paths: str | list[str]):
    """One block per file, rows are header-keyed dicts."""
    return _read_files(paths, _read_csv_file)


def _read_files(paths, reader):
    from .dataset import Dataset
    rt = _api()
    if isinstance(paths, str):
        paths = [paths]
    expanded: list[str] = []
    for p in paths:
        if os.path.isdir(p):
            expanded.extend(
                full for name in sorted(os.listdir(p))
                if os.path.isfile(full := os.path.join(p, name)))
        else:
            expanded.append(p)
    if not expanded:
        raise ValueError("no input files")
    for p in expanded:
        if not os.path.isfile(p):
            raise FileNotFoundError(p)
    task = rt.remote(reader)
    return Dataset([task.remote(p) for p in expanded],
                   [-1] * len(expanded))


def write_json(dataset, directory: str) -> list[str]:
    """One ``part-NNNNN.json`` per block; returns the written paths.
    Stale parts from a previous larger write are cleared only AFTER the
    new writes all land — a failed write must not destroy the previous
    output (each part itself lands via atomic rename)."""
    rt = _api()
    os.makedirs(directory, exist_ok=True)
    writer = rt.remote(_write_json_block)
    refs = [writer.remote(b, os.path.join(directory, f"part-{i:05d}.json"))
            for i, b in enumerate(dataset._blocks)]
    written = rt.get(refs, timeout=300)
    keep = {os.path.basename(p) for p in written}
    for name in os.listdir(directory):
        if name.startswith("part-") and name.endswith(".json") \
                and name not in keep:
            os.unlink(os.path.join(directory, name))
    return written
