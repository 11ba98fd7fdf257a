"""Dataset: block-parallel transforms executed as tasks.

Blocks are plain lists (row datasets) or numpy arrays (tensor
datasets); each transform ships one task per block and the results stay
in the object store until consumed (reference: ``ray.data``'s
block/BlockMetadata model with task-based map stages — SURVEY.md §1
layer 14; mount empty).
"""

from __future__ import annotations

import builtins
from typing import Any, Callable, Iterable, Iterator

import numpy as np


def _api():
    import ray_tpu_torch
    return ray_tpu_torch


# -- block-level task bodies (top-level so cloudpickle ships cleanly) --------

def _map_block(fn, block):
    if isinstance(block, np.ndarray):
        return np.asarray([fn(row) for row in block])
    return [fn(row) for row in block]


def _map_batches_block(fn, block):
    return fn(block)


def _filter_block(fn, block):
    if isinstance(block, np.ndarray):
        mask = np.asarray([bool(fn(row)) for row in block])
        return block[mask]
    return [row for row in block if fn(row)]


def _flat_map_block(fn, block):
    out: list = []
    for row in block:
        out.extend(fn(row))
    return out


def _sort_block(block, key):
    if isinstance(block, np.ndarray):
        keys = np.asarray([key(r) for r in block]) if key is not None \
            else block
        return block[np.argsort(keys, kind="stable")]
    return sorted(block, key=key)


def _merge_sorted(blocks, key):
    import heapq
    rows: Iterable[Any]
    rows = heapq.merge(*[list(b) for b in blocks], key=key)
    return list(rows)


def _shuffle_partition(blocks, n_out: int, seed: int, salt: int):
    """Map stage of a distributed shuffle: split one block into n_out
    pseudo-random buckets (deterministic in (seed, salt, position))."""
    rng = np.random.default_rng((seed, salt))
    rows = list(blocks)
    dests = rng.integers(0, n_out, size=len(rows))
    return [[row for row, d in zip(rows, dests) if d == i]
            for i in builtins.range(n_out)]


def _shuffle_concat(seed: int, idx: int, *buckets):
    """Reduce stage: concatenate one bucket from every map output and
    locally shuffle the concatenation."""
    out: list = []
    for b in buckets:
        out.extend(b)
    rng = np.random.default_rng((seed, 10_000 + idx))
    rng.shuffle(out)
    return out


class Dataset:
    """A list of block ObjectRefs + row counts."""

    def __init__(self, block_refs: list, counts: list[int]):
        self._blocks = list(block_refs)
        self._counts = list(counts)

    # -- transforms (each = one task per block) ------------------------------
    def _per_block(self, body, fn) -> "Dataset":
        rt = _api()
        task = rt.remote(body)
        refs = [task.remote(fn, b) for b in self._blocks]
        return Dataset(refs, self._counts)

    def map(self, fn: Callable[[Any], Any]) -> "Dataset":
        return self._per_block(_map_block, fn)

    def map_batches(self, fn: Callable[[Any], Any]) -> "Dataset":
        """``fn`` sees a whole block (list or ndarray) and returns the
        transformed block — the accelerator-friendly hook: batch work,
        not per-row Python."""
        ds = self._per_block(_map_batches_block, fn)
        ds._counts = [-1] * len(ds._blocks)     # fn may change row counts
        return ds

    def filter(self, fn: Callable[[Any], bool]) -> "Dataset":
        ds = self._per_block(_filter_block, fn)
        ds._counts = [-1] * len(ds._blocks)
        return ds

    def flat_map(self, fn: Callable[[Any], Iterable[Any]]) -> "Dataset":
        ds = self._per_block(_flat_map_block, fn)
        ds._counts = [-1] * len(ds._blocks)
        return ds

    def repartition(self, num_blocks: int) -> "Dataset":
        if num_blocks <= 0:
            raise ValueError("num_blocks must be positive")
        rows = self._materialize_rows()
        return _from_rows(rows, num_blocks)

    def random_shuffle(self, *, seed: int = 0) -> "Dataset":
        """Two-stage distributed shuffle: per-block bucket split (map
        tasks), then per-bucket concatenation (reduce tasks) — the
        all-to-all shape of the reference's push-based shuffle."""
        rt = _api()
        n = len(self._blocks)
        reduce_task = rt.remote(_shuffle_concat)
        if n <= 1:
            return Dataset(
                [reduce_task.remote(seed, 0, b) for b in self._blocks],
                [-1] * n)
        # map stage emits n SEPARATE return objects per block, so each
        # reduce task pulls only its bucket refs — nothing funnels
        # through the driver (the all-to-all stays in the object store)
        split = rt.remote(_shuffle_partition).options(num_returns=n)
        part_refs = [split.remote(b, n, seed, i)
                     for i, b in enumerate(self._blocks)]
        refs = [reduce_task.remote(seed, j, *[pr[j] for pr in part_refs])
                for j in builtins.range(n)]
        return Dataset(refs, [-1] * n)

    def sort(self, key: Callable | None = None) -> "Dataset":
        rt = _api()
        sort_task = rt.remote(_sort_block)
        sorted_refs = [sort_task.remote(b, key) for b in self._blocks]
        blocks = rt.get(sorted_refs, timeout=300)
        merged = _merge_sorted(blocks, key)
        return _from_rows(merged, max(len(self._blocks), 1))

    def groupby(self, key_fn: Callable | None = None):
        """Group rows by ``key_fn(row)`` (identity when None); finish
        with ``.count()/.sum()/.mean()/.aggregate(...)`` — distributed
        per-block partials + a worker-side merge tree."""
        from .aggregate import GroupedDataset
        return GroupedDataset(self, key_fn)

    def union(self, other: "Dataset") -> "Dataset":
        return Dataset(self._blocks + other._blocks,
                       self._counts + other._counts)

    def write_json(self, directory: str) -> list[str]:
        """One ``part-NNNNN.json`` per block; returns written paths."""
        from .aggregate import write_json
        return write_json(self, directory)

    def split(self, n: int) -> list["Dataset"]:
        """N aligned shards (for per-worker ingest in training)."""
        rows = self._materialize_rows()
        shards = np.array_split(np.arange(len(rows)), n)
        return [_from_rows([rows[i] for i in shard], 1)
                for shard in shards]

    # -- consumers -----------------------------------------------------------
    def _materialize(self) -> list:
        return _api().get(list(self._blocks), timeout=300)

    def _materialize_rows(self) -> list:
        rows: list = []
        for block in self._materialize():
            rows.extend(list(block))
        return rows

    def count(self) -> int:
        if all(c >= 0 for c in self._counts):
            return sum(self._counts)
        return sum(len(b) for b in self._materialize())

    def take(self, k: int = 20) -> list:
        out: list = []
        rt = _api()
        for ref in self._blocks:
            out.extend(list(rt.get(ref, timeout=300)))
            if len(out) >= k:
                return out[:k]
        return out

    def take_all(self) -> list:
        return self._materialize_rows()

    def sum(self):
        vals = self._materialize_rows()
        return sum(vals)

    def to_numpy(self) -> np.ndarray:
        blocks = [np.asarray(b) for b in self._materialize()]
        return np.concatenate([b for b in blocks if b.size]) \
            if blocks else np.empty(0)

    def iter_batches(self, *, batch_size: int = 256) \
            -> Iterator[np.ndarray]:
        """Stream fixed-size numpy batches across block boundaries —
        the training-ingest hook (pad/drop is the caller's choice)."""
        carry: list = []
        for block in self._materialize():
            carry.extend(list(block))
            while len(carry) >= batch_size:
                yield np.asarray(carry[:batch_size])
                carry = carry[batch_size:]
        if carry:
            yield np.asarray(carry)

    def iter_torch_batches(self, *, batch_size: int = 256,
                           dtype=None, device=None):
        """``iter_batches`` as torch tensors (reference:
        ``Dataset.iter_torch_batches``) — the torch-training ingest
        hook.  Batches land on ``device``: None means the GPU
        (``ray_tpu_torch.device.resolve_device``; a ``RuntimeError``
        without CUDA), ``"cpu"`` keeps them on the host, zero-copy from
        the numpy batch where dtypes allow."""
        import torch

        from ..device import resolve_device
        dev = resolve_device(device)
        non_blocking = dev.type == "cuda"
        for batch in self.iter_batches(batch_size=batch_size):
            # iter_batches yields fresh contiguous arrays; one fused
            # .to(device, dtype) avoids a second full-batch copy
            yield torch.from_numpy(batch).to(dev, dtype=dtype,
                                              non_blocking=non_blocking)

    def num_blocks(self) -> int:
        return len(self._blocks)

    def __repr__(self) -> str:
        return f"Dataset(num_blocks={len(self._blocks)})"


# -- constructors ------------------------------------------------------------

def _from_rows(rows: list, num_blocks: int) -> Dataset:
    rt = _api()
    chunks = np.array_split(np.arange(len(rows)), num_blocks)
    refs, counts = [], []
    for chunk in chunks:
        block = [rows[i] for i in chunk]
        refs.append(rt.put(block))
        counts.append(len(block))
    return Dataset(refs, counts)


def from_items(items: Iterable[Any], *, parallelism: int = 8) -> Dataset:
    rows = list(items)
    return _from_rows(rows, max(min(parallelism, len(rows)), 1))


def range(n: int, *, parallelism: int = 8) -> Dataset:  # noqa: A001
    return from_items(builtins.range(n), parallelism=parallelism)


def from_numpy(arr: np.ndarray, *, parallelism: int = 8) -> Dataset:
    rt = _api()
    arr = np.asarray(arr)
    chunks = [c for c in np.array_split(arr, parallelism) if len(c)] \
        or [arr]
    return Dataset([rt.put(c) for c in chunks],
                   [len(c) for c in chunks])
