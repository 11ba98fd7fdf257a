"""Streaming dataset execution: bounded-memory pipelines over generators.

Reference parity: upstream Data's streaming executor runs map stages
over blocks with bounded in-flight resources instead of materializing
every block (``python/ray/data/_internal/execution/`` — SURVEY.md §1
layer 14; mount empty).  The rebuild's shape: the SOURCE is a streaming
generator task (``num_returns="streaming"`` — the block producer pauses
on consumer backpressure), map stages are per-block tasks submitted
with a bounded window, and consumed block refs drop immediately so
reference counting reclaims them.  Peak store occupancy is
O(window + backpressure), not O(total blocks) — the property
``tests/test_streaming.py`` pins.
"""

from __future__ import annotations

from collections import deque
from typing import Any, Callable, Iterable, Iterator


def _api():
    import ray_tpu_torch
    return ray_tpu_torch


# adaptive-window defaults: keep roughly this many bytes of blocks in
# flight (upstream: the streaming executor's memory budget), clamped
# to a sane block-count range
_TARGET_INFLIGHT_BYTES = 32 * 1024 * 1024
_MIN_WINDOW, _MAX_WINDOW = 1, 32


class DataStream:
    """A lazy, bounded-memory block pipeline.

    Build with :func:`stream_range` / :func:`stream_from_items` /
    :func:`stream_blocks`, chain ``.map``/``.map_batches``/``.filter``,
    then drain with ``iter_blocks()`` / ``iter_rows()`` / ``take_all()``.
    Nothing executes until iteration starts.

    The in-flight window is ADAPTIVE by default (``window=None``):
    per-block size stats (plasma sizes probed before consumption,
    ``ColumnBlock.nbytes``/estimates after) feed a rolling average, and
    the window holds ``target_inflight_bytes`` of blocks in flight —
    big blocks shrink it, tiny blocks widen it (upstream: block
    metadata feeding the streaming executor's memory accounting).
    ``.window(n)`` pins a fixed count instead."""

    def __init__(self, source_fn: Callable[[], Iterable[list]],
                 stages: tuple = (), window: int | None = None,
                 target_inflight_bytes: int = _TARGET_INFLIGHT_BYTES):
        self._source_fn = source_fn
        self._stages = stages
        self._window = None if window is None else max(int(window), 1)
        self._target_bytes = max(int(target_inflight_bytes), 1)

    # -- transforms (lazy) ---------------------------------------------------
    def map(self, fn: Callable[[Any], Any]) -> "DataStream":
        return DataStream(self._source_fn,
                          self._stages + (("map", fn),), self._window,
                          self._target_bytes)

    def map_batches(self, fn: Callable[[list], list]) -> "DataStream":
        return DataStream(self._source_fn,
                          self._stages + (("map_batches", fn),),
                          self._window, self._target_bytes)

    def filter(self, fn: Callable[[Any], bool]) -> "DataStream":
        return DataStream(self._source_fn,
                          self._stages + (("filter", fn),),
                          self._window, self._target_bytes)

    def window(self, n: int) -> "DataStream":
        """Pin a fixed number of blocks in flight through the stages."""
        return DataStream(self._source_fn, self._stages, n,
                          self._target_bytes)

    def target_bytes(self, n: int) -> "DataStream":
        """Adaptive-window memory budget (bytes of blocks in flight)."""
        return DataStream(self._source_fn, self._stages, None, n)

    @staticmethod
    def _probe_size(ref) -> int | None:
        """Plasma size of an un-consumed block ref (exact, no get)."""
        try:
            from ray_tpu_torch.api import _get_runtime
            store = getattr(_get_runtime(), "store", None)
            if store is None:
                return None
            kind, size = store.plasma_info(ref.id)
            return size if kind in ("shm", "spill") else None
        except Exception:   # noqa: BLE001 — stats only
            return None

    @staticmethod
    def _block_size(block) -> int:
        nb = getattr(block, "nbytes", None)
        if nb is not None:
            return int(nb)
        if isinstance(block, (list, tuple)) and block:
            import sys
            return len(block) * max(sys.getsizeof(block[0]), 1)
        return 1024

    # -- execution -----------------------------------------------------------
    def iter_blocks(self) -> Iterator[list]:
        """Drive the pipeline: blocks stream from the generator source,
        at most ``window`` are in the map stages at once, and each
        yielded block's refs drop before the next is requested."""
        ray = _api()
        stages = self._stages

        @ray.remote(num_returns="streaming")
        def _source(src):
            yield from src()

        @ray.remote
        def _apply(block, staged=stages):
            from .block import ColumnBlock
            for kind, fn in staged:
                if kind == "map_batches":
                    out = fn(block)
                    # columnar in, columnar out: a ColumnBlock result
                    # stays a block (don't iterate it into rows)
                    block = out if isinstance(out, ColumnBlock) \
                        else list(out)
                    continue
                rows = block.to_rows() \
                    if isinstance(block, ColumnBlock) else block
                if kind == "map":
                    block = [fn(r) for r in rows]
                else:
                    block = [r for r in rows if fn(r)]
            return block

        gen = _source.remote(self._source_fn)
        inflight: deque = deque()       # refs moving through the stages
        src_done = False
        sizes: deque = deque(maxlen=16)     # recent block size stats

        def allowed_window() -> int:
            if self._window is not None:
                return self._window
            if not sizes:
                return 2                # probe conservatively first
            avg = max(sum(sizes) // len(sizes), 1)
            return min(max(self._target_bytes // avg, _MIN_WINDOW),
                       _MAX_WINDOW)

        while inflight or not src_done:
            while not src_done and len(inflight) < allowed_window():
                try:
                    block_ref = next(gen)
                except StopIteration:
                    src_done = True
                    break
                probed = self._probe_size(block_ref)
                if probed:
                    sizes.append(probed)
                if stages:
                    inflight.append(_apply.remote(block_ref))
                    del block_ref       # the stage task owns it now
                else:
                    inflight.append(block_ref)
            if not inflight:
                break
            ref = inflight.popleft()
            block = ray.get(ref, timeout=300)
            del ref                     # consumed: reclaimable NOW
            sizes.append(self._block_size(block))
            yield block

    def iter_rows(self) -> Iterator[Any]:
        for block in self.iter_blocks():
            yield from block

    def take_all(self) -> list:
        return list(self.iter_rows())

    def count(self) -> int:
        return sum(len(b) for b in self.iter_blocks())


def stream_range(n: int, *, block_size: int = 1000,
                 window: int | None = None) -> DataStream:
    """A streaming source of ``range(n)`` in ``block_size`` blocks."""
    def source():
        for lo in range(0, n, block_size):
            yield list(range(lo, min(lo + block_size, n)))
    return DataStream(source, window=window)


def stream_from_items(items: list, *, block_size: int = 1000,
                      window: int | None = None) -> DataStream:
    items = list(items)

    def source():
        for lo in range(0, len(items), block_size):
            yield items[lo:lo + block_size]
    return DataStream(source, window=window)


def stream_blocks(make_blocks: Callable[[], Iterable[list]], *,
                  window: int | None = None) -> DataStream:
    """A streaming source from any block-yielding callable (runs INSIDE
    the generator task — e.g. read files lazily)."""
    return DataStream(make_blocks, window=window)


def stream_block_files(paths_or_dir, *,
                       window: int | None = None) -> DataStream:
    """Stream ``.rtb`` columnar block files (the read_parquet-
    equivalent local binary reader) — files are read lazily INSIDE the
    source generator task, one ColumnBlock per file, so peak memory
    follows the adaptive window, never the dataset size."""
    from .block import block_file_paths, read_block_file
    paths = block_file_paths(paths_or_dir)

    def source():
        for p in paths:
            yield read_block_file(p)
    return DataStream(source, window=window)
