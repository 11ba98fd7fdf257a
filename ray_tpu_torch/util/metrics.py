"""User-defined metrics exported on the Prometheus endpoint.

Reference parity: ``ray.util.metrics`` — ``Counter``/``Gauge``/
``Histogram`` with tag keys, registered into the same exporter that
serves the core metrics (``python/ray/util/metrics.py`` +
``src/ray/stats/`` — SURVEY.md §1 layer 12, §5.5; mount empty).

Process-local (the driver's endpoint exports the driver's metrics —
the reference aggregates per-node through agents; here the cluster is
one process, so one registry suffices).
"""

from __future__ import annotations

import bisect
import threading

_lock = threading.Lock()
_registry: dict[str, "_Metric"] = {}


def _tags_key(tags: dict | None) -> tuple:
    return tuple(sorted((tags or {}).items()))


class _Metric:
    def __init__(self, name: str, description: str = "",
                 tag_keys: tuple = ()):
        if not name.replace("_", "").isalnum():
            raise ValueError(f"invalid metric name {name!r}")
        self.name = name
        self.description = description
        self.tag_keys = tuple(tag_keys)
        self._default_tags: dict = {}
        with _lock:
            prev = _registry.get(name)
            if prev is not None:
                # re-creation (module reload, per-job setup re-run)
                # ADOPTS the existing series — two registry entries
                # would emit duplicate HELP/TYPE blocks, which
                # Prometheus rejects for the whole scrape
                if type(prev) is not type(self):
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{type(prev).__name__}")
                self._adopt(prev)
            else:
                self._series: dict[tuple, float] = {}
                _registry[name] = self

    def _adopt(self, prev: "_Metric") -> None:
        self._series = prev._series

    def set_default_tags(self, tags: dict) -> "_Metric":
        self._default_tags = dict(tags)
        return self

    def _resolve_tags(self, tags: dict | None) -> dict:
        merged = {**self._default_tags, **(tags or {})}
        extra = set(merged) - set(self.tag_keys)
        if extra:
            raise ValueError(
                f"tags {sorted(extra)} not in declared tag_keys "
                f"{self.tag_keys}")
        return merged

    def _rows(self) -> list[tuple[str, dict, float]]:
        with _lock:
            return [(self.name, dict(k), v)
                    for k, v in self._series.items()]


class Counter(_Metric):
    TYPE = "counter"

    def inc(self, value: float = 1.0, tags: dict | None = None) -> None:
        if value < 0:
            raise ValueError("counters only go up")
        key = _tags_key(self._resolve_tags(tags))
        with _lock:
            self._series[key] = self._series.get(key, 0.0) + value


class Gauge(_Metric):
    TYPE = "gauge"

    def set(self, value: float, tags: dict | None = None) -> None:
        key = _tags_key(self._resolve_tags(tags))
        with _lock:
            self._series[key] = float(value)


class Histogram(_Metric):
    TYPE = "histogram"

    def __init__(self, name: str, description: str = "",
                 boundaries: list[float] | None = None,
                 tag_keys: tuple = ()):
        self.boundaries = sorted(boundaries or
                                 [0.001, 0.01, 0.1, 1.0, 10.0])
        self._counts: dict[tuple, list[int]] = {}
        self._sums: dict[tuple, float] = {}
        super().__init__(name, description, tag_keys)

    def _adopt(self, prev: "Histogram") -> None:
        super()._adopt(prev)
        self.boundaries = prev.boundaries   # bucket layout must match
        self._counts = prev._counts
        self._sums = prev._sums

    def observe(self, value: float, tags: dict | None = None) -> None:
        key = _tags_key(self._resolve_tags(tags))
        with _lock:
            counts = self._counts.setdefault(
                key, [0] * (len(self.boundaries) + 1))
            counts[bisect.bisect_left(self.boundaries, value)] += 1
            self._sums[key] = self._sums.get(key, 0.0) + value

    def _rows(self):
        # rendered specially in render_user_metrics
        return []


def _escape(value) -> str:
    """Prometheus label-value escaping: one bad tag must not corrupt
    the whole exposition (the endpoint also serves core metrics)."""
    return str(value).replace("\\", r"\\").replace('"', r"\"") \
        .replace("\n", r"\n")


def _fmt_labels(tags: dict, extra: dict | None = None) -> str:
    merged = {**tags, **(extra or {})}
    if not merged:
        return ""
    return "{" + ",".join(f'{k}="{_escape(v)}"'
                          for k, v in sorted(merged.items())) + "}"


def render_user_metrics() -> list[str]:
    """Prometheus text lines for every registered user metric (the
    exporter appends these after the core gauges)."""
    out: list[str] = []
    with _lock:
        metrics = list(_registry.values())
    for m in metrics:
        full = f"ray_tpu_user_{m.name}"
        out.append(f"# HELP {full} {m.description}")
        out.append(f"# TYPE {full} {m.TYPE}")
        if isinstance(m, Histogram):
            with _lock:
                items = [(dict(k), list(c), m._sums.get(k, 0.0))
                         for k, c in m._counts.items()]
            for tags, counts, total in items:
                cum = 0
                for bound, c in zip(m.boundaries, counts):
                    cum += c
                    out.append(
                        f"{full}_bucket"
                        f"{_fmt_labels(tags, {'le': bound})} {cum}")
                cum += counts[-1]
                out.append(
                    f"{full}_bucket"
                    f"{_fmt_labels(tags, {'le': '+Inf'})} {cum}")
                out.append(f"{full}_sum{_fmt_labels(tags)} {total}")
                out.append(f"{full}_count{_fmt_labels(tags)} {cum}")
        else:
            for _name, tags, value in m._rows():
                out.append(f"{full}{_fmt_labels(tags)} {value}")
    return out


def _reset_registry() -> None:
    """Test helper: drop all registered metrics."""
    with _lock:
        _registry.clear()


__all__ = ["Counter", "Gauge", "Histogram", "render_user_metrics"]
