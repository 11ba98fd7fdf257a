"""Object directory: which simulated nodes hold a copy of each object.

Reference parity: upstream's ``ObjectDirectory`` (``src/ray/object_manager/
object_directory.cc``) tracks object locations (via GCS/owner subscription)
so the ``PullManager`` can pick transfer sources; per-node plasma stores
make locality real (SURVEY.md §1 layer 6, §3.3; mount empty).

Here the arena is physically one shared mapping (the simulated-cluster
form, like upstream's ``cluster_utils.Cluster`` on one machine), so
locality is a *directory* property: large (plasma-routed) objects are
born on the node that produced them and gain locations as pulls complete.
Small in-band values live in the owner's memory store and ship with task
specs — they have no directory entry, matching upstream (only plasma
objects transfer through the object manager).
"""

from __future__ import annotations

import threading
from typing import Iterable

from ..common.ids import ObjectID


class ObjectDirectory:
    def __init__(self):
        self._lock = threading.Lock()
        self._locs: dict[ObjectID, set[int]] = {}

    def add_location(self, object_id: ObjectID, row: int) -> None:
        with self._lock:
            self._locs.setdefault(object_id, set()).add(row)

    def locations(self, object_id: ObjectID) -> tuple[int, ...]:
        with self._lock:
            return tuple(sorted(self._locs.get(object_id, ())))

    def has_location(self, object_id: ObjectID, row: int) -> bool:
        with self._lock:
            return row in self._locs.get(object_id, ())

    def is_tracked(self, object_id: ObjectID) -> bool:
        with self._lock:
            return object_id in self._locs

    def drop(self, object_ids: Iterable[ObjectID]) -> None:
        """Object deleted cluster-wide (refcount zero / loss)."""
        with self._lock:
            for oid in object_ids:
                self._locs.pop(oid, None)

    def sole_copies_on(self, row: int) -> list[ObjectID]:
        """Objects whose ONLY copy lives on ``row`` (a node holding any is
        not safe to terminate; the autoscaler migrates them first)."""
        out = []
        with self._lock:
            for oid, rows in self._locs.items():
                if rows == {row}:
                    out.append(oid)
        return out

    def on_node_removed(self, row: int) -> list[ObjectID]:
        """Node death: its copies vanish.  Returns objects whose LAST copy
        was on the dead node — they are lost (upstream: reconstructed via
        lineage or surfaced as ObjectLostError, SURVEY §5.3)."""
        lost = []
        with self._lock:
            for oid, rows in list(self._locs.items()):
                rows.discard(row)
                if not rows:
                    del self._locs[oid]
                    lost.append(oid)
        return lost

    def location_matrix(self, object_ids: list[ObjectID], n_rows: int):
        """(len(ids), n_rows) bool location mask for the pull kernel."""
        import numpy as np
        out = np.zeros((len(object_ids), n_rows), dtype=bool)
        with self._lock:
            for i, oid in enumerate(object_ids):
                for r in self._locs.get(oid, ()):
                    if r < n_rows:
                        out[i, r] = True
        return out

    def stats(self) -> dict:
        with self._lock:
            copies = sum(len(v) for v in self._locs.values())
            return {"num_tracked": len(self._locs), "num_copies": copies}
