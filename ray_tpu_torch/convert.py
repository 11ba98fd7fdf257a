"""Carry cluster state from the JAX package into the port.

The system has no weights; what it carries between the two packages is
the cluster resource table.  ``crm_from_arrays`` rebuilds a port
``ClusterResourceManager`` from the dense arrays a reference CRM hands
out (``ClusterResourceManager.arrays()``) and its resource names in
column order (``resource_index.names()``), so both packages schedule
the same cluster row for row and column for column.
"""

from __future__ import annotations

import numpy as np

from .common.ids import NodeID
from .common.resources import NodeResources
from .scheduling.cluster_resources import ClusterResourceManager


def crm_from_arrays(totals, avail, node_mask, resource_names
                    ) -> ClusterResourceManager:
    """A port CRM with the same rows, columns and masks.

    totals/avail: (N, R) int32 cu; node_mask: (N,) bool; resource_names:
    the names of the columns in column order (the predefined names come
    first, as every ``ResourceIndex`` orders them); columns past the last
    name are spare width and must be zero.
    Row i of the result is row i of the input.  Rows whose mask is False
    are registered and removed again, which leaves them zeroed and free,
    as the CRM keeps every unoccupied row.  Node ids are fresh; map them
    by row (``crm.id_of(row)``).
    """
    totals = np.asarray(totals, np.int32)
    avail = np.asarray(avail, np.int32)
    node_mask = np.asarray(node_mask, bool)
    n, r = totals.shape
    names = list(resource_names)[:r]
    if totals[:, len(names):].any() or avail[:, len(names):].any():
        raise ValueError(f"columns {len(names)}.. hold quantities but have "
                         "no resource name")
    crm = ClusterResourceManager(num_resource_slots=r, capacity=max(n, 1))
    for col, name in enumerate(names):
        if crm.resource_index.get_or_add(name) != col:
            raise ValueError(f"resource {name!r} cannot take column {col}: "
                             "names must list the columns in order")
    for row in range(n):
        res = NodeResources({})
        res.total_cu = {names[c]: int(totals[row, c])
                        for c in range(len(names)) if totals[row, c]}
        res.available_cu = {names[c]: int(avail[row, c])
                            for c in range(len(names)) if avail[row, c]}
        got = crm.add_node(NodeID.from_random(), res)
        assert got == row, (got, row)
    for row in np.flatnonzero(~node_mask):
        crm.remove_node(crm.id_of(int(row)))
    return crm
