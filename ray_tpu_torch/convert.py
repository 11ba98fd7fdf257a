"""Carry state from the JAX package into the port.

What the scheduler carries between the two packages is the cluster
resource table: ``crm_from_arrays`` rebuilds a port
``ClusterResourceManager`` from the dense arrays a reference CRM hands
out (``ClusterResourceManager.arrays()``) and its resource names in
column order (``resource_index.names()``), so both packages schedule
the same cluster row for row and column for column.

What training carries is parameters and optimizer state:
``params_from_arrays`` turns the reference's parameter pytree into the
same dict of tensors, and ``adam_state_from_optax`` turns optax's Adam
state into a ``torch.optim.Adam`` state_dict for the same parameters,
so a reference ``MeshTrainer`` run resumes in the port.
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


def params_from_arrays(tree, device) -> dict:
    """The same dict of tensors on ``device``, each a fresh copy.

    ``tree``: a dict (nested dicts allowed) whose leaves are arrays
    (numpy, or ``np.asarray`` of jax arrays), numpy scalars or tensors.
    """
    import torch
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = params_from_arrays(v, device)
        elif isinstance(v, torch.Tensor):
            out[k] = v.detach().to(device, copy=True)
        else:
            out[k] = torch.tensor(np.asarray(v), device=device)
    return out


def adam_state_from_optax(opt_state, names, *, lr: float = 1e-3,
                          betas=(0.9, 0.999), eps: float = 1e-8) -> dict:
    """A ``torch.optim.Adam`` state_dict from optax's Adam state.

    ``opt_state``: what ``optax.adam(...).init``/``update`` return (a
    tuple holding a state with ``count``, ``mu`` and ``nu``); ``names``:
    the parameters in the order the port's optimizer holds them
    (``MeshTrainer`` keeps JAX's order, the sorted keys).  optax's
    ``mu``/``nu`` are torch's ``exp_avg``/``exp_avg_sq`` and its
    ``count`` torch's ``step``; both correct the bias by the same
    ``1 - beta ** step``.  ``lr``, ``betas`` and ``eps`` fill the param
    group and must be those of the optimizer that loads it.
    """
    import torch
    adam = _find_adam_state(opt_state)
    if adam is None:
        raise ValueError("no Adam state (count, mu, nu) in the optax "
                         "state")
    count, mu, nu = adam
    step = torch.tensor(float(np.asarray(count)))
    state = {i: {"step": step.clone(),
                 "exp_avg": torch.tensor(np.asarray(mu[name])),
                 "exp_avg_sq": torch.tensor(np.asarray(nu[name]))}
             for i, name in enumerate(names)}
    # the param group's keys are this torch version's Adam defaults
    group = torch.optim.Adam([torch.zeros(1)], lr=lr, betas=betas,
                             eps=eps).state_dict()["param_groups"][0]
    group["params"] = list(range(len(names)))
    return {"state": state, "param_groups": [group]}


def _find_adam_state(node):
    """(count, mu, nu) of the first state in ``node`` that has them."""
    if all(hasattr(node, f) for f in ("count", "mu", "nu")):
        return node.count, node.mu, node.nu
    if isinstance(node, (list, tuple)):
        for child in node:
            found = _find_adam_state(child)
            if found is not None:
                return found
    return None
