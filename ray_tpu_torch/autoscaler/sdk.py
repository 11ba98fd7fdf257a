"""Programmatic autoscaler control.

Reference parity: ``ray.autoscaler.sdk.request_resources``
(``python/ray/autoscaler/sdk.py`` — SURVEY.md §1 layer 11; mount
empty): command the cluster to scale so the given resource bundles
could be scheduled, immediately and regardless of current load.  Each
call replaces the previous request; ``request_resources()`` with no
arguments clears it.
"""

from __future__ import annotations


def request_resources(num_cpus: int | None = None,
                      bundles: list[dict] | None = None) -> None:
    from ray_tpu_torch.api import _get_runtime
    reqs: list[dict] = []
    if num_cpus:
        reqs.extend({"CPU": 1} for _ in range(int(num_cpus)))
    for b in bundles or []:
        reqs.append(dict(b))
    rt = _get_runtime()
    cluster = getattr(rt, "cluster", None)
    if cluster is not None:                 # in-process driver
        asc = cluster.autoscaler
        if asc is None:
            raise RuntimeError(
                "no autoscaler is running — start one with "
                "cluster.start_autoscaler(node_types)")
        asc.request_resources(reqs)
        return
    if hasattr(rt, "request_resources"):    # client mode: head RPC
        rt.request_resources(reqs)
        return
    raise RuntimeError(
        "request_resources is callable from the driver or a connected "
        "client; worker-side calls are not supported")
