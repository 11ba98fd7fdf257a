"""The dispatch-path factory of the delta-scheduling heartbeat.

In the JAX package this module also holds ``ShardedDeltaScheduler``, the
heartbeat with node rows sharded over a device mesh.  Its port is the
ROADMAP's sharded-beat item; until it lands, a request that resolves to
more than one shard raises instead of running something else.
"""

from __future__ import annotations

from .policy import DeltaScheduler


def resolve_shards(requested: int, n_devices: int) -> int:
    """Effective shard count: 0 => one shard per local device, clamped
    to the device count and rounded DOWN to a power of two so the
    bucketed node axis (always a power of two >= 64) divides evenly and
    global traversal indices stay inside the packed key's NODE_BITS."""
    s = n_devices if requested <= 0 else min(requested, n_devices)
    s = max(s, 1)
    return 1 << (s.bit_length() - 1)


def make_delta_scheduler(crm, n_shards: int | None = None,
                         reduce_mode: str | None = None, device=None):
    """The heartbeat engine for ``crm`` on ``device`` (the GPU unless the
    caller asks for the CPU): the single-device ``DeltaScheduler`` when
    the shard count resolves to 1 over the local devices.

    ``n_shards``/``reduce_mode`` default to the ``scheduler_shards`` /
    ``scheduler_shard_reduce`` knobs.  More than one shard raises
    ``NotImplementedError``: the sharded beat is not ported yet.
    """
    import torch

    from ..common.config import get_config
    from ..device import resolve_device
    cfg = get_config()
    requested = cfg.scheduler_shards if n_shards is None else n_shards
    mode = cfg.scheduler_shard_reduce if reduce_mode is None \
        else reduce_mode
    dev = resolve_device(device)
    n_devices = torch.cuda.device_count() if dev.type == "cuda" else 1
    s = resolve_shards(requested, n_devices)
    if s <= 1:
        return DeltaScheduler(crm, device=dev)
    raise NotImplementedError(
        f"{s}-way sharded heartbeat (reduce_mode={mode!r}) is not ported "
        "yet: ROADMAP.md, section A, item 11 (sharded beat)")
