"""ray_tpu_torch — the PyTorch/CUDA port of ray_tpu.

A second package beside ``ray_tpu`` (the JAX reference, unchanged) that
mirrors its module tree and names.  It carries the scheduling data plane
(the int32 scheduling contract, the cluster resource manager, the
delta-scheduling heartbeat on torch residents with a hand-written CUDA
water-fill kernel, its localized mode for locality rounds, and the
bundle/pull/broadcast programs, the top-k spread and the autoscaler's
demand packing with a hand-written CUDA launch-loop kernel), the ops
library's flash attention as a hand-written CUDA kernel, the runtime
(``init/remote/get/put/wait``, actors, placement groups, the autoscaler
loop) and its daemon half: a head daemon with worker-node agents,
client mode (``init(address=...)``), job submission and the CLI
(``python -m ray_tpu_torch``).  Above the runtime: serve, the
model-version plane (``versioning``), workflows, the metrics exporter
and the dashboard, user metrics, the actor-backed queue, the runtime
lock-order recorder and datasets (``data``: block-parallel transforms
whose ``iter_torch_batches`` feeds the GPU).  Beside it, the in-process
cluster simulator (``sim``: chaos campaigns on a virtual clock, whose
trace hashes equal the reference's, and the ``hunt`` search), behind
the CLI's ``simulate`` and ``hunt``.  The training libraries:
collectives over NCCL (``util.collective``), ``train`` (the gang and
elastic trainers, whose workers compute on the CPU, and ``MeshTrainer``,
data-parallel over the GPUs from one process), ``tune`` and ``rllib``
(rollouts in workers, the policy update on the GPU).  The sharded paths:
the scheduler's node rows split over ranks (``ops.shard_reduce``, the
sharded heartbeat ``scheduling.ShardedDeltaScheduler`` and the
``*_sharded_np`` wrappers), ring and Ulysses attention, and ``entry``
(one heartbeat step, and a multi-rank dry run).

The package imports ``torch`` and numpy, never JAX and nothing of
``ray_tpu``.  Entry points run on the GPU unless the caller asks for the
CPU (``ray_tpu_torch.device.resolve_device``; for the runtime, the
``scheduler_device`` knob).  Workers see no GPU; the runtime's own
task code never imports torch in them (an RLlib learner computes its
gradients there on the CPU).
"""

__version__ = "0.1.0"

from .common import (Config, NodeResources, ResourceRequest, get_config)

# The runtime API (init/remote/get/put/...) is imported lazily to keep
# `import ray_tpu_torch` light for scheduler-only users.
_API_NAMES = ("init", "shutdown", "is_initialized", "remote", "get", "put",
              "wait", "cancel", "kill", "get_actor",
              "available_resources", "cluster_resources", "nodes",
              "drain_node",
              "timeline", "worker_stacks", "get_runtime_context",
              "list_named_actors")


def __getattr__(name):
    if name in _API_NAMES:
        from . import api
        return getattr(api, name)
    if name in ("ops", "scheduling", "convert", "device", "util", "serve",
                "experimental", "cross_language", "autoscaler",
                "versioning", "workflow", "data", "train", "tune",
                "rllib", "entry"):
        # NOT `from . import ops`: that re-enters __getattr__ via the
        # fromlist hasattr probe before the submodule import finishes.
        # Only submodules that EXIST belong here.
        import importlib
        return importlib.import_module(f".{name}", __name__)
    raise AttributeError(f"module 'ray_tpu_torch' has no attribute {name!r}")


__all__ = ["Config", "get_config", "NodeResources", "ResourceRequest",
           *_API_NAMES]
