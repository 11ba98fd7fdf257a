"""ray_tpu_torch — the PyTorch/CUDA port of ray_tpu.

A second package beside ``ray_tpu`` (the JAX reference, unchanged) that
mirrors its module tree and names.  It carries the scheduling data plane
(the int32 scheduling contract, the cluster resource manager, the
delta-scheduling heartbeat on torch residents with a hand-written CUDA
water-fill kernel, its localized mode for locality rounds, and the
bundle/pull/broadcast programs), the ops library's flash attention as a
hand-written CUDA kernel, and the runtime on one host:
``init/remote/get/put/wait``, actors and placement groups.  The daemon
and client side (``init(address=...)``, the CLI) and the libraries come
with later slices (ROADMAP.md).

The package imports ``torch`` and numpy, never JAX and nothing of
``ray_tpu``.  Entry points run on the GPU unless the caller asks for the
CPU (``ray_tpu_torch.device.resolve_device``; for the runtime, the
``scheduler_device`` knob).  Workers never import torch and see no GPU.
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
    if name in ("ops", "scheduling", "convert", "device", "util", "serve"):
        # NOT `from . import ops`: that re-enters __getattr__ via the
        # fromlist hasattr probe before the submodule import finishes.
        # Only submodules that EXIST belong here.
        import importlib
        return importlib.import_module(f".{name}", __name__)
    raise AttributeError(f"module 'ray_tpu_torch' has no attribute {name!r}")


__all__ = ["Config", "get_config", "NodeResources", "ResourceRequest",
           *_API_NAMES]
