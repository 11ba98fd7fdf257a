"""ray_tpu_torch — the PyTorch/CUDA port of ray_tpu.

A second package beside ``ray_tpu`` (the JAX reference, unchanged) that
mirrors its module tree and names.  This first slice carries the
scheduling data plane — the int32 scheduling contract, the cluster
resource manager, the delta-scheduling heartbeat (``DeltaScheduler``) on
torch residents with a hand-written CUDA water-fill kernel — and the ops
library's flash attention as a hand-written CUDA kernel.  The runtime API
(``init/remote/get/...``) arrives with the runtime slice (ROADMAP.md).

The package imports ``torch`` and numpy, never JAX and nothing of
``ray_tpu``.  Entry points run on the GPU unless the caller asks for the
CPU (``ray_tpu_torch.device.resolve_device``).
"""

__version__ = "0.1.0"

from .common import (Config, NodeResources, ResourceRequest, get_config)


def __getattr__(name):
    if name in ("ops", "scheduling", "convert", "device"):
        # NOT `from . import ops`: that re-enters __getattr__ via the
        # fromlist hasattr probe before the submodule import finishes.
        import importlib
        return importlib.import_module(f".{name}", __name__)
    raise AttributeError(f"module 'ray_tpu_torch' has no attribute {name!r}")


__all__ = ["Config", "get_config", "NodeResources", "ResourceRequest"]
