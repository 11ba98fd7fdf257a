"""Where the port's tensors live.

The port runs on the GPU.  An entry point that is given no device puts
its work on ``cuda``; the CPU is used only when the caller asks for it
(``device="cpu"``, or CPU tensors as inputs), which is how the tests run
the plain PyTorch versions of the kernels.  Nothing falls back to the CPU
when no GPU is found: that is an error.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``torch.device`` for ``device``; None means the GPU.

    Raises ``RuntimeError`` when the resolved device is CUDA and CUDA is
    not available — the caller has to ask for the CPU explicitly.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "ray_tpu_torch runs on the GPU and CUDA is not available; "
            "pass device='cpu' to run the plain PyTorch path")
    return dev
