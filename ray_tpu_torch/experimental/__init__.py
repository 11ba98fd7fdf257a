"""ray_tpu_torch.experimental — internal/advanced APIs.

Reference parity: ``ray.experimental`` hosts ``internal_kv`` (SURVEY.md
§1 layer 3; mount empty).
"""

from . import internal_kv

__all__ = ["internal_kv"]
