"""CLI entry points (``python -m ray_tpu_torch`` / console script).

Reference parity: ``python/ray/scripts/scripts.py`` — ``ray start/stop/
status/memory/timeline/microbenchmark`` and ``ray job submit/status/
logs/list/stop`` (SURVEY.md §1 layer 15; mount empty).
"""

from .cli import main

__all__ = ["main"]
