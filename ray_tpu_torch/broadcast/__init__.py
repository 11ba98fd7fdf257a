"""Broadcast plane: topology-aware 1->N object distribution.

The N->1 half of the object plane (striped multi-source pull) has a
1->N sibling here: a relay tree shaped over the node-bandwidth matrix
(``plan.py`` / ``ops/broadcast_kernel.py``), executed by per-node relay
sessions that serve each chunk onward the moment it lands
(``relay.py``), coordinated head-side with directory updates, pull
grafting and failure fallback (``manager.py``).
"""

from .manager import BroadcastManager
from .plan import BroadcastPlan, balanced_plan, build_plan
from .relay import BroadcastEndpoint, BroadcastRelayError

__all__ = ["BroadcastManager", "BroadcastPlan", "BroadcastEndpoint",
           "BroadcastRelayError", "balanced_plan", "build_plan"]
