"""ray_tpu_torch.serve — the parts of serve the runtime needs.

``Cluster`` builds the capacity-loan manager (``loaning``) and the
health manager folds the routers' load gossip (``gossip``) on every
probe round, so the runtime slice carries these two modules.  The rest
of serve (deployments, the router, batching, the HTTP proxy) is
ROADMAP.md A.16; until then no router group exists in the process.
"""

from .gossip import LoadBoard, board, fold_all
from .loaning import CapacityLoanManager

__all__ = ["CapacityLoanManager", "LoadBoard", "board", "fold_all"]
