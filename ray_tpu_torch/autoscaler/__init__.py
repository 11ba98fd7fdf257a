from .autoscaler import NODE_TYPE_LABEL, StandardAutoscaler
from .demand import (FIRST_FIT_THRESHOLD, NodeTypeSpec, fit_existing,
                     get_nodes_to_launch, pack_one_node)

__all__ = ["FIRST_FIT_THRESHOLD", "NODE_TYPE_LABEL", "NodeTypeSpec",
           "StandardAutoscaler", "fit_existing", "get_nodes_to_launch",
           "pack_one_node"]
