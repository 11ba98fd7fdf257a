"""ray_tpu_torch.serve — scalable deployments over actor replica pools.

Reference parity: ``ray.serve`` (``python/ray/serve/``) —
``@serve.deployment`` wraps a class/function, ``.bind(...)`` builds an
application graph, ``serve.run`` materializes it as a controller +
replica actors, ``DeploymentHandle.remote`` routes requests across
replicas, autoscaling tracks ongoing requests against a target, and
handles compose (a deployment takes another's handle), and an HTTP
proxy routes ``route_prefix`` requests into the replica sets.  The
routers' load gossip (``gossip``) and the capacity-loan manager
(``loaning``) that ``Cluster`` builds are exported beside them.
"""

from ..common.status import BackPressureError
from .batching import batch
from .deployment import (Application, Deployment, DeploymentHandle,
                         delete, deployment, get_deployment_handle,
                         get_multiplexed_model_id, http_address,
                         multiplexed, run, shutdown, start, status)
from .gossip import LoadBoard, board, fold_all
from .http_proxy import HTTPRequest
from .loaning import CapacityLoanManager
from .router import RequestRouter, RouterGroup

__all__ = ["Application", "BackPressureError", "batch",
           "CapacityLoanManager", "Deployment", "DeploymentHandle",
           "delete", "deployment", "get_deployment_handle",
           "get_multiplexed_model_id", "http_address", "HTTPRequest",
           "LoadBoard", "board", "fold_all", "multiplexed",
           "RequestRouter", "RouterGroup", "run", "shutdown", "start",
           "status"]
