"""Host-side control-plane RPC (TCP, length-prefixed frames).

Reference parity: upstream's control plane is gRPC/protobuf everywhere —
``src/ray/rpc/`` (``GrpcServer``, ``ClientCallManager``, retryable
clients) carrying ``NodeManagerService``/``CoreWorkerService``/
``gcs_service.proto`` (SURVEY.md §1 layer 2; mount empty).

Device-first form: the DEVICE data plane needs no RPC at all (scheduler
state is resident in device memory on the driver's raylet), so the host
control plane can stay deliberately small: a threaded TCP server with
4-byte length-prefixed cloudpickle frames, request pipelining (ids +
per-request dispatch threads, so a blocking ``get`` on one request does
not stall the connection), and typed error propagation.  This carries
the driver<->head boundary (client mode, job submission) the way the
reference's gRPC carries daemon-to-daemon traffic.
"""

from .breaker import CircuitOpenError
from .client import RemoteRpcError, RpcClient, RpcConnectionError, RpcFuture
from .server import RpcServer
from .transport import (TcpTransport, Transport, connect, get_transport,
                        serve)
from .wire import RawReply, RawResult

__all__ = ["RpcServer", "RpcClient", "RpcConnectionError",
           "RemoteRpcError", "RpcFuture", "RawReply", "RawResult",
           "CircuitOpenError", "Transport", "TcpTransport",
           "get_transport", "connect", "serve"]
