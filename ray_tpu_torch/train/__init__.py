"""ray_tpu_torch.train — distributed training orchestration.

Reference parity: ``ray.train`` (``python/ray/train/``) — a ``Trainer``
runs ``train_loop_per_worker`` on a gang of worker actors sized by
``ScalingConfig``, workers sync gradients through a collective backend,
report metrics/checkpoints via ``train.report``, and ``fit()`` returns a
``Result`` (SURVEY.md §1 layer 14, §2.4 DP row; mount empty).

Three trainers, all real:

- **JaxTrainer** (alias ``TorchTrainer``) — the reference shape: N
  worker actors placed as a PACK gang, per-worker dataset shards,
  gradient allreduce over the ``ray_tpu_torch.util.collective``
  process group, and gang fault tolerance (``FailureConfig``): on a
  worker death the gang restarts and resumes from the checkpoint rank 0
  persisted via ``train.report``.  Its workers compute on the CPU, as
  every worker of the runtime does.
- **ElasticTrainer** — ``JaxTrainer`` with a cluster-durable run
  identity: epoch/step journaled into the GCS-snapshotted KV (a
  promoted standby inherits the run), resume weights broadcast-fed to
  (re)joining workers, checkpoints replicated off the writing node,
  drains/loan-reclaims handled as planned resizes, and SIGKILL
  mid-allreduce recovered via typed ``GangMemberLost`` gang re-form.
- **MeshTrainer** — the device-first shape and the training path on
  the GPU: ONE process, N devices; the batch is sharded over the
  ranks, grads are averaged by an NCCL all-reduce and params stay
  replicated, so data parallelism is a device collective, not N
  Python processes.
"""

from .checkpoint import Checkpoint
from .elastic import ElasticTrainer
from .mesh import MeshTrainer
from .trainer import (FailureConfig, JaxTrainer, Result, ScalingConfig,
                      TorchTrainer, get_checkpoint, get_context, report)

__all__ = ["Checkpoint", "ElasticTrainer", "FailureConfig", "JaxTrainer",
           "MeshTrainer", "Result", "ScalingConfig", "TorchTrainer",
           "get_checkpoint", "get_context", "report"]
