"""MeshTrainer: data-parallel training over this host's devices from one
process.

The device-first counterpart of the actor-gang trainer: instead of N
Python worker processes exchanging gradients through a host-side
collective, one process drives every device.  The global batch is
sharded over the ranks, every rank computes its gradients
(``torch.func.grad_and_value``), one all-reduce over
``DeviceCollectiveGroup`` (NCCL between GPUs) averages them with the
loss, and the optimizer update runs replicated on every rank, as the
reference's ``shard_map`` step with its ``pmean`` does
(SURVEY.md §2.3/§2.4 TPU-native equivalents; mount empty).
"""

from __future__ import annotations

import copy
from typing import Callable

import numpy as np

from .checkpoint import Checkpoint
from .trainer import Result


class MeshTrainer:
    def __init__(self, loss_fn: Callable, init_params,
                 *, optimizer: Callable | None = None, devices=None):
        """``loss_fn(params: dict[str, Tensor], batch: Tensor) -> 0-d
        Tensor``; ``init_params`` a dict of tensors or arrays;
        ``optimizer`` builds a ``torch.optim.Optimizer`` from the
        parameter list (default: ``SGD(lr=1e-2)``, the reference's
        ``optax.sgd(1e-2)``); ``devices`` are the ranks (default: every
        CUDA device, a ``RuntimeError`` without one)."""
        import torch

        from ..convert import params_from_arrays
        from ..util.collective import DeviceCollectiveGroup
        self._group = DeviceCollectiveGroup(devices)
        self.devices = self._group.devices
        self.n_devices = self._group.world_size
        self._grad = torch.func.grad_and_value(loss_fn)
        if optimizer is None:
            def optimizer(ps):
                return torch.optim.SGD(ps, lr=1e-2)
        # the parameters in the order of JAX's pytree (sorted keys), so
        # an optimizer's state lines up with optax's (convert.py)
        self._names = sorted(init_params)
        # one replica per rank, each with its own optimizer
        self._replicas = [params_from_arrays(init_params, d)
                          for d in self.devices]
        self._opts = [optimizer([rep[k] for k in self._names])
                      for rep in self._replicas]

    def step(self, batch) -> float:
        """One global-batch step; returns the (replicated) loss."""
        import torch
        shards = self._shards(batch)
        flats = []
        for rep, shard in zip(self._replicas, shards):
            grads, loss = self._grad(rep, shard)
            flats.append(torch.cat([grads[k].reshape(-1)
                                    for k in self._names]
                                   + [loss.reshape(1)]))
        # the gradient sync: one all-reduce of grads and loss, then the
        # mean (the reference's pmean)
        sums = self._group.allreduce(flats, "sum")
        for rep, opt, flat in zip(self._replicas, self._opts, sums):
            mean = flat / self.n_devices
            pos = 0
            for k in self._names:
                p = rep[k]
                p.grad = mean[pos:pos + p.numel()].view_as(p).to(p.dtype)
                pos += p.numel()
            opt.step()
        return float(sums[0][-1]) / self.n_devices

    def _shardable(self, batch):
        """Trim the leading axis to a multiple of the rank count (the
        reference's rule: every rank takes an equal shard)."""
        import torch
        x = batch if isinstance(batch, torch.Tensor) \
            else torch.as_tensor(np.asarray(batch))
        n = self.n_devices
        keep = (x.shape[0] // n) * n
        if keep == 0:
            raise ValueError(
                f"batch of {x.shape[0]} rows cannot shard over "
                f"{n} devices")
        return x[:keep]

    def _shards(self, batch) -> list:
        x = self._shardable(batch)
        return [s.to(d, non_blocking=True)
                for s, d in zip(x.chunk(self.n_devices), self.devices)]

    @property
    def params(self) -> dict:
        """Rank 0's replica (every rank holds the same)."""
        return self._replicas[0]

    def fit(self, dataset, *, epochs: int = 1,
            global_batch_size: int = 256) -> Result:
        """Train over a ``ray_tpu_torch.data.Dataset`` (or an array or
        tensor batch source): batches stream from the object store
        through ``iter_batches``, every step shards one of them over the
        ranks."""
        history: list[dict] = []
        loss = float("nan")
        for epoch in range(epochs):
            losses = []
            for batch in self._batches(dataset, global_batch_size):
                losses.append(self.step(batch))
            loss = float(np.mean(losses)) if losses else float("nan")
            history.append({"epoch": epoch, "loss": loss})
        return Result(
            metrics=history[-1] if history else {},
            checkpoint=Checkpoint({
                "params": {k: _cpu_copy(v)
                           for k, v in self.params.items()},
                "opt_state": _cpu_copy(self._opts[0].state_dict())}),
            history=history)

    def _batches(self, dataset, batch_size: int):
        import torch
        if hasattr(dataset, "iter_batches"):
            # drop the ragged tail: every step sees the same shard shape
            for batch in dataset.iter_batches(batch_size=batch_size):
                if len(batch) == batch_size:
                    yield batch
        else:
            arr = dataset if isinstance(dataset, torch.Tensor) \
                else np.asarray(dataset)
            for i in range(0, len(arr) - batch_size + 1, batch_size):
                yield arr[i:i + batch_size]

    def restore(self, checkpoint: Checkpoint) -> None:
        """Load the params (tensors or arrays) and optimizer state of a
        checkpoint into every replica."""
        import torch

        from ..convert import params_from_arrays
        state = checkpoint.to_dict()
        params = params_from_arrays(state["params"], "cpu")
        with torch.no_grad():
            for rep, opt in zip(self._replicas, self._opts):
                for k in self._names:
                    rep[k].copy_(params[k])
                # a copy each: load_state_dict keeps the tensors it is
                # given where device and dtype already match, and the
                # replicas' optimizers must not share state
                opt.load_state_dict(copy.deepcopy(state["opt_state"]))


def _cpu_copy(obj):
    """``obj`` with every tensor copied to the host (a state_dict holds
    the live state tensors, which later steps update in place)."""
    import torch
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _cpu_copy(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_cpu_copy(v) for v in obj)
    return obj
