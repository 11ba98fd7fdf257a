"""Collective communication — ``ray.util.collective`` on GPUs.

Reference parity: ``python/ray/util/collective/`` — named groups created
with ``init_collective_group(world_size, rank, backend, group_name)``,
then ``allreduce/allgather/reducescatter/broadcast/barrier/send/recv``;
NCCL backend for device tensors, Gloo for host tensors (SURVEY.md §1
layer 13; mount empty).

Two backends, both real:

- **Devices (NCCL)**: collectives over this host's GPUs from one
  process, through NCCL's single-process, multi-device calls
  (``torch.cuda.nccl``: all-reduce, all-gather, reduce-scatter,
  broadcast; peer copies for the ring shift), the counterpart of the
  reference's one XLA program over its devices.  On CPU ranks a plain
  stack-and-reduce computes the same results.
  ``DeviceCollectiveGroup`` below.

- **Process group (the Gloo analogue)**: named groups spanning worker
  processes/actors/driver, rendezvoused through the GCS KV store; every
  collective is a full barrier, and a two-phase-lagged garbage sweep
  (rank 0 deletes round ``s`` keys at round ``s+2`` — by the time any
  rank reaches ``s+2`` every rank has finished reading ``s``) keeps KV
  memory bounded.  ``init_collective_group`` + module-level ops below.
"""

from __future__ import annotations

import time

import numpy as np

from ..common.config import get_config
from ..runtime.serialization import deserialize, serialize

_NAMESPACE = "collective"


class GangMemberLost(TimeoutError):
    """A collective round timed out with specific ranks missing — the
    signature of a gang peer SIGKILLed between barrier and reduce.
    Subclasses TimeoutError so pre-existing deadline handling still
    catches it; carries the group/round/ranks so an elastic trainer can
    convert it into a planned gang re-form instead of a failure."""

    def __init__(self, group: str, seq: int, missing, timeout: float):
        self.group = group
        self.seq = int(seq)
        self.missing_ranks = sorted(int(r) for r in missing)
        self.timeout_s = float(timeout)
        super().__init__(
            f"collective {group} round {seq}: ranks "
            f"{self.missing_ranks} missing after {timeout}s "
            f"(gang member lost)")

    def __reduce__(self):
        # Exception's default reduce replays the formatted message into
        # the 4-arg __init__; rebuild from the typed fields instead so
        # the error survives the task-result pickle round-trip
        return (GangMemberLost, (self.group, self.seq,
                                 self.missing_ranks, self.timeout_s))


def _resolve_timeout(timeout: float | None) -> float:
    """Per-call override, else the W3-wired collective_timeout_s knob."""
    if timeout is not None:
        return float(timeout)
    return float(get_config().collective_timeout_s)


_REDUCERS = {
    "sum": lambda arrs: np.sum(arrs, axis=0),
    "prod": lambda arrs: np.prod(arrs, axis=0),
    "max": lambda arrs: np.max(arrs, axis=0),
    "min": lambda arrs: np.min(arrs, axis=0),
}


# ---------------------------------------------------------------------------
# device backend (NCCL between this host's GPUs; stack-and-reduce on CPU)
# ---------------------------------------------------------------------------

# ncclRedOp_t of the reductions NCCL computes itself (prod is an
# all-gather and a local product, as in the reference)
_NCCL_OPS = {"sum": 0, "max": 2, "min": 3}


class DeviceCollectiveGroup:
    """Collectives across this host's devices, one rank per device.

    Input carries a leading ``world_size`` axis, one slice per rank:
    either one ``(W, ...)`` tensor or array, whose slices go to their
    ranks' devices, or a sequence of W tensors with slice r on rank r's
    device.  Outputs keep that axis and the input's kind: a sequence in
    gives a list out (slice r on rank r's device), a tensor in a tensor
    on the input's device.

    On GPUs every op is NCCL's single-process, multi-device API
    (``torch.cuda.nccl``): one process drives all ranks, the shape of
    the reference's one compiled program over the host's devices, and
    nothing is reduced on the host.  On CPU ranks
    (``devices=["cpu"] * 8``, the tests' mirror of the reference's 8
    CPU devices) the plain version stacks the slices and reduces them.
    """

    def __init__(self, devices=None):
        import torch

        from ..device import resolve_device
        if devices is None:
            resolve_device(None)        # RuntimeError without CUDA
            devices = [torch.device("cuda", i)
                       for i in range(torch.cuda.device_count())]
        self.devices = [resolve_device(d) for d in devices]
        kinds = {d.type for d in self.devices}
        if not self.devices or len(kinds) != 1 or \
                kinds - {"cpu", "cuda"}:
            raise ValueError(f"a device group is all CUDA devices or all "
                             f"CPU ranks, not {devices!r}")
        self._nccl = kinds == {"cuda"}
        if self._nccl:
            self.devices = [
                d if d.index is not None
                else torch.device("cuda", torch.cuda.current_device())
                for d in self.devices]
            idx = [d.index for d in self.devices]
            if len(set(idx)) != len(idx):
                raise ValueError(f"NCCL takes each device once: {idx}")
        self.world_size = len(self.devices)

    # -- slices in and out ---------------------------------------------------
    def _parts(self, stacked) -> list:
        """The per-rank slices, each contiguous on its rank's device."""
        import torch
        if isinstance(stacked, (list, tuple)):
            parts = [torch.as_tensor(x) for x in stacked]
        else:
            parts = list(torch.as_tensor(stacked).unbind(0))
        if len(parts) != self.world_size or \
                len({p.shape for p in parts}) > 1:
            raise ValueError(
                f"expected {self.world_size} slices of one shape, got "
                f"{[tuple(p.shape) for p in parts]}")
        return [p.to(d).contiguous() for p, d in zip(parts, self.devices)]

    def _out(self, outs: list, stacked):
        import torch
        if isinstance(stacked, (list, tuple)):
            return outs
        home = stacked.device if isinstance(stacked, torch.Tensor) \
            else self.devices[0]
        if len(outs) == 1:
            return outs[0].to(home).unsqueeze(0)
        return torch.stack([o.to(home) for o in outs])

    # -- the ops on slices ----------------------------------------------------
    def _reduce(self, parts: list, op: str) -> list:
        """Every rank's slice becomes the reduction over all ranks."""
        import torch
        if op == "prod":
            return [g.prod(0).to(g.dtype) for g in self._gather(parts)]
        if self._nccl:
            from torch.cuda import nccl
            outs = [torch.empty_like(p) for p in parts]
            nccl.all_reduce(parts, outs, op=_NCCL_OPS[op])
            return outs
        x = torch.stack(parts)
        red = {"sum": lambda: x.sum(0).to(x.dtype),
               "max": lambda: x.amax(0),
               "min": lambda: x.amin(0)}[op]()
        return [red.clone() for _ in parts]

    def _gather(self, parts: list) -> list:
        """Every rank gets the (W, ...) stack of all slices."""
        import torch
        if self._nccl:
            from torch.cuda import nccl
            outs = [torch.empty((self.world_size, *p.shape), dtype=p.dtype,
                                device=p.device) for p in parts]
            nccl.all_gather(parts, outs)
            return outs
        x = torch.stack(parts)
        return [x.clone() for _ in parts]

    # -- public ops -----------------------------------------------------------
    def allreduce(self, stacked, op: str = "sum"):
        """(W, ...) -> (W, ...): every rank's slice becomes the
        reduction over all ranks (NCCL all-reduce for sum/max/min; prod
        is an all-gather and a local product)."""
        if op not in ("sum", "prod", "max", "min"):
            raise ValueError(f"unsupported allreduce op {op!r}")
        return self._out(self._reduce(self._parts(stacked), op), stacked)

    def allgather(self, stacked):
        """(W, ...) -> (W, W, ...): every rank sees every slice."""
        return self._out(self._gather(self._parts(stacked)), stacked)

    def reducescatter(self, stacked, op: str = "sum"):
        """(W, W_chunks...) -> (W, chunk): rank r holds the r-th chunk of
        the reduction (sum is NCCL's reduce-scatter; max/min reduce
        fully, then each rank keeps its own chunk)."""
        import torch
        if op not in ("sum", "max", "min"):
            raise ValueError(f"unsupported reducescatter op {op!r}")
        parts = self._parts(stacked)
        if parts[0].dim() == 0 or parts[0].shape[0] != self.world_size:
            raise ValueError(f"reducescatter needs {self.world_size} "
                             f"chunks a slice, got {tuple(parts[0].shape)}")
        if op == "sum" and self._nccl:
            from torch.cuda import nccl
            outs = [torch.empty(p.shape[1:], dtype=p.dtype,
                                device=p.device) for p in parts]
            nccl.reduce_scatter(parts, outs, op=_NCCL_OPS[op])
        else:
            outs = [full[r] for r, full in
                    enumerate(self._reduce(parts, op))]
        return self._out(outs, stacked)

    def broadcast(self, stacked, src_rank: int = 0):
        """(W, ...) -> (W, ...): every rank gets rank ``src_rank``'s
        slice."""
        import torch
        if not 0 <= src_rank < self.world_size:
            raise ValueError(f"src_rank {src_rank} out of range for "
                             f"world {self.world_size}")
        parts = self._parts(stacked)
        if self._nccl:
            from torch.cuda import nccl
            outs = [p.clone() if r == src_rank else torch.empty_like(p)
                    for r, p in enumerate(parts)]
            nccl.broadcast(outs, root=src_rank)
        else:
            outs = [parts[src_rank].clone() for _ in parts]
        return self._out(outs, stacked)

    def ring_shift(self, stacked, shift: int = 1):
        """(W, ...) -> (W, ...): rank r gets rank (r-shift)'s slice, a
        copy between peers (the send/recv ring primitive)."""
        parts = self._parts(stacked)
        w = self.world_size
        outs = [parts[(r - shift) % w].to(d, copy=True)
                for r, d in enumerate(self.devices)]
        return self._out(outs, stacked)


# ---------------------------------------------------------------------------
# process-group backend (Gloo analogue; KV rendezvous)
# ---------------------------------------------------------------------------

class _ProcessGroup:
    def __init__(self, group_name: str, world_size: int, rank: int):
        self.name = group_name
        self.world_size = world_size
        self.rank = rank
        self.seq = 0
        self.sid = None         # incarnation id, agreed in _handshake

    # -- kv plumbing ---------------------------------------------------------
    @staticmethod
    def _kv(op, key, value=None):
        from ..experimental.internal_kv import _kv
        return _kv(op, key, value, namespace=_NAMESPACE)

    def _key(self, seq: int, rank: int) -> str:
        return f"{self.name}/{self.sid}/{seq}/{rank}"

    def _handshake(self, timeout: float = 60.0) -> None:
        """Join barrier that also derives a per-incarnation session id:
        every rank posts a fresh random nonce, hashes all ranks' nonces
        into a candidate ``sid``, posts it as an ack, and loops —
        re-reading nonces — until every rank's ack carries the SAME sid.
        Round/p2p keys live under the sid, so keys left by a PREVIOUS
        incarnation of the same group name (crashed rank retried,
        destroy + re-init) can never be read as this incarnation's data.
        A rank that initially mixes a stale join nonce into its
        candidate sees the ack mismatch and re-reads until the fresh
        nonce lands (convergent: nonces stop changing once every member
        has posted); joining against a generation that will never
        re-ack — half of a dead group — raises TimeoutError instead of
        producing a silently wrong reduction."""
        import hashlib
        from ..common.ids import fast_random_bytes
        nonce = fast_random_bytes(8).hex().encode()
        self._kv("put", f"{self.name}/join/{self.rank}", nonce)
        deadline = time.monotonic() + timeout
        while True:
            nonces = []
            for r in range(self.world_size):
                v = nonce if r == self.rank else \
                    self._kv("get", f"{self.name}/join/{r}")
                if v is None:
                    break               # peer not joined yet
                nonces.append(v)
            if len(nonces) == self.world_size:
                sid = hashlib.sha256(b"|".join(nonces)).hexdigest()[:12]
                self._kv("put", f"{self.name}/ack/{self.rank}",
                         sid.encode())
                if all(self._kv("get", f"{self.name}/ack/{r}")
                       == sid.encode() for r in range(self.world_size)):
                    self.sid = sid
                    return
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"collective group {self.name}: handshake did not "
                    f"converge within {timeout}s")
            time.sleep(0.002)

    def _post(self, seq: int, payload: bytes) -> None:
        self._kv("put", self._key(seq, self.rank), payload)

    def _collect(self, seq: int, timeout: float) -> list[bytes]:
        """All ranks' round-``seq`` payloads (poll until complete).
        Ranks still missing at the deadline raise the typed
        :class:`GangMemberLost` — without the bound, one SIGKILLed peer
        parks every surviving rank here forever."""
        deadline = time.monotonic() + timeout
        out: list = [None] * self.world_size
        missing = set(range(self.world_size))
        while missing:
            # sorted: rank polling order drives per-link chaos draws,
            # so it must not depend on set memory layout
            for r in sorted(missing):
                v = self._kv("get", self._key(seq, r))
                if v is not None:
                    out[r] = v
                    missing.discard(r)
            if not missing:
                break
            if time.monotonic() > deadline:
                raise GangMemberLost(self.name, seq, missing, timeout)
            time.sleep(0.002)
        return out

    def _sweep(self) -> None:
        """Two-phase-lagged GC: by the time this rank runs round s, every
        rank has finished READING round s-2 (each round is a full
        barrier), so rank 0 deletes those keys."""
        if self.rank == 0 and self.seq >= 2:
            for r in range(self.world_size):
                self._kv("del", self._key(self.seq - 2, r))

    def _round(self, payload: bytes,
               timeout: float | None) -> list[bytes]:
        timeout = _resolve_timeout(timeout)
        self._sweep()
        seq = self.seq
        self.seq += 1
        self._post(seq, payload)
        return self._collect(seq, timeout)

    # -- ops -----------------------------------------------------------------
    def allreduce(self, array, op: str = "sum",
                  timeout: float | None = None):
        arrs = [deserialize(p) for p in
                self._round(serialize(np.asarray(array)), timeout)]
        return _REDUCERS[op](arrs)

    def allgather(self, array,
                  timeout: float | None = None) -> list:
        return [deserialize(p) for p in
                self._round(serialize(np.asarray(array)), timeout)]

    def reducescatter(self, array, op: str = "sum",
                      timeout: float | None = None):
        """Each rank returns its chunk of the elementwise reduction
        (arrays split on axis 0 into world_size chunks)."""
        full = _REDUCERS[op]([deserialize(p) for p in
                              self._round(serialize(np.asarray(array)),
                                          timeout)])
        return np.array_split(full, self.world_size)[self.rank]

    def broadcast(self, array, src_rank: int = 0,
                  timeout: float | None = None):
        payloads = self._round(
            serialize(np.asarray(array) if array is not None else None),
            timeout)
        return deserialize(payloads[src_rank])

    def barrier(self, timeout: float | None = None) -> None:
        self._round(serialize(None), timeout)

    def send(self, array, dst_rank: int,
             timeout: float | None = None) -> None:
        key = f"{self.name}/{self.sid}/p2p/{self.rank}->{dst_rank}"
        timeout = _resolve_timeout(timeout)
        deadline = time.monotonic() + timeout
        while self._kv("exists", key):          # previous message unread
            if time.monotonic() > deadline:
                raise TimeoutError(f"send to rank {dst_rank} stalled")
            time.sleep(0.002)
        self._kv("put", key, serialize(np.asarray(array)))

    def recv(self, src_rank: int, timeout: float | None = None):
        key = f"{self.name}/{self.sid}/p2p/{src_rank}->{self.rank}"
        timeout = _resolve_timeout(timeout)
        deadline = time.monotonic() + timeout
        while True:
            v = self._kv("get", key)
            if v is not None:
                self._kv("del", key)
                return deserialize(v)
            if time.monotonic() > deadline:
                raise TimeoutError(f"recv from rank {src_rank} timed out")
            time.sleep(0.002)


_groups: dict[str, _ProcessGroup] = {}


def init_collective_group(world_size: int, rank: int,
                          group_name: str = "default") -> None:
    """Join a named group from this process (driver, task, or actor).
    Blocks until all ranks joined (reference: group handshake)."""
    if not 0 <= rank < world_size:
        raise ValueError(f"rank {rank} out of range for world {world_size}")
    g = _ProcessGroup(group_name, world_size, rank)
    g._handshake()      # join barrier + per-incarnation key namespace
    _groups[group_name] = g


def _group(group_name: str) -> _ProcessGroup:
    g = _groups.get(group_name)
    if g is None:
        raise ValueError(f"collective group {group_name!r} is not "
                         "initialized in this process")
    return g


def allreduce(array, op: str = "sum", group_name: str = "default",
              timeout: float | None = None):
    return _group(group_name).allreduce(array, op, timeout=timeout)


def allgather(array, group_name: str = "default",
              timeout: float | None = None) -> list:
    return _group(group_name).allgather(array, timeout=timeout)


def reducescatter(array, op: str = "sum", group_name: str = "default",
                  timeout: float | None = None):
    return _group(group_name).reducescatter(array, op, timeout=timeout)


def broadcast(array, src_rank: int = 0, group_name: str = "default",
              timeout: float | None = None):
    return _group(group_name).broadcast(array, src_rank, timeout=timeout)


def barrier(group_name: str = "default",
            timeout: float | None = None) -> None:
    _group(group_name).barrier(timeout=timeout)


def send(array, dst_rank: int, group_name: str = "default",
         timeout: float | None = None) -> None:
    _group(group_name).send(array, dst_rank, timeout=timeout)


def recv(src_rank: int, group_name: str = "default",
         timeout: float | None = None):
    return _group(group_name).recv(src_rank, timeout=timeout)


def destroy_collective_group(group_name: str = "default") -> None:
    """Drop this process's handle on the group.  The last two rounds'
    KV keys are deliberately NOT swept here: the lagged GC only
    guarantees rounds <= seq-2 are fully read, so deleting newer keys
    would race slower ranks still polling them in ``_collect`` (they
    would time out on a collective that actually succeeded).  The
    residue is bounded — at most 2 x world_size keys per destroyed
    group — and dies with the session KV."""
    _groups.pop(group_name, None)


def get_rank(group_name: str = "default") -> int:
    return _group(group_name).rank


def get_collective_group_size(group_name: str = "default") -> int:
    return _group(group_name).world_size
