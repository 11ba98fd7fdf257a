"""The port's collectives against the JAX package's, on the same inputs.

Scenario sources: ``tests/test_collective.py``.  ``DeviceCollectiveGroup``
runs on 8 CPU ranks (``devices=["cpu"] * 8``, the plain stack-and-reduce)
against the reference's group on the conftest's 8 CPU devices, for every
op, on seeded float32 and int32 inputs: exact, except the float sum and
product, whose order of accumulation differs (within ``FLOAT_TOL``).  The
process-group scenarios run through each package's runtime (the port
with ``scheduler_device="cpu"``), one after the other, and must return
the same values.
"""

from __future__ import annotations

import importlib
import pickle

import numpy as np
import pytest
import torch

from ray_tpu.common.config import Config as RefConfig
from ray_tpu.util.collective import DeviceCollectiveGroup as RefGroup
from ray_tpu_torch.common.config import Config as PortConfig
from ray_tpu_torch.util.collective import DeviceCollectiveGroup, \
    GangMemberLost

W = 8
# float32 sums and products of 8 slices in another order: a few ulps
FLOAT_TOL = dict(rtol=4e-7 * W, atol=1e-6)


@pytest.fixture(autouse=True)
def _fresh_port_config():
    PortConfig.reset()
    yield
    PortConfig.reset()


@pytest.fixture(scope="module")
def groups():
    return RefGroup(), DeviceCollectiveGroup(["cpu"] * W)


def _data(dtype, shape, seed):
    rng = np.random.default_rng(seed)
    if dtype == "int32":
        # wide enough that sums and products wrap int32
        return rng.integers(-50_000, 50_000, size=shape).astype(np.int32)
    return rng.uniform(0.5, 1.5, size=shape).astype(np.float32) * \
        rng.choice([-1.0, 1.0], size=shape).astype(np.float32)


def _same(got, want, inexact):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    if inexact and want.dtype.kind == "f":
        np.testing.assert_allclose(got, want, **FLOAT_TOL)
    else:
        np.testing.assert_array_equal(got, want)


DTYPES = ("float32", "int32")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("op", ["sum", "max", "min", "prod"])
def test_allreduce(groups, op, dtype):
    ref, port = groups
    x = _data(dtype, (W, 3, 5), seed=1)
    _same(port.allreduce(torch.from_numpy(x), op=op),
          ref.allreduce(x, op=op), inexact=op in ("sum", "prod"))


@pytest.mark.parametrize("dtype", DTYPES)
def test_allgather(groups, dtype):
    ref, port = groups
    x = _data(dtype, (W, 3), seed=2)
    out = port.allgather(torch.from_numpy(x))
    assert out.shape == (W, W, 3)
    _same(out, ref.allgather(x), inexact=False)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("op", ["sum", "max", "min"])
def test_reducescatter(groups, op, dtype):
    ref, port = groups
    x = _data(dtype, (W, W, 2), seed=3)
    out = port.reducescatter(torch.from_numpy(x), op=op)
    assert out.shape == (W, 2)
    _same(out, ref.reducescatter(x, op=op), inexact=op == "sum")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("src", range(W))
def test_broadcast_from_every_source(groups, src, dtype):
    ref, port = groups
    x = _data(dtype, (W, 2), seed=4)
    _same(port.broadcast(torch.from_numpy(x), src_rank=src),
          ref.broadcast(x, src_rank=src), inexact=False)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shift", [1, -1, 3, -3])
def test_ring_shift(groups, shift, dtype):
    ref, port = groups
    x = _data(dtype, (W, 2), seed=5)
    out = port.ring_shift(torch.from_numpy(x), shift=shift)
    _same(out, ref.ring_shift(x, shift=shift), inexact=False)
    np.testing.assert_array_equal(out.numpy(),
                                  x[(np.arange(W) - shift) % W])


def test_unsupported_ops_raise_as_the_reference_does(groups):
    ref, port = groups
    x = np.ones((W, 2), dtype=np.float32)
    x3 = np.ones((W, W, 2), dtype=np.float32)
    for grp in (ref, port):
        with pytest.raises(ValueError, match="unsupported"):
            grp.allreduce(x, op="xor")
        with pytest.raises(ValueError, match="unsupported"):
            grp.reducescatter(x3, op="prod")


def test_sequences_and_arrays_keep_their_kind(groups):
    """A list of per-rank slices comes back as a list, fresh tensors
    (never the caller's); an array comes back as one stacked tensor."""
    _ref, port = groups
    x = _data("float32", (W, 4), seed=6)
    parts = [torch.from_numpy(r.copy()) for r in x]
    out = port.ring_shift(parts, shift=0)
    assert isinstance(out, list) and len(out) == W
    for o, p in zip(out, parts):
        assert torch.equal(o, p) and o.data_ptr() != p.data_ptr()
    stacked = port.allreduce(x, op="max")
    assert isinstance(stacked, torch.Tensor) and stacked.shape == (W, 4)
    with pytest.raises(ValueError, match="slices"):
        port.allreduce(parts[:3])


def test_a_group_is_one_kind_of_device():
    with pytest.raises(ValueError, match="all CUDA devices or all CPU"):
        DeviceCollectiveGroup([])
    with pytest.raises(ValueError, match="all CUDA devices or all CPU"):
        DeviceCollectiveGroup(["cpu", "meta"])


def test_no_devices_means_the_gpus():
    """``devices=None`` is every visible CUDA device: without one the
    group raises instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: devices=None lands on it")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DeviceCollectiveGroup()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DeviceCollectiveGroup(["cuda:0"])


def test_gang_member_lost_survives_pickle():
    err = GangMemberLost("g", 7, {3, 1}, 4.0)
    back = pickle.loads(pickle.dumps(err))
    assert isinstance(back, GangMemberLost)
    assert isinstance(back, TimeoutError)
    assert (back.group, back.seq, back.missing_ranks, back.timeout_s) == \
        ("g", 7, [1, 3], 4.0)
    assert str(back) == str(err)


# -- the process group (KV rendezvous) across real workers -------------------

def allreduce_across_workers(rt):
    @rt.remote
    def member(pkg, rank, world):
        col = importlib.import_module(f"{pkg}.util.collective")
        col.init_collective_group(world, rank, "g1")
        return col.allreduce(np.full(4, rank + 1.0),
                             group_name="g1").tolist()
    return rt.get([member.remote(rt.__name__, r, 3)
                   for r in range(3)], timeout=60)


def allgather_broadcast_barrier(rt):
    @rt.remote
    def member(pkg, rank, world):
        col = importlib.import_module(f"{pkg}.util.collective")
        col.init_collective_group(world, rank, "g2")
        gathered = col.allgather(np.array([rank]), group_name="g2")
        got = col.broadcast(np.array([rank * 10]), src_rank=1,
                            group_name="g2")
        col.barrier(group_name="g2")
        return [int(a[0]) for a in gathered], int(got[0])
    return rt.get([member.remote(rt.__name__, r, 3)
                   for r in range(3)], timeout=60)


def send_recv(rt):
    @rt.remote
    def member(pkg, rank, world):
        col = importlib.import_module(f"{pkg}.util.collective")
        col.init_collective_group(world, rank, "g3")
        if rank == 0:
            col.send(np.array([42.5]), dst_rank=1, group_name="g3")
            return None
        return float(col.recv(0, group_name="g3")[0])
    return rt.get([member.remote(rt.__name__, r, 2)
                   for r in range(2)], timeout=60)


def kv_sweep_bounds_memory(rt):
    @rt.remote
    def member(pkg, rank, world, rounds):
        col = importlib.import_module(f"{pkg}.util.collective")
        col.init_collective_group(world, rank, "g4")
        for _ in range(rounds):
            col.allreduce(np.ones(2), group_name="g4")
        return True
    done = rt.get([member.remote(rt.__name__, r, 2, 12)
                   for r in range(2)], timeout=60)
    api = importlib.import_module(f"{rt.__name__}.api")
    kv = api._get_runtime().cluster.kv
    return done, len(kv.keys(b"g4/", namespace="collective")) <= 4 * 2


def same_group_name_across_generations(rt):
    @rt.remote
    def member(pkg, rank, world, val):
        col = importlib.import_module(f"{pkg}.util.collective")
        col.init_collective_group(world, rank, "g5")
        out = col.allreduce(np.full(2, float(val)), group_name="g5")
        col.destroy_collective_group("g5")
        return out.tolist()
    return [rt.get([member.remote(rt.__name__, r, 2, v)
                    for r in range(2)], timeout=60)
            for v in (1, 5)]


SCENARIOS = [allreduce_across_workers, allgather_broadcast_barrier,
             send_recv, kv_sweep_bounds_memory,
             same_group_name_across_generations]


@pytest.fixture(scope="module")
def runs():
    out = {}
    for name in ("ray_tpu", "ray_tpu_torch"):
        rt = importlib.import_module(name)
        importlib.import_module(f"{name}.api")
        port = name == "ray_tpu_torch"
        rt.init(resources={"CPU": 4, "memory": 4}, num_workers=3,
                system_config={"scheduler_device": "cpu"} if port else None)
        res = out[name] = {}
        try:
            for sc in SCENARIOS:
                try:
                    res[sc.__name__] = sc(rt)
                except Exception as e:      # noqa: BLE001 — compared
                    res[sc.__name__] = e
        finally:
            rt.shutdown()
            (PortConfig if port else RefConfig).reset()
    return out


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda s: s.__name__)
def test_process_group_same_as_reference(runs, scenario):
    want = runs["ray_tpu"][scenario.__name__]
    got = runs["ray_tpu_torch"][scenario.__name__]
    for v in (want, got):
        if isinstance(v, Exception):
            raise v
    assert got == want


def test_process_group_values(runs):
    got = runs["ray_tpu_torch"]
    assert got["allreduce_across_workers"] == [[6.0] * 4] * 3
    assert got["allgather_broadcast_barrier"] == [([0, 1, 2], 10)] * 3
    assert got["send_recv"] == [None, 42.5]
    assert got["kv_sweep_bounds_memory"] == ([True, True], True)
    # the second generation does not read the first one's stale keys
    assert got["same_group_name_across_generations"] == \
        [[[2.0, 2.0]] * 2, [[10.0, 10.0]] * 2]
