"""The port's trainers against the JAX package's, on the same inputs.

Scenario sources: ``tests/test_train.py``.  The gang scenarios (the
actor-gang trainer, its failure recovery and elastic shrink) run once
through each package's runtime (the port with ``scheduler_device="cpu"``),
one after the other, with ``collective_timeout_s`` at 5 s so that a
killed member's peer gives up in seconds in both packages alike; their
workers compute in numpy, so the port must return what the reference
returns, bit for bit.  ``MeshTrainer`` runs on 8 CPU ranks
(``devices=["cpu"] * 8``) against the reference's on the conftest's 8
CPU devices, with ``SGD``/``Adam`` against ``optax.sgd``/``optax.adam``:
the loss of every step and the final params agree within atol and rtol
``MESH_TOL``.  The carry-across test resumes a reference run's params
and Adam state in the port through ``ray_tpu_torch.convert``.
"""

from __future__ import annotations

import importlib
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from ray_tpu.common.config import Config as RefConfig
from ray_tpu_torch.common.config import Config as PortConfig

PKGS = ("ray_tpu", "ray_tpu_torch")
MESH_TOL = dict(atol=1e-5, rtol=1e-5)
KNOBS = {"collective_timeout_s": 5.0}


@pytest.fixture(autouse=True)
def _fresh_port_config():
    PortConfig.reset()
    yield
    PortConfig.reset()


# -- gang scenarios (train loops are closures: cloudpickle ships them by
# value, so a worker never imports this file) ---------------------------------

def _sgd_loop(pkg):
    def loop(config):
        rtrain = importlib.import_module(f"{pkg}.train")
        ctx = rtrain.get_context()
        rows = np.asarray(ctx.get_dataset_shard(), dtype=np.float64)
        x, y = rows[:, :-1], rows[:, -1]
        w = np.zeros(x.shape[1])
        lr = config["lr"]
        for _ in range(config["steps"]):
            grad = 2.0 * x.T @ (x @ w - y) / max(len(x), 1)
            grad = ctx.allreduce(grad, op="mean")
            w = w - lr * grad
            loss = float(np.mean((x @ w - y) ** 2))
            rtrain.report({"loss": loss, "rank": ctx.get_world_rank()})
        rtrain.report({"loss": loss, "final": True},
                      checkpoint=rtrain.Checkpoint({"w": w}))
    return loop


def gang_matches_serial(m, d):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(64, 3))
    y = x @ np.array([2.0, -3.0, 0.5])
    ds = m.data.from_numpy(np.concatenate([x, y[:, None]], axis=1),
                           parallelism=4)
    res = m.train.JaxTrainer(
        _sgd_loop(m.pkg), train_loop_config={"lr": 0.1, "steps": 40},
        scaling_config=m.train.ScalingConfig(num_workers=2),
        datasets={"train": ds}).fit()
    w_serial = np.zeros(3)
    for _ in range(40):
        w_serial -= 0.1 * 2.0 * x.T @ (x @ w_serial - y) / len(x)
    w = res.checkpoint.to_dict()["w"]
    np.testing.assert_allclose(w, w_serial, rtol=1e-8)
    return w.tobytes(), res.history, res.metrics


def context_rank_and_world(m, d):
    pkg = m.pkg

    def loop(config):
        rtrain = importlib.import_module(f"{pkg}.train")
        ctx = rtrain.get_context()
        rtrain.report({"rank": ctx.get_world_rank(),
                       "world": ctx.get_world_size()})

    return m.train.JaxTrainer(
        loop, scaling_config=m.train.ScalingConfig(num_workers=3)
    ).fit().metrics


def gang_restarts_from_persisted_checkpoint(m, d):
    """Rank 1 dies once at step 3 of 6; the gang restarts from rank 0's
    persisted checkpoint."""
    pkg = m.pkg

    def loop(config):
        import os as _os
        train = importlib.import_module(f"{pkg}.train")
        ctx = train.get_context()
        ckpt = train.get_checkpoint()
        start = ckpt.to_dict()["step"] if ckpt is not None else 0
        for step in range(start, 6):
            if step == 3 and ctx.get_world_rank() == 1 \
                    and not _os.path.exists(config["marker"]):
                open(config["marker"], "w").close()
                _os._exit(1)
            vals = ctx.allreduce({"s": np.float32(step)}, op="mean")
            train.report({"step": step, "sync": float(vals["s"]),
                          "resumed_from": start},
                         checkpoint=train.Checkpoint({"step": step + 1}))

    marker = os.path.join(d, "crashed_once")
    res = m.train.JaxTrainer(
        loop, train_loop_config={"marker": marker},
        scaling_config=m.train.ScalingConfig(num_workers=2),
        failure_config=m.train.FailureConfig(max_failures=1),
    ).fit(timeout=120)
    return os.path.exists(marker), res.metrics, res.checkpoint.to_dict()


def failures_exhausted_raises(m, d):
    def always_dies(config):
        import os as _os
        _os._exit(1)

    try:
        m.train.JaxTrainer(
            always_dies,
            scaling_config=m.train.ScalingConfig(num_workers=2),
            failure_config=m.train.FailureConfig(max_failures=1),
        ).fit(timeout=60)
    except Exception:   # noqa: BLE001 — the point: it raises
        return "raised"
    return "completed"


def gang_shrinks_to_surviving_capacity(m, d):
    """A 3-worker gang crashes while a hog holds 6 of 8 CPUs; the
    restart shrinks the world and completes from the checkpoint."""
    import time as _time
    pkg = m.pkg

    @m.rt.remote(num_returns=1, resources={"CPU": 6})
    def hog(dt):
        _time.sleep(dt)
        return "done"

    def loop(config):
        import os as _os
        train = importlib.import_module(f"{pkg}.train")
        ctx = train.get_context()
        ckpt = train.get_checkpoint()
        start = ckpt.to_dict()["step"] if ckpt is not None else 0
        for step in range(start, 4):
            if step == 2 and ctx.get_world_rank() == 0 \
                    and not _os.path.exists(config["marker"]):
                open(config["marker"], "w").close()
                _os._exit(1)
            train.report({"step": step, "world": ctx.get_world_size(),
                          "resumed_from": start},
                         checkpoint=train.Checkpoint({"step": step + 1}))

    marker = os.path.join(d, "crashed")
    hog_ref = hog.remote(3600.0)
    try:
        res = m.train.JaxTrainer(
            loop, train_loop_config={"marker": marker},
            scaling_config=m.train.ScalingConfig(num_workers=3,
                                                 min_workers=1),
            failure_config=m.train.FailureConfig(max_failures=4),
        ).fit(timeout=120)
    finally:
        m.rt.cancel(hog_ref, force=True)
    met = res.metrics
    return (os.path.exists(marker), met["step"], met["resumed_from"],
            1 <= met["world"] < 3)


def mesh_fits_a_dataset(m, d):
    """``MeshTrainer.fit`` over a ``from_numpy`` dataset (4 blocks) on 8
    ranks: SGD(0.1), 12 epochs of batches of 128."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(512, 2)).astype(np.float32)
    y = x @ np.array([1.5, -2.0], dtype=np.float32)
    ds = m.data.from_numpy(np.concatenate([x, y[:, None]], axis=1),
                           parallelism=4)
    if m.pkg == "ray_tpu":
        import jax.numpy as jnp
        import optax

        def loss_fn(params, batch):
            return jnp.mean((batch[:, :-1] @ params["w"]
                             - batch[:, -1]) ** 2)
        t = m.train.MeshTrainer(loss_fn, {"w": np.zeros(2, np.float32)},
                                optimizer=optax.sgd(0.1))
    else:
        def loss_fn(params, batch):
            return torch.mean((batch[:, :-1] @ params["w"]
                               - batch[:, -1]) ** 2)
        t = m.train.MeshTrainer(
            loss_fn, {"w": np.zeros(2, np.float32)},
            optimizer=lambda ps: torch.optim.SGD(ps, lr=0.1),
            devices=["cpu"] * 8)
    res = t.fit(ds, epochs=12, global_batch_size=128)
    return (t.n_devices, np.asarray(t.params["w"]),
            [h["loss"] for h in res.history])


def torch_leaves_allreduce(m, d):
    """The port's ``TrainContext.allreduce`` takes CPU tensor leaves and
    gives each back as a tensor of its dtype (numpy leaves stay numpy)."""
    if m.pkg == "ray_tpu":
        return None

    def loop(config):
        import torch as _torch
        train = importlib.import_module("ray_tpu_torch.train")
        ctx = train.get_context()
        r = ctx.get_world_rank()
        out = ctx.allreduce({"f": _torch.full((2, 2), float(r)),
                             "i": _torch.tensor([r + 1],
                                                dtype=_torch.int32),
                             "n": np.float32(r)}, op="sum")
        train.report({k: (type(v).__name__, str(v.dtype), v.tolist())
                      for k, v in out.items()})

    return m.train.TorchTrainer(
        loop, scaling_config=m.train.ScalingConfig(num_workers=2)
    ).fit().metrics


SCENARIOS = [gang_matches_serial, context_rank_and_world,
             gang_restarts_from_persisted_checkpoint,
             failures_exhausted_raises, gang_shrinks_to_surviving_capacity,
             mesh_fits_a_dataset, torch_leaves_allreduce]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = {}
    for name in PKGS:
        rt = importlib.import_module(name)
        m = SimpleNamespace(pkg=name, rt=rt,
                            train=importlib.import_module(f"{name}.train"),
                            data=importlib.import_module(f"{name}.data"))
        importlib.import_module(f"{name}.api")
        port = name == "ray_tpu_torch"
        rt.init(resources={"CPU": 8, "memory": 8}, num_workers=4,
                system_config={**KNOBS, "scheduler_device": "cpu"}
                if port else dict(KNOBS))
        res = out[name] = {}
        try:
            for sc in SCENARIOS:
                d = str(tmp_path_factory.mktemp(f"{name}-{sc.__name__}"))
                try:
                    res[sc.__name__] = sc(m, d)
                except Exception as e:      # noqa: BLE001 — compared
                    res[sc.__name__] = e
        finally:
            rt.shutdown()
            (PortConfig if port else RefConfig).reset()
    return out


def _both(runs, scenario):
    want = runs["ray_tpu"][scenario]
    got = runs["ray_tpu_torch"][scenario]
    for v in (want, got):
        if isinstance(v, Exception):
            raise v
    return want, got


@pytest.mark.parametrize("scenario", [
    "gang_matches_serial", "context_rank_and_world",
    "gang_restarts_from_persisted_checkpoint", "failures_exhausted_raises",
    "gang_shrinks_to_surviving_capacity"])
def test_gang_same_as_reference(runs, scenario):
    want, got = _both(runs, scenario)
    assert got == want


def test_what_the_gang_runs_show(runs):
    got = runs["ray_tpu_torch"]
    w = np.frombuffer(got["gang_matches_serial"][0])
    np.testing.assert_allclose(w, [2.0, -3.0, 0.5], atol=0.05)
    assert len(got["gang_matches_serial"][1]) == 41
    assert got["context_rank_and_world"] == {"rank": 0, "world": 3}
    crashed, metrics, ckpt = got["gang_restarts_from_persisted_checkpoint"]
    assert crashed and ckpt == {"step": 6}
    assert (metrics["step"], metrics["sync"], metrics["resumed_from"]) == \
        (5, 5.0, 3)
    assert got["failures_exhausted_raises"] == "raised"
    assert got["gang_shrinks_to_surviving_capacity"] == (True, 3, 2, True)


def test_mesh_fit_over_a_dataset_matches_reference(runs):
    (n_ref, w_ref, l_ref), (n, w, losses) = _both(runs,
                                                  "mesh_fits_a_dataset")
    assert n == n_ref == 8
    np.testing.assert_allclose(w, w_ref, **MESH_TOL)
    np.testing.assert_allclose(losses, l_ref, **MESH_TOL)
    np.testing.assert_allclose(w, [1.5, -2.0], atol=0.05)
    assert losses[-1] < losses[0]


def test_tensor_leaves_come_back_as_tensors(runs):
    got = runs["ray_tpu_torch"]["torch_leaves_allreduce"]
    if isinstance(got, Exception):
        raise got
    assert got == {"f": ("Tensor", "torch.float32", [[1.0, 1.0]] * 2),
                   "i": ("Tensor", "torch.int32", [3]),
                   "n": ("ndarray", "float32", 1.0)}


# -- MeshTrainer against the reference's, step by step ------------------------

def _linear(rng):
    return ({"w": rng.normal(size=(4,)).astype(np.float32)},
            rng.normal(size=(64, 5)).astype(np.float32),
            lambda mod, p, b: mod.mean((b[:, :-1] @ p["w"] - b[:, -1]) ** 2))


def _mlp(rng):
    params = {"w1": (0.5 * rng.normal(size=(6, 16))).astype(np.float32),
              "b1": np.zeros(16, np.float32),
              "w2": (0.5 * rng.normal(size=(16, 1))).astype(np.float32),
              "b2": np.zeros(1, np.float32)}

    def loss(mod, p, b):
        h = mod.tanh(b[:, :-1] @ p["w1"] + p["b1"])
        return mod.mean(((h @ p["w2"] + p["b2"])[:, 0] - b[:, -1]) ** 2)
    return params, rng.normal(size=(64, 7)).astype(np.float32), loss


def _reference_mesh(params, loss, opt_name):
    import jax.numpy as jnp
    import optax

    from ray_tpu.train import MeshTrainer as RefMesh
    opt = optax.sgd(1e-2) if opt_name == "sgd" else optax.adam(1e-3)
    return RefMesh(lambda p, b: loss(jnp, p, b), params, optimizer=opt)


def _port_mesh(params, loss, opt_name):
    from ray_tpu_torch.train import MeshTrainer
    make = (lambda ps: torch.optim.SGD(ps, lr=1e-2)) if opt_name == "sgd" \
        else (lambda ps: torch.optim.Adam(ps, lr=1e-3))
    return MeshTrainer(lambda p, b: loss(torch, p, b), params,
                       optimizer=make, devices=["cpu"] * 8)


@pytest.mark.parametrize("opt_name", ["sgd", "adam"])
@pytest.mark.parametrize("model", [_linear, _mlp], ids=["linear", "mlp"])
def test_mesh_steps_match_reference(model, opt_name):
    params, data, loss = model(np.random.default_rng(7))
    ref = _reference_mesh(params, loss, opt_name)
    port = _port_mesh(params, loss, opt_name)
    assert port.n_devices == ref.n_devices == 8
    for step in range(5):
        batch = data[np.random.default_rng(step).permutation(64)[:40]]
        np.testing.assert_allclose(port.step(batch), ref.step(batch),
                                   **MESH_TOL)
    for k in params:
        np.testing.assert_allclose(port.params[k].numpy(),
                                   np.asarray(ref.params[k]), **MESH_TOL)


def test_batch_not_divisible_trims_with_the_reference_message():
    params, _data, loss = _linear(np.random.default_rng(0))
    ref = _reference_mesh(params, loss, "sgd")
    port = _port_mesh(params, loss, "sgd")
    # 13 rows -> 8: the same loss and update
    batch = np.random.default_rng(1).normal(size=(13, 5)).astype(np.float32)
    np.testing.assert_allclose(port.step(batch), ref.step(batch), **MESH_TOL)
    for t in (ref, port):
        with pytest.raises(ValueError,
                           match="batch of 3 rows cannot shard over 8 "
                                 "devices"):
            t.step(batch[:3])


def test_checkpoint_restore():
    params, data, loss = _linear(np.random.default_rng(2))
    t1 = _port_mesh(params, loss, "adam")
    res = t1.fit(data, epochs=2, global_batch_size=32)
    ckpt = res.checkpoint.to_dict()
    assert all(v.device.type == "cpu" for v in ckpt["params"].values())
    t2 = _port_mesh({"w": np.zeros(4, np.float32)}, loss, "adam")
    t2.restore(res.checkpoint)
    assert torch.equal(t2.params["w"], t1.params["w"])
    # the optimizer state came along, once for each replica: the next
    # steps are the same
    for batch in (data[:32], data[32:]):
        assert t2.step(batch) == t1.step(batch)
        assert torch.equal(t2.params["w"], t1.params["w"])
    # and the checkpoint did not move with t1's later steps
    assert not torch.equal(ckpt["params"]["w"], t1.params["w"])


def test_reference_adam_run_resumes_in_the_port():
    """3 Adam steps in the reference, its params and optax state through
    ``convert``, then 3 more steps in each package: the same losses and
    params."""
    from ray_tpu_torch.convert import (adam_state_from_optax,
                                       params_from_arrays)
    from ray_tpu_torch.train import Checkpoint
    params, data, loss = _mlp(np.random.default_rng(3))
    ref = _reference_mesh(params, loss, "adam")
    batches = [data[np.random.default_rng(s).permutation(64)[:48]]
               for s in range(6)]
    for b in batches[:3]:
        ref.step(b)
    port = _port_mesh(params, loss, "adam")
    carried = {k: np.asarray(v) for k, v in ref.params.items()}
    port.restore(Checkpoint({
        "params": params_from_arrays(carried, "cpu"),
        "opt_state": adam_state_from_optax(ref._opt_state, sorted(params),
                                           lr=1e-3)}))
    assert port._opts[0].state_dict()["state"][0]["step"] == 3
    for b in batches[3:]:
        np.testing.assert_allclose(port.step(b), ref.step(b), **MESH_TOL)
    for k in params:
        np.testing.assert_allclose(port.params[k].numpy(),
                                   np.asarray(ref.params[k]), **MESH_TOL)


def test_no_devices_means_the_gpus():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: devices=None lands on it")
    from ray_tpu_torch.train import MeshTrainer
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        MeshTrainer(lambda p, b: (b @ p["w"]).sum(),
                    {"w": np.zeros(2, np.float32)})
