"""The port's scheduling contract vs the JAX package's, bit for bit.

``ray_tpu_torch`` carries its own copies of the contract, the oracle and
the numpy host water-fill; on the same seeded inputs they must give the
reference's answers exactly.  Also: the port imports neither JAX nor
``ray_tpu``, and its device resolution never falls back to the CPU."""

import subprocess
import sys

import numpy as np
import pytest
import torch

from ray_tpu.ops import hybrid_kernel as ref_hk
from ray_tpu.scheduling import contract as ref_contract
from ray_tpu.scheduling.oracle import ClusterState as RefState
from ray_tpu.scheduling.oracle import schedule_grouped_oracle as ref_oracle
from ray_tpu_torch.common.config import Config as PortConfig
from ray_tpu_torch.device import resolve_device
from ray_tpu_torch.ops import hybrid_kernel as port_hk
from ray_tpu_torch.scheduling import contract as port_contract
from ray_tpu_torch.scheduling.oracle import ClusterState as PortState
from ray_tpu_torch.scheduling.oracle import \
    schedule_grouped_oracle as port_oracle

SCALE = ref_contract.SCALE
# thresholds: pure packing, the default, the autoscaler's first fit
THRESHOLDS = [0, SCALE // 2, 2 * SCALE + 1]


@pytest.fixture(autouse=True)
def _fresh_port_config():
    PortConfig.reset()
    yield
    PortConfig.reset()


def _problem(seed, n=48, r=5, g=7):
    rng = np.random.default_rng(seed)
    totals = rng.integers(0, 3200, size=(n, r)).astype(np.int32)
    totals[rng.random(totals.shape) < 0.2] = 0
    avail = (totals * rng.random(totals.shape)).astype(np.int32)
    avail[rng.random(n) < 0.1] -= 150          # overcommitted rows
    mask = rng.random(n) > 0.1
    reqs = rng.integers(0, 600, size=(g, r)).astype(np.int32)
    reqs[rng.random(reqs.shape) < 0.4] = 0
    reqs[0] = 0                                 # the empty request
    counts = rng.integers(0, 120, size=g).astype(np.int32)
    return totals, avail, mask, reqs, counts


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("thr", THRESHOLDS)
def test_compute_keys_bit_exact(seed, thr):
    totals, avail, mask, reqs, _ = _problem(seed)
    for req in reqs:
        np.testing.assert_array_equal(
            port_contract.compute_keys(totals, avail, req, thr, mask),
            ref_contract.compute_keys(totals, avail, req, thr, mask))
    np.testing.assert_array_equal(
        port_contract.compute_keys_batch(totals, avail, reqs, thr, mask),
        ref_contract.compute_keys_batch(totals, avail, reqs, thr, mask))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_compute_budgets_bit_exact(seed):
    totals, avail, mask, reqs, _ = _problem(seed)
    np.testing.assert_array_equal(
        port_contract.compute_budgets(totals, avail, reqs, mask),
        ref_contract.compute_budgets(totals, avail, reqs, mask))


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("thr", THRESHOLDS)
@pytest.mark.parametrize("require_available", [False, True])
def test_schedule_grouped_oracle_bit_exact(seed, thr, require_available):
    totals, avail, mask, reqs, counts = _problem(seed)
    avail = np.maximum(avail, 0)   # the oracle loop's own domain
    spread = thr / SCALE
    got = port_oracle(PortState(totals, avail.copy(), mask), reqs, counts,
                      spread_threshold=spread,
                      require_available=require_available)
    want = ref_oracle(RefState(totals, avail.copy(), mask), reqs, counts,
                      spread_threshold=spread,
                      require_available=require_available)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("thr", THRESHOLDS)
def test_schedule_group_host_bit_exact(seed, thr):
    totals, avail, mask, reqs, counts = _problem(seed)
    rng = np.random.default_rng(seed + 100)
    gmask = rng.random(totals.shape[0]) > 0.2
    for g in range(reqs.shape[0]):
        for pref in (-1, int(rng.integers(0, totals.shape[0]))):
            got = port_hk.schedule_group_host(
                avail, totals, mask, reqs[g], counts[g], gmask, thr,
                pref_row=pref, require_available=bool(g % 2))
            want = ref_hk.schedule_group_host(
                avail, totals, mask, reqs[g], counts[g], gmask, thr,
                pref_row=pref, require_available=bool(g % 2))
            np.testing.assert_array_equal(got[0], want[0])
            np.testing.assert_array_equal(got[1], want[1])


def test_threshold_knob_matches_reference():
    assert port_contract.threshold_fp(None) == \
        ref_contract.threshold_fp(None)
    PortConfig.reset({"scheduler_spread_threshold": 0.25})
    assert port_contract.threshold_fp(None) == SCALE // 4


def test_port_imports_neither_jax_nor_ray_tpu():
    code = (
        "import importlib, pkgutil, sys\n"
        "import ray_tpu_torch\n"
        "for m in pkgutil.walk_packages(ray_tpu_torch.__path__, "
        "'ray_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules if n == 'jax' "
        "or n.startswith('jax.') or n == 'ray_tpu' "
        "or n.startswith('ray_tpu.'))\n"
        "assert not bad, bad\n"
        "print(len([n for n in sys.modules "
        "if n.startswith('ray_tpu_torch')]))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 15


def test_resolve_device_never_falls_back():
    assert resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            resolve_device()
        with pytest.raises(RuntimeError):
            resolve_device("cuda")
