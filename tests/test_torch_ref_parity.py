"""Bit-for-bit parity: TPU water-fill kernel vs CPU sequential oracle.

The north-star acceptance property (BASELINE.json): batched device placement
must equal the CPU hybrid policy's sequential decisions exactly.  Arithmetic
on both sides is pure int32, so these tests assert *equality*, not closeness.
Runs on the virtual CPU backend in CI (conftest); the same int32 programs
produce identical bits on real TPU hardware (exercised by bench.py).
"""

import numpy as np
import pytest

from ray_tpu_torch.ops import schedule_grouped_np
from ray_tpu_torch.scheduling import (ClusterState, group_requests,
                                schedule_grouped_oracle, threshold_fp)
from torch_ref_fixtures import (  # noqa: F401
    _port_device_module, _port_state, device)

# Port copy of tests/test_parity.py: the reference's file with
# ``ray_tpu`` renamed to ``ray_tpu_torch``.  Deviations, none of which
# loosens a check:
# - the autouse fixtures of tests/torch_ref_fixtures.py: ``_port_state``
#   resets the port's process-global state (Config, chaos, breakers, the
#   clock and transport seams) as tests/conftest.py resets the
#   reference's, and ``_port_device_module`` sets RT_SCHEDULER_DEVICE=cpu
#   for the module before any module-scoped fixture starts a runtime:
#   the port's device programs run on the GPU unless asked for the CPU
#   (subprocesses inherit the variable);
# - the kernel calls take ``device`` (the fixture of
#   tests/torch_ref_fixtures.py): every case that reaches a kernel runs
#   once with "cpu" (the plain PyTorch version) and once with "cuda"
#   under the ``cuda`` marker, which skips without a GPU;
# - ``rng``, ``random_cluster`` and ``random_requests`` are copied from
#   tests/conftest.py onto the port's ClusterState: importing them
#   would import ``ray_tpu``.


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def random_cluster(rng, n_nodes, n_resources, max_total_units=64):
    """Random dense cluster state in cu with some zero-capacity columns."""
    totals = rng.integers(0, max_total_units * 100,
                          size=(n_nodes, n_resources)).astype(np.int32)
    # some nodes lack some resources entirely
    totals[rng.random(totals.shape) < 0.2] = 0
    used_frac = rng.random((n_nodes, n_resources))
    avail = (totals * (1 - used_frac)).astype(np.int32)
    return ClusterState(totals, avail)


def random_requests(rng, n_tasks, n_resources, n_classes=8,
                    max_req_units=8):
    """Random request batch drawn from a small set of scheduling classes."""
    classes = rng.integers(0, max_req_units * 100,
                           size=(n_classes, n_resources)).astype(np.int32)
    classes[rng.random(classes.shape) < 0.5] = 0
    picks = rng.integers(0, n_classes, size=n_tasks)
    return classes[picks]


def run_both(state, group_reqs, group_counts, thr, group_masks=None, *,
             device):
    """Oracle vs device kernel vs pure-numpy host twin — all three must
    agree bit-for-bit (the host twin is the raylet's small-round
    dispatch path, ``ops.hybrid_kernel.schedule_group_host``)."""
    from ray_tpu_torch.ops.hybrid_kernel import schedule_group_host
    st = state.copy()
    want = schedule_grouped_oracle(st, group_reqs, group_counts,
                                   spread_threshold=thr,
                                   group_masks=group_masks)
    got, new_avail = schedule_grouped_np(
        state.totals, state.avail, state.node_mask, group_reqs, group_counts,
        group_masks, spread_threshold=thr, device=device)
    np.testing.assert_array_equal(got, want, err_msg="placement counts")
    np.testing.assert_array_equal(new_avail, st.avail, err_msg="avail")
    av = np.asarray(state.avail, np.int64)
    tfp = threshold_fp(thr)
    for g in range(group_reqs.shape[0]):
        row, av = schedule_group_host(
            av, state.totals, state.node_mask, group_reqs[g],
            int(group_counts[g]),
            None if group_masks is None else group_masks[g], tfp)
        np.testing.assert_array_equal(row, want[g],
                                      err_msg=f"host twin group {g}")
    np.testing.assert_array_equal(av, st.avail, err_msg="host twin avail")
    return got


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("thr", [0.999, 1.0, 1.5, 1.9999, 2.0, 2.0002])
def test_parity_threshold_collapse_extremes(seed, thr, device):
    """Adversarial thresholds at and beyond MAX_SCORE: the width audit
    permits thr up to the first-fit regime (2*SCALE + 1), and the
    collapse branch in ``_slots_at_or_below`` (levels below thr_fp all
    equal the level-0 count) is where an off-by-one would hide —
    eff scores max out at 2*SCALE, so thr in [1.0, 2.0] exercises the
    collapse against real score values and thr > 2.0 the total-collapse
    regime (VERDICT r03 weak #7)."""
    rng = np.random.default_rng(9000 + seed)
    n_nodes = int(rng.integers(2, 40))
    n_res = int(rng.integers(1, 5))
    n_tasks = int(rng.integers(10, 500))
    state = random_cluster(rng, n_nodes, n_res)
    reqs = random_requests(rng, n_tasks, n_res,
                           n_classes=int(rng.integers(1, 9)))
    group_reqs, group_counts, _ = group_requests(reqs)
    run_both(state, group_reqs, group_counts, thr, device=device)


@pytest.mark.parametrize("thr", [1.0, 2.0])
def test_parity_collapse_near_full_nodes(thr, device):
    """Hand-built near-boundary case: nodes pinned at utilizations that
    land eff scores EXACTLY on the threshold so the < vs <= branch of
    the collapse is observable."""
    n_res = 2
    totals = np.array([[1000, 1000], [1000, 1000], [1000, 1000]],
                      np.int32)
    # used fractions 0.5, exactly thr, just above thr (for thr=1.0 the
    # last two saturate availability)
    avail = np.array([[500, 500], [0, 1000], [1, 999]], np.int32)
    state = ClusterState(totals, avail, np.ones(3, dtype=bool))
    group_reqs = np.array([[100, 0], [0, 250]], np.int32)
    group_counts = np.array([40, 13], np.int32)
    run_both(state, group_reqs, group_counts, thr, device=device)


@pytest.mark.parametrize("seed", range(20))
@pytest.mark.parametrize("thr", [0.0, 0.3, 0.5, 1.01])
def test_random_parity(seed, thr, device):
    rng = np.random.default_rng(seed)
    n_nodes = int(rng.integers(1, 50))
    n_res = int(rng.integers(1, 6))
    n_tasks = int(rng.integers(1, 400))
    state = random_cluster(rng, n_nodes, n_res)
    reqs = random_requests(rng, n_tasks, n_res,
                           n_classes=int(rng.integers(1, 9)))
    group_reqs, group_counts, _ = group_requests(reqs)
    run_both(state, group_reqs, group_counts, thr, device=device)


@pytest.mark.parametrize("seed", range(8))
def test_parity_with_group_masks(seed, device):
    rng = np.random.default_rng(100 + seed)
    state = random_cluster(rng, 23, 3)
    reqs = random_requests(rng, 150, 3, n_classes=5)
    group_reqs, group_counts, _ = group_requests(reqs)
    masks = rng.random((group_reqs.shape[0], 23)) < 0.6
    run_both(state, group_reqs, group_counts, 0.5, masks, device=device)


def test_empty_request_class(rng, device):
    state = random_cluster(rng, 9, 3)
    group_reqs = np.zeros((1, 3), dtype=np.int32)
    group_counts = np.array([17], dtype=np.int32)
    counts = run_both(state, group_reqs, group_counts, 0.5, device=device)
    assert counts[0].sum() == 17


def test_all_infeasible(rng, device):
    state = random_cluster(rng, 5, 2)
    group_reqs = np.full((1, 2), 10**6, dtype=np.int32)
    group_counts = np.array([13], dtype=np.int32)
    counts = run_both(state, group_reqs, group_counts, 0.5, device=device)
    assert counts[0, -1] == 13          # all in the infeasible column


def test_overflow_queues_on_single_node(rng, device):
    # demand exceeds total cluster capacity: overflow all lands on one node
    totals = np.full((6, 1), 400, dtype=np.int32)   # 4 units each
    state_avail = totals.copy()
    from ray_tpu_torch.scheduling import ClusterState
    state = ClusterState(totals, state_avail)
    group_reqs = np.array([[100]], dtype=np.int32)  # 1 unit
    group_counts = np.array([100], dtype=np.int32)  # 24 fit, 76 queue
    counts = run_both(state, group_reqs, group_counts, 0.5, device=device)
    placed = counts[0, :-1]
    assert placed.sum() == 100
    assert (placed >= 4).sum() == 6                 # every node filled
    assert placed.max() == 4 + 76                   # the rest queue on one


def test_padding_rows_are_noops(rng, device):
    state = random_cluster(rng, 12, 3)
    reqs = random_requests(rng, 60, 3, n_classes=3)
    group_reqs, group_counts, _ = group_requests(reqs)
    # pad with zero-count rows (the fixed-shape device batch)
    pad = 5
    gr = np.vstack([group_reqs, np.ones((pad, 3), np.int32)])
    gc = np.concatenate([group_counts, np.zeros(pad, np.int32)])
    got = run_both(state, gr, gc, 0.5, device=device)
    assert (got[-pad:] == 0).all()


def test_thousand_node_smoke(device):
    rng = np.random.default_rng(7)
    state = random_cluster(rng, 1000, 4)
    reqs = random_requests(rng, 5000, 4, n_classes=16)
    group_reqs, group_counts, _ = group_requests(reqs)
    got, _ = schedule_grouped_np(
        state.totals, state.avail, state.node_mask, group_reqs, group_counts,
        spread_threshold=0.5, device=device)
    assert got.sum() == 5000
    # cross-check a couple of groups against the oracle
    st = state.copy()
    want = schedule_grouped_oracle(st, group_reqs, group_counts,
                                   spread_threshold=0.5)
    np.testing.assert_array_equal(got, want)


@pytest.mark.slow
def test_full_scale_parity_1k_nodes_64_classes_1m_tasks(device):
    """The north-star acceptance artifact at FULL scale: the exact
    problem bench.py times (1k nodes x 64 classes x 1M tasks), device
    batch vs sequential CPU oracle, bit-for-bit — plus the same scale
    with random group masks and a spread threshold sweep."""
    import sys
    sys.path.insert(0, ".")
    from bench import build_problem

    totals, avail, node_mask, reqs, counts = build_problem()
    from ray_tpu_torch.scheduling import ClusterState
    state = ClusterState(totals, avail, node_mask)
    got = run_both(state, reqs, counts, 0.5, device=device)
    assert int(got.sum()) == 1_000_000

    # mixed group masks at scale (each class restricted to ~60% of nodes,
    # the label/PG-mask shape at full width)
    rng = np.random.default_rng(11)
    masks = rng.random((reqs.shape[0], 1000)) < 0.6
    run_both(ClusterState(totals, avail, node_mask), reqs,
             counts, 0.5, masks, device=device)

    # threshold sweep (pack-everything and spread-everything extremes)
    for thr in (0.0, 1.01):
        run_both(ClusterState(totals, avail, node_mask), reqs,
                 counts, thr, device=device)


def test_host_twin_pref_row_matches_localized_kernel(device):
    """The host twin's soft-locality path (pref_row) vs the device
    localized kernel — bit-identical (the raylet's locality-biased
    small rounds take the host twin)."""
    from ray_tpu_torch.ops.hybrid_kernel import schedule_group_host
    from ray_tpu_torch.ops.locality_kernel import schedule_grouped_localized_np
    rng = np.random.default_rng(11)
    for trial in range(12):
        n, r = 12, 3
        totals = rng.integers(0, 2000, size=(n, r)).astype(np.int32)
        avail = (totals * rng.random((n, r))).astype(np.int32)
        mask = rng.random(n) > 0.1
        req = rng.integers(0, 500, size=r).astype(np.int32)
        cnt = int(rng.integers(0, 30))
        pref = int(rng.integers(0, n))
        thr = int(rng.choice([0, 4096, 2 ** 13]))
        row, av = schedule_group_host(
            avail.astype(np.int64), totals, mask, req, cnt, None, thr,
            pref_row=pref)
        dev, dav = schedule_grouped_localized_np(
            totals, avail, mask, req[None],
            np.array([cnt], np.int32), np.array([pref], np.int32),
            thr_fp=thr, device=device)
        np.testing.assert_array_equal(row, dev[0], err_msg=str(trial))
        np.testing.assert_array_equal(av, dav, err_msg=str(trial))
