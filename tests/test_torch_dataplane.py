"""The port's bundle, pull and broadcast programs vs the JAX package's.

``ray_tpu_torch.ops.{bundle,pull,broadcast}_kernel`` in PyTorch on the
CPU against ``ray_tpu.ops``'s jitted functions on the CPU and against the
numpy oracles, on the same seeded inputs.  All three are int32 programs
under the scheduling contract: equal bit for bit."""

import numpy as np
import pytest

from ray_tpu.ops import broadcast_kernel as ref_bc
from ray_tpu.ops import bundle_kernel as ref_bk
from ray_tpu.ops import pull_kernel as ref_pk
from ray_tpu_torch.common.config import Config as PortConfig
from ray_tpu_torch.ops import broadcast_kernel as bc
from ray_tpu_torch.ops import bundle_kernel as bk
from ray_tpu_torch.ops import pull_kernel as pk


@pytest.fixture(autouse=True)
def _fresh_port_config():
    PortConfig.reset()
    yield
    PortConfig.reset()


def bundle_problem(seed, n_nodes=24, n_res=4, n_groups=12, max_bundles=5):
    """Random groups of every strategy, padded bundle slots, and a few
    groups that cannot be placed (tests/test_bundles.py's generator)."""
    rng = np.random.default_rng(seed)
    totals = rng.integers(0, 2000, size=(n_nodes, n_res)).astype(np.int32)
    totals[rng.random(totals.shape) < 0.2] = 0
    avail = (totals * rng.random(totals.shape)).astype(np.int32)
    mask = rng.random(n_nodes) > 0.1
    reqs = np.zeros((n_groups, max_bundles, n_res), dtype=np.int32)
    valid = np.zeros((n_groups, max_bundles), dtype=bool)
    strategies = rng.integers(0, 4, size=n_groups)
    for p in range(n_groups):
        nb = rng.integers(1, max_bundles + 1)
        valid[p, :nb] = True
        r = rng.integers(0, 400, size=(nb, n_res))
        r[rng.random(r.shape) < 0.4] = 0
        reqs[p, :nb] = r
    return totals, avail, mask, reqs, valid, strategies


@pytest.mark.parametrize("seed", range(8))
@pytest.mark.parametrize("thr", [None, 0.5])
def test_bundle_groups_bit_exact(seed, thr):
    prob = bundle_problem(seed)
    got = bk.schedule_bundle_groups_np(*prob, spread_threshold=thr,
                                       device="cpu")
    want = ref_bk.schedule_bundle_groups_np(*prob, spread_threshold=thr)
    oracle = bk.schedule_bundle_groups_oracle(*prob, spread_threshold=thr)
    for g, w, o in zip(got, want, oracle):
        np.testing.assert_array_equal(g, np.asarray(w))
        np.testing.assert_array_equal(g, o)
    assert got[1].any() and not got[1].all(), "want placed and failed groups"


def test_bundle_empty_groups_match_reference():
    """A group with no valid bundle: soft strategies succeed, STRICT_PACK
    needs a masked-in node, as the JAX scan decides."""
    totals, avail, _mask, reqs, valid, _ = bundle_problem(1, n_groups=4)
    valid[:] = False
    strategies = np.array([0, 1, 2, 3])
    for mask in (np.ones(24, bool), np.zeros(24, bool)):
        got = bk.schedule_bundle_groups_np(totals, avail, mask, reqs, valid,
                                           strategies, device="cpu")
        want = ref_bk.schedule_bundle_groups_np(totals, avail, mask, reqs,
                                                valid, strategies)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, np.asarray(w))


@pytest.mark.parametrize("n,r", [(4, 3), (16, 50), (64, 200), (257, 300)])
def test_choose_sources_bit_exact(n, r):
    rng = np.random.default_rng(n * 1000 + r)
    loc = rng.random((r, n)) < 0.3
    loc[0] = False                          # an object no node holds
    bw = rng.integers(0, 100_000, size=(n, n)).astype(np.int32)
    dest = rng.integers(0, n, size=r).astype(np.int32)
    sizes = rng.integers(1, 1 << 20, size=r).astype(np.int32)
    infl = rng.integers(0, 200_000, size=n).astype(np.int32)
    got = pk.choose_sources_np(loc, bw, dest, sizes, infl, device="cpu")
    want = ref_pk.choose_sources_np(loc, bw, dest, sizes, infl)
    oracle = pk.choose_sources_oracle(loc, bw, dest, sizes, infl)
    for g, w, o in zip(got, want, oracle):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, o)
    assert got[0][0] == -1 and (got[0] >= 0).any()


@pytest.mark.parametrize("seed", range(6))
def test_plan_fanout_bit_exact(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(2, 41))
    member = rng.random(n) < 0.7
    bw = rng.integers(0, 100_000, size=(n, n)).astype(np.int32)
    np.fill_diagonal(bw, 0)
    bw[rng.random((n, n)) < 0.1] = 0
    root = int(rng.integers(0, n))
    member[root] = True
    fanout = int(rng.integers(1, 5))
    infl = rng.integers(0, 200_000, size=n).astype(np.int32)
    got = bc.plan_fanout_np(member, bw, root, fanout, infl, device="cpu")
    want = ref_bc.plan_fanout_np(member, bw, root, fanout, infl)
    oracle = bc.plan_fanout_oracle(member, bw, root, fanout, infl)
    for g, w, o in zip(got, want, oracle):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, o)


def test_call_sites_take_the_device_program(monkeypatch):
    """Above their thresholds the runtime's call sites run the port's
    device programs (here on the CPU), never the numpy oracle."""
    from ray_tpu_torch.broadcast import plan as bplan
    from ray_tpu_torch.common.config import Config
    Config.reset({"broadcast_device_batch_min": 2})
    calls = []
    monkeypatch.setattr(bc, "plan_fanout_oracle",
                        lambda *a, **k: calls.append("oracle"))
    bw = np.full((6, 6), 1000, np.int32)
    np.fill_diagonal(bw, 0)
    plan = bplan.build_plan([1, 2, 3, 4, 5], bw, 0, fanout=2, device="cpu")
    assert not calls and len(plan.parent) == 5


# -- the plain versions at the edges the kernels' designs meet ---------------

def _same(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))


def _bundle_edge(case):
    """(totals, avail, mask, reqs, valid, strategies, the oracle agrees)"""
    rng = np.random.default_rng(len(case))
    n, r = 12, 3
    totals = np.full((n, r), 1000, np.int32)
    avail = rng.integers(200, 1000, size=(n, r)).astype(np.int32)
    mask = np.ones(n, bool)
    if case == "valid_not_a_prefix":
        reqs = rng.integers(0, 300, size=(6, 5, r)).astype(np.int32)
        valid = rng.random((6, 5)) < 0.6
        valid[:, 0] = False                 # a leading hole in every group
        valid[0] = [False, True, False, True, False]
        return totals, avail, mask, reqs, valid, np.arange(6) % 4, True
    if case == "rollback_after_a_placed_bundle":
        # each group places its first bundle, then fails on its second
        # (more than any node has): avail must come back whole, and the
        # last group, which fits, sees it
        reqs = np.zeros((5, 3, r), np.int32)
        reqs[:, 0] = 150
        reqs[:4, 1, 1] = 5000
        valid = np.ones((5, 3), bool)
        valid[:, 2] = False
        return totals, avail, mask, reqs, valid, [0, 1, 3, 0, 1], True
    if case == "strict_pack_past_max_total_cu":
        reqs = np.zeros((3, 4, r), np.int32)
        reqs[0, :, 0] = 50_000              # 200,000 > MAX_TOTAL_CU
        reqs[1, :2, 1] = 300                # fits
        reqs[2, :, 2] = 40_000              # 160,000 > MAX_TOTAL_CU
        valid = np.ones((3, 4), bool)
        return totals, avail, mask, reqs, valid, [2, 2, 2], True
    if case == "strict_pack_sum_wraps":
        # four bundles of 2**30 cu sum to 2**32: int32 wraps to 0, so the
        # JAX program places the group (the oracle sums in int64)
        reqs = np.zeros((2, 4, r), np.int32)
        reqs[0, :, 0] = 1 << 30
        reqs[1, :, 1] = 100
        valid = np.ones((2, 4), bool)
        return totals, avail, mask, reqs, valid, [2, 2], False
    if case == "one_group_one_bundle":
        reqs = np.full((1, 1, r), 100, np.int32)
        return totals, avail, mask, reqs, np.ones((1, 1), bool), [1], True
    raise KeyError(case)


BUNDLE_EDGES = ["valid_not_a_prefix", "rollback_after_a_placed_bundle",
                "strict_pack_past_max_total_cu", "strict_pack_sum_wraps",
                "one_group_one_bundle"]


@pytest.mark.parametrize("case", BUNDLE_EDGES)
def test_bundle_plain_edges_against_jax(case):
    """``schedule_bundle_groups_plain`` (what CPU tensors take) against
    the JAX program and the oracle where the kernel's design meets its
    edges: holes in the valid mask, the undo of a group that failed after
    placing, STRICT_PACK's clamp and wrapping sum, one group of one."""
    *prob, oracle_agrees = _bundle_edge(case)
    got = bk.schedule_bundle_groups_np(*prob, device="cpu")
    _same(got, ref_bk.schedule_bundle_groups_np(*prob))
    if oracle_agrees:
        _same(got, bk.schedule_bundle_groups_oracle(*prob))
    rows, ok, new_avail = got
    if case == "rollback_after_a_placed_bundle":
        assert not ok[:4].any() and ok[4] and (rows[:4] == -1).all()
        placed = rows[4, 0]
        want = prob[1].copy()
        want[placed] -= prob[3][4, 0]
        np.testing.assert_array_equal(new_avail, want)
    if case == "strict_pack_past_max_total_cu":
        assert ok.tolist() == [False, True, False]
    if case == "strict_pack_sum_wraps":
        assert ok.all()
    if case == "valid_not_a_prefix":
        assert ((rows >= 0) <= prob[4]).all() and ok.any()


def _pull_edge(case):
    """(loc, bw, dest, sizes_kb, inflight_kb)"""
    unit = int(pk._INFLIGHT_UNIT_KB)
    n = 9
    bw = np.full((n, n), 4000, np.int32)
    dest = np.arange(6, dtype=np.int32) % n
    if case == "equal_bandwidths":
        # every row holds every object at the same bandwidth: the lowest
        # row wins until its in-flight bytes derate it
        loc = np.ones((6, n), bool)
        return loc, bw, dest, np.full(6, unit // 4, np.int32), \
            np.zeros(n, np.int32)
    if case == "no_holder":
        loc = np.zeros((6, n), bool)
        loc[1, 3] = loc[4, 7] = True
        return loc, bw, dest, np.full(6, 100, np.int32), \
            np.zeros(n, np.int32)
    if case == "one_source_crosses_units":
        # one holder, picked every time: in flight crosses 0, 1, 2 ...
        # UNITs, so eff and the cost step down
        loc = np.zeros((12, n), bool)
        loc[:, 5] = True
        return loc, bw, np.arange(12, dtype=np.int32) % n, \
            np.full(12, 20_000, np.int32), np.zeros(n, np.int32)
    if case == "one_request":
        loc = np.zeros((1, n), bool)
        loc[0, [2, 6]] = True
        bw[6, 4] = 9000
        return loc, bw, np.array([4], np.int32), \
            np.array([12345], np.int32), np.zeros(n, np.int32)
    if case == "divisor_zero_and_negative":
        # infl // UNIT = -1 (divisor 0) on row 1, -3 (divisor -2) on row 2;
        # row 3 sits just below INT_MAX, the only holder of requests 2-3,
        # and its in-flight KB wraps below zero after request 2
        loc = np.zeros((4, n), bool)
        loc[:2, 1:4] = True
        loc[2:, 3] = True
        infl = np.zeros(n, np.int32)
        infl[1], infl[2], infl[3] = -unit, -3 * unit, 2**31 - 10
        bw[1:4] = 0
        bw[1:4, :4] = 3
        return loc, bw, np.zeros(4, np.int32), \
            np.array([100, 7, 20, 9], np.int32), infl
    raise KeyError(case)


PULL_EDGES = ["equal_bandwidths", "no_holder", "one_source_crosses_units",
              "one_request", "divisor_zero_and_negative"]


@pytest.mark.parametrize("case", PULL_EDGES)
def test_pull_plain_edges_against_jax(case):
    """``choose_sources_plain`` (what CPU tensors take) against the JAX
    program and the oracle at the kernel's edges: ties to the lowest row,
    an object no node holds, one source derated as its in-flight bytes
    cross several UNITs, one request, and a divisor ``1 + infl // UNIT``
    of 0 or below (the JAX program's eff is then 1)."""
    prob = _pull_edge(case)
    got = pk.choose_sources_np(*prob, device="cpu")
    _same(got, ref_pk.choose_sources_np(*prob))
    # numpy warns on x // 0 and on the int32 wrap the program means
    with np.errstate(divide="ignore", over="ignore"):
        _same(got, pk.choose_sources_oracle(*prob))
    src, cost = got
    if case == "equal_bandwidths":
        assert src.tolist() == [0, 0, 0, 0, 1, 1]
    if case == "no_holder":
        assert (src == -1).sum() == 4 and (cost[src == -1] == 2**31 - 1).all()
    if case == "one_source_crosses_units":
        assert (src == 5).all() and len(set(cost.tolist())) >= 3
    if case == "divisor_zero_and_negative":
        # every eff is 1 (divisors 0, -2, 65536 and, after the wrap,
        # -65535): the first max is row 1, and each cost is the size
        assert src.tolist() == [1, 1, 3, 3] and cost.tolist() == [100, 7,
                                                                  20, 9]


def _broadcast_edge(case):
    """(member, bw, root, fanout, inflight_kb)"""
    unit = int(bc._INFLIGHT_UNIT_KB)
    n = 8
    member = np.ones(n, bool)
    bw = np.full((n, n), 1000, np.int32)
    np.fill_diagonal(bw, 0)
    infl = np.zeros(n, np.int32)
    if case == "divisor_zero":
        # infl // UNIT = -1 on the root: its denominator is 0 while it
        # has no children, so every eff of the root is 1
        infl[0] = -unit
        return member, bw, 0, 4, infl
    if case == "inflight_minus_one":
        infl[[0, 3, 5]] = -1                # units -1 on three nodes
        return member, bw, 0, 2, infl
    if case == "inflight_minus_65536":
        infl[[0, 2]] = -65536               # units -2: denominators -1, 0
        return member, bw, 0, 3, infl
    if case == "inflight_max_deep":
        # units 65535 everywhere and fan-out 2 over 24 nodes: the tree
        # goes past depth 2, so both factors of the denominator grow
        rng = np.random.default_rng(11)
        n = 24
        bw = rng.integers(0, 2**31 - 1, size=(n, n)).astype(np.int32)
        np.fill_diagonal(bw, 0)
        return np.ones(n, bool), bw, 5, 2, np.full(n, 2**31 - 1, np.int32)
    if case == "fanout_zero":
        return member, bw, 0, 0, infl
    if case == "fanout_past_n":
        return member, bw, 2, n + 5, infl
    if case == "member_unreachable":
        bw[:, 6] = 0                        # nobody can send to node 6
        return member, bw, 0, 2, infl
    if case == "uniform":
        n = 40
        bw = np.full((n, n), 777, np.int32)
        np.fill_diagonal(bw, 0)
        return np.ones(n, bool), bw, 0, 3, np.zeros(n, np.int32)
    if case == "one_node":
        return np.ones(1, bool), np.zeros((1, 1), np.int32), 0, 4, \
            np.zeros(1, np.int32)
    if case == "root_not_a_member":
        member[[3, 4]] = False
        member[0] = False                   # the root relays all the same
        return member, bw, 0, 2, infl
    raise KeyError(case)


BROADCAST_EDGES = ["divisor_zero", "inflight_minus_one",
                   "inflight_minus_65536", "inflight_max_deep",
                   "fanout_zero", "fanout_past_n", "member_unreachable",
                   "uniform", "one_node", "root_not_a_member"]


@pytest.mark.parametrize("case", BROADCAST_EDGES)
def test_plan_fanout_plain_edges_against_jax(case):
    """``plan_fanout_plain`` (what CPU tensors take) against the JAX
    program and the oracle at the kernel's edges: denominators of 0 and
    below (torch raised at the first before the repair; JAX's eff is 1),
    in-flight KB at INT_MAX with depth past 2, fan-out 0 and past N, a
    member nobody reaches, uniform bandwidth, one node, a root that is
    not a member."""
    prob = _broadcast_edge(case)
    got = bc.plan_fanout_np(*prob, device="cpu")
    _same(got, ref_bc.plan_fanout_np(*prob))
    with np.errstate(divide="ignore", over="ignore"):
        _same(got, bc.plan_fanout_oracle(*prob))
    parent, order = got
    if case == "divisor_zero":
        assert parent.tolist() == [-1, 0, 0, 0, 1, 2, 3, 0]
        assert order.tolist() == [-1, 0, 1, 2, 3, 4, 5, 6]
    if case == "fanout_zero":
        assert (parent == -1).all() and (order == -1).all()
    if case == "fanout_past_n":
        assert (parent[np.arange(8) != 2] >= 0).all()
    if case == "member_unreachable":
        assert parent[6] == -1 and order[6] == -1
        assert (parent[[1, 2, 3, 4, 5, 7]] >= 0).all()
    if case == "root_not_a_member":
        assert parent[0] == -1 and (parent[[3, 4]] == -1).all()
        assert (parent[[1, 2, 5, 6, 7]] >= 0).all()
    if case == "uniform":
        assert (parent[1:] >= 0).all() and sorted(order[1:]) == \
            list(range(39))


_NO_KEY = (1 << 64) - 1


def _wrap32(x):
    return (int(x) + 2**31) % 2**32 - 2**31


def kernel_rule(member, bw, root, fanout, inflight_kb, look=256):
    """A numpy model of an eager form of ``csrc/broadcast.cu``'s rule (the
    kernel's lazy form is ``test_torch_dataplane_chain.fanout_model``):
    each row keeps the packed key of its first-max child; after
    an attach (p*, c*) only p* and c* are rescanned in full, and a row
    whose best child was c* first looks for the same eff in the ``look``
    columns from its 32-aligned start past the old child, and is
    rescanned in full only on a miss.  (The kernel skips the look and
    rescans such rows in full when they are few; a full rescan is the
    plain argmax of the row, so only the look needs a model.)"""
    member = np.asarray(member, bool)
    bw = np.asarray(bw, np.int64)
    n = len(member)
    units = (np.asarray(inflight_kb, np.int32) >> 15).astype(np.int64)
    want = member.copy()
    want[root] = False
    children = np.zeros(n, np.int64)
    depth = np.zeros(n, np.int64)
    denom = [_wrap32(1 + u) for u in units]
    best = [_NO_KEY] * n
    parent = np.full(n, -1, np.int32)
    order = np.full(n, -1, np.int32)

    def eff(b, den):
        return max(b // den, 1) if den > 0 else 1

    def key(e, p, c):
        return ((2**31 - 1 - e) << 32) | (p * n + c)

    def full_scan(p):
        cand = np.flatnonzero(want & (bw[p] > 0))
        if not len(cand):
            return _NO_KEY
        effs = [eff(int(bw[p, c]), denom[p]) for c in cand]
        e = max(effs)
        return key(e, p, int(cand[effs.index(e)]))

    full = [root] if fanout > 0 else []
    looks = []
    k = 0
    while True:
        for p in looks:
            e = 2**31 - 1 - (best[p] >> 32)
            c_old = (best[p] & 0xffffffff) - p * n
            a = (c_old + 1) & ~31
            hit = next((c for c in range(c_old + 1, min(a + look, n))
                        if want[c] and bw[p, c] > 0
                        and eff(int(bw[p, c]), denom[p]) == e), None)
            if hit is None:
                full.append(p)
            else:
                best[p] = key(e, p, hit)
        for p in full:
            best[p] = full_scan(p)
        g = min(best)
        if g == _NO_KEY:
            return parent, order
        ps, cs = divmod(g & 0xffffffff, n)
        full, looks = [], []
        for p in range(n):
            if p == ps:
                children[p] += 1
                best[p] = _NO_KEY
                if children[p] < fanout:
                    denom[p] = _wrap32(_wrap32(1 + children[p] + units[p])
                                       * (1 + depth[p]))
                    full.append(p)
            elif p == cs:
                depth[p] = depth[ps] + 1
                denom[p] = _wrap32(_wrap32(1 + units[p]) * (1 + depth[p]))
                best[p] = _NO_KEY
                full.append(p)
                parent[p], order[p] = ps, k
            elif best[p] != _NO_KEY and (best[p] & 0xffffffff) - p * n == cs:
                looks.append(p)
        want[cs] = False
        k += 1


def _rule_case(case):
    if case in BROADCAST_EDGES:
        return _broadcast_edge(case)
    kind, seed = case.split("_")
    rng = np.random.default_rng(int(seed))
    n = int(rng.integers(2, 120))
    member = rng.random(n) < 0.8
    if kind == "ties":      # few distinct values: ties and merged floors
        bw = rng.integers(0, 4, size=(n, n)).astype(np.int32) * 1000
    else:
        bw = rng.integers(0, 100_000, size=(n, n)).astype(np.int32)
    np.fill_diagonal(bw, 0)
    root = int(rng.integers(0, n))
    member[root] = True
    infl = rng.integers(-(1 << 17), 1 << 20, size=n).astype(np.int32)
    return member, bw, root, int(rng.integers(1, 6)), infl


@pytest.mark.parametrize("case", BROADCAST_EDGES
                         + [f"random_{s}" for s in range(6)]
                         + [f"ties_{s}" for s in range(6)])
@pytest.mark.parametrize("look", [32, 256])
def test_kernel_rule_equals_the_full_argmax(case, look):
    """The kernel's incremental rule (a best child per row, rescans of
    the rows an attach changed, the short look past a taken best) gives
    the oracle's tree: random bandwidth, few distinct values (ties, and
    floors that merge), negative in-flight KB, and the edges above."""
    prob = _rule_case(case)
    with np.errstate(divide="ignore", over="ignore"):
        want = bc.plan_fanout_oracle(*prob)
    _same(kernel_rule(*prob, look=look), want)


# -- the kernels' builds and launch counters off the card ---------------------

def test_lib_path_follows_the_included_headers(tmp_path, monkeypatch):
    """A library's name hashes its source AND the headers it includes, so
    an edited header never loads a stale build: every scheduling kernel
    includes ``contract.cuh``, and flash attention, which does not,
    keeps its name."""
    import shutil

    from ray_tpu_torch.ops import _build
    csrc = tmp_path / "csrc"
    shutil.copytree(_build._CSRC, csrc)
    monkeypatch.setattr(_build, "_CSRC", csrc)
    includers = ("topk", "bundle", "pull", "waterfill", "binpack",
                 "broadcast")
    names = includers + ("flash_attention",)
    before = {n: _build.lib_path(n) for n in names}
    with open(csrc / "contract.cuh", "a") as f:
        f.write("\n// edited\n")
    after = {n: _build.lib_path(n) for n in names}
    for n in includers:
        assert after[n] != before[n], n
    assert after["flash_attention"] == before["flash_attention"]
    with open(csrc / "pull.cu", "a") as f:
        f.write("\n// edited\n")
    assert _build.lib_path("pull") != after["pull"]
    assert _build.lib_path("topk") == after["topk"]


def test_cpu_tensors_never_load_a_kernel(monkeypatch):
    """CPU tensors take the plain versions: no build, no load, and the
    launch counters stay where they were."""
    import torch

    from ray_tpu_torch.ops import _build
    from ray_tpu_torch.ops import locality_kernel as lk

    def refuse(*_a, **_k):
        raise AssertionError("a CPU call reached the kernel build")

    monkeypatch.setattr(_build, "load", refuse)
    monkeypatch.setattr(_build, "build", refuse)
    counters = (lk.schedule_grouped_topk, bk.schedule_bundle_groups,
                pk.choose_sources, bc.plan_fanout)
    before = [f.launches for f in counters]
    bc.plan_fanout_np(*_broadcast_edge("uniform"), device="cpu")
    prob = bundle_problem(0)
    bk.schedule_bundle_groups_np(*prob, device="cpu")
    t = [torch.as_tensor(a) for a in prob[:4]]
    bk.schedule_bundle_groups(*t, prob[4], prob[5], 0)
    loc, bw, dest, sizes, infl = _pull_edge("one_request")
    pk.choose_sources_np(loc, bw, dest, sizes, infl, device="cpu")
    rng = np.random.default_rng(0)
    totals = rng.integers(100, 1000, size=(20, 3)).astype(np.int32)
    reqs = rng.integers(0, 50, size=(4, 3)).astype(np.int32)
    counts = np.full(4, 7, np.int32)
    lk.schedule_grouped_topk_np(totals, totals, np.ones(20, bool), reqs,
                                counts, 1, 1, k_frac=0.5, device="cpu")
    assert [f.launches for f in counters] == before
