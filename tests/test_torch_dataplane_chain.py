"""The pull-source, gang-placement and broadcast kernels' chains,
modelled in numpy and held to the JAX functions, bit for bit.

``ray_tpu_torch/ops/csrc/pull.cu`` compacts each request's candidates
(holders with a live link, in column order, at most a cap of them) off
the chain, then one warp takes a request's list 32 candidates at a time
(each lane its first maximum, then the warp's largest eff and the least
column holding it); a request past the cap is reduced by 30 helper warps
over every column (packed keys ``(INT_MAX - eff) << 32 | n``).
``pull_model`` repeats that in numpy.

``ray_tpu_torch/ops/csrc/bundle.cu`` compacts every bundle's request
(positive columns first, then negative ones) and every STRICT_PACK
group's clamped wrapping sum off the chain, divides by each (row,
column) divisor's magic multiplier, and cuts the rows into CTA slices
(thread i mod 1024 of a slice owns row i) whose partial first-minimums
are joined; a failed group is undone from its log.  ``bundle_model``
repeats that in numpy, and ``plan`` repeats the kernel's layout rule.

``ray_tpu_torch/ops/csrc/broadcast.cu`` keeps each parent row's best key
and, after an attach, rescans only the two rows it changed; a row whose
best child was taken keeps its key as a lower bound and is refreshed
(a look past the old child, or a full rescan after a miss) only when its
warp's least key is stale.  ``fanout_model`` repeats that in numpy, and
``fanout_plan`` the kernel's cluster rule.

The models run on seeded inputs against the JAX package's
``choose_sources_np`` / ``schedule_bundle_groups_np`` /
``plan_fanout_np`` (on the CPU, as its own tests run them) and against
the port's plain versions."""

import numpy as np
import pytest

from ray_tpu.ops import bundle_kernel as ref_bk
from ray_tpu.ops import pull_kernel as ref_pk
from ray_tpu_torch.common.config import Config as PortConfig
from ray_tpu_torch.ops import bundle_kernel as bk
from ray_tpu_torch.ops import pull_kernel as pk

INT_MAX = 2**31 - 1
INF = INT_MAX
SCALE = 1 << 12
MAX_TOTAL_CU = 1 << 17
THREADS, WARPS = 1024, 32
HELPERS = 30                        # pull.cu: warps 2..31 of CTA 0
UNIT_SHIFT = 15
LIST_CAP = 128                      # pull.cu kListCap
ROWS_PER_CTA = 128                  # bundle.cu kRowsPerCta


@pytest.fixture(autouse=True)
def _fresh_port_config():
    PortConfig.reset()
    yield
    PortConfig.reset()


def wrap(x):
    """int32 wrap of int64 values (the kernels' wadd/wsub/wmul)."""
    return (np.asarray(x, np.int64) + 2**31) % 2**32 - 2**31


def _same(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


# -- pull-source selection ---------------------------------------------------

def pull_compact(loc, bw, dest, cap):
    """The prologue: each request's (n, raw) pairs with raw > 0, in column
    order, at most ``cap``; its count, cap + 1 past it."""
    n = bw.shape[0]
    lists, counts = [], []
    for i in range(loc.shape[0]):
        d = int(dest[i])
        d = d + n if d < 0 else d
        d = min(max(d, 0), n - 1)
        cols = np.flatnonzero(loc[i] & (bw[:, d] > 0))
        lists.append([(int(c), int(bw[c, d])) for c in cols[:cap]])
        counts.append(min(len(cols), cap + 1))
    return lists, counts


def eff_of(raw, infl):
    div = 1 + (int(infl) >> UNIT_SHIFT)
    return max(raw // div, 1) if div > 0 else 1


def pull_model(loc, bw, dest, sizes, inflight, cap=LIST_CAP):
    """pull.cu's chain: (src, cost)."""
    loc = np.asarray(loc, bool)
    bw = np.asarray(bw, np.int64)
    n = bw.shape[0]
    infl = np.asarray(inflight, np.int64).copy()
    lists, counts = pull_compact(loc, bw, dest, cap)
    src, cost = [], []
    for i, (lst, cnt) in enumerate(zip(lists, counts)):
        if cnt <= cap:
            # lane l takes candidates l, l + 32, ...: its first maximum
            lane_best = [(0, 2**32 - 1)] * 32
            for j, (c, raw) in enumerate(lst):
                e = eff_of(raw, infl[c])
                if e > lane_best[j % 32][0]:
                    lane_best[j % 32] = (e, c)
            best = max(b for b, _ in lane_best)
            at = min(c for b, c in lane_best if b == best)
        else:
            # helpers: thread g takes columns g, g + 960, ...; a warp's
            # least packed key, then the chain's over the 30 partials
            d = int(dest[i])
            d = min(max(d + n if d < 0 else d, 0), n - 1)
            part = []
            for w in range(HELPERS):
                v = 2**64 - 1
                for g in range(w * 32, w * 32 + 32):
                    for c in range(g, n, HELPERS * 32):
                        raw = int(bw[c, d])
                        if loc[i, c] and raw > 0:
                            v = min(v, ((INT_MAX - eff_of(raw, infl[c]))
                                        << 32) | c)
                part.append(v)
            v = min(part)
            best = 0 if v == 2**64 - 1 else INT_MAX - (v >> 32)
            at = v & 0xffffffff
        if best > 0:
            infl[at] = wrap(infl[at] + int(sizes[i]))
        src.append(at if best > 0 else -1)
        cost.append(int(sizes[i]) // best if best > 0 else INT_MAX)
    return np.asarray(src, np.int32), np.asarray(cost, np.int32)


def _pull_case(case):
    """(loc, bw, dest, sizes, inflight, cap)"""
    rng = np.random.default_rng(len(case))
    n, r = 150, 40
    bw = rng.integers(1, 50_000, size=(n, n)).astype(np.int32)
    dest = rng.integers(0, n, size=r).astype(np.int32)
    sizes = rng.integers(1, 1 << 20, size=r).astype(np.int32)
    infl = rng.integers(0, 1 << 20, size=n).astype(np.int32)
    loc = np.zeros((r, n), bool)
    if case == "counts_0_1_32_33_n":
        # requests with exactly 0, 1, 32, 33 and N candidates, and past
        # the cap (64 here): 64 fits, 65 is reduced by the helpers
        for i in range(r):
            k = (0, 1, 32, 33, n, 64, 65)[i % 7]
            loc[i, rng.permutation(n)[:k]] = True
        return loc, bw, dest, sizes, infl, 64
    if case == "equal_bandwidths":
        # every link at one rate and nothing in flight: ties across the
        # 32-candidate rounds and lanes go to the lowest column until the
        # picks derate it
        bw[:] = 4000
        infl[:] = 0
        loc = rng.random((r, n)) < 0.5
        return loc, bw, dest, np.full(r, 1 << 14, np.int32), infl, 128
    if case == "inflight_wraps":
        # a few holders close to INT_MAX: each pick wraps its in-flight KB
        # below zero, so its divisor 1 + infl // UNIT turns 0 or negative
        loc[:, :3] = True
        infl[:3] = INT_MAX - rng.integers(0, 1 << 20, size=3)
        bw[:3] = 7
        return loc, bw, dest, sizes, infl, 128
    if case == "divisors_zero_and_below":
        unit = 1 << UNIT_SHIFT
        loc = rng.random((r, n)) < 0.3
        infl[:] = rng.choice([-unit, -3 * unit, -2**31, 0, 5 * unit], n)
        return loc, bw, dest, sizes, infl, 128
    if case == "long_lists_split":
        # dense holders at a small cap: most requests go to the helpers,
        # some stay on the one warp, in turn
        loc = rng.random((r, n)) < 0.9
        loc[::4] = rng.random((len(loc[::4]), n)) < 0.05
        bw[rng.random((n, n)) < 0.1] = 0
        return loc, bw, dest, sizes, infl, 8
    if case == "negative_dest_and_sizes":
        loc = rng.random((r, n)) < 0.1
        dest[::3] = -rng.integers(1, n, size=len(dest[::3]))
        sizes[::2] = -sizes[::2]
        return loc, bw, dest, sizes, infl, 128
    raise KeyError(case)


PULL_CASES = ["counts_0_1_32_33_n", "equal_bandwidths", "inflight_wraps",
              "divisors_zero_and_below", "long_lists_split",
              "negative_dest_and_sizes"]


@pytest.mark.parametrize("case", PULL_CASES)
def test_pull_model_equals_jax(case):
    """The chain of pull.cu == the JAX function == the port's plain
    version == the numpy oracle, bit for bit."""
    *prob, cap = _pull_case(case)
    got = pull_model(*prob, cap=cap)
    _same(got, ref_pk.choose_sources_np(*prob))
    _same(got, pk.choose_sources_np(*prob, device="cpu"))
    with np.errstate(divide="ignore", over="ignore"):
        _same(got, pk.choose_sources_oracle(*prob))
    _lists, counts = pull_compact(prob[0], prob[1], prob[2], cap)
    if case == "counts_0_1_32_33_n":
        assert {0, 1, 32, 33, 64, 65}.issubset(counts)   # 65: cap + 1
    if case == "long_lists_split":
        assert cap + 1 in counts and min(counts) <= cap
    if case == "equal_bandwidths":
        assert max(counts) > 64                        # several rounds


@pytest.mark.parametrize("cap", [2, 32, 128, 150])
def test_pull_model_any_cap_is_the_same_function(cap):
    """The list cap only moves requests between the one warp and the
    helpers: the result never depends on it."""
    rng = np.random.default_rng(cap)
    n, r = 150, 30
    loc = rng.random((r, n)) < rng.choice([0.02, 0.5, 1.0], size=(r, 1))
    bw = rng.integers(0, 9, size=(n, n)).astype(np.int32) * 1000
    dest = rng.integers(0, n, size=r).astype(np.int32)
    sizes = rng.integers(1, 1 << 20, size=r).astype(np.int32)
    infl = rng.integers(0, 1 << 17, size=n).astype(np.int32)
    _same(pull_model(loc, bw, dest, sizes, infl, cap=cap),
          ref_pk.choose_sources_np(loc, bw, dest, sizes, infl))


# -- gang placement ----------------------------------------------------------

def magic(d):
    """contract.cuh magic(d) for d >= 1: (m, s)."""
    s = 31 + (d - 1).bit_length()
    return ((1 << s) + d - 1) // d, s


def fdiv(a, m, s):
    """contract.cuh fdiv: floor(a / d) for int32 a by d's magic (m, s)."""
    a = np.asarray(a, np.int64)
    x = np.where(a < 0, ~a, a)                      # < 2**31
    q = (x * np.asarray(m, np.int64)) >> np.asarray(s, np.int64)
    return np.where(a < 0, ~q, q)


EDGE_DIVISORS = [1, 2, 3, 7, 4095, 4096, 4097, 1 << 17, (1 << 17) + 1,
                 2**30, 2**31 - 1]
EDGE_DIVIDENDS = [-2**31, -2**31 + 1, -4097, -4096, -1, 0, 1, 4095, 4096,
                  2**30, 2**31 - 2, 2**31 - 1]


def test_magic_reciprocals_are_floor_division():
    """fdiv by magic(max(t, 1)) == numpy's // over the contract's range
    (t in 0..MAX_TOTAL_CU, any int32 dividend: (t - a + q) * SCALE wraps)
    and at the edges of both."""
    rng = np.random.default_rng(0)
    divs = np.concatenate([EDGE_DIVISORS,
                           rng.integers(1, MAX_TOTAL_CU + 1, 2000),
                           rng.integers(1, 2**31, 200)])
    nums = np.concatenate([EDGE_DIVIDENDS,
                           rng.integers(-2**31, 2**31, 500)])
    for d in divs:
        m, s = magic(int(d))
        assert m < 2**32
        np.testing.assert_array_equal(fdiv(nums, m, s),
                                      nums.astype(np.int64) // int(d))


def compact_slot(q):
    """A bundle's entries: positive columns, then negative ones."""
    pos = [(c, int(v)) for c, v in enumerate(q) if v > 0]
    neg = [(c, int(v)) for c, v in enumerate(q) if v < 0]
    return len(pos), pos + neg


def strict_total(reqs, valid):
    """A STRICT_PACK group's total: the wrapping int32 sum of its valid
    bundles, clamped to MAX_TOTAL_CU + 1."""
    s = wrap(np.where(valid[:, None], reqs, 0).astype(np.int64).sum(0))
    return np.minimum(s, MAX_TOTAL_CU + 1)


def keys_rcp(t, a, m, live, npos, ent, thr, rows):
    """contract_key_rcp over rows (t, a, m: (rows, R)), then _avail_keys."""
    feas = live.copy()
    availb = np.ones(len(rows), bool)
    s = np.zeros(len(rows), np.int64)
    for c, q in ent[:npos]:
        tc, ac = t[:, c].astype(np.int64), a[:, c].astype(np.int64)
        feas &= tc >= q
        availb &= ac >= q
        num = wrap(wrap(wrap(tc - ac) + q) * SCALE)
        sh = 31 + np.frexp((np.maximum(tc, 1) - 1).astype(float))[1]
        s = np.maximum(s, fdiv(num, m[:, c], sh))
    eff = np.where(availb & (s < thr), 0, s)
    u = ((~availb).astype(np.int64) << 27) | ((eff << 13) & 0xffffffff) | rows
    key = np.where(feas, wrap(u), INF)
    return np.where((key >> 27) & 1, INF, key)


def _group_min(keys, rows, groups):
    """Each group's first minimum: the least key, then the least row."""
    order = np.lexsort((rows, keys, groups))
    g = groups[order]
    first = np.r_[True, g[1:] != g[:-1]]
    return keys[order][first], rows[order][first], g[first]


def slice_min(keys, rows, cluster, nloc):
    """(key, row): the kernel's join of the (key, row) pairs of rows in
    CTA slices of nloc: each thread's first minimum over the rows it owns
    (row i of a slice: thread i mod 1024), each warp's, then the least of
    every CTA's warps' partials; (INF, None) where every key is INF."""
    live = keys != INF
    if not live.any():
        return INF, None
    keys, rows = keys[live], rows[live]
    cta = rows // nloc
    thread = cta * THREADS + (rows - cta * nloc) % THREADS
    k, r, g = _group_min(keys, rows, thread)
    k, r, g = _group_min(k, r, g // 32)              # warps
    k, r, _ = _group_min(k, r, np.zeros_like(g))     # the CTAs' partials
    return int(k[0]), int(r[0])


def plan(n, r, p, b, per_cta=ROWS_PER_CTA):
    """bundle.cu plan() in a build with kRowsPerCta = per_cta: (layout,
    CTAs, threads a CTA)."""
    limit = 232448

    def up16(x):
        return (x + 15) & ~15

    group = (2 + (b + 1) * (2 + 2 * r) + 3) & ~3
    stage = 2 * group * 4 <= 32 * 1024

    def place(c, on_chip):
        nloc = -(-n // c)
        threads = min(THREADS, max(32, (nloc + 31) & ~31))
        at = up16(2 * c * (threads // 32) * 16) + 32
        at += (up16(2 * group * 4) if stage else 0)
        at += up16(4 * (b + 1)) + up16(4 * nloc)
        return threads, at + on_chip * 3 * up16(4 * nloc * r) <= limit

    want = min(16, max(1, -(-n // per_cta)))
    for on_chip, layout in ((True, "cluster"), (False, "global")):
        for c in range(1, 17):
            if not place(c, on_chip)[1]:
                continue
            if c < want and place(want, on_chip)[1]:
                c = want
            if on_chip and c == 1:
                layout = "shared"
            return layout, c, place(c, on_chip)[0]
    return None, None, None


def bundle_model(totals, avail, mask, reqs, valid, strategies, thr,
                 cluster=None):
    """bundle.cu's chain: (rows, ok, new_avail)."""
    n, r = totals.shape
    p_n, b_n = valid.shape
    c_n = cluster or plan(n, r, p_n, b_n)[1]
    nloc = -(-n // c_n)
    t = totals.astype(np.int64)
    a = avail.astype(np.int64).copy()
    m = np.array([[magic(max(int(x), 1))[0] for x in row] for row in t])
    meta = np.where(mask, -1, -2**31)
    allrows = np.arange(n)
    out_rows = np.full((p_n, b_n), -1, np.int32)
    out_ok = np.zeros(p_n, bool)
    for p in range(p_n):
        strat = int(strategies[p])
        strict = strat == 2
        slots = [compact_slot(reqs[p, j]) if valid[p, j] else None
                 for j in range(b_n)]
        placed = [-1] * b_n
        ok, node = True, 0
        steps = [(b_n, compact_slot(strict_total(reqs[p], valid[p])))] \
            if strict else [(j, s) for j, s in enumerate(slots)
                            if s is not None]
        for j, (npos, ent) in steps:
            live = meta != -2**31
            keys = keys_rcp(t, a, m, live, npos, ent, thr, allrows)
            lv = allrows[live]
            k1, r1 = slice_min(keys[live], lv, c_n, nloc)
            if strict:
                found, node = k1 != INF, r1
            else:
                prim = live & ((meta == p) == (strat == 0))
                k0, r0 = slice_min(keys[prim], allrows[prim], c_n, nloc)
                found = k0 != INF or (strat != 3 and k1 != INF)
                node = r0 if k0 != INF else r1
            if not found:
                ok = False
                break
            for c, q in ent:
                a[node, c] = wrap(a[node, c] - q)
            meta[node] = p
            if not strict:
                placed[j] = node
        if not ok and not strict:
            for j in range(b_n):
                if placed[j] >= 0:
                    for c, q in slots[j][1]:
                        a[placed[j], c] = wrap(a[placed[j], c] + q)
        for j in range(b_n):
            out_rows[p, j] = -1 if not ok else \
                (node if valid[p, j] else -1) if strict else placed[j]
        out_ok[p] = ok
    return out_rows, out_ok, a.astype(np.int32)


def _bundle_case(case):
    """(totals, avail, mask, reqs, valid, strategies, cluster)"""
    rng = np.random.default_rng(len(case))
    n, r, p, b = 40, 4, 12, 5
    totals = rng.integers(0, 2000, size=(n, r)).astype(np.int32)
    totals[rng.random(totals.shape) < 0.2] = 0
    avail = (totals * rng.random(totals.shape)).astype(np.int32)
    mask = rng.random(n) > 0.1
    reqs = rng.integers(0, 400, size=(p, b, r)).astype(np.int32)
    reqs[rng.random(reqs.shape) < 0.4] = 0
    valid = rng.random((p, b)) < 0.8
    strat = np.arange(p) % 4
    if case == "every_strategy":
        return totals, avail, mask, reqs, valid, strat, 3
    if case == "failed_group_after_placed":
        # each group places a bundle or two, then asks for more than any
        # row has: avail comes back whole, the group after it fits
        reqs[:, 2] = 0
        reqs[:-1, 2, 1] = 50_000
        reqs[-1] = 0
        reqs[-1, :, 0] = 1
        valid[:] = True
        strat = np.array([0, 1, 3] * 4)
        return totals, avail, mask, reqs, valid, strat, 2
    if case == "tie_on_a_slice_boundary":
        # every row equal but the two around the slices' boundary (rows 19
        # and 20 of 40 in 2 CTAs), which alone can take a bundle and tie
        totals[:] = 1000
        avail[:] = 0
        avail[[19, 20]] = 1000
        mask[:] = True
        reqs[:] = 100
        valid[:] = True
        return totals, avail, mask, reqs, valid, strat, 2
    if case == "homogeneous_gangs":
        reqs[:] = reqs[:, :1]            # one request a group, B times
        valid[:] = True
        return totals, avail, mask, reqs, valid, strat, 4
    if case == "strict_pack_past_max_total_cu":
        totals[:] = 100_000
        avail[:] = 100_000
        reqs[:] = 0
        reqs[:, :, 0] = 40_000           # 5 x 40,000 > MAX_TOTAL_CU
        reqs[1::2, :, 0] = 10
        valid[:] = True
        strat[:] = 2
        return totals, avail, mask, reqs, valid, strat, 2
    if case == "negative_requests":
        reqs[::2, :, 3] = -rng.integers(1, 300, size=(len(reqs[::2]), b))
        return totals, avail, mask, reqs, valid, strat, 3
    raise KeyError(case)


BUNDLE_CASES = ["every_strategy", "failed_group_after_placed",
                "tie_on_a_slice_boundary", "homogeneous_gangs",
                "strict_pack_past_max_total_cu", "negative_requests"]


@pytest.mark.parametrize("case", BUNDLE_CASES)
def test_bundle_model_equals_jax(case):
    """The chain of bundle.cu == the JAX function == the port's plain
    version (and the oracle, where it sums as JAX does), bit for bit."""
    *prob, cluster = _bundle_case(case)
    thr = SCALE // 2
    got = bundle_model(*prob, thr, cluster=cluster)
    _same(got, ref_bk.schedule_bundle_groups_np(*prob, thr_fp=thr))
    _same(got, bk.schedule_bundle_groups_np(*prob, thr_fp=thr, device="cpu"))
    _same(got, bk.schedule_bundle_groups_oracle(*prob, spread_threshold=0.5))
    rows, ok, _ = got
    if case == "tie_on_a_slice_boundary":
        # the first bundle of every group ties on rows 19 and 20, one in
        # each slice: the lower row wins
        assert rows[0, 0] == 19 and (rows[ok] >= 0).all()
        assert set(np.unique(rows[rows >= 0])) <= {19, 20}
    if case == "failed_group_after_placed":
        assert not ok[:-1].any() and ok[-1]
    if case == "strict_pack_past_max_total_cu":
        assert not ok[0::2].any() and ok[1::2].any()


@pytest.mark.parametrize("cluster", [1, 2, 5, 16])
def test_bundle_model_any_cluster_is_the_same_function(cluster):
    """The slices only split the rows: the result never depends on how
    many CTAs hold them."""
    from test_torch_dataplane import bundle_problem
    prob = bundle_problem(cluster, n_nodes=37)
    thr = SCALE // 2
    _same(bundle_model(*prob, thr, cluster=cluster),
          ref_bk.schedule_bundle_groups_np(*prob, thr_fp=thr))


# (n, r, p, b, per_cta, layout, cluster, threads): bundle.cu's layout
# rule at the card tests' shapes, in the source's build (kRowsPerCta =
# 128) and in builds with other rows a CTA (tests/test_torch_cuda.py
# holds every row to the library)
LAYOUT_RULE = [
    (16, 8, 4, 3, 128, "shared", 1, 32),
    (100, 8, 16, 8, 128, "shared", 1, 128),
    (200, 8, 2, 8, 128, "cluster", 2, 128),
    (1000, 8, 64, 8, 128, "cluster", 8, 128),
    (8192, 8, 64, 8, 128, "cluster", 16, 512),
    (8192, 64, 16, 4, 128, "global", 16, 512),
    (8192, 128, 8, 4, 128, "global", 16, 512),
    (200_000, 8, 2, 8, 128, "global", 16, 1024),
    # the fewest CTAs that hold each layout
    (1000, 8, 64, 8, 1024, "shared", 1, 1000 + 24),
    (8192, 8, 64, 8, 8192, "cluster", 4, 1024),
    (8192, 64, 16, 4, 8192, "global", 1, 1024),
    (8192, 128, 8, 4, 8192, "global", 1, 1024)]


@pytest.mark.parametrize("n,r,p,b,per_cta,layout,cluster,threads",
                         LAYOUT_RULE)
def test_bundle_layout_rule(n, r, p, b, per_cta, layout, cluster, threads):
    """plan() as the kernel states it: the rows' arrays on chip, else in
    global memory, each in the fewest CTAs that hold them or in more
    where that leaves a CTA more than per_cta rows (up to 16); a thread a
    row up to 1024."""
    assert plan(n, r, p, b, per_cta) == (layout, cluster, threads)


# -- the broadcast fan-out plan ------------------------------------------------

NO_KEY = (1 << 64) - 1
MARK = 1                            # broadcast.cu: a key under replacement
FANOUT_WARPS = 16                   # broadcast.cu: 512 threads a CTA
LOOK = 256                          # broadcast.cu: 8 x 32 columns
MAX_LOOKS = 4                       # looks a warp a round
FANOUT_ROWS_PER_CTA = 1024          # broadcast.cu kRowsPerCta


def pair_key(eff, p, c):
    return ((INT_MAX - eff) << 32) | (((p << 13) | c) << 1)


def fanout_plan(n, per_cta=FANOUT_ROWS_PER_CTA):
    """broadcast.cu's plan(): (layout, CTAs), per_cta rows a CTA up to
    16 CTAs, and more where a CTA's 24 B a row would pass its shared
    memory."""
    c = min(max(-(-n // per_cta), 1), 16)
    while c < 16:
        nloc = -(-n // c)
        part = 2 * c * FANOUT_WARPS * 16
        up16 = lambda x: (x + 15) & ~15                       # noqa: E731
        smem = up16(part) + up16(8 * nloc) + 4 * up16(4 * nloc)
        if smem <= 232448 - 8192:
            break
        c += 1
    return ("cta" if c == 1 else "cluster"), c


def fanout_model(member, bw, root, fanout, inflight_kb, cluster=1,
                 stats=None):
    """A numpy model of broadcast.cu's rounds: rows cut into ``cluster``
    CTA slices, each slice's rows in runs over 16 warps; each warp caches
    its least key (rows under replacement left out) and refreshes it
    while its child is taken, by a look past the old child or, on a
    miss, a full rescan in the next round with the stale key standing in
    meanwhile (at most MAX_LOOKS looks a warp a round); a round's least
    offer is the step's pair when its child is still wanted; the round's
    rescans fold into the rows' keys after the join.  Returns (parent,
    order); ``stats`` counts rounds, looks, misses and stand-in
    rounds."""
    member = np.asarray(member, bool)
    bw = np.asarray(bw, np.int64)
    n = len(member)
    fanout = min(max(int(fanout), 0), n)
    u1 = [1 + (int(x) >> UNIT_SHIFT) for x in np.asarray(inflight_kb,
                                                         np.int32)]
    want = member.copy()
    want[root] = False
    children, depth = [0] * n, [0] * n
    den = [int(wrap(u1[p])) for p in range(n)]
    best = [NO_KEY] * n
    parent = np.full(n, -1, np.int32)
    order = np.full(n, -1, np.int32)
    nloc = -(-n // cluster)
    slices = [range(r * nloc, min(n, (r + 1) * nloc))
              for r in range(cluster)]
    runs = []                          # (slice, warp) -> its rows
    for rows in slices:
        rpw = max(1, -(-len(rows) // FANOUT_WARPS))
        for w in range(FANOUT_WARPS):
            lo = min(len(rows), w * rpw)
            runs.append(list(rows[lo:min(len(rows), lo + rpw)]))
    owner = {p: i for i, run in enumerate(runs) for p in run}
    wmin = [NO_KEY] * len(runs)
    dirty = [True] * len(runs)
    lists = [[root] if fanout > 0 else [], []]
    st = stats if stats is not None else {}
    for k in ("rounds", "looks", "misses", "stand_in_rounds"):
        st.setdefault(k, 0)

    def eff(b, d):
        return max(b // d, 1) if d > 0 else 1

    def scan(p, lo=0, hi=None):
        cand = [c for c in range(lo, n if hi is None else hi)
                if want[c] and bw[p, c] > 0]
        return min((pair_key(eff(int(bw[p, c]), den[p]), p, c)
                    for c in cand), default=NO_KEY)

    def own_min(i):
        return min((best[p] for p in runs[i] if not best[p] & MARK),
                   default=NO_KEY)

    par, step = 0, 0
    while True:
        st["rounds"] += 1
        offers = []                    # (key, depth)
        acc = {p: scan(p) for p in lists[par]}
        offers += [(acc[p], depth[p]) for p in lists[par]]
        for i in range(len(runs)):
            if dirty[i]:
                dirty[i] = False
                wmin[i] = own_min(i)
            for _ in range(MAX_LOOKS):
                if wmin[i] == NO_KEY:
                    break
                p, c_old = (wmin[i] & 0xffffffff) >> 14, (wmin[i] >> 1) & 8191
                if want[c_old]:
                    break
                st["looks"] += 1
                e = INT_MAX - (wmin[i] >> 32)
                a = (c_old + 1) & ~31
                hit = next((c for c in range(c_old + 1, min(a + LOOK, n))
                            if want[c] and bw[p, c] > 0
                            and eff(int(bw[p, c]), den[p]) == e), None)
                if hit is None:
                    st["misses"] += 1
                    offers.append((wmin[i], depth[p]))
                    best[p] = wmin[i] | MARK
                    lists[par ^ 1].append(p)
                else:
                    best[p] = pair_key(e, p, hit)
                wmin[i] = own_min(i)
            if wmin[i] != NO_KEY:
                offers.append((wmin[i], depth[(wmin[i] & 0xffffffff)
                                              >> 14]))
        g, gd = min(offers, default=(NO_KEY, 0))
        if g == NO_KEY:
            return parent, order
        for p in lists[par]:
            best[p] = acc[p]
            dirty[owner[p]] = True
        lists[par] = []
        ps, cs = (g & 0xffffffff) >> 14, (g >> 1) & 8191
        if not want[cs]:
            st["stand_in_rounds"] += 1
        else:
            children[ps] += 1
            best[ps] = NO_KEY
            if children[ps] < fanout:
                den[ps] = int(wrap(wrap(children[ps] + u1[ps])
                                   * (1 + depth[ps])))
                lists[par ^ 1].append(ps)
            dirty[owner[ps]] = True
            depth[cs] = gd + 1
            den[cs] = int(wrap(wrap(u1[cs]) * (1 + depth[cs])))
            best[cs] = NO_KEY
            lists[par ^ 1].append(cs)
            dirty[owner[cs]] = True
            parent[cs], order[cs] = ps, step
            want[cs] = False
            step += 1
        par ^= 1


def _fanout_case(case):
    """(member, bw, root, fanout, inflight_kb, cluster)"""
    from test_torch_dataplane import BROADCAST_EDGES, _broadcast_edge
    if case in BROADCAST_EDGES:
        return (*_broadcast_edge(case), 1)
    kind, fan, seed = case.split("_")
    rng = np.random.default_rng(int(seed) * 10 + int(fan))
    n = int(rng.integers(40, 130))
    member = rng.random(n) < 0.9
    if kind == "uniform":
        bw = np.full((n, n), 1000, np.int32)
    elif kind == "slices":
        # few values and a CTA boundary between two rows of one eff: the
        # join across slices breaks the tie to the lower row
        bw = (rng.integers(1, 3, size=(n, n)) * 1000).astype(np.int32)
    else:
        bw = rng.integers(0, 50_000, size=(n, n)).astype(np.int32)
        bw[rng.random((n, n)) < 0.05] = 0
    np.fill_diagonal(bw, 0)
    root = int(rng.integers(0, n))
    member[root] = True
    infl = rng.integers(0, 1 << 20, size=n).astype(np.int32)
    return member, bw, root, int(fan), infl, 3 if kind == "slices" else 1


FANOUT_CASES = (
    [f"uniform_{f}_0" for f in range(1, 6)]
    + [f"random_{f}_{s}" for f in range(1, 6) for s in range(2)]
    + [f"slices_{f}_0" for f in (1, 3, 5)])


@pytest.mark.parametrize("case", FANOUT_CASES + ["edge_" + c for c in (
    "divisor_zero", "inflight_minus_one", "inflight_minus_65536",
    "inflight_max_deep", "fanout_zero", "fanout_past_n",
    "member_unreachable", "uniform", "one_node", "root_not_a_member")])
def test_fanout_model_equals_jax(case):
    """The lazy refresh == the JAX function == the oracle == the port's
    plain version, bit for bit: uniform bandwidth (every row's best is
    the same child; looks hit until the members run out), random
    bandwidth with 5% dead links (looks miss: rescans and stand-ins),
    fan-outs 1-5, the ten edges of the plain version, and rows cut into
    three CTA slices with ties on the boundaries."""
    import torch

    from ray_tpu.ops import broadcast_kernel as ref_bc
    from ray_tpu_torch.ops import broadcast_kernel as bc
    *prob, cluster = _fanout_case(case.removeprefix("edge_"))
    stats = {}
    got = fanout_model(*prob, cluster=cluster, stats=stats)
    _same(got, ref_bc.plan_fanout_np(*prob))
    with np.errstate(divide="ignore", over="ignore"):
        _same(got, bc.plan_fanout_oracle(*prob))
    member, bw, root, fanout, infl = prob
    t = [torch.as_tensor(np.asarray(a)) for a in (member, bw, infl)]
    _same(got, [x.numpy() for x in bc.plan_fanout_plain(
        t[0], t[1], root, fanout, t[2])])
    if case.startswith(("uniform", "random")) and fanout > 1:
        # a row's best child taken by another: refreshed by a look, or
        # (random bandwidth) rescanned after a miss
        assert stats["looks"] > 0
        assert stats["misses"] > 0 or case.startswith("uniform")


@pytest.mark.parametrize("cluster", [1, 2, 5, 16])
def test_fanout_model_any_cluster_is_the_same_function(cluster):
    """The slices only split the rows: the tree never depends on how many
    CTAs hold them."""
    *prob, _ = _fanout_case("slices_2_1")
    with np.errstate(divide="ignore", over="ignore"):
        want = bc_oracle(*prob)
    _same(fanout_model(*prob, cluster=cluster), want)


def bc_oracle(*prob):
    from ray_tpu_torch.ops import broadcast_kernel as bc
    return bc.plan_fanout_oracle(*prob)


# (n, per_cta, layout, cluster): broadcast.cu's rule in the source's
# build (kRowsPerCta = 1024) and in the sweep's -DRT_ROWS_PER_CTA builds
# (tests/test_torch_cuda.py holds every row to the library)
FANOUT_RULE = [(1, 1024, "cta", 1), (72, 1024, "cta", 1),
               (1000, 1024, "cta", 1), (1024, 1024, "cta", 1),
               (1025, 1024, "cluster", 2), (8192, 1024, "cluster", 8),
               (8192, 8192, "cta", 1), (72, 64, "cluster", 2),
               (1000, 64, "cluster", 16), (8192, 512, "cluster", 16),
               (1000, 512, "cluster", 2), (64, 64, "cta", 1)]


@pytest.mark.parametrize("n,per_cta,layout,cluster", FANOUT_RULE)
def test_fanout_layout_rule(n, per_cta, layout, cluster):
    assert fanout_plan(n, per_cta) == (layout, cluster)


def magic_by_double(d):
    """broadcast.cu's magic_of: 2**s / d as a double (Python's float is
    the same IEEE binary64, rounded to nearest), truncated, then made
    exact by the remainder."""
    s = 31 + (d - 1).bit_length()
    m = int(float(2**s) / float(d))
    r = (1 << s) - m * d
    if r < 0:
        m, r = m - 1, r + d
    elif r >= d:
        m, r = m + 1, r - d
    return m + (1 if r else 0)


def test_fanout_multiplier_by_double_division_is_magic():
    """The broadcast kernel's multiplier (a double division, corrected) is
    contract.cuh's magic multiplier for every divisor tried: the edges,
    every divisor below 2**16 + 2 and a seeded sample up to INT_MAX."""
    rng = np.random.default_rng(0)
    ds = (EDGE_DIVISORS + list(range(1, (1 << 16) + 2))
          + [int(x) for x in rng.integers(1, INT_MAX, size=20_000)])
    for d in ds:
        assert magic_by_double(d) == magic(d)[0], d
