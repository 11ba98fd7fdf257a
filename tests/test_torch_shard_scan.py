"""The sharded heartbeat's class scan: a numpy model of ``shard_scan``'s
arithmetic (``ray_tpu_torch/ops/csrc/shard_scan.cu``) held bit for bit to
the JAX package's ``_schedule_group_sharded`` and to the port's
``shard_scan_plain``; and the route ``ShardPlane._scan`` takes.

The model is the kernel's arithmetic across ranks, written out: each
rank's partial sums (capacity, the seven levels of a search round, base
and level-set mass), reduced over the ranks in rank order as wrapping
int32; the k-level search of seven levels a round in place of the 15
bisection steps; the exclusive prefix as the lower ranks' mass plus the
rank's own running sum; the overflow argmin as the min of packed 64-bit
(key, global row) values, landing on the rank that owns its row.  The
reference's ``_schedule_group_sharded`` is a ``shard_map`` body, so it is
reached through ``ShardPlane.fused_beat`` (counts, and the lease budgets
priced off the carried avail) and, with per-class group masks, through
``hybrid_kernel.schedule_grouped_sharded_np`` (counts and the carried
avail), on the 8 virtual CPU devices of ``tests/conftest.py``.  The
model's L* is also held to the reference's 15-step bisection over the
same global sums.  The kernel itself is held to ``shard_scan_plain`` on
the card by ``tests/test_torch_cuda.py``."""

import numpy as np
import pytest

import jax
import ray_tpu.ops.shard_reduce as ref_sr
from ray_tpu.ops.hybrid_kernel import schedule_grouped_sharded_np as ref_grouped
from ray_tpu.scheduling.contract import compute_budgets
from ray_tpu_torch.common.config import Config as PortConfig
from ray_tpu_torch.ops import shard_reduce as sr

SCALE = 1 << 12
AVAIL_SHIFT = 27
ROW_MASK = (1 << 13) - 1
BIG = 1 << 30
INF_KEY = 2**31 - 1
TOP = 2 * SCALE + 1
PROBES = 7
N, R, G = 64, 4, 6
MESHES = [(1, "flat"), (2, "flat"), (2, "two_level"), (4, "flat"),
          (4, "two_level"), (8, "flat"), (8, "two_level")]


@pytest.fixture(autouse=True)
def _fresh_port_config():
    PortConfig.reset()
    yield
    PortConfig.reset()


# -- the model ----------------------------------------------------------------

def w32(x):
    """int32 wrap (XLA's and the kernel's uint32 arithmetic)."""
    return (np.asarray(x, np.int64) + 2**31) % 2**32 - 2**31


def _sum32(x):
    return int(w32(np.asarray(x, np.int64).sum()))


class _Rank:
    """One rank's rows for one class: m_max and m(L) as the kernel's
    threads compute them (used*SCALE + 1, the magic-multiplier floor
    division by max(q*SCALE, 1); the same values as numpy's ``//``)."""

    def __init__(self, t, a, live, req, thr):
        self.cols = np.nonzero(req > 0)[0]
        self.q = req[self.cols].astype(np.int64)
        self.t = t[:, self.cols].astype(np.int64)
        self.a = a[:, self.cols].astype(np.int64)
        self.thr = thr
        feas = live & (self.t >= self.q).all(axis=1)
        caps = (self.a // self.q).min(axis=1, initial=BIG)
        self.m_max = np.where(feas & (self.cols.size > 0),
                              np.clip(caps, 0, BIG), 0)

    def m(self, level):
        lp1 = (self.thr - 1 if level < self.thr else level) + 1
        u1 = w32(w32((self.t - self.a) * SCALE) + 1)
        d = np.maximum(w32(self.q * SCALE), 1)
        jc = np.clip(w32(w32(lp1 * self.t) - u1) // d, 0, BIG)
        jc = jc.min(axis=1, initial=BIG)
        return np.where(self.m_max > 0, np.minimum(self.m_max, jc), 0)


def _keys(t, a, live, req, thr, rows):
    """_keys_block: packed int32 keys with the global rows."""
    pos = req > 0
    feas = live & np.where(pos, t >= req, True).all(axis=1)
    availb = np.where(pos, a >= req, True).all(axis=1)
    q = w32(t.astype(np.int64) - a + req)
    s = np.where(pos, w32(q * SCALE) // np.maximum(t, 1), 0).max(
        axis=1, initial=0)
    eff = np.where(availb & (s < thr), 0, s)
    key = w32(((~availb).astype(np.int64) << AVAIL_SHIFT)
              | (eff << 13) | rows)
    return np.where(feas, key, INF_KEY)


def cta_rows(n_l, ctas):
    """Each CTA's rows of a rank as plan() lays them out: threads a CTA
    ceil(n_l / ctas) rounded up to a warp, CTA c the rows [c * threads,
    (c + 1) * threads) (the last CTAs may hold none)."""
    nt = -(-(-(-n_l // ctas)) // 32) * 32
    return [(min(c * nt, n_l), min((c + 1) * nt, n_l)) for c in range(ctas)]


def model_scan(totals, avail, mask, reqs, counts, gmasks, thr,
               require_available, ctas=1):
    """The kernel's scan over per-rank numpy blocks (rank order), every
    exchange over rank-major CTA slots of ``ctas`` CTAs a rank (the
    cluster route's slots, or the global route's: each CTA's wrapping
    sums and packed min in its slot; all = the sum of every slot, a CTA's
    exclusive prefix = the sum of the slots before it plus its own running
    sum).  Returns (alloc (G, n_l) per rank, inf (G,), avail per rank, L*
    (G,), the owner rank of each class's overflow or -1)."""
    s, n_l = len(totals), totals[0].shape[0]
    parts = cta_rows(n_l, ctas)

    def slot_sums(per_rank):
        """Rank-major slots of per-row values: one wrapping sum a CTA."""
        return [_sum32(v[lo:hi]) for v in per_rank for lo, hi in parts]
    av = [a.astype(np.int64).copy() for a in avail]
    allocs = [np.zeros((len(reqs), n_l), np.int64) for _ in range(s)]
    inf = np.zeros(len(reqs), np.int64)
    lstars, owners = [], []
    for gi, (req, count) in enumerate(zip(reqs, counts)):
        live = [mask[k] & (True if gmasks is None else gmasks[k][gi])
                for k in range(s)]
        rk = [_Rank(totals[k], av[k], live[k], req, thr) for k in range(s)]

        def total(level):            # the CTAs' slots, in rank order
            return int(w32(sum(slot_sums([x.m(level) for x in rk]))))

        n_avail = min(int(count), int(w32(sum(slot_sums(
            [x.m_max for x in rk])))))
        overflow = int(w32(int(count) - n_avail))
        lo, hi = 0, TOP
        while lo < hi:               # seven levels a round
            step = (hi - lo + PROBES) // (PROBES + 1)
            jstar = PROBES
            for j in range(PROBES - 1, -1, -1):
                lv = lo + (j + 1) * step - 1
                if lv >= hi or total(min(lv, hi - 1)) >= n_avail:
                    jstar = j
            new_hi = min(lo + (jstar + 1) * step - 1, hi) \
                if jstar < PROBES else hi
            lo = lo + jstar * step if jstar > 0 else lo
            hi = new_hi
        lstars.append(lo)
        base = [x.m(lo - 1) if lo > 0 else np.zeros(n_l, np.int64)
                for x in rk]
        extra = [w32(x.m(lo) - b) for x, b in zip(rk, base)]
        rem = int(w32(n_avail - int(w32(sum(slot_sums(base))))))
        low = np.cumsum([0, *slot_sums(extra)])    # the slots before each
        mins = []
        for k in range(s):
            prefix = np.zeros(n_l, np.int64)
            for c, (lo_r, hi_r) in enumerate(parts):
                e = extra[k][lo_r:hi_r]
                prefix[lo_r:hi_r] = w32(np.cumsum(e) - e
                                        + int(w32(low[k * ctas + c])))
            prefix = w32(prefix)
            give = np.minimum(np.maximum(w32(rem - prefix), 0), extra[k])
            alloc = w32(base[k] + give)
            av[k][:, rk[k].cols] = w32(av[k][:, rk[k].cols]
                                       - alloc[:, None] * rk[k].q)
            allocs[k][gi] = alloc
            rows = k * n_l + np.arange(n_l)
            key = _keys(totals[k], av[k], live[k], req, thr, rows)
            # packed (key ^ sign bit) << 32 | row: the min is (key, row);
            # a CTA without rows offers the all-ones word
            packed = [((int(kk) + 2**31) << 32) | int(rw)
                      for kk, rw in zip(key, rows)]
            mins += [min(packed[lo_r:hi_r], default=2**64 - 1)
                     for lo_r, hi_r in parts]
        okey = (min(mins) >> 32) - 2**31
        queue_ok = okey != INF_KEY
        if require_available:
            queue_ok = queue_ok and ((okey >> AVAIL_SHIFT) & 1) == 0
        owner = -1
        for k in range(s):           # a negative position is another's
            pos = (okey & ROW_MASK) - k * n_l
            if queue_ok and 0 <= pos < n_l:
                allocs[k][gi, pos] = w32(allocs[k][gi, pos] + overflow)
                owner = k
        inf[gi] = 0 if queue_ok else overflow
        owners.append(owner)
    return ([w32(a).astype(np.int32) for a in allocs],
            w32(inf).astype(np.int32),
            [w32(a).astype(np.int32) for a in av], lstars, owners)


def bisect_lstars(totals, avail, mask, reqs, counts, gmasks, thr):
    """L* of the reference's 15-step bisection over the global sums, the
    classes carried with the model's own avail (so only the search
    differs)."""
    out = []
    s = len(totals)
    av = [a.copy() for a in avail]
    for gi, (req, count) in enumerate(zip(reqs, counts)):
        live = [mask[k] & (True if gmasks is None else gmasks[k][gi])
                for k in range(s)]
        rk = [_Rank(totals[k], av[k], live[k], req, thr) for k in range(s)]
        n_avail = min(int(count), int(w32(sum(_sum32(x.m_max)
                                              for x in rk))))
        lo, hi = 0, 2 * SCALE
        for _ in range(SCALE.bit_length() + 2):
            mid = (lo + hi) // 2
            if int(w32(sum(_sum32(x.m(mid)) for x in rk))) >= n_avail:
                hi = mid
            else:
                lo = mid + 1
        out.append(lo)
        one = model_scan([totals[k] for k in range(s)], av,
                         mask, reqs[gi:gi + 1], counts[gi:gi + 1],
                         None if gmasks is None else
                         [g[gi:gi + 1] for g in gmasks], thr, False)
        av = one[2]
    return out


# -- cases ----------------------------------------------------------------------

def _case(seed, n=N, r=R, g=G):
    rng = np.random.default_rng(seed)
    totals = rng.integers(0, 1 << 17, size=(n, r)).astype(np.int32)
    totals[rng.random(totals.shape) < 0.2] = 0
    avail = (totals * rng.random(totals.shape)).astype(np.int32)
    rows = rng.random(n) < 0.1                      # overcommitted rows
    avail[rows] = -(totals[rows] * rng.random((int(rows.sum()), r))
                    ).astype(np.int32)
    mask = rng.random(n) > 0.1
    reqs = rng.integers(0, 9000, size=(g, r)).astype(np.int32)
    reqs[rng.random(reqs.shape) < 0.4] = 0
    counts = rng.integers(0, 400, size=g).astype(np.int32)
    gmask = rng.random((g, n)) > 0.15
    return totals, avail, mask, reqs, counts, gmask


def _edges(seed):
    """A class with no positive request, an all-infeasible class, counts
    past the total capacity and a zero count, beside random classes."""
    totals, avail, mask, reqs, counts, gmask = _case(seed)
    reqs[0] = 0
    reqs[1] = 0
    reqs[1, 2] = (1 << 17) + 1                      # no row has that much
    counts[2] = 1_000_000
    counts[3] = 0
    return totals, avail, mask, reqs, counts, gmask


def _split(a, s, axis=0):
    return [np.ascontiguousarray(b) for b in np.split(a, s, axis=axis)]


def _gather(model, n):
    alloc, inf, av, _, _ = model
    counts = np.concatenate([np.concatenate(alloc, axis=1),
                             inf[:, None]], axis=1)
    return counts, np.concatenate(av)[:n]


def _port_plain(s, mode, totals, avail, mask, reqs, counts, gmask, thr,
                require_available):
    import torch
    plane = sr.plane_for(s, mode, ["cpu"] * s)
    t = lambda blocks: [torch.as_tensor(b) for b in blocks]   # noqa: E731
    gm = None if gmask is None else t(_split(gmask, s, axis=1))
    alloc, inf, av = sr.shard_scan_plain(
        plane.transport, t(_split(totals, s)), t(_split(avail, s)),
        t(_split(mask, s)), [torch.as_tensor(reqs)] * s,
        [torch.as_tensor(counts)] * s, gm, thr, require_available)
    return [a.numpy() for a in alloc], inf.numpy(), [a.numpy() for a in av]


def _ref_fused(s, mode, totals, avail, mask, reqs, counts, thr,
               require_available):
    """The reference's shard_map beat (its scan is
    ``_schedule_group_sharded``): (counts (G, N+1), budgets (C, N))."""
    pl = ref_sr.plane_for(s, mode)
    n_l = totals.shape[0] // s
    put = jax.device_put
    keys = np.zeros((len(reqs), totals.shape[0]), np.int32)
    packed, _ = pl.fused_beat(
        put(totals, pl.sh_rows), put(avail, pl.sh_rows),
        put(mask, pl.sh_vec), put(keys, pl.sh_cols),
        put(reqs, pl.sh_repl),
        put(np.arange(len(reqs), dtype=np.int32), pl.sh_repl),
        put(counts, pl.sh_repl),
        put(np.ones(totals.shape[0], bool), pl.sh_vec),
        put(np.full(s, n_l, np.int32), pl.sh_vec),
        put(np.zeros((s, totals.shape[1]), np.int32), pl.sh_rows),
        thr, require_available=require_available)
    packed = np.asarray(packed)
    return packed[:len(reqs)], packed[len(reqs):, :-1]


def _check_fused(s, mode, arrays, thr, require_available, ctas=1):
    totals, avail, mask, reqs, counts, _ = arrays
    model = model_scan(_split(totals, s), _split(avail, s), _split(mask, s),
                       reqs, counts, None, thr, require_available, ctas)
    got, post = _gather(model, totals.shape[0])
    want, budgets = _ref_fused(s, mode, totals, avail, mask, reqs, counts,
                               thr, require_available)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        compute_budgets(totals, post, reqs, mask), budgets)
    plain = _port_plain(s, mode, totals, avail, mask, reqs, counts, None,
                        thr, require_available)
    for x, y in zip(model[:3], plain):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    assert model[3] == bisect_lstars(_split(totals, s), _split(avail, s),
                                     _split(mask, s), reqs, counts, None,
                                     thr)
    return model


def _check_grouped(s, mode, arrays, thr, ctas=1):
    totals, avail, mask, reqs, counts, gmask = arrays
    gm = _split(gmask, s, axis=1)
    model = model_scan(_split(totals, s), _split(avail, s), _split(mask, s),
                       reqs, counts, gm, thr, False, ctas)
    got, post = _gather(model, totals.shape[0])
    want, want_avail = ref_grouped(totals, avail, mask, reqs, counts, gmask,
                                   thr_fp=thr, n_shards=s, reduce_mode=mode)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(post, want_avail)
    plain = _port_plain(s, mode, totals, avail, mask, reqs, counts, gmask,
                        thr, False)
    for x, y in zip(model[:3], plain):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    assert model[3] == bisect_lstars(_split(totals, s), _split(avail, s),
                                     _split(mask, s), reqs, counts, gm, thr)
    return model


# -- the model against the reference and the plain version -----------------------

@pytest.mark.parametrize("s,mode", MESHES)
@pytest.mark.parametrize("seed", [0, 1])
def test_model_equals_the_reference_beat(s, mode, seed):
    model = _check_fused(s, mode, _case(seed), SCALE // 2, False)
    assert sum(int(a.sum()) for a in model[0]) > 0


@pytest.mark.parametrize("s,mode", MESHES)
def test_model_equals_the_reference_with_group_masks(s, mode):
    _check_grouped(s, mode, _case(7), SCALE // 2)


@pytest.mark.parametrize("s,mode", [(2, "flat"), (4, "two_level"),
                                    (8, "flat")])
@pytest.mark.parametrize("ctas", [1, 2, 4, 8])
def test_cta_slots_equal_the_reference(s, mode, ctas):
    """The exchange over rank-major CTA slots (``ctas`` CTAs a rank, as
    the cluster route lays every rank's CTAs out in one cluster, and the
    global route's slots): the sums over every slot, each CTA's prefix
    from the slots before it and the min of the slots' packed keys give
    the reference's counts, budgets and carried avail exactly, at 1024
    rows (the beat cell's) with and without group masks."""
    arrays = _case(11, n=1024)
    model = _check_fused(s, mode, arrays, SCALE // 2, False, ctas)
    assert sum(int(a.sum()) for a in model[0]) > 0
    _check_grouped(s, mode, arrays, SCALE // 2, ctas)
    assert sum(1 for lo, hi in cta_rows(1024 // s, ctas) if hi > lo) == \
        min(ctas, -(-(1024 // s) // 32))


@pytest.mark.parametrize("s,mode", [(2, "flat"), (4, "two_level"),
                                    (8, "flat")])
def test_model_require_available(s, mode):
    arrays = _edges(3)
    model = _check_fused(s, mode, arrays, SCALE // 2, True)
    # the class past capacity queues on no row whose avail fits
    assert model[1][2] > 0


@pytest.mark.parametrize("s,mode", MESHES)
@pytest.mark.parametrize("thr", [0, SCALE // 2, 2 * SCALE + 1])
def test_model_edges(s, mode, thr):
    """No positive request (nothing consumed: the count queues on the
    first feasible row), an all-infeasible class (inf), counts past the
    total capacity (the overflow on the best row), a zero count."""
    arrays = _edges(5)
    model = _check_fused(s, mode, arrays, thr, False)
    alloc, inf = model[0], model[1]
    counts = arrays[4]
    assert inf[1] == counts[1] and inf[0] == 0
    assert sum(int(a[1].sum()) for a in alloc) == 0
    assert sum(int(a[2].sum()) for a in alloc) + int(inf[2]) == counts[2]
    assert sum(int(a[3].sum()) for a in alloc) == 0 and inf[3] == 0
    _check_grouped(s, mode, arrays, thr)


@pytest.mark.parametrize("owner", [0, 1, 2, 3])
@pytest.mark.parametrize("mode", ["flat", "two_level"])
def test_overflow_lands_on_its_owning_rank(owner, mode):
    """Counts past capacity with the rows of every rank below ``owner``
    masked off: the overflow's node, the best feasible row after the fill,
    is the owner's first row, and only that rank adds it."""
    s = 4
    totals, avail, mask, reqs, counts, gmask = _case(11)
    totals[:] = 1000
    avail[:] = 500
    mask[:] = True
    mask[:owner * N // s] = False
    reqs[:] = 0
    reqs[:, 0] = 100
    counts[:] = 10_000
    arrays = (totals, avail, mask, reqs, counts, gmask)
    model = _check_fused(s, mode, arrays, SCALE // 2, False)
    assert model[4] == [owner] * G
    assert int(model[0][owner][0, 0]) > 5           # the overflow is there
    _check_grouped(s, mode, arrays, SCALE // 2)


@pytest.mark.parametrize("s,mode", [(2, "flat"), (4, "two_level"),
                                    (8, "flat")])
def test_level_set_spans_every_rank(s, mode):
    """Identical rows: every row sits at L*, so the level-L* slots go out
    in global row order across the ranks and the lower ranks' mass is
    what places the rest."""
    totals, avail, mask, reqs, counts, gmask = _case(17)
    totals[:] = 1000
    avail[:] = 1000
    mask[:] = True
    gmask[:] = True
    reqs[:] = 0
    reqs[:, 1] = 100
    counts[:] = [150, 5, 61, 1, 64, 20]
    arrays = (totals, avail, mask, reqs, counts, gmask)
    model = _check_fused(s, mode, arrays, SCALE // 2, False)
    first = [int((a[0] > 0).sum()) for a in model[0]]
    assert sum(f > 0 for f in first) >= 2           # it spans the ranks
    _check_grouped(s, mode, arrays, SCALE // 2)


def test_model_search_is_the_bisection_on_ragged_sums():
    """Many classes on one mesh, the k-level L* equal to the 15-step one
    class by class (also where rows are dead, masked or overcommitted)."""
    arrays = _case(13, g=24)
    _check_fused(8, "two_level", arrays, SCALE // 2, False)
    _check_grouped(8, "two_level", arrays, 3 * SCALE // 4)


# -- the route ShardPlane._scan takes ---------------------------------------------

def test_cpu_ranks_take_the_plain_version():
    from ray_tpu_torch.ops import hybrid_kernel as hk
    totals, avail, mask, reqs, counts, gmask = _case(2)
    plane = sr.plane_for(4, "flat", ["cpu"] * 4)
    assert plane.scan_route == "plain"
    before = sr.shard_scan.launches
    got = hk.schedule_grouped_sharded_np(totals, avail, mask, reqs, counts,
                                         gmask, n_shards=4,
                                         devices=["cpu"] * 4)
    assert plane.last_scan_route == "plain"
    assert sr.shard_scan.launches == before
    want = ref_grouped(totals, avail, mask, reqs, counts, gmask,
                       n_shards=4, reduce_mode="flat")
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def _patch_cards(monkeypatch, n):
    torch = sr.torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: n)


def test_one_card_mesh_routes_to_the_kernel(monkeypatch):
    """Ranks that share one card: ``_scan`` calls ``shard_scan`` (the
    kernel's wrapper) and never the plain version."""
    import torch
    _patch_cards(monkeypatch, 1)
    plane = sr.ShardPlane(sr.build_mesh(2, "flat", ["cuda:0"] * 2))
    assert plane.scan_route == "shard_scan"
    calls = []

    def kernel(*args, **kw):
        calls.append(len(args[0]))
        raise RuntimeError("no GPU")

    def plain(*args, **kw):
        raise AssertionError("the plain version ran on a one-card mesh")

    monkeypatch.setattr(sr, "shard_scan", kernel)
    monkeypatch.setattr(sr, "shard_scan_plain", plain)
    z = [torch.zeros((4, 2), dtype=torch.int32)] * 2
    with pytest.raises(RuntimeError, match="no GPU"):
        plane._scan(z, z, [torch.ones(4, dtype=torch.bool)] * 2,
                    [torch.ones((1, 2), dtype=torch.int32)] * 2,
                    [torch.ones(1, dtype=torch.int32)] * 2, None,
                    SCALE // 2, False)
    assert calls == [2] and plane.last_scan_route == "shard_scan"


def test_one_card_mesh_without_a_gpu_raises(monkeypatch):
    """No GPU: a mesh of ranks on ``cuda:0`` raises; nothing runs the
    plain version instead."""
    from ray_tpu_torch.ops import hybrid_kernel as hk

    def plain(*args, **kw):
        raise AssertionError("the plain version ran on a one-card mesh")

    monkeypatch.setattr(sr, "shard_scan_plain", plain)
    totals, avail, mask, reqs, counts, gmask = _case(4)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        hk.schedule_grouped_sharded_np(totals, avail, mask, reqs, counts,
                                       gmask, n_shards=2,
                                       devices=["cuda:0"] * 2)


def test_distinct_cards_keep_the_nccl_route(monkeypatch):
    """Ranks on distinct cards: the scan stays rank by rank over NCCL
    (``shard_scan_plain`` with the NCCL transport), chosen by the mesh."""
    import torch
    _patch_cards(monkeypatch, 2)
    plane = sr.ShardPlane(sr.build_mesh(2, "flat", ["cuda:0", "cuda:1"]))
    assert plane.transport.nccl and plane.scan_route == "nccl"
    seen = []

    def plain(tp, *args):
        seen.append(tp)
        raise RuntimeError("no GPU")

    def kernel(*args, **kw):
        raise AssertionError("the kernel ran on distinct cards")

    monkeypatch.setattr(sr, "shard_scan_plain", plain)
    monkeypatch.setattr(sr, "shard_scan", kernel)
    z = [torch.zeros((4, 2), dtype=torch.int32)] * 2
    with pytest.raises(RuntimeError, match="no GPU"):
        plane._scan(z, z, [torch.ones(4, dtype=torch.bool)] * 2,
                    [torch.ones((1, 2), dtype=torch.int32)] * 2,
                    [torch.ones(1, dtype=torch.int32)] * 2, None,
                    SCALE // 2, False)
    assert seen == [plane.transport] and plane.last_scan_route == "nccl"


def test_cpu_wrapper_is_the_plain_version():
    """``shard_scan`` on CPU tensors is ``shard_scan_plain`` over a flat
    transport: the same arrays, and no launch counted."""
    import torch
    totals, avail, mask, reqs, counts, gmask = _case(6)
    s = 4
    t = lambda blocks: [torch.as_tensor(b) for b in blocks]   # noqa: E731
    args = (t(_split(totals, s)), t(_split(avail, s)), t(_split(mask, s)),
            [torch.as_tensor(reqs)] * s, [torch.as_tensor(counts)] * s,
            t(_split(gmask, s, axis=1)), SCALE // 2, True)
    before = sr.shard_scan.launches
    got = sr.shard_scan(*args)
    assert sr.shard_scan.launches == before
    want = model_scan(_split(totals, s), _split(avail, s), _split(mask, s),
                      reqs, counts, _split(gmask, s, axis=1), SCALE // 2,
                      True)
    for x, y in zip(got[0], want[0]):
        np.testing.assert_array_equal(x.numpy(), y)
    np.testing.assert_array_equal(got[1].numpy(), want[1])
    for x, y in zip(got[2], want[2]):
        np.testing.assert_array_equal(x.numpy(), y)
