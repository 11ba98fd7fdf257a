"""The rest of the delta heartbeat: ``beat_rows`` and ``beat_tail``
(``ray_tpu_torch/ops/csrc/beat.cu``) as a numpy model of the two kernels'
own decomposition, held bit for bit to the JAX package's programs and to
the port's plain versions.

The model is the kernels' work written out.  ``beat_rows``' beat call is
three kinds of CTA a rank, none reading what another writes: a gather CTA
(the scan's classes, clamped slots), lane CTAs of 8 dirty lanes (a warp a
lane: the staged row stored into the residents and its key column scored
against every class from the staged values, the low bits the global row)
and eff CTAs of 64 rows (avail_eff from a per-tile lookup: this beat's
override, else the dirty row's new avail, else the resident's as it was
before the call; mask_eff the new or resident mask & extra_mask).  The
class install and the full rescore are (rank, 32-row tile, block of 8
classes) CTAs: the tile's columns staged with a magic multiplier a (row,
column) (``magic_of``: a double quotient corrected in integers) and every
key's division a multiply-high (``fdiv``), each key written once; rows
wider than 128 columns take the division; the install scatters its rows
into reqs from the tile-0 CTAs and scores its slots from the staged rows.
``beat_tail`` writes the packed (G + C, N + 1) readback tile by tile and
the per-class argmin as the min of packed 64-bit (key, global row) values
over every rank.  The budgets are priced by (rank, 64-row tile, block of
8 classes) CTAs, a warp a class with its positive columns compacted and
each request's magic multiplier in place of the division (past 32
positive columns, the division), and the counts block is copied in a
grid-stride loop.  It is held to ``ray_tpu/ops/hybrid_kernel.py``
(``full_rescore``, ``apply_dirty_rows``, ``apply_dirty_classes``,
``fused_beat``) and to the reference's ``ShardPlane`` programs on the 8
virtual CPU devices of ``tests/conftest.py`` at 1, 2, 4 and 8 ranks, with
padding lanes, an all-INF key row, negative overrides, an override on a
dirty row, an all-false soft mask, padded class slots and
``require_available``.  The kernels themselves are held to the plain
versions on the card by ``tests/test_torch_cuda.py``."""

import numpy as np
import pytest
import torch

import jax
import ray_tpu.ops.hybrid_kernel as ref_hk
import ray_tpu.ops.shard_reduce as ref_sr
from ray_tpu.scheduling import DeltaScheduler as RefDelta
from ray_tpu.scheduling import ShardedDeltaScheduler as RefSharded
from ray_tpu_torch.common.config import Config as PortConfig
from ray_tpu_torch.ops import _build
from ray_tpu_torch.ops import hybrid_kernel as hk
from ray_tpu_torch.scheduling import DeltaScheduler as PortDelta
from ray_tpu_torch.scheduling import ShardedDeltaScheduler as PortSharded
from ray_tpu_torch.scheduling.policy import BeatBlob
from test_torch_delta import Twin, _assert_beat_equal, _specs

SCALE = 1 << 12
SCORE_SHIFT = 13
AVAIL_SHIFT = 27
INF_KEY = 2**31 - 1
BUDGET_CAP = 1 << 15
LANES = 8                        # csrc/beat.cu kLanes: dirty lanes a CTA
EFF_ROWS = 64                    # kEffRows: node rows an eff CTA
KEY_ROWS = 32                    # kKeyRows: node rows a key CTA
KEY_CLS = 8                      # kKeyCls: classes a key CTA
ROW_COLS = 128                   # kRowCols: a row's columns staged on chip
KEY_WAVE = 4 * 132               # kKeyWave: key CTAs in one wave
MAX_PER_WARP = 8                 # kMaxPerWarp: classes a warp at most
TAIL_ROWS = 64                   # kTailRows: node rows a budget CTA
CLS_BLOCK = 8                    # kClsBlock: classes a budget CTA
COL_CAP = 32                     # kColCap: a class's columns on chip
MESHES = [(1, "flat"), (2, "two_level"), (4, "flat"), (8, "two_level")]


@pytest.fixture(autouse=True)
def _fresh_port_config():
    PortConfig.reset()
    yield
    PortConfig.reset()


# -- the model ------------------------------------------------------------------

def _i32(x):
    """int32 wrap (the kernels' uint32 arithmetic, cast back)."""
    return (np.asarray(x, np.int64) + 2**31) % 2**32 - 2**31


def model_key(t, a, live, q, thr, rows, staged=False):
    """beat.cu's key of one request q (R,) over rows: t/a (B, R), live
    (B,), rows (B,) global rows.  ``staged``: each division by the row's
    magic multiplier (``magic_of(max(t, 1))``, ``fdiv``), as the kernels
    score the rows they stage; else key_of's division.  (B,) int32."""
    t, a = np.asarray(t, np.int64), np.asarray(a, np.int64)
    feas = np.asarray(live, bool).copy()
    availb = np.ones(len(rows), bool)
    s = np.zeros(len(rows), np.int64)
    for col in np.flatnonzero(q > 0):
        qc = int(q[col])
        feas &= t[:, col] >= qc
        availb &= a[:, col] >= qc
        num = _i32(_i32(_i32(t[:, col] - a[:, col]) + qc) * SCALE)
        d = np.maximum(t[:, col], 1)
        if staged:
            m, sh = magic_of(d), 31 + _ceil_log2(d)
            s = np.maximum(s, fdiv(num, m, sh))
        else:
            s = np.maximum(s, num // d)
    eff = np.where(availb & (s < thr), 0, s)
    key = ((~availb).astype(np.int64) << AVAIL_SHIFT) \
        | (eff << SCORE_SHIFT) | np.asarray(rows, np.int64)
    return np.where(feas, _i32(key & 0xffffffff), INF_KEY).astype(np.int32)


def _ceil_log2(d):
    """ceil(log2 d) for d >= 1: the bit length of d - 1 (frexp's exponent,
    exact below 2**53)."""
    return np.frexp((np.asarray(d, np.int64) - 1).astype(np.float64))[1] \
        .astype(np.int64)


def magic_of(d):
    """beat.cu magic_of for divisors d >= 1: q = the double quotient
    2**s / d truncated (IEEE division, correctly rounded), one down where
    q d passes 2**s, plus one unless q d is 2**s: ceil(2**s / d), s = 31 +
    ceil(log2 d), as uint64."""
    d = np.asarray(d, np.int64)
    s = (31 + _ceil_log2(d)).astype(np.uint64)
    p = np.left_shift(np.uint64(1), s)
    du = d.astype(np.uint64)
    q = np.trunc(np.ldexp(1.0, s.astype(np.int64)) / d.astype(np.float64)
                 ).astype(np.uint64)
    q = np.where(q * du > p, q - np.uint64(1), q)
    return q + (q * du != p).astype(np.uint64)


def fdiv(x, m, s):
    """contract.cuh fdiv for any int32 dividend x: a negative one through
    its complement (floor(x / d) = ~floor(~x / d)), a multiply-high and a
    shift."""
    x = np.asarray(x, np.int64)
    neg = x < 0
    xx = np.where(neg, ~x, x).astype(np.uint64)
    q = ((xx * np.asarray(m, np.uint64)) >> np.asarray(s, np.uint64)) \
        .astype(np.int64)
    return np.where(neg, ~q, q)


def magic(d):
    """contract.cuh magic(d) for divisors d >= 1 (int64 array): s = 31 +
    ceil(log2 d), m = ceil(2**s / d), as uint64."""
    d = np.asarray(d, np.int64)
    s = 31 + np.array([int(v - 1).bit_length() for v in d.ravel()],
                      np.int64).reshape(d.shape)
    m = (np.left_shift(np.int64(1), s).astype(np.uint64)
         + (d - 1).astype(np.uint64)) // d.astype(np.uint64)
    return m, s.astype(np.uint64)


def fdiv_nonneg(x, m, s):
    """contract.cuh fdiv for dividends 0 <= x < 2**31: a multiply-high
    and a shift."""
    return ((np.asarray(x, np.int64).astype(np.uint64) * m) >> s) \
        .astype(np.int64)


def model_budget(t, a, live, q):
    """beat.cu's budget of one class over rows: the positive columns
    compacted (at most COL_CAP, each with its magic multiplier), the
    avail clamped >= 0 and divided by a multiply-high; past COL_CAP
    positive columns, budget_of's division."""
    cols = np.flatnonzero(q > 0)
    feas = np.asarray(live, bool).copy()
    fill = np.full(len(t), BUDGET_CAP, np.int64)
    for col in cols:
        feas &= t[:, col] >= q[col]
        x = np.maximum(np.asarray(a[:, col], np.int64), 0)
        if len(cols) <= COL_CAP:
            m, sh = magic(np.array([q[col]]))
            fill = np.minimum(fill, fdiv_nonneg(x, m[0], sh[0]))
        else:
            fill = np.minimum(fill, x // int(q[col]))
    return np.where(feas, fill, 0).astype(np.int32)


def model_state(totals, avail, mask, reqs, keys, s):
    """Per-rank numpy residents (each rank its own copy of reqs)."""
    def split(x):
        return [np.array(b) for b in np.split(np.asarray(x), s)]
    return {"totals": split(totals), "avail": split(avail),
            "mask": split(mask), "reqs": [np.array(reqs) for _ in range(s)],
            "keys": [np.array(b) for b in np.split(np.asarray(keys), s,
                                                   axis=1)]}


def model_rows(st, thr, rows=None, overrides=None, extra_mask=None,
               groups=None, classes=None, rescore=False, wave=KEY_WAVE):
    """beat_rows, CTA by CTA, in place on ``st`` (``wave``: the key CTAs'
    wave, smaller to put several classes on a warp at a small size)."""
    if rescore or classes is not None:
        return _model_keys(st, thr, classes, wave)
    s = len(st["totals"])
    n_l, r = st["totals"][0].shape
    c = st["reqs"][0].shape[0]
    before = {f: [np.array(x) for x in st[f]] for f in ("avail", "mask")}
    if groups is not None:
        g = len(groups[0][0])
        for f, shape, dtype in (("avail_eff", (n_l, r), np.int32),
                                ("mask_eff", (n_l,), bool),
                                ("group_reqs", (g, r), np.int32),
                                ("group_counts", (g,), np.int32)):
            st[f] = [np.zeros(shape, dtype) for _ in range(s)]
    for k in range(s):
        t, a, m, q, keys = (st[f][k] for f in
                            ("totals", "avail", "mask", "reqs", "keys"))
        if groups is not None:                  # the gather CTA
            st["group_reqs"][k][:] = q[np.clip(groups[0][k], 0, c - 1)]
            st["group_counts"][k][:] = groups[1][k]
        idx = np.asarray([] if rows is None else rows[0][k], np.int64)
        assert len(set(i for i in idx if i < n_l)) == \
            int((idx < n_l).sum())              # the host's rows are unique
        for j0 in range(0, len(idx), LANES):     # the lane CTAs
            for j in range(j0, min(j0 + LANES, len(idx))):
                row = int(idx[j])
                if not 0 <= row < n_l:          # a padding lane
                    continue
                rt, ra = rows[1][k][j][None], rows[2][k][j][None]
                live = np.asarray([rows[3][k][j]], bool)
                t[row], a[row], m[row] = rt[0], ra[0], live[0]
                for cls in range(c):            # from the staged row
                    keys[cls, row] = model_key(rt, ra, live, q[cls], thr,
                                               [k * n_l + row],
                                               staged=r <= ROW_COLS)[0]
        if groups is None:
            continue
        ov = [] if overrides is None else overrides[0][k]
        em = np.ones(n_l, bool) if extra_mask is None else extra_mask[k]
        for lo in range(0, n_l, EFF_ROWS):       # the eff CTAs
            hi = min(lo + EFF_ROWS, n_l)
            dirty = {int(row): j for j, row in enumerate(idx)
                     if lo <= row < hi}
            over = {int(row): j for j, row in enumerate(ov)
                    if lo <= row < hi}
            for row in range(lo, hi):
                if row in over:                 # overrides win
                    st["avail_eff"][k][row] = overrides[1][k][over[row]]
                elif row in dirty:
                    st["avail_eff"][k][row] = rows[2][k][dirty[row]]
                else:
                    st["avail_eff"][k][row] = before["avail"][k][row]
                live = rows[3][k][dirty[row]] if row in dirty \
                    else before["mask"][k][row]
                st["mask_eff"][k][row] = live and em[row]


def keys_per_warp(s, n_l, n_cls, r, wave=KEY_WAVE):
    """beat.cu keys_per_warp: one class a warp of a key CTA while the CTAs
    fit one wave, else as many as bring them to a wave (at most 8, the
    CTA's shared memory under 96 KB)."""
    def cdiv(x, y):
        return -(-x // y)
    base = s * cdiv(n_l, KEY_ROWS) * cdiv(n_cls, KEY_CLS)
    pw = min(max(cdiv(base, wave), 1), MAX_PER_WARP)
    cols = r if r <= ROW_COLS else 0
    while pw > 1 and (3 * (KEY_ROWS + 1) + 2 * KEY_CLS * pw) * cols * 4 \
            > 96 * 1024:
        pw -= 1
    return pw


def _model_keys(st, thr, classes, wave=KEY_WAVE):
    """The install (``classes``) or the full rescore: (rank, row tile,
    class block) CTAs, a block of 8 x ``keys_per_warp`` classes (warp w
    its classes w, w + 8, ...), every (slot, row) key written once."""
    s = len(st["totals"])
    n_l, r = st["totals"][0].shape
    c = st["reqs"][0].shape[0]
    n_cls = c if classes is None else len(classes[0][0])
    block = KEY_CLS * keys_per_warp(s, n_l, n_cls, r, wave)
    for k in range(s):
        t, a, m, q, keys = (st[f][k] for f in
                            ("totals", "avail", "mask", "reqs", "keys"))
        written = np.zeros(keys.shape, bool)
        new_q = np.array(q)
        for lo in range(0, n_l, KEY_ROWS):
            hi = min(lo + KEY_ROWS, n_l)
            grow = k * n_l + np.arange(lo, hi)
            for c0 in range(0, n_cls, block):
                for j in (c0 + w + i * KEY_CLS for w in range(KEY_CLS)
                          for i in range(block // KEY_CLS)
                          if c0 + w + i * KEY_CLS < n_cls):
                    slot = j if classes is None else int(classes[0][k][j])
                    if not 0 <= slot < c:       # a padding lane
                        continue
                    req = q[slot] if classes is None else classes[1][k][j]
                    if classes is not None and lo == 0:
                        new_q[slot] = req
                    assert not written[slot, lo:hi].any()
                    written[slot, lo:hi] = True
                    keys[slot, lo:hi] = model_key(
                        t[lo:hi], a[lo:hi], m[lo:hi], req, thr, grow,
                        staged=r <= ROW_COLS)
        q[:] = new_q
        if classes is None:
            assert written.all()


def model_tail(st, alloc, inf, av_fin):
    """beat_tail: the counts block copied element by element along the
    packed rows, the budgets by (rank, row tile, class block) CTAs, a
    (class, row) each, every cell written once; and each class's argmin
    as the min packed (key, global row)."""
    s = len(st["totals"])
    n_l = st["totals"][0].shape[0]
    c = st["reqs"][0].shape[0]
    g = alloc[0].shape[0]
    n = s * n_l
    packed = np.full((g + c, n + 1), -7, np.int64)
    for e in range(g * n):                     # the grid-stride copy
        gi, col = divmod(e, n)
        k, row = divmod(col, n_l)
        assert packed[gi, col] == -7
        packed[gi, col] = alloc[k][gi, row]
    packed[:g, n] = inf
    packed[g:, n] = 0
    for k in range(s):
        for lo in range(0, n_l, TAIL_ROWS):
            hi = min(lo + TAIL_ROWS, n_l)
            for c0 in range(0, c, CLS_BLOCK):
                for cls in range(c0, min(c0 + CLS_BLOCK, c)):
                    cols = k * n_l + np.arange(lo, hi)
                    assert (packed[g + cls, cols] == -7).all()
                    packed[g + cls, cols] = model_budget(
                        st["totals"][k][lo:hi], av_fin[k][lo:hi],
                        st["mask_eff"][k][lo:hi], st["reqs"][k][cls])
    assert (packed != -7).all()
    amin = np.zeros(c, np.int32)
    for cls in range(c):
        best = None
        for k in range(s):
            key = st["keys"][k][cls].astype(np.int64)
            v = (((key ^ 0x80000000) & 0xffffffff).astype(np.uint64)
                 << np.uint64(32)) \
                | (k * n_l + np.arange(n_l)).astype(np.uint64)
            m = int(v.min())
            best = m if best is None else min(best, m)
        amin[cls] = best & 0xffffffff
    return packed.astype(np.int32), amin


def model_scan(st, thr, require_available):
    """The class scan between the two kernels: the port's plain versions
    (held to the reference in tests/test_torch_hybrid.py and
    tests/test_torch_shard_scan.py).  Returns (alloc per rank, inf,
    av_fin per rank) as numpy."""
    from ray_tpu_torch.ops import shard_reduce as sr
    t = [torch.as_tensor(x) for x in st["totals"]]
    args = ([torch.as_tensor(x) for x in st["avail_eff"]],
            [torch.as_tensor(x) for x in st["mask_eff"]],
            [torch.as_tensor(x) for x in st["group_reqs"]],
            [torch.as_tensor(x) for x in st["group_counts"]])
    if len(t) == 1:
        counts, av = hk.waterfill_scan_plain(t[0], *(x[0] for x in args),
                                             None, thr, require_available)
        n = t[0].shape[0]
        return [counts[:, :n].numpy()], counts[:, n].numpy(), [av.numpy()]
    alloc, inf, av = sr.shard_scan(t, *args, None, thr, require_available)
    return [x.numpy() for x in alloc], inf.numpy(), [x.numpy() for x in av]


# -- cases ----------------------------------------------------------------------

def _case(seed, s, n_l=80, r=5, c=16, n_cls=12, b=8, bo=8, g=16,
          em="random"):
    """Residents at N = s * n_l, C = 16 class slots (the last four padded:
    all-zero requests), class 1 infeasible everywhere (an all-INF key
    row), per-rank buckets of dirty rows and overrides with padding
    lanes, a negative override, an override on a dirty row, a class
    install with padding lanes."""
    rng = np.random.default_rng(seed)
    n = s * n_l
    totals = rng.integers(0, 60, size=(n, r)).astype(np.int32)
    totals[rng.random(totals.shape) < 0.2] = 0
    avail = (totals - rng.integers(0, 40, size=(n, r))).astype(np.int32)
    mask = rng.random(n) > 0.15
    reqs = np.zeros((c, r), np.int32)
    reqs[:n_cls] = rng.integers(0, 6, size=(n_cls, r)) * \
        (rng.random((n_cls, r)) > 0.4)
    reqs[1, 0] = 1000                       # no row has that much
    keys = np.array(ref_hk.full_rescore(totals, avail, mask, reqs,
                                        SCALE // 2))
    n_dirty = min(b - 2, n_l)

    def per_rank(fn):
        return [fn(k) for k in range(s)]
    idx = per_rank(lambda k: np.concatenate(
        [np.sort(rng.choice(n_l, n_dirty, replace=False)),
         [n_l] * (b - n_dirty)]).astype(np.int32))
    rows = (idx,
            per_rank(lambda k: rng.integers(0, 60, (b, r)).astype(np.int32)),
            per_rank(lambda k: rng.integers(-30, 60, (b, r)).astype(np.int32)),
            per_rank(lambda k: rng.random(b) > 0.3))
    ov_idx = per_rank(lambda k: np.concatenate(
        [np.sort(rng.choice(n_l, 3, replace=False)),
         [n_l] * (bo - 3)]).astype(np.int32))
    for i, o in zip(idx, ov_idx):           # an override on a dirty row
        if i[0] not in o[:3]:
            o[1] = i[0]
    ov_av = per_rank(lambda k: rng.integers(-50, 60, (bo, r)).astype(np.int32))
    for a in ov_av:
        a[0, :] = -5000                     # planned load past zero
    if em == "random":
        extra = per_rank(lambda k: rng.random(n_l) > 0.2)
    else:
        extra = per_rank(lambda k: np.zeros(n_l, bool))
    slots = np.full(g, c, np.int32)         # padding slots == C
    slots[:n_cls] = rng.permutation(n_cls)
    counts = np.zeros(g, np.int32)
    counts[:n_cls] = rng.integers(0, 40, n_cls)
    cls_idx = np.array([2, c - 3, c, c], np.int32)
    cls_reqs = rng.integers(0, 5, (4, r)).astype(np.int32)
    return {"res": (totals, avail, mask, reqs, keys), "rows": rows,
            "overrides": (ov_idx, ov_av), "extra_mask": extra,
            "groups": ([slots] * s, [counts] * s),
            "classes": ([cls_idx] * s, [cls_reqs] * s)}


def _port_state(res, s):
    totals, avail, mask, reqs, keys = res
    t = torch.as_tensor

    def split(x, axis=0):
        return [t(np.array(b)) for b in
                np.split(np.asarray(x), s, axis=axis)]
    return hk.BeatState(split(totals), split(avail), split(mask),
                        [t(np.array(reqs)) for _ in range(s)],
                        split(keys, axis=1))


def _torch(xs):
    return None if xs is None else [torch.as_tensor(np.asarray(x))
                                    for x in xs]


def _port_kw(kw):
    return {k: (tuple(_torch(x) for x in v) if isinstance(v, tuple)
                else _torch(v)) for k, v in kw.items()}


def _same_state(model, port, fields):
    for f in fields:
        for x, y in zip(model[f], getattr(port, f)):
            np.testing.assert_array_equal(x, y.numpy()[:len(x)])


def _cat(xs, axis=0):
    return np.concatenate([np.asarray(x) for x in xs], axis=axis)


# -- one rank: the JAX package's single-device programs ---------------------------

@pytest.mark.parametrize("seed", [0, 1])
def test_model_equals_jax_full_rescore_and_dirty_rows(seed):
    case = _case(seed, 1, n_l=300)             # two node tiles
    totals, avail, mask, reqs, keys = case["res"]
    thr = SCALE // 2
    st = model_state(*case["res"], 1)
    model_rows(st, thr, rescore=True)
    np.testing.assert_array_equal(st["keys"][0], keys)
    rows = case["rows"]
    model_rows(st, thr, rows=rows)
    want = ref_hk.apply_dirty_rows(totals, avail, mask, keys, reqs,
                                   rows[0][0], rows[1][0], rows[2][0],
                                   rows[3][0], thr)
    for f, w in zip(("totals", "avail", "mask", "keys"), want):
        np.testing.assert_array_equal(st[f][0], np.asarray(w))
    port = _port_state(case["res"], 1)
    hk.beat_rows(port, thr, rows=tuple(_torch(x) for x in rows))
    _same_state(st, port, ("totals", "avail", "mask", "keys"))


@pytest.mark.parametrize("seed", [2, 3])
def test_model_equals_jax_class_install(seed):
    case = _case(seed, 1)
    totals, avail, mask, reqs, keys = case["res"]
    thr = SCALE // 2
    st = model_state(*case["res"], 1)
    cls = case["classes"]
    model_rows(st, thr, classes=cls)
    want = ref_hk.apply_dirty_classes(totals, avail, mask, keys, reqs,
                                      cls[0][0], cls[1][0], thr)
    np.testing.assert_array_equal(st["reqs"][0], np.asarray(want[0]))
    np.testing.assert_array_equal(st["keys"][0], np.asarray(want[1]))
    port = _port_state(case["res"], 1)
    hk.beat_rows(port, thr, classes=tuple(_torch(x) for x in cls))
    _same_state(st, port, ("reqs", "keys"))


@pytest.mark.parametrize("seed,require_available,em",
                         [(4, False, "random"), (5, True, "random"),
                          (6, False, "none")])
def test_model_equals_jax_fused_beat(seed, require_available, em):
    case = _case(seed, 1, n_l=300, em=em)
    totals, avail, mask, reqs, keys = case["res"]
    keys[1] = INF_KEY                          # an all-INF carried row
    thr = SCALE // 2
    kw = {k: case[k] for k in ("overrides", "extra_mask", "groups")}
    st = model_state(totals, avail, mask, reqs, keys, 1)
    model_rows(st, thr, **kw)
    alloc, inf, av_fin = model_scan(st, thr, require_available)
    packed, amin = model_tail(st, alloc, inf, av_fin)
    ov, groups = kw["overrides"], kw["groups"]
    want_p, want_a = ref_hk.fused_beat(
        totals, avail, mask, keys, reqs, groups[0][0], groups[1][0],
        kw["extra_mask"][0], ov[0][0], ov[1][0], thr,
        require_available=require_available)
    np.testing.assert_array_equal(packed, np.asarray(want_p))
    np.testing.assert_array_equal(amin, np.asarray(want_a))
    assert amin[1] == 0
    if em == "none":                           # nothing placeable
        assert (packed[:len(groups[0][0]), :-1] == 0).all()
    # the port: the wrappers (plain on the CPU), and fused_beat
    port = _port_state((totals, avail, mask, reqs, keys), 1)
    hk.beat_rows(port, thr, **_port_kw(kw))
    _same_state(st, port, ("avail_eff", "mask_eff", "group_reqs",
                           "group_counts"))
    g = len(groups[0][0])
    counts, av = hk.waterfill_scan(
        port.totals[0], port.avail_eff[0], port.mask_eff[0],
        port.group_reqs[0][:g], port.group_counts[0][:g], None, thr,
        require_available)
    n = totals.shape[0]
    got = hk.beat_tail(port, [counts[:, :n]], counts[:, n], [av])
    np.testing.assert_array_equal(got[0].numpy(), packed)
    np.testing.assert_array_equal(got[1].numpy(), amin)
    t = torch.as_tensor
    fused = hk.fused_beat(t(totals), t(avail), t(mask), t(keys), t(reqs),
                          t(groups[0][0]), t(groups[1][0]),
                          t(kw["extra_mask"][0]), t(ov[0][0]), t(ov[1][0]),
                          thr, require_available)
    np.testing.assert_array_equal(fused[0].numpy(), packed)
    np.testing.assert_array_equal(fused[1].numpy(), amin)


@pytest.mark.parametrize("r", [ROW_COLS, ROW_COLS + 3])
def test_model_equals_jax_at_the_staged_width(r):
    """Rows of exactly the columns the key CTAs stage (magic multipliers)
    and rows wider (the division), 11 class slots (not a multiple of the
    class block): the full rescore, the dirty rows and a class install of
    the model against the JAX programs and the port's plain versions."""
    case = _case(30 + r, 1, n_l=70, r=r, c=11, n_cls=9)
    totals, avail, mask, reqs, keys = case["res"]
    thr = SCALE // 2
    st = model_state(*case["res"], 1)
    model_rows(st, thr, rescore=True)
    np.testing.assert_array_equal(st["keys"][0], keys)
    assert (np.count_nonzero(reqs > 0, axis=1) > 32).any()
    assert keys_per_warp(1, 70, 11, r, wave=2) > 1      # warps of classes
    several = model_state(*case["res"], 1)
    model_rows(several, thr, rescore=True, wave=2)
    np.testing.assert_array_equal(several["keys"][0], keys)
    rows, cls = case["rows"], case["classes"]
    cls = ([np.array([2, 10, 11, 11], np.int32)], cls[1][:1])
    model_rows(st, thr, rows=rows)
    want = ref_hk.apply_dirty_rows(totals, avail, mask, keys, reqs,
                                   rows[0][0], rows[1][0], rows[2][0],
                                   rows[3][0], thr)
    for f, w in zip(("totals", "avail", "mask", "keys"), want):
        np.testing.assert_array_equal(st[f][0], np.asarray(w))
    model_rows(st, thr, classes=cls, wave=1)
    want = ref_hk.apply_dirty_classes(*(np.asarray(w) for w in want),
                                      reqs, cls[0][0], cls[1][0], thr)
    np.testing.assert_array_equal(st["reqs"][0], np.asarray(want[0]))
    np.testing.assert_array_equal(st["keys"][0], np.asarray(want[1]))
    port = _port_state(case["res"], 1)
    hk.beat_rows(port, thr, rows=tuple(_torch(x) for x in rows))
    hk.beat_rows(port, thr, classes=tuple(_torch(x) for x in cls))
    _same_state(st, port, ("totals", "avail", "mask", "keys", "reqs"))


# -- S ranks: the reference's ShardPlane on the virtual CPU devices ---------------

def _ref_plane(s, mode):
    pl = ref_sr.plane_for(s, mode)
    put = jax.device_put
    return pl, {"rows": lambda x: put(x, pl.sh_rows),
                "vec": lambda x: put(x, pl.sh_vec),
                "cols": lambda x: put(x, pl.sh_cols),
                "repl": lambda x: put(x, pl.sh_repl)}


@pytest.mark.parametrize("s,mode", MESHES)
def test_model_equals_jax_shard_plane(s, mode):
    """Every program of the reference's ShardPlane against the model and
    the port's plain versions, at S ranks: the full rescore, the dirty
    rows, a class install and the fused beat (with and without
    require_available)."""
    case = _case(10 + s, s, n_l=64 if s > 2 else 160)
    totals, avail, mask, reqs, keys = case["res"]
    thr = SCALE // 2
    pl, put = _ref_plane(s, mode)
    st = model_state(*case["res"], s)
    model_rows(st, thr, rescore=True)
    want = pl.full_rescore(put["rows"](totals), put["rows"](avail),
                           put["vec"](mask), put["repl"](reqs), thr)
    np.testing.assert_array_equal(_cat(st["keys"], 1), np.asarray(want))
    keys = np.array(want)
    port = _port_state((totals, avail, mask, reqs, keys), s)
    hk.beat_rows(port, thr, rescore=True)
    _same_state(st, port, ("keys",))

    rows = case["rows"]
    model_rows(st, thr, rows=rows)
    want = pl.apply_dirty_rows(
        put["rows"](totals), put["rows"](avail), put["vec"](mask),
        put["cols"](keys), put["repl"](reqs), put["vec"](_cat(rows[0])),
        put["rows"](_cat(rows[1])), put["rows"](_cat(rows[2])),
        put["vec"](_cat(rows[3])), thr)
    for f, w in zip(("totals", "avail", "mask"), want[:3]):
        np.testing.assert_array_equal(_cat(st[f]), np.asarray(w))
    np.testing.assert_array_equal(_cat(st["keys"], 1), np.asarray(want[3]))
    totals, avail, mask, keys = (np.array(w) for w in want)
    hk.beat_rows(port, thr, rows=tuple(_torch(x) for x in rows))
    _same_state(st, port, ("totals", "avail", "mask", "keys"))

    cls = case["classes"]
    model_rows(st, thr, classes=cls)
    want = pl.apply_dirty_classes(
        put["rows"](totals), put["rows"](avail), put["vec"](mask),
        put["cols"](keys), put["repl"](reqs), put["repl"](cls[0][0]),
        put["repl"](cls[1][0]), thr)
    np.testing.assert_array_equal(st["reqs"][0], np.asarray(want[0]))
    np.testing.assert_array_equal(_cat(st["keys"], 1), np.asarray(want[1]))
    reqs, keys = np.array(want[0]), np.array(want[1])
    hk.beat_rows(port, thr, classes=tuple(_torch(x) for x in cls))
    _same_state(st, port, ("reqs", "keys"))

    keys[1] = INF_KEY                          # an all-INF carried row
    for k, blk in enumerate(np.split(keys, s, axis=1)):
        st["keys"][k][:] = blk
        port.keys[k].copy_(torch.as_tensor(blk))
    ov, groups, em = case["overrides"], case["groups"], case["extra_mask"]
    for require_available in (False, True):
        model_rows(st, thr, overrides=ov, extra_mask=em, groups=groups)
        alloc, inf, av_fin = model_scan(st, thr, require_available)
        packed, amin = model_tail(st, alloc, inf, av_fin)
        want_p, want_a = pl.fused_beat(
            put["rows"](totals), put["rows"](avail), put["vec"](mask),
            put["cols"](keys), put["repl"](reqs), put["repl"](groups[0][0]),
            put["repl"](groups[1][0]), put["vec"](_cat(em)),
            put["vec"](_cat(ov[0])), put["rows"](_cat(ov[1])), thr,
            require_available=require_available)
        np.testing.assert_array_equal(packed, np.asarray(want_p))
        np.testing.assert_array_equal(amin, np.asarray(want_a))
        assert amin[1] == 0
        hk.beat_rows(port, thr, overrides=tuple(_torch(x) for x in ov),
                     extra_mask=_torch(em),
                     groups=tuple(_torch(x) for x in groups))
        _same_state(st, port, ("avail_eff", "mask_eff", "group_reqs",
                               "group_counts"))
        got = hk.beat_tail(port, _torch(alloc), torch.as_tensor(inf),
                           _torch(av_fin))
        np.testing.assert_array_equal(got[0].numpy(), packed)
        np.testing.assert_array_equal(got[1].numpy(), amin)


def test_model_argmin_ties_and_all_inf_rows():
    """The packed 64-bit min: an all-INF row gives 0, equal keys go to
    the lowest row, a key on a later rank wins only when smaller."""
    st = {"totals": [np.zeros((4, 1), np.int32)] * 2,
          "reqs": [np.zeros((3, 1), np.int32)] * 2,
          "mask_eff": [np.ones(4, bool)] * 2,
          "keys": [np.array([[INF_KEY] * 4, [9, 5, 5, 7], [50] * 4],
                            np.int32),
                   np.array([[INF_KEY] * 4, [5, 5, 1, 8], [-3, 50, 9, 9]],
                            np.int32)]}
    zero = [np.zeros((0, 4), np.int32)] * 2
    _, amin = model_tail(st, zero, np.zeros(0, np.int32),
                         [np.zeros((4, 1), np.int32)] * 2)
    np.testing.assert_array_equal(amin, [0, 6, 4])


# beat_tail's division: every request 1..2**15 at the int32 edges of the
# clamped avail
DIV_EDGES = [0, 1, 2, 3, (1 << 15) - 1, 1 << 15, (1 << 15) + 1, 1 << 16,
             (1 << 30) - 1, 1 << 30, (1 << 31) - 2, (1 << 31) - 1]


# the keys' division: the dividend (t - a + q) * SCALE wraps to any int32,
# the divisor is max(t, 1) of a row
KEY_DIVIDENDS = [-(1 << 31), -(1 << 31) + 1, -(1 << 30), -SCALE - 1, -SCALE,
                 -2, -1, 0, 1, 2, SCALE - 1, SCALE, (1 << 30) - 1,
                 (1 << 31) - 2, (1 << 31) - 1]
KEY_DIVISORS = [1, 2, 3, 1 << 15, (1 << 15) + 1, (1 << 31) - 1,
                *[(1 << p) + o for p in range(1, 31) for o in (-1, 0, 1)]]


@pytest.mark.parametrize("kind", ["budget", "key"])
def test_budget_division_is_floor_division(kind):
    """``budget``: ``fdiv(max(avail, 0), magic(q))`` equals ``//`` for
    every request q in 1..2**15 at the int32 edges of the dividend and at
    multiples of q around the budget cap, exactly.  ``key``: each row's
    divisor max(t, 1) as ``magic_of`` makes it (a double quotient,
    corrected) equals ``magic``, and ``fdiv`` of every int32 dividend
    (negative and wrapped ones, INT_MIN and INT_MAX) by it equals ``//``:
    divisors 1, 2, the powers of two and their neighbours, 2**15 and
    INT_MAX, with random ones."""
    rng = np.random.default_rng(22)
    if kind == "key":
        d = np.array(KEY_DIVISORS + list(rng.integers(1, 1 << 31, 2000)),
                     np.int64)
        m = magic_of(d)
        want_m, sh = magic(d)
        np.testing.assert_array_equal(m, want_m)
        assert (m < (1 << 32)).all()
        num = _i32(rng.integers(-(1 << 40), 1 << 40, 64) * SCALE)
        x = np.array(KEY_DIVIDENDS + list(num), np.int64)
        y = np.concatenate([x[None, :].repeat(len(d), 0),
                            d[:, None] * np.array([-2, -1, 1, 2])
                            + np.array([-1, 0, 0, 1])], axis=1)
        y = np.clip(y, -(1 << 31), (1 << 31) - 1)
        got = fdiv(y, m[:, None], sh[:, None].astype(np.int64))
        np.testing.assert_array_equal(got, y // d[:, None])
        return
    d = np.arange(1, (1 << 15) + 1, dtype=np.int64)
    m, sh = magic(d)
    assert (m < (1 << 32)).all() and (sh <= 46).all()
    x = np.array(DIV_EDGES + list(rng.integers(0, 1 << 31, 64)), np.int64)
    got = fdiv_nonneg(x[None, :], m[:, None], sh[:, None])
    np.testing.assert_array_equal(got, x[None, :] // d[:, None])
    k = np.array([1, 2, BUDGET_CAP - 1, BUDGET_CAP, BUDGET_CAP + 1],
                 np.int64)
    mult = np.concatenate([np.broadcast_to(k, (len(d), len(k))),
                           ((2**31 - 1) // d)[:, None]], axis=1)
    y = (d[:, None] * mult)[:, :, None] + np.array([-1, 0, 1])
    y = np.clip(y, 0, 2**31 - 1).reshape(len(d), -1)
    got = fdiv_nonneg(y, m[:, None], sh[:, None])
    np.testing.assert_array_equal(got, y // d[:, None])


def test_budget_model_equals_jax_at_the_division_edges():
    """The model's budgets (the magic multiplier) against the JAX fused
    beat's and the port's plain version at the division's edges: avail at
    the int32 edges and negative, requests 1..2**15 including powers of
    two and their neighbours, a class past COL_CAP positive columns,
    dead and infeasible rows; exact."""
    rng = np.random.default_rng(23)
    n, r = 256, 40
    avail = rng.choice(np.array(DIV_EDGES + [-1, -(1 << 31), -5000]),
                       size=(n, r)).astype(np.int32)
    avail[:, 1] = rng.integers(0, 1 << 31, n)
    totals = np.full((n, r), (1 << 31) - 1, np.int32)
    totals[rng.random((n, r)) < 0.03] = 7          # infeasible cells
    mask = rng.random(n) > 0.1
    qs = [1, 2, 3, 1 << 14, (1 << 14) + 1, (1 << 15) - 1, 1 << 15,
          *rng.integers(1, (1 << 15) + 1, 8)]
    reqs = np.zeros((len(qs) + 3, r), np.int32)
    for i, q in enumerate(qs):
        reqs[i, i % 2] = q                          # one or two columns
        if i % 3 == 0:
            reqs[i, 2 + i % 5] = qs[-1 - i]
    reqs[len(qs)] = 0                               # the zero class
    reqs[len(qs) + 1] = rng.integers(1, 1 << 15, r)  # past COL_CAP
    reqs[len(qs) + 2, 0] = 1 << 15
    keys = np.zeros((len(reqs), n), np.int32)
    packed, _ = ref_hk.fused_beat(
        totals, avail, mask, keys, reqs, np.zeros(1, np.int32),
        np.zeros(1, np.int32), np.ones(n, bool), np.array([n], np.int32),
        np.zeros((1, r), np.int32), SCALE // 2)
    want = np.asarray(packed)[1:, :-1]
    got = np.stack([model_budget(totals, avail, mask, q) for q in reqs])
    np.testing.assert_array_equal(got, want)
    plain = hk._budgets(torch.as_tensor(totals), torch.as_tensor(avail),
                        torch.as_tensor(mask), torch.as_tensor(reqs))
    np.testing.assert_array_equal(plain.numpy(), want)
    assert (want > 0).any() and (want == BUDGET_CAP).any()
    assert ((want > 0) & (want < BUDGET_CAP)).any()


# -- the engines: one beat with everything at once --------------------------------

@pytest.mark.parametrize("shards", [1, 4])
def test_engine_beat_with_rows_overrides_mask_and_a_fresh_class(shards):
    """A beat that stages dirty rows, overrides, a soft mask and a fresh
    class in one blob, through the port's single-device and sharded
    engines on the CPU, equal to the reference's engines."""
    tw = Twin(8, n_nodes=40, capacity=64)
    vecs = tw.requests(_specs(tw.rng, 4))
    counts = tw.rng.integers(1, 20, size=4).astype(np.int32)
    if shards == 1:
        ref, eng = RefDelta(tw.ref), PortDelta(tw.port, device="cpu")
    else:
        ref = RefSharded(tw.ref, shards, "two_level")
        eng = PortSharded(tw.port, shards, "two_level",
                          devices=["cpu"] * shards)
    _assert_beat_equal(ref, eng, vecs, eng.beat(vecs, counts),
                       ref.beat(vecs, counts))
    for _ in range(3):
        tw.mutate()
    fresh = tw.requests([{"CPU": 2, "memory": 3.0}])
    vecs = np.concatenate([vecs, fresh])
    counts = np.concatenate([counts, [9]]).astype(np.int32)
    ov = {1: np.array([-700, 5], np.int32), 33: np.array([40, 1], np.int32)}
    soft = tw.rng.random(tw.ref.arrays()[0].shape[0]) > 0.3
    kw = dict(overrides=ov, extra_mask=soft, require_available=True)
    got = eng.beat(vecs, counts, **kw)
    want = ref.beat(vecs, counts, **kw)
    assert eng.stats["delta_beats"] == 1
    assert eng.stats["classes_installed"] == 5
    _assert_beat_equal(ref, eng, vecs, got, want)


def test_blob_views_are_the_staged_fields():
    """The staged upload: every field at one offset in each rank's
    section, booleans as bytes at a word-aligned offset, sections of a
    multiple of 16 bytes; the views hold what was staged."""
    rng = np.random.default_rng(0)
    s = 3
    fields = {"slots": [np.arange(8, dtype=np.int32)] * s,
              "counts": [rng.integers(0, 9, 8).astype(np.int32)] * s,
              "idx": [rng.integers(0, 9, 5).astype(np.int32)
                      for _ in range(s)],
              "rows_totals": [rng.integers(0, 9, (5, 3)).astype(np.int32)
                              for _ in range(s)],
              "rows_mask": [rng.random(5) > 0.5 for _ in range(s)],
              "extra_mask": [rng.random(7) > 0.5 for _ in range(s)]}
    blob = BeatBlob(fields)
    assert blob.words % 4 == 0 and blob.host.shape == (s, blob.words)
    offsets = [o for o, _, _ in blob.layout.values()]
    assert offsets == sorted(offsets)
    dev = torch.from_numpy(blob.host.reshape(-1).copy())
    views = blob.views(list(dev.view(s, blob.words)))
    for name, parts in fields.items():
        for k, (want, got) in enumerate(zip(parts, views[name])):
            np.testing.assert_array_equal(got.numpy(), want)
            assert got.data_ptr() == views[name][0].data_ptr() + \
                k * 4 * blob.words
            assert got.data_ptr() % 4 == 0
    # the kernels take such views as they are (equally spaced)
    assert all(x is y for x, y in zip(hk.spaced(views["idx"]),
                                      views["idx"]))


def test_rank_table_is_rebuilt_only_when_a_resident_is_reallocated():
    """Delta beats update the residents in place, so the kernels' table
    of pointers is built once; a full resync reallocates them, and the
    next table holds the new pointers."""
    tw = Twin(9)
    vecs = tw.requests(_specs(tw.rng, 3))
    counts = np.array([4, 5, 6], np.int32)
    eng = PortDelta(tw.port, device="cpu")
    eng.beat(vecs, counts)
    builds = hk.rank_table.builds
    first = hk.resident_table(eng._st)
    assert hk.rank_table.builds == builds + 1
    ptrs = [t.data_ptr() for t in (*eng._st.totals, *eng._st.keys)]
    for _ in range(2):
        tw.mutate()
        eng.beat(vecs, counts)
    assert eng.stats["delta_beats"] >= 1
    assert [t.data_ptr() for t in (*eng._st.totals, *eng._st.keys)] == ptrs
    assert hk.resident_table(eng._st) is first
    assert hk.rank_table.builds == builds + 1
    old = eng._st                  # kept alive: its memory is not reused
    eng.beat(vecs, counts, spread_threshold=0.9)    # a new threshold
    assert eng.stats["full_rescores"] == 2 and eng._st is not old
    table = hk.resident_table(eng._st)
    assert hk.rank_table.builds == builds + 2
    st = eng._st
    assert table.tolist()[0][:5] == [x.data_ptr() for x in (
        st.totals[0], st.avail[0], st.mask[0], st.keys[0], st.reqs[0])]
    eng.beat(vecs, counts, spread_threshold=0.9)
    assert hk.resident_table(eng._st) is table


def test_wrapper_checks_once_a_layout_and_raises_on_a_new_one():
    """``rows_call``, the checks and C arguments of a launch, on a staged
    beat's views: a second call of the same layout is the same checked
    call (no check, no table); a changed shape or dtype, ranks that are
    not equally spaced, a rank on another device and a resident of
    another shape are new layouts, and their checks raise."""
    s, thr = 4, SCALE // 2
    case = _case(21, s)
    port = _port_state(case["res"], s)
    fields = {"slots": case["groups"][0], "counts": case["groups"][1],
              "idx": case["rows"][0], "rows_totals": case["rows"][1],
              "rows_avail": case["rows"][2], "rows_mask": case["rows"][3],
              "ov_idx": case["overrides"][0],
              "ov_avail": case["overrides"][1],
              "extra_mask": case["extra_mask"]}

    def staged(f, dev=None):
        blob = BeatBlob(f)
        if dev is None:
            dev = torch.from_numpy(blob.host.reshape(-1).copy())
        kw = hk.beat_inputs(blob.views(list(dev.view(s, blob.words))))
        kw.pop("classes")
        return kw, dev
    kw, upload = staged(fields)
    hk._ROW_CALLS.clear()
    first = hk.rows_call(port, thr, **kw)
    builds = hk.rank_table.builds
    assert hk.rows_call(port, thr, **kw) is first
    again, _ = staged(fields, upload)           # new views, one layout
    assert all(x is not y for x, y in zip(again["rows"][0], kw["rows"][0]))
    assert hk.rows_call(port, thr, **again) is first
    assert hk.rows_call(port, thr, rescore=True) is not first
    assert hk.rank_table.builds == builds and len(hk._ROW_CALLS) == 2
    wider = dict(fields, idx=[np.concatenate([i, [80] * 8]).astype(np.int32)
                              for i in fields["idx"]])
    with pytest.raises(ValueError, match="rows_totals must be"):
        hk.rows_call(port, thr, **dict(staged(wider)[0],
                                       rows=(staged(wider)[0]["rows"][0],
                                             *kw["rows"][1:])))
    rows = list(kw["rows"])
    rows[2] = [x.float() for x in rows[2]]
    with pytest.raises(ValueError, match="rows_avail must be"):
        hk.rows_call(port, thr, **dict(kw, rows=tuple(rows)))
    rows = list(kw["rows"])
    rows[1] = [x.clone() for x in rows[1]]
    with pytest.raises(ValueError, match="not equally spaced"):
        hk.rows_call(port, thr, **dict(kw, rows=tuple(rows)))
    em = list(kw["extra_mask"])
    em[-1] = em[-1].to("meta")
    with pytest.raises(ValueError, match="extra_mask must be"):
        hk.rows_call(port, thr, **dict(kw, extra_mask=em))
    port.keys[1] = port.keys[1][:8]
    with pytest.raises(ValueError, match="keys must be"):
        hk.rows_call(port, thr, **kw)


def test_cpu_wrappers_never_load_a_kernel_and_other_devices_raise():
    case = _case(20, 1)
    port = _port_state(case["res"], 1)
    loaded = dict(_build._LOADED)
    launches = (hk.beat_rows.launches, hk.beat_tail.launches)
    hk.beat_rows(port, SCALE // 2, rescore=True)
    assert _build._LOADED == loaded
    assert (hk.beat_rows.launches, hk.beat_tail.launches) == launches
    meta = hk.BeatState(*[[x.to("meta") for x in xs] for xs in (
        port.totals, port.avail, port.mask, port.reqs, port.keys)])
    with pytest.raises(ValueError, match="unsupported device"):
        hk.beat_rows(meta, SCALE // 2, rescore=True)
    with pytest.raises(ValueError, match="unsupported device"):
        hk.beat_tail(meta, [meta.totals[0][:0, :1]], meta.totals[0][:0, 0],
                     meta.avail)
