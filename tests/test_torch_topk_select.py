"""The top-k kernel's select, modelled in numpy and held to the JAX
function, bit for bit.

``ray_tpu_torch/ops/csrc/topk.cu`` does not sort a class's keys.  A row's
count depends on its position among them only through three order
statistics: it is placed where its key x <= K(k - 1), and gets the
remainder's + 1 where K(offset) <= x < K(offset + extra) (when the
window wraps, x >= K(offset) or x < K(offset + extra - k); at offset +
extra == k the window runs to K(k - 1)).  The kernel finds the three by
an MSB-first radix select: 4 passes of 8 bits over each key with its
sign bit flipped, a 256-bin histogram a pass, targets that share a
prefix sharing one histogram.  ``topk_model`` repeats that in numpy
(the keys from the port's plain key function) and runs against the JAX
package's ``schedule_grouped_topk_np`` (on the CPU, as its own tests run
it) and the port's plain version, on seeded problems whose counts are
chosen class by class to reach each edge of the rule.
"""

from fractions import Fraction

import jax
import numpy as np
import pytest
import torch

from ray_tpu.ops.locality_kernel import \
    schedule_grouped_topk_np as jax_topk_np
from ray_tpu_torch.common.config import Config as PortConfig
from ray_tpu_torch.ops.hybrid_kernel import _keys_one_req
from ray_tpu_torch.ops.locality_kernel import (_randint_offset,
                                               schedule_grouped_topk_np,
                                               topk_draws)

# the draws follow JAX's partitionable threefry (its default since 0.5)
jax.config.update("jax_threefry_partitionable", True)

INF = 2**31 - 1
BIG = 1 << 30
SCALE = 1 << 12
THREADS = 1024                      # topk.cu: a key a thread and register
DIGITS = (8, 8, 8, 8)               # topk.cu: the select's passes, MSB first


@pytest.fixture(autouse=True)
def _fresh_port_config():
    PortConfig.reset()
    yield
    PortConfig.reset()


def wrap(x):
    """int32 wrap of int64 values (the kernel's wadd/wsub/wmul)."""
    return (np.asarray(x, np.int64) + 2**31) % 2**32 - 2**31


def radix_select(keys, ranks):
    """The kernel's select: the keys of ``ranks`` (each below the number
    of keys) among ``keys`` (int32, padded as the kernel pads them with
    INF to E * 1024), by 4 passes of 8 bits, MSB first, over the key
    with its sign bit flipped.  Targets whose prefixes agree
    count into one histogram, and a key adds to at most one."""
    n = len(keys)
    pad = max(1, -(-n // THREADS)) * THREADS
    u = np.full(pad, INF ^ 0x80000000, np.uint64)
    u[:n] = (np.asarray(keys, np.int64) & 0xffffffff) ^ 0x80000000
    prefix = [0] * len(ranks)
    rank = list(ranks)
    shift = 32
    for p, bits in enumerate(DIGITS):
        top, shift = shift, shift - bits
        hists = {}
        for t in range(len(ranks)):
            if prefix[t] in hists:
                continue
            sel = (u >> np.uint64(top)) == prefix[t] if p else \
                np.ones(pad, bool)
            digits = (u[sel] >> np.uint64(shift)) & np.uint64(2**bits - 1)
            hists[prefix[t]] = np.bincount(digits.astype(np.int64),
                                           minlength=2**bits)
        for t in range(len(ranks)):
            h = hists[prefix[t]]
            cum = np.cumsum(h)
            d = int(np.searchsorted(cum, rank[t], side="right"))
            rank[t] -= int(cum[d - 1]) if d else 0
            prefix[t] = (prefix[t] << bits) | d
    return [int(wrap(np.int64(x) ^ 0x80000000)) for x in prefix]


def class_terms(keys, count, words, k_abs, num, den):
    """(nf, k, offset, base, extra) of one class, as the kernel forms
    them; k is None where no key is feasible."""
    nf = int((keys != INF).sum())
    if nf == 0:
        return nf, None, None, None, None
    k = max(-((-nf * num) // den), k_abs)
    k = min(max(k, 1), nf)
    offset = int(_randint_offset(torch.as_tensor(words),
                                 torch.tensor(k, dtype=torch.int32)))
    base = count // k
    return nf, k, offset, base, count - base * k


def topk_model(totals, avail, mask, reqs, counts, seed, rnd, group_masks,
               thr, k_abs, k_frac, extra_mask, trace=None):
    """The kernel's rule for a whole round: (counts (G, N+1), avail)."""
    frac = Fraction(k_frac).limit_denominator(1 << 16)
    num, den = frac.numerator, max(frac.denominator, 1)
    n, g = totals.shape[0], reqs.shape[0]
    live = mask.copy() if extra_mask is None else mask & extra_mask
    draws = topk_draws(seed, rnd, g)
    av = avail.astype(np.int64)
    out = np.zeros((g, n + 1), np.int32)
    t_tot = torch.as_tensor(totals)
    for gi in range(g):
        gm = live if group_masks is None else live & group_masks[gi]
        keys = _keys_one_req(t_tot, torch.as_tensor(av.astype(np.int32)),
                             torch.as_tensor(reqs[gi]), thr,
                             torch.as_tensor(gm)).numpy().astype(np.int64)
        count = int(counts[gi])
        nf, k, offset, base, extra = class_terms(keys, count, draws[gi],
                                                 k_abs, num, den)
        if trace is not None:
            trace.append((nf, k, offset, extra))
        if nf == 0:
            out[gi, n] = count
            continue
        end = offset + extra
        ranks = [k - 1] + ([offset] if extra else []) + \
            ([end if end < k else end - k] if extra and end != k else [])
        ks = radix_select(keys, ranks)
        placed = keys <= ks[0]
        if not extra:
            window = np.zeros(n, bool)
        elif end == k:
            window = keys >= ks[1]
        elif end < k:
            window = (keys >= ks[1]) & (keys < ks[2])
        else:
            window = (keys >= ks[1]) | (keys < ks[2])
        alloc = np.where(placed, wrap(base + window), 0)
        req = reqs[gi].astype(np.int64)
        pos = req > 0
        cap = np.where(pos[None, :], av // np.maximum(req, 1)[None, :],
                       BIG).min(axis=1) if pos.any() else np.full(n, BIG)
        consumed = np.minimum(alloc, np.clip(cap, 0, BIG))
        av = wrap(av - wrap(consumed[:, None] * req[None, :]))
        out[gi, :n] = alloc
    return out, av.astype(np.int32)


def _problem(seed, n, r, g):
    rng = np.random.default_rng(seed)
    totals = rng.integers(200, 5000, size=(n, r)).astype(np.int32)
    totals[rng.random(totals.shape) < 0.2] = 0
    avail = (totals * rng.random(totals.shape)).astype(np.int32)
    mask = rng.random(n) > 0.05
    reqs = rng.integers(0, 300, size=(g, r)).astype(np.int32)
    reqs[rng.random(reqs.shape) < 0.4] = 0
    counts = rng.integers(0, 5000, size=g).astype(np.int32)
    masks = rng.random((g, n)) > 0.1
    extra = rng.random(n) > 0.05
    return dict(totals=totals, avail=avail, mask=mask, reqs=reqs,
                counts=counts, group_masks=masks, extra_mask=extra)


def _choose_counts(p, seed, rnd, k_abs, k_frac, want):
    """Set each class's count so that its window is of kind ``want``
    ('none': extra 0; 'wrap': offset + extra > k; 'end': offset + extra
    == k), class by class on the model's running avail, where k allows."""
    for gi in range(p["reqs"].shape[0]):
        trace = []
        sub = {**p, "reqs": p["reqs"][:gi + 1],
               "counts": p["counts"][:gi + 1],
               "group_masks": p["group_masks"][:gi + 1]}
        topk_model(**_model_args(sub, seed, rnd, k_abs, k_frac), trace=trace)
        _nf, k, offset, _extra = trace[-1]
        if k is None:
            continue
        if want == "none":
            extra = 0
        elif want == "wrap" and offset >= 2:
            extra = k - offset + 1
        elif want == "end" and offset >= 1:
            extra = k - offset
        else:
            continue
        p["counts"][gi] = 3 * k + extra
    return p


def _model_args(p, seed, rnd, k_abs, k_frac, thr=SCALE // 2):
    return dict(totals=p["totals"], avail=p["avail"], mask=p["mask"],
                reqs=p["reqs"], counts=p["counts"], seed=seed, rnd=rnd,
                group_masks=p["group_masks"], thr=thr, k_abs=k_abs,
                k_frac=k_frac, extra_mask=p["extra_mask"])


def _edge(case):
    """(problem, seed, round, k_abs, k_frac, thr) of one edge of the rule."""
    seed, rnd, k_abs, k_frac, thr = 3, 11, 1, 0.25, SCALE // 2
    if case == "extra_zero":
        p = _choose_counts(_problem(1, 300, 4, 6), seed, rnd, k_abs, k_frac,
                           "none")
    elif case == "window_wraps":
        p = _choose_counts(_problem(2, 300, 4, 6), seed, rnd, k_abs, k_frac,
                           "wrap")
    elif case == "window_ends_at_k":
        p = _choose_counts(_problem(3, 300, 4, 6), seed, rnd, k_abs, k_frac,
                           "end")
    elif case == "k_is_nf":
        p, k_frac = _problem(4, 200, 4, 6), 1.0
    elif case == "k_is_one":
        p, k_frac = _problem(5, 200, 4, 6), 0.0
    elif case == "every_key_inf":
        p = _problem(6, 100, 3, 4)
        p["reqs"][:] = 100000                  # past every total
    elif case == "one_score_rows_decide":
        # thousands of rows with one key but for the row bits
        n = 3000
        p = _problem(7, n, 2, 5)
        p["totals"][:] = 4000
        p["avail"][:] = 4000
        p["mask"][:] = True
        p["extra_mask"][:] = True
        p["group_masks"][:] = True
        p["reqs"][:] = [[10, 0], [0, 7], [10, 7], [1, 1], [5, 5]]
        p["counts"][:] = [2999, 17, 40000, 5, 1234]
        k_frac = 0.37
    elif case == "negative_avail_past_the_avail_bit":
        # avail far below zero: the score field passes the avail bit
        p = _problem(8, 400, 3, 6)
        rows = np.arange(0, 400, 3)
        p["avail"][rows] = -(p["totals"][rows] * 8)
        p["reqs"][:, 0] = np.maximum(p["reqs"][:, 0], 1)
        thr = 0
    elif case == "one_digit_shared_by_every_key":
        # every key has the same top 24 bits: only the last pass decides
        n = 200
        p = _problem(9, n, 1, 4)
        p["totals"][:] = 4096
        p["avail"][:] = 4096
        p["mask"][:] = True
        p["extra_mask"][:] = True
        p["group_masks"][:] = True
        p["reqs"][:] = 1
        p["counts"][:] = [199, 1000, 3, 77]
        k_frac = 0.6
    else:
        raise KeyError(case)
    return p, seed, rnd, k_abs, k_frac, thr


EDGES = ["extra_zero", "window_wraps", "window_ends_at_k", "k_is_nf",
         "k_is_one", "every_key_inf", "one_score_rows_decide",
         "negative_avail_past_the_avail_bit", "one_digit_shared_by_every_key"]


@pytest.mark.parametrize("case", EDGES)
def test_select_model_equals_jax(case):
    """The model == the JAX function == the port's plain version, bit for
    bit, and each case reaches its edge."""
    p, seed, rnd, k_abs, k_frac, thr = _edge(case)
    trace = []
    got = topk_model(**_model_args(p, seed, rnd, k_abs, k_frac, thr),
                     trace=trace)
    args = (p["totals"], p["avail"], p["mask"], p["reqs"], p["counts"])
    kw = dict(group_masks=p["group_masks"], thr_fp=thr, k_abs=k_abs,
              k_frac=k_frac, extra_mask=p["extra_mask"])
    want = jax_topk_np(*args, seed=seed, round_index=rnd, **kw)
    plain = schedule_grouped_topk_np(*args, seed, rnd, device="cpu", **kw)
    for a, b, c in zip(got, want, plain):
        np.testing.assert_array_equal(a, np.asarray(b))
        np.testing.assert_array_equal(a, c)
    live = [t for t in trace if t[1] is not None]
    if case == "extra_zero":
        assert live and all(t[3] == 0 for t in live)
    if case == "window_wraps":
        assert any(t[2] + t[3] > t[1] for t in live)
    if case == "window_ends_at_k":
        assert any(t[3] and t[2] + t[3] == t[1] for t in live)
    if case == "k_is_nf":
        assert live and all(t[1] == t[0] for t in live)
    if case == "k_is_one":
        assert live and all(t[1] == 1 for t in live)
    if case == "every_key_inf":
        assert not live and (got[0][:, -1] == p["counts"]).all()
    if case == "one_score_rows_decide":
        assert all(t[0] == 3000 for t in trace)
    if case == "negative_avail_past_the_avail_bit":
        keys = _keys_one_req(torch.as_tensor(p["totals"]),
                             torch.as_tensor(p["avail"]),
                             torch.as_tensor(p["reqs"][0]), thr,
                             torch.ones(400, dtype=torch.bool)).numpy()
        fin = keys[keys != INF].astype(np.int64)
        assert (fin >= 1 << 28).any() or (fin < 0).any()


@pytest.mark.parametrize("seed", range(4))
def test_radix_select_is_the_sorted_order(seed):
    """The select gives the j-th smallest of the int32 keys (negative,
    past the avail bit, unique feasible keys, INF padding), for every
    target at once, including targets that share every prefix."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 3000))
    hi = rng.integers(-2**31, 2**31 - 1, size=n, dtype=np.int64)
    lo = rng.integers(0, 4, size=n) << 13
    keys = np.where(rng.random(n) < 0.5, hi, lo) & ~np.int64(8191)
    keys = wrap(keys | np.arange(n))                 # unique, as rows
    keys[rng.random(n) < 0.2] = INF
    order = np.sort(keys)
    nf = int((keys != INF).sum())
    for _ in range(20):
        ranks = list(rng.integers(0, max(nf, 1), size=3)) if nf else [0]
        got = radix_select(keys, ranks)
        assert got == [int(order[j]) for j in ranks]


def topk_plan(n, r, g):
    """topk.cu's plan(): the rows' totals, multipliers and avail (3 N R
    ints) in shared memory while they fit beside the histograms and the
    staged group blocks, else in a global scratch."""
    def up16(x):
        return (x + 15) & ~15
    group = 8 + 4 * r
    at = up16(4 * 256 * (2 + 3 * 3))
    if 3 * group * 4 <= 48 * 1024:
        at += up16(3 * group * 4)
    on_chip = at + 3 * up16(4 * n * r) <= 232448 - 256
    return "shared" if on_chip else "global"


# (n, r, g, layout): topk.cu's rule at the card tests' shapes
# (tests/test_torch_cuda.py holds each to the library)
TOPK_LAYOUT_RULE = [(16, 3, 4, "shared"), (77, 6, 9, "shared"),
                    (1000, 8, 64, "shared"), (1025, 5, 7, "shared"),
                    (2296, 8, 4, "shared"), (2297, 8, 4, "global"),
                    (8192, 16, 128, "global"), (8192, 64, 8, "global"),
                    (1000, 6000, 2, "global")]


@pytest.mark.parametrize("n,r,g,layout", TOPK_LAYOUT_RULE)
def test_topk_layout_rule(n, r, g, layout):
    assert topk_plan(n, r, g) == layout
