"""The row-sharded localized water-fill and autoscaler, held bit for bit
to the JAX package.

- ``schedule_grouped_localized_sharded_np`` at S = 2 / 4 / 8 flat and
  two-level against the reference's ``schedule_grouped_localized`` on
  the same rows: a preferred row on every rank, at each rank's first and
  last row, infeasible by totals, by the node mask and by the class
  mask, a class with no positive request, -1 and other negative rows,
  rows past N, and a preferred row whose avail runs short or below zero;
- ``schedule_grouped_localized_sharded_np`` and ``autoscale_sharded_np``
  against the reference's sharded wrappers on the 8 virtual CPU devices
  of ``tests/conftest.py``, with ``extra_mask``, with N not a multiple of
  S and with preferred rows past N (which clip to the reference's last
  padded row);
- the routes: the localized, top-k and autoscale host wrappers run the
  single-device function over every row on the first rank
  (``ShardPlane.call_gathered``), the plain wrapper runs shard-local, and
  ranks of a card with no GPU raise;
- what the reference's sharded programs move between ranks, from their
  compiled HLO.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from ray_tpu.ops.binpack_kernel import autoscale_sharded_np as ref_autoscale
from ray_tpu.ops.locality_kernel import schedule_grouped_localized as ref_loc
from ray_tpu.ops.locality_kernel import \
    schedule_grouped_localized_sharded_np as ref_loc_sharded
from ray_tpu_torch.common.config import Config as PortConfig
from ray_tpu_torch.ops import binpack_kernel as bk
from ray_tpu_torch.ops import locality_kernel as lk
from ray_tpu_torch.ops import shard_reduce as sr
from test_torch_shard_scan import SCALE

MESHES = [(2, "flat"), (2, "two_level"), (4, "flat"), (4, "two_level"),
          (8, "flat"), (8, "two_level")]
N, R = 64, 4


@pytest.fixture(autouse=True)
def _fresh_port_config():
    PortConfig.reset()
    yield
    PortConfig.reset()


def _cpu(n):
    return ["cpu"] * n


def localized_case(seed, s, n=N, r=R):
    """Rows and classes whose preferred rows cover every edge on a mesh
    of ``s`` ranks of n / s rows: for each rank a class preferring its
    first row and one its last, then classes preferring a row that is
    infeasible by totals, by the node mask and by the class mask, a
    class with no positive request, -1, -7, N and 4 N, a row whose avail
    covers 2 of 40 tasks, and one whose avail is below zero, beside a few
    random ones.  Returns (totals, avail, mask, reqs, counts, gmask,
    prefs)."""
    rng = np.random.default_rng(seed)
    n_l = n // s
    totals = rng.integers(2000, 1 << 15, size=(n, r)).astype(np.int32)
    totals[rng.random(totals.shape) < 0.15] = 0
    avail = (totals * rng.random(totals.shape)).astype(np.int32)
    mask = rng.random(n) > 0.05
    edges = [k * n_l + off for k in range(s) for off in (0, n_l - 1)]
    inner = [i for i in range(n) if i % n_l not in (0, n_l - 1)]
    rows = list(rng.choice(inner, size=6, replace=False))
    prefs = edges + rows[:6] + [-1, -7, n, 4 * n] + \
        list(rng.integers(0, n, size=3))
    g = len(prefs)
    reqs = rng.integers(0, 900, size=(g, r)).astype(np.int32)
    reqs[rng.random(reqs.shape) < 0.3] = 0
    reqs[:, 0] = np.maximum(reqs[:, 0], 1)          # a positive column
    counts = rng.integers(1, 60, size=g).astype(np.int32)
    gmask = rng.random((g, n)) > 0.1
    for gi, p in enumerate(edges):                  # feasible edge rows
        mask[p] = True
        gmask[gi, p] = True
        totals[p] = np.maximum(totals[p], reqs[gi])
    base = len(edges)
    for gi, p in enumerate(rows[:6], start=base):
        mask[p] = True
        gmask[gi, p] = True
        totals[p] = np.maximum(totals[p], reqs[gi])
    t_row, m_row, g_row, z_row, short_row, neg_row = rows[:6]
    totals[t_row, 0] = reqs[base, 0] - 1            # infeasible by totals
    avail[t_row] = np.minimum(avail[t_row], totals[t_row])
    mask[m_row] = False                             # by the node mask
    gmask[base + 2, g_row] = False                  # by the class mask
    reqs[base + 3] = 0                              # no positive request
    counts[base + 4] = 40                           # avail covers 2 of 40
    totals[short_row] = np.maximum(totals[short_row], 40 * reqs[base + 4])
    avail[short_row] = totals[short_row]
    avail[short_row, 0] = 2 * reqs[base + 4, 0] + reqs[base + 4, 0] // 2
    avail[neg_row] = -(totals[neg_row] // 3)        # below zero
    return (totals, avail, mask, reqs, counts, gmask,
            np.asarray(prefs, np.int32))


def _ref_single(totals, avail, mask, reqs, counts, gmask, prefs, thr):
    counts_, av = ref_loc(
        jnp.asarray(totals), jnp.asarray(avail), jnp.asarray(mask),
        jnp.asarray(reqs), jnp.asarray(counts), jnp.asarray(gmask),
        jnp.asarray(prefs), jnp.int32(thr))
    return np.asarray(counts_), np.asarray(av)


def _same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


# -- the localized wrapper on every edge ------------------------------------

def _wrapper(s, mode, totals, avail, mask, reqs, counts, gmask, prefs, thr):
    return lk.schedule_grouped_localized_sharded_np(
        totals, avail, mask, reqs, counts, prefs, gmask, thr_fp=thr,
        n_shards=s, reduce_mode=mode, devices=_cpu(s))


@pytest.mark.parametrize("s,mode", MESHES)
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_localized_wrapper_on_every_edge_equals_the_reference(s, mode,
                                                              seed):
    case = localized_case(seed, s)
    want = _ref_single(*case, SCALE // 2)
    _same(_wrapper(s, mode, *case, SCALE // 2), want)
    counts, prefs, n_l = case[4], case[6], N // s
    # every rank's first and last row took its whole class
    for gi in range(2 * s):
        assert want[0][gi, prefs[gi]] >= counts[gi]
        assert prefs[gi] % n_l in (0, n_l - 1)


def test_the_edges_do_what_the_reference_does():
    """Each edge class at S = 4, row by row: the infeasible rows take
    nothing and their classes water-fill; the zero-request class queues
    whole on its row and consumes nothing; the short row gives what its
    avail allows and still takes the whole class; -1, -7 place nothing
    there; N and 4 N clip to row N - 1 (no padding here)."""
    s = 4
    totals, avail, mask, reqs, counts, gmask, prefs = localized_case(3, s)
    want, post = _ref_single(totals, avail, mask, reqs, counts, gmask,
                             prefs, SCALE // 2)
    _same(_wrapper(s, "two_level", totals, avail, mask, reqs, counts, gmask,
                   prefs, SCALE // 2), (want, post))
    base = 2 * s
    for gi in range(base, base + 3):                # infeasible rows
        assert want[gi, prefs[gi]] == 0
        assert want[gi].sum() == counts[gi]
    z = base + 3                                    # no positive request
    assert want[z, prefs[z]] == counts[z] and want[z].sum() == counts[z]
    short = base + 4                                # 2 of 40 consumed
    assert want[short, prefs[short]] == 40
    p = prefs[short]
    np.testing.assert_array_equal(avail[p] - post[p], 2 * reqs[short])
    neg = base + 5                                  # avail below zero
    assert want[neg, prefs[neg]] == counts[neg]
    for gi in range(base + 6, base + 10):           # -1, -7, N, 4N
        assert want[gi].sum() == counts[gi]


# -- the wrappers against the reference's sharded wrappers -------------------

@pytest.mark.parametrize("s,mode", [(1, "auto"), *MESHES])
@pytest.mark.parametrize("n", [64, 61])
def test_localized_wrapper_equals_the_reference(s, mode, n):
    """N a multiple of S and not (the rows pad with mask-False rows),
    with and without ``extra_mask``; the preferred rows past N clip to
    the last padded row, as the reference's sharded wrapper pads before
    its jit and leaves ``pref_rows`` as they are."""
    totals, avail, mask, reqs, counts, gmask, prefs = localized_case(
        8 + s, 8 if s == 1 else s)
    totals, avail, mask, gmask = totals[:n], avail[:n], mask[:n], \
        gmask[:, :n]
    prefs = np.where(prefs >= n, n + (prefs % 3), prefs).astype(np.int32)
    em = np.random.default_rng(s).random(n) > 0.1
    for extra in (None, em):
        got = lk.schedule_grouped_localized_sharded_np(
            totals, avail, mask, reqs, counts, prefs, gmask,
            extra_mask=extra, n_shards=s, reduce_mode=mode, devices=_cpu(8))
        _same(got, ref_loc_sharded(totals, avail, mask, reqs, counts, prefs,
                                   gmask, extra_mask=extra, n_shards=s,
                                   reduce_mode=mode))


def test_rows_past_n_clip_to_a_padded_row():
    """61 rows on 4 ranks: 3 padded rows.  A class preferring row N
    clips to the last padded row (mask False) and water-fills; without
    padding (64 rows) the same class's row clips to N - 1 and takes it."""
    s = 4
    totals, avail, mask, reqs, counts, gmask, _ = localized_case(9, s)
    g = reqs.shape[0]
    for n in (61, 64):
        prefs = np.full(g, n, np.int32)
        t, a, m, gm = totals[:n], avail[:n], mask[:n].copy(), gmask[:, :n]
        m[n - 1] = True
        gm = gm.copy()
        gm[:, n - 1] = True
        got = lk.schedule_grouped_localized_sharded_np(
            t, a, m, reqs, counts, prefs, gm, n_shards=s, devices=_cpu(s))
        _same(got, ref_loc_sharded(t, a, m, reqs, counts, prefs, gm,
                                   n_shards=s))
        feasible = (np.where(reqs > 0, t[n - 1] >= reqs, True).all(axis=1))
        took = got[0][:, n - 1] >= counts
        if n == 61:                                 # no class prefers
            _same(got, ref_loc_sharded(t, a, m, reqs, counts,
                                       np.full(g, -1, np.int32), gm,
                                       n_shards=s))
        else:
            np.testing.assert_array_equal(took[feasible], True)


@pytest.mark.parametrize("s,mode", [(2, "flat"), (4, "two_level"),
                                    (8, "flat"), (8, "two_level")])
@pytest.mark.parametrize("n", [64, 61])
def test_autoscale_wrapper_equals_the_reference(s, mode, n):
    """Launches, fit counts, unmet and new avail equal the reference's
    sharded wrapper, with and without ``extra_mask``, and the
    single-device call."""
    rng = np.random.default_rng(20 + s)
    totals = rng.integers(0, 40, size=(n, R)).astype(np.int32)
    totals[rng.random(totals.shape) < 0.2] = 0
    avail = (totals * rng.random(totals.shape)).astype(np.int32)
    mask = rng.random(n) > 0.1
    reqs = rng.integers(0, 6, size=(7, R)).astype(np.int32)
    reqs[rng.random(reqs.shape) < 0.4] = 0
    reqs[3] = 0                                     # a zero-request class
    counts = rng.integers(20, 200, size=7).astype(np.int32)
    caps = rng.integers(4, 64, size=(3, R)).astype(np.int32)
    quotas = np.array([6, 0, 9], np.int32)
    em = rng.random(n) > 0.2
    for extra in (None, em):
        got = bk.autoscale_sharded_np(totals, avail, mask, reqs, counts,
                                      caps, quotas, extra, n_shards=s,
                                      reduce_mode=mode, devices=_cpu(8))
        want = ref_autoscale(totals, avail, mask, reqs, counts, caps,
                             quotas, extra, n_shards=s, reduce_mode=mode)
        _same(got, want)
        assert want[1][:, -1].sum() > 0            # the loop had work
    _same(got, bk.autoscale_np(totals, avail, mask, reqs, counts, caps,
                               quotas, em, device="cpu"))


# -- the routes ------------------------------------------------------------------

def test_host_wrappers_gather_and_the_plain_one_does_not(monkeypatch):
    """On 4 CPU ranks the localized, top-k and autoscale wrappers each make
    one ``call_gathered`` call (host arrays in and out: the single-device
    function over every row on the first rank); the plain wrapper runs
    shard-local and makes none.  Each still equals the reference."""
    from ray_tpu.ops.hybrid_kernel import \
        schedule_grouped_sharded_np as ref_plain
    from ray_tpu.ops.locality_kernel import \
        schedule_grouped_topk_sharded_np as ref_topk
    from ray_tpu_torch.ops import hybrid_kernel as hk
    calls = []
    real = sr.ShardPlane.call_gathered

    def gathered(self, fn, *args):
        calls.append(fn.__name__)
        return real(self, fn, *args)

    monkeypatch.setattr(sr.ShardPlane, "call_gathered", gathered)
    s = 4
    totals, avail, mask, reqs, counts, gmask, prefs = localized_case(7, s)
    _same(lk.schedule_grouped_localized_sharded_np(
        totals, avail, mask, reqs, counts, prefs, gmask, n_shards=s,
        devices=_cpu(s)),
        ref_loc_sharded(totals, avail, mask, reqs, counts, prefs, gmask,
                        n_shards=s))
    caps = np.full((2, R), 30000, np.int32)
    quotas = np.array([3, 4], np.int32)
    _same(bk.autoscale_sharded_np(totals, avail, mask, reqs, counts, caps,
                                  quotas, n_shards=s, devices=_cpu(s)),
          ref_autoscale(totals, avail, mask, reqs, counts, caps, quotas,
                        n_shards=s))
    _same(lk.schedule_grouped_topk_sharded_np(
        totals, avail, mask, reqs, counts, 7, 1, gmask, n_shards=s,
        devices=_cpu(s)),
        ref_topk(totals, avail, mask, reqs, counts, 7, 1, gmask,
                 n_shards=s))
    assert calls == ["schedule_grouped_localized", "autoscale",
                     "schedule_grouped_topk"]
    _same(hk.schedule_grouped_sharded_np(totals, avail, mask, reqs, counts,
                                         gmask, n_shards=s,
                                         devices=_cpu(s)),
          ref_plain(totals, avail, mask, reqs, counts, gmask, n_shards=s))
    assert len(calls) == 3


@pytest.mark.parametrize("wrapper", ["localized", "autoscale"])
def test_one_card_mesh_without_a_gpu_raises(wrapper):
    """No GPU: the wrappers on ranks of ``cuda:0`` raise; nothing reroutes
    to the CPU."""
    totals, avail, mask, reqs, counts, gmask, prefs = localized_case(1, 2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        if wrapper == "localized":
            lk.schedule_grouped_localized_sharded_np(
                totals, avail, mask, reqs, counts, prefs, gmask,
                n_shards=2, devices=["cuda:0"] * 2)
        else:
            bk.autoscale_sharded_np(
                totals, avail, mask, reqs, counts,
                np.full((2, R), 100, np.int32), np.array([1, 1], np.int32),
                n_shards=2, devices=["cuda:0"] * 2)


# -- what the reference's sharded programs move between ranks ---------------

def _collectives(fn, out_shardings, *args):
    """The shapes of the all-gathers and all-reduces in ``fn``'s compiled
    program, its arguments placed as ``args`` ((shape, dtype, sharding)
    or a concrete value)."""
    import re
    lowered = jax.jit(fn, out_shardings=out_shardings).lower(*(
        jax.ShapeDtypeStruct(a[0], a[1], sharding=a[2])
        if isinstance(a, tuple) else a for a in args))
    lines = lowered.compile().as_text().splitlines()

    def shapes(op):
        return sorted(re.search(rf"= (.*?) {op}", ln).group(1).split("{")[0]
                      for ln in lines if re.search(rf"\b{op}(-start)?\(", ln))
    return shapes("all-gather"), shapes("all-reduce")


def test_reference_programs_keep_rows_sharded():
    """The reference's three wrappers' programs at N = 1024, R = 8, G = 16
    on 4 of the conftest's CPU devices (its own ``gspmd_plane``
    shardings): totals and avail stay row-sharded and the per-class sums
    are all-reduces of scalars.  What crosses ranks as a gather: (N,) per
    row vectors (autoscale: 3 of s32[N] and 2 of s32[S]; top-k: 2 of
    s32[N], its sort's keys), and in the localized program also avail
    (N, R) and the mask (N,), which the dynamic index of the preferred
    row makes.  The port's host wrappers gather their rows onto the first
    rank instead (``ShardPlane.call_gathered``): they take host arrays,
    so a row-sharded placement would move the same bytes."""
    from ray_tpu.ops import shard_reduce as ref_sr
    from ray_tpu.ops.binpack_kernel import autoscale as ref_auto
    from ray_tpu.ops.locality_kernel import schedule_grouped_topk as ref_tk
    n, r, g, k = 1024, 8, 16, 3
    pl = ref_sr.gspmd_plane(4, "auto")
    i32 = jnp.int32
    rows = ((n, r), i32, pl.sh_rows)
    common = (rows, rows, ((n,), bool, pl.sh_vec), ((g, r), i32, pl.sh_repl),
              ((g,), i32, pl.sh_repl))
    gm = ((g, n), bool, pl.sh_cols)
    loc = _collectives(ref_loc, (pl.sh_repl, pl.sh_rows), *common, gm,
                       ((g,), i32, pl.sh_repl), jnp.int32(SCALE // 2))
    auto = _collectives(ref_auto, (pl.sh_repl,) * 3 + (pl.sh_rows,),
                        *common, ((k, r), i32, pl.sh_repl),
                        ((k,), i32, pl.sh_repl))
    topk = _collectives(ref_tk, (pl.sh_repl, pl.sh_rows), *common, gm,
                        jnp.int32(SCALE // 2), jnp.int32(1), jnp.int32(1),
                        jnp.int32(4), jax.random.PRNGKey(0))
    assert auto[0] == ["s32[1024]"] * 3 + ["s32[4]"] * 2
    assert topk[0] == ["s32[1024]"] * 2
    assert loc[0] == sorted(auto[0] + ["s32[1024,8]", "pred[1024]"] * 2)
    for gathers, reduces in (loc, auto, topk):
        assert reduces and set(reduces) == {"s32[]"}
