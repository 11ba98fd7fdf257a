"""The port's CUDA kernels on the card (marker ``cuda``).

Each test needs a GPU and skips without one; on the GPU machine run

    python -m pytest tests/test_torch_cuda.py -q

The kernels are held against their plain PyTorch versions (and the
scheduler against the JAX reference on the CPU) at small shapes:
``waterfill_scan`` bit for bit, ``flash_attention`` within the stated
tolerances.  The top-k, bundle, pull and broadcast kernels are also held
to the JAX functions, bit for bit, at every shape and at the edge
problems their plain versions are pinned to in ``test_torch_topk.py``
and ``test_torch_dataplane.py``.  ``chip_smoke.py`` repeats this at the main
paths' shapes."""

import numpy as np
import pytest
import torch

from ray_tpu_torch.common.config import Config as PortConfig
# importing test_torch_topk also switches JAX to its partitionable
# threefry, whose draws the port's top-k reproduces
from test_torch_dataplane import (BROADCAST_EDGES, BUNDLE_EDGES, PULL_EDGES,
                                  _broadcast_edge, _bundle_edge, _pull_edge)
from test_torch_dataplane_chain import (FANOUT_RULE, LAYOUT_RULE, LIST_CAP,
                                        fanout_plan)
from test_torch_dataplane_chain import plan as bundle_plan_model
# csrc/beat.cu's beat_rows grid: dirty lanes a lane CTA, rows an eff CTA,
# rows and classes a key CTA, a row's columns staged on chip
from test_torch_beat_rest import (EFF_ROWS, KEY_CLS, KEY_ROWS, LANES,
                                  ROW_COLS, keys_per_warp)
from test_torch_topk import TOPK_EDGES
from test_torch_topk_select import EDGES as SELECT_EDGES
from test_torch_topk_select import (TOPK_LAYOUT_RULE, _choose_counts,
                                    _edge, topk_model, topk_plan)

pytestmark = pytest.mark.cuda

SCALE = 1 << 12


@pytest.fixture(autouse=True)
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    PortConfig.reset()
    yield
    PortConfig.reset()


def _problem(seed, n, r, g, neg=True):
    rng = np.random.default_rng(seed)
    totals = rng.integers(0, 1 << 17, size=(n, r)).astype(np.int32)
    totals[rng.random(totals.shape) < 0.25] = 0
    avail = (totals * rng.random(totals.shape)).astype(np.int32)
    if neg:
        rows = rng.random(n) < 0.05
        avail[rows] = -(totals[rows] * rng.random((int(rows.sum()), r))
                        ).astype(np.int32)
    mask = rng.random(n) > 0.05
    reqs = rng.integers(0, 3000, size=(g, r)).astype(np.int32)
    reqs[rng.random(reqs.shape) < 0.5] = 0
    counts = rng.integers(0, 20000, size=g).astype(np.int32)
    masks = rng.random((g, n)) > 0.1
    if g >= 3:
        reqs[0] = 0                     # the empty request
        counts[1] = 0                   # a padding row
        masks[2] = False                # an all-masked class
    return totals, avail, mask, reqs, counts, masks


@pytest.mark.parametrize("n,r,g", [(1, 1, 1), (77, 6, 9), (1000, 8, 64),
                                   (4097, 16, 20), (8192, 16, 8),
                                   # 16 CTAs: 8 cannot hold the rows
                                   (8192, 32, 4),
                                   # 16 cannot either: the rows spill
                                   (8192, 64, 4), (4096, 128, 3),
                                   (1024, 512, 3)])
@pytest.mark.parametrize("thr", [0, SCALE // 2, 2 * SCALE + 1])
@pytest.mark.parametrize("require_available", [False, True])
def test_waterfill_kernel_bit_exact(n, r, g, thr, require_available):
    from ray_tpu_torch.ops import hybrid_kernel as hk
    arrays = _problem(n + g, n, r, g)
    if r > 32:
        # requests in the first and last 6 columns only: rows stay
        # feasible, and the last ones lie past what shared memory holds
        arrays[3][:, 6:r - 6] = 0
    dev = [torch.as_tensor(a, device="cuda") for a in arrays]
    before = hk.waterfill_scan.launches
    kc, ka = hk.waterfill_scan(*dev, thr, require_available)
    assert hk.waterfill_scan.launches == before + 1
    pc, pa = hk.waterfill_scan_plain(*dev, thr, require_available)
    assert torch.equal(kc, pc) and torch.equal(ka, pa)
    cc, ca = hk.waterfill_scan(*[torch.as_tensor(a) for a in arrays], thr,
                               require_available)
    assert torch.equal(kc.cpu(), cc) and torch.equal(ka.cpu(), ca)
    nm = hk.waterfill_scan(*dev[:5], None, thr, require_available)
    pm = hk.waterfill_scan_plain(*dev[:5], None, thr, require_available)
    assert torch.equal(nm[0], pm[0]) and torch.equal(nm[1], pm[1])


def _limit_case(case):
    """The contract's limit (8192 nodes x 16 resources), 16 classes."""
    arrays = list(_problem(8192 + 16, 8192, 16, 16))
    thr, require_available = SCALE // 2, False
    if case == "require_available":
        require_available = True
    elif case == "first_fit":
        # the autoscaler's first-fit threshold with its fit semantics
        thr, require_available = 2 * SCALE + 1, True
    else:
        # counts far above capacity with a threshold past 2*SCALE: lp1 * t
        # wraps below zero on the large rows at every level, so no level
        # in [0, 2*SCALE] suffices and the search answers 2*SCALE + 1
        rng = np.random.default_rng(5)
        totals = rng.integers(110_000, (1 << 17) + 1,
                              size=(8192, 16)).astype(np.int32)
        arrays[0], arrays[1] = totals, totals.copy()
        arrays[4] = np.full(16, 2**30, np.int32)
        thr = 5 * SCALE
    return arrays, thr, require_available


@pytest.mark.parametrize("case", ["require_available", "first_fit",
                                  "no_level_suffices"])
def test_waterfill_kernel_at_the_node_limit(case):
    from ray_tpu_torch.ops import hybrid_kernel as hk
    arrays, thr, require_available = _limit_case(case)
    dev = [torch.as_tensor(a, device="cuda") for a in arrays]
    kc, ka = hk.waterfill_scan(*dev, thr, require_available)
    assert hk.waterfill_scan.last_layout["cluster"] > 1   # a real cluster
    pc, pa = hk.waterfill_scan_plain(*dev, thr, require_available)
    assert torch.equal(kc, pc) and torch.equal(ka, pa)
    if case == "no_level_suffices":
        # capacity exists (a threshold below 2*SCALE consumes some), yet
        # no slot is counted at any level: nothing is consumed
        assert torch.equal(ka, dev[1])
        assert not torch.equal(hk.waterfill_scan(*dev, SCALE // 2)[1], dev[1])


@pytest.mark.parametrize("n, r, cluster, threads, spills", [
    (1, 16, 1, 32, False), (100, 8, 1, 128, False),
    (1000, 8, 8, 128, False), (1024, 16, 8, 128, False),
    (4000, 16, 8, 512, False), (8192, 16, 8, 1024, False),
    (8192, 32, 16, 512, False), (8192, 64, 16, 512, True),
    (1024, 512, 16, 64, True), (64, 8192, 16, 32, True),
    (8192, 6000, 16, 512, True)])
def test_waterfill_layout_rule(n, r, cluster, threads, spills):
    """The launch the kernel reports for (N, R) on an H100 (227 KB of
    shared memory per CTA): one thread per row, 16 CTAs only where 8
    cannot hold the rows, past that the rows spill, and past R = 5743
    the class arrays go to global scratch (one copy per CTA)."""
    from ray_tpu_torch.ops import hybrid_kernel as hk
    arrays = _problem(n, n, r, 2)
    hk.waterfill_scan(*[torch.as_tensor(a, device="cuda") for a in arrays],
                      0)
    lay = hk.waterfill_scan.last_layout
    assert (lay["cluster"], lay["threads"]) == (cluster, threads)
    assert (lay["shared_cols"] < r) == spills
    assert lay["u1_cols"] == (min(r, 8) if spills else r)
    assert lay["scratch_ints"] == (cluster * 8 * r if r > 5743 else 0)


@pytest.mark.parametrize("n,r,g", [(64, 8192, 4), (8192, 6000, 2)])
def test_waterfill_kernel_past_5743_resources(n, r, g):
    """More resource kinds than one CTA's shared memory holds class arrays
    for: bit-exact against the plain version.  Each (N, R) array is made
    once on the card (8192 x 6000 x 4 B = 197 MB) and shared by both."""
    from ray_tpu_torch.ops import hybrid_kernel as hk
    rng = np.random.default_rng(r)
    totals = torch.randint(0, 1 << 17, (n, r), dtype=torch.int32,
                           device="cuda")
    avail = (totals.double() * torch.rand((n, r), device="cuda",
                                          dtype=torch.float64)).int()
    mask = torch.as_tensor(rng.random(n) > 0.05, device="cuda")
    reqs = np.zeros((g, r), np.int32)
    for gi in range(g):         # a few requested kinds, some past 5743
        cols = rng.choice(r, size=4, replace=False)
        reqs[gi, cols] = rng.integers(1, 3000, size=4)
    reqs[-1, r - 1] = 500
    counts = torch.as_tensor(rng.integers(1, 20000, size=g).astype(np.int32),
                             device="cuda")
    masks = torch.as_tensor(rng.random((g, n)) > 0.1, device="cuda")
    reqs = torch.as_tensor(reqs, device="cuda")
    thr = SCALE // 2
    kc, ka = hk.waterfill_scan(totals, avail, mask, reqs, counts, masks, thr)
    assert hk.waterfill_scan.last_layout["scratch_ints"] > 0
    pc, pa = hk.waterfill_scan_plain(totals, avail, mask, reqs, counts,
                                     masks, thr)
    assert torch.equal(kc, pc) and torch.equal(ka, pa)
    assert int(kc[:, :n].sum()) > 0


def test_fused_beat_wide_on_card_equals_cpu():
    """A beat at the node limit with 64 resource kinds (rows spill)."""
    from ray_tpu_torch.ops import hybrid_kernel as hk
    rng = np.random.default_rng(4)
    n, r, c = 8192, 64, 8
    totals, avail, mask, reqs, _, _ = _problem(4, n, r, c, neg=False)
    reqs[:, 10:54] = 0                  # columns 54.. lie past shared memory
    reqs[:, 0] = np.maximum(reqs[:, 0], 1)
    keys = hk.full_rescore(*[torch.as_tensor(a) for a in (
        totals, avail, mask, reqs)], SCALE // 2).numpy()
    slots = np.arange(c, dtype=np.int32)
    counts = rng.integers(0, 50000, size=c).astype(np.int32)
    extra = rng.random(n) > 0.1
    ov_idx = np.array([3, 7000, n, n], np.int32)
    ov_av = rng.integers(-9000, 9000, size=(4, r)).astype(np.int32)
    args = (totals, avail, mask, keys, reqs, slots, counts, extra, ov_idx,
            ov_av)
    got = hk.fused_beat(*[torch.as_tensor(a, device="cuda") for a in args],
                        SCALE // 2)
    assert hk.waterfill_scan.last_layout["shared_cols"] < r
    want = hk.fused_beat(*[torch.as_tensor(a) for a in args], SCALE // 2)
    assert torch.equal(got[0].cpu(), want[0])
    assert torch.equal(got[1].cpu(), want[1])
    assert int(want[0][:c, :n].sum()) > 0


def test_waterfill_rejects_what_the_kernel_does_not_take():
    from ray_tpu_torch.ops import hybrid_kernel as hk
    arrays = _problem(0, 64, 4, 3)
    dev = [torch.as_tensor(a, device="cuda") for a in arrays]
    with pytest.raises(ValueError, match="totals must be"):
        hk.waterfill_scan(dev[0].long(), *dev[1:], 0)
    with pytest.raises(ValueError, match="nodes outside"):
        big = torch.zeros((8193, 4), dtype=torch.int32, device="cuda")
        hk.waterfill_scan(big, big, torch.ones(8193, dtype=torch.bool,
                                               device="cuda"),
                          dev[3], dev[4], None, 0)


def test_fused_beat_on_card_equals_cpu():
    from ray_tpu_torch.ops import hybrid_kernel as hk
    rng = np.random.default_rng(3)
    totals, avail, mask, reqs, _, _ = _problem(3, 256, 8, 16, neg=False)
    keys = hk.full_rescore(*[torch.as_tensor(a) for a in (
        totals, avail, mask, reqs)], SCALE // 2).numpy()
    slots = np.full((16,), 16, np.int32)
    slots[:12] = rng.integers(0, 16, size=12)
    counts = np.zeros((16,), np.int32)
    counts[:12] = rng.integers(0, 5000, size=12)
    extra = rng.random(256) > 0.2
    ov_idx = np.array([3, 70, 256, 256], np.int32)
    ov_av = rng.integers(-9000, 9000, size=(4, 8)).astype(np.int32)
    args = (totals, avail, mask, keys, reqs, slots, counts, extra, ov_idx,
            ov_av)
    got = hk.fused_beat(*[torch.as_tensor(a, device="cuda") for a in args],
                        SCALE // 2)
    want = hk.fused_beat(*[torch.as_tensor(a) for a in args], SCALE // 2)
    assert torch.equal(got[0].cpu(), want[0])
    assert torch.equal(got[1].cpu(), want[1])


def test_delta_scheduler_on_card_matches_reference():
    from ray_tpu.common.ids import NodeID
    from ray_tpu.common.resources import NodeResources, ResourceRequest
    from ray_tpu.scheduling import ClusterResourceManager, DeltaScheduler
    from ray_tpu_torch.common.resources import ResourceRequest as PReq
    from ray_tpu_torch.convert import crm_from_arrays
    from ray_tpu_torch.ops import hybrid_kernel as hk
    from ray_tpu_torch.scheduling import make_delta_scheduler

    rng = np.random.default_rng(11)
    ref = ClusterResourceManager(capacity=300)
    for _ in range(300):
        ref.add_node(NodeID.from_random(), NodeResources(
            {"CPU": int(rng.integers(2, 64)),
             "memory": int(rng.integers(1, 256))}))
    port = crm_from_arrays(*ref.arrays(), ref.resource_index.names())
    specs = [{"CPU": int(rng.integers(1, 4)),
              "memory": float(rng.integers(0, 6))} for _ in range(12)]
    vecs = np.stack([ref.intern_request(ResourceRequest(s)) for s in specs])
    for s in specs:
        port.intern_request(PReq(s))
    counts = rng.integers(1, 400, size=12).astype(np.int32)
    ref_eng = DeltaScheduler(ref)
    eng = make_delta_scheduler(port)
    assert eng.device.type == "cuda"
    before = hk.waterfill_scan.launches
    for beat in range(8):
        for _ in range(12):
            row = int(rng.integers(0, 300))
            ref.force_subtract(row, ResourceRequest({"CPU": 1}))
            port.force_subtract(row, PReq({"CPU": 1}))
        ov = {5: np.array([-300, 40], np.int32)} if beat % 2 else None
        got = eng.beat(vecs, counts, overrides=ov)
        want = ref_eng.beat(vecs, counts, overrides=ov)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(eng.last_budgets(),
                                      ref_eng.last_budgets())
        assert eng.stats == ref_eng.stats
    assert hk.waterfill_scan.launches == before + 8
    assert eng.readbacks == 8


# -- the rest of the delta beat: beat_rows and beat_tail (csrc/beat.cu) ----------

def _beat_case(s, n, r, c, seed, dirty=12):
    """Residents of S ranks of the card at N = n nodes (n_l = n / S) x R
    x C class slots (the last four padded), negative avail, dead rows and
    int32-edge totals, with one beat's inputs staged as the engines stage
    them (``BeatBlob``, one upload): dirty rows and overrides with padding
    lanes (a negative override, an override on a dirty row and on clean
    ones), a soft mask, the groups, and a class install with a padding
    slot.  Where R > ``ROW_COLS`` class 2 requests every column.
    Returns (state, the staged fields, a function of fields that stages
    them and returns the beat's kwargs and the install)."""
    from ray_tpu_torch.ops import hybrid_kernel as hk
    from ray_tpu_torch.scheduling.policy import BeatBlob
    rng = np.random.default_rng(seed)
    n_l = n // s
    totals, avail, mask, reqs, _, _ = _problem(seed, n, r, c)
    edge = rng.random(n) < 0.02               # not class 1's column
    totals[edge, r - 1] = (1 << 31) - 1
    avail[edge, r - 1] = rng.integers(-(1 << 31), (1 << 31) - 1,
                                      int(edge.sum()))
    reqs[c - 4:] = 0
    reqs[1] = 0
    reqs[1, 0] = (1 << 17) + 1               # an all-INF key row
    if r > ROW_COLS:
        reqs[2] = rng.integers(1, 3000, r)

    def rows(x):
        return [torch.as_tensor(np.ascontiguousarray(b), device="cuda")
                for b in np.split(x, s)]
    st = hk.BeatState(rows(totals), rows(avail), rows(mask),
                      [torch.as_tensor(reqs, device="cuda")] * s)
    st.alloc_keys()
    hk.beat_rows_plain(st, SCALE // 2, rescore=True)
    b = 16
    fields = {"slots": [np.concatenate([rng.permutation(c - 4),
                                        [c] * 4]).astype(np.int32)] * s,
              "counts": [rng.integers(0, 20000, c).astype(np.int32)] * s,
              "idx": [], "rows_totals": [], "rows_avail": [],
              "rows_mask": [], "ov_idx": [], "ov_avail": [],
              "extra_mask": [rng.random(n_l) > 0.1 for _ in range(s)],
              "cls_idx": [np.array([2, c - 3, c, c], np.int32)] * s,
              "cls_reqs": [rng.integers(0, 3000, (4, r)).astype(np.int32)]
              * s}
    for _ in range(s):
        k = min(dirty, n_l)
        idx = np.sort(rng.choice(n_l, k, replace=False))
        fields["idx"].append(np.concatenate(
            [idx, [n_l] * (b - k)]).astype(np.int32))
        fields["rows_totals"].append(
            rng.integers(0, 1 << 17, (b, r)).astype(np.int32))
        fields["rows_avail"].append(
            rng.integers(-(1 << 16), 1 << 17, (b, r)).astype(np.int32))
        fields["rows_mask"].append(rng.random(b) > 0.2)
        clean = np.setdiff1d(np.arange(n_l), idx)
        fields["ov_idx"].append(np.array(          # a dirty row, then clean
            [idx[0], *np.sort(rng.choice(clean, 3, replace=False)),
             *[n_l] * 4], np.int32))
        ov = rng.integers(-9000, 9000, (8, r)).astype(np.int32)
        ov[0] = -(1 << 17)
        fields["ov_avail"].append(ov)

    def stage(f):
        blob = BeatBlob(f)
        dev = torch.as_tensor(blob.host.reshape(-1), device="cuda")
        v = blob.views(list(dev.view(s, blob.words)))
        kw = {"rows": (v["idx"], v["rows_totals"], v["rows_avail"],
                       v["rows_mask"]),
              "overrides": (v["ov_idx"], v["ov_avail"]),
              "extra_mask": v["extra_mask"],
              "groups": (v["slots"], v["counts"])}
        return kw, (v["cls_idx"], v["cls_reqs"])
    return st, fields, stage


def _same_beat_state(a, b, g=None):
    """Every resident and beat buffer equal; the group buffers' first
    ``g`` rows (the rest is never written)."""
    for name in ("totals", "avail", "mask", "keys", "reqs", "avail_eff",
                 "mask_eff", "group_counts", "group_reqs"):
        xs, ys = getattr(a, name), getattr(b, name)
        if xs is not None:
            for x, y in zip(xs, ys):
                if name.startswith("group") and g is not None:
                    x, y = x[:g], y[:g]
                assert torch.equal(x, y), name


def _cdiv(a, b):
    return -(-a // b)


def _beat_rows_layout(call, s, n_l, r, c, kw):
    """The grid beat_rows must report for a call."""
    staged = r if r <= ROW_COLS else 0
    if "groups" in kw or "rows" in kw:
        b = kw["rows"][0][0].shape[0] if "rows" in kw else 0
        tiles = _cdiv(n_l, EFF_ROWS) if "groups" in kw else 0
        lanes = _cdiv(b, LANES)
        return {"ctas": s * (1 + lanes + tiles), "threads": 256,
                "tile_rows": EFF_ROWS, "class_block": 0,
                "gather_ctas": s, "lane_ctas": s * lanes,
                "tile_ctas": s * tiles, "staged_cols": staged,
                "mode": "beat"}
    n_cls = kw["classes"][0][0].shape[0] if "classes" in kw else c
    block = KEY_CLS * keys_per_warp(s, n_l, n_cls, r)
    ctas = s * _cdiv(n_l, KEY_ROWS) * _cdiv(n_cls, block)
    return {"ctas": ctas, "threads": 256, "tile_rows": KEY_ROWS,
            "class_block": block, "gather_ctas": 0, "lane_ctas": 0,
            "tile_ctas": ctas, "staged_cols": staged, "mode": call}


@pytest.mark.parametrize("s,n,r,c", [(1, 1024, 8, 64), (1, 8192, 64, 8),
                                     (2, 1024, 8, 64), (4, 1024, 8, 64),
                                     (8, 1024, 8, 64), (1, 8192, 16, 128),
                                     (2, 8192, 16, 128), (4, 8192, 16, 128),
                                     (8, 8192, 16, 128), (2, 8192, 128, 16),
                                     (1, 1024, 8, 20), (4, 1024, 160, 12)])
def test_beat_kernels_equal_plain(s, n, r, c):
    """``beat_rows`` (a class install with a padding slot, a full rescore,
    the beat, the beat under an all-false soft mask, a beat of G = 0 and
    the dirty rows alone) and ``beat_tail`` against their plain versions
    on the card, bit for bit: the beat width (1000 -> 1024 x 8 x 64), the
    node limit with 64 resource kinds, the contract's 8192 x 16 x 128,
    ranks of one card at S = 2 / 4 / 8, rows of exactly the columns staged
    on chip (128), classes that are not a multiple of the class block, and
    rows wider than the columns staged (a class requesting every one).
    The kernel zeroes the shard_scan exchange areas; each call is one
    launch, its grid as the layout rule says."""
    from ray_tpu_torch.ops import hybrid_kernel as hk
    from ray_tpu_torch.ops import shard_reduce as sr
    thr = SCALE // 2
    st, fields, stage = _beat_case(s, n, r, c, seed=s * 7 + r)
    kw, classes = stage(fields)
    dark, _ = stage(dict(fields, extra_mask=[np.zeros_like(x) for x in
                                             fields["extra_mask"]]))
    no_groups, _ = stage(dict(fields, slots=[np.zeros(0, np.int32)] * s,
                              counts=[np.zeros(0, np.int32)] * s))
    g = kw["groups"][0][0].shape[0]
    n_l = n // s
    calls = [("classes", {"classes": classes}), ("rescore", {"rescore": True}),
             ("dark", dark), ("no_groups", no_groups),
             ("rows", {"rows": kw["rows"]}), ("beat", kw)]
    xchg = max(128, sr.shard_scan_plan(s, n_l, r, False,
                                       st.totals[0].device)["exchange_ints"])
    for name, call in calls:
        a, p = st.clone(), st.clone()
        if s > 1:
            a.ensure_scan_buffers(g, xchg)
            a.scan_out["xchg"].fill_(5)
        before = hk.beat_rows.launches
        hk.beat_rows(a, thr, **call)
        assert hk.beat_rows.launches == before + 1, name
        hk.beat_rows_plain(p, thr, **call)
        torch.cuda.synchronize()
        _same_beat_state(a, p, call["groups"][0][0].shape[0]
                         if "groups" in call else None)
        assert hk.beat_rows.last_layout == _beat_rows_layout(
            name if name in ("classes", "rescore") else "beat", s, n_l, r, c,
            call), name
        if s > 1 and "groups" in call:
            assert int(a.scan_out["xchg"].abs().sum()) == 0
        if name == "dark":
            assert int(a.mask_eff[0].sum()) == 0
    assert int(a.mask_eff[0].sum()) > 0
    ov0 = kw["overrides"][0][0][0].item()      # an override on a dirty row
    assert torch.equal(a.avail_eff[0][ov0], kw["overrides"][1][0][0])
    if s == 1:
        counts, av = hk.waterfill_scan(
            a.totals[0], a.avail_eff[0], a.mask_eff[0], a.group_reqs[0][:g],
            a.group_counts[0][:g], None, thr)
        alloc, inf, av_fin = [counts[:, :n]], counts[:, n], [av]
    else:
        alloc, inf, av_fin = sr.shard_scan(
            a.totals, a.avail_eff, a.mask_eff, [x[:g] for x in a.group_reqs],
            [x[:g] for x in a.group_counts], None, thr, out=a.scan_out)
    before = hk.beat_tail.launches
    got = hk.beat_tail(a, alloc, inf, av_fin)
    assert hk.beat_tail.launches == before + 1
    want = hk.beat_tail_plain(a, alloc, inf, av_fin)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert int(got[1][1]) == 0 and int(got[0][:g, :n].sum()) > 0
    assert int((got[0][g:, :n] > 0).sum()) > 0


def test_beat_rows_wrapper_checks_once_a_layout():
    """A steady beat's ``beat_rows`` call on the card reuses its layout's
    checked call (no checks, no table) and still launches once; a changed
    shape, ranks not equally spaced and a CPU/CUDA mix raise
    ``ValueError`` before any launch."""
    from ray_tpu_torch.ops import hybrid_kernel as hk
    st, fields, stage = _beat_case(4, 1024, 8, 64, seed=5)
    kw, _ = stage(fields)
    thr = SCALE // 2
    hk.beat_rows(st, thr, **kw)
    n_calls, builds = len(hk._ROW_CALLS), hk.rank_table.builds
    call = hk.rows_call(st, thr, **kw)
    before = hk.beat_rows.launches
    for _ in range(3):
        hk.beat_rows(st, thr, **kw)
    assert hk.beat_rows.launches == before + 3
    assert hk.rows_call(st, thr, **kw) is call
    assert (len(hk._ROW_CALLS), hk.rank_table.builds) == (n_calls, builds)
    rows = list(kw["rows"])
    apart = torch.stack([rows[1][0]] * 8)       # ranks 0, 1, 3 and 6 of 8
    bad = {"shape": [x[:8] for x in rows[1]],
           "spacing": [apart[k] for k in (0, 1, 3, 6)],
           "device": [*rows[1][:-1], rows[1][-1].cpu()]}
    for what, xs in bad.items():
        with pytest.raises(ValueError):
            hk.beat_rows(st, thr, **dict(kw, rows=(rows[0], xs, *rows[2:])))
    assert hk.beat_rows.launches == before + 3
    torch.cuda.synchronize()


def _tail_case(s, n, r, c, g, seed):
    """``beat_tail``'s inputs on S ranks of the card, made directly: a
    class count that is not a multiple of the kernel's class block,
    zero-request columns and an all-zero class, a class with every
    column positive (past the 32 the kernel compacts where r > 32),
    negative and int32-edge avail, dead rows in mask_eff, rows short of a
    request, an all-INF key row, G classes of counts (G may be 0)."""
    from ray_tpu_torch.ops import hybrid_kernel as hk
    rng = np.random.default_rng(seed)
    n_l = n // s
    totals = rng.integers(0, 1 << 17, (n, r)).astype(np.int32)
    totals[rng.random(totals.shape) < 0.2] = 0
    av = (totals * rng.random(totals.shape)).astype(np.int32)
    neg = rng.random(totals.shape) < 0.1
    av[neg] = -rng.integers(1, 1 << 17, int(neg.sum()))
    av[rng.random(totals.shape) < 0.02] = (1 << 31) - 1
    mask_eff = rng.random(n) > 0.1
    reqs = rng.integers(1, 3000, (c, r)).astype(np.int32)
    reqs[rng.random(reqs.shape) < 0.5] = 0
    reqs[0] = 0
    reqs[1] = rng.integers(1, 3000, r)
    # contract keys: a score over the global row in the low 13 bits,
    # ties between rows, an all-INF row
    keys = ((rng.integers(0, 64, (c, n)) << 13) | np.arange(n)).astype(
        np.int32)
    keys[2] = (1 << 31) - 1
    alloc = rng.integers(0, 1000, (g, n)).astype(np.int32)
    inf = rng.integers(0, 100, g).astype(np.int32)

    def rows(x, axis=0):
        return [torch.as_tensor(np.ascontiguousarray(b), device="cuda")
                for b in np.split(x, s, axis=axis)]
    st = hk.BeatState(rows(totals), rows(totals), rows(mask_eff),
                      [torch.as_tensor(reqs, device="cuda")] * s,
                      rows(keys, axis=1))
    st.mask_eff = rows(mask_eff)
    return (st, hk.spaced(rows(alloc, axis=1)),
            torch.as_tensor(inf, device="cuda"), hk.spaced(rows(av)))


@pytest.mark.parametrize("s", [1, 2, 4, 8])
@pytest.mark.parametrize("n,r,c,g", [(1024, 16, 13, 64), (1024, 40, 32, 0),
                                     (8192, 8, 20, 7), (512, 3, 9, 128)])
def test_beat_tail_kernel_edges(s, n, r, c, g):
    """The budget CTAs over (class block, row tile) against
    ``beat_tail_plain``, bit for bit: classes past a class block, the
    magic-multiplier division at negative and int32-edge avail, more
    positive columns than the kernel compacts, dead and infeasible rows,
    G = 0; the overflow columns (inf, 0) and the argmin."""
    from ray_tpu_torch.ops import hybrid_kernel as hk
    args = _tail_case(s, n, r, c, g, seed=s * 31 + c)
    before = hk.beat_tail.launches
    got = hk.beat_tail(*args)
    assert hk.beat_tail.launches == before + 1
    want = hk.beat_tail_plain(*args)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    lay = hk.beat_tail.last_layout
    assert lay["argmin_ctas"] == c and lay["ctas"] == c + s * (
        -(-(n // s) // lay["tile_rows"])) * (-(-c // lay["class_block"]))
    budgets = got[0][g:, :-1]
    assert int((budgets > 0).sum()) > 0 and int(got[1][2]) == 0
    assert int(got[0][g:, -1].abs().sum()) == 0


@pytest.mark.parametrize("shards", [1, 2, 4, 8])
def test_delta_beat_is_three_kernels_and_no_transport_call(shards):
    """The engines on the card: every delta beat launches ``beat_rows``,
    the scan and ``beat_tail`` once each, makes no transport call, and
    builds no table of pointers (it is rebuilt after a full resync only);
    each beat equal to the plain engine on the CPU."""
    from ray_tpu_torch.common.ids import NodeID
    from ray_tpu_torch.common.resources import NodeResources, ResourceRequest
    from ray_tpu_torch.ops import hybrid_kernel as hk
    from ray_tpu_torch.ops import shard_reduce as sr
    from ray_tpu_torch.scheduling import (ClusterResourceManager,
                                          DeltaScheduler,
                                          ShardedDeltaScheduler)
    rng = np.random.default_rng(30 + shards)
    crm = ClusterResourceManager(capacity=1000)
    for _ in range(1000):
        crm.add_node(NodeID.from_random(), NodeResources(
            {"CPU": int(rng.integers(4, 64)),
             "memory": int(rng.integers(8, 256))}))
    vecs = np.stack([crm.intern_request(ResourceRequest(
        {"CPU": int(rng.integers(1, 4)),
         "memory": float(rng.integers(0, 8))})) for _ in range(64)])
    counts = rng.multinomial(1_000_000, np.full(64, 1 / 64)).astype(np.int32)
    if shards == 1:
        eng = DeltaScheduler(crm)
        scan = hk.waterfill_scan
    else:
        eng = ShardedDeltaScheduler(crm, shards, "flat",
                                    devices=["cuda:0"] * shards)
        scan = sr.shard_scan
    cpu = DeltaScheduler(crm, device="cpu")
    for i in range(8):
        if i == 5:                                  # a full resync
            thr_kw = {"spread_threshold": 0.75}
        for _ in range(12):
            crm.force_subtract(int(rng.integers(0, 1000)),
                               ResourceRequest({"CPU": 1}))
        kw = thr_kw if i >= 5 else {}
        ov = {7: np.array([-300, 40], np.int32)} if i % 2 else None
        before = (hk.beat_rows.launches, scan.launches,
                  hk.beat_tail.launches, hk.rank_table.builds)
        calls = eng._plane.transport.calls if shards > 1 else 0
        got = eng.beat(vecs, counts, overrides=ov, **kw)
        after = (hk.beat_rows.launches, scan.launches,
                 hk.beat_tail.launches, hk.rank_table.builds)
        np.testing.assert_array_equal(got, cpu.beat(vecs, counts,
                                                    overrides=ov, **kw))
        np.testing.assert_array_equal(eng.last_budgets(), cpu.last_budgets())
        if shards > 1:
            assert eng._plane.transport.calls == calls
        if i in (2, 3, 4, 6, 7):                    # steady delta beats
            assert [y - x for x, y in zip(before, after)] == [1, 1, 1, 0]
        if i == 5:                                  # resync: new tables
            assert after[3] > before[3]
    assert eng.stats["full_rescores"] == 2
    if shards > 1:
        st = eng.scan_stats
        assert st["transport_calls"] == 0 and st["route"] == "shard_scan"
        assert st["beat_tail_launches"] == 8


@pytest.mark.parametrize("s,mode", [(2, "flat"), (4, "two_level")])
def test_shard_plane_programs_on_one_card_equal_cpu_ranks(s, mode):
    """``ShardPlane``'s programs on ranks of one card (the beat kernels,
    each launched once for every rank; the residents updated in place)
    against the same programs on CPU ranks (the per-rank plain programs
    over the transport): full rescore, dirty rows, a class install and
    the fused beat, bit for bit; the card's fused beat makes no transport
    call."""
    from ray_tpu_torch.ops import hybrid_kernel as hk
    from ray_tpu_torch.ops import shard_reduce as sr
    thr = SCALE // 2
    rng = np.random.default_rng(40 + s)
    n, r, c = 1024, 8, 16
    totals, avail, mask, reqs, _, _ = _problem(40 + s, n, r, c)
    n_l = n // s
    card = sr.plane_for(s, mode, ["cuda:0"] * s)
    cpu = sr.plane_for(s, mode, ["cpu"] * s)
    assert card.on_card and not cpu.on_card

    def both(f):
        return [f(pl) for pl in (card, cpu)]

    def same(xs, ys):
        for x, y in zip(xs, ys):
            assert torch.equal(x.cpu(), y.cpu())
    res = both(lambda pl: [pl.shard_rows(totals, np.int32),
                           pl.shard_rows(avail, np.int32),
                           pl.shard_rows(mask, bool),
                           pl.replicate(reqs, np.int32)])
    keys = both(lambda pl: pl.full_rescore(*res[pl is cpu], thr))
    same(*keys)
    idx = np.concatenate([np.sort(rng.choice(n_l, 6, replace=False)),
                          [n_l, n_l]]).astype(np.int32)
    rows = (np.tile(idx, s), rng.integers(0, 1 << 17, (8 * s, r)),
            rng.integers(-(1 << 16), 1 << 17, (8 * s, r)),
            rng.random(8 * s) > 0.2)
    out = both(lambda pl: pl.apply_dirty_rows(
        *res[pl is cpu][:3], keys[pl is cpu], res[pl is cpu][3],
        pl.shard_rows(rows[0], np.int32), pl.shard_rows(rows[1], np.int32),
        pl.shard_rows(rows[2], np.int32), pl.shard_rows(rows[3], bool), thr))
    for x, y in zip(*out):
        same(x, y)
    cls = (np.array([1, 5, c, c], np.int32),
           rng.integers(0, 3000, (4, r)).astype(np.int32))
    out2 = both(lambda pl: pl.apply_dirty_classes(
        *out[pl is cpu][:3], out[pl is cpu][3], res[pl is cpu][3],
        pl.replicate(cls[0], np.int32), pl.replicate(cls[1], np.int32),
        thr))
    for x, y in zip(*out2):
        same(x, y)
    slots = np.concatenate([rng.permutation(c - 4), [c] * 4]).astype(np.int32)
    counts = rng.integers(0, 20000, c).astype(np.int32)
    ov_idx = np.tile(np.array([3, 9, n_l, n_l], np.int32), s)
    ov_av = rng.integers(-9000, 9000, (4 * s, r)).astype(np.int32)
    em = rng.random(n) > 0.1
    calls = card.transport.calls
    before = (hk.beat_rows.launches, hk.beat_tail.launches,
              sr.shard_scan.launches)
    packed = both(lambda pl: pl.fused_beat(
        *out[pl is cpu][:3], out2[pl is cpu][1], out2[pl is cpu][0],
        pl.replicate(slots, np.int32), pl.replicate(counts, np.int32),
        pl.shard_rows(em, bool), pl.shard_rows(ov_idx, np.int32),
        pl.shard_rows(ov_av, np.int32), thr))
    assert card.transport.calls == calls
    assert (hk.beat_rows.launches, hk.beat_tail.launches,
            sr.shard_scan.launches) == tuple(b + 1 for b in before)
    same(*packed)
    assert int(packed[0][0][:c, :n].sum()) > 0


# |kernel - plain| <= atol + rtol * |plain| + p_u * (softmax(QK^T) |V|),
# elementwise in f32; the reasons stand beside chip_smoke.FLASH_TOL
FLASH_TOL = {  # dtype: (atol, rtol, p_u)
    torch.float32: (1e-6, 1e-5, 1e-5),
    torch.float16: (1e-5, 2.0**-9, 2.0**-11),
    torch.bfloat16: (1e-5, 2.0**-6, 2.0**-8),
}
FLASH_CASES = [
    # dtype, causal, (b, t, h, d)
    (torch.float32, False, (2, 256, 4, 64)),
    (torch.float32, True, (1, 200, 2, 128)),
    (torch.float16, True, (2, 320, 4, 128)),
    (torch.bfloat16, False, (1, 192, 3, 64)),
    (torch.bfloat16, True, (2, 1024, 8, 128)),
    (torch.bfloat16, True, (2, 1024, 4, 64)),
    (torch.float16, True, (1, 1536, 4, 64)),
    # ragged: T is a multiple of neither 64 nor 128
    (torch.bfloat16, False, (1, 1000, 2, 128)),
    (torch.float16, True, (2, 333, 3, 128)),
]


def _flash_inputs(dtype, shape):
    gen = torch.Generator(device="cuda").manual_seed(sum(shape))
    return [torch.randn(shape, generator=gen, device="cuda").to(dtype)
            for _ in range(3)]


# the widest kernel width of the one-pass routes (the source note's);
# past it each dtype's pair of two-pass kernels
FLASH_REACH = 512
FLASH_TWOPASS32 = "flash_scores32_kernel+flash_values32_kernel"
FLASH_TWOPASS16 = "flash_scores16_kernel+flash_values16_kernel"


def _flash_route(dtype, width):
    """The kernel the entry point must report for a dtype and width."""
    if dtype == torch.float32:
        return "flash_tf32_kernel" if width <= FLASH_REACH else FLASH_TWOPASS32
    return ("flash_wgmma_kernel" if width <= 128 else
            "flash_big16_kernel" if width <= FLASH_REACH else
            FLASH_TWOPASS16)


def _key_tiles(dtype, d):
    """The key tiles the dropped-tile check drops: 64 keys, and in f32 or
    past width 512 the kernel's own tile, as the library reports it."""
    from ray_tpu_torch.ops.flash_attention import kernel_key_tile, kernel_width
    own = dtype == torch.float32 or kernel_width(d) > 512
    return sorted({64} | ({kernel_key_tile(d, dtype)} if own else set()))


def _drop_last_keys(q, k, v, causal, tile):
    """The plain version without the last ``tile`` keys: what a kernel
    that skipped its last key tile would return."""
    import math
    t, d = q.shape[1], q.shape[3]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float() / math.sqrt(d), k.float())
    dead = torch.zeros((t, t), dtype=torch.bool, device="cuda")
    dead[:, t - tile:] = True
    if causal:
        dead |= torch.ones_like(dead).triu(1)
    p = torch.softmax(s.masked_fill(dead, float("-inf")), dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)


def _flash_err_over_limit(got, q, k, v, causal):
    """max over elements of |got - plain| / its limit (<= 1 passes)."""
    from ray_tpu_torch.ops import flash_attention_plain
    atol, rtol, p_u = FLASH_TOL[q.dtype]
    want = flash_attention_plain(q, k, v, causal=causal).float()
    pv_abs = flash_attention_plain(q.float(), k.float(), v.float().abs(),
                                   causal=causal)
    limit = atol + rtol * want.abs() + p_u * pv_abs
    return float(((got.float() - want).abs() / limit).max())


@pytest.mark.parametrize("dtype,causal,shape", FLASH_CASES)
def test_flash_kernel_matches_plain(dtype, causal, shape):
    from ray_tpu_torch.ops import flash_attention
    q, k, v = _flash_inputs(dtype, shape)
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=causal, block_q=shape[1],
                          block_k=shape[1])
    assert flash_attention.launches == before + 1
    assert flash_attention.last_route == _flash_route(dtype, shape[3])
    assert got.dtype == dtype and got.shape == q.shape
    ratio = _flash_err_over_limit(got, q, k, v, causal)
    assert ratio <= 1.0, ratio


@pytest.mark.parametrize("dtype,causal,shape", FLASH_CASES)
def test_flash_limit_rejects_a_dropped_key_tile(dtype, causal, shape):
    """The limit above fails a kernel that skips its last 64-key tile,
    and, in f32, its last tile of the split-TF32 kernel."""
    q, k, v = _flash_inputs(dtype, shape)
    for tile in _key_tiles(dtype, shape[3]):
        faulty = _drop_last_keys(q, k, v, causal, tile)
        assert _flash_err_over_limit(faulty, q, k, v, causal) > 1.0, tile


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_kernel_takes_more_than_65535_heads(dtype):
    """B*H = 66560 (query tiles and b*h share gridDim.x)."""
    from ray_tpu_torch.ops import flash_attention
    shape = (1024, 64, 65, 64)
    q, k, v = _flash_inputs(dtype, shape)
    got = flash_attention(q, k, v)
    assert _flash_err_over_limit(got, q, k, v, False) <= 1.0


def test_flash_kernel_rejects_other_head_dims():
    """The kernel takes D in {64, 128, 256} and the multiples of 64 past
    256; its entry point refuses any other D (the wrapper pads those with
    zeros first: D = 300 runs at 320)."""
    import ctypes
    from ray_tpu_torch.ops import _build, flash_attention
    from ray_tpu_torch.ops.flash_attention import kernel_width
    assert [kernel_width(d) for d in (16, 100, 200, 256, 257, 300, 320,
                                      513)] == [64, 128, 256, 256, 320,
                                                320, 320, 576]
    q = torch.zeros((1, 64, 2, 320), device="cuda", dtype=torch.bfloat16)
    fn = _build.load("flash_attention")
    for d in (32, 96, 300):
        err = fn(q.data_ptr(), q.data_ptr(), q.data_ptr(), q.data_ptr(),
                 1, 64, 2, d, 2, 0, ctypes.c_float(1.0), None,
                 torch.cuda.current_stream().cuda_stream)
        assert err != 0, d
    x = torch.randn((1, 64, 2, 300), device="cuda", dtype=torch.bfloat16)
    assert flash_attention(x, x, x).shape == x.shape


FLASH_HEAD_DIMS = [16, 32, 80, 96, 160, 256]


@pytest.mark.parametrize("d", FLASH_HEAD_DIMS)
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32,
                                   torch.float16])
def test_flash_kernel_every_head_dim(d, causal, dtype):
    """Every head dim up to 256, against the plain version within the
    limit, which must still reject a dropped key tile at that dim (64
    keys, and in f32 the split-TF32 kernel's tile); the entry point
    reports the route: f32 on flash_tf32_kernel up to width 512."""
    from ray_tpu_torch.ops import flash_attention
    from ray_tpu_torch.ops.flash_attention import kernel_width
    shape = (2, 384, 3, d)
    q, k, v = _flash_inputs(dtype, shape)
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=causal)
    assert flash_attention.launches == before + 1
    width = kernel_width(d)
    assert flash_attention.last_route == _flash_route(dtype, width)
    assert got.shape == q.shape and got.dtype == dtype
    assert _flash_err_over_limit(got, q, k, v, causal) <= 1.0
    for tile in _key_tiles(dtype, d):
        faulty = _drop_last_keys(q, k, v, causal, tile)
        assert _flash_err_over_limit(faulty, q, k, v, causal) > 1.0, tile


# head dims past 256: 16-bit on wgmma with O's columns split over two
# warpgroups, f32 on wgmma in split TF32 over a cluster of two CTAs
FLASH_WIDE_DIMS = [288, 320, 384, 512]


@pytest.mark.parametrize("d", FLASH_WIDE_DIMS)
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32,
                                   torch.float16])
def test_flash_kernel_wide_head_dims(d, causal, dtype):
    """Head dims past 256, against the plain version within the limit,
    which must still reject a dropped key tile."""
    test_flash_kernel_every_head_dim(d, causal, dtype)


@pytest.mark.parametrize("d", [256, 512])
@pytest.mark.parametrize("t", [96, 203, 320])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32])
def test_flash_kernel_ragged_sequence_at_width_256_and_past(d, t, causal,
                                                           dtype):
    """T a multiple of neither the query tile (128 at D = 256, 64 at 512,
    in 16 bits and in f32) nor, at D = 256 in 16 bits, the key tile (64);
    T = 203 is odd, so the last key tile is ragged at every tile (f32's
    16 keys too, and the cluster exchanges S of that tile): TMA fills
    them with zeros."""
    from ray_tpu_torch.ops import flash_attention
    shape = (2, t, 3, d)
    q, k, v = _flash_inputs(dtype, shape)
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=causal, block_q=t, block_k=t)
    assert flash_attention.launches == before + 1
    assert flash_attention.last_route == _flash_route(dtype, d)
    assert got.shape == q.shape and got.dtype == dtype
    assert _flash_err_over_limit(got, q, k, v, causal) <= 1.0
    for tile in _key_tiles(dtype, d):
        faulty = _drop_last_keys(q, k, v, causal, tile)
        assert _flash_err_over_limit(faulty, q, k, v, causal) > 1.0, tile


@pytest.mark.parametrize("width", [64, 128, 256, 320, 384, 448, 512])
def test_flash_split32_model_has_the_kernels_tiles(width):
    """The CPU model of the f32 arithmetic
    (``tests/test_torch_flash_split32.py``) tiles the keys and the head
    dim as flash_tf32_kernel does: its key tile is the one the library
    reports, so the model's dropped-tile check drops the kernel's tile."""
    from ray_tpu_torch.ops.flash_attention import kernel_key_tile
    from test_torch_flash_split32 import kernel_tiles
    assert kernel_tiles(width)[1] == kernel_key_tile(width, torch.float32)


@pytest.mark.parametrize("d", [256, 512])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_f32_takes_the_split_tf32_route(d, causal):
    """f32 at D = 256 and past it runs on flash_tf32_kernel: within f32's
    limit, which the same function with bf16 operands (what a 16-bit
    tensor-core route would compute) fails, and so does one TF32 pass
    (operands with their low 13 bits cleared)."""
    import math
    from ray_tpu_torch.ops import flash_attention, flash_attention_plain
    q, k, v = _flash_inputs(torch.float32, (2, 256, 2, d))
    got = flash_attention(q, k, v, causal=causal)
    assert got.dtype == torch.float32
    assert flash_attention.last_route == "flash_tf32_kernel"
    assert _flash_err_over_limit(got, q, k, v, causal) <= 1.0
    rounded = flash_attention_plain(
        *(x.to(torch.bfloat16).float() for x in (q, k, v)), causal=causal)
    assert _flash_err_over_limit(rounded, q, k, v, causal) > 1.0

    def tf32(x):
        return (x.view(torch.int32) & ~0x1FFF).view(torch.float32)
    # one pass: S from TF32 Q (scaled first, as the kernel) and K, P V
    # from TF32 p and V
    s = torch.einsum("bqhd,bkhd->bhqk", tf32(q * (1.0 / math.sqrt(d))),
                     tf32(k))
    if causal:
        t = q.shape[1]
        s = s.masked_fill(torch.ones((t, t), dtype=torch.bool,
                                     device="cuda").triu(1), float("-inf"))
    one_pass = torch.einsum("bhqk,bkhd->bqhd", tf32(torch.softmax(s, -1)),
                            tf32(v))
    assert _flash_err_over_limit(one_pass, q, k, v, causal) > 1.0


def _flash_past_512_case(dtype, causal, d, shape=(2, 384, 2)):
    """The entry point at head dim d: one launch on the route of
    ``_flash_route``, within the limit, which rejects the dropped key
    tiles of ``_key_tiles``."""
    from ray_tpu_torch.ops import flash_attention
    q, k, v = _flash_inputs(dtype, (*shape, d))
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=causal, block_q=shape[1],
                          block_k=shape[1])
    assert flash_attention.launches == before + 1
    assert flash_attention.last_route == _flash_route(dtype, d), d
    assert got.shape == q.shape and got.dtype == dtype
    assert _flash_err_over_limit(got, q, k, v, causal) <= 1.0, d
    for tile in _key_tiles(dtype, d):
        faulty = _drop_last_keys(q, k, v, causal, tile)
        assert _flash_err_over_limit(faulty, q, k, v, causal) > 1.0, tile


@pytest.mark.parametrize("causal", [False, True])
def test_flash_f32_past_512_takes_the_cluster_then_two_pass_route(causal):
    """f32 past kernel width 512 (D = 576, 1600, 2048, 4096) takes the
    two-pass route (the scores kernel, then the values kernel) in split
    TF32, and 16-bit inputs at 576 and 1600 their own pair: each within
    the limit (f32's unchanged), which rejects the dropped 64 keys and
    the values kernel's tile of 32, with one launch of the entry point
    and two kernel launches (one chunk of scratch)."""
    from ray_tpu_torch.ops import flash_attention
    for dtype, d in ((torch.float32, 576), (torch.float32, 1600),
                     (torch.float32, 2048), (torch.float32, 4096),
                     (torch.bfloat16, 576), (torch.float16, 576),
                     (torch.bfloat16, 1600), (torch.float16, 1600)):
        _flash_past_512_case(dtype, causal, d, shape=(1, 256, 2))
        assert flash_attention.last_kernel_launches == 2, (dtype, d)
        assert flash_attention.last_scratch_bytes > 0, (dtype, d)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_two_pass_scratch_stays_within_its_cap(dtype):
    """The two-pass routes' score scratch is bounded: at B=1 T=2048 H=17
    D=1600 the scores of every query block need just past the cap (17
    heads x 16 blocks of 1 MiB and their row maxima; the need of one head
    times 17), so the scratch holds as many blocks as fit and the call
    runs in two chunks (four kernel launches, as the library counts them
    at each launch), within the limit.  Both dtypes share one plan (S is
    f32 in both).  Where one query block's scores pass the cap (T = 2**20)
    the route still plans, one block a chunk: the scratch is that
    block's, O(T), whatever B and H are."""
    from ray_tpu_torch.ops import _build, flash_attention
    scratch = _build.load("flash_attention", "rt_flash_scratch_bytes")
    code = {torch.float32: 0, torch.bfloat16: 2}[dtype]
    b, t, h, d = 1, 2048, 17, 1600
    need = b * h * scratch(1, t, 1, d, code)     # uncapped: head by head
    cap = scratch(b, t, h, d, code)
    assert 0 < cap < need <= 2 * cap, (cap, need)
    assert cap == scratch(b, t, h, d, 0)         # one plan, both dtypes
    assert scratch(b, t, h, 512, code) == 0      # one-pass routes keep none
    long_t = 2 ** 20
    block = scratch(1, long_t, 1, d, code)       # one block of 128 rows
    assert 256 << 20 < block <= 4 * 128 * 2 * long_t, block
    assert scratch(2, long_t, 8, d, code) == block
    q, k, v = _flash_inputs(dtype, (b, t, h, d))
    for causal in (False, True):
        got = flash_attention(q, k, v, causal=causal, block_q=t,
                              block_k=t)
        assert flash_attention.last_route == _flash_route(dtype, d)
        assert flash_attention.last_kernel_launches == 4
        assert _flash_err_over_limit(got, q, k, v, causal) <= 1.0


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_flash_16bit_past_512_runs_on_the_cluster_or_widened(dtype, causal):
    """16-bit inputs past kernel width 512 run on their own two-pass pair
    (flash_scores16_kernel, flash_values16_kernel), unwidened: at D = 576
    and past 1024 (1088) within the limit, which rejects their dropped
    key tiles (64 keys and the values kernel's 32), in 16-bit tensors.
    The C entry point takes 16-bit widths past 1024 itself, and refuses a
    two-pass call without its score scratch."""
    import ctypes
    from ray_tpu_torch.ops import _build, flash_attention
    _flash_past_512_case(dtype, causal, 576)
    _flash_past_512_case(dtype, causal, 1088, shape=(1, 256, 2))
    assert flash_attention.last_kernel_launches == 2
    x = torch.zeros((1, 64, 2, 1088), device="cuda", dtype=dtype)
    out = torch.empty_like(x)
    code = 2 if dtype == torch.bfloat16 else 1
    n = _build.load("flash_attention", "rt_flash_scratch_bytes")(
        1, 64, 2, 1088, code)
    scratch = torch.empty(n, dtype=torch.uint8, device="cuda")
    fn = _build.load("flash_attention")
    for ptr, ok in ((scratch.data_ptr(), True), (None, False)):
        err = fn(x.data_ptr(), x.data_ptr(), x.data_ptr(), out.data_ptr(),
                 1, 64, 2, 1088, code, 0, ctypes.c_float(1.0), ptr,
                 torch.cuda.current_stream().cuda_stream)
        assert (err == 0) == ok, (ptr, err)
    torch.cuda.synchronize()


FLASH_CLUSTER_WIDTHS = (
    [(torch.float32, d) for d in range(576, 1536 + 1, 64)]
    + [(dtype, d) for dtype in (torch.bfloat16, torch.float16)
       for d in range(576, 1024 + 1, 64)])


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype,d", FLASH_CLUSTER_WIDTHS,
                         ids=[f"{str(t)[6:]}-d{d}"
                              for t, d in FLASH_CLUSTER_WIDTHS])
def test_flash_cluster_routes_every_width(dtype, d, causal):
    """Every width past 512 that a cluster route once took (576 to 1536
    in f32, to 1024 in 16 bits, in steps of 64: even and uneven slices of
    O's columns): the library's rt_flash_route names the dtype's
    two-pass route, and the entry point runs on it within the limit at
    T = 200 (ragged at the query block and at both key tiles)."""
    from ray_tpu_torch.ops import _build
    code = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}[dtype]
    route = _build.load("flash_attention", "rt_flash_route")(d, code)
    assert route == (3 if dtype == torch.float32 else 7)
    _flash_past_512_case(dtype, causal, d, shape=(1, 200, 2))


# chip_smoke.FLASH_HEAD_DIMS past 512
FLASH_PAIR16_DIMS = [576, 1024, 1088, 1600]


@pytest.mark.parametrize("d", FLASH_PAIR16_DIMS)
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_flash_16bit_pair_every_head_dim_past_512(d, causal, dtype):
    """The 16-bit pair == the plain version within the limit at every
    width of chip_smoke.FLASH_HEAD_DIMS past 512, at T = 384 (three query
    blocks, twelve key tiles of the values kernel a block), with the
    dropped-tile checks."""
    _flash_past_512_case(dtype, causal, d, shape=(2, 384, 2))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_twopass_model_has_the_kernels_tiles(dtype):
    """The CPU model of the two-pass routes
    (``tests/test_torch_flash_twopass.py``) tiles the keys as the values
    kernels do: its key tile is the one the library reports."""
    from ray_tpu_torch.ops.flash_attention import kernel_key_tile
    from test_torch_flash_twopass import VALUES_TILE
    for d in (576, 1088, 1600):
        assert VALUES_TILE == kernel_key_tile(d, dtype)


# -- the autoscaler: phase 1 on the water-fill, the launch-loop kernel -------

def _launch_loop_problem(seed, k, g, r):
    rng = np.random.default_rng(seed)
    caps = rng.integers(0, 3000, size=(k, r)).astype(np.int32)
    caps[rng.random(caps.shape) < 0.2] = 0
    quotas = rng.integers(0, 60, size=k).astype(np.int32)
    reqs = rng.integers(0, 500, size=(g, r)).astype(np.int32)
    reqs[rng.random(reqs.shape) < 0.6] = 0
    reqs[0] = 0                                 # a class with no request
    rem = rng.integers(0, 4000, size=g).astype(np.int32)
    return caps, quotas, reqs, rem


INT_MIN, INT_MAX = -(1 << 31), (1 << 31) - 1
# divisors at the edges of the kernel's division (MAX_TOTAL_CU = 2**17)
EDGE_DIVISORS = (1, 2, 3, 7, 499, 1 << 17)
LAUNCH_LOOP_CASES = ("sparse", "negative", "dense128", "inactive",
                     "division", "all_positive")


def launch_loop_case(case, route, seed=0):
    """(caps, quotas, reqs, rem) int32 and max_iters for one of the
    launch loop's traps: "sparse" (3 of 64 kinds a class, as
    chip_smoke.autoscale_problem), "negative" (negative request
    entries), "dense128" (every one of R = 128 columns nonzero: more than
    32 entries a class), "inactive" (all-zero classes, rem <= 0, zero
    quotas), "division" (dividends at the edges: negative, multiples of
    the divisor +- 1, INT_MIN/INT_MAX, over EDGE_DIVISORS), "all_positive"
    (every column positive, caps and rem past 2**30: no _BIG in the
    min).  ``route`` "on_chip" keeps G*R small enough for the class rows
    to fit one CTA's shared memory, "streamed" takes G past that and runs
    a few iterations (the plain loop is a host loop over the classes)."""
    rng = np.random.default_rng(seed)
    streamed = route == "streamed"
    if case == "sparse":
        k, r, g = 16, 64, (256 if streamed else 64)
        reqs = np.zeros((g, r), np.int32)
        for row in reqs:
            kinds = rng.choice(r, size=3, replace=False)
            row[kinds] = rng.integers(1, 500, size=3)
        caps = rng.integers(0, 3000, size=(k, r)).astype(np.int32)
        caps[rng.random(caps.shape) < 0.2] = 0
        quotas = rng.integers(0, 60, size=k).astype(np.int32)
        rem = rng.integers(0, 4000, size=g).astype(np.int32)
    elif case == "negative":
        k, r, g = 12, 16, (1024 if streamed else 48)
        reqs = rng.integers(-300, 500, size=(g, r)).astype(np.int32)
        reqs[rng.random(reqs.shape) < 0.6] = 0
        caps = rng.integers(-200, 3000, size=(k, r)).astype(np.int32)
        quotas = rng.integers(0, 40, size=k).astype(np.int32)
        rem = rng.integers(-50, 4000, size=g).astype(np.int32)
    elif case == "dense128":
        k, r, g = 8, 128, (128 if streamed else 24)
        reqs = rng.integers(1, 300, size=(g, r)).astype(np.int32)
        reqs[rng.random(reqs.shape) < 0.1] *= -1
        caps = rng.integers(1000, 60000, size=(k, r)).astype(np.int32)
        quotas = rng.integers(0, 40, size=k).astype(np.int32)
        rem = rng.integers(0, 400, size=g).astype(np.int32)
    elif case == "inactive":
        k, r, g = 10, 16, (1024 if streamed else 40)
        reqs = rng.integers(0, 500, size=(g, r)).astype(np.int32)
        reqs[rng.random(reqs.shape) < 0.6] = 0
        reqs[::3] = 0                                   # no request
        reqs[1::5] = -np.abs(reqs[1::5])                # no positive entry
        caps = rng.integers(0, 3000, size=(k, r)).astype(np.int32)
        quotas = rng.integers(0, 40, size=k).astype(np.int32)
        quotas[::2] = 0
        quotas[1] = -3
        rem = rng.integers(0, 4000, size=g).astype(np.int32)
        rem[rng.random(g) < 0.3] = 0
        rem[rng.random(g) < 0.2] = -rng.integers(1, 1000)
    elif case == "division":
        k, r, g = 24, 8, (2048 if streamed else 40)
        d = np.array(EDGE_DIVISORS, np.int64)
        edges = np.unique(np.concatenate([
            [0, 1, -1, INT_MIN, INT_MIN + 1, INT_MAX, INT_MAX - 1],
            d - 1, d, d + 1, 2 * d - 1, 2 * d + 1, -d, -d - 1, -d + 1,
            7 * d, 7 * d - 1, -7 * d - 1, INT_MAX - INT_MAX % d,
            INT_MIN + (-INT_MIN) % d]))
        caps = rng.choice(edges, size=(k, r)).astype(np.int32)
        reqs = np.zeros((g, r), np.int32)
        for row in reqs:
            kinds = rng.choice(r, size=rng.integers(1, 4), replace=False)
            row[kinds] = rng.choice(d, size=kinds.size)
            if rng.random() < 0.3:
                row[rng.integers(r)] = -rng.choice(d)
        quotas = rng.integers(0, 8, size=k).astype(np.int32)
        # INT_MAX among 40 classes wraps the loop's int32 sum, as XLA's
        # does; among 2048 it would end the loop before it starts
        big = 1 << 16 if streamed else INT_MAX
        rem = rng.choice(np.array([1, 2, 3, 500, 1 << 20, big, -1, 0]),
                         size=g).astype(np.int32)
    elif case == "all_positive":
        k, r, g = 3, 2, (8192 if streamed else 6)
        reqs = rng.integers(1, 4, size=(g, r)).astype(np.int32)
        caps = np.full((k, r), INT_MAX, np.int32)
        caps[1] = 1 << 30
        caps[2, 1] = 5
        quotas = np.array([1, 2, 1], np.int32)
        # one class past 2**30, the loop's int32 sum still positive,
        # asking 1 of each kind: its fit on type 0 is rem, past _BIG
        rem = rng.integers(1, 100, size=g).astype(np.int32)
        rem[1] = INT_MAX - (1 << 20)
        reqs[1] = 1
    else:
        raise ValueError(case)
    max_iters = (2 if g > 4096 else 6) if streamed else g * k + g + k + 2
    return (caps, quotas, reqs, rem), max_iters


def _steps_bound(iters, quotas, reqs):
    # class steps the kernel may run: iterations x types with quota x
    # classes with a positive entry (<= iterations x K x G)
    return int(iters) * int((quotas > 0).sum()) * \
        int((reqs > 0).any(axis=1).sum())


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("k,g,r", [(1, 1, 1), (5, 10, 4), (16, 64, 64),
                                   (32, 128, 128), (40, 33, 7)])
def test_binpack_launch_loop_bit_exact(seed, k, g, r):
    from ray_tpu_torch.ops.binpack_kernel import (binpack_launch_loop,
                                                  launch_loop_plain)
    arrays = _launch_loop_problem(seed, k, g, r)
    cpu = [torch.tensor(a) for a in arrays]
    max_iters = g * k + g + k + 2
    before = binpack_launch_loop.launches
    got = binpack_launch_loop(*[a.cuda() for a in cpu], max_iters)
    assert binpack_launch_loop.launches == before + 1
    steps = int(binpack_launch_loop.last_class_steps)
    want = launch_loop_plain(*cpu, max_iters)
    for x, y in zip(got, want):
        assert torch.equal(x.cpu(), y), (seed, k, g, r)
    chain = int(binpack_launch_loop.last_chain_steps)
    assert 0 <= chain <= steps <= int(got[2]) * k * g
    assert steps <= _steps_bound(got[2].cpu(), arrays[1], arrays[2])
    # the plain version on the card equals its CPU run too
    plain_card = launch_loop_plain(*[a.cuda() for a in cpu], max_iters)
    for x, y in zip(plain_card, want):
        assert torch.equal(x.cpu(), y)


# the kernel's traps, each on chip and with the class rows streamed
# through the ring (G*R*4 ints past one CTA's shared memory)
@pytest.mark.parametrize("route", ["on_chip", "streamed"])
@pytest.mark.parametrize("case", LAUNCH_LOOP_CASES)
def test_binpack_launch_loop_edge_cases(case, route):
    from ray_tpu_torch.ops.binpack_kernel import (binpack_launch_loop,
                                                  launch_loop_plain)
    arrays, max_iters = launch_loop_case(case, route)
    k, g = arrays[0].shape[0], arrays[2].shape[0]
    cpu = [torch.tensor(a) for a in arrays]
    got = binpack_launch_loop(*[a.cuda() for a in cpu], max_iters)
    layout = binpack_launch_loop.last_layout
    steps = int(binpack_launch_loop.last_class_steps)
    assert ("table" in layout["global"]) == (route == "streamed"), layout
    assert (layout["ring_slots"] > 0) == (route == "streamed"), layout
    want = launch_loop_plain(*cpu, max_iters)
    for x, y in zip(got, want):
        assert torch.equal(x.cpu(), y), (case, route)
    chain = int(binpack_launch_loop.last_chain_steps)
    assert 0 <= chain <= steps <= int(got[2]) * k * g
    assert steps <= _steps_bound(got[2].cpu(), arrays[1], arrays[2])


@pytest.mark.parametrize("seed", range(6))
def test_autoscale_on_card_equals_oracle(seed):
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).parent))
    from test_autoscaler import random_autoscale_problem

    from ray_tpu_torch.autoscaler.demand import get_nodes_to_launch
    from ray_tpu_torch.ops.binpack_kernel import autoscale_np
    from ray_tpu_torch.scheduling.oracle import ClusterState
    rng = np.random.default_rng(seed + 100)
    p = random_autoscale_problem(rng, n_nodes=300, n_res=16, n_groups=48,
                                 n_types=12)
    got = autoscale_np(*p)
    st = ClusterState(p[0].copy(), p[1].copy(), p[2].copy())
    launches, fit, unmet = get_nodes_to_launch(st, *p[3:])
    for x, y in zip(got, (launches, fit, unmet, st.avail)):
        assert np.array_equal(x, y), seed


def test_binpack_rejects_what_the_kernel_does_not_take():
    from ray_tpu_torch.ops.binpack_kernel import binpack_launch_loop
    caps, quotas, reqs, rem = (torch.tensor(a).cuda() for a in
                               _launch_loop_problem(0, 4, 8, 4))
    with pytest.raises(ValueError, match="int32"):
        binpack_launch_loop(caps.long(), quotas, reqs, rem, 10)
    with pytest.raises(ValueError, match="shape"):
        binpack_launch_loop(caps, quotas, reqs[:, :2].contiguous(), rem, 10)
    with pytest.raises(ValueError, match="empty"):
        binpack_launch_loop(caps[:0], quotas[:0], reqs, rem, 10)


# the arrays in global memory on an H100 (227 KB of shared memory a CTA),
# placed in the .cu's order: table (sized for dense requests), state,
# classes, used, caps, packed, capdiv; one shape for each route
@pytest.mark.parametrize("k,g,r,spilled", [
    (64, 8, 512, ["caps", "capdiv"]),       # the rows on chip
    (16, 1024, 64, ["table"]),              # the rows streamed
    (32, 2048, 128, ["table", "packed"]),
    (2, 30000, 2, ["table", "classes", "packed"]),
    (2, 8, 40000, ["table", "used", "caps", "capdiv"]),
])
def test_binpack_spills_what_shared_memory_cannot_hold(k, g, r, spilled):
    # every shape the reference takes runs: the arrays that do not fit
    # go to global memory, bit-exact against the plain loop (a few
    # iterations: the plain loop is a host loop over the classes)
    from ray_tpu_torch.ops.binpack_kernel import (binpack_launch_loop,
                                                  launch_loop_plain)
    arrays = _launch_loop_problem(3, k, g, r)
    cpu = [torch.tensor(a) for a in arrays]
    iters = 2 if g > 4096 else 12
    got = binpack_launch_loop(*[a.cuda() for a in cpu], iters)
    layout = binpack_launch_loop.last_layout
    assert layout["global"] == spilled, layout
    assert layout["scratch_ints"] > 0 or set(spilled) <= {"caps"}
    assert (layout["ring_slots"] > 0) == ("table" in spilled)
    want = launch_loop_plain(*cpu, iters)
    for x, y in zip(got, want):
        assert torch.equal(x.cpu(), y), (k, g, r)
    steps = int(binpack_launch_loop.last_class_steps)
    assert steps <= _steps_bound(got[2].cpu(), arrays[1], arrays[2])
    # and the fitting shape keeps everything on chip
    binpack_launch_loop(*[a.cuda() for a in
                          map(torch.tensor, _launch_loop_problem(0, 16, 64,
                                                                 64))], 4)
    assert binpack_launch_loop.last_layout["global"] == []
    assert binpack_launch_loop.last_layout["ring_slots"] == 0


# -- top-k rounds ------------------------------------------------------------

@pytest.mark.parametrize("seed", range(3))
def test_topk_card_equals_cpu(seed):
    from ray_tpu_torch.ops.locality_kernel import schedule_grouped_topk_np
    totals, avail, mask, reqs, counts, masks = _problem(seed, 500, 8, 24,
                                                        neg=False)
    kw = dict(group_masks=masks, k_frac=0.3, k_abs=2)
    got = schedule_grouped_topk_np(totals, avail, mask, reqs, counts,
                                   seed, 7, **kw)
    want = schedule_grouped_topk_np(totals, avail, mask, reqs, counts,
                                    seed, 7, device="cpu", **kw)
    for x, y in zip(got, want):
        assert np.array_equal(x, y)


# -- the localized water-fill ------------------------------------------------

def _localized(seed, n, r, g):
    """_problem's arrays plus preferred rows: half the classes prefer a
    row; among them an infeasible row, a row masked out by the class's
    avoid row, and rows with negative avail."""
    totals, avail, mask, reqs, counts, masks = _problem(seed, n, r, g)
    rng = np.random.default_rng(seed + 1)
    prefs = np.where(rng.random(g) < 0.5, rng.integers(0, n, size=g),
                     -1).astype(np.int32)
    if g >= 6 and n >= 8:
        c = int(np.argmax(reqs[3] > 0)) if (reqs[3] > 0).any() else 0
        reqs[3, c] = max(int(reqs[3, c]), 100)
        prefs[3], totals[4, c], mask[4] = 4, 1, True   # infeasible
        prefs[4], masks[4, 5], mask[5] = 5, False, True  # masked out
        prefs[5], mask[6] = 6, True
        avail[6] = -(totals[6] // 3)                      # negative avail
    return totals, avail, mask, reqs, counts, masks, prefs


@pytest.mark.parametrize("n,r,g", [(16, 3, 8), (1000, 8, 64),
                                   # the contract's limit
                                   (8192, 16, 128),
                                   # the rows spill out of shared memory
                                   (8192, 64, 32)])
def test_localized_kernel_bit_exact(n, r, g):
    from ray_tpu_torch.ops import hybrid_kernel as hk
    from ray_tpu_torch.ops import locality_kernel as lk
    arrays = list(_localized(n + r, n, r, g))
    if r > 32:
        arrays[3][:, 6:r - 6] = 0
    dev = [torch.as_tensor(a, device="cuda") for a in arrays]
    extra = torch.as_tensor(np.random.default_rng(n).random(n) > 0.05,
                            device="cuda")
    before = (hk.waterfill_scan.launches, hk.waterfill_scan.localized_launches)
    kc, ka = lk.schedule_grouped_localized(*dev, SCALE // 2, extra)
    assert (hk.waterfill_scan.launches,
            hk.waterfill_scan.localized_launches) == (before[0], before[1] + 1)
    pc, pa = hk.waterfill_scan_plain(dev[0], dev[1], dev[2] & extra,
                                     dev[3], dev[4], dev[5], SCALE // 2,
                                     False, dev[6])
    assert torch.equal(kc, pc) and torch.equal(ka, pa)
    # the plain (no preference) launch of the same classes is untouched
    nc, _ = hk.waterfill_scan(*dev[:6], SCALE // 2)
    npc, _ = hk.waterfill_scan_plain(*dev[:6], SCALE // 2)
    assert torch.equal(nc, npc)


def test_localized_kernel_matches_the_jax_function():
    import jax.numpy as jnp
    from ray_tpu.ops import locality_kernel as ref
    from ray_tpu_torch.ops import locality_kernel as lk
    arrays = _localized(7, 257, 8, 33)
    got = lk.schedule_grouped_localized(
        *[torch.as_tensor(a, device="cuda") for a in arrays], SCALE // 2)
    want = ref.schedule_grouped_localized(
        *[jnp.asarray(a) for a in arrays], jnp.int32(SCALE // 2))
    np.testing.assert_array_equal(got[0].cpu().numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].cpu().numpy(), np.asarray(want[1]))


# -- the data-plane programs on the card --------------------------------------

def test_dataplane_programs_on_card_equal_their_oracles():
    from ray_tpu_torch.ops import broadcast_kernel as bc
    from ray_tpu_torch.ops import bundle_kernel as bk
    from ray_tpu_torch.ops import pull_kernel as pk
    rng = np.random.default_rng(0)
    n = 200
    totals = rng.integers(0, 4000, size=(n, 4)).astype(np.int32)
    avail = (totals * rng.random(totals.shape)).astype(np.int32)
    mask = rng.random(n) > 0.05
    reqs = rng.integers(0, 600, size=(16, 6, 4)).astype(np.int32)
    valid = rng.random((16, 6)) < 0.8
    strat = rng.integers(0, 4, size=16)
    got = bk.schedule_bundle_groups_np(totals, avail, mask, reqs, valid,
                                       strat)
    want = bk.schedule_bundle_groups_oracle(totals, avail, mask, reqs, valid,
                                            strat)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    loc = rng.random((300, n)) < 0.05
    bw = rng.integers(0, 50_000, size=(n, n)).astype(np.int32)
    dest = rng.integers(0, n, size=300).astype(np.int32)
    sizes = rng.integers(1, 1 << 20, size=300).astype(np.int32)
    infl = rng.integers(0, 100_000, size=n).astype(np.int32)
    for a, b in zip(pk.choose_sources_np(loc, bw, dest, sizes, infl),
                    pk.choose_sources_oracle(loc, bw, dest, sizes, infl)):
        np.testing.assert_array_equal(a, b)
    member = rng.random(n) < 0.8
    member[3] = True
    for a, b in zip(bc.plan_fanout_np(member, bw, 3, 4, infl),
                    bc.plan_fanout_oracle(member, bw, 3, 4, infl)):
        np.testing.assert_array_equal(a, b)


# -- the top-k, bundle and pull kernels ----------------------------------------

def _topk_args(seed, n, r, g, dev, masks):
    from fractions import Fraction

    from ray_tpu_torch.ops import locality_kernel as lk
    totals, avail, mask, reqs, counts, gm = _problem(seed, n, r, g)
    extra = np.random.default_rng(seed).random(n) > 0.05
    frac = Fraction(0.3).limit_denominator(1 << 16)
    arrays = (totals, avail, mask, reqs, counts, gm if masks else None)
    t = [None if a is None else torch.as_tensor(a, device=dev)
         for a in arrays]
    return (*t, SCALE // 2, 2, frac.numerator, frac.denominator,
            torch.as_tensor(lk.topk_draws(seed, 9, g), device=dev),
            torch.as_tensor(extra, device=dev) if masks else None)


@pytest.mark.parametrize("n,r,g", [(16, 3, 4), (77, 6, 9), (1000, 8, 64),
                                   (1025, 5, 7), (8192, 16, 128),
                                   # avail past shared memory (2 MB)
                                   (8192, 64, 8),
                                   # two and three keys a thread
                                   (2000, 8, 32), (3000, 6, 16)])
@pytest.mark.parametrize("masks", [True, False])
def test_topk_kernel_bit_exact(n, r, g, masks):
    """csrc/topk.cu == schedule_grouped_topk_plain on the card and on the
    CPU, bit for bit (negative avail, dead rows, an all-masked class),
    one launch a call."""
    from ray_tpu_torch.ops import locality_kernel as lk
    args = _topk_args(n + g, n, r, g, "cuda", masks)
    before = lk.schedule_grouped_topk.launches
    kc, ka = lk.schedule_grouped_topk(*args)
    assert lk.schedule_grouped_topk.launches == before + 1
    assert lk.schedule_grouped_topk.last_layout == topk_plan(n, r, g)
    pc, pa = lk.schedule_grouped_topk_plain(*args)
    assert torch.equal(kc, pc) and torch.equal(ka, pa)
    cc, ca = lk.schedule_grouped_topk(*_topk_args(n + g, n, r, g, "cpu",
                                                  masks))
    assert torch.equal(kc.cpu(), cc) and torch.equal(ka.cpu(), ca)
    assert lk.schedule_grouped_topk.launches == before + 1
    jc, ja = _topk_jax(n + g, n, r, g, masks)
    np.testing.assert_array_equal(kc.cpu().numpy(), jc)
    np.testing.assert_array_equal(ka.cpu().numpy(), ja)


def _topk_select_case(case):
    """test_torch_topk_select's edge problems on the card, and two at the
    ``global`` layout (8192 x 64): counts chosen for a wrapping window,
    and every key equal but its row bits."""
    if case == "global_window_wraps":
        from test_torch_topk_select import _problem
        p = _choose_counts(_problem(21, 8192, 64, 3), 3, 11, 1, 0.25,
                           "wrap")
        return p, 3, 11, 1, 0.25, SCALE // 2
    if case == "global_one_digit":
        n, r = 8192, 64
        totals = np.zeros((n, r), np.int32)
        totals[:, 0] = 4096
        reqs = np.zeros((4, r), np.int32)
        reqs[:, 0] = 1
        p = dict(totals=totals, avail=totals.copy(), mask=np.ones(n, bool),
                 extra_mask=np.ones(n, bool), reqs=reqs,
                 counts=np.array([199, 1000, 3, 77], np.int32),
                 group_masks=np.ones((4, n), bool))
        return p, 3, 11, 1, 0.6, SCALE // 2
    return _edge(case)


@pytest.mark.parametrize("case", SELECT_EDGES + ["global_window_wraps",
                                                 "global_one_digit"])
def test_topk_kernel_select_edges(case):
    """The select's edges on the card: extra 0, a window that wraps, a
    window that ends at k, k == nf, k == 1, every key INF, thousands of
    keys equal but their row bits, keys past the avail bit, one radix
    digit shared by every key; at both layouts.  The kernel == its
    plain version on the card == the numpy model of the select == the
    JAX function, bit for bit, one launch a call."""
    from ray_tpu.ops import locality_kernel as ref
    from ray_tpu_torch.ops import locality_kernel as lk
    p, seed, rnd, k_abs, k_frac, thr = _topk_select_case(case)
    args = (p["totals"], p["avail"], p["mask"], p["reqs"], p["counts"])
    kw = dict(group_masks=p["group_masks"], thr_fp=thr, k_abs=k_abs,
              k_frac=k_frac, extra_mask=p["extra_mask"])
    before = lk.schedule_grouped_topk.launches
    got = lk.schedule_grouped_topk_np(*args, seed, rnd, device="cuda", **kw)
    assert lk.schedule_grouped_topk.launches == before + 1
    n, r = p["totals"].shape
    assert lk.schedule_grouped_topk.last_layout == topk_plan(
        n, r, p["reqs"].shape[0])
    if case.startswith("global"):
        assert lk.schedule_grouped_topk.last_layout == "global"
    plain = lk.schedule_grouped_topk_np(*args, seed, rnd, device="cpu",
                                        **kw)
    model = topk_model(p["totals"], p["avail"], p["mask"], p["reqs"],
                       p["counts"], seed, rnd, p["group_masks"], thr, k_abs,
                       k_frac, p["extra_mask"])
    want = ref.schedule_grouped_topk_np(*args, seed=seed, round_index=rnd,
                                        **kw)
    for a, b, c, d in zip(got, plain, model, want):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(a, np.asarray(d))


@pytest.mark.parametrize("n,r,g,layout", TOPK_LAYOUT_RULE)
def test_topk_layout_rule_is_the_kernels(n, r, g, layout):
    """The CPU model's layout rule (test_torch_topk_select.topk_plan) is
    topk.cu's plan()."""
    from ray_tpu_torch.ops import locality_kernel as lk
    assert lk.topk_plan(n, r, g)[0] == layout == topk_plan(n, r, g)


def _topk_jax(seed, n, r, g, masks):
    """The JAX function on ``_topk_args``' problem (seed and round 9)."""
    from ray_tpu.ops import locality_kernel as ref
    totals, avail, mask, reqs, counts, gm = _problem(seed, n, r, g)
    extra = np.random.default_rng(seed).random(n) > 0.05
    return ref.schedule_grouped_topk_np(
        totals, avail, mask, reqs, counts, seed, 9,
        gm if masks else None, thr_fp=SCALE // 2, k_abs=2, k_frac=0.3,
        extra_mask=extra if masks else None)


def _bundle_arrays(seed, n, p, b, r=8, kind="random"):
    rng = np.random.default_rng(seed)
    totals = rng.integers(0, 6400, size=(n, r)).astype(np.int32)
    totals[rng.random(totals.shape) < 0.25] = 0
    avail = (totals * rng.random(totals.shape)).astype(np.int32)
    mask = rng.random(n) > 0.02
    reqs = rng.integers(0, 800, size=(p, b, r)).astype(np.int32)
    reqs[rng.random(reqs.shape) < 0.5] = 0
    valid = rng.random((p, b)) < 0.85
    if kind == "homogeneous":
        reqs[:] = reqs[:, :1]            # gangs of one request, B times
    if kind == "tie_on_a_cta_boundary":
        # only the rows around two CTA boundaries (512 rows a CTA at 8192
        # nodes) can take a bundle, and they tie
        totals[:] = 3000
        avail[:] = 0
        mask[:] = True
        avail[[2047, 2048, 4095, 4096]] = 3000
        reqs[:] = np.where(reqs > 0, 700, 0)
        valid[:, 0] = True
    return totals, avail, mask, reqs, valid, np.arange(p) % 4


@pytest.mark.parametrize("n,p,b,r,kind,layout", [
    (16, 4, 3, 8, "random", "shared"), (100, 16, 8, 8, "random", "shared"),
    (200, 2, 8, 8, "random", "cluster"),
    (1000, 64, 8, 8, "random", "cluster"),
    (8192, 64, 8, 8, "random", "cluster"),
    # the rows past a cluster's shared memory (6 MB, 12 MB): in global
    # memory
    (8192, 16, 4, 64, "random", "global"),
    (8192, 8, 4, 128, "random", "global"),
    (1000, 32, 8, 8, "homogeneous", "cluster"),
    (8192, 16, 8, 8, "homogeneous", "cluster"),
    # 512 rows a CTA of 16: rows 2047 | 2048 and 4095 | 4096 straddle two
    (8192, 8, 8, 8, "tie_on_a_cta_boundary", "cluster"),
    # past MAX_NODES a key no longer names its row: (key, row) pairs are
    # exchanged instead of atomicMin on keys
    (9000, 6, 4, 8, "random", "cluster")])
def test_bundle_kernel_bit_exact(n, p, b, r, kind, layout):
    """csrc/bundle.cu == schedule_bundle_groups_plain on the card, the
    JAX function and the numpy oracle, bit for bit, one launch a call, in
    the layout the shape asks for (every layout, homogeneous gangs, a
    first-argmin tie on a CTA boundary), over the CTAs the layout rule
    gives."""
    from ray_tpu.ops import bundle_kernel as ref
    from ray_tpu_torch.ops import bundle_kernel as bk
    totals, avail, mask, reqs, valid, strat = _bundle_arrays(n + p, n, p, b,
                                                             r, kind)
    dev = [torch.as_tensor(a, device="cuda")
           for a in (totals, avail, mask, reqs)]
    before = bk.schedule_bundle_groups.launches
    got = bk.schedule_bundle_groups(*dev, valid, strat, SCALE // 2)
    assert bk.schedule_bundle_groups.launches == before + 1
    assert bk.schedule_bundle_groups.last_layout == layout
    assert bk.schedule_bundle_groups.last_cluster == \
        bundle_plan_model(n, r, p, b)[1]
    if kind == "tie_on_a_cta_boundary":
        placed = got[0].cpu().numpy()
        assert placed[0][valid[0]][0] == 2047
        assert set(np.unique(placed[placed >= 0])) <= {2047, 2048, 4095,
                                                       4096}
    plain = bk.schedule_bundle_groups_plain(*dev, valid, strat, SCALE // 2)
    for x, y in zip(got, plain):
        assert torch.equal(x, y)
    want = bk.schedule_bundle_groups_oracle(totals, avail, mask, reqs,
                                            valid, strat,
                                            spread_threshold=0.5)
    for x, y in zip(got, want):
        np.testing.assert_array_equal(x.cpu().numpy(), y)
    jax_out = ref.schedule_bundle_groups_np(totals, avail, mask, reqs, valid,
                                            strat, thr_fp=SCALE // 2)
    for x, y in zip(got, jax_out):
        np.testing.assert_array_equal(x.cpu().numpy(), y)


@pytest.mark.parametrize("n,r,kind", [
    (4, 3, "random"), (200, 300, "random"), (1000, 4096, "random"),
    (1025, 40, "random"), (8192, 512, "random"),
    # every row holds every object: each list passes the cap, and the
    # CTA's helpers reduce it (every third request sparse, on the warp)
    (8192, 96, "dense"),
    # one rate on every link: ties across 32-candidate rounds
    (300, 200, "equal"),
    # exactly 32 and 33 candidates (and 0, 1, 31, 64, the cap, cap + 1)
    (1000, 64, "counts")])
def test_pull_kernel_bit_exact(n, r, kind):
    """csrc/pull.cu == choose_sources_plain on the card, the JAX function
    and the numpy oracle, bit for bit (an object no node holds, in-flight
    KB near INT_MAX that wraps), one launch a call."""
    from ray_tpu.ops import pull_kernel as ref
    from ray_tpu_torch.ops import pull_kernel as pk
    rng = np.random.default_rng(n + r)
    loc = rng.random((r, n)) < max(0.01, 2.0 / n)
    loc[0] = False
    bw = rng.integers(0, 50_000, size=(n, n)).astype(np.int32)
    bw[rng.random((n, n)) < 0.05] = 0
    dest = rng.integers(0, n, size=r).astype(np.int32)
    sizes = rng.integers(1, 1 << 20, size=r).astype(np.int32)
    infl = rng.integers(0, 1 << 20, size=n).astype(np.int32)
    infl[0] = 2**31 - 1000                  # wraps below zero when picked
    if kind == "dense":
        loc[:] = True
        loc[::3] = rng.random((len(loc[::3]), n)) < 0.01
    if kind == "equal":
        loc = rng.random((r, n)) < 0.35
        bw[:] = 4000
        infl[:] = 0
    if kind == "counts":
        bw[bw == 0] = 1                     # every holder a candidate
        cap = pk.kernel_plan(r, n)[0]
        assert cap == LIST_CAP
        for i in range(r):
            k = (32, 33, 0, 1, 31, 64, cap, cap + 1)[i % 8]
            loc[i] = False
            loc[i, rng.permutation(n)[:k]] = True
    arrays = (loc, bw, dest, sizes, infl)
    dev = [torch.as_tensor(a, device="cuda") for a in arrays]
    before = pk.choose_sources.launches
    got = pk.choose_sources(*dev)
    assert pk.choose_sources.launches == before + 1
    for x, y in zip(got, pk.choose_sources_plain(*dev)):
        assert torch.equal(x, y)
    with np.errstate(divide="ignore", over="ignore"):
        want = pk.choose_sources_oracle(*arrays)
    for x, y in zip(got, want):
        np.testing.assert_array_equal(x.cpu().numpy(), y)
    for x, y in zip(got, ref.choose_sources_np(*arrays)):
        np.testing.assert_array_equal(x.cpu().numpy(), y)


@pytest.mark.parametrize("n", [1, 2, 7, 200, 1000, 8192])
def test_pull_list_cap_is_the_kernels(n):
    """The cap the CPU model of pull.cu's chain takes (LIST_CAP, or N
    rounded up to even where that is less) and the scratch it implies
    are the library's."""
    from ray_tpu_torch.ops import pull_kernel as pk
    cap = min(LIST_CAP, (n + 1) & ~1)
    assert pk.kernel_plan(5, n) == (cap, 5 * (2 * cap + 1))


@pytest.mark.parametrize("n,r,p,b,per_cta,layout,cluster,threads",
                         LAYOUT_RULE)
def test_bundle_layout_rule_is_the_kernels(n, r, p, b, per_cta, layout,
                                           cluster, threads):
    """The CPU model's layout rule (test_torch_dataplane_chain.plan) is
    bundle.cu's plan(): each row of its table, in the source's build
    (kRowsPerCta = 128) or in one with -DRT_ROWS_PER_CTA=per_cta."""
    import ctypes

    from ray_tpu_torch.ops import _build
    from ray_tpu_torch.ops import bundle_kernel as bk
    if per_cta == 128:
        got = bk.kernel_plan(n, r, p, b)
    else:
        lib = _build.build_variants([(
            _build._CSRC / "bundle.cu",
            (f"-DRT_ROWS_PER_CTA={per_cta}",))])[0]
        out = (ctypes.c_longlong * 5)()
        assert _build.entry(lib, "bundle", "rt_bundle_plan")(
            n, r, p, b, out) == 0
        got = (bk.LAYOUTS[out[0]], *[int(x) for x in out[1:]])
    assert got[:3] == (layout, cluster, threads) == \
        bundle_plan_model(n, r, p, b, per_cta)


def _fanout_problem(n, fanout, kind, seed=0):
    """(member, bw, root, fanout, inflight_kb): the dataplane cell's
    draws (5% dead links, in-flight KB below 2**20) with random or
    uniform bandwidth; uniform gives every row the same best child, the
    kernel's worst case."""
    rng = np.random.default_rng(seed * 100 + n * 10 + fanout)
    if kind == "uniform":
        bw = np.full((n, n), 1000, np.int32)
    else:
        bw = rng.integers(0, 50_000, size=(n, n)).astype(np.int32)
        bw[rng.random((n, n)) < 0.05] = 0
    np.fill_diagonal(bw, 0)
    member = rng.random(n) < 0.9
    root = int(rng.integers(0, n))
    member[root] = True
    infl = rng.integers(0, 1 << 20, size=n).astype(np.int32)
    return member, bw, root, fanout, infl


@pytest.mark.parametrize("n", [2, 37, 200, 1000])
@pytest.mark.parametrize("fanout", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("kind", ["random", "uniform"])
def test_broadcast_kernel_bit_exact(n, fanout, kind):
    """csrc/broadcast.cu == plan_fanout_plain on the card, bit for bit,
    one launch a call; == the JAX function too up to 200 nodes."""
    from ray_tpu.ops import broadcast_kernel as ref
    from ray_tpu_torch.ops import broadcast_kernel as bc
    member, bw, root, fanout, infl = _fanout_problem(n, fanout, kind)
    dev = [torch.as_tensor(a, device="cuda") for a in (member, bw, infl)]
    before = bc.plan_fanout.launches
    got = bc.plan_fanout(dev[0], dev[1], root, fanout, dev[2])
    assert bc.plan_fanout.launches == before + 1
    for x, y in zip(got, bc.plan_fanout_plain(dev[0], dev[1], root, fanout,
                                              dev[2])):
        assert torch.equal(x, y)
    if kind == "uniform":                           # no dead link
        assert int((got[0] >= 0).sum()) == member.sum() - 1
    if n <= 200:
        for x, y in zip(got, ref.plan_fanout_np(member, bw, root, fanout,
                                                infl)):
            np.testing.assert_array_equal(x.cpu().numpy(), np.asarray(y))


def test_broadcast_kernel_uniform_at_8192():
    """Uniform bandwidth at the contract's 8192 rows (every row's best
    child taken at every attach): the kernel == its plain version on the
    card, bit for bit, one launch."""
    from ray_tpu_torch.ops import broadcast_kernel as bc
    member, bw, root, fanout, infl = _fanout_problem(8192, 4, "uniform")
    dev = [torch.as_tensor(a, device="cuda") for a in (member, bw, infl)]
    before = bc.plan_fanout.launches
    got = bc.plan_fanout(dev[0], dev[1], root, fanout, dev[2])
    assert bc.plan_fanout.launches == before + 1
    for x, y in zip(got, bc.plan_fanout_plain(dev[0], dev[1], root, fanout,
                                              dev[2])):
        assert torch.equal(x, y)
    assert int((got[0] >= 0).sum()) == member.sum() - 1


def test_broadcast_kernel_cluster_rule():
    """One CTA up to 1024 rows, then 1024 rows a CTA (kRowsPerCta =
    1024; 8 CTAs at the contract's 8192): the launch's CTAs and layout,
    as the CPU model's rule (test_torch_dataplane_chain.fanout_plan) gives
    them."""
    from ray_tpu_torch.ops import broadcast_kernel as bc
    for n, layout, cluster in ((1, "cta", 1), (64, "cta", 1),
                               (65, "cta", 1), (1000, "cta", 1),
                               (1025, "cluster", 2), (8192, "cluster", 8)):
        member, bw, root, fanout, infl = _fanout_problem(n, 4, "random")
        bc.plan_fanout_np(member, bw, root, fanout, infl, device="cuda")
        assert bc.plan_fanout.last_cluster == cluster, n
        assert bc.plan_fanout.last_layout == layout, n
        assert bc.fanout_plan(n) == fanout_plan(n) == (layout, cluster)


@pytest.mark.parametrize("n,per_cta,layout,cluster", FANOUT_RULE)
def test_broadcast_layout_rule_is_the_kernels(n, per_cta, layout, cluster):
    """broadcast.cu's plan() in the source's build and in builds with
    -DRT_ROWS_PER_CTA=per_cta, against the CPU model's rule; each such
    build's plan == its plain version on the card at that N."""
    import ctypes

    from ray_tpu_torch.ops import _build
    from ray_tpu_torch.ops import broadcast_kernel as bc
    flags = () if per_cta == 1024 else (f"-DRT_ROWS_PER_CTA={per_cta}",)
    lib = _build.build_variants([(_build._CSRC / "broadcast.cu", flags)])[0]
    out = (ctypes.c_longlong * 2)()
    assert _build.entry(lib, "broadcast", "rt_fanout_plan")(n, out) == 0
    assert (bc.FANOUT_LAYOUTS[out[0]], out[1]) == (layout, cluster) == \
        fanout_plan(n, per_cta)
    member, bw, root, fanout, infl = _fanout_problem(min(n, 1000), 3,
                                                     "random")
    m = len(member)
    dev = [torch.as_tensor(a, device="cuda") for a in (member, bw, infl)]
    parent = torch.empty(m, dtype=torch.int32, device="cuda")
    order = torch.empty(m, dtype=torch.int32, device="cuda")
    cl = ctypes.c_int(0)
    err = _build.entry(lib, "broadcast")(
        dev[0].data_ptr(), dev[1].data_ptr(), dev[2].data_ptr(), m, root,
        fanout, parent.data_ptr(), order.data_ptr(), ctypes.addressof(cl),
        torch.cuda.current_stream().cuda_stream)
    assert err == 0
    want = bc.plan_fanout_plain(dev[0], dev[1], root, fanout, dev[2])
    assert torch.equal(parent, want[0]) and torch.equal(order, want[1])


def test_broadcast_kernel_rejects_what_it_does_not_take():
    from ray_tpu_torch.ops import broadcast_kernel as bc
    i32 = dict(dtype=torch.int32, device="cuda")
    member = torch.ones(5, dtype=torch.bool, device="cuda")
    bw = torch.ones((5, 5), **i32)
    infl = torch.zeros(5, **i32)
    with pytest.raises(ValueError, match="bw"):
        bc.plan_fanout(member, bw.to(torch.int64), 0, 2, infl)
    with pytest.raises(ValueError, match="member"):
        bc.plan_fanout(member.to(torch.int32), bw, 0, 2, infl)
    with pytest.raises(ValueError, match="inflight_kb"):
        bc.plan_fanout(member, bw, 0, 2, infl[:4])
    with pytest.raises(IndexError):
        bc.plan_fanout(member, bw, 5, 2, infl)
    big = torch.zeros(8193, dtype=torch.bool, device="cuda")
    with pytest.raises(ValueError, match="N=8193"):
        bc.plan_fanout(big, torch.zeros((8193, 8193), **i32), 0, 2,
                       torch.zeros(8193, **i32))


EDGE_CASES = ([("topk", c) for c in sorted(TOPK_EDGES)]
              + [("bundles", c) for c in BUNDLE_EDGES]
              + [("pulls", c) for c in PULL_EDGES]
              + [("broadcast", c) for c in BROADCAST_EDGES])


@pytest.mark.parametrize("program,case", EDGE_CASES)
def test_new_kernels_at_the_edges_equal_the_jax_function(program, case):
    """Each kernel, one launch, bit for bit against the JAX function on
    the edge problems its plain version is pinned to on the CPU: the
    contract's 8192 rows, every class infeasible, k past the feasible
    count, negative avail; holes in the valid mask, a group undone after
    a placed bundle, STRICT_PACK's clamp and its int32 wrap; ties, no
    holder, in-flight bytes across UNITs and past INT_MAX, divisors of 0
    and below; the broadcast plan's denominators of 0 and below, fan-out 0
    and past N, an unreachable member, uniform bandwidth, one node and a
    root that is not a member."""
    from ray_tpu.ops import broadcast_kernel as ref_bc
    from ray_tpu.ops import bundle_kernel as ref_bk
    from ray_tpu.ops import locality_kernel as ref_lk
    from ray_tpu.ops import pull_kernel as ref_pk
    from ray_tpu_torch.ops import bundle_kernel as bk
    from ray_tpu_torch.ops import locality_kernel as lk
    from ray_tpu_torch.ops import broadcast_kernel as bc
    from ray_tpu_torch.ops import pull_kernel as pk
    if program == "topk":
        make, k_abs, k_frac = TOPK_EDGES[case]
        p = make()
        args = (p["totals"], p["avail"], p["mask"], p["reqs"], p["counts"])
        kw = dict(group_masks=p["group_masks"], extra_mask=p["extra_mask"],
                  k_abs=k_abs, k_frac=k_frac)
        counter = lk.schedule_grouped_topk
        before = counter.launches
        got = lk.schedule_grouped_topk_np(*args, 5, 77, device="cuda", **kw)
        want = ref_lk.schedule_grouped_topk_np(*args, seed=5,
                                               round_index=77, **kw)
    elif program == "bundles":
        *prob, _oracle_agrees = _bundle_edge(case)
        counter = bk.schedule_bundle_groups
        before = counter.launches
        got = bk.schedule_bundle_groups_np(*prob, device="cuda")
        want = ref_bk.schedule_bundle_groups_np(*prob)
    elif program == "pulls":
        prob = _pull_edge(case)
        counter = pk.choose_sources
        before = counter.launches
        got = pk.choose_sources_np(*prob, device="cuda")
        want = ref_pk.choose_sources_np(*prob)
    else:
        prob = _broadcast_edge(case)
        counter = bc.plan_fanout
        before = counter.launches
        got = bc.plan_fanout_np(*prob, device="cuda")
        want = ref_bc.plan_fanout_np(*prob)
    assert counter.launches == before + 1
    for x, y in zip(got, want):
        np.testing.assert_array_equal(x, np.asarray(y))


def test_new_kernels_raise_when_the_build_fails(monkeypatch):
    """No fallback: with the build failing, a CUDA call raises and counts
    no launch (the CPU is never taken for a CUDA tensor)."""
    from ray_tpu_torch.ops import _build
    from ray_tpu_torch.ops import broadcast_kernel as bc
    from ray_tpu_torch.ops import bundle_kernel as bk
    from ray_tpu_torch.ops import locality_kernel as lk
    from ray_tpu_torch.ops import pull_kernel as pk

    def broken(*_a, **_k):
        raise RuntimeError("kernel build failed: forced")

    monkeypatch.setattr(_build, "load", broken)
    counters = (lk.schedule_grouped_topk, bk.schedule_bundle_groups,
                pk.choose_sources, bc.plan_fanout)
    before = [f.launches for f in counters]
    with pytest.raises(RuntimeError, match="forced"):
        lk.schedule_grouped_topk(*_topk_args(1, 50, 3, 4, "cuda", True))
    totals, avail, mask, reqs, valid, strat = _bundle_arrays(1, 30, 3, 2)
    with pytest.raises(RuntimeError, match="forced"):
        bk.schedule_bundle_groups(
            *[torch.as_tensor(a, device="cuda")
              for a in (totals, avail, mask, reqs)], valid, strat, 0)
    loc = torch.ones((3, 5), dtype=torch.bool, device="cuda")
    i32 = dict(dtype=torch.int32, device="cuda")
    with pytest.raises(RuntimeError, match="forced"):
        pk.choose_sources(loc, torch.ones((5, 5), **i32),
                          torch.zeros(3, **i32), torch.ones(3, **i32),
                          torch.zeros(5, **i32))
    with pytest.raises(RuntimeError, match="forced"):
        bc.plan_fanout(loc[0], torch.ones((5, 5), **i32), 0, 2,
                       torch.zeros(5, **i32))
    assert [f.launches for f in counters] == before


# -- the runtime on the card ---------------------------------------------------

def test_runtime_places_rounds_on_the_card():
    """init() with the default scheduler device (the GPU): a burst of
    tasks and a locality burst go through the delta beat and the
    localized kernel."""
    import ray_tpu_torch as rt
    from ray_tpu_torch.ops import hybrid_kernel as hk

    rt.init(resources={"CPU": 4, "memory": 4}, num_workers=2,
            system_config={"scheduler_device_batch_min": 2})
    try:
        from ray_tpu_torch.api import _get_runtime
        runtime = _get_runtime()
        assert runtime.cluster.scheduler_device.type == "cuda"
        runtime.cluster.add_node(resources={"CPU": 4, "memory": 4},
                                 num_workers=2)

        @rt.remote
        def add(a, b):
            return a + b

        head = runtime.raylet
        w0, d0 = hk.waterfill_scan.launches, head.delta_rounds
        assert rt.get([add.remote(i, 1) for i in range(300)]) == \
            [i + 1 for i in range(300)]
        # the burst's rounds went through the delta beat (no preference)
        assert head.delta_rounds > d0
        assert hk.waterfill_scan.launches > w0
        l0 = hk.waterfill_scan.localized_launches
        blob = rt.put(bytes(300_000))
        @rt.remote
        def size(b):
            return len(b)

        assert rt.get([size.remote(blob) for _ in range(40)]) == \
            [300_000] * 40
        assert hk.waterfill_scan.localized_launches > l0
        assert head.device_rounds > head.delta_rounds
    finally:
        rt.shutdown()


# -- the training libraries on the card ---------------------------------------

COLLECTIVE_OPS = [("allreduce", "sum"), ("allreduce", "max"),
                  ("allreduce", "min"), ("allreduce", "prod"),
                  ("allgather", None), ("reducescatter", "sum"),
                  ("reducescatter", "max"), ("reducescatter", "min"),
                  ("broadcast", 0), ("ring_shift", 1)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.int32])
@pytest.mark.parametrize("name,arg", COLLECTIVE_OPS)
def test_collectives_on_the_cards_equal_the_plain_version(name, arg, dtype):
    """Every op over every visible card (NCCL) against the plain
    stack-and-reduce on CPU ranks: exact, except float sum and product
    past one card (another order of accumulation)."""
    from ray_tpu_torch.util.collective import DeviceCollectiveGroup
    cards = DeviceCollectiveGroup()
    w = cards.world_size
    plain = DeviceCollectiveGroup(["cpu"] * w)
    g = torch.Generator().manual_seed(0)
    shape = (w, w, 33) if name == "reducescatter" else (w, 1000)
    x = (torch.randint(-5000, 5000, shape, generator=g, dtype=dtype)
         if dtype == torch.int32 else
         torch.rand(shape, generator=g) + 0.5)
    args = () if arg is None else (arg,)
    got = getattr(cards, name)(x.cuda(), *args)
    want = getattr(plain, name)(x, *args)
    assert got.device.type == "cuda" and got.dtype == want.dtype
    if arg in ("sum", "prod") and dtype == torch.float32 and w > 1:
        torch.testing.assert_close(got.cpu(), want, rtol=4e-7 * w,
                                   atol=1e-6)
    else:
        assert torch.equal(got.cpu(), want)
    parts = [x[r].cuda(r) for r in range(w)]
    listed = getattr(cards, name)(parts, *args)
    assert [p.device.index for p in listed] == list(range(w))
    assert torch.equal(torch.stack([p.cpu() for p in listed]), got.cpu())


def test_nccl_takes_each_card_once():
    from ray_tpu_torch.util.collective import DeviceCollectiveGroup
    with pytest.raises(ValueError, match="each device once"):
        DeviceCollectiveGroup(["cuda:0", "cuda:0"])


@pytest.mark.parametrize("opt", ["sgd", "adam"])
def test_mesh_step_on_the_card_equals_the_cpu(opt):
    """Three MeshTrainer steps of a small tanh MLP on the card against
    the same steps on the CPU (one rank each; f32, no TF32)."""
    from ray_tpu_torch.train import MeshTrainer
    rng = np.random.default_rng(0)
    params = {"w1": (0.3 * rng.normal(size=(16, 64))).astype(np.float32),
              "b1": np.zeros(64, np.float32),
              "w2": (0.3 * rng.normal(size=(64, 1))).astype(np.float32)}
    data = rng.normal(size=(3, 256, 17)).astype(np.float32)

    def loss(p, b):
        h = torch.tanh(b[:, :-1] @ p["w1"] + p["b1"])
        return torch.mean(((h @ p["w2"])[:, 0] - b[:, -1]) ** 2)

    make = (lambda ps: torch.optim.SGD(ps, lr=0.05)) if opt == "sgd" \
        else (lambda ps: torch.optim.Adam(ps, lr=1e-3))
    card = MeshTrainer(loss, params, optimizer=make)
    cpu = MeshTrainer(loss, params, optimizer=make, devices=["cpu"])
    assert card.devices[0].type == "cuda"
    for batch in data:
        np.testing.assert_allclose(card.step(batch), cpu.step(batch),
                                   rtol=1e-5, atol=1e-6)
    for k in params:
        assert card.params[k].device.type == "cuda"
        np.testing.assert_allclose(card.params[k].cpu().numpy(),
                                   cpu.params[k].numpy(), rtol=1e-5,
                                   atol=1e-6)


def test_pg_update_on_the_card_equals_the_cpu():
    from ray_tpu_torch.rllib import Algorithm, PGConfig
    rng = np.random.default_rng(1)
    params = {"w": (0.3 * rng.normal(size=(3, 4))).astype(np.float32),
              "b": np.zeros(4, np.float32)}
    obs = rng.normal(size=(200, 3)).astype(np.float32)
    batch = [torch.from_numpy(obs),
             torch.from_numpy(rng.integers(0, 4, size=200)),
             torch.from_numpy(rng.normal(size=200).astype(np.float32)),
             torch.ones(200)]
    out = []
    for dev in ("cuda", "cpu"):
        algo = Algorithm.__new__(Algorithm)
        algo.config = PGConfig(lr=0.3)
        update = algo._make_update()
        new = update({k: torch.from_numpy(v).to(dev)
                      for k, v in params.items()},
                     *(t.to(dev) for t in batch))
        out.append({k: v.cpu().numpy() for k, v in new.items()})
    for k in params:
        np.testing.assert_allclose(out[0][k], out[1][k], rtol=1e-6,
                                   atol=1e-6)


# -- the sharded paths on the card's ranks --------------------------------------

ONE_CARD_RANKS = ["cuda:0"] * 4


def _sharded_beat_case(ranks, mode, seed=13):
    """A port CRM of 300 nodes under churn, beat by a ShardedDeltaScheduler
    on ``ranks``, the single-device engine on the card and the CPU
    oracle: counts and budgets bit for bit every beat."""
    from ray_tpu_torch.common.ids import NodeID
    from ray_tpu_torch.common.resources import NodeResources, ResourceRequest
    from ray_tpu_torch.scheduling import (ClusterResourceManager,
                                          DeltaScheduler,
                                          ShardedDeltaScheduler,
                                          schedule_grouped_oracle)
    rng = np.random.default_rng(seed)
    crm = ClusterResourceManager(capacity=300)
    for _ in range(300):
        crm.add_node(NodeID.from_random(), NodeResources(
            {"CPU": int(rng.integers(2, 64)),
             "memory": int(rng.integers(1, 256))}))
    vecs = np.stack([crm.intern_request(ResourceRequest(
        {"CPU": int(rng.integers(1, 4)),
         "memory": float(rng.integers(0, 6))})) for _ in range(12)])
    counts = rng.integers(1, 400, size=12).astype(np.int32)
    eng = ShardedDeltaScheduler(crm, len(ranks), mode, devices=ranks)
    single = DeltaScheduler(crm)
    assert eng.device.type == "cuda" and eng.stats["shards"] == len(ranks)
    for beat in range(6):
        for _ in range(12):
            crm.force_subtract(int(rng.integers(0, 300)),
                               ResourceRequest({"CPU": 1}))
        ov = {5: np.array([-300, 40], np.int32)} if beat % 2 else None
        got = eng.beat(vecs, counts, overrides=ov)
        np.testing.assert_array_equal(got, single.beat(vecs, counts,
                                                       overrides=ov))
        np.testing.assert_array_equal(eng.last_budgets(),
                                      single.last_budgets())
        if ov is None:
            np.testing.assert_array_equal(
                got, schedule_grouped_oracle(crm.snapshot(), vecs, counts))
    assert eng.readbacks == 6 and eng.stats["delta_beats"] == 5


@pytest.mark.parametrize("mode", ["flat", "two_level"])
def test_sharded_beat_on_one_card_ranks(mode):
    _sharded_beat_case(ONE_CARD_RANKS, mode)


def _ring_case(ranks, causal):
    from ray_tpu_torch.ops.ring_attention import (full_attention,
                                                  ring_attention,
                                                  ulysses_attention)
    g = torch.Generator().manual_seed(3)
    q, k, v = (torch.randn((2, 256, 8, 64), generator=g).cuda()
               for _ in range(3))
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")      # TF32 on outside
    try:
        want = full_attention(q, k, v, causal, precision="highest")
        for fn in (ring_attention, ulysses_attention):
            got = fn(q, k, v, mesh=ranks, causal=causal,
                     precision="highest")
            assert got.device == q.device
            torch.testing.assert_close(got, want, atol=2e-5, rtol=0)
    finally:
        torch.set_float32_matmul_precision(prev)


@pytest.mark.parametrize("causal", [False, True])
def test_ring_and_ulysses_on_one_card_ranks(causal):
    _ring_case(ONE_CARD_RANKS, causal)


def test_sharded_wrappers_on_one_card_ranks():
    from ray_tpu_torch.ops import binpack_kernel as bk
    from ray_tpu_torch.ops import hybrid_kernel as hk
    from ray_tpu_torch.ops import locality_kernel as lk
    totals, avail, mask, reqs, counts, masks = _problem(5, 333, 6, 9,
                                                        neg=False)
    rng = np.random.default_rng(5)
    pref = rng.integers(-1, 333, size=9).astype(np.int32)
    ranks = ONE_CARD_RANKS
    for a, b in zip(hk.schedule_grouped_np(totals, avail, mask, reqs,
                                           counts, masks),
                    hk.schedule_grouped_sharded_np(
                        totals, avail, mask, reqs, counts, masks,
                        n_shards=4, devices=ranks)):
        np.testing.assert_array_equal(a, b)
    before = hk.waterfill_scan.localized_launches
    for a, b in zip(lk.schedule_grouped_localized_np(
            totals, avail, mask, reqs, counts, pref, masks),
            lk.schedule_grouped_localized_sharded_np(
                totals, avail, mask, reqs, counts, pref, masks,
                n_shards=4, devices=ranks)):
        np.testing.assert_array_equal(a, b)
    assert hk.waterfill_scan.localized_launches == before + 2
    for a, b in zip(lk.schedule_grouped_topk_np(
            totals, avail, mask, reqs, counts, 3, 1, masks, k_frac=0.25),
            lk.schedule_grouped_topk_sharded_np(
                totals, avail, mask, reqs, counts, 3, 1, masks,
                k_frac=0.25, n_shards=4, devices=ranks)):
        np.testing.assert_array_equal(a, b)
    caps = rng.integers(3000, 20000, size=(4, 6)).astype(np.int32)
    quotas = np.array([50, 0, 200, 7], np.int32)
    for a, b in zip(bk.autoscale_np(totals, avail, mask, reqs, counts, caps,
                                    quotas),
                    bk.autoscale_sharded_np(totals, avail, mask, reqs,
                                            counts, caps, quotas,
                                            n_shards=4, devices=ranks)):
        np.testing.assert_array_equal(a, b)


def test_raylet_sharded_state_on_one_card_launches_the_kernel(monkeypatch):
    """``scheduler_sharded_state`` with one rank on the card: the one-rank
    plane is the single-device call, so every round launches
    ``waterfill_scan``, and the rows equal the unsharded path's."""
    import ray_tpu_torch
    import ray_tpu_torch.cluster_utils as port_cluster
    from ray_tpu_torch.ops import hybrid_kernel as hk
    from ray_tpu_torch.ops import shard_reduce as sr
    from test_torch_runtime import _raylet_rows, _specs
    monkeypatch.setattr(sr, "local_ranks",
                        lambda device=None: [torch.device("cuda", 0)])
    rng = np.random.default_rng(5)
    node_res = [{"CPU": int(rng.integers(2, 16)),
                 "memory": int(rng.integers(2, 16))} for _ in range(13)]

    def batches_of(pkg):
        brng = np.random.default_rng(6)
        return [(_specs(pkg, brng, 300, 5), [None] * 300, [False] * 300)
                for _ in range(2)]

    rows = {}
    for sharded in (False, True):
        PortConfig.reset({"scheduler_device_batch_min": 1,
                          "scheduler_sharded_state": sharded})
        before = hk.waterfill_scan.launches
        rows[sharded], head = _raylet_rows(ray_tpu_torch, port_cluster,
                                           node_res, batches_of)
    assert head.device_rounds == 2 and head.delta_rounds == 0
    assert hk.waterfill_scan.launches >= before + 2
    assert rows[True] == rows[False]
    assert len(set(rows[True][0])) > 2          # the rounds spread


def test_sharded_paths_over_distinct_cards():
    """The NCCL route: the sharded beat and the ring over the first 2 or
    4 cards."""
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs two or more cards (the NCCL route)")
    ranks = [f"cuda:{i}" for i in range(4 if n >= 4 else 2)]
    _sharded_beat_case(ranks, "two_level" if len(ranks) == 4 else "flat")
    _ring_case(ranks, True)


def test_dryrun_multichip_on_one_card():
    from ray_tpu_torch import entry
    info = entry.dryrun_multichip(4, device="cuda:0")
    assert info["platform"] == "cuda" and info["cards"] == 1


# -- the sharded class scan: one shard_scan launch for ranks on one card ---------

def _shard_scan_case(s, mode, n, r, g, thr, require_available, masks,
                     seed=0):
    """``shard_scan`` against ``shard_scan_plain`` (the scan rank by rank
    over the plane's transport) on the same per-rank tensors of one card:
    alloc rows, inf and the carried avail bit for bit."""
    from ray_tpu_torch.ops import shard_reduce as sr
    totals, avail, mask, reqs, counts, gmasks = _problem(seed + s, n, r, g)
    plane = sr.plane_for(s, mode, ["cuda:0"] * s)
    assert plane.scan_route == "shard_scan"

    def rows(a):
        return [torch.as_tensor(np.ascontiguousarray(b), device="cuda")
                for b in np.split(a, s)]

    def repl(a):
        return [torch.as_tensor(a, device="cuda")] * s

    gm = None
    if masks:
        gm = [torch.as_tensor(np.ascontiguousarray(b), device="cuda")
              for b in np.split(gmasks, s, axis=1)]
    args = (rows(totals), rows(avail), rows(mask), repl(reqs), repl(counts),
            gm, thr, require_available)
    before = sr.shard_scan.launches
    ka, ki, kv = sr.shard_scan(*args)
    assert sr.shard_scan.launches == before + 1
    pa, pi, pv = sr.shard_scan_plain(plane.transport, *args)
    for x, y in zip(ka, pa):
        assert torch.equal(x, y)
    assert torch.equal(ki, pi)
    for x, y in zip(kv, pv):
        assert torch.equal(x, y)
    return sr.shard_scan.last_layout, ka


def _assert_route(lay, s, n):
    """The plan's route: every rank in one thread-block cluster where
    their CTAs make at most 16 (the beat cell's 1024 rows at S = 2 / 4 /
    8; 8192 rows at S = 2), else the global route (no cluster, the
    exchange areas in global memory)."""
    ctas = max(1, min(8, n // s // 128))
    assert lay["rank_ctas"] == ctas
    if s * ctas <= 16:
        assert lay["route"] == "cluster" and lay["cluster"] == s * ctas
        assert lay["exchange_ints"] == 0
    else:
        assert lay["route"] == "global" and lay["cluster"] == 1
        assert lay["exchange_ints"] > 0
    assert lay["resident_ranks"] >= s


@pytest.mark.parametrize("s,mode", [(2, "flat"), (4, "two_level"),
                                    (4, "flat"), (8, "flat"),
                                    (8, "two_level")])
@pytest.mark.parametrize("n,r,g", [(1024, 8, 64), (8192, 16, 128)])
@pytest.mark.parametrize("thr", [SCALE // 2, 2 * SCALE + 1])
def test_shard_scan_equals_plain(s, mode, n, r, g, thr):
    """The beat cell's 1000 x 64 (rows padded to 1024, as the engine
    pads them) on the cluster route at every S, and the contract's 8192 x
    16 x 128: the cluster route at S = 2 (16 CTAs of 512 rows), the
    global route at S = 4 and 8."""
    lay, alloc = _shard_scan_case(s, mode, n, r, g, thr, False, False)
    _assert_route(lay, s, n)
    assert lay["route"] == ("cluster" if n == 1024 or s == 2 else "global")
    assert sum(int(a.sum()) for a in alloc) > 0


@pytest.mark.parametrize("s,mode", [(2, "flat"), (4, "two_level"),
                                    (8, "flat")])
@pytest.mark.parametrize("require_available", [False, True])
def test_shard_scan_group_masks_and_require_available(s, mode,
                                                      require_available):
    lay, _ = _shard_scan_case(s, mode, 8192, 16, 128, SCALE // 2,
                              require_available, True, seed=1)
    _assert_route(lay, s, 8192)
    lay, _ = _shard_scan_case(s, mode, 1024, 8, 64, SCALE // 2,
                              require_available, True, seed=2)
    _assert_route(lay, s, 1024)


@pytest.mark.parametrize("s,mode", [(32, "flat"), (64, "two_level")])
def test_shard_scan_past_32_ranks(s, mode):
    """More ranks than a warp has lanes: each lane of the reading warp
    takes several ranks' slots (and the lower ranks' prefix) in turn."""
    lay, alloc = _shard_scan_case(s, mode, 8192, 16, 8, SCALE // 2, False,
                                  True, seed=3)
    assert lay["rank_ctas"] == max(1, 8192 // s // 128)
    assert lay["route"] == "global" and lay["cluster"] == 1
    assert sum(int((a > 0).any()) for a in alloc) > s // 2


@pytest.mark.parametrize("n,r", [(8192, 128), (4096, 512)])
def test_shard_scan_rows_off_chip(n, r):
    """Rows too wide for 16 CTAs' shared memory a rank stay in global
    memory (totals read there, avail carried in new_avail); 32 CTAs take
    the global route."""
    lay, _ = _shard_scan_case(2, "flat", n, r, 8, SCALE // 2, False, True)
    assert lay["on_chip"] == 0 and lay["rank_ctas"] == 16
    assert lay["route"] == "global"


def test_shard_scan_is_one_launch_a_scan_of_the_sharded_beat():
    """A sharded beat on ranks of one card: the class scan is one
    ``shard_scan`` launch a beat and makes no transport call; the beats
    stay equal to the single-device engine's."""
    from ray_tpu_torch.common.ids import NodeID
    from ray_tpu_torch.common.resources import NodeResources, ResourceRequest
    from ray_tpu_torch.ops import shard_reduce as sr
    from ray_tpu_torch.scheduling import (ClusterResourceManager,
                                          DeltaScheduler,
                                          ShardedDeltaScheduler)
    rng = np.random.default_rng(21)
    crm = ClusterResourceManager(capacity=500)
    for _ in range(500):
        crm.add_node(NodeID.from_random(), NodeResources(
            {"CPU": int(rng.integers(2, 64)),
             "memory": int(rng.integers(1, 256))}))
    vecs = np.stack([crm.intern_request(ResourceRequest(
        {"CPU": int(rng.integers(1, 4)),
         "memory": float(rng.integers(0, 6))})) for _ in range(16)])
    counts = rng.integers(1, 900, size=16).astype(np.int32)
    eng = ShardedDeltaScheduler(crm, 4, "two_level", devices=["cuda:0"] * 4)
    single = DeltaScheduler(crm)
    scan = sr.ShardPlane._scan
    calls = []

    def counted(pl, *a):
        c0 = pl.transport.calls
        out = scan(pl, *a)
        calls.append(pl.transport.calls - c0)
        return out

    sr.ShardPlane._scan = counted
    try:
        for _ in range(4):
            for _ in range(12):
                crm.force_subtract(int(rng.integers(0, 500)),
                                   ResourceRequest({"CPU": 1}))
            np.testing.assert_array_equal(eng.beat(vecs, counts),
                                          single.beat(vecs, counts))
    finally:
        sr.ShardPlane._scan = scan
    assert calls == [0] * 4
    assert eng.scan_stats["route"] == "shard_scan"
    assert eng.scan_stats["shard_scan_launches"] == 4


def test_shard_scan_grouped_sharded_np_equals_single_device():
    from ray_tpu_torch.ops import hybrid_kernel as hk
    from ray_tpu_torch.ops import shard_reduce as sr
    totals, avail, mask, reqs, counts, masks = _problem(9, 1000, 8, 64,
                                                        neg=False)
    want = hk.schedule_grouped_np(totals, avail, mask, reqs, counts, masks)
    before = sr.shard_scan.launches
    got = hk.schedule_grouped_sharded_np(totals, avail, mask, reqs, counts,
                                         masks, n_shards=4,
                                         devices=["cuda:0"] * 4)
    assert sr.shard_scan.launches == before + 1
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_shard_scan_mesh_too_large_to_be_resident_raises():
    """256 ranks of 32 rows x 512 columns: a CTA a rank whose shared
    memory leaves room for one CTA an SM, so the card cannot hold every
    rank at once and the ranks would wait forever: ValueError, before any
    launch."""
    from ray_tpu_torch.ops import shard_reduce as sr
    s, n_l, r = 256, 32, 512
    plan = sr.shard_scan_plan(s, n_l, r)
    assert plan["cluster"] == 1 and plan["resident_ranks"] < s
    assert plan["route"] == "global" and plan["rank_ctas"] == 1
    z = torch.zeros((n_l, r), dtype=torch.int32, device="cuda")
    m = torch.ones((n_l,), dtype=torch.bool, device="cuda")
    reqs = torch.ones((2, r), dtype=torch.int32, device="cuda")
    cnt = torch.ones((2,), dtype=torch.int32, device="cuda")
    before = sr.shard_scan.launches
    with pytest.raises(ValueError, match="resident"):
        sr.shard_scan([z] * s, [z] * s, [m] * s, [reqs] * s, [cnt] * s,
                      None, SCALE // 2)
    assert sr.shard_scan.launches == before
    # the largest mesh the card holds at that shape runs
    fits = plan["resident_ranks"]
    sr.shard_scan([z] * fits, [z] * fits, [m] * fits, [reqs] * fits,
                  [cnt] * fits, None, SCALE // 2)
    torch.cuda.synchronize()
