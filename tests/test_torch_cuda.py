"""The port's CUDA kernels on the card (marker ``cuda``).

Each test needs a GPU and skips without one; on the GPU machine run

    python -m pytest tests/test_torch_cuda.py -q

The kernels are held against their plain PyTorch versions (and the
scheduler against the JAX reference on the CPU) at small shapes:
``waterfill_scan`` bit for bit, ``flash_attention`` within the stated
tolerances.  ``chip_smoke.py`` repeats this at the main paths' shapes."""

import numpy as np
import pytest
import torch

from ray_tpu_torch.common.config import Config as PortConfig

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
    assert got.dtype == dtype and got.shape == q.shape
    ratio = _flash_err_over_limit(got, q, k, v, causal)
    assert ratio <= 1.0, ratio


@pytest.mark.parametrize("dtype,causal,shape", FLASH_CASES)
def test_flash_limit_rejects_a_dropped_key_tile(dtype, causal, shape):
    """The limit above fails a kernel that skips its last 64-key tile."""
    import math
    q, k, v = _flash_inputs(dtype, shape)
    t = shape[1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float() / math.sqrt(shape[3]),
                     k.float())
    dead = torch.zeros((t, t), dtype=torch.bool, device="cuda")
    dead[:, t - 64:] = True
    if causal:
        dead |= torch.ones_like(dead).triu(1)
    p = torch.softmax(s.masked_fill(dead, float("-inf")), dim=-1)
    faulty = torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(dtype)
    assert _flash_err_over_limit(faulty, q, k, v, causal) > 1.0


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_kernel_takes_more_than_65535_heads(dtype):
    """B*H = 66560 (query tiles and b*h share gridDim.x)."""
    from ray_tpu_torch.ops import flash_attention
    shape = (1024, 64, 65, 64)
    q, k, v = _flash_inputs(dtype, shape)
    got = flash_attention(q, k, v)
    assert _flash_err_over_limit(got, q, k, v, False) <= 1.0


def test_flash_kernel_rejects_other_head_dims():
    """Head dims up to 256 pad to a kernel width (below); past 256 the
    kernel has none and the wrapper raises."""
    from ray_tpu_torch.ops import flash_attention
    q = torch.zeros((1, 64, 2, 320), device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention(q, q, q)


FLASH_HEAD_DIMS = [16, 32, 80, 96, 160, 256]


@pytest.mark.parametrize("d", FLASH_HEAD_DIMS)
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_kernel_every_head_dim(d, causal, dtype):
    """Every head dim up to 256, against the plain version within the
    limit, which must still reject a dropped key tile at that dim."""
    import math
    from ray_tpu_torch.ops import flash_attention
    shape = (2, 384, 3, d)
    q, k, v = _flash_inputs(dtype, shape)
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=causal)
    assert flash_attention.launches == before + 1
    assert got.shape == q.shape and got.dtype == dtype
    assert _flash_err_over_limit(got, q, k, v, causal) <= 1.0
    t = shape[1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float() / math.sqrt(d), k.float())
    dead = torch.zeros((t, t), dtype=torch.bool, device="cuda")
    dead[:, t - 64:] = True
    if causal:
        dead |= torch.ones_like(dead).triu(1)
    p = torch.softmax(s.masked_fill(dead, float("-inf")), dim=-1)
    faulty = torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(dtype)
    assert _flash_err_over_limit(faulty, q, k, v, causal) > 1.0


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
