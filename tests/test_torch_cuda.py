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
                 1, 64, 2, d, 2, 0, ctypes.c_float(1.0),
                 torch.cuda.current_stream().cuda_stream)
        assert err != 0, d
    x = torch.randn((1, 64, 2, 300), device="cuda", dtype=torch.bfloat16)
    assert flash_attention(x, x, x).shape == x.shape


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


# head dims past 256: the wide kernel (the head dim in chunks of 64)
FLASH_WIDE_DIMS = [288, 320, 384, 512]


@pytest.mark.parametrize("d", FLASH_WIDE_DIMS)
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_kernel_wide_head_dims(d, causal, dtype):
    """Head dims past 256 on the wide kernel, against the plain version
    within the limit, which must still reject a dropped key tile."""
    test_flash_kernel_every_head_dim(d, causal, dtype)


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
