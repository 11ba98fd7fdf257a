// The grouped water-fill scan of the scheduling heartbeat, by hand for
// Hopper (sm_90a).
//
// Replaces: the lax.scan over scheduling classes in
//   ray_tpu/ops/hybrid_kernel.py::schedule_grouped (its scan) and
//   ray_tpu/ops/hybrid_kernel.py::fused_beat (its scan), whose body is
//   ray_tpu/ops/hybrid_kernel.py::_schedule_group with the 15-step
//   bisection of _slots_at_or_below; and, given pref_rows, the lax.scan
//   of ray_tpu/ops/locality_kernel.py::schedule_grouped_localized (the
//   localized mode below).
// Semantics: scheduling/contract.py, bit for bit in int32.
//
// What bounds it on this card: neither bytes nor operations.  The scan is
// a chain of G classes, each a chain of dependent cross-row reductions
// over <= 8192 rows (capacity, the bisection's sums, base, an exclusive
// scan, the overflow argmin).  The work is a few MB of int32 arithmetic;
// the time is the latency of that chain, so the design shortens it and
// makes each link cheap:
//
//   * Rows over a thread-block cluster.  plan() picks the cluster size
//     from N and the shared memory the rows need; CTA k owns rows
//     [k*blockDim, (k+1)*blockDim), one row per thread.  Each cross-row
//     step is a warp reduction, one CTA-level combine, a push of the CTA's
//     partials into every CTA's shared memory (distributed shared memory),
//     one barrier.cluster, and local reads; every CTA then holds the same
//     totals.  Contiguous ranges keep
//     the level-L* hand-out in row order: a CTA's prefix is the sum of the
//     lower ranks' totals.
//   * State on chip.  totals and the carried avail live in shared memory
//     (column-major, so a warp's loads hit 32 banks) for all G classes;
//     new_avail is written once at the end, each class's counts once.
//     Where a CTA's rows do not fit even at 16 CTAs (R above 37 at 8192
//     nodes), the first `rs` columns stay in shared memory and the rest
//     of each row is read from totals and carried in new_avail, which
//     each thread owns row by row; used*SCALE + 1 is then kept for the
//     class's first 8 requested columns and recomputed beyond them.  Such
//     a launch runs its own instantiation (kSpill), so the launches that
//     fit pay nothing for it.  Where even the class arrays (10R + 2 ints)
//     do not fit one CTA's shared memory (R > 5743 on an H100), they live
//     in a global scratch buffer, one copy per CTA, and each class's
//     request is read from group_reqs directly (kGlobalCls; row offsets
//     are 64-bit there, as row * R can pass 2**31).
//   * Invariants hoisted.  Per class the positive-request columns are
//     compacted (the loops run over ~2 columns, not R); per (row, column)
//     used*SCALE + 1 is computed once; per column the class's q*SCALE gets
//     an exact reciprocal (floordiv_rcp), so no bisection level divides.
//   * Fewer dependent steps.  The search evaluates 7 levels per round and
//     reduces their 7 sums in one exchange: 5 rounds instead of 15 steps.
//     The first round also carries the capacity sum and the previous
//     class's argmin (its overflow node does not change avail, so it can
//     wait a class).  Per class: 5 search rounds + 1 base/scan round.
//
// Why the k-level search is exact.  The 15-step rule (lo = 0, hi =
// 2*SCALE; mid = (lo+hi)>>1; ok(mid) -> hi = mid else lo = mid + 1)
// returns the smallest L in [0, 2*SCALE] with sum m(L) >= n_avail, and
// 2*SCALE+1 when there is none, PROVIDED sum m(L) is non-decreasing in L:
// its interval halves 14 times to one point and the 15th step moves past
// 2*SCALE only if that level fails.  Within the contract (totals and
// requests <= MAX_TOTAL_CU = 2**17) m(L) is non-decreasing: rows with
// m_max = 0 give 0 at every level; a row with m_max > 0 has a >= q > 0 in
// every requested column, so used <= t <= 2**17, and for thr_fp <=
// 2*SCALE + 1 (L+1)*t <= 8193 * 2**17 < 2**31 cannot wrap, while for
// larger thr_fp every level in [0, 2*SCALE+1] maps to the same lp1 and
// m(L) is constant.  Each round below keeps the invariant "the answer is
// in [lo, hi] and hi is ok or the sentinel 2*SCALE+1", probes lo + j*s - 1
// (j = 1..7, s = ceil((hi-lo)/8)) and keeps the first ok sub-interval, so
// it returns the same smallest ok level, or 2*SCALE+1 when no level in
// [0, 2*SCALE] suffices.  tests/test_torch_waterfill_search.py holds a
// numpy model of this arithmetic to the 15-step bisection.
//
// The localized mode (pref_rows given, kPref): a class with a preferred
// row p >= 0 places its whole count on p when p is feasible for it
// (totals >= the request on every requested column, p in node_mask and
// in the class's mask), consuming only what p's avail allows, and the
// water-fill places the rest (count - m, m = count or 0).  Feasibility
// reads only constant inputs (totals, masks), so warp 0 decides it while
// it sets up the class, and every CTA knows m without an exchange: the
// class costs the same rounds as any other.  The thread that owns p
// debits p's carried avail before the class's capacity is taken, and
// adds m to p's count at the end.  Launches without pref_rows run the
// instantiations without this code.
//
// Exactness otherwise: all int32 arithmetic wraps like XLA's (done in
// uint32 and cast back: signed overflow is undefined in C++), floor
// division floors like numpy/XLA `//` (CUDA `/` truncates), reductions
// start from the same `initial=` values as the JAX code and are wrapping
// sums in any order (the same bits modulo 2**32), ties break to the
// lowest row, and an all-INFEASIBLE argmin gives row 0 as jnp.argmin.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

#include "contract.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace rt;

constexpr int kTop = 2 * kScale + 1;     // the search's "no level" answer
constexpr int kProbes = 7;               // levels per search round
constexpr int kVals = kProbes + 1;       // ints exchanged per round
constexpr int kMaxThreads = 1024;
constexpr int kRowsPerCta = 128;         // the cluster doubles above this
constexpr int kPortableCluster = 8;      // every Hopper card schedules 8
constexpr int kMaxCluster = 16;          // H100 allows 16 on request
constexpr int kSpillU1 = 8;              // used*SCALE+1 columns kept on chip
                                         // when the rows spill
__device__ __forceinline__ int clip(int x, int lo, int hi) {
  return min(max(x, lo), hi);
}
// floor(x / d) for a divisor d >= 1 by its reciprocal: with l =
// ceil(log2 d), m = ceil(2**(31+l) / d) < 2**32 and sh = 31 + l,
// floor(u / d) = (u * m) >> sh for every 0 <= u < 2**31 (Granlund and
// Montgomery, Thm 4.2), and floor(x / d) = ~floor(~x / d) for x < 0.
__device__ __forceinline__ int floordiv_rcp(int x, unsigned m, int sh) {
  const unsigned u = x >= 0 ? (unsigned)x : ~(unsigned)x;
  const unsigned q = (unsigned)(((unsigned long long)u * m) >> sh);
  return x >= 0 ? (int)q : (int)~q;
}

struct Shared {
  int warp_vals[kVals][32];
  unsigned long long warp_min[32];
  // each CTA pushes its partials into slot [its rank] of every CTA of the
  // cluster, by round parity: after the barrier every read is local
  int slot[2][kMaxCluster][kVals];
  unsigned long long slot_min[2][kMaxCluster];
  int woff[32];                        // exclusive scan offsets of the warps
  int npos[2], count[2];               // the class's, by class parity
  int pref[2], m[2];                   // preferred row (-1: none) and the
                                       // count it takes (localized mode)
};

__device__ __forceinline__ unsigned warp_sum(unsigned x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

// Warp 0, every lane holding this CTA's totals: store them into slot
// [rank] of every CTA of the cluster (lane k writes CTA k's).
template <int NV>
__device__ __forceinline__ void push(Shared& sh, int parity,
                                     const unsigned (&x)[NV],
                                     unsigned long long mn) {
  cg::cluster_group cl = cg::this_cluster();
  const int lane = threadIdx.x & 31, rank = (int)cl.block_rank();
  if (lane < (int)cl.num_blocks()) {
    int* dst = cl.map_shared_rank(&sh.slot[parity][rank][0], lane);
#pragma unroll
    for (int v = 0; v < NV; ++v) dst[v] = (int)x[v];
    *cl.map_shared_rank(&sh.slot_min[parity][rank], lane) = mn;
  }
}

// After the cluster barrier, in every warp: the slots summed over all
// ranks, and over the ranks below this one (kLow), and their min.
template <int NV, bool kLow>
__device__ __forceinline__ void combine(const Shared& sh, int parity,
                                        unsigned (&all)[NV],
                                        unsigned (&low)[NV],
                                        unsigned long long& mn) {
  cg::cluster_group cl = cg::this_cluster();
  const int lane = threadIdx.x & 31, rank = (int)cl.block_rank();
  const bool on = lane < (int)cl.num_blocks();
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    const unsigned x = on ? (unsigned)sh.slot[parity][lane][v] : 0u;
    all[v] = warp_sum(x);
    if (kLow) low[v] = warp_sum(lane < rank ? x : 0u);
  }
  mn = warp_min(on ? sh.slot_min[parity][lane] : kNoKey);
}

// Cluster-wide wrapping sums of vals[] and min of mn: every thread of
// every CTA calls it and gets the results in all[] and mn_all.
__device__ void exchange(Shared& sh, int& parity, const int (&vals)[kVals],
                         unsigned long long mn, unsigned (&all)[kVals],
                         unsigned long long& mn_all) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  unsigned u[kVals];
#pragma unroll
  for (int v = 0; v < kVals; ++v) u[v] = warp_sum((unsigned)vals[v]);
  mn = warp_min(mn);
  if (lane == 0) {
#pragma unroll
    for (int v = 0; v < kVals; ++v) sh.warp_vals[v][warp] = (int)u[v];
    sh.warp_min[warp] = mn;
  }
  __syncthreads();
  if (warp == 0) {
    unsigned x[kVals];
#pragma unroll
    for (int v = 0; v < kVals; ++v)
      x[v] = warp_sum(lane < nw ? (unsigned)sh.warp_vals[v][lane] : 0u);
    push<kVals>(sh, parity, x,
                warp_min(lane < nw ? sh.warp_min[lane] : kNoKey));
  }
  cg::this_cluster().sync();
  unsigned low[kVals];
  combine<kVals, false>(sh, parity, all, low, mn_all);
  parity ^= 1;
}

// The class's per-column data: compacted positive requests
struct Cls {
  int npos;
  const int* col;          // resource column
  const int* q;            // request
  const unsigned* rm;      // reciprocal of max(q * SCALE, 1)
  const int* rs;           // its shift
};

// This thread's row: columns below rs in shared memory (column-major,
// stride nt), the rest in global memory (totals; the carried avail in
// new_avail).  used*SCALE + 1 of the class's requested column p is in
// shared memory for p < nu1.  Only live rows touch the global part.
// Without kSpill every column is on chip (rs = nu1 = r) and the checks
// compile away: the launches that fit keep their registers for the
// search.
template <bool kSpill, typename Off>
struct Row {
  const int* s_t;          // the kernel's shared arrays, as laid out
  int* s_a;
  const int* s_u1;
  const int* totals;       // the kernel's arguments, as given
  int* new_avail;
  Off base;                // row * r: int while the class arrays fit
                           // (r <= 5743), 64-bit past that
  int nt, tid, rs, nu1;
  __device__ __forceinline__ int t(int c) const {
    return !kSpill || c < rs ? s_t[c * nt + tid] : totals[base + c];
  }
  __device__ __forceinline__ int a(int c) const {
    return !kSpill || c < rs ? s_a[c * nt + tid] : new_avail[base + c];
  }
  __device__ __forceinline__ void set_a(int c, int v) const {
    if (!kSpill || c < rs) s_a[c * nt + tid] = v;
    else new_avail[base + c] = v;
  }
  __device__ __forceinline__ int u1(int p, int c, int t) const {
    return !kSpill || p < nu1 ? s_u1[p * nt + tid]
                              : wadd(wmul(wsub(t, a(c)), kScale), 1);
  }
};

// m(L) for K levels of this thread's row (_slots_at_or_below): slots with
// eff-score key <= L, levels below thr_fp collapsing onto the level-0 count
template <int K, bool kSpill, typename Off>
__device__ __forceinline__ void slots_at(const int (&lv)[K], int m_max,
                                         const Cls& cls,
                                         const Row<kSpill, Off>& rw,
                                         int thr_fp, int (&out)[K]) {
  int lp1[K], jc[K];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    lp1[j] = (lv[j] < thr_fp ? thr_fp - 1 : lv[j]) + 1;
    jc[j] = kBig;                        // where(req_pos, jc, BIG).min()
  }
  if (m_max > 0) {                       // else 0 at every level
    for (int p = 0; p < cls.npos; ++p) {
      const int t = rw.t(cls.col[p]);
      const int u1 = rw.u1(p, cls.col[p], t);   // used * SCALE + 1
      const unsigned m = cls.rm[p];
      const int sh = cls.rs[p];
#pragma unroll
      for (int j = 0; j < K; ++j)
        jc[j] = min(jc[j],
                    clip(floordiv_rcp(wsub(wmul(lp1[j], t), u1), m, sh), 0,
                         kBig));
    }
  }
#pragma unroll
  for (int j = 0; j < K; ++j) out[j] = min(m_max, jc[j]);
}

// Warp 0: copy class gi's request row and count into staging buffer
// gi & 1 (cp.async: the copy overlaps the class before it).
__device__ __forceinline__ void stage_class(int* s_stage, int gi, int r,
                                            const int* group_reqs,
                                            const int* group_counts) {
  int* dst = s_stage + (gi & 1) * (r + 1);
  for (int c = threadIdx.x; c <= r; c += 32) {
    const int* src = c < r ? group_reqs + (size_t)gi * r + c : group_counts + gi;
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                     (unsigned)__cvta_generic_to_shared(dst + c)),
                 "l"(src)
                 : "memory");
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// The kernel's inputs that stay fixed for the whole launch
struct Inputs {
  const int* totals;
  const uint8_t* node_mask;
  const int* group_reqs;
  const int* group_counts;
  const uint8_t* group_masks;
  const int* pref_rows;
  int n, r, g;
};

// Warp 0: compact class gi's request (staged in shared memory, or read
// from group_reqs with kGlobalCls) into the class arrays of parity gi & 1
// (positive columns with their reciprocals), decide its preferred row
// (kPref), then stage class gi + 1.  The arrays are read after the next
// CTA or cluster barrier.
template <bool kGlobalCls, bool kPref>
__device__ __forceinline__ void setup_class(Shared& sh, int* s_stage, int* s_col, int* s_q,
                            unsigned* s_rm, int* s_rs, int gi,
                            const Inputs& in) {
  const int lane = threadIdx.x, cb = gi & 1, r = in.r;
  const int* req;
  int count;
  if constexpr (kGlobalCls) {
    req = in.group_reqs + (size_t)gi * r;
    count = in.group_counts[gi];
  } else {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncwarp();
    req = s_stage + cb * (r + 1);
    count = req[r];
  }
  int npos = 0;
  for (int c0 = 0; c0 < r; c0 += 32) {
    const int c = c0 + lane;
    const int q = c < r ? req[c] : 0;
    const unsigned pos = __ballot_sync(kFull, q > 0);
    if (q > 0) {
      const int p = cb * r + npos + __popc(pos & ((1u << lane) - 1u));
      const unsigned d = (unsigned)max(wmul(q, kScale), 1);
      const int l = 32 - __clz((int)(d - 1u));   // ceil(log2 d)
      s_col[p] = c;
      s_q[p] = q;
      s_rm[p] = (unsigned)(((1ull << (31 + l)) + d - 1u) / d);
      s_rs[p] = 31 + l;
    }
    npos += __popc(pos);
  }
  int pref = -1, m = 0;
  if constexpr (kPref) {
    const int pr = in.pref_rows[gi];
    if (pr >= 0) {                       // p = clip(pref, 0, N - 1)
      const int p = clip(pr, 0, in.n - 1);
      const int* tp = in.totals + (size_t)p * r;
      bool feas = true;
      for (int c = lane; c < r; c += 32) {
        const int q = req[c];
        feas = feas && !(q > 0 && tp[c] < q);
      }
      feas = __all_sync(kFull, feas) && in.node_mask[p] != 0 &&
             (in.group_masks == nullptr ||
              in.group_masks[(size_t)gi * in.n + p] != 0);
      m = feas ? count : 0;              // the whole class, or none of it
      pref = m != 0 ? p : -1;            // m = 0 changes nothing
    }
  }
  if (lane == 0) {
    sh.npos[cb] = npos;
    sh.count[cb] = count;
    sh.pref[cb] = pref;
    sh.m[cb] = m;
  }
  if constexpr (!kGlobalCls)
    if (gi + 1 < in.g)
      stage_class(s_stage, gi + 1, r, in.group_reqs, in.group_counts);
}

// kSpill: rows partly in global memory; kGlobalCls: the class arrays too
// (implies kSpill); kPref: the localized mode.  Only the instantiations
// kernel_for() names are compiled.
template <bool kSpill, bool kGlobalCls, bool kPref>
__global__ void __launch_bounds__(kMaxThreads)
waterfill_cluster_kernel(const int* __restrict__ totals,
                         const int* __restrict__ avail,
                         const uint8_t* __restrict__ node_mask,
                         const int* __restrict__ group_reqs,
                         const int* __restrict__ group_counts,
                         const uint8_t* __restrict__ group_masks,
                         const int* __restrict__ pref_rows,
                         int* __restrict__ counts, int* __restrict__ new_avail,
                         int* __restrict__ scratch,
                         int n, int r, int g, int thr_fp,
                         int require_available, int rs_spill,
                         int nu1_spill) {
  using Off = typename std::conditional<kGlobalCls, size_t, int>::type;
  __shared__ Shared sh;
  extern __shared__ int dyn[];
  cg::cluster_group cl = cg::this_cluster();
  const int nt = blockDim.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, nw = nt >> 5;
  const int rank = (int)cl.block_rank();
  const int row = rank * nt + tid;
  const bool live = row < n;

  // column-major with stride nt: totals and the carried avail (rs
  // columns each), used*SCALE + 1 of the class's first nu1 positive
  // columns; then the class arrays, by class parity, and two staging
  // rows of R + 1 (request, count) -- or, with kGlobalCls, the class
  // arrays in this CTA's part of scratch (8R ints) and no staging
  int* s_t = dyn;
  // without kSpill every column is on chip: r (a kernel argument) rather
  // than a value the class loop would keep live
  const int rs = kSpill ? rs_spill : r, nu1 = kSpill ? nu1_spill : r;
  int* s_a = s_t + rs * nt;
  int* s_u1 = s_a + rs * nt;
  int* s_col = kGlobalCls ? scratch + (size_t)rank * 8 * r
                          : s_u1 + nu1 * nt;       // [2][r]
  int* s_q = s_col + 2 * r;              // [2][r]
  unsigned* s_rm = (unsigned*)(s_q + 2 * r);
  int* s_rs = (int*)(s_rm + 2 * r);
  int* s_stage = s_rs + 2 * r;           // [2][r + 1], unused by kGlobalCls
  const Inputs in{totals, node_mask, group_reqs, group_counts, group_masks,
                  pref_rows, n, r, g};

  if (warp == 0 && g > 0) {
    if constexpr (!kGlobalCls)
      stage_class(s_stage, 0, r, group_reqs, group_counts);
    setup_class<kGlobalCls, kPref>(sh, s_stage, s_col, s_q, s_rm, s_rs, 0,
                                   in);
  }
  const Row<kSpill, Off> rw{s_t, s_a, s_u1, totals, new_avail,
                            kSpill && live ? (Off)row * r : (Off)0, nt, tid,
                            rs, nu1};
  for (int c = 0; c < rs; ++c) {
    s_t[c * nt + tid] = live ? totals[(size_t)row * r + c] : 0;
    s_a[c * nt + tid] = live ? avail[(size_t)row * r + c] : 0;
  }
  if (kSpill && live)
    for (int c = rs; c < r; ++c)
      new_avail[(size_t)row * r + c] = avail[(size_t)row * r + c];
  const bool nmask = live && node_mask[row] != 0;
  bool gmask = group_masks == nullptr || !live || g == 0 ||
               group_masks[row] != 0;
  // the block's barrier, and every CTA of the cluster has started before
  // the first class writes into its shared memory
  cl.sync();

  int parity = 0;
  // the last class's allocation and overflow, until its argmin is known
  int prev_alloc = 0, prev_over = 0;
  unsigned long long best = kNoKey;      // this row's packed overflow key

  auto resolve = [&](int gi, unsigned long long key_min) {
    const int onode = (int)(key_min & 0xffffffffull);
    const int okey = (int)((unsigned)(key_min >> 32) ^ 0x80000000u);
    const bool infeasible = okey == kInfKey;
    int ocol = infeasible ? n : onode;
    if (require_available) {
      const bool o_avail = ((okey >> kAvailShift) & 1) == 0;
      ocol = (infeasible || !o_avail) ? n : onode;
    }
    int* crow = counts + (size_t)gi * (n + 1);
    if (live && row == ocol) crow[row] = wadd(prev_alloc, prev_over);
    if (rank == 0 && tid == 0) crow[n] = ocol == n ? prev_over : 0;
  };

  for (int gi = 0; gi < g; ++gi) {
    const int cb = gi & 1;
    const Cls cls{sh.npos[cb], s_col + cb * r, s_q + cb * r, s_rm + cb * r,
                  s_rs + cb * r};
    // localized mode: the preferred row takes m of the count, and its
    // owner debits what p's avail allows (_schedule_grouped_localized's
    // step: consumed = min(m, clip(min_c floor(avail[p] / req), 0, BIG)))
    int count = sh.count[cb];
    if constexpr (kPref) {
      count = wsub(count, sh.m[cb]);
      if (row == sh.pref[cb]) {
        int cap = kBig;
        for (int p = 0; p < cls.npos; ++p)
          cap = min(cap, floordiv(rw.a(cls.col[p]), cls.q[p]));
        const int consumed = min(sh.m[cb], clip(cap, 0, kBig));
        for (int p = 0; p < cls.npos; ++p)
          rw.set_a(cls.col[p],
                   wsub(rw.a(cls.col[p]), wmul(cls.q[p], consumed)));
      }
    }
    const bool pmask = nmask && gmask;
    // the next class's mask, loaded now and used a class later
    if (group_masks != nullptr && live && gi + 1 < g)
      gmask = group_masks[(size_t)(gi + 1) * n + row] != 0;

    // feasibility, capacity m_max, and the hoisted used*SCALE + 1
    bool feas = pmask;                   // false on dead rows
    int caps = kBig;
    if (!kSpill || live)
      for (int p = 0; p < cls.npos; ++p) {
        const int c = cls.col[p], q = cls.q[p];
        const int t = rw.t(c), a = rw.a(c);
        feas = feas && (t >= q);
        caps = min(caps, floordiv(a, q));
        if (!kSpill || p < nu1) s_u1[p * nt + tid] = wadd(wmul(wsub(t, a), kScale), 1);
      }
    const int m_max = (feas && cls.npos > 0) ? clip(caps, 0, kBig) : 0;

    // the k-level search for L* (see the note at the top)
    int lo = 0, hi = kTop, n_avail = 0, overflow = 0;
    bool first = true;
    while (lo < hi) {
      const int step = (hi - lo + kProbes) / (kProbes + 1);
      int lv[kProbes], sums[kProbes], vals[kVals];
#pragma unroll
      for (int j = 0; j < kProbes; ++j)
        lv[j] = min(lo + (j + 1) * step - 1, hi - 1);
      slots_at<kProbes>(lv, m_max, cls, rw, thr_fp, sums);
#pragma unroll
      for (int j = 0; j < kProbes; ++j) vals[j] = sums[j];
      vals[kProbes] = m_max;
      unsigned all[kVals];
      unsigned long long key_min;
      exchange(sh, parity, vals, first ? best : kNoKey, all, key_min);
      if (first) {
        n_avail = min(count, (int)all[kProbes]);  // placements that consume
        overflow = wsub(count, n_avail);          // queue on best feasible
        if (gi > 0) resolve(gi - 1, key_min);
        first = false;
      }
      int jstar = kProbes;                   // first ok probe
#pragma unroll
      for (int j = kProbes - 1; j >= 0; --j)
        if (lo + (j + 1) * step - 1 >= hi || (int)all[j] >= n_avail) jstar = j;
      const int new_hi = jstar < kProbes ? min(lo + (jstar + 1) * step - 1, hi)
                                         : hi;
      lo = jstar > 0 ? lo + jstar * step : lo;
      hi = new_hi;
    }
    const int l_star = lo;

    // base = m(L*-1), at_level = m(L*); hand out the level-L* slots in
    // row order: exclusive scan over the cluster's contiguous ranges.
    // Warp 0 also sets up the next class before the barrier publishes it.
    int lv2[2] = {max(l_star - 1, 0), l_star}, m2[2];
    slots_at<2>(lv2, m_max, cls, rw, thr_fp, m2);
    const int base = l_star > 0 ? m2[0] : 0;
    const int extra = wsub(m2[1], base);
    unsigned incl = (unsigned)extra;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned y = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += y;
    }
    const unsigned bsum = warp_sum((unsigned)base);
    if (lane == 31) sh.warp_vals[0][warp] = (int)incl;
    if (lane == 0) sh.warp_vals[1][warp] = (int)bsum;
    __syncthreads();
    if (warp == 0) {
      const unsigned e = lane < nw ? (unsigned)sh.warp_vals[0][lane] : 0u;
      unsigned x = e;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const unsigned y = __shfl_up_sync(kFull, x, o);
        if (lane >= o) x += y;
      }
      sh.woff[lane] = (int)(x - e);
      const unsigned tot[2] = {
          __shfl_sync(kFull, x, 31),
          warp_sum(lane < nw ? (unsigned)sh.warp_vals[1][lane] : 0u)};
      if (gi + 1 < g)
        setup_class<kGlobalCls, kPref>(sh, s_stage, s_col, s_q, s_rm, s_rs,
                                       gi + 1, in);
      push<2>(sh, parity, tot, kNoKey);
    }
    cl.sync();
    unsigned all2[2], low2[2];
    unsigned long long unused;
    combine<2, true>(sh, parity, all2, low2, unused);
    parity ^= 1;
    const int prefix = (int)(low2[0] + (unsigned)sh.woff[warp] + incl -
                             (unsigned)extra);
    const int rem = wsub(n_avail, (int)all2[1]);
    const int give = min(max(wsub(rem, prefix), 0), extra);
    const int alloc = wadd(base, give);

    // consume, then this row's key on the post-allocation state
    // (_keys_one_req); the argmin is taken with the next class's first
    // exchange
    bool kfeas = pmask, availb = true;
    int s = 0;                           // .max(axis=1, initial=0)
    if (!kSpill || live)
      for (int p = 0; p < cls.npos; ++p) {
        const int c = cls.col[p], q = cls.q[p];
        const int t = rw.t(c);
        const int a = wsub(rw.a(c), wmul(alloc, q));
        rw.set_a(c, a);
        kfeas = kfeas && (t >= q);
        availb = availb && (a >= q);
        const int qq = wadd(wsub(t, a), q);
        s = max(s, floordiv(wmul(qq, kScale), max(t, 1)));
      }
    const int eff = (availb && s < thr_fp) ? 0 : s;
    const unsigned key = ((unsigned)(!availb) << kAvailShift) |
                         ((unsigned)eff << kScoreShift) | (unsigned)row;
    const int k32 = kfeas ? (int)key : kInfKey;
    best = live ? (((unsigned long long)((unsigned)k32 ^ 0x80000000u) << 32) |
                   (unsigned)row)
                : kNoKey;
    int placed = alloc;                  // + m on the preferred row
    if constexpr (kPref)
      if (row == sh.pref[cb]) placed = wadd(alloc, sh.m[cb]);
    if (live) counts[(size_t)gi * (n + 1) + row] = placed;
    prev_alloc = placed;
    prev_over = overflow;
  }

  if (g > 0) {                           // the last class's overflow node
    const int zero[kVals] = {};
    unsigned all[kVals];
    unsigned long long key_min;
    exchange(sh, parity, zero, best, all, key_min);
    resolve(g - 1, key_min);
  }
  if (live)
    for (int c = 0; c < rs; ++c)
      new_avail[(size_t)row * r + c] = s_a[c * nt + tid];
  cl.sync();                             // no CTA leaves while written to
}

// The launch for n rows x r columns, a fixed rule: the cluster doubles
// while a CTA would hold more than kRowsPerCta rows (up to the portable
// 8), and again, to 16, while a CTA's rows (3 ints per column: totals,
// avail, used*SCALE + 1) do not fit the card's shared memory beside the
// class arrays; at 16 the rows spill past `rs` columns (see the note).
// Where the class arrays alone do not fit, they go to global scratch
// (8R ints per CTA) and the rows get all of the shared memory.
struct Layout {
  int cluster, threads, rs, nu1, cls_global;
  size_t smem;                           // dynamic shared memory, bytes
};

cudaError_t plan(int n, int r, Layout* lay) {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  if (n < 1 || n > kMaxCluster * kMaxThreads || r < 1)
    return cudaErrorInvalidValue;
  const long long all =
      ((long long)optin - (long long)sizeof(Shared)) / (long long)sizeof(int);
  const long long cls_ints = 10LL * r + 2;
  const int cls_global = all - cls_ints < 0;
  const long long room = cls_global ? all : all - cls_ints;  // for the rows
  int c = 1;
  while (c < kPortableCluster && c * kRowsPerCta < n) c *= 2;
  for (;;) {
    const int threads = ((n + c - 1) / c + 31) / 32 * 32;
    const long long per = room / threads;          // ints per row
    if (threads <= kMaxThreads && per >= 3LL * r) {
      *lay = {c, threads, r, r, cls_global, 0};
      break;
    }
    if (c == kMaxCluster) {
      const int nu1 = (int)std::min<long long>(std::min(r, kSpillU1), per);
      *lay = {c, threads, (int)std::min<long long>(r, (per - nu1) / 2), nu1,
              cls_global, 0};
      break;
    }
    c *= 2;
  }
  lay->smem = sizeof(int) * ((size_t)(2 * lay->rs + lay->nu1) * lay->threads +
                             (cls_global ? 0 : (size_t)cls_ints));
  return cudaSuccess;
}

typedef void (*KernelFn)(const int*, const int*, const uint8_t*, const int*,
                         const int*, const uint8_t*, const int*, int*, int*,
                         int*, int, int, int, int, int, int, int);

// the compiled instantiations: global class arrays imply spilled rows
KernelFn kernel_for(bool spill, bool cls_global, bool pref) {
  if (cls_global)
    return pref ? waterfill_cluster_kernel<true, true, true>
                : waterfill_cluster_kernel<true, true, false>;
  if (spill)
    return pref ? waterfill_cluster_kernel<true, false, true>
                : waterfill_cluster_kernel<true, false, false>;
  return pref ? waterfill_cluster_kernel<false, false, true>
              : waterfill_cluster_kernel<false, false, false>;
}

void write_layout(const Layout& lay, int r, int* layout) {
  layout[0] = lay.cluster;
  layout[1] = lay.threads;
  layout[2] = lay.rs;
  layout[3] = lay.nu1;
  layout[4] = lay.cls_global ? lay.cluster * 8 * r : 0;   // scratch ints
}

}  // namespace

// One launch for the G classes; writes the launch it made into
// layout[0..4] (cluster size, threads per CTA, columns in shared memory,
// used*SCALE + 1 columns kept, ints of global scratch: 0 unless the class
// arrays live in global memory, where this call allocates the scratch on
// the stream and frees it after the launch).  pref_rows (G ints, -1 =
// none) or null.  Returns a cudaError_t.
extern "C" int rt_waterfill_scan(const void* totals, const void* avail,
                                 const void* node_mask,
                                 const void* group_reqs,
                                 const void* group_counts,
                                 const void* group_masks,
                                 const void* pref_rows, void* counts,
                                 void* new_avail, int n, int r, int g,
                                 int thr_fp, int require_available,
                                 int* layout, void* stream) {
  if (g < 0) return (int)cudaErrorInvalidValue;
  Layout lay;
  cudaError_t err = plan(n, r, &lay);
  if (err != cudaSuccess) return (int)err;
  write_layout(lay, r, layout);
  const KernelFn kernel = kernel_for(lay.rs < r || lay.nu1 < r,
                                     lay.cls_global != 0, pref_rows != nullptr);
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)lay.smem);
  if (err != cudaSuccess) return (int)err;
  if (lay.cluster > kPortableCluster) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return (int)err;
  }
  const cudaStream_t st = (cudaStream_t)stream;
  int* scratch = nullptr;
  if (lay.cls_global) {
    err = cudaMallocAsync((void**)&scratch, sizeof(int) * (size_t)layout[4],
                          st);
    if (err != cudaSuccess) return (int)err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(lay.cluster, 1, 1);
  cfg.blockDim = dim3(lay.threads, 1, 1);
  cfg.dynamicSmemBytes = lay.smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = lay.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(
      &cfg, kernel, (const int*)totals, (const int*)avail,
      (const uint8_t*)node_mask, (const int*)group_reqs,
      (const int*)group_counts, (const uint8_t*)group_masks,
      (const int*)pref_rows, (int*)counts, (int*)new_avail, scratch, n, r, g,
      thr_fp, require_available, lay.rs, lay.nu1);
  if (scratch != nullptr) {
    const cudaError_t freed = cudaFreeAsync(scratch, st);
    if (err == cudaSuccess) err = freed;
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
