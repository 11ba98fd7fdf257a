// The class scan of the sharded heartbeat, by hand for Hopper (sm_90a): the
// G water-fills of every rank of a row-sharded plane in one launch, for S
// ranks that share one card, with the collectives between the ranks done
// inside the kernel.
//
// Replaces: the lax.scan over scheduling classes inside the shard_map
//   program of ray_tpu/ops/shard_reduce.py::ShardPlane.fused_beat
//   (:410-419), whose body is _schedule_group_sharded (:180-252) with its
//   collectives _psum2 / _pmin2 (:98-110) and the all_gather of the prefix
//   (:222-226); and the same scan behind
//   hybrid_kernel.schedule_grouped_sharded_np (per-class group masks).
// Semantics: scheduling/contract.py, bit for bit in int32.  Per rank the
// alloc rows (G, n_l) and the carried avail; inf (G,) from rank 0.
//
// What bounds it on this card: as for waterfill.cu, neither bytes nor
// operations but a chain of dependent reductions over every row, here over
// every rank's rows.  Eager PyTorch rank by rank pays ~19 host collectives
// and ~800 small launches a class; here a class is 6 exchanges inside one
// launch, so the design makes an exchange short:
//
//   * Within a rank, waterfill.cu's layout: one row a thread, the rank's
//     rows over nc CTAs where they pass one CTA (plan()); the rank's CTA k
//     owns its rows [k*nt, (k+1)*nt).
//     totals and the carried avail stay in shared memory for the whole scan
//     (column-major), or, where they cannot, are read from totals and
//     carried in new_avail (kOnChip false).  A class's positive-request
//     columns are compacted, each with its divisor's magic multiplier
//     (contract.cuh fdiv), so no search level divides.
//   * The k-level search of waterfill.cu: 7 levels a round, 5 rounds in
//     place of the 15 bisection steps, the capacity sum and the previous
//     class's argmin carried by the first round (the overflow does not
//     change avail, so its node can wait a class), then one round for base
//     and the prefix.  It is exact for the reason given at waterfill.cu:53:
//     the global m(L) is the sum of the ranks' m(L), so it is non-decreasing
//     as the single-device sum is.
//   * An exchange takes one of two routes (plan()), both starting with
//     the CTA's sums (a redux.sync a value, one __syncthreads):
//     - "cluster", where every rank's CTAs fit one thread-block cluster
//       (at most kMaxCluster = 16 CTAs; the beat cell's 1024 rows at S =
//       2 / 4 / 8, 8192 rows at S = 2): one launch of one cluster, rank
//       k's CTAs a run of consecutive cluster ranks, so cluster order is
//       global row order.  An exchange is waterfill.cu's: each CTA pushes
//       its sums and packed min into a parity slot of every CTA by
//       distributed shared memory, one barrier.cluster, and every warp
//       combines the slots itself.  The exclusive prefix is the sum of
//       the lower CTAs' slots: the lower ranks' rows, then this rank's
//       lower CTAs' (the reference's all-gathered prefix).  No global
//       memory, no fences, no counters, no cooperative launch.  The
//       hardware co-schedules a cluster, so no CTA waits on one that has
//       not started.
//     - "global", for meshes past one cluster (8192 rows at S = 4 / 8,
//       32 and 64 ranks): a cooperative launch of every rank's CTAs, no
//       cluster.  Every CTA publishes its own sums and packed min into its
//       own slot of its rank's exchange area (a ring of kRing slots, by
//       round), each 32-bit value in a 64-bit word whose high half is the
//       round, written and read as volatile 16-byte pairs.  A reader
//       knows a word is this round's from the word itself, so there is no
//       release/acquire, no counter and no second read: warp 0 of every
//       CTA polls every CTA's slot until each of its words carries the
//       round (a pair's words are single-copy atomic each), sums them
//       (wrapping uint32, the same bits in any order, so the same as
//       _psum2's ici then dcn), takes the min and the exclusive prefix
//       over the lower CTAs, and a __syncthreads hands them to the CTA.
//       A CTA is never more than one round ahead of another (it publishes
//       round k+1 only after reading every slot of round k), so the ring
//       is never overwritten under a reader.  The areas start zeroed (the
//       wrapper, or beat_rows in the engines), which no round matches.
//       Slots rather than one shared cell with atomics: a rank writes only
//       its own memory, as ranks on distinct cards will over peer-mapped
//       memory; the slots are found through the table of per-rank
//       pointers.  Every CTA spins on the others, so all must be resident
//       at once: rt_shard_scan_plan reports how many ranks can be and the
//       wrapper raises before launching a mesh that cannot be; a wait
//       that lasts 10 s traps, failing the launch instead of hanging the
//       card.

// Exactness: as in waterfill.cu (uint32 wrapping, floor division, initial
// values of the reductions, ties to the lowest row), plus the sharded
// reference's own traps: keys carry the GLOBAL row (rank * n_l + row); the
// overflow goes to the thread whose row is the min key's row less the
// rank's offset, so a negative or too large local position (another rank's
// node) adds nothing, where the reference scatters it into a scratch slot
// n_l that is cut off; an all-INF min queues the overflow nowhere (inf,
// whatever row the min names); require_available reads bit AVAIL_SHIFT of
// the global min key.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "contract.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace rt;

constexpr int kTop = 2 * kScale + 1;     // the search's "no level" answer
constexpr int kProbes = 7;               // levels per search round
constexpr int kVals = kProbes + 1;       // sums exchanged per search round
constexpr int kMaxThreads = 1024;
constexpr int kRowsPerCta = 128;         // a rank's CTAs double above this
constexpr int kPortableCluster = 8;
constexpr int kMaxCluster = 16;
constexpr int kRing = 4;                 // a CTA's exchange slots, by round
constexpr int kSlotWords = 16;           // kVals sums, the min's two halves
constexpr int kMinWord = 8;              // (a 128-byte line)
constexpr int kSlotInts = 2 * kSlotWords;
constexpr int kCtaInts = kRing * kSlotInts;
constexpr long long kWaitNs = 10000000000LL;
constexpr int kRouteGlobal = 0;          // layout[6]
constexpr int kRouteCluster = 1;

// One rank's arrays, as the wrapper lays out its table (one int64 each)
struct RankPtrs {
  const int* totals;          // (n_l, r)
  const int* avail;           // (n_l, r)
  const uint8_t* mask;        // (n_l,)
  const int* group_reqs;      // (g, r): this rank's copy
  const int* group_counts;    // (g,)
  const uint8_t* group_masks; // (g, n_l) or null
  int* alloc;                 // (g, n_l), out
  int* new_avail;             // (n_l, r), out
  int* inf;                   // (g,), out: rank 0's, null on the others
  unsigned* xchg;             // this rank's exchange area, zeroed: its
                              // CTAs' slots (global route)
};

struct Shared {
  int warp_vals[kVals][32];
  unsigned long long warp_min[32];
  // cluster route: each CTA pushes its sums into slot [its cluster rank]
  // of every CTA of the cluster, by round parity: after the barrier every
  // read is local
  int slot[2][kMaxCluster][kVals];
  unsigned long long slot_min[2][kMaxCluster];
  int woff[32];                          // exclusive scan offsets of the warps
  unsigned res[kVals], res_low[kVals];   // global route: an exchange's
  unsigned long long res_min;            // result, for the CTA
  int npos[2], count[2];                 // the class's, by class parity
};

__device__ __forceinline__ int clip(int x, int lo, int hi) {
  return min(max(x, lo), hi);
}

// A warp's wrapping sum and its first min of packed 64-bit keys, each one
// redux.sync a 32-bit word (in place of five shuffles each)
__device__ __forceinline__ unsigned warp_sum(unsigned x) {
  return __reduce_add_sync(kFull, x);
}

__device__ __forceinline__ unsigned long long warp_min64(
    unsigned long long x) {
  const unsigned hi = __reduce_min_sync(kFull, (unsigned)(x >> 32));
  const unsigned lo = __reduce_min_sync(
      kFull, (unsigned)(x >> 32) == hi ? (unsigned)x : 0xffffffffu);
  return ((unsigned long long)hi << 32) | lo;
}

__device__ __forceinline__ void st_pair(unsigned long long* p,
                                        unsigned long long a,
                                        unsigned long long b) {
  asm volatile("st.volatile.global.v2.u64 [%0], {%1, %2};" ::"l"(p), "l"(a),
               "l"(b)
               : "memory");
}

__device__ __forceinline__ void ld_pair(const unsigned long long* p,
                                        unsigned long long& a,
                                        unsigned long long& b) {
  asm volatile("ld.volatile.global.v2.u64 {%0, %1}, [%2];"
               : "=l"(a), "=l"(b)
               : "l"(p)
               : "memory");
}

__device__ __forceinline__ long long globaltimer() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ unsigned long long tagged(unsigned round,
                                                     unsigned v) {
  return ((unsigned long long)round << 32) | v;
}

// This CTA's place in the exchange
struct Ctx {
  const RankPtrs* tab;
  int s, rank, cta, cpr;                 // cpr: CTAs a rank
  int me;                                // rank * cpr + cta: row order
  unsigned round;                        // exchanges so far (global route)
  int parity;                            // of the cluster's slots
};

// An exchange's result, in every thread
template <int NV>
struct Res {
  unsigned all[NV], low[NV];             // over every row; over the rows
  unsigned long long mn;                 // before this CTA's (kLow)
};

// The cluster route.  Warp 0 holds this CTA's sums x[] and min mn (every
// lane): push them into slot [me] of every CTA, one barrier.cluster, then
// every warp combines the slots.
template <int NV, bool kLow>
__device__ __forceinline__ void cross_cluster(Shared& sh, Ctx& cx,
                                              const unsigned (&x)[NV],
                                              unsigned long long mn,
                                              Res<NV>& out) {
  cg::cluster_group cl = cg::this_cluster();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nc = (int)cl.num_blocks();
  if (warp == 0 && lane < nc) {          // lane k writes CTA k's copy
    int* dst = cl.map_shared_rank(&sh.slot[cx.parity][cx.me][0], lane);
#pragma unroll
    for (int v = 0; v < NV; ++v) dst[v] = (int)x[v];
    *cl.map_shared_rank(&sh.slot_min[cx.parity][cx.me], lane) = mn;
  }
  cl.sync();
  const bool on = lane < nc;
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    const unsigned y = on ? (unsigned)sh.slot[cx.parity][lane][v] : 0u;
    out.all[v] = warp_sum(y);
    if (kLow) out.low[v] = warp_sum(lane < cx.me ? y : 0u);
  }
  out.mn = warp_min64(on ? sh.slot_min[cx.parity][lane] : kNoKey);
  cx.parity ^= 1;
}

// The global route.  Warp 0 holds this CTA's sums x[] and min mn (every
// lane): publish them tagged with the round in this CTA's slot, read
// every CTA's slot once all its words carry the round (lane j the slots
// j, j + 32, ...), reduce, and hand the result to the CTA.
template <int NV, bool kLow>
__device__ void cross_global(Shared& sh, Ctx& cx, const unsigned (&x)[NV],
                             unsigned long long mn, Res<NV>& out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned round = ++cx.round;
  const int ring = (int)(round % kRing) * kSlotInts;
  if (warp == 0) {
    unsigned long long* own = reinterpret_cast<unsigned long long*>(
        cx.tab[cx.rank].xchg + cx.cta * kCtaInts + ring);
    unsigned lo = 0u, hi = 0u;           // lane j writes words 2j, 2j + 1
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      if (v == 2 * lane) lo = x[v];
      if (v == 2 * lane + 1) hi = x[v];
    }
    if (2 * lane < NV)
      st_pair(own + 2 * lane, tagged(round, lo), tagged(round, hi));
    if (lane == kMinWord / 2)
      st_pair(own + kMinWord, tagged(round, (unsigned)(mn >> 32)),
              tagged(round, (unsigned)mn));
    unsigned all[NV], low[NV];
#pragma unroll
    for (int v = 0; v < NV; ++v) all[v] = low[v] = 0u;
    unsigned long long m = kNoKey;
    const int nslots = cx.s * cx.cpr;
    for (int j = lane; j < nslots; j += 32) {
      const int k = j / cx.cpr;
      const unsigned long long* xs =
          reinterpret_cast<const unsigned long long*>(
              cx.tab[k].xchg + (j - k * cx.cpr) * kCtaInts + ring);
      constexpr int kPairs = (NV + 1) / 2;
      unsigned long long w[2 * kPairs], w_min[2];
      long long t0 = 0;
      for (int spin = 1;; ++spin) {
        bool ok = true;
#pragma unroll
        for (int q = 0; q < kPairs; ++q) {
          ld_pair(xs + 2 * q, w[2 * q], w[2 * q + 1]);
          ok = ok && (unsigned)(w[2 * q] >> 32) == round &&
               (unsigned)(w[2 * q + 1] >> 32) == round;
        }
        ld_pair(xs + kMinWord, w_min[0], w_min[1]);
        ok = ok && (unsigned)(w_min[0] >> 32) == round &&
             (unsigned)(w_min[1] >> 32) == round;
        if (ok) break;
        if ((spin & 1023) == 0) {        // trap after kWaitNs
          const long long t = globaltimer();
          if (t0 == 0) t0 = t;
          else if (t - t0 > kWaitNs) __trap();
        }
      }
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        const unsigned y = (unsigned)w[v];
        all[v] += y;
        if (kLow && j < cx.me) low[v] += y;
      }
      const unsigned long long y =
          ((unsigned long long)(unsigned)w_min[0] << 32) | (unsigned)w_min[1];
      m = y < m ? y : m;
    }
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      all[v] = warp_sum(all[v]);
      if (kLow) low[v] = warp_sum(low[v]);
    }
    m = warp_min64(m);
    if (lane == 0) {
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        sh.res[v] = all[v];
        if (kLow) sh.res_low[v] = low[v];
      }
      sh.res_min = m;
    }
  }
  __syncthreads();
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    out.all[v] = sh.res[v];
    if (kLow) out.low[v] = sh.res_low[v];
  }
  out.mn = sh.res_min;
}

template <int NV, bool kLow, bool kCluster>
__device__ __forceinline__ void cross(Shared& sh, Ctx& cx,
                                      const unsigned (&x)[NV],
                                      unsigned long long mn, Res<NV>& out) {
  if constexpr (kCluster) cross_cluster<NV, kLow>(sh, cx, x, mn, out);
  else cross_global<NV, kLow>(sh, cx, x, mn, out);
}

// An exchange of one value vector a row: the CTA's sums, then cross().
template <int NV, bool kCluster>
__device__ void exchange(Shared& sh, Ctx& cx, const int (&vals)[NV],
                         unsigned long long mn, Res<NV>& out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  unsigned u[NV];
#pragma unroll
  for (int v = 0; v < NV; ++v) u[v] = warp_sum((unsigned)vals[v]);
  mn = warp_min64(mn);
  if (lane == 0) {
#pragma unroll
    for (int v = 0; v < NV; ++v) sh.warp_vals[v][warp] = (int)u[v];
    sh.warp_min[warp] = mn;
  }
  __syncthreads();
  unsigned x[NV];
  unsigned long long xm = kNoKey;
#pragma unroll
  for (int v = 0; v < NV; ++v)
    x[v] = warp == 0 ? warp_sum(lane < nw ? (unsigned)sh.warp_vals[v][lane]
                                          : 0u)
                     : 0u;
  if (warp == 0) xm = warp_min64(lane < nw ? sh.warp_min[lane] : kNoKey);
  cross<NV, false, kCluster>(sh, cx, x, xm, out);
}

// This thread's row: on chip (column-major, stride nt) or, without
// kOnChip, totals read where they are and avail carried in new_avail.
template <bool kOnChip>
struct Row {
  int* s_t;
  int* s_a;
  const int* totals;
  int* new_avail;
  size_t base;                           // row * r
  int nt, tid;
  __device__ __forceinline__ int t(int c) const {
    return kOnChip ? s_t[c * nt + tid] : __ldg(totals + base + c);
  }
  __device__ __forceinline__ int a(int c) const {
    return kOnChip ? s_a[c * nt + tid] : new_avail[base + c];
  }
  __device__ __forceinline__ void set_a(int c, int v) const {
    if (kOnChip) s_a[c * nt + tid] = v;
    else new_avail[base + c] = v;
  }
};

// The class's compacted positive request columns
struct Cls {
  int npos;
  const int* col;
  const int* q;
  const unsigned* m;       // magic multiplier of max(q * SCALE, 1)
  const int* sh;           // its shift
};

// m(L) for K levels of this thread's row (_slots_at_or_below_l): slots
// with eff-score key <= L, levels below thr_fp collapsing onto thr_fp - 1
template <int K, bool kOnChip>
__device__ __forceinline__ void slots_at(const int (&lv)[K], int m_max,
                                         const Cls& cls,
                                         const Row<kOnChip>& rw, int thr_fp,
                                         int (&out)[K]) {
  int lp1[K], jc[K];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    lp1[j] = (lv[j] < thr_fp ? thr_fp - 1 : lv[j]) + 1;
    jc[j] = kBig;                        // where(req_pos, jc, BIG).min()
  }
  if (m_max > 0) {                       // else 0 at every level
    for (int p = 0; p < cls.npos; ++p) {
      const int c = cls.col[p];
      const int t = rw.t(c);
      const int u1 = wadd(wmul(wsub(t, rw.a(c)), kScale), 1);
      const unsigned m = cls.m[p], sh = (unsigned)cls.sh[p];
#pragma unroll
      for (int j = 0; j < K; ++j)
        jc[j] = min(jc[j],
                    clip(fdiv(wsub(wmul(lp1[j], t), u1), m, sh), 0, kBig));
    }
  }
#pragma unroll
  for (int j = 0; j < K; ++j) out[j] = min(m_max, jc[j]);
}

// Warp 0: compact class gi's request into the class arrays of parity
// gi & 1 (positive columns with their magic multipliers) and note its
// count; read after the next barrier.
__device__ __forceinline__ void setup_class(Shared& sh, int* s_col, int* s_q,
                                            unsigned* s_m, int* s_sh, int gi,
                                            const RankPtrs& p, int r) {
  const int lane = threadIdx.x, cb = gi & 1;
  const int* req = p.group_reqs + (size_t)gi * r;
  int npos = 0;
  for (int c0 = 0; c0 < r; c0 += 32) {
    const int c = c0 + lane;
    const int q = c < r ? req[c] : 0;
    const unsigned pos = __ballot_sync(kFull, q > 0);
    if (q > 0) {
      const int at = cb * r + npos + __popc(pos & ((1u << lane) - 1u));
      const uint2 mg = magic(max(wmul(q, kScale), 1));
      s_col[at] = c;
      s_q[at] = q;
      s_m[at] = mg.x;
      s_sh[at] = (int)mg.y;
    }
    npos += __popc(pos);
  }
  if (lane == 0) {
    sh.npos[cb] = npos;
    sh.count[cb] = p.group_counts[gi];
  }
}

// kCluster: every rank in one thread-block cluster (the cluster route),
// else a cooperative grid (the global route); kOnChip: totals and avail
// in shared memory; kReqAvail: require_available.
template <bool kCluster, bool kOnChip, bool kReqAvail>
__global__ void __launch_bounds__(kMaxThreads)
shard_scan_kernel(const RankPtrs* __restrict__ tab, int s, int n_l, int r,
                  int g, int thr_fp) {
  __shared__ Shared sh;
  extern __shared__ int dyn[];
  const int nt = blockDim.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, nw = nt >> 5;
  const int cpr = (int)gridDim.x / s;    // CTAs a rank
  const int rank = (int)blockIdx.x / cpr, cta = (int)blockIdx.x % cpr;
  const RankPtrs p = tab[rank];
  const int row = cta * nt + tid;        // the rank's row
  const bool live = row < n_l;
  const int grow = rank * n_l + row;     // its global traversal index
  Ctx cx{tab, s, rank, cta, cpr, (int)blockIdx.x, 0u, 0};

  // totals and the carried avail (r columns each, stride nt; none without
  // kOnChip), then the class arrays by class parity ([2][r] each)
  int* s_t = dyn;
  int* s_a = s_t + (kOnChip ? r * nt : 0);
  int* s_col = s_a + (kOnChip ? r * nt : 0);
  int* s_q = s_col + 2 * r;
  unsigned* s_m = reinterpret_cast<unsigned*>(s_q + 2 * r);
  int* s_sh = reinterpret_cast<int*>(s_m + 2 * r);
  const Row<kOnChip> rw{s_t, s_a, p.totals, p.new_avail,
                        live ? (size_t)row * r : 0, nt, tid};
  if (live)
    for (int c = 0; c < r; ++c) {
      const int a = p.avail[(size_t)row * r + c];
      if (kOnChip) {
        s_t[c * nt + tid] = p.totals[(size_t)row * r + c];
        s_a[c * nt + tid] = a;
      } else {
        p.new_avail[(size_t)row * r + c] = a;
      }
    }
  if (warp == 0 && g > 0) setup_class(sh, s_col, s_q, s_m, s_sh, 0, p, r);
  const bool nmask = live && p.mask[row] != 0;
  bool gmask = p.group_masks == nullptr || !live || g == 0 ||
               p.group_masks[row] != 0;
  // the block's barrier, and every CTA of the cluster has started before
  // another writes into its shared memory
  if constexpr (kCluster) cg::this_cluster().sync();
  else __syncthreads();

  // the last class's allocation and overflow, until its argmin is known
  int prev_alloc = 0, prev_over = 0;
  unsigned long long best = kNoKey;      // this row's packed overflow key

  auto resolve = [&](int gi, unsigned long long key_min) {
    const int okey = packed_key(key_min);
    bool queue_ok = okey != kInfKey;
    if (kReqAvail) queue_ok = queue_ok && ((okey >> kAvailShift) & 1) == 0;
    // the node's position in this rank: another rank's is out of [0, n_l)
    const int pos = (okey & kRowMask) - rank * n_l;
    if (queue_ok && live && row == pos)
      p.alloc[(size_t)gi * n_l + row] = wadd(prev_alloc, prev_over);
    if (p.inf != nullptr && cta == 0 && tid == 0)
      p.inf[gi] = queue_ok ? 0 : prev_over;
  };

  for (int gi = 0; gi < g; ++gi) {
    const int cb = gi & 1;
    const Cls cls{sh.npos[cb], s_col + cb * r, s_q + cb * r, s_m + cb * r,
                  s_sh + cb * r};
    const int count = sh.count[cb];
    const bool pmask = nmask && gmask;
    // the next class's mask, loaded now and used a class later
    if (p.group_masks != nullptr && live && gi + 1 < g)
      gmask = p.group_masks[(size_t)(gi + 1) * n_l + row] != 0;

    // feasibility and capacity m_max
    bool feas = pmask;                   // false on dead rows
    int caps = kBig;
    if (live)
      for (int k = 0; k < cls.npos; ++k) {
        const int c = cls.col[k], q = cls.q[k];
        feas = feas && (rw.t(c) >= q);
        caps = min(caps, floordiv(rw.a(c), q));
      }
    const int m_max = (feas && cls.npos > 0) ? clip(caps, 0, kBig) : 0;

    // the k-level search for L* (waterfill.cu), every sum over all ranks
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
      Res<kVals> res;
      exchange<kVals, kCluster>(sh, cx, vals, first ? best : kNoKey, res);
      if (first) {
        n_avail = min(count, (int)res.all[kProbes]);  // placements that
        overflow = wsub(count, n_avail);  // consume; queue on best feasible
        if (gi > 0) resolve(gi - 1, res.mn);
        first = false;
      }
      int jstar = kProbes;                   // first ok probe
#pragma unroll
      for (int j = kProbes - 1; j >= 0; --j)
        if (lo + (j + 1) * step - 1 >= hi || (int)res.all[j] >= n_avail)
          jstar = j;
      const int new_hi = jstar < kProbes ? min(lo + (jstar + 1) * step - 1, hi)
                                         : hi;
      lo = jstar > 0 ? lo + jstar * step : lo;
      hi = new_hi;
    }
    const int l_star = lo;

    // base = m(L*-1), at_level = m(L*); the level-L* slots go out in global
    // row order: the exclusive prefix is the lower ranks' and lower CTAs'
    // sums, the lower warps' and the lanes' below.  Warp 0 also sets up the
    // next class before the exchange's barriers publish it.
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
    unsigned tot[2] = {0u, 0u};
    if (warp == 0) {
      const unsigned e = lane < nw ? (unsigned)sh.warp_vals[0][lane] : 0u;
      unsigned xs = e;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const unsigned y = __shfl_up_sync(kFull, xs, o);
        if (lane >= o) xs += y;
      }
      sh.woff[lane] = (int)(xs - e);
      tot[0] = __shfl_sync(kFull, xs, 31);
      tot[1] = warp_sum(lane < nw ? (unsigned)sh.warp_vals[1][lane] : 0u);
      if (gi + 1 < g) setup_class(sh, s_col, s_q, s_m, s_sh, gi + 1, p, r);
    }
    Res<2> pre;
    cross<2, true, kCluster>(sh, cx, tot, kNoKey, pre);
    const int prefix = (int)(pre.low[0] + (unsigned)sh.woff[warp] + incl -
                             (unsigned)extra);
    const int rem = wsub(n_avail, (int)pre.all[1]);
    const int give = min(max(wsub(rem, prefix), 0), extra);
    const int alloc = wadd(base, give);

    // consume, then this row's key on the post-allocation state
    // (_keys_block with the global row); the min is taken with the next
    // class's first exchange
    bool kfeas = pmask, availb = true;
    int sc = 0;                          // .max(axis=1, initial=0)
    if (live)
      for (int k = 0; k < cls.npos; ++k) {
        const int c = cls.col[k], q = cls.q[k];
        const int t = rw.t(c);
        const int a = wsub(rw.a(c), wmul(alloc, q));
        rw.set_a(c, a);
        kfeas = kfeas && (t >= q);
        availb = availb && (a >= q);
        sc = max(sc, floordiv(wmul(wadd(wsub(t, a), q), kScale), max(t, 1)));
      }
    best = live ? pack_key(pack_contract_key(kfeas, availb, sc, thr_fp, grow),
                           grow)
                : kNoKey;
    if (live) p.alloc[(size_t)gi * n_l + row] = alloc;
    prev_alloc = alloc;
    prev_over = overflow;
  }

  if (g > 0) {                           // the last class's overflow node
    const int zero[1] = {0};
    Res<1> res;
    exchange<1, kCluster>(sh, cx, zero, best, res);
    resolve(g - 1, res.mn);
  }
  if (kOnChip && live)
    for (int c = 0; c < r; ++c)
      p.new_avail[(size_t)row * r + c] = s_a[c * nt + tid];
  if constexpr (kCluster) cg::this_cluster().sync();  // none leaves while
                                                      // written to
}

typedef void (*KernelFn)(const RankPtrs*, int, int, int, int, int);

KernelFn kernel_for(bool cluster, bool on_chip, bool req_av) {
  if (cluster) {
    if (on_chip)
      return req_av ? shard_scan_kernel<true, true, true>
                    : shard_scan_kernel<true, true, false>;
    return req_av ? shard_scan_kernel<true, false, true>
                  : shard_scan_kernel<true, false, false>;
  }
  if (on_chip)
    return req_av ? shard_scan_kernel<false, true, true>
                  : shard_scan_kernel<false, true, false>;
  return req_av ? shard_scan_kernel<false, false, true>
                : shard_scan_kernel<false, false, false>;
}

// The launch for S ranks of n_l rows x r columns, a fixed rule: a rank's
// CTAs double while a CTA would hold more than kRowsPerCta rows (up to
// 8), and again, to 16, while a CTA's rows (totals and avail) do not fit
// its shared memory beside the class arrays (8r ints); at 16 the rows
// stay in global memory.  The route is "cluster" where every rank's CTAs
// make at most kMaxCluster, else "global".  `resident` is how many ranks
// the card can hold at once at that launch.
struct Layout {
  int rank_ctas, threads, on_chip, resident, route;
  size_t smem;                           // dynamic shared memory, bytes
};

cudaError_t plan(int s, int n_l, int r, bool req_av, Layout* lay) {
  int dev = 0, optin = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  if (s < 1 || n_l < 1 || r < 1 || (long long)s * n_l > kMaxNodes)
    return cudaErrorInvalidValue;
  const long long all =
      ((long long)optin - (long long)sizeof(Shared)) / (long long)sizeof(int);
  const long long cls = 8LL * r;
  if (cls > all) return cudaErrorInvalidValue;   // the class arrays alone
  int c = 1;
  while (c < kPortableCluster && c * kRowsPerCta < n_l) c *= 2;
  int threads = 0, on_chip = 0;
  for (;;) {
    threads = ((n_l + c - 1) / c + 31) / 32 * 32;
    if (threads <= kMaxThreads && (all - cls) / threads >= 2LL * r) {
      on_chip = 1;
      break;
    }
    if (c == kMaxCluster) break;         // 512 threads at most: n_l <= 8192
    c *= 2;
  }
  lay->rank_ctas = c;
  lay->threads = threads;
  lay->on_chip = on_chip;
  lay->route = (long long)s * c <= kMaxCluster ? kRouteCluster : kRouteGlobal;
  lay->smem = sizeof(int) *
              ((on_chip ? 2 * (size_t)r * threads : 0) + (size_t)cls);
  const bool cluster = lay->route == kRouteCluster;
  const KernelFn kernel = kernel_for(cluster, on_chip != 0, req_av);
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)lay->smem);
  if (err == cudaSuccess && cluster && s * c > kPortableCluster)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  if (cluster) {                         // the one cluster fits, or none
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(s * c, 1, 1);
    cfg.blockDim = dim3(threads, 1, 1);
    cfg.dynamicSmemBytes = lay->smem;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = s * c;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
    lay->resident = clusters > 0 ? s : 0;
  } else {
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        threads, lay->smem);
    lay->resident = per_sm * sms / c;
  }
  return err;
}

void write_layout(const Layout& lay, int s, int* layout) {
  const bool cluster = lay.route == kRouteCluster;
  layout[0] = cluster ? s * lay.rank_ctas : 1;   // CTAs of a cluster
  layout[1] = lay.threads;
  layout[2] = lay.on_chip;
  layout[3] = (int)lay.smem;
  layout[4] = lay.resident;
  layout[5] = cluster ? 0 : lay.rank_ctas * kCtaInts;  // exchange ints
  layout[6] = lay.route;
  layout[7] = lay.rank_ctas;
}

}  // namespace

// The launch that rt_shard_scan makes for this mesh, into layout[0..7]:
// CTAs of its thread-block cluster (1 on the global route), threads a
// CTA, rows on chip (1) or in global memory (0), dynamic shared memory
// bytes, ranks the card can hold at once, the ints of a rank's exchange
// area (0 on the cluster route), the route (0 global, 1 cluster) and
// CTAs a rank.  Returns a cudaError_t.
extern "C" int rt_shard_scan_plan(int s, int n_l, int r,
                                  int require_available, int* layout) {
  Layout lay;
  const cudaError_t err = plan(s, n_l, r, require_available != 0, &lay);
  if (err != cudaSuccess) return (int)err;
  write_layout(lay, s, layout);
  return (int)cudaSuccess;
}

// One launch for the G classes of S ranks.  `table` is S RankPtrs on the
// device (the wrapper's int64 table); on the global route each rank's
// exchange area holds layout[5] zeroed ints.  A mesh the card cannot
// hold at once returns cudaErrorCooperativeLaunchTooLarge before
// launching.  Writes the launch into layout[0..7] as rt_shard_scan_plan
// does.  Returns a cudaError_t.
extern "C" int rt_shard_scan(const void* table, int s, int n_l, int r, int g,
                             int thr_fp, int require_available, int* layout,
                             void* stream) {
  if (g < 0) return (int)cudaErrorInvalidValue;
  Layout lay;
  cudaError_t err = plan(s, n_l, r, require_available != 0, &lay);
  if (err != cudaSuccess) return (int)err;
  write_layout(lay, s, layout);
  if (lay.resident < s) return (int)cudaErrorCooperativeLaunchTooLarge;
  const bool cluster = lay.route == kRouteCluster;
  const KernelFn kernel =
      kernel_for(cluster, lay.on_chip != 0, require_available != 0);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(s * lay.rank_ctas, 1, 1);
  cfg.blockDim = dim3(lay.threads, 1, 1);
  cfg.dynamicSmemBytes = lay.smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  if (cluster) {
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = s * lay.rank_ctas;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
  } else {
    attr[0].id = cudaLaunchAttributeCooperative;
    attr[0].val.cooperative = 1;
  }
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, (const RankPtrs*)table, s, n_l, r, g,
                           thr_fp);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
