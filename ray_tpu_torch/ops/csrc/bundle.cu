// Gang placement of placement groups, by hand for Hopper (sm_90a).
//
// Replaces: the two nested lax.scans of
//   ray_tpu/ops/bundle_kernel.py::schedule_bundle_groups (:89-119): the
//   scan over groups carrying avail, the bundle scan of _place_soft
//   (:47-74) and _place_strict_pack (:77-85).
// Semantics: scheduling/bundles.py (the CPU oracle) and the JAX program,
// bit for bit in int32; the port's plain version is
// bundle_kernel.schedule_bundle_groups_plain.
//
// Per group p, in order, with avail carried from group to group:
//   STRICT_PACK: total = the wrapping int32 sum of its valid bundles,
//     clamped to MAX_TOTAL_CU + 1; one first-argmin of _avail_keys
//     (keys with unavailable rows forced to INF) over node_mask; ok when
//     the minimum is not INF; the row takes the total.
//   PACK / SPREAD / STRICT_SPREAD: bundle by bundle, a first-argmin over
//     the primary rows (PACK: rows this group already used, else the
//     unused ones) and one over every row; the primary row if it is
//     found, else (not STRICT_SPREAD) the other; the row takes the
//     bundle.  An invalid slot places nothing and cannot fail the group
//     (place = found & v, ok &= found | ~v).
//   A group that fails leaves avail as it was and places nothing.
//
// What bounds it on this card: the latency of the chain of bundle steps
// (about P x B of them), not bytes or operations (a call at 1000 nodes x
// 64 groups x 8 bundles moves ~0.1 MB and needs ~25 M integer
// operations: 0.0015 ms of bound).  Each step reads the avail the last
// one wrote.  The design keeps a step to one key pass from shared memory
// and one barrier:
//
//   * Requests compacted off the chain.  The requests never depend on
//     avail, so before the chain every thread of the launch takes slots
//     in turn: each valid bundle's positive columns (then its negative
//     ones, which a debit also moves) and each STRICT_PACK group's
//     clamped wrapping sum go to a list in a global scratch, a group's
//     lists and its strategy in one block of ints.  The chain copies the
//     next group's block into shared memory (cp.async) while it runs the
//     current one, and never reads the request tensors.
//   * Reciprocals.  Each (row, column) divisor max(totals, 1) gets its
//     magic multiplier once, in the prologue; the key pass multiplies
//     where it divided (contract.cuh contract_key_rcp, the same key bit
//     for bit).
//   * Rows on chip, split over a thread-block cluster.  Each CTA holds a
//     slice of the rows, column-major (a warp's lanes read neighbouring
//     rows: no bank conflicts), a thread a row up to 1024: totals,
//     multipliers and avail in shared memory where the slice fits
//     (`shared`, one CTA; `cluster`, up to 16), else all three in a
//     column-major global scratch (`global`: past 16 CTAs' shared
//     memory, e.g. 8192 rows x 64 kinds).  A step's key pass is bound by
//     issuing its instructions (~25 a positive column and row), so the
//     rule also spreads the rows to at most kRowsPerCta = 128 a CTA where
//     16 CTAs allow it: of 64-1024 in dataplane_routes.py's sweep of
//     -DRT_ROWS_PER_CTA builds, the fastest at 2 x 8 bundles, within 4%
//     of the fastest (64) at 1000 nodes, level with the rest at 8192
//     (PERF.md, PR 14).  plan() chooses from the shape, before the
//     launch, and the wrapper reports it
//     (`schedule_bundle_groups.last_layout`).
//   * One barrier a step.  Where N <= MAX_NODES a finite key's low bits
//     are its row, so each warp's two minimums are two redux.sync and
//     two atomicMin into every CTA's slot for the step (distributed
//     shared memory in a cluster; three slots in turn, each reset two
//     steps ahead); one barrier (barrier.cluster, or __syncthreads in
//     one CTA), and every thread reads both.  Past MAX_NODES each warp
//     pushes its (key, row) pairs instead, and every warp joins them.
//   * Debits by the row's owner.  Row i of a slice is always handled by
//     thread i mod (its CTA's threads): that thread debits it, stamps it
//     used (the `used` flag is the group's index, so nothing is
//     cleared), and is the one that reads it in the next key pass, so no
//     barrier orders a debit.  A failed group gives its bundles back from
//     a log of its placed rows, by the same owners (two barriers, on
//     failure only).  avail goes out to new_avail once, after the last
//     group.
//
// Exactness: int32 arithmetic wraps like XLA's, `//` floors
// (contract.cuh floordiv, or fdiv by the magic multiplier); the argmins
// break ties to the lowest row and give no row on an all-INF minimum
// (then nothing is debited: the bundle is not found); STRICT_PACK's sum
// wraps before its clamp, as jnp's int32 sum.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "contract.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace rt;

constexpr int kThreads = 1024;
constexpr int kStrictPack = 2, kPack = 0, kStrictSpread = 3;
constexpr int kMaxTotalCu = 1 << 17;     // common/resources.MAX_TOTAL_CU
constexpr int kMaxShared = 232448;       // an H100 block's shared memory
constexpr int kMaxCluster = 16;
constexpr int kPortableCluster = 8;
constexpr int kStageMax = 32 * 1024;     // two group blocks, at most
constexpr int kDead = (int)0x80000000;   // a row outside node_mask
constexpr unsigned kNoRow = 0xffffffffu;
#ifndef RT_ROWS_PER_CTA
#define RT_ROWS_PER_CTA 128
#endif
// rows a CTA holds at most, where 16 CTAs allow it
constexpr int kRowsPerCta = RT_ROWS_PER_CTA;
static_assert(kRowsPerCta >= 1, "a row a CTA at least");

enum Layout { kShared = 0, kClusterRows = 1, kGlobal = 2 };

struct Args {
  const int* totals;        // (N, R)
  const int* avail;         // (N, R)
  const bool* node_mask;    // (N,)
  const int* reqs;          // (P, B, R)
  const bool* valid;        // (P, B)
  const int* strategies;    // (P,)
  int n, r, p, b, thr_fp;
  int* rows;                // (P, B)
  bool* ok;                 // (P,)
  int* new_avail;           // (N, R)
  int* lists;               // scratch: P group blocks of `group` ints
  int* cols;                // scratch (`global`): totals, multipliers and
                            // avail, column-major (R, N) each
};

// Where everything lives, from the shape alone.
struct Plan {
  int layout, cluster, nloc, threads;    // rows and threads a CTA
  int slot, group;                       // ints a slot, a group block
  bool stage;                            // group blocks in shared memory
  long long list_ints, col_ints;         // the scratches
  int part, mins, stage_at, placed, meta, a, t, m;   // shared offsets
  int smem;
};

__host__ __device__ inline int up16(long long x) {
  return (int)((x + 15) & ~15LL);
}

// the offsets of a CTA's shared memory, with the rows' three arrays on
// chip or not; false where it passes the limit
inline bool place(Plan& pl, int n, int r, int b, int cluster, bool on_chip,
                  bool stage) {
  pl.cluster = cluster;
  pl.nloc = (n + cluster - 1) / cluster;
  // a thread a row, up to 1024 (a warp at least)
  pl.threads = min(kThreads, max(32, (pl.nloc + 31) & ~31));
  pl.stage = stage;
  long long at = 0;
  pl.part = (int)at;
  at += up16(2LL * cluster * (pl.threads / 32) * 16);
  pl.mins = (int)at;                     // 3 x (v0, v1)
  at += 32;
  pl.stage_at = (int)at;
  if (stage) at += up16(2LL * pl.group * 4);
  pl.placed = (int)at;
  at += up16(4LL * (b + 1));
  pl.meta = (int)at;
  at += up16(4LL * pl.nloc);
  const long long cells = up16(4LL * pl.nloc * r);
  pl.a = (int)at;                        // avail, totals, multipliers
  pl.t = pl.a + (int)cells;
  pl.m = pl.t + (int)cells;
  if (on_chip) at += 3 * cells;
  pl.smem = (int)at;
  return at <= kMaxShared;
}

// The layout rule: the rows' arrays on chip (`shared` in one CTA,
// `cluster` in more), else in global memory with only the rows' flags on
// chip (`global`), each in the fewest CTAs that hold it, or more where
// that leaves a CTA more than kRowsPerCta rows (up to 16).  Group blocks
// are staged in shared memory while two take 32 KB or less.
inline bool plan(Plan& pl, int n, int r, int p, int b) {
  pl.slot = 2 + 2 * r;
  pl.group = (2 + (b + 1) * pl.slot + 3) & ~3;   // 16-byte blocks
  pl.list_ints = (long long)p * pl.group;
  const bool stage = 2LL * pl.group * 4 <= kStageMax;
  const int want =
      min(kMaxCluster, max(1, (n + kRowsPerCta - 1) / kRowsPerCta));
  for (bool on_chip : {true, false})
    for (int c = 1; c <= kMaxCluster; ++c) {
      if (!place(pl, n, r, b, c, on_chip, stage)) continue;
      if (c < want && !place(pl, n, r, b, want, on_chip, stage))
        place(pl, n, r, b, c, on_chip, stage);
      pl.layout = !on_chip ? kGlobal
                           : pl.cluster == 1 ? kShared : kClusterRows;
      pl.col_ints = on_chip ? 0 : 3LL * n * r;
      return true;
    }
  return false;
}

// a warp's first minimum of (key, row) pairs: the least key, then the
// least row holding it.  Where N <= MAX_NODES a finite key's low 13 bits
// are its row (keys of distinct rows differ), so one redux.sync gives
// both.
__device__ __forceinline__ void warp_first_min(int& k, unsigned& row,
                                               bool packed) {
  const int km = __reduce_min_sync(kFull, k);
  if (packed)
    row = km == kInfKey ? kNoRow : (unsigned)(km & kRowMask);
  else
    row = __reduce_min_sync(kFull, k == km ? row : kNoRow);
  k = km;
}
__device__ __forceinline__ void first_min(int& k, unsigned& row, int k2,
                                          unsigned r2) {
  if (k2 < k || (k2 == k && r2 < row)) {
    k = k2;
    row = r2;
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// A slot's entries from value(c) (a bundle's request, or a group's
// clamped sum): its positive columns, then its negative ones, with the
// values of 8 columns in flight at a time.
template <class Value>
__device__ __forceinline__ void compact_slot(int* slot, int r, Value value) {
  int k = 0, npos = 0;
  for (int pass = 0; pass < 2; ++pass) {
    for (int c0 = 0; c0 < r; c0 += 8) {
      int v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) v[u] = c0 + u < r ? value(c0 + u) : 0;
#pragma unroll
      for (int u = 0; u < 8; ++u)
        if (pass == 0 ? v[u] > 0 : v[u] < 0) {
          slot[2 + 2 * k] = c0 + u;
          slot[3 + 2 * k] = v[u];
          ++k;
        }
    }
    if (pass == 0) npos = k;
  }
  slot[0] = npos;
  slot[1] = k;
}

// Every thread of the launch: the group blocks.  Block p is
//   [strategy, 0, slot 0 .. slot B], slot = [npos, nnz, (col, q) x nnz]
// with the positive entries first; npos = -1 marks an invalid bundle;
// slot B is a STRICT_PACK group's clamped sum.
__device__ __forceinline__ void compact_groups(const Args& in,
                                               const Plan& pl, int gtid,
                                               int gthreads) {
  const int r = in.r, nb = in.b;
  const long long nslots = (long long)in.p * (nb + 1);
  for (long long s = gtid; s < nslots; s += gthreads) {
    const int p = (int)(s / (nb + 1)), j = (int)(s % (nb + 1));
    int* blk = in.lists + (long long)p * pl.group;
    int* slot = blk + 2 + (long long)j * pl.slot;
    const int strategy = in.strategies[p];
    const bool strict = strategy == kStrictPack;
    const bool* valid = in.valid + (long long)p * nb;
    const int* preq = in.reqs + (long long)p * nb * r;
    if (j < nb) {
      if (!valid[j] || strict) {
        slot[0] = valid[j] ? 0 : -1;
        slot[1] = 0;
      } else {
        const int* q = preq + (long long)j * r;
        compact_slot(slot, r, [&](int c) { return q[c]; });
      }
      continue;
    }
    blk[0] = strategy;
    blk[1] = 0;
    if (!strict) {
      slot[0] = slot[1] = 0;
      continue;
    }
    compact_slot(slot, r, [&](int c) {
      unsigned sum = 0;                  // the int32 sum wraps, then clamps
      for (int jj = 0; jj < nb; ++jj)
        if (valid[jj]) sum += (unsigned)preq[(long long)jj * r + c];
      return min((int)sum, kMaxTotalCu + 1);
    });
  }
}

template <bool kOnChip, bool kCluster>
__global__ void __launch_bounds__(kThreads, 1) bundle_kernel(Args in,
                                                             Plan pl) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nt = pl.threads, nw = nt >> 5;
  const int n = in.n, r = in.r, nb = in.b, cs = pl.cluster;
  const bool packed = n <= kMaxNodes;
  const int rank = kCluster ? (int)cg::this_cluster().block_rank() : 0;
  const int nloc = pl.nloc, base = rank * nloc;
  const int rows = max(0, min(nloc, n - base));
  int4* part = reinterpret_cast<int4*>(smem + pl.part);
  int* stage = reinterpret_cast<int*>(smem + pl.stage_at);
  int* placed = reinterpret_cast<int*>(smem + pl.placed);
  int* meta = reinterpret_cast<int*>(smem + pl.meta);
  // (column c, local row i) at x[c * st + i]
  int* av = kOnChip ? reinterpret_cast<int*>(smem + pl.a)
                    : in.cols + 2LL * n * r + base;
  int* tt = kOnChip ? reinterpret_cast<int*>(smem + pl.t) : in.cols + base;
  unsigned* mm = reinterpret_cast<unsigned*>(
      kOnChip ? reinterpret_cast<int*>(smem + pl.m)
              : in.cols + (long long)n * r + base);
  const int st = kOnChip ? nloc : n;
  int* mins = reinterpret_cast<int*>(smem + pl.mins);   // 3 x (v0, v1)

  // prologue, off the chain: the group blocks, and this CTA's rows
  // (written column-major; a row's columns share its cache lines)
  compact_groups(in, pl, rank * nt + tid, cs * nt);
  const int* t_in = in.totals + (long long)base * r;
  const int* a_in = in.avail + (long long)base * r;
  for (int c = 0; c < r; ++c)
    for (int i = tid; i < rows; i += nt) {
      const int t = t_in[(long long)i * r + c];
      tt[c * st + i] = t;
      mm[c * st + i] = magic(max(t, 1)).x;
      av[c * st + i] = a_in[(long long)i * r + c];
    }
  for (int i = tid; i < rows; i += nt)
    meta[i] = in.node_mask[base + i] ? -1 : kDead;
  if (tid < 6) mins[tid] = kInfKey;
  // the lists are written: every CTA reads them (and in a cluster, every
  // CTA has started before the first push into its shared memory)
  if (kCluster)
    cg::this_cluster().sync();
  else
    __syncthreads();
  if (pl.stage && in.p > 0) {
    for (int k = tid; k < pl.group / 4; k += nt)
      cp_async16(stage + 4 * k, in.lists + 4 * k);
  }

  int parity = 0;
  for (int p = 0; p < in.p; ++p) {
    const int* blk;
    if (pl.stage) {
      cp_async_wait();
      __syncthreads();                   // group p's block has landed
      blk = stage + (p & 1) * pl.group;
      if (p + 1 < in.p) {
        const int* nxt = in.lists + (long long)(p + 1) * pl.group;
        int* dst = stage + ((p + 1) & 1) * pl.group;
        for (int k = tid; k < pl.group / 4; k += nt)
          cp_async16(dst + 4 * k, nxt + 4 * k);
      }
    } else {
      blk = in.lists + (long long)p * pl.group;
    }
    const int strategy = blk[0];
    const bool strict = strategy == kStrictPack;
    if (tid == 0)
      for (int j = 0; j < nb; ++j) placed[j] = -1;
    bool ok = true;
    int node = 0;

    // one step: the two first-minimums of the slot's keys (v0 over the
    // primary rows, v1 over every live row), then the owner's debit
    const int nsteps = strict ? 1 : nb;
    for (int j = 0; j < nsteps; ++j) {
      const int* slot = blk + 2 + (long long)(strict ? nb : j) * pl.slot;
      const int npos = slot[0], nnz = slot[1];
      if (npos < 0) continue;            // an invalid bundle
      const int2* ent = reinterpret_cast<const int2*>(slot + 2);
      int k0 = kInfKey, k1 = kInfKey;
      unsigned r0 = kNoRow, r1 = kNoRow;
      for (int i = tid; i < rows; i += nt) {
        const int mt = meta[i];
        if (mt == kDead) continue;
        int key = contract_key_rcp(
            [&](int e, int& t, int& a, unsigned& m, int& q) {
              const int2 cq = ent[e];
              t = tt[cq.x * st + i];
              m = mm[cq.x * st + i];
              a = av[cq.x * st + i];
              q = cq.y;
            },
            npos, true, in.thr_fp, base + i);
        // _avail_keys: a feasible but unavailable row is INF
        if ((key >> kAvailShift) & 1) key = kInfKey;
        const unsigned row = (unsigned)(base + i);
        first_min(k1, r1, key, row);
        const bool primary = (mt == p) == (strategy == kPack);
        if (!strict && primary) first_min(k0, r0, key, row);
      }
      warp_first_min(k0, r0, packed);
      warp_first_min(k1, r1, packed);
      if (packed) {
        // a key names its row: each warp's two minimums go into every
        // CTA's slot of this step by atomicMin (three slots in turn: the
        // one two steps ahead is reset once every thread has read it)
        int* slot = mins + 2 * parity;
        if (kCluster) {
          if (lane < cs) {
            int* to = cg::this_cluster().map_shared_rank(slot, lane);
            if (k0 != kInfKey) atomicMin(to, k0);
            if (k1 != kInfKey) atomicMin(to + 1, k1);
          }
          cg::this_cluster().sync();
        } else {
          if (lane == 0) {
            if (k0 != kInfKey) atomicMin(slot, k0);
            if (k1 != kInfKey) atomicMin(slot + 1, k1);
          }
          __syncthreads();
        }
        k0 = slot[0];
        k1 = slot[1];
        r0 = k0 == kInfKey ? kNoRow : (unsigned)(k0 & kRowMask);
        r1 = k1 == kInfKey ? kNoRow : (unsigned)(k1 & kRowMask);
        if (tid == 0) {
          int* ahead = mins + 2 * (parity == 0 ? 2 : parity - 1);
          ahead[0] = ahead[1] = kInfKey;
        }
        parity = parity == 2 ? 0 : parity + 1;
      } else {
        // each warp's pair into every CTA's partials, by step parity
        int4* mine = part + (parity & 1) * cs * nw;
        const int4 v = make_int4(k0, (int)r0, k1, (int)r1);
        if (kCluster) {
          if (lane < cs)
            *cg::this_cluster().map_shared_rank(mine + rank * nw + warp,
                                                lane) = v;
          cg::this_cluster().sync();
        } else {
          if (lane == 0) mine[warp] = v;
          __syncthreads();
        }
        k0 = k1 = kInfKey;
        r0 = r1 = kNoRow;
        for (int w = lane; w < cs * nw; w += 32) {
          const int4 x = mine[w];
          first_min(k0, r0, x.x, (unsigned)x.y);
          first_min(k1, r1, x.z, (unsigned)x.w);
        }
        warp_first_min(k0, r0, false);
        warp_first_min(k1, r1, false);
        parity ^= 1;
      }
      const bool ok1 = k0 != kInfKey, ok2 = k1 != kInfKey;
      bool found;
      if (strict) {
        found = ok2;
        node = (int)r1;
      } else {
        found = ok1 || (strategy != kStrictSpread && ok2);
        node = ok1 ? (int)r0 : (int)r1;
      }
      if (!found) {
        ok = false;                      // uniform: every thread agrees
        break;
      }
      const int i = node - base;
      if (i >= 0 && i < rows && i % nt == tid) {
        for (int e = 0; e < nnz; ++e) {
          const int2 cq = ent[e];
          int* a = av + cq.x * st + i;
          *a = wsub(*a, cq.y);
        }
        meta[i] = p;                     // used by this group
      }
      if (tid == 0 && !strict) placed[j] = node;
    }
    if (!ok && !strict) {
      // give the placed bundles back, each by its row's owner
      __syncthreads();
      for (int j = 0; j < nb; ++j) {
        const int i = placed[j] - base;
        if (placed[j] < 0 || i < 0 || i >= rows || i % nt != tid) continue;
        const int* slot = blk + 2 + (long long)j * pl.slot;
        const int2* ent = reinterpret_cast<const int2*>(slot + 2);
        for (int e = 0; e < slot[1]; ++e) {
          int* a = av + ent[e].x * st + i;
          *a = wadd(*a, ent[e].y);
        }
      }
      __syncthreads();                   // placed, before the next group
    }
    if (rank == 0 && tid == 0) {
      int* out = in.rows + (long long)p * nb;
      for (int j = 0; j < nb; ++j) {
        const int* slot = blk + 2 + (long long)j * pl.slot;
        out[j] = !ok ? -1 : strict ? (slot[0] >= 0 ? node : -1) : placed[j];
      }
      in.ok[p] = ok;
    }
  }
  // avail out, once (every owner's last debit first)
  __syncthreads();
  int* a_out = in.new_avail + (long long)base * r;
  for (int c = 0; c < r; ++c)
    for (int i = tid; i < rows; i += nt)
      a_out[(long long)i * r + c] = av[c * st + i];
}

template <bool kOnChip, bool kCluster>
cudaError_t launch(const Args& in, const Plan& pl, cudaStream_t stream) {
  auto kernel = bundle_kernel<kOnChip, kCluster>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, pl.smem);
  if (err != cudaSuccess) return err;
  if (!kCluster) {
    kernel<<<1, pl.threads, pl.smem, stream>>>(in, pl);
    return cudaGetLastError();
  }
  if (pl.cluster > kPortableCluster) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(pl.cluster, 1, 1);
  cfg.blockDim = dim3(pl.threads, 1, 1);
  cfg.dynamicSmemBytes = pl.smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = pl.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, in, pl);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// The launch's layout for a shape: out = [layout (0 shared, 1 cluster,
// 2 global), CTAs, threads a CTA, list scratch ints, column scratch
// ints].  Returns a cudaError_t (cudaErrorInvalidValue where no layout
// holds the rows' flags).
extern "C" int rt_bundle_plan(int n, int r, int p, int b, long long* out) {
  if (n < 1 || r < 1 || p < 0 || b < 0) return (int)cudaErrorInvalidValue;
  Plan pl;
  if (!plan(pl, n, r, p, b)) return (int)cudaErrorInvalidValue;
  out[0] = pl.layout;
  out[1] = pl.cluster;
  out[2] = pl.threads;
  out[3] = pl.list_ints;
  out[4] = pl.col_ints;
  return 0;
}

// One launch on `stream` of one CTA or one thread-block cluster, as
// rt_bundle_plan lays it out; `lists` and `cols` hold the ints it names.
// Writes rows (P, B), ok (P,) and new_avail (N, R).  Returns a
// cudaError_t.
extern "C" int rt_bundle_schedule(const void* totals, const void* avail,
                                  const void* node_mask, const void* reqs,
                                  const void* valid, const void* strategies,
                                  int n, int r, int p, int b, int thr_fp,
                                  void* rows, void* ok, void* new_avail,
                                  void* lists, void* cols, void* stream) {
  if (n < 1 || r < 1 || p < 0 || b < 0) return (int)cudaErrorInvalidValue;
  Plan pl;
  if (!plan(pl, n, r, p, b)) return (int)cudaErrorInvalidValue;
  const Args in{(const int*)totals, (const int*)avail,
                (const bool*)node_mask, (const int*)reqs,
                (const bool*)valid, (const int*)strategies, n, r, p, b,
                thr_fp, (int*)rows, (bool*)ok, (int*)new_avail,
                (int*)lists, (int*)cols};
  const cudaStream_t s = (cudaStream_t)stream;
  const bool cl = pl.cluster > 1;
  if (pl.layout == kGlobal)
    return (int)(cl ? launch<false, true>(in, pl, s)
                    : launch<false, false>(in, pl, s));
  return (int)(cl ? launch<true, true>(in, pl, s)
                  : launch<true, false>(in, pl, s));
}
