// The broadcast fan-out plan (the relay tree of a 1->N broadcast), by
// hand for Hopper (sm_90a).
//
// Replaces: the lax.fori_loop of
//   ray_tpu/ops/broadcast_kernel.py::plan_fanout (:48-92).
// Semantics: the JAX program and its numpy oracle, bit for bit in int32;
// the port's plain version is broadcast_kernel.plan_fanout_plain.
//
// Step k, until a step finds no pair (every later step is a no-op):
//   eff[p, c] = covered[p] & children[p] < fanout & member[c] & ~covered[c]
//               & bw[p, c] > 0
//               ? max(bw[p, c] // ((1 + children[p] + infl[p] // UNIT)
//                                   * (1 + depth[p])), 1) : 0
//   (p*, c*)  = the first max over the flattened p * N + c
//   parent[c*] = p*, order[c*] = k, depth[c*] = depth[p*] + 1,
//   covered[c*] = 1, children[p*] += 1
//
// What bounds it on this card: the chain of N dependent argmaxes.  The
// JAX program rescans all N^2 pairs a step; what the function needs is
// bw read once and N steps of an N-way argmax (0.0012 ms of bound at N =
// 1000, bytes).  The design keeps a step to the rescan of a few rows and
// two barriers:
//
//   * One best pair per parent, not the whole matrix.  Row p keeps the
//     packed key (INT_MAX - eff) << 32 | (p << 13 | c) << 1 of its
//     first-max child (contract.cuh's packed first-min: (p, c) order is
//     p * N + c order); a step's pair is the least key.  Bit 0 marks a
//     row whose key is being replaced (its rescan is under way).
//   * Stale keys as lower bounds, refreshed only when they surface.  An
//     attach (p*, c*) changes p*'s denominator (it may also move from <=
//     0 to > 0, so its eff can rise) and makes c* a parent: both are
//     rescanned in full.  Every other row keeps its denominator and loses
//     one candidate, c*: its true best key can only stay or grow, so the
//     key it keeps is a lower bound, and it is current while its child
//     is still wanted.  Each warp owns a run of rows and caches their
//     least key; where that key's child was taken, the warp refreshes
//     the row (the first column past the old child, in the next 256,
//     with the same eff: a column before it with that eff cannot exist;
//     on a miss the row is rescanned in full in the next round, its
//     stale key standing in meanwhile) until its least key is current.
//     A round's least key is the step's pair when it is current; where
//     it is a stale stand-in, the round attaches nothing and the next
//     one rescans that row.  With uniform bandwidth (every row's best is
//     the same child) a step refreshes one row a warp in place of every
//     row; rows that never surface are never searched again.
//   * The rows' state on chip: the key (8 B), the denominator, its magic
//     multiplier (a multiply-high in place of a division), 1 + infl //
//     UNIT, children and depth: 24 B a row, so 8192 rows fit one CTA.
//     parent and order go out at the attach (no store waits on a step).
//   * One CTA for all rows (`cta`) up to kRowsPerCta = 1024, past that
//     the rows over a thread-block cluster of 1024 rows a CTA (`cluster`:
//     a row is rescanned by its CTA's warps, and at 8192 one CTA's 16
//     warps would need several trips to HBM a rescan; dataplane_routes.py's
//     sweep of -DRT_ROWS_PER_CTA builds).  A round's join is each warp's
//     (key, depth) written into every CTA's partials (distributed shared
//     memory, by round parity) and one barrier (barrier.cluster, or
//     __syncthreads in one CTA); then each CTA's warp 0 reduces them,
//     folds the round's rescans into the rows' keys and applies the
//     attach, and one __syncthreads ends the round.  plan() takes the
//     cluster from N alone.
//   * A rescan is split into column segments over the CTA's warps (rows
//     of bw are contiguous: the reads coalesce; a power of two of them a
//     row, each one chunk of loads where the warps allow), each
//     segment's least key offered to the
//     round's join directly and stored in a slot of its own; warp 0 joins
//     a row's slots by shuffles after the join (no 64-bit shared atomics:
//     they contend).  A rescanning warp makes the row's magic multiplier
//     (a double division, corrected) while its first columns load.  A
//     warp's 64-bit minimum is two redux.sync.
//
// Exactness: infl // UNIT is an arithmetic shift by 15 (UNIT = 2**15, so
// it floors); the denominator is added and multiplied in uint32 and
// wraps as XLA's int32 does; fdiv floors for every int32 dividend (and
// bw > 0 here); a denominator of 0 or below gives eff 1, as the JAX
// program does (bw // d <= -1 there, and XLA's quotient by 0 is negative
// too); ties go to the lowest flattened index; fanout <= 0 attaches
// nothing.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "contract.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace rt;

constexpr int kThreads = 512;          // 128 registers a thread: a
                                       // rescan keeps 16 loads in flight
constexpr int kWarps = kThreads / 32;
constexpr int kPortableCluster = 8;
constexpr int kMaxCluster = 16;        // H100 allows 16 on request
#ifndef RT_ROWS_PER_CTA
#define RT_ROWS_PER_CTA 1024
#endif
// rows a CTA holds at most, where 16 CTAs allow it
constexpr int kRowsPerCta = RT_ROWS_PER_CTA;
static_assert(kRowsPerCta >= 1, "a row a CTA at least");
constexpr int kChunkLane = 16;         // a rescan: 512 columns a warp a pass
constexpr int kChunk = 32 * kChunkLane;
constexpr int kLookLane = 8;           // the look past the old child: 256
constexpr int kMaxLooks = 4;           // looks a warp a round
constexpr int kMaxList = kWarps * kMaxLooks + 2;   // rows rescanned a round
constexpr int kUnitShift = 15;         // _INFLIGHT_UNIT_KB = 32 * 1024
constexpr int kMaxShared = 232448 - 8192;   // less the static part
constexpr unsigned long long kMark = 1ull;  // a key under replacement

enum Layout { kCta = 0, kClusterRows = 1 };

struct Args {
  const uint8_t* member;   // (N,) bool
  const int* bw;           // (N, N)
  const int* inflight;     // (N,)
  int n, root, fanout;
  int* parent;             // (N,)
  int* order;              // (N,)
};

// a warp's offer to a round's join
struct Part {
  unsigned long long key;
  int depth, pad;
};

// Where everything lives, from N alone.
struct Plan {
  int layout, cluster, nloc;
  int part, best, den, mag, u1, chdep;   // shared offsets
  int smem;
};

inline int up16(long long x) { return (int)((x + 15) & ~15LL); }

inline bool place(Plan& pl, int n, int cluster) {
  pl.cluster = cluster;
  pl.nloc = (n + cluster - 1) / cluster;
  long long at = 0;
  pl.part = (int)at;
  at += up16(2LL * cluster * kWarps * sizeof(Part));
  pl.best = (int)at;
  at += up16(8LL * pl.nloc);
  pl.den = (int)at;
  at += up16(4LL * pl.nloc);
  pl.mag = (int)at;
  at += up16(4LL * pl.nloc);
  pl.u1 = (int)at;
  at += up16(4LL * pl.nloc);
  pl.chdep = (int)at;
  at += up16(4LL * pl.nloc);
  pl.smem = (int)at;
  pl.layout = cluster == 1 ? kCta : kClusterRows;
  return at <= kMaxShared;
}

// The cluster rule: kRowsPerCta rows a CTA, up to 16 CTAs, and more
// where a CTA's rows would not fit its shared memory.
inline bool plan(Plan& pl, int n) {
  int c = (n + kRowsPerCta - 1) / kRowsPerCta;
  c = c < 1 ? 1 : (c > kMaxCluster ? kMaxCluster : c);
  for (; c <= kMaxCluster; ++c)
    if (place(pl, n, c)) return true;
  return false;
}

__device__ __forceinline__ int denom_of(int children, int u1, int depth) {
  return wmul(wadd(children, u1), 1 + depth);
}
// magic(den).x (contract.cuh) for den > 0, by a double division and an
// exact correction in place of a 64-bit integer division: the quotient
// 2**s / den is below 2**32, so the double is within one of its floor.
__device__ __forceinline__ unsigned magic_of(int den) {
  if (den <= 0) return 0u;
  const unsigned s = 63u - (unsigned)__clz(den - 1);
  const double q =
      __longlong_as_double((long long)(1023 + s) << 52) / (double)den;
  unsigned long long m = (unsigned long long)q;
  long long r = (long long)((1ull << s) - m * (unsigned long long)den);
  if (r < 0) {
    --m;
    r += den;
  } else if (r >= den) {
    ++m;
    r -= den;
  }
  return (unsigned)(m + (r != 0 ? 1 : 0));
}
// eff of one candidate (b > 0) under a row's denominator and its magic
__device__ __forceinline__ int eff_of(int b, int den, unsigned m) {
  if (den <= 0) return 1;
  const unsigned sh = 63u - (unsigned)__clz(den - 1);
  return max(fdiv(b, m, sh), 1);
}
__device__ __forceinline__ unsigned long long pair_key(int eff, int p,
                                                       int c) {
  return ((unsigned long long)(unsigned)(0x7fffffff - eff) << 32) |
         ((unsigned)((p << 13) | c) << 1);
}
__device__ __forceinline__ int key_eff(unsigned long long k) {
  return 0x7fffffff - (int)(unsigned)(k >> 32);
}
__device__ __forceinline__ int key_parent(unsigned long long k) {
  return (int)((unsigned)k >> 14);
}
__device__ __forceinline__ int key_child(unsigned long long k) {
  return (int)(((unsigned)k >> 1) & kRowMask);
}
__device__ __forceinline__ bool wanted(const unsigned* want, int c) {
  return (want[c >> 5] >> (c & 31)) & 1u;
}

// The least of a warp's 64-bit keys: two redux.sync, the high words then
// the low words of the lanes that hold the least high word.
__device__ __forceinline__ unsigned long long warp_min64(
    unsigned long long x) {
  const unsigned hi = __reduce_min_sync(kFull, (unsigned)(x >> 32));
  const unsigned lo = __reduce_min_sync(
      kFull, (unsigned)(x >> 32) == hi ? (unsigned)x : 0xffffffffu);
  return ((unsigned long long)hi << 32) | lo;
}

// One warp: the least key of row p over the columns [c0, c1) of one
// chunk (c1 - c0 <= kChunk, c0 a multiple of 32), under the row's
// denominator and multiplier m; with `make`, m = the multiplier, made
// while the columns load.
__device__ __forceinline__ unsigned long long scan_chunk(
    const int* __restrict__ row, int p, int den, unsigned& m, bool make,
    const unsigned* want, int c0, int c1) {
  const int lane = threadIdx.x & 31;
  int v[kChunkLane];
#pragma unroll
  for (int j = 0; j < kChunkLane; ++j) {
    const int c = c0 + j * 32 + lane;
    v[j] = c < c1 ? __ldg(row + c) : 0;
  }
  if (make) m = magic_of(den);
  unsigned long long best = kNoKey;
#pragma unroll
  for (int j = 0; j < kChunkLane; ++j) {
    const int c = c0 + j * 32 + lane;
    // no branch a column: every lane computes, the candidates select
    const bool ok = v[j] > 0 && c < c1 && wanted(want, c);
    const unsigned long long k =
        pair_key(eff_of(max(v[j], 1), den, m), p, c);
    best = ok && k < best ? k : best;
  }
  return warp_min64(best);
}

// One warp: the first column past c_old in the next 256 whose eff is e,
// or -1.
__device__ __forceinline__ int look_past(const int* __restrict__ row, int n,
                                         int den, unsigned m,
                                         const unsigned* want, int c_old,
                                         int e) {
  const int lane = threadIdx.x & 31;
  const int a = (c_old + 1) & ~31;
  int v[kLookLane];
#pragma unroll
  for (int j = 0; j < kLookLane; ++j) {
    const int c = a + j * 32 + lane;
    v[j] = c < n ? __ldg(row + c) : 0;
  }
#pragma unroll
  for (int j = 0; j < kLookLane; ++j) {
    const int c = a + j * 32 + lane;
    const bool hit = v[j] > 0 && c > c_old && c < n && wanted(want, c) &
                     (eff_of(max(v[j], 1), den, m) == e);
    const unsigned b = __ballot_sync(kFull, hit);
    if (b) return a + j * 32 + __ffs(b) - 1;
  }
  return -1;
}

// One warp: the least key of its rows [lo, hi) not under replacement.
__device__ __forceinline__ unsigned long long own_min(
    const unsigned long long* best, int lo, int hi) {
  unsigned long long m = kNoKey;
  for (int t = lo + (threadIdx.x & 31); t < hi; t += 32) {
    const unsigned long long k = best[t];
    if (!(k & kMark) && k < m) m = k;
  }
  return warp_min64(m);
}

// The column segments a round cuts each of its nl rescanned rows of n
// columns into: enough that a segment is one chunk of loads (kChunk
// columns), at most one task a warp, and a power of two, so that a warp's
// lanes join a row's segments by shuffles.
__device__ __forceinline__ int segs_for(int nl, int n) {
  if (nl > kWarps) return 1;
  const int cap = kWarps >> (32 - __clz(nl - 1));
  const int need = (n + kChunk - 1) / kChunk;
  return min(cap, need <= 1 ? 1 : 1 << (32 - __clz(need - 1)));
}

template <bool kCluster>
__global__ void __launch_bounds__(kThreads, 1) fanout_kernel(Args in,
                                                             Plan pl) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ unsigned want[kMaxNodes / 32];      // member & ~covered
  __shared__ int s_list[2][kMaxList];            // rows rescanned a round
  __shared__ unsigned long long s_seg[2][kMaxList];   // their segments' keys
  __shared__ int s_n[2];
  __shared__ int s_dirty[kWarps];                // a warp's rows changed
  __shared__ bool s_done;                        // the last round's join
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n = in.n, fanout = in.fanout;
  const int cs = pl.cluster;
  const int rank = kCluster ? (int)cg::this_cluster().block_rank() : 0;
  const int base = rank * pl.nloc;
  const int rows = max(0, min(pl.nloc, n - base));
  Part* part = reinterpret_cast<Part*>(smem + pl.part);
  unsigned long long* best =
      reinterpret_cast<unsigned long long*>(smem + pl.best);
  int* den = reinterpret_cast<int*>(smem + pl.den);
  unsigned* mag = reinterpret_cast<unsigned*>(smem + pl.mag);
  int* u1 = reinterpret_cast<int*>(smem + pl.u1);
  // children | depth << 16
  int* chdep = reinterpret_cast<int*>(smem + pl.chdep);
  const int rpw = max(1, (rows + kWarps - 1) / kWarps);
  const int w_lo = min(rows, warp * rpw), w_hi = min(rows, w_lo + rpw);

  for (int t = tid; t < rows; t += kThreads) {
    const int p = base + t;
    const int u = 1 + (in.inflight[p] >> kUnitShift);
    u1[t] = u;
    chdep[t] = 0;
    den[t] = denom_of(0, u, 0);
    mag[t] = magic_of(den[t]);
    best[t] = kNoKey;
    in.parent[p] = -1;
    in.order[p] = -1;
  }
  for (int w = tid; w < (n + 31) / 32; w += kThreads) {
    unsigned bits = 0;
    for (int b = 0; b < 32; ++b) {
      const int c = w * 32 + b;
      if (c < n && c != in.root && in.member[c]) bits |= 1u << b;
    }
    want[w] = bits;
  }
  if (tid < kWarps) s_dirty[tid] = 1;
  if (tid == 0) {
    const int t = in.root - base;
    const bool mine = t >= 0 && t < rows && fanout > 0;
    s_n[0] = mine ? 1 : 0;
    s_n[1] = 0;
    s_list[0][0] = t;
    s_done = false;
  }
  // the block's barrier, and every CTA of the cluster has started before
  // the first round writes into its shared memory
  if (kCluster)
    cg::this_cluster().sync();
  else
    __syncthreads();

  int par = 0, step = 0;
  unsigned long long wmin = kNoKey;
  for (;;) {
    // -- a round: this round's rescans, in column segments over the warps
    const int nl = s_n[par];
    unsigned long long key = kNoKey;
    int dep = 0;
    if (nl > 0) {
      const int segs = segs_for(nl, n), lg = __ffs(segs) - 1;
      const int span = (((n + segs - 1) >> lg) + 31) & ~31;
      for (int task = warp; task < nl * segs; task += kWarps) {
        const int i = task >> lg, sg = task & (segs - 1);
        const int t = s_list[par][i];
        const int c0 = sg * span, c1 = min(n, c0 + span);
        const int* row = in.bw + (long long)(base + t) * n;
        const int d = den[t];
        unsigned m = 0;
        unsigned long long k = kNoKey;
        for (int a = c0; a < c1; a += kChunk) {
          const unsigned long long x = scan_chunk(
              row, base + t, d, m, a == c0, want, a, min(c1, a + kChunk));
          k = x < k ? x : k;
        }
        if (lane == 0) {
          s_seg[par][task] = k;
          if (sg == 0) mag[t] = m;
        }
        if (k < key) {
          key = k;
          dep = chdep[t] >> 16;
        }
      }
    }
    // this warp's least key, refreshed while its child is taken
    const bool dirty = s_dirty[warp] != 0;
    __syncwarp();
    if (dirty) {
      if (lane == 0) s_dirty[warp] = 0;
      wmin = own_min(best, w_lo, w_hi);
    }
    for (int it = 0; it < kMaxLooks && wmin != kNoKey; ++it) {
      const int c_old = key_child(wmin);
      if (wanted(want, c_old)) break;                // current
      const int p = key_parent(wmin), t = p - base, e = key_eff(wmin);
      const int hit = look_past(in.bw + (long long)p * n, n, den[t], mag[t],
                                want, c_old, e);
      if (hit < 0 && wmin < key) {                   // a stand-in, meanwhile
        key = wmin;
        dep = chdep[t] >> 16;
      }
      if (lane == 0) {
        if (hit >= 0) {
          best[t] = pair_key(e, p, hit);
        } else {
          best[t] = wmin | kMark;                    // rescanned next round
          s_list[par ^ 1][atomicAdd(&s_n[par ^ 1], 1)] = t;
        }
      }
      __syncwarp();
      wmin = own_min(best, w_lo, w_hi);
    }
    if (wmin < key) {                                // current, or past
      key = wmin;                                    // kMaxLooks: a bound
      dep = chdep[key_parent(wmin) - base] >> 16;
    }
    // the warp's offer into every CTA's partials, then the round's barrier
    Part* mine = part + par * cs * kWarps + rank * kWarps + warp;
    if (kCluster) {
      if (lane < cs) {
        Part* to = cg::this_cluster().map_shared_rank(mine, lane);
        to->key = key;
        to->depth = dep;
      }
      cg::this_cluster().sync();
    } else {
      if (lane == 0) {
        mine->key = key;
        mine->depth = dep;
      }
      __syncthreads();
    }
    // -- the join, by warp 0: the least offer and its row's depth; the
    // other warps learn the end from s_done after the round's barrier
    if (warp == 0) {
      const Part* offers = part + par * cs * kWarps;
      unsigned long long g = kNoKey;
      int gd = 0;
      for (int j = lane; j < cs * kWarps; j += 32) {
        const Part o = offers[j];
        if (o.key < g) {
          g = o.key;
          gd = o.depth;
        }
      }
      const unsigned long long least = warp_min64(g);
      gd = __shfl_sync(kFull, gd,
                       __ffs(__ballot_sync(kFull, g == least)) - 1);
      g = least;
      if (lane == 0) s_done = g == kNoKey;   // the same round in every CTA
      // fold the round's rescans into the rows' keys: each row's segments
      // joined by shuffles (segs lanes a row)
      const int nf = s_n[par];
      const int segs = nf > 0 ? segs_for(nf, n) : 1, lg = __ffs(segs) - 1;
      for (int b0 = 0; b0 < nf * segs; b0 += 32) {
        const int task = b0 + lane;
        unsigned long long v = task < nf * segs ? s_seg[par][task] : kNoKey;
        for (int o = 1; o < segs; o <<= 1) {
          const unsigned long long u = __shfl_xor_sync(kFull, v, o);
          v = u < v ? u : v;
        }
        if (task < nf * segs && (task & (segs - 1)) == 0) {
          const int t = s_list[par][task >> lg];
          best[t] = v;
          s_dirty[t / rpw] = 1;
        }
      }
      __syncwarp();
      const int ps = key_parent(g), cs_ = key_child(g);
      // a current least key is the step's pair (a stand-in is not)
      if (g != kNoKey && wanted(want, cs_)) {
        if (lane == 0) {
          const int t = ps - base;
          if (t >= 0 && t < rows) {
            const int cd = chdep[t] + 1;
            const int ch = cd & 0xffff;
            chdep[t] = cd;
            best[t] = kNoKey;
            if (ch < fanout) {              // its multiplier at the rescan
              den[t] = denom_of(ch, u1[t], cd >> 16);
              s_list[par ^ 1][atomicAdd(&s_n[par ^ 1], 1)] = t;
            }
            s_dirty[t / rpw] = 1;
          }
        } else if (lane == 1) {
          const int t = cs_ - base;
          if (t >= 0 && t < rows) {
            const int d = gd + 1;
            chdep[t] = d << 16;
            den[t] = denom_of(0, u1[t], d);
            best[t] = kNoKey;              // fanout >= 1: p* attached
            s_list[par ^ 1][atomicAdd(&s_n[par ^ 1], 1)] = t;
            s_dirty[t / rpw] = 1;
            in.parent[cs_] = ps;
            in.order[cs_] = step;
          }
        }
        __syncwarp();
        if (lane == 0) {
          s_n[par] = 0;
          want[cs_ >> 5] &= ~(1u << (cs_ & 31));
        }
        ++step;
      } else if (lane == 0) {
        s_n[par] = 0;
      }
    }
    par ^= 1;
    __syncthreads();                     // the round's state, for the next
    if (s_done) break;
  }
}

template <bool kCluster>
cudaError_t launch(const Args& in, const Plan& pl, cudaStream_t stream) {
  auto kernel = fanout_kernel<kCluster>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, pl.smem);
  if (err != cudaSuccess) return err;
  if (!kCluster) {
    kernel<<<1, kThreads, pl.smem, stream>>>(in, pl);
    return cudaGetLastError();
  }
  if (pl.cluster > kPortableCluster) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(pl.cluster, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
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

// The launch's layout for N rows: out = [layout (0 cta, 1 cluster),
// CTAs].  Returns a cudaError_t.
extern "C" int rt_fanout_plan(int n, long long* out) {
  Plan pl;
  if (n < 1 || n > kMaxNodes || !plan(pl, n))
    return (int)cudaErrorInvalidValue;
  out[0] = pl.layout;
  out[1] = pl.cluster;
  return 0;
}

// One launch of one CTA or one thread-block cluster on `stream`, as
// rt_fanout_plan lays it out.  1 <= N <= 8192, 0 <= root < N.  Writes
// parent (N,) and order (N,), and the launch's CTAs into *cluster.
// Returns a cudaError_t.
extern "C" int rt_plan_fanout(const void* member, const void* bw,
                              const void* inflight, int n, int root,
                              int fanout, void* parent, void* order,
                              int* cluster, void* stream) {
  Plan pl;
  if (n < 1 || n > kMaxNodes || root < 0 || root >= n || !plan(pl, n))
    return (int)cudaErrorInvalidValue;
  *cluster = pl.cluster;
  const Args in{(const uint8_t*)member, (const int*)bw, (const int*)inflight,
                n, root, fanout, (int*)parent, (int*)order};
  const cudaStream_t s = (cudaStream_t)stream;
  return (int)(pl.cluster > 1 ? launch<true>(in, pl, s)
                              : launch<false>(in, pl, s));
}
