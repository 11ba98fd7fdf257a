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
// JAX program rescans all N^2 pairs a step (8 N^3 operations: 0.48 ms of
// bound at N = 1000, 263 ms at 8192); what the function needs is bw read
// once and N steps of an N-way argmax (0.0012 ms at 1000, bytes).  In
// eager PyTorch each step is ~37 launches.  The design:
//
//   * One best pair per parent, not the whole matrix.  Row p keeps the
//     packed key (INT_MAX - eff) << 32 | (p * N + c) of its first-max
//     child (contract.cuh's packed first-min), and a step's pair is the
//     unsigned min over the rows' keys.
//   * Only rows whose best can have changed are rescanned.  An attach
//     (p*, c*) changes p*'s denominator (and perhaps its eligibility at
//     the fan-out cap), makes c* a parent, and takes c* from every row's
//     candidates.  Every other row keeps its eff values and loses one
//     candidate, so its best changes only where it was c*.  The floor in
//     bw // denom merges values, so a row whose denominator changed is
//     rescanned in full, never patched.  Rows that only lost their best
//     are rescanned in full with the others while all of them fit one
//     round of the CTA's warps (one memory round trip a step).  Past
//     that (with uniform bandwidth every row's best is the same child)
//     a row that lost its best (E, c0) first looks for eff == E in the
//     256 columns from c0 + 1: a candidate before c0 with eff E cannot
//     exist (c0 was the first), so a hit there is the new best, and only
//     a miss is rescanned in full.
//   * Rows over one thread-block cluster (up to 16 CTAs, 64 rows a CTA
//     below 1024 nodes, at most 512 above).  A CTA keeps its rows' keys,
//     children, depth, denominators (each with its magic multiplier: a
//     multiply-high in place of a division) and parent and order in
//     shared memory, and a replicated bitmask of member & ~covered (1 KB
//     at 8192); parent and order go out after the last step, so no
//     global store waits on a step's barrier.  It rescans its dirty
//     rows with all its warps, 512-column segments of a full row at a
//     time (rows of bw are contiguous: the reads coalesce) and a 64-bit
//     shared atomicMin to join them.  Then warp 0 pushes the CTA's least
//     key and that row's depth into every CTA's shared memory
//     (distributed shared memory, by step parity), and one
//     barrier.cluster ends the step: every CTA then reads the same pair.
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

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerCta = 64;        // the cluster grows while above
constexpr int kPortableCluster = 8;
constexpr int kMaxCluster = 16;        // H100 allows 16 on request
constexpr int kMaxRows = kMaxNodes / kMaxCluster;   // 512 = kThreads
constexpr int kSegLane = 16;           // a full scan: 512 columns a warp
constexpr int kSeg = 32 * kSegLane;
constexpr int kLookLane = 8;           // the look past c0: 256 columns
constexpr int kUnitShift = 15;         // _INFLIGHT_UNIT_KB = 32 * 1024

struct Args {
  const uint8_t* member;   // (N,) bool
  const int* bw;           // (N, N)
  const int* inflight;     // (N,)
  int n, root, fanout;
  int* parent;             // (N,)
  int* order;              // (N,)
};

struct Shared {
  unsigned long long best[kMaxRows];   // each row's packed best, or kNoKey
  int children[kMaxRows];
  int depth[kMaxRows];
  int units[kMaxRows];                 // infl // UNIT
  int denom[kMaxRows];                 // (1 + children + units) * (1 + depth)
  uint2 mag[kMaxRows];                 // its magic multiplier (denom > 0)
  int parent[kMaxRows], order[kMaxRows];   // written out after the loop
  unsigned want[kMaxNodes / 32];       // member & ~covered
  unsigned long long old[kMaxRows];    // a look row's best before it
  int full[kMaxRows];                  // rows to rescan in full
  int look[kMaxRows];                  // rows that lost their best child
  int miss[kMaxRows];                  // look rows rescanned in full
  int nfull, nlook, nmiss;
  // each CTA's least key and its row's depth, by step parity
  unsigned long long slot_key[2][kMaxCluster];
  int slot_depth[2][kMaxCluster];
};

__device__ __forceinline__ int denom_of(int children, int units, int depth) {
  return wmul(wadd(1 + children, units), 1 + depth);
}
__device__ __forceinline__ uint2 magic_of(int den) {
  return den > 0 ? magic(den) : make_uint2(0u, 0u);
}
// eff of one candidate (b > 0) under a row's denominator and its magic
__device__ __forceinline__ int eff_of(int b, int den, uint2 mg) {
  return den > 0 ? max(fdiv(b, mg.x, mg.y), 1) : 1;
}
__device__ __forceinline__ unsigned long long pair_key(int eff, int idx) {
  return ((unsigned long long)(unsigned)(0x7fffffff - eff) << 32) |
         (unsigned)idx;
}
__device__ __forceinline__ bool wanted(const unsigned* want, int c) {
  return (want[c >> 5] >> (c & 31)) & 1u;
}

// One warp: the least key of row p over columns [c0, c0 + kSeg), c0 a
// multiple of 32.
__device__ __forceinline__ unsigned long long scan_segment(
    const int* __restrict__ row, int p, int n, int den, uint2 mg,
    const unsigned* want, int c0) {
  const int lane = threadIdx.x & 31;
  int v[kSegLane];
#pragma unroll
  for (int j = 0; j < kSegLane; ++j) {
    const int c = c0 + j * 32 + lane;
    v[j] = c < n ? __ldg(row + c) : 0;
  }
  unsigned long long best = kNoKey;
#pragma unroll
  for (int j = 0; j < kSegLane; ++j) {
    const int c = c0 + j * 32 + lane;
    if (v[j] > 0 && c < n && wanted(want, c)) {
      const unsigned long long k =
          pair_key(eff_of(v[j], den, mg), p * n + c);
      best = k < best ? k : best;
    }
  }
  return warp_min(best);
}

// One warp: the first column past c_old in the next 256 whose eff is e,
// or -1.
__device__ __forceinline__ int look_past(const int* __restrict__ row, int n,
                                         int den, uint2 mg,
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
    const bool hit = v[j] > 0 && c > c_old && c < n && wanted(want, c) &&
                     eff_of(v[j], den, mg) == e;
    const unsigned b = __ballot_sync(kFull, hit);
    if (b) return a + j * 32 + __ffs(b) - 1;
  }
  return -1;
}

__global__ void __launch_bounds__(kThreads, 1) fanout_kernel(Args in) {
  __shared__ Shared sh;
  cg::cluster_group cl = cg::this_cluster();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n = in.n, fanout = in.fanout;
  const int cs = (int)cl.num_blocks(), rank = (int)cl.block_rank();
  const int per = (n + cs - 1) / cs;
  const int base = rank * per;
  const int rows = max(0, min(per, n - base));
  const int nseg = (n + kSeg - 1) / kSeg;

  if (tid < rows) {
    const int p = base + tid;
    const int u = in.inflight[p] >> kUnitShift;
    sh.best[tid] = kNoKey;
    sh.children[tid] = 0;
    sh.depth[tid] = 0;
    sh.units[tid] = u;
    sh.denom[tid] = denom_of(0, u, 0);
    sh.mag[tid] = magic_of(sh.denom[tid]);
    sh.parent[tid] = -1;
    sh.order[tid] = -1;
  }
  for (int w = tid; w < (n + 31) / 32; w += kThreads) {
    unsigned bits = 0;
    for (int b = 0; b < 32; ++b) {
      const int c = w * 32 + b;
      if (c < n && c != in.root && in.member[c]) bits |= 1u << b;
    }
    sh.want[w] = bits;
  }
  if (tid == 0) {
    const int t = in.root - base;
    const bool mine = t >= 0 && t < rows && fanout > 0;
    sh.nfull = mine ? 1 : 0;
    sh.full[0] = t;
    sh.nlook = 0;
    sh.nmiss = 0;
  }
  // the block's barrier, and every CTA of the cluster has started before
  // the first step writes into its shared memory
  cl.sync();

  int parity = 0;
  for (int k = 0;; ++k) {
    // Rows that lost their best child: few are rescanned in full at
    // once, with the rows an attach changed (one memory round trip); many
    // (the uniform case) first look for the old best's equal past it.
    const int nfull = sh.nfull, nlook = sh.nlook;
    const bool direct = (nfull + nlook) * nseg <= kWarps;
    if (!direct) {
      for (int i = warp; i < nlook; i += kWarps) {
        const int t = sh.look[i], p = base + t;
        const unsigned long long old = sh.old[t];
        const int e = 0x7fffffff - (int)(unsigned)(old >> 32);
        const int c_old = (int)(unsigned)old - p * n;
        const int c = look_past(in.bw + (long long)p * n, n, sh.denom[t],
                                sh.mag[t], sh.want, c_old, e);
        if (lane == 0) {
          if (c >= 0)
            sh.best[t] = pair_key(e, p * n + c);
          else
            sh.miss[atomicAdd(&sh.nmiss, 1)] = t;
        }
      }
      __syncthreads();
    }
    // full rescans, a 512-column segment a warp: the changed rows, then
    // the look rows (direct) or their misses
    const int* more = direct ? sh.look : sh.miss;
    const int nrows = nfull + (direct ? nlook : sh.nmiss);
    for (int u = warp; u < nrows * nseg; u += kWarps) {
      const int i = u / nseg;
      const int t = i < nfull ? sh.full[i] : more[i - nfull];
      const int p = base + t;
      const unsigned long long key =
          scan_segment(in.bw + (long long)p * n, p, n, sh.denom[t],
                       sh.mag[t], sh.want, (u - i * nseg) * kSeg);
      if (lane == 0 && key != kNoKey) atomicMin(&sh.best[t], key);
    }
    __syncthreads();
    // this CTA's least key, pushed into every CTA's slot [rank]
    if (warp == 0) {
      unsigned long long m = kNoKey;
      for (int t = lane; t < rows; t += 32) {
        const unsigned long long x = sh.best[t];
        m = x < m ? x : m;
      }
      m = warp_min(m);
      const int d =
          m == kNoKey ? 0 : sh.depth[(int)((unsigned)m / (unsigned)n) - base];
      if (lane < cs) {
        *cl.map_shared_rank(&sh.slot_key[parity][rank], lane) = m;
        *cl.map_shared_rank(&sh.slot_depth[parity][rank], lane) = d;
      }
      if (lane == 0) {
        sh.nfull = 0;
        sh.nlook = 0;
        sh.nmiss = 0;
      }
    }
    cl.sync();
    // every warp: the least of the CTAs' keys, and its row's depth
    const unsigned long long mine =
        lane < cs ? sh.slot_key[parity][lane] : kNoKey;
    const unsigned long long g = warp_min(mine);
    const int from = __ffs(__ballot_sync(kFull, mine == g)) - 1;
    const int gd = __shfl_sync(kFull, lane < cs ? sh.slot_depth[parity][lane]
                                                : 0, from);
    parity ^= 1;
    if (g == kNoKey) break;              // the same step in every CTA
    const int idx = (int)(unsigned)g;
    const int ps = idx / n, cs_ = idx - ps * n;
    if (tid < rows) {
      const int t = tid, p = base + t;
      if (p == ps) {
        const int ch = sh.children[t] + 1;
        sh.children[t] = ch;
        sh.best[t] = kNoKey;
        if (ch < fanout) {
          sh.denom[t] = denom_of(ch, sh.units[t], sh.depth[t]);
          sh.mag[t] = magic_of(sh.denom[t]);
          sh.full[atomicAdd(&sh.nfull, 1)] = t;
        }
      } else if (p == cs_) {
        const int d = gd + 1;
        sh.depth[t] = d;
        sh.denom[t] = denom_of(0, sh.units[t], d);
        sh.mag[t] = magic_of(sh.denom[t]);
        sh.best[t] = kNoKey;
        sh.full[atomicAdd(&sh.nfull, 1)] = t;   // fanout >= 1: p* attached
        sh.parent[t] = ps;
        sh.order[t] = k;
      } else {
        const unsigned long long key = sh.best[t];
        if (key != kNoKey && (int)(unsigned)key - p * n == cs_) {
          sh.old[t] = key;
          sh.best[t] = kNoKey;
          sh.look[atomicAdd(&sh.nlook, 1)] = t;
        }
      }
    }
    if (tid == 0) sh.want[cs_ >> 5] &= ~(1u << (cs_ & 31));
    __syncthreads();
  }
  if (tid < rows) {
    in.parent[base + tid] = sh.parent[tid];
    in.order[base + tid] = sh.order[tid];
  }
}

// The cluster for n rows, a fixed rule: 64 rows a CTA, up to 16 CTAs.
int cluster_for(int n) {
  const int c = (n + kRowsPerCta - 1) / kRowsPerCta;
  return c < 1 ? 1 : (c > kMaxCluster ? kMaxCluster : c);
}

}  // namespace

// One launch of one thread-block cluster on `stream`.  1 <= N <= 8192,
// 0 <= root < N.  Writes parent (N,) and order (N,).  Returns a
// cudaError_t.
extern "C" int rt_plan_fanout(const void* member, const void* bw,
                              const void* inflight, int n, int root,
                              int fanout, void* parent, void* order,
                              int* cluster, void* stream) {
  if (n < 1 || n > kMaxNodes || root < 0 || root >= n)
    return (int)cudaErrorInvalidValue;
  const int cs = cluster_for(n);
  *cluster = cs;
  cudaError_t err;
  if (cs > kPortableCluster) {
    err = cudaFuncSetAttribute(
        fanout_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return (int)err;
  }
  const Args in{(const uint8_t*)member, (const int*)bw, (const int*)inflight,
                n, root, fanout, (int*)parent, (int*)order};
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cs, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, fanout_kernel, in);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
