// The grouped water-fill scan of the scheduling heartbeat, by hand for
// Hopper (sm_90a).
//
// Replaces: the lax.scan over scheduling classes in
//   ray_tpu/ops/hybrid_kernel.py::schedule_grouped (its scan) and
//   ray_tpu/ops/hybrid_kernel.py::fused_beat (its scan), whose body is
//   ray_tpu/ops/hybrid_kernel.py::_schedule_group with the 15-step
//   bisection of _slots_at_or_below.
// Semantics: scheduling/contract.py, bit for bit in int32.
//
// What bounds it on this card: neither bytes nor operations.  The scan is
// a chain of G classes, each a chain of ~20 dependent block-wide
// reductions over <= 8192 rows (feasibility/capacity sum, 15 bisection
// sums, base sum, an exclusive scan, the overflow argmin).  The work is a
// few MB of int32 arithmetic; the time is the latency of that chain.  Run
// eagerly as tensor ops it would be ~G * 45 kernel launches per beat.
// Design: ONE thread block of up to 1024 threads walks all G classes;
// each thread owns rows tid, tid + blockDim, ... (<= 8 rows) of the
// (N, R) state, updates its own avail rows in place (no races: one owner
// per row), and every per-class step is a block reduction, scan or
// argmin through shared memory.  It uses one SM of 132 — a multi-block
// design is later work (PERF.md records the gap to the bound).
//
// Exactness: all int32 arithmetic wraps like XLA's (done in uint32 and
// cast back: signed overflow is undefined in C++), floor division floors
// like numpy/XLA `//` (CUDA `/` truncates), reductions start from the
// same `initial=` values as the JAX code, ties break to the lowest row,
// and an all-INFEASIBLE argmin gives row 0 as jnp.argmin does.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kScale = 1 << 12;          // contract.SCALE
constexpr int kScoreShift = 13;          // contract.SCORE_SHIFT
constexpr int kAvailShift = 27;          // contract.AVAIL_SHIFT
constexpr int kBig = 1 << 30;            // hybrid_kernel._BIG
constexpr int kInfKey = 0x7fffffff;      // contract.INFEASIBLE_KEY
constexpr int kBisectSteps = 15;         // SCALE.bit_length() + 2
constexpr int kMaxRows = 8;              // MAX_NODES / 1024 rows per thread
constexpr int kMaxThreads = 1024;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int wadd(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
}
__device__ __forceinline__ int wsub(int a, int b) {
  return (int)((unsigned)a - (unsigned)b);
}
__device__ __forceinline__ int wmul(int a, int b) {
  return (int)((unsigned)a * (unsigned)b);
}
// numpy/XLA floor division (b > 0 at every call site)
__device__ __forceinline__ int floordiv(int a, int b) {
  int q = a / b;
  if ((a % b != 0) && ((a < 0) != (b < 0))) --q;
  return q;
}
__device__ __forceinline__ int clip(int x, int lo, int hi) {
  return min(max(x, lo), hi);
}

// Wrapping int32 block sum; every thread gets the total.
__device__ int block_sum(int v, int* red) {
  unsigned u = (unsigned)v;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) u += __shfl_xor_sync(kFull, u, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();                       // red[] free from the last use
  if (lane == 0) red[warp] = (int)u;
  __syncthreads();
  unsigned total = 0;
  const int nw = blockDim.x >> 5;
  for (int i = 0; i < nw; ++i) total += (unsigned)red[i];
  return (int)total;
}

// Exclusive scan in thread order (wrapping), offset by *carry, which
// advances by the block total.
__device__ int block_exclusive_scan(int v, unsigned* carry, int* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned x = (unsigned)v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    unsigned y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  __syncthreads();
  if (lane == 31) red[warp] = (int)x;
  __syncthreads();
  unsigned before = 0, total = 0;
  const int nw = blockDim.x >> 5;
  for (int i = 0; i < nw; ++i) {
    unsigned w = (unsigned)red[i];
    if (i < warp) before += w;
    total += w;
  }
  const unsigned excl = *carry + before + x - (unsigned)v;
  *carry += total;
  return (int)excl;
}

__device__ unsigned long long block_min_u64(unsigned long long v,
                                            unsigned long long* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    unsigned long long y = __shfl_xor_sync(kFull, v, o);
    v = y < v ? y : v;
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  unsigned long long best = ~0ull;
  const int nw = blockDim.x >> 5;
  for (int i = 0; i < nw; ++i) best = red[i] < best ? red[i] : best;
  return best;
}

// m_n(L): slots of this row with eff-score key <= L (_slots_at_or_below).
__device__ __forceinline__ int slots_at_or_below(
    int L, const int* __restrict__ trow, const int* arow,
    const int* req, int r, int m_max, int thr_fp) {
  const int lp1 = (L < thr_fp ? thr_fp - 1 : L) + 1;
  int jcount = kBig;                     // where(req_pos, jc, BIG).min()
  for (int c = 0; c < r; ++c) {
    const int q = req[c];
    if (q > 0) {
      const int t = trow[c];
      const int used = wsub(t, arow[c]);
      const int num = wsub(wsub(wmul(lp1, t), wmul(used, kScale)), 1);
      const int den = max(wmul(q, kScale), 1);
      jcount = min(jcount, clip(floordiv(num, den), 0, kBig));
    }
  }
  return min(m_max, jcount);
}

// Packed contract key of one row (_keys_one_req).
__device__ __forceinline__ int row_key(
    int row, const int* __restrict__ trow, const int* arow,
    const int* req, int r, bool mask, int thr_fp) {
  bool feas = mask, availb = true;
  int s = 0;                             // .max(axis=1, initial=0)
  for (int c = 0; c < r; ++c) {
    const int q = req[c];
    if (q > 0) {
      const int t = trow[c], a = arow[c];
      feas = feas && (t >= q);
      availb = availb && (a >= q);
      const int qq = wadd(wsub(t, a), q);
      s = max(s, floordiv(wmul(qq, kScale), max(t, 1)));
    }
  }
  const int eff = (availb && s < thr_fp) ? 0 : s;
  const unsigned key = ((unsigned)(!availb) << kAvailShift)
      | ((unsigned)eff << kScoreShift) | (unsigned)row;
  return feas ? (int)key : kInfKey;
}

__global__ void __launch_bounds__(kMaxThreads)
waterfill_scan_kernel(const int* __restrict__ totals,
                      const int* __restrict__ avail,
                      const uint8_t* __restrict__ node_mask,
                      const int* __restrict__ group_reqs,
                      const int* __restrict__ group_counts,
                      const uint8_t* __restrict__ group_masks,
                      int* __restrict__ counts, int* new_avail,
                      int n, int r, int g, int thr_fp,
                      int require_available) {
  extern __shared__ int s_req[];         // (r,) this class's request
  __shared__ int red[32];
  __shared__ unsigned long long red64[32];
  const int tid = threadIdx.x, nt = blockDim.x;
  const int kmax = (n + nt - 1) / nt;    // rows per thread, block-uniform

  // the carry starts as a copy of avail; each thread owns its rows
#pragma unroll
  for (int k = 0; k < kMaxRows; ++k) {
    const int row = tid + k * nt;
    if (k < kmax && row < n)
      for (int c = 0; c < r; ++c)
        new_avail[(size_t)row * r + c] = avail[(size_t)row * r + c];
  }

  for (int gi = 0; gi < g; ++gi) {
    __syncthreads();                     // last class done with s_req
    for (int c = tid; c < r; c += nt) s_req[c] = group_reqs[(size_t)gi * r + c];
    __syncthreads();
    const int count = group_counts[gi];
    bool any_req = false;
    for (int c = 0; c < r; ++c) any_req = any_req || (s_req[c] > 0);

    // feasibility, per-row capacity m_max, and the placement mask
    int m_max[kMaxRows], lvl[kMaxRows], alloc[kMaxRows];
    bool pmask[kMaxRows];
    int local = 0;
#pragma unroll
    for (int k = 0; k < kMaxRows; ++k) {
      const int row = tid + k * nt;
      m_max[k] = 0;
      pmask[k] = false;
      if (k < kmax && row < n) {
        const int* trow = totals + (size_t)row * r;
        const int* arow = new_avail + (size_t)row * r;
        pmask[k] = node_mask[row] &&
            (group_masks == nullptr || group_masks[(size_t)gi * n + row]);
        bool feas = pmask[k];
        int caps = kBig;
        for (int c = 0; c < r; ++c) {
          const int q = s_req[c];
          if (q > 0) {
            feas = feas && (trow[c] >= q);
            caps = min(caps, floordiv(arow[c], q));
          }
        }
        m_max[k] = (feas && any_req) ? clip(caps, 0, kBig) : 0;
      }
      local = wadd(local, m_max[k]);
    }
    const int total_cap = block_sum(local, red);
    const int n_avail = min(count, total_cap);  // placements that consume
    const int overflow = wsub(count, n_avail);  // queue on best feasible

    // smallest L in [0, 2*SCALE] with sum(m(L)) >= n_avail; the same
    // fixed 15 steps and update rule as the lax.scan bisection
    int lo = 0, hi = 2 * kScale;
    for (int it = 0; it < kBisectSteps; ++it) {
      const int mid = (lo + hi) >> 1;
      int part = 0;
#pragma unroll
      for (int k = 0; k < kMaxRows; ++k) {
        const int row = tid + k * nt;
        if (k < kmax && row < n)
          part = wadd(part, slots_at_or_below(
              mid, totals + (size_t)row * r, new_avail + (size_t)row * r,
              s_req, r, m_max[k], thr_fp));
      }
      const bool ok = block_sum(part, red) >= n_avail;
      lo = ok ? lo : mid + 1;
      hi = ok ? mid : hi;
    }
    const int l_star = lo;

    // base = m(L*-1), at_level = m(L*); hand out the level-L* slots in
    // row (traversal) order
    int bpart = 0;
#pragma unroll
    for (int k = 0; k < kMaxRows; ++k) {
      const int row = tid + k * nt;
      alloc[k] = 0;                      // holds base until the scan
      lvl[k] = 0;
      if (k < kmax && row < n) {
        const int* trow = totals + (size_t)row * r;
        const int* arow = new_avail + (size_t)row * r;
        alloc[k] = l_star > 0 ? slots_at_or_below(
            max(l_star - 1, 0), trow, arow, s_req, r, m_max[k], thr_fp) : 0;
        lvl[k] = slots_at_or_below(l_star, trow, arow, s_req, r,
                                   m_max[k], thr_fp);
      }
      bpart = wadd(bpart, alloc[k]);
    }
    const int rem = wsub(n_avail, block_sum(bpart, red));
    unsigned carry = 0;
#pragma unroll
    for (int k = 0; k < kMaxRows; ++k) {
      if (k < kmax) {                    // block-uniform: the scan syncs
        const int row = tid + k * nt;
        const int extra = row < n ? wsub(lvl[k], alloc[k]) : 0;
        const int prefix = block_exclusive_scan(extra, &carry, red);
        const int give = min(max(wsub(rem, prefix), 0), extra);
        alloc[k] = wadd(alloc[k], give);
      }
    }

    // consume, then the overflow node: argmin of the keys on the
    // post-allocation state (lowest row on ties)
    unsigned long long best = ~0ull;
#pragma unroll
    for (int k = 0; k < kMaxRows; ++k) {
      const int row = tid + k * nt;
      if (k < kmax && row < n) {
        const int* trow = totals + (size_t)row * r;
        int* arow = new_avail + (size_t)row * r;
        for (int c = 0; c < r; ++c)
          arow[c] = wsub(arow[c], wmul(alloc[k], s_req[c]));
        const int key = row_key(row, trow, arow, s_req, r, pmask[k], thr_fp);
        const unsigned long long packed =
            ((unsigned long long)((unsigned)key ^ 0x80000000u) << 32)
            | (unsigned)row;
        best = packed < best ? packed : best;
      }
    }
    best = block_min_u64(best, red64);
    const int onode = (int)(best & 0xffffffffull);
    const int okey = (int)((unsigned)(best >> 32) ^ 0x80000000u);
    const bool infeasible = okey == kInfKey;
    int ocol = infeasible ? n : onode;
    if (require_available) {
      const bool o_avail = ((okey >> kAvailShift) & 1) == 0;
      ocol = (infeasible || !o_avail) ? n : onode;
    }

    int* crow = counts + (size_t)gi * (n + 1);
#pragma unroll
    for (int k = 0; k < kMaxRows; ++k) {
      const int row = tid + k * nt;
      if (k < kmax && row < n)
        crow[row] = row == ocol ? wadd(alloc[k], overflow) : alloc[k];
    }
    if (tid == 0) crow[n] = ocol == n ? overflow : 0;
  }
}

}  // namespace

extern "C" int rt_waterfill_scan(const void* totals, const void* avail,
                                 const void* node_mask,
                                 const void* group_reqs,
                                 const void* group_counts,
                                 const void* group_masks, void* counts,
                                 void* new_avail, int n, int r, int g,
                                 int thr_fp, int require_available,
                                 int threads, void* stream) {
  if (n < 1 || r < 1 || g < 0 || threads < 32 || threads > kMaxThreads ||
      threads % 32 != 0 || n > threads * kMaxRows)
    return (int)cudaErrorInvalidValue;
  waterfill_scan_kernel<<<1, threads, r * sizeof(int),
                          (cudaStream_t)stream>>>(
      (const int*)totals, (const int*)avail, (const uint8_t*)node_mask,
      (const int*)group_reqs, (const int*)group_counts,
      (const uint8_t*)group_masks, (int*)counts, (int*)new_avail, n, r, g,
      thr_fp, require_available);
  return (int)cudaGetLastError();
}

extern "C" const char* rt_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
