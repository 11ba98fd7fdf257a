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
// operations, one key pass a bundle over its positive columns: 0.0015 ms
// of bound).  Each bundle reads the avail the last one wrote.  One CTA
// of 1024 threads walks the chain; each bundle step is one key pass over
// the rows, one block-wide reduction and a debit of one row:
//
//   * Both argmins in one pass.  A row's key does not depend on the
//     mask, so one pass computes it and offers it to both minimums (the
//     primary one only where the row is primary); one barrier reduces
//     both (contract.cuh block_min).  A found primary row ends the step;
//     a group stops at its first failed bundle, since its result is then
//     discarded whole.
//   * An undo log instead of a copy.  The JAX program keeps a copy of
//     avail per group and selects; here the group's placed rows are its
//     log (at most B rows, kept in shared memory), and a failed group
//     adds each placed bundle back (wrapping adds undo wrapping
//     subtractions exactly).  The `used` flags (one byte a row, in
//     shared memory) are cleared from the same log, so nothing is O(N)
//     per group.
//   * Only the request's columns are read in the key pass (warp 0
//     compacts the positive columns into shared memory).
//   * avail stays in global memory (new_avail, copied from avail at the
//     start): N x R can pass shared memory, and a bundle touches one row.
//
// Exactness: int32 arithmetic wraps like XLA's, `//` floors
// (contract.cuh); the argmins break ties to the lowest row and give row
// 0 on an all-INF row (then nothing is debited: the bundle is not
// found); STRICT_PACK's sum wraps before its clamp, as jnp's int32 sum.

#include <cuda_runtime.h>
#include <stdint.h>

#include "contract.cuh"

namespace {

using namespace rt;

constexpr int kThreads = 1024;
constexpr int kPack = 0, kStrictPack = 2, kStrictSpread = 3;
constexpr int kMaxTotalCu = 1 << 17;     // common/resources.MAX_TOTAL_CU
constexpr int kMaxShared = 232448;       // an H100 block's shared memory

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
};

struct Layout {                          // dynamic shared memory, in ints
  int req, col, q, placed, used;         // offsets; used is N bytes
  size_t bytes;
};

__host__ __device__ inline Layout layout(int n, int r, int b) {
  Layout l;
  l.req = 0;
  l.col = l.req + r;
  l.q = l.col + r;
  l.placed = l.q + r;
  l.used = l.placed + b;
  l.bytes = sizeof(int) * (size_t)l.used + (((size_t)n + 15) & ~(size_t)15);
  return l;
}

// key pass + both argmins of one step: v[0] over the primary rows, v[1]
// over every row (or only v[0], STRICT_PACK, over every row)
__device__ __forceinline__ void avail_argmins(
    const Args& in, const int* col, const int* q, int npos,
    const unsigned char* used, int primary_used, bool two,
    unsigned long long (&v)[2], unsigned long long (*part)[32]) {
  v[0] = v[1] = kNoKey;
  for (int row = threadIdx.x; row < in.n; row += kThreads) {
    const bool live = in.node_mask[row];
    int key = contract_key(in.totals + (long long)row * in.r,
                           in.new_avail + (long long)row * in.r, col, q,
                           npos, live, in.thr_fp, row);
    // _avail_keys: a feasible but unavailable row is INF
    if ((key >> kAvailShift) & 1) key = kInfKey;
    const unsigned long long k = pack_key(key, row);
    if (two) {
      const bool primary = (used[row] != 0) == (primary_used != 0);
      const unsigned long long k1 = primary ? k : pack_key(kInfKey, row);
      v[0] = k1 < v[0] ? k1 : v[0];
      v[1] = k < v[1] ? k : v[1];
    } else {
      v[0] = k < v[0] ? k : v[0];
    }
  }
  block_min<2>(v, part);
}

__global__ void __launch_bounds__(kThreads, 1) bundle_kernel(Args in) {
  extern __shared__ int smem[];
  const Layout l = layout(in.n, in.r, in.b);
  int* req = smem + l.req;               // the step's request (r)
  int* col = smem + l.col;               // its positive columns
  int* q = smem + l.q;
  int* placed = smem + l.placed;         // the group's placed rows (b)
  unsigned char* used = (unsigned char*)(smem + l.used);
  __shared__ unsigned long long part[2][2][32];
  __shared__ int s_npos;
  const int tid = threadIdx.x, warp = tid >> 5;
  const int n = in.n, r = in.r, nb = in.b;

  const long long cells = (long long)n * r;
  for (long long i = tid; i < cells; i += kThreads)
    in.new_avail[i] = in.avail[i];
  for (int i = tid; i < n; i += kThreads) used[i] = 0;
  int parity = 0;

  for (int p = 0; p < in.p; ++p) {
    const int strategy = in.strategies[p];
    const bool* valid = in.valid + (long long)p * nb;
    const int* preq = in.reqs + (long long)p * nb * r;
    for (int j = tid; j < nb; j += kThreads) placed[j] = -1;
    bool ok = true;

    if (strategy == kStrictPack) {
      // the wrapping sum of the valid bundles, then the width clamp
      for (int c = tid; c < r; c += kThreads) {
        unsigned s = 0;
        for (int j = 0; j < nb; ++j)
          if (valid[j]) s += (unsigned)preq[(long long)j * r + c];
        req[c] = min((int)s, kMaxTotalCu + 1);
      }
      __syncthreads();
      if (warp == 0)
        compact_request(req, r, col, q, &s_npos, nullptr, nullptr, nullptr);
      __syncthreads();
      unsigned long long v[2];
      avail_argmins(in, col, q, s_npos, used, 0, false, v, part[parity]);
      parity ^= 1;
      const int node = packed_row(v[0]);
      ok = packed_key(v[0]) != kInfKey;
      if (ok) {
        int* a_row = in.new_avail + (long long)node * r;
        for (int c = tid; c < r; c += kThreads)
          a_row[c] = wsub(a_row[c], req[c]);
        for (int j = tid; j < nb; j += kThreads)
          placed[j] = valid[j] ? node : -1;
      }
      __syncthreads();
    } else {
      const int primary_used = strategy == kPack;
      for (int j = 0; j < nb && ok; ++j) {
        if (!valid[j]) continue;         // uniform: every thread reads it
        const int* breq = preq + (long long)j * r;
        if (warp == 0)
          compact_request(breq, r, col, q, &s_npos, nullptr, nullptr,
                          nullptr);
        __syncthreads();
        unsigned long long v[2];
        avail_argmins(in, col, q, s_npos, used, primary_used, true, v,
                      part[parity]);
        parity ^= 1;
        const bool ok1 = packed_key(v[0]) != kInfKey;
        const bool ok2 = packed_key(v[1]) != kInfKey;
        const int node = ok1 ? packed_row(v[0]) : packed_row(v[1]);
        if (!(ok1 || (strategy != kStrictSpread && ok2))) {
          ok = false;                    // uniform: block-wide results
          break;
        }
        int* a_row = in.new_avail + (long long)node * r;
        for (int c = tid; c < r; c += kThreads)
          a_row[c] = wsub(a_row[c], breq[c]);
        if (tid == 0) {
          used[node] = 1;
          placed[j] = node;
        }
        __syncthreads();                 // the debit, before the next keys
      }
      __syncthreads();
      // a failed group gives its bundles back; every placed row's flag
      // is cleared from the log
      if (!ok)
        for (int c = tid; c < r; c += kThreads)
          for (int j = 0; j < nb; ++j)
            if (placed[j] >= 0) {
              int* a = in.new_avail + (long long)placed[j] * r + c;
              *a = wadd(*a, preq[(long long)j * r + c]);
            }
      for (int j = tid; j < nb; j += kThreads)
        if (placed[j] >= 0) used[placed[j]] = 0;
      __syncthreads();
    }
    int* out = in.rows + (long long)p * nb;
    for (int j = tid; j < nb; j += kThreads) out[j] = ok ? placed[j] : -1;
    if (tid == 0) in.ok[p] = ok;
    __syncthreads();                     // log and used, before the next group
  }
}

}  // namespace

// One launch of one CTA on `stream`.  Writes rows (P, B), ok (P,) and
// new_avail (N, R).  Returns a cudaError_t (cudaErrorInvalidValue where
// the used flags and the group's arrays do not fit shared memory).
extern "C" int rt_bundle_schedule(const void* totals, const void* avail,
                                  const void* node_mask, const void* reqs,
                                  const void* valid, const void* strategies,
                                  int n, int r, int p, int b, int thr_fp,
                                  void* rows, void* ok, void* new_avail,
                                  void* stream) {
  if (n < 1 || r < 1 || p < 0 || b < 0) return (int)cudaErrorInvalidValue;
  const Layout l = layout(n, r, b);
  if (l.bytes > (size_t)kMaxShared - 2048) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      bundle_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)l.bytes);
  if (err != cudaSuccess) return (int)err;
  const Args in{(const int*)totals, (const int*)avail,
                (const bool*)node_mask, (const int*)reqs,
                (const bool*)valid, (const int*)strategies, n, r, p, b,
                thr_fp, (int*)rows, (bool*)ok, (int*)new_avail};
  bundle_kernel<<<1, kThreads, l.bytes, (cudaStream_t)stream>>>(in);
  return (int)cudaGetLastError();
}
