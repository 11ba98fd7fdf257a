// The top-k contention spread of the scheduling round, by hand for
// Hopper (sm_90a).
//
// Replaces: the lax.scan over scheduling classes in
//   ray_tpu/ops/locality_kernel.py::schedule_grouped_topk (:79-135).
// Semantics: scheduling/contract.py, bit for bit in int32; the port's
// plain version is locality_kernel.schedule_grouped_topk_plain.
//
// Per class g, in order, with `avail` carried from class to class:
//   keys   = hybrid_kernel._keys of the class's request on every row
//   nf     = the number of feasible keys (key != INF)
//   k      = min(max(k_abs, ceil(nf * num / den), 1), max(nf, 1))
//   order  = the stable argsort of the keys
//   offset = randint's span arithmetic on the host's two draw words
//   slot p < k of `order` gets count // k, + 1 where (p - offset) mod k
//            is below the remainder; every other row gets 0
//   consumed = min(alloc, clip(min over positive columns of a // q, 0,
//              BIG)), and avail -= consumed * req
//   counts[g] = alloc with overflow column 0, or (0, ..., count) when no
//              row is feasible.
//
// What bounds it on this card: the latency of a chain of G dependent
// class steps.  The work is small (a call at 1000 x 8 x 64 moves ~0.3 MB
// and needs ~4.4 M integer operations, the keys over the requests'
// positive columns: 0.00027 ms of bound), and every class reads the
// avail the previous one wrote, so the classes cannot run side by side.
// One CTA of 1024 threads runs the chain; each step is a block-wide
// pass, a sort and a scatter, and the design makes each of them short:
//
//   * No sort by index.  A feasible key's low NODE_BITS bits are its row
//     (contract.py: key = avail bit | score << 13 | row), so feasible
//     keys are unique for N <= MAX_NODES = 8192, the stable argsort is a
//     plain sort of the int32 keys, and the first nf sorted keys carry
//     their own rows.  INF keys (all equal) sort last and never reach a
//     slot, as k <= nf.
//   * The sort in registers.  Each thread holds E = P / 1024 keys (P =
//     N rounded up to a power of two, at least 1024), key e = m * 1024 +
//     tid in register m.  A bitonic network sorts them: stages whose
//     partner lies in the same warp (distance < 32) are shuffles with no
//     barrier; the others exchange through shared memory, double
//     buffered, one barrier a stage: 15 barriers at N <= 1024, 36 at
//     8192.  After the sort thread tid holds sorted positions m * 1024 +
//     tid, so it knows each position's slot count and its row at once.
//   * Only the placed rows are touched.  Rows past the k-th key get 0
//     and consume nothing, so only the thread holding a position below k
//     reads that row's avail, caps and debits it (rows are distinct: no
//     atomics).  The counts row is zeroed by the key pass, written before
//     the sort's first barrier.
//   * Only the request's columns are read.  Warp 0 compacts the class's
//     positive columns (the key and the cap) and nonzero columns (the
//     debit) into shared memory, so a row costs ~2 column reads, not R.
//   * avail stays in global memory (new_avail, copied from avail at the
//     start): N x R can pass shared memory (8192 x 16 is 512 KB), and a
//     class touches only its columns, which stay in L2.
// The per-class time is then one key pass, ~15-36 barriers and one
// scatter; the launch is one CTA and 64 KB of shared memory at most.
//
// Exactness: int32 arithmetic wraps like XLA's (uint32), `//` and `%`
// floor (contract.cuh), randint's span arithmetic is uint32 as JAX's,
// ceil(nf * num / den) is -((-nf * num) // den) as the reference writes
// it, and the sort compares signed int32 keys as argsort does.

#include <cuda_runtime.h>
#include <stdint.h>

#include "contract.cuh"

namespace {

using namespace rt;

constexpr int kThreads = 1024;

struct Args {
  const int* totals;        // (N, R)
  const int* avail;         // (N, R)
  const bool* node_mask;    // (N,)
  const bool* extra_mask;   // (N,) or null
  const int* reqs;          // (G, R)
  const int* group_counts;  // (G,)
  const bool* group_masks;  // (G, N) or null
  const long long* draws;   // (G, 2) uint32 words in int64
  int n, r, g, thr_fp, k_abs, k_num, k_den;
  int* counts;              // (G, N + 1)
  int* new_avail;           // (N, R)
};

// Sort E * 1024 keys ascending, thread tid holding key m * 1024 + tid in
// v[m] (see the note above); buf holds 2 * E * 1024 ints.
template <int E>
__device__ __forceinline__ void bitonic_sort(int (&v)[E], int* buf) {
  constexpr int P = E * kThreads;
  const int tid = threadIdx.x, lane = tid & 31;
  int parity = 0;
  for (int k = 2; k <= P; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      if (j >= 32) {
        int* b = buf + parity * P;
#pragma unroll
        for (int m = 0; m < E; ++m) b[m * kThreads + tid] = v[m];
        __syncthreads();
#pragma unroll
        for (int m = 0; m < E; ++m) {
          const int e = m * kThreads + tid;
          const int other = b[e ^ j];
          const bool lower = (e & j) == 0, asc = (e & k) == 0;
          v[m] = (lower == asc) ? min(v[m], other) : max(v[m], other);
        }
        parity ^= 1;
      } else {
#pragma unroll
        for (int m = 0; m < E; ++m) {
          const int e = m * kThreads + tid;
          const int other = __shfl_xor_sync(kFull, v[m], j);
          const bool lower = (lane & j) == 0, asc = (e & k) == 0;
          v[m] = (lower == asc) ? min(v[m], other) : max(v[m], other);
        }
      }
    }
  }
}

template <int E>
__global__ void __launch_bounds__(kThreads, 1) topk_kernel(Args in) {
  extern __shared__ int smem[];
  constexpr int P = E * kThreads;
  const int n = in.n, r = in.r;
  int* buf = smem;                       // 2 * P: the sort's exchange
  int* col = buf + 2 * P;                // r: positive columns
  int* q = col + r;                      // r: their requests
  int* nz_col = q + r;                   // r: nonzero columns
  int* nz_q = nz_col + r;                // r: their requests
  __shared__ int s_npos, s_nnz, s_nf;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  // the carry lives in new_avail
  const long long cells = (long long)n * r;
  for (long long i = tid; i < cells; i += kThreads)
    in.new_avail[i] = in.avail[i];
  __syncthreads();

  for (int gi = 0; gi < in.g; ++gi) {
    const int* req = in.reqs + (long long)gi * r;
    if (warp == 0) compact_request(req, r, col, q, &s_npos, nz_col, nz_q,
                                   &s_nnz);
    if (tid == 0) s_nf = 0;
    __syncthreads();
    const int npos = s_npos, nnz = s_nnz;
    int* crow = in.counts + (long long)gi * (n + 1);
    const bool* gmask =
        in.group_masks ? in.group_masks + (long long)gi * n : nullptr;

    // keys of this class on the running avail; the counts row zeroed
    int v[E];
    int feasible = 0;
#pragma unroll
    for (int m = 0; m < E; ++m) {
      const int e = m * kThreads + tid;
      int key = kInfKey;
      if (e < n) {
        const bool live = in.node_mask[e] &&
                          (in.extra_mask == nullptr || in.extra_mask[e]) &&
                          (gmask == nullptr || gmask[e]);
        key = contract_key(in.totals + (long long)e * r,
                           in.new_avail + (long long)e * r, col, q, npos,
                           live, in.thr_fp, e);
        crow[e] = 0;
        feasible += key != kInfKey;
      }
      v[m] = key;
    }
    // nf: a warp sum, one shared atomic a warp; complete at the sort's
    // first barrier (P >= 1024, so the sort has stages past the warp)
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      feasible += __shfl_xor_sync(kFull, feasible, o);
    if (lane == 0 && feasible) atomicAdd(&s_nf, feasible);

    bitonic_sort<E>(v, buf);

    const int nf = s_nf;
    const int count = in.group_counts[gi];
    if (nf > 0) {
      // k = min(max(k_abs, -((-nf * num) // den), 1), max(nf, 1))
      int k = wsub(0, floordiv(wmul(wsub(0, nf), in.k_num), in.k_den));
      k = max(k, in.k_abs);
      k = min(max(k, 1), max(nf, 1));
      // randint's span arithmetic (locality_kernel._randint_offset)
      const unsigned span = (unsigned)k;
      const unsigned w_hi = (unsigned)in.draws[2 * gi];
      const unsigned w_lo = (unsigned)in.draws[2 * gi + 1];
      const unsigned m16 = 65536u % span;
      const unsigned mult = (m16 * m16) % span;
      const unsigned t = (w_hi % span) * mult + w_lo % span;
      const int offset = (int)(t % span);
      const int base = floordiv(count, k);
      const int extra_n = wsub(count, wmul(base, k));
#pragma unroll
      for (int m = 0; m < E; ++m) {
        const int pos = m * kThreads + tid;
        if (pos < k) {                   // k <= nf: a feasible key
          const int row = v[m] & kRowMask;
          const int alloc =
              wadd(base, floormod(pos - offset, k) < extra_n ? 1 : 0);
          crow[row] = alloc;
          int* a_row = in.new_avail + (long long)row * r;
          int cap = kBig;                // min(..., initial=_BIG)
          for (int p = 0; p < npos; ++p)
            cap = min(cap, floordiv(a_row[col[p]], q[p]));
          const int consumed = min(alloc, min(max(cap, 0), kBig));
          for (int p = 0; p < nnz; ++p) {
            const int c = nz_col[p];
            a_row[c] = wsub(a_row[c], wmul(consumed, nz_q[p]));
          }
        }
      }
    }
    if (tid == 0) crow[n] = nf > 0 ? 0 : count;
    __syncthreads();                     // the debits, before the next keys
  }
}

template <int E>
cudaError_t launch(const Args& in, void* stream) {
  const size_t bytes = sizeof(int) * (2 * (size_t)E * kThreads +
                                      4 * (size_t)in.r);
  cudaError_t err = cudaFuncSetAttribute(
      topk_kernel<E>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return err;
  topk_kernel<E><<<1, kThreads, bytes, (cudaStream_t)stream>>>(in);
  return cudaGetLastError();
}

}  // namespace

// One launch of one CTA on `stream`.  N <= MAX_NODES (8192); extra_mask
// and group_masks may be null; draws are (G, 2) int64 words in [0,
// 2**32).  Writes counts (G, N+1) and new_avail (N, R).  Returns a
// cudaError_t.
extern "C" int rt_topk_schedule(const void* totals, const void* avail,
                                const void* node_mask,
                                const void* extra_mask, const void* reqs,
                                const void* group_counts,
                                const void* group_masks, const void* draws,
                                int n, int r, int g, int thr_fp, int k_abs,
                                int k_num, int k_den, void* counts,
                                void* new_avail, void* stream) {
  if (n < 0 || n > kMaxNodes || r < 1 || g < 0 || k_den < 1)
    return (int)cudaErrorInvalidValue;
  const Args in{(const int*)totals, (const int*)avail,
                (const bool*)node_mask, (const bool*)extra_mask,
                (const int*)reqs, (const int*)group_counts,
                (const bool*)group_masks, (const long long*)draws,
                n, r, g, thr_fp, k_abs, k_num, k_den,
                (int*)counts, (int*)new_avail};
  if (n <= 1 * kThreads) return (int)launch<1>(in, stream);
  if (n <= 2 * kThreads) return (int)launch<2>(in, stream);
  if (n <= 4 * kThreads) return (int)launch<4>(in, stream);
  return (int)launch<8>(in, stream);
}
