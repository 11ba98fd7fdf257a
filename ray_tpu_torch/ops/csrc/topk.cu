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
// class steps, each a key pass over every row and a few block barriers.
// Every class reads the avail the previous one wrote, so the classes
// cannot run side by side.  One CTA of 1024 threads runs the chain,
// thread tid holding row e = m * 1024 + tid in register m (E = ceil(N /
// 1024) rows a thread).  The design:
//
//   * Requests off the chain.  The requests never depend on avail, so
//     before the first class every warp compacts classes in turn into a
//     group block in a global scratch: its positive columns (each with
//     its request and that divisor's magic multiplier, for the cap),
//     then its negative ones (a debit moves them too), its count and its
//     two draw words.  The chain copies a block two classes ahead into
//     shared memory (cp.async, three buffers) and never reads the
//     request tensors.  The columns some class requests are flagged, and
//     only they are brought on chip.
//   * Reciprocals.  Each (row, requested column) divisor max(totals, 1)
//     gets its magic multiplier once, in the prologue; the key pass
//     multiplies where it divided (contract.cuh contract_key_rcp, the
//     same key bit for bit).
//   * Rows on chip where they fit.  totals, multipliers and avail of the
//     requested columns, column-major (a warp's lanes read neighbouring
//     rows), in shared memory while 3 N R ints fit beside the histograms
//     (`shared`: 1000 x 8 is 96 KB), else in a column-major global
//     scratch (`global`: 8192 x 16).  plan() chooses from the shape,
//     before the launch, and the wrapper reports it
//     (`schedule_grouped_topk.last_layout`).  avail goes out to
//     new_avail once, after the last class; the columns no class
//     requests are the input's, copied by the entry point
//     (cudaMemcpyAsync on the stream, before the launch).
//   * A select, not a sort.  A row's count depends on its position
//     among the keys only through three order statistics: it is placed
//     where its key x <= K(k - 1), and gets the remainder's + 1 where its
//     position lies in the window [offset, offset + extra) mod k, that is
//     where K(offset) <= x < K(offset + extra) (or, when the window
//     wraps, x >= K(offset) or x < K(offset + extra - k); at offset +
//     extra == k the window runs to K(k - 1)).  Feasible keys are unique
//     (their low 13 bits are the row, contract.py), and INF keys are the
//     largest and never reach a slot (k <= nf), so K(j) for j < nf is
//     the j-th smallest key of all N.  An MSB-first radix select finds
//     the three at once: 4 passes of 8 bits over the key with its sign
//     bit flipped (so unsigned digit order is argsort's order), each a
//     256-bin histogram in shared memory (warp-aggregated atomics for the
//     commonest bins: keys share their top bits heavily, and atomics on
//     one bin serialise), then one warp a target scans the bins and
//     takes its digit; targets that share a prefix share a histogram,
//     and a key matches at most one prefix.  nf is counted beside the
//     first histogram, so k, the offset and the remainder are known at
//     its scan (worked out by the targets' warps only).  8 barriers a
//     class, none for the key pass or the debit.  (Passes of 11, 11 and
//     10 bits were slower: 2048-bin scans and zeroing cost more than the
//     pass they save.)
//   * Debits by the row's owner.  The thread that holds a key caps and
//     debits its row (rows are distinct: no atomics), and is the one that
//     reads the row in the next key pass, so no barrier orders a debit.
//     The counts row is written by the rows' owners too.
//
// Exactness: int32 arithmetic wraps like XLA's (uint32), `//` and `%`
// floor (contract.cuh, or fdiv by a magic multiplier, exact for every
// int32 dividend), randint's span arithmetic is uint32 as JAX's,
// ceil(nf * num / den) is -((-nf * num) // den) as the reference writes
// it, and the select orders the signed int32 keys as argsort does.

#include <cuda_runtime.h>
#include <stdint.h>

#include "contract.cuh"

namespace {

using namespace rt;

constexpr int kThreads = 1024;
constexpr int kBins = 256;               // a radix digit of 8 bits
constexpr int kPasses = 4;
constexpr int kTargets = 3;              // K(k-1), K(offset), the window's end
constexpr int kHead = 8;                 // a group block's header ints
constexpr int kMaxShared = 232448 - 256; // an H100 block's shared memory,
                                         // less the kernel's static part
constexpr int kStageMax = 48 * 1024;     // three staged blocks, at most

enum Layout { kShared = 0, kGlobal = 1 };

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
  int* new_avail;           // (N, R), the input's copy on entry
  int* blocks;              // scratch: G group blocks, then R column flags
  int* cols;                // scratch (`global`): totals, multipliers and
                            // avail, column-major (R, N) each
};

// Where everything lives, from the shape alone.
struct Plan {
  int layout, group;                     // ints a group block
  bool stage;                            // blocks staged in shared memory
  long long block_ints, col_ints;        // the scratches
  int hist, stage_at, t, m, a;           // shared offsets
  int smem;
};

__host__ __device__ inline long long up16(long long x) {
  return (x + 15) & ~15LL;
}

// The layout rule: the rows' three arrays on chip while they fit beside
// the histograms and the staged blocks, else in global memory.  Blocks
// are staged while three take 48 KB or less.
inline void plan(Plan& pl, int n, int r, int g) {
  pl.group = kHead + 4 * r;
  pl.block_ints = (long long)g * pl.group + r;
  pl.stage = 3LL * pl.group * 4 <= kStageMax;
  long long at = 0;
  pl.hist = (int)at;                     // [2][256] + [3][3][256]
  at += up16(4LL * kBins * (2 + (kPasses - 1) * kTargets));
  pl.stage_at = (int)at;
  if (pl.stage) at += up16(3LL * pl.group * 4);
  const long long cells = up16(4LL * n * r);
  const bool on_chip = at + 3 * cells <= kMaxShared;
  pl.layout = on_chip ? kShared : kGlobal;
  pl.t = (int)at;
  pl.m = (int)(at + cells);
  pl.a = (int)(at + 2 * cells);
  if (on_chip) at += 3 * cells;
  pl.col_ints = on_chip ? 0 : 3LL * n * r;
  pl.smem = (int)at;
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

// One warp: class gi's block
//   [npos, nnz, count, w_hi, w_lo, 0, 0, 0, (col, q, magic(q), 0) x nnz]
// with the positive entries first, in column order; each nonzero column
// flagged in `used`.
__device__ __forceinline__ void compact_class(const Args& in, int gi,
                                              int* blk, int* used) {
  const int lane = threadIdx.x & 31, r = in.r;
  const int* req = in.reqs + (long long)gi * r;
  const unsigned below = (1u << lane) - 1u;
  int k = 0, npos = 0;
  for (int pass = 0; pass < 2; ++pass) {
    for (int c0 = 0; c0 < r; c0 += 32) {
      const int c = c0 + lane;
      const int v = c < r ? req[c] : 0;
      const bool take = pass == 0 ? v > 0 : v < 0;
      const unsigned b = __ballot_sync(kFull, take);
      if (take) {
        int4* e = reinterpret_cast<int4*>(blk + kHead) + k + __popc(b & below);
        *e = make_int4(c, v, v > 0 ? (int)magic(v).x : 0, 0);
        used[c] = 1;
      }
      k += __popc(b);
    }
    if (pass == 0) npos = k;
  }
  if (lane == 0) {
    blk[0] = npos;
    blk[1] = k;
    blk[2] = in.group_counts[gi];
    blk[3] = (int)(unsigned)in.draws[2 * gi];
    blk[4] = (int)(unsigned)in.draws[2 * gi + 1];
    blk[5] = blk[6] = blk[7] = 0;
  }
}

// Add one to bin `bin` of `h` for each lane where `on`.  Keys share their
// top bits heavily (avail bit 27, score bits 13-26), and atomics of one
// warp on one bin serialise, so the lanes of the first two bins met add
// together (a ballot each, one atomic a bin); the rest add alone.  A bin
// is a digit, or slot * 256 + digit where a pass counts into several
// histograms.
__device__ __forceinline__ void hist_add(int* h, unsigned bin, bool on) {
  const int lane = threadIdx.x & 31;
  unsigned left = __ballot_sync(kFull, on);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (left == 0) return;               // warp-uniform
    const int first = __ffs(left) - 1;
    const unsigned b = __shfl_sync(kFull, bin, first);
    const unsigned same = __ballot_sync(kFull, bin == b) & left;
    if (lane == first) atomicAdd(h + b, __popc(same));
    left &= ~same;
  }
  if ((left >> lane) & 1u) atomicAdd(h + bin, 1);
}

// One warp: the digit of the key of rank `rank` among those counted in
// the 256 bins of `h`; appends it to `prefix` and leaves the rank among
// the keys with that digit.
__device__ __forceinline__ void scan_digit(const int* h, unsigned& prefix,
                                           int& rank) {
  const int lane = threadIdx.x & 31;
  const int4 lo = reinterpret_cast<const int4*>(h)[2 * lane];
  const int4 hi = reinterpret_cast<const int4*>(h)[2 * lane + 1];
  const int c[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
  int s = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) s += c[i];
  int incl = s;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += y;
  }
  const int excl = incl - s;
  const bool here = excl <= rank && rank < incl;
  const int src = __ffs(__ballot_sync(kFull, here)) - 1;
  int d = 0, left = rank - excl;
#pragma unroll
  for (int i = 0; i < 8; ++i)
    if (here && d == i && left >= c[i]) {
      left -= c[i];
      d = i + 1;
    }
  const int digit = __shfl_sync(kFull, lane * 8 + d, src);
  rank = __shfl_sync(kFull, left, src);
  prefix = (prefix << 8) | (unsigned)digit;
}

template <int E, bool kOnChip>
__global__ void __launch_bounds__(kThreads, 1) topk_kernel(Args in,
                                                           Plan pl) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ unsigned s_prefix[kTargets];
  __shared__ int s_rank[kTargets];
  __shared__ int s_nf[3];
  __shared__ int s_terms[4];             // k, offset, base, extra
  const int tid = threadIdx.x, warp = tid >> 5;
  const int n = in.n, r = in.r, ng = in.g;
  int* hist1 = reinterpret_cast<int*>(smem + pl.hist);   // [2][256]
  int* hist = hist1 + 2 * kBins;                         // [3][3][256]
  int* stage = reinterpret_cast<int*>(smem + pl.stage_at);
  // (column c, row e) at x[c * n + e]
  int* tt = kOnChip ? reinterpret_cast<int*>(smem + pl.t) : in.cols;
  unsigned* mm = reinterpret_cast<unsigned*>(
      kOnChip ? reinterpret_cast<int*>(smem + pl.m)
              : in.cols + (long long)n * r);
  int* av = kOnChip ? reinterpret_cast<int*>(smem + pl.a)
                    : in.cols + 2LL * n * r;
  int* used = in.blocks + (long long)ng * pl.group;      // zeroed on entry

  // prologue, off the chain: the group blocks, the histograms, the live
  // rows, and the requested columns' rows on chip (or in the scratch)
  for (int gi = warp; gi < ng; gi += kThreads / 32)
    compact_class(in, gi, in.blocks + (long long)gi * pl.group, used);
  for (int i = tid; i < kBins * (2 + (kPasses - 1) * kTargets);
       i += kThreads)
    hist1[i] = 0;
  if (tid < 3) s_nf[tid] = 0;
  unsigned live = 0;                     // bit m: node_mask & extra_mask
#pragma unroll
  for (int m = 0; m < E; ++m) {
    const int e = m * kThreads + tid;
    if (e < n && in.node_mask[e] &&
        (in.extra_mask == nullptr || in.extra_mask[e]))
      live |= 1u << m;
  }
  __syncthreads();                       // blocks and flags are written
  for (int c = 0; c < r; ++c) {
    if (!used[c]) continue;
    for (int e = tid; e < n; e += kThreads) {
      const int t = in.totals[(long long)e * r + c];
      tt[c * n + e] = t;
      mm[c * n + e] = magic(max(t, 1)).x;
      av[c * n + e] = in.avail[(long long)e * r + c];
    }
  }
  if (pl.stage) {
    for (int gi = 0; gi < min(ng, 2); ++gi)
      for (int k = tid; k < pl.group / 4; k += kThreads)
        cp_async16(stage + gi * pl.group + 4 * k,
                   in.blocks + (long long)gi * pl.group + 4 * k);
    cp_async_wait();
  }
  bool gm[E];                            // this class's group mask
#pragma unroll
  for (int m = 0; m < E; ++m) {
    const int e = m * kThreads + tid;
    gm[m] = in.group_masks == nullptr || ng == 0 || e >= n ||
            in.group_masks[e];
  }
  __syncthreads();

  for (int gi = 0; gi < ng; ++gi) {
    const int* blk = pl.stage ? stage + (gi % 3) * pl.group
                              : in.blocks + (long long)gi * pl.group;
    const int npos = blk[0], nnz = blk[1];
    const int4* ent = reinterpret_cast<const int4*>(blk + kHead);
    int* crow = in.counts + (long long)gi * (n + 1);
    int* h1 = hist1 + (gi & 1) * kBins;
    int* nf_at = s_nf + gi % 3;
    if (tid == 0) s_nf[(gi + 1) % 3] = 0;

    // the keys of this class on the running avail, and the first
    // histogram (the top 8 bits) with nf beside it
    int v[E];
    int feasible = 0;
#pragma unroll
    for (int m = 0; m < E; ++m) {
      const int e = m * kThreads + tid;
      int key = kInfKey;
      if (((live >> m) & 1u) && gm[m])
        key = contract_key_rcp(
            [&](int p, int& t, int& a, unsigned& mu, int& q) {
              const int4 cq = ent[p];
              t = tt[cq.x * n + e];
              mu = mm[cq.x * n + e];
              a = av[cq.x * n + e];
              q = cq.y;
            },
            npos, true, in.thr_fp, e);
      v[m] = key;
      feasible += key != kInfKey;
      hist_add(h1, ((unsigned)key ^ 0x80000000u) >> 24, true);
    }
    feasible = __reduce_add_sync(kFull, feasible);
    if ((tid & 31) == 0 && feasible) atomicAdd(nf_at, feasible);
    // the next class's mask, read while this one runs
    if (in.group_masks != nullptr && gi + 1 < ng) {
      const bool* nxt = in.group_masks + (long long)(gi + 1) * n;
#pragma unroll
      for (int m = 0; m < E; ++m) {
        const int e = m * kThreads + tid;
        gm[m] = e >= n || nxt[e];
      }
    }
    if (pl.stage) cp_async_wait();       // class gi + 1's block (below)
    __syncthreads();                     // B1: the first histogram, nf

    const int nf = *nf_at;
    const int count = blk[2];
    if (pl.stage && gi + 2 < ng) {
      // class gi + 2's block into the buffer class gi - 1 used
      const int* src = in.blocks + (long long)(gi + 2) * pl.group;
      int* dst = stage + ((gi + 2) % 3) * pl.group;
      for (int k = tid; k < pl.group / 4; k += kThreads)
        cp_async16(dst + 4 * k, src + 4 * k);
    }
    if (nf == 0) {                       // no row is feasible
      for (int i = tid; i < kBins / 4; i += kThreads)
        reinterpret_cast<int4*>(h1)[i] = make_int4(0, 0, 0, 0);
#pragma unroll
      for (int m = 0; m < E; ++m) {
        const int e = m * kThreads + tid;
        if (e < n) crow[e] = 0;
      }
      if (tid == 0) crow[n] = count;
      continue;
    }
    // the select's first scan, by the targets' warps; the class's terms
    // reach the others through shared memory
    if (warp < kTargets) {
      // k = min(max(k_abs, -((-nf * num) // den), 1), max(nf, 1))
      int k = wsub(0, floordiv(wmul(wsub(0, nf), in.k_num), in.k_den));
      k = max(k, in.k_abs);
      k = min(max(k, 1), nf);
      // randint's span arithmetic (locality_kernel._randint_offset)
      const unsigned span = (unsigned)k;
      const unsigned m16 = 65536u % span;
      const unsigned mult = (m16 * m16) % span;
      const unsigned tsum =
          ((unsigned)blk[3] % span) * mult + (unsigned)blk[4] % span;
      const int offset = (int)(tsum % span);
      const int base = floordiv(count, k);
      const int extra_n = wsub(count, wmul(base, k));
      // the targets' ranks: K(k - 1), then the window's two ends
      const int end = offset + extra_n;  // both below k: no wrap in int
      const int nt = extra_n == 0 ? 1 : end == k ? 2 : 3;
      if (warp < nt) {
        unsigned prefix = 0;
        int rank = warp == 0 ? k - 1 : warp == 1 ? offset
                                 : end < k ? end : end - k;
        scan_digit(h1, prefix, rank);
        if ((tid & 31) == 0) {
          s_prefix[warp] = prefix;
          s_rank[warp] = rank;
        }
      }
      if (tid == 0) {
        s_terms[0] = k;
        s_terms[1] = offset;
        s_terms[2] = base;
        s_terms[3] = extra_n;
      }
    }
    __syncthreads();                     // B2
    const int k = s_terms[0], base = s_terms[2], extra_n = s_terms[3];
    const int end = s_terms[1] + extra_n;
    const int nt = extra_n == 0 ? 1 : end == k ? 2 : 3;
    for (int i = tid; i < kBins / 4; i += kThreads)
      reinterpret_cast<int4*>(h1)[i] = make_int4(0, 0, 0, 0);
    // passes 2-4: a histogram of the next 8 bits, then the scan
#pragma unroll 1
    for (int pass = 1; pass < kPasses; ++pass) {
      int* hp = hist + (pass - 1) * kTargets * kBins;
      unsigned pre[kTargets];
      int slot[kTargets];
#pragma unroll
      for (int t = 0; t < kTargets; ++t) {
        pre[t] = s_prefix[t];
        slot[t] = t;
      }
      // targets that share a prefix share the first one's histogram
      if (nt > 1 && pre[1] == pre[0]) slot[1] = 0;
      if (nt > 2) slot[2] = pre[2] == pre[0] ? 0 : pre[2] == pre[1]
                                                       ? slot[1] : 2;
      const int top_shift = 32 - 8 * pass;
#pragma unroll
      for (int m = 0; m < E; ++m) {
        const unsigned u = (unsigned)v[m] ^ 0x80000000u;
        const unsigned top = u >> top_shift;
        int s = -1;
#pragma unroll
        for (int t = kTargets - 1; t >= 0; --t)
          if (t < nt && slot[t] == t && top == pre[t]) s = t;
        hist_add(hp, max(s, 0) * kBins + ((u >> (top_shift - 8)) & 0xffu),
                 s >= 0);
      }
      __syncthreads();                   // B3, B5, B7
      if (warp < nt) {
        unsigned prefix = pre[warp];
        int rank = s_rank[warp];
        scan_digit(hp + slot[warp] * kBins, prefix, rank);
        if ((tid & 31) == 0) {
          s_prefix[warp] = prefix;
          s_rank[warp] = rank;
        }
      }
      __syncthreads();                   // B4, B6, B8
      for (int i = tid; i < kTargets * kBins / 4; i += kThreads)
        reinterpret_cast<int4*>(hp)[i] = make_int4(0, 0, 0, 0);
    }
    const int k_last = (int)(s_prefix[0] ^ 0x80000000u);
    const int k_from = (int)(s_prefix[1] ^ 0x80000000u);
    const int k_to = (int)(s_prefix[2] ^ 0x80000000u);

    // the spread, the cap and the debit, each row by its owner
#pragma unroll
    for (int m = 0; m < E; ++m) {
      const int e = m * kThreads + tid;
      if (e >= n) continue;
      // only a row below slot k reads its avail (a branch a row: a
      // branch-free debit, every row's cap read, was slower at 8192)
      const int x = v[m];
      int alloc = 0;
      if (x <= k_last) {                 // a slot below k: feasible
        const bool in_window =
            nt == 1 ? false
            : nt == 2 ? x >= k_from
            : end < k ? (x >= k_from && x < k_to)
                      : (x >= k_from || x < k_to);
        alloc = wadd(base, in_window ? 1 : 0);
        int cap = kBig;                  // min(..., initial=_BIG)
        for (int p = 0; p < npos; ++p) {
          const int4 cq = ent[p];
          const unsigned sh = 63u - (unsigned)__clz(cq.y - 1);
          cap = min(cap, fdiv(av[cq.x * n + e], (unsigned)cq.z, sh));
        }
        const int consumed = min(alloc, min(max(cap, 0), kBig));
        for (int p = 0; p < nnz; ++p) {
          const int4 cq = ent[p];
          int* a = av + cq.x * n + e;
          *a = wsub(*a, wmul(consumed, cq.y));
        }
      }
      crow[e] = alloc;
    }
    if (tid == 0) crow[n] = 0;
  }
  // avail out, once (every owner's last debit first)
  __syncthreads();
  for (int c = 0; c < r; ++c) {
    if (!used[c]) continue;
    for (int e = tid; e < n; e += kThreads)
      in.new_avail[(long long)e * r + c] = av[c * n + e];
  }
}

template <int E, bool kOnChip>
cudaError_t launch(const Args& in, const Plan& pl, cudaStream_t stream) {
  auto kernel = topk_kernel<E, kOnChip>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, pl.smem);
  if (err != cudaSuccess) return err;
  kernel<<<1, kThreads, pl.smem, stream>>>(in, pl);
  return cudaGetLastError();
}

template <bool kOnChip>
cudaError_t launch_rows(const Args& in, const Plan& pl, cudaStream_t s) {
  if (in.n <= 1 * kThreads) return launch<1, kOnChip>(in, pl, s);
  if (in.n <= 2 * kThreads) return launch<2, kOnChip>(in, pl, s);
  if (in.n <= 4 * kThreads) return launch<4, kOnChip>(in, pl, s);
  return launch<8, kOnChip>(in, pl, s);
}

}  // namespace

// The launch's layout for a shape: out = [layout (0 shared, 1 global),
// block scratch ints, column scratch ints].  Returns a cudaError_t.
extern "C" int rt_topk_plan(int n, int r, int g, long long* out) {
  if (n < 0 || n > kMaxNodes || r < 1 || g < 0)
    return (int)cudaErrorInvalidValue;
  Plan pl;
  plan(pl, n, r, g);
  out[0] = pl.layout;
  out[1] = pl.block_ints;
  out[2] = pl.col_ints;
  return 0;
}

// One launch of one CTA on `stream`, as rt_topk_plan lays it out;
// `blocks` and `cols` hold the ints it names.  N <= MAX_NODES (8192);
// extra_mask and group_masks may be null; draws are (G, 2) int64 words
// in [0, 2**32).  Writes counts (G, N+1) and new_avail (N, R).  Returns a
// cudaError_t.
extern "C" int rt_topk_schedule(const void* totals, const void* avail,
                                const void* node_mask,
                                const void* extra_mask, const void* reqs,
                                const void* group_counts,
                                const void* group_masks, const void* draws,
                                int n, int r, int g, int thr_fp, int k_abs,
                                int k_num, int k_den, void* counts,
                                void* new_avail, void* blocks, void* cols,
                                void* stream) {
  if (n < 0 || n > kMaxNodes || r < 1 || g < 0 || k_den < 1)
    return (int)cudaErrorInvalidValue;
  Plan pl;
  plan(pl, n, r, g);
  const cudaStream_t s = (cudaStream_t)stream;
  // the columns no class requests leave as they came; the flags start 0
  cudaError_t err = cudaMemcpyAsync(new_avail, avail,
                                    sizeof(int) * (size_t)n * r,
                                    cudaMemcpyDeviceToDevice, s);
  if (err != cudaSuccess) return (int)err;
  err = cudaMemsetAsync((int*)blocks + (long long)g * pl.group, 0,
                        sizeof(int) * (size_t)r, s);
  if (err != cudaSuccess) return (int)err;
  const Args in{(const int*)totals, (const int*)avail,
                (const bool*)node_mask, (const bool*)extra_mask,
                (const int*)reqs, (const int*)group_counts,
                (const bool*)group_masks, (const long long*)draws,
                n, r, g, thr_fp, k_abs, k_num, k_den,
                (int*)counts, (int*)new_avail, (int*)blocks, (int*)cols};
  return (int)(pl.layout == kShared ? launch_rows<true>(in, pl, s)
                                    : launch_rows<false>(in, pl, s));
}
