// The autoscaler's launch loop, by hand for Hopper (sm_90a).
//
// Replaces: ray_tpu/ops/binpack_kernel.py::_launch_loop (a lax.while_loop
// bounded by G*K + G + K + 2 iterations) with _pack_all_types (a
// lax.scan over the G demand classes carrying each node type's used
// vector) inside it: phase 2 of ray_tpu/ops/binpack_kernel.py::autoscale.
// Semantics: autoscaler/demand.py's contract, bit for bit in int32 as XLA
// computes it (floor division, wrapping sums and products).
//
// Each iteration first-fits one fresh node of EVERY type over the classes
// in order (the used vector carries from class to class, so the classes
// are a chain), scores each packed node by its fixed-point critical
// utilization, picks the eligible type with the highest score (lowest
// index on ties, as jnp.argmax), and launches t = max(min(min_g rem_g //
// p_g, quota_k), 1) copies of it at once.  The loop stops when nothing is
// left, when no type can pack anything, or at max_iters.
//
// What bounds it on this card: neither bytes nor operations but the
// latency of one dependent chain, iterations x (class steps of a type),
// each step carrying one int32 fit from a class to the next through the
// type's used vector.  So the whole loop is ONE launch of one CTA (one
// warp per node type, the types in parallel), and the design shortens
// the chain and drops the steps that cannot move anything:
//
//   * Compact class rows.  The requests are fixed for the whole loop, so
//     the prologue builds a CSR of each class's nonzero entries (column,
//     value, and for a positive entry the divisor's magic multiplier and
//     shift), 16 bytes an entry, in flat passes over the requests.  A
//     step reads one entry a lane instead of a strided pass over all R
//     columns (a class of the full-width problem asks for 3 of 64
//     kinds); a class with more than 32 entries takes them 32 at a time,
//     in two passes (the min, then the update).  Negative entries stay in
//     the row: they change `used` as in JAX.
//   * Exact division without `/`.  floor(a / d) for any int32 a and d in
//     1..2^31-1 is x = a ^ (a >> 31) (a, or -a-1 when negative, < 2^31),
//     q = (x * m) >> s with m = ceil(2^s / d), s = 31 + ceil(log2 d) (the
//     Granlund-Montgomery bound for 31-bit dividends: m < 2^32 and the
//     error term stays under 1/d), then q ^ (a >> 31): five instructions.
//     The same for the score's division by the type's caps.
//   * One-instruction warp reductions: __reduce_min_sync / max
//     (redux.sync) for the fit, the score and the type pick, which is
//     warp-parallel over K (the max, then the least k holding it: the
//     first max of jnp.argmax).
//   * Steps only where something can move.  Each iteration warp 0 writes
//     a record (row start, length, rem) for each active class (rem > 0
//     and a positive entry; ballot + popc); the others have fit exactly 0
//     and are not stepped.  A type with quota <= 0 is not packed: the
//     pick gives it -1 whatever it packs.  `steps` counts the class steps
//     run, and the chain's length (the steps one after another: per
//     iteration, the active classes of each round of types walked).
//   * Only the chain on the critical path.  Where every active row fits
//     32 entries, the walk is a pipeline three classes deep: while step i
//     runs, class i + 1's entries and caps and class i + 2's record are in
//     flight, so a step waits only on its own chain: the gather of
//     used[c], subtract, divide, redux min, clamp, multiply-add and store.
//     That chain is what bounds the kernel now: 160-173 ns a chain step
//     at the full width of chip_smoke.py's autoscaler phase on an H100
//     (the kernel's time over its chain steps, the rest of each
//     iteration included; PERF.md).
//   * Every shape runs.  plan() places the compact table first (sized for
//     a dense request matrix, so the host needs no read of the data): in
//     shared memory where it fits, else in a global scratch from which a
//     producer warp streams the active rows, in order, through a ring of
//     32-entry slots with cp.async.bulk (TMA 1-D bulk copies) and
//     mbarriers (full: the bytes landed; empty: every consumer warp has
//     left the slot), ahead of the chain.  Rows of up to 32 entries are
//     packed into a slot while they fit, so a warp waits once for several
//     classes.  Then the state, the class arrays, used, caps, packed and
//     the score divisors, each in shared memory while it fits, else in
//     global memory.  Where all but the streamed table fits, the launch
//     keeps its own instantiation (kAllShared: the compiler sees shared
//     addresses, which a step's loads and stores need to stay short).  A
//     streamed chain step costs ~1.6x one on chip (PERF.md): the ring's
//     bookkeeping, not the copies.
//
// Exactness (ROADMAP B): floor division by the magic multiplier (exact by
// construction, see above; CUDA's `/` truncates), and where both operands
// are positive (t's rem // p) by `/`; _BIG = 2**30 joins a class's min
// when one of its R columns asks for nothing (> 0 only), as
// jnp.where(pos, ..., _BIG).min() does; fit = clip(fit, 0, max(rem, 0)),
// and 0 for a class with no positive entry; t = max(min(t, quota[k]), 1);
// used * SCALE and every sum and product in uint32, so they wrap as XLA's
// int32 does.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <algorithm>

#include "contract.cuh"

namespace {

using namespace rt;

constexpr int kSlots = 32;              // ring slots when streaming
constexpr int kSlotEntries = 32;        // entries (16 bytes) a slot
constexpr int kLenMask = (1 << 30) - 1;
constexpr int kAllPos = 1 << 30;        // len flag: every column positive


__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}
// more bytes for the current phase, without an arrival
__device__ __forceinline__ void mbar_add_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.expect_tx.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
// wait until the barrier's phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// Where each array lives.  plan() places them in this order, each in
// shared memory while the card's opt-in limit has room for it, else in
// global memory: a scratch the entry point allocates for all but the
// caps, which are read where the caller holds them.  The table (the
// compact rows) goes first, sized for a dense request matrix; where it
// does not fit, the ring it is streamed through takes its place.
enum Array {
  kTable = 0,   // 4 ints an entry, G*R entries at most
  kState,       // ctl (8) + quota, launches, score, psum (K each)
  kCls,         // rem, pos, start, len (G each), records (G + 2)
  kUsed,        // (K, R)
  kCaps,        // (K, R), read-only
  kPacked,      // (K, G): packed[k][i], i the class's place in the list
  kCapDiv,      // (K, R) x 2: the score's divisors (m, s)
  kArrays
};

struct Plan {
  long long off[kArrays];   // ints into shared memory or the scratch
  long long ring;           // ints into shared memory (when streaming)
  unsigned global;          // bit a: array a is in global memory
  int stream;               // the table is streamed through the ring
  long long smem_ints, scratch_ints;
};

constexpr long long kRingInts = kSlots * kSlotEntries * 4 + kSlots * 4;

long long up4(long long n) { return (n + 3) & ~3ll; }

cudaError_t plan(int k, int g, int r, Plan* p) {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  const long long kk = k, gg = g, rr = r;
  const long long ints[kArrays] = {4 * gg * rr, 8 + 4 * kk, 8 * gg + 8, kk * rr,
                                   kk * rr,     kk * gg,    2 * kk * rr};
  const long long room = optin / (long long)sizeof(int);
  *p = {};
  for (int a = 0; a < kArrays; ++a) {
    const long long n = up4(ints[a]);
    if (p->smem_ints + n <= room) {
      p->off[a] = p->smem_ints;
      p->smem_ints += n;
      continue;
    }
    p->global |= 1u << a;
    if (a == kTable) {
      p->stream = 1;
      p->ring = 0;
      p->smem_ints = kRingInts;
    }
    if (a != kCaps) {
      p->off[a] = p->scratch_ints;
      p->scratch_ints += n;
    }
  }
  return cudaSuccess;
}

enum { kSum = 0, kPick, kOk, kT, kAct, kWide };

// Where a class's entries come from: the table in shared or global
// memory, or (kStream) the ring.  A streamed warp takes the slots in the
// producer's order.  Where every active row fits one slot (`next`), the
// producer packs consecutive rows into a slot while they fit, so a warp
// waits on one barrier for several classes and releases a slot when it
// moves to the next one (the rows of the slot it leaves are in registers
// by then); a wide row (`take`) has slots of its own, 32 entries each.
template <bool kStream>
struct Source {
  const int4* table;
  const int4* ring;
  uint32_t full, empty;     // shared addresses of the barrier arrays
  unsigned seq;             // slots acquired so far
  int off;                  // entries taken from the held slot

  static constexpr int kNone = kSlotEntries + 1;   // off: no slot held

  __device__ __forceinline__ void wait_next() {
    mbar_wait(full + 8 * (seq % kSlots), (seq / kSlots) & 1u);
    ++seq;
  }
  __device__ __forceinline__ void release(int lane) {
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * ((seq - 1) % kSlots));
  }
  // this lane's entry of chunk `ch` (cnt entries) of a row at `start`
  __device__ __forceinline__ int4 take(int start, int ch, int cnt,
                                       int lane) {
    const int4 none = make_int4(0, 0, 0, 0);
    if (!kStream)
      return lane < cnt ? table[start + ch * kSlotEntries + lane] : none;
    wait_next();
    const int4 e =
        lane < cnt ? ring[((seq - 1) % kSlots) * kSlotEntries + lane] : none;
    release(lane);
    return e;
  }
  // this lane's entry of the next row (record r) of a walk whose rows
  // each fit one slot
  __device__ __forceinline__ int4 next(int4 r, int lane) {
    const int4 none = make_int4(0, 0, 0, 0);
    const int n = r.y & kLenMask;
    if (!kStream) return lane < n ? table[r.x + lane] : none;
    if (off + n > kSlotEntries) {
      if (off != kNone) release(lane);
      wait_next();
      off = 0;
    }
    const int4 e =
        lane < n ? ring[((seq - 1) % kSlots) * kSlotEntries + off + lane]
                 : none;
    off += n;
    return e;
  }
  __device__ __forceinline__ void finish(int lane) {
    if (kStream && off != kNone) {
      release(lane);
      off = kNone;
    }
  }
};

// A class record, written for each active class when the list is built:
// x = row start, y = len (entries | kAllPos), z = rem (w unused).
__device__ __forceinline__ int rec_n(int4 r) { return r.y & kLenMask; }
__device__ __forceinline__ int rec_fill(int4 r) {
  return (r.y & kAllPos) ? INT_MAX : kBig;
}
__device__ __forceinline__ int rec_chunks(int4 r) {
  return (rec_n(r) + kSlotEntries - 1) / kSlotEntries;
}

// kAllShared: every array but a streamed table is in shared memory (the
// compiler then sees shared addresses); else each array's pointer is
// taken from the plan.  kStream: the table is streamed through the ring.
template <bool kAllShared, bool kStream>
__global__ void __launch_bounds__(1024, 1) binpack_launch_loop_kernel(
    const int* __restrict__ type_caps, const int* __restrict__ type_quotas,
    const int* __restrict__ demand_reqs, const int* __restrict__ remaining,
    int k_types, int g_cls, int r_res, int max_iters, Plan pl,
    int* __restrict__ scratch, int* __restrict__ launches_out,
    int* __restrict__ remaining_out, int* __restrict__ iters_out,
    unsigned long long* __restrict__ steps_out) {
  extern __shared__ __align__(16) int sm[];
  auto at = [&](int a) -> int* {
    return ((kAllShared && (a != kTable || !kStream)) ||
            !(pl.global >> a & 1u))
               ? sm + pl.off[a]
               : scratch + pl.off[a];
  };
  int4* const table = reinterpret_cast<int4*>(at(kTable));
  int* const state = at(kState);
  int* const ctl = state;
  int* const quota = state + 8;
  int* const launches = quota + k_types;
  int* const score = launches + k_types;
  int* const psum = score + k_types;
  int* const rem = at(kCls);
  int* const pos = rem + g_cls;
  int* const start = pos + g_cls;
  int* const len = start + g_cls;
  // records of the active classes in list order, and two empty ones
  // after the last (read ahead of the walk, never stepped)
  int4* const rec = reinterpret_cast<int4*>(rem + 4 * (size_t)g_cls);
  int* const used = at(kUsed);
  int* const packed = at(kPacked);
  const uint2* const capdiv = reinterpret_cast<const uint2*>(at(kCapDiv));
  const bool caps_sh = kAllShared || !(pl.global >> kCaps & 1u);
  const int* const caps = caps_sh ? sm + pl.off[kCaps] : type_caps;

  const int tid = threadIdx.x, nt = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int nw = kStream ? (nt >> 5) - 1 : nt >> 5;   // consumer warps
  const bool producer = kStream && warp == nw;
  const size_t kr = (size_t)k_types * r_res;
  const unsigned lt = (1u << lane) - 1u;
  const int4 none = make_int4(0, 0, 0, 0);

  // -- prologue: caps and their divisors, the state, the compact rows --
  for (size_t i = tid; i < kr; i += nt) {
    const int cp = type_caps[i];
    if (caps_sh) sm[pl.off[kCaps] + i] = cp;
    reinterpret_cast<uint2*>(at(kCapDiv))[i] =
        cp > 0 ? magic(cp) : make_uint2(0u, 0u);
  }
  for (int i = tid; i < k_types; i += nt) {
    quota[i] = type_quotas[i];
    launches[i] = 0;
  }
  if (tid == 0) *steps_out = 0ull;
  for (int g = tid; g < g_cls; g += nt) {
    rem[g] = remaining[g];
    len[g] = 0;     // nonzero entries
    start[g] = 0;   // positive entries
    pos[g] = 0;     // entries written
  }
  // the requests in flat passes, kBatch loads in flight a thread: the
  // class of element i is i // R (by the magic divisor below 2^31)
  constexpr int kBatch = 8;
  const size_t gr = (size_t)g_cls * r_res;
  const uint2 rdiv = magic(r_res);
  auto row_of = [&](size_t i) {
    return gr <= (size_t)INT_MAX ? fdiv((int)i, rdiv.x, rdiv.y)
                                 : (int)(i / (size_t)r_res);
  };
  auto each_request = [&](auto&& fn) {
    for (size_t i0 = tid; i0 < gr; i0 += (size_t)nt * kBatch) {
      int q[kBatch];
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        const size_t i = i0 + (size_t)b * nt;
        q[b] = i < gr ? demand_reqs[i] : 0;
      }
#pragma unroll
      for (int b = 0; b < kBatch; ++b)
        if (q[b] != 0) fn(i0 + (size_t)b * nt, q[b]);
    }
  };
  __syncthreads();
  each_request([&](size_t i, int q) {
    const int g = row_of(i);
    atomicAdd(len + g, 1);
    if (q > 0) atomicAdd(start + g, 1);
  });
  __syncthreads();
  for (int g = tid; g < g_cls; g += nt) {
    const int nz = len[g], np = start[g];
    // a class with no positive entry is never stepped: no row
    len[g] = np == 0 ? 0 : (nz | (np == r_res ? kAllPos : 0));
  }
  __syncthreads();
  if (warp == 0) {   // exclusive scan of the row lengths
    int base = 0;
    for (int g0 = 0; g0 < g_cls; g0 += 32) {
      const int g = g0 + lane;
      const int n = g < g_cls ? len[g] & kLenMask : 0;
      int x = n;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(kFull, x, o);
        if (lane >= o) x += y;
      }
      if (g < g_cls) start[g] = base + x - n;
      base += __shfl_sync(kFull, x, 31);
    }
  }
  __syncthreads();
  // the rows, in any order within a row (a step takes a min over its
  // entries and updates distinct columns)
  each_request([&](size_t i, int q) {
    const int g = row_of(i);
    if (len[g] == 0) return;
    const uint2 d = q > 0 ? magic(q) : make_uint2(0u, 0u);
    table[start[g] + atomicAdd(pos + g, 1)] =
        make_int4((int)(i - (size_t)g * r_res), q, (int)d.x, (int)d.y);
  });
  uint32_t full = 0, empty = 0;
  if (kStream) {
    uint64_t* bars = reinterpret_cast<uint64_t*>(
        sm + pl.ring + kSlots * kSlotEntries * 4);
    full = smem_u32(bars);
    empty = smem_u32(bars + kSlots);
    if (tid == 0) {
      for (int s = 0; s < kSlots; ++s) {
        mbar_init(full + 8 * s, 1);
        mbar_init(empty + 8 * s, nw);
      }
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    // the rows written above are read by the bulk copies (async proxy)
    asm volatile("fence.proxy.async;\n" ::: "memory");
  }
  __syncthreads();

  Source<kStream> src{table,
                      reinterpret_cast<const int4*>(sm + pl.ring), full,
                      empty, 0u, Source<kStream>::kNone};
  // class steps of this warp; and (thread 0) the chain's length: per
  // iteration, the active classes of each round walked
  unsigned long long steps = 0, chain = 0;
  const int rounds = (k_types + nw - 1) / nw;
  // a round (types j*nw .. j*nw + nw - 1) is walked when one of its
  // types has quota left; every warp decides it alike
  auto live = [&](int j) {
    const int k = j * nw + lane;
    return __any_sync(kFull, lane < nw && k < k_types && quota[k] > 0);
  };

  int it = 0;
  bool done = false;
  for (;;) {
    // cond: remaining.sum() > 0 (an int32 sum, wrapping) & ~done & it <
    // max; and the records of the active classes
    if (warp == 0) {
      unsigned s = 0;
      int n = 0;
      bool wide = false;
      for (int g0 = 0; g0 < g_cls; g0 += 32) {
        const int g = g0 + lane;
        const int rg = g < g_cls ? rem[g] : 0;
        const int l = g < g_cls ? len[g] : 0;
        s += (unsigned)rg;
        const bool on = rg > 0 && l != 0;
        const unsigned b = __ballot_sync(kFull, on);
        const int i = n + __popc(b & lt);
        if (on) {
          rec[i] = make_int4(start[g], l, rg, 0);
          wide |= (l & kLenMask) > kSlotEntries;
        }
        if (g < g_cls) pos[g] = on ? i : -1;
        n += __popc(b);
      }
      s = __reduce_add_sync(kFull, s);
      wide = __any_sync(kFull, wide);
      if (lane < 2) rec[n + lane] = none;
      if (lane == 0) {
        ctl[kSum] = (int)s;
        ctl[kAct] = n;
        ctl[kWide] = wide;
      }
    }
    __syncthreads();
    if (!(ctl[kSum] > 0 && !done && it < max_iters)) break;
    const int n_act = ctl[kAct];
    const bool wide = ctl[kWide] != 0;

    if (producer) {
      // stream the active rows of every live round, in the walk's order:
      // rows that each fit one slot packed into slots while they fit
      // (one arrival a slot, the bytes counted per row); wide rows a
      // slot per 32 entries, twice (the min, then the update)
      if (lane == 0) {
        unsigned seq = src.seq;
        const uint32_t ring = smem_u32(sm + pl.ring);
        for (int j = 0; j < rounds; ++j) {
          bool any = false;
          for (int w = 0; w < nw && !any; ++w) {
            const int k = j * nw + w;
            any = k < k_types && quota[k] > 0;
          }
          if (!any) continue;
          unsigned s = 0;
          int off = Source<kStream>::kNone;
          for (int i = 0; i < n_act; ++i) {
            const int4 r = rec[i];
            const int n = rec_n(r), nch = rec_chunks(r);
            if (!wide) {
              if (off + n > kSlotEntries) {
                if (off != Source<kStream>::kNone) mbar_arrive(full + 8 * s);
                s = seq % kSlots;
                mbar_wait(empty + 8 * s, ((seq / kSlots) & 1u) ^ 1u);
                ++seq;
                off = 0;
              }
              mbar_add_tx(full + 8 * s, 16u * (uint32_t)n);
              bulk_load(ring + 16u * (s * kSlotEntries + off), table + r.x,
                        16u * (uint32_t)n, full + 8 * s);
              off += n;
              continue;
            }
            for (int pass = 0; pass < (nch > 1 ? 2 : 1); ++pass)
              for (int ch = 0; ch < nch; ++ch, ++seq) {
                s = seq % kSlots;
                mbar_wait(empty + 8 * s, ((seq / kSlots) & 1u) ^ 1u);
                const int cnt = min(kSlotEntries, n - ch * kSlotEntries);
                const uint32_t bytes = 16u * (uint32_t)cnt;
                mbar_expect_tx(full + 8 * s, bytes);
                bulk_load(ring + 16u * s * kSlotEntries,
                          table + r.x + ch * kSlotEntries, bytes,
                          full + 8 * s);
              }
          }
          if (off != Source<kStream>::kNone) mbar_arrive(full + 8 * s);
        }
        src.seq = seq;
      }
      __syncwarp();
    } else {
      // _pack_all_types: warp w packs types w, w + nw, ...
      for (int j = 0; j < rounds; ++j) {
        if (!live(j)) continue;
        chain += (unsigned long long)n_act;
        const int k = j * nw + warp;
        const bool mine = k < k_types && quota[k] > 0;
        if (!mine) {   // walk the ring all the same, packing nothing
          if (kStream) {
            for (int i = 0; i < n_act; ++i) {
              const int4 r = rec[i];
              const int nch = rec_chunks(r);
              if (!wide)
                src.next(r, lane);
              else
                for (int c = 0; c < (nch > 1 ? 2 * nch : 1); ++c)
                  src.take(0, 0, 0, lane);
            }
            src.finish(lane);
          }
          continue;
        }
        const int* cap = caps + (size_t)k * r_res;
        int* u = used + (size_t)k * r_res;
        int* pk = packed + (size_t)k * g_cls;
        for (int c = lane; c < r_res; c += 32) u[c] = 0;
        __syncwarp();
        unsigned fit_sum = 0;

        if (n_act == 0) {
        } else if (!wide) {
          // every active row fits one slot: a pipeline three classes
          // deep, so that a step waits only on its own chain (the loads
          // of class i + 1's entries and caps and of class i + 2's
          // record are in flight meanwhile)
          int4 rc = rec[0];
          int4 ec = src.next(rc, lane);
          int capc = cap[ec.x];
          int4 rn = rec[1];
          for (int i = 0; i < n_act; ++i) {
            const int uc = u[ec.x];
            const int4 en =
                (kStream && i + 1 >= n_act) ? none : src.next(rn, lane);
            const int4 rnn = rec[i + 2];
            const bool on = lane < rec_n(rc);
            const int f = __reduce_min_sync(
                kFull, (on && ec.w) ? fdiv(wsub(capc, uc), (unsigned)ec.z,
                                           (unsigned)ec.w)
                                    : rec_fill(rc));
            const int fit = min(max(f, 0), rc.z);
            const int capn = cap[en.x];
            if (fit != 0 && on) u[ec.x] = wadd(uc, wmul(fit, ec.y));
            __syncwarp();
            if (lane == 0) pk[i] = fit;
            fit_sum += (unsigned)fit;
            rc = rn;
            ec = en;
            capc = capn;
            rn = rnn;
          }
          src.finish(lane);
        } else {
          // some row takes more than one slot: class by class, a row of
          // one slot loaded a class ahead, a longer one 32 entries at a
          // time in two passes (the min, then the update)
          auto fetch = [&](int i, int4& e, int& cp) {
            const int4 r = rec[i];
            e = none;
            cp = 0;
            if (rec_n(r) <= kSlotEntries) {
              e = src.take(r.x, 0, rec_n(r), lane);
              cp = cap[e.x];
            }
            return r;
          };
          int4 ec, en = none;
          int capc, capn = 0;
          int4 rc = fetch(0, ec, capc);
          for (int i = 0; i < n_act; ++i) {
            int4 rn = none;
            int fit;
            const int n = rec_n(rc);
            if (n <= kSlotEntries) {
              const bool on = lane < n;
              const int uc = u[ec.x];
              if (i + 1 < n_act) rn = fetch(i + 1, en, capn);
              const int f = __reduce_min_sync(
                  kFull, (on && ec.w) ? fdiv(wsub(capc, uc), (unsigned)ec.z,
                                             (unsigned)ec.w)
                                      : rec_fill(rc));
              fit = min(max(f, 0), rc.z);
              if (fit != 0 && on) u[ec.x] = wadd(uc, wmul(fit, ec.y));
            } else {
              const int nch = rec_chunks(rc);
              int f = rec_fill(rc);
              for (int ch = 0; ch < nch; ++ch) {
                const int cnt = min(kSlotEntries, n - ch * kSlotEntries);
                const int4 e = src.take(rc.x, ch, cnt, lane);
                if (lane < cnt && e.w)
                  f = min(f, fdiv(wsub(cap[e.x], u[e.x]), (unsigned)e.z,
                                  (unsigned)e.w));
              }
              f = __reduce_min_sync(kFull, f);
              fit = min(max(f, 0), rc.z);
              if (kStream || fit != 0)
                for (int ch = 0; ch < nch; ++ch) {
                  const int cnt = min(kSlotEntries, n - ch * kSlotEntries);
                  const int4 e = src.take(rc.x, ch, cnt, lane);
                  if (fit != 0 && lane < cnt)
                    u[e.x] = wadd(u[e.x], wmul(fit, e.y));
                }
              if (i + 1 < n_act) rn = fetch(i + 1, en, capn);
            }
            __syncwarp();
            if (lane == 0) pk[i] = fit;
            fit_sum += (unsigned)fit;
            rc = rn;
            ec = en;
            capc = capn;
          }
        }
        steps += (unsigned long long)n_act;
        // score = max_c where(cap > 0, (used * SCALE) // max(cap, 1), 0),
        // read only where the type is eligible (psum > 0)
        int s = -1;
        if ((int)fit_sum > 0) {
          const uint2* cd = capdiv + (size_t)k * r_res;
          s = INT_MIN;
          for (int c = lane; c < r_res; c += 32) {
            const uint2 d = cd[c];
            s = max(s, d.y ? fdiv(wmul(u[c], kScale), d.x, d.y) : 0);
          }
          s = __reduce_max_sync(kFull, s);
        }
        if (lane == 0) {
          score[k] = s;
          psum[k] = (int)fit_sum;
        }
      }
    }
    __syncthreads();

    // pick the type (first max of s_eff over K, warp-parallel) and the
    // repeat factor t
    if (warp == 0) {
      int best = INT_MIN, kb = INT_MAX;
      for (int k = lane; k < k_types; k += 32) {
        const int se = (quota[k] > 0 && psum[k] > 0) ? score[k] : -1;
        if (se > best) {
          best = se;
          kb = k;
        }
      }
      const int top = __reduce_max_sync(kFull, best);
      const int kk = (int)__reduce_min_sync(
          kFull, (unsigned)(best == top ? kb : INT_MAX));
      const bool ok = top >= 0;
      int t = kBig;
      if (ok) {
        const int* p = packed + (size_t)kk * g_cls;
        for (int i = lane; i < n_act; i += 32) {
          // rem > 0 (an active class) and p > 0: floor is truncation
          const int pi = p[i];
          if (pi > 0) t = min(t, (int)((unsigned)rec[i].z / (unsigned)pi));
        }
        t = __reduce_min_sync(kFull, t);
      }
      if (lane == 0) {
        ctl[kPick] = kk;
        ctl[kOk] = ok;
        ctl[kT] = ok ? max(min(t, quota[kk]), 1) : 1;
      }
    }
    __syncthreads();
    const int kk = ctl[kPick], t = ctl[kT];
    const bool ok = ctl[kOk] != 0;
    if (ok) {
      const int* p = packed + (size_t)kk * g_cls;
      for (int g = tid; g < g_cls; g += nt) {
        const int i = pos[g];
        rem[g] = max(wsub(rem[g], wmul(t, i >= 0 ? p[i] : 0)), 0);
      }
      if (tid == 0) {
        quota[kk] = wsub(quota[kk], t);
        launches[kk] = wadd(launches[kk], t);
      }
    }
    done = !ok;
    ++it;
    __syncthreads();
  }

  if (!producer && lane == 0 && steps) atomicAdd(steps_out, steps);
  if (tid == 0) steps_out[1] = chain;
  for (int i = tid; i < k_types; i += nt) launches_out[i] = launches[i];
  for (int g = tid; g < g_cls; g += nt) remaining_out[g] = rem[g];
  if (tid == 0) *iters_out = it;
}

}  // namespace

// The launch rt_binpack_launch_loop makes for (K, G, R) on the current
// device, into layout[0..3]: bytes of shared memory, the arrays in global
// memory (bit a = enum Array a), ints of global scratch the caller
// provides, ring slots (0: the table is in shared memory).  Returns a
// cudaError_t.
extern "C" int rt_binpack_plan(int k, int g, int r, long long* layout) {
  if (k < 1 || g < 1 || r < 1) return (int)cudaErrorInvalidValue;
  Plan pl;
  const cudaError_t err = plan(k, g, r, &pl);
  if (err != cudaSuccess) return (int)err;
  layout[0] = (long long)sizeof(int) * pl.smem_ints;
  layout[1] = pl.global;
  layout[2] = pl.scratch_ints;
  layout[3] = pl.stream ? kSlots : 0;
  return (int)cudaSuccess;
}

// One launch of one CTA on `stream`: 32 * min(K, 32) threads, or with the
// table streamed 32 * min(K, 31) consumers and one producer warp.
// `scratch` holds `scratch_ints` ints (at least rt_binpack_plan's).
// `steps` (two uint64) gets the class steps run, summed over iterations
// and types, and the chain's length in class steps.  Returns a
// cudaError_t.
extern "C" int rt_binpack_launch_loop(const void* type_caps,
                                      const void* type_quotas,
                                      const void* demand_reqs,
                                      const void* remaining, int k, int g,
                                      int r, int max_iters, void* launches,
                                      void* remaining_out, void* iters,
                                      void* steps, void* scratch,
                                      long long scratch_ints, void* stream) {
  if (k < 1 || g < 1 || r < 1 || max_iters < 0)
    return (int)cudaErrorInvalidValue;
  Plan pl;
  cudaError_t err = plan(k, g, r, &pl);
  if (err != cudaSuccess) return (int)err;
  if (scratch_ints < pl.scratch_ints) return (int)cudaErrorInvalidValue;
  const size_t bytes = sizeof(int) * (size_t)pl.smem_ints;
  // kAllShared: every array but a streamed table in shared memory
  const bool all_shared = (pl.global & ~(1u << kTable)) == 0;
  const auto kernel =
      pl.stream ? (all_shared ? binpack_launch_loop_kernel<true, true>
                              : binpack_launch_loop_kernel<false, true>)
                : (all_shared ? binpack_launch_loop_kernel<true, false>
                              : binpack_launch_loop_kernel<false, false>);
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const int consumers = std::min(k, pl.stream ? 31 : 32);
  const int threads = 32 * (consumers + pl.stream);
  kernel<<<1, threads, bytes, (cudaStream_t)stream>>>(
      (const int*)type_caps, (const int*)type_quotas,
      (const int*)demand_reqs, (const int*)remaining, k, g, r, max_iters, pl,
      (int*)scratch, (int*)launches, (int*)remaining_out, (int*)iters,
      (unsigned long long*)steps);
  return (int)cudaGetLastError();
}
