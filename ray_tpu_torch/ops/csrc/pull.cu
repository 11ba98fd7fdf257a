// Pull-source selection (the PullManager's bandwidth cost model), by
// hand for Hopper (sm_90a).
//
// Replaces: the lax.fori_loop over pull requests in
//   ray_tpu/ops/pull_kernel.py::choose_sources (:45-84).
// Semantics: the JAX program and its numpy oracle, bit for bit in int32;
// the port's plain version is pull_kernel.choose_sources_plain.
//
// Per request i, in order, with the in-flight KB `infl` carried:
//   raw[n]  = bw[n, dest[i]]
//   eff[n]  = loc[i, n] & raw > 0 ? max(raw // (1 + infl[n] // UNIT), 1)
//             : 0                           (UNIT = 32 MB in KB)
//   s       = the first argmax of eff; picked = eff[s] > 0
//   src[i]  = picked ? s : -1; cost[i] = picked ? size // eff[s] : INT_MAX
//   infl[s] += size when picked (int32, wrapping)
//
// What bounds it on this card: the chain of R dependent argmaxes (each
// reads the infl the last one wrote); bytes and operations are small (a
// call at 4096 pulls x 1000 nodes moves ~8 MB: 0.0024 ms of bound).  An
// object sits on few rows (1% in the data-plane cell: ~10 of 1000
// columns can win, ~82 of 8192), so a step needs only its holders.  The
// design:
//
//   * Candidates compacted off the chain.  Every warp of a cooperative
//     grid takes requests in turn: it reads the request's loc row
//     (contiguous), gathers bw[n, dest] for the holders only, and a
//     ballot writes the pairs (n, raw) with raw > 0, in column order,
//     into the request's list of `cap` slots (cap = kListCap, or N
//     rounded up to even where that is less; an (R, cap) scratch, the
//     count, or cap + 1 where the list overflows, beside it).  One grid
//     sync, then CTA 0 alone runs the chain.
//   * A one-warp chain.  Warp 0 takes a request's candidates 32 at a
//     time against infl in shared memory (N ints, 32 KB at 8192):
//     eff = max(raw // (1 + (infl[n] >> 15)), 1), or 1 where that
//     divisor is 0 or below; each lane keeps its first maximum, and two
//     redux.sync (the max eff, then the least n holding it) give the
//     first argmax across the warp; the lane holding it adds the size to
//     its infl, and lane 0 writes src and the winning eff.  No barrier of
//     the block sits in the chain: a __syncwarp orders the add before
//     the next step's reads.
//   * Lists ahead of the chain.  A producer warp copies the requests'
//     lists into a ring of shared-memory slots with cp.async.bulk (TMA
//     1-D bulk copies; mbarriers full: the bytes landed, empty: the chain
//     left the slot), the counts and sizes of 32 requests read at a time
//     (one a lane), so a step's only dependent read is infl.  A slot
//     packs the lists of consecutive requests while they fit (up to 32
//     requests, 512 candidates or one list of cap), so the chain waits
//     on a barrier once a slot: a wait per request cost ~230 of a step's
//     ~1,000 cycles (PERF.md, PR 14).
//   * Long lists on the block.  A request with more than `cap`
//     candidates (a dense loc) is not listed: the other 30 warps
//     (helpers) read its loc row and bw column straight from memory,
//     prefetching the next long request's while the chain runs, and
//     reduce eff over every column against infl: the chain warp hands
//     them infl with a named barrier (bar.arrive 1), waits for their 30
//     partial keys on another (bar.sync 2), reduces them and updates
//     infl.  kListCap = 128 was measured against one warp looping over
//     the whole list (dataplane_routes.py builds -DRT_LIST_CAP=8192;
//     PERF.md, PR 14).
//   * Costs after the chain.  cost = size // eff (a floor division) is
//     not on the chain: the chain stores eff, and the block turns it
//     into the cost once the chain is done.
//
// Exactness: infl wraps (uint32 add); infl // UNIT is an arithmetic
// shift (UNIT = 2**15, so it floors); raw > 0 and a positive divisor
// make C++ division floor; a divisor of 0 or below gives eff = 1, which
// is what the JAX program gives (raw // d <= -1 there, and XLA's
// quotient by 0 is negative too; tests/test_torch_dataplane.py pins it);
// a candidate's eff is >= 1, so an empty list is exactly JAX's all-zero
// argmax (src -1, cost INT_MAX); ties go to the lowest column (the
// packed key (INT_MAX - eff) << 32 | n on the long path); cost floors
// (sizes may be negative).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "contract.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace rt;

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kHelpers = kWarps - 2;     // warps 2..31
constexpr int kHelperThreads = kHelpers * 32;
constexpr int kLongThreads = kHelperThreads + 32;   // and the chain warp
constexpr int kLongCols = (kMaxNodes + kHelperThreads - 1) / kHelperThreads;
constexpr int kChunk = 16;               // prologue: 16 columns a lane
constexpr int kUnitShift = 15;           // _INFLIGHT_UNIT_KB = 32 * 1024
constexpr int kNoSourceCost = 0x7fffffff;
constexpr int kRingBytes = 96 * 1024;    // the ring's shared memory, at most
constexpr int kPack = 32;                // requests a ring slot, at most
constexpr int kSlotHead = 2 + kPack;     // int2: n, pad, (count, size)s
constexpr int kSlotPairs = 512;          // candidates a ring slot, at least
constexpr int kMaxShared = 232448;       // an H100 block's shared memory
#ifndef RT_LIST_CAP
#define RT_LIST_CAP 128
#endif
// candidates a list holds at most (even: lists are copied in 16 bytes)
constexpr int kListCap = RT_LIST_CAP;
static_assert(kListCap >= 2 && kListCap % 2 == 0, "an even list cap");

struct Args {
  const uint8_t* loc;       // (R, N) bool
  const int* bw;            // (N, N)
  const int* dest;          // (R,)
  const int* sizes;         // (R,)
  const int* inflight;      // (N,)
  int r, n, cap, slots, slot_pairs;
  int2* lists;              // (R, cap) scratch: (n, raw)
  int* counts;              // (R,) scratch: candidates, cap + 1 if more
  int* src;                 // (R,)
  int* cost;                // (R,): the winning eff until the epilogue
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
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
// named barriers: id 1 hands infl to the helpers, id 2 their partials
// back to the chain warp
__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(kLongThreads) : "memory");
}
__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "n"(kLongThreads)
               : "memory");
}

__device__ __forceinline__ int clamp_dest(int d, int n) {
  d = d < 0 ? d + n : d;                 // jnp's gather: negative indices
  return min(max(d, 0), n - 1);          // wrap once, then clamp
}
// eff of a candidate (raw > 0) against its source's in-flight KB
__device__ __forceinline__ int eff_of(int raw, int infl) {
  const int div = 1 + (infl >> kUnitShift);
  return div > 0 ? max(raw / div, 1) : 1;
}

// One warp: request i's candidates, in column order, into its list.
__device__ __forceinline__ void compact(const Args& in, int i) {
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  const int n = in.n, cap = in.cap;
  const int d = clamp_dest(in.dest[i], n);
  const uint8_t* row = in.loc + (long long)i * n;
  int2* out = in.lists + (long long)i * cap;
  int cnt = 0;
  for (int c0 = 0; c0 < n && cnt <= cap; c0 += 32 * kChunk) {
    bool held[kChunk];
    int raw[kChunk];
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      const int c = c0 + k * 32 + lane;
      held[k] = c < n && row[c] != 0;
    }
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      const int c = c0 + k * 32 + lane;
      raw[k] = held[k] ? __ldg(in.bw + (long long)c * n + d) : 0;
    }
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      const bool on = raw[k] > 0;
      const unsigned b = __ballot_sync(kFull, on);
      const int at = cnt + __popc(b & below);
      if (on && at < cap) out[at] = make_int2(c0 + k * 32 + lane, raw[k]);
      cnt += __popc(b);
    }
  }
  if (lane == 0) in.counts[i] = min(cnt, cap + 1);
  // the lists are read by bulk copies (the async proxy)
  asm volatile("fence.proxy.async;\n" ::: "memory");
}

// One warp: the first request at or past i with a long list, or r.
__device__ __forceinline__ int next_long(const Args& in, int i) {
  const int lane = threadIdx.x & 31;
  for (int j0 = i; j0 < in.r; j0 += 32) {
    const int j = j0 + lane;
    const unsigned b =
        __ballot_sync(kFull, j < in.r && __ldcg(in.counts + j) > in.cap);
    if (b) return j0 + __ffs(b) - 1;
  }
  return in.r;
}

// Helper thread g: request j's raw value of each of its columns (0
// where the column does not hold the object), or nothing past the end.
__device__ __forceinline__ void fetch_long(const Args& in, int j, int g,
                                           int (&raw)[kLongCols]) {
  if (j >= in.r) return;
  const int n = in.n;
  const int d = clamp_dest(in.dest[j], n);
  const uint8_t* row = in.loc + (long long)j * n;
#pragma unroll
  for (int k = 0; k < kLongCols; ++k) {
    const int c = g + k * kHelperThreads;
    raw[k] = c < n && row[c] != 0 ? __ldg(in.bw + (long long)c * n + d) : 0;
  }
}

__global__ void __launch_bounds__(kThreads, 1) pull_kernel(Args in) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n = in.n, r = in.r, cap = in.cap, slots = in.slots;

  // every warp of the grid: candidate lists
  for (int i = blockIdx.x * kWarps + warp; i < r; i += gridDim.x * kWarps)
    compact(in, i);
  cg::this_grid().sync();
  if (blockIdx.x != 0) return;

  // barriers (full, empty), the helpers' partial keys, the ring (16-byte
  // aligned for the bulk copies), infl.  A slot is [n, pad, (count,
  // size) x kPack, lists]: the lists of up to kPack requests in a row
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  unsigned long long* part =
      reinterpret_cast<unsigned long long*>(bars + 2 * slots);
  int2* ring = reinterpret_cast<int2*>(part + kHelpers);
  const int slot_len = kSlotHead + in.slot_pairs;       // int2 a slot
  int* infl = reinterpret_cast<int*>(ring + (size_t)slots * slot_len);
  const uint32_t full = smem_u32(bars), empty = smem_u32(bars + slots);
  for (int c = tid; c < n; c += kThreads) infl[c] = in.inflight[c];
  if (tid == 0) {
    for (int s = 0; s < slots; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  asm volatile("fence.proxy.async;\n" ::: "memory");
  __syncthreads();

  if (warp == 1) {
    // producer: the requests in order, packed into slots while a slot
    // has room (kPack requests, cap candidates); the counts and sizes of
    // 32 requests at a time, one a lane, the next 32 in flight; lane 0
    // fills the slots, each list one bulk copy, and closes a slot with
    // one arrival
    const uint32_t base = smem_u32(ring);
    int seq = 0, s = 0, off = 0, nq = 0;
    bool open = false;
    int c_next = lane < r ? __ldcg(in.counts + lane) : 0;
    int z_next = lane < r ? in.sizes[lane] : 0;
    for (int i0 = 0; i0 < r; i0 += 32) {
      const int c_mine = c_next, z_mine = z_next;
      const int j = i0 + 32 + lane;
      c_next = j < r ? __ldcg(in.counts + j) : 0;
      z_next = j < r ? in.sizes[j] : 0;
      for (int k = 0; k < 32 && i0 + k < r; ++k) {
        const int c = __shfl_sync(kFull, c_mine, k);
        const int z = __shfl_sync(kFull, z_mine, k);
        if (lane != 0) continue;
        const int need = c <= cap ? (c + 1) & ~1 : 0;   // 16-byte copies
        int2* slot = ring + (size_t)s * slot_len;
        if (open && (nq == kPack || off + need > in.slot_pairs)) {
          reinterpret_cast<int*>(slot)[0] = nq;
          mbar_arrive(full + 8 * s);
          open = false;
        }
        if (!open) {
          s = seq % slots;
          mbar_wait(empty + 8 * s, ((seq / slots) & 1) ^ 1);
          ++seq;
          off = nq = 0;
          open = true;
          slot = ring + (size_t)s * slot_len;
        }
        slot[2 + nq++] = make_int2(c, z);
        if (c > 0 && c <= cap) {
          const uint32_t bytes = (uint32_t)need * 8u;
          mbar_add_tx(full + 8 * s, bytes);
          bulk_load(base + 8u * (uint32_t)(s * slot_len + kSlotHead + off),
                    in.lists + (long long)(i0 + k) * cap, bytes,
                    full + 8 * s);
          off += need;
        }
      }
    }
    if (lane == 0 && open) {
      reinterpret_cast<int*>(ring + (size_t)s * slot_len)[0] = nq;
      mbar_arrive(full + 8 * s);
    }
  } else if (warp == 0) {
    // the chain: a slot at a time, its requests in order
    for (int i = 0, seq = 0; i < r; ++seq) {
      const int s = seq % slots;
      mbar_wait(full + 8 * s, (seq / slots) & 1);
      const int2* slot = ring + (size_t)s * slot_len;
      const int nq = reinterpret_cast<const int*>(slot)[0];
      const int2* data = slot + kSlotHead;
      for (int q = 0, off = 0; q < nq; ++q, ++i) {
        // the list's first 32 entries load beside its count (past the
        // count they are not read)
        const int2* lst = data + off;
        const int2 head = lst[min(lane, in.slot_pairs - 1 - off)];
        const int2 cz = slot[2 + q];
        const int c = cz.x, size = cz.y;
        int best = 0, at = 0;
        if (c <= cap) {
          int b = 0, bi = 0;
          unsigned bn = 0xffffffffu;
          for (int j = lane; j < c; j += 32) {
            const int2 e = j < 32 ? head : lst[j];
            const int f = infl[e.x];
            const int eff = eff_of(e.y, f);
            if (eff > b) {               // a lane's columns ascend
              b = eff;
              bn = (unsigned)e.x;
              bi = f;
            }
          }
          best = __reduce_max_sync(kFull, b);
          at = (int)__reduce_min_sync(kFull,
                                      b == best ? bn : 0xffffffffu);
          // the winning lane holds infl[at]: it adds the size
          if (best > 0 && bn == (unsigned)at) infl[at] = wadd(bi, size);
          off += (c + 1) & ~1;
        } else {
          // the helpers reduce every column against this infl
          __threadfence_block();
          named_arrive(1);
          named_sync(2);
          const unsigned long long v =
              warp_min(lane < kHelpers ? part[lane] : kNoKey);
          best = v == kNoKey ? 0 : 0x7fffffff - (int)(unsigned)(v >> 32);
          at = packed_row(v);
          if (lane == 0 && best > 0) infl[at] = wadd(infl[at], size);
        }
        if (lane == 0) {
          in.src[i] = best > 0 ? at : -1;
          in.cost[i] = best;
        }
        __syncwarp();
      }
      if (lane == 0) mbar_arrive(empty + 8 * s);
    }
  } else {
    // helpers: the long requests, each prefetched while the chain runs
    const int g = tid - 64;
    int raw[kLongCols];
    int j = next_long(in, 0);
    fetch_long(in, j, g, raw);
    while (j < r) {
      named_sync(1);
      unsigned long long v = kNoKey;
#pragma unroll
      for (int k = 0; k < kLongCols; ++k) {
        const int c = g + k * kHelperThreads;
        if (raw[k] > 0) {
          const int eff = eff_of(raw[k], infl[c]);
          const unsigned long long key =
              ((unsigned long long)(unsigned)(0x7fffffff - eff) << 32) |
              (unsigned)c;
          v = key < v ? key : v;
        }
      }
      v = warp_min(v);
      if (lane == 0) part[warp - 2] = v;
      __threadfence_block();
      named_arrive(2);
      j = next_long(in, j + 1);
      fetch_long(in, j, g, raw);
    }
  }
  __syncthreads();
  // the costs, off the chain
  for (int i = tid; i < r; i += kThreads) {
    const int best = in.cost[i];
    in.cost[i] = best > 0 ? floordiv(in.sizes[i], best) : kNoSourceCost;
  }
}

// a slot holds one list of `cap` and packs shorter ones up to its pairs
int slot_pairs(int cap) { return cap > kSlotPairs ? cap : kSlotPairs; }

size_t smem_bytes(int n, int cap, int slots) {
  return 2 * (size_t)slots * 8 + kHelpers * 8 +
         (size_t)slots * (kSlotHead + slot_pairs(cap)) * 8 + (size_t)n * 4;
}

// The ring's slots for a list cap: as many as fit kRingBytes, 2 to 16.
int ring_slots(int cap) {
  const int s = kRingBytes / ((kSlotHead + slot_pairs(cap)) * 8);
  return s < 2 ? 2 : (s > 16 ? 16 : s);
}

// a list's cap for N columns: kListCap, or N rounded up to even
int list_cap(int n) { return min(kListCap, (n + 1) & ~1); }

}  // namespace

// The scratch of a launch over R requests and N columns: out = [the list
// cap, scratch ints (R lists of cap (n, raw) pairs, then R counts)].
// Returns a cudaError_t (cudaErrorInvalidValue outside 1 <= N <= 8192).
extern "C" int rt_pull_plan(int r, int n, long long* out) {
  if (n < 1 || n > kMaxNodes || r < 0) return (int)cudaErrorInvalidValue;
  out[0] = list_cap(n);
  out[1] = (long long)r * (2 * out[0] + 1);
  return 0;
}

// One cooperative launch on `stream`: every warp of the grid compacts
// requests' candidates, CTA 0 runs the chain.  1 <= N <= 8192; `scratch`
// holds the ints rt_pull_plan names.  Writes src (R,) and cost (R,).
// Returns a cudaError_t.
extern "C" int rt_pull_choose(const void* loc, const void* bw,
                              const void* dest, const void* sizes,
                              const void* inflight, int r, int n,
                              void* scratch, void* src, void* cost,
                              void* stream) {
  if (n < 1 || n > kMaxNodes || r < 0) return (int)cudaErrorInvalidValue;
  const int cap = list_cap(n);
  const int slots = ring_slots(cap);
  const size_t bytes = smem_bytes(n, cap, slots);
  if (bytes > (size_t)kMaxShared) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      pull_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, pull_kernel,
                                                      kThreads, bytes);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  int2* lists = (int2*)scratch;          // 16-byte aligned rows: cap is even
  Args in{(const uint8_t*)loc, (const int*)bw, (const int*)dest,
          (const int*)sizes, (const int*)inflight, r, n, cap, slots,
          slot_pairs(cap), lists, (int*)(lists + (long long)r * cap),
          (int*)src, (int*)cost};
  // every CTA resident at once (the grid sync needs it)
  const int grid = max(1, min((r + kWarps - 1) / kWarps, per_sm * sms));
  void* args[] = {&in};
  err = cudaLaunchCooperativeKernel((const void*)pull_kernel, dim3(grid),
                                    dim3(kThreads), args, bytes,
                                    (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
