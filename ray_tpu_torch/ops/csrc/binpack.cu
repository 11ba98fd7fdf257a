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
// What bounds it on this card: neither bytes nor operations.  The state
// is tiny (used (K, R), packed (K, G), remaining (G), quota and launches
// (K)) and the work per iteration is K*G*R small integer steps; the time
// is the chain: iterations x G dependent class steps, each a warp-wide
// min over R.  Eagerly in PyTorch each class step would be ~8 launches
// and each iteration a host sync (PERF.md: such loops ran 1,900-850,000x
// their bounds).  So the whole loop is ONE launch of one CTA:
//
//   * Everything in shared memory where it fits: the type caps (K, R) and
//     demand requests (G, R) are staged once; used, packed, remaining,
//     quota and launches live there across iterations; only launches and
//     the final remaining are written back.  Where the card's shared
//     memory cannot hold them all (K=16, R=64 fills it near 680 classes),
//     plan() keeps the arrays that do not fit in global memory, last
//     placed first to go, so every shape runs; the launch that fits keeps
//     its own instantiation (kAllShared) and code.
//   * One warp per node type (warps loop over types when K > 32), lanes
//     over R: a class step is a strided pass over R (space // req where
//     req > 0), a 5-shuffle min, and the used update.  The G classes run
//     in order inside the warp because the first fit carries `used`; the
//     K types run in parallel across warps.
//   * Then warp 0 picks the type (a first-max over K on lane 0) and the
//     repeat factor (lanes over G, a warp min), and every thread updates
//     its share of remaining.  Three __syncthreads per iteration.
//
// Exactness (ROADMAP B): floordiv by hand (CUDA truncates); _BIG = 2**30
// for a column with no request; fit = clip(fit, 0, max(rem, 0)), and 0
// for a class with no positive entry; t = max(min(t, quota[k]), 1);
// used * SCALE and every sum and product in uint32, so they wrap as XLA's
// int32 does and C++ never sees signed overflow (within MAX_TOTAL_CU caps
// nothing wraps at all).

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kBig = 1 << 30;
constexpr int kScale = 4096;            // scheduling/contract.py SCALE
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
// numpy/XLA floor division (b >= 1 at every call site)
__device__ __forceinline__ int floordiv(int a, int b) {
  int q = a / b;
  if ((a % b != 0) && ((a < 0) != (b < 0))) --q;
  return q;
}
__device__ __forceinline__ int warp_min(int x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = min(x, __shfl_xor_sync(kFull, x, o));
  return x;
}
__device__ __forceinline__ int warp_max(int x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = max(x, __shfl_xor_sync(kFull, x, o));
  return x;
}
__device__ __forceinline__ unsigned warp_sum(unsigned x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

// Where each array lives.  plan() places them in this order, each in
// shared memory while the card's opt-in limit has room for it, else in
// global memory: the per-type and per-class state in a scratch the entry
// point allocates, caps and requests read where the caller holds them.
// The order is the inner loop's: the state it carries, then what every
// class step reads, then the packed table warp 0 reads once.
enum Array {
  kState = 0,   // ctl (8) + quota, launches, score, psum (K each)
  kCls,         // rem, anypos (G each)
  kUsed,        // (K, R)
  kCaps,        // (K, R), read-only
  kReqs,        // (G, R), read-only
  kPacked,      // (K, G)
  kArrays
};

struct Plan {
  long long off[kArrays];   // ints into shared memory or the scratch
  unsigned global;          // bit a: array a is in global memory
  long long smem_ints, scratch_ints;
};

cudaError_t plan(int k, int g, int r, Plan* p) {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  const long long kk = k, gg = g, rr = r;
  const long long ints[kArrays] = {8 + 4 * kk, 2 * gg, kk * rr, kk * rr,
                                   gg * rr, kk * gg};
  const long long room = optin / (long long)sizeof(int);
  *p = {};
  for (int a = 0; a < kArrays; ++a) {
    if (p->smem_ints + ints[a] <= room) {
      p->off[a] = p->smem_ints;
      p->smem_ints += ints[a];
    } else {
      p->global |= 1u << a;
      if (a != kCaps && a != kReqs) {
        p->off[a] = p->scratch_ints;
        p->scratch_ints += ints[a];
      }
    }
  }
  return cudaSuccess;
}

enum { kSum = 0, kPick, kOk, kT };

// kAllShared: every array is in shared memory (the compiler then sees
// shared addresses); else each array's pointer is taken from the plan.
template <bool kAllShared>
__global__ void binpack_launch_loop_kernel(
    const int* __restrict__ type_caps, const int* __restrict__ type_quotas,
    const int* __restrict__ demand_reqs, const int* __restrict__ remaining,
    int k_types, int g_cls, int r_res, int max_iters, Plan pl,
    int* __restrict__ scratch, int* __restrict__ launches_out,
    int* __restrict__ remaining_out, int* __restrict__ iters_out) {
  extern __shared__ int sm[];
  auto at = [&](int a) -> int* {
    return (kAllShared || !(pl.global >> a & 1u)) ? sm + pl.off[a]
                                                   : scratch + pl.off[a];
  };
  int* const state = at(kState);
  int* const ctl = state;
  int* const quota = state + 8;
  int* const launches = quota + k_types;
  int* const score = launches + k_types;
  int* const psum = score + k_types;
  int* const rem = at(kCls);
  int* const anypos = rem + g_cls;
  int* const used = at(kUsed);
  int* const packed = at(kPacked);
  const bool caps_sh = kAllShared || !(pl.global >> kCaps & 1u);
  const bool reqs_sh = kAllShared || !(pl.global >> kReqs & 1u);
  const int* const caps = caps_sh ? sm + pl.off[kCaps] : type_caps;
  const int* const reqs = reqs_sh ? sm + pl.off[kReqs] : demand_reqs;

  const int tid = threadIdx.x, nt = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31, nw = nt >> 5;
  const size_t kr = (size_t)k_types * r_res, gr = (size_t)g_cls * r_res;

  if (caps_sh)
    for (size_t i = tid; i < kr; i += nt) sm[pl.off[kCaps] + i] = type_caps[i];
  if (reqs_sh)
    for (size_t i = tid; i < gr; i += nt)
      sm[pl.off[kReqs] + i] = demand_reqs[i];
  for (int i = tid; i < k_types; i += nt) {
    quota[i] = type_quotas[i];
    launches[i] = 0;
  }
  for (int g = tid; g < g_cls; g += nt) {
    rem[g] = remaining[g];
    int any = 0;
    const int* req = demand_reqs + (size_t)g * r_res;
    for (int c = 0; c < r_res; ++c) any |= req[c] > 0;
    anypos[g] = any;
  }
  __syncthreads();

  int it = 0;
  bool done = false;
  for (;;) {
    // cond: remaining.sum() > 0 (an int32 sum, wrapping) & ~done & it < max
    if (warp == 0) {
      unsigned s = 0;
      for (int g = lane; g < g_cls; g += 32) s += (unsigned)rem[g];
      s = warp_sum(s);
      if (lane == 0) ctl[kSum] = (int)s;
    }
    __syncthreads();
    if (!(ctl[kSum] > 0 && !done && it < max_iters)) break;

    // _pack_all_types: warp w packs types w, w + nw, ...
    for (int k = warp; k < k_types; k += nw) {
      const int* cap = caps + (size_t)k * r_res;
      int* u = used + (size_t)k * r_res;
      for (int c = lane; c < r_res; c += 32) u[c] = 0;
      __syncwarp();
      unsigned fit_sum = 0;
      for (int g = 0; g < g_cls; ++g) {
        const int* req = reqs + (size_t)g * r_res;
        int fit = 0;
        if (anypos[g]) {
          int f = kBig;
          for (int c = lane; c < r_res; c += 32) {
            const int q = req[c];
            if (q > 0) f = min(f, floordiv(wsub(cap[c], u[c]), q));
          }
          f = warp_min(f);
          fit = min(max(f, 0), max(rem[g], 0));
        }
        if (fit != 0)
          for (int c = lane; c < r_res; c += 32)
            u[c] = wadd(u[c], wmul(fit, req[c]));
        __syncwarp();
        if (lane == 0) packed[(size_t)k * g_cls + g] = fit;
        fit_sum += (unsigned)fit;
      }
      // score = max_c where(cap > 0, (used * SCALE) // max(cap, 1), 0)
      int s = INT_MIN;
      for (int c = lane; c < r_res; c += 32)
        s = max(s, cap[c] > 0 ? floordiv(wmul(u[c], kScale), cap[c]) : 0);
      s = warp_max(s);
      if (lane == 0) {
        score[k] = s;
        psum[k] = (int)fit_sum;
      }
    }
    __syncthreads();

    // pick the type (first max of s_eff) and the repeat factor t
    if (warp == 0) {
      int kk = 0;
      if (lane == 0) {
        int best = INT_MIN;
        for (int k = 0; k < k_types; ++k) {
          const int se = (quota[k] > 0 && psum[k] > 0) ? score[k] : -1;
          if (se > best) {
            best = se;
            kk = k;
          }
        }
        ctl[kPick] = kk;
        ctl[kOk] = best >= 0;
      }
      kk = __shfl_sync(kFull, kk, 0);
      const int* p = packed + (size_t)kk * g_cls;
      int t = kBig;
      for (int g = lane; g < g_cls; g += 32)
        if (p[g] > 0) t = min(t, floordiv(rem[g], p[g]));
      t = warp_min(t);
      if (lane == 0) ctl[kT] = max(min(t, quota[kk]), 1);
    }
    __syncthreads();
    const int kk = ctl[kPick], t = ctl[kT];
    const bool ok = ctl[kOk] != 0;
    if (ok) {
      const int* p = packed + (size_t)kk * g_cls;
      for (int g = tid; g < g_cls; g += nt)
        rem[g] = max(wsub(rem[g], wmul(t, p[g])), 0);
      if (tid == 0) {
        quota[kk] = wsub(quota[kk], t);
        launches[kk] = wadd(launches[kk], t);
      }
    }
    done = !ok;
    ++it;
    __syncthreads();
  }

  for (int i = tid; i < k_types; i += nt) launches_out[i] = launches[i];
  for (int g = tid; g < g_cls; g += nt) remaining_out[g] = rem[g];
  if (tid == 0) *iters_out = it;
}

}  // namespace

// One launch of one CTA (32 * min(K, 32) threads) on `stream`.  Writes
// the launch it made into layout[0..2]: bytes of shared memory, the
// arrays in global memory (bit a = enum Array a), ints of global
// scratch (allocated on the stream for this launch and freed after it).
// Returns a cudaError_t.
extern "C" int rt_binpack_launch_loop(const void* type_caps,
                                      const void* type_quotas,
                                      const void* demand_reqs,
                                      const void* remaining, int k, int g,
                                      int r, int max_iters, void* launches,
                                      void* remaining_out, void* iters,
                                      int* layout, void* stream) {
  if (k < 1 || g < 1 || r < 1 || max_iters < 0)
    return (int)cudaErrorInvalidValue;
  Plan pl;
  cudaError_t err = plan(k, g, r, &pl);
  if (err != cudaSuccess) return (int)err;
  const size_t bytes = sizeof(int) * (size_t)pl.smem_ints;
  layout[0] = (int)bytes;
  layout[1] = (int)pl.global;
  layout[2] = (int)std::min<long long>(pl.scratch_ints, INT_MAX);
  const auto kernel = pl.global == 0 ? binpack_launch_loop_kernel<true>
                                     : binpack_launch_loop_kernel<false>;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t st = (cudaStream_t)stream;
  int* scratch = nullptr;
  if (pl.scratch_ints > 0) {
    err = cudaMallocAsync((void**)&scratch,
                          sizeof(int) * (size_t)pl.scratch_ints, st);
    if (err != cudaSuccess) return (int)err;
  }
  const int threads = 32 * (k < 32 ? k : 32);
  kernel<<<1, threads, bytes, st>>>(
      (const int*)type_caps, (const int*)type_quotas,
      (const int*)demand_reqs, (const int*)remaining, k, g, r, max_iters, pl,
      scratch, (int*)launches, (int*)remaining_out, (int*)iters);
  err = cudaGetLastError();
  if (scratch != nullptr) {
    const cudaError_t freed = cudaFreeAsync(scratch, st);
    if (err == cudaSuccess) err = freed;
  }
  return (int)err;
}

extern "C" const char* rt_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
