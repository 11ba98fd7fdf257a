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
// call at 4096 pulls x 1000 nodes moves ~8 MB: 0.0024 ms of bound).  The
// design:
//
//   * The column reads leave the chain.  bw[:, dest[i]] is a column of
//     a row-major N x N matrix: read inside the loop, each of its N
//     values is its own 32-byte sector.  It does not depend on infl, so
//     the launch first gathers every request's column into a scratch
//     (R, N) matrix with every CTA of a cooperative grid (one request row
//     a CTA at a time, the writes coalesced), syncs the grid once, and
//     only CTA 0 runs the chain, reading rows of the scratch and of loc
//     (contiguous) and prefetching request i + 1's while it reduces i.
//   * The carry in registers.  Thread tid owns rows m * 1024 + tid (E =
//     ceil(N / 1024) <= 8 of them) and keeps their infl in registers;
//     after the argmax every thread knows s, and its owner adds the size.
//     A step is then one key pass and one barrier (contract.cuh
//     block_min, with double-buffered partials): no shared carry, no
//     second barrier.
//   * argmax as a packed min: (INT_MAX - eff) << 32 | row, so the first
//     maximum is the unsigned minimum and an all-zero eff gives row 0,
//     as jnp.argmax does.
//
// Exactness: infl wraps (uint32 add); infl // UNIT is an arithmetic
// shift (UNIT = 2**15, so it floors); raw > 0 and a positive divisor
// make C++ division floor; a divisor of 0 or below gives eff = 1, which
// is what the JAX program gives (raw // d <= -1 there, and XLA's
// quotient by 0 is negative too; tests/test_torch_dataplane.py pins it);
// cost floors (sizes may be negative).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "contract.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace rt;

constexpr int kThreads = 1024;
constexpr int kUnitShift = 15;           // _INFLIGHT_UNIT_KB = 32 * 1024
constexpr int kNoSourceCost = 0x7fffffff;

struct Args {
  const bool* loc;          // (R, N)
  const int* bw;            // (N, N)
  const int* dest;          // (R,)
  const int* sizes;         // (R,)
  const int* inflight;      // (N,)
  int r, n;
  int* gathered;            // (R, N) scratch
  int* src;                 // (R,)
  int* cost;                // (R,)
};

template <int E>
__global__ void __launch_bounds__(kThreads, 1) pull_kernel(Args in) {
  __shared__ unsigned long long part[2][1][32];
  const int tid = threadIdx.x;
  const int n = in.n, r = in.r;

  // every CTA: gathered[i, :] = bw[:, dest[i]]
  for (int i = blockIdx.x; i < r; i += gridDim.x) {
    int d = in.dest[i];
    d = d < 0 ? d + n : d;               // jnp's gather: negative indices
    d = min(max(d, 0), n - 1);           // wrap once, then clamp
    int* out = in.gathered + (long long)i * n;
    for (int c = tid; c < n; c += kThreads)
      out[c] = in.bw[(long long)c * n + d];
  }
  cg::this_grid().sync();
  if (blockIdx.x != 0) return;

  int infl[E], raw[E];
  bool held[E];
#pragma unroll
  for (int m = 0; m < E; ++m) {
    const int c = m * kThreads + tid;
    infl[m] = c < n ? in.inflight[c] : 0;
    raw[m] = 0;
    held[m] = false;
  }
  // request 0's row (written by other CTAs: read through L2, not L1)
  if (r > 0)
#pragma unroll
    for (int m = 0; m < E; ++m) {
      const int c = m * kThreads + tid;
      if (c < n) {
        raw[m] = __ldcg(in.gathered + c);
        held[m] = in.loc[c];
      }
    }

  for (int i = 0; i < r; ++i) {
    unsigned long long v[1] = {kNoKey};
#pragma unroll
    for (int m = 0; m < E; ++m) {
      const int c = m * kThreads + tid;
      if (c < n) {
        int eff = 0;
        if (held[m] && raw[m] > 0) {
          const int div = 1 + (infl[m] >> kUnitShift);
          eff = div > 0 ? max(raw[m] / div, 1) : 1;
        }
        const unsigned long long k =
            ((unsigned long long)(unsigned)(0x7fffffff - eff) << 32) |
            (unsigned)c;
        v[0] = k < v[0] ? k : v[0];
      }
    }
    // the next request's row, in flight during the reduction
    if (i + 1 < r) {
      const long long at = (long long)(i + 1) * n;
#pragma unroll
      for (int m = 0; m < E; ++m) {
        const int c = m * kThreads + tid;
        if (c < n) {
          raw[m] = __ldcg(in.gathered + at + c);
          held[m] = in.loc[at + c];
        }
      }
    }
    block_min<1>(v, part[i & 1]);
    const int s = packed_row(v[0]);
    const int best = 0x7fffffff - (int)(unsigned)(v[0] >> 32);
    const int size = in.sizes[i];
    if (best > 0) {
#pragma unroll
      for (int m = 0; m < E; ++m)
        if (m * kThreads + tid == s) infl[m] = wadd(infl[m], size);
    }
    if (tid == 0) {
      in.src[i] = best > 0 ? s : -1;
      in.cost[i] = best > 0 ? floordiv(size, best) : kNoSourceCost;
    }
  }
}

template <int E>
cudaError_t launch(Args in, void* stream) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm,
                                                      pull_kernel<E>,
                                                      kThreads, 0);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  // every CTA resident at once (the grid sync needs it)
  const int grid = max(1, min(in.r, per_sm * sms));
  void* args[] = {&in};
  err = cudaLaunchCooperativeKernel((const void*)pull_kernel<E>, dim3(grid),
                                    dim3(kThreads), args, 0,
                                    (cudaStream_t)stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// One cooperative launch on `stream`: every CTA gathers, CTA 0 runs the
// chain.  1 <= N <= 8192; `gathered` holds R * N ints.  Writes src (R,)
// and cost (R,).  Returns a cudaError_t.
extern "C" int rt_pull_choose(const void* loc, const void* bw,
                              const void* dest, const void* sizes,
                              const void* inflight, int r, int n,
                              void* gathered, void* src, void* cost,
                              void* stream) {
  if (n < 1 || n > 8 * kThreads || r < 0) return (int)cudaErrorInvalidValue;
  const Args in{(const bool*)loc, (const int*)bw, (const int*)dest,
                (const int*)sizes, (const int*)inflight, r, n,
                (int*)gathered, (int*)src, (int*)cost};
  if (n <= 1 * kThreads) return (int)launch<1>(in, stream);
  if (n <= 2 * kThreads) return (int)launch<2>(in, stream);
  if (n <= 4 * kThreads) return (int)launch<4>(in, stream);
  return (int)launch<8>(in, stream);
}
