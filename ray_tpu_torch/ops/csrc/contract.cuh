// Device helpers shared by every scheduling kernel (waterfill.cu,
// binpack.cu, topk.cu, bundle.cu, pull.cu, broadcast.cu): the int32
// scheduling contract of scheduling/contract.py and XLA's integer
// semantics, written out.
//
// * int32 add, subtract and multiply wrap as XLA's do: they run in
//   uint32 and cast back (signed overflow is undefined in C++).
// * floordiv and floormod floor as numpy, torch and XLA `//` and `%` do
//   (CUDA `/` and `%` truncate toward zero); fdiv floors by a divisor's
//   magic multiplier (magic), exact for every int32 dividend.
// * contract_key is hybrid_kernel._keys for one (request, row): the avail
//   bit, the effective score and the row packed into an int32, or
//   INFEASIBLE_KEY.  Only the request's positive columns enter it, as in
//   the reference's torch.where(req_pos, ..., True/0).  contract_key_rcp
//   is the same key with each division by a precomputed magic multiplier.
// * A packed 64-bit value (key or score in the high word, row in the low
//   word) makes a first-min or first-max a plain unsigned min: ties go to
//   the lowest row, and the min over an all-INF row is row 0, as
//   jnp.argmin gives.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace rt {

constexpr int kScale = 1 << 12;          // contract.SCALE
constexpr int kScoreShift = 13;          // contract.SCORE_SHIFT (= NODE_BITS)
constexpr int kAvailShift = 27;          // contract.AVAIL_SHIFT
constexpr int kMaxNodes = 1 << 13;       // contract.MAX_NODES
constexpr int kRowMask = kMaxNodes - 1;  // a key's row bits
constexpr int kBig = 1 << 30;            // hybrid_kernel._BIG
constexpr int kInfKey = 0x7fffffff;      // contract.INFEASIBLE_KEY
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned long long kNoKey = ~0ull;

__device__ __forceinline__ int wadd(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
}
__device__ __forceinline__ int wsub(int a, int b) {
  return (int)((unsigned)a - (unsigned)b);
}
__device__ __forceinline__ int wmul(int a, int b) {
  return (int)((unsigned)a * (unsigned)b);
}
// numpy/XLA floor division and remainder; b != 0 and (a, b) !=
// (INT_MIN, -1) at every call site
__device__ __forceinline__ int floordiv(int a, int b) {
  const int q = a / b;
  return (a % b != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}
__device__ __forceinline__ int floormod(int a, int b) {
  const int m = a % b;
  return (m != 0 && ((m < 0) != (b < 0))) ? m + b : m;
}
// the divisor d >= 1 as (m, s) for fdiv
__device__ __forceinline__ uint2 magic(int d) {
  const unsigned s = 31u + (32u - (unsigned)__clz(d - 1));
  const unsigned long long m =
      ((1ull << s) + (unsigned long long)(d - 1)) / (unsigned long long)d;
  return make_uint2((unsigned)m, s);
}
// floor(a / d) for any int32 a, (m, s) = magic(d): a multiply-high and a
// shift in place of a division (Granlund and Montgomery)
__device__ __forceinline__ int fdiv(int a, unsigned m, unsigned s) {
  const unsigned neg = (unsigned)(a >> 31);
  const unsigned x = (unsigned)a ^ neg;
  return (int)((unsigned)(((unsigned long long)x * m) >> s) ^ neg);
}

// (key ^ sign bit) << 32 | row: unsigned order is (signed key, row) order
__device__ __forceinline__ unsigned long long pack_key(int key, int row) {
  return ((unsigned long long)((unsigned)key ^ 0x80000000u) << 32) |
         (unsigned)row;
}
__device__ __forceinline__ int packed_key(unsigned long long v) {
  return (int)((unsigned)(v >> 32) ^ 0x80000000u);
}
__device__ __forceinline__ int packed_row(unsigned long long v) {
  return (int)(unsigned)(v & 0xffffffffu);
}

// The key from a row's feasibility, availability and score.
__device__ __forceinline__ int pack_contract_key(bool feas, bool availb,
                                                 int s, int thr_fp,
                                                 int row) {
  if (!feas) return kInfKey;
  const int eff = (availb && s < thr_fp) ? 0 : s;
  return (int)(((unsigned)(!availb) << kAvailShift) |
               ((unsigned)eff << kScoreShift) | (unsigned)row);
}

// The packed contract key of one row for one request, whose positive
// columns are col[0..npos) with values q[0..npos); t and a are the row's
// totals and avail (row-major, 64-bit offsets).  `live` is the row's
// mask.  hybrid_kernel._keys, bit for bit.
__device__ __forceinline__ int contract_key(const int* __restrict__ t_row,
                                            const int* a_row,
                                            const int* col, const int* q,
                                            int npos, bool live,
                                            int thr_fp, int row) {
  bool feas = live, availb = true;
  int s = 0;                             // .amax(...).clamp_min(0)
  for (int p = 0; p < npos; ++p) {
    const int c = col[p], qc = q[p];
    const int t = t_row[c], a = a_row[c];
    feas = feas && (t >= qc);
    availb = availb && (a >= qc);
    const int num = wmul(wadd(wsub(t, a), qc), kScale);
    s = max(s, floordiv(num, max(t, 1)));
  }
  return pack_contract_key(feas, availb, s, thr_fp, row);
}

// contract_key with the division by max(t, 1) done by that divisor's
// magic multiplier m = magic(max(t, 1)).x, computed once per (row,
// column) by the caller (its shift follows from t).  `col(p, t, a, m, q)`
// gives the p-th positive column's totals, avail, multiplier and
// request.  The same key, bit for bit: fdiv is floordiv for every int32
// dividend.
template <class Col>
__device__ __forceinline__ int contract_key_rcp(Col col, int npos, bool live,
                                                int thr_fp, int row) {
  bool feas = live, availb = true;
  int s = 0;
  for (int p = 0; p < npos; ++p) {
    int t, a, qc;
    unsigned m;
    col(p, t, a, m, qc);
    feas = feas && (t >= qc);
    availb = availb && (a >= qc);
    const int num = wmul(wadd(wsub(t, a), qc), kScale);
    const unsigned sh = 63u - (unsigned)__clz(max(t, 1) - 1);
    s = max(s, fdiv(num, m, sh));
  }
  return pack_contract_key(feas, availb, s, thr_fp, row);
}

__device__ __forceinline__ unsigned long long warp_min(unsigned long long x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const unsigned long long y = __shfl_xor_sync(kFull, x, o);
    x = y < x ? y : x;
  }
  return x;
}

// Block-wide min of K packed values with ONE barrier: each warp's min
// goes to part[k][warp], and after the barrier every warp reduces all
// partials itself, so every thread returns the block's mins.  A caller
// alternates `part` between two buffers (or puts another barrier
// between two calls): a warp may still read this call's partials while
// a faster one writes the next call's.
template <int K>
__device__ __forceinline__ void block_min(unsigned long long (&v)[K],
                                          unsigned long long (*part)[32]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
#pragma unroll
  for (int k = 0; k < K; ++k) v[k] = warp_min(v[k]);
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) part[k][warp] = v[k];
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < K; ++k) v[k] = warp_min(lane < nw ? part[k][lane] : kNoKey);
}

// Warp 0 compacts a request of r columns (read from `src`, or summed by
// the caller into `src` in shared memory) into its positive columns
// (col/q, count in *npos) and, when nz_col is given, its nonzero columns
// (nz_col/nz_q, count in *nnz), in column order.  The caller syncs.
__device__ __forceinline__ void compact_request(const int* src, int r,
                                                int* col, int* q, int* npos,
                                                int* nz_col, int* nz_q,
                                                int* nnz) {
  const int lane = threadIdx.x & 31;
  int cp = 0, cz = 0;
  for (int c0 = 0; c0 < r; c0 += 32) {
    const int c = c0 + lane;
    const int v = c < r ? src[c] : 0;
    const unsigned below = (1u << lane) - 1u;
    const unsigned pos = __ballot_sync(kFull, v > 0);
    if (v > 0) {
      const int at = cp + __popc(pos & below);
      col[at] = c;
      q[at] = v;
    }
    cp += __popc(pos);
    if (nz_col != nullptr) {
      const unsigned nz = __ballot_sync(kFull, v != 0);
      if (v != 0) {
        const int at = cz + __popc(nz & below);
        nz_col[at] = c;
        nz_q[at] = v;
      }
      cz += __popc(nz);
    }
  }
  if (lane == 0) {
    *npos = cp;
    if (nnz != nullptr) *nnz = cz;
  }
}

}  // namespace rt

extern "C" const char* rt_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
