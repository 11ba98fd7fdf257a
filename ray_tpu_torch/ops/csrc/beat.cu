// The rest of the delta heartbeat, by hand for Hopper (sm_90a): the two
// kernels around the class scan, for one rank or for S ranks of a
// row-sharded plane that share one card.  A steady beat is one host-to-
// device copy of the beat's staged inputs, beat_rows, the scan
// (waterfill.cu at S = 1, shard_scan.cu past it), beat_tail and one
// device-to-host copy of the packed result.
//
// Replaces, bit for bit in int32 (scheduling/contract.py):
//   beat_rows, the prologue:
//     ray_tpu/ops/hybrid_kernel.py::apply_dirty_rows (:348; its
//     _keys_cols :325), fused_beat's overrides, soft mask and class gather
//     (:399-401), apply_dirty_classes (:363) and full_rescore (:318); and
//     the shard_map twins of ray_tpu/ops/shard_reduce.py::ShardPlane
//     (apply_dirty_rows :311, apply_dirty_classes :350, full_rescore :290,
//     fused_beat's override and gather part).
//   beat_tail, after the scan:
//     fused_beat's budgets, packing and argmin (hybrid_kernel.py:415-427;
//     ShardPlane.fused_beat's budgets, its pmin2 over the carried keys and
//     its gathers).
//
// What bounds it on this card: at the beat cell (1000 -> 1024 nodes x 8
// resources x 64 classes, 12 dirty rows) the two kernels move ~0.9 MB
// (the budgets' (C, N+1) rows, the keys read once for the argmin, avail
// copied into avail_eff) and do ~2.2 M int32 operations
// (chip_smoke.py beat_rest_work): a bound of a few tenths of a
// microsecond.  The time is the launches and their latency, not the work.
// Eager PyTorch spends ~85 launches on it; the design is to make it two
// launches whatever S is, with no grid-wide barrier and no host sync:
//
//   * Every step is node-local except the group gather and the argmin.
//     beat_rows runs a CTA per (node tile, rank): it scatters the beat's
//     dirty rows that land in its tile into the resident totals / avail /
//     mask in place, then rescores those rows' key columns against every
//     class in place (the low bits the global row, rank * n_l + row), then
//     writes the tile's avail_eff (avail with this beat's overrides) and
//     mask_eff = mask & extra_mask.  The first tile of each rank gathers
//     group_reqs = reqs[clamp(slots)], copies the group counts, and zeroes
//     the rank's shard_scan exchange area, so the scan's table of pointers
//     stays valid from beat to beat and no memset is launched.
//   * The same kernel with other index sets covers the rare calls: a class
//     install scatters B request rows into every rank's copy of reqs and
//     rescores those key rows over every node (reading the new rows from
//     the staged inputs, so no CTA waits for the scatter), and a full
//     rescore scores every class against every node.
//   * beat_tail writes the packed (G + C, N + 1) readback directly: the
//     scan's counts (each rank's block into its columns, inf into column
//     N), then the lease budgets of every class slot off the scan's final
//     avail (clamped >= 0 before the division, capped at BUDGET_CAP, a
//     zero overflow column).  The budgets are spread over the card: a CTA
//     takes kClsBlock classes (a warp each) of kTailRows rows of one rank,
//     so a thread prices one (class, row) at a time instead of one row for
//     every class.  Each warp first compacts its class's positive request
//     columns into shared memory, each with its magic multiplier
//     (contract.cuh magic), so the division by the request is a
//     multiply-high: the dividend max(avail, 0) >= 0 and the divisor is >=
//     1, so fdiv floors exactly.  The same CTAs copy the counts block in a
//     grid-stride loop along the packed rows.  C more CTAs take the
//     per-class argmin of the carried keys over every rank as the min of
//     packed 64-bit (key, global row) values (contract.cuh): ties go to the
//     lowest row and an all-INF row gives 0, as jnp.argmin and the sharded
//     reference's pmin do.  That replaces the pmin2 and the two gathers,
//     so a sharded beat on one card makes no transport call.
//
// Exactness traps: the keys use the raw (possibly negative) avail and the
// resident mask, never mask_eff; only the budgets clamp avail and use
// mask_eff.  Padding lanes (row index outside [0, n_l), class index
// outside [0, C)) are dropped, never wrapped and never written.  Rank k's
// per-beat inputs are at rank 0's address plus k times a step (the staged
// upload holds one section a rank, so every input steps by the section);
// the residents come from a table of per-rank pointers that the wrapper
// builds once per layout.

#include <cuda_runtime.h>
#include <stdint.h>

#include "contract.cuh"

namespace {

using namespace rt;

constexpr int kTile = 256;               // node rows a CTA (beat_rows)
constexpr int kThreads = 256;
constexpr int kClsBlock = kThreads / 32; // classes a budget CTA, a warp each
constexpr int kTailRows = 64;            // node rows a budget CTA
constexpr int kColCap = 32;              // a class's compacted columns on chip
constexpr int kBudgetCap = 1 << 15;      // contract.BUDGET_CAP
constexpr int kModeBeat = 0;             // dirty rows; with eff, the beat
constexpr int kModeClasses = 1;          // install class rows, rescore them
constexpr int kModeRescore = 2;          // every class against every node

// One rank's residents and beat buffers, as the wrapper lays out its table
// (one int64 each)
struct RankRes {
  int* totals;           // (n_l, r)
  int* avail;            // (n_l, r)
  uint8_t* mask;         // (n_l,)
  int* keys;             // (c, n_l)
  int* reqs;             // (c, r): this rank's copy
  int* avail_eff;        // (n_l, r)
  uint8_t* mask_eff;     // (n_l,)
  int* group_reqs;       // (>= g, r)
  int* group_counts;     // (>= g,)
  unsigned* xchg;        // shard_scan's exchange area, or null
};

// beat_rows' per-call inputs: rank 0's pointer to each (null where the
// call has none) and the bytes from one rank's to the next's
enum Field {
  kIdx,         // (b,) local rows of the dirty lanes
  kRowsTotals,  // (b, r)
  kRowsAvail,   // (b, r)
  kRowsMask,    // (b,) bytes
  kOvIdx,       // (bo,) local rows of this beat's overrides
  kOvAvail,     // (bo, r)
  kExtraMask,   // (n_l,) bytes, or null: all true
  kSlots,       // (g,) class slots of the beat's groups
  kCounts,      // (g,)
  kClsIdx,      // (bc,) class slots to install
  kClsReqs,     // (bc, r)
  kFields
};

struct RowsArgs {
  const void* ptr[kFields];
  long long step[kFields];
  int s, n_l, r, c, b, bo, g, bc, thr_fp, xchg_ints, mode, eff;
};

// beat_tail's per-call arguments
struct TailArgs {
  const int* alloc;          // rank 0's (g, n_l) counts, rows alloc_row apart
  long long alloc_rank;      // bytes from one rank's alloc to the next's
  const int* inf;            // (g,) queued nowhere, inf_stride apart
  const int* av_fin;         // rank 0's (n_l, r) avail after the scan
  long long av_rank;         // bytes from one rank's av_fin to the next's
  int* packed;               // (g + c, s * n_l + 1)
  int* amin;                 // (c,)
  int alloc_row, inf_stride, s, n_l, r, c, g;
};

template <class T>
__device__ __forceinline__ T* at_rank(T* p, long long bytes, int k) {
  return p == nullptr ? p
                      : reinterpret_cast<T*>(
                            reinterpret_cast<uintptr_t>(p) + bytes * k);
}

// rank k's copy of input f
template <class T>
__device__ __forceinline__ const T* input(const RowsArgs& a, Field f, int k) {
  return at_rank(static_cast<const T*>(a.ptr[f]), a.step[f], k);
}

// hybrid_kernel._keys for one (request, row), over every column (only the
// positive ones enter): contract_key without the compaction
__device__ __forceinline__ int key_of(const int* t_row, const int* a_row,
                                      const int* q, int r, bool live,
                                      int thr_fp, int row) {
  bool feas = live, availb = true;
  int s = 0;
  for (int col = 0; col < r; ++col) {
    const int qc = q[col];
    if (qc <= 0) continue;
    const int t = t_row[col], a = a_row[col];
    feas = feas && (t >= qc);
    availb = availb && (a >= qc);
    const int num = wmul(wadd(wsub(t, a), qc), kScale);
    s = max(s, floordiv(num, max(t, 1)));
  }
  return pack_contract_key(feas, availb, s, thr_fp, row);
}

// hybrid_kernel._budgets for one (class, row): fill is >= 0 (avail
// clamped, requests >= 1), so the division floors
__device__ __forceinline__ int budget_of(const int* t_row, const int* a_row,
                                         const int* q, int r, bool live) {
  bool feas = live;
  int fill = kBudgetCap;
  for (int col = 0; col < r; ++col) {
    const int qc = q[col];
    if (qc <= 0) continue;
    feas = feas && (t_row[col] >= qc);
    fill = min(fill, max(a_row[col], 0) / qc);
  }
  return feas ? fill : 0;
}

__global__ void __launch_bounds__(kThreads)
beat_rows_kernel(const RankRes* __restrict__ tab, const RowsArgs a) {
  __shared__ int lanes[kTile], ov_lanes[kTile];
  __shared__ int n_lanes, n_ov;
  const int k = blockIdx.y, tid = threadIdx.x, nt = blockDim.x;
  const RankRes res = tab[k];
  const int r = a.r, n_l = a.n_l;
  const int lo = blockIdx.x * kTile, hi = min(lo + kTile, n_l);
  const int base_row = k * n_l;            // the global row of local row 0

  if (a.mode != kModeBeat) {
    const bool install = a.mode == kModeClasses;
    const int* cls_idx = input<int>(a, kClsIdx, k);
    const int* cls_reqs = input<int>(a, kClsReqs, k);
    if (install && blockIdx.x == 0) {      // this rank's copy of reqs
      for (int e = tid; e < a.bc * r; e += nt) {
        const int j = e / r, slot = cls_idx[j];
        if (slot >= 0 && slot < a.c) res.reqs[slot * r + e % r] = cls_reqs[e];
      }
    }
    const int n_cls = install ? a.bc : a.c;
    for (int row = lo + tid; row < hi; row += nt) {
      const int* t_row = res.totals + (long long)row * r;
      const int* a_row = res.avail + (long long)row * r;
      const bool live = res.mask[row] != 0;
      for (int j = 0; j < n_cls; ++j) {
        const int slot = install ? cls_idx[j] : j;
        if (slot < 0 || slot >= a.c) continue;          // padding lane
        const int* q = install ? cls_reqs + j * r : res.reqs + slot * r;
        res.keys[(long long)slot * n_l + row] =
            key_of(t_row, a_row, q, r, live, a.thr_fp, base_row + row);
      }
    }
    return;
  }

  const int* idx = input<int>(a, kIdx, k);
  const int* ov_idx = input<int>(a, kOvIdx, k);
  if (tid == 0) n_lanes = n_ov = 0;
  __syncthreads();
  for (int j = tid; j < a.b; j += nt) {    // the dirty lanes in this tile
    const int row = idx[j];
    if (row >= lo && row < hi) {
      const int p = atomicAdd(&n_lanes, 1);
      if (p < kTile) lanes[p] = j;
    }
  }
  if (a.eff) {
    for (int j = tid; j < a.bo; j += nt) {
      const int row = ov_idx[j];
      if (row >= lo && row < hi) {
        const int p = atomicAdd(&n_ov, 1);
        if (p < kTile) ov_lanes[p] = j;
      }
    }
  }
  __syncthreads();
  const int nl = min(n_lanes, kTile), no = min(n_ov, kTile);

  // the dirty rows into the resident mirror, in place
  {
    const int* rt = input<int>(a, kRowsTotals, k);
    const int* ra = input<int>(a, kRowsAvail, k);
    const uint8_t* rm = input<uint8_t>(a, kRowsMask, k);
    for (int e = tid; e < nl * r; e += nt) {
      const int j = lanes[e / r], col = e % r;
      const long long at = (long long)idx[j] * r + col;
      res.totals[at] = rt[j * r + col];
      res.avail[at] = ra[j * r + col];
    }
    for (int e = tid; e < nl; e += nt) {
      const int j = lanes[e];
      res.mask[idx[j]] = rm[j] != 0;
    }
  }
  __syncthreads();

  // their key columns against every class, off the raw avail and the
  // resident mask
  for (int e = tid; e < a.c * nl; e += nt) {
    const int slot = e / nl, row = idx[lanes[e % nl]];
    res.keys[(long long)slot * n_l + row] =
        key_of(res.totals + (long long)row * r, res.avail + (long long)row * r,
               res.reqs + slot * r, r, res.mask[row] != 0, a.thr_fp,
               base_row + row);
  }
  if (!a.eff) return;

  // this beat's avail_eff and mask_eff for the tile
  const uint8_t* em = input<uint8_t>(a, kExtraMask, k);
  for (long long e = (long long)lo * r + tid; e < (long long)hi * r; e += nt)
    res.avail_eff[e] = res.avail[e];
  for (int row = lo + tid; row < hi; row += nt)
    res.mask_eff[row] = res.mask[row] != 0 && (em == nullptr || em[row] != 0);
  __syncthreads();
  {
    const int* ova = input<int>(a, kOvAvail, k);
    for (int e = tid; e < no * r; e += nt) {
      const int j = ov_lanes[e / r], col = e % r;
      res.avail_eff[(long long)ov_idx[j] * r + col] = ova[j * r + col];
    }
  }

  if (blockIdx.x == 0) {                   // the rank's scan inputs
    const int* slots = input<int>(a, kSlots, k);
    const int* counts = input<int>(a, kCounts, k);
    for (int e = tid; e < a.g * r; e += nt) {
      const int gi = e / r, slot = min(max(slots[gi], 0), a.c - 1);
      res.group_reqs[e] = res.reqs[slot * r + e % r];
    }
    for (int gi = tid; gi < a.g; gi += nt) res.group_counts[gi] = counts[gi];
    if (res.xchg != nullptr)
      for (int e = tid; e < a.xchg_ints; e += nt) res.xchg[e] = 0u;
  }
}

// One class's positive request columns, compacted by its warp: column,
// request and the request's magic multiplier and shift
struct TailCls {
  int col[kColCap], q[kColCap];
  unsigned m[kColCap], sh[kColCap];
};

// CTAs [0, c) take one class's argmin each; the rest are budget CTAs, by
// (rank, row tile, class block), which also copy the counts block.
__global__ void __launch_bounds__(kThreads)
beat_tail_kernel(const RankRes* __restrict__ tab, const TailArgs a) {
  __shared__ unsigned long long part[1][32];
  __shared__ TailCls cls_sh[kClsBlock];
  const int tid = threadIdx.x, nt = blockDim.x, r = a.r;
  const int lane = tid & 31, warp = tid >> 5;
  const long long ld = (long long)a.s * a.n_l + 1;   // packed's row length

  if ((int)blockIdx.x < a.c) {             // the argmin of one class
    const int cls = blockIdx.x;
    unsigned long long m[1] = {kNoKey};
    for (int k = 0; k < a.s; ++k) {
      const int* keys = tab[k].keys + (long long)cls * a.n_l;
      for (int j = tid; j < a.n_l; j += nt) {
        const unsigned long long v = pack_key(keys[j], k * a.n_l + j);
        m[0] = v < m[0] ? v : m[0];
      }
    }
    block_min<1>(m, part);
    if (tid == 0) a.amin[cls] = packed_row(m[0]);
    return;
  }

  // the counts block, along the packed rows: column k * n_l + row of row
  // gi is rank k's alloc[gi][row]
  const int b = blockIdx.x - a.c, nb = gridDim.x - a.c;
  const unsigned n = (unsigned)(a.s * a.n_l), nl = (unsigned)a.n_l;
  for (unsigned e = (unsigned)(b * nt + tid); e < (unsigned)a.g * n;
       e += (unsigned)(nb * nt)) {        // the host keeps the packed
    const unsigned gi = e / n, col = e - gi * n;     // rows below 2**31
    const unsigned k = col / nl, row = col - k * nl;
    const int* alloc = at_rank(a.alloc, a.alloc_rank, (int)k);
    a.packed[gi * ld + col] = alloc[(long long)gi * a.alloc_row + row];
  }
  if (b == 0) {                            // the overflow column
    for (int gi = tid; gi < a.g; gi += nt)
      a.packed[gi * ld + ld - 1] = a.inf[(long long)gi * a.inf_stride];
    for (int cls = tid; cls < a.c; cls += nt)
      a.packed[(a.g + cls) * ld + ld - 1] = 0;
  }

  // the budgets of this warp's class over the CTA's rows of one rank
  const int tiles = (a.n_l + kTailRows - 1) / kTailRows;
  const int blocks = (a.c + kClsBlock - 1) / kClsBlock;
  const int k = b / (tiles * blocks), rest = b % (tiles * blocks);
  const int lo = (rest / blocks) * kTailRows;
  const int hi = min(lo + kTailRows, a.n_l);
  const int cls = (rest % blocks) * kClsBlock + warp;
  if (cls >= a.c) return;                  // past the last class
  const RankRes res = tab[k];
  const int* req = res.reqs + (long long)cls * r;
  TailCls& cs = cls_sh[warp];
  int npos = 0;
  for (int c0 = 0; c0 < r; c0 += 32) {
    const int c = c0 + lane;
    const int q = c < r ? req[c] : 0;
    const unsigned pos = __ballot_sync(kFull, q > 0);
    const int at = npos + __popc(pos & ((1u << lane) - 1u));
    if (q > 0 && at < kColCap) {
      const uint2 mg = magic(q);
      cs.col[at] = c;
      cs.q[at] = q;
      cs.m[at] = mg.x;
      cs.sh[at] = mg.y;
    }
    npos += __popc(pos);
  }
  __syncwarp();
  const int* av_fin = at_rank(a.av_fin, a.av_rank, k);
  int* out = a.packed + (a.g + cls) * ld + (long long)k * a.n_l;
  for (int row = lo + lane; row < hi; row += 32) {
    const int* t_row = res.totals + (long long)row * r;
    const int* a_row = av_fin + (long long)row * r;
    const bool live = res.mask_eff[row] != 0;
    int budget;
    if (npos <= kColCap) {
      bool feas = live;
      int fill = kBudgetCap;
      for (int p = 0; p < npos; ++p) {
        const int c = cs.col[p];
        feas = feas && (t_row[c] >= cs.q[p]);
        fill = min(fill, fdiv(max(a_row[c], 0), cs.m[p], cs.sh[p]));
      }
      budget = feas ? fill : 0;
    } else {                               // more columns than the cap
      budget = budget_of(t_row, a_row, req, r, live);
    }
    out[row] = budget;
  }
}

bool rows_args_ok(const RowsArgs& a) {
  return a.s >= 1 && a.n_l >= 1 && a.r >= 1 && a.c >= 1 && a.b >= 0 &&
         a.bo >= 0 && a.g >= 0 && a.bc >= 0 && a.xchg_ints >= 0 &&
         a.mode >= kModeBeat && a.mode <= kModeRescore && a.s <= 65535;
}

}  // namespace

// layout[0..2]: CTAs, threads a CTA, node rows a CTA
extern "C" int rt_beat_rows(const void* table, const void* args, int* layout,
                            void* stream) {
  const RowsArgs& a = *static_cast<const RowsArgs*>(args);
  if (!rows_args_ok(a)) return (int)cudaErrorInvalidValue;
  const dim3 grid((a.n_l + kTile - 1) / kTile, a.s, 1);
  layout[0] = (int)(grid.x * grid.y);
  layout[1] = kThreads;
  layout[2] = kTile;
  beat_rows_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const RankRes*>(table), a);
  return (int)cudaGetLastError();
}

// layout[0..4]: CTAs, threads a CTA, node rows a budget CTA, classes a
// budget CTA, argmin CTAs
extern "C" int rt_beat_tail(const void* table, const void* args, int* layout,
                            void* stream) {
  const TailArgs& a = *static_cast<const TailArgs*>(args);
  if (a.s < 1 || a.n_l < 1 || a.r < 1 || a.c < 1 || a.g < 0)
    return (int)cudaErrorInvalidValue;
  const long long blocks =
      (long long)a.s * ((a.n_l + kTailRows - 1) / kTailRows) *
          ((a.c + kClsBlock - 1) / kClsBlock) + a.c;
  if (blocks > 0x7fffffffLL ||
      (long long)(a.g + a.c) * ((long long)a.s * a.n_l + 1) > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  layout[0] = (int)blocks;
  layout[1] = kThreads;
  layout[2] = kTailRows;
  layout[3] = kClsBlock;
  layout[4] = a.c;
  beat_tail_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const RankRes*>(table), a);
  return (int)cudaGetLastError();
}
