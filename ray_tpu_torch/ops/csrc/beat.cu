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
// resources x 32 class slots, 12 dirty rows) the two kernels move ~0.9 MB
// (the budgets' (C, N+1) rows, the keys read once for the argmin, avail
// copied into avail_eff) and do ~2.2 M int32 operations
// (chip_smoke.py beat_rest_work): a bound of a few tenths of a
// microsecond.  The time is the launches and their latency, not the work.
// Eager PyTorch spends ~85 launches on it; the design is to make it two
// launches whatever S is, with no grid-wide barrier and no host sync, and
// to spread each launch over the card so that no CTA runs a chain of
// dependent phases:
//
//   * Every step is node-local except the group gather and the argmin.
//     The beat call of beat_rows (beat_rows_kernel) runs three kinds of
//     CTA side by side, none waiting on another's stores: a gather CTA a
//     rank (group_reqs = reqs[clamp(slots)], the group counts, the rank's
//     shard_scan exchange area zeroed, so the scan's table of pointers
//     stays valid from beat to beat and no memset is launched); lane CTAs
//     of kLanes dirty lanes (a warp each) that store the dirty row into
//     the resident totals / avail / mask and score its key column against
//     every class (a lane a class; the low bits the global row, rank * n_l
//     + row) from the staged row, never from the residents they write;
//     and eff CTAs of kEffRows rows that write avail_eff (this beat's
//     override where the row has one, else the dirty row's new avail, else
//     the resident's: a per-tile lookup built in shared memory) and
//     mask_eff = (new or resident mask) & extra_mask.  The host's dirty
//     rows are unique, as its overrides are, so no two lanes write one row.
//   * The class install and the full rescore (beat_rows_keys_kernel) run
//     a CTA per (rank, tile of kKeyRows rows, block of classes): a warp a
//     class, or pw classes a warp where one class a warp would take more
//     than a wave of the card (keys_per_warp: the contract's 8192 rows x
//     128 classes is 4,096 such CTAs, 512 with pw = 8).  A CTA stages its
//     rows' totals and avail on chip with each column's divisor as a magic
//     multiplier (magic_of: one per (row, column), not one division per
//     (class, row, column)), compacts each class's positive request
//     columns (a warp its classes, from columns it loaded up front), and
//     scores a (class, row) a thread with contract_key_rcp, writing the
//     keys along rows (coalesced).  A row wider than kRowCols columns is
//     not staged: its keys take the division in the same kernel.  The
//     install scatters its B request rows into each rank's copy of reqs
//     (the row tile 0 CTAs) and scores those slots from the staged
//     requests, so no CTA waits for the scatter; padding slots (>= C) are
//     dropped.
//   * What is left at the beat cell is latency: each of these CTAs reads
//     its rank's pointers from the table, then its data, in two dependent
//     trips to memory, and then writes; a call takes ~3.3 us of device
//     time beside an empty kernel's ~0.8 (PERF.md).  At 8192 x 16
//     x 128 the rescore is bound by the key arithmetic's instructions.
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
// resident mask (the dirty row's new one), never the eff buffers; only
// the budgets clamp avail and use mask_eff.  Overrides apply after the
// dirty rows.  Padding lanes (row index outside [0, n_l), class index
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

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// beat_rows' beat call: dirty lanes a lane CTA (a warp each), node rows an
// eff CTA; the install and the rescore: node rows and classes a CTA (a
// lane a row, a warp a class), resource columns staged on chip a row
constexpr int kLanes = kWarps;
constexpr int kEffRows = 64;
constexpr int kKeyRows = 32;
constexpr int kKeyCls = kWarps;
constexpr int kRowCols = 128;
constexpr int kKeyPitch = kKeyRows + 1;  // a staged column's words
constexpr int kReqCap = 4096;            // requests (C x R) staged on chip
constexpr int kPre = 4;                  // elements a thread loads up front
constexpr int kMaxPerWarp = 8;           // classes a warp of a key CTA
constexpr int kKeyWave = 4 * 132;        // key CTAs in one wave: 4 an SM
                                         // (their registers), 132 SMs
constexpr int kKeySmemCap = 96 * 1024;   // a key CTA's dynamic shared memory
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

// magic(d).x for a divisor d >= 1 (contract.cuh), from a double
// quotient corrected in integers: 2**s / d < 2**32 with s = 31 +
// ceil(log2 d), so the correctly rounded quotient floors to q or q + 1
// of the true floor q; one 64-bit product finds which.  The same word,
// with no 64-bit division (tests/test_torch_beat_rest.py holds the two
// equal at every divisor's edges).
__device__ __forceinline__ unsigned magic_of(int d) {
  const unsigned s = 63u - (unsigned)__clz(d - 1);
  const unsigned long long p = 1ull << s;
  unsigned long long q =
      __double2ull_rz(__ull2double_rn(p) / (double)d);
  if (q * (unsigned long long)d > p) --q;
  return (unsigned)(q + (q * (unsigned long long)d != p));
}

// key_of with each division by a magic multiplier, over a row's columns
// staged at t[c * pitch], a[c * pitch], m[c * pitch]
__device__ __forceinline__ int key_rcp(const int* t, const int* a,
                                       const unsigned* m, int pitch,
                                       const int* col, const int* q,
                                       int npos, bool live, int thr_fp,
                                       int row) {
  return contract_key_rcp(
      [&](int p, int& tc, int& ac, unsigned& mc, int& qc) {
        const int c = col[p] * pitch;
        tc = t[c];
        ac = a[c];
        mc = m[c];
        qc = q[p];
      },
      npos, live, thr_fp, row);
}

// The beat call: CTA 0 of a rank gathers the scan's classes, the next
// ceil(b / kLanes) take kLanes dirty lanes each, the rest (with eff) write
// kEffRows rows of avail_eff and mask_eff each.  blockIdx.y is the rank.
// Each CTA issues the loads it needs in one wave before its first use
// (the requests staged on chip where C x R fits kReqCap, the first kPre
// elements of a thread in registers), so its chain is one round trip to
// memory, not one a phase.
__global__ void __launch_bounds__(kThreads)
beat_rows_kernel(const RankRes* __restrict__ tab, const RowsArgs a) {
  __shared__ int req_sh[kReqCap];
  __shared__ int st_t[kWarps][kRowCols], st_a[kWarps][kRowCols];
  __shared__ unsigned st_m[kWarps][kRowCols];
  __shared__ int dirty_of[kEffRows], ov_of[kEffRows];
  const int k = blockIdx.y, tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5;
  const RankRes res = tab[k];
  const int r = a.r, n_l = a.n_l;
  const int lane_ctas = (a.b + kLanes - 1) / kLanes;
  const bool reqs_on_chip = a.c * r <= kReqCap;
  const int* idx = input<int>(a, kIdx, k);

  if (blockIdx.x == 0) {                   // the rank's scan inputs
    if (!a.eff) return;
    const int* slots = input<int>(a, kSlots, k);
    const int* counts = input<int>(a, kCounts, k);
    const int n = a.g * r;
    int slot[kPre];
#pragma unroll
    for (int i = 0; i < kPre; ++i) {
      const int e = tid + i * kThreads;
      slot[i] = e < n ? min(max(slots[e / r], 0), a.c - 1) : 0;
    }
    if (reqs_on_chip)
      for (int e = tid; e < a.c * r; e += nt) req_sh[e] = res.reqs[e];
    for (int gi = tid; gi < a.g; gi += nt) res.group_counts[gi] = counts[gi];
    if (res.xchg != nullptr)
      for (int e = tid; e < a.xchg_ints; e += nt) res.xchg[e] = 0u;
    __syncthreads();
    const int* q = reqs_on_chip ? req_sh : res.reqs;
#pragma unroll
    for (int i = 0; i < kPre; ++i) {
      const int e = tid + i * kThreads;
      if (e < n) res.group_reqs[e] = q[slot[i] * r + e % r];
    }
    for (int e = tid + kPre * kThreads; e < n; e += nt) {
      const int s = min(max(slots[e / r], 0), a.c - 1);
      res.group_reqs[e] = q[s * r + e % r];
    }
    return;
  }

  if ((int)blockIdx.x <= lane_ctas) {      // kLanes dirty lanes, a warp each
    const int j = (blockIdx.x - 1) * kLanes + warp;
    const bool mine = j < a.b;
    const int* rt = input<int>(a, kRowsTotals, k) + (long long)j * r;
    const int* ra = input<int>(a, kRowsAvail, k) + (long long)j * r;
    const int row = mine ? idx[j] : -1;
    const bool live = mine && input<uint8_t>(a, kRowsMask, k)[j] != 0;
    const int t0 = mine && lane < r ? rt[lane] : 0;   // the first 32
    const int a0 = mine && lane < r ? ra[lane] : 0;   // columns, up front
    const bool staged = r <= kRowCols;
    if (reqs_on_chip)
      for (int e = tid; e < a.c * r; e += nt) req_sh[e] = res.reqs[e];
    const bool on = mine && row >= 0 && row < n_l;    // else a padding lane
    for (int col = lane; mine && col < r; col += 32) {
      const int t = col < 32 ? t0 : rt[col], av = col < 32 ? a0 : ra[col];
      if (on) {
        res.totals[(long long)row * r + col] = t;
        res.avail[(long long)row * r + col] = av;
      }
      if (staged) {
        st_t[warp][col] = t;
        st_a[warp][col] = av;
        st_m[warp][col] = magic_of(max(t, 1));
      }
    }
    if (on && lane == 0) res.mask[row] = live;
    __syncthreads();
    if (!on) return;
    // the row's key column against every class, from the staged row: the
    // raw avail and the new mask
    for (int cls = lane; cls < a.c; cls += 32) {
      const int* q = (reqs_on_chip ? req_sh : res.reqs) + cls * r;
      int key;
      if (staged) {
        bool feas = live, availb = true;
        int s = 0;
        for (int col = 0; col < r; ++col) {
          const int qc = q[col];
          if (qc <= 0) continue;
          const int t = st_t[warp][col], av = st_a[warp][col];
          feas = feas && (t >= qc);
          availb = availb && (av >= qc);
          const int num = wmul(wadd(wsub(t, av), qc), kScale);
          const unsigned sh = 63u - (unsigned)__clz(max(t, 1) - 1);
          s = max(s, fdiv(num, st_m[warp][col], sh));
        }
        key = pack_contract_key(feas, availb, s, a.thr_fp, k * n_l + row);
      } else {
        key = key_of(rt, ra, q, r, live, a.thr_fp, k * n_l + row);
      }
      res.keys[(long long)cls * n_l + row] = key;
    }
    return;
  }

  // kEffRows rows of avail_eff and mask_eff: the override, else the dirty
  // row's new avail, else the resident's (rows no lane CTA writes).  The
  // rank's dirty and override rows come on chip with the first wave where
  // they fit kReqCap (req_sh: this CTA stages no requests).
  const int lo = (blockIdx.x - 1 - lane_ctas) * kEffRows;
  const int rows = min(kEffRows, n_l - lo), n = rows * r;
  const int* ov_idx = input<int>(a, kOvIdx, k);
  const uint8_t* rm = input<uint8_t>(a, kRowsMask, k);
  const uint8_t* em = input<uint8_t>(a, kExtraMask, k);
  const int* ra = input<int>(a, kRowsAvail, k);
  const int* ova = input<int>(a, kOvAvail, k);
  if ((a.b + a.bo) * r <= kReqCap) {
    for (int e = tid; e < a.b * r; e += nt) req_sh[e] = ra[e];
    for (int e = tid; e < a.bo * r; e += nt) req_sh[a.b * r + e] = ova[e];
    ra = req_sh;
    ova = req_sh + a.b * r;
  }
  const int* av_tile = res.avail + (long long)lo * r;
  int* eff_tile = res.avail_eff + (long long)lo * r;
  if (tid < kEffRows) dirty_of[tid] = ov_of[tid] = -1;
  const int drow = tid < a.b ? idx[tid] : -1;
  const int orow = tid < a.bo ? ov_idx[tid] : -1;
  const bool dlive = tid < a.b && rm[tid] != 0;
  int pre[kPre];
#pragma unroll
  for (int i = 0; i < kPre; ++i) {
    const int e = tid + i * kThreads;
    pre[i] = e < n ? av_tile[e] : 0;
  }
  const bool live = tid < rows && res.mask[lo + tid] != 0;
  const bool soft = tid < rows && (em == nullptr || em[lo + tid] != 0);
  __syncthreads();
  for (int j = tid; j < max(a.b, a.bo); j += nt) {
    const int row = j == tid ? drow : j < a.b ? idx[j] : -1;
    const int orw = j == tid ? orow : j < a.bo ? ov_idx[j] : -1;
    if (row >= lo && row < lo + rows) {          // the lane and its mask
      dirty_of[row - lo] = 2 * j + (j == tid ? dlive : rm[j] != 0);
    }
    if (orw >= lo && orw < lo + rows) ov_of[orw - lo] = j;
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kPre; ++i) {
    const int e = tid + i * kThreads;
    if (e >= n) break;
    const int rl = e / r, col = e - rl * r;
    const int o = ov_of[rl], d = dirty_of[rl] >> 1;
    eff_tile[e] = o >= 0 ? ova[(long long)o * r + col]
                : d >= 0 ? ra[(long long)d * r + col] : pre[i];
  }
  for (int e = tid + kPre * kThreads; e < n; e += nt) {
    const int rl = e / r, col = e - rl * r;
    const int o = ov_of[rl], d = dirty_of[rl] >> 1;
    eff_tile[e] = o >= 0 ? ova[(long long)o * r + col]
                : d >= 0 ? ra[(long long)d * r + col] : av_tile[e];
  }
  if (tid < rows) {
    const int d = dirty_of[tid];
    res.mask_eff[lo + tid] = (d >= 0 ? (d & 1) != 0 : live) && soft;
  }
}

// Classes a warp of a key CTA takes: one while one CTA a (rank, row tile,
// block of kKeyCls classes) fits one wave (kKeyWave CTAs), else as many as
// bring the grid to a wave (at most kMaxPerWarp, and the CTA's shared
// memory under kKeySmemCap).  The kernel and its launch both call it.
__host__ __device__ inline int keys_per_warp(int s, int n_l, int n_cls,
                                             int r) {
  const long long base = (long long)s * ((n_l + kKeyRows - 1) / kKeyRows) *
                         ((n_cls + kKeyCls - 1) / kKeyCls);
  int pw = (int)((base + kKeyWave - 1) / kKeyWave);
  pw = pw < 1 ? 1 : pw > kMaxPerWarp ? kMaxPerWarp : pw;
  const int cols = r <= kRowCols ? r : 0;
  while (pw > 1 && (3 * kKeyPitch + 2 * kKeyCls * pw) * cols *
                           (int)sizeof(int) > kKeySmemCap)
    --pw;
  return pw;
}

// The class install and the full rescore: CTA (rank, row tile, block of
// kKeyCls * pw classes), block fastest; warp w takes classes w, w + kKeyCls,
// ... of its block.  Shared memory: the tile's staged columns (t, a, magic
// multiplier; kKeyPitch words a column) when r <= kRowCols, then each
// (warp, class) list of positive columns.  One wave of loads: the rows'
// columns and the first 32 request columns of each class, before any use.
// kPW bounds pw at compile time (1, 2, 4 or 8: the launch takes the least
// that holds it), so a warp of one class carries no registers for eight.
template <int kPW>
__global__ void __launch_bounds__(kThreads)
beat_rows_keys_kernel(const RankRes* __restrict__ tab, const RowsArgs a) {
  extern __shared__ int smem[];
  __shared__ int npos_sh[kKeyCls][kPW];
  __shared__ bool live_sh[kKeyRows];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int r = a.r, n_l = a.n_l;
  const bool install = a.mode == kModeClasses;
  const int n_cls = install ? a.bc : a.c;
  const int pw = keys_per_warp(a.s, n_l, n_cls, r);
  const int per_cta = kKeyCls * pw;
  const int blocks = (n_cls + per_cta - 1) / per_cta;
  const int tiles = (n_l + kKeyRows - 1) / kKeyRows;
  const int k = blockIdx.x / (tiles * blocks);
  const int rest = blockIdx.x - k * tiles * blocks;
  const int tile = rest / blocks, j0 = (rest - tile * blocks) * per_cta;
  const int lo = tile * kKeyRows, rows = min(kKeyRows, n_l - lo);
  const RankRes res = tab[k];
  const bool staged = r <= kRowCols;
  const int cols = staged ? r : 0;
  int* st_t = smem;
  int* st_a = st_t + cols * kKeyPitch;
  unsigned* st_m = reinterpret_cast<unsigned*>(st_a + cols * kKeyPitch);
  int* lists = reinterpret_cast<int*>(st_m + cols * kKeyPitch) +
               warp * pw * 2 * cols;                 // (col, q) a class

  // this warp's classes: slots and request rows (the install reads the
  // staged rows, never the reqs it scatters into) and their first 32
  // columns, loaded up front
  const int* cls_idx = input<int>(a, kClsIdx, k);
  const int* cls_reqs = input<int>(a, kClsReqs, k);
  int slot[kPW], v0[kPW];
#pragma unroll
  for (int i = 0; i < kPW; ++i) {
    const int j = j0 + warp + i * kKeyCls;
    slot[i] = -1;
    v0[i] = 0;
    if (i < pw && j < n_cls) {                     // both loads at once
      slot[i] = install ? cls_idx[j] : j;
      if (lane < r)
        v0[i] = install ? cls_reqs[(long long)j * r + lane]
                        : res.reqs[(long long)j * r + lane];
    }
    if (slot[i] >= a.c) slot[i] = -1;              // a padding lane
  }

  // the tile's rows on chip, a magic multiplier a (row, column)
  for (int e = tid; e < rows * cols; e += kThreads) {
    const int rl = e / cols, col = e - rl * cols;
    const long long at = (long long)(lo + rl) * r + col;
    const int t = res.totals[at];
    st_t[col * kKeyPitch + rl] = t;
    st_a[col * kKeyPitch + rl] = res.avail[at];
    st_m[col * kKeyPitch + rl] = magic_of(max(t, 1));
  }
  if (tid < rows) live_sh[tid] = res.mask[lo + tid] != 0;

  // each class's positive columns, compacted by its warp; the install's
  // rows into this rank's reqs from the row tile 0 CTAs
#pragma unroll
  for (int i = 0; i < kPW; ++i) {
    if (slot[i] < 0) continue;                     // warp-uniform
    const int j = j0 + warp + i * kKeyCls;
    const int* q = install ? cls_reqs + (long long)j * r
                           : res.reqs + (long long)slot[i] * r;
    if (install && tile == 0)
      for (int col = lane; col < r; col += 32)
        res.reqs[slot[i] * r + col] = col < 32 ? v0[i] : q[col];
    if (!staged) continue;
    int* lc = lists + i * 2 * cols;
    int np = 0;
    for (int c0 = 0; c0 < r; c0 += 32) {
      const int c = c0 + lane;
      const int v = c0 == 0 ? v0[i] : c < r ? q[c] : 0;
      const unsigned pos = __ballot_sync(kFull, v > 0);
      if (v > 0) {
        const int at = np + __popc(pos & ((1u << lane) - 1u));
        lc[at] = c;
        lc[cols + at] = v;
      }
      np += __popc(pos);
    }
    if (lane == 0) npos_sh[warp][i] = np;
  }
  __syncthreads();
  if (lane >= rows) return;
  const int row = lo + lane, grow = k * n_l + row;
#pragma unroll
  for (int i = 0; i < kPW; ++i) {
    if (slot[i] < 0) continue;
    int key;
    if (staged) {
      const int* lc = lists + i * 2 * cols;
      key = key_rcp(st_t + lane, st_a + lane, st_m + lane, kKeyPitch, lc,
                    lc + cols, npos_sh[warp][i], live_sh[lane], a.thr_fp,
                    grow);
    } else {
      const int j = j0 + warp + i * kKeyCls;
      const int* q = install ? cls_reqs + (long long)j * r
                             : res.reqs + (long long)slot[i] * r;
      key = key_of(res.totals + (long long)row * r,
                   res.avail + (long long)row * r, q, r, live_sh[lane],
                   a.thr_fp, grow);
    }
    res.keys[(long long)slot[i] * n_l + row] = key;
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

// The shared memory of a beat_rows_keys_kernel CTA past its static part
size_t keys_smem(int r, int pw) {
  const int cols = r <= kRowCols ? r : 0;
  return (size_t)cols * (3 * kKeyPitch + 2 * kKeyCls * pw) * sizeof(int);
}

}  // namespace

// layout[0..7]: CTAs, threads a CTA, node rows a tile (an eff CTA's, or a
// key CTA's), classes a key CTA, gather CTAs, lane CTAs, tile CTAs,
// resource columns staged a row (0: the keys take the division)
extern "C" int rt_beat_rows(const void* table, const void* args, int* layout,
                            void* stream) {
  const RowsArgs& a = *static_cast<const RowsArgs*>(args);
  if (!rows_args_ok(a)) return (int)cudaErrorInvalidValue;
  const RankRes* tab = static_cast<const RankRes*>(table);
  cudaStream_t st = (cudaStream_t)stream;
  for (int i = 0; i < 8; ++i) layout[i] = 0;
  layout[1] = kThreads;
  layout[7] = a.r <= kRowCols ? a.r : 0;
  if (a.mode == kModeBeat) {
    const int lanes = (a.b + kLanes - 1) / kLanes;
    const int tiles = a.eff ? (a.n_l + kEffRows - 1) / kEffRows : 0;
    const dim3 grid(1 + lanes + tiles, a.s, 1);
    layout[0] = (int)(grid.x * grid.y);
    layout[2] = kEffRows;
    layout[4] = a.s;
    layout[5] = lanes * a.s;
    layout[6] = tiles * a.s;
    beat_rows_kernel<<<grid, kThreads, 0, st>>>(tab, a);
    return (int)cudaGetLastError();
  }
  const int n_cls = a.mode == kModeClasses ? a.bc : a.c;
  const int pw = keys_per_warp(a.s, a.n_l, n_cls, a.r);
  const long long blocks =
      (long long)a.s * ((a.n_l + kKeyRows - 1) / kKeyRows) *
      ((n_cls + kKeyCls * pw - 1) / (kKeyCls * pw));
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  layout[0] = (int)blocks;
  layout[2] = kKeyRows;
  layout[3] = kKeyCls * pw;
  layout[6] = (int)blocks;
  if (blocks == 0) return (int)cudaSuccess;  // an install of no classes
  const size_t smem = keys_smem(a.r, pw);
  auto kernel = pw <= 1 ? beat_rows_keys_kernel<1>
              : pw <= 2 ? beat_rows_keys_kernel<2>
              : pw <= 4 ? beat_rows_keys_kernel<4>
                        : beat_rows_keys_kernel<kMaxPerWarp>;
  if (smem > 48 * 1024) {                  // past 48 KB needs the opt-in
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<(unsigned)blocks, kThreads, smem, st>>>(tab, a);
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
