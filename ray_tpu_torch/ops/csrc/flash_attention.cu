// Flash attention, by hand for Hopper (sm_90a).
//
// Replaces: ray_tpu/ops/flash_attention.py::flash_attention, the Pallas
// TPU kernel (its pallas_call body: online softmax with (m, l, acc) in
// f32 scratch over a (B*H, T/BQ, T/BK) grid whose key axis runs in order).
//
// What bounds it on this card: operations.  softmax(QK^T/sqrt(d)) V does
// 4*B*H*T^2*D flops (half of that causal) on 4*B*T*H*D elements, far
// above the H100's ~295 flop/byte ridge at the sizes it is used at, so
// the tensor cores are the limit, and only wgmma reaches their full rate:
// 989 TFLOP/s for 16-bit inputs; f32 runs each product as three TF32
// products at 495 TFLOP/s, so at most 165 TFLOP/s of f32-accurate work
// (the f32 FMA units would give 67).
//
// Routes, by dtype and kernel width D (the wrapper pads any other head
// dim with zeros to the next width: 64, 128, 256, then multiples of 64);
// rt_flash_route names the route of a (D, dtype), rt_flash_key_tile its
// key tile:
//
//   f16, bf16   D = 64, 128      flash_wgmma_kernel      (wgmma + TMA)
//               D = 256 .. 512   flash_big16_kernel      (wgmma + TMA)
//               D > 512          flash_scores16_kernel,  (wgmma + TMA, two
//                                then                     passes over a
//                                flash_values16_kernel    score scratch)
//   f32         D = 64 .. 512    flash_tf32_kernel       (split-TF32
//                                                         wgmma + TMA)
//               D > 512          flash_scores32_kernel,  (split TF32, two
//                                then                     passes over a
//                                flash_values32_kernel    score scratch)
//
// The one-pass routes keep S on chip (O(T) memory); past 512 (kReach) S
// goes through a scratch in device memory of at most the larger of
// kScratchCap (256 MiB) and one 128-row query block's scores (512 T
// bytes, past the cap only at T past 2**19), whatever B and H are, so
// still O(T): the wrapper allocates it and the entry point walks the
// query blocks in chunks whose scores fit it (one block a chunk where
// one passes the cap).  Both dtypes share the plan and the scratch's
// layout (S in f32).
//
// 16-bit inputs, the one-pass kernels:
//   * One CTA per (b*h, query tile), on
//     gridDim.x with the query tiles in reverse order, so under causal
//     masking the heaviest tiles start first.  Three warpgroups: two consumers and a producer warpgroup of
//     which one thread issues every copy; setmaxnreg moves registers from
//     the producer (24) to the consumers (240).
//   * Copies: TMA over 4-d tensor maps built on the public (B, T, H, D)
//     layout itself (dims D, H, T, B), so there is no transpose copy and
//     the zero fill past T covers a ragged last tile.  A box is 64
//     elements (128 bytes, the 128-byte swizzle wgmma reads) by 1 by rows
//     by 1; a width of D takes D/64 boxes.  Q is loaded once; K and V go
//     through a two-stage ring guarded by mbarriers (full: TMA bytes
//     landed; empty: all 256 consumer threads done), with separate K and
//     V barriers so S = Q K^T starts while V is still in flight.  Nothing
//     is widened to f32 in shared memory.
//   * Products: S = Q K^T is m64nBNk16 wgmma with both operands K-major
//     in shared memory; O += P V is wgmma with P in registers (the S
//     accumulator's fragment, rounded to 16 bits in place, is the
//     A-register fragment of the next product) and V (key, d) read
//     MN-major through the transpose flag.  Both accumulate in f32
//     registers, and S is computed once per (query tile, key tile).
//   * Softmax on the accumulator registers: a row lives on the four lanes
//     of a quad, so the row max is two shuffles; m and the per-thread
//     partial l stay in registers (l is summed over the quad once, at the
//     end); O is rescaled in registers by exp(m_prev - m_new).  Scores
//     are kept in log2 units (log2(e) folded into the scale) and
//     exponentiated by the hardware ex2.approx.ftz (relative error about
//     2**-22, far below the 16-bit rounding of p; the full-precision
//     exp2f was slower, PERF.md);
//     p is zeroed where the score is not finite, and the output is
//     acc / max(l, 1e-30), as the Pallas kernel.  Masking runs only on a
//     tile that crosses the diagonal or the end of the sequence; tiles
//     past the diagonal are never loaded.
//
// flash_wgmma_kernel, D = 64 and 128: 128 query rows, 64 a consumer; key
//   tiles of 128.  At D = 128 a consumer thread holds 64 S + 64 O
//   accumulators + 32 packed P registers.
//
// flash_big16_kernel, D = 256 .. 512.  O takes D/2 f32 registers a
// thread for 64 rows (128 at D = 256, 256 at 512) against the consumers'
// 240, so past 256 one warpgroup cannot hold a row's whole O:
//   * D = 256: as above, 128 query rows, 64 a consumer, each with the
//     whole of O (128 registers), S (32) and packed P (16) at key tiles of
//     64.  Shared memory: Q 64 KB, K and V 32 KB a stage, two stages: 192
//     KB.
//   * D = 320 .. 512: 64 query rows, shared by both consumers.  O's C =
//     D/64 column chunks are split: consumer 0 owns chunks [0, ceil(C/2)),
//     consumer 1 the rest (at most 4 chunks, 128 registers).  S is shared
//     by summing partials: consumer 0 computes S over head-dim chunks
//     [0, floor(C/2)), consumer 1 over [floor(C/2), C), each in f32 on
//     wgmma; each writes its partial (64 x 32 f32, key tiles of 32) to
//     shared memory, one named barrier over the 256 consumer threads,
//     and each adds the other's (a + b == b + a, so both hold the same
//     S bit for bit and run the same softmax).  Every consumer thus
//     multiplies C chunks a key tile (its S chunks and its O chunks), and
//     P V multiplies P by its own chunks of V only.  The exchange has two
//     buffers (key tiles alternate), so one barrier a tile suffices: a
//     buffer is written again only after both passed the next barrier.
//     Shared memory at D = 512: Q 64 KB, K and V 32 KB a stage, two
//     stages, and 32 KB of exchange: 224 KB of the 227.
//   * What bounds it: the consumers run the softmax between their
//     products, and past 256 the exchange puts both consumers in step,
//     so the tensor cores idle while they do; S at key tiles of 32 reads
//     its Q operand (2 KB) for every 32 keys from shared memory.
//   * Past 512 one CTA's resident Q and two-stage ring of K and V do not
//     fit 227 KB: the two passes (below).
//
//   * ptxas (CUDA 12.8, -O3, sm_90a): every instantiation of the four
//     16-bit kernels reports 168 registers, the cap of
//     __launch_bounds__(384, 1) that setmaxnreg lifts to 240 for the
//     consumers, and 0 bytes of spill stores and loads.
//
// f32 inputs, flash_tf32_kernel (split TF32, "3xTF32"):
//   * Arithmetic.  Each operand x of both products is split in two: hi
//     is x with its low 13 bits cleared (a TF32 value), lo = x - hi (exact
//     in f32) rounded to TF32 to nearest (cvt.rna.tf32.f32), so that
//     |x - hi - lo| <= 2**-21 |x|.  A product A B is A_hi B_lo + A_lo B_hi
//     + A_hi B_hi (lo*lo, about 2**-22 of it, is dropped), each term exact
//     in the tensor core.  Q is scaled by 1/sqrt(d) in f32 before the
//     split, as the JAX kernel.  Every operand is masked explicitly, so
//     nothing rests on how the tensor core reads a raw f32 word.
//   * Error budget, against f32's limit |kernel - plain| <= 1e-6 + 1e-5
//     |plain| + 1e-5 softmax(QK^T) |V| (chip_smoke.FLASH_TOL): modelled on
//     the CPU (tests/test_torch_flash_split32.py run as a script:
//     standard-normal Q, K, V, D 64-512, T 80 and 128), one TF32 pass
//     reaches 69-114x the limit, bf16x3 (bf16 hi/lo, three products)
//     0.41-1.14x, past 1 where causal rows have few live keys, split TF32
//     0.03-0.06x.
//   * The tensor core truncates as it sums (it does not round to nearest),
//     so a long chain of products into one accumulator drifts: a first
//     build that summed O across all key tiles and S across all k-slices
//     in the accumulators came close to the limit at the full card (B=2
//     T=4096 H=16 D=128).  So every chain is short and is added in f32 by
//     the CUDA cores: S in batches of one 32-column box (12 wgmma, small
//     products first), O per key tile and 64 or 128 columns (3 x kBN / 8
//     wgmma), folded as O = O corr + P V by one fma; the full-card rows
//     then stay within 0.06-0.15 of the limit (chip_smoke.py).
//   * p = 2**(S log2(e) - m) on ex2.approx.ftz (relative error about
//     2**-22, far below the limit's 1e-5), as the 16-bit kernels; m, l
//     and the online softmax in f32; p = 0 where S is not finite; the
//     output acc / max(l, 1e-30).
//   * Trap 1: TF32 wgmma has no transpose flag (imm-trans-b is 16-bit
//     only), so both shared-memory operands must be K-major.  K (keys x
//     head dim, as TMA lands it) is the B of S = Q K^T as it lies; V, the
//     B of O += P V, needs V^T (head dim x keys, keys contiguous).  TMA
//     neither transposes nor splits: 96 threads of the producer warpgroup
//     (warps 1-3; warp 0's lane 0 issues every TMA copy) build K's hi and
//     lo planes and V^T's hi and lo planes from the landed tiles, in the
//     swizzled layout the descriptors read (128-byte swizzle, 64-byte for
//     V^T rows of 16 keys), fence them for the async proxy and signal
//     k_ready / v_ready.
//   * Trap 2: a thread's TF32 A fragment holds columns t and t + 4 of its
//     quad's 8-key slice, where the f32 accumulator holds 2t and 2t + 1,
//     so the 16-bit kernels' "accumulator fragment is the A fragment" does
//     not carry over.  The fragment is taken as it lies ({S[2t], S[2t +
//     1]} of rows r and r + 8 as A's {t, t + 4}) and the converters write
//     V^T's keys of each 8-key slice in the matching order (logical 0..7 =
//     physical 0, 2, 4, 6, 1, 3, 5, 7): free, since the transpose writes
//     every element once anyway.
//   * Q from registers: per k8 slice each consumer thread loads its four
//     Q words from the raw tile in shared memory, scales and splits them;
//     the 16 words of a 32-column batch stay live until its wgmma finish.
//     P from registers, split the same way after the softmax.
//   * Layouts (bytes of shared memory, of the 227 KB a block can take;
//     key tiles of kBN; rings of kKS raw K and kVS raw V slots let the TMA
//     run ahead of the converters):
//       D     CTAs  consumers (rows)  kBN  kKS kVS  Q      plane   bytes
//       64    1     2 (128)           64   2   2    32 KB  16 KB   230568
//       128   1     2 (128)           32   0   2    64 KB  16 KB   230568
//       256   2     2 (128)           16   2   2    64 KB   8 KB   181416
//       320   2     2 (128)           16   2   2    80 KB  10 KB   222376
//       384   2     1 (64)            16   2   2    48 KB  12 KB   205992
//       448   2     1 (64)            16   0   2    56 KB  14 KB   210088
//       512   2     1 (64)            16   0   1    64 KB  16 KB   222376
//     A plane is one key tile of one of Khi, Klo, V^T hi, V^T lo; two
//     stages of the four.  With kKS = 0 K lands in its hi plane and is
//     split in place (two K slots do not fit; at D = 128 a slot of each
//     was 9% slower than two V slots, measured).
//   * Past D = 128 (D = 256 .. 512) a cluster of two CTAs serves each
//     query tile, each holding half of the head dim's Q, K and V (the
//     16-bit kernels' split of the head dim, one level up): each computes
//     a partial S, stores it into the other CTA's exchange slot with
//     st.async (the bytes complete on that CTA's x_full mbarrier, no
//     fence; 11-14% faster than plain remote stores and a release
//     arrive), waits for the other's and adds it in place (own + other is
//     one order on both CTAs, so both hold the same S bit for bit); each
//     owns its half of O's columns and multiplies P by its half of V^T.
//     Two slots a consumer.  The cluster's CTAs sync after barrier init
//     and before they leave.
//   * Consumers: setmaxnreg moves the producer warpgroup to 56 registers
//     and two consumers to 224; one consumer (384 threads' cap lifted to
//     255 with 256 threads) needs none.
//   * What bounds it: at D <= 128 the two consumers keep the tensor cores
//     at 0.46-0.52 of the three-product bound at the full card; past 128
//     the per-tile chain (S in batches, the exchange of ~480 cycles a key
//     tile, the softmax, P V in chunks) leaves them idle: 0.21-0.33 (clock
//     probes, PERF.md).  The two-pass route below reaches more at 320-512
//     on a copy of this source (PERF.md); the route has not moved there.
//   * ptxas (CUDA 12.8, -O3, sm_90a): flash_tf32_kernel 168 registers at
//     D = 64, 128, 256, 320 (the cap of __launch_bounds__(384, 1), lifted
//     by setmaxnreg), 197 at 384, 213 at 448, 238 at 512; 0 bytes of
//     spill stores and loads in every instantiation.
//
// Past D = 512, two passes, both dtypes (f32: flash_scores32_kernel,
// flash_values32_kernel; f16 and bf16: flash_scores16_kernel,
// flash_values16_kernel):
//   * Why two passes: past 512 one CTA holds neither a query tile's O and
//     resident Q nor the rings of K and V.  Splitting the head dim over a
//     cluster of CTAs (the route before, 3-8 CTAs) computed S in step over
//     all of them, each key tile waiting for the slowest CTA's partial.
//     Here S is computed once per (query block, key tile) over the whole
//     head dim by one CTA, stored to a bounded scratch, and read back once
//     for each slice of O's columns; the slices of one block run side by
//     side, so most of those reads come from L2.  On the card this was
//     2.65-3.72x the f32 cluster and 1.44-1.78x the 16-bit one at every
//     width they took (PERF.md), so nothing else runs past 512.
//   * flash_scores32_kernel: one CTA per (query block of 128 rows, split
//     of kSplitTiles key tiles of 64); two consumers of 64 rows share
//     each K tile.  Per key tile it streams the head dim through a ring
//     of 6 steps, each a 32-column TMA box of Q (128 rows) and of K (64
//     keys; the converters split K in place into its hi plane beside a
//     lo plane), and runs flash_tf32_kernel's S arithmetic unchanged
//     (s_batch: Q scaled in f32, split in registers, 12 TF32 wgmma a
//     step, small products first, each step's sum added in f32).  It
//     stores S (f32, keys past the sequence or the diagonal -inf, masked
//     only on a tile that crosses either) and each row's max of S
//     log2(e) over the split.  It does not compute l: an online l sums p
//     taken against a running max, not the p the second pass multiplies
//     in.  Under causal masking a consumer neither computes nor stores
//     tiles past its last row, and the splits past the diagonal only
//     write -inf maxima.  The max is exact in any order, so the key
//     tiles of a block can be split over CTAs (to fill 132 SMs at T =
//     1024) and the maxima of the splits joined in the second pass.
//   * flash_values32_kernel: one CTA per (query block, slice of O: the
//     D/32 boxes over ceil(D/192) slices as evenly as they go, 192 or
//     160 columns past 512, each a template instance); two consumers of
//     64 rows.  Per key tile of 32 a TMA
//     thread loads the block's S box (128 rows x 32 keys, the 128-byte
//     swizzle, so a thread's fragment loads conflict-free) and the
//     slice's V boxes; the converters build V^T's hi and lo planes
//     (vt_planes, as flash_tf32_kernel).  Each consumer takes p =
//     2**(S log2(e) - m) against the final m (the max over the splits)
//     on ex2.approx.ftz, p = 0 where S is not finite, sums l from those
//     p in key-tile order (every slice's CTA adds the same numbers in the
//     same order: one l, the sum of exactly the p multiplied in), splits
//     P and folds P V into O in f32 (pv_fold, corr 1: m is final, so no
//     rescale).  O / max(l, 1e-30), as the JAX kernel.
//   * Chunks: the entry point launches the pair once per chunk of query
//     blocks whose S (128 x T x 4 bytes a block, T rounded up to 64) and
//     maxima fit kScratchCap (at least one block a chunk), in stream
//     order on one scratch, so no chunk's values kernel still reads it
//     when the next scores kernel writes it; a chunk may split a head.
//     rt_flash_scratch_bytes gives the bytes; rt_flash_last_launches
//     reads the kernel launches the calling thread's last call made,
//     counted where each launch succeeds (2 a chunk here, 1 elsewhere).
//   * What bounds the f32 pair: operations, three TF32 products each of
//     S and P V; it reaches 0.41-0.45 of that bound at 576-1600 (PERF.md).
//     The design does each product once: S per (query block, key tile),
//     P V per (block, key tile, slice).
//   * f32 layouts: scores 6 steps x (Q 16 KB, K's hi 8 KB, lo 8 KB) =
//     197,776 bytes; values 2 stages of V^T's hi and lo (24 KB each at 192
//     columns) and 3 raw stages (S 16 KB, V 24 KB) = 222,288 bytes.  A
//     raw stage goes back to the TMA thread only after the tile's P V:
//     released right after the consumers' loads of S, the refill's TMA
//     writes (async proxy) could land under loads still in flight.
//   * flash_scores16_kernel: the grid, the splits, the masking and the
//     stores of flash_scores32_kernel, on the 16-bit kernels' arithmetic:
//     S = Q K^T is one chain of m64n64k16 wgmma (both operands K-major in
//     shared memory, 128-byte swizzle) over the whole head dim into an f32
//     accumulator, then times the scale in f32 (never a 16-bit Q).  No
//     hi/lo split, so no converter warps: the producer warpgroup is one
//     TMA thread (24 registers; the consumers 240).  A split's four key
//     tiles run side by side (4 accumulators of 64 rows x 64 keys, 128
//     registers a thread), so each step's Q box is read once for all of
//     them: a ring of 4 steps, each Q's 64-column box (128 rows, 16 KB)
//     and the same box of K for each live key tile (64 keys, 8 KB each),
//     48 KB a step, 197,696 bytes.  The accumulators are zeroed and every
//     product accumulates (several chains in flight); a step's stage goes
//     back once its products are done (wgmma.wait_group 1, one step in
//     flight).  The tensor core truncates as it sums: over a chain of D/16
//     products the drift stays near 2**-24 of |S| a product, ~0.05 of the
//     f16 limit's p term at D = 4096 (a CPU model of a truncating sum).
//   * flash_values16_kernel: one CTA per (query block, slice of O: the
//     D/64 boxes over ceil(D/256) slices as evenly as they go, 3 or 4
//     boxes past 512, 192 or 256 columns: 128 f32 registers a consumer
//     thread at 256, wgmma's widest N); two consumers of 64 rows.  A ring
//     of 6 stages, each the block's S box (as Val32's, 16 KB) and the
//     slice's V boxes (32 keys x 64 columns, 4 KB each): 197,728 bytes.
//     p against the final m and l as the f32 pair (p_of_s_box); P is
//     rounded to 16 bits into the A fragment (the S fragment's layout is
//     the A fragment's, as in flash_wgmma_kernel) and O += P V by
//     m64n64k16 wgmma, V read MN-major through the transpose flag (no V^T
//     planes).  The p of key tile kt are taken while P V of tile kt - 1 is
//     in flight; that stage goes back after its wait.  O / max(l, 1e-30),
//     rounded to the input type.
//   * What bounds the 16-bit pair: not operations (one product each of S
//     and P V: 0.25-0.31 of that bound at 576-1600, PERF.md) but the
//     bytes each SM reads from L2: the scores kernel 48 KB a step for 4.2
//     MFLOP (87 flop/byte), the values kernel the S box (16 KB) again for
//     every slice beside 16 KB of V for 2.1 MFLOP, against ~989 TFLOP/s
//     over 132 SMs; and S's write and read in device memory (1 GiB each
//     way at B=2 T=4096 H=8, ~0.3 ms apiece).
//   * ptxas (CUDA 12.8, -O3, sm_90a): all four kernels 168 registers (the
//     cap of __launch_bounds__(384, 1), lifted by setmaxnreg for the
//     consumers), 0 bytes of spill stores and loads.
//
// Scaling: the JAX kernel scales Q in f32 before the product.  The f32
// paths do exactly that.  On the 16-bit paths Q stays in its 16-bit type
// (rounding a scaled Q back to 16 bits would add an error the JAX kernel
// does not have) and the scale multiplies the f32 product, which equals
// the JAX order up to f32 rounding.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

namespace {

// kernel launches of the calling thread's current rt_flash_attention
// call, one added where each launch succeeds (rt_flash_last_launches)
thread_local long long t_launches = 0;

constexpr unsigned kFull = 0xffffffffu;

// ---------------------------------------------------------------------------
// 16-bit paths: wgmma + TMA
// ---------------------------------------------------------------------------

constexpr int kConsumers = 2;       // consumer warpgroups
constexpr int kThreads16 = (kConsumers + 1) * 128;
constexpr uint32_t kRowBytes = 128; // one box row: 64 16-bit elements
constexpr uint32_t kSwAtom = 1024;  // 8 swizzled rows
constexpr uint32_t kSmemMax = 232448;  // a block's opt-in shared memory

// flash_wgmma_kernel's layout: D = 64 or 128
template <int D>
struct Smem16 {
  static constexpr int kBQ = 128;            // query rows per CTA
  static constexpr int kBN = 128;            // keys per tile
  static constexpr int kStages = 2;          // K/V ring depth
  static constexpr int kBoxes = D / 64;
  static constexpr uint32_t kQBox = kBQ * kRowBytes;
  static constexpr uint32_t kKVBox = kBN * kRowBytes;
  static constexpr uint32_t kStage = kBoxes * kKVBox;  // one K or V tile
  static constexpr uint32_t kQ = 0;
  static constexpr uint32_t kK = kQ + kBoxes * kQBox;
  static constexpr uint32_t kV = kK + kStages * kStage;
  static constexpr uint32_t kBar = kV + kStages * kStage;
  // barriers: q_full, k_full[S], v_full[S], empty[S]; slack to align to
  // 1024 bytes, which the 128-byte swizzle needs
  static constexpr uint32_t kBytes = kBar + 8 * (1 + 3 * kStages) + kSwAtom;
};

// flash_big16_kernel's layout: D = 256 .. 512, a multiple of 64
template <int D>
struct Big16 {
  static constexpr int kC = D / 64;          // 64-column chunks
  static constexpr bool kSplit = D > 256;    // consumers split O's columns
  static constexpr int kBQ = kSplit ? 64 : 128;
  static constexpr int kBN = kSplit ? 32 : 64;
  static constexpr int kStages = 2;
  static constexpr int kBoxes = kC;
  static constexpr uint32_t kQBox = kBQ * kRowBytes;
  static constexpr uint32_t kKVBox = kBN * kRowBytes;
  static constexpr uint32_t kStage = kBoxes * kKVBox;
  static constexpr uint32_t kQ = 0;
  static constexpr uint32_t kK = kQ + kBoxes * kQBox;
  static constexpr uint32_t kV = kK + kStages * kStage;
  static constexpr uint32_t kX = kV + kStages * kStage;
  // the S exchange: 2 buffers x 2 consumers x a partial S (64 x kBN f32)
  static constexpr uint32_t kXSlot = 64 * kBN * 4;
  static constexpr uint32_t kBar = kX + (kSplit ? 4 * kXSlot : 0);
  static constexpr uint32_t kBytes = kBar + 8 * (1 + 3 * kStages) + kSwAtom;
  static_assert(D % 64 == 0 && D >= 256 && D <= 512, "kernel width");
  static_assert(kBytes <= kSmemMax, "shared memory");
};

// consumer w's chunks of O, [o_lo, o_hi), and the head-dim chunks it
// sums S over, [s_lo, s_hi), of the c chunks a CTA holds; split: the two
// consumers share 64 rows (Big16 past 256), else each has its own rows
// and all c chunks
__host__ __device__ constexpr int o_lo(bool split, int w, int c) {
  return split && w ? (c + 1) / 2 : 0;
}
__host__ __device__ constexpr int o_hi(bool split, int w, int c) {
  return split && !w ? (c + 1) / 2 : c;
}
__host__ __device__ constexpr int s_lo(bool split, int w, int c) {
  return split && w ? c / 2 : 0;
}
__host__ __device__ constexpr int s_hi(bool split, int w, int c) {
  return split && !w ? c / 2 : c;
}

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

// the ring's barriers, after q_full at bar_q: k_full[s], v_full[s],
// empty[s] for the kS stages
template <int kS>
__device__ __forceinline__ uint32_t k_full(uint32_t bar_q, int s) {
  return bar_q + 8u * (1 + s);
}
template <int kS>
__device__ __forceinline__ uint32_t v_full(uint32_t bar_q, int s) {
  return bar_q + 8u * (1 + kS + s);
}
template <int kS>
__device__ __forceinline__ uint32_t empty_bar(uint32_t bar_q, int s) {
  return bar_q + 8u * (1 + 2 * kS + s);
}

template <class L>
__device__ __forceinline__ void init_barriers(uint32_t bar_q) {
  mbar_init(bar_q, 1);
#pragma unroll
  for (int s = 0; s < L::kStages; ++s) {
    mbar_init(k_full<L::kStages>(bar_q, s), 1);
    mbar_init(v_full<L::kStages>(bar_q, s), 1);
    mbar_init(empty_bar<L::kStages>(bar_q, s), kConsumers * 128);
  }
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(bar)
      : "memory");
}

// the producer thread: Q once, then K and V of every key tile through
// the ring of layout L; kNB boxes of 64 columns
template <class L, int kNB = L::kBoxes>
__device__ __forceinline__ void produce(uint32_t base, const CUtensorMap* tm_q,
                                        const CUtensorMap* tm_k,
                                        const CUtensorMap* tm_v, int h, int b,
                                        int q0, int n_kt) {
  const uint32_t sQ = base + L::kQ, sK = base + L::kK, sV = base + L::kV;
  const uint32_t bar_q = base + L::kBar;
  mbar_expect_tx(bar_q, kNB * L::kQBox);
#pragma unroll
  for (int x = 0; x < kNB; ++x)
    tma_load_4d(sQ + x * L::kQBox, tm_q, bar_q, x * 64, h, q0, b);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int s = kt % L::kStages, use = kt / L::kStages;
    if (use > 0) mbar_wait(empty_bar<L::kStages>(bar_q, s), (use - 1) & 1);
    const uint32_t kb = k_full<L::kStages>(bar_q, s);
    const uint32_t vb = v_full<L::kStages>(bar_q, s);
    mbar_expect_tx(kb, kNB * L::kKVBox);
#pragma unroll
    for (int x = 0; x < kNB; ++x)
      tma_load_4d(sK + s * L::kStage + x * L::kKVBox, tm_k, kb, x * 64, h,
                  kt * L::kBN, b);
    mbar_expect_tx(vb, kNB * L::kKVBox);
#pragma unroll
    for (int x = 0; x < kNB; ++x)
      tma_load_4d(sV + s * L::kStage + x * L::kKVBox, tm_v, vb, x * 64, h,
                  kt * L::kBN, b);
  }
}

// wgmma shared-memory descriptor, 128-byte swizzle.  K-major operands:
// sbo = 1024 (8 rows of 128 bytes), lbo unused.  MN-major operands: lbo =
// the stride between 64-element blocks of the MN dimension, sbo = 1024
// (8 rows of the K dimension).
__device__ __forceinline__ uint64_t desc_sw128(uint32_t saddr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((saddr & 0x3FFFFu) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFFu) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFFu) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// every group but the last committed is done
__device__ __forceinline__ void wgmma_wait1() {
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}
// keeps the compiler from touching accumulators across the async product
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define RT_R16                                 \
  "%0, %1, %2, %3, %4, %5, %6, %7, "           \
  "%8, %9, %10, %11, %12, %13, %14, %15"
#define RT_R32                                 \
  RT_R16 ", "                                  \
  "%16, %17, %18, %19, %20, %21, %22, %23, "   \
  "%24, %25, %26, %27, %28, %29, %30, %31"
#define RT_R64                                 \
  RT_R32 ", "                                  \
  "%32, %33, %34, %35, %36, %37, %38, %39, "   \
  "%40, %41, %42, %43, %44, %45, %46, %47, "   \
  "%48, %49, %50, %51, %52, %53, %54, %55, "   \
  "%56, %57, %58, %59, %60, %61, %62, %63"
#define RT_O16(d)                                          \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),          \
  "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),          \
  "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),        \
  "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
#define RT_O32(d)                                          \
  RT_O16(d), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),        \
  "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]),      \
  "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]),      \
  "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),      \
  "+f"(d[31])
#define RT_O64(d)                                          \
  RT_O32(d), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),        \
  "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]),      \
  "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),      \
  "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]),      \
  "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),      \
  "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),      \
  "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]),      \
  "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),      \
  "+f"(d[63])

// D[64 x N] (+)= A[64 x 16] B[16 x N], A and B K-major in shared memory;
// scale_d = 0 overwrites D.  REGS/OUTS name the N/2 accumulators, A, B
// and P the operand numbers that follow them.
#define RT_SS(SHAPE, TY, REGS, OUTS, A, B, P)                              \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, " P ", 0;\n"             \
               "wgmma.mma_async.sync.aligned." SHAPE ".f32." TY "." TY     \
               " {" REGS "}, " A ", " B ", p, 1, 1, 0, 0;\n}\n"            \
               : OUTS                                                      \
               : "l"(da), "l"(db), "r"(scale_d))
template <bool kBF16>
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da,
                                         uint64_t db, int scale_d) {
  if constexpr (kBF16)
    RT_SS("m64n128k16", "bf16", RT_R64, RT_O64(d), "%64", "%65", "%66");
  else
    RT_SS("m64n128k16", "f16", RT_R64, RT_O64(d), "%64", "%65", "%66");
}
template <bool kBF16>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int scale_d) {
  if constexpr (kBF16)
    RT_SS("m64n64k16", "bf16", RT_R32, RT_O32(d), "%32", "%33", "%34");
  else
    RT_SS("m64n64k16", "f16", RT_R32, RT_O32(d), "%32", "%33", "%34");
}
template <bool kBF16>
__device__ __forceinline__ void wgmma_ss(float (&d)[16], uint64_t da,
                                         uint64_t db, int scale_d) {
  if constexpr (kBF16)
    RT_SS("m64n32k16", "bf16", RT_R16, RT_O16(d), "%16", "%17", "%18");
  else
    RT_SS("m64n32k16", "f16", RT_R16, RT_O16(d), "%16", "%17", "%18");
}

// D[64 x N] += A[64 x 16] B[16 x N], A in registers, B MN-major in
// shared memory (transpose flag set); N = 128 and N = 64
template <bool kBF16>
__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (kBF16)
    asm volatile(
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" RT_R64
        "}, {%64, %65, %66, %67}, %68, 1, 1, 1, 1;\n"
        : RT_O64(d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
  else
    asm volatile(
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16 {" RT_R64
        "}, {%64, %65, %66, %67}, %68, 1, 1, 1, 1;\n"
        : RT_O64(d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}
template <bool kBF16>
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (kBF16)
    asm volatile(
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" RT_R32
        "}, {%32, %33, %34, %35}, %36, 1, 1, 1, 1;\n"
        : RT_O32(d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
  else
    asm volatile(
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 {" RT_R32
        "}, {%32, %33, %34, %35}, %36, 1, 1, 1, 1;\n"
        : RT_O32(d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

// 2**x by the SFU (flushes subnormal results to 0; ex2(-inf) = 0)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <bool kBF16>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  uint32_t out;
  if constexpr (kBF16) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    out = *reinterpret_cast<const uint32_t*>(&v);
  } else {
    const __half2 v = __floats2half2_rn(lo, hi);
    out = *reinterpret_cast<const uint32_t*>(&v);
  }
  return out;
}

// One key tile's online-softmax step on a consumer warpgroup's S
// accumulator (64 rows x kN keys; element 4k + 2i + j of the fragment is
// row r0 + 8i, key k0 + 8k + c_lane + j).  Masks keys past tn and, when
// causal, past the row, only on a tile that crosses the end or the
// diagonal (row0: the warpgroup's first row).  Moves the running max m2
// (log2 units) and this thread's part of l, returns in corr the factor
// that rescales O, and in pa P = exp(S - m) rounded to 16 bits, already
// in the A-fragment order of the m64k16 product: slice kk = keys
// 16kk..16kk+15 is {row r0 keys +0..7, row r0+8 keys +0..7, row r0
// +8..15, row r0+8 +8..15}.
template <bool kBF16, int kN>
__device__ __forceinline__ void softmax_tile(
    float (&s)[kN / 2], uint32_t (&pa)[kN / 4], float (&m2)[2],
    float (&lsum)[2], float (&corr)[2], int k0, int row0, int r0, int c_lane,
    int tn, int causal, float scale_log2) {
  if (k0 + kN > tn || (causal && k0 + kN - 1 > row0)) {
#pragma unroll
    for (int k = 0; k < kN / 8; ++k)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int col = k0 + 8 * k + c_lane + j;
          if (col >= tn || (causal && col > r0 + 8 * i))
            s[4 * k + 2 * i + j] = -INFINITY;
        }
  }

  float m_use[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float mx = -INFINITY;
#pragma unroll
    for (int k = 0; k < kN / 8; ++k)
      mx = fmaxf(mx, fmaxf(s[4 * k + 2 * i], s[4 * k + 2 * i + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));
    const float m_new = fmaxf(m2[i], mx * scale_log2);
    m_use[i] = m_new == -INFINITY ? 0.f : m_new;
    corr[i] = exp2_approx(m2[i] - m_use[i]);
    m2[i] = m_new;
    lsum[i] *= corr[i];
  }

#pragma unroll
  for (int k = 0; k < kN / 8; ++k)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float p[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float sv = s[4 * k + 2 * i + j];
        p[j] = isfinite(sv) ? exp2_approx(fmaf(sv, scale_log2, -m_use[i]))
                            : 0.f;
        lsum[i] += p[j];
      }
      pa[(k >> 1) * 4 + (k & 1) * 2 + i] = pack2<kBF16>(p[0], p[1]);
    }
}

template <bool kBF16, int D>
__global__ void __launch_bounds__(kThreads16, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                   const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v,
                   uint16_t* __restrict__ o, int tn, int heads, int bh_count,
                   int n_qt, int causal, float scale_log2) {
  using L = Smem16<D>;
  constexpr int kBN = L::kBN;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + kSwAtom - 1) & ~(kSwAtom - 1);
  const uint32_t sQ = base + L::kQ, sK = base + L::kK, sV = base + L::kV;
  const uint32_t bar_q = base + L::kBar;

  const int tid = threadIdx.x, wg = tid >> 7;
  const int qt = n_qt - 1 - (int)(blockIdx.x / (unsigned)bh_count);
  const int bh = (int)(blockIdx.x % (unsigned)bh_count);
  const int b = bh / heads, h = bh % heads, q0 = qt * L::kBQ;
  int n_kt = (tn + kBN - 1) / kBN;
  if (causal) n_kt = min(n_kt, (min(q0 + L::kBQ, tn) - 1) / kBN + 1);

  if (tid == 0) init_barriers<L>(bar_q);
  __syncthreads();

  if (wg == kConsumers) {
    // ---- producer: one thread keeps the ring full ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (tid == kConsumers * 128)
      produce<L>(base, &tm_q, &tm_k, &tm_v, h, b, q0, n_kt);
  } else {
    // ---- consumers: 64 query rows per warpgroup ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int t = tid & 127, warp = t >> 5, lane = t & 31;
    // this thread's rows (fragment rows r0 and r0 + 8) and first column
    const int r0 = q0 + wg * 64 + warp * 16 + (lane >> 2);
    const int c_lane = 2 * (lane & 3);
    const int wg_row0 = q0 + wg * 64;
    const uint32_t sQw = sQ + wg * 64 * kRowBytes;
    float acc_o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc_o[i] = 0.f;
    float m2[2] = {-INFINITY, -INFINITY};   // running max, log2 units
    float lsum[2] = {0.f, 0.f};             // this thread's part of l

    mbar_wait(bar_q, 0);
    for (int kt = 0; kt < n_kt; ++kt) {
      const int s = kt % L::kStages;
      const uint32_t par = (kt / L::kStages) & 1;
      const uint32_t sKs = sK + s * L::kStage, sVs = sV + s * L::kStage;

      // S = Q K^T (f32, unscaled)
      float acc_s[kBN / 2];
      mbar_wait(k_full<L::kStages>(bar_q, s), par);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<kBF16>(
            acc_s,
            desc_sw128(sQw + (kk >> 2) * L::kQBox + (kk & 3) * 32, 16,
                       kSwAtom),
            desc_sw128(sKs + (kk >> 2) * L::kKVBox + (kk & 3) * 32, 16,
                       kSwAtom),
            kk > 0);
      wgmma_commit();
      wgmma_wait0();
      fence_regs(acc_s);

      float corr[2];
      uint32_t pa[kBN / 4];
      softmax_tile<kBF16, kBN>(acc_s, pa, m2, lsum, corr, kt * kBN, wg_row0,
                               r0, c_lane, tn, causal, scale_log2);
#pragma unroll
      for (int k = 0; k < D / 8; ++k)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          acc_o[4 * k + 2 * i] *= corr[i];
          acc_o[4 * k + 2 * i + 1] *= corr[i];
        }

      // O += P V
      mbar_wait(v_full<L::kStages>(bar_q, s), par);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBN / 16; ++kk) {
        const uint32_t a[4] = {pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2],
                               pa[4 * kk + 3]};
        wgmma_rs<kBF16>(acc_o, a,
                        desc_sw128(sVs + kk * 16 * kRowBytes, L::kKVBox,
                                   kSwAtom));
      }
      wgmma_commit();
      wgmma_wait0();
      fence_regs(acc_o);
      mbar_arrive(empty_bar<L::kStages>(bar_q, s));
    }

#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float l = lsum[i];
      l += __shfl_xor_sync(kFull, l, 1);
      l += __shfl_xor_sync(kFull, l, 2);
      const float den = fmaxf(l, 1e-30f);
      const int row = r0 + 8 * i;
      if (row < tn) {
        uint16_t* orow =
            o + (((size_t)b * tn + row) * heads + h) * D + c_lane;
#pragma unroll
        for (int k = 0; k < D / 8; ++k)
          *reinterpret_cast<uint32_t*>(orow + 8 * k) = pack2<kBF16>(
              acc_o[4 * k + 2 * i] / den, acc_o[4 * k + 2 * i + 1] / den);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// 16-bit path at widths 256 .. 512
// ---------------------------------------------------------------------------

__device__ __forceinline__ void st_shared_v4(uint32_t addr, float a, float b,
                                             float c, float d) {
  asm volatile("st.shared.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr),
               "f"(a), "f"(b), "f"(c), "f"(d)
               : "memory");
}
__device__ __forceinline__ float4 ld_shared_v4(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}
// named barrier 1 over the two consumer warpgroups
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers * 128) : "memory");
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release;\n"
      "barrier.cluster.wait.acquire;\n" ::: "memory");
}
// the address of the same shared-memory offset in CTA `rank`
__device__ __forceinline__ uint32_t map_rank(uint32_t addr, uint32_t rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(out)
               : "r"(addr), "r"(rank));
  return out;
}
// 16 bytes into another CTA's shared memory; the store completes its
// bytes on that CTA's mbarrier (no fence: the barrier's transaction count
// says when every store of a phase has landed)
__device__ __forceinline__ void st_async_v4(uint32_t addr, float a, float b,
                                            float c, float d,
                                            uint32_t remote_bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], "
      "{%1, %2, %3, %4}, [%5];\n" ::"r"(addr),
      "f"(a), "f"(b), "f"(c), "f"(d), "r"(remote_bar)
      : "memory");
}
__device__ __forceinline__ void mbar_wait_cluster(uint32_t bar,
                                                  uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// S of a key tile on a CTA of a cluster of two, each holding a partial
// over its half of the head dim: this consumer's partial (thread t's
// float4 v at (v * 128 + t) * 16 of a slot of kN * 512 bytes) goes to the
// same consumer of the other CTA, its bytes counted on that CTA's x_full
// `xbar`, and once the other's has landed here it is added in place.  Own
// + other is one order on both CTAs (a + b == b + a), so both hold the
// same S bit for bit and run the same softmax, with no second accumulator
// (flash_tf32_kernel at D = 512 uses 238 of 255 registers).  A slot is
// stored into again only after the other CTA's partial of the next tile
// has landed here, which it sends after reading its own slot of this one.
// Thread 0 arms xbar's next phase when `rearm`.
template <int kN>
__device__ __forceinline__ void cluster_sum_s(float (&acc)[kN],
                                              uint32_t slots, uint32_t xbar,
                                              uint32_t parity, uint32_t rank,
                                              int t, bool rearm) {
  constexpr uint32_t kSlot = kN * 128u * 4u;   // a partial: 64 x 2 kN f32
  const uint32_t rslot = map_rank(slots, rank ^ 1u);
  const uint32_t rbar = map_rank(xbar, rank ^ 1u);
#pragma unroll
  for (int v = 0; v < kN / 4; ++v)
    st_async_v4(rslot + (v * 128 + t) * 16, acc[4 * v], acc[4 * v + 1],
                acc[4 * v + 2], acc[4 * v + 3], rbar);
  mbar_wait_cluster(xbar, parity);
#pragma unroll
  for (int v = 0; v < kN / 4; ++v) {
    const float4 y = ld_shared_v4(slots + (v * 128 + t) * 16);
    acc[4 * v] += y.x;
    acc[4 * v + 1] += y.y;
    acc[4 * v + 2] += y.z;
    acc[4 * v + 3] += y.w;
  }
  if (t == 0 && rearm) mbar_expect_tx(xbar, kSlot);
}

// consumer warpgroup W of flash_big16_kernel (layout Big16): its O
// chunks and (past 256, the partial of) S over its head-dim chunks, for
// every key tile
template <bool kBF16, class L, int W>
__device__ __forceinline__ void big16_consume(
    uint32_t base, uint16_t* __restrict__ o, int b, int h, int heads, int q0,
    int tn, int n_kt, int causal, float scale_log2) {
  constexpr int kBN = L::kBN, kS = L::kStages, kNC = L::kC;
  constexpr int kOLo = o_lo(L::kSplit, W, kNC);
  constexpr int kNO = o_hi(L::kSplit, W, kNC) - kOLo;
  constexpr int kSLo = s_lo(L::kSplit, W, kNC);
  constexpr int kSHi = s_hi(L::kSplit, W, kNC);
  constexpr int kRow = L::kSplit ? 0 : W * 64;   // first row in the tile
  const uint32_t bar_q = base + L::kBar;
  const uint32_t sQw = base + L::kQ + kRow * kRowBytes;
  const int t = threadIdx.x & 127, warp = t >> 5, lane = t & 31;
  const int row0 = q0 + kRow;
  const int r0 = row0 + warp * 16 + (lane >> 2);
  const int c_lane = 2 * (lane & 3);

  float acc_o[kNO][32];
#pragma unroll
  for (int j = 0; j < kNO; ++j)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc_o[j][i] = 0.f;
  float m2[2] = {-INFINITY, -INFINITY};   // running max, log2 units
  float lsum[2] = {0.f, 0.f};             // this thread's part of l

  mbar_wait(bar_q, 0);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int s = kt % kS;
    const uint32_t par = (kt / kS) & 1;
    const uint32_t sKs = base + L::kK + s * L::kStage;
    const uint32_t sVs = base + L::kV + s * L::kStage;

    // S (or this consumer's partial of it) = Q K^T over chunks
    // [kSLo, kSHi) of the head dim, f32, unscaled
    float acc_s[kBN / 2];
    mbar_wait(k_full<kS>(bar_q, s), par);
    wgmma_fence();
#pragma unroll
    for (int x = kSLo; x < kSHi; ++x)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss<kBF16>(
            acc_s, desc_sw128(sQw + x * L::kQBox + kk * 32, 16, kSwAtom),
            desc_sw128(sKs + x * L::kKVBox + kk * 32, 16, kSwAtom),
            x > kSLo || kk > 0);
    wgmma_commit();
    wgmma_wait0();
    fence_regs(acc_s);

    if constexpr (L::kSplit) {
      // S = own partial + the other consumer's, through shared memory:
      // thread t's fragment as float4 number v * 128 + t of a slot
      const uint32_t slot = base + L::kX + (kt & 1) * 2 * L::kXSlot;
#pragma unroll
      for (int v = 0; v < kBN / 8; ++v)
        st_shared_v4(slot + W * L::kXSlot + (v * 128 + t) * 16,
                     acc_s[4 * v], acc_s[4 * v + 1], acc_s[4 * v + 2],
                     acc_s[4 * v + 3]);
      consumers_sync();
#pragma unroll
      for (int v = 0; v < kBN / 8; ++v) {
        const float4 x =
            ld_shared_v4(slot + (1 - W) * L::kXSlot + (v * 128 + t) * 16);
        acc_s[4 * v] += x.x;
        acc_s[4 * v + 1] += x.y;
        acc_s[4 * v + 2] += x.z;
        acc_s[4 * v + 3] += x.w;
      }
    }

    float corr[2];
    uint32_t pa[kBN / 4];
    softmax_tile<kBF16, kBN>(acc_s, pa, m2, lsum, corr, kt * kBN, row0, r0,
                             c_lane, tn, causal, scale_log2);
#pragma unroll
    for (int j = 0; j < kNO; ++j)
#pragma unroll
      for (int k = 0; k < 8; ++k)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          acc_o[j][4 * k + 2 * i] *= corr[i];
          acc_o[j][4 * k + 2 * i + 1] *= corr[i];
        }

    // O[:, own chunks] += P V[:, own chunks], one m64n64k16 a chunk
    mbar_wait(v_full<kS>(bar_q, s), par);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk) {
      const uint32_t a[4] = {pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2],
                             pa[4 * kk + 3]};
#pragma unroll
      for (int j = 0; j < kNO; ++j)
        wgmma_rs<kBF16>(acc_o[j], a,
                        desc_sw128(sVs + (kOLo + j) * L::kKVBox +
                                       kk * 16 * kRowBytes,
                                   L::kKVBox, kSwAtom));
    }
    wgmma_commit();
    wgmma_wait0();
#pragma unroll
    for (int j = 0; j < kNO; ++j) fence_regs(acc_o[j]);
    mbar_arrive(empty_bar<kS>(bar_q, s));
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = lsum[i];
    l += __shfl_xor_sync(kFull, l, 1);
    l += __shfl_xor_sync(kFull, l, 2);
    const float den = fmaxf(l, 1e-30f);
    const int row = r0 + 8 * i;
    if (row < tn) {
      uint16_t* orow = o + (((size_t)b * tn + row) * heads + h) * kNC * 64 +
                       kOLo * 64 + c_lane;
#pragma unroll
      for (int j = 0; j < kNO; ++j)
#pragma unroll
        for (int k = 0; k < 8; ++k)
          *reinterpret_cast<uint32_t*>(orow + 64 * j + 8 * k) =
              pack2<kBF16>(acc_o[j][4 * k + 2 * i] / den,
                           acc_o[j][4 * k + 2 * i + 1] / den);
    }
  }
}

template <bool kBF16, int D>
__global__ void __launch_bounds__(kThreads16, 1)
flash_big16_kernel(const __grid_constant__ CUtensorMap tm_q,
                   const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v,
                   uint16_t* __restrict__ o, int tn, int heads, int bh_count,
                   int n_qt, int causal, float scale_log2) {
  using L = Big16<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + kSwAtom - 1) & ~(kSwAtom - 1);

  const int tid = threadIdx.x, wg = tid >> 7;
  const int qt = n_qt - 1 - (int)(blockIdx.x / (unsigned)bh_count);
  const int bh = (int)(blockIdx.x % (unsigned)bh_count);
  const int b = bh / heads, h = bh % heads, q0 = qt * L::kBQ;
  int n_kt = (tn + L::kBN - 1) / L::kBN;
  if (causal) n_kt = min(n_kt, (min(q0 + L::kBQ, tn) - 1) / L::kBN + 1);
  const uint32_t bar_q = base + L::kBar;
  if (tid == 0) init_barriers<L>(bar_q);
  __syncthreads();

  // one branch a role to the end, so that setmaxnreg applies
  if (wg == kConsumers) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (tid == kConsumers * 128)
      produce<L>(base, &tm_q, &tm_k, &tm_v, h, b, q0, n_kt);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    if (wg == 0)
      big16_consume<kBF16, L, 0>(base, o, b, h, heads, q0, tn, n_kt, causal,
                                 scale_log2);
    else
      big16_consume<kBF16, L, 1>(base, o, b, h, heads, q0, tn, n_kt, causal,
                                 scale_log2);
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled is a driver-API call: reach it through the
// runtime's entry-point query, so the library needs no -lcuda
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// (B, T, H, D) 16-bit tensor as a 4-d map (dims D, H, T, B; strides in
// bytes), boxes of 64 x 1 x rows x 1 with the 128-byte swizzle
bool make_map(CUtensorMap* map, const void* ptr, int b, int t, int h, int d,
              bool bf16, int rows) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)h, (cuuint64_t)t,
                              (cuuint64_t)b};
  const cuuint64_t strides[3] = {(cuuint64_t)d * 2, (cuuint64_t)h * d * 2,
                                 (cuuint64_t)t * h * d * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  return enc(map,
             bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                  : CU_TENSOR_MAP_DATA_TYPE_FLOAT16,
             4, const_cast<void*>(ptr), dims, strides, box, estr,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// one of the 16-bit kernels with layout L: tensor maps, the shared-memory
// opt-in, the launch; returns the first CUDA error
template <class L, class Kernel>
int launch_tma(Kernel kernel, const void* q, const void* k, const void* v,
               void* o, int b, int tn, int h, int d, bool bf16, int causal,
               float scale, cudaStream_t stream) {
  CUtensorMap mq, mk, mv;
  if (!make_map(&mq, q, b, tn, h, d, bf16, L::kBQ) ||
      !make_map(&mk, k, b, tn, h, d, bf16, L::kBN) ||
      !make_map(&mv, v, b, tn, h, d, bf16, L::kBN))
    return (int)cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::kBytes);
  if (err != cudaSuccess) return (int)err;
  const int n_qt = (tn + L::kBQ - 1) / L::kBQ;
  if ((long long)n_qt * b * h > INT_MAX) return (int)cudaErrorInvalidValue;
  kernel<<<n_qt * b * h, kThreads16, L::kBytes, stream>>>(
      mq, mk, mv, (uint16_t*)o, tn, h, b * h, n_qt, causal,
      scale * 1.4426950408889634f);
  const cudaError_t launched = cudaGetLastError();
  if (launched == cudaSuccess) ++t_launches;
  return (int)launched;
}

template <bool kBF16, int D>
int launch16(const void* q, const void* k, const void* v, void* o, int b,
             int tn, int h, int causal, float scale, cudaStream_t stream) {
  return launch_tma<Smem16<D>>(flash_wgmma_kernel<kBF16, D>, q, k, v, o, b,
                               tn, h, D, kBF16, causal, scale, stream);
}

template <bool kBF16, int D>
int launch_big(const void* q, const void* k, const void* v, void* o, int b,
               int tn, int h, int causal, float scale, cudaStream_t stream) {
  return launch_tma<Big16<D>>(flash_big16_kernel<kBF16, D>, q, k, v, o, b,
                              tn, h, D, kBF16, causal, scale, stream);
}

// a kernel over a thread-block cluster of ncl CTAs a query tile (ncl
// consecutive blocks of gridDim.x); returns the first CUDA error
template <class Kernel, class... Args>
int launch_cluster(Kernel kernel, int n_blocks, int threads, uint32_t smem,
                   int ncl, cudaStream_t stream, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)n_blocks, 1, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ncl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = ncl > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return (int)err;
  err = cudaGetLastError();
  if (err == cudaSuccess) ++t_launches;
  return (int)err;
}

// every 16-bit width of the one-pass routes: 64, 128
// (flash_wgmma_kernel), 256 .. 512 (flash_big16_kernel); any other width
// is refused
template <bool kBF16>
int launch_any16(const void* q, const void* k, const void* v, void* o, int b,
                 int t, int h, int d, int causal, float scale,
                 cudaStream_t st) {
  switch (d) {
    case 64: return launch16<kBF16, 64>(q, k, v, o, b, t, h, causal, scale, st);
    case 128: return launch16<kBF16, 128>(q, k, v, o, b, t, h, causal, scale, st);
    case 256: return launch_big<kBF16, 256>(q, k, v, o, b, t, h, causal, scale, st);
    case 320: return launch_big<kBF16, 320>(q, k, v, o, b, t, h, causal, scale, st);
    case 384: return launch_big<kBF16, 384>(q, k, v, o, b, t, h, causal, scale, st);
    case 448: return launch_big<kBF16, 448>(q, k, v, o, b, t, h, causal, scale, st);
    case 512: return launch_big<kBF16, 512>(q, k, v, o, b, t, h, causal, scale, st);
  }
  return (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// f32 path: split-TF32 (3xTF32) wgmma + TMA at widths 64 .. 512
// ---------------------------------------------------------------------------

constexpr uint32_t kTf32Mask = 0xffffe000u;  // the bits a TF32 value keeps
constexpr int kConverters = 96;  // producer warps 1-3 build the planes

// flash_tf32_kernel's layouts: a CTA holds kW head-dim columns (its half
// of the head dim where a cluster of kCl_ = 2 CTAs serves a query tile)
// and kCons_ consumer warpgroups of 64 query rows; key tiles
// of kBN0 where it is given, else 32 where they fit, else 16.  The planes
// of a key tile, two stages of each: K's hi plane (keys x head dim, boxes
// of 32 columns, the low 13 bits cleared), K's lo plane in the same
// layout, and V's hi and lo planes transposed (head dim x keys, keys
// contiguous, in the permuted order of the P fragment).  TMA lands K and
// V raw in rings of kKS and kVS slots, and the converters build the
// planes from them, so the copies run ahead of the consumers; with kKS =
// 0 (where two K slots do not fit) K lands in its hi plane and is split
// in place.
template <int kW, int kCl_, int kCons_, int kBN0 = 0>
struct Tf32L {
  static constexpr int kCl = kCl_;                   // CTAs a query tile
  static constexpr int kDH = kW;                     // head-dim columns a CTA
  static constexpr int kCons = kCons_;
  static constexpr int kThreads = (kCons + 1) * 128;
  static constexpr int kBQ = 64 * kCons;             // query rows a CTA
  static constexpr int kBars = 21;
  // shared memory at key tiles of bn with ks raw K and vs raw V slots
  static constexpr uint32_t bytes_for(int bn, int ks, int vs) {
    return kDH / 32 * kBQ * 128u + (8u + ks + vs) * bn * kDH * 4u +
           (kCl > 1 ? kCons * 2u * (kCl - 1) * 64u * bn * 4u : 0u) +
           8u * kBars + kSwAtom;
  }
  static constexpr int kBN =
      kBN0 ? kBN0 : bytes_for(32, 0, 1) <= kSmemMax ? 32 : 16;
  static constexpr int kKS = bytes_for(kBN, 2, 2) <= kSmemMax ? 2 : 0;
  static constexpr int kVS = bytes_for(kBN, kKS, 2) <= kSmemMax ? 2 : 1;
  static constexpr int kBoxes = kDH / 32;            // 32-column TMA boxes
  static constexpr uint32_t kQBox = kBQ * 128u;
  static constexpr uint32_t kKBox = kBN * 128u;
  static constexpr uint32_t kPlane = kBoxes * kKBox;   // one tile of K or V
  // V^T: rows of up to 32 keys (128-byte swizzle), 16 keys at kBN = 16
  // (64-byte swizzle); kBN = 64 takes two such boxes
  static constexpr uint32_t kVtRow = (kBN < 32 ? kBN : 32) * 4u;
  static constexpr uint32_t kXSlot = 64u * kBN * 4u;   // a partial S
  // two slots a consumer warpgroup for each other CTA: consumer w's
  // slots of buffer x at kX + (2 w + x) (kCl - 1) kXSlot
  static constexpr uint32_t kXBytes =
      kCl > 1 ? kCons * 2 * (kCl - 1) * kXSlot : 0;
  static constexpr uint32_t kQ = 0;
  static constexpr uint32_t kKhi = kQ + kBoxes * kQBox;
  static constexpr uint32_t kKlo = kKhi + 2 * kPlane;
  static constexpr uint32_t kVthi = kKlo + 2 * kPlane;
  static constexpr uint32_t kVtlo = kVthi + 2 * kPlane;
  static constexpr uint32_t kKraw = kVtlo + 2 * kPlane;
  static constexpr uint32_t kVraw = kKraw + kKS * kPlane;
  static constexpr uint32_t kX = kVraw + kVS * kPlane;
  static constexpr uint32_t kBar = kX + kXBytes;
  static constexpr uint32_t kBytes = kBar + 8 * kBars + kSwAtom;
  static_assert(kDH % 32 == 0 && kCl >= 1 && kCl <= 2, "slice");
  static_assert(kBytes <= kSmemMax && kBytes == bytes_for(kBN, kKS, kVS),
                "shared memory");
};

// flash_tf32_kernel at kernel width D (64, 128, or a multiple of 64 from
// 256 to 512): one CTA up to 128, past it a cluster of two, each half of
// the head dim; two consumers where a CTA holds at most 160 columns
template <int D>
using Tf32 = Tf32L<D <= 128 ? D : D / 2, D <= 128 ? 1 : 2,
                   D <= 128 || D / 2 <= 160 ? 2 : 1, D == 64 ? 64 : 0>;

// what a CTA's slice of kDH columns (<= L::kDH) spans of layout L
template <class L, int kDH>
struct Tf32Slice {
  static constexpr int kBoxes = kDH / 32;
  static constexpr uint32_t kPlane = kBoxes * L::kKBox;   // bytes a tile
  static constexpr uint32_t kVtBox = kDH * L::kVtRow;
  // O columns a wgmma
  static constexpr int kOC = kDH % 128 == 0 ? 128 : kDH % 64 == 0 ? 64 : 32;
  static constexpr int kNO = kDH / kOC;
  static_assert(kDH % 32 == 0 && kDH <= L::kDH, "slice");
};

// the barriers after Tf32::kBar, 8 bytes each: q_full; per stage s of the
// planes k_ready (K's planes built), v_ready (V's), k_free (S done with
// K's planes), vt_free (P V done with V's); per raw slot k_full and v_full
// (landed; k_full per stage when kKS = 0), kraw_free and vraw_free
// (read); x_full[2 w + slot], the partials S the other CTAs' consumer w
// wrote here for consumer w
enum : int {
  kQFull = 0, kKFull = 1, kKReady = 3, kVReady = 5, kKFree = 7,
  kVtFree = 9, kVFull = 11, kVRawFree = 13, kKRawFree = 15, kXFull = 17
};
__device__ __forceinline__ uint32_t bar32(uint32_t bar0, int which, int i) {
  return bar0 + 8u * (uint32_t)(which + i);
}

template <class L>
__device__ __forceinline__ void init_tf32_barriers(uint32_t bar0) {
  mbar_init(bar32(bar0, kQFull, 0), 1);
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    mbar_init(bar32(bar0, kKFull, s), 1);
    mbar_init(bar32(bar0, kKReady, s), kConverters);
    mbar_init(bar32(bar0, kVReady, s), kConverters);
    mbar_init(bar32(bar0, kKFree, s), L::kCons * 128);
    mbar_init(bar32(bar0, kVtFree, s), L::kCons * 128);
    mbar_init(bar32(bar0, kVFull, s), 1);
    mbar_init(bar32(bar0, kVRawFree, s), kConverters);
    mbar_init(bar32(bar0, kKRawFree, s), kConverters);
  }
#pragma unroll
  for (int x = 0; x < 4; ++x)
    mbar_init(bar32(bar0, kXFull, x), 1);   // armed by its own consumer
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ float ld_shared_f32(uint32_t addr) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(v) : "r"(addr) : "memory");
  return v;
}
// orders this thread's generic-proxy writes to shared memory before
// later reads by the async proxy (wgmma, TMA)
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// x = hi + lo + (|x| 2**-22 at most): hi is x with its low 13 bits
// cleared, lo the rest (exact in f32) rounded to TF32, ties away
__device__ __forceinline__ uint32_t tf32_hi(float x) {
  return __float_as_uint(x) & kTf32Mask;
}
__device__ __forceinline__ uint32_t tf32_lo(float x, uint32_t hi) {
  uint32_t lo;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(lo) : "f"(x - __uint_as_float(hi)));
  return lo;
}

// K-major operand in shared memory with a 128-byte (row_bytes 128) or
// 64-byte (row_bytes 64) swizzle: 8 rows between core-matrix groups
__device__ __forceinline__ uint64_t desc_kmajor(uint32_t saddr,
                                                uint32_t row_bytes) {
  return (uint64_t)((saddr & 0x3FFFFu) >> 4) | (1ull << 16) |
         ((uint64_t)(((8u * row_bytes) >> 4) & 0x3FFFu) << 32) |
         ((row_bytes == 128 ? 1ull : 2ull) << 62);
}

#define RT_R8 "%0, %1, %2, %3, %4, %5, %6, %7"
#define RT_O8(d)                                           \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),          \
  "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
// D[64 x N] (+)= A[64 x 8] B[8 x N] in TF32, A in registers (4 words a
// thread: rows r, r + 8 x columns t, t + 4 of the warp's 16 rows), B
// K-major in shared memory; scale_d = 0 overwrites D.  TF32 has no
// transpose flag: both shared-memory operands must be K-major.
#define RT_RS_TF32(SHAPE, REGS, OUTS, A, B, P)                             \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, " P ", 0;\n"             \
               "wgmma.mma_async.sync.aligned." SHAPE ".f32.tf32.tf32 {"   \
               REGS "}, {" A "}, " B ", p, 1, 1;\n}\n"                    \
               : OUTS                                                     \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),     \
                 "r"(scale_d))
__device__ __forceinline__ void wgmma_tf32(float (&d)[8],
                                           const uint32_t (&a)[4],
                                           uint64_t db, int scale_d) {
  RT_RS_TF32("m64n16k8", RT_R8, RT_O8(d), "%8, %9, %10, %11", "%12", "%13");
}
__device__ __forceinline__ void wgmma_tf32(float (&d)[16],
                                           const uint32_t (&a)[4],
                                           uint64_t db, int scale_d) {
  RT_RS_TF32("m64n32k8", RT_R16, RT_O16(d), "%16, %17, %18, %19", "%20",
             "%21");
}
__device__ __forceinline__ void wgmma_tf32(float (&d)[32],
                                           const uint32_t (&a)[4],
                                           uint64_t db, int scale_d) {
  RT_RS_TF32("m64n64k8", RT_R32, RT_O32(d), "%32, %33, %34, %35", "%36",
             "%37");
}
__device__ __forceinline__ void wgmma_tf32(float (&d)[64],
                                           const uint32_t (&a)[4],
                                           uint64_t db, int scale_d) {
  RT_RS_TF32("m64n128k8", RT_R64, RT_O64(d), "%64, %65, %66, %67", "%68",
             "%69");
}

// One key tile's online-softmax step on an f32 S accumulator (as
// softmax_tile, S already scaled): p = 2**(S log2(e) - m) replaces S in
// place, unrounded.
template <int kN>
__device__ __forceinline__ void softmax32_tile(float (&s)[kN / 2],
                                               float (&m2)[2],
                                               float (&lsum)[2],
                                               float (&corr)[2], int k0,
                                               int row0, int r0, int c_lane,
                                               int tn, int causal) {
  constexpr float kLog2e = 1.4426950408889634f;
  if (k0 + kN > tn || (causal && k0 + kN - 1 > row0)) {
#pragma unroll
    for (int k = 0; k < kN / 8; ++k)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int col = k0 + 8 * k + c_lane + j;
          if (col >= tn || (causal && col > r0 + 8 * i))
            s[4 * k + 2 * i + j] = -INFINITY;
        }
  }
  float m_use[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float mx = -INFINITY;
#pragma unroll
    for (int k = 0; k < kN / 8; ++k)
      mx = fmaxf(mx, fmaxf(s[4 * k + 2 * i], s[4 * k + 2 * i + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));
    const float m_new = fmaxf(m2[i], mx * kLog2e);
    m_use[i] = m_new == -INFINITY ? 0.f : m_new;
    corr[i] = exp2_approx(m2[i] - m_use[i]);
    m2[i] = m_new;
    lsum[i] *= corr[i];
  }
#pragma unroll
  for (int k = 0; k < kN / 8; ++k)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float sv = s[4 * k + 2 * i + j];
        const float p =
            isfinite(sv) ? exp2_approx(fmaf(sv, kLog2e, -m_use[i])) : 0.f;
        lsum[i] += p;
        s[4 * k + 2 * i + j] = p;
      }
}

// K's hi and lo planes from a raw box of n16 float4 (in place when kraw is
// khi), converter ct of kConverters
__device__ __forceinline__ void k_planes(uint32_t kraw, uint32_t khi,
                                         uint32_t klo, int n16, int ct) {
  for (int i = ct; i < n16; i += kConverters) {
    const float4 x = ld_shared_v4(kraw + 16 * i);
    const uint32_t h0 = tf32_hi(x.x), h1 = tf32_hi(x.y);
    const uint32_t h2 = tf32_hi(x.z), h3 = tf32_hi(x.w);
    st_shared_v4(khi + 16 * i, __uint_as_float(h0), __uint_as_float(h1),
                 __uint_as_float(h2), __uint_as_float(h3));
    st_shared_v4(klo + 16 * i, __uint_as_float(tf32_lo(x.x, h0)),
                 __uint_as_float(tf32_lo(x.y, h1)),
                 __uint_as_float(tf32_lo(x.z, h2)),
                 __uint_as_float(tf32_lo(x.w, h3)));
  }
}

// V of a key tile (raw TMA boxes of layout L, kDH columns) transposed into
// its hi and lo planes, converter ct.  Block i: logical keys 4c .. 4c + 3
// (c = i % kC) x head-dim rows n .. n + 3.  Logical key 8q + l holds
// physical key 8q + 2l (l < 4) or 8q + 2(l - 4) + 1: the order of the P
// fragment (see the note)
template <class L, int kDH>
__device__ __forceinline__ void vt_planes(uint32_t vraw, uint32_t vthi,
                                          uint32_t vtlo, int ct) {
  using Sl = Tf32Slice<L, kDH>;
  constexpr int kC = L::kBN / 4;          // 4-key chunks of a V^T row
  for (int i = ct; i < kC * (kDH / 4); i += kConverters) {
    const int c = i % kC, n = 4 * (i / kC);
    const int j0 = 8 * (c >> 1) + (c & 1);
    float m[4][4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int j = j0 + 2 * e;
      const float4 r = ld_shared_v4(vraw + (n >> 5) * L::kKBox + j * 128 +
                                    ((((n & 31) >> 2) ^ (j & 7)) << 4));
      m[e][0] = r.x;
      m[e][1] = r.y;
      m[e][2] = r.z;
      m[e][3] = r.w;
    }
#pragma unroll
    for (int f = 0; f < 4; ++f) {
      const int row = n + f;
      const int swz = L::kVtRow == 128 ? (row & 7) : ((row >> 1) & 3);
      const uint32_t off = (c >> 3) * Sl::kVtBox + row * L::kVtRow +
                           (((c & 7) ^ swz) << 4);
      uint32_t hi[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) hi[e] = tf32_hi(m[e][f]);
      st_shared_v4(vthi + off, __uint_as_float(hi[0]),
                   __uint_as_float(hi[1]), __uint_as_float(hi[2]),
                   __uint_as_float(hi[3]));
      st_shared_v4(vtlo + off, __uint_as_float(tf32_lo(m[0][f], hi[0])),
                   __uint_as_float(tf32_lo(m[1][f], hi[1])),
                   __uint_as_float(tf32_lo(m[2][f], hi[2])),
                   __uint_as_float(tf32_lo(m[3][f], hi[3])));
    }
  }
}

// One 32-column batch of S = (Q scale) K^T into part (a consumer
// warpgroup's 64 rows x kN keys): per k8 slice Q_hi K_lo + Q_lo K_hi,
// then Q_hi K_hi, small products first; Q split in registers (16 words a
// thread stay live until the batch's products are done).  qa: this
// thread's row word tq of the batch's Q box (chunk 0; the swizzle moves
// chunk c to c ^ g); khi, klo: the batch's box of K's planes.  part is
// never written before its first product, which reads it with scale-d 0:
// safe because one wgmma chain is in flight at a time (the batch waits
// for its own); several chains in flight on unwritten accumulators gave
// wrong sums, so those would have to be zeroed first
template <int kN>
__device__ __forceinline__ void s_batch(float (&part)[kN / 2], uint32_t qa,
                                        uint32_t khi, uint32_t klo,
                                        float scale, int g) {
  uint32_t ah[4][4], al[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    // slice j: chunks 2j (columns tq) and 2j + 1 (tq + 4)
    const float v[4] = {
        ld_shared_f32(qa + (((2 * j) ^ g) << 4)) * scale,
        ld_shared_f32(qa + 1024 + (((2 * j) ^ g) << 4)) * scale,
        ld_shared_f32(qa + (((2 * j + 1) ^ g) << 4)) * scale,
        ld_shared_f32(qa + 1024 + (((2 * j + 1) ^ g) << 4)) * scale};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      ah[j][e] = tf32_hi(v[e]);
      al[j][e] = tf32_lo(v[e], ah[j][e]);
    }
  }
  wgmma_fence();
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    wgmma_tf32(part, ah[j], desc_kmajor(klo + j * 32, 128), j > 0);
    wgmma_tf32(part, al[j], desc_kmajor(khi + j * 32, 128), 1);
  }
#pragma unroll
  for (int j = 0; j < 4; ++j)
    wgmma_tf32(part, ah[j], desc_kmajor(khi + j * 32, 128), 1);
  wgmma_commit();
  wgmma_wait0();
  fence_regs(part);
}

// O = O corr + P V of one key tile, over a CTA's kDH columns of layout L:
// P as its TF32 hi and lo words (the S accumulator's fragment as it lies),
// V^T's planes at vthi, vtlo.  The accumulator holds keys 2t and 2t + 1
// of each 8-key slice where the A fragment wants t and t + 4, so the
// fragment is taken as it lies and V^T's keys are written in the matching
// order (logical 0..7 = physical 0, 2, 4, 6, 1, 3, 5, 7).  Each O chunk's
// P V sums into its own accumulator, small products first, folded into O
// by one f32 fma
template <class L, int kDH>
__device__ __forceinline__ void pv_fold(
    float (&acc_o)[Tf32Slice<L, kDH>::kNO][Tf32Slice<L, kDH>::kOC / 2],
    const uint32_t (&ph)[L::kBN / 2], const uint32_t (&pl)[L::kBN / 2],
    uint32_t vthi, uint32_t vtlo, const float (&corr)[2]) {
  using Sl = Tf32Slice<L, kDH>;
  constexpr int kBN = L::kBN, kNO = Sl::kNO, kOC = Sl::kOC;
#pragma unroll
  for (int c = 0; c < kNO; ++c) {
    float pv[kOC / 2];   // unwritten: first product scale-d 0, as part
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBN / 8; ++kk) {
      const uint32_t a_hi[4] = {ph[4 * kk], ph[4 * kk + 2], ph[4 * kk + 1],
                                ph[4 * kk + 3]};
      const uint32_t a_lo[4] = {pl[4 * kk], pl[4 * kk + 2], pl[4 * kk + 1],
                                pl[4 * kk + 3]};
      const uint32_t off = (kk >> 2) * Sl::kVtBox + (kk & 3) * 32 +
                           c * kOC * L::kVtRow;
      wgmma_tf32(pv, a_hi, desc_kmajor(vtlo + off, L::kVtRow), kk > 0);
      wgmma_tf32(pv, a_lo, desc_kmajor(vthi + off, L::kVtRow), 1);
    }
#pragma unroll
    for (int kk = 0; kk < kBN / 8; ++kk) {
      const uint32_t a_hi[4] = {ph[4 * kk], ph[4 * kk + 2], ph[4 * kk + 1],
                                ph[4 * kk + 3]};
      const uint32_t off = (kk >> 2) * Sl::kVtBox + (kk & 3) * 32 +
                           c * kOC * L::kVtRow;
      wgmma_tf32(pv, a_hi, desc_kmajor(vthi + off, L::kVtRow), 1);
    }
    wgmma_commit();
    wgmma_wait0();
    fence_regs(pv);
#pragma unroll
    for (int k = 0; k < kOC / 8; ++k)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          acc_o[c][4 * k + 2 * i + e] =
              fmaf(acc_o[c][4 * k + 2 * i + e], corr[i],
                   pv[4 * k + 2 * i + e]);
  }
}

// the TMA thread: Q once, then per key tile V and K into their raw slots;
// this CTA's kDH columns from col0
template <class L, int kDH>
__device__ __forceinline__ void tf32_produce(uint32_t base,
                                             const CUtensorMap* tm_q,
                                             const CUtensorMap* tm_k,
                                             const CUtensorMap* tm_v, int h,
                                             int b, int q0, int col0,
                                             int n_kt) {
  using Sl = Tf32Slice<L, kDH>;
  const uint32_t bar0 = base + L::kBar;
  const uint32_t qf = bar32(bar0, kQFull, 0);
  mbar_expect_tx(qf, Sl::kBoxes * L::kQBox);
#pragma unroll
  for (int x = 0; x < Sl::kBoxes; ++x)
    tma_load_4d(base + L::kQ + x * L::kQBox, tm_q, qf, col0 + 32 * x, h, q0,
                b);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int s = kt & 1, u = kt >> 1;
    const int vs = kt % L::kVS, vu = kt / L::kVS;
    if (vu > 0) mbar_wait(bar32(bar0, kVRawFree, vs), (vu - 1) & 1);
    const uint32_t vf = bar32(bar0, kVFull, vs);
    mbar_expect_tx(vf, Sl::kPlane);
#pragma unroll
    for (int x = 0; x < Sl::kBoxes; ++x)
      tma_load_4d(base + L::kVraw + vs * L::kPlane + x * L::kKBox, tm_v, vf,
                  col0 + 32 * x, h, kt * L::kBN, b);
    // K: into its raw slot, or with kKS = 0 into the stage's hi plane
    // once S of tile kt - 2 is done with it
    uint32_t dst;
    int ks = s;
    if constexpr (L::kKS > 0) {
      ks = kt % L::kKS;
      const int ku = kt / L::kKS;
      if (ku > 0) mbar_wait(bar32(bar0, kKRawFree, ks), (ku - 1) & 1);
      dst = base + L::kKraw + ks * L::kPlane;
    } else {
      if (u > 0) mbar_wait(bar32(bar0, kKFree, s), (u - 1) & 1);
      dst = base + L::kKhi + s * L::kPlane;
    }
    const uint32_t kf = bar32(bar0, kKFull, ks);
    mbar_expect_tx(kf, Sl::kPlane);
#pragma unroll
    for (int x = 0; x < Sl::kBoxes; ++x)
      tma_load_4d(dst + x * L::kKBox, tm_k, kf, col0 + 32 * x, h,
                  kt * L::kBN, b);
  }
}

// converter ct (0 .. 95): K's hi and lo planes from its raw slot (or in
// place); V transposed into its hi and lo planes
template <class L, int kDH>
__device__ __forceinline__ void tf32_convert(uint32_t base, int ct,
                                             int n_kt) {
  using Sl = Tf32Slice<L, kDH>;
  const uint32_t bar0 = base + L::kBar;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int s = kt & 1, u = kt >> 1;
    const int vs = kt % L::kVS, vu = kt / L::kVS;
    const uint32_t khi = base + L::kKhi + s * L::kPlane;
    const uint32_t klo = base + L::kKlo + s * L::kPlane;
    uint32_t kraw = khi;
    if constexpr (L::kKS > 0) {
      const int ks = kt % L::kKS;
      kraw = base + L::kKraw + ks * L::kPlane;
      mbar_wait(bar32(bar0, kKFull, ks), (kt / L::kKS) & 1);
      if (u > 0) mbar_wait(bar32(bar0, kKFree, s), (u - 1) & 1);
    } else {
      // k_full implies S of tile kt - 2 is done with both K planes (the
      // TMA thread waited on k_free before the copy)
      mbar_wait(bar32(bar0, kKFull, s), u & 1);
    }
    k_planes(kraw, khi, klo, (int)(Sl::kPlane / 16), ct);
    if constexpr (L::kKS > 0)
      mbar_arrive(bar32(bar0, kKRawFree, kt % L::kKS));
    fence_async_smem();
    mbar_arrive(bar32(bar0, kKReady, s));

    const uint32_t vraw = base + L::kVraw + vs * L::kPlane;
    const uint32_t vthi = base + L::kVthi + s * L::kPlane;
    const uint32_t vtlo = base + L::kVtlo + s * L::kPlane;
    mbar_wait(bar32(bar0, kVFull, vs), vu & 1);
    if (u > 0) mbar_wait(bar32(bar0, kVtFree, s), (u - 1) & 1);
    vt_planes<L, kDH>(vraw, vthi, vtlo, ct);
    mbar_arrive(bar32(bar0, kVRawFree, vs));
    fence_async_smem();
    mbar_arrive(bar32(bar0, kVReady, s));
  }
}

// consumer warpgroup wg: 64 query rows, this CTA's kDH columns of O
// (kernel width d, its columns from col0), of a cluster of ncl CTAs
template <class L, int kDH>
__device__ __forceinline__ void tf32_consume(
    uint32_t base, float* __restrict__ o, int wg, uint32_t rank,
    uint32_t ncl, int b, int h, int heads, int q0, int col0, int tn,
    int n_kt, int causal, float scale, int d) {
  using Sl = Tf32Slice<L, kDH>;
  constexpr int kBN = L::kBN, kNO = Sl::kNO, kOC = Sl::kOC;
  const uint32_t bar0 = base + L::kBar;
  const int t = threadIdx.x & 127, warp = t >> 5, lane = t & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int row_a = wg * 64 + warp * 16 + g;   // row in the CTA's tile
  const int row0 = q0 + wg * 64, r0 = q0 + row_a;
  // row_a's word tq of 16-byte chunk 0 (the swizzle moves chunk c to c ^ g)
  const uint32_t qa = base + L::kQ + row_a * 128 + tq * 4;

  float acc_o[kNO][kOC / 2];
#pragma unroll
  for (int j = 0; j < kNO; ++j)
#pragma unroll
    for (int i = 0; i < kOC / 2; ++i) acc_o[j][i] = 0.f;
  float m2[2] = {-INFINITY, -INFINITY};   // running max, log2 units
  float lsum[2] = {0.f, 0.f};             // this thread's part of l

  if constexpr (L::kCl > 1) {
    // arm both exchange slots for tiles 0 and 1
    if (t == 0) {
      mbar_expect_tx(bar32(bar0, kXFull, 2 * wg), (ncl - 1) * L::kXSlot);
      if (n_kt > 1)
        mbar_expect_tx(bar32(bar0, kXFull, 2 * wg + 1),
                       (ncl - 1) * L::kXSlot);
    }
  }

  mbar_wait(bar32(bar0, kQFull, 0), 0);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int s = kt & 1;
    const uint32_t par = (kt >> 1) & 1;
    const uint32_t khi = base + L::kKhi + s * L::kPlane;
    const uint32_t klo = base + L::kKlo + s * L::kPlane;

    // S = (Q scale) K^T in batches of one 32-column box (s_batch), each
    // added to S in f32 (see the note: the tensor core's sums truncate)
    float acc_s[kBN / 2], part[kBN / 2];
    mbar_wait(bar32(bar0, kKReady, s), par);
#pragma unroll
    for (int x = 0; x < Sl::kBoxes; ++x) {
      s_batch<kBN>(part, qa + x * L::kQBox, khi + x * L::kKBox,
                   klo + x * L::kKBox, scale, g);
#pragma unroll
      for (int i = 0; i < kBN / 2; ++i)
        acc_s[i] = x > 0 ? acc_s[i] + part[i] : part[i];
    }
    mbar_arrive(bar32(bar0, kKFree, s));

    if constexpr (L::kCl > 1) {
      // S = own partial + the other CTA's
      const int xs = 2 * wg + (kt & 1);
      cluster_sum_s(acc_s, base + L::kX + xs * (L::kCl - 1) * L::kXSlot,
                    bar32(bar0, kXFull, xs), (kt >> 1) & 1, rank, t,
                    kt + 2 < n_kt);
    }

    float corr[2];
    softmax32_tile<kBN>(acc_s, m2, lsum, corr, kt * kBN, row0, r0, 2 * tq,
                        tn, causal);
    // P split into TF32 hi and lo; O = O corr + P V
    uint32_t ph[kBN / 2], pl[kBN / 2];
#pragma unroll
    for (int i = 0; i < kBN / 2; ++i) {
      ph[i] = tf32_hi(acc_s[i]);
      pl[i] = tf32_lo(acc_s[i], ph[i]);
    }
    mbar_wait(bar32(bar0, kVReady, s), par);
    pv_fold<L, kDH>(acc_o, ph, pl, base + L::kVthi + s * L::kPlane,
                    base + L::kVtlo + s * L::kPlane, corr);
    mbar_arrive(bar32(bar0, kVtFree, s));
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = lsum[i];
    l += __shfl_xor_sync(kFull, l, 1);
    l += __shfl_xor_sync(kFull, l, 2);
    const float den = fmaxf(l, 1e-30f);
    const int row = r0 + 8 * i;
    if (row < tn) {
      float* orow =
          o + (((size_t)b * tn + row) * heads + h) * d + col0 + 2 * tq;
#pragma unroll
      for (int j = 0; j < kNO; ++j)
#pragma unroll
        for (int k = 0; k < kOC / 8; ++k)
          *reinterpret_cast<float2*>(orow + j * kOC + 8 * k) =
              make_float2(acc_o[j][4 * k + 2 * i] / den,
                          acc_o[j][4 * k + 2 * i + 1] / den);
    }
  }
}

// one CTA of the f32 kernels with layout L over a slice of kDH columns
// from col0: barriers, then one branch a role to the end, so setmaxnreg
// applies; no CTA of a cluster leaves while another may still reach its
// shared memory
template <class L, int kDH>
__device__ __forceinline__ void tf32_cta(
    uint32_t base, const CUtensorMap* tm_q, const CUtensorMap* tm_k,
    const CUtensorMap* tm_v, float* __restrict__ o, uint32_t rank,
    uint32_t ncl, int b, int h, int heads, int q0, int col0, int tn,
    int n_kt, int causal, float scale, int d) {
  const int tid = threadIdx.x, wg = tid >> 7;
  if (tid == 0) init_tf32_barriers<L>(base + L::kBar);
  // the other CTAs' barriers are initialised before anyone arrives there
  if constexpr (L::kCl > 1) cluster_sync();
  else __syncthreads();

  if (wg == L::kCons) {
    if constexpr (L::kCons == 2)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 56;\n" ::: "memory");
    const int pt = tid - L::kCons * 128;
    if (pt == 0)
      tf32_produce<L, kDH>(base, tm_q, tm_k, tm_v, h, b, q0, col0, n_kt);
    else if (pt >= 32)
      tf32_convert<L, kDH>(base, pt - 32, n_kt);
    if constexpr (L::kCl > 1) cluster_sync();
  } else {
    if constexpr (L::kCons == 2)
      asm volatile("setmaxnreg.inc.sync.aligned.u32 224;\n" ::: "memory");
    tf32_consume<L, kDH>(base, o, wg, rank, ncl, b, h, heads, q0, col0, tn,
                         n_kt, causal, scale, d);
    if constexpr (L::kCl > 1) cluster_sync();
  }
}

template <int D>
__global__ void __launch_bounds__(Tf32<D>::kThreads, 1)
flash_tf32_kernel(const __grid_constant__ CUtensorMap tm_q,
                  const __grid_constant__ CUtensorMap tm_k,
                  const __grid_constant__ CUtensorMap tm_v,
                  float* __restrict__ o, int tn, int heads, int bh_count,
                  int n_qt, int causal, float scale) {
  using L = Tf32<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + kSwAtom - 1) & ~(kSwAtom - 1);

  uint32_t rank = 0;
  if constexpr (L::kCl > 1) rank = cluster_rank();
  const int tile = (int)(blockIdx.x / (unsigned)L::kCl);
  const int qt = n_qt - 1 - tile / bh_count;
  const int bh = tile % bh_count;
  const int b = bh / heads, h = bh % heads, q0 = qt * L::kBQ;
  const int col0 = (int)rank * L::kDH;
  int n_kt = (tn + L::kBN - 1) / L::kBN;
  if (causal) n_kt = min(n_kt, (min(q0 + L::kBQ, tn) - 1) / L::kBN + 1);
  tf32_cta<L, L::kDH>(base, &tm_q, &tm_k, &tm_v, o, rank, L::kCl, b, h,
                      heads, q0, col0, tn, n_kt, causal, scale, D);
}

// (B, T, H, D) f32 tensor as a 4-d map (dims D, H, T, B), boxes of 32 x 1
// x rows x 1 (128 bytes wide) with the 128-byte swizzle
bool make_map32(CUtensorMap* map, const void* ptr, int b, int t, int h,
                int d, int rows) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)h, (cuuint64_t)t,
                              (cuuint64_t)b};
  const cuuint64_t strides[3] = {(cuuint64_t)d * 4, (cuuint64_t)h * d * 4,
                                 (cuuint64_t)t * h * d * 4};
  const cuuint32_t box[4] = {32, 1, (cuuint32_t)rows, 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<void*>(ptr),
             dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
int launch_tf32(const void* q, const void* k, const void* v, void* o, int b,
                int tn, int h, int causal, float scale, cudaStream_t stream) {
  using L = Tf32<D>;
  CUtensorMap mq, mk, mv;
  if (!make_map32(&mq, q, b, tn, h, D, L::kBQ) ||
      !make_map32(&mk, k, b, tn, h, D, L::kBN) ||
      !make_map32(&mv, v, b, tn, h, D, L::kBN))
    return (int)cudaErrorInvalidValue;
  const int n_qt = (tn + L::kBQ - 1) / L::kBQ;
  const long long grid = (long long)n_qt * b * h * L::kCl;
  if (grid > INT_MAX) return (int)cudaErrorInvalidValue;
  return launch_cluster(flash_tf32_kernel<D>, (int)grid, L::kThreads,
                        L::kBytes, L::kCl, stream, mq, mk, mv, (float*)o, tn,
                        h, b * h, n_qt, causal, scale);
}

// every f32 width of flash_tf32_kernel (64 .. 512); any other width is
// refused
int launch_any32(const void* q, const void* k, const void* v, void* o, int b,
                 int t, int h, int d, int causal, float scale,
                 cudaStream_t st) {
  switch (d) {
    case 64: return launch_tf32<64>(q, k, v, o, b, t, h, causal, scale, st);
    case 128: return launch_tf32<128>(q, k, v, o, b, t, h, causal, scale, st);
    case 256: return launch_tf32<256>(q, k, v, o, b, t, h, causal, scale, st);
    case 320: return launch_tf32<320>(q, k, v, o, b, t, h, causal, scale, st);
    case 384: return launch_tf32<384>(q, k, v, o, b, t, h, causal, scale, st);
    case 448: return launch_tf32<448>(q, k, v, o, b, t, h, causal, scale, st);
    case 512: return launch_tf32<512>(q, k, v, o, b, t, h, causal, scale, st);
  }
  return (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// past kernel width 512: two passes on wgmma + TMA, both dtypes
// ---------------------------------------------------------------------------
//
// The softmax is split into two kernels joined by a bounded score scratch
// in device memory (see the note at the head): a scores kernel computes
// S once per (query block, key tile) and the rows' max m; a values kernel
// reads S back for each slice of O's columns, takes p against the final m
// and multiplies P by the slice's V.  A query block is 128 rows (two
// consumers of 64).  f32 runs the pair in split TF32
// (flash_scores32_kernel, flash_values32_kernel), 16-bit inputs on their
// own type (flash_scores16_kernel, flash_values16_kernel); both write and
// read one scratch layout (f32 S by key tiles of 64, the maxima by split).

// the widest D of the one-pass routes (flash_big16_kernel,
// flash_tf32_kernel); past it both dtypes take the two passes
constexpr int kReach = 512;
constexpr int kSplitTiles = 4;            // key tiles a scores CTA computes
constexpr size_t kScratchCap = size_t(256) << 20;   // bytes of scores a chunk

// flash_scores32_kernel's layout: 128 query rows (two consumers of 64) x
// key tiles of 64; a ring of kStages steps, each one 32-column box of Q
// (128 rows) and of K (64 keys, split in place into its hi plane beside
// a lo plane)
struct Sc32 {
  static constexpr int kCons = 2;
  static constexpr int kThreads = (kCons + 1) * 128;
  static constexpr int kBQ = 128;
  static constexpr int kBN = 64;
  static constexpr int kStages = 6;
  static constexpr uint32_t kQBox = kBQ * 128u;
  static constexpr uint32_t kKBox = kBN * 128u;
  static constexpr uint32_t kQ = 0;
  static constexpr uint32_t kKhi = kQ + kStages * kQBox;
  static constexpr uint32_t kKlo = kKhi + kStages * kKBox;
  static constexpr uint32_t kBar = kKlo + kStages * kKBox;
  // barriers: full[s] (TMA bytes landed), ready[s] (K's planes built),
  // free[s] (both consumers done with the step)
  static constexpr uint32_t kBytes = kBar + 8 * 3 * kStages + kSwAtom;
  static_assert(kBytes <= kSmemMax, "shared memory");
};

// flash_values32_kernel's layout: 128 query rows (two consumers of 64) x
// a slice of at most kDH columns of O, key tiles of 32; a ring of kR raw
// stages (the block's S box, 128 rows x 32 keys, and V's boxes of the
// slice) and two stages of V^T's hi and lo planes.  kKBox, kVtRow and
// kDH are the names Tf32Slice, vt_planes and pv_fold read.
struct Val32 {
  static constexpr int kCons = 2;
  static constexpr int kThreads = (kCons + 1) * 128;
  static constexpr int kBQ = 128;
  static constexpr int kBN = 32;
  static constexpr int kR = 3;
  static constexpr int kDH = 192;
  static constexpr uint32_t kKBox = kBN * 128u;      // V: 32 keys x 32 cols
  static constexpr uint32_t kVtRow = kBN * 4u;
  static constexpr uint32_t kPlane = kDH / 32 * kKBox;
  static constexpr uint32_t kSBox = kBQ * 128u;      // S: 128 rows x 32 keys
  static constexpr uint32_t kVthi = 0;
  static constexpr uint32_t kVtlo = kVthi + 2 * kPlane;
  static constexpr uint32_t kS = kVtlo + 2 * kPlane;
  static constexpr uint32_t kVraw = kS + kR * kSBox;
  static constexpr uint32_t kBar = kVraw + kR * kPlane;
  // barriers: full[r], raw_free[r] (converters and consumers done with
  // raw stage r), ready[p] (V^T's planes built), vt_free[p]
  static constexpr uint32_t kBytes = kBar + 8 * (2 * kR + 4) + kSwAtom;
  static_assert(kBytes <= kSmemMax, "shared memory");
};

__device__ __forceinline__ void tma_load_2d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

__device__ __forceinline__ float2 ld_shared_v2(uint32_t addr) {
  float2 v;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n"
               : "=f"(v.x), "=f"(v.y)
               : "r"(addr)
               : "memory");
  return v;
}

// (b, h, first query row) of query block blk of b*h x n_qb: the blocks in
// reverse query order, so under causal masking the heaviest start first
struct BlockOf {
  int b, h, q0;
  __device__ BlockOf(int blk, int heads, int bh_count, int n_qb, int rows) {
    const int bh = blk % bh_count;
    b = bh / heads;
    h = bh % heads;
    q0 = (n_qb - 1 - blk / bh_count) * rows;
  }
};

// m of this thread's rows (row_a and row_a + 8 of its block): the max of
// the splits' maxima (a max is exact in any order), 0 where every key of
// the row is dead
__device__ __forceinline__ void final_max(const float* __restrict__ m_part,
                                          int local, int n_split, int row_a,
                                          float (&m_use)[2]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float m = -INFINITY;
    for (int sp = 0; sp < n_split; ++sp)
      m = fmaxf(m, m_part[((size_t)local * n_split + sp) * 128 + row_a +
                          8 * r]);
    m_use[r] = m == -INFINITY ? 0.f : m;
  }
}

// this thread's S fragment of a key tile of 32 (element 4k + 2i + j: row
// row_a + 8i, key 8k + 2tq + j) from the 128-byte-swizzled S box (128 rows
// x 32 keys f32) at sbox, then p = 2**(S log2(e) - m) in place against the
// final m, 0 where S is not finite; l sums exactly these p, in key-tile
// order (every slice's CTA adds the same numbers in the same order)
__device__ __forceinline__ void p_of_s_box(uint32_t sbox, int row_a, int g,
                                           int tq, const float (&m_use)[2],
                                           float (&p)[16], float (&lsum)[2]) {
  constexpr float kLog2e = 1.4426950408889634f;
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float2 x = ld_shared_v2(sbox + (row_a + 8 * i) * 128 +
                                    (((2 * k + (tq >> 1)) ^ g) << 4) +
                                    (tq & 1) * 8);
      p[4 * k + 2 * i] = x.x;
      p[4 * k + 2 * i + 1] = x.y;
    }
#pragma unroll
  for (int e = 0; e < 16; ++e) {
    const float sx = p[e];
    p[e] = isfinite(sx)
               ? exp2_approx(fmaf(sx, kLog2e, -m_use[(e >> 1) & 1]))
               : 0.f;
    lsum[(e >> 1) & 1] += p[e];
  }
}

// One CTA per (query block i0 + blockIdx.x / n_split, split
// blockIdx.x % n_split of its key tiles, kSplitTiles each): S = (Q scale)
// K^T over the whole head dim (d / 32 boxes) for each key tile of the
// split, into the scratch s_out (row local * 128 + r, key k at pitch
// floats a row), and each row's max of S log2(e) over the split into
// m_out[(local * n_split + split) * 128 + r].  Under causal masking a
// consumer skips the key tiles past its last row (they are neither
// computed nor stored) and masks only a tile that crosses the diagonal
// or the end of the sequence, to -inf.
__global__ void __launch_bounds__(Sc32::kThreads, 1)
flash_scores32_kernel(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_k,
                      float* __restrict__ s_out, float* __restrict__ m_out,
                      int tn, int heads, int bh_count, int n_qb, int i0,
                      int n_split, int pitch, int d, int causal,
                      float scale) {
  using L = Sc32;
  constexpr int kS = L::kStages;
  constexpr float kLog2e = 1.4426950408889634f;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + kSwAtom - 1) & ~(kSwAtom - 1);
  const int tid = threadIdx.x, wg = tid >> 7;
  const int local = (int)(blockIdx.x / (unsigned)n_split);
  const int split = (int)(blockIdx.x % (unsigned)n_split);
  const BlockOf blk(i0 + local, heads, bh_count, n_qb, L::kBQ);
  int n_kt = (tn + L::kBN - 1) / L::kBN;
  if (causal) n_kt = min(n_kt, (min(blk.q0 + L::kBQ, tn) - 1) / L::kBN + 1);
  const int kt0 = split * kSplitTiles, kt1 = min(n_kt, kt0 + kSplitTiles);
  float* m_rows = m_out + ((size_t)local * n_split + split) * L::kBQ;
  if (kt0 >= kt1) {   // every key tile of the split is past the diagonal
    if (tid < L::kBQ) m_rows[tid] = -INFINITY;
    return;
  }
  const int nbox = d / 32, n_steps = (kt1 - kt0) * nbox;
  const uint32_t bar0 = base + L::kBar;
  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < kS; ++s) {
      mbar_init(bar32(bar0, 0, s), 1);
      mbar_init(bar32(bar0, kS, s), kConverters);
      mbar_init(bar32(bar0, 2 * kS, s), L::kCons * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == L::kCons) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 56;\n" ::: "memory");
    const int pt = tid - L::kCons * 128;
    if (pt == 0) {
      // the TMA thread: per step a box of Q and of K into stage s
      for (int i = 0; i < n_steps; ++i) {
        const int s = i % kS, u = i / kS;
        if (u > 0) mbar_wait(bar32(bar0, 2 * kS, s), (u - 1) & 1);
        const int kt = kt0 + i / nbox, x = i % nbox;
        const uint32_t full = bar32(bar0, 0, s);
        mbar_expect_tx(full, L::kQBox + L::kKBox);
        tma_load_4d(base + L::kQ + s * L::kQBox, &tm_q, full, 32 * x, blk.h,
                    blk.q0, blk.b);
        tma_load_4d(base + L::kKhi + s * L::kKBox, &tm_k, full, 32 * x,
                    blk.h, kt * L::kBN, blk.b);
      }
    } else if (pt >= 32) {
      // converters: K's box split in place into its hi plane and a lo
      // plane (full[s] implies both consumers are done with the stage)
      for (int i = 0; i < n_steps; ++i) {
        const int s = i % kS;
        mbar_wait(bar32(bar0, 0, s), (i / kS) & 1);
        const uint32_t khi = base + L::kKhi + s * L::kKBox;
        k_planes(khi, khi, base + L::kKlo + s * L::kKBox,
                 (int)(L::kKBox / 16), pt - 32);
        fence_async_smem();
        mbar_arrive(bar32(bar0, kS, s));
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 224;\n" ::: "memory");
    const int t = tid & 127, warp = t >> 5, lane = t & 31;
    const int g = lane >> 2, tq = lane & 3;
    const int row_a = wg * 64 + warp * 16 + g;   // row in the block
    const int row0 = blk.q0 + wg * 64, r0 = blk.q0 + row_a;
    const uint32_t qa = base + L::kQ + row_a * 128 + tq * 4;
    float m2[2] = {-INFINITY, -INFINITY};   // max of S log2(e), this split
    float acc_s[L::kBN / 2], part[L::kBN / 2];
    int i = 0;
    for (int kt = kt0; kt < kt1; ++kt) {
      const int k0 = kt * L::kBN;
      const bool live = !causal || k0 <= row0 + 63;
      for (int x = 0; x < nbox; ++x, ++i) {
        const int s = i % kS;
        const uint32_t par = (i / kS) & 1;
        // ready: K's planes built; full too, for Q's TMA bytes, which this
        // thread reads with generic loads
        mbar_wait(bar32(bar0, kS, s), par);
        mbar_wait(bar32(bar0, 0, s), par);
        if (live) {
          s_batch<L::kBN>(part, qa + s * L::kQBox,
                          base + L::kKhi + s * L::kKBox,
                          base + L::kKlo + s * L::kKBox, scale, g);
#pragma unroll
          for (int e = 0; e < L::kBN / 2; ++e)
            acc_s[e] = x > 0 ? acc_s[e] + part[e] : part[e];
        }
        mbar_arrive(bar32(bar0, 2 * kS, s));
      }
      if (!live) continue;
      // element 4k + 2i + j: row r0 + 8i, key k0 + 8k + 2tq + j
      if (k0 + L::kBN > tn || (causal && k0 + L::kBN - 1 > row0)) {
#pragma unroll
        for (int k = 0; k < L::kBN / 8; ++k)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = k0 + 8 * k + 2 * tq + (e & 1);
            if (col >= tn || (causal && col > r0 + 8 * (e >> 1)))
              acc_s[4 * k + e] = -INFINITY;
          }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = -INFINITY;
#pragma unroll
        for (int k = 0; k < L::kBN / 8; ++k)
          mx = fmaxf(mx,
                     fmaxf(acc_s[4 * k + 2 * r], acc_s[4 * k + 2 * r + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));
        m2[r] = fmaxf(m2[r], mx * kLog2e);
        float* srow =
            s_out + ((size_t)local * L::kBQ + row_a + 8 * r) * pitch + k0 +
            2 * tq;
#pragma unroll
        for (int k = 0; k < L::kBN / 8; ++k)
          *reinterpret_cast<float2*>(srow + 8 * k) =
              make_float2(acc_s[4 * k + 2 * r], acc_s[4 * k + 2 * r + 1]);
      }
    }
    if (tq == 0) {
      m_rows[row_a] = m2[0];
      m_rows[row_a + 8] = m2[1];
    }
  }
}

// consumer warpgroup wg of a values CTA: 64 rows of the block, the
// slice's kDH columns of O from col0
template <int kDH>
__device__ __forceinline__ void values_consume(
    uint32_t base, const float* __restrict__ m_part, float* __restrict__ o,
    int wg, int local, int n_split, const BlockOf& blk, int heads, int col0,
    int tn, int n_kt, int causal, int d) {
  using L = Val32;
  using Sl = Tf32Slice<L, kDH>;
  constexpr int kR = L::kR, kNO = Sl::kNO, kOC = Sl::kOC;
  const uint32_t bar0 = base + L::kBar;
  const int t = threadIdx.x & 127, warp = t >> 5, lane = t & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int row_a = wg * 64 + warp * 16 + g;   // row in the block
  const int row0 = blk.q0 + wg * 64, r0 = blk.q0 + row_a;

  float m_use[2];
  final_max(m_part, local, n_split, row_a, m_use);
  float acc_o[kNO][kOC / 2];
#pragma unroll
  for (int j = 0; j < kNO; ++j)
#pragma unroll
    for (int e = 0; e < kOC / 2; ++e) acc_o[j][e] = 0.f;
  float lsum[2] = {0.f, 0.f};             // this thread's part of l
  const float one[2] = {1.f, 1.f};        // m is final: no rescale of O
  for (int kt = 0; kt < n_kt; ++kt) {
    const int r = kt % kR, p = kt & 1;
    const bool live = !causal || kt * L::kBN <= row0 + 63;
    mbar_wait(bar32(bar0, 0, r), (kt / kR) & 1);
    // p against the final m, split into TF32 hi and lo
    uint32_t p_hi[L::kBN / 2], p_lo[L::kBN / 2];
    if (live) {
      float px[L::kBN / 2];
      p_of_s_box(base + L::kS + r * L::kSBox, row_a, g, tq, m_use, px,
                 lsum);
#pragma unroll
      for (int e = 0; e < L::kBN / 2; ++e) {
        p_hi[e] = tf32_hi(px[e]);
        p_lo[e] = tf32_lo(px[e], p_hi[e]);
      }
    }
    mbar_wait(bar32(bar0, 2 * kR, p), (kt >> 1) & 1);
    if (live)
      pv_fold<L, kDH>(acc_o, p_hi, p_lo, base + L::kVthi + p * L::kPlane,
                      base + L::kVtlo + p * L::kPlane, one);
    mbar_arrive(bar32(bar0, 2 * kR + 2, p));
    // the raw stage goes back only now, after P V (the note: Layouts)
    mbar_arrive(bar32(bar0, kR, r));
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = lsum[i];
    l += __shfl_xor_sync(kFull, l, 1);
    l += __shfl_xor_sync(kFull, l, 2);
    const float den = fmaxf(l, 1e-30f);
    const int row = r0 + 8 * i;
    if (row < tn) {
      float* orow = o + (((size_t)blk.b * tn + row) * heads + blk.h) * d +
                    col0 + 2 * tq;
#pragma unroll
      for (int j = 0; j < kNO; ++j)
#pragma unroll
        for (int k = 0; k < kOC / 8; ++k)
          *reinterpret_cast<float2*>(orow + j * kOC + 8 * k) =
              make_float2(acc_o[j][4 * k + 2 * i] / den,
                          acc_o[j][4 * k + 2 * i + 1] / den);
    }
  }
}

// one values CTA over a slice of kDH columns from col0: barriers, then
// the TMA thread (per key tile the block's S box and the slice's V
// boxes), the converters (V^T's planes) and the two consumers
template <int kDH>
__device__ __forceinline__ void values_cta(
    uint32_t base, const CUtensorMap* tm_s, const CUtensorMap* tm_v,
    const float* __restrict__ m_part, float* __restrict__ o, int local,
    int n_split, const BlockOf& blk, int heads, int col0, int tn, int n_kt,
    int causal, int d) {
  using L = Val32;
  using Sl = Tf32Slice<L, kDH>;
  constexpr int kR = L::kR;
  const int tid = threadIdx.x, wg = tid >> 7;
  const uint32_t bar0 = base + L::kBar;
  if (tid == 0) {
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      mbar_init(bar32(bar0, 0, r), 1);
      mbar_init(bar32(bar0, kR, r), kConverters + L::kCons * 128);
    }
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      mbar_init(bar32(bar0, 2 * kR, p), kConverters);
      mbar_init(bar32(bar0, 2 * kR + 2, p), L::kCons * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == L::kCons) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 56;\n" ::: "memory");
    const int pt = tid - L::kCons * 128;
    if (pt == 0) {
      for (int kt = 0; kt < n_kt; ++kt) {
        const int r = kt % kR, u = kt / kR;
        if (u > 0) mbar_wait(bar32(bar0, kR, r), (u - 1) & 1);
        const uint32_t full = bar32(bar0, 0, r);
        mbar_expect_tx(full, L::kSBox + Sl::kPlane);
        tma_load_2d(base + L::kS + r * L::kSBox, tm_s, full, kt * L::kBN,
                    local * L::kBQ);
#pragma unroll
        for (int x = 0; x < Sl::kBoxes; ++x)
          tma_load_4d(base + L::kVraw + r * L::kPlane + x * L::kKBox, tm_v,
                      full, col0 + 32 * x, blk.h, kt * L::kBN, blk.b);
      }
    } else if (pt >= 32) {
      for (int kt = 0; kt < n_kt; ++kt) {
        const int r = kt % kR, p = kt & 1;
        mbar_wait(bar32(bar0, 0, r), (kt / kR) & 1);
        if (kt >= 2)
          mbar_wait(bar32(bar0, 2 * kR + 2, p), ((kt >> 1) - 1) & 1);
        vt_planes<L, kDH>(base + L::kVraw + r * L::kPlane,
                          base + L::kVthi + p * L::kPlane,
                          base + L::kVtlo + p * L::kPlane, pt - 32);
        mbar_arrive(bar32(bar0, kR, r));
        fence_async_smem();
        mbar_arrive(bar32(bar0, 2 * kR, p));
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 224;\n" ::: "memory");
    values_consume<kDH>(base, m_part, o, wg, local, n_split, blk, heads,
                        col0, tn, n_kt, causal, d);
  }
}

// One CTA per (query block i0 + blockIdx.x / n_sl, slice blockIdx.x %
// n_sl of O's columns: the d / 32 boxes over n_sl slices as evenly as
// they go, the first ones one box more, 5 or 6 boxes each), reading the
// block's S from the scratch through tm_s and m from m_part
__global__ void __launch_bounds__(Val32::kThreads, 1)
flash_values32_kernel(const __grid_constant__ CUtensorMap tm_s,
                      const __grid_constant__ CUtensorMap tm_v,
                      const float* __restrict__ m_part, float* __restrict__ o,
                      int tn, int heads, int bh_count, int n_qb, int i0,
                      int n_split, int n_sl, int d, int causal) {
  using L = Val32;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + kSwAtom - 1) & ~(kSwAtom - 1);
  const int local = (int)(blockIdx.x / (unsigned)n_sl);
  const int sl = (int)(blockIdx.x % (unsigned)n_sl);
  const BlockOf blk(i0 + local, heads, bh_count, n_qb, L::kBQ);
  const int nx = d / 32, small = nx / n_sl, extra = nx % n_sl;
  const int col0 = 32 * (sl * small + min(sl, extra));
  int n_kt = (tn + L::kBN - 1) / L::kBN;
  if (causal) n_kt = min(n_kt, (min(blk.q0 + L::kBQ, tn) - 1) / L::kBN + 1);
  if (small + (sl < extra) == L::kDH / 32)
    values_cta<L::kDH>(base, &tm_s, &tm_v, m_part, o, local, n_split, blk,
                       heads, col0, tn, n_kt, causal, d);
  else
    values_cta<L::kDH - 32>(base, &tm_s, &tm_v, m_part, o, local, n_split,
                            blk, heads, col0, tn, n_kt, causal, d);
}

// flash_scores16_kernel's layout: 128 query rows (two consumers of 64) x
// a split's kSplitTiles key tiles of 64 at once; a ring of kStages steps,
// each one 64-column box of Q (128 rows) and of K for each key tile of the
// split (64 keys).  The tiles and the block are Sc32's: one scratch layout
struct Sc16 {
  static constexpr int kCons = 2;
  static constexpr int kThreads = (kCons + 1) * 128;
  static constexpr int kBQ = 128;
  static constexpr int kBN = 64;
  static constexpr int kStages = 4;
  static constexpr uint32_t kQBox = kBQ * kRowBytes;
  static constexpr uint32_t kKBox = kBN * kRowBytes;
  static constexpr uint32_t kStage = kQBox + kSplitTiles * kKBox;
  static constexpr uint32_t kBar = kStages * kStage;
  // barriers: full[s] (TMA bytes landed), free[s] (both consumers' products
  // of the step done)
  static constexpr uint32_t kBytes = kBar + 8 * 2 * kStages + kSwAtom;
  static_assert(kBQ == Sc32::kBQ && kBN == Sc32::kBN, "scratch layout");
  static_assert(kBytes <= kSmemMax, "shared memory");
};

// flash_values16_kernel's layout: 128 query rows (two consumers of 64) x
// a slice of at most kNB 64-column boxes of O (256 columns: 128 f32
// registers a consumer thread, wgmma's widest N), key tiles of 32; a ring
// of kR stages, each the block's S box (128 rows x 32 keys f32, as Val32)
// and the slice's V boxes (32 keys x 64 columns), read MN-major
struct Val16 {
  static constexpr int kCons = 2;
  static constexpr int kThreads = (kCons + 1) * 128;
  static constexpr int kBQ = 128;
  static constexpr int kBN = 32;
  static constexpr int kNB = 4;
  static constexpr int kR = 6;
  static constexpr uint32_t kSBox = kBQ * 128u;
  static constexpr uint32_t kVBox = kBN * kRowBytes;
  static constexpr uint32_t kStage = kSBox + kNB * kVBox;
  static constexpr uint32_t kBar = kR * kStage;
  // barriers: full[r] (TMA bytes landed), free[r] (both consumers' P V of
  // the stage done)
  static constexpr uint32_t kBytes = kBar + 8 * 2 * kR + kSwAtom;
  static_assert(kBQ == Val32::kBQ && kBN == Val32::kBN, "scratch map");
  static_assert(kBytes <= kSmemMax, "shared memory");
};

// One CTA per (query block i0 + blockIdx.x / n_split, split
// blockIdx.x % n_split of its key tiles, kSplitTiles of 64 each), as
// flash_scores32_kernel, on 16-bit Q and K: per key tile S = Q K^T over
// the whole head dim (d / 64 boxes) as one chain of m64n64k16 wgmma into
// an f32 accumulator (the 16-bit kernels' arithmetic), then times the
// scale in f32 (never a 16-bit Q); the split's tiles run side by side, so
// each step's Q box is read once for all of them.  Writes S (scaled) and
// each row's max of S log2(e) over the split to the scratch, in the f32
// pair's layout; a consumer skips the key tiles past its last row.
template <bool kBF16>
__global__ void __launch_bounds__(Sc16::kThreads, 1)
flash_scores16_kernel(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_k,
                      float* __restrict__ s_out, float* __restrict__ m_out,
                      int tn, int heads, int bh_count, int n_qb, int i0,
                      int n_split, int pitch, int d, int causal,
                      float scale) {
  using L = Sc16;
  constexpr int kS = L::kStages, kNT = kSplitTiles;
  constexpr float kLog2e = 1.4426950408889634f;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + kSwAtom - 1) & ~(kSwAtom - 1);
  const int tid = threadIdx.x, wg = tid >> 7;
  const int local = (int)(blockIdx.x / (unsigned)n_split);
  const int split = (int)(blockIdx.x % (unsigned)n_split);
  const BlockOf blk(i0 + local, heads, bh_count, n_qb, L::kBQ);
  int n_kt = (tn + L::kBN - 1) / L::kBN;
  if (causal) n_kt = min(n_kt, (min(blk.q0 + L::kBQ, tn) - 1) / L::kBN + 1);
  const int kt0 = split * kNT, nt = min(n_kt, kt0 + kNT) - kt0;
  float* m_rows = m_out + ((size_t)local * n_split + split) * L::kBQ;
  if (nt <= 0) {   // every key tile of the split is past the diagonal
    if (tid < L::kBQ) m_rows[tid] = -INFINITY;
    return;
  }
  const int nbox = d / 64;
  const uint32_t bar0 = base + L::kBar;
  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < kS; ++s) {
      mbar_init(bar32(bar0, 0, s), 1);
      mbar_init(bar32(bar0, kS, s), L::kCons * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == L::kCons) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (tid == L::kCons * 128) {
      // the TMA thread: per step box x of Q and of each live key tile's K
      for (int x = 0; x < nbox; ++x) {
        const int s = x % kS, u = x / kS;
        if (u > 0) mbar_wait(bar32(bar0, kS, s), (u - 1) & 1);
        const uint32_t full = bar32(bar0, 0, s), st = base + s * L::kStage;
        mbar_expect_tx(full, L::kQBox + nt * L::kKBox);
        tma_load_4d(st, &tm_q, full, 64 * x, blk.h, blk.q0, blk.b);
        for (int j = 0; j < nt; ++j)
          tma_load_4d(st + L::kQBox + j * L::kKBox, &tm_k, full, 64 * x,
                      blk.h, (kt0 + j) * L::kBN, blk.b);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int t = tid & 127, warp = t >> 5, lane = t & 31;
    const int tq = lane & 3;
    const int row_a = wg * 64 + warp * 16 + (lane >> 2);   // row in block
    const int row0 = blk.q0 + wg * 64, r0 = blk.q0 + row_a;
    // the split's key tiles this consumer's rows reach
    const int live =
        causal ? max(0, min(nt, (row0 + 63) / L::kBN - kt0 + 1)) : nt;
    // several chains in flight: zeroed first, never started on scale-d 0
    float acc[kNT][L::kBN / 2];
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < L::kBN / 2; ++e) acc[j][e] = 0.f;
    const uint32_t qw = wg * 64 * kRowBytes;
    for (int x = 0; x < nbox; ++x) {
      const int s = x % kS;
      const uint32_t st = base + s * L::kStage;
      mbar_wait(bar32(bar0, 0, s), (x / kS) & 1);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < kNT; ++j)
        if (j < live)
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            wgmma_ss<kBF16>(
                acc[j], desc_sw128(st + qw + kk * 32, 16, kSwAtom),
                desc_sw128(st + L::kQBox + j * L::kKBox + kk * 32, 16,
                           kSwAtom),
                1);
      wgmma_commit();
      // the previous step's products are done: its stage goes back
      wgmma_wait1();
      if (x > 0) mbar_arrive(bar32(bar0, kS, (x - 1) % kS));
    }
    wgmma_wait0();
#pragma unroll
    for (int j = 0; j < kNT; ++j) fence_regs(acc[j]);

    float m2[2] = {-INFINITY, -INFINITY};   // max of S log2(e), this split
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      if (j >= live) continue;
      const int k0 = (kt0 + j) * L::kBN;
#pragma unroll
      for (int e = 0; e < L::kBN / 2; ++e) acc[j][e] *= scale;
      // element 4k + 2i + e: row r0 + 8i, key k0 + 8k + 2tq + e
      if (k0 + L::kBN > tn || (causal && k0 + L::kBN - 1 > row0)) {
#pragma unroll
        for (int k = 0; k < L::kBN / 8; ++k)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = k0 + 8 * k + 2 * tq + (e & 1);
            if (col >= tn || (causal && col > r0 + 8 * (e >> 1)))
              acc[j][4 * k + e] = -INFINITY;
          }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = -INFINITY;
#pragma unroll
        for (int k = 0; k < L::kBN / 8; ++k)
          mx = fmaxf(mx, fmaxf(acc[j][4 * k + 2 * r],
                               acc[j][4 * k + 2 * r + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));
        m2[r] = fmaxf(m2[r], mx * kLog2e);
        float* srow =
            s_out + ((size_t)local * L::kBQ + row_a + 8 * r) * pitch + k0 +
            2 * tq;
#pragma unroll
        for (int k = 0; k < L::kBN / 8; ++k)
          *reinterpret_cast<float2*>(srow + 8 * k) = make_float2(
              acc[j][4 * k + 2 * r], acc[j][4 * k + 2 * r + 1]);
      }
    }
    if (tq == 0) {
      m_rows[row_a] = m2[0];
      m_rows[row_a + 8] = m2[1];
    }
  }
}

// consumer warpgroup wg of a 16-bit values CTA: 64 rows of the block, the
// slice's kNB boxes of O from col0.  Per key tile p (f32, against the
// final m) from the S box, l summed from those p in key-tile order, P
// rounded to 16 bits in registers (the S fragment is the A fragment, as
// in flash_wgmma_kernel) and O += P V by wgmma with V read MN-major; the p
// of tile kt are taken while P V of tile kt - 1 is in flight
template <bool kBF16, int kNB>
__device__ __forceinline__ void values16_consume(
    uint32_t base, const float* __restrict__ m_part,
    uint16_t* __restrict__ o, int wg, int local, int n_split,
    const BlockOf& blk, int heads, int col0, int tn, int n_kt, int causal,
    int d) {
  using L = Val16;
  constexpr int kR = L::kR;
  const uint32_t bar0 = base + L::kBar;
  const int t = threadIdx.x & 127, warp = t >> 5, lane = t & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int row_a = wg * 64 + warp * 16 + g;   // row in the block
  const int row0 = blk.q0 + wg * 64, r0 = blk.q0 + row_a;

  float m_use[2];
  final_max(m_part, local, n_split, row_a, m_use);
  float acc_o[kNB][32];
#pragma unroll
  for (int j = 0; j < kNB; ++j)
#pragma unroll
    for (int e = 0; e < 32; ++e) acc_o[j][e] = 0.f;
  float lsum[2] = {0.f, 0.f};             // this thread's part of l
  uint32_t pa[L::kBN / 4] = {};           // P, the A fragments of 2 k16
  for (int kt = 0; kt < n_kt; ++kt) {
    const int r = kt % kR;
    const bool live = !causal || kt * L::kBN <= row0 + 63;
    const uint32_t st = base + r * L::kStage;
    mbar_wait(bar32(bar0, 0, r), (kt / kR) & 1);
    float p[L::kBN / 2];
    if (live) p_of_s_box(st, row_a, g, tq, m_use, p, lsum);
    // P V of tile kt - 1 is done: its stage goes back, P's registers free
    wgmma_wait0();
#pragma unroll
    for (int j = 0; j < kNB; ++j) fence_regs(acc_o[j]);
#pragma unroll
    for (int i = 0; i < L::kBN / 4; ++i) asm volatile("" : "+r"(pa[i]));
    if (kt > 0) mbar_arrive(bar32(bar0, kR, (kt - 1) % kR));
    if (!live) continue;
#pragma unroll
    for (int k = 0; k < L::kBN / 8; ++k)
#pragma unroll
      for (int i = 0; i < 2; ++i)
        pa[(k >> 1) * 4 + (k & 1) * 2 + i] =
            pack2<kBF16>(p[4 * k + 2 * i], p[4 * k + 2 * i + 1]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < L::kBN / 16; ++kk) {
      const uint32_t a[4] = {pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2],
                             pa[4 * kk + 3]};
#pragma unroll
      for (int j = 0; j < kNB; ++j)
        wgmma_rs<kBF16>(acc_o[j], a,
                        desc_sw128(st + L::kSBox + j * L::kVBox +
                                       kk * 16 * kRowBytes,
                                   L::kVBox, kSwAtom));
    }
    wgmma_commit();
  }
  wgmma_wait0();
#pragma unroll
  for (int j = 0; j < kNB; ++j) fence_regs(acc_o[j]);

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = lsum[i];
    l += __shfl_xor_sync(kFull, l, 1);
    l += __shfl_xor_sync(kFull, l, 2);
    const float den = fmaxf(l, 1e-30f);
    const int row = r0 + 8 * i;
    if (row < tn) {
      uint16_t* orow = o + (((size_t)blk.b * tn + row) * heads + blk.h) * d +
                       col0 + 2 * tq;
#pragma unroll
      for (int j = 0; j < kNB; ++j)
#pragma unroll
        for (int k = 0; k < 8; ++k)
          *reinterpret_cast<uint32_t*>(orow + 64 * j + 8 * k) =
              pack2<kBF16>(acc_o[j][4 * k + 2 * i] / den,
                           acc_o[j][4 * k + 2 * i + 1] / den);
    }
  }
}

// one 16-bit values CTA over a slice of kNB boxes from col0: barriers,
// then the TMA thread (per key tile the block's S box and the slice's V
// boxes) and the two consumers
template <bool kBF16, int kNB>
__device__ __forceinline__ void values16_cta(
    uint32_t base, const CUtensorMap* tm_s, const CUtensorMap* tm_v,
    const float* __restrict__ m_part, uint16_t* __restrict__ o, int local,
    int n_split, const BlockOf& blk, int heads, int col0, int tn, int n_kt,
    int causal, int d) {
  using L = Val16;
  constexpr int kR = L::kR;
  const int tid = threadIdx.x, wg = tid >> 7;
  const uint32_t bar0 = base + L::kBar;
  if (tid == 0) {
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      mbar_init(bar32(bar0, 0, r), 1);
      mbar_init(bar32(bar0, kR, r), L::kCons * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == L::kCons) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (tid == L::kCons * 128) {
      for (int kt = 0; kt < n_kt; ++kt) {
        const int r = kt % kR, u = kt / kR;
        if (u > 0) mbar_wait(bar32(bar0, kR, r), (u - 1) & 1);
        const uint32_t full = bar32(bar0, 0, r), st = base + r * L::kStage;
        mbar_expect_tx(full, L::kSBox + kNB * L::kVBox);
        tma_load_2d(st, tm_s, full, kt * L::kBN, local * L::kBQ);
#pragma unroll
        for (int x = 0; x < kNB; ++x)
          tma_load_4d(st + L::kSBox + x * L::kVBox, tm_v, full,
                      col0 + 64 * x, blk.h, kt * L::kBN, blk.b);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    values16_consume<kBF16, kNB>(base, m_part, o, wg, local, n_split, blk,
                                 heads, col0, tn, n_kt, causal, d);
  }
}

// One CTA per (query block i0 + blockIdx.x / n_sl, slice blockIdx.x %
// n_sl of O's columns: the d / 64 boxes over n_sl = ceil(d / 256) slices
// as evenly as they go, the first ones one box more; past 512 that is 3
// or 4 boxes a slice), reading the block's S from the scratch through
// tm_s and m from m_part
template <bool kBF16>
__global__ void __launch_bounds__(Val16::kThreads, 1)
flash_values16_kernel(const __grid_constant__ CUtensorMap tm_s,
                      const __grid_constant__ CUtensorMap tm_v,
                      const float* __restrict__ m_part,
                      uint16_t* __restrict__ o, int tn, int heads,
                      int bh_count, int n_qb, int i0, int n_split, int n_sl,
                      int d, int causal) {
  using L = Val16;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + kSwAtom - 1) & ~(kSwAtom - 1);
  const int local = (int)(blockIdx.x / (unsigned)n_sl);
  const int sl = (int)(blockIdx.x % (unsigned)n_sl);
  const BlockOf blk(i0 + local, heads, bh_count, n_qb, L::kBQ);
  const int nx = d / 64, small = nx / n_sl, extra = nx % n_sl;
  const int col0 = 64 * (sl * small + min(sl, extra));
  int n_kt = (tn + L::kBN - 1) / L::kBN;
  if (causal) n_kt = min(n_kt, (min(blk.q0 + L::kBQ, tn) - 1) / L::kBN + 1);
  if (small + (sl < extra) == L::kNB)
    values16_cta<kBF16, L::kNB>(base, &tm_s, &tm_v, m_part, o, local,
                                n_split, blk, heads, col0, tn, n_kt, causal,
                                d);
  else
    values16_cta<kBF16, L::kNB - 1>(base, &tm_s, &tm_v, m_part, o, local,
                                    n_split, blk, heads, col0, tn, n_kt,
                                    causal, d);
}

// The two-pass route's plan for (b, t, h): query blocks of 128 rows in
// chunks whose scores fit kScratchCap, at least one block a chunk.  A
// block's scratch: its S (128 rows x pitch keys, pitch = t rounded up to
// the scores' key tile) and its rows' per-split maxima; the scratch holds
// one chunk (the first `per_chunk` blocks' S, then their maxima), so it
// is at most the larger of the cap and one block's scratch.  False where
// the blocks pass the grid's int index.
struct TwoPass {
  long long blocks, per_chunk, bytes;
  int n_qb, pitch, n_split;
};
bool twopass_plan(int b, int t, int h, TwoPass* p) {
  p->n_qb = (t + Sc32::kBQ - 1) / Sc32::kBQ;
  const int n_kt = (t + Sc32::kBN - 1) / Sc32::kBN;
  p->pitch = n_kt * Sc32::kBN;
  p->n_split = (n_kt + kSplitTiles - 1) / kSplitTiles;
  p->blocks = (long long)b * h * p->n_qb;
  const long long block_bytes =
      4ll * Sc32::kBQ * ((long long)p->pitch + p->n_split);
  p->per_chunk = std::min<long long>(
      p->blocks,
      std::max<long long>(1, (long long)kScratchCap / block_bytes));
  if (p->blocks > INT_MAX) return false;
  p->bytes = p->per_chunk * block_bytes;
  return true;
}

// the scratch's scores as a 2-d map (dims keys, rows; strides in bytes),
// boxes of 32 keys x 128 rows with the 128-byte swizzle
bool make_map_s(CUtensorMap* map, const float* ptr, int pitch,
                long long rows) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)pitch, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)pitch * 4};
  const cuuint32_t box[2] = {32, (cuuint32_t)Val32::kBQ};
  const cuuint32_t estr[2] = {1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(ptr),
             dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// a pair of kernels once per chunk, in stream order on one scratch (the
// next chunk's scores kernel starts after this chunk's values kernel has
// read it), n_sl values CTAs a block; returns the first CUDA error
template <class Scores, class Values, class Out>
int twopass_chunks(Scores scores, int sc_threads, uint32_t sc_bytes,
                   Values values, int va_threads, uint32_t va_bytes,
                   int n_sl, const TwoPass& p, const CUtensorMap& mq,
                   const CUtensorMap& mk, const CUtensorMap& mv,
                   const CUtensorMap& ms, float* s_buf, float* m_buf, Out* o,
                   int b, int tn, int h, int d, int causal, float scale,
                   cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      scores, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sc_bytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        values, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)va_bytes);
  if (err != cudaSuccess) return (int)err;
  for (long long i0 = 0; i0 < p.blocks; i0 += p.per_chunk) {
    const long long n = std::min(p.per_chunk, p.blocks - i0);
    if (n * p.n_split > INT_MAX || n * n_sl > INT_MAX)
      return (int)cudaErrorInvalidValue;
    scores<<<(unsigned)(n * p.n_split), sc_threads, sc_bytes, stream>>>(
        mq, mk, s_buf, m_buf, tn, h, b * h, p.n_qb, (int)i0, p.n_split,
        p.pitch, d, causal, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    ++t_launches;
    values<<<(unsigned)(n * n_sl), va_threads, va_bytes, stream>>>(
        ms, mv, m_buf, o, tn, h, b * h, p.n_qb, (int)i0, p.n_split, n_sl, d,
        causal);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    ++t_launches;
  }
  return (int)cudaSuccess;
}

// the two-pass route of a dtype (0 = float32: flash_scores32_kernel and
// flash_values32_kernel; 1 = float16, 2 = bfloat16: flash_scores16_kernel
// and flash_values16_kernel) on one plan and one scratch
int launch_twopass(const void* q, const void* k, const void* v, void* o,
                   int b, int tn, int h, int d, int dtype, int causal,
                   float scale, void* scratch, cudaStream_t stream) {
  TwoPass p;
  if (!twopass_plan(b, tn, h, &p) || scratch == nullptr ||
      reinterpret_cast<uintptr_t>(scratch) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  float* s_buf = static_cast<float*>(scratch);
  float* m_buf = s_buf + p.per_chunk * Sc32::kBQ * (long long)p.pitch;
  const bool bf16 = dtype == 2;
  CUtensorMap mq, mk, mv, ms;
  const bool mapped =
      dtype == 0 ? make_map32(&mq, q, b, tn, h, d, Sc32::kBQ) &&
                       make_map32(&mk, k, b, tn, h, d, Sc32::kBN) &&
                       make_map32(&mv, v, b, tn, h, d, Val32::kBN)
                 : make_map(&mq, q, b, tn, h, d, bf16, Sc16::kBQ) &&
                       make_map(&mk, k, b, tn, h, d, bf16, Sc16::kBN) &&
                       make_map(&mv, v, b, tn, h, d, bf16, Val16::kBN);
  if (!mapped || !make_map_s(&ms, s_buf, p.pitch, p.per_chunk * Val32::kBQ))
    return (int)cudaErrorInvalidValue;
  // the values kernels' slices: the boxes as evenly as they go over as
  // few slices as hold at most a slice's instance each, which also has an
  // instance one box narrower (true past kReach; refused elsewhere)
  const int box = dtype == 0 ? 32 : 64;
  const int most = dtype == 0 ? Val32::kDH / 32 : Val16::kNB;
  const int n_sl = (d / box + most - 1) / most;
  if (d / box / n_sl < most - 1) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return twopass_chunks(flash_scores32_kernel, Sc32::kThreads,
                          Sc32::kBytes, flash_values32_kernel,
                          Val32::kThreads, Val32::kBytes, n_sl, p, mq, mk,
                          mv, ms, s_buf, m_buf, (float*)o, b, tn, h, d,
                          causal, scale, stream);
  if (bf16)
    return twopass_chunks(flash_scores16_kernel<true>, Sc16::kThreads,
                          Sc16::kBytes, flash_values16_kernel<true>,
                          Val16::kThreads, Val16::kBytes, n_sl, p, mq, mk,
                          mv, ms, s_buf, m_buf, (uint16_t*)o, b, tn, h, d,
                          causal, scale, stream);
  return twopass_chunks(flash_scores16_kernel<false>, Sc16::kThreads,
                        Sc16::kBytes, flash_values16_kernel<false>,
                        Val16::kThreads, Val16::kBytes, n_sl, p, mq, mk, mv,
                        ms, s_buf, m_buf, (uint16_t*)o, b, tn, h, d, causal,
                        scale, stream);
}

}  // namespace

// The kernels rt_flash_attention launches for kernel width d and dtype (0
// = float32, 1 = float16, 2 = bfloat16): 0 flash_wgmma_kernel, 1
// flash_big16_kernel, 2 flash_tf32_kernel, 3 flash_scores32_kernel then
// flash_values32_kernel (once per chunk), 7 flash_scores16_kernel then
// flash_values16_kernel (once per chunk); -1 where no route takes the
// width.  Chosen by width and dtype alone.  The codes of deleted routes
// are not given again (4 and 5: the cluster routes of 16-bit inputs at
// 576-1024 and of f32 at 576-1536; 6: 16-bit widths past 1024, which the
// caller widened to f32), so an older build's code still names its own
// kernel.
extern "C" int rt_flash_route(int d, int dtype) {
  if (!(d == 64 || d == 128 || (d >= 256 && d % 64 == 0))) return -1;
  if (dtype < 0 || dtype > 2) return -1;
  if (d <= kReach) return dtype == 0 ? 2 : d <= 128 ? 0 : 1;
  if (d / 64 > 65535) return -1;
  return dtype == 0 ? 3 : 7;
}

// Keys a tile of the kernel rt_flash_route names for (d, dtype) (for the
// two-pass routes, of the values kernel, whose tiles O sums over); -1
// where no route takes the width.  The tiles are the layouts' own
// (Smem16, Big16, Tf32, Val32, Val16), so the card tests read the
// rule from here.
extern "C" int rt_flash_key_tile(int d, int dtype) {
  switch (rt_flash_route(d, dtype)) {
    case 0: return d == 64 ? Smem16<64>::kBN : Smem16<128>::kBN;
    case 1: return d == 256 ? Big16<256>::kBN : Big16<320>::kBN;
    case 2:
      switch (d) {
        case 64: return Tf32<64>::kBN;
        case 128: return Tf32<128>::kBN;
        case 256: return Tf32<256>::kBN;
        case 320: return Tf32<320>::kBN;
        case 384: return Tf32<384>::kBN;
        case 448: return Tf32<448>::kBN;
        case 512: return Tf32<512>::kBN;
      }
      return -1;
    case 3: return Val32::kBN;
    case 7: return Val16::kBN;
  }
  return -1;
}

// Bytes of device scratch rt_flash_attention needs for (b, t, h, d,
// dtype): the two-pass routes' (one chunk's scores and row maxima: at
// most the larger of kScratchCap and one query block's, whatever b and
// h are; one plan for both dtypes); 0 for every other route; -1 where no
// route takes the width or the two-pass route's blocks pass its grid.
extern "C" long long rt_flash_scratch_bytes(int b, int t, int h, int d,
                                            int dtype) {
  const int route = rt_flash_route(d, dtype);
  if (route < 0 || b < 1 || t < 1 || h < 1) return -1;
  if (route != 3 && route != 7) return 0;
  TwoPass p;
  return twopass_plan(b, t, h, &p) ? p.bytes : -1;
}

// The kernel launches the calling thread's last rt_flash_attention call
// made, counted where each launch succeeded
extern "C" long long rt_flash_last_launches() { return t_launches; }

// d: a kernel width rt_flash_route takes (the wrapper pads other head dims
// with zeros and passes the scale of the original one).  scratch: device
// memory of rt_flash_scratch_bytes(b, t, h, d, dtype) bytes (16-byte
// aligned), or null where that is 0.  Each route checks its own grid
// (b*h, the query tiles and a tile's CTAs on gridDim.x, at most 2**31 - 1
// blocks).
extern "C" int rt_flash_attention(const void* q, const void* k, const void* v,
                                  void* o, int b, int t, int h, int d,
                                  int dtype, int causal, float scale,
                                  void* scratch, void* stream) {
  t_launches = 0;
  if (b < 1 || t < 1 || h < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (rt_flash_route(d, dtype)) {
    case 0:
    case 1:
      return dtype == 2 ? launch_any16<true>(q, k, v, o, b, t, h, d, causal,
                                             scale, st)
                        : launch_any16<false>(q, k, v, o, b, t, h, d, causal,
                                              scale, st);
    case 2: return launch_any32(q, k, v, o, b, t, h, d, causal, scale, st);
    case 3:
    case 7:
      return launch_twopass(q, k, v, o, b, t, h, d, dtype, causal, scale,
                            scratch, st);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* rt_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
