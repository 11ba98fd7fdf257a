// Flash attention, by hand for Hopper (sm_90a).
//
// Replaces: ray_tpu/ops/flash_attention.py::flash_attention, the Pallas
// TPU kernel (its pallas_call body: online softmax with (m, l, acc) in
// f32 scratch over a (B*H, T/BQ, T/BK) grid whose key axis runs in order).
//
// What bounds it on this card: operations.  softmax(QK^T/sqrt(d)) V does
// 4*B*H*T^2*D flops (half of that causal) on 4*B*T*H*D elements, far
// above the H100's ~295 flop/byte ridge at the sizes it is used at, so
// the tensor cores are the limit, and only wgmma reaches their full rate.
//
// 16-bit inputs (f16, bf16): a warp-specialised wgmma + TMA kernel.
//   * One CTA per (b*h, 128-query tile), on gridDim.x with the query tiles
//     in reverse order, so under causal masking the heaviest tiles start
//     first.  Three warpgroups: two consumers of 64 query rows each and a
//     producer warpgroup of which one thread issues every copy;
//     setmaxnreg moves registers from the producer (24) to the consumers
//     (240).
//   * Copies: TMA over 4-d tensor maps built on the public (B, T, H, D)
//     layout itself (dims D, H, T, B), so there is no transpose copy and
//     the zero fill past T covers a ragged last tile.  A box is 64
//     elements (128 bytes, the 128-byte swizzle wgmma reads) by 1 by rows
//     by 1; D = 128 is two boxes.  Q is loaded once; K and V go through a
//     two-stage ring guarded by mbarriers (full: TMA bytes landed; empty:
//     all 256 consumer threads done), with separate K and V barriers so
//     S = Q K^T starts while V is still in flight.
//   * Products: S = Q K^T is m64n128k16 wgmma with both operands K-major
//     in shared memory; O += P V is m64nDk16 wgmma with P in registers
//     (the S accumulator's fragment of m64nNk16, rounded to 16 bits in
//     place, is the A-register fragment of the next product) and V
//     (key, d) read MN-major through the transpose flag.  Both accumulate
//     in f32 registers.
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
//   * Key tiles are 128 for both head dims: at D = 128 a consumer thread
//     holds 64 S + 64 O accumulators + 32 packed P registers.
//
// f32 inputs: plain FMA (f32 wgmma would be TF32 and break the f32
// tolerance).  One block of 4 warps per (b*h, 64-query tile), S and O in
// shared memory; later work (ROADMAP).  The same kernel takes every
// dtype at D = 256 (16-bit inputs widened to f32 as they are loaded, as
// the JAX kernel computes): a wgmma instantiation there needs its own
// shared-memory and register budget (128 O accumulators a thread), left
// for a later PR.  At D = 256 a block holds 32 query rows (2 warps), so
// the f32 tiles stay inside 227 KB.  Head dims other than 64, 128 and
// 256 are padded with zeros by the wrapper, which passes the original
// dim's scale.
//
// Scaling: the JAX kernel scales Q in f32 before the product.  The f32
// path does exactly that.  On the 16-bit path Q stays in its 16-bit type
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

namespace {

constexpr unsigned kFull = 0xffffffffu;

// ---------------------------------------------------------------------------
// 16-bit path: wgmma + TMA
// ---------------------------------------------------------------------------

constexpr int kBQ = 128;            // query rows per CTA
constexpr int kBN = 128;            // keys per tile
constexpr int kStages = 2;          // K/V ring depth
constexpr int kConsumers = 2;       // consumer warpgroups, 64 rows each
constexpr int kThreads16 = (kConsumers + 1) * 128;
constexpr uint32_t kRowBytes = 128; // one box row: 64 16-bit elements
constexpr uint32_t kSwAtom = 1024;  // 8 swizzled rows

template <int D>
struct Smem16 {
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
// keeps the compiler from touching accumulators across the async product
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define RT_R32                                 \
  "%0, %1, %2, %3, %4, %5, %6, %7, "           \
  "%8, %9, %10, %11, %12, %13, %14, %15, "     \
  "%16, %17, %18, %19, %20, %21, %22, %23, "   \
  "%24, %25, %26, %27, %28, %29, %30, %31"
#define RT_R64                                 \
  RT_R32 ", "                                  \
  "%32, %33, %34, %35, %36, %37, %38, %39, "   \
  "%40, %41, %42, %43, %44, %45, %46, %47, "   \
  "%48, %49, %50, %51, %52, %53, %54, %55, "   \
  "%56, %57, %58, %59, %60, %61, %62, %63"
#define RT_O32(d)                                          \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),          \
  "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),          \
  "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),        \
  "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),      \
  "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),      \
  "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),      \
  "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),      \
  "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
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

// D[64 x 128] (+)= A[64 x 16] B[16 x 128], A and B K-major in shared
// memory; scale_d = 0 overwrites D
#define RT_SS_N128(TY)                                                     \
  asm volatile(                                                            \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"                         \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " {" RT_R64 \
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"                                   \
      : RT_O64(d)                                                          \
      : "l"(da), "l"(db), "r"(scale_d))
template <bool kBF16>
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                              uint64_t db, int scale_d) {
  if constexpr (kBF16)
    RT_SS_N128("bf16");
  else
    RT_SS_N128("f16");
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

template <bool kBF16, int D>
__global__ void __launch_bounds__(kThreads16, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                   const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v,
                   uint16_t* __restrict__ o, int tn, int heads, int bh_count,
                   int n_qt, int causal, float scale_log2) {
  using L = Smem16<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + kSwAtom - 1) & ~(kSwAtom - 1);
  const uint32_t sQ = base + L::kQ, sK = base + L::kK, sV = base + L::kV;
  const uint32_t bar_q = base + L::kBar;
  auto k_full = [&](int s) { return bar_q + 8u * (1 + s); };
  auto v_full = [&](int s) { return bar_q + 8u * (1 + kStages + s); };
  auto empty = [&](int s) { return bar_q + 8u * (1 + 2 * kStages + s); };

  const int tid = threadIdx.x, wg = tid >> 7;
  const int qt = n_qt - 1 - (int)(blockIdx.x / (unsigned)bh_count);
  const int bh = (int)(blockIdx.x % (unsigned)bh_count);
  const int b = bh / heads, h = bh % heads, q0 = qt * kBQ;
  int n_kt = (tn + kBN - 1) / kBN;
  if (causal) n_kt = min(n_kt, (min(q0 + kBQ, tn) - 1) / kBN + 1);

  if (tid == 0) {
    mbar_init(bar_q, 1);
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(empty(s), kConsumers * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == kConsumers) {
    // ---- producer: one thread keeps the ring full ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (tid == kConsumers * 128) {
      mbar_expect_tx(bar_q, L::kBoxes * L::kQBox);
#pragma unroll
      for (int x = 0; x < L::kBoxes; ++x)
        tma_load_4d(sQ + x * L::kQBox, &tm_q, bar_q, x * 64, h, q0, b);
      for (int kt = 0; kt < n_kt; ++kt) {
        const int s = kt % kStages, use = kt / kStages;
        if (use > 0) mbar_wait(empty(s), (use - 1) & 1);
        mbar_expect_tx(k_full(s), L::kStage);
#pragma unroll
        for (int x = 0; x < L::kBoxes; ++x)
          tma_load_4d(sK + s * L::kStage + x * L::kKVBox, &tm_k, k_full(s),
                      x * 64, h, kt * kBN, b);
        mbar_expect_tx(v_full(s), L::kStage);
#pragma unroll
        for (int x = 0; x < L::kBoxes; ++x)
          tma_load_4d(sV + s * L::kStage + x * L::kKVBox, &tm_v, v_full(s),
                      x * 64, h, kt * kBN, b);
      }
    }
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
      const int s = kt % kStages;
      const uint32_t par = (kt / kStages) & 1;
      const uint32_t sKs = sK + s * L::kStage, sVs = sV + s * L::kStage;

      // S = Q K^T (f32, unscaled)
      float acc_s[64];
      mbar_wait(k_full(s), par);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss_n128<kBF16>(
            acc_s,
            desc_sw128(sQw + (kk >> 2) * L::kQBox + (kk & 3) * 32, 16,
                       kSwAtom),
            desc_sw128(sKs + (kk >> 2) * L::kKVBox + (kk & 3) * 32, 16,
                       kSwAtom),
            kk > 0);
      wgmma_commit();
      wgmma_wait0();
      fence_regs(acc_s);

      // accumulator element 4k + 2i + j: row r0 + 8i, key k0 + 8k + c_lane + j
      const int k0 = kt * kBN;
      if (k0 + kBN > tn || (causal && k0 + kBN - 1 > wg_row0)) {
#pragma unroll
        for (int k = 0; k < kBN / 8; ++k)
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              const int col = k0 + 8 * k + c_lane + j;
              if (col >= tn || (causal && col > r0 + 8 * i))
                acc_s[4 * k + 2 * i + j] = -INFINITY;
            }
      }

      float corr[2], m_use[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float mx = -INFINITY;
#pragma unroll
        for (int k = 0; k < kBN / 8; ++k)
          mx = fmaxf(mx, fmaxf(acc_s[4 * k + 2 * i], acc_s[4 * k + 2 * i + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));
        const float m_new = fmaxf(m2[i], mx * scale_log2);
        m_use[i] = m_new == -INFINITY ? 0.f : m_new;
        corr[i] = exp2_approx(m2[i] - m_use[i]);
        m2[i] = m_new;
        lsum[i] *= corr[i];
      }

      // P = exp(S - m) in registers, already in the A-fragment order of
      // the m64k16 product: slice kk = keys 16kk..16kk+15 is
      // {row r0 keys +0..7, row r0+8 keys +0..7, row r0 +8..15, row r0+8 +8..15}
      uint32_t pa[kBN / 4];
#pragma unroll
      for (int k = 0; k < kBN / 8; ++k)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          float p[2];
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const float sv = acc_s[4 * k + 2 * i + j];
            p[j] = isfinite(sv) ? exp2_approx(fmaf(sv, scale_log2, -m_use[i]))
                                : 0.f;
            lsum[i] += p[j];
          }
          pa[(k >> 1) * 4 + (k & 1) * 2 + i] = pack2<kBF16>(p[0], p[1]);
        }
#pragma unroll
      for (int k = 0; k < D / 8; ++k)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          acc_o[4 * k + 2 * i] *= corr[i];
          acc_o[4 * k + 2 * i + 1] *= corr[i];
        }

      // O += P V
      mbar_wait(v_full(s), par);
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
      mbar_arrive(empty(s));
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

template <bool kBF16, int D>
int launch16(const void* q, const void* k, const void* v, void* o, int b,
             int tn, int h, int causal, float scale, cudaStream_t stream) {
  using L = Smem16<D>;
  CUtensorMap mq, mk, mv;
  if (!make_map(&mq, q, b, tn, h, D, kBF16, kBQ) ||
      !make_map(&mk, k, b, tn, h, D, kBF16, kBN) ||
      !make_map(&mv, v, b, tn, h, D, kBF16, kBN))
    return (int)cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_wgmma_kernel<kBF16, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)L::kBytes);
  if (err != cudaSuccess) return (int)err;
  const int n_qt = (tn + kBQ - 1) / kBQ;
  flash_wgmma_kernel<kBF16, D><<<n_qt * b * h, kThreads16, L::kBytes, stream>>>(
      mq, mk, mv, (uint16_t*)o, tn, h, b * h, n_qt, causal,
      scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// FMA path: f32 inputs at every head dim, 16-bit inputs at D = 256
// ---------------------------------------------------------------------------

constexpr int kBK32 = 64;       // keys per tile

// rows per block: 64 (4 warps of 16 rows) where the f32 tiles fit, 32
// (2 warps) at D = 256, whose 64-row tiles would pass 227 KB
template <int D>
struct Fma {
  static constexpr int kBQ = D > 128 ? 32 : 64;
  static constexpr int kThreads = 2 * kBQ;   // two lanes per query row
};

constexpr size_t align128(size_t x) { return (x + 127) & ~size_t(127); }

template <int D>
struct Smem32 {
  static constexpr int BQ = Fma<D>::kBQ;
  // row strides (floats): one float of padding, so the lanes of a warp
  // reading one column of 32 K rows hit 32 banks
  static constexpr int LDT = D + 1;
  static constexpr int LDS = kBK32 + 4;
  static constexpr int LDO = D + 4;
  static constexpr size_t kQ = 0;
  static constexpr size_t kK = align128(kQ + sizeof(float) * BQ * LDT);
  static constexpr size_t kV = align128(kK + sizeof(float) * kBK32 * LDT);
  static constexpr size_t kS = align128(kV + sizeof(float) * kBK32 * LDT);
  static constexpr size_t kO = align128(kS + sizeof(float) * BQ * LDS);
  static constexpr size_t kBytes = align128(kO + sizeof(float) * BQ * LDO);
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __half from_f32<__half>(float x) {
  return __float2half_rn(x);
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// rows [t0, t0 + ROWS) of a (T, D) slab with row stride `stride`, in f32,
// times `mul`, zero past T
template <typename T, int D, int ROWS>
__device__ void load_tile32(float* dst, const T* __restrict__ src,
                            size_t stride, int t0, int tn, float mul) {
  for (int i = threadIdx.x; i < ROWS * D; i += Fma<D>::kThreads) {
    const int r = i / D, c = i % D, t = t0 + r;
    dst[r * Smem32<D>::LDT + c] =
        t < tn ? to_f32(src[(size_t)t * stride + c]) * mul : 0.f;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(Fma<D>::kThreads)
flash_f32_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int tn,
                 int heads, int bh_count, int causal, float scale) {
  using L = Smem32<D>;
  constexpr int BQ = Fma<D>::kBQ, NT = Fma<D>::kThreads;
  extern __shared__ __align__(128) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem + L::kQ);
  float* Ks = reinterpret_cast<float*>(smem + L::kK);
  float* Vs = reinterpret_cast<float*>(smem + L::kV);
  float* Ss = reinterpret_cast<float*>(smem + L::kS);
  float* Os = reinterpret_cast<float*>(smem + L::kO);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int bh = (int)(blockIdx.x % (unsigned)bh_count);
  const int b = bh / heads, h = bh % heads;
  const int q0 = (int)(blockIdx.x / (unsigned)bh_count) * BQ;
  const size_t stride = (size_t)heads * D;          // between t and t+1
  const size_t base = ((size_t)b * tn * heads + h) * D;

  // Q scaled in f32 before the product, as the JAX kernel
  load_tile32<T, D, BQ>(Qs, q + base, stride, q0, tn, scale);
  for (int i = tid; i < BQ * D; i += NT)
    Os[(i / D) * L::LDO + i % D] = 0.f;

  // two lanes per query row, 32 score columns each
  const int my_row = warp * 16 + (lane >> 1), half = lane & 1;
  const int qpos = q0 + my_row;
  float m_i = -INFINITY, l_i = 0.f;

  int n_kt = (tn + kBK32 - 1) / kBK32;
  if (causal) n_kt = min(n_kt, (min(q0 + BQ, tn) - 1) / kBK32 + 1);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kBK32;
    __syncthreads();                    // every warp done with K/V tiles
    load_tile32<T, D, kBK32>(Ks, k + base, stride, k0, tn, 1.f);
    load_tile32<T, D, kBK32>(Vs, v + base, stride, k0, tn, 1.f);
    __syncthreads();
    {  // S[warp rows] = Q K^T: lane owns keys lane and lane + 32
      float acc[16][2];
#pragma unroll
      for (int r = 0; r < 16; ++r) acc[r][0] = acc[r][1] = 0.f;
      const float* qrows = Qs + warp * 16 * L::LDT;
      for (int d = 0; d < D; ++d) {
        const float k0v = Ks[lane * L::LDT + d];
        const float k1v = Ks[(lane + 32) * L::LDT + d];
#pragma unroll
        for (int r = 0; r < 16; ++r) {
          const float qv = qrows[r * L::LDT + d];
          acc[r][0] = fmaf(qv, k0v, acc[r][0]);
          acc[r][1] = fmaf(qv, k1v, acc[r][1]);
        }
      }
#pragma unroll
      for (int r = 0; r < 16; ++r) {
        Ss[(warp * 16 + r) * L::LDS + lane] = acc[r][0];
        Ss[(warp * 16 + r) * L::LDS + lane + 32] = acc[r][1];
      }
    }
    __syncwarp();

    float* srow = Ss + my_row * L::LDS + half * 32;
    float sv[32];
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int kpos = k0 + half * 32 + j;
      const bool dead = kpos >= tn || (causal && kpos > qpos);
      sv[j] = dead ? -INFINITY : srow[j];
      mx = fmaxf(mx, sv[j]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
    const float m_new = fmaxf(m_i, mx);
    const float corr = m_i == -INFINITY ? 0.f : expf(m_i - m_new);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const float p = isfinite(sv[j]) ? expf(sv[j] - m_new) : 0.f;
      psum += p;
      srow[j] = p;
    }
    psum += __shfl_xor_sync(kFull, psum, 1);
    l_i = l_i * corr + psum;
    m_i = m_new;
    float* orow = Os + my_row * L::LDO + half * (D / 2);
#pragma unroll 8
    for (int c = 0; c < D / 2; ++c) orow[c] *= corr;
    __syncwarp();

    {  // O[warp rows] += P V: lane owns columns lane + 32 i
      constexpr int kCols = D / 32;
      float acc[16][kCols];
#pragma unroll
      for (int r = 0; r < 16; ++r)
#pragma unroll
        for (int i = 0; i < kCols; ++i)
          acc[r][i] = Os[(warp * 16 + r) * L::LDO + lane + 32 * i];
      for (int j = 0; j < kBK32; ++j) {
        float vv[kCols];
#pragma unroll
        for (int i = 0; i < kCols; ++i) vv[i] = Vs[j * L::LDT + lane + 32 * i];
#pragma unroll
        for (int r = 0; r < 16; ++r) {
          const float p = Ss[(warp * 16 + r) * L::LDS + j];
#pragma unroll
          for (int i = 0; i < kCols; ++i) acc[r][i] = fmaf(p, vv[i], acc[r][i]);
        }
      }
#pragma unroll
      for (int r = 0; r < 16; ++r)
#pragma unroll
        for (int i = 0; i < kCols; ++i)
          Os[(warp * 16 + r) * L::LDO + lane + 32 * i] = acc[r][i];
    }
    __syncwarp();
  }

  if (qpos < tn) {
    const float denom = fmaxf(l_i, 1e-30f);
    const float* orow = Os + my_row * L::LDO + half * (D / 2);
    T* out = o + base + (size_t)qpos * stride + half * (D / 2);
    for (int c = 0; c < D / 2; ++c) out[c] = from_f32<T>(orow[c] / denom);
  }
}

template <typename T, int D>
int launch32(const void* q, const void* k, const void* v, void* o, int b,
             int tn, int h, int causal, float scale, cudaStream_t stream) {
  using L = Smem32<D>;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_f32_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)L::kBytes);
  if (err != cudaSuccess) return (int)err;
  const int n_qt = (tn + Fma<D>::kBQ - 1) / Fma<D>::kBQ;
  flash_f32_kernel<T, D><<<n_qt * b * h, Fma<D>::kThreads, L::kBytes,
                           stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, tn, h, b * h, causal,
      scale);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = float16, 2 = bfloat16; d in {64, 128, 256}
// (the wrapper pads other head dims with zeros and passes the scale of
// the original one).  Both grids put b*h and the query tile on gridDim.x
// (at most 2**31 - 1 blocks).
extern "C" int rt_flash_attention(const void* q, const void* k, const void* v,
                                  void* o, int b, int t, int h, int d,
                                  int dtype, int causal, float scale,
                                  void* stream) {
  if (b < 1 || t < 1 || h < 1 ||
      (long long)b * h * ((t + 31) / 32) > INT_MAX)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (d == 64) {
    if (dtype == 0) return launch32<float, 64>(q, k, v, o, b, t, h, causal, scale, st);
    if (dtype == 1) return launch16<false, 64>(q, k, v, o, b, t, h, causal, scale, st);
    if (dtype == 2) return launch16<true, 64>(q, k, v, o, b, t, h, causal, scale, st);
  } else if (d == 128) {
    if (dtype == 0) return launch32<float, 128>(q, k, v, o, b, t, h, causal, scale, st);
    if (dtype == 1) return launch16<false, 128>(q, k, v, o, b, t, h, causal, scale, st);
    if (dtype == 2) return launch16<true, 128>(q, k, v, o, b, t, h, causal, scale, st);
  } else if (d == 256) {
    if (dtype == 0) return launch32<float, 256>(q, k, v, o, b, t, h, causal, scale, st);
    if (dtype == 1) return launch32<__half, 256>(q, k, v, o, b, t, h, causal, scale, st);
    if (dtype == 2) return launch32<__nv_bfloat16, 256>(q, k, v, o, b, t, h, causal, scale, st);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* rt_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
