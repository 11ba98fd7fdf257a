// Flash attention, by hand for Hopper (sm_90a).
//
// Replaces: ray_tpu/ops/flash_attention.py::flash_attention, the Pallas
// TPU kernel (its pallas_call body: online softmax with (m, l, acc) in
// f32 scratch over a (B*H, T/BQ, T/BK) grid whose key axis runs in order).
//
// What bounds it on this card: operations.  softmax(QK^T/sqrt(d)) V does
// 4*B*H*T^2*D flops (half of that causal) on 4*B*T*H*D elements, far
// above the H100's ~295 flop/byte ridge at the sizes it is used at, so
// the tensor cores are the limit.  This first version takes the tensor
// cores through WMMA (m16n16k16, f16/bf16 in, f32 accumulate) for both
// products of f16/bf16 inputs, and plain f32 FMA for f32 inputs (f32
// WMMA would be TF32 and break the f32 tolerance).  wgmma, TMA and warp
// specialisation are later work; PERF.md keeps the gap to the bound.
//
// Design: one block of 4 warps per (b*h, 64-query tile).  The TPU's
// sequential key-block grid axis becomes a loop over 64-key tiles inside
// the block; under causal masking it stops at the last tile any of the
// block's queries can see (dead blocks skipped, as the Pallas kernel's
// `live` predicate) and masks inside the diagonal tile.  Each warp owns
// 16 query rows.  Per key tile: S = Q K^T into shared f32; two lanes per
// row run the online-softmax update (m, l in registers, scores and p in
// f32, p zeroed where the score is not finite, the O rows rescaled by
// exp(m_prev - m_new)); then O += P V with O kept in shared f32.  The
// output is acc / max(l, 1e-30) cast to the input type.  The 64x64 tile
// is the kernel's own choice: block_q/block_k of the Python API are
// validated for parity with the JAX signature and do not reach here.
//
// Scaling: the JAX kernel scales Q in f32 before the product.  The f32
// path does exactly that.  On the tensor-core path Q stays in its 16-bit
// type (rounding a scaled Q back to 16 bits would add an error the JAX
// kernel does not have) and the scale multiplies the f32 product, which
// equals the JAX order up to f32 rounding.
//
// Layout: (B, T, H, D) contiguous, as the public function takes it; the
// kernel computes its own strided offsets (no transpose copy).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

using namespace nvcuda;

namespace {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // keys per tile
constexpr int kWarps = 4;      // 16 query rows each
constexpr int kThreads = kWarps * 32;
constexpr unsigned kFull = 0xffffffffu;

template <typename T>
struct Cvt;
template <>
struct Cvt<float> {
  static __device__ __forceinline__ float to_f(float x) { return x; }
  static __device__ __forceinline__ float from_f(float x) { return x; }
};
template <>
struct Cvt<__half> {
  static __device__ __forceinline__ float to_f(__half x) {
    return __half2float(x);
  }
  static __device__ __forceinline__ __half from_f(float x) {
    return __float2half_rn(x);
  }
};
template <>
struct Cvt<__nv_bfloat16> {
  static __device__ __forceinline__ float to_f(__nv_bfloat16 x) {
    return __bfloat162float(x);
  }
  static __device__ __forceinline__ __nv_bfloat16 from_f(float x) {
    return __float2bfloat16_rn(x);
  }
};

constexpr size_t align128(size_t x) { return (x + 127) & ~size_t(127); }

template <typename T, int D>
struct Layout {
  static constexpr bool kTC = !std::is_same<T, float>::value;
  // row strides (elements): 16-bit tiles keep WMMA's 16-byte ldm rule
  // and 32-byte fragment alignment; f32 tiles pad by one float so the
  // lanes of a warp reading one column of 32 K rows hit 32 banks
  static constexpr int LDT = kTC ? D + 8 : D + 1;
  static constexpr int LDS = kBK + 4;            // S / P (f32)
  static constexpr int LDP = kBK + 8;            // P (16-bit)
  static constexpr int LDO = D + 4;              // O accumulator (f32)
  static constexpr size_t kQ = 0;
  static constexpr size_t kK = align128(kQ + sizeof(T) * kBQ * LDT);
  static constexpr size_t kV = align128(kK + sizeof(T) * kBK * LDT);
  static constexpr size_t kS = align128(kV + sizeof(T) * kBK * LDT);
  static constexpr size_t kP = align128(kS + sizeof(float) * kBQ * LDS);
  static constexpr size_t kO = align128(kP + (kTC ? sizeof(T) * kBQ * LDP : 0));
  static constexpr size_t kBytes = align128(kO + sizeof(float) * kBQ * LDO);
};

// rows [t0, t0 + rows) of a (T, D) slab with row stride `stride`, zero
// past T; f32 tiles are multiplied by `mul` on the way in
template <typename T, int D, int ROWS>
__device__ void load_tile(T* dst, int ld, const T* __restrict__ src,
                          size_t stride, int t0, int tn, float mul) {
  if constexpr (std::is_same<T, float>::value) {
    for (int i = threadIdx.x; i < ROWS * D; i += kThreads) {
      const int r = i / D, c = i % D, t = t0 + r;
      dst[r * ld + c] = t < tn ? src[(size_t)t * stride + c] * mul : 0.f;
    }
  } else {
    constexpr int kVec = D / 8;                    // 16-byte chunks per row
    for (int i = threadIdx.x; i < ROWS * kVec; i += kThreads) {
      const int r = i / kVec, c = i % kVec, t = t0 + r;
      uint4 val = make_uint4(0, 0, 0, 0);
      if (t < tn)
        val = *reinterpret_cast<const uint4*>(src + (size_t)t * stride + c * 8);
      *reinterpret_cast<uint4*>(dst + r * ld + c * 8) = val;
    }
  }
}

// S[warp rows, 0:kBK] = Q K^T (f32, unscaled on the tensor-core path)
template <typename T, int D>
__device__ void scores(const T* Qs, const T* Ks, float* Ss, int warp,
                       int lane) {
  using L = Layout<T, D>;
  if constexpr (L::kTC) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> a;
    wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::col_major> b;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
#pragma unroll
    for (int jn = 0; jn < kBK / 16; ++jn) {
      wmma::fill_fragment(acc, 0.f);
#pragma unroll
      for (int kd = 0; kd < D / 16; ++kd) {
        wmma::load_matrix_sync(a, Qs + warp * 16 * L::LDT + kd * 16, L::LDT);
        // K row-major (key, d) read as column-major K^T (d, key)
        wmma::load_matrix_sync(b, Ks + jn * 16 * L::LDT + kd * 16, L::LDT);
        wmma::mma_sync(acc, a, b, acc);
      }
      wmma::store_matrix_sync(Ss + warp * 16 * L::LDS + jn * 16, acc, L::LDS,
                              wmma::mem_row_major);
    }
  } else {
    // lane owns keys lane and lane + 32 of the warp's 16 rows
    float acc[16][2];
#pragma unroll
    for (int r = 0; r < 16; ++r) acc[r][0] = acc[r][1] = 0.f;
    const float* qrows = Qs + warp * 16 * L::LDT;
    for (int d = 0; d < D; ++d) {
      const float k0 = Ks[lane * L::LDT + d];
      const float k1 = Ks[(lane + 32) * L::LDT + d];
#pragma unroll
      for (int r = 0; r < 16; ++r) {
        const float qv = qrows[r * L::LDT + d];
        acc[r][0] = fmaf(qv, k0, acc[r][0]);
        acc[r][1] = fmaf(qv, k1, acc[r][1]);
      }
    }
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      Ss[(warp * 16 + r) * L::LDS + lane] = acc[r][0];
      Ss[(warp * 16 + r) * L::LDS + lane + 32] = acc[r][1];
    }
  }
}

// O[warp rows] += P V
template <typename T, int D>
__device__ void accumulate_pv(const T* Ps, const float* Ss, const T* Vs,
                              float* Os, int warp, int lane) {
  using L = Layout<T, D>;
  if constexpr (L::kTC) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> a;
    wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::row_major> b;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
#pragma unroll
    for (int dn = 0; dn < D / 16; ++dn) {
      float* o = Os + warp * 16 * L::LDO + dn * 16;
      wmma::load_matrix_sync(acc, o, L::LDO, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        wmma::load_matrix_sync(a, Ps + warp * 16 * L::LDP + kk * 16, L::LDP);
        wmma::load_matrix_sync(b, Vs + kk * 16 * L::LDT + dn * 16, L::LDT);
        wmma::mma_sync(acc, a, b, acc);
      }
      wmma::store_matrix_sync(o, acc, L::LDO, wmma::mem_row_major);
    }
  } else {
    // lane owns columns lane + 32*i; p comes from S (f32, overwritten)
    constexpr int kCols = D / 32;
    float acc[16][kCols];
#pragma unroll
    for (int r = 0; r < 16; ++r)
#pragma unroll
      for (int i = 0; i < kCols; ++i)
        acc[r][i] = Os[(warp * 16 + r) * L::LDO + lane + 32 * i];
    for (int j = 0; j < kBK; ++j) {
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
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o, int tn, int heads,
             int causal, float scale) {
  using L = Layout<T, D>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem + L::kQ);
  T* Ks = reinterpret_cast<T*>(smem + L::kK);
  T* Vs = reinterpret_cast<T*>(smem + L::kV);
  float* Ss = reinterpret_cast<float*>(smem + L::kS);
  T* Ps = reinterpret_cast<T*>(smem + L::kP);
  float* Os = reinterpret_cast<float*>(smem + L::kO);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int bh = blockIdx.y, b = bh / heads, h = bh % heads;
  const int q0 = blockIdx.x * kBQ;
  const size_t stride = (size_t)heads * D;          // between t and t+1
  const size_t base = ((size_t)b * tn * heads + h) * D;

  // f32 path: Q scaled in f32 before the product, as the JAX kernel
  load_tile<T, D, kBQ>(Qs, L::LDT, q + base, stride, q0, tn,
                       L::kTC ? 1.f : scale);
  for (int i = tid; i < kBQ * D; i += kThreads)
    Os[(i / D) * L::LDO + i % D] = 0.f;
  const float s_mul = L::kTC ? scale : 1.f;

  // two lanes per query row, 32 score columns each
  const int my_row = warp * 16 + (lane >> 1), half = lane & 1;
  const int qpos = q0 + my_row;
  float m_i = -INFINITY, l_i = 0.f;

  int n_kt = (tn + kBK - 1) / kBK;
  if (causal) n_kt = min(n_kt, (min(q0 + kBQ, tn) - 1) / kBK + 1);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();                    // every warp done with K/V tiles
    load_tile<T, D, kBK>(Ks, L::LDT, k + base, stride, k0, tn, 1.f);
    load_tile<T, D, kBK>(Vs, L::LDT, v + base, stride, k0, tn, 1.f);
    __syncthreads();

    scores<T, D>(Qs, Ks, Ss, warp, lane);
    __syncwarp();

    float* srow = Ss + my_row * L::LDS + half * 32;
    float sv[32];
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int kpos = k0 + half * 32 + j;
      const bool dead = kpos >= tn || (causal && kpos > qpos);
      sv[j] = dead ? -INFINITY : srow[j] * s_mul;
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
      if constexpr (L::kTC)
        Ps[my_row * L::LDP + half * 32 + j] = Cvt<T>::from_f(p);
      else
        srow[j] = p;
    }
    psum += __shfl_xor_sync(kFull, psum, 1);
    l_i = l_i * corr + psum;
    m_i = m_new;
    float* orow = Os + my_row * L::LDO + half * (D / 2);
#pragma unroll 8
    for (int c = 0; c < D / 2; ++c) orow[c] *= corr;
    __syncwarp();

    accumulate_pv<T, D>(Ps, Ss, Vs, Os, warp, lane);
    __syncwarp();
  }

  if (qpos < tn) {
    const float denom = fmaxf(l_i, 1e-30f);
    const float* orow = Os + my_row * L::LDO + half * (D / 2);
    T* out = o + base + (size_t)qpos * stride + half * (D / 2);
    for (int c = 0; c < D / 2; ++c) out[c] = Cvt<T>::from_f(orow[c] / denom);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int b,
           int tn, int h, int causal, float scale, cudaStream_t stream) {
  using L = Layout<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)L::kBytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((tn + kBQ - 1) / kBQ, b * h);
  flash_kernel<T, D><<<grid, kThreads, L::kBytes, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, tn, h, causal, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = float16, 2 = bfloat16
extern "C" int rt_flash_attention(const void* q, const void* k, const void* v,
                                  void* o, int b, int t, int h, int d,
                                  int dtype, int causal, float scale,
                                  void* stream) {
  if (b < 1 || t < 1 || h < 1 || b * h > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (d == 64) {
    if (dtype == 0) return launch<float, 64>(q, k, v, o, b, t, h, causal, scale, st);
    if (dtype == 1) return launch<__half, 64>(q, k, v, o, b, t, h, causal, scale, st);
    if (dtype == 2) return launch<__nv_bfloat16, 64>(q, k, v, o, b, t, h, causal, scale, st);
  } else if (d == 128) {
    if (dtype == 0) return launch<float, 128>(q, k, v, o, b, t, h, causal, scale, st);
    if (dtype == 1) return launch<__half, 128>(q, k, v, o, b, t, h, causal, scale, st);
    if (dtype == 2) return launch<__nv_bfloat16, 128>(q, k, v, o, b, t, h, causal, scale, st);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* rt_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
