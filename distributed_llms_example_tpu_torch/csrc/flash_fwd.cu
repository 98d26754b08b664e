// Flash-attention forward for fp32 on Hopper's CUDA cores (sm_90a), plain C
// interface for ctypes.
//
// Replaces the TPU Pallas kernel distributed_llms_example_tpu/ops/
// flash_attention.py `_fwd_kernel` (reached through `_fwd` and the public
// `flash_attention`) for fp32 inputs; bf16 inputs go to the tensor-core
// kernel of csrc/flash_fwd_tc.cu.  fp32 stays here because its products are
// exact fp32 FMAs, which the port's fp32 checks hold at 1e-4; TF32 wgmma
// keeps about three decimal digits and would not meet that.  Same function
// as the TPU kernel, not a block-by-block copy:
//
//   o   = softmax(scale * q k^T + bias + lbias) v      (fp32 online softmax)
//   lse = m + log(l), or MASK_VALUE where a row has no live key
//
// q, k, v: (B, H, S, D) contiguous fp32 (the element type T stays a
// template parameter); o like q; lse (B, H, Sq) fp32.  `bias` is an fp32
// additive mask read through its own element strides, so a size-1 dim
// (stride 0) is never broadcast in memory; it may be null.  `lbias` is the
// learned (1, H, Sq, Sk) bias (T5's relative position bias) in its own
// dtype, fp32 or bf16 (`lb_bf16`; the element type LB is a template
// parameter, so each load is one typed read-only load), read the same way,
// widened to fp32 and added after the mask, as the TPU kernel adds it; it
// may be null.  `causal` applies the top-left mask q_pos >= k_pos with -inf
// and skips kv tiles wholly above the diagonal.  Rows whose every key is
// -inf give o = 0 and lse = MASK_VALUE; rows masked only by the finite
// NEG_INF = -1e9 padding bias average all values uniformly, exactly as
// plain softmax attention does.  As on the TPU, p is rounded to v's dtype
// before the value product, while the row sum l accumulates unrounded p.
// Attention-probs dropout (template parameter DROP): p is dropped by the
// counter hash of csrc/dropout_hash.cuh over (seed, b, h, absolute query,
// absolute key) after l has summed it, the kept entries scaled by the fp32
// 1 / (1 - rate) before the rounding, as the TPU kernel does; DROP = 0 is
// the code as it was.
//
// Any Lq and Lk: every tile load and score is bounds-checked.
//
// What bounds it on the H100: at (8, 16, 1024, 64) the work is
// 4*B*H*S*S*D = 34 GFLOP, which in fp32 outside the tensor cores (67
// TFLOP/s) cannot take less than about 0.5 ms.  The design keeps the
// (S, S) score matrix out of device memory (one 64 x 64 tile in shared
// memory at a time), reads every q/k/v element once per block, and
// register-tiles both products (each thread owns a 4 x 4 score tile and a
// 4 x D/16 output tile) so shared-memory loads are half the FMAs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "dropout_hash.cuh"

namespace {

constexpr int BQ = 64;   // query rows per block
constexpr int BK = 64;   // keys per tile
constexpr int NT = 256;  // threads: a 16 x 16 grid of register tiles
constexpr float MASK_VALUE = -0.7f * 3.4028234663852886e38f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }

template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

template <int D>
constexpr size_t smem_floats() {
  return BQ * D + BK * (D + 1) + BK * D + BQ * (BK + 1) + 3 * BQ;
}

template <typename T, typename LB, int D, int DROP>
__global__ void __launch_bounds__(NT) flash_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ bias, long long bsb, long long bsh, long long bsq,
    long long bsk, const LB* __restrict__ lbias, long long lsb, long long lsh,
    long long lsq, long long lsk, T* __restrict__ o, float* __restrict__ lse, int H, int Lq,
    int Lk, float scale, int causal, ProbsDropout drop) {
  static_assert(D % 16 == 0, "head_dim must be a multiple of 16");
  constexpr int CD = D / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;                  // [BQ][D]
  float* Ks = Qs + BQ * D;           // [BK][D + 1]
  float* Vs = Ks + BK * (D + 1);     // [BK][D]
  float* Ss = Vs + BK * D;           // [BQ][BK + 1]
  float* m_s = Ss + BQ * (BK + 1);   // [BQ] running max
  float* l_s = m_s + BQ;             // [BQ] running sum
  float* a_s = l_s + BQ;             // [BQ] this tile's rescale factor

  const int tid = threadIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * BQ;
  const T* qp = q + (size_t)bh * Lq * D;
  const T* kp = k + (size_t)bh * Lk * D;
  const T* vp = v + (size_t)bh * Lk * D;
  const float* bp = bias ? bias + b * bsb + h * bsh : nullptr;
  const LB* lp = lbias ? lbias + b * lsb + h * lsh : nullptr;

  for (int i = tid; i < BQ * D; i += NT) {
    const int r = i / D, c = i % D;
    Qs[i] = (q0 + r < Lq) ? to_f(qp[(size_t)(q0 + r) * D + c]) : 0.f;
  }
  if (tid < BQ) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }

  const int ty = tid / 16, tx = tid % 16;
  float acc[4][CD];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < CD; ++j) acc[i][j] = 0.f;

  int nk = (Lk + BK - 1) / BK;
  if (causal) nk = min(nk, (q0 + BQ - 1) / BK + 1);  // tiles touching the diagonal or below

  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's readers are done with Ks/Vs/Ss
    for (int i = tid; i < BK * D; i += NT) {
      const int r = i / D, c = i % D;
      const bool ok = k0 + r < Lk;
      Ks[r * (D + 1) + c] = ok ? to_f(kp[(size_t)(k0 + r) * D + c]) : 0.f;
      Vs[r * D + c] = ok ? to_f(vp[(size_t)(k0 + r) * D + c]) : 0.f;
    }
    __syncthreads();

    // scores: rows ty*4 + i, columns tx + 16*j (strided, so lanes hit
    // distinct banks of the padded K rows)
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty * 4 + i) * D + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * (D + 1) + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = ty * 4 + i, c = tx + 16 * j;
        const int qi = q0 + r, ki = k0 + c;
        float x = -INFINITY;
        if (qi < Lq && ki < Lk && !(causal && ki > qi)) {
          x = s[i][j] * scale;
          if (bp) x += bp[(long long)qi * bsq + (long long)ki * bsk];
          if (lp) x += to_f(lp[(long long)qi * lsq + (long long)ki * lsk]);
        }
        Ss[r * (BK + 1) + c] = x;
      }
    }
    __syncthreads();

    // online softmax, four consecutive lanes per row
    {
      const int r = tid / 4, part = tid % 4;
      float* row = Ss + r * (BK + 1);
      float mx = -INFINITY;
      for (int c = part; c < BK; c += 4) mx = fmaxf(mx, row[c]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_prev = m_s[r];
      const float m_next = fmaxf(m_prev, mx);
      // a row can still be all -inf: a finite stand-in max keeps
      // exp(-inf - m) = 0 instead of NaN, and l stays 0
      const float safe_m = (m_next == -INFINITY) ? 0.f : m_next;
      // probs dropout: this row's hash word at the tile's first key
      uint32_t word = 0;
      if constexpr (DROP)
        word = (uint32_t)(q0 + r) * HASH_ROW_MUL + (uint32_t)k0 * HASH_COL_MUL +
               stream_key(drop.seed, b, h);
      float sum = 0.f;
      for (int c = part; c < BK; c += 4) {
        float p = expf(row[c] - safe_m);
        sum += p;
        if constexpr (DROP)
          p = keep_word(word + (uint32_t)c * HASH_COL_MUL, drop.threshold << 8)
                  ? __fmul_rn(p, drop.inv_keep) : 0.f;
        row[c] = round_to<T>(p);
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      if (part == 0) {
        const float alpha = expf(m_prev - safe_m);
        m_s[r] = m_next;
        l_s[r] = alpha * l_s[r] + sum;
        a_s[r] = alpha;
      }
    }
    __syncthreads();

    // acc = acc * alpha + p v
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float al = a_s[ty * 4 + i];
#pragma unroll
      for (int j = 0; j < CD; ++j) acc[i][j] *= al;
    }
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float pv[4], vv[CD];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ss[(ty * 4 + i) * (BK + 1) + kk];
#pragma unroll
      for (int j = 0; j < CD; ++j) vv[j] = Vs[kk * D + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < CD; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }
  __syncthreads();

  T* op = o + (size_t)bh * Lq * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i, qi = q0 + r;
    if (qi >= Lq) continue;
    const float l = l_s[r];
    const float l_safe = (l == 0.f) ? 1.f : l;  // fully-masked rows give zeros
#pragma unroll
    for (int j = 0; j < CD; ++j) op[(size_t)qi * D + tx + 16 * j] = from_f<T>(acc[i][j] / l_safe);
  }
  if (tid < BQ && q0 + tid < Lq) {
    const float l = l_s[tid];
    lse[(size_t)bh * Lq + q0 + tid] = (l == 0.f) ? MASK_VALUE : m_s[tid] + logf(l);
  }
}

// The two biases' pointers and element strides, passed as one argument.
struct Biases {
  const void* bias;
  long long bsb, bsh, bsq, bsk;
  const void* lbias;
  long long lsb, lsh, lsq, lsk;
};

template <typename T, typename LB, int D>
int launch(const void* q, const void* k, const void* v, const Biases& bs, void* o, void* lse,
           int B, int H, int Lq, int Lk, float scale, int causal, const ProbsDropout& drop,
           cudaStream_t stream) {
  const size_t smem = smem_floats<D>() * sizeof(float);
  auto kernel = drop.on() ? flash_fwd_kernel<T, LB, D, 1> : flash_fwd_kernel<T, LB, D, 0>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Lq + BQ - 1) / BQ, B * H);
  kernel<<<grid, NT, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const float*)bs.bias, bs.bsb, bs.bsh, bs.bsq,
      bs.bsk, (const LB*)bs.lbias, bs.lsb, bs.lsh, bs.lsq, bs.lsk, (T*)o, (float*)lse, H, Lq,
      Lk, scale, causal, drop);
  return (int)cudaGetLastError();
}

template <typename T, typename LB>
int dispatch_d(int D, const void* q, const void* k, const void* v, const Biases& bs, void* o,
               void* lse, int B, int H, int Lq, int Lk, float scale, int causal,
               const ProbsDropout& drop, cudaStream_t s) {
  switch (D) {
    case 16: return launch<T, LB, 16>(q, k, v, bs, o, lse, B, H, Lq, Lk, scale, causal, drop, s);
    case 32: return launch<T, LB, 32>(q, k, v, bs, o, lse, B, H, Lq, Lk, scale, causal, drop, s);
    case 64: return launch<T, LB, 64>(q, k, v, bs, o, lse, B, H, Lq, Lk, scale, causal, drop, s);
    case 128:
      return launch<T, LB, 128>(q, k, v, bs, o, lse, B, H, Lq, Lk, scale, causal, drop, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int dispatch_lb(int lb_bf16, int D, const void* q, const void* k, const void* v,
                const Biases& bs, void* o, void* lse, int B, int H, int Lq, int Lk, float scale,
                int causal, const ProbsDropout& drop, cudaStream_t s) {
  if (lb_bf16)
    return dispatch_d<T, __nv_bfloat16>(D, q, k, v, bs, o, lse, B, H, Lq, Lk, scale, causal,
                                        drop, s);
  return dispatch_d<T, float>(D, q, k, v, bs, o, lse, B, H, Lq, Lk, scale, causal, drop, s);
}

}  // namespace

// fp32 q/k/v only: bf16 goes to the tensor-core kernel (csrc/flash_fwd_tc.cu);
// seed, threshold, inv_keep: the probs dropout (threshold 2^24: none)
extern "C" int flash_fwd(const void* q, const void* k, const void* v, const void* bias,
                         long long bsb, long long bsh, long long bsq, long long bsk,
                         const void* lbias, long long lsb, long long lsh, long long lsq,
                         long long lsk, void* o, void* lse, int B, int H, int Lq, int Lk, int D,
                         float scale, int causal, int seed, unsigned int threshold,
                         float inv_keep, int lb_bf16, void* stream) {
  if (threshold > (1u << 24)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const Biases bs{bias, bsb, bsh, bsq, bsk, lbias, lsb, lsh, lsq, lsk};
  const ProbsDropout drop{seed, threshold, inv_keep};
  return dispatch_lb<float>(lb_bf16, D, q, k, v, bs, o, lse, B, H, Lq, Lk, scale, causal, drop,
                            s);
}
