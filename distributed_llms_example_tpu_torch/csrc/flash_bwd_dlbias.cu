// Learned-bias gradient of flash attention for Hopper (sm_90a) in fp32 on
// the CUDA cores, plain C interface for ctypes.
//
// Replaces the TPU Pallas kernel distributed_llms_example_tpu/ops/
// flash_attention.py `_bwd_dlbias_kernel` (reached through `_bwd_dlbias`
// from `_bwd`) for fp32 inputs.  bf16 inputs go to the tensor-core kernel
// of csrc/flash_bwd_dlbias_tc.cu; fp32 stays here because the fp32 T5
// gradient check holds these products at ~1e-10, which TF32 wgmma (about
// three decimal digits) would not meet.  Same function, not a
// block-by-block copy:
//
//   dlbias[0, h, i, j] = sum_b p[b, h, i, j] * (dp[b, h, i, j] - delta[b, h, i])
//
// with s = scale * q k^T + bias + lbias (-inf where causal-masked),
// p = exp(s - lse) (0 on rows whose lse is the MASK_VALUE sentinel: rows
// with no live key) and dp = dO v^T recomputed per tile exactly as the dq
// and dk/dv kernels (csrc/flash_bwd.cu) recompute them.  No scale factor:
// the scale multiplies only q k^T, so ds/dlbias = 1.  With attention-probs
// dropout (template parameter DROP), dp is the dropped m * dp / (1 - rate),
// the mask m redrawn per batch row from the counter hash of
// csrc/dropout_hash.cuh over (seed, b, h, absolute query, absolute key);
// DROP = 0 is the code as it was.
//
// q, k, v, dO: (B, H, S, D) contiguous fp32; lse and delta (B, H, Sq) fp32;
// the fp32 `bias` (a constant mask, may be null) and the learned (1, H, Sq,
// Sk) `lbias` (never null here; fp32 or bf16, `lb_bf16`, widened to fp32
// on load) are read through their element strides.  The output is (1, H,
// Sq, Sk) contiguous in the learned bias's dtype, rounded once from the
// fp32 sum.  Any Sq and Sk: every load and score is bounds-checked.
//
// Design.  The TPU runs the batch as its innermost sequential grid axis and
// carries the sum in one tile's scratch, so the (B, H, Sq, Sk) gradient
// never exists.  Here one block owns one (h, 64-query, 64-key) tile and
// loops over the batch itself; each of its 256 threads keeps a 4 x 4 piece
// of the tile's sum in registers.  There are no atomics and no second
// pass, so the result is the same on every run.  Every tile of the output
// is written: a tile wholly above the causal diagonal skips the batch loop
// and stores its zeros (as the TPU writes its zeroed scratch), and a
// fully-masked row has p = 0, hence 0.  A tile left unwritten would be
// allocator garbage flowing into the bias table's gradient.
//
// What bounds it on the H100: the fp32 products on the CUDA cores (4 *
// B * H * S * S * D flops at 67 TFLOP/s), far above the memory bound.  The
// train paths run bf16, so this kernel carries the fp32 checks only.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "dropout_hash.cuh"

namespace {

constexpr int BQ = 64;   // query rows per tile
constexpr int BK = 64;   // keys per tile
constexpr int NT = 256;  // threads: a 16 x 16 grid of 4 x 4 register tiles
constexpr float MASK_VALUE = -0.7f * 3.4028234663852886e38f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Loads a (64 x D) tile starting at row r0 of a (len x D) matrix into
// shared memory with row stride `ld`, zero-filling rows past `len`.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, int ld, const T* src, int r0, int len) {
  for (int i = threadIdx.x; i < 64 * D; i += NT) {
    const int r = i / D, c = i % D;
    dst[r * ld + c] = (r0 + r < len) ? to_f(src[(size_t)(r0 + r) * D + c]) : 0.f;
  }
}

template <int D>
constexpr size_t smem_floats() {
  return 2 * BQ * D + 2 * BK * (D + 1) + 2 * BQ;
}

template <typename T, typename O, int D, int DROP>
__global__ void __launch_bounds__(NT) flash_bwd_dlbias_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ bias, long long bsb, long long bsh, long long bsq, long long bsk,
    const O* __restrict__ lbias, long long lsh, long long lsq, long long lsk,
    const T* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
    O* __restrict__ dlb, int B, int H, int Lq, int Lk, float scale, int causal,
    ProbsDropout drop) {
  extern __shared__ float smem[];
  float* Qs = smem;                // [BQ][D]
  float* dOs = Qs + BQ * D;        // [BQ][D]
  float* Ks = dOs + BQ * D;        // [BK][D + 1]
  float* Vs = Ks + BK * (D + 1);   // [BK][D + 1]
  float* lse_s = Vs + BK * (D + 1);
  float* dl_s = lse_s + BQ;

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int k0 = blockIdx.x * BK, q0 = blockIdx.y * BQ, h = blockIdx.z;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  // a tile wholly above the causal diagonal has no live pair: it skips the
  // batch loop and writes zeros below
  if (!(causal && k0 > q0 + BQ - 1)) {
    // this thread's learned-bias values are the same for every batch row
    float lb[4][4];
    const O* lp = lbias + h * lsh;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int qi = q0 + ty * 4 + i, ki = k0 + tx + 16 * j;
        lb[i][j] = (qi < Lq && ki < Lk) ? to_f(lp[(long long)qi * lsq + (long long)ki * lsk]) : 0.f;
      }

    for (int b = 0; b < B; ++b) {
      const size_t bh = (size_t)b * H + h;
      __syncthreads();  // the previous row's readers are done with the tiles
      load_tile<T, D>(Qs, D, q + bh * Lq * D, q0, Lq);
      load_tile<T, D>(dOs, D, dout + bh * Lq * D, q0, Lq);
      load_tile<T, D>(Ks, D + 1, k + bh * Lk * D, k0, Lk);
      load_tile<T, D>(Vs, D + 1, v + bh * Lk * D, k0, Lk);
      if (tid < BQ) {
        const bool ok = q0 + tid < Lq;
        lse_s[tid] = ok ? lse[bh * Lq + q0 + tid] : MASK_VALUE;
        dl_s[tid] = ok ? delta[bh * Lq + q0 + tid] : 0.f;
      }
      __syncthreads();

      // s and dp for rows ty*4+i, keys tx+16j: the same sums, in the same
      // order, as the dq and dk/dv kernels' score step
      float s[4][4], dp[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        float qv[4], ov[4], kv[4], vv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          qv[i] = Qs[(ty * 4 + i) * D + d];
          ov[i] = dOs[(ty * 4 + i) * D + d];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          kv[j] = Ks[(tx + 16 * j) * (D + 1) + d];
          vv[j] = Vs[(tx + 16 * j) * (D + 1) + d];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
            dp[i][j] = fmaf(ov[i], vv[j], dp[i][j]);
          }
      }
      const float* bp = bias ? bias + b * bsb + h * bsh : nullptr;
      const uint32_t key = DROP ? stream_key(drop.seed, b, h) : 0u;  // this row's plane
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty * 4 + i, qi = q0 + r;
        const float l = lse_s[r], dl = dl_s[r];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int ki = k0 + tx + 16 * j;
          if (qi < Lq && ki < Lk && !(causal && ki > qi) && !(l <= MASK_VALUE / 2)) {
            const float bv = bp ? bp[(long long)qi * bsq + (long long)ki * bsk] : 0.f;
            const float p = expf(s[i][j] * scale + bv + lb[i][j] - l);
            float dpv = dp[i][j];
            if constexpr (DROP)
              dpv = keep_word((uint32_t)qi * HASH_ROW_MUL + (uint32_t)ki * HASH_COL_MUL + key,
                              drop.threshold << 8)
                        ? __fmul_rn(dpv, drop.inv_keep) : 0.f;
            acc[i][j] += p * (dpv - dl);
          }
        }
      }
    }
  }

  O* out = dlb + (size_t)h * Lq * Lk;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty * 4 + i;
    if (qi >= Lq) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int ki = k0 + tx + 16 * j;
      if (ki < Lk) out[(size_t)qi * Lk + ki] = from_f<O>(acc[i][j]);
    }
  }
}

struct Args {
  const void *q, *k, *v, *bias;
  long long bsb, bsh, bsq, bsk;
  const void* lbias;
  long long lsh, lsq, lsk;
  const void *dout, *lse, *delta;
  void* out;
  int B, H, Lq, Lk;
  float scale;
  int causal;
  ProbsDropout drop;
};

template <typename T, typename O, int D>
int launch(const Args& a, cudaStream_t stream) {
  const size_t smem = smem_floats<D>() * sizeof(float);
  auto kernel = a.drop.on() ? flash_bwd_dlbias_kernel<T, O, D, 1>
                            : flash_bwd_dlbias_kernel<T, O, D, 0>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((a.Lk + BK - 1) / BK, (a.Lq + BQ - 1) / BQ, a.H);
  kernel<<<grid, NT, smem, stream>>>(
      (const T*)a.q, (const T*)a.k, (const T*)a.v, (const float*)a.bias, a.bsb, a.bsh, a.bsq,
      a.bsk, (const O*)a.lbias, a.lsh, a.lsq, a.lsk, (const T*)a.dout, (const float*)a.lse,
      (const float*)a.delta, (O*)a.out, a.B, a.H, a.Lq, a.Lk, a.scale, a.causal, a.drop);
  return (int)cudaGetLastError();
}

template <typename T, typename O>
int dispatch_d(int D, const Args& a, cudaStream_t s) {
  switch (D) {
    case 16: return launch<T, O, 16>(a, s);
    case 32: return launch<T, O, 32>(a, s);
    case 64: return launch<T, O, 64>(a, s);
    case 128: return launch<T, O, 128>(a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// `lsb`, the learned bias's batch stride, is 0: its batch dim is 1, which
// is what the kernel sums over.  seed, threshold, inv_keep: the forward's
// probs dropout (threshold 2^24: none).  `lb_bf16` gives the dtype of the
// learned bias and of its gradient.
extern "C" int flash_bwd_dlbias(const void* q, const void* k, const void* v, const void* bias,
                                long long bsb, long long bsh, long long bsq, long long bsk,
                                const void* lbias, long long lsb, long long lsh, long long lsq,
                                long long lsk, const void* dout, const void* lse,
                                const void* delta, void* dlbias, int B, int H, int Lq, int Lk,
                                int D, float scale, int causal, int seed, unsigned int threshold,
                                float inv_keep, int lb_bf16, void* stream) {
  (void)lsb;
  if (lbias == nullptr || threshold > (1u << 24)) return (int)cudaErrorInvalidValue;
  if (H == 0 || Lq == 0 || Lk == 0) return 0;
  const Args a{q, k, v, bias, bsb, bsh, bsq, bsk, lbias, lsh, lsq, lsk, dout, lse, delta, dlbias,
               B, H, Lq, Lk, scale, causal, {seed, threshold, inv_keep}};
  cudaStream_t s = (cudaStream_t)stream;
  return lb_bf16 ? dispatch_d<float, __nv_bfloat16>(D, a, s) : dispatch_d<float, float>(D, a, s);
}
