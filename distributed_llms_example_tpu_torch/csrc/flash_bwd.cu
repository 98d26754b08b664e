// Flash-attention backward for Hopper (sm_90a) in fp32 on the CUDA cores:
// two kernels, plain C interface for ctypes.
//
// Replaces the TPU Pallas kernels distributed_llms_example_tpu/ops/
// flash_attention.py `_bwd_dq_kernel` (entry `flash_bwd_dq`) and
// `_bwd_dkv_kernel` (entry `flash_bwd_dkv`), both reached through `_bwd`,
// for fp32 inputs.  bf16 inputs go to the tensor-core kernels of
// csrc/flash_bwd_tc.cu; fp32 stays here because the fp32 gradient checks
// hold these products exactly or at 5e-6, which TF32 wgmma (about three
// decimal digits) would not meet.
// Given the forward's inputs, its lse and delta = rowsum(dO * O) (computed
// by the wrapper, as the JAX package computes it outside its kernels), each
// tile recomputes
//
//   s  = scale * q k^T + bias + lbias   (-inf where causal-masked)
//   p  = exp(s - lse)            (0 on rows whose lse is the MASK_VALUE
//                                 sentinel: rows with no live key)
//   dp = dO v^T
//   ds = p * (dp - delta) * scale
//
// and accumulates dq = ds k (one block per 64 query rows, looping over key
// tiles) or dk = ds^T q, dv = p^T dO (one block per 64 keys, looping over
// query tiles).  Rounding points follow the TPU kernels: ds is rounded to
// k's dtype before the dq product and to q's dtype before the dk product,
// p to dO's dtype before the dv product; every product accumulates in fp32.
//
// q, k, v, dO: (B, H, S, D) contiguous fp32 (the kernels' element type T
// is a template parameter, instantiated for float only); lse and
// delta (B, H, Sq) fp32; the fp32 `bias` is read through its element
// strides (stride 0 for a size-1 dim) and may be null, and so is the
// learned (1, H, Sq, Sk) `lbias` (T5's relative-position bias), read in its
// own dtype, fp32 or bf16 (`lb_bf16`; the element type LB is a template
// parameter), widened to fp32 and added after the bias as the TPU kernels
// add it.  `causal` is the top-left mask q_pos >= k_pos; tiles wholly
// above the diagonal are skipped, as `diag_ok` skips them on the TPU.  Any
// Sq and Sk: every load and score is bounds-checked.  The bias is a
// constant mask: it gets no gradient; the learned bias's gradient is
// kernel 4 (csrc/flash_bwd_dlbias.cu).  The probs-dropout branch of the
// TPU kernels is not here (no model of the port trains with
// attention-probs dropout).
//
// What bounds it on the H100: arithmetic.  At the encoder shape (8, 16,
// 1024, 64) the dq pass does 6*B*H*S*S*D = 51.5 GFLOP and the dk/dv pass
// 8*B*H*S*S*D = 68.7 GFLOP, far right of the ~295 FLOP/byte ridge.  The
// design does that arithmetic in fp32 on the CUDA cores, as
// csrc/flash_fwd.cu does for the forward: one 64 x 64 score tile per block
// in shared memory, register tiles of 4 x 4 scores and 4 x D/16 outputs
// per thread, every q/k/v/dO element read once per block.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;   // query rows per tile
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

template <typename B>
struct Bias {
  const B* p;  // already offset to (b, h); null = no bias
  long long sq, sk;
  __device__ __forceinline__ float at(int qi, int ki) const {
    return p ? to_f(p[(long long)qi * sq + (long long)ki * sk]) : 0.f;
  }
};

// Loads a (rows x D) tile starting at row r0 of a (len x D) matrix into
// shared memory with row stride `ld`, zero-filling rows past `len`.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, int ld, const T* src, int r0, int len) {
  for (int i = threadIdx.x; i < 64 * D; i += NT) {
    const int r = i / D, c = i % D;
    dst[r * ld + c] = (r0 + r < len) ? to_f(src[(size_t)(r0 + r) * D + c]) : 0.f;
  }
}

// The shared score step of both kernels: for the thread's 4 x 4 tile of
// (query row ty*4+i, key tx+16j) it returns p and ds, with p = 0 wherever
// the pair is out of range, causal-masked or on a sentinel row.
template <int D, typename LB>
__device__ __forceinline__ void score_tile(
    const float* Qs, const float* dOs, const float* Ks, const float* Vs, const float* lse_s,
    const float* dl_s, int q0, int k0, int Lq, int Lk, float scale, int causal,
    const Bias<float>& bias, const Bias<LB>& lbias, float p[4][4], float ds[4][4]) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
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
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i, qi = q0 + r;
    const float l = lse_s[r], delta = dl_s[r];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int ki = k0 + tx + 16 * j;
      float pv = 0.f;
      if (qi < Lq && ki < Lk && !(causal && ki > qi) && !(l <= MASK_VALUE / 2)) {
        pv = expf(s[i][j] * scale + bias.at(qi, ki) + lbias.at(qi, ki) - l);
      }
      p[i][j] = pv;
      ds[i][j] = pv * (dp[i][j] - delta) * scale;
    }
  }
}

template <int D>
constexpr size_t dq_smem_floats() {
  return 2 * BQ * D + 2 * BK * (D + 1) + BQ * (BK + 1) + 2 * BQ;
}

template <typename T, typename LB, int D>
__global__ void __launch_bounds__(NT) flash_bwd_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ bias, long long bsb, long long bsh, long long bsq, long long bsk,
    const LB* __restrict__ lbias, long long lsb, long long lsh, long long lsq, long long lsk,
    const T* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
    T* __restrict__ dq, int H, int Lq, int Lk, float scale, int causal) {
  constexpr int CD = D / 16;
  extern __shared__ float smem[];
  float* Qs = smem;                 // [BQ][D]
  float* dOs = Qs + BQ * D;         // [BQ][D]
  float* Ks = dOs + BQ * D;         // [BK][D + 1]
  float* Vs = Ks + BK * (D + 1);    // [BK][D + 1]
  float* Ss = Vs + BK * (D + 1);    // [BQ][BK + 1]: ds rounded to k's dtype
  float* lse_s = Ss + BQ * (BK + 1);
  float* dl_s = lse_s + BQ;

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * BQ;
  const T* kp = k + (size_t)bh * Lk * D;
  const T* vp = v + (size_t)bh * Lk * D;
  const Bias<float> bs{bias ? bias + b * bsb + h * bsh : nullptr, bsq, bsk};
  const Bias<LB> ls{lbias ? lbias + b * lsb + h * lsh : nullptr, lsq, lsk};

  load_tile<T, D>(Qs, D, q + (size_t)bh * Lq * D, q0, Lq);
  load_tile<T, D>(dOs, D, dout + (size_t)bh * Lq * D, q0, Lq);
  if (tid < BQ) {
    const bool ok = q0 + tid < Lq;
    lse_s[tid] = ok ? lse[(size_t)bh * Lq + q0 + tid] : MASK_VALUE;
    dl_s[tid] = ok ? delta[(size_t)bh * Lq + q0 + tid] : 0.f;
  }

  float acc[4][CD];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < CD; ++j) acc[i][j] = 0.f;

  int nk = (Lk + BK - 1) / BK;
  if (causal) nk = min(nk, (q0 + BQ - 1) / BK + 1);
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // previous tile's readers are done with Ks/Vs/Ss
    load_tile<T, D>(Ks, D + 1, kp, k0, Lk);
    load_tile<T, D>(Vs, D + 1, vp, k0, Lk);
    __syncthreads();
    float p[4][4], ds[4][4];
    score_tile<D, LB>(Qs, dOs, Ks, Vs, lse_s, dl_s, q0, k0, Lq, Lk, scale, causal, bs, ls, p, ds);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) Ss[(ty * 4 + i) * (BK + 1) + tx + 16 * j] = round_to<T>(ds[i][j]);
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float sv[4], kv[CD];
#pragma unroll
      for (int i = 0; i < 4; ++i) sv[i] = Ss[(ty * 4 + i) * (BK + 1) + kk];
#pragma unroll
      for (int j = 0; j < CD; ++j) kv[j] = Ks[kk * (D + 1) + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < CD; ++j) acc[i][j] = fmaf(sv[i], kv[j], acc[i][j]);
    }
  }

  T* op = dq + (size_t)bh * Lq * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty * 4 + i;
    if (qi >= Lq) continue;
#pragma unroll
    for (int j = 0; j < CD; ++j) op[(size_t)qi * D + tx + 16 * j] = from_f<T>(acc[i][j]);
  }
}

template <int D>
constexpr size_t dkv_smem_floats() {
  return 2 * BK * (D + 1) + 2 * BQ * D + 2 * BQ * (BK + 1) + 2 * BQ;
}

template <typename T, typename LB, int D>
__global__ void __launch_bounds__(NT) flash_bwd_dkv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ bias, long long bsb, long long bsh, long long bsq, long long bsk,
    const LB* __restrict__ lbias, long long lsb, long long lsh, long long lsq, long long lsk,
    const T* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
    T* __restrict__ dk, T* __restrict__ dv, int H, int Lq, int Lk, float scale, int causal) {
  constexpr int CD = D / 16;
  extern __shared__ float smem[];
  float* Ks = smem;                  // [BK][D + 1]
  float* Vs = Ks + BK * (D + 1);     // [BK][D + 1]
  float* Qs = Vs + BK * (D + 1);     // [BQ][D]
  float* dOs = Qs + BQ * D;          // [BQ][D]
  float* Ps = dOs + BQ * D;          // [BQ][BK + 1]: p rounded to dO's dtype
  float* dSs = Ps + BQ * (BK + 1);   // [BQ][BK + 1]: ds rounded to q's dtype
  float* lse_s = dSs + BQ * (BK + 1);
  float* dl_s = lse_s + BQ;

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int k0 = blockIdx.x * BK;
  const T* qp = q + (size_t)bh * Lq * D;
  const T* dop = dout + (size_t)bh * Lq * D;
  const Bias<float> bs{bias ? bias + b * bsb + h * bsh : nullptr, bsq, bsk};
  const Bias<LB> ls{lbias ? lbias + b * lsb + h * lsh : nullptr, lsq, lsk};

  load_tile<T, D>(Ks, D + 1, k + (size_t)bh * Lk * D, k0, Lk);
  load_tile<T, D>(Vs, D + 1, v + (size_t)bh * Lk * D, k0, Lk);

  float dk_acc[4][CD], dv_acc[4][CD];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < CD; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;

  const int nq = (Lq + BQ - 1) / BQ;
  const int qt0 = causal ? k0 / BQ : 0;  // query tiles wholly above the diagonal see no key here
  for (int qt = qt0; qt < nq; ++qt) {
    const int q0 = qt * BQ;
    __syncthreads();  // previous tile's readers are done with Qs/dOs/Ps/dSs
    load_tile<T, D>(Qs, D, qp, q0, Lq);
    load_tile<T, D>(dOs, D, dop, q0, Lq);
    if (tid < BQ) {
      const bool ok = q0 + tid < Lq;
      lse_s[tid] = ok ? lse[(size_t)bh * Lq + q0 + tid] : MASK_VALUE;
      dl_s[tid] = ok ? delta[(size_t)bh * Lq + q0 + tid] : 0.f;
    }
    __syncthreads();
    float p[4][4], ds[4][4];
    score_tile<D, LB>(Qs, dOs, Ks, Vs, lse_s, dl_s, q0, k0, Lq, Lk, scale, causal, bs, ls, p, ds);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int at = (ty * 4 + i) * (BK + 1) + tx + 16 * j;
        Ps[at] = round_to<T>(p[i][j]);
        dSs[at] = round_to<T>(ds[i][j]);
      }
    __syncthreads();
    // this thread's keys are rows ty*4+i of the K tile, its columns tx+16j
#pragma unroll 4
    for (int r = 0; r < BQ; ++r) {
      float pv[4], sv[4], ov[CD], qv[CD];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pv[i] = Ps[r * (BK + 1) + ty * 4 + i];
        sv[i] = dSs[r * (BK + 1) + ty * 4 + i];
      }
#pragma unroll
      for (int j = 0; j < CD; ++j) {
        ov[j] = dOs[r * D + tx + 16 * j];
        qv[j] = Qs[r * D + tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < CD; ++j) {
          dv_acc[i][j] = fmaf(pv[i], ov[j], dv_acc[i][j]);
          dk_acc[i][j] = fmaf(sv[i], qv[j], dk_acc[i][j]);
        }
    }
  }

  T* dkp = dk + (size_t)bh * Lk * D;
  T* dvp = dv + (size_t)bh * Lk * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int ki = k0 + ty * 4 + i;
    if (ki >= Lk) continue;
#pragma unroll
    for (int j = 0; j < CD; ++j) {
      dkp[(size_t)ki * D + tx + 16 * j] = from_f<T>(dk_acc[i][j]);
      dvp[(size_t)ki * D + tx + 16 * j] = from_f<T>(dv_acc[i][j]);
    }
  }
}

struct Args {
  const void *q, *k, *v, *bias;
  long long bsb, bsh, bsq, bsk;
  const void* lbias;
  long long lsb, lsh, lsq, lsk;
  const void *dout, *lse, *delta;
  void *d1, *d2;  // dq, or dk and dv
  int B, H, Lq, Lk;
  float scale;
  int causal;
};

template <typename T, typename LB, int D>
int launch_dq(const Args& a, cudaStream_t stream) {
  const size_t smem = dq_smem_floats<D>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_kernel<T, LB, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((a.Lq + BQ - 1) / BQ, a.B * a.H);
  flash_bwd_dq_kernel<T, LB, D><<<grid, NT, smem, stream>>>(
      (const T*)a.q, (const T*)a.k, (const T*)a.v, (const float*)a.bias, a.bsb, a.bsh, a.bsq,
      a.bsk, (const LB*)a.lbias, a.lsb, a.lsh, a.lsq, a.lsk, (const T*)a.dout,
      (const float*)a.lse, (const float*)a.delta, (T*)a.d1, a.H, a.Lq, a.Lk, a.scale, a.causal);
  return (int)cudaGetLastError();
}

template <typename T, typename LB, int D>
int launch_dkv(const Args& a, cudaStream_t stream) {
  const size_t smem = dkv_smem_floats<D>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkv_kernel<T, LB, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((a.Lk + BK - 1) / BK, a.B * a.H);
  flash_bwd_dkv_kernel<T, LB, D><<<grid, NT, smem, stream>>>(
      (const T*)a.q, (const T*)a.k, (const T*)a.v, (const float*)a.bias, a.bsb, a.bsh, a.bsq,
      a.bsk, (const LB*)a.lbias, a.lsb, a.lsh, a.lsq, a.lsk, (const T*)a.dout,
      (const float*)a.lse, (const float*)a.delta, (T*)a.d1, (T*)a.d2, a.H, a.Lq, a.Lk, a.scale,
      a.causal);
  return (int)cudaGetLastError();
}

template <typename T, typename LB>
int dispatch(int which, int D, const Args& a, cudaStream_t s) {
  switch (D) {
    case 16: return which ? launch_dkv<T, LB, 16>(a, s) : launch_dq<T, LB, 16>(a, s);
    case 32: return which ? launch_dkv<T, LB, 32>(a, s) : launch_dq<T, LB, 32>(a, s);
    case 64: return which ? launch_dkv<T, LB, 64>(a, s) : launch_dq<T, LB, 64>(a, s);
    case 128: return which ? launch_dkv<T, LB, 128>(a, s) : launch_dq<T, LB, 128>(a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

int run(int which, const void* q, const void* k, const void* v, const void* bias, long long bsb,
        long long bsh, long long bsq, long long bsk, const void* lbias, long long lsb,
        long long lsh, long long lsq, long long lsk, const void* dout, const void* lse,
        const void* delta, void* d1, void* d2, int B, int H, int Lq, int Lk, int D, float scale,
        int causal, int lb_bf16, void* stream) {
  if (B == 0 || H == 0 || Lq == 0 || Lk == 0) return 0;
  const Args a{q, k, v, bias, bsb, bsh, bsq, bsk, lbias, lsb, lsh, lsq, lsk, dout, lse, delta,
               d1, d2, B, H, Lq, Lk, scale, causal};
  cudaStream_t s = (cudaStream_t)stream;
  return lb_bf16 ? dispatch<float, __nv_bfloat16>(which, D, a, s)
                 : dispatch<float, float>(which, D, a, s);
}

}  // namespace

extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v, const void* bias,
                            long long bsb, long long bsh, long long bsq, long long bsk,
                            const void* lbias, long long lsb, long long lsh, long long lsq,
                            long long lsk, const void* dout, const void* lse, const void* delta,
                            void* dq, int B, int H, int Lq, int Lk, int D, float scale,
                            int causal, int lb_bf16, void* stream) {
  return run(0, q, k, v, bias, bsb, bsh, bsq, bsk, lbias, lsb, lsh, lsq, lsk, dout, lse, delta,
             dq, nullptr, B, H, Lq, Lk, D, scale, causal, lb_bf16, stream);
}

extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v, const void* bias,
                             long long bsb, long long bsh, long long bsq, long long bsk,
                             const void* lbias, long long lsb, long long lsh, long long lsq,
                             long long lsk, const void* dout, const void* lse, const void* delta,
                             void* dk, void* dv, int B, int H, int Lq, int Lk, int D, float scale,
                             int causal, int lb_bf16, void* stream) {
  return run(1, q, k, v, bias, bsb, bsh, bsq, bsk, lbias, lsb, lsh, lsq, lsk, dout, lse, delta,
             dk, dv, B, H, Lq, Lk, D, scale, causal, lb_bf16, stream);
}
