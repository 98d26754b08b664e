// Flash decode for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the TPU Pallas kernel distributed_llms_example_tpu/ops/
// flash_attention.py `_decode_kernel` (reached through `flash_decode` and
// `flash_decode_run`): a short q block of Q <= 8 rows against a full-length
// (B, H, L, D) K/V cache of which only a prefix is live.
//
//   row r of batch b attends cache slots k_pos <= offsets[b] + r
//   (bottom-right aligned per-row length mask), o = softmax(scale*qk^T +
//   bias) v with an fp32 online softmax; a row whose sum l is 0 divides by 1.
//
// q: (B, H, Q, D) fp32/bf16; k, v: (B, H, L, D) of q's dtype, or int8 with
// k_scale / v_scale (B, H, L) fp32, dequantised per tile as
// float(x) * scale -- the same expression as `dequantize_kv`.  `bias`
// (fp32, may be null) is read through element strides (0 for a size-1 dim).
// Any cache length L (every tile is bounds-checked); K/V 16-byte aligned.
// One block per (b, h); the loop runs only over kv tiles whose first slot
// is <= offsets[b] + Q - 1, so dead tiles past the longest live row are
// never read.  As on the TPU, p is rounded to v's (dequantised) dtype
// before the value product.
//
// What bounds it on the H100: decode does 4*Q*live*D flops per (b, h)
// against 2*live*D elements of K/V, about Q flops per byte -- far below the
// ~295 flops/byte where the tensor cores would matter -- so it is bound by
// bytes, and at serve shapes (B*H = 128 blocks, L = 128) by launch latency
// and the one-block-per-(b, h) grid filling 128 of 132 SMs.  The design
// reads each live K/V element once, keeps scores and the accumulator in
// shared memory, moves int8 K/V at one byte per element, and loads K/V
// rows 16 bytes per thread (2-byte loads left a bf16 tile latency-bound:
// 0.6 ms a call at the llama-2-7b shape).  Splitting long caches over
// several blocks per (b, h) is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BK = 64;   // cache slots per tile
constexpr int NT = 128;  // threads: four warps
constexpr int MAXQ = 8;  // MAX_DECODE_Q_ROWS

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(int8_t x) { return (float)x; }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// p is rounded to the dtype the value product sees: v's own float dtype,
// or fp32 once int8 values are dequantised
template <typename KV> __device__ __forceinline__ float round_p(float x) { return to_f(from_f<KV>(x)); }
template <> __device__ __forceinline__ float round_p<int8_t>(float x) { return x; }

template <int D>
constexpr size_t smem_floats() {
  return MAXQ * D + BK * (D + 1) + BK * D + MAXQ * BK + MAXQ * D + 3 * MAXQ;
}

template <typename T, typename KV, int D>
__global__ void __launch_bounds__(NT) flash_decode_kernel(
    const T* __restrict__ q, const KV* __restrict__ k, const KV* __restrict__ v,
    const float* __restrict__ k_scale, const float* __restrict__ v_scale,
    const float* __restrict__ bias, long long bsb, long long bsh, long long bsq, long long bsk,
    const int* __restrict__ offsets, T* __restrict__ o, int H, int Q, int L, float scale) {
  extern __shared__ float smem[];
  float* Qs = smem;                   // [MAXQ][D]
  float* Ks = Qs + MAXQ * D;          // [BK][D + 1]
  float* Vs = Ks + BK * (D + 1);      // [BK][D]
  float* Ss = Vs + BK * D;            // [MAXQ][BK]
  float* Acc = Ss + MAXQ * BK;        // [MAXQ][D]
  float* m_s = Acc + MAXQ * D;        // [MAXQ]
  float* l_s = m_s + MAXQ;            // [MAXQ]
  float* a_s = l_s + MAXQ;            // [MAXQ]

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int off = offsets[b];
  const T* qp = q + (size_t)bh * Q * D;
  const KV* kp = k + (size_t)bh * L * D;
  const KV* vp = v + (size_t)bh * L * D;
  const float* ksp = k_scale ? k_scale + (size_t)bh * L : nullptr;
  const float* vsp = v_scale ? v_scale + (size_t)bh * L : nullptr;
  const float* bp = bias ? bias + b * bsb + h * bsh : nullptr;

  for (int i = tid; i < Q * D; i += NT) {
    Qs[i] = to_f(qp[i]);
    Acc[i] = 0.f;
  }
  if (tid < Q) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }

  // tiles past the longest live row (slot offsets[b] + Q - 1) contribute nothing
  const long long last = (long long)off + Q - 1;
  const int nk = (int)min((long long)(L + BK - 1) / BK, last / BK + 1);
  constexpr int VEC = 16 / sizeof(KV);  // elements of one 16-byte load

  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();
#pragma unroll
    for (int i = tid; i < BK * D / VEC; i += NT) {
      const int r = i / (D / VEC), c = (i % (D / VEC)) * VEC;
      const int pos = k0 + r;
      KV kx[VEC], vx[VEC];
      float ksc = 0.f, vsc = 0.f;
      if (pos < L) {
        *reinterpret_cast<uint4*>(kx) = *reinterpret_cast<const uint4*>(kp + (size_t)pos * D + c);
        *reinterpret_cast<uint4*>(vx) = *reinterpret_cast<const uint4*>(vp + (size_t)pos * D + c);
        if (ksp) {
          ksc = ksp[pos];
          vsc = vsp[pos];
        }
      }
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        float kf = 0.f, vf = 0.f;
        if (pos < L) {
          kf = to_f(kx[j]);
          vf = to_f(vx[j]);
          if (ksp) {
            kf *= ksc;
            vf *= vsc;
          }
        }
        Ks[r * (D + 1) + c + j] = kf;
        Vs[r * D + c + j] = vf;
      }
    }
    __syncthreads();

    for (int e = tid; e < Q * BK; e += NT) {
      const int r = e / BK, c = e % BK;
      const long long pos = k0 + c;
      float x = -INFINITY;
      if (pos < L && pos <= (long long)off + r) {
        float dot = 0.f;
#pragma unroll 16
        for (int d = 0; d < D; ++d) dot = fmaf(Qs[r * D + d], Ks[c * (D + 1) + d], dot);
        x = dot * scale;
        if (bp) x += bp[(long long)r * bsq + pos * bsk];
      }
      Ss[r * BK + c] = x;
    }
    __syncthreads();

    for (int r = warp; r < Q; r += NT / 32) {
      float* row = Ss + r * BK;
      float mx = -INFINITY;
      for (int c = lane; c < BK; c += 32) mx = fmaxf(mx, row[c]);
#pragma unroll
      for (int w = 16; w > 0; w /= 2) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
      const float m_prev = m_s[r];
      const float m_next = fmaxf(m_prev, mx);
      const float safe_m = (m_next == -INFINITY) ? 0.f : m_next;
      float sum = 0.f;
      for (int c = lane; c < BK; c += 32) {
        const float p = expf(row[c] - safe_m);
        sum += p;
        row[c] = round_p<KV>(p);
      }
#pragma unroll
      for (int w = 16; w > 0; w /= 2) sum += __shfl_xor_sync(0xffffffffu, sum, w);
      if (lane == 0) {
        const float alpha = expf(m_prev - safe_m);
        m_s[r] = m_next;
        l_s[r] = alpha * l_s[r] + sum;
        a_s[r] = alpha;
      }
    }
    __syncthreads();

    for (int e = tid; e < Q * D; e += NT) {
      const int r = e / D, c = e % D;
      float a = Acc[e] * a_s[r];
#pragma unroll 16
      for (int kk = 0; kk < BK; ++kk) a = fmaf(Ss[r * BK + kk], Vs[kk * D + c], a);
      Acc[e] = a;
    }
  }
  __syncthreads();

  T* op = o + (size_t)bh * Q * D;
  for (int e = tid; e < Q * D; e += NT) {
    const float l = l_s[e / D];
    op[e] = from_f<T>(Acc[e] / ((l == 0.f) ? 1.f : l));
  }
}

template <typename T, typename KV, int D>
int launch(const void* q, const void* k, const void* v, const void* ks, const void* vs,
           const void* bias, long long bsb, long long bsh, long long bsq, long long bsk,
           const void* offsets, void* o, int B, int H, int Q, int L, float scale,
           cudaStream_t stream) {
  const size_t smem = smem_floats<D>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(flash_decode_kernel<T, KV, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  flash_decode_kernel<T, KV, D><<<B * H, NT, smem, stream>>>(
      (const T*)q, (const KV*)k, (const KV*)v, (const float*)ks, (const float*)vs,
      (const float*)bias, bsb, bsh, bsq, bsk, (const int*)offsets, (T*)o, H, Q, L, scale);
  return (int)cudaGetLastError();
}

template <typename T, typename KV>
int dispatch_d(int D, const void* q, const void* k, const void* v, const void* ks,
               const void* vs, const void* bias, long long bsb, long long bsh, long long bsq,
               long long bsk, const void* offsets, void* o, int B, int H, int Q, int L,
               float scale, cudaStream_t s) {
  switch (D) {
    case 16: return launch<T, KV, 16>(q, k, v, ks, vs, bias, bsb, bsh, bsq, bsk, offsets, o, B, H, Q, L, scale, s);
    case 32: return launch<T, KV, 32>(q, k, v, ks, vs, bias, bsb, bsh, bsq, bsk, offsets, o, B, H, Q, L, scale, s);
    case 64: return launch<T, KV, 64>(q, k, v, ks, vs, bias, bsb, bsh, bsq, bsk, offsets, o, B, H, Q, L, scale, s);
    case 128: return launch<T, KV, 128>(q, k, v, ks, vs, bias, bsb, bsh, bsq, bsk, offsets, o, B, H, Q, L, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int flash_decode(const void* q, const void* k, const void* v, const void* k_scale,
                            const void* v_scale, const void* bias, long long bsb, long long bsh,
                            long long bsq, long long bsk, const void* offsets, void* o, int B,
                            int H, int Q, int L, int D, float scale, int is_bf16, int is_int8,
                            void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (Q < 1 || Q > MAXQ) return (int)cudaErrorInvalidValue;
  if (is_bf16) {
    if (is_int8)
      return dispatch_d<__nv_bfloat16, int8_t>(D, q, k, v, k_scale, v_scale, bias, bsb, bsh, bsq,
                                               bsk, offsets, o, B, H, Q, L, scale, s);
    return dispatch_d<__nv_bfloat16, __nv_bfloat16>(D, q, k, v, k_scale, v_scale, bias, bsb, bsh,
                                                    bsq, bsk, offsets, o, B, H, Q, L, scale, s);
  }
  if (is_int8)
    return dispatch_d<float, int8_t>(D, q, k, v, k_scale, v_scale, bias, bsb, bsh, bsq, bsk,
                                     offsets, o, B, H, Q, L, scale, s);
  return dispatch_d<float, float>(D, q, k, v, k_scale, v_scale, bias, bsb, bsh, bsq, bsk, offsets,
                                  o, B, H, Q, L, scale, s);
}
