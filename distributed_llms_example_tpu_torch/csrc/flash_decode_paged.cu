// Paged flash decode for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the TPU Pallas kernel distributed_llms_example_tpu/ops/
// flash_attention.py `_decode_paged_kernel` (reached through
// `flash_decode_paged`): one decode step of Q <= 8 rows whose K/V live in a
// shared block pool that each batch row maps through its block table.
//
//   logical slot p of row b lives in pool block block_tables[b, p / bs] at
//   in-block position p % bs; row r of batch b attends logical slots
//   p <= offsets[b] + r; o = softmax(scale*qk^T + bias) v with an fp32
//   online softmax; a row whose sum l is 0 divides by 1.
//
// q: (B, H, Q, D) fp32/bf16; k_pool, v_pool: (N, H_kv, bs, D) of q's dtype,
// or int8 with k_scale / v_scale pools (N, H_kv, bs) fp32, dequantised as
// float(x) * scale -- the same expression as `dequantize_kv`.  q head h
// reads pool head h / (H / H_kv) (grouped-query attention without
// materialising the repeat).  block_tables: (B, n_tiles) int32; an entry
// >= N is an unallocated tile: its block is never read and its slots
// contribute nothing.  `bias` (fp32, may be null) is read through element
// strides in logical slot order (0 for a size-1 dim).  Any bs; a logical
// length n_tiles * bs below 2^31; pools 16-byte aligned.
//
// Design: kernel 5's (csrc/flash_decode.cu) -- one block per (b, h), the
// logical cache walked in 64-slot tiles in order, the same accumulation
// order and the same p rounding -- with each slot's K/V fetched through the
// block table instead of from a flat (B, H, L, D) buffer.  A tile whose
// slots all map to unallocated entries is skipped whole, and so are tiles
// past offsets[b] + Q - 1.  Where the skipped slots are masked anyway (the
// prompt gap under the padding bias, the tail past the offset), the result
// equals kernel 5 over the gathered view of the same blocks bit for bit:
// a skipped tile would have multiplied the accumulator by exp(0) = 1 and
// added zeros.
//
// What bounds it on the H100: like kernel 5, about Q flops per byte of
// K/V, far below the ~295 flops/byte where tensor cores matter, so it is
// bound by the bytes of the live K/V (read once) and, at serve shapes
// (B*H = 256 blocks), by launch latency.  Each tile resolves its 64 slots
// through the block table once (one lookup per slot, kept in shared
// memory), then loads K/V rows 16 bytes per thread.  TMA block copies,
// tensor cores and splitting long caches over several blocks per (b, h)
// are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BK = 64;   // logical cache slots per tile
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
__global__ void __launch_bounds__(NT) flash_decode_paged_kernel(
    const T* __restrict__ q, const KV* __restrict__ k, const KV* __restrict__ v,
    const float* __restrict__ k_scale, const float* __restrict__ v_scale,
    const float* __restrict__ bias, long long bsb, long long bsh, long long bsq, long long bsk,
    const int* __restrict__ block_tables, const int* __restrict__ offsets, T* __restrict__ o,
    int H, int H_kv, int Q, int n_tiles, int bs, int N, float scale) {
  extern __shared__ float smem[];
  float* Qs = smem;                   // [MAXQ][D]
  float* Ks = Qs + MAXQ * D;          // [BK][D + 1]
  float* Vs = Ks + BK * (D + 1);      // [BK][D]
  float* Ss = Vs + BK * D;            // [MAXQ][BK]
  float* Acc = Ss + MAXQ * BK;        // [MAXQ][D]
  float* m_s = Acc + MAXQ * D;        // [MAXQ]
  float* l_s = m_s + MAXQ;            // [MAXQ]
  float* a_s = l_s + MAXQ;            // [MAXQ]
  // per slot of the current tile: its row in the pool (in rows of D
  // elements, for pool head hk), or -1 for a slot past the cache or in an
  // unallocated tile -- one block-table lookup per slot, not per element
  __shared__ long long row_of[BK];

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int hk = h / (H / H_kv);
  const int off = offsets[b];
  const int L = n_tiles * bs;
  const int* bt = block_tables + (size_t)b * n_tiles;
  const T* qp = q + (size_t)bh * Q * D;
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
  const int last = off + Q - 1;
  const int nk = min((L + BK - 1) / BK, last / BK + 1);
  constexpr int VEC = 16 / sizeof(KV);  // elements of one 16-byte load

  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();
    long long slot_row = -1;
    if (tid < BK && k0 + tid < L) {
      const int blk = bt[(k0 + tid) / bs];
      if (blk < N) slot_row = ((long long)blk * H_kv + hk) * bs + (k0 + tid) % bs;
    }
    if (tid < BK) row_of[tid] = slot_row;
    // a tile whose every slot is unallocated is skipped whole (uniform
    // across the block: __syncthreads_or is a barrier)
    if (!__syncthreads_or(slot_row >= 0)) continue;

#pragma unroll
    for (int i = tid; i < BK * D / VEC; i += NT) {
      const int r = i / (D / VEC), c = (i % (D / VEC)) * VEC;
      const long long rr = row_of[r];
      KV kx[VEC], vx[VEC];
      float ksc = 0.f, vsc = 0.f;
      if (rr >= 0) {
        *reinterpret_cast<uint4*>(kx) = *reinterpret_cast<const uint4*>(k + rr * D + c);
        *reinterpret_cast<uint4*>(vx) = *reinterpret_cast<const uint4*>(v + rr * D + c);
        if (k_scale) {
          ksc = k_scale[rr];
          vsc = v_scale[rr];
        }
      }
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        float kf = 0.f, vf = 0.f;
        if (rr >= 0) {
          kf = to_f(kx[j]);
          vf = to_f(vx[j]);
          if (k_scale) {
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
      const int pos = k0 + c;
      float x = -INFINITY;
      if (row_of[c] >= 0 && pos <= off + r) {
        float dot = 0.f;
#pragma unroll 16
        for (int d = 0; d < D; ++d) dot = fmaf(Qs[r * D + d], Ks[c * (D + 1) + d], dot);
        x = dot * scale;
        if (bp) x += bp[(long long)r * bsq + (long long)pos * bsk];
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

struct Args {
  const void *q, *k, *v, *ks, *vs, *bias;
  long long bsb, bsh, bsq, bsk;
  const void *block_tables, *offsets;
  void* o;
  int B, H, H_kv, Q, n_tiles, bs, N;
  float scale;
};

template <typename T, typename KV, int D>
int launch(const Args& a, cudaStream_t stream) {
  const size_t smem = smem_floats<D>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(flash_decode_paged_kernel<T, KV, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  flash_decode_paged_kernel<T, KV, D><<<a.B * a.H, NT, smem, stream>>>(
      (const T*)a.q, (const KV*)a.k, (const KV*)a.v, (const float*)a.ks, (const float*)a.vs,
      (const float*)a.bias, a.bsb, a.bsh, a.bsq, a.bsk, (const int*)a.block_tables,
      (const int*)a.offsets, (T*)a.o, a.H, a.H_kv, a.Q, a.n_tiles, a.bs, a.N, a.scale);
  return (int)cudaGetLastError();
}

template <typename T, typename KV>
int dispatch_d(int D, const Args& a, cudaStream_t s) {
  switch (D) {
    case 16: return launch<T, KV, 16>(a, s);
    case 32: return launch<T, KV, 32>(a, s);
    case 64: return launch<T, KV, 64>(a, s);
    case 128: return launch<T, KV, 128>(a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int flash_decode_paged(const void* q, const void* k_pool, const void* v_pool,
                                  const void* k_scale, const void* v_scale, const void* bias,
                                  long long bsb, long long bsh, long long bsq, long long bsk,
                                  const void* block_tables, const void* offsets, void* o, int B,
                                  int H, int H_kv, int Q, int n_tiles, int bs, int N, int D,
                                  float scale, int is_bf16, int is_int8, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (Q < 1 || Q > MAXQ || H_kv < 1 || H % H_kv != 0 || bs < 1 || n_tiles < 1 || N < 1)
    return (int)cudaErrorInvalidValue;
  const Args a{q, k_pool, v_pool, k_scale, v_scale, bias, bsb, bsh, bsq, bsk, block_tables,
               offsets, o, B, H, H_kv, Q, n_tiles, bs, N, scale};
  if (is_bf16)
    return is_int8 ? dispatch_d<__nv_bfloat16, int8_t>(D, a, s)
                   : dispatch_d<__nv_bfloat16, __nv_bfloat16>(D, a, s);
  return is_int8 ? dispatch_d<float, int8_t>(D, a, s) : dispatch_d<float, float>(D, a, s);
}
