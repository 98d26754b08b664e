// Flash decode for Hopper (sm_90a): the one kernel body of kernels 5 and 6.
//
// Replaces two TPU Pallas kernels of distributed_llms_example_tpu/ops/
// flash_attention.py, one decode step of Q <= 8 q rows each:
//
// - `_decode_kernel` (kernel 5, reached through `flash_decode`) against a
//   flat (B, H, L, D) cache: C entry csrc/flash_decode.cu, PAGED = 0;
// - `_decode_paged_kernel` (kernel 6, through `flash_decode_paged`)
//   against a shared block pool that each batch row maps through its block
//   table: C entry csrc/flash_decode_paged.cu, PAGED = 1.
//
//   Logical slot p of row b lives in pool block blk at in-block position
//   p % bs.  Paged: blk = block_tables[b, p / bs], an entry >= N being an
//   unallocated tile (its block is never read, its slots contribute
//   nothing).  Flat: the cache is a pool with one block of L slots a row
//   (blk = b, N = B, H_kv = H, bs = L, one tile of the table), so a slot's
//   row is (b H + h) L + p, every slot p < L is allocated, and no table
//   exists.  Row r of batch b attends logical slots p <= offsets[b] + r;
//   o = softmax(scale*qk^T + bias) v with an fp32 online softmax; a row
//   whose sum l is 0 divides by 1.
//
// q: (B, H, Q, D) fp32/bf16; K/V of q's dtype, or int8 with fp32 scales
// (one a slot, laid out as the cache without D), dequantised as
// float(x) * scale -- the same expression as `dequantize_kv`.  q head h
// reads pool head h / (H / H_kv) (grouped-query attention without
// materialising the repeat).  `bias` (fp32, may be null) is read through
// element strides in logical slot order (0 for a size-1 dim).  Any bs and
// any L; a logical length below 2^31; K/V 16-byte aligned.
//
// Arithmetic, one order for both entries, so that kernel 6 equals kernel 5
// over the gathered view of the same blocks bit for bit: one CTA per
// (b, h); the logical cache walked in 64-slot tiles in order; per score
// one sequential fmaf chain over d; the lane-strided max and sum of one
// warp per row with the same shuffles; p rounded to v's dtype; per output
// element one fmaf chain over the tile's 64 slots after the rescale by
// alpha.  Tiles past offsets[b] + Q - 1 are never read.  A paged tile
// whose slots all map to unallocated entries is skipped whole; where such
// slots are masked anyway (the prompt gap under the padding bias, the tail
// past the offset), a skipped tile would have multiplied the accumulator
// by exp(0) = 1 and added zeros.  A flat cache has no such tile.
//
// What bounds it on the H100: about Q flops per byte of K/V, far below the
// ~295 flops/byte where tensor cores matter, so the bytes of K/V (read
// once) bound it, and the longest row's CTA sets the time: ~18 tiles at
// the llama-2-7b flat decode step.  At the seq2seq serve shapes (two tiles
// a row) the latency of device memory and of the launch bound it.  The
// design moves the bytes without stalling the arithmetic:
//
// - Shared memory holds K and V in their storage dtype (a bf16 64-slot
//   tile is 16 KB at d = 128, int8 with its per-slot scales), widened to
//   fp32 as they are read.  Rows are swizzled (16-byte chunks XORed with
//   the row) so that a warp reading 32 rows at one chunk hits distinct
//   banks.
// - A ring of three stages of 16-byte cp.async copies keeps the next
//   tiles' copies in flight while a tile is computed, so a CTA waits out
//   the latency of device memory once, not once a tile.  K and V of a tile
//   travel apart (K is read a step before V), so two tiles' bytes are in
//   flight against one when they travelled together.  A flat tile's rows
//   are contiguous: a warp copies 512 contiguous bytes at a time.  A paged
//   slot's row is found by the thread that issues its copies, with the
//   block-table entry loaded one tile ahead.
// - A score's bias is loaded before its product, under whose latency it
//   arrives.
// - The threads are split in two groups of two warps: the score group
//   computes tile t's scores (one slot a thread, every q row at once from
//   one read of K) and its online-softmax step, while the value group
//   computes tile t - 1's p V.  At Q = 1 neither half idles.
// - Instances for one q row (the decode step) or eight, so that a one-row
//   step carries no idle rows; 2 CTAs a SM at bf16 d = 128 (~106 KB of
//   shared memory each), so the 256 (b, h) CTAs of the llama-2-7b step run
//   in one wave.
//
// Splitting a row's cache over several CTAs (flash-decoding) would change
// the summation order of both entries at once: later work.

#pragma once

#include <math.h>

#include "hopper.cuh"

namespace {

constexpr int BK = 64;      // logical cache slots per tile
constexpr int NT = 128;     // threads: four warps
constexpr int SG = 64;      // the score group (warps 0-1); warps 2-3 are the value group
constexpr int MAXQ = 8;     // MAX_DECODE_Q_ROWS
constexpr int STAGES = 3;   // K/V tiles in the ring

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(int8_t x) { return (float)x; }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// the EPC values of one 16-byte chunk, widened to fp32 exactly as to_f
// widens each (bf16: the high half of an fp32; int8: sign-extended)
template <typename KV, int EPC>
__device__ __forceinline__ void widen(const uint4& raw, float (&out)[EPC]) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < EPC; ++i) {
    const uint32_t x = w[i * 4 / EPC];
    if constexpr (sizeof(KV) == 4) out[i] = __uint_as_float(x);
    else if constexpr (sizeof(KV) == 2) out[i] = __uint_as_float(i % 2 ? x & 0xffff0000u : x << 16);
    else out[i] = (float)(int8_t)(x >> (8 * (i % 4)));
  }
}

// p is rounded to the dtype the value product sees: v's own float dtype,
// or fp32 once int8 values are dequantised
template <typename KV> __device__ __forceinline__ float round_p(float x) { return to_f(from_f<KV>(x)); }
template <> __device__ __forceinline__ float round_p<int8_t>(float x) { return x; }

// shared memory: STAGES stages of (K tile, V tile, K and V scales, slot
// flags), then q in fp32, two buffers of scores / p, and m, l and two
// buffers of alpha per q row
template <typename KV, int D> struct Smem {
  static constexpr int ROW = D * (int)sizeof(KV);  // bytes of one K or V row
  static constexpr int EPC = 16 / (int)sizeof(KV);  // elements of a 16-byte chunk
  static constexpr int CPR = ROW / 16;              // chunks of a row
  static constexpr int TILE = BK * ROW;
  static constexpr int K = 0;
  static constexpr int V = TILE;
  static constexpr int KSC = 2 * TILE;
  static constexpr int VSC = KSC + BK * 4;
  static constexpr int OK = VSC + BK * 4;
  static constexpr int STAGE = OK + BK * 4;
  static constexpr int QS = STAGES * STAGE;
  static constexpr int SS = QS + MAXQ * D * 4;
  static constexpr int M = SS + 2 * MAXQ * BK * 4;
  static constexpr int BYTES = M + 4 * MAXQ * 4;

  // byte offset of 16-byte chunk j of row c in a tile: the chunk index
  // XORed with the row (rows of 128 bytes or more), or with the 128-byte
  // line (shorter rows), so that 8 neighbouring rows read at one chunk
  // index fall in 8 distinct bank groups
  static __device__ __forceinline__ int off(int c, int j) {
    if constexpr (ROW >= 128) {
      return c * ROW + ((j ^ (c & 7)) << 4);
    } else {
      const int o = c * ROW + (j << 4);
      return o ^ (((o >> 7) & 7) << 4);
    }
  }
  // element e of row c
  static __device__ __forceinline__ int elem(int c, int e) {
    return off(c, e / EPC) + (e % EPC) * (int)sizeof(KV);
  }
};

__device__ __forceinline__ void score_group_bar() {
  asm volatile("bar.sync 1, 64;\n" ::: "memory");
}

// PAGED: whether slots are found through block tables (kernel 6) or in a
// flat cache (kernel 5; block_tables unused).  BF16 / INT8: q's dtype, and
// whether K/V are int8.  QM: the most q rows the instance takes (1, the
// decode step, or MAXQ): the per-row loops run to QM, so a one-row step
// carries no idle rows
template <int PAGED, int BF16, int INT8, int D, int QM>
__global__ void __launch_bounds__(NT, 2) flash_decode_kernel(
    const void* __restrict__ q_, const void* __restrict__ k_, const void* __restrict__ v_,
    const float* __restrict__ k_scale, const float* __restrict__ v_scale,
    const float* __restrict__ bias, long long bsb, long long bsh, long long bsq, long long bsk,
    const int* __restrict__ block_tables, const int* __restrict__ offsets, void* __restrict__ o_,
    int H, int H_kv, int Q, int n_tiles, int bs, int N, float scale) {
  using T = std::conditional_t<BF16 != 0, __nv_bfloat16, float>;
  using KV = std::conditional_t<INT8 != 0, int8_t, T>;
  using L = Smem<KV, D>;
  const KV* __restrict__ k = static_cast<const KV*>(k_);
  const KV* __restrict__ v = static_cast<const KV*>(v_);
  extern __shared__ __align__(16) uint8_t smem[];
  float* Qs = reinterpret_cast<float*>(smem + L::QS);  // [MAXQ][D]
  float* Ss = reinterpret_cast<float*>(smem + L::SS);  // [2][MAXQ][BK]
  float* m_s = reinterpret_cast<float*>(smem + L::M);  // [MAXQ]
  float* l_s = m_s + MAXQ;                             // [MAXQ]
  float* a_s = l_s + MAXQ;                             // [2][MAXQ]

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int hk = h / (H / H_kv);
  const int off = offsets[b];
  const int len = n_tiles * bs;  // logical cache length
  const int* bt = PAGED ? block_tables + (size_t)b * n_tiles : nullptr;
  const T* __restrict__ qp = static_cast<const T*>(q_) + (size_t)bh * Q * D;
  const float* bp = bias ? bias + b * bsb + h * bsh : nullptr;

  for (int i = tid; i < QM * D; i += NT) Qs[i] = i < Q * D ? to_f(qp[i]) : 0.f;
  if (tid < Q) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }

  // tiles past the longest live row (slot offsets[b] + Q - 1) contribute nothing
  const int last = off + Q - 1;
  const int nk = min((len + BK - 1) / BK, last / BK + 1);

  // copies.  K and V of a tile travel apart: the score group reads K(t)
  // in step t, the value group V(t) in step t + 1, so K(t + 2) is issued
  // at the top of step t (its stage's K was read in step t - 1) and
  // V(t + 2) at its end: V(t), K(t + 1), V(t + 1) and K(t + 2) are in
  // flight while tile t is computed.  Flat: a warp copies 512 contiguous
  // bytes of a tile at a time (a tile's rows are contiguous).  Paged:
  // thread pair (2c, 2c + 1) fetches slot c, the even and the odd chunks
  // of its row, its block-table entry loaded one tile ahead
  const int cs = tid >> 1, half = tid & 1;
  auto lookup = [&](int t) {  // the block of slot cs of tile t, or N for none
    const int pos = t * BK + cs;
    return pos < len ? bt[pos / bs] : N;
  };
  int blk_next = PAGED ? lookup(0) : 0, blk_v = 0;
  // K or V of tile t, with its scales and (K) the slot flags
  auto issue = [&](int t, bool isv) {
    uint8_t* st = smem + (t % STAGES) * L::STAGE;
    const uint32_t dst = smem_u32(st) + (isv ? L::V : L::K);
    const uint32_t sdst = smem_u32(st) + (isv ? L::VSC : L::KSC);
    const KV* src = isv ? v : k;
    const float* sc = isv ? v_scale : k_scale;
    int* flags = reinterpret_cast<int*>(st + L::OK);
    if constexpr (PAGED == 0) {
      const long long r0 = (long long)bh * len + t * BK;  // the tile's first row
      constexpr int NCH = BK * L::CPR;                    // its chunks
#pragma unroll
      for (int i = 0; i < (NCH + NT - 1) / NT; ++i) {
        const int g = tid + NT * i, c = g / L::CPR, j = g % L::CPR;
        const bool ok = t * BK + c < len;
        if (NCH % NT == 0 || g < NCH)
          cp_async16(dst + L::off(c, j), src + (ok ? (r0 + c) * D + j * L::EPC : 0),
                     ok ? 16 : 0);
      }
      if (tid < BK) {
        const bool ok = t * BK + tid < len;
        if constexpr (INT8 != 0) cp_async4(sdst + tid * 4, sc + (ok ? r0 + tid : 0), ok ? 4 : 0);
        if (!isv) flags[tid] = ok;
      }
    } else {
      if (!isv) {
        blk_v = blk_next;
        blk_next = lookup(t + 1);  // in flight until the next issue
      }
      const int pos = t * BK + cs;
      const bool ok = blk_v < N;
      const long long row = ok ? ((long long)blk_v * H_kv + hk) * bs + pos % bs : 0;
#pragma unroll
      for (int i = 0; i < (L::CPR + 1) / 2; ++i) {
        const int j = 2 * i + half;
        if (L::CPR % 2 == 0 || j < L::CPR)
          cp_async16(dst + L::off(cs, j), src + row * D + j * L::EPC, ok ? 16 : 0);
      }
      if (!half) {
        if constexpr (INT8 != 0) cp_async4(sdst + cs * 4, sc + row, ok ? 4 : 0);
        if (!isv) flags[cs] = ok;
      }
    }
  };
  // tiles 0 and 1 whole, each followed by an empty group, so that at the
  // top of step t the groups after K(t)'s are always three
#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) {
    if (t < nk) {
      issue(t, false);
      issue(t, true);
    }
    cp_async_commit();
    cp_async_commit();
  }
  __syncthreads();  // q and the first tiles' slot flags, for every thread

  // the value group's outputs: element e = (tid - SG) + SG * n of the
  // (Q, D) block
  constexpr int NO = (QM * D + NT - SG - 1) / (NT - SG);
  float acc[NO];
#pragma unroll
  for (int n = 0; n < NO; ++n) acc[n] = 0.f;

  bool live_prev = false;
  for (int t = 0; t <= nk; ++t) {
    cp_async_wait<3>();  // K(t) has landed, and V(t - 1) before it
    const uint8_t* st = smem + (t % STAGES) * L::STAGE;
    // a tile whose every slot is unallocated is skipped whole (uniform
    // across the block: __syncthreads_or is a barrier); a flat tile
    // t < nk always holds slot t * BK < L, so is never skipped
    const bool live = __syncthreads_or(t < nk && tid < BK &&
                                       reinterpret_cast<const int*>(st + L::OK)[tid]);
    if (t + STAGES - 1 < nk) issue(t + STAGES - 1, false);
    cp_async_commit();
    if (tid < SG) {
      if (live) {
        // scores of tile t: slot c = tid, every q row from one read of K
        const int c = tid, pos = t * BK + c;
        const bool ok = reinterpret_cast<const int*>(st + L::OK)[c];
        const uint8_t* kt = st + L::K;
        float ksc = 0.f;
        if constexpr (INT8 != 0) ksc = reinterpret_cast<const float*>(st + L::KSC)[c];
        float dot[QM], bv[QM];
#pragma unroll
        for (int r = 0; r < QM; ++r) {
          dot[r] = 0.f;
          // the bias, loaded before the product so that its latency hides
          const bool biased = bp && r < Q && ok && pos <= off + r;
          bv[r] = biased ? bp[(long long)r * bsq + (long long)pos * bsk] : 0.f;
        }
        if (ok && pos <= last) {
#pragma unroll 4
          for (int j = 0; j < L::CPR; ++j) {
            float kf[L::EPC];
            widen<KV>(*reinterpret_cast<const uint4*>(kt + L::off(c, j)), kf);
            if constexpr (INT8 != 0) {
#pragma unroll
              for (int e = 0; e < L::EPC; ++e) kf[e] *= ksc;
            }
            // every row up to QM, branch-free (rows past Q are zeros, unused)
#pragma unroll
            for (int r = 0; r < QM; ++r) {
              const float* qr = Qs + r * D + j * L::EPC;
#pragma unroll
              for (int e = 0; e < L::EPC; ++e) dot[r] = fmaf(qr[e], kf[e], dot[r]);
            }
          }
        }
        float* sb = Ss + (t & 1) * MAXQ * BK;
#pragma unroll
        for (int r = 0; r < QM; ++r) {
          if (r < Q) {
            float x = -INFINITY;
            if (ok && pos <= off + r) {
              x = dot[r] * scale;
              if (bp) x += bv[r];
            }
            sb[r * BK + c] = x;
          }
        }
        score_group_bar();

        // the online-softmax step of tile t, one warp per row
        for (int r = warp; r < Q; r += SG / 32) {
          float* row = sb + r * BK;
          float mx = -INFINITY;
          for (int c2 = lane; c2 < BK; c2 += 32) mx = fmaxf(mx, row[c2]);
#pragma unroll
          for (int w = 16; w > 0; w /= 2) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
          const float m_prev = m_s[r];
          const float m_next = fmaxf(m_prev, mx);
          const float safe_m = (m_next == -INFINITY) ? 0.f : m_next;
          float sum = 0.f;
          for (int c2 = lane; c2 < BK; c2 += 32) {
            const float p = expf(row[c2] - safe_m);
            sum += p;
            row[c2] = round_p<KV>(p);
          }
#pragma unroll
          for (int w = 16; w > 0; w /= 2) sum += __shfl_xor_sync(0xffffffffu, sum, w);
          if (lane == 0) {
            const float alpha = expf(m_prev - safe_m);
            m_s[r] = m_next;
            l_s[r] = alpha * l_s[r] + sum;
            a_s[(t & 1) * MAXQ + r] = alpha;
          }
        }
      }
    } else if (live_prev) {
      // p V of tile t - 1: per output element the rescale by alpha, then
      // one fmaf chain over the tile's slots
      const int pt = tid - SG;
      const uint8_t* ps = smem + ((t - 1) % STAGES) * L::STAGE;
      const uint8_t* vt = ps + L::V;
      const float* vsc = reinterpret_cast<const float*>(ps + L::VSC);
      const float* pb = Ss + ((t - 1) & 1) * MAXQ * BK;
      const float* ab = a_s + ((t - 1) & 1) * MAXQ;
      // branch-free over the outputs: one past the block repeats the last
      // element, and is never stored
      int row[NO], col[NO];
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        const int e = min(pt + (NT - SG) * n, Q * D - 1);
        row[n] = e / D;
        col[n] = e % D;
        acc[n] = acc[n] * ab[row[n]];
      }
#pragma unroll 4
      for (int kk = 0; kk < BK; ++kk) {
        float vs = 0.f;
        if constexpr (INT8 != 0) vs = vsc[kk];
#pragma unroll
        for (int n = 0; n < NO; ++n) {
          float vf = to_f(*reinterpret_cast<const KV*>(vt + L::elem(kk, col[n])));
          if constexpr (INT8 != 0) vf *= vs;
          acc[n] = fmaf(pb[row[n] * BK + kk], vf, acc[n]);
        }
      }
    }
    __syncthreads();  // V(t - 1)'s stage is free
    if (t + STAGES - 1 < nk) issue(t + STAGES - 1, true);
    cp_async_commit();
    live_prev = live;
  }
  cp_async_wait<0>();

  if (tid >= SG) {
    T* op = static_cast<T*>(o_) + (size_t)bh * Q * D;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      const int e = tid - SG + (NT - SG) * n;
      if (e < Q * D) {
        const float l = l_s[e / D];
        op[e] = from_f<T>(acc[n] / ((l == 0.f) ? 1.f : l));
      }
    }
  }
}

// one call's arguments, as both C entries receive them (a flat cache as
// the pool of B blocks of L slots: block_tables null, H_kv = H, n_tiles =
// 1, bs = L, N = B)
struct DecodeArgs {
  const void *q, *k, *v, *ks, *vs, *bias;
  long long bsb, bsh, bsq, bsk;
  const void *block_tables, *offsets;
  void* o;
  int B, H, H_kv, Q, n_tiles, bs, N;
  float scale;
};

template <int PAGED, int BF16, int INT8, int D, int QM>
int launch(const DecodeArgs& a, cudaStream_t stream) {
  using KV = std::conditional_t<INT8 != 0, int8_t, std::conditional_t<BF16 != 0, __nv_bfloat16,
                                                                      float>>;
  const int smem = Smem<KV, D>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(flash_decode_kernel<PAGED, BF16, INT8, D, QM>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  flash_decode_kernel<PAGED, BF16, INT8, D, QM><<<a.B * a.H, NT, smem, stream>>>(
      a.q, a.k, a.v, (const float*)a.ks, (const float*)a.vs, (const float*)a.bias, a.bsb, a.bsh,
      a.bsq, a.bsk, (const int*)a.block_tables, (const int*)a.offsets, a.o, a.H, a.H_kv, a.Q,
      a.n_tiles, a.bs, a.N, a.scale);
  return (int)cudaGetLastError();
}

template <int PAGED, int BF16, int INT8, int QM>
int dispatch_d(int D, const DecodeArgs& a, cudaStream_t s) {
  switch (D) {
    case 16: return launch<PAGED, BF16, INT8, 16, QM>(a, s);
    case 32: return launch<PAGED, BF16, INT8, 32, QM>(a, s);
    case 64: return launch<PAGED, BF16, INT8, 64, QM>(a, s);
    case 128: return launch<PAGED, BF16, INT8, 128, QM>(a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <int PAGED, int BF16, int INT8>
int dispatch_q(int D, const DecodeArgs& a, cudaStream_t s) {
  return a.Q == 1 ? dispatch_d<PAGED, BF16, INT8, 1>(D, a, s)
                  : dispatch_d<PAGED, BF16, INT8, MAXQ>(D, a, s);
}

// both entries' checks, then the instance for (dtype, int8, d, Q)
template <int PAGED>
int flash_decode_launch(const DecodeArgs& a, int D, int is_bf16, int is_int8, cudaStream_t s) {
  if (a.Q < 1 || a.Q > MAXQ || a.H_kv < 1 || a.H % a.H_kv != 0 || a.bs < 1 || a.n_tiles < 1 ||
      a.N < 1 || (long long)a.n_tiles * a.bs > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if (((uintptr_t)a.k & 15) || ((uintptr_t)a.v & 15)) return (int)cudaErrorMisalignedAddress;
  if (is_int8 && (a.ks == nullptr || a.vs == nullptr)) return (int)cudaErrorInvalidValue;
  if (is_bf16)
    return is_int8 ? dispatch_q<PAGED, 1, 1>(D, a, s) : dispatch_q<PAGED, 1, 0>(D, a, s);
  return is_int8 ? dispatch_q<PAGED, 0, 1>(D, a, s) : dispatch_q<PAGED, 0, 0>(D, a, s);
}

}  // namespace
