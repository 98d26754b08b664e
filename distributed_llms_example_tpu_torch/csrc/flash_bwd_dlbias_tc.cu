// Learned-bias gradient of flash attention on Hopper's tensor cores
// (sm_90a), bf16, plain C interface for ctypes.
//
// Replaces the TPU Pallas kernel distributed_llms_example_tpu/ops/
// flash_attention.py `_bwd_dlbias_kernel` (reached through `_bwd_dlbias`
// from `_bwd`) for bf16 q/k/v/dO.  fp32 inputs stay on the CUDA-core
// kernel of csrc/flash_bwd_dlbias.cu, whose fp32 products the fp32 T5
// gradient check holds at ~1e-10 (TF32 wgmma would keep about three
// decimal digits).  The function is the one `_dlbias_plain` computes, with
// its rounding points:
//
//   s  = scale * q k^T + bias + lbias   (-inf where causal-masked)
//   p  = exp(s - lse)            (0 on rows whose lse is the MASK_VALUE
//                                 sentinel: rows with no live key)
//   dp = dO v^T
//   dlbias[0, h] = sum_b p * (dp - delta)   (fp32, b = 0 .. B-1 in order,
//                                            rounded once to lbias's dtype)
//
// No scale factor applies to the sum: the scale multiplies only q k^T.
// With attention-probs dropout (template parameter DROP), dp is the
// dropped m * dp / (1 - rate), the mask m redrawn per batch row from the
// counter hash of csrc/dropout_hash.cuh over (seed, b, h, absolute query,
// absolute key); DROP = 0 is the code as it was.
// q, k, v, dO: (B, H, S, D) contiguous bf16, D in {16, 32, 64, 128}; lse
// and delta (B, H, Sq) fp32; `bias` an fp32 additive mask read through its
// element strides (a size-1 dim has stride 0; a key-only padding mask
// (B, 1, 1, Sk) takes a tile path); `lbias` the learned (1, H, Sq, Sk) bias
// in bf16 or fp32 (template parameter LBB, its element bytes), read
// through its strides.  The output is (1, H, Sq, Sk) contiguous in the
// learned bias's dtype.  Any Sq and Sk; `causal` is the top-left mask.
//
// What bounds it on the H100: at the t5-large encoder shape (8, 16, 1024,
// 64) the two products need 4*B*H*S*S*D = 34.4 GFLOP (35 us at 989
// TFLOP/s) and the function must move ~135 MB (q, k, v, dO, lse, delta,
// the padding mask, the learned bias in and its gradient out: 40 us at
// 3.35 TB/s).  The design, against that bound:
//
// - One CTA per (head, 128 queries, 64 keys): two warpgroups of 64 query
//   rows.  The dlbias tile stays in registers in the wgmma accumulator
//   layout through the whole batch loop; the learned bias's tile, the same
//   for every batch row, is read once before the loop into that layout
//   (packed bf16 pairs when it is bf16).
// - The batch loop: for each row b, S = Q K^T and dP = dO V^T are wgmma
//   m64n64k16 with both operands K-major, from the swizzled tiles of
//   hopper.cuh.  Q, dO, K and V of a row arrive by TMA: one thread issues
//   the row's boxes (one per 64-column panel of each of the four tiles)
//   from tensor maps whose 128/64/32-byte swizzle is the Tile<D> layout,
//   and an mbarrier per stage counts their bytes.  lse, delta and the key
//   bias tile come by 4-byte cp.async.  A ring of three rows (two at head
//   dim 128, whose row is 96 KB) keeps the next rows in flight: a row's
//   copies are issued as the loop reaches the row before it lands.  Issuing
//   a row's 48 KB as 16-byte cp.async from all 256 threads instead stalled
//   those threads for a large part of each row; TMA takes it off them.
// - Skipped work leaves the bits unchanged.  A CTA wholly above the causal
//   diagonal skips the loop and stores zeros (every output tile is
//   written); a warpgroup wholly above its diagonal skips S.  A batch row
//   whose p is exactly 0 over a warpgroup's tile (padding keys under the
//   -1e9 mask, sentinel rows, edges) skips dP and the update, by a vote of
//   the warpgroup after S, as in csrc/flash_bwd_tc.cu: the update would
//   have added exact zeros.
// - L2 reuse: the grid's head index is its slowest, so the CTAs of one
//   head run together; one head's Q, dO, K and V over eight batch rows
//   (4 MB at the encoder shape) stay in L2 while its 8 x 16 tiles re-read
//   them.
// - No atomics: each output element is summed by one thread in a fixed
//   order, so a rerun gives the same bits.
// - The tile is written through shared memory, 16 bytes a thread where
//   the row length allows it.
// - Registers: no setmaxnreg; __launch_bounds__(256, 1).  A thread holds
//   32 fp32 of dlbias, 32 of S, 32 of dP and 16 or 32 of the learned bias;
//   ptxas's report is printed by chip_smoke.py's build, which requires 0
//   bytes of spill in every instance, the dropout ones included.
// - Dropout: the plane's key is formed once per batch row (the rows loop
//   inside the CTA) and the thread's two (query, key) terms once, so an
//   entry costs an add, the mix and a compare.
// - Host: the four tensor maps are encoded per launch with
//   cuTensorMapEncodeTiled, looked up at run time through the CUDA runtime
//   (no link to libcuda), and passed in a __grid_constant__ Args.

#include <cuda.h>
#include <math.h>

#include "dropout_hash.cuh"
#include "hopper.cuh"

namespace {

constexpr int ROWS = 128;  // query rows of a CTA: two warpgroups
constexpr int BK = 64;     // keys of a CTA
constexpr int NT = 256;

struct Args {
  CUtensorMap tq, tk, tv, tdo;  // (B*H, S, D) bf16 tensor maps, boxes of (64 or D, rows)
  const __nv_bfloat16 *q, *k, *v;
  const float* bias;
  long long bsb, bsh, bsq, bsk;
  const void* lbias;
  long long lsh, lsq, lsk;
  const __nv_bfloat16* dout;
  const float *lse, *delta;
  void* out;
  int B, H, Lq, Lk;
  float scale;
  int causal;
  int bias_tile;  // key-only padding bias (B, 1, 1, Sk)
  int out_vec;    // output rows 16-byte aligned: 16-byte stores
  ProbsDropout drop;
};

// ST stages (batch rows) each of Q, dO (ROWS rows), K, V (BK rows), lse,
// delta and the key-bias tile, then an mbarrier per stage, from a
// 1024-byte aligned base (the slack is in BYTES); after the loop the same
// bytes stage the output tile, ROWS rows of BK elements padded by 16 bytes
template <int D, int LBB> struct Smem {
  static constexpr int ST = D == 128 ? 2 : 3;  // batch rows in the ring
  static constexpr int QS = ROWS * D * 2;
  static constexpr int KS = BK * D * 2;
  static constexpr int Q = 0;
  static constexpr int DO = Q + ST * QS;
  static constexpr int K = DO + ST * QS;
  static constexpr int V = K + ST * KS;
  static constexpr int LSE = V + ST * KS;
  static constexpr int DL = LSE + ST * ROWS * 4;
  static constexpr int BIAS = DL + ST * ROWS * 4;
  static constexpr int BAR = BIAS + ST * BK * 4;
  static constexpr int RING = BAR + ST * 8;
  static constexpr int OUT_LD = BK * LBB + 16;  // bytes per staged output row
  static constexpr int OUT = ROWS * OUT_LD;
  static constexpr int BYTES = (RING > OUT ? RING : OUT) + 1024;
};

// a row's exponent offset -lse * log2 e, or -inf on a sentinel row (no
// live key), so that p = exp2(s * log2 e + offset) is exactly 0 there
__device__ __forceinline__ float neg_lse2(float l) {
  return l <= MASK_VALUE / 2 ? -INFINITY : -l * LOG2E;
}

// the learned bias's values a thread holds: bf16 pairs as they are, fp32
// pairs as float2
template <int LBB> struct LbPair;
template <> struct LbPair<2> {
  using type = __nv_bfloat162;
  static __device__ __forceinline__ type make(float x, float y) {
    return __floats2bfloat162_rn(x, y);  // exact: both are bf16 values
  }
  static __device__ __forceinline__ float2 get(type p) { return __bfloat1622float2(p); }
};
template <> struct LbPair<4> {
  using type = float2;
  static __device__ __forceinline__ type make(float x, float y) { return make_float2(x, y); }
  static __device__ __forceinline__ float2 get(type p) { return p; }
};

template <int D, int LBB, int DROP>
__global__ void __launch_bounds__(NT, 1) flash_bwd_dlbias_tc_kernel(const __grid_constant__ Args a) {
  using T = Tile<D>;
  using L = Smem<D, LBB>;
  using LP = LbPair<LBB>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  uint8_t* sm = smem_raw + (base - raw);

  const int tid = threadIdx.x;
  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int k0 = blockIdx.x * BK, q0 = blockIdx.y * ROWS, h = blockIdx.z;
  const int B = a.B, H = a.H, Lq = a.Lq, Lk = a.Lk;

  // accumulator layout: register r holds row r_lo + 8 * ((r >> 1) & 1) and
  // column 8 * (r >> 2) + c_lo + (r & 1) of the warpgroup's 64 x 64 tile;
  // register pair j = r / 2 is (row r_lo + 8 * (j & 1), columns 8 * (j >>
  // 1) + c_lo + {0, 1})
  const int r_lo = wg * 64 + warp * 16 + lane / 4;  // CTA-local row
  const int c_lo = 2 * (lane % 4);
  const int wg_first = q0 + wg * 64;  // the warpgroup's first query row
  float acc[32];
#pragma unroll
  for (int r = 0; r < 32; ++r) acc[r] = 0.f;

  // a CTA wholly above the causal diagonal has no live pair: zeros
  if (B > 0 && !(a.causal && k0 > q0 + ROWS - 1)) {
    constexpr int ST = L::ST;
    if (tid == 0) {
      for (int s = 0; s < ST; ++s) mbar_init(base + L::BAR + 8 * s, 1);
      mbar_init_fence();
    }
    __syncthreads();
    // batch row b's tiles into stage s, zero past Lq / Lk (TMA fills the
    // boxes' rows past the tensor with zeros)
    auto load_stage = [&](int b, int s) {
      const size_t bh = (size_t)b * H + h;
      if (tid == 0) {
        const uint32_t bar = base + L::BAR + 8 * s;
        mbar_expect_tx(bar, 2 * L::QS + 2 * L::KS);
        constexpr int PW = D >= 64 ? 64 : D;  // columns of a panel
#pragma unroll
        for (int p = 0; p < D / PW; ++p) {
          tma_load_3d(base + L::Q + s * L::QS + p * ROWS * T::W, &a.tq, p * PW, q0, (int)bh, bar);
          tma_load_3d(base + L::DO + s * L::QS + p * ROWS * T::W, &a.tdo, p * PW, q0, (int)bh,
                      bar);
          tma_load_3d(base + L::K + s * L::KS + p * BK * T::W, &a.tk, p * PW, k0, (int)bh, bar);
          tma_load_3d(base + L::V + s * L::KS + p * BK * T::W, &a.tv, p * PW, k0, (int)bh, bar);
        }
      }
      const int i = tid % ROWS;
      const bool ok = q0 + i < Lq;
      cp_async4(base + (tid < ROWS ? L::LSE : L::DL) + (s * ROWS + i) * 4,
                (tid < ROWS ? a.lse : a.delta) + bh * Lq + (ok ? q0 + i : 0), ok ? 4 : 0);
      if (a.bias_tile && tid < BK) {
        const bool kok = k0 + tid < Lk;
        cp_async4(base + L::BIAS + (s * BK + tid) * 4,
                  a.bias + b * a.bsb + h * a.bsh + (kok ? k0 + tid : 0), kok ? 4 : 0);
      }
    };

#pragma unroll
    for (int b = 0; b < ST - 1; ++b) {
      if (b < B) load_stage(b, b);
      cp_async_commit();
    }

    // the learned bias's tile, the same for every batch row, read while
    // the first rows' copies fly
    typename LP::type lb[16];
    const uint8_t* lp = (const uint8_t*)a.lbias + (long long)h * a.lsh * LBB;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int qi = q0 + r_lo + 8 * (j & 1), ki = k0 + 8 * (j >> 1) + c_lo;
      const uint8_t* lr = lp + ((long long)qi * a.lsq + (long long)ki * a.lsk) * LBB;
      const float x = qi < Lq && ki < Lk ? load1<LBB>(lr) : 0.f;
      const float y = qi < Lq && ki + 1 < Lk ? load1<LBB>(lr + a.lsk * LBB) : 0.f;
      lb[j] = LP::make(x, y);
    }

    // a warpgroup whose every row precedes the CTA's first key sees no key
    const bool wg_live = !a.causal || k0 <= wg_first + 63;
    const bool edge = k0 + BK > Lk || (a.causal && k0 + BK - 1 > wg_first);
    // probs dropout: the hash terms of the thread's two rows at its first
    // column (the plane's key is added per batch row), and T * 256
    uint32_t pos_word[2], thr8 = 0;
    if constexpr (DROP) {
#pragma unroll
      for (int i = 0; i < 2; ++i)
        pos_word[i] = (uint32_t)(q0 + r_lo + 8 * i) * HASH_ROW_MUL +
                      (uint32_t)(k0 + c_lo) * HASH_COL_MUL;
      thr8 = a.drop.threshold << 8;
    }

    for (int b = 0; b < B; ++b) {
      const int s = b % ST;
      cp_async_wait<ST - 2>();  // this row's group has landed (later ones may still fly)
      while (!mbar_try_wait(base + L::BAR + 8 * s, (b / ST) & 1)) {
      }
      __syncthreads();  // and every thread is done with row b - 1
      if (b + ST - 1 < B) load_stage(b + ST - 1, (b + ST - 1) % ST);
      cp_async_commit();
      if (wg_live) {
        // S = Q K^T over D / 16 k-steps
        float sc[32];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const uint32_t panel = kk * 32 / T::W, col = kk * 32 % T::W;
          const uint64_t da = make_desc(
              base + L::Q + s * L::QS + panel * ROWS * T::W + wg * 64 * T::W + col, 16, T::SBO,
              T::LAYOUT);
          const uint64_t db = make_desc(base + L::K + s * L::KS + panel * BK * T::W + col, 16,
                                        T::SBO, T::LAYOUT);
          wgmma_ss(sc, da, db, kk > 0);
        }
        wgmma_commit();

        const float* ls = reinterpret_cast<const float*>(sm + L::LSE) + s * ROWS;
        const float* dls = reinterpret_cast<const float*>(sm + L::DL) + s * ROWS;
        float nl[2], dl[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int row = r_lo + 8 * i;
          nl[i] = q0 + row < Lq ? neg_lse2(ls[row]) : -INFINITY;  // rows past Lq: p = 0
          dl[i] = dls[row];
        }
        const float* bs = reinterpret_cast<const float*>(sm + L::BIAS) + s * BK;
        const float* bp = a.bias ? a.bias + b * a.bsb + h * a.bsh : nullptr;
        wgmma_wait<0>();

        // p = exp2(s log2 e - lse log2 e) in place of the scores; each
        // (bias, edge) combination is its own branch-free loop
        float pmax = 0.f;
        auto probs = [&](auto bias_mode, auto edge_mask) {
          constexpr int BM = decltype(bias_mode)::value;  // 0 none, 1 key tile, 2 strided
          constexpr bool EDGE = decltype(edge_mask)::value;
#pragma unroll
          for (int cg = 0; cg < 8; ++cg) {
            const int col = 8 * cg + c_lo, ki = k0 + col;
            float2 kb = {0.f, 0.f};
            if constexpr (BM == 1) kb = *reinterpret_cast<const float2*>(bs + col);
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              const int qi = q0 + r_lo + 8 * i, r = 4 * cg + 2 * i;
              float x0 = fmaf(sc[r], a.scale, kb.x), x1 = fmaf(sc[r + 1], a.scale, kb.y);
              if constexpr (BM == 2) {
                const float* br = bp + (long long)qi * a.bsq + (long long)ki * a.bsk;
                if (qi < Lq && ki < Lk) x0 += br[0];
                if (qi < Lq && ki + 1 < Lk) x1 += br[a.bsk];
              }
              const float2 l2 = LP::get(lb[2 * cg + i]);
              x0 += l2.x;
              x1 += l2.y;
              if constexpr (EDGE) {
                if (ki >= Lk || (a.causal && ki > qi)) x0 = -INFINITY;
                if (ki + 1 >= Lk || (a.causal && ki + 1 > qi)) x1 = -INFINITY;
              }
              const float p0 = ex2(fmaf(x0, LOG2E, nl[i])), p1 = ex2(fmaf(x1, LOG2E, nl[i]));
              pmax = fmaxf(pmax, fmaxf(p0, p1));
              sc[r] = p0;
              sc[r + 1] = p1;
            }
          }
        };
        auto by_edge = [&](auto bm) {
          if (edge) probs(bm, std::true_type{});
          else probs(bm, std::false_type{});
        };
        if (a.bias_tile) by_edge(Mode<1>{});
        else if (bp) by_edge(Mode<2>{});
        else by_edge(Mode<0>{});

        // every p of the warpgroup's tile exactly 0: dP and the update add
        // exactly nothing
        if (!warpgroup_all(1 + wg, pmax == 0.f)) {
          float dp[32];
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < D / 16; ++kk) {
            const uint32_t panel = kk * 32 / T::W, col = kk * 32 % T::W;
            const uint64_t da = make_desc(
                base + L::DO + s * L::QS + panel * ROWS * T::W + wg * 64 * T::W + col, 16,
                T::SBO, T::LAYOUT);
            const uint64_t db = make_desc(base + L::V + s * L::KS + panel * BK * T::W + col, 16,
                                          T::SBO, T::LAYOUT);
            wgmma_ss(dp, da, db, kk > 0);
          }
          wgmma_commit();
          wgmma_wait<0>();
          if constexpr (DROP) {
            // register r is row r_lo + 8 ((r >> 1) & 1), column 8 (r >> 2) +
            // c_lo + (r & 1): a dropped entry's dp is 0, a kept one's scaled
            const uint32_t key = stream_key(a.drop.seed, b, h);
#pragma unroll
            for (int r = 0; r < 32; ++r) {
              const uint32_t w = pos_word[(r >> 1) & 1] + key +
                                 (uint32_t)(8 * (r >> 2) + (r & 1)) * HASH_COL_MUL;
              dp[r] = keep_word(w, thr8) ? __fmul_rn(dp[r], a.drop.inv_keep) : 0.f;
            }
          }
#pragma unroll
          for (int r = 0; r < 32; ++r) acc[r] += sc[r] * (dp[r] - dl[(r >> 1) & 1]);
        }
      }
    }
    cp_async_wait<0>();
    __syncthreads();  // the ring's bytes are free for the output tile
  }

  // the tile, rounded once to the learned bias's dtype, staged in shared
  // memory and stored 16 bytes a thread where the row allows it
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    uint8_t* dst = sm + (r_lo + 8 * (j & 1)) * L::OUT_LD + (8 * (j >> 1) + c_lo) * LBB;
    if constexpr (LBB == 2) *reinterpret_cast<uint32_t*>(dst) = pack_bf16(acc[2 * j], acc[2 * j + 1]);
    else *reinterpret_cast<float2*>(dst) = make_float2(acc[2 * j], acc[2 * j + 1]);
  }
  __syncthreads();
  constexpr int EPC = 16 / LBB;  // elements per 16-byte chunk
  constexpr int CPR = BK / EPC;
  uint8_t* out = (uint8_t*)a.out + (size_t)h * Lq * Lk * LBB;
  for (int i = tid; i < ROWS * CPR; i += NT) {
    const int r = i / CPR, c = i % CPR, qi = q0 + r, ki = k0 + c * EPC;
    if (qi >= Lq || ki >= Lk) continue;
    uint8_t* dst = out + ((size_t)qi * Lk + ki) * LBB;
    const uint8_t* src = sm + r * L::OUT_LD + c * 16;
    if (a.out_vec && ki + EPC <= Lk) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
      for (int e = 0; e < EPC && ki + e < Lk; ++e) {
        if constexpr (LBB == 2)
          reinterpret_cast<uint16_t*>(dst)[e] = reinterpret_cast<const uint16_t*>(src)[e];
        else reinterpret_cast<float*>(dst)[e] = reinterpret_cast<const float*>(src)[e];
      }
    }
  }
}

// ------------------------------------------------------------------- host

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                     cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = (EncodeTiled)p;
  }
  return fn;
}

// a (BH, S, D) bf16 tensor as boxes of (panel columns, rows), swizzled as
// Tile<D> lays them out
bool make_map(CUtensorMap* m, const void* ptr, int D, int S, int BH, int rows) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const int pw = D >= 64 ? 64 : D;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)BH};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)S * D * 2};
  const cuuint32_t box[3] = {(cuuint32_t)pw, (cuuint32_t)rows, 1};
  const cuuint32_t es[3] = {1, 1, 1};
  const CUtensorMapSwizzle sw = pw == 64   ? CU_TENSOR_MAP_SWIZZLE_128B
                                : pw == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                                           : CU_TENSOR_MAP_SWIZZLE_32B;
  return fn(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims, strides, box, es,
            CU_TENSOR_MAP_INTERLEAVE_NONE, sw, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D, int LBB>
int launch(Args& a, int smem, cudaStream_t stream) {
  const int BH = a.B * a.H;
  if (!make_map(&a.tq, a.q, D, a.Lq, BH, ROWS) || !make_map(&a.tdo, a.dout, D, a.Lq, BH, ROWS) ||
      !make_map(&a.tk, a.k, D, a.Lk, BH, BK) || !make_map(&a.tv, a.v, D, a.Lk, BH, BK))
    return (int)cudaErrorInvalidValue;
  // the caller's plan (ops/flash_attention.py dlbias_plan) sized the shared
  // memory; it must be this instance's
  if (smem != Smem<D, LBB>::BYTES) return (int)cudaErrorInvalidValue;
  auto kernel = a.drop.on() ? flash_bwd_dlbias_tc_kernel<D, LBB, 1>
                            : flash_bwd_dlbias_tc_kernel<D, LBB, 0>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((a.Lk + BK - 1) / BK, (a.Lq + ROWS - 1) / ROWS, a.H);
  kernel<<<grid, NT, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int LBB>
int dispatch_d(int D, Args& a, int smem, cudaStream_t s) {
  switch (D) {
    case 16: return launch<16, LBB>(a, smem, s);
    case 32: return launch<32, LBB>(a, smem, s);
    case 64: return launch<64, LBB>(a, smem, s);
    case 128: return launch<128, LBB>(a, smem, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

}  // namespace

// The signature of csrc/flash_bwd_tc.cu's entries with one output.  `lsb`,
// the learned bias's batch stride, is unused: its batch dim is 1, which is
// what the kernel sums over.  seed, threshold, inv_keep: the forward's
// probs dropout (threshold 2^24: none); lb_bytes: the learned bias's
// element size (2 bf16, 4 fp32); smem from the caller's plan.
extern "C" int flash_bwd_dlbias_tc(const void* q, const void* k, const void* v,
                                   const void* bias, long long bsb, long long bsh, long long bsq,
                                   long long bsk, const void* lbias, long long lsb,
                                   long long lsh, long long lsq, long long lsk,
                                   const void* dout, const void* lse, const void* delta,
                                   void* dlbias, int B, int H, int Lq, int Lk, int D, float scale,
                                   int causal, int seed, unsigned int threshold, float inv_keep,
                                   int lb_bytes, int smem, void* stream) {
  (void)lsb;
  if (lbias == nullptr || threshold > (1u << 24)) return (int)cudaErrorInvalidValue;
  if (H == 0 || Lq == 0 || Lk == 0) return 0;
  if (!aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(dout))
    return (int)cudaErrorMisalignedAddress;
  Args a{{}, {}, {}, {}, (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
         (const float*)bias, bsb, bsh, bsq, bsk, lbias, lsh, lsq, lsk,
         (const __nv_bfloat16*)dout, (const float*)lse, (const float*)delta, dlbias, B, H, Lq, Lk,
         scale, causal, 0, 0, {seed, threshold, inv_keep}};
  a.bias_tile = bias != nullptr && bsq == 0 && bsk == 1;
  a.out_vec = aligned16(dlbias) && ((long long)Lk * lb_bytes) % 16 == 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (lb_bytes == 2) return dispatch_d<2>(D, a, smem, s);
  if (lb_bytes == 4) return dispatch_d<4>(D, a, smem, s);
  return (int)cudaErrorInvalidValue;
}
