// Flash-attention backward on Hopper's tensor cores (sm_90a), bf16: two
// kernels, plain C interface for ctypes.
//
// Replaces the TPU Pallas kernels distributed_llms_example_tpu/ops/
// flash_attention.py `_bwd_dq_kernel` (entry `flash_bwd_dq_tc`) and
// `_bwd_dkv_kernel` (entry `flash_bwd_dkv_tc`), both reached through `_bwd`,
// for bf16 inputs.  fp32 inputs stay on the CUDA-core kernels of
// csrc/flash_bwd.cu, whose fp32 products the fp32 gradient checks hold
// exactly or at 5e-6 (TF32 wgmma would keep about three decimal digits).
// The function is the one flash_attention_bwd_plain computes, with its
// rounding points:
//
//   s  = scale * q k^T + bias + lbias   (-inf where causal-masked)
//   p  = exp(s - lse)            (0 on rows whose lse is the MASK_VALUE
//                                 sentinel: rows with no live key)
//   dp = dO v^T,  ds = p * (dp - delta) * scale
//   dq = bf16(ds) k,  dk = bf16(ds)^T q,  dv = bf16(p)^T dO   (fp32 sums)
//
// q, k, v, dO: (B, H, S, D) contiguous bf16, D in {16, 32, 64, 128}; lse
// and delta = rowsum(dO * O) (B, H, Sq) fp32.  `bias` is an fp32 additive
// mask read through its element strides (a size-1 dim has stride 0);
// `lbias` the learned (1, H, Sq, Sk) bias in bf16 or fp32 (template
// parameter LBB, its element bytes).  `causal` is the top-left mask q_pos
// >= k_pos.  Any Lq and Lk.  Two kernels and no atomics: every output
// element is summed by one thread in a fixed order, so the backward is
// bit-reproducible, as the TPU kernels' split of the work is.
//
// What bounds it on the H100: operations.  At the encoder shape (8, 16,
// 1024, 64) the dq kernel needs 6*B*H*S*S*D = 51.5 GFLOP and the dk/dv
// kernel 8*B*H*S*S*D = 68.7 GFLOP over all keys (0.052 / 0.069 ms at 989
// TFLOP/s) against ~84 / ~101 MB of traffic (0.025 / 0.030 ms at 3.35
// TB/s); under a padding mask only the live keys' share is needed.  The
// design, against that bound:
//
// - Every product is a wgmma with fp32 accumulators, built from the
//   primitives of hopper.cuh.  Both kernels use CTAs of two warpgroups
//   (256 threads, 128 rows), each warpgroup owning 64 rows.
// - dq kernel: one CTA per 128 query rows.  Q and dO are copied into shared
//   memory once; K and V stream through a two-stage ring of 64-key tiles
//   by 16-byte cp.async (zero fill past Lk), the next tile's copy in flight
//   while this tile's products run.  S = Q K^T and dP = dO V^T are
//   wgmma m64n64k16 with every operand K-major; p and ds are computed in
//   registers in the accumulator layout; ds is rounded to bf16 and packed
//   straight into the A fragment of dQ += ds K (m64n{D}k16, K read
//   MN-major through the transpose bit, as kernel 1 reads V).  lse and
//   delta of a thread's two rows sit in registers.
// - dk/dv kernel: one CTA per 128 keys.  K and V are copied once; Q, dO,
//   and the tile's lse and delta stream through the ring (BQ = 64 queries
//   a tile, 32 at D = 128).  It computes the transposes, so that p^T and
//   ds^T land in the accumulator layout that is the next product's A
//   fragment: S^T = K Q^T and dP^T = V dO^T (wgmma_ss), then dV += p^T dO
//   and dK += ds^T Q (wgmma_rs, dO and Q read MN-major).  dV's product runs
//   while ds^T is computed (one wgmma group left in flight).  lse and delta
//   are per column here: each thread reads its columns' from the stage.
// - Dead tiles are skipped after S, bit for bit: when every p of a
//   warpgroup's tile is exactly 0 (padding keys under the -1e9 mask,
//   sentinel rows, rows or keys past the end), dP and both products are
//   left out, whose contribution is exactly zero.  The vote is per
//   warpgroup (a named barrier); both warpgroups still meet at every
//   __syncthreads of the shared ring.  Tiles wholly above a warpgroup's
//   causal diagonal skip S too: the dq kernel stops at the diagonal key
//   tile, the dk/dv kernel starts at the diagonal query tile.
// - Biases: a key-only padding bias (B, 1, 1, Sk) is a 64-float tile a key
//   tile in the dq kernel, and two registers a thread (its two keys) in the
//   dk/dv kernel; a bias with a query dimension takes the generic stride
//   path.  The learned bias comes in as a tile through the same
//   asynchronous copies when its rows are 16-byte aligned (else per
//   element): (128 queries x 64 keys) in the dq kernel, (BQ queries x 128
//   keys) in the dk/dv kernel, which reads it transposed; rows are padded
//   by 16 bytes so that the accumulator-layout reads hit distinct banks.
//   Each (bias, learned bias, edge) combination is its own branch-free
//   copy of the score loop, chosen once a tile, as in kernel 1.
// - Registers: no setmaxnreg; __launch_bounds__(256, 1), so up to 255 a
//   thread.  dq at D = 128: S 32 + dP 32 + dQ 64 + ds fragment 16.  dk/dv
//   keeps dK and dV (D / 2 each) beside S^T and dP^T (BQ / 2 each): at
//   D = 128 that is 64 + 64 + 16 + 16 with the 32-query tile (with 64
//   queries it would be 192 before the fragments); at D = 64, 32 each.
//   ptxas (-Xptxas -v, printed by chip_smoke.py's build) reports 0 bytes of
//   spill in all 24 instances and 167-254 registers a thread (dq 167-248,
//   dk/dv 173-254; the most at D = 128 with an fp32 learned bias), so one
//   CTA of 8 warps a SM.
//
// Later work (not here): warp specialisation with TMA producers, keeping
// the next tile's S in flight, and the in-kernel probs-dropout branch of
// the TPU kernels (no model of the port trains with attention-probs
// dropout).

#include <math.h>

#include "hopper.cuh"

namespace {

constexpr int BK = 64;     // keys per tile of the dq kernel
constexpr int ROWS = 128;  // query rows of a dq CTA, keys of a dk/dv CTA
constexpr int NT = 256;    // two warpgroups

// the dk/dv kernel's query tile: 32 at D = 128 keeps dK, dV, S^T and dP^T
// in registers
template <int D> constexpr int bq_of() { return D == 128 ? 32 : 64; }

struct Args {
  const __nv_bfloat16 *q, *k, *v;
  const float* bias;
  long long bsb, bsh, bsq, bsk;
  const void* lbias;
  long long lsb, lsh, lsq, lsk;
  const __nv_bfloat16* dout;
  const float *lse, *delta;
  __nv_bfloat16 *d1, *d2;  // dq, or dk and dv
  int H, Lq, Lk;
  float scale;
  int causal;
  int bias_tile;  // key-only padding bias (B, 1, 1, Sk)
  int lb_tile;    // learned bias through the asynchronous tile copies
};

// dq kernel: Q, dO, then two stages each of K, V, the learned-bias tile
// (rows padded by 8 elements) and the key-bias tile, from a 1024-byte
// aligned base (the slack is in BYTES)
template <int D, int LBB> struct DqSmem {
  static constexpr int KV = BK * D * 2;
  static constexpr int Q = 0;
  static constexpr int DO = ROWS * D * 2;
  static constexpr int K = 2 * ROWS * D * 2;
  static constexpr int V = K + 2 * KV;
  static constexpr int LB_LD = BK + 8;
  static constexpr int LB_STAGE = ROWS * LB_LD * LBB;
  static constexpr int LB = V + 2 * KV;
  static constexpr int BIAS = LB + 2 * LB_STAGE;
  static constexpr int BYTES = BIAS + 2 * BK * 4 + 1024;
};

// dk/dv kernel: K, V, then two stages each of Q, dO, the learned-bias tile
// (BQ rows of 128 keys, padded by 16 bytes), lse and delta
template <int D, int LBB> struct DkvSmem {
  static constexpr int BQ = bq_of<D>();
  static constexpr int KV = ROWS * D * 2;
  static constexpr int QS = BQ * D * 2;
  static constexpr int K = 0;
  static constexpr int V = KV;
  static constexpr int Q = 2 * KV;
  static constexpr int DO = Q + 2 * QS;
  static constexpr int LB_LD = ROWS + (LBB > 0 ? 16 / LBB : 0);  // elements
  static constexpr int LB_STAGE = BQ * LB_LD * LBB;
  static constexpr int LB = DO + 2 * QS;
  static constexpr int LSE = LB + 2 * LB_STAGE;
  static constexpr int DL = LSE + 2 * BQ * 4;
  static constexpr int BYTES = DL + 2 * BQ * 4 + 1024;
};

// a row's exponent offset -lse * log2 e, or -inf on a sentinel row (no
// live key), so that p = exp2(s * log2 e + offset) is exactly 0 there
__device__ __forceinline__ float neg_lse2(float l) {
  return l <= MASK_VALUE / 2 ? -INFINITY : -l * LOG2E;
}

// (rows x D) bf16 tile of a (len x D) matrix, rows from r0, into the
// swizzled layout at `dst`; zero past `len`
template <int D>
__device__ __forceinline__ void copy_rows(uint32_t dst, const __nv_bfloat16* src, int r0,
                                          int rows, int len) {
  using T = Tile<D>;
  constexpr int CH = D / 8;
  for (int i = threadIdx.x; i < rows * CH; i += NT) {
    const int r = i / CH, c = i % CH;
    const bool ok = r0 + r < len;
    cp_async16(dst + T::off(r, c, rows), src + (size_t)(ok ? r0 + r : 0) * D + c * 8,
               ok ? 16 : 0);
  }
}

// a warpgroup's 64 rows of a (ROWS x D) fp32 accumulator, as bf16, staged
// through its own rows of the tile at `stage` and stored 16 bytes a thread
template <int D>
__device__ __forceinline__ void store_rows(uint8_t* stage, const float (&acc)[D / 2], int wg,
                                           int r_lo, int c_lo, __nv_bfloat16* out, int r0,
                                           int len) {
  using T = Tile<D>;
  constexpr int CH = D / 8;
#pragma unroll
  for (int j = 0; j < D / 4; ++j) {
    const int row = r_lo + 8 * (j & 1), col = 8 * (j >> 1) + c_lo;
    *reinterpret_cast<uint32_t*>(stage + T::off(row, col / 8, ROWS) + (col % 8) * 2) =
        pack_bf16(acc[2 * j], acc[2 * j + 1]);
  }
  warpgroup_bar(1 + wg);
  for (int i = threadIdx.x % 128; i < 64 * CH; i += 128) {
    const int r = wg * 64 + i / CH, c = i % CH;
    if (r0 + r < len)
      *reinterpret_cast<uint4*>(out + (size_t)(r0 + r) * D + c * 8) =
          *reinterpret_cast<const uint4*>(stage + T::off(r, c, ROWS));
  }
}

// ------------------------------------------------------------ dq kernel

template <int D, int LBB>
__global__ void __launch_bounds__(NT, 1) flash_bwd_dq_tc_kernel(const Args a) {
  using T = Tile<D>;
  using L = DqSmem<D, LBB>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  uint8_t* sm = smem_raw + (base - raw);

  const int tid = threadIdx.x;
  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const int q0 = blockIdx.x * ROWS;
  const int Lq = a.Lq, Lk = a.Lk;
  const __nv_bfloat16* kp = a.k + (size_t)bh * Lk * D;
  const __nv_bfloat16* vp = a.v + (size_t)bh * Lk * D;
  const float* bp = a.bias ? a.bias + b * a.bsb + h * a.bsh : nullptr;
  const uint8_t* lp = nullptr;
  if constexpr (LBB > 0) lp = (const uint8_t*)a.lbias + (b * a.lsb + h * a.lsh) * LBB;

  int nk = (Lk + BK - 1) / BK;
  if (a.causal) nk = min(nk, (min(q0 + ROWS, Lq) - 1) / BK + 1);

  // one key tile (K, V and the biases' tiles) into stage s, zero past Lk
  auto load_tile = [&](int kt, int s) {
    const int k0 = kt * BK;
    copy_rows<D>(base + L::K + s * L::KV, kp, k0, BK, Lk);
    copy_rows<D>(base + L::V + s * L::KV, vp, k0, BK, Lk);
    if (a.bias_tile) {
      for (int i = tid; i < BK; i += NT) {
        const bool ok = k0 + i < Lk;
        cp_async4(base + L::BIAS + (s * BK + i) * 4, bp + (ok ? k0 + i : 0), ok ? 4 : 0);
      }
    }
    if constexpr (LBB > 0) {
      if (a.lb_tile) {
        constexpr int EPC = 16 / LBB;  // elements per 16-byte chunk
        constexpr int CPRW = BK / EPC;
        for (int i = tid; i < ROWS * CPRW; i += NT) {
          const int r = i / CPRW, c = i % CPRW;
          const int qi = q0 + r, ki = k0 + c * EPC;
          const bool ok = qi < Lq && ki < Lk;  // the host checked Lk % EPC == 0
          const uint8_t* src = lp + (ok ? (long long)qi * a.lsq + ki : 0) * LBB;
          cp_async16(base + L::LB + s * L::LB_STAGE + (r * L::LB_LD + c * EPC) * LBB, src,
                     ok ? 16 : 0);
        }
      }
    }
  };

  copy_rows<D>(base + L::Q, a.q + (size_t)bh * Lq * D, q0, ROWS, Lq);
  copy_rows<D>(base + L::DO, a.dout + (size_t)bh * Lq * D, q0, ROWS, Lq);
  load_tile(0, 0);
  cp_async_commit();
  if (nk > 1) load_tile(1, 1);
  cp_async_commit();

  // accumulator layout: register r holds row r_lo + 8 * ((r >> 1) & 1) and
  // column 8 * (r >> 2) + c_lo + (r & 1) of the warpgroup's 64-row tile
  const int r_lo = wg * 64 + warp * 16 + lane / 4;  // CTA-local row
  const int c_lo = 2 * (lane % 4);
  const int wg_first = q0 + wg * 64;  // the warpgroup's first query row
  float nl[2], dl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qi = q0 + r_lo + 8 * i;
    const size_t at = (size_t)bh * Lq + qi;
    nl[i] = qi < Lq ? neg_lse2(a.lse[at]) : -INFINITY;  // rows past Lq: p = 0
    dl[i] = qi < Lq ? a.delta[at] : 0.f;
  }
  float dq_acc[D / 2];
#pragma unroll
  for (int r = 0; r < D / 2; ++r) dq_acc[r] = 0.f;

  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt & 1, k0 = kt * BK;
    cp_async_wait<1>();  // this tile's group has landed (the next may still fly)
    fence_proxy_async();
    __syncthreads();
    // a tile wholly above the warpgroup's diagonal has no live key for it
    if (!a.causal || k0 <= wg_first + 63) {
      // S = Q K^T over D / 16 k-steps
      float sc[32];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t panel = kk * 32 / T::W, col = kk * 32 % T::W;
        const uint64_t da = make_desc(base + L::Q + panel * ROWS * T::W + wg * 64 * T::W + col,
                                      16, T::SBO, T::LAYOUT);
        const uint64_t db = make_desc(base + L::K + s * L::KV + panel * BK * T::W + col, 16,
                                      T::SBO, T::LAYOUT);
        wgmma_ss(sc, da, db, kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();

      // p = exp2(s log2 e - lse log2 e) in place of the scores; each
      // (bias, learned bias, edge) combination is its own branch-free loop
      const bool edge = k0 + BK > Lk || (a.causal && k0 + BK - 1 > wg_first);
      const float* bs = reinterpret_cast<const float*>(sm + L::BIAS) + s * BK;
      const uint8_t* lbs = sm + L::LB + s * L::LB_STAGE;
      float pmax = 0.f;
      auto probs = [&](auto bias_mode, auto lb_mode, auto edge_mask) {
        constexpr int BM = decltype(bias_mode)::value;  // 0 none, 1 key tile, 2 strided
        constexpr int LM = decltype(lb_mode)::value;    // 0 none, 1 tile, 2 strided
        constexpr bool EDGE = decltype(edge_mask)::value;
  #pragma unroll
        for (int cg = 0; cg < 8; ++cg) {
          const int col = 8 * cg + c_lo, ki = k0 + col;
          float2 kb = {0.f, 0.f};
          if constexpr (BM == 1) kb = *reinterpret_cast<const float2*>(bs + col);
  #pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int row = r_lo + 8 * i, qi = q0 + row, r = 4 * cg + 2 * i;
            float x0 = fmaf(sc[r], a.scale, kb.x), x1 = fmaf(sc[r + 1], a.scale, kb.y);
            if constexpr (BM == 2) {
              const float* br = bp + (long long)qi * a.bsq + (long long)ki * a.bsk;
              if (qi < Lq && ki < Lk) x0 += br[0];
              if (qi < Lq && ki + 1 < Lk) x1 += br[a.bsk];
            }
            if constexpr (LM == 1) {
              const float2 lb = load2<LBB>(lbs + (row * L::LB_LD + col) * LBB);
              x0 += lb.x;
              x1 += lb.y;
            } else if constexpr (LM == 2) {
              const uint8_t* lr = lp + ((long long)qi * a.lsq + (long long)ki * a.lsk) * LBB;
              if (qi < Lq && ki < Lk) x0 += load1<LBB>(lr);
              if (qi < Lq && ki + 1 < Lk) x1 += load1<LBB>(lr + a.lsk * LBB);
            }
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
      auto by_edge = [&](auto bm, auto lm) {
        if (edge) probs(bm, lm, std::true_type{});
        else probs(bm, lm, std::false_type{});
      };
      auto by_bias = [&](auto lm) {
        if (a.bias_tile) by_edge(Mode<1>{}, lm);
        else if (bp) by_edge(Mode<2>{}, lm);
        else by_edge(Mode<0>{}, lm);
      };
      if constexpr (LBB == 0) by_bias(Mode<0>{});
      else if (a.lb_tile) by_bias(Mode<1>{});
      else by_bias(Mode<2>{});

      // every p of the warpgroup's tile exactly 0: dP and dQ's product add
      // exactly nothing
      if (!warpgroup_all(1 + wg, pmax == 0.f)) {
        float dp[32];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const uint32_t panel = kk * 32 / T::W, col = kk * 32 % T::W;
          const uint64_t da = make_desc(
              base + L::DO + panel * ROWS * T::W + wg * 64 * T::W + col, 16, T::SBO, T::LAYOUT);
          const uint64_t db = make_desc(base + L::V + s * L::KV + panel * BK * T::W + col, 16,
                                        T::SBO, T::LAYOUT);
          wgmma_ss(dp, da, db, kk > 0);
        }
        wgmma_commit();
        wgmma_wait<0>();

        // ds = p (dp - delta) scale, rounded to bf16 into the A fragment of
        // dQ += ds K (k-step j / 4, register j % 4)
        uint32_t da_frag[BK / 16][4];
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int i = j & 1;
          const float ds0 = sc[2 * j] * (dp[2 * j] - dl[i]) * a.scale;
          const float ds1 = sc[2 * j + 1] * (dp[2 * j + 1] - dl[i]) * a.scale;
          da_frag[j / 4][j % 4] = pack_bf16(ds0, ds1);
        }
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          const uint64_t db = make_desc(base + L::K + s * L::KV + kk * 16 * T::W, BK * T::W,
                                        T::SBO, T::LAYOUT);
          wgmma_rs(dq_acc, da_frag[kk], db, 1);
        }
        wgmma_commit();
        wgmma_wait<0>();
      }
    }
    __syncthreads();  // every warpgroup is done with stage s
    if (kt + 2 < nk) load_tile(kt + 2, s);
    cp_async_commit();
  }
  cp_async_wait<0>();
  store_rows<D>(sm + L::Q, dq_acc, wg, r_lo, c_lo, a.d1 + (size_t)bh * Lq * D, q0, Lq);
}

// --------------------------------------------------------- dk/dv kernel

template <int D, int LBB>
__global__ void __launch_bounds__(NT, 1) flash_bwd_dkv_tc_kernel(const Args a) {
  using T = Tile<D>;
  using L = DkvSmem<D, LBB>;
  constexpr int BQ = L::BQ;
  constexpr int NA = BQ / 2;  // accumulator registers of an m64nBQ tile
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  uint8_t* sm = smem_raw + (base - raw);

  const int tid = threadIdx.x;
  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const int k0 = blockIdx.x * ROWS;
  const int Lq = a.Lq, Lk = a.Lk;
  const __nv_bfloat16* qp = a.q + (size_t)bh * Lq * D;
  const __nv_bfloat16* dop = a.dout + (size_t)bh * Lq * D;
  const float* lsep = a.lse + (size_t)bh * Lq;
  const float* dlp = a.delta + (size_t)bh * Lq;
  const float* bp = a.bias ? a.bias + b * a.bsb + h * a.bsh : nullptr;
  const uint8_t* lp = nullptr;
  if constexpr (LBB > 0) lp = (const uint8_t*)a.lbias + (b * a.lsb + h * a.lsh) * LBB;

  const int nq = (Lq + BQ - 1) / BQ;
  const int qt0 = a.causal ? k0 / BQ : 0;  // earlier query tiles see no key of this CTA
  const int n = nq - qt0;

  // one query tile (Q, dO, lse, delta and the learned-bias tile) into stage
  // s, zero past Lq
  auto load_tile = [&](int qt, int s) {
    const int q0 = qt * BQ;
    copy_rows<D>(base + L::Q + s * L::QS, qp, q0, BQ, Lq);
    copy_rows<D>(base + L::DO + s * L::QS, dop, q0, BQ, Lq);
    for (int i = tid; i < BQ; i += NT) {
      const bool ok = q0 + i < Lq;
      cp_async4(base + L::LSE + (s * BQ + i) * 4, lsep + (ok ? q0 + i : 0), ok ? 4 : 0);
      cp_async4(base + L::DL + (s * BQ + i) * 4, dlp + (ok ? q0 + i : 0), ok ? 4 : 0);
    }
    if constexpr (LBB > 0) {
      if (a.lb_tile) {
        constexpr int EPC = 16 / LBB;  // elements per 16-byte chunk
        constexpr int CPRW = ROWS / EPC;
        for (int i = tid; i < BQ * CPRW; i += NT) {
          const int r = i / CPRW, c = i % CPRW;
          const int qi = q0 + r, ki = k0 + c * EPC;
          const bool ok = qi < Lq && ki < Lk;  // the host checked Lk % EPC == 0
          const uint8_t* src = lp + (ok ? (long long)qi * a.lsq + ki : 0) * LBB;
          cp_async16(base + L::LB + s * L::LB_STAGE + (r * L::LB_LD + c * EPC) * LBB, src,
                     ok ? 16 : 0);
        }
      }
    }
  };

  copy_rows<D>(base + L::K, a.k + (size_t)bh * Lk * D, k0, ROWS, Lk);
  copy_rows<D>(base + L::V, a.v + (size_t)bh * Lk * D, k0, ROWS, Lk);
  load_tile(qt0, 0);
  cp_async_commit();
  if (n > 1) load_tile(qt0 + 1, 1);
  cp_async_commit();

  // accumulator layout of S^T: register r holds key row kr_lo + 8 * ((r >>
  // 1) & 1) and query column 8 * (r >> 2) + c_lo + (r & 1)
  const int kr_lo = wg * 64 + warp * 16 + lane / 4;  // CTA-local key row
  const int c_lo = 2 * (lane % 4);
  const int wg_k0 = k0 + wg * 64;  // the warpgroup's first key
  float kb[2] = {0.f, 0.f};        // key-only padding bias of the thread's two keys
  if (a.bias_tile) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int ki = k0 + kr_lo + 8 * i;
      if (ki < Lk) kb[i] = bp[ki];
    }
  }
  float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
  for (int r = 0; r < D / 2; ++r) dk_acc[r] = dv_acc[r] = 0.f;

  for (int it = 0; it < n; ++it) {
    const int s = it & 1, q0 = (qt0 + it) * BQ;
    cp_async_wait<1>();  // this tile's group has landed (the next may still fly)
    fence_proxy_async();
    __syncthreads();
    // a tile whose every query precedes the warpgroup's first key is masked
    if (!a.causal || q0 + BQ - 1 >= wg_k0) {
      // S^T = K Q^T over D / 16 k-steps
      float st[NA];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t panel = kk * 32 / T::W, col = kk * 32 % T::W;
        const uint64_t da = make_desc(base + L::K + panel * ROWS * T::W + wg * 64 * T::W + col,
                                      16, T::SBO, T::LAYOUT);
        const uint64_t db = make_desc(base + L::Q + s * L::QS + panel * BQ * T::W + col, 16,
                                      T::SBO, T::LAYOUT);
        wgmma_ss(st, da, db, kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();

      // p^T in place of the scores, lse per column from the stage
      const bool edge = q0 + BQ > Lq || wg_k0 + 64 > Lk || (a.causal && q0 < wg_k0 + 63);
      const float* ls = reinterpret_cast<const float*>(sm + L::LSE) + s * BQ;
      const uint8_t* lbs = sm + L::LB + s * L::LB_STAGE;
      float pmax = 0.f;
      auto probs = [&](auto bias_mode, auto lb_mode, auto edge_mask) {
        constexpr int BM = decltype(bias_mode)::value;  // 0 none, 1 key registers, 2 strided
        constexpr int LM = decltype(lb_mode)::value;    // 0 none, 1 tile, 2 strided
        constexpr bool EDGE = decltype(edge_mask)::value;
  #pragma unroll
        for (int cg = 0; cg < BQ / 8; ++cg) {
          const int col = 8 * cg + c_lo, qi = q0 + col;
          const float2 l2 = *reinterpret_cast<const float2*>(ls + col);
          const float nl0 = neg_lse2(l2.x), nl1 = neg_lse2(l2.y);
  #pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int row = kr_lo + 8 * i, ki = k0 + row, r = 4 * cg + 2 * i;
            float x0 = fmaf(st[r], a.scale, kb[i]), x1 = fmaf(st[r + 1], a.scale, kb[i]);
            if constexpr (BM == 2) {
              const float* br = bp + (long long)qi * a.bsq + (long long)ki * a.bsk;
              if (qi < Lq && ki < Lk) x0 += br[0];
              if (qi + 1 < Lq && ki < Lk) x1 += br[a.bsq];
            }
            if constexpr (LM == 1) {  // the (query, key) tile read transposed
              x0 += load1<LBB>(lbs + (col * L::LB_LD + row) * LBB);
              x1 += load1<LBB>(lbs + ((col + 1) * L::LB_LD + row) * LBB);
            } else if constexpr (LM == 2) {
              const uint8_t* lr = lp + ((long long)qi * a.lsq + (long long)ki * a.lsk) * LBB;
              if (qi < Lq && ki < Lk) x0 += load1<LBB>(lr);
              if (qi + 1 < Lq && ki < Lk) x1 += load1<LBB>(lr + a.lsq * LBB);
            }
            if constexpr (EDGE) {
              if (qi >= Lq || ki >= Lk || (a.causal && ki > qi)) x0 = -INFINITY;
              if (qi + 1 >= Lq || ki >= Lk || (a.causal && ki > qi + 1)) x1 = -INFINITY;
            }
            const float p0 = ex2(fmaf(x0, LOG2E, nl0)), p1 = ex2(fmaf(x1, LOG2E, nl1));
            pmax = fmaxf(pmax, fmaxf(p0, p1));
            st[r] = p0;
            st[r + 1] = p1;
          }
        }
      };
      auto by_edge = [&](auto bm, auto lm) {
        if (edge) probs(bm, lm, std::true_type{});
        else probs(bm, lm, std::false_type{});
      };
      auto by_bias = [&](auto lm) {
        if (a.bias_tile) by_edge(Mode<1>{}, lm);
        else if (bp) by_edge(Mode<2>{}, lm);
        else by_edge(Mode<0>{}, lm);
      };
      if constexpr (LBB == 0) by_bias(Mode<0>{});
      else if (a.lb_tile) by_bias(Mode<1>{});
      else by_bias(Mode<2>{});

      // every p of the warpgroup's tile exactly 0: dP^T and both products
      // add exactly nothing
      if (!warpgroup_all(1 + wg, pmax == 0.f)) {
        // p^T rounded to bf16 into the A fragment of dV += p^T dO
        uint32_t pa[BQ / 16][4];
#pragma unroll
        for (int j = 0; j < NA / 2; ++j) pa[j / 4][j % 4] = pack_bf16(st[2 * j], st[2 * j + 1]);
        float dpt[NA];
        wgmma_fence();
        // dP^T = V dO^T
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const uint32_t panel = kk * 32 / T::W, col = kk * 32 % T::W;
          const uint64_t da = make_desc(
              base + L::V + panel * ROWS * T::W + wg * 64 * T::W + col, 16, T::SBO, T::LAYOUT);
          const uint64_t db = make_desc(base + L::DO + s * L::QS + panel * BQ * T::W + col, 16,
                                        T::SBO, T::LAYOUT);
          wgmma_ss(dpt, da, db, kk > 0);
        }
        wgmma_commit();
        // dV += p^T dO (dO MN-major), in flight while ds^T is computed
#pragma unroll
        for (int kk = 0; kk < BQ / 16; ++kk) {
          const uint64_t db = make_desc(base + L::DO + s * L::QS + kk * 16 * T::W, BQ * T::W,
                                        T::SBO, T::LAYOUT);
          wgmma_rs(dv_acc, pa[kk], db, 1);
        }
        wgmma_commit();
        wgmma_wait<1>();  // dP^T has landed

        // ds^T = p^T (dP^T - delta) scale, delta per column, rounded to bf16
        // into the A fragment of dK += ds^T Q
        const float* dls = reinterpret_cast<const float*>(sm + L::DL) + s * BQ;
        uint32_t sa[BQ / 16][4];
#pragma unroll
        for (int cg = 0; cg < BQ / 8; ++cg) {
          const float2 d2 = *reinterpret_cast<const float2*>(dls + 8 * cg + c_lo);
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int r = 4 * cg + 2 * i, j = r / 2;
            const float ds0 = st[r] * (dpt[r] - d2.x) * a.scale;
            const float ds1 = st[r + 1] * (dpt[r + 1] - d2.y) * a.scale;
            sa[j / 4][j % 4] = pack_bf16(ds0, ds1);
          }
        }
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BQ / 16; ++kk) {
          const uint64_t db = make_desc(base + L::Q + s * L::QS + kk * 16 * T::W, BQ * T::W,
                                        T::SBO, T::LAYOUT);
          wgmma_rs(dk_acc, sa[kk], db, 1);
        }
        wgmma_commit();
        wgmma_wait<0>();
      }
    }
    __syncthreads();  // every warpgroup is done with stage s
    if (it + 2 < n) load_tile(qt0 + it + 2, s);
    cp_async_commit();
  }
  cp_async_wait<0>();
  store_rows<D>(sm + L::K, dk_acc, wg, kr_lo, c_lo, a.d1 + (size_t)bh * Lk * D, k0, Lk);
  store_rows<D>(sm + L::V, dv_acc, wg, kr_lo, c_lo, a.d2 + (size_t)bh * Lk * D, k0, Lk);
}

// ------------------------------------------------------------------- host

template <int D, int LBB>
int launch(int which, const Args& a, int B, int smem, cudaStream_t stream) {
  // the caller's plan (ops/flash_attention.py bwd_plan) sized the shared
  // memory; it must be this instance's
  const int want = which ? DkvSmem<D, LBB>::BYTES : DqSmem<D, LBB>::BYTES;
  if (smem != want) return (int)cudaErrorInvalidValue;
  auto kernel = which ? flash_bwd_dkv_tc_kernel<D, LBB> : flash_bwd_dq_tc_kernel<D, LBB>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(((which ? a.Lk : a.Lq) + ROWS - 1) / ROWS, B * a.H);
  kernel<<<grid, NT, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int LBB>
int dispatch_d(int which, int D, const Args& a, int B, int smem, cudaStream_t s) {
  switch (D) {
    case 16: return launch<16, LBB>(which, a, B, smem, s);
    case 32: return launch<32, LBB>(which, a, B, smem, s);
    case 64: return launch<64, LBB>(which, a, B, smem, s);
    case 128: return launch<128, LBB>(which, a, B, smem, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

int run(int which, const void* q, const void* k, const void* v, const void* bias,
        long long bsb, long long bsh, long long bsq, long long bsk, const void* lbias,
        long long lsb, long long lsh, long long lsq, long long lsk, const void* dout,
        const void* lse, const void* delta, void* d1, void* d2, int B, int H, int Lq, int Lk,
        int D, float scale, int causal, int lb_bytes, int smem, void* stream) {
  if (B == 0 || H == 0 || Lq == 0 || Lk == 0) return 0;
  if (!aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(dout) || !aligned16(d1) ||
      (d2 && !aligned16(d2)))
    return (int)cudaErrorMisalignedAddress;
  Args a{(const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
         (const float*)bias, bsb, bsh, bsq, bsk, lbias, lsb, lsh, lsq, lsk,
         (const __nv_bfloat16*)dout, (const float*)lse, (const float*)delta,
         (__nv_bfloat16*)d1, (__nv_bfloat16*)d2, H, Lq, Lk, scale, causal, 0, 0};
  a.bias_tile = bias != nullptr && bsq == 0 && bsk == 1;
  a.lb_tile = lbias != nullptr && lb_bytes > 0 && lsk == 1 && aligned16(lbias) &&
              (lsq * lb_bytes) % 16 == 0 && (lsh * lb_bytes) % 16 == 0 &&
              Lk % (16 / lb_bytes) == 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (lbias == nullptr) return dispatch_d<0>(which, D, a, B, smem, s);
  if (lb_bytes == 2) return dispatch_d<2>(which, D, a, B, smem, s);
  if (lb_bytes == 4) return dispatch_d<4>(which, D, a, B, smem, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// lb_bytes: the learned bias's element size (2 bf16, 4 fp32, 0 none); smem
// from the caller's plan.
extern "C" int flash_bwd_dq_tc(const void* q, const void* k, const void* v, const void* bias,
                               long long bsb, long long bsh, long long bsq, long long bsk,
                               const void* lbias, long long lsb, long long lsh, long long lsq,
                               long long lsk, const void* dout, const void* lse,
                               const void* delta, void* dq, int B, int H, int Lq, int Lk, int D,
                               float scale, int causal, int lb_bytes, int smem, void* stream) {
  return run(0, q, k, v, bias, bsb, bsh, bsq, bsk, lbias, lsb, lsh, lsq, lsk, dout, lse, delta,
             dq, nullptr, B, H, Lq, Lk, D, scale, causal, lb_bytes, smem, stream);
}

extern "C" int flash_bwd_dkv_tc(const void* q, const void* k, const void* v, const void* bias,
                                long long bsb, long long bsh, long long bsq, long long bsk,
                                const void* lbias, long long lsb, long long lsh, long long lsq,
                                long long lsk, const void* dout, const void* lse,
                                const void* delta, void* dk, void* dv, int B, int H, int Lq,
                                int Lk, int D, float scale, int causal, int lb_bytes, int smem,
                                void* stream) {
  return run(1, q, k, v, bias, bsb, bsh, bsq, bsk, lbias, lsb, lsh, lsq, lsk, dout, lse, delta,
             dk, dv, B, H, Lq, Lk, D, scale, causal, lb_bytes, smem, stream);
}
