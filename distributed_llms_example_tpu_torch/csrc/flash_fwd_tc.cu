// Flash-attention forward on Hopper's tensor cores (sm_90a), bf16 q/k/v,
// plain C interface for ctypes.
//
// Replaces the TPU Pallas kernel distributed_llms_example_tpu/ops/
// flash_attention.py `_fwd_kernel` (reached through `_fwd` and the public
// `flash_attention`) for bf16 inputs; fp32 inputs stay on the CUDA-core
// kernel of csrc/flash_fwd.cu, whose fp32 products are exact to fp32
// rounding (TF32 wgmma would keep about three decimal digits).  The
// function is the one flash_attention_plain computes:
//
//   o   = dropout(softmax(scale * q k^T + bias + lbias)) v   (fp32 online softmax)
//   lse = m + log(l), or MASK_VALUE where a row has no live key
//
// q, k, v: (B, H, S, D) contiguous bf16, D in {16, 32, 64, 128}; o bf16
// like q; lse (B, H, Sq) fp32.  `bias` is an fp32 additive mask read
// through its element strides (a size-1 dim has stride 0); `lbias` is the
// learned (1, H, Sq, Sk) bias in bf16 or fp32 (template parameter LBB, its
// element bytes).  `causal` is the top-left mask q_pos >= k_pos.  Rows
// whose every key is -inf give o = 0 and lse = MASK_VALUE; as on the TPU,
// p is rounded to bf16 before the value product while the row sum l
// accumulates the unrounded fp32 p.  Any Lq and Lk.
//
// Attention-probs dropout (template parameter DROP, the TPU kernel's
// `dropout_rate` branch): an entry of p is kept when the counter hash of
// csrc/dropout_hash.cuh over (seed, b, h, absolute query, absolute key)
// says so, and then scaled by the fp32 1 / (1 - rate).  It drops p after
// l has summed the undropped p, so l normalises the undropped softmax and
// only the value product sees the mask; the kept p is scaled in fp32 and
// rounded to bf16 after that, as the TPU kernel does.  The plane's key is
// formed once a CTA and each thread's two row terms once, so an entry
// costs an add, the mix and a compare (about 10 integer operations, where
// the tensor cores spend about 2 * D flops on it).  The instances without
// dropout (DROP = 0) are the code as it was.
//
// What bounds it on the H100: at the serve shape (8, 16, 1024, 64) the
// work is 4*B*H*S*S*D = 34.4 GFLOP against ~67 MB of q, k, v and o, so the
// bf16 tensor-core rate bounds it (about 35 us at 989 TFLOP/s, against
// about 20 us of HBM time).  The design, against that bound:
//
// - Both products on the tensor cores: S = Q K^T as wgmma m64n64k16 (Q and
//   K from shared memory, both K-major), O += P V as wgmma m64n{D}k16 with
//   P from registers and V from shared memory (MN-major, transpose bit).
// - One CTA owns ROWS = 128 query rows (two warpgroups of 64), or 64 rows
//   when Lq <= 64 (decode cross-attention's Lq = 1).  Q's tile is copied
//   into shared memory once.
// - K and V stream through a ring of two shared-memory stages, 64 keys a
//   tile, by 16-byte cp.async with src-size 0 past Lk (zero fill): tile
//   t+1's copy is in flight while tile t's products run.  Every tile is
//   written in the swizzle its wgmma descriptor names: 128-byte rows for
//   D = 64 and 128 (two 64-column panels at D = 128), 64-byte rows for
//   D = 32, 32-byte rows for D = 16 (16-byte chunk index XOR address bits
//   7-9, 7-8 or 7, as the hardware's swizzle modes read it).
// - Scores and online softmax stay in registers, in the accumulator
//   layout: scale, biases and masks are applied there (exp2 with log2 e
//   folded into one FMA), row max and sum reduce over each row's quad of
//   lanes by shuffles.  Each combination of bias source, learned-bias
//   source and edge masking is its own branch-free copy of the score loop,
//   chosen once a tile (a first build that branched per score spent more
//   instructions there than in the rest of the tile).  The causal and
//   key-range masks run only on tiles that need them; tiles wholly above a
//   warpgroup's diagonal are skipped.
// - Tiles that add exactly nothing are skipped after S: when every score of
//   a warpgroup's 64 rows lies more than 104 below its row's running max
//   (padding keys under the -1e9 mask), exp underflows to 0 in fp32 and
//   the max stays, so the exponentials and the value product are left out.
//   The result is bit for bit what computing them gives.
// - p goes straight into the second product: the m64n64 accumulator
//   layout is the A-fragment layout of m64n{D}k16, so eight accumulator
//   values pack into one k-step's four bf16x2 registers, never through
//   shared memory.
// - A key-only padding bias (B, 1, 1, Sk) is copied once per key tile into
//   shared memory with the K/V tile; a bias with a query dimension is read
//   through the generic stride path.  The learned bias comes in as a
//   (ROWS x 64) tile through the same asynchronous copies (rows padded by
//   16 or 32 bytes, so the accumulator-layout reads hit distinct banks)
//   when its rows are 16-byte aligned, else per element.
// - Epilogue: o = acc / l is staged through the warpgroup's own rows of
//   the Q tile and stored 16 bytes a thread; lse is (B, H, Sq) fp32, the
//   layout kernels 2-4 read.
// - Registers: BK = 64 at every head dim, no setmaxnreg.  D <= 64 asks for
//   two 256-thread CTAs a SM (128 registers a thread: 32 for S, D / 2 for
//   O, 16 for p); at D = 128 the O accumulator alone takes 64, so one CTA.
//   Four warpgroups a SM hide each other's latencies: a version that kept
//   the next tile's S in flight during this tile's softmax needed ~160
//   registers, ran one CTA a SM and was slower on the H100.
//
// Later work (not here): warp specialisation with TMA producers and
// ping-pong scheduling of the two warpgroups.

#include <math.h>

#include "dropout_hash.cuh"
#include "hopper.cuh"

namespace {

constexpr int BK = 64;  // keys per tile
// a score this far (natural log units) below its row max has exp() == 0 in fp32
constexpr float DEAD_GAP = 104.f;

// Dynamic shared memory: Q, two K stages, two V stages, two learned-bias
// stages (LBB bytes an element, rows padded by 8 elements), two key-bias
// stages, all from a 1024-byte aligned base (the slack is in BYTES).
template <int D, int ROWS, int LBB> struct Smem {
  static constexpr int KV = BK * D * 2;  // one K or V stage
  static constexpr int Q = 0;
  static constexpr int K = ROWS * D * 2;
  static constexpr int V = K + 2 * KV;
  static constexpr int LB_LD = BK + 8;
  static constexpr int LB_STAGE = ROWS * LB_LD * LBB;
  static constexpr int LB = V + 2 * KV;
  static constexpr int BIAS = LB + 2 * LB_STAGE;
  static constexpr int BYTES = BIAS + 2 * BK * 4 + 1024;
};

struct Args {
  const __nv_bfloat16 *q, *k, *v;
  const float* bias;
  long long bsb, bsh, bsq, bsk;
  const void* lbias;
  long long lsb, lsh, lsq, lsk;
  __nv_bfloat16* o;
  float* lse;
  int H, Lq, Lk;
  float scale;
  int causal;
  int bias_tile;  // key-only padding bias: one BK-float copy per key tile
  int lb_tile;    // learned bias through the asynchronous tile copies
  ProbsDropout drop;
};

// ------------------------------------------------------------------ kernel

template <int D, int ROWS, int LBB, int DROP>
__global__ void __launch_bounds__(2 * ROWS, (D <= 64 ? 2 : 1) * 128 / ROWS)
    flash_fwd_tc_kernel(const Args a) {
  using T = Tile<D>;
  using L = Smem<D, ROWS, LBB>;
  constexpr int NT = 2 * ROWS;  // ROWS / 64 warpgroups
  constexpr int CH = D / 8;     // 16-byte chunks per row
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  uint8_t* sm = smem_raw + (base - raw);

  const int tid = threadIdx.x;
  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const int q0 = blockIdx.x * ROWS;
  const int Lq = a.Lq, Lk = a.Lk;
  const __nv_bfloat16* qp = a.q + (size_t)bh * Lq * D;
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
    for (int i = tid; i < BK * CH; i += NT) {
      const int r = i / CH, c = i % CH;
      const bool ok = k0 + r < Lk;
      const size_t src = (size_t)(ok ? k0 + r : 0) * D + c * 8;
      const uint32_t dst = s * L::KV + T::off(r, c, BK);
      cp_async16(base + L::K + dst, kp + src, ok ? 16 : 0);
      cp_async16(base + L::V + dst, vp + src, ok ? 16 : 0);
    }
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

  for (int i = tid; i < ROWS * CH; i += NT) {
    const int r = i / CH, c = i % CH;
    const bool ok = q0 + r < Lq;
    cp_async16(base + L::Q + T::off(r, c, ROWS), qp + (size_t)(ok ? q0 + r : 0) * D + c * 8,
               ok ? 16 : 0);
  }
  load_tile(0, 0);
  cp_async_commit();
  if (nk > 1) load_tile(1, 1);
  cp_async_commit();

  // accumulator layout: register r holds row r_lo + 8 * ((r >> 1) & 1) and
  // column 8 * (r >> 2) + c_lo + (r & 1) of the warpgroup's 64-row tile
  const int r_lo = wg * 64 + warp * 16 + lane / 4;  // CTA-local row
  const int c_lo = 2 * (lane % 4);
  const int wg_first = q0 + wg * 64;  // the warpgroup's first query row
  float o_acc[D / 2];
#pragma unroll
  for (int r = 0; r < D / 2; ++r) o_acc[r] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
  // probs dropout: the hash word of each of the thread's two rows (row term
  // plus the (b, h) plane's key) and T * 256
  uint32_t row_word[2], thr8 = 0;
  if constexpr (DROP) {
    const uint32_t key = stream_key(a.drop.seed, b, h);
#pragma unroll
    for (int i = 0; i < 2; ++i) row_word[i] = (uint32_t)(q0 + r_lo + 8 * i) * HASH_ROW_MUL + key;
    thr8 = a.drop.threshold << 8;
  }

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
        const uint64_t dq = make_desc(base + L::Q + panel * ROWS * T::W + wg * 64 * T::W + col,
                                      16, T::SBO, T::LAYOUT);
        const uint64_t dk = make_desc(base + L::K + s * L::KV + panel * BK * T::W + col, 16,
                                      T::SBO, T::LAYOUT);
        wgmma_ss(sc, dq, dk, kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();

      // scale, biases and masks in base 2; both row halves share a column.
      // Each combination of bias source, learned-bias source and edge
      // masking is its own branch-free copy of the loop, chosen once a tile.
      const bool edge = k0 + BK > Lk || (a.causal && k0 + BK - 1 > wg_first);
      const float* bs = reinterpret_cast<const float*>(sm + L::BIAS) + s * BK;
      const uint8_t* lbs = sm + L::LB + s * L::LB_STAGE;
      auto scores = [&](auto bias_mode, auto lb_mode, auto edge_mask) {
        constexpr int BM = decltype(bias_mode)::value;  // 0 none, 1 key tile, 2 strided
        constexpr int LM = decltype(lb_mode)::value;    // 0 none, 1 tile, 2 strided
        constexpr bool EDGE = decltype(edge_mask)::value;
  #pragma unroll
        for (int cg = 0; cg < 8; ++cg) {
          const int col = 8 * cg + c_lo, ki = k0 + col;
          float2 kb = {0.f, 0.f};
          if constexpr (BM == 1) {
            kb = *reinterpret_cast<const float2*>(bs + col);
          }
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
            sc[r] = x0;
            sc[r + 1] = x1;
          }
        }
      };
      auto by_edge = [&](auto bm, auto lm) {
        if (edge) scores(bm, lm, std::true_type{});
        else scores(bm, lm, std::false_type{});
      };
      auto by_bias = [&](auto lm) {
        if (a.bias_tile) by_edge(Mode<1>{}, lm);
        else if (bp) by_edge(Mode<2>{}, lm);
        else by_edge(Mode<0>{}, lm);
      };
      if constexpr (LBB == 0) by_bias(Mode<0>{});
      else if (a.lb_tile) by_bias(Mode<1>{});
      else by_bias(Mode<2>{});

      // online softmax: row max over the quad of lanes that share a row
      // (four running maxima and sums, so each dependency chain is short)
      float m4[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY};
#pragma unroll
      for (int r = 0; r < 32; ++r) m4[(r >> 1) & 3] = fmaxf(m4[(r >> 1) & 3], sc[r]);
      float mx[2] = {fmaxf(m4[0], m4[2]), fmaxf(m4[1], m4[3])};
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      }
      // A tile whose every score lies more than 104 below its row's running
      // max (padding keys, -1e9 below) adds exactly nothing: exp underflows
      // to 0 in fp32 and the max stays.  When that holds for all 64 rows of
      // the warpgroup, the exponentials and the value product are skipped.
      const bool dead = mx[0] < m_run[0] - DEAD_GAP && mx[1] < m_run[1] - DEAD_GAP;
      if (!warpgroup_all(1 + wg, dead)) {
        float neg_m[2], alpha[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float m_new = fmaxf(m_run[i], mx[i]);
          // a row can still be all -inf: a finite stand-in keeps exp2 at 0
          const float safe = m_new == -INFINITY ? 0.f : m_new;
          alpha[i] = ex2((m_run[i] - safe) * LOG2E);
          neg_m[i] = -safe * LOG2E;
          m_run[i] = m_new;
        }
        // p: unrounded into this thread's part of l, rounded to bf16 into
        // the A fragment of the value product (k-step j / 4, register j % 4);
        // with dropout, the kept entries scaled and the rest zeroed between
        // the two (register j is row r_lo + 8 (j & 1), columns 8 (j >> 1) +
        // c_lo + {0, 1})
        uint32_t pa[BK / 16][4];
        float ps[4] = {0.f, 0.f, 0.f, 0.f};
        const uint32_t col_word = (uint32_t)(k0 + c_lo) * HASH_COL_MUL;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int i = j & 1;
          float p0 = ex2(fmaf(sc[2 * j], LOG2E, neg_m[i]));
          float p1 = ex2(fmaf(sc[2 * j + 1], LOG2E, neg_m[i]));
          ps[j & 3] += p0 + p1;
          if constexpr (DROP) {
            const uint32_t w = row_word[i] + col_word + (uint32_t)(8 * (j >> 1)) * HASH_COL_MUL;
            p0 = keep_word(w, thr8) ? __fmul_rn(p0, a.drop.inv_keep) : 0.f;
            p1 = keep_word(w + HASH_COL_MUL, thr8) ? __fmul_rn(p1, a.drop.inv_keep) : 0.f;
          }
          pa[j / 4][j % 4] = pack_bf16(p0, p1);
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) l_run[i] = l_run[i] * alpha[i] + (ps[i] + ps[i + 2]);
#pragma unroll
        for (int r = 0; r < D / 2; ++r) o_acc[r] *= alpha[(r >> 1) & 1];

        // O += P V over BK / 16 k-steps
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          const uint64_t dv = make_desc(base + L::V + s * L::KV + kk * 16 * T::W, BK * T::W,
                                        T::SBO, T::LAYOUT);
          wgmma_rs(o_acc, pa[kk], dv, 1);
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

  // epilogue: l over the quad; o = acc / l staged through the warpgroup's
  // own rows of the Q tile, then 16-byte stores; lse from the quad's lane 0
  float l_tot[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l_tot[i] = l_run[i] + __shfl_xor_sync(0xffffffffu, l_run[i], 1);
    l_tot[i] += __shfl_xor_sync(0xffffffffu, l_tot[i], 2);
  }
#pragma unroll
  for (int j = 0; j < D / 4; ++j) {
    const int i = j & 1;
    const float ls = l_tot[i] == 0.f ? 1.f : l_tot[i];  // fully-masked rows give zeros
    const int row = r_lo + 8 * i, col = 8 * (j >> 1) + c_lo;
    *reinterpret_cast<uint32_t*>(sm + L::Q + T::off(row, col / 8, ROWS) + (col % 8) * 2) =
        pack_bf16(o_acc[2 * j] / ls, o_acc[2 * j + 1] / ls);
  }
  warpgroup_bar(1 + wg);
  for (int i = tid % 128; i < 64 * CH; i += 128) {
    const int r = wg * 64 + i / CH, c = i % CH;
    if (q0 + r < Lq)
      *reinterpret_cast<uint4*>(a.o + ((size_t)bh * Lq + q0 + r) * D + c * 8) =
          *reinterpret_cast<const uint4*>(sm + L::Q + T::off(r, c, ROWS));
  }
  if (lane % 4 == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int qi = q0 + r_lo + 8 * i;
      if (qi < Lq)
        a.lse[(size_t)bh * Lq + qi] =
            l_tot[i] == 0.f ? MASK_VALUE : m_run[i] + logf(l_tot[i]);
    }
  }
}

// ------------------------------------------------------------------- host

template <int D, int ROWS, int LBB>
int launch(const Args& a, int B, int smem, cudaStream_t stream) {
  // the caller's plan (ops/flash_attention.py fwd_plan) sized the shared
  // memory; it must be this instance's
  if (smem != Smem<D, ROWS, LBB>::BYTES) return (int)cudaErrorInvalidValue;
  auto kernel = a.drop.on() ? flash_fwd_tc_kernel<D, ROWS, LBB, 1>
                            : flash_fwd_tc_kernel<D, ROWS, LBB, 0>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((a.Lq + ROWS - 1) / ROWS, B * a.H);
  kernel<<<grid, 2 * ROWS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int ROWS, int LBB>
int dispatch_d(int D, const Args& a, int B, int smem, cudaStream_t s) {
  switch (D) {
    case 16: return launch<16, ROWS, LBB>(a, B, smem, s);
    case 32: return launch<32, ROWS, LBB>(a, B, smem, s);
    case 64: return launch<64, ROWS, LBB>(a, B, smem, s);
    case 128: return launch<128, ROWS, LBB>(a, B, smem, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <int LBB>
int dispatch_rows(int rows, int D, const Args& a, int B, int smem, cudaStream_t s) {
  if (rows == 64) return dispatch_d<64, LBB>(D, a, B, smem, s);
  if (rows == 128) return dispatch_d<128, LBB>(D, a, B, smem, s);
  return (int)cudaErrorInvalidValue;
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

}  // namespace

// seed, threshold, inv_keep: the probs dropout (csrc/dropout_hash.cuh;
// threshold 2^24 is rate 0, no dropout); lb_bytes: the learned bias's
// element size (2 bf16, 4 fp32, 0 none); rows and smem from the caller's
// plan.
extern "C" int flash_fwd_tc(const void* q, const void* k, const void* v, const void* bias,
                            long long bsb, long long bsh, long long bsq, long long bsk,
                            const void* lbias, long long lsb, long long lsh, long long lsq,
                            long long lsk, void* o, void* lse, int B, int H, int Lq, int Lk,
                            int D, float scale, int causal, int seed, unsigned int threshold,
                            float inv_keep, int lb_bytes, int rows, int smem, void* stream) {
  if (!aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(o))
    return (int)cudaErrorMisalignedAddress;
  if (threshold > (1u << 24)) return (int)cudaErrorInvalidValue;
  Args a{(const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
         (const float*)bias, bsb, bsh, bsq, bsk, lbias, lsb, lsh, lsq, lsk,
         (__nv_bfloat16*)o, (float*)lse, H, Lq, Lk, scale, causal, 0, 0,
         {seed, threshold, inv_keep}};
  a.bias_tile = bias != nullptr && bsq == 0 && bsk == 1;
  a.lb_tile = lbias != nullptr && lb_bytes > 0 && lsk == 1 && aligned16(lbias) &&
              (lsq * lb_bytes) % 16 == 0 && (lsh * lb_bytes) % 16 == 0 &&
              Lk % (16 / lb_bytes) == 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (lbias == nullptr) return dispatch_rows<0>(rows, D, a, B, smem, s);
  if (lb_bytes == 2) return dispatch_rows<2>(rows, D, a, B, smem, s);
  if (lb_bytes == 4) return dispatch_rows<4>(rows, D, a, B, smem, s);
  return (int)cudaErrorInvalidValue;
}
