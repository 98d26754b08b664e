// Fused clip + AdamW + decoupled weight decay for Hopper (sm_90a), plain C
// interface for ctypes.
//
// Replaces the TPU Pallas kernel distributed_llms_example_tpu/ops/
// fused_optim.py `_adamw_kernel` (reached through `fused_adamw_leaf`).  One
// pass over one fp32 parameter tensor, in place:
//
//   gc  = trigger ? g : (g / gnorm) * max_norm        (only when clipping)
//   mu' = (1-b1)*gc + b1*mu        nu' = (1-b2)*(gc*gc) + b2*nu
//   u   = (mu'/bc1) / (sqrt(nu'/bc2) + eps)
//   u   = u + wd*p                 (decay-mask leaves only: wd != 0)
//   u   = (-lr) * u                p' = p + u
//
// with gnorm, trigger, bc1, bc2 and -lr read from an 8-float scalar vector
// on the device (layout `_S_*` of the JAX package), so a step needs no
// host round trip.  Every operation is an _rn intrinsic, which the compiler
// never contracts into a fused multiply-add, and sqrt/division are IEEE:
// the result equals the plain PyTorch version (one op at a time) bit for
// bit, where the TPU kernel and optax differ by XLA's float contraction.
//
// Beside the update it adds this leaf's health sums into stats[0..2]
// (double): sum of p^2, sum of u^2, and the count of non-finite elements
// of the raw, pre-clip gradient (one NaN must count as one, not as the
// whole leaf its clip would flood).  Per thread in double, a block
// reduction, one double atomicAdd per block and statistic.
//
// What bounds it on the H100: bytes, 28 per element (read p, mu, nu, g;
// write p, mu, nu), about 3.4 ms for bart-large-cnn's 406M parameters at
// 3.35 TB/s.  A grid-stride loop of scalar loads, one element per thread
// per iteration; vector loads are later work.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;
constexpr int S_GNORM = 0, S_TRIGGER = 1, S_BC1 = 2, S_BC2 = 3, S_NEG_LR = 4;

__device__ __forceinline__ double warp_sum(double x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__global__ void __launch_bounds__(NT) fused_adamw_kernel(
    float* __restrict__ p, float* __restrict__ mu, float* __restrict__ nu,
    const float* __restrict__ g, const float* __restrict__ scal, double* __restrict__ stats,
    long long n, float b1, float omb1, float b2, float omb2, float eps, float max_norm, float wd,
    int clip) {
  const float gnorm = scal[S_GNORM], trigger = scal[S_TRIGGER];
  const float bc1 = scal[S_BC1], bc2 = scal[S_BC2], neg_lr = scal[S_NEG_LR];
  double p_ss = 0.0, u_ss = 0.0, nonfinite = 0.0;
  for (long long i = (long long)blockIdx.x * NT + threadIdx.x; i < n;
       i += (long long)gridDim.x * NT) {
    const float g_raw = g[i];
    float gc = g_raw;
    if (clip && trigger == 0.f) gc = __fmul_rn(__fdiv_rn(g_raw, gnorm), max_norm);
    const float pv = p[i];
    const float m = __fadd_rn(__fmul_rn(omb1, gc), __fmul_rn(b1, mu[i]));
    const float v = __fadd_rn(__fmul_rn(omb2, __fmul_rn(gc, gc)), __fmul_rn(b2, nu[i]));
    float u = __fdiv_rn(__fdiv_rn(m, bc1), __fadd_rn(__fsqrt_rn(__fdiv_rn(v, bc2)), eps));
    if (wd != 0.f) u = __fadd_rn(u, __fmul_rn(wd, pv));
    u = __fmul_rn(neg_lr, u);
    p[i] = __fadd_rn(pv, u);
    mu[i] = m;
    nu[i] = v;
    p_ss += (double)__fmul_rn(pv, pv);
    u_ss += (double)__fmul_rn(u, u);
    nonfinite += isfinite(g_raw) ? 0.0 : 1.0;
  }
  __shared__ double part[3][NT / 32];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  p_ss = warp_sum(p_ss);
  u_ss = warp_sum(u_ss);
  nonfinite = warp_sum(nonfinite);
  if (lane == 0) {
    part[0][warp] = p_ss;
    part[1][warp] = u_ss;
    part[2][warp] = nonfinite;
  }
  __syncthreads();
  if (threadIdx.x < 3) {
    double t = 0.0;
    for (int w = 0; w < NT / 32; ++w) t += part[threadIdx.x][w];
    atomicAdd(stats + threadIdx.x, t);
  }
}

}  // namespace

extern "C" int fused_adamw(void* p, void* mu, void* nu, const void* g, const void* scal,
                           void* stats, long long n, float b1, float omb1, float b2, float omb2,
                           float eps, float max_norm, float wd, int clip, void* stream) {
  if (n == 0) return 0;
  long long blocks = (n + NT - 1) / NT;
  if (blocks > 1056) blocks = 1056;  // 8 blocks per SM on 132 SMs, grid-stride beyond
  fused_adamw_kernel<<<(unsigned)blocks, NT, 0, (cudaStream_t)stream>>>(
      (float*)p, (float*)mu, (float*)nu, (const float*)g, (const float*)scal, (double*)stats, n,
      b1, omb1, b2, omb2, eps, max_norm, wd, clip);
  return (int)cudaGetLastError();
}
