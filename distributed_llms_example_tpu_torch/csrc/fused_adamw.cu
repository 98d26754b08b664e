// Fused clip + AdamW + decoupled weight decay for Hopper (sm_90a) over a
// table of parameter tensors, and the gradient pass that feeds it; plain C
// interface for ctypes.
//
// `fused_adamw` replaces the TPU Pallas kernel distributed_llms_example_tpu/
// ops/fused_optim.py `_adamw_kernel` (reached through `fused_adamw_leaf`).
// One pass over every fp32 leaf of the table, in place:
//
//   gc  = trigger ? g : (g / gnorm) * max_norm        (only when clipping)
//   mu' = (1-b1)*gc + b1*mu        nu' = (1-b2)*(gc*gc) + b2*nu
//   u   = (mu'/bc1) / (sqrt(nu'/bc2) + eps)
//   u   = u + wd*p                 (decay leaves only)
//   u   = (-lr) * u                p' = p + u
//
// with gnorm, trigger, bc1, bc2 and -lr read from an 8-float scalar vector
// on the device (layout `_S_*` of the JAX package), so a step needs no
// host round trip.  Every operation is an _rn intrinsic, which the compiler
// never contracts into a fused multiply-add, and sqrt/division are IEEE:
// the result equals the plain PyTorch version (one op at a time) bit for
// bit, where the TPU kernel and optax differ by XLA's float contraction.
// Beside the update it adds each leaf's health sums into its row of the
// (N, 4) float64 stats table: sum of p^2, sum of u^2, and the count of
// non-finite elements of the raw, pre-clip gradient (one NaN counts as
// one, not as the whole leaf its clip would flood), by one double
// atomicAdd per CTA, leaf and statistic.
//
// `fused_grad_prep` is the step's pass before it, over the same table: the
// token division g <- g / tokens in place (IEEE, as torch's `div_` by a
// device tensor) and the global norm of the result, sqrt of the float64
// sum of squares rounded once to fp32, for the scalar vector.  Each CTA's
// partial sum goes to a workspace, and the last CTA to finish (one
// counter) adds them in a fixed order: no floating-point atomics, so a
// rerun gives the same bits.  A table of more leaves than one launch
// holds runs as several launches, which carry the running total in the
// workspace in stream order.
//
// Over a process group each rank holds shards of the leaves (FSDP), and
// the global norm is the root of every rank's float64 sum of squares.  So
// `fused_grad_prep` has a partial mode: given a `total` pointer, its last
// launch writes the float64 sum there instead of the root; the caller
// all-reduces it (float64 SUM) and `fused_grad_norm_finish`, one thread,
// rounds the root with the same `sqrt_to_float`.  Over one rank the
// partial pass and the finish give the one-pass norm bit for bit.
//
// The table (`Table`, < 32 KB) is the kernel's parameter block, copied at
// launch: each leaf's p, mu, nu and g pointers, element count, flags
// (decay; 16-byte aligned), and its first work item.  A work item is
// `chunk` elements of one leaf; CTAs stride over the items, find an item's
// leaf by binary search over the first items, so a 512-element bias and a
// 51 M-element embedding share a launch, and the grid is what the built
// kernel's occupancy fits on the card, each CTA the same number of items.
//
// What bounds them on the H100: bytes.  AdamW moves 28 per element (read
// p, mu, nu, g; write p, mu, nu), 6.2 ms for t5-large's 737.7 M
// parameters at 3.35 TB/s; the prep 8 (read and write g), 1.8 ms.  Leaves
// whose pointers are 16-byte aligned move float4s; an odd tail, or a leaf
// that is not aligned, runs one element an access in the same loop nest.
// AdamW's ~60 instructions an element (four IEEE divisions, one IEEE
// square root) are about a quarter of the byte time, hidden behind the
// loads of the other resident CTAs.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#if !defined(CUDART_VERSION) || CUDART_VERSION < 12010
#error "the leaf table is a kernel parameter block above 4 KB: CUDA 12.1 or later"
#endif

namespace {

constexpr int NT = 256;
constexpr int MAX_LEAVES = 640;  // leaves one launch's table holds
constexpr int MAX_GRID = 4096;   // CTAs of a prep launch (its workspace's partial sums)
constexpr int S_GNORM = 0, S_TRIGGER = 1, S_BC1 = 2, S_BC2 = 3, S_NEG_LR = 4;
constexpr int STATS = 4;
constexpr int FLAG_DECAY = 1, FLAG_VEC = 2;
// prep workspace, float64 slots: [0] the finished-CTA counter (uint32),
// [1] the running total across launches, [2, 2 + MAX_GRID) partial sums
constexpr int WS_COUNTER = 0, WS_TOTAL = 1, WS_PARTIALS = 2;

struct Table {
  float* p[MAX_LEAVES];
  float* mu[MAX_LEAVES];
  float* nu[MAX_LEAVES];
  float* g[MAX_LEAVES];
  long long n[MAX_LEAVES];
  int first[MAX_LEAVES + 1];  // leaf i's first work item; first[nleaves] = items
  unsigned char flags[MAX_LEAVES];
  int nleaves, chunk;
};
static_assert(sizeof(Table) + 128 < 32764, "a kernel parameter block holds 32764 bytes");

struct Hyper {
  float b1, omb1, b2, omb2, eps, max_norm, wd;
};

// The leaf of work item `item`: the last i with first[i] <= item (a leaf of
// no elements has no items and is never found).
__device__ __forceinline__ int find_leaf(const Table& t, int item) {
  int lo = 0, hi = t.nleaves;
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (t.first[mid] <= item) lo = mid;
    else hi = mid;
  }
  return lo;
}

__device__ __forceinline__ double warp_sum(double x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// The CTA's sum of each thread's K values, in a fixed order; the result is
// valid in thread 0.
template <int K>
__device__ __forceinline__ void block_sum(double (&v)[K]) {
  __shared__ double part[K][NT / 32];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll
  for (int k = 0; k < K; ++k) v[k] = warp_sum(v[k]);
  if (lane == 0)
#pragma unroll
    for (int k = 0; k < K; ++k) part[k][warp] = v[k];
  __syncthreads();
  if (threadIdx.x == 0)
#pragma unroll
    for (int k = 0; k < K; ++k) {
      double s = 0.0;
      for (int w = 0; w < NT / 32; ++w) s += part[k][w];
      v[k] = s;
    }
  __syncthreads();
}

struct Step {
  float gnorm, trigger, bc1, bc2, neg_lr;
};

// One element's update, the present kernel's operations in their order.
template <int CLIP>
__device__ __forceinline__ void adamw1(float& p, float& m, float& v, float g_raw, float wd,
                                       const Step& s, const Hyper& h, double (&acc)[3]) {
  float gc = g_raw;
  if (CLIP && s.trigger == 0.f) gc = __fmul_rn(__fdiv_rn(g_raw, s.gnorm), h.max_norm);
  const float pv = p;
  m = __fadd_rn(__fmul_rn(h.omb1, gc), __fmul_rn(h.b1, m));
  v = __fadd_rn(__fmul_rn(h.omb2, __fmul_rn(gc, gc)), __fmul_rn(h.b2, v));
  float u = __fdiv_rn(__fdiv_rn(m, s.bc1), __fadd_rn(__fsqrt_rn(__fdiv_rn(v, s.bc2)), h.eps));
  if (wd != 0.f) u = __fadd_rn(u, __fmul_rn(wd, pv));
  u = __fmul_rn(s.neg_lr, u);
  p = __fadd_rn(pv, u);
  acc[0] += (double)__fmul_rn(pv, pv);
  acc[1] += (double)__fmul_rn(u, u);
  acc[2] += isfinite(g_raw) ? 0.0 : 1.0;
}

template <int CLIP>
__global__ void __launch_bounds__(NT) fused_adamw_kernel(const __grid_constant__ Table t,
                                                         const float* __restrict__ scal,
                                                         double* __restrict__ stats,
                                                         const Hyper h) {
  const Step s{scal[S_GNORM], scal[S_TRIGGER], scal[S_BC1], scal[S_BC2], scal[S_NEG_LR]};
  const int items = t.first[t.nleaves];
  double acc[3] = {0.0, 0.0, 0.0};
  int cur = -1;  // the leaf whose sums `acc` holds; flushed when the leaf changes
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const int leaf = find_leaf(t, item);
    if (leaf != cur) {
      if (cur >= 0) {
        block_sum<3>(acc);
        if (threadIdx.x == 0)
          for (int k = 0; k < 3; ++k) atomicAdd(stats + cur * STATS + k, acc[k]);
        acc[0] = acc[1] = acc[2] = 0.0;
      }
      cur = leaf;
    }
    const long long start = (long long)(item - t.first[leaf]) * t.chunk;
    const long long end = min(t.n[leaf], start + t.chunk);
    float* __restrict__ p = t.p[leaf];
    float* __restrict__ mu = t.mu[leaf];
    float* __restrict__ nu = t.nu[leaf];
    const float* __restrict__ g = t.g[leaf];
    const float wd = (t.flags[leaf] & FLAG_DECAY) ? h.wd : 0.f;
    long long i = start;
    if (t.flags[leaf] & FLAG_VEC) {
      const long long vend = start + ((end - start) & ~3LL);
      for (long long k = start + 4 * threadIdx.x; k < vend; k += 4 * NT) {
        float4 pv = *reinterpret_cast<const float4*>(p + k);
        float4 mv = *reinterpret_cast<const float4*>(mu + k);
        float4 vv = *reinterpret_cast<const float4*>(nu + k);
        const float4 gv = *reinterpret_cast<const float4*>(g + k);
        adamw1<CLIP>(pv.x, mv.x, vv.x, gv.x, wd, s, h, acc);
        adamw1<CLIP>(pv.y, mv.y, vv.y, gv.y, wd, s, h, acc);
        adamw1<CLIP>(pv.z, mv.z, vv.z, gv.z, wd, s, h, acc);
        adamw1<CLIP>(pv.w, mv.w, vv.w, gv.w, wd, s, h, acc);
        *reinterpret_cast<float4*>(p + k) = pv;
        *reinterpret_cast<float4*>(mu + k) = mv;
        *reinterpret_cast<float4*>(nu + k) = vv;
      }
      i = vend;
    }
    for (long long k = i + threadIdx.x; k < end; k += NT)
      adamw1<CLIP>(p[k], mu[k], nu[k], g[k], wd, s, h, acc);
  }
  if (cur >= 0) {
    block_sum<3>(acc);
    if (threadIdx.x == 0)
      for (int k = 0; k < 3; ++k) atomicAdd(stats + cur * STATS + k, acc[k]);
  }
}

__device__ __forceinline__ void prep1(float& g, float tok, double& ss) {
  g = __fdiv_rn(g, tok);
  ss += (double)g * (double)g;
}

// sqrt(t) for a float64 sum of squares t, rounded once to fp32.  The
// library's double sqrt has a slow path that is a call (a stack frame in
// every kernel that has one), so: t = tn * 4^k with tn in [1, 4), a float
// seed for 1/sqrt(tn) refined by two Newton steps in double (to ~1e-16),
// then sqrt(tn) * 2^k rounded to fp32.  A denormal t gives 0 (its root is
// below fp32's range); 0, inf and NaN give themselves.
__device__ __forceinline__ float sqrt_to_float(double t) {
  const long long bits = __double_as_longlong(t);
  const int e = (int)((bits >> 52) & 0x7ff);
  if (!(t > 0.0) || e == 0x7ff) return (float)t;
  if (e == 0) return 0.f;
  const int k = (e - 1023) >> 1;  // floor, so tn = t / 4^k lies in [1, 4)
  const double tn = t * __longlong_as_double((long long)(1023 - 2 * k) << 52);
  double y = (double)rsqrtf((float)tn);
  y = y * (1.5 - 0.5 * tn * y * y);
  y = y * (1.5 - 0.5 * tn * y * y);
  return (float)(tn * y * __longlong_as_double((long long)(1023 + k) << 52));
}

// At least 2 CTAs a SM: under that bound ptxas keeps the accumulator in
// registers around the IEEE division's slow-path call; without it the
// kernel takes an 8-byte stack frame.
__global__ void __launch_bounds__(NT, 2) fused_grad_prep_kernel(const __grid_constant__ Table t,
                                                             const float* __restrict__ tokens,
                                                             double* __restrict__ ws,
                                                             float* __restrict__ gnorm,
                                                             double* __restrict__ total_out,
                                                             int first_launch, int last_launch) {
  const float tok = *tokens;
  const int items = t.first[t.nleaves];
  double ss[1] = {0.0};
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const int leaf = find_leaf(t, item);
    const long long start = (long long)(item - t.first[leaf]) * t.chunk;
    const long long end = min(t.n[leaf], start + t.chunk);
    float* __restrict__ g = t.g[leaf];
    long long i = start;
    if (t.flags[leaf] & FLAG_VEC) {
      const long long vend = start + ((end - start) & ~3LL);
      for (long long k = start + 4 * threadIdx.x; k < vend; k += 4 * NT) {
        float4 gv = *reinterpret_cast<const float4*>(g + k);
        prep1(gv.x, tok, ss[0]);
        prep1(gv.y, tok, ss[0]);
        prep1(gv.z, tok, ss[0]);
        prep1(gv.w, tok, ss[0]);
        *reinterpret_cast<float4*>(g + k) = gv;
      }
      i = vend;
    }
    for (long long k = i + threadIdx.x; k < end; k += NT) prep1(g[k], tok, ss[0]);
  }
  block_sum<1>(ss);
  __shared__ bool last;
  if (threadIdx.x == 0) {
    ws[WS_PARTIALS + blockIdx.x] = ss[0];
    __threadfence();
    last = atomicAdd(reinterpret_cast<unsigned int*>(ws + WS_COUNTER), 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  // the last CTA: every partial is written; add them in CTA order
  __threadfence();
  ss[0] = 0.0;
  for (int b = threadIdx.x; b < (int)gridDim.x; b += NT) ss[0] += __ldcg(ws + WS_PARTIALS + b);
  block_sum<1>(ss);
  if (threadIdx.x == 0) {
    const double total = (first_launch ? 0.0 : ws[WS_TOTAL]) + ss[0];
    if (!last_launch) ws[WS_TOTAL] = total;
    else if (total_out != nullptr) *total_out = total;  // partial: the caller reduces it
    else *gnorm = sqrt_to_float(total);
    *reinterpret_cast<unsigned int*>(ws + WS_COUNTER) = 0u;  // ready for the next launch
  }
}

// The root of an all-reduced float64 sum of squares, as the prep's last
// launch rounds its own.
__global__ void grad_norm_finish_kernel(const double* __restrict__ total,
                                        float* __restrict__ gnorm) {
  *gnorm = sqrt_to_float(*total);
}

// The host's copy of one launch's table from the wrapper's arrays: ptrs
// (nleaves x 4: p, mu, nu, g), numel, flags, first (nleaves + 1).
int fill_table(Table& t, const void* ptrs, const void* numel, const void* flags,
               const void* first, int nleaves, int chunk) {
  if (nleaves < 1 || nleaves > MAX_LEAVES || chunk < 4 || chunk % 4) return 1;
  const unsigned long long* ptr = static_cast<const unsigned long long*>(ptrs);
  const long long* n = static_cast<const long long*>(numel);
  const unsigned char* f = static_cast<const unsigned char*>(flags);
  const int* fi = static_cast<const int*>(first);
  if (fi[0] != 0) return 1;
  for (int i = 0; i < nleaves; ++i) {
    t.p[i] = reinterpret_cast<float*>(ptr[4 * i + 0]);
    t.mu[i] = reinterpret_cast<float*>(ptr[4 * i + 1]);
    t.nu[i] = reinterpret_cast<float*>(ptr[4 * i + 2]);
    t.g[i] = reinterpret_cast<float*>(ptr[4 * i + 3]);
    t.n[i] = n[i];
    t.flags[i] = f[i];
    t.first[i] = fi[i];
    if (n[i] < 0 || fi[i + 1] - fi[i] != (int)((n[i] + chunk - 1) / chunk)) return 1;
    if ((f[i] & FLAG_VEC) && (ptr[4 * i] % 16 || ptr[4 * i + 1] % 16 || ptr[4 * i + 2] % 16 ||
                              ptr[4 * i + 3] % 16))
      return 1;
  }
  t.first[nleaves] = fi[nleaves];
  t.nleaves = nleaves;
  t.chunk = chunk;
  return 0;
}

// CTAs for `items` work items: what the kernel's occupancy fits on the
// card (at most `cap`), each CTA the same number of items, at least one.
template <typename K>
int grid_for(K kernel, int items, int cap) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, NT, 0);
  long long most = (long long)sms * (per_sm > 0 ? per_sm : 1);
  if (most > cap) most = cap;
  if (items < 1) return 1;
  const long long rounds = (items + most - 1) / most;
  return (int)((items + rounds - 1) / rounds);
}

}  // namespace

extern "C" int fused_adamw(const void* ptrs, const void* numel, const void* flags,
                           const void* first, int nleaves, int chunk, const void* scal,
                           void* stats, float b1, float omb1, float b2, float omb2, float eps,
                           float max_norm, float wd, int clip, void* stream) {
  Table t;  // host staging, copied into the launch's parameters
  if (fill_table(t, ptrs, numel, flags, first, nleaves, chunk)) return (int)cudaErrorInvalidValue;
  const Hyper h{b1, omb1, b2, omb2, eps, max_norm, wd};
  cudaStream_t s = (cudaStream_t)stream;
  const int items = t.first[nleaves];
  if (clip) {
    fused_adamw_kernel<1><<<grid_for(fused_adamw_kernel<1>, items, 1 << 30), NT, 0, s>>>(
        t, (const float*)scal, (double*)stats, h);
  } else {
    fused_adamw_kernel<0><<<grid_for(fused_adamw_kernel<0>, items, 1 << 30), NT, 0, s>>>(
        t, (const float*)scal, (double*)stats, h);
  }
  return (int)cudaGetLastError();
}

extern "C" int fused_grad_prep(const void* ptrs, const void* numel, const void* flags,
                               const void* first, int nleaves, int chunk, const void* tokens,
                               void* workspace, void* gnorm, void* total, int first_launch,
                               int last_launch, void* stream) {
  Table t;
  if (fill_table(t, ptrs, numel, flags, first, nleaves, chunk)) return (int)cudaErrorInvalidValue;
  const int grid = grid_for(fused_grad_prep_kernel, t.first[nleaves], MAX_GRID);
  fused_grad_prep_kernel<<<grid, NT, 0, (cudaStream_t)stream>>>(
      t, (const float*)tokens, (double*)workspace, (float*)gnorm, (double*)total, first_launch,
      last_launch);
  return (int)cudaGetLastError();
}

// `total`: a float64 sum of squares on the device (the partial mode's,
// all-reduced); `gnorm`: its root, rounded once to fp32.
extern "C" int fused_grad_norm_finish(const void* total, void* gnorm, void* stream) {
  grad_norm_finish_kernel<<<1, 1, 0, (cudaStream_t)stream>>>((const double*)total,
                                                             (float*)gnorm);
  return (int)cudaGetLastError();
}
