// Fused residual dropout for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the TPU Pallas kernel distributed_llms_example_tpu/ops/
// fused_dropout.py `_dropout_kernel` (reached through `_run_dropout`):
//
//   out = residual + where(keep, x * inv_keep, 0)        (fp32 math)
//
// over the activation's 2-D view (rows = numel / cols, cols = last dim),
// with keep drawn from the counter-hash stream of the JAX package's
// `hw_rng=False` branch: bits = mix32(row * 0x27D4EB2F + col * 0x165667B1
// + key) in uint32 arithmetic, keep = (bits >> 8) < threshold (the stream
// of csrc/dropout_hash.cuh, shared with kernels 1-4's probs dropout).  `key` is
// mix32 of the (seed, tags) word, computed by the wrapper; it is the same
// for every element, so the mask is a pure function of (seed, row, col)
// and the backward (this kernel on the incoming gradient, no residual)
// redraws the forward's mask exactly.  Any `cols`: the TPU's lane-multiple
// gate does not apply.
//
// The product and the residual add are __fmul_rn / __fadd_rn, which the
// compiler never contracts into a fused multiply-add, so the output equals
// the plain PyTorch version (separate multiply and add) bit for bit.  The
// residual arrives already in x's dtype; out is in x's dtype (bf16 rounds
// to nearest even, as torch's cast does).
//
// What bounds it on the H100: bytes.  At bart-large-cnn's widest call,
// (8, 1024, 4096) bf16, it reads 67 MB and writes 67 MB: 40 us at 3.35
// TB/s.  The hash, the compare, the conversions and the multiply cost
// ~15-17 instructions an element, ~18 us of the SMs' instruction rate at
// that shape, so the next loads must be in flight while a thread hashes.  The design:
//
// - the element range is cut, by the wrapper's plan (`dropout_plan` in
//   ops/fused_dropout.py), into a scalar head up to the first element
//   whose x, residual and out addresses are all 16-byte aligned, `vectors`
//   16-byte accesses (8 bf16 or 4 fp32 elements each), and a scalar tail.
//   Where the three addresses disagree modulo 16, the head is everything.
//   Vectors run across row ends: each element still hashes its own
//   (row, col).  Every element is written exactly once, by one of the
//   three sweeps below; the scalar sweeps are part of the kernel;
// - each thread has 64 bytes of loads in flight before it hashes the
//   first element: 4 vectors of x, or 2 of x and 2 of the residual; 4
//   CTAs of 256 threads share an SM (64 registers a thread at most), so
//   32 warps keep loads in flight;
// - the grid is a few CTAs a SM that stride over the vectors, each CTA
//   the same number of rounds;
// - no division per element: a thread's first (row, col) comes from one
//   division, and each later access's from adding a fixed (rows, cols)
//   stride with one carry; inside a vector that does not cross a row end
//   the column term grows by 0x165667B1 per element;
// - the residual and no-residual cases, and bf16 and fp32, are template
//   instances, not branches per element.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <type_traits>

#include "dropout_hash.cuh"

namespace {

constexpr int NT = 256;      // threads a CTA
constexpr int UNROLL = 4;    // 16-byte vectors of x a thread has in flight (half with a residual)
constexpr int MIN_CTAS = 4;  // CTAs an SM must hold (caps registers at 64)
constexpr uint32_t ROW_MUL = HASH_ROW_MUL, COL_MUL = HASH_COL_MUL;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// An element's (row, col) in the 2-D view, the row mod 2**32 (all the hash
// reads).  `advance` moves it by a fixed number of elements, given as
// (whole rows, remaining cols) with dc < cols: one add and one carry.
struct Pos {
  uint32_t r, c;
};

__device__ __forceinline__ Pos pos_of(unsigned long long e, unsigned long long cols) {
  return {(uint32_t)(e / cols), (uint32_t)(e % cols)};
}

__device__ __forceinline__ Pos advance(Pos p, Pos by, uint32_t cols) {
  p.r += by.r;
  p.c += by.c;
  if (p.c >= cols) {
    p.c -= cols;
    p.r += 1;
  }
  return p;
}

// W consecutive elements of T read or written as one access: 16 bytes, or
// one element for the scalar sweeps.
template <typename T, int W>
struct Vec {
  T v[W];
};

template <typename T, int W>
__device__ __forceinline__ Vec<T, W> load(const T* p) {
  Vec<T, W> out;
  if constexpr (W * sizeof(T) == 16) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    memcpy(&out, &u, 16);
  } else {
    static_assert(W == 1, "an access is 16 bytes or one element");
    out.v[0] = *p;
  }
  return out;
}

template <typename T, int W>
__device__ __forceinline__ void store(T* p, const Vec<T, W>& v) {
  if constexpr (W * sizeof(T) == 16) {
    uint4 u;
    memcpy(&u, &v, 16);
    *reinterpret_cast<uint4*>(p) = u;
  } else {
    *p = v.v[0];
  }
}

// The hash bits of the W elements starting at `p`.  A vector that stays
// inside its row adds COL_MUL per element; one that crosses a row end
// (or several, when cols < W) steps element by element.
template <int W>
__device__ __forceinline__ void hash_bits(uint32_t (&bits)[W], Pos p, uint32_t cols,
                                          uint32_t key) {
  if (p.c + W <= cols) {
    const uint32_t w = p.r * ROW_MUL + key + p.c * COL_MUL;
#pragma unroll
    for (int j = 0; j < W; ++j) bits[j] = mix32(w + (uint32_t)j * COL_MUL);
  } else {
#pragma unroll
    for (int j = 0; j < W; ++j) {
      bits[j] = mix32(p.r * ROW_MUL + key + p.c * COL_MUL);
      if (++p.c == cols) {
        p.c = 0;
        ++p.r;
      }
    }
  }
}

struct Args {
  uint32_t cols, key, threshold;
  float inv_keep;
};

// Elements [lo, lo + count * W) as `count` accesses of W elements, U of
// them in flight a thread: in round k, the u-th access of thread t of CTA
// b is access ((k * gridDim + b) * U + u) * NT + t.  All of a round's
// loads are in flight before its first hash.
template <typename T, bool RES, int W, int U>
__device__ __forceinline__ void sweep(const T* __restrict__ x, const T* __restrict__ res,
                                      T* __restrict__ out, long long lo, long long count,
                                      const Args& a) {
  const unsigned long long first = (unsigned long long)blockIdx.x * U * NT + threadIdx.x;
  if (first >= (unsigned long long)count) return;
  const unsigned long long stride = (unsigned long long)gridDim.x * U * NT;
  Pos p = pos_of((unsigned long long)lo + first * W, a.cols);
  const Pos in_round = pos_of((unsigned long long)NT * W, a.cols);
  const Pos next_round = pos_of(stride * W, a.cols);
  for (unsigned long long i = first; i < (unsigned long long)count; i += stride) {
    Vec<T, W> xv[U], rv[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const unsigned long long e = lo + (i + (unsigned long long)u * NT) * W;
      if (i + (unsigned long long)u * NT < (unsigned long long)count) {
        xv[u] = load<T, W>(x + e);
        if constexpr (RES) rv[u] = load<T, W>(res + e);
      }
    }
    Pos pu = p;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const unsigned long long e = lo + (i + (unsigned long long)u * NT) * W;
      if (i + (unsigned long long)u * NT < (unsigned long long)count) {
        uint32_t bits[W];
        hash_bits<W>(bits, pu, a.cols, a.key);
        Vec<T, W> o;
#pragma unroll
        for (int j = 0; j < W; ++j) {
          float y = ((bits[j] >> 8) < a.threshold) ? __fmul_rn(to_f(xv[u].v[j]), a.inv_keep)
                                                   : 0.f;
          if constexpr (RES) y = __fadd_rn(to_f(rv[u].v[j]), y);
          o.v[j] = from_f<T>(y);
        }
        store<T, W>(out + e, o);
      }
      pu = advance(pu, in_round, a.cols);
    }
    p = advance(p, next_round, a.cols);
  }
}

// The head [0, head) and the tail [head + vectors * W, n) one element an
// access, the vectors between them 16 bytes an access.
template <int BF16, int RES>
__global__ void __launch_bounds__(NT, MIN_CTAS) fused_dropout_kernel(
    const void* __restrict__ xv, const void* __restrict__ resv, void* __restrict__ outv,
    long long n, long long head, long long vectors, Args a) {
  using T = typename std::conditional<BF16 != 0, __nv_bfloat16, float>::type;
  constexpr int W = 16 / sizeof(T);
  const T* x = static_cast<const T*>(xv);
  const T* res = static_cast<const T*>(resv);
  T* out = static_cast<T*>(outv);
  sweep<T, RES != 0, W, RES ? UNROLL / 2 : UNROLL>(x, res, out, head, vectors, a);
  sweep<T, RES != 0, 1, 1>(x, res, out, 0, head, a);
  const long long tail = head + vectors * W;
  sweep<T, RES != 0, 1, 1>(x, res, out, tail, n - tail, a);
}

bool aligned(const void* p, long long head, int size) {
  return p == nullptr || ((uintptr_t)p + (uintptr_t)(head * size)) % 16 == 0;
}

}  // namespace

// `head`, `vectors` and `grid` come from the wrapper's plan; they are
// checked here, since a misaligned vector access would fault on the card.
extern "C" int fused_dropout(const void* x, const void* res, void* out, long long n,
                             long long cols, long long head, long long vectors, int grid,
                             unsigned int key, unsigned int threshold, float inv_keep,
                             int is_bf16, void* stream) {
  if (n == 0) return 0;
  const int size = is_bf16 ? 2 : 4, w = 16 / size;
  if (cols <= 0 || cols >= (1LL << 31) || n % cols || head < 0 || vectors < 0 ||
      head + vectors * w > n || grid <= 0)
    return (int)cudaErrorInvalidValue;
  if (vectors > 0 && !(aligned(x, head, size) && aligned(res, head, size) &&
                       aligned(out, head, size)))
    return (int)cudaErrorMisalignedAddress;
  const Args a{(uint32_t)cols, key, threshold, inv_keep};
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16 && res)
    fused_dropout_kernel<1, 1><<<grid, NT, 0, s>>>(x, res, out, n, head, vectors, a);
  else if (is_bf16)
    fused_dropout_kernel<1, 0><<<grid, NT, 0, s>>>(x, res, out, n, head, vectors, a);
  else if (res)
    fused_dropout_kernel<0, 1><<<grid, NT, 0, s>>>(x, res, out, n, head, vectors, a);
  else
    fused_dropout_kernel<0, 0><<<grid, NT, 0, s>>>(x, res, out, n, head, vectors, a);
  return (int)cudaGetLastError();
}
