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
// + key) in uint32 arithmetic, keep = (bits >> 8) < threshold.  `key` is
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
// TB/s; the hash is ~20 integer ops per element, far below the integer
// rate.  This first version reads and writes one element per thread in a
// grid-stride row/column loop (no 64-bit division per element); 16-byte
// vector loads are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T>
__global__ void __launch_bounds__(NT) fused_dropout_kernel(
    const T* __restrict__ x, const T* __restrict__ res, T* __restrict__ out, long long rows,
    long long cols, uint32_t key, uint32_t threshold, float inv_keep) {
  for (long long r = blockIdx.y; r < rows; r += gridDim.y) {
    const uint32_t row_word = (uint32_t)r * 0x27D4EB2Fu + key;
    const size_t base = (size_t)r * (size_t)cols;
    for (long long c = (long long)blockIdx.x * NT + threadIdx.x; c < cols;
         c += (long long)gridDim.x * NT) {
      const uint32_t bits = mix32(row_word + (uint32_t)c * 0x165667B1u);
      const size_t i = base + (size_t)c;
      float y = ((bits >> 8) < threshold) ? __fmul_rn(to_f(x[i]), inv_keep) : 0.f;
      if (res) y = __fadd_rn(to_f(res[i]), y);
      out[i] = from_f<T>(y);
    }
  }
}

template <typename T>
int launch(const void* x, const void* res, void* out, long long n, long long cols, uint32_t key,
           uint32_t threshold, float inv_keep, cudaStream_t stream) {
  if (n == 0) return 0;
  if (cols <= 0 || n % cols) return (int)cudaErrorInvalidValue;
  const long long rows = n / cols;
  const long long gx = (cols + NT - 1) / NT;
  const long long gy = rows < 65535 ? rows : 65535;
  fused_dropout_kernel<T><<<dim3((unsigned)gx, (unsigned)gy), NT, 0, stream>>>(
      (const T*)x, (const T*)res, (T*)out, rows, cols, key, threshold, inv_keep);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int fused_dropout(const void* x, const void* res, void* out, long long n,
                             long long cols, unsigned int key, unsigned int threshold,
                             float inv_keep, int is_bf16, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    return launch<__nv_bfloat16>(x, res, out, n, cols, key, threshold, inv_keep, s);
  return launch<float>(x, res, out, n, cols, key, threshold, inv_keep, s);
}
