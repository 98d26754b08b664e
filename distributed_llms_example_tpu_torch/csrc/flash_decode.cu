// Flash decode against a flat cache (kernel 5), plain C interface for ctypes.
//
// Replaces the TPU Pallas kernel distributed_llms_example_tpu/ops/
// flash_attention.py `_decode_kernel` (reached through `flash_decode` and
// `flash_decode_run`): a short q block of Q <= 8 rows against a full-length
// (B, H, L, D) K/V cache of which only a prefix is live.  The kernel is the
// flat instance (PAGED = 0) of csrc/flash_decode.cuh, which kernel 6 shares:
// the cache is read as a pool of B blocks of L slots, one a batch row, so
// kernel 6 over the gathered view of the same blocks gives the same bits.
// The header's note says what bounds it on the H100 and what the design
// does about that.
//
// q: (B, H, Q, D) fp32/bf16; k, v: (B, H, L, D) of q's dtype, or int8 with
// k_scale / v_scale (B, H, L) fp32.  `bias` (fp32, may be null) is read
// through element strides (0 for a size-1 dim).  Any cache length L; K/V
// 16-byte aligned.  Returns the launch's CUDA error code.

#include "flash_decode.cuh"

extern "C" int flash_decode(const void* q, const void* k, const void* v, const void* k_scale,
                            const void* v_scale, const void* bias, long long bsb, long long bsh,
                            long long bsq, long long bsk, const void* offsets, void* o, int B,
                            int H, int Q, int L, int D, float scale, int is_bf16, int is_int8,
                            void* stream) {
  const DecodeArgs a{q, k, v, k_scale, v_scale, bias, bsb, bsh, bsq, bsk, nullptr, offsets, o,
                     B, H, H, Q, 1, L, B, scale};
  return flash_decode_launch<0>(a, D, is_bf16, is_int8, (cudaStream_t)stream);
}
