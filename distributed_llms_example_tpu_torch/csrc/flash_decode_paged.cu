// Paged flash decode (kernel 6), plain C interface for ctypes.
//
// Replaces the TPU Pallas kernel distributed_llms_example_tpu/ops/
// flash_attention.py `_decode_paged_kernel` (reached through
// `flash_decode_paged`): one decode step of Q <= 8 rows whose K/V live in a
// shared block pool that each batch row maps through its block table.  The
// kernel is the paged instance (PAGED = 1) of csrc/flash_decode.cuh, which
// kernel 5 shares, so the two give the same bits over the same blocks.  The
// header's note says what bounds it on the H100 and what the design does
// about that.
//
// q: (B, H, Q, D) fp32/bf16; k_pool, v_pool: (N, H_kv, bs, D) of q's dtype,
// or int8 with k_scale / v_scale pools (N, H_kv, bs) fp32; q head h reads
// pool head h / (H / H_kv).  block_tables: (B, n_tiles) int32; an entry >=
// N is an unallocated tile: its block is never read and its slots
// contribute nothing.  `bias` (fp32, may be null) is read through element
// strides in logical slot order (0 for a size-1 dim).  Any bs; a logical
// length n_tiles * bs below 2^31; pools 16-byte aligned.  Returns the
// launch's CUDA error code.

#include "flash_decode.cuh"

extern "C" int flash_decode_paged(const void* q, const void* k_pool, const void* v_pool,
                                  const void* k_scale, const void* v_scale, const void* bias,
                                  long long bsb, long long bsh, long long bsq, long long bsk,
                                  const void* block_tables, const void* offsets, void* o, int B,
                                  int H, int H_kv, int Q, int n_tiles, int bs, int N, int D,
                                  float scale, int is_bf16, int is_int8, void* stream) {
  const DecodeArgs a{q, k_pool, v_pool, k_scale, v_scale, bias, bsb, bsh, bsq, bsk,
                     block_tables, offsets, o, B, H, H_kv, Q, n_tiles, bs, N, scale};
  return flash_decode_launch<1>(a, D, is_bf16, is_int8, (cudaStream_t)stream);
}
