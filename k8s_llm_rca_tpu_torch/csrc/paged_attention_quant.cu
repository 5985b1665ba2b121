// Paged decode attention over a quantized KV pool for Hopper (sm_90a),
// plain C interface for ctypes.
//
// Replaces: k8s_llm_rca_tpu/ops/paged_attention.py::paged_attention_quant
// (Pallas kernel _paged_kernel_quant).  The pool holds int8 pages, or
// split-half int4 pages, with one f32 scale per token and pool (k, v):
//
//   q              [B, n_heads, d]                   float32 / bfloat16
//   k/v pages      [n_pages, page_size, n_kv*d]      int8             (int8)
//                  [n_pages, page_size, n_kv*d / 2]  int8 packed      (int4)
//   k/v scales     [n_pages, page_size] float32
//   lengths        [B] int32, block_tables [B, pages_per_seq] int32
//   out            [B, n_heads, d] in q's type
//
// What bounds it on the H100: bytes, as for the bf16 pool, with a quarter
// (int4) or half (int8) of the page bytes plus 8 bytes of scales a token.
// The body is csrc/paged_attention.cuh; this file instantiates it with the
// int8 and int4 load policies: 16-byte cp.async chunks of a head's row
// (int4: the row's bytes on the head's side of the half, whose low or high
// nibbles the head's lanes are), converted 8 lanes at a time by shifts,
// and each valid token's two scales loaded by bounds.  An int4 byte carries
// two kv-heads, and each head's block reads it: the int4 pool is read
// twice, mostly from L2.

#include "paged_attention.cuh"

namespace {

// The launch, or with `splits` set only the split count it would take.
int run(const void* q, const void* k_pages, const void* v_pages, const void* k_scale,
        const void* v_scale, const int* lengths, const int* block_tables, void* out,
        int batch, int n_heads, int n_kv, int head_dim, int page_size, int pages_per_seq,
        int n_split, int packed, int dtype, cudaStream_t s, int* splits) {
  if (!paged::shapes_ok(batch, n_heads, n_kv, page_size, pages_per_seq, n_split))
    return (int)cudaErrorInvalidValue;
  const int kv_dim = n_kv * head_dim;
  const paged::Args a{q, (const uint8_t*)k_pages, (const uint8_t*)v_pages,
                      (const float*)k_scale, (const float*)v_scale, lengths, block_tables, out,
                      (unsigned)(packed ? kv_dim / 2 : kv_dim), n_heads, n_kv, page_size,
                      pages_per_seq, n_split, 0, kv_dim / 2, paged::log2_exact(page_size)};
  if (dtype == 0 && !packed)
    return paged::launch_shape<float, paged::QuantPages<false>>(a, batch, head_dim, s, splits);
  if (dtype == 0 && packed)
    return paged::launch_shape<float, paged::QuantPages<true>>(a, batch, head_dim, s, splits);
  if (dtype == 1 && !packed)
    return paged::launch_shape<__nv_bfloat16, paged::QuantPages<false>>(a, batch, head_dim, s,
                                                                        splits);
  if (dtype == 1 && packed)
    return paged::launch_shape<__nv_bfloat16, paged::QuantPages<true>>(a, batch, head_dim, s,
                                                                       splits);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// n_split: 1 to 8 splits of the table, the most the launch takes (one
// cluster of them per kv-head and sequence).  packed: 0 = int8 pages [..,
// n_kv*head_dim], 1 = split-half int4 [.., n_kv*head_dim/2].  dtype (q and
// out): 0 = float32, 1 = bfloat16.  The pools are 16-byte aligned.
// Returns the CUDA error of the launch (0 on success).
extern "C" int paged_attention_quant_launch(
    const void* q, const void* k_pages, const void* v_pages, const void* k_scale,
    const void* v_scale, const int* lengths, const int* block_tables, void* out, int batch,
    int n_heads, int n_kv, int head_dim, int page_size, int pages_per_seq, int n_split,
    int packed, int dtype, void* stream) {
  return run(q, k_pages, v_pages, k_scale, v_scale, lengths, block_tables, out, batch, n_heads,
             n_kv, head_dim, page_size, pages_per_seq, n_split, packed, dtype,
             (cudaStream_t)stream, nullptr);
}

// The split count a launch of these shapes takes, in *splits.
extern "C" int paged_attention_quant_splits(int batch, int n_heads, int n_kv, int head_dim,
                                            int page_size, int pages_per_seq, int n_split,
                                            int packed, int dtype, int* splits) {
  return run(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, batch,
             n_heads, n_kv, head_dim, page_size, pages_per_seq, n_split, packed, dtype, nullptr,
             splits);
}
