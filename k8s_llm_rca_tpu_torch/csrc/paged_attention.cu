// Paged decode attention over an fp32 or bf16 pool for Hopper (sm_90a),
// plain C interface for ctypes.
//
// Replaces: k8s_llm_rca_tpu/ops/paged_attention.py::paged_attention
// (Pallas kernel _paged_kernel).  Layouts: q [B, n_heads, d]; k/v pages
// [n_pages, page_size, n_kv*d] in q's type, kv-heads merged on the last
// axis; lengths [B] int32 (the new token included); block_tables [B,
// pages_per_seq] int32 (page 0 = trash page); out [B, n_heads, d]; lse
// [B, n_heads] f32 or null (each row's log-sum-exp, for a merge of
// partial outputs).
//
// What bounds it on the H100: bytes, the KV rows the lengths need over
// 3.35 TB/s.  The body is csrc/paged_attention.cuh (one launch per call:
// a thread block cluster of the sequence's splits per (kv-head, sequence),
// per-warp cp.async rings, the splits merged through distributed shared
// memory in rank order); this file instantiates it with the fp32 and bf16
// load policies (16-byte vectors of 4 or 8 lanes).

#include "paged_attention.cuh"

namespace {

// The launch, or with `splits` set only the split count it would take.
int run(const void* q, const void* k_pages, const void* v_pages, const int* lengths,
        const int* block_tables, void* out, float* lse, int batch, int n_heads, int n_kv, int head_dim,
        int page_size, int pages_per_seq, int n_split, int dtype, cudaStream_t s,
        int* splits) {
  if (!paged::shapes_ok(batch, n_heads, n_kv, page_size, pages_per_seq, n_split))
    return (int)cudaErrorInvalidValue;
  const int elem = dtype == 0 ? 4 : 2;
  const paged::Args a{q, (const uint8_t*)k_pages, (const uint8_t*)v_pages, nullptr, nullptr,
                      lengths, block_tables, out, lse, (unsigned)(n_kv * head_dim * elem),
                      n_heads, n_kv, page_size, pages_per_seq, n_split, 0, 0,
                      paged::log2_exact(page_size)};
  if (dtype == 0)
    return paged::launch_shape<float, paged::FloatPages<float>>(a, batch, head_dim, s, splits);
  if (dtype == 1)
    return paged::launch_shape<__nv_bfloat16, paged::FloatPages<__nv_bfloat16>>(
        a, batch, head_dim, s, splits);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// n_split: 1 to 8 splits of the table, the most the launch takes (one
// cluster of them per kv-head and sequence).  dtype: 0 = float32, 1 =
// bfloat16.  The pools are 16-byte aligned.  lse may be null (no
// log-sum-exp written).  Returns the CUDA error of the launch (0 on
// success).
extern "C" int paged_attention_launch(const void* q, const void* k_pages,
                                      const void* v_pages, const int* lengths,
                                      const int* block_tables, void* out, float* lse,
                                      int batch,
                                      int n_heads, int n_kv, int head_dim, int page_size,
                                      int pages_per_seq, int n_split, int dtype,
                                      void* stream) {
  return run(q, k_pages, v_pages, lengths, block_tables, out, lse, batch, n_heads, n_kv,
             head_dim, page_size, pages_per_seq, n_split, dtype, (cudaStream_t)stream, nullptr);
}

// The split count a launch of these shapes takes, in *splits.
extern "C" int paged_attention_splits(int batch, int n_heads, int n_kv, int head_dim,
                                      int page_size, int pages_per_seq, int n_split,
                                      int dtype, int* splits) {
  return run(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, batch, n_heads,
             n_kv, head_dim, page_size, pages_per_seq, n_split, dtype, nullptr, splits);
}
