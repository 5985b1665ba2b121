// Fused weight-dequant matmuls over stacked MoE experts for Hopper (sm_90a),
// plain C interface for ctypes.
//
// Replaces: k8s_llm_rca_tpu/ops/quant_matmul.py::quant_matmul_experts
// (Pallas kernels _ekn8_kernel and _ekn4_kernel).  Per expert e, the kn
// product of quant_matmul.cuh: q [E, K, N] int8 or [E, K, N/2]
// split-half int4, scale [E, 1, N], fp32 sums scaled once in the epilogue,
// output in x's type.  It serves both einsums of the dense soft-dispatch
// MoE MLP (models/llama.py::_moe_mlp):
//
//   "bsh,ehi->bsei"  x [B*S, K], every expert reads the same rows: expert
//                    stride 0, row stride K (no broadcast copy)
//   "bsei,eih->bseh" x [B*S, E, K]: expert stride K, row stride E*K (no
//                    transpose copy)
//
// and writes out [B*S, E, N] directly, the einsums' own layout.
//
// What bounds them on the H100.  At decode (M = 4 rows per expert) each
// Mixtral-8x7B call streams 470 MB of int8 (235 MB of int4) expert weights
// against 2 * M flops per weight: at least 0.140 ms (0.070) at 3.35 TB/s,
// and 96 calls put >= 13.5 ms of int8 weights under every decode step.  At
// prefill (5120 rows x 8 experts) a call is 4.8 TFLOP: the tensor-core rate.
//
// Design: the expert is a grid dimension of every kn body, each block
// finding its expert's x, q, scale and output through the strides above.
// - M <= 16, bf16: the tensor-core weight-streaming body, blockIdx.z the
//   expert; the K-split count fills the card's resident slots counting
//   the expert blocks (at decode w_gate's 8 experts x 112 panels of 128
//   outputs already fill it, so one split; see PERF.md for each shape).
// - M > 16, bf16: the TMA + wgmma tile body; the x tensor map of the 3-D
//   einsum has no expert axis (stride 0: the expert comes from the tile
//   number), the 4-D einsum's has one (x rows E * K apart), and the
//   weights' map is [E, K, np], so no box crosses into the next expert.
//   Tiles are numbered expert-major, bands of 8 row tiles walked panel by
//   panel, so the resident blocks share one expert's weights in L2.
// Dense soft dispatch runs every expert on every row, padding included,
// as the JAX function does.
//
// Not yet: skipping the experts a token does not use; a persistent tile
// grid.

#include "quant_matmul.cuh"

// x rows: expert ex's row r at x + ex * x_es + r * x_rs (elements; x_dtype
// 0 = float32, 1 = bfloat16); q [e, k, n] int8 (bits 8) or [e, k, n/2]
// split-half packed (bits 4); scale [e, n] (scale_dtype as x_dtype;
// bfloat16 x takes bfloat16 scales); out [m, e, n] in x's type.  x and q
// 16-byte aligned.  For m <= 16 with float32 x, n/2 (int4) or n (int8) a
// multiple of 16 and k of 32, and for the narrow_split body, scratch
// holds e * max_splits * m * n floats, with max_splits >= k / 1792
// rounded up; otherwise it is unused.  Returns
// cudaGetLastError().
extern "C" int quant_matmul_ekn_launch(const void* x, const void* q, const void* scale,
                                       void* out, void* scratch, int m, int k, int n, int e,
                                       long long x_es, long long x_rs, int max_splits,
                                       int bits, int x_dtype, int scale_dtype, void* stream) {
  const KnGeom g{m, k, n, e, x_es, x_rs, n, (long long)e * n};
  if (bits == 8)
    return kn_dispatch<8>(x, q, scale, out, scratch, g, max_splits, x_dtype, scale_dtype,
                          stream);
  if (bits == 4)
    return kn_dispatch<4>(x, q, scale, out, scratch, g, max_splits, x_dtype, scale_dtype,
                          stream);
  return (int)cudaErrorInvalidValue;
}

// The body an expert call of m rows, [k, n] weights and `bits` takes (the
// names of quant_matmul_kn{4,8}_body; the expert axis does not change it).
extern "C" const char* quant_matmul_ekn_body(int m, int k, int n, int bits) {
  if (bits == 8) return kn_body_name<8>(m, k, n);
  if (bits == 4) return kn_body_name<4>(m, k, n);
  return "invalid";
}
