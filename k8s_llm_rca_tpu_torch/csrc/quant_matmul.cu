// Fused int4 weight-dequant matmuls for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces: k8s_llm_rca_tpu/ops/quant_matmul.py::quant_matmul (Pallas kernel
// _kn4_kernel) and ::quant_matmul_head (_nk4_kernel).  Layouts are the JAX
// package's (models/quant.py), read as stored:
//
//   kn  x [M, K] @ (q [K, N/2] int8, split-half: byte j = column j in the low
//       nibble, column j + N/2 in the high nibble) * scale [1, N] -> [M, N]
//   nk  x [M, K] @ (q [V, K/2] int8 packed along K: byte j = k j low,
//       k j + K/2 high) * scale [V, 1] transposed -> [M, V]
//
// Nibbles (values -7..7) become floats by an exponent trick on 32-bit
// words (nib_f), not by integer-to-float instructions.  As in the Pallas
// kernels, the integer weights meet x with fp32 accumulation and the scale
// is applied once, in the epilogue; the output is in x's type.
//
// What bounds them on the H100.  At decode (M = the batch, 4 on the main
// path) both are weight streams: 2-29 MB of packed bytes per kn call and
// 263 MB for the Llama-3-8B head, against 2 * M flops per packed byte, so
// the floor is the packed bytes over 3.35 TB/s.  At prefill the kn call
// has M up to 5120 rows: ~0.6 TFLOP per MLP matmul, so there the floor is
// the tensor-core rate.
//
// Design (the bodies live in quant_matmul.cuh, shared with the int8 and
// expert matmuls).
// - kn, M <= 16 (weight streaming): each block owns 256 packed columns (a
//   warp reads 8 bytes a lane, 256 contiguous bytes of a row) and one K
//   split, whose rows of x it stages in shared memory.  Its 8 warps take
//   batches of 8 rows in turn, each thread keeping 4 x 16 fp32 sums (4
//   rows of x, 8 low and 8 high columns) and the next batch's loads in
//   flight while it multiplies the current one.  The warps' sums meet in
//   shared memory and each split writes fp32 partials; a second pass sums
//   the splits, scales and converts.  The split count fills the card's
//   resident block slots (the occupancy the runtime reports) in one wave,
//   which also gives the narrow matrices (wk, wv: 512 packed columns)
//   enough blocks.
// - kn, M > 16, bf16: 128 x 128 output tiles (64 packed columns give the
//   64 low and 64 high columns) on tensor cores, mma.sync m16n8k16 with
//   fp32 accumulators.  64-deep steps: cp.async brings the next step's x
//   tile and packed weights into a second shared-memory stage while the
//   current step's weights are unpacked to bf16 (exact) and multiplied.
//   Fragments by ldmatrix, as in flash_attention.cu.
// - kn, M > 16, fp32: 64 x 64 tiles, plain FMA, 4 x 4 outputs a thread.
// - nk: one warp per vocab row at a time (rows strided over a grid of one
//   wave); a lane reads 4-byte words 128 bytes apart, each byte's low
//   nibble meeting x[m, j] and its high nibble x[m, j + K/2], with the
//   block's rows of x (up to 8) staged once in shared memory as fp32.
// - kn, rows not a multiple of 16 packed bytes or K not a multiple of 32
//   (the MoE router, N = 4 or 8: 2 or 4 packed bytes a row): the narrow
//   bodies of quant_matmul.cuh.  M > 16: a block stages its [K, 2..16
//   bytes] slice in shared memory once and its warps walk rows of x, x
//   read once as 16-byte vectors; M <= 16: K split over warps, fp32
//   partials and the second pass; K not a multiple of 8: one block per row
//   of x and 16 packed columns, byte loads, K split over the threads.
//
// Not yet: TMA, wgmma and a deeper pipeline for the prefill tiles.

#include "quant_matmul.cuh"

// x [m, k] (x_dtype 0 = float32, 1 = bfloat16), q [k, n/2] int8, scale [n]
// (scale_dtype 0 = float32, 1 = bfloat16; bfloat16 x takes bfloat16 scales),
// out [m, n] in x's type; n even, x and q 16-byte aligned.  For m <= 16
// with n a multiple of 32 and k of 32, scratch holds max_splits * m * n
// floats, with max_splits >= k / 1792 rounded up; otherwise it is unused.
// Returns cudaGetLastError().
extern "C" int quant_matmul_kn4_launch(const void* x, const void* q, const void* scale,
                                       void* out, void* scratch, int m, int k, int n,
                                       int max_splits, int x_dtype, int scale_dtype,
                                       void* stream) {
  const KnGeom g{m, k, n, 1, 0, k, 0, n};
  return kn_dispatch<4>(x, q, scale, out, scratch, g, max_splits, x_dtype, scale_dtype,
                        stream);
}

// The body an [m, k] @ [k, n] call takes (quant_matmul.cuh): "gemv",
// "tile", "narrow_split", "narrow_smem" or "narrow_bytes".
extern "C" const char* quant_matmul_kn4_body(int m, int k, int n) {
  return kn_body_name<4>(m, k, n);
}

// x [m, k], q [v, k/2] int8, scale [v], out [m, v] in x's type; dtypes as
// above.  k is a multiple of 32 and min(m, 8) * k * 4 bytes fits the
// block's shared memory (227 KB).  Returns cudaGetLastError().
extern "C" int quant_matmul_nk4_launch(const void* x, const void* q, const void* scale,
                                       void* out, int m, int k, int v, int x_dtype,
                                       int scale_dtype, void* stream) {
  return nk_dispatch<4>(x, q, scale, out, m, k, v, x_dtype, scale_dtype, stream);
}
