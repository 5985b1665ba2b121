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
// - kn, M <= 16, bf16 ("gemv"): weight streaming on tensor cores.  The
//   packed weights, 8 bytes a lane group (16 outputs) at four rows of K,
//   are the A operand of mma.sync m16n8k16, the rows of x the B operand
//   (8 or 16, zeros past M); a byte_perm pairs one column's values of two
//   K rows and lop3 plus one bf16x2 subtraction makes them exact bf16, so
//   a packed word costs ~12 instructions, not ~64 fp32 FMAs.  A block owns
//   128 outputs (64 packed columns) and one K split; the splits of a panel
//   form a thread block cluster whose sums meet in distributed shared
//   memory in split order: one launch, deterministic.
// - kn, M > 16, bf16 ("tile"): 128 x 256 output tiles (128 packed
//   columns give the 128 low and 128 high columns).  One producer thread
//   brings x (128 rows x 64 k, 128-byte swizzled) and the packed weights
//   (64 k x 128 bytes) by TMA into a 6-stage ring.  Each of two consumer
//   warpgroups takes one nibble of the 128 packed columns: its lanes read
//   packed words from shared memory and convert them straight into the A
//   fragments of wgmma m64n128k16 (the transposed product: weights from
//   registers, x the K-major B operand), and the two warpgroups take turns
//   issuing, so one converts while the other's products run.  The
//   epilogue scales in fp32 and stores 16-byte rows staged in shared
//   memory.
// - kn, fp32 (the cross-device checks): split-K FMA weight streaming with
//   a second pass (M <= 16), 64 x 64 FMA tiles (M > 16).
// - nk, bf16 ("mma"): weight streaming on tensor cores.  The table rows
//   are the A operand of mma.sync m16n8k16: a lane reads 16 bytes of each
//   of two rows of a 16-row tile, whose low nibbles meet x[:, :K/2] and
//   high nibbles x[:, K/2:] in 8 products, x's B fragments taking the same
//   k order from a bf16 copy of x staged once per block in shared memory.
//   Each warp streams whole tiles over all of K, 256 bytes of each row a
//   batch, through two register buffers taken in turn, so the next batch
//   is in flight while one is converted and multiplied; its sums are its
//   outputs (no reduction); one resident wave of warps strides over the
//   tiles.  One launch, deterministic.
// - nk, fp32 ("fma", the cross-device checks): one warp per vocab row at a
//   time; a lane reads 4-byte words 128 bytes apart, each byte's low
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
// Not yet: a persistent tile grid and a TMA store of the output tile.

#include "quant_matmul.cuh"

// x [m, k] (x_dtype 0 = float32, 1 = bfloat16), q [k, n/2] int8, scale [n]
// (scale_dtype 0 = float32, 1 = bfloat16; bfloat16 x takes bfloat16 scales),
// out [m, n] in x's type; n even, x and q 16-byte aligned.  For m <= 16
// with float32 x, n a multiple of 32 and k of 32, and for the narrow_split
// body, scratch holds max_splits * m * n floats, with max_splits >= k /
// 1792 rounded up; otherwise it is unused.
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
// above.  k is a multiple of 32 and the call has a body
// (quant_matmul_nk4_body).  Returns cudaGetLastError().
extern "C" int quant_matmul_nk4_launch(const void* x, const void* q, const void* scale,
                                       void* out, int m, int k, int v, int x_dtype,
                                       int scale_dtype, void* stream) {
  return nk_dispatch<4>(x, q, scale, out, m, k, v, x_dtype, scale_dtype, stream);
}

// The body an x [m, k] @ [v, k/2]^T call takes (quant_matmul.cuh): "mma",
// "fma" or "invalid" (no body: K not a multiple of 32, or x too wide for
// shared memory).
extern "C" const char* quant_matmul_nk4_body(int m, int k, int v, int x_dtype) {
  return nk_body_name<4>(m, k, v, x_dtype);
}
