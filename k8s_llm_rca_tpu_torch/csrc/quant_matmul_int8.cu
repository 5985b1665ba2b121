// Fused int8 weight-dequant matmuls for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces: k8s_llm_rca_tpu/ops/quant_matmul.py::quant_matmul (Pallas kernel
// _kn8_kernel) and ::quant_matmul_head (_nk8_kernel).  Layouts are the JAX
// package's (models/quant.py), read as stored:
//
//   kn  x [M, K] @ (q [K, N] int8) * scale [1, N] -> [M, N]
//   nk  x [M, K] @ (q [V, K] int8 * scale [V, 1]) transposed -> [M, V]
//
// As in the Pallas kernels, the integer weights meet x with fp32
// accumulation and the scale is applied once, in the epilogue; the output
// is in x's type.  Bytes become floats by an exponent trick (byte_f) and
// bf16 exactly (|q| <= 127 fits bf16's 8 significant bits).
//
// What bounds them on the H100.  At decode (M = 4 on the Mixtral path) both
// stream their weights: 4-17 MB per kn call (wq/wo [4096, 4096], wk/wv
// [4096, 1024]) and 131 MB for the Mixtral head [32000, 4096], against
// 2 * M flops per byte, so the floor is the bytes over 3.35 TB/s.  At
// prefill (M = 5120) a wq call is 0.17 TFLOP: the tensor-core rate.  The
// router [4096, 8] is tiny either way.
//
// Design (the bodies live in quant_matmul.cuh).
// - kn: the int4 matmul's bodies over bytes: for M <= 16 and bf16 x,
//   weight streaming on mma.sync (a lane group's 16 bytes at four rows of
//   K are the A fragments of 8 products, bytes to bf16 by lop3 and one
//   bf16x2 subtraction), K splits meeting in a thread block cluster, one
//   launch; for M > 16 and bf16 x, 128 x 256 tiles on wgmma over a TMA
//   ring, the weights converted into wgmma's register A fragments; fp32 x
//   keeps the FMA bodies; rows of N = 4 or 8 bytes (the router) take the
//   narrow bodies: the weight slice staged once per block in shared
//   memory with warps walking rows of x (M > 16), K split over warps with
//   a second pass (M <= 16), byte loads for K not a multiple of 8.
// - nk, bf16 x and K a multiple of 16 ("mma"): the int4 head's tensor-core
//   weight-streaming body over bytes: a lane's 16 bytes of each of two
//   table rows are the A fragments of 4 products, x's B fragments taking
//   the same k from a bf16 copy staged once per block; each warp streams
//   whole 16-row tiles through two register buffers taken in turn; one
//   launch.
// - nk, fp32 x or K not a multiple of 16 ("fma"): one warp per vocab row at
//   a time (rows strided over a grid of one wave); a lane reads 4-byte
//   words 128 bytes apart, four bytes meeting x[m, j .. j+3], with the
//   block's rows of x (up to 8) staged once in shared memory as fp32.

#include "quant_matmul.cuh"

// x [m, k] (x_dtype 0 = float32, 1 = bfloat16), q [k, n] int8, scale [n]
// (scale_dtype 0 = float32, 1 = bfloat16; bfloat16 x takes bfloat16 scales),
// out [m, n] in x's type; x and q 16-byte aligned.  For m <= 16 with
// float32 x, n a multiple of 16 and k of 32, and for the narrow_split body,
// scratch holds max_splits * m * n floats, with
// max_splits >= k / 1792 rounded up; otherwise it is unused.  Returns
// cudaGetLastError().
extern "C" int quant_matmul_kn8_launch(const void* x, const void* q, const void* scale,
                                       void* out, void* scratch, int m, int k, int n,
                                       int max_splits, int x_dtype, int scale_dtype,
                                       void* stream) {
  const KnGeom g{m, k, n, 1, 0, k, 0, n};
  return kn_dispatch<8>(x, q, scale, out, scratch, g, max_splits, x_dtype, scale_dtype,
                        stream);
}

// The body an [m, k] @ [k, n] call takes (quant_matmul.cuh): "gemv",
// "tile", "narrow_split", "narrow_smem" or "narrow_bytes".
extern "C" const char* quant_matmul_kn8_body(int m, int k, int n) {
  return kn_body_name<8>(m, k, n);
}

// x [m, k], q [v, k] int8, scale [v], out [m, v] in x's type; dtypes as
// above.  k is a multiple of 4 and the call has a body
// (quant_matmul_nk8_body).  Returns cudaGetLastError().
extern "C" int quant_matmul_nk8_launch(const void* x, const void* q, const void* scale,
                                       void* out, int m, int k, int v, int x_dtype,
                                       int scale_dtype, void* stream) {
  return nk_dispatch<8>(x, q, scale, out, m, k, v, x_dtype, scale_dtype, stream);
}

// The body an x [m, k] @ [v, k]^T call takes (quant_matmul.cuh): "mma",
// "fma" or "invalid" (no body: K not a multiple of 4, or x too wide for
// shared memory).
extern "C" const char* quant_matmul_nk8_body(int m, int k, int v, int x_dtype) {
  return nk_body_name<8>(m, k, v, x_dtype);
}
