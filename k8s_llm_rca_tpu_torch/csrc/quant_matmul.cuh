// Shared pieces of the fused weight-dequant matmuls for Hopper (sm_90a):
// value conversions, the TMA, mbarrier and tensor-core helpers, the kn
// bodies y = x @ (q * s) with per-column scales, for int8 and split-half
// int4 weights, with an optional leading expert axis, and the nk bodies
// (the lm head).  Included by quant_matmul.cu (int4 kn and nk),
// quant_matmul_int8.cu (int8 kn and nk) and quant_matmul_experts.cu (int8
// and int4 ekn); each compiles its own copy into its own library.
//
// The kn bodies for rows of a multiple of 16 packed bytes and K of 32
// (what bounds them, see quant_matmul.cu):
// - M <= 16, bf16 x ("gemv", weight streaming; bound by the weight bytes):
//   the weights are the A operand of mma.sync m16n8k16 and up to two tiles
//   of 8 rows of x the B operand, so the FMA issue rate no longer sets the
//   time; int8 and int4 become bf16 pairs by lop3 and one bf16x2
//   subtraction (s8x2_bf16, s4x2_bf16).  A block owns 128 outputs and one
//   K split; the splits of a panel (up to 8, as many as fill the card's
//   resident slots in one wave) form a thread block cluster and add their
//   sums in distributed shared memory in split order: one launch, the same
//   bits on every run.
// - M > 16, bf16 x ("tile"; bound by the tensor-core rate): 128 x 256
//   output tiles; a producer thread streams x and the packed weights by
//   TMA into a 5- or 6-stage ring; two consumer warpgroups convert the
//   packed weights straight into wgmma A fragments (the transposed
//   product, weights as A from registers, x as the K-major B operand in
//   shared memory) and take turns issuing wgmma m64n128k16, so one
//   converts while the other's products run; an L2 raster of 8-row-tile
//   bands.
// - fp32 x (the cross-device checks; tensor cores would round it): split-K
//   FMA weight streaming with a second pass (M <= 16), 64 x 64 FMA tiles.
// - Rows that are not a multiple of 16 bytes or K not a multiple of 32
//   (the MoE router: N = 4 or 8, rows of 2 to 8 packed bytes).  A block
//   owns a slice of CB packed columns (the whole row when it is 2, 4, 8 or
//   16 bytes, else 16 or the next power of two).  Three bodies, chosen by
//   shape (kn_narrow_kind; quant_matmul_kn{4,8}_body names them):
//   - narrow_smem, M > 16 and K a multiple of 8 (up to 10240): a block
//     stages its weight slice once in shared memory and then streams rows
//     of x past it, so x is read from memory once and the weights once per
//     block, not once per row of x.  bf16 x: the slice is 8 output columns
//     as exact bf16, and units of 16 rows run on tensor cores (mma.sync),
//     the block's warps splitting K and meeting in shared memory (x as
//     16-byte loads, four 32-k steps in flight).  fp32 x (exact fp32, the
//     cross-device checks): CB packed columns as bytes, warps walking a few
//     rows of x at a time, lanes along K on 16-byte vectors, fp32 FMA and
//     one warp reduction per sum.
//   - narrow_split, M <= 16 and K a multiple of 8: the same warp walk, its
//     weights read straight from memory, with K split over one warp per
//     split; fp32 partials and the second pass of the fp32 weight-streaming
//     body (deterministic sums, no atomics).
//   - narrow_bytes, any other shape (K not a multiple of 8, or a slice
//     too large for shared memory): one block per (row of x, 16 packed
//     columns), its threads splitting K, bytes read one by one (no
//     alignment assumed), a block reduction at the end.
// The nk head (x @ (q * s)^T, rows of the table along K), bf16 x ("mma",
// weight streaming; bound by the table's bytes): the table rows are the A
// operand of mma.sync m16n8k16, a lane reading 16 bytes of each of two
// rows and the x rows' B fragments following the same k order from x
// staged once per block in shared memory as bf16; each warp streams whole
// 16-row tiles (no K split, no reduction) through two register buffers
// taken in turn; one resident wave.  fp32 x, and int8 rows of K not a
// multiple of 16, keep the FMA body ("fma"; nk_body names them).
// Integers become fp32 by an exponent trick on 32-bit words (nib_f,
// byte_f) and bf16 by the lop3 trick above, not by integer-to-float
// instructions (a quarter-rate pipe).
//
// Not yet: a persistent tile grid (one tile's epilogue overlapping the
// next tile's loads) and a TMA store of the output tile.

#pragma once

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// the nibble at bit `shift` of a word flipped to offset binary (word ^
// 0x88888888), as a float: 0x4B000000 | u is the float 2^23 + u, so
// subtracting 2^23 + 8 gives the signed value exactly
__device__ __forceinline__ float nib_f(uint32_t w8, int shift) {
  return __int_as_float(0x4B000000u | ((w8 >> shift) & 0xFu)) - 8388616.f;
}

// the byte at bit `shift` of a word flipped to offset binary (word ^
// 0x80808080), as a float: 2^23 + u minus 2^23 + 128, exactly
__device__ __forceinline__ float byte_f(uint32_t w8, int shift) {
  return __int_as_float(0x4B000000u | ((w8 >> shift) & 0xFFu)) - 8388736.f;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// Integers to bf16 pairs without a float: each 16-bit half of t holds a
// value in its low bits, which lop3 ORs into the mantissa of a bf16 of
// exponent 2^7 (0x4300 | u is 128 + u for u < 128), and one bf16x2
// subtraction removes the offset.  Exact: every result is an integer of
// at most 8 significant bits.
__device__ __forceinline__ uint32_t bf16x2_sub(uint32_t a, uint32_t b) {
  const __nv_bfloat162 r = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&a),
                                   *reinterpret_cast<const __nv_bfloat162*>(&b));
  return *reinterpret_cast<const uint32_t*>(&r);
}

// the signed bytes at bits 0 and 16 of t: 128 + (low 7 bits) minus 128
// + (the sign bit's 128), i.e. 128 or 256
__device__ __forceinline__ uint32_t s8x2_bf16(uint32_t t) {
  return bf16x2_sub((t & 0x007F007Fu) | 0x43004300u, (t & 0x00800080u) | 0x43004300u);
}

// the signed nibbles at bits 0 and 16 of t: (u ^ 8) + 128 minus 136
__device__ __forceinline__ uint32_t s4x2_bf16(uint32_t t) {
  return bf16x2_sub((t & 0x000F000Fu) ^ 0x43084308u, 0x43084308u);
}

// ------------------------------------------- TMA, mbarriers and wgmma

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// spin until the phase of the given parity has completed; a wait that
// outlasts any real copy (2^28 polls, seconds) traps, so a broken
// protocol fails the launch instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  for (uint32_t polls = 0; !done; ++polls) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (polls == (1u << 28)) __trap();
  }
}

// one box of a 3-D tensor map (coordinates innermost first) into shared
// memory, completing its bytes on the barrier
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// wgmma shared-memory matrix descriptor: start address, leading and stride
// byte offsets (16-byte units) and the swizzle layout (1 = 128-byte)
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                              uint64_t layout) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (layout << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keeps the compiler from moving reads or writes of an accumulator across
// the asynchronous product that owns it
template <int N> __device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// D[64 x 128] += A[64 x 16] . B[16 x 128], A from registers (the
// mma.sync A fragment layout, per warp 16 rows), B K-major in shared memory
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\nwgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// Geometry of one kn call.  Expert ex's row r of x starts at
// x + ex * x_es + r * x_rs and of out at out + ex * out_es + r * out_rs
// (elements); q is [e, k, np] bytes (np = n for int8, n / 2 for int4),
// scale [e, n].  The plain 2-D call is e = 1, x_rs = k, out_rs = n.
struct KnGeom {
  int m, k, n, e;
  long long x_es, x_rs, out_es, out_rs;
};

template <int BITS> __host__ __device__ constexpr int packed_cols(int n) {
  return BITS == 4 ? n / 2 : n;
}

// ------------------------------------------------ small M, fp32: FMA
//
// The fp32 weight-streaming body (exact fp32 x, the cross-device checks):
// split K, each lane's 16 outputs as fp32 FMAs on weights made float by
// unpack_lane, fp32 partials and a second pass (kn_reduce_kernel) that
// sums the splits in order and scales.

constexpr int kGemvMaxM = 16;      // rows of x the weight-streaming bodies take
constexpr int kGemvMT = 4;         // rows of x per block
constexpr int kGemvThreads = 256;
constexpr int kGemvWarps = kGemvThreads / 32;
constexpr int kGemvMinRows = 128;  // fewest rows of K a split walks
constexpr int kGemvMaxRows = 1792; // most rows of K a split stages (28 KB of x)

template <int BITS> struct KnGemv {
  static constexpr int kLaneBytes = BITS == 4 ? 8 : 16;  // 16 outputs a lane
  static constexpr int kBatch = BITS == 4 ? 8 : 4;       // rows whose loads a thread issues together
  static constexpr int kCols = 32 * kLaneBytes;          // packed columns per block
  using Vec = typename std::conditional<BITS == 4, uint2, uint4>::type;
};

// a lane's 16 values in output-slot order: int4 slots 0..7 are the low
// nibbles of packed columns c..c+7 (output columns c..c+7), 8..15 their
// high nibbles (output columns np + c ..); int8 slot j is column c + j
__device__ __forceinline__ void unpack_lane(const uint2& v, float (&wf)[16]) {
  const uint32_t a = v.x ^ 0x88888888u;
  const uint32_t b = v.y ^ 0x88888888u;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    wf[i] = nib_f(a, 8 * i);
    wf[4 + i] = nib_f(b, 8 * i);
    wf[8 + i] = nib_f(a, 8 * i + 4);
    wf[12 + i] = nib_f(b, 8 * i + 4);
  }
}
__device__ __forceinline__ void unpack_lane(const uint4& v, float (&wf)[16]) {
  const uint32_t w[4] = {v.x ^ 0x80808080u, v.y ^ 0x80808080u, v.z ^ 0x80808080u,
                         v.w ^ 0x80808080u};
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) wf[4 * j + i] = byte_f(w[j], 8 * i);
}

template <int BITS> __device__ __forceinline__ int slot_col(int c, int e, int np) {
  if constexpr (BITS == 4) return e < 8 ? c + e : np + c + (e - 8);
  return c + e;
}

// unscaled fp32 partials [e, k_splits, m, n]; the x rows of this split
// staged in dynamic shared memory [kGemvMT][ke - kb].  blockIdx.z is
// expert * m_blocks + the block of rows.
template <int BITS>
__global__ void __launch_bounds__(kGemvThreads, 2)
kn_gemv_kernel(const float* __restrict__ x, const int8_t* __restrict__ q,
               float* __restrict__ part, KnGeom g, int k_per_split, int m_blocks) {
  using G = KnGemv<BITS>;
  using Vec = typename G::Vec;
  extern __shared__ __align__(16) float xs[];
  __shared__ float red[kGemvWarps][16][33];
  const int np = packed_cols<BITS>(g.n);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int c = blockIdx.x * G::kCols + lane * G::kLaneBytes;  // this lane's packed columns
  const bool col_ok = c < np;  // np % kLaneBytes == 0: whole vector or none
  const int split = blockIdx.y;
  const int ex = blockIdx.z / m_blocks;
  const int m0 = (blockIdx.z % m_blocks) * kGemvMT;
  const int kb = split * k_per_split;
  const int ke = min(g.k, kb + k_per_split);
  const int rows = max(ke - kb, 0);
  const float* xe = x + ex * g.x_es;
  const int8_t* qe = q + (long long)ex * g.k * np;

  for (int i = tid; i < kGemvMT * rows; i += kGemvThreads) {
    const int mm = i / rows;
    const int r = i % rows;
    xs[i] = m0 + mm < g.m ? xe[(m0 + mm) * g.x_rs + kb + r] : 0.f;
  }
  __syncthreads();

  float acc[kGemvMT][16];
#pragma unroll
  for (int mm = 0; mm < kGemvMT; ++mm)
#pragma unroll
    for (int e = 0; e < 16; ++e) acc[mm][e] = 0.f;

  // batches of rows dealt round-robin to the warps; the next batch's loads
  // are in flight while the current one is multiplied
  auto load = [&](int batch, Vec (&wv)[G::kBatch]) {
#pragma unroll
    for (int u = 0; u < G::kBatch; ++u) {
      const int r = batch * G::kBatch + u;
      wv[u] = Vec{};
      if (col_ok && r < rows)
        wv[u] = *reinterpret_cast<const Vec*>(qe + (long long)(kb + r) * np + c);
    }
  };
  Vec cur[G::kBatch], nxt[G::kBatch];
  const int n_batches = (rows + G::kBatch - 1) / G::kBatch;
  int batch = warp;
  if (batch < n_batches) load(batch, cur);
  for (; batch < n_batches; batch += kGemvWarps) {
    if (batch + kGemvWarps < n_batches) load(batch + kGemvWarps, nxt);
#pragma unroll
    for (int u = 0; u < G::kBatch; ++u) {
      float wf[16];
      unpack_lane(cur[u], wf);
      const int r = batch * G::kBatch + u;
#pragma unroll
      for (int mm = 0; mm < kGemvMT; ++mm) {
        const float xv = r < rows ? xs[mm * rows + r] : 0.f;
#pragma unroll
        for (int e = 0; e < 16; ++e) acc[mm][e] = fmaf(xv, wf[e], acc[mm][e]);
      }
    }
#pragma unroll
    for (int u = 0; u < G::kBatch; ++u) cur[u] = nxt[u];
  }

  // the warps' sums, one row of x at a time; output o = (lane ln, slot e)
  for (int mm = 0; mm < kGemvMT; ++mm) {
    __syncthreads();
#pragma unroll
    for (int e = 0; e < 16; ++e) red[warp][e][lane] = acc[mm][e];
    __syncthreads();
    if (m0 + mm >= g.m) continue;  // uniform over the block
    for (int o = tid; o < 16 * 32; o += kGemvThreads) {
      const int ln = o / 16;
      const int e = o % 16;
      const int cl = blockIdx.x * G::kCols + ln * G::kLaneBytes;
      if (cl >= np) continue;
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < kGemvWarps; ++w) s += red[w][e][ln];
      part[(((long long)ex * gridDim.y + split) * g.m + m0 + mm) * g.n +
           slot_col<BITS>(cl, e, np)] = s;
    }
  }
}

template <typename T, typename S>
__global__ void __launch_bounds__(256)
kn_reduce_kernel(const float* __restrict__ part, const S* __restrict__ scale,
                 T* __restrict__ out, KnGeom g, int k_splits) {
  const long long mn = (long long)g.m * g.n;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= mn * g.e) return;
  const int ex = (int)(i / mn);
  const long long rem = i - ex * mn;
  const int row = (int)(rem / g.n);
  const int col = (int)(rem - (long long)row * g.n);
  const float* p = part + (long long)ex * k_splits * mn + rem;
  float s = 0.f;
  for (int sp = 0; sp < k_splits; ++sp) s += p[sp * mn];
  out[ex * g.out_es + row * g.out_rs + col] =
      from_f<T>(s * to_f(scale[(long long)ex * g.n + col]));
}

// ------------------------------------------- small M, bf16: tensor cores
//
// The weights are the A operand of mma.sync m16n8k16 (16 output columns x
// 16 k), the rows of x the B operand (8 rows: x rows past m are zeros,
// which cost nothing on a card that waits for the weights).  A lane group
// (lanes 4gq .. 4gq + 3) owns 16 outputs: 16 int8 bytes or 8 int4 bytes
// (8 low, 8 high nibbles) of one weight row, read as one vector.  In a
// 16-k step lane tq loads that vector at rows k + 4tq .. k + 4tq + 3, so a
// warp's load reads four rows of 8 contiguous vectors.  The product sums
// over k in any order: the fragments' k slots 2tq, 2tq + 1, 2tq + 8, 2tq + 9
// take rows k + 4tq + 0 .. 3, in the weights and in x alike (x's four
// values are one 8-byte load).  Fragment j of the step holds the group's
// output slots 2j (rows gq) and 2j + 1 (rows gq + 8): a byte_perm pairs
// one column's bytes of two rows, and s8x2_bf16 / s4x2_bf16 make them
// bf16.  Slot s of a group is int8 column c + s; int4 slot s < 8 the low
// nibble of packed column c + s (output c + s), s >= 8 its high nibble
// (output np + c + s - 8).
//
// A block owns 128 outputs and one K split; its 8 warps take 16-k steps in
// batches whose loads are in flight together, and their sums meet in
// shared memory in warp order.  The K splits of a panel form one thread
// block cluster; their sums meet in distributed shared memory, each block
// of the cluster adding a share of the outputs over the splits in split
// order, scaling and storing.  One launch, no atomics: the same inputs give
// the same bits.

constexpr int kGmThreads = 256;
constexpr int kGmWarps = kGmThreads / 32;
constexpr int kGmMaxSplits = 8;  // one cluster of the portable size

template <int BITS> struct KnGm {
  using Vec = typename std::conditional<BITS == 4, uint2, uint4>::type;
  static constexpr int kGroupBytes = BITS == 4 ? 8 : 16;  // a lane group's 16 outputs
  static constexpr int kPanel = 8 * kGroupBytes;          // packed columns per block
  static constexpr int kBatch = BITS == 4 ? 4 : 2;        // steps whose loads issue together
  static constexpr int kMinK = kGmWarps * kBatch * 16;    // fewest rows of K a split walks
};

// shared memory: the warps' sums [warps][NT * 32 registers][32 lanes], then
// the block's [NT * 32][32]
template <int NT> constexpr int gm_smem() { return (kGmWarps + 1) * NT * 32 * 32 * 4; }

// the A fragments of one step's 8 products from a lane's four vectors
__device__ __forceinline__ void gm_frags(const uint4 (&w)[4], uint32_t (&a)[8][4]) {
  const uint32_t v[4][4] = {{w[0].x, w[0].y, w[0].z, w[0].w},
                            {w[1].x, w[1].y, w[1].z, w[1].w},
                            {w[2].x, w[2].y, w[2].z, w[2].w},
                            {w[3].x, w[3].y, w[3].z, w[3].w}};
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    // bytes 2j, 2j + 1 of rows 0 and 1 (and 2 and 3) side by side
    const uint32_t sel = (j & 1) ? 0x7632u : 0x5410u;
    const uint32_t t01 = __byte_perm(v[0][j / 2], v[1][j / 2], sel);
    const uint32_t t23 = __byte_perm(v[2][j / 2], v[3][j / 2], sel);
    a[j][0] = s8x2_bf16(t01);
    a[j][1] = s8x2_bf16(t01 >> 8);
    a[j][2] = s8x2_bf16(t23);
    a[j][3] = s8x2_bf16(t23 >> 8);
  }
}
__device__ __forceinline__ void gm_frags(const uint2 (&w)[4], uint32_t (&a)[8][4]) {
  const uint32_t v[4][2] = {{w[0].x, w[0].y}, {w[1].x, w[1].y}, {w[2].x, w[2].y},
                            {w[3].x, w[3].y}};
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    // bytes 2p, 2p + 1: their low nibbles are slots 2p, 2p + 1, their
    // high nibbles slots 2p + 8, 2p + 9
    const uint32_t sel = (p & 1) ? 0x7632u : 0x5410u;
    const uint32_t t01 = __byte_perm(v[0][p / 2], v[1][p / 2], sel);
    const uint32_t t23 = __byte_perm(v[2][p / 2], v[3][p / 2], sel);
    a[p][0] = s4x2_bf16(t01);
    a[p][1] = s4x2_bf16(t01 >> 8);
    a[p][2] = s4x2_bf16(t23);
    a[p][3] = s4x2_bf16(t23 >> 8);
    a[p + 4][0] = s4x2_bf16(t01 >> 4);
    a[p + 4][1] = s4x2_bf16(t01 >> 12);
    a[p + 4][2] = s4x2_bf16(t23 >> 4);
    a[p + 4][3] = s4x2_bf16(t23 >> 12);
  }
}

// blockIdx (panel of 128 outputs, K split = rank in the cluster, expert);
// NT tiles of 8 rows of x (m <= 8 * NT)
template <int BITS, int NT, typename S>
__global__ void __launch_bounds__(kGmThreads, NT == 1 ? 2 : 1)
kn_gemv_mma_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ q,
                   const S* __restrict__ scale, __nv_bfloat16* __restrict__ out, KnGeom g,
                   int k_per_split) {
  using G = KnGm<BITS>;
  using Vec = typename G::Vec;
  constexpr int kRegs = NT * 32;  // a lane's sums: NT x 8 products x 4
  extern __shared__ __align__(16) float red[];
  const int np = packed_cols<BITS>(g.n);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int gq = lane >> 2;  // lane group: its 16 outputs
  const int tq = lane & 3;   // rows 4tq .. 4tq + 3 of each step
  const int pbase = blockIdx.x * G::kPanel;
  const int pc = pbase + gq * G::kGroupBytes;
  const bool col_ok = pc < np;  // np % 16 == 0: a group is whole or absent
  const int split = blockIdx.y;
  const int ex = blockIdx.z;
  const int kb = split * k_per_split;
  const int steps = max(0, min(g.k - kb, k_per_split)) / 16;
  const int8_t* qe = q + (long long)ex * g.k * np + pc;
  const __nv_bfloat16* xe = x + ex * g.x_es;

  float acc[NT][8][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[nt][j][i] = 0.f;

  for (int s0 = warp * G::kBatch; s0 < steps; s0 += kGmWarps * G::kBatch) {
    Vec w[G::kBatch][4];
    uint2 xv[G::kBatch][NT];
#pragma unroll
    for (int u = 0; u < G::kBatch; ++u) {
      const bool ok = s0 + u < steps;
      const int k = kb + 16 * (s0 + u) + 4 * tq;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        w[u][r] = Vec{};
        if (ok && col_ok) w[u][r] = __ldg(reinterpret_cast<const Vec*>(qe + (long long)(k + r) * np));
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int row = gq + 8 * nt;
        xv[u][nt] = make_uint2(0u, 0u);
        if (ok && row < g.m)
          xv[u][nt] = __ldg(reinterpret_cast<const uint2*>(xe + row * g.x_rs + k));
      }
    }
#pragma unroll
    for (int u = 0; u < G::kBatch; ++u) {
      uint32_t a[8][4];
      gm_frags(w[u], a);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) mma_bf16(acc[nt][j], a[j], xv[u][nt].x, xv[u][nt].y);
    }
  }

  // the warps' sums, in warp order
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        red[(warp * kRegs + (nt * 8 + j) * 4 + i) * 32 + lane] = acc[nt][j][i];
  __syncthreads();
  float* part = red + kGmWarps * kRegs * 32;
  for (int e = tid; e < kRegs * 32; e += kGmThreads) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kGmWarps; ++w) s += red[w * kRegs * 32 + e];
    part[e] = s;
  }

  // the splits' sums, in split order: block `rank` of the cluster adds
  // every splits-th share of 256 sums
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int splits = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  for (int e = rank * kGmThreads + tid; e < kRegs * 32; e += splits * kGmThreads) {
    float s = 0.f;
    for (int r = 0; r < splits; ++r) s += cluster.map_shared_rank(part, r)[e];
    // sum e is register e / 32 of lane e % 32: product j of row tile nt,
    // fragment register i (slot 2j + i / 2, row of x 2tq + i % 2)
    const int reg = e >> 5;
    const int ln = e & 31;
    const int nt = reg >> 5;
    const int j = (reg >> 2) & 7;
    const int i = reg & 3;
    const int slot = 2 * j + (i >> 1);
    const int row = 8 * nt + 2 * (ln & 3) + (i & 1);
    const int gc = pbase + (ln >> 2) * G::kGroupBytes;
    if (row >= g.m || gc >= np) continue;
    const int col = BITS == 4 ? (slot < 8 ? gc + slot : np + gc + slot - 8) : gc + slot;
    out[ex * g.out_es + row * g.out_rs + col] =
        __float2bfloat16(s * to_f(scale[(long long)ex * g.n + col]));
  }
  cluster.sync();  // the other blocks' sums are read before they exit
}

// ------------------------------------------ large M, bf16: TMA + wgmma
//
// A block computes a 128 x 256 output tile: 128 rows of x by 256 output
// columns (int8: 256 packed columns; int4: 128 packed columns, whose low
// nibbles are outputs pc0 .. pc0 + 127 and high nibbles np + pc0 ..).  It
// computes the transposed product, out^T = (q s)^T x^T, so that the
// weights are wgmma's A operand, taken from registers, and x the B
// operand, K-major in shared memory as TMA lands it: the converted weights
// never go through shared memory.
// - Loads: one thread of the producer warpgroup keeps a ring of 5 (int8)
//   or 6 (int4) stages in flight by TMA.  A stage is 64 k of x (128 rows
//   of 128 bytes) and of the packed weights (one or two boxes of [64 k][128
//   bytes]), all 128-byte swizzled; boxes past m, np or K land as zeros.
// - Products: consumer warpgroup wg owns 128 output columns (int8: packed
//   columns 128 wg ..; int4: nibble wg of all 128), as two wgmma
//   m64n128k16 products per 16 k.  A lane group (lanes 4g .. 4g + 3 of
//   warp w) reads the 4-byte word of packed columns 32w + 4g .. + 3 at the
//   four k rows its A fragment needs (2tq, 2tq + 1, 2tq + 8, 2tq + 9); the
//   swizzle puts the 32 lanes' words on 32 banks.  A byte_perm pairs one
//   column's bytes of two rows and s8x2_bf16 / s4x2_bf16 make them bf16
//   (exact); fragment rows g and g + 8 of product j are columns 4g + 2j
//   and 4g + 2j + 1 of the word.
// - Overlap: the two warpgroups take turns issuing their products of a
//   16-k step (named barriers), so one converts its next fragments while
//   the other's products hold the tensor cores; a warpgroup loads the
//   next step's packed words while its own products run, and converts
//   them once they are done.  It writes fragment registers only when none
//   of its own products is in flight:
//   ptxas serializes every wgmma of a kernel in which registers that feed
//   one are written while another is pending, or whose in-flight
//   fragments do not fit the 168 registers a thread of a 384-thread block
//   has.  A stage is released once the products of its last 16 k are done.
// - Epilogue: scale in fp32, stage the bf16 tile transposed back in the
//   ring's shared memory, store 16-byte rows.
// - Raster: tiles are numbered expert-major, and within an expert in
//   bands of kTwGroupM row tiles walked column panel by column panel, so
//   the blocks resident at once share a few MB of x and weights in L2.
//
// Why this shape: every tile reads its x rows and its weight panel over
// all of K through L2, so wider tiles read fewer bytes per product (a
// 128 x 128 tile read ~4 TB/s from L2 at every prefill shape).  And
// shared memory, not the tensor cores, ran out first when the converted
// weights were written there and read back by wgmma as its B operand: at
// 128 x 256 a 64-k step then moves ~160 KB through shared memory in the
// ~1024 clocks its products take, against 128 bytes a clock.  With the
// weights in registers a step moves ~112 KB: x read by the products, the
// packed weights by the lanes, the TMA writes.

constexpr int kTwBM = 128;                      // rows of x per tile
constexpr int kTwBK = 64;                       // K per stage: one swizzled 128-byte row
constexpr int kTwBN = 256;                      // outputs per tile
constexpr int kTwConsumers = 256;               // two consumer warpgroups
constexpr int kTwThreads = kTwConsumers + 128;  // and the producer warpgroup
constexpr int kTwGroupM = 8;                    // row tiles per raster band
constexpr int kTwXBytes = kTwBM * kTwBK * 2;    // one stage of x
constexpr int kTwBoxBytes = kTwBK * 128;        // one [64 k][128 bytes] weight box
constexpr int kTwOutLd = kTwBN + 8;             // bf16 row stride of the staged output

template <int BITS> struct KnTw {
  static constexpr int kBytes = BITS == 4 ? 128 : 256;  // packed columns per tile
  static constexpr int kBoxes = kBytes / 128;
  static constexpr int kWBytes = kTwBK * kBytes;
  static constexpr int kStageBytes = kTwXBytes + kWBytes;
  static constexpr int kStages = BITS == 4 ? 6 : 5;     // TMA ring depth
  // 1 KB of slack to align the swizzled stages, the stages, the tile's
  // scales and the mbarriers
  static constexpr int kSmem = 1024 + kStages * kStageBytes + kTwBN * 4 + 2 * kStages * 8;
  static_assert(kTwBM * kTwOutLd * 2 <= kStages * kStageBytes,
                "the output tile is staged in the ring");
};

// the output column of tile column tc, or -1 past the weight's columns
template <int BITS> __device__ __forceinline__ int tw_col(int tc, int pc0, int np) {
  if constexpr (BITS == 4) {
    const int p = pc0 + tc % (kTwBN / 2);
    return p < np ? (tc < kTwBN / 2 ? p : np + p) : -1;
  }
  return pc0 + tc < np ? pc0 + tc : -1;
}

__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kTwConsumers) : "memory");
}
__device__ __forceinline__ void turn_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(kTwConsumers) : "memory");
}
__device__ __forceinline__ void turn_arrive(int id) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "n"(kTwConsumers) : "memory");
}

// tm_x: [m, x_experts ? e : 1, k] bf16 (innermost last here, first in the
// map), boxes 64 k x 1 x 128 rows; tm_q: [e, k, np] bytes, boxes 128 bytes
// x 64 k x 1; both 128-byte swizzled
template <int BITS, typename S>
__global__ void __launch_bounds__(kTwThreads, 1)
kn_wgmma_kernel(const __grid_constant__ CUtensorMap tm_x, const __grid_constant__ CUtensorMap tm_q,
                const S* __restrict__ scale, __nv_bfloat16* __restrict__ out, KnGeom g,
                int x_experts) {
  using Tw = KnTw<BITS>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // stage st: x at st * kStageBytes, then its weight boxes
  unsigned char* ring = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  float* sc = reinterpret_cast<float*>(ring + Tw::kStages * Tw::kStageBytes);
  uint64_t* full = reinterpret_cast<uint64_t*>(sc + kTwBN);
  uint64_t* empty = full + Tw::kStages;

  const int np = packed_cols<BITS>(g.n);
  const int tiles_n = (np + Tw::kBytes - 1) / Tw::kBytes;
  const int tiles_m = (g.m + kTwBM - 1) / kTwBM;
  int r = blockIdx.x;
  const int ex = r / (tiles_m * tiles_n);
  r -= ex * tiles_m * tiles_n;
  const int band = kTwGroupM * tiles_n;
  const int first_m = r / band * kTwGroupM;
  const int rows_in = min(tiles_m - first_m, kTwGroupM);
  const int m0 = (first_m + r % band % rows_in) * kTwBM;
  const int pc0 = r % band / rows_in * Tw::kBytes;
  const int steps = (g.k + kTwBK - 1) / kTwBK;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int st = 0; st < Tw::kStages; ++st) {
      mbar_init(&full[st], 1);
      mbar_init(&empty[st], kTwConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= kTwConsumers / 32) {  // producer
    if (warp == kTwConsumers / 32 && lane == 0) {
      for (int t = 0; t < steps; ++t) {
        const int st = t % Tw::kStages;
        unsigned char* stage = ring + st * Tw::kStageBytes;
        mbar_wait(&empty[st], ((t / Tw::kStages) & 1) ^ 1);
        mbar_expect_tx(&full[st], Tw::kStageBytes);
        tma_load_3d(stage, &tm_x, &full[st], t * kTwBK, x_experts ? ex : 0, m0);
#pragma unroll
        for (int b = 0; b < Tw::kBoxes; ++b)
          tma_load_3d(stage + kTwXBytes + b * kTwBoxBytes, &tm_q, &full[st], pc0 + 128 * b,
                      t * kTwBK, ex);
      }
    }
    return;
  }

  const int tid = threadIdx.x;
  const int wg = warp >> 2;
  const int gq = lane >> 2;
  const int tq = lane & 3;
  static_assert(kTwBN == kTwConsumers, "a consumer thread loads one column's scale");
  {
    const int col = tw_col<BITS>(tid, pc0, np);
    sc[tid] = col >= 0 ? to_f(scale[(long long)ex * g.n + col]) : 0.f;
  }
  // this lane group's word: packed columns cb .. cb + 3 of weight box
  // `box`; int4 takes nibble wg of each byte
  const int cb = 32 * (warp & 3) + 4 * gq;
  const int box = BITS == 8 ? wg : 0;
  const int nib = BITS == 4 ? 4 * wg : 0;

  float acc[2][64];
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[j][i] = 0.f;

  // The warpgroups take turns issuing a 16-k step's products (named
  // barriers 2 and 3, warpgroup 0 first), so one converts its next step
  // while the other's products hold the tensor cores.  A warpgroup writes
  // fragment registers only while none of its own products is in flight;
  // the next step's words load before it waits.
  if (wg == 1) turn_arrive(2);
  for (int t = 0; t < steps; ++t) {
    const int st = t % Tw::kStages;
    const unsigned char* stage = ring + st * Tw::kStageBytes;
    const unsigned char* wb = stage + kTwXBytes + box * kTwBoxBytes;
    const uint32_t x_addr = smem_u32(stage);
    mbar_wait(&full[st], (t / Tw::kStages) & 1);
    // this lane's words of 16-k step kk: packed columns cb .. cb + 3 at
    // its fragment rows 2tq, 2tq + 1, 2tq + 8, 2tq + 9
    auto words = [&](int kk, uint32_t (&v)[4]) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int k = kk * 16 + 2 * tq + (i & 1) + 8 * (i >> 1);
        v[i] = *reinterpret_cast<const uint32_t*>(wb + k * 128 + (((cb >> 4) ^ (k & 7)) << 4) +
                                                  (cb & 15));
      }
    };
    uint32_t v[4];
    words(0, v);
#pragma unroll
    for (int kk = 0; kk < kTwBK / 16; ++kk) {
      uint32_t a[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        // bytes 2j, 2j + 1 of rows (2tq, 2tq + 1) and of (2tq + 8, 2tq + 9)
        const uint32_t sel = j ? 0x7632u : 0x5410u;
        const uint32_t t01 = __byte_perm(v[0], v[1], sel);
        const uint32_t t23 = __byte_perm(v[2], v[3], sel);
        if constexpr (BITS == 8) {
          a[j][0] = s8x2_bf16(t01);
          a[j][1] = s8x2_bf16(t01 >> 8);
          a[j][2] = s8x2_bf16(t23);
          a[j][3] = s8x2_bf16(t23 >> 8);
        } else {
          a[j][0] = s4x2_bf16(t01 >> nib);
          a[j][1] = s4x2_bf16(t01 >> (8 + nib));
          a[j][2] = s4x2_bf16(t23 >> nib);
          a[j][3] = s4x2_bf16(t23 >> (8 + nib));
        }
      }
      const uint64_t db = smem_desc(x_addr + kk * 32, 16, 1024, 1);
      turn_sync(2 + wg);  // this warpgroup's turn
      fence_regs(acc[0]);
      fence_regs(acc[1]);
      wgmma_fence();
      wgmma_rs_n128(acc[0], a[0], db);
      wgmma_rs_n128(acc[1], a[1], db);
      wgmma_commit();
      turn_arrive(3 - wg);  // the other warpgroup's turn
      if (kk + 1 < kTwBK / 16) words(kk + 1, v);  // loads while the products run
      wgmma_wait_all();
      fence_regs(acc[0]);
      fence_regs(acc[1]);
    }
    mbar_arrive(&empty[st]);  // this thread no longer reads the stage
  }
  wgmma_wait_all();
  fence_regs(acc[0]);
  fence_regs(acc[1]);
  consumer_sync();  // every product has read the ring

  // register i of product j: fragment row 16 (warp & 3) + gq + 8 h, h =
  // (i >> 1) & 1, i.e. output column cb + 2j + h of this warpgroup's 128;
  // row of x 8 (i >> 2) + 2tq + (i & 1).  Registers i and i + 2 are two
  // neighbouring output columns of one row of x.
  __nv_bfloat16* os = reinterpret_cast<__nv_bfloat16*>(ring);  // [128][kTwOutLd]
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int tc = 128 * wg + cb + 2 * j;
    const float s0 = sc[tc];
    const float s1 = sc[tc + 1];
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      if (i & 2) continue;
      const int row = 8 * (i >> 2) + 2 * tq + (i & 1);
      *reinterpret_cast<uint32_t*>(&os[row * kTwOutLd + tc]) =
          pack_bf16(acc[j][i] * s0, acc[j][i + 2] * s1);
    }
  }
  consumer_sync();
  for (int c = tid; c < kTwBM * kTwBN / 8; c += kTwConsumers) {
    const int row = c / (kTwBN / 8);
    const int tc = c % (kTwBN / 8) * 8;
    const int col = tw_col<BITS>(tc, pc0, np);
    if (col < 0 || m0 + row >= g.m) continue;
    *reinterpret_cast<uint4*>(&out[ex * g.out_es + (long long)(m0 + row) * g.out_rs + col]) =
        *reinterpret_cast<const uint4*>(&os[row * kTwOutLd + tc]);
  }
}

// ---------------------------------------------------- large M, fp32 FMA

constexpr int kTfBM = 64;  // rows of x per block
constexpr int kTfBN = 64;  // outputs per block
constexpr int kTfBK = 16;

template <int BITS, typename S>
__global__ void __launch_bounds__(256)
kn_fma_kernel(const float* __restrict__ x, const int8_t* __restrict__ q,
              const S* __restrict__ scale, float* __restrict__ out, KnGeom g) {
  constexpr int kBytes = BITS == 4 ? kTfBN / 2 : kTfBN;  // packed columns per block
  const int np = packed_cols<BITS>(g.n);
  const int pc0 = blockIdx.x * kBytes;
  const int m0 = blockIdx.y * kTfBM;
  const int ex = blockIdx.z;
  const float* xe = x + ex * g.x_es;
  const int8_t* qe = q + (long long)ex * g.k * np;
  const int tid = threadIdx.x;
  const int ty = tid >> 4;  // rows ty*4 .. +3
  const int tx = tid & 15;  // tile columns tx*4 .. +3

  __shared__ __align__(16) float As[kTfBK][kTfBM + 4];  // x tile, transposed
  __shared__ __align__(16) float Bs[kTfBK][kTfBN + 4];  // converted weights

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < g.k; k0 += kTfBK) {
    __syncthreads();
    for (int i = tid; i < kTfBM * kTfBK; i += 256) {
      const int r = i / kTfBK;
      const int kk = i % kTfBK;
      As[kk][r] = m0 + r < g.m ? xe[(m0 + r) * g.x_rs + k0 + kk] : 0.f;
    }
    if constexpr (BITS == 4) {
      if (tid < 128) {
        const int r = tid >> 3;
        const int cb = (tid & 7) * 4;
        const bool ok = pc0 + cb < np;  // np % 16 == 0: all 4 bytes or none
        const uint32_t w =
            ok ? *reinterpret_cast<const uint32_t*>(qe + (long long)(k0 + r) * np + pc0 + cb)
               : 0u;
        const uint32_t w8 = w ^ 0x88888888u;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          Bs[r][cb + i] = nib_f(w8, 8 * i);
          Bs[r][kBytes + cb + i] = nib_f(w8, 8 * i + 4);
        }
      }
    } else {
      const int r = tid >> 4;
      const int cb = (tid & 15) * 4;
      const bool ok = pc0 + cb < np;
      const uint32_t w =
          ok ? *reinterpret_cast<const uint32_t*>(qe + (long long)(k0 + r) * np + pc0 + cb)
             : 0u;
      const uint32_t w8 = w ^ 0x80808080u;
#pragma unroll
      for (int i = 0; i < 4; ++i) Bs[r][cb + i] = byte_f(w8, 8 * i);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kTfBK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty * 4 + i;
    if (row >= g.m) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int tc = tx * 4 + j;
      int col;
      if constexpr (BITS == 4) {
        const int pcol = pc0 + (tc & (kBytes - 1));
        if (pcol >= np) continue;
        col = tc < kBytes ? pcol : np + pcol;
      } else {
        col = pc0 + tc;
        if (col >= np) continue;
      }
      out[ex * g.out_es + row * g.out_rs + col] =
          acc[i][j] * to_f(scale[(long long)ex * g.n + col]);
    }
  }
}

// ---------------------------- narrow rows, K a multiple of 8 (smem, split)

constexpr int kNwThreads = 256;            // narrow_smem: 8 warps walk rows of x
constexpr int kNwWarps = kNwThreads / 32;
constexpr int kNwSplitThreads = 128;       // narrow_split: a warp per K split
constexpr int kNwSplitWarps = kNwSplitThreads / 32;
constexpr int kNwMaxSlice = 160 * 1024;    // most weight bytes a block stages

// packed columns a block covers: the whole row when it is 2, 4, 8 or 16
// bytes (then the slice is contiguous), else the next power of two, or 16
__host__ __device__ constexpr int narrow_cb(int np) {
  return np <= 2 ? 2 : np <= 4 ? 4 : np <= 8 ? 8 : 16;
}

template <int BITS, int CB, typename T> struct Nw {
  static constexpr int kVals = BITS == 4 ? 2 * CB : CB;  // a lane's sums per row of x
  // rows of x a warp walks together: kRows * kVals <= 32 sums a lane
  static constexpr int kRows = kVals >= 32 ? 1 : (32 / kVals > 8 ? 8 : 32 / kVals);
  static constexpr int kVec = 16 / (int)sizeof(T);      // K of one 16-byte load of x
  static constexpr int kLane = kVec * CB;               // weight bytes meeting that load
  static constexpr int kWords = kLane / 4;
  static constexpr int kStep = 32 * kVec;               // K a warp covers per step
};

// Shared-memory position of byte o of the staged slice ([K][CB] bytes,
// K-row major): a lane reads kLane contiguous bytes as 16-byte chunks, and
// the chunks of neighbouring lanes' groups are XOR-permuted so 8 lanes of a
// phase hit 8 distinct bank quads
template <int L> __device__ __forceinline__ int nw_pos(int o) {
  if constexpr (L < 32) {
    return o;
  } else {
    const int grp = o / L;
    const int key = ((grp * L) >> 7) & (L / 16 - 1);
    return grp * L + ((((o % L) >> 4) ^ key) << 4) + (o & 15);
  }
}

// stage rows [0, k) of the slice (packed columns c0 .. c0 + nc of rows np
// bytes apart) into ws; columns past nc are zeros
template <int BITS, int CB, typename T>
__device__ void nw_stage(unsigned char* ws, const int8_t* qe, int k, int np, int c0, int nc) {
  using N = Nw<BITS, CB, T>;
  if (np == CB) {  // the slice is the whole weight, contiguous: 16-byte loads
    const uint4* src = reinterpret_cast<const uint4*>(qe);
    const int n16 = k * CB / 16;
    for (int i0 = threadIdx.x; i0 < n16; i0 += 4 * blockDim.x) {
      uint4 v[4];  // four loads in flight before the stores
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = i0 + u * blockDim.x;
        if (i < n16) v[u] = src[i];
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = i0 + u * blockDim.x;
        if (i < n16) *reinterpret_cast<uint4*>(ws + nw_pos<N::kLane>(16 * i)) = v[u];
      }
    }
  } else {
    for (int o = threadIdx.x; o < k * CB; o += blockDim.x) {
      const int c = o % CB;
      ws[nw_pos<N::kLane>(o)] =
          c < nc ? (unsigned char)qe[(long long)(o / CB) * np + c0 + c] : (unsigned char)0;
    }
  }
}

// the kLane weight bytes of rows kk .. kk + kVec of the slice as words
template <int BITS, int CB, typename T>
__device__ __forceinline__ void nw_words_smem(uint32_t (&w)[Nw<BITS, CB, T>::kWords],
                                              const unsigned char* ws, int kk) {
  using N = Nw<BITS, CB, T>;
  const int o = kk * CB;
  if constexpr (N::kLane >= 16) {
#pragma unroll
    for (int j = 0; j < N::kLane / 16; ++j) {
      const uint4 v = *reinterpret_cast<const uint4*>(ws + nw_pos<N::kLane>(o + 16 * j));
      w[4 * j] = v.x;
      w[4 * j + 1] = v.y;
      w[4 * j + 2] = v.z;
      w[4 * j + 3] = v.w;
    }
  } else {
    const uint2 v = *reinterpret_cast<const uint2*>(ws + o);
    w[0] = v.x;
    w[1] = v.y;
  }
}

// the same bytes read from memory: vectors when the slice is contiguous
template <int BITS, int CB, typename T>
__device__ __forceinline__ void nw_words_global(uint32_t (&w)[Nw<BITS, CB, T>::kWords],
                                                const int8_t* qe, int np, int c0, int nc,
                                                int kk) {
  using N = Nw<BITS, CB, T>;
  if (np == CB) {
    const int8_t* p = qe + (long long)kk * CB;
    if constexpr (N::kLane >= 16) {
#pragma unroll
      for (int j = 0; j < N::kLane / 16; ++j) {
        const uint4 v = reinterpret_cast<const uint4*>(p)[j];
        w[4 * j] = v.x;
        w[4 * j + 1] = v.y;
        w[4 * j + 2] = v.z;
        w[4 * j + 3] = v.w;
      }
    } else {
      const uint2 v = *reinterpret_cast<const uint2*>(p);
      w[0] = v.x;
      w[1] = v.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < N::kWords; ++i) w[i] = 0u;
#pragma unroll
    for (int o = 0; o < N::kLane; ++o) {
      const int c = o % CB;
      if (c < nc)
        w[o / 4] |= (uint32_t)(unsigned char)qe[(long long)(kk + o / CB) * np + c0 + c]
                    << (8 * (o % 4));
    }
  }
}

// lane's x values of one 16-byte load as floats
__device__ __forceinline__ void nw_x(const uint4& v, float (&f)[8]) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
  }
}
__device__ __forceinline__ void nw_x(const uint4& v, float (&f)[4]) {
  f[0] = __uint_as_float(v.x);
  f[1] = __uint_as_float(v.y);
  f[2] = __uint_as_float(v.z);
  f[3] = __uint_as_float(v.w);
}

// One warp's sums over K range [kb, ke) for rows r0 .. r0 + kRows of x
// (rows past m read zeros): lane l takes the 16-byte vectors at kb + l *
// kVec + i * kStep, and `words(kk, w)` gives the weight bytes of rows kk ..
// kk + kVec.  acc[r][v]: v < CB is packed column v (int4: its low nibble),
// v >= CB int4's high nibble of packed column v - CB.
template <int BITS, int CB, typename T, typename Words>
__device__ __forceinline__ void nw_rows(float (&acc)[Nw<BITS, CB, T>::kRows][Nw<BITS, CB, T>::kVals],
                                        const T* xe, long long x_rs, int m, int r0, int kb,
                                        int ke, int lane, Words words) {
  using N = Nw<BITS, CB, T>;
#pragma unroll
  for (int r = 0; r < N::kRows; ++r)
#pragma unroll
    for (int v = 0; v < N::kVals; ++v) acc[r][v] = 0.f;
  auto load = [&](int kk, uint4 (&xv)[N::kRows]) {
#pragma unroll
    for (int r = 0; r < N::kRows; ++r) {
      xv[r] = make_uint4(0u, 0u, 0u, 0u);
      if (r0 + r < m) xv[r] = *reinterpret_cast<const uint4*>(xe + (r0 + r) * x_rs + kk);
    }
  };
  int kk = kb + lane * N::kVec;
  uint4 cur[N::kRows], nxt[N::kRows];
  if (kk < ke) load(kk, cur);
  for (; kk < ke; kk += N::kStep) {
    if (kk + N::kStep < ke) load(kk + N::kStep, nxt);
    uint32_t w[N::kWords];
    words(kk, w);
    if constexpr (BITS == 8) {
#pragma unroll
      for (int i = 0; i < N::kWords; ++i) w[i] ^= 0x80808080u;
    } else {
#pragma unroll
      for (int i = 0; i < N::kWords; ++i) w[i] ^= 0x88888888u;
    }
    float xf[N::kRows][N::kVec];
#pragma unroll
    for (int r = 0; r < N::kRows; ++r) nw_x(cur[r], xf[r]);
#pragma unroll
    for (int u = 0; u < N::kVec; ++u)
#pragma unroll
      for (int c = 0; c < CB; ++c) {
        const int o = u * CB + c;  // byte of the lane's chunk
        if constexpr (BITS == 8) {
          const float wv = __uint_as_float(__byte_perm(w[o / 4], 0x4B000000u, 0x7440 + o % 4)) -
                           8388736.f;
#pragma unroll
          for (int r = 0; r < N::kRows; ++r) acc[r][c] = fmaf(xf[r][u], wv, acc[r][c]);
        } else {
          const float lo = nib_f(w[o / 4], 8 * (o % 4));
          const float hi = nib_f(w[o / 4], 8 * (o % 4) + 4);
#pragma unroll
          for (int r = 0; r < N::kRows; ++r) {
            acc[r][c] = fmaf(xf[r][u], lo, acc[r][c]);
            acc[r][CB + c] = fmaf(xf[r][u], hi, acc[r][CB + c]);
          }
        }
      }
#pragma unroll
    for (int r = 0; r < N::kRows; ++r) cur[r] = nxt[r];
  }
}

// warp-reduce every sum; lane r * kVals + v returns row r's sum v
template <int ROWS, int VALS>
__device__ __forceinline__ float nw_reduce(float (&acc)[ROWS][VALS], int lane) {
  float mine = 0.f;
#pragma unroll
  for (int r = 0; r < ROWS; ++r)
#pragma unroll
    for (int v = 0; v < VALS; ++v) {
      const float s = warp_sum(acc[r][v]);
      if (lane == r * VALS + v) mine = s;
    }
  return mine;
}

// output column of a lane's sum v in the block's slice at c0, or -1
template <int BITS, int CB>
__device__ __forceinline__ int nw_col(int v, int c0, int nc, int np) {
  if (BITS == 4 && v >= CB) return v - CB < nc ? np + c0 + v - CB : -1;
  return v < nc ? c0 + v : -1;
}

// narrow_smem: blockIdx (packed-column slice, row blocks striding over the
// row groups, expert)
template <int BITS, int CB, typename T, typename S>
__global__ void __launch_bounds__(kNwThreads)
kn_narrow_smem_kernel(const T* __restrict__ x, const int8_t* __restrict__ q,
                      const S* __restrict__ scale, T* __restrict__ out, KnGeom g) {
  using N = Nw<BITS, CB, T>;
  extern __shared__ __align__(16) unsigned char ws[];
  const int np = packed_cols<BITS>(g.n);
  const int c0 = blockIdx.x * CB;
  const int nc = min(CB, np - c0);
  const int ex = blockIdx.z;
  const int8_t* qe = q + (long long)ex * g.k * np;
  nw_stage<BITS, CB, T>(ws, qe, g.k, np, c0, nc);
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const T* xe = x + ex * g.x_es;
  const int groups = (g.m + N::kRows - 1) / N::kRows;
  const int v = lane % N::kVals;
  const int col = lane < N::kRows * N::kVals ? nw_col<BITS, CB>(v, c0, nc, np) : -1;
  const float s = col >= 0 ? to_f(scale[(long long)ex * g.n + col]) : 0.f;
  for (int rg = blockIdx.y * kNwWarps + warp; rg < groups; rg += gridDim.y * kNwWarps) {
    const int r0 = rg * N::kRows;
    float acc[N::kRows][N::kVals];
    nw_rows<BITS, CB, T>(acc, xe, g.x_rs, g.m, r0, 0, g.k, lane,
                         [&](int kk, uint32_t (&w)[N::kWords]) {
                           nw_words_smem<BITS, CB, T>(w, ws, kk);
                         });
    const float sum = nw_reduce(acc, lane);
    const int row = r0 + lane / N::kVals;
    if (col >= 0 && row < g.m) out[ex * g.out_es + row * g.out_rs + col] = from_f<T>(sum * s);
  }
}

// narrow_split: blockIdx (packed-column slice, group of kNwSplitWarps K
// splits, expert); unscaled fp32 partials [e, splits, m, n] for
// kn_reduce_kernel
template <int BITS, int CB, typename T>
__global__ void __launch_bounds__(kNwSplitThreads)
kn_narrow_split_kernel(const T* __restrict__ x, const int8_t* __restrict__ q,
                       float* __restrict__ part, KnGeom g, int k_per_split, int splits) {
  using N = Nw<BITS, CB, T>;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int split = blockIdx.y * kNwSplitWarps + warp;
  if (split >= splits) return;
  const int np = packed_cols<BITS>(g.n);
  const int c0 = blockIdx.x * CB;
  const int nc = min(CB, np - c0);
  const int ex = blockIdx.z;
  const int8_t* qe = q + (long long)ex * g.k * np;
  const T* xe = x + ex * g.x_es;
  const int kb = split * k_per_split;
  const int ke = min(g.k, kb + k_per_split);
  const int col = lane < N::kRows * N::kVals
                      ? nw_col<BITS, CB>(lane % N::kVals, c0, nc, np) : -1;
  float* pe = part + ((long long)ex * splits + split) * g.m * g.n;
  for (int r0 = 0; r0 < g.m; r0 += N::kRows) {
    float acc[N::kRows][N::kVals];
    nw_rows<BITS, CB, T>(acc, xe, g.x_rs, g.m, r0, kb, ke, lane,
                         [&](int kk, uint32_t (&w)[N::kWords]) {
                           nw_words_global<BITS, CB, T>(w, qe, np, c0, nc, kk);
                         });
    const float sum = nw_reduce(acc, lane);
    const int row = r0 + lane / N::kVals;
    if (col >= 0 && row < g.m) pe[(long long)row * g.n + col] = sum;
  }
}

// narrow_smem for bf16 x, on tensor cores: a block owns 8 output columns
// (8 int8 or 4 int4 packed columns), their weights staged once as bf16
// (exact), transposed [8][K] in shared memory; units of 16 rows of x,
// one per block at a time, the block's 8 warps splitting K.  Every 32 k a
// lane loads 16 bytes (8 k) of its two rows and 16 bytes of its column's
// weights, and two mma.sync m16n8k16 consume them: the product sums over
// k in any order, so the fragments' k slots 2t, 2t+1, 2t+8, 2t+9 take k
// 8t .. 8t+3 of the first 16-byte half and 8t+4 .. 8t+7 in the second
// product, in x and in the weights alike.
constexpr int kNmThreads = 256;
constexpr int kNmWarps = kNmThreads / 32;
constexpr int kNmRows = 16;  // rows of x per unit

template <int BITS> struct Nm {
  static constexpr int kCols = BITS == 4 ? 4 : 8;  // packed columns per block
};

// weight row stride in bf16: K rounded up to 64, + 32, so the rows of a
// lane group's 16-byte reads sit 16 banks apart
__host__ __device__ constexpr int nm_ld(int k) { return (k + 63) / 64 * 64 + 32; }

__host__ __device__ constexpr int nm_smem(int k) {
  return 8 * nm_ld(k) * 2 + kNmWarps * 4 * 32 * 4;
}

// Stage a contiguous slice whose rows are NP bytes (NP <= CB, a power of
// two): 16-byte loads, four in flight a thread; each load holds 16 / NP
// rows, and each pair of rows k, k + 1 of a column becomes one 32-bit
// store of two bf16 values at wt[c][k] (int4: the high nibbles at
// wt[CB + c][k]).
template <int BITS, int CB, int NP>
__device__ void nm_stage_vec(__nv_bfloat16* wt, int ld, const int8_t* qe, int k) {
  static_assert(NP <= CB && 16 % NP == 0, "a row must fit the slice and a load");
  constexpr int kRows = 16 / NP;
  const int n16 = k * NP / 16;
  const uint4* src = reinterpret_cast<const uint4*>(qe);
  for (int i0 = threadIdx.x; i0 < n16; i0 += 4 * kNmThreads) {
    uint4 v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (i0 + u * kNmThreads < n16) v[u] = src[i0 + u * kNmThreads];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = i0 + u * kNmThreads;
      if (i >= n16) break;
      const uint32_t w[4] = {v[u].x, v[u].y, v[u].z, v[u].w};
#pragma unroll
      for (int pr = 0; pr < kRows / 2; ++pr)
#pragma unroll
        for (int c = 0; c < NP; ++c) {
          constexpr int kNp = NP;
          const int j0 = 2 * pr * kNp + c;  // the byte of row 2pr, then of row 2pr + 1
          const int j1 = j0 + kNp;
          const uint32_t pair = ((w[j0 / 4] >> (8 * (j0 % 4))) & 0xFFu) |
                                (((w[j1 / 4] >> (8 * (j1 % 4))) & 0xFFu) << 8);
          uint32_t* dst = reinterpret_cast<uint32_t*>(&wt[c * ld + i * kRows + 2 * pr]);
          if constexpr (BITS == 8) {
            const uint32_t x = pair ^ 0x8080u;
            *dst = pack_bf16(byte_f(x, 0), byte_f(x, 8));
          } else {
            const uint32_t x = pair ^ 0x8888u;
            *dst = pack_bf16(nib_f(x, 0), nib_f(x, 8));
            *reinterpret_cast<uint32_t*>(&wt[(CB + c) * ld + i * kRows + 2 * pr]) =
                pack_bf16(nib_f(x, 4), nib_f(x, 12));
          }
        }
    }
  }
}

__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];\n" ::"l"(p));
}

template <int BITS, typename S>
__global__ void __launch_bounds__(kNmThreads)
kn_narrow_mma_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ q,
                     const S* __restrict__ scale, __nv_bfloat16* __restrict__ out, KnGeom g) {
  constexpr int CB = Nm<BITS>::kCols;
  extern __shared__ __align__(16) unsigned char smem[];
  const int ld = nm_ld(g.k);
  __nv_bfloat16* wt = reinterpret_cast<__nv_bfloat16*>(smem);            // [8][ld]
  float* red = reinterpret_cast<float*>(smem + 8 * ld * 2);              // [warps][4][32]
  const int np = packed_cols<BITS>(g.n);
  const int c0 = blockIdx.x * CB;
  const int nc = min(CB, np - c0);
  const int ex = blockIdx.z;
  const int8_t* qe = q + (long long)ex * g.k * np;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int gr = lane >> 2;  // fragment row group: rows gr and gr + 8, column gr
  const int tg = lane & 3;   // thread in group: k 8tg .. 8tg + 7 of each 32
  const int chunk = (g.k + kNmWarps * 32 - 1) / (kNmWarps * 32) * 32;
  const int kb = warp * chunk;
  const int ke = min(g.k, kb + chunk);
  constexpr int kUnroll = 4;  // 32-k steps whose loads are in flight together
  // the first unit's first x loads head for L2 while the weights stage
  for (int j = 0; j < kUnroll; ++j) {
    const int kk = kb + 32 * j + 8 * tg;
    const long long ra = (long long)blockIdx.y * kNmRows + gr;
    if (kk < ke && ra < g.m) prefetch_l2(x + ex * g.x_es + ra * g.x_rs + kk);
    if (kk < ke && ra + 8 < g.m) prefetch_l2(x + ex * g.x_es + (ra + 8) * g.x_rs + kk);
  }

  // stage the slice as bf16 W^T [8][ld]: the value of packed column c at K
  // row k lands at wt[c][k] (int4: its high nibble at wt[CB + c][k]).  A
  // slice that is the whole weight (np <= CB) is contiguous and, for rows
  // of 1, 2, 4 or 8 bytes, takes 16-byte loads (nm_stage_vec).  Other
  // weights read their CB columns byte by byte.  Rows of wt past the
  // slice's columns stay unwritten: they meet only output columns that are
  // never stored.
  if (np <= CB && g.k * np % 16 == 0 && (np & (np - 1)) == 0) {
    switch (np) {
      case 1: nm_stage_vec<BITS, CB, 1>(wt, ld, qe, g.k); break;
      case 2: nm_stage_vec<BITS, CB, 2>(wt, ld, qe, g.k); break;
      case 4: nm_stage_vec<BITS, CB, 4>(wt, ld, qe, g.k); break;
      default:
        if constexpr (CB >= 8) nm_stage_vec<BITS, CB, 8>(wt, ld, qe, g.k);
        break;
    }
  } else {
#pragma unroll 4
    for (int o = threadIdx.x; o < g.k * CB; o += kNmThreads) {
      const int c = o % CB;
      if (c >= nc) continue;
      const uint32_t byte = (unsigned char)qe[(long long)(o / CB) * np + c0 + c];
      if constexpr (BITS == 8) {
        wt[c * ld + o / CB] = __float2bfloat16(byte_f(byte ^ 0x80u, 0));
      } else {
        wt[c * ld + o / CB] = __float2bfloat16(nib_f(byte ^ 0x88u, 0));
        wt[(CB + c) * ld + o / CB] = __float2bfloat16(nib_f(byte ^ 0x88u, 4));
      }
    }
  }
  __syncthreads();

  const __nv_bfloat16* xe = x + ex * g.x_es;
  const __nv_bfloat16* wrow = wt + gr * ld + 8 * tg;
  const int units = (g.m + kNmRows - 1) / kNmRows;
  // this thread's outputs in the epilogue: (row, column) pairs of a unit
  const int o_row = threadIdx.x / 8;  // 0 .. 31: rows 0 .. 15 used
  const int o_v = threadIdx.x % 8;    // the block's output column
  int col = -1;
  if (BITS == 8) col = o_v < nc ? c0 + o_v : -1;
  else col = o_v < CB ? (o_v < nc ? c0 + o_v : -1) : (o_v - CB < nc ? np + c0 + o_v - CB : -1);
  const float s = col >= 0 ? to_f(scale[(long long)ex * g.n + col]) : 0.f;

  for (int u = blockIdx.y; u < units; u += gridDim.y) {
    const int ra = u * kNmRows + gr;
    const int rb = ra + 8;
    const __nv_bfloat16* xa = xe + (long long)ra * g.x_rs + 8 * tg;
    const __nv_bfloat16* xb = xe + (long long)rb * g.x_rs + 8 * tg;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int k0 = kb; k0 < ke; k0 += 32 * kUnroll) {
      uint4 va[kUnroll], vb[kUnroll], vw[kUnroll];
#pragma unroll
      for (int j = 0; j < kUnroll; ++j) {
        const int kk = k0 + 32 * j;
        const bool ok = kk + 8 * tg < ke;  // whole 8-k groups: k is a multiple of 8
        va[j] = ok && ra < g.m ? *reinterpret_cast<const uint4*>(xa + kk) : make_uint4(0, 0, 0, 0);
        vb[j] = ok && rb < g.m ? *reinterpret_cast<const uint4*>(xb + kk) : make_uint4(0, 0, 0, 0);
        vw[j] = ok ? *reinterpret_cast<const uint4*>(wrow + kk) : make_uint4(0, 0, 0, 0);
      }
#pragma unroll
      for (int j = 0; j < kUnroll; ++j) {
        const uint32_t a0[4] = {va[j].x, vb[j].x, va[j].y, vb[j].y};
        const uint32_t a1[4] = {va[j].z, vb[j].z, va[j].w, vb[j].w};
        mma_bf16(acc, a0, vw[j].x, vw[j].y);
        mma_bf16(acc, a1, vw[j].z, vw[j].w);
      }
    }
    // the warps' K chunks meet in shared memory: acc[i] is row gr + 8 * (i
    // >> 1), column 2 * tg + (i & 1)
#pragma unroll
    for (int i = 0; i < 4; ++i) red[(warp * 4 + i) * 32 + lane] = acc[i];
    __syncthreads();
    const int row = u * kNmRows + o_row;
    if (o_row < kNmRows && col >= 0 && row < g.m) {
      const int i = (o_row >> 3) * 2 + (o_v & 1);
      const int ln = (o_row & 7) * 4 + (o_v >> 1);
      float sum = 0.f;
#pragma unroll
      for (int w = 0; w < kNmWarps; ++w) sum += red[(w * 4 + i) * 32 + ln];
      out[ex * g.out_es + row * g.out_rs + col] = __float2bfloat16(sum * s);
    }
    __syncthreads();  // red is read before the next unit writes it
  }
}

// ------------------------------------------- narrow rows, any shape (bytes)

constexpr int kNarrowThreads = 256;
constexpr int kNarrowBytes = 16;  // packed columns per block

// one block per (16 packed columns, row of x, expert); the threads split K
// and read each weight byte on its own, so no alignment is assumed.  ROWS
// rows of K a thread loads together (predicated, no branch between loads)
// so their latencies overlap: 4 for a few rows of x (a handful of blocks,
// latency-bound), 1 for many (fewer registers, more resident blocks).
template <int BITS, int ROWS, typename T, typename S>
__global__ void __launch_bounds__(kNarrowThreads)
kn_narrow_kernel(const T* __restrict__ x, const int8_t* __restrict__ q,
                 const S* __restrict__ scale, T* __restrict__ out, KnGeom g) {
  constexpr int kVals = BITS == 4 ? 2 : 1;  // values per byte
  const int np = packed_cols<BITS>(g.n);
  const int c0 = blockIdx.x * kNarrowBytes;
  const int nc = min(kNarrowBytes, np - c0);
  const int row = blockIdx.y;
  const int ex = blockIdx.z;
  const T* xr = x + ex * g.x_es + row * g.x_rs;
  const int8_t* qe = q + (long long)ex * g.k * np + c0;
  const int tid = threadIdx.x;

  float acc[kNarrowBytes * kVals];
#pragma unroll
  for (int j = 0; j < kNarrowBytes * kVals; ++j) acc[j] = 0.f;
  for (int kb = tid; kb < g.k; kb += ROWS * kNarrowThreads) {
    float xv[ROWS];
    int b[ROWS][kNarrowBytes];
#pragma unroll
    for (int u = 0; u < ROWS; ++u) {
      const int kk = kb + u * kNarrowThreads;
      const bool ok = kk < g.k;
      xv[u] = ok ? to_f(xr[kk]) : 0.f;
      const int8_t* qr = qe + (long long)kk * np;
#pragma unroll
      for (int j = 0; j < kNarrowBytes; ++j) b[u][j] = ok && j < nc ? qr[j] : 0;
    }
#pragma unroll
    for (int u = 0; u < ROWS; ++u)
#pragma unroll
      for (int j = 0; j < kNarrowBytes; ++j) {
        if constexpr (BITS == 4) {
          acc[j] = fmaf(xv[u], (float)((int)((unsigned)b[u][j] << 28) >> 28), acc[j]);
          acc[kNarrowBytes + j] =
              fmaf(xv[u], (float)(b[u][j] >> 4), acc[kNarrowBytes + j]);
        } else {
          acc[j] = fmaf(xv[u], (float)b[u][j], acc[j]);
        }
      }
  }

  __shared__ float red[kNarrowThreads / 32][kNarrowBytes * kVals];
  const int warp = tid >> 5;
  const int lane = tid & 31;
#pragma unroll
  for (int j = 0; j < kNarrowBytes * kVals; ++j) {
    const float v = warp_sum(acc[j]);
    if (lane == 0) red[warp][j] = v;
  }
  __syncthreads();
  if (tid < kNarrowBytes * kVals) {
    const int j = tid % kNarrowBytes;
    if (j >= nc) return;
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kNarrowThreads / 32; ++w) s += red[w][tid];
    const int col = tid < kNarrowBytes ? c0 + j : np + c0 + j;
    out[ex * g.out_es + row * g.out_rs + col] =
        from_f<T>(s * to_f(scale[(long long)ex * g.n + col]));
  }
}

// ------------------------------------------------------------- launch

// the card's streaming multiprocessors
int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  return sms;
}

// K splits of the weight-streaming body: as many as fill the card's
// resident block slots in one wave (a second, partial wave would double
// the time), each walking kGemvMinRows..kGemvMaxRows rows of K
template <int BITS>
int kn_gemv_splits(const KnGeom& g, int max_splits) {
  static int slots = 0;
  if (slots == 0) {
    int per_sm = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kn_gemv_kernel<BITS>,
                                                  kGemvThreads,
                                                  kGemvMT * kGemvMaxRows * sizeof(float));
    slots = sm_count() * (per_sm > 0 ? per_sm : 1);
  }
  const int np = packed_cols<BITS>(g.n);
  const int blocks = ((np + KnGemv<BITS>::kCols - 1) / KnGemv<BITS>::kCols) *
                     ((g.m + kGemvMT - 1) / kGemvMT) * g.e;
  int splits = slots / blocks;
  splits = min(splits, g.k / kGemvMinRows);
  splits = max(splits, (g.k + kGemvMaxRows - 1) / kGemvMaxRows);
  return max(1, min(splits, max_splits));
}

// cuTensorMapEncodeTiled from the driver the runtime already loaded (no
// link against libcuda)
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a 3-D map (dims and box innermost first; strides in bytes of dims 1, 2)
bool make_map_3d(CUtensorMap* map, CUtensorMapDataType type, const void* base,
                 const cuuint64_t (&dims)[3], const cuuint64_t (&strides)[2],
                 const cuuint32_t (&box)[3], CUtensorMapSwizzle swizzle) {
  EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return false;
  const cuuint32_t unit[3] = {1, 1, 1};
  return enc(map, type, 3, const_cast<void*>(base), dims, strides, box, unit,
             CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The tile body.  x rows are 16-byte aligned with strides of multiples of
// 8 elements (the tensor maps' rule; kn_launch's caller checks the base).
template <int BITS, typename S>
int kn_wgmma_launch(const __nv_bfloat16* x, const int8_t* q, const S* scale, __nv_bfloat16* out,
                    const KnGeom& g, cudaStream_t st) {
  using Tw = KnTw<BITS>;
  const int np = packed_cols<BITS>(g.n);
  if (g.x_rs % 8 || g.x_es % 8) return (int)cudaErrorInvalidValue;
  // x: [k, experts (or 1 when every expert reads the same rows), m]
  const bool x_experts = g.x_es != 0;
  CUtensorMap tx, tq;
  const cuuint64_t xd[3] = {(cuuint64_t)g.k, (cuuint64_t)(x_experts ? g.e : 1), (cuuint64_t)g.m};
  const cuuint64_t xs[2] = {(cuuint64_t)(x_experts ? g.x_es : g.k) * 2, (cuuint64_t)g.x_rs * 2};
  const cuuint32_t xb[3] = {kTwBK, 1, kTwBM};
  const cuuint64_t qd[3] = {(cuuint64_t)np, (cuuint64_t)g.k, (cuuint64_t)g.e};
  const cuuint64_t qs[2] = {(cuuint64_t)np, (cuuint64_t)g.k * np};
  const cuuint32_t qb[3] = {128, kTwBK, 1};
  if (!make_map_3d(&tx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, xd, xs, xb,
                   CU_TENSOR_MAP_SWIZZLE_128B) ||
      !make_map_3d(&tq, CU_TENSOR_MAP_DATA_TYPE_UINT8, q, qd, qs, qb, CU_TENSOR_MAP_SWIZZLE_128B))
    return (int)cudaErrorInvalidValue;
  static bool sized = false;
  if (!sized) {
    const cudaError_t err = cudaFuncSetAttribute(
        kn_wgmma_kernel<BITS, S>, cudaFuncAttributeMaxDynamicSharedMemorySize, Tw::kSmem);
    if (err != cudaSuccess) return (int)err;
    sized = true;
  }
  const long long tiles = (long long)g.e * ((g.m + kTwBM - 1) / kTwBM) *
                          ((np + Tw::kBytes - 1) / Tw::kBytes);
  if (tiles > 2147483647LL) return (int)cudaErrorInvalidValue;
  kn_wgmma_kernel<BITS, S><<<(unsigned)tiles, kTwThreads, Tw::kSmem, st>>>(tx, tq, scale, out, g,
                                                                           x_experts ? 1 : 0);
  return (int)cudaGetLastError();
}

// K splits of the tensor-core weight-streaming body: as many as fill the
// card's resident block slots in one wave, at most one cluster, each
// split walking at least kMinK rows of K
template <int BITS, int NT, typename S> int kn_gemv_mma_splits(const KnGeom& g, int max_splits) {
  static int per_sm = 0;
  if (per_sm == 0) {
    cudaFuncSetAttribute(kn_gemv_mma_kernel<BITS, NT, S>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, gm_smem<NT>());
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kn_gemv_mma_kernel<BITS, NT, S>,
                                                  kGmThreads, gm_smem<NT>());
    per_sm = per_sm > 0 ? per_sm : 1;
  }
  const int np = packed_cols<BITS>(g.n);
  const long long blocks = (long long)((np + KnGm<BITS>::kPanel - 1) / KnGm<BITS>::kPanel) * g.e;
  long long splits = (long long)sm_count() * per_sm / blocks;
  splits = min(splits, (long long)(g.k / KnGm<BITS>::kMinK));
  return (int)max(1LL, min(splits, (long long)min(kGmMaxSplits, max_splits)));
}

template <int BITS, int NT, typename S>
int kn_gemv_mma_launch(const __nv_bfloat16* x, const int8_t* q, const S* scale,
                       __nv_bfloat16* out, const KnGeom& g, int max_splits, cudaStream_t st) {
  if (g.x_rs % 4 || g.x_es % 4 || g.e > 65535) return (int)cudaErrorInvalidValue;
  const int splits = kn_gemv_mma_splits<BITS, NT, S>(g, max_splits);
  const int per = (g.k + splits - 1) / splits;
  const int k_per_split = (per + 15) / 16 * 16;
  const int np = packed_cols<BITS>(g.n);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((np + KnGm<BITS>::kPanel - 1) / KnGm<BITS>::kPanel, splits, g.e);
  cfg.blockDim = dim3(kGmThreads, 1, 1);
  cfg.dynamicSmemBytes = gm_smem<NT>();
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = splits;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err =
      cudaLaunchKernelEx(&cfg, kn_gemv_mma_kernel<BITS, NT, S>, x, q, scale, out, g, k_per_split);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// True when the rows take a narrow body (see the top of this file).
template <int BITS> bool kn_narrow(const KnGeom& g) {
  return packed_cols<BITS>(g.n) % 16 != 0 || g.k % 32 != 0;
}

enum NarrowKind { kNarrowBytesBody, kNarrowSplitBody, kNarrowSmemBody };

// Which narrow body a call takes: the vector bodies need x rows that start
// on 16 bytes and K in whole 16-byte loads (K, and the x strides, multiples
// of 8 elements), and narrow_smem a slice that fits shared memory.
template <int BITS> NarrowKind kn_narrow_kind(const KnGeom& g) {
  if (g.k % 8 != 0 || g.x_rs % 8 != 0 || g.x_es % 8 != 0) return kNarrowBytesBody;
  if (g.m <= kGemvMaxM) return kNarrowSplitBody;
  // 16 bytes of staged weights per row of K: 16 packed bytes (fp32 x) or
  // 8 bf16 values (bf16 x)
  if ((long long)g.k * 16 > kNwMaxSlice) return kNarrowBytesBody;
  return kNarrowSmemBody;
}

// The name of the body a 2-D call of this shape takes.
template <int BITS> const char* kn_body_name(int m, int k, int n) {
  const KnGeom g{m, k, n, 1, 0, k, 0, n};
  if (m <= 0 || k <= 0 || n <= 0 || (BITS == 4 && n % 2)) return "invalid";
  if (!kn_narrow<BITS>(g)) return m <= kGemvMaxM ? "gemv" : "tile";
  switch (kn_narrow_kind<BITS>(g)) {
    case kNarrowSplitBody: return "narrow_split";
    case kNarrowSmemBody: return "narrow_smem";
    default: return "narrow_bytes";
  }
}

template <int BITS, int CB, typename T, typename S>
int narrow_smem_launch(const T* x, const int8_t* q, const S* scale, T* out, const KnGeom& g,
                       cudaStream_t st) {
  using N = Nw<BITS, CB, T>;
  static int per_sm = 0;
  if (per_sm == 0) {
    cudaError_t err = cudaFuncSetAttribute(kn_narrow_smem_kernel<BITS, CB, T, S>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           kNwMaxSlice);
    if (err != cudaSuccess) return (int)err;
    // residency by registers alone; shared memory is counted per call below
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kn_narrow_smem_kernel<BITS, CB, T, S>, kNwThreads, 0);
    if (err != cudaSuccess) return (int)err;
    per_sm = per_sm > 0 ? per_sm : 1;
  }
  const int smem = g.k * CB;
  const int by_smem = 227 * 1024 / (smem + 1024);
  const int cols = (packed_cols<BITS>(g.n) + CB - 1) / CB;
  // one wave of blocks, their warps striding over the row groups
  const long long slots = (long long)sm_count() * min(per_sm, by_smem > 0 ? by_smem : 1);
  const long long wanted = ((g.m + N::kRows - 1) / N::kRows + kNwWarps - 1) / kNwWarps;
  const long long fit = slots / ((long long)cols * g.e);
  const int rows_blocks = (int)max(1LL, min(wanted, fit));
  if (g.e > 65535) return (int)cudaErrorInvalidValue;
  kn_narrow_smem_kernel<BITS, CB, T, S><<<dim3(cols, rows_blocks, g.e), kNwThreads, smem, st>>>(
      x, q, scale, out, g);
  return (int)cudaGetLastError();
}

template <int BITS, typename S>
int narrow_mma_launch(const __nv_bfloat16* x, const int8_t* q, const S* scale,
                      __nv_bfloat16* out, const KnGeom& g, cudaStream_t st) {
  static int per_sm = 0;
  if (per_sm == 0) {
    cudaError_t err = cudaFuncSetAttribute(kn_narrow_mma_kernel<BITS, S>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           nm_smem(kNwMaxSlice / 16));
    if (err != cudaSuccess) return (int)err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kn_narrow_mma_kernel<BITS, S>,
                                                        kNmThreads, 0);
    if (err != cudaSuccess) return (int)err;
    per_sm = per_sm > 0 ? per_sm : 1;
  }
  const int smem = nm_smem(g.k);
  const int by_smem = 227 * 1024 / (smem + 1024);
  const int cols = (packed_cols<BITS>(g.n) + Nm<BITS>::kCols - 1) / Nm<BITS>::kCols;
  // every unit of 16 rows resident at once where the card holds them
  const long long slots = (long long)sm_count() * min(per_sm, by_smem > 0 ? by_smem : 1);
  const long long units = (g.m + kNmRows - 1) / kNmRows;
  const long long fit = slots / ((long long)cols * g.e);
  const int rows_blocks = (int)max(1LL, min(units, fit));
  if (g.e > 65535) return (int)cudaErrorInvalidValue;
  kn_narrow_mma_kernel<BITS, S><<<dim3(cols, rows_blocks, g.e), kNmThreads, smem, st>>>(
      x, q, scale, out, g);
  return (int)cudaGetLastError();
}

template <int BITS, int CB, typename T, typename S>
int narrow_split_launch(const T* x, const int8_t* q, const S* scale, T* out, float* scratch,
                        const KnGeom& g, int max_splits, cudaStream_t st) {
  using N = Nw<BITS, CB, T>;
  // one warp per split, each a few warp steps of K at most
  const int splits = max(1, min(max_splits, (g.k + N::kStep - 1) / N::kStep));
  const int per = (g.k + splits - 1) / splits;
  const int k_per_split = (per + N::kVec - 1) / N::kVec * N::kVec;
  const int cols = (packed_cols<BITS>(g.n) + CB - 1) / CB;
  const dim3 grid(cols, (splits + kNwSplitWarps - 1) / kNwSplitWarps, g.e);
  if (grid.y > 65535 || grid.z > 65535) return (int)cudaErrorInvalidValue;
  kn_narrow_split_kernel<BITS, CB, T><<<grid, kNwSplitThreads, 0, st>>>(x, q, scratch, g,
                                                                         k_per_split, splits);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long total = (long long)g.e * g.m * g.n;
  kn_reduce_kernel<T, S><<<(unsigned)((total + 255) / 256), 256, 0, st>>>(scratch, scale, out,
                                                                          g, splits);
  return (int)cudaGetLastError();
}

template <int BITS, int CB, typename T, typename S>
int narrow_launch(NarrowKind kind, const void* x, const void* q, const void* scale, void* out,
                  float* scratch, const KnGeom& g, int max_splits, cudaStream_t st) {
  if (kind == kNarrowSplitBody)
    return narrow_split_launch<BITS, CB, T, S>((const T*)x, (const int8_t*)q, (const S*)scale,
                                               (T*)out, scratch, g, max_splits, st);
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    return narrow_mma_launch<BITS, S>((const T*)x, (const int8_t*)q, (const S*)scale, (T*)out,
                                      g, st);
  } else {
    return narrow_smem_launch<BITS, CB, T, S>((const T*)x, (const int8_t*)q, (const S*)scale,
                                              (T*)out, g, st);
  }
}

// scratch: for m <= 16 (fp32 x in the aligned body, and the narrow_split
// body), e * max_splits * m * n floats
template <int BITS, typename T, typename S>
int kn_launch(const void* x, const void* q, const void* scale, void* out, float* scratch,
              const KnGeom& g, int max_splits, cudaStream_t st) {
  const int np = packed_cols<BITS>(g.n);
  if (kn_narrow<BITS>(g)) {
    const NarrowKind kind = kn_narrow_kind<BITS>(g);
    switch (kind == kNarrowBytesBody ? 0 : narrow_cb(np)) {
      case 2: return narrow_launch<BITS, 2, T, S>(kind, x, q, scale, out, scratch, g, max_splits, st);
      case 4: return narrow_launch<BITS, 4, T, S>(kind, x, q, scale, out, scratch, g, max_splits, st);
      case 8: return narrow_launch<BITS, 8, T, S>(kind, x, q, scale, out, scratch, g, max_splits, st);
      case 16: return narrow_launch<BITS, 16, T, S>(kind, x, q, scale, out, scratch, g, max_splits, st);
      default: break;
    }
    if (g.m > 65535 || g.e > 65535) return (int)cudaErrorInvalidValue;
    const dim3 grid((np + kNarrowBytes - 1) / kNarrowBytes, g.m, g.e);
    if (g.m <= kGemvMaxM)
      kn_narrow_kernel<BITS, 4, T, S><<<grid, kNarrowThreads, 0, st>>>(
          (const T*)x, (const int8_t*)q, (const S*)scale, (T*)out, g);
    else
      kn_narrow_kernel<BITS, 1, T, S><<<grid, kNarrowThreads, 0, st>>>(
          (const T*)x, (const int8_t*)q, (const S*)scale, (T*)out, g);
    return (int)cudaGetLastError();
  }
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    const auto* xb = (const __nv_bfloat16*)x;
    const auto* qb = (const int8_t*)q;
    const auto* sb = (const S*)scale;
    auto* ob = (__nv_bfloat16*)out;
    if (g.m <= 8) return kn_gemv_mma_launch<BITS, 1, S>(xb, qb, sb, ob, g, max_splits, st);
    if (g.m <= kGemvMaxM)
      return kn_gemv_mma_launch<BITS, 2, S>(xb, qb, sb, ob, g, max_splits, st);
    return kn_wgmma_launch<BITS, S>(xb, qb, sb, ob, g, st);
  } else {
    if (g.m <= kGemvMaxM) {
      const int k_splits = kn_gemv_splits<BITS>(g, max_splits);
      const int k_per_split = (g.k + k_splits - 1) / k_splits;
      const int m_blocks = (g.m + kGemvMT - 1) / kGemvMT;
      if (k_per_split > kGemvMaxRows || (long long)m_blocks * g.e > 65535)
        return (int)cudaErrorInvalidValue;
      const size_t smem = kGemvMT * k_per_split * sizeof(float);
      const dim3 grid((np + KnGemv<BITS>::kCols - 1) / KnGemv<BITS>::kCols, k_splits,
                      m_blocks * g.e);
      kn_gemv_kernel<BITS><<<grid, kGemvThreads, smem, st>>>(
          (const float*)x, (const int8_t*)q, scratch, g, k_per_split, m_blocks);
      cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
      const long long total = (long long)g.e * g.m * g.n;
      kn_reduce_kernel<T, S><<<(unsigned)((total + 255) / 256), 256, 0, st>>>(
          scratch, (const S*)scale, (T*)out, g, k_splits);
      return (int)cudaGetLastError();
    }
    if (g.e > 65535) return (int)cudaErrorInvalidValue;
    constexpr int kBytes = BITS == 4 ? kTfBN / 2 : kTfBN;
    const dim3 grid((np + kBytes - 1) / kBytes, (g.m + kTfBM - 1) / kTfBM, g.e);
    if (grid.y > 65535) return (int)cudaErrorInvalidValue;
    kn_fma_kernel<BITS, S><<<grid, 256, 0, st>>>((const float*)x, (const int8_t*)q,
                                                 (const S*)scale, (float*)out, g);
  }
  return (int)cudaGetLastError();
}

// x_dtype / scale_dtype: 0 = float32, 1 = bfloat16 (bfloat16 x takes
// bfloat16 scales)
template <int BITS>
int kn_dispatch(const void* x, const void* q, const void* scale, void* out, void* scratch,
                const KnGeom& g, int max_splits, int x_dtype, int scale_dtype, void* stream) {
  if (g.m <= 0 || g.k <= 0 || g.n <= 0 || g.e <= 0 || (BITS == 4 && g.n % 2) ||
      max_splits < 1 || max_splits > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  float* sc = (float*)scratch;
  if (x_dtype == 1 && scale_dtype == 1)
    return kn_launch<BITS, __nv_bfloat16, __nv_bfloat16>(x, q, scale, out, sc, g, max_splits, st);
  if (x_dtype == 0 && scale_dtype == 1)
    return kn_launch<BITS, float, __nv_bfloat16>(x, q, scale, out, sc, g, max_splits, st);
  if (x_dtype == 0 && scale_dtype == 0)
    return kn_launch<BITS, float, float>(x, q, scale, out, sc, g, max_splits, st);
  return (int)cudaErrorInvalidValue;
}

// ------------------------------------------------------------------- nk
//
// y = x @ (q * s)^T for a table q [v, k] int8 or [v, k/2] int4 packed along
// K (byte j = k j low, k j + K/2 high), scale [v].  Two bodies, chosen by
// nk_body (quant_matmul_nk{4,8}_body names them): "mma" for bf16 x with
// rows of a multiple of 16 bytes, "fma" for fp32 x (exact fp32, the
// cross-device checks), for int8 rows of K not a multiple of 16, and for x
// too wide for the mma body's shared memory.

// ------------------------------------------------------ nk, fp32 FMA

constexpr int kHeadMT = 8;        // rows of x per block
constexpr int kHeadThreads = 256;
constexpr int kHeadWarps = kHeadThreads / 32;
constexpr int kHeadUnroll = 16;   // 4-byte loads a lane issues together (a 2 KB row)

// One warp per vocab row at a time (rows strided over a grid of one
// wave), the block's rows of x (up to 8) staged once in shared memory as
// fp32
template <int BITS, typename T, typename S>
__global__ void __launch_bounds__(kHeadThreads)
nk_kernel(const T* __restrict__ x, const int8_t* __restrict__ q,
          const S* __restrict__ scale, T* __restrict__ out, int m, int k, int v) {
  extern __shared__ __align__(16) float xs[];  // [mc][k], fp32 once for every row
  const int kb = packed_cols<BITS>(k);         // bytes per table row
  const int m0 = blockIdx.y * kHeadMT;
  const int mc = min(kHeadMT, m - m0);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;

  // rows m0 .. m0+mc of x are contiguous
  const T* src = x + (long long)m0 * k;
  for (int i = tid; i < mc * k; i += kHeadThreads) xs[i] = to_f(src[i]);
  __syncthreads();

  // a lane takes 4-byte words 128 bytes apart, so a warp reads 128
  // contiguous bytes and its float4 reads of x are 16 bytes apart (no
  // bank conflicts)
  for (int row = blockIdx.x * kHeadWarps + warp; row < v; row += gridDim.x * kHeadWarps) {
    const int8_t* qrow = q + (long long)row * kb;
    float acc[kHeadMT];
#pragma unroll
    for (int mm = 0; mm < kHeadMT; ++mm) acc[mm] = 0.f;
    for (int jb = lane * 4; jb < kb; jb += 128 * kHeadUnroll) {
      uint32_t p[kHeadUnroll];
#pragma unroll
      for (int u = 0; u < kHeadUnroll; ++u) {
        const int j0 = jb + 128 * u;
        p[u] = j0 < kb ? *reinterpret_cast<const uint32_t*>(qrow + j0) : 0u;
      }
#pragma unroll
      for (int u = 0; u < kHeadUnroll; ++u) {
        const int j0 = jb + 128 * u;
        if (j0 >= kb) break;
        float lo[4], hi[4];  // lo meets x[m, j0 + i]; int4's hi x[m, K/2 + j0 + i]
        if constexpr (BITS == 4) {
          const uint32_t w8 = p[u] ^ 0x88888888u;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            lo[i] = nib_f(w8, 8 * i);
            hi[i] = nib_f(w8, 8 * i + 4);
          }
        } else {
          const uint32_t w8 = p[u] ^ 0x80808080u;
#pragma unroll
          for (int i = 0; i < 4; ++i) lo[i] = byte_f(w8, 8 * i);
        }
#pragma unroll
        for (int mm = 0; mm < kHeadMT; ++mm) {
          if (mm >= mc) break;
          const float4 a = *reinterpret_cast<const float4*>(xs + mm * k + j0);
          float s = acc[mm];
          s = fmaf(a.x, lo[0], s);
          s = fmaf(a.y, lo[1], s);
          s = fmaf(a.z, lo[2], s);
          s = fmaf(a.w, lo[3], s);
          if constexpr (BITS == 4) {
            const float4 b = *reinterpret_cast<const float4*>(xs + mm * k + kb + j0);
            s = fmaf(b.x, hi[0], s);
            s = fmaf(b.y, hi[1], s);
            s = fmaf(b.z, hi[2], s);
            s = fmaf(b.w, hi[3], s);
          }
          acc[mm] = s;
        }
      }
    }
#pragma unroll
    for (int mm = 0; mm < kHeadMT; ++mm) acc[mm] = warp_sum(acc[mm]);
    if (lane == 0) {
      const float s = to_f(scale[row]);
#pragma unroll
      for (int mm = 0; mm < kHeadMT; ++mm) {
        if (mm >= mc) break;
        out[(long long)(m0 + mm) * v + row] = from_f<T>(acc[mm] * s);
      }
    }
  }
}

template <int BITS, typename T, typename S>
int nk_launch(const void* x, const void* q, const void* scale, void* out, int m, int k,
              int v, cudaStream_t st) {
  const size_t smem = (size_t)(m < kHeadMT ? m : kHeadMT) * k * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(nk_kernel<BITS, T, S>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  // one wave: as many blocks as the card holds at once with this much
  // shared memory, warps striding over the vocab rows (once per step)
  int per_sm = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, nk_kernel<BITS, T, S>, kHeadThreads,
                                                smem);
  const int slots = sm_count() * (per_sm > 0 ? per_sm : 1);
  const int rows_blocks = (v + kHeadWarps - 1) / kHeadWarps;
  const dim3 grid(rows_blocks < slots ? rows_blocks : slots, (m + kHeadMT - 1) / kHeadMT);
  nk_kernel<BITS, T, S><<<grid, kHeadThreads, smem, st>>>(
      (const T*)x, (const int8_t*)q, (const S*)scale, (T*)out, m, k, v);
  return (int)cudaGetLastError();
}

// ---------------------------------------------- nk, bf16 x: tensor cores
//
// The head is a weight stream: M is 4 at decode and 1-2 at prefill, 2 M
// flops per weight, so its floor is the table's bytes over 3.35 TB/s.  The
// table rows are the A operand of mma.sync m16n8k16 (16 vocab rows x 16 k)
// and the rows of x the B operand (8 rows a tile, zeros past M).  A lane
// (group gq = lane / 4, tq = lane % 4) reads 16 bytes of each of its rows
// gq and gq + 8 of a 16-row tile at byte j = 64 s + 16 tq of step s.  The
// product sums over k in any order, so one k permutation serves both
// operands: word i of the lane's vector (bytes j + 4i .. j + 4i + 3) fills
// fragment slots 2tq, 2tq + 1 (its bytes 0, 1) and 2tq + 8, 2tq + 9 (bytes
// 2, 3) of product i, whose B fragments are then x[gq, j + 4i .. j + 4i +
// 3]: one 8-byte word of x in its natural order.  int4: the low nibbles of
// those bytes meet x[:, :K/2] and the high nibbles x[:, K/2:], so a vector
// feeds 8 products, 4 per half.  Bytes become bf16 by one byte_perm and
// s8x2_bf16 / s4x2_bf16, not by integer-to-float instructions.
//
// x is staged once per block in shared memory as bf16 by cp.async, behind
// the table's first batch: the row (int8) or each half (int4) padded with
// zeros to whole batches, rows 16 bytes longer than a multiple of 128 so
// the 16-byte reads of a quarter warp fall in distinct banks.  The
// table's loads do not allocate in L1.
//
// Each warp streams whole tiles (all of K), tiles strided over the warps
// of one resident wave: 2000 tiles at V = 32000 fill the ~2100 warps the
// card holds, 8016 at V = 128256 take four rounds.  No K split: a lane's
// sums are its outputs, scaled in fp32 (a tile's scales are loaded with
// its first batch) and stored, with no reduction and no barrier after the
// staging.  A warp reads a batch of 4 steps at a time, 256 contiguous
// bytes of each of its 16 rows, into one of two register buffers taken in
// turn (the loop unrolled by two): the next batch's loads, across the end
// of a tile, are in flight while the current one is converted and
// multiplied, and no register copy waits on a pending load (a copy from
// the next buffer into the current one did, and left one batch in
// flight).  4-8 KB in flight per warp, 64-128 KB per SM.  One launch, no
// atomics: the same inputs give the same bits.

constexpr int kNhThreads = 256;
constexpr int kNhWarps = kNhThreads / 32;
constexpr int kNhBatch = 4;              // steps of 64 bytes a warp loads together
constexpr int kNhRun = 64 * kNhBatch;    // bytes of a row in a batch
constexpr int kNhPad = 8;                // bf16 values after each staged row of x

// a staged run of x: kb values padded to whole batches
__host__ __device__ __forceinline__ int nh_seg(int kb) {
  return (kb + kNhRun - 1) / kNhRun * kNhRun;
}
// a staged row of x: the row (int8) or its two halves (int4), padded
template <int BITS> __host__ __device__ __forceinline__ int nh_ld(int kb) {
  return (BITS == 4 ? 2 : 1) * nh_seg(kb) + kNhPad;
}
// min(m, 8 NT) staged rows of x (NT = 2 tiles of x rows above m = 8)
template <int BITS> size_t nh_smem(int m, int kb) {
  return (size_t)min(m, m > 8 ? 16 : 8) * nh_ld<BITS>(kb) * 2;
}

// a 16-byte load of the table, which is read once: it leaves L1 alone
__device__ __forceinline__ uint4 ld_stream(const int8_t* p) {
  uint4 r;
  asm volatile("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w)
               : "l"(p));
  return r;
}

// 16 bytes from global to shared memory, or 16 zeros when !ok
__device__ __forceinline__ void stage16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(ok ? 16 : 0)
               : "memory");
}

// The A fragment of product i from word i of rows gq (w0) and gq + 8 (w1):
// bytes 0, 1 in registers 0 and 1, bytes 2, 3 in 2 and 3; int4 half h
// takes the low (0) or high (1) nibbles.
template <int BITS>
__device__ __forceinline__ void nh_frag(uint32_t w0, uint32_t w1, int h, uint32_t (&a)[4]) {
  // bytes b0 b2 b1 b3: b0 and b1 at bits 0 and 16, b2 and b3 at 8 and 24
  const uint32_t t0 = __byte_perm(w0, 0, 0x3120);
  const uint32_t t1 = __byte_perm(w1, 0, 0x3120);
  if constexpr (BITS == 8) {
    a[0] = s8x2_bf16(t0);
    a[1] = s8x2_bf16(t1);
    a[2] = s8x2_bf16(t0 >> 8);
    a[3] = s8x2_bf16(t1 >> 8);
  } else {
    const int sh = 4 * h;
    a[0] = s4x2_bf16(t0 >> sh);
    a[1] = s4x2_bf16(t1 >> sh);
    a[2] = s4x2_bf16(t0 >> (8 + sh));
    a[3] = s4x2_bf16(t1 >> (8 + sh));
  }
}

// blockIdx (8 warps' first tiles, tile of 8 NT rows of x)
template <int BITS, int NT>
__global__ void __launch_bounds__(kNhThreads, NT == 1 ? 2 : 1)
nk_mma_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ q,
              const __nv_bfloat16* __restrict__ scale, __nv_bfloat16* __restrict__ out,
              int m, int k, int v) {
  constexpr int kSegs = BITS == 4 ? 2 : 1;  // runs of x a packed byte meets
  extern __shared__ __align__(16) uint4 nh_xs[];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(nh_xs);
  const int kb = packed_cols<BITS>(k);  // bytes per table row
  const int seg = nh_seg(kb);
  const int ld = nh_ld<BITS>(kb);
  const int m0 = blockIdx.y * 8 * NT;
  const int mc = min(8 * NT, m - m0);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int gq = lane >> 2;
  const int tq = lane & 3;
  const int tiles = (v + 15) / 16;
  const int stride = gridDim.x * kNhWarps;
  const int batches = seg / kNhRun;

  // a warp's batches in order, position p: tile first + (p / batches)
  // stride, batch p % batches
  const int first = blockIdx.x * kNhWarps + (tid >> 5);
  const int total = first < tiles ? ((tiles - 1 - first) / stride + 1) * batches : 0;
  auto load_at = [&](int p, uint4 (&w)[kNhBatch][2]) {
    const int tile = first + p / batches * stride;
#pragma unroll
    for (int u = 0; u < kNhBatch; ++u) {
      const int j = kNhRun * (p % batches) + 64 * u + 16 * tq;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = 16 * tile + 8 * hh + gq;
        w[u][hh] = make_uint4(0u, 0u, 0u, 0u);
        if (row < v && j < kb) w[u][hh] = ld_stream(q + (long long)row * kb + j);
      }
    }
  };

  // the first batch is in flight while x is staged: run h of staged row r
  // is x[m0 + r][h kb .. h kb + kb), zeros to seg
  uint4 wa[kNhBatch][2], wb[kNhBatch][2];
  if (total > 0) load_at(0, wa);
  const int chunks = seg / 8;  // 16-byte chunks of a run
  for (int i = tid; i < mc * kSegs * chunks; i += kNhThreads) {
    const int r = i / (kSegs * chunks);
    const int h = i / chunks % kSegs;
    const int c = 8 * (i % chunks);
    stage16(xs + r * ld + h * seg + c, x + (long long)(m0 + r) * k + h * kb + (c < kb ? c : 0),
            c < kb);
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  float acc[NT][4];
  float s0 = 0.f, s1 = 0.f;
  // the batch at position p, held in w: a tile's first batch loads its
  // scales and clears the sums, its last scales and stores them
  auto step = [&](int p, const uint4 (&w)[kNhBatch][2]) {
    const int bt = p % batches;
    const int r0 = 16 * (first + p / batches * stride) + gq;
    if (bt == 0) {
      s0 = r0 < v ? __bfloat162float(scale[r0]) : 0.f;
      s1 = r0 + 8 < v ? __bfloat162float(scale[r0 + 8]) : 0.f;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[nt][i] = 0.f;
    }
#pragma unroll
    for (int u = 0; u < kNhBatch; ++u) {
      const int j = kNhRun * bt + 64 * u + 16 * tq;
      const uint32_t w0[4] = {w[u][0].x, w[u][0].y, w[u][0].z, w[u][0].w};
      const uint32_t w1[4] = {w[u][1].x, w[u][1].y, w[u][1].z, w[u][1].w};
#pragma unroll
      for (int h = 0; h < kSegs; ++h) {
        // B fragments of the step's 4 products: x[row, j .. j + 16) of run h
        uint32_t b[NT][8];
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const int r = 8 * nt + gq;
          uint4 lo = make_uint4(0u, 0u, 0u, 0u), hi = lo;
          if (r < mc) {
            const uint4* px = reinterpret_cast<const uint4*>(xs + r * ld + h * seg + j);
            lo = px[0];
            hi = px[1];
          }
          const uint32_t words[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
          for (int e = 0; e < 8; ++e) b[nt][e] = words[e];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          uint32_t a[4];
          nh_frag<BITS>(w0[i], w1[i], h, a);
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) mma_bf16(acc[nt], a, b[nt][2 * i], b[nt][2 * i + 1]);
        }
      }
    }
    if (bt == batches - 1) {
      // register i: vocab row r0 + 8 (i / 2), x row 8 nt + 2 tq + i % 2
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int row = r0 + 8 * (i >> 1);
          const int mm = 8 * nt + 2 * tq + (i & 1);
          if (row < v && mm < mc)
            out[(long long)(m0 + mm) * v + row] =
                __float2bfloat16(acc[nt][i] * ((i >> 1) ? s1 : s0));
        }
    }
  };

  // two buffers taken in turn, so no register copy waits for a load: the
  // next batch is in flight while this one is multiplied, and the one
  // after goes in flight before the next is waited for
  for (int p = 0; p < total; p += 2) {
    if (p + 1 < total) load_at(p + 1, wb);
    step(p, wa);
    if (p + 1 == total) break;
    if (p + 2 < total) load_at(p + 2, wa);
    step(p + 1, wb);
  }
}

// the shared memory a block may opt in to on this card
int smem_optin() {
  static int bytes = 0;
  if (bytes == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  return bytes;
}

template <int BITS, int NT>
int nk_mma_launch(const void* x, const void* q, const void* scale, void* out, int m, int k,
                  int v, cudaStream_t st) {
  const size_t smem = nh_smem<BITS>(m, packed_cols<BITS>(k));
  static bool sized = false;
  if (!sized) {
    const cudaError_t err = cudaFuncSetAttribute(
        nk_mma_kernel<BITS, NT>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_optin());
    if (err != cudaSuccess) return (int)err;
    sized = true;
  }
  // one wave: as many blocks as the card holds at once with this much
  // shared memory, shared by the tiles of x rows, each warp a tile of the
  // table at a time
  int per_sm = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, nk_mma_kernel<BITS, NT>, kNhThreads,
                                                smem);
  const int row_tiles = (m + 8 * NT - 1) / (8 * NT);
  const int slots = max(1, sm_count() * max(per_sm, 1) / row_tiles);
  const int blocks = ((v + 15) / 16 + kNhWarps - 1) / kNhWarps;
  const dim3 grid(min(blocks, slots), row_tiles);
  nk_mma_kernel<BITS, NT><<<grid, kNhThreads, smem, st>>>(
      (const __nv_bfloat16*)x, (const int8_t*)q, (const __nv_bfloat16*)scale,
      (__nv_bfloat16*)out, m, k, v);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------- nk dispatch

enum NkBody { kNkInvalid, kNkMma, kNkFma };

// The body a call takes: "mma" for bf16 x over rows of a multiple of 16
// bytes when its staged x fits a block's shared memory, else "fma" when
// the FMA body's fp32 rows of x fit.  k: a multiple of 32 (int4: x's
// halves and the packed words align) or 4 (int8); x_dtype 0 = float32,
// 1 = bfloat16.
template <int BITS> NkBody nk_body(int m, int k, int v, int x_dtype) {
  if (m <= 0 || k <= 0 || v <= 0 || k % (BITS == 4 ? 32 : 4) || x_dtype < 0 || x_dtype > 1)
    return kNkInvalid;
  const size_t room = (size_t)smem_optin();
  const int kb = packed_cols<BITS>(k);
  if (x_dtype == 1 && kb % 16 == 0 && (m + 15) / 16 <= 65535 && nh_smem<BITS>(m, kb) <= room)
    return kNkMma;
  if ((m + kHeadMT - 1) / kHeadMT <= 65535 && (size_t)min(m, kHeadMT) * k * 4 <= room)
    return kNkFma;
  return kNkInvalid;
}

template <int BITS> const char* nk_body_name(int m, int k, int v, int x_dtype) {
  switch (nk_body<BITS>(m, k, v, x_dtype)) {
    case kNkMma: return "mma";
    case kNkFma: return "fma";
    default: return "invalid";
  }
}

// dtypes as kn_dispatch (bfloat16 x takes bfloat16 scales)
template <int BITS>
int nk_dispatch(const void* x, const void* q, const void* scale, void* out, int m, int k,
                int v, int x_dtype, int scale_dtype, void* stream) {
  if (scale_dtype < 0 || scale_dtype > 1 || (x_dtype == 1 && scale_dtype == 0))
    return (int)cudaErrorInvalidValue;
  const NkBody body = nk_body<BITS>(m, k, v, x_dtype);
  cudaStream_t st = (cudaStream_t)stream;
  if (body == kNkMma)
    return m > 8 ? nk_mma_launch<BITS, 2>(x, q, scale, out, m, k, v, st)
                 : nk_mma_launch<BITS, 1>(x, q, scale, out, m, k, v, st);
  if (body != kNkFma) return (int)cudaErrorInvalidValue;
  if (x_dtype == 1)
    return nk_launch<BITS, __nv_bfloat16, __nv_bfloat16>(x, q, scale, out, m, k, v, st);
  if (scale_dtype == 1)
    return nk_launch<BITS, float, __nv_bfloat16>(x, q, scale, out, m, k, v, st);
  return nk_launch<BITS, float, float>(x, q, scale, out, m, k, v, st);
}

}  // namespace
