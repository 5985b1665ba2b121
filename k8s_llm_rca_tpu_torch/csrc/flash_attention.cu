// Causal flash-attention prefill for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces: k8s_llm_rca_tpu/ops/flash_attention.py::flash_attention
// (Pallas kernel _flash_kernel).  Queries at absolute positions
// q_offset[b] + i attend to keys k_pos <= q_pos with k_pos < seq_lens[b];
// online softmax over key tiles; GQA by kv-head h / (n_heads / n_kv).
//
// Layouts (the JAX package's, read through strides, never transposed into
// a copy; the last axis must be contiguous):
//   q   [B, S_q, n_heads, d]      k, v [B, S_k, n_kv, d]
//   seq_lens, q_offset [B] int32  out  [B, S_q, n_heads, d] (dense)
//
// What bounds it on the H100: operations.  At the main path's shapes
// (S = 2560, 32 heads, d = 128) the causal products are ~54 GFLOP against
// ~50 MB of q/k/v/out, far above the ~295 flops per byte where the tensor
// cores, not the memory, become the limit.  Only wgmma reaches the tensor
// cores' full rate, and only if its operands are in shared memory before
// it asks for them.
//
// bf16 body (the serving path), FlashAttention-3 style:
// - Work tiles of (128 queries, head, batch row) over a persistent grid of
//   one block per SM (288 threads: two consumer warpgroups of 64 query
//   rows each and one producer warp), heaviest tiles first (the last query
//   tiles, with the most causal keys), so the short tiles fill the end.
//   The producer runs ahead across tiles: the next tile's q and first K/V
//   stages load while the current tile's last products and epilogue run.
// - Loads: the producer warp's one thread issues TMA copies
//   (cp.async.bulk.tensor, 4-D tensor maps over the strided [B, S, H, d]
//   views, built on the host per launch through the driver entry point, so
//   no -lcuda) into a ring of 2 K/V stages of 128 keys, with full and empty
//   mbarriers per stage; a tile's 128 q rows land once.  Rows are 128-byte
//   swizzled (64-byte for d = 32); d = 128 is two 64-column boxes.  Rows
//   past S_q or S_k arrive as zeros; key tiles wholly past the causal edge
//   of the tile's last row or past seq_len are never loaded.
// - Products: S = q k^T by wgmma m64n128k16 with both operands in shared
//   memory (k [keys, d] is K-major as stored); O += P v by wgmma m64n{d}k16
//   with P from registers (the S accumulator's layout is the A-register
//   layout once rounded to bf16) and v as the MN-major B operand (the
//   transpose bit), so nothing is transposed or staged by threads.
// - The two warpgroups take turns issuing their S products (named
//   barriers), so one's softmax (ex2 on the special-function units) runs
//   while the other's product holds the tensor cores.
// - Softmax: fp32 running max and sum per row, scores scaled in fp32 (never
//   q rounded in bf16) with 1/sqrt(d) and log2(e) folded into one FMA
//   before ex2; masked scores are -1e30 with the Pallas shift rule (a row
//   with nothing visible shifts by 0, keeps l = 0 and outputs 0).  Only
//   tiles that cross the causal edge or seq_len are masked element-wise.
//
// fp32 body (exact fp32, no TF32: the reference and cross-device checks):
// one block of 128 threads per (64-query tile, head, batch row); the q tile
// is staged transposed and pre-scaled, each key tile transposed (k) and
// row-major (v); each thread owns a 4 x 8 block of the score tile and 4
// rows x d/8 columns of the output, with plain fp32 FMA.
//
// Not yet: overlapping one tile's softmax with the next tile's S product
// inside a warpgroup (FA3's intra-warpgroup pipelining: a second S
// accumulator, which needs setmaxnreg and a full producer warpgroup to
// fit the registers), and a TMA store of the output tile.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // keys per staged tile
constexpr int kLd = kBQ + 4;   // row stride of the transposed tiles: float4-aligned
constexpr float kNegInf = -1e30f;

static_assert(kBQ == kBK, "the transposed tiles share one row stride");

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// reductions over the 8 lanes that own one score row (lanes 8g .. 8g+7)
__device__ __forceinline__ float row_max8(float v) {
  for (int o = 1; o < 8; o <<= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float row_sum8(float v) {
  for (int o = 1; o < 8; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (D * kLd        // q tile, transposed
                          + D * kLd      // k tile, transposed
                          + kBK * D      // v tile
                          + kBK * kLd);  // probabilities, transposed
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const int* __restrict__ seq_lens,
                     const int* __restrict__ q_offset, T* __restrict__ out, int s_q,
                     int s_k, int n_heads, int n_kv, long long q_sb, long long q_ss,
                     long long q_sh, long long k_sb, long long k_ss, long long k_sh,
                     long long v_sb, long long v_ss, long long v_sh, long long o_sb,
                     long long o_ss, long long o_sh, float scale) {
  static_assert(D == 32 || D == 64 || D == 128, "head_dim must be 32, 64 or 128");
  constexpr int kCols = D / 8;  // output columns per thread

  extern __shared__ __align__(16) float smem[];
  float* qt = smem;            // [D][kLd]
  float* kt = qt + D * kLd;    // [D][kLd]
  float* vs = kt + D * kLd;    // [kBK][D]
  float* pt = vs + kBK * D;    // [kBK][kLd]

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (n_heads / n_kv);
  const int tid = threadIdx.x;
  const int rg = tid >> 3;  // rows rg*4 .. rg*4+3 of the tile
  const int cg = tid & 7;   // score columns cg*8 .. cg*8+7

  const int off = q_offset[b];
  const int kv_len = min(seq_lens[b], s_k);
  const T* q_bh = q + b * q_sb + h * q_sh;
  const T* k_bh = k + b * k_sb + kvh * k_sh;
  const T* v_bh = v + b * v_sb + kvh * v_sh;

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D;
    const int e = i % D;
    float x = 0.f;
    if (q0 + r < s_q) x = to_f(q_bh[(long long)(q0 + r) * q_ss + e]) * scale;
    qt[e * kLd + r] = x;
  }

  float m[4], l[4], acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[i][j] = 0.f;
  }

  // keys any row of this tile may see: up to the causal edge of its last
  // real row, and below the valid length
  const int last_pos = off + min(q0 + kBQ, s_q) - 1;
  const int k_end = min(kv_len, last_pos + 1);
  const int n_tiles = k_end > 0 ? (k_end + kBK - 1) / kBK : 0;

  for (int kb = 0; kb < n_tiles; ++kb) {
    const int k0 = kb * kBK;
    __syncthreads();  // the previous tile's readers are done
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int c = i / D;
      const int e = i % D;
      float kx = 0.f, vx = 0.f;
      if (k0 + c < kv_len) {
        kx = to_f(k_bh[(long long)(k0 + c) * k_ss + e]);
        vx = to_f(v_bh[(long long)(k0 + c) * v_ss + e]);
      }
      kt[e * kLd + c] = kx;
      vs[c * D + e] = vx;
    }
    __syncthreads();

    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int e = 0; e < D; ++e) {
      const float4 a = *reinterpret_cast<const float4*>(&qt[e * kLd + rg * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&kt[e * kLd + cg * 8]);
      const float4 b1 = *reinterpret_cast<const float4*>(&kt[e * kLd + cg * 8 + 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int q_pos = off + q0 + rg * 4 + i;
      float row_max = kNegInf;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int k_pos = k0 + cg * 8 + j;
        if (!(q_pos >= k_pos && k_pos < kv_len)) s[i][j] = kNegInf;
        row_max = fmaxf(row_max, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max8(row_max));
      const float shift = m_new <= kNegInf / 2 ? 0.f : m_new;
      const float corr = expf(m[i] - shift);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float p = expf(s[i][j] - shift);
        psum += p;
        pt[(cg * 8 + j) * kLd + rg * 4 + i] = p;
      }
      l[i] = l[i] * corr + row_sum8(psum);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < kCols; ++j) acc[i][j] *= corr;
    }
    __syncthreads();

    for (int c = 0; c < kBK; ++c) {
      const float4 p4 = *reinterpret_cast<const float4*>(&pt[c * kLd + rg * 4]);
      const float pv[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
      for (int j = 0; j < D / 32; ++j) {
        const float4 v4 = *reinterpret_cast<const float4*>(&vs[c * D + j * 32 + cg * 4]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][j * 4 + 0] = fmaf(pv[i], v4.x, acc[i][j * 4 + 0]);
          acc[i][j * 4 + 1] = fmaf(pv[i], v4.y, acc[i][j * 4 + 1]);
          acc[i][j * 4 + 2] = fmaf(pv[i], v4.z, acc[i][j * 4 + 2]);
          acc[i][j * 4 + 3] = fmaf(pv[i], v4.w, acc[i][j * 4 + 3]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + rg * 4 + i;
    if (r >= s_q) continue;
    const float inv = 1.f / (l[i] == 0.f ? 1.f : l[i]);
    T* o_row = out + b * o_sb + (long long)r * o_ss + h * o_sh;
#pragma unroll
    for (int j = 0; j < D / 32; ++j)
#pragma unroll
      for (int t = 0; t < 4; ++t) o_row[j * 32 + cg * 4 + t] = from_f<T>(acc[i][j * 4 + t] * inv);
  }
}

// ---------------------------------------------------------------- bf16 body

constexpr int kWgRows = 64;                  // query rows per consumer warpgroup
constexpr int kTmaBM = 2 * kWgRows;          // query rows per block
constexpr int kTmaBN = 128;                  // keys per stage
constexpr int kStages = 2;                   // K/V ring depth
constexpr int kConsumerThreads = 2 * 128;    // two warpgroups
constexpr int kTmaThreads = kConsumerThreads + 32;  // + the producer warp

// Shared-memory geometry: every tile is stored as boxes of kBoxCols columns,
// one row of a box being the swizzle span (kSw bytes).
template <int D> struct FlashTma {
  static constexpr int kSw = D >= 64 ? 128 : 64;
  static constexpr int kBoxCols = kSw / 2;
  static constexpr int kBoxes = D / kBoxCols;
  static constexpr int kQBytes = kTmaBM * D * 2;
  static constexpr int kKvBytes = kTmaBN * D * 2;   // one of k or v, one stage
  // layout type of a wgmma descriptor: 1 = 128-byte swizzle, 2 = 64-byte
  static constexpr uint64_t kLayout = kSw == 128 ? 1 : 2;
  // 1 KB of slack to align the tiles to the swizzle pattern, then q, the k
  // and v stages and the mbarriers
  static constexpr int kSmem = 1024 + kQBytes + 2 * kStages * kKvBytes + 64;
};

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

// one box of a 4-D tensor map (coordinates innermost first) into shared
// memory, completing `bytes` on the barrier
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory matrix descriptor: start address, leading and stride
// byte offsets (16-byte units) and the swizzle layout
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

// D[64 x 128] (+)= A[64 x 16] . B[16 x 128], A and B from shared memory, both K-major
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\nwgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D[64 x 32] += A[64 x 16] . B[16 x 32], A from registers, B MN-major in shared memory
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\nwgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64 x 64] += A[64 x 16] . B[16 x 64], A from registers, B MN-major in shared memory
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\nwgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64 x 128] += A[64 x 16] . B[16 x 128], A from registers, B MN-major in shared memory
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
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
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}


template <int D>
__device__ __forceinline__ void wgmma_pv(float (&o)[D / 2], const uint32_t (&a)[4], uint64_t db) {
  if constexpr (D == 32) {
    wgmma_rs_n32(o, a, db);
  } else if constexpr (D == 64) {
    wgmma_rs_n64(o, a, db);
  } else {
    wgmma_rs_n128(o, a, db);
  }
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// reductions over the 4 lanes that own one score row (lanes 4g .. 4g+3)
__device__ __forceinline__ float row_max4(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float row_sum4(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(kConsumerThreads) : "memory");
}
__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "n"(kConsumerThreads) : "memory");
}

// One tile of work: 128 queries of one head and batch row.  Tiles run in
// the order of i, the heaviest (the last query tiles, with the most causal
// keys) first.
struct FlashTile {
  int q0, h, b, off, kv_len, n_kv_tiles;
};

__device__ __forceinline__ FlashTile flash_tile(int i, int n_heads, int batch, int n_qt,
                                                int s_q, int s_k, const int* seq_lens,
                                                const int* q_offset) {
  FlashTile t;
  const int per = n_heads * batch;
  t.q0 = (n_qt - 1 - i / per) * kTmaBM;
  t.h = i % per % n_heads;
  t.b = i % per / n_heads;
  t.off = q_offset[t.b];
  t.kv_len = min(seq_lens[t.b], s_k);
  // keys any row may see: up to the causal edge of the tile's last real
  // row, and below the valid length
  const int k_end = min(t.kv_len, t.off + min(t.q0 + kTmaBM, s_q));
  t.n_kv_tiles = k_end > 0 ? (k_end + kTmaBN - 1) / kTmaBN : 0;
  return t;
}

// The r-th tile of this block: rounds of gridDim.x tiles, walked forward
// in even rounds and backward in odd ones, so with the tiles heaviest
// first every block's sum of heavy and light tiles comes out about even.
__device__ __forceinline__ int snake_tile(int r) {
  return r * gridDim.x + (r & 1 ? gridDim.x - 1 - blockIdx.x : blockIdx.x);
}

// A persistent grid: each block walks its tiles by snake_tile.  The
// producer runs ahead across tiles (the next tile's q lands once both
// warpgroups have issued their last S product of the current one), so one
// tile's softmax tail and epilogue overlap the next tile's loads.  The two
// warpgroups take turns issuing their S products (named barriers 1 and 2,
// warpgroup 0 first), so one's softmax runs while the other's product
// holds the tensor cores.  Accumulator register i of a thread holds row
// g + 8 * ((i >> 1) & 1) of its warp's 16 and column 8 * (i >> 2) + 2 * tq
// + (i & 1).
template <int D>
__global__ void __launch_bounds__(kTmaThreads, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                   const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v, const int* __restrict__ seq_lens,
                   const int* __restrict__ q_offset, __nv_bfloat16* __restrict__ out, int batch,
                   int s_q, int s_k, int n_heads, int n_kv, long long o_sb, long long o_ss,
                   long long o_sh, float scale_log2) {
  using F = FlashTma<D>;
  static_assert(D == 32 || D == 64 || D == 128, "head_dim must be 32, 64 or 128");
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // the swizzle repeats every 8 rows: tiles start on a 1024-byte boundary
  unsigned char* base = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  unsigned char* q_s = base;
  unsigned char* k_s = q_s + F::kQBytes;                  // [kStages][kKvBytes]
  unsigned char* v_s = k_s + kStages * F::kKvBytes;       // [kStages][kKvBytes]
  uint64_t* full = reinterpret_cast<uint64_t*>(v_s + kStages * F::kKvBytes);
  uint64_t* empty = full + kStages;
  uint64_t* q_full = empty + kStages;
  uint64_t* q_empty = q_full + 1;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n_qt = (s_q + kTmaBM - 1) / kTmaBM;
  const int n_work = n_qt * n_heads * batch;
  const int group = n_heads / n_kv;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int st = 0; st < kStages; ++st) {
      mbar_init(&full[st], 1);
      mbar_init(&empty[st], kConsumerThreads);
    }
    mbar_init(q_full, 1);
    mbar_init(q_empty, kConsumerThreads);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumerThreads / 32) {
    // producer: per tile q, then its K/V tiles through the ring
    if (lane == 0) {
      int it = 0, jq = 0;
      for (int rd = 0, i = snake_tile(0); i < n_work; i = snake_tile(++rd)) {
        const FlashTile tl = flash_tile(i, n_heads, batch, n_qt, s_q, s_k, seq_lens, q_offset);
        if (tl.n_kv_tiles == 0) continue;
        mbar_wait(q_empty, (jq++ & 1) ^ 1);
        mbar_expect_tx(q_full, F::kQBytes);
#pragma unroll
        for (int bx = 0; bx < F::kBoxes; ++bx)
          tma_load_4d(q_s + bx * kTmaBM * F::kSw, &tm_q, q_full, bx * F::kBoxCols, tl.h, tl.q0,
                      tl.b);
        for (int t = 0; t < tl.n_kv_tiles; ++t, ++it) {
          const int st = it % kStages;
          mbar_wait(&empty[st], ((it / kStages) & 1) ^ 1);
          mbar_expect_tx(&full[st], 2 * F::kKvBytes);
#pragma unroll
          for (int bx = 0; bx < F::kBoxes; ++bx) {
            tma_load_4d(k_s + st * F::kKvBytes + bx * kTmaBN * F::kSw, &tm_k, &full[st],
                        bx * F::kBoxCols, tl.h / group, t * kTmaBN, tl.b);
            tma_load_4d(v_s + st * F::kKvBytes + bx * kTmaBN * F::kSw, &tm_v, &full[st],
                        bx * F::kBoxCols, tl.h / group, t * kTmaBN, tl.b);
          }
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg owns query rows wg * 64 .. + 63 of each tile
  const int wg = warp >> 2;
  const int g = lane >> 2;  // fragment row group
  const int tq = lane & 3;  // thread in group
  const uint32_t q_addr = smem_u32(q_s) + wg * kWgRows * F::kSw;
  if (wg == 1) named_arrive(1);  // warpgroup 0 issues first
  int it = 0, jq = 0;
  for (int rd = 0, i = snake_tile(0); i < n_work; i = snake_tile(++rd)) {
    const FlashTile tl = flash_tile(i, n_heads, batch, n_qt, s_q, s_k, seq_lens, q_offset);
    const int row0 = tl.q0 + wg * kWgRows + (warp & 3) * 16 + g;  // and row0 + 8
    const int wg_first_pos = tl.off + tl.q0 + wg * kWgRows;

    float o[D / 2];
#pragma unroll
    for (int i2 = 0; i2 < D / 2; ++i2) o[i2] = 0.f;
    float m[2] = {kNegInf, kNegInf};
    float l[2] = {0.f, 0.f};  // this thread's share of the row sums
    if (tl.n_kv_tiles > 0) mbar_wait(q_full, jq++ & 1);

    for (int t = 0; t < tl.n_kv_tiles; ++t, ++it) {
      const int st = it % kStages;
      const int k0 = t * kTmaBN;
      const uint32_t k_addr = smem_u32(k_s + st * F::kKvBytes);
      const uint32_t v_addr = smem_u32(v_s + st * F::kKvBytes);
      mbar_wait(&full[st], (it / kStages) & 1);

      // S = q k^T over d in 16-column steps; a step's 32 bytes sit inside
      // one swizzled box row (the first step overwrites the accumulator)
      float s[kTmaBN / 2];
      named_sync(1 + wg);  // this warpgroup's turn
      fence_regs(s);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int bx = kk * 32 / F::kSw;
        const int in = kk * 32 % F::kSw;
        const uint64_t da =
            smem_desc(q_addr + bx * kTmaBM * F::kSw + in, 16, 8 * F::kSw, F::kLayout);
        const uint64_t db =
            smem_desc(k_addr + bx * kTmaBN * F::kSw + in, 16, 8 * F::kSw, F::kLayout);
        wgmma_ss_n128(s, da, db, kk > 0);
      }
      wgmma_commit();
      named_arrive(2 - wg);  // the other warpgroup's turn
      wgmma_wait_all();
      fence_regs(s);
      if (t == tl.n_kv_tiles - 1) mbar_arrive(q_empty);  // q read for the last time

      // mask the tiles that cross the causal edge or seq_len
      if (k0 + kTmaBN - 1 > wg_first_pos || k0 + kTmaBN > tl.kv_len) {
#pragma unroll
        for (int i2 = 0; i2 < kTmaBN / 2; ++i2) {
          const int k_pos = k0 + 8 * (i2 >> 2) + 2 * tq + (i2 & 1);
          const int q_pos = tl.off + row0 + 8 * ((i2 >> 1) & 1);
          if (!(k_pos <= q_pos && k_pos < tl.kv_len)) s[i2] = kNegInf;
        }
      }

      // online softmax in the log2 domain; the scale applies to the fp32
      // scores inside the exponent's FMA
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int i2 = 0; i2 < kTmaBN / 2; ++i2)
        mx[(i2 >> 1) & 1] = fmaxf(mx[(i2 >> 1) & 1], s[i2]);
      float shift[2], corr[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float m_new = fmaxf(m[r], row_max4(mx[r]));
        shift[r] = m_new <= kNegInf / 2 ? 0.f : m_new * scale_log2;
        corr[r] = ex2(m[r] * scale_log2 - shift[r]);
        m[r] = m_new;
      }
      float ps[2] = {0.f, 0.f};
#pragma unroll
      for (int i2 = 0; i2 < kTmaBN / 2; ++i2) {
        const int r = (i2 >> 1) & 1;
        s[i2] = ex2(fmaf(s[i2], scale_log2, -shift[r]));
        ps[r] += s[i2];
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + ps[r];
#pragma unroll
      for (int i2 = 0; i2 < D / 2; ++i2) o[i2] *= corr[(i2 >> 1) & 1];

      // P as bf16 A fragments: keys 16kk .. 16kk+15 are n-tiles 2kk, 2kk+1
      uint32_t pa[kTmaBN / 16][4];
#pragma unroll
      for (int kk = 0; kk < kTmaBN / 16; ++kk) {
        pa[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
        pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
        pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
        pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
      }

      // O += P v: 16 keys a step, v MN-major (its 64-column boxes LBO apart)
      fence_regs(o);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kTmaBN / 16; ++kk) {
        const uint64_t db = smem_desc(v_addr + kk * 16 * F::kSw, kTmaBN * F::kSw,
                                      8 * F::kSw, F::kLayout);
        wgmma_pv<D>(o, pa[kk], db);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(o);
      mbar_arrive(&empty[st]);  // this thread no longer reads the stage
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      const float lt = row_sum4(l[r]);
      if (row >= s_q) continue;
      const float inv = 1.f / (lt == 0.f ? 1.f : lt);
      __nv_bfloat16* o_row = out + tl.b * o_sb + (long long)row * o_ss + tl.h * o_sh;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        *reinterpret_cast<uint32_t*>(&o_row[8 * j + 2 * tq]) =
            pack_bf16(o[4 * j + 2 * r] * inv, o[4 * j + 2 * r + 1] * inv);
      }
    }
  }
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const int* seq_lens;
  const int* q_offset;
  void* out;
  int batch, s_q, s_k, n_heads, n_kv;
  long long st[12];
  cudaStream_t stream;
};

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

// a [batch, rows, heads, D] bf16 view (element strides sb, ss, sh; the
// last axis contiguous) as a 4-D tensor map, boxes of one head's
// kBoxCols x box_rows
template <int D>
bool make_map(CUtensorMap* map, const void* base, int heads, int rows, int batch,
              long long sh, long long ss, long long sb, int box_rows) {
  using F = FlashTma<D>;
  EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return false;
  // a stride of an axis of size 1 is never followed: give it a valid value
  if (heads == 1) sh = D;
  if (rows == 1) ss = sh * heads;
  if (batch == 1) sb = ss * rows;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)heads, (cuuint64_t)rows,
                              (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)sh * 2, (cuuint64_t)ss * 2, (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {(cuuint32_t)F::kBoxCols, 1, (cuuint32_t)box_rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides,
             box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
             F::kSw == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  return sms;
}

template <int D>
int launch_wgmma(const Args& a) {
  CUtensorMap tq, tk, tv;
  if (!make_map<D>(&tq, a.q, a.n_heads, a.s_q, a.batch, a.st[2], a.st[1], a.st[0], kTmaBM) ||
      !make_map<D>(&tk, a.k, a.n_kv, a.s_k, a.batch, a.st[5], a.st[4], a.st[3], kTmaBN) ||
      !make_map<D>(&tv, a.v, a.n_kv, a.s_k, a.batch, a.st[8], a.st[7], a.st[6], kTmaBN))
    return (int)cudaErrorInvalidValue;
  static bool sized = false;
  if (!sized) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_wgmma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, FlashTma<D>::kSmem);
    if (err != cudaSuccess) return (int)err;
    sized = true;
  }
  // one block per SM, striding over the tiles
  const long long work = (long long)((a.s_q + kTmaBM - 1) / kTmaBM) * a.n_heads * a.batch;
  if (work > 2147483647LL) return (int)cudaErrorInvalidValue;
  const int grid = (int)(work < sm_count() ? work : sm_count());
  flash_wgmma_kernel<D><<<grid, kTmaThreads, FlashTma<D>::kSmem, a.stream>>>(
      tq, tk, tv, a.seq_lens, a.q_offset, (__nv_bfloat16*)a.out, a.batch, a.s_q, a.s_k,
      a.n_heads, a.n_kv, a.st[9], a.st[10], a.st[11], 1.4426950408889634f / sqrtf((float)D));
  return (int)cudaGetLastError();
}

template <int D>
int launch_fma(const Args& a) {
  const dim3 grid((a.s_q + kBQ - 1) / kBQ, a.n_heads, a.batch);
  constexpr size_t smem = smem_bytes<D>();
  const cudaError_t err = cudaFuncSetAttribute(
      flash_fma_kernel<float, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  flash_fma_kernel<float, D><<<grid, kThreads, smem, a.stream>>>(
      (const float*)a.q, (const float*)a.k, (const float*)a.v, a.seq_lens, a.q_offset,
      (float*)a.out, a.s_q, a.s_k, a.n_heads, a.n_kv, a.st[0], a.st[1], a.st[2], a.st[3],
      a.st[4], a.st[5], a.st[6], a.st[7], a.st[8], a.st[9], a.st[10], a.st[11],
      1.0f / sqrtf((float)D));
  return (int)cudaGetLastError();
}

template <int D>
int launch(const Args& a, int dtype) {
  if (dtype == 0) return launch_fma<D>(a);
  if (dtype == 1) return launch_wgmma<D>(a);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Strides are in elements: q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss,
// v_sh, o_sb, o_ss, o_sh (batch, sequence, head); the head_dim axis is
// contiguous.  For bfloat16 every stride is a multiple of 8 and every base
// 16-byte aligned (the tensor maps' rule); k and v rows past seq_len are
// read and masked, so they must be finite, as for the plain version.
// dtype: 0 = float32, 1 = bfloat16.  Returns cudaGetLastError() after the
// launch (or the error of the tensor maps or the attribute call).
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v,
                                      const int* seq_lens, const int* q_offset,
                                      void* out, int batch, int s_q, int s_k,
                                      int n_heads, int n_kv, int head_dim,
                                      long long q_sb, long long q_ss, long long q_sh,
                                      long long k_sb, long long k_ss, long long k_sh,
                                      long long v_sb, long long v_ss, long long v_sh,
                                      long long o_sb, long long o_ss, long long o_sh,
                                      int dtype, void* stream) {
  if (batch <= 0 || s_q <= 0 || s_k <= 0 || n_kv <= 0 || n_heads % n_kv != 0 ||
      batch > 65535 || n_heads > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const Args a{q, k, v, seq_lens, q_offset, out, batch, s_q, s_k, n_heads, n_kv,
               {q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_ss, o_sh},
               (cudaStream_t)stream};
  switch (head_dim) {
    case 32: return launch<32>(a, dtype);
    case 64: return launch<64>(a, dtype);
    case 128: return launch<128>(a, dtype);
    default: return (int)cudaErrorInvalidValue;
  }
}
