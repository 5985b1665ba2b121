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
// cores, not the memory, become the limit.
//
// Design: one block of 128 threads (4 warps) per (64-query tile, head,
// batch row); key tiles of 64 wholly past the causal edge of the tile's
// last row or past seq_len are never loaded.  Masked scores are NEG_INF =
// -1e30 with the Pallas shift rule (a row with nothing unmasked shifts by 0
// and keeps l = 0, and its output is 0, not NaN).  Two bodies:
//
// - bf16 (the serving path): tensor cores through mma.sync m16n8k16 (bf16
//   in, fp32 accumulate), FlashAttention-2 style.  q, k and v tiles are
//   staged row-major in shared memory (rows padded by 8 elements, so the
//   fragment loads hit 32 distinct banks); each warp owns 16 query rows,
//   keeps its q fragments in registers for the whole key sweep, and holds
//   its 16 x 64 score tile and 16 x d output accumulator in registers.  The
//   score accumulator is rounded to bf16 in place as the A operand of the
//   P.V product (its fragment layout is the A layout), and v's B operand
//   comes from ldmatrix.trans.  Running max and sum are fp32; a row's 4
//   owners are 4 neighbouring lanes and reduce by shuffles.
// - fp32 (exact fp32, no TF32: the reference and cross-device checks): the
//   q tile is staged transposed and pre-scaled, each key tile transposed (k)
//   and row-major (v); each thread owns a 4 x 8 block of the score tile and
//   4 rows x d/8 columns of the output, with plain fp32 FMA.
//
// Not yet: cp.async / TMA double buffering of the key tiles and wgmma,
// which the card needs to approach its tensor-core peak.

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

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// four 8x8 bf16 matrices from shared memory, transposed (v's B operand)
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  const uint32_t addr = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ uint32_t lds32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
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

template <int D>
constexpr size_t mma_smem_bytes() {
  return sizeof(__nv_bfloat16) * 3 * kBQ * (D + 8);  // q, k, v tiles
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v, const int* __restrict__ seq_lens,
                 const int* __restrict__ q_offset, __nv_bfloat16* __restrict__ out,
                 int s_q, int s_k, int n_heads, int n_kv, long long q_sb, long long q_ss,
                 long long q_sh, long long k_sb, long long k_ss, long long k_sh,
                 long long v_sb, long long v_ss, long long v_sh, long long o_sb,
                 long long o_ss, long long o_sh, float scale) {
  static_assert(D % 16 == 0 && (D / 8) % 2 == 0 && D <= 128, "head_dim");
  static_assert(kBQ == 16 * (kThreads / 32) && kBK == 64, "16 rows per warp");
  constexpr int kLdb = D + 8;   // bf16 row stride of the staged tiles
  constexpr int kVecRow = D / 8;  // 16-byte vectors per row

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);   // [kBQ][kLdb]
  __nv_bfloat16* ks = qs + kBQ * kLdb;                              // [kBK][kLdb]
  __nv_bfloat16* vs = ks + kBK * kLdb;                              // [kBK][kLdb]

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (n_heads / n_kv);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;    // fragment row group
  const int tg = lane & 3;    // thread in group

  const int off = q_offset[b];
  const int kv_len = min(seq_lens[b], s_k);
  const __nv_bfloat16* q_bh = q + b * q_sb + h * q_sh;
  const __nv_bfloat16* k_bh = k + b * k_sb + kvh * k_sh;
  const __nv_bfloat16* v_bh = v + b * v_sb + kvh * v_sh;

  for (int i = tid; i < kBQ * kVecRow; i += kThreads) {
    const int r = i / kVecRow;
    const int c = (i % kVecRow) * 8;
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (q0 + r < s_q) x = *reinterpret_cast<const uint4*>(q_bh + (long long)(q0 + r) * q_ss + c);
    *reinterpret_cast<uint4*>(&qs[r * kLdb + c]) = x;
  }
  __syncthreads();

  // this warp's 16 query rows as A fragments, for the whole key sweep
  const int r0 = warp * 16 + g;
  uint32_t qa[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int c = kk * 16 + tg * 2;
    qa[kk][0] = lds32(&qs[r0 * kLdb + c]);
    qa[kk][1] = lds32(&qs[(r0 + 8) * kLdb + c]);
    qa[kk][2] = lds32(&qs[r0 * kLdb + c + 8]);
    qa[kk][3] = lds32(&qs[(r0 + 8) * kLdb + c + 8]);
  }

  float o[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};
  const int q_pos[2] = {off + q0 + r0, off + q0 + r0 + 8};

  const int last_pos = off + min(q0 + kBQ, s_q) - 1;
  const int k_end = min(kv_len, last_pos + 1);
  const int n_tiles = k_end > 0 ? (k_end + kBK - 1) / kBK : 0;

  for (int kb = 0; kb < n_tiles; ++kb) {
    const int k0 = kb * kBK;
    __syncthreads();  // the previous tile's readers are done
    for (int i = tid; i < kBK * kVecRow; i += kThreads) {
      const int r = i / kVecRow;
      const int c = (i % kVecRow) * 8;
      uint4 kx = make_uint4(0u, 0u, 0u, 0u), vx = kx;
      if (k0 + r < kv_len) {
        kx = *reinterpret_cast<const uint4*>(k_bh + (long long)(k0 + r) * k_ss + c);
        vx = *reinterpret_cast<const uint4*>(v_bh + (long long)(k0 + r) * v_ss + c);
      }
      *reinterpret_cast<uint4*>(&ks[r * kLdb + c]) = kx;
      *reinterpret_cast<uint4*>(&vs[r * kLdb + c]) = vx;
    }
    __syncthreads();

    // S = q k^T: 8 n-tiles of 8 keys
    float s[kBK / 8][4];
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const __nv_bfloat16* kr = &ks[(j * 8 + g) * kLdb + kk * 16 + tg * 2];
        mma_bf16(s[j], qa[kk], lds32(kr), lds32(kr + 8));
      }
    }

    // mask, scale and the online softmax of rows r0 (e = 0, 1) and r0 + 8
    float row_max[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int k_pos = k0 + j * 8 + tg * 2 + (e & 1);
        const bool ok = q_pos[e >> 1] >= k_pos && k_pos < kv_len;
        s[j][e] = ok ? s[j][e] * scale : kNegInf;
        row_max[e >> 1] = fmaxf(row_max[e >> 1], s[j][e]);
      }
    float shift[2], corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m[r], row_max4(row_max[r]));
      shift[r] = m_new <= kNegInf / 2 ? 0.f : m_new;
      corr[r] = expf(m[r] - shift[r]);
      m[r] = m_new;
    }
    float psum[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = expf(s[j][e] - shift[e >> 1]);
        psum[e >> 1] += s[j][e];
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + row_sum4(psum[r]);
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n][e] *= corr[e >> 1];

    // O += P v: the score accumulator of n-tiles 2kk, 2kk+1 is the A
    // fragment of keys 16kk .. 16kk+15
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int n = 0; n < D / 8; n += 2) {
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, &vs[(kk * 16 + (lane & 15)) * kLdb + (n + (lane >> 4)) * 8]);
        mma_bf16(o[n], pa, vb[0], vb[1]);
        mma_bf16(o[n + 1], pa, vb[2], vb[3]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + r0 + 8 * r;
    if (row >= s_q) continue;
    const float inv = 1.f / (l[r] == 0.f ? 1.f : l[r]);
    __nv_bfloat16* o_row = out + b * o_sb + (long long)row * o_ss + h * o_sh;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<uint32_t*>(&o_row[n * 8 + tg * 2]) =
          pack_bf16(o[n][2 * r] * inv, o[n][2 * r + 1] * inv);
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

#define FLASH_ARGS                                                              \
  a.seq_lens, a.q_offset, (T*)a.out, a.s_q, a.s_k, a.n_heads, a.n_kv, a.st[0],  \
      a.st[1], a.st[2], a.st[3], a.st[4], a.st[5], a.st[6], a.st[7], a.st[8],    \
      a.st[9], a.st[10], a.st[11], 1.0f / sqrtf((float)D)

template <typename T, int D>
int launch(const Args& a) {
  const dim3 grid((a.s_q + kBQ - 1) / kBQ, a.n_heads, a.batch);
  cudaError_t err;
  if constexpr (sizeof(T) == 2) {
    constexpr size_t smem = mma_smem_bytes<D>();
    err = cudaFuncSetAttribute(flash_mma_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    flash_mma_kernel<D><<<grid, kThreads, smem, a.stream>>>(
        (const T*)a.q, (const T*)a.k, (const T*)a.v, FLASH_ARGS);
  } else {
    constexpr size_t smem = smem_bytes<D>();
    err = cudaFuncSetAttribute(flash_fma_kernel<T, D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    flash_fma_kernel<T, D><<<grid, kThreads, smem, a.stream>>>(
        (const T*)a.q, (const T*)a.k, (const T*)a.v, FLASH_ARGS);
  }
  return (int)cudaGetLastError();
}
#undef FLASH_ARGS

template <typename T>
int launch_dim(const Args& a, int head_dim) {
  switch (head_dim) {
    case 32: return launch<T, 32>(a);
    case 64: return launch<T, 64>(a);
    case 128: return launch<T, 128>(a);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Strides are in elements: q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss,
// v_sh, o_sb, o_ss, o_sh (batch, sequence, head); the head_dim axis is
// contiguous.  For bfloat16 every stride is a multiple of 8 and every base
// 16-byte aligned (16-byte vector loads).  dtype: 0 = float32, 1 = bfloat16.  Returns
// cudaGetLastError() after the launch (or the attribute call's error).
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
  if (dtype == 0) return launch_dim<float>(a, head_dim);
  if (dtype == 1) return launch_dim<__nv_bfloat16>(a, head_dim);
  return (int)cudaErrorInvalidValue;
}
