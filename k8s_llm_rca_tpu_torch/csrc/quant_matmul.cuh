// Shared pieces of the fused weight-dequant matmuls for Hopper (sm_90a):
// value conversions, the tensor-core helpers, the kn bodies y = x @ (q * s)
// with per-column scales, for int8 and split-half int4 weights, with an
// optional leading expert axis, and the nk body (the lm head).  Included by
// quant_matmul.cu (int4 kn and nk), quant_matmul_int8.cu (int8 kn and nk)
// and quant_matmul_experts.cu (int8 and int4 ekn); each compiles its own
// copy into its own library.
//
// The kn bodies (what bounds them and why, see quant_matmul.cu):
// - M <= 16, rows of a multiple of 16 bytes (weight streaming): split K,
//   fp32 partials, a second pass that sums the splits and scales.  A lane
//   holds 16 outputs: 8 packed int4 bytes (8 low, 8 high columns) or 16
//   int8 bytes.
// - M > 16, bf16: 128 x 128 output tiles on tensor cores (mma.sync
//   m16n8k16, fp32 accumulators), cp.async double-buffered 64-deep steps;
//   the weights are converted to bf16 exactly (|q| <= 127) in shared memory.
// - M > 16, fp32: 64 x 64 FMA tiles.
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
//     split; fp32 partials and the second pass of the weight-streaming body
//     (deterministic sums, no atomics).
//   - narrow_bytes, any other shape (K not a multiple of 8, or a slice
//     too large for shared memory): one block per (row of x, 16 packed
//     columns), its threads splitting K, bytes read one by one (no
//     alignment assumed), a block reduction at the end.
// Integers become floats by an exponent trick on 32-bit words (nib_f,
// byte_f), not by integer-to-float instructions (a quarter-rate pipe).

#pragma once

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

// four 8x8 bf16 matrices from shared memory: as stored (an A fragment of a
// row-major tile) or transposed (the B operand of a row-major [K][N] tile)
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  const uint32_t addr = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  const uint32_t addr = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// 16 bytes global -> shared without registers; src_bytes 0 writes zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n"); }

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// 16 packed int4 bytes -> 16 low and 16 high values as bf16 (exact)
__device__ __forceinline__ void unpack16_nib_bf16(const uint4& p, uint4 (&lo)[2],
                                                  uint4 (&hi)[2]) {
  const uint32_t w[4] = {p.x ^ 0x88888888u, p.y ^ 0x88888888u, p.z ^ 0x88888888u,
                         p.w ^ 0x88888888u};
  uint32_t l[8], h[8];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    l[2 * j] = pack_bf16(nib_f(w[j], 0), nib_f(w[j], 8));
    l[2 * j + 1] = pack_bf16(nib_f(w[j], 16), nib_f(w[j], 24));
    h[2 * j] = pack_bf16(nib_f(w[j], 4), nib_f(w[j], 12));
    h[2 * j + 1] = pack_bf16(nib_f(w[j], 20), nib_f(w[j], 28));
  }
  lo[0] = make_uint4(l[0], l[1], l[2], l[3]);
  lo[1] = make_uint4(l[4], l[5], l[6], l[7]);
  hi[0] = make_uint4(h[0], h[1], h[2], h[3]);
  hi[1] = make_uint4(h[4], h[5], h[6], h[7]);
}

// 16 int8 bytes -> 16 values as bf16 (exact: |q| <= 128 fits 8 bits)
__device__ __forceinline__ void unpack16_byte_bf16(const uint4& p, uint4 (&v)[2]) {
  const uint32_t w[4] = {p.x ^ 0x80808080u, p.y ^ 0x80808080u, p.z ^ 0x80808080u,
                         p.w ^ 0x80808080u};
  uint32_t o[8];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    o[2 * j] = pack_bf16(byte_f(w[j], 0), byte_f(w[j], 8));
    o[2 * j + 1] = pack_bf16(byte_f(w[j], 16), byte_f(w[j], 24));
  }
  v[0] = make_uint4(o[0], o[1], o[2], o[3]);
  v[1] = make_uint4(o[4], o[5], o[6], o[7]);
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

// ------------------------------------------------------------ small M

constexpr int kGemvMaxM = 16;      // rows of x the weight-streaming body takes
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
template <int BITS, typename T>
__global__ void __launch_bounds__(kGemvThreads, 2)
kn_gemv_kernel(const T* __restrict__ x, const int8_t* __restrict__ q,
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
  const T* xe = x + ex * g.x_es;
  const int8_t* qe = q + (long long)ex * g.k * np;

  for (int i = tid; i < kGemvMT * rows; i += kGemvThreads) {
    const int mm = i / rows;
    const int r = i % rows;
    xs[i] = m0 + mm < g.m ? to_f(xe[(m0 + mm) * g.x_rs + kb + r]) : 0.f;
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

// ---------------------------------------------------- large M, bf16 MMA

constexpr int kTmBM = 128;         // rows of x per block
constexpr int kTmBK = 64;          // K per step
constexpr int kTmThreads = 256;    // 8 warps: 2 along M x 4 along N
constexpr int kTmLdA = kTmBK + 8;  // bf16 row strides, padded so the
constexpr int kTmLdB = 128 + 8;    // fragment loads hit distinct banks
constexpr int kTmStageA = kTmBM * kTmLdA * 2;

// two stages of x [BM][LdA] bf16 and packed weights [BK][kBytes] bytes,
// then one converted weight tile [BK][LdB] bf16 (128 output columns: int4
// 64 packed columns, low then high; int8 128 columns)
template <int BITS> struct KnTile {
  static constexpr int kBytes = BITS == 4 ? 64 : 128;
  static constexpr int kStageB = kTmBK * kBytes;
  static constexpr int kSmem = 2 * (kTmStageA + kStageB) + kTmBK * kTmLdB * 2;
};

template <int BITS, typename S>
__global__ void __launch_bounds__(kTmThreads)
kn_mma_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ q,
              const S* __restrict__ scale, __nv_bfloat16* __restrict__ out, KnGeom g) {
  using Tl = KnTile<BITS>;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* Bs = reinterpret_cast<__nv_bfloat16*>(smem + 2 * (kTmStageA + Tl::kStageB));
  const int np = packed_cols<BITS>(g.n);
  const int pc0 = blockIdx.x * Tl::kBytes;
  const int m0 = blockIdx.y * kTmBM;
  const int ex = blockIdx.z;
  const __nv_bfloat16* xe = x + ex * g.x_es;
  const int8_t* qe = q + (long long)ex * g.k * np;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int gr = lane >> 2;  // fragment row group
  const int tg = lane & 3;   // thread in group
  const int wm = warp >> 2;  // rows wm*64 .. +63 of the tile
  const int wn = warp & 3;   // tile columns wn*32 .. +31

  auto stage_a = [&](int st) {
    return reinterpret_cast<__nv_bfloat16*>(smem + st * (kTmStageA + Tl::kStageB));
  };
  auto stage_b = [&](int st) { return smem + st * (kTmStageA + Tl::kStageB) + kTmStageA; };
  constexpr int kVecsPerRow = Tl::kBytes / 16;
  constexpr int kVecsB = Tl::kStageB / 16 / kTmThreads;  // 1 (int4) or 2 (int8)
  // one step's tiles into stage st; rows past m, columns past np and depth
  // past k read nothing and land as zeros
  auto fetch = [&](int k0, int st) {
    __nv_bfloat16* as = stage_a(st);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int idx = tid + j * kTmThreads;
      const int r = idx >> 3;
      const int cv = (idx & 7) * 8;
      const bool ok = m0 + r < g.m && k0 + cv < g.k;
      cp_async16(&as[r * kTmLdA + cv], ok ? xe + (m0 + r) * g.x_rs + k0 + cv : x,
                 ok ? 16 : 0);
    }
#pragma unroll
    for (int j = 0; j < kVecsB; ++j) {
      const int idx = tid + j * kTmThreads;
      const int r = idx / kVecsPerRow;
      const int cb = (idx % kVecsPerRow) * 16;
      const bool ok = pc0 + cb < np && k0 + r < g.k;
      cp_async16(stage_b(st) + r * Tl::kBytes + cb,
                 ok ? qe + (long long)(k0 + r) * np + pc0 + cb : q, ok ? 16 : 0);
    }
    cp_async_commit();
  };

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  fetch(0, 0);
  for (int k0 = 0, st = 0; k0 < g.k; k0 += kTmBK, st ^= 1) {
    cp_async_wait_all();
    __syncthreads();  // stage st has landed; the previous step's readers are done
#pragma unroll
    for (int j = 0; j < kVecsB; ++j) {
      const int idx = tid + j * kTmThreads;
      const int r = idx / kVecsPerRow;
      const int cb = (idx % kVecsPerRow) * 16;
      const uint4 p = *reinterpret_cast<const uint4*>(stage_b(st) + r * Tl::kBytes + cb);
      uint4* row = reinterpret_cast<uint4*>(&Bs[r * kTmLdB]);
      if constexpr (BITS == 4) {
        uint4 lo[2], hi[2];
        unpack16_nib_bf16(p, lo, hi);
        row[cb / 8] = lo[0];
        row[cb / 8 + 1] = lo[1];
        row[(64 + cb) / 8] = hi[0];
        row[(64 + cb) / 8 + 1] = hi[1];
      } else {
        uint4 v[2];
        unpack16_byte_bf16(p, v);
        row[cb / 8] = v[0];
        row[cb / 8 + 1] = v[1];
      }
    }
    if (k0 + kTmBK < g.k) fetch(k0 + kTmBK, st ^ 1);  // lands during this step's math
    __syncthreads();  // the converted tile is complete

    const __nv_bfloat16* as = stage_a(st);
#pragma unroll
    for (int kk = 0; kk < kTmBK / 16; ++kk) {
      uint32_t a[4][4];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
        ldmatrix_x4(a[mt], &as[(wm * 64 + mt * 16 + (lane & 15)) * kTmLdA + kk * 16 +
                               (lane >> 4) * 8]);
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        uint32_t vb[4];
        ldmatrix_x4_trans(
            vb, &Bs[(kk * 16 + (lane & 15)) * kTmLdB + wn * 32 + (2 * p + (lane >> 4)) * 8]);
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) {
          mma_bf16(acc[mt][2 * p], a[mt], vb[0], vb[1]);
          mma_bf16(acc[mt][2 * p + 1], a[mt], vb[2], vb[3]);
        }
      }
    }
  }

#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int tc = wn * 32 + nt * 8 + tg * 2;  // even tile column
      int col;
      if constexpr (BITS == 4) {
        const int pcol = pc0 + (tc & 63);
        if (pcol >= np) continue;
        col = tc < 64 ? pcol : np + pcol;
      } else {
        col = pc0 + tc;
        if (col >= np) continue;
      }
      const float s0 = to_f(scale[(long long)ex * g.n + col]);
      const float s1 = to_f(scale[(long long)ex * g.n + col + 1]);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = m0 + wm * 64 + mt * 16 + gr + 8 * r;
        if (row >= g.m) continue;
        *reinterpret_cast<uint32_t*>(&out[ex * g.out_es + row * g.out_rs + col]) =
            pack_bf16(acc[mt][nt][2 * r] * s0, acc[mt][nt][2 * r + 1] * s1);
      }
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
template <int BITS, typename T>
int kn_gemv_splits(const KnGeom& g, int max_splits) {
  static int slots = 0;
  if (slots == 0) {
    int per_sm = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kn_gemv_kernel<BITS, T>,
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

// scratch: for m <= 16 (the aligned and the narrow_split bodies), e *
// max_splits * m * n floats
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
  if (g.m <= kGemvMaxM) {
    const int k_splits = kn_gemv_splits<BITS, T>(g, max_splits);
    const int k_per_split = (g.k + k_splits - 1) / k_splits;
    const int m_blocks = (g.m + kGemvMT - 1) / kGemvMT;
    if (k_per_split > kGemvMaxRows || (long long)m_blocks * g.e > 65535)
      return (int)cudaErrorInvalidValue;
    const size_t smem = kGemvMT * k_per_split * sizeof(float);
    const dim3 grid((np + KnGemv<BITS>::kCols - 1) / KnGemv<BITS>::kCols, k_splits,
                    m_blocks * g.e);
    kn_gemv_kernel<BITS, T><<<grid, kGemvThreads, smem, st>>>(
        (const T*)x, (const int8_t*)q, scratch, g, k_per_split, m_blocks);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const long long total = (long long)g.e * g.m * g.n;
    kn_reduce_kernel<T, S><<<(unsigned)((total + 255) / 256), 256, 0, st>>>(
        scratch, (const S*)scale, (T*)out, g, k_splits);
    return (int)cudaGetLastError();
  }
  if (g.e > 65535) return (int)cudaErrorInvalidValue;
  if constexpr (std::is_same<T, float>::value) {
    constexpr int kBytes = BITS == 4 ? kTfBN / 2 : kTfBN;
    const dim3 grid((np + kBytes - 1) / kBytes, (g.m + kTfBM - 1) / kTfBM, g.e);
    if (grid.y > 65535) return (int)cudaErrorInvalidValue;
    kn_fma_kernel<BITS, S><<<grid, 256, 0, st>>>((const float*)x, (const int8_t*)q,
                                                 (const S*)scale, (float*)out, g);
  } else {
    cudaError_t err = cudaFuncSetAttribute(
        kn_mma_kernel<BITS, S>, cudaFuncAttributeMaxDynamicSharedMemorySize, KnTile<BITS>::kSmem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((np + KnTile<BITS>::kBytes - 1) / KnTile<BITS>::kBytes,
                    (g.m + kTmBM - 1) / kTmBM, g.e);
    if (grid.y > 65535) return (int)cudaErrorInvalidValue;
    kn_mma_kernel<BITS, S><<<grid, kTmThreads, KnTile<BITS>::kSmem, st>>>(
        (const __nv_bfloat16*)x, (const int8_t*)q, (const S*)scale, (__nv_bfloat16*)out, g);
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

constexpr int kHeadMT = 8;        // rows of x per block
constexpr int kHeadThreads = 256;
constexpr int kHeadWarps = kHeadThreads / 32;
constexpr int kHeadUnroll = 16;   // 4-byte loads a lane issues together (a 2 KB row)

// y = x @ (q * s)^T for a table q [v, k] int8 or [v, k/2] int4 packed along
// K (byte j = k j low, k j + K/2 high), scale [v]: one warp per vocab row
// at a time (rows strided over a grid of one wave), the block's rows of x
// (up to 8) staged once in shared memory as fp32
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

// k: a multiple of 32 (int4: x's halves and the packed words align) or 4
// (int8); dtypes as kn_dispatch
template <int BITS>
int nk_dispatch(const void* x, const void* q, const void* scale, void* out, int m, int k,
                int v, int x_dtype, int scale_dtype, void* stream) {
  if (m <= 0 || k <= 0 || v <= 0 || k % (BITS == 4 ? 32 : 4) ||
      (m + kHeadMT - 1) / kHeadMT > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (x_dtype == 1 && scale_dtype == 1)
    return nk_launch<BITS, __nv_bfloat16, __nv_bfloat16>(x, q, scale, out, m, k, v, st);
  if (x_dtype == 0 && scale_dtype == 1)
    return nk_launch<BITS, float, __nv_bfloat16>(x, q, scale, out, m, k, v, st);
  if (x_dtype == 0 && scale_dtype == 0)
    return nk_launch<BITS, float, float>(x, q, scale, out, m, k, v, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace
