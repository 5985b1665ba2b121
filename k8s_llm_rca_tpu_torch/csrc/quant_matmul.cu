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
// Design.
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
//
// Not yet: TMA, wgmma and a deeper pipeline for the prefill tiles.

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
// subtracting 2^23 + 8 gives the signed value exactly, with no
// integer-to-float conversion (a quarter-rate instruction)
__device__ __forceinline__ float nib_f(uint32_t w8, int shift) {
  return __int_as_float(0x4B000000u | ((w8 >> shift) & 0xFu)) - 8388616.f;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// ------------------------------------------------------------ kn, small M

constexpr int kGemvMaxM = 16;     // rows of x the weight-streaming body takes
constexpr int kGemvMT = 4;        // rows of x per block
constexpr int kGemvThreads = 256;
constexpr int kGemvWarps = kGemvThreads / 32;
constexpr int kGemvCols = 256;    // packed columns per block: 32 lanes x 8 bytes
constexpr int kGemvBatch = 8;     // rows of K whose loads a thread issues together
constexpr int kGemvMinRows = 128; // fewest rows of K a split walks
constexpr int kGemvMaxRows = 1792;// most rows of K a split stages (28 KB of x)

// unscaled fp32 partials [k_splits, M, N]; x rows of this split staged in
// dynamic shared memory [kGemvMT][ke - kb]
template <typename T>
__global__ void __launch_bounds__(kGemvThreads, 2)
kn4_gemv_kernel(const T* __restrict__ x, const int8_t* __restrict__ q,
                float* __restrict__ part, int m, int k, int n, int k_per_split) {
  extern __shared__ __align__(16) float xs[];
  __shared__ float red[kGemvWarps][16][33];
  const int np = n / 2;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int c = blockIdx.x * kGemvCols + lane * 8;  // this thread's packed columns c..c+7
  const bool col_ok = c < np;                        // np % 8 == 0: whole vector or none
  const int split = blockIdx.y;
  const int m0 = blockIdx.z * kGemvMT;
  const int kb = split * k_per_split;
  const int ke = min(k, kb + k_per_split);
  const int rows = max(ke - kb, 0);

  for (int i = tid; i < kGemvMT * rows; i += kGemvThreads) {
    const int mm = i / rows;
    const int r = i % rows;
    xs[i] = m0 + mm < m ? to_f(x[(long long)(m0 + mm) * k + kb + r]) : 0.f;
  }
  __syncthreads();

  float acc[kGemvMT][16];
#pragma unroll
  for (int mm = 0; mm < kGemvMT; ++mm)
#pragma unroll
    for (int e = 0; e < 16; ++e) acc[mm][e] = 0.f;

  // batches of 8 rows dealt round-robin to the warps; the next batch's
  // loads are in flight while the current one is multiplied
  auto load = [&](int batch, uint2 (&wv)[kGemvBatch]) {
#pragma unroll
    for (int u = 0; u < kGemvBatch; ++u) {
      const int r = batch * kGemvBatch + u;
      wv[u] = make_uint2(0u, 0u);
      if (col_ok && r < rows)
        wv[u] = *reinterpret_cast<const uint2*>(q + (long long)(kb + r) * np + c);
    }
  };
  uint2 cur[kGemvBatch], nxt[kGemvBatch];
  const int n_batches = (rows + kGemvBatch - 1) / kGemvBatch;
  int batch = warp;
  if (batch < n_batches) load(batch, cur);
  for (; batch < n_batches; batch += kGemvWarps) {
    if (batch + kGemvWarps < n_batches) load(batch + kGemvWarps, nxt);
#pragma unroll
    for (int u = 0; u < kGemvBatch; ++u) {
      const uint32_t a = cur[u].x ^ 0x88888888u;
      const uint32_t b = cur[u].y ^ 0x88888888u;
      float wf[16];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        wf[i] = nib_f(a, 8 * i);          // low nibbles: columns c .. c+7
        wf[4 + i] = nib_f(b, 8 * i);
        wf[8 + i] = nib_f(a, 8 * i + 4);  // high nibbles: columns np + c ..
        wf[12 + i] = nib_f(b, 8 * i + 4);
      }
      const int r = batch * kGemvBatch + u;
#pragma unroll
      for (int mm = 0; mm < kGemvMT; ++mm) {
        const float xv = r < rows ? xs[mm * rows + r] : 0.f;
#pragma unroll
        for (int e = 0; e < 16; ++e) acc[mm][e] = fmaf(xv, wf[e], acc[mm][e]);
      }
    }
#pragma unroll
    for (int u = 0; u < kGemvBatch; ++u) cur[u] = nxt[u];
  }

  // the 8 warps' sums, one row of x at a time; output o = (lane ln, slot e):
  // e < 8 is packed column c + e's low column, e >= 8 its high column
  for (int mm = 0; mm < kGemvMT; ++mm) {
    __syncthreads();
#pragma unroll
    for (int e = 0; e < 16; ++e) red[warp][e][lane] = acc[mm][e];
    __syncthreads();
    if (m0 + mm >= m) continue;  // uniform over the block
    for (int o = tid; o < 16 * 32; o += kGemvThreads) {
      const int ln = o / 16;
      const int e = o % 16;
      const int col = blockIdx.x * kGemvCols + ln * 8 + (e & 7);
      if (col >= np) continue;
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < kGemvWarps; ++w) s += red[w][e][ln];
      part[((long long)split * m + m0 + mm) * n + (e < 8 ? col : np + col)] = s;
    }
  }
}

template <typename T, typename S>
__global__ void __launch_bounds__(256)
kn4_reduce_kernel(const float* __restrict__ part, const S* __restrict__ scale,
                  T* __restrict__ out, int m, int n, int k_splits) {
  const long long total = (long long)m * n;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  float s = 0.f;
  for (int sp = 0; sp < k_splits; ++sp) s += part[sp * total + i];
  out[i] = from_f<T>(s * to_f(scale[i % n]));
}

// ---------------------------------------------------- kn, large M, bf16 MMA

constexpr int kTmBM = 128;             // rows of x per block
constexpr int kTmBNP = 64;             // packed columns per block (128 outputs)
constexpr int kTmBK = 64;              // K per step
constexpr int kTmThreads = 256;        // 8 warps: 2 along M x 4 along N
constexpr int kTmLdA = kTmBK + 8;      // bf16 row strides, padded so the
constexpr int kTmLdB = 2 * kTmBNP + 8; // fragment loads hit distinct banks
// two stages of x [BM][LdA] bf16 and packed weights [BK][BNP] bytes, then
// one unpacked weight tile [BK][LdB] bf16
constexpr int kTmStageA = kTmBM * kTmLdA * 2;
constexpr int kTmStageB = kTmBK * kTmBNP;
constexpr int kTmSmem = 2 * (kTmStageA + kTmStageB) + kTmBK * kTmLdB * 2;

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

// 16 packed bytes -> 16 low and 16 high values as bf16 (exact), 2 uint4 each
__device__ __forceinline__ void unpack16_bf16(const uint4& p, uint4 (&lo)[2],
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

template <typename S>
__global__ void __launch_bounds__(kTmThreads)
kn4_mma_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ q,
               const S* __restrict__ scale, __nv_bfloat16* __restrict__ out, int m,
               int k, int n) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* Bs = reinterpret_cast<__nv_bfloat16*>(smem + 2 * (kTmStageA + kTmStageB));
  const int np = n / 2;
  const int pc0 = blockIdx.x * kTmBNP;
  const int m0 = blockIdx.y * kTmBM;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;   // fragment row group
  const int tg = lane & 3;   // thread in group
  const int wm = warp >> 2;  // rows wm*64 .. +63 of the tile
  const int wn = warp & 3;   // tile columns wn*32 .. +31 (0..63 low, 64..127 high)

  auto stage_a = [&](int st) {
    return reinterpret_cast<__nv_bfloat16*>(smem + st * (kTmStageA + kTmStageB));
  };
  auto stage_b = [&](int st) { return smem + st * (kTmStageA + kTmStageB) + kTmStageA; };
  // one step's tiles into stage st: x 128 x 64 (4 vectors a thread), the
  // packed weights 64 x 64 bytes (1 a thread); rows past m, columns past
  // n/2 and depth past k read nothing and land as zeros
  auto fetch = [&](int k0, int st) {
    __nv_bfloat16* as = stage_a(st);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int idx = tid + j * kTmThreads;
      const int r = idx >> 3;
      const int cv = (idx & 7) * 8;
      const bool ok = m0 + r < m && k0 + cv < k;
      cp_async16(&as[r * kTmLdA + cv], ok ? x + (long long)(m0 + r) * k + k0 + cv : x,
                 ok ? 16 : 0);
    }
    const int r = tid >> 2;
    const int cb = (tid & 3) * 16;
    const bool ok = pc0 + cb < np && k0 + r < k;
    cp_async16(stage_b(st) + r * kTmBNP + cb,
               ok ? q + (long long)(k0 + r) * np + pc0 + cb : q, ok ? 16 : 0);
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
  for (int k0 = 0, st = 0; k0 < k; k0 += kTmBK, st ^= 1) {
    cp_async_wait_all();
    __syncthreads();  // stage st has landed; the previous step's readers are done
    {
      const int r = tid >> 2;
      const int cb = (tid & 3) * 16;
      uint4 lo[2], hi[2];
      unpack16_bf16(*reinterpret_cast<const uint4*>(stage_b(st) + r * kTmBNP + cb), lo, hi);
      uint4* row = reinterpret_cast<uint4*>(&Bs[r * kTmLdB]);
      row[cb / 8] = lo[0];
      row[cb / 8 + 1] = lo[1];
      row[(kTmBNP + cb) / 8] = hi[0];
      row[(kTmBNP + cb) / 8 + 1] = hi[1];
    }
    if (k0 + kTmBK < k) fetch(k0 + kTmBK, st ^ 1);  // lands during this step's math
    __syncthreads();  // the unpacked tile is complete

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
      const int pcol = pc0 + (tc & (kTmBNP - 1));
      if (pcol >= np) continue;
      const int col = tc < kTmBNP ? pcol : np + pcol;
      const float s0 = to_f(scale[col]);
      const float s1 = to_f(scale[col + 1]);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = m0 + wm * 64 + mt * 16 + g + 8 * r;
        if (row >= m) continue;
        *reinterpret_cast<uint32_t*>(&out[(long long)row * n + col]) =
            pack_bf16(acc[mt][nt][2 * r] * s0, acc[mt][nt][2 * r + 1] * s1);
      }
    }
}

// ---------------------------------------------------- kn, large M, fp32 FMA

constexpr int kTfBM = 64;    // rows of x per block
constexpr int kTfBNP = 32;   // packed columns per block (64 outputs)
constexpr int kTfBK = 16;

template <typename S>
__global__ void __launch_bounds__(256)
kn4_fma_kernel(const float* __restrict__ x, const int8_t* __restrict__ q,
               const S* __restrict__ scale, float* __restrict__ out, int m, int k, int n) {
  const int np = n / 2;
  const int pc0 = blockIdx.x * kTfBNP;
  const int m0 = blockIdx.y * kTfBM;
  const int tid = threadIdx.x;
  const int ty = tid >> 4;  // rows ty*4 .. +3
  const int tx = tid & 15;  // tile columns tx*4 .. +3 (0..31 low, 32..63 high)

  __shared__ __align__(16) float As[kTfBK][kTfBM + 4];      // x tile, transposed
  __shared__ __align__(16) float Bs[kTfBK][2 * kTfBNP + 4]; // unpacked weights

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < k; k0 += kTfBK) {
    __syncthreads();
    for (int i = tid; i < kTfBM * kTfBK; i += 256) {
      const int r = i / kTfBK;
      const int kk = i % kTfBK;
      As[kk][r] = m0 + r < m ? x[(long long)(m0 + r) * k + k0 + kk] : 0.f;
    }
    if (tid < 128) {
      const int r = tid >> 3;
      const int cb = (tid & 7) * 4;
      const bool ok = pc0 + cb < np;  // np % 16 == 0: all 4 columns or none
      const uint32_t w =
          ok ? *reinterpret_cast<const uint32_t*>(q + (long long)(k0 + r) * np + pc0 + cb) : 0u;
      const uint32_t w8 = w ^ 0x88888888u;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        Bs[r][cb + i] = nib_f(w8, 8 * i);
        Bs[r][kTfBNP + cb + i] = nib_f(w8, 8 * i + 4);
      }
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
    if (row >= m) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int tc = tx * 4 + j;
      const int pcol = pc0 + (tc & (kTfBNP - 1));
      if (pcol >= np) continue;
      const int col = tc < kTfBNP ? pcol : np + pcol;
      out[(long long)row * n + col] = acc[i][j] * to_f(scale[col]);
    }
  }
}

// ------------------------------------------------------------------- nk

constexpr int kHeadMT = 8;        // rows of x per block
constexpr int kHeadThreads = 256;
constexpr int kHeadWarps = kHeadThreads / 32;
constexpr int kHeadUnroll = 16;   // 4-byte loads a lane issues together (a 2 KB row)

template <typename T, typename S>
__global__ void __launch_bounds__(kHeadThreads)
nk4_kernel(const T* __restrict__ x, const int8_t* __restrict__ q,
           const S* __restrict__ scale, T* __restrict__ out, int m, int k, int v) {
  extern __shared__ __align__(16) float xs[];  // [mc][k], fp32 once for every row
  const int kh = k / 2;
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
    const int8_t* qrow = q + (long long)row * kh;
    float acc[kHeadMT];
#pragma unroll
    for (int mm = 0; mm < kHeadMT; ++mm) acc[mm] = 0.f;
    for (int jb = lane * 4; jb < kh; jb += 128 * kHeadUnroll) {
      uint32_t p[kHeadUnroll];
#pragma unroll
      for (int u = 0; u < kHeadUnroll; ++u) {
        const int j0 = jb + 128 * u;
        p[u] = j0 < kh ? *reinterpret_cast<const uint32_t*>(qrow + j0) : 0u;
      }
#pragma unroll
      for (int u = 0; u < kHeadUnroll; ++u) {
        const int j0 = jb + 128 * u;
        if (j0 >= kh) break;
        const uint32_t w8 = p[u] ^ 0x88888888u;
        float lo[4], hi[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          lo[i] = nib_f(w8, 8 * i);      // meets x[m, j0 + i]
          hi[i] = nib_f(w8, 8 * i + 4);  // meets x[m, K/2 + j0 + i]
        }
#pragma unroll
        for (int mm = 0; mm < kHeadMT; ++mm) {
          if (mm >= mc) break;
          const float4 a = *reinterpret_cast<const float4*>(xs + mm * k + j0);
          const float4 b = *reinterpret_cast<const float4*>(xs + mm * k + kh + j0);
          float s = acc[mm];
          s = fmaf(a.x, lo[0], s);
          s = fmaf(a.y, lo[1], s);
          s = fmaf(a.z, lo[2], s);
          s = fmaf(a.w, lo[3], s);
          s = fmaf(b.x, hi[0], s);
          s = fmaf(b.y, hi[1], s);
          s = fmaf(b.z, hi[2], s);
          acc[mm] = fmaf(b.w, hi[3], s);
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

// ------------------------------------------------------------- launchers

// K splits of the weight-streaming body: as many as fill the card's
// resident block slots in one wave (a second, partial wave would double
// the time), each walking kGemvMinRows..kGemvMaxRows rows of K
template <typename T>
int gemv_splits(int m, int k, int n, int max_splits) {
  static int slots = 0;
  if (slots == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kn4_gemv_kernel<T>, kGemvThreads,
        kGemvMT * kGemvMaxRows * sizeof(float));
    slots = sms * (per_sm > 0 ? per_sm : 1);
  }
  const int blocks = ((n / 2 + kGemvCols - 1) / kGemvCols) * ((m + kGemvMT - 1) / kGemvMT);
  int splits = slots / blocks;
  splits = min(splits, k / kGemvMinRows);
  splits = max(splits, (k + kGemvMaxRows - 1) / kGemvMaxRows);
  return max(1, min(splits, max_splits));
}

template <typename T, typename S>
int kn4(const void* x, const void* q, const void* scale, void* out, float* scratch, int m,
        int k, int n, int max_splits, cudaStream_t st) {
  const int np = n / 2;
  if (m <= kGemvMaxM) {
    const int k_splits = gemv_splits<T>(m, k, n, max_splits);
    const int k_per_split = (k + k_splits - 1) / k_splits;
    if (k_per_split > kGemvMaxRows) return (int)cudaErrorInvalidValue;
    const size_t smem = kGemvMT * k_per_split * sizeof(float);
    const dim3 grid((np + kGemvCols - 1) / kGemvCols, k_splits, (m + kGemvMT - 1) / kGemvMT);
    kn4_gemv_kernel<T><<<grid, kGemvThreads, smem, st>>>((const T*)x, (const int8_t*)q,
                                                        scratch, m, k, n, k_per_split);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const long long total = (long long)m * n;
    kn4_reduce_kernel<T, S><<<(unsigned)((total + 255) / 256), 256, 0, st>>>(
        scratch, (const S*)scale, (T*)out, m, n, k_splits);
    return (int)cudaGetLastError();
  }
  if constexpr (std::is_same<T, float>::value) {
    const dim3 grid((np + kTfBNP - 1) / kTfBNP, (m + kTfBM - 1) / kTfBM);
    kn4_fma_kernel<S><<<grid, 256, 0, st>>>((const float*)x, (const int8_t*)q,
                                            (const S*)scale, (float*)out, m, k, n);
  } else {
    cudaError_t err = cudaFuncSetAttribute(
        kn4_mma_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize, kTmSmem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((np + kTmBNP - 1) / kTmBNP, (m + kTmBM - 1) / kTmBM);
    kn4_mma_kernel<S><<<grid, kTmThreads, kTmSmem, st>>>((const __nv_bfloat16*)x,
                                                         (const int8_t*)q, (const S*)scale,
                                                         (__nv_bfloat16*)out, m, k, n);
  }
  return (int)cudaGetLastError();
}

template <typename T, typename S>
int nk4(const void* x, const void* q, const void* scale, void* out, int m, int k, int v,
        cudaStream_t st) {
  const size_t smem = (size_t)(m < kHeadMT ? m : kHeadMT) * k * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(nk4_kernel<T, S>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  // one wave: as many blocks as the card holds at once with this much
  // shared memory, warps striding over the vocab rows (once per step)
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, nk4_kernel<T, S>, kHeadThreads, smem);
  const int slots = sms * (per_sm > 0 ? per_sm : 1);
  const int rows_blocks = (v + kHeadWarps - 1) / kHeadWarps;
  const dim3 grid(rows_blocks < slots ? rows_blocks : slots, (m + kHeadMT - 1) / kHeadMT);
  nk4_kernel<T, S><<<grid, kHeadThreads, smem, st>>>(
      (const T*)x, (const int8_t*)q, (const S*)scale, (T*)out, m, k, v);
  return (int)cudaGetLastError();
}

}  // namespace

// x [m, k] (x_dtype 0 = float32, 1 = bfloat16), q [k, n/2] int8, scale [n]
// (scale_dtype 0 = float32, 1 = bfloat16; bfloat16 x takes bfloat16 scales),
// out [m, n] in x's type.  k and n are multiples of 32, x and q 16-byte
// aligned.  For m <= 16, scratch holds max_splits * m * n floats, with
// max_splits >= k / 1792 rounded up; otherwise it is unused.  Returns
// cudaGetLastError().
extern "C" int quant_matmul_kn4_launch(const void* x, const void* q, const void* scale,
                                       void* out, void* scratch, int m, int k, int n,
                                       int max_splits, int x_dtype, int scale_dtype,
                                       void* stream) {
  if (m <= 0 || k <= 0 || n <= 0 || k % 32 || n % 32 || max_splits < 1 ||
      max_splits > 65535 || (m + kTmBM - 1) / kTmBM > 65535 ||
      (x_dtype == 1 && scale_dtype != 1)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = (cudaStream_t)stream;
  float* sc = (float*)scratch;
  if (x_dtype == 1) return kn4<__nv_bfloat16, __nv_bfloat16>(x, q, scale, out, sc, m, k, n, max_splits, st);
  if (x_dtype == 0 && scale_dtype == 1)
    return kn4<float, __nv_bfloat16>(x, q, scale, out, sc, m, k, n, max_splits, st);
  if (x_dtype == 0 && scale_dtype == 0)
    return kn4<float, float>(x, q, scale, out, sc, m, k, n, max_splits, st);
  return (int)cudaErrorInvalidValue;
}

// x [m, k], q [v, k/2] int8, scale [v], out [m, v] in x's type; dtypes as
// above.  k is a multiple of 32 and min(m, 8) * k * 4 bytes fits the
// block's shared memory (227 KB).  Returns cudaGetLastError().
extern "C" int quant_matmul_nk4_launch(const void* x, const void* q, const void* scale,
                                       void* out, int m, int k, int v, int x_dtype,
                                       int scale_dtype, void* stream) {
  if (m <= 0 || k <= 0 || v <= 0 || k % 32 || (m + kHeadMT - 1) / kHeadMT > 65535 ||
      (x_dtype == 1 && scale_dtype != 1)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = (cudaStream_t)stream;
  if (x_dtype == 1) return nk4<__nv_bfloat16, __nv_bfloat16>(x, q, scale, out, m, k, v, st);
  if (x_dtype == 0 && scale_dtype == 1) return nk4<float, __nv_bfloat16>(x, q, scale, out, m, k, v, st);
  if (x_dtype == 0 && scale_dtype == 0) return nk4<float, float>(x, q, scale, out, m, k, v, st);
  return (int)cudaErrorInvalidValue;
}
