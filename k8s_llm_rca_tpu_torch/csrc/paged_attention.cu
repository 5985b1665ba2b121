// Paged decode attention for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces: k8s_llm_rca_tpu/ops/paged_attention.py::paged_attention
// (Pallas kernel _paged_kernel).  One query token per sequence attends over
// that sequence's KV pages in the shared pool; online softmax across the
// pages; keys at or past the sequence length are masked; GQA.
//
// Layouts (the JAX package's, unchanged):
//   q            [B, n_heads, d]
//   k/v pages    [n_pages, page_size, n_kv*d]   kv-heads merged on the last axis
//   lengths      [B] int32  valid tokens (the new token included)
//   block_tables [B, pages_per_seq] int32 page ids (page 0 = trash page)
//   out          [B, n_heads, d]
//
// What bounds it on the H100: bytes.  Each (sequence, kv-head) reads
// length * d keys and as many values once and does 4 * n_rep flops per
// element read: far below the ~295 flops per byte the tensor cores need,
// so the time floor is the KV bytes over 3.35 TB/s.
//
// Design.  A decode batch is small (B x n_kv = 32 (sequence, kv-head) pairs
// at the 8B smoke shapes, on 132 SMs), so one block per pair would leave
// most of the card idle and walk a long sequence serially.  The sequence
// is split instead: pass 1 runs one block of 128 threads per (kv-head,
// sequence, 256-token split) and keeps a partial online softmax (max, sum,
// accumulator) in fp32 scratch; pass 2 (one block per (sequence, head))
// rescales and sums the partials.  A split at or past the length reads
// nothing and leaves an empty partial; no token at or past the length is
// read (the Pallas grid fetches every page of the table).  In pass 1 the
// block holds its kv-head's n_rep query rows in shared memory and stages
// 32 tokens per step: each thread issues all of its 16-byte K and V loads
// for the step before using any (one memory latency per step, not one per
// element), resolving each token's page through the block table, a strided
// [page, d] view of the merged pool row.  One warp per query head scores
// the 32 tokens (lane = token) and updates that head's running max and
// sum with the Pallas NEG_INF shift rule (a fully masked row keeps
// m = NEG_INF and shifts by 0); each thread then owns one output dimension
// of the accumulators.  The TPU kernel's block-diagonal query expansion (n_kv
// times the matmul work to avoid lane padding) has no purpose here and is
// not carried over.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 32;      // tokens staged per step (one per lane)
constexpr int kChunk = 256;    // tokens per split (pass-1 block)
constexpr int kMaxRep = 8;     // query heads per kv-head
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// elements of T in one 16-byte load, and their conversion to fp32
template <typename T> struct Vec16;
template <> struct Vec16<float> {
  static constexpr int n = 4;
  __device__ __forceinline__ static void unpack(const uint4& r, float* out) {
    out[0] = __uint_as_float(r.x);
    out[1] = __uint_as_float(r.y);
    out[2] = __uint_as_float(r.z);
    out[3] = __uint_as_float(r.w);
  }
};
template <> struct Vec16<__nv_bfloat16> {
  static constexpr int n = 8;
  __device__ __forceinline__ static void unpack(const uint4& r, float* out) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
};

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Pass 1: partial softmax of one (kv-head, sequence, split).  Partials are
// indexed ((b * n_heads + head) * n_split + split).
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
paged_partial_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                     const T* __restrict__ v_pages, const int* __restrict__ lengths,
                     const int* __restrict__ tables, float* __restrict__ part_m,
                     float* __restrict__ part_l, float* __restrict__ part_acc,
                     int n_heads, int n_kv, int page_size, int pps, int n_split,
                     float scale) {
  constexpr int kVec = Vec16<T>::n;
  constexpr int kVecPerTok = D / kVec;
  constexpr int kLoads = kTile * kVecPerTok / kThreads;
  static_assert(kTile * kVecPerTok % kThreads == 0, "a step must split evenly");
  static_assert(D <= kThreads, "one output dimension per thread");

  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int split = blockIdx.z;
  const int n_rep = n_heads / n_kv;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const long long kv_dim = (long long)n_kv * D;

  __shared__ float q_s[kMaxRep][D];
  __shared__ float k_s[kTile][D + 1];   // +1: conflict-free row-per-lane reads
  __shared__ float v_s[kTile][D];
  __shared__ float p_s[kMaxRep][kTile];
  __shared__ float corr_s[kMaxRep];
  __shared__ float m_s[kMaxRep];
  __shared__ float l_s[kMaxRep];

  const T* q_b = q + ((long long)b * n_heads + (long long)kvh * n_rep) * D;
  for (int i = tid; i < n_rep * D; i += kThreads) q_s[i / D][i % D] = to_f(q_b[i]);
  if (tid < kMaxRep) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  float acc[kMaxRep];
#pragma unroll
  for (int h = 0; h < kMaxRep; ++h) acc[h] = 0.f;

  // never walk past the table: slots that are not live may carry a length
  // beyond it (their output is discarded, but their reads stay in bounds)
  const int length = min(lengths[b], pps * page_size);
  const int t_begin = split * kChunk;
  const int t_end = min(length, t_begin + kChunk);
  const int* table = tables + (long long)b * pps;
  __syncthreads();

  for (int t0 = t_begin; t0 < t_end; t0 += kTile) {
    const int n_valid = min(kTile, t_end - t0);
    uint4 kr[kLoads], vr[kLoads];
#pragma unroll
    for (int j = 0; j < kLoads; ++j) {
      const int vi = tid + j * kThreads;
      const int t = vi / kVecPerTok;
      kr[j] = make_uint4(0u, 0u, 0u, 0u);
      vr[j] = kr[j];
      if (t < n_valid) {
        const int pos = t0 + t;
        const long long row =
            (long long)table[pos / page_size] * page_size + pos % page_size;
        const long long off = row * kv_dim + (long long)kvh * D + (vi % kVecPerTok) * kVec;
        kr[j] = *reinterpret_cast<const uint4*>(k_pages + off);
        vr[j] = *reinterpret_cast<const uint4*>(v_pages + off);
      }
    }
#pragma unroll
    for (int j = 0; j < kLoads; ++j) {
      const int vi = tid + j * kThreads;
      const int t = vi / kVecPerTok;
      const int e0 = (vi % kVecPerTok) * kVec;
      float kf[kVec], vf[kVec];
      Vec16<T>::unpack(kr[j], kf);
      Vec16<T>::unpack(vr[j], vf);
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        k_s[t][e0 + e] = kf[e];
        v_s[t][e0 + e] = vf[e];
      }
    }
    __syncthreads();
    for (int h = warp; h < n_rep; h += kThreads / 32) {
      float s = 0.f;
#pragma unroll 16
      for (int e = 0; e < D; ++e) s = fmaf(q_s[h][e], k_s[lane][e], s);
      s = lane < n_valid ? s * scale : kNegInf;
      const float m_prev = m_s[h];
      const float m_new = fmaxf(m_prev, warp_max(s));
      const float shift = m_new <= kNegInf / 2 ? 0.f : m_new;
      const float p = expf(s - shift);
      const float corr = expf(m_prev - shift);
      const float psum = warp_sum(p);
      p_s[h][lane] = p;
      if (lane == 0) {
        corr_s[h] = corr;
        m_s[h] = m_new;
        l_s[h] = l_s[h] * corr + psum;
      }
    }
    __syncthreads();
    if (tid < D) {
#pragma unroll
      for (int h = 0; h < kMaxRep; ++h) {
        if (h < n_rep) {
          float a = acc[h] * corr_s[h];
          for (int t = 0; t < n_valid; ++t) a = fmaf(p_s[h][t], v_s[t][tid], a);
          acc[h] = a;
        }
      }
    }
    __syncthreads();
  }

  const long long base = ((long long)b * n_heads + (long long)kvh * n_rep) * n_split + split;
  if (tid < D) {
#pragma unroll
    for (int h = 0; h < kMaxRep; ++h) {
      if (h < n_rep) part_acc[(base + (long long)h * n_split) * D + tid] = acc[h];
    }
  }
  if (tid < n_rep) {
    part_m[base + (long long)tid * n_split] = m_s[tid];
    part_l[base + (long long)tid * n_split] = l_s[tid];
  }
}

// Pass 2: one block of D threads per (sequence, head) sums its partials.
template <typename T, int D>
__global__ void __launch_bounds__(D)
paged_combine_kernel(const float* __restrict__ part_m, const float* __restrict__ part_l,
                     const float* __restrict__ part_acc, T* __restrict__ out,
                     int n_split) {
  const long long bh = blockIdx.x;
  const int e = threadIdx.x;
  const float* m = part_m + bh * n_split;
  const float* l = part_l + bh * n_split;
  float m_max = kNegInf;
  for (int s = 0; s < n_split; ++s) m_max = fmaxf(m_max, m[s]);
  const float shift = m_max <= kNegInf / 2 ? 0.f : m_max;
  float l_sum = 0.f, a = 0.f;
  for (int s = 0; s < n_split; ++s) {
    const float w = expf(m[s] - shift);
    l_sum = fmaf(l[s], w, l_sum);
    a = fmaf(part_acc[(bh * n_split + s) * D + e], w, a);
  }
  out[bh * D + e] = from_f<T>(a / (l_sum == 0.f ? 1.f : l_sum));
}

template <typename T, int D>
int launch(const T* q, const T* k_pages, const T* v_pages, const int* lengths,
           const int* tables, T* out, float* scratch, int batch, int n_heads,
           int n_kv, int page_size, int pps, int n_split, cudaStream_t s) {
  const long long n_part = (long long)batch * n_heads * n_split;
  float* part_m = scratch;
  float* part_l = scratch + n_part;
  float* part_acc = scratch + 2 * n_part;
  paged_partial_kernel<T, D><<<dim3(n_kv, batch, n_split), kThreads, 0, s>>>(
      q, k_pages, v_pages, lengths, tables, part_m, part_l, part_acc, n_heads, n_kv,
      page_size, pps, n_split, 1.0f / sqrtf((float)D));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  paged_combine_kernel<T, D><<<batch * n_heads, D, 0, s>>>(part_m, part_l, part_acc,
                                                           out, n_split);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dim(const void* q, const void* k, const void* v, const int* lengths,
               const int* tables, void* out, float* scratch, int batch, int n_heads,
               int n_kv, int head_dim, int page_size, int pps, int n_split,
               cudaStream_t s) {
#define PAGED_CASE(D)                                                              \
  case D:                                                                          \
    return launch<T, D>((const T*)q, (const T*)k, (const T*)v, lengths, tables,   \
                        (T*)out, scratch, batch, n_heads, n_kv, page_size, pps,   \
                        n_split, s);
  switch (head_dim) {
    PAGED_CASE(32)
    PAGED_CASE(64)
    PAGED_CASE(128)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef PAGED_CASE
}

}  // namespace

// scratch: fp32, batch * n_heads * n_split * (head_dim + 2) elements, with
// n_split * 256 >= pages_per_seq * page_size.  dtype: 0 = float32,
// 1 = bfloat16.  Returns cudaGetLastError() after the launches.
extern "C" int paged_attention_launch(const void* q, const void* k_pages,
                                      const void* v_pages, const int* lengths,
                                      const int* block_tables, void* out,
                                      void* scratch, int batch, int n_heads, int n_kv,
                                      int head_dim, int page_size, int pages_per_seq,
                                      int n_split, int dtype, void* stream) {
  if (n_kv <= 0 || n_heads % n_kv != 0 || n_heads / n_kv > kMaxRep || batch <= 0 ||
      page_size <= 0 || pages_per_seq <= 0 || n_split <= 0 ||
      (long long)n_split * kChunk < (long long)pages_per_seq * page_size ||
      n_split > 65535 || batch > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) {
    return launch_dim<float>(q, k_pages, v_pages, lengths, block_tables, out,
                             (float*)scratch, batch, n_heads, n_kv, head_dim, page_size,
                             pages_per_seq, n_split, s);
  }
  if (dtype == 1) {
    return launch_dim<__nv_bfloat16>(q, k_pages, v_pages, lengths, block_tables, out,
                                     (float*)scratch, batch, n_heads, n_kv, head_dim,
                                     page_size, pages_per_seq, n_split, s);
  }
  return (int)cudaErrorInvalidValue;
}
