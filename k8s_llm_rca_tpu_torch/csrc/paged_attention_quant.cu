// Paged decode attention over a quantized KV pool for Hopper (sm_90a), plain
// C interface for ctypes.
//
// Replaces: k8s_llm_rca_tpu/ops/paged_attention.py::paged_attention_quant
// (Pallas kernel _paged_kernel_quant).  The pool holds int8 pages, or
// split-half int4 pages, with one f32 scale per token and pool (k, v):
//
//   q              [B, n_heads, d]                      float32 / bfloat16
//   k/v pages      [n_pages, page_size, n_kv*d]      int8             (int8)
//                  [n_pages, page_size, n_kv*d / 2]  int8 packed      (int4)
//   k/v scales     [n_pages, page_size] float32
//   lengths        [B] int32, block_tables [B, pages_per_seq] int32
//   out            [B, n_heads, d] in q's type
//
// The packing is split-half over the whole merged row: byte i of a token
// row holds lane i in its low nibble and lane i + n_kv*d/2 in its high
// nibble, so (n_kv = 8, d = 128) kv-heads 0-3 are the low nibbles and 4-7
// the high nibbles of the same 512 bytes.  A head's 16-lane vector lies on
// one side of the half (n_kv*d/2 is a multiple of 16): its nibble is chosen
// by its lane index, never by byte parity.  As in the Pallas kernel the
// scales never touch the pages: the k scale multiplies a token's score, the
// v scale the token's softmax weight before p.v (not the denominator).
//
// What bounds it on the H100: bytes, as for the bf16 pool, with a quarter
// (int4) or half (int8) of the page bytes plus 8 bytes of scales a token.
//
// Design: that of paged_attention.cu (pass 1: one block of 128 threads per
// (kv-head, sequence, 256-token split), 32 tokens staged a step with every
// 16-byte load issued before any is used; pass 2 combines the splits),
// with the loads changed to int8 or packed bytes unpacked by 32-bit shifts
// and each valid token's two scales read by bounds.  The Pallas kernel
// selects scale rows with a where-then-sum guard against NaN in padding
// rows it fetches; here no row at or past the length is read at all.  An
// int4 byte carries two heads, and each head's block reads it: the int4
// pool is read twice, mostly from L2.

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

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// 16 lanes of one token row as fp32.  int8: 16 signed bytes.  int4: the
// low (high = false) or high nibbles of 16 bytes, sign-extended.
template <bool kPacked>
__device__ __forceinline__ void unpack16(const uint4& r, bool high, float (&out)[16]) {
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int b = 0; b < 16; ++b) {
    const uint32_t word = w[b >> 2];
    const int i = b & 3;
    int v;
    if (kPacked) {
      v = high ? ((int)(word << (24 - 8 * i))) >> 28 : ((int)(word << (28 - 8 * i))) >> 28;
    } else {
      v = ((int)(word << (24 - 8 * i))) >> 24;
    }
    out[b] = (float)v;
  }
}

// Pass 1: partial softmax of one (kv-head, sequence, split).  Partials are
// indexed ((b * n_heads + head) * n_split + split).
template <typename T, int D, bool kPacked>
__global__ void __launch_bounds__(kThreads)
paged_quant_partial_kernel(const T* __restrict__ q, const int8_t* __restrict__ k_pages,
                           const int8_t* __restrict__ v_pages,
                           const float* __restrict__ k_scale,
                           const float* __restrict__ v_scale, const int* __restrict__ lengths,
                           const int* __restrict__ tables, float* __restrict__ part_m,
                           float* __restrict__ part_l, float* __restrict__ part_acc,
                           int n_heads, int n_kv, int page_size, int pps, int n_split,
                           float scale) {
  constexpr int kVecPerTok = D / 16;             // 16-lane vectors of one head
  constexpr int kVecs = kTile * kVecPerTok;
  constexpr int kLoads = (kVecs + kThreads - 1) / kThreads;
  static_assert(D % 32 == 0 && D <= kThreads, "head_dim");

  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int split = blockIdx.z;
  const int n_rep = n_heads / n_kv;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int kv_dim = n_kv * D;
  const int half = kv_dim / 2;
  const long long row_bytes = kPacked ? half : kv_dim;

  __shared__ float q_s[kMaxRep][D];
  __shared__ float k_s[kTile][D + 1];   // +1: conflict-free row-per-lane reads
  __shared__ float v_s[kTile][D];
  __shared__ float ks_s[kTile];
  __shared__ float vs_s[kTile];
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
      if (vi < kVecs && t < n_valid) {
        const int pos = t0 + t;
        const long long row =
            (long long)table[pos / page_size] * page_size + pos % page_size;
        const int lane0 = kvh * D + (vi % kVecPerTok) * 16;
        const int byte0 = (kPacked && lane0 >= half) ? lane0 - half : lane0;
        const long long off = row * row_bytes + byte0;
        kr[j] = *reinterpret_cast<const uint4*>(k_pages + off);
        vr[j] = *reinterpret_cast<const uint4*>(v_pages + off);
      }
    }
    if (tid < kTile) {
      float ks = 0.f, vs = 0.f;
      if (tid < n_valid) {
        const int pos = t0 + tid;
        const long long row =
            (long long)table[pos / page_size] * page_size + pos % page_size;
        ks = k_scale[row];
        vs = v_scale[row];
      }
      ks_s[tid] = ks;
      vs_s[tid] = vs;
    }
#pragma unroll
    for (int j = 0; j < kLoads; ++j) {
      const int vi = tid + j * kThreads;
      if (vi >= kVecs) continue;
      const int t = vi / kVecPerTok;
      const int e0 = (vi % kVecPerTok) * 16;
      const bool high = kPacked && kvh * D + e0 >= half;
      float kf[16], vf[16];
      unpack16<kPacked>(kr[j], high, kf);
      unpack16<kPacked>(vr[j], high, vf);
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        k_s[t][e0 + e] = kf[e];
        v_s[t][e0 + e] = vf[e];
      }
    }
    __syncthreads();
    for (int h = warp; h < n_rep; h += kThreads / 32) {
      float s = 0.f;
#pragma unroll 16
      for (int e = 0; e < D; ++e) s = fmaf(q_s[h][e], k_s[lane][e], s);
      s = lane < n_valid ? s * scale * ks_s[lane] : kNegInf;
      const float m_prev = m_s[h];
      const float m_new = fmaxf(m_prev, warp_max(s));
      const float shift = m_new <= kNegInf / 2 ? 0.f : m_new;
      const float p = expf(s - shift);
      const float corr = expf(m_prev - shift);
      const float psum = warp_sum(p);
      p_s[h][lane] = p * vs_s[lane];   // the v scale weights p.v, not the sum
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
paged_quant_combine_kernel(const float* __restrict__ part_m, const float* __restrict__ part_l,
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

struct Args {
  const void* q;
  const int8_t* k_pages;
  const int8_t* v_pages;
  const float* k_scale;
  const float* v_scale;
  const int* lengths;
  const int* tables;
  void* out;
  float* scratch;
  int batch, n_heads, n_kv, page_size, pps, n_split;
  cudaStream_t stream;
};

template <typename T, int D, bool kPacked>
int launch(const Args& a) {
  const long long n_part = (long long)a.batch * a.n_heads * a.n_split;
  float* part_m = a.scratch;
  float* part_l = a.scratch + n_part;
  float* part_acc = a.scratch + 2 * n_part;
  paged_quant_partial_kernel<T, D, kPacked>
      <<<dim3(a.n_kv, a.batch, a.n_split), kThreads, 0, a.stream>>>(
          (const T*)a.q, a.k_pages, a.v_pages, a.k_scale, a.v_scale, a.lengths, a.tables,
          part_m, part_l, part_acc, a.n_heads, a.n_kv, a.page_size, a.pps, a.n_split,
          1.0f / sqrtf((float)D));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  paged_quant_combine_kernel<T, D><<<a.batch * a.n_heads, D, 0, a.stream>>>(
      part_m, part_l, part_acc, (T*)a.out, a.n_split);
  return (int)cudaGetLastError();
}

template <typename T, bool kPacked>
int launch_dim(const Args& a, int head_dim) {
  switch (head_dim) {
    case 32: return launch<T, 32, kPacked>(a);
    case 64: return launch<T, 64, kPacked>(a);
    case 128: return launch<T, 128, kPacked>(a);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int launch_packed(const Args& a, int head_dim, int packed) {
  return packed ? launch_dim<T, true>(a, head_dim) : launch_dim<T, false>(a, head_dim);
}

}  // namespace

// scratch: fp32, batch * n_heads * n_split * (head_dim + 2) elements, with
// n_split * 256 >= pages_per_seq * page_size.  packed: 0 = int8 pages
// [.., n_kv*head_dim], 1 = split-half int4 [.., n_kv*head_dim/2].  dtype
// (q and out): 0 = float32, 1 = bfloat16.  The pages are 16-byte aligned.
// Returns cudaGetLastError() after the launches.
extern "C" int paged_attention_quant_launch(
    const void* q, const void* k_pages, const void* v_pages, const void* k_scale,
    const void* v_scale, const int* lengths, const int* block_tables, void* out,
    void* scratch, int batch, int n_heads, int n_kv, int head_dim, int page_size,
    int pages_per_seq, int n_split, int packed, int dtype, void* stream) {
  if (n_kv <= 0 || n_heads % n_kv != 0 || n_heads / n_kv > kMaxRep || batch <= 0 ||
      page_size <= 0 || pages_per_seq <= 0 || n_split <= 0 ||
      (long long)n_split * kChunk < (long long)pages_per_seq * page_size ||
      n_split > 65535 || batch > 65535 || n_kv > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const Args a{q, (const int8_t*)k_pages, (const int8_t*)v_pages, (const float*)k_scale,
               (const float*)v_scale, lengths, block_tables, out, (float*)scratch,
               batch, n_heads, n_kv, page_size, pages_per_seq, n_split,
               (cudaStream_t)stream};
  if (dtype == 0) return launch_packed<float>(a, head_dim, packed);
  if (dtype == 1) return launch_packed<__nv_bfloat16>(a, head_dim, packed);
  return (int)cudaErrorInvalidValue;
}
