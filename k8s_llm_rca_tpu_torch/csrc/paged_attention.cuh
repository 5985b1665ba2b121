// Paged decode attention for Hopper (sm_90a): the one kernel body behind
// csrc/paged_attention.cu (fp32 and bf16 pools) and
// csrc/paged_attention_quant.cu (int8 and split-half int4 pools).
//
// Replaces: k8s_llm_rca_tpu/ops/paged_attention.py, Pallas kernels
// _paged_kernel (paged_attention) and _paged_kernel_quant
// (paged_attention_quant).  One query token per sequence attends over that
// sequence's KV pages in the shared pool; online softmax; keys at or past
// the sequence length are masked; GQA.  Layouts (the JAX package's):
//
//   q              [B, n_heads, d]                   fp32 / bf16
//   k/v pages      [n_pages, page, n_kv*d]           fp32 / bf16 / int8
//                  [n_pages, page, n_kv*d / 2]       int4, split-half
//   k/v scales     [n_pages, page] f32               int8 / int4 only
//   lengths [B] int32, block_tables [B, pages_per_seq] int32, out like q
//
// int4 packing is split-half over the whole merged row: byte i of a token
// row holds lane i in its low nibble and lane i + n_kv*d/2 in its high
// nibble.  The nibble of an 8-lane vector comes from its lane index
// (kvh*d + e0 >= n_kv*d/2), never from byte parity; n_kv*d/2 is a multiple
// of 16, so no vector straddles the half.  As in the Pallas kernel the
// scales never touch the pages: the k scale multiplies a token's score, the
// v scale its softmax weight before p.v (not the denominator).
//
// What bounds it on the H100: bytes (4 * n_rep flops per element read, far
// under the ~295 per byte of the tensor cores, and 0.6 us of fp32 FMA
// against >= 3 us of bytes at the 8B decode shapes).  So the design goes
// into memory parallelism and one launch, not into tensor cores (n_rep = 4
// query rows per kv-head would leave an m16 MMA three quarters empty).
//
// Design.  One thread block cluster per (kv-head, sequence), made of that
// sequence's splits: grid (n_kv, B, n_split), cluster (1, 1, n_split).
// The host's n_split (at most 8, the portable cluster size) gives a full
// table about a wave of busy blocks at two blocks an SM; the launcher
// lowers it until all n_kv * B clusters are resident at once
// (cudaOccupancyMaxActiveClusters), since a cluster left for a second wave
// would double the call.  A split covers `chunk` tokens, a multiple of the
// 8 warps; a split at or past the length exits before it loads anything
// (a cluster barrier waits only for blocks that have not exited), so short
// sequences free their SMs at once.  Each warp owns a contiguous run of
// chunk / 8 tokens and streams it through its own 12 KB cp.async ring:
// stages of kJ tokens per lane group, K rows, V rows and (int8/int4) the
// two scales, each 16-byte chunk of a row resolved through the block table
// (staged in shared memory once, loaded together with the queries and the
// length).  The next stages' loads are in flight while a stage is scored;
// tokens past the run are zero-filled (src-size 0) and read nothing.  No
// block-wide barrier sits in the token loop: a warp waits only on its own
// cp.async groups (__syncwarp).
//
// Inside a warp a lane group of d / kVec lanes holds one token's row, each
// lane kVec elements (fp32 4, bf16 8, int8/int4 8 from 8 bytes).  The
// scores of the group's kJ tokens for the n_rep query rows (q pre-scaled
// by log2(e)/sqrt(d) in shared memory) are kVec-long FMA chains; a
// butterfly within the group scatters the tokens over its lanes and adds
// the rest, so each lane ends with whole scores of one token for every
// row.  The stage's max per row goes across the warp, which keeps one
// (m, l) per row (the Pallas NEG_INF shift rule: a fully masked row keeps
// m = NEG_INF and shifts by 0) and rescales its sums only when a max rose.
// The weights p go to shared memory over the stage's consumed K rows, and
// each lane accumulates kVec output columns of every row over its group's
// tokens.  At the end the groups' sums meet by shuffles, the warps' states
// in shared memory (one __syncthreads), and the splits' states through
// distributed shared memory: after cluster.sync() each busy block reads
// every busy rank's (m, l, acc) in rank order and writes its share of the
// n_rep x d outputs, acc / (l == 0 ? 1 : l); a second cluster barrier
// keeps every block resident until the others have read it.  No atomics
// and no global scratch: two launches give the same bits.

#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace paged {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kJ = 4;                   // tokens a lane group scores per stage
constexpr int kRingBytes = 12 * 1024;   // one warp's cp.async ring
constexpr int kMaxRep = 8;              // query rows per kv-head
constexpr int kMaxSplits = 8;           // the portable cluster size
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// 2^x, flushing results under 2^-126 to zero (weights that small add
// nothing to an fp32 sum), in one instruction
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// 16 bytes global -> shared; ok = false fills zeros and reads nothing
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool ok) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ------------------------------------------------------------ load policies
//
// kBytes: stored bytes per lane of a head's row as it is staged (int4: one
// byte, of which one nibble is the lane's); kVec: lanes one thread
// converts from shared memory at a time; unpack: kVec lanes as fp32.

template <typename T> struct FloatPages;

template <> struct FloatPages<float> {
  static constexpr int kBytes = 4;
  static constexpr int kVec = 4;
  static constexpr bool kScaled = false;
  static constexpr bool kPacked = false;
  static __device__ __forceinline__ void unpack(const uint8_t* src, bool, float (&f)[kVec]) {
    const float4 r = *reinterpret_cast<const float4*>(src);
    f[0] = r.x;
    f[1] = r.y;
    f[2] = r.z;
    f[3] = r.w;
  }
};

template <> struct FloatPages<__nv_bfloat16> {
  static constexpr int kBytes = 2;
  static constexpr int kVec = 8;
  static constexpr bool kScaled = false;
  static constexpr bool kPacked = false;
  static __device__ __forceinline__ void unpack(const uint8_t* src, bool, float (&f)[kVec]) {
    const uint4 r = *reinterpret_cast<const uint4*>(src);
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {   // a bf16 is the top half of its fp32
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

// int8 (kPacked = false) or split-half int4 (true): 8 lanes from 8 bytes,
// sign-extended by shifts; int4 takes the high nibbles when `high`
template <bool kPackedPages> struct QuantPages {
  static constexpr int kBytes = 1;
  static constexpr int kVec = 8;
  static constexpr bool kScaled = true;
  static constexpr bool kPacked = kPackedPages;
  static __device__ __forceinline__ void unpack(const uint8_t* src, bool high, float (&f)[kVec]) {
    const uint2 r = *reinterpret_cast<const uint2*>(src);
#pragma unroll
    for (int b = 0; b < 8; ++b) {
      const uint32_t word = b < 4 ? r.x : r.y;
      const int i = b & 3;
      int v;
      if (kPacked) {
        v = ((int)(word << ((high ? 24 : 28) - 8 * i))) >> 28;
      } else {
        v = ((int)(word << (24 - 8 * i))) >> 24;
      }
      f[b] = (float)v;
    }
  }
};

// The stage geometry of a pool policy at head_dim D.
template <typename P, int D> struct Geo {
  static constexpr int kRowBytes = D * P::kBytes;           // one head's row
  static constexpr int kLanesPerTok = D / P::kVec;          // one lane group
  static constexpr int kGroups = 32 / kLanesPerTok;
  static constexpr int kStageTok = kJ * kGroups;
  static constexpr int kChunksPerTok = kRowBytes / 16;      // 16-byte loads
  static constexpr int kLoadsPerLane = kStageTok * kChunksPerTok / 32;
  static constexpr int kPoolBytes = kStageTok * kRowBytes;  // K (or V) of a stage
  static constexpr int kStageBytes = 2 * kPoolBytes + (P::kScaled ? 8 * kStageTok : 0);
  static constexpr int kStages = kRingBytes / kStageBytes;
  static_assert(kLanesPerTok <= 32 && 32 % kLanesPerTok == 0, "lane groups");
  static_assert(kStageTok * kChunksPerTok % 32 == 0, "a stage splits over the lanes");
  static_assert(kStageTok <= 32, "one scale per lane");
  static_assert(kStages >= 2, "a ring of two stages at least");
  static_assert(kStageBytes % 16 == 0, "16-byte aligned stages");
};

struct Args {
  const void* q;
  const uint8_t* k;
  const uint8_t* v;
  const float* k_scale;   // int8 / int4 pools only
  const float* v_scale;
  const int* lengths;
  const int* tables;
  void* out;
  unsigned row_stride;    // bytes between token rows of a pool
  int n_heads, n_kv, page_size, pps, n_split;
  int chunk;              // tokens per split, set by the launcher
  int half;               // int4: n_kv * d / 2
  int page_shift;         // log2(page_size), or -1 when it is not a power of 2
};

// The butterfly of a lane group over the scores of its kJ tokens, entry
// j * REP + h.  While a lane holds more than REP entries it keeps the half
// of its tokens that its lane bit names and adds its partner's sums of
// them (a reduce-scatter over tokens); then the rest of the levels add all
// REP entries whole.  Lane c of a group ends with the whole scores of
// token c * kJ / kL for every query row in s[0 .. REP), with static
// indices: a row index that varied by lane would put per-row arrays in
// local memory.
template <int REP, int O, int N> struct Butterfly {
  template <int NV> __device__ __forceinline__ static void run(float (&s)[NV], int lane) {
    if constexpr (O == 0) {
      return;
    } else if constexpr (N > REP) {
      const bool upper = lane & O;
#pragma unroll
      for (int i = 0; i < N / 2; ++i) {
        const float send = upper ? s[i] : s[i + N / 2];
        const float keep = upper ? s[i + N / 2] : s[i];
        s[i] = keep + __shfl_xor_sync(0xffffffffu, send, O);
      }
      Butterfly<REP, O / 2, N / 2>::run(s, lane);
    } else {
#pragma unroll
      for (int i = 0; i < REP; ++i) s[i] += __shfl_xor_sync(0xffffffffu, s[i], O);
      Butterfly<REP, O / 2, N>::run(s, lane);
    }
  }
};

template <int D, int REP> constexpr int shared_floats() {
  return REP * D + REP * D + 2 * REP;   // q, the block's acc, m and l
}

template <typename T, typename P, int D, int REP>
__global__ void __launch_bounds__(kThreads, REP > 4 ? 1 : 2)
paged_decode_kernel(const Args a) {
  using G = Geo<P, D>;
  constexpr int kVec = P::kVec;
  constexpr int kL = G::kLanesPerTok;
  constexpr int kS = G::kStages;
  constexpr int kDup = kL / kJ;   // lanes of a group that end with one token's scores
  static_assert(kL >= kJ && kL % kJ == 0, "a group scatters its tokens over its lanes");
  static_assert(REP * 4 <= G::kRowBytes, "p fits over the stage's K rows");
  extern __shared__ __align__(16) uint8_t smem[];
  float* q_s = reinterpret_cast<float*>(smem + kWarps * kRingBytes);   // [REP][D]
  float* part_acc = q_s + REP * D;                                      // [REP][D]
  float* part_m = part_acc + REP * D;                                   // [REP]
  float* part_l = part_m + REP;                                         // [REP]
  int* tab_s = reinterpret_cast<int*>(part_l + REP);

  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int split = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int n_rep = a.n_heads / a.n_kv;
  const int page = a.page_size;
  const int cap = a.pps * page;

  // the length, this split's table entries and the queries load together
  const int length_in = a.lengths[b];
  const int t_begin = split * a.chunk;
  const int page0 = t_begin / page;
  if (t_begin < cap) {
    const int n_tab = (min(cap, t_begin + a.chunk) - 1) / page - page0 + 1;
    const int* table = a.tables + (long long)b * a.pps + page0;
    for (int i = tid; i < n_tab; i += kThreads) tab_s[i] = table[i];
  }
  const T* q_b = reinterpret_cast<const T*>(a.q) +
                 ((long long)b * a.n_heads + (long long)kvh * n_rep) * D;
  const float q_scale = kLog2e / sqrtf((float)D);   // scores in log2 units
  for (int i = tid; i < REP * D; i += kThreads)
    q_s[i] = i < n_rep * D ? to_f(q_b[i]) * q_scale : 0.f;
  // never walk past the table: a slot that is not live may carry a length
  // beyond it (its output is discarded, its reads stay in bounds)
  const int length = min(max(length_in, 0), cap);
  const int t_end = min(length, t_begin + a.chunk);
  // the splits with tokens (split 0 always: it writes the output); the rest
  // leave now and free their SM, and the cluster's barriers wait only for
  // the blocks that have not exited
  const int n_busy = max(1, min(a.n_split, (length + a.chunk - 1) / a.chunk));
  if (split >= n_busy) return;
  __syncthreads();

  // -------------------------------------------------- this warp's run
  const int run = a.chunk / kWarps;
  const int w_begin = t_begin + warp * run;
  const int w_end = min(w_begin + run, t_end);
  const int n_st = w_begin < w_end ? (w_end - w_begin + G::kStageTok - 1) / G::kStageTok : 0;
  uint8_t* ring = smem + warp * kRingBytes;
  const int grp = lane / kL;   // the lane group: token grp of each kJ-group
  const int c = lane % kL;
  const int e0 = c * kVec;
  const bool high = P::kPacked && kvh * D + e0 >= a.half;
  const int my_j = c / kDup;           // the token whose scores this lane keeps
  const bool owner = c % kDup == 0;    // one lane of each token writes its p
  const int my_t = my_j * G::kGroups + grp;

  // a stage's loads: lane-constant tokens, chunks and offsets; the page of
  // each token from the stage's first one (a token lies fewer than 32
  // positions past it); tokens past the run read nothing
  auto load_stage = [&](uint8_t* base, int s0) {
    const int pg0 = a.page_shift >= 0 ? s0 >> a.page_shift : s0 / page;
    const int in0 = s0 - pg0 * page;
#pragma unroll
    for (int i = 0; i < G::kLoadsPerLane; ++i) {
      const int idx = lane + 32 * i;
      const int t = idx / G::kChunksPerTok;
      const int ch = idx % G::kChunksPerTok;
      const bool ok = s0 + t < w_end;
      int pg = pg0, in = in0 + (ok ? t : 0);
      while (in >= page) {
        in -= page;
        ++pg;
      }
      const unsigned row = (unsigned)tab_s[pg - page0] * (unsigned)page + (unsigned)in;
      const int lane0 = kvh * D + ch * (16 / P::kBytes);
      const unsigned byte0 = P::kPacked ? (lane0 >= a.half ? lane0 - a.half : lane0)
                                        : lane0 * P::kBytes;
      const unsigned long long off =
          ok ? (unsigned long long)row * a.row_stride + byte0 : 0ull;
      uint8_t* dst = base + t * G::kRowBytes + ch * 16;
      cp_async16(dst, a.k + off, ok);
      cp_async16(dst + G::kPoolBytes, a.v + off, ok);
    }
    if (P::kScaled && lane < G::kStageTok) {
      const bool ok = s0 + lane < w_end;
      int pg = pg0, in = in0 + (ok ? lane : 0);
      while (in >= page) {
        in -= page;
        ++pg;
      }
      const unsigned row = ok ? (unsigned)tab_s[pg - page0] * (unsigned)page + (unsigned)in : 0u;
      float* sc = reinterpret_cast<float*>(base + 2 * G::kPoolBytes);
      cp_async4(sc + lane, a.k_scale + row, ok);
      cp_async4(sc + G::kStageTok + lane, a.v_scale + row, ok);
    }
    cp_async_commit();
  };

  float m[REP], l[REP], acc[REP][kVec];
#pragma unroll
  for (int h = 0; h < REP; ++h) {
    m[h] = kNegInf;
    l[h] = 0.f;
#pragma unroll
    for (int e = 0; e < kVec; ++e) acc[h][e] = 0.f;
  }

  // the ring's slots, in turn: the next to fill and the next to score
  uint8_t* const ring_end = ring + kS * G::kStageBytes;
  uint8_t* fill = ring;
  uint8_t* base = ring;
#pragma unroll
  for (int st = 0; st < kS - 1; ++st) {
    if (st < n_st) load_stage(fill, w_begin + st * G::kStageTok);
    else cp_async_commit();   // empty groups keep the wait count uniform
    fill += G::kStageBytes;
  }
  for (int st = 0; st < n_st; ++st) {
    if (st + kS - 1 < n_st) load_stage(fill, w_begin + (st + kS - 1) * G::kStageTok);
    else cp_async_commit();
    fill = fill + G::kStageBytes == ring_end ? ring : fill + G::kStageBytes;
    cp_async_wait<kS - 1>();
    __syncwarp();
    const float* sc = reinterpret_cast<const float*>(base + 2 * G::kPoolBytes);
    const int s0 = w_begin + st * G::kStageTok;

    // partial scores of the group's kJ tokens: entry j * REP + h
    float s[kJ * REP];
    {
      float kf[kJ][kVec];
#pragma unroll
      for (int j = 0; j < kJ; ++j)
        P::unpack(base + (j * G::kGroups + grp) * G::kRowBytes + e0 * P::kBytes, high, kf[j]);
#pragma unroll
      for (int h = 0; h < REP; ++h) {
        const float4* qv = reinterpret_cast<const float4*>(q_s + h * D + e0);
        float4 qq[kVec / 4];
#pragma unroll
        for (int e4 = 0; e4 < kVec / 4; ++e4) qq[e4] = qv[e4];
#pragma unroll
        for (int j = 0; j < kJ; ++j) {
          float dot = 0.f;
#pragma unroll
          for (int e4 = 0; e4 < kVec / 4; ++e4) {
            dot = fmaf(qq[e4].x, kf[j][4 * e4], dot);
            dot = fmaf(qq[e4].y, kf[j][4 * e4 + 1], dot);
            dot = fmaf(qq[e4].z, kf[j][4 * e4 + 2], dot);
            dot = fmaf(qq[e4].w, kf[j][4 * e4 + 3], dot);
          }
          s[j * REP + h] = dot;
        }
      }
    }
    Butterfly<REP, kL / 2, kJ * REP>::run(s, lane);

    // this lane's token's scores, scaled and masked; the stage max per row
    // across the lanes that hold other tokens
    const bool valid = s0 + my_t < w_end;
    const float ks = P::kScaled ? sc[my_t] : 1.f;
    float shift[REP], corr[REP];
    bool moved = false;   // the same on every lane: m is the warp's
#pragma unroll
    for (int h = 0; h < REP; ++h) {
      s[h] = valid ? s[h] * ks : kNegInf;
      float mx = s[h];
#pragma unroll
      for (int off = kDup; off < 32; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[h], mx);
      shift[h] = m_new <= kNegInf / 2 ? 0.f : m_new;
      corr[h] = exp2_ftz(m[h] - shift[h]);
      moved |= m_new != m[h];
      m[h] = m_new;
    }
    if (moved) {   // a row's max rose: rescale what the warp holds
#pragma unroll
      for (int h = 0; h < REP; ++h) {
        l[h] *= corr[h];
#pragma unroll
        for (int e = 0; e < kVec; ++e) acc[h][e] *= corr[h];
      }
    }

    // the weights p over the stage's consumed K rows: [kStageTok][REP]
    __syncwarp();
    float* p_s = reinterpret_cast<float*>(base);
    const float vs = P::kScaled ? sc[G::kStageTok + my_t] : 1.f;
    float pw[REP];
#pragma unroll
    for (int h = 0; h < REP; ++h) {
      const float p = exp2_ftz(s[h] - shift[h]);
      l[h] += owner ? p : 0.f;
      pw[h] = p * vs;   // the v scale weights p.v, not the denominator
    }
    if (owner) {
      if constexpr (REP % 4 == 0) {
#pragma unroll
        for (int h4 = 0; h4 < REP / 4; ++h4)
          reinterpret_cast<float4*>(p_s + my_t * REP)[h4] =
              make_float4(pw[4 * h4], pw[4 * h4 + 1], pw[4 * h4 + 2], pw[4 * h4 + 3]);
      } else {
#pragma unroll
        for (int h2 = 0; h2 < REP / 2; ++h2)
          reinterpret_cast<float2*>(p_s + my_t * REP)[h2] = make_float2(pw[2 * h2], pw[2 * h2 + 1]);
      }
    }
    __syncwarp();

    // p.v: tokens past the run are zeros with p = 0
#pragma unroll
    for (int j = 0; j < kJ; ++j) {
      const int t = j * G::kGroups + grp;
      float vf[kVec];
      P::unpack(base + G::kPoolBytes + t * G::kRowBytes + e0 * P::kBytes, high, vf);
      float pr[REP];
      if constexpr (REP % 4 == 0) {
#pragma unroll
        for (int h4 = 0; h4 < REP / 4; ++h4) {
          const float4 p4 = reinterpret_cast<const float4*>(p_s + t * REP)[h4];
          pr[4 * h4] = p4.x;
          pr[4 * h4 + 1] = p4.y;
          pr[4 * h4 + 2] = p4.z;
          pr[4 * h4 + 3] = p4.w;
        }
      } else {
#pragma unroll
        for (int h2 = 0; h2 < REP / 2; ++h2) {
          const float2 p2 = reinterpret_cast<const float2*>(p_s + t * REP)[h2];
          pr[2 * h2] = p2.x;
          pr[2 * h2 + 1] = p2.y;
        }
      }
#pragma unroll
      for (int h = 0; h < REP; ++h)
#pragma unroll
        for (int e = 0; e < kVec; ++e) acc[h][e] = fmaf(pr[h], vf[e], acc[h][e]);
    }
    __syncwarp();   // the slot is read before the next loads overwrite it
    base = base + G::kStageBytes == ring_end ? ring : base + G::kStageBytes;
  }
  cp_async_wait<0>();
  __syncwarp();

  // -------------------------------------- the lanes, then the warps
#pragma unroll
  for (int h = 0; h < REP; ++h) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) l[h] += __shfl_xor_sync(0xffffffffu, l[h], off);
#pragma unroll
    for (int off = kL; off < 32; off <<= 1)
#pragma unroll
      for (int e = 0; e < kVec; ++e) acc[h][e] += __shfl_xor_sync(0xffffffffu, acc[h][e], off);
  }
  float* wsc = reinterpret_cast<float*>(ring);   // [REP] m, [REP] l, [REP][D] acc
  if (lane == 0) {
#pragma unroll
    for (int h = 0; h < REP; ++h) {
      wsc[h] = m[h];
      wsc[REP + h] = l[h];
    }
  }
  if (grp == 0) {
#pragma unroll
    for (int h = 0; h < REP; ++h)
#pragma unroll
      for (int e4 = 0; e4 < kVec / 4; ++e4)
        *reinterpret_cast<float4*>(wsc + 2 * REP + h * D + e0 + 4 * e4) =
            make_float4(acc[h][4 * e4], acc[h][4 * e4 + 1], acc[h][4 * e4 + 2],
                        acc[h][4 * e4 + 3]);
  }
  __syncthreads();
  for (int i = tid; i < REP * D; i += kThreads) {
    const int h = i / D;
    float wm[kWarps];
    float mb = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      wm[w] = reinterpret_cast<const float*>(smem + w * kRingBytes)[h];
      mb = fmaxf(mb, wm[w]);
    }
    const float shift = mb <= kNegInf / 2 ? 0.f : mb;
    float lb = 0.f, ab = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float* ws = reinterpret_cast<const float*>(smem + w * kRingBytes);
      const float wt = exp2_ftz(wm[w] - shift);
      lb = fmaf(ws[REP + h], wt, lb);
      ab = fmaf(ws[2 * REP + i], wt, ab);
    }
    part_acc[i] = ab;
    if (i % D == 0) {
      part_m[h] = mb;
      part_l[h] = lb;
    }
  }

  // ------------------------------------- the busy splits, in rank order
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  if (n_busy > 1) cluster.sync();
  else __syncthreads();
  T* out = reinterpret_cast<T*>(a.out) + ((long long)b * a.n_heads + (long long)kvh * n_rep) * D;
  for (int i = split * kThreads + tid; i < n_rep * D; i += n_busy * kThreads) {
    const int h = i / D;
    float rm[kMaxSplits], rl[kMaxSplits], ra[kMaxSplits];
#pragma unroll
    for (int r = 0; r < kMaxSplits; ++r) {   // every rank's loads in flight at once
      rm[r] = r < n_busy ? cluster.map_shared_rank(part_m, r)[h] : kNegInf;
      rl[r] = r < n_busy ? cluster.map_shared_rank(part_l, r)[h] : 0.f;
      ra[r] = r < n_busy ? cluster.map_shared_rank(part_acc, r)[i] : 0.f;
    }
    float mx = kNegInf;
#pragma unroll
    for (int r = 0; r < kMaxSplits; ++r) mx = fmaxf(mx, rm[r]);
    const float shift = mx <= kNegInf / 2 ? 0.f : mx;
    float lsum = 0.f, asum = 0.f;
#pragma unroll
    for (int r = 0; r < kMaxSplits; ++r) {
      const float wt = exp2_ftz(rm[r] - shift);
      lsum = fmaf(rl[r], wt, lsum);
      asum = fmaf(ra[r], wt, asum);
    }
    out[i] = from_f<T>(__fdividef(asum, lsum == 0.f ? 1.f : lsum));
  }
  if (n_busy > 1) {
    // every rank's state is read before its block exits (the reads are
    // done before this thread arrives; nothing is published, so relaxed)
    asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
    asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  }
}

// Tokens per split for n_split splits of a table of `cap` tokens: a
// multiple of the warps (tests/test_torch_cuda.py mirrors it).
inline int split_chunk(int cap, int n_split) {
  const int per = (cap + n_split - 1) / n_split;
  return (per + kWarps - 1) / kWarps * kWarps;
}

inline int log2_exact(int x) {
  int s = 0;
  while ((1 << s) < x) ++s;
  return (1 << s) == x ? s : -1;
}

// Launches at most `a.n_split` splits: fewer when the batch's n_kv * batch
// clusters of that many blocks would not all be resident at once (a
// cluster left for a second wave would double the call's time).  With
// `splits` set it launches nothing and stores the count it would take.
template <typename T, typename P, int D, int REP>
int launch(Args a, int batch, cudaStream_t stream, int* splits) {
  const auto kernel = paged_decode_kernel<T, P, D, REP>;
  const int n_tab = a.pps + 2;   // the most pages a split's span touches
  const size_t smem = (size_t)kWarps * kRingBytes + sizeof(float) * shared_floats<D, REP>() +
                      sizeof(int) * n_tab;
  static size_t sized = 0;
  static int resident[kMaxSplits + 1];   // clusters of n blocks resident at once
  if (smem != sized) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    sized = smem;
    for (int n = 0; n <= kMaxSplits; ++n) resident[n] = -1;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const long long clusters = (long long)a.n_kv * batch;
  for (int n = a.n_split;; --n) {
    attr[0].val.clusterDim.z = n;
    cfg.gridDim = dim3(a.n_kv, batch, n);
    if (resident[n] < 0) {
      const cudaError_t err = cudaOccupancyMaxActiveClusters(&resident[n], kernel, &cfg);
      if (err != cudaSuccess) return (int)err;
    }
    if (resident[n] >= clusters || n == 1) {
      if (resident[n] < 1) return (int)cudaErrorLaunchOutOfResources;
      a.n_split = n;
      break;
    }
  }
  if (splits) {
    *splits = a.n_split;
    return (int)cudaSuccess;
  }
  a.chunk = split_chunk(a.pps * a.page_size, a.n_split);
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// Instantiates the kernel for head_dim 32, 64, 128 and n_rep rounded up to
// 2, 4 or 8 query rows per kv-head.
template <typename T, typename P>
int launch_shape(const Args& a, int batch, int head_dim, cudaStream_t stream, int* splits) {
  const int n_rep = a.n_heads / a.n_kv;
  const int rep = n_rep <= 2 ? 2 : n_rep <= 4 ? 4 : 8;
#define PAGED_CASE(D, R) \
  if (head_dim == D && rep == R) return launch<T, P, D, R>(a, batch, stream, splits);
  PAGED_CASE(32, 2) PAGED_CASE(32, 4) PAGED_CASE(32, 8)
  PAGED_CASE(64, 2) PAGED_CASE(64, 4) PAGED_CASE(64, 8)
  PAGED_CASE(128, 2) PAGED_CASE(128, 4) PAGED_CASE(128, 8)
#undef PAGED_CASE
  return (int)cudaErrorInvalidValue;
}

// The checks both entry points share: true when the shapes are taken.
inline bool shapes_ok(int batch, int n_heads, int n_kv, int page_size, int pps, int n_split) {
  return n_kv > 0 && n_kv <= 65535 && n_heads % n_kv == 0 && n_heads / n_kv <= kMaxRep &&
         batch > 0 && batch <= 65535 && page_size > 0 && pps > 0 && n_split > 0 &&
         n_split <= kMaxSplits && (long long)pps * page_size <= 0x7fffffffLL;
}

}  // namespace paged
