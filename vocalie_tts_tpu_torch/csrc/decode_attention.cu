// q_len == 1 decode attention over one layer of the stacked KV cache, read
// in place, with the current token's k/v merged unquantized: the int8
// whole-row kernel (B1w) in one block first, then the f32 kernel of K1, K2
// and B10, then the int8 T-blocked kernel (B1), then B1w split, which share
// the f32 kernel's split over a thread-block cluster (see their own notes
// below).
//
// The TPU's lane-packed k|v layout is not copied: k and v are separate
// [L, b, kv, T, d] int8 arrays (bf16 scales [L, b, kv, T]) or float arrays.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#define TBLK 128
#define NTHREADS 128
#define NWARPS (NTHREADS / 32)
#define MAX_G 8
#define MAX_D 128

__device__ __forceinline__ float block_max(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float r = red[0];
#pragma unroll
  for (int i = 1; i < NWARPS; ++i) r = fmaxf(r, red[i]);
  return r;
}

__device__ __forceinline__ float block_sum(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float r = red[0];
#pragma unroll
  for (int i = 1; i < NWARPS; ++i) r += red[i];
  return r;
}

// ---------------------------------------------------------------------------
// B1w: the int8 decode attention with ONE softmax over the whole cache row.
//
// Replaces: vocalie_tts_tpu/ops/decode_attention.py::decode_attention_stacked
// on its non-T-blocked int8 branches, _kernel_stacked_int8dots[_new] (:190,
// :260; pallas_call :844) and, over the lane-packed cache,
// _kernel_stacked_int8dots_packed (:268; pallas_call :808), which JAX takes
// for an int8 cache whose length is not a 128-multiple, or without k_new or
// valid_len. The packed kernel's selector matmuls are exact, so over the
// split cache it is this function too. The math, step for step:
//   * q is quantized once per (row, head, group member), as in B1;
//   * s = (float(q8 . k) * (qs * sm_scale)) * ks + bias for every slot read;
//   * ONE max over those slots; with k_new, the current token's exact score
//     s_new = sum(q * k_new) * sm_scale joins the max BEFORE exp;
//   * p = exp(s - m), l = sum(p) (before the v scales);
//   * p * vs is re-quantized to int8 with ONE scale over the whole row,
//     ps = max(max(p * vs) / 127, 1e-20) -- not one per 128-slot block;
//   * o = float(p8 . v) * ps; with k_new, p_new = exp(s_new - m) adds
//     p_new * v_new to o and p_new to l; out = o / max(l, 1e-30).
// Slots read (n_slots, from the wrapper): with k_new and valid_len, the
// first max(valid_len, 1) -- a slot at or past valid_len is masked in the
// decode step, so its p is exactly 0, its score is below s_new, and skipping
// it changes nothing; otherwise all T (a fully masked row then spreads its
// softmax over every slot, as in JAX).
//
// Bound: bytes, as B1: each (row, kv head) reads its slots' k and v rows
// (d int8 each), two bf16 scales and the 4-byte bias.
//
// Design (first, simple version): one block of 128 threads per (row, kv
// head). Because p's scale spans the whole row, every score is kept until
// the row's max and p-max are known: the g x T scores live in dynamic
// shared memory (g*T*4 bytes, 2.4 KB for the T3 at T 600) or, past what a
// block holds, in a global workspace the wrapper allocates; they are
// computed once and never recomputed. Pass 1: thread t owns slots t,
// t + 128, ...: int8 dots with __dp4a, scores stored, block max. Pass 2:
// p, l and the p-max. Pass 3: each thread quantizes its own slots in place.
// PV: each thread owns 4 output columns (one int32 word of a v row) over a
// slice of the slots, sums p8 * v in int32 (exact in any order), and the
// slices meet in shared memory through integer atomics. No tensor cores,
// no TMA. Since the split body at the end of this file
// (attend_int8_whole_kernel), this one runs only for a row that 16 blocks'
// shared memory cannot hold, and as that body's yardstick (one_block=True).

#define WHOLE_SMEM_MAX (200 * 1024)   // scores in shared memory up to this size

__global__ void __launch_bounds__(NTHREADS) decode_attention_int8_whole_kernel(
    const float* __restrict__ q,                  // [BC, g, d]
    const int8_t* __restrict__ k_all,             // [L, BC, T, d]
    const int8_t* __restrict__ v_all,             // [L, BC, T, d]
    const __nv_bfloat16* __restrict__ ks_all,     // [L, BC, T]
    const __nv_bfloat16* __restrict__ vs_all,     // [L, BC, T]
    const float* __restrict__ bias,               // [b, T]
    const float* __restrict__ k_new,              // [BC, d] or null
    const float* __restrict__ v_new,              // [BC, d] or null
    float* __restrict__ out,                      // [BC, g, d]
    float* __restrict__ ws,                       // [BC, g, T] scores, or null
    int BC, int kv, int T, int d, int g, int layer, int n, float sm_scale) {
  extern __shared__ float sc_dyn[];
  __shared__ __align__(16) int8_t q8_s[MAX_G * MAX_D];
  __shared__ int o_s[MAX_G * MAX_D];
  __shared__ float qs_s[MAX_G], m_s[MAX_G], l_s[MAX_G], ps_s[MAX_G], snew_s[MAX_G];
  __shared__ float red[NWARPS];

  const int bc = blockIdx.x;
  const int row = bc / kv;
  const int tid = threadIdx.x;
  const bool with_new = k_new != nullptr;
  const float* qb = q + (long long)bc * g * d;
  float* sc = ws != nullptr ? ws + (long long)bc * g * T : sc_dyn;   // [g, T]

  // quantize q once per group member
  for (int gi = 0; gi < g; ++gi) {
    const float a = tid < d ? fabsf(qb[gi * d + tid]) : 0.0f;
    const float qs = fmaxf(block_max(a, red) / 127.0f, 1e-8f);
    if (tid < d) q8_s[gi * d + tid] = (int8_t)__float2int_rn(qb[gi * d + tid] / qs);
    if (tid == 0) qs_s[gi] = qs;
  }
  for (int o = tid; o < g * d; o += NTHREADS) o_s[o] = 0;
  if (with_new && tid < g) {   // the current token's score, unquantized
    const float* knb = k_new + (long long)bc * d;
    float s = 0.0f;
    for (int dd = 0; dd < d; ++dd) s = __fadd_rn(s, __fmul_rn(qb[tid * d + dd], knb[dd]));
    snew_s[tid] = __fmul_rn(s, sm_scale);
  }
  __syncthreads();

  const long long lrow = (long long)layer * BC + bc;
  const int8_t* kb = k_all + lrow * T * d;
  const int8_t* vb = v_all + lrow * T * d;
  const __nv_bfloat16* ksb = ks_all + lrow * T;
  const __nv_bfloat16* vsb = vs_all + lrow * T;
  const float* brow = bias + (long long)row * T;

  // pass 1: scores and their max
  float mloc[MAX_G];
#pragma unroll
  for (int gi = 0; gi < MAX_G; ++gi) mloc[gi] = -INFINITY;
  for (int t = tid; t < n; t += NTHREADS) {
    const int4* kr = reinterpret_cast<const int4*>(kb + (long long)t * d);
    int dot[MAX_G];
#pragma unroll
    for (int gi = 0; gi < MAX_G; ++gi) dot[gi] = 0;
    for (int w = 0; w < d / 16; ++w) {
      const int4 kk = kr[w];
#pragma unroll
      for (int gi = 0; gi < MAX_G; ++gi) {
        if (gi < g) {
          const int4 qq = reinterpret_cast<const int4*>(q8_s + gi * d)[w];
          dot[gi] = __dp4a(kk.x, qq.x, dot[gi]);
          dot[gi] = __dp4a(kk.y, qq.y, dot[gi]);
          dot[gi] = __dp4a(kk.z, qq.z, dot[gi]);
          dot[gi] = __dp4a(kk.w, qq.w, dot[gi]);
        }
      }
    }
    const float ksc = __bfloat162float(ksb[t]);
    const float bb = brow[t];
#pragma unroll
    for (int gi = 0; gi < MAX_G; ++gi) {
      if (gi < g) {
        float s = __fmul_rn((float)dot[gi], __fmul_rn(qs_s[gi], sm_scale));
        s = __fadd_rn(__fmul_rn(s, ksc), bb);
        sc[gi * T + t] = s;
        mloc[gi] = fmaxf(mloc[gi], s);
      }
    }
  }
#pragma unroll
  for (int gi = 0; gi < MAX_G; ++gi) {
    if (gi < g) {
      float m = block_max(mloc[gi], red);
      if (with_new) m = fmaxf(m, snew_s[gi]);
      if (tid == 0) m_s[gi] = m;
    }
  }
  __syncthreads();

  // pass 2: p, its sum, p * vs and its max
  float lloc[MAX_G], ploc[MAX_G];
#pragma unroll
  for (int gi = 0; gi < MAX_G; ++gi) lloc[gi] = ploc[gi] = 0.0f;
  for (int t = tid; t < n; t += NTHREADS) {
    const float vsc = __bfloat162float(vsb[t]);
#pragma unroll
    for (int gi = 0; gi < MAX_G; ++gi) {
      if (gi < g) {
        const float p = expf(sc[gi * T + t] - m_s[gi]);
        lloc[gi] = __fadd_rn(lloc[gi], p);
        const float pv = __fmul_rn(p, vsc);   // fold the v scales in before quantizing
        sc[gi * T + t] = pv;
        ploc[gi] = fmaxf(ploc[gi], pv);
      }
    }
  }
#pragma unroll
  for (int gi = 0; gi < MAX_G; ++gi) {
    if (gi < g) {
      const float l = block_sum(lloc[gi], red);
      const float pa = block_max(ploc[gi], red);
      if (tid == 0) {
        l_s[gi] = l;
        ps_s[gi] = fmaxf(pa / 127.0f, 1e-20f);
      }
    }
  }
  __syncthreads();

  // pass 3: p quantized with the row's one scale, in place (own slots only;
  // the int8 values are kept as exact floats)
  for (int t = tid; t < n; t += NTHREADS) {
    for (int gi = 0; gi < g; ++gi) {
      sc[gi * T + t] = (float)__float2int_rn(sc[gi * T + t] / ps_s[gi]);
    }
  }
  __syncthreads();

  // PV: thread (slice, word) sums p8 * v over its slots for 4 columns
  const int nw = d / 4;
  const int slices = NTHREADS / nw;
  const int w = tid % nw, sl = tid / nw;
  if (sl < slices) {
    int acc[MAX_G][4];
#pragma unroll
    for (int gi = 0; gi < MAX_G; ++gi) acc[gi][0] = acc[gi][1] = acc[gi][2] = acc[gi][3] = 0;
    const int* vw = reinterpret_cast<const int*>(vb);
    for (int t = sl; t < n; t += slices) {
      const int vv = __ldg(vw + (long long)t * nw + w);
      const int v0 = (int)(int8_t)(vv & 0xff), v1 = (int)(int8_t)((vv >> 8) & 0xff);
      const int v2 = (int)(int8_t)((vv >> 16) & 0xff), v3 = (int)(int8_t)((vv >> 24) & 0xff);
#pragma unroll
      for (int gi = 0; gi < MAX_G; ++gi) {
        if (gi < g) {
          const int p = __float2int_rz(sc[gi * T + t]);
          acc[gi][0] += p * v0;
          acc[gi][1] += p * v1;
          acc[gi][2] += p * v2;
          acc[gi][3] += p * v3;
        }
      }
    }
#pragma unroll
    for (int gi = 0; gi < MAX_G; ++gi) {
      if (gi < g) {
#pragma unroll
        for (int j = 0; j < 4; ++j) atomicAdd(&o_s[gi * d + 4 * w + j], acc[gi][j]);
      }
    }
  }
  __syncthreads();

  // o * ps, the current token merged exactly, then / max(l, 1e-30)
  float* ob = out + (long long)bc * g * d;
  for (int o = tid; o < g * d; o += NTHREADS) {
    const int gi = o / d, dd = o - gi * d;
    float val = __fmul_rn(__int2float_rn(o_s[o]), ps_s[gi]);
    float l = l_s[gi];
    if (with_new) {
      const float p_new = expf(snew_s[gi] - m_s[gi]);
      l = __fadd_rn(l, p_new);
      val = __fadd_rn(val, __fmul_rn(p_new, v_new[(long long)bc * d + dd]));
    }
    ob[o] = val / fmaxf(l, 1e-30f);
  }
}

// Bytes of global workspace B1w needs for its scores: 0 where a block's
// shared memory holds them.
extern "C" long long vt_attn_whole_workspace(int b, int kv, int g, int T) {
  const long long row = (long long)g * T * 4;
  return row <= WHOLE_SMEM_MAX ? 0 : (long long)b * kv * row;
}

extern "C" int vt_decode_attention_int8_whole(
    const void* q, const void* k_all, const void* v_all,
    const void* k_scale, const void* v_scale, const void* bias,
    const void* k_new, const void* v_new, void* out, void* ws, long long ws_bytes,
    int b, int kv, int g, int d, int T, int layer, int n_slots,
    float sm_scale, void* stream) {
  if (g < 1 || g > MAX_G || d < 16 || d > MAX_D || d % 16 != 0 || n_slots < 1 || n_slots > T ||
      (k_new == nullptr) != (v_new == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  const long long need = vt_attn_whole_workspace(b, kv, g, T);
  if (need > 0 && (ws == nullptr || ws_bytes < need)) return (int)cudaErrorInvalidValue;
  const int smem = need > 0 ? 0 : g * T * 4;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        decode_attention_int8_whole_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        WHOLE_SMEM_MAX);
    if (e != cudaSuccess) return (int)e;
  }
  decode_attention_int8_whole_kernel<<<b * kv, NTHREADS, smem, (cudaStream_t)stream>>>(
      (const float*)q, (const int8_t*)k_all, (const int8_t*)v_all,
      (const __nv_bfloat16*)k_scale, (const __nv_bfloat16*)v_scale,
      (const float*)bias, (const float*)k_new, (const float*)v_new, (float*)out,
      need > 0 ? (float*)ws : nullptr, b * kv, kv, T, d, g, layer, n_slots, sm_scale);
  return (int)cudaGetLastError();
}



// ---------------------------------------------------------------------------
// The f32 kernel: decode attention with every product in f32, one cache row
// split over the blocks of a thread-block cluster.
//
// Replaces three Pallas kernels of vocalie_tts_tpu/ops/decode_attention.py
// that share _attend_chunk's math (:150-176):
//   * K1: decode_attention_stacked's bf16 branch, _kernel_stacked_plain[_new]
//     (:538, :554; pallas_call :844), over a bf16 or f32 cache (mode PLAIN);
//   * K2: its f32-dequant branch, _kernel_stacked_quant[_new] (:512, :530;
//     :844), over the int8 cache: scores times sm_scale * ks, v times vs
//     before the PV product (mode DEQUANT);
//   * B10: decode_attention (:85; _kernel_quant :49, _kernel_plain :67;
//     pallas_call :126), one unstacked layer without a current token:
//     scores times sm_scale, then ks; p times vs after its sum (mode B10;
//     PLAIN without scales).
// The math: s = q.k in f32, times the score factor, plus the [b, T] bias;
// softmax over the slots and, where given, the current token's score
// s_new = sum(q * k_new) * sm_scale; o = p.v + p_new * v_new; o / max(l, 1e-30).
// JAX takes the max over all slots first; here each lane group keeps a
// running max, and the partial softmaxes are merged with rescaling (the
// same result up to f32 rounding; every merge maps exp(-inf - -inf) to 0).
//
// With the current token merged, the wrapper passes the number of slots to
// read (the valid length): past it every slot is masked, its probability
// is exactly 0 and its score is below the current token's, so skipping it
// changes nothing. Without one, every slot is read.
//
// Bound: bytes. Each (row, kv head) reads its slots' k and v once (2 or 4
// bytes an element; int8 plus two scales for K2/B10) and the bias row. One
// query row per q head makes 0.5-2 operations a byte: the tensor cores do
// not help; moving the bytes at the card's rate is the whole game.
//
// Design: split over the slots, merged inside the one launch.
//   * Each (row, kv head) gets a cluster of `splits` blocks (ops/
//     decode_attention.py attend_splits: doubled while the pairs have fewer
//     than 2 blocks per SM, every block keeps at least 16 slots, at most 16
//     blocks, and all the clusters stay resident at once: a second wave of
//     clusters cost more than the extra blocks gained, e.g. the Qwen3 cache
//     at 8 blocks a pair, 64 clusters where the H100 keeps 62). Block r
//     takes slots [r * chunk, min((r + 1) * chunk, n_slots)), chunk =
//     ceil(n_slots / splits); a range past n_slots is empty (m = -inf,
//     l = 0, acc = 0).
//   * Inside a block (4 warps), a lane holds E consecutive elements of a row
//     (16 bytes where g allows: E = min(16 / elem, 32 / G), G = g rounded
//     up to a power of two, so that q and the accumulators take at most 64
//     registers); a group of LG lanes (d / E rounded up to a power of two)
//     covers one row, so one warp load covers 32 / LG whole, contiguous
//     rows. q stays in registers in the lane's own columns; a score is the
//     group's partial dots reduced by __shfl_xor_sync; each lane adds p.v
//     over the same columns of V, so the PV product never leaves registers.
//   * Bytes in flight: a lane loads its k and v slices of ATT_UNROLL rows
//     (and their bias and scales) before it uses the first, 4 KB a warp.
//     Register loads were taken over a cp.async ring: ~16 resident warps x
//     4 KB an SM is several times what the card's bandwidth-latency product
//     needs, and 8 rows a pass (ATT_UNROLL 8) measured no faster.
//   * Each lane group runs the online softmax over its rows (one max and
//     one rescale per ATT_UNROLL rows); at the end of the range the groups
//     merge by an xor butterfly and the warps in order through shared
//     memory. After cluster.sync() the blocks share out the outputs: each
//     reads every rank's (m, l, acc) for its slice from the ranks' shared
//     memory (distributed shared memory), merges them in rank order,
//     ATT_MERGE ranks a round trip, merges the current token last, divides
//     and writes out. A second cluster.sync() keeps every block's shared
//     memory alive until the others have read it. No atomics, no global
//     scratch, no second pass: the sum is deterministic.
//   * Launched by cudaLaunchKernelEx with a cluster dimension attribute
//     (1-16; past 8 after cudaFuncAttributeNonPortableClusterSizeAllowed).
// ptxas (sm_90a, CUDA 12.8; chip_smoke.py's build log): 0 spill bytes in
// all 20 instantiations; bf16 cache G 1 80 registers, G 2 104 (the served
// K1 shapes), int8 + bf16 scales G 1 107, f32 cache G 1 64; G 8 168.

#include <cooperative_groups.h>

namespace cg = cooperative_groups;

#define ATT_THREADS 128
#define ATT_WARPS (ATT_THREADS / 32)
#define ATT_UNROLL 4          // rows a lane group loads before it uses the first
#define ATT_MAX_SPLITS 16     // blocks a cluster (16 is a non-portable size)
#define ATT_MERGE 4           // ranks rank 0 reads in one round trip

enum { MODE_PLAIN = 0, MODE_DEQUANT = 1, MODE_B10 = 2 };

// A lane's slice of a cache row: E elements of CT, kept as 32-bit words
// until used (4, 8 or 16 bytes, one load; the wider ones stream past L1
// and ask L2 to fetch the 256-byte line: a warp reads whole rows).
template <typename CT, int E>
struct Slice {
  static constexpr int BYTES = E * (int)sizeof(CT);
  static constexpr int W = BYTES / 4;
  uint32_t w[W];
  __device__ __forceinline__ void load(const CT* p) {
    if constexpr (BYTES == 16) {
      asm volatile("ld.global.nc.L1::no_allocate.L2::256B.v4.u32 {%0, %1, %2, %3}, [%4];"
                   : "=r"(w[0]), "=r"(w[1]), "=r"(w[2]), "=r"(w[3]) : "l"(p));
    } else if constexpr (BYTES == 8) {
      asm volatile("ld.global.nc.L1::no_allocate.L2::256B.v2.u32 {%0, %1}, [%2];"
                   : "=r"(w[0]), "=r"(w[1]) : "l"(p));
    } else {
      w[0] = __ldg(reinterpret_cast<const unsigned int*>(p));
    }
  }
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < W; ++i) w[i] = 0u;
  }
  // element j as f32 (j is a constant after unrolling)
  __device__ __forceinline__ float at(int j) const {
    if constexpr (sizeof(CT) == 4) {
      return __uint_as_float(w[j]);
    } else if constexpr (sizeof(CT) == 2) {   // bf16: element 2i is word i's low half
      return __uint_as_float((j & 1) ? (w[j >> 1] & 0xffff0000u) : (w[j >> 1] << 16));
    } else {                                  // int8, sign-extended
      return (float)((int)(w[j >> 2] << (24 - 8 * (j & 3))) >> 24);
    }
  }
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// exp(m - m_ref), 0 for an empty state (m = -inf), whatever m_ref is
__device__ __forceinline__ float rescale(float m, float m_ref) {
  return m == -INFINITY ? 0.0f : expf(m - m_ref);
}

template <typename CT, typename ST, int MODE, int G>
__global__ void __launch_bounds__(ATT_THREADS) attend_split_kernel(
    const float* __restrict__ q,        // [BC, g, d]
    const CT* __restrict__ k_all,       // [L * BC, T, d]; this layer's rows start at row0
    const CT* __restrict__ v_all,
    const ST* __restrict__ ks_all,      // [L * BC, T] (MODE != PLAIN)
    const ST* __restrict__ vs_all,
    const float* __restrict__ bias,     // [b, T]
    const float* __restrict__ k_new,    // [BC, d] or null
    const float* __restrict__ v_new,
    float* __restrict__ out,            // [BC, g, d]
    long long row0, int kv, int T, int d, int g, int n_slots, int splits, float sm_scale) {
  constexpr int VN = 16 / (int)sizeof(CT);
  constexpr int E = VN < 32 / G ? VN : 32 / G;
  constexpr int U = ATT_UNROLL;
  __shared__ float wm[ATT_WARPS][G], wl[ATT_WARPS][G];
  __shared__ __align__(16) float wacc[ATT_WARPS][G * MAX_D];
  __shared__ float bm[G], bl[G];
  __shared__ __align__(16) float bacc[G * MAX_D];
  __shared__ float snew_s[G];

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int bc = blockIdx.x / splits;
  const int row = bc / kv;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int lg = 1;
  while (lg * E < d) lg <<= 1;             // lanes a row, a power of two
  const int lig = lane & (lg - 1), grp = lane / lg, rpw = 32 / lg;
  const int col0 = lig * E;
  const bool colv = col0 < d;              // lanes past d (d / E not a power of two) idle

  const int chunk = (n_slots + splits - 1) / splits;
  const int lo = rank * chunk;
  const int hi = min(lo + chunk, n_slots);

  // q in registers, the lane's own columns (zero past g and d)
  float qr[G][E];
  const float* qb = q + (long long)bc * g * d;
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
#pragma unroll
    for (int j = 0; j < E; j += 4) {
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (gi < g && colv) x = *reinterpret_cast<const float4*>(qb + gi * d + col0 + j);
      qr[gi][j] = x.x; qr[gi][j + 1] = x.y; qr[gi][j + 2] = x.z; qr[gi][j + 3] = x.w;
    }
  }

  // the current token's score, unquantized (warp 0 of every rank; every
  // lane group computes it, lane 0 keeps it)
  if (k_new != nullptr && warp == 0) {
    float kn[E];
#pragma unroll
    for (int j = 0; j < E; j += 4) {
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (colv) x = *reinterpret_cast<const float4*>(k_new + (long long)bc * d + col0 + j);
      kn[j] = x.x; kn[j + 1] = x.y; kn[j + 2] = x.z; kn[j + 3] = x.w;
    }
#pragma unroll
    for (int gi = 0; gi < G; ++gi) {
      float a = 0.0f;
#pragma unroll
      for (int j = 0; j < E; ++j) a = fmaf(qr[gi][j], kn[j], a);
      for (int o = 1; o < lg; o <<= 1) a += __shfl_xor_sync(0xffffffffu, a, o);
      if (lane == 0) snew_s[gi] = __fmul_rn(a, sm_scale);
    }
  }

  const long long lrow = row0 + bc;
  const CT* kb = k_all + lrow * T * d;
  const CT* vb = v_all + lrow * T * d;
  const float* brow = bias + (long long)row * T;

  float m[G], l[G], acc[G][E];
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
    m[gi] = -INFINITY;
    l[gi] = 0.0f;
#pragma unroll
    for (int j = 0; j < E; ++j) acc[gi][j] = 0.0f;
  }

  // a warp takes rpw * U rows a pass: load u covers rows base + u * rpw ..
  // + rpw - 1 (contiguous bytes); lane group grp takes row base + u * rpw + grp
  const int step = rpw * U;
  for (int base = lo + warp * step; base < hi; base += step * ATT_WARPS) {
    Slice<CT, E> kr[U], vr[U];
    float bb[U], ksc[U], vsc[U];
    bool live[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int t = base + u * rpw + grp;
      live[u] = t < hi;
      if (live[u] && colv) {
        kr[u].load(kb + (long long)t * d + col0);
        vr[u].load(vb + (long long)t * d + col0);
      } else {
        kr[u].zero();
        vr[u].zero();
      }
      bb[u] = live[u] ? __ldg(brow + t) : 0.0f;
      ksc[u] = vsc[u] = 1.0f;
      if (MODE != MODE_PLAIN && live[u]) {
        ksc[u] = to_f32(ks_all[lrow * T + t]);
        vsc[u] = to_f32(vs_all[lrow * T + t]);
      }
    }
    float s[U][G];
#pragma unroll
    for (int u = 0; u < U; ++u) {
#pragma unroll
      for (int gi = 0; gi < G; ++gi) {
        float a = 0.0f;
#pragma unroll
        for (int j = 0; j < E; ++j) a = fmaf(qr[gi][j], kr[u].at(j), a);
        s[u][gi] = a;
      }
    }
    for (int o = 1; o < lg; o <<= 1) {
#pragma unroll
      for (int u = 0; u < U; ++u) {
#pragma unroll
        for (int gi = 0; gi < G; ++gi) s[u][gi] += __shfl_xor_sync(0xffffffffu, s[u][gi], o);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
#pragma unroll
      for (int gi = 0; gi < G; ++gi) {
        float x = s[u][gi];
        if (MODE == MODE_PLAIN) x = __fadd_rn(__fmul_rn(x, sm_scale), bb[u]);
        if (MODE == MODE_DEQUANT) x = __fadd_rn(__fmul_rn(x, __fmul_rn(sm_scale, ksc[u])), bb[u]);
        if (MODE == MODE_B10) x = __fadd_rn(__fmul_rn(__fmul_rn(x, sm_scale), ksc[u]), bb[u]);
        s[u][gi] = live[u] ? x : -INFINITY;
      }
    }
    // one max and one rescale per U rows; s becomes p
#pragma unroll
    for (int gi = 0; gi < G; ++gi) {
      float mx = m[gi];
#pragma unroll
      for (int u = 0; u < U; ++u) mx = fmaxf(mx, s[u][gi]);
      const float corr = mx == -INFINITY ? 1.0f : rescale(m[gi], mx);
      float psum = 0.0f;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        s[u][gi] = live[u] ? expf(s[u][gi] - mx) : 0.0f;
        psum = __fadd_rn(psum, s[u][gi]);
      }
      l[gi] = __fadd_rn(__fmul_rn(l[gi], corr), psum);
      m[gi] = mx;
#pragma unroll
      for (int j = 0; j < E; ++j) acc[gi][j] = __fmul_rn(acc[gi][j], corr);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float vf[E];
#pragma unroll
      for (int j = 0; j < E; ++j) {
        vf[j] = vr[u].at(j);
        if (MODE == MODE_DEQUANT) vf[j] = __fmul_rn(vf[j], vsc[u]);
      }
#pragma unroll
      for (int gi = 0; gi < G; ++gi) {
        const float pv = MODE == MODE_B10 ? __fmul_rn(s[u][gi], vsc[u]) : s[u][gi];
#pragma unroll
        for (int j = 0; j < E; ++j) acc[gi][j] = fmaf(pv, vf[j], acc[gi][j]);
      }
    }
  }

  // the lane groups of a warp merge by an xor butterfly: group 0 ends with
  // the warp's state
  for (int o = lg; o < 32; o <<= 1) {
#pragma unroll
    for (int gi = 0; gi < G; ++gi) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[gi], o);
      const float lo_ = __shfl_xor_sync(0xffffffffu, l[gi], o);
      const float mn = fmaxf(m[gi], mo);
      const float ca = rescale(m[gi], mn), cb = rescale(mo, mn);
      l[gi] = __fadd_rn(__fmul_rn(l[gi], ca), __fmul_rn(lo_, cb));
#pragma unroll
      for (int j = 0; j < E; ++j) {
        const float ao = __shfl_xor_sync(0xffffffffu, acc[gi][j], o);
        acc[gi][j] = __fadd_rn(__fmul_rn(acc[gi][j], ca), __fmul_rn(ao, cb));
      }
      m[gi] = mn;
    }
  }
  if (grp == 0) {
#pragma unroll
    for (int gi = 0; gi < G; ++gi) {
      if (lig == 0) {
        wm[warp][gi] = m[gi];
        wl[warp][gi] = l[gi];
      }
      if (colv) {
#pragma unroll
        for (int j = 0; j < E; ++j) wacc[warp][gi * d + col0 + j] = acc[gi][j];
      }
    }
  }
  __syncthreads();
  // the block's state: its warps merged in order
  for (int e = tid; e < G * d; e += ATT_THREADS) {
    const int gi = e / d;
    float M = -INFINITY;
#pragma unroll
    for (int w = 0; w < ATT_WARPS; ++w) M = fmaxf(M, wm[w][gi]);
    float L = 0.0f, A = 0.0f;
#pragma unroll
    for (int w = 0; w < ATT_WARPS; ++w) {
      const float c = rescale(wm[w][gi], M);
      L = fmaf(c, wl[w][gi], L);
      A = fmaf(c, wacc[w][e], A);
    }
    bacc[e] = A;
    if (e - gi * d == 0) {
      bm[gi] = M;
      bl[gi] = L;
    }
  }
  cluster.sync();   // every rank's state is written

  {   // the ranks merged in order, then the current token
    // The cluster's blocks share the outputs out: rank r takes a slice of
    // the g * d elements and, for each, runs a merge over ATT_MERGE ranks
    // at a time, their (m, l, acc) read together from distributed shared
    // memory (one round trip), so no one SM carries all the remote reads.
    const int per = (g * d + splits - 1) / splits;
    const int e_hi = min((rank + 1) * per, g * d);
    float* ob = out + (long long)bc * g * d;
    for (int e = rank * per + tid; e < e_hi; e += ATT_THREADS) {
      const int gi = e / d;
      float M = -INFINITY, A = 0.0f, L = 0.0f;
      for (int r0 = 0; r0 < splits; r0 += ATT_MERGE) {
        float mr[ATT_MERGE], lr[ATT_MERGE], ar[ATT_MERGE];
#pragma unroll
        for (int j = 0; j < ATT_MERGE; ++j) {
          mr[j] = -INFINITY;
          lr[j] = ar[j] = 0.0f;
          if (r0 + j < splits) {
            mr[j] = cluster.map_shared_rank(bm, r0 + j)[gi];
            lr[j] = cluster.map_shared_rank(bl, r0 + j)[gi];
            ar[j] = cluster.map_shared_rank(bacc, r0 + j)[e];
          }
        }
        float mn = M;
#pragma unroll
        for (int j = 0; j < ATT_MERGE; ++j) mn = fmaxf(mn, mr[j]);
        const float c = rescale(M, mn);
        A = __fmul_rn(A, c);
        L = __fmul_rn(L, c);
#pragma unroll
        for (int j = 0; j < ATT_MERGE; ++j) {
          const float w = rescale(mr[j], mn);
          A = fmaf(w, ar[j], A);
          L = fmaf(w, lr[j], L);
        }
        M = mn;
      }
      if (k_new != nullptr) {
        const float s_new = snew_s[gi];
        const float m_fin = fmaxf(M, s_new);
        const float c = expf(M - m_fin), p_new = expf(s_new - m_fin);
        A = fmaf(p_new, v_new[(long long)bc * d + (e - gi * d)], __fmul_rn(A, c));
        L = __fadd_rn(__fmul_rn(L, c), p_new);
      }
      ob[e] = A / fmaxf(L, 1e-30f);
    }
  }
  cluster.sync();   // no block leaves before the others have read its shared memory
}

// Launches the split kernel; with `clusters` set, stores instead how many
// clusters of `splits` blocks the card keeps resident at once
// (cudaOccupancyMaxActiveClusters), which attend_splits reads.
template <typename CT, typename ST, int MODE, int G>
static int launch_attend(const void* q, const void* k_all, const void* v_all, const void* ks,
                         const void* vs, const void* bias, const void* k_new, const void* v_new,
                         void* out, long long row0, int BC, int kv, int T, int d, int g,
                         int n_slots, int splits, float sm_scale, cudaStream_t stream,
                         int* clusters) {
  void (*kern)(const float*, const CT*, const CT*, const ST*, const ST*, const float*,
               const float*, const float*, float*, long long, int, int, int, int, int, int,
               float) = attend_split_kernel<CT, ST, MODE, G>;
  if (splits > 8) {
    static bool wide = false;   // set once per instantiation
    if (!wide) {
      const cudaError_t e =
          cudaFuncSetAttribute(kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
      if (e != cudaSuccess) return (int)e;
      wide = true;
    }
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(BC * splits), 1, 1);
  cfg.blockDim = dim3(ATT_THREADS, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (clusters != nullptr) return (int)cudaOccupancyMaxActiveClusters(clusters, kern, &cfg);
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, kern, (const float*)q, (const CT*)k_all, (const CT*)v_all, (const ST*)ks,
      (const ST*)vs, (const float*)bias, (const float*)k_new, (const float*)v_new, (float*)out,
      row0, kv, T, d, g, n_slots, splits, sm_scale);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// The instantiation the codes and g select (G = g rounded up to a power of
// two), launched or queried as launch_attend says.
static int dispatch_attend(const void* q, const void* k_all, const void* v_all,
                           const void* k_scale, const void* v_scale, const void* bias,
                           const void* k_new, const void* v_new, void* out, int cache, int scale,
                           int mode, long long row0, int BC, int kv, int g, int d, int T,
                           int n_slots, int splits, float sm_scale, cudaStream_t st,
                           int* clusters) {
#define VT_ATTEND(CT, ST, MODE, G)                                                           \
  launch_attend<CT, ST, MODE, G>(q, k_all, v_all, k_scale, v_scale, bias, k_new, v_new, out, \
                                 row0, BC, kv, T, d, g, n_slots, splits, sm_scale, st,       \
                                 clusters)
#define VT_ATTEND_G(CT, ST, MODE)                                           \
  (g <= 1 ? VT_ATTEND(CT, ST, MODE, 1) : g <= 2 ? VT_ATTEND(CT, ST, MODE, 2) \
   : g <= 4 ? VT_ATTEND(CT, ST, MODE, 4) : VT_ATTEND(CT, ST, MODE, 8))
  if (mode == MODE_PLAIN && scale == 0) {
    if (cache == 0) return VT_ATTEND_G(float, float, MODE_PLAIN);
    if (cache == 1) return VT_ATTEND_G(__nv_bfloat16, float, MODE_PLAIN);
  } else if (cache == 2 && mode == MODE_DEQUANT && scale == 1) {
    return VT_ATTEND_G(int8_t, __nv_bfloat16, MODE_DEQUANT);
  } else if (cache == 2 && mode == MODE_B10) {
    if (scale == 1) return VT_ATTEND_G(int8_t, __nv_bfloat16, MODE_B10);
    if (scale == 2) return VT_ATTEND_G(int8_t, float, MODE_B10);
  }
#undef VT_ATTEND_G
#undef VT_ATTEND
  return (int)cudaErrorInvalidValue;
}

// cache: 0 f32, 1 bf16, 2 int8; scale: 0 none, 1 bf16, 2 f32;
// mode: 0 PLAIN (float cache, no scales), 1 DEQUANT, 2 B10 (int8 + scales);
// splits: the cluster's blocks per (row, kv head), 1..16 (attend_splits)
extern "C" int vt_attend_f32(
    const void* q, const void* k_all, const void* v_all, const void* k_scale,
    const void* v_scale, const void* bias, const void* k_new, const void* v_new, void* out,
    int cache, int scale, int mode, long long row0, int b, int kv, int g, int d, int T,
    int n_slots, int splits, float sm_scale, void* stream) {
  if (g < 1 || g > MAX_G || d < 16 || d > MAX_D || d % 16 != 0 || n_slots < 1 || n_slots > T ||
      splits < 1 || splits > ATT_MAX_SPLITS || (k_new == nullptr) != (v_new == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  return dispatch_attend(q, k_all, v_all, k_scale, v_scale, bias, k_new, v_new, out, cache,
                         scale, mode, row0, b * kv, kv, g, d, T, n_slots, splits, sm_scale,
                         (cudaStream_t)stream, nullptr);
}

// Clusters of `splits` blocks the card keeps resident at once for the
// instantiation vt_attend_f32 would launch with these codes and g.
extern "C" int vt_attend_clusters(int cache, int scale, int mode, int g, int splits,
                                  int* clusters) {
  if (g < 1 || g > MAX_G || splits < 1 || splits > ATT_MAX_SPLITS || clusters == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  return dispatch_attend(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                         nullptr, cache, scale, mode, 0, 1, 1, g, 16, 16, 1, splits, 1.0f,
                         nullptr, clusters);
}


// ---------------------------------------------------------------------------
// B1: the int8 T-blocked decode attention, split over a thread-block cluster.
//
// Replaces: vocalie_tts_tpu/ops/decode_attention.py::decode_attention_stacked
// on its int8 T-blocked branches, _kernel_stacked_int8dots_packed_tblk
// (:344; pallas_call :704) and _kernel_stacked_int8dots_tblk (:439;
// pallas_call :780), which compute the same numbers (:466-494):
//   * q is quantized once per (row, head, group member):
//     qs = max(max|q| / 127, 1e-8), q8 = round_half_even(q / qs);
//   * s = (float(q8 . k8) * (qs * sm_scale)) * ks + bias, the dot in int32;
//   * for each 128-slot block j below ceil(valid_len / 128) (at least one):
//     m_j = max(m_{j-1}, max s) from -1e30, corr = exp(m_{j-1} - m_j),
//     p = exp(s - m_j), l = l * corr + sum p, pv = p * vs,
//     ps = max(max pv / 127, 1e-20), p8 = round(pv / ps),
//     acc = acc * corr + float(p8 . v8) * ps;
//   * the current token's k/v join in f32 at the end, out = o / max(l, 1e-30).
//
// p8 is a rounding: one flip moves an output by ~|v| / 127, far past the
// 5e-4 gate. So every block's p must be taken against the same running max
// m_j, with the same IEEE steps and expf, as the sequential chain.
//
// Bound: bytes. Each (row, kv head) reads, for every slot of its valid
// blocks, d int8 of k and of v, two bf16 scales and the 4-byte bias.
//
// Design: each (row, kv head) gets a cluster of `splits` blocks (ops/
// decode_attention.py int8_splits: at most n_blk, every block a whole
// number of 128-slot blocks, all clusters resident in one wave). Rank r
// takes blocks [r * n_blk / splits, (r + 1) * n_blk / splits).
//   0. Every load that depends on nothing goes first: q, the first block's
//      k rows into registers (a lane holds E int8 of a row, 16 bytes where
//      g allows; a group of LG lanes covers a row, so one warp load reads
//      32 / LG whole rows, contiguous), each lane's own row's scales and
//      bias, and the first block's v rows into a two-slot ring in shared
//      memory by 16-byte cp.async, in flight through everything up to the
//      p8 . v product; a later block's v rows are asked for when the chain
//      reaches the block before it. Asking for more at once (every block's
//      k in two register sets, two blocks of v; or k and v both through
//      shared memory) ran slower at both main shapes: the bytes needed
//      first then wait behind the others (PERF.md §6).
//   1. Scores. q quantized in registers in the lane's own columns; a row's
//      dot is the group's __dp4a partials, reduced by a transposing
//      butterfly (LG - 1 shuffles a group member for LG rows, each lane
//      ending with the whole dot of row lig of its group), scaled and
//      biased by that lane into shared memory.
//   2. Each block's max per group member, and the rank's max, published.
//      cluster.sync(). Rank r's chain starts at the prefix max of ranks
//      0..r-1 (read through distributed shared memory), so its m_j are the
//      sequential chain's.
//   3. The chain over the rank's own blocks: one warp per group member
//      takes the block's 128 scores (4 a lane) for m_j, p, l and the p8;
//      every lane group then adds p8 * v over its rows from shared memory
//      in int32 (exact in any order), the groups meet by xor shuffles and
//      the warps by shared integer atomics, and acc = acc * corr + o * ps.
//   4. cluster.sync(). The ranks share the g * d outputs out; each output
//      merges every rank's (m, l, acc) in rank order, c = exp(M - m_r),
//      A = A * c + acc_r, L = L * c + l_r (for a rank of one block these
//      are the chain's own steps, so acc is the chain's to the bit; only l
//      sums its 128 p in another order), then the current token, divides
//      and writes. A last cluster.sync() keeps the shared memory alive
//      until every rank has read it.
// With `stamps` set, thread 0 of every block writes the card's ns clock at
// the I8_STAMPS phase points (ops/decode_attention.py INT8_STAMP_POINTS).

#define I8_SMEM_MAX (160 * 1024)   // dynamic shared bytes a block may take
#define I8_STAMPS 8

// shared bytes of a rank with nbm blocks: the scores, v scales and block
// maxima, and one or two 128-slot blocks of v (ops/decode_attention.py
// int8_smem says the same)
__host__ __device__ __forceinline__ int i8_bmax_words(int G, int nbm) {
  return (nbm * G + 3) & ~3;   // the v rows after them start on 16 bytes
}
__host__ __device__ __forceinline__ int i8_smem_bytes(int G, int nbm, int d) {
  return (G * nbm * TBLK + nbm * TBLK + i8_bmax_words(G, nbm)) * 4 +
         (nbm > 1 ? 2 : 1) * TBLK * d;
}

__device__ __forceinline__ void i8_stamp(unsigned long long* stamps, int i) {
  if (stamps != nullptr && threadIdx.x == 0) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    stamps[blockIdx.x * I8_STAMPS + i] = t;
  }
}

// 16-byte copies of one 128-slot block of v rows (TBLK * d bytes) into
// shared dst by the block's threads, as one cp.async group
__device__ __forceinline__ void i8_copy_v(int8_t* dst, const int8_t* src, int d) {
  const uint32_t base = (uint32_t)__cvta_generic_to_shared(dst);
  for (int i = threadIdx.x; i < TBLK * d / 16; i += ATT_THREADS) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(base + 16 * i), "l"(src + 16 * i) : "memory");
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// int8 byte j of word w, sign-extended
__device__ __forceinline__ int i8_byte(uint32_t w, int j) {
  return (int)(w << (24 - 8 * j)) >> 24;
}

// A lane's share of one 128-slot block: its k slices (NU rows) and its own
// row's k scale, bias and v scale.
template <int E, int NU>
struct I8Rows {
  Slice<int8_t, E> k[NU];
  float ksc, bias, vs;
};

template <int G, int LG>
__global__ void __launch_bounds__(ATT_THREADS) attend_int8_tblk_kernel(
    const float* __restrict__ q,                  // [BC, g, d]
    const int8_t* __restrict__ k_all,             // [L * BC, T, d]; this layer's rows from row0
    const int8_t* __restrict__ v_all,
    const __nv_bfloat16* __restrict__ ks_all,     // [L * BC, T]
    const __nv_bfloat16* __restrict__ vs_all,
    const float* __restrict__ bias,               // [b, T]
    const float* __restrict__ k_new,              // [BC, d]
    const float* __restrict__ v_new,
    float* __restrict__ out,                      // [BC, g, d]
    unsigned long long* __restrict__ stamps,      // [grid, I8_STAMPS] or null
    long long row0, int kv, int T, int d, int g, int n_blk, int splits, float sm_scale) {
  constexpr int E = 16 < 32 / G ? 16 : 32 / G;   // int8 columns a lane holds
  constexpr int EW = E / 4;
  constexpr int RPW = 32 / LG;                    // rows a warp load covers
  constexpr int NU = LG;                          // rows a lane group takes of a block
  extern __shared__ __align__(16) float dyn[];    // sc [G][nbm * TBLK], vsc, bmax, v rows
  __shared__ int p8s[G][TBLK];
  __shared__ int osum[G * MAX_D];
  __shared__ float acc_s[G * MAX_D];
  __shared__ float rmax_s[G], m_s[G], l_s[G], corr_s[G], ps_s[G], snew_s[G];

  i8_stamp(stamps, 0);
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int bc = blockIdx.x / splits;
  const int row = bc / kv;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int lig = lane & (LG - 1), grp = lane / LG;
  const int col0 = lig * E;
  const bool colv = col0 < d;              // lanes past d (d / E not a power of two) idle
  const int gd = g * d;

  const int nbm = (n_blk + splits - 1) / splits;
  const int blo = rank * n_blk / splits, bhi = (rank + 1) * n_blk / splits;
  const int nb = bhi - blo;
  const int scs = nbm * TBLK;
  float* sc = dyn;
  float* vsc = dyn + G * scs;
  float* bmax = vsc + scs;
  int8_t* vbuf = reinterpret_cast<int8_t*>(bmax + i8_bmax_words(G, nbm));   // [2][TBLK * d]
  const int vslot = TBLK * d;

  const long long lrow = row0 + bc;
  const int8_t* kb = k_all + lrow * T * d;
  const int8_t* vb = v_all + lrow * T * d;
  const __nv_bfloat16* ksb = ks_all + lrow * T;
  const __nv_bfloat16* vsb = vs_all + lrow * T;
  const float* brow = bias + (long long)row * T;
  // row u of a lane group in a block: (u * ATT_WARPS + warp) * RPW + grp;
  // one warp load covers the RPW rows of one u, contiguous. The lane's own
  // row (whose score it writes) is u = lig.
  const int own = (lig * ATT_WARPS + warp) * RPW + grp;

  // 0. q and the current token's k, then the first block's k rows, own
  // scales and bias, and its v rows, all in flight before any is used (a
  // rank's later blocks' k rows are loaded as it reaches them)
  const float* qb = q + (long long)bc * gd;
  float4 qx[G][E / 4], knx[E / 4];
#pragma unroll
  for (int j = 0; j < E / 4; ++j) {
    knx[j] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (colv) knx[j] = *reinterpret_cast<const float4*>(k_new + (long long)bc * d + col0 + 4 * j);
#pragma unroll
    for (int gi = 0; gi < G; ++gi) {
      qx[gi][j] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (gi < g && colv) qx[gi][j] = *reinterpret_cast<const float4*>(qb + gi * d + col0 + 4 * j);
    }
  }
  auto load = [&](I8Rows<E, NU>& r, int jb) {
#pragma unroll
    for (int u = 0; u < NU; ++u) {
      const int t = jb * TBLK + (u * ATT_WARPS + warp) * RPW + grp;
      if (colv) r.k[u].load(kb + (long long)t * d + col0);
      else r.k[u].zero();
    }
    r.ksc = __bfloat162float(ksb[jb * TBLK + own]);
    r.bias = __ldg(brow + jb * TBLK + own);
    r.vs = __bfloat162float(vsb[jb * TBLK + own]);
  };
  I8Rows<E, NU> ra;
  load(ra, blo);
  i8_copy_v(vbuf, vb + (long long)blo * TBLK * d, d);

  for (int e = tid; e < gd; e += ATT_THREADS) {
    acc_s[e] = 0.0f;
    osum[e] = 0;
  }

  // q quantized in registers, the lane's own columns; the current token's
  // score from the unquantized q
  uint32_t qw[G][EW];
  float qss[G];
  float kn[E];
#pragma unroll
  for (int j = 0; j < E / 4; ++j) {
    kn[4 * j] = knx[j].x; kn[4 * j + 1] = knx[j].y; kn[4 * j + 2] = knx[j].z;
    kn[4 * j + 3] = knx[j].w;
  }
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
    float x[E];
#pragma unroll
    for (int j = 0; j < E / 4; ++j) {
      x[4 * j] = qx[gi][j].x; x[4 * j + 1] = qx[gi][j].y; x[4 * j + 2] = qx[gi][j].z;
      x[4 * j + 3] = qx[gi][j].w;
    }
    float a = 0.0f, sn = 0.0f;
#pragma unroll
    for (int j = 0; j < E; ++j) {
      a = fmaxf(a, fabsf(x[j]));
      sn = fmaf(x[j], kn[j], sn);
    }
#pragma unroll
    for (int o = 1; o < LG; o <<= 1) {
      a = fmaxf(a, __shfl_xor_sync(0xffffffffu, a, o));
      sn += __shfl_xor_sync(0xffffffffu, sn, o);
    }
    const float qs = fmaxf(a / 127.0f, 1e-8f);
    qss[gi] = __fmul_rn(qs, sm_scale);
#pragma unroll
    for (int w = 0; w < EW; ++w) {
      uint32_t word = 0u;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        word |= ((uint32_t)__float2int_rn(x[4 * w + i] / qs) & 0xffu) << (8 * i);
      }
      qw[gi][w] = word;
    }
    if (tid == 0 && gi < g) snew_s[gi] = __fmul_rn(sn, sm_scale);
  }
  i8_stamp(stamps, 1);

  // 1. scores, v scales
  auto score = [&](const I8Rows<E, NU>& r, int jl) {
    vsc[jl * TBLK + own] = r.vs;
#pragma unroll
    for (int gi = 0; gi < G; ++gi) {
      int dot[NU];
#pragma unroll
      for (int u = 0; u < NU; ++u) {
        dot[u] = 0;
#pragma unroll
        for (int w = 0; w < EW; ++w) dot[u] = __dp4a((int)r.k[u].w[w], (int)qw[gi][w], dot[u]);
      }
      // transposing butterfly: after the stage of bit o a lane holds o
      // partial rows, those whose bit o is its own; dot[0] ends as row lig's
#pragma unroll
      for (int o = NU / 2; o >= 1; o >>= 1) {
        const bool up = (lig & o) != 0;
#pragma unroll
        for (int i = 0; i < o; ++i) {
          const int send = up ? dot[i] : dot[i + o];
          const int keep = up ? dot[i + o] : dot[i];
          dot[i] = keep + __shfl_xor_sync(0xffffffffu, send, o);
        }
      }
      if (gi < g) {
        sc[gi * scs + jl * TBLK + own] =
            __fadd_rn(__fmul_rn(__fmul_rn((float)dot[0], qss[gi]), r.ksc), r.bias);
      }
    }
  };
  for (int jb = blo; jb < bhi; ++jb) {
    if (jb > blo) load(ra, jb);
    score(ra, jb - blo);
  }
  __syncthreads();

  // 2. each block's max per group member, the rank's max, the prefix max
  for (int pr = warp; pr < nb * g; pr += ATT_WARPS) {
    const int jl = pr / g, gi = pr - jl * g;
    const float* s = sc + gi * scs + jl * TBLK;
    float mx = fmaxf(fmaxf(s[lane], s[lane + 32]), fmaxf(s[lane + 64], s[lane + 96]));
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    if (lane == 0) bmax[jl * G + gi] = mx;
  }
  __syncthreads();
  if (tid < g) {
    float mx = -INFINITY;
    for (int jl = 0; jl < nb; ++jl) mx = fmaxf(mx, bmax[jl * G + tid]);
    rmax_s[tid] = mx;
  }
  i8_stamp(stamps, 2);
  cluster.sync();   // every rank's max is written
  i8_stamp(stamps, 3);
  if (tid < g) {
    float m0 = -1e30f;
    for (int r = 0; r < rank; ++r) m0 = fmaxf(m0, cluster.map_shared_rank(rmax_s, r)[tid]);
    m_s[tid] = m0;
    l_s[tid] = 0.0f;
  }
  __syncthreads();

  // 3. the chain over the rank's blocks
  for (int jl = 0; jl < nb; ++jl) {
    if (jl + 1 < nb) {   // the next block's v rows, into the other slot
      i8_copy_v(vbuf + ((jl + 1) & 1) * vslot, vb + (long long)(blo + jl + 1) * TBLK * d, d);
    }
    for (int gi = warp; gi < g; gi += ATT_WARPS) {
      const float mp = m_s[gi];
      const float mj = fmaxf(mp, bmax[jl * G + gi]);
      const float corr = expf(mp - mj);
      const float* s = sc + gi * scs + jl * TBLK;
      const float* vv = vsc + jl * TBLK;
      float pv[4], psum = 0.0f, pmax = 0.0f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = expf(s[lane + 32 * i] - mj);
        psum = __fadd_rn(psum, p);
        pv[i] = __fmul_rn(p, vv[lane + 32 * i]);   // fold the v scales in before quantizing
        pmax = fmaxf(pmax, pv[i]);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        psum = __fadd_rn(psum, __shfl_xor_sync(0xffffffffu, psum, o));
        pmax = fmaxf(pmax, __shfl_xor_sync(0xffffffffu, pmax, o));
      }
      const float ps = fmaxf(pmax / 127.0f, 1e-20f);
#pragma unroll
      for (int i = 0; i < 4; ++i) p8s[gi][lane + 32 * i] = __float2int_rn(pv[i] / ps);
      if (lane == 0) {
        m_s[gi] = mj;
        l_s[gi] = __fadd_rn(__fmul_rn(l_s[gi], corr), psum);
        corr_s[gi] = corr;
        ps_s[gi] = ps;
      }
    }
    if (jl + 1 < nb) {
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    __syncthreads();
    if (jl == 0) i8_stamp(stamps, 4);
    {   // p8 . v in int32 over the lane group's rows
      const int8_t* vrow = vbuf + (jl & 1) * vslot;
      int o[G][E];
#pragma unroll
      for (int gi = 0; gi < G; ++gi) {
#pragma unroll
        for (int j = 0; j < E; ++j) o[gi][j] = 0;
      }
#pragma unroll
      for (int u = 0; u < NU; ++u) {
        const int r = (u * ATT_WARPS + warp) * RPW + grp;
        uint32_t vw[EW];
#pragma unroll
        for (int w = 0; w < EW; ++w) vw[w] = 0u;
        if (colv) {
          if constexpr (EW == 4) {
            const uint4 x = *reinterpret_cast<const uint4*>(vrow + r * d + col0);
            vw[0] = x.x; vw[1] = x.y; vw[2] = x.z; vw[3] = x.w;
          } else if constexpr (EW == 2) {
            const uint2 x = *reinterpret_cast<const uint2*>(vrow + r * d + col0);
            vw[0] = x.x; vw[1] = x.y;
          } else {
            vw[0] = *reinterpret_cast<const uint32_t*>(vrow + r * d + col0);
          }
        }
#pragma unroll
        for (int gi = 0; gi < G; ++gi) {
          const int pw = gi < g ? p8s[gi][r] : 0;
#pragma unroll
          for (int j = 0; j < E; ++j) o[gi][j] += pw * i8_byte(vw[j >> 2], j & 3);
        }
      }
#pragma unroll
      for (int off = LG; off < 32; off <<= 1) {
#pragma unroll
        for (int gi = 0; gi < G; ++gi) {
#pragma unroll
          for (int j = 0; j < E; ++j) o[gi][j] += __shfl_xor_sync(0xffffffffu, o[gi][j], off);
        }
      }
      if (grp == 0 && colv) {
#pragma unroll
        for (int gi = 0; gi < G; ++gi) {
          if (gi < g) {
#pragma unroll
            for (int j = 0; j < E; ++j) atomicAdd(&osum[gi * d + col0 + j], o[gi][j]);
          }
        }
      }
    }
    __syncthreads();

    for (int e = tid; e < gd; e += ATT_THREADS) {
      const int gi = e / d;
      acc_s[e] = __fadd_rn(__fmul_rn(acc_s[e], corr_s[gi]),
                           __fmul_rn((float)osum[e], ps_s[gi]));
      osum[e] = 0;
    }
    if (jl + 1 < nb) __syncthreads();   // after the last block, the cluster barrier
  }
  i8_stamp(stamps, 5);
  cluster.sync();   // every rank's (m, l, acc) is written
  i8_stamp(stamps, 6);

  {   // 4. the ranks merged in order, then the current token
    const int per = (gd + splits - 1) / splits;
    const int e_hi = min((rank + 1) * per, gd);
    float* ob = out + (long long)bc * gd;
    for (int e = rank * per + tid; e < e_hi; e += ATT_THREADS) {
      const int gi = e / d;
      float M = -1e30f, A = 0.0f, L = 0.0f;
      for (int r0 = 0; r0 < splits; r0 += ATT_MERGE) {
        float mr[ATT_MERGE], lr[ATT_MERGE], ar[ATT_MERGE];
#pragma unroll
        for (int j = 0; j < ATT_MERGE; ++j) {
          if (r0 + j < splits) {
            mr[j] = cluster.map_shared_rank(m_s, r0 + j)[gi];
            lr[j] = cluster.map_shared_rank(l_s, r0 + j)[gi];
            ar[j] = cluster.map_shared_rank(acc_s, r0 + j)[e];
          }
        }
#pragma unroll
        for (int j = 0; j < ATT_MERGE; ++j) {
          if (r0 + j < splits) {
            const float c = expf(M - mr[j]);
            A = __fadd_rn(__fmul_rn(A, c), ar[j]);
            L = __fadd_rn(__fmul_rn(L, c), lr[j]);
            M = mr[j];
          }
        }
      }
      const float s_new = snew_s[gi];
      const float m_fin = fmaxf(M, s_new);
      const float c = expf(M - m_fin), p_new = expf(s_new - m_fin);
      const float lf = __fadd_rn(__fmul_rn(L, c), p_new);
      const float o = __fadd_rn(__fmul_rn(A, c),
                                __fmul_rn(p_new, v_new[(long long)bc * d + (e - gi * d)]));
      ob[e] = o / fmaxf(lf, 1e-30f);
    }
  }
  i8_stamp(stamps, 7);
  cluster.sync();   // no block leaves before the others have read its shared memory
}

// Launches B1 over clusters of `splits` blocks; with `clusters` set, stores
// instead how many such clusters the card keeps resident at once.
template <int G, int LG>
static int launch_int8_tblk(const void* q, const void* k_all, const void* v_all, const void* ks,
                            const void* vs, const void* bias, const void* k_new,
                            const void* v_new, void* out, void* stamps, long long row0, int BC,
                            int kv, int T, int d, int g, int n_blk, int splits, float sm_scale,
                            cudaStream_t stream, int* clusters) {
  void (*kern)(const float*, const int8_t*, const int8_t*, const __nv_bfloat16*,
               const __nv_bfloat16*, const float*, const float*, const float*, float*,
               unsigned long long*, long long, int, int, int, int, int, int, float) =
      attend_int8_tblk_kernel<G, LG>;
  static bool ready = false;   // set once per instantiation
  if (!ready) {
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return (int)e;
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, I8_SMEM_MAX);
    if (e != cudaSuccess) return (int)e;
    ready = true;
  }
  const int smem = i8_smem_bytes(G, (n_blk + splits - 1) / splits, d);
  if (smem > I8_SMEM_MAX) return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(BC * splits), 1, 1);
  cfg.blockDim = dim3(ATT_THREADS, 1, 1);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (clusters != nullptr) return (int)cudaOccupancyMaxActiveClusters(clusters, kern, &cfg);
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, kern, (const float*)q, (const int8_t*)k_all, (const int8_t*)v_all,
      (const __nv_bfloat16*)ks, (const __nv_bfloat16*)vs, (const float*)bias,
      (const float*)k_new, (const float*)v_new, (float*)out, (unsigned long long*)stamps, row0,
      kv, T, d, g, n_blk, splits, sm_scale);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// The instantiation g and d select: G = g rounded up to a power of two, LG
// the lanes a row (d / E rounded up to a power of two).
static int dispatch_int8_tblk(const void* q, const void* k_all, const void* v_all,
                              const void* ks, const void* vs, const void* bias,
                              const void* k_new, const void* v_new, void* out, void* stamps,
                              long long row0, int BC, int kv, int T, int d, int g, int n_blk,
                              int splits, float sm_scale, cudaStream_t st, int* clusters) {
#define VT_I8(G, LG)                                                                      \
  launch_int8_tblk<G, LG>(q, k_all, v_all, ks, vs, bias, k_new, v_new, out, stamps, row0, \
                          BC, kv, T, d, g, n_blk, splits, sm_scale, st, clusters)
// d in 16..128: LG from 16 / E (d 16) to 128 / E (d 128)
#define VT_I8_LG(G, L0) \
  (d <= 16 ? VT_I8(G, L0) : d <= 32 ? VT_I8(G, 2 * L0) : d <= 64 ? VT_I8(G, 4 * L0) \
   : VT_I8(G, 8 * L0))
  if (g <= 1) return VT_I8_LG(1, 1);
  if (g <= 2) return VT_I8_LG(2, 1);
  if (g <= 4) return VT_I8_LG(4, 2);
  return VT_I8_LG(8, 4);
#undef VT_I8_LG
#undef VT_I8
}

// B1 on layer `layer` of the int8 cache: the blocks below
// ceil(valid_len / 128) (at least one), split over clusters of `splits`
// blocks (1 <= splits <= that count, at most 16; int8_splits). stamps:
// [b * kv * splits, I8_STAMPS] u64 or null.
extern "C" int vt_decode_attention_int8(
    const void* q, const void* k_all, const void* v_all,
    const void* k_scale, const void* v_scale, const void* bias,
    const void* k_new, const void* v_new, void* out, void* stamps,
    int b, int kv, int g, int d, int T, int layer, int valid_len, int splits,
    float sm_scale, void* stream) {
  if (g < 1 || g > MAX_G || d < 16 || d > MAX_D || d % 16 != 0 || T % TBLK != 0 || T < TBLK ||
      k_new == nullptr || v_new == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  int n_blk = (valid_len + TBLK - 1) / TBLK;
  if (n_blk < 1) n_blk = 1;
  if (n_blk > T / TBLK) n_blk = T / TBLK;
  if (splits < 1 || splits > n_blk || splits > ATT_MAX_SPLITS) return (int)cudaErrorInvalidValue;
  const int BC = b * kv;
  return dispatch_int8_tblk(q, k_all, v_all, k_scale, v_scale, bias, k_new, v_new, out, stamps,
                            (long long)layer * BC, BC, kv, T, d, g, n_blk, splits, sm_scale,
                            (cudaStream_t)stream, nullptr);
}

// Clusters of `splits` blocks the card keeps resident at once for B1 at
// this g, d and count of valid blocks (their shared bytes set by all three).
extern "C" int vt_attend_int8_clusters(int g, int d, int n_blk, int splits, int* clusters) {
  if (g < 1 || g > MAX_G || d < 16 || d > MAX_D || d % 16 != 0 || n_blk < 1 || splits < 1 ||
      splits > ATT_MAX_SPLITS || splits > n_blk || clusters == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  return dispatch_int8_tblk(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                            nullptr, nullptr, nullptr, 0, 1, 1, TBLK, d, g, n_blk, splits, 1.0f,
                            nullptr, clusters);
}


// ---------------------------------------------------------------------------
// B1w split over a thread-block cluster: the whole-row int8 decode attention
// of decode_attention_int8_whole_kernel above, the same function and the
// same JAX kernels replaced (_kernel_stacked_int8dots[_new] :190, :260,
// pallas_call :844; _kernel_stacked_int8dots_packed :268, pallas_call :808),
// with each (row, kv head) on a cluster of `splits` blocks.
//
// Unlike B1 the math has no sequential chain: ONE max over the row (joined
// by the current token's exact score), ONE l summed before the v scales, ONE
// p scale ps = max(max(p * vs) / 127, 1e-20) over the row, and an int32 PV
// product exact in any order. So the ranks publish two row-wide reductions,
// the max and then the p-max, and each rank then rounds its own p8 exactly
// as the one-block body and the plain version round them.
//
// Bound: bytes, as the one-block body (the slots' k and v rows, two bf16
// scales and the bias).
//
// Design: rank r takes the slots [r * n / splits, (r + 1) * n / splits)
// (ops/decode_attention.py whole_splits, whole_ranges), off the 128-slot
// grid, the last range ending at n. Its threads walk the range 128 slots a
// pass, laid out as B1's blocks: a lane holds E int8 of a k row (16 bytes
// where g allows), a group of LG lanes covers a row, so that a warp load
// reads 32 / LG whole, contiguous rows; each lane owns one row a pass.
//   0. Loads that wait on nothing first: q (and the current token's k), the
//      first pass's k rows into registers, the lane's own rows' scales and
//      bias.
//   1. Scores: q quantized in registers; a row's dot is the group's __dp4a
//      partials met by B1's transposing butterfly; the owning lane scales
//      and biases it into shared memory, where it stays: each score is
//      computed once. Before a pass's dots, the next pass's k rows are asked
//      for, then this pass's v rows into shared memory by 16-byte cp.async,
//      in flight until the PV product: every block's k bytes stay ahead of
//      its v bytes in the memory queue (all of the rank's v rows asked for
//      at entry held the later passes' k rows, and so the scores, ~2 µs
//      behind at the T3 shape).
//      __dp4a, not mma.sync: one query row a group member fills 1/16 (g 1)
//      to 1/2 (g 8) of an m16 tile, the k rows would need a transpose into
//      the B fragment's layout, and the dots are a few instructions a 16-byte
//      load the lane already holds.
//   2. The rank's max per group member published; cluster.sync(); every rank
//      takes M = the max over the ranks (distributed shared memory), joined
//      by the exact s_new.
//   3. p = exp(s - M) in place of s; the rank's l and max of p * vs
//      published; cluster.sync(); ps = max(max_r / 127, 1e-20), the same bits
//      in every rank.
//   4. p8 = round(p * vs / ps), as bytes; the int32 partial p8 . v over the
//      rank's rows from shared memory, four rows a __dp4a: a lane takes 4
//      rows x 16 (g 8: 8) columns, transposes each 4 x 4 block of bytes
//      (__byte_perm) into a column's 4 rows and multiplies it with the
//      group member's 4 p8 in one word (lanes met by xor shuffles, warps by
//      shared integer atomics). cluster.sync(); the ranks share the g * d outputs
//      out: each sums the ranks' int32 partials (exact in any order), times
//      ps, takes l summed in rank order, merges the current token, divides
//      by max(l, 1e-30) and writes. A last cluster.sync() keeps the shared
//      memory alive until every rank has read it.
// With `stamps` set, thread 0 of every block writes the card's ns clock at
// the W_STAMPS phase points (ops/decode_attention.py WHOLE_STAMP_POINTS).

#define W_SMEM_MAX (160 * 1024)   // dynamic shared bytes a block may take
#define W_STAMPS 9

// a rank's shared memory: its scores [G][nr] and v scales [nr] (f32), its v
// rows [nr][d], its p8 [G][nr] (bytes); nr is the most slots a rank takes
// padded to 4, so that the v rows start on 16 bytes and a 4-row quad's v
// rows and p8 word lie inside (ops/decode_attention.py whole_smem says the
// same)
__host__ __device__ __forceinline__ int w_rows(int ns) { return (ns + 3) & ~3; }
__host__ __device__ __forceinline__ int w_smem_bytes(int G, int ns, int d) {
  return w_rows(ns) * ((G + 1) * 4 + d + G);
}

// The 4 x 4 bytes of words a0..a3 (rows 0-3) transposed: c[j] holds column
// j's 4 rows, row i in byte i.
__device__ __forceinline__ void w_transpose4(uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3,
                                             uint32_t (&c)[4]) {
  const uint32_t lo01 = __byte_perm(a0, a1, 0x5140), hi01 = __byte_perm(a0, a1, 0x7362);
  const uint32_t lo23 = __byte_perm(a2, a3, 0x5140), hi23 = __byte_perm(a2, a3, 0x7362);
  c[0] = __byte_perm(lo01, lo23, 0x5410);
  c[1] = __byte_perm(lo01, lo23, 0x7632);
  c[2] = __byte_perm(hi01, hi23, 0x5410);
  c[3] = __byte_perm(hi01, hi23, 0x7632);
}

__device__ __forceinline__ void w_stamp(unsigned long long* stamps, int i) {
  if (stamps != nullptr && threadIdx.x == 0) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    stamps[blockIdx.x * W_STAMPS + i] = t;
  }
}

template <int G>
__device__ __forceinline__ void w_warp_max(float (&v)[G]) {
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v[gi] = fmaxf(v[gi], __shfl_xor_sync(0xffffffffu, v[gi], o));
  }
}

template <int G, int LG>
__global__ void __launch_bounds__(ATT_THREADS) attend_int8_whole_kernel(
    const float* __restrict__ q,                  // [BC, g, d]
    const int8_t* __restrict__ k_all,             // [L * BC, T, d]; this layer's rows from row0
    const int8_t* __restrict__ v_all,
    const __nv_bfloat16* __restrict__ ks_all,     // [L * BC, T]
    const __nv_bfloat16* __restrict__ vs_all,
    const float* __restrict__ bias,               // [b, T]
    const float* __restrict__ k_new,              // [BC, d] or null
    const float* __restrict__ v_new,
    float* __restrict__ out,                      // [BC, g, d]
    unsigned long long* __restrict__ stamps,      // [grid, W_STAMPS] or null
    long long row0, int kv, int T, int d, int g, int n, int splits, float sm_scale) {
  constexpr int E = 16 < 32 / G ? 16 : 32 / G;   // int8 columns a lane holds
  constexpr int EW = E / 4;
  constexpr int RPW = 32 / LG;                    // rows a warp load covers
  constexpr int NU = LG;                          // rows a lane group takes of a pass
  constexpr int PASS = NU * ATT_WARPS * RPW;      // slots a pass: 128
  constexpr int EPV = G <= 4 ? 16 : 8;            // v columns a lane takes in the PV product
  extern __shared__ __align__(16) float dyn[];    // sc [G][nr] (s, p * vs), vsc [nr], v rows, p8
  __shared__ int osum[G * MAX_D];
  __shared__ float wred[ATT_WARPS][G], wred2[ATT_WARPS][G];
  __shared__ float rmax_s[G], l_s[G], pm_s[G], m_s[G], ps_s[G], lt_s[G], snew_s[G];

  w_stamp(stamps, 0);
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int bc = blockIdx.x / splits;
  const int row = bc / kv;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int lig = lane & (LG - 1), grp = lane / LG;
  const int col0 = lig * E;
  const bool colv = col0 < d;              // lanes past d (d / E not a power of two) idle
  const int gd = g * d;
  const bool with_new = k_new != nullptr;

  const int lo = (int)((long long)rank * n / splits);
  const int cnt = (int)((long long)(rank + 1) * n / splits) - lo;
  const int nr = w_rows((n + splits - 1) / splits);
  const int quads = (cnt + 3) >> 2;
  float* sc = dyn;
  float* vsc = dyn + G * nr;
  int8_t* vbuf = reinterpret_cast<int8_t*>(vsc + nr);
  int8_t* p8b = vbuf + nr * d;

  const long long lrow = row0 + bc;
  const int8_t* kb = k_all + (lrow * T + lo) * d;
  const int8_t* vb = v_all + (lrow * T + lo) * d;
  const __nv_bfloat16* ksb = ks_all + lrow * T + lo;
  const __nv_bfloat16* vsb = vs_all + lrow * T + lo;
  const float* brow = bias + (long long)row * T + lo;
  // row u of a lane group in a pass: (u * ATT_WARPS + warp) * RPW + grp; one
  // warp load covers the RPW rows of one u, contiguous. The lane's own row
  // (whose score it writes) is u = lig.
  const int own = (lig * ATT_WARPS + warp) * RPW + grp;

  // 0. q and the current token's k, the first pass's k rows, own scales and
  // bias, all in flight before any is used
  const float* qb = q + (long long)bc * gd;
  float4 qx[G][E / 4], knx[E / 4];
#pragma unroll
  for (int j = 0; j < E / 4; ++j) {
    knx[j] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (with_new && colv) {
      knx[j] = *reinterpret_cast<const float4*>(k_new + (long long)bc * d + col0 + 4 * j);
    }
#pragma unroll
    for (int gi = 0; gi < G; ++gi) {
      qx[gi][j] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (gi < g && colv) qx[gi][j] = *reinterpret_cast<const float4*>(qb + gi * d + col0 + 4 * j);
    }
  }
  auto load = [&](I8Rows<E, NU>& r, int base) {
#pragma unroll
    for (int u = 0; u < NU; ++u) {
      const int t = base + (u * ATT_WARPS + warp) * RPW + grp;
      if (colv && t < cnt) r.k[u].load(kb + (long long)t * d + col0);
      else r.k[u].zero();
    }
    const int t = base + own;
    const bool live = t < cnt;
    r.ksc = live ? __bfloat162float(ksb[t]) : 0.0f;
    r.bias = live ? __ldg(brow + t) : 0.0f;
    r.vs = live ? __bfloat162float(vsb[t]) : 0.0f;
  };
  I8Rows<E, NU> ra, rb;
  load(ra, 0);
  for (int e = tid; e < gd; e += ATT_THREADS) osum[e] = 0;

  // q quantized in registers, the lane's own columns; the current token's
  // score from the unquantized q
  uint32_t qw[G][EW];
  float qss[G];
  float kn[E];
#pragma unroll
  for (int j = 0; j < E / 4; ++j) {
    kn[4 * j] = knx[j].x; kn[4 * j + 1] = knx[j].y; kn[4 * j + 2] = knx[j].z;
    kn[4 * j + 3] = knx[j].w;
  }
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
    float x[E];
#pragma unroll
    for (int j = 0; j < E / 4; ++j) {
      x[4 * j] = qx[gi][j].x; x[4 * j + 1] = qx[gi][j].y; x[4 * j + 2] = qx[gi][j].z;
      x[4 * j + 3] = qx[gi][j].w;
    }
    float a = 0.0f, sn = 0.0f;
#pragma unroll
    for (int j = 0; j < E; ++j) {
      a = fmaxf(a, fabsf(x[j]));
      sn = fmaf(x[j], kn[j], sn);
    }
#pragma unroll
    for (int o = 1; o < LG; o <<= 1) {
      a = fmaxf(a, __shfl_xor_sync(0xffffffffu, a, o));
      sn += __shfl_xor_sync(0xffffffffu, sn, o);
    }
    const float qs = fmaxf(a / 127.0f, 1e-8f);
    qss[gi] = __fmul_rn(qs, sm_scale);
#pragma unroll
    for (int w = 0; w < EW; ++w) {
      uint32_t word = 0u;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        word |= ((uint32_t)__float2int_rn(x[4 * w + i] / qs) & 0xffu) << (8 * i);
      }
      qw[gi][w] = word;
    }
    if (tid == 0 && gi < g) snew_s[gi] = __fmul_rn(sn, sm_scale);
  }
  w_stamp(stamps, 1);

  // 1. scores and v scales, the rank's max per group member
  float mloc[G];
#pragma unroll
  for (int gi = 0; gi < G; ++gi) mloc[gi] = -INFINITY;
  const uint32_t vdst = (uint32_t)__cvta_generic_to_shared(vbuf);
  for (int base = 0; base < cnt; base += PASS) {
    if (base + PASS < cnt) load(rb, base + PASS);
    // this pass's v rows, behind the next pass's k rows
    for (int i = base * d / 16 + tid; i < min(base + PASS, cnt) * d / 16; i += ATT_THREADS) {
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                   :: "r"(vdst + 16 * i), "l"(vb + 16 * i) : "memory");
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    const int t = base + own;
    if (t < cnt) vsc[t] = ra.vs;
#pragma unroll
    for (int gi = 0; gi < G; ++gi) {
      int dot[NU];
#pragma unroll
      for (int u = 0; u < NU; ++u) {
        dot[u] = 0;
#pragma unroll
        for (int w = 0; w < EW; ++w) dot[u] = __dp4a((int)ra.k[u].w[w], (int)qw[gi][w], dot[u]);
      }
      // transposing butterfly (B1's): dot[0] ends as row lig's
#pragma unroll
      for (int o = NU / 2; o >= 1; o >>= 1) {
        const bool up = (lig & o) != 0;
#pragma unroll
        for (int i = 0; i < o; ++i) {
          const int send = up ? dot[i] : dot[i + o];
          const int keep = up ? dot[i + o] : dot[i];
          dot[i] = keep + __shfl_xor_sync(0xffffffffu, send, o);
        }
      }
      if (gi < g && t < cnt) {
        const float s = __fadd_rn(__fmul_rn(__fmul_rn((float)dot[0], qss[gi]), ra.ksc), ra.bias);
        sc[gi * nr + t] = s;
        mloc[gi] = fmaxf(mloc[gi], s);
      }
    }
    ra = rb;
  }
  w_warp_max<G>(mloc);
  if (lane == 0) {
#pragma unroll
    for (int gi = 0; gi < G; ++gi) wred[warp][gi] = mloc[gi];
  }
  __syncthreads();
  if (tid < g) {
    float mx = wred[0][tid];
#pragma unroll
    for (int w = 1; w < ATT_WARPS; ++w) mx = fmaxf(mx, wred[w][tid]);
    rmax_s[tid] = mx;
  }
  w_stamp(stamps, 2);
  cluster.sync();   // every rank's max is written
  w_stamp(stamps, 3);

  // 2. the row's max, joined by the current token's exact score
  if (tid < g) {
    float mx = -INFINITY;
    for (int r = 0; r < splits; ++r) mx = fmaxf(mx, cluster.map_shared_rank(rmax_s, r)[tid]);
    if (with_new) mx = fmaxf(mx, snew_s[tid]);
    m_s[tid] = mx;
  }
  __syncthreads();

  // 3. p, its sum, p * vs (in place of s) and its max
  float lloc[G], ploc[G];
#pragma unroll
  for (int gi = 0; gi < G; ++gi) lloc[gi] = ploc[gi] = 0.0f;
  for (int t = own; t < cnt; t += PASS) {
    const float vs = vsc[t];
#pragma unroll
    for (int gi = 0; gi < G; ++gi) {
      if (gi < g) {
        const float p = expf(sc[gi * nr + t] - m_s[gi]);
        lloc[gi] = __fadd_rn(lloc[gi], p);
        const float pv = __fmul_rn(p, vs);   // fold the v scales in before quantizing
        sc[gi * nr + t] = pv;
        ploc[gi] = fmaxf(ploc[gi], pv);
      }
    }
  }
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      lloc[gi] = __fadd_rn(lloc[gi], __shfl_xor_sync(0xffffffffu, lloc[gi], o));
      ploc[gi] = fmaxf(ploc[gi], __shfl_xor_sync(0xffffffffu, ploc[gi], o));
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int gi = 0; gi < G; ++gi) {
      wred[warp][gi] = lloc[gi];
      wred2[warp][gi] = ploc[gi];
    }
  }
  __syncthreads();
  if (tid < g) {
    float l = wred[0][tid], pm = wred2[0][tid];
#pragma unroll
    for (int w = 1; w < ATT_WARPS; ++w) {
      l = __fadd_rn(l, wred[w][tid]);
      pm = fmaxf(pm, wred2[w][tid]);
    }
    l_s[tid] = l;
    pm_s[tid] = pm;
  }
  w_stamp(stamps, 4);
  cluster.sync();   // every rank's l and p-max are written
  w_stamp(stamps, 5);

  // 4. the row's one p scale; p8 over the rank's own slots; p8 . v
  if (tid < g) {
    float pm = 0.0f;
    for (int r = 0; r < splits; ++r) pm = fmaxf(pm, cluster.map_shared_rank(pm_s, r)[tid]);
    ps_s[tid] = fmaxf(pm / 127.0f, 1e-20f);
  }
  __syncthreads();
  for (int t = own; t < cnt; t += PASS) {
#pragma unroll
    for (int gi = 0; gi < G; ++gi) {
      if (gi < g) p8b[gi * nr + t] = (int8_t)__float2int_rn(sc[gi * nr + t] / ps_s[gi]);
    }
  }
  if (tid < 4 * g) {   // the last quad's rows past the range multiply by 0
    const int t = cnt + (tid & 3);
    if (t < 4 * quads) p8b[(tid >> 2) * nr + t] = 0;
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();
  {
    // lane (quad set, column group): EPV columns of 4 rows a quad
    int lgp = 1;
    while (lgp * EPV < d) lgp <<= 1;
    const int pc0 = (lane & (lgp - 1)) * EPV;
    const int qpw = 32 / lgp;
    int o[G][EPV];
#pragma unroll
    for (int gi = 0; gi < G; ++gi) {
#pragma unroll
      for (int j = 0; j < EPV; ++j) o[gi][j] = 0;
    }
    if (pc0 < d) {
      for (int qd = warp * qpw + lane / lgp; qd < quads; qd += ATT_WARPS * qpw) {
        const int8_t* vr = vbuf + 4 * qd * d + pc0;
        uint32_t a[4][EPV / 4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if constexpr (EPV == 16) {
            const uint4 x = *reinterpret_cast<const uint4*>(vr + i * d);
            a[i][0] = x.x; a[i][1] = x.y; a[i][2] = x.z; a[i][3] = x.w;
          } else {
            const uint2 x = *reinterpret_cast<const uint2*>(vr + i * d);
            a[i][0] = x.x; a[i][1] = x.y;
          }
        }
        int pw[G];
#pragma unroll
        for (int gi = 0; gi < G; ++gi) {
          pw[gi] = gi < g ? *reinterpret_cast<const int*>(p8b + gi * nr + 4 * qd) : 0;
        }
#pragma unroll
        for (int w = 0; w < EPV / 4; ++w) {
          uint32_t c[4];
          w_transpose4(a[0][w], a[1][w], a[2][w], a[3][w], c);
#pragma unroll
          for (int gi = 0; gi < G; ++gi) {
#pragma unroll
            for (int j = 0; j < 4; ++j) o[gi][4 * w + j] = __dp4a((int)c[j], pw[gi], o[gi][4 * w + j]);
          }
        }
      }
    }
    for (int off = lgp; off < 32; off <<= 1) {
#pragma unroll
      for (int gi = 0; gi < G; ++gi) {
#pragma unroll
        for (int j = 0; j < EPV; ++j) o[gi][j] += __shfl_xor_sync(0xffffffffu, o[gi][j], off);
      }
    }
    if (lane < lgp && pc0 < d) {
#pragma unroll
      for (int gi = 0; gi < G; ++gi) {
        if (gi < g) {
#pragma unroll
          for (int j = 0; j < EPV; ++j) atomicAdd(&osum[gi * d + pc0 + j], o[gi][j]);
        }
      }
    }
  }
  w_stamp(stamps, 6);
  cluster.sync();   // every rank's int32 partials are summed
  w_stamp(stamps, 7);

  // 5. the ranks' partials met, times ps; l in rank order; the current token
  if (tid < g) {
    float l = 0.0f;
    for (int r = 0; r < splits; ++r) l = __fadd_rn(l, cluster.map_shared_rank(l_s, r)[tid]);
    lt_s[tid] = l;
  }
  __syncthreads();
  {
    const int per = (gd + splits - 1) / splits;
    const int e_hi = min((rank + 1) * per, gd);
    float* ob = out + (long long)bc * gd;
    for (int e = rank * per + tid; e < e_hi; e += ATT_THREADS) {
      const int gi = e / d;
      int acc = 0;
      for (int r0 = 0; r0 < splits; r0 += ATT_MERGE) {
        int part[ATT_MERGE];
#pragma unroll
        for (int j = 0; j < ATT_MERGE; ++j) {
          part[j] = r0 + j < splits ? cluster.map_shared_rank(osum, r0 + j)[e] : 0;
        }
#pragma unroll
        for (int j = 0; j < ATT_MERGE; ++j) acc += part[j];
      }
      float val = __fmul_rn(__int2float_rn(acc), ps_s[gi]);
      float l = lt_s[gi];
      if (with_new) {
        const float p_new = expf(snew_s[gi] - m_s[gi]);
        l = __fadd_rn(l, p_new);
        val = __fadd_rn(val, __fmul_rn(p_new, v_new[(long long)bc * d + (e - gi * d)]));
      }
      ob[e] = val / fmaxf(l, 1e-30f);
    }
  }
  w_stamp(stamps, 8);
  cluster.sync();   // no block leaves before the others have read its shared memory
}

// Launches split B1w over clusters of `splits` blocks; with `clusters` set,
// stores instead how many such clusters the card keeps resident at once
// (n: the slots, which set a rank's shared bytes).
template <int G, int LG>
static int launch_int8_whole(const void* q, const void* k_all, const void* v_all, const void* ks,
                             const void* vs, const void* bias, const void* k_new,
                             const void* v_new, void* out, void* stamps, long long row0, int BC,
                             int kv, int T, int d, int g, int n, int splits, float sm_scale,
                             cudaStream_t stream, int* clusters) {
  void (*kern)(const float*, const int8_t*, const int8_t*, const __nv_bfloat16*,
               const __nv_bfloat16*, const float*, const float*, const float*, float*,
               unsigned long long*, long long, int, int, int, int, int, int, float) =
      attend_int8_whole_kernel<G, LG>;
  static bool ready = false;   // set once per instantiation
  if (!ready) {
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return (int)e;
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, W_SMEM_MAX);
    if (e != cudaSuccess) return (int)e;
    ready = true;
  }
  const int smem = w_smem_bytes(G, (n + splits - 1) / splits, d);
  if (smem > W_SMEM_MAX) return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(BC * splits), 1, 1);
  cfg.blockDim = dim3(ATT_THREADS, 1, 1);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (clusters != nullptr) return (int)cudaOccupancyMaxActiveClusters(clusters, kern, &cfg);
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, kern, (const float*)q, (const int8_t*)k_all, (const int8_t*)v_all,
      (const __nv_bfloat16*)ks, (const __nv_bfloat16*)vs, (const float*)bias,
      (const float*)k_new, (const float*)v_new, (float*)out, (unsigned long long*)stamps, row0,
      kv, T, d, g, n, splits, sm_scale);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// The instantiation g and d select, as B1's (dispatch_int8_tblk).
static int dispatch_int8_whole(const void* q, const void* k_all, const void* v_all,
                               const void* ks, const void* vs, const void* bias,
                               const void* k_new, const void* v_new, void* out, void* stamps,
                               long long row0, int BC, int kv, int T, int d, int g, int n,
                               int splits, float sm_scale, cudaStream_t st, int* clusters) {
#define VT_W(G, LG)                                                                        \
  launch_int8_whole<G, LG>(q, k_all, v_all, ks, vs, bias, k_new, v_new, out, stamps, row0, \
                           BC, kv, T, d, g, n, splits, sm_scale, st, clusters)
#define VT_W_LG(G, L0) \
  (d <= 16 ? VT_W(G, L0) : d <= 32 ? VT_W(G, 2 * L0) : d <= 64 ? VT_W(G, 4 * L0) \
   : VT_W(G, 8 * L0))
  if (g <= 1) return VT_W_LG(1, 1);
  if (g <= 2) return VT_W_LG(2, 1);
  if (g <= 4) return VT_W_LG(4, 2);
  return VT_W_LG(8, 4);
#undef VT_W_LG
#undef VT_W
}

// Split B1w on layer `layer` of the int8 cache: the first n_slots slots,
// over clusters of `splits` blocks (1 <= splits <= min(n_slots, 16); a rank's
// shared bytes within W_SMEM_MAX; whole_splits). k_new / v_new: both or
// neither. stamps: [b * kv * splits, W_STAMPS] u64 or null.
extern "C" int vt_decode_attention_int8_whole_split(
    const void* q, const void* k_all, const void* v_all,
    const void* k_scale, const void* v_scale, const void* bias,
    const void* k_new, const void* v_new, void* out, void* stamps,
    int b, int kv, int g, int d, int T, int layer, int n_slots, int splits,
    float sm_scale, void* stream) {
  if (g < 1 || g > MAX_G || d < 16 || d > MAX_D || d % 16 != 0 || n_slots < 1 || n_slots > T ||
      splits < 1 || splits > n_slots || splits > ATT_MAX_SPLITS ||
      (k_new == nullptr) != (v_new == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  const int BC = b * kv;
  return dispatch_int8_whole(q, k_all, v_all, k_scale, v_scale, bias, k_new, v_new, out, stamps,
                             (long long)layer * BC, BC, kv, T, d, g, n_slots, splits, sm_scale,
                             (cudaStream_t)stream, nullptr);
}

// Clusters of `splits` blocks the card keeps resident at once for split B1w
// at this g and d over n slots (their shared bytes set by all three).
extern "C" int vt_attend_whole_clusters(int g, int d, int n, int splits, int* clusters) {
  if (g < 1 || g > MAX_G || d < 16 || d > MAX_D || d % 16 != 0 || n < 1 || splits < 1 ||
      splits > ATT_MAX_SPLITS || splits > n || clusters == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  return dispatch_int8_whole(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                             nullptr, nullptr, nullptr, 0, 1, 1, n, d, g, n, splits, 1.0f,
                             nullptr, clusters);
}
