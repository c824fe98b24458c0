// q_len == 1 decode attention over one layer of the stacked KV cache, read
// in place, with the current token's k/v merged unquantized: the int8
// T-blocked kernel (B1) first, then the int8 whole-row kernel (B1w) and the
// f32 kernel of K1, K2 and B10 (see their own notes below).
//
// Replaces: vocalie_tts_tpu/ops/decode_attention.py::decode_attention_stacked
// on its int8 T-blocked branches (_kernel_stacked_int8dots_packed_tblk and
// _kernel_stacked_int8dots_tblk, which compute the same numbers). The math
// is theirs, step for step:
//   * q is quantized once per (row, head, group member):
//     qs = max(max|q| / 127, 1e-8), q8 = round_half_even(q / qs);
//   * scores are int8 dot products in int32, scaled by qs * sm_scale, then
//     by the per-slot k scale, plus the additive [b, T] bias;
//   * online softmax over 128-slot blocks (running max starts at -1e30);
//   * the probabilities, times the per-slot v scales, are re-quantized to
//     int8 PER 128-SLOT BLOCK (ps = max(max p / 127, 1e-20)) -- so the
//     block here must be 128 slots for the numbers to match;
//   * only blocks below ceil(valid_len / 128) are read (at least one);
//     slots inside them are still masked by the bias;
//   * the current token's k/v join in f32 at the end, and the result is
//     divided by max(l, 1e-30).
// The TPU's lane-packed k|v layout is not copied: k and v are separate
// [L, b, kv, T, d] int8 arrays.
//
// Bound: bytes. Each step reads, for every (row, kv head) and valid slot,
// d int8 of k and of v, two bf16 scales and the 4-byte bias.
//
// Design (first, simple version): one block of 128 threads per
// (row, kv head). Thread t owns slot t of the current 128-slot block: it
// reads that slot's k row and computes its scores with __dp4a; block-wide
// max/sum reductions run the online softmax; the v block is staged in
// shared memory and the p.v products are summed by the threads that own
// each output element. No tensor cores, no TMA, no split over T.

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

__global__ void __launch_bounds__(NTHREADS) decode_attention_int8_kernel(
    const float* __restrict__ q,                  // [BC, g, d]
    const int8_t* __restrict__ k_all,             // [L, BC, T, d]
    const int8_t* __restrict__ v_all,             // [L, BC, T, d]
    const __nv_bfloat16* __restrict__ ks_all,     // [L, BC, T]
    const __nv_bfloat16* __restrict__ vs_all,     // [L, BC, T]
    const float* __restrict__ bias,               // [b, T]
    const float* __restrict__ k_new,              // [BC, d]
    const float* __restrict__ v_new,              // [BC, d]
    float* __restrict__ out,                      // [BC, g, d]
    int BC, int kv, int T, int d, int g, int layer, int n_blk, float sm_scale) {
  __shared__ __align__(16) int8_t q8_s[MAX_G * MAX_D];
  __shared__ __align__(16) int8_t v_s[TBLK * MAX_D];
  __shared__ int p_s[MAX_G * TBLK];
  __shared__ float acc_s[MAX_G * MAX_D];
  __shared__ float qs_s[MAX_G], m_s[MAX_G], l_s[MAX_G], corr_s[MAX_G], ps_s[MAX_G], snew_s[MAX_G];
  __shared__ float red[NWARPS];

  const int bc = blockIdx.x;
  const int row = bc / kv;
  const int tid = threadIdx.x;
  const float* qb = q + (long long)bc * g * d;

  // quantize q once per group member
  for (int gi = 0; gi < g; ++gi) {
    float a = tid < d ? fabsf(qb[gi * d + tid]) : 0.0f;
    float qa = block_max(a, red);
    float qs = fmaxf(qa / 127.0f, 1e-8f);
    if (tid < d) q8_s[gi * d + tid] = (int8_t)__float2int_rn(qb[gi * d + tid] / qs);
    if (tid == 0) {
      qs_s[gi] = qs;
      m_s[gi] = -1e30f;
      l_s[gi] = 0.0f;
    }
  }
  for (int o = tid; o < g * d; o += NTHREADS) acc_s[o] = 0.0f;
  __syncthreads();

  const long long lrow = (long long)layer * BC + bc;
  const int8_t* kb = k_all + lrow * T * d;
  const int8_t* vb = v_all + lrow * T * d;
  const __nv_bfloat16* ksb = ks_all + lrow * T;
  const __nv_bfloat16* vsb = vs_all + lrow * T;
  const float* brow = bias + (long long)row * T;
  const int dw = d / 4;

  for (int blk = 0; blk < n_blk; ++blk) {
    const int t = blk * TBLK + tid;
    // stage this block's v rows (TBLK * d bytes, 16 bytes per load)
    const int4* vsrc = reinterpret_cast<const int4*>(vb + (long long)blk * TBLK * d);
    int4* vdst = reinterpret_cast<int4*>(v_s);
    for (int i = tid; i < TBLK * d / 16; i += NTHREADS) vdst[i] = vsrc[i];

    const float ksc = __bfloat162float(ksb[t]);
    const float vsc = __bfloat162float(vsb[t]);
    const float bb = brow[t];
    const int* krow = reinterpret_cast<const int*>(kb + (long long)t * d);

    for (int gi = 0; gi < g; ++gi) {
      const int* qw = reinterpret_cast<const int*>(q8_s + gi * d);
      int dot = 0;
      for (int w = 0; w < dw; ++w) dot = __dp4a(krow[w], qw[w], dot);
      float s = __fmul_rn((float)dot, __fmul_rn(qs_s[gi], sm_scale));
      s = __fadd_rn(__fmul_rn(s, ksc), bb);
      const float m_prev = m_s[gi];
      const float m_new = fmaxf(m_prev, block_max(s, red));
      const float corr = expf(m_prev - m_new);
      float p = expf(s - m_new);
      const float psum = block_sum(p, red);
      p = __fmul_rn(p, vsc);  // fold the v scales in before quantizing
      const float pa = block_max(p, red);
      const float ps = fmaxf(pa / 127.0f, 1e-20f);
      p_s[gi * TBLK + tid] = __float2int_rn(p / ps);
      if (tid == 0) {
        m_s[gi] = m_new;
        l_s[gi] = __fadd_rn(__fmul_rn(l_s[gi], corr), psum);
        corr_s[gi] = corr;
        ps_s[gi] = ps;
      }
    }
    __syncthreads();
    for (int o = tid; o < g * d; o += NTHREADS) {
      const int gi = o / d, dd = o - gi * d;
      const int* pg = p_s + gi * TBLK;
      int sum = 0;
#pragma unroll 8
      for (int j = 0; j < TBLK; ++j) sum += pg[j] * (int)v_s[j * d + dd];
      acc_s[o] = __fadd_rn(__fmul_rn(acc_s[o], corr_s[gi]), __fmul_rn((float)sum, ps_s[gi]));
    }
    __syncthreads();
  }

  // merge the current token's k/v (unquantized, f32)
  const float* knb = k_new + (long long)bc * d;
  const float* vnb = v_new + (long long)bc * d;
  if (tid < g) {
    float s = 0.0f;
    for (int dd = 0; dd < d; ++dd) s = __fadd_rn(s, __fmul_rn(qb[tid * d + dd], knb[dd]));
    snew_s[tid] = __fmul_rn(s, sm_scale);
  }
  __syncthreads();
  float* ob = out + (long long)bc * g * d;
  for (int o = tid; o < g * d; o += NTHREADS) {
    const int gi = o / d, dd = o - gi * d;
    const float m_prev = m_s[gi];
    const float s_new = snew_s[gi];
    const float m_fin = fmaxf(m_prev, s_new);
    const float corr = expf(m_prev - m_fin);
    const float p_new = expf(s_new - m_fin);
    const float l_fin = __fadd_rn(__fmul_rn(l_s[gi], corr), p_new);
    const float val = __fadd_rn(__fmul_rn(acc_s[o], corr), __fmul_rn(p_new, vnb[dd]));
    ob[o] = val / fmaxf(l_fin, 1e-30f);
  }
}

extern "C" int vt_decode_attention_int8(
    const void* q, const void* k_all, const void* v_all,
    const void* k_scale, const void* v_scale, const void* bias,
    const void* k_new, const void* v_new, void* out,
    int b, int kv, int g, int d, int T, int layer, int valid_len,
    float sm_scale, void* stream) {
  if (g < 1 || g > MAX_G || d < 16 || d > MAX_D || d % 16 != 0 || T % TBLK != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const int n_tblk = T / TBLK;
  int n_blk = (valid_len + TBLK - 1) / TBLK;
  if (n_blk < 1) n_blk = 1;
  if (n_blk > n_tblk) n_blk = n_tblk;
  const int BC = b * kv;
  decode_attention_int8_kernel<<<BC, NTHREADS, 0, (cudaStream_t)stream>>>(
      (const float*)q, (const int8_t*)k_all, (const int8_t*)v_all,
      (const __nv_bfloat16*)k_scale, (const __nv_bfloat16*)v_scale,
      (const float*)bias, (const float*)k_new, (const float*)v_new, (float*)out,
      BC, kv, T, d, g, layer, n_blk, sm_scale);
  return (int)cudaGetLastError();
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
// no TMA.

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
// The f32 kernel: decode attention with every product in f32.
//
// Replaces three Pallas kernels of vocalie_tts_tpu/ops/decode_attention.py
// that share _attend_chunk's math (:150-176):
//   * K1: decode_attention_stacked's bf16 branch, _kernel_stacked_plain[_new]
//     (:538, :554), over a bf16 or f32 cache (mode PLAIN);
//   * K2: its f32-dequant branch, _kernel_stacked_quant[_new] (:512, :530),
//     over the int8 cache: scores times sm_scale * ks, v times vs before the
//     PV product (mode DEQUANT);
//   * B10: decode_attention (:85; _kernel_quant :49, _kernel_plain :67), one
//     unstacked layer without a current token: scores times sm_scale, then
//     ks; p times vs after its sum (mode B10; PLAIN without scales).
// The math: s = q.k in f32, times the score factor, plus the [b, T] bias;
// softmax over the slots and, where given, the current token's score
// s_new = sum(q * k_new) * sm_scale; o = p.v + p_new * v_new; o / max(l, 1e-30).
// JAX takes the max over all slots first; here it is a running max over
// 128-slot chunks, rescaled (the same result up to f32 rounding).
//
// With the current token merged, the wrapper passes the number of slots to
// read (the valid length): past it every slot is masked, its probability
// is exactly 0 and its score is below the current token's, so skipping it
// changes nothing. Without one, every slot is read.
//
// Bound: bytes. Each (row, kv head) reads its slots' k and v once (2 or 4
// bytes an element, int8 plus two scales for K2/B10) and the bias row.
//
// Design (first, simple version): one block of 128 threads per
// (row, kv head). Thread t owns slot t of the current 128-slot chunk and
// computes its g scores from its k row (16-byte loads); block-wide max/sum
// reductions run the online softmax; the probabilities go to shared memory
// and each thread accumulates up to 8 of the g*d outputs, reading the v
// rows coalesced. No tensor cores, no split over T.

#define ACC_PER_THREAD (MAX_G * MAX_D / NTHREADS)

enum { MODE_PLAIN = 0, MODE_DEQUANT = 1, MODE_B10 = 2 };

template <typename T> struct Vec16;  // 16 bytes of a cache row as floats
template <> struct Vec16<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void load(const float* p, float* f) {
    const float4 u = *reinterpret_cast<const float4*>(p);
    f[0] = u.x; f[1] = u.y; f[2] = u.z; f[3] = u.w;
  }
};
template <> struct Vec16<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void load(const __nv_bfloat16* p, float* f) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 x = __bfloat1622float2(h[i]);
      f[2 * i] = x.x;
      f[2 * i + 1] = x.y;
    }
  }
};
template <> struct Vec16<int8_t> {
  static constexpr int N = 16;
  __device__ __forceinline__ static void load(const int8_t* p, float* f) {
    const int4 u = *reinterpret_cast<const int4*>(p);
    const int8_t* b = reinterpret_cast<const int8_t*>(&u);
#pragma unroll
    for (int i = 0; i < 16; ++i) f[i] = (float)b[i];
  }
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(int8_t x) { return (float)x; }

template <typename CT, typename ST, int MODE>
__global__ void __launch_bounds__(NTHREADS) attend_f32_kernel(
    const float* __restrict__ q,        // [BC, g, d]
    const CT* __restrict__ k_all,       // [L * BC, T, d]; this layer's rows start at row0
    const CT* __restrict__ v_all,
    const ST* __restrict__ ks_all,      // [L * BC, T] (MODE != PLAIN)
    const ST* __restrict__ vs_all,
    const float* __restrict__ bias,     // [b, T]
    const float* __restrict__ k_new,    // [BC, d] or null
    const float* __restrict__ v_new,
    float* __restrict__ out,            // [BC, g, d]
    long long row0, int kv, int T, int d, int g, int n_slots, float sm_scale) {
  __shared__ float q_s[MAX_G * MAX_D];
  __shared__ float p_s[MAX_G * TBLK];
  __shared__ float vs_s[TBLK];
  __shared__ float m_s[MAX_G], l_s[MAX_G], corr_s[MAX_G], snew_s[MAX_G];
  __shared__ float red[NWARPS];

  const int bc = blockIdx.x;
  const int row = bc / kv;
  const int tid = threadIdx.x;
  const int gd = g * d;
  for (int i = tid; i < gd; i += NTHREADS) q_s[i] = q[(long long)bc * gd + i];
  if (tid < g) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.0f;
  }
  float acc[ACC_PER_THREAD];
#pragma unroll
  for (int i = 0; i < ACC_PER_THREAD; ++i) acc[i] = 0.0f;
  __syncthreads();

  const long long lrow = row0 + bc;
  const CT* kb = k_all + lrow * T * d;
  const CT* vb = v_all + lrow * T * d;
  const float* brow = bias + (long long)row * T;
  constexpr int VN = Vec16<CT>::N;

  for (int c0 = 0; c0 < n_slots; c0 += TBLK) {
    const int t = c0 + tid;
    const bool live = t < n_slots;
    float s[MAX_G];
#pragma unroll
    for (int gi = 0; gi < MAX_G; ++gi) s[gi] = 0.0f;
    float vsc = 1.0f;
    if (live) {
      const CT* kr = kb + (long long)t * d;
      for (int d0 = 0; d0 < d; d0 += VN) {
        float kx[VN];
        Vec16<CT>::load(kr + d0, kx);
#pragma unroll
        for (int j = 0; j < VN; ++j) {
#pragma unroll
          for (int gi = 0; gi < MAX_G; ++gi) {
            if (gi < g) s[gi] = fmaf(q_s[gi * d + d0 + j], kx[j], s[gi]);
          }
        }
      }
      const float bb = brow[t];
      float ksc = 1.0f;
      if (MODE != MODE_PLAIN) {
        ksc = to_f32(ks_all[lrow * T + t]);
        vsc = to_f32(vs_all[lrow * T + t]);
      }
#pragma unroll
      for (int gi = 0; gi < MAX_G; ++gi) {
        if (MODE == MODE_PLAIN) s[gi] = __fadd_rn(__fmul_rn(s[gi], sm_scale), bb);
        if (MODE == MODE_DEQUANT) s[gi] = __fadd_rn(__fmul_rn(s[gi], __fmul_rn(sm_scale, ksc)), bb);
        if (MODE == MODE_B10) s[gi] = __fadd_rn(__fmul_rn(__fmul_rn(s[gi], sm_scale), ksc), bb);
      }
    }
    if (MODE == MODE_DEQUANT) vs_s[tid] = vsc;
    for (int gi = 0; gi < g; ++gi) {
      float sv = -INFINITY;
#pragma unroll
      for (int gj = 0; gj < MAX_G; ++gj) {
        if (gj == gi && live) sv = s[gj];
      }
      const float m_prev = m_s[gi];
      const float m_new = fmaxf(m_prev, block_max(sv, red));
      const float corr = m_prev == -INFINITY ? 0.0f : expf(m_prev - m_new);
      const float p = live ? expf(sv - m_new) : 0.0f;
      const float psum = block_sum(p, red);
      p_s[gi * TBLK + tid] = MODE == MODE_B10 ? __fmul_rn(p, vsc) : p;
      if (tid == 0) {
        m_s[gi] = m_new;
        l_s[gi] = __fadd_rn(__fmul_rn(l_s[gi], corr), psum);
        corr_s[gi] = corr;
      }
    }
    __syncthreads();
    const int cnt = min(TBLK, n_slots - c0);
#pragma unroll
    for (int i = 0; i < ACC_PER_THREAD; ++i) {
      const int o = tid + i * NTHREADS;
      if (o < gd) {
        const int gi = o / d, dd = o - gi * d;
        const float* pg = p_s + gi * TBLK;
        const CT* vcol = vb + (long long)c0 * d + dd;
        float sum = 0.0f;
        for (int j = 0; j < cnt; ++j) {
          float vx = to_f32(vcol[(long long)j * d]);
          if (MODE == MODE_DEQUANT) vx = __fmul_rn(vx, vs_s[j]);
          sum = fmaf(pg[j], vx, sum);
        }
        acc[i] = __fadd_rn(__fmul_rn(acc[i], corr_s[gi]), sum);
      }
    }
    __syncthreads();
  }

  // merge the current token's k/v (f32)
  if (k_new != nullptr) {
    if (tid < g) {
      float sn = 0.0f;
      for (int dd = 0; dd < d; ++dd) sn = fmaf(q_s[tid * d + dd], k_new[(long long)bc * d + dd], sn);
      snew_s[tid] = __fmul_rn(sn, sm_scale);
    }
    __syncthreads();
  }
  float* ob = out + (long long)bc * gd;
#pragma unroll
  for (int i = 0; i < ACC_PER_THREAD; ++i) {
    const int o = tid + i * NTHREADS;
    if (o < gd) {
      const int gi = o / d, dd = o - gi * d;
      float l = l_s[gi], a = acc[i];
      if (k_new != nullptr) {
        const float m_prev = m_s[gi], s_new = snew_s[gi];
        const float m_fin = fmaxf(m_prev, s_new);
        const float corr = expf(m_prev - m_fin);
        const float p_new = expf(s_new - m_fin);
        l = __fadd_rn(__fmul_rn(l, corr), p_new);
        a = __fadd_rn(__fmul_rn(a, corr), __fmul_rn(p_new, v_new[(long long)bc * d + dd]));
      }
      ob[o] = a / fmaxf(l, 1e-30f);
    }
  }
}

template <typename CT, typename ST, int MODE>
static int launch_attend_f32(const void* q, const void* k_all, const void* v_all,
                             const void* ks, const void* vs, const void* bias,
                             const void* k_new, const void* v_new, void* out,
                             long long row0, int BC, int kv, int T, int d, int g, int n_slots,
                             float sm_scale, cudaStream_t stream) {
  attend_f32_kernel<CT, ST, MODE><<<BC, NTHREADS, 0, stream>>>(
      (const float*)q, (const CT*)k_all, (const CT*)v_all, (const ST*)ks, (const ST*)vs,
      (const float*)bias, (const float*)k_new, (const float*)v_new, (float*)out,
      row0, kv, T, d, g, n_slots, sm_scale);
  return (int)cudaGetLastError();
}

// cache: 0 f32, 1 bf16, 2 int8; scale: 0 none, 1 bf16, 2 f32;
// mode: 0 PLAIN (float cache, no scales), 1 DEQUANT, 2 B10 (int8 + scales)
extern "C" int vt_attend_f32(
    const void* q, const void* k_all, const void* v_all, const void* k_scale,
    const void* v_scale, const void* bias, const void* k_new, const void* v_new, void* out,
    int cache, int scale, int mode, long long row0, int b, int kv, int g, int d, int T,
    int n_slots, float sm_scale, void* stream) {
  if (g < 1 || g > MAX_G || d < 16 || d > MAX_D || d % 16 != 0 || n_slots < 1 || n_slots > T ||
      (k_new == nullptr) != (v_new == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  const int BC = b * kv;
  cudaStream_t st = (cudaStream_t)stream;
#define VT_ATTEND(CT, ST, MODE) \
  launch_attend_f32<CT, ST, MODE>(q, k_all, v_all, k_scale, v_scale, bias, k_new, v_new, out, \
                                  row0, BC, kv, T, d, g, n_slots, sm_scale, st)
  if (mode == MODE_PLAIN && scale == 0) {
    if (cache == 0) return VT_ATTEND(float, float, MODE_PLAIN);
    if (cache == 1) return VT_ATTEND(__nv_bfloat16, float, MODE_PLAIN);
  } else if (cache == 2 && mode == MODE_DEQUANT && scale == 1) {
    return VT_ATTEND(int8_t, __nv_bfloat16, MODE_DEQUANT);
  } else if (cache == 2 && mode == MODE_B10) {
    if (scale == 1) return VT_ATTEND(int8_t, __nv_bfloat16, MODE_B10);
    if (scale == 2) return VT_ATTEND(int8_t, float, MODE_B10);
  }
#undef VT_ATTEND
  return (int)cudaErrorInvalidValue;
}
