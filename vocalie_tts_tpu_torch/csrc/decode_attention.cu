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
