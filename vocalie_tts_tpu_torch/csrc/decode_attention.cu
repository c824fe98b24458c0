// q_len == 1 decode attention over one layer of the stacked int8 KV cache,
// read in place, with the current token's k/v merged unquantized.
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
