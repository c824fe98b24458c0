// The whole decode step at batch 1 -- every layer -- in ONE cooperative
// launch (kernel B7).
//
// Replaces: vocalie_tts_tpu/ops/decode_step.py::decode_step_fused_packed
// (def :245, pallas_call :335). The math is theirs, step for step, for each
// layer l on the residual carried in f32 across all layers:
//   * attention over the whole cache of one head in one block: q quantized
//     per head (qs = max(max|q| / 127, 1e-8)), s = (i32 * (qs * sm)) * ks +
//     bias over all T slots, the current token's column merged in f32, the
//     probabilities times the v scales quantized ONCE per head over all T
//     (ps = max(max(p * vs) / 127, 1e-20)), o = (o_v + p_new * v_new) /
//     max(l_sum, 1e-30);
//   * the o-projection with one scale per HEAD: the per-head int32 products,
//     times their head's scale, summed over heads in ascending order, then
//     times the column scale, plus the residual;
//   * RMSNorm, per-row int8, gate | up with their column scales,
//     silu(g) * u quantized with ONE scale over all of d_ff, down, plus the
//     residual;
//   * the next layer's RMSNorm, per-row int8, qkv of layer min(l + 1, L - 1)
//     times the scales plus bqkv, RoPE in f32 on the q and k heads
//     (y * cos|cos + swap(y) * (-sin|sin)); q goes on to layer l + 1, k and v
//     go to output row l.
// Rounding follows the plain version (ops/decode_step.py): int8 products in
// int32, IEEE divides, no fused multiply-add, and the variance, the softmax
// sum and the current token's score summed in double and rounded to f32
// once, so that the summation order does not show.
// The TPU kernel's head-stacked weight copy, selector matmuls and RoPE
// permutation dot are not carried over: the port reads the fused
// [L, d_model, 3*H*d] qkv weights and its split [L, 1, H, T, d] k and v.
//
// Bound: bytes. At the full CosyVoice shapes (24 layers, d_model 1024,
// d_ff 4096, 16 heads of 64) halfway through the streaming request (cache
// 640, 383 slots valid) one step needs 402.7 MB of int8 weights (16 MiB a
// layer), 18.8 MB of the valid slots' int8 k and v, 0.6 MB of their bf16
// scales and 1.8 MB of scales, norms, biases and rows: 423.9 MB, 0.127 ms at
// 3.35 TB/s. Every weight byte is used for one multiply-add (batch 1), far
// below the int8 tensor-core rate.
//
// Design (first, simple version): one persistent grid of one block per SM
// (at most what the card keeps resident, checked with
// cudaOccupancyMaxActiveBlocksPerMultiprocessor), launched with
// cudaLaunchCooperativeKernel; cooperative_groups' grid.sync() separates the
// phases of a layer that need a row-wide result. Five barriers a layer:
//   P1 attention (one block per head; with the previous layer's qkv epilogue
//      and RoPE for that head in front) -> o quantized per head
//   P2 o-projection partials, one item per (head, 128 columns)
//   P3 every block: heads summed, residual, RMSNorm, int8 (recomputed in
//      every block instead of one more barrier); gate | up items
//   P4 every block: silu(g) * u over all d_ff, its amax, int8; down items
//   P5 every block: residual, next RMSNorm, int8; next qkv items
// An item is 128 columns x a K slice of <= 256 rows of one int8 weight
// matrix: 8 warps split the rows, each lane multiplies 4 columns with
// __dp4a after a 4x4 byte transpose (__byte_perm), the warps meet in shared
// memory, and split-K slices meet in int32 atomics in global memory (exact
// in any order). Data written during the launch is read with __ldcg (L2,
// coherent). No tensor cores, no TMA; the barriers, not the 16 MiB of
// weights a layer, are expected to set the time.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

#define NT 256
#define NWARPS (NT / 32)
#define COLS 128
#define MAX_DH 128
#define MAX_H 64

enum { KIND_NONE = 0, KIND_F32 = 1, KIND_BF16 = 2 };

struct StepArgs {
  const float* q0;
  const float* kn0;
  const float* vn0;
  const float* x0;
  const int8_t* k_all;
  const int8_t* v_all;
  const __nv_bfloat16* ks_all;
  const __nv_bfloat16* vs_all;
  const float* bias;
  const int8_t* wo;
  const float* wos;
  const void* mw;
  const int8_t* wgu;
  const float* sgu;
  const int8_t* wd;
  const float* sd;
  const void* nw;
  const int8_t* wq;
  const float* sq;
  const void* bq;
  const float* cos_f;
  const float* sin_f;
  float* x_out;
  float* kn_out;
  float* vn_out;
  int norm_kind, bq_kind;
  int L, H, T, d, D, F;
  float sm_scale, eps;
  // workspace
  int8_t* o8;    // [H * d] this layer's o, int8 per head
  float* os;     // [H] its scales
  int* part_o;   // [H, D] o-projection products per head
  int* acc_gu;   // [2F]
  int* acc_d;    // [D]
  int* acc_qkv;  // [3 * H * d]
};

__device__ __forceinline__ float load_f(const void* p, int kind, long long i) {
  return kind == KIND_BF16 ? __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(p)[i])
                           : reinterpret_cast<const float*>(p)[i];
}

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

__device__ __forceinline__ double block_sum(double v, double* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  double r = red[0];
#pragma unroll
  for (int i = 1; i < NWARPS; ++i) r += red[i];
  return r;
}

__device__ __forceinline__ float quant_scale(float amax, float floor) {
  return fmaxf(__fdiv_rn(amax, 127.0f), floor);
}

__device__ __forceinline__ int8_t quant(float v, float s) {
  return (int8_t)__float2int_rn(__fdiv_rn(v, s));
}

// RMSNorm of the block's copy of a row (shared memory) with the stacked norm
// weights of one layer, quantized per row into act; returns the scale.
__device__ float norm_quant(const float* x, int n, const void* w, int wkind, float eps,
                            int8_t* act, float* redf, double* redd) {
  double ss = 0.0;
  for (int i = threadIdx.x; i < n; i += NT) {
    const double v = (double)x[i];
    ss += v * v;
  }
  const float var = (float)(block_sum(ss, redd) / (double)n);
  const float inv = __frcp_rn(__fsqrt_rn(__fadd_rn(var, eps)));
  float amax = 0.0f;
  for (int i = threadIdx.x; i < n; i += NT) {
    amax = fmaxf(amax, fabsf(__fmul_rn(__fmul_rn(x[i], inv), load_f(w, wkind, i))));
  }
  const float s = quant_scale(block_max(amax, redf), 1e-8f);
  for (int i = threadIdx.x; i < n; i += NT) {
    act[i] = quant(__fmul_rn(__fmul_rn(x[i], inv), load_f(w, wkind, i)), s);
  }
  __syncthreads();
  return s;
}

// int32 sums over rows [k0, k0 + kb) of W ([K, N] int8, N contiguous) for
// columns [n0, n0 + 128), with the int8 activations a8 (shared memory,
// indexed by k); the result is in red[0..127] after the trailing barrier.
__device__ void gemv_tile(const int8_t* __restrict__ W, int N, const int8_t* a8, int k0, int kb,
                          int n0, int* red) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  __syncthreads();
  if (threadIdx.x < COLS) red[threadIdx.x] = 0;
  __syncthreads();
  const int n = n0 + lane * 4;
  const int kw = kb / NWARPS;  // a multiple of 4
  const int kbeg = k0 + warp * kw;
  if (n < N) {
    int c0 = 0, c1 = 0, c2 = 0, c3 = 0;
    const int8_t* wp = W + (long long)kbeg * N + n;
#pragma unroll 4
    for (int kk = 0; kk < kw; kk += 4) {
      const int w0 = __ldg(reinterpret_cast<const int*>(wp + (long long)(kk + 0) * N));
      const int w1 = __ldg(reinterpret_cast<const int*>(wp + (long long)(kk + 1) * N));
      const int w2 = __ldg(reinterpret_cast<const int*>(wp + (long long)(kk + 2) * N));
      const int w3 = __ldg(reinterpret_cast<const int*>(wp + (long long)(kk + 3) * N));
      // 4 k-rows x 4 columns -> one word per column holding its 4 k-values
      const int t0 = __byte_perm(w0, w1, 0x5140);
      const int t1 = __byte_perm(w0, w1, 0x7362);
      const int t2 = __byte_perm(w2, w3, 0x5140);
      const int t3 = __byte_perm(w2, w3, 0x7362);
      const int av = *reinterpret_cast<const int*>(a8 + kbeg + kk);
      c0 = __dp4a((int)__byte_perm(t0, t2, 0x5410), av, c0);
      c1 = __dp4a((int)__byte_perm(t0, t2, 0x7632), av, c1);
      c2 = __dp4a((int)__byte_perm(t1, t3, 0x5410), av, c2);
      c3 = __dp4a((int)__byte_perm(t1, t3, 0x7632), av, c3);
    }
    atomicAdd(&red[lane * 4 + 0], c0);
    atomicAdd(&red[lane * 4 + 1], c1);
    atomicAdd(&red[lane * 4 + 2], c2);
    atomicAdd(&red[lane * 4 + 3], c3);
  }
  __syncthreads();
}

// K rows per split-K slice: the largest of 256/128/64/32 dividing K.
__host__ __device__ __forceinline__ int pick_kb(int K) {
  return K % 256 == 0 ? 256 : K % 128 == 0 ? 128 : K % 64 == 0 ? 64 : 32;
}

// acc[n] += act . W[:, n] over all rows, split into items of (K slice,
// 128 columns) strided over the grid.
__device__ void gemv_atomic(const int8_t* __restrict__ W, int K, int N, const int8_t* act,
                            int* acc, int* red) {
  const int kb = pick_kb(K);
  const int nt = (N + COLS - 1) / COLS;
  const int items = (K / kb) * nt;
  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    const int n0 = (it % nt) * COLS;
    gemv_tile(W, N, act, (it / nt) * kb, kb, n0, red);
    if (threadIdx.x < COLS && n0 + threadIdx.x < N) atomicAdd(&acc[n0 + threadIdx.x], red[threadIdx.x]);
  }
}

// The qkv epilogue of one head from the accumulated products of layer
// ``ql``: y = (i32 * s_row) * sq (+ bq), RoPE on the q and k rows.
__device__ void qkv_head(const StepArgs& a, int ql, int h, float s_row, float* y3, float* q,
                         float* kn, float* vn) {
  const int d = a.d, Hd = a.H * a.d;
  const long long base = (long long)ql * 3 * Hd;
  for (int i = threadIdx.x; i < 3 * d; i += NT) {
    const int r = i / d, j = i - r * d;
    const int c = r * Hd + h * d + j;
    float y = __fmul_rn(__fmul_rn(__int2float_rn(__ldcg(&a.acc_qkv[c])), s_row), a.sq[base + c]);
    if (a.bq_kind != KIND_NONE) y = __fadd_rn(y, load_f(a.bq, a.bq_kind, base + c));
    y3[i] = y;
  }
  __syncthreads();
  const int half = d / 2;
  for (int j = threadIdx.x; j < d; j += NT) {
    const int sw = j < half ? j + half : j - half;
    const float c = a.cos_f[j], s = a.sin_f[j];
    q[j] = __fadd_rn(__fmul_rn(y3[j], c), __fmul_rn(y3[sw], s));
    kn[j] = __fadd_rn(__fmul_rn(y3[d + j], c), __fmul_rn(y3[d + sw], s));
    vn[j] = y3[2 * d + j];
  }
  __syncthreads();
}

__global__ void __launch_bounds__(NT) decode_step_kernel(StepArgs a) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int red_i[COLS];
  __shared__ float red_f[NWARPS];
  __shared__ double red_d[NWARPS];
  __shared__ float head_s[MAX_H];
  __shared__ float q_s[MAX_DH], kn_s[MAX_DH], vn_s[MAX_DH], o_s[MAX_DH];
  __shared__ float y3[3 * MAX_DH];
  __shared__ __align__(16) int8_t q8_s[MAX_DH];
  __shared__ int oacc_s[MAX_DH];
  __shared__ float snew_s;

  const int L = a.L, H = a.H, T = a.T, d = a.d, D = a.D, F = a.F;
  const int Hd = H * d, Q = 3 * Hd;
  const int tid = threadIdx.x;
  float* xres = reinterpret_cast<float*>(smem);          // [D] the residual, this block's copy
  float* x2 = xres + D;                                  // [D] after the o-projection
  float* buf = x2 + D;                                   // [max(F, T)] scores / hidden
  const int nbuf = F > T ? F : T;
  int8_t* act = reinterpret_cast<int8_t*>(buf + nbuf);   // int8 activations / probabilities

  for (int i = tid; i < D; i += NT) xres[i] = a.x0[i];
  float s_row = 0.0f;  // the scale of the next layer's qkv activations (P5 -> P1)
  float hs = 0.0f, ms = 0.0f;

  for (int l = 0; l < L; ++l) {
    // ── P1: attention, one block per head ──
    for (int h = blockIdx.x; h < H; h += gridDim.x) {
      if (l == 0) {
        for (int j = tid; j < d; j += NT) {
          q_s[j] = a.q0[h * d + j];
          kn_s[j] = a.kn0[h * d + j];
          vn_s[j] = a.vn0[h * d + j];
        }
        __syncthreads();
      } else {
        qkv_head(a, l, h, s_row, y3, q_s, kn_s, vn_s);
        for (int j = tid; j < d; j += NT) {
          a.kn_out[((long long)(l - 1) * H + h) * d + j] = kn_s[j];
          a.vn_out[((long long)(l - 1) * H + h) * d + j] = vn_s[j];
        }
      }
      const float qs = quant_scale(block_max(tid < d ? fabsf(q_s[tid]) : 0.0f, red_f), 1e-8f);
      if (tid < d) {
        q8_s[tid] = quant(q_s[tid], qs);
        oacc_s[tid] = 0;
      }
      if (tid == 0) {
        double acc = 0.0;
        for (int j = 0; j < d; ++j) acc += (double)q_s[j] * (double)kn_s[j];
        snew_s = __fmul_rn((float)acc, a.sm_scale);
      }
      __syncthreads();
      const float qsm = __fmul_rn(qs, a.sm_scale);
      const long long lh = (long long)l * H + h;
      const int8_t* kb = a.k_all + lh * T * d;
      const int8_t* vb = a.v_all + lh * T * d;
      const __nv_bfloat16* ksb = a.ks_all + lh * T;
      const __nv_bfloat16* vsb = a.vs_all + lh * T;
      float lmax = -INFINITY;
      for (int t = tid; t < T; t += NT) {
        const int4* kr = reinterpret_cast<const int4*>(kb + (long long)t * d);
        const int* qw = reinterpret_cast<const int*>(q8_s);
        int dot = 0;
        for (int w = 0; w < d / 16; ++w) {
          const int4 kv = __ldg(kr + w);
          dot = __dp4a(kv.x, qw[4 * w + 0], dot);
          dot = __dp4a(kv.y, qw[4 * w + 1], dot);
          dot = __dp4a(kv.z, qw[4 * w + 2], dot);
          dot = __dp4a(kv.w, qw[4 * w + 3], dot);
        }
        float s = __fmul_rn(__int2float_rn(dot), qsm);
        s = __fadd_rn(__fmul_rn(s, __bfloat162float(ksb[t])), a.bias[t]);
        buf[t] = s;
        lmax = fmaxf(lmax, s);
      }
      const float snew = snew_s;
      const float m = fmaxf(block_max(lmax, red_f), snew);
      double lsum_part = 0.0;
      for (int t = tid; t < T; t += NT) {
        const float p = expf(__fsub_rn(buf[t], m));
        lsum_part += (double)p;
        buf[t] = p;
      }
      const float p_new = expf(__fsub_rn(snew, m));
      const float l_sum = __fadd_rn((float)block_sum(lsum_part, red_d), p_new);
      float pmax = 0.0f;
      for (int t = tid; t < T; t += NT) {
        const float pv = __fmul_rn(buf[t], __bfloat162float(vsb[t]));
        buf[t] = pv;
        pmax = fmaxf(pmax, pv);
      }
      const float ps = quant_scale(block_max(pmax, red_f), 1e-20f);
      for (int t = tid; t < T; t += NT) act[t] = quant(buf[t], ps);
      __syncthreads();
      // o_i32 = p8 . v over T: d / 4 threads cover a row's columns, the
      // rest of the block splits T
      const int cols4 = d / 4;
      const int groups = NT / cols4;
      const int grp = tid / cols4, cq = tid - grp * cols4;
      if (grp < groups) {
        int c0 = 0, c1 = 0, c2 = 0, c3 = 0;
        const int8_t* vp = vb + cq * 4;
        for (int t = grp * 4; t < T; t += groups * 4) {
          const int w0 = __ldg(reinterpret_cast<const int*>(vp + (long long)(t + 0) * d));
          const int w1 = __ldg(reinterpret_cast<const int*>(vp + (long long)(t + 1) * d));
          const int w2 = __ldg(reinterpret_cast<const int*>(vp + (long long)(t + 2) * d));
          const int w3 = __ldg(reinterpret_cast<const int*>(vp + (long long)(t + 3) * d));
          const int t0 = __byte_perm(w0, w1, 0x5140);
          const int t1 = __byte_perm(w0, w1, 0x7362);
          const int t2 = __byte_perm(w2, w3, 0x5140);
          const int t3 = __byte_perm(w2, w3, 0x7362);
          const int pw = *reinterpret_cast<const int*>(act + t);
          c0 = __dp4a((int)__byte_perm(t0, t2, 0x5410), pw, c0);
          c1 = __dp4a((int)__byte_perm(t0, t2, 0x7632), pw, c1);
          c2 = __dp4a((int)__byte_perm(t1, t3, 0x5410), pw, c2);
          c3 = __dp4a((int)__byte_perm(t1, t3, 0x7632), pw, c3);
        }
        atomicAdd(&oacc_s[cq * 4 + 0], c0);
        atomicAdd(&oacc_s[cq * 4 + 1], c1);
        atomicAdd(&oacc_s[cq * 4 + 2], c2);
        atomicAdd(&oacc_s[cq * 4 + 3], c3);
      }
      __syncthreads();
      float oa = 0.0f;
      if (tid < d) {
        const float num = __fadd_rn(__fmul_rn(__int2float_rn(oacc_s[tid]), ps),
                                    __fmul_rn(p_new, vn_s[tid]));
        o_s[tid] = __fdiv_rn(num, fmaxf(l_sum, 1e-30f));
        oa = fabsf(o_s[tid]);
      }
      const float osc = quant_scale(block_max(oa, red_f), 1e-8f);
      if (tid < d) a.o8[h * d + tid] = quant(o_s[tid], osc);
      if (tid == 0) a.os[h] = osc;
      __syncthreads();
    }
    grid.sync();

    // ── P2: o-projection partials per (head, 128 columns); clear the
    // accumulators this layer adds into (last read before the barrier) ──
    {
      const long long gt = (long long)blockIdx.x * NT + tid, gn = (long long)gridDim.x * NT;
      for (long long i = gt; i < 2LL * F; i += gn) a.acc_gu[i] = 0;
      for (long long i = gt; i < D; i += gn) a.acc_d[i] = 0;
      for (long long i = gt; i < Q; i += gn) a.acc_qkv[i] = 0;
      const int nt = (D + COLS - 1) / COLS;
      const int items = H * nt;
      if (blockIdx.x < items) {
        for (int i = tid; i < Hd; i += NT) act[i] = __ldcg(&a.o8[i]);
      }
      const int8_t* wo_l = a.wo + (long long)l * Hd * D;
      for (int it = blockIdx.x; it < items; it += gridDim.x) {
        const int h = it / nt, n0 = (it - h * nt) * COLS;
        gemv_tile(wo_l, D, act, h * d, d, n0, red_i);
        if (tid < COLS && n0 + tid < D) a.part_o[(long long)h * D + n0 + tid] = red_i[tid];
      }
    }
    grid.sync();

    // ── P3: heads summed + residual, RMSNorm, int8 (every block); gate | up ──
    {
      for (int h = tid; h < H; h += NT) head_s[h] = __ldcg(&a.os[h]);
      __syncthreads();
      const float* wos_l = a.wos + (long long)l * D;
      for (int n = tid; n < D; n += NT) {
        float acc = __fmul_rn(__int2float_rn(__ldcg(&a.part_o[n])), head_s[0]);
        for (int h = 1; h < H; ++h) {
          acc = __fadd_rn(acc, __fmul_rn(__int2float_rn(__ldcg(&a.part_o[(long long)h * D + n])),
                                         head_s[h]));
        }
        x2[n] = __fadd_rn(xres[n], __fmul_rn(acc, wos_l[n]));
      }
      __syncthreads();
      const int esz = a.norm_kind == KIND_BF16 ? 2 : 4;
      hs = norm_quant(x2, D, reinterpret_cast<const char*>(a.mw) + (long long)l * D * esz,
                      a.norm_kind, a.eps, act, red_f, red_d);
      gemv_atomic(a.wgu + (long long)l * D * 2 * F, D, 2 * F, act, a.acc_gu, red_i);
    }
    grid.sync();

    // ── P4: silu(g) * u over all of d_ff, one scale, int8 (every block); down ──
    {
      const float* sg = a.sgu + (long long)l * 2 * F;
      float amax = 0.0f;
      for (int n = tid; n < F; n += NT) {
        const float g = __fmul_rn(__fmul_rn(__int2float_rn(__ldcg(&a.acc_gu[n])), hs), sg[n]);
        const float u = __fmul_rn(__fmul_rn(__int2float_rn(__ldcg(&a.acc_gu[F + n])), hs), sg[F + n]);
        const float v = __fmul_rn(__fmul_rn(g, __frcp_rn(__fadd_rn(1.0f, expf(-g)))), u);
        buf[n] = v;
        amax = fmaxf(amax, fabsf(v));
      }
      ms = quant_scale(block_max(amax, red_f), 1e-8f);
      for (int n = tid; n < F; n += NT) act[n] = quant(buf[n], ms);
      __syncthreads();
      gemv_atomic(a.wd + (long long)l * F * D, F, D, act, a.acc_d, red_i);
    }
    grid.sync();

    // ── P5: down + residual (every block), the next layer's RMSNorm + int8; qkv ──
    {
      const float* sd_l = a.sd + (long long)l * D;
      for (int n = tid; n < D; n += NT) {
        const float xo = __fadd_rn(
            x2[n], __fmul_rn(__fmul_rn(__int2float_rn(__ldcg(&a.acc_d[n])), ms), sd_l[n]));
        xres[n] = xo;
        if (l == L - 1 && blockIdx.x == 0) a.x_out[n] = xo;
      }
      __syncthreads();
      const int nxt = l + 1 < L ? l + 1 : L - 1;
      const int esz = a.norm_kind == KIND_BF16 ? 2 : 4;
      s_row = norm_quant(xres, D, reinterpret_cast<const char*>(a.nw) + (long long)nxt * D * esz,
                         a.norm_kind, a.eps, act, red_f, red_d);
      gemv_atomic(a.wq + (long long)nxt * D * Q, D, Q, act, a.acc_qkv, red_i);
    }
    grid.sync();
  }

  // the last layer's successor (layer L - 1's own weights): output row L - 1
  for (int h = blockIdx.x; h < H; h += gridDim.x) {
    qkv_head(a, L - 1, h, s_row, y3, q_s, kn_s, vn_s);
    for (int j = tid; j < d; j += NT) {
      a.kn_out[((long long)(L - 1) * H + h) * d + j] = kn_s[j];
      a.vn_out[((long long)(L - 1) * H + h) * d + j] = vn_s[j];
    }
  }
}

// ── host side ────────────────────────────────────────────────────────────

static long long align256(long long n) { return (n + 255) / 256 * 256; }

static bool shapes_ok(int H, int d, int D, int F, int T) {
  return H >= 1 && H <= MAX_H && d >= 32 && d <= MAX_DH && d % 32 == 0 && D >= 32 &&
         D % 32 == 0 && F >= 32 && F % 32 == 0 && T >= 128 && T % 128 == 0;
}

static size_t smem_bytes(int H, int d, int D, int F, int T) {
  long long act = D;
  if (F > act) act = F;
  if ((long long)H * d > act) act = (long long)H * d;
  if (T > act) act = T;
  act = (act + 15) / 16 * 16;
  const long long nbuf = F > T ? F : T;
  return (size_t)(2LL * D * 4 + nbuf * 4 + act);
}

// SMs and resident blocks per SM at these shapes (0 on success).
static int occupancy(int H, int d, int D, int F, int T, int* sms, int* per_sm) {
  const size_t smem = smem_bytes(H, d, D, F, T);
  cudaError_t e = cudaFuncSetAttribute(decode_step_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  int dev = 0;
  e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, decode_step_kernel, NT, smem);
  return (int)e;
}

extern "C" long long vt_decode_step_workspace(int H, int d, int D, int F) {
  return align256((long long)H * d) + align256((long long)H * 4) +
         align256((long long)H * D * 4) + align256(2LL * F * 4) + align256((long long)D * 4) +
         align256(3LL * H * d * 4);
}

// The largest grid a cooperative launch accepts (SMs x resident blocks).
extern "C" int vt_decode_step_max_blocks(int H, int d, int D, int F, int T) {
  if (!shapes_ok(H, d, D, F, T)) return -(int)cudaErrorInvalidValue;
  int sms = 0, per_sm = 0;
  const int rc = occupancy(H, d, D, F, T, &sms, &per_sm);
  return rc ? -rc : sms * per_sm;
}

// B7: one cooperative launch. grid <= 0 takes one block per SM.
extern "C" int vt_decode_step_fused(
    const void* q0, const void* kn0, const void* vn0, const void* x,
    const void* k_all, const void* v_all, const void* k_scale, const void* v_scale,
    const void* bias, const void* wo, const void* wos, const void* mw,
    const void* wgu, const void* sgu, const void* wd, const void* sd,
    const void* nw, const void* wq, const void* sq, const void* bq,
    const void* cos_f, const void* sin_f, void* x_out, void* kn_out, void* vn_out,
    int norm_kind, int bq_kind, int grid,
    int L, int H, int T, int d, int D, int F, float sm_scale, float eps,
    void* ws, long long ws_bytes, void* stream) {
  if (L < 1 || !shapes_ok(H, d, D, F, T) || ws_bytes < vt_decode_step_workspace(H, d, D, F)) {
    return (int)cudaErrorInvalidValue;
  }
  int sms = 0, per_sm = 0;
  int rc = occupancy(H, d, D, F, T, &sms, &per_sm);
  if (rc) return rc;
  if (grid <= 0) {
    if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
    grid = sms;
  }
  StepArgs a;
  a.q0 = (const float*)q0;
  a.kn0 = (const float*)kn0;
  a.vn0 = (const float*)vn0;
  a.x0 = (const float*)x;
  a.k_all = (const int8_t*)k_all;
  a.v_all = (const int8_t*)v_all;
  a.ks_all = (const __nv_bfloat16*)k_scale;
  a.vs_all = (const __nv_bfloat16*)v_scale;
  a.bias = (const float*)bias;
  a.wo = (const int8_t*)wo;
  a.wos = (const float*)wos;
  a.mw = mw;
  a.wgu = (const int8_t*)wgu;
  a.sgu = (const float*)sgu;
  a.wd = (const int8_t*)wd;
  a.sd = (const float*)sd;
  a.nw = nw;
  a.wq = (const int8_t*)wq;
  a.sq = (const float*)sq;
  a.bq = bq;
  a.cos_f = (const float*)cos_f;
  a.sin_f = (const float*)sin_f;
  a.x_out = (float*)x_out;
  a.kn_out = (float*)kn_out;
  a.vn_out = (float*)vn_out;
  a.norm_kind = norm_kind;
  a.bq_kind = bq == nullptr ? KIND_NONE : bq_kind;
  a.L = L;
  a.H = H;
  a.T = T;
  a.d = d;
  a.D = D;
  a.F = F;
  a.sm_scale = sm_scale;
  a.eps = eps;
  char* p = (char*)ws;
  a.o8 = (int8_t*)p;
  p += align256((long long)H * d);
  a.os = (float*)p;
  p += align256((long long)H * 4);
  a.part_o = (int*)p;
  p += align256((long long)H * D * 4);
  a.acc_gu = (int*)p;
  p += align256(2LL * F * 4);
  a.acc_d = (int*)p;
  p += align256((long long)D * 4);
  a.acc_qkv = (int*)p;
  void* params[] = {&a};
  cudaError_t e = cudaLaunchCooperativeKernel((const void*)decode_step_kernel, dim3(grid), dim3(NT),
                                              params, smem_bytes(H, d, D, F, T),
                                              (cudaStream_t)stream);
  if (e != cudaSuccess) {
    cudaGetLastError();  // a refused launch leaves no sticky error; clear the last one
    return (int)e;
  }
  return (int)cudaGetLastError();
}
