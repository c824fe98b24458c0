// int8-native dense decode-step kernels: B4 (one int8 product), B3 (RMSNorm
// + the fused int8 qkv product), B8b (the int8 SwiGLU MLP alone), and their
// GPT-2 (XTTS) siblings: B9a (LayerNorm + qkv), B9b (the GELU layer tail +
// the next layer's LayerNorm and qkv), B9c (the GELU tail alone) and B9d
// (the int8 GELU MLP alone). B2 and B8a (the SwiGLU layer tail) are one
// tensor-core launch of their own, in tail_swiglu.cu.
//
// Replaces, in vocalie_tts_tpu/ops/decode_dense.py:
//   B4 dense_int8_stacked             (def :116, pallas_call :143)
//   B3 qkv_norm_int8_stacked          (def :269, pallas_call :302)
//   B8b mlp_swiglu_int8_stacked       (def :190, pallas_call :234)
//   B9a qkv_lnorm_int8_stacked        (def :652, pallas_call :686)
//   B9c tail_gelu_int8_stacked        (def :752, pallas_call :811)
//   B9b tail_gelu_qkv_int8_stacked    (def :985, pallas_call :1084)
//   B9d mlp_gelu_int8_stacked         (def :862, pallas_call :898)
// The math is theirs, step for step:
//   * activations are quantized per row: s = max(max|x| / 127, 1e-8),
//     q = round_half_even(x / s) (an IEEE divide, no clip);
//   * RMSNorm in f32 before quantizing: x * (1 / sqrt(mean(x*x) + eps)) * w,
//     with the mean of the squares summed in double and rounded to f32 once
//     (JAX sums in f32; this keeps the kernel bit-equal to its plain version
//     in any summation order, and within an ulp of JAX);
//   * products are int8 x int8 summed in int32 (exact in any order), then
//     the f32 epilogue in JAX's order: (float(y) * x_scale) * w_scale, plus
//     the residual where there is one;
//   * the SwiGLU hidden silu(g) * u is quantized per (row, d_ff TILE), not per
//     row: the down-projection sums one f32 part per tile,
//     acc = d_0 + d_1 + ..., d_t = float(y_t) * s_t, then x2 + acc * s_down;
//   * the next layer's qkv reads layer min(l + 1, L - 1);
//   * LayerNorm (B9): mean, then the mean of the squared centred values,
//     each summed in double and rounded to f32 once, then
//     ((x - mean) * (1 / sqrt(var + eps))) * g + b;
//   * the GELU tail (B9): o = y * s_a * s_o + bo, x2 = x + o;
//     u = y * s_h * s_u + bu; h = tanh-GELU(u) as jax.nn.gelu spells it,
//     u * (0.5 * (1 + tanhf(sqrt(2/pi) * (u + 0.044715 * (u * u) * u))));
//     h quantized per (row, d_ff tile) as for SwiGLU; out = (x2 + acc * s_d)
//     + bd. Every f32 step is an explicit IEEE intrinsic, so nvcc contracts
//     nothing into an FMA and the plain PyTorch version rounds alike.
// Weights keep the JAX layout [L, K, N] (N contiguous); the layer is an
// offset into the stacked array, nothing is copied.
//
// Bound: bytes. At the decode shapes (b = 16) every weight byte is used for
// 16 multiply-adds, far below the ~590 int8 operations per byte at which
// Hopper's tensor cores become the limit. B3 at full width reads 3.1 MB of
// int8 weights per call, B4 (the lm_head) 1.2 MB; at the XTTS layer (b = 8)
// B9b reads 12.6 MB, B9c 9.4 MB, B9a 3.1 MB; at the Qwen3 layer (d_model
// 2048, d_ff 8192, qkv 4096, b = 8) B8b 50.3 MB, B3 8.4 MB.
//
// Design (first, simple version). The TPU ran each of these as one
// sequential grid carrying scratch from step to step; GPU blocks run in no
// order, and B9b needs four reductions across a whole row (the norm after the
// o-projection, the hidden's per-tile amax, the sum over tiles with the norm
// after it, the next qkv). So each entry point is a short sequence of
// kernels on the caller's stream, with intermediates in a workspace the
// wrapper allocates:
//   norm_quant   one block per row: optional RMSNorm, amax, int8 + scale;
//   gemv_partial a block owns 128 columns (32 lanes x 4) and one K slice,
//                holds ALL rows of the batch (each weight byte is read once
//                per call for b <= 16), splits its slice over 8 warps, and
//                multiplies with __dp4a after a 4x4 byte transpose
//                (__byte_perm) of four k-rows of four columns; the warps'
//                int32 sums meet in shared memory, and the block writes one
//                int32 partial per (row, column);
//   gemv_finish  sums the partials of each K tile (int32, exact), then the
//                f32 epilogue above;
//   swiglu_quant one block per (row, d_ff tile): silu(g) * u, amax, int8;
//   ln_quant     one block per row: LayerNorm, amax, int8 + scale;
//   gelu_quant   one block per (row, d_ff tile): tanh-GELU, amax, int8.
// The finish takes an optional bias, added before the residual (the
// o-projection, the fc) or after it (the down-projection), as JAX orders
// them. B4, B3 and B9a are 3 launches, B9b 12, B9c 9, B8b and B9d 6.
// No tensor cores, no TMA.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#define QUANT_THREADS 256
#define GEMV_THREADS 256
#define GEMV_WARPS (GEMV_THREADS / 32)
#define COLS 128      // columns per gemv block: 32 lanes x 4
#define RB 16         // batch rows per pass of a gemv block
#define KB_MAX 256    // K rows per gemv block, at most
#define FIN_THREADS 256

enum { KIND_NONE = 0, KIND_F32 = 1, KIND_BF16 = 2 };

__device__ __forceinline__ float load_f(const void* p, int kind, long long i) {
  return kind == KIND_BF16 ? __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(p)[i])
                           : reinterpret_cast<const float*>(p)[i];
}

template <int NT>
__device__ __forceinline__ double block_sum(double v, double* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  double r = red[0];
#pragma unroll
  for (int i = 1; i < NT / 32; ++i) r += red[i];
  return r;
}

template <int NT>
__device__ __forceinline__ float block_max(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float r = red[0];
#pragma unroll
  for (int i = 1; i < NT / 32; ++i) r = fmaxf(r, red[i]);
  return r;
}

__device__ __forceinline__ float quant_scale(float amax) {
  return fmaxf(__fdiv_rn(amax, 127.0f), 1e-8f);
}

// ── norm + per-row quantization ──────────────────────────────────────────

__global__ void __launch_bounds__(QUANT_THREADS) norm_quant_kernel(
    const void* __restrict__ x, int x_kind,      // [b, d]
    const void* __restrict__ nw, int nw_kind,    // [d] or null (no norm)
    float eps, int d,
    int8_t* __restrict__ q,                      // [b, d]
    float* __restrict__ qs) {                    // [b]
  __shared__ float red[QUANT_THREADS / 32];
  __shared__ double red_d[QUANT_THREADS / 32];
  const long long base = (long long)blockIdx.x * d;
  float inv = 1.0f;
  if (nw_kind != KIND_NONE) {
    // squares are exact in double and their sum is rounded to f32 only at
    // the end, so the variance does not depend on the summation order
    double ss = 0.0;
    for (int i = threadIdx.x; i < d; i += QUANT_THREADS) {
      const double v = (double)load_f(x, x_kind, base + i);
      ss += v * v;
    }
    const float var = (float)(block_sum<QUANT_THREADS>(ss, red_d) / (double)d);
    inv = __frcp_rn(__fsqrt_rn(__fadd_rn(var, eps)));
  }
  // the normed value is recomputed in each pass (same ops, same bits)
  float amax = 0.0f;
  for (int i = threadIdx.x; i < d; i += QUANT_THREADS) {
    float h = load_f(x, x_kind, base + i);
    if (nw_kind != KIND_NONE) h = __fmul_rn(__fmul_rn(h, inv), load_f(nw, nw_kind, i));
    amax = fmaxf(amax, fabsf(h));
  }
  const float s = quant_scale(block_max<QUANT_THREADS>(amax, red));
  for (int i = threadIdx.x; i < d; i += QUANT_THREADS) {
    float h = load_f(x, x_kind, base + i);
    if (nw_kind != KIND_NONE) h = __fmul_rn(__fmul_rn(h, inv), load_f(nw, nw_kind, i));
    q[base + i] = (int8_t)__float2int_rn(__fdiv_rn(h, s));
  }
  if (threadIdx.x == 0) qs[blockIdx.x] = s;
}

// ── int8 x int8 products: partial sums over K slices ─────────────────────

__global__ void __launch_bounds__(GEMV_THREADS) gemv_partial_kernel(
    const int8_t* __restrict__ a8, int b, int K,   // [b, K] activations
    const int8_t* __restrict__ w, int N,           // [K, N] weights of one layer
    int kb,                                        // K rows of this block's slice
    int* __restrict__ part) {                      // [K / kb, b, N]
  __shared__ int red[RB * COLS];
  __shared__ __align__(16) int a_s[RB * KB_MAX / 4];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n = blockIdx.x * COLS + lane * 4;
  const bool col_ok = n < N;
  const int k0 = blockIdx.y * kb;
  const int kw = kb / GEMV_WARPS;    // rows per warp, a multiple of 4
  const int kw0 = warp * kw;
  const int kb4 = kb / 4;
  int* pout = part + (long long)blockIdx.y * b * N;

  for (int r0 = 0; r0 < b; r0 += RB) {
    const int nr = min(RB, b - r0);
    for (int i = threadIdx.x; i < nr * kb4; i += GEMV_THREADS) {
      const int r = i / kb4, c = i - r * kb4;
      a_s[r * (KB_MAX / 4) + c] =
          *reinterpret_cast<const int*>(a8 + (long long)(r0 + r) * K + k0 + 4 * c);
    }
    for (int i = threadIdx.x; i < RB * COLS; i += GEMV_THREADS) red[i] = 0;
    __syncthreads();

    if (col_ok) {
      int acc[RB][4];
#pragma unroll
      for (int r = 0; r < RB; ++r) acc[r][0] = acc[r][1] = acc[r][2] = acc[r][3] = 0;
      const int8_t* wp = w + (long long)(k0 + kw0) * N + n;
#pragma unroll 2
      for (int kk = 0; kk < kw; kk += 4) {
        const int w0 = __ldg(reinterpret_cast<const int*>(wp + (long long)(kk + 0) * N));
        const int w1 = __ldg(reinterpret_cast<const int*>(wp + (long long)(kk + 1) * N));
        const int w2 = __ldg(reinterpret_cast<const int*>(wp + (long long)(kk + 2) * N));
        const int w3 = __ldg(reinterpret_cast<const int*>(wp + (long long)(kk + 3) * N));
        // 4 k-rows x 4 columns -> one word per column holding its 4 k-values
        const int t0 = __byte_perm(w0, w1, 0x5140);  // w0.b0 w1.b0 w0.b1 w1.b1
        const int t1 = __byte_perm(w0, w1, 0x7362);  // w0.b2 w1.b2 w0.b3 w1.b3
        const int t2 = __byte_perm(w2, w3, 0x5140);
        const int t3 = __byte_perm(w2, w3, 0x7362);
        const int c0 = __byte_perm(t0, t2, 0x5410);
        const int c1 = __byte_perm(t0, t2, 0x7632);
        const int c2 = __byte_perm(t1, t3, 0x5410);
        const int c3 = __byte_perm(t1, t3, 0x7632);
        const int aw = (kw0 + kk) / 4;
#pragma unroll
        for (int r = 0; r < RB; ++r) {
          if (r < nr) {
            const int av = a_s[r * (KB_MAX / 4) + aw];
            acc[r][0] = __dp4a(c0, av, acc[r][0]);
            acc[r][1] = __dp4a(c1, av, acc[r][1]);
            acc[r][2] = __dp4a(c2, av, acc[r][2]);
            acc[r][3] = __dp4a(c3, av, acc[r][3]);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        if (r < nr) {
#pragma unroll
          for (int j = 0; j < 4; ++j) atomicAdd(&red[r * COLS + lane * 4 + j], acc[r][j]);
        }
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < nr * COLS; i += GEMV_THREADS) {
      const int r = i / COLS, c = i - r * COLS;
      const int nn = blockIdx.x * COLS + c;
      if (nn < N) pout[(long long)(r0 + r) * N + nn] = red[i];
    }
    __syncthreads();
  }
}

// ── partial sums -> f32 epilogue ─────────────────────────────────────────

__global__ void __launch_bounds__(FIN_THREADS) gemv_finish_kernel(
    const int* __restrict__ part, int splits_per_tile, int n_tiles,
    const float* __restrict__ xs,                  // [b, n_tiles] activation scales
    const float* __restrict__ s,                   // [N] weight scales
    const void* __restrict__ bias, int bias_kind,  // [N] or null
    int bias_last,                                 // add the bias after the residual
    const void* __restrict__ resid, int resid_kind,  // [b, N] or null
    float* __restrict__ out, int b, int N) {       // [b, N]
  const long long i = (long long)blockIdx.x * FIN_THREADS + threadIdx.x;
  const long long bn = (long long)b * N;
  if (i >= bn) return;
  const int r = (int)(i / N);
  const int n = (int)(i - (long long)r * N);
  float acc = 0.0f;
  for (int t = 0; t < n_tiles; ++t) {
    int y = 0;
    for (int sp = t * splits_per_tile; sp < (t + 1) * splits_per_tile; ++sp) y += part[sp * bn + i];
    const float dt = __fmul_rn(__int2float_rn(y), xs[r * n_tiles + t]);
    acc = t == 0 ? dt : __fadd_rn(acc, dt);
  }
  float v = __fmul_rn(acc, s[n]);
  if (bias_kind != KIND_NONE && !bias_last) v = __fadd_rn(v, load_f(bias, bias_kind, n));
  if (resid_kind != KIND_NONE) v = __fadd_rn(load_f(resid, resid_kind, i), v);
  if (bias_kind != KIND_NONE && bias_last) v = __fadd_rn(v, load_f(bias, bias_kind, n));
  out[i] = v;
}

// ── SwiGLU hidden, quantized per (row, d_ff tile) ───────────────────────

__global__ void __launch_bounds__(QUANT_THREADS) swiglu_quant_kernel(
    const float* __restrict__ gu,     // [b, 2F]: gate | up
    int F, int tile,
    int8_t* __restrict__ hq,          // [b, F]
    float* __restrict__ hs) {         // [b, F / tile]
  __shared__ float red[QUANT_THREADS / 32];
  const int t = blockIdx.x, r = blockIdx.y, n_tiles = gridDim.x;
  const float* g = gu + (long long)r * 2 * F + (long long)t * tile;
  const float* u = g + F;
  float amax = 0.0f;
  for (int c = threadIdx.x; c < tile; c += QUANT_THREADS) {
    const float gv = g[c];
    const float h = __fmul_rn(__fmul_rn(gv, __frcp_rn(__fadd_rn(1.0f, expf(-gv)))), u[c]);
    amax = fmaxf(amax, fabsf(h));
  }
  const float s = quant_scale(block_max<QUANT_THREADS>(amax, red));
  int8_t* qo = hq + (long long)r * F + (long long)t * tile;
  for (int c = threadIdx.x; c < tile; c += QUANT_THREADS) {
    const float gv = g[c];
    const float h = __fmul_rn(__fmul_rn(gv, __frcp_rn(__fadd_rn(1.0f, expf(-gv)))), u[c]);
    qo[c] = (int8_t)__float2int_rn(__fdiv_rn(h, s));
  }
  if (threadIdx.x == 0) hs[r * n_tiles + t] = s;
}

// ── LayerNorm + per-row quantization (B9) ────────────────────────────────

__global__ void __launch_bounds__(QUANT_THREADS) ln_quant_kernel(
    const void* __restrict__ x, int x_kind,      // [b, d]
    const void* __restrict__ g, const void* __restrict__ bb, int n_kind,  // [d] gain, bias
    float eps, int d,
    int8_t* __restrict__ q,                      // [b, d]
    float* __restrict__ qs) {                    // [b]
  __shared__ float red[QUANT_THREADS / 32];
  __shared__ double red_d[QUANT_THREADS / 32];
  const long long base = (long long)blockIdx.x * d;
  double sum = 0.0;
  for (int i = threadIdx.x; i < d; i += QUANT_THREADS) sum += (double)load_f(x, x_kind, base + i);
  const float mean = (float)(block_sum<QUANT_THREADS>(sum, red_d) / (double)d);
  double ss = 0.0;
  for (int i = threadIdx.x; i < d; i += QUANT_THREADS) {
    const double c = (double)__fsub_rn(load_f(x, x_kind, base + i), mean);
    ss += c * c;
  }
  const float var = (float)(block_sum<QUANT_THREADS>(ss, red_d) / (double)d);
  const float inv = __frcp_rn(__fsqrt_rn(__fadd_rn(var, eps)));
  // the normed value is recomputed in each pass (same ops, same bits)
  float amax = 0.0f;
  for (int i = threadIdx.x; i < d; i += QUANT_THREADS) {
    const float c = __fsub_rn(load_f(x, x_kind, base + i), mean);
    const float h = __fadd_rn(__fmul_rn(__fmul_rn(c, inv), load_f(g, n_kind, i)),
                              load_f(bb, n_kind, i));
    amax = fmaxf(amax, fabsf(h));
  }
  const float s = quant_scale(block_max<QUANT_THREADS>(amax, red));
  for (int i = threadIdx.x; i < d; i += QUANT_THREADS) {
    const float c = __fsub_rn(load_f(x, x_kind, base + i), mean);
    const float h = __fadd_rn(__fmul_rn(__fmul_rn(c, inv), load_f(g, n_kind, i)),
                              load_f(bb, n_kind, i));
    q[base + i] = (int8_t)__float2int_rn(__fdiv_rn(h, s));
  }
  if (threadIdx.x == 0) qs[blockIdx.x] = s;
}

// ── tanh-GELU hidden, quantized per (row, d_ff tile) (B9) ────────────────

#define GELU_C 0x1.988454p-1f   // float32(sqrt(2 / pi)), as JAX rounds it
#define GELU_A 0x1.6e4e26p-5f   // float32(0.044715)

__device__ __forceinline__ float gelu_tanh(float u) {
  const float u3 = __fmul_rn(__fmul_rn(u, u), u);
  const float t = tanhf(__fmul_rn(GELU_C, __fadd_rn(u, __fmul_rn(GELU_A, u3))));
  return __fmul_rn(u, __fmul_rn(0.5f, __fadd_rn(1.0f, t)));
}

__global__ void __launch_bounds__(QUANT_THREADS) gelu_quant_kernel(
    const float* __restrict__ u,      // [b, F]
    int F, int tile,
    int8_t* __restrict__ hq,          // [b, F]
    float* __restrict__ hs) {         // [b, F / tile]
  __shared__ float red[QUANT_THREADS / 32];
  const int t = blockIdx.x, r = blockIdx.y, n_tiles = gridDim.x;
  const float* ut = u + (long long)r * F + (long long)t * tile;
  float amax = 0.0f;
  for (int c = threadIdx.x; c < tile; c += QUANT_THREADS) amax = fmaxf(amax, fabsf(gelu_tanh(ut[c])));
  const float s = quant_scale(block_max<QUANT_THREADS>(amax, red));
  int8_t* qo = hq + (long long)r * F + (long long)t * tile;
  for (int c = threadIdx.x; c < tile; c += QUANT_THREADS) {
    qo[c] = (int8_t)__float2int_rn(__fdiv_rn(gelu_tanh(ut[c]), s));
  }
  if (threadIdx.x == 0) hs[r * n_tiles + t] = s;
}

// ── host side ────────────────────────────────────────────────────────────

// K rows per gemv block: the largest of 256/128/64 that divides the K tile
// and still gives >= 128 blocks (about one per SM), else the smallest of
// 64/32 that divides it. kb >= 64 keeps the int32 partials (K / kb * b * N
// * 4 bytes) below the weight bytes at b = 16.
static int pick_kb(int kt, int K, int N) {
  const int col_blocks = (N + COLS - 1) / COLS;
  const int big[3] = {256, 128, 64};
  for (int i = 0; i < 3; ++i) {
    if (kt % big[i] == 0 && (long long)col_blocks * (K / big[i]) >= 128) return big[i];
  }
  if (kt % 64 == 0) return 64;
  if (kt % 32 == 0) return 32;
  return 0;
}

static long long align256(long long n) { return (n + 255) / 256 * 256; }

static long long part_bytes(int b, int K, int kt, int N) {
  const int kb = pick_kb(kt, K, N);
  return kb ? align256((long long)(K / kb) * b * N * 4) : -1;
}

struct Carver {
  char* p;
  template <typename T>
  T* take(long long bytes) {
    T* out = reinterpret_cast<T*>(p);
    p += align256(bytes);
    return out;
  }
};

// the finish's optional bias: added before the residual or, with last = 1,
// after it
struct Bias {
  const void* p;
  int kind;
  int last;
};
static const Bias NO_BIAS = {nullptr, KIND_NONE, 0};

static int launch_gemv(cudaStream_t st, const int8_t* a8, const float* xs, int n_tiles, int b,
                       int K, const int8_t* w, const float* s, int N, Bias bias,
                       const void* resid, int resid_kind, float* out, int* part) {
  const int kt = K / n_tiles;
  const int kb = pick_kb(kt, K, N);
  if (kb == 0) return (int)cudaErrorInvalidValue;
  dim3 grid((N + COLS - 1) / COLS, K / kb);
  gemv_partial_kernel<<<grid, GEMV_THREADS, 0, st>>>(a8, b, K, w, N, kb, part);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const long long bn = (long long)b * N;
  gemv_finish_kernel<<<(unsigned)((bn + FIN_THREADS - 1) / FIN_THREADS), FIN_THREADS, 0, st>>>(
      part, kt / kb, n_tiles, xs, s, bias.p, bias.kind, bias.last, resid, resid_kind, out, b, N);
  return (int)cudaGetLastError();
}

// normquant(x) . W + epilogue: 3 launches. The norm: none (nw null), RMS
// (nw), or LayerNorm (nw the gain, nb the bias).
static int launch_dense(cudaStream_t st, const void* x, int x_kind, const void* nw,
                        const void* nb, int nw_kind, float eps, int b, int K, const int8_t* w,
                        const float* s, int N, Bias bias, const void* resid, int resid_kind,
                        float* out, int8_t* q8, float* xs, int* part) {
  if (nb != nullptr) {
    ln_quant_kernel<<<b, QUANT_THREADS, 0, st>>>(x, x_kind, nw, nb, nw_kind, eps, K, q8, xs);
  } else {
    norm_quant_kernel<<<b, QUANT_THREADS, 0, st>>>(x, x_kind, nw, nw_kind, eps, K, q8, xs);
  }
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return launch_gemv(st, q8, xs, 1, b, K, w, s, N, bias, resid, resid_kind, out, part);
}

static bool shapes_ok(int b, int K, int N) {
  return b >= 1 && K >= 32 && K % 32 == 0 && N >= 4 && N % 4 == 0;
}

extern "C" long long vt_dense_workspace(int b, int K, int N) {
  if (!shapes_ok(b, K, N)) return -1;
  return align256((long long)b * K) + align256((long long)b * 4) + part_bytes(b, K, K, N);
}

// B4 (nw == null) and B3 (nw = the stacked norm weights): out = the layer's
// int8 product of the (normed) rows of x, [b, N] f32.
extern "C" int vt_dense_int8(const void* x, int x_kind, const void* nw_all, int nw_kind,
                             float eps, const void* w_all, const void* s_all, int layer,
                             int b, int K, int N, void* out, void* ws, long long ws_bytes,
                             void* stream) {
  if (!shapes_ok(b, K, N) || ws_bytes < vt_dense_workspace(b, K, N)) {
    return (int)cudaErrorInvalidValue;
  }
  Carver c{reinterpret_cast<char*>(ws)};
  int8_t* q8 = c.take<int8_t>((long long)b * K);
  float* xs = c.take<float>((long long)b * 4);
  int* part = c.take<int>(part_bytes(b, K, K, N));
  const int esz = nw_kind == KIND_BF16 ? 2 : 4;
  const void* nw = nw_kind == KIND_NONE
                       ? nullptr
                       : reinterpret_cast<const char*>(nw_all) + (long long)layer * K * esz;
  return launch_dense((cudaStream_t)stream, x, x_kind, nw, nullptr, nw_kind, eps, b, K,
                      reinterpret_cast<const int8_t*>(w_all) + (long long)layer * K * N,
                      reinterpret_cast<const float*>(s_all) + (long long)layer * N, N,
                      NO_BIAS, nullptr, KIND_NONE, reinterpret_cast<float*>(out), q8, xs, part);
}

// B9a: out = the layer's int8 product of the LayerNormed rows of x (gain
// g_all[layer], bias b_all[layer]), [b, N] f32. Workspace: vt_dense_workspace.
extern "C" int vt_qkv_lnorm_int8(const void* x, int x_kind, const void* g_all,
                                 const void* b_all, int norm_kind, float eps, const void* w_all,
                                 const void* s_all, int layer, int b, int K, int N, void* out,
                                 void* ws, long long ws_bytes, void* stream) {
  if (!shapes_ok(b, K, N) || norm_kind == KIND_NONE ||
      ws_bytes < vt_dense_workspace(b, K, N)) {
    return (int)cudaErrorInvalidValue;
  }
  Carver c{reinterpret_cast<char*>(ws)};
  int8_t* q8 = c.take<int8_t>((long long)b * K);
  float* xs = c.take<float>((long long)b * 4);
  int* part = c.take<int>(part_bytes(b, K, K, N));
  const long long off = (long long)layer * K * (norm_kind == KIND_BF16 ? 2 : 4);
  return launch_dense((cudaStream_t)stream, x, x_kind,
                      reinterpret_cast<const char*>(g_all) + off,
                      reinterpret_cast<const char*>(b_all) + off, norm_kind, eps, b, K,
                      reinterpret_cast<const int8_t*>(w_all) + (long long)layer * K * N,
                      reinterpret_cast<const float*>(s_all) + (long long)layer * N, N,
                      NO_BIAS, nullptr, KIND_NONE, reinterpret_cast<float*>(out), q8, xs, part);
}

// ── B8b: the int8 SwiGLU MLP alone ───────────────────────────────────────

static bool mlp_ok(int b, int d, int F, int tile) {
  return shapes_ok(b, d, 2 * F) && shapes_ok(b, F, d) && tile >= 32 && tile % 32 == 0 &&
         F % tile == 0;
}

extern "C" long long vt_mlp_swiglu_workspace(int b, int d, int F, int tile) {
  if (!mlp_ok(b, d, F, tile)) return -1;
  long long part = part_bytes(b, d, d, 2 * F);
  const long long p2 = part_bytes(b, F, tile, d);
  if (part < 0 || p2 < 0) return -1;
  if (p2 > part) part = p2;
  return align256((long long)b * d) + align256((long long)b * 4) +          // q8, its scales
         align256((long long)b * 2 * F * 4) +                             // gate | up
         align256((long long)b * F) + align256((long long)b * (F / tile) * 4) +  // hidden int8
         part;
}

// B8b: out = sum_t q_t(silu(g) * u) . Wd[l] (* scales), with
// gu = q(x) . Wgu[l] (* scales); x are the post-norm rows, no residual.
extern "C" int vt_mlp_swiglu_int8(const void* x, int x_kind, const void* wgu, const void* sgu,
                                  const void* wd, const void* sd, int layer, int L, int b, int d,
                                  int F, int tile, void* out, void* ws, long long ws_bytes,
                                  void* stream) {
  if (!mlp_ok(b, d, F, tile) || layer < 0 || layer >= L ||
      ws_bytes < vt_mlp_swiglu_workspace(b, d, F, tile)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = (cudaStream_t)stream;
  const int n_tiles = F / tile;
  Carver c{reinterpret_cast<char*>(ws)};
  int8_t* q8 = c.take<int8_t>((long long)b * d);
  float* xs = c.take<float>((long long)b * 4);
  float* gu = c.take<float>((long long)b * 2 * F * 4);
  int8_t* hq = c.take<int8_t>((long long)b * F);
  float* hs = c.take<float>((long long)b * n_tiles * 4);
  int* part = reinterpret_cast<int*>(c.p);
  // gate | up of the row-quantized x
  int rc = launch_dense(st, x, x_kind, nullptr, nullptr, KIND_NONE, 0.0f, b, d,
                        reinterpret_cast<const int8_t*>(wgu) + (long long)layer * d * 2 * F,
                        reinterpret_cast<const float*>(sgu) + (long long)layer * 2 * F, 2 * F,
                        NO_BIAS, nullptr, KIND_NONE, gu, q8, xs, part);
  if (rc) return rc;
  // silu(g) * u, quantized per (row, tile)
  swiglu_quant_kernel<<<dim3(n_tiles, b), QUANT_THREADS, 0, st>>>(gu, F, tile, hq, hs);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  // down-projection, one f32 part per tile
  return launch_gemv(st, hq, hs, n_tiles, b, F,
                     reinterpret_cast<const int8_t*>(wd) + (long long)layer * F * d,
                     reinterpret_cast<const float*>(sd) + (long long)layer * d, d, NO_BIAS,
                     nullptr, KIND_NONE, reinterpret_cast<float*>(out), part);
}

// ── B9b / B9c: the GPT-2 layer tail ──────────────────────────────────────

static bool gelu_ok(int b, int d_attn, int d, int F, int tile, int Q) {
  return shapes_ok(b, d_attn, d) && shapes_ok(b, d, F) && (Q == 0 || shapes_ok(b, d, Q)) &&
         tile >= 32 && tile % 32 == 0 && F % tile == 0;
}

// Q = 0: B9c (no next-layer qkv)
extern "C" long long vt_tail_gelu_workspace(int b, int d_attn, int d, int F, int tile, int Q) {
  if (!gelu_ok(b, d_attn, d, F, tile, Q)) return -1;
  const int mx = d_attn > d ? d_attn : d;
  long long part = part_bytes(b, d_attn, d_attn, d);
  const long long p2 = part_bytes(b, d, d, F);
  const long long p3 = part_bytes(b, F, tile, d);
  const long long p4 = Q ? part_bytes(b, d, d, Q) : 0;
  if (part < 0 || p2 < 0 || p3 < 0 || p4 < 0) return -1;
  if (p2 > part) part = p2;
  if (p3 > part) part = p3;
  if (p4 > part) part = p4;
  return align256((long long)b * mx) + align256((long long)b * 4) +       // q8, its scales
         align256((long long)b * d * 4) +                                 // x2
         align256((long long)b * F * 4) +                                 // u
         align256((long long)b * F) + align256((long long)b * (F / tile) * 4) +  // hidden int8
         part;
}

// B9c (wq == null, Q = 0) and B9b:
//   x2   = x + (q(attn) . Wo[l] (* scales) + bo[l])
//   u    = q(ln(x2, lg[l], lb[l])) . Wu[l] (* scales) + bu[l]
//   out  = (x2 + sum_t q_t(gelu(u)) . Wd[l] (* scales)) + bd[l]
//   qkv  = q(ln(out, ng[nxt], nb[nxt])) . Wq[nxt],  nxt = min(l + 1, L - 1)
// bias_kind is the dtype of bo / bu / bd, norm_kind that of the LayerNorm
// gains and biases.
extern "C" int vt_tail_gelu_int8(
    const void* attn, const void* x, int x_kind,
    const void* wo, const void* wos, const void* bo, const void* lg, const void* lb,
    const void* wu, const void* su, const void* bu, const void* wd, const void* sd,
    const void* bd, int bias_kind, const void* ng, const void* nb, const void* wq,
    const void* sq, int norm_kind, int layer, int L, int b, int d_attn, int d, int F, int tile,
    int Q, float eps, void* x_out, void* qkv_out, void* ws, long long ws_bytes, void* stream) {
  if (!gelu_ok(b, d_attn, d, F, tile, Q) || layer < 0 || layer >= L ||
      bias_kind == KIND_NONE || norm_kind == KIND_NONE || (Q != 0) != (wq != nullptr) ||
      ws_bytes < vt_tail_gelu_workspace(b, d_attn, d, F, tile, Q)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = (cudaStream_t)stream;
  const int mx = d_attn > d ? d_attn : d;
  const int n_tiles = F / tile;
  const int nxt = layer + 1 < L ? layer + 1 : L - 1;
  const int nsz = norm_kind == KIND_BF16 ? 2 : 4;
  const int bsz = bias_kind == KIND_BF16 ? 2 : 4;
  const char* bo_c = reinterpret_cast<const char*>(bo);
  const char* bu_c = reinterpret_cast<const char*>(bu);
  const char* bd_c = reinterpret_cast<const char*>(bd);
  Carver c{reinterpret_cast<char*>(ws)};
  int8_t* q8 = c.take<int8_t>((long long)b * mx);
  float* xs = c.take<float>((long long)b * 4);
  float* x2 = c.take<float>((long long)b * d * 4);
  float* u = c.take<float>((long long)b * F * 4);
  int8_t* hq = c.take<int8_t>((long long)b * F);
  float* hs = c.take<float>((long long)b * n_tiles * 4);
  int* part = reinterpret_cast<int*>(c.p);
  const int8_t* w8;
  const float* sc;

  // o-projection + bias, + residual
  w8 = reinterpret_cast<const int8_t*>(wo) + (long long)layer * d_attn * d;
  sc = reinterpret_cast<const float*>(wos) + (long long)layer * d;
  int rc = launch_dense(st, attn, KIND_F32, nullptr, nullptr, KIND_NONE, eps, b, d_attn, w8, sc,
                        d, Bias{bo_c + (long long)layer * d * bsz, bias_kind, 0}, x, x_kind, x2,
                        q8, xs, part);
  if (rc) return rc;
  // mlp LayerNorm + fc + bias
  w8 = reinterpret_cast<const int8_t*>(wu) + (long long)layer * d * F;
  sc = reinterpret_cast<const float*>(su) + (long long)layer * F;
  rc = launch_dense(st, x2, KIND_F32, reinterpret_cast<const char*>(lg) + (long long)layer * d * nsz,
                    reinterpret_cast<const char*>(lb) + (long long)layer * d * nsz, norm_kind, eps,
                    b, d, w8, sc, F, Bias{bu_c + (long long)layer * F * bsz, bias_kind, 0},
                    nullptr, KIND_NONE, u, q8, xs, part);
  if (rc) return rc;
  // tanh-GELU, quantized per (row, tile)
  gelu_quant_kernel<<<dim3(n_tiles, b), QUANT_THREADS, 0, st>>>(u, F, tile, hq, hs);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  // down-projection, one f32 part per tile, + residual, + bias
  w8 = reinterpret_cast<const int8_t*>(wd) + (long long)layer * F * d;
  sc = reinterpret_cast<const float*>(sd) + (long long)layer * d;
  rc = launch_gemv(st, hq, hs, n_tiles, b, F, w8, sc, d,
                   Bias{bd_c + (long long)layer * d * bsz, bias_kind, 1}, x2, KIND_F32,
                   reinterpret_cast<float*>(x_out), part);
  if (rc || Q == 0) return rc;
  // the next layer's LayerNorm + qkv
  w8 = reinterpret_cast<const int8_t*>(wq) + (long long)nxt * d * Q;
  sc = reinterpret_cast<const float*>(sq) + (long long)nxt * Q;
  return launch_dense(st, x_out, KIND_F32,
                      reinterpret_cast<const char*>(ng) + (long long)nxt * d * nsz,
                      reinterpret_cast<const char*>(nb) + (long long)nxt * d * nsz, norm_kind, eps,
                      b, d, w8, sc, Q, NO_BIAS, nullptr, KIND_NONE,
                      reinterpret_cast<float*>(qkv_out), q8, xs, part);
}

// ── B9d: the int8 GELU MLP alone ─────────────────────────────────────────

extern "C" long long vt_mlp_gelu_workspace(int b, int d, int F, int tile) {
  if (!gelu_ok(b, d, d, F, tile, 0)) return -1;
  long long part = part_bytes(b, d, d, F);
  const long long p2 = part_bytes(b, F, tile, d);
  if (part < 0 || p2 < 0) return -1;
  if (p2 > part) part = p2;
  return align256((long long)b * d) + align256((long long)b * 4) +          // q8, its scales
         align256((long long)b * F * 4) +                                 // u
         align256((long long)b * F) + align256((long long)b * (F / tile) * 4) +  // hidden int8
         part;
}

// B9d (the MLP that JAX's decode step gives a GELU MLP with biases under
// RMSNorm) on the old chain: since the one launch of tail_gelu.cu took it
// (vt_mlp_gelu_one), only for the shapes that body does not take and as its
// yardstick (chain=True). out = sum_t q_t(gelu(u)) . Wd[l] (* scales), with
// u = q(x) . Wu[l] (* scales) + bu[l]; x are the post-norm rows; no
// residual, and the proj bias is the caller's add. bias_kind is bu's dtype.
extern "C" int vt_mlp_gelu_int8(const void* x, int x_kind, const void* wu, const void* su,
                                const void* bu, int bias_kind, const void* wd, const void* sd,
                                int layer, int L, int b, int d, int F, int tile, void* out,
                                void* ws, long long ws_bytes, void* stream) {
  if (!gelu_ok(b, d, d, F, tile, 0) || layer < 0 || layer >= L || bias_kind == KIND_NONE ||
      ws_bytes < vt_mlp_gelu_workspace(b, d, F, tile)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = (cudaStream_t)stream;
  const int n_tiles = F / tile;
  const int bsz = bias_kind == KIND_BF16 ? 2 : 4;
  Carver c{reinterpret_cast<char*>(ws)};
  int8_t* q8 = c.take<int8_t>((long long)b * d);
  float* xs = c.take<float>((long long)b * 4);
  float* u = c.take<float>((long long)b * F * 4);
  int8_t* hq = c.take<int8_t>((long long)b * F);
  float* hs = c.take<float>((long long)b * n_tiles * 4);
  int* part = reinterpret_cast<int*>(c.p);
  // fc of the row-quantized x, + bias
  int rc = launch_dense(st, x, x_kind, nullptr, nullptr, KIND_NONE, 0.0f, b, d,
                        reinterpret_cast<const int8_t*>(wu) + (long long)layer * d * F,
                        reinterpret_cast<const float*>(su) + (long long)layer * F, F,
                        Bias{reinterpret_cast<const char*>(bu) + (long long)layer * F * bsz,
                             bias_kind, 0},
                        nullptr, KIND_NONE, u, q8, xs, part);
  if (rc) return rc;
  // tanh-GELU, quantized per (row, tile)
  gelu_quant_kernel<<<dim3(n_tiles, b), QUANT_THREADS, 0, st>>>(u, F, tile, hq, hs);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  // down-projection, one f32 part per tile
  return launch_gemv(st, hq, hs, n_tiles, b, F,
                     reinterpret_cast<const int8_t*>(wd) + (long long)layer * F * d,
                     reinterpret_cast<const float*>(sd) + (long long)layer * d, d, NO_BIAS,
                     nullptr, KIND_NONE, reinterpret_cast<float*>(out), part);
}
