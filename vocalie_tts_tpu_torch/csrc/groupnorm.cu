// Fused GroupNorm over channels-last activations: optional pre-norm FiLM
// row add, f32 group moments, folded scale/bias apply, optional SiLU,
// output in the input's dtype (bf16).
//
// Replaces: vocalie_tts_tpu/ops/groupnorm.py::group_norm_fused (the
// Pallas kernel _gn_kernel and, for the shapes Mosaic cannot tile, the
// XLA branch _gn_xla: this kernel serves both, every C, every spatial
// size).
//
//   xf   = f32(x) + f32(e)[b]                     (e optional, [B, C])
//   mean = sum(xf) / n,  var = max(sum(xf^2) / n - mean^2, 0)   per (b, group)
//   inv  = 1 / sqrt(var + eps)
//   y    = xf * (inv * gamma) + (beta - mean * inv * gamma)
//   y    = y * sigmoid(y)                          (optional)
//
// Bound: bytes. ~10 flops per element against 4 bytes (bf16 read + bf16
// write): far under the card's ~300 flops per byte. The least traffic is
// one read of x and one write of y.
//
// Design. The TPU kernel held a whole batch row in VMEM and made one
// pass. A GPU block cannot hold a VAE row (64 x 128 x 64 bf16 = 1 MB),
// and blocks run in no order, so the moments take a second launch:
//   1. gn_stats: grid (chunk, b). Each block reduces a chunk of spatial
//      rows: per-channel f32 sums in registers (vector loads of V bf16
//      along C, coalesced across threads), a fixed-order tree over the
//      block's row-threads, then per-group sums of its channels, written
//      to ws[b, chunk, g, {sum, sumsq}]. No atomics: the result does not
//      depend on block order.
//   2. gn_apply: the same grid. Each block sums its row's chunk partials
//      in chunk order, forms mean / inv per group and scale / bias / e
//      per channel in shared memory, and streams its chunk once more
//      (from L2 where the activation fits its 50 MB) to write y.
// The apply is two IEEE-rounded ops (__fmul_rn, __fadd_rn) as the plain
// version runs them, so the kernel and the plain version differ only
// through the order in which the moments are summed.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <int V>
struct Vec;
template <>
struct Vec<8> { using T = uint4; };
template <>
struct Vec<4> { using T = uint2; };
template <>
struct Vec<2> { using T = uint32_t; };
template <>
struct Vec<1> { using T = uint16_t; };

template <int V>
__device__ __forceinline__ void load_bf16(const __nv_bfloat16* p, float* out) {
  typename Vec<V>::T raw = *reinterpret_cast<const typename Vec<V>::T*>(p);
  const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
  for (int j = 0; j < V; ++j) out[j] = __bfloat162float(h[j]);
}

template <int V>
__device__ __forceinline__ void store_bf16(__nv_bfloat16* p, const float* in) {
  typename Vec<V>::T raw;
  __nv_bfloat16* h = reinterpret_cast<__nv_bfloat16*>(&raw);
#pragma unroll
  for (int j = 0; j < V; ++j) h[j] = __float2bfloat16_rn(in[j]);
  *reinterpret_cast<typename Vec<V>::T*>(p) = raw;
}

// Thread layout shared by both kernels: threadIdx.x walks channel vectors
// (V channels each), threadIdx.y walks the spatial rows of the chunk.
struct Layout {
  int bx, by;
};

__device__ __forceinline__ Layout layout(int n_vec) {
  Layout l;
  l.bx = n_vec < kThreads ? n_vec : kThreads;
  l.by = kThreads / l.bx;
  return l;
}

template <int V, bool HAS_E>
__global__ void __launch_bounds__(kThreads) gn_stats(
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ e,
    float* __restrict__ ws, int S, int C, int G, int rows_per_chunk) {
  extern __shared__ float smem[];
  float* ch_sum = smem;                  // [C]
  float* ch_sq = smem + C;               // [C]
  float* red = smem + 2 * C;             // [by][bx*V][2]
  const int b = blockIdx.y, chunk = blockIdx.x, n_chunks = gridDim.x;
  const int n_vec = C / V;
  const Layout l = layout(n_vec);
  const int tid = threadIdx.x;
  const int tx = tid % l.bx, ty = tid / l.bx;
  const bool active = ty < l.by;
  const int s0 = chunk * rows_per_chunk;
  const int s1 = min(S, s0 + rows_per_chunk);
  const __nv_bfloat16* xb = x + (long long)b * S * C;

  for (int cv0 = 0; cv0 < n_vec; cv0 += l.bx) {
    const int cv = cv0 + tx;
    float s[V], q[V], ev[V];
#pragma unroll
    for (int j = 0; j < V; ++j) { s[j] = 0.f; q[j] = 0.f; ev[j] = 0.f; }
    if (active && cv < n_vec) {
      if (HAS_E) load_bf16<V>(e + (long long)b * C + cv * V, ev);
      for (int r = s0 + ty; r < s1; r += l.by) {
        float v[V];
        load_bf16<V>(xb + (long long)r * C + cv * V, v);
#pragma unroll
        for (int j = 0; j < V; ++j) {
          const float xf = HAS_E ? __fadd_rn(v[j], ev[j]) : v[j];
          s[j] += xf;
          q[j] = fmaf(xf, xf, q[j]);
        }
      }
    }
    if (active) {
#pragma unroll
      for (int j = 0; j < V; ++j) {
        red[(ty * l.bx * V + tx * V + j) * 2] = s[j];
        red[(ty * l.bx * V + tx * V + j) * 2 + 1] = q[j];
      }
    }
    __syncthreads();
    // fixed-order sum over the row-threads, one channel per thread
    for (int k = tid; k < l.bx * V; k += kThreads) {
      const int c = cv0 * V + k;
      if (c < C) {
        float a = 0.f, a2 = 0.f;
        for (int y = 0; y < l.by; ++y) {
          a += red[(y * l.bx * V + k) * 2];
          a2 += red[(y * l.bx * V + k) * 2 + 1];
        }
        ch_sum[c] = a;
        ch_sq[c] = a2;
      }
    }
    __syncthreads();
  }
  const int cg = C / G;
  for (int g = tid; g < G; g += kThreads) {
    float a = 0.f, a2 = 0.f;
    for (int j = 0; j < cg; ++j) {
      a += ch_sum[g * cg + j];
      a2 += ch_sq[g * cg + j];
    }
    float* w = ws + (((long long)b * n_chunks + chunk) * G + g) * 2;
    w[0] = a;
    w[1] = a2;
  }
}

template <int V, bool HAS_E, bool SILU>
__global__ void __launch_bounds__(kThreads) gn_apply(
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ e,
    const float* __restrict__ gamma, const float* __restrict__ beta,
    const float* __restrict__ ws, __nv_bfloat16* __restrict__ y,
    int S, int C, int G, int rows_per_chunk, float eps) {
  extern __shared__ float smem[];
  float* scale = smem;                   // [C]
  float* bias = smem + C;                // [C]
  float* erow = smem + 2 * C;            // [C]
  float* mean_g = smem + 3 * C;          // [G]
  float* inv_g = smem + 3 * C + G;       // [G]
  const int b = blockIdx.y, chunk = blockIdx.x, n_chunks = gridDim.x;
  const int tid = threadIdx.x;
  const int cg = C / G;
  const float n = (float)S * (float)cg;
  for (int g = tid; g < G; g += kThreads) {
    float a = 0.f, a2 = 0.f;
    for (int k = 0; k < n_chunks; ++k) {
      const float* w = ws + (((long long)b * n_chunks + k) * G + g) * 2;
      a += w[0];
      a2 += w[1];
    }
    const float mean = __fdiv_rn(a, n);
    const float var = fmaxf(__fsub_rn(__fdiv_rn(a2, n), __fmul_rn(mean, mean)), 0.f);
    mean_g[g] = mean;
    inv_g[g] = __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(var, eps)));
  }
  __syncthreads();
  for (int c = tid; c < C; c += kThreads) {
    const float sc = __fmul_rn(inv_g[c / cg], gamma[c]);
    scale[c] = sc;
    bias[c] = __fsub_rn(beta[c], __fmul_rn(mean_g[c / cg], sc));
    erow[c] = HAS_E ? __bfloat162float(e[(long long)b * C + c]) : 0.f;
  }
  __syncthreads();

  const int n_vec = C / V;
  const Layout l = layout(n_vec);
  const int tx = tid % l.bx, ty = tid / l.bx;
  if (ty >= l.by) return;
  const int s0 = chunk * rows_per_chunk;
  const int s1 = min(S, s0 + rows_per_chunk);
  const long long base = (long long)b * S * C;
  for (int cv = tx; cv < n_vec; cv += l.bx) {
    float sc[V], bi[V], ev[V];
#pragma unroll
    for (int j = 0; j < V; ++j) {
      sc[j] = scale[cv * V + j];
      bi[j] = bias[cv * V + j];
      ev[j] = erow[cv * V + j];
    }
    for (int r = s0 + ty; r < s1; r += l.by) {
      const long long off = base + (long long)r * C + cv * V;
      float v[V];
      load_bf16<V>(x + off, v);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float xf = HAS_E ? __fadd_rn(v[j], ev[j]) : v[j];
        float o = __fadd_rn(__fmul_rn(xf, sc[j]), bi[j]);
        if (SILU) o = __fmul_rn(o, __fdiv_rn(1.f, __fadd_rn(1.f, expf(-o))));
        v[j] = o;
      }
      store_bf16<V>(y + off, v);
    }
  }
}

template <int V, bool HAS_E, bool SILU>
int launch(const void* x, const void* e, const float* gamma, const float* beta, float* ws,
           void* y, int B, int S, int C, int G, int n_chunks, int rows_per_chunk, float eps,
           cudaStream_t stream) {
  const dim3 grid(n_chunks, B);
  const int n_vec = C / V;
  const int bx = n_vec < kThreads ? n_vec : kThreads;
  const int by = kThreads / bx;
  const size_t stats_smem = (size_t)(2 * C + 2 * by * bx * V) * sizeof(float);
  const size_t apply_smem = (size_t)(3 * C + 2 * G) * sizeof(float);
  cudaError_t err;
  if (stats_smem > 48 * 1024) {
    err = cudaFuncSetAttribute(gn_stats<V, HAS_E>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)stats_smem);
    if (err != cudaSuccess) return (int)err;
  }
  if (apply_smem > 48 * 1024) {
    err = cudaFuncSetAttribute(gn_apply<V, HAS_E, SILU>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)apply_smem);
    if (err != cudaSuccess) return (int)err;
  }
  gn_stats<V, HAS_E><<<grid, kThreads, stats_smem, stream>>>(
      (const __nv_bfloat16*)x, (const __nv_bfloat16*)e, ws, S, C, G, rows_per_chunk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  gn_apply<V, HAS_E, SILU><<<grid, kThreads, apply_smem, stream>>>(
      (const __nv_bfloat16*)x, (const __nv_bfloat16*)e, gamma, beta, ws,
      (__nv_bfloat16*)y, S, C, G, rows_per_chunk, eps);
  return (int)cudaGetLastError();
}

template <int V>
int dispatch(const void* x, const void* e, const float* gamma, const float* beta, float* ws,
             void* y, int B, int S, int C, int G, int n_chunks, int rows_per_chunk, float eps,
             int silu, cudaStream_t stream) {
  if (e != nullptr) {
    return silu ? launch<V, true, true>(x, e, gamma, beta, ws, y, B, S, C, G, n_chunks,
                                        rows_per_chunk, eps, stream)
                : launch<V, true, false>(x, e, gamma, beta, ws, y, B, S, C, G, n_chunks,
                                         rows_per_chunk, eps, stream);
  }
  return silu ? launch<V, false, true>(x, e, gamma, beta, ws, y, B, S, C, G, n_chunks,
                                       rows_per_chunk, eps, stream)
              : launch<V, false, false>(x, e, gamma, beta, ws, y, B, S, C, G, n_chunks,
                                        rows_per_chunk, eps, stream);
}

}  // namespace

// x, y: [B, S, C] bf16 contiguous; e: [B, C] bf16 or null; gamma, beta:
// [C] f32; ws: [B, n_chunks, G, 2] f32 scratch. vec is the channel vector
// width (8, 4, 2 or 1; it divides C and the pointers are aligned to it).
extern "C" int vt_group_norm(const void* x, const void* e, const void* gamma, const void* beta,
                             void* ws, void* y, int B, int S, int C, int G, int n_chunks,
                             int rows_per_chunk, float eps, int silu, int vec, void* stream) {
  const float* g = (const float*)gamma;
  const float* bt = (const float*)beta;
  float* w = (float*)ws;
  cudaStream_t st = (cudaStream_t)stream;
  switch (vec) {
    case 8: return dispatch<8>(x, e, g, bt, w, y, B, S, C, G, n_chunks, rows_per_chunk, eps, silu, st);
    case 4: return dispatch<4>(x, e, g, bt, w, y, B, S, C, G, n_chunks, rows_per_chunk, eps, silu, st);
    case 2: return dispatch<2>(x, e, g, bt, w, y, B, S, C, G, n_chunks, rows_per_chunk, eps, silu, st);
    case 1: return dispatch<1>(x, e, g, bt, w, y, B, S, C, G, n_chunks, rows_per_chunk, eps, silu, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
