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
// Design. The TPU kernel held a whole batch row in VMEM and made one pass.
// Here a batch row is held in the shared memory of a thread-block cluster:
//   * gn_one_pass (every row that fits 16 blocks; ops/groupnorm.py gn_plan
//     picks the cluster size n so that an SM holds two blocks, and so that
//     the rows' blocks fill the card once): grid (n, B), a cluster per row.
//     Block r copies its slice of the row -- rows [r * R, (r + 1) * R) of
//     the spatial axis, contiguous bytes -- into shared memory ONCE, by the
//     copy engine (cp.async.bulk in up to 8 pieces, each completing on its
//     own mbarrier, so the moments start on the first piece while the rest
//     land; 16-byte vectors by the threads where C is not a multiple of 8).
//     Per-channel f32 sums in registers over the block's rows, a fixed-order
//     tree over the row-threads, per-group sums over the channels. The
//     blocks meet once (cluster barrier): each reads every rank's group
//     partials through distributed shared memory in rank order, so every
//     block forms the same mean / inv with no atomics and no global
//     workspace, then writes y from its shared copy. x is read from device
//     memory once, y written once, in one launch.
//   * gn_stats + gn_apply (a row past 16 blocks' shared memory): the two
//     launches of the first port, grid (chunk, b). gn_stats writes chunk
//     partials to ws[b, chunk, g, {sum, sumsq}]; gn_apply sums them in
//     chunk order and streams its chunk once more (from L2 where the
//     activation fits its 50 MB) to write y.
// The apply is two IEEE-rounded ops (__fmul_rn, __fadd_rn) as the plain
// version runs them; the SiLU takes the card's fast exp and reciprocal (a
// few f32 ulps). So the kernel and the plain version differ through the
// order in which the moments are summed and those ulps, both far inside
// the bf16 rounding of the output.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "int8_stream.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kMaxCluster = 16;                 // blocks a row's cluster (16 is non-portable)
constexpr int kOnePassSmemMax = 227 * 1024;     // dynamic shared bytes a block may take

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

// o * sigmoid(o) with the card's fast exp and reciprocal: within a few f32
// ulps of the IEEE steps, far inside the bf16 rounding that follows (the
// IEEE divide and expf took most of the apply's instructions)
__device__ __forceinline__ float silu(float o) {
  return __fdividef(o, __fadd_rn(1.f, __expf(-o)));
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
        if (SILU) o = silu(o);
        v[j] = o;
      }
      store_bf16<V>(y + off, v);
    }
  }
}

// ── the one-pass kernel ─────────────────────────────────────────────────

constexpr int kMaxPieces = 8;   // bulk copies (and mbarriers) a block

__host__ __device__ __forceinline__ long long round16(long long n) { return (n + 15) & ~15LL; }

// Dynamic shared bytes of gn_one_pass for blocks of `rows` spatial rows
// (ops/groupnorm.py gn_one_pass_smem says the same): the row slice (bf16),
// the row-thread tree [by][bx * V][2], the channel sums [2][C], the group
// partials and statistics [2][G][2], the mbarriers.
__host__ __device__ __forceinline__ long long one_pass_smem(int rows, int C, int G, int V) {
  const int n_vec = C / V;
  const int bx = n_vec < kThreads ? n_vec : kThreads;
  const int by = kThreads / bx;
  return round16((long long)rows * C * 2) + 4LL * (2 * by * bx * V + 2 * C + 4 * G) +
         8LL * kMaxPieces;
}

constexpr int kStamps = 6;   // phase points of gn_one_pass's trace

__device__ __forceinline__ void gn_stamp(unsigned long long* stamps, int i) {
  if (stamps != nullptr && threadIdx.x == 0) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    stamps[((long long)blockIdx.y * gridDim.x + blockIdx.x) * kStamps + i] = t;
  }
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

template <int V, bool HAS_E, bool SILU>
__global__ void __launch_bounds__(kThreads) gn_one_pass(
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ e,
    const float* __restrict__ gamma, const float* __restrict__ beta,
    __nv_bfloat16* __restrict__ y, unsigned long long* __restrict__ stamps, int S, int C,
    int G, int rows_per_block, int pieces, float eps) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  gn_stamp(stamps, 0);
  cg::cluster_group cluster = cg::this_cluster();
  const int n_cl = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int n_vec = C / V;
  const Layout l = layout(n_vec);
  const int tx = tid % l.bx, ty = tid / l.bx;
  const bool active = ty < l.by;
  const int s0 = rank * rows_per_block;
  const int nrows = max(0, min(S, s0 + rows_per_block) - s0);
  const long long base = ((long long)b * S + s0) * C;

  __nv_bfloat16* data = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  float* red = reinterpret_cast<float*>(smem_raw + round16((long long)rows_per_block * C * 2));
  float* ch_sum = red + 2 * l.by * l.bx * V;
  float* ch_sq = ch_sum + C;
  float* part = ch_sq + C;               // [G][2] this block's group sums
  float* stat = part + 2 * G;            // [G][2] mean, inv
  uint64_t* bars = reinterpret_cast<uint64_t*>(stat + 2 * G);
  const int rpp = (nrows + pieces - 1) / pieces;   // rows a piece
  // the weights and FiLM row of the thread's first channel vector, asked
  // for now so that the apply does not wait on them after the barrier
  float gam0[V], bet0[V], e0[V];
#pragma unroll
  for (int j = 0; j < V; ++j) gam0[j] = bet0[j] = e0[j] = 0.f;
  if (active) {
#pragma unroll
    for (int j = 0; j < V; ++j) {
      gam0[j] = __ldg(gamma + tx * V + j);
      bet0[j] = __ldg(beta + tx * V + j);
    }
    if (HAS_E) load_bf16<V>(e + (long long)b * C + tx * V, e0);
  }

  // the block's slice of the row, into shared memory once
  if (V == 8) {
    if (tid == 0) {
      for (int p = 0; p < pieces; ++p) i8s::mbar_init(i8s::smem_u32(bars + p), 1);
      i8s::mbar_fence_init();
    }
    __syncthreads();
    if (tid == 0) {
      for (int p = 0; p < pieces; ++p) {
        const int r0 = p * rpp, r1 = min(nrows, r0 + rpp);
        if (r1 <= r0) continue;
        const int bytes = (r1 - r0) * C * 2;
        const uint32_t bar = i8s::smem_u32(bars + p);
        i8s::mbar_expect_tx(bar, (uint32_t)bytes);
        i8s::bulk_load(i8s::smem_u32(data + (long long)r0 * C), x + base + (long long)r0 * C,
                       bytes, bar);
      }
    }
  } else {
    for (int i = tid; i < nrows * n_vec; i += kThreads) {
      float v[V];
      load_bf16<V>(x + base + (long long)i * V, v);
      store_bf16<V>(data + (long long)i * V, v);
    }
    __syncthreads();
  }

  // per-channel moments over the block's rows, piece by piece
  for (int cv0 = 0; cv0 < n_vec; cv0 += l.bx) {
    const int cv = cv0 + tx;
    float s[V], q[V], ev[V];
#pragma unroll
    for (int j = 0; j < V; ++j) { s[j] = 0.f; q[j] = 0.f; ev[j] = 0.f; }
    if (active && cv < n_vec) {
      if (HAS_E) load_bf16<V>(e + (long long)b * C + cv * V, ev);
      for (int p = 0; p < pieces; ++p) {
        const int r0 = p * rpp, r1 = min(nrows, r0 + rpp);
        if (r1 <= r0) break;
        if (V == 8 && cv0 == 0) i8s::mbar_wait(i8s::smem_u32(bars + p), 0);
        if (p == 0 && cv0 == 0) gn_stamp(stamps, 1);
        for (int r = r0 + ty; r < r1; r += l.by) {
          float v[V];
          load_bf16<V>(data + (long long)r * C + cv * V, v);
#pragma unroll
          for (int j = 0; j < V; ++j) {
            const float xf = HAS_E ? __fadd_rn(v[j], ev[j]) : v[j];
            s[j] += xf;
            q[j] = fmaf(xf, xf, q[j]);
          }
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
    for (int k = tid; k < l.bx * V; k += kThreads) {   // fixed-order sum over the row-threads
      const int c = cv0 * V + k;
      if (c < C) {
        float a = 0.f, a2 = 0.f;
        for (int yy = 0; yy < l.by; ++yy) {
          a += red[(yy * l.bx * V + k) * 2];
          a2 += red[(yy * l.bx * V + k) * 2 + 1];
        }
        ch_sum[c] = a;
        ch_sq[c] = a2;
      }
    }
    __syncthreads();
  }
  // per-group sums, a warp a group: lane j takes channels j, j + 32, ...,
  // then a fixed xor tree (the same order in every block and every call)
  const int cg_ = C / G;
  const int warp = tid >> 5, lane = tid & 31;
  for (int g = warp; g < G; g += kThreads / 32) {
    float a = 0.f, a2 = 0.f;
    for (int j = lane; j < cg_; j += 32) {
      a += ch_sum[g * cg_ + j];
      a2 += ch_sq[g * cg_ + j];
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      a += __shfl_xor_sync(0xffffffffu, a, o);
      a2 += __shfl_xor_sync(0xffffffffu, a2, o);
    }
    if (lane == 0) {
      part[2 * g] = a;
      part[2 * g + 1] = a2;
    }
  }
  gn_stamp(stamps, 2);
  cluster.sync();   // every rank's group partials are written
  gn_stamp(stamps, 3);
  const float n = (float)S * (float)cg_;
  for (int g = tid; g < G; g += kThreads) {
    float a = 0.f, a2 = 0.f;
    for (int r = 0; r < n_cl; ++r) {   // rank order: the same sums in every block
      const float* pr = cluster.map_shared_rank(part, r);
      a += pr[2 * g];
      a2 += pr[2 * g + 1];
    }
    const float mean = __fdiv_rn(a, n);
    const float var = fmaxf(__fsub_rn(__fdiv_rn(a2, n), __fmul_rn(mean, mean)), 0.f);
    stat[2 * g] = mean;
    stat[2 * g + 1] = __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(var, eps)));
  }
  cluster_arrive();   // this block has read the others' partials
  __syncthreads();
  gn_stamp(stamps, 4);

  // y from the shared copy, written once
  if (active) {
    for (int cv = tx; cv < n_vec; cv += l.bx) {
      const bool first = cv == tx;
      float sc[V], bi[V], ev[V];
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const int c = cv * V + j;
        const int g = c / cg_;
        sc[j] = __fmul_rn(stat[2 * g + 1], first ? gam0[j] : gamma[c]);
        bi[j] = __fsub_rn(first ? bet0[j] : beta[c], __fmul_rn(stat[2 * g], sc[j]));
        ev[j] = e0[j];
      }
      if (HAS_E && !first) load_bf16<V>(e + (long long)b * C + cv * V, ev);
      for (int r = ty; r < nrows; r += l.by) {
        float v[V];
        load_bf16<V>(data + (long long)r * C + cv * V, v);
#pragma unroll
        for (int j = 0; j < V; ++j) {
          const float xf = HAS_E ? __fadd_rn(v[j], ev[j]) : v[j];
          float o = __fadd_rn(__fmul_rn(xf, sc[j]), bi[j]);
          if (SILU) o = silu(o);
          v[j] = o;
        }
        store_bf16<V>(y + base + (long long)r * C + cv * V, v);
      }
    }
  }
  gn_stamp(stamps, 5);
  cluster_wait();   // no block leaves before the others have read its partials
}

// ── launches ────────────────────────────────────────────────────────────

template <int V, bool HAS_E, bool SILU>
int launch_two_pass(const void* x, const void* e, const float* gamma, const float* beta,
                    float* ws, void* y, int B, int S, int C, int G, int n_chunks,
                    int rows_per_chunk, float eps, cudaStream_t stream) {
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

template <int V, bool HAS_E, bool SILU>
int launch_one_pass(const void* x, const void* e, const float* gamma, const float* beta,
                    void* y, void* stamps, int B, int S, int C, int G, int n_cl,
                    int rows_per_block, int pieces, float eps, cudaStream_t stream) {
  void (*kern)(const __nv_bfloat16*, const __nv_bfloat16*, const float*, const float*,
               __nv_bfloat16*, unsigned long long*, int, int, int, int, int, float) =
      gn_one_pass<V, HAS_E, SILU>;
  const long long smem = one_pass_smem(rows_per_block, C, G, V);
  if (smem > kOnePassSmemMax) return (int)cudaErrorInvalidValue;
  static bool ready = false;   // set once per instantiation
  if (!ready) {
    cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           kOnePassSmemMax);
    if (err != cudaSuccess) return (int)err;
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return (int)err;
    ready = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)n_cl, (unsigned)B, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)n_cl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, kern, (const __nv_bfloat16*)x, (const __nv_bfloat16*)e, gamma, beta,
      (__nv_bfloat16*)y, (unsigned long long*)stamps, S, C, G, rows_per_block, pieces, eps);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <int V, bool HAS_E, bool SILU>
int launch(const void* x, const void* e, const float* gamma, const float* beta, float* ws,
           void* y, void* stamps, int B, int S, int C, int G, int n_chunks, int rows_per_chunk,
           int n_cl, int pieces, float eps, cudaStream_t stream) {
  if (n_cl > 0) {
    return launch_one_pass<V, HAS_E, SILU>(x, e, gamma, beta, y, stamps, B, S, C, G, n_cl,
                                           rows_per_chunk, pieces, eps, stream);
  }
  return launch_two_pass<V, HAS_E, SILU>(x, e, gamma, beta, ws, y, B, S, C, G, n_chunks,
                                         rows_per_chunk, eps, stream);
}

template <int V>
int dispatch(const void* x, const void* e, const float* gamma, const float* beta, float* ws,
             void* y, void* stamps, int B, int S, int C, int G, int n_chunks,
             int rows_per_chunk, int n_cl, int pieces, float eps, int silu,
             cudaStream_t stream) {
#define VT_GN(HE, SI)                                                                  \
  launch<V, HE, SI>(x, e, gamma, beta, ws, y, stamps, B, S, C, G, n_chunks,          \
                    rows_per_chunk, n_cl, pieces, eps, stream)
  if (e != nullptr) return silu ? VT_GN(true, true) : VT_GN(true, false);
  return silu ? VT_GN(false, true) : VT_GN(false, false);
#undef VT_GN
}

}  // namespace

// x, y: [B, S, C] bf16 contiguous; e: [B, C] bf16 or null; gamma, beta:
// [C] f32. vec is the channel vector width (8, 4, 2 or 1; it divides C and
// the pointers are aligned to it).
//   * n_cl in 1..16: the one-pass route, a cluster of n_cl blocks per row,
//     rows_per_chunk spatial rows a block (their slice in shared memory;
//     pieces 1..8 bulk copies of it where vec is 8); ws unused.
//   * n_cl 0: the two-pass route, grid (n_chunks, B), rows_per_chunk rows a
//     chunk; ws: [B, n_chunks, G, 2] f32 scratch.
// stamps: null, or [B, n_cl, kStamps] u64 for the one-pass route's trace.
extern "C" int vt_group_norm(const void* x, const void* e, const void* gamma, const void* beta,
                             void* ws, void* y, void* stamps, int B, int S, int C, int G,
                             int n_chunks, int rows_per_chunk, int n_cl, int pieces, float eps,
                             int silu, int vec, void* stream) {
  if (n_cl < 0 || n_cl > kMaxCluster || pieces < 1 || pieces > kMaxPieces ||
      (n_cl > 0 && (long long)n_cl * rows_per_chunk < S) || (n_cl == 0 && ws == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  const float* g = (const float*)gamma;
  const float* bt = (const float*)beta;
  float* w = (float*)ws;
  cudaStream_t st = (cudaStream_t)stream;
#define VT_GN_V(V) \
  dispatch<V>(x, e, g, bt, w, y, stamps, B, S, C, G, n_chunks, rows_per_chunk, n_cl, pieces, \
              eps, silu, st)
  switch (vec) {
    case 8: return VT_GN_V(8);
    case 4: return VT_GN_V(4);
    case 2: return VT_GN_V(2);
    case 1: return VT_GN_V(1);
    default: return (int)cudaErrorInvalidValue;
  }
#undef VT_GN_V
}

// gn_one_pass's dynamic shared bytes for blocks of `rows` rows (the
// wrapper's planner computes the same; tests hold the two together).
extern "C" long long vt_group_norm_smem(int rows, int C, int G, int vec) {
  return one_pass_smem(rows, C, G, vec);
}
