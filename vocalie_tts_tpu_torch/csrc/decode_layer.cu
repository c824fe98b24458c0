// One SwiGLU decode layer -- attention over the int8 cache, the per-head
// o-projection, the MLP tail and the next layer's RMSNorm + qkv -- in ONE
// cooperative launch (kernel B12).
//
// Replaces: vocalie_tts_tpu/ops/decode_layer.py::layer_swiglu_qkv_int8_stacked
// (def :314, pallas_call :459): its packed (_layer_kernel_packed, :250) and
// split (_layer_kernel_split, :280) bodies compute the same numbers; the port
// keeps k and v split ([L, b, kv, T, d] int8, bf16 scales [L, b, kv, T]). The
// math is theirs, step for step, for layer l:
//   * attention per (row, kv head) over the 128-slot T blocks below
//     ceil(valid_len / 128) (at least one), as B1 (decode_attention.cu): q
//     quantized per q row (qs = max(max|q| / 127, 1e-8)), s = (i32 * (qs *
//     sm)) * ks + bias, online max and sum from -1e30, p * vs quantized per
//     block and q row (ps = max(max / 127, 1e-20)), acc = acc * corr +
//     i32 * ps; the current token's k/v merged in f32, o = (acc * corr +
//     p_new * v_new) / max(l, 1e-30);
//   * the o-projection per q-head chunk: each [b, d] slice of head c = h*g+j
//     quantized per row on its own (floor 1e-8), its int32 product with Wo
//     rows [c*d, c*d + d) times that scale, summed in f32 over c in ascending
//     order, y * wos, x2 = x + that;
//   * RMSNorm(x2, mw[l]), per-row int8, gate | up (float(i32) * hs * s),
//     silu(g) * u quantized per (row, d_ff tile), the down-projection's f32
//     parts summed in tile order, x_out = x2 + acc * sd;
//   * RMSNorm(x_out, nw[nxt]), per-row int8, qkv_next = float(i32) * xs * sq
//     of layer nxt = min(l + 1, L - 1).
// Rounding follows the plain version (ops/decode_layer.py): int8 products in
// int32, IEEE divides, no contracted multiply-add, and each attention block's
// probability sum, the current token's score and the variances summed in
// double and rounded to f32 once, so that the summation order does not show.
//
// Bound: bytes. A layer reads its int8 weights once (Chatterbox T3: 16.8 MB;
// Qwen3: 62.9 MB) and the valid slots' int8 k/v with their bf16 scales and
// the bias (T3 at 416 valid slots: 14.1 MB; Qwen3 at 352: 5.9 MB): 9.2 and
// 20.5 us at 3.35 TB/s. At b <= 16 each weight byte serves at most 16
// multiply-adds, far below the int8 tensor-core rate.
//
// Design (first, simple version): one persistent grid of one block per SM
// (at most what the card keeps resident, checked with
// cudaOccupancyMaxActiveBlocksPerMultiprocessor), launched with
// cudaLaunchCooperativeKernel; grid.sync() separates the phases, each of
// which strides its items over the grid:
//   P1 attention, one item per (row, kv head) with its g q rows -> o int8
//      [b, H, d] and one scale per (row, q head)
//   P2 o-projection partials, one item per (q head, 128 columns), all b
//      rows at once (each weight byte read once) -> int32 [H, b, D]
//   P3 x2 = x + (heads summed in order) * wos, one element per thread
//   P4 every block: RMSNorm + int8 of all b rows (one warp per row); gate |
//      up items per (K slice, 128 columns) -> int32 partials per K slice
//   P5 items per (row, d_ff tile): the slices summed (int32, exact),
//      silu(g) * u, its amax, int8 -> hidden [b, F] and its scales
//   P6 down items per (K slice of a tile, 128 columns) -> int32 partials
//   P7 x_out = x2 + (tiles summed in order) * sd, one element per thread
//   P8 every block: RMSNorm + int8 of all b rows; qkv items per (K slice,
//      128 columns)
//   P9 qkv = float(slices summed) * xs * sq, one element per thread
// Eight grid barriers. An item is 128 columns x a K slice of one int8 weight
// matrix: 8 warps split the rows, each lane multiplies 4 columns for every
// batch row with __dp4a after a 4x4 byte transpose (__byte_perm), the warps
// meet in shared memory, and each K slice writes its own int32 partials
// (no atomics in global memory, and none across heads: their scales
// differ). Data written during the launch is read with __ldcg (L2,
// coherent). No tensor cores, no TMA.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

#define NT 256
#define NWARPS (NT / 32)
#define COLS 128
#define TBLK 128
#define MAX_B 16
#define MAX_G 8
#define MAX_D 128

enum { KIND_NONE = 0, KIND_F32 = 1, KIND_BF16 = 2 };

struct LayerArgs {
  const float* q;               // [BC, g, d]
  const float* x;               // [b, D]
  const int8_t* k_all;          // [L, BC, T, d]
  const int8_t* v_all;
  const __nv_bfloat16* ks_all;  // [L, BC, T]
  const __nv_bfloat16* vs_all;
  const float* bias;            // [b, T]
  const float* k_new;           // [BC, d]
  const float* v_new;
  const int8_t* wo;             // [L, H * d, D]
  const float* wos;             // [L, D]
  const void* mw;               // [L, D] (norm_kind)
  const int8_t* wgu;            // [L, D, 2F]
  const float* sgu;             // [L, 2F]
  const int8_t* wd;             // [L, F, D]
  const float* sd;              // [L, D]
  const void* nw;               // [L, D] (norm_kind)
  const int8_t* wq;             // [L, D, Q]
  const float* sq;              // [L, Q]
  float* x_out;                 // [b, D]
  float* qkv_out;               // [b, Q]
  int norm_kind;
  int L, layer, b, kv, g, d, T, n_blk, D, F, tile, Q;
  int kb_d, kb_f;               // K rows per slice of the D- and F-deep products
  float sm_scale, eps;
  // workspace
  int8_t* o8;                   // [b, H, d]
  float* os;                    // [b, H]
  float* x2;                    // [b, D]
  int8_t* hq;                   // [b, F]
  float* hs2;                   // [b, F / tile]
  int* part;                    // int32 partials, one phase at a time
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

struct AttnSmem {
  __align__(16) int8_t q8[MAX_G * MAX_D];
  __align__(16) int8_t v[TBLK * MAX_D];
  int p[MAX_G * TBLK];
  float acc[MAX_G * MAX_D];
  float qs[MAX_G], m[MAX_G], l[MAX_G], corr[MAX_G], ps[MAX_G], snew[MAX_G];
};

// P1: attention of one (row, kv head) item for its g q rows; writes o as int8
// per q head with its scale.
__device__ void attention_item(const LayerArgs& a, int bc, AttnSmem& s, float* redf,
                               double* redd) {
  const int tid = threadIdx.x;
  const int g = a.g, d = a.d, T = a.T;
  const int row = bc / a.kv;
  const int BC = a.b * a.kv;
  const float* qb = a.q + (long long)bc * g * d;
  for (int gi = 0; gi < g; ++gi) {
    const float qv = tid < d ? qb[gi * d + tid] : 0.0f;
    const float qs = quant_scale(block_max(fabsf(qv), redf), 1e-8f);
    if (tid < d) s.q8[gi * d + tid] = quant(qv, qs);
    if (tid == 0) {
      s.qs[gi] = qs;
      s.m[gi] = -1e30f;
      s.l[gi] = 0.0f;
    }
  }
  for (int o = tid; o < g * d; o += NT) s.acc[o] = 0.0f;
  __syncthreads();

  const long long lrow = (long long)a.layer * BC + bc;
  const int8_t* kb = a.k_all + lrow * T * d;
  const int8_t* vb = a.v_all + lrow * T * d;
  const __nv_bfloat16* ksb = a.ks_all + lrow * T;
  const __nv_bfloat16* vsb = a.vs_all + lrow * T;
  const float* brow = a.bias + (long long)row * T;
  const bool owner = tid < TBLK;  // thread t owns slot t of the current block
  for (int blk = 0; blk < a.n_blk; ++blk) {
    const int t = blk * TBLK + tid;
    const int4* vsrc = reinterpret_cast<const int4*>(vb + (long long)blk * TBLK * d);
    int4* vdst = reinterpret_cast<int4*>(s.v);
    for (int i = tid; i < TBLK * d / 16; i += NT) vdst[i] = __ldg(vsrc + i);
    float ksc = 0.0f, vsc = 0.0f, bb = 0.0f;
    if (owner) {
      ksc = __bfloat162float(ksb[t]);
      vsc = __bfloat162float(vsb[t]);
      bb = brow[t];
    }
    for (int gi = 0; gi < g; ++gi) {
      float sc = -INFINITY;
      if (owner) {
        const int4* kr = reinterpret_cast<const int4*>(kb + (long long)t * d);
        const int* qw = reinterpret_cast<const int*>(s.q8 + gi * d);
        int dot = 0;
        for (int w = 0; w < d / 16; ++w) {
          const int4 k4 = __ldg(kr + w);
          dot = __dp4a(k4.x, qw[4 * w + 0], dot);
          dot = __dp4a(k4.y, qw[4 * w + 1], dot);
          dot = __dp4a(k4.z, qw[4 * w + 2], dot);
          dot = __dp4a(k4.w, qw[4 * w + 3], dot);
        }
        sc = __fmul_rn(__int2float_rn(dot), __fmul_rn(s.qs[gi], a.sm_scale));
        sc = __fadd_rn(__fmul_rn(sc, ksc), bb);
      }
      const float m_prev = s.m[gi];
      const float m_new = fmaxf(m_prev, block_max(sc, redf));
      const float corr = expf(__fsub_rn(m_prev, m_new));
      float p = owner ? expf(__fsub_rn(sc, m_new)) : 0.0f;
      const double psum = block_sum((double)p, redd);
      p = __fmul_rn(p, vsc);  // fold the v scales in before quantizing
      const float ps = quant_scale(block_max(p, redf), 1e-20f);
      if (owner) s.p[gi * TBLK + tid] = __float2int_rn(__fdiv_rn(p, ps));
      if (tid == 0) {
        s.m[gi] = m_new;
        s.l[gi] = __fadd_rn(__fmul_rn(s.l[gi], corr), (float)psum);
        s.corr[gi] = corr;
        s.ps[gi] = ps;
      }
    }
    __syncthreads();
    for (int o = tid; o < g * d; o += NT) {
      const int gi = o / d, dd = o - gi * d;
      const int* pg = s.p + gi * TBLK;
      int sum = 0;
#pragma unroll 8
      for (int j = 0; j < TBLK; ++j) sum += pg[j] * (int)s.v[j * d + dd];
      s.acc[o] = __fadd_rn(__fmul_rn(s.acc[o], s.corr[gi]),
                           __fmul_rn(__int2float_rn(sum), s.ps[gi]));
    }
    __syncthreads();
  }

  // the current token's k/v, unquantized
  const float* knb = a.k_new + (long long)bc * d;
  const float* vnb = a.v_new + (long long)bc * d;
  if (tid < g) {
    double acc = 0.0;
    for (int dd = 0; dd < d; ++dd) acc += (double)qb[tid * d + dd] * (double)knb[dd];
    s.snew[tid] = __fmul_rn((float)acc, a.sm_scale);
  }
  __syncthreads();
  for (int o = tid; o < g * d; o += NT) {
    const int gi = o / d, dd = o - gi * d;
    const float m_prev = s.m[gi], s_new = s.snew[gi];
    const float m_fin = fmaxf(m_prev, s_new);
    const float corr = expf(__fsub_rn(m_prev, m_fin));
    const float p_new = expf(__fsub_rn(s_new, m_fin));
    const float l_fin = __fadd_rn(__fmul_rn(s.l[gi], corr), p_new);
    const float num = __fadd_rn(__fmul_rn(s.acc[o], corr), __fmul_rn(p_new, vnb[dd]));
    s.acc[o] = __fdiv_rn(num, fmaxf(l_fin, 1e-30f));
  }
  __syncthreads();
  // o int8 per q head: row of [b, H, d] is (bc * g + gi)
  for (int gi = 0; gi < g; ++gi) {
    const float ov = tid < d ? s.acc[gi * d + tid] : 0.0f;
    const float osc = quant_scale(block_max(fabsf(ov), redf), 1e-8f);
    if (tid < d) a.o8[((long long)bc * g + gi) * d + tid] = quant(ov, osc);
    if (tid == 0) a.os[bc * g + gi] = osc;
  }
}

// int32 sums over rows [k0, k0 + kb) of W ([K, N] int8, N contiguous) for
// columns [n0, n0 + 128) and the b activation rows in act (shared memory, row
// r at act + r * lda, indexed by k - k0), into red[r * COLS + c]. The caller
// has loaded act after a barrier; the result is complete after the trailing
// one.
__device__ void gemv_rows(const int8_t* __restrict__ W, int N, const int8_t* act, int lda, int b,
                          int k0, int kb, int n0, int* red) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int i = threadIdx.x; i < b * COLS; i += NT) red[i] = 0;
  __syncthreads();
  const int n = n0 + lane * 4;
  const int kw = kb / NWARPS;  // a multiple of 4
  const int kbeg = warp * kw;
  int acc[MAX_B][4];
#pragma unroll
  for (int r = 0; r < MAX_B; ++r) acc[r][0] = acc[r][1] = acc[r][2] = acc[r][3] = 0;
  const int8_t* wp = W + (long long)(k0 + kbeg) * N + n;
#pragma unroll 2
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
    const int c0 = __byte_perm(t0, t2, 0x5410);
    const int c1 = __byte_perm(t0, t2, 0x7632);
    const int c2 = __byte_perm(t1, t3, 0x5410);
    const int c3 = __byte_perm(t1, t3, 0x7632);
#pragma unroll
    for (int r = 0; r < MAX_B; ++r) {
      if (r < b) {
        const int av = *reinterpret_cast<const int*>(act + r * lda + kbeg + kk);
        acc[r][0] = __dp4a(c0, av, acc[r][0]);
        acc[r][1] = __dp4a(c1, av, acc[r][1]);
        acc[r][2] = __dp4a(c2, av, acc[r][2]);
        acc[r][3] = __dp4a(c3, av, acc[r][3]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < MAX_B; ++r) {
    if (r < b) {
#pragma unroll
      for (int j = 0; j < 4; ++j) atomicAdd(&red[r * COLS + lane * 4 + j], acc[r][j]);
    }
  }
  __syncthreads();
}

// The b rows of red to the K slice's partials: part[(s * b + r) * N + n0 + c].
__device__ __forceinline__ void store_partials(const int* red, int b, int* part, int s, int N,
                                               int n0) {
  for (int i = threadIdx.x; i < b * COLS; i += NT) {
    const int r = i / COLS, c = i - r * COLS;
    part[((long long)s * b + r) * N + n0 + c] = red[i];
  }
}

// Copies the b rows of xr ([b, D] f32, written during this launch) into xs
// (shared), then RMSNorm with w ([D], wkind) and per-row int8 into act[r * D
// + i], the scales into rs[r]. One warp per row; the mean of the squares
// summed in double and rounded to f32 once.
__device__ void norm_rows(const float* xr, int b, int D, const void* w, int wkind, float eps,
                          float* xs, int8_t* act, float* rs) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int i = threadIdx.x; i < b * D; i += NT) xs[i] = __ldcg(xr + i);
  __syncthreads();
  for (int r = warp; r < b; r += NWARPS) {
    const float* xp = xs + (long long)r * D;
    double ss = 0.0;
    for (int i = lane; i < D; i += 32) {
      const double v = (double)xp[i];
      ss += v * v;
    }
    for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
    const float var = (float)(ss / (double)D);
    const float inv = __frcp_rn(__fsqrt_rn(__fadd_rn(var, eps)));
    float amax = 0.0f;
    for (int i = lane; i < D; i += 32) {
      amax = fmaxf(amax, fabsf(__fmul_rn(__fmul_rn(xp[i], inv), load_f(w, wkind, i))));
    }
    for (int o = 16; o > 0; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
    const float s = quant_scale(amax, 1e-8f);
    for (int i = lane; i < D; i += 32) {
      act[r * D + i] = quant(__fmul_rn(__fmul_rn(xp[i], inv), load_f(w, wkind, i)), s);
    }
    if (lane == 0) rs[r] = s;
  }
  __syncthreads();
}

// acc[(s, r), n] for every K slice s of the D-deep product act . W ([D, N]),
// items (slice, 128 columns) strided over the grid.
__device__ void gemv_slices(const int8_t* __restrict__ W, int K, int N, int kb, const int8_t* act,
                            int b, int* part, int* red) {
  const int nt = N / COLS;
  const int items = (K / kb) * nt;
  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    const int s = it / nt, n0 = (it - s * nt) * COLS;
    __syncthreads();  // the previous item's red is written out
    gemv_rows(W, N, act + s * kb, K, b, s * kb, kb, n0, red);
    store_partials(red, b, part, s, N, n0);
  }
}

__global__ void __launch_bounds__(NT, 1) decode_layer_kernel(LayerArgs a) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ AttnSmem at;
  __shared__ int red_i[MAX_B * COLS];
  __shared__ float red_f[NWARPS];
  __shared__ double red_d[NWARPS];
  __shared__ float hs_s[MAX_B], xs_s[MAX_B];

  const int b = a.b, D = a.D, F = a.F, Q = a.Q, d = a.d, tile = a.tile;
  const int H = a.kv * a.g;
  const int n_tiles = F / tile;
  const int tid = threadIdx.x;
  const long long gt = (long long)blockIdx.x * NT + tid, gn = (long long)gridDim.x * NT;
  const int act_bytes = b * (D > 256 ? D : 256);
  int8_t* act = reinterpret_cast<int8_t*>(smem);                     // int8 activations
  float* fbuf = reinterpret_cast<float*>(smem + (act_bytes + 15) / 16 * 16);  // f32 rows / hidden
  const int l = a.layer;
  const int nxt = l + 1 < a.L ? l + 1 : a.L - 1;
  const int esz = a.norm_kind == KIND_BF16 ? 2 : 4;

  // ── P1: attention, one item per (row, kv head) ──
  for (int bc = blockIdx.x; bc < b * a.kv; bc += gridDim.x) attention_item(a, bc, at, red_f, red_d);
  grid.sync();

  // ── P2: o-projection partials per (q head, 128 columns), all rows ──
  {
    const int8_t* wo_l = a.wo + (long long)l * H * d * D;
    const int nt = D / COLS;
    for (int it = blockIdx.x; it < H * nt; it += gridDim.x) {
      const int c = it / nt, n0 = (it - c * nt) * COLS;
      __syncthreads();
      const int dw = d / 4;
      for (int i = tid; i < b * dw; i += NT) {
        const int r = i / dw, w = i - r * dw;
        reinterpret_cast<int*>(act)[i] =
            __ldcg(reinterpret_cast<const int*>(a.o8 + ((long long)r * H + c) * d) + w);
      }
      gemv_rows(wo_l, D, act, d, b, c * d, d, n0, red_i);
      store_partials(red_i, b, a.part, c, D, n0);
    }
  }
  grid.sync();

  // ── P3: x2 = x + (sum over heads, ascending) * wos ──
  {
    const float* wos_l = a.wos + (long long)l * D;
    for (long long e = gt; e < (long long)b * D; e += gn) {
      const int r = (int)(e / D), n = (int)(e - (long long)r * D);
      float y = __fmul_rn(__int2float_rn(__ldcg(&a.part[(long long)r * D + n])),
                          __ldcg(&a.os[r * H]));
      for (int c = 1; c < H; ++c) {
        y = __fadd_rn(y, __fmul_rn(__int2float_rn(__ldcg(&a.part[((long long)c * b + r) * D + n])),
                                   __ldcg(&a.os[r * H + c])));
      }
      a.x2[e] = __fadd_rn(a.x[e], __fmul_rn(y, wos_l[n]));
    }
  }
  grid.sync();

  // ── P4: every block: RMSNorm + int8 of all rows; gate | up partials ──
  norm_rows(a.x2, b, D, reinterpret_cast<const char*>(a.mw) + (long long)l * D * esz, a.norm_kind,
            a.eps, fbuf, act, hs_s);
  gemv_slices(a.wgu + (long long)l * D * 2 * F, D, 2 * F, a.kb_d, act, b, a.part, red_i);
  grid.sync();

  // ── P5: silu(g) * u per (row, d_ff tile), quantized per item ──
  {
    const float* sg = a.sgu + (long long)l * 2 * F;
    const int ns = D / a.kb_d;
    for (int it = blockIdx.x; it < b * n_tiles; it += gridDim.x) {
      const int r = it / n_tiles, t = it - r * n_tiles;
      const float hs = hs_s[r];
      float amax = 0.0f;
      for (int c = tid; c < tile; c += NT) {
        const int col = t * tile + c;
        int yg = 0, yu = 0;
        for (int s = 0; s < ns; ++s) {
          const long long base = ((long long)s * b + r) * 2 * F;
          yg += __ldcg(&a.part[base + col]);
          yu += __ldcg(&a.part[base + F + col]);
        }
        const float gv = __fmul_rn(__fmul_rn(__int2float_rn(yg), hs), sg[col]);
        const float uv = __fmul_rn(__fmul_rn(__int2float_rn(yu), hs), sg[F + col]);
        const float h = __fmul_rn(__fmul_rn(gv, __frcp_rn(__fadd_rn(1.0f, expf(-gv)))), uv);
        fbuf[c] = h;
        amax = fmaxf(amax, fabsf(h));
      }
      const float s = quant_scale(block_max(amax, red_f), 1e-8f);
      for (int c = tid; c < tile; c += NT) {
        a.hq[(long long)r * F + t * tile + c] = quant(fbuf[c], s);
      }
      if (tid == 0) a.hs2[r * n_tiles + t] = s;
      __syncthreads();  // fbuf is read before the next item writes it
    }
  }
  grid.sync();

  // ── P6: down-projection partials per (K slice of a tile, 128 columns) ──
  {
    const int8_t* wd_l = a.wd + (long long)l * F * D;
    const int kb = a.kb_f, nt = D / COLS;
    for (int it = blockIdx.x; it < (F / kb) * nt; it += gridDim.x) {
      const int s = it / nt, n0 = (it - s * nt) * COLS;
      __syncthreads();
      const int kw = kb / 4;
      for (int i = tid; i < b * kw; i += NT) {
        const int r = i / kw, w = i - r * kw;
        reinterpret_cast<int*>(act)[i] =
            __ldcg(reinterpret_cast<const int*>(a.hq + (long long)r * F + (long long)s * kb) + w);
      }
      gemv_rows(wd_l, D, act, kb, b, s * kb, kb, n0, red_i);
      store_partials(red_i, b, a.part, s, D, n0);
    }
  }
  grid.sync();

  // ── P7: x_out = x2 + (sum over tiles, in order) * sd ──
  {
    const float* sd_l = a.sd + (long long)l * D;
    const int per_tile = tile / a.kb_f;
    for (long long e = gt; e < (long long)b * D; e += gn) {
      const int r = (int)(e / D), n = (int)(e - (long long)r * D);
      float acc = 0.0f;
      for (int t = 0; t < n_tiles; ++t) {
        int y = 0;
        for (int s = t * per_tile; s < (t + 1) * per_tile; ++s) {
          y += __ldcg(&a.part[((long long)s * b + r) * D + n]);
        }
        const float dt = __fmul_rn(__int2float_rn(y), __ldcg(&a.hs2[r * n_tiles + t]));
        acc = t == 0 ? dt : __fadd_rn(acc, dt);
      }
      a.x_out[e] = __fadd_rn(__ldcg(&a.x2[e]), __fmul_rn(acc, sd_l[n]));
    }
  }
  grid.sync();

  // ── P8: every block: the next layer's RMSNorm + int8; qkv partials ──
  norm_rows(a.x_out, b, D, reinterpret_cast<const char*>(a.nw) + (long long)nxt * D * esz,
            a.norm_kind, a.eps, fbuf, act, xs_s);
  gemv_slices(a.wq + (long long)nxt * D * Q, D, Q, a.kb_d, act, b, a.part, red_i);
  grid.sync();

  // ── P9: qkv = float(slices summed) * xs * sq ──
  {
    const float* sq_n = a.sq + (long long)nxt * Q;
    const int ns = D / a.kb_d;
    for (long long e = gt; e < (long long)b * Q; e += gn) {
      const int r = (int)(e / Q), n = (int)(e - (long long)r * Q);
      int y = 0;
      for (int s = 0; s < ns; ++s) y += __ldcg(&a.part[((long long)s * b + r) * Q + n]);
      a.qkv_out[e] = __fmul_rn(__fmul_rn(__int2float_rn(y), xs_s[r]), sq_n[n]);
    }
  }
}

// ── host side ────────────────────────────────────────────────────────────

static long long align256(long long n) { return (n + 255) / 256 * 256; }

static int kb_of(int K) { return K % 256 == 0 ? 256 : 128; }

static bool shapes_ok(int b, int kv, int g, int d, int D, int F, int tile, int Q) {
  return b >= 1 && b <= MAX_B && kv >= 1 && g >= 1 && g <= MAX_G && d >= 32 && d <= MAX_D &&
         d % 32 == 0 && D >= 128 && D % 128 == 0 && Q >= 128 && Q % 128 == 0 && tile >= 128 &&
         tile % 128 == 0 && F % tile == 0;
}

static size_t smem_bytes(int b, int D, int tile) {
  const long long act = (long long)b * (D > 256 ? D : 256);
  const long long nf = (long long)b * D > tile ? (long long)b * D : tile;
  return (size_t)((act + 15) / 16 * 16 + nf * 4);
}

static long long part_ints(int b, int H, int D, int F, int tile, int Q) {
  long long n = (long long)H * b * D;                                  // o-projection
  const long long gu = (long long)(D / kb_of(D)) * b * 2 * F;         // gate | up
  const long long dn = (long long)(F / kb_of(tile)) * b * D;          // down
  const long long qk = (long long)(D / kb_of(D)) * b * Q;             // qkv
  if (gu > n) n = gu;
  if (dn > n) n = dn;
  if (qk > n) n = qk;
  return n;
}

// SMs and resident blocks per SM at these shapes (0 on success).
static int occupancy(int b, int D, int tile, int* sms, int* per_sm) {
  const size_t smem = smem_bytes(b, D, tile);
  cudaError_t e = cudaFuncSetAttribute(decode_layer_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  int dev = 0;
  e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, decode_layer_kernel, NT, smem);
  return (int)e;
}

extern "C" long long vt_decode_layer_workspace(int b, int kv, int g, int d, int D, int F,
                                               int tile, int Q) {
  if (!shapes_ok(b, kv, g, d, D, F, tile, Q)) return -1;
  const int H = kv * g;
  return align256((long long)b * H * d) + align256((long long)b * H * 4) +
         align256((long long)b * D * 4) + align256((long long)b * F) +
         align256((long long)b * (F / tile) * 4) + align256(part_ints(b, H, D, F, tile, Q) * 4);
}

// The largest grid a cooperative launch accepts (SMs x resident blocks).
extern "C" int vt_decode_layer_max_blocks(int b, int D, int F, int tile) {
  if (b < 1 || b > MAX_B || D < 128 || D % 128 || tile < 128 || tile % 128 || F % tile) {
    return -(int)cudaErrorInvalidValue;
  }
  int sms = 0, per_sm = 0;
  const int rc = occupancy(b, D, tile, &sms, &per_sm);
  return rc ? -rc : sms * per_sm;
}

// B12: one cooperative launch for layer `layer`. grid <= 0 takes one block
// per SM. n_blk: the 128-slot blocks of the cache to read (>= 1).
extern "C" int vt_decode_layer(
    const void* q, const void* x, const void* k_all, const void* v_all, const void* k_scale,
    const void* v_scale, const void* bias, const void* k_new, const void* v_new,
    const void* wo, const void* wos, const void* mw, const void* wgu, const void* sgu,
    const void* wd, const void* sd, const void* nw, const void* wq, const void* sq,
    void* x_out, void* qkv_out, int norm_kind, int grid, int L, int layer, int b, int kv, int g,
    int d, int T, int n_blk, int D, int F, int tile, int Q, float sm_scale, float eps,
    void* ws, long long ws_bytes, void* stream) {
  if (!shapes_ok(b, kv, g, d, D, F, tile, Q) || L < 1 || layer < 0 || layer >= L ||
      T < TBLK || T % TBLK || n_blk < 1 || n_blk > T / TBLK || norm_kind == KIND_NONE ||
      ws_bytes < vt_decode_layer_workspace(b, kv, g, d, D, F, tile, Q)) {
    return (int)cudaErrorInvalidValue;
  }
  int sms = 0, per_sm = 0;
  int rc = occupancy(b, D, tile, &sms, &per_sm);
  if (rc) return rc;
  if (grid <= 0) {
    if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
    grid = sms;
  }
  const int H = kv * g;
  LayerArgs a;
  a.q = (const float*)q;
  a.x = (const float*)x;
  a.k_all = (const int8_t*)k_all;
  a.v_all = (const int8_t*)v_all;
  a.ks_all = (const __nv_bfloat16*)k_scale;
  a.vs_all = (const __nv_bfloat16*)v_scale;
  a.bias = (const float*)bias;
  a.k_new = (const float*)k_new;
  a.v_new = (const float*)v_new;
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
  a.x_out = (float*)x_out;
  a.qkv_out = (float*)qkv_out;
  a.norm_kind = norm_kind;
  a.L = L;
  a.layer = layer;
  a.b = b;
  a.kv = kv;
  a.g = g;
  a.d = d;
  a.T = T;
  a.n_blk = n_blk;
  a.D = D;
  a.F = F;
  a.tile = tile;
  a.Q = Q;
  a.kb_d = kb_of(D);
  a.kb_f = kb_of(tile);
  a.sm_scale = sm_scale;
  a.eps = eps;
  char* p = (char*)ws;
  a.o8 = (int8_t*)p;
  p += align256((long long)b * H * d);
  a.os = (float*)p;
  p += align256((long long)b * H * 4);
  a.x2 = (float*)p;
  p += align256((long long)b * D * 4);
  a.hq = (int8_t*)p;
  p += align256((long long)b * F);
  a.hs2 = (float*)p;
  p += align256((long long)b * (F / tile) * 4);
  a.part = (int*)p;
  void* params[] = {&a};
  cudaError_t e = cudaLaunchCooperativeKernel((const void*)decode_layer_kernel, dim3(grid),
                                              dim3(NT), params, smem_bytes(b, D, tile),
                                              (cudaStream_t)stream);
  if (e != cudaSuccess) {
    cudaGetLastError();  // a refused launch leaves no sticky error; clear the last one
    return (int)e;
  }
  return (int)cudaGetLastError();
}
