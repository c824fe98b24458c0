// B2 (the SwiGLU layer tail + the NEXT layer's RMSNorm and qkv product) and
// B8a (the tail alone) as ONE cooperative, persistent launch whose int8
// weights stream into shared memory ahead of its grid barriers and are
// multiplied on the int8 tensor cores.
//
// Replaces, in vocalie_tts_tpu/ops/decode_dense.py:
//   B2  tail_swiglu_qkv_int8_stacked  (def :519, pallas_call :611)
//   B8a tail_swiglu_int8_stacked      (def :368, pallas_call :428)
// The math is theirs, step for step, and the plain versions' in
// ops/decode_dense.py (tail_swiglu_qkv_int8_plain, tail_swiglu_int8_plain):
//   x2   = x + (float(q(attn) . Wo[l]) * as) * wos
//   gu   = (float(q(rms(x2, mw[l])) . Wgu[l]) * hs) * sgu
//   h    = (g * (1 / (1 + exp(-g)))) * u, quantized per (row, d_ff tile)
//   out  = x2 + (sum over tiles, in order, of float(h_t . Wd_t) * s_t) * sd
//   qkv  = (float(q(rms(out, nw[nxt])) . Wq[nxt]) * xs) * sq, nxt = min(l+1, L-1)
// with int8 x int8 summed in int32 (exact in any order), every f32 step an
// IEEE intrinsic (nothing contracted into an FMA), the variances summed in
// double and rounded once, the quantizer's IEEE divide with floor 1e-8: the
// outputs are bit-equal to the plain versions'.
//
// Bound: bytes. Each weight byte serves b <= 16 multiply-adds. At the T3
// layer (b 16, d 1024, d_ff 4096, qkv 3072) a call reads 16.8 MB of weights
// (5.0 us at 3.35 TB/s), at the Qwen3 layer (b 8, d 2048, d_ff 8192, qkv
// 4096) 62.9 MB (18.8 us).
//
// Design. The old body was 12 kernels a call (norm_quant + gemv_partial +
// gemv_finish for each product, and swiglu_quant), each draining the card,
// with ~5.5 MiB of int32 partials through device memory, and its weights
// read by 4-byte __ldg with no request across a kernel boundary. Here:
//   * one block per SM (cudaLaunchCooperativeKernel), 512 threads (256 for
//     b > 16, whose second m16 tile doubles the accumulators); grid
//     barriers only where a row-wide reduction needs one: after x2 (the MLP
//     RMSNorm), after the hidden's per-(row, tile) amax, after the quantized
//     hidden (the down-projection's A), after x_out (the next RMSNorm): four
//     for B2, three for B8a;
//   * every block owns whole output columns in 32-column slabs (items), each
//     over the full K, so its epilogue is in-block and no int32 partial goes
//     through device memory; gate column c and up column F + c are one item.
//     The items are dealt to the blocks by bytes, largest first, to the least
//     loaded (ops/decode_dense.py tail_plan, cached per shape with the ring
//     depth and the shared bytes; the item table is uploaded once);
//   * weight tiles (kc rows of a slab) come by TMA: thread 0 asks the copy
//     engine for boxes of 256 rows x 32 bytes (tensor maps encoded once per
//     weight array) and the warps wait on the stage's mbarrier, so no thread
//     stalls issuing copies. Each block streams its items' tiles through a
//     ring of `stages` stages, refilled as it consumes them, across the
//     barriers: at the T3 layer the ring holds all of a block's tiles (<= 128
//     KB), at the Qwen3 layer (~470 KB a block) it is refilled. Until barrier
//     1 only the o-projection's tiles are asked for (the plan gives each
//     o-projection item a block of its own), so that they have the card's
//     bandwidth to themselves; the MLP norm's blocks ask for the rest once
//     they have read their rows, the other blocks once all of them have (a
//     counter in device memory): the stream would slow those reads down;
//   * products on the int8 tensor cores (int8_stream.cuh): mma m16n8k32 with
//     the batch rows as A (one m16 tile for b <= 16, two for b <= 32) and the
//     slab as B after a 4 x 4 byte transpose in registers; the warps split
//     K, and meet through shared-memory int32 adds;
//   * every block recomputes each row norm from L2 (a row over one or two
//     warps, in a fixed order: the same bits in every block); the hidden's
//     amax meets in device memory by atomicMax of the float bits (exact, any
//     order);
//   * the chain of dependent reads between the barriers is kept short: the
//     MLP norm's weights, each item's column scales and the o-projection's
//     residual columns are requested (cp.async) at entry; the
//     down-projection's activations and residual columns are loaded in one
//     round trip; a warp issues all its row's loads before it reduces.
// vocalie_tts_tpu_torch/tools/tail_swiglu_trace.py reads the card's clock at
// each phase point (the `stamps` argument).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "int8_stream.cuh"
#include "tensor_map.cuh"

namespace cg = cooperative_groups;
using namespace i8s;

namespace {

constexpr int MAX_B = 32;
constexpr int MAX_D = 2048;   // the widest normed row (quant_rows splits it over warps)
constexpr int SMEM_MAX = 232448;
constexpr int VEC_BYTES = 2 * SLAB * 4;   // an item's column scales (gate and up for gate | up)
constexpr int COL_ROW = SLAB * 4;         // bytes of one row of an item's residual columns

struct TailArgs {
  const float* attn;   // [b, d_attn]
  const void* x;       // [b, d] (x_kind)
  const int8_t* wo;    // [L, d_attn, d]
  const float* wos;    // [L, d]
  const void* mw;      // [L, d] (norm_kind)
  const int8_t* wgu;   // [L, d, 2F]
  const float* sgu;    // [L, 2F]
  const int8_t* wd;    // [L, F, d]
  const float* sd;     // [L, d]
  const void* nw;      // [L, d] (norm_kind)
  const int8_t* wq;    // [L, d, Q]
  const float* sq;     // [L, Q]
  float* x_out;        // [b, d]
  float* qkv_out;      // [b, Q]
  const int* plan;     // [grid + 1] item offsets, then the items (product << 24 | slab)
  float* x2;           // [b, d]        workspace
  int8_t* hq;          // [b, F]
  unsigned* amax;      // [b, F / tile] float bits
  unsigned* normed;    // the blocks past the MLP norm
  unsigned long long* stamps;  // [grid, TAIL_STAMPS] %globaltimer at each phase point, or null
  int x_kind, norm_kind, layer, nxt, b, d_attn, d, F, tile, Q;
  int kc, stages, lda, max_gu, max_items, gu_blocks;
  float eps;
};

// shared memory, in order: the ring, the int8 activations, the int32 sums
// (gate | up), the items' hidden, the down-projection's f32 sum, row scales,
// the MLP norm's weights, each item's column scales and residual columns,
// the row quantizer's scratch, the stages' mbarriers
struct Layout {
  int ring, act, red, hid, dacc, sc, nvec, vec, cols, scratch, bars, total;
};

__host__ __device__ inline int align16(int n) { return (n + 15) / 16 * 16; }

__host__ __device__ inline Layout layout(int b, int mt, int lda, int d, int max_gu,
                                         int max_items, int n_tiles, int stages, int kc) {
  Layout o;
  o.ring = 0;
  o.act = stages * kc * SLAB;
  o.red = o.act + align16(b * lda);
  o.hid = o.red + align16(2 * 16 * mt * RED_ROW * 4);
  o.dacc = o.hid + align16(max_gu * b * SLAB * 4);
  o.sc = o.dacc + align16(b * SLAB * 4);
  o.nvec = o.sc + align16(4 * b * (n_tiles > 1 ? n_tiles : 1));
  o.vec = o.nvec + align16(4 * d);
  o.cols = o.vec + max_items * VEC_BYTES;
  o.scratch = o.cols + max_items * b * COL_ROW;
  o.bars = o.scratch + QUANT_SCRATCH;
  o.total = o.bars + 8 * MAX_STAGES;
  return o;
}

__device__ __forceinline__ int item_tiles(const TailArgs& a, int code) {
  switch (code >> 24) {
    case 0: return a.d_attn / a.kc;
    case 1: return 2 * (a.d / a.kc);   // gate and up, alternating
    case 2: return a.F / a.kc;
    default: return a.d / a.kc;
  }
}

// The four weight arrays' tensor maps ([L, K, N] int8, boxes of BOX_ROWS x
// 32 bytes), kernel parameters in constant space.
struct Maps {
  CUtensorMap wo, wgu, wd, wq;
};

// Requests tile j of an item into shared dst: its kc rows as kc / BOX_ROWS
// (or one kc-row) boxes of the item's 32 columns, completing on bar.
__device__ __forceinline__ void tile_request(const TailArgs& a, const Maps& m, int code, int j,
                                             uint32_t dst, uint32_t bar) {
  int col = SLAB * (code & 0xffffff), row = j * a.kc, layer = a.layer;
  const CUtensorMap* map;
  switch (code >> 24) {
    case 0: map = &m.wo; break;
    case 1:
      map = &m.wgu;
      row = (j >> 1) * a.kc;
      col += (j & 1) * a.F;
      break;
    case 2: map = &m.wd; break;
    default:
      map = &m.wq;
      layer = a.nxt;
  }
  const int rows = a.kc < BOX_ROWS ? a.kc : BOX_ROWS;
  mbar_expect_tx(bar, a.kc * SLAB);
  for (int k = 0; k < a.kc; k += rows) tma_load(dst + k * SLAB, map, col, row + k, layer, bar);
}

template <int MT>
__global__ void __launch_bounds__(threads<MT>(), 1)
    tail_swiglu_kernel(TailArgs a, const __grid_constant__ Maps m) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(1024) unsigned char smem[];
  const int b = a.b, d = a.d, F = a.F, tid = threadIdx.x, nt = threads<MT>();
  const int n_tiles = F / a.tile;
  const Layout lo = layout(b, MT, a.lda, d, a.max_gu, a.max_items, n_tiles, a.stages, a.kc);
  int8_t* act = reinterpret_cast<int8_t*>(smem + lo.act);
  int* red = reinterpret_cast<int*>(smem + lo.red);          // [2][16 MT][RED_ROW]
  int* red_u = red + 16 * MT * RED_ROW;
  float* hid = reinterpret_cast<float*>(smem + lo.hid);      // [max_gu][b][32]
  float* dacc = reinterpret_cast<float*>(smem + lo.dacc);    // [b][32]
  float* sc = reinterpret_cast<float*>(smem + lo.sc);        // row (or row, tile) scales
  const unsigned char* nvec = smem + lo.nvec;                // mw[l], norm_kind
  const float* vec = reinterpret_cast<const float*>(smem + lo.vec);   // [item][2][32]
  float* cols = reinterpret_cast<float*>(smem + lo.cols);    // [item][b][32]
  void* scratch = smem + lo.scratch;
  stamp(a, 0);

  const int beg = a.plan[blockIdx.x];
  TileRing rg;
  rg.items = a.plan + gridDim.x + 1 + beg;
  rg.n_items = a.plan[blockIdx.x + 1] - beg;
  rg.pi = rg.pj = rg.next = rg.groups = rg.cap = 0;
  rg.base = smem_u32(smem + lo.ring);
  rg.bars = smem_u32(smem + lo.bars);
  if (tid == 0) {
    for (int s = 0; s < a.stages; ++s) mbar_init(rg.bars + 8 * s, 1);
    mbar_fence_init();
  }
  __syncthreads();
  const uint32_t act_s = smem_u32(act);
  const int* items = rg.items;
  const int n_items = rg.n_items;
  const int esz = a.norm_kind == KIND_BF16 ? 2 : 4;
  const int xsz = a.x_kind == KIND_BF16 ? 2 : 4;
  // the small inputs, in a group of their own ahead of the tiles: the MLP
  // norm's weights, each item's column scales, the o-projection's residual
  // columns
  copy_async(smem_u32(nvec), reinterpret_cast<const char*>(a.mw) + (long long)a.layer * d * esz,
             d * esz);
  for (int it = 0; it < n_items; ++it) {
    const int p = items[it] >> 24, c0 = SLAB * (items[it] & 0xffffff);
    const float* s0 = p == 0   ? a.wos + (long long)a.layer * d + c0
                      : p == 1 ? a.sgu + (long long)a.layer * 2 * F + c0
                      : p == 2 ? a.sd + (long long)a.layer * d + c0
                               : a.sq + (long long)a.nxt * a.Q + c0;
    const uint32_t v = smem_u32(vec) + it * VEC_BYTES;
    if (tid < 8) cp_async16(v + 16 * tid, s0 + 4 * tid);
    if (p == 1 && tid >= 8 && tid < 16) cp_async16(v + 16 * tid, s0 + F + 4 * (tid - 8));
    if (p == 0) {
      const int chunks = SLAB * xsz / 16;   // 16-byte chunks of a row's 32 columns
      for (int i = tid; i < b * chunks; i += nt) {
        const int r = i / chunks, c = i - r * chunks;
        cp_async16(smem_u32(cols) + (it * b + r) * COL_ROW + 16 * c,
                   reinterpret_cast<const char*>(a.x) + ((long long)r * d + c0) * xsz + 16 * c);
      }
    }
  }
  cp_async_commit();   // group 0: the small inputs
  // the o-projection's tiles now, alone on the card until barrier 1; every
  // other tile the ring holds once the block has passed it (and its MLP
  // norm's reads: they would queue behind the stream)
  fill(a, m, rg);

  for (int i = tid; i < 2 * 16 * MT * RED_ROW; i += nt) red[i] = 0;
  if (blockIdx.x == 0) {   // used after barrier 1
    for (int i = tid; i < b * n_tiles; i += nt) a.amax[i] = 0u;
    if (tid == 0) *a.normed = 0u;
  }
  int it = 0;
  int acc[MT][4][4];
  zero_acc(acc);

  // ── o-projection + residual: x2 ──
  if (it < n_items && (items[it] >> 24) == 0) {
    quant_rows(a.attn, b, a.d_attn, nullptr, KIND_NONE, 0.0f, act, a.lda, sc, scratch);
    wait_first();   // the column scales and the residual columns
  }
  for (; it < n_items && (items[it] >> 24) == 0; ++it) {
    const int c0 = SLAB * (items[it] & 0xffffff);
    for (int j = 0; j < a.d_attn / a.kc; ++j) {
      const uint32_t t = wait_tile(a, rg);
      tile_mma<MT>(t, a.kc, act_s, a.lda, b, j * a.kc, acc);
      release_tile(a, m, rg);
    }
    acc_to_red<MT>(acc, red, b);
    __syncthreads();
    const unsigned char* xr = reinterpret_cast<const unsigned char*>(cols + it * b * SLAB);
    for (int e = tid; e < b * SLAB; e += nt) {
      const int r = e / SLAB, c = e % SLAB;
      const int k = r * RED_ROW + c;
      const float y = __fmul_rn(__fmul_rn(__int2float_rn(red[k]), sc[r]), vec[it * 2 * SLAB + c]);
      a.x2[(long long)r * d + c0 + c] = __fadd_rn(load_f(xr + r * COL_ROW, a.x_kind, c), y);
      red[k] = 0;
    }
    __syncthreads();
  }
  stamp(a, 1);
  grid.sync();
  stamp(a, 2);
  wait_first();   // the small inputs of every later phase
  rg.cap = 3;
  if (it >= n_items || (items[it] >> 24) != 1) {
    // the rest of the stream once every gate | up block has read its rows
    // through L2 for the MLP norm (the stream would slow those reads down)
    if (tid == 0) {
      while (atomicAdd(a.normed, 0u) < (unsigned)a.gu_blocks) __nanosleep(256);
    }
    __syncthreads();
    fill(a, m, rg);
  }

  // ── MLP RMSNorm, gate | up, silu(g) * u and its amax per (row, tile) ──
  const int gu_beg = it;
  if (it < n_items && (items[it] >> 24) == 1) {
    quant_rows(a.x2, b, d, nvec, a.norm_kind, a.eps, act, a.lda, sc, scratch);
    if (tid == 0) atomicAdd(a.normed, 1u);
    fill(a, m, rg);
  }
  stamp(a, 3);
  {
    int acc_u[MT][4][4];
    zero_acc(acc_u);
    for (int slot = 0; it < n_items && (items[it] >> 24) == 1; ++it, ++slot) {
      const int c0 = SLAB * (items[it] & 0xffffff);
      for (int j = 0; j < d / a.kc; ++j) {
        uint32_t t = wait_tile(a, rg);
        tile_mma<MT>(t, a.kc, act_s, a.lda, b, j * a.kc, acc);
        release_tile(a, m, rg);
        t = wait_tile(a, rg);
        tile_mma<MT>(t, a.kc, act_s, a.lda, b, j * a.kc, acc_u);
        release_tile(a, m, rg);
      }
      acc_to_red<MT>(acc, red, b);
      acc_to_red<MT>(acc_u, red_u, b);
      __syncthreads();
      float* h = hid + slot * b * SLAB;
      const float* sg = vec + it * 2 * SLAB;
      for (int e = tid; e < b * SLAB; e += nt) {
        const int r = e / SLAB, c = e % SLAB, k = r * RED_ROW + c;
        const float gv = __fmul_rn(__fmul_rn(__int2float_rn(red[k]), sc[r]), sg[c]);
        const float uv = __fmul_rn(__fmul_rn(__int2float_rn(red_u[k]), sc[r]), sg[SLAB + c]);
        h[e] = __fmul_rn(__fmul_rn(gv, __frcp_rn(__fadd_rn(1.0f, expf(-gv)))), uv);
        red[k] = red_u[k] = 0;
      }
      __syncthreads();
      // the item's 32 columns lie in one d_ff tile: one atomicMax a row
      const int lane = tid & 31;
      for (int r = tid >> 5; r < b; r += nt >> 5) {
        float m = fabsf(h[r * SLAB + lane]);
        for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
        if (lane == 0) atomicMax(&a.amax[r * n_tiles + c0 / a.tile], __float_as_uint(m));
      }
    }
  }
  stamp(a, 4);
  grid.sync();
  stamp(a, 5);

  // ── the hidden quantized per (row, tile) ──
  for (int i = gu_beg, slot = 0; i < n_items && (items[i] >> 24) == 1; ++i, ++slot) {
    const int c0 = SLAB * (items[i] & 0xffffff);
    const float* h = hid + slot * b * SLAB;
    for (int e = tid; e < b * SLAB; e += nt) {
      const int r = e / SLAB;
      const float s = quant_scale(__uint_as_float(__ldcg(&a.amax[r * n_tiles + c0 / a.tile])));
      a.hq[(long long)r * F + c0 + e % SLAB] = (int8_t)quant_fast(h[e], s, __frcp_rn(s));
    }
  }
  stamp(a, 6);
  grid.sync();
  stamp(a, 7);

  // ── down-projection, one f32 part per tile, + residual: x_out ──
  if (it < n_items && (items[it] >> 24) == 2) {
    // one round trip: the quantized hidden, its scales, the items' x2 columns
    const int w16 = F / 16;
    const int4* hsrc = reinterpret_cast<const int4*>(a.hq);
#pragma unroll 8
    for (int i = tid; i < b * w16; i += nt) {
      const int r = i / w16, c = i - r * w16;
      *reinterpret_cast<int4*>(act + r * a.lda + 16 * c) = __ldcg(hsrc + (long long)r * w16 + c);
    }
    for (int i = tid; i < b * n_tiles; i += nt) {
      sc[i] = quant_scale(__uint_as_float(__ldcg(&a.amax[i])));
    }
    for (int i = it; i < n_items && (items[i] >> 24) == 2; ++i) {
      const int c0 = SLAB * (items[i] & 0xffffff);
      for (int e = tid; e < b * SLAB / 4; e += nt) {
        const int r = e / (SLAB / 4), c = 4 * (e % (SLAB / 4));
        *reinterpret_cast<float4*>(cols + (i * b + r) * SLAB + c) =
            __ldcg(reinterpret_cast<const float4*>(a.x2 + (long long)r * d + c0 + c));
      }
    }
    __syncthreads();
  }
  stamp(a, 8);
  {
    const int per_tile = a.tile / a.kc;
    for (; it < n_items && (items[it] >> 24) == 2; ++it) {
      for (int j = 0; j < F / a.kc; ++j) {
        const uint32_t t = wait_tile(a, rg);
        tile_mma<MT>(t, a.kc, act_s, a.lda, b, j * a.kc, acc);
        release_tile(a, m, rg);
        if ((j + 1) % per_tile == 0) {   // the end of a d_ff tile
          const int tt = j / per_tile;
          acc_to_red<MT>(acc, red, b);
          __syncthreads();
          for (int e = tid; e < b * SLAB; e += nt) {
            const int k = (e / SLAB) * RED_ROW + e % SLAB;
            const float dt = __fmul_rn(__int2float_rn(red[k]), sc[(e / SLAB) * n_tiles + tt]);
            dacc[e] = tt == 0 ? dt : __fadd_rn(dacc[e], dt);
            red[k] = 0;
          }
          __syncthreads();
        }
      }
      const int c0 = SLAB * (items[it] & 0xffffff);
      for (int e = tid; e < b * SLAB; e += nt) {
        const int r = e / SLAB, c = e % SLAB;
        a.x_out[(long long)r * d + c0 + c] =
            __fadd_rn(cols[(it * b + r) * SLAB + c], __fmul_rn(dacc[e], vec[it * 2 * SLAB + c]));
      }
      __syncthreads();
    }
  }
  stamp(a, 9);

  if (a.Q > 0) {
    grid.sync();
    stamp(a, 10);
    // ── the next layer's RMSNorm + qkv ──
    if (it < n_items && (items[it] >> 24) == 3) {
      quant_rows(a.x_out, b, d, reinterpret_cast<const char*>(a.nw) + (long long)a.nxt * d * esz,
                 a.norm_kind, a.eps, act, a.lda, sc, scratch);
    }
    for (; it < n_items && (items[it] >> 24) == 3; ++it) {
      const int c0 = SLAB * (items[it] & 0xffffff);
      for (int j = 0; j < d / a.kc; ++j) {
        const uint32_t t = wait_tile(a, rg);
        tile_mma<MT>(t, a.kc, act_s, a.lda, b, j * a.kc, acc);
        release_tile(a, m, rg);
      }
      acc_to_red<MT>(acc, red, b);
      __syncthreads();
      for (int e = tid; e < b * SLAB; e += nt) {
        const int r = e / SLAB, c = e % SLAB, k = r * RED_ROW + c;
        a.qkv_out[(long long)r * a.Q + c0 + c] =
            __fmul_rn(__fmul_rn(__int2float_rn(red[k]), sc[r]), vec[it * 2 * SLAB + c]);
        red[k] = 0;
      }
      __syncthreads();
    }
  }
  stamp(a, 11);
}

bool shapes_ok(int b, int d_attn, int d, int F, int tile, int Q) {
  return b >= 1 && b <= MAX_B && d_attn >= 32 && d_attn % 32 == 0 && d_attn <= MAX_D &&
         d >= 32 && d % 32 == 0 && d <= MAX_D && F >= 32 &&
         F % 32 == 0 && tile >= 32 && tile % 32 == 0 && F % tile == 0 && Q >= 0 && Q % 32 == 0 &&
         F < (1 << 24) && Q < (1 << 24);
}

}  // namespace

extern "C" long long vt_tail_swiglu_workspace(int b, int d, int F, int tile) {
  if (b < 1 || d < 1 || F < 1 || tile < 1 || F % tile) return -1;
  auto a256 = [](long long n) { return (n + 255) / 256 * 256; };
  return a256((long long)b * d * 4) + a256((long long)b * F) + a256((long long)b * (F / tile) * 4) +
         256;
}

// The shared bytes of a launch; -1 for a plan the kernel does not take.
extern "C" int vt_tail_swiglu_smem(int b, int d_attn, int d, int F, int tile, int max_gu,
                                   int max_items, int stages, int kc) {
  if (!shapes_ok(b, d_attn, d, F, tile, 0) || stages < 1 || stages > MAX_STAGES || kc < 32 ||
      kc % 32 || d_attn % kc || d % kc || tile % kc || max_gu < 0 || max_items < max_gu) {
    return -1;
  }
  int lda = d_attn > d ? d_attn : d;
  lda = (F > lda ? F : lda) + 16;
  return layout(b, b > 16 ? 2 : 1, lda, d, max_gu, max_items, F / tile, stages, kc).total;
}

// B8a (nw == wq == sq == null, Q = 0) and B2, one launch of `grid` blocks.
// plan: the item table (ops/decode_dense.py tail_plan, on the device); kc,
// stages, max_gu, max_items, gu_blocks and smem: its tile rows, ring depth,
// gate | up items and items a block at most, blocks with gate | up items and
// shared bytes (checked against vt_tail_swiglu_smem). stamps: null, or [grid, 12] u64 for the
// %globaltimer ns at each phase point (the entry, the end of each product,
// after each grid barrier and norm), then [grid, 64] for the ns at which
// each of a block's first 64 tiles was ready. Every pointer but x_out, qkv_out, ws,
// plan and stamps starts on a 16-byte boundary.
extern "C" int vt_tail_swiglu_qkv_int8(
    const void* attn, const void* x, int x_kind, const void* wo, const void* wos, const void* mw,
    const void* wgu, const void* sgu, const void* wd, const void* sd, const void* nw,
    const void* wq, const void* sq, int norm_kind, int layer, int L, int b, int d_attn, int d,
    int F, int tile, int Q, float eps, void* x_out, void* qkv_out, void* ws, long long ws_bytes,
    const void* plan, int grid, int kc, int stages, int max_gu, int max_items, int gu_blocks,
    int smem, void* stamps, void* stream) {
  if (!shapes_ok(b, d_attn, d, F, tile, Q) || layer < 0 || layer >= L || grid < 1 ||
      norm_kind == KIND_NONE || x_kind == KIND_NONE || (Q != 0) != (wq != nullptr) ||
      (Q != 0) != (qkv_out != nullptr) || plan == nullptr || gu_blocks < 1 || gu_blocks > grid ||
      smem != vt_tail_swiglu_smem(b, d_attn, d, F, tile, max_gu, max_items, stages, kc) ||
      smem > SMEM_MAX || ws_bytes < vt_tail_swiglu_workspace(b, d, F, tile)) {
    return (int)cudaErrorInvalidValue;
  }
  const void* aligned[] = {attn, x, wo, wos, mw, wgu, sgu, wd, sd, nw, wq, sq};
  for (const void* q : aligned) {
    if ((uintptr_t)q % 16 != 0) return (int)cudaErrorMisalignedAddress;
  }
  TailArgs a;
  a.attn = (const float*)attn;
  a.x = x;
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
  a.plan = (const int*)plan;
  char* p = (char*)ws;
  a.x2 = (float*)p;
  p += ((long long)b * d * 4 + 255) / 256 * 256;
  a.hq = (int8_t*)p;
  p += ((long long)b * F + 255) / 256 * 256;
  a.amax = (unsigned*)p;
  p += ((long long)b * (F / tile) * 4 + 255) / 256 * 256;
  a.normed = (unsigned*)p;
  a.stamps = (unsigned long long*)stamps;
  a.x_kind = x_kind;
  a.norm_kind = norm_kind;
  a.layer = layer;
  a.nxt = layer + 1 < L ? layer + 1 : L - 1;
  a.b = b;
  a.d_attn = d_attn;
  a.d = d;
  a.F = F;
  a.tile = tile;
  a.Q = Q;
  a.kc = kc;
  a.stages = stages;
  int lda = d_attn > d ? d_attn : d;
  a.lda = (F > lda ? F : lda) + 16;
  a.max_gu = max_gu;
  a.max_items = max_items;
  a.gu_blocks = gu_blocks;
  a.eps = eps;
  Maps maps;
  const int rows = kc < BOX_ROWS ? kc : BOX_ROWS;
  int rc = weight_map(wo, L, d_attn, d, rows, &maps.wo);
  if (rc == 0) rc = weight_map(wgu, L, d, 2 * F, rows, &maps.wgu);
  if (rc == 0) rc = weight_map(wd, L, F, d, rows, &maps.wd);
  if (rc == 0) rc = Q ? weight_map(wq, L, d, Q, rows, &maps.wq) : 0;
  if (rc) return rc;
  if (!Q) maps.wq = maps.wo;   // not read
  const void* fn = b > 16 ? (const void*)tail_swiglu_kernel<2> : (const void*)tail_swiglu_kernel<1>;
  // the largest dynamic shared size, allowed once per body and device
  static int allowed[2][64];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  int& ok = allowed[b > 16][dev & 63];
  if (!ok) {
    e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
    if (e != cudaSuccess) return (int)e;
    ok = 1;
  }
  void* params[] = {&a, &maps};
  e = cudaLaunchCooperativeKernel(fn, dim3(grid), dim3(b > 16 ? threads<2>() : threads<1>()),
                                  params, (size_t)smem, (cudaStream_t)stream);
  if (e != cudaSuccess) {
    cudaGetLastError();  // a refused launch leaves no sticky error; clear the last one
    return (int)e;
  }
  return (int)cudaGetLastError();
}
