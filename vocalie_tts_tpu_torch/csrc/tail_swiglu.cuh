// The SwiGLU layer tail's body, shared by B2/B8a (tail_swiglu.cu) and B12
// (decode_layer.cu): from x2 = the residual after the o-projection, the MLP
// RMSNorm, gate | up, silu(g) * u quantized per (row, d_ff tile), the
// down-projection's parts summed in tile order, x_out, and (Q > 0) the next
// layer's RMSNorm + qkv. See tail_swiglu.cu for the design; this header
// holds the pieces both kernels run: the arguments, the shared-memory
// layout, the weight tiles' requests, the ring's set-up, the small inputs
// and everything after the o-projection (tail_after_x2). A kernel that
// includes it computes x2 its own way and then calls tail_after_x2, so the
// tail's arithmetic is one copy of code. With MLP (B8b, tail_swiglu.cu's
// mlp_swiglu_kernel) the same body runs the MLP alone on the rows of x: no
// x2, no norm, no residual and no barrier before gate | up.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "int8_stream.cuh"
#include "tensor_map.cuh"

namespace i8s {

constexpr int TAIL_MAX_B = 32;
constexpr int TAIL_MAX_D = 2048;   // the widest normed row (quant_rows splits it over warps)
constexpr int TAIL_SMEM_MAX = 232448;
constexpr int TAIL_VEC_BYTES = 2 * SLAB * 4;   // an item's column scales (gate and up for gate | up)
constexpr int TAIL_COL_ROW = SLAB * 4;         // bytes of one row of an item's residual columns

struct TailArgs {
  const float* attn;   // [b, d_attn] (B2's o-projection input; B12: unused)
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
  unsigned* amax;      // [b, F / tile] float bits (MLP: [b, F / 32], a gate | up slab's)
  unsigned* normed;    // the blocks past the MLP norm
  unsigned long long* stamps;  // [grid, TAIL_STAMPS] %globaltimer at each phase point, or null
  int x_kind, norm_kind, layer, nxt, b, d_attn, d, F, tile, Q;
  int kc, stages, lda, max_gu, max_items, gu_blocks;
  float eps;
};

// shared memory, in order: the ring, the int8 activations (at least
// act_min bytes), the int32 sums (gate | up), the items' hidden, the
// down-projection's f32 sum, row scales, each item's column scales and
// residual columns, the MLP norm's weights, the row quantizer's scratch,
// the stages' mbarriers, then n_abar more mbarriers (B12's attention slots,
// which lie between the ring's first stage and the column scales)
struct Layout {
  int ring, act, red, hid, dacc, sc, nvec, vec, cols, scratch, bars, abars, total;
};

__host__ __device__ inline int align16(int n) { return (n + 15) / 16 * 16; }

__host__ __device__ inline Layout layout(int b, int mt, int lda, int d, int max_gu,
                                         int max_items, int n_tiles, int stages, int kc,
                                         int act_min = 0, int n_abar = 0) {
  Layout o;
  o.ring = 0;
  o.act = stages * kc * SLAB;
  o.red = o.act + align16(b * lda > act_min ? b * lda : act_min);
  o.hid = o.red + align16(2 * 16 * mt * RED_ROW * 4);
  o.dacc = o.hid + align16(max_gu * b * SLAB * 4);
  o.sc = o.dacc + align16(b * SLAB * 4);
  o.vec = o.sc + align16(4 * b * (n_tiles > 1 ? n_tiles : 1));
  o.cols = o.vec + max_items * TAIL_VEC_BYTES;
  o.nvec = o.cols + max_items * b * TAIL_COL_ROW;
  o.scratch = o.nvec + align16(4 * d);
  o.bars = o.scratch + QUANT_SCRATCH;
  o.abars = o.bars + 8 * MAX_STAGES;
  o.total = o.abars + 8 * n_abar;
  return o;
}

// the activation row stride: b rows of the widest K, + 16 bytes against bank conflicts
__host__ __device__ inline int tail_lda(int d_attn, int d, int F) {
  const int lda = d_attn > d ? d_attn : d;
  return (F > lda ? F : lda) + 16;
}

__device__ __forceinline__ int item_tiles(const TailArgs& a, int code) {
  switch (code >> 24) {
    case 0: return a.d_attn / a.kc;
    case 1: return 2 * (a.d / a.kc);   // gate and up, alternating
    case 2: return a.F / a.kc;
    default: return a.d / a.kc;
  }
}

// The four weight arrays' tensor maps ([L, K, N] int8 seen as [L, K / R, R,
// N]: a box is one kc-row tile of 32 bytes a row), kernel parameters in
// constant space.
struct Maps {
  CUtensorMap wo, wgu, wd, wq;
};

// The maps of a launch (Q = 0: wq is not read, its map is wo's); 0 on success.
static inline int tail_maps(const void* wo, const void* wgu, const void* wd, const void* wq,
                            int L, int d_attn, int d, int F, int Q, int kc, Maps* maps) {
  int rc = tile_map(wo, L, d_attn, d, kc, &maps->wo);
  if (rc == 0) rc = tile_map(wgu, L, d, 2 * F, kc, &maps->wgu);
  if (rc == 0) rc = tile_map(wd, L, F, d, kc, &maps->wd);
  if (rc == 0) rc = Q ? tile_map(wq, L, d, Q, kc, &maps->wq) : 0;
  if (rc == 0 && !Q) maps->wq = maps->wo;   // not read
  return rc;
}

// Requests tile j of an item into shared dst: its kc rows of the item's 32
// columns in one request, completing on bar, marked to leave L2 first.
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
  tma_load_tile<true>(dst, map, col, row, a.kc, layer, bar);
}

// A block's view of its shared regions (layout)
struct TailSmem {
  int8_t* act;
  int* red;       // [2][16 MT][RED_ROW]
  int* red_u;
  float* hid;     // [max_gu][b][32]
  float* dacc;    // [b][32]
  float* sc;      // row (or row, tile) scales
  const unsigned char* nvec;   // mw[l], norm_kind
  const float* vec;            // [item][2][32]
  float* cols;                 // [item][b][32]
  void* scratch;
  uint32_t act_s;
};

template <int MT>
__device__ __forceinline__ TailSmem tail_smem(unsigned char* smem, const Layout& lo) {
  TailSmem s;
  s.act = reinterpret_cast<int8_t*>(smem + lo.act);
  s.red = reinterpret_cast<int*>(smem + lo.red);
  s.red_u = s.red + 16 * MT * RED_ROW;
  s.hid = reinterpret_cast<float*>(smem + lo.hid);
  s.dacc = reinterpret_cast<float*>(smem + lo.dacc);
  s.sc = reinterpret_cast<float*>(smem + lo.sc);
  s.nvec = smem + lo.nvec;
  s.vec = reinterpret_cast<const float*>(smem + lo.vec);
  s.cols = reinterpret_cast<float*>(smem + lo.cols);
  s.scratch = smem + lo.scratch;
  s.act_s = smem_u32(s.act);
  return s;
}

// The block's stream (its items of the plan) with the stages' mbarriers
// initialized; ends with __syncthreads().
__device__ __forceinline__ TileRing tail_ring(const TailArgs& a, unsigned char* smem,
                                              const Layout& lo) {
  const int beg = a.plan[blockIdx.x];
  TileRing rg;
  rg.items = a.plan + gridDim.x + 1 + beg;
  rg.n_items = a.plan[blockIdx.x + 1] - beg;
  rg.pi = rg.pj = rg.next = rg.groups = rg.cap = 0;
  rg.base = smem_u32(smem + lo.ring);
  rg.bars = smem_u32(smem + lo.bars);
  if (threadIdx.x == 0) {
    for (int s = 0; s < a.stages; ++s) mbar_init(rg.bars + 8 * s, 1);
    mbar_fence_init();
  }
  __syncthreads();
  return rg;
}

// The small inputs, one cp.async group: the MLP norm's weights (not with
// MLP: there is no norm), each item's column scales, the o-projection items'
// residual columns.
template <bool MLP = false>
__device__ __forceinline__ void tail_small_inputs(const TailArgs& a, const TailSmem& s,
                                                  const TileRing& rg) {
  const int b = a.b, d = a.d, F = a.F, tid = threadIdx.x, nt = blockDim.x;
  const int esz = a.norm_kind == KIND_BF16 ? 2 : 4;
  const int xsz = a.x_kind == KIND_BF16 ? 2 : 4;
  if constexpr (!MLP) {
    copy_async(smem_u32(s.nvec),
               reinterpret_cast<const char*>(a.mw) + (long long)a.layer * d * esz, d * esz);
  }
  for (int it = 0; it < rg.n_items; ++it) {
    const int p = rg.items[it] >> 24, c0 = SLAB * (rg.items[it] & 0xffffff);
    const float* s0 = p == 0   ? a.wos + (long long)a.layer * d + c0
                      : p == 1 ? a.sgu + (long long)a.layer * 2 * F + c0
                      : p == 2 ? a.sd + (long long)a.layer * d + c0
                               : a.sq + (long long)a.nxt * a.Q + c0;
    const uint32_t v = smem_u32(s.vec) + it * TAIL_VEC_BYTES;
    if (tid < 8) cp_async16(v + 16 * tid, s0 + 4 * tid);
    if (p == 1 && tid >= 8 && tid < 16) cp_async16(v + 16 * tid, s0 + F + 4 * (tid - 8));
    if (p == 0) {
      const int chunks = SLAB * xsz / 16;   // 16-byte chunks of a row's 32 columns
      for (int i = tid; i < b * chunks; i += nt) {
        const int r = i / chunks, c = i - r * chunks;
        cp_async16(smem_u32(s.cols) + (it * b + r) * TAIL_COL_ROW + 16 * c,
                   reinterpret_cast<const char*>(a.x) + ((long long)r * d + c0) * xsz + 16 * c);
      }
    }
  }
  cp_async_commit();   // group 0: the small inputs
}

// The int32 sums zeroed; block 0 zeroes the amax and the norm counter, used
// after barrier 1.
template <int MT>
__device__ __forceinline__ void tail_reset(const TailArgs& a, const TailSmem& s) {
  const int tid = threadIdx.x, nt = blockDim.x;
  for (int i = tid; i < 2 * 16 * MT * RED_ROW; i += nt) s.red[i] = 0;
  if (blockIdx.x == 0) {
    for (int i = tid; i < a.b * (a.F / a.tile); i += nt) a.amax[i] = 0u;
    if (tid == 0) *a.normed = 0u;
  }
}

// Everything after the o-projection: x2 is written by every block's
// o-projection items (it: the block's first item past them; acc zero).
// Barrier 1, the MLP RMSNorm, gate | up, silu(g) * u and its amax, barrier
// 2, the hidden quantized, barrier 3, the down-projection and x_out, then
// (Q > 0) barrier 4 and the next layer's RMSNorm + qkv.
// With MLP (B8b: no o-projection items, Q 0, every tile asked for at entry):
// no barrier 1; a gate | up block quantizes the rows of x as they are (bf16
// or f32, no norm). Nothing device-wide can be zeroed before gate | up, so
// the hidden's amax is stored once per (row, gate | up slab) and every block
// meets a (row, d_ff tile)'s slabs after barrier 2; x_out is the sum times
// sd, with no residual.
template <int MT, bool MLP = false>
__device__ __forceinline__ void tail_after_x2(const TailArgs& a, const Maps& m, TileRing& rg,
                                              const TailSmem& s, int it, int (&acc)[MT][4][4]) {
  namespace cg = cooperative_groups;
  cg::grid_group grid = cg::this_grid();
  const int b = a.b, d = a.d, F = a.F, tid = threadIdx.x, nt = threads<MT>();
  const int n_tiles = F / a.tile;
  const int* items = rg.items;
  const int n_items = rg.n_items;
  const int esz = a.norm_kind == KIND_BF16 ? 2 : 4;
  int8_t* act = s.act;
  int* red = s.red;
  int* red_u = s.red_u;
  float* hid = s.hid;
  float* dacc = s.dacc;
  float* sc = s.sc;
  const float* vec = s.vec;
  float* cols = s.cols;
  const uint32_t act_s = s.act_s;

  if constexpr (!MLP) {
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
  }

  // ── MLP RMSNorm (MLP: the rows of x as they are), gate | up, silu(g) * u
  // and its amax per (row, tile) (MLP: per (row, slab)) ──
  const int gu_beg = it;
  if (it < n_items && (items[it] >> 24) == 1) {
    if constexpr (MLP) {
      if (a.x_kind == KIND_BF16) {
        quant_rows_n<false, __nv_bfloat16>(reinterpret_cast<const __nv_bfloat16*>(a.x), b, d,
                                            nullptr, nullptr, KIND_NONE, 0.0f, act, a.lda, sc,
                                            s.scratch);
      } else {
        quant_rows_n<false, float>(reinterpret_cast<const float*>(a.x), b, d, nullptr, nullptr,
                                   KIND_NONE, 0.0f, act, a.lda, sc, s.scratch);
      }
      wait_first();   // the items' column scales
    } else {
      quant_rows(a.x2, b, d, s.nvec, a.norm_kind, a.eps, act, a.lda, sc, s.scratch);
      if (tid == 0) atomicAdd(a.normed, 1u);
      fill(a, m, rg);
    }
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
      // (MLP: the slab's max, stored)
      const int lane = tid & 31;
      for (int r = tid >> 5; r < b; r += nt >> 5) {
        float mx = fabsf(h[r * SLAB + lane]);
        for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
        if (lane == 0) {
          if constexpr (MLP) __stcg(&a.amax[r * (F / SLAB) + c0 / SLAB], __float_as_uint(mx));
          else atomicMax(&a.amax[r * n_tiles + c0 / a.tile], __float_as_uint(mx));
        }
      }
    }
  }
  stamp(a, 4);
  grid.sync();
  stamp(a, 5);
  if constexpr (MLP) {   // every (row, tile)'s scale from its slabs' maxima
    wait_first();   // the column scales of the blocks without gate | up items
    const int lane = tid & 31, spt = a.tile / SLAB;
    for (int i = tid >> 5; i < b * n_tiles; i += nt >> 5) {
      const unsigned* am = a.amax + (i / n_tiles) * (F / SLAB) + (i % n_tiles) * spt;
      float mx = 0.0f;
      for (int j = lane; j < spt; j += 32) mx = fmaxf(mx, __uint_as_float(__ldcg(am + j)));
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      if (lane == 0) sc[i] = quant_scale(mx);
    }
    __syncthreads();
  }

  // ── the hidden quantized per (row, tile) ──
  for (int i = gu_beg, slot = 0; i < n_items && (items[i] >> 24) == 1; ++i, ++slot) {
    const int c0 = SLAB * (items[i] & 0xffffff);
    const float* h = hid + slot * b * SLAB;
    for (int e = tid; e < b * SLAB; e += nt) {
      const int r = e / SLAB;
      const float sv =
          MLP ? sc[r * n_tiles + c0 / a.tile]
              : quant_scale(__uint_as_float(__ldcg(&a.amax[r * n_tiles + c0 / a.tile])));
      a.hq[(long long)r * F + c0 + e % SLAB] = (int8_t)quant_fast(h[e], sv, __frcp_rn(sv));
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
    for (int i = tid; i < b * n_tiles && !MLP; i += nt) {
      sc[i] = quant_scale(__uint_as_float(__ldcg(&a.amax[i])));
    }
    for (int i = it; i < n_items && (items[i] >> 24) == 2 && !MLP; ++i) {
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
        float* o = a.x_out + (long long)r * d + c0 + c;
        const float y = __fmul_rn(dacc[e], vec[it * 2 * SLAB + c]);
        if constexpr (MLP) *o = y;
        else *o = __fadd_rn(cols[(it * b + r) * SLAB + c], y);
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
                 a.norm_kind, a.eps, act, a.lda, sc, s.scratch);
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

// The largest dynamic shared size, allowed once per kernel and device.
static inline int allow_smem_once(const void* fn, int (&allowed)[64]) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  int& ok = allowed[dev & 63];
  if (!ok) {
    e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, TAIL_SMEM_MAX);
    if (e != cudaSuccess) return (int)e;
    ok = 1;
  }
  return 0;
}

}  // namespace i8s
