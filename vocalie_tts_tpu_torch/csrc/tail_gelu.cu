// B9b (the GPT-2 layer tail + the NEXT layer's LayerNorm and qkv) as ONE
// cooperative, persistent launch whose int8 weights stream into shared
// memory ahead of its grid barriers and are multiplied on the int8 tensor
// cores: B2's body (tail_swiglu.cu) with the GELU MLP, the LayerNorms and the
// biases, and the down-projection split over its d_ff tiles.
//
// Replaces, in vocalie_tts_tpu/ops/decode_dense.py:
//   B9b tail_gelu_qkv_int8_stacked  (def :985, pallas_call :1084)
//   B9c tail_gelu_int8_stacked      (def :752, pallas_call :811), the Q = 0
//       branch: the same body without the next layer's LayerNorm + qkv (as
//       B8a is to B2)
//   B9d mlp_gelu_int8_stacked       (def :862, pallas_call :898), the MLP
//       branch (template MLP): no o-projection, no LayerNorm, no residual
//       and no proj bias (see "B9d" below)
// The math is the plain versions' in ops/decode_dense.py
// (tail_gelu_qkv_int8_plain, tail_gelu_int8_plain), step for step:
//   x2   = x + ((float(q(attn) . Wo[l]) * as) * wos + bo)
//   u    = (float(q(ln(x2, lg[l], lb[l])) . Wu[l]) * hs) * su + bu
//   h    = u * (0.5 * (1 + tanhf(sqrt(2/pi) * (u + 0.044715 * (u * u) * u))))
//          quantized per (row, d_ff tile)
//   out  = (x2 + (sum over tiles, in order, of float(h_t . Wd_t) * s_t) * sd) + bd
//   qkv  = (float(q(ln(out, ng[nxt], nb[nxt])) . Wq[nxt]) * xs) * sq, nxt = min(l+1, L-1)
// with int8 x int8 summed in int32 (exact in any order), every f32 step an
// IEEE intrinsic, each LayerNorm's mean and centred variance summed in
// double and rounded once, the quantizer's IEEE divide with floor 1e-8: the
// outputs are bit-equal to the plain versions' and to the old chain's
// (vt_tail_gelu_int8 in decode_dense.cu, which still runs the shapes this
// body does not take).
//
// Bound: bytes. Each weight byte serves b multiply-adds. At the XTTS layer
// (b 8, d 1024, d_ff 4096, qkv 3072) a call reads 12.6 MB of weights (3.8 us
// at 3.35 TB/s).
//
// Design (B2's, tail_swiglu.cu): one block per SM (cudaLaunchCooperativeKernel), 512
// threads (256 for b > 16); grid barriers after x2 (the MLP LayerNorm),
// after the hidden's per-(row, tile) amax, after the quantized hidden, after
// x_out (the next LayerNorm; not for B9c); every block owns whole output
// columns in 32-column slabs (items), dealt by bytes, largest first, to the least loaded
// block (ops/decode_dense.py tail_plan with mlp="gelu"); weight tiles by TMA
// into an mbarrier ring that runs ahead across the barriers (only the
// o-projection's tiles until barrier 1, the rest once every fc block has read
// its rows); every block recomputes each LayerNorm row from L2; products by
// mma.sync m16n8k32 s8 (int8_stream.cuh). What differs:
//   * the down-projection's items are (slab, d_ff tile) pairs, so that it
//     spans d / 32 x n_tiles blocks (64 at the XTTS layer, not 32): a tile's
//     block writes its f32 part float(h_t . Wd_t) * s_t to device memory and
//     raises a flag; the slab's tile-0 block adds the parts in tile order
//     and writes x_out. Every block streams the parts of later tiles first,
//     so a tile-0 block waits only on blocks that never wait;
//   * the fc item is one slab (no gate | up pair); its epilogue adds the bias
//     and takes the tanh-GELU; both LayerNorms run in quant_rows_ln.
// Also tried, and taken out again: each LayerNorm row computed once and
// published (block r < b normalizes row r, the others copy the int8 rows),
// and a producer warp that alone asks TMA for tiles (the grid barriers then
// counters the consumers take). Neither moved the call's time in the trace
// (39.4-40.8 us against 38.6-39.7 for this body), which the weight stream's
// arrival sets (the fc tiles land ~15 us in, the down tiles ~25), so the
// simpler body stays.
// vocalie_tts_tpu_torch/tools/tail_swiglu_trace.py reads the card's clock at
// each phase point (the `stamps` argument).
//
// B9d (the GELU MLP alone, JAX _mlp_gelu_kernel :829-858) is the same body
// with the o-projection taken out (ops/decode_dense.py tail_plan with
// mlp="gelu_mlp": no product-0 items):
//   u    = (float(q(x) . Wu[l]) * xs) * su + bu, x the post-norm rows
//   out  = (sum over tiles, in order, of float(q_t(gelu(u)) . Wd_t) * s_t) * sd
// Every block streams its tiles from its first instruction (its fc items
// first); an fc block quantizes the rows of x itself (an amax and a divide,
// no norm) in place of the o-projection and barrier 1. There is no barrier
// before the fc items, so nothing device-wide can be zeroed for them: the
// hidden's amax is written per (row, fc slab), each word once, and every
// block takes the max of a (row, tile)'s slabs after barrier 2. Then the
// quantized-hidden barrier and the down items, (slab, d_ff tile) pairs met in
// tile order by the slab's tile-0 block as in B9c; the output is acc * sd
// (the proj bias is the caller's add, as in JAX).

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
constexpr int MAX_D = 2048;   // the widest normed row (quant_rows_ln splits it over warps)
constexpr int SMEM_MAX = 232448;
constexpr int VEC_BYTES = 2 * SLAB * 4;   // an item's column scales, then its bias columns
constexpr int COL_ROW = SLAB * 4;         // bytes of one row of an item's residual columns

#define GELU_C 0x1.988454p-1f   // float32(sqrt(2 / pi)), as JAX rounds it
#define GELU_A 0x1.6e4e26p-5f   // float32(0.044715)

__device__ __forceinline__ float gelu_tanh(float u) {
  const float u3 = __fmul_rn(__fmul_rn(u, u), u);
  const float t = tanhf(__fmul_rn(GELU_C, __fadd_rn(u, __fmul_rn(GELU_A, u3))));
  return __fmul_rn(u, __fmul_rn(0.5f, __fadd_rn(1.0f, t)));
}

struct GeluArgs {
  const float* attn;   // [b, d_attn]
  const void* x;       // [b, d] (x_kind)
  const int8_t* wo;    // [L, d_attn, d]
  const float* wos;    // [L, d]
  const void* bo;      // [L, d] (bias_kind)
  const void* lg;      // [L, d] (norm_kind)
  const void* lb;      // [L, d] (norm_kind)
  const int8_t* wu;    // [L, d, F]
  const float* su;     // [L, F]
  const void* bu;      // [L, F] (bias_kind)
  const int8_t* wd;    // [L, F, d]
  const float* sd;     // [L, d]
  const void* bd;      // [L, d] (bias_kind)
  const void* ng;      // [L, d] (norm_kind)
  const void* nb;      // [L, d] (norm_kind)
  const int8_t* wq;    // [L, d, Q]
  const float* sq;     // [L, Q]
  float* x_out;        // [b, d]
  float* qkv_out;      // [b, Q]
  const int* plan;     // [grid + 1] item offsets, then the items (product << 24 | slab)
  float* x2;           // [b, d]        workspace
  int8_t* hq;          // [b, F]
  unsigned* amax;      // [b, F / tile] float bits
  unsigned* normed;    // the blocks past the MLP LayerNorm
  float* part;         // [F / tile, b, d] the down-projection's per-tile f32 parts
  unsigned* flags;     // [F / tile, d / 32] a part has landed
  unsigned long long* stamps;  // [grid, TAIL_STAMPS] %globaltimer at each phase point, or null
  int x_kind, bias_kind, norm_kind, layer, nxt, b, d_attn, d, F, tile, Q;
  int kc, stages, lda, max_fc, max_items, fc_blocks;
  float eps;
};

// shared memory, in order: the ring, the int8 activations, the int32 sums,
// the fc items' hidden, the down-projection's f32 sum, row scales, the MLP
// LayerNorm's gain and bias, each item's column scales and bias, its
// residual columns, the row quantizer's scratch, the stages' mbarriers
struct Layout {
  int ring, act, red, hid, dacc, sc, nvec, vec, cols, scratch, bars, total;
};

__host__ __device__ inline int align16(int n) { return (n + 15) / 16 * 16; }

__host__ __device__ inline Layout layout(int b, int mt, int lda, int d, int max_fc,
                                         int max_items, int n_tiles, int stages, int kc) {
  Layout o;
  o.ring = 0;
  o.act = stages * kc * SLAB;
  o.red = o.act + align16(b * lda);
  o.hid = o.red + align16(16 * mt * RED_ROW * 4);
  o.dacc = o.hid + align16(max_fc * b * SLAB * 4);
  o.sc = o.dacc + align16(b * SLAB * 4);
  o.nvec = o.sc + align16(4 * b * n_tiles);
  o.vec = o.nvec + 2 * align16(4 * d);
  o.cols = o.vec + max_items * VEC_BYTES;
  o.scratch = o.cols + max_items * b * COL_ROW;
  o.bars = o.scratch + QUANT_SCRATCH;
  o.total = o.bars + 8 * MAX_STAGES;
  return o;
}

// A down-projection item's slab and d_ff tile: the items of later tiles
// sort first (slab code (n_tiles - 1 - t) * d / 32 + slab).
__device__ __forceinline__ int down_tile(const GeluArgs& a, int code) {
  return a.F / a.tile - 1 - (code & 0xffffff) / (a.d / SLAB);
}
__device__ __forceinline__ int down_slab(const GeluArgs& a, int code) {
  return (code & 0xffffff) % (a.d / SLAB);
}

__device__ __forceinline__ int item_tiles(const GeluArgs& a, int code) {
  switch (code >> 24) {
    case 0: return a.d_attn / a.kc;
    case 2: return a.tile / a.kc;
    default: return a.d / a.kc;
  }
}

// the first output column of an item
__device__ __forceinline__ int item_col(const GeluArgs& a, int code) {
  return SLAB * ((code >> 24) == 2 ? down_slab(a, code) : (code & 0xffffff));
}

// The four weight arrays' tensor maps (tensor_map.cuh tile_map: one
// request a kc-row tile), kernel parameters in constant space.
struct Maps {
  CUtensorMap wo, wu, wd, wq;
};

// Requests tile j of an item into shared dst: its kc rows of the item's 32
// columns in one request, completing on bar, marked to leave L2 first.
__device__ __forceinline__ void tile_request(const GeluArgs& a, const Maps& m, int code, int j,
                                             uint32_t dst, uint32_t bar) {
  const int col = item_col(a, code);
  int row = j * a.kc, layer = a.layer;
  const CUtensorMap* map;
  switch (code >> 24) {
    case 0: map = &m.wo; break;
    case 1: map = &m.wu; break;
    case 2:
      map = &m.wd;
      row += down_tile(a, code) * a.tile;
      break;
    default:
      map = &m.wq;
      layer = a.nxt;
  }
  tma_load_tile<true>(dst, map, col, row, a.kc, layer, bar);
}

// The item's int32 sums over its tiles of kc rows (activation columns from
// kact), into red after the trailing barrier.
template <int MT>
__device__ __forceinline__ void item_sums(const GeluArgs& a, const Maps& m, TileRing& rg,
                                          int code, uint32_t act_s, int kact,
                                          int (&acc)[MT][4][4], int* red) {
  for (int j = 0; j < item_tiles(a, code); ++j) {
    const uint32_t t = wait_tile(a, rg);
    tile_mma<MT>(t, a.kc, act_s, a.lda, a.b, kact + j * a.kc, acc);
    release_tile(a, m, rg);
  }
  acc_to_red<MT>(acc, red, a.b);
  __syncthreads();
}

template <int MT, bool MLP>
__global__ void __launch_bounds__(threads<MT>(), 1)
    tail_gelu_kernel(GeluArgs a, const __grid_constant__ Maps m) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(1024) unsigned char smem[];
  const int b = a.b, d = a.d, F = a.F, tid = threadIdx.x, nt = threads<MT>();
  const int n_tiles = F / a.tile;
  const Layout lo = layout(b, MT, a.lda, d, a.max_fc, a.max_items, n_tiles, a.stages, a.kc);
  int8_t* act = reinterpret_cast<int8_t*>(smem + lo.act);
  int* red = reinterpret_cast<int*>(smem + lo.red);          // [16 MT][RED_ROW]
  float* hid = reinterpret_cast<float*>(smem + lo.hid);      // [max_fc][b][32]
  float* dacc = reinterpret_cast<float*>(smem + lo.dacc);    // [b][32]
  float* sc = reinterpret_cast<float*>(smem + lo.sc);        // row (or row, tile) scales
  const unsigned char* lgv = smem + lo.nvec;                 // lg[l], norm_kind
  const unsigned char* lbv = lgv + align16(4 * d);           // lb[l]
  const unsigned char* vec = smem + lo.vec;                  // [item]: 32 f32 scales, 32 biases
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
  const int bsz = a.bias_kind == KIND_BF16 ? 2 : 4;
  // the small inputs, in a group of their own ahead of the tiles: the MLP
  // LayerNorm's gain and bias, each item's column scales and bias, the
  // o-projection's residual columns (B9d: the fc's scales and bias, the
  // down-projection's scales)
  if constexpr (!MLP) {
    copy_async(smem_u32(lgv), reinterpret_cast<const char*>(a.lg) + (long long)a.layer * d * esz,
               d * esz);
    copy_async(smem_u32(lbv), reinterpret_cast<const char*>(a.lb) + (long long)a.layer * d * esz,
               d * esz);
  }
  for (int it = 0; it < n_items; ++it) {
    const int p = items[it] >> 24, c0 = item_col(a, items[it]);
    const float* s0 = p == 0   ? a.wos + (long long)a.layer * d + c0
                      : p == 1 ? a.su + (long long)a.layer * F + c0
                      : p == 2 ? a.sd + (long long)a.layer * d + c0
                               : a.sq + (long long)a.nxt * a.Q + c0;
    const uint32_t v = smem_u32(vec) + it * VEC_BYTES;
    if (tid < 8) cp_async16(v + 16 * tid, s0 + 4 * tid);
    if (p < (MLP ? 2 : 3)) {
      const char* b0 = reinterpret_cast<const char*>(p == 0 ? a.bo : p == 1 ? a.bu : a.bd) +
                       ((long long)a.layer * (p == 1 ? F : d) + c0) * bsz;
      if (tid >= 8 && tid < 8 + SLAB * bsz / 16) cp_async16(v + 128 + 16 * (tid - 8), b0 + 16 * (tid - 8));
    }
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
  // B9b/B9c: the o-projection's tiles, alone on the card until barrier 1;
  // B9d: every tile, each block's fc tiles first
  if (MLP) rg.cap = 3;
  fill(a, m, rg);

  for (int i = tid; i < 16 * MT * RED_ROW; i += nt) red[i] = 0;
  if (blockIdx.x == 0) {   // used after barrier 1 (B9d: after barrier 2)
    if (!MLP) {
      for (int i = tid; i < b * n_tiles; i += nt) a.amax[i] = 0u;
      if (tid == 0) *a.normed = 0u;
    }
    for (int i = tid; i < n_tiles * (d / SLAB); i += nt) a.flags[i] = 0u;
  }
  int it = 0;
  int acc[MT][4][4];
  zero_acc(acc);

  if constexpr (!MLP) {   // B9b, B9c
    // ── o-projection + bias + residual: x2 ──
    if (it < n_items && (items[it] >> 24) == 0) {
      quant_rows(a.attn, b, a.d_attn, nullptr, KIND_NONE, 0.0f, act, a.lda, sc, scratch);
      wait_first();   // the column scales, the biases and the residual columns
    }
    for (; it < n_items && (items[it] >> 24) == 0; ++it) {
      const int c0 = item_col(a, items[it]);
      item_sums<MT>(a, m, rg, items[it], act_s, 0, acc, red);
      const unsigned char* xr = reinterpret_cast<const unsigned char*>(cols + it * b * SLAB);
      const float* vs = reinterpret_cast<const float*>(vec + it * VEC_BYTES);
      const void* vb = vec + it * VEC_BYTES + 128;
      for (int e = tid; e < b * SLAB; e += nt) {
        const int r = e / SLAB, c = e % SLAB;
        const int k = r * RED_ROW + c;
        const float o = __fadd_rn(__fmul_rn(__fmul_rn(__int2float_rn(red[k]), sc[r]), vs[c]),
                                  load_f(vb, a.bias_kind, c));
        a.x2[(long long)r * d + c0 + c] = __fadd_rn(load_f(xr + r * COL_ROW, a.x_kind, c), o);
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
      // the rest of the stream once every fc block has read its rows through
      // L2 for the MLP LayerNorm (the stream would slow those reads down)
      if (tid == 0) {
        while (atomicAdd(a.normed, 0u) < (unsigned)a.fc_blocks) __nanosleep(256);
      }
      __syncthreads();
      fill(a, m, rg);
    }
  }

  // ── MLP LayerNorm (B9d: the rows as they are), fc + bias, tanh-GELU and
  // its amax per (row, tile) (B9d: per (row, slab)) ──
  const int fc_beg = it;
  if (it < n_items && (items[it] >> 24) == 1) {
    if constexpr (MLP) {
      if (a.x_kind == KIND_BF16) {
        quant_rows_n<false, __nv_bfloat16>(reinterpret_cast<const __nv_bfloat16*>(a.x), b, d,
                                            nullptr, nullptr, KIND_NONE, 0.0f, act, a.lda, sc,
                                            scratch);
      } else {
        quant_rows_n<false, float>(reinterpret_cast<const float*>(a.x), b, d, nullptr, nullptr,
                                   KIND_NONE, 0.0f, act, a.lda, sc, scratch);
      }
      wait_first();   // the fc's column scales and bias
    } else {
      quant_rows_ln(a.x2, b, d, lgv, lbv, a.norm_kind, a.eps, act, a.lda, sc, scratch);
      if (tid == 0) atomicAdd(a.normed, 1u);
      fill(a, m, rg);
    }
  }
  stamp(a, 3);
  for (int slot = 0; it < n_items && (items[it] >> 24) == 1; ++it, ++slot) {
    const int c0 = item_col(a, items[it]);
    item_sums<MT>(a, m, rg, items[it], act_s, 0, acc, red);
    float* h = hid + slot * b * SLAB;
    const float* vs = reinterpret_cast<const float*>(vec + it * VEC_BYTES);
    const void* vb = vec + it * VEC_BYTES + 128;
    for (int e = tid; e < b * SLAB; e += nt) {
      const int r = e / SLAB, c = e % SLAB, k = r * RED_ROW + c;
      const float u = __fadd_rn(__fmul_rn(__fmul_rn(__int2float_rn(red[k]), sc[r]), vs[c]),
                                load_f(vb, a.bias_kind, c));
      h[e] = gelu_tanh(u);
      red[k] = 0;
    }
    __syncthreads();
    // the item's 32 columns lie in one d_ff tile: one atomicMax a row
    // (B9d: the slab's max, stored)
    const int lane = tid & 31;
    for (int r = tid >> 5; r < b; r += nt >> 5) {
      float mx = fabsf(h[r * SLAB + lane]);
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      if (lane == 0) {
        if (MLP) __stcg(&a.amax[r * (F / SLAB) + c0 / SLAB], __float_as_uint(mx));
        else atomicMax(&a.amax[r * n_tiles + c0 / a.tile], __float_as_uint(mx));
      }
    }
  }
  stamp(a, 4);
  grid.sync();
  stamp(a, 5);
  if constexpr (MLP) {   // every (row, tile)'s scale from its slabs' maxima
    wait_first();   // the small inputs of the blocks without fc items
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
  for (int i = fc_beg, slot = 0; i < n_items && (items[i] >> 24) == 1; ++i, ++slot) {
    const int c0 = item_col(a, items[i]);
    const float* h = hid + slot * b * SLAB;
    for (int e = tid; e < b * SLAB; e += nt) {
      const int r = e / SLAB;
      const float s =
          MLP ? sc[r * n_tiles + c0 / a.tile]
              : quant_scale(__uint_as_float(__ldcg(&a.amax[r * n_tiles + c0 / a.tile])));
      a.hq[(long long)r * F + c0 + e % SLAB] = (int8_t)quant_fast(h[e], s, __frcp_rn(s));
    }
  }
  stamp(a, 6);
  grid.sync();
  stamp(a, 7);

  // ── down-projection, one item a (slab, d_ff tile): the tile's f32 part;
  // the slab's tile-0 item adds the parts in tile order, then residual and
  // bias: x_out ──
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
      if (down_tile(a, items[i]) != 0) continue;
      const int c0 = item_col(a, items[i]);
      for (int e = tid; e < b * SLAB / 4; e += nt) {
        const int r = e / (SLAB / 4), c = 4 * (e % (SLAB / 4));
        *reinterpret_cast<float4*>(cols + (i * b + r) * SLAB + c) =
            __ldcg(reinterpret_cast<const float4*>(a.x2 + (long long)r * d + c0 + c));
      }
    }
    __syncthreads();
  }
  stamp(a, 8);
  for (; it < n_items && (items[it] >> 24) == 2; ++it) {
    const int tt = down_tile(a, items[it]), slab = down_slab(a, items[it]), c0 = SLAB * slab;
    item_sums<MT>(a, m, rg, items[it], act_s, tt * a.tile, acc, red);
    if (tt != 0) {
      float* pt = a.part + (long long)tt * b * d;
      for (int e = tid; e < b * SLAB; e += nt) {
        const int r = e / SLAB, c = e % SLAB, k = r * RED_ROW + c;
        __stcg(pt + (long long)r * d + c0 + c,
               __fmul_rn(__int2float_rn(red[k]), sc[r * n_tiles + tt]));
        red[k] = 0;
      }
      __threadfence();
      __syncthreads();
      if (tid == 0) atomicAdd(&a.flags[tt * (d / SLAB) + slab], 1u);
      continue;
    }
    for (int e = tid; e < b * SLAB; e += nt) {
      const int r = e / SLAB, k = r * RED_ROW + e % SLAB;
      dacc[e] = __fmul_rn(__int2float_rn(red[k]), sc[r * n_tiles]);
      red[k] = 0;
    }
    for (int t2 = 1; t2 < n_tiles; ++t2) {
      if (tid == 0) {
        // (past ~2^26 polls, over a second, a fault in the plan traps)
        for (unsigned polls = 0; atomicAdd(&a.flags[t2 * (d / SLAB) + slab], 0u) == 0u; ++polls) {
          if (polls > (1u << 26)) __trap();
          __nanosleep(64);
        }
        __threadfence();
      }
      __syncthreads();
      const float* pt = a.part + (long long)t2 * b * d;
      for (int e = tid; e < b * SLAB; e += nt) {
        const int r = e / SLAB, c = e % SLAB;
        dacc[e] = __fadd_rn(dacc[e], __ldcg(pt + (long long)r * d + c0 + c));
      }
    }
    const float* vs = reinterpret_cast<const float*>(vec + it * VEC_BYTES);
    const void* vb = vec + it * VEC_BYTES + 128;
    for (int e = tid; e < b * SLAB; e += nt) {
      const int r = e / SLAB, c = e % SLAB;
      a.x_out[(long long)r * d + c0 + c] =
          MLP ? __fmul_rn(dacc[e], vs[c])
              : __fadd_rn(__fadd_rn(cols[(it * b + r) * SLAB + c], __fmul_rn(dacc[e], vs[c])),
                          load_f(vb, a.bias_kind, c));
    }
    __syncthreads();
  }
  stamp(a, 9);

  if (!MLP && a.Q > 0) {   // B9b; B9c and B9d end with x_out
    grid.sync();
    stamp(a, 10);
    // ── the next layer's LayerNorm + qkv ──
    if (it < n_items && (items[it] >> 24) == 3) {
      quant_rows_ln(a.x_out, b, d,
                    reinterpret_cast<const char*>(a.ng) + (long long)a.nxt * d * esz,
                    reinterpret_cast<const char*>(a.nb) + (long long)a.nxt * d * esz,
                    a.norm_kind, a.eps, act, a.lda, sc, scratch);
    }
    for (; it < n_items && (items[it] >> 24) == 3; ++it) {
      const int c0 = item_col(a, items[it]);
      item_sums<MT>(a, m, rg, items[it], act_s, 0, acc, red);
      const float* vs = reinterpret_cast<const float*>(vec + it * VEC_BYTES);
      for (int e = tid; e < b * SLAB; e += nt) {
        const int r = e / SLAB, c = e % SLAB, k = r * RED_ROW + c;
        a.qkv_out[(long long)r * a.Q + c0 + c] =
            __fmul_rn(__fmul_rn(__int2float_rn(red[k]), sc[r]), vs[c]);
        red[k] = 0;
      }
      __syncthreads();
    }
  }
  stamp(a, 11);
}

bool shapes_ok(int b, int d_attn, int d, int F, int tile, int Q) {
  return b >= 1 && b <= MAX_B && d_attn >= 32 && d_attn % 32 == 0 && d_attn <= MAX_D &&
         d >= 32 && d % 32 == 0 && d <= MAX_D && F >= 32 && F % 32 == 0 && tile >= 32 &&
         tile % 32 == 0 && F % tile == 0 && Q >= 0 && Q % 32 == 0 && F < (1 << 24) &&
         Q < (1 << 24) && (long long)(F / tile) * (d / SLAB) < (1 << 24);
}

long long a256(long long n) { return (n + 255) / 256 * 256; }

// B9d's workspace: the quantized hidden, its amax per (row, fc slab), the
// down-projection's parts and their flags
long long mlp_workspace(int b, int d, int F, int tile) {
  const long long n_tiles = F / tile;
  return a256((long long)b * F) + a256((long long)b * (F / SLAB) * 4) +
         a256(n_tiles * b * d * 4) + a256(n_tiles * (d / SLAB) * 4);
}

// One cooperative launch of the body on `grid` blocks, the largest dynamic
// shared size allowed once per body and device.
template <bool MLP>
int launch_gelu(GeluArgs& a, Maps& maps, int grid, int smem, cudaStream_t stream) {
  const bool wide = a.b > 16;
  const void* fn =
      wide ? (const void*)tail_gelu_kernel<2, MLP> : (const void*)tail_gelu_kernel<1, MLP>;
  static int allowed[2][64];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  int& ok = allowed[wide][dev & 63];
  if (!ok) {
    e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
    if (e != cudaSuccess) return (int)e;
    ok = 1;
  }
  void* params[] = {&a, &maps};
  e = cudaLaunchCooperativeKernel(fn, dim3(grid), dim3(wide ? threads<2>() : threads<1>()),
                                  params, (size_t)smem, stream);
  if (e != cudaSuccess) {
    cudaGetLastError();  // a refused launch leaves no sticky error; clear the last one
    return (int)e;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// x2, the quantized hidden, its amax, a counter, the down-projection's parts
// and their flags
extern "C" long long vt_tail_gelu_one_workspace(int b, int d, int F, int tile) {
  if (b < 1 || d < 1 || F < 1 || tile < 1 || F % tile) return -1;
  const long long n_tiles = F / tile;
  return a256((long long)b * d * 4) + a256((long long)b * F) + a256((long long)b * n_tiles * 4) +
         256 + a256(n_tiles * b * d * 4) + a256(n_tiles * (d / SLAB) * 4);
}

// The shared bytes of a launch; -1 for a plan the kernel does not take.
extern "C" int vt_tail_gelu_smem(int b, int d_attn, int d, int F, int tile, int max_fc,
                                 int max_items, int stages, int kc) {
  if (!shapes_ok(b, d_attn, d, F, tile, 0) || stages < 1 || stages > MAX_STAGES || kc < 32 ||
      kc % 32 || d_attn % kc || d % kc || tile % kc || max_fc < 0 || max_items < max_fc) {
    return -1;
  }
  int lda = d_attn > d ? d_attn : d;
  lda = (F > lda ? F : lda) + 16;
  return layout(b, b > 16 ? 2 : 1, lda, d, max_fc, max_items, F / tile, stages, kc).total;
}

// B9b (Q > 0), or B9c (Q = 0: ng, nb, wq, sq and qkv_out null; the tail
// alone, ending with x_out), one launch of `grid` blocks. plan: the item table (ops/decode_dense.py
// tail_plan with mlp="gelu", on the device); kc, stages, max_fc, max_items,
// fc_blocks and smem: its tile rows, ring depth, fc items and items a block
// at most, blocks with fc items and shared bytes (checked against
// vt_tail_gelu_smem). stamps: null, or [grid, 12 + 64] u64 as in
// vt_tail_swiglu_qkv_int8. bias_kind is the dtype of bo / bu / bd,
// norm_kind that of the LayerNorm gains and biases. Every pointer but
// x_out, qkv_out, ws, plan and stamps starts on a 16-byte boundary.
extern "C" int vt_tail_gelu_qkv_int8(
    const void* attn, const void* x, int x_kind, const void* wo, const void* wos, const void* bo,
    const void* lg, const void* lb, const void* wu, const void* su, const void* bu,
    const void* wd, const void* sd, const void* bd, int bias_kind, const void* ng,
    const void* nb, const void* wq, const void* sq, int norm_kind, int layer, int L, int b,
    int d_attn, int d, int F, int tile, int Q, float eps, void* x_out, void* qkv_out, void* ws,
    long long ws_bytes, const void* plan, int grid, int kc, int stages, int max_fc,
    int max_items, int fc_blocks, int smem, void* stamps, void* stream) {
  if (!shapes_ok(b, d_attn, d, F, tile, Q) || layer < 0 || layer >= L || grid < 1 ||
      norm_kind == KIND_NONE || x_kind == KIND_NONE || bias_kind == KIND_NONE ||
      (Q != 0) != (wq != nullptr) || (Q != 0) != (sq != nullptr) ||
      (Q != 0) != (qkv_out != nullptr) || (Q != 0) != (ng != nullptr) ||
      (Q != 0) != (nb != nullptr) || plan == nullptr || fc_blocks < 1 || fc_blocks > grid ||
      smem != vt_tail_gelu_smem(b, d_attn, d, F, tile, max_fc, max_items, stages, kc) ||
      smem > SMEM_MAX || ws_bytes < vt_tail_gelu_one_workspace(b, d, F, tile)) {
    return (int)cudaErrorInvalidValue;
  }
  const void* aligned[] = {attn, x, wo, wos, bo, lg, lb, wu, su, bu, wd, sd, bd, ng, nb, wq, sq};
  for (const void* q : aligned) {
    if ((uintptr_t)q % 16 != 0) return (int)cudaErrorMisalignedAddress;
  }
  GeluArgs a;
  a.attn = (const float*)attn;
  a.x = x;
  a.wo = (const int8_t*)wo;
  a.wos = (const float*)wos;
  a.bo = bo;
  a.lg = lg;
  a.lb = lb;
  a.wu = (const int8_t*)wu;
  a.su = (const float*)su;
  a.bu = bu;
  a.wd = (const int8_t*)wd;
  a.sd = (const float*)sd;
  a.bd = bd;
  a.ng = ng;
  a.nb = nb;
  a.wq = (const int8_t*)wq;
  a.sq = (const float*)sq;
  a.x_out = (float*)x_out;
  a.qkv_out = (float*)qkv_out;
  a.plan = (const int*)plan;
  const int n_tiles = F / tile;
  char* p = (char*)ws;
  a.x2 = (float*)p;
  p += a256((long long)b * d * 4);
  a.hq = (int8_t*)p;
  p += a256((long long)b * F);
  a.amax = (unsigned*)p;
  p += a256((long long)b * n_tiles * 4);
  a.normed = (unsigned*)p;
  p += 256;
  a.part = (float*)p;
  p += a256((long long)n_tiles * b * d * 4);
  a.flags = (unsigned*)p;
  a.stamps = (unsigned long long*)stamps;
  a.x_kind = x_kind;
  a.bias_kind = bias_kind;
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
  a.max_fc = max_fc;
  a.max_items = max_items;
  a.fc_blocks = fc_blocks;
  a.eps = eps;
  Maps maps;
  int rc = tile_map(wo, L, d_attn, d, kc, &maps.wo);
  if (rc == 0) rc = tile_map(wu, L, d, F, kc, &maps.wu);
  if (rc == 0) rc = tile_map(wd, L, F, d, kc, &maps.wd);
  if (rc == 0) rc = Q ? tile_map(wq, L, d, Q, kc, &maps.wq) : 0;
  if (rc) return rc;
  if (!Q) maps.wq = maps.wo;   // not read
  return launch_gelu<false>(a, maps, grid, smem, (cudaStream_t)stream);
}

// ── B9d: the GELU MLP alone, the body's MLP branch ───────────────────────

// The shared bytes of a B9d launch; -1 for a plan the kernel does not take.
extern "C" int vt_mlp_gelu_one_smem(int b, int d, int F, int tile, int max_fc, int max_items,
                                    int stages, int kc) {
  if (!shapes_ok(b, d, d, F, tile, 0) || stages < 1 || stages > MAX_STAGES || kc < 32 ||
      kc % 32 || d % kc || tile % kc || max_fc < 0 || max_items < max_fc) {
    return -1;
  }
  const int lda = (F > d ? F : d) + 16;
  return layout(b, b > 16 ? 2 : 1, lda, d, max_fc, max_items, F / tile, stages, kc).total;
}

// B9d, one launch of `grid` blocks: out = (sum over d_ff tiles t, in order,
// of float(q_t(gelu(u)) . Wd[l]_t) * s_t) * sd[l], u = (float(q(x) . Wu[l])
// * xs) * su[l] + bu[l]; x [b, d] the post-norm rows (x_kind), bu of
// bias_kind; no residual, and the proj bias is the caller's add. plan: the
// item table of tail_plan with mlp="gelu_mlp" (no o-projection items); kc,
// stages, max_fc, max_items and smem as vt_tail_gelu_qkv_int8's (smem
// checked against vt_mlp_gelu_one_smem). stamps: null, or [grid, 12 + 64]
// u64. Every pointer but out, ws, plan and stamps starts on a 16-byte
// boundary.
extern "C" int vt_mlp_gelu_one(const void* x, int x_kind, const void* wu, const void* su,
                               const void* bu, int bias_kind, const void* wd, const void* sd,
                               int layer, int L, int b, int d, int F, int tile, void* out,
                               void* ws, long long ws_bytes, const void* plan, int grid, int kc,
                               int stages, int max_fc, int max_items, int smem, void* stamps,
                               void* stream) {
  if (!shapes_ok(b, d, d, F, tile, 0) || layer < 0 || layer >= L || grid < 1 ||
      x_kind == KIND_NONE || bias_kind == KIND_NONE || plan == nullptr ||
      smem != vt_mlp_gelu_one_smem(b, d, F, tile, max_fc, max_items, stages, kc) ||
      smem > SMEM_MAX || ws_bytes < mlp_workspace(b, d, F, tile)) {
    return (int)cudaErrorInvalidValue;
  }
  const void* aligned[] = {x, wu, su, bu, wd, sd};
  for (const void* p : aligned) {
    if ((uintptr_t)p % 16 != 0) return (int)cudaErrorMisalignedAddress;
  }
  GeluArgs a = {};
  a.x = x;
  a.wu = (const int8_t*)wu;
  a.su = (const float*)su;
  a.bu = bu;
  a.wd = (const int8_t*)wd;
  a.sd = (const float*)sd;
  a.x_out = (float*)out;
  a.plan = (const int*)plan;
  const int n_tiles = F / tile;
  char* p = (char*)ws;
  a.hq = (int8_t*)p;
  p += a256((long long)b * F);
  a.amax = (unsigned*)p;
  p += a256((long long)b * (F / SLAB) * 4);
  a.part = (float*)p;
  p += a256((long long)n_tiles * b * d * 4);
  a.flags = (unsigned*)p;
  a.stamps = (unsigned long long*)stamps;
  a.x_kind = x_kind;
  a.bias_kind = bias_kind;
  a.norm_kind = KIND_NONE;
  a.layer = a.nxt = layer;
  a.b = b;
  a.d = d;
  a.F = F;
  a.tile = tile;
  a.kc = kc;
  a.stages = stages;
  a.lda = (F > d ? F : d) + 16;
  a.max_fc = max_fc;
  a.max_items = max_items;
  Maps maps;
  int rc = tile_map(wu, L, d, F, kc, &maps.wu);
  if (rc == 0) rc = tile_map(wd, L, F, d, kc, &maps.wd);
  if (rc) return rc;
  maps.wo = maps.wq = maps.wu;   // not read
  return launch_gelu<true>(a, maps, grid, smem, (cudaStream_t)stream);
}
