// The whole decode step at batch 1 -- every layer -- in ONE cooperative
// launch (kernel B7), its int8 weights and its cache streamed by TMA into a
// shared-memory ring that runs ahead across the layers.
//
// Replaces: vocalie_tts_tpu/ops/decode_step.py::decode_step_fused_packed
// (def :245, pallas_call :335). The math is theirs, step for step, for each
// layer l on the residual carried in f32 across all layers:
//   * attention over the whole cache of one head: q quantized per head (qs
//     = max(max|q| / 127, 1e-8)), s = (i32 * (qs * sm)) * ks + bias over all
//     T slots, the current token's column merged in f32, the probabilities
//     times the v scales quantized ONCE per head over all T (ps = max(max(p
//     * vs) / 127, 1e-20)), o = (o_v + p_new * v_new) / max(l_sum, 1e-30);
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
// int32, IEEE divides (the quantizers' by a multiply where no tie is near,
// int8_stream.cuh), no fused multiply-add, and the variance, the softmax sum
// and the current token's score summed in double and rounded to f32 once,
// so that the summation order does not show.
// The TPU kernel's head-stacked weight copy, selector matmuls and RoPE
// permutation dot are not carried over: the port reads the fused
// [L, d_model, 3*H*d] qkv weights and its split [L, 1, H, T, d] k and v.
//
// Bound: bytes. At the full CosyVoice shapes (24 layers, d_model 1024,
// d_ff 4096, 16 heads of 64) halfway through the streaming request (cache
// 640, 383 slots valid) one step needs 402.7 MB of int8 weights (16 MiB a
// layer), 18.8 MB of the valid slots' int8 k and v, 0.6 MB of their bf16
// scales and 1.8 MB of scales, norms, biases and rows: 423.9 MB, 0.127 ms at
// 3.35 TB/s. Every weight byte is used for one multiply-add (batch 1).
//
// Design. The first version of this kernel ran five grid barriers a layer, the
// attention on 16 blocks (one a head, four serial passes over the cache),
// the weights read by 4-byte __ldg after each barrier, and int32 split-K
// partials through device memory. Here one block per SM (512 threads) owns
// items of one layer, the same items in every layer (ops/decode_step.py
// step_plan, a pure function of the shape and the grid; the item table is
// uploaded once per shape):
//   * attention splits: a head's cache is split over S blocks of n slots (S
//     = 4 at the CosyVoice shape: 64 blocks); a split's k, v and their
//     scales are one tile of the block's stream (bulk copies);
//   * o-projection, gate | up and down slabs (32 columns over the full K),
//     and qkv items (one head's d columns of q, k or v: RoPE in-block).
// Every block streams its items' tiles, layer after layer, through a ring
// of `stages` stages (TMA boxes of 256 rows x 32 bytes, 32-byte swizzle, as
// B2's): the next phases' tiles, and the next layer's, are in flight while a
// block waits, so no phase starts cold on device memory. One warp of the
// block's 16 is the producer: it requests each tile once the 15 consumer
// warps have released its stage (a full and an empty mbarrier a stage).
// Asking the copy engine for a tile can hold the asking thread for as long
// as the engine takes to accept it (about a microsecond and a half a 32 KB
// tile in this kernel's trace when the consumers asked
// themselves): only the producer waits so. The consumers synchronize on a
// named barrier of their own. Products run on the int8 tensor
// cores (mma.sync m16n8k32, the batch row as A; int8_stream.cuh), each
// item's sums meeting in shared memory: no split-K partials in device
// memory. No grid barrier separates the phases: each dependency is a
// counter in device memory that the producing items raise (after a fence)
// and only the consuming blocks wait on:
//   the qkv items of head h (layer l - 1) -> its attention splits;
//   the S splits of a head meet twice: their score maxima, then their
//     probability sums and max p * vs (each split posts its values as
//     {layer + 1, value} words by release stores, and polls the others'
//     words: one round trip a meeting, no counter);
//   every split's int32 p8 . v -> the o-projection blocks, each of which
//     adds the splits, divides and quantizes o per head itself (1,024
//     values at the CosyVoice shape); every o-projection slab (x2) -> the MLP
//   norm and gate | up; every gate | up slab (the hidden and its amax) ->
//   down; every down slab (x_out) -> the next norm and the qkv.
// A consuming block prefetches its items' column scales and norm weights
// (cp.async) before it waits. One grid barrier at entry orders the
// counters' zeroing. The wrapper sets the shared-memory attribute and asks
// the occupancy once per device, not per call. The trace (`stamps`,
// tools/decode_step_trace.py) reads %globaltimer at 16 points of one layer.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "int8_stream.cuh"
#include "tensor_map.cuh"

namespace cg = cooperative_groups;
using namespace i8s;

namespace {

constexpr int NT = 512;           // threads a block: NC consumers, then one producer warp
constexpr int NC = NT - 32;
constexpr int NWARPS = NC / 32;   // consumer warps
constexpr int NQ_VEC = 8;         // float4s a consumer thread holds of a normed row
constexpr int MAX_DH = 128;
constexpr int MAX_H = 64;
constexpr int MAX_S = 64;         // attention splits a head at most
constexpr int SMEM_MAX = 232448;
constexpr int N_STAMPS = 34;
constexpr int VEC_ITEM = 1024;   // an item's column scales, then its biases (d <= 128)
constexpr int CNT_STRIDE = 32;   // words between counters (a 128-byte line each)

enum { ATT = 0, OPROJ = 1, GU = 2, DOWN = 3, QKV = 4 };
// counters: attention splits done, o-projection, gate | up and down slabs
// done, then per head its qkv items done
enum { C_ATT = 0, C_O = 1, C_GU = 2, C_DOWN = 3, C_HEAD = 4 };

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
  const float* wos;
  const void* mw;
  const float* sgu;
  const float* sd;
  const void* nw;
  const float* sq;
  const void* bq;
  const float* cos_f;
  const float* sin_f;
  float* x_out;
  float* kn_out;
  float* vn_out;
  const int* plan;   // [grid + 1] item offsets, then the items (kind << 24 | index)
  // workspace
  float* qbuf;       // [H, d] the next layer's q, after RoPE
  float* hsc;        // [H, 3] each head's ps, p_new and l_sum this layer
  float* x2;         // [D] after the o-projection
  float* xo;         // [D] out of the layer
  float* hbuf;       // [F] silu(g) * u
  float* hmax;       // [F / 32] its max |.| over each gate | up item's 32 columns
  unsigned long long* slots;  // [H, S, 4] each split's meeting values, {layer + 1, value}:
                              // its score max; its max p * vs and its probability sum
  int* opart;        // [H, S, d] their int32 p8 . v, which the o-projection blocks add
  unsigned* cnt;     // [C_HEAD + H] counters, CNT_STRIDE words apart
  unsigned long long* stamps;  // [grid, N_STAMPS] %globaltimer at the traced layer, then
                               // [grid, 2, 64] the requests and arrivals of 64 tiles from
                               // the layer before it, or null
  int trace_layer;
  int norm_kind, bq_kind;
  int L, H, T, d, D, F, S, n;
  int kc, stages, max_items;
  float sm_scale, eps;
};

// shared memory, in order: the ring, the int8 activations, the int32 sums
// (per head for the o-projection), the items' column scales and biases, the
// two norms' weights, the items' residual columns, the split's bias, its
// scores and int8 probabilities, the head's rows (q, k, v, qkv out), q int8,
// the int32 p8 . v, the head scales (and maxima), o of every head, the
// splits' meeting values, scalars, the row quantizer's scratch, the stages'
// mbarriers
struct Layout {
  int ring, act, red, vec, nvec, xcol, sbias, sbuf, p8, rows, q8, ov, hs, obuf, meet, scal,
      scratch, bars, total;
};

__host__ __device__ inline int align16(int n) { return (n + 15) / 16 * 16; }

__host__ __device__ inline Layout layout(int H, int d, int D, int F, int n, int max_items,
                                         int stages, int kc) {
  int widest = D > F ? D : F;
  if (H * d > widest) widest = H * d;
  Layout o;
  o.ring = 0;
  o.act = stages * kc * SLAB;
  o.red = o.act + align16(widest + 16);
  o.vec = o.red + align16((H > 2 ? H : 2) * SLAB * 4);
  o.nvec = o.vec + max_items * VEC_ITEM;
  o.xcol = o.nvec + 2 * align16(4 * D);
  o.sbias = o.xcol + max_items * SLAB * 4;
  o.sbuf = o.sbias + align16(4 * n);
  o.p8 = o.sbuf + align16(4 * n);
  o.rows = o.p8 + align16(n);
  o.q8 = o.rows + 4 * MAX_DH * 4;
  o.ov = o.q8 + MAX_DH;
  o.hs = o.ov + MAX_DH * 4;
  o.obuf = o.hs + MAX_H * 4;
  o.meet = o.obuf + align16(4 * H * d);
  o.scal = o.meet + 3 * MAX_S * 4;
  o.scratch = o.scal + 64;
  o.bars = o.scratch + QUANT_SCRATCH;
  o.total = o.bars + 16 * MAX_STAGES;   // full, then empty
  return o;
}

// The four weight arrays' tensor maps (tensor_map.cuh tile_map: one
// request a kc-row tile), kernel parameters in constant space.
struct Maps {
  CUtensorMap wo, wgu, wd, wq;
};

__device__ __forceinline__ int item_tiles(const StepArgs& a, int code) {
  switch (code >> 24) {
    case ATT: return 1;
    case OPROJ: return a.H * a.d / a.kc;
    case GU: return 2 * (a.D / a.kc);   // gate and up, alternating
    case DOWN: return a.F / a.kc;
    default: return (a.d / SLAB) * (a.D / a.kc);
  }
}

// Requests tile j of an item of layer l into shared dst, completing on bar:
// an attention split's k, v, k-scale and v-scale rows by bulk copies; a
// weight tile (kc rows of 32 columns) by one TMA request, not marked to
// leave L2 first (marked, B7 ran ~1 % slower: PERF.md §6).
__device__ __forceinline__ void tile_request(const StepArgs& a, const Maps& m, int code, int j,
                                             int l, uint32_t dst, uint32_t bar) {
  const int kind = code >> 24, idx = code & 0xffffff;
  if (kind == ATT) {
    const long long row = ((long long)l * a.H + idx / a.S) * a.T + (long long)(idx % a.S) * a.n;
    const int nd = a.n * a.d;
    mbar_expect_tx(bar, a.n * (2 * a.d + 4));
    bulk_load(dst, a.k_all + row * a.d, nd, bar);
    bulk_load(dst + nd, a.v_all + row * a.d, nd, bar);
    bulk_load(dst + 2 * nd, a.ks_all + row, 2 * a.n, bar);
    bulk_load(dst + 2 * nd + 2 * a.n, a.vs_all + row, 2 * a.n, bar);
    return;
  }
  int col = SLAB * idx, row = j * a.kc, layer = l;
  const CUtensorMap* map;
  switch (kind) {
    case OPROJ: map = &m.wo; break;
    case GU:
      map = &m.wgu;
      row = (j >> 1) * a.kc;
      col += (j & 1) * a.F;
      break;
    case DOWN: map = &m.wd; break;
    default: {   // qkv item idx = r * H + h: columns idx * d + [0, d), slab by slab
      const int per = a.D / a.kc;
      map = &m.wq;
      layer = l + 1 < a.L ? l + 1 : a.L - 1;
      col = idx * a.d + SLAB * (j / per);
      row = (j % per) * a.kc;
    }
  }
  tma_load_tile<false>(dst, map, col, row, a.kc, layer, bar);
}

// The block's stream: layer after layer, its items in order, their tiles in
// order, through `stages` stages. The producer warp's lane 0 requests tile g
// into stage g % stages once the consumers have released tile g - stages
// (the stage's `empty` mbarrier); the consumers wait on its `full` mbarrier,
// whose phase k completes when tile s + k stages has landed. A request can
// stall its thread until the copy engine takes it: only the producer
// waits so, never the warps that compute.
struct Ring {
  int next;     // tiles consumed
  int traced;   // the first of the 64 tiles whose request and arrival the trace records
  uint32_t base, full, empty;
};

constexpr int N_TILE_STAMPS = 64;

// the clock at a tile's request (k 0) or when the consumers had it (k 1),
// for the traced tiles (one thread calls)
__device__ __forceinline__ void tile_stamp(const StepArgs& a, const Ring& rg, int idx, int k) {
  const int j = idx - rg.traced;
  if (a.stamps != nullptr && j >= 0 && j < N_TILE_STAMPS) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    a.stamps[gridDim.x * N_STAMPS + (2 * blockIdx.x + k) * N_TILE_STAMPS + j] = t;
  }
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(bar) : "memory");
}

// The producer warp's lane 0: requests every tile of the block's stream, in
// order (layer pl, item pi, tile pj of the item), each once the consumers
// have released its stage's previous tile.
__device__ __forceinline__ void produce(const StepArgs& a, const Maps& m, const int* items,
                                        int n_items, const Ring& rg) {
  int pl = 0, pi = 0, pj = 0;
  for (int g = 0; pl < a.L && n_items > 0; ++g) {
    const int s = g % a.stages;
    if (g >= a.stages) mbar_wait(rg.empty + 8 * s, ((g / a.stages) - 1) & 1);
    tile_stamp(a, rg, g, 0);
    const int code = items[pi];
    tile_request(a, m, code, pj, pl, rg.base + s * a.kc * SLAB, rg.full + 8 * s);
    if (++pj == item_tiles(a, code)) {
      pj = 0;
      if (++pi == n_items) {
        pi = 0;
        ++pl;
      }
    }
  }
}

// the consumers' barrier (named barrier 1; the producer warp is not in it)
__device__ __forceinline__ void csync() {
  asm volatile("bar.sync 1, %0;\n" :: "n"(NC) : "memory");
}

__device__ __forceinline__ uint32_t wait_tile(const StepArgs& a, Ring& rg) {
  const int s = rg.next % a.stages;
  mbar_wait(rg.full + 8 * s, (rg.next / a.stages) & 1);
  if (threadIdx.x == 0) tile_stamp(a, rg, rg.next, 1);
  return rg.base + s * a.kc * SLAB;
}

// Every consumer warp has read the tile: its stage goes back to the producer.
__device__ __forceinline__ void release_tile(const StepArgs& a, Ring& rg) {
  csync();
  if (threadIdx.x == 0) mbar_arrive(rg.empty + 8 * (rg.next % a.stages));
  ++rg.next;
}

__device__ __forceinline__ void stamp(const StepArgs& a, int l, int i) {
  if (a.stamps != nullptr && l == a.trace_layer && threadIdx.x == 0) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    a.stamps[blockIdx.x * N_STAMPS + i] = t;
  }
}

__device__ __forceinline__ unsigned* counter(const StepArgs& a, int i) {
  return a.cnt + (long long)i * CNT_STRIDE;
}

// The block's writes are done: raise counter c (a release add at gpu scope,
// after the consumers' barrier, orders them before the count).
__device__ __forceinline__ void arrive(unsigned* c) {
  csync();
  if (threadIdx.x == 0) asm volatile("red.release.gpu.global.add.u32 [%0], 1;\n" :: "l"(c) : "memory");
}

// Waits until counter c reaches target (an acquire load at gpu scope); what
// was written before those arrivals is then read through L2 (__ldcg). A
// wait past ~2^26 polls (over a second; a whole step takes about a
// millisecond) traps: a fault in the plan or the counts ends the launch with
// an error instead of holding the card.
__device__ __forceinline__ void wait_count(const unsigned* c, unsigned target) {
  if (threadIdx.x == 0) {
    unsigned v;
    for (unsigned polls = 0;; ++polls) {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(c) : "memory");
      if (v >= target) break;
      if (polls > (1u << 26)) __trap();
      __nanosleep(20);
    }
  }
  csync();
}

// A split's meeting value: {epoch, v} in one release store at gpu scope
// (the epoch is the layer + 1, so that no wait mistakes an earlier layer's
// value for its own); take() waits for it with acquire loads.
__device__ __forceinline__ void post(unsigned long long* p, unsigned epoch, unsigned v) {
  const unsigned long long w = ((unsigned long long)epoch << 32) | v;
  asm volatile("st.release.gpu.global.b64 [%0], %1;\n" :: "l"(p), "l"(w) : "memory");
}
__device__ __forceinline__ unsigned take(const unsigned long long* p, unsigned epoch) {
  unsigned long long w;
  for (unsigned polls = 0;; ++polls) {
    asm volatile("ld.acquire.gpu.global.b64 %0, [%1];\n" : "=l"(w) : "l"(p) : "memory");
    if ((unsigned)(w >> 32) == epoch) break;
    if (polls > (1u << 26)) __trap();
    __nanosleep(20);
  }
  return (unsigned)w;
}

__device__ __forceinline__ float block_max(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  csync();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  csync();
  float r = red[0];
#pragma unroll
  for (int i = 1; i < NWARPS; ++i) r = fmaxf(r, red[i]);
  return r;
}

__device__ __forceinline__ double block_sum(double v, double* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  csync();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  csync();
  double r = red[0];
#pragma unroll
  for (int i = 1; i < NWARPS; ++i) r += red[i];
  return r;
}

__device__ __forceinline__ float qscale(float amax, float floor) {
  return fmaxf(__fdiv_rn(amax, 127.0f), floor);
}

__device__ __forceinline__ void zero4(int (&acc)[4][4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0;
}

// The row-0 sums of acc into red[32] (shared int32 adds: exact in any
// order), acc zeroed: lane (0, t) holds columns 8 t + j and 8 t + 4 + j.
__device__ __forceinline__ void acc_to_red1(int (&acc)[4][4], int* red) {
  const int lane = threadIdx.x & 31;
  if (lane < 4) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      atomicAdd(&red[8 * lane + j], acc[j][0]);
      atomicAdd(&red[8 * lane + 4 + j], acc[j][1]);
    }
  }
  zero4(acc);
}

// The int32 sums of the stream's next `tiles` tiles against act (from
// column 0, kc a tile), in red after the trailing barrier.
__device__ __forceinline__ void tiles_to_red(const StepArgs& a, Ring& rg, int tiles,
                                             uint32_t act, int* red, int l, int point) {
  int acc[1][4][4];
  zero4(acc[0]);
  for (int j = 0; j < tiles; ++j) {
    const uint32_t t = wait_tile(a, rg);
    if (point >= 0 && j == 0) stamp(a, l, point);
    if (point == 27 && j == tiles - 1) stamp(a, l, 28);
    tile_mma<1, NC>(t, a.kc, act, 16, 1, j * a.kc, acc);
    if (point == 27 && j == 0) stamp(a, l, 32);
    release_tile(a, rg);
    if (point == 27 && j == 0) stamp(a, l, 33);
  }
  acc_to_red1(acc[0], red);
  csync();
}

// RMSNorm of the row x ([D] f32, read through L2) with the weights w (kind
// wkind), quantized into act, its scale into *scale: quant_rows's
// arithmetic (int8_stream.cuh) for one row spread over every consumer warp
// (quant_rows gives a row at most 8 warps, and 2.7-3.6 us against 2.2 a
// norm in this kernel's traces): the mean of the squares summed in double and
// rounded once, the quantizer's divide by a multiply where no tie is near.
// Ends with the consumers' barrier.
__device__ __noinline__ void norm_quant1(const float* x, int D, const void* w, int wkind,
                                         float eps, int8_t* act, float* scale, float* red_f,
                                         double* red_d) {
  const int n4 = D >> 2, tid = threadIdx.x;
  float4 v[NQ_VEC];
  double ss = 0.0;
#pragma unroll
  for (int j = 0; j < NQ_VEC; ++j) {
    const int i = tid + NC * j;
    v[j] = i < n4 ? __ldcg(reinterpret_cast<const float4*>(x) + i)
                  : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    ss += (double)v[j].x * (double)v[j].x + (double)v[j].y * (double)v[j].y;
    ss += (double)v[j].z * (double)v[j].z + (double)v[j].w * (double)v[j].w;
  }
  ss = block_sum(ss, red_d);
  const float inv = __frcp_rn(__fsqrt_rn(__fadd_rn((float)(ss / (double)D), eps)));
  float amax = 0.0f;
#pragma unroll
  for (int j = 0; j < NQ_VEC; ++j) {
    const int i = tid + NC * j;
    if (i < n4) {
      const float4 wv = load_f4(w, wkind, 4 * i);
      v[j].x = __fmul_rn(__fmul_rn(v[j].x, inv), wv.x);
      v[j].y = __fmul_rn(__fmul_rn(v[j].y, inv), wv.y);
      v[j].z = __fmul_rn(__fmul_rn(v[j].z, inv), wv.z);
      v[j].w = __fmul_rn(__fmul_rn(v[j].w, inv), wv.w);
      amax = fmaxf(amax, fmaxf(fmaxf(fabsf(v[j].x), fabsf(v[j].y)),
                               fmaxf(fabsf(v[j].z), fabsf(v[j].w))));
    }
  }
  const float sc = qscale(block_max(amax, red_f), 1e-8f);
  const float r = __frcp_rn(sc);
#pragma unroll
  for (int j = 0; j < NQ_VEC; ++j) {
    const int i = tid + NC * j;
    if (i < n4) *reinterpret_cast<uint32_t*>(act + 4 * i) = quant4(v[j], sc, r);
  }
  if (tid == 0) *scale = sc;
  csync();
}

struct Smem {
  int8_t* act;
  int* red;
  unsigned char* vec;
  unsigned char* nvec;
  float* xcol;
  float* sbias;
  float* sbuf;
  int8_t* p8;
  float* qf;
  float* knf;
  float* vnf;
  float* y3;
  int8_t* q8;
  int* ov;
  float* hs;
  float* obuf;
  unsigned* meet;
  float* scal;
  void* scratch;
  float* red_f;
  double* red_d;
};

// One attention split of layer l: head h, slots [i n, (i + 1) n).
__device__ __forceinline__ void attention(const StepArgs& a, Ring& rg, int l, int idx,
                                          const Smem& sm) {
  const int h = idx / a.S, i = idx % a.S, d = a.d, n = a.n, S = a.S, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  if (l > 0) wait_count(counter(a, C_HEAD + h), 3u * l);
  stamp(a, l, 1);
  const float* qsrc = l == 0 ? a.q0 + h * d : a.qbuf + h * d;
  const float* ksrc = l == 0 ? a.kn0 + h * d : a.kn_out + ((long long)(l - 1) * a.H + h) * d;
  const float* vsrc = l == 0 ? a.vn0 + h * d : a.vn_out + ((long long)(l - 1) * a.H + h) * d;
  if (tid < d) {
    sm.qf[tid] = __ldcg(qsrc + tid);
    sm.knf[tid] = __ldcg(ksrc + tid);
    sm.vnf[tid] = __ldcg(vsrc + tid);
    sm.ov[tid] = 0;
  }
  csync();
  if (warp == 0) {
    // q quantized per head, and the current token's score (double, once)
    float mq = 0.0f;
    double acc = 0.0;
    for (int j = lane; j < d; j += 32) {
      mq = fmaxf(mq, fabsf(sm.qf[j]));
      acc += (double)sm.qf[j] * (double)sm.knf[j];
    }
    for (int o = 16; o > 0; o >>= 1) {
      mq = fmaxf(mq, __shfl_xor_sync(0xffffffffu, mq, o));
      acc += __shfl_xor_sync(0xffffffffu, acc, o);
    }
    const float qs = qscale(mq, 1e-8f);
    for (int j = lane; j < d; j += 32) sm.q8[j] = (int8_t)__float2int_rn(__fdiv_rn(sm.qf[j], qs));
    if (lane == 0) {
      sm.scal[0] = __fmul_rn(qs, a.sm_scale);
      sm.scal[1] = __fmul_rn((float)acc, a.sm_scale);
    }
  }
  stamp(a, l, 16);
  const uint32_t tile = wait_tile(a, rg);
  csync();
  stamp(a, l, 17);
  const int8_t* kt = reinterpret_cast<const int8_t*>(__cvta_shared_to_generic(tile));
  const int8_t* vt = kt + n * d;
  const __nv_bfloat16* kss = reinterpret_cast<const __nv_bfloat16*>(vt + n * d);
  const __nv_bfloat16* vss = kss + n;
  const float qsm = sm.scal[0], snew = sm.scal[1];
  // scores over the split's slots (16-byte words, rotated against bank conflicts)
  const int words = d / 16;
  const int* qw = reinterpret_cast<const int*>(sm.q8);
  float lmax = -INFINITY;
  for (int t = tid; t < n; t += NC) {
    const int4* kr = reinterpret_cast<const int4*>(kt + t * d);
    int dot = 0;
    for (int w0 = 0; w0 < words; ++w0) {
      const int w = (w0 + (t >> 1)) % words;
      const int4 kv = kr[w];
      dot = __dp4a(kv.x, qw[4 * w + 0], dot);
      dot = __dp4a(kv.y, qw[4 * w + 1], dot);
      dot = __dp4a(kv.z, qw[4 * w + 2], dot);
      dot = __dp4a(kv.w, qw[4 * w + 3], dot);
    }
    float s = __fmul_rn(__int2float_rn(dot), qsm);
    s = __fadd_rn(__fmul_rn(s, __bfloat162float(kss[t])), sm.sbias[t]);
    sm.sbuf[t] = s;
    lmax = fmaxf(lmax, s);
  }
  lmax = block_max(lmax, sm.red_f);
  stamp(a, l, 18);
  // meeting 1: the head's max over all T (each split posts its own and
  // takes the others', one thread a split)
  unsigned long long* sl = a.slots + (long long)h * S * 4;
  unsigned* meet = sm.meet;   // the splits' values: [S], then [3 S]
  if (S > 1) {
    if (tid == 0) post(sl + 4 * i, l + 1, __float_as_uint(lmax));
    if (tid < S) meet[tid] = take(sl + 4 * tid, l + 1);
    csync();
    for (int j = 0; j < S; ++j) lmax = fmaxf(lmax, __uint_as_float(meet[j]));
  }
  stamp(a, l, 2);
  const float mm = fmaxf(lmax, snew);
  double lsum = 0.0;
  float pmax = 0.0f;
  for (int t = tid; t < n; t += NC) {
    const float p = expf(__fsub_rn(sm.sbuf[t], mm));
    lsum += (double)p;
    const float pv = __fmul_rn(p, __bfloat162float(vss[t]));
    sm.sbuf[t] = pv;
    pmax = fmaxf(pmax, pv);
  }
  lsum = block_sum(lsum, sm.red_d);
  pmax = block_max(pmax, sm.red_f);
  // meeting 2: the head's probability sum (added in split order) and max
  // p * vs (the double's halves in two values)
  if (S > 1) {
    if (tid == 0) {
      post(sl + 4 * i + 1, l + 1, __float_as_uint(pmax));
      post(sl + 4 * i + 2, l + 1, (unsigned)__double2loint(lsum));
      post(sl + 4 * i + 3, l + 1, (unsigned)__double2hiint(lsum));
    }
    if (tid < 3 * S) meet[tid] = take(sl + 4 * (tid / 3) + 1 + tid % 3, l + 1);
    csync();
    lsum = 0.0;
    for (int j = 0; j < S; ++j) {
      pmax = fmaxf(pmax, __uint_as_float(meet[3 * j]));
      lsum += __hiloint2double((int)meet[3 * j + 2], (int)meet[3 * j + 1]);
    }
  }
  stamp(a, l, 3);
  const float p_new = expf(__fsub_rn(snew, mm));
  const float l_sum = __fadd_rn((float)lsum, p_new);
  const float ps = qscale(pmax, 1e-20f);
  for (int t = tid; t < n; t += NC) sm.p8[t] = (int8_t)__float2int_rn(__fdiv_rn(sm.sbuf[t], ps));
  csync();
  // the int32 p8 . v over the split's slots: d / 4 threads cover a row's
  // columns, the rest of the block splits the slots four at a time
  const int cols4 = d / 4, groups = NC / cols4;
  const int grp = tid / cols4, cq = tid - grp * cols4;
  {
    int c0 = 0, c1 = 0, c2 = 0, c3 = 0;
    for (int t = 4 * grp; t < n; t += 4 * groups) {
      const int w0 = *reinterpret_cast<const int*>(vt + (t + 0) * d + 4 * cq);
      const int w1 = *reinterpret_cast<const int*>(vt + (t + 1) * d + 4 * cq);
      const int w2 = *reinterpret_cast<const int*>(vt + (t + 2) * d + 4 * cq);
      const int w3 = *reinterpret_cast<const int*>(vt + (t + 3) * d + 4 * cq);
      const int t0 = __byte_perm(w0, w1, 0x5140);
      const int t1 = __byte_perm(w0, w1, 0x7362);
      const int t2 = __byte_perm(w2, w3, 0x5140);
      const int t3 = __byte_perm(w2, w3, 0x7362);
      const int pw = *reinterpret_cast<const int*>(sm.p8 + t);
      c0 = __dp4a((int)__byte_perm(t0, t2, 0x5410), pw, c0);
      c1 = __dp4a((int)__byte_perm(t0, t2, 0x7632), pw, c1);
      c2 = __dp4a((int)__byte_perm(t1, t3, 0x5410), pw, c2);
      c3 = __dp4a((int)__byte_perm(t1, t3, 0x7632), pw, c3);
    }
    if (c0 | c1 | c2 | c3) {
      atomicAdd(&sm.ov[4 * cq + 0], c0);
      atomicAdd(&sm.ov[4 * cq + 1], c1);
      atomicAdd(&sm.ov[4 * cq + 2], c2);
      atomicAdd(&sm.ov[4 * cq + 3], c3);
    }
  }
  stamp(a, l, 19);
  release_tile(a, rg);   // the split's cache rows are read
  // every split publishes its int32 p8 . v, split 0 also the head's ps,
  // p_new and l_sum: the o-projection blocks add the splits and divide
  if (tid < d) __stcg(&a.opart[(h * S + i) * d + tid], sm.ov[tid]);
  if (i == 0 && tid == 0) {
    __stcg(&a.hsc[3 * h], ps);
    __stcg(&a.hsc[3 * h + 1], p_new);
    __stcg(&a.hsc[3 * h + 2], l_sum);
  }
  arrive(counter(a, C_ATT));
  stamp(a, l, 4);
}

__global__ void __launch_bounds__(NT, 1)
    decode_step_kernel(StepArgs a, const __grid_constant__ Maps m) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(1024) unsigned char smem[];   // no static shared memory: all of
                                                              // SMEM_MAX is the launch's
  const int L = a.L, H = a.H, d = a.d, D = a.D, F = a.F, Hd = H * d, tid = threadIdx.x;
  const Layout lo = layout(H, d, D, F, a.n, a.max_items, a.stages, a.kc);
  Smem sm;
  sm.act = reinterpret_cast<int8_t*>(smem + lo.act);
  sm.red = reinterpret_cast<int*>(smem + lo.red);
  sm.vec = smem + lo.vec;
  sm.nvec = smem + lo.nvec;
  sm.xcol = reinterpret_cast<float*>(smem + lo.xcol);
  sm.sbias = reinterpret_cast<float*>(smem + lo.sbias);
  sm.sbuf = reinterpret_cast<float*>(smem + lo.sbuf);
  sm.p8 = reinterpret_cast<int8_t*>(smem + lo.p8);
  sm.qf = reinterpret_cast<float*>(smem + lo.rows);
  sm.knf = sm.qf + MAX_DH;
  sm.vnf = sm.knf + MAX_DH;
  sm.y3 = sm.vnf + MAX_DH;
  sm.q8 = reinterpret_cast<int8_t*>(smem + lo.q8);
  sm.ov = reinterpret_cast<int*>(smem + lo.ov);
  sm.hs = reinterpret_cast<float*>(smem + lo.hs);
  sm.obuf = reinterpret_cast<float*>(smem + lo.obuf);
  sm.meet = reinterpret_cast<unsigned*>(smem + lo.meet);
  sm.scal = reinterpret_cast<float*>(smem + lo.scal);
  sm.scratch = smem + lo.scratch;
  // the block reductions' scratch: the row quantizer's, which they never overlap
  sm.red_d = reinterpret_cast<double*>(smem + lo.scratch);
  sm.red_f = reinterpret_cast<float*>(smem + lo.scratch + 8 * NWARPS);

  const int beg = a.plan[blockIdx.x];
  const int* items = a.plan + gridDim.x + 1 + beg;
  const int n_items = a.plan[blockIdx.x + 1] - beg;
  Ring rg;
  rg.next = 0;
  {
    int per_layer = 0;
    for (int i = 0; i < n_items; ++i) per_layer += item_tiles(a, items[i]);
    rg.traced = per_layer * (a.trace_layer > 0 ? a.trace_layer - 1 : 0);
  }
  rg.base = smem_u32(smem + lo.ring);
  rg.full = smem_u32(smem + lo.bars);
  rg.empty = rg.full + 8 * MAX_STAGES;
  if (tid == 0) {
    for (int s = 0; s < a.stages; ++s) {
      mbar_init(rg.full + 8 * s, 1);
      mbar_init(rg.empty + 8 * s, 1);
    }
    mbar_fence_init();
  }
  __syncthreads();
  for (int i = tid; i < (H > 2 ? H : 2) * SLAB; i += NT) sm.red[i] = 0;
  if (n_items > 0 && (items[0] >> 24) == ATT) {   // the split's bias, the same in every layer
    const int t0 = ((items[0] & 0xffffff) % a.S) * a.n;
    for (int t = tid; t < a.n; t += NT) sm.sbias[t] = a.bias[t0 + t];
  }
  if (blockIdx.x == 0) {
    for (int i = tid; i < (C_HEAD + H) * CNT_STRIDE; i += NT) a.cnt[i] = 0u;
    for (int i = tid; i < H * a.S * 4; i += NT) a.slots[i] = 0ull;
  }
  grid.sync();   // the counters are zero before any block raises one
  if (tid >= NC) {   // the producer warp: the whole stream, as the consumers free its stages
    if (tid == NC) produce(a, m, items, n_items, rg);
    return;
  }

  const int esz = a.norm_kind == KIND_BF16 ? 2 : 4;
  const int bsz = a.bq_kind == KIND_BF16 ? 2 : 4;
  const int warp = tid >> 5, lane = tid & 31;
  const uint32_t act_s = smem_u32(sm.act);
  for (int l = 0; l < L; ++l) {
    const int nxt = l + 1 < L ? l + 1 : L - 1;
    int it = 0;
    stamp(a, l, 0);
    // ── attention splits ──
    for (; it < n_items && (items[it] >> 24) == ATT; ++it) {
      attention(a, rg, l, items[it] & 0xffffff, sm);
    }

    // ── o-projection, per-head int32 sums, + residual: x2 ──
    if (it < n_items && (items[it] >> 24) == OPROJ) {
      for (int i = it; i < n_items && (items[i] >> 24) == OPROJ; ++i) {
        if (tid < 8) {
          cp_async16(smem_u32(sm.vec + i * VEC_ITEM) + 16 * tid,
                     a.wos + (long long)l * D + SLAB * (items[i] & 0xffffff) + 4 * tid);
        }
      }
      cp_async_commit();
      wait_count(counter(a, C_ATT), (unsigned)(H * a.S) * (l + 1));
      stamp(a, l, 5);
      // o of every head: the splits' int32 sums added (exact), then
      // (o_v * ps + p_new * v_new) / max(l_sum, 1e-30), quantized per head
      const float* vn = l == 0 ? a.vn0 : a.vn_out + (long long)(l - 1) * Hd;
      for (int h = tid; h < H; h += NC) reinterpret_cast<unsigned*>(sm.hs)[h] = 0u;
      csync();
      // four elements a thread at a time, all their loads in flight together
      for (int i0 = tid; i0 < Hd; i0 += 4 * NC) {
        int oi[4] = {0, 0, 0, 0};
        float v[4], sc3[4][3];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int i = i0 + u * NC, h = i / d;
          if (i < Hd) {
            for (int j = 0; j < a.S; ++j) oi[u] += __ldcg(&a.opart[(h * a.S + j) * d + i - h * d]);
            v[u] = __ldcg(vn + i);
#pragma unroll
            for (int q = 0; q < 3; ++q) sc3[u][q] = __ldcg(&a.hsc[3 * h + q]);
          }
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int i = i0 + u * NC;
          if (i < Hd) {
            const float num = __fadd_rn(__fmul_rn(__int2float_rn(oi[u]), sc3[u][0]),
                                        __fmul_rn(sc3[u][1], v[u]));
            const float o = __fdiv_rn(num, fmaxf(sc3[u][2], 1e-30f));
            sm.obuf[i] = o;
            atomicMax(reinterpret_cast<unsigned*>(sm.hs) + i / d, __float_as_uint(fabsf(o)));
          }
        }
      }
      csync();
      stamp(a, l, 20);
      for (int h = tid; h < H; h += NC) {
        sm.hs[h] = qscale(__uint_as_float(reinterpret_cast<unsigned*>(sm.hs)[h]), 1e-8f);
      }
      csync();
      for (int i = tid; i < Hd; i += NC) {
        sm.act[i] = (int8_t)__float2int_rn(__fdiv_rn(sm.obuf[i], sm.hs[i / d]));
      }
      for (int i = it; i < n_items && (items[i] >> 24) == OPROJ; ++i) {
        if (tid < SLAB) {
          const int c = SLAB * (items[i] & 0xffffff) + tid;
          sm.xcol[i * SLAB + tid] = l == 0 ? a.x0[c] : __ldcg(&a.xo[c]);
        }
      }
      cp_async_wait<0>();
      csync();
      stamp(a, l, 21);
      for (; it < n_items && (items[it] >> 24) == OPROJ; ++it) {
        const int c0 = SLAB * (items[it] & 0xffffff);
        for (int j = 0; j < Hd / a.kc; ++j) {
          const uint32_t t = wait_tile(a, rg);
          if (j == 0) stamp(a, l, 22);
          for (int s = warp; s < a.kc / 32; s += NWARPS) {
            int acc[1][4][4];
            zero4(acc[0]);
            mma_step<1>(t, s, act_s, 16, 1, j * a.kc, acc);
            const int head = (j * a.kc + 32 * s) / d;
            acc_to_red1(acc[0], sm.red + head * SLAB);
          }
          release_tile(a, rg);
        }
        stamp(a, l, 23);
        if (tid < SLAB) {
          float y = __fmul_rn(__int2float_rn(sm.red[tid]), sm.hs[0]);
          sm.red[tid] = 0;
          for (int h = 1; h < H; ++h) {
            y = __fadd_rn(y, __fmul_rn(__int2float_rn(sm.red[h * SLAB + tid]), sm.hs[h]));
            sm.red[h * SLAB + tid] = 0;
          }
          const float* wsv = reinterpret_cast<const float*>(sm.vec + it * VEC_ITEM);
          __stcg(&a.x2[c0 + tid], __fadd_rn(sm.xcol[it * SLAB + tid], __fmul_rn(y, wsv[tid])));
        }
        arrive(counter(a, C_O));
      }
      stamp(a, l, 6);
    }

    // ── MLP RMSNorm, gate | up, silu(g) * u and its amax ──
    if (it < n_items && (items[it] >> 24) == GU) {
      copy_async<NC>(smem_u32(sm.nvec),
                     reinterpret_cast<const char*>(a.mw) + (long long)l * D * esz, D * esz);
      for (int i = it; i < n_items && (items[i] >> 24) == GU; ++i) {
        const float* s0 = a.sgu + (long long)l * 2 * F + SLAB * (items[i] & 0xffffff);
        if (tid < 8) cp_async16(smem_u32(sm.vec + i * VEC_ITEM) + 16 * tid, s0 + 4 * tid);
        if (tid >= 8 && tid < 16) {
          cp_async16(smem_u32(sm.vec + i * VEC_ITEM) + 16 * tid, s0 + F + 4 * (tid - 8));
        }
      }
      cp_async_commit();
      wait_count(counter(a, C_O), (unsigned)(D / SLAB) * (l + 1));
      stamp(a, l, 7);
      cp_async_wait<0>();
      csync();
      norm_quant1(a.x2, D, sm.nvec, a.norm_kind, a.eps, sm.act, sm.scal + 4, sm.red_f, sm.red_d);
      stamp(a, l, 8);
      const float hs = sm.scal[4];
      for (; it < n_items && (items[it] >> 24) == GU; ++it) {
        const int c0 = SLAB * (items[it] & 0xffffff);
        int acc_g[1][4][4], acc_u[1][4][4];
        zero4(acc_g[0]);
        zero4(acc_u[0]);
        for (int j = 0; j < D / a.kc; ++j) {
          uint32_t t = wait_tile(a, rg);
          if (j == 0) stamp(a, l, 24);
          tile_mma<1, NC>(t, a.kc, act_s, 16, 1, j * a.kc, acc_g);
          release_tile(a, rg);
          t = wait_tile(a, rg);
          tile_mma<1, NC>(t, a.kc, act_s, 16, 1, j * a.kc, acc_u);
          release_tile(a, rg);
        }
        acc_to_red1(acc_g[0], sm.red);
        acc_to_red1(acc_u[0], sm.red + SLAB);
        csync();
        stamp(a, l, 25);
        if (tid < SLAB) {
          const float* sg = reinterpret_cast<const float*>(sm.vec + it * VEC_ITEM);
          const float g = __fmul_rn(__fmul_rn(__int2float_rn(sm.red[tid]), hs), sg[tid]);
          const float u = __fmul_rn(__fmul_rn(__int2float_rn(sm.red[SLAB + tid]), hs),
                                    sg[SLAB + tid]);
          const float v = __fmul_rn(__fmul_rn(g, __frcp_rn(__fadd_rn(1.0f, expf(-g)))), u);
          sm.red[tid] = sm.red[SLAB + tid] = 0;
          __stcg(&a.hbuf[c0 + tid], v);
          float mx = fabsf(v);
          for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
          if (tid == 0) __stcg(&a.hmax[c0 / SLAB], mx);
        }
        arrive(counter(a, C_GU));
      }
      stamp(a, l, 9);
    }

    // ── down, one hidden scale over all of d_ff, + residual: x_out ──
    if (it < n_items && (items[it] >> 24) == DOWN) {
      for (int i = it; i < n_items && (items[i] >> 24) == DOWN; ++i) {
        if (tid < 8) {
          cp_async16(smem_u32(sm.vec + i * VEC_ITEM) + 16 * tid,
                     a.sd + (long long)l * D + SLAB * (items[i] & 0xffffff) + 4 * tid);
        }
      }
      cp_async_commit();
      wait_count(counter(a, C_GU), (unsigned)(F / SLAB) * (l + 1));
      stamp(a, l, 10);
      // the hidden's max |.| over all of d_ff (the gate | up items' maxima)
      // and the hidden itself, loaded together, then quantized with one
      // scale (4 float4 a thread at a time; a longer d_ff loops)
      float hm = 0.0f;
      for (int i = tid; i < F / SLAB; i += NC) hm = fmaxf(hm, __ldcg(&a.hmax[i]));
      const float4* hsrc = reinterpret_cast<const float4*>(a.hbuf);
      float4 hv[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = tid + u * NC;
        hv[u] = i < F / 4 ? __ldcg(hsrc + i) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      }
      const float ms = qscale(block_max(hm, sm.red_f), 1e-8f);
      const float inv = __frcp_rn(ms);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = tid + u * NC;
        if (i < F / 4) reinterpret_cast<uint32_t*>(sm.act)[i] = quant4(hv[u], ms, inv);
      }
      for (int i = tid + 4 * NC; i < F / 4; i += NC) {
        reinterpret_cast<uint32_t*>(sm.act)[i] = quant4(__ldcg(hsrc + i), ms, inv);
      }
      for (int i = it; i < n_items && (items[i] >> 24) == DOWN; ++i) {
        if (tid < SLAB) sm.xcol[i * SLAB + tid] = __ldcg(&a.x2[SLAB * (items[i] & 0xffffff) + tid]);
      }
      cp_async_wait<0>();
      csync();
      stamp(a, l, 26);
      for (; it < n_items && (items[it] >> 24) == DOWN; ++it) {
        const int c0 = SLAB * (items[it] & 0xffffff);
        tiles_to_red(a, rg, F / a.kc, act_s, sm.red, l, 27);
        stamp(a, l, 29);
        if (tid < SLAB) {
          const float* sdv = reinterpret_cast<const float*>(sm.vec + it * VEC_ITEM);
          const float xo = __fadd_rn(sm.xcol[it * SLAB + tid],
                                     __fmul_rn(__fmul_rn(__int2float_rn(sm.red[tid]), ms), sdv[tid]));
          sm.red[tid] = 0;
          __stcg(&a.xo[c0 + tid], xo);
          if (l == L - 1) a.x_out[c0 + tid] = xo;
        }
        arrive(counter(a, C_DOWN));
      }
      stamp(a, l, 11);
    }

    // ── the next layer's RMSNorm, qkv (+ bias), RoPE ──
    if (it < n_items && (items[it] >> 24) == QKV) {
      copy_async<NC>(smem_u32(sm.nvec + align16(4 * D)),
                     reinterpret_cast<const char*>(a.nw) + (long long)nxt * D * esz, D * esz);
      const int Q = 3 * Hd;
      for (int i = it; i < n_items && (items[i] >> 24) == QKV; ++i) {
        const int c0 = (items[i] & 0xffffff) * d;
        const uint32_t v = smem_u32(sm.vec + i * VEC_ITEM);
        for (int k = tid; k < d / 4; k += NC) {
          cp_async16(v + 16 * k, a.sq + (long long)nxt * Q + c0 + 4 * k);
        }
        if (a.bq_kind != KIND_NONE) {
          const char* b0 = reinterpret_cast<const char*>(a.bq) + ((long long)nxt * Q + c0) * bsz;
          for (int k = tid; k < d * bsz / 16; k += NC) cp_async16(v + 512 + 16 * k, b0 + 16 * k);
        }
      }
      cp_async_commit();
      wait_count(counter(a, C_DOWN), (unsigned)(D / SLAB) * (l + 1));
      stamp(a, l, 12);
      cp_async_wait<0>();
      csync();
      norm_quant1(a.xo, D, sm.nvec + align16(4 * D), a.norm_kind, a.eps, sm.act, sm.scal + 5,
                  sm.red_f, sm.red_d);
      stamp(a, l, 13);
      const float s_row = sm.scal[5];
      for (; it < n_items && (items[it] >> 24) == QKV; ++it) {
        const int idx = items[it] & 0xffffff, r = idx / H, h = idx % H;
        const float* sqv = reinterpret_cast<const float*>(sm.vec + it * VEC_ITEM);
        const void* bqv = sm.vec + it * VEC_ITEM + 512;
        for (int k = 0; k < d / SLAB; ++k) {
          tiles_to_red(a, rg, D / a.kc, act_s, sm.red, l, k == 0 ? 30 : -1);
          if (tid < SLAB) {
            const int c = SLAB * k + tid;
            float y = __fmul_rn(__fmul_rn(__int2float_rn(sm.red[tid]), s_row), sqv[c]);
            if (a.bq_kind != KIND_NONE) y = __fadd_rn(y, load_f(bqv, a.bq_kind, c));
            sm.y3[c] = y;
            sm.red[tid] = 0;
          }
        }
        csync();
        stamp(a, l, 31);
        float* dst = r == 0 ? a.qbuf + h * d
                            : (r == 1 ? a.kn_out : a.vn_out) + ((long long)l * H + h) * d;
        const int half = d / 2;
        for (int j = tid; j < d; j += NC) {
          float out = sm.y3[j];
          if (r < 2) {
            const int sw = j < half ? j + half : j - half;
            out = __fadd_rn(__fmul_rn(sm.y3[j], a.cos_f[j]), __fmul_rn(sm.y3[sw], a.sin_f[j]));
          }
          __stcg(dst + j, out);
        }
        arrive(counter(a, C_HEAD + h));
      }
      stamp(a, l, 14);
    }
    stamp(a, l, 15);
  }
}

bool shapes_ok(int L, int H, int d, int D, int F, int T) {
  return L >= 1 && H >= 1 && H <= MAX_H && d >= 32 && d <= MAX_DH && d % 32 == 0 && D >= 32 &&
         D % 32 == 0 && D <= 4 * NQ_VEC * NC && F >= 32 && F % 32 == 0 && T >= 128 &&
         T % 128 == 0 && 3 * H * d < (1 << 24) && F < (1 << 24);
}

long long a256(long long n) { return (n + 255) / 256 * 256; }

}  // namespace

// q, the heads' ps, p_new and l_sum, x2, x_out, the hidden and its maxima
// by item, the splits' meetings and int32 sums, the counters
extern "C" long long vt_decode_step_workspace(int L, int H, int d, int D, int F, int S) {
  if (L < 1 || H < 1 || d < 1 || D < 1 || F < 1 || S < 1) return -1;
  return a256((long long)H * d * 4) + a256((long long)H * 3 * 4) + 2 * a256((long long)D * 4) + a256((long long)F * 4) + a256((long long)(F / SLAB) * 4) +
         a256((long long)H * S * 4 * 8) + a256((long long)H * S * d * 4) +
         a256((long long)(C_HEAD + H) * CNT_STRIDE * 4);
}

// The shared bytes of a launch; -1 for a plan the kernel does not take.
extern "C" int vt_decode_step_smem(int H, int d, int D, int F, int T, int n, int max_items,
                                   int stages, int kc) {
  if (!shapes_ok(1, H, d, D, F, T) || n < 8 || n % 8 || T % n || T / n > MAX_S || stages < 2 ||
      stages > MAX_STAGES || kc < 32 || kc > 1024 || kc % 32 || (H * d) % kc || D % kc ||
      F % kc || n * (2 * d + 4) > kc * SLAB || max_items < 1) {
    return -1;
  }
  return layout(H, d, D, F, n, max_items, stages, kc).total;
}

// The largest grid a cooperative launch accepts: the SMs times the blocks
// an SM keeps resident at the most shared memory a block may use (one),
// asked of the runtime once per device.
extern "C" int vt_decode_step_max_blocks(int H, int d, int D, int F, int T) {
  if (!shapes_ok(1, H, d, D, F, T)) return -(int)cudaErrorInvalidValue;
  static int most[64];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return -(int)e;
  if (most[dev & 63] == 0) {
    e = cudaFuncSetAttribute(decode_step_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM_MAX);
    if (e != cudaSuccess) return -(int)e;
    int sms = 0, per_sm = 0;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return -(int)e;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, decode_step_kernel, NT, SMEM_MAX);
    if (e != cudaSuccess) return -(int)e;
    most[dev & 63] = sms * per_sm;
  }
  return most[dev & 63];
}

// B7: one cooperative launch of `grid` blocks. plan: the item table
// (ops/decode_step.py step_plan, on the device); S and n: the splits of a
// head and their slots; kc, stages, max_items and smem: the tile rows, ring
// depth, items a block at most and shared bytes (checked against
// vt_decode_step_smem). stamps: null, or [grid, 16] u64 for the
// %globaltimer ns at the phase points of layer trace_layer. The cache, its
// scales and the weights start on 16-byte boundaries.
extern "C" int vt_decode_step_fused(
    const void* q0, const void* kn0, const void* vn0, const void* x,
    const void* k_all, const void* v_all, const void* k_scale, const void* v_scale,
    const void* bias, const void* wo, const void* wos, const void* mw,
    const void* wgu, const void* sgu, const void* wd, const void* sd,
    const void* nw, const void* wq, const void* sq, const void* bq,
    const void* cos_f, const void* sin_f, void* x_out, void* kn_out, void* vn_out,
    int norm_kind, int bq_kind, int grid,
    int L, int H, int T, int d, int D, int F, float sm_scale, float eps,
    void* ws, long long ws_bytes, const void* plan, int S, int n, int kc, int stages,
    int max_items, int smem, void* stamps, int trace_layer, void* stream) {
  if (!shapes_ok(L, H, d, D, F, T) || grid < 1 || plan == nullptr || S < 1 || S * n != T ||
      norm_kind == KIND_NONE ||
      smem != vt_decode_step_smem(H, d, D, F, T, n, max_items, stages, kc) || smem > SMEM_MAX ||
      ws_bytes < vt_decode_step_workspace(L, H, d, D, F, S)) {
    return (int)cudaErrorInvalidValue;
  }
  const void* aligned[] = {k_all, v_all, k_scale, v_scale, wo, wos, mw, wgu, sgu, wd, sd, nw,
                           wq, sq, bq};
  for (const void* q : aligned) {
    if ((uintptr_t)q % 16 != 0) return (int)cudaErrorMisalignedAddress;
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
  a.wos = (const float*)wos;
  a.mw = mw;
  a.sgu = (const float*)sgu;
  a.sd = (const float*)sd;
  a.nw = nw;
  a.sq = (const float*)sq;
  a.bq = bq;
  a.cos_f = (const float*)cos_f;
  a.sin_f = (const float*)sin_f;
  a.x_out = (float*)x_out;
  a.kn_out = (float*)kn_out;
  a.vn_out = (float*)vn_out;
  a.plan = (const int*)plan;
  char* p = (char*)ws;
  auto take = [&p](long long bytes) {
    char* out = p;
    p += a256(bytes);
    return out;
  };
  a.qbuf = (float*)take((long long)H * d * 4);
  a.hsc = (float*)take((long long)H * 3 * 4);
  a.x2 = (float*)take((long long)D * 4);
  a.xo = (float*)take((long long)D * 4);
  a.hbuf = (float*)take((long long)F * 4);
  a.hmax = (float*)take((long long)(F / SLAB) * 4);
  a.slots = (unsigned long long*)take((long long)H * S * 4 * 8);
  a.opart = (int*)take((long long)H * S * d * 4);
  a.cnt = (unsigned*)take((long long)(C_HEAD + H) * CNT_STRIDE * 4);
  a.stamps = (unsigned long long*)stamps;
  a.trace_layer = trace_layer;
  a.norm_kind = norm_kind;
  a.bq_kind = bq == nullptr ? KIND_NONE : bq_kind;
  a.L = L;
  a.H = H;
  a.T = T;
  a.d = d;
  a.D = D;
  a.F = F;
  a.S = S;
  a.n = n;
  a.kc = kc;
  a.stages = stages;
  a.max_items = max_items;
  a.sm_scale = sm_scale;
  a.eps = eps;
  Maps maps;
  int rc = tile_map(wo, L, H * d, D, kc, &maps.wo);
  if (rc == 0) rc = tile_map(wgu, L, D, 2 * F, kc, &maps.wgu);
  if (rc == 0) rc = tile_map(wd, L, F, D, kc, &maps.wd);
  if (rc == 0) rc = tile_map(wq, L, D, 3 * H * d, kc, &maps.wq);
  if (rc) return rc;
  // the largest dynamic shared size, allowed once per device
  static int allowed[64];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (!allowed[dev & 63]) {
    e = cudaFuncSetAttribute(decode_step_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM_MAX);
    if (e != cudaSuccess) return (int)e;
    allowed[dev & 63] = 1;
  }
  void* params[] = {&a, &maps};
  e = cudaLaunchCooperativeKernel((const void*)decode_step_kernel, dim3(grid), dim3(NT), params,
                                  (size_t)smem, (cudaStream_t)stream);
  if (e != cudaSuccess) {
    cudaGetLastError();  // a refused launch leaves no sticky error; clear the last one
    return (int)e;
  }
  return (int)cudaGetLastError();
}
