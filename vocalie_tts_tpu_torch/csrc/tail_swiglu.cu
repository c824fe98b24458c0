// B2 (the SwiGLU layer tail + the NEXT layer's RMSNorm and qkv product) and
// B8a (the tail alone) as ONE cooperative, persistent launch whose int8
// weights stream into shared memory ahead of its grid barriers and are
// multiplied on the int8 tensor cores.
//
// Replaces, in vocalie_tts_tpu/ops/decode_dense.py:
//   B2  tail_swiglu_qkv_int8_stacked  (def :519, pallas_call :611)
//   B8a tail_swiglu_int8_stacked      (def :368, pallas_call :428)
//   B8b mlp_swiglu_int8_stacked       (def :190, pallas_call :234), the MLP
//       branch (mlp_swiglu_kernel, see "B8b" below)
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
//     engine for a whole tile in one request (a 4-d tensor map, encoded once
//     per weight array), marked to leave L2 first, and the warps wait on the
//     stage's mbarrier. Each block streams its items' tiles through a ring of
//     `stages` stages, refilled as it consumes them, across the
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
// The body past the o-projection (tail_after_x2), the layout, the tile
// requests and the ring's set-up live in tail_swiglu.cuh, shared with B12
// (decode_layer.cu), which computes x2 its own way.
// vocalie_tts_tpu_torch/tools/tail_swiglu_trace.py reads the card's clock at
// each phase point (the `stamps` argument).
//
// B8b (the SwiGLU MLP alone, JAX _mlp_kernel :155-187) is the same body
// with the o-projection, the norm and the residual taken out
// (tail_after_x2<MT, true>; ops/decode_dense.py tail_plan with
// mlp="swiglu_mlp": gate | up and down items only):
//   gu   = (float(q(x) . Wgu[l]) * xs) * sgu, x the post-norm rows
//   out  = (sum over tiles, in order, of float(q_t(silu(g) * u) . Wd_t) * s_t) * sd
// Every block asks for its tiles from its first instruction (its gate | up
// items first); a gate | up block quantizes the rows of x itself (bf16 or
// f32, an amax and a divide) in place of the o-projection and barrier 1.
// With no barrier before gate | up nothing device-wide can be zeroed for it:
// the hidden's amax is written per (row, gate | up slab), each word once,
// and every block takes the max of a (row, tile)'s slabs after barrier 2
// (as B9d does, tail_gelu.cu). Then the quantized-hidden barrier and the
// down items, each a whole slab over d_ff met in tile order in its block:
// two grid barriers a call, where the old chain (vt_mlp_swiglu_int8 in
// decode_dense.cu, which still runs the shapes this body does not take) was
// six kernels.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "tail_swiglu.cuh"

namespace cg = cooperative_groups;
using namespace i8s;

namespace {

template <int MT>
__global__ void __launch_bounds__(threads<MT>(), 1)
    tail_swiglu_kernel(TailArgs a, const __grid_constant__ Maps m) {
  extern __shared__ __align__(1024) unsigned char smem[];
  const int b = a.b, d = a.d, tid = threadIdx.x, nt = threads<MT>();
  const Layout lo = layout(b, MT, a.lda, d, a.max_gu, a.max_items, a.F / a.tile, a.stages, a.kc);
  const TailSmem s = tail_smem<MT>(smem, lo);
  stamp(a, 0);

  TileRing rg = tail_ring(a, smem, lo);
  const int* items = rg.items;
  const int n_items = rg.n_items;
  tail_small_inputs(a, s, rg);
  // the o-projection's tiles now, alone on the card until barrier 1; every
  // other tile the ring holds once the block has passed it (and its MLP
  // norm's reads: they would queue behind the stream)
  fill(a, m, rg);
  tail_reset<MT>(a, s);
  int it = 0;
  int acc[MT][4][4];
  zero_acc(acc);

  // ── o-projection + residual: x2 ──
  if (it < n_items && (items[it] >> 24) == 0) {
    quant_rows(a.attn, b, a.d_attn, nullptr, KIND_NONE, 0.0f, s.act, a.lda, s.sc, s.scratch);
    wait_first();   // the column scales and the residual columns
  }
  for (; it < n_items && (items[it] >> 24) == 0; ++it) {
    const int c0 = SLAB * (items[it] & 0xffffff);
    for (int j = 0; j < a.d_attn / a.kc; ++j) {
      const uint32_t t = wait_tile(a, rg);
      tile_mma<MT>(t, a.kc, s.act_s, a.lda, b, j * a.kc, acc);
      release_tile(a, m, rg);
    }
    acc_to_red<MT>(acc, s.red, b);
    __syncthreads();
    const unsigned char* xr = reinterpret_cast<const unsigned char*>(s.cols + it * b * SLAB);
    for (int e = tid; e < b * SLAB; e += nt) {
      const int r = e / SLAB, c = e % SLAB;
      const int k = r * RED_ROW + c;
      const float y = __fmul_rn(__fmul_rn(__int2float_rn(s.red[k]), s.sc[r]),
                                s.vec[it * 2 * SLAB + c]);
      a.x2[(long long)r * d + c0 + c] = __fadd_rn(load_f(xr + r * TAIL_COL_ROW, a.x_kind, c), y);
      s.red[k] = 0;
    }
    __syncthreads();
  }
  tail_after_x2<MT>(a, m, rg, s, it, acc);
}

// B8b: the MLP alone on the rows of x (the tail's MLP branch); every tile
// asked for at entry
template <int MT>
__global__ void __launch_bounds__(threads<MT>(), 1)
    mlp_swiglu_kernel(TailArgs a, const __grid_constant__ Maps m) {
  extern __shared__ __align__(1024) unsigned char smem[];
  const int tid = threadIdx.x, nt = threads<MT>();
  const Layout lo =
      layout(a.b, MT, a.lda, a.d, a.max_gu, a.max_items, a.F / a.tile, a.stages, a.kc);
  const TailSmem s = tail_smem<MT>(smem, lo);
  stamp(a, 0);
  TileRing rg = tail_ring(a, smem, lo);
  tail_small_inputs<true>(a, s, rg);
  rg.cap = 3;
  fill(a, m, rg);
  for (int i = tid; i < 2 * 16 * MT * RED_ROW; i += nt) s.red[i] = 0;
  int acc[MT][4][4];
  zero_acc(acc);
  tail_after_x2<MT, true>(a, m, rg, s, 0, acc);
}

bool shapes_ok(int b, int d_attn, int d, int F, int tile, int Q) {
  return b >= 1 && b <= TAIL_MAX_B && d_attn >= 32 && d_attn % 32 == 0 && d_attn <= TAIL_MAX_D &&
         d >= 32 && d % 32 == 0 && d <= TAIL_MAX_D && F >= 32 &&
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
  return layout(b, b > 16 ? 2 : 1, tail_lda(d_attn, d, F), d, max_gu, max_items, F / tile, stages,
                kc).total;
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
      smem > TAIL_SMEM_MAX || ws_bytes < vt_tail_swiglu_workspace(b, d, F, tile)) {
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
  a.lda = tail_lda(d_attn, d, F);
  a.max_gu = max_gu;
  a.max_items = max_items;
  a.gu_blocks = gu_blocks;
  a.eps = eps;
  Maps maps;
  const int rc = tail_maps(wo, wgu, wd, wq, L, d_attn, d, F, Q, kc, &maps);
  if (rc) return rc;
  const void* fn = b > 16 ? (const void*)tail_swiglu_kernel<2> : (const void*)tail_swiglu_kernel<1>;
  // the largest dynamic shared size, allowed once per body and device
  static int allowed[2][64];
  const int ok = allow_smem_once(fn, allowed[b > 16]);
  if (ok) return ok;
  void* params[] = {&a, &maps};
  const cudaError_t e = cudaLaunchCooperativeKernel(fn, dim3(grid),
                                                    dim3(b > 16 ? threads<2>() : threads<1>()),
                                  params, (size_t)smem, (cudaStream_t)stream);
  if (e != cudaSuccess) {
    cudaGetLastError();  // a refused launch leaves no sticky error; clear the last one
    return (int)e;
  }
  return (int)cudaGetLastError();
}

// ── B8b: the SwiGLU MLP alone, the body's MLP branch ─────────────────────

// B8b's workspace: the quantized hidden and its amax per (row, gate | up slab)
extern "C" long long vt_mlp_swiglu_one_workspace(int b, int d, int F, int tile) {
  if (b < 1 || d < 1 || F < 1 || tile < 1 || F % tile) return -1;
  auto a256 = [](long long n) { return (n + 255) / 256 * 256; };
  return a256((long long)b * F) + a256((long long)b * (F / SLAB) * 4);
}

// The shared bytes of a B8b launch; -1 for a plan the kernel does not take.
extern "C" int vt_mlp_swiglu_one_smem(int b, int d, int F, int tile, int max_gu, int max_items,
                                      int stages, int kc) {
  if (!shapes_ok(b, d, d, F, tile, 0) || stages < 1 || stages > MAX_STAGES || kc < 32 ||
      kc % 32 || d % kc || tile % kc || max_gu < 0 || max_items < max_gu) {
    return -1;
  }
  return layout(b, b > 16 ? 2 : 1, tail_lda(0, d, F), d, max_gu, max_items, F / tile, stages, kc)
      .total;
}

// B8b, one launch of `grid` blocks: out = (sum over d_ff tiles t, in order,
// of float(q_t(silu(g) * u) . Wd[l]_t) * s_t) * sd[l], [g | u] =
// (float(q(x) . Wgu[l]) * xs) * sgu[l]; x [b, d] the post-norm rows
// (x_kind), no residual. plan: the item table of tail_plan with
// mlp="swiglu_mlp" (no o-projection or qkv items); kc, stages, max_gu,
// max_items and smem as vt_tail_swiglu_qkv_int8's (smem checked against
// vt_mlp_swiglu_one_smem). stamps: null, or [grid, 12 + 64] u64. Every
// pointer but out, ws, plan and stamps starts on a 16-byte boundary.
extern "C" int vt_mlp_swiglu_one(const void* x, int x_kind, const void* wgu, const void* sgu,
                                 const void* wd, const void* sd, int layer, int L, int b, int d,
                                 int F, int tile, void* out, void* ws, long long ws_bytes,
                                 const void* plan, int grid, int kc, int stages, int max_gu,
                                 int max_items, int smem, void* stamps, void* stream) {
  if (!shapes_ok(b, d, d, F, tile, 0) || layer < 0 || layer >= L || grid < 1 ||
      x_kind == KIND_NONE || plan == nullptr ||
      smem != vt_mlp_swiglu_one_smem(b, d, F, tile, max_gu, max_items, stages, kc) ||
      smem > TAIL_SMEM_MAX || ws_bytes < vt_mlp_swiglu_one_workspace(b, d, F, tile)) {
    return (int)cudaErrorInvalidValue;
  }
  const void* aligned[] = {x, wgu, sgu, wd, sd};
  for (const void* q : aligned) {
    if ((uintptr_t)q % 16 != 0) return (int)cudaErrorMisalignedAddress;
  }
  TailArgs a = {};
  a.x = x;
  a.wgu = (const int8_t*)wgu;
  a.sgu = (const float*)sgu;
  a.wd = (const int8_t*)wd;
  a.sd = (const float*)sd;
  a.x_out = (float*)out;
  a.plan = (const int*)plan;
  char* p = (char*)ws;
  a.hq = (int8_t*)p;
  p += ((long long)b * F + 255) / 256 * 256;
  a.amax = (unsigned*)p;
  a.stamps = (unsigned long long*)stamps;
  a.x_kind = x_kind;
  a.norm_kind = KIND_NONE;
  a.layer = a.nxt = layer;
  a.b = b;
  a.d = d;
  a.F = F;
  a.tile = tile;
  a.kc = kc;
  a.stages = stages;
  a.lda = tail_lda(0, d, F);
  a.max_gu = max_gu;
  a.max_items = max_items;
  Maps maps;
  int rc = tile_map(wgu, L, d, 2 * F, kc, &maps.wgu);
  if (rc == 0) rc = tile_map(wd, L, F, d, kc, &maps.wd);
  if (rc) return rc;
  maps.wo = maps.wq = maps.wgu;   // not read
  const void* fn = b > 16 ? (const void*)mlp_swiglu_kernel<2> : (const void*)mlp_swiglu_kernel<1>;
  static int allowed[2][64];
  const int ok = allow_smem_once(fn, allowed[b > 16]);
  if (ok) return ok;
  void* params[] = {&a, &maps};
  const cudaError_t e = cudaLaunchCooperativeKernel(fn, dim3(grid),
                                                    dim3(b > 16 ? threads<2>() : threads<1>()),
                                                    params, (size_t)smem, (cudaStream_t)stream);
  if (e != cudaSuccess) {
    cudaGetLastError();  // a refused launch leaves no sticky error; clear the last one
    return (int)e;
  }
  return (int)cudaGetLastError();
}
