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
//     sm)) * ks + bias, a running max from -1e30 over the blocks, p * vs
//     quantized per block and q row (ps = max(max / 127, 1e-20)), acc = acc *
//     corr + i32 * ps; the current token's k/v merged in f32, o = (acc * corr
//     + p_new * v_new) / max(l, 1e-30);
//   * the o-projection per q head: each [b, d] slice of head c = h*g+j
//     quantized per row on its own (floor 1e-8), its int32 product with Wo
//     rows [c*d, c*d + d) times that scale, summed in f32 over c in ascending
//     order, y * wos, x2 = x + that;
//   * from x2, B2's tail (tail_swiglu.cuh): RMSNorm(x2, mw[l]), per-row int8,
//     gate | up, silu(g) * u quantized per (row, d_ff tile), the
//     down-projection's parts summed in tile order, x_out = x2 + acc * sd;
//     RMSNorm(x_out, nw[nxt]), int8, qkv_next of layer nxt = min(l + 1, L - 1).
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
// Design: one cooperative grid of one block an SM (512 threads), B2's body
// with the attention and the per-head o-projection in front of it.
//   * The weights: B2's plan (ops/decode_dense.py tail_plan, through
//     ops/decode_layer.py layer_plan: 32-column slabs of the four products
//     dealt by bytes, a TMA tile ring on mbarriers), one request a tile (a
//     4-d tensor map: tile_map). A block asks for its first Wo or
//     gate | up tile at launch; the rest when its attention is done (an
//     o-projection block its Wo tiles first, the rest after its
//     o-projection: each request holds the asking thread ~0.7 us). Asking
//     for more at launch slowed the cache's bytes (PERF.md §6).
//   * Attention: an item is one (row, kv head) pair's 128-slot block j (B1's
//     split, one block a rank): item i = j * b * kv + pair runs on block i %
//     grid, team (i / grid) % slots of 1-4 warps (the split and the teams
//     planned by ops/decode_layer.py layer_attn_split, layer_attn_team; named
//     barriers), each team walking its items in ascending i. A team's slot
//     in shared memory, past the ring's first stage and over the tail's
//     regions (the attention does not need them), takes the block's k rows,
//     scales and bias by bulk copies on one mbarrier, its v rows (asked for
//     after the scores: with the k rows they landed together) on another.
//   * Each item scores its 128 slots (int8 dots from shared memory, 16 bytes
//     a lane, rotated so that a quarter-warp's rows fall in distinct banks;
//     the rows shared by the team's warps), publishes its block max per q
//     row and a flag, and waits for the flags of the pair's earlier blocks:
//     its chain starts at their prefix max, so its p8 round as the plain
//     version's do (B1's rule). Waits only point to earlier blocks, and a
//     team takes its items in block order, so no wait is circular. It writes
//     (m_j, l_j = its p summed in double, acc_j = p8 . v * ps; p8 . v's
//     columns shared by the warps) to device memory; the pair's last item to
//     finish (a counter) merges the blocks in order, c = exp(M - m_j), A =
//     A * c + acc_j, L = L * c + l_j -- for one block a rank these are the
//     chain's own steps, bit for bit -- then the current token (its score
//     taken at the start), divides, quantizes each q head's d outputs (its
//     o8 and scale; the q rows shared by the team), resets the pair's flags
//     and counter for the next call, and counts the pair merged.
//   * The o-projection blocks wait for every pair's count (the others go on
//     to barrier 1), then multiply on the int8 tensor cores (mma.sync
//     m16n8k32 as B2's, int8_stream.cuh): a Wo tile of kc rows holds kc / d
//     whole heads, a warp takes one head's d / 32 steps into its own int32
//     accumulator, scales it by os[row, head] into an f32 part, and the
//     block adds the parts head after head in ascending order.
//   * x2 written, B2's tail runs as it is (tail_after_x2): its four grid
//     barriers are the launch's only ones.
//   * Every weight tile and cache block is marked to leave L2 first: the
//     34-69 MB a call streams otherwise evicted the kernel's code and small
//     inputs, and every phase ran slower (PERF.md §6).
// vocalie_tts_tpu_torch/tools/decode_layer_trace.py reads the card's clock
// at each phase point (the `stamps` argument).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "tail_swiglu.cuh"

using namespace i8s;

namespace {

constexpr int NT = 512;           // threads a block (B2's body at b <= 16)
constexpr int NWARP = NT / 32;
constexpr int TBLK = 128;         // slots of a cache block
constexpr int MAX_B = 16;
constexpr int MAX_G = 8;
constexpr int MAX_SLOTS = NWARP;  // attention items a block holds at once
constexpr int ATT_STAMPS = 13;    // a block's attention phase points in a trace
constexpr int KC_MAX = 1024;      // a weight tile's rows at most (tail_plan)
constexpr int MERGE_R = 8;        // blocks a merge loads in one round trip
constexpr int W_MAX = 4;          // warps an attention item at most

struct LayerArgs {
  TailArgs t;                   // the tail from x2 (t.x: the residual, f32)
  const float* q;               // [BC, g, dh]
  const int8_t* k_all;          // [L, BC, T, dh]
  const int8_t* v_all;
  const __nv_bfloat16* ks_all;  // [L, BC, T]
  const __nv_bfloat16* vs_all;
  const float* bias;            // [b, T]
  const float* k_new;           // [BC, dh]
  const float* v_new;
  int8_t* o8;                   // [b, H * dh] the attention output, int8 per (row, head)
  float* os;                    // [b, H] its scales
  float* bmax;                  // [BC, nmax, g] each item's block max
  float* pm;                    // [BC, nmax, g] each item's running max after its block
  float* pl;                    // [BC, nmax, g] its probability sum
  float* pacc;                  // [BC, nmax, g, dh] its p8 . v * ps
  unsigned* flags;              // [BC, nmax] an item's block max is out
  unsigned* cnt;                // [BC] a pair's items done
  unsigned* merged;             // the pairs merged (their o8 out)
  unsigned long long* astamps;  // [grid, ATT_STAMPS] or null
  int kv, g, dh, T, n_blk, nmax, slots, team, slot_bytes, lda_o, act_min;
  float sm_scale;
};


// A slot's bytes: k rows, v rows, k scales, v scales, bias, the scores [g][128]
// f32, per-q-row stats [6][8] f32, q8 [g][dh], p8 [g][128], the team's
// warps' parts (maxima, maxima of p * vs, double sums: [W_MAX][8] each)
__host__ __device__ inline int slot_bytes(int dh, int g) {
  return 256 * dh + 1024 + 512 * g + 256 + align16(g * dh) + 128 * g + 16 * W_MAX * 8;
}

// The o-projection's shared bytes (in the activation region): o8 rows at
// stride lda_o, the heads' f32 parts [kc / dh][16][RED_ROW] for the largest
// tile (KC_MAX rows), os [b][H]; and at least one attention slot
__host__ __device__ inline int layer_act_min(int b, int H, int dh, int g) {
  const int op = align16(b * (H * dh + 16)) + (KC_MAX / dh) * 16 * RED_ROW * 4 + b * H * 4;
  const int sl = slot_bytes(dh, g);
  return op > sl ? op : sl;
}

__device__ __forceinline__ void att_stamp(const LayerArgs& a, int i) {
  if (a.astamps != nullptr && threadIdx.x == 0) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    a.astamps[blockIdx.x * ATT_STAMPS + i] = t;
  }
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// the slot's copies landed (past ~2^26 polls, over a second, a fault in the
// plan or the copies traps instead of hanging the card)
__device__ __forceinline__ void slot_wait(uint32_t bar, int parity) {
  for (unsigned polls = 0;; ++polls) {
    uint32_t done;
    asm volatile(
        "{\n"
        ".reg .pred P1;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 P1, [%1], %2;\n"
        "selp.u32 %0, 1, 0, P1;\n"
        "}\n" : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (polls > (1u << 26)) __trap();
  }
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// The pair's blocks merged in order, then the current token, for q rows
// gi0, gi0 + gstep, ...; each q head's outputs quantized per row into o8
// and os. Run by the warps of the team of the pair's last item.
__device__ __noinline__ void merge_pair(const LayerArgs& a, int pc, const float* s_news, int gi0,
                                        int gstep) {
  const int lane = threadIdx.x & 31;
  const int g = a.g, dh = a.dh, H = a.kv * g, per = dh / 32;
  const int row = pc / a.kv, kvh = pc - row * a.kv;
  for (int gi = gi0; gi < g; gi += gstep) {
    const float s_new = s_news[gi];
    float vn[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) vn[k] = k < per ? a.v_new[(long long)pc * dh + lane + 32 * k] : 0.0f;
    // the blocks in order, MERGE_R a round trip: each block's (m, l) and
    // the lane's columns of its acc loaded before any is used
    float M = -1e30f, Ls = 0.0f, A[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int r0 = 0; r0 < a.n_blk; r0 += MERGE_R) {
      float mr[MERGE_R], lr[MERGE_R], ar[MERGE_R][4];
#pragma unroll
      for (int j = 0; j < MERGE_R; ++j) {
        if (r0 + j < a.n_blk) {
          const long long base = ((long long)pc * a.nmax + r0 + j) * g + gi;
          mr[j] = __ldcg(a.pm + base);
          lr[j] = __ldcg(a.pl + base);
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            ar[j][k] = k < per ? __ldcg(a.pacc + base * dh + lane + 32 * k) : 0.0f;
          }
        }
      }
#pragma unroll
      for (int j = 0; j < MERGE_R; ++j) {
        if (r0 + j < a.n_blk) {
          const float cf = expf(__fsub_rn(M, mr[j]));
#pragma unroll
          for (int k = 0; k < 4; ++k) A[k] = __fadd_rn(__fmul_rn(A[k], cf), ar[j][k]);
          Ls = __fadd_rn(__fmul_rn(Ls, cf), lr[j]);
          M = mr[j];
        }
      }
    }
    const float mf = fmaxf(M, s_new);
    const float cf = expf(__fsub_rn(M, mf)), pn = expf(__fsub_rn(s_new, mf));
    const float lf = fmaxf(__fadd_rn(__fmul_rn(Ls, cf), pn), 1e-30f);
    float o[4];
    float amax = 0.0f;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      o[k] = 0.0f;
      if (k < per) {
        const float num = __fadd_rn(__fmul_rn(A[k], cf), __fmul_rn(pn, vn[k]));
        o[k] = __fdiv_rn(num, lf);
        amax = fmaxf(amax, fabsf(o[k]));
      }
    }
    amax = warp_max(amax);
    const float osc = quant_scale(amax);
    const int head = kvh * g + gi;
    int8_t* dst = a.o8 + ((long long)row * H + head) * dh;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (k < per) dst[lane + 32 * k] = (int8_t)quant(o[k], osc);
    }
    if (lane == 0) a.os[row * H + head] = osc;
  }
}

// The warps of an attention team meet (named barrier 1 + team; one warp:
// __syncwarp).
__device__ __forceinline__ void team_sync(int team, int W) {
  if (W == 1) {
    __syncwarp();
  } else {
    asm volatile("bar.sync %0, %1;\n" :: "r"(1 + team), "r"(32 * W) : "memory");
  }
}

// One attention item on a team of W warps (wt: this warp's place in it):
// pair pc's 128-slot block j, in the slot at sb (its two mbarriers at bar,
// in phase `parity`). The team's first warp (the leader) quantizes q, asks
// for the bytes, publishes the block max, waits for the earlier blocks',
// publishes (m_j, l_j) and merges; the scores, p and p8 are split over the
// warps by rows, p8 . v by columns.
__device__ __noinline__ void attn_item(const LayerArgs& a, int pc, int j, unsigned char* sb,
                                       uint32_t bar, int parity, bool first, int team, int W,
                                       int wt) {
  const int lane = threadIdx.x & 31;
  const bool lead = wt == 0;
  const int g = a.g, dh = a.dh, T = a.T, BC = a.t.b * a.kv;
  const int row = pc / a.kv;
  const long long lrow = (long long)a.t.layer * BC + pc;
  const long long s0 = (long long)j * TBLK;
  int8_t* kb = reinterpret_cast<int8_t*>(sb);
  int8_t* vb = kb + TBLK * dh;
  const __nv_bfloat16* ksb = reinterpret_cast<const __nv_bfloat16*>(sb + 256 * dh);
  const __nv_bfloat16* vsb = ksb + TBLK;
  const float* bb = reinterpret_cast<const float*>(sb + 256 * dh + 512);
  float* sc = reinterpret_cast<float*>(sb + 256 * dh + 1024);          // [g][128]
  // per q row: [0, 8) qs * sm, [8, 16) block max, [16, 24) m_j, [24, 32) l_j,
  // [32, 40) ps, [40, 48) the current token's score
  float* st = sc + g * TBLK;
  int8_t* q8 = reinterpret_cast<int8_t*>(st + 64);                     // [g][dh]
  int8_t* p8 = q8 + align16(g * dh);                                   // [g][128]
  // the warps' parts: [W_MAX][8] maxima, [W_MAX][8] p * vs maxima, [W_MAX][8] sums of p
  float* wmax = reinterpret_cast<float*>(p8 + g * TBLK);
  float* wpmax = wmax + W_MAX * MAX_G;
  double* wsum = reinterpret_cast<double*>(wpmax + W_MAX * MAX_G);
  const int R = TBLK / W;            // rows a warp takes: wt * R + lane + 32 i
  const int r0 = wt * R;

  if (lead) {
    // 0. the block's k rows, scales and bias by the copy engine (its v rows
    // after the scores, on a second mbarrier), marked to leave L2 first: the
    // cache is read once, and the kernel's code and the layer's small
    // inputs stay there
    if (lane == 0) {
      const uint64_t pol = evict_first_policy();
      fence_proxy_async();   // the slot's earlier reads before the copies
      mbar_expect_tx(bar, 128 * dh + 1024);
      bulk_load_hint(smem_u32(kb), a.k_all + (lrow * T + s0) * dh, TBLK * dh, bar, pol);
      bulk_load_hint(smem_u32(ksb), a.ks_all + lrow * T + s0, 2 * TBLK, bar, pol);
      bulk_load_hint(smem_u32(vsb), a.vs_all + lrow * T + s0, 2 * TBLK, bar, pol);
      bulk_load(smem_u32(bb), a.bias + (long long)row * T + s0, 4 * TBLK, bar);
    }
    // 1. q quantized per q row while the bytes are in flight, and the
    // current token's score for the merge (q . k_new in double, rounded once)
    const float* qb = a.q + (long long)pc * g * dh;
    const float* kn = a.k_new + (long long)pc * dh;
    for (int gi = 0; gi < g; ++gi) {
      float xv[4];
      float amax = 0.0f;
      double sd = 0.0;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int c = lane + 32 * k;
        xv[k] = c < dh ? qb[gi * dh + c] : 0.0f;
        amax = fmaxf(amax, fabsf(xv[k]));
        if (c < dh) sd += (double)xv[k] * (double)kn[c];
      }
      amax = warp_max(amax);
      sd = warp_sum(sd);
      const float qs = quant_scale(amax);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int c = lane + 32 * k;
        if (c < dh) q8[gi * dh + c] = (int8_t)quant(xv[k], qs);
      }
      if (lane == 0) {
        st[gi] = __fmul_rn(qs, a.sm_scale);
        st[40 + gi] = __fmul_rn((float)sd, a.sm_scale);
      }
    }
  }
  team_sync(team, W);   // q8 and its scales
  slot_wait(bar, parity);
  if (first && lead) att_stamp(a, 1);


  // 2. the scores of the warp's rows, and their max per q row: lane l takes
  // rows r0 + l + 32 i, a row's 16-byte chunks from chunk (l >> sh) on, so
  // that the 8 lanes of a quarter-warp read 8 distinct bank groups
  const int nch = dh >> 4;
  const int sh = nch == 2 ? 2 : nch == 4 ? 1 : 0;
  for (int gi = 0; gi < g; ++gi) {
    const float qss = st[gi];
    float mx = -INFINITY;
    for (int i = 0; i < R / 32; ++i) {
      const int r = r0 + lane + 32 * i;
      int dot = 0;
      for (int c = 0; c < nch; ++c) {
        const int ch = (c + (lane >> sh)) & (nch - 1);
        const uint4 kw = *reinterpret_cast<const uint4*>(kb + r * dh + 16 * ch);
        const uint4 qw = *reinterpret_cast<const uint4*>(q8 + gi * dh + 16 * ch);
        dot = __dp4a((int)kw.x, (int)qw.x, dot);
        dot = __dp4a((int)kw.y, (int)qw.y, dot);
        dot = __dp4a((int)kw.z, (int)qw.z, dot);
        dot = __dp4a((int)kw.w, (int)qw.w, dot);
      }
      const float sv = __fadd_rn(__fmul_rn(__fmul_rn(__int2float_rn(dot), qss),
                                           __bfloat162float(ksb[r])), bb[r]);
      sc[gi * TBLK + r] = sv;
      mx = fmaxf(mx, sv);
    }
    mx = warp_max(mx);
    if (lane == 0) wmax[wt * MAX_G + gi] = mx;
  }
  team_sync(team, W);   // the warps' maxima
  if (first && lead) att_stamp(a, 2);

  // 3. the block max out; the prefix max of the pair's earlier blocks, once
  // their flags are up (the leader)
  if (lead) {
    if (lane < g) {
      float mx = wmax[lane];
      for (int w = 1; w < W; ++w) mx = fmaxf(mx, wmax[w * MAX_G + lane]);
      st[8 + lane] = mx;
      a.bmax[((long long)pc * a.nmax + j) * g + lane] = mx;
    }
    __syncwarp();
    if (lane == 0) {
      __threadfence();
      atomicExch(a.flags + (long long)pc * a.nmax + j, 1u);
      // the v rows now: asked for with the k rows, they landed together and
      // the scores waited for both; p8 . v comes after the prefix max
      mbar_expect_tx(bar + 8, 128 * dh);
      bulk_load_hint(smem_u32(vb), a.v_all + (lrow * T + s0) * dh, TBLK * dh, bar + 8,
                     evict_first_policy());
    }
    if (j > 0) {
      const unsigned* fl = a.flags + (long long)pc * a.nmax;
      for (unsigned polls = 0;; ++polls) {
        bool ok = true;
        for (int jj = lane; jj < j; jj += 32) ok = ok && ld_acquire(fl + jj) != 0u;
        if (__all_sync(0xffffffffu, ok)) break;
        if (polls > (1u << 24)) __trap();   // over a second: a fault, not a wait
        __nanosleep(64);
      }
      __threadfence();
    }
    for (int gi = 0; gi < g; ++gi) {
      float mp = -1e30f;
      for (int jj = lane; jj < j; jj += 32) {
        mp = fmaxf(mp, __ldcg(a.bmax + ((long long)pc * a.nmax + jj) * g + gi));
      }
      mp = warp_max(mp);
      if (lane == 0) st[16 + gi] = fmaxf(mp, st[8 + gi]);
    }
  }
  team_sync(team, W);   // m_j
  if (first && lead) att_stamp(a, 3);

  // 4. p = exp(s - m_j) of the warp's rows: its sum (in double) and the
  // max of p * vs; then, with the block's max, ps and p8
  for (int gi = 0; gi < g; ++gi) {
    const float mj = st[16 + gi];
    double psd = 0.0;
    float pmax = 0.0f;
    for (int i = 0; i < R / 32; ++i) {
      const int r = r0 + lane + 32 * i;
      const float p = expf(__fsub_rn(sc[gi * TBLK + r], mj));
      psd += (double)p;
      pmax = fmaxf(pmax, __fmul_rn(p, __bfloat162float(vsb[r])));
    }
    psd = warp_sum(psd);
    pmax = warp_max(pmax);
    if (lane == 0) {
      wsum[wt * MAX_G + gi] = psd;
      wpmax[wt * MAX_G + gi] = pmax;
    }
  }
  team_sync(team, W);   // the warps' sums and maxima
  for (int gi = 0; gi < g; ++gi) {
    const float mj = st[16 + gi];
    float pmax = wpmax[gi];
    for (int w = 1; w < W; ++w) pmax = fmaxf(pmax, wpmax[w * MAX_G + gi]);
    const float ps = fmaxf(__fdiv_rn(pmax, 127.0f), 1e-20f);
    for (int i = 0; i < R / 32; ++i) {
      const int r = r0 + lane + 32 * i;
      // the v scales folded in before quantizing
      const float pv = __fmul_rn(expf(__fsub_rn(sc[gi * TBLK + r], mj)),
                                 __bfloat162float(vsb[r]));
      p8[gi * TBLK + r] = (int8_t)quant(pv, ps);
    }
    if (lead && lane == 0) {
      double sum = wsum[gi];
      for (int w = 1; w < W; ++w) sum += wsum[w * MAX_G + gi];
      st[24 + gi] = (float)sum;
      st[32 + gi] = ps;
    }
  }
  team_sync(team, W);   // p8, l_j and ps
  slot_wait(bar + 8, parity);   // the v rows

  // 5. p8 . v in int32 over the warp's words of each v row: lane (wl, h)
  // takes word wl of the rows of row groups h, h + S, ... (4 rows each,
  // transposed to column words); subset h reads a group's rows rotated by h
  // (distinct banks) and rotates the p8 word alike, a dot over the same
  // four rows in another order
  const int nww = (dh >> 2) / W, S = 32 / nww;   // words a warp, row subsets
  const int wl = wt * nww + (lane & (nww - 1)), h = lane / nww;
  const uint32_t rot = (h & 3) | (((h + 1) & 3) << 4) | (((h + 2) & 3) << 8) |
                       (((h + 3) & 3) << 12);
  for (int gi = 0; gi < g; ++gi) {
    int o0 = 0, o1 = 0, o2 = 0, o3 = 0;
    for (int gq = h; gq < TBLK / 4; gq += S) {
      uint32_t w[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        w[k] = *reinterpret_cast<const uint32_t*>(vb + (4 * gq + ((k + h) & 3)) * dh + 4 * wl);
      }
      uint32_t c0, c1, c2, c3;
      transpose4(w, c0, c1, c2, c3);
      const uint32_t pw =
          __byte_perm(*reinterpret_cast<const uint32_t*>(p8 + gi * TBLK + 4 * gq), 0u, rot);
      o0 = __dp4a((int)c0, (int)pw, o0);
      o1 = __dp4a((int)c1, (int)pw, o1);
      o2 = __dp4a((int)c2, (int)pw, o2);
      o3 = __dp4a((int)c3, (int)pw, o3);
    }
    for (int off = nww; off < 32; off <<= 1) {
      o0 += __shfl_xor_sync(0xffffffffu, o0, off);
      o1 += __shfl_xor_sync(0xffffffffu, o1, off);
      o2 += __shfl_xor_sync(0xffffffffu, o2, off);
      o3 += __shfl_xor_sync(0xffffffffu, o3, off);
    }
    if (lane < nww) {
      const float ps = st[32 + gi];
      *reinterpret_cast<float4*>(a.pacc + (((long long)pc * a.nmax + j) * g + gi) * dh + 4 * wl) =
          make_float4(__fmul_rn(__int2float_rn(o0), ps), __fmul_rn(__int2float_rn(o1), ps),
                      __fmul_rn(__int2float_rn(o2), ps), __fmul_rn(__int2float_rn(o3), ps));
    }
  }
  if (first && lead) att_stamp(a, 4);

  // 6. (m_j, l_j) out; the pair's last item merges, its q rows over the
  // team's warps
  if (lead && lane < g) {
    const long long base = ((long long)pc * a.nmax + j) * g + lane;
    a.pm[base] = st[16 + lane];
    a.pl[base] = st[24 + lane];
  }
  __threadfence();
  team_sync(team, W);   // the team's writes, and the slot read
  unsigned* last = reinterpret_cast<unsigned*>(st + 48);
  if (lead && lane == 0) *last = atomicAdd(a.cnt + pc, 1u) == (unsigned)(a.n_blk - 1);
  team_sync(team, W);
  if (*last) {
    __threadfence();
    merge_pair(a, pc, st + 40, wt, W);
    __threadfence();   // the pair's o8 and scales before the count
    team_sync(team, W);
    if (lead) {
      // every item of the pair has passed its waits and counted itself
      for (int jj = lane; jj < a.n_blk; jj += 32) a.flags[(long long)pc * a.nmax + jj] = 0u;
      if (lane == 0) {
        a.cnt[pc] = 0u;
        atomicAdd(a.merged, 1u);
      }
    }
  }
  team_sync(team, W);   // st (the merge's s_new) read before the next item's
}

__global__ void __launch_bounds__(NT, 1)
    decode_layer_kernel(const __grid_constant__ LayerArgs la, const __grid_constant__ Maps m) {
  extern __shared__ __align__(1024) unsigned char smem[];
  const TailArgs& a = la.t;
  const int b = a.b, d = a.d, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const Layout lo = layout(b, 1, a.lda, d, a.max_gu, a.max_items, a.F / a.tile, a.stages, a.kc,
                           la.act_min, 2 * MAX_SLOTS);
  const TailSmem s = tail_smem<1>(smem, lo);
  stamp(a, 0);
  att_stamp(la, 0);
  if (tid == 0) {
    for (int i = 0; i < 2 * la.slots; ++i) mbar_init(smem_u32(smem + lo.abars) + 8 * i, 1);
  }
  TileRing rg = tail_ring(a, smem, lo);   // (fences the mbarriers' init, __syncthreads)
  tail_small_inputs(a, s, rg);   // (past the attention's slots: asked for now)
  // the block's first Wo or gate | up tile now: it lands while the cache is
  // read (more would slow the cache's bytes down)
  rg.cap = 1;
  request(a, m, rg);

  // ── attention: item i = j * BC + pair on block i % grid, team (i / grid) %
  // slots of la.team warps ──
  const int BC = b * la.kv, n_att = BC * la.n_blk;
  const int team = warp / la.team, wt = warp - team * la.team;
  if (team < la.slots) {
    unsigned char* sb = smem + lo.ring + a.kc * SLAB + team * la.slot_bytes;   // (below lo.vec)
    const uint32_t bar = smem_u32(smem + lo.abars) + 16 * team;   // k's, then v's
    int round = 0;
    for (int i = blockIdx.x + gridDim.x * team; i < n_att; i += gridDim.x * la.slots, ++round) {
      attn_item(la, i % BC, i / BC, sb, bar, round & 1, round == 0, team, la.team, wt);
      if (round == 0 && wt == 0) att_stamp(la, 5);
    }
  }
  // the slots' bytes become ring stages and the tail's regions
  fence_proxy_async();
  __syncthreads();
  att_stamp(la, 6);
  // an o-projection block asks for its Wo tiles alone now (each request
  // holds the asking thread ~0.7 us: the rest waits for the o-projection's
  // end), the others for every tile the ring holds (they wait for barrier
  // 1, and the MLP norm then finds its ring full)
  const bool oproj = rg.n_items > 0 && (rg.items[0] >> 24) == 0;
  rg.cap = oproj ? 0 : 3;
  fill(a, m, rg);
  rg.cap = oproj ? 1 : 3;
  tail_reset<1>(a, s);
  att_stamp(la, 7);
  wait_first();

  // ── the o-projection per q head + residual: x2 ──
  const int H = la.kv * la.g, dh = la.dh, da = a.d_attn;
  const int nh = a.kc / dh, sph = dh / 32;
  float* parts = reinterpret_cast<float*>(smem + lo.act + align16(b * la.lda_o));  // [nh][16][RED_ROW]
  float* os_s = parts + nh * 16 * RED_ROW;                                         // [b][H]
  const int* items = rg.items;
  const int n_items = rg.n_items;
  int it = 0;
  int acc[1][4][4];
  zero_acc(acc);
  if (it < n_items && (items[it] >> 24) == 0) {
    // every pair's o8 and scales are out (no grid barrier: the other blocks
    // go on to barrier 1)
    if (tid == 0) {
      for (unsigned polls = 0; ld_acquire(la.merged) < (unsigned)BC; ++polls) {
        if (polls > (1u << 24)) __trap();   // over a second: a fault, not a wait
        __nanosleep(32);
      }
      __threadfence();
    }
    __syncthreads();
    att_stamp(la, 8);
    const int w16 = da / 16;
    for (int i = tid; i < b * w16; i += NT) {
      const int r = i / w16, c = i - r * w16;
      *reinterpret_cast<int4*>(s.act + r * la.lda_o + 16 * c) =
          __ldcg(reinterpret_cast<const int4*>(la.o8 + (long long)r * da) + c);
    }
    for (int i = tid; i < b * H; i += NT) os_s[i] = __ldcg(la.os + i);
    __syncthreads();
    att_stamp(la, 10);
  }
  // (the plan keeps an item's Wo tiles all in the ring: no refill here)
  for (; it < n_items && (items[it] >> 24) == 0; ++it) {
    const int c0 = SLAB * (items[it] & 0xffffff);
    float y = 0.0f;   // element tid of [b][32]
    for (int jt = 0; jt < da / a.kc; ++jt) {
      const uint32_t t = wait_tile(a, rg);
      if (jt == 0) att_stamp(la, 11);
      for (int hh = warp; hh < nh; hh += NWARP) {
        int hacc[1][4][4];
        zero_acc(hacc);
        for (int st = hh * sph; st < (hh + 1) * sph; ++st) {
          mma_step<1>(t, st, s.act_s, la.lda_o, b, jt * a.kc, hacc);
        }
        // lane (g8, t4) of n8 tile jn: rows g8 and g8 + 8 at slab columns
        // 8 t4 + jn and 8 t4 + 4 + jn
        const int head = jt * nh + hh, g8 = lane >> 2, t4 = lane & 3;
        float* ph = parts + hh * 16 * RED_ROW;
#pragma unroll
        for (int jn = 0; jn < 4; ++jn) {
          if (g8 < b) {
            const float sv = os_s[g8 * H + head];
            ph[g8 * RED_ROW + 8 * t4 + jn] = __fmul_rn(__int2float_rn(hacc[0][jn][0]), sv);
            ph[g8 * RED_ROW + 8 * t4 + 4 + jn] = __fmul_rn(__int2float_rn(hacc[0][jn][1]), sv);
          }
          if (g8 + 8 < b) {
            const float sv = os_s[(g8 + 8) * H + head];
            ph[(g8 + 8) * RED_ROW + 8 * t4 + jn] = __fmul_rn(__int2float_rn(hacc[0][jn][2]), sv);
            ph[(g8 + 8) * RED_ROW + 8 * t4 + 4 + jn] =
                __fmul_rn(__int2float_rn(hacc[0][jn][3]), sv);
          }
        }
      }
      __syncthreads();   // every head's part is written
      if (jt == 0) att_stamp(la, 12);
      ++rg.next;
      if (tid < b * SLAB) {
        const int r = tid / SLAB, c = tid % SLAB;
        for (int hh = 0; hh < nh; ++hh) {
          const float p = parts[(hh * 16 + r) * RED_ROW + c];
          y = jt == 0 && hh == 0 ? p : __fadd_rn(y, p);   // heads in ascending order
        }
      }
      __syncthreads();   // the parts are read before the next tile's
    }
    if (tid < b * SLAB) {
      const int r = tid / SLAB, c = tid % SLAB;
      const unsigned char* xr = reinterpret_cast<const unsigned char*>(s.cols + it * b * SLAB);
      a.x2[(long long)r * d + c0 + c] = __fadd_rn(load_f(xr + r * TAIL_COL_ROW, a.x_kind, c),
                                                  __fmul_rn(y, s.vec[it * 2 * SLAB + c]));
    }
    __syncthreads();
  }
  fill(a, m, rg);   // an o-projection block's other tiles
  att_stamp(la, 9);
  tail_after_x2<1>(a, m, rg, s, it, acc);
  // every block passed barrier 1 after its o-projection: the count is free
  if (blockIdx.x == 0 && tid == 0) *la.merged = 0u;
}

long long a256(long long n) { return (n + 255) / 256 * 256; }

bool shapes_ok(int b, int kv, int g, int dh, int T, int D, int F, int tile, int Q) {
  const int da = kv * g * dh;
  return b >= 1 && b <= MAX_B && kv >= 1 && g >= 1 && g <= MAX_G &&
         (dh == 32 || dh == 64 || dh == 128) && T >= TBLK && T % TBLK == 0 && da <= TAIL_MAX_D &&
         D >= 32 && D % 32 == 0 && D <= TAIL_MAX_D && F >= 32 && F % 32 == 0 && tile >= 32 &&
         tile % 32 == 0 && F % tile == 0 && Q >= 32 && Q % 32 == 0 && F < (1 << 24) &&
         Q < (1 << 24);
}

}  // namespace

// The shared bytes of a launch (layout with the o-projection's and the
// attention slots' needs); -1 for a shape the kernel does not take.
extern "C" int vt_decode_layer_smem(int b, int kv, int g, int dh, int D, int F, int tile,
                                    int max_gu, int max_items, int stages, int kc) {
  if (!shapes_ok(b, kv, g, dh, TBLK, D, F, tile, 32) || stages < 1 || stages > MAX_STAGES ||
      kc < dh || kc % dh || kc % 32 || kc > KC_MAX || (kv * g * dh) % kc || D % kc || tile % kc || max_gu < 0 ||
      max_items < max_gu) {
    return -1;
  }
  const int H = kv * g;
  return layout(b, 1, tail_lda(H * dh, D, F), D, max_gu, max_items, F / tile, stages, kc,
                layer_act_min(b, H, dh, g), 2 * MAX_SLOTS).total;
}

// The workspace: the tail's (x2, the quantized hidden, its amax, a
// counter), o8 and its scales, the attention items' block maxima, (m, l,
// acc) and flags, the pairs' counters, the count of merged pairs. Flags
// and counters start at zero (the caller's first allocation) and every
// launch leaves them so.
extern "C" long long vt_decode_layer_workspace(int b, int kv, int g, int dh, int T, int D, int F,
                                               int tile) {
  if (b < 1 || kv < 1 || g < 1 || dh < 1 || T < TBLK || D < 1 || F < 1 || tile < 1 || F % tile) {
    return -1;
  }
  const long long BC = (long long)b * kv, H = (long long)kv * g, nmax = T / TBLK;
  return a256((long long)b * D * 4) + a256((long long)b * F) + a256((long long)b * (F / tile) * 4) +
         256 + a256(b * H * dh) + a256(b * H * 4) + 3 * a256(BC * nmax * g * 4) +
         a256(BC * nmax * g * dh * 4) + a256(BC * nmax * 4) + a256(BC * 4) + 256;
}

// The largest grid a cooperative launch of the kernel accepts at `smem`
// dynamic shared bytes (SMs x resident blocks), or -cudaError.
extern "C" int vt_decode_layer_max_blocks(int smem) {
  static int allowed[64];
  int rc = allow_smem_once((const void*)decode_layer_kernel, allowed);
  if (rc) return -rc;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, decode_layer_kernel, NT, smem);
  }
  return e == cudaSuccess ? sms * per_sm : -(int)e;
}

// B12: one cooperative launch of `grid` blocks for layer `layer`. n_blk: the
// 128-slot blocks of the cache to read (>= 1). plan: the item table
// (ops/decode_layer.py layer_plan, on the device, `grid` blocks); kc, stages,
// max_gu, max_items, gu_blocks and smem: its tile rows, ring depth, gate | up
// items and items a block at most, blocks with gate | up items and shared
// bytes (checked against vt_decode_layer_smem). The attention's split, as
// the plan chose it for n_blk (layer_attn_split, layer_attn_team): `slots`
// teams a block of `team` warps each, a slot of `slot` shared bytes, the
// slots' room ending at `slot_end`; refused where they disagree with this
// kernel's layout (slot_bytes, the layout's column scales) or do not fit
// its warps, barriers or that room. stamps: null, or [grid, 12 + 64 + 13]
// u64: the tail's phase points and tiles as in vt_tail_swiglu_qkv_int8, then
// the attention's ATT_STAMPS. Every input starts on a 16-byte boundary.
extern "C" int vt_decode_layer(
    const void* q, const void* x, const void* k_all, const void* v_all, const void* k_scale,
    const void* v_scale, const void* bias, const void* k_new, const void* v_new,
    const void* wo, const void* wos, const void* mw, const void* wgu, const void* sgu,
    const void* wd, const void* sd, const void* nw, const void* wq, const void* sq,
    void* x_out, void* qkv_out, int norm_kind, int L, int layer, int b, int kv, int g, int dh,
    int T, int n_blk, int D, int F, int tile, int Q, float sm_scale, float eps, void* ws,
    long long ws_bytes, const void* plan, int grid, int kc, int stages, int max_gu, int max_items,
    int gu_blocks, int smem, int slots, int team, int slot, int slot_end, void* stamps,
    void* stream) {
  if (!shapes_ok(b, kv, g, dh, T, D, F, tile, Q) || L < 1 || layer < 0 || layer >= L ||
      n_blk < 1 || n_blk > T / TBLK || norm_kind == KIND_NONE || plan == nullptr || grid < 1 ||
      gu_blocks < 1 || gu_blocks > grid ||
      smem != vt_decode_layer_smem(b, kv, g, dh, D, F, tile, max_gu, max_items, stages, kc) ||
      kv * g * dh > stages * kc ||   // an o-projection item's Wo tiles all in the ring
      smem > TAIL_SMEM_MAX ||
      ws_bytes < vt_decode_layer_workspace(b, kv, g, dh, T, D, F, tile)) {
    return (int)cudaErrorInvalidValue;
  }
  const void* aligned[] = {q, x, k_all, v_all, k_scale, v_scale, bias, k_new, v_new, wo, wos,
                           mw, wgu, sgu, wd, sd, nw, wq, sq, ws};
  for (const void* p : aligned) {
    if ((uintptr_t)p % 16 != 0) return (int)cudaErrorMisalignedAddress;
  }
  const int H = kv * g, BC = b * kv, nmax = T / TBLK;
  LayerArgs la;
  TailArgs& a = la.t;
  a.attn = nullptr;
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
  p += a256((long long)b * D * 4);
  a.hq = (int8_t*)p;
  p += a256((long long)b * F);
  a.amax = (unsigned*)p;
  p += a256((long long)b * (F / tile) * 4);
  a.normed = (unsigned*)p;
  p += 256;
  la.o8 = (int8_t*)p;
  p += a256((long long)b * H * dh);
  la.os = (float*)p;
  p += a256((long long)b * H * 4);
  la.bmax = (float*)p;
  p += a256((long long)BC * nmax * g * 4);
  la.pm = (float*)p;
  p += a256((long long)BC * nmax * g * 4);
  la.pl = (float*)p;
  p += a256((long long)BC * nmax * g * 4);
  la.pacc = (float*)p;
  p += a256((long long)BC * nmax * g * dh * 4);
  la.flags = (unsigned*)p;
  p += a256((long long)BC * nmax * 4);
  la.cnt = (unsigned*)p;
  p += a256((long long)BC * 4);
  la.merged = (unsigned*)p;
  a.stamps = (unsigned long long*)stamps;
  la.astamps = stamps ? (unsigned long long*)stamps + (long long)grid * (TAIL_STAMPS + TAIL_TILE_STAMPS)
                      : nullptr;
  a.x_kind = KIND_F32;
  a.norm_kind = norm_kind;
  a.layer = layer;
  a.nxt = layer + 1 < L ? layer + 1 : L - 1;
  a.b = b;
  a.d_attn = H * dh;
  a.d = D;
  a.F = F;
  a.tile = tile;
  a.Q = Q;
  a.kc = kc;
  a.stages = stages;
  a.lda = tail_lda(H * dh, D, F);
  a.max_gu = max_gu;
  a.max_items = max_items;
  a.gu_blocks = gu_blocks;
  a.eps = eps;
  la.q = (const float*)q;
  la.k_all = (const int8_t*)k_all;
  la.v_all = (const int8_t*)v_all;
  la.ks_all = (const __nv_bfloat16*)k_scale;
  la.vs_all = (const __nv_bfloat16*)v_scale;
  la.bias = (const float*)bias;
  la.k_new = (const float*)k_new;
  la.v_new = (const float*)v_new;
  la.kv = kv;
  la.g = g;
  la.dh = dh;
  la.T = T;
  la.n_blk = n_blk;
  la.nmax = nmax;
  la.slot_bytes = slot_bytes(dh, g);
  la.lda_o = H * dh + 16;
  la.act_min = layer_act_min(b, H, dh, g);
  la.sm_scale = sm_scale;
  const Layout lo = layout(b, 1, a.lda, D, max_gu, max_items, F / tile, stages, kc, la.act_min,
                           2 * MAX_SLOTS);
  // the split: teams of 1, 2 or 4 warps (at most a v row's words each) that
  // the block's warps hold, each slot past the ring's first stage and below
  // the column scales
  if (slot != la.slot_bytes || slot_end != lo.vec || slots < 1 || slots > MAX_SLOTS ||
      (team != 1 && team != 2 && team != 4) || team > dh / 4 ||
      slots * team > NWARP || kc * SLAB + slots * slot > slot_end) {
    return (int)cudaErrorInvalidValue;
  }
  la.slots = slots;
  la.team = team;
  Maps maps;
  int rc = tail_maps(wo, wgu, wd, wq, L, H * dh, D, F, Q, kc, &maps);
  if (rc) return rc;
  static int allowed[64];
  rc = allow_smem_once((const void*)decode_layer_kernel, allowed);
  if (rc) return rc;
  void* params[] = {&la, &maps};
  const cudaError_t e = cudaLaunchCooperativeKernel((const void*)decode_layer_kernel, dim3(grid),
                                                    dim3(NT), params, (size_t)smem,
                                                    (cudaStream_t)stream);
  if (e != cudaSuccess) {
    cudaGetLastError();  // a refused launch leaves no sticky error; clear the last one
    return (int)e;
  }
  return (int)cudaGetLastError();
}
