// Flash-attention backward over [b, h, s, d] from the forward's saved
// logsumexp: B11b (dQ, with di = rowsum(o * dO)) and B11a (dK, dV), causal
// (start-aligned) or not, with GQA by head indexing.
//
// Replaces: vocalie_tts_tpu/ops/flash_attention_bwd.py::flash_attention_bwd
// (_dq_kernel and _dkv_kernel, via _fa_bwd, the custom VJP of
// flash_attention_trainable). Its numbers (_tile_ds):
//   * s = q.k in f32, times sm_scale; a masked score (a key after the
//     query, causal) has a probability of exactly 0, as the TPU's
//     "add _MASK_VALUE, exp, zero after" gives it;
//   * p = exp(s - lse) in f32, with lse from the forward (B6 with lse);
//   * dp = dO.v in f32; di = rowsum(o * dO) in f32 from the stored o and dO
//     (the TPU computes di outside its kernels; here B11b's prologue does,
//     and writes it for B11a, which runs after it on the same stream);
//   * ds = p * (dp - di) * sm_scale in f32;
//   * dV += p^T dO and dK += ds^T q with p and ds in f32; dQ += ds k with ds
//     rounded to the input type first (ds.astype(k.dtype), :140);
//   * f32 accumulators, the outputs cast to the input type once.
// Not copied: the TPU's padding to 128-row tiles (rows and keys past the
// sequence do not exist here) and the jnp.repeat of k/v heads for GQA:
// B11a's block owns one kv head's key tile and sweeps every q head of its
// group, so dK and dV are summed over the group in f32 inside the kernel and
// rounded once (the TPU rounds each q head's dK/dV to the input type and
// sums the group after the kernel, in that type, _fa_bwd :317-321). The two
// kernels keep JAX's two iteration orders (B11b fixes 64 query rows and
// sweeps keys, B11a fixes 64 keys and sweeps query rows): no atomics, and
// every sum is taken in one fixed order.
//
// Bound: bytes. At the T3 fine-tune's [8, 16, 512, 64] bf16 causal each
// kernel moves ~50.9 MB (q, k, v, o or the di rows, dO, lse, its outputs:
// 0.0152 ms at 3.35 TB/s); its products, 6 d (B11b: s, dp, dQ) and 8 d
// (B11a: s, dp, dV, dK) operations per visible (query, key) pair, are 6.5
// and 8.6 GFLOP, 6.5 and 8.7 us at 989 TFLOP/s on the bf16 tensor cores and
// ~100-130 us at 67 TFLOP/s on the f32 CUDA cores: off the tensor cores the
// products, not the bytes, set the time.
//
// Two bodies, chosen by dtype and d (ops/flash_attention_bwd.py
// ``flash_bwd_body`` makes the same choice):
//
// (1) bf16 at d 64 (the trainer's d_head) and 128 -- tc::flash_bwd_dq_tc_kernel
// and tc::flash_bwd_dkv_tc_kernel, every product on the Hopper tensor cores
// (wgmma.mma_async m64n64k16, f32 accumulators; the building blocks of
// wgmma.cuh, which B6's body uses too):
//   * one block = one warpgroup (128 threads). B11b owns 64 query rows of
//     one (b, h), the longest causal rows first; it loads Q and dO once and
//     streams K/V tiles of 64 keys through a two-stage cp.async ring (keys at
//     or past s_k zero-filled, causal tiles above the diagonal skipped). B11a
//     owns 64 keys of one (b, hk), key tile 0 (the most causal work) first;
//     it loads K and V once and streams, for each q head of the group, Q and
//     dO tiles of 64 rows with their lse and di (f32, 4-byte cp.async),
//     causal from the tile that holds its first key. Tiles are bf16 in
//     64-column panels of 128-byte rows with the 128-byte swizzle.
//   * B11b: S = Q.K^T and dP = dO.V^T (A and B K-major from shared memory;
//     V's rows are dP's columns), then p = exp2(s scale log2e - lse log2e)
//     and ds = p (dp - di) scale on the accumulator fragments, 0 past s_k
//     and (causal) past the row; ds rounded to bf16 is the register A of
//     dQ += dS.K (K as the MN-major B, as V in B6's O += P.V).
//   * B11a: S^T = K.Q^T and dP^T = V.dO^T (rows keys, columns queries: each
//     thread reads its 16 columns' lse and di from shared memory), p^T and
//     ds^T in f32 with the same masks (0 past s_q), then dV += P^T.dO and
//     dK += dS^T.Q with dO and Q as the MN-major B. JAX keeps p and ds in
//     f32 there (an f32 x bf16 dot promotes to f32); each is fed as two bf16
//     A operands, hi = bf16(x) and lo = bf16(x - hi), into two wgmmas that
//     share the B descriptor: 16 significand bits, where one bf16 rounding
//     of p and ds moves dK and dV several times further from JAX's gradient
//     (tests/test_torch_flash_attention_bwd.py emulates both at [2, 4, 128,
//     64] causal and prints the deviations). dV is finished with P's
//     fragments before dS's are built.
//   * dQ (B11b) and dK, dV (B11a, over the whole group sweep) are f32 in
//     registers, stored once as bf16. Dynamic shared memory: B11b 49 KB at
//     d 64 (97 KB at d 128), B11a 50 KB (98 KB), set by cudaFuncSetAttribute
//     and checked. ptxas (-Xptxas -v, sm_90a): B11b 146 registers at d 64,
//     191 at d 128; B11a 201 and 255; 0 spill bytes in all four.
//
// (2) f32, and bf16 at d 8, 16, 32 (the tiny test configurations and the
// f32 tiny train view) -- flash_bwd_dq_kernel and flash_bwd_dkv_kernel, the
// products on the CUDA cores in f32. Each row (a query row in B11b, a key
// row in B11a) is owned by SPLIT = D / DS adjacent lanes of one warp, each
// holding DS = min(D, 16) of the row's dims in registers (lane p owns dims
// p, p + SPLIT, ...). A score is each lane's partial dot summed over the
// row's lanes by a shuffle butterfly, so every lane holds the same bits.
//   B11b: one block per (b*h, 64-query tile), q, dO and the dQ accumulator
//   in registers; it walks 32-key tiles of k and v staged in shared memory
//   (as f32), each row stopping at its last visible key.
//   B11a: one block per (b*hk, 64-key tile), k, v and the dK, dV
//   accumulators in registers; for each q head of the group it walks
//   32-row chunks of q, dO, lse and di staged in shared memory (as f32),
//   from the tile's first key on when causal (earlier rows see none of it).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "wgmma.cuh"

// ── (1) the tensor-core bodies: bf16 at d 64 and 128 ─────────────────────

namespace tc {

constexpr int ROWS = 64;               // rows of every tile: one warpgroup's wgmma M and N

// B11b: one warpgroup owns 64 query rows of one (b, h). Q and dO are loaded
// once; K and V tiles of 64 keys stream through a two-stage cp.async ring.
// Per tile: S = Q.K^T and dP = dO.V^T (wgmma, both operands K-major from
// shared memory), p and ds in f32 on the accumulator fragments, ds rounded
// to bf16 into the A fragment, dQ += dS.K (K as the MN-major B).
template <int D>
constexpr int dq_smem_bytes() { return 6 * (D / 64) * PANEL + ROWS * 4 + 1024; }

template <int D>
__global__ void __launch_bounds__(THREADS) flash_bwd_dq_tc_kernel(
    const __nv_bfloat16* __restrict__ q,    // [b, h, s_q, D]
    const __nv_bfloat16* __restrict__ k,    // [b, hk, s_k, D]
    const __nv_bfloat16* __restrict__ v,    // [b, hk, s_k, D]
    const __nv_bfloat16* __restrict__ o,    // [b, h, s_q, D]
    const __nv_bfloat16* __restrict__ dO,   // [b, h, s_q, D]
    const float* __restrict__ lse,          // [b, h, s_q]
    __nv_bfloat16* __restrict__ dq,         // [b, h, s_q, D]
    float* __restrict__ di_out,             // [b, h, s_q]
    int h, int hk, int s_q, int s_k, int causal, float sm_scale) {
  constexpr int NP = D / 64;               // 64-column panels of d
  constexpr int TILE = NP * PANEL;         // bytes of one 64-row tile
  extern __shared__ uint8_t smem_raw[];
  // the swizzle is a function of the address: panels on 1024-byte boundaries
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t q_s = base, do_s = base + TILE;
  // stage st: K at base + TILE (2 + 2 st), V at base + TILE (3 + 2 st)
  float* di_s = reinterpret_cast<float*>(smem_raw + (base - raw) + 6 * TILE);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int bh = blockIdx.y;
  const int bi = bh / h, hkv = (bh - bi * h) / (h / hk);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * ROWS;   // the longest causal rows first
  const int q_last = min(q0 + ROWS, s_q) - 1;
  const int k_end = causal ? min(s_k, q_last + 1) : s_k;   // keys any row here sees
  const int n_tiles = (k_end + ROWS - 1) / ROWS;

  const __nv_bfloat16* kb = k + (long long)(bi * hk + hkv) * s_k * D;
  const __nv_bfloat16* vb = v + (long long)(bi * hk + hkv) * s_k * D;
  auto load_kv = [&](int j) {
    const uint32_t st = base + TILE * (2 + 2 * (j & 1));
    load_tile<D>(st, kb + (long long)j * ROWS * D, s_k - j * ROWS, tid);
    load_tile<D>(st + TILE, vb + (long long)j * ROWS * D, s_k - j * ROWS, tid);
  };
  // groups: {Q, dO, tile 0}, {tile 1}, then one per tile j + 2 (some empty)
  const long long row0 = (long long)bh * s_q + q0;
  load_tile<D>(q_s, q + row0 * D, s_q - q0, tid);
  load_tile<D>(do_s, dO + row0 * D, s_q - q0, tid);
  if (n_tiles > 0) load_kv(0);
  cp_async_commit();
  if (n_tiles > 1) load_kv(1);
  cp_async_commit();

  // di = rowsum(o * dO) in f32 while the tiles load: two threads a row, D/2
  // columns each, 16-byte loads; written for B11a
  {
    const int row = tid >> 1;
    float acc = 0.0f;
    if (q0 + row < s_q) {
      const long long off = (row0 + row) * D + (tid & 1) * (D / 2);
      const uint4* op = reinterpret_cast<const uint4*>(o + off);
      const uint4* dp = reinterpret_cast<const uint4*>(dO + off);
#pragma unroll
      for (int i = 0; i < D / 16; ++i) {
        const uint4 a = op[i], b = dp[i];
        const uint32_t aw[4] = {a.x, a.y, a.z, a.w}, bw[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          const float2 af = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&aw[w]));
          const float2 bf = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&bw[w]));
          acc = fmaf(af.x, bf.x, acc);
          acc = fmaf(af.y, bf.y, acc);
        }
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if ((tid & 1) == 0) {
      di_s[row] = acc;
      if (q0 + row < s_q) di_out[row0 + row] = acc;
    }
  }
  __syncthreads();

  // this thread's rows r0 and r0 + 8 (the accumulator's layout)
  const int r0 = q0 + warp * 16 + (lane >> 2);
  const int cq = 2 * (lane & 3);         // the first of this thread's column pair
  float lse2[2], dir[2];                 // lse * log2(e) and di of the two rows
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 8 * r;
    lse2[r] = row < s_q ? lse[(long long)bh * s_q + row] * LOG2E : 0.0f;
    dir[r] = di_s[row - q0];
  }
  const float sl2 = sm_scale * LOG2E;

  float acc[NP][32];
#pragma unroll
  for (int p = 0; p < NP; ++p)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[p][i] = 0.0f;

  for (int j = 0; j < n_tiles; ++j) {
    cp_async_wait<1>();
    fence_async_smem();
    __syncthreads();
    const uint32_t k_s = base + TILE * (2 + 2 * (j & 1));
    const uint32_t v_s = k_s + TILE;
    const int k0 = j * ROWS;

    float s[32], dp[32];
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss(s, desc(q_s + k_major(kk)), desc(k_s + k_major(kk)), kk > 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss(dp, desc(do_s + k_major(kk)), desc(v_s + k_major(kk)), kk > 0);
    wg_commit();
    wg_wait_all();
    fence_regs(s);
    fence_regs(dp);

    // s[4c + e]: row r0 + 8 (e >> 1), key k0 + 8c + cq + (e & 1). p = exp(s
    // scale - lse), ds = p (dp - di) scale, 0 past s_k and (causal) past the
    // row; rows past s_q are never stored
    const bool edge = k0 + ROWS > s_k || (causal && k0 + ROWS - 1 > q0);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = (i >> 1) & 1;
      const float p = exp2f(fmaf(s[i], sl2, -lse2[r]));
      float ds = p * (dp[i] - dir[r]) * sm_scale;
      if (edge) {
        const int col = k0 + (i >> 2) * 8 + cq + (i & 1);
        if (col >= s_k || (causal && col > r0 + 8 * r)) ds = 0.0f;
      }
      s[i] = ds;
    }
    uint32_t da[4][4];
    acc_to_a(s, da);                      // ds rounded to bf16 (JAX's ds.astype(k.dtype))
#pragma unroll
    for (int p = 0; p < NP; ++p) fence_regs(acc[p]);
    wg_fence();
#pragma unroll
    for (int p = 0; p < NP; ++p)
#pragma unroll
      for (int kk = 0; kk < ROWS / 16; ++kk)
        wgmma_rs(acc[p], da[kk], desc(k_s + mn_major(p, kk)));
    wg_commit();
    wg_wait_all();
#pragma unroll
    for (int p = 0; p < NP; ++p) fence_regs(acc[p]);
    __syncthreads();                      // every warp is done with this stage
    if (j + 2 < n_tiles) load_kv(j + 2);
    cp_async_commit();
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 8 * r;
    if (row >= s_q) continue;
    __nv_bfloat16* out = dq + ((long long)bh * s_q + row) * D + cq;
#pragma unroll
    for (int p = 0; p < NP; ++p)
#pragma unroll
      for (int c = 0; c < 8; ++c)
        *reinterpret_cast<__nv_bfloat162*>(out + p * 64 + 8 * c) =
            __floats2bfloat162_rn(acc[p][4 * c + 2 * r], acc[p][4 * c + 2 * r + 1]);
  }
}

// B11a: one warpgroup owns 64 keys of one (b, hk). K and V are loaded once;
// for each q head of the group, Q and dO tiles of 64 rows with their lse
// and di stream through a two-stage cp.async ring (causal: from the tile
// that holds the block's first key). Per tile: S^T = K.Q^T and dP^T =
// V.dO^T (rows keys, columns queries), p^T and ds^T in f32, then dV +=
// P^T.dO and dK += dS^T.Q, each as two wgmmas on the bf16 hi and lo parts
// of p^T (ds^T), with dO (Q) as the MN-major B.
template <int D>
constexpr int dkv_smem_bytes() { return 6 * (D / 64) * PANEL + 2 * 2 * ROWS * 4 + 1024; }

template <int D>
__global__ void __launch_bounds__(THREADS) flash_bwd_dkv_tc_kernel(
    const __nv_bfloat16* __restrict__ q,    // [b, h, s_q, D]
    const __nv_bfloat16* __restrict__ k,    // [b, hk, s_k, D]
    const __nv_bfloat16* __restrict__ v,    // [b, hk, s_k, D]
    const __nv_bfloat16* __restrict__ dO,   // [b, h, s_q, D]
    const float* __restrict__ lse,          // [b, h, s_q]
    const float* __restrict__ di,           // [b, h, s_q]
    __nv_bfloat16* __restrict__ dk,         // [b, hk, s_k, D]
    __nv_bfloat16* __restrict__ dv,         // [b, hk, s_k, D]
    int h, int hk, int s_q, int s_k, int causal, float sm_scale) {
  constexpr int NP = D / 64;
  constexpr int TILE = NP * PANEL;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t k_s = base, v_s = base + TILE;
  // stage st: Q at base + TILE (2 + 2 st), dO at base + TILE (3 + 2 st), and
  // at rows + st * 512 bytes the tile's lse [64] then its di [64] (f32)
  const uint32_t rows = base + 6 * TILE;
  const float* rows_p = reinterpret_cast<const float*>(smem_raw + (rows - raw));

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int bkv = blockIdx.y;              // bi * hk + hkv
  const int bi = bkv / hk, hkv = bkv - bi * hk, grp = h / hk;
  const int k0 = blockIdx.x * ROWS;        // key tile 0, the most work when causal, first
  // rows before the block's first key see none of its keys (causal)
  const int t0 = causal ? k0 / ROWS : 0;
  const int n_qt = max(0, (s_q + ROWS - 1) / ROWS - t0);   // q tiles of each head
  const int n_tiles = grp * n_qt;

  auto q_tile = [&](int t, long long& bh, int& i0) {
    const int g = t / n_qt;
    bh = (long long)bi * h + hkv * grp + g;
    i0 = (t0 + t - g * n_qt) * ROWS;
  };
  auto load_q = [&](int t) {
    long long bh;
    int i0;
    q_tile(t, bh, i0);
    const uint32_t st = base + TILE * (2 + 2 * (t & 1));
    load_tile<D>(st, q + (bh * s_q + i0) * D, s_q - i0, tid);
    load_tile<D>(st + TILE, dO + (bh * s_q + i0) * D, s_q - i0, tid);
    const int i = i0 + (tid & (ROWS - 1));
    const bool ok = i < s_q;
    cp_async4(rows + (t & 1) * 512 + tid * 4, (tid < ROWS ? lse : di) + bh * s_q + (ok ? i : 0),
              ok);
  };
  // groups: {K, V, tile 0}, {tile 1}, then one per tile t + 2 (some empty)
  const long long key0 = (long long)bkv * s_k + k0;
  load_tile<D>(k_s, k + key0 * D, s_k - k0, tid);
  load_tile<D>(v_s, v + key0 * D, s_k - k0, tid);
  if (n_tiles > 0) load_q(0);
  cp_async_commit();
  if (n_tiles > 1) load_q(1);
  cp_async_commit();

  float dk_acc[NP][32], dv_acc[NP][32];
#pragma unroll
  for (int p = 0; p < NP; ++p)
#pragma unroll
    for (int i = 0; i < 32; ++i) dk_acc[p][i] = dv_acc[p][i] = 0.0f;
  const int r0 = warp * 16 + (lane >> 2);   // this thread's keys k0 + r0 and k0 + r0 + 8
  const int cq = 2 * (lane & 3);
  const float sl2 = sm_scale * LOG2E;

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<1>();
    fence_async_smem();
    __syncthreads();
    const uint32_t q_s = base + TILE * (2 + 2 * (t & 1));
    const uint32_t do_s = q_s + TILE;
    const float* lse_s = rows_p + (t & 1) * 128;
    const float* di_s = lse_s + ROWS;
    long long bh;
    int i0;
    q_tile(t, bh, i0);

    float s[32], dp[32];
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss(s, desc(k_s + k_major(kk)), desc(q_s + k_major(kk)), kk > 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss(dp, desc(v_s + k_major(kk)), desc(do_s + k_major(kk)), kk > 0);
    wg_commit();
    wg_wait_all();
    fence_regs(s);
    fence_regs(dp);

    // s[4c + e]: key k0 + r0 + 8 (e >> 1), query i0 + 8c + cq + (e & 1). p^T
    // and ds^T, 0 past s_q and (causal) where the key is after the query
    const bool edge = i0 + ROWS > s_q || (causal && k0 + ROWS - 1 > i0);
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int col = 8 * c + cq;
      const float2 l2 = *reinterpret_cast<const float2*>(lse_s + col);
      const float2 d2 = *reinterpret_cast<const float2*>(di_s + col);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 4 * c + e;
        float p = exp2f(fmaf(s[i], sl2, -((e & 1) ? l2.y : l2.x) * LOG2E));
        float ds = p * (dp[i] - ((e & 1) ? d2.y : d2.x)) * sm_scale;
        if (edge) {
          const int qi = i0 + col + (e & 1);
          if (qi >= s_q || (causal && k0 + r0 + 8 * (e >> 1) > qi)) p = ds = 0.0f;
        }
        s[i] = p;
        dp[i] = ds;
      }
    }
    // dV += P^T.dO with P's fragments, which die before dS's are built
    uint32_t hi[4][4], lo[4][4];
    acc_to_a_split(s, hi, lo);
#pragma unroll
    for (int p = 0; p < NP; ++p) fence_regs(dv_acc[p]);
    wg_fence();
#pragma unroll
    for (int p = 0; p < NP; ++p)
#pragma unroll
      for (int kk = 0; kk < ROWS / 16; ++kk) {
        wgmma_rs(dv_acc[p], hi[kk], desc(do_s + mn_major(p, kk)));
        wgmma_rs(dv_acc[p], lo[kk], desc(do_s + mn_major(p, kk)));
      }
    wg_commit();
    wg_wait_all();
#pragma unroll
    for (int p = 0; p < NP; ++p) fence_regs(dv_acc[p]);
    // dK += dS^T.Q
    acc_to_a_split(dp, hi, lo);
#pragma unroll
    for (int p = 0; p < NP; ++p) fence_regs(dk_acc[p]);
    wg_fence();
#pragma unroll
    for (int p = 0; p < NP; ++p)
#pragma unroll
      for (int kk = 0; kk < ROWS / 16; ++kk) {
        wgmma_rs(dk_acc[p], hi[kk], desc(q_s + mn_major(p, kk)));
        wgmma_rs(dk_acc[p], lo[kk], desc(q_s + mn_major(p, kk)));
      }
    wg_commit();
    wg_wait_all();
#pragma unroll
    for (int p = 0; p < NP; ++p) fence_regs(dk_acc[p]);
    __syncthreads();                      // every warp is done with this stage
    if (t + 2 < n_tiles) load_q(t + 2);
    cp_async_commit();
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = k0 + r0 + 8 * r;
    if (key >= s_k) continue;
    const long long off = ((long long)bkv * s_k + key) * D + cq;
#pragma unroll
    for (int p = 0; p < NP; ++p)
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        *reinterpret_cast<__nv_bfloat162*>(dk + off + p * 64 + 8 * c) =
            __floats2bfloat162_rn(dk_acc[p][4 * c + 2 * r], dk_acc[p][4 * c + 2 * r + 1]);
        *reinterpret_cast<__nv_bfloat162*>(dv + off + p * 64 + 8 * c) =
            __floats2bfloat162_rn(dv_acc[p][4 * c + 2 * r], dv_acc[p][4 * c + 2 * r + 1]);
      }
  }
}

}  // namespace tc

// ── (2) the CUDA-core bodies: f32, and bf16 at d 8, 16, 32 ───────────────

#define BQ 64     // B11b: query rows a block
#define BK 32     // B11b: keys a staged tile
#define BKV 64    // B11a: key rows a block
#define BR 32     // B11a: query rows a staged chunk

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <int D> struct Lanes {
  static constexpr int DS = D < 16 ? D : 16;    // dims a lane owns
  static constexpr int SPLIT = D / DS;          // lanes a row
};

// the mask of the SPLIT lanes of this thread's row (shuffles and warp syncs
// name only them: the rows of one warp see different numbers of pairs)
template <int SPLIT>
__device__ __forceinline__ unsigned row_lanes(int tid) {
  return SPLIT == 32 ? 0xffffffffu : ((1u << SPLIT) - 1u) << ((tid & 31) & ~(SPLIT - 1));
}

template <int SPLIT>
__device__ __forceinline__ float row_sum(float x, unsigned mask) {
#pragma unroll
  for (int o = 1; o < SPLIT; o <<= 1) x += __shfl_xor_sync(mask, x, o, SPLIT);
  return x;
}

// ── B11b: dQ and di ──────────────────────────────────────────────────────

template <typename T, int D>
__global__ void __launch_bounds__(BQ * Lanes<D>::SPLIT) flash_bwd_dq_kernel(
    const T* __restrict__ q,       // [b, h, s_q, D]
    const T* __restrict__ k,       // [b, hk, s_k, D]
    const T* __restrict__ v,       // [b, hk, s_k, D]
    const T* __restrict__ o,       // [b, h, s_q, D]
    const T* __restrict__ dO,      // [b, h, s_q, D]
    const float* __restrict__ lse,  // [b, h, s_q]
    T* __restrict__ dq,            // [b, h, s_q, D]
    float* __restrict__ di_out,    // [b, h, s_q]
    int h, int hk, int s_q, int s_k, int causal, float sm_scale) {
  constexpr int DS = Lanes<D>::DS, SPLIT = Lanes<D>::SPLIT, NT = BQ * SPLIT;
  __shared__ float k_s[BK][D];
  __shared__ float v_s[BK][D];

  const int bh = blockIdx.y;
  const int bi = bh / h;
  const int hkv = (bh - bi * h) / (h / hk);
  const int tid = threadIdx.x;
  const int row = tid / SPLIT;
  const int part = tid - row * SPLIT;
  const unsigned mask = row_lanes<SPLIT>(tid);
  const int r = blockIdx.x * BQ + row;
  const bool row_ok = r < s_q;
  const int q_last = min(blockIdx.x * BQ + BQ, s_q) - 1;
  const int k_end = causal ? min(s_k, q_last + 1) : s_k;   // keys any row here sees
  const int my_end = causal ? min(s_k, r + 1) : s_k;        // keys this row sees

  const T* kb = k + (long long)(bi * hk + hkv) * s_k * D;
  const T* vb = v + (long long)(bi * hk + hkv) * s_k * D;

  float qr[DS], dor[DS], acc[DS];
  float di = 0.0f, lse_r = 0.0f;
  if (row_ok) {
    const long long off = ((long long)bh * s_q + r) * D + part;
    float part_di = 0.0f;
#pragma unroll
    for (int dd = 0; dd < DS; ++dd) {
      qr[dd] = to_f<T>(q[off + dd * SPLIT]);
      dor[dd] = to_f<T>(dO[off + dd * SPLIT]);
      part_di = fmaf(to_f<T>(o[off + dd * SPLIT]), dor[dd], part_di);
    }
    di = row_sum<SPLIT>(part_di, mask);
    lse_r = lse[(long long)bh * s_q + r];
    if (part == 0) di_out[(long long)bh * s_q + r] = di;
  }
#pragma unroll
  for (int dd = 0; dd < DS; ++dd) acc[dd] = 0.0f;

  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();
    for (int i = tid; i < BK * D; i += NT) {
      const int j = i / D, dd = i - j * D;
      const int kk = k0 + j;
      const bool in = kk < s_k;
      k_s[j][dd] = in ? to_f<T>(kb[(long long)kk * D + dd]) : 0.0f;
      v_s[j][dd] = in ? to_f<T>(vb[(long long)kk * D + dd]) : 0.0f;
    }
    __syncthreads();
    // the lanes of a row are adjacent in one warp and take the same branch
    const int nj = row_ok ? min(BK, my_end - k0) : 0;
    for (int j = 0; j < nj; ++j) {
      float s = 0.0f, dp = 0.0f;
#pragma unroll
      for (int dd = 0; dd < DS; ++dd) {
        s = fmaf(qr[dd], k_s[j][dd * SPLIT + part], s);
        dp = fmaf(dor[dd], v_s[j][dd * SPLIT + part], dp);
      }
      s = row_sum<SPLIT>(s, mask) * sm_scale;
      dp = row_sum<SPLIT>(dp, mask);
      const float p = expf(s - lse_r);
      const float ds = p * (dp - di) * sm_scale;
      const float dsr = to_f<T>(from_f<T>(ds));
#pragma unroll
      for (int dd = 0; dd < DS; ++dd) acc[dd] = fmaf(dsr, k_s[j][dd * SPLIT + part], acc[dd]);
    }
  }

  if (row_ok) {
    T* out = dq + ((long long)bh * s_q + r) * D + part;
#pragma unroll
    for (int dd = 0; dd < DS; ++dd) out[dd * SPLIT] = from_f<T>(acc[dd]);
  }
}

// ── B11a: dK and dV ──────────────────────────────────────────────────────

template <typename T, int D>
__global__ void __launch_bounds__(BKV * Lanes<D>::SPLIT) flash_bwd_dkv_kernel(
    const T* __restrict__ q,        // [b, h, s_q, D]
    const T* __restrict__ k,        // [b, hk, s_k, D]
    const T* __restrict__ v,        // [b, hk, s_k, D]
    const T* __restrict__ dO,       // [b, h, s_q, D]
    const float* __restrict__ lse,  // [b, h, s_q]
    const float* __restrict__ di,   // [b, h, s_q]
    T* __restrict__ dk,             // [b, hk, s_k, D]
    T* __restrict__ dv,             // [b, hk, s_k, D]
    int h, int hk, int s_q, int s_k, int causal, float sm_scale) {
  constexpr int DS = Lanes<D>::DS, SPLIT = Lanes<D>::SPLIT, NT = BKV * SPLIT;
  __shared__ float q_s[BR][D];
  __shared__ float do_s[BR][D];
  __shared__ float lse_s[BR];
  __shared__ float di_s[BR];

  const int bkv = blockIdx.y;            // bi * hk + hkv
  const int bi = bkv / hk;
  const int hkv = bkv - bi * hk;
  const int grp = h / hk;
  const int tid = threadIdx.x;
  const int row = tid / SPLIT;
  const int part = tid - row * SPLIT;
  const unsigned mask = row_lanes<SPLIT>(tid);
  const int k0 = blockIdx.x * BKV;
  const int j = k0 + row;                // this thread's key
  const bool key_ok = j < s_k;

  float kr[DS], vr[DS], dk_acc[DS], dv_acc[DS];
  if (key_ok) {
    const long long off = ((long long)bkv * s_k + j) * D + part;
#pragma unroll
    for (int dd = 0; dd < DS; ++dd) {
      kr[dd] = to_f<T>(k[off + dd * SPLIT]);
      vr[dd] = to_f<T>(v[off + dd * SPLIT]);
    }
  }
#pragma unroll
  for (int dd = 0; dd < DS; ++dd) dk_acc[dd] = dv_acc[dd] = 0.0f;

  // rows before the tile's first key see none of its keys (causal)
  const int i_begin = causal ? min(k0, s_q) : 0;
  for (int g = 0; g < grp; ++g) {
    const long long bh = (long long)bi * h + hkv * grp + g;
    const T* qb = q + bh * s_q * D;
    const T* dob = dO + bh * s_q * D;
    for (int i0 = i_begin; i0 < s_q; i0 += BR) {
      __syncthreads();
      for (int x = tid; x < BR * D; x += NT) {
        const int ii = x / D, dd = x - ii * D;
        const int i = i0 + ii;
        const bool in = i < s_q;
        q_s[ii][dd] = in ? to_f<T>(qb[(long long)i * D + dd]) : 0.0f;
        do_s[ii][dd] = in ? to_f<T>(dob[(long long)i * D + dd]) : 0.0f;
      }
      if (tid < BR) {
        const int i = i0 + tid;
        lse_s[tid] = i < s_q ? lse[bh * s_q + i] : 0.0f;
        di_s[tid] = i < s_q ? di[bh * s_q + i] : 0.0f;
      }
      __syncthreads();
      if (!key_ok) continue;
      const int ni = min(BR, s_q - i0);
      // causal: rows before this key skip it (the row's lanes share j)
      const int ii0 = causal ? max(0, j - i0) : 0;
      for (int ii = ii0; ii < ni; ++ii) {
        float s = 0.0f, dp = 0.0f;
#pragma unroll
        for (int dd = 0; dd < DS; ++dd) {
          s = fmaf(q_s[ii][dd * SPLIT + part], kr[dd], s);
          dp = fmaf(do_s[ii][dd * SPLIT + part], vr[dd], dp);
        }
        s = row_sum<SPLIT>(s, mask) * sm_scale;
        dp = row_sum<SPLIT>(dp, mask);
        const float p = expf(s - lse_s[ii]);
        const float ds = p * (dp - di_s[ii]) * sm_scale;
#pragma unroll
        for (int dd = 0; dd < DS; ++dd) {
          dv_acc[dd] = fmaf(p, do_s[ii][dd * SPLIT + part], dv_acc[dd]);
          dk_acc[dd] = fmaf(ds, q_s[ii][dd * SPLIT + part], dk_acc[dd]);
        }
      }
    }
  }

  if (key_ok) {
    const long long off = ((long long)bkv * s_k + j) * D + part;
#pragma unroll
    for (int dd = 0; dd < DS; ++dd) {
      dk[off + dd * SPLIT] = from_f<T>(dk_acc[dd]);
      dv[off + dd * SPLIT] = from_f<T>(dv_acc[dd]);
    }
  }
}

// ── host side ────────────────────────────────────────────────────────────

struct BwdArgs {
  const void *q, *k, *v, *o, *dO;
  const float *lse, *di_in;
  void *dq, *dk, *dv;
  float* di_out;
  int b, h, hk, s_q, s_k, causal;
  float sm_scale;
  cudaStream_t stream;
};

template <typename T, int D>
static int launch_dq(const BwdArgs& a) {
  dim3 grid((a.s_q + BQ - 1) / BQ, a.b * a.h);
  flash_bwd_dq_kernel<T, D><<<grid, BQ * Lanes<D>::SPLIT, 0, a.stream>>>(
      (const T*)a.q, (const T*)a.k, (const T*)a.v, (const T*)a.o, (const T*)a.dO, a.lse,
      (T*)a.dq, a.di_out, a.h, a.hk, a.s_q, a.s_k, a.causal, a.sm_scale);
  return (int)cudaGetLastError();
}

template <typename T, int D>
static int launch_dkv(const BwdArgs& a) {
  dim3 grid((a.s_k + BKV - 1) / BKV, a.b * a.hk);
  flash_bwd_dkv_kernel<T, D><<<grid, BKV * Lanes<D>::SPLIT, 0, a.stream>>>(
      (const T*)a.q, (const T*)a.k, (const T*)a.v, (const T*)a.dO, a.lse, a.di_in,
      (T*)a.dk, (T*)a.dv, a.h, a.hk, a.s_q, a.s_k, a.causal, a.sm_scale);
  return (int)cudaGetLastError();
}

template <int D>
static int launch_dq_tc(const BwdArgs& a) {
  constexpr int smem = tc::dq_smem_bytes<D>();
  // above 48 KB only as dynamic shared memory, once allowed; set once
  static const cudaError_t allowed = cudaFuncSetAttribute(
      tc::flash_bwd_dq_tc_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (allowed != cudaSuccess) return (int)allowed;
  dim3 grid((a.s_q + tc::ROWS - 1) / tc::ROWS, a.b * a.h);
  tc::flash_bwd_dq_tc_kernel<D><<<grid, tc::THREADS, smem, a.stream>>>(
      (const __nv_bfloat16*)a.q, (const __nv_bfloat16*)a.k, (const __nv_bfloat16*)a.v,
      (const __nv_bfloat16*)a.o, (const __nv_bfloat16*)a.dO, a.lse, (__nv_bfloat16*)a.dq,
      a.di_out, a.h, a.hk, a.s_q, a.s_k, a.causal, a.sm_scale);
  return (int)cudaGetLastError();
}

template <int D>
static int launch_dkv_tc(const BwdArgs& a) {
  constexpr int smem = tc::dkv_smem_bytes<D>();
  static const cudaError_t allowed = cudaFuncSetAttribute(
      tc::flash_bwd_dkv_tc_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (allowed != cudaSuccess) return (int)allowed;
  dim3 grid((a.s_k + tc::ROWS - 1) / tc::ROWS, a.b * a.hk);
  tc::flash_bwd_dkv_tc_kernel<D><<<grid, tc::THREADS, smem, a.stream>>>(
      (const __nv_bfloat16*)a.q, (const __nv_bfloat16*)a.k, (const __nv_bfloat16*)a.v,
      (const __nv_bfloat16*)a.dO, a.lse, a.di_in, (__nv_bfloat16*)a.dk, (__nv_bfloat16*)a.dv,
      a.h, a.hk, a.s_q, a.s_k, a.causal, a.sm_scale);
  return (int)cudaGetLastError();
}

template <typename T, bool DQ>
static int dispatch_d(const BwdArgs& a, int d) {
  switch (d) {
    case 8: return DQ ? launch_dq<T, 8>(a) : launch_dkv<T, 8>(a);
    case 16: return DQ ? launch_dq<T, 16>(a) : launch_dkv<T, 16>(a);
    case 32: return DQ ? launch_dq<T, 32>(a) : launch_dkv<T, 32>(a);
    default: break;
  }
  // bf16 at d 64 and 128 takes the tensor-core body
  if constexpr (std::is_same<T, float>::value) {
    if (d == 64) return DQ ? launch_dq<T, 64>(a) : launch_dkv<T, 64>(a);
    if (d == 128) return DQ ? launch_dq<T, 128>(a) : launch_dkv<T, 128>(a);
  }
  return (int)cudaErrorInvalidValue;
}

// bf16 at d 64 and 128 takes the tensor-core body (ops/flash_attention_bwd.py
// ``flash_bwd_body`` makes the same choice), everything else the CUDA-core one
template <bool DQ>
static int dispatch(const BwdArgs& a, int d, int dtype) {
  if (a.hk < 1 || a.h % a.hk != 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return dispatch_d<float, DQ>(a, d);
  if (dtype == 1 && d == 64) return DQ ? launch_dq_tc<64>(a) : launch_dkv_tc<64>(a);
  if (dtype == 1 && d == 128) return DQ ? launch_dq_tc<128>(a) : launch_dkv_tc<128>(a);
  if (dtype == 1) return dispatch_d<__nv_bfloat16, DQ>(a, d);
  return (int)cudaErrorInvalidValue;
}

// B11b. dtype: 0 = float32, 1 = bfloat16. Writes dq [b, h, s_q, d] and di
// (f32 [b, h, s_q], B11a's input).
extern "C" int vt_flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* o, const void* dO,
    const void* lse, void* dq, void* di,
    int b, int h, int hk, int s_q, int s_k, int d, int causal, float sm_scale,
    int dtype, void* stream) {
  BwdArgs a{q, k, v, o, dO, (const float*)lse, nullptr, dq, nullptr, nullptr, (float*)di,
            b, h, hk, s_q, s_k, causal, sm_scale, (cudaStream_t)stream};
  return dispatch<true>(a, d, dtype);
}

// B11a. Reads B11b's di; writes dk and dv [b, hk, s_k, d].
extern "C" int vt_flash_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dO, const void* lse,
    const void* di, void* dk, void* dv,
    int b, int h, int hk, int s_q, int s_k, int d, int causal, float sm_scale,
    int dtype, void* stream) {
  BwdArgs a{q, k, v, nullptr, dO, (const float*)lse, (const float*)di, nullptr, dk, dv,
            nullptr, b, h, hk, s_q, s_k, causal, sm_scale, (cudaStream_t)stream};
  return dispatch<false>(a, d, dtype);
}
