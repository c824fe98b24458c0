// Tiled online-softmax attention forward over [b, h, s, d], causal or
// masked per batch row by kv_lens, with GQA by head indexing.
//
// Replaces: vocalie_tts_tpu/ops/flash_attention.py::flash_attention (its
// forward, _attention_kernel via _flash_attention_padded). Its numbers:
//   * scores q.k in f32 (bf16 products with an f32 accumulator for bf16
//     inputs, preferred_element_type=f32), times sm_scale after the product;
//   * keys at or past the row's kv_len, and (causal) keys after the query
//     position, are left out; the TPU adds -0.7*f32max to them, which
//     gives them a probability of exactly 0 wherever a row has a valid key;
//   * f32 running max, sum and accumulator; the probabilities are cast to
//     the input type before the p.v product, as the TPU kernel does;
//   * a row with no valid key returns 0 (l == 0 -> 1/l taken as 1).
// Not copied: the TPU's whole-row CFM tiles (block_q = block_k = T padded)
// and the jnp.repeat of k/v heads for GQA -- the kv head is indexed.
//
// With a non-null ``lse`` (f32 [b, h, s_q]) the kernel also writes each
// row's logsumexp, m + log(max(l, 1e-30)) as _attention_kernel's _store
// (flash_attention.py:103), which the training path's backward (B11,
// flash_attention_bwd.cu) reads: _fa_fwd -> _flash_attention_padded. A row
// with no valid key gets -inf. Serving passes null and writes nothing more.
//
// Bound: bytes at every main-path shape. At the CFM shape (b=16, h=8,
// T=640, d=64, bf16, ragged kv_lens) q, k, v and o move ~36 MB (0.0108 ms
// at 3.35 TB/s); at the T3 prefill (b=16, h=16, s=512, d=64, causal) ~67 MB
// (0.0200 ms); at the Qwen3 prefill (b=8, h=16, hk=8, s=512, d=128, causal)
// ~50 MB (0.0150 ms); B6t's [8,16,512,64] ~34 MB (0.0101 ms). Their q.k and
// p.v are 9-13 GFLOP, 9-14 us at 989 TFLOP/s on the bf16 tensor cores and
// ~150-200 us at 67 TFLOP/s on the f32 CUDA cores: off the tensor cores
// the products, not the bytes, set the time.
//
// Two bodies, chosen by dtype and d (ops/flash_attention.py ``flash_body``
// makes the same choice):
//
// (1) bf16 at d 64 and 128 -- every full-width path -- flash_fwd_tc_kernel,
// both products on the Hopper tensor cores (wgmma.mma_async, sm_90a; the
// building blocks are wgmma.cuh's, which B11's tensor-core bodies share):
//   * one block = one warpgroup (128 threads) owns 64 query rows of one
//     (batch, head); thread t holds rows 16*warp + lane/4 and that + 8, as
//     the wgmma accumulator lays them out. 64-row tiles give the Qwen3
//     batch-1 prefill [1,16,512,128] 128 blocks for 132 SMs (128-row tiles
//     would give 64); the heaviest causal tiles are issued first. GQA
//     indexes the kv head; the two q heads of a kv head run in two blocks
//     that read its K/V through L2 (no per-kv-head packing).
//   * S = Q.K^T: wgmma m64n64k16, A = the Q tile and B = the K tile, both
//     from shared memory (K-major), f32 accumulator, D/16 steps; then
//     S *= sm_scale as JAX, the masks, and the online softmax on the
//     accumulator fragments: the row max and row sum over the 4 lanes of
//     a quad by shuffles, alpha rescales O in registers. exp is exp2f of
//     s*log2(e) - m*log2(e) (one FMA: log2(e) folded into the exponent).
//     A row whose running max is still -inf takes 0 as its exponent base,
//     so exp(-inf - -inf) never makes a NaN.
//   * P is rounded to bf16 in registers and fed to O += P.V as wgmma's
//     register A operand (the accumulator of columns 16j..16j+15 is the A
//     fragment of k-slice j); B = the V tile, MN-major from shared memory,
//     one m64n64k16 per 64-column panel of d and 16 keys. The scores never
//     go through shared memory.
//   * K/V tiles of 64 keys, bf16 in shared memory in 64-column panels of
//     128-byte rows with the 128-byte swizzle that wgmma's descriptors
//     read; a ring of 2 stages filled by cp.async (16 bytes a thread, keys
//     at or past kv_len zero-filled), so tile j+1 loads while tile j
//     multiplies; Q is loaded once per block. Dynamic shared memory: 41 KB
//     at d 64, 81 KB at d 128 (cudaFuncSetAttribute, checked).
//   * Causal tiles strictly above the diagonal are skipped; the tiles that
//     reach past kv_len or the diagonal are masked element by element.
//
// (2) f32, and bf16 at d 8, 16, 32 (the tiny test configurations and the
// f32 CFM of the small t2w scale, none on a full-width path) --
// flash_fwd_kernel, products on the CUDA cores in f32: one block per
// (b*h, 64-query tile); each query row is owned by SPLIT adjacent threads
// of one warp (SPLIT = 1 for d <= 64, 4 for d = 128), each holding D /
// SPLIT of q and of the accumulator in registers (lane p of a row owns
// dims p, p + SPLIT, ..., so the row's lanes read neighbouring
// shared-memory words). The block walks 32-key tiles that it stages in
// shared memory (as f32). A score is each thread's partial q.k summed over
// the row's SPLIT lanes by a shuffle butterfly (every lane gets the same
// bits); lane 0 of the row writes it to a shared row, then the tile's max,
// exp and p.v follow, each lane on its own slice of d.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "wgmma.cuh"

// ── (1) the tensor-core body: bf16, d 64 and 128 ──────────────────────────

namespace tc {

constexpr int BM = 64;                 // query rows of a block: one warpgroup's wgmma M
constexpr int BN = 64;                 // keys of a tile

template <int D>
constexpr int smem_bytes() { return (1 + 2 * 2) * (D / 64) * PANEL + 1024; }

template <int D>
__global__ void __launch_bounds__(THREADS) flash_fwd_tc_kernel(
    const __nv_bfloat16* __restrict__ q,   // [b, h, s_q, D]
    const __nv_bfloat16* __restrict__ k,   // [b, hk, s_k, D]
    const __nv_bfloat16* __restrict__ v,   // [b, hk, s_k, D]
    __nv_bfloat16* __restrict__ out,       // [b, h, s_q, D]
    float* __restrict__ lse,               // [b, h, s_q] or null
    const int* __restrict__ kv_lens,       // [b] or null
    int h, int hk, int s_q, int s_k, int causal, float sm_scale) {
  constexpr int NP = D / 64;               // 64-column panels of d
  constexpr int TILE = NP * PANEL;         // bytes of one 64-row tile
  extern __shared__ uint8_t smem_raw[];
  // the swizzle is a function of the address: panels on 1024-byte boundaries
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_s = base;
  // stage st: K at base + TILE (1 + 2 st), V at base + TILE (2 + 2 st)

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int bh = blockIdx.y;
  const int bi = bh / h, hi = bh - bi * h, hkv = hi / (h / hk);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BM;    // the longest causal rows first
  int kv_len = s_k;
  if (kv_lens != nullptr) kv_len = min(max(kv_lens[bi], 0), s_k);
  const int q_last = min(q0 + BM, s_q) - 1;
  const int k_end = causal ? min(kv_len, q_last + 1) : kv_len;   // keys any row here sees
  const int n_tiles = (k_end + BN - 1) / BN;

  const __nv_bfloat16* kb = k + (long long)(bi * hk + hkv) * s_k * D;
  const __nv_bfloat16* vb = v + (long long)(bi * hk + hkv) * s_k * D;
  auto load_kv = [&](int j) {
    const uint32_t st = base + TILE * (1 + 2 * (j & 1));
    load_tile<D>(st, kb + (long long)j * BN * D, kv_len - j * BN, tid);
    load_tile<D>(st + TILE, vb + (long long)j * BN * D, kv_len - j * BN, tid);
  };
  // groups: {Q, tile 0}, {tile 1}, then one per tile j + 2 (some empty), so
  // that at tile j every group but the newest holds what tile j needs
  load_tile<D>(q_s, q + ((long long)bh * s_q + q0) * D, s_q - q0, tid);
  if (n_tiles > 0) load_kv(0);
  cp_async_commit();
  if (n_tiles > 1) load_kv(1);
  cp_async_commit();

  float o[NP][32];
#pragma unroll
  for (int p = 0; p < NP; ++p)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[p][i] = 0.0f;
  float m[2] = {-INFINITY, -INFINITY};   // rows r0 and r0 + 8
  float l[2] = {0.0f, 0.0f};             // this thread's part of the row sums
  const int r0 = q0 + warp * 16 + (lane >> 2);
  const int cq = 2 * (lane & 3);         // the first of this thread's column pair

  for (int j = 0; j < n_tiles; ++j) {
    cp_async_wait<1>();
    fence_async_smem();
    __syncthreads();
    const uint32_t k_s = base + TILE * (1 + 2 * (j & 1));
    const uint32_t v_s = k_s + TILE;
    const int k0 = j * BN;

    float s[32];
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)   // 16 columns of d
      wgmma_ss(s, desc(q_s + k_major(kk)), desc(k_s + k_major(kk)), kk > 0);
    wg_commit();
    wg_wait_all();
    fence_regs(s);

    // s[4c + e]: row r0 + 8 (e >> 1), key k0 + 8c + cq + (e & 1)
    const bool edge = k0 + BN > kv_len || (causal && k0 + BN - 1 > q0);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      float x = s[i] * sm_scale;
      if (edge) {
        const int col = k0 + (i >> 2) * 8 + cq + (i & 1);
        const int row = r0 + ((i >> 1) & 1) * 8;
        if (col >= kv_len || (causal && col > row)) x = -INFINITY;
      }
      s[i] = x;
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], x);
    }
    float alpha[2], mb[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      const bool none = m_new == -INFINITY;                 // no valid key yet
      alpha[r] = none ? 1.0f : exp2f((m[r] - m_new) * LOG2E);
      mb[r] = none ? 0.0f : m_new * LOG2E;
      m[r] = m_new;
    }
    // p = exp(s - m) in f32 for the row sums; bf16 pairs for P.V, laid out
    // as wgmma's A fragment
    float ps[2] = {0.0f, 0.0f};
#pragma unroll
    for (int c = 0; c < 8; ++c) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[4 * c + e] = exp2f(fmaf(s[4 * c + e], LOG2E, -mb[e >> 1]));
      ps[0] += s[4 * c + 0] + s[4 * c + 1];
      ps[1] += s[4 * c + 2] + s[4 * c + 3];
    }
    uint32_t pa[4][4];
    acc_to_a(s, pa);
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = alpha[r] * l[r] + ps[r];
#pragma unroll
    for (int p = 0; p < NP; ++p) {
#pragma unroll
      for (int i = 0; i < 32; ++i) o[p][i] *= alpha[(i >> 1) & 1];
      fence_regs(o[p]);
    }
    wg_fence();
#pragma unroll
    for (int p = 0; p < NP; ++p)
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)   // 16 keys: two 8-row groups of the V panel
        wgmma_rs(o[p], pa[kk], desc(v_s + mn_major(p, kk)));
    wg_commit();
    wg_wait_all();
#pragma unroll
    for (int p = 0; p < NP; ++p) fence_regs(o[p]);
    __syncthreads();                      // every warp is done with this stage
    if (j + 2 < n_tiles) load_kv(j + 2);
    cp_async_commit();
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int row = r0 + 8 * r;
    if (row >= s_q) continue;
    const float linv = (l[r] == 0.0f) ? 1.0f : 1.0f / l[r];
    __nv_bfloat16* orow = out + ((long long)bh * s_q + row) * D + cq;
#pragma unroll
    for (int p = 0; p < NP; ++p)
#pragma unroll
      for (int c = 0; c < 8; ++c)
        *reinterpret_cast<__nv_bfloat162*>(orow + p * 64 + 8 * c) = __floats2bfloat162_rn(
            o[p][4 * c + 2 * r] * linv, o[p][4 * c + 2 * r + 1] * linv);
    if (lse != nullptr && (lane & 3) == 0)
      lse[(long long)bh * s_q + row] = m[r] + logf(fmaxf(l[r], 1e-30f));
  }
}

template <int D>
static int launch(const void* q, const void* k, const void* v, void* out, float* lse,
                  const int* kv_lens, int b, int h, int hk, int s_q, int s_k, int causal,
                  float sm_scale, cudaStream_t stream) {
  constexpr int smem = smem_bytes<D>();
  // above 48 KB only as dynamic shared memory, once allowed; set once
  static const cudaError_t allowed = cudaFuncSetAttribute(
      flash_fwd_tc_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (allowed != cudaSuccess) return (int)allowed;
  dim3 grid((s_q + BM - 1) / BM, b * h);
  flash_fwd_tc_kernel<D><<<grid, THREADS, smem, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
      (__nv_bfloat16*)out, lse, kv_lens, h, hk, s_q, s_k, causal, sm_scale);
  return (int)cudaGetLastError();
}

}  // namespace tc

// ── (2) the CUDA-core body: f32, and bf16 at d 8, 16, 32 ──────────────────

#define BQ 64
#define BK 32

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

template <typename T, int D, int SPLIT>
__global__ void __launch_bounds__(BQ * SPLIT) flash_fwd_kernel(
    const T* __restrict__ q,        // [b, h, s_q, D]
    const T* __restrict__ k,        // [b, hk, s_k, D]
    const T* __restrict__ v,        // [b, hk, s_k, D]
    T* __restrict__ out,            // [b, h, s_q, D]
    float* __restrict__ lse,        // [b, h, s_q] or null
    const int* __restrict__ kv_lens,  // [b] or null
    int h, int hk, int s_q, int s_k, int causal, float sm_scale) {
  constexpr int NT = BQ * SPLIT;
  constexpr int DS = D / SPLIT;      // the dims each lane of a row owns
  __shared__ float k_s[BK][D];
  __shared__ float v_s[BK][D];
  __shared__ float s_s[BQ][BK + 1];

  const int bh = blockIdx.y;
  const int bi = bh / h;
  const int hi = bh - bi * h;
  const int hkv = hi / (h / hk);
  const int tid = threadIdx.x;
  const int row = tid / SPLIT;          // the query row of this block
  const int part = tid - row * SPLIT;   // owns dims part, part + SPLIT, ...
  // the row's lanes: the shuffles and warp syncs name only them, since the
  // rows of one warp see different numbers of keys
  const unsigned row_mask = SPLIT == 32 ? 0xffffffffu
                                        : ((1u << SPLIT) - 1u) << ((tid & 31) & ~(SPLIT - 1));
  const int r = blockIdx.x * BQ + row;
  const bool row_ok = r < s_q;

  int kv_len = s_k;
  if (kv_lens != nullptr) kv_len = min(max(kv_lens[bi], 0), s_k);
  const int q_last = min(blockIdx.x * BQ + BQ, s_q) - 1;
  const int k_end = causal ? min(kv_len, q_last + 1) : kv_len;   // keys any row here sees
  const int my_end = causal ? min(kv_len, r + 1) : kv_len;        // keys this row sees

  const T* kb = k + (long long)(bi * hk + hkv) * s_k * D;
  const T* vb = v + (long long)(bi * hk + hkv) * s_k * D;

  float qr[DS];
  float acc[DS];
  if (row_ok) {
    const T* qrow = q + ((long long)bh * s_q + r) * D + part;
#pragma unroll
    for (int dd = 0; dd < DS; ++dd) qr[dd] = to_f<T>(qrow[dd * SPLIT]);
  }
#pragma unroll
  for (int dd = 0; dd < DS; ++dd) acc[dd] = 0.0f;
  float m = -INFINITY, l = 0.0f;

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
    if (nj <= 0) continue;
    float mt = -INFINITY;
    for (int j = 0; j < nj; ++j) {
      float s = 0.0f;
#pragma unroll
      for (int dd = 0; dd < DS; ++dd) s = fmaf(qr[dd], k_s[j][dd * SPLIT + part], s);
#pragma unroll
      for (int o = 1; o < SPLIT; o <<= 1) s += __shfl_xor_sync(row_mask, s, o, SPLIT);
      s *= sm_scale;
      if (part == 0) s_s[row][j] = s;
      mt = fmaxf(mt, s);
    }
    if (SPLIT > 1) __syncwarp(row_mask);   // s_s[row] written by the row's lane 0
    const float m_new = fmaxf(m, mt);
    const float alpha = expf(m - m_new);
#pragma unroll
    for (int dd = 0; dd < DS; ++dd) acc[dd] *= alpha;
    float psum = 0.0f;
    for (int j = 0; j < nj; ++j) {
      const float p = expf(s_s[row][j] - m_new);
      psum += p;
      const float pc = to_f<T>(from_f<T>(p));
#pragma unroll
      for (int dd = 0; dd < DS; ++dd) acc[dd] = fmaf(pc, v_s[j][dd * SPLIT + part], acc[dd]);
    }
    l = alpha * l + psum;
    m = m_new;
  }

  if (row_ok) {
    const float linv = (l == 0.0f) ? 1.0f : 1.0f / l;
    T* orow = out + ((long long)bh * s_q + r) * D + part;
#pragma unroll
    for (int dd = 0; dd < DS; ++dd) orow[dd * SPLIT] = from_f<T>(acc[dd] * linv);
    if (lse != nullptr && part == 0) lse[(long long)bh * s_q + r] = m + logf(fmaxf(l, 1e-30f));
  }
}

template <typename T, int D>
static int launch_simt(const void* q, const void* k, const void* v, void* out, float* lse,
                  const int* kv_lens,
                  int b, int h, int hk, int s_q, int s_k, int causal, float sm_scale,
                  cudaStream_t stream) {
  constexpr int SPLIT = D > 64 ? 4 : 1;
  dim3 grid((s_q + BQ - 1) / BQ, b * h);
  flash_fwd_kernel<T, D, SPLIT><<<grid, BQ * SPLIT, 0, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, lse, kv_lens, h, hk, s_q, s_k, causal,
      sm_scale);
  return (int)cudaGetLastError();
}

template <typename T>
static int dispatch_d(const void* q, const void* k, const void* v, void* out, float* lse,
                      const int* kv_lens,
                      int b, int h, int hk, int s_q, int s_k, int d, int causal, float sm_scale,
                      cudaStream_t stream) {
  switch (d) {
    case 8: return launch_simt<T, 8>(q, k, v, out, lse, kv_lens, b, h, hk, s_q, s_k, causal, sm_scale, stream);
    case 16: return launch_simt<T, 16>(q, k, v, out, lse, kv_lens, b, h, hk, s_q, s_k, causal, sm_scale, stream);
    case 32: return launch_simt<T, 32>(q, k, v, out, lse, kv_lens, b, h, hk, s_q, s_k, causal, sm_scale, stream);
    default: break;
  }
  // bf16 at d 64 and 128 takes the tensor-core body (vt_flash_attention_fwd)
  if constexpr (std::is_same<T, float>::value) {
    if (d == 64) return launch_simt<T, 64>(q, k, v, out, lse, kv_lens, b, h, hk, s_q, s_k, causal, sm_scale, stream);
    if (d == 128) return launch_simt<T, 128>(q, k, v, out, lse, kv_lens, b, h, hk, s_q, s_k, causal, sm_scale, stream);
  }
  return (int)cudaErrorInvalidValue;
}

// dtype: 0 = float32, 1 = bfloat16; lse: f32 [b, h, s_q] or null. bf16 at d 64
// and 128 takes the tensor-core body, everything else the CUDA-core one.
extern "C" int vt_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* out, void* lse, const void* kv_lens,
    int b, int h, int hk, int s_q, int s_k, int d, int causal, float sm_scale,
    int dtype, void* stream) {
  if (hk < 1 || h % hk != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int* lens = (const int*)kv_lens;
  float* ls = (float*)lse;
  if (dtype == 0)
    return dispatch_d<float>(q, k, v, out, ls, lens, b, h, hk, s_q, s_k, d, causal, sm_scale, st);
  if (dtype == 1 && d == 64)
    return tc::launch<64>(q, k, v, out, ls, lens, b, h, hk, s_q, s_k, causal, sm_scale, st);
  if (dtype == 1 && d == 128)
    return tc::launch<128>(q, k, v, out, ls, lens, b, h, hk, s_q, s_k, causal, sm_scale, st);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(q, k, v, out, ls, lens, b, h, hk, s_q, s_k, d, causal, sm_scale, st);
  return (int)cudaErrorInvalidValue;
}
