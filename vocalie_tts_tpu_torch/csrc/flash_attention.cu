// Tiled online-softmax attention forward over [b, h, s, d], causal or
// masked per batch row by kv_lens, with GQA by head indexing.
//
// Replaces: vocalie_tts_tpu/ops/flash_attention.py::flash_attention (its
// forward, _attention_kernel via _flash_attention_padded). Its numbers:
//   * scores q.k in f32, times sm_scale;
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
// Bound: bytes at both main-path shapes. At the CFM shape (b=16, h=8,
// T=640, d=64, bf16) q, k, v and o move ~42 MB (~12.5 us at 3.35 TB/s)
// against at most 13 GFLOP of q.k and p.v (less with ragged kv_lens; at
// most ~13.6 us at the bf16 tensor-core rate);
// at prefill (b=16, h=16, s=512, causal) ~67 MB against ~9 GFLOP; at the
// Qwen3 prefill (b=8, h=16, hk=8, s=512, d=128, causal) ~50 MB against ~9
// GFLOP. This
// first kernel does its products on the CUDA cores in f32 (67 TFLOP/s),
// which alone puts it an order of magnitude above that bound.
//
// Design (first, simple version, no tensor cores): one block per (b*h,
// 64-query tile); each query row is owned by SPLIT adjacent threads of one
// warp (SPLIT = 1 for d <= 64, 4 for d = 128), each holding D / SPLIT of q
// and of the accumulator in registers (lane p of a row owns dims p, p +
// SPLIT, ..., so the row's lanes read neighbouring shared-memory words) (a whole d = 128 row in one thread
// would need ~256 registers and spill). The block walks 32-key tiles that
// it stages in shared memory (as f32). A score is each thread's partial
// q.k summed over the row's SPLIT lanes by a shuffle butterfly (every lane
// gets the same bits); lane 0 of the row writes it to a shared row, then the
// tile's max, exp and p.v follow, each lane on its own slice of d.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

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
static int launch(const void* q, const void* k, const void* v, void* out, float* lse,
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
    case 8: return launch<T, 8>(q, k, v, out, lse, kv_lens, b, h, hk, s_q, s_k, causal, sm_scale, stream);
    case 16: return launch<T, 16>(q, k, v, out, lse, kv_lens, b, h, hk, s_q, s_k, causal, sm_scale, stream);
    case 32: return launch<T, 32>(q, k, v, out, lse, kv_lens, b, h, hk, s_q, s_k, causal, sm_scale, stream);
    case 64: return launch<T, 64>(q, k, v, out, lse, kv_lens, b, h, hk, s_q, s_k, causal, sm_scale, stream);
    case 128: return launch<T, 128>(q, k, v, out, lse, kv_lens, b, h, hk, s_q, s_k, causal, sm_scale, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// dtype: 0 = float32, 1 = bfloat16; lse: f32 [b, h, s_q] or null
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
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(q, k, v, out, ls, lens, b, h, hk, s_q, s_k, d, causal, sm_scale, st);
  return (int)cudaErrorInvalidValue;
}
