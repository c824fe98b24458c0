// Flash-attention backward over [b, h, s, d] from the forward's saved
// logsumexp: B11b (dQ, with di = rowsum(o * dO)) and B11a (dK, dV), causal
// (start-aligned) or not, with GQA by head indexing.
//
// Replaces: vocalie_tts_tpu/ops/flash_attention_bwd.py::flash_attention_bwd
// (_dq_kernel and _dkv_kernel, via _fa_bwd, the custom VJP of
// flash_attention_trainable). Its numbers (_tile_ds):
//   * s = q.k in f32, times sm_scale; a masked score (a key after the
//     query, causal) has a probability of exactly 0, as the TPU's
//     "add _MASK_VALUE, exp, zero after" gives it: the pair is skipped;
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
// sums the group after the kernel, in that type, _fa_bwd :317-321).
//
// Bound: at the T3 fine-tune shapes ([8, 16, 128|512, 64] bf16, causal) the
// backward does 7 products of 2*d operations per (query, key) pair (s and
// dp in each kernel, dV, dK, dQ): ~15 GFLOP at s = 512 against ~59 MB of
// q, k, v, o, dO, lse, dQ, dK, dV (~15 us at the bf16 tensor-core rate,
// ~17.5 us at 3.35 TB/s). This first version multiplies on the CUDA cores
// in f32 (67 TFLOP/s), which alone puts it an order of magnitude above.
//
// Design (first, simple version, no tensor cores). Each row (a query row in
// B11b, a key row in B11a) is owned by SPLIT = D / DS adjacent lanes of one
// warp, each holding DS = min(D, 16) of the row's dims in registers (lane p
// owns dims p, p + SPLIT, ...). A score is each lane's partial dot summed
// over the row's lanes by a shuffle butterfly, so every lane holds the same
// bits.
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

template <typename T, bool DQ>
static int dispatch_d(const BwdArgs& a, int d) {
  switch (d) {
    case 8: return DQ ? launch_dq<T, 8>(a) : launch_dkv<T, 8>(a);
    case 16: return DQ ? launch_dq<T, 16>(a) : launch_dkv<T, 16>(a);
    case 32: return DQ ? launch_dq<T, 32>(a) : launch_dkv<T, 32>(a);
    case 64: return DQ ? launch_dq<T, 64>(a) : launch_dkv<T, 64>(a);
    case 128: return DQ ? launch_dq<T, 128>(a) : launch_dkv<T, 128>(a);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <bool DQ>
static int dispatch(const BwdArgs& a, int d, int dtype) {
  if (a.hk < 1 || a.h % a.hk != 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return dispatch_d<float, DQ>(a, d);
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
