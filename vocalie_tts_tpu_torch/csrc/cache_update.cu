// In-place append of one decode step's int8 k/v and their bf16 scales
// into the stacked KV cache, for all layers at once (B5); below it, the
// same for a cache without scales, k and v (K4) or one array (K5).
//
// Replaces: vocalie_tts_tpu/ops/cache_update.py::cache_append_stacked
// (the split k/v + scales branch, _write_kv_scales_kernel). The TPU
// kernel read-modify-wrote an 8-row window because Mosaic stores are
// 8-sublane aligned; a GPU writes single bytes, so this kernel writes
// exactly the new slot and nothing else.
//
// Bound: bytes. It reads the new rows and writes them once:
// L*b*kv*(2*d int8 + 2 bf16 scales) each way, ~1 MB at the main-path
// shape (30*16*16 rows, d=64) -- well under a microsecond of HBM time,
// so launch latency is what this kernel costs.
//
// Design: one thread per byte of the new k/v rows; the thread that owns
// a row's first byte also writes the row's two scales.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

__global__ void cache_append_kernel(
    int8_t* __restrict__ k_cache, int8_t* __restrict__ v_cache,       // [rows, T, d]
    __nv_bfloat16* __restrict__ k_scale, __nv_bfloat16* __restrict__ v_scale,  // [rows, T]
    const int8_t* __restrict__ k_new, const int8_t* __restrict__ v_new,         // [rows, d]
    const __nv_bfloat16* __restrict__ ks_new, const __nv_bfloat16* __restrict__ vs_new,  // [rows]
    long long rows, int T, int d, int pos) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= rows * d) return;
  long long r = i / d;
  int e = (int)(i - r * d);
  long long dst = (r * T + pos) * d + e;
  k_cache[dst] = k_new[i];
  v_cache[dst] = v_new[i];
  if (e == 0) {
    k_scale[r * T + pos] = ks_new[r];
    v_scale[r * T + pos] = vs_new[r];
  }
}

extern "C" int vt_cache_append(
    void* k_cache, void* v_cache, void* k_scale, void* v_scale,
    const void* k_new, const void* v_new, const void* ks_new, const void* vs_new,
    long long rows, int T, int d, int pos, void* stream) {
  const int threads = 256;
  long long total = rows * d;
  unsigned int blocks = (unsigned int)((total + threads - 1) / threads);
  cache_append_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (int8_t*)k_cache, (int8_t*)v_cache,
      (__nv_bfloat16*)k_scale, (__nv_bfloat16*)v_scale,
      (const int8_t*)k_new, (const int8_t*)v_new,
      (const __nv_bfloat16*)ks_new, (const __nv_bfloat16*)vs_new,
      rows, T, d, pos);
  return (int)cudaGetLastError();
}


// ---------------------------------------------------------------------------
// K4 and K5: in-place append of one decode step's rows into a stacked cache
// without scales, for all layers at once: k and v (K4, a bf16 or f32 cache)
// or one array (K5, v null: any dtype, the lane-packed k|v of JAX's API).
//
// Replaces: vocalie_tts_tpu/ops/cache_update.py::cache_append_stacked on
// its no-scale branches: the split one (_write_kv_kernel, :58; pallas_call
// :191), which the decode step takes for a bf16 cache when the decode or
// the dense kernels are on, and the one-array one (_write_k_kernel, :63;
// pallas_call :135), which JAX's packed cache without scales takes (the
// port keeps its caches split, so only JAX's API reaches it). As B5, it
// writes exactly the new slot (the TPU kernel's 8-row read-modify-write
// window is a Mosaic store rule).
//
// Bound: bytes. It reads the new rows and writes them once:
// L*b*kv rows of k (and of v) each way, ~1 MB at the Chatterbox shape
// (30*16*16 rows, d 64, bf16), 2 MB for K5's [30,16,16,128] bf16 k|v.
//
// Design: each row is copied in words of `word` bytes, chosen by the
// caller (ops/cache_update.py append_word): 16 where the row's bytes are a
// multiple of 16 and every pointer is 16-byte aligned (every bf16 or f32
// row of d >= 8, the int8 rows of d 64 and 128), else 4, else 1. A grid of
// a few blocks an SM strides over the words (one 16-byte load and store a
// thread and step); the stores stay cached, since the next step's attention
// reads the slot.

template <typename V>
__global__ void cache_append_kv_kernel(
    uint8_t* __restrict__ k_cache, uint8_t* __restrict__ v_cache,       // [rows, T, row_bytes]
    const uint8_t* __restrict__ k_new, const uint8_t* __restrict__ v_new, // [rows, row_bytes]
    long long rows, int T, int per_row, int pos) {
  V* kc = reinterpret_cast<V*>(k_cache);
  V* vc = reinterpret_cast<V*>(v_cache);
  const V* kn = reinterpret_cast<const V*>(k_new);
  const V* vn = reinterpret_cast<const V*>(v_new);
  const long long total = rows * per_row;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (long long)gridDim.x * blockDim.x) {
    const long long r = i / per_row;
    const long long dst = (r * T + pos) * per_row + (i - r * per_row);
    kc[dst] = __ldg(kn + i);
    if (vc != nullptr) vc[dst] = __ldg(vn + i);
  }
}

static int sm_count() {
  static int n[64];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  int& c = n[dev & 63];
  if (c == 0 && cudaDeviceGetAttribute(&c, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) {
    c = 0;
  }
  return c;
}

// v_cache == v_new == null: one array (K5). word: 16, 4 or 1; a row width or
// a pointer that is not a multiple of it is refused.
extern "C" int vt_cache_append_kv(
    void* k_cache, void* v_cache, const void* k_new, const void* v_new,
    long long rows, int T, int row_bytes, int pos, int word, void* stream) {
  if (rows < 1 || row_bytes < 1 || pos < 0 || pos >= T ||
      (v_cache == nullptr) != (v_new == nullptr) || (word != 16 && word != 4 && word != 1) ||
      row_bytes % word != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const void* ptrs[4] = {k_cache, v_cache, k_new, v_new};
  for (const void* p : ptrs) {
    if ((uintptr_t)p % word != 0) return (int)cudaErrorMisalignedAddress;
  }
  const int threads = 256;
  const int per_row = row_bytes / word;
  const long long total = rows * per_row;
  long long blocks = (total + threads - 1) / threads;
  const int sms = sm_count();
  if (sms > 0 && blocks > 4LL * sms) blocks = 4LL * sms;
  cudaStream_t st = (cudaStream_t)stream;
  uint8_t* kc = (uint8_t*)k_cache;
  uint8_t* vc = (uint8_t*)v_cache;
  const uint8_t* kn = (const uint8_t*)k_new;
  const uint8_t* vn = (const uint8_t*)v_new;
  if (word == 16) {
    cache_append_kv_kernel<uint4><<<(unsigned)blocks, threads, 0, st>>>(kc, vc, kn, vn, rows, T,
                                                                        per_row, pos);
  } else if (word == 4) {
    cache_append_kv_kernel<uint32_t><<<(unsigned)blocks, threads, 0, st>>>(kc, vc, kn, vn, rows,
                                                                           T, per_row, pos);
  } else {
    cache_append_kv_kernel<uint8_t><<<(unsigned)blocks, threads, 0, st>>>(kc, vc, kn, vn, rows, T,
                                                                          per_row, pos);
  }
  return (int)cudaGetLastError();
}
