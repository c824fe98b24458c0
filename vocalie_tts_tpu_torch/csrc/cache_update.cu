// In-place append of one decode step's int8 k/v and their bf16 scales
// into the stacked KV cache, for all layers at once.
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
