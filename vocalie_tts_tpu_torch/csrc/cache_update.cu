// In-place append of one decode step's rows into a stacked KV cache, for all
// layers at once, in one kernel body:
//   B5  the int8 k/v and their bf16 scales (the port's int8 cache);
//   K6  one int8 array (JAX's lane-packed k|v) and the two bf16 scale rows;
//   K4  k and v without scales (a bf16 or f32 cache);
//   K5  one array without scales (any dtype).
//
// Replaces: vocalie_tts_tpu/ops/cache_update.py::cache_append_stacked, each
// of its four branches: split with scales (_write_kv_scales_kernel, :74;
// pallas_call :174, B5), one array with scales (_write_k_scales_kernel,
// :67; pallas_call :154, K6), split without (_write_kv_kernel, :58;
// pallas_call :191, K4) and one array without (_write_k_kernel, :63;
// pallas_call :135, K5). The port keeps its caches split, so only JAX's API
// (ops/cache_update.py cache_append_kv_stacked) reaches K5 and K6. The TPU
// kernels read-modify-wrote an 8-row window (and the scales' whole T row)
// because Mosaic stores are 8-sublane aligned; a GPU writes exactly the new
// slot and nothing else.
//
// Bound: bytes. It reads the new rows and writes them once: L*b*kv rows of
// k (and of v) each way, plus 2 bf16 scales a row with scales: ~1 MB at the
// T3 int8 shape (30*16*16 rows, d 64), ~0.6 MB at Qwen3 (28*8*8 rows, d
// 128), ~1 MB for K4 at the T3 bf16 cache, 2 MB for K5's [30,16,16,128] bf16
// k|v: under a microsecond of HBM time each, so launch latency and the
// scattered 2-byte scale stores (one 32-byte sector each) are what it costs.
//
// Design: each row is copied in words of `word` bytes, chosen by the caller
// (ops/cache_update.py append_word): 16 where the row's bytes are a multiple
// of 16 and every pointer is 16-byte aligned (every bf16 or f32 row of d >=
// 8, the int8 rows of d 64 and 128), else 4, else 1. A grid of at most 4
// blocks an SM strides over the words (one 16-byte load and store a thread
// and step); with scales, the thread that copies word 0 of a row also writes
// that row's k and v scales at [r, pos]. The stores stay cached, since the
// next step's attention reads the slot.

#include <cuda_runtime.h>
#include <stdint.h>

template <typename V, bool SCALES>
__global__ void cache_append_kernel(
    uint8_t* __restrict__ k_cache, uint8_t* __restrict__ v_cache,         // [rows, T, row_bytes]
    uint16_t* __restrict__ k_scale, uint16_t* __restrict__ v_scale,       // [rows, T] bf16
    const uint8_t* __restrict__ k_new, const uint8_t* __restrict__ v_new, // [rows, row_bytes]
    const uint16_t* __restrict__ ks_new, const uint16_t* __restrict__ vs_new,  // [rows] bf16
    int rows, int T, int per_row, int shift, int pos) {
  V* kc = reinterpret_cast<V*>(k_cache);
  V* vc = reinterpret_cast<V*>(v_cache);
  const V* kn = reinterpret_cast<const V*>(k_new);
  const V* vn = reinterpret_cast<const V*>(v_new);
  const int total = rows * per_row;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < total; i += gridDim.x * blockDim.x) {
    // row r, word e of it: 32-bit index math, a shift where per_row is a
    // power of two (a 64-bit divide here cost B5 0.1-0.2 us a call, PERF.md §6)
    const int r = shift >= 0 ? i >> shift : i / per_row;
    const int e = i - r * per_row;
    const long long slot = (long long)r * T + pos;
    kc[slot * per_row + e] = __ldg(kn + i);
    if (vc != nullptr) vc[slot * per_row + e] = __ldg(vn + i);
    if (SCALES && e == 0) {
      k_scale[slot] = __ldg(ks_new + r);
      v_scale[slot] = __ldg(vs_new + r);
    }
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

template <bool SCALES>
static void launch(int word, unsigned blocks, cudaStream_t st, void* kc, void* vc, void* ksc,
                   void* vsc, const void* kn, const void* vn, const void* ksn, const void* vsn,
                   int rows, int T, int per_row, int pos) {
  const int shift = (per_row & (per_row - 1)) == 0 ? __builtin_ctz(per_row) : -1;
  const int threads = 256;
  uint8_t *k = (uint8_t*)kc, *v = (uint8_t*)vc;
  uint16_t *ks = (uint16_t*)ksc, *vs = (uint16_t*)vsc;
  const uint8_t *a = (const uint8_t*)kn, *b = (const uint8_t*)vn;
  const uint16_t *as = (const uint16_t*)ksn, *bs = (const uint16_t*)vsn;
  if (word == 16) {
    cache_append_kernel<uint4, SCALES><<<blocks, threads, 0, st>>>(
        k, v, ks, vs, a, b, as, bs, rows, T, per_row, shift, pos);
  } else if (word == 4) {
    cache_append_kernel<uint32_t, SCALES><<<blocks, threads, 0, st>>>(
        k, v, ks, vs, a, b, as, bs, rows, T, per_row, shift, pos);
  } else {
    cache_append_kernel<uint8_t, SCALES><<<blocks, threads, 0, st>>>(
        k, v, ks, vs, a, b, as, bs, rows, T, per_row, shift, pos);
  }
}

// Every branch: v_cache == v_new == null for one array; the four scale
// pointers all set (bf16) or all null. word: 16, 4 or 1; a row width or a
// cache or row pointer that is not a multiple of it is refused.
static int append(void* k_cache, void* v_cache, void* k_scale, void* v_scale, const void* k_new,
                  const void* v_new, const void* ks_new, const void* vs_new, long long rows,
                  int T, int row_bytes, int pos, int word, void* stream) {
  const bool scales = k_scale != nullptr;
  if (rows < 1 || row_bytes < 1 || pos < 0 || pos >= T ||
      (v_cache == nullptr) != (v_new == nullptr) || (word != 16 && word != 4 && word != 1) ||
      row_bytes % word != 0 || (v_scale != nullptr) != scales ||
      (ks_new != nullptr) != scales || (vs_new != nullptr) != scales) {
    return (int)cudaErrorInvalidValue;
  }
  const void* ptrs[4] = {k_cache, v_cache, k_new, v_new};
  for (const void* p : ptrs) {
    if ((uintptr_t)p % word != 0) return (int)cudaErrorMisalignedAddress;
  }
  const void* sptrs[4] = {k_scale, v_scale, ks_new, vs_new};
  for (const void* p : sptrs) {
    if ((uintptr_t)p % 2 != 0) return (int)cudaErrorMisalignedAddress;
  }
  const int per_row = row_bytes / word;
  if (rows * per_row >= (1LL << 30)) return (int)cudaErrorInvalidValue;   // 32-bit indices
  long long blocks = (rows * per_row + 255) / 256;
  const int sms = sm_count();
  if (sms > 0 && blocks > 4LL * sms) blocks = 4LL * sms;
  cudaStream_t st = (cudaStream_t)stream;
  if (scales) {
    launch<true>(word, (unsigned)blocks, st, k_cache, v_cache, k_scale, v_scale, k_new, v_new,
                 ks_new, vs_new, (int)rows, T, per_row, pos);
  } else {
    launch<false>(word, (unsigned)blocks, st, k_cache, v_cache, k_scale, v_scale, k_new, v_new,
                  ks_new, vs_new, (int)rows, T, per_row, pos);
  }
  return (int)cudaGetLastError();
}

// B5 (k and v) and K6 (v_cache == v_new == null): rows of row_bytes (d)
// int8 and their bf16 scales at slot pos.
extern "C" int vt_cache_append(void* k_cache, void* v_cache, void* k_scale, void* v_scale,
                               const void* k_new, const void* v_new, const void* ks_new,
                               const void* vs_new, long long rows, int T, int row_bytes, int pos,
                               int word, void* stream) {
  if (k_scale == nullptr) return (int)cudaErrorInvalidValue;
  return append(k_cache, v_cache, k_scale, v_scale, k_new, v_new, ks_new, vs_new, rows, T,
                row_bytes, pos, word, stream);
}

// K4 (k and v) and K5 (v_cache == v_new == null): rows without scales.
extern "C" int vt_cache_append_kv(void* k_cache, void* v_cache, const void* k_new,
                                  const void* v_new, long long rows, int T, int row_bytes,
                                  int pos, int word, void* stream) {
  return append(k_cache, v_cache, nullptr, nullptr, k_new, v_new, nullptr, nullptr, rows, T,
                row_bytes, pos, word, stream);
}
