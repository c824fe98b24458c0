// Tensor maps of the stacked int8 weight arrays for the TMA weight streams
// (int8_stream.cuh tma_load_tile): one map per [L, K, N] array and tile
// height, encoded once by cuTensorMapEncodeTiled (which the runtime
// hands out through cudaGetDriverEntryPoint: no -lcuda) and cached by
// pointer and shape.
// Included by tail_swiglu.cuh (B2, B8a and B12), tail_gelu.cu (B9b, B9c),
// decode_step.cu (B7) and dense_int8.cu (B3, B4); each source keeps its own
// cache.

#pragma once

#include <cuda.h>   // CUtensorMap and the encoder's types; the encoder comes from the runtime
#include <cuda_runtime.h>
#include <mutex>

#include "int8_stream.cuh"

namespace i8s {

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

static EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) ==
            cudaSuccess && q == cudaDriverEntryPointSuccess) {
      fn = (EncodeTiled)p;
    }
  }
  return fn;
}

struct MapKey {
  const void* p;
  int L, K, N, kc;
};

static std::mutex map_lock;
static MapKey map_keys[64];
static CUtensorMap map_vals[64];
static int map_count = 0;

// The map through which tma_load_tile (int8_stream.cuh) asks for a tile of
// kc rows of a [L, K, N] int8 array at p in one request: the array seen as
// [L, K / R, R, N] (R = min(kc, BOX_ROWS), the most rows a box dimension
// takes), boxes of kc / R x R rows x 32 bytes, 32-byte swizzle (which
// follows the shared address, so a tile lands as R-row boxes one after the
// other would); 0 on success, cudaErrorInvalidValue for a kc that is not a
// whole number of R-row boxes of K.
static inline int tile_map(const void* p, int L, int K, int N, int kc, CUtensorMap* out) {
  std::lock_guard<std::mutex> guard(map_lock);
  const int n = map_count < 64 ? map_count : 64;
  for (int i = 0; i < n; ++i) {
    const MapKey& k = map_keys[i];
    if (k.p == p && k.L == L && k.K == K && k.N == N && k.kc == kc) {
      *out = map_vals[i];
      return 0;
    }
  }
  const int rows = kc < BOX_ROWS ? kc : BOX_ROWS;
  if (kc < 1 || kc % rows || K % rows || kc / rows > 256) return (int)cudaErrorInvalidValue;
  EncodeTiled enc = encoder();
  if (enc == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)N, (cuuint64_t)rows, (cuuint64_t)(K / rows),
                              (cuuint64_t)L};
  const cuuint64_t strides[3] = {(cuuint64_t)N, (cuuint64_t)rows * N, (cuuint64_t)K * N};
  const cuuint32_t box[4] = {(cuuint32_t)SLAB, (cuuint32_t)rows, (cuuint32_t)(kc / rows), 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  const CUresult r = enc(out, CU_TENSOR_MAP_DATA_TYPE_UINT8, 4, const_cast<void*>(p), dims,
                         strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_32B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return (int)cudaErrorInvalidValue;
  const int slot = map_count++ % 64;
  map_keys[slot] = MapKey{p, L, K, N, kc};
  map_vals[slot] = *out;
  return 0;
}

}  // namespace i8s
