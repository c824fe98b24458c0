// Tensor maps of the stacked int8 weight arrays for the TMA weight streams
// (cp.async.bulk.tensor in int8_stream.cuh): one map per [L, K, N] array
// and box height, encoded once by cuTensorMapEncodeTiled (which the runtime
// hands out through cudaGetDriverEntryPoint: no -lcuda) and cached by
// pointer and shape.
// Included by tail_swiglu.cu (B2, B8a), tail_gelu.cu (B9b) and
// decode_step.cu (B7); each keeps its own cache.

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
  int L, K, N, rows;
};

static std::mutex map_lock;
static MapKey map_keys[64];
static CUtensorMap map_vals[64];
static int map_count = 0;

// The map of a [L, K, N] int8 array at p, boxes of rows x 32 bytes, 32-byte
// swizzle; 0 on success.
static inline int weight_map(const void* p, int L, int K, int N, int rows, CUtensorMap* out) {
  std::lock_guard<std::mutex> guard(map_lock);
  const int n = map_count < 64 ? map_count : 64;
  for (int i = 0; i < n; ++i) {
    const MapKey& k = map_keys[i];
    if (k.p == p && k.L == L && k.K == K && k.N == N && k.rows == rows) {
      *out = map_vals[i];
      return 0;
    }
  }
  EncodeTiled enc = encoder();
  if (enc == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)N, (cuuint64_t)K, (cuuint64_t)L};
  const cuuint64_t strides[2] = {(cuuint64_t)N, (cuuint64_t)K * N};
  const cuuint32_t box[3] = {(cuuint32_t)SLAB, (cuuint32_t)rows, 1};
  const cuuint32_t estr[3] = {1, 1, 1};
  const CUresult r = enc(out, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, const_cast<void*>(p), dims,
                         strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_32B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return (int)cudaErrorInvalidValue;
  const int slot = map_count++ % 64;
  map_keys[slot] = MapKey{p, L, K, N, rows};
  map_vals[slot] = *out;
  return 0;
}

}  // namespace i8s
