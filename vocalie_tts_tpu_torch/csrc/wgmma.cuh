// Building blocks of the Hopper tensor-core bodies (sm_90a): asynchronous
// tile loads into the 128-byte-swizzled panels that wgmma's descriptors
// read, the descriptors, wgmma m64n64k16 with both operands from shared
// memory or A from registers, and the accumulator-to-A-fragment packing.
// Included by flash_attention.cu (B6, B6t) and flash_attention_bwd.cu (B11).
//
// Layouts every user relies on:
//   * a [64 rows, D] bf16 tile sits in D/64 panels of [64][64], each row 128
//     bytes, 16-byte chunk c of row r at chunk c ^ (r % 8) (load_tile);
//   * such a tile is a K-major operand when its columns are the product's
//     depth (Q or K in S = Q.K^T: k-slice kk of 16 columns at byte offset
//     (kk / 4) * PANEL + (kk % 4) * 32) and an MN-major B when its rows are
//     the depth (V in O += P.V: 16 rows of panel p at p * PANEL + kk * 2048);
//   * a [64 x 64] f32 accumulator x: thread t (warp w = t / 32, lane l) holds
//     x[4c + e] = row 16 w + l / 4 + 8 (e / 2), column 8 c + 2 (l % 4) + e % 2.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace tc {

constexpr int THREADS = 128;           // one warpgroup
constexpr int PANEL = 64 * 128;        // bytes of 64 rows x 64 bf16 columns (128-byte rows)
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared, asynchronous; zero-filled (nothing read) when !ok
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(ok ? 16 : 0) : "memory");
}
// 4 bytes global -> shared (for f32 rows at any offset); zero-filled when !ok
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(ok ? 4 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}
// cp.async's writes (generic proxy) -> visible to wgmma's reads (async proxy)
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// A [64 rows, D] bf16 tile (row stride D) -> D/64 panels of [64][64] at dst,
// each 64-column row 128 bytes with the 128-byte swizzle (16-byte chunk c of
// row r at chunk c ^ (r % 8)), the layout wgmma's descriptors read below.
// Rows at or past ``rows`` are zero-filled.
template <int D>
__device__ __forceinline__ void load_tile(uint32_t dst, const __nv_bfloat16* src, int rows,
                                          int tid) {
  constexpr int ROW_CHUNKS = D / 8;
#pragma unroll
  for (int i = 0; i < 64 * ROW_CHUNKS / THREADS; ++i) {
    const int c = i * THREADS + tid;
    const int r = c / ROW_CHUNKS, col = c % ROW_CHUNKS;
    const int panel = col >> 3, ch = col & 7;
    const bool ok = r < rows;
    cp_async16(dst + panel * PANEL + r * 128 + ((ch ^ (r & 7)) << 4),
               src + (long long)(ok ? r : 0) * D + col * 8, ok);
  }
}

// byte offset of k-slice kk (16 columns of the depth) in a K-major tile
__device__ __forceinline__ uint32_t k_major(int kk) { return (kk >> 2) * PANEL + (kk & 3) * 32; }
// byte offset of depth rows 16 kk.. of output panel p in an MN-major tile
__device__ __forceinline__ uint32_t mn_major(int p, int kk) { return p * PANEL + kk * 2048; }

// wgmma shared-memory descriptor of a 128-byte-swizzled panel: start address
// >> 4, 8-row groups 1024 bytes apart (the stride field; the leading field is
// given the same value: no operand here spans two 64-column atoms of the
// swizzle, where it would be read), layout 1 = 128-byte swizzle.
__device__ __forceinline__ uint64_t desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(1024 >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keep the compiler from moving accumulator reads and writes across the
// asynchronous wgmma
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

// d[64 x 64] (+)= A[64 x 16] . B[16 x 64], A and B K-major in shared memory
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(acc));
}

// d[64 x 64] += A[64 x 16] . B[16 x 64], A (bf16 pairs) in registers, B
// MN-major in shared memory (trans-b = 1)
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 t = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&t);
}

// A [64 x 64] accumulator x rounded to bf16 as wgmma's register A operand:
// the columns 16 j..16 j + 15 are the fragment a[j] of k-slice j (registers
// 2 (c % 2) + row half, c = the 8-column group)
__device__ __forceinline__ void acc_to_a(const float (&x)[32], uint32_t (&a)[4][4]) {
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    a[c >> 1][(c & 1) * 2 + 0] = pack_bf16(x[4 * c + 0], x[4 * c + 1]);
    a[c >> 1][(c & 1) * 2 + 1] = pack_bf16(x[4 * c + 2], x[4 * c + 3]);
  }
}

// x as two bf16 A operands, hi = bf16(x) and lo = bf16(x - hi): the pair
// carries 16 of f32's 24 significand bits into an f32-accumulating product
__device__ __forceinline__ void acc_to_a_split(const float (&x)[32], uint32_t (&hi)[4][4],
                                               uint32_t (&lo)[4][4]) {
#pragma unroll
  for (int c = 0; c < 8; ++c) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float a = x[4 * c + 2 * r], b = x[4 * c + 2 * r + 1];
      const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
      const float2 hf = __bfloat1622float2(h);
      hi[c >> 1][(c & 1) * 2 + r] = *reinterpret_cast<const uint32_t*>(&h);
      lo[c >> 1][(c & 1) * 2 + r] = pack_bf16(a - hf.x, b - hf.y);
    }
  }
}

}  // namespace tc
