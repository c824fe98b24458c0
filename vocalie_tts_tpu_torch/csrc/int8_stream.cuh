// Building blocks of the int8 decode products on Hopper's tensor cores
// (sm_90a), for persistent kernels that stream [K, N] int8 weights (N
// contiguous, the JAX layout) through shared memory while the activations
// (a few rows) stay there:
//   * the weight-tile stream: a tile is KC rows of a 32-column slab (32 bytes
//     a row, the 32-byte sector the card reads), requested by TMA boxes that
//     complete on the stage's mbarrier;
//   * the int8 tile product: mma.sync m16n8k32 (s8 x s8 -> s32) with the
//     activation rows as A (zero past the batch) and the slab as B; B's
//     fragment wants four consecutive k of one column in a register, so each
//     lane transposes two 4 x 4 byte blocks (__byte_perm) and the slab's 32
//     columns are spread over four n8 tiles (column 4 g + j is column g of
//     tile j);
//   * the row norm and the quantizer: a row over one or more warps, held in
//     registers (d <= 128 * MAX_VEC), RMSNorm with the mean of the squares
//     summed in double and rounded to f32 once, or LayerNorm with the mean
//     and then the centred variance each summed so, then the per-row int8
//     with s = max(amax / 127, 1e-8) and q = round_half_even(x / s) (the
//     IEEE divide's rounding, from a multiply where no tie is near).
//   * the layer-tail bodies' weight stream: a ring of mbarrier stages that
//     a block refills with its items' tiles as it consumes them.
// Included by tail_swiglu.cuh (B2, B8a and B12), tail_gelu.cu (B9b, B9c),
// decode_step.cu (B7) and dense_int8.cu (B3, B4, B9a).

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

namespace i8s {

constexpr int SLAB = 32;         // columns (bytes) of a weight slab row
constexpr int MAX_VEC = 8;       // float4s a lane holds of a normed row's part
constexpr int MAX_STAGES = 16;   // ring depth at most
constexpr int BOX_ROWS = 256;    // rows of a TMA box (the most a box dimension takes)
constexpr int RED_ROW = SLAB + 1;  // words a row of the int32 sums (no bank conflicts)
constexpr int QUANT_SCRATCH = 32 * 8 + 32 * 4;   // quant_rows' shared bytes

enum { KIND_NONE = 0, KIND_F32 = 1, KIND_BF16 = 2 };

__device__ __forceinline__ float load_f(const void* p, int kind, long long i) {
  return kind == KIND_BF16 ? __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(p)[i])
                           : reinterpret_cast<const float*>(p)[i];
}

__device__ __forceinline__ float quant_scale(float amax) {
  return fmaxf(__fdiv_rn(amax, 127.0f), 1e-8f);
}

__device__ __forceinline__ int quant(float v, float s) { return __float2int_rn(__fdiv_rn(v, s)); }

// quant(v, s) from v * r, r = 1 / s rounded: |v / s| <= 127.00001, so v * r
// is within 2^-16 and the rounded divide within 2^-17 of v / s; the two
// round to the same integer unless v * r lies within 2^-14 of a half
// integer (near_tie), where the divide is taken. Bit-equal to quant.
__device__ __forceinline__ bool near_tie(float y, float f) {
  return fabsf(fabsf(__fsub_rn(y, f)) - 0.5f) < 0x1p-14f;
}
__device__ __forceinline__ int quant_fast(float v, float s, float r) {
  const float y = __fmul_rn(v, r);
  const float f = rintf(y);
  return near_tie(y, f) ? quant(v, s) : (int)f;
}
// four values -> four int8 in a word, byte 0 the first
__device__ __forceinline__ uint32_t quant4(const float4& v, float s, float r) {
  return ((uint32_t)quant_fast(v.x, s, r) & 0xffu) |
         (((uint32_t)quant_fast(v.y, s, r) & 0xffu) << 8) |
         (((uint32_t)quant_fast(v.z, s, r) & 0xffu) << 16) |
         ((uint32_t)quant_fast(v.w, s, r) << 24);
}

// quant4 as a call, for the rare word with a near tie (quant4_fast): kept out
// of line so that the divides are not computed for every word (a template,
// so that the sources that do not use it compile no copy)
template <int UNUSED = 0>
__device__ __noinline__ uint32_t quant4_call(float4 v, float s, float r) {
  return quant4(v, s, r);
}

// quant4 without its float-to-int conversions (B3 and B4, dense_int8.cu):
// y + 1.5 * 2^23 rounds y (|y| < 2^22) to an integer, half to even, as
// rintf does, and the float's low byte is then that integer's int8 byte;
// four values with no near tie need no conversion and no divide, the others
// take quant4. Bit-equal to quant4.
__device__ __forceinline__ uint32_t quant4_fast(const float4& v, float s, float r) {
  constexpr float M = 12582912.0f;   // 1.5 * 2^23
  const float y0 = __fmul_rn(v.x, r), y1 = __fmul_rn(v.y, r);
  const float y2 = __fmul_rn(v.z, r), y3 = __fmul_rn(v.w, r);
  const float t0 = __fadd_rn(y0, M), t1 = __fadd_rn(y1, M);
  const float t2 = __fadd_rn(y2, M), t3 = __fadd_rn(y3, M);
  if (near_tie(y0, __fsub_rn(t0, M)) || near_tie(y1, __fsub_rn(t1, M)) ||
      near_tie(y2, __fsub_rn(t2, M)) || near_tie(y3, __fsub_rn(t3, M))) {
    return quant4_call<>(v, s, r);
  }
  return __byte_perm(__byte_perm(__float_as_uint(t0), __float_as_uint(t1), 0x0040),
                     __byte_perm(__float_as_uint(t2), __float_as_uint(t3), 0x0040), 0x5410);
}

// 4 consecutive norm weights (f32, or bf16) from index i (a multiple of 4)
__device__ __forceinline__ float4 load_f4(const void* p, int kind, int i) {
  if (kind == KIND_BF16) {
    const uint2 u = *reinterpret_cast<const uint2*>(reinterpret_cast<const __nv_bfloat16*>(p) + i);
    return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                       __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
  }
  return *reinterpret_cast<const float4*>(reinterpret_cast<const float*>(p) + i);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// The warps that compute: the whole block's (NCON 0), or the first NCON
// threads' in a block whose last warp only streams tiles (decode_step.cu).
template <int NCON>
__device__ __forceinline__ int block_warps() {
  return NCON == 0 ? (int)(blockDim.x >> 5) : NCON / 32;
}

// ── the weight-tile stream ───────────────────────────────────────────────

// the small inputs' 16-byte copies (generic proxy), waited for by group
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" :: "r"(dst), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}
// 16-byte copies of n bytes (a multiple of 16) from global src to shared
// dst by the computing threads (block_warps<NCON>)
template <int NCON = 0>
__device__ __forceinline__ void copy_async(uint32_t dst, const void* src, int n) {
  const int nt = 32 * block_warps<NCON>();
  for (int i = threadIdx.x; i < n / 16; i += nt) {
    cp_async16(dst + 16 * i, reinterpret_cast<const char*>(src) + 16 * i);
  }
}

// Tiles come by TMA (cp.async.bulk.tensor): one thread asks for a box of R
// rows x 32 bytes of a [L, K, N] int8 weight array (its tensor map encoded
// once on the host, CU_TENSOR_MAP_SWIZZLE_32B), the copy engine gathers the
// rows and completes a transaction count on the stage's mbarrier, and the
// requesting threads go on at once. Within a 32-byte row the two 16-byte
// chunks are swapped on rows whose bit 2 is set (the 32-byte swizzle), which
// the fragment loads below undo.
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra WAIT;\n"
      "DONE:\n"
      "}\n" :: "r"(bar), "r"(parity) : "memory");
}
// an L2 policy that evicts the lines it covers first (a stream read once)
__device__ __forceinline__ uint64_t evict_first_policy() {
  uint64_t p;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(p));
  return p;
}
// A weight tile: the kc rows of 32 bytes from `row` (a multiple of kc) at
// column col of layer `layer`, through a map of tensor_map.cuh's tile_map
// ([L, K / R, R, N], R = min(kc, BOX_ROWS)), into shared dst in one request
// that completes on bar (which is told to expect its bytes). EVICT_FIRST
// marks it to leave L2 first: the layer bodies read their weights once a
// call, and without the mark the stream evicted the kernels' code and small
// inputs (on an H100, B12 took 85.8 us a call instead of 71.6, B2 at the
// Qwen3 layer 5 % longer); B7 (decode_step.cu) asks without it, which it
// runs ~1 % faster (PERF.md §6).
template <bool EVICT_FIRST>
__device__ __forceinline__ void tma_load_tile(uint32_t dst, const void* map, int col, int row,
                                              int kc, int layer, uint32_t bar) {
  const int rows = kc < BOX_ROWS ? kc : BOX_ROWS;
  mbar_expect_tx(bar, kc * SLAB);
  if (EVICT_FIRST) {
    asm volatile(
        "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
        ".L2::cache_hint [%0], [%1, {%2, %3, %4, %5}], [%6], %7;\n"
        :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(0), "r"(row / rows),
           "r"(layer), "r"(bar), "l"(evict_first_policy())
        : "memory");
  } else {
    asm volatile(
        "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1, {%2, %3, %4, %5}], [%6];\n"
        :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(0), "r"(row / rows),
           "r"(layer), "r"(bar)
        : "memory");
  }
}
// bulk_load under an L2 policy
__device__ __forceinline__ void bulk_load_hint(uint32_t dst, const void* src, int n, uint32_t bar,
                                               uint64_t policy) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.L2::cache_hint"
      " [%0], [%1], %2, [%3], %4;\n"
      :: "r"(dst), "l"(src), "r"(n), "r"(bar), "l"(policy) : "memory");
}

// n bytes (a multiple of 16, both addresses 16-byte aligned) of contiguous
// global memory into shared dst by the copy engine, completing on bar
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, int n, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      :: "r"(dst), "l"(src), "r"(n), "r"(bar) : "memory");
}

// ── the int8 tile product ────────────────────────────────────────────────

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The 4 x 4 byte transpose: rows w[0..3] of 4 columns -> one word per
// column holding its 4 rows, byte 0 the lowest row.
__device__ __forceinline__ void transpose4(const uint32_t (&w)[4], uint32_t& c0, uint32_t& c1,
                                           uint32_t& c2, uint32_t& c3) {
  const uint32_t t0 = __byte_perm(w[0], w[1], 0x5140);
  const uint32_t t1 = __byte_perm(w[0], w[1], 0x7362);
  const uint32_t t2 = __byte_perm(w[2], w[3], 0x5140);
  const uint32_t t3 = __byte_perm(w[2], w[3], 0x7362);
  c0 = __byte_perm(t0, t2, 0x5410);
  c1 = __byte_perm(t0, t2, 0x7632);
  c2 = __byte_perm(t1, t3, 0x5410);
  c3 = __byte_perm(t1, t3, 0x7632);
}

__device__ __forceinline__ uint32_t lds32(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(v) : "r"(addr));
  return v;
}

// acc[m][j] += act[16 m.., kact + 32 s ..] . rows 32 s .. 32 s + 31 of the
// tile (one 32-row step; tile and act as shared addresses; the tile's rows
// 32 bytes, 32-byte swizzled; act's rows at or past b are zero; its row
// stride lda a multiple of 16). Lane (g = lane / 4, t = lane % 4) loads the B
// fragments of n8 tile j, column 4 g + j, at rows 32 s + 4 t .. + 3 and 32 s
// + 16 + 4 t .. + 3, and the A fragments of rows g and g + 8 at the same
// depths. Load r of lane t reads row 4 t + (r + t) % 4, which spreads the
// four t of a load over the 32 banks (rows 4 t + r would put them 128 bytes
// apart, in the same 8 banks); the B fragment's four k then come rotated by
// t, and so are the A fragment's bytes (one byte permute a word): a dot
// product over the same four k in another order, exact in int32.
template <int MT>
__device__ __forceinline__ void mma_step(uint32_t tile, int s, uint32_t act, int lda, int b,
                                         int kact, int (&acc)[MT][4][4]) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  // row 4 t + r: byte 32 row, chunk g / 4 swapped where bit 2 of the row,
  // t's bit 0, is set, word g % 4
  const uint32_t base = tile + 1024 * s + 128 * t + 16 * ((g >> 2) ^ (t & 1)) + 4 * (g & 3);
  uint32_t bf[4][2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    uint32_t w[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) w[r] = lds32(base + 32 * ((r + t) & 3) + 512 * h);
    transpose4(w, bf[0][h], bf[1][h], bf[2][h], bf[3][h]);
  }
  // byte i of an A word from byte (i + t) % 4
  const uint32_t rot = (t & 3) | (((t + 1) & 3) << 4) | (((t + 2) & 3) << 8) |
                       (((t + 3) & 3) << 12);
  const uint32_t arow = act + g * lda + kact + 32 * s + 4 * t;
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    const int r0 = 16 * m + g;
    const uint32_t a0 = arow + 16 * m * lda;
    uint32_t af[4];
    af[0] = r0 < b ? __byte_perm(lds32(a0), 0u, rot) : 0u;
    af[1] = r0 + 8 < b ? __byte_perm(lds32(a0 + 8 * lda), 0u, rot) : 0u;
    af[2] = r0 < b ? __byte_perm(lds32(a0 + 16), 0u, rot) : 0u;
    af[3] = r0 + 8 < b ? __byte_perm(lds32(a0 + 8 * lda + 16), 0u, rot) : 0u;
#pragma unroll
    for (int j = 0; j < 4; ++j) mma_s8(acc[m][j], af, bf[j][0], bf[j][1]);
  }
}

// acc += act[.., kact ..] . tile over the tile's kc rows: warp w of n
// (block_warps<NCON>) takes the 32-row steps w, w + n, ....
template <int MT, int NCON = 0>
__device__ __forceinline__ void tile_mma(uint32_t tile, int kc, uint32_t act, int lda, int b,
                                         int kact, int (&acc)[MT][4][4]) {
  const int warp = threadIdx.x >> 5, nwarp = block_warps<NCON>();
#pragma unroll 2
  for (int s = warp; s < kc / 32; s += nwarp) mma_step<MT>(tile, s, act, lda, b, kact, acc);
}

// The warps' int32 sums into red ([16 MT][RED_ROW], zero before; int32 adds
// are exact in any order), then acc is zeroed. Lane (g, t) of tile j holds
// rows g and g + 8 at columns 2 t and 2 t + 1 of the tile: slab columns 8 t +
// j and 8 t + 4 + j. A row is RED_ROW = 33 words, so the 32 lanes of an add
// (rows g, columns 8 t + j) fall in 32 banks.
template <int MT>
__device__ __forceinline__ void acc_to_red(int (&acc)[MT][4][4], int* red, int b) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    const int r0 = 16 * m + g, r1 = r0 + 8;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (r0 < b) {
        atomicAdd(&red[r0 * RED_ROW + 8 * t + j], acc[m][j][0]);
        atomicAdd(&red[r0 * RED_ROW + 8 * t + 4 + j], acc[m][j][1]);
      }
      if (r1 < b) {
        atomicAdd(&red[r1 * RED_ROW + 8 * t + j], acc[m][j][2]);
        atomicAdd(&red[r1 * RED_ROW + 8 * t + 4 + j], acc[m][j][3]);
      }
      acc[m][j][0] = acc[m][j][1] = acc[m][j][2] = acc[m][j][3] = 0;
    }
  }
}

// ── the row norm and the quantizer ───────────────────────────────────────

// Rows [0, b) of x ([b, d] f32; read through L2, so rows written earlier in
// the launch are seen) -> int8 at act + r * lda, the scales at rs[r]; with w
// (kind wkind), RMSNorm first: x * (1 / sqrt(mean(x * x) + eps)) * w, the
// mean of the squares summed in double and rounded once; with LN, LayerNorm
// instead: c = x - mean, ((c * (1 / sqrt(mean(c * c) + eps))) * w) + wb, the
// mean and the variance each summed in double and rounded once. A row is
// split over wpr warps (d / 4 divisible by wpr), each holding VEC float4 a
// lane of its part in registers (all its loads in flight at once): the
// parts' double sums are added in part order and their maxima met through
// shared memory (scratch: QUANT_SCRATCH bytes), so every block gets the
// same bits. Rows go nwarp / wpr at a time. XT is x's type: float, or
// __nv_bfloat16 (B3, B4 and B9a, dense_int8.cu), whose rows come four values
// (8 bytes) a load and are widened exactly; the float body is the same code.
// FASTQ quantizes with quant4_fast (B3, B4 and B9a), the same bits.
template <int VEC, bool LN, typename XT = float, bool FASTQ = false>
__device__ __forceinline__ void quant_rows_t(const XT* x, int b, int d, const void* w,
                                             const void* wb, int wkind, float eps, int8_t* act,
                                             int lda, float* rs, int wpr, void* scratch) {
  double* part_ss = reinterpret_cast<double*>(scratch);
  float* part_max = reinterpret_cast<float*>(part_ss + 32);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarp = blockDim.x >> 5;
  const int n4 = d >> 2, per = n4 / wpr;   // float4s of a part
  const int p = warp % wpr, rows = nwarp / wpr;
  for (int r0 = 0; r0 < b; r0 += rows) {
    const int r = r0 + warp / wpr;
    const bool live = warp / wpr < rows && r < b;
    float4 v[VEC];
    if constexpr (std::is_same<XT, float>::value) {
      const float4* xp = reinterpret_cast<const float4*>(x + (long long)(live ? r : 0) * d) + p * per;
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const int i = lane + 32 * j;
        v[j] = live && i < per ? __ldcg(xp + i) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      }
    } else {
      const uint2* xp = reinterpret_cast<const uint2*>(x + (long long)(live ? r : 0) * d) + p * per;
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const int i = lane + 32 * j;
        const uint2 u = live && i < per ? __ldcg(xp + i) : make_uint2(0u, 0u);
        v[j] = make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                           __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
      }
    }
    if (LN) {
      double s1 = 0.0;
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        s1 += (double)v[j].x + (double)v[j].y;
        s1 += (double)v[j].z + (double)v[j].w;
      }
      for (int o = 16; o > 0; o >>= 1) s1 += __shfl_xor_sync(0xffffffffu, s1, o);
      if (lane == 0) part_ss[warp] = s1;
      __syncthreads();
      s1 = part_ss[warp - p];
      for (int q = 1; q < wpr; ++q) s1 += part_ss[warp - p + q];
      const float mean = (float)(s1 / (double)d);
      double ss = 0.0;
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        if (lane + 32 * j < per) {   // the part's padding stays 0
          v[j].x = __fsub_rn(v[j].x, mean);
          v[j].y = __fsub_rn(v[j].y, mean);
          v[j].z = __fsub_rn(v[j].z, mean);
          v[j].w = __fsub_rn(v[j].w, mean);
        }
        ss += (double)v[j].x * (double)v[j].x + (double)v[j].y * (double)v[j].y;
        ss += (double)v[j].z * (double)v[j].z + (double)v[j].w * (double)v[j].w;
      }
      for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
      __syncthreads();   // every warp has read the means' parts
      if (lane == 0) part_ss[warp] = ss;
      __syncthreads();
      if (live) {
        ss = part_ss[warp - p];
        for (int q = 1; q < wpr; ++q) ss += part_ss[warp - p + q];
        const float var = (float)(ss / (double)d);
        const float inv = __frcp_rn(__fsqrt_rn(__fadd_rn(var, eps)));
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          const int i = lane + 32 * j;
          if (i < per) {
            const float4 gv = load_f4(w, wkind, 4 * (p * per + i));
            const float4 bv = load_f4(wb, wkind, 4 * (p * per + i));
            v[j].x = __fadd_rn(__fmul_rn(__fmul_rn(v[j].x, inv), gv.x), bv.x);
            v[j].y = __fadd_rn(__fmul_rn(__fmul_rn(v[j].y, inv), gv.y), bv.y);
            v[j].z = __fadd_rn(__fmul_rn(__fmul_rn(v[j].z, inv), gv.z), bv.z);
            v[j].w = __fadd_rn(__fmul_rn(__fmul_rn(v[j].w, inv), gv.w), bv.w);
          }
        }
      }
    } else if (wkind != KIND_NONE) {
      double ss = 0.0;
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        ss += (double)v[j].x * (double)v[j].x + (double)v[j].y * (double)v[j].y;
        ss += (double)v[j].z * (double)v[j].z + (double)v[j].w * (double)v[j].w;
      }
      for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
      if (lane == 0) part_ss[warp] = ss;
      __syncthreads();
      if (live) {
        ss = part_ss[warp - p];
        for (int q = 1; q < wpr; ++q) ss += part_ss[warp - p + q];
        const float var = (float)(ss / (double)d);
        const float inv = __frcp_rn(__fsqrt_rn(__fadd_rn(var, eps)));
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          const int i = lane + 32 * j;
          if (i < per) {
            const float4 wv = load_f4(w, wkind, 4 * (p * per + i));
            v[j].x = __fmul_rn(__fmul_rn(v[j].x, inv), wv.x);
            v[j].y = __fmul_rn(__fmul_rn(v[j].y, inv), wv.y);
            v[j].z = __fmul_rn(__fmul_rn(v[j].z, inv), wv.z);
            v[j].w = __fmul_rn(__fmul_rn(v[j].w, inv), wv.w);
          }
        }
      }
    }
    float amax = 0.0f;
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      if (LN && lane + 32 * j >= per) continue;
      amax = fmaxf(amax, fmaxf(fmaxf(fabsf(v[j].x), fabsf(v[j].y)),
                               fmaxf(fabsf(v[j].z), fabsf(v[j].w))));
    }
    for (int o = 16; o > 0; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
    if (lane == 0) part_max[warp] = amax;
    __syncthreads();
    if (live) {
      for (int q = 0; q < wpr; ++q) amax = fmaxf(amax, part_max[warp - p + q]);
      const float s = quant_scale(amax);
      const float inv_s = __frcp_rn(s);
      int8_t* dst = act + r * lda + 4 * p * per;
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const int i = lane + 32 * j;
        if (i < per) {
          *reinterpret_cast<uint32_t*>(dst + 4 * i) =
              FASTQ ? quant4_fast(v[j], s, inv_s) : quant4(v[j], s, inv_s);
        }
      }
      if (lane == 0 && p == 0) rs[r] = s;
    }
    __syncthreads();   // the parts are read before the next rows write them
  }
}

// The warps a row and the float4s a lane: a row's part at most MAX_VEC
// float4 a lane and as many warps a row as the block has to spare (a power
// of two, at least 32 float4 a part), the part's float4s a lane rounded up
// to a power of two (d % 4 == 0, d <= 128 MAX_VEC * nwarp).
__device__ __forceinline__ int rows_split(int b, int d, int& vec) {
  const int nwarp = blockDim.x >> 5, n4 = d >> 2;
  int wpr = 1;
  while (n4 / wpr > 32 * MAX_VEC ||
         (2 * wpr * b <= nwarp && n4 % (2 * wpr) == 0 && n4 / (2 * wpr) >= 32)) {
    wpr *= 2;
  }
  vec = (n4 / wpr + 31) / 32;
  return wpr;
}

// quant_rows_t split by rows_split, RMSNorm (or none; with LN, LayerNorm:
// gain w, bias wb), on f32 rows or (XT, B9d's) bf16 ones. Not inlined: one
// copy of the code serves every call (the instruction cache is small). Ends
// with __syncthreads().
template <bool LN, typename XT = float>
static __device__ __noinline__ void quant_rows_n(const XT* x, int b, int d, const void* w,
                                                 const void* wb, int wkind, float eps,
                                                 int8_t* act, int lda, float* rs, void* scratch) {
  int vec;
  const int wpr = rows_split(b, d, vec);
  if (vec <= 1) {
    quant_rows_t<1, LN, XT>(x, b, d, w, wb, wkind, eps, act, lda, rs, wpr, scratch);
  } else if (vec <= 2) {
    quant_rows_t<2, LN, XT>(x, b, d, w, wb, wkind, eps, act, lda, rs, wpr, scratch);
  } else if (vec <= 4) {
    quant_rows_t<4, LN, XT>(x, b, d, w, wb, wkind, eps, act, lda, rs, wpr, scratch);
  } else {
    quant_rows_t<MAX_VEC, LN, XT>(x, b, d, w, wb, wkind, eps, act, lda, rs, wpr, scratch);
  }
}

__device__ __forceinline__ void quant_rows(const float* x, int b, int d, const void* w, int wkind,
                                           float eps, int8_t* act, int lda, float* rs,
                                           void* scratch) {
  quant_rows_n<false>(x, b, d, w, nullptr, wkind, eps, act, lda, rs, scratch);
}

// quant_rows on f32 or bf16 rows (x 16- or 8-byte aligned, d % 4 == 0)
// with quant4_fast, inlined: B3's and B4's (dense_int8.cu), whose one call
// site a launch ran ~1.3 us faster inlined than as quant_rows_n's call on an
// H100 (PERF.md §6); with LN, B9a's LayerNorm (gain w, bias wb) in place of
// the RMSNorm, quant_rows_t's LN branch
template <bool LN, typename XT>
__device__ __forceinline__ void quant_rows_dense(const XT* x, int b, int d, const void* w,
                                                 const void* wb, int wkind, float eps,
                                                 int8_t* act, int lda, float* rs, void* scratch) {
  int vec;
  const int wpr = rows_split(b, d, vec);
  if (vec <= 1) {
    quant_rows_t<1, LN, XT, true>(x, b, d, w, wb, wkind, eps, act, lda, rs, wpr, scratch);
  } else if (vec <= 2) {
    quant_rows_t<2, LN, XT, true>(x, b, d, w, wb, wkind, eps, act, lda, rs, wpr, scratch);
  } else if (vec <= 4) {
    quant_rows_t<4, LN, XT, true>(x, b, d, w, wb, wkind, eps, act, lda, rs, wpr, scratch);
  } else {
    quant_rows_t<MAX_VEC, LN, XT, true>(x, b, d, w, wb, wkind, eps, act, lda, rs, wpr, scratch);
  }
}

__device__ __forceinline__ void quant_rows_ln(const float* x, int b, int d, const void* g,
                                              const void* gb, int gkind, float eps, int8_t* act,
                                              int lda, float* rs, void* scratch) {
  quant_rows_n<true>(x, b, d, g, gb, gkind, eps, act, lda, rs, scratch);
}

// ── a layer-tail body's weight stream (tail_swiglu.cu, tail_gelu.cu) ─────

constexpr int TAIL_STAMPS = 12;        // a block's phase points in a trace
constexpr int TAIL_TILE_STAMPS = 64;   // then the clock as each of its first 64 tiles lands

// threads a block: 16 warps for b <= 16, 8 for b <= 32 (twice the registers
// for the second m16 tile)
template <int MT>
__host__ __device__ constexpr int threads() { return MT == 1 ? 512 : 256; }

// A block's weight stream: its items in order, each item's tiles in order;
// `next` counts the tiles consumed, `groups` the tiles requested, (pi, pj) is
// the next tile to request; tiles of products past `cap` wait (the
// o-projection's tiles go out alone). Stage s holds tiles s, s + stages, ...;
// its mbarrier's phase n completes when tile s + n stages has landed. The
// body's arguments `a` (stages, kc, stamps) and its tile_request(a, m, code,
// j, dst, bar) and item_tiles(a, code), declared beside a's type, say what
// an item's tiles are.
struct TileRing {
  const int* items;
  int n_items, pi, pj, next, groups, cap;
  uint32_t base, bars;
};

// Requests the stream's next tile into its stage, if it is due (thread 0
// asks the copy engine; every thread keeps the same counts).
template <class A, class M>
__device__ __forceinline__ void request(const A& a, const M& m, TileRing& rg) {
  if (rg.pi >= rg.n_items || (rg.items[rg.pi] >> 24) > rg.cap) return;
  const int code = rg.items[rg.pi];
  const int s = rg.groups % a.stages;
  if (threadIdx.x == 0) tile_request(a, m, code, rg.pj, rg.base + s * a.kc * SLAB, rg.bars + 8 * s);
  ++rg.groups;
  if (++rg.pj == item_tiles(a, code)) {
    rg.pj = 0;
    ++rg.pi;
  }
}

// Fills the ring: the stream's due tiles, up to `stages` ahead.
template <class A, class M>
__device__ __forceinline__ void fill(const A& a, const M& m, TileRing& rg) {
  for (int g = rg.groups; rg.groups < rg.next + a.stages; g = rg.groups) {
    request(a, m, rg);
    if (rg.groups == g) break;
  }
}

// The next tile, once it has landed.
template <class A>
__device__ __forceinline__ uint32_t wait_tile(const A& a, TileRing& rg) {
  const int s = rg.next % a.stages;
  mbar_wait(rg.bars + 8 * s, (rg.next / a.stages) & 1);
  if (a.stamps != nullptr && threadIdx.x == 0 && rg.next < TAIL_TILE_STAMPS) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    a.stamps[gridDim.x * TAIL_STAMPS + blockIdx.x * TAIL_TILE_STAMPS + rg.next] = t;
  }
  return rg.base + s * a.kc * SLAB;
}

// The tile is read by every warp: its stage takes the stream's next tile.
template <class A, class M>
__device__ __forceinline__ void release_tile(const A& a, const M& m, TileRing& rg) {
  __syncthreads();
  ++rg.next;
  fill(a, m, rg);
}

// The small inputs (the block's only cp.async group) have landed.
__device__ __forceinline__ void wait_first() {
  cp_async_wait<0>();
  __syncthreads();
}

// thread 0 of each block writes the card's ns clock for phase point i (a
// trace of where a call's time goes; off when the pointer is null)
template <class A>
__device__ __forceinline__ void stamp(const A& a, int i) {
  if (a.stamps != nullptr && threadIdx.x == 0) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    a.stamps[blockIdx.x * TAIL_STAMPS + i] = t;
  }
}

template <int MT>
__device__ __forceinline__ void zero_acc(int (&acc)[MT][4][4]) {
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[m][j][0] = acc[m][j][1] = acc[m][j][2] = acc[m][j][3] = 0;
}

}  // namespace i8s
