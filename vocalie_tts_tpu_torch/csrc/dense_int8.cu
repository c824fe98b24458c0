// B4 (the int8 product of per-row int8 activations), B3 (RMSNorm + the
// fused int8 qkv product) and B9a (LayerNorm + the fused int8 qkv product) as
// ONE launch each, on the int8 weight stream of the layer bodies
// (int8_stream.cuh): TMA weight slices, int8 mma.sync, and split-K met in a
// thread-block cluster.
//
// Replaces, in vocalie_tts_tpu/ops/decode_dense.py:
//   B4 dense_int8_stacked      (def :116, pallas_call :143)
//   B3 qkv_norm_int8_stacked   (def :269, pallas_call :302)
//   B9a qkv_lnorm_int8_stacked (def :652, pallas_call :686)
// The math is theirs, step for step, and the plain versions' in
// ops/decode_dense.py (dense_int8_plain, qkv_norm_int8_plain,
// qkv_lnorm_int8_plain):
//   h   = x (B4), or x * (1 / sqrt(mean(x * x) + eps)) * nw[l] (B3), the mean
//         of the squares summed in double and rounded to f32 once, or (B9a)
//         c * (1 / sqrt(mean(c * c) + eps)) * nw[l] + nb[l], c = x - mean(x),
//         the mean and the variance each summed in double and rounded once;
//   q   = round_half_even(h / s), s = max(max|h| / 127, 1e-8), per row;
//   out = (float(q . W[l]) * s) * ws[l], the product int8 x int8 in int32
// (exact in any order, so the K split costs no bit), every f32 step an IEEE
// intrinsic: the outputs are bit-equal to the plain versions' and to the old
// three-kernel chain of decode_dense.cu (norm_quant or ln_quant,
// gemv_partial, gemv_finish), which still runs the shapes this body does not
// take.
//
// Bound: bytes. Each weight byte serves b <= 32 multiply-adds, far below the
// ~590 int8 operations a byte at which Hopper's tensor cores become the
// limit. B3 reads 3.1 MB of int8 weights a call at the T3 layer ([16, 1024]
// x [1024, 3072]: 1.0 us at 3.35 TB/s) and 8.4 MB at the Qwen3 layer ([8,
// 2048] x [2048, 4096]: 2.6 us); B4 on the lm_head 1.2 MB at T3 ([1024,
// 1152]) and 4.5 MB at Qwen3 ([2048, 2176]); B9a 3.1 MB at the XTTS layer
// ([8, 1024] x [1024, 3072]: 0.98 us).
//
// Design. The old chain was three kernels a call (a block a row reading the
// row three times, __dp4a partials over K slices written to a workspace, a
// finish kernel adding them), each draining the card, and its weights came
// by 4-byte __ldg with nothing in flight across a kernel boundary. Here:
//   * a block owns `spb` 32-column slabs of the output (one at every served
//     shape but the Qwen3 DENSE_FNS qkv's two) and a range of their K rows;
//     where the slabs are too few to fill the card, a cluster of `ks` blocks
//     splits K (rank r takes K tiles [r T / ks, (r + 1) T / ks) of the T),
//     and the ranks' int32 sums meet through distributed shared memory: each
//     rank adds every rank's sums for its share of the outputs.
//     ops/decode_dense.py dense_plan picks spb, ks (the most, up to 8, whose
//     clusters all stay resident) and the tile rows kc within one wave of the
//     card's SMs, cached per shape;
//   * at entry the warps ask the copy engine for every weight tile of the
//     block (kc rows x 32 bytes, one TMA request and one mbarrier a tile,
//     marked to leave L2 first: the weights are read once a call; lane 0 of
//     warp w asks for tiles w, w + nwarp, ...: a request holds its thread);
//     the whole slice fits in shared memory, so there is no ring;
//   * while the tiles land, every block norms and quantizes all b rows
//     itself into shared int8 (quant_rows' body inlined, f32 or bf16 rows,
//     with the conversion-free quant4_fast: the same bits in every block),
//     which needs no grid barrier and no workspace; B3's norm weights (B9a's
//     gains and biases) are prefetched into L1 at entry, where the norm reads
//     them after its first reduction (B9a's after its second). The norm is the launch's critical path: on an H100 it ends
//     ~3.6 us after entry for B4's 16 rows of 1024, ~4.4 us for B3's, ~6.5
//     us for B3's 8 rows of 2048, when the weights have landed; without it
//     the launch would take 5.3-8.5 us graph-timed instead of 8-11 (PERF.md
//     §6). A cluster sharing the norm (its rows written into every rank's
//     shared memory) and 128-byte-wide tiles were measured and ran slower;
//   * each warp takes 32-row steps of the slice, waits for its step's tile
//     and multiplies on the int8 tensor cores (mma m16n8k32, one m16 tile for
//     b <= 16, two for b <= 32); the warps meet by shared int32 adds;
//   * the epilogue writes f32 [b, N] and nothing else.
// `stamps` (null, or [grid, DENSE_STAMPS] u64) records the card's ns clock
// at the block's entry, when thread 0 has asked for its tiles, after the
// norm, after the products, after the cluster's meet and at the end.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "int8_stream.cuh"
#include "tensor_map.cuh"

namespace cg = cooperative_groups;
using namespace i8s;

namespace {

constexpr int DENSE_MAX_B = 32;
constexpr int DENSE_MAX_K = 8192;    // quant_rows' reach with 8 warps, whole parts
constexpr int DENSE_MAX_KS = 8;      // a portable cluster
constexpr int DENSE_KC_MAX = 256;    // tile rows: one TMA box
constexpr int DENSE_SMEM_MAX = 232448;
constexpr int DENSE_STAMPS = 6;

struct DenseArgs {
  const void* x;      // [b, K] (x_kind)
  const void* nw;     // [K] the layer's norm weights or gains (nw_kind), or null (B4)
  const void* nb;     // [K] the layer's LayerNorm biases (nw_kind; B9a), or null
  const float* s;     // [N] the layer's column scales
  float* out;         // [b, N]
  unsigned long long* stamps;
  int x_kind, nw_kind, layer, b, K, N, ks, spb, kc, tiles, lda;
  float eps;
};

// shared memory, in order: the block's weight tiles (spb slabs of tr tiles,
// a slab's tiles contiguous), the int8 rows [b][K + 16], the int32 sums
// [spb][16 MT][RED_ROW], the row scales, the column scales [spb][32], the
// quantizer's scratch, the tiles' mbarriers
struct DenseLayout {
  int act, red, rs, sc, scratch, bars, total;
};

__host__ __device__ inline DenseLayout dense_layout(int b, int K, int spb, int kc, int tr) {
  const int mt = b > 16 ? 2 : 1;
  DenseLayout o;
  o.act = spb * tr * kc * SLAB;
  o.red = o.act + (b * (K + 16) + 15) / 16 * 16;
  o.rs = o.red + spb * 16 * mt * RED_ROW * 4;
  o.sc = o.rs + (4 * b + 15) / 16 * 16;
  o.scratch = o.sc + spb * SLAB * 4;
  o.bars = o.scratch + QUANT_SCRATCH;
  o.total = o.bars + 8 * spb * tr;
  return o;
}

__device__ __forceinline__ void dense_stamp(const DenseArgs& a, int i) {
  if (a.stamps != nullptr && threadIdx.x == 0) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    a.stamps[blockIdx.x * DENSE_STAMPS + i] = t;
  }
}

// a 4-byte copy (the column scales need no 16-byte alignment)
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" :: "r"(dst), "l"(src) : "memory");
}

// LN: B9a (nw the gains, nb the biases); else B3 (nw set) or B4
template <int MT, bool LN>
__global__ void __launch_bounds__(threads<MT>(), 1)
    dense_int8_kernel(DenseArgs a, const __grid_constant__ CUtensorMap map) {
  extern __shared__ __align__(1024) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int ks = a.ks, rank = ks > 1 ? (int)cluster.block_rank() : 0;
  const int tid = threadIdx.x, nthr = threads<MT>(), b = a.b;
  const int slab0 = blockIdx.x / ks * a.spb;
  const int ns = min(a.spb, a.N / SLAB - slab0);
  const int t0 = rank * a.tiles / ks, nt = (rank + 1) * a.tiles / ks - t0;
  const int tr = (a.tiles + ks - 1) / ks;
  const DenseLayout lo = dense_layout(b, a.K, a.spb, a.kc, tr);
  const uint32_t tiles_s = smem_u32(smem), bars = smem_u32(smem + lo.bars);
  int8_t* act = reinterpret_cast<int8_t*>(smem + lo.act);
  int* red = reinterpret_cast<int*>(smem + lo.red);
  float* rs = reinterpret_cast<float*>(smem + lo.rs);
  float* sc = reinterpret_cast<float*>(smem + lo.sc);
  const int red_n = 16 * MT * RED_ROW;
  dense_stamp(a, 0);

  // every tile of the block, asked for at once: lane 0 of warp w asks for
  // tiles w, w + nwarp, ... (a request holds its thread ~0.7 us)
  const int warp = tid >> 5, nwarp = nthr >> 5;
  if ((tid & 31) == 0 && warp < ns * nt) {
    for (int q = warp; q < ns * nt; q += nwarp) mbar_init(bars + 8 * q, 1);
    mbar_fence_init();
    for (int q = warp; q < ns * nt; q += nwarp) {
      const int i = q / nt, j = q % nt;
      tma_load_tile<true>(tiles_s + (i * tr + j) * a.kc * SLAB, &map, SLAB * (slab0 + i),
                          (t0 + j) * a.kc, a.kc, a.layer, bars + 8 * q);
    }
  }
  dense_stamp(a, 1);
  for (int i = tid; i < ns * SLAB; i += nthr) {
    cp_async4(smem_u32(sc + i), a.s + SLAB * slab0 + i);
  }
  cp_async_commit();
  // B3's norm weights (B9a's gains and biases) into L1, where the norm reads
  // them after its first reduction (B9a's after its second)
  const int nw_bytes = a.nw == nullptr ? 0 : a.K * (a.nw_kind == KIND_BF16 ? 2 : 4);
  for (int i = tid; i < nw_bytes / 128; i += nthr) {
    asm volatile("prefetch.global.L1 [%0];\n"
                 :: "l"(reinterpret_cast<const char*>(a.nw) + 128 * i));
    if (LN) {
      asm volatile("prefetch.global.L1 [%0];\n"
                   :: "l"(reinterpret_cast<const char*>(a.nb) + 128 * i));
    }
  }
  for (int i = tid; i < ns * red_n; i += nthr) red[i] = 0;

  // the norm and the quantizer while the tiles land (ends with __syncthreads)
  if (a.x_kind == KIND_BF16) {
    quant_rows_dense<LN>(reinterpret_cast<const __nv_bfloat16*>(a.x), b, a.K, a.nw, a.nb,
                         a.nw_kind, a.eps, act, a.lda, rs, smem + lo.scratch);
  } else {
    quant_rows_dense<LN>(reinterpret_cast<const float*>(a.x), b, a.K, a.nw, a.nb, a.nw_kind,
                         a.eps, act, a.lda, rs, smem + lo.scratch);
  }
  dense_stamp(a, 2);

  // the products: warp w takes the slice's 32-row steps w, w + nwarp, ...
  const int spt = a.kc / 32, steps = nt * spt;
  const uint32_t act_s = smem_u32(act);
  int acc[MT][4][4];
  zero_acc(acc);
  for (int i = 0; i < ns; ++i) {
    const uint32_t slab_s = tiles_s + i * tr * a.kc * SLAB;
    for (int st = warp; st < steps; st += nwarp) {
      mbar_wait(bars + 8 * (i * nt + st / spt), 0);
      mma_step<MT>(slab_s, st, act_s, a.lda, b, t0 * a.kc, acc);
    }
    if (warp < steps) acc_to_red<MT>(acc, red + i * red_n, b);
  }
  cp_async_wait<0>();
  __syncthreads();
  dense_stamp(a, 3);
  if (ks > 1) cluster.sync();   // every rank's sums are in its shared memory
  dense_stamp(a, 4);

  // the epilogue: rank r takes every ks-th run of nthr outputs, adding the
  // ranks' int32 sums (exact in any order)
  for (int e = rank * nthr + tid; e < ns * b * SLAB; e += ks * nthr) {
    const int i = e / (b * SLAB), r = e / SLAB % b, c = e % SLAB;
    const int k = i * red_n + r * RED_ROW + c;
    int y = red[k];
    if (ks > 1) {
      for (int q = 0; q < ks; ++q) {
        if (q != rank) y += cluster.map_shared_rank(red, q)[k];
      }
    }
    a.out[(long long)r * a.N + SLAB * (slab0 + i) + c] =
        __fmul_rn(__fmul_rn(__int2float_rn(y), rs[r]), sc[i * SLAB + c]);
  }
  if (ks > 1) cluster.sync();   // no block leaves while another reads its sums
  dense_stamp(a, 5);
}

bool shapes_ok(int b, int K, int N) {
  return b >= 1 && b <= DENSE_MAX_B && K >= 32 && K % 32 == 0 && K <= DENSE_MAX_K && N >= SLAB &&
         N % SLAB == 0;
}


// The body for b rows (ln: B9a's), its largest dynamic shared size allowed
// once per body and device.
int dense_fn(int b, int ln, const void** fn) {
  static int allowed[4][64];
  const int k = 2 * (ln != 0) + (b > 16);
  const void* fns[4] = {(const void*)dense_int8_kernel<1, false>,
                        (const void*)dense_int8_kernel<2, false>,
                        (const void*)dense_int8_kernel<1, true>,
                        (const void*)dense_int8_kernel<2, true>};
  *fn = fns[k];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (!allowed[k][dev & 63]) {
    e = cudaFuncSetAttribute(*fn, cudaFuncAttributeMaxDynamicSharedMemorySize, DENSE_SMEM_MAX);
    if (e != cudaSuccess) return (int)e;
    allowed[k][dev & 63] = 1;
  }
  return 0;
}

cudaLaunchConfig_t dense_config(int b, int grid, int ks, int smem, cudaStream_t stream,
                                cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)grid, 1, 1);
  cfg.blockDim = dim3(b > 16 ? threads<2>() : threads<1>(), 1, 1);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)ks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

}  // namespace

// The shared bytes of a launch (ops/decode_dense.py dense_smem); -1 for a
// plan the kernel does not take.
extern "C" int vt_dense_one_smem(int b, int K, int N, int ks, int spb, int kc) {
  if (!shapes_ok(b, K, N) || ks < 1 || ks > DENSE_MAX_KS || spb < 1 || kc < 32 ||
      kc > DENSE_KC_MAX || (kc & (kc - 1)) || K % kc || K / kc < ks) {
    return -1;
  }
  const int tiles = K / kc;
  return dense_layout(b, K, spb, kc, (tiles + ks - 1) / ks).total;
}

// Clusters of ks blocks of `smem` shared bytes (b rows; ln: B9a's body) the
// card keeps resident at once (cudaOccupancyMaxActiveClusters), which
// dense_plan reads.
extern "C" int vt_dense_clusters(int b, int ln, int ks, int smem, int* clusters) {
  if (b < 1 || b > DENSE_MAX_B || ks < 1 || ks > DENSE_MAX_KS || smem < 0 ||
      smem > DENSE_SMEM_MAX || clusters == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  const void* fn;
  const int rc = dense_fn(b, ln, &fn);
  if (rc) return rc;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = dense_config(b, ks, ks, smem, nullptr, attr);
  return (int)cudaOccupancyMaxActiveClusters(clusters, fn, &cfg);
}

// B4 (nw_all and nb_all null, nw_kind 0), B3 (nb_all null) and B9a (nw_all
// the LayerNorm gains, nb_all its biases): out = the layer's int8 product of
// the (normed) rows of x, [b, N] f32, in one launch of `grid` blocks in
// clusters of ks (ops/decode_dense.py dense_plan: ks, spb slabs a block, kc
// tile rows; smem checked against vt_dense_one_smem). x is 16-byte aligned
// (f32) or 8-byte aligned (bf16), nw_all and nb_all likewise by nw_kind,
// w_all 16-byte aligned. stamps: null, or [grid, 6] u64 (the phase points
// above).
extern "C" int vt_dense_int8_one(const void* x, int x_kind, const void* nw_all,
                                 const void* nb_all, int nw_kind, float eps, const void* w_all,
                                 const void* s_all, int layer, int L, int b, int K, int N,
                                 void* out, int grid, int ks, int spb, int kc, int smem,
                                 void* stamps, void* stream) {
  const int groups = (N / SLAB + spb - 1) / (spb > 0 ? spb : 1);
  if (!shapes_ok(b, K, N) || layer < 0 || layer >= L || x_kind == KIND_NONE ||
      (nw_kind != KIND_NONE) != (nw_all != nullptr) || (nb_all != nullptr && nw_all == nullptr) ||
      smem < 0 ||
      smem != vt_dense_one_smem(b, K, N, ks, spb, kc) || smem > DENSE_SMEM_MAX ||
      grid != groups * ks) {
    return (int)cudaErrorInvalidValue;
  }
  const int xa = x_kind == KIND_BF16 ? 8 : 16, na = nw_kind == KIND_BF16 ? 8 : 16;
  if ((uintptr_t)x % xa || (uintptr_t)nw_all % na || (uintptr_t)nb_all % na ||
      (uintptr_t)w_all % 16 || (uintptr_t)s_all % 4) {
    return (int)cudaErrorMisalignedAddress;
  }
  DenseArgs a;
  const long long norm_off = (long long)layer * K * (nw_kind == KIND_BF16 ? 2 : 4);
  a.x = x;
  a.nw = nw_all == nullptr ? nullptr : reinterpret_cast<const char*>(nw_all) + norm_off;
  a.nb = nb_all == nullptr ? nullptr : reinterpret_cast<const char*>(nb_all) + norm_off;
  a.s = reinterpret_cast<const float*>(s_all) + (long long)layer * N;
  a.out = reinterpret_cast<float*>(out);
  a.stamps = reinterpret_cast<unsigned long long*>(stamps);
  a.x_kind = x_kind;
  a.nw_kind = nw_kind;
  a.layer = layer;
  a.b = b;
  a.K = K;
  a.N = N;
  a.ks = ks;
  a.spb = spb;
  a.kc = kc;
  a.tiles = K / kc;
  a.lda = K + 16;
  a.eps = eps;
  CUtensorMap map;
  int rc = tile_map(w_all, L, K, N, kc, &map);
  if (rc) return rc;
  const void* fn;
  rc = dense_fn(b, nb_all != nullptr, &fn);
  if (rc) return rc;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = dense_config(b, grid, ks, smem, (cudaStream_t)stream, attr);
  void* params[] = {&a, &map};
  const cudaError_t e = cudaLaunchKernelExC(&cfg, fn, params);
  if (e != cudaSuccess) {
    cudaGetLastError();   // a refused launch leaves no sticky error; clear the last one
    return (int)e;
  }
  return (int)cudaGetLastError();
}
