"""Probe how fast one persistent block per SM streams an int8 weight matrix
into shared memory on the GPU, by the width of the column slab each block
owns, and what a cooperative grid barrier costs: the measurements behind
the tile shape of the port's one-launch SwiGLU tail
(``vocalie_tts_tpu_torch/csrc/tail_swiglu.cu``).

    python3 -m vocalie_tts_tpu_torch.tools.weight_stream_probe

Needs an NVIDIA Hopper GPU and ``nvcc`` (found as the port's build finds
it). It builds its own kernels into ``build/probe/``.
Each variant streams a [4096, 4096] int8 matrix (16.8 MB, the T3 layer
tail's weight bytes) once per launch through a ring of 16-KB stages with
16-byte ``cp.async``, in slabs of ``W`` columns
(``W`` bytes a row), in tiles of 16 KB: the matrix's tiles, slab by slab,
are cut into one contiguous run a block, so every block streams the same
bytes whatever ``W`` is. Eight copies of
the matrix are cycled, so no launch finds its bytes in the 50 MB L2. It
prints the ms a launch and GB/s for each (W, ring depth), with and without
the L2 fetch granularity raised to 128 bytes, and the µs a grid barrier
costs in a cooperative launch of one block per SM.
"""

from __future__ import annotations

import ctypes
import json
import subprocess

import torch

from vocalie_tts_tpu_torch.ops._build import BUILD_DIR, _nvcc

SRC = r"""
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>
namespace cg = cooperative_groups;

__device__ __forceinline__ void cp16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" :: "r"(dst), "l"(src) : "memory");
}
__device__ __forceinline__ void commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N> __device__ __forceinline__ void waitg() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// block b streams its run of the matrix's tiles (slabs W bytes wide, tiles
// of KC rows, slab by slab) through a ring of S stages
template <int W, int S>
__global__ void __launch_bounds__(256, 1) stream_kernel(const int8_t* w, int K, int N, int KC,
                                                        int* sink) {
  extern __shared__ __align__(128) unsigned char sm[];
  const int per_slab = K / KC;
  const long long tiles = (long long)(N / W) * per_slab;
  const int t0 = (int)(tiles * blockIdx.x / gridDim.x);
  const int total = (int)(tiles * (blockIdx.x + 1) / gridDim.x) - t0;
  const int stage = KC * W;
  int issued = 0;
  auto issue = [&](int s) {
    if (issued < total) {
      const int slab = (t0 + issued) / per_slab;
      const int j = (t0 + issued) % per_slab;
      const int8_t* src = w + (long long)j * KC * N + (long long)slab * W;
      const uint32_t dst = (uint32_t)__cvta_generic_to_shared(sm + s * stage);
      for (int i = threadIdx.x; i < KC * (W / 16); i += 256) {
        const int r = i / (W / 16), c = i % (W / 16);
        cp16(dst + r * W + 16 * c, src + (long long)r * N + 16 * c);
      }
    }
    ++issued;
    commit();
  };
  for (int s = 0; s < S; ++s) issue(s);
  int acc = 0;
  for (int i = 0; i < total; ++i) {
    waitg<S - 1>();
    __syncthreads();
    acc += reinterpret_cast<const int*>(sm + (i % S) * stage)[threadIdx.x];
    __syncthreads();
    issue(i % S);
  }
  waitg<0>();
  if (acc == 0x12345678) sink[0] = acc;
}

__global__ void sync_kernel(int n) {
  cg::grid_group g = cg::this_grid();
  for (int i = 0; i < n; ++i) g.sync();
}

template <int W, int S>
static int launch(const void* w, int K, int N, int KC, void* sink, int grid, cudaStream_t st) {
  const int smem = S * KC * W;
  cudaError_t e = cudaFuncSetAttribute(stream_kernel<W, S>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  stream_kernel<W, S><<<grid, 256, smem, st>>>((const int8_t*)w, K, N, KC, (int*)sink);
  return (int)cudaGetLastError();
}

extern "C" int probe_stream(int W, int S, const void* w, int K, int N, void* sink, int grid,
                            void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int KC = 16384 / W;   // 16-KB tiles
  if (W == 32 && S == 8) return launch<32, 8>(w, K, N, KC, sink, grid, st);
  if (W == 32 && S == 2) return launch<32, 2>(w, K, N, KC, sink, grid, st);
  if (W == 64 && S == 8) return launch<64, 8>(w, K, N, KC, sink, grid, st);
  if (W == 128 && S == 8) return launch<128, 8>(w, K, N, KC, sink, grid, st);
  if (W == 128 && S == 2) return launch<128, 2>(w, K, N, KC, sink, grid, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" int probe_fetch_granularity(int bytes) {
  return (int)cudaDeviceSetLimit(cudaLimitMaxL2FetchGranularity, (size_t)bytes);
}

extern "C" int probe_sync(int n, int grid, void* stream) {
  void* args[] = {&n};
  return (int)cudaLaunchCooperativeKernel((const void*)sync_kernel, dim3(grid), dim3(256), args,
                                          0, (cudaStream_t)stream);
}
"""


def build() -> ctypes.CDLL:
    out = BUILD_DIR.parent / "probe"
    out.mkdir(parents=True, exist_ok=True)
    (out / "stream_probe.cu").write_text(SRC)
    nvcc = _nvcc()
    lib = out / "libstream_probe.so"
    subprocess.run([nvcc, "-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                    "-Xcompiler", "-fPIC", "-shared", "-o", str(lib), str(out / "stream_probe.cu")],
                   check=True)
    so = ctypes.CDLL(str(lib))
    P, I = ctypes.c_void_p, ctypes.c_int
    so.probe_stream.argtypes = [I, I, P, I, I, P, I, P]
    so.probe_sync.argtypes = [I, I, P]
    so.probe_fetch_granularity.argtypes = [I]
    return so


def event_ms(fn, n: int) -> float:
    fn(0)
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for i in range(n):
        fn(i)
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / n


def main() -> int:
    so = build()
    dev = torch.device("cuda:0")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    K = N = 4096
    mats = [torch.randint(-127, 128, (K, N), dtype=torch.int8, device=dev) for _ in range(8)]
    sink = torch.zeros(1, dtype=torch.int32, device=dev)
    st = torch.cuda.current_stream().cuda_stream
    out = {"card": torch.cuda.get_device_name(0), "sms": sms, "bytes": K * N, "stream": {}}
    for gran in (None, 128):
        if gran:
            assert so.probe_fetch_granularity(gran) == 0
        for W, S in ((32, 8), (32, 2), (64, 8), (128, 8), (128, 2)):
            def call(i, W=W, S=S):
                rc = so.probe_stream(W, S, mats[i % 8].data_ptr(), K, N, sink.data_ptr(), sms, st)
                assert rc == 0, rc
            ms = event_ms(call, 48)
            key = f"W{W} S{S}" + (f" fetch{gran}" if gran else "")
            out["stream"][key] = {"ms": ms, "GB/s": K * N / ms / 1e6}
            print(f"{key}: {ms:.6f} ms a launch, {K * N / ms / 1e6:.1f} GB/s", flush=True)
    t0 = event_ms(lambda i: so.probe_sync(0, sms, st), 20)
    t40 = event_ms(lambda i: so.probe_sync(40, sms, st), 20)
    out["grid_sync_us"] = (t40 - t0) / 40 * 1e3
    out["empty_cooperative_launch_ms"] = t0
    print(f"grid.sync: {(t40 - t0) / 40 * 1e3:.3f} us each; an empty cooperative launch "
          f"{t0:.6f} ms", flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
