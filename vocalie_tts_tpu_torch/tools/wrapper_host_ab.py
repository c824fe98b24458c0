"""The host's µs that the B9b, B7, B2 and B8b wrappers spend in Python
before their C call, this tree's beside another tree's (a parent commit
unpacked by ``git archive``), in one process on the GPU:

    python3 -m vocalie_tts_tpu_torch.tools.wrapper_host_ab PARENT_DIR

Needs an NVIDIA GPU and ``nvcc`` (the port builds its kernels at first
use). It loads PARENT_DIR's ``vocalie_tts_tpu_torch/ops/decode_dense.py``
and ``decode_step.py`` as modules of their own beside this tree's, makes
the inputs of B9b at the XTTS layer (b 8, bf16 rows and biases), of B7
at the CosyVoice streaming shape (16 heads of 64, d_model 1024, d_ff 4096,
a 640-slot cache with 383 valid, a bf16 qkv bias), of B2 at the T3 layer
(b 16, bf16 rows) and of B8b at the Qwen3 layer (b 8, d_model 2048, d_ff
8192, bf16 rows; its one launch here, the old chain in a tree before it);
2 layers, as the wrappers' Python does not depend on the depth; random
from a seed, and
calls this tree's wrappers once for real (their per-shape caches fill).
Then it stubs the kernel library's entry points to return at once and
times 300 calls of each wrapper, the two trees in turn, in 7 rounds; it
prints each wrapper's least and median µs a call, the card's name and
power limit, and all of it as one JSON line. The C call (ctypes and the
launch) is in none of these numbers: ``chip_smoke.py --stream-steps``
times the whole call, run in each tree.
"""

from __future__ import annotations

import importlib.util
import json
import os
import statistics
import subprocess
import sys
import time

import torch

ROUNDS = 7
CALLS = 300


def _load(root: str, name: str):
    path = os.path.join(root, "vocalie_tts_tpu_torch", "ops", name + ".py")
    spec = importlib.util.spec_from_file_location(f"_other_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod   # dataclasses look their module up
    spec.loader.exec_module(mod)
    return mod


def _int8(gen, dev, L, d_in, d_out):
    q = torch.randint(-127, 128, (L, d_in, d_out), generator=gen, device=dev, dtype=torch.int8)
    return q, (torch.rand((L, 1, d_out), generator=gen, device=dev) + 0.5) / 127 * d_in ** -0.5


def _b9b_args(dev, L=2, b=8, d=1024, F=4096, Q=3072):
    gen = torch.Generator(device=dev).manual_seed(9)

    def vec(n, base=0.0):
        return base + 0.1 * torch.randn((L, n), generator=gen, device=dev)

    bf16 = torch.bfloat16
    wo, wos = _int8(gen, dev, L, d, d)
    wu, su = _int8(gen, dev, L, d, F)
    wd, sd = _int8(gen, dev, L, F, d)
    wq, sq = _int8(gen, dev, L, d, Q)
    attn = torch.randn((b, d), generator=gen, device=dev) * 0.3
    x = torch.randn((b, d), generator=gen, device=dev).to(bf16)
    return (attn, x, wo, wos, vec(d).to(bf16), vec(d, 1.0), vec(d), wu, su, vec(F).to(bf16), wd,
            sd, vec(d).to(bf16), vec(d, 1.0), vec(d), wq, sq)


def _b7_args(dev, L=2, H=16, d=64, D=1024, F=4096, T=640, valid=383):
    gen = torch.Generator(device=dev).manual_seed(7)
    q0 = torch.randn((H, 1, d), generator=gen, device=dev)
    kn0, vn0 = (torch.randn((H, d), generator=gen, device=dev) for _ in range(2))
    x = torch.randn((1, D), generator=gen, device=dev) * 0.5
    k, v = (torch.randint(-127, 128, (L, 1, H, T, d), generator=gen, device=dev,
                          dtype=torch.int8) for _ in range(2))
    ks, vs = (((torch.rand((L, 1, H, T), generator=gen, device=dev) + 0.5) / 127)
              .to(torch.bfloat16) for _ in range(2))
    bias = torch.where(torch.arange(T, device=dev) < valid, 0.0, -1e30).float()[None]
    wo, wos = _int8(gen, dev, L, H * d, D)
    mw = 1 + 0.1 * torch.randn((L, D), generator=gen, device=dev)
    wgu, sgu = _int8(gen, dev, L, D, 2 * F)
    wd, sd = _int8(gen, dev, L, F, D)
    nw = 1 + 0.1 * torch.randn((L, D), generator=gen, device=dev)
    wq, sq = _int8(gen, dev, L, D, 3 * H * d)
    bq = (0.5 * torch.randn((L, 3 * H * d), generator=gen, device=dev)).to(torch.bfloat16)
    ang = (valid + 7) / (10000.0 ** (torch.arange(0, d, 2, device=dev).float() / d))
    c, s = torch.cos(ang)[None], torch.sin(ang)[None]
    return (q0, kn0, vn0, x, k, v, ks, vs, bias, wo, wos, mw, wgu, sgu, wd, sd, nw, wq, sq, bq,
            torch.cat([c, c], -1), torch.cat([-s, s], -1))


def _b2_args(dev, L=2, b=16, d=1024, F=4096, Q=3072):
    gen = torch.Generator(device=dev).manual_seed(2)
    wo, wos = _int8(gen, dev, L, d, d)
    wgu, sgu = _int8(gen, dev, L, d, 2 * F)
    wd, sd = _int8(gen, dev, L, F, d)
    wq, sq = _int8(gen, dev, L, d, Q)
    attn = torch.randn((b, d), generator=gen, device=dev) * 0.3
    x = torch.randn((b, d), generator=gen, device=dev).to(torch.bfloat16)
    mw, nw = (1 + 0.1 * torch.randn((L, d), generator=gen, device=dev) for _ in range(2))
    return attn, x, wo, wos, mw, wgu, sgu, wd, sd, nw, wq, sq


def _b8b_args(dev, L=2, b=8, d=2048, F=8192):
    gen = torch.Generator(device=dev).manual_seed(8)
    wgu, sgu = _int8(gen, dev, L, d, 2 * F)
    wd, sd = _int8(gen, dev, L, F, d)
    x = torch.randn((b, d), generator=gen, device=dev).to(torch.bfloat16)
    return x, wgu, sgu, wd, sd


def _us(fn) -> float:
    fn()
    t0 = time.perf_counter()
    for _ in range(CALLS):
        fn()
    return (time.perf_counter() - t0) / CALLS * 1e6


def main(argv) -> int:
    if len(argv) != 1 or not os.path.isdir(argv[0]):
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("wrapper_host_ab: no CUDA device available", file=sys.stderr)
        return 2
    from vocalie_tts_tpu_torch.ops import _build
    from vocalie_tts_tpu_torch.ops import decode_dense as dd
    from vocalie_tts_tpu_torch.ops import decode_step as ds

    other_dd, other_ds = _load(argv[0], "decode_dense"), _load(argv[0], "decode_step")
    dev = torch.device("cuda:0")
    g, s, t, m = _b9b_args(dev), _b7_args(dev), _b2_args(dev), _b8b_args(dev)
    kw = dict(sm_scale=0.125, eps=1e-5)
    calls = {"B9b tail_gelu_qkv_int8": {
                 "this": lambda: dd.tail_gelu_qkv_int8_stacked(*g, 1, eps=1e-5),
                 "other": lambda: other_dd.tail_gelu_qkv_int8_stacked(*g, 1, eps=1e-5)},
             "B7 decode_step_fused": {
                 "this": lambda: ds.decode_step_fused_packed(*s, **kw),
                 "other": lambda: other_ds.decode_step_fused_packed(*s, **kw)},
             "B2 tail_swiglu_qkv_int8": {
                 "this": lambda: dd.tail_swiglu_qkv_int8_stacked(*t, 1, eps=1e-5),
                 "other": lambda: other_dd.tail_swiglu_qkv_int8_stacked(*t, 1, eps=1e-5)},
             "B8b mlp_swiglu_int8": {
                 "this": lambda: dd.mlp_swiglu_int8_stacked(*m, 1),
                 "other": lambda: other_dd.mlp_swiglu_int8_stacked(*m, 1)}}
    for pair in calls.values():
        pair["this"]()   # for real: this tree's per-shape caches fill
    torch.cuda.synchronize()
    times = {name: {"this": [], "other": []} for name in calls}
    real = _build.kernel
    _build.kernel = lambda *a, **k: (lambda *args: 0)
    try:
        for _ in range(ROUNDS):
            for name, pair in calls.items():
                for who in ("this", "other"):
                    times[name][who].append(_us(pair[who]))
    finally:
        _build.kernel = real
    torch.cuda.synchronize()
    out = {}
    for name, by in times.items():
        out[name] = {who: {"least_us": min(t), "median_us": statistics.median(t), "rounds": t}
                     for who, t in by.items()}
        print(f"{name}: Python before the C call, this tree {min(by['this']):.2f} us a call "
              f"(median {statistics.median(by['this']):.2f}), {argv[0]} "
              f"{min(by['other']):.2f} (median {statistics.median(by['other']):.2f})", flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    print(json.dumps({"card": torch.cuda.get_device_name(0), "other": argv[0], **out}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
