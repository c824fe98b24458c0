"""Where a call of the port's one-launch SwiGLU layer tail (B2, B8a:
``vocalie_tts_tpu_torch/csrc/tail_swiglu.cu``) spends its time on the GPU,
phase by phase, from the card's own clock.

    python3 -m vocalie_tts_tpu_torch.tools.tail_swiglu_trace

Needs an NVIDIA GPU and ``nvcc`` (the port builds its kernels at first
use). The kernel's thread 0 of every block writes ``%globaltimer`` (ns) at
twelve points: entry, the o-projection's end, after barrier 1, after the
MLP norm, the gate | up end, after barrier 2, the hidden's quantization
end, after barrier 3, the down-projection's start (its activations
loaded), its end, after barrier 4, the exit. At the T3 layer (b 16) and
the Qwen3 layer (b 8), random int8 weights from a seed, each call reading
another of 8 layers so the weights come from device memory, it prints for
each point the µs from the first block's entry at which the first and the
last block reached it (the median of 20 calls), and for one block of each
mix of items when its tiles landed; then all of it as one JSON line.
"""

from __future__ import annotations

import json
import statistics

import torch

POINTS = ("entry", "o-proj end", "barrier 1", "mlp norm", "gate|up end", "barrier 2",
          "hidden quantized", "barrier 3", "down start", "down end", "barrier 4", "exit")
SHAPES = {"t3": dict(b=16, d=1024, F=4096, Q=3072, eps=1e-5),
          "qwen3": dict(b=8, d=2048, F=8192, Q=4096, eps=1e-6)}


def trace(shape: dict, dev, L: int = 8, calls: int = 20, qkv: bool = True) -> dict:
    from vocalie_tts_tpu_torch.ops import decode_dense as dd

    b, d, F, Q, eps = (shape[k] for k in ("b", "d", "F", "Q", "eps"))
    gen = torch.Generator(device=dev).manual_seed(7)

    def weights(d_in, d_out):
        q = torch.randint(-127, 128, (L, d_in, d_out), generator=gen, device=dev,
                          dtype=torch.int8)
        return q, (torch.rand((L, 1, d_out), generator=gen, device=dev) + 0.5) / 127 * d_in ** -0.5

    attn = torch.randn((b, d), generator=gen, device=dev) * 0.3
    x = torch.randn((b, d), generator=gen, device=dev).to(torch.bfloat16)
    wo, wos = weights(d, d)
    mw = 1 + 0.1 * torch.randn((L, d), generator=gen, device=dev)
    wgu, sgu = weights(d, 2 * F)
    wd, sd = weights(F, d)
    nw = 1 + 0.1 * torch.randn((L, d), generator=gen, device=dev)
    wq, sq = weights(d, Q)
    tile = dd.pick_tile(F, dd.TILE_BUDGET, 2 * d)
    nxt = (nw, wq, sq) if qkv else None
    plan = dd.tail_plan(b, d, d, F, tile, Q if qkv else 0,
                        torch.cuda.get_device_properties(dev).multi_processor_count)
    stamps = torch.zeros((plan.grid * (len(POINTS) + 64),), dtype=torch.int64, device=dev)
    args = (attn, x, wo, wos, mw, wgu, sgu, wd, sd, nxt)
    dd._tail_swiglu(*args, 0, eps, tile)
    firsts, lasts = [[] for _ in POINTS], [[] for _ in POINTS]
    # one block of each kind: its tiles' arrival times (µs from the first entry)
    kinds = {}
    for blk, its in enumerate(plan.items):
        kinds.setdefault(tuple(sorted({p for p, _ in its})), blk)
    arrivals = {k: [] for k in kinds}
    for i in range(calls):
        dd._tail_swiglu(*args, i % L, eps, tile, stamps=stamps)
        torch.cuda.synchronize()
        flat = stamps.cpu()
        t = flat[:plan.grid * len(POINTS)].view(plan.grid, len(POINTS))
        tiles = flat[plan.grid * len(POINTS):].view(plan.grid, 64)
        t0 = int(t[:, 0].min())
        for k, blk in kinds.items():
            n = min(plan.tiles[blk], 64)
            arrivals[k].append([(int(v) - t0) / 1e3 for v in tiles[blk, :n]]
                               + [(int(v) - t0) / 1e3 for v in t[blk]])
        for p in range(len(POINTS)):
            if not qkv and p == 10:
                continue
            firsts[p].append((int(t[:, p].min()) - t0) / 1e3)
            lasts[p].append((int(t[:, p].max()) - t0) / 1e3)
    out = {POINTS[p]: {"first_us": statistics.median(firsts[p]),
                       "last_us": statistics.median(lasts[p])}
           for p in range(len(POINTS)) if firsts[p]}
    out["stages"] = plan.stages
    out["blocks"] = {
        "+".join(("o", "gu", "down", "qkv")[p] for p in k): {
            "tiles_ready_us": [round(statistics.median(c[j] for c in v), 2)
                               for j in range(min(plan.tiles[kinds[k]], 64))],
            "points_us": [round(statistics.median(c[min(plan.tiles[kinds[k]], 64) + j] for c in v), 2)
                          if qkv or j != 10 else None for j in range(len(POINTS))]}
        for k, v in arrivals.items()}
    return out


def main() -> int:
    dev = torch.device("cuda:0")
    out = {"card": torch.cuda.get_device_name(0)}
    for name, shape in SHAPES.items():
        for qkv in (True, False):
            res = trace(shape, dev, qkv=qkv)
            key = f"{name} {'B2' if qkv else 'B8a'} stages {res.pop('stages')}"
            out[key] = res
            blocks = res.pop("blocks")
            print(f"{key}: " + "; ".join(f"{p} {r['first_us']:.2f}-{r['last_us']:.2f}"
                                         for p, r in res.items()) + " us", flush=True)
            for kind, r in blocks.items():
                print(f"  a block of {kind}: tiles ready at {r['tiles_ready_us']}, phase "
                      f"points at {r['points_us']} us", flush=True)
            res["blocks"] = blocks
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
