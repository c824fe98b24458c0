"""Where one layer of the port's whole-step kernel (B7:
``vocalie_tts_tpu_torch/csrc/decode_step.cu``) spends its time on the GPU,
phase by phase, from the card's own clock.

    python3 -m vocalie_tts_tpu_torch.tools.decode_step_trace

Needs an NVIDIA GPU and ``nvcc`` (the port builds its kernels at first
use). The kernel's thread 0 of every block writes ``%globaltimer`` (ns) at
the phase points ``ops/decode_step.py`` names in ``STAMP_POINTS``, in the
layer ``trace_layer`` (the middle one). At the CosyVoice streaming shape
(24 layers, d_model 1024, d_ff 4096, 16 heads of 64, a cache of 640 slots
with 383 valid, batch 1; random int8 weights and cache from a seed), it
prints for each point the µs from the first block's arrival at the layer
at which the first and the last block reached it (the median of 20 calls;
a block that has no work in a phase writes nothing there and is left out),
for one block of each mix of item kinds when its ring requested each of
its tiles and when it was ready for it (from the layer before the traced one on),
and the call's time by CUDA events; then all of it as one JSON line.
"""

from __future__ import annotations

import json
import statistics

import torch

SHAPE = dict(L=24, H=16, d=64, D=1024, F=4096, T=640, valid=383, eps=1e-5)


def inputs(dev, L, H, d, D, F, T, valid, eps, seed=8):
    """B7's arguments at one shape, from a seed: the cache's first ``valid``
    slots unmasked, bf16 q/k/v biases, f32 norm weights."""
    gen = torch.Generator(device=dev).manual_seed(seed)

    def weights(d_in, d_out):
        q = torch.randint(-127, 128, (L, d_in, d_out), generator=gen, device=dev,
                          dtype=torch.int8)
        return q, (torch.rand((L, 1, d_out), generator=gen, device=dev) + 0.5) / 127 * d_in ** -0.5

    q0 = torch.randn((H, 1, d), generator=gen, device=dev)
    kn0, vn0 = (torch.randn((H, d), generator=gen, device=dev) for _ in range(2))
    x = torch.randn((1, D), generator=gen, device=dev) * 0.5
    k, v = (torch.randint(-127, 128, (L, 1, H, T, d), generator=gen, device=dev,
                          dtype=torch.int8) for _ in range(2))
    ks, vs = (((torch.rand((L, 1, H, T), generator=gen, device=dev) + 0.5) / 127)
              .to(torch.bfloat16) for _ in range(2))
    bias = torch.where(torch.arange(T, device=dev) < valid, 0.0,
                       -0.7 * torch.finfo(torch.float32).max).float()[None]
    wo, wos = weights(H * d, D)
    mw = 1 + 0.1 * torch.randn((L, D), generator=gen, device=dev)
    wgu, sgu = weights(D, 2 * F)
    wd, sd = weights(F, D)
    nw = 1 + 0.1 * torch.randn((L, D), generator=gen, device=dev)
    wq, sq = weights(D, 3 * H * d)
    bq = (0.5 * torch.randn((L, 3 * H * d), generator=gen, device=dev)).to(torch.bfloat16)
    ang = (valid + 7) / (10000.0 ** (torch.arange(0, d, 2, device=dev).float() / d))
    c, s = torch.cos(ang)[None], torch.sin(ang)[None]
    args = (q0, kn0, vn0, x, k, v, ks, vs, bias, wo, wos, mw, wgu, sgu, wd, sd, nw, wq, sq, bq,
            torch.cat([c, c], -1), torch.cat([-s, s], -1))
    return args, dict(sm_scale=d ** -0.5, eps=eps)


def trace(dev, shape=SHAPE, calls: int = 20) -> dict:
    from vocalie_tts_tpu_torch.ops import decode_step as ds

    args, kw = inputs(dev, **shape)
    grid = torch.cuda.get_device_properties(dev).multi_processor_count
    layer = shape["L"] // 2
    n, nt = len(ds.STAMP_POINTS), ds.N_TILE_STAMPS
    plan = ds.step_plan(shape["L"], shape["H"], shape["d"], shape["D"], shape["F"], shape["T"],
                        grid)
    stamps = torch.zeros((grid * (ds.N_STAMPS + 2 * nt),), dtype=torch.int64, device=dev)
    ds.decode_step_fused_packed(*args, **kw)
    firsts, lasts = [[] for _ in range(n)], [[] for _ in range(n)]
    # one block of each mix of item kinds: its tiles' request and arrival (µs
    # from the first block's start of the traced layer)
    kinds = {}
    for blk, its in enumerate(plan.items):
        kinds.setdefault(tuple(sorted({k for k, _ in its})), blk)
    tiles = {k: [] for k in kinds}
    for _ in range(calls):
        stamps.zero_()
        ds.decode_step_fused_packed(*args, **kw, stamps=stamps, trace_layer=layer)
        torch.cuda.synchronize()
        flat = stamps.cpu()
        t = flat[:grid * ds.N_STAMPS].view(grid, ds.N_STAMPS)[:, :n]
        tt = flat[grid * ds.N_STAMPS:].view(grid, 2, nt)
        t0 = int(t[:, 0][t[:, 0] > 0].min())
        for p in range(n):
            col = t[:, p][t[:, p] > 0]
            if len(col):
                firsts[p].append((int(col.min()) - t0) / 1e3)
                lasts[p].append((int(col.max()) - t0) / 1e3)
        for k, blk in kinds.items():
            m = min(2 * plan.tiles[blk], nt)
            tiles[k].append([[(int(v) - t0) / 1e3 if v > 0 else None for v in tt[blk, i, :m]]
                             for i in range(2)])
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        ds.decode_step_fused_packed(*args, **kw)
    end.record()
    torch.cuda.synchronize()
    out = {ds.STAMP_POINTS[p]: {"first_us": statistics.median(firsts[p]),
                                "last_us": statistics.median(lasts[p])}
           for p in range(n) if firsts[p]}
    names = ("att", "o", "gu", "down", "qkv")

    def med(vals):
        vals = [v for v in vals if v is not None]
        return round(statistics.median(vals), 2) if vals else None

    out["tiles"] = {"+".join(names[x] for x in k): {
        "tiles_a_layer": plan.tiles[kinds[k]],
        "requested_us": [med(c[0][j] for c in v) for j in range(len(v[0][0]))],
        "ready_us": [med(c[1][j] for c in v) for j in range(len(v[0][1]))]}
        for k, v in tiles.items()}
    out["call_ms"] = start.elapsed_time(end) / calls
    out["layer"] = layer
    return out


def main() -> int:
    dev = torch.device("cuda:0")
    res = trace(dev)
    print(f"B7 layer {res['layer']} of {SHAPE['L']}: " + "; ".join(
        f"{p} {r['first_us']:.2f}-{r['last_us']:.2f}" for p, r in res.items()
        if isinstance(r, dict) and "first_us" in r) + f" us; a call {res['call_ms']:.6f} ms",
        flush=True)
    for kind, r in res.get("tiles", {}).items():
        print(f"  a block of {kind} ({r['tiles_a_layer']} tiles a layer): tiles requested at "
              f"{r['requested_us']}, ready (waited for) at {r['ready_us']} us", flush=True)
    print(json.dumps({"card": torch.cuda.get_device_name(0), "shape": SHAPE, **res}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
