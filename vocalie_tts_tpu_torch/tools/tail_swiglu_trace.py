"""Where a call of the port's one-launch layer tails spends its time on the
GPU, phase by phase, from the card's own clock: the SwiGLU tail (B2, B8a:
``vocalie_tts_tpu_torch/csrc/tail_swiglu.cu``) and the SwiGLU MLP alone
(B8b, that body's MLP branch), the GELU tail (B9b:
``vocalie_tts_tpu_torch/csrc/tail_gelu.cu``) and the GELU MLP alone (B9d,
the same body's MLP branch). The MLP branches have no o-projection, so no
o-projection end and no barrier 1; their "mlp norm" point is the end of
the rows' quantization.

    python3 -m vocalie_tts_tpu_torch.tools.tail_swiglu_trace

Needs an NVIDIA GPU and ``nvcc`` (the port builds its kernels at first
use). The kernel's thread 0 of every block writes ``%globaltimer`` (ns) at
twelve points: entry, the o-projection's end, after barrier 1, after the
MLP norm, the gate | up (fc) end, after barrier 2, the hidden's
quantization end, after barrier 3, the down-projection's start (its
activations loaded), its end, after barrier 4, the exit. At the T3 layer
(b 16), the Qwen3 layer (b 8, B2, B8a and B8b) and the XTTS layer (b 8, B9b and B9d), random int8
weights from a seed, each call reading another of 8 layers so the weights
come from device memory, it prints for each point the µs from the first
block's entry at which the first and the last block reached it (the median
of 20 calls), and for one block of each mix of items when its tiles
landed; for B9b also the CUDA kernels of the old 12-kernel chain
(``vt_tail_gelu_int8``, which B9c still runs) with their device µs a call,
from torch.profiler; then all of it as one JSON line.
"""

from __future__ import annotations

import json
import statistics

import torch

POINTS = ("entry", "o-proj end", "barrier 1", "mlp norm", "gate|up end", "barrier 2",
          "hidden quantized", "barrier 3", "down start", "down end", "barrier 4", "exit")
SHAPES = {"t3": dict(b=16, d=1024, F=4096, Q=3072, eps=1e-5),
          "qwen3": dict(b=8, d=2048, F=8192, Q=4096, eps=1e-6)}
GELU_SHAPE = dict(b=8, d=1024, F=4096, Q=3072, eps=1e-5)


def _weights(gen, dev, L, d_in, d_out):
    q = torch.randint(-127, 128, (L, d_in, d_out), generator=gen, device=dev, dtype=torch.int8)
    return q, (torch.rand((L, 1, d_out), generator=gen, device=dev) + 0.5) / 127 * d_in ** -0.5


def _swiglu_call(shape: dict, dev, L: int, qkv: bool):
    from vocalie_tts_tpu_torch.ops import decode_dense as dd

    b, d, F, Q, eps = (shape[k] for k in ("b", "d", "F", "Q", "eps"))
    gen = torch.Generator(device=dev).manual_seed(7)
    attn = torch.randn((b, d), generator=gen, device=dev) * 0.3
    x = torch.randn((b, d), generator=gen, device=dev).to(torch.bfloat16)
    wo, wos = _weights(gen, dev, L, d, d)
    mw = 1 + 0.1 * torch.randn((L, d), generator=gen, device=dev)
    wgu, sgu = _weights(gen, dev, L, d, 2 * F)
    wd, sd = _weights(gen, dev, L, F, d)
    nw = 1 + 0.1 * torch.randn((L, d), generator=gen, device=dev)
    wq, sq = _weights(gen, dev, L, d, Q)
    tile = dd.pick_tile(F, dd.TILE_BUDGET, 2 * d)
    args = (attn, x, wo, wos, mw, wgu, sgu, wd, sd, (nw, wq, sq) if qkv else None)
    plan = dd.tail_plan(b, d, d, F, tile, Q if qkv else 0,
                        torch.cuda.get_device_properties(dev).multi_processor_count)
    return plan, lambda layer, stamps=None: dd._tail_swiglu(*args, layer, eps, tile,
                                                            stamps=stamps)


def _gelu_call(shape: dict, dev, L: int, chain: bool = False):
    from vocalie_tts_tpu_torch.ops import decode_dense as dd

    b, d, F, Q, eps = (shape[k] for k in ("b", "d", "F", "Q", "eps"))
    gen = torch.Generator(device=dev).manual_seed(9)

    def vec(n, base=0.0, dtype=torch.float32):
        return (base + 0.1 * torch.randn((L, n), generator=gen, device=dev)).to(dtype)

    attn = torch.randn((b, d), generator=gen, device=dev) * 0.3
    x = torch.randn((b, d), generator=gen, device=dev).to(torch.bfloat16)
    wo, wos = _weights(gen, dev, L, d, d)
    wu, su = _weights(gen, dev, L, d, F)
    wd, sd = _weights(gen, dev, L, F, d)
    wq, sq = _weights(gen, dev, L, d, Q)
    bo, bu, bd = (vec(n, dtype=torch.bfloat16) for n in (d, F, d))
    args = (attn, x, wo, wos, bo, vec(d, 1.0), vec(d), wu, su, bu, wd, sd, bd,
            (vec(d, 1.0), vec(d), wq, sq))
    tile = dd.pick_tile(F, dd.TILE_BUDGET, 2 * d)
    plan = dd.tail_plan(b, d, d, F, tile, Q,
                        torch.cuda.get_device_properties(dev).multi_processor_count, mlp="gelu")
    return plan, lambda layer, stamps=None: dd._tail_gelu(*args, layer, eps, tile, stamps=stamps,
                                                          chain=chain)


def _mlp_gelu_call(shape: dict, dev, L: int):
    """B9d at ``shape``'s d_model and d_ff: bf16 rows and fc bias."""
    from vocalie_tts_tpu_torch.ops import decode_dense as dd

    b, d, F = (shape[k] for k in ("b", "d", "F"))
    gen = torch.Generator(device=dev).manual_seed(10)
    x = torch.randn((b, d), generator=gen, device=dev).to(torch.bfloat16)
    wu, su = _weights(gen, dev, L, d, F)
    wd, sd = _weights(gen, dev, L, F, d)
    bu = (0.1 * torch.randn((L, F), generator=gen, device=dev)).to(torch.bfloat16)
    tile = dd.pick_tile(F, dd.TILE_BUDGET, 2 * d)
    plan = dd.tail_plan(b, 0, d, F, tile, 0,
                        torch.cuda.get_device_properties(dev).multi_processor_count,
                        mlp="gelu_mlp")
    return plan, lambda layer, stamps=None: dd.mlp_gelu_int8_stacked(x, wu, su, bu, wd, sd,
                                                                     layer, stamps=stamps)


def _mlp_swiglu_call(shape: dict, dev, L: int):
    """B8b at ``shape``'s d_model and d_ff: bf16 rows."""
    from vocalie_tts_tpu_torch.ops import decode_dense as dd

    b, d, F = (shape[k] for k in ("b", "d", "F"))
    gen = torch.Generator(device=dev).manual_seed(11)
    x = torch.randn((b, d), generator=gen, device=dev).to(torch.bfloat16)
    wgu, sgu = _weights(gen, dev, L, d, 2 * F)
    wd, sd = _weights(gen, dev, L, F, d)
    tile = dd.pick_tile(F, dd.TILE_BUDGET, 2 * d)
    plan = dd.tail_plan(b, 0, d, F, tile, 0, dd.card_sms(dev), mlp="swiglu_mlp")
    return plan, lambda layer, stamps=None: dd.mlp_swiglu_int8_stacked(x, wgu, sgu, wd, sd,
                                                                       layer, stamps=stamps)


def trace(plan, call, L: int = 8, calls: int = 20, qkv: bool = True, skip=()) -> dict:
    stamps = torch.zeros((plan.grid * (len(POINTS) + 64),), dtype=torch.int64,
                         device=torch.device("cuda:0"))
    call(0)
    firsts, lasts = [[] for _ in POINTS], [[] for _ in POINTS]
    # one block of each kind: its tiles' arrival times (µs from the first entry)
    kinds = {}
    for blk, its in enumerate(plan.items):
        kinds.setdefault(tuple(sorted({p for p, _ in its})), blk)
    arrivals = {k: [] for k in kinds}
    for i in range(calls):
        call(i % L, stamps=stamps)
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
            if (not qkv and p == 10) or p in skip:
                continue
            firsts[p].append((int(t[:, p].min()) - t0) / 1e3)
            lasts[p].append((int(t[:, p].max()) - t0) / 1e3)
    out = {POINTS[p]: {"first_us": statistics.median(firsts[p]),
                       "last_us": statistics.median(lasts[p])}
           for p in range(len(POINTS)) if firsts[p]}
    out["stages"] = plan.stages
    out["blocks"] = {
        "+".join(("o", "mlp", "down", "qkv")[p] for p in k): {
            "tiles_ready_us": [round(statistics.median(c[j] for c in v), 2)
                               for j in range(min(plan.tiles[kinds[k]], 64))],
            "points_us": [round(statistics.median(c[min(plan.tiles[kinds[k]], 64) + j] for c in v), 2)
                          if (qkv or j != 10) and j not in skip else None
                          for j in range(len(POINTS))]}
        for k, v in arrivals.items()}
    return out


def chain_kernels(call, L: int = 8, calls: int = 5) -> dict:
    """The CUDA kernels one call launches and their device µs a call (the
    median over ``calls`` calls), from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    call(0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(calls):
            call(i % L)
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        dt = getattr(e, "self_device_time_total", None)
        if dt is None:
            dt = getattr(e, "self_cuda_time_total", 0.0)
        if dt and e.device_type == torch.autograd.DeviceType.CUDA:
            out[e.key.split("(")[0].removeprefix("void ")] = {"per_call": e.count / calls,
                                                              "us_per_call": dt / calls}
    return out


def _report(key: str, res: dict, out: dict) -> None:
    out[key] = res
    blocks = res.pop("blocks")
    print(f"{key}: " + "; ".join(f"{p} {r['first_us']:.2f}-{r['last_us']:.2f}"
                                 for p, r in res.items() if isinstance(r, dict)) + " us",
          flush=True)
    for kind, r in blocks.items():
        print(f"  a block of {kind}: tiles ready at {r['tiles_ready_us']}, phase "
              f"points at {r['points_us']} us", flush=True)
    res["blocks"] = blocks


def main() -> int:
    dev = torch.device("cuda:0")
    out = {"card": torch.cuda.get_device_name(0)}
    for name, shape in SHAPES.items():
        for qkv in (True, False):
            plan, call = _swiglu_call(shape, dev, 8, qkv)
            res = trace(plan, call, qkv=qkv)
            _report(f"{name} {'B2' if qkv else 'B8a'} stages {res.pop('stages')}", res, out)
    plan, call = _mlp_swiglu_call(SHAPES["qwen3"], dev, 8)
    res = trace(plan, call, qkv=False, skip=(1, 2))
    _report(f"qwen3 B8b stages {res.pop('stages')}", res, out)
    plan, call = _gelu_call(GELU_SHAPE, dev, 8)
    res = trace(plan, call)
    _report(f"xtts B9b stages {res.pop('stages')}", res, out)
    plan, call = _mlp_gelu_call(GELU_SHAPE, dev, 8)
    res = trace(plan, call, qkv=False, skip=(1, 2))
    _report(f"xtts B9d stages {res.pop('stages')}", res, out)
    _, chain = _gelu_call(GELU_SHAPE, dev, 8, chain=True)
    kernels = chain_kernels(chain)
    out["xtts B9b old chain"] = kernels
    print("xtts B9b, the old chain: " + "; ".join(
        f"{k} x{v['per_call']:g} {v['us_per_call']:.2f} us" for k, v in kernels.items())
        + f"; total {sum(v['us_per_call'] for v in kernels.values()):.2f} us a call", flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
