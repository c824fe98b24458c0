"""Where a call of the port's whole-layer decode kernel (B12,
``vocalie_tts_tpu_torch/csrc/decode_layer.cu``, ``VOCALIE_MEGALAYER=1``)
spends its time on the GPU, phase by phase, from the card's own clock.

    python3 -m vocalie_tts_tpu_torch.tools.decode_layer_trace

Needs an NVIDIA GPU and ``nvcc`` (the port builds its kernels at first
use). Thread 0 of every block writes ``%globaltimer`` (ns) at the
attention's thirteen points (``decode_layer.ATT_STAMP_POINTS``: entry, its
first item's bytes in, that item's scores, its prefix max known, its p8 .
v, its end with the pair's merge if it came last, the block's attention
done, its ring asked for, every pair merged (o-projection blocks), the
o-projection's end, o8 in, its first Wo tile in, its heads' parts) and at
the tail's twelve (B2's, ``tools/tail_swiglu_trace.py``: entry, the
o-projection's end, after barrier 1, after the MLP norm, gate | up's end,
after barrier 2, the hidden quantized, after barrier 3, the
down-projection's start, its end, after barrier 4, the exit), and the time
each of its first 64 weight tiles was ready to its block. At the
Chatterbox T3 layer (b 16, 16 heads of 64, cache 640 at 416 valid slots)
and the Qwen3 layer (b 8, 8 kv x 2 q heads of 128, cache 512 at 352), with
random int8 weights and cache from a seed (each call reading another
layer, so that they come from device memory), it prints for each point the
µs from the first block's entry at which the first and the last block
reached it (the median of 20 calls), when the first and the last Wo and
gate | up tiles were ready over all blocks, and the attention's split
(``slots`` items a block, a ``team`` of warps each); then all of it as one
JSON line.
"""

from __future__ import annotations

import json
import statistics
import types

import torch

TAIL_POINTS = ("entry", "o-proj end", "barrier 1", "mlp norm", "gate|up end", "barrier 2",
               "hidden quantized", "barrier 3", "down start", "down end", "barrier 4", "exit")
#: the two served layers: layers stacked, rows, kv heads, q heads a kv head,
#: d_head, cache slots, prompt slots, decoded slots, d_model, d_ff, eps
SHAPES = {"t3": dict(L=30, b=16, kv=16, g=1, d=64, T=640, prompt_pad=256, n_dec=160, D=1024,
                     F=4096, eps=1e-5),
          "qwen3": dict(L=28, b=8, kv=8, g=2, d=128, T=512, prompt_pad=256, n_dec=96, D=2048,
                        F=8192, eps=1e-6)}


def _inputs(label: str, dev):
    """B12's inputs at a served layer, from a seed: random int8 weights and
    cache with their scales, the prompt's padding and the slots past
    valid_len masked, q/k/v f32 and the residual bf16-valued f32 as the
    decode step hands them over."""
    L, b, kv, g, d, T, pad, n_dec, D, F, eps = SHAPES[label].values()
    H, valid_len = kv * g, pad + n_dec
    Q = (H + 2 * kv) * d
    gen = torch.Generator(device=dev).manual_seed(101)

    def weights(d_in, d_out):
        w = torch.randint(-127, 128, (L, d_in, d_out), generator=gen, device=dev,
                          dtype=torch.int8)
        return w, (torch.rand((L, 1, d_out), generator=gen, device=dev) + 0.5) / 127 * d_in ** -0.5

    q = torch.randn((b, kv, g, d), generator=gen, device=dev)
    x = torch.randn((b, D), generator=gen, device=dev).to(torch.bfloat16).float()
    k, v = (torch.randint(-127, 128, (L, b, kv, T, d), generator=gen, device=dev,
                          dtype=torch.int8) for _ in range(2))
    ks, vs = (((torch.rand((L, b, kv, T), generator=gen, device=dev) + 0.5) / 127)
              .to(torch.bfloat16) for _ in range(2))
    kn, vn = (torch.randn((b, kv, d), generator=gen, device=dev) for _ in range(2))
    lens = torch.randint(1, pad + 1, (b,), generator=gen, device=dev)
    pos = torch.arange(T, device=dev)[None, :]
    bias = torch.where((pos < lens[:, None]) | ((pos >= pad) & (pos < valid_len)),
                       0.0, -0.7 * torch.finfo(torch.float32).max).float()
    wo, wos = weights(H * d, D)
    mw = 1 + 0.1 * torch.randn((L, D), generator=gen, device=dev)
    wgu, sgu = weights(D, 2 * F)
    wd, sd = weights(F, D)
    nw = 1 + 0.1 * torch.randn((L, D), generator=gen, device=dev)
    wq, sq = weights(D, Q)
    return types.SimpleNamespace(
        L=L, b=b, kv=kv, g=g, d=d, T=T, D=D, F=F, Q=Q, valid_len=valid_len,
        head=(q, x, k, v, ks, vs, bias, kn, vn), tail=(wo, wos, mw, wgu, sgu, wd, sd, nw, wq, sq),
        kw=dict(sm_scale=d ** -0.5, eps=eps))


def trace(label: str, calls: int = 20) -> dict:
    from vocalie_tts_tpu_torch.ops import decode_layer as dl
    from vocalie_tts_tpu_torch.ops.decode_attention import n_valid_blocks
    from vocalie_tts_tpu_torch.ops.decode_dense import _ff_tile

    dev = torch.device("cuda:0")
    t = _inputs(label, dev)
    tile = _ff_tile(t.D, t.F, t.Q)
    plan = dl.layer_plan(t.b, t.kv, t.g, t.d, t.T, t.D, t.F, tile, t.Q,
                         torch.cuda.get_device_properties(dev).multi_processor_count)
    slots, team = dl.layer_splits(plan)[n_valid_blocks(t.valid_len, t.T) - 1]
    stamps = torch.zeros((plan.grid * dl.LAYER_STAMPS,), dtype=torch.int64, device=dev)

    def call(layer, st=None):
        return dl.layer_swiglu_qkv_int8_stacked(*t.head, layer, t.valid_len, *t.tail, **t.kw,
                                                stamps=st)

    call(0)
    n_tail, n_tiles = len(TAIL_POINTS), 64
    points = [f"attn: {p}" for p in dl.ATT_STAMP_POINTS] + list(TAIL_POINTS)
    firsts, lasts = [[] for _ in points], [[] for _ in points]
    tiles = {"wo": ([], []), "gate|up": ([], [])}
    items = plan.items()
    kc = plan.tail.kc
    per_item = (plan.heads * plan.d // kc, 2 * t.D // kc, t.F // kc, t.D // kc)   # tiles an item
    for i in range(calls):
        call(i % t.L, stamps)
        torch.cuda.synchronize()
        flat = stamps.cpu()
        tail = flat[:plan.grid * n_tail].view(plan.grid, n_tail)
        land = flat[plan.grid * n_tail:plan.grid * (n_tail + n_tiles)].view(plan.grid, n_tiles)
        att = flat[plan.grid * (n_tail + n_tiles):].view(plan.grid, len(dl.ATT_STAMP_POINTS))
        t0 = int(tail[:, 0].min())
        for p, col in enumerate([att[:, j] for j in range(att.shape[1])]
                                + [tail[:, j] for j in range(n_tail)]):
            seen = col[col > 0]
            if len(seen):
                firsts[p].append((int(seen.min()) - t0) / 1e3)
                lasts[p].append((int(seen.max()) - t0) / 1e3)
        for key, prod in (("wo", 0), ("gate|up", 1)):
            got = []
            for blk, its in enumerate(items):
                j = 0
                for p, _ in its:
                    n = per_item[p]
                    if p == prod:
                        got += [int(v) for v in land[blk, j:min(j + n, n_tiles)] if int(v) > 0]
                    j += n
            if got:
                tiles[key][0].append((min(got) - t0) / 1e3)
                tiles[key][1].append((max(got) - t0) / 1e3)
        stamps.zero_()
    out = {"slots": slots, "team": team, "stages": plan.tail.stages,
           "kc": plan.tail.kc,
           "points": {points[p]: {"first_us": statistics.median(firsts[p]),
                                  "last_us": statistics.median(lasts[p])}
                      for p in range(len(points)) if firsts[p]},
           "tiles": {k: {"first_us": statistics.median(v[0]), "last_us": statistics.median(v[1])}
                     for k, v in tiles.items() if v[0]}}
    return out


def main() -> int:
    out = {"card": torch.cuda.get_device_name(0)}
    for label in ("t3", "qwen3"):
        res = trace(label)
        key = f"{label} slots {res['slots']} team {res['team']} (stages {res['stages']})"
        out[key] = res
        print(f"{key}: " + "; ".join(f"{p} {r['first_us']:.2f}-{r['last_us']:.2f}"
                                     for p, r in res["points"].items()) + " us", flush=True)
        print("  tiles ready: " + "; ".join(f"{k} {r['first_us']:.2f}-{r['last_us']:.2f}"
                                             for k, r in res["tiles"].items()) + " us",
              flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
