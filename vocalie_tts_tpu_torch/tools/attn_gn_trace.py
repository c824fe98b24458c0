"""Where a call of B1 (the int8 T-blocked decode attention,
``vocalie_tts_tpu_torch/csrc/decode_attention.cu``), of B1w split over a
cluster (the whole-row int8 decode attention, the same file) and of B13's
one-pass GroupNorm (``csrc/groupnorm.cu``) spends its time on the GPU, phase
by phase, from the card's own clock.

    python3 -m vocalie_tts_tpu_torch.tools.attn_gn_trace

Needs an NVIDIA GPU and ``nvcc`` (the port builds its kernels at first
use). Thread 0 of every block writes ``%globaltimer`` (ns) at the phase
points ``ops/decode_attention.py`` ``INT8_STAMP_POINTS`` and
``ops/decode_attention.py`` ``WHOLE_STAMP_POINTS`` and
``ops/groupnorm.py`` ``STAMP_POINTS`` name. At B1's two main shapes (the T3
voice-over: 16 rows x 16 kv heads of 64, cache 640 with 416 valid slots;
Qwen3: 8 rows x 8 kv heads of 128 for 16 q heads, cache 512 with 352
valid) at every split count the valid blocks allow, at B1w's three
(``chip_smoke.py`` ``T3_WHOLE`` and ``QWEN3_WHOLE``: the T3 cache of 600
slots with 552 valid and the current token, the same without it, all 600
read; Qwen3's cache of 520 with 352 valid) at every split count from 1 to
16, and at B13's four
studio shapes (``chip_smoke.py`` ``GN_CASES``), it prints for each point
the µs from the first block's start at which the first and the last block
reached it (the median of 20 calls), the launch's plan, and the call's time
by CUDA events (eager: the stamped calls, one after another); then all of it
as one JSON line. Inputs are random, from a seed.
"""

from __future__ import annotations

import json
import math
import statistics

import torch

#: B1's shapes: (b, kv, g, d, T, valid_len)
B1_SHAPES = {"t3": (16, 16, 1, 64, 640, 416), "qwen3": (8, 8, 2, 128, 512, 352)}
#: B1w's shapes: (b, kv, g, d, T, valid_len or None: no current token)
B1W_SHAPES = {"t3": (16, 16, 1, 64, 600, 552), "t3_no_new": (16, 16, 1, 64, 600, None),
              "qwen3": (8, 8, 2, 128, 520, 352)}
#: B13's shapes (chip_smoke.py GN_CASES): (shape, eps, FiLM row, SiLU)
GN_SHAPES = {"unet_level0": ((128, 16, 32, 128), 1e-5, True, True),
             "unet_level2": ((128, 4, 8, 1024), 1e-5, False, True),
             "vae_level0": ((64, 64, 128, 64), 1e-6, False, True),
             "unet_level1": ((128, 8, 16, 384), 1e-5, False, True)}


def _phases(runs, points) -> dict:
    """Median first / last block arrival per point (µs from the earliest
    start) over ``runs``, each a [blocks, points] int64 tensor of ns."""
    firsts, lasts = [[] for _ in points], [[] for _ in points]
    for t in runs:
        t0 = int(t[:, 0][t[:, 0] > 0].min())
        for p in range(len(points)):
            col = t[:, p][t[:, p] > 0]
            if len(col):
                firsts[p].append((int(col.min()) - t0) / 1e3)
                lasts[p].append((int(col.max()) - t0) / 1e3)
    return {points[p]: {"first_us": round(statistics.median(firsts[p]), 3),
                        "last_us": round(statistics.median(lasts[p]), 3)}
            for p in range(len(points)) if firsts[p]}


def _call_ms(fn, calls: int) -> float:
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / calls


def trace_b1(dev, shape: str, splits: int, calls: int = 20) -> dict:
    from vocalie_tts_tpu_torch.ops import decode_attention as da

    b, kv, g, d, T, valid = B1_SHAPES[shape]
    gen = torch.Generator(device=dev).manual_seed(2)
    q = torch.randn((b, kv, g, d), generator=gen, device=dev)
    k, v = (torch.randint(-127, 128, (2, b, kv, T, d), generator=gen, device=dev,
                          dtype=torch.int8) for _ in range(2))
    ks, vs = (((torch.rand((2, b, kv, T), generator=gen, device=dev) + 0.5) / 127)
              .to(torch.bfloat16) for _ in range(2))
    kn, vn = (torch.randn((b, kv, d), generator=gen, device=dev) for _ in range(2))
    bias = torch.zeros((b, T), device=dev)
    n = da.INT8_STAMPS
    stamps = torch.zeros((b * kv * splits * n,), dtype=torch.int64, device=dev)

    def call(st=None):
        return da.decode_attention_int8_stacked(q, k, v, bias, 1, ks, vs, kn, vn, valid_len=valid,
                                                sm_scale=1 / math.sqrt(d), splits=splits,
                                                stamps=st)

    call(stamps)
    runs = []
    for _ in range(calls):
        stamps.zero_()
        call(stamps)
        torch.cuda.synchronize()
        runs.append(stamps.cpu().view(-1, n))
    return {"splits": splits, "blocks": b * kv * splits,
            "phases": _phases(runs, da.INT8_STAMP_POINTS), "call_ms": _call_ms(call, calls)}


def trace_b1w(dev, shape: str, splits=None, calls: int = 20) -> dict:
    """B1w's split body at ``shape`` over ``splits`` ranks (None: the
    planned count)."""
    from vocalie_tts_tpu_torch.ops import decode_attention as da

    b, kv, g, d, T, valid = B1W_SHAPES[shape]
    n = valid if valid is not None else T
    planned = da.card_whole_splits(b * kv, n, g, d)
    splits = splits or planned
    gen = torch.Generator(device=dev).manual_seed(3)
    q = torch.randn((b, kv, g, d), generator=gen, device=dev)
    k, v = (torch.randint(-127, 128, (2, b, kv, T, d), generator=gen, device=dev,
                          dtype=torch.int8) for _ in range(2))
    ks, vs = (((torch.rand((2, b, kv, T), generator=gen, device=dev) + 0.5) / 127)
              .to(torch.bfloat16) for _ in range(2))
    new = (None, None) if valid is None else tuple(
        torch.randn((b, kv, d), generator=gen, device=dev) for _ in range(2))
    bias = torch.zeros((b, T), device=dev)
    w = da.WHOLE_STAMPS
    stamps = torch.zeros((b * kv * splits * w,), dtype=torch.int64, device=dev)

    def call(st=None):
        return da.decode_attention_int8_whole_stacked(
            q, k, v, bias, 1, ks, vs, *new, valid_len=valid, sm_scale=1 / math.sqrt(d),
            splits=splits, stamps=st)

    call(stamps)
    runs = []
    for _ in range(calls):
        stamps.zero_()
        call(stamps)
        torch.cuda.synchronize()
        runs.append(stamps.cpu().view(-1, w))
    return {"splits": splits, "planned": splits == planned, "blocks": b * kv * splits,
            "phases": _phases(runs, da.WHOLE_STAMP_POINTS), "call_ms": _call_ms(call, calls)}


def trace_b13(dev, case: str, calls: int = 20) -> dict:
    from vocalie_tts_tpu_torch.models.common.unet2d import n_groups
    from vocalie_tts_tpu_torch.ops import groupnorm as gn

    shape, eps, pre, silu = GN_SHAPES[case]
    c = shape[-1]
    gen = torch.Generator(device=dev).manual_seed(sum(shape))
    x = (torch.randn(shape, generator=gen, device=dev) * 2 + 0.5).to(torch.bfloat16)
    w = 1 + 0.2 * torch.randn((c,), generator=gen, device=dev)
    bb = 0.1 * torch.randn((c,), generator=gen, device=dev)
    e = (0.3 * torch.randn((shape[0], c), generator=gen, device=dev)).to(torch.bfloat16) \
        if pre else None
    s = math.prod(shape[1:-1])
    n_cl, rows, pieces = gn.gn_plan(shape[0], s, c, n_groups(c), 8,
                                    torch.cuda.get_device_properties(dev).multi_processor_count)
    n = len(gn.STAMP_POINTS)
    stamps = torch.zeros((shape[0] * n_cl * n,), dtype=torch.int64, device=dev)

    def call(st=None):
        return gn.group_norm_fused(x, w, bb, groups=n_groups(c), eps=eps, silu=silu, pre_add=e,
                                   stamps=st)

    call(stamps)
    runs = []
    for _ in range(calls):
        stamps.zero_()
        call(stamps)
        torch.cuda.synchronize()
        runs.append(stamps.cpu().view(-1, n))
    return {"cluster": n_cl, "rows_a_block": rows, "pieces": pieces,
            "blocks": shape[0] * n_cl, "phases": _phases(runs, gn.STAMP_POINTS),
            "call_ms": _call_ms(call, calls)}


def _line(label: str, res: dict) -> str:
    return (f"{label}: " + "; ".join(f"{p} {r['first_us']:.2f}-{r['last_us']:.2f}"
                                     for p, r in res["phases"].items())
            + f" us; a call {res['call_ms']:.6f} ms")


def main() -> int:
    from vocalie_tts_tpu_torch.ops import decode_attention as da

    dev = torch.device("cuda:0")
    out = {"card": torch.cuda.get_device_name(0), "b1": {}, "b1w": {}, "b13": {}}
    for shape, (b, kv, g, d, T, valid) in B1_SHAPES.items():
        n_blk = da.n_valid_blocks(valid, T)
        planned = da.card_int8_splits(b * kv, n_blk, g, d)
        for splits in range(1, n_blk + 1):
            res = trace_b1(dev, shape, splits)
            res["planned"] = splits == planned
            out["b1"][f"{shape} splits {splits}"] = res
            print(_line(f"B1 {shape}, {splits} split(s) ({res['blocks']} blocks"
                        f"{', planned' if res['planned'] else ''})", res), flush=True)
    for shape in B1W_SHAPES:
        for splits in range(1, da.WHOLE_SPLIT_MAX + 1):
            res = trace_b1w(dev, shape, splits)
            out["b1w"][f"{shape} splits {splits}"] = res
            print(_line(f"B1w {shape}, {splits} split(s) ({res['blocks']} blocks"
                        f"{', planned' if res['planned'] else ''})", res), flush=True)
    for case in GN_SHAPES:
        res = trace_b13(dev, case)
        out["b13"][case] = res
        print(_line(f"B13 {case} (cluster {res['cluster']}, {res['rows_a_block']} rows a block, "
                    f"{res['pieces']} pieces, {res['blocks']} blocks)", res), flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
