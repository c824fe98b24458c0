"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero before the final line is printed):

1. build the port's CUDA kernels from ``vocalie_tts_tpu_torch/csrc`` with
   nvcc for sm_90a (one nvcc per source, all started together);
2. for each kernel of the voice-over path — B1 int8 decode attention,
   B5 KV-cache append, B6 flash attention — at the shapes the path gives
   it: hold the kernel against its plain PyTorch version on the card,
   time kernel, plain version and (where one exists) the one PyTorch call
   that computes the same function, and compute the least time the card
   could take (bytes over 3.35 TB/s or operations over the peak rate);
3. a small-input reference check: the tiny-scale model on the GPU
   (kernels) against the same weights on the CPU (plain versions) —
   teacher-forced decode logits and stage-2 PCM on shared noise;
4. the main path: ``run_tts_pipeline`` at the full Chatterbox T3 width
   (random weights from a seed) with the slice's env, for the 8-chunk
   bench script and for a request whose chunk takes the 512 prompt
   bucket (causal flash attention in prefill). Every WAV is checked, the
   kernels' launch counters must have moved, and audio seconds, wall
   seconds and the real-time factor are printed.

The second-to-last lines are the card's name and power limit and a JSON
``kernels`` line; the last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import tempfile
import time

import torch

PEAK_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
PEAK_BF16_FLOPS = 989e12        # H100 SXM dense bf16 tensor rate
PEAK_INT8_OPS = 1979e12
NEG = -0.7 * float(torch.finfo(torch.float32).max)

SLICE_ENV = {
    "VOCALIE_KV_INT8": "1",
    "VOCALIE_WEIGHT_INT8": "1",
    "VOCALIE_DENSE_KERNEL": "0",
}

# the bench script: ~60 s of French voice-over in 8 marked chunks
_SENT = (
    "Découvrez une nouvelle façon de créer vos voix off en français, "
    "avec un rendu naturel et une diction parfaitement maîtrisée."
)
BENCH_SCRIPT = "\n[[CHUNK]]\n".join([_SENT] * 8)
# one chunk of > 250 text bytes (no sentence end inside), so the prompt
# takes the 512 bucket and prefill runs the causal flash kernel
LONG_CHUNK = (
    "Dans ce long passage lu d'une seule traite sans le moindre point final "
    "la voix doit garder son souffle et son rythme tout au long de la phrase "
    "car le texte continue encore et encore avec des virgules, des incises "
    "et des détours qui ne s'arrêtent jamais vraiment avant la toute fin "
    "de cette démonstration du moteur"
)
LONG_SCRIPT = _SENT + "\n[[CHUNK]]\n" + LONG_CHUNK


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of ``fn(i)`` over ``iters`` calls (CUDA events)."""
    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(i)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(n_bytes: float, n_ops: float, peak_ops: float):
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_ops / peak_ops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ── phase 2: kernels against their plain versions ───────────────────────


def check_decode_attention(dev, failures):
    from vocalie_tts_tpu_torch.ops.decode_attention import (
        decode_attention_plain,
        decode_attention_stacked,
    )

    # the voice-over path: b = 16 (8 chunks, CFG-doubled), 16 kv heads,
    # d_head 64, 30 layers, cache 640 (256 + 320 buckets), mid-decode
    L, b, kv, g, d, T = 30, 16, 16, 1, 64, 640
    prompt_pad, n_dec = 256, 160
    valid_len = prompt_pad + n_dec
    gen = torch.Generator(device=dev).manual_seed(1)
    q = torch.randn((b, kv, g, d), generator=gen, device=dev)
    k = torch.randint(-127, 128, (L, b, kv, T, d), generator=gen, device=dev, dtype=torch.int8)
    v = torch.randint(-127, 128, (L, b, kv, T, d), generator=gen, device=dev, dtype=torch.int8)
    ks = ((torch.rand((L, b, kv, T), generator=gen, device=dev) + 0.5) / 127).to(torch.bfloat16)
    vs = ((torch.rand((L, b, kv, T), generator=gen, device=dev) + 0.5) / 127).to(torch.bfloat16)
    kn = torch.randn((b, kv, d), generator=gen, device=dev)
    vn = torch.randn((b, kv, d), generator=gen, device=dev)
    lens = torch.randint(1, prompt_pad + 1, (b,), generator=gen, device=dev)
    pos = torch.arange(T, device=dev)[None, :]
    valid = (pos < lens[:, None]) | ((pos >= prompt_pad) & (pos < valid_len))
    bias = torch.where(valid, 0.0, NEG).float()
    sm = 1.0 / math.sqrt(d)
    layer = 7
    out = decode_attention_stacked(q, k, v, bias, layer, ks, vs, kn, vn,
                                   valid_len=valid_len, sm_scale=sm)
    ref = decode_attention_plain(q, k, v, bias, layer, ks, vs, kn, vn, valid_len, sm)
    torch.cuda.synchronize()
    err = (out - ref).abs().max().item()
    # outputs are ~0.04; one p rounded one int8 step the other way (exp /
    # sum order) moves an output by ~1e-4, while a p block other than 128
    # slots moves it by > 2e-3 (tests/test_torch_decode_attention.py)
    tol = 5e-4
    log(f"B1 decode_attention: max_abs_err={err:.3e} (tolerance {tol}: a few int8 steps of p "
        "rounded the other way; a wrong p block size is > 2e-3)")
    if not err <= tol:
        failures.append(f"B1 max_abs_err {err} > {tol}")
    # each call reads another layer, as the decode step does (the whole
    # cache, 630 MB, is far larger than the 50 MB L2)
    ms = cuda_ms(lambda i: decode_attention_stacked(
        q, k, v, bias, i % L, ks, vs, kn, vn, valid_len=valid_len, sm_scale=sm), 300)
    plain_ms = cuda_ms(lambda i: decode_attention_plain(
        q, k, v, bias, i % L, ks, vs, kn, vn, valid_len, sm), 20)
    n_bytes = (valid_len * b * kv * (2 * d + 2 * 2) + valid_len * b * 4
               + b * kv * d * 4 * 2 + 2 * b * kv * g * d * 4)
    n_ops = 2 * 2 * valid_len * b * kv * g * d
    bms, by = bound_ms(n_bytes, n_ops, PEAK_INT8_OPS)
    return {"name": "B1 decode_attention_int8", "route": "cuda",
            "source": "vocalie_tts_tpu_torch/csrc/decode_attention.cu",
            "replaces": "vocalie_tts_tpu/ops/decode_attention.py:565",
            "max_abs_err": err, "tolerance": tol, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bms, "bound_by": by, "library_ms": None,
            "shape": f"q[{b},{kv},{g},{d}] cache[{L},{b},{kv},{T},{d}] int8 valid_len={valid_len}"}


def check_cache_append(dev, failures):
    from vocalie_tts_tpu_torch.ops.cache_update import cache_append_plain, cache_append_stacked

    L, b, kv, d, T, pos = 30, 16, 16, 64, 640, 416
    gen = torch.Generator(device=dev).manual_seed(2)
    k = torch.randint(-127, 128, (L, b, kv, T, d), generator=gen, device=dev, dtype=torch.int8)
    v = torch.randint(-127, 128, (L, b, kv, T, d), generator=gen, device=dev, dtype=torch.int8)
    ks = torch.rand((L, b, kv, T), generator=gen, device=dev).to(torch.bfloat16)
    vs = torch.rand((L, b, kv, T), generator=gen, device=dev).to(torch.bfloat16)
    kn = torch.randint(-127, 128, (L, b, kv, d), generator=gen, device=dev, dtype=torch.int8)
    vn = torch.randint(-127, 128, (L, b, kv, d), generator=gen, device=dev, dtype=torch.int8)
    ksn = torch.rand((L, b, kv), generator=gen, device=dev).to(torch.bfloat16)
    vsn = torch.rand((L, b, kv), generator=gen, device=dev).to(torch.bfloat16)
    got = cache_append_stacked(k.clone(), v.clone(), ks.clone(), vs.clone(),
                               kn, vn, ksn, vsn, pos)
    ref = cache_append_plain(k.clone(), v.clone(), ks.clone(), vs.clone(), kn, vn, ksn, vsn, pos)
    torch.cuda.synchronize()
    exact = all(torch.equal(a.view(torch.uint8) if a.dtype == torch.int8 else a.view(torch.int16),
                            r.view(torch.uint8) if r.dtype == torch.int8 else r.view(torch.int16))
                for a, r in zip(got, ref))
    err = 0.0 if exact else float("inf")
    log(f"B5 cache_append: byte-exact={exact} (tolerance: byte-exact)")
    if not exact:
        failures.append("B5 differs from its plain version")
    ms = cuda_ms(lambda i: cache_append_stacked(k, v, ks, vs, kn, vn, ksn, vsn, i % T), 300)
    plain_ms = cuda_ms(lambda i: cache_append_plain(k, v, ks, vs, kn, vn, ksn, vsn, i % T), 100)
    rows = L * b * kv
    bms, by = bound_ms(2 * rows * (2 * d + 2 * 2), 0, PEAK_INT8_OPS)
    return {"name": "B5 cache_append", "route": "cuda",
            "source": "vocalie_tts_tpu_torch/csrc/cache_update.cu",
            "replaces": "vocalie_tts_tpu/ops/cache_update.py:84",
            "max_abs_err": err, "tolerance": 0.0, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bms, "bound_by": by, "library_ms": None,
            "shape": f"new[{L},{b},{kv},{d}] int8 into cache[{L},{b},{kv},{T},{d}]"}


def _flash_case(dev, failures, *, b, h, s, d, causal, kv_lens_lo, seed, label):
    import torch.nn.functional as F

    from vocalie_tts_tpu_torch.ops.flash_attention import attention_plain, flash_attention

    gen = torch.Generator(device=dev).manual_seed(seed)
    q, k, v = (torch.randn((b, h, s, d), generator=gen, device=dev).to(torch.bfloat16)
               for _ in range(3))
    lens = None
    if kv_lens_lo is not None:
        lens = torch.randint(kv_lens_lo, s + 1, (b,), generator=gen, device=dev,
                             dtype=torch.int32)
    out = flash_attention(q, k, v, causal=causal, kv_lens=lens)
    ref = attention_plain(q, k, v, causal=causal, kv_lens=lens)
    torch.cuda.synchronize()
    diff = (out.float() - ref.float()).abs()
    err = diff.max().item()
    tol = 1e-2
    worst = (diff / (tol + tol * ref.float().abs())).max().item()
    log(f"B6 flash_attention [{label}]: max_abs_err={err:.3e}, worst |diff| / (1e-2 + 1e-2|ref|) = "
        f"{worst:.3f} (must be <= 1: bf16 in and out, one bf16 step is 2^-8 of the value; "
        "p is rounded to bf16 against a running max in the kernel, the row max in the plain version)")
    if not worst <= 1.0:
        failures.append(f"B6 [{label}] differs: worst ratio {worst}")
    ms = cuda_ms(lambda i: flash_attention(q, k, v, causal=causal, kv_lens=lens), 50)
    plain_ms = cuda_ms(lambda i: attention_plain(q, k, v, causal=causal, kv_lens=lens), 10)
    if lens is not None:
        keep = torch.arange(s, device=dev)[None, :] < lens[:, None]
        mask = keep[:, None, None, :]
        lib_ms = cuda_ms(lambda i: F.scaled_dot_product_attention(q, k, v, attn_mask=mask), 50)
        kv_rows = h * lens.sum().item()
        pairs = s * kv_rows
        # q read and o written in full; k and v only up to each row's kv_len
        n_bytes = 2 * b * h * s * d * 2 + 2 * kv_rows * d * 2 + 4 * b
    else:
        lib_ms = cuda_ms(lambda i: F.scaled_dot_product_attention(q, k, v, is_causal=causal), 50)
        pairs = b * h * (s * (s + 1) // 2 if causal else s * s)
        n_bytes = 4 * b * h * s * d * 2
    n_ops = 4 * d * pairs
    bms, by = bound_ms(n_bytes, n_ops, PEAK_BF16_FLOPS)
    return {"max_abs_err": err, "tolerance": "atol 1e-2 + rtol 1e-2", "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bms, "bound_by": by, "library_ms": lib_ms,
            "shape": f"{label}: q/k/v[{b},{h},{s},{d}] bf16"}


def check_flash_attention(dev, failures):
    # CFM transformer blocks: 8 rows CFG-doubled, 8 heads, 640 mel frames
    cfm = _flash_case(dev, failures, b=16, h=8, s=640, d=64, causal=False, kv_lens_lo=320,
                      seed=3, label="cfm non-causal kv_lens")
    # prefill at the 512 prompt bucket
    pre = _flash_case(dev, failures, b=16, h=16, s=512, d=64, causal=True, kv_lens_lo=None,
                      seed=4, label="prefill causal")
    return {"name": "B6 flash_attention", "route": "cuda",
            "source": "vocalie_tts_tpu_torch/csrc/flash_attention.cu",
            "replaces": "vocalie_tts_tpu/ops/flash_attention.py:226",
            **cfm, "prefill_causal": pre}


# ── phase 3: small-input reference (GPU kernels vs CPU plain) ───────────


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, dev) for v in tree]
    return tree.to(dev)


def small_reference(dev, failures):
    import dataclasses

    from vocalie_tts_tpu_torch.models.chatterbox.runtime import SCALES, ChatterboxRuntime
    from vocalie_tts_tpu_torch.models.common import transformer as tr
    from vocalie_tts_tpu_torch.models.common.token2wav import draw_stage2_noise

    os.environ["VOCALIE_MODEL_SCALE"] = "tiny"
    with tempfile.TemporaryDirectory() as tmp:
        rt = ChatterboxRuntime.create(tmp, force_init=True, device=dev, seed=11)
        cpu = ChatterboxRuntime(_to(rt.params, "cpu"), rt.cfg, rt.weights_dir,
                                torch.device("cpu"))
    cfg = rt.cfg.lm
    assert cfg.kv_quant and cfg.decode_kernel and not cfg.dense_kernel
    gen = torch.Generator().manual_seed(5)
    b, s = 4, 64
    emb = torch.randn((b, s, cfg.d_model), generator=gen) * 0.5
    lens = torch.tensor([64, 40, 3, 21], dtype=torch.int32)
    toks = torch.randint(0, cfg.vocab_size, (12, b), generator=gen)
    worst = 0.0
    caches = {}
    for name, r, d in (("gpu", rt, dev), ("cpu", cpu, torch.device("cpu"))):
        lm = r.params["t3"]["lm"]
        logits, cache = tr.prefill(lm, cfg, None, lens.to(d), inputs_embeds=emb.to(d),
                                   cache_len=256)
        steps = [logits.cpu()]
        for i in range(toks.shape[0]):
            logits, cache = tr.decode_step(lm, cfg, toks[i].to(d), cache)
            steps.append(logits.cpu())
        caches[name] = steps
    for a, c in zip(caches["gpu"], caches["cpu"]):
        worst = max(worst, ((a - c).abs() / (2e-3 + 2e-3 * c.abs())).max().item())
    log(f"small reference: tiny T3 prefill + 12 teacher-forced decode steps, GPU kernels vs "
        f"CPU plain: worst |diff| / (2e-3 + 2e-3|ref|) = {worst:.3f} (must be <= 1)")
    if not worst <= 1.0:
        failures.append(f"tiny decode logits differ: {worst}")

    n_tok = 140  # 280 mel frames: the CFM blocks take the flash kernel
    gtok = torch.randint(0, rt.cfg.speech_vocab, (3, n_tok), generator=gen)
    glen = torch.tensor([140, 90, 5], dtype=torch.int32)
    noise = draw_stage2_noise(rt.cfg.t2w, 3, n_tok, gen, "cpu")
    pcm_cpu = cpu.stage2_pcm16(gtok, glen, noise)
    pcm_gpu = rt.stage2_pcm16(gtok.to(dev), glen.to(dev), dataclasses.replace(
        noise, **{f.name: getattr(noise, f.name).to(dev)
                  for f in dataclasses.fields(noise)})).cpu()
    lsb = (pcm_gpu.int() - pcm_cpu.int()).abs().max().item()
    log(f"small reference: tiny stage 2 on shared noise, GPU vs CPU: max |diff| = {lsb} LSB "
        "of int16 (tolerance 33 = 1e-3 of full scale)")
    if not lsb <= 33:
        failures.append(f"tiny stage-2 PCM differs by {lsb} LSB")


# ── phase 4: the main path ───────────────────────────────────────────────


def _request(script: str, out_path: str) -> dict:
    from vocalie_tts_tpu_torch.text import parse_manual_chunks

    return {
        "tts_backend": "chatterbox",
        "script": script,
        "chunks": parse_manual_chunks(script)[0],
        "engine_params": {"chatterbox_mode": "fr_finetune", "cfg_weight": 0.6,
                          "temperature": 0.5, "repetition_penalty": 1.35},
        "inter_chunk_gap_ms": 250,
        "target_sr": 24000,
        "out_path": out_path,
    }


def main_path(dev, failures, scale: str = "full"):
    from vocalie_tts_tpu_torch.engines.chatterbox import ChatterboxEngine
    from vocalie_tts_tpu_torch.io.wavio import read_wav
    from vocalie_tts_tpu_torch.ops.cache_update import cache_append_stacked
    from vocalie_tts_tpu_torch.ops.decode_attention import decode_attention_stacked
    from vocalie_tts_tpu_torch.ops.flash_attention import flash_attention
    from vocalie_tts_tpu_torch.pipeline import run_tts_pipeline

    os.environ["VOCALIE_MODEL_SCALE"] = scale
    os.environ["VOCALIE_ALLOW_RANDOM_WEIGHTS"] = "1"
    wrappers = (decode_attention_stacked, cache_append_stacked, flash_attention)
    requests = [("bench 8-chunk", BENCH_SCRIPT), ("512-bucket prompt", LONG_SCRIPT)]
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.monotonic()
        engine = ChatterboxEngine(device=dev, assets=os.path.join(tmp, "assets"))
        rt = engine.runtime()
        torch.cuda.synchronize()
        log(f"main path: full-width runtime built in {time.monotonic() - t0:.2f} s "
            f"(random weights, seed 7; T3 {rt.cfg.n_layers} layers x d_model {rt.cfg.d_model})")
        t0 = time.monotonic()
        warm = run_tts_pipeline(_request(BENCH_SCRIPT, os.path.join(tmp, "warm.wav")),
                                engine=engine)
        log(f"main path warm-up (bench script, first call: CUDA/cuBLAS/cuDNN set-up): "
            f"audio {warm.meta['total_duration']:.3f} s, wall {time.monotonic() - t0:.3f} s")
        for w in wrappers:
            w.launches = 0
        per_request = []
        for label, script in requests:
            request = _request(script, os.path.join(tmp, f"{len(per_request)}.wav"))
            chunks = request["chunks"]
            before = [w.launches for w in wrappers]
            t0 = time.monotonic()
            res = run_tts_pipeline(request, engine=engine)
            wall = time.monotonic() - t0
            wav, sr = read_wav(res.out_path)
            meta = res.meta
            gap = int(24000 * 0.25)
            expect = round(sum(meta["durations"]) * 24000) + gap * (len(chunks) - 1)
            ok = (sr == 24000 and len(wav) == expect and len(wav) > 0
                  and bool(torch.isfinite(torch.from_numpy(wav)).all())
                  and abs(len(wav) / sr - meta["total_duration"]) < 1e-9
                  and all(round(dur * 24000) % rt.cfg.samples_per_token == 0
                          for dur in meta["durations"]))
            bm = meta["backend_meta"]
            launches = [w.launches - b0 for w, b0 in zip(wrappers, before)]
            log(f"main path [{label}]: {len(chunks)} chunks, prompt bucket {bm['prompt_bucket']}, "
                f"decode bucket {bm['decode_bucket']}, audio {meta['total_duration']:.3f} s, "
                f"wall {wall:.3f} s, RTF {meta['total_duration'] / wall:.3f}x, wav ok={ok}, "
                f"launches B1/B5/B6 = {launches}")
            if not ok:
                failures.append(f"{label}: WAV check failed (len {len(wav)}, expected {expect})")
            per_request.append({"label": label, "prompt_bucket": bm["prompt_bucket"],
                                "launches": launches})
        if per_request[1]["prompt_bucket"] != 512:
            failures.append("the long request did not reach the 512 prompt bucket")
        if per_request[1]["launches"][2] == 0:
            failures.append("no flash launch in the 512-bucket request")
        counts = {w.__name__: w.launches for w in wrappers}
        for name, n in counts.items():
            if n == 0:
                failures.append(f"{name} was never launched on the main path")
        breakdown(rt, dev)
    return counts


def _profiled(label: str, fn) -> None:
    """Run ``fn`` under torch.profiler (device activity only) and print the
    device's busy share of the wall time and the kernels that fill it."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        fn()
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    rows = []
    for e in prof.key_averages():
        dt = getattr(e, "self_device_time_total", None)
        if dt is None:
            dt = getattr(e, "self_cuda_time_total", 0.0)
        if dt and e.device_type == torch.autograd.DeviceType.CUDA:
            rows.append((dt, e.count, e.key))
    busy = sum(r[0] for r in rows) / 1e6
    if busy <= 0:
        log(f"breakdown [{label}]: device time not measured (profiler saw none)")
        return
    log(f"breakdown [{label}]: wall {wall:.3f} s (profiler on), device busy "
        f"{busy:.3f} s = {busy / wall:.1%}, idle {1 - busy / wall:.1%}")
    for dt, n, key in sorted(rows, reverse=True)[:8]:
        log(f"  {dt / 1e3:10.3f} ms  {n:7d} launches  {key[:90]}")


def breakdown(rt, dev) -> None:
    """Where one bench request's time goes: host wall time of the decode
    (prefill + loop) and of stage 2; then torch.profiler over a window of
    the same work (prefill + 32 decode steps, and one stage-2 call) for
    the device's busy share and the kernels that fill it. The window is
    short because the profiler's post-processing grows with the number of
    launches (~2,000 a decode step)."""
    from vocalie_tts_tpu_torch.models.common.token2wav import draw_stage2_noise

    texts = [_SENT] * 8
    kw = dict(mode="fr_finetune", lang="fr", exaggeration=0.5, cfg_weight=0.6)
    t3, embeds, lens, (_, _, n_dec, cache_len) = rt._prepare_batch(texts, **kw)

    def decode(n_steps):
        return rt.generate(t3, embeds, lens, cache_len=cache_len, max_new=n_steps,
                           temperature=0.5, cfg_weight=0.6, repetition_penalty=1.35)

    def stage2(toks, tl):
        noise = draw_stage2_noise(rt.cfg.t2w, toks.shape[0], toks.shape[1], rt._gen, dev)
        return rt.stage2_pcm16(toks, tl, noise).cpu()

    t0 = time.monotonic()
    toks, tl = decode(n_dec)
    torch.cuda.synchronize()
    t_gen = time.monotonic()
    stage2(toks, tl)
    t_end = time.monotonic()
    log(f"breakdown [bench request]: decode (prefill + {n_dec} steps) {t_gen - t0:.3f} s "
        f"= {(t_gen - t0) / n_dec * 1e3:.2f} ms/step, stage 2 {t_end - t_gen:.3f} s")
    _profiled("prefill + 32 decode steps", lambda: decode(32))
    _profiled(f"stage 2 ({toks.shape[1]} tokens x {toks.shape[0]} rows)", lambda: stage2(toks, tl))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    try:
        from vocalie_tts_tpu_torch.ops import _build
    except ImportError as e:
        print(f"chip_smoke: the port's package is not importable here: {e}", file=sys.stderr)
        return 2
    for k, v in SLICE_ENV.items():
        os.environ[k] = v
    dev = torch.device("cuda:0")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")

    t0 = time.monotonic()
    lib = _build.build()
    log(f"kernels built in {time.monotonic() - t0:.1f} s -> {lib.name}")
    for line in _build.build_log().splitlines():
        if "registers" in line or "spill" in line or "rc " in line or "error" in line.lower():
            log("  " + line.strip())

    failures: list = []
    kernels = [check_decode_attention(dev, failures), check_cache_append(dev, failures),
               check_flash_attention(dev, failures)]
    if failures:
        raise SystemExit("kernel checks failed: " + "; ".join(failures))
    # the tiny model runs in f32 and is held against the CPU's f32
    # products, so TF32 is off for this phase only (cuDNN's default is on);
    # the main path runs with PyTorch's defaults, as a caller gets them
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    small_reference(dev, failures)
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    if failures:
        raise SystemExit("small-input reference failed: " + "; ".join(failures))
    counts = main_path(dev, failures)
    if failures:
        raise SystemExit("main path failed: " + "; ".join(failures))
    for entry, name in zip(kernels, ("decode_attention_stacked", "cache_append_stacked",
                                     "flash_attention")):
        entry["launches"] = counts[name]

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout.strip() \
        else f"nvidia-smi failed: {smi.stderr.strip()}"
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
