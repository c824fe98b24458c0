"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero before the final line is printed):

1. build the port's CUDA kernels from ``vocalie_tts_tpu_torch/csrc`` with
   nvcc for sm_90a (one nvcc per source, all started together);
2. for each kernel of the voice-over, streaming and studio paths -- B1
   int8 decode attention, B5 KV-cache append, B6 flash attention, the dense
   decode kernels B3 norm+qkv, B2 layer tail + next qkv, B4 int8 lm_head,
   B7, the whole decode step at batch 1 as one cooperative launch, B13,
   the fused GroupNorm of the AudioSR UNet and VAE, and the GPT-2 (XTTS)
   decode kernels B9a LayerNorm+qkv, B9b GELU layer tail + next qkv and B9c
   the tail alone, the unfused SwiGLU tail B8a and MLP B8b of the Qwen3
   path, and B12, the whole SwiGLU decode layer as one cooperative launch
   (``VOCALIE_MEGALAYER=1``; at the T3 and the Qwen3 layer, beside the B1 +
   B2 pair on the same inputs), and the kernels of the JAX package's no-env
   configurations: K1, the f32 decode attention over a bf16 cache
   (``VOCALIE_DECODE_KERNEL=1``; at the T3 and Qwen3 decode shapes and the
   Qwen3 batch-1 decode), K2, its int8-cache dequantizing branch, and B10,
   the single-layer decode attention (both on no served path; B10 on one
   T3 layer, bf16 and int8), against SDPA where one call computes the same
   attention, each timed eager and as a CUDA graph of its 300 calls
   replayed under CUDA events (``graph_ms``: the host taken out), and K4, the
   cache append without scales (at the T3 bf16 cache, against the slice
   assignment), and the training path's B6t (B6 writing the logsumexp),
   B11b (the flash backward's dQ, with di) and B11a (its dK/dV) at the T3
   fine-tune's [8, 16, 128, 64] and [8, 16, 512, 64] bf16 causal, GQA at d
   128 and a ragged non-causal [2, 4, 200, 64], against SDPA's forward and
   its backward alone under autograd, and slice 10's: B1w, the int8 decode
   attention with one softmax over the whole row (at the T3 cache of 600
   slots with and without the current token, and [28,8,8,520,128] at g 2;
   B1 on the same slots of a 640-slot cache timed beside it), B9d, the int8
   GELU MLP alone (the XTTS layer, f32 and bf16 rows, against the ``_qdot``
   ops), and K5, the one-array append without scales (one bf16
   [30,16,16,640,128] array at three positions, byte-exact) -- at the
   shapes the path gives it (B1-B6 also at the Qwen3 shapes:
   d_model 2048, 16 q / 8 kv heads of 128, d_ff 8192, b = 8; B6 at
   [8, 16, 512, 128] causal with 8 kv heads, and at the one-chunk batch-1
   prefill [1, 16, 512, 128]; B6 and B6t print their TFLOP/s: bf16 at d 64
   and 128 runs the tensor-core body): hold the kernel against its plain
   PyTorch version on the card, time kernel, plain version and (where one
   exists) the one PyTorch call that computes the same function
   (``F.group_norm`` + add + SiLU for B13; for B2-B4, B7 and B9 there is none; the ops the port runs otherwise for the same work
   are timed as a yardstick, and a child process counts the CUDA kernels
   one call issues with torch.profiler), and compute the least time the
   card could take (bytes over 3.35 TB/s or operations over the peak rate).
   Every kernel row and its yardstick is timed eager and as a CUDA graph of
   its calls (``timed``: ``cuda_ms`` and ``try_graph_ms``; a launch the
   capture refuses is logged and keeps its eager time), and K4 and K5 also
   print their wrapper's host µs a call. B2 and B8a (one cooperative launch
   on the int8 tensor cores, ``csrc/tail_swiglu.cu``) must be bit-equal to
   their plain versions at layers 0, L/2 and L - 1, B8a to B2's first
   output, and must issue one CUDA kernel a call; their launch plan is
   printed. B3 and B4 (one launch each, ``csrc/dense_int8.cu``) must be
   bit-equal to their plain versions and to the old three-kernel chain
   (``chain=True``) at layers 0 and L - 1, B4 also on a ``DENSE_FNS`` qkv
   shape, one CUDA kernel a call; the chain is timed beside them, with both
   wrappers' host µs, and every B3 and B4 launch of a main path must take
   the one launch (``tc_launches``). ``python3 chip_smoke.py --tail-rows``
   runs the dense rows, K4 and K5 alone, ``--dense-rows`` the B3 and B4 rows
   with each block's phase points (copied into an unpacked parent commit,
   each times that commit's kernels);
3. small-input references: the tiny-scale model on the GPU (kernels)
   against the same weights on the CPU (plain versions) -- teacher-forced
   decode logits and stage-2 PCM on shared noise; then a d_model-128
   transformer with the dense kernels on, the GPU kernels against the same
   GPU step through the dense kernels' plain versions, and against the CPU;
   then the tiny AudioSR (f32) ``enhance_audio`` on the GPU against the CPU;
   then a d_model-128 XTTS GPT-2 (B9a, B9b, B4) the same two ways, and its
   stage-2 PCM against the CPU's; then a d_model-256 Qwen3 LM (2 q heads, 1
   kv head of 128, qk-norm): a 512-position prefill (B6) GPU vs CPU, the
   dense decode with ``VOCALIE_MEGATAIL`` unset (B3 + B2) and 0 (B3 + B8a)
   the same two ways, its stage 2 GPU vs CPU; and a d_model-128 SwiGLU
   transformer with biases (B4 for the qkv and o-projections, B8b for the
   MLP: the dispatch no served family reaches) the same two ways; and with
   ``VOCALIE_MEGALAYER=1`` (B3 + L x B12 + B4 a step) the d_model-128 model
   (d_head 64) and the Qwen3 d_model-256 LM (d_head 128, GQA) the same two
   ways; and the no-env rows (bf16 weights; the tiny T3 and the Qwen3
   d_model-256 LM, f32 caches) built with no env (the XLA attention branch,
   slice assignment) and with ``VOCALIE_DECODE_KERNEL=1`` (K1 + K4), GPU vs
   CPU, and the no-env T3's stage 2; and two ``use_flash=True`` train steps
   of the tiny T3 train view (f32), GPU kernels against the CPU's plain
   versions: losses and each leaf's gradient; the tiny T3 also at
   ``cache_len`` 200 (B1w in place of B1), and a d_model-128 GELU MLP with
   biases under RMSNorm (B4 + B9d) GPU vs GPU plain and vs CPU, where every
   logit row outside the CPU's gate must trace to a tie: the first int8
   activation (or bf16 cache scale) of that row on which a GPU run through
   every plain version and the CPU run round apart lies within a few ulps
   of its tie on both;
4. the main path: ``run_tts_pipeline`` at the full Chatterbox T3 width
   (random weights from a seed), in the JAX package's default int8 serving
   configuration (``VOCALIE_KV_INT8=1 VOCALIE_WEIGHT_INT8=1``, the dense
   kernels on) for the 8-chunk bench script and for a request whose chunk
   takes the 512 prompt bucket (causal flash attention in prefill); then
   the slice-1 configuration (``VOCALIE_DENSE_KERNEL=0``) on the bench
   script, and the default config with ``VOCALIE_MEGALAYER=1`` on the bench
   script (B3 + 30 x B12 a step, B1 = B2 = 0; timed once more after its
   counted run), and the JAX package's no-env configurations on the bench
   script, each timed twice: no env (a bf16 cache and bf16 weights, the XLA
   attention branch in plain PyTorch: no kernel on the decode step),
   ``VOCALIE_DECODE_KERNEL=1`` (30 x K1 + K4 a step) and
   ``VOCALIE_WEIGHT_INT8=1`` alone (B3 + 30 x B2 + K4 + B4). Every WAV is checked; each path's launch counters are set
   to 0
   just before it and read just after, must have moved, and must fit the
   path (B2 = 30 x decode steps, B3 = decode steps, B4 = decode steps +
   prefills; on every path the tensor-core body's launches equal B6's and
   B6t's); audio seconds, wall seconds, the real-time factor and
   ms/step are printed; then the CosyVoice-class paths at full width
   (random weights from a seed), each driven with the counters at 0 just
   before it: the streaming request of ``scripts/bench_streaming.py``
   (``CosyVoiceEngine.synthesize_stream``, instruct mode, sampled from the
   runtime's seeded generator; B3 + B7 + B5 + B4 every step, B1 = B2 = 0),
   the same request with ``VOCALIE_FUSED_STEP=0`` (B3 + 24 x (B1 + B2)),
   and ``run_tts_pipeline`` with ``tts_backend: "cosyvoice"`` on the
   8-chunk bench script (b = 8: B1-B6), also with ``VOCALIE_MEGALAYER=1``
   (24 x B12 a step), and the streaming request in the no-env configuration
   (its own runtime; no kernel on the decode step, B7 = 0); first-packet ms,
   sustained RTF,
   windows and decode ms/step are printed; then the AudioSR studio pass at
   full width (random weights from a seed; bf16, int8 UNet convs, device
   stitch): ``AudioSRRuntime.enhance_file`` on the Chatterbox bench
   request's WAV at bench.py's settings (100 DDIM steps, guidance 2.5, seed
   42, chunk 32768, overlap 1024), with ``VOCALIE_GN_PALLAS=1`` (B13 =
   dispatches x (41 x steps + the VAE's 42 norms)) and with the knob unset
   (B13 = 0); studio wall, studio RTF and bench.py's headline (VO audio s
   / (VO wall + studio wall)) are printed for both; then the XTTS-class
   voice clone at full width (random weights from a seed):
   ``run_tts_pipeline`` with ``tts_backend: "xtts"`` and a 3 s reference on
   ``scripts/bench_engine.py``'s 8-chunk request in the default config (B9a
   + 24 x (B1 + B9b) + B5 + B4 a step), with ``VOCALIE_MEGATAIL=0`` (24 x
   (B9a + B1 + B9c)), and one long chunk at batch 1 (544 prompt bucket:
   causal B6 in prefill; B7 never); RTF, wall and decode ms/step each;
   then the Qwen3-class LLM-TTS at full width (1.7B, random weights from a
   seed): ``run_tts_pipeline`` with ``tts_backend: "qwen3"`` on
   ``scripts/bench_engine.py``'s 8-chunk request (its 3 s reference makes it
   voice_clone) in the default config (B3 + 28 x (B1 + B2) + B5 + B4 a
   step) and with ``VOCALIE_MEGATAIL=0`` (28 x (B3 + B1 + B8a)), an explicit
   voice_clone with a transcript, one chunk of > 509 bytes at batch 1 in
   custom_voice (the 512 bucket: 28 B6 in prefill; B7 never) and a
   voice_design chunk, then the bench request and the batch-1 chunk with
   ``VOCALIE_MEGALAYER=1`` (B3 + 28 x B12 a step), and the batch-1 chunk with
   ``VOCALIE_DECODE_KERNEL=1`` on a bf16-weight runtime of its own (28 x K1 +
   K4 a step, d_head 128, group 2); RTF, wall and decode ms/step each;
   then the T3 fine-tune trainer at full width (bf16, 506 M parameters):
   a force-init runtime's ``save_weights``, ``finetune_overlay`` (8 steps,
   batch 8, seq_len 128; the XLA attention as in JAX: B6t = B11a = B11b =
   0), its overlay served in ``fr_finetune`` mode by a fresh runtime in the
   default int8 env (WAV check), and ``make_train_step`` with
   ``use_flash=True`` (30 x (B6t + B11b + B11a) a step) and without, from
   one state and batch at seq_len 128 and 512: losses within 1e-2 of each
   other, each leaf's gradient difference, ms per step, tokens/s, peak
   memory and the FLOP bound; and slice 10's rows: (a) the T3 LM at full
   width in the default int8 config, batch 16, ``prefill`` at the 512
   bucket with ``cache_len`` 600 (a length no runtime makes) and 80 greedy
   steps through ``generate_tokens`` (B1w = 30 x steps, B1 = B12 = B7 = 0),
   against the same loop at ``cache_len`` 640 (B1 = 30 x steps); (b) the
   XTTS GPT widths with RMSNorm (a GELU MLP with biases under RMSNorm, int8
   weights and cache), batch 8, a 544-bucket prompt and 64 steps (B9d = 24
   x steps, B4 for qkv, o and the head, B1, B5); every earlier path holds
   B1w = B9d = K5 = 0;
   To keep the run's time, each runtime is warmed up by its first request
   only, and three Qwen3 requests of earlier slices (the voice clone with a
   transcript, voice design, the batch-1 chunk with ``VOCALIE_MEGALAYER=1``)
   are timed once, without their decode alone; every launch count and WAV
   is still checked;
5. torch.profiler, only now, so that nothing above is timed in a process
   where it has been on: short windows of each configuration show where
   the time goes, the studio pass's one UNet call and the XTTS and Qwen3
   decode windows included, the Chatterbox and Qwen3 bench requests with
   ``VOCALIE_MEGALAYER=1`` beside their default config, slice 10's two
   rows (prefill alone and prefill + 16 steps, at 600 and 640 slots), and
   one flash train step at 8 x 128 and at 8 x 512.

The second-to-last lines are a JSON ``kernels`` line and the card's name
and power limit; the last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import inspect
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

import torch

PEAK_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
PEAK_BF16_FLOPS = 989e12        # H100 SXM dense bf16 tensor rate
PEAK_INT8_OPS = 1979e12
NEG = -0.7 * float(torch.finfo(torch.float32).max)

#: the JAX package's default int8 serving configuration (bench.py's env)
DEFAULT_ENV = {"VOCALIE_KV_INT8": "1", "VOCALIE_WEIGHT_INT8": "1"}
#: slice 1's configuration: the dense decode kernels off
SLICE1_ENV = {**DEFAULT_ENV, "VOCALIE_DENSE_KERNEL": "0"}
#: the whole decode layer as one launch (B12), on every SwiGLU family
MEGALAYER_ENV = {**DEFAULT_ENV, "VOCALIE_MEGALAYER": "1"}
#: the JAX package's configuration with no env set (``docs/ENV_POLICY.md``):
#: a bf16 cache, bf16 weights, the XLA decode-attention branch (plain
#: PyTorch), the cache appended by slice assignment
NOENV_ENV: dict = {}
#: ``VOCALIE_DECODE_KERNEL=1`` ("1 forces") on that bf16 cache: K1 + K4
DECODE_KERNEL_ENV = {"VOCALIE_DECODE_KERNEL": "1"}
#: int8 weights alone: the dense kernels over the bf16 cache (XLA
#: attention; the append through K4)
WEIGHT_INT8_ENV = {"VOCALIE_WEIGHT_INT8": "1"}
#: knobs that change the decode path; cleared before each configuration
PATH_KNOBS = ("VOCALIE_KV_INT8", "VOCALIE_WEIGHT_INT8", "VOCALIE_DENSE_KERNEL",
              "VOCALIE_DECODE_KERNEL", "VOCALIE_MEGATAIL", "VOCALIE_MEGALAYER",
              "VOCALIE_FUSED_STEP")


def set_env(env: dict) -> None:
    for k in PATH_KNOBS:
        os.environ.pop(k, None)
    os.environ.update(env)


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


_T0 = time.monotonic()


def log(msg: str) -> None:
    """A line of the run's log, after the seconds since the script started."""
    print(f"[{time.monotonic() - _T0:7.1f} s] {msg}", flush=True)


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


def graph_ms(fn, iters: int = 300, replays: int = 3) -> float:
    """Mean device time of ``fn(i)`` for ``i < iters``, the calls captured
    once in a CUDA graph and replayed ``replays`` times under CUDA events:
    the host's issue rate taken out of a kernel of a few microseconds."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):   # warm-up off the capture, as PyTorch asks
        for i in range(3):
            fn(i)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            fn(i)
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (iters * replays)
    del graph
    return ms


def try_graph_ms(fn, label: str, iters: int = 300):
    """``graph_ms(fn, iters)``, or None where the calls cannot be captured in
    a CUDA graph (the reason is logged; the row keeps its eager time)."""
    try:
        return graph_ms(fn, iters)
    except Exception as e:   # a launch the capture refuses
        torch.cuda.set_stream(torch.cuda.default_stream())
        torch.cuda.synchronize()
        log(f"{label}: not graph-timed (the capture failed: {str(e).splitlines()[0][:200]})")
        return None


def timed(fn, iters: int, label: str, graph_iters: int = 300) -> tuple:
    """``fn(i)``'s eager ms (``cuda_ms``) and graph ms (``try_graph_ms``)."""
    return cuda_ms(fn, iters), try_graph_ms(fn, label, graph_iters)


def fmt_ms(ms) -> str:
    return "not measured" if ms is None else f"{ms:.6f}"


def bound_ms(n_bytes: float, n_ops: float, peak_ops: float):
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_ops / peak_ops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ── phase 2: kernels against their plain versions ───────────────────────


#: B1's and B5's decode shapes: the Chatterbox voice-over (b = 16: 8
#: chunks, CFG-doubled; 16 kv heads of 64; 30 layers; cache 640 = 256 + 320
#: buckets) and the Qwen3 bench request (b = 8; 8 kv heads of 128 for 16 q
#: heads; 28 layers; cache 512 = 256 + 192 buckets, rounded), mid-decode
T3_ATTN = dict(L=30, b=16, kv=16, g=1, d=64, T=640, prompt_pad=256, n_dec=160, seed=1)
QWEN3_ATTN = dict(L=28, b=8, kv=8, g=2, d=128, T=512, prompt_pad=256, n_dec=96, seed=11)
#: the Qwen3 batch-1 chunk's decode (``VOCALIE_DECODE_KERNEL=1`` serves it
#: through K1): 8 (row, kv head) pairs
QWEN3_B1_ATTN = {**QWEN3_ATTN, "b": 1}


B1_NAME = "B1 decode_attention_int8"


def _b1_inputs(dev, *, L, b, kv, g, d, T, prompt_pad, n_dec, seed, bias_fn=None, valid_len=None,
               **_):
    """B1's inputs from a seed: unit-scale q and current token, int8 k/v,
    bf16 scales near 1/127, each row's prompt (a random length of the
    ``prompt_pad`` bucket) and the decoded slots unmasked; or, with
    ``bias_fn``, the first ``valid_len`` slots biased by ``bias_fn(pos)``."""
    import types

    valid_len = valid_len or prompt_pad + n_dec
    gen = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((b, kv, g, d), generator=gen, device=dev)
    k = torch.randint(-127, 128, (L, b, kv, T, d), generator=gen, device=dev, dtype=torch.int8)
    v = torch.randint(-127, 128, (L, b, kv, T, d), generator=gen, device=dev, dtype=torch.int8)
    ks = ((torch.rand((L, b, kv, T), generator=gen, device=dev) + 0.5) / 127).to(torch.bfloat16)
    vs = ((torch.rand((L, b, kv, T), generator=gen, device=dev) + 0.5) / 127).to(torch.bfloat16)
    kn = torch.randn((b, kv, d), generator=gen, device=dev)
    vn = torch.randn((b, kv, d), generator=gen, device=dev)
    pos = torch.arange(T, device=dev)[None, :]
    if bias_fn is None:
        lens = torch.randint(1, prompt_pad + 1, (b,), generator=gen, device=dev)
        valid = (pos < lens[:, None]) | ((pos >= prompt_pad) & (pos < valid_len))
        bias = torch.where(valid, 0.0, NEG).float()
    else:
        posf = pos.float().expand(b, T)
        bias = torch.where(posf < valid_len, bias_fn(posf), torch.full_like(posf, NEG))
    bias = bias.contiguous()
    sm = 1.0 / math.sqrt(d)
    return types.SimpleNamespace(**locals())


def _b1_splits(t) -> int | None:
    """The split B1 takes for these inputs on the card (None for a tree
    whose B1 does not split)."""
    from vocalie_tts_tpu_torch.ops import decode_attention as da

    plan = getattr(da, "card_int8_splits", None)
    return plan(t.b * t.kv, da.n_valid_blocks(t.valid_len, t.T), t.g, t.d) if plan else None


def _b1_case(dev, failures, *, L, b, kv, g, d, T, prompt_pad, n_dec, seed, label):
    from vocalie_tts_tpu_torch.ops.decode_attention import (
        decode_attention_int8_stacked,
        decode_attention_plain,
    )

    t = _b1_inputs(dev, L=L, b=b, kv=kv, g=g, d=d, T=T, prompt_pad=prompt_pad, n_dec=n_dec,
                   seed=seed)
    valid_len, sm, layer = t.valid_len, t.sm, 7
    q, k, v, bias, ks, vs, kn, vn = t.q, t.k, t.v, t.bias, t.ks, t.vs, t.kn, t.vn
    out = decode_attention_int8_stacked(q, k, v, bias, layer, ks, vs, kn, vn,
                                        valid_len=valid_len, sm_scale=sm)
    ref = decode_attention_plain(q, k, v, bias, layer, ks, vs, kn, vn, valid_len, sm)
    torch.cuda.synchronize()
    err = (out - ref).abs().max().item()
    # outputs are ~0.04; one p rounded one int8 step the other way (exp /
    # sum order) moves an output by ~1e-4, while a p block other than 128
    # slots moves it by > 2e-3 (tests/test_torch_decode_attention.py)
    tol = 5e-4
    # each call reads another layer, as the decode step does (the whole
    # cache, 0.3-0.6 GB, is far larger than the 50 MB L2)
    ms, g_ms = timed(lambda i: decode_attention_int8_stacked(
        q, k, v, bias, i % L, ks, vs, kn, vn, valid_len=valid_len, sm_scale=sm), 300,
        f"B1 [{label}]")
    plain_ms = cuda_ms(lambda i: decode_attention_plain(
        q, k, v, bias, i % L, ks, vs, kn, vn, valid_len, sm), 20)
    n_bytes = (valid_len * b * kv * (2 * d + 2 * 2) + valid_len * b * 4
               + b * kv * d * 4 * 2 + 2 * b * kv * g * d * 4)
    n_ops = 2 * 2 * valid_len * b * kv * g * d
    bms, by = bound_ms(n_bytes, n_ops, PEAK_INT8_OPS)
    splits = _b1_splits(t)
    log(f"B1 decode_attention [{label}]: max_abs_err={err:.3e} (tolerance {tol}: a few int8 "
        f"steps of p rounded the other way; a wrong p block size is > 2e-3); {splits} block(s) a "
        f"(row, kv head); kernel {ms:.6f} ms eager, {fmt_ms(g_ms)} ms graph, plain "
        f"{plain_ms:.6f} ms, bound {bms:.6f} ms ({by})")
    if not err <= tol:
        failures.append(f"B1 [{label}] max_abs_err {err} > {tol}")
    return {"max_abs_err": err, "tolerance": tol, "ms": ms, "graph_ms": g_ms, "plain_ms": plain_ms,
            "bound_ms": bms, "bound_by": by, "library_ms": None, "splits": splits,
            "shape": f"{label}: q[{b},{kv},{g},{d}] cache[{L},{b},{kv},{T},{d}] int8 "
                     f"valid_len={valid_len}"}


#: B1's adversarial cases, each at the T3 and the Qwen3 head widths (2 rows
#: x 2 kv heads, a cache of 640): scores that rise over the cache (every
#: block's running max below the final one), a block 60 below the running
#: max (its p under 1e-26: ps takes its 1e-20 floor), valid lengths just
#: below, on and past a 128-slot boundary and at the cache's end, a single
#: valid block
B1_ADVERSARIAL = (
    ("rising scores", dict(valid_len=600, bias_fn=lambda pos: 0.02 * pos)),
    ("one block 60 below the running max",
     dict(valid_len=600, bias_fn=lambda pos: torch.where((pos >= 128) & (pos < 256), -60.0,
                                                         0.0))),
    ("valid_len 127", dict(valid_len=127, bias_fn=torch.zeros_like)),
    ("valid_len 128", dict(valid_len=128, bias_fn=torch.zeros_like)),
    ("valid_len 129", dict(valid_len=129, bias_fn=torch.zeros_like)),
    ("valid_len 640, the cache's end", dict(valid_len=640, bias_fn=torch.zeros_like)),
    ("a single valid slot", dict(valid_len=1, bias_fn=torch.zeros_like)),
)


def _b1_adversarial(dev, failures) -> list:
    """B1 against its plain version at each ``B1_ADVERSARIAL`` case (atol
    5e-4, as the main shapes), at g 1 d 64 and g 2 d 128."""
    from vocalie_tts_tpu_torch.ops.decode_attention import (
        decode_attention_int8_stacked,
        decode_attention_plain,
    )

    out = []
    for width, (g, d) in (("T3 heads", (1, 64)), ("Qwen3 heads", (2, 128))):
        for i, (label, kw) in enumerate(B1_ADVERSARIAL):
            t = _b1_inputs(dev, L=2, b=2, kv=2, g=g, d=d, T=640, prompt_pad=0, n_dec=0,
                           seed=40 + i, **kw)
            args = (t.q, t.k, t.v, t.bias, 1, t.ks, t.vs, t.kn, t.vn)
            got = decode_attention_int8_stacked(*args, valid_len=t.valid_len, sm_scale=t.sm)
            ref = decode_attention_plain(*args, t.valid_len, t.sm)
            torch.cuda.synchronize()
            err = (got - ref).abs().max().item()
            if not err <= 5e-4:
                failures.append(f"B1 [{label}, {width}] max_abs_err {err} > 5e-4")
            out.append({"label": f"{label}, {width}", "max_abs_err": err,
                        "splits": _b1_splits(t)})
    log("B1 adversarial cases (atol 5e-4): " + "; ".join(
        f"{r['label']} {r['max_abs_err']:.3e} ({r['splits']} split(s))" for r in out))
    return out


def check_decode_attention(dev, failures):
    main = _b1_case(dev, failures, **T3_ATTN, label="voice-over")
    return {"name": B1_NAME, "route": "cuda",
            "source": "vocalie_tts_tpu_torch/csrc/decode_attention.cu",
            "replaces": "vocalie_tts_tpu/ops/decode_attention.py:565", **main,
            "cuda_kernels_per_call": None,
            "qwen3_shape": _b1_case(dev, failures, **QWEN3_ATTN, label="qwen3"),
            "adversarial": _b1_adversarial(dev, failures)}


def _b5_case(dev, failures, *, L, b, kv, d, T, pos, seed, label):
    from vocalie_tts_tpu_torch.ops.cache_update import cache_append_plain, cache_append_stacked

    gen = torch.Generator(device=dev).manual_seed(seed)
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
    ms, g_ms = timed(lambda i: cache_append_stacked(k, v, ks, vs, kn, vn, ksn, vsn, i % T), 300,
                     f"B5 [{label}]")
    plain_ms = cuda_ms(lambda i: cache_append_plain(k, v, ks, vs, kn, vn, ksn, vsn, i % T), 100)
    rows = L * b * kv
    bms, by = bound_ms(2 * rows * (2 * d + 2 * 2), 0, PEAK_INT8_OPS)
    log(f"B5 cache_append [{label}]: byte-exact={exact} (tolerance: byte-exact); kernel "
        f"{ms:.6f} ms eager, {fmt_ms(g_ms)} ms graph, plain {plain_ms:.6f} ms, bound {bms:.6f} ms "
        f"({by})")
    if not exact:
        failures.append(f"B5 [{label}] differs from its plain version")
    return {"max_abs_err": err, "tolerance": 0.0, "ms": ms, "graph_ms": g_ms, "plain_ms": plain_ms,
            "bound_ms": bms, "bound_by": by, "library_ms": None,
            "shape": f"{label}: new[{L},{b},{kv},{d}] int8 into cache[{L},{b},{kv},{T},{d}]"}


def check_cache_append(dev, failures):
    main = _b5_case(dev, failures, L=30, b=16, kv=16, d=64, T=640, pos=416, seed=2,
                    label="voice-over")
    return {"name": "B5 cache_append", "route": "cuda",
            "source": "vocalie_tts_tpu_torch/csrc/cache_update.cu",
            "replaces": "vocalie_tts_tpu/ops/cache_update.py:84", **main,
            "qwen3_shape": _b5_case(dev, failures, L=28, b=8, kv=8, d=128, T=512, pos=352,
                                    seed=12, label="qwen3")}


# ── K1, K2, B10: the f32 decode attention; K4: the append without scales ─

K1_NAME = "K1 decode_attention_float (bf16 cache)"
K2_NAME = "K2 decode_attention_dequant (int8 cache, f32)"
B10_NAME = "B10 decode_attention (one layer)"
K4_NAME = "K4 cache_append_kv (no scales)"
#: K1-K3 against their plain versions: f32 throughout; the kernel's running
#: max over 128-slot chunks and its summation order differ from the
#: two-pass plain version (tests/test_decode_attention.py:50's bound)
F32_ATTN_TOL = 1e-4


def _f32_attn_inputs(dev, attn, cache):
    """B1's decode shapes (``attn``) with a ``cache`` (bf16, or int8 with
    bf16 scales) from a seed: q, k, v, ks, vs, bias, kn, vn, valid_len."""
    import types

    L, b, kv, g, d, T = (attn[k] for k in ("L", "b", "kv", "g", "d", "T"))
    valid_len = attn["prompt_pad"] + attn["n_dec"]
    gen = torch.Generator(device=dev).manual_seed(attn["seed"] + 200)
    q = torch.randn((b, kv, g, d), generator=gen, device=dev)
    if cache == torch.int8:
        k, v = (torch.randint(-127, 128, (L, b, kv, T, d), generator=gen, device=dev,
                              dtype=torch.int8) for _ in range(2))
        ks, vs = (((torch.rand((L, b, kv, T), generator=gen, device=dev) + 0.5) / 127)
                  .to(torch.bfloat16) for _ in range(2))
    else:
        k, v = (torch.randn((L, b, kv, T, d), generator=gen, device=dev).to(cache)
                for _ in range(2))
        ks = vs = None
    kn, vn = (torch.randn((b, kv, d), generator=gen, device=dev) for _ in range(2))
    lens = torch.randint(1, attn["prompt_pad"] + 1, (b,), generator=gen, device=dev)
    pos = torch.arange(T, device=dev)[None, :]
    bias = torch.where((pos < lens[:, None]) | ((pos >= attn["prompt_pad"]) & (pos < valid_len)),
                       0.0, NEG).float()
    return types.SimpleNamespace(L=L, b=b, kv=kv, g=g, d=d, T=T, q=q, k=k, v=v, ks=ks, vs=vs,
                                 kn=kn, vn=vn, bias=bias, valid=valid_len, sm=d ** -0.5)


def _sdpa_ms(t, layers, with_new: bool) -> tuple:
    """``F.scaled_dot_product_attention`` over the bf16 cache's valid slots
    with the current token's k/v appended (``with_new``) or over every slot,
    the bias as its mask: the one PyTorch call for the same attention
    (prepared per layer outside the timed call; its own bf16 kernel).
    Returns its eager and its graph-timed ms."""
    import torch.nn.functional as F

    n = t.valid if with_new else t.T
    bf = torch.bfloat16
    q = t.q.reshape(t.b, t.kv * t.g, 1, t.d).to(bf)
    prepared = []
    for layer in layers:
        k, v = t.k[layer][:, :, :n].to(bf), t.v[layer][:, :, :n].to(bf)
        mask = t.bias[:, :n]
        if with_new:
            k = torch.cat([k, t.kn[:, :, None].to(bf)], 2)
            v = torch.cat([v, t.vn[:, :, None].to(bf)], 2)
            mask = torch.cat([mask, torch.zeros_like(mask[:, :1])], 1)
        prepared.append((k, v, mask[:, None, None].to(bf)))
    call = lambda i: F.scaled_dot_product_attention(  # noqa: E731
        q, prepared[i % len(prepared)][0], prepared[i % len(prepared)][1],
        attn_mask=prepared[i % len(prepared)][2], enable_gqa=t.g > 1)
    return cuda_ms(call, 300), graph_ms(call)


def _attn_bytes(t, n, elem, scales: bool, with_new: bool) -> int:
    """Each input read once, each output written once; of the cache, the
    ``n`` slots read (a masked slot's probability is exactly 0)."""
    cache = n * t.b * t.kv * (2 * t.d * elem + (4 if scales else 0)) + n * t.b * 4
    return cache + 4 * t.b * t.kv * t.g * t.d * 2 + (8 * t.b * t.kv * t.d if with_new else 0)


def _k1_k2_case(dev, failures, attn, cache, label):
    """K1 (bf16 cache) or K2 (int8 cache dequantized) at one of B1's decode
    shapes, each timed call reading another layer, as the decode step."""
    from vocalie_tts_tpu_torch.ops import decode_attention as da

    t = _f32_attn_inputs(dev, attn, cache)
    quant = cache == torch.int8
    fn = da.decode_attention_dequant_stacked if quant else da.decode_attention_float_stacked
    plain = da.decode_attention_dequant_plain if quant else da.decode_attention_float_plain
    scales = (t.ks, t.vs) if quant else ()
    call = lambda l: fn(t.q, t.k, t.v, t.bias, l, *scales, t.kn, t.vn,  # noqa: E731
                        valid_len=t.valid, sm_scale=t.sm)
    out = call(7)
    ref = plain(t.q, t.k, t.v, t.bias, 7, *scales, t.kn, t.vn, t.valid, sm_scale=t.sm)
    torch.cuda.synchronize()
    err = (out - ref).abs().max().item()
    ms = cuda_ms(lambda i: call(i % t.L), 300)
    g_ms = graph_ms(lambda i: call(i % t.L))
    plain_ms = cuda_ms(lambda i: plain(t.q, t.k, t.v, t.bias, i % t.L, *scales, t.kn, t.vn,
                                       t.valid, sm_scale=t.sm), 20)
    lib_ms, lib_graph_ms = (None, None) if quant else _sdpa_ms(t, range(8), with_new=True)
    n_bytes = _attn_bytes(t, t.valid, 1 if quant else 2, quant, True)
    n_ops = 2 * 2 * t.valid * t.b * t.kv * t.g * t.d
    bms, by = bound_ms(n_bytes, n_ops, PEAK_INT8_OPS if quant else PEAK_BF16_FLOPS)
    shape = (f"{label}: q[{t.b},{t.kv},{t.g},{t.d}] cache[{t.L},{t.b},{t.kv},{t.T},{t.d}] "
             f"{str(cache).removeprefix('torch.')} valid_len={t.valid}")
    return _f32_row(failures, K2_NAME if quant else K1_NAME, label, err, ms, g_ms, plain_ms,
                    lib_ms, lib_graph_ms, "SDPA over the valid slots + the current token",
                    n_bytes, bms, by, _splits(t, "dequant" if quant else "plain", t.valid),
                    shape)


def _splits(t, mode, n_slots):
    """The blocks per (row, kv head) the kernel's split takes, and how many
    clusters of that size the card keeps resident (None for a tree without
    the split)."""
    from vocalie_tts_tpu_torch.ops import decode_attention as da

    if not hasattr(da, "f32_splits"):
        return None
    s = da.f32_splits(t.k, t.ks, mode, t.b, t.kv, t.g, n_slots)
    resident = da.resident_clusters(*da.f32_codes(t.k, t.ks, mode, t.g), s) if s > 1 else None
    return {"splits": s, "resident_clusters": resident, "clusters": t.b * t.kv}


def _f32_row(failures, name, label, err, ms, g_ms, plain_ms, lib_ms, lib_graph_ms, lib_what,
             n_bytes, bms, by, splits, shape) -> dict:
    """Log one K1/K2/B10 row, gate its error, and return its dict: eager
    and graph-timed ms, GB/s on the graph time against 3.35 TB/s, SDPA's
    eager and graph ms where it computes the same attention."""
    gbs = n_bytes / (g_ms * 1e-3) / 1e9
    log(f"{name} [{label}]: max_abs_err={err:.3e} (tolerance {F32_ATTN_TOL}); kernel {ms:.6f} "
        f"ms eager, {g_ms:.6f} ms graph ({gbs:.1f} GB/s, {gbs / PEAK_BYTES_PER_S * 1e9:.1%} of "
        f"3.35 TB/s), plain {plain_ms:.6f} ms, "
        + ("" if lib_ms is None else f"{lib_what} {lib_ms:.6f} ms eager, {lib_graph_ms:.6f} ms "
                                     f"graph (kernel / SDPA graph {g_ms / lib_graph_ms:.3f}), ")
        + f"bound {bms:.6f} ms ({by}); splits {splits}; {shape}")
    if not err <= F32_ATTN_TOL:
        failures.append(f"{name.split()[0]} [{label}] max_abs_err {err} > {F32_ATTN_TOL}")
    return {"max_abs_err": err, "tolerance": F32_ATTN_TOL, "ms": ms, "graph_ms": g_ms,
            "gb_per_s_graph": gbs, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
            "library_ms": lib_ms, "library_graph_ms": lib_graph_ms, "splits": splits,
            "shape": shape}


def _b10_case(dev, failures, cache, label):
    """B10 on one T3 layer (no current token: every slot read), the bf16
    cache or the int8 cache with its bf16 scales; eight copies of the layer
    are cycled so that no timed call finds it in the 50 MB L2."""
    from vocalie_tts_tpu_torch.ops import decode_attention as da

    t = _f32_attn_inputs(dev, {**T3_ATTN, "L": 8}, cache)
    quant = cache == torch.int8
    scales = lambda l: (t.ks[l], t.vs[l]) if quant else (None, None)   # noqa: E731
    call = lambda l: da.decode_attention(t.q, t.k[l], t.v[l], t.bias, *scales(l),  # noqa: E731
                                         sm_scale=t.sm)
    out = call(3)
    ref = da.decode_attention_plain_b10(t.q, t.k[3], t.v[3], t.bias, *scales(3), sm_scale=t.sm)
    torch.cuda.synchronize()
    err = (out - ref).abs().max().item()
    ms = cuda_ms(lambda i: call(i % t.L), 300)
    g_ms = graph_ms(lambda i: call(i % t.L))
    plain_ms = cuda_ms(lambda i: da.decode_attention_plain_b10(
        t.q, t.k[i % t.L], t.v[i % t.L], t.bias, *scales(i % t.L), sm_scale=t.sm), 20)
    lib_ms, lib_graph_ms = (None, None) if quant else _sdpa_ms(t, range(t.L), with_new=False)
    n_bytes = _attn_bytes(t, t.T, 1 if quant else 2, quant, False)
    bms, by = bound_ms(n_bytes, 2 * 2 * t.T * t.b * t.kv * t.g * t.d,
                       PEAK_INT8_OPS if quant else PEAK_BF16_FLOPS)
    shape = (f"{label}: q[{t.b},{t.kv},{t.g},{t.d}] one layer [{t.b},{t.kv},{t.T},{t.d}] "
             f"{str(cache).removeprefix('torch.')}, every slot")
    return _f32_row(failures, B10_NAME, label, err, ms, g_ms, plain_ms, lib_ms, lib_graph_ms,
                    "SDPA over the layer", n_bytes, bms, by,
                    _splits(t, "b10" if quant else "plain", t.T), shape)


def _entry(name, source, replaces, main, **extra):
    """A ``kernels`` entry from a case's dict."""
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces, **main,
            "cuda_kernels_per_call": None, **extra}


def check_f32_attention(dev, failures):
    """K1 at the T3 and Qwen3 decode shapes and the Qwen3 batch-1 decode
    (bf16 caches), K2 at the T3 int8 shape, B10 on one T3 layer, bf16 and
    int8 → their ``kernels`` entries; each timed eager and as a CUDA graph."""
    src = "vocalie_tts_tpu_torch/csrc/decode_attention.cu"
    k1 = _k1_k2_case(dev, failures, T3_ATTN, torch.bfloat16, "voice-over")
    k1_q3 = _k1_k2_case(dev, failures, QWEN3_ATTN, torch.bfloat16, "qwen3")
    k1_q3b1 = _k1_k2_case(dev, failures, QWEN3_B1_ATTN, torch.bfloat16, "qwen3 batch 1")
    k2 = _k1_k2_case(dev, failures, T3_ATTN, torch.int8, "voice-over")
    b10 = _b10_case(dev, failures, torch.bfloat16, "T3 layer, bf16")
    b10_i8 = _b10_case(dev, failures, torch.int8, "T3 layer, int8")
    return [
        _entry(K1_NAME, src, "vocalie_tts_tpu/ops/decode_attention.py:554", k1,
               qwen3_shape=k1_q3, qwen3_batch1_shape=k1_q3b1,
               library_call="F.scaled_dot_product_attention (bf16) over the valid slots and the "
                            "current token"),
        _entry(K2_NAME, src, "vocalie_tts_tpu/ops/decode_attention.py:530", k2,
               launches_path="no served path: JAX's decode_step passes int8_dots with the int8 "
                             "cache (its tests reach this branch); launches counted on the "
                             "Chatterbox default path, every phase-4 path held to 0",
               library_call="none (no PyTorch call attends over an int8 cache with scales)"),
        _entry(B10_NAME, src, "vocalie_tts_tpu/ops/decode_attention.py:85", b10,
               int8_shape=b10_i8,
               launches_path="no served path: only JAX's tests call decode_attention; launches "
                             "counted on the Chatterbox default path, every phase-4 path held "
                             "to 0",
               library_call="F.scaled_dot_product_attention (bf16) over the layer"),
    ]


def check_cache_append_kv(dev, failures):
    """K4 at the T3 bf16 cache ([30,16,16,640,64]) against its plain version
    (byte-equal); the library yardstick is the slice assignment of k and v
    (``k_all[:, :, :, pos] = k_new``, which the plain version also is)."""
    from vocalie_tts_tpu_torch.ops.cache_update import cache_append_kv_plain, cache_append_kv_stacked

    L, b, kv, d, T, pos = 30, 16, 16, 64, 640, 416
    gen = torch.Generator(device=dev).manual_seed(14)
    k, v = (torch.randn((L, b, kv, T, d), generator=gen, device=dev).to(torch.bfloat16)
            for _ in range(2))
    kn, vn = (torch.randn((L, b, kv, d), generator=gen, device=dev).to(torch.bfloat16)
              for _ in range(2))
    got = cache_append_kv_stacked(k.clone(), v.clone(), kn, vn, pos)
    ref = cache_append_kv_plain(k.clone(), v.clone(), kn, vn, pos)
    torch.cuda.synchronize()
    exact = all(torch.equal(a.view(torch.int16), r.view(torch.int16)) for a, r in zip(got, ref))
    ms, g_ms = timed(lambda i: cache_append_kv_stacked(k, v, kn, vn, i % T), 300, "K4")
    plain_ms = cuda_ms(lambda i: cache_append_kv_plain(k, v, kn, vn, i % T), 100)

    def assign(i):
        k[:, :, :, i % T] = kn
        v[:, :, :, i % T] = vn

    lib_ms, lib_g_ms = timed(assign, 100, "K4's slice assignment")
    rows = L * b * kv
    bms, by = bound_ms(2 * 2 * rows * d * 2, 0, PEAK_BF16_FLOPS)
    main = _append_row(K4_NAME, exact, ms, g_ms, plain_ms, lib_ms, lib_g_ms, bms, by,
                       "slice assignment of k and v", _host_us(lambda i: cache_append_kv_stacked(
                           k, v, kn, vn, i % T)), failures)
    main["shape"] = f"new[{L},{b},{kv},{d}] bf16 into cache[{L},{b},{kv},{T},{d}]"
    return _entry(K4_NAME, "vocalie_tts_tpu_torch/csrc/cache_update.cu",
                  "vocalie_tts_tpu/ops/cache_update.py:191", main,
                  library_call="k_all[:, :, :, pos] = k_new; v_all[:, :, :, pos] = v_new")


def _host_us(fn, n: int = 300) -> float:
    """The host's µs a call of ``fn(i)``: ``n`` calls issued back to back
    after a warm-up, timed on the host clock up to the last issue (the card
    runs behind; each call here is far shorter on the card than on the
    host)."""
    fn(0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(n):
        fn(i)
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / n * 1e6


def _wrapper_host_us(call, rounds: int = 5) -> tuple:
    """The host's µs a call of a kernel wrapper ``call(i)`` (``_host_us``):
    whole, and with the kernel library's entry points stubbed to return at
    once (the wrapper's Python alone, before the C call; the rest is ctypes
    and the launch itself). Each is the least of ``rounds`` rounds, taken
    in turn: the host's cores are shared, and a round that other work
    slowed says nothing of the wrapper."""
    from vocalie_tts_tpu_torch.ops import _build

    real = _build.kernel
    whole, python = [], []
    for _ in range(rounds):
        whole.append(_host_us(call))
        _build.kernel = lambda *a, **k: (lambda *args: 0)
        try:
            python.append(_host_us(call))
        finally:
            _build.kernel = real
    return min(whole), min(python)


def _append_row(name, exact, ms, g_ms, plain_ms, lib_ms, lib_g_ms, bms, by, lib_what, host_us,
                failures) -> dict:
    """Log one K4/K5 row (eager and graph ms beside the slice assignment's,
    the wrapper's host µs a call), gate it byte-exact, and return its dict."""
    log(f"{name}: byte-exact={exact} (tolerance: byte-exact); kernel {ms:.6f} ms eager, "
        f"{fmt_ms(g_ms)} ms graph, plain {plain_ms:.6f} ms, {lib_what} {lib_ms:.6f} ms eager, "
        f"{fmt_ms(lib_g_ms)} ms graph, bound {bms:.6f} ms ({by}); wrapper host time "
        f"{host_us:.2f} us a call")
    if not exact:
        failures.append(f"{name.split()[0]} differs from its plain version")
    return {"max_abs_err": 0.0 if exact else float("inf"), "tolerance": 0.0, "ms": ms,
            "graph_ms": g_ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
            "library_ms": lib_ms, "library_graph_ms": lib_g_ms, "host_us": host_us}


def _flash_case(dev, failures, *, b, h, s, d, causal, kv_lens_lo, seed, label, hk=None):
    import torch.nn.functional as F

    from vocalie_tts_tpu_torch.ops.flash_attention import attention_plain, flash_attention

    hk = hk or h
    gen = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((b, h, s, d), generator=gen, device=dev).to(torch.bfloat16)
    k, v = (torch.randn((b, hk, s, d), generator=gen, device=dev).to(torch.bfloat16)
            for _ in range(2))
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
    ms, g_ms = timed(lambda i: flash_attention(q, k, v, causal=causal, kv_lens=lens), 50,
                     f"B6 [{label}]", 100)
    plain_ms = cuda_ms(lambda i: attention_plain(q, k, v, causal=causal, kv_lens=lens), 10)
    gqa = {"enable_gqa": True} if hk != h else {}
    if lens is not None:
        keep = torch.arange(s, device=dev)[None, :] < lens[:, None]
        mask = keep[:, None, None, :]
        lib_ms, lib_g_ms = timed(lambda i: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, **gqa), 50, f"SDPA [{label}]", 100)
        kv_rows = hk * lens.sum().item()
        pairs = s * h * lens.sum().item()
        # q read and o written in full; k and v only up to each row's kv_len
        n_bytes = 2 * b * h * s * d * 2 + 2 * kv_rows * d * 2 + 4 * b
    else:
        lib_ms, lib_g_ms = timed(lambda i: F.scaled_dot_product_attention(
            q, k, v, is_causal=causal, **gqa), 50, f"SDPA [{label}]", 100)
        pairs = b * h * (s * (s + 1) // 2 if causal else s * s)
        n_bytes = 2 * b * h * s * d * 2 + 2 * b * hk * s * d * 2
    n_ops = 4 * d * pairs
    bms, by = bound_ms(n_bytes, n_ops, PEAK_BF16_FLOPS)
    tflops = n_ops / (ms * 1e-3) / 1e12
    log(f"B6 flash_attention [{label}]: kernel {ms:.6f} ms eager ({tflops:.1f} TFLOP/s, "
        f"{n_ops / 1e9:.2f} GFLOP, {n_bytes / 1e6:.1f} MB), {fmt_ms(g_ms)} ms graph, plain "
        f"{plain_ms:.6f} ms, SDPA {lib_ms:.6f} ms eager, {fmt_ms(lib_g_ms)} ms graph, bound "
        f"{bms:.6f} ms ({by})")
    return {"max_abs_err": err, "tolerance": "atol 1e-2 + rtol 1e-2", "ms": ms, "graph_ms": g_ms,
            "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by, "library_ms": lib_ms,
            "library_graph_ms": lib_g_ms, "tflops": tflops,
            "shape": f"{label}: q[{b},{h},{s},{d}] k/v[{b},{hk},{s},{d}] bf16"}


def check_flash_attention(dev, failures):
    # CFM transformer blocks: 8 rows CFG-doubled, 8 heads, 640 mel frames
    cfm = _flash_case(dev, failures, b=16, h=8, s=640, d=64, causal=False, kv_lens_lo=320,
                      seed=3, label="cfm non-causal kv_lens")
    # prefill at the 512 prompt bucket
    pre = _flash_case(dev, failures, b=16, h=16, s=512, d=64, causal=True, kv_lens_lo=None,
                      seed=4, label="prefill causal")
    # the Qwen3 prefill at the 512 bucket: d_head 128, 16 q heads on 8 kv heads
    q3 = _flash_case(dev, failures, b=8, h=16, hk=8, s=512, d=128, causal=True, kv_lens_lo=None,
                     seed=5, label="qwen3 prefill causal GQA d128")
    # the Qwen3 one-chunk request at batch 1 (the 512 bucket): 128 blocks of
    # 64 rows for 132 SMs; its 6 MB stay in the L2 (timed warm)
    q3b1 = _flash_case(dev, failures, b=1, h=16, hk=8, s=512, d=128, causal=True,
                       kv_lens_lo=None, seed=6, label="qwen3 batch-1 prefill causal GQA d128")
    return {"name": "B6 flash_attention", "route": "cuda",
            "source": "vocalie_tts_tpu_torch/csrc/flash_attention.cu",
            "replaces": "vocalie_tts_tpu/ops/flash_attention.py:226",
            **cfm, "prefill_causal": pre, "qwen3_shape": q3, "qwen3_batch1_shape": q3b1}


#: B2-B4 against their plain versions: the kernels repeat the plain
#: versions' rounding step for step (exact int32 products, the variance
#: summed in double, IEEE divides, the same f32 epilogue order), so only an
#: int8 activation on a .5 tie reached from the other side could move an
#: output (by ~1e-3 of its scale); a d_ff block other than the tile moves
#: it by ~1e-2 (tests/test_torch_decode_dense.py)
DENSE_TOL = 1e-5


# ── B7: the whole decode step at batch 1 ─────────────────────────────────

B7_NAME = "B7 decode_step_fused"


def stream_layout() -> dict:
    """The streaming request's prompt: its length, its prompt and decode
    buckets and its cache length, found as ``CosyVoiceRuntime.
    synthesize_streaming`` finds them (the byte frontend, no weights)."""
    from vocalie_tts_tpu_torch.models.common.ar_runtime import pad_token_batch
    from vocalie_tts_tpu_torch.models.cosyvoice.model import TOKENS_PER_SECOND
    from vocalie_tts_tpu_torch.models.cosyvoice.runtime import (
        DECODE_BUCKETS,
        PROMPT_BUCKETS,
        SCALES,
    )
    from vocalie_tts_tpu_torch.ops.kv_cache import pick_bucket, round_cache_len
    from vocalie_tts_tpu_torch.text.duration import estimate_duration
    from vocalie_tts_tpu_torch.text.frontend import build_prompt_ids, load_frontend

    with tempfile.TemporaryDirectory() as tmp:
        fe = load_frontend(tmp, style="raw", text_vocab=SCALES["full"].text_vocab)
    parts = build_prompt_ids(fe, STREAM_TEXT, preamble=COSY_INSTRUCT)
    _tok, lengths, prompt_bucket, _ = pad_token_batch(
        [parts], prompt_buckets=PROMPT_BUCKETS, batch_buckets=(1,), extra_positions=2)
    est = int(estimate_duration(STREAM_TEXT) * TOKENS_PER_SECOND * 1.8) + 8
    decode_bucket = pick_bucket(est, DECODE_BUCKETS)
    return {"prompt_len": int(lengths[0]), "prompt_bucket": prompt_bucket,
            "decode_bucket": decode_bucket,
            "cache_len": round_cache_len(prompt_bucket + decode_bucket)}


def _b7_inputs(dev):
    """B7's inputs as the streaming request gives them halfway through its
    decode, from a seed: the full CosyVoice LM's shapes (random int8
    weights, f32 norm weights, non-zero bf16 q/k/v biases as the model
    stores them) over the request's own cache (random int8 k/v), whose mask
    lets through the prompt and the tokens decoded so far. Also one call of
    the wrapper."""
    import types

    from vocalie_tts_tpu_torch.models.cosyvoice.runtime import SCALES
    from vocalie_tts_tpu_torch.ops import decode_step as ds

    lm = SCALES["full"].lm
    L, H, d, D, F = lm.n_layers, lm.n_heads, lm.d_head, lm.d_model, lm.d_ff
    lay = stream_layout()
    T, n_dec = lay["cache_len"], lay["decode_bucket"] // 2
    pos = torch.arange(T, device=dev)
    keep = (pos < lay["prompt_len"]) | ((pos >= lay["prompt_bucket"])
                                       & (pos < lay["prompt_bucket"] + n_dec))
    valid = int(keep.sum())
    gen = torch.Generator(device=dev).manual_seed(8)

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
    bias = torch.where(keep, 0.0, NEG).float()[None]
    wo, wos = weights(H * d, D)
    mw = 1 + 0.1 * torch.randn((L, D), generator=gen, device=dev)
    wgu, sgu = weights(D, 2 * F)
    wd, sd = weights(F, D)
    nw = 1 + 0.1 * torch.randn((L, D), generator=gen, device=dev)
    wq, sq = weights(D, 3 * H * d)
    bq = (0.5 * torch.randn((L, 3 * H * d), generator=gen, device=dev)).to(lm.dtype)
    ang = float(lay["prompt_len"] + n_dec) / (
        lm.rope_theta ** (torch.arange(0, d, 2, device=dev).float() / d))
    c, sn = torch.cos(ang)[None], torch.sin(ang)[None]
    args = (q0, kn0, vn0, x, k, v, ks, vs, bias, wo, wos, mw, wgu, sgu, wd, sd, nw, wq, sq, bq,
            torch.cat([c, c], -1), torch.cat([-sn, sn], -1))
    kw = dict(sm_scale=d ** -0.5, eps=lm.norm_eps)
    call = lambda: ds.decode_step_fused_packed(*args, **kw)  # noqa: E731
    return types.SimpleNamespace(**locals())


def check_decode_step(dev, failures):
    """B7 at the streaming request's inputs (``_b7_inputs``) against its
    plain version (1e-5 x max|ref| on each output, as B2-B4: the plain
    version takes the kernel's steps); its time against its bound and the
    plain version, and the ops the port runs for the same step with
    ``VOCALIE_FUSED_STEP=0``: B3 + L x (B1 + B2) at batch 1 (their glue left
    out). Returns the ``kernels`` entry; its ``path_inputs`` are what phase
    4 holds the streaming request's own B7 calls to."""
    from vocalie_tts_tpu_torch.ops import decode_dense as dd
    from vocalie_tts_tpu_torch.ops import decode_step as ds
    from vocalie_tts_tpu_torch.ops.decode_attention import decode_attention_int8_stacked

    t = _b7_inputs(dev)
    L, H, d, D, F, T, valid = t.L, t.H, t.d, t.D, t.F, t.T, t.valid
    got = t.call()
    ref = ds.decode_step_fused_plain(*t.args, **t.kw)
    torch.cuda.synchronize()
    errs = [(g - r).abs().max().item() for g, r in zip(got, ref)]
    worst = max(e / (DENSE_TOL * r.abs().max().item()) for e, r in zip(errs, ref))
    ms, g_ms = timed(lambda i: t.call(), 50, B7_NAME, 50)
    plain_ms = cuda_ms(lambda i: ds.decode_step_fused_plain(*t.args, **t.kw), 3, warmup=1)
    xb = t.x.to(torch.bfloat16)
    attn = torch.randn((1, H * d), device=dev) * 0.3
    q1 = t.q0.reshape(1, H, 1, d).contiguous()
    kn1, vn1 = t.kn0[None].contiguous(), t.vn0[None].contiguous()
    kc, vc = t.k, t.v        # [L, 1, H, T, d]: the b = 1 cache B1 reads
    tail = (attn, xb, t.wo, t.wos, t.mw, t.wgu, t.sgu, t.wd, t.sd, t.nw, t.wq, t.sq)

    write_pos = t.lay["prompt_bucket"] + t.n_dec

    def megatail_ops(i):
        dd.qkv_norm_int8_stacked(xb, t.nw, t.wq, t.sq, 0, eps=t.kw["eps"])
        for l in range(L):
            decode_attention_int8_stacked(q1, kc, vc, t.bias, l, t.ks, t.vs, kn1, vn1,
                                          valid_len=write_pos, sm_scale=d ** -0.5)
            dd.tail_swiglu_qkv_int8_stacked(*tail, l, eps=t.kw["eps"])

    step0_ms, step0_g_ms = timed(megatail_ops, 10, "B7's yardstick B3 + L x (B1 + B2)", 10)
    Q = 3 * H * d
    # each input read once, each output written once; of the cache, only
    # the valid slots (a masked slot's probability is exactly 0)
    w_bytes = L * (D * Q + H * d * D + D * 2 * F + F * D)
    vec_bytes = L * (4 * (Q + D + 2 * F + D) + 4 * 2 * D + Q * t.bq.element_size())
    kv_bytes = 2 * L * H * valid * (d + 2)
    io_bytes = T * 4 + (Q + D + 2 * d) * 4 + (D + 2 * L * H * d) * 4
    n_bytes = w_bytes + vec_bytes + kv_bytes + io_bytes
    n_ops = 2 * L * (D * Q + H * d * D + D * 2 * F + F * D + 2 * H * valid * d)
    bms, by = bound_ms(n_bytes, n_ops, PEAK_INT8_OPS)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    most = ds.max_resident_blocks(H, d, D, F, T)
    log(f"{B7_NAME}: max_abs_err={max(errs):.3e} (x_out/kn/vn {errs[0]:.3e}/{errs[1]:.3e}/"
        f"{errs[2]:.3e}), worst |diff| / ({DENSE_TOL} x max|ref|) = {worst:.3f} (must be <= 1); "
        f"kernel {ms:.6f} ms eager, {fmt_ms(g_ms)} ms graph (one cooperative block per SM: "
        f"{sms}, of at most {most} resident), plain {plain_ms:.6f} ms, B3 + {L} x (B1 + B2) "
        f"{step0_ms:.6f} ms eager, {fmt_ms(step0_g_ms)} ms graph, bound {bms:.6f} ms "
        f"({by}, {n_bytes / 1e6:.1f} MB: weights {w_bytes / 1e6:.1f}, the {valid} valid cache "
        f"slots' k/v and scales {kv_bytes / 1e6:.1f})")
    if not worst <= 1.0:
        failures.append(f"B7 differs from its plain version: worst ratio {worst}")
    return {"name": B7_NAME, "route": "cuda", "source": "vocalie_tts_tpu_torch/csrc/decode_step.cu",
            "replaces": "vocalie_tts_tpu/ops/decode_step.py:245",
            "max_abs_err": max(errs), "tolerance": f"{DENSE_TOL} x max|ref| per output",
            "ms": ms, "graph_ms": g_ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
            "library_ms": None, "fused_step0_ops_ms": step0_ms,
            "fused_step0_ops_graph_ms": step0_g_ms, "cuda_kernels_per_call": None,
            "path_inputs": {"cache_len": T, "valid_slots": valid, "bqkv": str(t.bq.dtype),
                            "norm": str(t.mw.dtype)},
            "shape": f"L {L}, d_model {D}, {H} heads x {d}, d_ff {F}, cache {T} int8 (valid "
                     f"{valid}: prompt {t.lay['prompt_len']} of {t.lay['prompt_bucket']} + "
                     f"{t.n_dec} decoded), {t.bq.dtype} q/k/v bias, batch 1"}


# ── B12: the whole SwiGLU decode layer in one launch ─────────────────────

B12_NAME = "B12 layer_swiglu_qkv_int8"


def _b12_inputs(dev, attn=T3_ATTN, dense=None):
    """B12's inputs at a main path's layer, from a seed: B1's cache and mask
    (``attn``) and the dense kernels' layer weights (``dense``, the
    matching ``*_DENSE``), q/k/v f32 and the residual bf16-valued f32 as
    the decode step hands them over. Also one call of the wrapper."""
    import types

    from vocalie_tts_tpu_torch.ops import decode_layer as dl

    dense = dense or (T3_DENSE if attn is T3_ATTN else QWEN3_DENSE)
    L, b, kv, g, d, T = (attn[k] for k in ("L", "b", "kv", "g", "d", "T"))
    D, F, Q, eps = (dense[k] for k in ("d", "F", "Q", "eps"))
    H, valid_len = kv * g, attn["prompt_pad"] + attn["n_dec"]
    gen = torch.Generator(device=dev).manual_seed(attn["seed"] + 100)

    def weights(d_in, d_out):
        q = torch.randint(-127, 128, (L, d_in, d_out), generator=gen, device=dev,
                          dtype=torch.int8)
        return q, (torch.rand((L, 1, d_out), generator=gen, device=dev) + 0.5) / 127 * d_in ** -0.5

    q = torch.randn((b, kv, g, d), generator=gen, device=dev)
    x = torch.randn((b, D), generator=gen, device=dev).to(torch.bfloat16).float()
    k, v = (torch.randint(-127, 128, (L, b, kv, T, d), generator=gen, device=dev,
                          dtype=torch.int8) for _ in range(2))
    ks, vs = (((torch.rand((L, b, kv, T), generator=gen, device=dev) + 0.5) / 127)
              .to(torch.bfloat16) for _ in range(2))
    kn, vn = (torch.randn((b, kv, d), generator=gen, device=dev) for _ in range(2))
    lens = torch.randint(1, attn["prompt_pad"] + 1, (b,), generator=gen, device=dev)
    pos = torch.arange(T, device=dev)[None, :]
    bias = torch.where((pos < lens[:, None]) | ((pos >= attn["prompt_pad"]) & (pos < valid_len)),
                       0.0, NEG).float()
    wo, wos = weights(H * d, D)
    mw = 1 + 0.1 * torch.randn((L, D), generator=gen, device=dev)
    wgu, sgu = weights(D, 2 * F)
    wd, sd = weights(F, D)
    nw = 1 + 0.1 * torch.randn((L, D), generator=gen, device=dev)
    wq, sq = weights(D, Q)
    head = (q, x, k, v, ks, vs, bias, kn, vn)
    tail = (wo, wos, mw, wgu, sgu, wd, sd, nw, wq, sq)
    kw = dict(sm_scale=d ** -0.5, eps=eps)
    call = lambda: dl.layer_swiglu_qkv_int8_stacked(*head, 1, valid_len, *tail, **kw)  # noqa: E731
    return types.SimpleNamespace(**locals())


def _b12_case(dev, failures, attn, label, dense=None):
    """B12 at one layer shape against its plain version (at a middle and at
    the last layer: the clamped next qkv), DENSE_TOL x max|ref| on each
    output; times: the kernel, its plain version, and the B1 + B2 pair the
    port runs for the same layer without the knob, on the same inputs (no
    PyTorch call computes B12: none quantizes activations)."""
    from vocalie_tts_tpu_torch.ops import decode_dense as dd
    from vocalie_tts_tpu_torch.ops import decode_layer as dl
    from vocalie_tts_tpu_torch.ops.decode_attention import decode_attention_int8_stacked

    t = _b12_inputs(dev, attn, dense)
    L, b, kv, g, d, D, F, Q, H, valid = t.L, t.b, t.kv, t.g, t.d, t.D, t.F, t.Q, t.H, t.valid_len
    got, ref = [], []
    for layer in (L // 2, L - 1):
        got += dl.layer_swiglu_qkv_int8_stacked(*t.head, layer, valid, *t.tail, **t.kw)
        ref += dl.layer_swiglu_qkv_int8_plain(*t.head, layer, valid, *t.tail, **t.kw)
    torch.cuda.synchronize()
    errs = [(a - r).abs().max().item() for a, r in zip(got, ref)]
    worst = max(e / (DENSE_TOL * r.abs().max().item()) for e, r in zip(errs, ref))
    exact = all(torch.equal(a, r) for a, r in zip(got, ref))
    # each timed call reads another layer, as the decode loop does
    ms, g_ms = timed(lambda i: dl.layer_swiglu_qkv_int8_stacked(*t.head, i % L, valid, *t.tail,
                                                                **t.kw), 100,
                     f"{B12_NAME} [{label}]")
    plain_ms = cuda_ms(lambda i: dl.layer_swiglu_qkv_int8_plain(*t.head, i % L, valid, *t.tail,
                                                                **t.kw), 5, warmup=1)
    wo, wos, mw, wgu, sgu, wd, sd, nw, wq, sq = t.tail

    def pair(i):
        l = i % L
        attn = decode_attention_int8_stacked(t.q, t.k, t.v, t.bias, l, t.ks, t.vs, t.kn, t.vn,
                                             valid_len=valid, sm_scale=t.kw["sm_scale"])
        dd.tail_swiglu_qkv_int8_stacked(attn.reshape(b, H * d), t.x, wo, wos, mw, wgu, sgu, wd,
                                        sd, nw, wq, sq, l, eps=t.kw["eps"])

    pair_ms, pair_g_ms = timed(pair, 100, f"B1 + B2 pair [{label}]")
    # and each alone, graph-timed on the same inputs: the sum B12 is held to
    attn1 = decode_attention_int8_stacked(t.q, t.k, t.v, t.bias, 1, t.ks, t.vs, t.kn, t.vn,
                                          valid_len=valid, sm_scale=t.kw["sm_scale"])
    attn1 = attn1.reshape(b, H * d)
    b1_g_ms = try_graph_ms(lambda i: decode_attention_int8_stacked(
        t.q, t.k, t.v, t.bias, i % L, t.ks, t.vs, t.kn, t.vn, valid_len=valid,
        sm_scale=t.kw["sm_scale"]), f"B1 [{label}]", 300)
    b2_g_ms = try_graph_ms(lambda i: dd.tail_swiglu_qkv_int8_stacked(
        attn1, t.x, wo, wos, mw, wgu, sgu, wd, sd, nw, wq, sq, i % L, eps=t.kw["eps"]),
        f"B2 [{label}]", 300)
    sum_g_ms = None if b1_g_ms is None or b2_g_ms is None else b1_g_ms + b2_g_ms
    # each input read once, each output written once; of the cache, only
    # the valid slots (a masked slot's probability is exactly 0)
    w_bytes = H * d * D + D * 2 * F + F * D + D * Q
    vec_bytes = 4 * (D + 2 * F + D + Q) + 4 * 2 * D
    kv_bytes = valid * b * kv * (2 * d + 2 * 2) + valid * b * 4
    io_bytes = 4 * (b * H * d + b * D + 2 * b * kv * d) + 4 * (b * D + b * Q)
    n_bytes = w_bytes + vec_bytes + kv_bytes + io_bytes
    n_ops = 2 * b * w_bytes + 2 * 2 * valid * b * H * d
    bms, by = bound_ms(n_bytes, n_ops, PEAK_INT8_OPS)
    shape = (f"{label}: q[{b},{kv},{g},{d}] cache[{L},{b},{kv},{t.T},{d}] int8 valid_len={valid}, "
             f"d_model {D}, d_ff {F} in tiles of {dd.pick_tile(F, dd.TILE_BUDGET, 2 * D)}, qkv "
             f"{Q}, layers {L // 2} and {L - 1} checked")
    log(f"{B12_NAME} [{label}]: max_abs_err={max(errs):.3e} (bit-equal: {exact}), worst |diff| / "
        f"({DENSE_TOL} x max|ref|) = {worst:.3f} (must be <= 1); kernel {ms:.6f} ms eager, "
        f"{fmt_ms(g_ms)} ms graph (one cooperative launch), plain {plain_ms:.6f} ms, B1 + B2 pair "
        f"{pair_ms:.6f} ms eager, {fmt_ms(pair_g_ms)} ms graph; graph alone B1 "
        f"{fmt_ms(b1_g_ms)} + B2 {fmt_ms(b2_g_ms)} = {fmt_ms(sum_g_ms)} ms; bound "
        f"{bms:.6f} ms ({by}, {n_bytes / 1e6:.2f} MB: weights {w_bytes / 1e6:.2f}, the valid "
        f"slots' k/v, scales and bias {kv_bytes / 1e6:.2f}); {shape}")
    if not worst <= 1.0:
        failures.append(f"{B12_NAME} [{label}] differs from its plain version: worst ratio {worst}")
    return {"max_abs_err": max(errs), "bit_equal": exact, "ms": ms, "graph_ms": g_ms,
            "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by, "b1_b2_pair_ms": pair_ms,
            "b1_b2_pair_graph_ms": pair_g_ms, "b1_graph_ms": b1_g_ms, "b2_graph_ms": b2_g_ms,
            "b1_plus_b2_graph_ms": sum_g_ms, "shape": shape}


def check_decode_layer(dev, failures):
    """B12 at the Chatterbox T3 layer (b = 16, 16 heads of 64, cache 640
    part-filled, as B1's case) and at the Qwen3 layer (b = 8, 16 q and 8 kv
    heads of 128, cache 512) → the ``kernels`` entry."""
    main = _b12_case(dev, failures, T3_ATTN, "voice-over")
    q3 = _b12_case(dev, failures, QWEN3_ATTN, "qwen3")
    return {"name": B12_NAME, "route": "cuda",
            "source": "vocalie_tts_tpu_torch/csrc/decode_layer.cu",
            "replaces": "vocalie_tts_tpu/ops/decode_layer.py:314",
            "tolerance": f"{DENSE_TOL} x max|ref| per output", "library_ms": None,
            "cuda_kernels_per_call": None, **main, "qwen3_shape": q3}


def kernels_per_call(fn) -> dict:
    """The CUDA kernels one call of ``fn`` issues, by name, as
    torch.profiler sees them (empty if it saw none)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {key: n for _, n, key in _device_rows(prof)}


def _kernel_name(key: str) -> str:
    """A profiler key without its return type, namespace and parameters:
    ``void (anonymous namespace)::gn_stats<8, true>(...)`` → ``gn_stats<8, true>``."""
    key = key.removeprefix("void ").replace("(anonymous namespace)::", "")
    return key.split("(")[0]


def count_dense_kernels(kernels, failures) -> None:
    """Record in each B2-B4, B7, B8a-b, B9a-d, B12, B13, K1, K2, B10, K4,
    B1w and K5 entry the CUDA kernels one call of its wrapper
    issues at the main path's shapes, as torch.profiler counts them in a
    child process (``--count-kernels``). The profiler is never on in this
    process, which times everything before phase 5; in a fresh process it
    saw every kernel of a single call, while after other profiled windows
    it missed some."""
    def child(names=()):
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--count-kernels",
                               *names], capture_output=True, text=True, timeout=300)
        lines = proc.stdout.strip().splitlines()
        if proc.returncode != 0:
            failures.append(f"the kernel-count child failed (rc {proc.returncode}): "
                            f"{proc.stderr.strip()[-2000:]}")
        return json.loads(lines[-1]) if proc.returncode == 0 and lines else {}

    counted = child()
    # a call of which the profiler saw no kernel at all is counted once more,
    # alone in a fresh child: the profiler has missed the cooperative B7's
    # one kernel in one child and seen it in each of the next three
    unseen = [name for name, per_call in counted.items() if not per_call]
    if unseen:
        log(f"the profiler saw no CUDA kernel for {unseen}: counting them again in a fresh child")
        counted.update(child(unseen))
    for entry in kernels:
        # B1's Qwen3 shape and B13's other studio shapes are counted under
        # "<name> [<label>]" into their own dicts
        targets = [(entry["name"], entry, entry["name"])]
        if entry["name"] in (B1_NAME, B12_NAME):
            targets.append((f"{entry['name']} [qwen3]", entry["qwen3_shape"], entry["name"]))
        for case in entry.get("cases", ()) if entry["name"] == B13_NAME else ():
            targets.append((f"{B13_NAME} [{case['label']}]", case, B13_NAME))
        for key, into, name in targets:
            if key not in counted:
                continue
            per_call = counted.get(key, {})
            n_kernels = sum(per_call.values()) or None
            listed = ", ".join(f"{_kernel_name(k)} x{n}" for k, n in sorted(per_call.items()))
            into["cuda_kernels_per_call"] = n_kernels
            log(f"{key}: CUDA kernels per call (profiled): "
                + (f"{n_kernels} ({listed})" if n_kernels else "not measured (profiler saw none)"))
            if name in ONE_KERNEL_NAMES and n_kernels != 1:
                failures.append(f"{key}: {n_kernels} CUDA kernels a call, not 1")


def _count_kernels_child() -> int:
    """``--count-kernels [name ...]``: one profiled call of each of B1-B4, B7, B8a-b, B9a-d,
    B12, B13, K1, K2, B10, K4, B1w and K5 (or of the named ones alone; after
    one unprofiled call that loads the library), printed as one JSON line."""
    dev = torch.device("cuda:0")
    t3 = {k: c for k, c in _dense_inputs(dev).calls.items() if k not in B8_NAMES}
    q3 = {k: c for k, c in _dense_inputs(dev, QWEN3_DENSE).calls.items() if k in B8_NAMES}
    calls = {**t3, **q3, B7_NAME: _b7_inputs(dev).call, B12_NAME: _b12_inputs(dev).call,
             f"{B12_NAME} [qwen3]": _b12_inputs(dev, QWEN3_ATTN).call,
             **_b1_b13_calls(dev), **_gelu_inputs(dev).calls,
             **_f32_calls(dev), **_flash_train_calls(dev), **_slice10_calls(dev)}
    wanted = sys.argv[2:]
    out = {}
    for name, call in calls.items():
        if wanted and name not in wanted:
            continue
        call()
        out[name] = kernels_per_call(call)
    print(json.dumps(out), flush=True)
    return 0


def _b1_b13_calls(dev) -> dict:
    """One call each of B1 at the T3 and Qwen3 decode shapes and of B13 at
    every studio shape, for the kernel-count child (keys as
    ``count_dense_kernels`` reads them)."""
    from vocalie_tts_tpu_torch.ops.decode_attention import decode_attention_int8_stacked

    calls = {}
    for key, attn in ((B1_NAME, T3_ATTN), (f"{B1_NAME} [qwen3]", QWEN3_ATTN)):
        t = _b1_inputs(dev, **{**attn, "L": 8})
        calls[key] = lambda t=t: decode_attention_int8_stacked(
            t.q, t.k, t.v, t.bias, 7, t.ks, t.vs, t.kn, t.vn, valid_len=t.valid_len,
            sm_scale=t.sm)
    for i, case in enumerate(GN_CASES):
        key = B13_NAME if i == 0 else f"{B13_NAME} [{case[0]}]"
        calls[key] = _gn_case(dev, case).call
    return calls


def _f32_calls(dev) -> dict:
    """One call each of K1, K2 and B10 at their phase-2 shapes, and of K4 at
    the T3 bf16 cache, for the kernel-count child."""
    from vocalie_tts_tpu_torch.ops import decode_attention as da
    from vocalie_tts_tpu_torch.ops.cache_update import cache_append_kv_stacked

    t = _f32_attn_inputs(dev, T3_ATTN, torch.bfloat16)
    t8 = _f32_attn_inputs(dev, T3_ATTN, torch.int8)
    kn = torch.zeros((t.L, t.b, t.kv, t.d), dtype=torch.bfloat16, device=dev)
    kw = dict(valid_len=t.valid, sm_scale=t.sm)
    return {
        K1_NAME: lambda: da.decode_attention_float_stacked(t.q, t.k, t.v, t.bias, 7, t.kn, t.vn,
                                                           **kw),
        K2_NAME: lambda: da.decode_attention_dequant_stacked(t8.q, t8.k, t8.v, t8.bias, 7, t8.ks,
                                                             t8.vs, t8.kn, t8.vn, **kw),
        B10_NAME: lambda: da.decode_attention(t.q, t.k[3], t.v[3], t.bias, sm_scale=t.sm),
        K4_NAME: lambda: cache_append_kv_stacked(t.k, t.v, kn, kn, t.valid),
    }


def _dense_entry(name, *, got, ref, ms, plain_ms, ops_ms, n_bytes, n_ops, shape, failures,
                 ops_key="slice1_ops_ms", g_ms=None, ops_g_ms=None, host=None):
    """The ``kernels`` entry of a dense kernel; ``ops_ms`` is the time of the
    ops the port runs otherwise for the same work (``ops_key``: the slice-1
    path's for B2-B4, the ``_qdot`` path's for B9); ``g_ms`` and
    ``ops_g_ms`` the same two graph-timed; ``host`` the wrapper's host µs a
    call (``_wrapper_host_us``). B2 and B8a (one launch,
    ``csrc/tail_swiglu.cu``) and B3 and B4 (one launch,
    ``csrc/dense_int8.cu``) must be bit-equal to their plain versions."""
    errs = [(g - r).abs().max().item() for g, r in zip(got, ref)]
    worst = max(e / (DENSE_TOL * r.abs().max().item()) for e, r in zip(errs, ref))
    err = max(errs)
    exact = all(torch.equal(g, r) for g, r in zip(got, ref))
    bms, by = bound_ms(n_bytes, n_ops, PEAK_INT8_OPS)
    ops_what = ops_key.removesuffix('_ms').replace('_', ' ')
    log(f"{name}: max_abs_err={err:.3e} (bit-equal: {exact}), worst |diff| / ({DENSE_TOL} x "
        f"max|ref|) = {worst:.3f} (must be <= 1); kernel {ms:.6f} ms eager, {fmt_ms(g_ms)} ms "
        f"graph (eager - graph {fmt_ms(None if g_ms is None else ms - g_ms)} ms), plain "
        f"{plain_ms:.6f} ms, {ops_what} {ops_ms:.6f} ms eager, {fmt_ms(ops_g_ms)} ms graph, bound "
        f"{bms:.6f} ms ({by}, {n_bytes / 1e6:.2f} MB)" + ("" if host is None else
        f"; wrapper host time {host[0]:.2f} us a call, {host[1]:.2f} us of it before the C call"))
    if not worst <= 1.0:
        failures.append(f"{name} differs from its plain version: worst ratio {worst}")
    if name in TAIL_NAMES + DENSE_ONE_NAMES and not exact:
        failures.append(f"{name} is not bit-equal to its plain version (max_abs_err {err})")
    source = ("tail_swiglu.cu" if name in TAIL_NAMES else
              "tail_gelu.cu" if name in (B9B_NAME, B9C_NAME) else
              "dense_int8.cu" if name in DENSE_ONE_NAMES else "decode_dense.cu")
    return {"name": name, "route": "cuda",
            "source": "vocalie_tts_tpu_torch/csrc/" + source,
            "replaces": f"vocalie_tts_tpu/ops/decode_dense.py:{DENSE_LINES[name]}",
            "max_abs_err": err, "bit_equal": exact, "tolerance": f"{DENSE_TOL} x max|ref|"
            + ("; bit-equal" if name in TAIL_NAMES + DENSE_ONE_NAMES else ""),
            "ms": ms, "graph_ms": g_ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
            "library_ms": None, ops_key: ops_ms, ops_key.removesuffix("_ms") + "_graph_ms": ops_g_ms,
            "cuda_kernels_per_call": None, "shape": shape,
            **({} if host is None else {"host_us": host[0], "host_python_us": host[1]})}


#: the dense kernels' names in the ``kernels`` line and the lines of the
#: JAX functions they replace in vocalie_tts_tpu/ops/decode_dense.py
DENSE_LINES = {"B3 qkv_norm_int8": 269, "B2 tail_swiglu_qkv_int8": 519,
               "B4 dense_int8 (lm_head)": 116, "B8a tail_swiglu_int8": 368,
               "B8b mlp_swiglu_int8": 190, "B9a qkv_lnorm_int8": 652,
               "B9b tail_gelu_qkv_int8": 985, "B9c tail_gelu_int8": 752,
               "B9d mlp_gelu_int8": 862}
B8_NAMES = ("B8a tail_swiglu_int8", "B8b mlp_swiglu_int8")
#: B2 and B8a: one cooperative launch (csrc/tail_swiglu.cu), bit-equal to
#: their plain versions; one CUDA kernel a call
TAIL_NAMES = ("B2 tail_swiglu_qkv_int8", "B8a tail_swiglu_int8")
#: B9b and B9c: one cooperative launch (csrc/tail_gelu.cu), bit-equal to
#: the old 12- and 9-kernel chains (which still run the shapes the body
#: does not take)
B9B_NAME = "B9b tail_gelu_qkv_int8"
B9C_NAME = "B9c tail_gelu_int8"
#: B3 and B4: one launch each (csrc/dense_int8.cu), bit-equal to their
#: plain versions and to the old three-kernel chain (which still runs the
#: shapes the body does not take)
DENSE_ONE_NAMES = ("B3 qkv_norm_int8", "B4 dense_int8 (lm_head)")
#: the kernels that must be one CUDA kernel a call (B1 and B13 at each of
#: their shapes: ``count_dense_kernels``)
ONE_KERNEL_NAMES = TAIL_NAMES + DENSE_ONE_NAMES + (B9B_NAME, B9C_NAME, "B7 decode_step_fused",
                                 "B1 decode_attention_int8", "B13 group_norm_fused",
                                 "B12 layer_swiglu_qkv_int8")
#: the SwiGLU dense kernels' decode shapes: the Chatterbox T3 voice-over
#: (b = 16: 8 chunks, CFG-doubled; the 1026-token head padded to 1152) and
#: the Qwen3 bench request (b = 8; GQA qkv 16 x 128 + 2 x 8 x 128; d_ff 8192
#: in eight tiles of 1024; the 2050-token head padded to 2176)
T3_DENSE = dict(L=30, b=16, d=1024, F=4096, Q=3072, N=1152, heads=16, d_head=64, eps=1e-5,
                seed=6, label="voice-over")
QWEN3_DENSE = dict(L=28, b=8, d=2048, F=8192, Q=4096, N=2176, heads=16, d_head=128, eps=1e-6,
                   seed=16, label="qwen3")


def _dense_inputs(dev, shape=T3_DENSE):
    """The inputs of B3, B2, B4, B8a and B8b at ``shape`` (stacked over its
    layers), from a seed, and one call of each wrapper by its entry's name."""
    import types

    from vocalie_tts_tpu_torch.ops import decode_dense as dd

    L, b, d, F, Q, N, eps = (shape[k] for k in ("L", "b", "d", "F", "Q", "N", "eps"))
    gen = torch.Generator(device=dev).manual_seed(shape["seed"])

    def weights(d_in, d_out, n=L):
        q = torch.randint(-127, 128, (n, d_in, d_out), generator=gen, device=dev,
                          dtype=torch.int8)
        s = (torch.rand((n, 1, d_out), generator=gen, device=dev) + 0.5) / 127 * d_in ** -0.5
        return q, s

    x = torch.randn((b, d), generator=gen, device=dev).to(torch.bfloat16)
    attn = torch.randn((b, d), generator=gen, device=dev) * 0.3
    nw = 1 + 0.1 * torch.randn((L, d), generator=gen, device=dev)
    mw = 1 + 0.1 * torch.randn((L, d), generator=gen, device=dev)
    wq, sq = weights(d, Q)
    wo, wos = weights(d, d)
    wgu, sgu = weights(d, 2 * F)
    wd, sd = weights(F, d)
    wh, sh = weights(d, N)
    tail = (attn, x, wo, wos, mw, wgu, sgu, wd, sd)
    args = tail + (nw, wq, sq)
    calls = {"B3 qkv_norm_int8": lambda: dd.qkv_norm_int8_stacked(x, nw, wq, sq, 1, eps=eps),
             "B2 tail_swiglu_qkv_int8": lambda: dd.tail_swiglu_qkv_int8_stacked(*args, 1, eps=eps),
             "B4 dense_int8 (lm_head)": lambda: dd.dense_int8_stacked(x, wh, sh, 1),
             "B8a tail_swiglu_int8": lambda: dd.tail_swiglu_int8_stacked(*tail, 1, eps=eps),
             "B8b mlp_swiglu_int8": lambda: dd.mlp_swiglu_int8_stacked(x, wgu, sgu, wd, sd, 1)}
    return types.SimpleNamespace(**locals())


def _tail_plan_note(dev, shape: dict, qkv: bool) -> dict:
    """B2's (``qkv``) or B8a's launch plan at a phase-2 shape, logged:
    blocks, tile rows, ring depth, shared bytes and the largest block's
    weight bytes."""
    from vocalie_tts_tpu_torch.ops import decode_dense as dd

    b, d, F = shape["b"], shape["d"], shape["F"]
    Q = shape["Q"] if qkv else 0
    tile = dd.pick_tile(F, dd.TILE_BUDGET, 2 * d)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    p = dd.tail_plan(b, d, d, F, tile, Q, sms)
    loads = [sum(dd.tail_item_rows(k, d, d, F) * dd.SLAB for k, _ in its) for its in p.items]
    note = {"grid": p.grid, "kc": p.kc, "stages": p.stages, "smem": p.smem,
            "ring_holds_all": p.ring_holds_all, "max_block_weight_bytes": max(loads),
            "mean_block_weight_bytes": sum(loads) / len(loads)}
    log(f"{'B2' if Q else 'B8a'} plan at b {b}, d {d}, d_ff {F}, qkv {Q}: {note}")
    return note


def _chain_kw(fn) -> dict:
    """``{"chain": True}`` where the wrapper ``fn`` takes it; a tree whose B3
    and B4 are the old chain itself (before their one launch) takes none."""
    return {"chain": True} if "chain" in inspect.signature(fn).parameters else {}


def check_b3_b4(t, failures, label: str) -> list:
    """B3 (the layer-0 norm + qkv prologue) and B4 (the 128-padded int8
    lm_head) at a decode shape ``t`` (``_dense_inputs``), each one launch of
    ``csrc/dense_int8.cu``: against their plain versions and, bit for bit,
    the old three-kernel chain (``chain=True``) at layers 0 and L - 1, B4
    also on the layer's qkv weights (the ``DENSE_FNS`` qkv shape); each
    timed eager and graph beside the chain, with both wrappers' host µs in
    this process. Each timed call reads another layer, as the decode step
    does (the head over as many copies for the same reason). The yardstick
    (``slice1_ops_ms``) is the ops the port runs for the same work with the
    dense kernels off (``_qdot`` and the f32 norm): no PyTorch call
    quantizes activations. Returns the two ``kernels`` entries."""
    from vocalie_tts_tpu_torch.models.common import transformer as tr
    from vocalie_tts_tpu_torch.ops import decode_dense as dd

    L, b, d, Q, N, eps = t.L, t.b, t.d, t.Q, t.N, t.eps
    x, nw, wq, sq, wh, sh = t.x, t.nw, t.wq, t.sq, t.wh, t.sh
    kw = _chain_kw(dd.dense_int8_stacked)
    rows = {
        DENSE_ONE_NAMES[0]: dict(
            call=lambda l, **k: dd.qkv_norm_int8_stacked(x, nw, wq, sq, l, eps=eps, **k),
            plain=lambda l: dd.qkv_norm_int8_plain(x, nw, wq, sq, l, eps=eps),
            ops=lambda l: tr._qdot(tr.rms_norm(x, nw[l], eps), {"q": wq[l], "s": sq[l]}),
            n_bytes=b * d * 2 + d * 4 + d * Q + Q * 4 + b * Q * 4, n_ops=2 * b * d * Q,
            shape=f"x[{b},{d}] bf16, f32 norm weights, W[{L},{d},{Q}] int8"),
        DENSE_ONE_NAMES[1]: dict(
            call=lambda l, **k: dd.dense_int8_stacked(x, wh, sh, l, **k),
            plain=lambda l: dd.dense_int8_plain(x, wh, sh, l),
            ops=lambda l: tr._qdot(x, {"q": wh[l], "s": sh[l]}, f32_out=True),
            n_bytes=b * d * 2 + d * N + N * 4 + b * N * 4, n_ops=2 * b * d * N,
            shape=f"x[{b},{d}] bf16, W[1,{d},{N}] int8 (timed over {L} copies); also the "
                  f"DENSE_FNS qkv W[{L},{d},{Q}] at layers 0 and {L - 1}"),
    }
    out = []
    for name, r in rows.items():
        key = f"{name.split()[0]} [{label}]"
        layers = (0, L - 1)
        got = [r["call"](l) for l in layers]
        ref = [r["plain"](l) for l in layers]
        chain = [r["call"](l, **kw) for l in layers]
        if name == DENSE_ONE_NAMES[1]:
            got += [dd.dense_int8_stacked(x, wq, sq, l) for l in layers]
            ref += [dd.dense_int8_plain(x, wq, sq, l) for l in layers]
            chain += [dd.dense_int8_stacked(x, wq, sq, l, **kw) for l in layers]
        torch.cuda.synchronize()
        same = all(torch.equal(a, c) for a, c in zip(got, chain))
        log(f"{key}: equal to the old chain at layers 0, {L - 1}: {same} (max |diff| "
            f"{max((a - c).abs().max().item() for a, c in zip(got, chain)):.3e})")
        if not same:
            failures.append(f"{key} differs from the old chain (vt_dense_int8)")
        ms, g_ms = timed(lambda i: r["call"](i % L), 300, key)
        old_ms, old_g_ms = timed(lambda i: r["call"](i % L, **kw), 300, f"{key}, the old chain")
        host = _wrapper_host_us(lambda i: r["call"](i % L))
        old_host = _wrapper_host_us(lambda i: r["call"](i % L, **kw))
        ops_ms, ops_g_ms = timed(lambda i: r["ops"](i % L), 100, f"{key} yardstick")
        e = _dense_entry(name, got=got, ref=ref, ms=ms, g_ms=g_ms, host=host,
                         plain_ms=cuda_ms(lambda i: r["plain"](i % L), 20), ops_ms=ops_ms,
                         ops_g_ms=ops_g_ms, n_bytes=r["n_bytes"], n_ops=r["n_ops"],
                         shape=r["shape"], failures=failures)
        e["shape"] = f"{label}: {e['shape']}"
        e.update(equal_to_old_chain=same, earlier_ms=old_ms, earlier_graph_ms=old_g_ms,
                 earlier_host_us=old_host[0], earlier_host_python_us=old_host[1],
                 earlier="the old three-kernel chain (vt_dense_int8, chain=True), timed in "
                         "this run")
        log(f"{key}: the old chain {old_ms:.6f} ms eager, {fmt_ms(old_g_ms)} ms graph; wrapper "
            f"host time {host[0]:.2f} us a call against the old chain's {old_host[0]:.2f} us"
            + (" (more: a miss)" if host[0] > old_host[0] else ""))
        out.append(e)
    return out


def check_dense(dev, failures, shape=T3_DENSE):
    """B3, B2 and B4 (and at the Qwen3 shape B8a and B8b) at the decode
    shapes of a main path. Each timed call reads another layer, as the
    decode step does (the 0.5-1.8 GB of int8 weights are far larger than
    the 50 MB L2); the head is timed over as many copies for the same
    reason. The yardstick (``slice1_ops_ms``) is the ops the port runs for
    the same work with the dense kernels off (``_qdot``, the f32 norm and
    SwiGLU): no PyTorch call quantizes activations."""
    from vocalie_tts_tpu_torch.models.common import transformer as tr
    from vocalie_tts_tpu_torch.ops import decode_dense as dd

    t = _dense_inputs(dev, shape)
    L, b, d, F, Q, N, eps, label = t.L, t.b, t.d, t.F, t.Q, t.N, t.eps, shape["label"]
    x, attn, nw, mw, args, tail = t.x, t.attn, t.nw, t.mw, t.args, t.tail
    wq, sq, wo, wos, wgu, sgu, wd, sd, wh, sh = (t.wq, t.sq, t.wo, t.wos, t.wgu, t.sgu, t.wd,
                                                  t.sd, t.wh, t.sh)
    heads, d_head = shape["heads"], shape["d_head"]
    cfg = tr.TransformerConfig(vocab_size=N, d_model=d, n_layers=L, n_heads=heads,
                               n_kv_heads=heads, d_head=d_head, d_ff=F, norm_eps=eps)
    tile = dd.pick_tile(F, dd.TILE_BUDGET, 2 * d)

    def i8(w, s, l):
        return {"q": w[l], "s": s[l]}

    def entry(name, **kw):
        e = _dense_entry(name, failures=failures, **kw)
        e["shape"] = f"{label}: {e['shape']}"
        return e

    b3, b4 = check_b3_b4(t, failures, label)
    out = [b3]
    # B2: the layer tail + the next layer's norm + qkv, at a middle layer
    # and at the last one (next qkv clamped to it)
    got, ref = [], []
    for layer in (0, L // 2, L - 1):
        got += dd.tail_swiglu_qkv_int8_stacked(*args, layer, eps=eps)
        ref += dd.tail_swiglu_qkv_int8_plain(*args, layer, eps=eps)
    torch.cuda.synchronize()
    attn_heads = attn.to(torch.bfloat16).reshape(b, heads, 1, d_head)

    def slice1_tail(i):
        l = i % L
        layer = {"wo": i8(wo, wos, l), "mlp_norm": mw[l], "w_gateup": i8(wgu, sgu, l),
                 "w_down": i8(wd, sd, l)}
        return tr._block_tail(layer, x[:, None], attn_heads, cfg)

    def slice1_qkv(y, l):
        return tr._qdot(tr.rms_norm(y, nw[min(l + 1, L - 1)], eps), i8(wq, sq, min(l + 1, L - 1)))

    tail_w = d * d + d * 2 * F + F * d
    tail_bytes = b * d * 4 + b * d * 2 + tail_w + 4 * (d + d + 2 * F + d) + b * d * 4
    ms, g_ms = timed(lambda i: dd.tail_swiglu_qkv_int8_stacked(*args, i % L, eps=eps), 300,
                     f"B2 [{label}]")
    ops_ms, ops_g_ms = timed(lambda i: slice1_qkv(slice1_tail(i), i % L), 100,
                             f"B2 yardstick [{label}]")
    out.append(entry(
        "B2 tail_swiglu_qkv_int8", got=got, ref=ref, ms=ms, g_ms=g_ms,
        host=_wrapper_host_us(lambda i: dd.tail_swiglu_qkv_int8_stacked(*args, i % L, eps=eps)),
        plain_ms=cuda_ms(lambda i: dd.tail_swiglu_qkv_int8_plain(*args, i % L, eps=eps), 20),
        ops_ms=ops_ms, ops_g_ms=ops_g_ms,
        n_bytes=tail_bytes + d * Q + 4 * (d + Q) + b * Q * 4,
        n_ops=2 * b * (tail_w + d * Q),
        shape=f"attn[{b},{d}] f32, x[{b},{d}] bf16, d_ff {F} in tiles of {tile}, qkv {Q}, "
              f"{L} layers (layers 0, {L // 2} and {L - 1} checked)"))
    out.append(b4)
    if shape is not QWEN3_DENSE:
        return out
    # B8a: the tail alone (VOCALIE_MEGATAIL=0), at a middle and the last layer
    got, ref = [], []
    for layer in (0, L // 2, L - 1):
        got.append(dd.tail_swiglu_int8_stacked(*tail, layer, eps=eps))
        ref.append(dd.tail_swiglu_int8_plain(*tail, layer, eps=eps))
    torch.cuda.synchronize()
    b2_first = [dd.tail_swiglu_qkv_int8_stacked(*args, layer, eps=eps)[0]
                for layer in (0, L // 2, L - 1)]
    torch.cuda.synchronize()
    same = all(torch.equal(a, c) for a, c in zip(got, b2_first))
    log(f"B8a [{label}]: equal to B2's first output at layers 0, {L // 2}, {L - 1}: {same}")
    if not same:
        failures.append(f"B8a [{label}] differs from B2's first output")
    ms, g_ms = timed(lambda i: dd.tail_swiglu_int8_stacked(*tail, i % L, eps=eps), 300,
                     f"B8a [{label}]")
    ops_ms, ops_g_ms = timed(slice1_tail, 100, f"B8a yardstick [{label}]")
    out.append(entry(
        "B8a tail_swiglu_int8", got=got, ref=ref, ms=ms, g_ms=g_ms,
        host=_wrapper_host_us(lambda i: dd.tail_swiglu_int8_stacked(*tail, i % L, eps=eps)),
        plain_ms=cuda_ms(lambda i: dd.tail_swiglu_int8_plain(*tail, i % L, eps=eps), 20),
        ops_ms=ops_ms, ops_g_ms=ops_g_ms, n_bytes=tail_bytes, n_ops=2 * b * tail_w,
        shape=f"attn[{b},{d}] f32, x[{b},{d}] bf16, d_ff {F} in tiles of {tile}, {L} layers "
              f"(layers 0, {L // 2} and {L - 1} checked)"))

    # B8b: the MLP alone on post-norm bf16 rows (the DENSE_FNS path)
    def slice1_mlp(i):
        l = i % L
        gu = tr._qdot(x, i8(wgu, sgu, l), f32_out=True)
        hidden = (torch.nn.functional.silu(gu[:, :F]) * gu[:, F:]).to(x.dtype)
        return tr._qdot(hidden, i8(wd, sd, l), f32_out=True)

    got = [dd.mlp_swiglu_int8_stacked(x, wgu, sgu, wd, sd, L - 1)]
    ref = [dd.mlp_swiglu_int8_plain(x, wgu, sgu, wd, sd, L - 1)]
    torch.cuda.synchronize()
    mlp_w = d * 2 * F + F * d
    ms, g_ms = timed(lambda i: dd.mlp_swiglu_int8_stacked(x, wgu, sgu, wd, sd, i % L), 300,
                     f"B8b [{label}]")
    ops_ms, ops_g_ms = timed(slice1_mlp, 100, f"B8b yardstick [{label}]")
    out.append(entry(
        "B8b mlp_swiglu_int8", got=got, ref=ref, ms=ms, g_ms=g_ms,
        plain_ms=cuda_ms(lambda i: dd.mlp_swiglu_int8_plain(x, wgu, sgu, wd, sd, i % L), 20),
        ops_ms=ops_ms, ops_g_ms=ops_g_ms,
        n_bytes=b * d * 2 + mlp_w + 4 * (2 * F + d) + b * d * 4, n_ops=2 * b * mlp_w,
        shape=f"x[{b},{d}] bf16 post-norm, d_ff {F} in tiles of {tile}, {L} layers"))
    return out


# ── B9a-c: the GPT-2 dense decode kernels, at the XTTS layer ─────────────


def _gelu_inputs(dev, L: int = 24):
    """The inputs of B9a, B9b and B9c at the decode shapes of the XTTS bench
    request (b = 8 chunks; the full XTTS layer: d_model 1024, d_ff 4096, the
    fused qkv 3072; bf16 residual stream and o/fc/proj biases, f32 LayerNorm
    parameters, as the model stores them), from a seed, and one call of each
    wrapper by its entry's name."""
    import types

    from vocalie_tts_tpu_torch.ops import decode_dense as dd

    b, d, F, Q, eps = 8, 1024, 4096, 3072, 1e-5
    gen = torch.Generator(device=dev).manual_seed(9)

    def weights(d_in, d_out):
        q = torch.randint(-127, 128, (L, d_in, d_out), generator=gen, device=dev,
                          dtype=torch.int8)
        return q, (torch.rand((L, 1, d_out), generator=gen, device=dev) + 0.5) / 127 * d_in ** -0.5

    def vec(n, base=0.0, dtype=torch.float32):
        return (base + 0.1 * torch.randn((L, n), generator=gen, device=dev)).to(dtype)

    x = torch.randn((b, d), generator=gen, device=dev).to(torch.bfloat16)
    attn = torch.randn((b, d), generator=gen, device=dev) * 0.3
    wo, wos = weights(d, d)
    wu, su = weights(d, F)
    wd, sd = weights(F, d)
    wq, sq = weights(d, Q)
    bo, bu, bd = (vec(n, dtype=torch.bfloat16) for n in (d, F, d))
    lg, lb, ng, nb = vec(d, 1.0), vec(d), vec(d, 1.0), vec(d)
    tail = (attn, x, wo, wos, bo, lg, lb, wu, su, bu, wd, sd, bd)
    nxt = (ng, nb, wq, sq)
    calls = {"B9a qkv_lnorm_int8": lambda: dd.qkv_lnorm_int8_stacked(x, ng, nb, wq, sq, 1, eps=eps),
             "B9b tail_gelu_qkv_int8": lambda: dd.tail_gelu_qkv_int8_stacked(*tail, *nxt, 1,
                                                                             eps=eps),
             "B9c tail_gelu_int8": lambda: dd.tail_gelu_int8_stacked(*tail, 1, eps=eps)}
    return types.SimpleNamespace(**locals())


def check_dense_gelu(dev, failures, L: int = 24):
    """B9a, B9b and B9c at the XTTS decode shapes against their plain
    versions (``DENSE_TOL``: the kernels repeat the plain versions' steps,
    the tanh-GELU with ``tanhf`` on both sides). Each timed call reads
    another layer of 24, as the decode step does (the 302 MB of int8 layer
    weights are far larger than the 50 MB L2). The ops the port runs for the
    same work without the dense kernels (the ``_qdot`` path: the f32
    LayerNorm, the int8-weight products in bf16 / f32, the tanh-GELU) are
    timed as the yardstick: no PyTorch call quantizes activations."""
    from vocalie_tts_tpu_torch.models.common import transformer as tr
    from vocalie_tts_tpu_torch.ops import decode_dense as dd

    t = _gelu_inputs(dev, L)
    b, d, F, Q, eps = t.b, t.d, t.F, t.Q, t.eps
    cfg = tr.TransformerConfig(vocab_size=1026, d_model=d, n_layers=L, n_heads=16, n_kv_heads=16,
                               d_head=64, d_ff=F, norm_eps=eps, norm_type="layer",
                               mlp_type="gelu", bias=True)

    def i8(w, s, l):
        return {"q": w[l], "s": s[l]}

    def qdot_qkv(l, x):
        return tr._qdot(tr._norm(x, cfg, t.ng[l], t.nb[l]), i8(t.wq, t.sq, l))

    attn_heads = t.attn.to(torch.bfloat16).reshape(b, 16, 1, 64)

    def qdot_tail(l):
        layer = {"wo": i8(t.wo, t.wos, l), "bo": t.bo[l], "mlp_norm": t.lg[l],
                 "mlp_norm_b": t.lb[l], "w_up": i8(t.wu, t.su, l), "b_up": t.bu[l],
                 "w_down": i8(t.wd, t.sd, l), "b_down": t.bd[l]}
        return tr._block_tail(layer, t.x[:, None], attn_heads, cfg)

    vec_bytes = 4 * 4 * d + 2 * (d + F + d)          # LayerNorm gains/biases, bf16 biases
    tail_w = d * d + d * F + F * d
    tail_scales = 4 * (d + F + d)
    out = []
    got = [dd.qkv_lnorm_int8_stacked(t.x, t.ng, t.nb, t.wq, t.sq, 0, eps=eps)]
    ref = [dd.qkv_lnorm_int8_plain(t.x, t.ng, t.nb, t.wq, t.sq, 0, eps=eps)]
    torch.cuda.synchronize()
    ms, g_ms = timed(lambda i: dd.qkv_lnorm_int8_stacked(t.x, t.ng, t.nb, t.wq, t.sq, i % L,
                                                         eps=eps), 300, "B9a")
    ops_ms, ops_g_ms = timed(lambda i: qdot_qkv(i % L, t.x), 100, "B9a yardstick")
    out.append(_dense_entry(
        "B9a qkv_lnorm_int8", got=got, ref=ref, ms=ms, g_ms=g_ms,
        plain_ms=cuda_ms(lambda i: dd.qkv_lnorm_int8_plain(t.x, t.ng, t.nb, t.wq, t.sq, i % L,
                                                           eps=eps), 20),
        ops_ms=ops_ms, ops_g_ms=ops_g_ms, ops_key="qdot_ops_ms",
        n_bytes=b * d * 2 + 2 * d * 4 + d * Q + Q * 4 + b * Q * 4, n_ops=2 * b * d * Q,
        shape=f"x[{b},{d}] bf16, LayerNorm f32, W[{L},{d},{Q}] int8", failures=failures))
    # B9b at a middle layer and at the last one (its next qkv clamped to it),
    # against its plain version and, bit for bit, the old 12-kernel chain
    tile = dd.pick_tile(F, dd.TILE_BUDGET, 2 * d)
    got, ref, chain = [], [], []
    for layer in (L // 2, L - 1):
        got += dd.tail_gelu_qkv_int8_stacked(*t.tail, *t.nxt, layer, eps=eps)
        ref += dd.tail_gelu_qkv_int8_plain(*t.tail, *t.nxt, layer, eps=eps)
        chain += dd._tail_gelu(*t.tail, t.nxt, layer, eps, tile, chain=True)
    torch.cuda.synchronize()
    same = all(torch.equal(a, c) for a, c in zip(got, chain))
    log(f"B9b: equal to the old chain at layers {L // 2}, {L - 1}: {same} (max |diff| "
        f"{max((a - c).abs().max().item() for a, c in zip(got, chain)):.3e})")
    if not same:
        failures.append("B9b differs from the old chain (vt_tail_gelu_int8)")
    ms, g_ms = timed(lambda i: dd.tail_gelu_qkv_int8_stacked(*t.tail, *t.nxt, i % L, eps=eps),
                     300, "B9b")
    old_ms, old_g_ms = timed(lambda i: dd._tail_gelu(*t.tail, t.nxt, i % L, eps, tile,
                                                     chain=True), 300, "B9b, the old chain")
    ops_ms, ops_g_ms = timed(lambda i: qdot_qkv(min(i % L + 1, L - 1), qdot_tail(i % L)[:, 0]),
                             100, "B9b yardstick")
    out.append(_dense_entry(
        B9B_NAME, got=got, ref=ref, ms=ms, g_ms=g_ms,
        host=_wrapper_host_us(lambda i: dd.tail_gelu_qkv_int8_stacked(*t.tail, *t.nxt, i % L,
                                                                      eps=eps)),
        plain_ms=cuda_ms(lambda i: dd.tail_gelu_qkv_int8_plain(*t.tail, *t.nxt, i % L, eps=eps),
                         20),
        ops_ms=ops_ms, ops_g_ms=ops_g_ms, ops_key="qdot_ops_ms",
        n_bytes=(b * d * 4 + b * d * 2 + tail_w + d * Q + tail_scales + Q * 4 + vec_bytes
                 + b * d * 4 + b * Q * 4),
        n_ops=2 * b * (tail_w + d * Q),
        shape=f"attn[{b},{d}] f32, x[{b},{d}] bf16, bf16 biases, d_ff {F} in tiles of "
              f"{dd.pick_tile(F, dd.TILE_BUDGET, 2 * d)}, qkv {Q}, {L} layers (layers "
              f"{L // 2} and {L - 1} checked)", failures=failures))
    out[-1].update(equal_to_old_chain=same, earlier_ms=old_ms, earlier_graph_ms=old_g_ms,
                   earlier="the old 12-kernel chain (vt_tail_gelu_int8), timed in this run")
    log(f"B9b: the old chain {old_ms:.6f} ms eager, {fmt_ms(old_g_ms)} ms graph")
    c = b9c_row(t, failures)
    ops_ms, ops_g_ms = timed(lambda i: qdot_tail(i % L), 100, "B9c yardstick")
    out.append(_dense_entry(
        B9C_NAME, got=c["got"], ref=c["ref"], ms=c["ms"], g_ms=c["graph_ms"],
        plain_ms=cuda_ms(lambda i: dd.tail_gelu_int8_plain(*t.tail, i % L, eps=eps), 20),
        ops_ms=ops_ms, ops_g_ms=ops_g_ms, ops_key="qdot_ops_ms",
        n_bytes=c["n_bytes"], n_ops=c["n_ops"], shape=c["shape"], failures=failures))
    out[-1].update({k: v for k, v in c.items() if k.startswith(("equal", "earlier"))})
    return out


def b9c_row(t, failures) -> dict:
    """B9c (``tail_gelu_int8_stacked``, the GELU tail without the next qkv:
    the Q = 0 branch of ``csrc/tail_gelu.cu``) on ``_gelu_inputs`` at a
    middle and at the last layer: bit-equal to the old 9-kernel chain
    (``_tail_gelu(..., chain=True)``, which the one-launch body replaces)
    and to its plain version's gate; both timed eager and graph-timed, each
    call reading another layer."""
    from vocalie_tts_tpu_torch.ops import decode_dense as dd

    b, d, F, L, eps = t.b, t.d, t.F, t.L, t.eps
    tile = dd.pick_tile(F, dd.TILE_BUDGET, 2 * d)
    got, ref, chain = [], [], []
    for layer in (L // 2, L - 1):
        got.append(dd.tail_gelu_int8_stacked(*t.tail, layer, eps=eps))
        ref.append(dd.tail_gelu_int8_plain(*t.tail, layer, eps=eps))
        chain.append(dd._tail_gelu(*t.tail, None, layer, eps, tile, chain=True)[0])
    torch.cuda.synchronize()
    same = all(torch.equal(a, c) for a, c in zip(got, chain))
    log(f"B9c: equal to the old chain at layers {L // 2}, {L - 1}: {same} (max |diff| "
        f"{max((a - c).abs().max().item() for a, c in zip(got, chain)):.3e})")
    if not same:
        failures.append("B9c differs from the old chain (vt_tail_gelu_int8)")
    ms, g_ms = timed(lambda i: dd.tail_gelu_int8_stacked(*t.tail, i % L, eps=eps), 300, "B9c")
    old_ms, old_g_ms = timed(lambda i: dd._tail_gelu(*t.tail, None, i % L, eps, tile,
                                                     chain=True), 300, "B9c, the old chain")
    log(f"B9c: {ms:.6f} ms eager, {fmt_ms(g_ms)} ms graph; the old chain {old_ms:.6f} ms eager, "
        f"{fmt_ms(old_g_ms)} ms graph")
    tail_w = d * d + d * F + F * d
    vec_bytes = 2 * 4 * d + 2 * (d + F + d)          # LayerNorm gain/bias, bf16 biases
    return {"got": got, "ref": ref, "ms": ms, "graph_ms": g_ms, "equal_to_old_chain": same,
            "earlier_ms": old_ms, "earlier_graph_ms": old_g_ms,
            "earlier": "the old 9-kernel chain (vt_tail_gelu_int8), timed in this run",
            "n_bytes": (b * d * 4 + b * d * 2 + tail_w + 4 * (d + F + d) + vec_bytes
                        + b * d * 4),
            "n_ops": 2 * b * tail_w,
            "shape": f"attn[{b},{d}] f32, x[{b},{d}] bf16, bf16 biases, d_ff {F} in tiles of "
                     f"{tile}, {L} layers (layers {L // 2} and {L - 1} checked)"}


# ── B13: fused GroupNorm, at the studio pass's shapes ────────────────────

B13_NAME = "B13 group_norm_fused"
PEAK_F32_FLOPS = 67e12          # H100 SXM f32 outside the tensor cores
#: B13's calls on the studio path (full scale, bf16):
#: (label, shape, eps, FiLM row, SiLU)
GN_CASES = (
    ("UNet level-0 ResBlock out_norm, FiLM row + SiLU", (128, 16, 32, 128), 1e-5, True, True),
    ("UNet level-2 skip-concat in_norm", (128, 4, 8, 1024), 1e-5, False, True),
    ("VAE level-0 norm, the largest", (64, 64, 128, 64), 1e-6, False, True),
    ("UNet level-1 skip-concat in_norm, C/G = 12", (128, 8, 16, 384), 1e-5, False, True),
)


def _gn_case(dev, case):
    """B13's inputs for one ``GN_CASES`` entry, from a seed, and one call of
    the wrapper."""
    import types

    from vocalie_tts_tpu_torch.models.common.unet2d import n_groups
    from vocalie_tts_tpu_torch.ops.groupnorm import group_norm_fused

    label, shape, eps, pre, silu = case
    c = shape[-1]
    groups = n_groups(c)
    gen = torch.Generator(device=dev).manual_seed(sum(shape))
    x = (torch.randn(shape, generator=gen, device=dev) * 2 + 0.5).to(torch.bfloat16)
    g = 1 + 0.2 * torch.randn((c,), generator=gen, device=dev)
    b = 0.1 * torch.randn((c,), generator=gen, device=dev)
    e = ((0.3 * torch.randn((shape[0], c), generator=gen, device=dev)).to(torch.bfloat16)
         if pre else None)
    call = lambda: group_norm_fused(x, g, b, groups=groups, eps=eps, silu=silu,  # noqa: E731
                                    pre_add=e)
    return types.SimpleNamespace(**locals())


def check_group_norm(dev, failures):
    """B13 at each ``GN_CASES`` shape against its plain version (one bf16 ulp
    of the plain value + 1e-5: the f32 moments are summed in another order
    and the kernel's SiLU is a few f32 ulps off the IEEE steps, then both
    round once), on the one-pass route; its time against its bound (x read once, y
    written once, over 3.35 TB/s), the plain version and the one PyTorch
    call that computes the same function: ``F.group_norm`` with the same
    add and SiLU, on the same channels-last tensor seen as NCHW."""
    import torch.nn.functional as F

    from vocalie_tts_tpu_torch.ops.groupnorm import group_norm_fused_plain

    from vocalie_tts_tpu_torch.ops import groupnorm as gn

    out = []
    for case in GN_CASES:
        t = _gn_case(dev, case)
        bsz, c = t.shape[0], t.c
        x3 = t.x.reshape(bsz, -1, c)
        row = t.e if t.e is not None else torch.zeros((bsz, c), dtype=torch.bfloat16, device=dev)

        def plain(i=0, t=t, x3=x3, row=row):
            return group_norm_fused_plain(x3, row, t.g, t.b, groups=t.groups, eps=t.eps,
                                          silu=t.silu)

        two0 = getattr(gn.group_norm_fused, "two_pass_launches", None)
        got = t.call()
        ref = plain().reshape(t.shape)
        torch.cuda.synchronize()
        # the route this shape takes: the one-pass plan (cluster, rows a
        # block, pieces), or the two-pass route (a tree without the first)
        plan = (gn.gn_plan(bsz, x3.shape[1], c, t.groups, gn._vec_width(c, x3),
                           gn._sm_count(0)) if hasattr(gn, "gn_plan") else None)
        route = ("two-pass" if two0 is None or gn.group_norm_fused.two_pass_launches > two0
                 else "one-pass")
        if two0 is not None and route != "one-pass":
            failures.append(f"B13 [{t.label}] took the two-pass route")
        diff = (got.float() - ref.float()).abs()
        ulp = torch.exp2(torch.floor(torch.log2(ref.float().abs().clamp(min=2.0 ** -126))) - 7)
        worst = (diff / (ulp + 1e-5)).max().item()
        g16, b16 = t.g.to(torch.bfloat16), t.b.to(torch.bfloat16)
        xn = t.x.permute(0, 3, 1, 2)
        en = t.e[:, :, None, None] if t.e is not None else None

        def library(i, t=t, xn=xn, en=en, g16=g16, b16=b16):
            y = F.group_norm(xn + en if en is not None else xn, t.groups, g16, b16, t.eps)
            return F.silu(y) if t.silu else y

        ms, g_ms = timed(lambda i, t=t: t.call(), 200, f"B13 [{t.label}]")
        plain_ms = cuda_ms(plain, 20)
        lib_ms, lib_g_ms = timed(library, 200, f"F.group_norm [{t.label}]")
        n = t.x.numel()
        n_bytes = 2 * n * 2 + (bsz * c * 2 if t.e is not None else 0) + 2 * c * 4
        bms, by = bound_ms(n_bytes, 10 * n, PEAK_F32_FLOPS)
        log(f"B13 group_norm [{t.label}] x{list(t.shape)} bf16, G {t.groups}, eps {t.eps}: "
            f"{route} route (cluster, rows a block, pieces: {plan}); "
            f"max_abs_err={diff.max().item():.3e}, worst |diff| / (ulp + 1e-5) = {worst:.3f} "
            f"(must be <= 1); kernel {ms:.6f} ms eager, {fmt_ms(g_ms)} ms graph, plain "
            f"{plain_ms:.6f} ms, F.group_norm + add + SiLU {lib_ms:.6f} ms eager, "
            f"{fmt_ms(lib_g_ms)} ms graph, bound {bms:.6f} ms ({by}, {n_bytes / 1e6:.1f} MB)")
        if not worst <= 1.0:
            failures.append(f"B13 [{t.label}] differs from its plain version: worst ratio {worst}")
        out.append({"label": t.label, "shape": f"x{list(t.shape)} bf16, G {t.groups}, eps {t.eps}"
                    f"{', FiLM row' if t.e is not None else ''}{', SiLU' if t.silu else ''}",
                    "max_abs_err": diff.max().item(), "worst_ratio": worst, "ms": ms,
                    "graph_ms": g_ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
                    "library_ms": lib_ms, "library_graph_ms": lib_g_ms, "gn_route": route,
                    "plan": plan})
    main = out[0]
    return {"name": B13_NAME, "route": "cuda", "source": "vocalie_tts_tpu_torch/csrc/groupnorm.cu",
            "replaces": "vocalie_tts_tpu/ops/groupnorm.py:104",
            **{k: main[k] for k in ("max_abs_err", "ms", "graph_ms", "plain_ms", "bound_ms",
                                    "bound_by", "library_ms", "library_graph_ms", "shape",
                                    "gn_route", "plan")},
            "tolerance": "one bf16 ulp of the plain value + 1e-5", "cuda_kernels_per_call": None,
            "library": "F.group_norm + the same add and SiLU", "cases": out[1:]}


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
    from vocalie_tts_tpu_torch.ops import decode_attention as da

    os.environ["VOCALIE_MODEL_SCALE"] = "tiny"
    with tempfile.TemporaryDirectory() as tmp:
        rt = ChatterboxRuntime.create(tmp, force_init=True, device=dev, seed=11)
        cpu = ChatterboxRuntime(_to(rt.params, "cpu"), rt.cfg, rt.weights_dir,
                                torch.device("cpu"))
    cfg = rt.cfg.lm
    # the dense flag is on, but d_model 64 is not eligible: _qdot, as in JAX
    assert cfg.kv_quant and cfg.decode_kernel and cfg.dense_kernel
    gen = torch.Generator().manual_seed(5)
    b, s = 4, 64
    emb = torch.randn((b, s, cfg.d_model), generator=gen) * 0.5
    lens = torch.tensor([64, 40, 3, 21], dtype=torch.int32)
    toks = torch.randint(0, cfg.vocab_size, (12, b), generator=gen)
    # cache_len 256 takes B1 (T-blocked); 200, not a 128-multiple, B1w
    attn = (da.decode_attention_int8_stacked, da.decode_attention_int8_whole_stacked)
    for cache_len, want in ((256, (24, 0)), (200, (0, 24))):
        worst = 0.0
        caches = {}
        for name, r, d in (("gpu", rt, dev), ("cpu", cpu, torch.device("cpu"))):
            lm = r.params["t3"]["lm"]
            before = [w.launches for w in attn]
            logits, cache = tr.prefill(lm, cfg, None, lens.to(d), inputs_embeds=emb.to(d),
                                       cache_len=cache_len)
            steps = [logits.cpu()]
            for i in range(toks.shape[0]):
                logits, cache = tr.decode_step(lm, cfg, toks[i].to(d), cache)
                steps.append(logits.cpu())
            caches[name] = steps
            if name == "gpu":
                launched = tuple(w.launches - n for w, n in zip(attn, before))
        for a, c in zip(caches["gpu"], caches["cpu"]):
            worst = max(worst, ((a - c).abs() / (2e-3 + 2e-3 * c.abs())).max().item())
        log(f"small reference: tiny T3 prefill + 12 teacher-forced decode steps at cache_len "
            f"{cache_len}, GPU kernels vs CPU plain: worst |diff| / (2e-3 + 2e-3|ref|) = "
            f"{worst:.3f} (must be <= 1); B1/B1w launches {launched} (expected {want})")
        if not worst <= 1.0:
            failures.append(f"tiny decode logits differ at cache_len {cache_len}: {worst}")
        if launched != want:
            failures.append(f"tiny decode at cache_len {cache_len}: B1/B1w launches {launched} "
                            f"!= {want}")

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


def small_reference_dense(dev, failures):
    """A d_model-128 transformer (2 layers, 2 heads, d_head 64, d_ff 256,
    f32, int8 weights) with the dense kernels on: prefill + 12 teacher-forced
    decode steps on the GPU through the kernels, against (a) the same GPU
    steps through the dense kernels' plain versions -- the kernels repeat
    their rounding, so DENSE_TOL holds at every step -- and (b) the CPU. On
    (b), an int8 activation on a .5 tie can round the other way under
    another exp or cos and move one row's logits at one step by up to a few
    1e-2; a wrong kernel or path moves most rows at every step. So (b)
    fails if more than a quarter of the (step, row) logit rows are outside
    2e-3 + 2e-3|ref|."""
    from vocalie_tts_tpu_torch.models.common import transformer as tr
    from vocalie_tts_tpu_torch.ops import decode_attention as da
    from vocalie_tts_tpu_torch.ops import decode_dense as dd

    cfg = tr.TransformerConfig(vocab_size=96, d_model=128, n_layers=2, n_heads=2, n_kv_heads=2,
                               d_head=64, d_ff=256, max_seq_len=256, kv_quant=True,
                               decode_kernel=True, dense_kernel=True, dtype=torch.float32)
    gen = torch.Generator(device=dev).manual_seed(12)
    params = tr.fuse_decode_weights(tr.quantize_weights_int8(
        tr.init_params(cfg, generator=gen, device=dev)))
    cpu_params = _to(params, "cpu")
    g = torch.Generator().manual_seed(13)
    b, s, n_steps = 4, 32, 12
    emb = torch.randn((b, s, cfg.d_model), generator=g) * 0.5
    lens = torch.tensor([32, 20, 3, 11], dtype=torch.int32)
    toks = torch.randint(0, cfg.vocab_size, (n_steps, b), generator=g)

    def run(p, d):
        logits, cache = tr.prefill(p, cfg, None, lens.to(d), inputs_embeds=emb.to(d),
                                   cache_len=256)
        steps = [logits.cpu()]
        for i in range(n_steps):
            logits, cache = tr.decode_step(p, cfg, toks[i].to(d), cache)
            steps.append(logits.cpu())
        return steps

    wrappers = (dd.qkv_norm_int8_stacked, dd.tail_swiglu_qkv_int8_stacked, dd.dense_int8_stacked)
    before = [w.launches for w in wrappers]
    kernel = run(params, dev)
    launched = [w.launches - b0 for w, b0 in zip(wrappers, before)]
    kept = (tr.qkv_norm_int8_stacked, tr.tail_swiglu_qkv_int8_stacked, tr.dense_int8_stacked)
    tr.qkv_norm_int8_stacked = dd.qkv_norm_int8_plain
    tr.tail_swiglu_qkv_int8_stacked = dd.tail_swiglu_qkv_int8_plain
    tr.dense_int8_stacked = dd.dense_int8_plain
    try:
        plain = run(params, dev)
    finally:
        (tr.qkv_norm_int8_stacked, tr.tail_swiglu_qkv_int8_stacked,
         tr.dense_int8_stacked) = kept
    cpu = run(cpu_params, torch.device("cpu"))
    want = [n_steps, cfg.n_layers * n_steps, n_steps + 1]
    worst_plain = max(((a - c).abs().max() / (DENSE_TOL * c.abs().max())).item()
                      for a, c in zip(kernel, plain))
    ratios = torch.stack([((a - c).abs() / (2e-3 + 2e-3 * c.abs())).amax(-1)
                          for a, c in zip(kernel, cpu)])
    outside = int((ratios > 1).sum())
    log(f"small reference, dense path (d_model 128, prefill + {n_steps} teacher-forced steps): "
        f"launches B3/B2/B4 = {launched} (expected {want}); GPU kernels vs GPU plain versions: "
        f"worst |diff| / ({DENSE_TOL} x max|ref|) = {worst_plain:.3f} (must be <= 1); GPU vs CPU: "
        f"worst |diff| / (2e-3 + 2e-3|ref|) = {ratios.max().item():.3f}, {outside} of "
        f"{ratios.numel()} (step, row) logit rows outside it (at most a quarter)")
    if launched != want:
        failures.append(f"dense reference launches {launched} != {want}")
    if not worst_plain <= 1.0:
        failures.append(f"dense reference: kernels differ from plain versions by {worst_plain}")
    if outside * 4 > ratios.numel():
        failures.append(f"dense reference: {outside} logit rows differ from the CPU")
    # the same model with the whole layer as one launch (B12)
    set_env(MEGALAYER_ENV)
    try:
        _dense_reference(dev, failures, "d_model 128, d_head 64, VOCALIE_MEGALAYER=1", cfg, params,
                         _megalayer_swaps(), {"qkv_norm_int8_stacked": n_steps,
                                              "layer_swiglu_qkv_int8_stacked":
                                                  cfg.n_layers * n_steps,
                                              "dense_int8_stacked": n_steps + 1})
    finally:
        set_env(DEFAULT_ENV)


def _megalayer_swaps() -> dict:
    """``_dense_reference``'s swaps for the ``VOCALIE_MEGALAYER=1`` step: the
    B3 prologue, B12 per layer, the B4 head."""
    from vocalie_tts_tpu_torch.ops import decode_dense as dd
    from vocalie_tts_tpu_torch.ops import decode_layer as dl

    return {"qkv_norm_int8_stacked": (dd.qkv_norm_int8_stacked, dd.qkv_norm_int8_plain),
            "layer_swiglu_qkv_int8_stacked": (dl.layer_swiglu_qkv_int8_stacked,
                                              dl.layer_swiglu_qkv_int8_plain),
            "dense_int8_stacked": (dd.dense_int8_stacked, dd.dense_int8_plain)}


#: a rounding whose pre-round value lies within TIE_ULPS f32 ulps of its tie
#: (a .5 for int8, the midpoint of two bf16 values for a cache scale) on
#: both devices is a tie: the GPU's and the CPU's f32 sums, means, rsqrt,
#: exp and tanh round apart by a few ulps, so such a value may round either
#: way; a wrong path or product (a TF32 GEMM: ~1e-3 relative) moves
#: pre-round values by thousands of ulps
TIE_ULPS = 64


class _RoundTrace:
    """Every int8 and bf16 rounding of one run, in call order: (decode step,
    kind, the pre-round value, the rounded value), on the CPU. ``int``: each
    ``torch.round`` (the int8 quantizers of the plain versions and of the
    cache); ``bf16``: the int8 cache's scales, ``amax / 127`` rounded to
    bf16 (``transformer._quantize_kv``), recorded before its values."""

    def __init__(self):
        self.calls: list = []
        self.step = 0

    def __enter__(self):
        from vocalie_tts_tpu_torch.models.common import transformer as tr

        self._round, self._quantize_kv = torch.round, tr._quantize_kv

        def traced(x, *a, **k):
            out = self._round(x, *a, **k)
            self.calls.append((self.step, "int", x.detach().float().cpu(),
                               out.detach().float().cpu()))
            return out

        def traced_kv(t):
            amax = t.float().abs().amax(-1)
            s32 = torch.clamp(amax / tr._127(amax), min=1e-8)
            self.calls.append((self.step, "bf16", s32.cpu(), s32.to(torch.bfloat16).float().cpu()))
            return self._quantize_kv(t)

        torch.round, tr._quantize_kv = traced, traced_kv
        return self

    def __exit__(self, *exc):
        from vocalie_tts_tpu_torch.models.common import transformer as tr

        torch.round, tr._quantize_kv = self._round, self._quantize_kv


def _row_of(t: torch.Tensor, r: int, b: int) -> torch.Tensor:
    """Batch row ``r`` of a traced tensor: along its first dim whose size is
    a multiple of ``b`` (b-major: the appended k/v lead with their layers,
    B1's q and p merge (row, kv head))."""
    for dim, n in enumerate(t.shape):
        if n % b == 0:
            grp = n // b
            return t.narrow(dim, r * grp, grp)
    return t


def _ulps_from_tie(x: torch.Tensor, kind: str) -> torch.Tensor:
    """Distance of f32 values from the rounding's tie, in f32 ulps of each
    value: from the nearest .5 (``int``), from the midpoint of two bf16
    neighbours (``bf16``: the low 16 bits at 0x8000)."""
    import numpy as np

    a = np.abs(x.numpy().astype(np.float32))
    if kind == "bf16":
        low = a.view(np.uint32).astype(np.int64) & 0xFFFF
        return torch.from_numpy(np.abs(low - 0x8000).astype(np.float64))
    frac = a.astype(np.float64) - np.floor(a.astype(np.float64))
    return torch.from_numpy(np.abs(frac - 0.5) / np.spacing(a).astype(np.float64))


def _trace_ties(outside, gpu, cpu, b: int, failures, label: str) -> None:
    """For each (step, row) outside the gate, the first rounding of that row
    where the GPU and the CPU runs differ (at or before that step), and its
    pre-round values' distance from the tie in ulps on both devices. Fails
    unless every such row traces to a tie (within ``TIE_ULPS``)."""
    if len(gpu) != len(cpu) or any(g[2].shape != c[2].shape for g, c in zip(gpu, cpu)):
        failures.append(f"{label}: the GPU and CPU runs round different tensors "
                        f"({len(gpu)} against {len(cpu)} calls)")
        return
    first = {}
    for r in sorted({row for _, row in outside}):
        for i, ((step, kind, xg, qg), (_, _, xc, qc)) in enumerate(zip(gpu, cpu)):
            rg, rc = _row_of(qg, r, b), _row_of(qc, r, b)
            if torch.equal(rg, rc):
                continue
            moved = rg != rc
            vg, vc = _row_of(xg, r, b)[moved], _row_of(xc, r, b)[moved]
            ulps = torch.maximum(_ulps_from_tie(vg, kind), _ulps_from_tie(vc, kind))
            first[r] = (step, i, kind, tuple(qg.shape), vg, vc, ulps)
            break
    for step, r in outside:
        if r not in first or first[r][0] > step:
            log(f"  {label}: row {r}, step {step}: no rounding differs before it")
            failures.append(f"{label}: logit row {r} at step {step} leaves the gate with no "
                            "differing rounding before it")
            continue
        t0, i, kind, shape, vg, vc, ulps = first[r]
        tie = bool(ulps.max() <= TIE_ULPS)
        what = "int8 activation" if kind == "int" else "bf16 cache scale"
        log(f"  {label}: row {r}, step {step}: first differing {what} at step {t0} (rounding "
            f"#{i}, {list(shape)}): {vg.numel()} value(s), pre-round GPU {vg[:4].tolist()} CPU "
            f"{vc[:4].tolist()}, distance from the tie {ulps.max().item():.1f} ulps -> "
            f"{'a tie' if tie else 'NOT a tie'}")
        if not tie:
            failures.append(f"{label}: logit row {r} at step {step} traces to a {what} "
                            f"{ulps.max().item():.1f} ulps from its tie (not a tie)")


def _dense_reference(dev, failures, label, cfg, params, swaps, want, *, n_steps=12, seed=13,
                     tie_swaps=None):
    """Prefill (32 positions, 4 rows) + ``n_steps`` teacher-forced decode
    steps of a transformer with the dense kernels on: on the GPU through
    the kernels (``swaps``: name in ``transformer`` → (wrapper, plain
    version); their launches must equal ``want``), against (a) the same GPU
    steps through the plain versions -- the kernels repeat their rounding,
    so ``DENSE_TOL`` holds at every step -- and (b) the same weights on the
    CPU. On (b), an int8 activation on a .5 tie can round the other way
    under another exp, norm or cos and move one row's logits at one step by
    up to a few 1e-2; a wrong kernel or path moves most rows at every step.
    So (b) fails if more than a quarter of the (step, row) logit rows are
    outside 2e-3 + 2e-3|ref| -- or, with ``tie_swaps`` ((module, name) →
    plain version: the kernels the plain-version run still launches), if
    any row outside it does not trace to a tie: the GPU run through every
    plain version and the CPU run, their int8 roundings traced
    (``_trace_ties``)."""
    from vocalie_tts_tpu_torch.models.common import transformer as tr

    cpu_params = _to(params, "cpu")
    g = torch.Generator().manual_seed(seed)
    b, s = 4, 32
    emb = torch.randn((b, s, cfg.d_model), generator=g) * 0.5
    lens = torch.tensor([32, 20, 3, 11], dtype=torch.int32)
    toks = torch.randint(0, min(cfg.vocab_size, 2048), (n_steps, b), generator=g)

    def run(p, d, trace=None):
        logits, cache = tr.prefill(p, cfg, None, lens.to(d), inputs_embeds=emb.to(d),
                                   cache_len=256)
        steps = [logits.cpu()]
        for i in range(n_steps):
            if trace is not None:
                trace.step = i + 1
            logits, cache = tr.decode_step(p, cfg, toks[i].to(d), cache)
            steps.append(logits.cpu())
        return steps

    before = {n: w.launches for n, (w, _) in swaps.items()}
    kernel = run(params, dev)
    launched = {n: w.launches - before[n] for n, (w, _) in swaps.items()}
    kept = {n: getattr(tr, n) for n in swaps}
    for n, (_, plain) in swaps.items():
        setattr(tr, n, plain)
    try:
        plain = run(params, dev)
    finally:
        for n, fn in kept.items():
            setattr(tr, n, fn)
    on_cpu = run(cpu_params, torch.device("cpu"))
    worst_plain = max(((a - c).abs().max() / (DENSE_TOL * c.abs().max())).item()
                      for a, c in zip(kernel, plain))
    ratios = torch.stack([((a - c).abs() / (2e-3 + 2e-3 * c.abs())).amax(-1)
                          for a, c in zip(kernel, on_cpu)])
    outside = int((ratios > 1).sum())
    rule = ("each traced to a tie" if tie_swaps is not None else "at most a quarter")
    log(f"small reference, {label} (prefill + {n_steps} teacher-forced steps): launches "
        f"{launched} (expected {want}); GPU kernels vs GPU plain versions: worst |diff| / "
        f"({DENSE_TOL} x max|ref|) = {worst_plain:.3f} (must be <= 1); GPU vs CPU: worst "
        f"|diff| / (2e-3 + 2e-3|ref|) = {ratios.max().item():.3f}, {outside} of {ratios.numel()} "
        f"(step, row) logit rows outside it ({rule})")
    if launched != want:
        failures.append(f"{label} reference launches {launched} != {want}")
    if not worst_plain <= 1.0:
        failures.append(f"{label} reference: kernels differ from plain versions by {worst_plain}")
    if tie_swaps is None:
        if outside * 4 > ratios.numel():
            failures.append(f"{label} reference: {outside} logit rows differ from the CPU")
        return launched
    kept = {key: getattr(*key) for key in tie_swaps}
    for (mod, name), plain_fn in tie_swaps.items():
        setattr(mod, name, plain_fn)
    try:
        with _RoundTrace() as gpu_trace:
            run(params, dev, gpu_trace)
    finally:
        for (mod, name), fn in kept.items():
            setattr(mod, name, fn)
    with _RoundTrace() as cpu_trace:
        run(cpu_params, torch.device("cpu"), cpu_trace)
    rows = [(int(t), int(r)) for t, r in (ratios > 1).nonzero().tolist()]
    log(f"  {label}: {len(gpu_trace.calls)} roundings traced on each device; rows outside "
        f"the gate (step, row): {rows}")
    _trace_ties(rows, gpu_trace.calls, cpu_trace.calls, b, failures, label)
    return launched


#: phase 3's Qwen3 width: d_model 256, 2 q heads and 1 kv head of 128 (the
#: full model's head width, GQA, the unpacked cache), d_ff 512, 2 layers
QWEN3_SMALL = dict(d_model=256, n_layers=2, n_heads=2, n_kv_heads=1, d_ff=512, max_seq_len=1024,
                   dtype=torch.float32)
#: stage 2's codec embedding gain (see XTTS_VQ_GAIN): the init's table
#: renders a waveform under one int16 step
QWEN3_CODEC_GAIN = 1e4


def _audible_codec(rt):
    rt.params["decoder"]["tok_emb"].mul_(QWEN3_CODEC_GAIN)
    return rt


def small_reference_qwen3(dev, failures):
    """The Qwen3 LM at ``QWEN3_SMALL`` (f32, int8 weights, the default int8
    serving env, random weights from a seed, q/k norm weights away from 1):
    prefill over a 512-position prompt (B6 at d_head 128, group 2) on the
    GPU against the CPU, logits within 2e-3 + 2e-3|ref|; the dense decode
    reference (``_dense_reference``) with ``VOCALIE_MEGATAIL`` unset (B3 +
    L x B2 + B4 a step) and 0 (L x (B3 + B8a) + B4); stage 2 on shared tokens,
    GPU against CPU, PCM within 33 LSB. Then a d_model-128 SwiGLU transformer
    with biases (no family has one; the JAX dispatch then runs B4 for the
    qkv and o-projections and B8b for the MLP): L x B8b and 1 + 2L B4 a step.
    Returns the launches of B8b (the kernel no served path reaches)."""
    from vocalie_tts_tpu_torch.models.common import transformer as tr
    from vocalie_tts_tpu_torch.models.lmtts import runtime as lrt
    from vocalie_tts_tpu_torch.models.lmtts.model import LMTTSConfig
    from vocalie_tts_tpu_torch.ops import decode_dense as dd
    from vocalie_tts_tpu_torch.ops.flash_attention import flash_attention

    set_env(DEFAULT_ENV)
    os.environ["VOCALIE_MODEL_SCALE"] = "d256"
    lrt.SCALES["d256"] = LMTTSConfig(**QWEN3_SMALL)
    with tempfile.TemporaryDirectory() as tmp:
        rt = _audible_codec(lrt.LMTTSRuntime.create(tmp, force_init=True, device=dev, seed=19))
    cfg = rt.cfg.lm
    lm = rt.params["lm_bundle"]["lm"]
    gen = torch.Generator(device=dev).manual_seed(20)
    for name in ("q_norm", "k_norm", "attn_norm", "mlp_norm"):
        lm["layers"][name].copy_(1 + 0.2 * torch.randn(lm["layers"][name].shape, generator=gen,
                                                       device=dev))
    cpu_lm = _to(lm, "cpu")
    g = torch.Generator().manual_seed(21)
    emb = torch.randn((2, 512, cfg.d_model), generator=g) * 0.5
    lens = torch.tensor([512, 300], dtype=torch.int32)
    n0 = flash_attention.launches
    got, _ = tr.prefill(lm, cfg, None, lens.to(dev), inputs_embeds=emb.to(dev), cache_len=640)
    n_flash = flash_attention.launches - n0
    ref, _ = tr.prefill(cpu_lm, cfg, None, lens, inputs_embeds=emb, cache_len=640)
    worst = ((got.cpu() - ref).abs() / (2e-3 + 2e-3 * ref.abs())).max().item()
    log(f"small reference, Qwen3 d_model 256 prefill over 512 positions: B6 launches {n_flash} "
        f"(expected {cfg.n_layers}); GPU vs CPU worst |diff| / (2e-3 + 2e-3|ref|) = {worst:.3f} "
        "(must be <= 1)")
    if n_flash != cfg.n_layers or not worst <= 1.0:
        failures.append(f"Qwen3 512-position prefill: B6 x{n_flash}, worst ratio {worst}")
    swaps = {"qkv_norm_int8_stacked": (dd.qkv_norm_int8_stacked, dd.qkv_norm_int8_plain),
             "tail_swiglu_qkv_int8_stacked": (dd.tail_swiglu_qkv_int8_stacked,
                                              dd.tail_swiglu_qkv_int8_plain),
             "tail_swiglu_int8_stacked": (dd.tail_swiglu_int8_stacked,
                                          dd.tail_swiglu_int8_plain),
             "dense_int8_stacked": (dd.dense_int8_stacked, dd.dense_int8_plain)}
    n, L = 12, cfg.n_layers
    _dense_reference(dev, failures, "Qwen3 d_model 256, default", cfg, lm, swaps,
                     {"qkv_norm_int8_stacked": n, "tail_swiglu_qkv_int8_stacked": L * n,
                      "tail_swiglu_int8_stacked": 0, "dense_int8_stacked": n + 1})
    set_env(MEGATAIL0_ENV)
    _dense_reference(dev, failures, "Qwen3 d_model 256, VOCALIE_MEGATAIL=0", cfg, lm, swaps,
                     {"qkv_norm_int8_stacked": L * n, "tail_swiglu_qkv_int8_stacked": 0,
                      "tail_swiglu_int8_stacked": L * n, "dense_int8_stacked": n + 1})
    set_env(MEGALAYER_ENV)
    _dense_reference(dev, failures, "Qwen3 d_model 256, d_head 128 GQA, VOCALIE_MEGALAYER=1", cfg,
                     lm, _megalayer_swaps(),
                     {"qkv_norm_int8_stacked": n, "layer_swiglu_qkv_int8_stacked": L * n,
                      "dense_int8_stacked": n + 1})
    set_env(DEFAULT_ENV)
    cpu = lrt.LMTTSRuntime(_to(rt.params, "cpu"), rt.cfg, rt.weights_dir, torch.device("cpu"))
    codes = torch.randint(0, 2048, (3, 40), generator=g)
    n_tok = torch.tensor([40, 27, 5])
    pcm_gpu = rt.stage2_pcm16(codes.to(dev), n_tok.to(dev)).cpu()
    pcm_cpu = cpu.stage2_pcm16(codes, n_tok)
    lsb = (pcm_gpu.int() - pcm_cpu.int()).abs().max().item()
    peak = pcm_cpu.int().abs().max().item()
    log(f"small reference: Qwen3 stage 2 (40 tokens x 3 rows, codec decoder x8, HiFi-GAN 512 "
        f"channels, hop 240), GPU vs CPU: max |diff| = {lsb} LSB of int16 (tolerance 33), CPU "
        f"peak {peak}")
    if not lsb <= 33 or peak <= 33:
        failures.append(f"Qwen3 stage-2 PCM: {lsb} LSB off, peak {peak}")

    bcfg = tr.TransformerConfig(vocab_size=96, d_model=128, n_layers=2, n_heads=2, n_kv_heads=2,
                                d_head=64, d_ff=256, max_seq_len=256, kv_quant=True,
                                decode_kernel=True, dense_kernel=True, bias=True, attn_bias=True,
                                dtype=torch.float32)
    gen = torch.Generator(device=dev).manual_seed(22)
    raw = tr.init_params(bcfg, generator=gen, device=dev)
    for name in ("bq", "bk", "bv", "bo", "b_up", "b_down"):
        raw["layers"][name] = 0.2 * torch.randn(raw["layers"][name].shape, generator=gen,
                                                device=dev)
    bparams = tr.fuse_decode_weights(tr.quantize_weights_int8(raw))
    assert tr._dense_dispatch(bparams["layers"], bcfg, 4, 256) == tr.DENSE_FNS
    launched = _dense_reference(
        dev, failures, "biased SwiGLU d_model 128 (B4 + B8b)", bcfg, bparams,
        {"mlp_swiglu_int8_stacked": (dd.mlp_swiglu_int8_stacked, dd.mlp_swiglu_int8_plain),
         "dense_int8_stacked": (dd.dense_int8_stacked, dd.dense_int8_plain)},
        {"mlp_swiglu_int8_stacked": bcfg.n_layers * n,
         "dense_int8_stacked": 1 + n * (1 + 2 * bcfg.n_layers)})
    return launched["mlp_swiglu_int8_stacked"]


def small_reference_noenv(dev, failures):
    """The rows that keep the bf16 weights on small models, GPU against CPU:
    the tiny Chatterbox T3 (d_model 64) and the Qwen3 LM at ``QWEN3_SMALL``
    (d_model 256, 2 q / 1 kv heads of 128), both f32 (so their caches are
    f32), each built in the no-env row (the XLA attention branch, slice
    assignment) and with ``VOCALIE_DECODE_KERNEL=1`` (K1 + K4): prefill + 12
    teacher-forced steps, logits within 2e-3 + 2e-3|ref|; K1 = L x steps and
    K4 = steps with the knob, 0 without; then the no-env T3 runtime's stage 2
    on shared noise, PCM within 33 LSB."""
    import dataclasses

    from vocalie_tts_tpu_torch.models.chatterbox.runtime import ChatterboxRuntime
    from vocalie_tts_tpu_torch.models.common import transformer as tr
    from vocalie_tts_tpu_torch.models.common.token2wav import draw_stage2_noise
    from vocalie_tts_tpu_torch.models.lmtts import runtime as lrt
    from vocalie_tts_tpu_torch.models.lmtts.model import LMTTSConfig
    from vocalie_tts_tpu_torch.ops.cache_update import cache_append_kv_stacked as k4
    from vocalie_tts_tpu_torch.ops.decode_attention import decode_attention_float_stacked as k1

    cpu = torch.device("cpu")

    def teacher_forced(label, cfg, lm, cache_len):
        g = torch.Generator().manual_seed(5)
        b, s, n = 4, 64, 12
        emb = torch.randn((b, s, cfg.d_model), generator=g) * 0.5
        lens = torch.tensor([64, 40, 3, 21], dtype=torch.int32)
        toks = torch.randint(0, min(cfg.vocab_size, 2048), (n, b), generator=g)
        runs = {}
        for name, p, d in (("gpu", lm, dev), ("cpu", _to(lm, "cpu"), cpu)):
            n0 = (k1.launches, k4.launches)
            logits, cache = tr.prefill(p, cfg, None, lens.to(d), inputs_embeds=emb.to(d),
                                       cache_len=cache_len)
            steps = [logits.cpu()]
            for i in range(n):
                logits, cache = tr.decode_step(p, cfg, toks[i].to(d), cache)
                steps.append(logits.cpu())
            runs[name] = steps, (k1.launches - n0[0], k4.launches - n0[1]), cache.k.dtype
        worst = max(((a - c).abs() / (2e-3 + 2e-3 * c.abs())).max().item()
                    for a, c in zip(runs["gpu"][0], runs["cpu"][0]))
        want = (cfg.n_layers * n, n) if cfg.decode_kernel else (0, 0)
        log(f"small reference, {label} (prefill + {n} teacher-forced steps, {runs['gpu'][2]} "
            f"cache): K1/K4 launches {runs['gpu'][1]} (expected {want}); GPU vs CPU worst |diff| "
            f"/ (2e-3 + 2e-3|ref|) = {worst:.3f} (must be <= 1)")
        if not worst <= 1.0 or runs["gpu"][1] != want or cfg.kv_quant:
            failures.append(f"{label} reference: worst ratio {worst}, K1/K4 {runs['gpu'][1]} "
                            f"!= {want}")

    for label, env in (("no env", NOENV_ENV), ("VOCALIE_DECODE_KERNEL=1", DECODE_KERNEL_ENV)):
        set_env(env)
        os.environ["VOCALIE_MODEL_SCALE"] = "tiny"
        with tempfile.TemporaryDirectory() as tmp:
            rt = ChatterboxRuntime.create(tmp, force_init=True, device=dev, seed=11)
        teacher_forced(f"tiny T3, {label}", rt.cfg.lm, rt.params["t3"]["lm"], 256)
        if env is NOENV_ENV:
            host = ChatterboxRuntime(_to(rt.params, "cpu"), rt.cfg, rt.weights_dir, cpu)
            gen = torch.Generator().manual_seed(6)
            gtok = torch.randint(0, rt.cfg.speech_vocab, (3, 140), generator=gen)
            glen = torch.tensor([140, 90, 5], dtype=torch.int32)
            noise = draw_stage2_noise(rt.cfg.t2w, 3, 140, gen, "cpu")
            pcm_cpu = host.stage2_pcm16(gtok, glen, noise)
            pcm_gpu = rt.stage2_pcm16(gtok.to(dev), glen.to(dev), dataclasses.replace(
                noise, **{f.name: getattr(noise, f.name).to(dev)
                          for f in dataclasses.fields(noise)})).cpu()
            lsb = (pcm_gpu.int() - pcm_cpu.int()).abs().max().item()
            log(f"small reference: tiny stage 2 of the no-env runtime on shared noise, GPU vs "
                f"CPU: max |diff| = {lsb} LSB of int16 (tolerance 33)")
            if not lsb <= 33:
                failures.append(f"no-env tiny stage-2 PCM differs by {lsb} LSB")
        os.environ["VOCALIE_MODEL_SCALE"] = "d256"
        lrt.SCALES["d256"] = LMTTSConfig(**QWEN3_SMALL)
        with tempfile.TemporaryDirectory() as tmp:
            q3 = lrt.LMTTSRuntime.create(tmp, force_init=True, device=dev, seed=19)
        teacher_forced(f"Qwen3 d_model 256, {label}", q3.cfg.lm, q3.params["lm_bundle"]["lm"],
                       640)
    set_env(DEFAULT_ENV)


#: the XTTS width of phase 3: the GPT-2 dense path is eligible (d_model and
#: the qkv width 128-multiples, the 1026 vocabulary padded to 1152 for B4)
XTTS_SMALL = dict(d_model=128, n_layers=2, n_heads=2, n_kv_heads=2, d_ff=256, max_seq_len=512,
                  speaker_dim=64, dtype=torch.float32)


def small_reference_xtts(dev, failures):
    """A d_model-128 XTTS (2 layers, 2 heads of 64, d_ff 256, vocab 1026,
    f32) in the default int8 serving env, random weights from a seed, on
    the GPU through B9a + B9b per layer and B4, against (a) the same GPU
    steps through the kernels' plain versions (``DENSE_TOL`` at every
    step), and (b) the same weights on the CPU: prefill + 12 teacher-forced
    decode steps on the prompt ``build_prompt_embeds`` makes, logits within
    2e-3 + 2e-3|ref|. On (b) an int8 activation on a .5 tie rounds the other
    way under another tanh or summation order and moves one row's logits at
    one step by up to a few 1e-2 (a tie in the prompt's k/v moves the rest of
    its row), while a wrong kernel or path moves most rows at every step:
    (b) fails if more than a quarter of the (step, row) logit rows are
    outside. Then stage 2 on shared tokens, GPU against CPU: PCM within 33
    LSB."""
    from vocalie_tts_tpu_torch.models.common import transformer as tr
    from vocalie_tts_tpu_torch.models.xtts import runtime as xrt
    from vocalie_tts_tpu_torch.models.xtts.model import XTTSConfig, build_prompt_embeds
    from vocalie_tts_tpu_torch.ops import decode_dense as dd

    set_env(DEFAULT_ENV)
    os.environ["VOCALIE_MODEL_SCALE"] = "d128"
    xrt.SCALES["d128"] = XTTSConfig(**XTTS_SMALL)
    with tempfile.TemporaryDirectory() as tmp:
        rt = _audible(xrt.XTTSRuntime.create(tmp, force_init=True, device=dev, seed=17))
    cfg = rt.cfg.lm
    assert cfg.dense_kernel and cfg.kv_quant and cfg.decode_kernel
    cpu = xrt.XTTSRuntime(_to(rt.params, "cpu"), rt.cfg, rt.weights_dir, torch.device("cpu"))
    g = torch.Generator().manual_seed(18)
    b, n_steps = 4, 12
    text = torch.randint(0, 260, (b, 40), generator=g)
    spk = torch.nn.functional.normalize(torch.randn((b, 64), generator=g), dim=-1)
    lens = torch.tensor([73, 50, 34, 61], dtype=torch.int32)
    toks = torch.randint(0, 1024, (n_steps, b), generator=g)

    def run(r, d):
        with torch.no_grad():
            emb = build_prompt_embeds(r.params["gpt"], r.cfg, text.to(d), spk.to(d))
            lm = r.params["gpt"]["lm"]
            logits, cache = tr.prefill(lm, cfg, None, lens.to(d), inputs_embeds=emb,
                                       cache_len=256)
            steps = [logits.cpu()]
            for i in range(n_steps):
                logits, cache = tr.decode_step(lm, cfg, toks[i].to(d), cache)
                steps.append(logits.cpu())
        return steps

    wrappers = (dd.qkv_lnorm_int8_stacked, dd.tail_gelu_qkv_int8_stacked, dd.dense_int8_stacked)
    before = [w.launches for w in wrappers]
    kernel = run(rt, dev)
    launched = [w.launches - b0 for w, b0 in zip(wrappers, before)]
    kept = (tr.qkv_lnorm_int8_stacked, tr.tail_gelu_qkv_int8_stacked, tr.dense_int8_stacked)
    tr.qkv_lnorm_int8_stacked = dd.qkv_lnorm_int8_plain
    tr.tail_gelu_qkv_int8_stacked = dd.tail_gelu_qkv_int8_plain
    tr.dense_int8_stacked = dd.dense_int8_plain
    try:
        plain = run(rt, dev)
    finally:
        (tr.qkv_lnorm_int8_stacked, tr.tail_gelu_qkv_int8_stacked, tr.dense_int8_stacked) = kept
    on_cpu = run(cpu, torch.device("cpu"))
    want = [n_steps, cfg.n_layers * n_steps, n_steps + 1]
    worst_plain = max(((a - c).abs().max() / (DENSE_TOL * c.abs().max())).item()
                      for a, c in zip(kernel, plain))
    ratios = torch.stack([((a - c).abs() / (2e-3 + 2e-3 * c.abs())).amax(-1)
                          for a, c in zip(kernel, on_cpu)])
    outside = int((ratios > 1).sum())
    log(f"small reference, XTTS d_model 128 (prefill + {n_steps} teacher-forced steps): launches "
        f"B9a/B9b/B4 = {launched} (expected {want}); GPU kernels vs GPU plain versions: worst "
        f"|diff| / ({DENSE_TOL} x max|ref|) = {worst_plain:.3f} (must be <= 1); GPU vs CPU: worst "
        f"|diff| / (2e-3 + 2e-3|ref|) = {ratios.max().item():.3f}, {outside} of {ratios.numel()} "
        "(step, row) logit rows outside it (at most a quarter)")
    if launched != want:
        failures.append(f"XTTS reference launches {launched} != {want}")
    if not worst_plain <= 1.0:
        failures.append(f"XTTS reference: kernels differ from plain versions by {worst_plain}")
    if outside * 4 > ratios.numel():
        failures.append(f"XTTS reference: {outside} logit rows differ from the CPU")
    vq = torch.randint(0, 1024, (3, 60), generator=g)
    n = torch.tensor([60, 41, 7])
    pcm_gpu = rt.stage2_pcm16(vq.to(dev), n.to(dev), spk[:3].to(dev)).cpu()
    pcm_cpu = cpu.stage2_pcm16(vq, n, spk[:3])
    lsb = (pcm_gpu.int() - pcm_cpu.int()).abs().max().item()
    peak = pcm_cpu.int().abs().max().item()
    log(f"small reference: XTTS stage 2 (60 tokens x 3 rows, HiFi-GAN 512 channels), GPU vs CPU: "
        f"max |diff| = {lsb} LSB of int16 (tolerance 33 = 1e-3 of full scale), CPU peak {peak}")
    if not lsb <= 33:
        failures.append(f"XTTS stage-2 PCM differs by {lsb} LSB")
    if peak <= 33:
        failures.append(f"XTTS stage-2 PCM is silent (peak {peak} LSB)")


def _redraw_zero_convs(tree, gen) -> None:
    """Give every all-zero conv weight (the LDM convention zero-initializes
    each ResBlock's and the UNet's output conv) uniform fan-in weights, in
    place, so that a reference through the UNet does not reduce to its
    skips."""
    if isinstance(tree, dict):
        w = tree.get("w")
        if isinstance(w, torch.Tensor) and w.ndim == 4 and not w.any():
            bound = 1.0 / math.sqrt(w[..., 0].numel())
            w.copy_((torch.rand(w.shape, generator=gen, device=w.device) * 2 - 1) * bound)
        for v in tree.values():
            _redraw_zero_convs(v, gen)
    elif isinstance(tree, list):
        for v in tree:
            _redraw_zero_convs(v, gen)


def small_reference_audiosr(dev, failures):
    """The tiny AudioSR (f32: no int8, no B13) on the GPU against the same
    weights on the CPU: ``enhance_audio`` of a three-window input, 3 DDIM
    steps, the same noise on both sides. Tolerance 1e-3 of the output's
    peak: f32 throughout, the GPU's convolutions sum in another order, and
    the DDIM update amplifies that by the guidance scale."""
    import numpy as np

    from vocalie_tts_tpu_torch.models.audiosr.runtime import AudioSRRuntime

    os.environ["VOCALIE_MODEL_SCALE"] = "tiny"
    with tempfile.TemporaryDirectory() as tmp:
        rt = AudioSRRuntime.create(tmp, force_init=True, device=dev, seed=13)
    _redraw_zero_convs(rt.params, torch.Generator(device=dev).manual_seed(14))
    cpu = AudioSRRuntime(_to(rt.params, "cpu"), rt.cfg, rt.weights_dir, torch.device("cpu"))

    def noise(shape, seed):
        return torch.randn(shape, generator=torch.Generator().manual_seed(int(seed)))

    rt._draw_noise = lambda shape, seed: noise(shape, seed).to(dev)
    cpu._draw_noise = noise
    audio = (0.2 * np.random.default_rng(15).standard_normal(80_000)).astype(np.float32)
    kw = dict(ddim_steps=3, guidance_scale=2.5, seed=4)
    got = rt.enhance_audio(audio, 48000, **kw)
    want = cpu.enhance_audio(audio, 48000, **kw)
    peak = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    log(f"small reference: tiny AudioSR enhance_audio (3 windows, 3 DDIM steps, f32), GPU vs "
        f"CPU: max |diff| = {err:.3e}, output peak {peak:.3e} (tolerance 1e-3 x peak)")
    if not (peak > 0 and err <= 1e-3 * peak and got.shape == want.shape):
        failures.append(f"tiny AudioSR differs: {err} against peak {peak}")


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


#: the kernels of the voice-over path, by the names of PERF.md's table
KERNEL_NAMES = ("B1", "B2", "B3", "B4", "B5", "B6")
#: the training path's kernels, held to 0 on every serving path
TRAIN_ZERO = {"B6t": 0, "B11a": 0, "B11b": 0, "B11a_tc": 0, "B11b_tc": 0}
#: slice 10's kernels, held to 0 on every serving path of the runtimes: they
#: round their caches to 128-multiples (B1w), no family has a GELU MLP under
#: RMSNorm (B9d), and K5 is for JAX's one-array API alone
SLICE10_ZERO = {"B1w": 0, "B9d": 0, "K5": 0}


class DecodeSteps:
    """The decode steps run (``transformer.decode_step.steps``, counted
    where every decode path ends its step) under the launch counters'
    attribute, so that they are reset and read with them: a path without an
    append kernel has its step count too. Not a kernel."""

    def __init__(self):
        from vocalie_tts_tpu_torch.models.common.transformer import decode_step

        self._step = decode_step

    @property
    def launches(self) -> int:
        return self._step.steps

    @launches.setter
    def launches(self, n: int) -> None:
        self._step.steps = n


class TcLaunches:
    """The launches of a flash wrapper (B6, B6t, B11a, B11b) that took the
    tensor-core body, or of B3 or B4 that took their one launch
    (``csrc/dense_int8.cu``, not the old chain) (the wrapper's
    ``tc_launches``), under the launch counters' attribute, so that they are
    reset and read with them. Not a kernel of its own."""

    def __init__(self, wrapper):
        self._wrapper = wrapper

    @property
    def launches(self) -> int:
        return self._wrapper.tc_launches

    @launches.setter
    def launches(self, n: int) -> None:
        self._wrapper.tc_launches = n


#: each flash wrapper's key → the key of its tensor-core launches; B3's and
#: B4's → the key of their one launch's
TC_KEYS = {"B6": "B6tc", "B6t": "B6t_tc", "B11a": "B11a_tc", "B11b": "B11b_tc", "B3": "B3tc",
           "B4": "B4tc"}


def check_tc(label: str, c: dict, failures) -> None:
    """Every B6, B6t, B11a and B11b launch of a full-width path took the
    tensor-core body (bf16 at d 64 or 128), and every B3 and B4 launch the
    one launch of ``csrc/dense_int8.cu`` (no served shape takes the old
    chain): each such count equals the wrapper's."""
    for key, tc in TC_KEYS.items():
        if tc in c and c[tc] != c[key]:
            failures.append(f"[{label}] {tc} (the tensor-core body or one launch) launched "
                            f"{c[tc]} times, {key} {c[key]}")


def _wrappers():
    from vocalie_tts_tpu_torch.ops.cache_update import (
        cache_append_k_stacked,
        cache_append_kv_stacked,
        cache_append_stacked,
    )
    from vocalie_tts_tpu_torch.ops.decode_attention import (
        decode_attention,
        decode_attention_dequant_stacked,
        decode_attention_float_stacked,
        decode_attention_int8_stacked,
        decode_attention_int8_whole_stacked,
    )
    from vocalie_tts_tpu_torch.ops.decode_dense import (
        dense_int8_stacked,
        mlp_gelu_int8_stacked,
        qkv_norm_int8_stacked,
        tail_swiglu_qkv_int8_stacked,
    )
    from vocalie_tts_tpu_torch.ops.decode_layer import layer_swiglu_qkv_int8_stacked
    from vocalie_tts_tpu_torch.ops import flash_attention_bwd as fb
    from vocalie_tts_tpu_torch.ops.flash_attention import flash_attention, flash_attention_lse

    return {**dict(zip(KERNEL_NAMES, (decode_attention_int8_stacked, tail_swiglu_qkv_int8_stacked,
                                      qkv_norm_int8_stacked, dense_int8_stacked,
                                      cache_append_stacked, flash_attention))),
            "B12": layer_swiglu_qkv_int8_stacked, "K1": decode_attention_float_stacked,
            "K2": decode_attention_dequant_stacked, "B10": decode_attention,
            "K4": cache_append_kv_stacked, "B6t": flash_attention_lse,
            "B11a": fb.flash_attention_bwd_dkv, "B11b": fb.flash_attention_bwd_dq,
            "B1w": decode_attention_int8_whole_stacked, "B9d": mlp_gelu_int8_stacked,
            "K5": cache_append_k_stacked, "B6tc": TcLaunches(flash_attention),
            "B6t_tc": TcLaunches(flash_attention_lse),
            "B11a_tc": TcLaunches(fb.flash_attention_bwd_dkv),
            "B11b_tc": TcLaunches(fb.flash_attention_bwd_dq),
            "B3tc": TcLaunches(qkv_norm_int8_stacked), "B4tc": TcLaunches(dense_int8_stacked),
            "steps": DecodeSteps()}


def path_wants(lm, env: dict, steps: int) -> dict:
    """The launches a SwiGLU decode path at batch > 1 needs in ``steps``
    steps, as JAX's ``decode_step`` and ``_decode_step_finish`` choose (B4
    is the head's launch per step; the caller adds prefill's): attention
    through B1 on the int8 cache and K1 on the bf16 cache with the decode
    kernel, else plain PyTorch; B12 in place of B1 + B2 with
    ``VOCALIE_MEGALAYER=1`` on the int8 cache with the decode kernel; the
    append through B5 (int8) or K4 (bf16) with the decode or dense kernels
    on, else slice assignment. K2 and B10 are on no served path, B6t and
    B11 on the training path alone: 0."""
    L = lm.n_layers
    int8_attn = lm.kv_quant and lm.decode_kernel
    mega = int8_attn and lm.dense_kernel and env.get("VOCALIE_MEGALAYER") == "1"
    append = steps if lm.decode_kernel or lm.dense_kernel else 0
    return {"B1": L * steps if int8_attn and not mega else 0,
            "K1": L * steps if lm.decode_kernel and not lm.kv_quant else 0,
            "B12": L * steps if mega else 0,
            "B2": L * steps if lm.dense_kernel and not mega else 0,
            "B3": steps if lm.dense_kernel else 0,
            "B4": steps if lm.dense_kernel else 0,
            "B5": append if lm.kv_quant else 0, "K4": 0 if lm.kv_quant else append,
            "K2": 0, "B10": 0, **TRAIN_ZERO, **SLICE10_ZERO}


def drive_path(dev, failures, label: str, env: dict, requests, scale: str = "full",
               keep: dict | None = None, again: bool = False, lean: bool = False):
    """Build the full-width runtime under ``env``, warm it up on the bench
    script, set every launch counter to 0, run ``requests`` through
    ``run_tts_pipeline``, read the counters (with ``again``, time each
    request once more), and time the bench request's decode and stage 2.
    Returns the counters by kernel and a function that
    runs the profiled windows of ``breakdown`` (kept for after every timed
    phase). With ``keep`` (``{"dir": ...}``), the first request's WAV is
    copied there and its audio and wall seconds recorded (the studio pass
    enhances it). ``lean`` (a configuration after the first, to keep the
    script's time): no warm-up request (the earlier configurations set up
    CUDA and cuBLAS; ``again`` gives the second timing) and no profiled
    stage-2 window (stage 2 runs the same in every decode configuration)."""
    from vocalie_tts_tpu_torch.engines.chatterbox import ChatterboxEngine
    from vocalie_tts_tpu_torch.models.chatterbox import runtime as rt_mod
    from vocalie_tts_tpu_torch.pipeline import run_tts_pipeline

    set_env(env)
    os.environ["VOCALIE_MODEL_SCALE"] = scale
    os.environ["VOCALIE_ALLOW_RANDOM_WEIGHTS"] = "1"
    wrappers = _wrappers()
    prefills = [0]
    real_prefill = rt_mod.prefill

    def counted_prefill(*a, **k):
        prefills[0] += 1
        return real_prefill(*a, **k)

    rt_mod.prefill = counted_prefill
    try:
        with tempfile.TemporaryDirectory() as tmp:
            t0 = time.monotonic()
            engine = ChatterboxEngine(device=dev, assets=os.path.join(tmp, "assets"))
            rt = engine.runtime()
            torch.cuda.synchronize()
            lm = rt.cfg.lm
            log(f"main path [{label}]: full-width runtime built in {time.monotonic() - t0:.2f} s "
                f"(random weights, seed 7; T3 {rt.cfg.n_layers} layers x d_model "
                f"{rt.cfg.d_model}; kv_quant={lm.kv_quant} decode_kernel={lm.decode_kernel} "
                f"dense_kernel={lm.dense_kernel})")
            t0 = time.monotonic()
            for _ in () if lean else (1,):
                warm = run_tts_pipeline(_request(BENCH_SCRIPT, os.path.join(tmp, "warm.wav")),
                                        engine=engine)
                log(f"main path [{label}] warm-up (bench script, first call: CUDA/cuBLAS/cuDNN "
                    f"set-up): audio {warm.meta['total_duration']:.3f} s, "
                    f"wall {time.monotonic() - t0:.3f} s")
            for w in wrappers.values():
                w.launches = 0
            prefills[0] = 0
            per_request = []
            for req_label, script in requests:
                request = _request(script, os.path.join(tmp, f"{len(per_request)}.wav"))
                chunks = request["chunks"]
                before = {k: w.launches for k, w in wrappers.items()}
                t0 = time.monotonic()
                res = run_tts_pipeline(request, engine=engine)
                wall = time.monotonic() - t0
                meta = res.meta
                ok, n_wav, expect = _wav_ok(res, rt, len(chunks))
                bm = meta["backend_meta"]
                launches = {k: w.launches - before[k] for k, w in wrappers.items()}
                log(f"main path [{label}, {req_label}]: {len(chunks)} chunks, prompt bucket "
                    f"{bm['prompt_bucket']}, decode bucket {bm['decode_bucket']}, audio "
                    f"{meta['total_duration']:.3f} s, wall {wall:.3f} s, RTF "
                    f"{meta['total_duration'] / wall:.3f}x, wav ok={ok}, launches {launches}")
                if not ok:
                    failures.append(f"{label} {req_label}: WAV check failed (len {n_wav}, "
                                    f"expected {expect})")
                per_request.append({"prompt_bucket": bm["prompt_bucket"], "launches": launches})
                if keep is not None and len(per_request) == 1:
                    keep["wav"] = shutil.copy(res.out_path, os.path.join(keep["dir"], "vo.wav"))
                    keep.update(audio_s=meta["total_duration"], wall_s=wall, label=label)
            counts = {k: w.launches for k, w in wrappers.items()}
            n_prefill = prefills[0]
            for req_label, script in requests if again else ():
                n0, p0 = wrappers["steps"].launches, prefills[0]
                t0 = time.monotonic()
                again = run_tts_pipeline(_request(script, os.path.join(tmp, "again.wav")),
                                         engine=engine)
                wall = time.monotonic() - t0
                log(f"main path [{label}, {req_label}] again: wall {wall:.3f} s, RTF "
                    f"{again.meta['total_duration'] / wall:.3f}x, audio "
                    f"{again.meta['total_duration']:.3f} s, "
                    f"{wrappers['steps'].launches - n0} decode steps, {prefills[0] - p0} "
                    "prefills (a chunk that fails the runtime's check is decoded again)")
            windows = breakdown(rt, dev, label, stage2_window=not lean)
    finally:
        rt_mod.prefill = real_prefill

    def profile():
        set_env(env)
        windows()

    steps = counts["steps"]
    log(f"main path [{label}]: {steps} decode steps, {n_prefill} prefills, launches {counts}")
    if len(requests) > 1:
        if per_request[1]["prompt_bucket"] != 512:
            failures.append("the long request did not reach the 512 prompt bucket")
        if per_request[1]["launches"]["B6"] == 0:
            failures.append("no flash launch in the 512-bucket request")
    want = path_wants(lm, env, steps)
    if lm.dense_kernel:
        want.update(B4=steps + n_prefill)
    if steps == 0:
        failures.append(f"[{label}] no decode step ran")
    for k, n in want.items():
        if counts[k] != n:
            failures.append(f"[{label}] {k} launched {counts[k]} times, the path needs {n}")
    check_tc(label, counts, failures)
    for k in KERNEL_NAMES:
        if k in want and want[k] == 0:
            continue
        if counts[k] == 0:
            failures.append(f"[{label}] {k} was never launched on the main path")
    return counts, profile


# ── phase 4: the CosyVoice-class paths ───────────────────────────────────

#: scripts/bench_streaming.py's request: its French text, instruct mode
STREAM_TEXT = (
    "Bienvenue dans cette démonstration de synthèse vocale en continu. "
    "Chaque fenêtre de jetons est convertie en audio dès qu'elle est "
    "prête, pour une écoute immédiate pendant que la suite se calcule."
)
COSY_INSTRUCT = "Parle clairement."
#: the whole-step kernel off: batch 1 takes B3 + B1 + B2 per layer
FUSED_STEP0_ENV = {**DEFAULT_ENV, "VOCALIE_FUSED_STEP": "0"}


def _cosy_wrappers() -> dict:
    from vocalie_tts_tpu_torch.ops.decode_step import decode_step_fused_packed

    return {**_wrappers(), "B7": decode_step_fused_packed}


def _cosy_decode(rt, n_steps: int, window: int = 48) -> None:
    """The streaming request's LM work alone: prefill, then ``n_steps``
    decode steps in windows (sampled), synchronized."""
    from vocalie_tts_tpu_torch.models.common.ar_runtime import pad_token_batch
    from vocalie_tts_tpu_torch.models.cosyvoice.model import build_prompt_embeds
    from vocalie_tts_tpu_torch.models.cosyvoice.runtime import PROMPT_BUCKETS

    cfg, dev = rt.cfg, rt.device
    bundle = rt.params["lm_bundle"]
    parts = rt._prompt_ids(STREAM_TEXT, "instruct", COSY_INSTRUCT, "")
    tokens, lengths, _pb, _ = pad_token_batch([parts], prompt_buckets=PROMPT_BUCKETS,
                                              batch_buckets=(1,), extra_positions=2)
    spk = torch.zeros((1, cfg.speaker_dim), device=dev)
    embeds = build_prompt_embeds(bundle, cfg, torch.from_numpy(tokens).to(dev), spk)
    with torch.no_grad():
        cache = rt._stream_prefill(bundle["lm"], embeds, torch.from_numpy(lengths).to(dev),
                                   cache_len=stream_layout()["cache_len"])
        prev = torch.full((1,), cfg.bos_speech, dtype=torch.int64, device=dev)
        done = torch.zeros((1,), dtype=torch.bool, device=dev)
        left = n_steps
        while left > 0:
            w = min(window, left)
            _t, _n, prev, done, cache = rt._stream_window(
                bundle["lm"], cache, prev, done, window=w, eos_token_id=cfg.eos_speech,
                temperature=0.8, top_k=50, generator=rt._gen)
            left -= w
    torch.cuda.synchronize()


def _cosy_stream(engine, rt) -> tuple:
    """The streaming request once: (first packet ms, audio s, wall s,
    packets, every packet's check passed)."""
    import numpy as np

    t0 = time.monotonic()
    first, audio_s, n_pk, ok = None, 0.0, 0, True
    for pcm, sr in engine.synthesize_stream(STREAM_TEXT, engine_id="cosyvoice_instruct",
                                            instruct_text=COSY_INSTRUCT):
        if first is None:
            first = (time.monotonic() - t0) * 1e3
        ok = ok and sr == 24000 and len(pcm) > 0 and bool(np.isfinite(pcm).all()) \
            and float(np.abs(pcm).max()) <= 1.0 and len(pcm) % rt.cfg.samples_per_token == 0
        audio_s += len(pcm) / sr
        n_pk += 1
    return first, audio_s, time.monotonic() - t0, n_pk, ok


def _held_to_phase2(stream, b7_inputs: dict, failures) -> None:
    """Run ``stream`` (the streaming request's warm-up) with B7's inputs
    recorded at every step, and check that phase 2 held the kernel to
    inputs of the same kind: the request's cache length, its bias and norm
    dtypes, and a valid-slot count within the range its steps reach."""
    from vocalie_tts_tpu_torch.models.common import transformer as tr

    real_b7, seen = tr.decode_step_fused_packed, []

    def recording_b7(*a, **k):
        bias = "none" if a[19] is None else str(a[19].dtype)
        seen.append((a[4].shape[3], bias, str(a[16].dtype), (a[8] == 0).sum()))
        return real_b7(*a, **k)

    tr.decode_step_fused_packed = recording_b7
    try:
        stream()
    finally:
        tr.decode_step_fused_packed = real_b7
    if not seen:
        failures.append("cosyvoice streaming: no B7 call to compare with phase 2's inputs")
        return
    kinds = {s[:3] for s in seen}
    valid = [int(s[3]) for s in seen]
    want = (b7_inputs["cache_len"], b7_inputs["bqkv"], b7_inputs["norm"])
    log(f"cosyvoice [streaming, default]: B7's inputs on the path: (cache, q/k/v bias, norm) "
        f"{sorted(kinds)}, valid slots {min(valid)}-{max(valid)} over {len(seen)} steps; phase 2 "
        f"held it to {want}, {b7_inputs['valid_slots']} valid slots")
    if kinds != {want} or not min(valid) <= b7_inputs["valid_slots"] <= max(valid):
        failures.append(f"phase 2 held B7 to inputs the streaming path does not give it: "
                        f"{want}, {b7_inputs['valid_slots']} valid, against {sorted(kinds)}, "
                        f"{min(valid)}-{max(valid)}")


def drive_cosyvoice(dev, failures, b7_inputs: dict, scale: str = "full"):
    """The CosyVoice-class paths at full width: (a) the streaming request,
    default config; (b) the same with ``VOCALIE_FUSED_STEP=0``; (c)
    ``run_tts_pipeline`` on the 8-chunk bench script, default config and
    (d) with ``VOCALIE_MEGALAYER=1`` (``_cosy_offline``); (e) the streaming
    request in the no-env configuration (``_cosy_stream_noenv``). Each is warmed up,
    then driven with every launch counter at 0 just before it and read just
    after; (a)'s warm-up also checks that phase 2 gave B7 the path's kind of
    inputs (``b7_inputs``). Returns the counts by path and a function that
    runs the profiled windows (kept for after every timed phase)."""
    from vocalie_tts_tpu_torch.engines.cosyvoice import CosyVoiceEngine

    set_env(DEFAULT_ENV)
    os.environ["VOCALIE_MODEL_SCALE"] = scale
    os.environ["VOCALIE_ALLOW_RANDOM_WEIGHTS"] = "1"
    wrappers = _cosy_wrappers()
    counts, profiles = {}, []
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.monotonic()
        engine = CosyVoiceEngine(device=dev, assets=os.path.join(tmp, "assets"))
        rt = engine.runtime()
        torch.cuda.synchronize()
        lm = rt.cfg.lm
        log(f"cosyvoice: full-width runtime built in {time.monotonic() - t0:.2f} s (random "
            f"weights, seed 31; LM {lm.n_layers} layers x d_model {lm.d_model}, q/k/v bias "
            f"{lm.attn_bias}; kv_quant={lm.kv_quant} decode_kernel={lm.decode_kernel} "
            f"dense_kernel={lm.dense_kernel})")

        def stream():
            return _cosy_stream(engine, rt)

        for label, env in (("streaming, default", DEFAULT_ENV),
                           ("streaming, VOCALIE_FUSED_STEP=0", FUSED_STEP0_ENV)):
            set_env(env)
            if env is DEFAULT_ENV:
                _held_to_phase2(stream, b7_inputs, failures)   # also the warm-up
            else:
                stream()   # warm-up
            for w in wrappers.values():
                w.launches = 0
            first, audio_s, wall, n_pk, ok = stream()
            c = {k: w.launches for k, w in wrappers.items()}
            steps = c["B5"]
            t0 = time.monotonic()
            _cosy_decode(rt, 0)
            t1 = time.monotonic()
            _cosy_decode(rt, 320)
            t2 = time.monotonic()
            decode_ms = ((t2 - t1) - (t1 - t0)) / 320 * 1e3
            log(f"cosyvoice [{label}]: first packet {first:.1f} ms, audio {audio_s:.3f} s, wall "
                f"{wall:.3f} s, sustained RTF {audio_s / wall:.3f}x, {n_pk} windows, {steps} "
                f"decode steps, audio ok={ok}, launches {c}; decode alone (prefill "
                f"{(t1 - t0) * 1e3:.1f} ms, then 320 steps) {decode_ms:.3f} ms/step")
            if not ok or n_pk == 0:
                failures.append(f"cosyvoice [{label}]: a packet failed its check")
            if env is DEFAULT_ENV:
                # one sustained window's stage 2 (48 tokens: CFM + HiFT + int16)
                toks = torch.randint(0, rt.cfg.speech_vocab, (1, 48), device=dev)
                nv = torch.full((1,), 48, dtype=torch.int32, device=dev)
                spk = torch.zeros((1, rt.cfg.speaker_dim), device=dev)

                def stage2():
                    rt.stage2_pcm16(toks, nv, spk, rt._stage2_noise(1, 48))
                    torch.cuda.synchronize()

                stage2()
                t0 = time.monotonic()
                stage2()
                log(f"cosyvoice [{label}]: one 48-token window's stage 2 "
                    f"{(time.monotonic() - t0) * 1e3:.1f} ms (host clock, synchronized)")
                profiles.append(lambda: _profiled("cosyvoice streaming, one 48-token window's "
                                                  "stage 2", stage2))
            fused = env is DEFAULT_ENV
            want = {"B3": steps, "B4": steps + 1, "B7": steps if fused else 0,
                    "B1": 0 if fused else lm.n_layers * steps,
                    "B2": 0 if fused else lm.n_layers * steps, "K2": 0, "B10": 0, **TRAIN_ZERO,
                    **SLICE10_ZERO}
            for k, n in want.items():
                if c[k] != n:
                    failures.append(f"cosyvoice [{label}] {k} launched {c[k]} times, the path "
                                    f"needs {n}")
            check_tc(f"cosyvoice {label}", c, failures)
            if steps == 0:
                failures.append(f"cosyvoice [{label}]: no decode step ran")
            counts[label] = c

            def windows(label=label, env=env):
                set_env(env)
                n0 = _profiled(f"cosyvoice {label}, prefill alone", lambda: _cosy_decode(rt, 0))
                n32 = _profiled(f"cosyvoice {label}, prefill + 32 decode steps",
                                lambda: _cosy_decode(rt, 32, window=32))
                if n0 and n32:
                    log(f"breakdown [cosyvoice {label}]: {(n32 - n0) / 32:.1f} device operations "
                        "per decode step")

            profiles.append(windows)

        request = {**_request(BENCH_SCRIPT, os.path.join(tmp, "cosy.wav")),
                   "tts_backend": "cosyvoice",
                   "engine_params": {"engine_id": "cosyvoice_instruct",
                                     "instruct_text": COSY_INSTRUCT}}
        for label, env in (("offline", DEFAULT_ENV),
                           ("offline, VOCALIE_MEGALAYER=1", MEGALAYER_ENV)):
            set_env(env)
            counts[label] = _cosy_offline(engine, rt, request, tmp, label, env, wrappers,
                                          failures)
        counts["streaming, no env"] = _cosy_stream_noenv(dev, failures, tmp, wrappers, profiles)
        set_env(DEFAULT_ENV)

    def profile():
        for windows in profiles:
            windows()

    return counts, profile


def _cosy_stream_noenv(dev, failures, tmp, wrappers, profiles) -> dict:
    """The streaming request in the JAX package's no-env configuration (a
    bf16 cache, bf16 weights, the XLA attention branch in plain PyTorch, no
    kernel on the decode step): a runtime of its own (random weights, seed
    31), driven with the counters at 0 (no warm-up: the earlier streaming
    requests set up CUDA and cuBLAS), read, streamed once more;
    every packet checked; B1-B7, B12, K1 and K4 must not launch. Its
    profiled windows join ``profiles``."""
    from vocalie_tts_tpu_torch.engines.cosyvoice import CosyVoiceEngine

    label = "streaming, no env"
    set_env(NOENV_ENV)
    engine = CosyVoiceEngine(device=dev, assets=os.path.join(tmp, "assets_noenv"))
    rt = engine.runtime()
    lm = rt.cfg.lm
    assert not (lm.kv_quant or lm.decode_kernel or lm.dense_kernel)

    for w in wrappers.values():
        w.launches = 0
    first, audio_s, wall, n_pk, ok = _cosy_stream(engine, rt)
    c = {k: w.launches for k, w in wrappers.items()}
    first2, _, wall2, _, ok2 = _cosy_stream(engine, rt)
    t0 = time.monotonic()
    _cosy_decode(rt, 0)
    t1 = time.monotonic()
    _cosy_decode(rt, 320)
    decode_ms = ((time.monotonic() - t1) - (t1 - t0)) / 320 * 1e3
    steps = c["steps"]
    log(f"cosyvoice [{label}]: first packet {first:.1f} ms, audio {audio_s:.3f} s, wall "
        f"{wall:.3f} s, sustained RTF {audio_s / wall:.3f}x, {n_pk} windows, {steps} decode "
        f"steps, audio ok={ok and ok2}, launches {c}; the request again: first packet "
        f"{first2:.1f} ms, wall {wall2:.3f} s, RTF {audio_s / wall2:.3f}x; decode alone "
        f"(prefill {(t1 - t0) * 1e3:.1f} ms, then 320 steps) {decode_ms:.3f} ms/step")
    if not (ok and ok2) or n_pk == 0 or steps == 0:
        failures.append(f"cosyvoice [{label}]: a packet failed its check or no step ran")
    for k in ("B1", "B2", "B3", "B4", "B5", "B7", "B12", "K1", "K2", "B10", "K4"):
        if c[k] != 0:
            failures.append(f"cosyvoice [{label}] {k} launched {c[k]} times, the path needs 0")
    check_tc(f"cosyvoice {label}", c, failures)

    def windows():
        set_env(NOENV_ENV)
        n0 = _profiled(f"cosyvoice {label}, prefill alone", lambda: _cosy_decode(rt, 0))
        n32 = _profiled(f"cosyvoice {label}, prefill + 32 decode steps",
                        lambda: _cosy_decode(rt, 32, window=32))
        if n0 and n32:
            log(f"breakdown [cosyvoice {label}]: {(n32 - n0) / 32:.1f} device operations per "
                "decode step")

    profiles.append(windows)
    return {**c, "first_packet_ms": first, "sustained_rtf": audio_s / wall, "wall2_s": wall2,
            "decode_ms_per_step": decode_ms}


def _cosy_offline(engine, rt, request, tmp, label, env, wrappers, failures) -> dict:
    """The offline bench request through ``run_tts_pipeline`` under ``env``:
    warmed up, driven with the launch counters at 0, read, timed once more;
    its WAV and launch counts checked (``VOCALIE_MEGALAYER=1``: L x B12 a
    step instead of L x (B1 + B2)). Returns the counts."""
    import numpy as np

    from vocalie_tts_tpu_torch.io.wavio import read_wav
    from vocalie_tts_tpu_torch.pipeline import run_tts_pipeline

    lm = rt.cfg.lm
    run_tts_pipeline({**request, "out_path": os.path.join(tmp, "warm.wav")}, engine=engine)
    for w in wrappers.values():
        w.launches = 0
    t0 = time.monotonic()
    res = run_tts_pipeline(request, engine=engine)
    wall = time.monotonic() - t0
    c = {k: w.launches for k, w in wrappers.items()}
    t0 = time.monotonic()
    run_tts_pipeline({**request, "out_path": os.path.join(tmp, "again.wav")}, engine=engine)
    wall2 = time.monotonic() - t0
    wav, sr = read_wav(res.out_path)
    meta, chunks = res.meta, request["chunks"]
    expect = round(sum(meta["durations"]) * 24000) + int(24000 * 0.25) * (len(chunks) - 1)
    ok = (sr == 24000 and len(wav) == expect and len(wav) > 0
          and bool(np.isfinite(wav).all())
          and all(round(dur * 24000) % rt.cfg.samples_per_token == 0
                  for dur in meta["durations"]))
    steps = c["B5"]
    bm = meta["backend_meta"]
    log(f"cosyvoice [{label}, bench 8-chunk]: {len(chunks)} chunks, prompt bucket "
        f"{bm['prompt_bucket']}, decode bucket {bm['decode_bucket']}, audio "
        f"{meta['total_duration']:.3f} s, wall {wall:.3f} s, RTF "
        f"{meta['total_duration'] / wall:.3f}x (the request again: wall {wall2:.3f} s), "
        f"{steps} decode steps, wav ok={ok}, launches {c}")
    if not ok:
        failures.append(f"cosyvoice {label}: WAV check failed (len {len(wav)}, expected "
                        f"{expect})")
    mega = env is MEGALAYER_ENV
    L = lm.n_layers
    want = {"B1": 0 if mega else L * steps, "B2": 0 if mega else L * steps, "B3": steps,
            "B4": steps + 1, "B7": 0, "B12": L * steps if mega else 0, "K2": 0, "B10": 0,
            **TRAIN_ZERO, **SLICE10_ZERO}
    for k, n in want.items():
        if c[k] != n:
            failures.append(f"cosyvoice {label} {k} launched {c[k]} times, the path needs {n}")
    check_tc(f"cosyvoice {label}", c, failures)
    for k in (("B12",) if mega else ("B1", "B2")) + ("B3", "B4", "B5", "B6"):
        if c[k] == 0:
            failures.append(f"cosyvoice {label}: {k} was never launched")
    return {**c, "steps": steps, "rtf": meta["total_duration"] / wall, "wall_s": wall,
            "wall2_s": wall2}


# ── phase 4: the XTTS-class voice clone ──────────────────────────────────

#: scripts/bench_engine.py's request: its sentence, 8 chunks, its engine
#: params and its 3 s tone reference (bench_engine.py:33-36, :39, :66-77)
XTTS_SENT = (
    "La synthèse vocale sur accélérateur dédié transforme le flux de "
    "production des livres audio et des documentaires en français."
)
XTTS_PARAMS = {"language": "fr", "temperature": 0.65}
#: BASELINE #2, "single chunk": LONG_CHUNK as the one marked chunk of its
#: request (> 250 text bytes: its prompt takes the 544 bucket)
XTTS_LONG = LONG_CHUNK + "\n[[CHUNK]]"
MEGATAIL0_ENV = {**DEFAULT_ENV, "VOCALIE_MEGATAIL": "0"}
#: The init draws stage 2's VQ embedding at std 0.02, which renders a
#: waveform of peak ~5e-6 of full scale: under one int16 step, so every
#: random-weight WAV would be all zeros. The smoke multiplies that table
#: (still drawn from the seed) by this gain, so that the PCM checks see
#: sound: the chain up to the vocoder's final tanh is linear in it.
XTTS_VQ_GAIN = 1e4


def _audible(rt):
    rt.params["decoder"]["tok_emb"].mul_(XTTS_VQ_GAIN)
    return rt


def _xtts_wrappers() -> dict:
    from vocalie_tts_tpu_torch.ops import decode_dense as dd

    return {**_cosy_wrappers(), "B9a": dd.qkv_lnorm_int8_stacked,
            "B9b": dd.tail_gelu_qkv_int8_stacked, "B9c": dd.tail_gelu_int8_stacked}


def _write_tone_ref(path: str) -> str:
    import numpy as np

    from vocalie_tts_tpu_torch.io.wavio import write_wav

    t = np.arange(3 * 24000) / 24000.0
    ref = (0.2 * np.sin(2 * np.pi * 180 * t) * (0.6 + 0.4 * np.sin(2 * np.pi * 3 * t)))
    write_wav(path, ref.astype(np.float32), 24000)
    return path


def _xtts_decode(rt, texts, spk, n_steps: int) -> None:
    """A request's LM work alone (``spk``: its speaker embedding): prompt,
    prefill, then ``n_steps`` sampled decode steps, synchronized."""
    import numpy as np

    from vocalie_tts_tpu_torch.models.xtts.model import BOS_VQ, EOS_VQ, build_prompt_embeds
    from vocalie_tts_tpu_torch.ops.kv_cache import round_cache_len

    dev = rt.device
    tokens, lengths, pb, bb, db = rt._prepare_prompt(texts, "fr")
    spk = torch.from_numpy(np.tile(spk[None], (bb, 1))).to(dev)
    with torch.no_grad():
        embeds = build_prompt_embeds(rt.params["gpt"], rt.cfg, torch.from_numpy(tokens).to(dev),
                                     spk)
    rt._generate(rt.params["gpt"]["lm"], embeds, torch.from_numpy(lengths).to(dev),
                 cache_len=round_cache_len(pb + db), max_new=n_steps, eos_token_id=EOS_VQ,
                 temperature=0.65, top_k=50, top_p=0.85, repetition_penalty=2.0,
                 first_token=BOS_VQ, generator=rt._gen)
    torch.cuda.synchronize()


def drive_xtts(dev, failures, scale: str = "full"):
    """The XTTS-class voice clone at full width (random weights from seed
    23), through ``run_tts_pipeline`` with ``tts_backend: "xtts"`` and a 3 s
    reference: (a) bench_engine.py's 8-chunk request in the default int8
    env (B9a + 24 x (B1 + B9b) + B5 + B4 a step); (b) the same with
    ``VOCALIE_MEGATAIL=0`` (24 x (B9a + B1 + B9c)); (c) one long chunk at
    batch 1 (BASELINE #2), whose prompt takes the 544 bucket, so prefill
    runs causal B6, and which must not reach B7. Each is warmed up, then
    driven with every launch counter at 0 just before it and read just
    after. Returns the counts by request and a function that runs the
    profiled decode windows (kept for after every timed phase)."""
    import numpy as np

    from vocalie_tts_tpu_torch.engines.xtts import XTTSEngine
    from vocalie_tts_tpu_torch.io.wavio import read_wav
    from vocalie_tts_tpu_torch.pipeline import run_tts_pipeline

    set_env(DEFAULT_ENV)
    os.environ["VOCALIE_MODEL_SCALE"] = scale
    os.environ["VOCALIE_ALLOW_RANDOM_WEIGHTS"] = "1"
    wrappers = _xtts_wrappers()
    bench = "\n[[CHUNK]]\n".join([XTTS_SENT] * 8)
    counts, profiles = {}, []
    with tempfile.TemporaryDirectory() as tmp:
        ref = _write_tone_ref(os.path.join(tmp, "bench_ref.wav"))
        t0 = time.monotonic()
        engine = XTTSEngine(device=dev, assets=os.path.join(tmp, "assets"))
        rt = _audible(engine.runtime())
        spk = rt._spk_cache.get(ref)
        torch.cuda.synchronize()
        lm = rt.cfg.lm
        log(f"xtts: full-width runtime built in {time.monotonic() - t0:.2f} s (random weights, "
            f"seed 23; GPT {lm.n_layers} layers x d_model {lm.d_model}, d_ff {lm.d_ff}, "
            f"{lm.norm_type} norm, {lm.mlp_type}, {lm.pos_type} positions; kv_quant={lm.kv_quant} "
            f"decode_kernel={lm.decode_kernel} dense_kernel={lm.dense_kernel})")
        for label, env, script in (("bench 8-chunk, default", DEFAULT_ENV, bench),
                                   ("bench 8-chunk, VOCALIE_MEGATAIL=0", MEGATAIL0_ENV, bench),
                                   ("one chunk at batch 1, 544 bucket", DEFAULT_ENV, XTTS_LONG)):
            set_env(env)
            request = {**_request(script, os.path.join(tmp, "x.wav")), "tts_backend": "xtts",
                       "voice_ref_path": ref, "engine_params": XTTS_PARAMS}
            t0 = time.monotonic()
            # the runtime is warmed up by its first request; the second
            # timing ("again") follows every counted run
            if script is bench and env is DEFAULT_ENV:
                run_tts_pipeline({**request, "out_path": os.path.join(tmp, "warm.wav")},
                                 engine=engine)
            warm = time.monotonic() - t0
            for w in wrappers.values():
                w.launches = 0
            t0 = time.monotonic()
            res = run_tts_pipeline(request, engine=engine)
            wall = time.monotonic() - t0
            c = {k: w.launches for k, w in wrappers.items()}
            # the same request once more, for the spread of the host-clock wall
            t0 = time.monotonic()
            run_tts_pipeline({**request, "out_path": os.path.join(tmp, "again.wav")},
                             engine=engine)
            wall2 = time.monotonic() - t0
            wav, sr = read_wav(res.out_path)
            meta, chunks = res.meta, request["chunks"]
            expect = round(sum(meta["durations"]) * 24000) + int(24000 * 0.25) * (len(chunks) - 1)
            ok = (sr == 24000 and len(wav) == expect and len(wav) > 0
                  and bool(np.isfinite(wav).all()) and int(np.count_nonzero(wav)) > 0
                  and all(round(dur * 24000) % 1024 == 0 for dur in meta["durations"]))
            steps = c["B5"]
            bm = meta["backend_meta"]
            texts = [XTTS_SENT] * 8 if script == bench else [LONG_CHUNK]
            _xtts_decode(rt, texts, spk, 0)
            t1 = time.monotonic()
            _xtts_decode(rt, texts, spk, 0)
            t2 = time.monotonic()
            n0 = wrappers["B5"].launches
            _xtts_decode(rt, texts, spk, bm["decode_bucket"])
            t3 = time.monotonic()
            n_dec = max(wrappers["B5"].launches - n0, 1)   # one KV append per step
            decode_ms = ((t3 - t2) - (t2 - t1)) / n_dec * 1e3
            log(f"xtts [{label}]: warm-up {warm:.3f} s; {len(chunks)} chunks, prompt bucket "
                f"{bm['prompt_bucket']}, decode bucket {bm['decode_bucket']}, audio "
                f"{meta['total_duration']:.3f} s, wall {wall:.3f} s, RTF "
                f"{meta['total_duration'] / wall:.3f}x (the request again: wall {wall2:.3f} s), "
                f"{steps} decode steps, wav ok={ok} "
                f"({len(wav)} samples, {int(np.count_nonzero(wav))} non-zero, peak "
                f"{float(np.abs(wav).max()):.6f}), launches {c}; decode alone (prefill "
                f"{(t2 - t1) * 1e3:.1f} ms, then {n_dec} steps) "
                f"{decode_ms:.3f} ms/step")
            if not ok:
                failures.append(f"xtts [{label}]: WAV check failed (len {len(wav)}, expected "
                                f"{expect})")
            L = lm.n_layers
            if env is MEGATAIL0_ENV:
                want = {"B9a": L * steps, "B9c": L * steps, "B9b": 0}
            else:
                want = {"B9a": steps, "B9b": L * steps, "B9c": 0}
            want.update(B1=L * steps, B4=steps + 1, B7=0, B2=0, B3=0, K2=0, B10=0, **TRAIN_ZERO,
                        **SLICE10_ZERO)
            if script == XTTS_LONG and bm["prompt_bucket"] != 544:
                failures.append(f"xtts [{label}]: prompt bucket {bm['prompt_bucket']}, not 544")
            if script == XTTS_LONG and c["B6"] == 0:
                failures.append(f"xtts [{label}]: no flash launch in the 544-bucket prefill")
            for k, n in want.items():
                if c[k] != n:
                    failures.append(f"xtts [{label}] {k} launched {c[k]} times, the path needs {n}")
            check_tc(f"xtts {label}", c, failures)
            if steps == 0:
                failures.append(f"xtts [{label}]: no decode step ran")
            counts[label] = c

            def windows(label=label, env=env, texts=texts):
                set_env(env)
                n0 = _profiled(f"xtts {label}, prefill alone",
                               lambda: _xtts_decode(rt, texts, spk, 0))
                n32 = _profiled(f"xtts {label}, prefill + 32 decode steps",
                                lambda: _xtts_decode(rt, texts, spk, 32))
                if n0 and n32:
                    log(f"breakdown [xtts {label}]: {(n32 - n0) / 32:.1f} device operations per "
                        "decode step")

            profiles.append(windows)

    def profile():
        for windows in profiles:
            windows()

    return counts, profile


# ── phase 4: the Qwen3-class LLM-TTS ─────────────────────────────────────

#: scripts/bench_engine.py's qwen3 request: its sentence (XTTS_SENT) x 8,
#: its engine params and its 3 s tone reference, which the engine's mode
#: resolution turns into voice_clone (a reference, ``qwen3_mode`` unset)
QWEN3_PARAMS = {"language": "fr"}
#: an explicit voice_clone with the reference's transcript prepended
QWEN3_CLONE = {"qwen3_mode": "voice_clone", "x_vector_only_mode": False,
               "ref_text": "Une voix de référence pour le clonage."}
#: one chunk of > 509 text bytes at batch 1: its prompt takes the 512 bucket
#: (the speaker, language and BOS slots make 3 more), so prefill runs B6
QWEN3_LONG = " ".join([LONG_CHUNK] * 2) + "\n[[CHUNK]]"
QWEN3_DESIGN = {"qwen3_mode": "voice_design", "instruct": "Voix grave, posée et chaleureuse."}


#: requests of earlier slices timed once, without their decode alone, to
#: keep the script's time (their launch counts and WAVs are still checked)
QWEN3_LEAN = ("voice_clone with transcript, 8 chunks", "voice_design, one chunk",
              "one chunk at batch 1, 512 bucket, custom_voice, VOCALIE_MEGALAYER=1")


def _weights_key(env: dict) -> tuple:
    """The knobs a runtime reads when it is built (the cache format, the
    weight format and the kernel flags): requests whose keys differ need
    runtimes of their own."""
    return tuple(env.get(k) for k in ("VOCALIE_KV_INT8", "VOCALIE_WEIGHT_INT8",
                                      "VOCALIE_DECODE_KERNEL", "VOCALIE_DENSE_KERNEL"))


def _qwen3_wrappers() -> dict:
    from vocalie_tts_tpu_torch.ops import decode_dense as dd

    return {**_cosy_wrappers(), "B8a": dd.tail_swiglu_int8_stacked,
            "B8b": dd.mlp_swiglu_int8_stacked}


def _qwen3_decode(rt, texts, n_steps: int, spk) -> None:
    """A request's LM work alone (``spk``: its speaker vector): prompt,
    prefill, then ``n_steps`` sampled decode steps, synchronized."""
    from vocalie_tts_tpu_torch.ops.kv_cache import round_cache_len

    tokens, lengths, pb, _, db = rt.prepare(texts, mode="custom_voice", instruct="", ref_text="",
                                            x_vector_only=True)
    embeds = rt.prompt_embeds(tokens, spk, "French")
    rt._generate(rt.params["lm_bundle"]["lm"], embeds, torch.from_numpy(lengths).to(rt.device),
                 cache_len=round_cache_len(pb + db), max_new=n_steps, eos_token_id=rt.cfg.eos_audio,
                 temperature=0.8, top_k=50, first_token=rt.cfg.bos_audio, generator=rt._gen)
    torch.cuda.synchronize()


def drive_qwen3(dev, failures, scale: str = "full"):
    """The Qwen3-class LLM-TTS at full width (1.7B, random weights from seed
    11; stage 2's codec embedding raised by ``QWEN3_CODEC_GAIN``) through
    ``run_tts_pipeline`` with ``tts_backend: "qwen3"``: (a) bench_engine.py's
    8-chunk request (voice_clone from its 3 s reference) in the default int8
    env (B3 + 28 x (B1 + B2) + B5 + B4 a step) and (b) with
    ``VOCALIE_MEGATAIL=0`` (28 x (B3 + B1 + B8a)); (c) an explicit voice_clone
    with the reference's transcript; (d) one chunk of > 509 bytes at batch 1
    in custom_voice (the 512 bucket: B6 in prefill; never B7); (e) a
    voice_design request; (a) and (d) again with ``VOCALIE_MEGALAYER=1``
    (B3 + 28 x B12 + B5 + B4 a step, B1 = B2 = 0); (d) again with
    ``VOCALIE_DECODE_KERNEL=1`` on a runtime with bf16 weights (28 x K1 + K4
    a step). Each is warmed up, then driven with every launch
    counter at 0 just before it and read just after, then timed once more.
    Returns the counts by request and a function that runs the profiled
    decode windows (kept for after every timed phase)."""
    import numpy as np

    from vocalie_tts_tpu_torch.engines.qwen3 import Qwen3Engine
    from vocalie_tts_tpu_torch.io.wavio import read_wav
    from vocalie_tts_tpu_torch.models.common.weights import tree_items
    from vocalie_tts_tpu_torch.pipeline import run_tts_pipeline
    from vocalie_tts_tpu_torch.text import render_clean_text_from_segments

    set_env(DEFAULT_ENV)
    os.environ["VOCALIE_MODEL_SCALE"] = scale
    os.environ["VOCALIE_ALLOW_RANDOM_WEIGHTS"] = "1"
    wrappers = _qwen3_wrappers()
    bench = "\n[[CHUNK]]\n".join([XTTS_SENT] * 8)
    counts, profiles = {}, []
    with tempfile.TemporaryDirectory() as tmp:
        ref = _write_tone_ref(os.path.join(tmp, "bench_ref.wav"))
        t0 = time.monotonic()
        engine = Qwen3Engine(device=dev, assets=os.path.join(tmp, "assets"))
        rt = _audible_codec(engine.runtime())
        torch.cuda.synchronize()
        lm = rt.cfg.lm
        n_params = sum(v.numel() for _, v in tree_items(rt.params["lm_bundle"]))
        log(f"qwen3: full-width runtime built in {time.monotonic() - t0:.2f} s (random weights, "
            f"seed 11; LM {lm.n_layers} layers x d_model {lm.d_model}, {lm.n_heads} q / "
            f"{lm.n_kv_heads} kv heads of {lm.d_head}, d_ff {lm.d_ff}, qk_norm={lm.qk_norm}, "
            f"vocab {lm.vocab_size}; {n_params / 1e9:.3f} G LM-bundle parameters; kv_quant="
            f"{lm.kv_quant} decode_kernel={lm.decode_kernel} dense_kernel={lm.dense_kernel})")
        runs = (("bench 8-chunk voice_clone, default", DEFAULT_ENV, bench, QWEN3_PARAMS, ref),
                ("bench 8-chunk voice_clone, VOCALIE_MEGATAIL=0", MEGATAIL0_ENV, bench,
                 QWEN3_PARAMS, ref),
                ("voice_clone with transcript, 8 chunks", DEFAULT_ENV, bench, QWEN3_CLONE, ref),
                ("one chunk at batch 1, 512 bucket, custom_voice", DEFAULT_ENV, QWEN3_LONG,
                 {"qwen3_mode": "custom_voice", "speaker": "Vivian"}, None),
                ("voice_design, one chunk", DEFAULT_ENV, XTTS_SENT + "\n[[CHUNK]]", QWEN3_DESIGN,
                 None),
                ("bench 8-chunk voice_clone, VOCALIE_MEGALAYER=1", MEGALAYER_ENV, bench,
                 QWEN3_PARAMS, ref),
                ("one chunk at batch 1, 512 bucket, custom_voice, VOCALIE_MEGALAYER=1",
                 MEGALAYER_ENV, QWEN3_LONG, {"qwen3_mode": "custom_voice", "speaker": "Vivian"},
                 None),
                ("one chunk at batch 1, 512 bucket, custom_voice, VOCALIE_DECODE_KERNEL=1",
                 DECODE_KERNEL_ENV, QWEN3_LONG,
                 {"qwen3_mode": "custom_voice", "speaker": "Vivian"}, None))
        engines = {_weights_key(DEFAULT_ENV): (engine, rt)}
        warmed = set()
        for label, env, script, params, voice in runs:
            set_env(env)
            if _weights_key(env) not in engines:
                # another cache or weight format: a runtime of its own (seed 11)
                e2 = Qwen3Engine(device=dev, assets=os.path.join(tmp, f"assets{len(engines)}"))
                engines[_weights_key(env)] = (e2, _audible_codec(e2.runtime()))
            engine, rt = engines[_weights_key(env)]
            lm = rt.cfg.lm
            request = {**_request(script, os.path.join(tmp, "q.wav")), "tts_backend": "qwen3",
                       "voice_ref_path": voice, "engine_params": params}
            t0 = time.monotonic()
            # each runtime is warmed up by its first request; the second
            # timing ("again") follows every counted run
            if id(engine) not in warmed:
                warmed.add(id(engine))
                run_tts_pipeline({**request, "out_path": os.path.join(tmp, "warm.wav")},
                                 engine=engine)
            warm = time.monotonic() - t0
            for w in wrappers.values():
                w.launches = 0
            t0 = time.monotonic()
            res = run_tts_pipeline(request, engine=engine)
            wall = time.monotonic() - t0
            c = {k: w.launches for k, w in wrappers.items()}
            lean = label in QWEN3_LEAN
            wall2 = decode_ms = None
            t0 = time.monotonic()
            for _ in () if lean else (1,):
                run_tts_pipeline({**request, "out_path": os.path.join(tmp, "again.wav")},
                                 engine=engine)
                wall2 = time.monotonic() - t0
            wav, sr = read_wav(res.out_path)
            meta, chunks = res.meta, request["chunks"]
            bm = meta["backend_meta"]
            expect = round(sum(meta["durations"]) * 24000) + int(24000 * 0.25) * (len(chunks) - 1)
            ok = (sr == 24000 and len(wav) == expect and len(wav) > 0
                  and bool(np.isfinite(wav).all()) and int(np.count_nonzero(wav)) > 0
                  and all(round(dur * 24000) % 1920 == 0 for dur in meta["durations"]))
            steps = c["steps"]
            texts = [render_clean_text_from_segments(ch.segments) for ch in chunks]
            mode = bm["qwen3_mode"]
            spk = rt.speaker_embedding(mode, "Vivian", voice)
            alone = "decode alone: not timed (a row cut to keep the script's time)"
            for _ in () if lean else (1,):
                _qwen3_decode(rt, texts, 0, spk)
                t1 = time.monotonic()
                _qwen3_decode(rt, texts, 0, spk)
                t2 = time.monotonic()
                n0 = wrappers["steps"].launches
                _qwen3_decode(rt, texts, bm["decode_bucket"], spk)
                t3 = time.monotonic()
                n_dec = max(wrappers["steps"].launches - n0, 1)
                decode_ms = ((t3 - t2) - (t2 - t1)) / n_dec * 1e3
                alone = (f"decode alone (prefill {(t2 - t1) * 1e3:.1f} ms, then {n_dec} steps) "
                         f"{decode_ms:.3f} ms/step")
            again = "not timed" if wall2 is None else f"wall {wall2:.3f} s"
            log(f"qwen3 [{label}]: warm-up {warm:.3f} s; {len(chunks)} chunks, mode {mode}, "
                f"prompt bucket {bm['prompt_bucket']}, decode bucket {bm['decode_bucket']}, audio "
                f"{meta['total_duration']:.3f} s, wall {wall:.3f} s, RTF "
                f"{meta['total_duration'] / wall:.3f}x (the request again: {again}), "
                f"{steps} decode steps, wav ok={ok} ({len(wav)} samples, "
                f"{int(np.count_nonzero(wav))} non-zero, peak {float(np.abs(wav).max()):.6f}), "
                f"launches {c}; {alone}")
            if not ok:
                failures.append(f"qwen3 [{label}]: WAV check failed (len {len(wav)}, expected "
                                f"{expect})")
            L = lm.n_layers
            if env is MEGATAIL0_ENV:
                want = {"B3": L * steps, "B8a": L * steps, "B2": 0, "B1": L * steps, "B12": 0,
                        "B4": steps + 1, "B5": steps, "K1": 0, "K4": 0, "K2": 0, "B10": 0}
            else:
                want = {**path_wants(lm, env, steps), "B8a": 0}
                if lm.dense_kernel:
                    want["B4"] = steps + 1
            want.update(B7=0, B8b=0, **SLICE10_ZERO)
            if script == QWEN3_LONG:
                if bm["prompt_bucket"] != 512:
                    failures.append(f"qwen3 [{label}]: prompt bucket {bm['prompt_bucket']}, not 512")
                if c["B6"] != L:
                    failures.append(f"qwen3 [{label}]: B6 launched {c['B6']} times in the "
                                    f"512-bucket prefill, expected {L}")
            if label.startswith("bench") and mode != "voice_clone":
                failures.append(f"qwen3 [{label}]: resolved to {mode}, not voice_clone")
            for k, n in want.items():
                if c[k] != n:
                    failures.append(f"qwen3 [{label}] {k} launched {c[k]} times, the path needs {n}")
            check_tc(f"qwen3 {label}", c, failures)
            if steps == 0:
                failures.append(f"qwen3 [{label}]: no decode step ran")
            counts[label] = {**c, "steps": steps, "rtf": meta["total_duration"] / wall,
                             "wall_s": wall, "wall2_s": wall2, "decode_ms_per_step": decode_ms}

            def windows(label=label, env=env, texts=texts, spk=spk, rt=rt):
                set_env(env)
                n0 = _profiled(f"qwen3 {label}, prefill alone",
                               lambda: _qwen3_decode(rt, texts, 0, spk))
                n32 = _profiled(f"qwen3 {label}, prefill + 32 decode steps",
                                lambda: _qwen3_decode(rt, texts, 32, spk))
                if n0 and n32:
                    log(f"breakdown [qwen3 {label}]: {(n32 - n0) / 32:.1f} device operations per "
                        "decode step")

            if label.startswith("bench") or (script == QWEN3_LONG and env is not MEGALAYER_ENV):
                profiles.append(windows)

    def profile():
        for windows in profiles:
            windows()

    return counts, profile


# ── phase 4: the AudioSR studio pass ─────────────────────────────────────

#: bench.py's studio request (bench.py:224-247, :296-303)
STUDIO = dict(ddim_steps=100, guidance_scale=2.5, seed=42, chunk_size=32768, overlap=1024)


def studio_dispatches(n: int, chunk: int, overlap: int, buckets) -> list:
    """The window-count bucket of each batched dispatch for ``n`` samples
    at 48 kHz: windows every ``chunk - overlap`` samples until one reaches
    the end, taken in the largest bucket that the remaining windows fill."""
    hop = chunk - overlap
    n_windows = 1 if n <= chunk else 1 + -(-(n - chunk) // hop)
    out, row = [], 0
    while row < n_windows:
        bucket = next((b for b in buckets if n_windows - row <= b), buckets[-1])
        out.append(bucket)
        row += min(bucket, n_windows - row)
    return out


def norms_per_dispatch(cfg, ddim_steps: int) -> int:
    """``_norm_act`` calls of one dispatch, from the config: two per UNet
    ResBlock, one per attention block and the output norm, every DDIM step;
    the VAE's encoder and decoder (two per ResNet block, one for the
    bottleneck attention, one output norm) once."""
    from vocalie_tts_tpu_torch.models.common.unet2d import _plan

    inp, outp, _ = _plan(cfg.unet)
    n_res = sum("res" in m for m in inp + outp) + 2
    n_attn = sum("attn" in m for m in inp + outp) + 1
    unet = 2 * n_res + n_attn + 1
    levels, r = len(cfg.vae_mult), cfg.vae_res_blocks
    enc = 2 * (levels * r + 2) + 1 + 1
    dec = 2 * (levels * (r + 1) + 2) + 1 + 1
    return unet * ddim_steps + enc + dec


#: the studio knob settings: the slice's path, then the yardstick
GN_SETTINGS = (("VOCALIE_GN_PALLAS=1", "1"), ("knob unset", None))


def _set_gn(knob) -> None:
    if knob is None:
        os.environ.pop("VOCALIE_GN_PALLAS", None)
    else:
        os.environ["VOCALIE_GN_PALLAS"] = knob


def drive_audiosr(dev, failures, vo: dict, scale: str = "full", steps: int = 100):
    """The AudioSR studio pass at full width (random weights from seed 5;
    bf16 VAE and UNet, int8 UNet convs, device stitch) on the Chatterbox
    bench request's WAV, through ``AudioSRRuntime.enhance_file`` at
    bench.py's settings, with ``VOCALIE_GN_PALLAS=1`` (B13 on every norm)
    and with the knob unset (B13 never launched). Each is warmed up on the
    same file at 2 DDIM steps, then driven with B13's counter at 0 just
    before it and read just after. Returns the results by setting and a
    function that runs the profiled windows (one UNet call at the 64-window
    dispatch's CFG batch), kept for after every timed phase."""
    import numpy as np

    from vocalie_tts_tpu_torch.io.wavio import read_wav
    from vocalie_tts_tpu_torch.models.audiosr.model import latent_shape
    from vocalie_tts_tpu_torch.models.audiosr.runtime import (
        WINDOW_COUNT_BUCKETS,
        AudioSRRuntime,
    )
    from vocalie_tts_tpu_torch.models.common.unet2d import apply_unet2d
    from vocalie_tts_tpu_torch.ops.groupnorm import group_norm_fused

    set_env(DEFAULT_ENV)
    os.environ["VOCALIE_MODEL_SCALE"] = scale
    os.environ["VOCALIE_ALLOW_RANDOM_WEIGHTS"] = "1"
    request = {**STUDIO, "ddim_steps": steps}
    wav, sr_in = read_wav(vo["wav"])
    n48 = len(wav) * 48000 // sr_in
    dispatches = studio_dispatches(n48, STUDIO["chunk_size"], STUDIO["overlap"],
                                   WINDOW_COUNT_BUCKETS)
    results = {}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.monotonic()
        rt = AudioSRRuntime.create(os.path.join(tmp, "assets"), device=dev)
        torch.cuda.synchronize()
        cfg = rt.cfg
        per = norms_per_dispatch(cfg, steps)
        log(f"studio: full-width AudioSR runtime built in {time.monotonic() - t0:.2f} s (random "
            f"weights, seed 5; {cfg.dtype}, UNet {cfg.unet_channels} x {cfg.unet_mult}, int8 convs "
            f"{'w_q' in rt.params['unet']['input_blocks'][1]['res']['in_conv']}); input "
            f"{vo['wav'].rsplit('/', 1)[-1]} {len(wav) / sr_in:.3f} s at {sr_in} Hz -> {n48} "
            f"samples at 48 kHz, dispatches of {dispatches} windows, {per} norms a dispatch")
        for i, (label, knob) in enumerate(GN_SETTINGS):
            _set_gn(knob)
            out_path = os.path.join(tmp, f"studio_{i}.wav")
            t0 = time.monotonic()
            rt.enhance_file(input_path=vo["wav"], output_path=out_path,
                            **{**STUDIO, "ddim_steps": 2})
            warm = time.monotonic() - t0
            group_norm_fused.launches = group_norm_fused.two_pass_launches = 0
            t0 = time.monotonic()
            rt.enhance_file(input_path=vo["wav"], output_path=out_path, **request)
            wall = time.monotonic() - t0
            launched = group_norm_fused.launches
            two_pass = group_norm_fused.two_pass_launches
            out, sr = read_wav(out_path)
            audio_s = len(out) / sr
            ok = (sr == 48000 and len(out) == n48 and bool(np.isfinite(out).all())
                  and int(np.count_nonzero(out)) > 0)
            want = len(dispatches) * per if knob else 0
            headline = vo["audio_s"] / (vo["wall_s"] + wall)
            log(f"studio [{label}]: warm-up (2 DDIM steps) {warm:.3f} s; enhance_file "
                f"{steps} steps: audio {audio_s:.3f} s, wall {wall:.3f} s, studio "
                f"RTF {audio_s / wall:.3f}x, wav ok={ok} (48 kHz, {len(out)} samples, "
                f"{int(np.count_nonzero(out))} non-zero, peak {float(np.abs(out).max()):.6f}), "
                f"B13 launches {launched} (the path needs {want}), {two_pass} of them on the "
                "two-pass route (the path needs 0)")
            log(f"headline [{label}]: audio_rtf_60s_fr_vo_chatterbox_plus_audiosr_studio = VO "
                f"audio {vo['audio_s']:.3f} s / (VO wall {vo['wall_s']:.3f} s [{vo['label']}] + "
                f"studio wall {wall:.3f} s) = {headline:.3f}x")
            if not ok:
                failures.append(f"studio [{label}]: WAV check failed (sr {sr}, len {len(out)}, "
                                f"expected {n48})")
            if launched != want:
                failures.append(f"studio [{label}]: B13 launched {launched} times, the path "
                                f"needs {want}")
            if two_pass:
                failures.append(f"studio [{label}]: {two_pass} B13 launches took the two-pass "
                                "route")
            results[label] = {"audio_s": audio_s, "wall_s": wall, "rtf": audio_s / wall,
                              "headline_rtf": headline, "launches": launched,
                              "two_pass_launches": two_pass}

    lat = (*latent_shape(cfg, 2 * dispatches[0], STUDIO["chunk_size"])[:3],
           cfg.unet.in_channels)
    gen = torch.Generator(device=dev).manual_seed(16)
    x = torch.randn(lat, generator=gen, device=dev).to(cfg.dtype)
    t = torch.full((lat[0],), 500.0, device=dev)

    def profile():
        set_env(DEFAULT_ENV)
        for label, knob in GN_SETTINGS:
            _set_gn(knob)
            apply_unet2d(rt.params["unet"], cfg.unet, x, t)
            _profiled(f"studio, one UNet call x{list(lat)} [{label}]",
                      lambda: apply_unet2d(rt.params["unet"], cfg.unet, x, t))
        _set_gn(None)

    return results, profile


def _device_rows(prof) -> list:
    """(device µs, count, name) of each device operation a profile saw."""
    rows = []
    for e in prof.key_averages():
        dt = getattr(e, "self_device_time_total", None)
        if dt is None:
            dt = getattr(e, "self_cuda_time_total", 0.0)
        if dt and e.device_type == torch.autograd.DeviceType.CUDA:
            rows.append((dt, e.count, e.key))
    return rows


def _profiled(label: str, fn) -> int:
    """Run ``fn`` under torch.profiler (device activity only), print the
    device's busy share of the wall time and the kernels that fill it, and
    return the number of device operations (0 if the profiler saw none)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        fn()
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    rows = _device_rows(prof)
    busy = sum(r[0] for r in rows) / 1e6
    if busy <= 0:
        log(f"breakdown [{label}]: device time not measured (profiler saw none)")
        return 0
    n_ops = sum(r[1] for r in rows)
    _profiled.last = {"wall_s": wall, "busy_s": busy, "busy_share": busy / wall,
                      "device_ops": n_ops}
    log(f"breakdown [{label}]: wall {wall:.3f} s (profiler on), device busy "
        f"{busy:.3f} s = {busy / wall:.1%}, idle {1 - busy / wall:.1%}, {n_ops} device operations")
    for dt, n, key in sorted(rows, reverse=True)[:8]:
        log(f"  {dt / 1e3:10.3f} ms  {n:7d} launches  {key[:90]}")
    return n_ops


def breakdown(rt, dev, label: str, stage2_window: bool = True):
    """Where one bench request's time goes: host wall time of the decode
    (prefill + loop) and of stage 2, measured now; and a function that
    runs torch.profiler over windows of the same work (prefill alone,
    prefill + 32 decode steps, and one stage-2 call) for the device's busy
    share, the kernels that fill it and the device operations per decode
    step. The windows are short because the profiler's post-processing
    grows with the number of launches."""
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
    log(f"breakdown [{label}, bench request]: decode (prefill + {n_dec} steps) "
        f"{t_gen - t0:.3f} s = {(t_gen - t0) / n_dec * 1e3:.2f} ms/step, "
        f"stage 2 {t_end - t_gen:.3f} s")

    def windows():
        n0 = _profiled(f"{label}, prefill alone", lambda: decode(0))
        n32 = _profiled(f"{label}, prefill + 32 decode steps", lambda: decode(32))
        if n0 and n32:
            log(f"breakdown [{label}]: {(n32 - n0) / 32:.1f} device operations per decode step")
        if stage2_window:
            _profiled(f"{label}, stage 2 ({toks.shape[1]} tokens x {toks.shape[0]} rows)",
                      lambda: stage2(toks, tl))

    return windows


# ── the training path (slice 9): B6t, B11a, B11b; phases 2-5 ─────────────

B6T_NAME = "B6t flash_attention_lse (training forward)"
B11A_NAME = "B11a flash_attention_bwd_dkv"
B11B_NAME = "B11b flash_attention_bwd_dq"
#: phase 2's shapes: the finetune default [8, 16, 128, 64] bf16 causal (the
#: main entry), seq 512 (several tiles), GQA at d 128, a ragged non-causal case
TRAIN_SHAPES = (
    ("finetune default", dict(b=8, h=16, hk=16, s=128, d=64, causal=True)),
    ("seq 512", dict(b=8, h=16, hk=16, s=512, d=64, causal=True)),
    ("GQA d128", dict(b=8, h=16, hk=8, s=512, d=128, causal=True)),
    ("ragged non-causal", dict(b=2, h=4, hk=4, s=200, d=64, causal=False)),
)
#: tolerances against the plain versions (bf16): B6t's output per element
#: within B6T_TOL + B6T_TOL·|ref|, as B6's (p rounds to bf16 against a
#: running max in the kernel, the row max in the plain version; measured
#: max |diff| <= 7.8e-3); B11's outputs, max |diff| as a share of max |ref|
#: (measured <= 3.3e-3; B11b rounds ds to bf16, where an f32-ulp change can
#: flip a step); B6t's lse within LSE_TOL + LSE_TOL·|ref| (measured <= 1.8e-7
#: relative)
B6T_TOL = 1e-2
TRAIN_TOL = {"B11a": 5e-3, "B11b": 5e-3}
LSE_TOL = 1e-6


def _train_attn_inputs(dev, b, h, hk, s, d, causal, seed=31):
    gen = torch.Generator(device=dev).manual_seed(seed + s + d)
    q = torch.randn((b, h, s, d), generator=gen, device=dev).to(torch.bfloat16)
    k, v = (torch.randn((b, hk, s, d), generator=gen, device=dev).to(torch.bfloat16)
            for _ in range(2))
    do = torch.randn((b, h, s, d), generator=gen, device=dev).to(torch.bfloat16)
    return q, k, v, do


def _flash_train_calls(dev) -> dict:
    """One call each of B6t, B11b and B11a at the finetune default shape,
    for the kernel-count child."""
    from vocalie_tts_tpu_torch.ops import flash_attention_bwd as fb
    from vocalie_tts_tpu_torch.ops.flash_attention import flash_attention_lse

    shp = TRAIN_SHAPES[0][1]
    q, k, v, do = _train_attn_inputs(dev, **shp)
    o, lse = flash_attention_lse(q, k, v)
    _, di = fb.flash_attention_bwd_dq(q, k, v, o, lse, do, causal=True, sm_scale=0.125)
    return {B6T_NAME: lambda: flash_attention_lse(q, k, v),
            B11B_NAME: lambda: fb.flash_attention_bwd_dq(q, k, v, o, lse, do, causal=True,
                                                         sm_scale=0.125),
            B11A_NAME: lambda: fb.flash_attention_bwd_dkv(q, k, v, do, lse, di, causal=True,
                                                          sm_scale=0.125)}


def _rel_err(got, ref) -> float:
    return (got.float() - ref.float()).abs().max().item() / ref.float().abs().max().item()


def _top_steps(got, ref) -> float:
    """max |got - ref| in bf16 steps of max|ref|'s binade: 1 where two bf16
    outputs differ by one rounding step at the largest values, which alone
    gives 2^-8 to 2^-7 of max|ref|."""
    top = ref.float().abs().max().item()
    return (got.float() - ref.float()).abs().max().item() / 2.0 ** (math.floor(math.log2(top)) - 7)


def _flash_train_case(dev, failures, label, b, h, hk, s, d, causal):
    """B6t, B11b and B11a at one shape: each against its plain version on the
    same inputs, timed beside its plain version, SDPA (forward; backward
    alone under autograd) and its bound → {name: case dict}."""
    import torch.nn.functional as F

    from vocalie_tts_tpu_torch.ops import flash_attention_bwd as fb
    from vocalie_tts_tpu_torch.ops.flash_attention import attention_plain_lse, flash_attention_lse

    q, k, v, do = _train_attn_inputs(dev, b, h, hk, s, d, causal)
    sm = 1.0 / math.sqrt(d)
    kw = dict(causal=causal, sm_scale=sm)
    out, lse = flash_attention_lse(q, k, v, causal=causal)
    ref_out, ref_lse = attention_plain_lse(q, k, v, causal=causal)
    dq, di = fb.flash_attention_bwd_dq(q, k, v, ref_out, ref_lse, do, **kw)
    ref_dq, ref_di = fb.flash_attention_bwd_dq_plain(q, k, v, ref_out, ref_lse, do, **kw)
    dk, dv = fb.flash_attention_bwd_dkv(q, k, v, do, ref_lse, ref_di, **kw)
    ref_dk, ref_dv = fb.flash_attention_bwd_dkv_plain(q, k, v, do, ref_lse, ref_di, **kw)
    torch.cuda.synchronize()
    lse_worst = ((lse - ref_lse).abs() / (LSE_TOL + LSE_TOL * ref_lse.abs())).max().item()
    out_worst = ((out.float() - ref_out.float()).abs()
                 / (B6T_TOL + B6T_TOL * ref_out.float().abs())).max().item()
    errs = {B6T_NAME: [_rel_err(out, ref_out)], B11B_NAME: [_rel_err(dq, ref_dq),
                                                            _rel_err(di, ref_di)],
            B11A_NAME: [_rel_err(dk, ref_dk), _rel_err(dv, ref_dv)]}
    abs_errs = {B6T_NAME: (out.float() - ref_out.float()).abs().max().item(),
                B11B_NAME: (dq.float() - ref_dq.float()).abs().max().item(),
                B11A_NAME: max((dk.float() - ref_dk.float()).abs().max().item(),
                               (dv.float() - ref_dv.float()).abs().max().item())}
    steps = {B11B_NAME: _top_steps(dq, ref_dq),
             B11A_NAME: max(_top_steps(dk, ref_dk), _top_steps(dv, ref_dv))}
    if not lse_worst <= 1.0:
        failures.append(f"{B6T_NAME} [{label}] lse differs: worst ratio {lse_worst}")
    if not out_worst <= 1.0:
        failures.append(f"{B6T_NAME} [{label}] output differs: worst ratio {out_worst}")
    for name in (B11B_NAME, B11A_NAME):
        if not max(errs[name]) <= TRAIN_TOL[name.split()[0]]:
            failures.append(f"{name} [{label}] differs from its plain version: {errs[name]}")

    gqa = {"enable_gqa": True} if hk != h else {}
    calls = {
        B6T_NAME: (lambda i: flash_attention_lse(q, k, v, causal=causal),
                   lambda i: attention_plain_lse(q, k, v, causal=causal)),
        B11B_NAME: (lambda i: fb.flash_attention_bwd_dq(q, k, v, ref_out, ref_lse, do, **kw),
                    lambda i: fb.flash_attention_bwd_dq_plain(q, k, v, ref_out, ref_lse, do, **kw)),
        B11A_NAME: (lambda i: fb.flash_attention_bwd_dkv(q, k, v, do, ref_lse, ref_di, **kw),
                    lambda i: fb.flash_attention_bwd_dkv_plain(q, k, v, do, ref_lse, ref_di,
                                                               **kw)),
    }
    sdpa_fwd = cuda_ms(lambda i: F.scaled_dot_product_attention(q, k, v, is_causal=causal, **gqa),
                       30)
    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
    o_lib = F.scaled_dot_product_attention(*leaves, is_causal=causal, **gqa)
    sdpa_bwd = cuda_ms(lambda i: torch.autograd.grad(o_lib, leaves, do, retain_graph=True), 30)
    pairs = b * h * (s * (s + 1) // 2 if causal else s * s)
    qb, kb, rows = b * h * s * d * 2, b * hk * s * d * 2, b * h * s * 4
    bounds = {B6T_NAME: (2 * qb + 2 * kb + rows, 4 * d * pairs),
              B11B_NAME: (4 * qb + 2 * kb + 2 * rows, 6 * d * pairs),
              B11A_NAME: (2 * qb + 4 * kb + 2 * rows, 8 * d * pairs)}
    shape = f"{label}: q[{b},{h},{s},{d}] k/v[{b},{hk},{s},{d}] bf16, causal={causal}"
    cases = {}
    for name, (kernel, plain) in calls.items():
        ms = cuda_ms(kernel, 20)
        plain_ms = cuda_ms(plain, 5)
        lib = sdpa_fwd if name == B6T_NAME else sdpa_bwd
        bms, by = bound_ms(*bounds[name], PEAK_BF16_FLOPS)
        if name == B6T_NAME:
            tol = f"atol {B6T_TOL} + rtol {B6T_TOL}"
            check = (f"worst |diff| / ({B6T_TOL} + {B6T_TOL}|ref|) = {out_worst:.3f} (must be "
                     f"<= 1), max |diff| / max|ref| = {max(errs[name]):.3e}, lse worst |diff| / "
                     f"({LSE_TOL} + {LSE_TOL}|ref|) = {lse_worst:.3f} (must be <= 1)")
        else:
            tol = f"{TRAIN_TOL[name.split()[0]]} x max|ref|"
            check = (f"max |diff| / max|ref| = {max(errs[name]):.3e} (tolerance {tol}), "
                     f"{steps[name]:.3f} bf16 steps of max|ref|'s binade")
        tflops = bounds[name][1] / (ms * 1e-3) / 1e12
        log(f"{name} [{label}]: {check}; kernel {ms:.6f} ms ({tflops:.1f} TFLOP/s), plain "
            f"{plain_ms:.6f} ms, SDPA {'forward' if name == B6T_NAME else 'backward alone'} "
            f"{lib:.6f} ms, bound {bms:.6f} ms ({by}: {bounds[name][0] / 1e6:.1f} MB, "
            f"{bounds[name][1] / 1e9:.2f} GFLOP)")
        cases[name] = {"max_abs_err": abs_errs[name], "max_rel_err": max(errs[name]),
                       "tolerance": tol, "ms": ms, "plain_ms": plain_ms,
                       "bound_ms": bms, "bound_by": by, "library_ms": lib, "tflops": tflops,
                       "shape": shape}
        if name == B6T_NAME:
            cases[name]["worst_ratio"] = out_worst
            cases[name]["lse_worst_ratio"] = lse_worst
            cases[name]["lse_tolerance"] = f"{LSE_TOL} + {LSE_TOL} x |ref|"
    pair = cases[B11A_NAME]["ms"] + cases[B11B_NAME]["ms"]
    log(f"B11a + B11b [{label}]: {pair:.6f} ms, SDPA backward alone {sdpa_bwd:.6f} ms, "
        f"{pair / sdpa_bwd:.3f}x")
    return cases


def check_flash_train(dev, failures):
    """B6t, B11a and B11b at TRAIN_SHAPES → their ``kernels`` entries (the
    main numbers at the finetune default shape, the others under
    ``other_shapes``)."""
    per_shape = [_flash_train_case(dev, failures, label, **shp) for label, shp in TRAIN_SHAPES]
    fwd, bwd = "vocalie_tts_tpu_torch/csrc/flash_attention.cu", \
        "vocalie_tts_tpu_torch/csrc/flash_attention_bwd.cu"
    meta = {B6T_NAME: (fwd, "vocalie_tts_tpu/ops/flash_attention.py:289",
                       "F.scaled_dot_product_attention forward"),
            B11A_NAME: (bwd, "vocalie_tts_tpu/ops/flash_attention_bwd.py:55",
                        "F.scaled_dot_product_attention backward alone (dq, dk and dv together)"),
            B11B_NAME: (bwd, "vocalie_tts_tpu/ops/flash_attention_bwd.py:104",
                        "F.scaled_dot_product_attention backward alone (dq, dk and dv together)")}
    return [_entry(name, src, replaces, per_shape[0][name], library_call=lib,
                   other_shapes=[c[name] for c in per_shape[1:]])
            for name, (src, replaces, lib) in meta.items()]


def _train_wrappers() -> dict:
    from vocalie_tts_tpu_torch.ops import flash_attention_bwd as fb
    from vocalie_tts_tpu_torch.ops.flash_attention import flash_attention, flash_attention_lse

    return {"B6t": flash_attention_lse, "B11a": fb.flash_attention_bwd_dkv,
            "B11b": fb.flash_attention_bwd_dq, "B6": flash_attention,
            "B6t_tc": TcLaunches(flash_attention_lse), "B6tc": TcLaunches(flash_attention),
            "B11a_tc": TcLaunches(fb.flash_attention_bwd_dkv),
            "B11b_tc": TcLaunches(fb.flash_attention_bwd_dq)}


def _train_view(cfg, dev, seed):
    """The T3 train view (``to_train_view`` of a seeded ``init_t3``) and its
    training config."""
    import dataclasses

    from vocalie_tts_tpu_torch.models.chatterbox.model import init_t3
    from vocalie_tts_tpu_torch.training.finetune_fr import to_train_view

    t3 = init_t3(cfg, generator=torch.Generator(device=dev).manual_seed(seed), device=dev)
    train_cfg = dataclasses.replace(cfg.lm, vocab_size=cfg.text_vocab + cfg.speech_vocab + 2)
    return to_train_view(t3, cfg), train_cfg


def _train_batch(n, batch, seq_len, dev, seed=42):
    """``[n, batch, seq_len]`` tokens and targets from the synthetic corpus,
    drawn as ``finetune_overlay`` draws them."""
    import numpy as np

    from vocalie_tts_tpu_torch.training.finetune_fr import example_to_tokens, synthetic_dataset

    pairs = [example_to_tokens(e["text"], e["speech_tokens"], seq_len)
             for e in synthetic_dataset(512)]
    idx = np.random.RandomState(seed).randint(0, len(pairs), (n, batch))
    toks = np.stack([p[0] for p in pairs])[idx]
    tgts = np.stack([p[1] for p in pairs])[idx]
    return torch.from_numpy(toks).to(dev), torch.from_numpy(tgts).to(dev)


def small_reference_train(dev, failures):
    """The tiny T3 train view (f32), two ``use_flash=True`` train steps on
    the GPU (B6t, B11b, B11a: 2 layers x 1 each a step) against the same
    steps on the CPU (plain versions): the losses (1e-5 relative) and each
    leaf's gradient (1e-4 x max|g|: f32 on both sides, only the summation
    orders differ) at both steps."""
    from vocalie_tts_tpu_torch.models.chatterbox.runtime import SCALES
    from vocalie_tts_tpu_torch.models.common.weights import tree_items
    from vocalie_tts_tpu_torch.parallel import train

    cfg = SCALES["tiny"]
    lm, train_cfg = _train_view(cfg, torch.device("cpu"), 21)
    toks, tgts = _train_batch(2, 4, 64, "cpu")
    wrappers = _train_wrappers()
    runs = {}
    for name, d in (("gpu", dev), ("cpu", torch.device("cpu"))):
        opt = train.make_optimizer(1e-4)
        state = train.create_train_state(_to(lm, d), opt)
        step = train.make_train_step(train_cfg, opt, use_flash=True)
        before = {k: w.launches for k, w in wrappers.items()}
        out = []
        for i in range(2):
            loss, grads = train.value_and_grad(state.params, train_cfg, toks[i].to(d),
                                               tgts[i].to(d), use_flash=True)
            state, step_loss = step(state, toks[i].to(d), tgts[i].to(d))
            out.append((float(loss), float(step_loss), _to(grads, "cpu")))
        runs[name] = out
        launched = {k: w.launches - before[k] for k, w in wrappers.items()}
        want = cfg.n_layers * 4 if name == "gpu" else 0   # 2 steps, value_and_grad + step
        if any(launched[k] != want for k in ("B6t", "B11a", "B11b")) \
                or any(launched[k] for k in ("B6", "B6tc", "B6t_tc", "B11a_tc", "B11b_tc")):
            failures.append(f"tiny train steps on the {name}: launches {launched}, want "
                            f"{want} of B6t, B11a, B11b (the f32 CUDA-core bodies) and no B6")
    worst_loss, worst_grad = 0.0, 0.0
    for (lg, sg, gg), (lc, sc, gc) in zip(runs["gpu"], runs["cpu"]):
        worst_loss = max(worst_loss, abs(lg - lc) / abs(lc), abs(sg - sc) / abs(sc))
        for key, a in tree_items(gg):
            c = dict(tree_items(gc))[key]
            worst_grad = max(worst_grad, (a - c).abs().max().item() / (1e-4 * c.abs().max().item()))
    log(f"small reference: tiny T3 train view (f32), two use_flash=True train steps, GPU kernels "
        f"vs CPU plain: losses {[round(r[0], 6) for r in runs['gpu']]} vs "
        f"{[round(r[0], 6) for r in runs['cpu']]}, worst relative loss diff {worst_loss:.2e} "
        f"(tolerance 1e-5), worst grad |diff| / (1e-4 x max|g|) per leaf = {worst_grad:.3f} "
        "(must be <= 1)")
    if not (worst_loss <= 1e-5 and worst_grad <= 1.0):
        failures.append(f"tiny train steps differ: loss {worst_loss}, grads {worst_grad}")


def _wav_ok(res, rt, n_chunks: int) -> tuple:
    """(ok, samples, expected samples) of a ``run_tts_pipeline`` result's WAV
    for a request of ``n_chunks`` chunks: one duration a chunk, finite, of
    the chunks' summed duration plus the 250 ms gaps between the request's
    chunks, each chunk a whole number of tokens."""
    from vocalie_tts_tpu_torch.io.wavio import read_wav

    wav, sr = read_wav(res.out_path)
    meta = res.meta
    gap = int(24000 * 0.25)
    expect = round(sum(meta["durations"]) * 24000) + gap * (n_chunks - 1)
    ok = (sr == 24000 and len(wav) == expect and len(wav) > 0
          and len(meta["durations"]) == n_chunks
          and bool(torch.isfinite(torch.from_numpy(wav)).all())
          and abs(len(wav) / sr - meta["total_duration"]) < 1e-9
          and all(round(dur * 24000) % rt.cfg.samples_per_token == 0
                  for dur in meta["durations"]))
    return ok, len(wav), expect


#: the full-width train step with the flash kernels against the XLA
#: attention's, from one state and batch (bf16 activations: the two
#: attentions round their bf16 outputs and the residual stream apart): the
#: loss, relative (measured 4.7e-4 at seq 128, 1.1e-4 at seq 512), and each
#: leaf's max |flash - XLA| / max|g| (measured 8.2e-3 to 3.2e-2), each
#: limit about 3x the largest reading
TRAIN_LOSS_TOL = 1.5e-3
TRAIN_GRAD_TOL = 0.1


def _time_steps(step, state, toks, tgts, n: int) -> tuple:
    """ms per step over ``n`` chained steps (host clock, synchronized) and
    the last state."""
    torch.cuda.synchronize()
    t0 = time.monotonic()
    for i in range(n):
        state, loss = step(state, toks[i % toks.shape[0]], tgts[i % tgts.shape[0]])
    torch.cuda.synchronize()
    return (time.monotonic() - t0) / n * 1e3, state, float(loss)


def drive_training(dev, failures, scale: str = "full"):
    """Phase 4's training path at the full T3 width (bf16): (a) a base
    ``t3`` saved by a force-init runtime, then ``finetune_overlay`` (8 steps,
    batch 8, seq_len 128) with no env: the XLA attention, as in JAX, so no
    B6t/B11 launch; every loss finite, the overlay differs from the base;
    (b) a fresh runtime in the default int8 env serves one chunk in
    ``fr_finetune`` mode from that overlay (the WAV check); (c) the train
    step with ``use_flash=True`` and without, from one state and batch, at
    seq_len 128 and 512: 30 x B6t + 30 x B11b + 30 x B11a a flash step, 0
    without; the losses within TRAIN_LOSS_TOL, each leaf's grad within
    TRAIN_GRAD_TOL; ms per step, tokens/s, peak memory and the FLOP bound.
    Returns the flash step's launches and a function for phase 5's profiled
    steps."""
    import numpy as np

    from vocalie_tts_tpu_torch.engines.chatterbox import ChatterboxEngine
    from vocalie_tts_tpu_torch.models.chatterbox.runtime import SCALES, ChatterboxRuntime
    from vocalie_tts_tpu_torch.models.common.weights import tree_items
    from vocalie_tts_tpu_torch.parallel import train
    from vocalie_tts_tpu_torch.pipeline import run_tts_pipeline
    from vocalie_tts_tpu_torch.text import chunk_script
    from vocalie_tts_tpu_torch.training.finetune_fr import finetune_overlay

    wrappers = _train_wrappers()
    os.environ["VOCALIE_MODEL_SCALE"] = scale
    os.environ["VOCALIE_ALLOW_RANDOM_WEIGHTS"] = "1"
    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        set_env(NOENV_ENV)
        t0 = time.monotonic()
        ChatterboxRuntime.create(tmp, force_init=True, device=dev).save_weights()
        log(f"training [a]: full-width base t3 + s3gen saved in {time.monotonic() - t0:.1f} s")
        torch.cuda.empty_cache()
        losses = []

        def grab(line):
            log(f"training [a] finetune_overlay: {line}")
            losses.append(float(line.rsplit(" ", 1)[1]))

        for w in wrappers.values():
            w.launches = 0
        t0 = time.monotonic()
        res = finetune_overlay(assets_dir=tmp, steps=8, batch_size=8, seq_len=128, log_every=1,
                               log=grab, device=dev)
        wall = time.monotonic() - t0
        launched = {k: w.launches for k, w in wrappers.items()}
        weights = os.path.join(tmp, "weights")
        base, fr = np.load(os.path.join(weights, "t3.npz")), np.load(os.path.join(weights,
                                                                                 "t3_fr.npz"))
        moved = {key: float(np.abs(fr[key] - base[key]).max())
                 for key in ("lm/layers/wq", "lm/layers/w_down", "lm/tok_emb", "text_emb")}
        log(f"training [a]: finetune_overlay (8 steps, batch 8, seq_len 128, lr 1e-4, XLA "
            f"attention) {wall:.1f} s with loading and saving; losses {losses}; first "
            f"{res['first_loss']:.4f}, final {res['final_loss']:.4f}; launches {launched} "
            f"(must be 0); overlay - base, max |diff| per leaf: {moved}")
        if any(launched.values()):
            failures.append(f"finetune_overlay launched kernels: {launched}")
        if len(losses) != 8 or not all(math.isfinite(x) for x in losses):
            failures.append(f"finetune_overlay losses {losses}")
        if not any(v > 0 for v in moved.values()):
            failures.append("the saved overlay equals the base")
        del base, fr

        set_env(DEFAULT_ENV)
        t0 = time.monotonic()
        engine = ChatterboxEngine(device=dev, assets=tmp)
        rt = engine.runtime()
        same = torch.equal(rt.params["t3_fr"]["lm"]["layers"]["wqkv"]["q"],
                           rt.params["t3"]["lm"]["layers"]["wqkv"]["q"])
        request = _request(_SENT, os.path.join(tmp, "fr.wav"))
        request["chunks"] = list(chunk_script(_SENT))   # the pipeline's own chunking
        res = run_tts_pipeline(request, engine=engine)
        ok, n, expect = _wav_ok(res, rt, len(request["chunks"]))
        log(f"training [b]: the overlay served in fr_finetune mode (default int8 env): runtime + "
            f"request {time.monotonic() - t0:.1f} s, audio {res.meta['total_duration']:.3f} s, "
            f"wav ok={ok} ({n} samples, expected {expect}); overlay int8 qkv equals the "
            f"base's: {same} (must be False)")
        if not ok or same:
            failures.append(f"serving the overlay: wav ok={ok}, overlay equals base={same}")
        del engine, rt
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()

    set_env(NOENV_ENV)
    cfg = SCALES[scale]
    lm, train_cfg = _train_view(cfg, dev, 23)
    n_params = sum(t.numel() for _, t in tree_items(lm))
    card = torch.cuda.get_device_name(0)
    counts = {}
    profiled = []
    for seq in (128, 512):
        toks, tgts = _train_batch(4, 8, seq, dev, seed=seq)
        opt = train.make_optimizer()
        state = train.create_train_state(lm, opt)
        steps = {flash: train.make_train_step(train_cfg, opt, use_flash=flash)
                 for flash in (True, False)}
        grads, losses, launched = {}, {}, {}
        for flash in (True, False):
            for w in wrappers.values():
                w.launches = 0
            losses[flash], grads[flash] = train.value_and_grad(state.params, train_cfg, toks[0],
                                                               tgts[0], use_flash=flash)
            torch.cuda.synchronize()
            launched[flash] = {k: w.launches for k, w in wrappers.items()}
        for w in wrappers.values():
            w.launches = 0
        steps[True](state, toks[0], tgts[0])
        torch.cuda.synchronize()
        per_step = {k: w.launches for k, w in wrappers.items()}
        want = {"B6t": cfg.n_layers, "B11a": cfg.n_layers, "B11b": cfg.n_layers, "B6": 0,
                "B6t_tc": cfg.n_layers, "B6tc": 0, "B11a_tc": cfg.n_layers,
                "B11b_tc": cfg.n_layers}
        if per_step != want or any(launched[False].values()) or launched[True] != want:
            failures.append(f"train step at seq {seq}: flash step launches {per_step}, flash "
                            f"grads {launched[True]}, XLA grads {launched[False]}; want {want} "
                            "a flash step, 0 without")
        if seq == 128:
            counts = per_step
        rel = abs(float(losses[True]) - float(losses[False])) / abs(float(losses[False]))
        log(f"training [c] seq {seq}: loss flash {float(losses[True]):.6f}, XLA "
            f"{float(losses[False]):.6f}, relative diff {rel:.2e} (tolerance {TRAIN_LOSS_TOL}); "
            f"flash step launches {per_step}, XLA step {launched[False]}")
        if not rel <= TRAIN_LOSS_TOL:
            failures.append(f"train step at seq {seq}: flash loss differs from XLA's by {rel}")
        xla = dict(tree_items(grads[False]))
        for key, g in tree_items(grads[True]):
            r = xla[key].float()
            gd = (g.float() - r).abs().max().item() / r.abs().max().item()
            log(f"  grad {key}: max |flash - XLA| / max|g| = {gd:.3e} (tolerance "
                f"{TRAIN_GRAD_TOL})")
            if not gd <= TRAIN_GRAD_TOL:
                failures.append(f"train step at seq {seq}: grad {key} differs from XLA's by {gd}")
        del grads
        for flash in (True, False):
            _time_steps(steps[flash], state, toks, tgts, 2)   # warm-up
            held = torch.cuda.memory_allocated() / 2 ** 30
            torch.cuda.reset_peak_memory_stats()
            ms, _, last = _time_steps(steps[flash], state, toks, tgts, 5)
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            flops = 6 * n_params * 8 * seq
            log(f"training [c] seq {seq}, {'flash (B6t + B11)' if flash else 'XLA attention'}: "
                f"{ms:.2f} ms per train step, {8 * seq / ms * 1e3:.0f} tokens/s, peak memory "
                f"{peak:.2f} GiB ({peak - held:.2f} GiB above the {held:.2f} GiB allocated before "
                f"the steps: the train state and what earlier phases hold), bound "
                f"{flops / PEAK_BF16_FLOPS * 1e3:.3f} ms "
                f"(6 x {n_params / 1e6:.1f} M parameters x {8 * seq} tokens = "
                f"{flops / 1e12:.2f} TFLOP at the bf16 dense peak), last loss {last:.4f}; {card}")
        profiled.append((seq, steps[True], state, toks[0], tgts[0]))

    def profile():
        for seq, step, state, tok, tgt in profiled:
            n = _profiled(f"flash train step, 8 x {seq}", lambda: step(state, tok, tgt))
            log(f"breakdown [flash train step, 8 x {seq}]: {n} device operations a step")

    return counts, profile


# ── slice 10: B1w, B9d and K5; the unrounded cache and the GELU MLP under RMSNorm ──

B1W_NAME = "B1w decode_attention_int8_whole"
B9D_NAME = "B9d mlp_gelu_int8"
K5_NAME = "K5 cache_append_k (one array, no scales)"
#: B1w's shapes: the T3 voice-over's cache at phase 4 (a)'s unrounded
#: length (cache_len 600: the 512 prompt bucket + 80 steps; 552 slots in use
#: mid-run) and the Qwen3 decode shape at 520 slots
T3_WHOLE = dict(L=30, b=16, kv=16, g=1, d=64, T=600, prompt_pad=512, n_dec=40, seed=21)
QWEN3_WHOLE = dict(L=28, b=8, kv=8, g=2, d=128, T=520, prompt_pad=256, n_dec=96, seed=22)
#: K5's array: the T3 cache's k|v width (2 x 64) at 640 slots, bf16
K5_SHAPE = dict(L=30, b=16, kv=16, T=640, D=128)


def _whole_inputs(dev, *, L, b, kv, g, d, T, prompt_pad, n_dec, seed):
    """B1w's (and, with T rounded up to 128, B1's) inputs from a seed."""
    import types

    gen = torch.Generator(device=dev).manual_seed(seed)
    valid = prompt_pad + n_dec
    q = torch.randn((b, kv, g, d), generator=gen, device=dev)
    k, v = (torch.randint(-127, 128, (L, b, kv, T, d), generator=gen, device=dev,
                          dtype=torch.int8) for _ in range(2))
    ks, vs = (((torch.rand((L, b, kv, T), generator=gen, device=dev) + 0.5) / 127)
              .to(torch.bfloat16) for _ in range(2))
    kn, vn = (torch.randn((b, kv, d), generator=gen, device=dev) for _ in range(2))
    lens = torch.randint(1, prompt_pad + 1, (b,), generator=gen, device=dev)
    pos = torch.arange(T, device=dev)[None, :]
    bias = torch.where((pos < lens[:, None]) | ((pos >= prompt_pad) & (pos < valid)), 0.0,
                       NEG).float()
    return types.SimpleNamespace(q=q, k=k, v=v, ks=ks, vs=vs, kn=kn, vn=vn, bias=bias,
                                 valid=valid, L=L, b=b, kv=kv, g=g, d=d, T=T,
                                 sm=1.0 / math.sqrt(d))


def _whole_case(dev, failures, attn, label, with_new=True):
    """B1w against its plain version (atol 5e-4, B1's), timed over the
    layers; B1 (T-blocked) timed on the same slots of a cache rounded up to
    a 128-multiple, the kernel the port runs for a runtime's rounded cache."""
    from vocalie_tts_tpu_torch.ops import decode_attention as da

    t = _whole_inputs(dev, **attn)
    new = (t.kn, t.vn) if with_new else (None, None)
    vl = t.valid if with_new else None
    out = da.decode_attention_int8_whole_stacked(t.q, t.k, t.v, t.bias, 7, t.ks, t.vs, *new,
                                                 valid_len=vl, sm_scale=t.sm)
    ref = da.decode_attention_whole_plain(t.q, t.k, t.v, t.bias, 7, t.ks, t.vs, *new, vl,
                                          sm_scale=t.sm)
    torch.cuda.synchronize()
    err = (out - ref).abs().max().item()
    tol = 5e-4
    ms, g_ms = timed(lambda i: da.decode_attention_int8_whole_stacked(
        t.q, t.k, t.v, t.bias, i % t.L, t.ks, t.vs, *new, valid_len=vl, sm_scale=t.sm), 300,
        f"{B1W_NAME} [{label}]")
    plain_ms = cuda_ms(lambda i: da.decode_attention_whole_plain(
        t.q, t.k, t.v, t.bias, i % t.L, t.ks, t.vs, *new, vl, sm_scale=t.sm), 20)
    T128 = -(-t.T // 128) * 128
    pad = T128 - t.T
    k1, v1 = (torch.nn.functional.pad(a, (0, 0, 0, pad)) for a in (t.k, t.v))
    ks1, vs1 = (torch.nn.functional.pad(a, (0, pad)) for a in (t.ks, t.vs))
    bias1 = torch.nn.functional.pad(t.bias, (0, pad), value=NEG)
    b1_ms, b1_g_ms = timed(lambda i: da.decode_attention_int8_stacked(
        t.q, k1, v1, bias1, i % t.L, ks1, vs1, t.kn, t.vn, valid_len=t.valid, sm_scale=t.sm), 300,
        f"B1 on a {T128}-slot cache [{label}]")
    del k1, v1
    n = t.valid if with_new else t.T
    n_bytes = (n * t.b * t.kv * (2 * t.d + 2 * 2) + n * t.b * 4
               + 2 * t.b * t.kv * t.g * t.d * 4 + (2 * t.b * t.kv * t.d * 4 if with_new else 0))
    n_ops = 2 * 2 * n * t.b * t.kv * t.g * t.d
    bms, by = bound_ms(n_bytes, n_ops, PEAK_INT8_OPS)
    log(f"{B1W_NAME} [{label}]: max_abs_err={err:.3e} (tolerance {tol}, B1's); kernel "
        f"{ms:.6f} ms eager, {fmt_ms(g_ms)} ms graph, plain {plain_ms:.6f} ms, B1 (T-blocked) on "
        f"a {T128}-slot cache {b1_ms:.6f} ms eager, {fmt_ms(b1_g_ms)} ms graph, bound "
        f"{bms:.6f} ms ({by}, {n} slots read)")
    if not err <= tol:
        failures.append(f"B1w [{label}] max_abs_err {err} > {tol}")
    return {"max_abs_err": err, "tolerance": tol, "ms": ms, "graph_ms": g_ms,
            "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by, "library_ms": None,
            "b1_tblocked_ms": b1_ms, "b1_tblocked_graph_ms": b1_g_ms,
            "shape": f"{label}: q[{t.b},{t.kv},{t.g},{t.d}] cache[{t.L},{t.b},{t.kv},{t.T},"
                     f"{t.d}] int8, " + (f"valid_len={t.valid}" if with_new else
                                         "no current token: all T read")}


def check_whole_attention(dev, failures):
    """B1w at the T3 unrounded cache with the current token (the path's
    call) and without it, and at the Qwen3 shape → its ``kernels`` entry."""
    main = _whole_case(dev, failures, T3_WHOLE, "unrounded T3 cache")
    return _entry(B1W_NAME, "vocalie_tts_tpu_torch/csrc/decode_attention.cu",
                  "vocalie_tts_tpu/ops/decode_attention.py:190", main,
                  no_new_shape=_whole_case(dev, failures, T3_WHOLE, "T3, no k_new/valid_len",
                                           with_new=False),
                  qwen3_shape=_whole_case(dev, failures, QWEN3_WHOLE, "qwen3, 520 slots"),
                  library_call="none (no PyTorch call attends over an int8 cache with scales); "
                               "b1_tblocked_ms: B1 on the same slots of a 640-slot cache")


def check_mlp_gelu(dev, failures, L: int = 24):
    """B9d at the XTTS layer (b 8, d_model 1024, d_ff 4096 in two tiles of
    2048, bf16 fc bias) with f32 and bf16 rows against its plain version
    (``DENSE_TOL``), timed on bf16 rows over the layers; the ``_qdot`` ops
    the port runs for the same MLP without the dense kernels as the
    yardstick."""
    from vocalie_tts_tpu_torch.models.common import transformer as tr
    from vocalie_tts_tpu_torch.ops import decode_dense as dd

    t = _gelu_inputs(dev, L)
    b, d, F = t.b, t.d, t.F
    args = (t.wu, t.su, t.bu, t.wd, t.sd)
    got = [dd.mlp_gelu_int8_stacked(x, *args, layer) for x in (t.x.float(), t.x)
           for layer in (0, L - 1)]
    ref = [dd.mlp_gelu_int8_plain(x, *args, layer) for x in (t.x.float(), t.x)
           for layer in (0, L - 1)]
    torch.cuda.synchronize()

    def qdot_mlp(l):
        up = tr._qdot(t.x, {"q": t.wu[l], "s": t.su[l]}, f32_out=True) + t.bu[l].float()
        return tr._qdot(dd.gelu_tanh(up).to(t.x.dtype), {"q": t.wd[l], "s": t.sd[l]},
                        f32_out=True)

    ms, g_ms = timed(lambda i: dd.mlp_gelu_int8_stacked(t.x, *args, i % L), 300, "B9d")
    ops_ms, ops_g_ms = timed(lambda i: qdot_mlp(i % L), 100, "B9d yardstick")
    return _dense_entry(
        B9D_NAME, got=got, ref=ref, ms=ms, g_ms=g_ms,
        plain_ms=cuda_ms(lambda i: dd.mlp_gelu_int8_plain(t.x, *args, i % L), 20),
        ops_ms=ops_ms, ops_g_ms=ops_g_ms, ops_key="qdot_ops_ms",
        n_bytes=b * d * 2 + 2 * d * F + 4 * (F + d) + 2 * F + b * d * 4,
        n_ops=2 * b * 2 * d * F,
        shape=f"x[{b},{d}] bf16 (and f32), bf16 fc bias, d_ff {F} in tiles of "
              f"{dd.pick_tile(F, dd.TILE_BUDGET, 2 * d)}, {L} layers (layers 0 and {L - 1} "
              "checked)", failures=failures)


def check_cache_append_k(dev, failures):
    """K5 on one bf16 array of the T3 k|v width ([30,16,16,640,128]) at
    three positions against its plain version (byte-equal); the library
    yardstick is the slice assignment (which the plain version also is)."""
    from vocalie_tts_tpu_torch.ops.cache_update import cache_append_k_plain, cache_append_kv_stacked

    L, b, kv, T, D = K5_SHAPE.values()
    gen = torch.Generator(device=dev).manual_seed(23)
    k = torch.randn((L, b, kv, T, D), generator=gen, device=dev).to(torch.bfloat16)
    kn = torch.randn((L, b, kv, D), generator=gen, device=dev).to(torch.bfloat16)
    exact = True
    for pos in (0, T * 2 // 3, T - 1):
        got = cache_append_kv_stacked(k.clone(), None, kn, None, pos)
        ref = cache_append_k_plain(k.clone(), kn, pos)
        torch.cuda.synchronize()
        exact = exact and torch.equal(got.view(torch.int16), ref.view(torch.int16))
        del got, ref
    ms, g_ms = timed(lambda i: cache_append_kv_stacked(k, None, kn, None, i % T), 300, "K5")
    plain_ms = cuda_ms(lambda i: cache_append_k_plain(k, kn, i % T), 100)

    def assign(i):
        k[:, :, :, i % T] = kn

    lib_ms, lib_g_ms = timed(assign, 100, "K5's slice assignment")
    bms, by = bound_ms(2 * L * b * kv * D * 2, 0, PEAK_BF16_FLOPS)
    log(f"{K5_NAME}: checked at positions 0, {T * 2 // 3}, {T - 1}")
    main = _append_row(K5_NAME, exact, ms, g_ms, plain_ms, lib_ms, lib_g_ms, bms, by,
                       "slice assignment", _host_us(lambda i: cache_append_kv_stacked(
                           k, None, kn, None, i % T)), failures)
    main["shape"] = f"new[{L},{b},{kv},{D}] bf16 into one array [{L},{b},{kv},{T},{D}]"
    return _entry(K5_NAME, "vocalie_tts_tpu_torch/csrc/cache_update.cu",
                  "vocalie_tts_tpu/ops/cache_update.py:135", main,
                  launches_path="no served path: only JAX's one-array API reaches it (the "
                                "port's caches are split); launches counted on the Chatterbox "
                                "default path, every phase-4 path held to 0",
                  library_call="k_all[:, :, :, pos] = k_new")


def _slice10_calls(dev) -> dict:
    """One call each of B1w, B9d and K5 at their phase-2 shapes, for the
    kernel-count child."""
    from vocalie_tts_tpu_torch.ops import decode_attention as da
    from vocalie_tts_tpu_torch.ops import decode_dense as dd
    from vocalie_tts_tpu_torch.ops.cache_update import cache_append_kv_stacked

    t = _whole_inputs(dev, **T3_WHOLE)
    g = _gelu_inputs(dev, 2)
    k = torch.zeros((30, 16, 16, 640, 128), dtype=torch.bfloat16, device=dev)
    kn = torch.zeros((30, 16, 16, 128), dtype=torch.bfloat16, device=dev)
    return {
        B1W_NAME: lambda: da.decode_attention_int8_whole_stacked(
            t.q, t.k, t.v, t.bias, 7, t.ks, t.vs, t.kn, t.vn, valid_len=t.valid, sm_scale=t.sm),
        B9D_NAME: lambda: dd.mlp_gelu_int8_stacked(g.x, g.wu, g.su, g.bu, g.wd, g.sd, 1),
        K5_NAME: lambda: cache_append_kv_stacked(k, None, kn, None, 417),
    }


def small_reference_gelu_rms(dev, failures):
    """A d_model-128 GELU MLP with biases under RMSNorm (2 layers, 2 heads of
    64, d_ff 256, f32, int8 weights and cache, non-zero biases; no family
    has it): the dense kernels take B4 for the qkv and o-projections and the
    head and B9d for the MLP, GPU kernels against the GPU plain versions and
    against the CPU (``_dense_reference``). Returns B9d's launches."""
    from vocalie_tts_tpu_torch.models.common import transformer as tr
    from vocalie_tts_tpu_torch.ops import decode_attention as da
    from vocalie_tts_tpu_torch.ops import decode_dense as dd

    cfg = tr.TransformerConfig(vocab_size=96, d_model=128, n_layers=2, n_heads=2, n_kv_heads=2,
                               d_head=64, d_ff=256, max_seq_len=256, kv_quant=True,
                               decode_kernel=True, dense_kernel=True, mlp_type="gelu",
                               bias=True, norm_type="rms", dtype=torch.float32)
    gen = torch.Generator(device=dev).manual_seed(24)
    raw = tr.init_params(cfg, generator=gen, device=dev)
    for name in ("bo", "b_up", "b_down"):
        raw["layers"][name] = 0.2 * torch.randn(raw["layers"][name].shape, generator=gen,
                                                device=dev)
    params = tr.fuse_decode_weights(tr.quantize_weights_int8(raw))
    n = 12
    swaps = {"dense_int8_stacked": (dd.dense_int8_stacked, dd.dense_int8_plain),
             "mlp_gelu_int8_stacked": (dd.mlp_gelu_int8_stacked, dd.mlp_gelu_int8_plain)}
    # the tie trace's GPU run: B4 and B9d as above, and B1 (whose int8 q and
    # p roundings happen inside its kernel) through its plain version too
    ties = {(tr, name): plain for name, (_, plain) in swaps.items()}
    ties[(da, "decode_attention_int8_stacked")] = da.decode_attention_plain
    launched = _dense_reference(dev, failures, "GELU + bias + RMSNorm, d_model 128", cfg, params,
                                swaps, {"dense_int8_stacked": 1 + n * (1 + 2 * cfg.n_layers),
                                        "mlp_gelu_int8_stacked": n * cfg.n_layers}, n_steps=n,
                                tie_swaps=ties)
    return launched["mlp_gelu_int8_stacked"]


def _decode_loop(params, cfg, embeds, lens, cache_len, steps, cfg_weight, tokens=None):
    """``prefill`` + ``steps`` greedy steps through ``generate_tokens`` (no
    EOS, so every step runs) → (prefill s, decode s, tokens)."""
    from vocalie_tts_tpu_torch.models.common import transformer as tr
    from vocalie_tts_tpu_torch.ops.generate import GenerateConfig, generate_tokens

    t0 = time.monotonic()
    logits, cache = tr.prefill(params, cfg, tokens, lens, inputs_embeds=embeds,
                               cache_len=cache_len)
    torch.cuda.synchronize()
    t1 = time.monotonic()
    b = lens.shape[0] // 2 if cfg_weight > 0 else lens.shape[0]
    first = torch.argmax(logits[:b], -1)
    gen = GenerateConfig(max_new_tokens=steps, eos_token_id=-1, temperature=0.0,
                         cfg_weight=cfg_weight, vocab_size=cfg.vocab_size)
    toks, _ = generate_tokens(params, lambda p, t, c: tr.decode_step(p, cfg, t, c), cache, first,
                              gen)
    torch.cuda.synchronize()
    return t1 - t0, time.monotonic() - t1, toks


def _counted_loops(label, wrappers, runs, vocab, failures):
    """Each run (name, fn, want) with every counter at 0 just before it and
    read just after; the counts must equal ``want`` and the tokens lie in
    the vocabulary. Returns the counts by run."""
    out = {}
    for name, fn, want in runs:
        for w in wrappers.values():
            w.launches = 0
        t_pre, t_dec, toks = fn()
        c = {k: w.launches for k, w in wrappers.items()}
        steps = c["steps"]
        ok = bool(((toks >= 0) & (toks < vocab)).all())
        log(f"phase 4 [{label}, {name}]: prefill {t_pre:.3f} s, {steps} decode steps in "
            f"{t_dec:.3f} s = {t_dec / max(steps, 1) * 1e3:.3f} ms/step, tokens in range={ok}, "
            f"launches {c}")
        if not ok:
            failures.append(f"[{label}, {name}] tokens out of range")
        for k, n in want.items():
            if c[k] != n:
                failures.append(f"[{label}, {name}] {k} launched {c[k]} times, the path needs {n}")
        check_tc(f"{label}, {name}", c, failures)
        out[name] = c
    return out


def drive_unrounded(dev, failures, scale: str = "full", steps: int = 80):
    """Phase 4 (a): the Chatterbox T3 LM at full width (random weights from
    a seed) in the default int8 config, batch 16 (8 chunks, CFG-doubled),
    ``prefill`` at the 512 prompt bucket with ``cache_len`` 600 -- a length
    no runtime makes (they round to 128) -- then ``steps`` greedy steps
    through ``generate_tokens``: B1w = 30 x steps, B1 = B12 = B7 = 0; the
    same loop at ``cache_len`` 640 in the same run (B1 = 30 x steps). Each
    timed twice, in turns. Returns the counts by run and the function that
    profiles both (prefill alone, prefill + 16 steps)."""
    from vocalie_tts_tpu_torch.models.chatterbox.runtime import SCALES
    from vocalie_tts_tpu_torch.models.common import transformer as tr
    from vocalie_tts_tpu_torch.models.common.ar_runtime import apply_runtime_env, maybe_quantize_lm

    set_env(DEFAULT_ENV)
    cfg = apply_runtime_env(SCALES[scale]).lm
    gen = torch.Generator(device=dev).manual_seed(25)
    params = maybe_quantize_lm({"lm": tr.init_params(cfg, generator=gen, device=dev)})["lm"]
    b, s = 16, 512 if scale == "full" else 64
    embeds = (torch.randn((b, s, cfg.d_model), generator=gen, device=dev) * 0.5).to(cfg.dtype)
    lens = torch.randint(s // 4, s + 1, (b,), generator=gen, device=dev).to(torch.int32)
    lens[0] = s
    lens = torch.cat([lens[:8], lens[:8]])   # cond | uncond rows share their prompt lengths
    wrappers = _wrappers()
    L = cfg.n_layers
    lens_600 = ((600, 640) if scale == "full"
                else ((s + steps + 8) // 8 * 8, -(-(s + steps) // 128) * 128))

    def loop(cache_len, n=steps):
        return lambda: _decode_loop(params, cfg, embeds, lens, cache_len, n, 0.6)

    loop(lens_600[0], 4)()   # load and warm up
    base = {**{k: 0 for k in wrappers}, "B2": L * steps, "B3": steps, "B4": steps + 1,
            "B3tc": steps, "B4tc": steps + 1, "B5": steps, "B6": L if s >= 512 else 0,
            "B6tc": L if s >= 512 else 0, "steps": steps}
    counts = _counted_loops("unrounded T3 cache", wrappers, [
        (f"cache_len {lens_600[0]}", loop(lens_600[0]), {**base, "B1w": L * steps}),
        (f"cache_len {lens_600[1]}", loop(lens_600[1]), {**base, "B1": L * steps}),
    ], cfg.vocab_size, failures)
    for cache_len in (lens_600[1], lens_600[0]):
        _, t_dec, _ = loop(cache_len)()
        log(f"phase 4 [unrounded T3 cache, cache_len {cache_len}] again: "
            f"{t_dec / steps * 1e3:.3f} ms/step")

    def profile():
        set_env(DEFAULT_ENV)
        n = min(16, steps)
        for cache_len in lens_600:
            label = f"T3 cache_len {cache_len}"
            n0 = _profiled(f"{label}, prefill alone", loop(cache_len, 0))
            n16 = _profiled(f"{label}, prefill + {n} decode steps", loop(cache_len, n))
            if n0 and n16:
                log(f"breakdown [{label}]: {(n16 - n0) / n:.1f} device operations per decode "
                    "step")

    return counts, profile


def drive_gelu_rms(dev, failures, scale: str = "full", steps: int = 64):
    """Phase 4 (b): the XTTS GPT LM's widths (24 layers, d_model 1024, d_ff
    4096, 16 heads of 64, biases, learned positions) with RMSNorm in place of
    LayerNorm -- the config JAX's decode step gives B4 + B9d -- int8
    weights and cache, dense and decode kernels, random weights and biases
    from a seed; batch 8, a 544-bucket token prompt (flash prefill), ``steps``
    greedy steps through ``generate_tokens``: B9d = 24 x steps, B4 = steps x
    (1 + 2 x 24) + 1, B1 = 24 x steps, B5 = steps, B9a-c = B2 = B3 = 0.
    Timed twice. Returns the counts by run and the profile function."""
    import dataclasses

    from vocalie_tts_tpu_torch.models.common import transformer as tr
    from vocalie_tts_tpu_torch.models.common.ar_runtime import maybe_quantize_lm
    from vocalie_tts_tpu_torch.models.xtts.runtime import SCALES

    set_env(DEFAULT_ENV)
    xcfg = dataclasses.replace(SCALES[scale], kv_quant=True, decode_kernel=True,
                               dense_kernel=True)
    cfg = dataclasses.replace(xcfg.lm, norm_type="rms")
    gen = torch.Generator(device=dev).manual_seed(26)
    raw = tr.init_params(cfg, generator=gen, device=dev)
    for name in ("bq", "bk", "bv", "bo", "b_up", "b_down"):
        raw["layers"][name] = (0.02 * torch.randn(raw["layers"][name].shape, generator=gen,
                                                  device=dev)).to(cfg.dtype)
    params = maybe_quantize_lm({"lm": raw})["lm"]
    b, s = 8, 544 if scale == "full" else 96
    toks = torch.randint(0, cfg.vocab_size, (b, s), generator=gen, device=dev)
    lens = torch.randint(s // 4, s + 1, (b,), generator=gen, device=dev).to(torch.int32)
    lens[0] = s
    cache_len = -(-(s + steps) // 128) * 128
    wrappers = {**_xtts_wrappers(), **_qwen3_wrappers()}
    L = cfg.n_layers
    assert tr._dense_dispatch(params["layers"], cfg, b, cache_len) == tr.DENSE_FNS

    def loop(n=steps):
        return lambda: _decode_loop(params, cfg, None, lens, cache_len, n, 0.0, tokens=toks)

    loop(4)()   # load and warm up
    want = {**{k: 0 for k in wrappers}, "B9d": L * steps, "B4": steps * (1 + 2 * L) + 1,
            "B4tc": steps * (1 + 2 * L) + 1, "B1": L * steps, "B5": steps,
            "B6": L if s >= 512 else 0, "B6tc": L if s >= 512 else 0, "steps": steps}
    counts = _counted_loops("GELU MLP under RMSNorm", wrappers,
                            [(f"{s} prompt, cache_len {cache_len}", loop(), want)],
                            cfg.vocab_size, failures)
    _, t_dec, _ = loop()()
    log(f"phase 4 [GELU MLP under RMSNorm] again: {t_dec / steps * 1e3:.3f} ms/step")

    def profile():
        set_env(DEFAULT_ENV)
        n = min(16, steps)
        n0 = _profiled("GELU MLP under RMSNorm, prefill alone", loop(0))
        n16 = _profiled(f"GELU MLP under RMSNorm, prefill + {n} decode steps", loop(n))
        if n0 and n16:
            log(f"breakdown [GELU MLP under RMSNorm]: {(n16 - n0) / n:.1f} device operations "
                "per decode step")

    return counts, profile


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    try:
        from vocalie_tts_tpu_torch.ops import _build
    except ImportError as e:
        print(f"chip_smoke: the port's package is not importable here: {e}", file=sys.stderr)
        return 2
    set_env(DEFAULT_ENV)
    dev = torch.device("cuda:0")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")

    t0 = time.monotonic()
    lib = _build.build()
    log(f"kernels built in {time.monotonic() - t0:.1f} s -> {lib.name}")
    for line in _build.build_log().splitlines():
        if "Compiling entry function" in line:   # the kernel the next lines describe
            log("  " + line.split("'")[1][:72])
        elif ("registers" in line or "spill" in line or "rc " in line or "error" in line.lower()
                or "warning" in line.lower()):
            log("  " + line.strip())

    failures: list = []
    t_start = time.monotonic()
    dense = check_dense(dev, failures)
    dense_q3 = check_dense(dev, failures, QWEN3_DENSE)
    for rows, shape in ((dense, T3_DENSE), (dense_q3, QWEN3_DENSE)):
        for entry in rows:
            if entry["name"] in TAIL_NAMES:
                entry["plan"] = _tail_plan_note(dev, shape, entry["name"] == TAIL_NAMES[0])
    for entry, q3 in zip(dense, dense_q3):
        entry["qwen3_shape"] = {k: q3.get(k) for k in (
            "max_abs_err", "bit_equal", "ms", "graph_ms", "plain_ms", "bound_ms", "bound_by",
            "slice1_ops_ms", "slice1_ops_graph_ms", "plan", "host_us", "host_python_us",
            "equal_to_old_chain", "earlier_ms", "earlier_graph_ms", "earlier_host_us",
            "earlier_host_python_us", "shape") if k in q3}
    f32_attn = check_f32_attention(dev, failures)
    kernels = [check_decode_attention(dev, failures), *dense, check_cache_append(dev, failures),
               check_flash_attention(dev, failures), check_decode_step(dev, failures),
               check_group_norm(dev, failures), *check_dense_gelu(dev, failures),
               *dense_q3[3:], check_decode_layer(dev, failures), *f32_attn,
               check_cache_append_kv(dev, failures), *check_flash_train(dev, failures),
               check_whole_attention(dev, failures), check_mlp_gelu(dev, failures),
               check_cache_append_k(dev, failures)]
    by_key = {k["name"].split()[0]: k for k in kernels}
    count_dense_kernels(kernels, failures)
    if failures:
        raise SystemExit("kernel checks failed: " + "; ".join(failures))
    # the small models run in f32 and are held against the CPU's f32
    # products, so TF32 is off for this phase only (cuDNN's default is on);
    # the main path runs with PyTorch's defaults, as a caller gets them
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    small_reference(dev, failures)
    small_reference_dense(dev, failures)
    small_reference_audiosr(dev, failures)
    small_reference_xtts(dev, failures)
    b8b_launches = small_reference_qwen3(dev, failures)
    small_reference_noenv(dev, failures)
    small_reference_train(dev, failures)
    b9d_small = small_reference_gelu_rms(dev, failures)
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    if failures:
        raise SystemExit("small-input reference failed: " + "; ".join(failures))
    requests = [("bench 8-chunk", BENCH_SCRIPT), ("512-bucket prompt", LONG_SCRIPT)]
    work = tempfile.mkdtemp(prefix="chip_smoke_")
    vo = {"dir": work}
    try:
        counts, profile = drive_path(dev, failures, "default int8 config", DEFAULT_ENV, requests,
                                     keep=vo)
        counts1, profile1 = drive_path(dev, failures, "slice-1 config", SLICE1_ENV, requests[:1],
                                       lean=True)
        counts12, profile12 = drive_path(dev, failures, "VOCALIE_MEGALAYER=1", MEGALAYER_ENV,
                                         requests[:1], again=True, lean=True)
        # the JAX package's no-env configurations: bf16 cache and weights
        _, profile0 = drive_path(dev, failures, "no env", NOENV_ENV, requests[:1],
                                 lean=True)
        counts_dk, profile_dk = drive_path(dev, failures, "VOCALIE_DECODE_KERNEL=1",
                                           DECODE_KERNEL_ENV, requests[:1],
                                           lean=True)
        counts_w8, profile_w8 = drive_path(dev, failures, "VOCALIE_WEIGHT_INT8=1 alone",
                                           WEIGHT_INT8_ENV, requests[:1], lean=True)
        cosy, profile_cosy = drive_cosyvoice(dev, failures, by_key["B7"]["path_inputs"])
        studio, profile_studio = drive_audiosr(dev, failures, vo)
        xtts, profile_xtts = drive_xtts(dev, failures)
        qwen3, profile_qwen3 = drive_qwen3(dev, failures)
        unrounded, profile_unrounded = drive_unrounded(dev, failures)
        gelu_rms, profile_gelu_rms = drive_gelu_rms(dev, failures)
        train_counts, profile_train = drive_training(dev, failures)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    if failures:
        raise SystemExit("main path failed: " + "; ".join(failures))
    # torch.profiler last: everything above is timed without it
    profile()
    profile1()
    profile12()
    profile0()
    profile_dk()
    profile_w8()
    profile_cosy()
    profile_studio()
    profile_xtts()
    profile_qwen3()
    profile_unrounded()
    profile_gelu_rms()
    profile_train()
    by_key["B13"]["launches"] = studio[GN_SETTINGS[0][0]]["launches"]
    by_key["B13"]["two_pass_launches"] = studio[GN_SETTINGS[0][0]]["two_pass_launches"]
    by_key["B13"]["launches_knob_unset"] = studio[GN_SETTINGS[1][0]]["launches"]
    # B1-B6: the Chatterbox default path's counts; B7: the streaming path's;
    # B9a-b: the XTTS default bench request's, B9c: its VOCALIE_MEGATAIL=0 run;
    # B8a: the Qwen3 bench request's VOCALIE_MEGATAIL=0 run; B8b: phase 3's
    # biased-SwiGLU reference (no served family reaches it); B12: the
    # Chatterbox bench request's VOCALIE_MEGALAYER=1 run; K1 and K4: its
    # VOCALIE_DECODE_KERNEL=1 run; K2 and B10 (on no served path): the
    # Chatterbox default path's counts, measured (every path above fails if
    # either is launched); B6t, B11a and B11b: one full-width flash train step;
    # B1w: phase 4 (a), the T3 at cache_len 600; B9d: phase 4 (b); K5 (on no
    # served path): the Chatterbox default path's counts, measured
    main_counts = {**counts, "B12": counts12["B12"], "B7": cosy["streaming, default"]["B7"],
                   "B1w": unrounded["cache_len 600"]["B1w"],
                   "B9d": next(iter(gelu_rms.values()))["B9d"],
                   "B9a": xtts["bench 8-chunk, default"]["B9a"],
                   "B9b": xtts["bench 8-chunk, default"]["B9b"],
                   "B9c": xtts["bench 8-chunk, VOCALIE_MEGATAIL=0"]["B9c"],
                   "B8a": qwen3["bench 8-chunk voice_clone, VOCALIE_MEGATAIL=0"]["B8a"],
                   "B8b": b8b_launches, "K1": counts_dk["K1"], "K4": counts_dk["K4"],
                   **{k: train_counts[k] for k in ("B6t", "B11a", "B11b")}}
    for key in ("B6t", "B11a", "B11b"):
        by_key[key]["launches_path"] = ("one full-width use_flash=True train step at 8 x 128 "
                                        "(30 layers); finetune_overlay launches 0 (the XLA "
                                        "attention, as in JAX)")
    by_key["B8b"]["launches_path"] = "phase 3: the biased-SwiGLU d_model-128 reference"
    by_key["B1w"]["launches_path"] = ("phase 4 (a): the full-width T3 LM at cache_len 600, 80 "
                                      "steps; every runtime path held to 0 (they round their "
                                      "caches to 128-multiples)")
    by_key["B9d"]["launches_path"] = ("phase 4 (b): the XTTS GPT widths with RMSNorm, 64 steps; "
                                      f"phase 3's d_model-128 reference: {b9d_small}; every "
                                      "family's path held to 0")
    # of those, the launches the tensor-core body took (bf16 at d 64 and 128)
    by_key["B6"]["tc_launches"] = counts["B6tc"]
    by_key["B6t"]["tc_launches"] = train_counts["B6t_tc"]
    by_key["B11a"]["tc_launches"] = train_counts["B11a_tc"]
    by_key["B11b"]["tc_launches"] = train_counts["B11b_tc"]
    # B3's and B4's that took their one launch (every one: check_tc)
    by_key["B3"]["tc_launches"] = counts["B3tc"]
    by_key["B4"]["tc_launches"] = counts["B4tc"]
    for key, entry in by_key.items():
        if key == "B13":
            continue
        entry["launches"] = main_counts[key]
        if counts1.get(key):
            entry["launches_slice1_config"] = counts1[key]
        if counts12.get(key) and key != "B12":
            entry["launches_megalayer_config"] = counts12[key]
        if counts_w8.get(key):
            entry["launches_weight_int8_config"] = counts_w8[key]
        for group, per_path in (("cosyvoice", cosy), ("xtts", xtts), ("qwen3", qwen3),
                                ("t3", unrounded), ("gelu_rms", gelu_rms)):
            for path, c in per_path.items():
                if c.get(key):
                    entry[f"launches_{group}_{path}"] = c[key]

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout.strip() \
        else f"nvidia-smi failed: {smi.stderr.strip()}"
    log(f"chip_smoke: phases 2-5 took {time.monotonic() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


def sweep_f32_splits(dev) -> dict:
    """Each K1 and B10 row of phase 2 graph-timed at every split count the
    kernel takes (1-16 blocks a pair, at least 16 slots a block), beside the
    clusters of that size the card keeps resident: the measurement
    ``attend_splits``' one-wave rule rests on."""
    from vocalie_tts_tpu_torch.ops import decode_attention as da

    rows = [("K1 voice-over", T3_ATTN, torch.bfloat16, "plain"),
            ("K1 qwen3", QWEN3_ATTN, torch.bfloat16, "plain"),
            ("K1 qwen3 batch 1", QWEN3_B1_ATTN, torch.bfloat16, "plain"),
            ("B10 T3 layer, bf16", {**T3_ATTN, "L": 8}, torch.bfloat16, "plain"),
            ("B10 T3 layer, int8", {**T3_ATTN, "L": 8}, torch.int8, "b10")]
    rule = da.f32_splits
    out = {}
    try:
        for label, attn, cache, mode in rows:
            t = _f32_attn_inputs(dev, attn, cache)
            if label.startswith("K1"):
                n = t.valid
                call = lambda i, t=t: da.decode_attention_float_stacked(  # noqa: E731
                    t.q, t.k, t.v, t.bias, i % t.L, t.kn, t.vn, valid_len=t.valid, sm_scale=t.sm)
            else:
                n = t.T
                call = lambda i, t=t, q8=cache == torch.int8: da.decode_attention(  # noqa: E731
                    t.q, t.k[i % t.L], t.v[i % t.L], t.bias, *((t.ks[i % t.L], t.vs[i % t.L])
                                                                if q8 else (None, None)),
                    sm_scale=t.sm)
            codes = da.f32_codes(t.k, t.ks, mode, t.g)
            chosen = rule(t.k, t.ks, mode, t.b, t.kv, t.g, n)
            res = {}
            for s in (1, 2, 4, 8, 16):
                if s > 1 and s * da.SPLIT_MIN_SLOTS > n:
                    break
                da.f32_splits = lambda *a, s=s: s
                res[s] = {"graph_ms": graph_ms(call),
                          "resident_clusters": da.resident_clusters(*codes, s)}
            da.f32_splits = rule
            log(f"split sweep [{label}]: {t.b * t.kv} clusters, attend_splits {chosen}; "
                + "; ".join(f"{s}: {r['graph_ms']:.6f} ms ({r['resident_clusters']} resident)"
                            for s, r in res.items()))
            out[label] = {"chosen": chosen, "by_splits": res}
    finally:
        da.f32_splits = rule
    return out


def time_qwen3_decode_kernel(dev, reps: int = 6) -> list:
    """The Qwen3 batch-1 chunk's decode with ``VOCALIE_DECODE_KERNEL=1``
    (28 x K1 + K4 a step on a bf16-weight runtime, seed 11), timed as phase
    4 times it (192 sampled steps less the prefill, ms/step), ``reps`` times
    in one process after a warm-up. Copied into an unpacked parent commit
    and run there, it times that commit on the same request, so that two
    versions are compared within one call."""
    from vocalie_tts_tpu_torch.engines.qwen3 import Qwen3Engine
    from vocalie_tts_tpu_torch.text import render_clean_text_from_segments

    set_env(DECODE_KERNEL_ENV)
    os.environ["VOCALIE_MODEL_SCALE"] = "full"
    os.environ["VOCALIE_ALLOW_RANDOM_WEIGHTS"] = "1"
    steps = _qwen3_wrappers()["steps"]
    out = []
    with tempfile.TemporaryDirectory() as tmp:
        rt = Qwen3Engine(device=dev, assets=os.path.join(tmp, "assets")).runtime()
        texts = [render_clean_text_from_segments(ch.segments)
                 for ch in _request(QWEN3_LONG, os.path.join(tmp, "q.wav"))["chunks"]]
        spk = rt.speaker_embedding("custom_voice", "Vivian", None)
        _qwen3_decode(rt, texts, 192, spk)
        for _ in range(reps):
            t1 = time.monotonic()
            _qwen3_decode(rt, texts, 0, spk)
            t2 = time.monotonic()
            n0 = steps.launches
            _qwen3_decode(rt, texts, 192, spk)
            t3 = time.monotonic()
            out.append(((t3 - t2) - (t2 - t1)) / max(steps.launches - n0, 1) * 1e3)
    log("qwen3 one chunk at batch 1, VOCALIE_DECODE_KERNEL=1, decode alone: "
        + ", ".join(f"{ms:.3f}" for ms in out) + " ms/step")
    return out


def _chatterbox_decoder(dev, tmp: str):
    """The Chatterbox bench request's decode (T3, 8 chunks CFG-doubled, b
    16) on a runtime with its assets under ``tmp``: ``(decode, n_dec)``,
    ``decode(n)`` running its prefill and ``n`` sampled steps, synchronized,
    and the request's decode bucket."""
    from vocalie_tts_tpu_torch.engines.chatterbox import ChatterboxEngine

    rt = ChatterboxEngine(device=dev, assets=os.path.join(tmp, "assets")).runtime()
    kw = dict(mode="fr_finetune", lang="fr", exaggeration=0.5, cfg_weight=0.6)
    t3, embeds, lens, (_, _, n_dec, cache_len) = rt._prepare_batch([_SENT] * 8, **kw)

    def decode(n):
        rt.generate(t3, embeds, lens, cache_len=cache_len, max_new=n, temperature=0.5,
                    cfg_weight=0.6, repetition_penalty=1.35)
        torch.cuda.synchronize()

    return decode, n_dec


def _qwen3_decoder(dev, tmp: str):
    """The Qwen3 bench request's decode (voice_clone, b 8, seed 11), as
    ``_chatterbox_decoder``'s: ``(decode, 192)``."""
    from vocalie_tts_tpu_torch.engines.qwen3 import Qwen3Engine
    from vocalie_tts_tpu_torch.text import render_clean_text_from_segments

    rt = Qwen3Engine(device=dev, assets=os.path.join(tmp, "q3")).runtime()
    ref = _write_tone_ref(os.path.join(tmp, "bench_ref.wav"))
    bench = "\n[[CHUNK]]\n".join([XTTS_SENT] * 8)
    chunks = _request(bench, os.path.join(tmp, "q.wav"))["chunks"]
    texts = [render_clean_text_from_segments(ch.segments) for ch in chunks]
    spk = rt.speaker_embedding("voice_clone", "Vivian", ref)
    return (lambda n: _qwen3_decode(rt, texts, n, spk)), 192


def _xtts_decoder(dev, tmp: str):
    """The XTTS bench request's decode (bench_engine.py's 8 chunks, b 8), as
    ``_chatterbox_decoder``'s: ``(decode, n_dec)``, the bucket from one
    pipeline run of the request."""
    from vocalie_tts_tpu_torch.engines.xtts import XTTSEngine
    from vocalie_tts_tpu_torch.pipeline import run_tts_pipeline

    ref = _write_tone_ref(os.path.join(tmp, "bench_ref.wav"))
    engine = XTTSEngine(device=dev, assets=os.path.join(tmp, "xtts"))
    rt = _audible(engine.runtime())
    spk = rt._spk_cache.get(ref)
    bench = "\n[[CHUNK]]\n".join([XTTS_SENT] * 8)
    request = {**_request(bench, os.path.join(tmp, "x.wav")), "tts_backend": "xtts",
               "voice_ref_path": ref, "engine_params": XTTS_PARAMS}
    n_dec = run_tts_pipeline(request, engine=engine).meta["backend_meta"]["decode_bucket"]
    return (lambda n: _xtts_decode(rt, [XTTS_SENT] * 8, spk, n)), n_dec


def _time_decode(decode, n_steps: int, steps, reps: int, envs) -> dict:
    """``decode(n)`` (prefill, then ``n`` sampled steps, synchronized) timed
    as decode alone, ms/step: the request's prefill and steps less its
    prefill alone, over the steps ``steps`` counted; under each ``(label,
    env)`` of ``envs`` in turn, ``reps`` times each, after a warm-up under
    each (its path's first launches)."""
    out = {label: [] for label, _ in envs}
    for _, env in envs:
        set_env(env)
        decode(n_steps)
    for _ in range(reps):
        for label, env in envs:
            set_env(env)
            t1 = time.monotonic()
            decode(0)
            t2 = time.monotonic()
            n0 = steps.launches
            decode(n_steps)
            t3 = time.monotonic()
            out[label].append(((t3 - t2) - (t2 - t1)) / max(steps.launches - n0, 1) * 1e3)
    set_env(DEFAULT_ENV)
    return out


#: the decode paths ``time_decode_steps`` and ``time_stream_steps`` time on
#: one runtime: the SwiGLU families' default (B1 + B2 a layer) and B12, and
#: XTTS's default (B1 + B9b) and B9c
SWIGLU_ENVS = (("default", DEFAULT_ENV), ("VOCALIE_MEGALAYER=1", MEGALAYER_ENV))
XTTS_ENVS = (("default", DEFAULT_ENV), ("VOCALIE_MEGATAIL=0", MEGATAIL0_ENV))


def time_decode_steps(dev, reps: int = 3, scale: str = "full") -> dict:
    """The Chatterbox and Qwen3 bench requests' decode steps under
    ``SWIGLU_ENVS`` (the default B3 + L x (B1 + B2) + B5 + B4 a step, and
    ``VOCALIE_MEGALAYER=1``: B12 in place of B1 + B2) on one runtime each,
    ``_time_decode``'s ms/step, the envs alternating. Copied into an
    unpacked parent commit and run there, it times that commit on the same
    requests, so that two versions are compared within one call."""
    set_env(DEFAULT_ENV)
    os.environ["VOCALIE_MODEL_SCALE"] = scale
    os.environ["VOCALIE_ALLOW_RANDOM_WEIGHTS"] = "1"
    steps = _wrappers()["steps"]
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for family, decoder in (("chatterbox", _chatterbox_decoder), ("qwen3", _qwen3_decoder)):
            decode, n_dec = decoder(dev, tmp)
            out[family] = _time_decode(decode, n_dec, steps, reps, SWIGLU_ENVS)
            del decode
            torch.cuda.empty_cache()
    for family, rows in out.items():
        for env, ms in rows.items():
            log(f"decode steps [{family}, {env}]: " + ", ".join(f"{m:.3f}" for m in ms)
                + " ms/step")
    return out


def time_stream_steps(dev, reps: int = 3, scale: str = "full") -> dict:
    """The XTTS bench request's decode step under ``XTTS_ENVS`` (the default
    B9a + 24 x (B1 + B9b) + B5 + B4 a step, and ``VOCALIE_MEGATAIL=0``: B1 +
    B9c a layer) on one runtime, ``_time_decode``'s ms/step, the envs
    alternating; and the CosyVoice streaming request (B3 + B7 + B5 + B4 a
    step; first packet, sustained RTF, decode alone), ``reps`` times each
    after a warm-up. Copied into an unpacked parent commit and run there, it
    times that commit on the same requests, so that two versions are
    compared within one call."""
    from vocalie_tts_tpu_torch.engines.cosyvoice import CosyVoiceEngine

    set_env(DEFAULT_ENV)
    os.environ["VOCALIE_MODEL_SCALE"] = scale
    os.environ["VOCALIE_ALLOW_RANDOM_WEIGHTS"] = "1"
    steps = _wrappers()["steps"]
    out = {"cosyvoice_decode_ms_per_step": [], "cosyvoice_first_packet_ms": [],
           "cosyvoice_sustained_rtf": []}
    with tempfile.TemporaryDirectory() as tmp:
        decode, n_dec = _xtts_decoder(dev, tmp)
        out = {f"xtts_decode_ms_per_step, {label}": ms for label, ms in
               _time_decode(decode, n_dec, steps, reps, XTTS_ENVS).items()} | out
        del decode
        torch.cuda.empty_cache()
        cosy = CosyVoiceEngine(device=dev, assets=os.path.join(tmp, "cosy"))
        crt = cosy.runtime()
        _cosy_stream(cosy, crt)   # warm-up
        for _ in range(reps):
            first, audio_s, wall, _n, _ok = _cosy_stream(cosy, crt)
            out["cosyvoice_first_packet_ms"].append(first)
            out["cosyvoice_sustained_rtf"].append(audio_s / wall)
            t0 = time.monotonic()
            _cosy_decode(crt, 0)
            t1 = time.monotonic()
            _cosy_decode(crt, 320)
            t2 = time.monotonic()
            out["cosyvoice_decode_ms_per_step"].append(((t2 - t1) - (t1 - t0)) / 320 * 1e3)
    for key, vals in out.items():
        log(f"{key}: " + ", ".join(f"{v:.3f}" for v in vals))
    return out


def _stream_steps_only() -> int:
    """``--stream-steps``: B9b at the XTTS layer and B7 at the streaming
    shape (eager, graph, the wrapper's host µs whole and before the C call),
    then ``time_stream_steps``, printed as one JSON line."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    from vocalie_tts_tpu_torch.ops import _build
    from vocalie_tts_tpu_torch.ops import decode_dense as dd

    log(f"kernels built -> {_build.build().name}")
    dev = torch.device("cuda:0")
    rows = []
    t = _gelu_inputs(dev)
    b7 = _b7_inputs(dev)
    for name, call, iters in (
            (B9B_NAME, lambda i: dd.tail_gelu_qkv_int8_stacked(*t.tail, *t.nxt, i % t.L,
                                                               eps=t.eps), 300),
            ("B7 decode_step_fused", lambda i: b7.call(), 50)):
        ms, g_ms = timed(call, iters, name, iters)
        host, python = _wrapper_host_us(call)
        log(f"{name}: {ms:.6f} ms eager, {fmt_ms(g_ms)} ms graph, wrapper host time "
            f"{host:.2f} us a call, {python:.2f} us of it before the C call")
        rows.append({"name": name, "ms": ms, "graph_ms": g_ms, "host_us": host,
                     "host_python_us": python})
    del t, b7
    steps = time_stream_steps(dev)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    print(json.dumps({"rows": rows, "steps": steps}), flush=True)
    return 0


def _decode_steps_only() -> int:
    """``--decode-steps``: B2 at the T3 and Qwen3 shapes and B8a at the Qwen3
    shape (eager, graph, the wrapper's host µs whole and before the C call),
    then ``time_decode_steps``, printed as one JSON line."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    from vocalie_tts_tpu_torch.ops import _build
    from vocalie_tts_tpu_torch.ops import decode_dense as dd

    log(f"kernels built -> {_build.build().name}")
    dev = torch.device("cuda:0")
    rows = []
    for shape, names in ((T3_DENSE, TAIL_NAMES[:1]), (QWEN3_DENSE, TAIL_NAMES)):
        t = _dense_inputs(dev, shape)
        calls = {TAIL_NAMES[0]: lambda i, t=t: dd.tail_swiglu_qkv_int8_stacked(
                     *t.args, i % t.L, eps=t.eps),
                 TAIL_NAMES[1]: lambda i, t=t: dd.tail_swiglu_int8_stacked(
                     *t.tail, i % t.L, eps=t.eps)}
        for name in names:
            call = calls[name]
            ms, g_ms = timed(call, 300, f"{name} [{shape['label']}]")
            host, python = _wrapper_host_us(call)
            log(f"{name} [{shape['label']}]: {ms:.6f} ms eager, {fmt_ms(g_ms)} ms graph, "
                f"wrapper host time {host:.2f} us a call, {python:.2f} us of it before the C "
                "call")
            rows.append({"name": name, "shape": shape["label"], "ms": ms, "graph_ms": g_ms,
                         "host_us": host, "host_python_us": python})
        del t
    decode = time_decode_steps(dev)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    print(json.dumps({"rows": rows, "decode_ms_per_step": decode}), flush=True)
    return 0


def _f32_attention_only() -> int:
    """``--f32-attention [--sweep]``: build the kernels and run phase 2's
    K1, K2 and B10 rows alone (with ``--sweep``, also every split count:
    ``sweep_f32_splits``), then print them as one JSON line. Copied into an
    unpacked copy of another commit and run there (without ``--sweep``), it
    times that commit's kernels on the same rows."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    from vocalie_tts_tpu_torch.ops import _build

    log(f"kernels built -> {_build.build().name}")
    failures: list = []
    entries = check_f32_attention(torch.device("cuda:0"), failures)
    sweep = sweep_f32_splits(torch.device("cuda:0")) if "--sweep" in sys.argv else None
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    print(json.dumps({"kernels": entries, "sweep": sweep, "failures": failures}), flush=True)
    return 1 if failures else 0


def _tail_rows_only() -> int:
    """``--tail-rows``: build the kernels and run phase 2's dense rows at the
    T3 and Qwen3 shapes (B3, B2, B4; B8a, B8b) and the K4 and K5 rows, each
    eager and graph-timed, then count one B2 call's and one B8a call's CUDA
    kernels with torch.profiler (after every timing), and print the rows as
    one JSON line. Copied into an unpacked copy of another commit and run
    there, it times that commit's kernels on the same rows; a failed gate is
    printed, not fatal (the old B2 body is not one kernel)."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    from vocalie_tts_tpu_torch.ops import _build

    log(f"kernels built -> {_build.build().name}")
    for line in _build.build_log().splitlines():
        if "tail_swiglu" in line or ("registers" in line and "tail" in line):
            log("  " + line.strip()[:160])
    dev = torch.device("cuda:0")
    failures: list = []
    rows = check_dense(dev, failures) + check_dense(dev, failures, QWEN3_DENSE)
    rows += [check_cache_append_kv(dev, failures), check_cache_append_k(dev, failures)]
    t3 = _dense_inputs(dev).calls
    q3 = _dense_inputs(dev, QWEN3_DENSE).calls
    for name, call in ((TAIL_NAMES[0], t3[TAIL_NAMES[0]]), (TAIL_NAMES[1], q3[TAIL_NAMES[1]])):
        call()
        per_call = kernels_per_call(call)
        log(f"{name}: CUDA kernels per call (profiled): {sum(per_call.values())} ("
            + ", ".join(f"{_kernel_name(k)} x{n}" for k, n in sorted(per_call.items())) + ")")
        rows.append({"name": name, "cuda_kernels_per_call": sum(per_call.values())})
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    print(json.dumps({"rows": rows, "failures": failures}), flush=True)
    return 0


#: the phase points of a B3/B4 block (``stamps``; csrc/dense_int8.cu)
DENSE_PHASES = ("entry", "asked", "normed", "products", "met", "end")


def _dense_phases(dd, dev, x, nw, w, s, eps) -> dict:
    """One B3 (``nw`` set) or B4 call's phase points at layer 1, from its
    blocks' stamps (the last of three calls): for each point, the µs after
    the earliest entry at which the first and the last block reached it,
    beside the plan."""
    b, K = x.shape
    plan = dd._dense_launch(b, K, w.shape[2], dev.index or 0)
    stamps = torch.zeros((plan.grid, len(DENSE_PHASES)), dtype=torch.int64, device=dev)
    for _ in range(3):
        dd._launch_dense(x, nw, eps, w, s, 1, stamps=stamps)
    torch.cuda.synchronize()
    t = stamps.cpu().double()
    t = (t - t[:, 0].min()) / 1e3
    return {"plan": {k: getattr(plan, k) for k in ("grid", "ks", "spb", "kc", "tiles",
                                                    "smem")},
            **{name: [t[:, i].min().item(), t[:, i].max().item()]
               for i, name in enumerate(DENSE_PHASES)}}


def _dense_rows_only() -> int:
    """``--dense-rows``: build the kernels and run phase 2's B3 and B4 rows at
    the T3 and Qwen3 decode shapes (``check_b3_b4``: bit-equal to the plain
    versions and to the old chain, eager and graph ms of both, both
    wrappers' host µs), then one call of each at each shape that records its
    blocks' phase points (``_dense_phases``), then count one call's CUDA
    kernels of each with torch.profiler (after every timing), and print the
    rows as one JSON line. Copied into an unpacked copy of another commit
    and run there, it times that commit's B3 and B4 on the same rows (before
    their one launch: the old chain, no phase points); a failed gate is
    printed, not fatal."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    from vocalie_tts_tpu_torch.ops import _build
    from vocalie_tts_tpu_torch.ops import decode_dense as dd

    log(f"kernels built -> {_build.build().name}")
    name = ""
    for line in _build.build_log().splitlines():   # the body's registers and spills
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif "dense_int8_kernel" in name and ("registers" in line or "spill" in line):
            log(f"  {_kernel_name(name)[:60]}: {line.strip()}")
    dev = torch.device("cuda:0")
    failures: list = []
    rows, phases, counts = [], {}, {}
    for shape in (T3_DENSE, QWEN3_DENSE):
        t = _dense_inputs(dev, shape)
        rows += check_b3_b4(t, failures, shape["label"])
        for name, (nw, w, s, eps) in ((DENSE_ONE_NAMES[0], (t.nw, t.wq, t.sq, t.eps)),
                                      (DENSE_ONE_NAMES[1], (None, t.wh, t.sh, 0.0))):
            key = f"{name.split()[0]} [{shape['label']}]"
            if hasattr(dd, "_dense_launch"):
                phases[key] = _dense_phases(dd, dev, t.x, nw, w, s, eps)
                log(f"{key}: phase points (us from the first entry; first and last block) "
                    f"{phases[key]}")
            call = t.calls[name]
            call()
            per_call = kernels_per_call(call)
            counts[key] = sum(per_call.values())
            log(f"{key}: CUDA kernels per call (profiled): {counts[key]} ("
                + ", ".join(f"{_kernel_name(k)} x{n}" for k, n in sorted(per_call.items())) + ")")
        del t
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    print(json.dumps({"rows": rows, "phases": phases, "cuda_kernels_per_call": counts,
                      "failures": failures}), flush=True)
    return 0


def sweep_int8_splits(dev) -> dict:
    """B1 at the T3 and Qwen3 decode shapes graph-timed at every split count
    the valid blocks allow (``splits=``), beside the count ``int8_splits``
    picks on this card."""
    from vocalie_tts_tpu_torch.ops import decode_attention as da

    out = {}
    for label, attn in (("voice-over", T3_ATTN), ("qwen3", QWEN3_ATTN)):
        t = _b1_inputs(dev, **attn)
        n_blk = da.n_valid_blocks(t.valid_len, t.T)
        row = {"planned": _b1_splits(t)}
        for s in range(1, n_blk + 1):
            row[s] = graph_ms(lambda i, s=s: da.decode_attention_int8_stacked(
                t.q, t.k, t.v, t.bias, i % t.L, t.ks, t.vs, t.kn, t.vn, valid_len=t.valid_len,
                sm_scale=t.sm, splits=s))
        log(f"B1 [{label}] by split count (graph ms): "
            + ", ".join(f"{k}: {v:.6f}" for k, v in row.items() if k != "planned")
            + f"; planned {row['planned']}")
        out[label] = row
        del t
    return out


def _attn_gn_rows_only() -> int:
    """``--attn-gn-rows [--sweep]``: build the kernels and run phase 2's B1
    rows (the T3 and Qwen3 decode shapes, the adversarial cases) and B13
    rows (the four studio shapes), eager and graph-timed, then count one
    call's CUDA kernels of each at each shape with torch.profiler (after
    every timing), and print the rows as one JSON line; with ``--sweep``,
    also ``sweep_int8_splits``. Copied into an unpacked copy of another
    commit and run there (without ``--sweep``), it times that commit's
    kernels on the same rows; a failed gate is printed, not fatal (the old
    B13 is two kernels)."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    from vocalie_tts_tpu_torch.ops import _build

    log(f"kernels built -> {_build.build().name}")
    name = ""
    for line in _build.build_log().splitlines():   # the two kernels' registers and spills
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif ("attend_int8" in name or "gn_one_pass" in name) and "registers" in line:
            log(f"  {_kernel_name(name)[:60]}: {line.strip()}")
    dev = torch.device("cuda:0")
    failures: list = []
    rows = [check_decode_attention(dev, failures), check_group_norm(dev, failures)]
    sweep = sweep_int8_splits(dev) if "--sweep" in sys.argv else None
    counts = {}
    for key, call in _b1_b13_calls(dev).items():
        call()
        per_call = kernels_per_call(call)
        counts[key] = sum(per_call.values())
        log(f"{key}: CUDA kernels per call (profiled): {counts[key]} ("
            + ", ".join(f"{_kernel_name(k)} x{n}" for k, n in sorted(per_call.items())) + ")")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    print(json.dumps({"rows": rows, "cuda_kernels_per_call": counts, "sweep": sweep,
                      "failures": failures}), flush=True)
    return 0


def _layer_rows_only() -> int:
    """``--layer-rows``: build the kernels and run phase 2's B12 rows (the T3
    and Qwen3 layers, beside the B1 + B2 pair on the same inputs) and the
    B9c row (beside the old chain), eager and graph-timed, then B9b at the
    XTTS layer and B7 at the streaming shape (the other bodies on the same
    weight stream, ``int8_stream.cuh`` ``tma_load_tile``) eager and
    graph-timed, then count one call's CUDA kernels of B12 and B9c with
    torch.profiler (after every timing), and print it all as one JSON line.
    Copied into an unpacked copy of another commit and run there, it times
    that commit's kernels on the same rows; a failed gate is printed, not
    fatal (the old B9c is nine kernels). The decode steps these kernels run
    on are timed by ``--decode-steps`` (``VOCALIE_MEGALAYER=1``) and
    ``--stream-steps`` (``VOCALIE_MEGATAIL=0``)."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    from vocalie_tts_tpu_torch.ops import _build
    from vocalie_tts_tpu_torch.ops import decode_dense as dd

    log(f"kernels built -> {_build.build().name}")
    name = ""
    for line in _build.build_log().splitlines():   # the two kernels' registers and spills
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif ("decode_layer_kernel" in name or "tail_gelu_kernel" in name) and (
                "registers" in line or "spill" in line):
            log(f"  {_kernel_name(name)[:60]}: {line.strip()}")
    dev = torch.device("cuda:0")
    failures: list = []
    b12 = check_decode_layer(dev, failures)
    t = _gelu_inputs(dev)
    b9c = {k: v for k, v in b9c_row(t, failures).items() if k not in ("got", "ref")}
    b7 = _b7_inputs(dev)
    stream = {}
    for key, call, iters in (
            (B9B_NAME, lambda i: dd.tail_gelu_qkv_int8_stacked(*t.tail, *t.nxt, i % t.L,
                                                               eps=t.eps), 300),
            ("B7 decode_step_fused", lambda i: b7.call(), 50)):
        ms, g_ms = timed(call, iters, key, iters)
        log(f"{key}: {ms:.6f} ms eager, {fmt_ms(g_ms)} ms graph")
        stream[key] = {"ms": ms, "graph_ms": g_ms}
    del b7
    calls = {B12_NAME: _b12_inputs(dev).call, f"{B12_NAME} [qwen3]":
             _b12_inputs(dev, QWEN3_ATTN).call, B9C_NAME: t.calls[B9C_NAME]}
    counts = {}
    for key, call in calls.items():
        call()
        # a call of which the profiler saw nothing is counted once more (it
        # has missed one after other profiled windows: count_dense_kernels)
        per_call = kernels_per_call(call) or kernels_per_call(call)
        counts[key] = sum(per_call.values())
        log(f"{key}: CUDA kernels per call (profiled): {counts[key]} ("
            + ", ".join(f"{_kernel_name(k)} x{n}" for k, n in sorted(per_call.items())) + ")")
    del calls, t
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    print(json.dumps({"b12": b12, "b9c": b9c, "stream": stream, "cuda_kernels_per_call": counts,
                      "failures": failures}), flush=True)
    return 0


def _studio_input(path: str, seconds: float = 89.35) -> dict:
    """A 24 kHz WAV of ``seconds`` (the Chatterbox bench request's length in
    PERF.md's studio row; a tone under seeded noise), as ``drive_audiosr``'s
    ``vo``: the studio's work depends on the length only."""
    import numpy as np

    from vocalie_tts_tpu_torch.io.wavio import write_wav

    n = int(seconds * 24000)
    t = np.arange(n) / 24000.0
    rng = np.random.default_rng(3)
    wav = 0.2 * np.sin(2 * np.pi * 180 * t) + 0.02 * rng.standard_normal(n)
    write_wav(path, wav.astype(np.float32), 24000)
    return {"wav": path, "audio_s": n / 24000, "wall_s": 0.0, "label": "a generated input"}


def time_e2e(dev, reps: int = 3, scale: str = "full") -> dict:
    """The two end-to-end rows B1 and B13 sit on, ``reps`` timings each
    after a warm-up: the Chatterbox default decode (the bench request, 8
    chunks CFG-doubled: B3 + 30 x (B1 + B2) + B5 + B4 a step; decode alone,
    ms/step, as phase 4 times it) and one profiled window of its prefill +
    32 steps (busy share, device operations a step); the studio pass
    (``enhance_file`` at bench.py's settings with ``VOCALIE_GN_PALLAS=1``
    on a generated input of the bench request's length: wall s) and one
    profiled UNet call at its first dispatch's CFG batch. Copied into an
    unpacked parent commit and run there, it times that commit on the same
    work, so that two versions are compared within one call."""
    from vocalie_tts_tpu_torch.models.audiosr.model import latent_shape
    from vocalie_tts_tpu_torch.models.audiosr.runtime import AudioSRRuntime
    from vocalie_tts_tpu_torch.models.common.unet2d import apply_unet2d

    set_env(DEFAULT_ENV)
    os.environ["VOCALIE_MODEL_SCALE"] = scale
    os.environ["VOCALIE_ALLOW_RANDOM_WEIGHTS"] = "1"
    steps = _wrappers()["steps"]
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        decode, n_dec = _chatterbox_decoder(dev, tmp)
        ms = _time_decode(decode, n_dec, steps, reps, SWIGLU_ENVS[:1])["default"]
        n0 = _profiled("Chatterbox default, prefill alone", lambda: decode(0))
        n32 = _profiled("Chatterbox default, prefill + 32 decode steps", lambda: decode(32))
        out["chatterbox_default"] = {"decode_ms_per_step": ms, **_profiled.last,
                                     "ops_per_step": (n32 - n0) / 32 if n0 and n32 else None}
        log("e2e [Chatterbox default]: decode " + ", ".join(f"{m:.3f}" for m in ms)
            + f" ms/step; {out['chatterbox_default']['ops_per_step']} device operations a step")
        del decode
        torch.cuda.empty_cache()
        vo = _studio_input(os.path.join(tmp, "vo.wav"))
        srt = AudioSRRuntime.create(os.path.join(tmp, "sr"), device=dev)
        _set_gn("1")
        path = os.path.join(tmp, "studio.wav")
        srt.enhance_file(input_path=vo["wav"], output_path=path, **{**STUDIO, "ddim_steps": 2})
        walls = []
        for _ in range(reps):
            t0 = time.monotonic()
            srt.enhance_file(input_path=vo["wav"], output_path=path, **STUDIO)
            walls.append(time.monotonic() - t0)
        cfg = srt.cfg
        lat = (*latent_shape(cfg, 2 * 64, STUDIO["chunk_size"])[:3], cfg.unet.in_channels)
        gen = torch.Generator(device=dev).manual_seed(16)
        x = torch.randn(lat, generator=gen, device=dev).to(cfg.dtype)
        tt = torch.full((lat[0],), 500.0, device=dev)
        apply_unet2d(srt.params["unet"], cfg.unet, x, tt)
        _profiled(f"studio, one UNet call x{list(lat)}",
                  lambda: apply_unet2d(srt.params["unet"], cfg.unet, x, tt))
        out["studio_gn_pallas"] = {"audio_in_s": vo["audio_s"], "wall_s": walls,
                                   "unet_call": _profiled.last}
        log("e2e [studio, VOCALIE_GN_PALLAS=1]: wall " + ", ".join(f"{w:.3f}" for w in walls)
            + " s")
        _set_gn(None)
    set_env(DEFAULT_ENV)
    return out


def _e2e_ab_only() -> int:
    """``--e2e-ab``: ``time_e2e``, printed as one JSON line."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    from vocalie_tts_tpu_torch.ops import _build

    log(f"kernels built -> {_build.build().name}")
    res = time_e2e(torch.device("cuda:0"))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    print(json.dumps(res), flush=True)
    return 0


def _qwen3_decode_kernel_only() -> int:
    """``--qwen3-decode-kernel``: ``time_qwen3_decode_kernel`` alone."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    time_qwen3_decode_kernel(torch.device("cuda:0"))
    return 0


if __name__ == "__main__":
    modes = {"--count-kernels": _count_kernels_child, "--f32-attention": _f32_attention_only,
             "--qwen3-decode-kernel": _qwen3_decode_kernel_only, "--tail-rows": _tail_rows_only,
             "--decode-steps": _decode_steps_only, "--stream-steps": _stream_steps_only,
             "--attn-gn-rows": _attn_gn_rows_only, "--e2e-ab": _e2e_ab_only,
             "--layer-rows": _layer_rows_only, "--dense-rows": _dense_rows_only}
    sys.exit(modes[sys.argv[1]]() if sys.argv[1:2] and sys.argv[1] in modes else main())
