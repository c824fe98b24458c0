"""CosyVoice-class runtime: offline batches and true incremental streaming
(counterpart of ``vocalie_tts_tpu/models/cosyvoice/runtime.py``).

Offline (``synthesize_batch``): byte prompts [BOS] preamble [SEP] text,
padded into (batch, prompt) buckets → one prefill → one decode loop for
every row → ONE stage-2 call (clip, mask, CFM, HiFT, int16) → one host
read.

Streaming (``synthesize_streaming``): one prefill, then per window decode W
tokens → clip → mask → CFM → vocoder → int16, with one device→host read
per window. Up to ``VOCALIE_STREAM_DEPTH`` (default 2) windows are queued
on the card ahead of the read, so the card decodes window N+1 while the
host yields window N. The first window is 8 tokens (first-packet latency),
later ones ``VOCALIE_STREAM_WINDOW`` (default 48). At batch 1 every decode
step is the B3 prologue + the whole-step kernel B7 + B5 + B4.
``VOCALIE_STREAM_FUSED=0`` (the JAX package's unfused window programs, kept
there for bisection) raises: the port has one streaming dispatch.

Random numbers come from the runtime's ``torch.Generator``: sampling, and
the CFM start noise drawn by :meth:`CosyVoiceRuntime._stage2_noise` (the
tests replace it with the JAX package's draws). Zero-shot clone and
cross-lingual need the S3 tokenizer and the speaker encoder, which the
port does not have yet: a ``voice_ref_path`` raises (``SpeakerEmbedCache``).
"""

from __future__ import annotations

import dataclasses
import os
import time
from collections import deque
from pathlib import Path
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from vocalie_tts_tpu_torch.device import resolve_device
from vocalie_tts_tpu_torch.models.common.ar_runtime import (
    SpeakerEmbedCache,
    apply_runtime_env,
    from_pcm16_wire,
    make_generate_fn,
    make_streaming_fns,
    maybe_quantize_lm,
    pad_token_batch,
    to_pcm16_wire,
)
from vocalie_tts_tpu_torch.models.common.token2wav import Stage2Noise
from vocalie_tts_tpu_torch.models.common.weights import checkpoint_exists, load_meta, load_params
from vocalie_tts_tpu_torch.models.cosyvoice.model import (
    TOKENS_PER_SECOND,
    CosyVoiceConfig,
    build_prompt_embeds,
    init_cfm_decoder,
    init_cosyvoice_lm,
    mel_to_audio,
    speech_logit_bias,
    tokens_to_mel,
)
from vocalie_tts_tpu_torch.ops.kv_cache import pick_bucket, round_cache_len
from vocalie_tts_tpu_torch.text.duration import estimate_duration
from vocalie_tts_tpu_torch.text.frontend import build_prompt_ids, load_frontend
from vocalie_tts_tpu_torch.utils.env import bool_env

PROMPT_BUCKETS = (64, 128, 256, 512)
DECODE_BUCKETS = (64, 128, 256, 320)
BATCH_BUCKETS = (1, 2, 4, 8)
#: the first streamed window: the first packet waits for this many tokens
STREAM_WINDOW_TOKENS = 8
#: later windows: fewer host reads per second of audio
STREAM_WINDOW_SUSTAIN = int(os.environ.get("VOCALIE_STREAM_WINDOW", "48"))
#: windows queued on the card ahead of the host read
STREAM_PIPELINE_DEPTH = max(1, int(os.environ.get("VOCALIE_STREAM_DEPTH", "2")))

SCALES: Dict[str, CosyVoiceConfig] = {
    "full": CosyVoiceConfig(),
    "small": CosyVoiceConfig(d_model=512, n_layers=8, n_heads=8, n_kv_heads=8, d_ff=2048,
                             t2w_scale="small"),
    "tiny": CosyVoiceConfig(d_model=64, n_layers=2, n_heads=4, n_kv_heads=2, d_ff=128,
                            max_seq_len=512, t2w_scale="tiny", dtype=torch.float32),
}


def stream_window_schedule(decode_bucket: int) -> list:
    """Window sizes for one streamed utterance: a small first window, then
    ``STREAM_WINDOW_SUSTAIN`` tokens, the last one cut to the bucket."""
    schedule = [STREAM_WINDOW_TOKENS]
    consumed = STREAM_WINDOW_TOKENS
    while consumed < decode_bucket:
        w = min(STREAM_WINDOW_SUSTAIN, decode_bucket - consumed)
        schedule.append(w)
        consumed += w
    return schedule


class CosyVoiceRuntime:
    def __init__(self, params: Dict[str, Any], cfg: CosyVoiceConfig, weights_dir: Path,
                 device: torch.device, seed: int = 0) -> None:
        self.params = params  # {"lm_bundle": {"lm", "text_emb", "spk_cond"}, "decoder": ...}
        self.cfg = cfg
        self.device = device
        self.weights_dir = Path(weights_dir)
        self._frontend = load_frontend(self.weights_dir.parent, style="raw",
                                       text_vocab=cfg.text_vocab)
        self._gen = torch.Generator(device=device).manual_seed(seed)
        self._logit_bias = speech_logit_bias(cfg, device)
        self._generate = make_generate_fn(cfg.lm, self._logit_bias)
        self._stream_prefill, self._stream_window = make_streaming_fns(cfg.lm, self._logit_bias)
        self._spk_cache = SpeakerEmbedCache(cfg.speaker_dim)

    # ── lifecycle ───────────────────────────────────────────────────────

    @classmethod
    def create(cls, assets_dir: Path, force_init: bool = False, *,
               device: str | torch.device = "cuda", seed: int = 31) -> "CosyVoiceRuntime":
        """Build the runtime from ``<assets_dir>/weights/{lm,flow}.npz`` (the
        JAX package's format; the flow bundle's speaker encoder is not
        read), or from random weights made from ``seed`` where a checkpoint
        is absent or ``force_init``."""
        dev = resolve_device(device)
        cfg = apply_runtime_env(SCALES[os.environ.get("VOCALIE_MODEL_SCALE", "full")])
        weights_dir = Path(assets_dir) / "weights"
        if not force_init:
            meta = load_meta(weights_dir, "lm")
            tv = int(meta.get("text_vocab", cfg.text_vocab))
            sv = int(meta.get("speech_vocab", cfg.speech_vocab))
            if (tv, sv) != (cfg.text_vocab, cfg.speech_vocab):
                cfg = dataclasses.replace(cfg, text_vocab=tv, speech_vocab=sv)
        gen = torch.Generator(device=dev).manual_seed(seed)
        bundle = init_cosyvoice_lm(cfg, generator=gen, device=dev)
        if not force_init and checkpoint_exists(weights_dir, "lm"):
            bundle = load_params(weights_dir, "lm", bundle, dev)
        dec = init_cfm_decoder(cfg, generator=gen, device=dev)
        if not force_init and checkpoint_exists(weights_dir, "flow"):
            dec = load_params(weights_dir, "flow", dec, dev)
        params = {"lm_bundle": maybe_quantize_lm(bundle), "decoder": dec}
        return cls(params, cfg, weights_dir, dev, seed=seed)

    def warmup(self) -> None:
        self.synthesize("Préchauffage.", mode="instruct", language="French")

    # ── synthesis ───────────────────────────────────────────────────────

    def synthesize(self, text: str, **kwargs) -> Tuple[np.ndarray, int, Dict[str, Any]]:
        return self.synthesize_batch([text], **kwargs)[0]

    def synthesize_batch(
        self,
        texts: List[str],
        *,
        mode: str = "instruct",
        language: Optional[str] = "French",
        instruct_text: str = "",
        prompt_text: str = "",
        streaming: bool = False,
        voice_ref_path: Optional[str] = None,
        temperature: float = 0.8,
        top_k: int = 50,
        progress_cb=None,
        **_ignored,
    ) -> List[Tuple[np.ndarray, int, Dict[str, Any]]]:
        t0 = time.monotonic()
        kw = dict(mode=mode, instruct_text=instruct_text, prompt_text=prompt_text,
                  voice_ref_path=voice_ref_path, temperature=temperature, top_k=top_k)
        if streaming:
            # the first row streams; the others (batch > 1) render offline
            packets: List[np.ndarray] = []
            first_packet_ms = None
            n_tokens = 0
            for packet, _sr in self.synthesize_streaming(texts[0], language=language, **kw):
                if first_packet_ms is None:
                    first_packet_ms = round((time.monotonic() - t0) * 1000, 1)
                packets.append(packet)
                n_tokens += len(packet) // self.cfg.samples_per_token
            audio_rows = [np.concatenate(packets) if packets else np.zeros(0, np.float32)]
            lengths_out = [n_tokens]
            if len(texts) > 1:
                tokens, tok_lengths, spk_b, meta_common = self._lm_tokens(texts[1:], **kw)
                audio_full, tok_lengths = self._offline_audio(tokens, tok_lengths, spk_b)
                audio_rows += list(audio_full)
                lengths_out += [int(n) for n in tok_lengths[: len(texts) - 1]]
            else:
                meta_common = {"engine": "cosyvoice", "mode": mode}
            metas = [dict(meta_common, streaming=True, first_packet_ms=first_packet_ms)]
            metas += [dict(meta_common, streaming=True) for _ in texts[1:]]
        else:
            tokens, tok_lengths, spk_b, meta_common = self._lm_tokens(texts, **kw)
            audio_full, tok_lengths = self._offline_audio(tokens, tok_lengths, spk_b)
            audio_rows = list(audio_full)
            lengths_out = [int(n) for n in tok_lengths[: len(texts)]]
            metas = [dict(meta_common) for _ in texts]

        elapsed = time.monotonic() - t0
        out = []
        for i in range(len(texts)):
            n = lengths_out[i] * self.cfg.samples_per_token
            meta = metas[i]
            meta.update({"speech_tokens": lengths_out[i], "elapsed_ms": round(elapsed * 1000, 1)})
            out.append((audio_rows[i][:n], self.cfg.sample_rate, meta))
            if progress_cb:
                progress_cb((i + 1) / len(texts))
        return out

    def _prompt_ids(self, text: str, mode: str, instruct_text: str, prompt_text: str):
        preamble = instruct_text if mode == "instruct" else (
            prompt_text if mode == "clone" else "")
        return build_prompt_ids(self._frontend, text, preamble=preamble)

    def _stage2_noise(self, batch: int, n_tok: int) -> Stage2Noise:
        """The CFM start noise for ``batch`` rows of ``n_tok`` tokens (HiFT's
        source is deterministic on this path, as in the JAX runtime)."""
        t2w = self.cfg.t2w
        return Stage2Noise(z=torch.randn((batch, n_tok * t2w.token_mel_ratio, t2w.n_mels),
                                         generator=self._gen, device=self.device))

    @torch.no_grad()
    def stage2_pcm16(self, tokens: torch.Tensor, n_valid: torch.Tensor, spk: torch.Tensor,
                     noise: Stage2Noise) -> torch.Tensor:
        """Control-id strip + validity mask + CFM + vocoder → int16 PCM on
        the device (the JAX ``_stage2_nc`` / the stage-2 half of
        ``_stream_chain``)."""
        cfg = self.cfg
        speech = torch.clamp(tokens, 0, cfg.speech_vocab - 1)
        mask = (torch.arange(tokens.shape[1], device=tokens.device)[None, :]
                < n_valid[:, None]).float()
        mel = tokens_to_mel(self.params["decoder"], cfg, speech, mask, spk, noise.z)
        return to_pcm16_wire(mel_to_audio(self.params["decoder"], cfg, mel))

    @torch.no_grad()
    def synthesize_streaming(
        self,
        text: str,
        *,
        mode: str = "instruct",
        language: Optional[str] = "French",
        instruct_text: str = "",
        prompt_text: str = "",
        voice_ref_path: Optional[str] = None,
        temperature: float = 0.8,
        top_k: int = 50,
        **_ignored,
    ) -> Iterator[Tuple[np.ndarray, int]]:
        """Yield (audio_window, sr) packets: prefill → [decode W tokens →
        CFM → vocoder → yield]*; the first packet waits for one window."""
        if not bool_env("VOCALIE_STREAM_FUSED", True):
            raise NotImplementedError(
                "VOCALIE_STREAM_FUSED=0 runs the JAX package's unfused window programs (decode, "
                "tokens-to-mel and mel-to-audio dispatched apart, each with its own rng split); "
                "the port has one streaming dispatch; unset it"
            )
        cfg, dev = self.cfg, self.device
        spk = torch.from_numpy(self._spk_cache.get(voice_ref_path)[None]).to(dev)
        bundle = self.params["lm_bundle"]
        parts = self._prompt_ids(text, mode, instruct_text, prompt_text)
        tokens, lengths, prompt_bucket, _bb = pad_token_batch(
            [parts], prompt_buckets=PROMPT_BUCKETS, batch_buckets=(1,), extra_positions=2)
        est_tokens = int(estimate_duration(text) * TOKENS_PER_SECOND * 1.8) + 8
        decode_bucket = pick_bucket(est_tokens, DECODE_BUCKETS)
        cache_len = round_cache_len(prompt_bucket + decode_bucket)

        embeds = build_prompt_embeds(bundle, cfg, torch.from_numpy(tokens).to(dev), spk)
        cache = self._stream_prefill(bundle["lm"], embeds, torch.from_numpy(lengths).to(dev),
                                     cache_len=cache_len)
        prev = torch.full((1,), cfg.bos_speech, dtype=torch.int64, device=dev)
        done = torch.zeros((1,), dtype=torch.bool, device=dev)

        def dispatch_window(cache, prev, done, w):
            """Queue window decode + CFM + vocoder with no host read; the
            packet's valid count, done flag and int16 PCM leave the card as
            ONE int32 array."""
            toks, n_valid, prev, done, cache = self._stream_window(
                bundle["lm"], cache, prev, done, window=w, eos_token_id=cfg.eos_speech,
                temperature=float(temperature), top_k=int(top_k), generator=self._gen)
            pcm = self.stage2_pcm16(toks, n_valid, spk, self._stage2_noise(1, w))
            wire = torch.cat([n_valid.to(torch.int32), done.to(torch.int32),
                              pcm.reshape(-1).to(torch.int32)])
            return wire, prev, done, cache

        schedule = stream_window_schedule(decode_bucket)
        in_flight: deque = deque()
        state = (cache, prev, done)
        next_i = 0

        def queue_next(cache, prev, done):
            nonlocal next_i
            if next_i >= len(schedule):
                return cache, prev, done
            wire, prev, done, cache = dispatch_window(cache, prev, done, schedule[next_i])
            next_i += 1
            in_flight.append(wire)
            return cache, prev, done

        for _ in range(min(STREAM_PIPELINE_DEPTH, len(schedule))):
            state = queue_next(*state)
        while in_flight:
            wire = in_flight.popleft().cpu().numpy()
            n, finished = int(wire[0]), bool(wire[1])
            if n > 0:
                pcm = from_pcm16_wire(wire[2:].astype(np.int16))
                yield pcm[: n * cfg.samples_per_token], cfg.sample_rate
            if finished:
                break
            state = queue_next(*state)

    # ── internals ───────────────────────────────────────────────────────

    def _lm_tokens(self, texts, *, mode="instruct", instruct_text="", prompt_text="",
                   voice_ref_path=None, temperature=0.8, top_k=50):
        cfg, dev = self.cfg, self.device
        spk = self._spk_cache.get(voice_ref_path)
        bundle = self.params["lm_bundle"]
        seqs = [self._prompt_ids(t, mode, instruct_text, prompt_text) for t in texts]
        tokens, lengths, prompt_bucket, batch_bucket = pad_token_batch(
            seqs, prompt_buckets=PROMPT_BUCKETS, batch_buckets=BATCH_BUCKETS,
            extra_positions=2)  # spk slot + BOS
        spk_b = torch.from_numpy(np.tile(spk[None], (batch_bucket, 1))).to(dev)
        est_tokens = max(int(estimate_duration(t) * TOKENS_PER_SECOND * 1.8) + 8 for t in texts)
        decode_bucket = pick_bucket(est_tokens, DECODE_BUCKETS)
        cache_len = round_cache_len(prompt_bucket + decode_bucket)
        embeds = build_prompt_embeds(bundle, cfg, torch.from_numpy(tokens).to(dev), spk_b)
        out_tokens, tok_lengths = self._generate(
            bundle["lm"], embeds, torch.from_numpy(lengths).to(dev), cache_len=cache_len,
            max_new=decode_bucket, eos_token_id=cfg.eos_speech, temperature=float(temperature),
            top_k=int(top_k), first_token=cfg.bos_speech, generator=self._gen)
        meta = {"engine": "cosyvoice", "mode": mode, "prompt_bucket": prompt_bucket,
                "decode_bucket": decode_bucket}
        return out_tokens, tok_lengths, spk_b, meta

    def _offline_audio(self, tokens, tok_lengths, spk_b):
        """Device LM tokens → (audio [b, T] f32, tok_lengths np): ONE stage-2
        call queued behind the decode loop, then one host read."""
        pcm = self.stage2_pcm16(tokens, tok_lengths, spk_b,
                                self._stage2_noise(tokens.shape[0], tokens.shape[1]))
        wire = torch.cat([tok_lengths.to(torch.int32), pcm.reshape(-1).to(torch.int32)]).cpu()
        b = tokens.shape[0]
        tl = wire[:b].numpy()
        audio = from_pcm16_wire(wire[b:].numpy().astype(np.int16).reshape(b, -1))
        return audio, tl


__all__ = ["CosyVoiceRuntime", "SCALES", "PROMPT_BUCKETS", "DECODE_BUCKETS", "BATCH_BUCKETS",
           "STREAM_WINDOW_TOKENS", "STREAM_WINDOW_SUSTAIN", "STREAM_PIPELINE_DEPTH",
           "stream_window_schedule"]
