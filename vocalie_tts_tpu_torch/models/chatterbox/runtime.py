"""Chatterbox-class engine runtime: batched CFG decode on resident state
(counterpart of ``vocalie_tts_tpu/models/chatterbox/runtime.py``).

Per script (N chunks):
  1. byte-tokenize the chunks, pad into (batch, prompt) buckets;
  2. ONE prefill over the doubled CFG batch [cond; uncond];
  3. ONE decode loop for every chunk at once;
  4. ONE stage-2 token → waveform call, int16 PCM back to the host.
Long text that produced suspiciously short audio is retried once with
+0.05 CFG / −0.05 temperature (the longer take is kept).

Random numbers come from the runtime's ``torch.Generator`` (seeded at
``create``); greedy decoding (temperature <= 0) needs none.
"""

from __future__ import annotations

import dataclasses
import os
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from vocalie_tts_tpu_torch.device import resolve_device
from vocalie_tts_tpu_torch.models.chatterbox.model import (
    TOKENS_PER_SECOND,
    XVECTOR_DIM,
    T3Config,
    build_prompt_embeds,
    init_t3,
    init_token_decoder,
    speech_logit_bias,
    tokens_to_audio,
)
from vocalie_tts_tpu_torch.models.common.ar_runtime import (
    apply_runtime_env,
    from_pcm16_wire,
    maybe_quantize_lm,
    to_pcm16_wire,
)
from vocalie_tts_tpu_torch.models.common.token2wav import Stage2Noise, draw_stage2_noise
from vocalie_tts_tpu_torch.models.common.transformer import (
    decode_step,
    prefill,
    unfuse_decode_weights,
)
from vocalie_tts_tpu_torch.models.common.weights import (
    check_saveable,
    checkpoint_exists,
    load_meta,
    load_params,
    save_params,
)
from vocalie_tts_tpu_torch.ops.generate import GenerateConfig, generate_tokens
from vocalie_tts_tpu_torch.ops.kv_cache import pick_bucket, round_cache_len
from vocalie_tts_tpu_torch.text.duration import estimate_duration
from vocalie_tts_tpu_torch.text.frontend import load_frontend

PROMPT_BUCKETS = (64, 128, 256, 512)
DECODE_BUCKETS = (64, 128, 256, 320)
BATCH_BUCKETS = (1, 2, 4, 8)

#: model scales — "full" is the published Chatterbox T3 scale (~0.5B
#: params); smaller scales serve the CPU tests
SCALES: Dict[str, T3Config] = {
    "full": T3Config(),
    "small": T3Config(d_model=512, n_layers=8, n_heads=8, n_kv_heads=8, d_ff=2048,
                      t2w_scale="small"),
    "tiny": T3Config(d_model=64, n_layers=2, n_heads=4, n_kv_heads=2, d_ff=128,
                     max_seq_len=512, t2w_scale="tiny", dtype=torch.float32),
}


def _scale_from_env() -> str:
    return os.environ.get("VOCALIE_MODEL_SCALE", "full")


class ChatterboxRuntime:
    def __init__(self, params: Dict[str, Any], cfg: T3Config, weights_dir: Path,
                 device: torch.device, seed: int = 0) -> None:
        self.params = params  # {"t3": ..., "t3_fr": ..., "decoder": ...}
        self.cfg = cfg
        self.device = device
        self.weights_dir = Path(weights_dir)
        self._frontend = load_frontend(self.weights_dir.parent, text_vocab=cfg.text_vocab)
        self._gen = torch.Generator(device=device).manual_seed(seed)
        self._logit_bias = speech_logit_bias(cfg, device)

    # ── lifecycle ───────────────────────────────────────────────────────

    @classmethod
    def create(cls, assets_dir: Path, force_init: bool = False, *,
               device: str | torch.device = "cuda", seed: int = 7) -> "ChatterboxRuntime":
        """Build the runtime from ``<assets_dir>/weights/{t3,s3gen,t3_fr}.npz``
        (the JAX package's format), or from random weights made from
        ``seed`` where a checkpoint is absent or ``force_init``."""
        dev = resolve_device(device)
        cfg = apply_runtime_env(SCALES[_scale_from_env()])
        weights_dir = Path(assets_dir) / "weights"
        if not force_init:
            meta = load_meta(weights_dir, "t3")
            tv = int(meta.get("text_vocab", cfg.text_vocab))
            sv = int(meta.get("speech_vocab", cfg.speech_vocab))
            if (tv, sv) != (cfg.text_vocab, cfg.speech_vocab):
                cfg = dataclasses.replace(cfg, text_vocab=tv, speech_vocab=sv)
        gen = torch.Generator(device=dev).manual_seed(seed)

        def _have(name: str) -> bool:
            return not force_init and checkpoint_exists(weights_dir, name)

        t3 = init_t3(cfg, generator=gen, device=dev)
        if _have("t3"):
            t3 = load_params(weights_dir, "t3", t3, dev)
        dec = init_token_decoder(cfg, generator=gen, device=dev)
        if _have("s3gen"):
            dec = load_params(weights_dir, "s3gen", dec, dev)
        params = {"t3": maybe_quantize_lm(t3), "decoder": dec}
        # FR fine-tune: overlay on the T3 stage only
        if checkpoint_exists(weights_dir, "t3_fr"):
            params["t3_fr"] = maybe_quantize_lm(load_params(weights_dir, "t3_fr", t3, dev))
        else:
            params["t3_fr"] = params["t3"]
        return cls(params, cfg, weights_dir, dev, seed=seed)

    def save_weights(self) -> None:
        """Write ``t3`` (the LM unfused, with the vocabularies in its meta)
        and ``s3gen`` in the JAX package's format (JAX ``save_weights``);
        int8 weights are refused, as in JAX."""
        check_saveable(self.params)
        t3 = self.params["t3"]
        save_params(self.weights_dir, "t3",
                    {**t3, "lm": unfuse_decode_weights(t3["lm"], self.cfg.lm)},
                    meta={"family": "chatterbox", "stage": "t3",
                          "text_vocab": self.cfg.text_vocab,
                          "speech_vocab": self.cfg.speech_vocab})
        save_params(self.weights_dir, "s3gen", self.params["decoder"],
                    meta={"family": "chatterbox", "stage": "s3gen"})

    def warmup(self) -> None:
        self.synthesize("Bonjour, préchauffage du moteur.", mode="fr_finetune")

    # ── synthesis ───────────────────────────────────────────────────────

    def synthesize(self, text: str, **kwargs) -> Tuple[np.ndarray, int, Dict[str, Any]]:
        return self.synthesize_batch([text], **kwargs)[0]

    def synthesize_batch(
        self,
        texts: List[str],
        *,
        mode: str = "fr_finetune",
        lang: Optional[str] = None,
        voice_ref_path: Optional[str] = None,
        exaggeration: float = 0.5,
        cfg_weight: float = 0.6,
        temperature: float = 0.5,
        repetition_penalty: float = 1.35,
        progress_cb=None,
        _retry: bool = True,
    ) -> List[Tuple[np.ndarray, int, Dict[str, Any]]]:
        if voice_ref_path:
            raise NotImplementedError(
                "voice references need the speaker encoders, which the port "
                "does not have yet"
            )
        t0 = time.monotonic()
        kw = dict(mode=mode, lang=lang, exaggeration=exaggeration,
                  repetition_penalty=repetition_penalty)
        results = self._decode_batch(texts, cfg_weight=cfg_weight, temperature=temperature, **kw)
        if _retry:
            retry_idx = [
                i for i, (audio, sr, _m) in enumerate(results)
                if len(texts[i]) > 80 and len(audio) / sr < 1.2
            ]
            if retry_idx:
                retry_out = self._decode_batch(
                    [texts[i] for i in retry_idx],
                    cfg_weight=min(cfg_weight + 0.05, 1.0),
                    temperature=max(temperature - 0.05, 0.05), **kw,
                )
                for j, i in enumerate(retry_idx):
                    new_audio, sr, meta = retry_out[j]
                    if len(new_audio) > len(results[i][0]):
                        results[i] = (new_audio, sr, {**meta, "retry": True})
        elapsed = time.monotonic() - t0
        out = []
        for i, (audio, sr, meta) in enumerate(results):
            out.append((audio, sr, {**meta, "elapsed_ms_batch": round(elapsed * 1000, 1)}))
            if progress_cb:
                progress_cb((i + 1) / len(results))
        return out

    def _prepare_batch(self, texts: List[str], *, mode: str, lang: Optional[str],
                       exaggeration: float, cfg_weight: float):
        """Tokenize, bucket and build the CFG-doubled prompt embeds →
        ``(t3, embeds, prompt_lengths, (batch, prompt, decode, cache_len))``."""
        cfg, dev = self.cfg, self.device
        t3 = self.params["t3_fr"] if mode == "fr_finetune" else self.params["t3"]
        front = self._frontend
        fr_lang = (lang or "fr").split("-")[0].lower()
        token_seqs = [front.bos_ids + front.encode(t, fr_lang) for t in texts]
        prompt_bucket = pick_bucket(max(len(s) + 3 for s in token_seqs), PROMPT_BUCKETS)
        batch_bucket = pick_bucket(len(texts), BATCH_BUCKETS)
        est_tokens = max(
            int(estimate_duration(t) * TOKENS_PER_SECOND * 1.8) + 16 for t in texts
        )
        decode_bucket = pick_bucket(est_tokens, DECODE_BUCKETS)
        cache_len = round_cache_len(prompt_bucket + decode_bucket)

        text_tokens = np.zeros((batch_bucket, prompt_bucket - 3), np.int64)
        lengths = np.full((batch_bucket,), 3, np.int32)  # empty rows: cond slots + BOS
        for i, s in enumerate(token_seqs):
            s = s[: prompt_bucket - 3]
            text_tokens[i, : len(s)] = s
            lengths[i] = len(s) + 3

        spk = torch.zeros((batch_bucket, cfg.speaker_dim), device=dev)
        exag = torch.full((batch_bucket,), float(exaggeration), device=dev)
        tt = torch.from_numpy(text_tokens).to(dev)
        lens = torch.from_numpy(lengths).to(dev)
        embeds = build_prompt_embeds(t3, cfg, tt, spk, exag)
        if cfg_weight > 0:
            uncond = build_prompt_embeds(t3, cfg, tt, torch.zeros_like(spk), torch.zeros_like(exag))
            embeds = torch.cat([embeds, uncond], 0)
            lens = torch.cat([lens, lens])
        return t3, embeds, lens, (batch_bucket, prompt_bucket, decode_bucket, cache_len)

    @torch.no_grad()
    def generate(self, t3, embeds, prompt_lengths, *, cache_len: int, max_new: int,
                 temperature: float, cfg_weight: float, repetition_penalty: float):
        """CFG prefill + decode loop → (tokens [b, max_new] int32, lengths [b])."""
        cfg = self.cfg
        _logits, cache = prefill(t3["lm"], cfg.lm, None, prompt_lengths,
                                 inputs_embeds=embeds, cache_len=cache_len)
        b = embeds.shape[0] // 2 if cfg_weight > 0 else embeds.shape[0]
        first = torch.full((b,), cfg.bos_speech, dtype=torch.int64, device=self.device)
        gen = GenerateConfig(
            max_new_tokens=max_new, eos_token_id=cfg.eos_speech, temperature=temperature,
            repetition_penalty=repetition_penalty, cfg_weight=cfg_weight,
            vocab_size=cfg.lm.vocab_size,
        )

        def step(lm, tok, cache_):
            logits, cache_ = decode_step(lm, cfg.lm, tok, cache_)
            return logits + self._logit_bias[None, :], cache_

        return generate_tokens(t3["lm"], step, cache, first, gen, generator=self._gen)

    @torch.no_grad()
    def stage2_pcm16(self, tokens: torch.Tensor, tok_lengths: torch.Tensor,
                     noise: Stage2Noise, xvec_emb: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Control-id strip + validity mask + stage 2 → int16 PCM on device."""
        cfg = self.cfg
        speech = torch.clamp(tokens, 0, cfg.speech_vocab - 1)
        mask = (torch.arange(tokens.shape[1], device=tokens.device)[None, :]
                < tok_lengths[:, None]).float()
        return to_pcm16_wire(tokens_to_audio(self.params["decoder"], cfg, speech, mask,
                                             noise, xvec_emb=xvec_emb))

    def _decode_batch(self, texts: List[str], *, mode: str, lang: Optional[str],
                      exaggeration: float, cfg_weight: float, temperature: float,
                      repetition_penalty: float) -> List[Tuple[np.ndarray, int, Dict[str, Any]]]:
        cfg = self.cfg
        use_cfg = cfg_weight > 0
        t3, embeds, prompt_lengths, buckets = self._prepare_batch(
            texts, mode=mode, lang=lang, exaggeration=exaggeration, cfg_weight=cfg_weight)
        _batch, prompt_bucket, decode_bucket, cache_len = buckets
        tokens, tok_lengths = self.generate(
            t3, embeds, prompt_lengths, cache_len=cache_len, max_new=decode_bucket,
            temperature=float(temperature), cfg_weight=float(cfg_weight) if use_cfg else 0.0,
            repetition_penalty=float(repetition_penalty),
        )
        noise = draw_stage2_noise(cfg.t2w, tokens.shape[0], tokens.shape[1], self._gen, self.device)
        xv = torch.zeros((tokens.shape[0], XVECTOR_DIM), device=self.device)
        audio = from_pcm16_wire(self.stage2_pcm16(tokens, tok_lengths, noise, xv).cpu().numpy())
        tok_lengths = tok_lengths.cpu().numpy()
        results = []
        for i in range(len(texts)):
            n = int(tok_lengths[i]) * cfg.samples_per_token
            meta = {
                "engine": "chatterbox",
                "mode": mode,
                "speech_tokens": int(tok_lengths[i]),
                "prompt_bucket": prompt_bucket,
                "decode_bucket": decode_bucket,
                "cfg_weight": cfg_weight,
            }
            results.append((audio[i, :n], cfg.sample_rate, meta))
        return results


__all__ = ["ChatterboxRuntime", "SCALES", "PROMPT_BUCKETS", "DECODE_BUCKETS", "BATCH_BUCKETS"]
