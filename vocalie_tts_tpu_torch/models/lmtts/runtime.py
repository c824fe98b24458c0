"""Qwen3-TTS-class runtime (counterpart of
``vocalie_tts_tpu/models/lmtts/runtime.py``): three conditioning modes on one
resident LM.

Mode → prompt recipe:
- custom_voice: the named speaker's table row in the speaker slot (an
  instruction, if any, prepended to the text);
- voice_design: the instruction prepended (SEP-joined), a zero speaker slot;
- voice_clone: the reference's x-vector (``normalize_ref_audio`` →
  ``embed_reference_audio``, cached per file) in the speaker slot, the
  transcript prepended unless ``x_vector_only``.

Per batch of chunks: byte prompts in (batch, prompt) buckets with room for
the speaker, language and BOS slots; ONE prefill (B6 at the 512 bucket) and
ONE decode loop for every row (first token the audio BOS, the codec logit
mask); ONE stage-2 call (codec decoder x8 → HiFi-GAN, hop 240) → int16 PCM
→ one host read. In the default int8 serving env every decode step runs B3
+ the layers' B1 and B2 + B5 + B4 (``VOCALIE_MEGATAIL=0``: B3 + B1 + B8a per
layer). Random numbers come from the runtime's ``torch.Generator``.
``VOCALIE_SERVE_MESH`` (multi-chip serving) is refused.
"""

from __future__ import annotations

import os
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from vocalie_tts_tpu_torch.device import resolve_device
from vocalie_tts_tpu_torch.dsp.host import resample
from vocalie_tts_tpu_torch.models.common.ar_runtime import (
    SpeakerEmbedCache,
    apply_runtime_env,
    from_pcm16_wire,
    make_generate_fn,
    maybe_quantize_lm,
    pad_token_batch,
    to_pcm16_wire,
)
from vocalie_tts_tpu_torch.models.common.speaker import embed_reference_audio
from vocalie_tts_tpu_torch.models.common.transformer import unfuse_decode_weights
from vocalie_tts_tpu_torch.models.common.weights import (
    check_saveable,
    checkpoint_exists,
    load_meta,
    load_params,
    save_params,
)
from vocalie_tts_tpu_torch.models.lmtts.model import (
    SPEAKERS,
    TOKENS_PER_SECOND,
    LMTTSConfig,
    build_prompt_embeds,
    codec_logit_bias,
    init_codec_decoder,
    init_lmtts,
    lang_one_hot,
    tokens_to_audio,
)
from vocalie_tts_tpu_torch.ops.kv_cache import pick_bucket, round_cache_len
from vocalie_tts_tpu_torch.text.duration import estimate_duration
from vocalie_tts_tpu_torch.text.frontend import build_prompt_ids, load_frontend

PROMPT_BUCKETS = (64, 128, 256, 512)
DECODE_BUCKETS = (32, 64, 128, 192)
BATCH_BUCKETS = (1, 2, 4, 8)
#: the speaker slot, the language slot and the audio BOS
PROMPT_SLOTS = 3

SCALES: Dict[str, LMTTSConfig] = {
    "full": LMTTSConfig(),
    "small": LMTTSConfig(d_model=512, n_layers=8, n_heads=8, n_kv_heads=4, d_ff=2048),
    "tiny": LMTTSConfig(d_model=64, n_layers=2, n_heads=4, n_kv_heads=2, d_ff=128,
                        max_seq_len=512, dtype=torch.float32),
}


class LMTTSRuntime:
    def __init__(self, params: Dict[str, Any], cfg: LMTTSConfig, weights_dir: Path,
                 device: torch.device, seed: int = 0) -> None:
        self.params = params   # {"lm_bundle": {"lm", "text_emb", ...}, "decoder": {...}}
        self.cfg = cfg
        self.device = device
        self.weights_dir = Path(weights_dir)
        self._frontend = load_frontend(self.weights_dir.parent, style="raw",
                                       text_vocab=cfg.text_vocab)
        self._gen = torch.Generator(device=device).manual_seed(seed)
        self._generate = make_generate_fn(cfg.lm, codec_logit_bias(cfg, device))
        self._spk_cache = SpeakerEmbedCache(cfg.speaker_dim, self._embed)

    # ── lifecycle ───────────────────────────────────────────────────────

    @classmethod
    def create(cls, assets_dir: Path, force_init: bool = False, *,
               device: str | torch.device = "cuda", seed: int = 11) -> "LMTTSRuntime":
        """Build the runtime from ``<assets_dir>/weights/{lm,codec_decoder}.npz``
        (the JAX package's format; ``meta.json`` may give the text and codec
        vocabularies), or from random weights made from ``seed`` where a
        checkpoint is absent or ``force_init``."""
        import dataclasses

        dev = resolve_device(device)
        cfg = apply_runtime_env(SCALES[os.environ.get("VOCALIE_MODEL_SCALE", "full")])
        if os.environ.get("VOCALIE_SERVE_MESH", "").strip():
            raise NotImplementedError(
                "VOCALIE_SERVE_MESH serves the LM over a dp x tp mesh with the decode kernels "
                "off in the JAX package; the port serves one GPU; unset it"
            )
        weights_dir = Path(assets_dir) / "weights"
        if not force_init:
            meta = load_meta(weights_dir, "lm")
            tv = int(meta.get("text_vocab", cfg.text_vocab))
            cv = int(meta.get("codec_vocab", cfg.codec_vocab))
            if (tv, cv) != (cfg.text_vocab, cfg.codec_vocab):
                cfg = dataclasses.replace(cfg, text_vocab=tv, codec_vocab=cv)
        gen = torch.Generator(device=dev).manual_seed(seed)
        bundle = init_lmtts(cfg, generator=gen, device=dev)
        if not force_init and checkpoint_exists(weights_dir, "lm"):
            bundle = load_params(weights_dir, "lm", bundle, dev)
        dec = init_codec_decoder(cfg, generator=gen, device=dev)
        if not force_init and checkpoint_exists(weights_dir, "codec_decoder"):
            dec = load_params(weights_dir, "codec_decoder", dec, dev)
        return cls({"lm_bundle": maybe_quantize_lm(bundle), "decoder": dec}, cfg, weights_dir,
                   dev, seed=seed)

    def save_weights(self) -> None:
        """Write ``lm`` (the LM unfused, with the vocabularies in its meta)
        and ``codec_decoder``; int8 weights are refused, as in JAX."""
        check_saveable(self.params)
        bundle = self.params["lm_bundle"]
        save_params(self.weights_dir, "lm",
                    {**bundle, "lm": unfuse_decode_weights(bundle["lm"], self.cfg.lm)},
                    meta={"family": "lmtts", "text_vocab": self.cfg.text_vocab,
                          "codec_vocab": self.cfg.codec_vocab})
        save_params(self.weights_dir, "codec_decoder", self.params["decoder"],
                    meta={"family": "lmtts", "stage": "codec_decoder"})

    def warmup(self) -> None:
        self.synthesize("Bonjour, préchauffage.", mode="custom_voice", language="French")

    # ── synthesis ───────────────────────────────────────────────────────

    def synthesize(self, text: str, **kwargs) -> Tuple[np.ndarray, int, Dict[str, Any]]:
        return self.synthesize_batch([text], **kwargs)[0]

    def _embed(self, audio: np.ndarray, sr: int) -> np.ndarray:
        """The speaker x-vector of a normalized reference: at most 10 s at
        the model rate."""
        cfg = self.cfg
        if sr != cfg.sample_rate:
            audio = resample(audio, sr, cfg.sample_rate)
        wave = torch.from_numpy(np.ascontiguousarray(audio[: cfg.sample_rate * 10]))
        with torch.no_grad():
            emb = embed_reference_audio(self.params["decoder"]["speaker"], cfg.speaker,
                                        wave.to(self.device)[None])
        return emb[0].cpu().numpy()

    def speaker_embedding(self, mode: str, speaker: Optional[str],
                          voice_ref_path: Optional[str]) -> np.ndarray:
        """The speaker slot's vector: the reference's x-vector (voice_clone),
        the named speaker's table row (custom_voice), else zeros."""
        if mode == "voice_clone" and voice_ref_path:
            return self._spk_cache.get(voice_ref_path)
        if mode == "custom_voice" and speaker in SPEAKERS:
            row = self.params["lm_bundle"]["speaker_table"][SPEAKERS.index(speaker)]
            return row.float().cpu().numpy()
        return np.zeros((self.cfg.speaker_dim,), np.float32)

    def prepare(self, texts: List[str], *, mode: str, instruct: str, ref_text: str,
                x_vector_only: bool):
        """Byte prompts ``[BOS] preamble [SEP] text`` in (batch, prompt)
        buckets → ``(tokens, lengths, prompt_bucket, batch_bucket,
        decode_bucket)``."""
        if mode == "voice_design" and instruct:
            preamble = instruct
        elif mode == "voice_clone" and not x_vector_only and ref_text:
            preamble = ref_text
        elif instruct:  # a custom_voice emotion instruction
            preamble = instruct
        else:
            preamble = ""
        seqs = [build_prompt_ids(self._frontend, t, preamble=preamble) for t in texts]
        tokens, lengths, prompt_bucket, batch_bucket = pad_token_batch(
            seqs, prompt_buckets=PROMPT_BUCKETS, batch_buckets=BATCH_BUCKETS,
            extra_positions=PROMPT_SLOTS)
        est = max(int(estimate_duration(t) * TOKENS_PER_SECOND * 1.8) + 8 for t in texts)
        return tokens, lengths, prompt_bucket, batch_bucket, pick_bucket(est, DECODE_BUCKETS)

    def prompt_embeds(self, tokens: np.ndarray, spk: np.ndarray,
                      language: Optional[str]) -> torch.Tensor:
        """The prompt embeddings of ``tokens`` [b, L], one speaker vector and
        one language for every row."""
        dev, b = self.device, tokens.shape[0]
        spk_b = torch.from_numpy(np.tile(np.asarray(spk, np.float32)[None], (b, 1))).to(dev)
        lang_b = lang_one_hot(language or "Auto", dev)[None].expand(b, 16)
        with torch.no_grad():
            return build_prompt_embeds(self.params["lm_bundle"], self.cfg,
                                       torch.from_numpy(tokens).to(dev), spk_b, lang_b)

    @torch.no_grad()
    def stage2_pcm16(self, tokens: torch.Tensor, tok_lengths: torch.Tensor) -> torch.Tensor:
        """Control-id strip + validity mask + stage 2 → int16 PCM on device."""
        codec = torch.clamp(tokens.long(), 0, self.cfg.codec_vocab - 1)
        mask = (torch.arange(tokens.shape[1], device=tokens.device)[None, :]
                < tok_lengths[:, None]).float()
        return to_pcm16_wire(tokens_to_audio(self.params["decoder"], self.cfg, codec, mask))

    def synthesize_batch(
        self,
        texts: List[str],
        *,
        mode: str = "custom_voice",
        language: Optional[str] = "French",
        speaker: Optional[str] = "Vivian",
        instruct: str = "",
        ref_text: str = "",
        x_vector_only: bool = True,
        voice_ref_path: Optional[str] = None,
        temperature: float = 0.8,
        top_k: int = 50,
        progress_cb=None,
        **_ignored,
    ) -> List[Tuple[np.ndarray, int, Dict[str, Any]]]:
        t0 = time.monotonic()
        cfg = self.cfg
        tokens, lengths, prompt_bucket, _, decode_bucket = self.prepare(
            texts, mode=mode, instruct=instruct, ref_text=ref_text, x_vector_only=x_vector_only)
        spk = self.speaker_embedding(mode, speaker, voice_ref_path)
        embeds = self.prompt_embeds(tokens, spk, language)
        out_tokens, tok_lengths = self._generate(
            self.params["lm_bundle"]["lm"], embeds, torch.from_numpy(lengths).to(self.device),
            cache_len=round_cache_len(prompt_bucket + decode_bucket), max_new=decode_bucket,
            eos_token_id=cfg.eos_audio, temperature=float(temperature), top_k=int(top_k),
            first_token=cfg.bos_audio, generator=self._gen)
        # stage 2 queues behind the decode loop; ONE host read returns the
        # PCM with the token lengths as a last int16 column (<= 192)
        wire = torch.cat([self.stage2_pcm16(out_tokens, tok_lengths),
                          tok_lengths.to(torch.int16)[:, None]], 1).cpu().numpy()
        audio = from_pcm16_wire(wire[:, :-1])
        tok_lengths = wire[:, -1].astype(np.int64)
        elapsed = time.monotonic() - t0
        per_token = cfg.token_upsample * cfg.vocoder.hop
        results = []
        for i in range(len(texts)):
            meta = {"engine": "qwen3", "mode": mode, "codec_tokens": int(tok_lengths[i]),
                    "elapsed_ms": round(elapsed * 1000, 1), "prompt_bucket": prompt_bucket,
                    "decode_bucket": decode_bucket}
            results.append((audio[i, : int(tok_lengths[i]) * per_token], cfg.sample_rate, meta))
            if progress_cb:
                progress_cb((i + 1) / len(texts))
        return results


__all__ = ["LMTTSRuntime", "SCALES", "PROMPT_BUCKETS", "DECODE_BUCKETS", "BATCH_BUCKETS"]
