"""XTTS-class runtime, the dev path (counterpart of
``vocalie_tts_tpu/models/xtts/runtime.py`` without its published-checkpoint
graph).

Per batch of chunks:
  1. the reference voice → ``normalize_ref_audio`` → the speaker x-vector
     (``embed_reference_audio``, cached per file);
  2. byte prompts ``[lang]text`` padded into (batch, prompt) buckets, with
     room for the 32 conditioning latents and the mel BOS;
  3. ONE prefill over the prompt embeds and ONE decode loop for every row
     (first token the mel BOS, the VQ logit mask, the repetition penalty);
  4. ONE stage-2 call (VQ embedding, upsampling, speaker modulation, mel
     conv, HiFi-GAN) → int16 PCM → one host read.
In the default int8 serving env every decode step runs B9a + the layers'
B1 and B9b + B5 + B4 (``VOCALIE_MEGATAIL=0``: B9a + B1 + B9c per layer).

A weights directory that holds the published bundle (``xtts_cond``,
``xtts_hifi``, ``xtts_spk`` at the LM's width) or a ``tokenizer.json`` is
refused: the JAX runtime would take its published path there, which the
port does not have. Random numbers come from the runtime's
``torch.Generator``; greedy decoding (temperature <= 0) needs none.
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
    checkpoint_exists,
    load_meta,
    load_params,
    save_params,
)
from vocalie_tts_tpu_torch.models.xtts.model import (
    BOS_VQ,
    EOS_VQ,
    N_COND_LATENTS,
    TOKENS_PER_SECOND,
    VQ_BASE,
    VQ_VOCAB,
    XTTSConfig,
    build_prompt_embeds,
    init_vq_decoder,
    init_xtts,
    tokens_to_audio,
    vq_logit_bias,
)
from vocalie_tts_tpu_torch.ops.kv_cache import pick_bucket, round_cache_len
from vocalie_tts_tpu_torch.text.duration import estimate_duration
from vocalie_tts_tpu_torch.text.frontend import text_to_byte_ids

PROMPT_BUCKETS = (96, 160, 288, 544)   # room for the 32 cond latents
DECODE_BUCKETS = (64, 128, 256, 320)
BATCH_BUCKETS = (1, 2, 4, 8)

SCALES: Dict[str, XTTSConfig] = {
    "full": XTTSConfig(),
    "small": XTTSConfig(d_model=512, n_layers=8, n_heads=8, n_kv_heads=8, d_ff=2048),
    "tiny": XTTSConfig(d_model=64, n_layers=2, n_heads=4, n_kv_heads=4, d_ff=128,
                       max_seq_len=512, speaker_dim=64, dtype=torch.float32),
}

#: the published bundle's checkpoints (``convert-hf xtts``)
PUBLISHED_NAMES = ("xtts_cond", "xtts_hifi", "xtts_spk")


def _refuse_published(assets_dir: Path, weights_dir: Path, cfg: XTTSConfig) -> None:
    """Raise where the JAX runtime would take its published path: the three
    published checkpoints whose conditioning width is the LM's (at another
    width it warns and keeps the dev path), or a ``tokenizer.json``."""
    if all(checkpoint_exists(weights_dir, n) for n in PUBLISHED_NAMES):
        dim = load_meta(weights_dir, "xtts_cond").get("config", {}).get("perceiver", {}).get("dim")
        if dim == cfg.d_model:
            raise NotImplementedError(
                f"{weights_dir} holds the published XTTS-v2 bundle ({', '.join(PUBLISHED_NAMES)}); "
                "its conditioning encoder, latent HiFi-GAN and speaker ResNet are not ported yet"
            )
    for cand in (Path(assets_dir) / "tokenizer.json", weights_dir / "tokenizer.json"):
        if cand.exists():
            raise NotImplementedError(
                f"{cand}: the published text BPE is not ported yet; the port encodes XTTS "
                "prompts with the byte frontend only"
            )


class XTTSRuntime:
    def __init__(self, params: Dict[str, Any], cfg: XTTSConfig, weights_dir: Path,
                 device: torch.device, seed: int = 0) -> None:
        self.params = params   # {"gpt": {"lm", "text_emb", ...}, "decoder": {...}}
        self.cfg = cfg
        self.device = device
        self.weights_dir = Path(weights_dir)
        self._gen = torch.Generator(device=device).manual_seed(seed)
        self._generate = make_generate_fn(cfg.lm, vq_logit_bias(device))
        self._spk_cache = SpeakerEmbedCache(cfg.speaker_dim, self._embed)

    # ── lifecycle ───────────────────────────────────────────────────────

    @classmethod
    def create(cls, assets_dir: Path, force_init: bool = False, *,
               device: str | torch.device = "cuda", seed: int = 23) -> "XTTSRuntime":
        """Build the runtime from ``<assets_dir>/weights/{gpt,vq_decoder}.npz``
        (the JAX package's format), or from random weights made from
        ``seed`` where a checkpoint is absent or ``force_init``."""
        dev = resolve_device(device)
        cfg = apply_runtime_env(SCALES[os.environ.get("VOCALIE_MODEL_SCALE", "full")])
        weights_dir = Path(assets_dir) / "weights"
        if not force_init:
            _refuse_published(Path(assets_dir), weights_dir, cfg)
        gen = torch.Generator(device=dev).manual_seed(seed)
        gpt = init_xtts(cfg, generator=gen, device=dev)
        if not force_init and checkpoint_exists(weights_dir, "gpt"):
            gpt = load_params(weights_dir, "gpt", gpt, dev)
        dec = init_vq_decoder(cfg, generator=gen, device=dev)
        if not force_init and checkpoint_exists(weights_dir, "vq_decoder"):
            dec = load_params(weights_dir, "vq_decoder", dec, dev)
        return cls({"gpt": maybe_quantize_lm(gpt), "decoder": dec}, cfg, weights_dir, dev,
                   seed=seed)

    def save_weights(self) -> None:
        """Write ``gpt`` (the LM unfused) and ``vq_decoder``; int8 weights
        are refused, as the JAX runtime refuses them."""
        gpt = self.params["gpt"]
        save_params(self.weights_dir, "gpt",
                    {**gpt, "lm": unfuse_decode_weights(gpt["lm"], self.cfg.lm)},
                    meta={"family": "xtts"})
        save_params(self.weights_dir, "vq_decoder", self.params["decoder"],
                    meta={"family": "xtts", "stage": "vq_decoder"})

    def warmup(self) -> None:
        # no reference needed: a zero speaker embedding
        self._decode(["Préchauffage du moteur."], np.zeros((self.cfg.speaker_dim,), np.float32),
                     language="fr", temperature=0.65, repetition_penalty=2.0, top_k=50,
                     top_p=0.85)

    # ── synthesis ───────────────────────────────────────────────────────

    def synthesize(self, text: str, **kwargs) -> Tuple[np.ndarray, int, Dict[str, Any]]:
        return self.synthesize_batch([text], **kwargs)[0]

    def synthesize_batch(
        self,
        texts: List[str],
        *,
        language: Optional[str] = "fr",
        voice_ref_path: Optional[str] = None,
        temperature: float = 0.65,
        repetition_penalty: float = 2.0,
        top_k: int = 50,
        top_p: float = 0.85,
        speed: float = 1.0,
        progress_cb=None,
        **_ignored,
    ) -> List[Tuple[np.ndarray, int, Dict[str, Any]]]:
        t0 = time.monotonic()
        spk = self._spk_cache.get(voice_ref_path)
        results = self._decode(texts, spk, language=language, temperature=temperature,
                               repetition_penalty=repetition_penalty, top_k=top_k, top_p=top_p)
        elapsed = time.monotonic() - t0
        out = []
        for i, (audio, sr, meta) in enumerate(results):
            if speed and speed != 1.0:
                # time-stretch by resampling (pitch-affecting, as the JAX runtime)
                audio = resample(audio, int(sr * speed), sr)
            out.append((audio, sr, {**meta, "elapsed_ms_batch": round(elapsed * 1000, 1)}))
            if progress_cb:
                progress_cb((i + 1) / len(results))
        return out

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

    def _prepare_prompt(self, texts: List[str], language: Optional[str]):
        """Byte ids ``[BOS][lang]text`` in (batch, prompt) buckets →
        ``(tokens, lengths, prompt_bucket, batch_bucket, decode_bucket)``."""
        tag = f"[{language or 'fr'}]"
        seqs = [text_to_byte_ids(f"{tag}{t}", add_bos=True, add_eos=False) for t in texts]
        tokens, lengths, prompt_bucket, batch_bucket = pad_token_batch(
            seqs, prompt_buckets=PROMPT_BUCKETS, batch_buckets=BATCH_BUCKETS,
            extra_positions=N_COND_LATENTS + 1)
        est = max(int(estimate_duration(t) * TOKENS_PER_SECOND * 1.8) + 16 for t in texts)
        return tokens, lengths, prompt_bucket, batch_bucket, pick_bucket(est, DECODE_BUCKETS)

    @torch.no_grad()
    def stage2_pcm16(self, tokens: torch.Tensor, tok_lengths: torch.Tensor,
                     spk_emb: torch.Tensor) -> torch.Tensor:
        """Control-id strip + validity mask + stage 2 → int16 PCM on device."""
        vq = torch.clamp(tokens.long() - VQ_BASE, 0, VQ_VOCAB - 1)
        mask = (torch.arange(tokens.shape[1], device=tokens.device)[None, :]
                < tok_lengths[:, None]).float()
        return to_pcm16_wire(tokens_to_audio(self.params["decoder"], self.cfg, vq, mask, spk_emb))

    def _decode(self, texts, spk, *, language, temperature, repetition_penalty, top_k, top_p):
        cfg, dev = self.cfg, self.device
        tokens, lengths, prompt_bucket, batch_bucket, decode_bucket = self._prepare_prompt(
            texts, language)
        spk_b = torch.from_numpy(np.tile(np.asarray(spk, np.float32)[None], (batch_bucket, 1)))
        spk_b = spk_b.to(dev)
        with torch.no_grad():
            embeds = build_prompt_embeds(self.params["gpt"], cfg, torch.from_numpy(tokens).to(dev),
                                         spk_b)
        out_tokens, tok_lengths = self._generate(
            self.params["gpt"]["lm"], embeds, torch.from_numpy(lengths).to(dev),
            cache_len=round_cache_len(prompt_bucket + decode_bucket), max_new=decode_bucket,
            eos_token_id=EOS_VQ, temperature=float(temperature), top_k=int(top_k),
            top_p=float(top_p), repetition_penalty=float(repetition_penalty),
            first_token=BOS_VQ, generator=self._gen)
        # stage 2 queues behind the decode loop; one host read returns both
        wire = self.stage2_pcm16(out_tokens, tok_lengths, spk_b)
        audio = from_pcm16_wire(wire.cpu().numpy())
        tok_lengths = tok_lengths.cpu().numpy()
        per_token = cfg.token_upsample * cfg.vocoder.hop
        results = []
        for i in range(len(texts)):
            meta = {"engine": "xtts", "vq_tokens": int(tok_lengths[i]),
                    "prompt_bucket": prompt_bucket, "decode_bucket": decode_bucket}
            results.append((audio[i, : int(tok_lengths[i]) * per_token], cfg.sample_rate, meta))
        return results


__all__ = ["XTTSRuntime", "SCALES", "PROMPT_BUCKETS", "DECODE_BUCKETS", "BATCH_BUCKETS",
           "PUBLISHED_NAMES"]
