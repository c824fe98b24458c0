"""Shared pieces of the AR runtimes (counterpart of the parts of
``vocalie_tts_tpu/models/common/ar_runtime.py`` the Chatterbox-, CosyVoice-
and XTTS-class paths use): the decode-path env knobs, the runtime weight
transforms, prompt padding and the two-table prompt embedding, the generate
(prefill + decode loop) and streaming functions, the speaker-embedding
cache and the int16 PCM wire format."""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from vocalie_tts_tpu_torch.ops.kv_cache import pick_bucket
from vocalie_tts_tpu_torch.utils.env import bool_env, tri_env


def apply_runtime_env(cfg):
    """Apply the decode-path env knobs to a family config dataclass, as
    ``vocalie_tts_tpu/models/common/ar_runtime.py:29-54`` does:

    - ``VOCALIE_KV_INT8=1``: int8 KV cache;
    - ``VOCALIE_DECODE_KERNEL``: decode-attention kernel, on by default
      with the int8 cache (``=0`` opts out);
    - ``VOCALIE_DENSE_KERNEL``: the int8-native dense decode kernels, on
      by default with ``VOCALIE_WEIGHT_INT8=1`` (``=0`` opts out, ``=1``
      forces the flag, inert without int8 weights).
    """
    kv_int8 = bool_env("VOCALIE_KV_INT8")
    if kv_int8:
        cfg = dataclasses.replace(cfg, kv_quant=True)
    kernel_env = tri_env("VOCALIE_DECODE_KERNEL")
    if kernel_env is True or (kv_int8 and kernel_env is not False):
        cfg = dataclasses.replace(cfg, decode_kernel=True)
    dense_env = tri_env("VOCALIE_DENSE_KERNEL")
    if dense_env is True or (bool_env("VOCALIE_WEIGHT_INT8") and dense_env is not False):
        cfg = dataclasses.replace(cfg, dense_kernel=True)
    return cfg


def maybe_quantize_lm(bundle: Dict, key: str = "lm") -> Dict:
    """Runtime weight transforms of the transformer inside a bundle:
    ``VOCALIE_WEIGHT_INT8=1`` (int8 weights, per-channel scales), then
    fused q/k/v and gate/up, the only layout the port's forward takes.
    ``VOCALIE_FUSE_QKV=0`` (the JAX package's unfused layout, which with
    int8 weights also turns its dense decode kernels off) raises."""
    from vocalie_tts_tpu_torch.models.common.transformer import (
        fuse_decode_weights,
        quantize_weights_int8,
    )

    if not bool_env("VOCALIE_FUSE_QKV", True):
        raise NotImplementedError(
            "VOCALIE_FUSE_QKV=0 keeps q/k/v and gate/up unfused in the JAX package, where the "
            "decode step then takes _qdot on unquantized activations; the port serves the "
            "fused layout only; unset it"
        )
    if key not in bundle:
        return bundle
    lm = bundle[key]
    if bool_env("VOCALIE_WEIGHT_INT8"):
        lm = quantize_weights_int8(lm)
    return {**bundle, key: fuse_decode_weights(lm)}


def pad_token_batch(
    seqs: List[List[int]],
    *,
    prompt_buckets: Tuple[int, ...],
    batch_buckets: Tuple[int, ...],
    extra_positions: int = 0,
    pad_id: int = 0,
) -> Tuple[np.ndarray, np.ndarray, int, int]:
    """Pad ragged token lists into a (batch_bucket, prompt_bucket) grid;
    ``extra_positions`` reserves room for slots the caller adds. Returns
    (tokens, lengths, prompt_bucket, batch_bucket), lengths including the
    extra positions."""
    max_len = max((len(s) for s in seqs), default=0) + extra_positions
    prompt_bucket = pick_bucket(max_len, prompt_buckets)
    batch_bucket = pick_bucket(len(seqs), batch_buckets)
    room = prompt_bucket - extra_positions
    tokens = np.full((batch_bucket, room), pad_id, np.int32)
    lengths = np.full((batch_bucket,), extra_positions, np.int32)
    for i, s in enumerate(seqs):
        s = s[:room]
        tokens[i, : len(s)] = s
        lengths[i] = len(s) + extra_positions
    return tokens, lengths, prompt_bucket, batch_bucket


def embed_mixed_prompt(text_emb: torch.Tensor, tok_emb: torch.Tensor, tokens: torch.Tensor,
                       text_vocab: int) -> torch.Tensor:
    """Prompt-space embedding over two tables: ids below ``text_vocab``
    index ``text_emb``, the rest index the LM-core ``tok_emb`` at
    ``id - text_vocab`` (speech tokens spliced into a prompt, BOS)."""
    tokens = tokens.long()
    is_text = tokens < text_vocab
    text_rows = text_emb[torch.clamp(tokens, max=text_vocab - 1)]
    core_rows = tok_emb[torch.clamp(tokens - text_vocab, 0, tok_emb.shape[0] - 1)]
    return torch.where(is_text[..., None], text_rows, core_rows.to(text_rows.dtype))


def biased_step(lm_cfg, logit_bias: Optional[torch.Tensor] = None):
    """``step(lm, tok, cache)`` → ``(logits + logit_bias, cache)``: one
    decode step as the decode loops take it, with the vocabulary mask."""
    from vocalie_tts_tpu_torch.models.common.transformer import decode_step

    def step(lm, tok, cache):
        logits, cache = decode_step(lm, lm_cfg, tok, cache)
        if logit_bias is not None:
            logits = logits + logit_bias[None, :]
        return logits, cache

    return step


def make_generate_fn(lm_cfg, logit_bias: Optional[torch.Tensor] = None):
    """The prefill + decode-loop program of an AR LM (JAX
    ``make_generate_fn``, ``ar_runtime.py:103-153``, without CFG):
    ``fn(lm, embeds, prompt_lengths, *, cache_len, max_new, eos_token_id,
    temperature, top_k=0, top_p=1.0, repetition_penalty=1.0, first_token=0,
    generator=None)`` → ``(tokens [b, max_new] int32, lengths [b] int32)``."""
    from vocalie_tts_tpu_torch.models.common.transformer import prefill
    from vocalie_tts_tpu_torch.ops.generate import GenerateConfig, generate_tokens

    step = biased_step(lm_cfg, logit_bias)

    @torch.no_grad()
    def generate(lm, embeds, prompt_lengths, *, cache_len: int, max_new: int, eos_token_id: int,
                 temperature: float, top_k: int = 0, top_p: float = 1.0,
                 repetition_penalty: float = 1.0, first_token: int = 0, generator=None):
        _logits, cache = prefill(lm, lm_cfg, None, prompt_lengths, inputs_embeds=embeds,
                                 cache_len=cache_len)
        first = torch.full((embeds.shape[0],), first_token, dtype=torch.int64,
                           device=embeds.device)
        gen = GenerateConfig(max_new_tokens=max_new, eos_token_id=eos_token_id,
                             temperature=temperature, top_k=top_k, top_p=top_p,
                             repetition_penalty=repetition_penalty,
                             vocab_size=lm_cfg.vocab_size)
        return generate_tokens(lm, step, cache, first, gen, generator=generator)

    return generate


def make_streaming_fns(lm_cfg, logit_bias: Optional[torch.Tensor] = None):
    """(prefill_fn, window_fn) for incremental window decode:

    - ``prefill_fn(lm, embeds, prompt_lengths, *, cache_len)`` → cache;
    - ``window_fn(lm, cache, prev_token, done, *, window, eos_token_id,
      temperature, top_k=0, top_p=1.0, generator=None)`` →
      ``(tokens, n_valid, next_token, done, cache)``, with no host read.
    """
    from vocalie_tts_tpu_torch.models.common.transformer import prefill
    from vocalie_tts_tpu_torch.ops.generate import GenerateConfig, generate_window

    step = biased_step(lm_cfg, logit_bias)

    @torch.no_grad()
    def prefill_fn(lm, embeds, prompt_lengths, *, cache_len: int):
        _logits, cache = prefill(lm, lm_cfg, None, prompt_lengths, inputs_embeds=embeds,
                                 cache_len=cache_len)
        return cache

    @torch.no_grad()
    def window_fn(lm, cache, prev_token, done, *, window: int, eos_token_id: int,
                  temperature: float, top_k: int = 0, top_p: float = 1.0, generator=None):
        gen = GenerateConfig(max_new_tokens=window, eos_token_id=eos_token_id,
                             temperature=temperature, top_k=top_k, top_p=top_p,
                             vocab_size=lm_cfg.vocab_size)
        return generate_window(lm, step, cache, prev_token, done, gen, window=window,
                               generator=generator)

    return prefill_fn, window_fn


class SpeakerEmbedCache:
    """Speaker embeddings per reference voice, keyed by (path, mtime). No
    reference gives zeros, as in the JAX cache. A reference is loaded with
    ``normalize_ref_audio`` (mono, 24 kHz, -20 dBFS) and embedded by
    ``embed_fn(audio, sr)``; a runtime that passes no ``embed_fn`` lacks
    what its references need (CosyVoice: the S3 speech tokenizer), and a
    reference raises."""

    def __init__(self, dim: int,
                 embed_fn: Optional[Callable[[np.ndarray, int], np.ndarray]] = None):
        self._dim = dim
        self._embed_fn = embed_fn
        self._cache: Dict[str, np.ndarray] = {}

    def get(self, voice_ref_path: Optional[str]) -> np.ndarray:
        if not voice_ref_path:
            return np.zeros((self._dim,), np.float32)
        if self._embed_fn is None:
            raise NotImplementedError(
                "voice references (voice cloning, cross-lingual) here need the speaker encoders "
                "and the S3 speech tokenizer, which the port does not have yet"
            )
        key = f"{voice_ref_path}:{os.path.getmtime(voice_ref_path)}"
        if key not in self._cache:
            from vocalie_tts_tpu_torch.io.refs import normalize_ref_audio

            audio, sr = normalize_ref_audio(voice_ref_path)
            self._cache[key] = np.asarray(self._embed_fn(audio, sr))
        return self._cache[key]


def to_pcm16_wire(audio: torch.Tensor) -> torch.Tensor:
    """Device-side int16 PCM: the output file's precision, half the bytes
    of f32 on the way to the host."""
    return torch.round(torch.clamp(audio, -1.0, 1.0) * 32767.0).to(torch.int16)


def from_pcm16_wire(arr) -> np.ndarray:
    """Host-side inverse of to_pcm16_wire → float32 in [-1, 1]."""
    a = np.asarray(arr)
    if a.dtype == np.int16:
        return a.astype(np.float32) / 32767.0
    return a.astype(np.float32)


__all__ = ["apply_runtime_env", "maybe_quantize_lm", "pad_token_batch", "embed_mixed_prompt",
           "biased_step", "make_generate_fn", "make_streaming_fns", "SpeakerEmbedCache", "to_pcm16_wire", "from_pcm16_wire"]
