"""Autoregressive decode loops (counterparts of
``vocalie_tts_tpu/ops/generate.py::generate_tokens`` and
``generate_window``).

Same semantics as the JAX ``while_loop``: a CFG-doubled batch
``[cond; uncond]`` through one cache, EOS freezing of finished rows,
repetition counts, and ``lengths`` counting tokens before EOS. The loop
runs on the host; it reads ``done.all()`` back from the device only
every ``check_every`` steps. Steps taken after every row finished write
nothing (``active`` gates the token write), so the output equals the
JAX loop's, which stops at once.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch

from vocalie_tts_tpu_torch.ops.sampling import (
    apply_repetition_penalty,
    cfg_combine,
    sample_logits,
)


@dataclasses.dataclass(frozen=True)
class GenerateConfig:
    max_new_tokens: int
    eos_token_id: int
    temperature: float = 0.7
    top_k: int = 0
    top_p: float = 1.0
    repetition_penalty: float = 1.0
    cfg_weight: float = 0.0  # 0 → no CFG
    vocab_size: int = 0  # required if repetition_penalty != 1


def generate_tokens(
    params,
    decode_step: Callable,     # (params, token [B] int64, cache) -> (logits [B, V], cache)
    cache,
    first_token: torch.Tensor,  # [batch] — token that starts decode
    gen: GenerateConfig,
    generator: Optional[torch.Generator] = None,
    check_every: int = 16,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (tokens [batch, max_new_tokens] int32, lengths [batch] int32)."""
    use_cfg = bool(gen.cfg_weight and gen.cfg_weight > 0.0)
    batch = int(first_token.shape[0])
    dev = first_token.device
    track_rep = gen.repetition_penalty != 1.0
    if track_rep and not gen.vocab_size:
        raise ValueError("vocab_size required for repetition penalty")
    out = torch.zeros((batch, gen.max_new_tokens), dtype=torch.int64, device=dev)
    counts = torch.zeros((batch, gen.vocab_size if track_rep else 1), dtype=torch.int32, device=dev)
    done = torch.zeros((batch,), dtype=torch.bool, device=dev)
    lengths = torch.zeros((batch,), dtype=torch.int32, device=dev)
    eos = torch.full((batch,), gen.eos_token_id, dtype=torch.int64, device=dev)
    tok = first_token.to(torch.int64)
    for step in range(gen.max_new_tokens):
        if step % check_every == 0 and step > 0 and bool(done.all()):
            break
        active = ~done.all()
        step_tok = torch.cat([tok, tok]) if use_cfg else tok
        logits, cache = decode_step(params, step_tok, cache)
        if use_cfg:
            logits = cfg_combine(logits[:batch], logits[batch:], gen.cfg_weight)
        if track_rep:
            logits = apply_repetition_penalty(logits, counts, gen.repetition_penalty)
        next_tok = sample_logits(logits, temperature=gen.temperature, top_k=gen.top_k,
                                 top_p=gen.top_p, generator=generator)
        is_eos = next_tok == gen.eos_token_id
        # freeze rows that already finished on EOS
        next_tok = torch.where(done, eos, next_tok)
        out[:, step] = torch.where(active, next_tok, out[:, step])
        lengths = torch.where(~done & ~is_eos, lengths + 1, lengths)
        if track_rep:
            counts.scatter_add_(1, next_tok[:, None], (~done).to(torch.int32)[:, None])
        done = done | is_eos
        tok = next_tok
    return out.to(torch.int32), lengths


def generate_window(
    params,
    decode_step: Callable,      # (params, token [B] int64, cache) -> (logits [B, V], cache)
    cache,
    prev_token: torch.Tensor,   # [batch] — last emitted (or BOS) token
    done: torch.Tensor,         # [batch] bool — rows already finished
    gen: GenerateConfig,
    *,
    window: int,
    generator: Optional[torch.Generator] = None,
):
    """Decode exactly ``window`` tokens (masked once a row hits EOS): the
    streaming building block. Every step stays on the device (no host
    read), so a caller can queue the next window before reading this one.
    Returns ``(tokens [batch, window] int32, n_valid [batch] int32,
    next_prev_token, done, cache)``."""
    use_cfg = bool(gen.cfg_weight and gen.cfg_weight > 0.0)
    batch = int(prev_token.shape[0])
    eos = torch.full((batch,), gen.eos_token_id, dtype=torch.int64, device=prev_token.device)
    tok = prev_token.to(torch.int64)
    toks, valid = [], []
    for _ in range(window):
        step_tok = torch.cat([tok, tok]) if use_cfg else tok
        logits, cache = decode_step(params, step_tok, cache)
        if use_cfg:
            logits = cfg_combine(logits[:batch], logits[batch:], gen.cfg_weight)
        nxt = sample_logits(logits, temperature=gen.temperature, top_k=gen.top_k,
                            top_p=gen.top_p, generator=generator)
        is_eos = nxt == gen.eos_token_id
        nxt = torch.where(done, eos, nxt)
        valid.append(~done & ~is_eos)
        done = done | is_eos
        toks.append(nxt)
        tok = nxt
    tokens = torch.stack(toks, 1).to(torch.int32)
    n_valid = torch.stack(valid, 1).sum(1, dtype=torch.int32)
    return tokens, n_valid, tok, done, cache


__all__ = ["GenerateConfig", "generate_tokens", "generate_window"]
