"""Token sampling: temperature, top-k, top-p, repetition penalty and
classifier-free guidance (counterpart of ``vocalie_tts_tpu/ops/sampling.py``).

Greedy decoding at temperature <= 0 is an argmax and matches the JAX
package token for token; sampled tokens come from an explicit
``torch.Generator`` and cannot match JAX's PRNG.
"""

from __future__ import annotations

from typing import Optional

import torch

_NEG = -1e30


def apply_repetition_penalty(logits: torch.Tensor, token_counts: torch.Tensor,
                             penalty: float) -> torch.Tensor:
    """HF-style repetition penalty on already-emitted tokens."""
    seen = token_counts > 0
    penalized = torch.where(logits > 0, logits / penalty, logits * penalty)
    return torch.where(seen, penalized, logits)


def cfg_combine(cond_logits: torch.Tensor, uncond_logits: torch.Tensor, weight: float) -> torch.Tensor:
    """Classifier-free guidance: uncond + w * (cond - uncond)."""
    return uncond_logits + weight * (cond_logits - uncond_logits)


def _top_k_mask(logits: torch.Tensor, k: int) -> torch.Tensor:
    if k <= 0:
        return logits
    kth = torch.topk(logits, k, dim=-1).values[..., -1:]
    return torch.where(logits < kth, torch.full_like(logits, _NEG), logits)


def _top_p_mask(logits: torch.Tensor, p: float) -> torch.Tensor:
    if p >= 1.0:
        return logits
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
    # keep tokens until the cumulative probability exceeds p (always the top-1)
    keep = torch.cat([torch.ones_like(cum[..., :1], dtype=torch.bool), cum[..., :-1] < p], dim=-1)
    threshold = torch.where(keep, sorted_logits, torch.full_like(sorted_logits, float("inf")))
    threshold = threshold.amin(-1, keepdim=True)
    return torch.where(logits < threshold, torch.full_like(logits, _NEG), logits)


def sample_logits(logits: torch.Tensor, *, temperature: float = 1.0, top_k: int = 0,
                  top_p: float = 1.0, generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """One token id per row (int64). temperature <= 0 → argmax."""
    filtered = _top_p_mask(_top_k_mask(logits.float(), top_k), top_p)
    if temperature <= 0:
        return torch.argmax(filtered, dim=-1)
    probs = torch.softmax(filtered / max(float(temperature), 1e-6), dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


__all__ = ["apply_repetition_penalty", "cfg_combine", "sample_logits"]
