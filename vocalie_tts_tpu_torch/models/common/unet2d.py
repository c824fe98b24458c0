"""Dense layer helpers (the ``dense`` / ``dense_init`` part of
``vocalie_tts_tpu/models/common/unet2d.py``; the UNet itself belongs to
a later slice)."""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch

Params = Dict[str, Any]


def dense_init(d_in: int, d_out: int, *, generator: Optional[torch.Generator] = None,
               device="cpu", zero: bool = False, dtype=torch.float32) -> Params:
    if zero:
        w = torch.zeros((d_in, d_out), dtype=dtype, device=device)
    else:
        scale = 1.0 / math.sqrt(d_in)
        w = (torch.rand((d_in, d_out), generator=generator, device=device) * 2 - 1) * scale
        w = w.to(dtype)
    return {"w": w, "b": torch.zeros((d_out,), dtype=dtype, device=device)}


def dense(params: Params, x: torch.Tensor) -> torch.Tensor:
    return torch.matmul(x, params["w"].to(x.dtype)) + params["b"].to(x.dtype)


__all__ = ["dense", "dense_init"]
