"""Device resolution for the port's entry points.

The default is the GPU. A caller that wants the CPU (the tests) says so
with ``device="cpu"``; a missing GPU is an error, never a silent CPU run.
"""

from __future__ import annotations

import numpy as np
import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port's plain PyTorch path on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev


def div_const(a: torch.Tensor, n: float) -> torch.Tensor:
    """``a / n`` for a constant ``n`` as the JAX package's jitted code
    computes it: XLA rewrites an f32 division by a constant into a multiply
    by the f32 reciprocal, and divides bf16 (computed in f32) exactly. The
    reciprocal is rounded to f32 on the host, so the multiply is the same
    on every device; the bf16 case divides by a 0-dim tensor on ``a``'s
    device, since PyTorch's CUDA divide by a Python number would multiply
    by a reciprocal there too."""
    if a.dtype == torch.float32:
        return a * float(np.float32(1.0) / np.float32(n))
    return a / torch.full((), float(n), dtype=a.dtype, device=a.device)


__all__ = ["resolve_device", "div_const"]
