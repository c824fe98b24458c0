"""Device resolution for the port's entry points.

The default is the GPU. A caller that wants the CPU (the tests) says so
with ``device="cpu"``; a missing GPU is an error, never a silent CPU run.
"""

from __future__ import annotations

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


__all__ = ["resolve_device"]
