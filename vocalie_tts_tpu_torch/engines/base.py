"""What the port's engines share: the device, the assets directory and one
resident runtime built at first use (counterpart of the residency part of
``vocalie_tts_tpu/engines/base.py``, without its registry).

Weights come from ``<assets>/<engine id>/weights`` (the JAX package's
``.npz`` format, ``$VOCALIE_ASSETS_DIR`` or ``.assets`` at the repository
root), or are random from a seed when ``VOCALIE_ALLOW_RANDOM_WEIGHTS=1``
and no checkpoint is there.
"""

from __future__ import annotations

import os
import threading
from pathlib import Path
from typing import Optional

import torch

from vocalie_tts_tpu_torch.device import resolve_device
from vocalie_tts_tpu_torch.utils.env import bool_env


class EngineUnavailableError(RuntimeError):
    """The request cannot run on this engine as given (the JAX engines'
    ``EngineUnavailableError``)."""


def assets_dir(engine_id: str) -> Path:
    env = os.environ.get("VOCALIE_ASSETS_DIR")
    base = Path(env).expanduser() if env else Path(__file__).resolve().parents[2] / ".assets"
    return base / engine_id


class ResidentEngine:
    """An engine keeping one runtime resident; subclasses set ``id`` and
    build the runtime in ``_create_runtime``."""

    id = ""

    def __init__(self, device: str | torch.device = "cuda", assets: Optional[Path] = None) -> None:
        self.device = resolve_device(device)
        self.assets = Path(assets) if assets is not None else assets_dir(self.id)
        self._runtime = None
        self._lock = threading.Lock()

    def is_available(self) -> bool:
        weights = self.assets / "weights"
        installed = weights.is_dir() and any(weights.iterdir())
        return installed or bool_env("VOCALIE_ALLOW_RANDOM_WEIGHTS")

    def unavailable_reason(self) -> Optional[str]:
        if self.is_available():
            return None
        return (f"Poids absents pour '{self.id}' (attendus sous {self.assets / 'weights'}); "
                "installez le backend ou exportez VOCALIE_ALLOW_RANDOM_WEIGHTS=1.")

    def _create_runtime(self):
        raise NotImplementedError

    def runtime(self):
        with self._lock:
            if self._runtime is None:
                if not self.is_available():
                    raise RuntimeError(self.unavailable_reason())
                self._runtime = self._create_runtime()
            return self._runtime

    def warmup(self) -> None:
        self.runtime().warmup()


__all__ = ["ResidentEngine", "EngineUnavailableError", "assets_dir"]
