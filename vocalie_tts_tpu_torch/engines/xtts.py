"""XTTS-class engine of the port (counterpart of the synthesis part of
``vocalie_tts_tpu/engines/xtts.py``): voice cloning from a reference of at
least 3 s, mapped onto :class:`XTTSRuntime`, with the JAX engine's
languages, parameter defaults and refusals.

Weights come from ``<assets>/xtts/weights`` (the JAX package's ``.npz``
format), or are random from a seed when ``VOCALIE_ALLOW_RANDOM_WEIGHTS=1``
and no checkpoint is there.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np

from vocalie_tts_tpu_torch.engines.base import EngineUnavailableError, ResidentEngine

XTTS_LANGUAGES = [
    "fr-FR", "en-US", "en-GB", "es-ES", "de-DE", "it-IT",
    "pt-PT", "pl-PL", "tr-TR", "ru-RU", "nl-NL", "cs-CZ",
    "ar-XA", "zh-CN", "ja-JP", "ko-KR", "hu-HU", "hi-IN",
]


def validate_ref_audio(path: str, *, min_duration_s: float = 1.0) -> Dict[str, Any]:
    """Reference-audio gate: duration and RMS floor (copy of the JAX
    package's ``engines/qwen3.py`` ``validate_ref_audio``)."""
    from vocalie_tts_tpu_torch.io.wavio import read_wav

    audio, sr = read_wav(path)
    mono = audio.mean(axis=1) if audio.ndim > 1 else audio
    duration_s = float(len(mono) / sr)
    if duration_s < min_duration_s:
        raise EngineUnavailableError(
            f"Audio de reference trop court ({duration_s:.1f}s < {min_duration_s:.1f}s)."
        )
    rms = float(np.sqrt(np.mean(mono.astype(np.float64) ** 2)))
    if rms < 0.001:
        raise EngineUnavailableError(f"Audio de reference trop silencieux (RMS={rms:.4f}).")
    return {"duration_s": duration_s, "rms": rms, "sample_rate": sr}


class XTTSEngine(ResidentEngine):
    id = "xtts"
    supports_ref_audio = True
    supports_inter_chunk_gap = True
    native_sr = 24000

    def _create_runtime(self):
        from vocalie_tts_tpu_torch.models.xtts.runtime import XTTSRuntime

        return XTTSRuntime.create(self.assets, device=self.device)

    def supported_languages(self) -> List[str]:
        return list(XTTS_LANGUAGES)

    def default_language(self) -> str:
        return "fr-FR"

    def map_language(self, bcp47: Optional[str]) -> str:
        if not bcp47:
            return "fr"
        return bcp47.split("-")[0]

    def synthesize_batch(self, texts, *, voice_ref_path: Optional[str] = None,
                         lang: Optional[str] = None, progress_cb=None,
                         **params: Any) -> List[tuple]:
        """Bucketed batched decode of a whole script's chunks, cloning the
        voice of ``voice_ref_path`` (required, at least 3 s)."""
        if not voice_ref_path:
            raise EngineUnavailableError("XTTS requiert un audio de référence.")
        validate_ref_audio(voice_ref_path, min_duration_s=3.0)
        results = self.runtime().synthesize_batch(
            list(texts),
            language=self.map_language(lang),
            voice_ref_path=voice_ref_path,
            temperature=float(params.get("temperature", 0.65)),
            repetition_penalty=float(params.get("repetition_penalty", 2.0)),
            top_k=int(params.get("top_k", 50)),
            top_p=float(params.get("top_p", 0.85)),
            speed=float(params.get("speed", 1.0)),
            progress_cb=progress_cb,
        )
        return [(audio, sr, {**meta, "backend_id": self.id, "backend_lang": lang})
                for audio, sr, meta in results]


__all__ = ["XTTSEngine", "XTTS_LANGUAGES", "validate_ref_audio"]
