"""Piper-class engine of the port (counterpart of the synthesis part of
``vocalie_tts_tpu/engines/piper.py``): the small fr_FR VITS, fully
non-autoregressive, one bucketed batch a script, mapped onto
:class:`VITSRuntime` with the JAX engine's voices and parameter defaults.

Weights come from ``<assets>/piper/weights`` (the JAX package's ``.npz``
format), or are random from a seed when ``VOCALIE_ALLOW_RANDOM_WEIGHTS=1``
and no checkpoint is there (``ResidentEngine.is_available``).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

from vocalie_tts_tpu_torch.engines.base import ResidentEngine

#: the voices (copy of the JAX engine's ``PIPER_VOICES``); the voice picks
#: the speaker embedding (``VITSRuntime``'s ``VOICE_TO_SPEAKER``), the
#: first is the default
PIPER_VOICES = [
    {"id": "fr_FR-siwis-medium", "label": "Siwis (F, fr_FR, medium)", "lang_codes": ["fr-FR"]},
    {"id": "fr_FR-upmc-medium", "label": "UPMC (M/F, fr_FR, medium)", "lang_codes": ["fr-FR"]},
    {"id": "fr_FR-tom-medium", "label": "Tom (M, fr_FR, medium)", "lang_codes": ["fr-FR"]},
]


class PiperEngine(ResidentEngine):
    id = "piper"
    supports_ref_audio = False
    uses_internal_voices = True
    supports_inter_chunk_gap = True
    native_sr = 22050

    def _create_runtime(self):
        from vocalie_tts_tpu_torch.models.vits.runtime import VITSRuntime

        return VITSRuntime.create(self.assets, device=self.device)

    def supported_languages(self) -> List[str]:
        return ["fr-FR"]

    def default_language(self) -> str:
        return "fr-FR"

    @staticmethod
    def _kwargs(params: Dict[str, Any]) -> Dict[str, Any]:
        """The runtime's arguments from the request's engine params, with
        the JAX engine's defaults; the voice from ``voice`` or
        ``voice_id``."""
        voice = params.get("voice") or params.get("voice_id") or PIPER_VOICES[0]["id"]
        return {"voice": str(voice),
                "length_scale": float(params.get("length_scale", 1.0)),
                "noise_scale": float(params.get("noise_scale", 0.667)),
                "noise_w": float(params.get("noise_w", 0.8))}

    def synthesize_chunk(self, text: str, *, voice_ref_path: Optional[str] = None,
                         lang: Optional[str] = None, **params: Any):
        kw = self._kwargs(params)
        audio, sr, meta = self.runtime().synthesize(text, **kw)
        meta.update({"backend_id": self.id, "backend_lang": lang, "voice": kw["voice"]})
        return audio, sr, meta

    def synthesize_batch(self, texts, *, voice_ref_path: Optional[str] = None,
                         lang: Optional[str] = None, progress_cb=None,
                         **params: Any) -> List[tuple]:
        """One bucketed batch for the whole chunk list."""
        kw = self._kwargs(params)
        results = self.runtime().synthesize_batch(list(texts), progress_cb=progress_cb, **kw)
        extra = {"backend_id": self.id, "backend_lang": lang, "voice": kw["voice"]}
        return [(audio, sr, {**meta, **extra}) for audio, sr, meta in results]


__all__ = ["PiperEngine", "PIPER_VOICES"]
