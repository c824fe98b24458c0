"""Qwen3-TTS-class engine of the port (counterpart of the synthesis part of
``vocalie_tts_tpu/engines/qwen3.py``): the custom_voice, voice_design and
voice_clone modes mapped onto :class:`LMTTSRuntime`, with the JAX engine's
languages, mode resolution and reference-audio gate.

Weights come from ``<assets>/qwen3/weights`` (the JAX package's ``.npz``
format), or are random from a seed when ``VOCALIE_ALLOW_RANDOM_WEIGHTS=1``
and no checkpoint is there.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

from vocalie_tts_tpu_torch.engines.base import EngineUnavailableError, ResidentEngine
from vocalie_tts_tpu_torch.engines.xtts import validate_ref_audio

#: BCP-47 → the model's language names (copy of the JAX package's
#: ``engines/catalog.py`` ``QWEN3_LANGUAGE_MAP``)
QWEN3_LANGUAGE_MAP: Dict[str, str] = {
    "zh-CN": "Chinese", "zh-TW": "Chinese", "en-US": "English", "en-GB": "English",
    "ja-JP": "Japanese", "ko-KR": "Korean", "de-DE": "German", "fr-FR": "French",
    "ru-RU": "Russian", "pt-PT": "Portuguese", "pt-BR": "Portuguese", "es-ES": "Spanish",
    "it-IT": "Italian",
}
QWEN3_DEFAULT_MODELS = {
    "custom_voice": "Qwen/Qwen3-TTS-12Hz-1.7B-CustomVoice",
    "voice_design": "Qwen/Qwen3-TTS-12Hz-1.7B-VoiceDesign",
    "voice_clone": "Qwen/Qwen3-TTS-12Hz-1.7B-Base",
}
MODES = ("custom_voice", "voice_design", "voice_clone")


def _coerce_bool(value: Any, default: bool) -> bool:
    """Tolerant bool coercion for params arriving over the API (copy of the
    JAX engines' ``coerce_bool``)."""
    if isinstance(value, bool):
        return value
    if value is None:
        return default
    if isinstance(value, (int, float)):
        return bool(value)
    text = str(value).strip().lower()
    if text in {"1", "true", "yes", "y", "on"}:
        return True
    if text in {"0", "false", "no", "n", "off"}:
        return False
    return default


class Qwen3Engine(ResidentEngine):
    id = "qwen3"
    supports_ref_audio = False
    supports_inter_chunk_gap = True
    native_sr = 24000

    def _create_runtime(self):
        from vocalie_tts_tpu_torch.models.lmtts.runtime import LMTTSRuntime

        return LMTTSRuntime.create(self.assets, device=self.device)

    def supported_languages(self) -> List[str]:
        return list(QWEN3_LANGUAGE_MAP)

    def default_language(self) -> str:
        return "fr-FR"

    def map_language(self, bcp47: Optional[str]) -> str:
        if not bcp47:
            return "French"
        return QWEN3_LANGUAGE_MAP.get(bcp47, "Auto")

    def _resolve_request(self, voice_ref_path, params):
        """(mode, model_id, speaker, instruct) from the public params: a
        reference switches custom_voice to voice_clone unless the mode was
        asked for; voice_clone needs a reference of at least 1 s."""
        mode = str(params.get("qwen3_mode") or "custom_voice")
        if mode not in MODES:
            mode = "custom_voice"
        if mode == "custom_voice" and voice_ref_path and "qwen3_mode" not in params:
            mode = "voice_clone"
        if mode == "voice_clone" and not voice_ref_path:
            raise EngineUnavailableError("Qwen3 voice clone requiert un ref audio.")
        if mode == "voice_clone" and voice_ref_path:
            validate_ref_audio(voice_ref_path, min_duration_s=1.0)
        model_id = params.get("model_id") or QWEN3_DEFAULT_MODELS.get(mode)
        speaker = params.get("voice") or params.get("voice_id") or params.get("speaker")
        if mode != "custom_voice":
            speaker = None
        instruct = params.get("instruct") or ""
        emotion = params.get("emotion")
        if not instruct and emotion and str(emotion) != "neutral":
            instruct = str(emotion)
        return mode, model_id, speaker, instruct

    def _run(self, texts, voice_ref_path, lang, progress_cb, params):
        mode, model_id, speaker, instruct = self._resolve_request(voice_ref_path, params)
        results = self.runtime().synthesize_batch(
            list(texts), mode=mode, language=self.map_language(lang), speaker=speaker,
            instruct=instruct, ref_text=params.get("ref_text") or "",
            x_vector_only=_coerce_bool(params.get("x_vector_only_mode"), True),
            voice_ref_path=voice_ref_path, progress_cb=progress_cb)
        extra = {"backend_id": self.id, "backend_lang": lang, "qwen3_mode": mode,
                 "qwen3_model": model_id, "qwen3_speaker": speaker}
        return [(audio, sr, {**meta, **extra}) for audio, sr, meta in results]

    def synthesize_chunk(self, text: str, *, voice_ref_path: Optional[str] = None,
                         lang: Optional[str] = None, **params: Any):
        return self._run([text], voice_ref_path, lang, None, params)[0]

    def synthesize_batch(self, texts, *, voice_ref_path: Optional[str] = None,
                         lang: Optional[str] = None, progress_cb=None,
                         **params: Any) -> List[tuple]:
        """Bucketed batched decode of a whole script's chunks in one prefill
        and one decode loop."""
        return self._run(texts, voice_ref_path, lang, progress_cb, params)


__all__ = ["Qwen3Engine", "QWEN3_LANGUAGE_MAP", "QWEN3_DEFAULT_MODELS", "validate_ref_audio"]
