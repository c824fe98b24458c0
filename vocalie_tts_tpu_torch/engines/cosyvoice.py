"""CosyVoice-class engine of the port (counterpart of the synthesis part of
``vocalie_tts_tpu/engines/cosyvoice.py``): variants instruct / clone /
cross-lingual, instruct presets, the language map and the streaming
capability, mapped onto :class:`CosyVoiceRuntime`.

Clone and cross-lingual refuse a request without a reference audio with
the JAX engine's errors; with one, the runtime raises
``NotImplementedError`` (the speaker encoder and the S3 tokenizer are not
ported yet).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

from vocalie_tts_tpu_torch.engines.base import EngineUnavailableError, ResidentEngine

COSYVOICE_DEFAULT_MODELS = {
    "clone": "FunAudioLLM/Fun-CosyVoice3-0.5B-2512",
    "instruct": "FunAudioLLM/Fun-CosyVoice3-0.5B-2512",
    "cross_lingual": "FunAudioLLM/Fun-CosyVoice3-0.5B-2512",
}

#: BCP-47 → the model's language name (copy of the JAX engine's map)
COSYVOICE_LANGUAGE_MAP: Dict[str, str] = {
    "fr-FR": "French",
    "fr-CA": "French",
    "en-US": "English",
    "en-GB": "English",
    "zh-CN": "Chinese",
    "zh-TW": "Chinese",
    "ja-JP": "Japanese",
    "ko-KR": "Korean",
    "de-DE": "German",
    "es-ES": "Spanish",
    "it-IT": "Italian",
    "ru-RU": "Russian",
    "pt-PT": "Portuguese",
    "pt-BR": "Portuguese",
}

INSTRUCT_CHOICES = [
    ("Aucune", ""),
    ("Joyeux", "用开心的语气说"),
    ("Triste", "用伤心的语气说"),
    ("Colère", "用生气的语气说"),
    ("Surpris", "用惊讶的语气说"),
    ("Calme", "用冷静的语气说"),
    ("Rapide", "快速"),
    ("Lent", "慢速"),
]

_MODES = {"instruct", "clone", "cross_lingual"}


def _coerce_bool(value, default: bool) -> bool:
    if value is None:
        return default
    if isinstance(value, str):
        return value.strip().lower() in {"1", "true", "yes", "on"}
    return bool(value)


class CosyVoiceEngine(ResidentEngine):
    id = "cosyvoice"
    supports_ref_audio = True
    supports_inter_chunk_gap = True
    uses_internal_voices = False
    native_sr = 24000

    _ENGINE_MODE_MAP = {
        "cosyvoice_instruct": "instruct",
        "cosyvoice_clone": "clone",
        "cosyvoice_cross": "cross_lingual",
    }

    def _create_runtime(self):
        from vocalie_tts_tpu_torch.models.cosyvoice.runtime import CosyVoiceRuntime

        return CosyVoiceRuntime.create(self.assets, device=self.device)

    @classmethod
    def engine_variants(cls) -> List[Dict[str, str]]:
        return [
            {"id": "cosyvoice_instruct", "label": "CosyVoice (Instruct)"},
            {"id": "cosyvoice_clone", "label": "CosyVoice (Voice Clone)"},
            {"id": "cosyvoice_cross", "label": "CosyVoice (Cross-lingual)"},
        ]

    def map_language(self, bcp47: Optional[str]) -> str:
        if not bcp47:
            return "French"
        return COSYVOICE_LANGUAGE_MAP.get(bcp47, "Auto")

    def supports_ref_for_engine(self, engine_id: str) -> bool:
        return engine_id in {"cosyvoice_clone", "cosyvoice_cross", "cosyvoice_instruct"}

    def capabilities(self, engine_id: Optional[str] = None) -> Dict[str, Any]:
        ref = self.supports_ref_for_engine(engine_id) if engine_id else self.supports_ref_audio
        return {
            "uses_voice_reference": bool(ref),
            "uses_internal_voices": self.uses_internal_voices,
            "auto_resolved_keys": ["cosyvoice_mode"],
            "supports_instruct": engine_id == "cosyvoice_instruct",
            "supports_cross_lingual": engine_id == "cosyvoice_cross",
            "supports_streaming": True,
            "supports_emotion": engine_id == "cosyvoice_instruct",
            "supports_fine_grained_control": engine_id == "cosyvoice_instruct",
        }

    # ── synthesis ───────────────────────────────────────────────────────

    def _mode(self, params, default_engine: str) -> str:
        engine_id = params.get("engine_id") or default_engine
        mode = self._ENGINE_MODE_MAP.get(engine_id, self._ENGINE_MODE_MAP[default_engine])
        explicit = params.get("cosyvoice_mode")
        return explicit if explicit in _MODES else mode

    def synthesize_stream(self, text: str, *, voice_ref_path: Optional[str] = None,
                          lang: Optional[str] = None, **params: Any):
        """Packets straight off the pipelined window decode."""
        mode = self._mode(params, "cosyvoice_instruct")
        if mode in {"clone", "cross_lingual"} and not voice_ref_path:
            raise EngineUnavailableError(
                "CosyVoice clone/cross-lingual requiert un audio de référence."
            )
        yield from self.runtime().synthesize_streaming(
            text,
            mode=mode,
            language=self.map_language(lang),
            instruct_text=params.get("instruct_text") or params.get("instruct_preset") or "",
            prompt_text=params.get("prompt_text") or "",
            voice_ref_path=voice_ref_path,
        )

    def _resolve_request(self, voice_ref_path, params):
        """(mode, model_id, instruct_text, prompt_text, streaming) from the
        public params, shared by the chunk and batch entry points."""
        mode = self._mode(params, "cosyvoice_clone")
        if mode == "clone" and not voice_ref_path:
            raise EngineUnavailableError("CosyVoice clone requiert un audio de référence (≥3s).")
        if mode == "cross_lingual" and not voice_ref_path:
            raise EngineUnavailableError(
                "CosyVoice cross-lingual requiert un audio de référence."
            )
        model_id = params.get("model_id") or COSYVOICE_DEFAULT_MODELS[mode]
        instruct_text = params.get("instruct_text") or params.get("instruct_preset") or ""
        prompt_text = params.get("prompt_text") or ""
        streaming = _coerce_bool(params.get("streaming"), False)
        return mode, model_id, instruct_text, prompt_text, streaming

    def _meta(self, meta, lang, mode, model_id, streaming):
        meta.update({"backend_id": self.id, "backend_lang": lang, "cosyvoice_mode": mode,
                     "cosyvoice_model": model_id, "cosyvoice_streaming": streaming})
        return meta

    def synthesize_chunk(self, text: str, *, voice_ref_path: Optional[str] = None,
                         lang: Optional[str] = None, **params: Any):
        mode, model_id, instruct_text, prompt_text, streaming = self._resolve_request(
            voice_ref_path, params)
        audio, sr, meta = self.runtime().synthesize(
            text, mode=mode, language=self.map_language(lang), instruct_text=instruct_text,
            prompt_text=prompt_text, streaming=streaming, voice_ref_path=voice_ref_path,
        )
        return audio, sr, self._meta(meta, lang, mode, model_id, streaming)

    def synthesize_batch(self, texts, *, voice_ref_path: Optional[str] = None,
                         lang: Optional[str] = None, progress_cb=None, **params: Any):
        """Bucketed batched decode: all chunks in one decode loop."""
        mode, model_id, instruct_text, prompt_text, _streaming = self._resolve_request(
            voice_ref_path, params)
        results = self.runtime().synthesize_batch(
            list(texts), mode=mode, language=self.map_language(lang),
            instruct_text=instruct_text, prompt_text=prompt_text,
            streaming=False,  # batch mode renders whole chunks
            voice_ref_path=voice_ref_path, progress_cb=progress_cb,
        )
        for _audio, _sr, meta in results:
            self._meta(meta, lang, mode, model_id, False)
        return results


__all__ = ["CosyVoiceEngine", "COSYVOICE_LANGUAGE_MAP", "COSYVOICE_DEFAULT_MODELS",
           "INSTRUCT_CHOICES", "EngineUnavailableError"]
