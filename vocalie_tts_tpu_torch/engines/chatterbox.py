"""Chatterbox-class engine of the port (counterpart of the synthesis part
of ``vocalie_tts_tpu/engines/chatterbox.py``): maps the request's engine
params onto :class:`ChatterboxRuntime` and keeps the runtime resident.

Weights come from ``<assets>/chatterbox/weights`` (the JAX package's
``.npz`` format, ``$VOCALIE_ASSETS_DIR`` or ``.assets`` at the repository
root), or are random from a seed when ``VOCALIE_ALLOW_RANDOM_WEIGHTS=1``
and no checkpoint is there.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

from vocalie_tts_tpu_torch.engines.base import ResidentEngine

#: BCP-47 → model language code (copy of the JAX catalog's map)
CHATTERBOX_LANGUAGE_MAP: Dict[str, str] = {
    "fr-FR": "fr",
    "en-US": "en",
    "en-GB": "en",
    "es-ES": "es",
    "de-DE": "de",
    "it-IT": "it",
    "pt-PT": "pt",
    "nl-NL": "nl",
}


class ChatterboxEngine(ResidentEngine):
    id = "chatterbox"
    supports_inter_chunk_gap = True
    native_sr = 24000

    def _create_runtime(self):
        from vocalie_tts_tpu_torch.models.chatterbox.runtime import ChatterboxRuntime

        return ChatterboxRuntime.create(self.assets, device=self.device)

    def map_language(self, bcp47: Optional[str]) -> str:
        if not bcp47:
            return "fr"
        return CHATTERBOX_LANGUAGE_MAP.get(bcp47, bcp47.split("-")[0])

    def synthesize_batch(self, texts, *, voice_ref_path: Optional[str] = None,
                         lang: Optional[str] = None, progress_cb=None,
                         **params: Any) -> List[tuple]:
        """Bucketed batched decode of a whole script's chunks."""
        mode = str(params.get("tts_model_mode") or params.get("chatterbox_mode") or "fr_finetune")
        results = self.runtime().synthesize_batch(
            list(texts),
            mode=mode,
            lang=self.map_language(lang),
            voice_ref_path=voice_ref_path,
            exaggeration=float(params.get("exaggeration", 0.5)),
            cfg_weight=float(
                params.get("multilang_cfg_weight", 0.5) if mode == "multilang"
                else params.get("cfg_weight", 0.6)
            ),
            temperature=float(params.get("temperature", 0.5)),
            repetition_penalty=float(params.get("repetition_penalty", 1.35)),
            progress_cb=progress_cb,
        )
        return [(audio, sr, {**meta, "backend_id": self.id, "backend_lang": lang})
                for audio, sr, meta in results]


__all__ = ["ChatterboxEngine", "CHATTERBOX_LANGUAGE_MAP"]
