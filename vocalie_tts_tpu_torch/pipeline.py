"""Synthesis pipeline: chunks → engine batch decode → stitch → WAV
(counterpart of ``vocalie_tts_tpu/pipeline.py::run_tts_pipeline``, same
request dict and meta).

Per-chunk clean render, short-text padding, resample to the target rate,
inter-chunk gap with crossfades. The engine is passed in, or built from
the port's own ``engines.ENGINES`` by ``tts_backend`` (``chatterbox``,
``cosyvoice``, ``xtts``: the voice clone, which needs ``voice_ref_path``,
``qwen3``: its three modes, a ``voice_ref_path`` taking voice_clone,
``piper``: the fr_FR VITS at 22050 Hz, resampled like any engine) on
``device`` — the GPU unless the caller asks for the CPU.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from vocalie_tts_tpu_torch.dsp.host import apply_inter_chunk_gap, resample
from vocalie_tts_tpu_torch.io.wavio import write_wav
from vocalie_tts_tpu_torch.text import (
    DEFAULT_MAX_EST_SECONDS_PER_CHUNK,
    DEFAULT_MAX_WORDS_WITHOUT_TERMINATOR,
    DEFAULT_MIN_WORDS_PER_CHUNK,
    ChunkInfo,
    chunk_script,
    render_clean_text_from_segments,
    strip_legacy_tokens,
)

TARGET_SR = 24000
MIN_WORDS_FOR_SYNTHESIS = 3  # shorter inputs are repetition-padded


@dataclass(frozen=True)
class PipelineResult:
    out_path: str
    meta: Dict[str, Any]


def pad_short_text(text: str, min_words: int = MIN_WORDS_FOR_SYNTHESIS) -> tuple[str, int]:
    """Repeat very short text so the model has prosodic context."""
    if not text or not text.strip():
        return text, 1
    words = text.split()
    if len(words) >= min_words:
        return text, 1
    reps = -(-min_words // len(words))
    separator = " " if text.rstrip().endswith((".", "!", "?")) else ". "
    return (separator.join([text] * reps) if reps > 1 else text), reps


def run_tts_pipeline(request: dict, progress_cb=None, *, engine=None,
                     device: str | torch.device = "cuda"):
    t_start = time.monotonic()
    backend_id = request.get("tts_backend")
    if engine is None:
        from vocalie_tts_tpu_torch.engines import ENGINES

        cls = ENGINES.get(backend_id)
        if cls is None:
            raise ValueError(f"Backend introuvable: {backend_id}")
        engine = cls(device=device)
    elif engine.id != backend_id:
        raise ValueError(f"engine {engine.id!r} does not serve backend {backend_id!r}")
    if not engine.is_available():
        raise RuntimeError(f"Backend indisponible: {backend_id}. {engine.unavailable_reason()}")

    script = request.get("script") or ""
    if not script.strip():
        raise ValueError("Le texte est vide.")
    chunks = request.get("chunks") or []
    if chunks and not isinstance(chunks[0], ChunkInfo):
        raise ValueError("chunks must be ChunkInfo list")
    if not chunks:
        settings = request.get("chunk_settings") or {}
        chunks = list(chunk_script(
            script,
            min_words_per_chunk=int(settings.get("min_words_per_chunk", DEFAULT_MIN_WORDS_PER_CHUNK)),
            max_words_without_terminator=int(settings.get(
                "max_words_without_terminator", DEFAULT_MAX_WORDS_WITHOUT_TERMINATOR)),
            max_est_seconds_per_chunk=float(settings.get(
                "max_est_seconds_per_chunk", DEFAULT_MAX_EST_SECONDS_PER_CHUNK)),
        ))
    if not chunks:
        raise ValueError("Aucun chunk généré.")

    target_sr = int(request.get("target_sr") or TARGET_SR)
    engine_params = request.get("engine_params") or {}
    lang = request.get("lang_code") or request.get("lang")
    out_path = request.get("out_path")
    if not out_path:
        raise ValueError("out_path must be provided")
    if progress_cb:
        progress_cb(0.0)

    texts: List[str] = []
    for chunk in chunks:
        clean = strip_legacy_tokens(render_clean_text_from_segments(list(chunk.segments)))
        clean, _reps = pad_short_text(clean)
        if clean.strip():
            texts.append(clean)

    results = engine.synthesize_batch(
        texts, voice_ref_path=request.get("voice_ref_path"), lang=lang,
        progress_cb=progress_cb, **engine_params,
    )

    durations: List[float] = []
    retries: List[bool] = []
    audio_chunks: List[np.ndarray] = []
    backend_meta_last: Dict[str, Any] = {}
    backend_logs: List[str] = []
    for audio, sr, meta in results:
        if meta:
            backend_meta_last = dict(meta)
            if meta.get("stdout"):
                backend_logs.append(f"stdout: {meta['stdout']}")
            if meta.get("stderr"):
                backend_logs.append(f"stderr: {meta['stderr']}")
        audio = np.asarray(audio, dtype=np.float32)
        if sr != target_sr:
            audio = resample(audio, sr, target_sr)
        durations.append(len(audio) / float(target_sr))
        retries.append(bool(meta.get("retry")))
        audio_chunks.append(audio)
    if progress_cb:
        progress_cb(1.0)

    inter_chunk_gap_ms = int(request.get("inter_chunk_gap_ms") or 0)
    if not engine.supports_inter_chunk_gap:
        inter_chunk_gap_ms = 0
    gap_applied = bool(engine.supports_inter_chunk_gap and len(audio_chunks) > 1
                       and inter_chunk_gap_ms > 0)
    if gap_applied:
        final_audio = apply_inter_chunk_gap(audio_chunks, sr=target_sr, gap_ms=inter_chunk_gap_ms)
    else:
        final_audio = (np.concatenate(audio_chunks) if audio_chunks
                       else np.zeros(0, dtype=np.float32))

    out_path = str(Path(out_path).expanduser().resolve())
    write_wav(out_path, final_audio, target_sr)

    total = len(final_audio) / float(target_sr)
    elapsed = time.monotonic() - t_start
    meta = {
        "backend_id": backend_id,
        "backend_lang": lang,
        "chunks": len(chunks),
        "durations": durations,
        "retries": retries,
        "total_duration": total,
        "duration_sec": total,
        "sr": target_sr,
        "segments_count_total": len(chunks),
        "num_subunits": len(chunks),
        "backend_meta": backend_meta_last,
        "backend_logs": backend_logs,
        "warnings": [],
        "inter_chunk_gap_ms": inter_chunk_gap_ms,
        "inter_chunk_gap_applied": gap_applied,
        "inter_chunk_gap_engine": backend_id,
        "inter_chunk_gap_chunks": len(chunks),
        "perf": {
            "elapsed_ms": round(elapsed * 1000, 1),
            "audio_s": round(total, 3),
            "rtf": round(total / elapsed, 2) if elapsed > 0 else 0.0,
        },
    }
    return PipelineResult(out_path=out_path, meta=meta)


__all__ = ["TARGET_SR", "PipelineResult", "pad_short_text", "run_tts_pipeline"]
