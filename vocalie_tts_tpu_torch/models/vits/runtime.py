"""VITS engine runtime: bucketing, batching, weights, warm-up (counterpart
of ``vocalie_tts_tpu/models/vits/runtime.py``).

A multi-chunk script is one padded, bucketed batch through two stages:
A (``encode_and_durations``) predicts the durations, the host reads their
largest sum and picks the smallest frame bucket that holds it, and B
(``decode_frames``) renders only that many frames, so the vocoder (most
of the work) does not pay for ``max_frames``. One host read returns the
audio and the sample lengths.

The duration noise and the prior's ``eps`` come from the runtime's own
``torch.Generator`` on the device, scaled as JAX scales them
(``normal · noise_w``; ``eps · exp(logs_p) · noise_scale``). At
``noise_w = noise_scale = 0`` the output is deterministic.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from vocalie_tts_tpu_torch.device import resolve_device
from vocalie_tts_tpu_torch.models.common.weights import (
    checkpoint_exists,
    load_meta,
    load_params,
    save_params,
)
from vocalie_tts_tpu_torch.models.vits.model import (
    VITSConfig,
    decode_frames,
    encode_and_durations,
    init_vits,
)
from vocalie_tts_tpu_torch.ops.kv_cache import pick_bucket
from vocalie_tts_tpu_torch.text.phonemes import text_to_phone_ids
from vocalie_tts_tpu_torch.text.piper_ids import PiperIdMap, load_piper_id_map

PHONE_BUCKETS = (64, 128, 256, 512)
BATCH_BUCKETS = (1, 2, 4, 8)
FRAME_BUCKETS = (128, 256, 512, 1200)

#: "full" is Piper-medium scale; tiny serves CI
SCALES = {
    "full": VITSConfig(),
    "small": VITSConfig(d_model=128, n_layers=4, d_ff=512, latent_dim=128,
                        n_flows=2, flow_hidden=128, dp_filter=128),
    "tiny": VITSConfig(
        d_model=32, n_layers=2, n_heads=2, d_ff=64, latent_dim=32,
        n_flows=2, flow_hidden=32, flow_wn_layers=2, dp_filter=32,
        dp_flows=2, max_phones=128, max_frames=256, vocoder_channels=64,
    ),
}

VOICE_TO_SPEAKER = {
    "fr_FR-siwis-medium": 0,
    "fr_FR-upmc-medium": 1,
    "fr_FR-tom-medium": 2,
}


class VITSRuntime:
    """Piper-class engine runtime on resident PyTorch state."""

    def __init__(self, params, cfg: VITSConfig, weights_dir: Path, device: torch.device,
                 id_map: Optional[PiperIdMap] = None, seed: int = 0) -> None:
        self.params = params
        self.cfg = cfg
        self.device = device
        self.weights_dir = Path(weights_dir)
        #: published espeak phoneme_id_map (text/piper_ids.py) when the
        #: voice's config.json is staged beside the weights; the in-repo
        #: phone inventory otherwise
        self._id_map = id_map
        self._gen = torch.Generator(device=device).manual_seed(seed)

    # ── lifecycle ───────────────────────────────────────────────────────

    @classmethod
    def create(cls, assets_dir: Path, force_init: bool = False, *,
               device: str | torch.device = "cuda", seed: int = 42) -> "VITSRuntime":
        """Build the runtime from ``<assets_dir>/weights/vits.npz`` (the JAX
        package's format; ``n_phones`` from its meta, the id map from a
        staged ``piper_config.json`` or ``config.json``), or from random
        weights made from ``seed`` where the checkpoint is absent or
        ``force_init``."""
        dev = resolve_device(device)
        cfg = SCALES[os.environ.get("VOCALIE_MODEL_SCALE", "full")]
        weights_dir = Path(assets_dir) / "weights"
        id_map = None
        if not force_init:
            # published voices define their own phoneme-id space: n_phones
            # comes from the converted checkpoint's meta and the id
            # translation from its staged config.json
            n_phones = int(load_meta(weights_dir, "vits").get("n_phones", cfg.n_phones))
            if n_phones != cfg.n_phones:
                cfg = dataclasses.replace(cfg, n_phones=n_phones)
            id_map = load_piper_id_map(Path(assets_dir))
            if id_map is not None and id_map.max_id >= cfg.n_phones:
                logging.getLogger("vocalie_api").warning(
                    "piper voice config maps ids up to %d but the phone embedding has %d "
                    "rows — ignoring the id map", id_map.max_id, cfg.n_phones)
                id_map = None
        gen = torch.Generator(device=dev).manual_seed(seed)
        params = init_vits(cfg, generator=gen, device=dev)
        if not force_init and checkpoint_exists(weights_dir, "vits"):
            params = load_params(weights_dir, "vits", params, dev)
        return cls(params, cfg, weights_dir, dev, id_map=id_map, seed=seed)

    def save_weights(self) -> None:
        save_params(self.weights_dir, "vits", self.params,
                    meta={"family": "vits", "sample_rate": self.cfg.sample_rate,
                          "n_phones": self.cfg.n_phones})

    def warmup(self) -> None:
        self.synthesize("Bonjour le monde.", voice="fr_FR-siwis-medium")

    # ── synthesis ───────────────────────────────────────────────────────

    def synthesize(self, text: str, **kwargs) -> Tuple[np.ndarray, int, Dict[str, Any]]:
        return self.synthesize_batch([text], **kwargs)[0]

    def phone_batch(self, texts: List[str]) -> Tuple[np.ndarray, np.ndarray, int, int]:
        """Phone ids padded into (batch, phone) buckets → ``(phones [B, P]
        int32, lengths [B] int32, phone_bucket, batch_bucket)``."""
        if self._id_map is not None:
            seqs = [self._id_map.encode_text(t)[: self.cfg.max_phones] for t in texts]
        else:
            seqs = [text_to_phone_ids(t)[: self.cfg.max_phones] for t in texts]
        max_len = max((len(s) for s in seqs), default=1)
        phone_bucket = pick_bucket(max_len, PHONE_BUCKETS)
        batch_bucket = pick_bucket(len(seqs), BATCH_BUCKETS)
        phones = np.zeros((batch_bucket, phone_bucket), np.int32)
        lengths = np.zeros((batch_bucket,), np.int32)
        for i, s in enumerate(seqs):
            s = s[:phone_bucket]
            phones[i, : len(s)] = s
            lengths[i] = len(s)
        return phones, lengths, phone_bucket, batch_bucket

    @torch.no_grad()
    def synthesize_batch(
        self,
        texts: List[str],
        *,
        voice: str = "fr_FR-siwis-medium",
        length_scale: float = 1.0,
        noise_scale: float = 0.667,
        noise_w: float = 0.8,
        progress_cb=None,
    ) -> List[Tuple[np.ndarray, int, Dict[str, Any]]]:
        """One padded, bucketed batch through both stages for the whole
        chunk list."""
        t0 = time.monotonic()
        cfg, dev = self.cfg, self.device
        phones, lengths, phone_bucket, batch_bucket = self.phone_batch(texts)
        speaker = torch.full((batch_bucket,), VOICE_TO_SPEAKER.get(voice, 0),
                             dtype=torch.int32, device=dev)
        noise = torch.randn((batch_bucket, phone_bucket, 2), generator=self._gen,
                            device=dev) * float(noise_w)
        stats, durations = encode_and_durations(
            self.params, cfg, torch.from_numpy(phones).to(dev), torch.from_numpy(lengths).to(dev),
            speaker, noise, length_scale=float(length_scale))
        total_frames = int(durations.sum(1).max())
        frame_bucket = pick_bucket(max(total_frames, 1), FRAME_BUCKETS)
        eps = torch.randn((batch_bucket, frame_bucket, cfg.latent_dim), generator=self._gen,
                          device=dev)
        audio, sample_lengths = decode_frames(
            self.params, cfg, stats, durations, eps, max_frames=frame_bucket,
            speaker_id=speaker, noise_scale=float(noise_scale))
        # one host read for both outputs
        host = torch.cat([audio.float().reshape(-1),
                          sample_lengths.float()]).cpu().numpy()
        n_audio = audio.numel()
        audio = host[:n_audio].reshape(audio.shape)
        sample_lengths = host[n_audio:].astype(np.int64)
        elapsed = time.monotonic() - t0

        out: List[Tuple[np.ndarray, int, Dict[str, Any]]] = []
        for i in range(len(texts)):
            n = int(min(sample_lengths[i], audio.shape[1]))
            meta = {
                "engine": "piper",
                "phones": int(lengths[i]),
                "elapsed_ms_batch": round(elapsed * 1000, 1),
                "batch_bucket": batch_bucket,
                "phone_bucket": phone_bucket,
                "frame_bucket": frame_bucket,
            }
            out.append((audio[i, :n], cfg.sample_rate, meta))
            if progress_cb:
                progress_cb((i + 1) / len(texts))
        return out


__all__ = ["VITSRuntime", "SCALES", "PHONE_BUCKETS", "BATCH_BUCKETS", "FRAME_BUCKETS",
           "VOICE_TO_SPEAKER"]
