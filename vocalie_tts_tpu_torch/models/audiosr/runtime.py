"""AudioSR runtime: file-level enhancement with chunked overlap-add
(counterpart of ``vocalie_tts_tpu/models/audiosr/runtime.py``).

The parameter surface is the reference worker's: ddim_steps,
guidance_scale, seed, chunk_size / overlap (samples at 48 kHz),
multiband_ensemble + input_cutoff (Butterworth lowpass), PCM_16 48 kHz
output. Overlap-add windows are stacked into batched DDIM dispatches
(window-count buckets up to 64, so 104 s of audio runs as 64 + 64 + 32),
each window's DDIM noise drawn from a generator seeded with
``seed + first row of its dispatch``. Serving scale computes the VAE and
UNet in bf16 (``VOCALIE_AUDIOSR_BF16``, default on except at ``tiny``) with
int8 UNet convs (``VOCALIE_AUDIOSR_INT8``, default on with bf16), and
stitches the windows on the device (``VOCALIE_AUDIOSR_DEVICE_STITCH``,
default on).
"""

from __future__ import annotations

import dataclasses
import os
import time
from pathlib import Path
from typing import Any, Dict

import numpy as np
import torch
from scipy.signal import butter, sosfiltfilt

from vocalie_tts_tpu_torch.device import div_const, resolve_device
from vocalie_tts_tpu_torch.dsp.host import resample
from vocalie_tts_tpu_torch.io.wavio import read_wav, write_wav
from vocalie_tts_tpu_torch.models.audiosr.model import (
    AudioSRConfig,
    enhance_window,
    init_audiosr,
    latent_shape,
)
from vocalie_tts_tpu_torch.models.common.unet2d import quantize_unet_convs
from vocalie_tts_tpu_torch.models.common.weights import checkpoint_exists, load_params, save_params
from vocalie_tts_tpu_torch.ops.kv_cache import pick_bucket
from vocalie_tts_tpu_torch.utils.env import bool_env

WINDOW_BUCKETS = (32768, 65536, 131072)
#: window-count buckets of the batched overlap-add path
WINDOW_COUNT_BUCKETS = (1, 2, 4, 8, 16, 32, 64)

SCALES: Dict[str, AudioSRConfig] = {
    "full": AudioSRConfig(),
    "small": AudioSRConfig(vae_base=32, unet_channels=64, unet_res_blocks=1),
    "tiny": AudioSRConfig(
        n_mels=32, vae_base=8, vae_mult=(1, 2), vae_res_blocks=1,
        z_channels=4, embed_dim=4, unet_channels=16, unet_mult=(1, 2),
        unet_res_blocks=1, unet_attn_res=(2,), unet_heads=2,
    ),
}

#: ``VOCALIE_AUDIOSR_DEVICE_STITCH=0`` → the host numpy overlap-add
_DEVICE_STITCH = bool_env("VOCALIE_AUDIOSR_DEVICE_STITCH", True)


def _to_float(arr: np.ndarray) -> np.ndarray:
    """Device output → f32 audio (rescales the int16 PCM format)."""
    if arr.dtype == np.int16:
        return arr.astype(np.float32) / 32767.0
    return arr.astype(np.float32)


def _stitch_batch_segment(batch_out: torch.Tensor, row0: int, w_act: int, *, chunk: int,
                          hop: int, overlap: int):
    """Overlap-add ONE window-count batch into its exclusive span, on the
    device. ``batch_out``: [bucket, chunk] outputs of global windows
    ``row0 .. row0+bucket-1`` (rows ≥ ``w_act`` are bucket padding, weight
    0). Triangular crossfades as the host stitch: fade-in on every window
    but the global first, fade-out on every window but the global last.
    Returns ``(seg, head_num, head_den, tail_num, tail_den)``: the
    normalized span [row0·hop, (row0+bucket)·hop) (its first ``overlap``
    samples lack the predecessor batch's tail when row0 > 0), this batch's
    numerator/denominator of those first samples, and its contribution to
    the next span's head."""
    x = batch_out[:, :chunk]
    wire_int16 = x.dtype == torch.int16
    x = div_const(x.float(), 32767.0) if wire_int16 else x.float()
    bucket = x.shape[0]
    dev = x.device
    g = row0 + torch.arange(bucket, device=dev)[:, None]          # global rows
    pos = torch.arange(chunk, dtype=torch.float32, device=dev)[None, :]
    den_r = float(max(overlap - 1, 1))
    ramp_in = torch.clamp(div_const(pos, den_r), 0.0, 1.0)
    ramp_out = torch.clamp(div_const(float(chunk - 1) - pos, den_r), 0.0, 1.0)
    one = torch.ones((), device=dev)
    w_mat = (torch.where(g >= 1, ramp_in, one) * torch.where(g <= w_act - 2, ramp_out, one)
             * (g < w_act).float())
    weighted = x * w_mat

    def fold(rows):
        acc = torch.zeros(bucket * hop + hop, dtype=torch.float32, device=dev)
        acc[: bucket * hop] = rows[:, :hop].reshape(-1)
        tails = torch.zeros((bucket, hop), dtype=torch.float32, device=dev)
        tails[:, :overlap] = rows[:, hop:]
        acc[hop:] += tails.reshape(-1)
        return acc

    num, den = fold(weighted), fold(w_mat)
    seg = num[: bucket * hop] / torch.clamp(den[: bucket * hop], min=1e-6)
    if wire_int16:
        seg = torch.round(torch.clamp(seg, -1.0, 1.0) * 32767.0).to(torch.int16)
    return (seg, num[:overlap], den[:overlap], num[bucket * hop : bucket * hop + overlap],
            den[bucket * hop : bucket * hop + overlap])


class AudioSRRuntime:
    def __init__(self, params: Dict[str, Any], cfg: AudioSRConfig, weights_dir: Path,
                 device: torch.device) -> None:
        self.params = params
        # the full-precision tree for save_weights (create() sets it when
        # the serving tree is an int8 view)
        self._save_params = params
        self.cfg = cfg
        self.device = device
        self.weights_dir = Path(weights_dir)

    @classmethod
    def create(cls, assets_dir: Path, force_init: bool = False, *,
               device: str | torch.device = "cuda", seed: int = 5) -> "AudioSRRuntime":
        """Build the runtime from ``<assets_dir>/weights/audiosr.npz`` (the
        JAX package's format), or from random weights made from ``seed`` on
        the device where none is saved or ``force_init``."""
        dev = resolve_device(device)
        scale = os.environ.get("VOCALIE_MODEL_SCALE", "full")
        cfg = SCALES[scale]
        if bool_env("VOCALIE_AUDIOSR_BF16", scale != "tiny"):
            cfg = dataclasses.replace(cfg, dtype=torch.bfloat16)
        use_int8 = cfg.dtype != torch.float32 and bool_env("VOCALIE_AUDIOSR_INT8", True)
        weights_dir = Path(assets_dir) / "weights"
        params = init_audiosr(cfg, generator=torch.Generator(device=dev).manual_seed(seed),
                              device=dev)
        if not force_init and checkpoint_exists(weights_dir, "audiosr"):
            params = load_params(weights_dir, "audiosr", params, dev)
        serving = {**params, "unet": quantize_unet_convs(params["unet"])} if use_int8 else params
        rt = cls(serving, cfg, weights_dir, dev)
        # checkpoints hold the full-precision tree (quantizing a re-loaded
        # int8 tree would round twice)
        rt._save_params = params
        return rt

    def save_weights(self) -> None:
        save_params(self.weights_dir, "audiosr", self._save_params, meta={"family": "audiosr"})

    def warmup(self) -> None:
        audio = np.zeros(self.cfg.sample_rate, np.float32)
        self.enhance_audio(audio, self.cfg.sample_rate, ddim_steps=20, guidance_scale=2.5, seed=0)

    # ── enhancement ─────────────────────────────────────────────────────

    def enhance_audio(self, audio: np.ndarray, sr: int, *, ddim_steps: int = 100,
                      guidance_scale: float = 2.5, seed: int = 0, chunk_size: int = 32768,
                      overlap: int = 1024, multiband_ensemble: bool = False,
                      input_cutoff: int = 8000) -> np.ndarray:
        """Enhance mono/stereo audio → mono 48 kHz float32."""
        cfg = self.cfg
        if audio.ndim > 1:
            audio = audio.mean(axis=1)
        if sr != cfg.sample_rate:
            audio = resample(audio.astype(np.float32), sr, cfg.sample_rate)
        audio = audio.astype(np.float32)

        def run_pass(x: np.ndarray) -> np.ndarray:
            return self._chunked(x, ddim_steps=ddim_steps, guidance_scale=guidance_scale,
                                 seed=seed, chunk_size=chunk_size, overlap=overlap)

        out = run_pass(audio)
        if multiband_ensemble and input_cutoff > 0:
            # mean of the full-band pass and a lowpassed-input pass
            out_low = run_pass(self._butter_lowpass(audio, input_cutoff, cfg.sample_rate))
            n = min(len(out), len(out_low))
            out = 0.5 * (out[:n] + out_low[:n])
        return np.clip(out, -1.0, 1.0)

    def enhance_file(self, *, input_path: str, output_path: str, ddim_steps: int = 100,
                     guidance_scale: float = 2.5, seed: int = 0, chunk_size: int = 32768,
                     overlap: int = 1024, multiband_ensemble: bool = False,
                     input_cutoff: int = 8000) -> Dict[str, Any]:
        t0 = time.monotonic()
        audio, sr = read_wav(input_path)
        out = self.enhance_audio(audio, sr, ddim_steps=ddim_steps, guidance_scale=guidance_scale,
                                 seed=seed, chunk_size=chunk_size, overlap=overlap,
                                 multiband_ensemble=multiband_ensemble,
                                 input_cutoff=input_cutoff)
        write_wav(output_path, out, self.cfg.sample_rate, subtype="PCM_16")
        return {"sample_rate": self.cfg.sample_rate,
                "duration_s": len(out) / self.cfg.sample_rate,
                "elapsed_s": round(time.monotonic() - t0, 2)}

    # ── internals ───────────────────────────────────────────────────────

    @staticmethod
    def _butter_lowpass(x: np.ndarray, cutoff: int, sr: int) -> np.ndarray:
        nyq = sr / 2
        cutoff = min(cutoff, int(nyq * 0.95))
        sos = butter(8, cutoff / nyq, btype="low", output="sos")
        return sosfiltfilt(sos, x).astype(np.float32)

    def _chunked(self, audio: np.ndarray, *, ddim_steps: int, guidance_scale: float,
                 seed: int, chunk_size: int, overlap: int) -> np.ndarray:
        cfg = self.cfg
        n = len(audio)
        if chunk_size <= 0 or n <= chunk_size:
            bucket = pick_bucket(max(n, cfg.hop), WINDOW_BUCKETS)
            padded = np.zeros((1, bucket), np.float32)
            padded[0, :n] = audio
            return self._run_batch(padded, ddim_steps, guidance_scale, seed)[0, :n]

        hop = chunk_size - overlap
        spans = []
        for start in range(0, n, hop):
            end = min(start + chunk_size, n)
            spans.append((start, end))
            if end >= n:
                break
        n_windows = len(spans)
        pieces = np.zeros((n_windows, chunk_size), np.float32)
        for i, (start, end) in enumerate(spans):
            pieces[i, : end - start] = audio[start:end]

        hop_uniform = (n_windows >= 2 and 0 < overlap <= hop
                       and all(spans[i] == (i * hop, i * hop + chunk_size)
                               for i in range(n_windows - 1)))
        device_stitch = _DEVICE_STITCH and hop_uniform

        # every dispatch is queued before the first read, so reading batch
        # i overlaps the device's work on batch i+1
        in_flight = []   # (row0, bucket, device output or stitched segment)
        row = 0
        while row < n_windows:
            remaining = n_windows - row
            bucket = pick_bucket(remaining, WINDOW_COUNT_BUCKETS)
            count = min(remaining, bucket)
            batch = np.zeros((bucket, chunk_size), np.float32)
            batch[:count] = pieces[row : row + count]
            dev = self._dispatch_batch(batch, ddim_steps, guidance_scale, seed + row)
            if device_stitch:
                dev = _stitch_batch_segment(dev, row, n_windows, chunk=chunk_size, hop=hop,
                                            overlap=overlap)
            in_flight.append((row, bucket, dev))
            row += count

        if device_stitch:
            # the boundary strips (``overlap`` samples) are patched on the
            # host with the predecessor's tail contribution
            last_row0, last_bucket = in_flight[-1][0], in_flight[-1][1]
            out = np.zeros((last_row0 + last_bucket) * hop + overlap, np.float32)
            prev_tail = None
            for row0, bucket, handles in in_flight:
                seg, h_num, h_den, t_num, t_den = (t.cpu().numpy() for t in handles)
                span0 = row0 * hop
                out[span0 : span0 + bucket * hop] = _to_float(seg)
                if prev_tail is not None:
                    bnum = h_num + prev_tail[0]
                    bden = h_den + prev_tail[1]
                    out[span0 : span0 + overlap] = bnum / np.maximum(bden, 1e-6)
                prev_tail = (t_num, t_den)
            end0 = (last_row0 + last_bucket) * hop
            if n > end0:  # exact-fit last bucket: the final tail strip
                out[end0:] = prev_tail[0] / np.maximum(prev_tail[1], 1e-6)
            return out[:n]

        enhanced_all = np.zeros((n_windows, chunk_size), np.float32)
        for row0, bucket, dev in in_flight:
            count = min(bucket, n_windows - row0)
            enhanced_all[row0 : row0 + count] = _to_float(dev.cpu().numpy())[:count, :chunk_size]

        # host overlap-add with triangular crossfades: every span but the
        # last is a full chunk at i·hop, laid out as a [hop] body plus an
        # [overlap] tail added into the next row's head
        out = np.zeros(n, np.float32)
        weight = np.zeros(n, np.float32)
        u = len(spans) - 1
        vectorized = (u >= 1 and 0 < overlap <= hop
                      and all(spans[i] == (i * hop, i * hop + chunk_size) for i in range(u)))
        start_idx = 0
        if vectorized:
            ramp = np.linspace(0.0, 1.0, overlap, dtype=np.float32)
            w_mat = np.ones((u, chunk_size), np.float32)
            w_mat[1:, :overlap] = ramp            # fade-in (all but first)
            w_mat[:, -overlap:] = ramp[::-1]      # fade-out (end < n for all)
            weighted = enhanced_all[:u] * w_mat
            total = (u - 1) * hop + chunk_size
            out[: u * hop] = weighted[:, :hop].reshape(-1)
            weight[: u * hop] = w_mat[:, :hop].reshape(-1)
            out[: u * hop].reshape(u, hop)[1:, :overlap] += weighted[:-1, hop:]
            weight[: u * hop].reshape(u, hop)[1:, :overlap] += w_mat[:-1, hop:]
            out[u * hop : total] += weighted[-1, hop:]
            weight[u * hop : total] += w_mat[-1, hop:]
            start_idx = u
        for idx in range(start_idx, len(spans)):
            start, end = spans[idx]
            w = np.ones(end - start, np.float32)
            if overlap > 0:
                ramp = np.linspace(0.0, 1.0, min(overlap, len(w)), dtype=np.float32)
                if start > 0:
                    w[: len(ramp)] = ramp
                if end < n:
                    w[-len(ramp):] = ramp[::-1]
            out[start:end] += enhanced_all[idx, : end - start] * w
            weight[start:end] += w
        return out / np.maximum(weight, 1e-6)

    def _draw_noise(self, shape, seed: int) -> torch.Tensor:
        """One dispatch's DDIM start noise, from a generator seeded with ``seed``."""
        gen = torch.Generator(device=self.device).manual_seed(int(seed))
        return torch.randn(shape, generator=gen, device=self.device)

    def _dispatch_batch(self, batch: np.ndarray, ddim_steps: int, guidance_scale: float,
                        seed: int) -> torch.Tensor:
        """Queue one batched diffusion dispatch [W, T] (no host sync);
        sample length padded to a bucket. Returns the device output."""
        w, t = batch.shape
        bucket = pick_bucket(t, WINDOW_BUCKETS)
        if bucket != t:
            padded = np.zeros((w, bucket), np.float32)
            padded[:, :t] = batch
            batch = padded
        if self.cfg.dtype != torch.float32:
            # int16 PCM, as the JAX package ships it: the model sees the
            # 16-bit-rounded samples
            batch = np.round(np.clip(batch, -1.0, 1.0) * 32767.0).astype(np.int16)
        audio = torch.from_numpy(batch).to(self.device)
        noise = self._draw_noise(latent_shape(self.cfg, w, bucket), seed)
        with torch.no_grad():
            return enhance_window(self.params, self.cfg, audio, noise, ddim_steps=int(ddim_steps),
                                  guidance_scale=float(guidance_scale))

    def _run_batch(self, batch: np.ndarray, ddim_steps: int, guidance_scale: float,
                   seed: int) -> np.ndarray:
        return _to_float(self._dispatch_batch(batch, ddim_steps, guidance_scale, seed)
                         .cpu().numpy())


__all__ = ["AudioSRRuntime", "SCALES", "WINDOW_BUCKETS", "WINDOW_COUNT_BUCKETS"]
