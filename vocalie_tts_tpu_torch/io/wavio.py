"""Minimal dependency-free WAV codec (PCM 16/24/32, float32/float64).

The reference stack reads/writes audio through libsndfile
(ref: backend/shared/tts_pipeline.py:226, audio_edit.py:38); this
environment has no soundfile wheel, so we implement the RIFF/WAVE
subset the product needs: mono/stereo PCM_16 (the delivery format,
ref: backend/shared/audio_edit.py:70), PCM_24/32 and IEEE float for
ingest. Pure numpy, no audio deps (the PCM_16 codec is the numpy form of the
JAX package's native one, in f32: clip, scale by 32767, round half away
from zero; decode divides by 32768).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from pathlib import Path
from typing import Tuple, Union

import numpy as np

PathLike = Union[str, Path]

_FMT_PCM = 0x0001
_FMT_IEEE_FLOAT = 0x0003
_FMT_EXTENSIBLE = 0xFFFE


@dataclass(frozen=True)
class WavInfo:
    frames: int
    channels: int
    samplerate: int
    sampwidth_bits: int
    format: str  # "pcm" | "float"


def _parse_chunks(data: bytes):
    """Yield (chunk_id, offset, size) for every RIFF chunk."""
    if len(data) < 12 or data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise ValueError("not a RIFF/WAVE file")
    pos = 12
    while pos + 8 <= len(data):
        cid = data[pos : pos + 4]
        (size,) = struct.unpack_from("<I", data, pos + 4)
        yield cid, pos + 8, size
        pos += 8 + size + (size & 1)  # chunks are word-aligned


def _decode_samples(raw: bytes, fmt_tag: int, bits: int) -> np.ndarray:
    if fmt_tag == _FMT_IEEE_FLOAT:
        dtype = np.float32 if bits == 32 else np.float64
        return np.frombuffer(raw, dtype=f"<f{bits // 8}").astype(np.float32)
    if fmt_tag != _FMT_PCM:
        raise ValueError(f"unsupported WAV format tag 0x{fmt_tag:04x}")
    if bits == 16:
        return np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    if bits == 32:
        return np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
    if bits == 8:
        return (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
    if bits == 24:
        b = np.frombuffer(raw, dtype=np.uint8)
        n = len(b) // 3
        b = b[: n * 3].reshape(n, 3)
        val = (
            b[:, 0].astype(np.int32)
            | (b[:, 1].astype(np.int32) << 8)
            | (b[:, 2].astype(np.int32) << 16)
        )
        val = np.where(val >= (1 << 23), val - (1 << 24), val)
        return val.astype(np.float32) / 8388608.0
    raise ValueError(f"unsupported PCM width: {bits} bits")


def read_wav(path: PathLike, always_2d: bool = False) -> Tuple[np.ndarray, int]:
    """Read a WAV file → (float32 audio in [-1, 1], sample_rate).

    Mono audio returns shape (n,) unless *always_2d*; multi-channel
    returns (n, channels).
    """
    data = Path(path).read_bytes()
    fmt = None
    audio = None
    for cid, off, size in _parse_chunks(data):
        if cid == b"fmt ":
            fmt_tag, channels, sr, _br, _ba, bits = struct.unpack_from("<HHIIHH", data, off)
            if fmt_tag == _FMT_EXTENSIBLE and size >= 40:
                (sub_tag,) = struct.unpack_from("<H", data, off + 24)
                fmt_tag = sub_tag
            fmt = (fmt_tag, channels, sr, bits)
        elif cid == b"data":
            audio = data[off : off + size]
    if fmt is None or audio is None:
        raise ValueError("WAV missing fmt or data chunk")
    fmt_tag, channels, sr, bits = fmt
    samples = _decode_samples(audio, fmt_tag, bits)
    if channels > 1:
        n = len(samples) // channels
        samples = samples[: n * channels].reshape(n, channels)
    elif always_2d:
        samples = samples.reshape(-1, 1)
    return samples, int(sr)


def write_wav(
    path: PathLike,
    audio: np.ndarray,
    samplerate: int,
    subtype: str = "PCM_16",
) -> None:
    """Write float audio ([-1, 1]) as WAV. Subtypes: PCM_16, PCM_24, FLOAT."""
    audio = np.asarray(audio)
    if audio.ndim == 1:
        frames, channels = audio.shape[0], 1
        interleaved = audio
    elif audio.ndim == 2:
        frames, channels = audio.shape
        interleaved = audio.reshape(-1)
    else:
        raise ValueError("audio must be 1-D or 2-D")

    if subtype == "PCM_16":
        fmt_tag, bits = _FMT_PCM, 16
        scaled = np.clip(np.asarray(interleaved, np.float32), -1.0, 1.0) * np.float32(32767.0)
        half = np.where(scaled >= 0, np.float32(0.5), np.float32(-0.5))
        payload = (scaled + half).astype("<i2").tobytes()  # astype truncates toward 0
    elif subtype == "PCM_24":
        fmt_tag, bits = _FMT_PCM, 24
        clipped = np.clip(interleaved.astype(np.float64), -1.0, 1.0)
        ints = (clipped * 8388607.0).round().astype(np.int32)
        b = np.empty((len(ints), 3), dtype=np.uint8)
        b[:, 0] = ints & 0xFF
        b[:, 1] = (ints >> 8) & 0xFF
        b[:, 2] = (ints >> 16) & 0xFF
        payload = b.tobytes()
    elif subtype in ("FLOAT", "FLOAT_32"):
        fmt_tag, bits = _FMT_IEEE_FLOAT, 32
        payload = interleaved.astype("<f4").tobytes()
    else:
        raise ValueError(f"unsupported subtype: {subtype}")

    byte_rate = samplerate * channels * bits // 8
    block_align = channels * bits // 8
    fmt_chunk = struct.pack(
        "<HHIIHH", fmt_tag, channels, samplerate, byte_rate, block_align, bits
    )
    out = bytearray()
    out += b"RIFF"
    out += struct.pack("<I", 4 + 8 + len(fmt_chunk) + 8 + len(payload))
    out += b"WAVE"
    out += b"fmt " + struct.pack("<I", len(fmt_chunk)) + fmt_chunk
    out += b"data" + struct.pack("<I", len(payload)) + payload
    if len(payload) & 1:
        out += b"\x00"
    p = Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_bytes(bytes(out))


def wav_info(path: PathLike) -> WavInfo:
    """Header-only probe (no sample decode)."""
    data = Path(path).read_bytes()
    fmt = None
    data_size = 0
    for cid, off, size in _parse_chunks(data):
        if cid == b"fmt ":
            fmt_tag, channels, sr, _br, _ba, bits = struct.unpack_from("<HHIIHH", data, off)
            if fmt_tag == _FMT_EXTENSIBLE and size >= 40:
                (sub_tag,) = struct.unpack_from("<H", data, off + 24)
                fmt_tag = sub_tag
            fmt = (fmt_tag, channels, sr, bits)
        elif cid == b"data":
            data_size = size
    if fmt is None:
        raise ValueError("WAV missing fmt chunk")
    fmt_tag, channels, sr, bits = fmt
    frames = data_size // max(1, channels * bits // 8)
    return WavInfo(
        frames=frames,
        channels=channels,
        samplerate=sr,
        sampwidth_bits=bits,
        format="float" if fmt_tag == _FMT_IEEE_FLOAT else "pcm",
    )


def wav_duration_s(path: PathLike) -> float:
    info = wav_info(path)
    return info.frames / info.samplerate if info.samplerate else 0.0


__all__ = ["WavInfo", "read_wav", "write_wav", "wav_info", "wav_duration_s"]
