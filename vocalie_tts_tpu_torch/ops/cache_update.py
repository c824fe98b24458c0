"""In-place decode-step KV-cache append (kernel B5) and its plain version.

Counterpart of ``vocalie_tts_tpu/ops/cache_update.py::cache_append_stacked``
on the split k/v + scales branch. The cache is UPDATED IN PLACE: the
four cache tensors passed in are written at slot ``pos`` and returned.

On a CUDA tensor the wrapper launches ``csrc/cache_update.cu``; on a
CPU tensor it runs :func:`cache_append_plain`. The two write the same
bytes.
"""

from __future__ import annotations

import torch

from vocalie_tts_tpu_torch.ops import _build

_ARGTYPES = [_build.P] * 8 + [_build.LL, _build.I, _build.I, _build.I, _build.P]


def cache_append_plain(k_all, v_all, k_scale, v_scale, k_new, v_new, ks_new, vs_new, pos: int):
    k_all[:, :, :, pos, :] = k_new
    v_all[:, :, :, pos, :] = v_new
    k_scale[:, :, :, pos] = ks_new.to(k_scale.dtype)
    v_scale[:, :, :, pos] = vs_new.to(v_scale.dtype)
    return k_all, v_all, k_scale, v_scale


def cache_append_stacked(
    k_all: torch.Tensor,     # [L, b, kv, T, d] int8 — written in place
    v_all: torch.Tensor,
    k_scale: torch.Tensor,   # [L, b, kv, T] bf16 — written in place
    v_scale: torch.Tensor,
    k_new: torch.Tensor,     # [L, b, kv, d] int8
    v_new: torch.Tensor,
    ks_new: torch.Tensor,    # [L, b, kv] bf16
    vs_new: torch.Tensor,
    pos: int,
):
    """Write one step's k/v and scales at slot ``pos`` of every layer.
    Returns ``(k_all, v_all, k_scale, v_scale)`` (the same tensors)."""
    L, b, kv, T, d = k_all.shape
    if not 0 <= int(pos) < T:
        raise ValueError(f"write position {pos} outside the cache length {T}")
    if k_all.device.type == "cpu":
        return cache_append_plain(
            k_all, v_all, k_scale, v_scale, k_new, v_new, ks_new, vs_new, int(pos)
        )
    if k_all.device.type != "cuda":
        raise ValueError(f"unsupported device {k_all.device}")
    for name, t, dtype, shape in (
        ("k_all", k_all, torch.int8, (L, b, kv, T, d)),
        ("v_all", v_all, torch.int8, (L, b, kv, T, d)),
        ("k_scale", k_scale, torch.bfloat16, (L, b, kv, T)),
        ("v_scale", v_scale, torch.bfloat16, (L, b, kv, T)),
        ("k_new", k_new, torch.int8, (L, b, kv, d)),
        ("v_new", v_new, torch.int8, (L, b, kv, d)),
        ("ks_new", ks_new, torch.bfloat16, (L, b, kv)),
        ("vs_new", vs_new, torch.bfloat16, (L, b, kv)),
    ):
        if t.device != k_all.device or t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(
                f"{name}: expected {dtype} {shape} on {k_all.device}, got "
                f"{t.dtype} {tuple(t.shape)} on {t.device}"
            )
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    fn = _build.kernel("vt_cache_append", _ARGTYPES)
    cache_append_stacked.launches += 1
    rc = fn(
        k_all.data_ptr(), v_all.data_ptr(), k_scale.data_ptr(), v_scale.data_ptr(),
        k_new.data_ptr(), v_new.data_ptr(), ks_new.data_ptr(), vs_new.data_ptr(),
        L * b * kv, T, d, int(pos), _build.stream_ptr(k_all),
    )
    _build.check(rc, "vt_cache_append")
    return k_all, v_all, k_scale, v_scale


#: launches of the CUDA kernel (the plain version is not counted)
cache_append_stacked.launches = 0

__all__ = ["cache_append_stacked", "cache_append_plain"]
