"""In-place decode-step KV-cache append and its plain versions: the int8
cache with its scales (kernel B5), a cache without scales (K4), and one
array without scales (K5).

Counterpart of ``vocalie_tts_tpu/ops/cache_update.py::cache_append_stacked``:
the split branch with scales (``_write_kv_scales_kernel``, B5:
:func:`cache_append_stacked`), the split branch without (``_write_kv_kernel``,
K4, the bf16 or f32 cache: :func:`cache_append_kv_stacked`), and the
one-array branch without scales (``_write_k_kernel``, K5:
``cache_append_kv_stacked(k_all, None, k_new, None, pos)``, JAX's argument
order for that call, or :func:`cache_append_k_stacked`). The port's caches
stay split, so only that API reaches K5; JAX's one-array branch with scales
is not copied. The cache length must be a multiple of 8, as JAX requires.
The cache is UPDATED IN PLACE: the cache tensors passed in are written at
slot ``pos`` and returned.

On a CUDA tensor each wrapper launches ``csrc/cache_update.cu``; on a CPU
tensor it runs its plain version. The two write the same bytes.
"""

from __future__ import annotations

from typing import Optional

import torch

from vocalie_tts_tpu_torch.ops import _build

_ARGTYPES = [_build.P] * 8 + [_build.LL, _build.I, _build.I, _build.I, _build.P]


def _check_slot(T: int, pos: int) -> None:
    if T % 8:
        raise ValueError(f"cache length {T} must be a multiple of 8")
    if not 0 <= int(pos) < T:
        raise ValueError(f"write position {pos} outside the cache length {T}")


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
    _check_slot(T, pos)
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


_KV_ARGTYPES = [_build.P] * 4 + [_build.LL, _build.I, _build.I, _build.I, _build.I, _build.P]


def cache_append_kv_plain(k_all, v_all, k_new, v_new, pos: int):
    k_all[:, :, :, pos, :] = k_new
    v_all[:, :, :, pos, :] = v_new
    return k_all, v_all


def cache_append_k_plain(k_all, k_new, pos: int):
    k_all[:, :, :, pos, :] = k_new
    return k_all


def append_word(row_bytes: int, *ptrs: int) -> int:
    """The word K4/K5 copy a row in: 16 bytes where the row's bytes are a
    multiple of 16 and every pointer is 16-byte aligned, else 4 on the same
    terms, else 1 (``vt_cache_append_kv`` refuses a word the row or a
    pointer does not take)."""
    for word in (16, 4):
        if row_bytes % word == 0 and all(p % word == 0 for p in ptrs):
            return word
    return 1


def _launch_kv(wrapper, k_all, v_all, k_new, v_new, pos: int) -> None:
    """Check the arrays of K4 (k and v) or K5 (``v_all`` None) and launch the
    kernel, counting the launch on ``wrapper``."""
    dev, dtype, shape = k_all.device, k_all.dtype, k_all.shape
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    new_shape = shape[:3] + shape[4:]
    arrays = (k_all, k_new) if v_all is None else (k_all, k_new, v_all, v_new)
    for name, t, want in zip(("k_all", "k_new", "v_all", "v_new"), arrays,
                             (shape, new_shape, shape, new_shape)):
        if t.shape != want or t.dtype != dtype or t.device != dev or not t.is_contiguous():
            raise ValueError(
                f"{name}: expected contiguous {dtype} {tuple(want)} on {dev}, got "
                f"{t.dtype} {tuple(t.shape)} on {t.device}"
                + ("" if t.is_contiguous() else " (not contiguous)"))
    ptrs = [t.data_ptr() for t in arrays]
    row_bytes = shape[4] * k_all.element_size()
    wrapper.launches += 1
    rc = _build.kernel("vt_cache_append_kv", _KV_ARGTYPES)(
        ptrs[0], None if v_all is None else ptrs[2], ptrs[1], None if v_all is None else ptrs[3],
        shape[0] * shape[1] * shape[2], shape[3], row_bytes, int(pos),
        append_word(row_bytes, *ptrs), _build.stream_ptr(k_all))
    _build.check(rc, "vt_cache_append_kv")


def cache_append_k_stacked(
    k_all: torch.Tensor,     # [L, b, kv, T, D] any dtype — written in place
    k_new: torch.Tensor,     # [L, b, kv, D] the cache's dtype
    pos: int,
) -> torch.Tensor:
    """K5: write one step's rows at slot ``pos`` of every layer of ONE
    stacked array without scales (JAX's one-array branch). Returns
    ``k_all`` (the same tensor)."""
    _check_slot(k_all.shape[3], pos)
    if k_all.device.type == "cpu":
        return cache_append_k_plain(k_all, k_new, int(pos))
    _launch_kv(cache_append_k_stacked, k_all, None, k_new, None, pos)
    return k_all


def cache_append_kv_stacked(
    k_all: torch.Tensor,     # [L, b, kv, T, d] bf16 or f32 — written in place
    v_all: Optional[torch.Tensor],   # None: one array (K5)
    k_new: torch.Tensor,     # [L, b, kv, d] the cache's dtype
    v_new: Optional[torch.Tensor],
    pos: int,
):
    """K4: write one step's k/v at slot ``pos`` of every layer of a cache
    without scales. Returns ``(k_all, v_all)`` (the same tensors); with
    ``v_all`` and ``v_new`` None, K5 on ``k_all`` alone, returning it, as
    JAX's ``cache_append_stacked(k, None, k_new, None, pos)``."""
    if v_all is None or v_new is None:
        if v_all is not None or v_new is not None:
            raise ValueError("one-array append: v_all and v_new are both None")
        return cache_append_k_stacked(k_all, k_new, pos)
    _check_slot(k_all.shape[3], pos)
    if k_all.device.type == "cpu":
        return cache_append_kv_plain(k_all, v_all, k_new, v_new, int(pos))
    if k_all.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"k_all: expected a bf16 or f32 cache, got {k_all.dtype}")
    _launch_kv(cache_append_kv_stacked, k_all, v_all, k_new, v_new, pos)
    return k_all, v_all


#: launches of the CUDA kernels (the plain versions are not counted)
cache_append_stacked.launches = 0
cache_append_kv_stacked.launches = 0
cache_append_k_stacked.launches = 0

__all__ = ["cache_append_stacked", "cache_append_plain", "cache_append_kv_stacked",
           "cache_append_kv_plain", "cache_append_k_stacked", "cache_append_k_plain",
           "append_word"]
