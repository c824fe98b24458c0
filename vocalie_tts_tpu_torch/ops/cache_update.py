"""In-place decode-step KV-cache append and its plain versions: the int8
cache with its scales (kernel B5), one int8 array with its scales (K6), a
cache without scales (K4), and one array without scales (K5).

Counterpart of ``vocalie_tts_tpu/ops/cache_update.py::cache_append_stacked``,
each of its four branches: split with scales (``_write_kv_scales_kernel``,
B5: :func:`cache_append_stacked`), one array with scales
(``_write_k_scales_kernel``, K6: :func:`cache_append_k_scales_stacked`),
split without (``_write_kv_kernel``, K4, the bf16 or f32 cache) and one
array without (``_write_k_kernel``, K5: :func:`cache_append_k_stacked`).
:func:`cache_append_kv_stacked` takes JAX's argument order and returns
what it returns in every branch (``cache_append_kv_stacked(k, None, kn,
None, pos, ks, vs, ksn, vsn)`` is K6). The port's caches stay split, so
only that API reaches K5 and K6. The cache length must be a multiple of 8,
as JAX requires. The cache is UPDATED IN PLACE: the cache tensors passed in
are written at slot ``pos`` and returned.

On a CUDA tensor each wrapper launches the one kernel body of
``csrc/cache_update.cu``; on a CPU tensor it runs its plain version. The two
write the same bytes.
"""

from __future__ import annotations

from typing import Optional

import torch

from vocalie_tts_tpu_torch.ops import _build

_ARGTYPES = [_build.P] * 8 + [_build.LL, _build.I, _build.I, _build.I, _build.I, _build.P]
_KV_ARGTYPES = [_build.P] * 4 + [_build.LL, _build.I, _build.I, _build.I, _build.I, _build.P]


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


def cache_append_k_scales_plain(k_all, k_scale, v_scale, k_new, ks_new, vs_new, pos: int):
    k_all[:, :, :, pos, :] = k_new
    k_scale[:, :, :, pos] = ks_new.to(k_scale.dtype)
    v_scale[:, :, :, pos] = vs_new.to(v_scale.dtype)
    return k_all, k_scale, v_scale


def cache_append_kv_plain(k_all, v_all, k_new, v_new, pos: int):
    k_all[:, :, :, pos, :] = k_new
    v_all[:, :, :, pos, :] = v_new
    return k_all, v_all


def cache_append_k_plain(k_all, k_new, pos: int):
    k_all[:, :, :, pos, :] = k_new
    return k_all


def append_word(row_bytes: int, *ptrs: int) -> int:
    """The word a row is copied in: 16 bytes where the row's bytes are a
    multiple of 16 and every pointer is 16-byte aligned, else 4 on the same
    terms, else 1 (the C entries refuse a word the row or a pointer does not
    take)."""
    for word in (16, 4):
        if row_bytes % word == 0 and all(p % word == 0 for p in ptrs):
            return word
    return 1


def _launch(wrapper, k_all, v_all, k_new, v_new, pos: int, scales=None) -> None:
    """Check the arrays of B5 or K4 (k and v) or of K6 or K5 (``v_all``
    None), with ``scales`` = (k_scale, v_scale, ks_new, vs_new) for B5 and
    K6 (an int8 cache, bf16 scales), and launch the kernel, counting the
    launch on ``wrapper``."""
    dev, dtype, shape = k_all.device, k_all.dtype, k_all.shape
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    new_shape = shape[:3] + shape[4:]
    specs = [("k_all", k_all, dtype, shape), ("k_new", k_new, dtype, new_shape)]
    if v_all is not None:
        specs += [("v_all", v_all, dtype, shape), ("v_new", v_new, dtype, new_shape)]
    if scales is not None:
        if dtype != torch.int8:
            raise ValueError(f"k_all: expected an int8 cache with scales, got {dtype}")
        specs += [(name, t, torch.bfloat16, want) for name, t, want in zip(
            ("k_scale", "v_scale", "ks_new", "vs_new"), scales,
            (shape[:4], shape[:4], shape[:3], shape[:3]))]
    for name, t, want_dtype, want in specs:
        if (t.shape != want or t.dtype != want_dtype or t.device != dev
                or not t.is_contiguous()):
            raise ValueError(
                f"{name}: expected contiguous {want_dtype} {tuple(want)} on {dev}, got "
                f"{t.dtype} {tuple(t.shape)} on {t.device}"
                + ("" if t.is_contiguous() else " (not contiguous)"))
    rows_ptrs = [k_all.data_ptr(), k_new.data_ptr()]
    v_ptrs = [None, None] if v_all is None else [v_all.data_ptr(), v_new.data_ptr()]
    row_bytes = shape[4] * k_all.element_size()
    word = append_word(row_bytes, *rows_ptrs, *(p for p in v_ptrs if p is not None))
    head = (shape[0] * shape[1] * shape[2], shape[3], row_bytes, int(pos), word,
            _build.stream_ptr(k_all))
    wrapper.launches += 1
    if scales is None:
        rc = _build.kernel("vt_cache_append_kv", _KV_ARGTYPES)(
            rows_ptrs[0], v_ptrs[0], rows_ptrs[1], v_ptrs[1], *head)
        _build.check(rc, "vt_cache_append_kv")
        return
    ks, vs, ksn, vsn = (t.data_ptr() for t in scales)
    rc = _build.kernel("vt_cache_append", _ARGTYPES)(
        rows_ptrs[0], v_ptrs[0], ks, vs, rows_ptrs[1], v_ptrs[1], ksn, vsn, *head)
    _build.check(rc, "vt_cache_append")


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
    """B5: write one step's k/v and scales at slot ``pos`` of every layer.
    Returns ``(k_all, v_all, k_scale, v_scale)`` (the same tensors)."""
    _check_slot(k_all.shape[3], pos)
    if k_all.device.type == "cpu":
        return cache_append_plain(
            k_all, v_all, k_scale, v_scale, k_new, v_new, ks_new, vs_new, int(pos)
        )
    _launch(cache_append_stacked, k_all, v_all, k_new, v_new, pos,
            (k_scale, v_scale, ks_new, vs_new))
    return k_all, v_all, k_scale, v_scale


def cache_append_k_scales_stacked(
    k_all: torch.Tensor,     # [L, b, kv, T, D] int8 (the lane-packed k|v) — written in place
    k_scale: torch.Tensor,   # [L, b, kv, T] bf16 — written in place
    v_scale: torch.Tensor,
    k_new: torch.Tensor,     # [L, b, kv, D] int8
    ks_new: torch.Tensor,    # [L, b, kv] bf16
    vs_new: torch.Tensor,
    pos: int,
):
    """K6: write one step's rows of ONE stacked int8 array and its two scale
    rows at slot ``pos`` of every layer (JAX's one-array branch with
    scales). Returns ``(k_all, k_scale, v_scale)`` (the same tensors)."""
    _check_slot(k_all.shape[3], pos)
    if k_all.device.type == "cpu":
        return cache_append_k_scales_plain(k_all, k_scale, v_scale, k_new, ks_new, vs_new,
                                           int(pos))
    _launch(cache_append_k_scales_stacked, k_all, None, k_new, None, pos,
            (k_scale, v_scale, ks_new, vs_new))
    return k_all, k_scale, v_scale


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
    _launch(cache_append_k_stacked, k_all, None, k_new, None, pos)
    return k_all


def cache_append_kv_stacked(
    k_all: torch.Tensor,     # [L, b, kv, T, d] — written in place
    v_all: Optional[torch.Tensor],   # None: one array
    k_new: torch.Tensor,     # [L, b, kv, d] the cache's dtype
    v_new: Optional[torch.Tensor],
    pos: int,
    k_scale: Optional[torch.Tensor] = None,   # [L, b, kv, T] — written in place
    v_scale: Optional[torch.Tensor] = None,
    ks_new: Optional[torch.Tensor] = None,    # [L, b, kv]
    vs_new: Optional[torch.Tensor] = None,
):
    """JAX's ``cache_append_stacked`` signature and returns: split without
    scales, K4 (a bf16 or f32 cache) → ``(k_all, v_all)``; one array without
    scales, K5 → ``k_all``; split with scales, B5 → ``(k_all, v_all,
    k_scale, v_scale)``; one array with scales, K6 → ``(k_all, k_scale,
    v_scale)`` (the same tensors, written at slot ``pos``)."""
    single = v_all is None or v_new is None
    if single and (v_all is not None or v_new is not None):
        raise ValueError("one-array append: v_all and v_new are both None")
    scales = (k_scale, v_scale, ks_new, vs_new)
    if any(t is not None for t in scales):
        if any(t is None for t in scales):
            raise ValueError("scale append needs k_scale, v_scale, ks_new, vs_new")
        if single:
            return cache_append_k_scales_stacked(k_all, k_scale, v_scale, k_new, ks_new,
                                                 vs_new, pos)
        return cache_append_stacked(k_all, v_all, k_scale, v_scale, k_new, v_new, ks_new,
                                    vs_new, pos)
    if single:
        return cache_append_k_stacked(k_all, k_new, pos)
    _check_slot(k_all.shape[3], pos)
    if k_all.device.type == "cpu":
        return cache_append_kv_plain(k_all, v_all, k_new, v_new, int(pos))
    if k_all.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"k_all: expected a bf16 or f32 cache, got {k_all.dtype}")
    _launch(cache_append_kv_stacked, k_all, v_all, k_new, v_new, pos)
    return k_all, v_all


#: launches of the CUDA kernel, by entry (the plain versions are not counted)
cache_append_stacked.launches = 0
cache_append_k_scales_stacked.launches = 0
cache_append_kv_stacked.launches = 0
cache_append_k_stacked.launches = 0

__all__ = ["cache_append_stacked", "cache_append_plain", "cache_append_k_scales_stacked",
           "cache_append_k_scales_plain", "cache_append_kv_stacked", "cache_append_kv_plain",
           "cache_append_k_stacked", "cache_append_k_plain", "append_word"]
