"""Kernels B5 (in-place KV append with scales), K6 (one array with scales)
and K5 (one array without scales): the port against the JAX reference.

The port's CPU path (the plain versions of csrc/cache_update.cu) must
write the same bytes as ``cache_append_stacked`` (run as the JAX tests
run it on the CPU, in Pallas interpret mode): B5 with the split k/v and
their scales, K5 with one stacked array and no scales
(``cache_append_stacked(k, None, kn, None, pos)`` in JAX,
``cache_append_kv_stacked(k, None, kn, None, pos)`` in the port), K6 with
one int8 array and the two scale rows through JAX's argument order
(``cache_append_kv_stacked(k, None, kn, None, pos, ks, vs, ksn, vsn)``, as
B5 with v). Both packages refuse a cache length that is not a multiple of 8
and a scale append missing a scale array. The CUDA body's mapping (the
grid-stride walk over the rows' words, each word's row and destination, and
the scales written by the thread of a row's word 0) is emulated in numpy
and held to the plain versions' bytes. Tolerance: none — int8 values, bf16
bits and scale bits are compared exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vocalie_tts_tpu.ops.cache_update import cache_append_stacked as jax_append
from vocalie_tts_tpu_torch.bridge import to_torch
from vocalie_tts_tpu_torch.ops.cache_update import (
    append_word,
    cache_append_k_scales_plain,
    cache_append_k_scales_stacked,
    cache_append_k_stacked,
    cache_append_kv_stacked,
    cache_append_plain,
    cache_append_stacked,
)


def _bf16(rng, shape):
    return jnp.asarray(rng.random(shape, dtype=np.float32) * 0.02 + 1e-3, jnp.bfloat16)


@pytest.mark.parametrize("pos", [0, 77, 255])
def test_cache_append_is_byte_exact(pos):
    rng = np.random.default_rng(pos)
    L, b, kv, T, d = 3, 2, 2, 256, 16
    k = rng.integers(-127, 128, (L, b, kv, T, d), dtype=np.int8)
    v = rng.integers(-127, 128, (L, b, kv, T, d), dtype=np.int8)
    ks, vs = _bf16(rng, (L, b, kv, T)), _bf16(rng, (L, b, kv, T))
    kn = rng.integers(-127, 128, (L, b, kv, d), dtype=np.int8)
    vn = rng.integers(-127, 128, (L, b, kv, d), dtype=np.int8)
    ksn, vsn = _bf16(rng, (L, b, kv)), _bf16(rng, (L, b, kv))

    ref = jax_append(jnp.asarray(k), jnp.asarray(v), jnp.asarray(kn), jnp.asarray(vn),
                     jnp.asarray(pos, jnp.int32), k_scale=ks, v_scale=vs,
                     ks_new=ksn, vs_new=vsn)
    ref = [np.asarray(r) for r in ref]

    t = [to_torch(np.asarray(a)) for a in (k, v, ks, vs, kn, vn, ksn, vsn)]
    out = cache_append_stacked(*t, pos)
    assert all(o is i for o, i in zip(out, t[:4])), "the cache must be updated in place"
    assert np.array_equal(out[0].numpy(), ref[0])
    assert np.array_equal(out[1].numpy(), ref[1])
    for o, r in zip(out[2:], ref[2:]):
        assert np.array_equal(o.view(torch.int16).numpy(), r.view(np.int16))


def test_cache_append_rejects_out_of_range_position():
    k = torch.zeros((1, 1, 1, 128, 16), dtype=torch.int8)
    s = torch.zeros((1, 1, 1, 128), dtype=torch.bfloat16)
    kn = torch.zeros((1, 1, 1, 16), dtype=torch.int8)
    sn = torch.zeros((1, 1, 1), dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        cache_append_stacked(k, k.clone(), s, s.clone(), kn, kn, sn, sn, 128)


@pytest.mark.parametrize("dtype,pos", [("int8", 0), ("int8", 131), ("bfloat16", 77)])
def test_one_array_append_is_byte_exact(dtype, pos):
    """K5: JAX's one-array branch without scales (``_write_k_kernel``) on a
    [L, b, kv, T, 2d] array (the lane-packed k|v layout)."""
    rng = np.random.default_rng(pos + 3)
    L, b, kv, T, D = 2, 2, 2, 136, 32
    if dtype == "int8":
        k = rng.integers(-127, 128, (L, b, kv, T, D), dtype=np.int8)
        kn = rng.integers(-127, 128, (L, b, kv, D), dtype=np.int8)
    else:
        k = np.asarray(jnp.asarray(rng.standard_normal((L, b, kv, T, D)), jnp.bfloat16))
        kn = np.asarray(jnp.asarray(rng.standard_normal((L, b, kv, D)), jnp.bfloat16))
    ref = np.asarray(jax_append(jnp.asarray(k), None, jnp.asarray(kn), None,
                                jnp.asarray(pos, jnp.int32)))
    tk = to_torch(np.asarray(k))
    out = cache_append_kv_stacked(tk, None, to_torch(np.asarray(kn)), None, pos)
    assert out is tk, "the cache must be updated in place"
    view = (lambda a: a.view(np.int16)) if dtype == "bfloat16" else (lambda a: a)
    got = out.view(torch.int16).numpy() if dtype == "bfloat16" else out.numpy()
    assert np.array_equal(got, view(ref))
    assert cache_append_k_stacked(tk.clone(), to_torch(np.asarray(kn)), pos).equal(out)


@pytest.mark.parametrize("which", ["scales", "kv", "one_array"])
def test_cache_length_not_a_multiple_of_8_is_refused(which):
    """JAX's ``cache_append_stacked`` raises for a cache length that is not
    a multiple of 8 (``ops/cache_update.py:108-109``); so do the port's
    append wrappers, B5's, K4's and K5's."""
    T = 100
    k8 = np.zeros((1, 1, 1, T, 16), np.int8)
    kn8 = np.zeros((1, 1, 1, 16), np.int8)
    with pytest.raises(ValueError, match="multiple of 8"):
        jax_append(jnp.asarray(k8), None, jnp.asarray(kn8), None, jnp.asarray(3, jnp.int32))
    with pytest.raises(ValueError, match="multiple of 8"):
        if which == "scales":
            k = torch.zeros((1, 1, 1, T, 16), dtype=torch.int8)
            s = torch.zeros((1, 1, 1, T), dtype=torch.bfloat16)
            kn = torch.zeros((1, 1, 1, 16), dtype=torch.int8)
            sn = torch.zeros((1, 1, 1), dtype=torch.bfloat16)
            cache_append_stacked(k, k.clone(), s, s.clone(), kn, kn, sn, sn, 3)
        elif which == "kv":
            k = torch.zeros((1, 1, 1, T, 16), dtype=torch.bfloat16)
            kn = torch.zeros((1, 1, 1, 16), dtype=torch.bfloat16)
            cache_append_kv_stacked(k, k.clone(), kn, kn, 3)
        else:
            cache_append_kv_stacked(to_torch(k8), None, to_torch(kn8), None, 3)


def _emulate_kernel(caches, scales, news, new_scales, pos, word, sms=132, threads=256):
    """``cache_append_kernel``'s walk in numpy: a grid of at most 4 blocks an
    SM strides over the rows' words; word i is row r = i // per_row, word e
    of it, written at (r * T + pos) * per_row + e of each cache (k, and v
    where given), and the thread of word 0 writes row r's k and v scales at
    r * T + pos. Every word is visited once."""
    L, b, kv, T, d = caches[0].shape
    rows, per_row = L * b * kv, d // word
    total = rows * per_row
    grid = min(-(-total // threads), 4 * sms)
    i = np.concatenate([np.arange(t, total, grid * threads) for t in range(grid * threads)])
    assert np.array_equal(np.sort(i), np.arange(total))   # each word once
    r, e = i // per_row, i % per_row
    dst = (r * T + pos) * per_row + e
    for cache, new in zip(caches, news):
        words = cache.reshape(-1, word)       # views of the caches' bytes
        words[dst] = new.reshape(-1, word)[i]
    first = e == 0
    for scale, new in zip(scales, new_scales):
        scale.reshape(-1)[r[first] * T + pos] = new.reshape(-1)[r[first]]


@pytest.mark.parametrize("one_array", [False, True], ids=["B5", "K6"])
@pytest.mark.parametrize("pos_at", ["0", "7", "T-1"])
@pytest.mark.parametrize("d", [8, 64, 128])
def test_kernel_word_and_scale_mapping_is_byte_exact(d, pos_at, one_array):
    """The CUDA body's words (16 bytes for the int8 rows of d 64 and 128, 4
    for d 8, as ``append_word`` picks them) and scales, emulated, write the
    plain versions' bytes at the first, an inner and the last slot."""
    rng = np.random.default_rng(d + len(pos_at))
    L, b, kv, T = 3, 2, 3, 24
    pos = {"0": 0, "7": 7, "T-1": T - 1}[pos_at]
    word = append_word(d, 0, 0)
    assert word == (4 if d == 8 else 16)
    k, v = (rng.integers(-127, 128, (L, b, kv, T, d), dtype=np.int8) for _ in range(2))
    ks, vs = (rng.integers(0, 1 << 15, (L, b, kv, T), dtype=np.uint16) for _ in range(2))
    kn, vn = (rng.integers(-127, 128, (L, b, kv, d), dtype=np.int8) for _ in range(2))
    ksn, vsn = (rng.integers(0, 1 << 15, (L, b, kv), dtype=np.uint16) for _ in range(2))
    caches = [k.view(np.uint8).copy()] + ([] if one_array else [v.view(np.uint8).copy()])
    news = [kn.view(np.uint8)] + ([] if one_array else [vn.view(np.uint8)])
    scales = [ks.copy(), vs.copy()]
    _emulate_kernel(caches, scales, news, [ksn, vsn], pos, word)
    t = {n: torch.from_numpy(a.copy()) for n, a in dict(k=k, v=v, kn=kn, vn=vn).items()}
    s = {n: torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16) for n, a in
         dict(ks=ks, vs=vs, ksn=ksn, vsn=vsn).items()}
    if one_array:
        ref = cache_append_k_scales_plain(t["k"], s["ks"], s["vs"], t["kn"], s["ksn"], s["vsn"],
                                          pos)
        ref_k, ref_scales = [ref[0]], ref[1:]
    else:
        ref = cache_append_plain(t["k"], t["v"], s["ks"], s["vs"], t["kn"], t["vn"], s["ksn"],
                                 s["vsn"], pos)
        ref_k, ref_scales = ref[:2], ref[2:]
    for got, want in zip(caches, ref_k):
        assert np.array_equal(got.view(np.int8), want.numpy())
    for got, want in zip(scales, ref_scales):
        assert np.array_equal(got.view(np.int16), want.view(torch.int16).numpy())


@pytest.mark.parametrize("one_array", [True, False], ids=["K6", "B5"])
@pytest.mark.parametrize("pos", [0, 131])
def test_jax_order_append_with_scales_is_byte_exact(pos, one_array):
    """K6, JAX's one-array branch with scales (``_write_k_scales_kernel``),
    and B5 through JAX's argument order: ``cache_append_kv_stacked(k, v or
    None, kn, vn or None, pos, ks, vs, ksn, vsn)`` returns what JAX returns,
    the same tensors, byte for byte (a [L, b, kv, T, 2d] int8 array: the
    lane-packed k|v)."""
    rng = np.random.default_rng(pos + 5)
    L, b, kv, T, D = 2, 2, 2, 136, 32
    k, v = (rng.integers(-127, 128, (L, b, kv, T, D), dtype=np.int8) for _ in range(2))
    kn, vn = (rng.integers(-127, 128, (L, b, kv, D), dtype=np.int8) for _ in range(2))
    ks, vs = _bf16(rng, (L, b, kv, T)), _bf16(rng, (L, b, kv, T))
    ksn, vsn = _bf16(rng, (L, b, kv)), _bf16(rng, (L, b, kv))
    vj, vnj = (None, None) if one_array else (jnp.asarray(v), jnp.asarray(vn))
    ref = jax_append(jnp.asarray(k), vj, jnp.asarray(kn), vnj, jnp.asarray(pos, jnp.int32),
                     k_scale=ks, v_scale=vs, ks_new=ksn, vs_new=vsn)
    ref = [np.asarray(r) for r in ref]
    tk, tks, tvs = (to_torch(np.asarray(a)) for a in (k, ks, vs))
    tv, tvn = (None, None) if one_array else (to_torch(v), to_torch(vn))
    out = cache_append_kv_stacked(tk, tv, to_torch(kn), tvn, pos, tks, tvs,
                                  to_torch(np.asarray(ksn)), to_torch(np.asarray(vsn)))
    cache = [tk] if one_array else [tk, tv]
    assert len(out) == len(ref) and all(o is i for o, i in zip(out, cache + [tks, tvs]))
    for o, r in zip(out, ref):
        if o.dtype == torch.int8:
            assert np.array_equal(o.numpy(), r)
        else:
            assert np.array_equal(o.view(torch.int16).numpy(), r.view(np.int16))
    if one_array:
        again = cache_append_k_scales_stacked(
            to_torch(k), to_torch(np.asarray(ks)), to_torch(np.asarray(vs)), to_torch(kn),
            to_torch(np.asarray(ksn)), to_torch(np.asarray(vsn)), pos)
        assert all(a.equal(o) for a, o in zip(again, out))


def test_scale_append_needs_every_scale_array():
    """A scale append given some of its four scale arrays is refused by both
    packages (JAX ``ops/cache_update.py:112-113``)."""
    k = np.zeros((1, 1, 1, 8, 16), np.int8)
    kn = np.zeros((1, 1, 1, 16), np.int8)
    s = jnp.zeros((1, 1, 1, 8), jnp.bfloat16)
    with pytest.raises(ValueError, match="scale append needs"):
        jax_append(jnp.asarray(k), None, jnp.asarray(kn), None, jnp.asarray(3, jnp.int32),
                   k_scale=s)
    with pytest.raises(ValueError, match="scale append needs"):
        cache_append_kv_stacked(to_torch(k), None, to_torch(kn), None, 3,
                                torch.zeros((1, 1, 1, 8), dtype=torch.bfloat16))
