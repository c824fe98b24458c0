"""Kernels B5 (in-place KV append with scales) and K5 (one array without
scales): the port against the JAX reference.

The port's CPU path (the plain versions of csrc/cache_update.cu) must
write the same bytes as ``cache_append_stacked`` (run as the JAX tests
run it on the CPU, in Pallas interpret mode): B5 with the split k/v and
their scales, K5 with one stacked array and no scales
(``cache_append_stacked(k, None, kn, None, pos)`` in JAX,
``cache_append_kv_stacked(k, None, kn, None, pos)`` in the port). Both
packages refuse a cache length that is not a multiple of 8. Tolerance:
none — int8 values, bf16 bits and scale bits are compared exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vocalie_tts_tpu.ops.cache_update import cache_append_stacked as jax_append
from vocalie_tts_tpu_torch.bridge import to_torch
from vocalie_tts_tpu_torch.ops.cache_update import (
    cache_append_k_stacked,
    cache_append_kv_stacked,
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
