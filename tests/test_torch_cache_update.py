"""Kernel B5 (in-place KV append): the port against the JAX reference.

The port's CPU path (the plain version of csrc/cache_update.cu) must
write the same bytes as ``cache_append_stacked`` (run as the JAX tests
run it on the CPU, in Pallas interpret mode). Tolerance: none — int8
values and bf16 scale bits are compared exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vocalie_tts_tpu.ops.cache_update import cache_append_stacked as jax_append
from vocalie_tts_tpu_torch.bridge import to_torch
from vocalie_tts_tpu_torch.ops.cache_update import cache_append_stacked


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
