"""Kernel B6 (flash attention forward): the port's plain version against
``flash_attention`` run in Pallas interpret mode — causal at s=512,
non-causal with ragged ``kv_lens`` at T=320, and GQA, also at the Qwen3
prefill's head width (d 128, group 2, causal at the 512 bucket).

Tolerance: atol 1e-4 in f32 (both sides accumulate the softmax in f32;
only the summation order differs).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vocalie_tts_tpu.ops.flash_attention import flash_attention as jax_flash
from vocalie_tts_tpu_torch.ops.flash_attention import flash_attention


def _qkv(seed, b, h, hk, s_q, s_k, d):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, h, s_q, d)).astype(np.float32),
            rng.standard_normal((b, hk, s_k, d)).astype(np.float32),
            rng.standard_normal((b, hk, s_k, d)).astype(np.float32))


@pytest.mark.parametrize("name,b,h,hk,s,d,causal,lens", [
    ("causal_512", 1, 2, 2, 512, 64, True, None),
    ("ragged_kv_lens_320", 3, 2, 2, 320, 64, False, (320, 200, 17)),
    ("gqa_causal", 2, 4, 2, 128, 32, True, None),
    ("gqa_kv_lens", 2, 4, 1, 256, 16, False, (256, 100)),
    ("gqa_d128_causal_512", 1, 4, 2, 512, 128, True, None),
])
def test_flash_attention_matches_jax(name, b, h, hk, s, d, causal, lens):
    q, k, v = _qkv(s + h, b, h, hk, s, s, d)
    kv_lens = None if lens is None else np.asarray(lens, np.int32)
    ref = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
                    kv_lens=None if kv_lens is None else jnp.asarray(kv_lens))
    out = flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                          causal=causal,
                          kv_lens=None if kv_lens is None else torch.from_numpy(kv_lens))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4, rtol=0)


def test_flash_attention_fully_masked_row_is_zero():
    q, k, v = _qkv(0, 2, 2, 2, 8, 8, 16)
    out = flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                          causal=False, kv_lens=torch.tensor([8, 0], dtype=torch.int32))
    assert torch.all(out[1] == 0) and torch.all(torch.isfinite(out))
