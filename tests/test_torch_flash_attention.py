"""Kernel B6 (flash attention forward): the port's plain version against
``flash_attention`` run in Pallas interpret mode — causal at s=512,
non-causal with ragged ``kv_lens`` at T=320, and GQA, also at the Qwen3
prefill's head width (d 128, group 2, causal at the 512 bucket).

Tolerance: atol 1e-4 in f32 (both sides accumulate the softmax in f32;
only the summation order differs).

Also the kernel's body choice (``flash_body``: the tensor-core body for
bf16 at d 64 and 128, the CUDA-core one otherwise), which the C entry point
makes alike, and that a CPU call counts no launch.
"""

from pathlib import Path


import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vocalie_tts_tpu.ops.flash_attention import flash_attention as jax_flash
from vocalie_tts_tpu_torch.ops.flash_attention import (
    TC_HEAD_DIMS,
    flash_attention,
    flash_attention_lse,
    flash_body,
)


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


@pytest.mark.parametrize("dtype,d,body", [
    (torch.bfloat16, 64, "tc"), (torch.bfloat16, 128, "tc"),
    (torch.bfloat16, 32, "simt"), (torch.bfloat16, 16, "simt"), (torch.bfloat16, 8, "simt"),
    (torch.float32, 128, "simt"), (torch.float32, 64, "simt"), (torch.float32, 32, "simt"),
])
def test_flash_body_by_dtype_and_head_dim(dtype, d, body):
    assert flash_body(dtype, d) == body


def test_c_entry_point_takes_the_same_body():
    """``vt_flash_attention_fwd`` sends bf16 (dtype 1) at exactly the
    tensor-core head dims to the tensor-core launch, so the wrappers'
    ``tc_launches`` count what ran."""
    src = (Path(__file__).resolve().parents[1] / "vocalie_tts_tpu_torch" / "csrc"
           / "flash_attention.cu").read_text()
    entry = src[src.index('extern "C" int vt_flash_attention_fwd'):]
    routes = [line.strip() for line in entry.splitlines() if "tc::launch<" in line]
    assert len(routes) == len(TC_HEAD_DIMS)
    for d in TC_HEAD_DIMS:
        assert f"if (dtype == 1 && d == {d})" in entry
        assert any(r.startswith(f"return tc::launch<{d}>(") for r in routes)


def test_cpu_calls_count_no_launch():
    q, k, v = (torch.from_numpy(t).to(torch.bfloat16) for t in _qkv(1, 1, 2, 2, 16, 16, 64))
    before = (flash_attention.launches, flash_attention.tc_launches,
              flash_attention_lse.launches, flash_attention_lse.tc_launches)
    flash_attention(q, k, v)
    flash_attention_lse(q, k, v)
    assert (flash_attention.launches, flash_attention.tc_launches,
            flash_attention_lse.launches, flash_attention_lse.tc_launches) == before
