"""Kernel B13 (fused GroupNorm): the port's plain version against the JAX
package's ``group_norm_fused`` (Pallas interpret mode where C % 128 == 0,
its ``_gn_xla`` branch otherwise, as the JAX wrapper picks on the CPU), and
``group_norm`` / ``_norm_act`` of both packages, f32 and bf16, with
``VOCALIE_GN_PALLAS`` set and unset.

Tolerances. bf16 outputs: one bf16 ulp of the reference value plus 1e-5
(both sides form the moments in f32 in another summation order and round
the f32 result once; near zero, where ``x·scale`` cancels ``bias``, the
f32 difference shows at ~1e-7 of the operands). The bf16 ``group_norm``
path applies in bf16 op by op, where XLA on the CPU may keep f32 between
ops: two ulps there. f32 ``group_norm``: 1e-5 absolute on unit-scale
outputs (summation order only).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vocalie_tts_tpu.models.common import unet2d as junet
from vocalie_tts_tpu.ops.groupnorm import group_norm_fused as jax_group_norm_fused
from vocalie_tts_tpu_torch.models.common import unet2d as tunet
from vocalie_tts_tpu_torch.ops.groupnorm import group_norm_fused


def _bf16_np(t) -> np.ndarray:
    return np.asarray(t.float().numpy() if isinstance(t, torch.Tensor) else
                      np.asarray(t, np.float32), np.float32)


def _ulp(v: np.ndarray) -> np.ndarray:
    """The bf16 spacing at |v| (8 significant bits)."""
    a = np.maximum(np.abs(v), np.float32(2.0 ** -126))
    return np.exp2(np.floor(np.log2(a)) - 7).astype(np.float32)


def assert_bf16_close(got, want, ulps: int = 1, atol: float = 1e-5):
    got, want = _bf16_np(got), _bf16_np(want)
    assert got.shape == want.shape
    excess = np.abs(got - want) - (ulps * _ulp(want) + atol)
    assert excess.max() <= 0, f"worst excess {excess.max():.3e} at {np.unravel_index(excess.argmax(), excess.shape)}"


def _inputs(shape, seed, *, pre_add):
    rng = np.random.RandomState(seed)
    c = shape[-1]
    x = rng.randn(*shape).astype(np.float32) * 2.0 + 0.5
    g = (1.0 + 0.2 * rng.randn(c)).astype(np.float32)
    b = (0.1 * rng.randn(c)).astype(np.float32)
    e = (0.3 * rng.randn(shape[0], c)).astype(np.float32) if pre_add else None
    # both sides see the same bf16 values
    x = np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    if e is not None:
        e = np.array(jnp.asarray(e, jnp.bfloat16).astype(jnp.float32))
    return x, g, b, e


def _bf16(a):
    return None if a is None else torch.from_numpy(a).to(torch.bfloat16)


@pytest.mark.parametrize("silu", [False, True])
@pytest.mark.parametrize("pre_add", [False, True])
@pytest.mark.parametrize("shape,groups,eps", [
    ((4, 5, 8, 128), 32, 1e-5),     # UNet level shape (non-pow2 spatial): interpret mode
    ((2, 16, 256), 32, 1e-5),       # pre-flattened 3D: interpret mode
    ((8, 3, 3, 16), 4, 1e-5),       # tiny scale: _gn_xla
    ((2, 8, 16, 64), 32, 1e-6),     # VAE level 0 (C/G = 2) at the VAE's eps: _gn_xla
    ((3, 4, 4, 96), 32, 1e-5),      # C/G = 3, not a power of two: _gn_xla
])
def test_plain_matches_jax_group_norm_fused(shape, groups, eps, silu, pre_add):
    x, g, b, e = _inputs(shape, 3, pre_add=pre_add)
    want = jax_group_norm_fused(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(g), jnp.asarray(b), groups=groups, eps=eps,
        silu=silu, pre_add=None if e is None else jnp.asarray(e, jnp.bfloat16))
    got = group_norm_fused(_bf16(x), torch.from_numpy(g), torch.from_numpy(b), groups=groups,
                           eps=eps, silu=silu, pre_add=_bf16(e))
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == shape
    assert_bf16_close(got, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,groups", [((2, 4, 6, 32), 32), ((3, 5, 7, 48), 32),
                                          ((2, 10, 24), 4)])
def test_group_norm_matches_jax(shape, groups, dtype):
    x, g, b, _ = _inputs(shape, 5, pre_add=False)
    jx = jnp.asarray(x, getattr(jnp, dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    want = junet.group_norm(jx, jnp.asarray(g), jnp.asarray(b), groups=groups)
    got = tunet.group_norm(tx, torch.from_numpy(g), torch.from_numpy(b), groups=groups)
    assert got.dtype == tx.dtype
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    else:
        assert_bf16_close(got, want, ulps=2)


@pytest.mark.parametrize("knob", [None, "1"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("eps", [1e-5, 1e-6])
def test_norm_act_matches_jax_under_both_knob_settings(knob, dtype, eps, monkeypatch):
    """``_norm_act`` with a FiLM row and SiLU: bf16 with the knob set takes
    B13 (JAX: its Pallas kernel); everything else takes ``group_norm``."""
    if knob is None:
        monkeypatch.delenv("VOCALIE_GN_PALLAS", raising=False)
    else:
        monkeypatch.setenv("VOCALIE_GN_PALLAS", knob)
    x, g, b, e = _inputs((4, 4, 8, 128), 9, pre_add=True)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    p_j = {"g": jnp.asarray(g), "b": jnp.asarray(b)}
    p_t = {"g": torch.from_numpy(g), "b": torch.from_numpy(b)}
    launched = group_norm_fused.launches
    calls = []
    real = tunet.group_norm_fused
    monkeypatch.setattr(tunet, "group_norm_fused", lambda *a, **k: calls.append(1) or real(*a, **k))
    for silu, pre in ((True, True), (False, False)):
        want = junet._norm_act(jnp.asarray(x, jd), p_j, silu=silu, eps=eps,
                               pre_add=jnp.asarray(e, jd) if pre else None)
        got = tunet._norm_act(torch.from_numpy(x).to(td), p_t, silu=silu, eps=eps,
                              pre_add=torch.from_numpy(e).to(td) if pre else None)
        assert got.dtype == td
        if dtype == "float32":
            np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
        else:
            assert_bf16_close(got, want, ulps=1 if knob else 2)
    assert len(calls) == (2 if (knob and dtype == "bfloat16") else 0)
    assert group_norm_fused.launches == launched   # the CPU never launches the kernel


def test_only_the_cpu_takes_the_plain_version():
    """A tensor on neither the CPU nor a CUDA device is refused, and a C
    the groups do not divide too; nothing counts as a launch."""
    x = torch.zeros((2, 4, 32), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="unsupported device"):
        group_norm_fused(x.to("meta"), torch.ones(32), torch.zeros(32), groups=8)
    with pytest.raises(ValueError, match="not divisible"):
        group_norm_fused(x, torch.ones(32), torch.zeros(32), groups=5)
    assert group_norm_fused.launches == 0
