"""Sampling helpers of the port against the JAX package's: repetition
penalty, CFG combine, top-k / top-p masks and greedy argmax. These are
exact functions of their inputs (comparisons, one multiply-add), so the
tolerance is float32 rounding (atol 1e-6) and argmax must be equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vocalie_tts_tpu.ops import sampling as js
from vocalie_tts_tpu_torch.ops import sampling as ps


def _logits(seed, b=4, v=97):
    return np.random.default_rng(seed).standard_normal((b, v)).astype(np.float32) * 3


def test_repetition_penalty_and_cfg():
    lg = _logits(0)
    counts = np.random.default_rng(1).integers(0, 3, lg.shape).astype(np.int32)
    ref = js.apply_repetition_penalty(jnp.asarray(lg), jnp.asarray(counts), 1.35)
    out = ps.apply_repetition_penalty(torch.from_numpy(lg), torch.from_numpy(counts), 1.35)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6, rtol=0)
    un = _logits(2)
    ref = js.cfg_combine(jnp.asarray(lg), jnp.asarray(un), 0.6)
    out = ps.cfg_combine(torch.from_numpy(lg), torch.from_numpy(un), 0.6)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6, rtol=0)


@pytest.mark.parametrize("top_k,top_p", [(0, 1.0), (5, 1.0), (0, 0.7), (10, 0.5)])
def test_top_k_top_p_masks_and_greedy(top_k, top_p):
    lg = _logits(top_k + int(top_p * 10))
    ref = js._top_p_mask(js._top_k_mask(jnp.asarray(lg), top_k), top_p)
    out = ps._top_p_mask(ps._top_k_mask(torch.from_numpy(lg), top_k), top_p)
    np.testing.assert_array_equal(out.numpy() <= -1e29, np.asarray(ref) <= -1e29)
    greedy = js.sample_logits(None, jnp.asarray(lg), temperature=0.0, top_k=top_k, top_p=top_p)
    out = ps.sample_logits(torch.from_numpy(lg), temperature=0.0, top_k=top_k, top_p=top_p)
    np.testing.assert_array_equal(out.numpy(), np.asarray(greedy))


def test_sampled_tokens_stay_inside_the_kept_set():
    lg = torch.from_numpy(_logits(7, b=64))
    gen = torch.Generator().manual_seed(0)
    tok = ps.sample_logits(lg, temperature=0.8, top_k=3, generator=gen)
    top3 = torch.topk(lg, 3, dim=-1).indices
    assert bool((top3 == tok[:, None]).any(-1).all())
