"""B1w, the int8 decode attention with one softmax over the whole cache row:
the port's plain version against ``decode_attention_stacked(...,
int8_dots=True)`` on its non-T-blocked branches (``_kernel_stacked_int8dots[_new]``
and, on the lane-packed cache, ``_kernel_stacked_int8dots_packed``), run in
Pallas interpret mode under ``jax.jit`` as the decode step runs them; and the
decode step over an int8 cache whose length is not a 128-multiple.

Tolerances:
- the attention: atol 5e-4 on unit-scale inputs (outputs ~0.05), B1's
  (``tests/test_torch_decode_attention.py``): both sides re-quantize q and
  p to int8 in f32, and a value on a rounding boundary may round the other
  way under the two libraries' exp and summation order. Over the lane-packed
  cache JAX's selector matmuls are exact, so its packed kernel is held
  against the port's split one. The T-blocked computation (one p scale per
  128 slots) on the same inputs lands more than four times the tolerance
  away;
- the decode step, on the configs of ``tests/test_decode_attention.py:146-149``
  (d_head 8, split) and ``:184-187`` (d_head 64, lane-packed in JAX) at
  ``cache_len`` 32: logits within 2e-3 + 2e-3 · |ref| over 3 steps (the
  JAX package's bound for its decode-step kernels,
  ``tests/test_decode_step_fused.py``), and the int8 cache and its bf16
  scales equal byte for byte (JAX's packed k|v against the port's split k
  and v).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _int8_ties import assert_appended_cache_up_to_ties
from vocalie_tts_tpu.models.common import transformer as jt
from vocalie_tts_tpu.ops.decode_attention import decode_attention_stacked as jax_attn
from vocalie_tts_tpu_torch.bridge import to_torch, tree_to_torch
from vocalie_tts_tpu_torch.models.common import transformer as pt
from vocalie_tts_tpu_torch.ops.decode_attention import (
    decode_attention_plain,
    decode_attention_stacked,
    decode_attention_whole_plain,
)

NEG = -0.7 * float(np.finfo(np.float32).max)
TOL = 5e-4


def _case(seed, L, b, kv, g, T, d, prompt_pad, n_dec):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, kv, g, d)).astype(np.float32)
    k = rng.integers(-127, 128, (L, b, kv, T, d), dtype=np.int8)
    v = rng.integers(-127, 128, (L, b, kv, T, d), dtype=np.int8)
    ks = jnp.asarray(rng.uniform(0.5, 1.5, (L, b, kv, T)).astype(np.float32) / 127, jnp.bfloat16)
    vs = jnp.asarray(rng.uniform(0.5, 1.5, (L, b, kv, T)).astype(np.float32) / 127, jnp.bfloat16)
    kn = rng.standard_normal((b, kv, d)).astype(np.float32)
    vn = rng.standard_normal((b, kv, d)).astype(np.float32)
    lens = rng.integers(1, prompt_pad + 1, (b,))
    pos = np.arange(T)[None, :]
    valid = (pos < lens[:, None]) | ((pos >= prompt_pad) & (pos < prompt_pad + n_dec))
    bias = np.where(valid, 0.0, NEG).astype(np.float32)
    return q, k, v, ks, vs, bias, kn, vn


@jax.jit
def _jax_new(q, k, v, bias, layer, ks, vs, kn, vn, valid_len):
    return jax_attn(q, k, v, bias, layer, ks, vs, kn, vn, valid_len=valid_len,
                    sm_scale=float(q.shape[-1]) ** -0.5, int8_dots=True)


@jax.jit
def _jax_packed(q, kv2, bias, layer, ks, vs, kn, vn):
    return jax_attn(q, kv2, None, bias, layer, ks, vs, kn, vn,
                    sm_scale=float(q.shape[-1]) ** -0.5, int8_dots=True, packed=True)


@jax.jit
def _jax_no_new(q, k, v, bias, layer, ks, vs):
    return jax_attn(q, k, v, bias, layer, ks, vs, sm_scale=float(q.shape[-1]) ** -0.5,
                    int8_dots=True)


CASES = [
    # (branch, L, b, kv, g, T, d, prompt_pad, n_decoded, layer)
    ("new", 2, 3, 2, 1, 200, 16, 120, 41, 1),        # T not a 128-multiple
    ("new", 1, 2, 2, 2, 320, 16, 200, 57, 0),        # GQA
    ("no_new", 2, 3, 2, 1, 256, 16, 100, 20, 1),     # no k_new/valid_len; a fully masked row
    ("packed", 1, 2, 2, 1, 200, 64, 96, 40, 0),      # JAX on the packed bytes
    ("new", 1, 2, 1, 1, 136, 128, 64, 30, 0),        # d 128, g 1
    ("new", 1, 2, 1, 2, 136, 128, 64, 30, 0),        # d 128, g 2
]


@pytest.mark.parametrize("branch,L,b,kv,g,T,d,prompt_pad,n_dec,layer", CASES)
def test_whole_row_attention_matches_jax(branch, L, b, kv, g, T, d, prompt_pad, n_dec, layer):
    q, k, v, ks, vs, bias, kn, vn = _case(T + d + g, L, b, kv, g, T, d, prompt_pad, n_dec)
    valid_len = prompt_pad + n_dec
    lay = jnp.asarray(layer, jnp.int32)
    if branch == "no_new":
        bias[1] = NEG    # every slot masked: the softmax spreads over all T
        ref = _jax_no_new(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(bias),
                          lay, ks, vs)
    elif branch == "packed":
        kv2 = jnp.concatenate([jnp.asarray(k), jnp.asarray(v)], axis=-1)
        ref = _jax_packed(jnp.asarray(q), kv2, jnp.asarray(bias), lay, ks, vs, jnp.asarray(kn),
                          jnp.asarray(vn))
    else:
        ref = _jax_new(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(bias), lay,
                       ks, vs, jnp.asarray(kn), jnp.asarray(vn),
                       jnp.asarray(valid_len, jnp.int32))
    ref = np.asarray(ref)
    new = branch != "no_new"
    t = [to_torch(np.asarray(a)) for a in (q, k, v, bias, ks, vs, kn, vn)]
    out = decode_attention_stacked(
        *t[:4], layer, t[4], t[5], t[6] if new else None, t[7] if new else None,
        valid_len=valid_len if branch == "new" else None, sm_scale=d ** -0.5, int8_dots=True,
    ).numpy()
    assert out.shape == ref.shape == (b, kv, g, d)
    np.testing.assert_allclose(out, ref, atol=TOL, rtol=0)


def test_tolerance_tells_the_whole_row_from_t_blocks():
    """On the same inputs (the T3 voice-over shape of one layer, valid_len
    416 in a 640-slot cache), B1's T-blocked computation (one p scale per
    128 slots) lands more than four times the tolerance away from B1w's."""
    q, k, v, ks, vs, bias, kn, vn = _case(1, 1, 16, 16, 1, 640, 64, 256, 160)
    t = [to_torch(np.asarray(a)) for a in (q, k, v, bias, ks, vs, kn, vn)]
    whole = decode_attention_whole_plain(*t[:4], 0, *t[4:], valid_len=416, sm_scale=0.125)
    blocked = decode_attention_plain(*t[:4], 0, *t[4:], 416, 0.125)
    assert (whole - blocked).abs().max().item() > 4 * TOL


def test_whole_row_skips_only_masked_slots():
    """With k_new and valid_len, slots at and past valid_len are not read
    (garbage there changes nothing); without k_new every slot is read."""
    q, k, v, ks, vs, bias, kn, vn = _case(3, 1, 2, 2, 1, 200, 16, 60, 4)
    t = [to_torch(np.asarray(a)) for a in (q, k, v, bias, ks, vs, kn, vn)]
    base = decode_attention_stacked(*t[:4], 0, *t[4:], valid_len=64, sm_scale=0.25,
                                    int8_dots=True)
    no_new = decode_attention_stacked(*t[:4], 0, *t[4:6], sm_scale=0.25, int8_dots=True)
    t[1][..., 64:, :] = 127
    t[3][:, 64:] = 0.0
    again = decode_attention_stacked(*t[:4], 0, *t[4:], valid_len=64, sm_scale=0.25,
                                     int8_dots=True)
    assert torch.equal(base, again)
    moved = decode_attention_stacked(*t[:4], 0, *t[4:6], sm_scale=0.25, int8_dots=True)
    assert not torch.allclose(moved, no_new)


def numpy_params(jcfg, seed):
    """A JAX ``init_params`` tree for ``jcfg`` drawn with numpy from a seed
    (no JAX random program to compile): weights normal / sqrt(d_in),
    embeddings 0.02, norm gains 1 + 0.1 · normal, biases 0.2 · normal."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda: jt.init_params(jax.random.PRNGKey(0), jcfg))

    def draw(path, leaf):
        name = str(path[-1].key)
        x = rng.standard_normal(leaf.shape)
        if "norm" in name:
            x = 1.0 + 0.1 * x
        elif name in ("tok_emb", "pos_emb"):
            x = 0.02 * x
        elif name.startswith("w") or name == "lm_head":
            x = x / np.sqrt(leaf.shape[-2])
        else:
            x = 0.2 * x
        return np.asarray(jnp.asarray(x.astype(np.float32), leaf.dtype))

    return jax.tree_util.tree_map_with_path(draw, shapes)


#: the JAX package's own decode-kernel tests at cache_len 32
#: (tests/test_decode_attention.py:146-149 and :184-187)
STEP_CONFIGS = {
    "split_d8": (dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2, d_head=8,
                      d_ff=64, max_seq_len=64), 0),
    "packed_d64": (dict(vocab_size=96, d_model=128, n_layers=2, n_heads=2, n_kv_heads=2,
                        d_head=64, d_ff=256, max_seq_len=64), 2),
}


@pytest.mark.parametrize("name", list(STEP_CONFIGS))
def test_decode_step_over_a_32_slot_cache_matches_jax(monkeypatch, name):
    dims, seed = STEP_CONFIGS[name]
    flags = dict(kv_quant=True, decode_kernel=True)
    jcfg = jt.TransformerConfig(**dims, **flags, dtype=jnp.float32)
    pcfg = pt.TransformerConfig(**dims, **flags, dtype=torch.float32)
    assert jcfg.kv_packed == (name == "packed_d64")
    params = numpy_params(jcfg, seed)
    pparams = tree_to_torch(params)
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, dims["vocab_size"], (2, 7)).astype(np.int32)
    lengths = np.asarray([7, 5], np.int32)

    @jax.jit
    def jax_run(p, toks, lens):
        """Prefill and 3 teacher-forced steps in one program."""
        logits, cache = jt.prefill(p, jcfg, toks, lens, cache_len=32)
        out = [logits]
        for i in range(3):
            logits, cache = jt.decode_step(p, jcfg, toks[:, i], cache)
            out.append(logits)
        return out, cache

    jlogits, jc = jax_run(params, jnp.asarray(tokens), jnp.asarray(lengths))
    pl, pc = pt.prefill(pparams, pcfg, torch.from_numpy(tokens).long(),
                        torch.from_numpy(lengths), cache_len=32)
    plogits, raw = [pl], []
    monkeypatch.setattr(pt, "_quantize_kv",
                        lambda t, q=pt._quantize_kv: raw.append(t.clone()) or q(t))
    for i in range(3):
        pl, pc = pt.decode_step(pparams, pcfg, torch.from_numpy(tokens[:, i]).long(), pc)
        plogits.append(pl)
    for i, (ref, got) in enumerate(zip(jlogits, plogits)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-3, rtol=2e-3,
                                   err_msg=f"logits {i}")
    assert pc.n_decoded == 3 == int(jc.n_decoded)
    jk = np.asarray(jc.k)
    d = pc.k.shape[-1]
    jv = jk[..., d:] if jc.v is None else np.asarray(jc.v)
    # the prompt's slots and the empty ones bit for bit; the three decoded
    # slots up to int8 ties (an appended byte on a .5 tie may round apart)
    pad = pc.prompt_pad
    kept = np.r_[0:pad, pad + 3:pc.k.shape[3]]
    assert np.array_equal(pc.k.numpy()[:, :, :, kept], jk[:, :, :, kept, :d])
    assert np.array_equal(pc.v.numpy()[:, :, :, kept], jv[:, :, :, kept])
    for s in ("k_scale", "v_scale"):
        assert np.array_equal(getattr(pc, s).view(torch.int16).numpy()[:, :, :, kept],
                              np.asarray(getattr(jc, s)).view(np.int16)[:, :, :, kept])
    assert_appended_cache_up_to_ties(jc, pc, raw, prompt_pad=pad)
