"""The decode configurations the JAX package's ``apply_runtime_env`` gives
without the int8 cache, and the kernels they reach, against the JAX
package (Pallas in interpret mode, as its own tests run it):

- the f32 decode-attention branches: K1 (``decode_attention_stacked``
  over a bf16 or f32 cache, ``_kernel_stacked_plain[_new]``), K2 (over the
  int8 cache with ``int8_dots=False``, ``_kernel_stacked_quant[_new]``) and
  B10 (``decode_attention``, one unstacked layer), at d 64 (g 1) and d 128
  (g 2) over a bias with holes: atol 1e-4, the bound of
  ``tests/test_decode_attention.py:50``;
- K4, the cache append without scales (``cache_append_stacked(k, v, kn,
  vn, pos)``): byte-equal;
- the XLA attention branch in bf16 (``_xla_attention``) against JAX's
  branch compiled with ``xla_allow_excess_precision`` off, on scores exact
  in f32: within 1e-5 of the largest output up to p's bf16 rounding ties
  (``test_xla_attention_bf16_matches_jax``);
- the decode step in the five rows of the env matrix (``ROWS``) on four
  tiny family-like configs (``CONFIGS``), in f32 where the point is the
  algorithm: prefill and teacher-forced decode logits within 2e-3 + 2e-3 ·
  |ref| (``tests/test_decode_step_fused.py:95-105``), the port decoding
  from JAX's prompt cache; with the int8 dense kernels on, an int8
  activation on a .5 tie may move a row's logits at one step, so at most a
  quarter of the (step, row) logit rows may leave the tolerance there
  (``tests/test_torch_dense_step.py::_assert_logits_up_to_ties``); the
  appended cache slots as each test says;
- the bf16 cache of the two bf16-weight rows on bf16 configs
  (``test_bf16_cache_appends_like_jax``).

JAX's side of the decode step is one ``jax.jit`` program per config
(prefill and the teacher-forced steps of every row; Chatterbox's runs
CosyVoice's program with the q/k/v biases at 0).
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vocalie_tts_tpu.models.common import transformer as jt
from vocalie_tts_tpu.models.common.ar_runtime import apply_runtime_env as jax_env
from vocalie_tts_tpu.ops.cache_update import cache_append_stacked as jax_append
from vocalie_tts_tpu.ops.decode_attention import decode_attention as jax_b10
from vocalie_tts_tpu.ops.decode_attention import decode_attention_stacked as jax_attn
from vocalie_tts_tpu_torch.bridge import to_torch, tree_to_torch
from vocalie_tts_tpu_torch.models.common import transformer as pt
from vocalie_tts_tpu_torch.models.common.ar_runtime import apply_runtime_env as port_env
from vocalie_tts_tpu_torch.ops import cache_update as pcu
from vocalie_tts_tpu_torch.ops import decode_attention as pda

NEG = -0.7 * float(np.finfo(np.float32).max)

@pytest.fixture(autouse=True)
def one_torch_thread():
    """The port's side runs tiny tensors: one intra-op thread is as fast
    here, and it keeps the suite's parallel workers from oversubscribing the
    CPU with spinning thread pools."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


#: the env matrix: every decode configuration ``apply_runtime_env`` gives
#: besides the int8 default (``tests/test_torch_dense_step.py`` holds that)
ROWS = {
    "noenv": {},
    "decode_kernel": {"VOCALIE_DECODE_KERNEL": "1"},
    "weight_int8": {"VOCALIE_WEIGHT_INT8": "1"},
    "kv_int8_xla": {"VOCALIE_KV_INT8": "1", "VOCALIE_DECODE_KERNEL": "0"},
    "kv_int8_xla_dense": {"VOCALIE_KV_INT8": "1", "VOCALIE_DECODE_KERNEL": "0",
                          "VOCALIE_WEIGHT_INT8": "1"},
}
KNOBS = ("VOCALIE_KV_INT8", "VOCALIE_WEIGHT_INT8", "VOCALIE_DECODE_KERNEL",
         "VOCALIE_DENSE_KERNEL", "VOCALIE_MEGATAIL", "VOCALIE_MEGALAYER", "VOCALIE_FUSED_STEP")


def set_row(monkeypatch, row: str) -> None:
    for k in KNOBS:
        monkeypatch.delenv(k, raising=False)
    for k, v in ROWS[row].items():
        monkeypatch.setenv(k, v)


# ── K1, K2, B10: the f32 decode-attention branches ───────────────────────


def _attn_case(seed, L, b, kv, g, T, d, prompt_pad, n_dec, cache):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, kv, g, d)).astype(np.float32)
    if cache == "int8":
        k, v = (rng.integers(-127, 128, (L, b, kv, T, d), dtype=np.int8) for _ in range(2))
        ks, vs = (jnp.asarray(rng.uniform(0.5, 1.5, (L, b, kv, T)).astype(np.float32) / 127,
                              jnp.bfloat16) for _ in range(2))
    else:
        k, v = (jnp.asarray(rng.standard_normal((L, b, kv, T, d)).astype(np.float32),
                            jnp.dtype(cache)) for _ in range(2))
        ks = vs = None
    kn, vn = (rng.standard_normal((b, kv, d)).astype(np.float32) for _ in range(2))
    # per-row prompt lengths leave masked slots inside the valid range
    lens = rng.integers(1, prompt_pad + 1, (b,))
    pos = np.arange(T)[None, :]
    valid = (pos < lens[:, None]) | ((pos >= prompt_pad) & (pos < prompt_pad + n_dec))
    bias = np.where(valid, 0.0, NEG).astype(np.float32)
    return q, k, v, ks, vs, bias, kn, vn


def _t(a):
    return None if a is None else to_torch(np.asarray(a))


@pytest.mark.parametrize("cache", ["bfloat16", "int8"])
@pytest.mark.parametrize("g,d", [(1, 64), (2, 128)])
def test_f32_branches_match_jax(cache, g, d):
    """K1 (a bf16 cache; the f32 cache in ``test_decode_step_matrix``) and
    K2 (int8 with scales) through the port's
    ``decode_attention_stacked`` with JAX's branch choice (``int8_dots``
    off), with the current token (the port reads the valid slots only) and,
    on the bf16 cache, without it (every slot read)."""
    L, b, kv, T, layer, prompt_pad, n_dec = 2, 2, 2, 256, 1, 100, 28
    q, k, v, ks, vs, bias, kn, vn = _attn_case(g * d + len(cache), L, b, kv, g, T, d,
                                               prompt_pad, n_dec, cache)
    valid_len = prompt_pad + n_dec
    ref = jax_attn(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(bias),
                   jnp.asarray(layer), ks, vs, jnp.asarray(kn), jnp.asarray(vn),
                   valid_len=jnp.asarray(valid_len, jnp.int32), sm_scale=d ** -0.5)
    got = pda.decode_attention_stacked(_t(q), _t(k), _t(v), _t(bias), layer, _t(ks), _t(vs),
                                       _t(kn), _t(vn), valid_len=valid_len, sm_scale=d ** -0.5)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4, rtol=0)
    if cache == "bfloat16":
        ref = jax_attn(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(bias),
                       jnp.asarray(layer), sm_scale=d ** -0.5)
        got = pda.decode_attention_stacked(_t(q), _t(k), _t(v), _t(bias), layer,
                                           sm_scale=d ** -0.5)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4, rtol=0)


@pytest.mark.parametrize("cache", ["bfloat16", "int8"])
@pytest.mark.parametrize("g,d", [(1, 64), (2, 128)])
def test_b10_matches_jax(cache, g, d):
    """B10 (``decode_attention``) on one unstacked layer, with the int8
    cache's f32 scales or without scales."""
    q, k, v, ks, vs, bias, _, _ = _attn_case(3 * d + g, 1, 2, 2, g, 256, d, 100, 28, cache)
    k, v = np.asarray(k)[0], np.asarray(v)[0]
    if ks is not None:
        ks, vs = (np.asarray(s, np.float32)[0] for s in (ks, vs))
    ref = jax_b10(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(bias),
                  None if ks is None else jnp.asarray(ks), None if vs is None else jnp.asarray(vs),
                  sm_scale=d ** -0.5)
    got = pda.decode_attention(_t(q), _t(k), _t(v), _t(bias), _t(ks), _t(vs), sm_scale=d ** -0.5)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4, rtol=0)


def test_dispatch_refuses_the_int8_branch_it_lacks():
    """``int8_dots`` over a cache that is not a 128-multiple is JAX's
    non-T-blocked int8 branch (``_kernel_stacked_int8dots_new``). The port
    used to refuse it; it now takes the whole-row kernel's plain version
    (B1w) and matches JAX within B1's atol 5e-4
    (``tests/test_torch_decode_attention_whole.py`` holds the other cases)."""
    q, k, v, ks, vs, bias, kn, vn = _attn_case(5, 1, 1, 1, 1, 200, 16, 100, 8, "int8")
    ref = jax_attn(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(bias),
                   jnp.asarray(0), ks, vs, jnp.asarray(kn), jnp.asarray(vn),
                   valid_len=jnp.asarray(108, jnp.int32), sm_scale=0.25, int8_dots=True)
    got = pda.decode_attention_stacked(_t(q), _t(k), _t(v), _t(bias), 0, _t(ks), _t(vs), _t(kn),
                                       _t(vn), valid_len=108, sm_scale=0.25, int8_dots=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=5e-4, rtol=0)


# ── K4: the append without scales ────────────────────────────────────────


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_kv_append_matches_jax_bytes(dtype):
    rng = np.random.default_rng(9)
    L, b, kv, T, d, pos = 3, 2, 2, 128, 64, 77
    k, v = (jnp.asarray(rng.standard_normal((L, b, kv, T, d)), jnp.dtype(dtype)) for _ in range(2))
    kn, vn = (jnp.asarray(rng.standard_normal((L, b, kv, d)), jnp.dtype(dtype)) for _ in range(2))
    rk, rv = jax_append(k, v, kn, vn, jnp.asarray(pos, jnp.int32))
    pk, pv = pcu.cache_append_kv_stacked(_t(k), _t(v), _t(kn), _t(vn), pos)
    bits = torch.int16 if dtype == "bfloat16" else torch.int32
    for got, ref in ((pk, rk), (pv, rv)):
        assert torch.equal(got.view(bits), _t(ref).view(bits))


# ── the XLA attention branch in bf16 ─────────────────────────────────────


def _jax_xla_branch(qg, k_all, v_all, ks_all, vs_all, bias, kn, vn, l, sm_scale):
    """JAX's XLA decode-attention branch, the lines of ``decode_step``
    (``transformer.py:1028-1059``) over layer ``l``, written out here as
    they stand there (the branch is not a function of its own): → (output
    ``[b, kv, g, d]`` f32, p before its cast, the denominator)."""
    f32, dt = jnp.float32, qg.dtype
    k_cache, v_cache = k_all[l], v_all[l]
    s = jnp.einsum("bhgd,bhtd->bhgt", qg, k_cache.astype(qg.dtype),
                   preferred_element_type=f32) * sm_scale
    if ks_all is not None:
        s = s * ks_all[l][:, :, None, :].astype(f32)
    s = s + bias[:, None, None, :]
    s_new = jnp.einsum("bhgd,bhd->bhg", qg.astype(f32), kn.astype(f32),
                       preferred_element_type=f32)[..., None] * sm_scale
    m = jnp.maximum(jnp.max(s, axis=-1, keepdims=True), s_new)
    e = jnp.exp(s - m)
    p_new = jnp.exp(s_new - m)
    denom = jnp.sum(e, axis=-1, keepdims=True) + p_new
    p = e
    if vs_all is not None:
        p = p * vs_all[l][:, :, None, :].astype(f32)
    attn = jnp.einsum("bhgt,bhtd->bhgd", p.astype(dt), v_cache.astype(dt),
                      preferred_element_type=f32)
    return (attn + p_new * vn.astype(f32)[:, :, None, :]) / denom, p, denom


@pytest.mark.parametrize("cache", ["bfloat16", "int8"])
@pytest.mark.parametrize("g,d", [(1, 64), (2, 128)])
def test_xla_attention_bf16_matches_jax(cache, g, d):
    """The port's ``_xla_attention`` with bf16 activations (the no-env
    configuration users get: the bf16 cache; and the int8 cache with the
    scales folded) against JAX's branch compiled with
    ``xla_allow_excess_precision`` off, so that XLA keeps the cast of p to
    bf16 before the PV product. q, k and the current token's k are small
    integers over 4 (int8 k as they come), so that every score is exact in
    f32 in any summation order: the two libraries' f32 p then differ only
    by their ``exp``'s last ulps. The outputs agree within 1e-5 of the
    largest, plus, at a p within 4 ulps of a bf16 rounding midpoint, one
    bf16 step of that p times its largest |v| over the denominator.
    Dropping the p cast moves the output by ~1e-3 of its largest; scores
    summed in bf16 by far more. (The cache's cast to the activation dtype
    is exact for a bf16 or int8 cache: no test can see it.)"""
    L, b, kv, T, layer = 2, 2, 2, 192, 1
    rng = np.random.default_rng(31 * d + g + len(cache))
    bf = jnp.bfloat16
    q = jnp.asarray(rng.integers(-4, 5, (b, kv * g, 1, d)) / 4, bf)
    if cache == "int8":
        k, v = (jnp.asarray(rng.integers(-127, 128, (L, b, kv, T, d)), jnp.int8) for _ in range(2))
        ks, vs = (jnp.asarray(rng.uniform(0.5, 1.5, (L, b, kv, T)) / 127, bf) for _ in range(2))
    else:
        k = jnp.asarray(rng.integers(-8, 9, (L, b, kv, T, d)) / 4, bf)
        v = jnp.asarray(rng.standard_normal((L, b, kv, T, d)), bf)
        ks = vs = None
    kn = jnp.asarray(rng.integers(-8, 9, (b, kv, 1, d)) / 4, bf)
    vn = jnp.asarray(rng.standard_normal((b, kv, 1, d)), bf)
    bias = jnp.asarray(np.where(rng.random((b, T)) < 0.7, 0.0, NEG), jnp.float32)
    sm = d ** -0.5

    def ref_fn(q, k, v, ks, vs, bias, kn, vn):
        return _jax_xla_branch(q.reshape(b, kv, g, d), k, v, ks, vs, bias, kn[:, :, 0],
                               vn[:, :, 0], layer, sm)

    args = (q, k, v, ks, vs, bias, kn, vn)
    ref, p, denom = (np.asarray(a, np.float32) for a in jax.device_get(
        jax.jit(ref_fn).lower(*args).compile({"xla_allow_excess_precision": False})(*args)))
    cache_t = types.SimpleNamespace(k=_t(k), v=_t(v), k_scale=_t(ks), v_scale=_t(vs))
    got = pt._xla_attention(cache_t, layer, _t(q), _t(kn), _t(vn), _t(bias), sm).numpy()
    # p's on a bf16 rounding boundary: the f32 value within 4 ulps of a
    # midpoint between two bf16 values
    bits = p.view(np.uint32).astype(np.int64)
    near = np.abs((bits & 0xFFFF) - 0x8000) <= 4
    v_max = np.abs(np.asarray(v, np.float32)[layer]).max(-1)                  # [b, kv, T]
    step = np.ldexp(1.0, np.frexp(p)[1] - 8)                                  # a bf16 step of p
    ties = (near * step * v_max[:, :, None, :]).sum(-1, keepdims=True) / denom
    assert (np.abs(got - ref) <= 1e-5 * np.abs(ref).max() + ties).all(), \
        np.abs(got - ref).max() / np.abs(ref).max()


# ── the decode step over the env matrix ──────────────────────────────────

DIMS = dict(vocab_size=96, d_model=128, n_layers=2, n_heads=2, n_kv_heads=2, d_head=64,
            d_ff=256, max_seq_len=256)
#: four tiny family-like configs: ``DIMS`` plus these
CONFIGS = {
    "chatterbox": {},
    "cosyvoice": dict(attn_bias=True),
    "xtts": dict(norm_type="layer", mlp_type="gelu", bias=True, pos_type="learned",
                 pos_index="decode_relative", head_bias=True),
    "qwen3": dict(n_heads=2, n_kv_heads=1, d_head=128, qk_norm=True, norm_eps=1e-6),
}
CACHE_LEN, PROMPT, N_STEPS, B = 128, 32, 4, 2
_RAW, _JAX = {}, {}
_DT = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _raw(config, dtype):
    """The JAX init tree of a config (its structure and dtypes from
    ``init_params``), every leaf drawn from a numpy seed as ``init_params``
    scales it (dense weights over √fan-in), biases and norm weights not
    inert."""
    if (config, dtype) not in _RAW:
        jcfg = jt.TransformerConfig(**{**DIMS, **CONFIGS[config]}, dtype=_DT[dtype][0])
        shapes = jax.eval_shape(lambda: jt.init_params(jax.random.PRNGKey(4), jcfg))
        # biases from a generator of their own: the other leaves do not
        # depend on which biases a config has
        rng, rng_b = np.random.default_rng(41), np.random.default_rng(42)

        def draw(name, leaf):
            if name in ("bq", "bk", "bv", "bo", "b_up", "b_down", "lm_head_b", "final_norm_b",
                        "attn_norm_b", "mlp_norm_b"):
                return np.asarray((0.2 * rng_b.standard_normal(leaf.shape)).astype(np.float32),
                                  leaf.dtype)
            n = rng.standard_normal(leaf.shape)
            if name in ("attn_norm", "mlp_norm", "q_norm", "k_norm", "final_norm"):
                n = 1 + 0.2 * n
            else:
                n = n * {"tok_emb": 0.02, "pos_emb": 0.01}.get(name, leaf.shape[-2] ** -0.5)
            return np.asarray(n.astype(np.float32), leaf.dtype)

        raw = {n: draw(n, v) for n, v in shapes.items() if n != "layers"}
        raw["layers"] = {n: draw(n, v) for n, v in shapes["layers"].items()}
        _RAW[config, dtype] = (jcfg, raw)
    return _RAW[config, dtype]


def _inputs(d_model):
    rng = np.random.default_rng(17)
    emb = (rng.standard_normal((B, PROMPT, d_model)) * 0.5).astype(np.float32)
    emb = np.array(jnp.asarray(emb, jnp.bfloat16).astype(jnp.float32))    # bf16-exact
    lens = np.asarray([PROMPT, 11], np.int32)
    toks = rng.integers(0, DIMS["vocab_size"], (N_STEPS, B)).astype(np.int32)
    return emb, lens, toks


#: configs whose JAX reference runs another config's program: Chatterbox's
#: is CosyVoice's (the same tree, drawn in the same order) with the q/k/v
#: biases at 0, which add exactly nothing
SHARED = {"chatterbox": "cosyvoice"}


def _jax_programs(config, rows, dtype, monkeypatch):
    """JAX's prefill and teacher-forced decode of ``config`` (and of the
    configs that share its program) in each of ``rows`` (each row's flags
    from JAX's ``apply_runtime_env`` under its env), all rows in one
    ``jax.jit`` program: (config, row) → (flags, prefill logits, prompt
    cache, step logits, final cache). In bf16 the program is compiled with
    ``xla_allow_excess_precision`` off, so that XLA rounds every bf16 op's
    result as PyTorch does."""
    jcfg0, raw = _raw(config, dtype)
    variants = {config: raw}
    for other in (c for c, host in SHARED.items() if host == config):
        own = _raw(other, dtype)[1]
        zeroed = {**raw, "layers": {**raw["layers"], **{n: np.zeros_like(raw["layers"][n])
                                                        for n in ("bq", "bk", "bv")}}}
        assert jax.tree_util.tree_all(jax.tree_util.tree_map(
            np.array_equal, own, {**zeroed, "layers": {n: zeroed["layers"][n]
                                                       for n in own["layers"]}}))
        variants[other] = zeroed
    cfgs = []
    for row in rows:
        set_row(monkeypatch, row)
        cfgs.append(jax_env(jcfg0))
    emb, lens, toks = _inputs(jcfg0.d_model)

    def run(trees, e, l, t):
        out = []
        for jcfg, p in zip(cfgs, trees):
            logits, cache = jt.prefill(p, jcfg, jnp.zeros(e.shape[:2], jnp.int32), l,
                                       inputs_embeds=e.astype(jcfg.dtype), cache_len=CACHE_LEN)

            def step(c, tok, p=p, jcfg=jcfg):
                lg, c = jt.decode_step(p, jcfg, tok, c)
                return c, lg

            final, steps = jax.lax.scan(step, cache, t)
            out.append((logits, cache, steps, final))
        return out

    def trees(tree):
        quant = jax.device_get(jax.jit(jt.quantize_weights_int8)(tree))
        return [jt.fuse_decode_weights(quant if "VOCALIE_WEIGHT_INT8" in ROWS[row] else tree)
                for row in rows]

    data = (jnp.asarray(emb), jnp.asarray(lens), jnp.asarray(toks))
    opts = {"xla_allow_excess_precision": False} if dtype == "bfloat16" else None
    inputs = {name: trees(tree) for name, tree in variants.items()}
    program = jax.jit(run).lower(inputs[config], *data).compile(opts)
    results = {}
    for name, tree_list in inputs.items():
        outs = jax.device_get(program(tree_list, *data))
        results.update({(name, row): ((c.kv_quant, c.decode_kernel, c.dense_kernel), *o)
                        for row, c, o in zip(rows, cfgs, outs)})
    return results


def jax_model(config, row, monkeypatch, dtype="float32"):
    """(port cfg, port params, JAX's flags, prefill logits, prompt cache,
    step logits, final cache) under ``row``'s env. JAX's side is one program
    per config (``SHARED``): in f32 every row of ``ROWS`` at once (the
    matrix), in bf16 the row asked for."""
    host = SHARED.get(config, config) if dtype == "float32" else config
    key = (host, dtype) if dtype == "float32" else (host, row, dtype)
    if key not in _JAX:
        _JAX[key] = _jax_programs(host, sorted(ROWS) if dtype == "float32" else [row], dtype,
                                  monkeypatch)
    set_row(monkeypatch, row)
    pcfg = port_env(pt.TransformerConfig(**{**DIMS, **CONFIGS[config]}, dtype=_DT[dtype][1]))
    int8 = "VOCALIE_WEIGHT_INT8" in ROWS[row]
    pparams = tree_to_torch(_raw(config, dtype)[1])
    pparams = pt.fuse_decode_weights(pt.quantize_weights_int8(pparams) if int8 else pparams)
    return (pcfg, pparams, *_JAX[key][config, row])


def _port_run(pcfg, pparams, jprompt, monkeypatch):
    """The port's prefill logits and cache, then its teacher-forced steps
    from JAX's prompt cache (a prompt element that rounds apart in the two
    prefills would move every later step) → (logits, cache, unquantized k/v
    of each step)."""
    emb, lens, toks = _inputs(pcfg.d_model)
    pl0, pcache = pt.prefill(pparams, pcfg, None, torch.from_numpy(lens),
                             inputs_embeds=torch.from_numpy(emb).to(pcfg.dtype),
                             cache_len=CACHE_LEN)
    assert pcache.k.dtype == (torch.int8 if pcfg.kv_quant else pcfg.dtype)
    assert (pcache.k_scale is None) is (jprompt.k_scale is None) is (not pcfg.kv_quant)
    for name in ("k", "v", "k_scale", "v_scale"):
        ref = getattr(jprompt, name)
        if ref is not None:
            getattr(pcache, name).copy_(to_torch(np.asarray(ref)))
    raw, quantize_kv = [], pt._quantize_kv
    monkeypatch.setattr(pt, "_quantize_kv", lambda t: raw.append(t.clone()) or quantize_kv(t))
    logits = [pl0.numpy()]
    for i in range(N_STEPS):
        lg, pcache = pt.decode_step(pparams, pcfg, torch.from_numpy(toks[i]).long(), pcache)
        logits.append(lg.numpy())
    return logits, pcache, raw


@pytest.mark.parametrize("row", sorted(ROWS))
@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_decode_step_matrix(monkeypatch, config, row):
    """f32 (the algorithm; ``test_bf16_cache_appends_like_jax`` holds the
    bf16 cache): prefill and teacher-forced step logits against JAX's; the
    appended slots: a float cache within 1e-5 · max|ref| (the k/v's f32
    sums run in another order), an int8 cache's scales equal and its values
    equal except one step off on a .5 tie of the port's unquantized k/v."""
    pcfg, pparams, flags, jl0, jprompt, jsteps, jfinal = jax_model(config, row, monkeypatch)
    assert (pcfg.kv_quant, pcfg.decode_kernel, pcfg.dense_kernel) == flags
    logits, pcache, raw = _port_run(pcfg, pparams, jprompt, monkeypatch)
    refs = [np.asarray(jl0)] + [np.asarray(r) for r in jsteps]
    ratios = np.stack([(np.abs(g - r) / (2e-3 + 2e-3 * np.abs(r))).max(-1)
                       for r, g in zip(refs, logits)])
    assert ratios[0].max() <= 1, f"prefill: {ratios[0]}"
    outside = int((ratios[1:] > 1).sum())
    if pcfg.dense_kernel:
        assert outside * 4 <= ratios[1:].size, ratios
    else:
        assert outside == 0, ratios
    sl = slice(PROMPT, PROMPT + N_STEPS)
    for name, unq in (("k", raw[0::2]), ("v", raw[1::2])):
        got = getattr(pcache, name)[:, :, :, sl].numpy()
        ref = np.asarray(getattr(jfinal, name))[:, :, :, sl]
        if not pcfg.kv_quant:
            assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max(), name
            continue
        scale = getattr(pcache, name + "_scale")[:, :, :, sl]
        jscale = np.asarray(getattr(jfinal, name + "_scale"))[:, :, :, sl]
        assert np.array_equal(scale.view(torch.int16).numpy(), jscale.view(np.int16)), name
        bad = got != ref
        if bad.any():
            assert np.all(np.abs(got[bad].astype(int) - ref[bad].astype(int)) == 1), name
            x = (torch.stack(unq, 3) / scale.float()[..., None]).numpy()[bad]
            assert np.all(np.abs(np.abs(x - np.trunc(x)) - 0.5) < 1e-3), f"{name}: {x}"


@pytest.mark.parametrize("config,row", [("chatterbox", "noenv"), ("qwen3", "decode_kernel")])
def test_bf16_cache_appends_like_jax(monkeypatch, config, row):
    """The bf16 cache in the two rows that keep it with bf16 weights (no
    env: the XLA branch and slice assignment; ``VOCALIE_DECODE_KERNEL=1``:
    K1 and K4), on bf16 configs, against JAX compiled to round every bf16
    op as PyTorch does. The slots the steps append: layer 0's k/v (the
    step's token alone: norm, qkv, q/k norm, RoPE) hold JAX's bf16 values or
    the neighbouring one, where the two libraries' f32 sums round a bf16
    result apart (at most 1 % of them); a later layer's input carries such
    roundings of the residual stream through the first layer's attention
    and MLP, so its k/v stay within 2^-6 of their row's largest (four bf16
    steps of it). A wrong path moves every slot by far more. The logits are
    held in f32 (``test_decode_step_matrix``): in bf16 the libraries round
    the residual stream apart by more than 2e-3 already after one layer."""
    pcfg, pparams, flags, _, jprompt, _, jfinal = jax_model(config, row, monkeypatch, "bfloat16")
    assert not pcfg.kv_quant and pcfg.decode_kernel is (row == "decode_kernel")
    _, pcache, _ = _port_run(pcfg, pparams, jprompt, monkeypatch)
    sl = slice(PROMPT, PROMPT + N_STEPS)
    for name in ("k", "v"):
        got = getattr(pcache, name)[:, :, :, sl]
        ref = to_torch(np.asarray(getattr(jfinal, name))[:, :, :, sl])
        assert got.dtype == ref.dtype == torch.bfloat16
        steps = (got[0].view(torch.int16).int() - ref[0].view(torch.int16).int()).abs()
        assert (got[0].float() * ref[0].float() >= 0).all() and steps.max() <= 1, name
        assert steps.float().mean() <= 0.01, f"{name}: {int(steps.sum())} of {steps.numel()} off"
        diff = (got.float() - ref.float()).abs()
        assert (diff <= 2 ** -6 * ref.float().abs().amax(-1, keepdim=True)).all(), name
