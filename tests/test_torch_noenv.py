"""The JAX package's no-env decode configurations at the family level:

- the path each row of the env matrix takes (no compute): the port's
  ``apply_runtime_env`` flags equal JAX's, and ``_dense_dispatch`` picks
  the whole-step kernel B7 or the whole-layer kernel B12 exactly where
  JAX's ``decode_step`` traces ``decode_step_fused_packed`` or
  ``layer_swiglu_qkv_int8_stacked`` (``jax.make_jaxpr``), at batch 1 and 8,
  d_head 64 and 128, with ``VOCALIE_MEGALAYER=1`` so that B12 is possible:
  never on a bf16 cache or with ``VOCALIE_DECODE_KERNEL=0``;
- greedy ``generate_tokens`` in the no-env and ``VOCALIE_DECODE_KERNEL=1``
  rows on the tiny Chatterbox-like config of ``tests/test_torch_bf16_cache.py``
  (f32): tokens equal JAX's; where the port's pick leaves JAX's, JAX's own
  logits on the port's tokens must show a near-tie (the port's pick within
  2e-3 + 2e-3 · |max| of JAX's top logit at that step, the
  ``tests/test_torch_slice.py`` rule), and tokens are compared up to it;
- ``run_tts_pipeline`` on the port alone with no env set, on the CPU, for
  each family (CosyVoice also through ``synthesize_stream``): a finite WAV
  of the length the chunks' durations and gaps give;
- the bridge keeps a bf16 (non-int8) tree's leaves in the dtype the JAX
  runtime holds them in.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_bf16_cache import CONFIGS, DIMS, KNOBS, ROWS, _raw, set_row
from vocalie_tts_tpu.models.common import transformer as jt
from vocalie_tts_tpu.models.common.ar_runtime import apply_runtime_env as jax_env
from vocalie_tts_tpu_torch.bridge import tree_to_torch
from vocalie_tts_tpu_torch.engines import ENGINES
from vocalie_tts_tpu_torch.io.wavio import read_wav
from vocalie_tts_tpu_torch.models.common import transformer as pt
from vocalie_tts_tpu_torch.models.common.ar_runtime import apply_runtime_env as port_env
from vocalie_tts_tpu_torch.models.common.vocoder import VocoderConfig
from vocalie_tts_tpu_torch.models.lmtts.model import LMTTSConfig
from vocalie_tts_tpu_torch.pipeline import run_tts_pipeline
from vocalie_tts_tpu_torch.text import parse_manual_chunks

@pytest.fixture(autouse=True)
def one_torch_thread():
    """The port's side runs tiny tensors: one intra-op thread is as fast
    here, and it keeps the suite's parallel workers from oversubscribing the
    CPU with spinning thread pools."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


#: the matrix rows and, for contrast, the int8 serving default
PATH_ROWS = {**ROWS, "int8_default": {"VOCALIE_KV_INT8": "1", "VOCALIE_WEIGHT_INT8": "1"}}


def _jax_kernels(jcfg, jparams, batch: int) -> set:
    """The whole-step (B7) and whole-layer (B12) kernels JAX's decode step
    traces at ``batch`` (the generate programs' head-stacked qkv installed
    first, as they do)."""
    params = jax.eval_shape(lambda p: jt.maybe_head_stack_qkv(p, jcfg, batch), jparams)
    cache = jax.eval_shape(lambda: jt.StackedKVCache.create(
        jcfg.n_layers, batch, jcfg.n_kv_heads, 256, jcfg.d_head, jcfg.dtype,
        quantized=jcfg.kv_quant, packed=jcfg.kv_packed))
    text = str(jax.make_jaxpr(lambda p, t, c: jt.decode_step(p, jcfg, t, c))(
        params, jax.ShapeDtypeStruct((batch,), jnp.int32), cache))
    names = set(re.findall(r"name=(\w+)", text))
    return {k for k, n in (("B7", "decode_step_fused_packed"),
                           ("B12", "layer_swiglu_qkv_int8_stacked")) if n in names}


@pytest.mark.parametrize("row", sorted(PATH_ROWS))
def test_path_choice_follows_jax(monkeypatch, row):
    for k in KNOBS:
        monkeypatch.delenv(k, raising=False)
    for k, v in {**PATH_ROWS[row], "VOCALIE_MEGALAYER": "1"}.items():
        monkeypatch.setenv(k, v)
    int8 = "VOCALIE_WEIGHT_INT8" in PATH_ROWS[row]
    picks = {}
    for config in ("chatterbox", "qwen3"):
        jcfg = jax_env(jt.TransformerConfig(**{**DIMS, **CONFIGS[config]}, dtype=jnp.float32))
        pcfg = port_env(pt.TransformerConfig(**{**DIMS, **CONFIGS[config]},
                                             dtype=torch.float32))
        assert (pcfg.kv_quant, pcfg.decode_kernel, pcfg.dense_kernel) == (
            jcfg.kv_quant, jcfg.decode_kernel, jcfg.dense_kernel)
        init = lambda: jt.init_params(jax.random.PRNGKey(0), jcfg)   # noqa: E731
        jparams = jax.eval_shape(lambda: jt.fuse_decode_weights(
            jt.quantize_weights_int8(init()) if int8 else init()))
        raw = pt.init_params(pcfg)
        pparams = pt.fuse_decode_weights(pt.quantize_weights_int8(raw) if int8 else raw)
        for batch in (1, 8):
            path = pt._dense_dispatch(pparams["layers"], pcfg, batch, 256)
            port = {pt.FUSED_STEP: {"B7"}, pt.MEGALAYER: {"B12"}}.get(path, set())
            assert port == _jax_kernels(jcfg, jparams, batch), (config, batch, path)
            picks[config, batch] = path
    if row in ROWS:   # a bf16 cache, or VOCALIE_DECODE_KERNEL=0
        assert not {pt.FUSED_STEP, pt.MEGALAYER} & set(picks.values()), picks
    else:   # the contrast: both kernels are reachable in the int8 default
        assert picks["chatterbox", 1] == pt.FUSED_STEP and picks["qwen3", 8] == pt.MEGALAYER


# ── greedy decode ────────────────────────────────────────────────────────

N_NEW, EOS = 16, 95


def _greedy_inputs():
    rng = np.random.default_rng(23)
    emb = (rng.standard_normal((2, 32, DIMS["d_model"])) * 0.5).astype(np.float32)
    return emb, np.asarray([32, 9], np.int32)


@pytest.mark.parametrize("row", ["noenv", "decode_kernel"])
def test_greedy_tokens_match_jax(monkeypatch, row):
    from vocalie_tts_tpu.ops.generate import GenerateConfig as JGen
    from vocalie_tts_tpu.ops.generate import generate_tokens as jax_generate
    from vocalie_tts_tpu_torch.ops.generate import GenerateConfig, generate_tokens

    set_row(monkeypatch, row)
    jcfg, raw = _raw("chatterbox", "float32")
    jcfg = jax_env(jcfg)
    pcfg = port_env(pt.TransformerConfig(**DIMS, dtype=torch.float32))
    assert not pcfg.kv_quant and pcfg.decode_kernel is (row == "decode_kernel")
    jparams, pparams = jt.fuse_decode_weights(raw), pt.fuse_decode_weights(tree_to_torch(raw))
    emb, lens = _greedy_inputs()
    first = np.asarray([3, 3], np.int32)

    def prompt(p, e, l):
        return jt.prefill(p, jcfg, jnp.zeros(e.shape[:2], jnp.int32), l, inputs_embeds=e,
                          cache_len=128)[1]

    @jax.jit
    def jgen(p, e, l):
        gen = JGen(max_new_tokens=N_NEW, eos_token_id=EOS, temperature=0.0)
        return jax_generate(p, lambda p, t, c, _cv: jt.decode_step(p, jcfg, t, c),
                            prompt(p, e, l), jnp.asarray(first), jax.random.PRNGKey(0), gen)

    jtoks, jlens = (np.asarray(a) for a in jgen(jparams, jnp.asarray(emb), jnp.asarray(lens)))
    _, cache = pt.prefill(pparams, pcfg, None, torch.from_numpy(lens),
                          inputs_embeds=torch.from_numpy(emb), cache_len=128)
    gen = GenerateConfig(max_new_tokens=N_NEW, eos_token_id=EOS, temperature=0.0)
    ptoks, plens = generate_tokens(pparams, lambda p, t, c: pt.decode_step(p, pcfg, t, c),
                                   cache, torch.from_numpy(first).long(), gen)
    ptoks, plens = ptoks.numpy(), plens.numpy()
    if np.array_equal(ptoks, jtoks):
        assert np.array_equal(plens, jlens)
        return
    # JAX's logits on the port's tokens: the first pick that differs must
    # sit within the logit tolerance of JAX's top logit at that step
    inputs = np.concatenate([first[:, None], ptoks[:, :-1]], 1).T

    @jax.jit
    def forced(p, e, l, t):
        return jax.lax.scan(lambda c, tok: jt.decode_step(p, jcfg, tok, c)[::-1],
                            prompt(p, e, l), t)[1]

    jl = np.asarray(forced(jparams, jnp.asarray(emb), jnp.asarray(lens), jnp.asarray(inputs)))
    step = int(np.argmax((ptoks != jtoks).any(0)))
    assert np.array_equal(ptoks[:, :step], jtoks[:, :step])
    for r in np.nonzero(ptoks[:, step] != jtoks[:, step])[0]:
        top = jl[step, r].max()
        assert jl[step, r, ptoks[r, step]] >= top - (2e-3 + 2e-3 * abs(top)), (step, r)


# ── run_tts_pipeline with no env set ─────────────────────────────────────

SCRIPT = "Bonjour à tous, voici un essai.\n[[CHUNK]]\nEt une deuxième phrase."


@pytest.mark.parametrize("family", ["chatterbox", "cosyvoice", "qwen3"])
def test_pipeline_serves_the_noenv_config(monkeypatch, tmp_path, family):
    """A family's engine through ``run_tts_pipeline`` with none of the
    decode knobs set (the f32 cache of the tiny scale, the XLA attention
    branch, slice assignment, ``_qdot``), CPU: a finite WAV of the chunks'
    durations plus the gap; CosyVoice's ``synthesize_stream`` too (the Qwen3
    vocoder narrowed, test side, to 16 base channels). (XTTS's
    GPT-2 decode in these configs is held against JAX in
    ``tests/test_torch_bf16_cache.py``; its pipeline takes the same
    transformer path.)"""
    for k in KNOBS:
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("VOCALIE_MODEL_SCALE", "tiny")
    monkeypatch.setenv("VOCALIE_ALLOW_RANDOM_WEIGHTS", "1")
    # the Qwen3 vocoder narrowed to 16 base channels, as in test_torch_qwen3.py
    monkeypatch.setattr(LMTTSConfig, "vocoder", property(lambda c: VocoderConfig(
        n_mels=c.n_mels, base_channels=16, upsample_rates=(8, 6, 5),
        upsample_kernels=(16, 12, 10))))
    engine = ENGINES[family](device="cpu", assets=tmp_path / "assets")
    lm = engine.runtime().cfg.lm
    assert not (lm.kv_quant or lm.decode_kernel or lm.dense_kernel)
    request = {"tts_backend": family, "script": SCRIPT, "chunks": parse_manual_chunks(SCRIPT)[0],
               "inter_chunk_gap_ms": 250, "target_sr": 24000,
               "out_path": str(tmp_path / "out.wav"), "engine_params": {"temperature": 0.0}}
    if family == "cosyvoice":
        request["engine_params"] = {"engine_id": "cosyvoice_instruct",
                                    "instruct_text": "Parle clairement."}
    if family == "qwen3":
        request["engine_params"] = {"qwen3_mode": "custom_voice", "speaker": "Serena"}
    res = run_tts_pipeline(request, engine=engine)
    wav, sr = read_wav(res.out_path)
    expect = round(sum(res.meta["durations"]) * 24000) + int(24000 * 0.25)
    assert sr == 24000 and len(wav) == expect > 0 and np.isfinite(wav).all()
    if family == "cosyvoice":
        packets = [p for p, _sr in engine.synthesize_stream("Bonjour à tous.",
                                                            engine_id="cosyvoice_instruct",
                                                            instruct_text="Parle clairement.")]
        assert packets and all(len(p) and np.isfinite(p).all() for p in packets)


# ── the bridge ───────────────────────────────────────────────────────────


def test_bridge_keeps_bf16_trees_as_jax_holds_them():
    """A bf16 (non-int8) tree of the bridged LMs (the transformer core with
    every optional leaf of the families; ``cosyvoice_bundle`` around one):
    every leaf in the JAX leaf's dtype (bf16 stays bf16, f32 norms stay
    f32) with the same values."""
    from vocalie_tts_tpu_torch.bridge import cosyvoice_bundle

    rng = np.random.default_rng(8)
    lm = _raw("qwen3", "bfloat16")[1]
    bundle = {"lm": lm, "text_emb": np.asarray(rng.standard_normal((8, 128)), jnp.bfloat16),
              "spk_cond": np.asarray(rng.standard_normal((4, 128)), jnp.bfloat16)}
    pairs = [(_raw("xtts", "bfloat16")[1], tree_to_torch(_raw("xtts", "bfloat16")[1])),
             (bundle, cosyvoice_bundle(bundle, {"t2w": {}})["lm_bundle"])]
    n_bf16 = 0
    for ref_tree, got_tree in pairs:
        refs = jax.tree_util.tree_leaves(ref_tree)
        gots = jax.tree_util.tree_leaves(got_tree)
        assert len(refs) == len(gots)
        for ref, got in zip(refs, gots):
            ref = np.asarray(ref)
            assert str(got.dtype).removeprefix("torch.") == ref.dtype.name
            assert np.array_equal(got.float().numpy(), ref.astype(np.float32))
            n_bf16 += ref.dtype.name == "bfloat16"
    assert n_bf16 > 20
