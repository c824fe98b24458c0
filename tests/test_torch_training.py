"""The T3 fine-tune path of the port against the JAX package, at the tiny
T3 (f32, 2 layers, 4 q / 2 kv heads of 16) in its mixed [text ‖ core]
training view: ``example_to_tokens``, ``to_train_view`` /
``from_train_view``, ``forward_all_logits`` with the f32 softmax attention
and with the flash kernels' plain versions (JAX: Pallas in interpret mode),
``loss_fn`` and its gradients per leaf, AdamW against optax, and
``finetune_overlay`` from one JAX-saved base against JAX's
``finetune_overlay(n_devices=1, tp=1)``; then the port's runtime serving the
port's overlay, ``save_weights``, and the refusals.

Tolerances. Logits and gradients per leaf within 1e-5 · max|ref| (f32 on
both sides, only the summation orders differ; measured <= 2e-6). AdamW
against optax on identical inputs within 1e-6 in f32 (measured one f32 ulp)
and equal in bf16. The fine-tune: losses within 1e-4 relative. Trained
parameters are held separately, because Adam's first steps move each
element by about ``lr · sign(g)``: where a gradient sits at the two
libraries' rounding noise, its sign, and so the update, can flip. So each
leaf of the saved ``t3_fr`` is within 2e-5 of JAX's (measured <= 9.1e-6 at
lr 3e-3) except on at most 0.1 % of its elements, and those within
2 · lr · steps (a flip on every step).
"""

import dataclasses
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vocalie_tts_tpu.models.chatterbox.model import init_t3 as jax_init_t3
from vocalie_tts_tpu.models.chatterbox.runtime import SCALES as JAX_SCALES
from vocalie_tts_tpu.models.common.transformer import forward_all_logits as jax_forward
from vocalie_tts_tpu.models.common.weights import load_params as jax_load_params
from vocalie_tts_tpu.models.common.weights import save_params as jax_save_params
from vocalie_tts_tpu.parallel import train as jax_train
from vocalie_tts_tpu.training import finetune_fr as jax_ft
from vocalie_tts_tpu_torch.bridge import tree_to_torch
from vocalie_tts_tpu_torch.models.chatterbox.runtime import SCALES, ChatterboxRuntime
from vocalie_tts_tpu_torch.models.common.transformer import (
    forward_all_logits,
    unfuse_decode_weights,
)
from vocalie_tts_tpu_torch.parallel import train
from vocalie_tts_tpu_torch.training import finetune_fr as ft

LR, STEPS = 3e-3, 6


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _leaf(tree, path):
    for key in path.split("/"):
        tree = tree[key]
    return tree.float().numpy() if isinstance(tree, torch.Tensor) else np.asarray(tree, np.float32)


def _init_t3(seed):
    """The JAX package's tiny ``init_t3`` (jitted: one compile, not one per op)."""
    return jax.device_get(jax.jit(jax_init_t3, static_argnums=1)(jax.random.PRNGKey(seed),
                                                                  JAX_SCALES["tiny"]))


def _paths(tree, prefix=""):
    for key, val in tree.items():
        if isinstance(val, dict):
            yield from _paths(val, f"{prefix}{key}/")
        else:
            yield prefix + key


@pytest.fixture(scope="module")
def views():
    """The tiny T3 (JAX init, bridged) in both packages' training views, and a
    batch of 4 synthetic examples at seq_len 64."""
    jcfg, cfg = JAX_SCALES["tiny"], SCALES["tiny"]
    t3 = _init_t3(3)
    jax_lm = jax_ft.to_train_view(t3, jcfg)
    lm = ft.to_train_view(tree_to_torch(t3), cfg)
    vocab = cfg.text_vocab + cfg.speech_vocab + 2
    pairs = [ft.example_to_tokens(e["text"], e["speech_tokens"], 64)
             for e in list(ft.synthetic_dataset(4))]
    tokens = np.stack([p[0] for p in pairs])
    targets = np.stack([p[1] for p in pairs])
    return dict(t3=t3, jcfg=jcfg, cfg=cfg, jax_lm=jax_lm, lm=lm, tokens=tokens, targets=targets,
                jax_train_cfg=dataclasses.replace(jcfg.lm, vocab_size=vocab),
                train_cfg=dataclasses.replace(cfg.lm, vocab_size=vocab))


def test_tokens_and_train_views_match_jax(views):
    for e in list(ft.synthetic_dataset(6)) + [{"text": "Été", "speech_tokens": [5, -3, 4000]}]:
        for max_len in (16, 64):
            ours = ft.example_to_tokens(e["text"], e["speech_tokens"], max_len)
            ref = jax_ft.example_to_tokens(e["text"], e["speech_tokens"], max_len)
            for a, b in zip(ours, ref):
                assert a.dtype == b.dtype and np.array_equal(a, b)
    for path in _paths(views["jax_lm"]):
        assert np.array_equal(_leaf(views["lm"], path), _leaf(views["jax_lm"], path)), path
    lm, text_emb = ft.from_train_view(views["lm"], views["cfg"])
    jax_lm, jax_text = jax_ft.from_train_view(views["jax_lm"], views["jcfg"])
    assert np.array_equal(text_emb.numpy(), np.asarray(jax_text))
    for path in _paths(jax_lm):
        assert np.array_equal(_leaf(lm, path), _leaf(jax_lm, path)), path


@pytest.mark.parametrize("use_flash", [False, True], ids=["xla_attention", "flash"])
def test_logits_loss_and_grads_match_jax(views, use_flash):
    tokens, targets = views["tokens"], views["targets"]
    jcfg, cfg = views["jax_train_cfg"], views["train_cfg"]

    @jax.jit
    def jax_side(lm):
        logits = jax_forward(lm, jcfg, jnp.asarray(tokens), use_flash=use_flash)
        loss, grads = jax.value_and_grad(lambda p: jax_train.loss_fn(
            p, jcfg, jnp.asarray(tokens), jnp.asarray(targets), use_flash=use_flash))(lm)
        return logits, loss, grads

    ref_logits, ref_loss, ref_grads = jax.device_get(jax_side(views["jax_lm"]))
    with torch.no_grad():
        logits = forward_all_logits(views["lm"], cfg, torch.from_numpy(tokens),
                                    use_flash=use_flash)
    assert logits.dtype == torch.float32 and logits.shape == ref_logits.shape
    assert np.abs(logits.numpy() - ref_logits).max() <= 1e-5 * np.abs(ref_logits).max()
    loss, grads = train.value_and_grad(views["lm"], cfg, torch.from_numpy(tokens),
                                       torch.from_numpy(targets), use_flash=use_flash)
    assert abs(float(loss) - float(ref_loss)) <= 1e-5 * abs(float(ref_loss))
    for path in _paths(ref_grads):
        g, r = _leaf(grads, path), _leaf(ref_grads, path)
        assert np.abs(g - r).max() <= 1e-5 * np.abs(r).max(), path


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16], ids=["f32", "bf16"])
def test_adamw_matches_optax(dtype):
    """Three steps of the port's AdamW and of ``make_optimizer``'s optax
    adamw on the same params and grads (jitted, as the trainer runs it)."""
    rng = np.random.default_rng(0)
    shapes = {"w": (64, 96), "n": {"b": (300,)}}

    def draw(scale):
        return jax.tree_util.tree_map(
            lambda shp: jnp.asarray(rng.standard_normal(shp).astype(np.float32) * scale
                                    ).astype(dtype),
            shapes, is_leaf=lambda x: isinstance(x, tuple))

    jp = draw(0.03)
    tp = tree_to_torch(jax.device_get(jp))
    jopt, opt = jax_train.make_optimizer(1e-3), train.make_optimizer(1e-3)
    js, ts = jopt.init(jp), opt.init(tp)
    update, apply = jax.jit(jopt.update), jax.jit(optax.apply_updates)
    for _ in range(3):
        jg = draw(1e-2)
        u, js = update(jg, js, jp)
        jp = apply(jp, u)
        tu, ts = opt.update(tree_to_torch(jax.device_get(jg)), ts, tp)
        tp = train.apply_updates(tp, tu)
        for path in _paths(jp):
            got, ref = _leaf(tp, path), np.asarray(_leaf(jp, path))
            if dtype == jnp.float32:
                assert np.abs(got - ref).max() <= 1e-6, path
            else:
                assert np.array_equal(got, ref), path
    assert ts.count == 3 and ts.mu["w"].dtype == tp["w"].dtype


@pytest.fixture(scope="module")
def finetuned(tmp_path_factory):
    """One JAX-saved tiny base ``t3``, fine-tuned by both packages (6 steps,
    batch 4, seq_len 64, lr 3e-3, two epochs of 3)."""
    root = tmp_path_factory.mktemp("finetune")
    jcfg = JAX_SCALES["tiny"]
    base = root / "base"
    jax_save_params(base / "weights", "t3", _init_t3(5),
                    meta={"family": "chatterbox", "stage": "t3",
                          "text_vocab": jcfg.text_vocab, "speech_vocab": jcfg.speech_vocab})
    kw = dict(steps=STEPS, batch_size=4, seq_len=64, learning_rate=LR, log_every=3,
              log=lambda *_: None)
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("VOCALIE_MODEL_SCALE", "tiny")
        mp.delenv("VOCALIE_WEIGHT_INT8", raising=False)
        for side in ("jax", "port"):
            shutil.copytree(base, root / side)
        out["jax"] = jax_ft.finetune_overlay(assets_dir=root / "jax", n_devices=1, tp=1, **kw)
        out["port"] = ft.finetune_overlay(assets_dir=root / "port", device="cpu", **kw)
    out["root"] = root
    return out


def test_finetune_overlay_matches_jax(finetuned):
    for key in ("first_loss", "final_loss"):
        ref = finetuned["jax"][key]
        assert abs(finetuned["port"][key] - ref) <= 1e-4 * abs(ref), key
    assert finetuned["port"]["final_loss"] < finetuned["port"]["first_loss"]
    root = finetuned["root"]
    ours = np.load(root / "port" / "weights" / "t3_fr.npz")
    ref = np.load(root / "jax" / "weights" / "t3_fr.npz")
    base = np.load(root / "base" / "weights" / "t3.npz")
    assert set(ours.files) <= set(ref.files)
    for key in ours.files:
        diff = np.abs(ours[key] - ref[key])
        off = diff > 2e-5
        assert off.sum() <= 1e-3 * diff.size and np.all(diff <= 2 * LR * STEPS), key
    # the trained leaves moved; the conditioning slots are not trained
    assert np.abs(ours["lm/layers/wq"] - base["lm/layers/wq"]).max() > LR
    assert np.array_equal(ours["spk_cond"], base["spk_cond"])


def test_runtime_serves_the_port_overlay(finetuned, monkeypatch):
    """``ChatterboxRuntime.create`` overlays the saved ``t3_fr`` (fused for
    serving) and serves it in ``fr_finetune`` mode."""
    monkeypatch.setenv("VOCALIE_MODEL_SCALE", "tiny")
    rt = ChatterboxRuntime.create(finetuned["root"] / "port", device="cpu")
    saved = np.load(finetuned["root"] / "port" / "weights" / "t3_fr.npz")
    q_dim = rt.cfg.lm.q_dim
    fr_wqkv = rt.params["t3_fr"]["lm"]["layers"]["wqkv"].numpy()
    assert np.array_equal(fr_wqkv[..., :q_dim], saved["lm/layers/wq"])
    assert not np.array_equal(rt.params["t3"]["lm"]["layers"]["wqkv"].numpy(), fr_wqkv)
    audio, sr, meta = rt.synthesize("Bonjour.", mode="fr_finetune", temperature=0.0,
                                    cfg_weight=0.0)
    assert meta["mode"] == "fr_finetune" and sr == rt.cfg.sample_rate
    assert len(audio) > 0 and np.all(np.isfinite(audio))


def test_runtime_save_weights_loads_in_jax(tmp_path, monkeypatch):
    """``save_weights`` writes the unfused ``t3`` that the JAX package's
    ``load_params`` reads into its own ``init_t3`` tree; int8 is refused."""
    monkeypatch.setenv("VOCALIE_MODEL_SCALE", "tiny")
    monkeypatch.delenv("VOCALIE_WEIGHT_INT8", raising=False)
    rt = ChatterboxRuntime.create(tmp_path, force_init=True, device="cpu")
    rt.save_weights()
    loaded = jax.device_get(jax_load_params(
        tmp_path / "weights", "t3", _init_t3(0)))
    ours = {**rt.params["t3"], "lm": unfuse_decode_weights(rt.params["t3"]["lm"], rt.cfg.lm)}
    for path in _paths(loaded):
        assert np.array_equal(_leaf(loaded, path), _leaf(ours, path)), path
    monkeypatch.setenv("VOCALIE_WEIGHT_INT8", "1")
    with pytest.raises(RuntimeError, match="int8"):
        ChatterboxRuntime.create(tmp_path, force_init=True, device="cpu").save_weights()


def test_refusals(tmp_path, monkeypatch, views):
    monkeypatch.setenv("VOCALIE_MODEL_SCALE", "tiny")
    monkeypatch.setenv("VOCALIE_WEIGHT_INT8", "1")
    with pytest.raises(RuntimeError, match="VOCALIE_WEIGHT_INT8"):
        ft.finetune_overlay(assets_dir=tmp_path, steps=1, device="cpu")
    monkeypatch.delenv("VOCALIE_WEIGHT_INT8")
    for kw in ({"tp": 2}, {"n_devices": 2}):
        with pytest.raises(NotImplementedError, match="A8"):
            ft.finetune_overlay(assets_dir=tmp_path, steps=1, device="cpu", **kw)
    with pytest.raises(NotImplementedError, match="A8"):
        train.loss_fn(views["lm"], views["train_cfg"], torch.from_numpy(views["tokens"]),
                      torch.from_numpy(views["targets"]), mesh=object())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ft.finetune_overlay(assets_dir=tmp_path, steps=1)
    assert not (tmp_path / "weights" / "t3_fr.npz").exists()
