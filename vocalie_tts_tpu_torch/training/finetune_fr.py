"""FR-overlay fine-tuning of the Chatterbox-class T3 decoder (counterpart of
``vocalie_tts_tpu/training/finetune_fr.py``).

Teacher-forced next-token cross-entropy on [BOS, text bytes, BOS_speech,
speech tokens, EOS_speech] sequences with AdamW, checkpointed as the
``t3_fr`` weight set that ``ChatterboxRuntime.create`` overlays on the T3
stage (``mode="fr_finetune"``). One GPU; the JAX package's dp × tp mesh
waits for ``torch.distributed`` (ROADMAP A8). As in JAX, the epoch runs
the plain softmax attention (``use_flash`` left at False); the flash
kernels' train step is ``parallel.train.make_train_step(...,
use_flash=True)``.

Dataset format: JSONL, one example per line —
    {"text": "<french text>", "speech_tokens": [int, ...]}
speech tokens are codebook ids in [0, 1024); the trainer offsets them into
its mixed [text ‖ core] view (see :func:`to_train_view`).
:func:`synthetic_dataset` serves smoke runs without data.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from vocalie_tts_tpu_torch.device import resolve_device
from vocalie_tts_tpu_torch.models.chatterbox.model import SPEECH_VOCAB, T3Config, init_t3
from vocalie_tts_tpu_torch.models.chatterbox.runtime import SCALES, _scale_from_env
from vocalie_tts_tpu_torch.models.common.weights import (
    checkpoint_exists,
    load_meta,
    load_params,
    save_params,
)
from vocalie_tts_tpu_torch.parallel.train import (
    create_train_state,
    make_optimizer,
    make_train_epoch,
)
from vocalie_tts_tpu_torch.text.frontend import BYTE_VOCAB_SIZE, text_to_byte_ids
from vocalie_tts_tpu_torch.utils.env import bool_env

IGNORE = -100


def example_to_tokens(
    text: str, speech_tokens: List[int], max_len: int,
    text_vocab: int = None, speech_vocab: int = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """(tokens, targets) in the mixed training space — loss on the speech
    span only: text ids [0, text_vocab), LM-core ids at +text_vocab."""
    tv = BYTE_VOCAB_SIZE if text_vocab is None else int(text_vocab)
    sv = SPEECH_VOCAB if speech_vocab is None else int(speech_vocab)
    prompt = text_to_byte_ids(text, add_bos=True, add_eos=False) + [tv + sv]
    speech = [tv + min(max(int(t), 0), sv - 1) for t in speech_tokens]
    seq = (prompt + speech + [tv + sv + 1])[:max_len]
    tokens = np.zeros(max_len, np.int32)
    targets = np.full(max_len, IGNORE, np.int32)
    tokens[: len(seq)] = seq
    # next-token targets, masked to the speech region (prompt is context)
    for i in range(len(prompt) - 1, len(seq) - 1):
        targets[i] = seq[i + 1]
    return tokens, targets


def to_train_view(t3: Dict, cfg: T3Config) -> Dict:
    """LM params over the mixed [text ‖ core] vocabulary: tok_emb rows are
    [text_emb; core tok_emb]; lm_head gains zero text columns (the loss
    never targets text ids, so those columns only absorb
    softmax-denominator gradient)."""
    lm = dict(t3["lm"])
    text_emb = t3["text_emb"].to(lm["tok_emb"].dtype)
    lm["tok_emb"] = torch.cat([text_emb, lm["tok_emb"]], dim=0)
    head = lm["lm_head"]
    lm["lm_head"] = torch.cat(
        [torch.zeros((head.shape[0], cfg.text_vocab), dtype=head.dtype, device=head.device),
         head], dim=1)
    return lm


def from_train_view(lm_mixed: Dict, cfg: T3Config) -> Tuple[Dict, torch.Tensor]:
    """Split the trained mixed view back into (core lm, text_emb)."""
    lm = dict(lm_mixed)
    text_emb = lm["tok_emb"][: cfg.text_vocab]
    lm["tok_emb"] = lm["tok_emb"][cfg.text_vocab :]
    lm["lm_head"] = lm["lm_head"][:, cfg.text_vocab :]
    return lm, text_emb


def load_jsonl(path: Path) -> Iterator[Dict]:
    with open(path, encoding="utf-8") as fh:
        for line in fh:
            line = line.strip()
            if line:
                yield json.loads(line)


def synthetic_dataset(n: int, seed: int = 0) -> Iterator[Dict]:
    """Deterministic toy corpus: each sentence maps to a fixed token
    pattern, so the loss has real structure to learn."""
    rng = np.random.RandomState(seed)
    phrases = [
        "Bonjour et bienvenue.",
        "La séance est ouverte.",
        "Merci de votre attention.",
        "À demain pour la suite.",
    ]
    for i in range(n):
        text = phrases[i % len(phrases)]
        base = (i % len(phrases)) * 17
        length = 24 + int(rng.randint(0, 8))
        yield {
            "text": text,
            "speech_tokens": [(base + 7 * j) % SPEECH_VOCAB for j in range(length)],
        }


def finetune_overlay(
    *,
    assets_dir: Path,
    dataset: Optional[Path] = None,
    steps: int = 100,
    batch_size: int = 8,
    seq_len: int = 128,
    learning_rate: float = 1e-4,
    tp: int = 1,
    n_devices: Optional[int] = None,
    log_every: int = 10,
    log=print,
    device: str | torch.device = "cuda",
) -> Dict[str, float]:
    """Train the FR overlay and save it as the ``t3_fr`` checkpoint.

    Starts from the overlay already saved (``t3_fr``), else the base ``t3``
    weights, else random weights from a seed, and writes ``t3_fr`` next to
    them. The JAX package first drops its resident serving runtimes; the
    port has no process-wide registry of them (a runtime lives as long as
    its caller holds it), so nothing is released here (ROADMAP A5)."""
    if bool_env("VOCALIE_WEIGHT_INT8"):
        raise RuntimeError("unset VOCALIE_WEIGHT_INT8 to fine-tune (int8 is inference-only)")
    if tp > 1 or (n_devices or 1) > 1:
        raise NotImplementedError(
            f"tp={tp}, n_devices={n_devices}: the JAX package trains over a dp x tp mesh; the "
            "port trains on one GPU until torch.distributed is ported (ROADMAP A8)"
        )
    dev = resolve_device(device)
    cfg: T3Config = SCALES[_scale_from_env()]
    weights_dir = Path(assets_dir) / "weights"
    # converted checkpoints define the text/speech id spaces (meta)
    meta = load_meta(weights_dir, "t3")
    cfg = dataclasses.replace(
        cfg,
        text_vocab=int(meta.get("text_vocab", cfg.text_vocab)),
        speech_vocab=int(meta.get("speech_vocab", cfg.speech_vocab)),
    )
    t3 = init_t3(cfg, generator=torch.Generator(device=dev).manual_seed(7), device=dev)
    if checkpoint_exists(weights_dir, "t3_fr"):
        t3 = load_params(weights_dir, "t3_fr", t3, dev)  # resume the overlay
    elif checkpoint_exists(weights_dir, "t3"):
        t3 = load_params(weights_dir, "t3", t3, dev)

    examples = list(load_jsonl(dataset)) if dataset else list(synthetic_dataset(512))
    if not examples:
        raise ValueError("empty dataset")
    pairs = [example_to_tokens(e["text"], e["speech_tokens"], seq_len,
                               text_vocab=cfg.text_vocab, speech_vocab=cfg.speech_vocab)
             for e in examples]
    toks = np.stack([p[0] for p in pairs])
    tgts = np.stack([p[1] for p in pairs])

    train_cfg = dataclasses.replace(cfg.lm, vocab_size=cfg.text_vocab + cfg.speech_vocab + 2)
    optimizer = make_optimizer(learning_rate)
    losses: List[float] = []
    state = create_train_state(to_train_view(t3, cfg), optimizer)
    epoch_fn = make_train_epoch(train_cfg, optimizer)
    rng = np.random.RandomState(42)
    done = 0
    while done < steps:
        k = min(log_every, steps - done)
        idx = rng.randint(0, len(examples), (k, batch_size))
        state, loss_k = epoch_fn(state, torch.from_numpy(toks[idx]).to(dev),
                                 torch.from_numpy(tgts[idx]).to(dev))
        loss_k = loss_k.cpu().numpy()
        if done == 0:
            losses.append(float(loss_k[0]))
        losses.append(float(loss_k[-1]))
        done += k
        log(f"step {done - 1}: loss {losses[-1]:.4f}")

    trained_lm, trained_text_emb = from_train_view(state.params, cfg)
    overlay = dict(t3)
    overlay["lm"] = trained_lm
    overlay["text_emb"] = trained_text_emb
    save_params(weights_dir, "t3_fr", overlay,
                meta={"family": "chatterbox", "stage": "t3_fr_overlay",
                      "text_vocab": cfg.text_vocab,
                      "speech_vocab": cfg.speech_vocab,
                      "steps": steps, "final_loss": losses[-1]})
    return {"first_loss": losses[0], "final_loss": losses[-1], "steps": steps}


__all__ = [
    "finetune_overlay",
    "example_to_tokens",
    "synthetic_dataset",
    "load_jsonl",
    "to_train_view",
    "from_train_view",
]
