"""Param trees from the JAX package → torch.

Takes the JAX tree after ``jax.device_get`` (numpy leaves) and returns
the same tree with torch tensors: keys unchanged, the stacked ``[L, …]``
layer axis and the ``x @ W`` layout kept, int8 ``{"q","s"}`` leaves kept
int8 with their scales, bfloat16 leaves (numpy ``ml_dtypes``) kept
bfloat16. Conv kernels keep the JAX ``[kernel, c_in, c_out]`` / HWIO
``[k, k, c_in, c_out]`` layout; the modules that use them re-lay them out
internally. The AudioSR tree (``init_audiosr``: lists of blocks, HWIO
convs, int8 ``{"w_q", "w_s", "b"}`` conv leaves after
``quantize_unet_convs``) goes across with ``tree_to_torch`` as it is.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch


def to_torch(leaf: Any, device="cpu") -> torch.Tensor:
    arr = np.asarray(leaf)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.astype(np.float32)).to(device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(arr, copy=True)).to(device)


def tree_to_torch(tree: Any, device="cpu") -> Any:
    """Map every array leaf of nested dicts/lists/tuples to a tensor."""
    if isinstance(tree, dict):
        return {k: tree_to_torch(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_to_torch(v, device) for v in tree)
    if tree is None:
        return None
    return to_torch(tree, device)


def cosyvoice_bundle(lm_bundle: Any, decoder: Any, device="cpu") -> Any:
    """The CosyVoice runtime's params from the JAX trees of
    ``init_cosyvoice_lm`` (``lm`` with its q/k/v biases ``bq``/``bk``/``bv``,
    ``text_emb``, ``spk_cond``) and ``init_cfm_decoder`` (``t2w``), before
    any runtime transform: ``{"lm_bundle": ..., "decoder": {"t2w": ...}}``.
    The decoder's ``speaker`` encoder is skipped: the port has no speaker
    encoder yet, and without a voice reference the JAX runtime does not run
    it either (zero speaker embeddings)."""
    lm = {k: lm_bundle[k] for k in ("lm", "text_emb", "spk_cond")}
    return {"lm_bundle": tree_to_torch(lm, device),
            "decoder": {"t2w": tree_to_torch(decoder["t2w"], device)}}


def xtts_bundle(gpt: Any, decoder: Any, device="cpu") -> Any:
    """The XTTS runtime's params from the JAX trees of ``init_xtts`` (``lm``
    with its GPT-2 leaves, ``text_emb``, ``text_pos``, ``cond_proj``,
    ``cond_bias``) and ``init_vq_decoder`` (stage 2 and the speaker
    encoder), before any runtime transform: ``{"gpt": ..., "decoder": ...}``."""
    return {"gpt": tree_to_torch(gpt, device), "decoder": tree_to_torch(decoder, device)}


def lmtts_bundle(lm_bundle: Any, decoder: Any, device="cpu") -> Any:
    """The Qwen3-class runtime's params from the JAX trees of ``init_lmtts``
    (``lm`` with its per-head ``q_norm`` / ``k_norm`` leaves, ``text_emb``,
    ``speaker_table``, ``spk_cond``, ``lang_cond``) and ``init_codec_decoder``
    (``tok_emb``, ``up1``, ``up2``, ``mel_out``, ``vocoder``, ``speaker``),
    before any runtime transform: ``{"lm_bundle": ..., "decoder": ...}``."""
    return {"lm_bundle": tree_to_torch(lm_bundle, device),
            "decoder": tree_to_torch(decoder, device)}


def vits_params(tree: Any, device="cpu") -> Any:
    """The VITS runtime's params from the JAX tree of ``init_vits`` (numpy
    leaves): the same keys and lists (``enc_layers``, ``dp.flows``,
    ``dp.convs.layers``, ``flows``, the vocoder's ``ups`` and
    ``resblocks[stage][kernel]``), the ``[k, c_in, c_out]`` convs and the
    depthwise ``sep.w [k, 1, c]`` kept as they are (``models/vits/model.py``
    re-lays them out inside its convs), and the relative embeddings ``[1,
    2w + 1, d_head]``. Raises ``ValueError`` on a depthwise kernel of
    another layout."""
    for i, lyr in enumerate(tree["dp"]["convs"]["layers"]
                            + [l for f in tree["dp"]["flows"] for l in f["convs"]["layers"]]):
        shape = np.shape(lyr["sep"]["w"])
        if len(shape) != 3 or shape[1] != 1 or shape[2] != np.shape(lyr["sep"]["b"])[0]:
            raise ValueError(f"DDSConv layer {i}: sep.w {shape} is not [k, 1, c]")
    return tree_to_torch(tree, device)


__all__ = ["to_torch", "tree_to_torch", "cosyvoice_bundle", "xtts_bundle", "lmtts_bundle",
           "vits_params"]
