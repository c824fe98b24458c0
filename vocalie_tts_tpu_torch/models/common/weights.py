"""Weight persistence: the JAX package's ``.npz`` + ``meta.json`` format
(counterpart of ``vocalie_tts_tpu/models/common/weights.py``).

Keys are the param tree's paths joined by "/" (dict keys, list
indices); bfloat16 leaves are stored widened to f32 and cast back to the
template's dtype on load, so a checkpoint saved by the JAX package loads
here, and one saved here loads there.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict, Iterator, Tuple

import numpy as np
import torch

_META_NAME = "meta.json"


def tree_items(tree: Any, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """``(path, leaf)`` of nested dicts and lists, depth first in order;
    paths join the keys and indices with "/" (the checkpoints' keys)."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from tree_items(v, f"{prefix}{k}/")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from tree_items(v, f"{prefix}{i}/")
    else:
        yield prefix[:-1], tree


def _unflatten_like(tree: Any, values: Dict[str, Any], prefix: str = "") -> Any:
    if isinstance(tree, dict):
        return {k: _unflatten_like(v, values, f"{prefix}{k}/") for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_unflatten_like(v, values, f"{prefix}{i}/") for i, v in enumerate(tree))
    return values[prefix[:-1]]


def load_params(weights_dir: Path, name: str, template: Any, device="cpu") -> Any:
    """Load checkpoint ``name`` into the structure, shapes and dtypes of
    *template* (a tree of tensors). Keys the template lacks are ignored."""
    path = Path(weights_dir) / f"{name}.npz"
    data = np.load(path)
    values = {}
    for key, leaf in tree_items(template):
        if key not in data.files:
            raise ValueError(f"checkpoint {path} is missing key {key!r}")
        raw = data[key]
        if raw.dtype.kind == "V" and raw.dtype.itemsize == 2:
            raise ValueError(f"{key}: legacy raw-bfloat16 entry; re-save with the JAX package")
        t = torch.from_numpy(np.ascontiguousarray(raw)).to(device=device, dtype=leaf.dtype)
        if tuple(t.shape) != tuple(leaf.shape):
            raise ValueError(f"{key}: shape {tuple(t.shape)} != template {tuple(leaf.shape)}")
        values[key] = t
    return _unflatten_like(template, values)


def save_params(weights_dir: Path, name: str, params: Any, meta: Dict | None = None) -> Path:
    """Write ``<weights_dir>/<name>.npz`` and its ``meta.json`` entry. int8
    and fused trees are runtime views of a full-precision tree and are
    refused, as the JAX package refuses them."""
    flat = {}
    for key, leaf in tree_items(params):
        if "wqkv" in key or "w_gateup" in key:
            raise RuntimeError(f"refusing to save fused decode weights ({key})")
        if leaf.dtype == torch.int8:
            raise RuntimeError(f"refusing to save int8-quantized weights ({key})")
        t = leaf.detach().cpu()
        flat[key] = (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    weights_dir = Path(weights_dir)
    weights_dir.mkdir(parents=True, exist_ok=True)
    path = weights_dir / f"{name}.npz"
    np.savez(path, **flat)
    meta_path = weights_dir / _META_NAME
    all_meta = {}
    if meta_path.exists():
        try:
            all_meta = json.loads(meta_path.read_text(encoding="utf-8"))
        except json.JSONDecodeError:
            all_meta = {}
    all_meta[name] = dict(meta or {})
    meta_path.write_text(json.dumps(all_meta, indent=2) + "\n", encoding="utf-8")
    return path


def check_saveable(tree: Any) -> None:
    """int8 weight trees are a runtime-only form: refused before anything is
    written, as in JAX."""
    for _key, leaf in tree_items(tree):
        if isinstance(leaf, torch.Tensor) and leaf.dtype == torch.int8:
            raise RuntimeError("refusing to save int8-quantized weights; unset "
                               "VOCALIE_WEIGHT_INT8 and re-create the runtime to save")


def checkpoint_exists(weights_dir: Path, name: str) -> bool:
    return (Path(weights_dir) / f"{name}.npz").exists()


def load_meta(weights_dir: Path, name: str) -> Dict:
    meta_path = Path(weights_dir) / _META_NAME
    if not meta_path.exists():
        return {}
    try:
        all_meta = json.loads(meta_path.read_text(encoding="utf-8"))
    except json.JSONDecodeError:
        return {}
    entry = all_meta.get(name)
    return dict(entry) if isinstance(entry, dict) else {}


__all__ = [
    "tree_items",
    "load_params",
    "save_params",
    "check_saveable",
    "checkpoint_exists",
    "load_meta",
]
