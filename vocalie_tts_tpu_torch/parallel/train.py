"""The T3 train step on one GPU (counterpart of
``vocalie_tts_tpu/parallel/train.py``).

Teacher-forced next-token cross-entropy with AdamW in optax's arithmetic.
The JAX package jits the step over a (dp × tp) mesh
(``make_sharded_train_step``, ``make_sharded_train_epoch``); their
one-device counterparts here are :func:`make_train_step` and
:func:`make_train_epoch`. The sharded ones wait for ``torch.distributed``
(ROADMAP A8).

Param trees are nested dicts of tensors (the unfused tree of
``transformer.init_params``). A step builds new parameter and moment
tensors and returns a new :class:`TrainState`; the old state's tensors are
freed when the caller drops it (JAX donates them).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional

import numpy as np
import torch

from vocalie_tts_tpu_torch.models.common.transformer import TransformerConfig, forward_all_logits
from vocalie_tts_tpu_torch.models.common.weights import tree_items

Params = Dict[str, Any]


def tree_map(fn: Callable, tree: Params, *rest: Params) -> Params:
    """``fn`` over the leaves of nested dicts with the same keys."""
    return {k: (tree_map(fn, v, *(r[k] for r in rest)) if isinstance(v, dict)
                else fn(v, *(r[k] for r in rest)))
            for k, v in tree.items()}


class AdamWState(NamedTuple):
    count: int          # steps taken (optax's ``count``)
    mu: Params          # first moments, in each parameter's dtype
    nu: Params          # second moments, in each parameter's dtype


class TrainState(NamedTuple):
    params: Params
    opt_state: AdamWState
    step: int


class AdamW:
    """``optax.adamw(learning_rate, b1, b2, eps, weight_decay=...)`` in
    optax's arithmetic (``scale_by_adam`` → ``add_decayed_weights`` →
    ``scale_by_learning_rate``), not ``torch.optim.AdamW``'s, whose decay
    multiplies the parameter before the Adam step. Per leaf, in the leaf's
    dtype (each Python constant rounded to it first, as JAX's weak types
    are):

        mu = (1 - b1)·g + b1·mu;  nu = (1 - b2)·g² + b2·nu
        u  = (mu / c1) / (sqrt(nu / c2) + eps),  c_i = 1 - b_i^count in f32
        u  = -lr · (u + wd·p);  p ← (p + u) rounded to p's dtype
    """

    def __init__(self, learning_rate: float, b1: float = 0.9, b2: float = 0.95,
                 eps: float = 1e-8, weight_decay: float = 0.01) -> None:
        self.learning_rate = learning_rate
        self.b1, self.b2, self.eps, self.weight_decay = b1, b2, eps, weight_decay

    def init(self, params: Params) -> AdamWState:
        return AdamWState(count=0, mu=tree_map(torch.zeros_like, params),
                          nu=tree_map(torch.zeros_like, params))

    def update(self, grads: Params, state: AdamWState, params: Params):
        """``(updates, new_state)``, as ``optax.GradientTransformation.update``."""
        count = state.count + 1
        # optax: 1 - decay ** count in f32 (weak decay, int32 count), then
        # cast to the moment's dtype
        c1 = float(np.float32(1) - np.float32(self.b1) ** np.float32(count))
        c2 = float(np.float32(1) - np.float32(self.b2) ** np.float32(count))

        consts = {}

        def const(x, like):
            # one 0-dim tensor per constant, dtype and device in an update,
            # made by a fill on the device: torch.tensor(x, device=...) is a
            # pageable host-to-device copy that waits for the stream
            key = (x, like.dtype, like.device)
            if key not in consts:
                consts[key] = torch.full((), torch.tensor(x, dtype=like.dtype).item(),
                                         dtype=like.dtype, device=like.device)
            return consts[key]

        mu = tree_map(lambda g, m: const(1 - self.b1, g) * g + const(self.b1, g) * m,
                      grads, state.mu)
        nu = tree_map(lambda g, v: const(1 - self.b2, g) * (g * g) + const(self.b2, g) * v,
                      grads, state.nu)

        def step(m, v, p):
            u = (m / const(c1, m)) / (torch.sqrt(v / const(c2, v)) + const(self.eps, v))
            u = u + const(self.weight_decay, p) * p
            return const(-self.learning_rate, u) * u

        return tree_map(step, mu, nu, params), AdamWState(count=count, mu=mu, nu=nu)


def apply_updates(params: Params, updates: Params) -> Params:
    """``optax.apply_updates``: ``p + u`` rounded to p's dtype."""
    return tree_map(lambda p, u: (p + u).to(p.dtype), params, updates)


def make_optimizer(learning_rate: float = 1e-4, weight_decay: float = 0.01) -> AdamW:
    """AdamW with b1 0.9, b2 0.95, eps 1e-8 (JAX ``make_optimizer``)."""
    return AdamW(learning_rate, b1=0.9, b2=0.95, weight_decay=weight_decay)


def create_train_state(params: Params, optimizer: Optional[AdamW] = None) -> TrainState:
    optimizer = optimizer or make_optimizer()
    return TrainState(params=params, opt_state=optimizer.init(params), step=0)


def loss_fn(params: Params, cfg: TransformerConfig, tokens: torch.Tensor,
            targets: torch.Tensor, *, use_flash: bool = False, mesh=None) -> torch.Tensor:
    """Masked mean NLL of the f32 log-softmax over ``[b, s]`` next-token
    ``targets`` (-100 = ignored)."""
    logits = forward_all_logits(params, cfg, tokens, use_flash=use_flash, mesh=mesh)
    valid = targets >= 0
    safe = torch.where(valid, targets, 0).long()
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, safe[..., None])[..., 0]
    return torch.sum(nll * valid) / torch.clamp(valid.sum(), min=1)


def value_and_grad(params: Params, cfg: TransformerConfig, tokens: torch.Tensor,
                   targets: torch.Tensor, *, use_flash: bool = False):
    """``(loss, grads)`` of :func:`loss_fn` (``jax.value_and_grad``); the
    grads have the params' tree, dtypes and devices."""
    live = tree_map(lambda t: t.detach().requires_grad_(True), params)
    with torch.enable_grad():
        loss = loss_fn(live, cfg, tokens, targets, use_flash=use_flash)
        grads = iter(torch.autograd.grad(loss, [t for _, t in tree_items(live)],
                                         allow_unused=True))

    def grad_of(t):   # the leaves in tree_items' order; None: the loss does not use it
        g = next(grads)
        return torch.zeros_like(t) if g is None else g

    return loss.detach(), tree_map(grad_of, live)


def make_train_step(cfg: TransformerConfig, optimizer: Optional[AdamW] = None, *,
                    use_flash: bool = False):
    """``train_step(state, tokens, targets) -> (state, loss)`` on one device
    (the counterpart of ``make_sharded_train_step``; the dp × tp one waits
    for A8). ``use_flash`` runs the flash kernels forward (B6t) and
    backward (B11)."""
    optimizer = optimizer or make_optimizer()

    def train_step(state: TrainState, tokens: torch.Tensor, targets: torch.Tensor):
        loss, grads = value_and_grad(state.params, cfg, tokens, targets, use_flash=use_flash)
        with torch.no_grad():
            updates, opt_state = optimizer.update(grads, state.opt_state, state.params)
            params = apply_updates(state.params, updates)
        return TrainState(params, opt_state, state.step + 1), loss

    return train_step


def make_train_epoch(cfg: TransformerConfig, optimizer: Optional[AdamW] = None, *,
                     use_flash: bool = False):
    """``epoch(state, tokens_k, targets_k) -> (state, losses [K])``: K steps
    over ``[K, b, s]`` batches (the counterpart of
    ``make_sharded_train_epoch``'s ``lax.scan``; the dp × tp one waits for
    A8)."""
    step = make_train_step(cfg, optimizer, use_flash=use_flash)

    def epoch(state: TrainState, tokens_k: torch.Tensor, targets_k: torch.Tensor):
        losses = []
        for i in range(tokens_k.shape[0]):
            state, loss = step(state, tokens_k[i], targets_k[i])
            losses.append(loss)
        return state, torch.stack(losses)

    return epoch


__all__ = [
    "TrainState",
    "AdamW",
    "AdamWState",
    "apply_updates",
    "loss_fn",
    "value_and_grad",
    "make_optimizer",
    "create_train_state",
    "make_train_step",
    "make_train_epoch",
    "tree_map",
]
