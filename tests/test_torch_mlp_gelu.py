"""B9d, the int8 GELU MLP alone (``mlp_gelu_int8_stacked``), and the decode
step that runs it: a GELU MLP with biases under RMSNorm with the dense
kernels on, which the JAX package gives B4 for the qkv and o-projections
and B9d for the MLP (``transformer.py:792-799, :922-941``).

- The plain B9d against the JAX kernel in Pallas interpret mode, on rows
  in f32 and in bf16, with ``VOCALIE_TILE_MB`` unset (one d_ff tile of 512)
  and at 0.125 MiB (two tiles of 256): within 1e-5 · max|ref|, the B9
  tests' bound (``tests/test_torch_decode_dense_gelu.py``). Both sides take
  exact integer products; the two tanh-GELUs differ by a few ulp, so an
  int8 hidden on a .5 tie may round the other way, and a bf16 row's
  activation can sit exactly on one: a row that misses the bound must meet
  it once its tied values round as JAX's do (``_assert_close_up_to_ties``).
- A hidden quantized in one block instead of per d_ff tile lands far
  outside the bound.
- A tiny decode step (d_model 128, two layers, two heads of 64, d_ff 256,
  non-zero biases, f32, int8 weights and cache) against JAX's: prefill and
  teacher-forced logits within 2e-3 + 2e-3 · |ref| up to the dense path's
  ties (``tests/test_torch_dense_step.py::_assert_logits_up_to_ties``),
  through B4 and B9d only.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_decode_attention_whole import numpy_params
from test_torch_dense_step import CACHE_LEN, _assert_logits_up_to_ties, _configs, _run

from vocalie_tts_tpu.models.common import transformer as jt
from vocalie_tts_tpu.ops import decode_dense as jd
from vocalie_tts_tpu_torch.bridge import tree_to_torch
from vocalie_tts_tpu_torch.models.common import transformer as pt
from vocalie_tts_tpu_torch.ops import decode_dense as pd

L, B, D, F = 2, 4, 256, 512


def _inputs(seed):
    """(x, wu, su, bu, wd, sd) with numpy from a seed."""
    rng = np.random.RandomState(seed)
    x = (rng.randn(B, D) * 1.5).astype(np.float32)
    out = [x]
    for d_in, d_out in ((D, F), (F, D)):
        w = rng.randn(L, d_in, d_out).astype(np.float32)
        s = (np.abs(w).max(axis=1, keepdims=True) / 127.0 + 1e-8).astype(np.float32)
        out += [np.clip(np.round(w / s), -127, 127).astype(np.int8), s]
        if d_out == F:
            out.append((0.3 * rng.randn(L, F)).astype(np.float32))
    return out


def _jax_mlp(args, layer, tile_mb, monkeypatch):
    """JAX reads ``VOCALIE_TILE_MB`` while it traces: a fresh trace per
    value."""
    if tile_mb is None:
        monkeypatch.delenv("VOCALIE_TILE_MB", raising=False)
    else:
        monkeypatch.setenv("VOCALIE_TILE_MB", tile_mb)
    jd.mlp_gelu_int8_stacked.clear_cache()
    try:
        return np.asarray(jd.mlp_gelu_int8_stacked(*map(jnp.asarray, args), layer))
    finally:
        jd.mlp_gelu_int8_stacked.clear_cache()


def _assert_close_up_to_ties(got, ref, targs, layer, tile):
    """``got`` within 1e-5 · max|ref| of ``ref``, or, in each row that
    misses, ``got`` is the port's computation of that row and ``ref`` the
    same computation with the int8 values that sit on a .5 tie rounded as
    JAX's. Two kinds: (a) bf16 rows' ``127 · x / amax`` often lands exactly
    on a tie, and the jitted JAX kernel scales by ``amax · (1 / 127)``, an
    ulp from the port's ``amax / 127`` (``tests/test_torch_decode_dense_swiglu.py``):
    every activation that differs from JAX's jitted quantizer must be such
    a tie, one step away; (b) the two tanh-GELUs differ by a few ulp, so an
    int8 hidden within 1e-3 of a tie may round either way: some of the
    row's tied hiddens rounded to their other neighbour must give ``ref``."""
    bound = 1e-5 * np.abs(ref).max()
    bad = np.flatnonzero((np.abs(got - ref) > bound).any(-1))
    if not len(bad):
        return
    x, wu, su, bu, wd, sd = targs
    x = x.float()
    cols = [slice(t * tile, (t + 1) * tile) for t in range(F // tile)]

    def hidden(xq, xs):
        """The hidden / its tile scale, and the tile scales."""
        g = pd.gelu_tanh(pd._int_dot(xq, wu[layer]) * xs * su[layer] + bu[layer])
        scales = [pd._quantize_rows(g[:, c])[1] for c in cols]
        return torch.cat([g[:, c] / s for c, s in zip(cols, scales)], 1).numpy(), scales

    def row(h, scales, r, flip=()):
        q = np.round(h[r])
        flip = list(flip)
        q[flip] = 2 * np.floor(h[r, flip]) + 1 - q[flip]
        qt = torch.from_numpy(q.astype(np.float32))[None]
        return (sum(pd._int_dot(qt[:, c], wd[layer][c]) * s[r:r + 1]
                    for c, s in zip(cols, scales)) * sd[layer]).numpy()[0]

    pq, ps = pd._quantize_rows(x)
    jq, js = (torch.from_numpy(np.array(a)) for a in jax.jit(jd._quantize_rows)(
        jnp.asarray(x.numpy())))
    moved = pq != jq.float()
    steps = (x / js)[moved]
    assert torch.all((pq[moved] - jq.float()[moved]).abs() == 1)
    assert torch.all(((steps - torch.trunc(steps)).abs() - 0.5).abs() < 1e-3)
    h_port, s_port = hidden(pq, ps)
    h_jax, s_jax = hidden(jq.float(), js)
    for r in bad:
        assert np.abs(row(h_port, s_port, r) - got[r]).max() <= bound, f"row {r}"
        ties = np.flatnonzero(np.abs(np.abs(h_jax[r] - np.trunc(h_jax[r])) - 0.5) < 1e-3)
        assert len(ties) <= 8, f"row {r}: {len(ties)} ties"
        assert any(np.abs(row(h_jax, s_jax, r, sub) - ref[r]).max() <= bound
                   for k in range(len(ties) + 1) for sub in itertools.combinations(ties, k)), \
            f"row {r} misses by more than its ties explain"


@pytest.mark.parametrize("rows", ["float32", "bfloat16"])
@pytest.mark.parametrize("tile_mb,tile", [(None, 512), ("0.125", 256)])
def test_mlp_gelu_matches_jax(monkeypatch, rows, tile_mb, tile):
    args = _inputs(7)
    layer = 1
    if rows == "bfloat16":
        args[0] = np.asarray(jnp.asarray(args[0], jnp.bfloat16))
    ref = _jax_mlp(args, layer, tile_mb, monkeypatch)
    targs = [torch.from_numpy(np.asarray(a, np.float32) if a.dtype != np.int8 else a)
             for a in args]
    if rows == "bfloat16":
        targs[0] = targs[0].to(torch.bfloat16)
    assert pd._ff_tile(D, F, 0) == tile
    got = pd.mlp_gelu_int8_stacked(*targs, layer)
    assert got.dtype == torch.float32 and got.shape == (B, D)
    _assert_close_up_to_ties(got.numpy(), ref, targs, layer, tile)


def test_mlp_gelu_one_block_hidden_is_caught(monkeypatch):
    """Two tiles: quantizing the whole 512-wide hidden with one scale (not
    one per 256-column tile) is the trap; it lands far outside 1e-5."""
    args = _inputs(8)
    ref = _jax_mlp(args, 0, "0.125", monkeypatch)
    wrong = pd.mlp_gelu_int8_plain(*map(torch.from_numpy, args), 0, tile=F)
    assert np.abs(wrong.numpy() - ref).max() / np.abs(ref).max() > 100 * 1e-5


def test_gelu_rms_bias_decode_takes_b4_and_b9d(monkeypatch):
    """A GELU MLP with biases under RMSNorm (biases non-zero, the tree of
    JAX's ``init_params`` for the config) has no
    fused tail: B4 for the qkv and o-projections, B9d for the MLP plus the
    caller's ``b_down``. Teacher-forced logits within 2e-3 up to ties."""
    monkeypatch.delenv("VOCALIE_TILE_MB", raising=False)
    dims = dict(mlp_type="gelu", bias=True, norm_type="rms")
    jcfg, pcfg = _configs(dict(kv_quant=True, decode_kernel=True, dense_kernel=True), **dims)
    raw = numpy_params(jcfg, 62)
    assert "w_gate" not in raw["layers"] and "mlp_norm_b" not in raw["layers"]
    jparams = jt.fuse_decode_weights(jax.device_get(jax.jit(jt.quantize_weights_int8)(raw)))
    pparams = pt.fuse_decode_weights(pt.quantize_weights_int8(tree_to_torch(raw)))
    assert pt._dense_dispatch(pparams["layers"], pcfg, 4, CACHE_LEN) == pt.DENSE_FNS
    calls = {"dense": 0, "mlp": 0}
    dense, mlp = pt.dense_int8_stacked, pt.mlp_gelu_int8_stacked
    monkeypatch.setattr(pt, "dense_int8_stacked",
                        lambda *a, **k: calls.__setitem__("dense", calls["dense"] + 1)
                        or dense(*a, **k))
    monkeypatch.setattr(pt, "mlp_gelu_int8_stacked",
                        lambda *a, **k: calls.__setitem__("mlp", calls["mlp"] + 1) or mlp(*a, **k))
    n_steps = 3
    pairs, _, pcache = _run(jcfg, jparams, pcfg, pparams, n_steps=n_steps)
    _assert_logits_up_to_ties(pairs)
    assert pcache.n_decoded == n_steps
    # per step: the head, and qkv + o per layer; prefill: the head
    assert calls == {"dense": 1 + n_steps * (1 + 2 * pcfg.n_layers),
                     "mlp": n_steps * pcfg.n_layers}
