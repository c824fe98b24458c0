"""The training path's attention: the port's plain ``flash_attention_trainable``
(B6t's plain forward with the logsumexp, B11's plain backward) against the JAX
package's ``flash_attention_trainable`` (the Pallas forward with lse and the
Pallas dKV/dQ kernels of its custom VJP, in interpret mode as the JAX tests
run them on the CPU), through ``jax.vjp``: the output, the lse, dq, dk and dv.
Causal and not, s of 100 and 200 (off the 128-row tile), GQA 4/2, d 16, 64
and 128.

Tolerances, against max|ref| of each output: f32 1e-5 (only the summation
orders differ; measured here, JAX's Pallas against its XLA attention differs
by ~1e-6 at [2, 4, 100, 16]); lse 1e-5 + 1e-5·|ref|. bf16 1e-2 (measured
<= 5.5e-3: every output is rounded to bf16, one step is 2^-8 of the value,
and with GQA JAX sums the group's rounded dK/dV in bf16 where the port sums
in f32 and rounds once). The plain backward is also held against
``torch.autograd`` of the port's ``reference_attention`` (f32, 1e-5).

The CUDA kernels' body choice (``flash_bwd_body``) and their counters on
CPU calls are checked here too, and the tensor-core body's roundings (dQ
from ds rounded to bf16 once; dV and dK from p and ds as bf16 hi + lo
parts) are emulated in plain PyTorch and held against JAX's gradient at
the same bf16 tolerance, with the one-rounding variant printed beside it.
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vocalie_tts_tpu.ops.flash_attention import _fa_fwd
from vocalie_tts_tpu.ops.flash_attention import flash_attention_trainable as jax_trainable
from vocalie_tts_tpu_torch.ops.flash_attention import (
    attention_plain_lse,
    flash_attention_trainable,
    reference_attention,
)
from vocalie_tts_tpu_torch.ops import flash_attention_bwd as fb
from vocalie_tts_tpu_torch.ops.flash_attention_bwd import flash_attention_bwd_plain, flash_bwd_body


@functools.partial(jax.jit, static_argnums=(4,))
def _jax_vjp(q, k, v, g, causal):
    """(out, lse [b*h, s_pad], (dq, dk, dv)) of JAX's trainable attention."""
    out, vjp = jax.vjp(lambda q_, k_, v_: jax_trainable(q_, k_, v_, causal), q, k, v)
    lse = _fa_fwd(q, k, v, causal, None, 128, 128)[1][4]
    return out, lse, vjp(g)


def _inputs(seed, b, h, hk, s, d):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((b, h, s, d), (b, hk, s, d), (b, hk, s, d), (b, h, s, d))]


def _rel(got, ref):
    got = got.detach().float().numpy()
    ref = np.asarray(ref, np.float32)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


CASES = [
    ("causal_s100_gqa2_d16", 2, 4, 2, 100, 16, True),
    ("noncausal_s200_d64", 2, 4, 4, 200, 64, False),
    ("causal_s100_gqa4_d128", 1, 4, 1, 100, 128, True),
]


@pytest.mark.parametrize("name,b,h,hk,s,d,causal", CASES)
def test_trainable_attention_f32_matches_jax(name, b, h, hk, s, d, causal):
    arrs = _inputs(s + d + hk, b, h, hk, s, d)
    out, lse, (dq, dk, dv) = _jax_vjp(*map(jnp.asarray, arrs), causal)
    q, k, v = (torch.from_numpy(a).requires_grad_(True) for a in arrs[:3])
    got = flash_attention_trainable(q, k, v, causal)
    got.backward(torch.from_numpy(arrs[3]))
    for label, g, r in (("out", got, out), ("dq", q.grad, dq), ("dk", k.grad, dk),
                        ("dv", v.grad, dv)):
        assert _rel(g, r) <= 1e-5, (label, _rel(g, r))
    _, my_lse = attention_plain_lse(*(torch.from_numpy(a) for a in arrs[:3]), causal=causal)
    ref_lse = np.asarray(lse).reshape(b, h, -1)[:, :, :s]
    np.testing.assert_allclose(my_lse.numpy(), ref_lse, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name,b,h,hk,s,d,causal", [
    ("causal_s100_gqa2_d64", 2, 4, 2, 100, 64, True),
    ("noncausal_s200_d128", 1, 4, 4, 200, 128, False),
])
def test_trainable_attention_bf16_matches_jax(name, b, h, hk, s, d, causal):
    arrs = [jnp.asarray(a).astype(jnp.bfloat16) for a in _inputs(s + d, b, h, hk, s, d)]
    out, _lse, (dq, dk, dv) = _jax_vjp(*arrs, causal)
    tensors = [torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16) for a in arrs]
    q, k, v = (t.requires_grad_(True) for t in tensors[:3])
    got = flash_attention_trainable(q, k, v, causal)
    got.backward(tensors[3])
    for label, g, r in (("out", got, out), ("dq", q.grad, dq), ("dk", k.grad, dk),
                        ("dv", v.grad, dv)):
        assert g.dtype == torch.bfloat16
        assert _rel(g, np.asarray(r, np.float32)) <= 1e-2, (label, _rel(g, np.asarray(r, np.float32)))


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "noncausal"])
def test_plain_backward_matches_autograd_of_reference(causal):
    """B11's plain version from the plain forward's (out, lse) equals
    autograd through the f32 softmax attention (GQA 4/2, s 100)."""
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(5, 2, 4, 2, 100, 32))
    out, lse = attention_plain_lse(q, k, v, causal=causal)
    dq, dk, dv = flash_attention_bwd_plain(q, k, v, out, lse, do, causal=causal,
                                           sm_scale=1.0 / math.sqrt(32))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    reference_attention(*leaves, causal=causal).backward(do)
    for got, leaf in zip((dq, dk, dv), leaves):
        assert _rel(got, leaf.grad.numpy()) <= 1e-5


# ── the CUDA bodies' choice and the tensor-core body's roundings ────────


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("d", [8, 16, 32, 64, 128])
def test_flash_bwd_body_choice(dtype, d):
    """B11a and B11b run on the tensor cores for bf16 at d 64 and 128 (the
    trainer's d_head is 64), on the CUDA cores in f32 for every other call."""
    want = "tc" if dtype == torch.bfloat16 and d in (64, 128) else "simt"
    assert flash_bwd_body(dtype, d) == want


def test_cpu_backward_launches_nothing():
    """CPU tensors take the plain versions: neither wrapper's ``launches`` nor
    its ``tc_launches`` moves, at the tensor-core body's dtype and width."""
    q, k, v, do = (torch.from_numpy(a).to(torch.bfloat16) for a in _inputs(3, 1, 2, 1, 40, 64))
    out, lse = attention_plain_lse(q, k, v, causal=True)
    wrappers = (fb.flash_attention_bwd_dq, fb.flash_attention_bwd_dkv)
    before = [(w.launches, w.tc_launches) for w in wrappers]
    dq, di = fb.flash_attention_bwd_dq(q, k, v, out, lse, do, causal=True, sm_scale=0.125)
    fb.flash_attention_bwd_dkv(q, k, v, do, lse, di, causal=True, sm_scale=0.125)
    fb.flash_attention_bwd(q, k, v, out, lse, do, causal=True, sm_scale=0.125)
    assert [(w.launches, w.tc_launches) for w in wrappers] == before


def _tc_body_grads(q, k, v, do, causal, split):
    """(dq, dk, dv) with the tensor-core body's roundings in plain PyTorch:
    dQ from ds rounded to bf16 once (JAX's ``ds.astype``: the plain
    version's rule); dV = pᵀ·dO and dK = dsᵀ·q with p and ds each fed as
    bf16 hi + lo parts (hi = bf16(x), lo = bf16(x − hi)) when ``split``, as
    one bf16 rounding otherwise; f32 sums, the group summed in f32."""
    b, h, s, d = q.shape
    hk = k.shape[1]
    sm = 1.0 / math.sqrt(d)
    out, lse = attention_plain_lse(q, k, v, causal=causal)
    dq, di = fb.flash_attention_bwd_dq_plain(q, k, v, out, lse, do, causal=causal, sm_scale=sm)
    p, ds = fb._p_ds(q, k, v, lse, do, di, causal, sm)

    def parts(x):
        hi = x.to(torch.bfloat16).float()
        return (hi, (x - hi).to(torch.bfloat16).float()) if split else (hi,)

    dof, qf = (t.float().reshape(b, hk, h // hk, s, d) for t in (do, q))
    dv = sum(torch.matmul(x.transpose(-1, -2), dof) for x in parts(p)).sum(2)
    dk = sum(torch.matmul(x.transpose(-1, -2), qf) for x in parts(ds)).sum(2)
    return dq, dk.to(torch.bfloat16), dv.to(torch.bfloat16)


@pytest.mark.parametrize("name,b,h,hk,s,d", [
    ("causal_s128_d64", 2, 4, 4, 128, 64),
    ("causal_s128_gqa2_d64", 2, 4, 2, 128, 64),
])
def test_tensor_core_body_roundings_match_jax(name, b, h, hk, s, d):
    """The tensor-core body's roundings (``_tc_body_grads``) against JAX's
    ``flash_attention_trainable`` gradient, bf16 causal, within the bf16
    tolerance of this file (1e-2 of max|ref|). The variant that rounds p and
    ds to bf16 once for dV and dK is printed beside it, as a record."""
    arrs = [jnp.asarray(a).astype(jnp.bfloat16) for a in _inputs(s + hk, b, h, hk, s, d)]
    _out, _lse, ref = _jax_vjp(*arrs, True)
    q, k, v, do = (torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16) for a in arrs)
    for split in (True, False):
        got = _tc_body_grads(q, k, v, do, True, split)
        errs = {label: _rel(g, np.asarray(r, np.float32))
                for label, g, r in zip(("dq", "dk", "dv"), got, ref)}
        print(f"{name}: {'bf16 hi + lo' if split else 'one bf16 rounding'} of p and ds, "
              f"max |diff| / max|ref| against JAX: {errs}")
        if split:
            assert all(e <= 1e-2 for e in errs.values()), errs
