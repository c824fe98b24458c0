"""The split f32 decode attention (K1, K2 and B10 share one CUDA body,
``csrc/decode_attention.cu`` ``attend_split_kernel``) on the CPU:

- ``attend_splits``, the one rule both the kernel's launch and this file's
  emulation take the split from, at the shapes the card runs (phase 2 of
  ``chip_smoke.py`` and the ``VOCALIE_DECODE_KERNEL=1`` decode paths): the
  counts expected there, powers of two up to 16, and no empty range while
  every block can keep ``SPLIT_MIN_SLOTS`` slots;
- a plain-PyTorch emulation of the kernel's order of operations: per split
  (``attend_ranges``), per warp and lane group, an online softmax over the
  rows that group loads (``UNROLL`` rows a pass, one max and one rescale a
  pass); the groups merged by the xor butterfly, the warps in order, the
  ranks in order four at a time, the current token last. It is held against JAX's
  ``decode_attention`` (B10: bf16, and int8 with f32 scales) and
  ``decode_attention_stacked`` with ``int8_dots=False`` (K1 over bf16, K2
  over int8 with bf16 scales), Pallas in interpret mode as
  ``tests/test_torch_bf16_cache.py`` runs them, at atol 1e-4, the bound of
  ``tests/test_decode_attention.py:50``; at d 64 g 1, d 128 g 2, with a
  fully masked row, with the split the rule gives and with 1 and 16 blocks,
  and with a valid length that leaves the last blocks of 16 empty;
- CPU calls of the three wrappers run their plain versions and leave their
  ``launches`` counts where they were.

The card's side (the kernel against the plain versions at these and the
main path's shapes) is ``tests/test_torch_kernels_cuda.py``.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vocalie_tts_tpu.ops.decode_attention import decode_attention as jax_b10
from vocalie_tts_tpu.ops.decode_attention import decode_attention_stacked as jax_attn
from vocalie_tts_tpu_torch.bridge import to_torch
from vocalie_tts_tpu_torch.ops import decode_attention as pda

NEG = -0.7 * float(np.finfo(np.float32).max)
#: the kernel's warps a block (ATT_WARPS), rows a lane group loads a pass
#: (ATT_UNROLL) and ranks rank 0 merges at a time (ATT_MERGE)
WARPS, UNROLL, MERGE = 4, 4, 4


# ── the split rule ───────────────────────────────────────────────────────


#: clusters of each size (2..16 blocks) the H100 keeps resident at once for
#: the bf16 K1 kernel at g 1 (80 registers) and g 2 (104), as
#: ``chip_smoke.py`` prints them (``cudaOccupancyMaxActiveClusters``)
RESIDENT_H100 = {1: {2: 396, 4: 186, 8: 92, 16: 42}, 2: {2: 264, 4: 124, 8: 62, 16: 28}}


@pytest.mark.parametrize("bc,n_slots,g,want", [
    (16 * 16, 416, 1, 2),     # K1, the T3 cache in phase 2 (valid_len 416)
    (16 * 16, 257, 1, 2),     # the Chatterbox DECODE_KERNEL=1 path: first step of the 256 prompt
    (16 * 16, 576, 1, 2),     # ... its last step (256 + 320)
    (16 * 16, 640, 1, 2),     # B10 on one T3 layer, every slot
    (8 * 8, 352, 2, 4),       # K1, the Qwen3 cache in phase 2: 64 clusters of 8 would not fit
    (1 * 8, 352, 2, 16),      # K1, the Qwen3 batch-1 row of phase 2
    (1 * 8, 257, 2, 16),      # the Qwen3 batch-1 DECODE_KERNEL=1 path, first step
    (1 * 8, 20, 2, 1),        # a short cache: one block keeps every slot
    (17 * 16, 4096, 1, 1),    # 272 pairs already fill the card
])
def test_attend_splits_at_the_card_shapes(bc, n_slots, g, want):
    assert pda.attend_splits(bc, n_slots, RESIDENT_H100[g].__getitem__) == want


def test_attend_splits_keeps_one_wave():
    """Without the card's residency the rule would give the Qwen3 cache 8
    blocks a pair (512 blocks): 64 clusters of 8 where the card keeps 62 at
    once; with it, every count it gives fits in one wave."""
    assert pda.attend_splits(64, 352) == 8
    for g, resident in RESIDENT_H100.items():
        for bc in range(1, 300):
            s = pda.attend_splits(bc, 640, resident.__getitem__)
            assert s == 1 or bc <= resident[s], (g, bc, s)


def test_attend_splits_never_leaves_a_block_empty():
    """Every count is a power of two in 1..16, and while n_slots >= splits x
    SPLIT_MIN_SLOTS (always, by the rule) every range holds a slot; the
    ranges tile [0, n_slots) in rank order."""
    for bc in (1, 2, 3, 8, 17, 64, 100, 256, 300):
        for n in range(1, 700):
            s = pda.attend_splits(bc, n)
            assert 1 <= s <= pda.SPLIT_MAX and s & (s - 1) == 0
            assert s == 1 or n >= s * pda.SPLIT_MIN_SLOTS
            ranges = pda.attend_ranges(n, s)
            assert ranges[0][0] == 0 and ranges[-1][1] == n
            assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
            assert all(hi > lo for lo, hi in ranges), (bc, n, s, ranges)


def test_attend_ranges_past_the_slots_are_empty():
    assert pda.attend_ranges(20, 16) == [(0, 2), (2, 4), (4, 6), (6, 8), (8, 10), (10, 12),
                                         (12, 14), (14, 16), (16, 18), (18, 20)] + [(20, 20)] * 6


# ── the kernel's order, emulated ─────────────────────────────────────────


def _rows_per_warp_load(elem: int, d: int, g: int) -> int:
    """Rows one warp load covers: a lane holds E = min(16 / elem, 32 / G)
    elements (G = g rounded up to a power of two), a row takes d / E lanes
    rounded up to a power of two."""
    G = 1 << (g - 1).bit_length()
    E = min(16 // elem, 32 // G)
    lg = 1
    while lg * E < d:
        lg *= 2
    return 32 // lg


def _rescale(m, ref):
    """exp(m - ref), 0 for an empty state (m = -inf)."""
    return torch.where(m == -math.inf, torch.zeros_like(m), torch.exp(m - ref))


def _merge_in_order(states):
    """(m, l, acc) states merged against their common max, summed in order."""
    M = states[0][0]
    for m, _, _ in states[1:]:
        M = torch.maximum(M, m)
    L = torch.zeros_like(states[0][1])
    A = torch.zeros_like(states[0][2])
    for m, l, acc in states:
        c = _rescale(m, M)
        L = L + c * l
        A = A + c * acc
    return M, L, A


def _merge_pair(a, b):
    mn = torch.maximum(a[0], b[0])
    ca, cb = _rescale(a[0], mn), _rescale(b[0], mn)
    return mn, a[1] * ca + b[1] * cb, a[2] * ca + b[2] * cb


def emulate_split(q, k, v, bias, ks, vs, kn, vn, n_slots, splits, mode, sm, rpw):
    """The split kernel's order in f32: q ``[BC, g, d]``, k/v ``[BC, T, d]``
    (dequantized values, unscaled), bias ``[BC, T]``, ks/vs ``[BC, T]`` or
    None, kn/vn ``[BC, d]`` or None; ``mode`` "plain", "dequant" or "b10".
    Returns ``[BC, g, d]``."""
    BC, g, d = q.shape
    step = rpw * UNROLL

    def empty():
        return (torch.full((BC, g, 1), -math.inf), torch.zeros((BC, g, 1)),
                torch.zeros((BC, g, d)))

    ranks = []
    for lo, hi in pda.attend_ranges(n_slots, splits):
        warps = []
        for w in range(WARPS):
            groups = []
            for j in range(rpw):
                m, l, acc = empty()
                base = lo + w * step
                while base < hi:
                    rows = [t for t in (base + u * rpw + j for u in range(UNROLL)) if t < hi]
                    if rows:
                        idx = torch.tensor(rows)
                        s = torch.matmul(q, k[:, idx].transpose(1, 2))      # [BC, g, R]
                        if mode == "plain":
                            s = s * sm + bias[:, None, idx]
                        elif mode == "dequant":
                            s = s * (sm * ks[:, None, idx]) + bias[:, None, idx]
                        else:
                            s = (s * sm) * ks[:, None, idx] + bias[:, None, idx]
                        mx = torch.maximum(m, s.amax(-1, keepdim=True))
                        corr = _rescale(m, mx)
                        p = torch.exp(s - mx)
                        l = l * corr + p.sum(-1, keepdim=True)
                        vv = v[:, idx] * vs[:, idx, None] if mode == "dequant" else v[:, idx]
                        pv = p * vs[:, None, idx] if mode == "b10" else p
                        acc = acc * corr + torch.matmul(pv, vv)
                        m = mx
                    base += step * WARPS
                groups.append((m, l, acc))
            while len(groups) > 1:   # the xor butterfly, as group 0 sees it
                groups = [_merge_pair(groups[i], groups[i + 1]) for i in range(0, len(groups), 2)]
            warps.append(groups[0])
        ranks.append(_merge_in_order(warps))
    # rank 0: a running merge over MERGE ranks at a time, in rank order
    M, L, A = empty()
    for r0 in range(0, splits, MERGE):
        mn, lc, ac = _merge_in_order(ranks[r0:r0 + MERGE])
        M, L, A = _merge_pair((M, L, A), (mn, lc, ac))
    if kn is None:
        return A / torch.clamp(L, min=1e-30)
    s_new = (q * kn[:, None, :]).sum(-1, keepdim=True) * sm
    m_fin = torch.maximum(M, s_new)
    c = torch.exp(M - m_fin)
    p_new = torch.exp(s_new - m_fin)
    return (A * c + p_new * vn[:, None, :]) / torch.clamp(L * c + p_new, min=1e-30)


def _inputs(seed, L, b, kv, g, T, d, prompt_pad, n_dec, cache, masked_row=False):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, kv, g, d)).astype(np.float32)
    if cache == "int8":
        k, v = (rng.integers(-127, 128, (L, b, kv, T, d), dtype=np.int8) for _ in range(2))
        ks, vs = (rng.uniform(0.5, 1.5, (L, b, kv, T)).astype(np.float32) / 127
                  for _ in range(2))
    else:
        k, v = (np.asarray(jnp.asarray(rng.standard_normal((L, b, kv, T, d)).astype(np.float32),
                                       jnp.bfloat16)) for _ in range(2))
        ks = vs = None
    kn, vn = (rng.standard_normal((b, kv, d)).astype(np.float32) for _ in range(2))
    lens = rng.integers(1, prompt_pad + 1, (b,))
    pos = np.arange(T)[None, :]
    valid = (pos < lens[:, None]) | ((pos >= prompt_pad) & (pos < prompt_pad + n_dec))
    if masked_row:
        valid[0] = False
    bias = np.where(valid, 0.0, NEG).astype(np.float32)
    return q, k, v, ks, vs, bias, kn, vn


def _flat(a, layer=None):
    """A JAX-side array as the emulation's f32 ``[BC, ...]`` tensor."""
    t = torch.from_numpy(np.array(jnp.asarray(a, jnp.float32)))
    if layer is not None:
        t = t[layer]
    return t.reshape(-1, *t.shape[2:])


#: (kernel, cache, g, d, masked_row, prompt_pad, n_dec, extra splits)
CASES = [
    ("K1", "bfloat16", 1, 64, False, 100, 28, (1, 16)),
    ("K1", "bfloat16", 2, 128, True, 100, 28, (1, 16)),
    ("K1", "bfloat16", 1, 64, False, 10, 10, (16,)),    # 20 slots: ranks 10-15 of 16 empty
    ("K2", "int8", 1, 64, True, 100, 28, (1, 16)),
    ("B10", "bfloat16", 1, 64, True, 100, 28, (1, 16)),
    ("B10", "int8", 2, 128, False, 100, 28, (1, 16)),
]


@pytest.mark.parametrize("kernel,cache,g,d,masked_row,prompt_pad,n_dec,extra", CASES,
                         ids=[f"{c[0]}-{c[1]}-g{c[2]}-d{c[3]}{'-masked' if c[4] else ''}"
                              + ("" if c[0] == "B10" else f"-valid{c[5] + c[6]}")
                              for c in CASES])
def test_split_order_matches_jax(kernel, cache, g, d, masked_row, prompt_pad, n_dec, extra):
    """The emulated split kernel against JAX, atol 1e-4, with the split
    ``attend_splits`` gives and with each of ``extra``."""
    L, b, kv, T, layer = 2, 2, 2, 256, 1
    sm = d ** -0.5
    q, k, v, ks, vs, bias, kn, vn = _inputs(g * d + prompt_pad + len(kernel), L, b, kv, g, T, d,
                                            prompt_pad, n_dec, cache, masked_row)
    BC = b * kv
    bias_bc = np.repeat(bias, kv, axis=0)
    if kernel == "B10":
        k1, v1 = k[layer], v[layer]
        ks1, vs1 = (None, None) if ks is None else (ks[layer], vs[layer])
        ref = jax_b10(jnp.asarray(q), jnp.asarray(k1), jnp.asarray(v1), jnp.asarray(bias),
                      None if ks1 is None else jnp.asarray(ks1),
                      None if vs1 is None else jnp.asarray(vs1), sm_scale=sm)
        n_slots, mode, kn_t, vn_t = T, "plain" if ks is None else "b10", None, None
    else:
        ks, vs = (None, None) if ks is None else (jnp.asarray(ks, jnp.bfloat16),
                                                  jnp.asarray(vs, jnp.bfloat16))
        valid_len = prompt_pad + n_dec
        ref = jax_attn(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(bias),
                       jnp.asarray(layer), ks, vs, jnp.asarray(kn), jnp.asarray(vn),
                       valid_len=jnp.asarray(valid_len, jnp.int32), sm_scale=sm,
                       int8_dots=False)
        n_slots, mode = valid_len, "plain" if ks is None else "dequant"
        kn_t, vn_t = _flat(kn), _flat(vn)
    lay = None if kernel == "B10" else layer
    kk = _flat(k[layer] if kernel == "B10" else k, lay)
    vv = _flat(v[layer] if kernel == "B10" else v, lay)
    ks_t = None if ks is None else _flat(ks[layer] if kernel == "B10" else ks, lay)
    vs_t = None if vs is None else _flat(vs[layer] if kernel == "B10" else vs, lay)
    elem = 1 if cache == "int8" else 2
    rpw = _rows_per_warp_load(elem, d, g)
    auto = pda.attend_splits(BC, n_slots)
    for splits in (auto, *extra):
        got = emulate_split(_flat(q), kk, vv, torch.from_numpy(bias_bc), ks_t, vs_t, kn_t, vn_t,
                            n_slots, splits, mode, sm, rpw)
        np.testing.assert_allclose(got.reshape(b, kv, g, d).numpy(), np.asarray(ref), atol=1e-4,
                                   rtol=0, err_msg=f"splits={splits}")


def test_cpu_calls_do_not_count_launches():
    """On CPU tensors K1, K2 and B10 run their plain versions, not counted."""
    q, k, v, ks, vs, bias, kn, vn = _inputs(3, 1, 1, 2, 1, 64, 16, 20, 10, "int8")
    t = lambda a: to_torch(np.asarray(a))   # noqa: E731
    wrappers = (pda.decode_attention_float_stacked, pda.decode_attention_dequant_stacked,
                pda.decode_attention)
    before = [w.launches for w in wrappers]
    kf = t(k).float()
    pda.decode_attention_float_stacked(t(q), kf, t(v).float(), t(bias), 0, t(kn), t(vn),
                                       valid_len=30, sm_scale=0.25)
    pda.decode_attention_dequant_stacked(t(q), t(k), t(v), t(bias), 0,
                                         t(ks).to(torch.bfloat16), t(vs).to(torch.bfloat16),
                                         t(kn), t(vn), valid_len=30, sm_scale=0.25)
    pda.decode_attention(t(q), t(k)[0], t(v)[0], t(bias), t(ks)[0], t(vs)[0], sm_scale=0.25)
    assert [w.launches for w in wrappers] == before
