"""The launch plan and the order of operations of the port's whole-layer
decode kernel (B12, ``csrc/decode_layer.cu``), as pure functions of the
shapes: the CUDA body runs only on the card (``tests/test_torch_kernels_cuda.py``
and ``chip_smoke.py`` hold it against its plain version there), and what it
is told to do is decided in ``ops/decode_layer.py`` and handed to it with
each call (the C entry refuses a split or a slot layout its own layout does
not hold).

``layer_plan`` at the Chatterbox T3 layer (b 16, 16 heads of 64, d_model
1024, d_ff 4096, qkv 3072, cache 640 at 416 valid slots), the Qwen3 layer
(b 8, 8 kv x 2 q heads of 128, d_model 2048, d_ff 8192, qkv 4096, cache 512
at 352) and a tiny one, on a card of 132 SMs (the H100):

- the attention items (one a (row, kv head) pair's 128-slot block) cover
  every valid block of every pair once, each team of warps takes its items
  in block order (no wait of an item on an earlier block's maximum can be
  circular), the teams fit a block's warps, and at both served shapes the
  items fit one wave;
- the o-projection adds the q heads in ascending order, a Wo tile holding
  whole heads;
- the four products' items are ``tail_plan``'s (B2's), padded to one block
  an SM, within the shared bytes;
- a CPU emulation of the kernel's order -- each block's chain from the
  prefix max of the pair's earlier blocks, the blocks merged in order, the
  per-head int32 products scaled and summed head after head -- equals
  ``layer_swiglu_qkv_int8_plain`` bit for bit on seeded inputs, with
  valid_len in the first block, across blocks and on a block boundary.
"""

import numpy as np
import pytest
import torch

from vocalie_tts_tpu_torch.ops.decode_attention import TBLK, n_valid_blocks
from vocalie_tts_tpu_torch.ops.decode_dense import (
    SMEM_MAX,
    _ff_tile,
    _row_chunks,
    _int_dot,
    _quantize_rows,
    _rms_rows,
    _swiglu_down,
    qkv_norm_int8_plain,
    tail_plan,
)
from vocalie_tts_tpu_torch.ops.decode_layer import (
    LAYER_MAX_B,
    LAYER_MAX_SLOTS,
    layer_act_min,
    layer_attn_items,
    layer_attn_split,
    layer_attn_team,
    layer_cache_offset,
    layer_head_order,
    layer_plan,
    layer_rows,
    layer_splits,
    layer_swiglu_qkv_int8_plain,
)

H100_SMS = 132

#: (label, b, kv, g, d_head, T, d_model, d_ff, valid_len)
SHAPES = [("t3", 16, 16, 1, 64, 640, 1024, 4096, 416),
          ("qwen3", 8, 8, 2, 128, 512, 2048, 8192, 352),
          ("tiny", 3, 2, 2, 32, 384, 128, 256, 200)]


def _plan(shape, sms=H100_SMS):
    _, b, kv, g, d, T, D, F, valid = shape
    Q = (kv * g + 2 * kv) * d
    return layer_plan(b, kv, g, d, T, D, F, _ff_tile(D, F, Q), Q, sms), valid


@pytest.mark.parametrize("shape", SHAPES, ids=[s[0] for s in SHAPES])
def test_attention_items_cover_every_block_once_in_block_order(shape):
    plan, valid = _plan(shape)
    _, b, kv, *_ = shape
    for n_blk in range(1, plan.T // TBLK + 1):
        slots = layer_attn_split(plan, n_blk)
        items = layer_attn_items(plan, n_blk)
        assert sorted(items) == [(pc, j) for pc in range(b * kv) for j in range(n_blk)]
        assert 1 <= slots <= LAYER_MAX_SLOTS
        # each item's team of warps: the teams fit the block's 16 warps
        team = layer_attn_team(slots, plan.d)
        assert team in (1, 2, 4) and team * slots <= 16
        # the slots lie past the ring's first stage (the tile a block asks
        # for at launch), below the items' column scales
        assert plan.stage + slots * plan.slot <= plan.slot_end < plan.smem
        # a team's items: distinct rounds, and a later round never takes an
        # earlier block (an item only waits on earlier blocks' maxima)
        by_team = {}
        for (pc, j), (blk, team_id, rnd) in items.items():
            assert 0 <= blk < plan.grid and 0 <= team_id < slots
            by_team.setdefault((blk, team_id), []).append((rnd, j))
        for its in by_team.values():
            its.sort()
            assert len({r for r, _ in its}) == len(its)
            assert [j for _, j in its] == sorted(j for _, j in its)


@pytest.mark.parametrize("shape", SHAPES, ids=[s[0] for s in SHAPES])
def test_each_call_hands_the_kernel_the_planned_split(shape):
    """The split a call passes to the C entry at each count of valid blocks
    (``layer_splits``, read by the wrapper) is ``layer_attn_split``'s with
    ``layer_attn_team``'s teams, within what the C entry takes: teams of 1, 2
    or 4 warps of at most a v row's words, 16 warps a block, the slots past
    the ring's first stage and below ``slot_end``."""
    plan, _ = _plan(shape)
    splits = layer_splits(plan)
    assert len(splits) == plan.T // TBLK
    for n_blk, (slots, team) in enumerate(splits, 1):
        assert slots == layer_attn_split(plan, n_blk)
        assert team == layer_attn_team(slots, plan.d)
        assert 1 <= slots <= LAYER_MAX_SLOTS and team in (1, 2, 4) and team <= plan.d // 4
        assert slots * team <= 16 and plan.stage + slots * plan.slot <= plan.slot_end


@pytest.mark.parametrize("label,n_blk,slots,team", [("t3", 4, 8, 2), ("qwen3", 3, 2, 4)])
def test_served_shapes_fit_one_wave(label, n_blk, slots, team):
    """At phase 2's valid lengths (416 and 352 slots) every attention item
    runs in the first round on 132 SMs: 1,024 items at T3 (8 a block, two
    warps an item), 192 at Qwen3 (2 a block, four warps an item)."""
    shape = next(s for s in SHAPES if s[0] == label)
    plan, valid = _plan(shape)
    assert n_valid_blocks(valid, plan.T) == n_blk
    assert layer_attn_split(plan, n_blk) == slots
    assert layer_attn_team(slots, plan.d) == team
    assert max(rnd for _, _, rnd in layer_attn_items(plan, n_blk).values()) == 0
    assert plan.grid == H100_SMS


@pytest.mark.parametrize("shape", SHAPES, ids=[s[0] for s in SHAPES])
def test_o_projection_adds_the_heads_in_ascending_order(shape):
    plan, _ = _plan(shape)
    assert plan.tail.kc % plan.d == 0
    assert layer_head_order(plan) == list(range(plan.heads))


@pytest.mark.parametrize("shape", SHAPES, ids=[s[0] for s in SHAPES])
def test_tail_items_are_tail_plans(shape):
    plan, _ = _plan(shape)
    _, b, kv, g, d, T, D, F, _ = shape
    Q = (kv * g + 2 * kv) * d
    tail = tail_plan(b, kv * g * d, D, F, _ff_tile(D, F, Q), Q, H100_SMS)
    items = plan.items()
    assert len(items) == plan.grid == H100_SMS
    assert items[:tail.grid] == tail.items and all(not its for its in items[tail.grid:])
    table = plan.table()
    assert table[:plan.grid + 1] == [sum(len(its) for its in items[:i])
                                     for i in range(plan.grid + 1)]
    assert plan.smem <= SMEM_MAX
    # the activations hold the o-projection's rows, parts and scales, and a slot
    assert plan.slot_end - plan.tail.stages * plan.stage >= layer_act_min(b, kv * g, d, g)


@pytest.mark.parametrize("kw,match", [
    (dict(b=17), "b <= 16"), (dict(g=9), "g <= 8"), (dict(d=96), "d_head"),
    (dict(T=200), "128-slot"),
])
def test_layer_plan_refuses_what_the_kernel_does_not_take(kw, match):
    args = dict(b=4, kv=2, g=1, d=64, T=256, D=256, F=512)
    args.update(kw)
    Q = (args["kv"] * args["g"] + 2 * args["kv"]) * args["d"]
    with pytest.raises(ValueError, match=match):
        layer_plan(args["b"], args["kv"], args["g"], args["d"], args["T"], args["D"],
                   args["F"], 512, Q, H100_SMS)


# ── the kernel's order of operations, emulated ──────────────────────────


def _inputs(seed, L, b, kv, g, d, T, D, F, prompt_pad, valid_len):
    rng = np.random.default_rng(seed)
    H = kv * g
    Q = (H + 2 * kv) * d

    def w(d_in, d_out):
        return (torch.from_numpy(rng.integers(-127, 128, (L, d_in, d_out), dtype=np.int8)),
                torch.from_numpy(((rng.random((L, 1, d_out)) + 0.5) / 127 * d_in ** -0.5)
                                 .astype(np.float32)))

    f32 = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))  # noqa: E731
    q = f32(b, kv, g, d)
    x = f32(b, D)
    k = torch.from_numpy(rng.integers(-127, 128, (L, b, kv, T, d), dtype=np.int8))
    v = torch.from_numpy(rng.integers(-127, 128, (L, b, kv, T, d), dtype=np.int8))
    ks = torch.from_numpy(((rng.random((L, b, kv, T)) + 0.5) / 127).astype(np.float32)).bfloat16()
    vs = torch.from_numpy(((rng.random((L, b, kv, T)) + 0.5) / 127).astype(np.float32)).bfloat16()
    kn, vn = f32(b, kv, d), f32(b, kv, d)
    lens = rng.integers(1, prompt_pad + 1, (b,))
    pos = np.arange(T)[None, :]
    valid = (pos < lens[:, None]) | ((pos >= prompt_pad) & (pos < valid_len))
    bias = torch.from_numpy(np.where(valid, 0.0, -0.7 * np.finfo(np.float32).max)
                            .astype(np.float32))
    wo, wos = w(H * d, D)
    mw = 1 + 0.1 * f32(L, D)
    wgu, sgu = w(D, 2 * F)
    wd, sd = w(F, D)
    nw = 1 + 0.1 * f32(L, D)
    wq, sq = w(D, Q)
    return (q, x, k, v, ks, vs, bias, kn, vn), (wo, wos, mw, wgu, sgu, wd, sd, nw, wq, sq)


def _emulate(plan, head, tail, layer, valid_len, sm_scale, eps):
    """B12's arithmetic in the kernel's order: every (pair, block) item on
    its own from the prefix max of the pair's earlier blocks (m_j, l_j =
    its p summed in double, acc_j = p8 . v * ps), the blocks merged in
    order, the current token, o8 per (row, head), the Wo tiles' heads in
    :func:`layer_head_order`, then B2's tail from x2."""
    q, x, k_all, v_all, k_scale, v_scale, bias, k_new, v_new = head
    wo_all, wos_all, mw_all, wgu_all, sgu_all, wd_all, sd_all, nw_all, wq_all, sq_all = tail
    b, kv, g, d = q.shape
    T, BC, H = k_all.shape[3], b * kv, kv * g
    f32 = torch.float32
    qf = q.reshape(BC, g, d)
    qq, qs = _quantize_rows(qf)
    k = k_all[layer].reshape(BC, T, d).to(f32)
    v = v_all[layer].reshape(BC, T, d).to(f32)
    ks = k_scale[layer].reshape(BC, T).to(f32)
    vs = v_scale[layer].reshape(BC, T).to(f32)
    bias_m = bias[:, None, :].expand(b, kv, T).reshape(BC, T)
    n_blk = n_valid_blocks(valid_len, T)
    # each item's scores and block max, all published before any chain
    blocks = []
    for j in range(n_blk):
        sl = slice(j * TBLK, (j + 1) * TBLK)
        s = torch.matmul(qq, k[:, sl].transpose(1, 2)) * (qs * sm_scale)
        s = s * ks[:, None, sl] + bias_m[:, None, sl]
        blocks.append((sl, s, s.amax(-1, keepdim=True)))
    parts = []
    for j, (sl, s, bmax) in enumerate(blocks):
        m_prev = torch.full_like(bmax, -1e30)
        for _, _, bm in blocks[:j]:           # the prefix max, in any order
            m_prev = torch.maximum(m_prev, bm)
        mj = torch.maximum(m_prev, bmax)
        p = torch.exp(s - mj)
        lj = p.double().sum(-1, keepdim=True).float()
        p8, ps = _quantize_rows(p * vs[:, None, sl], floor=1e-20)
        parts.append((mj, lj, torch.matmul(p8, v[:, sl]) * ps))
    M = torch.full((BC, g, 1), -1e30)
    A = torch.zeros((BC, g, d))
    L = torch.zeros((BC, g, 1))
    for mj, lj, accj in parts:               # the blocks merged in order
        cf = torch.exp(M - mj)
        A = A * cf + accj
        L = L * cf + lj
        M = mj
    kn = k_new.reshape(BC, 1, d)
    s_new = (qf.double() * kn.double()).sum(-1, keepdim=True).float() * sm_scale
    m_fin = torch.maximum(M, s_new)
    cf = torch.exp(M - m_fin)
    p_new = torch.exp(s_new - m_fin)
    o = (A * cf + p_new * v_new.reshape(BC, 1, d)) / torch.clamp(L * cf + p_new, min=1e-30)
    o = o.reshape(b, H, d)
    wo = wo_all[layer]
    y = None
    for c in layer_head_order(plan):          # one warp a head, f32 parts in order
        oq, os_ = _quantize_rows(o[:, c])
        part = _int_dot(oq, wo[c * d:(c + 1) * d]) * os_
        y = part if y is None else y + part
    x2 = x + y * wos_all[layer]
    h, hs = _quantize_rows(_rms_rows(x2, mw_all[layer], eps))
    x_out = x2 + _swiglu_down(h, hs, wgu_all[layer], sgu_all[layer], wd_all[layer],
                              plan.tail.tile) * sd_all[layer]
    nxt = min(layer + 1, wq_all.shape[0] - 1)
    return x_out, qkv_norm_int8_plain(x_out, nw_all, wq_all, sq_all, nxt, eps=eps)


@pytest.mark.parametrize("dims", [(3, 2, 2, 32), (2, 4, 1, 64)], ids=["g2-d32", "g1-d64"])
@pytest.mark.parametrize("where,prompt_pad,valid_len", [
    ("first block", 40, 57), ("across blocks", 200, 301), ("block boundary", 200, 256)])
def test_kernel_order_equals_the_plain_version(dims, where, prompt_pad, valid_len):
    b, kv, g, d = dims
    L, T, D, F = 2, 384, 128, 256
    Q = (kv * g + 2 * kv) * d
    plan = layer_plan(b, kv, g, d, T, D, F, _ff_tile(D, F, Q), Q, H100_SMS)
    head, tail = _inputs(valid_len + d, L, b, kv, g, d, T, D, F, prompt_pad, valid_len)
    kw = dict(sm_scale=d ** -0.5, eps=1e-6)
    for layer in range(L):
        got = _emulate(plan, head, tail, layer, valid_len, **kw)
        ref = layer_swiglu_qkv_int8_plain(*head, layer, valid_len, *tail, **kw,
                                          tile=plan.tail.tile)
        for a, r in zip(got, ref):
            assert torch.equal(a, r), (where, layer, (a - r).abs().max().item())


# ── fault C2: a batch past what one B12 launch takes ────────────────────


@pytest.mark.parametrize("shape", SHAPES, ids=[s[0] for s in SHAPES])
def test_layer_rows_is_the_most_rows_one_launch_takes(shape):
    """16 rows at the T3, Qwen3 and tiny layers on 132 SMs: ``layer_plan``
    takes 16 and refuses 17."""
    _, b, kv, g, d, T, D, F, _ = shape
    Q = (kv * g + 2 * kv) * d
    tile = _ff_tile(D, F, Q)
    assert layer_rows(kv, g, d, T, D, F, tile, Q, H100_SMS) == LAYER_MAX_B == 16
    layer_plan(16, kv, g, d, T, D, F, tile, Q, H100_SMS)
    with pytest.raises(ValueError, match="b <= 16"):
        layer_plan(17, kv, g, d, T, D, F, tile, Q, H100_SMS)


@pytest.mark.parametrize("b,chunks", [
    (16, [(0, 16)]),
    (17, [(0, 8), (8, 17)]),
    (33, [(0, 11), (11, 22), (22, 33)]),
])
def test_row_chunks_past_16_rows(b, chunks):
    """The launches a ``VOCALIE_MEGALAYER=1`` layer takes at 16, 17 and 33
    rows (the T3 layer; a Chatterbox request of 9 chunks or more has 18 CFG
    rows or more): near-equal chunks of at most 16 rows, in order."""
    rows = layer_rows(16, 1, 64, 640, 1024, 4096, _ff_tile(1024, 4096, 3072), 3072, H100_SMS)
    got = [(0, b)] if b <= rows else _row_chunks(b, rows)
    assert got == chunks
    assert all(r1 - r0 <= rows for r0, r1 in got)


@pytest.mark.parametrize("layer", [0, 1, 2])
@pytest.mark.parametrize("b,r0,r1", [(17, 0, 8), (17, 8, 17), (33, 11, 22), (33, 22, 33),
                                     (16, 0, 16)])
def test_cache_offset_lands_on_the_layer_slice(layer, b, r0, r1):
    """The kernel's index math on the pointer a chunk hands it: pair ``pc``
    of its ``bc`` rows at row ``layer · bc · kv + pc`` from the moved
    pointer, on a cache whose every row holds its own index, reads the
    layer slice ``k[layer, r0:r1]`` row for row, inside the cache."""
    L, kv = 3, 2
    rows = np.arange(L * b * kv).reshape(L, b, kv)        # each row's flat index
    bc = r1 - r0
    off = layer_cache_offset(layer, b, r0, r1) * kv
    read = np.array([off + layer * bc * kv + pc for pc in range(bc * kv)])
    assert read.min() >= 0 and read.max() < rows.size
    assert np.array_equal(read, rows[layer, r0:r1].reshape(-1))


def test_plain_layer_on_row_chunks_is_the_one_call():
    """The plain B12 on 33 rows equals, bit for bit, the concatenation of the
    plain B12 on its row chunks (11, 11 and 11 rows), each handed its rows'
    cache: what the card computes for a batch past 16 rows is the one call's
    result (every quantity is per row)."""
    L, b, kv, g, d, T, D, F = 2, 33, 2, 2, 32, 384, 128, 256
    valid_len, prompt_pad = 301, 200
    head, tail = _inputs(5, L, b, kv, g, d, T, D, F, prompt_pad, valid_len)
    kw = dict(sm_scale=d ** -0.5, eps=1e-6)
    chunks = _row_chunks(b, 16)
    assert chunks == [(0, 11), (11, 22), (22, 33)]
    for layer in range(L):
        whole = layer_swiglu_qkv_int8_plain(*head, layer, valid_len, *tail, **kw)
        parts = []
        for r0, r1 in chunks:
            q, x, k, v, ks, vs, bias, kn, vn = head
            sub = (q[r0:r1], x[r0:r1], k[:, r0:r1], v[:, r0:r1], ks[:, r0:r1], vs[:, r0:r1],
                   bias[r0:r1], kn[r0:r1], vn[r0:r1])
            parts.append(layer_swiglu_qkv_int8_plain(*sub, layer, valid_len, *tail, **kw))
        for i, name in enumerate(("x_out", "qkv")):
            assert torch.equal(whole[i], torch.cat([p[i] for p in parts])), (layer, name)


def test_megalayer_dispatch_past_16_rows_and_its_refusal(monkeypatch):
    """On a card (``card_sms`` answering 132) ``VOCALIE_MEGALAYER=1`` keeps
    B12 at 16, 17 and 33 rows of the T3 layer (JAX's ``use_megalayer`` has
    no row limit), and off a card; a width no B12 launch takes at one row
    (normed rows of 4096) raises ``ValueError`` naming the shape on a card
    instead of falling to another path."""
    import dataclasses

    from vocalie_tts_tpu_torch.models.chatterbox.runtime import SCALES
    from vocalie_tts_tpu_torch.models.common import transformer as tr
    from vocalie_tts_tpu_torch.models.common.ar_runtime import apply_runtime_env

    for name, value in (("VOCALIE_DENSE_KERNEL", "1"), ("VOCALIE_KV_INT8", "1"),
                        ("VOCALIE_DECODE_KERNEL", "1"), ("VOCALIE_MEGALAYER", "1")):
        monkeypatch.setenv(name, value)
    monkeypatch.delenv("VOCALIE_MEGATAIL", raising=False)

    def layers_at(d, d_ff):
        zero = torch.zeros((), dtype=torch.int8)
        return {name: {"q": zero.expand(shape)} for name, shape in (
            ("wqkv", (2, d, 3 * d)), ("wo", (2, d, d)),
            ("w_gateup", (2, d, 2 * d_ff)), ("w_down", (2, d_ff, d)))}

    base = apply_runtime_env(SCALES["tiny"]).lm
    cfg = dataclasses.replace(base, d_model=1024, n_heads=16, n_kv_heads=16, d_head=64,
                              d_ff=4096)
    wide = dataclasses.replace(base, d_model=4096, n_heads=32, n_kv_heads=32, d_head=128,
                               d_ff=16384)
    assert cfg.kv_quant and cfg.decode_kernel
    for b in (16, 17, 33):
        assert tr._dense_dispatch(layers_at(1024, 4096), cfg, b, 640) == tr.MEGALAYER
    assert tr._dense_dispatch(layers_at(4096, 16384), wide, 8, 640) == tr.MEGALAYER
    monkeypatch.setattr(tr, "card_sms", lambda device: H100_SMS)
    for b in (16, 17, 33):
        assert tr._dense_dispatch(layers_at(1024, 4096), cfg, b, 640) == tr.MEGALAYER
    with pytest.raises(ValueError, match="d_model=4096, 32 q / 32 kv heads of 128, d_ff=16384"):
        tr._dense_dispatch(layers_at(4096, 16384), wide, 8, 640)
    assert layer_rows(32, 1, 128, 640, 4096, 16384, _ff_tile(4096, 16384, 12288), 12288,
                      H100_SMS) is None
