"""The launch plans of the port's one-launch SwiGLU layer tail (B2, B8a:
``csrc/tail_swiglu.cu``) and the word choice of its cache appends without
scales (K4, K5: ``csrc/cache_update.cu``), as pure functions of the shapes:
the CUDA bodies run only on the card (``tests/test_torch_kernels_cuda.py``
and ``chip_smoke.py`` hold them against their plain versions there), and
what they are told to do is decided here in Python.

``tail_plan`` at the T3 layer (d_model 1024, d_ff 4096 in tiles of 2048,
qkv 3072), the Qwen3 layer (d_model 2048, d_ff 8192 in tiles of 1024, qkv
4096) and the tiny models' (d_model 64, d_ff 128, qkv 128), with the
next-layer qkv (B2) and without (B8a), at b = 1, 8, 16 and 17, on a card of
132 SMs (the H100): every output column of every product is owned by
exactly one block, every weight row of every product is streamed exactly
once, the shared bytes stay within the 232,448 a Hopper block may use, and
the ring holds every tile of the call where the call's weights fit beside
the activations (the T3 layer: ~127 KB an SM) and is a ring of stages where
they do not (the Qwen3 layer: ~470 KB an SM). ``tail_takes`` says which
shapes one launch takes on such a card; ``tail_rows`` the most rows one
launch takes at a width, so that a larger batch runs in row chunks (every
quantity of the tail is per row: the plain version on a batch equals it on
its chunks, bit for bit), and ``_dense_dispatch`` keeps JAX's path at any
batch on a card, raising where no launch takes the width.

``tail_plan(..., mlp="gelu")`` is B9b's plan (``csrc/tail_gelu.cu``) at the
XTTS layer (d_model 1024, d_ff 4096 in tiles of 2048, qkv 3072): the same
ownership and streaming, the fc one slab an item, and the down-projection
one item a (slab, d_ff tile), so that it spans 64 SMs instead of 32, each
block streaming the later tiles' items before the tile-0 item that waits
for them; with ``Q = 0`` it is B9c's (the same body without the next
qkv). ``gelu_takes`` says which shapes the one-launch body takes; the
others run the old chain. ``tail_plan(..., mlp="gelu_mlp")`` is B9d's (the
same body's MLP branch): the fc and down items alone, no o-projection and no
qkv; ``mlp_gelu_takes`` says which shapes it takes. ``tail_plan(...,
mlp="swiglu_mlp")`` is B8b's (B2's body's MLP branch): B8a's gate | up and
down items without the o-projection's; ``mlp_swiglu_takes`` says which
shapes it takes (the others run the old chain).
"""

import dataclasses

import numpy as np
import pytest
import torch

from vocalie_tts_tpu_torch.ops import _build
from vocalie_tts_tpu_torch.ops.cache_update import append_word
from vocalie_tts_tpu_torch.ops.decode_dense import (
    SLAB,
    SMEM_MAX,
    TAIL_MAX_STAGES,
    gelu_takes,
    mlp_gelu_takes,
    mlp_swiglu_takes,
    pick_tile,
    tail_item_rows,
    tail_plan,
    tail_rows,
    tail_stream,
    tail_swiglu_qkv_int8_plain,
    tail_takes,
    TILE_BUDGET,
)

H100_SMS = 132

#: (label, d_attn, d_model, d_ff, d_qkv)
WIDTHS = [("t3", 1024, 1024, 4096, 3072), ("qwen3", 2048, 2048, 8192, 4096),
          ("tiny", 64, 64, 128, 128)]


def _plan(width, b, with_qkv):
    _, d_attn, d, d_ff, Q = width
    tile = pick_tile(d_ff, TILE_BUDGET, 2 * d)
    Q = Q if with_qkv else 0
    return tail_plan(b, d_attn, d, d_ff, tile, Q, H100_SMS), (d_attn, d, d_ff, tile, Q)


@pytest.mark.parametrize("with_qkv", [True, False], ids=["B2", "B8a"])
@pytest.mark.parametrize("b", [1, 8, 16, 17])
@pytest.mark.parametrize("width", WIDTHS, ids=[w[0] for w in WIDTHS])
def test_tail_plan_owns_every_column_and_streams_every_row_once(width, b, with_qkv):
    plan, (d_attn, d, d_ff, tile, Q) = _plan(width, b, with_qkv)
    n_cols = (d, 2 * d_ff, d, Q)
    k_rows = (d_attn, d, d_ff, d)
    # columns: each (product, slab) item owned by exactly one block
    owned = [(p, s) for its in plan.items for p, s in its]
    assert len(owned) == len(set(owned))
    assert sorted(owned) == [(p, s) for p in range(4) for s in range(n_cols[p] // SLAB // (
        2 if p == 1 else 1))]
    # rows: each (product, 32-column slab, kc-row tile) streamed exactly once
    tiles = []
    for blk in range(plan.grid):
        stream = tail_stream(plan, blk, d_attn, d, d_ff)
        assert len(stream) == plan.tiles[blk]
        assert [p for p, _, _ in stream] == sorted(p for p, _, _ in stream), "product order"
        tiles += stream
    assert len(tiles) == len(set(tiles))
    assert sorted(tiles) == sorted((p, c, r) for p in range(4)
                                   for c in range(0, n_cols[p], SLAB)
                                   for r in range(0, k_rows[p], plan.kc))
    # a tile lies in one d_ff tile of the down-projection (its int32 sum is
    # scaled per tile), and an item's columns in one d_ff tile of the hidden
    assert tile % plan.kc == 0 and d_attn % plan.kc == 0 and d % plan.kc == 0
    assert all(SLAB * s // tile == (SLAB * s + SLAB - 1) // tile
               for its in plan.items for p, s in its if p == 1)
    # the table the kernel reads: grid + 1 offsets, then the items
    table = plan.table()
    assert table[:plan.grid + 1] == [sum(len(i) for i in plan.items[:k])
                                     for k in range(plan.grid + 1)]
    assert len(table) == plan.grid + 1 + len(owned)
    assert plan.grid <= H100_SMS


@pytest.mark.parametrize("b", [1, 8, 16, 17])
@pytest.mark.parametrize("width", WIDTHS, ids=[w[0] for w in WIDTHS])
def test_tail_plan_shared_bytes_and_ring_depth(width, b):
    plan, (d_attn, d, d_ff, tile, Q) = _plan(width, b, True)
    assert plan.smem <= SMEM_MAX
    stage = plan.kc * SLAB
    # the ring is what is left after the activations and the sums, in stages
    fixed = plan.smem - plan.stages * stage
    assert b * (max(d_attn, d, d_ff) + 16) <= fixed
    assert 1 <= plan.stages <= TAIL_MAX_STAGES
    biggest = max(plan.tiles)
    per_sm = sum(tail_item_rows(p, d_attn, d, d_ff) * SLAB
                 for its in plan.items for p, _ in its) / plan.grid
    if width[0] == "qwen3":
        # ~470 KB of weights an SM: a ring of as many stages as fit, refilled
        assert per_sm > SMEM_MAX and not plan.ring_holds_all
        assert plan.stages < biggest
        assert fixed + (plan.stages + 1) * stage > SMEM_MAX
    else:
        # the ring holds every tile of the block at once
        assert plan.ring_holds_all and plan.stages == biggest
    if width[0] == "t3":
        assert per_sm < 128 * 1024 and plan.kc == 1024 and plan.grid == H100_SMS
        # the blocks' weight bytes: dealt largest first, none above 128 KB
        loads = [sum(tail_item_rows(p, d_attn, d, d_ff) * SLAB for p, _ in its)
                 for its in plan.items]
        assert max(loads) <= 128 * 1024


@pytest.mark.parametrize("kw,match", [
    (dict(b=33), "rows"),
    (dict(b=0), "rows"),
    (dict(d=1000), "d_model"),
    (dict(d=4096, d_attn=4096), "norm rows"),
    (dict(Q=100), "d_qkv"),
    (dict(b=32, d_ff=16384, tile=1024, d=2048, d_attn=2048), "shared memory"),
])
def test_tail_plan_refuses_what_the_body_does_not_take(kw, match):
    args = dict(b=16, d_attn=1024, d=1024, d_ff=4096, tile=2048, Q=3072, sms=H100_SMS)
    args.update(kw)
    with pytest.raises(ValueError, match=match):
        tail_plan(**args)


@pytest.mark.parametrize("b,d,d_ff,Q,takes", [
    (16, 1024, 4096, 3072, True),     # the T3 layer
    (32, 1024, 4096, 3072, True),     # its most rows
    (33, 1024, 4096, 3072, False),    # a batch past 32 rows
    (33, 1024, 4096, 0, False),       # B8a alike
    (16, 2048, 8192, 4096, True),     # the Qwen3 layer at its CFG batch
    (24, 2048, 8192, 4096, False),    # its hidden rows leave no room for a ring
    (8, 4096, 16384, 12288, False),   # normed rows past 2048
])
def test_tail_takes_what_tail_plan_plans(b, d, d_ff, Q, takes):
    tile = pick_tile(d_ff, TILE_BUDGET, 2 * d)
    assert tail_takes(b, d, d, d_ff, Q, H100_SMS) is takes
    if not takes:
        with pytest.raises(ValueError):
            tail_plan(b, d, d, d_ff, tile, Q, H100_SMS)
    # off a card the plain version takes any shape
    assert tail_takes(b, d, d, d_ff, Q, None) is True


XTTS = (1024, 1024, 4096, 3072)   # d_attn, d_model, d_ff, d_qkv


@pytest.mark.parametrize("b", [1, 8, 16, 17, 32])
def test_gelu_plan_owns_every_column_and_streams_every_row_once(b):
    d_attn, d, d_ff, Q = XTTS
    tile = pick_tile(d_ff, TILE_BUDGET, 2 * d)
    n_tiles = d_ff // tile
    plan = tail_plan(b, d_attn, d, d_ff, tile, Q, H100_SMS, mlp="gelu")
    assert (plan.mlp, plan.tile, n_tiles) == ("gelu", 2048, 2)
    owned = [(p, s) for its in plan.items for p, s in its]
    assert len(owned) == len(set(owned))
    n_items = (d // SLAB, d_ff // SLAB, d // SLAB * n_tiles, Q // SLAB)
    assert sorted(owned) == [(p, s) for p in range(4) for s in range(n_items[p])]
    n_cols, k_rows = (d, d_ff, d, Q), (d_attn, d, d_ff, d)
    tiles = []
    for blk in range(plan.grid):
        stream = tail_stream(plan, blk, d_attn, d, d_ff)
        assert len(stream) == plan.tiles[blk]
        tiles += stream
        # a block's down items: the later d_ff tiles' parts before any tile-0 item
        down_t = [n_tiles - 1 - s // (d // SLAB) for p, s in plan.items[blk] if p == 2]
        assert down_t == sorted(down_t, reverse=True)
    assert len(tiles) == len(set(tiles))
    assert sorted(tiles) == sorted((p, c, r) for p in range(4)
                                   for c in range(0, n_cols[p], SLAB)
                                   for r in range(0, k_rows[p], plan.kc))
    assert plan.smem <= SMEM_MAX and tile % plan.kc == 0
    # the ring holds all of a block's tiles up to 17 rows (at 32 the activations take 131 KB)
    assert plan.ring_holds_all or b > 17
    # the down-projection spans 64 SMs (32 slabs x 2 tiles), not 32
    assert sum(any(p == 2 for p, _ in its) for its in plan.items) == 64
    assert plan.grid == H100_SMS


@pytest.mark.parametrize("b", [1, 8, 16, 17, 32])
def test_gelu_plan_without_the_next_qkv(b):
    """B9c's plan (``Q = 0``): B9b's at the XTTS widths without the qkv
    slabs: the same tile, every o / fc / down column owned once and every
    weight row streamed once, within the shared bytes, over every SM."""
    d_attn, d, d_ff, Q = XTTS
    tile = pick_tile(d_ff, TILE_BUDGET, 2 * d)
    plan = tail_plan(b, d_attn, d, d_ff, tile, 0, H100_SMS, mlp="gelu")
    assert (plan.mlp, plan.tile) == ("gelu", 2048) and tile % plan.kc == 0
    # the same items as B9b's but the qkv slabs
    with_qkv = tail_plan(b, d_attn, d, d_ff, tile, Q, H100_SMS, mlp="gelu")
    assert sorted(it for its in with_qkv.items for it in its if it[0] < 3) == sorted(
        it for its in plan.items for it in its)
    owned = [(p, s) for its in plan.items for p, s in its]
    n_items = (d // SLAB, d_ff // SLAB, d // SLAB * (d_ff // tile))
    assert sorted(owned) == [(p, s) for p in range(3) for s in range(n_items[p])]
    tiles = [t for blk in range(plan.grid) for t in tail_stream(plan, blk, d_attn, d, d_ff)]
    assert sorted(tiles) == sorted((p, c, r) for p, (n, k) in enumerate(
        ((d, d_attn), (d_ff, d), (d, d_ff))) for c in range(0, n, SLAB)
        for r in range(0, k, plan.kc))
    assert plan.smem <= SMEM_MAX and plan.grid == H100_SMS
    assert sum(any(p == 2 for p, _ in its) for its in plan.items) == 64
    assert gelu_takes(b, d_attn, d, d_ff, 0, H100_SMS)


@pytest.mark.parametrize("b,Q,sms,takes", [
    (8, 3072, H100_SMS, True),     # the XTTS bench batch
    (32, 3072, H100_SMS, True),    # the most rows
    (33, 3072, H100_SMS, False),   # past 32 rows: the old chain
    (8, 0, H100_SMS, True),        # B9c (no next qkv): the body's Q = 0 branch
    (8, 3072, None, False),        # off a card: the plain version
])
def test_gelu_takes_what_the_gelu_plan_plans(b, Q, sms, takes):
    d_attn, d, d_ff, _ = XTTS
    assert gelu_takes(b, d_attn, d, d_ff, Q, sms) is takes
    if b > 32:
        with pytest.raises(ValueError, match="rows"):
            tail_plan(b, d_attn, d, d_ff, 2048, Q, H100_SMS, mlp="gelu")


@pytest.mark.parametrize("b", [1, 8, 17, 32])
def test_gelu_mlp_plan_deals_every_item_once(b):
    """B9d's plan (``mlp="gelu_mlp"``) at the XTTS widths: every fc slab and
    every (down slab, d_ff tile) pair is dealt exactly once, no block holds
    an o-projection or a qkv item, every weight row of the two products is
    streamed once, the later tiles' down items before a block's tile-0 item,
    within the shared bytes, over every SM."""
    _, d, d_ff, _ = XTTS
    tile = pick_tile(d_ff, TILE_BUDGET, 2 * d)
    n_tiles = d_ff // tile
    plan = tail_plan(b, 0, d, d_ff, tile, 0, H100_SMS, mlp="gelu_mlp")
    assert (plan.mlp, plan.tile, n_tiles) == ("gelu_mlp", 2048, 2)
    owned = [(p, s) for its in plan.items for p, s in its]
    assert len(owned) == len(set(owned))
    assert sorted(owned) == ([(1, s) for s in range(d_ff // SLAB)]
                             + [(2, s) for s in range(d // SLAB * n_tiles)])
    tiles = [t for blk in range(plan.grid) for t in tail_stream(plan, blk, 0, d, d_ff)]
    assert len(tiles) == sum(plan.tiles)
    assert sorted(tiles) == sorted((p, c, r) for p, (n, k) in ((1, (d_ff, d)), (2, (d, d_ff)))
                                   for c in range(0, n, SLAB) for r in range(0, k, plan.kc))
    for its in plan.items:
        down_t = [n_tiles - 1 - s // (d // SLAB) for p, s in its if p == 2]
        assert down_t == sorted(down_t, reverse=True)
    assert plan.smem <= SMEM_MAX and tile % plan.kc == 0 and plan.grid == H100_SMS
    assert sum(any(p == 2 for p, _ in its) for its in plan.items) == 64


@pytest.mark.parametrize("b,d,d_ff,sms,takes", [
    (8, 1024, 4096, H100_SMS, True),     # the XTTS layer
    (32, 1024, 4096, H100_SMS, True),    # the most rows
    (33, 1024, 4096, H100_SMS, False),   # past 32 rows: the old chain
    (8, 2048, 8192, H100_SMS, True),     # the widest rows
    (8, 2080, 8192, H100_SMS, False),    # past 2048: the old chain
    (8, 1024, 4096, None, False),        # off a card: the plain version
])
def test_mlp_gelu_takes_what_the_plan_plans(b, d, d_ff, sms, takes):
    assert mlp_gelu_takes(b, d, d_ff, sms) is takes
    tile = pick_tile(d_ff, TILE_BUDGET, 2 * d)
    if sms is not None and not takes:
        with pytest.raises(ValueError, match="B9d"):
            tail_plan(b, 0, d, d_ff, tile, 0, sms, mlp="gelu_mlp")
    with pytest.raises(ValueError, match="no o-projection"):
        tail_plan(8, 1024, 1024, 4096, 2048, 0, H100_SMS, mlp="gelu_mlp")


@pytest.mark.parametrize("d_ff,tile", [(4096, 2048), (8192, 1024)], ids=["t3", "qwen3"])
@pytest.mark.parametrize("b", [1, 8, 17, 23])
def test_mlp_swiglu_plan_deals_every_item_once(b, d_ff, tile):
    """B8b's plan (``mlp="swiglu_mlp"``): gate | up items (a gate slab with
    its up slab) and down items (a whole slab over d_ff), each owned by one
    block, every weight row streamed once, gate | up before down in each
    block's stream; B8a's plan without its o-projection items."""
    d = d_ff // 4
    plan = tail_plan(b, 0, d, d_ff, tile, 0, H100_SMS, mlp="swiglu_mlp")
    owned = [(p, s) for its in plan.items for p, s in its]
    assert len(owned) == len(set(owned))
    assert sorted(owned) == ([(1, s) for s in range(d_ff // SLAB)]
                             + [(2, s) for s in range(d // SLAB)])
    tiles = [t for blk in range(plan.grid) for t in tail_stream(plan, blk, 0, d, d_ff)]
    assert len(tiles) == sum(plan.tiles) == len(set(tiles))
    assert sorted(tiles) == sorted((p, c, r) for p, (n, k) in ((1, (2 * d_ff, d)), (2, (d, d_ff)))
                                   for c in range(0, n, SLAB) for r in range(0, k, plan.kc))
    for its in plan.items:
        assert [p for p, _ in its] == sorted(p for p, _ in its)
    assert plan.smem <= SMEM_MAX and tile % plan.kc == 0 and plan.grid == H100_SMS
    b8a = tail_plan(b, d, d, d_ff, tile, 0, H100_SMS)
    assert b8a.smem - b8a.stages * b8a.kc * SLAB == plan.smem - plan.stages * plan.kc * SLAB
    assert sorted(owned) == sorted((p, s) for its in b8a.items for p, s in its if p)


@pytest.mark.parametrize("b,d,d_ff,sms,takes", [
    (8, 2048, 8192, H100_SMS, True),     # the Qwen3 layer
    (23, 2048, 8192, H100_SMS, True),    # its most rows: 23 hidden rows of 8208 bytes
    (24, 2048, 8192, H100_SMS, False),   # no room for a two-stage ring: the old chain
    (32, 1024, 4096, H100_SMS, True),    # the T3 widths' most rows
    (33, 1024, 4096, H100_SMS, False),   # past 32 rows: the old chain
    (8, 2080, 8192, H100_SMS, False),    # past 2048: the old chain
    (8, 1024, 4096, None, False),        # off a card: the plain version
])
def test_mlp_swiglu_takes_what_the_plan_plans(b, d, d_ff, sms, takes):
    assert mlp_swiglu_takes(b, d, d_ff, sms) is takes
    tile = pick_tile(d_ff, TILE_BUDGET, 2 * d)
    if sms is not None and not takes:
        with pytest.raises(ValueError, match="B8b"):
            tail_plan(b, 0, d, d_ff, tile, 0, sms, mlp="swiglu_mlp")
    with pytest.raises(ValueError, match="B8b has no o-projection"):
        tail_plan(8, 1024, 1024, 4096, 2048, 0, H100_SMS, mlp="swiglu_mlp")


@pytest.mark.parametrize("d,d_ff,Q,rows", [
    (1024, 4096, 3072, 32),    # the T3 layer, B2
    (1024, 4096, 0, 32),       # B8a
    (2048, 8192, 4096, 22),    # the Qwen3 layer, B2: its hidden rows fill shared memory first
    (2048, 8192, 0, 23),       # B8a
    (4096, 16384, 12288, None),   # normed rows past 2048: no launch
])
def test_tail_rows_is_the_most_rows_one_launch_takes(d, d_ff, Q, rows):
    assert tail_rows(d, d, d_ff, Q, H100_SMS) == rows
    if rows is not None:
        assert tail_takes(rows, d, d, d_ff, Q, H100_SMS)
        assert rows == 32 or not tail_takes(rows + 1, d, d, d_ff, Q, H100_SMS)


@pytest.mark.parametrize("megatail", [True, False], ids=["B2", "B8a"])
def test_dispatch_sends_untaken_tail_shapes_to_dense_fns(monkeypatch, megatail):
    """No shape is sent to ``DENSE_FNS`` any more: on a card (``card_sms``
    answering 132) the T3 layer keeps the megatail (or, with
    ``VOCALIE_MEGATAIL=0``, the tail) at 32, 33 and 64 rows, which run in
    row chunks, as off a card; normed rows of 4096, which no launch takes,
    raise ``ValueError`` naming the shape on a card and keep the path off
    it (the plain versions take any shape)."""
    from vocalie_tts_tpu_torch.models.chatterbox.runtime import SCALES
    from vocalie_tts_tpu_torch.models.common import transformer as tr
    from vocalie_tts_tpu_torch.models.common.ar_runtime import apply_runtime_env

    monkeypatch.setenv("VOCALIE_DENSE_KERNEL", "1")
    monkeypatch.setenv("VOCALIE_KV_INT8", "1")
    monkeypatch.delenv("VOCALIE_MEGALAYER", raising=False)
    if megatail:
        monkeypatch.delenv("VOCALIE_MEGATAIL", raising=False)
    else:
        monkeypatch.setenv("VOCALIE_MEGATAIL", "0")
    path = tr.MEGATAIL if megatail else tr.TAIL

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
    assert tr._dense_dispatch(layers_at(1024, 4096), cfg, 33, 640) == path
    assert tr._dense_dispatch(layers_at(4096, 16384), wide, 8, 640) == path
    monkeypatch.setattr(tr, "card_sms", lambda device: H100_SMS)
    for b in (32, 33, 64):
        assert tr._dense_dispatch(layers_at(1024, 4096), cfg, b, 640) == path
    with pytest.raises(ValueError, match="d_model=4096, d_attn=4096, d_ff=16384"):
        tr._dense_dispatch(layers_at(4096, 16384), wide, 8, 640)


def test_plain_tail_on_row_chunks_is_the_one_call():
    """The plain B2 on 33 rows equals, bit for bit, the concatenation of the
    plain B2 on its row chunks (16 and 17 rows): what a card computes for a
    batch past 32 rows is the one call's result (every quantity is per
    row)."""
    from vocalie_tts_tpu_torch.ops.decode_dense import _row_chunks

    rng = np.random.default_rng(33)
    L, b, d, d_ff, Q = 2, 33, 128, 256, 384

    def i8(*shape):
        return torch.from_numpy(rng.integers(-127, 128, shape).astype(np.int8))

    def f32(*shape, scale=1.0, shift=0.0):
        return torch.from_numpy((shift + scale * rng.standard_normal(shape)).astype(np.float32))

    attn, x = f32(b, d, scale=0.3), f32(b, d).to(torch.bfloat16)
    weights = (i8(L, d, d), f32(L, 1, d, scale=1e-3, shift=4e-3), f32(L, d, scale=0.1, shift=1),
               i8(L, d, 2 * d_ff), f32(L, 1, 2 * d_ff, scale=1e-3, shift=4e-3),
               i8(L, d_ff, d), f32(L, 1, d, scale=1e-3, shift=4e-3),
               f32(L, d, scale=0.1, shift=1), i8(L, d, Q), f32(L, 1, Q, scale=1e-3, shift=4e-3))
    chunks = _row_chunks(b, 32)
    assert chunks == [(0, 16), (16, 33)]
    whole = tail_swiglu_qkv_int8_plain(attn, x, *weights, 1, eps=1e-5)
    parts = [tail_swiglu_qkv_int8_plain(attn[r0:r1], x[r0:r1], *weights, 1, eps=1e-5)
             for r0, r1 in chunks]
    for i, name in enumerate(("x_out", "qkv")):
        assert torch.equal(whole[i], torch.cat([p[i] for p in parts])), name


@pytest.mark.parametrize("row_bytes,ptrs,word", [
    (128, (0, 256, 1024, 4096), 16),       # K4's bf16 rows of d 64
    (256, (0, 512), 16),                   # K5's bf16 k|v rows of 128
    (32, (0, 64), 16),                     # f32 rows of d 8
    (64, (0, 64), 16),                     # int8 rows of d 64
    (24, (0, 48), 4),                      # int8 rows of 24: not a 16-multiple
    (48, (0, 8, 1024, 16), 4),             # bf16 rows of 24: one pointer 8-aligned
    (128, (0, 2, 1024, 16), 1),            # a 2-aligned pointer
    (3, (0, 16), 1),                       # 3-byte int8 rows
    (4, (0, 4), 4),                        # bf16 rows of 2
])
def test_append_word_by_row_width_and_alignment(row_bytes, ptrs, word):
    assert append_word(row_bytes, *ptrs) == word


@pytest.mark.parametrize("rc,hint", [
    (716, "16-byte boundary"),   # cudaErrorMisalignedAddress: B2, B9b and B7 check their inputs
    (1, None),                   # cudaErrorInvalidValue: the cudaError alone
])
def test_a_refused_launch_names_its_cause(rc, hint):
    """The one-launch bodies' C entries check each input's 16-byte
    alignment themselves; ``_build.check`` raises with the error and, for a
    misaligned input, what it means."""
    with pytest.raises(RuntimeError, match=f"vt_tail_gelu_qkv_int8 failed to launch: "
                                           f"cudaError {rc}") as err:
        _build.check(rc, "vt_tail_gelu_qkv_int8")
    assert (hint in str(err.value)) if hint else str(err.value).endswith(f"cudaError {rc}")
    _build.check(0, "vt_tail_gelu_qkv_int8")
