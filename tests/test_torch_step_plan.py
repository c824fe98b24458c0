"""The launch plan of the port's whole-step kernel (B7:
``csrc/decode_step.cu``), a pure function of the shape and the grid: the
CUDA body runs only on the card (``tests/test_torch_kernels_cuda.py`` and
``chip_smoke.py`` hold it against its plain version there), and what each
block is told to do is decided here in Python.

``step_plan`` at the CosyVoice LM's shape (24 layers, d_model 1024, d_ff
4096, 16 heads of 64, the streaming request's 640-slot cache), at the
shapes of the CUDA tests (d_head 32 to 128, caches of 128 to 640 slots)
and on 132 SMs (the H100): every output column of every product and every
slot of every head is owned by exactly one block, each attention split by
a block of its own, and no block holds two items of one phase; an
attention split's cache rows fit one ring tile;
the shared bytes stay within the 232,448 a Hopper block may use; at the
CosyVoice shape the attention spans 64 SMs (4 splits a head, not the 16
blocks of one a head) and the ring holds a layer's tiles of every block.
Shapes the body does not take are refused.
"""

import pytest

from vocalie_tts_tpu_torch.ops.decode_dense import SLAB, SMEM_MAX
from vocalie_tts_tpu_torch.ops.decode_step import (
    ATT,
    DOWN,
    GU,
    OPROJ,
    QKV,
    STEP_MAX_STAGES,
    step_item_bytes,
    step_item_tiles,
    step_plan,
)

H100_SMS = 132

#: (label, L, H, d, D, F, T): the CosyVoice LM and the CUDA tests' shapes
SHAPES = [("cosyvoice", 24, 16, 64, 1024, 4096, 640), ("small", 3, 4, 64, 256, 512, 128),
          ("long", 1, 4, 64, 256, 512, 640), ("d128", 3, 2, 128, 256, 384, 128),
          ("d32", 1, 8, 32, 512, 1024, 256)]


@pytest.mark.parametrize("shape", SHAPES, ids=[s[0] for s in SHAPES])
def test_step_plan_owns_every_column_and_slot_once(shape):
    _, L, H, d, D, F, T = shape
    plan = step_plan(L, H, d, D, F, T, H100_SMS)
    owned = [item for its in plan.items for item in its]
    assert len(owned) == len(set(owned))
    counts = {ATT: H * plan.S, OPROJ: D // SLAB, GU: F // SLAB, DOWN: D // SLAB, QKV: 3 * H}
    assert sorted(owned) == [(k, i) for k in range(5) for i in range(counts[k])]
    # the splits cover each head's cache: S blocks of n slots, n a multiple of 8
    assert plan.S * plan.n == T and plan.n % 8 == 0
    # each split on a block of its own; a block streams its items in kind order
    att = [blk for blk, its in enumerate(plan.items) for k, _ in its if k == ATT]
    assert len(att) == len(set(att)) == H * plan.S
    assert all(list(its) == sorted(its) for its in plan.items)
    # the table the kernel reads: grid + 1 offsets, then the items
    table = plan.table()
    assert table[:plan.grid + 1] == [sum(len(i) for i in plan.items[:k])
                                     for k in range(plan.grid + 1)]
    assert table[plan.grid + 1:] == [k << 24 | i for its in plan.items for k, i in its]
    assert plan.grid == H100_SMS


@pytest.mark.parametrize("shape", SHAPES, ids=[s[0] for s in SHAPES])
def test_step_plan_tiles_fit_the_ring(shape):
    _, L, H, d, D, F, T = shape
    plan = step_plan(L, H, d, D, F, T, H100_SMS)
    stage = plan.kc * SLAB
    assert plan.smem <= SMEM_MAX and 2 <= plan.stages <= STEP_MAX_STAGES
    # a weight tile is kc rows of one product's K; a split's cache rows fit a stage
    assert (H * d) % plan.kc == 0 and D % plan.kc == 0 and F % plan.kc == 0
    assert step_item_bytes(ATT, H, d, D, F, plan.n) <= stage
    assert plan.tiles == tuple(sum(step_item_tiles(k, H, d, D, F, plan.kc) for k, _ in its)
                               for its in plan.items)
    assert plan.ring_holds_layer == (plan.stages >= max(plan.tiles))


def test_step_plan_at_the_cosyvoice_shape():
    """Attention on 64 SMs (4 splits of 160 slots a head), 32 KB tiles, no
    block with two items of one phase (a phase would wait on it twice), and
    a ring of six that holds each block's layer (at most six tiles: a gate |
    up pair and a down slab): the next layer's tiles are requested while the
    block still works on the current one."""
    plan = step_plan(24, 16, 64, 1024, 4096, 640, H100_SMS)
    assert (plan.S, plan.n, plan.kc) == (4, 160, 1024)
    assert sum(any(k == ATT for k, _ in its) for its in plan.items) == 64
    assert all(sum(k == kind for k, _ in its) <= 1 for its in plan.items for kind in range(5))
    assert plan.ring_holds_layer and plan.stages == 6 and max(plan.tiles) == 6
    loads = [sum(step_item_bytes(k, 16, 64, 1024, 4096, plan.n) for k, _ in its)
             for its in plan.items]
    # a layer's 16 MiB of weights and 1.3 MB of cache
    assert sum(loads) == 16 * 2 ** 20 + 16 * 640 * 132
    assert max(loads) <= 192 * 1024 + step_item_bytes(ATT, 16, 64, 1024, 4096, plan.n)


@pytest.mark.parametrize("kw,match", [
    (dict(H=65), "heads"),
    (dict(d=48), "heads"),
    (dict(d=256), "heads"),
    (dict(T=100), "multiple of 128"),
    (dict(D=1000), "multiple"),
    (dict(grid=32), "blocks"),
])
def test_step_plan_refuses_what_the_body_does_not_take(kw, match):
    args = dict(L=24, H=16, d=64, D=1024, F=4096, T=640, grid=H100_SMS)
    args.update(kw)
    with pytest.raises(ValueError, match=match):
        step_plan(**args)
