"""The launch planners of B1 (the int8 T-blocked decode attention, split over
a thread-block cluster), B1w (the int8 whole-row decode attention, split the
same way) and B13 (the one-pass GroupNorm, a cluster per batch
row), on the CPU, in pure Python:

- ``int8_splits``: at most the valid 128-slot blocks, whole blocks a rank
  (``int8_block_ranges``), no rank empty, the scores within the shared
  memory a block may take, every cluster resident in one wave; the counts
  at the main path's two shapes;
- a plain-PyTorch emulation of the kernel's order of operations (each rank's
  scores and block maxima, its chain from the prefix max of the ranks
  before it, the ranks merged in order, the current token last) against
  ``decode_attention_plain``: bit-equal where every rank holds one block or
  one rank holds them all, within an ulp-sized bound otherwise;
- ``gn_plan``: every studio row (``chip_smoke.py`` ``GN_CASES``) fits a
  cluster of blocks that an SM holds two of, the blocks cover the row with
  none empty, the counts at those shapes; a row past 16 blocks' shared
  memory takes the two-pass route;
- ``whole_splits`` (B1w split over a cluster, off the 128-slot grid): every
  slot in exactly one rank (``whole_ranges``), at most 16 ranks, a rank's
  scores and v rows within a block's shared memory, the counts at the T3
  and Qwen3 shapes, a row past 16 ranks' room on the one-block body; a
  plain-PyTorch emulation of the split kernel's order of operations against
  ``decode_attention_whole_plain``;
- CPU calls of the wrappers run their plain versions and count nothing.

The kernels themselves are held against their plain versions on the card in
``tests/test_torch_kernels_cuda.py``.
"""

import pytest
import torch

from vocalie_tts_tpu_torch.ops import decode_attention as da
from vocalie_tts_tpu_torch.ops import groupnorm as gn
from vocalie_tts_tpu_torch.ops.decode_dense import _quantize_rows

#: the studio path's B13 rows (chip_smoke.py GN_CASES): (b, spatial rows, C)
GN_ROWS = {"unet_level0": (128, 16 * 32, 128), "unet_level2": (128, 4 * 8, 1024),
           "vae_level0": (64, 64 * 128, 64), "unet_level1": (128, 8 * 16, 384)}
SMS = 132


# ── B1: int8_splits ─────────────────────────────────────────────────────


def _resident(blocks_an_sm: int):
    """The card's resident clusters of n blocks where an SM holds
    ``blocks_an_sm`` of B1's blocks (132 SMs)."""
    return lambda n: SMS * blocks_an_sm // n


@pytest.mark.parametrize("bc,n_blk,g,d,per_sm,want", [
    (256, 4, 1, 64, 5, 2),     # T3 voice-over: 16 rows x 16 kv heads, 416 valid slots
    (256, 4, 1, 64, 1, 1),     # the same where 2 ranks would take two waves
    (64, 3, 2, 128, 4, 3),     # Qwen3: 8 rows x 8 kv heads, 352 valid slots
    (8, 4, 2, 128, 4, 4),      # Qwen3 batch 1: every block its own rank
    (1, 40, 1, 64, 8, 16),     # one pair, a long cache: the largest cluster
    (512, 5, 1, 64, 8, 1),     # pairs enough for two blocks an SM: no split
])
def test_int8_splits_at_the_card_shapes(bc, n_blk, g, d, per_sm, want):
    assert da.int8_splits(bc, n_blk, g, d, _resident(per_sm)) == want


@pytest.mark.parametrize("g", [1, 2, 4, 8])
@pytest.mark.parametrize("n_blk", [1, 2, 3, 4, 5, 7, 16, 33])
@pytest.mark.parametrize("bc", [1, 8, 64, 256])
def test_int8_splits_fall_on_block_boundaries(bc, n_blk, g):
    s = da.int8_splits(bc, n_blk, g, 128)
    assert 1 <= s <= min(n_blk, da.INT8_SPLIT_MAX)
    ranges = da.int8_block_ranges(n_blk, s)
    assert ranges[0][0] == 0 and ranges[-1][1] == n_blk
    assert all(lo < hi for lo, hi in ranges)                       # no rank empty
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))   # contiguous, whole blocks
    assert max(hi - lo for lo, hi in ranges) == -(-n_blk // s)     # the kernel's nbm
    assert da.int8_smem(g, 128, n_blk, s) <= da.INT8_SMEM_MAX


@pytest.mark.parametrize("resident", [1, 100, 255, 300, 10_000])
def test_int8_splits_keep_one_wave(resident):
    """Past one split, every cluster of the chosen size is resident at
    once: a count whose clusters the card cannot all hold is not taken."""
    bc = 100
    s = da.int8_splits(bc, 4, 1, 64, lambda n: resident // n)
    assert s == 1 or bc <= resident // s
    assert s == max([1] + [n for n in range(2, 4) if resident // n >= bc])


def test_int8_splits_make_room_for_long_caches():
    """A rank's scores must fit the shared memory a block may take: a long
    cache at g 8 needs more than one rank whatever the pairs, and past 16
    ranks' room the planner refuses."""
    assert da.int8_smem(8, 128, 64, 1) > da.INT8_SMEM_MAX
    s = da.int8_splits(10_000, 64, 8, 128, lambda n: 0)   # no wave to fill
    assert s > 1 and da.int8_smem(8, 128, 64, s) <= da.INT8_SMEM_MAX
    assert da.int8_smem(8, 128, 64, s - 1) > da.INT8_SMEM_MAX
    with pytest.raises(ValueError, match="shared memory"):
        da.int8_splits(1, 16 * 40, 8, 128)


# ── B1: the split's order of operations ─────────────────────────────────


def emulate_int8_split(q, k_all, v_all, bias, layer, k_scale, v_scale, k_new, v_new,
                       valid_len, sm_scale, splits):
    """``decode_attention_plain`` as the kernel orders it: the ranks of
    ``int8_block_ranges`` score their blocks and publish their maxima; rank
    r runs the chain over its own blocks from the prefix max of ranks
    0..r-1 (l and acc from 0); the ranks' (m, l, acc) merge in rank order
    (c = exp(M - m_r), A = A·c + acc_r, L = L·c + l_r from M = -1e30); the
    current token joins last."""
    TB = da.TBLK
    b, kv, g, d = q.shape
    T = k_all.shape[3]
    BC = b * kv
    f32 = torch.float32
    qf = q.reshape(BC, g, d).to(f32)
    qq, qs = _quantize_rows(qf)
    k = k_all[layer].reshape(BC, T, d).to(f32)
    v = v_all[layer].reshape(BC, T, d).to(f32)
    ks = k_scale[layer].reshape(BC, T).to(f32)
    vs = v_scale[layer].reshape(BC, T).to(f32)
    bias_m = bias.to(f32)[:, None, :].expand(b, kv, T).reshape(BC, T)
    n_blk = da.n_valid_blocks(valid_len, T)
    scores = []
    for blk in range(n_blk):
        sl = slice(blk * TB, (blk + 1) * TB)
        s = torch.matmul(qq, k[:, sl].transpose(1, 2)) * (qs * sm_scale)
        scores.append(s * ks[:, None, sl] + bias_m[:, None, sl])
    bmax = [s.amax(-1, keepdim=True) for s in scores]
    states, m_prefix = [], torch.full((BC, g, 1), -1e30, dtype=f32)
    for lo, hi in da.int8_block_ranges(n_blk, splits):
        m = m_prefix
        lsum = torch.zeros((BC, g, 1), dtype=f32)
        acc = torch.zeros((BC, g, d), dtype=f32)
        for blk in range(lo, hi):
            sl = slice(blk * TB, (blk + 1) * TB)
            m_new = torch.maximum(m, bmax[blk])
            corr = torch.exp(m - m_new)
            p = torch.exp(scores[blk] - m_new)
            lsum = lsum * corr + p.sum(-1, keepdim=True)
            p8, ps = _quantize_rows(p * vs[:, None, sl], floor=1e-20)
            acc = acc * corr + torch.matmul(p8, v[:, sl]) * ps
            m = m_new
        states.append((m, lsum, acc))
        m_prefix = torch.maximum(m_prefix, torch.stack(bmax[lo:hi]).amax(0))
    M = torch.full((BC, g, 1), -1e30, dtype=f32)
    L = torch.zeros((BC, g, 1), dtype=f32)
    A = torch.zeros((BC, g, d), dtype=f32)
    for m_r, l_r, a_r in states:
        c = torch.exp(M - m_r)
        A = A * c + a_r
        L = L * c + l_r
        M = m_r
    s_new = (qf * k_new.reshape(BC, 1, d).to(f32)).sum(-1, keepdim=True) * sm_scale
    m_fin = torch.maximum(M, s_new)
    c = torch.exp(M - m_fin)
    p_new = torch.exp(s_new - m_fin)
    out = (A * c + p_new * v_new.reshape(BC, 1, d).to(f32)) / torch.clamp(L * c + p_new,
                                                                            min=1e-30)
    return out.reshape(b, kv, g, d)


def _b1_inputs(seed, L, b, kv, g, T, d, valid_len, slope):
    gen = torch.Generator().manual_seed(seed)
    q = torch.randn((b, kv, g, d), generator=gen)
    k, v = (torch.randint(-127, 128, (L, b, kv, T, d), generator=gen, dtype=torch.int8)
            for _ in range(2))
    ks, vs = (((torch.rand((L, b, kv, T), generator=gen) + 0.5) / 127).to(torch.bfloat16)
              for _ in range(2))
    kn, vn = (torch.randn((b, kv, d), generator=gen) for _ in range(2))
    pos = torch.arange(T, dtype=torch.float32)[None, :].expand(b, T)
    bias = torch.where(pos < valid_len, slope * pos, torch.full_like(pos, -1e30)).contiguous()
    return q, k, v, bias, ks, vs, kn, vn


@pytest.mark.parametrize("slope", [0.0, 0.02, -0.02], ids=["flat", "rising", "falling"])
@pytest.mark.parametrize("g,d,valid_len,splits", [
    (1, 64, 416, 4), (1, 64, 416, 1), (1, 64, 416, 2), (1, 64, 416, 3),
    (2, 128, 352, 3), (2, 128, 352, 2), (2, 32, 129, 2), (4, 16, 100, 1),
])
def test_split_order_matches_the_plain_version(g, d, valid_len, splits, slope):
    """Every block's p is quantized against the chain's own running max in
    any split; where each rank holds one block (or one rank all) the merge
    repeats the chain's steps, so the emulation equals the plain version to
    the bit; otherwise only the rescaling of earlier ranks' sums is grouped
    otherwise (one exp for several corr factors)."""
    T = 512
    args = _b1_inputs(valid_len + g, 2, 2, 2, g, T, d, valid_len, slope)
    sm = d ** -0.5
    got = emulate_int8_split(*args[:4], 1, *args[4:], valid_len, sm, splits)
    ref = da.decode_attention_plain(*args[:4], 1, *args[4:], valid_len, sm)
    n_blk = da.n_valid_blocks(valid_len, T)
    if splits in (1, n_blk):
        assert torch.equal(got, ref), (got - ref).abs().max().item()
    else:
        assert torch.allclose(got, ref, atol=1e-6, rtol=1e-6), (got - ref).abs().max().item()


def test_b1_cpu_calls_run_the_plain_version():
    args = _b1_inputs(3, 1, 2, 2, 1, 256, 64, 200, 0.0)
    before = da.decode_attention_int8_stacked.launches
    out = da.decode_attention_int8_stacked(*args[:4], 0, *args[4:], valid_len=200, sm_scale=0.125)
    ref = da.decode_attention_plain(*args[:4], 0, *args[4:], 200, 0.125)
    assert torch.equal(out, ref) and da.decode_attention_int8_stacked.launches == before


# ── B1w: whole_splits ───────────────────────────────────────────────────


@pytest.mark.parametrize("g", [1, 2, 4, 8])
@pytest.mark.parametrize("n", [1, 7, 40, 352, 552, 7000])
@pytest.mark.parametrize("bc", [1, 8, 64, 256])
def test_whole_splits_cover_every_slot_once(bc, n, g):
    """Every slot lies in exactly one rank's range, the ranks are contiguous,
    none is empty, there are at most 16, and each rank's scores and v rows
    stay within the shared memory a block may take."""
    for d in (64, 128):
        s = da.whole_splits(bc, n, g, d)
        assert s is not None and 1 <= s <= da.WHOLE_SPLIT_MAX
        ranges = da.whole_ranges(n, s)
        assert ranges[0][0] == 0 and ranges[-1][1] == n
        assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
        assert all(lo < hi for lo, hi in ranges)
        assert max(hi - lo for lo, hi in ranges) <= -(-n // s)   # the kernel's layout
        assert da.whole_smem(g, d, -(-n // s)) <= da.WHOLE_SMEM_MAX


@pytest.mark.parametrize("bc,n,g,d,per_sm,want", [
    (256, 552, 1, 64, 8, 2),      # T3 voice-over at cache_len 600: 16 rows x 16 kv heads
    (256, 600, 1, 64, 8, 2),      # ... without the current token: all 600 slots
    (256, 552, 1, 64, 1, 1),      # the same where 2 ranks would take two waves
    (64, 352, 2, 128, 8, 3),      # Qwen3: 8 rows x 8 kv heads, 352 of 520 slots: 96 a rank
    (1, 6900, 8, 64, 8, 16),      # one pair, a long row at g 8: the largest cluster
    (512, 600, 1, 64, 8, 1),      # pairs enough for two blocks an SM: no split
])
def test_whole_splits_at_the_card_shapes(bc, n, g, d, per_sm, want):
    assert da.whole_splits(bc, n, g, d, _resident(per_sm)) == want


def test_whole_splits_make_room_for_long_rows():
    """A rank's scores and v rows must fit a block's shared memory: the T
    7000, g 8 row takes 5 ranks at least; a row that 16 ranks cannot hold
    (20,000 slots at g 8, d 128), or a card that holds no cluster of the
    fewest ranks, goes to the one-block body (None)."""
    assert da.whole_smem(8, 64, 6900 // 4 + 1) > da.WHOLE_SMEM_MAX
    assert da.whole_splits(1, 6900, 8, 64, lambda n: int(n == 5)) == 5   # no larger one resident
    assert da.whole_splits(1, 19_900, 8, 128) is None
    assert da.whole_smem(8, 128, -(-19_900 // 16)) > da.WHOLE_SMEM_MAX
    assert da.whole_splits(1, 6900, 8, 64, lambda n: 0) is None


def emulate_whole_split(q, k_all, v_all, bias, layer, k_scale, v_scale, k_new, v_new,
                        valid_len, sm_scale, splits):
    """``decode_attention_whole_plain`` as the split kernel orders it: each
    rank of ``whole_ranges`` scores its slots; M is the max of the ranks'
    maxima and the current token's score; each rank sums its p and takes its
    max of p · vs; ps from the max over the ranks; the int32 partials of the
    ranks summed; l summed in rank order; the current token last."""
    b, kv, g, d = q.shape
    T = k_all.shape[3]
    n = da._n_slots(T, k_new, valid_len)
    BC = b * kv
    f32 = torch.float32
    qf = q.reshape(BC, g, d).to(f32)
    qq, qs = _quantize_rows(qf)
    k = k_all[layer].reshape(BC, T, d).to(f32)
    v = v_all[layer].reshape(BC, T, d).to(f32)
    ks = k_scale[layer].reshape(BC, T).to(f32)
    vs = v_scale[layer].reshape(BC, T).to(f32)
    bias_m = bias.to(f32)[:, None, :].expand(b, kv, T).reshape(BC, T)
    ranges = da.whole_ranges(n, splits)
    s_r = [torch.matmul(qq, k[:, lo:hi].transpose(1, 2)) * (qs * sm_scale) * ks[:, None, lo:hi]
           + bias_m[:, None, lo:hi] for lo, hi in ranges]
    M = torch.stack([s.amax(-1, keepdim=True) for s in s_r]).amax(0)
    s_new = (qf * k_new.reshape(BC, 1, d).to(f32)).sum(-1, keepdim=True) * sm_scale
    M = torch.maximum(M, s_new)
    p_r = [torch.exp(s - M) for s in s_r]
    pv_r = [p * vs[:, None, lo:hi] for p, (lo, hi) in zip(p_r, ranges)]
    ps = torch.clamp(torch.stack([pv.amax(-1, keepdim=True) for pv in pv_r]).amax(0)
                     / torch.full_like(M, 127.0), min=1e-20)
    o = sum(torch.matmul(torch.round(pv / ps), v[:, lo:hi]) for pv, (lo, hi) in zip(pv_r, ranges))
    L = torch.zeros_like(M)
    for p in p_r:
        L = L + p.sum(-1, keepdim=True)
    p_new = torch.exp(s_new - M)
    out = (o * ps + p_new * v_new.reshape(BC, 1, d).to(f32)) / torch.clamp(L + p_new, min=1e-30)
    return out.reshape(b, kv, g, d)


@pytest.mark.parametrize("splits", [1, 3, 16])
@pytest.mark.parametrize("slope", [0.0, 0.02], ids=["flat", "rising"])
def test_whole_split_order_matches_the_plain_version(splits, slope):
    """Split over any count of ranks, every p8 rounds as in the plain version
    (one max and one p scale over the row): the outputs move only by the
    order in which l is summed."""
    valid_len = 300
    args = _b1_inputs(5, 1, 2, 2, 2, 320, 64, valid_len, slope)
    got = emulate_whole_split(*args[:4], 0, *args[4:], valid_len, 0.125, splits)
    ref = da.decode_attention_whole_plain(*args[:4], 0, *args[4:], valid_len, sm_scale=0.125)
    assert torch.allclose(got, ref, atol=1e-6, rtol=1e-6), (got - ref).abs().max().item()


def test_b1w_cpu_calls_run_the_plain_version():
    args = _b1_inputs(4, 1, 2, 2, 1, 200, 64, 150, 0.0)
    fn = da.decode_attention_int8_whole_stacked
    before = (fn.launches, fn.cluster_launches)
    out = fn(*args[:4], 0, *args[4:], valid_len=150, sm_scale=0.125)
    ref = da.decode_attention_whole_plain(*args[:4], 0, *args[4:], 150, sm_scale=0.125)
    assert torch.equal(out, ref) and (fn.launches, fn.cluster_launches) == before


# ── B13: gn_plan ────────────────────────────────────────────────────────


def _half() -> int:
    return gn.SM_SMEM // 2 - gn.BLOCK_RESERVED


@pytest.mark.parametrize("case", list(GN_ROWS))
def test_gn_plan_fits_every_studio_row(case):
    """Each studio row fits a cluster of at most 16 blocks that an SM holds
    two of; the blocks cover the row, none empty; a smaller cluster would
    not fit, or the blocks already fill the card twice over."""
    b, s, c = GN_ROWS[case]
    n, rows, pieces = gn.gn_plan(b, s, c, 32, 8, SMS)
    assert 1 <= n <= gn.MAX_CLUSTER and 1 <= pieces <= gn.MAX_PIECES
    assert n * rows >= s and (n - 1) * rows < s
    assert gn.gn_one_pass_smem(rows, c, 32, 8) <= _half()
    smaller = n - 1
    assert (smaller == 0 or gn.gn_one_pass_smem(-(-s // smaller), c, 32, 8) > _half()
            or b * n <= 2 * SMS)
    assert b * (n + 1) > 2 * SMS or n == gn.MAX_CLUSTER


@pytest.mark.parametrize("case,want", [
    ("unet_level0", (2, 256, 4)),    # 128 KB a row: two blocks of 64 KB, 256 blocks
    ("unet_level2", (2, 16, 2)),     # 64 KB: one block would do; two fill the card
    ("vae_level0", (11, 745, 6)),    # 1 MB: eleven blocks of 93 KB
    ("unet_level1", (2, 64, 3)),     # 96 KB and the row-thread tree: two blocks
])
def test_gn_plan_at_the_studio_shapes(case, want):
    b, s, c = GN_ROWS[case]
    assert gn.gn_plan(b, s, c, 32, 8, SMS) == want


def test_gn_plan_sends_rows_past_a_cluster_to_two_passes():
    """A 4 MB row is past 16 blocks of 227 KB: the two-pass route (None).
    A 3 MB row takes 16 blocks one an SM holds."""
    assert gn.gn_plan(1, 2048, 1024, 32, 8, SMS) is None
    n, rows, _ = gn.gn_plan(1, 1536, 1024, 32, 8, SMS)
    assert n == 16 and _half() < gn.gn_one_pass_smem(rows, 1024, 32, 8) <= gn.BLOCK_SMEM_MAX


@pytest.mark.parametrize("s,c,groups,vec", [(35, 36, 12, 4), (12, 30, 10, 2), (22, 15, 5, 1)])
def test_gn_plan_narrow_vectors_take_one_piece(s, c, groups, vec):
    """Without 16-byte vectors the threads copy the slice themselves: one
    piece, no bulk copy."""
    n, rows, pieces = gn.gn_plan(3, s, c, groups, vec, SMS)
    assert pieces == 1 and n * rows >= s and (n - 1) * rows < s


def test_gn_cpu_calls_run_the_plain_version():
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((2, 4, 8, 64), generator=gen).to(torch.bfloat16)
    g, b = torch.ones(64), torch.zeros(64)
    before = gn.group_norm_fused.launches, gn.group_norm_fused.two_pass_launches
    y = gn.group_norm_fused(x, g, b, groups=32, silu=True)
    ref = gn.group_norm_fused_plain(x.reshape(2, 32, 64), torch.zeros((2, 64), dtype=x.dtype),
                                    g, b, groups=32, eps=1e-5, silu=True).reshape(x.shape)
    assert torch.equal(y, ref)
    assert (gn.group_norm_fused.launches, gn.group_norm_fused.two_pass_launches) == before
