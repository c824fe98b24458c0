"""The whole SwiGLU decode layer in one launch (kernel B12) and its plain
version.

Counterpart of ``vocalie_tts_tpu/ops/decode_layer.py::
layer_swiglu_qkv_int8_stacked`` (``VOCALIE_MEGALAYER=1``). Its packed and
split bodies compute the same numbers; the port keeps k and v split
(``[L, b, kv, T, d]`` int8, bf16 scales ``[L, b, kv, T]``), as B1 does, and
has one kernel. For one layer ``l``:

- attention per (row, kv head) over the 128-slot T blocks below
  ``ceil(valid_len / 128)`` (at least one): B1's int8 math (q quantized per
  q row, ``s = i32 · (qs · sm_scale) · ks + bias`` with an online max and
  sum, ``p · vs`` quantized per block and q row, the current token's k/v
  merged in f32, divided by ``max(l, 1e-30)``);
- the o-projection per q-head chunk: each ``[b, d]`` slice of head
  ``h · g + j`` quantized per row on its own (floor 1e-8), its int32 product
  with Wo rows ``[(h · g + j) · d, +d)`` times that scale, the chunks summed
  in f32 in ascending head order, times ``wos``, plus the residual: ``x2``.
  B2 quantizes the whole ``[h · d]`` row with one scale, so B12 is not
  B1 + B2;
- B2's tail: RMSNorm(x2, ``mw[l]``), per-row int8, gate | up, ``silu(g) · u``
  quantized per (row, d_ff tile), the down-projection's parts summed in tile
  order, ``x_out = x2 + acc · sd``; then RMSNorm with ``nw[nxt]``, int8 and
  ``qkv_next`` from layer ``nxt = min(l + 1, L - 1)``.

The d_ff tile is the JAX kernel's, ``pick_tile(d_ff, 6 MiB, 2 · d_model)``
(``VOCALIE_TILE_MB`` read at each call, as for B2).

The plain version takes the kernel's steps: int8 products exact, IEEE
divides by a tensor 127, each attention block's probability sum and the
current token's score in float64 rounded to f32 once, the variance as B2's.

On a CUDA tensor the wrapper launches ``csrc/decode_layer.cu`` (one
cooperative launch, planned per shape by :func:`layer_plan`); on a CPU
tensor it runs the plain version.

The launch: B2's body (``csrc/tail_swiglu.cuh``, planned by
``decode_dense.tail_plan``) with the attention and the per-head
o-projection in front of it, one block an SM. The attention is B1's split
at one 128-slot block a rank: item ``i = j · b · kv + pair`` (block ``j`` of
a (row, kv head) pair) runs on block ``i % grid``, a team of warps ``(i //
grid) % slots`` (:func:`layer_attn_items`), each item's chain starting at the
prefix max of the pair's earlier blocks, and the pair's blocks merged in
order by its last item to finish. The o-projection takes a Wo tile of
``kc`` rows as ``kc / d_head`` whole heads, one warp a head, the heads'
f32 parts added in ascending order (:func:`layer_head_order`).
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from vocalie_tts_tpu_torch.ops import _build
from vocalie_tts_tpu_torch.ops.decode_attention import TBLK, decode_attention_plain, n_valid_blocks
from vocalie_tts_tpu_torch.ops.decode_dense import (
    SLAB,
    TAIL_KC_MAX,
    TailPlan,
    _check,
    _ff_tile,
    _int_dot,
    _kind,
    _quantize_rows,
    _rms_rows,
    _row_chunks,
    _sm_count,
    _swiglu_down,
    qkv_norm_int8_plain,
    tail_plan,
)

_ARGTYPES = ([_build.P] * 21 + [_build.I] * 13 + [_build.F] * 2
             + [_build.P, _build.LL, _build.P] + [_build.I] * 11 + [_build.P, _build.P])

#: the kernel's batch rows, q heads a kv head and head widths; the attention
#: items a block holds at once (its warps)
LAYER_MAX_B = 16
LAYER_MAX_G = 8
LAYER_D_HEADS = (32, 64, 128)
LAYER_MAX_SLOTS = 16
LAYER_MAX_TEAM = 4
#: mbarriers past the ring's: two an attention slot (its k rows, its v rows)
_N_ABAR = 2 * LAYER_MAX_SLOTS
_RED_ROW = SLAB + 1
#: the points at which a block's thread 0 writes the card's clock in the
#: attention (csrc ATT_STAMPS), after the tail's 12 and its 64 tile times
ATT_STAMP_POINTS = ("entry", "first item's bytes in", "its scores", "its prefix max known",
                    "its p8 . v", "first item done (merge too if last)", "attention done",
                    "ring filled", "every pair merged (o-projection blocks)",
                    "o-projection done", "o8 in", "first Wo tile in", "its heads' parts")
LAYER_STAMPS = 12 + 64 + len(ATT_STAMP_POINTS)


def _align16(n: int) -> int:
    return (n + 15) // 16 * 16


def slot_bytes(d: int, g: int) -> int:
    """An attention slot's shared bytes (``csrc/decode_layer.cu``
    ``slot_bytes``): a 128-slot block's k and v rows, its two bf16 scale rows
    and bias, the scores ``[g, 128]`` f32, per-q-row stats, q8, p8 and the
    team's warps' parts."""
    return 256 * d + 1024 + 512 * g + 256 + _align16(g * d) + 128 * g + 16 * LAYER_MAX_TEAM * 8


def layer_act_min(b: int, H: int, d: int, g: int) -> int:
    """The activation region's bytes at least (``layer_act_min``): the
    o-projection's o8 rows, the f32 parts of the heads of the largest tile
    and the ``[b, H]`` scales; and one attention slot."""
    op = _align16(b * (H * d + 16)) + (TAIL_KC_MAX // d) * 16 * _RED_ROW * 4 + b * H * 4
    return max(op, slot_bytes(d, g))


@dataclasses.dataclass(frozen=True)
class LayerPlan:
    """One B12 launch at one shape: ``tail`` B2's plan for the layer's four
    products (its items and tiles), run on ``grid`` blocks (the blocks past
    the tail plan's own hold no tail item but take attention items);
    ``slot_end`` the shared offset of the items' column scales, where the
    attention slots' room ends (past it the small inputs land while the
    attention runs); ``smem`` the launch's shared bytes
    (``vt_decode_layer_smem``'s)."""
    tail: TailPlan
    grid: int
    b: int
    kv: int
    g: int
    d: int
    T: int
    slot: int
    slot_end: int
    smem: int

    @property
    def heads(self) -> int:
        return self.kv * self.g

    @property
    def stage(self) -> int:
        return self.tail.kc * SLAB

    def items(self) -> tuple:
        """Each block's tail items (B2's plan, padded to ``grid`` blocks)."""
        return self.tail.items + ((),) * (self.grid - self.tail.grid)

    def table(self) -> list:
        """The item table the kernel reads: ``grid + 1`` offsets, then each
        block's items as ``product << 24 | slab``."""
        offsets, codes = [0], []
        for its in self.items():
            codes += [p << 24 | s for p, s in its]
            offsets.append(len(codes))
        return offsets + codes


def layer_attn_split(plan: LayerPlan, n_blk: int) -> int:
    """The attention slots a block holds at ``n_blk`` valid blocks, handed to
    the C entry with the call (which refuses a split its layout does not
    hold): one for each of its items in one wave
    (``ceil(b · kv · n_blk / grid)``, at most 16), as many as fit between
    the ring's first stage (the one tile a block asks for at launch) and the
    items' column scales; each slot is worked by a team of :func:`layer_attn_team`
    warps. Raises ``ValueError`` where none fits."""
    need = min(-(-plan.b * plan.kv * n_blk // plan.grid), LAYER_MAX_SLOTS)
    slots = min(need, (plan.slot_end - plan.stage) // plan.slot)
    if slots < 1:
        raise ValueError("B12: no attention slot fits beside the ring")
    return slots


def layer_attn_team(slots: int, d: int) -> int:
    """The warps an attention item takes, handed to the C entry with the
    call: doubled from one
    while the ``slots`` teams still fit a block's 16 warps, at most 4, and
    at most the 32-bit words of a v row (the warps share its columns in
    p8 · v; the scores, p and p8 are shared by rows)."""
    w = 1
    while w < LAYER_MAX_TEAM and 2 * w * slots <= 16 and 2 * w <= d // 4:
        w *= 2
    return w


def layer_attn_items(plan: LayerPlan, n_blk: int) -> dict:
    """Where each attention item runs: ``(pair, j) → (block, team, round)``
    for pair ``row · kv + kv_head`` and 128-slot block ``j < n_blk``; item
    ``i = j · b · kv + pair`` on block ``i % grid``, team ``(i // grid) %
    slots`` (of :func:`layer_attn_team` warps), in round ``i // (grid ·
    slots)`` (a team takes its items in ascending ``i``)."""
    slots = layer_attn_split(plan, n_blk)
    bc = plan.b * plan.kv
    return {(i % bc, i // bc): (i % plan.grid, (i // plan.grid) % slots,
                                i // (plan.grid * slots))
            for i in range(bc * n_blk)}


def layer_splits(plan: LayerPlan) -> tuple:
    """``(slots, team)`` at each count of valid blocks (index ``n_blk - 1``):
    what a call hands the C entry with ``plan.slot`` and ``plan.slot_end``."""
    return tuple((s, layer_attn_team(s, plan.d))
                 for s in (layer_attn_split(plan, n) for n in range(1, plan.T // TBLK + 1)))


def layer_head_order(plan: LayerPlan) -> list:
    """The q heads an o-projection item adds, in order: for each Wo tile of
    ``kc`` rows its ``kc / d_head`` heads, one warp each."""
    nh = plan.tail.kc // plan.d
    return [jt * nh + hh for jt in range(plan.heads * plan.d // plan.tail.kc)
            for hh in range(nh)]


def layer_plan(b: int, kv: int, g: int, d: int, T: int, D: int, F: int, tile: int, Q: int,
               sms: int) -> LayerPlan:
    """B12's launch plan, a pure function of the shape and the card's SM
    count: B2's ``tail_plan`` for the layer (d_attn = kv · g · d) with the
    activation region at least :func:`layer_act_min` and an mbarrier a slot,
    on ``sms`` blocks. Raises ``ValueError`` for a shape the kernel has no
    plan for (``b`` past 16, ``g`` past 8, ``d`` not 32, 64 or 128, a Wo
    tile that does not hold whole heads, what ``tail_plan`` refuses)."""
    if not (1 <= b <= LAYER_MAX_B and 1 <= g <= LAYER_MAX_G and d in LAYER_D_HEADS):
        raise ValueError(f"B12 takes 1 <= b <= {LAYER_MAX_B}, 1 <= g <= {LAYER_MAX_G} and "
                         f"d_head in {LAYER_D_HEADS}; got b={b} g={g} d={d}")
    if T < TBLK or T % TBLK or Q < SLAB:
        raise ValueError(f"B12 takes a cache of 128-slot blocks and a next qkv; got T={T} Q={Q}")
    H = kv * g
    try:
        tail = tail_plan(b, H * d, D, F, tile, Q, sms, act_min=layer_act_min(b, H, d, g),
                         n_abar=_N_ABAR)
    except ValueError as e:
        raise ValueError(f"B12 at b={b} kv={kv} g={g} d={d} D={D} F={F} Q={Q}: {e}") from None
    if tail.kc < d:
        raise ValueError(f"B12: a Wo tile of {tail.kc} rows holds no whole head of {d}")
    if H * d > tail.stages * tail.kc:
        raise ValueError(f"B12: an o-projection item's {H * d} Wo rows pass the ring's "
                         f"{tail.stages} stages of {tail.kc}")
    # the layout's offsets up to the items' column scales (``layout`` in
    # csrc/tail_swiglu.cuh; the C entry refuses a slot_end that is not its
    # layout's): the ring, the activations, the int32 sums, the hidden, the
    # down sum, the row scales
    lda = max(H * d, D, F) + 16
    slot_end = (tail.stages * tail.kc * SLAB + _align16(max(b * lda, layer_act_min(b, H, d, g)))
                + _align16(2 * 16 * _RED_ROW * 4) + _align16(tail.max_gu * b * SLAB * 4)
                + _align16(b * SLAB * 4) + _align16(4 * b * max(1, F // tile)))
    plan = LayerPlan(tail=tail, grid=sms, b=b, kv=kv, g=g, d=d, T=T, slot=slot_bytes(d, g),
                     slot_end=slot_end, smem=tail.smem)
    layer_attn_split(plan, 1)   # at least one slot
    return plan


@functools.lru_cache(maxsize=None)
def _layer_launch(b: int, kv: int, g: int, d: int, T: int, D: int, F: int, tile: int, Q: int,
                  dev: int, grid: int):
    """The plan of a shape on card ``dev`` (``grid`` blocks, 0: one an SM),
    the attention's ``(slots, team)`` at each count of valid blocks
    (index ``n_blk - 1``), its item table on the card and the workspace,
    zeroed once (the kernel leaves its flags and counters at zero): a decode
    step calls B12 once a layer and is bound by host time, so a call reads
    them from here and runs no Python over blocks or items. Calls at one
    shape share the workspace: one stream at a time."""
    plan = layer_plan(b, kv, g, d, T, D, F, tile, Q, grid or _sm_count(dev))
    splits = layer_splits(plan)
    cuda = torch.device("cuda", dev)
    table = torch.tensor(plan.table(), dtype=torch.int32, device=cuda)
    n = _build.kernel("vt_decode_layer_workspace", [_build.I] * 8, restype=_build.LL)(
        b, kv, g, d, T, D, F, tile)
    if n < 0:
        raise ValueError("B12: shapes the workspace does not take")
    ws = torch.zeros((int(n),), dtype=torch.uint8, device=cuda)
    return plan, splits, table, ws


def layer_swiglu_qkv_int8_plain(q, x, k_all, v_all, k_scale, v_scale, bias2d, k_new, v_new,
                                layer: int, valid_len: int, wo_all, wos_all, mw_all, wgu_all,
                                sgu_all, wd_all, sd_all, nw_all, wq_all, sq_all, *,
                                sm_scale: float, eps: float, tile: int | None = None):
    """The kernel's arithmetic in PyTorch ops (see module doc). ``tile``:
    the d_ff block the hidden is quantized over (default: the JAX
    kernel's)."""
    b, kv, g, d = q.shape
    H = kv * g
    tile = tile or _ff_tile(x.shape[1], wd_all.shape[1], wq_all.shape[2])
    o = decode_attention_plain(q, k_all, v_all, bias2d, layer, k_scale, v_scale, k_new, v_new,
                               valid_len, sm_scale, sum_dtype=torch.float64).reshape(b, H, d)
    wo = wo_all[layer]
    y = None
    for c in range(H):      # ascending q heads: the f32 sum's order
        oq, os_ = _quantize_rows(o[:, c])
        part = _int_dot(oq, wo[c * d:(c + 1) * d]) * os_
        y = part if y is None else y + part
    x2 = x.float() + y * wos_all[layer]
    h, hs = _quantize_rows(_rms_rows(x2, mw_all[layer], eps))
    x_out = x2 + _swiglu_down(h, hs, wgu_all[layer], sgu_all[layer], wd_all[layer], tile) \
        * sd_all[layer]
    nxt = min(int(layer) + 1, wq_all.shape[0] - 1)
    return x_out, qkv_norm_int8_plain(x_out, nw_all, wq_all, sq_all, nxt, eps=eps)


def layer_swiglu_qkv_int8_stacked(
    q: torch.Tensor,          # [b, kv, g, d] f32 (post-RoPE)
    x: torch.Tensor,          # [b, d_model] f32 residual INTO the layer
    k_all: torch.Tensor,      # [L, b, kv, T, d] int8
    v_all: torch.Tensor,      # [L, b, kv, T, d] int8
    k_scale: torch.Tensor,    # [L, b, kv, T] bf16
    v_scale: torch.Tensor,
    bias2d: torch.Tensor,     # [b, T] f32 additive mask
    k_new: torch.Tensor,      # [b, kv, d] f32 — the current token's k
    v_new: torch.Tensor,
    layer: int,
    valid_len: int,           # cached slots in use (blocks past it are skipped)
    wo_all: torch.Tensor,     # [L, h·d, d_model] int8
    wos_all: torch.Tensor,    # [L, 1, d_model] f32
    mw_all: torch.Tensor,     # [L, d_model] mlp-norm weights
    wgu_all: torch.Tensor,    # [L, d_model, 2·d_ff] int8 ([gate | up])
    sgu_all: torch.Tensor,    # [L, 1, 2·d_ff] f32
    wd_all: torch.Tensor,     # [L, d_ff, d_model] int8
    sd_all: torch.Tensor,     # [L, 1, d_model] f32
    nw_all: torch.Tensor,     # [L, d_model] attn-norm weights (the next layer's)
    wq_all: torch.Tensor,     # [L, d_model, d_qkv] int8 fused qkv
    sq_all: torch.Tensor,     # [L, 1, d_qkv] f32
    *,
    sm_scale: float,
    eps: float,
    grid: int = 0,
    stamps: torch.Tensor | None = None,
):
    """The whole decode layer →
    ``(x_out [b, d_model] f32, qkv_next [b, d_qkv] f32)``.

    On a card, more rows than one launch takes (:func:`layer_rows`: 16 at
    the T3 and Qwen3 layers) run as one launch over each of
    ``_row_chunks`` (near-equal; each counted in ``.launches``), bit for bit
    the one call's result; a shape no launch takes at one row raises
    ``ValueError`` naming it. JAX takes B12 at any batch (``use_megalayer``,
    ``vocalie_tts_tpu/models/common/transformer.py:833-841``).

    CUDA only: ``grid`` forces the number of cooperative blocks instead of
    one per SM (a grid larger than the card keeps resident is refused);
    ``stamps`` is
    None or an int64 tensor of ``grid · LAYER_STAMPS`` the kernel fills with
    its blocks' phase times (``tools/decode_layer_trace.py``; one launch
    only)."""
    b, kv, g, d = q.shape
    L, _, _, T, _ = k_all.shape
    D = x.shape[1]
    F = wd_all.shape[1]
    Q = wq_all.shape[2]
    if T % TBLK:
        raise ValueError(f"cache length {T} must be a multiple of {TBLK}")
    if wgu_all.shape[2] != 2 * F:
        raise ValueError("wgu_all must be the fused [gate | up] concat")
    tile = _ff_tile(D, F, Q)
    if q.device.type == "cpu":
        return layer_swiglu_qkv_int8_plain(
            q, x, k_all, v_all, k_scale, v_scale, bias2d, k_new, v_new, layer, valid_len,
            wo_all, wos_all, mw_all, wgu_all, sgu_all, wd_all, sd_all, nw_all, wq_all, sq_all,
            sm_scale=sm_scale, eps=eps, tile=tile)
    if not (b >= 1 and 1 <= g <= LAYER_MAX_G and d % 32 == 0 and 32 <= d <= 128
            and D % 128 == 0 and Q % 128 == 0):
        raise ValueError(f"the kernel takes 1 <= g <= 8, d_head 32..128 step 32 and d_model, "
                         f"d_qkv multiples of 128; got b={b} g={g} d={d} D={D} Q={Q}")
    H = kv * g
    f32, i8, bf16 = (torch.float32,), (torch.int8,), (torch.bfloat16,)
    norm = (mw_all.dtype,)
    _check(q.device, layer, L,
           ("q", q, f32, (b, kv, g, d)), ("x", x, f32, (b, D)),
           ("k_all", k_all, i8, (L, b, kv, T, d)), ("v_all", v_all, i8, (L, b, kv, T, d)),
           ("k_scale", k_scale, bf16, (L, b, kv, T)), ("v_scale", v_scale, bf16, (L, b, kv, T)),
           ("bias2d", bias2d, f32, (b, T)),
           ("k_new", k_new, f32, (b, kv, d)), ("v_new", v_new, f32, (b, kv, d)),
           ("wo_all", wo_all, i8, (L, H * d, D)), ("wos_all", wos_all, f32, (L, 1, D)),
           ("mw_all", mw_all, (torch.float32, torch.bfloat16), (L, D)),
           ("wgu_all", wgu_all, i8, (L, D, 2 * F)), ("sgu_all", sgu_all, f32, (L, 1, 2 * F)),
           ("wd_all", wd_all, i8, (L, F, D)), ("sd_all", sd_all, f32, (L, 1, D)),
           ("nw_all", nw_all, norm, (L, D)),
           ("wq_all", wq_all, i8, (L, D, Q)), ("sq_all", sq_all, f32, (L, 1, Q)))
    dev = q.device.index if q.device.index is not None else torch.cuda.current_device()
    rows = layer_rows(kv, g, d, T, D, F, tile, Q, int(grid) or _sm_count(dev))
    if rows is None:
        raise ValueError(f"B12: no launch takes kv={kv} g={g} d_head={d} T={T} d_model={D} "
                         f"d_ff={F} d_qkv={Q} ({b} rows), not even one row")
    chunks = [(0, b)] if b <= rows else _row_chunks(b, rows)
    if stamps is not None and len(chunks) > 1:
        raise ValueError(f"stamps trace one launch: {b} rows take {len(chunks)}")
    n_blk = n_valid_blocks(valid_len, T)
    x_out = torch.empty((b, D), dtype=torch.float32, device=q.device)
    qkv = torch.empty((b, Q), dtype=torch.float32, device=q.device)
    fn = _build.kernel("vt_decode_layer", _ARGTYPES)
    for r0, r1 in chunks:
        # row slices of the [b, ...] inputs and outputs are contiguous and
        # 16-byte aligned (every width is a multiple of 4 f32); the cache by
        # layer_cache_offset
        bc = r1 - r0
        plan, splits, table, ws = _layer_launch(bc, kv, g, d, T, D, F, tile, Q, dev, int(grid))
        slots, team = splits[n_blk - 1]
        if stamps is not None and (stamps.dtype != torch.int64 or stamps.device != q.device
                                   or stamps.numel() < plan.grid * LAYER_STAMPS):
            raise ValueError(f"stamps: int64 on {q.device}, {plan.grid * LAYER_STAMPS} or more")
        off = layer_cache_offset(int(layer), b, r0, r1) * kv * T
        layer_swiglu_qkv_int8_stacked.launches += 1
        tp = plan.tail
        rc = fn(q[r0:r1].data_ptr(), x[r0:r1].data_ptr(), k_all.data_ptr() + off * d,
                v_all.data_ptr() + off * d, k_scale.data_ptr() + 2 * off,
                v_scale.data_ptr() + 2 * off, bias2d[r0:r1].data_ptr(),
                k_new[r0:r1].data_ptr(), v_new[r0:r1].data_ptr(),
                wo_all.data_ptr(), wos_all.data_ptr(), mw_all.data_ptr(),
                wgu_all.data_ptr(), sgu_all.data_ptr(), wd_all.data_ptr(), sd_all.data_ptr(),
                nw_all.data_ptr(), wq_all.data_ptr(), sq_all.data_ptr(),
                x_out[r0:r1].data_ptr(), qkv[r0:r1].data_ptr(),
                _kind(mw_all, "mw_all"), L, int(layer), bc, kv, g, d, T,
                n_blk, D, F, tile, Q, float(sm_scale), float(eps),
                ws.data_ptr(), ws.numel(), table.data_ptr(), plan.grid, tp.kc, tp.stages,
                tp.max_gu, tp.max_items, tp.gu_blocks, plan.smem, slots, team, plan.slot,
                plan.slot_end, None if stamps is None else stamps.data_ptr(),
                _build.stream_ptr(q))
        _build.check(rc, "vt_decode_layer")
    return x_out, qkv


def _layer_fits(b: int, kv: int, g: int, d: int, T: int, D: int, F: int, tile: int, Q: int,
                sms: int) -> bool:
    try:
        layer_plan(b, kv, g, d, T, D, F, tile, Q, sms)
    except ValueError:
        return False
    return True


@functools.lru_cache(maxsize=None)
def layer_rows(kv: int, g: int, d: int, T: int, D: int, F: int, tile: int, Q: int, sms: int):
    """The most rows (at most ``LAYER_MAX_B``) that one B12 launch takes at
    these widths on a card of ``sms`` SMs, or None where none does (what
    :func:`layer_plan` refuses at one row: ``g`` past 8, a head width it has
    no body for, a normed row past 2048, ...). Every quantity B12 computes is
    per row (the attention per (row, kv head) over that row's own cache, the
    activations quantized per row, the weights shared), so a batch of more
    rows runs as launches over row chunks of at most this many, bit for bit
    the one call's result (``decode_dense._row_chunks``)."""
    for b in range(LAYER_MAX_B, 0, -1):
        if _layer_fits(b, kv, g, d, T, D, F, tile, Q, sms):
            return b
    return None


def layer_cache_offset(layer: int, b: int, r0: int, r1: int) -> int:
    """The batch rows (each ``kv · T · d`` int8 bytes, ``kv · T`` bf16
    scales) by which a launch over rows ``[r0, r1)`` of a ``b``-row step
    moves its cache pointers. The kernel reads its pair ``pc`` at row
    ``layer · bc · kv + pc`` (``bc = r1 - r0``) of the ``[L, bc, kv, T, d]``
    cache it is handed; the rows wanted are those of the layer slice
    ``k_all[layer, r0:r1]`` (contiguous, unlike the batch slice
    ``k_all[:, r0:r1]``, which is strided across layers): rows ``(layer · b
    + r0) · kv + pc`` of the whole cache. So the pointer moves by ``layer ·
    (b - bc) + r0`` batch rows (>= 0: it stays inside the cache) and the
    layer index goes in unchanged, as the weights need it."""
    return layer * (b - (r1 - r0)) + r0


def max_resident_blocks(b: int, kv: int, g: int, d: int, T: int, D: int, F: int, Q: int) -> int:
    """SMs × the blocks of the kernel one SM keeps resident at this shape's
    plan: the largest grid a cooperative launch accepts."""
    dev = torch.cuda.current_device()
    plan = layer_plan(b, kv, g, d, T, D, F, _ff_tile(D, F, Q), Q, _sm_count(dev))
    n = int(_build.kernel("vt_decode_layer_max_blocks", [_build.I])(plan.smem))
    if n < 0:
        raise RuntimeError(f"vt_decode_layer_max_blocks: cudaError {-n}")
    return n


#: launches of the CUDA kernel (the plain version is not counted)
layer_swiglu_qkv_int8_stacked.launches = 0

__all__ = ["layer_swiglu_qkv_int8_stacked", "layer_swiglu_qkv_int8_plain", "max_resident_blocks",
           "layer_plan", "layer_attn_split", "layer_attn_team", "layer_attn_items", "layer_splits",
           "layer_head_order", "layer_rows", "layer_cache_offset", "LayerPlan",
           "ATT_STAMP_POINTS", "LAYER_STAMPS"]
