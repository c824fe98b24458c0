"""The whole decode step at batch 1, every layer in one launch (kernel B7),
and its plain version.

Counterpart of ``vocalie_tts_tpu/ops/decode_step.py::
decode_step_fused_packed``. For each layer ``l``, on the residual carried
in f32 across all layers (no cast between layers):

- attention over the whole int8 cache of each head: q quantized per
  head, ``s = (i32 · (qs · sm_scale)) · ks + bias`` over every slot (the
  additive bias masks; there is no valid-length clamp), the current
  token's column merged in f32, the probabilities times the v scales
  quantized ONCE per head over all T (not per 128-slot block as in B1),
  ``o = (o_v + p_new · v_new) / max(l_sum, 1e-30)``;
- the o-projection with one scale per head: each head's o quantized on
  its own, the per-head products summed over heads (ascending), then
  times the column scale, plus the residual;
- RMSNorm, per-row int8, gate and up, ``silu(g) · u`` quantized with ONE
  scale over all of d_ff, down, plus the residual;
- the next layer's RMSNorm, per-row int8 and qkv from layer
  ``min(l + 1, L - 1)``, times the scales, plus ``bqkv``, RoPE in f32 on
  the q and k heads: q goes on to the next layer, k and v are written to
  output row ``l`` (so row ``l`` holds layer ``l + 1``'s k/v; the caller
  drops row ``L - 1``).

The port keeps its split cache (``[L, 1, H, T, d]`` int8 k and v, bf16
scales) and the fused ``wqkv`` ``[L, d_model, 3·H·d]`` with ``bqkv``; the
TPU's head-stacked weight copy, its selector matmuls and its permutation
dot for RoPE are not carried over.

The plain version repeats the kernel's arithmetic in the kernel's order:
int8 products summed exactly (float64), the variance, the softmax sum and
the current token's score summed in float64 and rounded to f32 once (so
any summation order gives the same f32), IEEE divides by a tensor 127,
and the head sum in a fixed ascending loop.

On a CUDA tensor the wrapper launches ``csrc/decode_step.cu`` (one
cooperative launch: the cache of each head split over several blocks, the
weights streamed by TMA into a ring that runs ahead across the layers, the
phases joined by counters; planned per shape by :func:`step_plan`); on a
CPU tensor it runs the plain version.
"""

from __future__ import annotations

import dataclasses
import functools
import heapq
from typing import Optional

import torch

from vocalie_tts_tpu_torch.ops import _build
from vocalie_tts_tpu_torch.ops.decode_dense import (
    SLAB,
    SMEM_MAX,
    _int_dot,
    _kind,
    _quantize_rows,
    _rms_rows,
    _sm_count,
)

_ARGTYPES = ([_build.P] * 25 + [_build.I] * 9 + [_build.F] * 2
             + [_build.P, _build.LL, _build.P] + [_build.I] * 6 + [_build.P, _build.I, _build.P])


def _rope(y: torch.Tensor, cos_f: torch.Tensor, sin_f: torch.Tensor) -> torch.Tensor:
    """``y · cos‖cos + swap(y) · (−sin‖sin)`` over the last dim (two
    products and an add, no fused multiply-add)."""
    h = y.shape[-1] // 2
    swap = torch.cat([y[..., h:], y[..., :h]], dim=-1)
    return y * cos_f + swap * sin_f


def decode_step_fused_plain(q0, kn0, vn0, x, k_all, v_all, k_scale, v_scale, bias2d,
                            wo_all, wos_all, mw_all, wgu_all, sgu_all, wd_all, sd_all,
                            nw_all, wq_all, sq_all, bqkv_all, cos_f, sin_f, *,
                            sm_scale: float, eps: float):
    """The kernel's arithmetic in PyTorch ops (see module doc)."""
    L, _, H, T, d = k_all.shape
    F = wd_all.shape[1]
    q = q0.reshape(H, d).float()
    kn, vn = kn0.float(), vn0.float()
    xres = x.float().reshape(1, -1)
    bias = bias2d.float().reshape(1, T)
    cos_f, sin_f = cos_f.float().reshape(1, d), sin_f.float().reshape(1, d)
    kn_rows, vn_rows = [], []
    for l in range(L):
        # attention, one whole-cache block per head
        qq, qs = _quantize_rows(q)
        s = torch.matmul(k_all[l, 0].double(), qq.double()[:, :, None])[..., 0].float()
        s = s * (qs * sm_scale)
        s = s * k_scale[l, 0].float() + bias
        s_new = (q.double() * kn.double()).sum(-1, keepdim=True).float() * sm_scale
        m = torch.maximum(s.amax(-1, keepdim=True), s_new)
        p = torch.exp(s - m)
        p_new = torch.exp(s_new - m)
        l_sum = p.double().sum(-1, keepdim=True).float() + p_new
        p8, ps = _quantize_rows(p * v_scale[l, 0].float(), floor=1e-20)   # p >= 0
        o_i = torch.matmul(p8.double()[:, None, :], v_all[l, 0].double())[:, 0].float()
        o = (o_i * ps + p_new * vn) / torch.clamp(l_sum, min=1e-30)
        # o-projection, one scale per head, heads summed in ascending order
        oq, os_ = _quantize_rows(o)
        wo = wo_all[l].reshape(H, d, -1)
        y = None
        for h in range(H):
            yh = _int_dot(oq[h:h + 1], wo[h]) * os_[h]
            y = yh if y is None else y + yh
        x2 = xres + y * wos_all[l]
        # whole-d_ff SwiGLU, one hidden scale per row
        hq, hs = _quantize_rows(_rms_rows(x2, mw_all[l], eps))
        gu = _int_dot(hq, wgu_all[l])
        g = gu[:, :F] * hs * sgu_all[l][:, :F]
        u = gu[:, F:] * hs * sgu_all[l][:, F:]
        mq, ms = _quantize_rows(g * torch.sigmoid(g) * u)
        x_out = x2 + _int_dot(mq, wd_all[l]) * ms * sd_all[l]
        xres = x_out
        # the next layer's norm, qkv (+ bias) and RoPE
        nxt = min(l + 1, L - 1)
        nq, ns = _quantize_rows(_rms_rows(x_out, nw_all[nxt], eps))
        yq = _int_dot(nq, wq_all[nxt]) * ns * sq_all[nxt]
        if bqkv_all is not None:
            yq = yq + bqkv_all[nxt].float()
        y3 = yq.reshape(3 * H, d)
        qk = _rope(y3[: 2 * H], cos_f, sin_f)
        q, kn, vn = qk[:H], qk[H:], y3[2 * H:]
        kn_rows.append(kn)
        vn_rows.append(vn)
    return xres, torch.stack(kn_rows), torch.stack(vn_rows)


#: the phase points of the ``stamps`` trace (``%globaltimer`` ns, thread 0
#: of every block, at the traced layer), ``N_STAMPS`` words a block; a block
#: with no item in a phase writes nothing there
STAMP_POINTS = ("layer start", "q ready", "meeting 1", "meeting 2", "attention end",
                "heads ready", "o-proj end", "x2 ready", "mlp norm", "gate|up end",
                "hidden ready", "down end", "x_out ready", "qkv norm", "qkv end", "layer end",
                "att: q quantized", "att: cache tile ready", "att: scores", "att: p8 . v",
                "o-proj: o of every head", "o-proj: inputs loaded", "o-proj: tile ready",
                "o-proj: products", "gate|up: first tile ready", "gate|up: item products",
                "down: hidden quantized", "down: first tile ready", "down: last tile ready",
                "down: products", "qkv: first tile ready", "qkv: item products",
                "down: first tile's products", "down: first tile released")
N_STAMPS = 34
#: then, per block, the clock at the request and at the arrival of 64 of its
#: ring's tiles, from the first of the layer before the traced one
N_TILE_STAMPS = 64

#: the kinds of B7's items, in a block's stream order: an attention split
#: (a head's n slots), an o-projection slab, a gate | up slab pair, a down
#: slab, a qkv item (one head's d columns of q, k or v)
ATT, OPROJ, GU, DOWN, QKV = range(5)
STEP_KC_MAX = 1024
STEP_MAX_STAGES = 16
STEP_MAX_H = 64
STEP_MAX_S = 64
#: shared bytes of an item's column scales and biases, and a block's fixed
#: scratch for one head's rows (``layout`` in ``csrc/decode_step.cu``)
_VEC_ITEM = 1024
_MAX_DH = 128


@dataclasses.dataclass(frozen=True)
class StepPlan:
    """One B7 launch at one shape: ``grid`` blocks, each owning
    ``items[blk]`` ((kind, index) pairs, the same in every layer, in stream
    order), ``tiles[blk]`` ring tiles of one layer; a head's cache split over
    ``S`` blocks of ``n`` slots; tiles of ``kc`` weight rows (32 columns), a
    ring of ``stages`` of them, ``max_items`` items a block at most,
    ``smem`` the launch's shared bytes (``vt_decode_step_smem``'s) and
    ``ring_holds_layer`` whether the ring holds every tile of a block's
    layer (the next layer's are then in flight before the current one
    ends)."""
    grid: int
    S: int
    n: int
    kc: int
    stages: int
    max_items: int
    smem: int
    items: tuple
    tiles: tuple
    ring_holds_layer: bool

    def table(self) -> list:
        """The item table the kernel reads: ``grid + 1`` offsets, then each
        block's items as ``kind << 24 | index``."""
        offsets, codes = [0], []
        for its in self.items:
            codes += [k << 24 | i for k, i in its]
            offsets.append(len(codes))
        return offsets + codes


def _align16(n: int) -> int:
    return (n + 15) // 16 * 16


def step_item_tiles(kind: int, H: int, d: int, D: int, F: int, kc: int) -> int:
    """The ring tiles of one item of ``kind`` in one layer."""
    return (1, H * d // kc, 2 * (D // kc), F // kc, (d // SLAB) * (D // kc))[kind]


def step_item_bytes(kind: int, H: int, d: int, D: int, F: int, n: int) -> int:
    """The bytes one item of ``kind`` streams in one layer: a split's k, v
    and their bf16 scales, or its weight slabs."""
    return (n * (2 * d + 4), H * d * SLAB, 2 * D * SLAB, F * SLAB, d * D)[kind]


def step_smem_fixed(H: int, d: int, D: int, F: int, n: int, max_items: int) -> int:
    """B7's shared bytes beside the ring (``layout`` in ``csrc/decode_step.cu``)."""
    widest = max(D, F, H * d)
    return (_align16(widest + 16) + _align16(max(H, 2) * SLAB * 4) + max_items * _VEC_ITEM
            + 2 * _align16(4 * D) + max_items * SLAB * 4 + 2 * _align16(4 * n) + _align16(n)
            + 4 * _MAX_DH * 4 + _MAX_DH + _MAX_DH * 4 + STEP_MAX_H * 4 + _align16(4 * H * d)
            + 3 * STEP_MAX_S * 4 + 64 + 32 * 12 + 16 * STEP_MAX_STAGES)


def step_plan(L: int, H: int, d: int, D: int, F: int, T: int, grid: int,
              smem_max: int = SMEM_MAX) -> StepPlan:
    """B7's launch plan, a pure function of the shape and the grid. A tile
    is ``kc`` rows: the largest power of two up to 1024 dividing ``H * d``,
    ``D`` and ``F``; an attention split takes the most slots (a divisor of
    ``T``, a multiple of 8) whose k, v and scales fit one tile's bytes, so
    a head is split over ``S = T / n`` blocks. The items of one layer are
    dealt largest first (by bytes) to the least loaded block that has no
    item of the same kind while there is one (each attention split always:
    H · S <= grid), so that no phase waits on a block doing two of its
    items; a block streams its items in kind order,
    layer after layer, through as many stages as shared memory leaves (at
    most 16). Raises ``ValueError`` for a shape the body does not take."""
    if not 1 <= H <= STEP_MAX_H or d % SLAB or not SLAB <= d <= _MAX_DH:
        raise ValueError(f"B7 takes 1 to {STEP_MAX_H} heads of 32 to {_MAX_DH} (a multiple of "
                         f"32), got H={H} d={d}")
    if D < SLAB or D % SLAB or F < SLAB or F % SLAB or T < 128 or T % 128 or L < 1:
        raise ValueError(f"B7 takes d_model and d_ff multiples of {SLAB} and a cache a "
                         f"multiple of 128, got D={D} F={F} T={T} L={L}")
    kc = STEP_KC_MAX
    while (H * d) % kc or D % kc or F % kc:
        kc //= 2
    n = max((c for c in range(8, T + 1, 8) if T % c == 0 and c * (2 * d + 4) <= kc * SLAB),
            default=0)
    if n == 0:
        raise ValueError(f"B7: no split of the cache fits a {kc * SLAB}-byte tile at d={d}")
    S = T // n
    if S > STEP_MAX_S:
        raise ValueError(f"B7 splits a head's cache over at most {STEP_MAX_S} blocks, got {S} "
                         f"(T={T}, {n} slots a {kc * SLAB}-byte tile)")
    if H * S > grid:
        raise ValueError(f"B7 splits each of {H} heads over {S} blocks: {H * S} blocks, the "
                         f"grid has {grid}")
    counts = (H * S, D // SLAB, F // SLAB, D // SLAB, 3 * H)
    work = sorted(((step_item_bytes(k, H, d, D, F, n), k, i)
                   for k in range(5) for i in range(counts[k])),
                  key=lambda w: (-w[0], w[1], w[2]))
    heap = [(0, blk) for blk in range(grid)]
    owned = [[] for _ in range(grid)]
    for nbytes, k, i in work:
        # a phase's items run side by side on their blocks, so two on one
        # block double the phase: the least loaded block without one of its
        # kind takes it while there is one (an attention split always)
        passed = []
        load, blk = heapq.heappop(heap)
        while heap and any(q == k for q, _ in owned[blk]):
            passed.append((load, blk))
            load, blk = heapq.heappop(heap)
        if any(q == k for q, _ in owned[blk]) and passed:
            passed.append((load, blk))
            load, blk = passed.pop(0)
        for entry in passed:
            heapq.heappush(heap, entry)
        owned[blk].append((k, i))
        heapq.heappush(heap, (load + nbytes, blk))
    items = tuple(tuple(sorted(its)) for its in owned)
    max_items = max(1, max(len(its) for its in items))
    fixed = step_smem_fixed(H, d, D, F, n, max_items)
    fit = (smem_max - fixed) // (kc * SLAB)
    if fit < 2:
        raise ValueError(f"B7: shared memory leaves no room for a two-stage ring of "
                         f"{kc * SLAB}-byte tiles")
    tiles = tuple(sum(step_item_tiles(k, H, d, D, F, kc) for k, _ in its) for its in items)
    stages = max(2, min(STEP_MAX_STAGES, fit, L * max(tiles)))
    return StepPlan(grid=grid, S=S, n=n, kc=kc, stages=stages, max_items=max_items,
                    smem=fixed + stages * kc * SLAB, items=items, tiles=tiles,
                    ring_holds_layer=stages >= max(tiles))


@functools.lru_cache(maxsize=None)
def _ws_bytes(L: int, H: int, d: int, D: int, F: int, S: int) -> int:
    return _build.kernel("vt_decode_step_workspace", [_build.I] * 6, restype=_build.LL)(
        L, H, d, D, F, S)


@functools.lru_cache(maxsize=None)
def _launch(L: int, H: int, d: int, D: int, F: int, T: int, grid: int, dev: int):
    """The plan of a shape on card ``dev``, its item table on the card
    (uploaded once) and the workspace bytes: a call reads them from here."""
    plan = step_plan(L, H, d, D, F, T, grid)
    table = torch.tensor(plan.table(), dtype=torch.int32, device=torch.device("cuda", dev))
    return plan, table, _ws_bytes(L, H, d, D, F, plan.S)


def decode_step_fused_packed(
    q0: torch.Tensor,         # [H, 1, d] f32 — layer-0 post-RoPE q
    kn0: torch.Tensor,        # [H, d] f32 — layer-0 current-token k
    vn0: torch.Tensor,        # [H, d] f32
    x: torch.Tensor,          # [1, d_model] f32 residual INTO layer 0
    k_all: torch.Tensor,      # [L, 1, H, T, d] int8
    v_all: torch.Tensor,      # [L, 1, H, T, d] int8
    k_scale: torch.Tensor,    # [L, 1, H, T] bf16
    v_scale: torch.Tensor,
    bias2d: torch.Tensor,     # [1, T] f32 additive mask
    wo_all: torch.Tensor,     # [L, H·d, d_model] int8
    wos_all: torch.Tensor,    # [L, 1, d_model] f32
    mw_all: torch.Tensor,     # [L, d_model] mlp-norm weights
    wgu_all: torch.Tensor,    # [L, d_model, 2·d_ff] int8 ([gate | up])
    sgu_all: torch.Tensor,    # [L, 1, 2·d_ff] f32
    wd_all: torch.Tensor,     # [L, d_ff, d_model] int8
    sd_all: torch.Tensor,     # [L, 1, d_model] f32
    nw_all: torch.Tensor,     # [L, d_model] attn-norm weights (the next layer's)
    wq_all: torch.Tensor,     # [L, d_model, 3·H·d] int8 fused qkv
    sq_all: torch.Tensor,     # [L, 1, 3·H·d] f32
    bqkv_all: Optional[torch.Tensor],  # [L, 3·H·d] q/k/v bias, or None
    cos_f: torch.Tensor,      # [1, d] f32 — cos tiled to both halves
    sin_f: torch.Tensor,      # [1, d] f32 — [−sin | +sin]
    *,
    sm_scale: float,
    eps: float,
    grid: int = 0,
    stamps: Optional[torch.Tensor] = None,
    trace_layer: int = 0,
):
    """The whole decode step (all layers) →
    ``(x_out [1, d_model] f32, kn_nxt [L, H, d] f32, vn_nxt [L, H, d] f32)``;
    ``kn_nxt[l]`` is layer ``l + 1``'s current-token k (see module doc).

    ``grid`` (CUDA only) forces the number of cooperative blocks instead of
    one per SM; a grid larger than the card keeps resident is refused.
    ``stamps``: None, or an int64 CUDA tensor of ``grid * (N_STAMPS + 2 *
    N_TILE_STAMPS)`` the kernel fills with its blocks' times at
    ``STAMP_POINTS`` in layer ``trace_layer`` and their tiles' request and
    arrival times (``python3 -m vocalie_tts_tpu_torch.tools.decode_step_trace``)."""
    H, g, d = q0.shape
    if g != 1:
        raise ValueError("the whole-step kernel takes one query per head (MHA, batch 1)")
    L, b, kv, T, _ = k_all.shape
    if b != 1 or kv != H:
        raise ValueError(f"the whole-step kernel takes batch 1 and kv heads == heads, got "
                         f"b={b} kv={kv} H={H}")
    D = x.shape[1]
    F = wd_all.shape[1]
    Q = wq_all.shape[2]
    if Q != 3 * H * d or wgu_all.shape[2] != 2 * F:
        raise ValueError("wq_all must be the fused q|k|v and wgu_all the fused gate|up")
    if q0.device.type == "cpu":
        return decode_step_fused_plain(q0, kn0, vn0, x, k_all, v_all, k_scale, v_scale, bias2d,
                                       wo_all, wos_all, mw_all, wgu_all, sgu_all, wd_all, sd_all,
                                       nw_all, wq_all, sq_all, bqkv_all, cos_f, sin_f,
                                       sm_scale=sm_scale, eps=eps)
    dev = q0.device
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if d % 32 or d > 128 or D % 32 or F % 32 or T % 128:
        raise ValueError(f"the kernel takes d_head a multiple of 32 up to 128, d_model and d_ff "
                         f"multiples of 32 and T a multiple of 128; got d={d} D={D} F={F} T={T}")
    f32, i8, bf16 = (torch.float32,), (torch.int8,), (torch.bfloat16,)
    norm = (nw_all.dtype,) if nw_all.dtype in (torch.float32, torch.bfloat16) else f32
    specs = [
        ("q0", q0, f32, (H, 1, d)), ("kn0", kn0, f32, (H, d)), ("vn0", vn0, f32, (H, d)),
        ("x", x, f32, (1, D)),
        ("k_all", k_all, i8, (L, 1, H, T, d)), ("v_all", v_all, i8, (L, 1, H, T, d)),
        ("k_scale", k_scale, bf16, (L, 1, H, T)), ("v_scale", v_scale, bf16, (L, 1, H, T)),
        ("bias2d", bias2d, f32, (1, T)),
        ("wo_all", wo_all, i8, (L, H * d, D)), ("wos_all", wos_all, f32, (L, 1, D)),
        ("mw_all", mw_all, norm, (L, D)),
        ("wgu_all", wgu_all, i8, (L, D, 2 * F)), ("sgu_all", sgu_all, f32, (L, 1, 2 * F)),
        ("wd_all", wd_all, i8, (L, F, D)), ("sd_all", sd_all, f32, (L, 1, D)),
        ("nw_all", nw_all, norm, (L, D)),
        ("wq_all", wq_all, i8, (L, D, Q)), ("sq_all", sq_all, f32, (L, 1, Q)),
        ("cos_f", cos_f, f32, (1, d)), ("sin_f", sin_f, f32, (1, d)),
    ]
    if bqkv_all is not None:
        specs.append(("bqkv_all", bqkv_all, (torch.float32, torch.bfloat16), (L, Q)))
    for name, t, dtypes, shape in specs:
        if t.device != dev or t.dtype not in dtypes or tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: expected {dtypes} {tuple(shape)} on {dev}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    plan, table, ws_bytes = _launch(L, H, d, D, F, T, int(grid) or _sm_count(index), index)
    ws = torch.empty((int(ws_bytes),), dtype=torch.uint8, device=dev)
    x_out = torch.empty((1, D), dtype=torch.float32, device=dev)
    kn_out = torch.empty((L, H, d), dtype=torch.float32, device=dev)
    vn_out = torch.empty((L, H, d), dtype=torch.float32, device=dev)
    fn = _build.kernel("vt_decode_step_fused", _ARGTYPES)
    decode_step_fused_packed.launches += 1
    rc = fn(q0.data_ptr(), kn0.data_ptr(), vn0.data_ptr(), x.data_ptr(),
            k_all.data_ptr(), v_all.data_ptr(), k_scale.data_ptr(), v_scale.data_ptr(),
            bias2d.data_ptr(), wo_all.data_ptr(), wos_all.data_ptr(), mw_all.data_ptr(),
            wgu_all.data_ptr(), sgu_all.data_ptr(), wd_all.data_ptr(), sd_all.data_ptr(),
            nw_all.data_ptr(), wq_all.data_ptr(), sq_all.data_ptr(),
            None if bqkv_all is None else bqkv_all.data_ptr(),
            cos_f.data_ptr(), sin_f.data_ptr(),
            x_out.data_ptr(), kn_out.data_ptr(), vn_out.data_ptr(),
            _kind(nw_all, "nw_all"), 0 if bqkv_all is None else _kind(bqkv_all, "bqkv_all"),
            plan.grid, L, H, T, d, D, F, float(sm_scale), float(eps),
            ws.data_ptr(), ws.numel(), table.data_ptr(), plan.S, plan.n, plan.kc, plan.stages,
            plan.max_items, plan.smem, None if stamps is None else stamps.data_ptr(),
            int(trace_layer), _build.stream_ptr(q0))
    _build.check(rc, "vt_decode_step_fused")
    return x_out, kn_out, vn_out


def max_resident_blocks(H: int, d: int, D: int, F: int, T: int) -> int:
    """SMs × the blocks of the kernel one SM keeps resident at these shapes:
    the largest grid a cooperative launch accepts."""
    return int(_build.kernel("vt_decode_step_max_blocks", [_build.I] * 5)(H, d, D, F, T))


#: launches of the CUDA kernel (the plain version is not counted)
decode_step_fused_packed.launches = 0

__all__ = ["decode_step_fused_packed", "decode_step_fused_plain", "max_resident_blocks",
           "StepPlan", "step_plan", "STAMP_POINTS", "N_STAMPS"]
