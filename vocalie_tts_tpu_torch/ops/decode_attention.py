"""q_len == 1 decode attention over the KV cache: the int8 T-blocked
kernel (B1), the int8 whole-row kernel (B1w), the f32 branches over a
bf16/f32 cache (K1) and over the int8 cache dequantized (K2), the
single-layer kernel (B10), and their plain versions.

Counterpart of ``vocalie_tts_tpu/ops/decode_attention.py``:

- :func:`decode_attention_stacked` takes JAX's branch choice
  (``decode_attention_stacked`` :565-854): ``int8_dots`` with ``k_new``,
  ``valid_len`` and a 128-multiple cache → the T-blocked int8 kernel
  (:func:`decode_attention_int8_stacked`, B1: ``_kernel_stacked_int8dots_packed_tblk``
  / ``_kernel_stacked_int8dots_tblk``, whose numbers are identical);
  ``int8_dots`` otherwise (a cache that is not a 128-multiple, or no
  ``k_new`` / ``valid_len``) → the whole-row int8 kernel
  (:func:`decode_attention_int8_whole_stacked`, B1w:
  ``_kernel_stacked_int8dots[_new]`` and ``_kernel_stacked_int8dots_packed``,
  whose selector matmuls are exact, so over the split cache they are one
  function); scales without ``int8_dots`` → the f32-dequant branch
  (:func:`decode_attention_dequant_stacked`, K2: ``_kernel_stacked_quant[_new]``);
  no scales → the float-cache branch (:func:`decode_attention_float_stacked`,
  K1: ``_kernel_stacked_plain[_new]``);
- :func:`decode_attention` is B10 (``decode_attention`` :85: one unstacked
  layer, no current token, ``_kernel_quant`` / ``_kernel_plain``).

The port keeps k and v split (``[L, b, kv, T, d]`` each; the int8 cache's
bf16 scales ``[L, b, kv, T]``); the TPU's lane-packed k|v is not copied.
The cache is read in place and never written here: the current token's
k/v (``k_new``/``v_new``) join the softmax in f32.

On a CUDA tensor each wrapper launches ``csrc/decode_attention.cu``; on a
CPU tensor it runs its plain version.

K1, K2 and B10 share one CUDA body, split over the cache: each (row, kv
head) gets a thread-block cluster of :func:`attend_splits` blocks, block r
takes the slots :func:`attend_ranges` gives it and runs an online softmax
over them in f32; in the same launch the blocks then share out the
outputs, and each merges every block's partial softmax for its outputs,
read through distributed shared memory in rank order, then the current
token.

B1 is split the same way, on 128-slot block boundaries: a cluster of
:func:`int8_splits` blocks per (row, kv head), rank r taking the blocks
:func:`int8_block_ranges` gives it. Each rank scores its blocks, the ranks
publish their maxima, and each rank runs the sequential chain over its own
blocks from the prefix max of the ranks before it, so every block's p is
quantized against the running max the plain version uses; the ranks'
states then merge in rank order.

B1w is split the same way, off the 128-slot grid: a cluster of
:func:`whole_splits` blocks per (row, kv head), rank r taking the slots
:func:`whole_ranges` gives it. Its math has no chain: the ranks publish the
row max, then l and the p-max, so that every rank rounds its p8 against the
one scale of the whole row, and the int32 partials meet in any order. A
row past 16 blocks' shared memory, or a call with ``one_block=True``, runs
the first, one-block body (its scores in a global workspace past 200 KB).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from vocalie_tts_tpu_torch.ops import _build
from vocalie_tts_tpu_torch.ops.decode_dense import _int_dot, _quantize_rows

#: slots per T block — the probabilities are re-quantized per block, so
#: this must equal the JAX kernel's 128 for the numbers to match
TBLK = 128

_ARGTYPES = [_build.P] * 10 + [_build.I] * 8 + [_build.F, _build.P]

#: B1's split: blocks it aims for (two per SM of the H100's 132), the
#: largest cluster (the kernel's ATT_MAX_SPLITS), and the dynamic shared
#: bytes a block may take (the kernel's I8_SMEM_MAX)
INT8_SPLIT_TARGET_BLOCKS = 264
INT8_SPLIT_MAX = 16
INT8_SMEM_MAX = 160 * 1024
#: the phase points at which B1 writes the card's clock when given
#: ``stamps`` (csrc I8_STAMPS): per block, in order
INT8_STAMP_POINTS = ("start", "q quantized", "scores and maxima", "barrier 1 passed",
                     "first block's p8 and v in", "chain done", "barrier 2 passed",
                     "outputs written")
INT8_STAMPS = len(INT8_STAMP_POINTS)


def n_valid_blocks(valid_len: int, T: int) -> int:
    """Blocks the kernel reads: ceil(valid_len / 128), at least one."""
    return min(max(-(-int(valid_len) // TBLK), 1), T // TBLK)


def int8_smem(g: int, d: int, n_blk: int, splits: int) -> int:
    """B1's dynamic shared bytes a block, for the most blocks a rank takes:
    the scores of its group members (g rounded up to a power of two), the v
    scales, each block's maxima (a multiple of 4 words), and one 128-slot
    block of v rows, or two where a rank takes more than one
    (``csrc/decode_attention.cu`` ``i8_smem_bytes``)."""
    G = 1 << (int(g) - 1).bit_length()
    nbm = -(-int(n_blk) // splits)
    bmax = -(-nbm * G // 4) * 4
    return (G * nbm * TBLK + nbm * TBLK + bmax) * 4 + (2 if nbm > 1 else 1) * TBLK * d


def int8_splits(bc: int, n_blk: int, g: int, d: int, resident=None) -> int:
    """Blocks per (row, kv head) of B1: the fewest whose shared bytes fit
    :data:`INT8_SMEM_MAX`, then one more while the ``bc`` pairs have fewer
    than :data:`INT8_SPLIT_TARGET_BLOCKS` blocks, every rank keeps at least
    one of the ``n_blk`` 128-slot blocks, the count stays at most
    :data:`INT8_SPLIT_MAX` and (given ``resident(splits)``, the clusters of
    that size the card keeps resident at once) all ``bc`` clusters still run
    in one wave. Past two blocks an SM the ranks mostly wait on the same
    bytes: the T3 shape ran slower at 3 and 4 ranks than at 2
    (``chip_smoke.py --attn-gn-rows --sweep``). Raises ``ValueError`` where
    no count fits."""
    top = min(int(n_blk), INT8_SPLIT_MAX)
    s = 1
    while s <= top and int8_smem(g, d, n_blk, s) > INT8_SMEM_MAX:
        s += 1
    if s > top:
        raise ValueError(f"{n_blk} blocks of scores do not fit {INT8_SPLIT_MAX} blocks' "
                         "shared memory")
    while (s < top and bc * s < INT8_SPLIT_TARGET_BLOCKS
           and (resident is None or bc <= resident(s + 1))):
        s += 1
    return s


def int8_block_ranges(n_blk: int, splits: int) -> list:
    """The 128-slot blocks ``[lo, hi)`` rank r of B1's split takes, as the
    kernel cuts them: ``r * n_blk // splits`` up to the next rank's start."""
    return [(r * n_blk // splits, (r + 1) * n_blk // splits) for r in range(splits)]


@functools.lru_cache(maxsize=None)
def resident_int8_clusters(g: int, d: int, n_blk: int, splits: int) -> int:
    """Clusters of ``splits`` blocks the card keeps resident at once for B1
    at this g, d and count of valid blocks (``cudaOccupancyMaxActiveClusters``)."""
    n = ctypes.c_int(0)
    rc = _build.kernel("vt_attend_int8_clusters", [_build.I] * 4 + [_build.P])(
        g, d, n_blk, splits, ctypes.byref(n))
    _build.check(rc, "vt_attend_int8_clusters")
    return n.value


@functools.lru_cache(maxsize=4096)
def card_int8_splits(bc: int, n_blk: int, g: int, d: int) -> int:
    """The split B1 takes on the card for ``bc`` (row, kv head) pairs over
    ``n_blk`` valid blocks (:func:`int8_splits` with the card's resident
    clusters)."""
    return int8_splits(bc, n_blk, g, d, lambda s: resident_int8_clusters(g, d, n_blk, s))


#: B1w's split: blocks it aims for, the largest cluster, the fewest slots a
#: rank keeps when the planner adds ranks (a rank walks its slots 128 a pass,
#: one row a lane: at the Qwen3 shape 3 ranks of ~117 slots ran 0.012379 ms
#: graph-timed, 4 of 88 0.012665, 5 of 70 0.013263; at T3 2 of 276 and 3 of
#: 184 ran alike, 0.015179: ``chip_smoke.py --whole-mlp-rows --sweep`` on an
#: H100), and the dynamic shared bytes a block may take (the kernel's
#: W_SMEM_MAX)
WHOLE_SPLIT_TARGET_BLOCKS = 264
WHOLE_SPLIT_MAX = 16
WHOLE_MIN_SLOTS = 96
WHOLE_SMEM_MAX = 160 * 1024
#: the phase points at which split B1w writes the card's clock when given
#: ``stamps`` (csrc W_STAMPS): per block, in order
WHOLE_STAMP_POINTS = ("start", "q quantized", "scores and maxima", "barrier 1 passed",
                      "p, l and the p-max", "barrier 2 passed", "p8 . v summed",
                      "barrier 3 passed", "outputs written")
WHOLE_STAMPS = len(WHOLE_STAMP_POINTS)


def whole_smem(g: int, d: int, ns: int) -> int:
    """Split B1w's dynamic shared bytes a block, for the most slots ``ns`` a
    rank takes, padded to 4: the scores of its group members (g rounded up
    to a power of two) and the v scales in f32, its v rows, and its p8 as
    bytes (``csrc/decode_attention.cu`` ``w_smem_bytes``)."""
    G = 1 << (int(g) - 1).bit_length()
    return (-(-int(ns) // 4) * 4) * ((G + 1) * 4 + d + G)


def whole_ranges(n: int, splits: int) -> list:
    """The slots ``[lo, hi)`` rank r of split B1w takes, as the kernel cuts
    them: ``r * n // splits`` up to the next rank's start."""
    return [(r * n // splits, (r + 1) * n // splits) for r in range(splits)]


def whole_splits(bc: int, n: int, g: int, d: int, resident=None) -> Optional[int]:
    """Blocks per (row, kv head) of split B1w over ``n`` slots: the fewest
    whose scores and v rows fit :data:`WHOLE_SMEM_MAX`, then one more while
    the ``bc`` pairs have fewer than :data:`WHOLE_SPLIT_TARGET_BLOCKS` blocks,
    every rank keeps :data:`WHOLE_MIN_SLOTS` slots, the count stays at most
    :data:`WHOLE_SPLIT_MAX` and (given ``resident(splits)``, the clusters of
    that size the card keeps resident at once) all ``bc`` clusters still run
    in one wave. None where even 16 ranks cannot hold the row, or the card
    holds no cluster of the fewest: the one-block body takes it."""
    s = 1
    while whole_smem(g, d, -(-int(n) // s)) > WHOLE_SMEM_MAX:
        s += 1
        if s > min(int(n), WHOLE_SPLIT_MAX):
            return None
    if resident is not None and resident(s) < 1:
        return None
    top = max(s, min(int(n) // WHOLE_MIN_SLOTS, WHOLE_SPLIT_MAX))
    while (s < top and bc * s < WHOLE_SPLIT_TARGET_BLOCKS
           and (resident is None or bc <= resident(s + 1))):
        s += 1
    return s


@functools.lru_cache(maxsize=None)
def resident_whole_clusters(g: int, d: int, ns: int, splits: int) -> int:
    """Clusters of ``splits`` blocks the card keeps resident at once for
    split B1w at this g and d, a rank taking ``ns`` slots
    (``cudaOccupancyMaxActiveClusters``)."""
    n = ctypes.c_int(0)
    rc = _build.kernel("vt_attend_whole_clusters", [_build.I] * 4 + [_build.P])(
        g, d, ns * splits, splits, ctypes.byref(n))
    _build.check(rc, "vt_attend_whole_clusters")
    return n.value


@functools.lru_cache(maxsize=4096)
def card_whole_splits(bc: int, n: int, g: int, d: int) -> Optional[int]:
    """The split B1w takes on the card for ``bc`` (row, kv head) pairs over
    ``n`` slots (:func:`whole_splits` with the card's resident clusters,
    asked at a rank's slots rounded up to 128 where those fit: the cache
    grows a slot a step, and fewer shared bytes never hold fewer
    clusters)."""
    def resident(s):
        ns = -(-int(n) // s)
        up = -(-ns // TBLK) * TBLK
        return resident_whole_clusters(g, d, up if whole_smem(g, d, up) <= WHOLE_SMEM_MAX
                                       else ns, s)

    return whole_splits(bc, n, g, d, resident)


def decode_attention_plain(q, k_all, v_all, bias, layer: int, k_scale, v_scale,
                           k_new, v_new, valid_len: int, sm_scale: float,
                           sum_dtype: torch.dtype = torch.float32):
    """The JAX kernel's math in PyTorch ops (see module doc). ``sum_dtype``
    float64 sums each block's probabilities and the current token's score
    in double, rounded to f32 once, as the whole-layer kernel (B12) does:
    then any summation order gives the same f32."""
    b, kv, g, d = q.shape
    T = k_all.shape[3]
    BC = b * kv
    f32 = torch.float32
    qf = q.reshape(BC, g, d).to(f32)
    qq, qs = _quantize_rows(qf)          # int values, exact in f32
    k = k_all[layer].reshape(BC, T, d)
    v = v_all[layer].reshape(BC, T, d)
    ks = k_scale[layer].reshape(BC, T).to(f32)
    vs = v_scale[layer].reshape(BC, T).to(f32)
    bias_m = bias.to(f32)[:, None, :].expand(b, kv, T).reshape(BC, T)
    m = torch.full((BC, g, 1), -1e30, dtype=f32, device=q.device)
    lsum = torch.zeros((BC, g, 1), dtype=f32, device=q.device)
    acc = torch.zeros((BC, g, d), dtype=f32, device=q.device)
    for blk in range(n_valid_blocks(valid_len, T)):
        sl = slice(blk * TBLK, (blk + 1) * TBLK)
        # int8 x int8 dots: every partial sum is an integer below 2**24,
        # so the f32 products are exact in any summation order
        s = torch.matmul(qq, k[:, sl].to(f32).transpose(1, 2))
        s = s * (qs * sm_scale)
        s = s * ks[:, None, sl] + bias_m[:, None, sl]
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        lsum = lsum * corr + p.to(sum_dtype).sum(-1, keepdim=True).float()
        p = p * vs[:, None, sl]
        p8, ps = _quantize_rows(p, floor=1e-20)   # p >= 0
        o = torch.matmul(p8, v[:, sl].to(f32))
        acc = acc * corr + o * ps
        m = m_new
    kn = k_new.reshape(BC, 1, d).to(f32)
    vn = v_new.reshape(BC, 1, d).to(f32)
    s_new = (qf.to(sum_dtype) * kn.to(sum_dtype)).sum(-1, keepdim=True).float() * sm_scale
    m_fin = torch.maximum(m, s_new)
    corr = torch.exp(m - m_fin)
    p_new = torch.exp(s_new - m_fin)
    l_fin = lsum * corr + p_new
    o = acc * corr + p_new * vn
    return (o / torch.clamp(l_fin, min=1e-30)).reshape(b, kv, g, d)


def decode_attention_int8_stacked(
    q: torch.Tensor,          # [b, kv, g, d] f32
    k_all: torch.Tensor,      # [L, b, kv, T, d] int8
    v_all: torch.Tensor,      # [L, b, kv, T, d] int8
    bias: torch.Tensor,       # [b, T] f32 additive mask
    layer: int,
    k_scale: torch.Tensor,    # [L, b, kv, T] bf16
    v_scale: torch.Tensor,
    k_new: torch.Tensor,      # [b, kv, d] f32 — current token's k
    v_new: torch.Tensor,
    *,
    valid_len: int,           # cached slots in use (blocks past it are skipped)
    sm_scale: float,
    splits: Optional[int] = None,   # on a card: force the cluster size (1..n_blk, <= 16)
    stamps: Optional[torch.Tensor] = None,   # on a card: [b·kv·splits, INT8_STAMPS] int64 trace
) -> torch.Tensor:
    """B1: attention output ``[b, kv, g, d]`` f32 for layer ``layer`` of the
    int8 cache, q and p re-quantized to int8 per 128-slot block."""
    L, b, kv, T, d = k_all.shape
    g = q.shape[2]
    if T % TBLK:
        raise ValueError(f"cache length {T} must be a multiple of {TBLK}")
    if q.device.type == "cpu":
        return decode_attention_plain(q, k_all, v_all, bias, layer, k_scale, v_scale,
                                      k_new, v_new, valid_len, sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if not (1 <= g <= 8 and d % 16 == 0 and 16 <= d <= 128):
        raise ValueError(f"kernel takes 1 <= g <= 8 and d in 16..128 step 16, got g={g} d={d}")
    if not 0 <= int(layer) < L:
        raise ValueError(f"layer {layer} outside 0..{L - 1}")
    for name, t, dtype, shape in (
        ("q", q, torch.float32, (b, kv, g, d)),
        ("k_all", k_all, torch.int8, (L, b, kv, T, d)),
        ("v_all", v_all, torch.int8, (L, b, kv, T, d)),
        ("bias", bias, torch.float32, (b, T)),
        ("k_scale", k_scale, torch.bfloat16, (L, b, kv, T)),
        ("v_scale", v_scale, torch.bfloat16, (L, b, kv, T)),
        ("k_new", k_new, torch.float32, (b, kv, d)),
        ("v_new", v_new, torch.float32, (b, kv, d)),
    ):
        if t.device != q.device or t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(
                f"{name}: expected {dtype} {shape} on {q.device}, got "
                f"{t.dtype} {tuple(t.shape)} on {t.device}"
            )
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    n_blk = n_valid_blocks(valid_len, T)
    if splits is None:
        splits = card_int8_splits(b * kv, n_blk, g, d)
    elif (not 1 <= splits <= min(n_blk, INT8_SPLIT_MAX)
          or int8_smem(g, d, n_blk, splits) > INT8_SMEM_MAX):
        raise ValueError(f"splits={splits} outside 1..{min(n_blk, INT8_SPLIT_MAX)} for {n_blk} "
                         "blocks, or a rank's scores past the shared memory")
    if stamps is not None and (stamps.dtype != torch.int64 or stamps.device != q.device
                               or stamps.numel() < b * kv * splits * INT8_STAMPS):
        raise ValueError(f"stamps: int64 on {q.device}, {b * kv * splits * INT8_STAMPS} or more")
    out = torch.empty((b, kv, g, d), dtype=torch.float32, device=q.device)
    fn = _build.kernel("vt_decode_attention_int8", _ARGTYPES)
    decode_attention_int8_stacked.launches += 1
    rc = fn(
        q.data_ptr(), k_all.data_ptr(), v_all.data_ptr(),
        k_scale.data_ptr(), v_scale.data_ptr(), bias.data_ptr(),
        k_new.data_ptr(), v_new.data_ptr(), out.data_ptr(),
        stamps.data_ptr() if stamps is not None else None,
        b, kv, g, d, T, int(layer), int(valid_len), int(splits), float(sm_scale),
        _build.stream_ptr(q),
    )
    _build.check(rc, "vt_decode_attention_int8")
    return out


#: launches of the CUDA kernel (the plain version is not counted)
decode_attention_int8_stacked.launches = 0



# ── B1w: the int8 whole-row branch ──

_WHOLE_ARGTYPES = ([_build.P] * 10 + [_build.LL] + [_build.I] * 7 + [_build.F, _build.P])
_WHOLE_SPLIT_ARGTYPES = [_build.P] * 10 + [_build.I] * 8 + [_build.F, _build.P]


def decode_attention_whole_plain(q, k_all, v_all, bias, layer: int, k_scale, v_scale,
                                 k_new=None, v_new=None, valid_len=None, *, sm_scale: float):
    """B1w's plain version: JAX ``_kernel_stacked_int8dots[_new]`` (:190-265)
    over the slots ``_n_slots`` reads: q quantized per row, the int8 scores
    times ``qs · sm_scale`` and ``ks`` plus the bias, ONE max (with the
    current token's exact score in it), ``l`` summed before the v scales,
    p · vs quantized with one scale over the row, the int8 PV product times
    ``ps``, the current token added exactly, ``/ max(l, 1e-30)``."""
    b, kv, g, d = q.shape
    T = k_all.shape[3]
    n = _n_slots(T, k_new, valid_len)
    BC = b * kv
    f32 = torch.float32
    qf = q.reshape(BC, g, d).to(f32)
    qq, qs = _quantize_rows(qf)
    k = k_all[layer].reshape(BC, T, d)[:, :n]
    v = v_all[layer].reshape(BC, T, d)[:, :n]
    ks = k_scale[layer].reshape(BC, T)[:, :n].to(f32)
    vs = v_scale[layer].reshape(BC, T)[:, :n].to(f32)
    bias_m = bias.to(f32)[:, None, :n].expand(b, kv, n).reshape(BC, n)
    s = _int_dot(qq, k.transpose(1, 2)) * (qs * sm_scale)
    s = s * ks[:, None, :] + bias_m[:, None, :]
    m = s.amax(-1, keepdim=True)
    if k_new is not None:
        s_new = (qf * k_new.reshape(BC, 1, d).to(f32)).sum(-1, keepdim=True) * sm_scale
        m = torch.maximum(m, s_new)
    p = torch.exp(s - m)
    lsum = p.sum(-1, keepdim=True)
    p8, ps = _quantize_rows(p * vs[:, None, :], floor=1e-20)   # p >= 0
    o = _int_dot(p8, v) * ps
    if k_new is not None:
        p_new = torch.exp(s_new - m)
        lsum = lsum + p_new
        o = o + p_new * v_new.reshape(BC, 1, d).to(f32)
    return (o / torch.clamp(lsum, min=1e-30)).reshape(b, kv, g, d)


@functools.lru_cache(maxsize=None)
def _whole_ws_bytes(b: int, kv: int, g: int, T: int) -> int:
    return _build.kernel("vt_attn_whole_workspace", [_build.I] * 4, restype=_build.LL)(
        b, kv, g, T)


def decode_attention_int8_whole_stacked(
    q: torch.Tensor,          # [b, kv, g, d] f32
    k_all: torch.Tensor,      # [L, b, kv, T, d] int8
    v_all: torch.Tensor,
    bias: torch.Tensor,       # [b, T] f32 additive mask
    layer: int,
    k_scale: torch.Tensor,    # [L, b, kv, T] bf16
    v_scale: torch.Tensor,
    k_new: Optional[torch.Tensor] = None,   # [b, kv, d] f32 — current token's k
    v_new: Optional[torch.Tensor] = None,
    *,
    valid_len: Optional[int] = None,   # with k_new: slots at and past it are masked
    sm_scale: float,
    splits: Optional[int] = None,   # on a card: force the cluster size (1..min(n, 16))
    one_block: bool = False,        # on a card: the one-block body (the yardstick)
    stamps: Optional[torch.Tensor] = None,   # on a card: [b·kv·splits, WHOLE_STAMPS] int64
) -> torch.Tensor:
    """B1w: attention output ``[b, kv, g, d]`` f32 for layer ``layer`` of the
    int8 cache, one softmax and one p scale over the whole row (any T). On a
    card: split over a cluster (:func:`card_whole_splits`), or the one-block
    body where no split holds the row or ``one_block`` is set."""
    L, b, kv, T, d = k_all.shape
    g = q.shape[2]
    if (k_new is None) != (v_new is None):
        raise ValueError("k_new and v_new go together")
    if _on(q) == "cpu":
        return decode_attention_whole_plain(q, k_all, v_all, bias, layer, k_scale, v_scale,
                                            k_new, v_new, valid_len, sm_scale=sm_scale)
    if not (1 <= g <= 8 and d % 16 == 0 and 16 <= d <= 128):
        raise ValueError(f"kernel takes 1 <= g <= 8 and d in 16..128 step 16, got g={g} d={d}")
    if not 0 <= int(layer) < L:
        raise ValueError(f"layer {layer} outside 0..{L - 1}")
    checks = [("q", q, torch.float32, (b, kv, g, d)),
              ("k_all", k_all, torch.int8, (L, b, kv, T, d)),
              ("v_all", v_all, torch.int8, (L, b, kv, T, d)),
              ("bias", bias, torch.float32, (b, T)),
              ("k_scale", k_scale, torch.bfloat16, (L, b, kv, T)),
              ("v_scale", v_scale, torch.bfloat16, (L, b, kv, T))]
    if k_new is not None:
        checks += [("k_new", k_new, torch.float32, (b, kv, d)),
                   ("v_new", v_new, torch.float32, (b, kv, d))]
    for name, t, dtype, shape in checks:
        if t.device != q.device or t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(
                f"{name}: expected {dtype} {shape} on {q.device}, got "
                f"{t.dtype} {tuple(t.shape)} on {t.device}"
            )
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    n = _n_slots(T, k_new, valid_len)
    if one_block:
        splits = None
    elif splits is None:
        splits = card_whole_splits(b * kv, n, g, d)
    elif (not 1 <= splits <= min(n, WHOLE_SPLIT_MAX)
          or whole_smem(g, d, -(-n // splits)) > WHOLE_SMEM_MAX):
        raise ValueError(f"splits={splits} outside 1..{min(n, WHOLE_SPLIT_MAX)} for {n} slots, "
                         "or a rank's scores and v rows past the shared memory")
    if stamps is not None and (splits is None or stamps.dtype != torch.int64
                               or stamps.device != q.device
                               or stamps.numel() < b * kv * splits * WHOLE_STAMPS):
        raise ValueError(f"stamps: the split body's, int64 on {q.device}, "
                         f"{b * kv * (splits or 0) * WHOLE_STAMPS} or more")
    out = torch.empty((b, kv, g, d), dtype=torch.float32, device=q.device)
    ptr = lambda t: 0 if t is None else t.data_ptr()   # noqa: E731
    head = (q.data_ptr(), k_all.data_ptr(), v_all.data_ptr(), k_scale.data_ptr(),
            v_scale.data_ptr(), bias.data_ptr(), ptr(k_new), ptr(v_new), out.data_ptr())
    decode_attention_int8_whole_stacked.launches += 1
    if splits is not None:
        decode_attention_int8_whole_stacked.cluster_launches += 1
        rc = _build.kernel("vt_decode_attention_int8_whole_split", _WHOLE_SPLIT_ARGTYPES)(
            *head, ptr(stamps), b, kv, g, d, T, int(layer), n, int(splits), float(sm_scale),
            _build.stream_ptr(q))
        _build.check(rc, "vt_decode_attention_int8_whole_split")
        return out
    need = _whole_ws_bytes(b, kv, g, T)
    ws = torch.empty((max(need, 1),), dtype=torch.uint8, device=q.device)
    rc = _build.kernel("vt_decode_attention_int8_whole", _WHOLE_ARGTYPES)(
        *head, ws.data_ptr(), ws.numel(), b, kv, g, d, T, int(layer), n, float(sm_scale),
        _build.stream_ptr(q))
    _build.check(rc, "vt_decode_attention_int8_whole")
    return out


#: launches of the CUDA kernels (the plain version is not counted);
#: ``cluster_launches``: those of the split body (the rest ran the one-block
#: body)
decode_attention_int8_whole_stacked.launches = 0
decode_attention_int8_whole_stacked.cluster_launches = 0


# ── the f32 branches: K1 (float cache), K2 (int8 cache dequantized), B10 ──

#: the f32 kernel's modes: no scales (K1, B10 plain), the stacked
#: dequantizing branch (K2: ``s · (sm_scale · ks)``, ``v · vs``), B10's
#: ``_kernel_quant`` (``(s · sm_scale) · ks``, ``p · vs``)
_MODE = {"plain": 0, "dequant": 1, "b10": 2}
_CACHE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_SCALE_CODE = {None: 0, torch.bfloat16: 1, torch.float32: 2}
_F32_ARGTYPES = [_build.P] * 9 + [_build.I] * 3 + [_build.LL] + [_build.I] * 7 + [_build.F,
                                                                                  _build.P]
#: blocks the split aims for (two per SM of the H100's 132), the fewest
#: slots a block of the split takes, and the largest cluster (16 is
#: non-portable; the kernel's ATT_MAX_SPLITS)
SPLIT_TARGET_BLOCKS = 264
SPLIT_MIN_SLOTS = 16
SPLIT_MAX = 16


def attend_splits(bc: int, n_slots: int, resident=None) -> int:
    """Blocks per (row, kv head) of the f32 kernel, a power of two: doubled
    while the ``bc`` pairs have fewer than :data:`SPLIT_TARGET_BLOCKS`
    blocks, every block keeps at least :data:`SPLIT_MIN_SLOTS` of the
    ``n_slots`` slots, the count stays at most :data:`SPLIT_MAX`, and (given
    ``resident(splits)``, the clusters of that size the card keeps resident
    at once) all ``bc`` clusters still run in one wave: a second wave costs
    more than the extra blocks gain."""
    s = 1
    while (bc * s < SPLIT_TARGET_BLOCKS and 2 * s <= SPLIT_MAX
           and 2 * s * SPLIT_MIN_SLOTS <= n_slots
           and (resident is None or bc <= resident(2 * s))):
        s *= 2
    return s


@functools.lru_cache(maxsize=None)
def resident_clusters(cache: int, scale: int, mode: int, g: int, splits: int) -> int:
    """Clusters of ``splits`` blocks the card keeps resident at once for the
    kernel these codes select (``cudaOccupancyMaxActiveClusters``)."""
    n = ctypes.c_int(0)
    rc = _build.kernel("vt_attend_clusters", [_build.I] * 5 + [_build.P])(
        cache, scale, mode, g, splits, ctypes.byref(n))
    _build.check(rc, "vt_attend_clusters")
    return n.value


def f32_codes(k_all: torch.Tensor, k_scale, mode: str, g: int) -> tuple:
    """The C entry's codes for this cache, its scales and ``mode``, and g:
    the key of the kernel instantiation :func:`resident_clusters` asks
    about."""
    return (_CACHE_CODE[k_all.dtype], _SCALE_CODE[None if k_scale is None else k_scale.dtype],
            _MODE[mode], g)


@functools.lru_cache(maxsize=4096)
def _card_splits(codes: tuple, bc: int, n_slots: int) -> int:
    return attend_splits(bc, n_slots, lambda s: resident_clusters(*codes, s))


def f32_splits(k_all: torch.Tensor, k_scale, mode: str, b: int, kv: int, g: int,
               n_slots: int) -> int:
    """The split the f32 kernel takes for this cache, mode and shape on the
    card (:func:`attend_splits` with the card's resident clusters)."""
    return _card_splits(f32_codes(k_all, k_scale, mode, g), b * kv, n_slots)


def attend_ranges(n_slots: int, splits: int) -> list:
    """The slots ``[lo, hi)`` block r of the split reads, as the kernel
    cuts them: ``ceil(n_slots / splits)`` each, the last ones short or
    empty."""
    chunk = -(-int(n_slots) // splits)
    return [(min(r * chunk, n_slots), min((r + 1) * chunk, n_slots)) for r in range(splits)]



def _attend_plain(q, k, v, bias, factors, sm_scale, k_new=None, v_new=None, p_scale=None):
    """JAX's ``_attend_chunk`` (:150-176) over ``[b, kv, ...]``: q ``[b, kv,
    g, d]`` f32, k/v ``[b, kv, T, d]`` (dequantized f32 for K2), bias ``[b,
    T]``; the scores are multiplied by each of ``factors`` in turn
    (``sm_scale``, ``sm_scale · ks`` as ``[b, kv, 1, T]``, or B10's
    ``sm_scale`` then ``ks``); ``p_scale`` (B10's ``vs``) multiplies p after
    its sum, before the PV product. Returns ``[b, kv, g, d]`` f32."""
    f32 = torch.float32
    s = torch.matmul(q, k.to(f32).transpose(-1, -2))           # [b, kv, g, T]
    for f in factors:
        s = s * f
    s = s + bias.to(f32)[:, None, None, :]
    m = s.amax(-1, keepdim=True)
    if k_new is not None:
        s_new = (q * k_new.to(f32)[:, :, None, :]).sum(-1, keepdim=True) * sm_scale
        m = torch.maximum(m, s_new)
    p = torch.exp(s - m)
    lsum = p.sum(-1, keepdim=True)
    if p_scale is not None:
        p = p * p_scale
    o = torch.matmul(p, v.to(f32))
    if k_new is not None:
        p_new = torch.exp(s_new - m)
        lsum = lsum + p_new
        o = o + p_new * v_new.to(f32)[:, :, None, :]
    return o / torch.clamp(lsum, min=1e-30)


def _n_slots(T: int, k_new, valid_len) -> int:
    """Slots the f32 branches read. With the current token merged (``k_new``)
    a masked slot's probability is exactly 0 and its score is below the
    current token's, so the slots at and past ``valid_len`` (all masked in
    the decode step) add nothing and are skipped; otherwise every slot is
    read (with every slot masked, the softmax spreads over all of them)."""
    if k_new is None or valid_len is None:
        return T
    return min(max(int(valid_len), 1), T)


def decode_attention_float_plain(q, k_all, v_all, bias, layer: int, k_new=None, v_new=None,
                                 valid_len=None, *, sm_scale: float):
    """K1's plain version: JAX ``_kernel_stacked_plain[_new]`` on a bf16 or
    f32 cache."""
    n = _n_slots(k_all.shape[3], k_new, valid_len)
    return _attend_plain(q.float(), k_all[layer][:, :, :n], v_all[layer][:, :, :n],
                         bias[:, :n], (sm_scale,), sm_scale, k_new, v_new)


def decode_attention_dequant_plain(q, k_all, v_all, bias, layer: int, k_scale, v_scale,
                                   k_new=None, v_new=None, valid_len=None, *, sm_scale: float):
    """K2's plain version: JAX ``_kernel_stacked_quant[_new]``, v
    dequantized by its scales and ``sm_scale · ks`` on the scores."""
    n = _n_slots(k_all.shape[3], k_new, valid_len)
    ks = k_scale[layer][:, :, :n].float()
    vs = v_scale[layer][:, :, :n].float()
    v = v_all[layer][:, :, :n].float() * vs[..., None]
    return _attend_plain(q.float(), k_all[layer][:, :, :n], v, bias[:, :n],
                         (sm_scale * ks[:, :, None, :],), sm_scale, k_new, v_new)


def decode_attention_plain_b10(q, k_cache, v_cache, bias, k_scale=None, v_scale=None, *,
                               sm_scale: float):
    """B10's plain version: JAX ``_kernel_quant`` (``(s · sm_scale) · ks``,
    p times ``vs`` after its sum) or ``_kernel_plain``."""
    if k_scale is None:
        return _attend_plain(q.float(), k_cache, v_cache, bias, (sm_scale,), sm_scale)
    return _attend_plain(q.float(), k_cache, v_cache, bias,
                         (sm_scale, k_scale.float()[:, :, None, :]), sm_scale,
                         p_scale=v_scale.float()[:, :, None, :])


def _launch_f32(wrapper, mode: str, q, k_all, v_all, bias, layer: int, k_scale, v_scale, k_new,
                v_new, n_slots: int, sm_scale: float) -> torch.Tensor:
    """Check the inputs of the f32 kernel and launch it on ``k_all``'s layer
    ``layer`` (``[L, b, kv, T, d]``), counting the launch on ``wrapper``."""
    L, b, kv, T, d = k_all.shape
    g = q.shape[2]
    if not (1 <= g <= 8 and d % 16 == 0 and 16 <= d <= 128):
        raise ValueError(f"kernel takes 1 <= g <= 8 and d in 16..128 step 16, got g={g} d={d}")
    if not 0 <= int(layer) < L:
        raise ValueError(f"layer {layer} outside 0..{L - 1}")
    cache_types = (torch.int8,) if mode != "plain" else (torch.bfloat16, torch.float32)
    if k_all.dtype not in cache_types:
        raise ValueError(f"k_all: expected {cache_types}, got {k_all.dtype}")
    scale_types = (torch.bfloat16,) if mode == "dequant" else (torch.bfloat16, torch.float32)
    checks = [("q", q, (torch.float32,), (b, kv, g, d)),
              ("k_all", k_all, cache_types, (L, b, kv, T, d)),
              ("v_all", v_all, (k_all.dtype,), (L, b, kv, T, d)),
              ("bias", bias, (torch.float32,), (b, T))]
    if mode != "plain":
        checks += [("k_scale", k_scale, scale_types, (L, b, kv, T)),
                   ("v_scale", v_scale, (k_scale.dtype,), (L, b, kv, T))]
    if k_new is not None:
        checks += [("k_new", k_new, (torch.float32,), (b, kv, d)),
                   ("v_new", v_new, (torch.float32,), (b, kv, d))]
    for name, t, dtypes, shape in checks:
        if t.device != q.device or t.dtype not in dtypes or tuple(t.shape) != shape:
            raise ValueError(
                f"{name}: expected {dtypes} {shape} on {q.device}, got "
                f"{t.dtype} {tuple(t.shape)} on {t.device}"
            )
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    out = torch.empty((b, kv, g, d), dtype=torch.float32, device=q.device)
    fn = _build.kernel("vt_attend_f32", _F32_ARGTYPES)
    ptr = lambda t: 0 if t is None else t.data_ptr()   # noqa: E731
    codes = f32_codes(k_all, k_scale, mode, g)
    wrapper.launches += 1
    rc = fn(
        q.data_ptr(), k_all.data_ptr(), v_all.data_ptr(), ptr(k_scale), ptr(v_scale),
        bias.data_ptr(), ptr(k_new), ptr(v_new), out.data_ptr(), *codes[:3],
        int(layer) * b * kv, b, kv, g, d, T, int(n_slots),
        _card_splits(codes, b * kv, int(n_slots)), float(sm_scale), _build.stream_ptr(q),
    )
    _build.check(rc, "vt_attend_f32")
    return out


def _on(t: torch.Tensor) -> str:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {t.device}")
    return t.device.type


def decode_attention_float_stacked(
    q: torch.Tensor,          # [b, kv, g, d] f32
    k_all: torch.Tensor,      # [L, b, kv, T, d] bf16 or f32
    v_all: torch.Tensor,
    bias: torch.Tensor,       # [b, T] f32 additive mask
    layer: int,
    k_new: Optional[torch.Tensor] = None,   # [b, kv, d] f32 — current token's k
    v_new: Optional[torch.Tensor] = None,
    *,
    valid_len: Optional[int] = None,   # with k_new: slots at and past it are masked
    sm_scale: float,
) -> torch.Tensor:
    """K1: attention output ``[b, kv, g, d]`` f32 for layer ``layer`` of a
    bf16 or f32 cache, every product in f32."""
    if _on(q) == "cpu":
        return decode_attention_float_plain(q, k_all, v_all, bias, layer, k_new, v_new,
                                            valid_len, sm_scale=sm_scale)
    return _launch_f32(decode_attention_float_stacked, "plain", q, k_all, v_all, bias, layer,
                       None, None, k_new, v_new, _n_slots(k_all.shape[3], k_new, valid_len),
                       sm_scale)


def decode_attention_dequant_stacked(
    q: torch.Tensor,          # [b, kv, g, d] f32
    k_all: torch.Tensor,      # [L, b, kv, T, d] int8
    v_all: torch.Tensor,
    bias: torch.Tensor,       # [b, T] f32 additive mask
    layer: int,
    k_scale: torch.Tensor,    # [L, b, kv, T] bf16
    v_scale: torch.Tensor,
    k_new: Optional[torch.Tensor] = None,
    v_new: Optional[torch.Tensor] = None,
    *,
    valid_len: Optional[int] = None,
    sm_scale: float,
) -> torch.Tensor:
    """K2: the int8 cache dequantized to f32 (no int8 products)."""
    if _on(q) == "cpu":
        return decode_attention_dequant_plain(q, k_all, v_all, bias, layer, k_scale, v_scale,
                                              k_new, v_new, valid_len, sm_scale=sm_scale)
    return _launch_f32(decode_attention_dequant_stacked, "dequant", q, k_all, v_all, bias, layer,
                       k_scale, v_scale, k_new, v_new, _n_slots(k_all.shape[3], k_new, valid_len),
                       sm_scale)


def decode_attention(
    q: torch.Tensor,          # [b, kv, g, d] f32
    k_cache: torch.Tensor,    # [b, kv, T, d] bf16, f32 or int8
    v_cache: torch.Tensor,
    bias: torch.Tensor,       # [b, T] f32 additive mask
    k_scale: Optional[torch.Tensor] = None,   # [b, kv, T] bf16 or f32 (int8 cache)
    v_scale: Optional[torch.Tensor] = None,
    *,
    sm_scale: float,
) -> torch.Tensor:
    """B10: softmax(q·Kᵀ·sm_scale (· ks) + bias)·V (p · vs) per (row, kv
    head) over one unstacked layer → ``[b, kv, g, d]`` f32."""
    if (k_scale is None) != (v_scale is None) or (k_scale is None) == (k_cache.dtype == torch.int8):
        raise ValueError("an int8 cache takes k_scale and v_scale; a float cache takes neither")
    if _on(q) == "cpu":
        return decode_attention_plain_b10(q, k_cache, v_cache, bias, k_scale, v_scale,
                                          sm_scale=sm_scale)
    scales = (None, None) if k_scale is None else (k_scale[None], v_scale[None])
    return _launch_f32(decode_attention, "plain" if k_scale is None else "b10", q, k_cache[None],
                       v_cache[None], bias, 0, *scales, None, None, k_cache.shape[2], sm_scale)


def decode_attention_stacked(
    q: torch.Tensor,          # [b, kv, g, d] f32
    k_all: torch.Tensor,      # [L, b, kv, T, d] bf16/f32, or int8 with scales
    v_all: torch.Tensor,
    bias: torch.Tensor,       # [b, T] f32 additive mask
    layer: int,
    k_scale: Optional[torch.Tensor] = None,   # [L, b, kv, T] bf16 (int8 cache)
    v_scale: Optional[torch.Tensor] = None,
    k_new: Optional[torch.Tensor] = None,     # [b, kv, d] f32 — current token's k
    v_new: Optional[torch.Tensor] = None,
    *,
    valid_len: Optional[int] = None,
    sm_scale: float,
    int8_dots: bool = False,
) -> torch.Tensor:
    """JAX ``decode_attention_stacked``'s branch choice (:601-602, :704-854):
    ``int8_dots`` → B1 where JAX takes a T-blocked branch (the scales,
    ``k_new``, ``valid_len`` and a 128-multiple cache), else B1w (the
    whole-row branch); scales → K2; none → K1."""
    quant = k_scale is not None
    if int8_dots:
        if not quant:
            raise ValueError("int8_dots requires the int8-quantized cache")
        if k_new is not None and valid_len is not None and k_all.shape[3] % TBLK == 0:
            return decode_attention_int8_stacked(q, k_all, v_all, bias, layer, k_scale, v_scale,
                                                 k_new, v_new, valid_len=valid_len,
                                                 sm_scale=sm_scale)
        return decode_attention_int8_whole_stacked(q, k_all, v_all, bias, layer, k_scale,
                                                   v_scale, k_new, v_new, valid_len=valid_len,
                                                   sm_scale=sm_scale)
    if quant:
        return decode_attention_dequant_stacked(q, k_all, v_all, bias, layer, k_scale, v_scale,
                                                k_new, v_new, valid_len=valid_len,
                                                sm_scale=sm_scale)
    return decode_attention_float_stacked(q, k_all, v_all, bias, layer, k_new, v_new,
                                          valid_len=valid_len, sm_scale=sm_scale)


#: launches of each CUDA kernel (the plain versions are not counted)
decode_attention_float_stacked.launches = 0
decode_attention_dequant_stacked.launches = 0
decode_attention.launches = 0

__all__ = ["decode_attention_stacked", "decode_attention_int8_stacked",
           "decode_attention_int8_whole_stacked", "decode_attention_whole_plain",
           "decode_attention_float_stacked", "decode_attention_dequant_stacked",
           "decode_attention", "decode_attention_plain", "decode_attention_float_plain",
           "decode_attention_dequant_plain", "decode_attention_plain_b10", "attend_splits",
           "attend_ranges", "f32_codes", "f32_splits", "resident_clusters", "n_valid_blocks",
           "whole_splits", "whole_ranges", "whole_smem", "card_whole_splits", "TBLK"]
