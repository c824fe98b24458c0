"""The launch plan of the port's one-launch B3 and B4 (``csrc/dense_int8.cu``:
the RMSNorm + int8 qkv product of every decode step's prologue, and the
int8 lm_head and ``DENSE_FNS`` projections), as a pure function of the
shape: the CUDA body runs only on the card (``tests/test_torch_kernels_cuda.py``
and ``chip_smoke.py`` hold it against its plain version and the old chain
there), and what it is told to do is decided here in Python.

``dense_plan`` at the served shapes (T3: [16, 1024] by [1024, 3072] and the
[1024, 1152] head; Qwen3: [8, 2048] by [2048, 4096] and the [2048, 2176]
head; the ``DENSE_FNS`` qkv and o-projections), at b = 1, 2, 8 and 16, on a
card of 132 SMs (the H100): every output column is owned by one cluster,
every K row of a column by one rank of it, the blocks fit one wave of the
card (and, given the card's resident clusters, all clusters stay
resident), and a block's shared bytes and its cluster stay within
Hopper's limits. ``dense_takes`` takes exactly what ``dense_plan`` plans;
the wrappers run the other shapes on the old chain. A numpy emulation of
the plan's split-K int32 parts, met in any order, then the kernel's f32
epilogue, gives the plain versions' bits. B9a (the LayerNorm + int8 qkv of
the XTTS prologue) is the same launch with a LayerNorm: planned at the XTTS
layer (b 1, 8, 16; [1024] x [1024, 3072]) and at phase 3's d_model-128
GPT-2 ([128] x [128, 384], split over clusters of 4), and held by the same
emulation to ``qkv_lnorm_int8_plain``'s bits. The C entries' parameters are
counted against the ctypes argument types their wrappers declare.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from vocalie_tts_tpu_torch.ops import decode_dense as dd
from vocalie_tts_tpu_torch.ops.decode_dense import (
    SLAB,
    SMEM_MAX,
    dense_plan,
    dense_takes,
)

H100_SMS = 132

#: (label, K, N): B3 and B4 at the T3 and Qwen3 decode steps, and B4 on
#: the DENSE_FNS qkv and o-projections at both widths
SERVED = [("b3-t3", 1024, 3072), ("b3-qwen3", 2048, 4096), ("b4-t3-head", 1024, 1152),
          ("b4-qwen3-head", 2048, 2176), ("b4-t3-qkv", 1024, 3072), ("b4-t3-o", 1024, 1024),
          ("b4-qwen3-qkv", 2048, 6144), ("b4-qwen3-o", 2048, 2048)]
BATCHES = [1, 2, 8, 16]


def _served():
    return [(b, K, N) for _, K, N in SERVED for b in BATCHES]


def _owners(plan, N):
    """Per 32-column slab, the K row ranges of the blocks that own it."""
    rows = {s: [] for s in range(N // SLAB)}
    for c0, c1, r0, r1 in plan.blocks(N):
        for s in range(c0 // SLAB, c1 // SLAB):
            rows[s].append((r0, r1))
    return rows


@pytest.mark.parametrize("b,K,N", _served() + [(32, 2048, 6144), (17, 256, 384), (5, 96, 128)])
def test_plan_owns_every_column_once_and_every_row_once_a_column(b, K, N):
    plan = dense_plan(b, K, N, H100_SMS)
    for s, ranges in _owners(plan, N).items():
        got = sorted(ranges)
        assert got[0][0] == 0 and got[-1][1] == K, (s, got)
        assert all(a[1] == c[0] for a, c in zip(got, got[1:])), (s, got)   # no gap, no overlap
        assert all(r1 > r0 for r0, r1 in got), (s, got)
        assert len(got) == plan.ks


@pytest.mark.parametrize("b,K,N", _served())
def test_plan_fits_one_wave_and_the_card(b, K, N):
    plan = dense_plan(b, K, N, H100_SMS)
    assert plan.grid <= H100_SMS and plan.grid % plan.ks == 0
    assert 1 <= plan.ks <= 8 and plan.smem <= SMEM_MAX
    assert plan.kc in (32, 64, 128, 256) and K % plan.kc == 0 and plan.tiles == K // plan.kc
    assert plan.tiles >= 4 * plan.ks or plan.kc == 32
    # slabs too few for the card's SMs take a K split, too many go two a block
    n_slabs = N // SLAB
    assert plan.spb == -(-n_slabs // H100_SMS)
    clusters = -(-n_slabs // plan.spb)
    assert plan.grid == clusters * plan.ks
    assert plan.ks == max(1, min(8, H100_SMS // clusters, K // SLAB))


def test_plans_at_the_main_shapes():
    """The served decode shapes: the T3 head (36 slabs) in clusters of 3, the
    others one slab a block over the whole K (96, 128 and 68 blocks), the
    Qwen3 DENSE_FNS qkv (192 slabs) two slabs a block."""
    want = {(16, 1024, 3072): (96, 1, 1, 256), (8, 2048, 4096): (128, 1, 1, 256),
            (16, 1024, 1152): (108, 3, 1, 64), (8, 2048, 2176): (68, 1, 1, 256),
            (8, 2048, 6144): (96, 1, 2, 256)}
    for shape, (grid, ks, spb, kc) in want.items():
        plan = dense_plan(*shape, H100_SMS)
        assert (plan.grid, plan.ks, plan.spb, plan.kc) == (grid, ks, spb, kc), (shape, plan)


def test_plan_keeps_every_cluster_resident():
    """Where the card keeps fewer clusters of a size resident than the plan
    has, it takes fewer K ranks: the T3 DENSE_FNS o-projection (32 slabs) on a
    card that holds 30 clusters of 4 takes clusters of 3; the resident count
    is asked with each split's shared bytes, and one rank needs no cluster."""
    asked = []

    def resident(ks, smem):
        asked.append((ks, smem))
        return 30 if ks == 4 else H100_SMS // ks

    plan = dense_plan(16, 1024, 1024, H100_SMS, resident=resident)
    assert (plan.ks, plan.grid) == (3, 96)
    assert [ks for ks, _ in asked] == [4, 3]
    assert asked[-1][1] == plan.smem
    plan = dense_plan(16, 1024, 1024, H100_SMS, resident=lambda ks, smem: 0)
    assert (plan.ks, plan.grid) == (1, 32)


@pytest.mark.parametrize("b", [1, 2, 8, 16, 17, 31, 32, 33, 64])
@pytest.mark.parametrize("K,N", [(96, 128), (1024, 1152), (2048, 4096), (2048, 6144),
                                 (4096, 4096), (8192, 1024), (8192, 32768), (200, 384),
                                 (8224, 128), (1024, 100), (1024, 1056)])
def test_takes_exactly_what_it_plans(b, K, N):
    try:
        dense_plan(b, K, N, H100_SMS)
        planned = True
    except ValueError:
        planned = False
    assert dense_takes(b, K, N, H100_SMS) == planned
    assert not dense_takes(b, K, N, None)   # off a card: the plain version


@pytest.mark.parametrize("b,K,N", _served())
def test_every_served_shape_is_taken(b, K, N):
    assert dense_takes(b, K, N, H100_SMS)


@pytest.mark.parametrize("b,K,N,match", [
    (0, 1024, 1152, "rows"), (33, 1024, 1152, "rows"),
    (8, 200, 384, "multiple of 32"), (8, 8224, 128, "multiple of 32"),
    (8, 1024, 100, "N a multiple"),
    (16, 8192, 32768, "shared memory"),   # 8 slabs of 256 KB a block
])
def test_refusals(b, K, N, match):
    with pytest.raises(ValueError, match=match):
        dense_plan(b, K, N, H100_SMS)


def test_the_c_entry_takes_the_wrappers_arguments():
    """``vt_dense_int8_one``'s parameters, counted in its source, are the
    ctypes argument types the wrapper declares."""
    src = (Path(dd.__file__).resolve().parents[1] / "csrc" / "dense_int8.cu").read_text()
    sig = re.search(r'extern "C" int vt_dense_int8_one\(([^)]*)\)', src).group(1)
    assert len(sig.split(",")) == len(dd._DENSE_ONE_ARGTYPES)


def _emulate(plan, q, w, xs, s, order_seed):
    """The kernel's arithmetic on the plan: each block's int32 part over its
    K rows, the parts of a column met in a shuffled order (int32, exact),
    then (float(y) * xs) * s in f32."""
    b, K = q.shape
    N = w.shape[1]
    parts = {}
    for c0, c1, r0, r1 in plan.blocks(N):
        part = q[:, r0:r1].astype(np.int64) @ w[r0:r1, c0:c1].astype(np.int64)
        parts.setdefault((c0, c1), []).append(part.astype(np.int32))
    rng = np.random.default_rng(order_seed)
    y = np.zeros((b, N), np.int32)
    for (c0, c1), ps in parts.items():
        for i in rng.permutation(len(ps)):
            y[:, c0:c1] += ps[i]
    return (y.astype(np.float32) * xs.astype(np.float32)) * s.astype(np.float32)


@pytest.mark.parametrize("b,K,N,sms", [(16, 1024, 1152, 132), (5, 96, 128, 132),
                                       (8, 2048, 2176, 40), (3, 512, 384, 4)])
@pytest.mark.parametrize("norm", [False, True, "ln"], ids=["B4", "B3", "B9a"])
def test_split_k_parts_meet_to_the_plain_bits(b, K, N, sms, norm):
    rng = np.random.default_rng(b * 7 + K + N)
    x = torch.from_numpy(rng.standard_normal((b, K)).astype(np.float32)).to(torch.bfloat16)
    x[b // 2] = 0
    w = torch.from_numpy(rng.integers(-127, 128, (2, K, N), dtype=np.int8))
    s = torch.from_numpy(((rng.random((2, 1, N)) + 0.5) / 127 / np.sqrt(K)).astype(np.float32))
    nw = torch.from_numpy((1 + 0.1 * rng.standard_normal((2, K))).astype(np.float32))
    plan = dense_plan(b, K, N, sms)
    assert plan.ks > 1 or plan.spb > 1
    if norm == "ln":
        nb = torch.from_numpy((0.1 * rng.standard_normal((2, K))).astype(np.float32))
        ref = dd.qkv_lnorm_int8_plain(x, nw, nb, w, s, 1, eps=1e-5)
        q, xs = dd._quantize_rows(dd._ln_rows(x.float(), nw[1], nb[1], 1e-5))
    elif norm:
        ref = dd.qkv_norm_int8_plain(x, nw, w, s, 1, eps=1e-5)
        q, xs = dd._quantize_rows(dd._rms_rows(x.float(), nw[1], 1e-5))
    else:
        ref = dd.dense_int8_plain(x, w, s, 1)
        q, xs = dd._quantize_rows(x.float())
    q8 = q.numpy().astype(np.int8)
    assert np.array_equal(q8, q.numpy())   # the quantized rows are int8
    for seed in range(3):
        got = _emulate(plan, q8, w[1].numpy(), xs.numpy(), s[1].numpy(), seed)
        assert np.array_equal(got, ref.numpy()), np.abs(got - ref.numpy()).max()
    if norm != "ln":   # a zero row LayerNorms to its bias
        assert not ref[b // 2].any()


#: B9a's shapes: the XTTS layer's qkv ([1024] x [1024, 3072]) at the batch-1
#: chunk, the bench request's 8 chunks and 16 rows, and phase 3's
#: d_model-128 GPT-2 ([128] x [128, 384]; chip_smoke.py's 4 rows)
B9A_SHAPES = [(1, 1024, 3072), (8, 1024, 3072), (16, 1024, 3072), (4, 128, 384)]


@pytest.mark.parametrize("b,K,N", B9A_SHAPES)
def test_b9a_plans(b, K, N):
    """B9a takes B3's plan: at the XTTS layer 96 slabs, one a block over the
    whole K in four 256-row tiles (one wave of 96 blocks, no K split); the
    d_model-128 GPT-2's 12 slabs split K over clusters of 4 ranks of one
    32-row tile. Every column is owned once, every K row once a column."""
    plan = dense_plan(b, K, N, H100_SMS)
    assert dense_takes(b, K, N, H100_SMS)
    want = (96, 1, 1, 256, 4) if K == 1024 else (48, 4, 1, 32, 4)
    assert (plan.grid, plan.ks, plan.spb, plan.kc, plan.tiles) == want, plan
    assert plan.grid <= H100_SMS and plan.smem <= SMEM_MAX
    for s, ranges in _owners(plan, N).items():
        got = sorted(ranges)
        assert got[0][0] == 0 and got[-1][1] == K and len(got) == plan.ks, (s, got)
        assert all(a[1] == c[0] for a, c in zip(got, got[1:])), (s, got)


def _c_params(source: str, entry: str) -> int:
    src = (Path(dd.__file__).resolve().parents[1] / "csrc" / source).read_text()
    return len(re.search(r'extern "C" int %s\(([^)]*)\)' % entry, src).group(1).split(","))


@pytest.mark.parametrize("source,entry,argtypes", [
    ("dense_int8.cu", "vt_dense_clusters", "_CLUSTERS_ARGTYPES"),
    ("decode_dense.cu", "vt_qkv_lnorm_int8", "_LNORM_ARGTYPES"),
    ("cache_update.cu", "vt_cache_append", "_ARGTYPES"),
    ("cache_update.cu", "vt_cache_append_kv", "_KV_ARGTYPES"),
    ("tail_gelu.cu", "vt_mlp_gelu_one", "_MLP_GELU_ONE_ARGTYPES"),
    ("decode_attention.cu", "vt_decode_attention_int8_whole_split", "_WHOLE_SPLIT_ARGTYPES"),
])
def test_the_other_c_entries_take_their_wrappers_arguments(source, entry, argtypes):
    """B9a's chain entry, the resident-cluster query (the body's kind among
    its arguments), the appends' entries (B5/K6 and K4/K5), B9d's one launch
    and split B1w's take as many parameters as their wrappers pass."""
    from vocalie_tts_tpu_torch.ops import cache_update as cu
    from vocalie_tts_tpu_torch.ops import decode_attention as da

    module = {"cache_update.cu": cu, "decode_attention.cu": da}.get(source, dd)
    assert _c_params(source, entry) == len(getattr(module, argtypes))
