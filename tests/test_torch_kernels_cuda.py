"""The port's CUDA kernels (B1 int8 decode attention and B1w, its whole-row
branch, B5 KV-cache append, K6, the one-array append with scales, and K5,
the one-array append without scales,
B6 flash attention, the training path's B6 with its logsumexp (B6t) and the
flash-attention backward B11 (B11b dQ, B11a dK/dV), the dense decode kernels B2/B3/B4, the unfused SwiGLU
tail and MLP B8a/B8b and the GPT-2 siblings B9a/B9b/B9c, the whole-step
kernel B7) against their plain PyTorch versions on the GPU, at the edge
shapes the main path does not reach: GQA, head dims other than 64, ragged
and fully masked rows, valid lengths off the 128-slot grid, f32 as well as
bf16, batch 1 and 17, zero rows, the last layer's clamped next-qkv, d_ff in
one and in two tiles, for B1w caches that are not 128-multiples (600, 520,
40, 8) with and without the current token, GQA up to g 8, a fully masked
row and scores past the shared-memory limit (a global workspace), for B9d
(the int8 GELU MLP alone) the XTTS width with f32 and bf16 rows and bf16
biases, and for K5 int8 and bf16 arrays, the Qwen3 layer (d_model 2048, d_ff 8192 in eight
tiles) for B8a/B8b and B6 at d_head 128 with GQA; for B9 bf16 and f32 biases and residuals, a
constant row (LayerNorm to its bias), the XTTS layer and batch 1; for B7 caches of 128 and 640 slots, a fully masked
tail and a fully masked cache, q/k/v biases off, in f32 and in bf16, 1 and
3 layers, the CosyVoice widths over 4 layers with valid lengths on and off
the 128-slot grid (every layer's k/v rows), and a cooperative grid forced
past what the card keeps resident (refused); for B9b's one-launch body
(``csrc/tail_gelu.cu``) the XTTS layer at b 1, 8, 16 and 17 with bf16 and f32
rows and biases, bit-equal to the old chain, one CUDA kernel a call, and a
shape it does not take (33 rows) and B9c on the chain; for B3's and B4's
one launch (``csrc/dense_int8.cu``) the T3 and Qwen3 decode shapes, the
lm_heads and a ``DENSE_FNS`` qkv, b 1, 17 and 32, K 96, a zero row, the
last layer, bf16 and f32 rows and norm weights, bit-equal to the plain
version and to the old chain, one CUDA kernel a call, 50 repeated calls,
and a shape it does not take (33 rows) on the chain; for B9a's one launch
(B3's with the LayerNorm) the XTTS layer and K 128 (split over clusters),
b 1, 3, 8, 17 and 32, bf16 and f32 rows and LayerNorm parameters, layers 0 and
2, a constant row, bit-equal to the plain version and to the old chain, one
CUDA kernel a call, and 33 rows on the chain; for B5 and K6 (the
grid-stride word body with the scales) the T3 and Qwen3 caches, 105 rows
(not a multiple of the block) and 8-byte rows, at the first and the last
slot; for B12 (the whole decode layer, one cooperative launch) the T3
and Qwen3 layers, GQA up to g 8, d_head 32 to 128, batch 1 to 16, a row
with every cached slot masked, the last layer, valid_len on a block
boundary and equal to T, bf16 norms, d_ff in one and several tiles, a grid
past residency and b > 16 (refused); for K1, K2 and B10 (the f32 decode
attention, split over a thread-block cluster) f32, bf16 and int8 caches, g
up to 8, d 16 to 128, a fully masked row, the Qwen3 batch-1 decode (16
blocks a pair), a last block of 2 slots and a cache short enough for one
block; for B1's split over a cluster the T3 and Qwen3 decode shapes at
every split count, scores that rise, fall, or leave a block 60 below the
running max (the p-scale floor), valid lengths on and around 128-slot
boundaries, one CUDA kernel a call and a refused split; for B13 (fused
GroupNorm) C/G of 2, 3, 4, 8, 12 and 32, C not a multiple of 8, the VAE's
large spatial size at eps 1e-6, batch 1, with and without the FiLM row and
SiLU, the four studio shapes on the one-pass route (one CUDA kernel a
call), rows past a cluster's shared memory on the two-pass route and a row
of 16 blocks one an SM holds; and the int8 products of the UNet's convs
(``torch._int_mm``, exact against the CPU).
``chip_smoke.py`` holds the kernels at the main path's shapes.

These tests need an NVIDIA GPU (a CUDA kernel has no CPU mode) and skip
without one. They import neither JAX nor the JAX package, so they run on
a machine that has only PyTorch:

    python -m pytest --noconftest tests/test_torch_kernels_cuda.py -q

Tolerances: B5, K6 and K5 byte-exact. B1 and B1w atol 5e-4 on unit-scale inputs: both
sides re-quantize q and p to int8, and a value on a rounding boundary
may round the other way under another exp/summation order; a p block
of other than 128 slots lands well outside it
(tests/test_torch_decode_attention.py). B6 in f32
atol 1e-4 (f32 throughout, only the summation order differs); in bf16
|diff| <= 1e-2 + 1e-2·|ref| (bf16 output, one step is 2^-8 of the
value; p rounds to bf16 against a running max in the kernel, the row
max in the plain version). B2/B3/B4 within 1e-5 · max|ref|: the kernels
repeat their plain versions' rounding step for step (exact int32 products,
the variance summed in double, IEEE divides, the same f32 epilogue order),
so an output moves only if an int8 activation sits on a .5 tie that
another expf reaches from the other side; such a flip moves it by ~1e-3.
B8a/B8b and B9a-d likewise (the LayerNorm's moments in double, the tanh-GELU as the
same IEEE steps with ``tanhf``, which PyTorch's CUDA tanh also calls).
B7 and B12 within 1e-5 · max|ref| on each output, for the same reason: the
plain version takes the kernel's steps (the softmax sums, the variance and
the current token's score in float64, rounded once). B13 within one bf16 ulp of
the plain value plus 1e-5: the f32 moments are summed in another order and
the kernel's SiLU takes the card's fast exp and reciprocal (a few f32 ulps),
and both round the f32 result to bf16 once.
"""

import dataclasses
import math

import pytest
import torch

from vocalie_tts_tpu_torch.ops import _build
from vocalie_tts_tpu_torch.ops.cache_update import (
    _KV_ARGTYPES,
    append_word,
    cache_append_k_plain,
    cache_append_k_scales_plain,
    cache_append_k_scales_stacked,
    cache_append_k_stacked,
    cache_append_kv_plain,
    cache_append_kv_stacked,
    cache_append_plain,
    cache_append_stacked,
)
from vocalie_tts_tpu_torch.ops.decode_attention import (
    decode_attention,
    decode_attention_dequant_plain,
    decode_attention_dequant_stacked,
    decode_attention_float_plain,
    decode_attention_float_stacked,
    decode_attention_int8_stacked,
    decode_attention_int8_whole_stacked,
    decode_attention_plain,
    decode_attention_plain_b10,
    decode_attention_whole_plain,
)
from vocalie_tts_tpu_torch.ops.decode_dense import (
    TILE_BUDGET,
    _tail_gelu,
    card_sms,
    dense_int8_plain,
    dense_takes,
    gelu_takes,
    pick_tile,
    dense_int8_stacked,
    mlp_gelu_int8_plain,
    mlp_gelu_int8_stacked,
    qkv_lnorm_int8_plain,
    qkv_lnorm_int8_stacked,
    qkv_norm_int8_plain,
    qkv_norm_int8_stacked,
    tail_gelu_int8_plain,
    tail_gelu_int8_stacked,
    tail_gelu_qkv_int8_plain,
    tail_gelu_qkv_int8_stacked,
    mlp_swiglu_int8_plain,
    mlp_swiglu_int8_stacked,
    tail_swiglu_int8_plain,
    tail_swiglu_int8_stacked,
    tail_swiglu_qkv_int8_plain,
    tail_swiglu_qkv_int8_stacked,
)
from vocalie_tts_tpu_torch.ops.decode_layer import (
    layer_swiglu_qkv_int8_plain,
    layer_swiglu_qkv_int8_stacked,
)
from vocalie_tts_tpu_torch.ops.decode_layer import max_resident_blocks as b12_max_blocks
from vocalie_tts_tpu_torch.ops.decode_step import (
    decode_step_fused_packed,
    decode_step_fused_plain,
    max_resident_blocks,
)
from vocalie_tts_tpu_torch.ops.flash_attention import attention_plain, flash_attention

pytestmark = pytest.mark.device

NEG = -0.7 * float(torch.finfo(torch.float32).max)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _gen(dev, seed):
    return torch.Generator(device=dev).manual_seed(seed)


# ── B1 ──────────────────────────────────────────────────────────────────


@pytest.mark.parametrize("L,b,kv,g,T,d,prompt_pad,n_dec,layer", [
    (2, 3, 2, 1, 512, 64, 256, 44, 1),     # valid_len 300, off the 128 grid
    (1, 2, 2, 2, 256, 64, 100, 28, 0),     # GQA, valid_len exactly 128
    (2, 2, 2, 4, 384, 16, 200, 57, 1),     # d 16, valid_len 257
    (1, 4, 1, 8, 128, 128, 3, 2, 0),       # d 128, g 8, valid_len 5
    (1, 2, 2, 1, 256, 32, 200, 56, 0),     # valid_len == T: every block read
])
def test_decode_attention_kernel(dev, L, b, kv, g, T, d, prompt_pad, n_dec, layer):
    gen = _gen(dev, T + d + g)
    q = torch.randn((b, kv, g, d), generator=gen, device=dev)
    k, v = (torch.randint(-127, 128, (L, b, kv, T, d), generator=gen, device=dev,
                          dtype=torch.int8) for _ in range(2))
    ks, vs = (((torch.rand((L, b, kv, T), generator=gen, device=dev) + 0.5) / 127)
              .to(torch.bfloat16) for _ in range(2))
    kn, vn = (torch.randn((b, kv, d), generator=gen, device=dev) for _ in range(2))
    lens = torch.randint(1, prompt_pad + 1, (b,), generator=gen, device=dev)
    pos = torch.arange(T, device=dev)[None, :]
    valid_len = prompt_pad + n_dec
    valid = (pos < lens[:, None]) | ((pos >= prompt_pad) & (pos < valid_len))
    bias = torch.where(valid, 0.0, NEG).float()
    sm = 1.0 / math.sqrt(d)
    before = decode_attention_int8_stacked.launches
    out = decode_attention_int8_stacked(q, k, v, bias, layer, ks, vs, kn, vn,
                                   valid_len=valid_len, sm_scale=sm)
    ref = decode_attention_plain(q, k, v, bias, layer, ks, vs, kn, vn, valid_len, sm)
    torch.cuda.synchronize()
    assert decode_attention_int8_stacked.launches == before + 1
    assert torch.allclose(out, ref, atol=5e-4, rtol=0), (out - ref).abs().max().item()


def test_decode_attention_kernel_rejects_bad_inputs(dev):
    L, b, kv, g, T, d = 1, 2, 2, 1, 128, 64
    q = torch.zeros((b, kv, g, d), device=dev)
    k = torch.zeros((L, b, kv, T, d), dtype=torch.int8, device=dev)
    s = torch.ones((L, b, kv, T), dtype=torch.bfloat16, device=dev)
    bias = torch.zeros((b, T), device=dev)
    kn = torch.zeros((b, kv, d), device=dev)
    args = dict(valid_len=4, sm_scale=0.125)
    with pytest.raises(ValueError, match="k_scale"):
        decode_attention_int8_stacked(q, k, k, bias, 0, s.float(), s, kn, kn, **args)
    with pytest.raises(ValueError, match="contiguous"):
        decode_attention_int8_stacked(q, k, k, torch.zeros((T, b), device=dev).t(), 0, s, s, kn,
                                      kn, **args)
    with pytest.raises(ValueError, match="layer"):
        decode_attention_int8_stacked(q, k, k, bias, 1, s, s, kn, kn, **args)
    off = torch.zeros((b * kv * g * d + 1,), device=dev)[1:].view(b, kv, g, d)
    with pytest.raises(ValueError, match="16-byte aligned"):   # q is read 16 bytes at a time
        decode_attention_int8_stacked(off, k, k, bias, 0, s, s, kn, kn, **args)


def _b1_inputs(dev, seed, L, b, kv, g, T, d, valid_len, bias_fn=None):
    """B1's inputs: unit-scale q and current token, int8 k/v, bf16 scales
    near 1/127; the bias 0 on the first ``valid_len`` slots and masked past
    them, or ``bias_fn(pos)`` there (the adversarial score profiles)."""
    gen = _gen(dev, seed)
    q = torch.randn((b, kv, g, d), generator=gen, device=dev)
    k, v = (torch.randint(-127, 128, (L, b, kv, T, d), generator=gen, device=dev,
                          dtype=torch.int8) for _ in range(2))
    ks, vs = (((torch.rand((L, b, kv, T), generator=gen, device=dev) + 0.5) / 127)
              .to(torch.bfloat16) for _ in range(2))
    kn, vn = (torch.randn((b, kv, d), generator=gen, device=dev) for _ in range(2))
    pos = torch.arange(T, device=dev, dtype=torch.float32)[None, :].expand(b, T)
    live = bias_fn(pos) if bias_fn is not None else torch.zeros_like(pos)
    bias = torch.where(pos < valid_len, live, torch.full_like(pos, NEG)).contiguous()
    return q, k, v, bias, ks, vs, kn, vn


def _b1_check(dev, args, layer, valid_len, d, splits=None):
    q, k, v, bias, ks, vs, kn, vn = args
    sm = 1.0 / math.sqrt(d)
    before = decode_attention_int8_stacked.launches
    out = decode_attention_int8_stacked(q, k, v, bias, layer, ks, vs, kn, vn,
                                        valid_len=valid_len, sm_scale=sm, splits=splits)
    ref = decode_attention_plain(q, k, v, bias, layer, ks, vs, kn, vn, valid_len, sm)
    torch.cuda.synchronize()
    assert decode_attention_int8_stacked.launches == before + 1
    err = (out - ref).abs().max().item()
    print(f"B1 valid_len {valid_len} splits {splits}: max |diff| {err:.3e}")
    assert torch.allclose(out, ref, atol=5e-4, rtol=0), err


#: the main path's two B1 shapes (chip_smoke.py T3_ATTN, QWEN3_ATTN; fewer
#: layers): (b, kv, g, d, T, valid_len)
B1_MAIN = {"t3": (16, 16, 1, 64, 640, 416), "qwen3": (8, 8, 2, 128, 512, 352)}


@pytest.mark.parametrize("shape,splits", [(shape, s) for shape, n_blk in (("t3", 4), ("qwen3", 3))
                                          for s in [None, *range(1, n_blk + 1)]])
def test_decode_attention_kernel_at_the_main_shapes(dev, shape, splits):
    """B1 at the T3 and Qwen3 decode shapes with the planned split and with
    every split count the valid blocks allow (a rank of one block up to one
    rank of every block)."""
    b, kv, g, d, T, valid_len = B1_MAIN[shape]
    _b1_check(dev, _b1_inputs(dev, 5, 3, b, kv, g, T, d, valid_len), 2, valid_len, d, splits)


#: score profiles the sequential chain must meet block by block: scores that
#: rise over the cache (every block's running max below the final one), a
#: block 60 below the running max (its p under 1e-26, so ps takes its 1e-20
#: floor and the block's p8 are 0), the same block first (its own max), and
#: scores that fall (the first block holds the max)
B1_PROFILES = {
    "rising": lambda pos: 0.02 * pos,
    "one_block_60_below": lambda pos: torch.where((pos >= 128) & (pos < 256), -60.0, 0.0),
    "first_block_60_below": lambda pos: torch.where(pos < 128, -60.0, 0.0),
    "falling": lambda pos: -0.02 * pos,
}


@pytest.mark.parametrize("splits", [None, 1, 2])
@pytest.mark.parametrize("profile", list(B1_PROFILES))
@pytest.mark.parametrize("g,d", [(1, 64), (2, 128)])
def test_decode_attention_kernel_meets_the_chain(dev, g, d, profile, splits):
    """Scores built so that a block quantizing p against any max but the
    chain's running m_j lands outside the gate, over four 128-slot blocks,
    split 1, 2 (two blocks a rank) and as planned (a block a rank)."""
    T, valid_len = 512, 500
    args = _b1_inputs(dev, 9 + g, 2, 2, 2, g, T, d, valid_len, B1_PROFILES[profile])
    _b1_check(dev, args, 1, valid_len, d, splits)


@pytest.mark.parametrize("valid_len", [1, 127, 128, 129, 383, 384, 640])
@pytest.mark.parametrize("g,d", [(1, 64), (2, 128)])
def test_decode_attention_kernel_at_block_edges(dev, g, d, valid_len):
    """valid_len on, just below and just past a 128-slot boundary, a single
    valid block (1, 127, 128) and the cache's end (640)."""
    T = 640
    _b1_check(dev, _b1_inputs(dev, valid_len + g, 2, 3, 2, g, T, d, valid_len), 0, valid_len, d)


@pytest.mark.parametrize("shape", list(B1_MAIN))
def test_decode_attention_kernel_is_one_cuda_kernel_a_call(dev, shape):
    """torch.profiler sees one CUDA kernel for a B1 call at the main shapes
    (counted through ``_profiled_kernels``: the profiler once saw no kernel
    at all for the Qwen3 case), and the planned split spreads the Qwen3
    shape's 64 (row, kv head) pairs over more than one block each."""
    b, kv, g, d, T, valid_len = B1_MAIN[shape]
    q, k, v, bias, ks, vs, kn, vn = _b1_inputs(dev, 3, 2, b, kv, g, T, d, valid_len)
    names = _profiled_kernels(lambda: decode_attention_int8_stacked(
        q, k, v, bias, 1, ks, vs, kn, vn, valid_len=valid_len, sm_scale=0.125))
    assert len(names) == 1 and "attend_int8_tblk_kernel" in names[0], names
    if shape == "qwen3":
        from vocalie_tts_tpu_torch.ops.decode_attention import card_int8_splits

        assert card_int8_splits(b * kv, -(-valid_len // 128), g, d) > 1


def test_decode_attention_kernel_refuses_a_bad_split(dev):
    b, kv, g, d, T, valid_len = 2, 2, 1, 64, 384, 300
    args = _b1_inputs(dev, 1, 1, b, kv, g, T, d, valid_len)
    for splits in (0, 4, 17):
        with pytest.raises(ValueError, match="splits"):
            _b1_check(dev, args, 0, valid_len, d, splits)


# ── B1w ─────────────────────────────────────────────────────────────────


#: B1w's cases: (L, b, kv, g, T, d, prompt_pad, n_dec, layer, with_new, masked_row)
B1W_CASES = {
    "t3": (30, 16, 16, 1, 600, 64, 512, 50, 7, True, False),     # the T3 at cache_len 600
    "qwen3": (28, 8, 8, 2, 520, 128, 256, 96, 27, True, False),  # the Qwen3 shape, last layer
    "t3_no_new": (30, 16, 16, 1, 600, 64, 512, 50, 7, False, False),   # all 600 slots read
    "short_masked": (2, 3, 2, 4, 40, 16, 24, 9, 1, True, True),  # a short cache, a masked prompt
    "t8_g8": (1, 2, 1, 8, 8, 32, 4, 3, 0, True, False),          # T 8, g 8
    "t8_g8_masked": (1, 2, 1, 8, 8, 32, 4, 3, 0, True, True),    # ... and a masked row
    "no_new": (2, 2, 2, 1, 256, 64, 100, 20, 1, False, True),    # no current token: all T read
    "valid_len_1": (2, 4, 2, 2, 200, 64, 1, 0, 1, True, False),  # one slot read
    "mid_block": (2, 4, 4, 4, 1000, 128, 700, 33, 0, True, False),   # ranges end off 128
    "t7000_g8": (1, 1, 1, 8, 7000, 64, 6000, 900, 0, True, False),   # 5 ranks at least
    # 16 ranks of 1,250 slots take 205 KB each: past the shared memory, the
    # one-block body (its scores in a global workspace)
    "t20000_g8": (1, 1, 1, 8, 20000, 128, 19000, 900, 0, True, False),
}


def _b1w_inputs(dev, L, b, kv, g, T, d, prompt_pad, n_dec, layer, with_new, masked_row):
    gen = _gen(dev, T + d + g)
    q = torch.randn((b, kv, g, d), generator=gen, device=dev)
    k, v = (torch.randint(-127, 128, (L, b, kv, T, d), generator=gen, device=dev,
                          dtype=torch.int8) for _ in range(2))
    ks, vs = (((torch.rand((L, b, kv, T), generator=gen, device=dev) + 0.5) / 127)
              .to(torch.bfloat16) for _ in range(2))
    kn, vn = (torch.randn((b, kv, d), generator=gen, device=dev) for _ in range(2))
    lens = torch.randint(1, prompt_pad + 1, (b,), generator=gen, device=dev)
    pos = torch.arange(T, device=dev)[None, :]
    valid_len = prompt_pad + n_dec
    valid = (pos < lens[:, None]) | ((pos >= prompt_pad) & (pos < valid_len))
    if masked_row:
        valid[-1] = False
    bias = torch.where(valid, 0.0, NEG).float()
    new = (kn, vn) if with_new else (None, None)
    vl = valid_len if with_new else None
    args = (q, k, v, bias, layer, ks, vs, *new)
    return args, dict(valid_len=vl, sm_scale=1.0 / math.sqrt(d))


def _b1w_slots(case) -> int:
    L, b, kv, g, T, d, prompt_pad, n_dec, layer, with_new, masked_row = B1W_CASES[case]
    return min(max(prompt_pad + n_dec, 1), T) if with_new else T


@pytest.mark.parametrize("case", list(B1W_CASES))
def test_decode_attention_whole_kernel(dev, case):
    """B1w against its plain version at its planned split (the cluster
    body, counted in ``cluster_launches``) or, for a row past 16 blocks'
    shared memory, on the one-block body; and the one-block body
    (``one_block=True``) on the same inputs."""
    from vocalie_tts_tpu_torch.ops.decode_attention import card_whole_splits

    L, b, kv, g, T, d = B1W_CASES[case][:6]
    args, kw = _b1w_inputs(dev, *B1W_CASES[case])
    split = card_whole_splits(b * kv, _b1w_slots(case), g, d)
    assert (split is None) == (case == "t20000_g8"), split
    fn = decode_attention_int8_whole_stacked
    before = (fn.launches, fn.cluster_launches)
    out = fn(*args, **kw)
    one = fn(*args, **kw, one_block=True)
    ref = decode_attention_whole_plain(*args, kw["valid_len"], sm_scale=kw["sm_scale"])
    torch.cuda.synchronize()
    assert (fn.launches, fn.cluster_launches) == (before[0] + 2,
                                                  before[1] + (split is not None))
    assert torch.isfinite(out).all() and torch.isfinite(one).all()
    assert torch.allclose(out, ref, atol=5e-4, rtol=0), (out - ref).abs().max().item()
    assert torch.allclose(one, ref, atol=5e-4, rtol=0), (one - ref).abs().max().item()


@pytest.mark.parametrize("case", ["t3", "qwen3", "t3_no_new"])
def test_decode_attention_whole_every_split(dev, case):
    """The cluster body at every split count the wrapper takes, 1 to 16 (past
    the planner's top: 5 at T3, 3 at Qwen3), each within B1's 5e-4 of the
    plain version; a split of 0 or past 16 is refused."""
    from vocalie_tts_tpu_torch.ops.decode_attention import (
        WHOLE_MIN_SLOTS,
        WHOLE_SPLIT_MAX,
        card_whole_splits,
    )

    L, b, kv, g, T, d = B1W_CASES[case][:6]
    args, kw = _b1w_inputs(dev, *B1W_CASES[case])
    ref = decode_attention_whole_plain(*args, kw["valid_len"], sm_scale=kw["sm_scale"])
    n = _b1w_slots(case)
    assert card_whole_splits(b * kv, n, g, d) <= max(1, n // WHOLE_MIN_SLOTS)
    top = WHOLE_SPLIT_MAX
    errs = {}
    for splits in range(1, top + 1):
        out = decode_attention_int8_whole_stacked(*args, **kw, splits=splits)
        errs[splits] = (out - ref).abs().max().item()
    assert all(e <= 5e-4 for e in errs.values()), errs
    for splits in (0, top + 1):
        with pytest.raises(ValueError, match="splits"):
            decode_attention_int8_whole_stacked(*args, **kw, splits=splits)


@pytest.mark.parametrize("case", ["t3", "t3_no_new", "qwen3"])
def test_decode_attention_whole_is_one_cuda_kernel_a_call(dev, case):
    """torch.profiler sees one CUDA kernel, the cluster body, for a B1w call
    at the T3 shape with and without the current token and at the Qwen3
    shape; its stamps record every phase point of every block in order."""
    from vocalie_tts_tpu_torch.ops.decode_attention import WHOLE_STAMPS, card_whole_splits

    L, b, kv, g, T, d = B1W_CASES[case][:6]
    args, kw = _b1w_inputs(dev, *B1W_CASES[case])
    names = _profiled_kernels(lambda: decode_attention_int8_whole_stacked(*args, **kw))
    assert len(names) == 1 and "attend_int8_whole_kernel" in names[0], names
    splits = card_whole_splits(b * kv, _b1w_slots(case), g, d)
    stamps = torch.zeros((b * kv * splits, WHOLE_STAMPS), dtype=torch.int64, device=dev)
    decode_attention_int8_whole_stacked(*args, **kw, stamps=stamps)
    torch.cuda.synchronize()
    t = stamps.cpu()
    assert (t > 0).all() and (t[:, 1:] >= t[:, :-1]).all()


def test_decode_attention_whole_kernel_rejects_bad_inputs(dev):
    L, b, kv, g, T, d = 1, 2, 2, 1, 200, 64
    q = torch.zeros((b, kv, g, d), device=dev)
    k = torch.zeros((L, b, kv, T, d), dtype=torch.int8, device=dev)
    s = torch.ones((L, b, kv, T), dtype=torch.bfloat16, device=dev)
    bias = torch.zeros((b, T), device=dev)
    kn = torch.zeros((b, kv, d), device=dev)
    args = dict(valid_len=4, sm_scale=0.125)
    with pytest.raises(ValueError, match="v_scale"):
        decode_attention_int8_whole_stacked(q, k, k, bias, 0, s, s.float(), kn, kn, **args)
    with pytest.raises(ValueError, match="together"):
        decode_attention_int8_whole_stacked(q, k, k, bias, 0, s, s, kn, None, **args)
    with pytest.raises(ValueError, match="g <= 8"):
        decode_attention_int8_whole_stacked(q[..., :24].contiguous(), k[..., :24].contiguous(),
                                            k[..., :24].contiguous(), bias, 0, s, s,
                                            kn[..., :24].contiguous(), kn[..., :24].contiguous(),
                                            **args)


# ── B5 ──────────────────────────────────────────────────────────────────


@pytest.mark.parametrize("L,b,kv,T,d,pos", [
    (30, 16, 16, 640, 64, 416),
    (2, 3, 2, 256, 16, 0),
    (1, 1, 1, 128, 128, 127),
])
def test_cache_append_kernel_is_byte_exact(dev, L, b, kv, T, d, pos):
    gen = _gen(dev, pos + d)
    k, v = (torch.randint(-127, 128, (L, b, kv, T, d), generator=gen, device=dev,
                          dtype=torch.int8) for _ in range(2))
    ks, vs = (torch.rand((L, b, kv, T), generator=gen, device=dev).to(torch.bfloat16)
              for _ in range(2))
    kn, vn = (torch.randint(-127, 128, (L, b, kv, d), generator=gen, device=dev,
                            dtype=torch.int8) for _ in range(2))
    ksn, vsn = (torch.rand((L, b, kv), generator=gen, device=dev).to(torch.bfloat16)
                for _ in range(2))
    got = cache_append_stacked(k.clone(), v.clone(), ks.clone(), vs.clone(),
                               kn, vn, ksn, vsn, pos)
    ref = cache_append_plain(k.clone(), v.clone(), ks.clone(), vs.clone(), kn, vn, ksn, vsn, pos)
    torch.cuda.synchronize()
    for a, r in zip(got, ref):
        bits = torch.uint8 if a.dtype == torch.int8 else torch.int16
        assert torch.equal(a.view(bits), r.view(bits))


@pytest.mark.parametrize("one_array", [False, True], ids=["B5", "K6"])
@pytest.mark.parametrize("pos_at", ["first", "last"])
@pytest.mark.parametrize("L,b,kv,T,d", [
    (30, 16, 16, 640, 64),   # the T3 cache: 16-byte words, 4 a row
    (28, 8, 8, 512, 128),    # the Qwen3 cache: 8 a row
    (3, 5, 7, 24, 64),       # 105 rows, 420 words: not a multiple of the 256-thread block
    (2, 3, 1, 16, 8),        # 8-byte rows: 4-byte words
])
def test_cache_append_scales_words_are_byte_exact(dev, L, b, kv, T, d, pos_at, one_array):
    """B5 (k and v) and K6 (one array, JAX's ``cache_append_kv_stacked(k,
    None, kn, None, pos, ks, vs, ksn, vsn)``) in the grid-stride body's
    words, each row's scales written with its word 0, at the first and the
    last slot: byte for byte against the plain versions, one launch counted
    on each entry."""
    pos = 0 if pos_at == "first" else T - 1
    gen = _gen(dev, L + b + kv + T + d + pos)
    k, v = (torch.randint(-127, 128, (L, b, kv, T, d), generator=gen, device=dev,
                          dtype=torch.int8) for _ in range(2))
    ks, vs = (torch.rand((L, b, kv, T), generator=gen, device=dev).to(torch.bfloat16)
              for _ in range(2))
    kn, vn = (torch.randint(-127, 128, (L, b, kv, d), generator=gen, device=dev,
                            dtype=torch.int8) for _ in range(2))
    ksn, vsn = (torch.rand((L, b, kv), generator=gen, device=dev).to(torch.bfloat16)
                for _ in range(2))
    assert append_word(d, k.data_ptr(), v.data_ptr(), kn.data_ptr(), vn.data_ptr()) == (
        4 if d == 8 else 16)
    before = cache_append_stacked.launches, cache_append_k_scales_stacked.launches
    if one_array:
        got = cache_append_kv_stacked(k.clone(), None, kn, None, pos, ks.clone(), vs.clone(),
                                      ksn, vsn)
        ref = cache_append_k_scales_plain(k.clone(), ks.clone(), vs.clone(), kn, ksn, vsn, pos)
    else:
        got = cache_append_kv_stacked(k.clone(), v.clone(), kn, vn, pos, ks.clone(), vs.clone(),
                                      ksn, vsn)
        ref = cache_append_plain(k.clone(), v.clone(), ks.clone(), vs.clone(), kn, vn, ksn, vsn,
                                 pos)
    torch.cuda.synchronize()
    assert (cache_append_stacked.launches, cache_append_k_scales_stacked.launches) == (
        before[0] + (not one_array), before[1] + one_array)
    assert len(got) == len(ref)
    for a, r in zip(got, ref):
        bits = torch.uint8 if a.dtype == torch.int8 else torch.int16
        assert torch.equal(a.view(bits), r.view(bits))


# ── K1, K2, B10: the f32 decode attention; K4: the append without scales ──


def _f32_attn_inputs(dev, L, b, kv, g, T, d, prompt_pad, n_dec, cache, seed, masked_row=False):
    gen = _gen(dev, seed)
    q = torch.randn((b, kv, g, d), generator=gen, device=dev)
    if cache == torch.int8:
        k, v = (torch.randint(-127, 128, (L, b, kv, T, d), generator=gen, device=dev,
                              dtype=torch.int8) for _ in range(2))
        ks, vs = (((torch.rand((L, b, kv, T), generator=gen, device=dev) + 0.5) / 127)
                  .to(torch.bfloat16) for _ in range(2))
    else:
        k, v = (torch.randn((L, b, kv, T, d), generator=gen, device=dev).to(cache)
                for _ in range(2))
        ks = vs = None
    kn, vn = (torch.randn((b, kv, d), generator=gen, device=dev) for _ in range(2))
    lens = torch.randint(1, prompt_pad + 1, (b,), generator=gen, device=dev)
    pos = torch.arange(T, device=dev)[None, :]
    valid = (pos < lens[:, None]) | ((pos >= prompt_pad) & (pos < prompt_pad + n_dec))
    if masked_row:
        valid[0] = False
    bias = torch.where(valid, 0.0, NEG).float()
    return q, k, v, ks, vs, bias, kn, vn


@pytest.mark.parametrize("cache", [torch.bfloat16, torch.float32, torch.int8],
                         ids=["bf16", "f32", "int8"])
@pytest.mark.parametrize("L,b,kv,g,T,d,prompt_pad,n_dec,layer,with_new,masked_row", [
    (30, 16, 16, 1, 640, 64, 256, 160, 7, True, False),    # the T3 layer
    (2, 8, 8, 2, 512, 128, 256, 96, 1, True, False),       # the Qwen3 layer, GQA
    (2, 3, 2, 8, 200, 16, 100, 37, 0, True, True),         # g 8, d 16, T off the grid
    (1, 1, 4, 1, 640, 64, 300, 83, 0, True, False),        # batch 1
    (1, 2, 2, 4, 256, 32, 200, 56, 0, True, False),        # valid_len == T
    (2, 2, 2, 2, 300, 64, 150, 20, 1, False, True),        # no current token: every slot
    (1, 1, 8, 2, 512, 128, 256, 96, 0, True, False),       # Qwen3 batch 1: 16 blocks a pair
    (1, 1, 2, 1, 320, 64, 200, 57, 0, True, False),        # 257 slots in 16: the last block 2
    (1, 2, 2, 1, 128, 64, 10, 10, 0, True, True),          # 20 slots: one block (splits 1)
])
def test_f32_decode_attention_kernels(dev, cache, L, b, kv, g, T, d, prompt_pad, n_dec, layer,
                                      with_new, masked_row):
    """K1 (bf16/f32 cache) and K2 (int8 + scales) against their plain
    versions, atol 1e-4 (f32 throughout; the kernel's running max and
    summation order differ from the two-pass plain version)."""
    q, k, v, ks, vs, bias, kn, vn = _f32_attn_inputs(dev, L, b, kv, g, T, d, prompt_pad, n_dec,
                                                     cache, T + d + g, masked_row)
    kn, vn = (kn, vn) if with_new else (None, None)
    valid_len = prompt_pad + n_dec
    sm = 1.0 / math.sqrt(d)
    if cache == torch.int8:
        fn = decode_attention_dequant_stacked
        before = fn.launches
        out = fn(q, k, v, bias, layer, ks, vs, kn, vn, valid_len=valid_len, sm_scale=sm)
        ref = decode_attention_dequant_plain(q, k, v, bias, layer, ks, vs, kn, vn, valid_len,
                                             sm_scale=sm)
    else:
        fn = decode_attention_float_stacked
        before = fn.launches
        out = fn(q, k, v, bias, layer, kn, vn, valid_len=valid_len, sm_scale=sm)
        ref = decode_attention_float_plain(q, k, v, bias, layer, kn, vn, valid_len, sm_scale=sm)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    assert torch.allclose(out, ref, atol=1e-4, rtol=0), (out - ref).abs().max().item()


@pytest.mark.parametrize("cache,scale", [(torch.bfloat16, None), (torch.float32, None),
                                         (torch.int8, torch.bfloat16),
                                         (torch.int8, torch.float32)],
                         ids=["bf16", "f32", "int8-bf16-scales", "int8-f32-scales"])
@pytest.mark.parametrize("b,kv,g,T,d,masked_row", [(16, 16, 1, 640, 64, False),
                                                   (2, 2, 2, 320, 128, True),
                                                   (1, 3, 8, 130, 16, False),
                                                   (1, 8, 2, 512, 128, False),
                                                   (2, 1, 1, 24, 16, True)])
def test_b10_decode_attention_kernel(dev, cache, scale, b, kv, g, T, d, masked_row):
    q, k, v, ks, vs, bias, _, _ = _f32_attn_inputs(dev, 1, b, kv, g, T, d, T // 2, T // 4,
                                                   cache, T + g, masked_row)
    k, v = k[0], v[0]
    if ks is not None:
        ks, vs = ks[0].to(scale), vs[0].to(scale)
    before = decode_attention.launches
    out = decode_attention(q, k, v, bias, ks, vs, sm_scale=d ** -0.5)
    ref = decode_attention_plain_b10(q, k, v, bias, ks, vs, sm_scale=d ** -0.5)
    torch.cuda.synchronize()
    assert decode_attention.launches == before + 1
    assert torch.allclose(out, ref, atol=1e-4, rtol=0), (out - ref).abs().max().item()


def test_f32_decode_attention_rejects_bad_inputs(dev):
    """Refused inputs raise before the launch, and a refused call is not
    counted as one."""
    q, k, v, ks, vs, bias, kn, vn = _f32_attn_inputs(dev, 1, 2, 2, 1, 128, 64, 64, 8,
                                                     torch.bfloat16, 1)
    wrappers = (decode_attention_float_stacked, decode_attention_dequant_stacked,
                decode_attention)
    before = [w.launches for w in wrappers]
    with pytest.raises(ValueError, match="k_all"):
        decode_attention_float_stacked(q, k.to(torch.float16), v, bias, 0, kn, vn, sm_scale=0.1)
    with pytest.raises(ValueError, match="v_all"):
        decode_attention_float_stacked(q, k, v.float(), bias, 0, kn, vn, sm_scale=0.1)
    with pytest.raises(ValueError, match="layer"):
        decode_attention_float_stacked(q, k, v, bias, 1, kn, vn, sm_scale=0.1)
    with pytest.raises(ValueError, match="scale"):
        decode_attention(q, k[0].to(torch.int8), v[0].to(torch.int8), bias, sm_scale=0.1)
    sc = torch.ones((1, 2, 2, 128), device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="k_scale"):
        decode_attention_dequant_stacked(q, k.to(torch.int8), v.to(torch.int8), bias, 0,
                                         sc[..., :64].contiguous(), sc, kn, vn, sm_scale=0.1)
    with pytest.raises(ValueError, match="k_all"):
        decode_attention(q, k[0].to(torch.float16), v[0].to(torch.float16), bias, sm_scale=0.1)
    assert [w.launches for w in wrappers] == before


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("L,b,kv,T,d,pos", [
    (30, 16, 16, 640, 64, 416),
    (2, 3, 2, 256, 16, 0),
    (1, 1, 1, 128, 128, 127),
    (2, 1, 3, 136, 8, 70),
])
def test_cache_append_kv_kernel_is_byte_exact(dev, dtype, L, b, kv, T, d, pos):
    gen = _gen(dev, pos + d)
    k, v = (torch.randn((L, b, kv, T, d), generator=gen, device=dev).to(dtype)
            for _ in range(2))
    kn, vn = (torch.randn((L, b, kv, d), generator=gen, device=dev).to(dtype) for _ in range(2))
    before = cache_append_kv_stacked.launches
    got = cache_append_kv_stacked(k.clone(), v.clone(), kn, vn, pos)
    ref = cache_append_kv_plain(k.clone(), v.clone(), kn, vn, pos)
    torch.cuda.synchronize()
    assert cache_append_kv_stacked.launches == before + 1
    bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
    for a, r in zip(got, ref):
        assert torch.equal(a.view(bits), r.view(bits))


def test_cache_append_kv_rejects_bad_inputs(dev):
    k = torch.zeros((1, 1, 1, 128, 16), device=dev, dtype=torch.bfloat16)
    kn = torch.zeros((1, 1, 1, 16), device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="bf16 or f32"):
        cache_append_kv_stacked(k.to(torch.int8), k.to(torch.int8), kn.to(torch.int8),
                                kn.to(torch.int8), 3)
    with pytest.raises(ValueError, match="k_new"):
        cache_append_kv_stacked(k, k.clone(), kn.float(), kn, 3)
    with pytest.raises(ValueError, match="position"):
        cache_append_kv_stacked(k, k.clone(), kn, kn, 128)


@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16], ids=["int8", "bf16"])
@pytest.mark.parametrize("L,b,kv,T,D,pos", [
    (30, 16, 16, 640, 128, 416),   # the T3 k|v width
    (2, 3, 2, 136, 24, 135),       # rows of 24 bytes (int8) and 48 (bf16)
    (1, 1, 1, 8, 3, 0),            # 3-byte int8 rows: byte copies
])
def test_cache_append_k_kernel_is_byte_exact(dev, dtype, L, b, kv, T, D, pos):
    gen = _gen(dev, pos + D + 1)
    if dtype == torch.int8:
        k = torch.randint(-127, 128, (L, b, kv, T, D), generator=gen, device=dev, dtype=dtype)
        kn = torch.randint(-127, 128, (L, b, kv, D), generator=gen, device=dev, dtype=dtype)
    else:
        k = torch.randn((L, b, kv, T, D), generator=gen, device=dev).to(dtype)
        kn = torch.randn((L, b, kv, D), generator=gen, device=dev).to(dtype)
    before = cache_append_k_stacked.launches, cache_append_kv_stacked.launches
    got = cache_append_kv_stacked(k.clone(), None, kn, None, pos)
    ref = cache_append_k_plain(k.clone(), kn, pos)
    torch.cuda.synchronize()
    assert (cache_append_k_stacked.launches, cache_append_kv_stacked.launches) == (
        before[0] + 1, before[1])
    bits = torch.uint8 if dtype == torch.int8 else torch.int16
    assert torch.equal(got.view(bits), ref.view(bits))


def _offset(t, elems):
    """A contiguous copy of ``t`` whose data starts ``elems`` elements past a
    fresh allocation (aligned to the element only)."""
    flat = torch.empty((t.numel() + elems,), dtype=t.dtype, device=t.device)
    out = flat[elems:].view(t.shape)
    out.copy_(t)
    return out


@pytest.mark.parametrize("dtype,d,misalign,word", [
    (torch.bfloat16, 64, 0, 16),    # K4's rows at the T3 cache: 128 bytes
    (torch.float32, 8, 0, 16),      # 32 bytes
    (torch.bfloat16, 6, 0, 4),      # 12 bytes
    (torch.float32, 3, 0, 4),       # 12 bytes
    (torch.bfloat16, 3, 0, 1),      # 6 bytes
    (torch.bfloat16, 64, 2, 4),     # 16-byte rows, the new rows 4-byte aligned only
    (torch.bfloat16, 64, 1, 1),     # 2-byte aligned new rows
])
@pytest.mark.parametrize("pos", [0, 135])
def test_cache_append_kv_words_are_byte_exact(dev, dtype, d, misalign, word, pos):
    """K4 (k and v) and K5 (one array) in 16-, 4- and 1-byte words, at the
    first and the last slot, byte for byte against the slice assignment."""
    L, b, kv, T = 2, 3, 2, 136
    gen = _gen(dev, d + pos + misalign)
    k, v = (torch.randn((L, b, kv, T, d), generator=gen, device=dev).to(dtype)
            for _ in range(2))
    kn, vn = (_offset(torch.randn((L, b, kv, d), generator=gen, device=dev).to(dtype), misalign)
              for _ in range(2))
    row = d * k.element_size()
    assert append_word(row, k.data_ptr(), v.data_ptr(), kn.data_ptr(), vn.data_ptr()) == word
    bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
    got = cache_append_kv_stacked(k.clone(), v.clone(), kn, vn, pos)
    ref = cache_append_kv_plain(k.clone(), v.clone(), kn, vn, pos)
    got1 = cache_append_kv_stacked(k.clone(), None, kn, None, pos)
    ref1 = cache_append_k_plain(k.clone(), kn, pos)
    torch.cuda.synchronize()
    for a, r in zip(got + (got1,), ref + (ref1,)):
        assert torch.equal(a.view(bits), r.view(bits))


def test_cache_append_kv_refuses_a_misaligned_word(dev):
    """The C entry refuses a 16-byte word on a row pointer that is not
    16-byte aligned, and a word the row's width is not a multiple of; b = 0
    rows are refused too. Nothing is written."""
    k = torch.zeros((1, 2, 2, 8, 64), dtype=torch.bfloat16, device=dev)
    kn = _offset(torch.ones((1, 2, 2, 64), dtype=torch.bfloat16, device=dev), 2)
    fn = _build.kernel("vt_cache_append_kv", _KV_ARGTYPES)
    stream = _build.stream_ptr(k)
    assert fn(k.data_ptr(), None, kn.data_ptr(), None, 4, 8, 128, 3, 16, stream) != 0
    assert fn(k.data_ptr(), None, kn.data_ptr(), None, 4, 8, 6, 3, 4, stream) != 0
    assert fn(k.data_ptr(), None, kn.data_ptr(), None, 0, 8, 128, 3, 4, stream) != 0
    torch.cuda.synchronize()
    assert not k.any()
    assert fn(k.data_ptr(), None, kn.data_ptr(), None, 4, 8, 128, 3, 4, stream) == 0
    torch.cuda.synchronize()
    assert torch.equal(k[:, :, :, 3], kn) and int((k != 0).sum()) == kn.numel()


# ── B6 ──────────────────────────────────────────────────────────────────


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("b,h,hk,s_q,s_k,d,causal,lens", [
    (1, 2, 2, 512, 512, 64, True, None),
    (3, 2, 2, 320, 320, 64, False, (320, 200, 17)),
    (2, 4, 2, 100, 100, 32, True, None),           # GQA, s off the 64-row tile
    (2, 4, 1, 256, 256, 16, False, (256, 0)),      # GQA 4:1, one fully masked row
    (2, 2, 2, 70, 130, 8, True, (130, 33)),        # s_q != s_k, causal and kv_lens
    (2, 16, 8, 512, 512, 128, True, None),         # the Qwen3 prefill at d_head 128
    (3, 4, 2, 200, 200, 128, False, (200, 77, 0)),  # d 128, ragged, a fully masked row
    # the tensor-core body's edges (bf16, d 64 and 128): s off the 64-row
    # and 64-key tiles, GQA groups 2 and 4, kv_lens below one tile and 0,
    # causal with s_q != s_k both ways
    (2, 2, 2, 100, 100, 64, True, None),
    (2, 4, 2, 130, 190, 128, False, (190, 50)),
    (2, 8, 2, 96, 96, 64, True, None),
    (2, 4, 1, 128, 128, 128, False, (0, 30)),
    (2, 2, 2, 70, 130, 64, True, (130, 33)),
    (1, 4, 2, 200, 100, 128, True, None),
])
@pytest.mark.parametrize("gain", [1.0, 30.0], ids=["x1", "x30"])
def test_flash_attention_kernel(dev, dtype, b, h, hk, s_q, s_k, d, causal, lens, gain):
    """B6 against its plain version; ``gain`` scales q, so that at x30 the
    row max moves from key tile to key tile. bf16 at d 64 and 128 takes the
    tensor-core body (``tc_launches`` rises), every other call the CUDA-core
    one."""
    gen = _gen(dev, s_q + d + h)
    q = (torch.randn((b, h, s_q, d), generator=gen, device=dev) * gain).to(dtype)
    k, v = (torch.randn((b, hk, s_k, d), generator=gen, device=dev).to(dtype)
            for _ in range(2))
    kv_lens = None if lens is None else torch.tensor(lens, dtype=torch.int32, device=dev)
    before = flash_attention.launches, flash_attention.tc_launches
    out = flash_attention(q, k, v, causal=causal, kv_lens=kv_lens)
    ref = attention_plain(q, k, v, causal=causal, kv_lens=kv_lens)
    torch.cuda.synchronize()
    tc = int(dtype == torch.bfloat16 and d in (64, 128))
    assert (flash_attention.launches, flash_attention.tc_launches) == (before[0] + 1,
                                                                       before[1] + tc)
    assert out.dtype == dtype and torch.all(torch.isfinite(out))
    diff = (out.float() - ref.float()).abs()
    if dtype == torch.float32:
        assert diff.max().item() <= 1e-4, diff.max().item()
    else:
        assert torch.all(diff <= 1e-2 + 1e-2 * ref.float().abs()), diff.max().item()
    if lens is not None and 0 in lens:
        assert torch.all(out[list(lens).index(0)] == 0)


def test_flash_attention_kernel_rejects_bad_inputs(dev):
    q = torch.zeros((1, 2, 8, 64), device=dev)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        flash_attention(q.half(), q.half(), q.half())
    with pytest.raises(ValueError, match="head dims"):
        flash_attention(q[..., :48].contiguous(), q[..., :48].contiguous(),
                        q[..., :48].contiguous())
    with pytest.raises(ValueError, match="kv_lens"):
        flash_attention(q, q, q, kv_lens=torch.zeros(1, dtype=torch.int64, device=dev))
    qb = q.bfloat16()
    off = torch.zeros(qb.numel() + 1, dtype=torch.bfloat16, device=dev)[1:].view(qb.shape)
    with pytest.raises(ValueError, match="16-byte"):
        flash_attention(qb, off, qb)


# ── B6t, B11a, B11b (the training path) ─────────────────────────────────


#: the phase-2 shapes of chip_smoke.py (the T3 fine-tune's [8, 16, 128, 64]
#: and [8, 16, 512, 64], GQA at d 128, a ragged non-causal case) and edges:
#: f32, d 16 with GQA 4:1, s off every tile, s_q != s_k; at d 64 (B11's
#: tensor-core body in bf16) s_q != s_k causal, s off every 64-row tile
#: non-causal, GQA 4:1
TRAIN_CASES = [
    (8, 16, 16, 128, 128, 64, True),
    (8, 16, 16, 512, 512, 64, True),
    (8, 16, 8, 512, 512, 128, True),
    (2, 4, 4, 200, 200, 64, False),
    (2, 4, 1, 100, 100, 16, True),
    (3, 4, 2, 77, 77, 32, False),
    (1, 2, 2, 70, 130, 8, True),
    (1, 2, 2, 70, 130, 64, True),
    (3, 4, 2, 77, 77, 64, False),
    (2, 8, 2, 150, 150, 64, True),
]


def _train_inputs(dev, dtype, b, h, hk, s_q, s_k, d):
    gen = _gen(dev, s_q + 3 * d + h + hk)
    q = torch.randn((b, h, s_q, d), generator=gen, device=dev).to(dtype)
    k, v = (torch.randn((b, hk, s_k, d), generator=gen, device=dev).to(dtype)
            for _ in range(2))
    do = torch.randn((b, h, s_q, d), generator=gen, device=dev).to(dtype)
    return q, k, v, do


def _within(got, ref, frac):
    """|got - ref| <= frac * max|ref| (f32 1e-4: only the summation order
    differs; bf16 1e-2: the outputs are bf16, and B11b rounds ds to bf16
    before its dQ product, where an f32-ulp change of ds can flip a step)."""
    err = (got.float() - ref.float()).abs().max().item()
    assert err <= frac * ref.float().abs().max().item(), (err, ref.float().abs().max().item())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("b,h,hk,s_q,s_k,d,causal", TRAIN_CASES)
def test_flash_train_kernels(dev, dtype, b, h, hk, s_q, s_k, d, causal):
    """B6t (out and lse), B11b (dq and di) and B11a (dk and dv) each against
    its plain version on the same inputs; lse within 1e-5 + 1e-5·|ref|. B11b
    and B11a count one tensor-core launch each exactly where
    ``flash_bwd_body`` says "tc", never for f32 or d <= 32."""
    from vocalie_tts_tpu_torch.ops.flash_attention import attention_plain_lse, flash_attention_lse
    from vocalie_tts_tpu_torch.ops import flash_attention_bwd as fb

    q, k, v, do = _train_inputs(dev, dtype, b, h, hk, s_q, s_k, d)
    before = (flash_attention_lse.launches, fb.flash_attention_bwd_dq.launches,
              fb.flash_attention_bwd_dkv.launches)
    tc_before = (fb.flash_attention_bwd_dq.tc_launches, fb.flash_attention_bwd_dkv.tc_launches)
    out, lse = flash_attention_lse(q, k, v, causal=causal)
    ref_out, ref_lse = attention_plain_lse(q, k, v, causal=causal)
    sm = 1.0 / math.sqrt(d)
    dq, di = fb.flash_attention_bwd_dq(q, k, v, ref_out, ref_lse, do, causal=causal, sm_scale=sm)
    ref_dq, ref_di = fb.flash_attention_bwd_dq_plain(q, k, v, ref_out, ref_lse, do,
                                                     causal=causal, sm_scale=sm)
    dk, dv = fb.flash_attention_bwd_dkv(q, k, v, do, ref_lse, ref_di, causal=causal, sm_scale=sm)
    ref_dk, ref_dv = fb.flash_attention_bwd_dkv_plain(q, k, v, do, ref_lse, ref_di,
                                                      causal=causal, sm_scale=sm)
    torch.cuda.synchronize()
    assert (flash_attention_lse.launches, fb.flash_attention_bwd_dq.launches,
            fb.flash_attention_bwd_dkv.launches) == tuple(n + 1 for n in before)
    tc = int(fb.flash_bwd_body(dtype, d) == "tc")
    if dtype == torch.float32 or d <= 32:
        assert not tc
    assert (fb.flash_attention_bwd_dq.tc_launches,
            fb.flash_attention_bwd_dkv.tc_launches) == tuple(n + tc for n in tc_before)
    rows_with_keys = torch.isfinite(ref_lse)
    assert torch.equal(torch.isfinite(lse), rows_with_keys)
    assert torch.all((lse - ref_lse).abs()[rows_with_keys]
                     <= 1e-5 + 1e-5 * ref_lse.abs()[rows_with_keys])
    diff = (out.float() - ref_out.float()).abs()
    if dtype == torch.float32:
        assert diff.max().item() <= 1e-4
    else:
        assert torch.all(diff <= 1e-2 + 1e-2 * ref_out.float().abs())
    frac = 1e-4 if dtype == torch.float32 else 1e-2
    _within(di, ref_di, 1e-5)
    for got, ref in ((dq, ref_dq), (dk, ref_dk), (dv, ref_dv)):
        assert got.dtype == dtype and torch.all(torch.isfinite(got))
        _within(got, ref, frac)


#: B6t's tensor-core edges (bf16, d 64 and 128): s off the tiles, GQA 2 and 4,
#: causal with s_q != s_k both ways, non-causal
TC_LSE_CASES = [
    (2, 2, 2, 100, 100, 64, True),
    (2, 4, 2, 130, 130, 128, True),
    (2, 8, 2, 96, 160, 64, False),
    (1, 4, 1, 200, 100, 128, True),
    (1, 4, 2, 70, 130, 64, True),
]


@pytest.mark.parametrize("gain", [1.0, 30.0], ids=["x1", "x30"])
@pytest.mark.parametrize("b,h,hk,s_q,s_k,d,causal", TC_LSE_CASES)
def test_flash_lse_tensor_core_body(dev, b, h, hk, s_q, s_k, d, causal, gain):
    """B6t on the tensor-core body against its plain version at phase 2's
    gates: out within 1e-2 + 1e-2·|ref|, lse within 1e-6 + 1e-6·|ref| with
    the absolute term in units of the scores, which q's ``gain`` scales (x30:
    the row max moves between key tiles; an early causal row's lse is one
    score, whose f32 sum of 128 products of ~30 rounds apart by ~1e-5 in any
    two summation orders). One launch, counted by ``tc_launches``; f32 and d
    32 leave that count flat."""
    from vocalie_tts_tpu_torch.ops.flash_attention import attention_plain_lse, flash_attention_lse

    q, k, v, _ = _train_inputs(dev, torch.bfloat16, b, h, hk, s_q, s_k, d)
    q = (q.float() * gain).to(torch.bfloat16)
    before = flash_attention_lse.launches, flash_attention_lse.tc_launches
    out, lse = flash_attention_lse(q, k, v, causal=causal)
    ref_out, ref_lse = attention_plain_lse(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert (flash_attention_lse.launches, flash_attention_lse.tc_launches) == (
        before[0] + 1, before[1] + 1)
    assert torch.equal(torch.isfinite(lse), torch.isfinite(ref_lse))
    ok = torch.isfinite(ref_lse)
    tol = 1e-6 * gain + 1e-6 * ref_lse.abs()[ok]
    assert torch.all((lse - ref_lse).abs()[ok] <= tol), \
        ((lse - ref_lse).abs()[ok] / tol).max().item()
    assert torch.all((out.float() - ref_out.float()).abs() <= 1e-2 + 1e-2 * ref_out.float().abs())
    for dtype, dd in ((torch.float32, d), (torch.bfloat16, 32)):
        qs, ks, vs, _ = _train_inputs(dev, dtype, b, h, hk, s_q, s_k, dd)
        n = flash_attention_lse.tc_launches
        flash_attention_lse(qs, ks, vs, causal=causal)
        assert flash_attention_lse.tc_launches == n


@pytest.mark.parametrize("hk", [4, 2])
def test_flash_attention_trainable_on_the_card(dev, hk):
    """The autograd path launches B6t once forward and B11b, B11a once
    backward, and its gradients equal the CPU's plain ones (f32)."""
    from vocalie_tts_tpu_torch.ops.flash_attention import flash_attention_lse, flash_attention_trainable
    from vocalie_tts_tpu_torch.ops import flash_attention_bwd as fb

    q, k, v, do = _train_inputs(dev, torch.float32, 2, 4, hk, 100, 100, 64)
    grads = []
    for device in (dev, torch.device("cpu")):
        leaves = [t.detach().to(device).requires_grad_(True) for t in (q, k, v)]
        before = (flash_attention_lse.launches, fb.flash_attention_bwd_dq.launches,
                  fb.flash_attention_bwd_dkv.launches)
        out = flash_attention_trainable(*leaves)
        out.backward(do.to(device).transpose(2, 3).contiguous().transpose(2, 3))  # not contiguous
        launched = tuple(a - b for a, b in zip((flash_attention_lse.launches,
                                                 fb.flash_attention_bwd_dq.launches,
                                                 fb.flash_attention_bwd_dkv.launches), before))
        assert launched == ((1, 1, 1) if device.type == "cuda" else (0, 0, 0))
        grads.append([out.detach().cpu()] + [t.grad.cpu() for t in leaves])
    for got, ref in zip(*grads):
        _within(got, ref, 1e-4)


def test_flash_train_kernels_reject_bad_inputs(dev):
    from vocalie_tts_tpu_torch.ops import flash_attention_bwd as fb

    q = torch.zeros((1, 2, 8, 64), device=dev)
    lse = torch.zeros((1, 2, 8), device=dev)
    kw = dict(causal=True, sm_scale=0.125)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        fb.flash_attention_bwd_dq(q.half(), q.half(), q.half(), q.half(), lse, q.half(), **kw)
    with pytest.raises(ValueError, match="lse"):
        fb.flash_attention_bwd_dq(q, q, q, q, lse.double(), q, **kw)
    with pytest.raises(ValueError, match="contiguous"):
        fb.flash_attention_bwd_dkv(q, q, q, q.transpose(2, 3).contiguous().transpose(2, 3), lse,
                                   lse, **kw)
    with pytest.raises(ValueError, match="di"):
        fb.flash_attention_bwd_dkv(q, q, q, q, lse, lse[:, :1].contiguous(), **kw)
    # the tensor-core body loads 16-byte chunks: a contiguous bf16 view that
    # starts one element into its storage is refused
    qb = q.bfloat16()
    off = torch.zeros(qb.numel() + 1, dtype=torch.bfloat16, device=dev)[1:].view(qb.shape)
    assert off.is_contiguous() and off.data_ptr() % 16
    with pytest.raises(ValueError, match="16-byte"):
        fb.flash_attention_bwd_dq(qb, qb, qb, qb, lse, off, **kw)
    with pytest.raises(ValueError, match="16-byte"):
        fb.flash_attention_bwd_dkv(off, qb, qb, qb, lse, lse, **kw)


# ── B2, B3, B4 ──────────────────────────────────────────────────────────


def _int8_weights(gen, dev, L, d_in, d_out):
    q = torch.randint(-127, 128, (L, d_in, d_out), generator=gen, device=dev, dtype=torch.int8)
    s = ((torch.rand((L, 1, d_out), generator=gen, device=dev) + 0.5) / 127) * d_in ** -0.5
    return q, s


def _close(got, ref):
    err = (got - ref).abs().max().item()
    assert torch.isfinite(got).all() and err <= 1e-5 * ref.abs().max().item(), err


@pytest.mark.parametrize("b,d_in,d_out,dtype,zero_row", [
    (1, 1024, 1152, torch.bfloat16, None),   # the lm_head at batch 1
    (17, 256, 384, torch.float32, 16),       # two row passes, a zero row
    (16, 1024, 1152, torch.bfloat16, 3),
    (5, 96, 128, torch.float32, None),       # K a multiple of 32 only
])
def test_dense_int8_kernel(dev, b, d_in, d_out, dtype, zero_row):
    gen = _gen(dev, b + d_in)
    x = torch.randn((b, d_in), generator=gen, device=dev).to(dtype)
    if zero_row is not None:
        x[zero_row] = 0
    w, s = _int8_weights(gen, dev, 2, d_in, d_out)
    before = dense_int8_stacked.launches
    got = dense_int8_stacked(x, w, s, 1)
    ref = dense_int8_plain(x, w, s, 1)
    torch.cuda.synchronize()
    assert dense_int8_stacked.launches == before + 1
    _close(got, ref)
    if zero_row is not None:
        assert (got[zero_row] == 0).all()


@pytest.mark.parametrize("b,d,dq,dtype,zero_row,layer", [
    (1, 1024, 3072, torch.bfloat16, None, 0),
    (17, 128, 384, torch.float32, 0, 1),
    (16, 1024, 3072, torch.bfloat16, 7, 1),
])
def test_qkv_norm_int8_kernel(dev, b, d, dq, dtype, zero_row, layer):
    gen = _gen(dev, b + d + 1)
    x = (torch.randn((b, d), generator=gen, device=dev) * 3).to(dtype)
    if zero_row is not None:
        x[zero_row] = 0
    nw = 1 + 0.1 * torch.randn((2, d), generator=gen, device=dev)
    w, s = _int8_weights(gen, dev, 2, d, dq)
    got = qkv_norm_int8_stacked(x, nw, w, s, layer, eps=1e-5)
    ref = qkv_norm_int8_plain(x, nw, w, s, layer, eps=1e-5)
    torch.cuda.synchronize()
    _close(got, ref)
    if zero_row is not None:
        assert (got[zero_row] == 0).all()


@pytest.mark.parametrize("b,L,d,F,Q,layer,dtype", [
    (16, 3, 1024, 4096, 3072, 1, torch.bfloat16),   # the T3 layer: d_ff in two tiles
    (1, 2, 1024, 4096, 3072, 1, torch.bfloat16),    # batch 1, last layer (clamped next)
    (17, 3, 128, 256, 384, 2, torch.float32),       # one tile, last layer, two row passes
    (4, 2, 512, 8192, 1536, 0, torch.float32),      # two 4096 tiles
])
def test_tail_swiglu_qkv_int8_kernel(dev, b, L, d, F, Q, layer, dtype):
    gen = _gen(dev, b + d + F)
    attn = torch.randn((b, d), generator=gen, device=dev) * 0.3
    attn[0] = 0   # a zero row: its o-projection is 0, x2 = x
    x = torch.randn((b, d), generator=gen, device=dev).to(dtype)
    wo, wos = _int8_weights(gen, dev, L, d, d)
    mw = 1 + 0.1 * torch.randn((L, d), generator=gen, device=dev)
    wgu, sgu = _int8_weights(gen, dev, L, d, 2 * F)
    wd, sd = _int8_weights(gen, dev, L, F, d)
    nw = 1 + 0.1 * torch.randn((L, d), generator=gen, device=dev)
    wq, sq = _int8_weights(gen, dev, L, d, Q)
    args = (attn, x, wo, wos, mw, wgu, sgu, wd, sd, nw, wq, sq, layer)
    before = tail_swiglu_qkv_int8_stacked.launches
    x_out, qkv = tail_swiglu_qkv_int8_stacked(*args, eps=1e-5)
    rx, rq = tail_swiglu_qkv_int8_plain(*args, eps=1e-5)
    torch.cuda.synchronize()
    assert tail_swiglu_qkv_int8_stacked.launches == before + 1
    assert x_out.shape == (b, d) and qkv.shape == (b, Q)
    _close(x_out, rx)
    _close(qkv, rq)


def _swiglu_args(dev, b, L, d, F, dtype):
    gen = _gen(dev, b + d + F + 5)
    attn = torch.randn((b, d), generator=gen, device=dev) * 0.3
    x = torch.randn((b, d), generator=gen, device=dev).to(dtype)
    wo, wos = _int8_weights(gen, dev, L, d, d)
    mw = 1 + 0.1 * torch.randn((L, d), generator=gen, device=dev)
    wgu, sgu = _int8_weights(gen, dev, L, d, 2 * F)
    wd, sd = _int8_weights(gen, dev, L, F, d)
    return attn, x, wo, wos, mw, wgu, sgu, wd, sd


@pytest.mark.parametrize("b,L,d,F,layer,dtype", [
    (8, 2, 2048, 8192, 1, torch.bfloat16),    # the Qwen3 layer: d_ff in eight 1024 tiles
    (1, 2, 2048, 8192, 0, torch.bfloat16),    # batch 1
    (17, 3, 128, 256, 2, torch.float32),      # one tile, two row passes
])
def test_tail_swiglu_int8_kernel(dev, b, L, d, F, layer, dtype):
    """B8a against its plain version, and bit-equal to B2's first output."""
    args = _swiglu_args(dev, b, L, d, F, dtype)
    gen = _gen(dev, 3)
    nw = 1 + 0.1 * torch.randn((L, d), generator=gen, device=dev)
    wq, sq = _int8_weights(gen, dev, L, d, 384)
    before = tail_swiglu_int8_stacked.launches
    got = tail_swiglu_int8_stacked(*args, layer, eps=1e-6)
    ref = tail_swiglu_int8_plain(*args, layer, eps=1e-6)
    b2, _ = tail_swiglu_qkv_int8_stacked(*args, nw, wq, sq, layer, eps=1e-6)
    torch.cuda.synchronize()
    assert tail_swiglu_int8_stacked.launches == before + 1
    assert got.shape == (b, d) and got.dtype == torch.float32
    _close(got, ref)
    assert torch.equal(got, b2)


#: B2/B8a's one-launch body at the T3 and Qwen3 widths: (d_model = d_attn,
#: d_ff, d_qkv, eps); three layers, so that 0, L/2 and L - 1 are 0, 1, 2
TAIL_WIDTHS = {"t3": (1024, 4096, 3072, 1e-5), "qwen3": (2048, 8192, 4096, 1e-6)}
_TAIL_WEIGHTS: dict = {}


def _tail_weights(dev, width, L=3):
    if width not in _TAIL_WEIGHTS:
        d, F, Q, _ = TAIL_WIDTHS[width]
        gen = _gen(dev, d + F)
        wo, wos = _int8_weights(gen, dev, L, d, d)
        mw = 1 + 0.1 * torch.randn((L, d), generator=gen, device=dev)
        wgu, sgu = _int8_weights(gen, dev, L, d, 2 * F)
        wd, sd = _int8_weights(gen, dev, L, F, d)
        nw = 1 + 0.1 * torch.randn((L, d), generator=gen, device=dev)
        wq, sq = _int8_weights(gen, dev, L, d, Q)
        _TAIL_WEIGHTS.clear()   # one width's weights at a time (the Qwen3 layers are 0.2 GB)
        _TAIL_WEIGHTS[width] = (wo, wos, mw, wgu, sgu, wd, sd, nw, wq, sq)
    return _TAIL_WEIGHTS[width]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("layer", [0, 1, 2])
@pytest.mark.parametrize("b", [1, 8, 16, 17])
@pytest.mark.parametrize("width", list(TAIL_WIDTHS))
def test_tail_swiglu_one_launch_is_bit_equal(dev, width, b, layer, dtype):
    """B2 and B8a (one cooperative launch on the int8 tensor cores) against
    their plain versions, bit for bit, with a zero attention row; B8a equals
    B2's first output."""
    d, F, Q, eps = TAIL_WIDTHS[width]
    wo, wos, mw, wgu, sgu, wd, sd, nw, wq, sq = _tail_weights(dev, width)
    gen = _gen(dev, 100 * b + layer)
    attn = torch.randn((b, d), generator=gen, device=dev) * 0.3
    attn[b // 2] = 0
    x = torch.randn((b, d), generator=gen, device=dev).to(dtype)
    mw_, nw_ = (mw, nw) if dtype == torch.float32 else (mw.to(dtype), nw.to(dtype))
    tail = (attn, x, wo, wos, mw_, wgu, sgu, wd, sd)
    before = tail_swiglu_qkv_int8_stacked.launches, tail_swiglu_int8_stacked.launches
    x_out, qkv = tail_swiglu_qkv_int8_stacked(*tail, nw_, wq, sq, layer, eps=eps)
    x8 = tail_swiglu_int8_stacked(*tail, layer, eps=eps)
    rx, rq = tail_swiglu_qkv_int8_plain(*tail, nw_, wq, sq, layer, eps=eps)
    torch.cuda.synchronize()
    assert (tail_swiglu_qkv_int8_stacked.launches, tail_swiglu_int8_stacked.launches) == (
        before[0] + 1, before[1] + 1)
    assert x_out.shape == (b, d) and qkv.shape == (b, Q)
    assert torch.equal(x_out, rx), (x_out - rx).abs().max().item()
    assert torch.equal(qkv, rq), (qkv - rq).abs().max().item()
    assert torch.equal(x8, x_out)


def test_tail_swiglu_is_one_cuda_kernel_a_call(dev):
    """torch.profiler sees one CUDA kernel for a B2 call and one for a B8a
    call (the old body issued 12 and 9), counted through
    ``_profiled_kernels``."""
    d, F, Q, eps = TAIL_WIDTHS["t3"]
    wo, wos, mw, wgu, sgu, wd, sd, nw, wq, sq = _tail_weights(dev, "t3")
    gen = _gen(dev, 7)
    attn = torch.randn((16, d), generator=gen, device=dev)
    x = torch.randn((16, d), generator=gen, device=dev).to(torch.bfloat16)
    tail = (attn, x, wo, wos, mw, wgu, sgu, wd, sd)
    calls = [lambda: tail_swiglu_qkv_int8_stacked(*tail, nw, wq, sq, 1, eps=eps),
             lambda: tail_swiglu_int8_stacked(*tail, 1, eps=eps)]
    for call in calls:
        names = _profiled_kernels(call)
        assert [n for n in names if "tail_swiglu_kernel" in n] and len(names) == 1, names


def test_tail_swiglu_refuses_bad_inputs(dev):
    d, F, Q, eps = TAIL_WIDTHS["t3"]
    wo, wos, mw, wgu, sgu, wd, sd, nw, wq, sq = _tail_weights(dev, "t3")
    x = torch.zeros((4, d), device=dev)
    attn = torch.zeros((4 * d + 1,), device=dev)[1:].view(4, d)   # 4-byte aligned only
    with pytest.raises(ValueError, match="16-byte"):
        tail_swiglu_qkv_int8_stacked(attn, x, wo, wos, mw, wgu, sgu, wd, sd, nw, wq, sq, 0,
                                     eps=eps)
    empty = torch.zeros((0, d), device=dev)
    with pytest.raises(ValueError, match="rows"):
        tail_swiglu_int8_stacked(empty, empty, wo, wos, mw, wgu, sgu, wd, sd, 0, eps=eps)
    # 33 rows run in two launches (test_tail_swiglu_past_32_rows_runs_in_row_chunks);
    # an attention row of 4096 is past every launch's normed rows: refused, named
    wide_attn = torch.zeros((4, 4096), device=dev)
    wide_wo = torch.zeros((wo.shape[0], 4096, d), dtype=torch.int8, device=dev)
    with pytest.raises(ValueError, match="no launch takes d_model=1024, d_attn=4096"):
        tail_swiglu_qkv_int8_stacked(wide_attn, x, wide_wo, wos, mw, wgu, sgu, wd, sd, nw, wq,
                                     sq, 0, eps=eps)


@pytest.mark.parametrize("width,b,launches", [("t3", 33, (2, 2)), ("t3", 64, (2, 2)),
                                              ("qwen3", 24, (2, 2)), ("qwen3", 45, (3, 2))])
def test_tail_swiglu_past_32_rows_runs_in_row_chunks(dev, width, b, launches):
    """More rows than one B2/B8a launch takes (32 at the T3 layer, 22 and
    23 at the Qwen3 layer: ``tail_rows``) run as one launch a row chunk of
    near-equal size, each counted in ``.launches``, bit-equal to the plain
    version on the whole batch."""
    d, F, Q, eps = TAIL_WIDTHS[width]
    wo, wos, mw, wgu, sgu, wd, sd, nw, wq, sq = _tail_weights(dev, width)
    gen = _gen(dev, 300 + b)
    attn = torch.randn((b, d), generator=gen, device=dev) * 0.3
    x = torch.randn((b, d), generator=gen, device=dev).to(torch.bfloat16)
    tail = (attn, x, wo, wos, mw, wgu, sgu, wd, sd)
    before = tail_swiglu_qkv_int8_stacked.launches, tail_swiglu_int8_stacked.launches
    x_out, qkv = tail_swiglu_qkv_int8_stacked(*tail, nw, wq, sq, 2, eps=eps)
    x8 = tail_swiglu_int8_stacked(*tail, 2, eps=eps)
    rx, rq = tail_swiglu_qkv_int8_plain(*tail, nw, wq, sq, 2, eps=eps)
    torch.cuda.synchronize()
    assert (tail_swiglu_qkv_int8_stacked.launches - before[0],
            tail_swiglu_int8_stacked.launches - before[1]) == launches
    assert torch.equal(x_out, rx), (x_out - rx).abs().max().item()
    assert torch.equal(qkv, rq), (qkv - rq).abs().max().item()
    assert torch.equal(x8, rx)


@pytest.mark.parametrize("megatail", [True, False], ids=["B2", "B8a"])
def test_decode_step_past_32_rows_keeps_the_tail(dev, monkeypatch, megatail):
    """A 33-row step of a two-layer model at the T3 widths (d_model 1024,
    16 heads of 64, d_ff 4096, the int8 cache and the dense kernels) on the
    card: ``_dense_dispatch`` keeps the megatail (``VOCALIE_MEGATAIL=0``:
    the tail), as JAX does at any batch; B2 (B8a) runs two launches a
    layer, of 16 and 17 rows. Held to the same two steps through the plain
    versions of B2/B8a, B3 and B4 (JAX's path, which the CPU parity tests
    hold to JAX): logits within 2e-3 + 2e-3·|ref|, every appended int8
    byte and bf16 scale equal."""
    import dataclasses

    from vocalie_tts_tpu_torch.models.common import transformer as tr

    monkeypatch.delenv("VOCALIE_MEGALAYER", raising=False)
    monkeypatch.setenv("VOCALIE_MEGATAIL", "1" if megatail else "0")
    cfg = tr.TransformerConfig(vocab_size=1152, d_model=1024, n_layers=2, n_heads=16,
                               n_kv_heads=16, d_head=64, d_ff=4096, max_seq_len=256,
                               norm_eps=1e-5, kv_quant=True, decode_kernel=True,
                               dense_kernel=True, dtype=torch.bfloat16)
    gen = _gen(dev, 33)
    params = tr.fuse_decode_weights(tr.quantize_weights_int8(
        tr.init_params(cfg, generator=gen, device=dev)))
    b, s = 33, 32
    path = tr._dense_dispatch(params["layers"], cfg, b, 256)
    assert path == (tr.MEGATAIL if megatail else tr.TAIL)
    emb = (torch.randn((b, s, 1024), generator=gen, device=dev) * 0.5).to(torch.bfloat16)
    lens = torch.randint(3, s + 1, (b,), generator=gen, device=dev).to(torch.int32)
    toks = torch.randint(0, 1152, (2, b), generator=gen, device=dev)
    _, cache = tr.prefill(params, cfg, None, lens, inputs_embeds=emb, cache_len=256)
    tail = tr.tail_swiglu_qkv_int8_stacked if megatail else tr.tail_swiglu_int8_stacked
    name = tail.__name__

    def run():
        c = dataclasses.replace(cache, k=cache.k.clone(), v=cache.v.clone(),
                                k_scale=cache.k_scale.clone(), v_scale=cache.v_scale.clone())
        out = []
        for i in range(2):
            logits, c = tr.decode_step(params, cfg, toks[i], c)
            out.append(logits.float())
        return out, c

    before = tail.launches
    got, kc = run()
    assert tail.launches - before == 2 * 2 * cfg.n_layers   # 2 steps x 2 launches a layer
    from vocalie_tts_tpu_torch.ops import decode_dense as dd

    for fn in ("qkv_norm_int8_stacked", "dense_int8_stacked", name):
        monkeypatch.setattr(tr, fn, getattr(dd, fn.replace("_stacked", "_plain")))
    ref, pc = run()
    torch.cuda.synchronize()
    for i, (g, r) in enumerate(zip(got, ref)):
        assert g.shape == (b, 1152) and torch.isfinite(g).all()
        ratio = ((g - r).abs() / (2e-3 + 2e-3 * r.abs())).max().item()
        assert ratio <= 1, f"step {i}: {ratio}"
    for attr in ("k", "v", "k_scale", "v_scale"):
        assert torch.equal(getattr(kc, attr), getattr(pc, attr)), attr


@pytest.mark.parametrize("b", [17, 33])
def test_megalayer_step_past_16_rows_runs_b12_in_row_chunks(dev, monkeypatch, b):
    """A ``VOCALIE_MEGALAYER=1`` step of 17 (33) rows of a two-layer model at
    the T3 widths on the card: ``_dense_dispatch`` keeps B12, as JAX does at
    any batch, and B12 runs 2 (3) launches a layer. Each chunk's rows run
    alone from the same cache rows give the same logits and cache bytes bit
    for bit; the plain versions of B12, B3 and B4 give logits within 2e-3 +
    2e-3·|ref| and appended bytes within one step (B12 is within 1e-5 of its
    plain version, so a byte on a .5 tie may round apart)."""
    import dataclasses

    from vocalie_tts_tpu_torch.models.common import transformer as tr
    from vocalie_tts_tpu_torch.ops import decode_dense as dd
    from vocalie_tts_tpu_torch.ops import decode_layer as dl

    monkeypatch.setenv("VOCALIE_MEGALAYER", "1")
    monkeypatch.delenv("VOCALIE_MEGATAIL", raising=False)
    cfg = tr.TransformerConfig(vocab_size=1152, d_model=1024, n_layers=2, n_heads=16,
                               n_kv_heads=16, d_head=64, d_ff=4096, max_seq_len=256,
                               norm_eps=1e-5, kv_quant=True, decode_kernel=True,
                               dense_kernel=True, dtype=torch.bfloat16)
    gen = _gen(dev, b)
    params = tr.fuse_decode_weights(tr.quantize_weights_int8(
        tr.init_params(cfg, generator=gen, device=dev)))
    s = 32
    assert tr._dense_dispatch(params["layers"], cfg, b, 256) == tr.MEGALAYER
    emb = (torch.randn((b, s, 1024), generator=gen, device=dev) * 0.5).to(torch.bfloat16)
    lens = torch.randint(3, s + 1, (b,), generator=gen, device=dev).to(torch.int32)
    toks = torch.randint(0, 1152, (2, b), generator=gen, device=dev)
    _, cache = tr.prefill(params, cfg, None, lens, inputs_embeds=emb, cache_len=256)

    def run(r0=0, r1=b):
        c = dataclasses.replace(cache, k=cache.k[:, r0:r1].clone(), v=cache.v[:, r0:r1].clone(),
                                k_scale=cache.k_scale[:, r0:r1].clone(),
                                v_scale=cache.v_scale[:, r0:r1].clone(),
                                prompt_lengths=cache.prompt_lengths[r0:r1].clone())
        out = []
        for i in range(2):
            logits, c = tr.decode_step(params, cfg, toks[i, r0:r1], c)
            out.append(logits.float())
        return out, c

    chunks = dd._row_chunks(b, 16)
    assert len(chunks) == (2 if b == 17 else 3)
    before = dl.layer_swiglu_qkv_int8_stacked.launches
    got, kc = run()
    assert dl.layer_swiglu_qkv_int8_stacked.launches - before == 2 * cfg.n_layers * len(chunks)
    for r0, r1 in chunks:
        alone, ac = run(r0, r1)
        for g, a in zip(got, alone):
            assert torch.equal(g[r0:r1], a), (r0, r1)
        for attr in ("k", "v", "k_scale", "v_scale"):
            assert torch.equal(getattr(kc, attr)[:, r0:r1], getattr(ac, attr)), (r0, r1, attr)
    tile = dd._ff_tile(1024, 4096, params["layers"]["wqkv"]["q"].shape[2])
    monkeypatch.setattr(tr, "layer_swiglu_qkv_int8_stacked",
                        lambda *a, **k: dl.layer_swiglu_qkv_int8_plain(*a, **k, tile=tile))
    for fn in ("qkv_norm_int8_stacked", "dense_int8_stacked"):
        monkeypatch.setattr(tr, fn, getattr(dd, fn.replace("_stacked", "_plain")))
    ref, pc = run()
    torch.cuda.synchronize()
    for i, (g, r) in enumerate(zip(got, ref)):
        assert g.shape == (b, 1152) and torch.isfinite(g).all()
        ratio = ((g - r).abs() / (2e-3 + 2e-3 * r.abs())).max().item()
        assert ratio <= 1, f"step {i}: {ratio}"
    for attr in ("k", "v"):
        assert (getattr(kc, attr).int() - getattr(pc, attr).int()).abs().max() <= 1, attr


@pytest.mark.parametrize("b,L,d,F,layer,dtype,zero_row", [
    (8, 2, 2048, 8192, 1, torch.bfloat16, None),   # the Qwen3 layer
    (17, 3, 128, 256, 2, torch.float32, 5),        # one tile, two row passes, a zero row
    (4, 2, 512, 8192, 0, torch.float32, None),     # two 4096 tiles
])
def test_mlp_swiglu_int8_kernel(dev, b, L, d, F, layer, dtype, zero_row):
    gen = _gen(dev, b + d + F + 7)
    x = torch.randn((b, d), generator=gen, device=dev).to(dtype)
    if zero_row is not None:
        x[zero_row] = 0
    wgu, sgu = _int8_weights(gen, dev, L, d, 2 * F)
    wd, sd = _int8_weights(gen, dev, L, F, d)
    before = mlp_swiglu_int8_stacked.launches
    got = mlp_swiglu_int8_stacked(x, wgu, sgu, wd, sd, layer)
    ref = mlp_swiglu_int8_plain(x, wgu, sgu, wd, sd, layer)
    torch.cuda.synchronize()
    assert mlp_swiglu_int8_stacked.launches == before + 1
    _close(got, ref)
    if zero_row is not None:
        assert (got[zero_row] == 0).all()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("layer", [0, 2])
@pytest.mark.parametrize("b", [1, 8, 17, 32])
@pytest.mark.parametrize("width", list(TAIL_WIDTHS))
def test_mlp_swiglu_one_launch_is_bit_equal(dev, width, b, layer, dtype):
    """B8b's one launch (``csrc/tail_swiglu.cu`` ``mlp_swiglu_kernel``,
    counted in ``tc_launches``) at the T3 and Qwen3 widths, first and last
    layer, bf16 and f32 rows with a zero row: bit-equal to its plain version
    and to the old six-kernel chain (``chain=True``). 32 rows at the Qwen3
    width (hidden rows of 8 KB) do not fit beside a ring: the chain runs
    them, bit-equal all the same."""
    from vocalie_tts_tpu_torch.ops.decode_dense import mlp_swiglu_takes

    d, F, _, _ = TAIL_WIDTHS[width]
    _, _, _, wgu, sgu, wd, sd, _, _, _ = _tail_weights(dev, width)
    x = torch.randn((b, d), generator=_gen(dev, 200 * b + layer), device=dev).to(dtype)
    x[b // 2] = 0
    takes = mlp_swiglu_takes(b, d, F, card_sms(dev))
    assert takes is not (width == "qwen3" and b == 32)
    fn = mlp_swiglu_int8_stacked
    before = (fn.launches, fn.tc_launches)
    got = fn(x, wgu, sgu, wd, sd, layer)
    chain = fn(x, wgu, sgu, wd, sd, layer, chain=True)
    ref = mlp_swiglu_int8_plain(x, wgu, sgu, wd, sd, layer)
    torch.cuda.synchronize()
    assert (fn.launches - before[0], fn.tc_launches - before[1]) == (2, int(takes))
    assert got.shape == (b, d) and torch.isfinite(got).all() and (got[b // 2] == 0).all()
    assert torch.equal(got, ref), (got - ref).abs().max().item()
    assert torch.equal(got, chain), (got - chain).abs().max().item()


def test_mlp_swiglu_is_one_cuda_kernel_a_call(dev):
    """torch.profiler sees one CUDA kernel a B8b call at the Qwen3 layer
    (b 8) and six on the old chain, counted through ``_profiled_kernels``;
    50 calls in a row, layers 0 and 2 in turn, give the chain's bits each
    (nothing of the workspace is carried from one call to the next: the
    hidden's amax is written whole every call)."""
    _, _, _, wgu, sgu, wd, sd, _, _, _ = _tail_weights(dev, "qwen3")
    x = torch.randn((8, 2048), generator=_gen(dev, 8), device=dev).to(torch.bfloat16)
    args = (wgu, sgu, wd, sd)
    names = _profiled_kernels(lambda: mlp_swiglu_int8_stacked(x, *args, 1))
    assert len(names) == 1 and "mlp_swiglu_kernel" in names[0], names
    names = _profiled_kernels(lambda: mlp_swiglu_int8_stacked(x, *args, 1, chain=True))
    assert len(names) == 6 and not any("mlp_swiglu_kernel" in n for n in names), names
    want = [mlp_swiglu_int8_stacked(x, *args, layer, chain=True) for layer in (0, 2)]
    got = [mlp_swiglu_int8_stacked(x, *args, 2 * (i % 2)) for i in range(50)]
    torch.cuda.synchronize()
    bad = [i for i, y in enumerate(got) if not torch.equal(y, want[i % 2])]
    assert not bad, f"calls {bad} differ from the chain"


def test_untaken_mlp_swiglu_shapes_take_the_chain(dev):
    """33 rows at the T3 width and 24 at the Qwen3 width, which the one
    launch does not take (``mlp_swiglu_takes``): B8b runs the old chain,
    bit-equal to the plain version, and ``tc_launches`` stays."""
    from vocalie_tts_tpu_torch.ops.decode_dense import mlp_swiglu_takes

    for width, b in (("t3", 33), ("qwen3", 24)):
        d, F, _, _ = TAIL_WIDTHS[width]
        _, _, _, wgu, sgu, wd, sd, _, _, _ = _tail_weights(dev, width)
        x = torch.randn((b, d), generator=_gen(dev, b), device=dev).to(torch.bfloat16)
        assert not mlp_swiglu_takes(b, d, F, card_sms(dev))
        before = mlp_swiglu_int8_stacked.tc_launches
        got = mlp_swiglu_int8_stacked(x, wgu, sgu, wd, sd, 1)
        ref = mlp_swiglu_int8_plain(x, wgu, sgu, wd, sd, 1)
        torch.cuda.synchronize()
        assert mlp_swiglu_int8_stacked.tc_launches == before
        assert torch.equal(got, ref), (width, (got - ref).abs().max().item())


def test_dense_kernels_reject_bad_inputs(dev):
    x = torch.zeros((2, 256), device=dev)
    w = torch.zeros((1, 256, 384), dtype=torch.int8, device=dev)
    s = torch.ones((1, 1, 384), device=dev)
    with pytest.raises(ValueError, match="s_all"):
        dense_int8_stacked(x, w, s.double(), 0)
    with pytest.raises(ValueError, match="layer"):
        dense_int8_stacked(x, w, s, 1)
    with pytest.raises(ValueError, match="contiguous"):
        dense_int8_stacked(torch.zeros((256, 2), device=dev).t(), w, s, 0)
    with pytest.raises(ValueError, match="K % 32"):
        dense_int8_stacked(x[:, :200].contiguous(), w[:, :200].contiguous(), s, 0)


#: B3/B4's one launch: (label, norm, b, K, N, layer, x dtype, norm dtype,
#: zero row); the T3 and Qwen3 decode steps' prologue and heads, a
#: DENSE_FNS qkv, batch 1, 17 and 32, K 96, the last layer
DENSE_ONE_CASES = [
    ("b3-t3", True, 16, 1024, 3072, 1, torch.bfloat16, torch.float32, None),
    ("b3-qwen3", True, 8, 2048, 4096, 2, torch.bfloat16, torch.bfloat16, 3),
    ("b4-t3-head", False, 16, 1024, 1152, 0, torch.bfloat16, None, 5),
    ("b4-qwen3-head", False, 8, 2048, 2176, 0, torch.bfloat16, None, None),
    ("b4-qwen3-qkv", False, 8, 2048, 6144, 2, torch.bfloat16, None, None),
    ("b3-b1", True, 1, 1024, 3072, 2, torch.float32, torch.float32, None),
    ("b4-b1", False, 1, 2048, 2176, 0, torch.float32, None, None),
    ("b3-b17", True, 17, 1024, 3072, 1, torch.bfloat16, torch.bfloat16, 16),
    ("b4-b32", False, 32, 1024, 1152, 2, torch.float32, None, 0),
    ("b3-b32", True, 32, 2048, 4096, 2, torch.float32, torch.bfloat16, 31),
    ("b3-k96", True, 5, 96, 128, 2, torch.bfloat16, torch.float32, 2),
    ("b4-k96", False, 2, 96, 128, 1, torch.float32, None, None),
]


def _dense_one_args(dev, norm, b, K, N, layer, x_dtype, nw_dtype, zero_row, L=3):
    gen = _gen(dev, b * 131 + K + N + layer)
    x = (torch.randn((b, K), generator=gen, device=dev) * 3).to(x_dtype)
    if zero_row is not None:
        x[zero_row] = 0
    w, s = _int8_weights(gen, dev, L, K, N)
    nw = (1 + 0.1 * torch.randn((L, K), generator=gen, device=dev)).to(nw_dtype) if norm else None
    return x, nw, w, s


def _dense_one_call(args, layer, **kw):
    x, nw, w, s = args
    if nw is None:
        return dense_int8_stacked(x, w, s, layer, **kw)
    return qkv_norm_int8_stacked(x, nw, w, s, layer, eps=1e-5, **kw)


def _dense_one_plain(args, layer):
    x, nw, w, s = args
    if nw is None:
        return dense_int8_plain(x, w, s, layer)
    return qkv_norm_int8_plain(x, nw, w, s, layer, eps=1e-5)


@pytest.mark.parametrize("case", DENSE_ONE_CASES, ids=[c[0] for c in DENSE_ONE_CASES])
def test_dense_one_launch_is_bit_equal(dev, case):
    """B3's and B4's one launch (``csrc/dense_int8.cu``) against the plain
    version and the old three-kernel chain (``chain=True``), bit for bit;
    the one launch counted in ``tc_launches``."""
    _, norm, b, K, N, layer, x_dtype, nw_dtype, zero_row = case
    args = _dense_one_args(dev, norm, b, K, N, layer, x_dtype, nw_dtype, zero_row)
    assert dense_takes(b, K, N, card_sms(dev))
    wrapper = qkv_norm_int8_stacked if norm else dense_int8_stacked
    before = (wrapper.launches, wrapper.tc_launches)
    got = _dense_one_call(args, layer)
    chain = _dense_one_call(args, layer, chain=True)
    ref = _dense_one_plain(args, layer)
    torch.cuda.synchronize()
    assert (wrapper.launches, wrapper.tc_launches) == (before[0] + 2, before[1] + 1)
    assert got.shape == (b, N) and got.dtype == torch.float32
    assert torch.equal(got, ref), (got - ref).abs().max().item()
    assert torch.equal(got, chain), (got - chain).abs().max().item()
    if zero_row is not None:
        assert (got[zero_row] == 0).all()


@pytest.mark.parametrize("case", DENSE_ONE_CASES[:4], ids=[c[0] for c in DENSE_ONE_CASES[:4]])
def test_dense_one_launch_is_one_cuda_kernel_a_call(dev, case):
    """torch.profiler sees one CUDA kernel a B3 or B4 call at the decode
    shapes (the old chain launches three), counted through
    ``_profiled_kernels``."""
    _, norm, b, K, N, layer, x_dtype, nw_dtype, zero_row = case
    args = _dense_one_args(dev, norm, b, K, N, layer, x_dtype, nw_dtype, zero_row)
    names = _profiled_kernels(lambda: _dense_one_call(args, layer))
    assert len(names) == 1 and "dense_int8_kernel" in names[0], names
    names = _profiled_kernels(lambda: _dense_one_call(args, layer, chain=True))
    assert len(names) == 3 and not any("dense_int8_kernel" in n for n in names), names


@pytest.mark.parametrize("case", [DENSE_ONE_CASES[i] for i in (0, 2, 4, 9)],
                         ids=[DENSE_ONE_CASES[i][0] for i in (0, 2, 4, 9)])
def test_dense_one_launch_repeats_bit_equal(dev, case):
    """50 calls a case, layers 1 and 2 in turn, each bit-equal to the old
    chain at its layer: the split-K sums met across a cluster give the same
    bits every call."""
    _, norm, b, K, N, _, x_dtype, nw_dtype, zero_row = case
    args = _dense_one_args(dev, norm, b, K, N, 1, x_dtype, nw_dtype, zero_row)
    want = {layer: _dense_one_call(args, layer, chain=True) for layer in (1, 2)}
    got = [_dense_one_call(args, 1 + i % 2) for i in range(50)]
    torch.cuda.synchronize()
    bad = [i for i, y in enumerate(got) if not torch.equal(y, want[1 + i % 2])]
    assert not bad, f"calls {bad} differ from the chain"


@pytest.mark.parametrize("norm", [True, False], ids=["B3", "B4"])
def test_untaken_dense_shapes_take_the_chain(dev, norm):
    """33 rows, which the one launch does not take (``dense_takes``): the
    wrapper runs the old chain (3 CUDA kernels), within the gate of the
    plain version, and ``tc_launches`` stays."""
    args = _dense_one_args(dev, norm, 33, 1024, 1152, 1, torch.bfloat16,
                           torch.float32 if norm else None, 4)
    assert not dense_takes(33, 1024, 1152, card_sms(dev))
    wrapper = qkv_norm_int8_stacked if norm else dense_int8_stacked
    before = wrapper.tc_launches
    names = _cuda_kernels(lambda: _dense_one_call(args, 1))
    assert len(names) == 3 and not any("dense_int8_kernel" in n for n in names), names
    got = _dense_one_call(args, 1)
    torch.cuda.synchronize()
    assert wrapper.tc_launches == before
    _close(got, _dense_one_plain(args, 1))


# ── B9a, B9b, B9c ───────────────────────────────────────────────────────


@pytest.mark.parametrize("b,d,dq,dtype,const_row,layer", [
    (1, 1024, 3072, torch.bfloat16, None, 0),    # the XTTS prologue at batch 1
    (8, 1024, 3072, torch.bfloat16, 5, 23),      # the XTTS batch, last layer
    (17, 128, 384, torch.float32, 0, 1),         # two row passes
])
def test_qkv_lnorm_int8_kernel(dev, b, d, dq, dtype, const_row, layer):
    gen = _gen(dev, b + d + 2)
    L = layer + 1
    x = (torch.randn((b, d), generator=gen, device=dev) * 3 + 0.5).to(dtype)
    if const_row is not None:
        x[const_row] = 2.0   # LayerNorm gives the bias alone
    g = 1 + 0.1 * torch.randn((L, d), generator=gen, device=dev)
    nb = 0.1 * torch.randn((L, d), generator=gen, device=dev)
    w, s = _int8_weights(gen, dev, L, d, dq)
    before = qkv_lnorm_int8_stacked.launches
    got = qkv_lnorm_int8_stacked(x, g, nb, w, s, layer, eps=1e-5)
    ref = qkv_lnorm_int8_plain(x, g, nb, w, s, layer, eps=1e-5)
    torch.cuda.synchronize()
    assert qkv_lnorm_int8_stacked.launches == before + 1
    _close(got, ref)


#: B9a's one launch (``csrc/dense_int8.cu`` with the LayerNorm): (rows dtype,
#: gains and biases dtype, layer of 3): bf16 rows as the decode step hands
#: them with f32 LayerNorm parameters at layer 0, and f32 rows with bf16
#: parameters at the last layer
B9A_KINDS = {"bf16-rows-l0": (torch.bfloat16, torch.float32, 0),
             "f32-rows-l2": (torch.float32, torch.bfloat16, 2)}


def _b9a_args(dev, b, K, N, x_dtype, g_dtype, L=3):
    gen = _gen(dev, 7 * b + K + N)
    x = (torch.randn((b, K), generator=gen, device=dev) * 3 + 0.5).to(x_dtype)
    if b > 1:
        x[b // 2] = 2.0   # a constant row: LayerNorm gives the bias alone
    g = (1 + 0.1 * torch.randn((L, K), generator=gen, device=dev)).to(g_dtype)
    nb = (0.1 * torch.randn((L, K), generator=gen, device=dev)).to(g_dtype)
    w, s = _int8_weights(gen, dev, L, K, N)
    return x, g, nb, w, s


@pytest.mark.parametrize("kinds", list(B9A_KINDS))
@pytest.mark.parametrize("K,N", [(1024, 3072), (128, 384)], ids=["xtts", "k128"])
@pytest.mark.parametrize("b", [1, 3, 8, 17, 32])
def test_qkv_lnorm_one_launch_is_bit_equal(dev, b, K, N, kinds):
    """B9a's one launch against its plain version and the old three-kernel
    chain (``chain=True``), bit for bit: the XTTS layer (one slab a block)
    and K 128 (K split over clusters of 4), 1 to 32 rows (3 and 17: warps
    whose rows are not live still read the parts' sums); the one launch
    counted in ``tc_launches``."""
    x_dtype, g_dtype, layer = B9A_KINDS[kinds]
    args = _b9a_args(dev, b, K, N, x_dtype, g_dtype)
    assert dense_takes(b, K, N, card_sms(dev))
    before = (qkv_lnorm_int8_stacked.launches, qkv_lnorm_int8_stacked.tc_launches)
    got = qkv_lnorm_int8_stacked(*args, layer, eps=1e-5)
    chain = qkv_lnorm_int8_stacked(*args, layer, eps=1e-5, chain=True)
    ref = qkv_lnorm_int8_plain(*args, layer, eps=1e-5)
    torch.cuda.synchronize()
    assert (qkv_lnorm_int8_stacked.launches, qkv_lnorm_int8_stacked.tc_launches) == (
        before[0] + 2, before[1] + 1)
    assert got.shape == (b, N) and got.dtype == torch.float32
    assert torch.equal(got, ref), (got - ref).abs().max().item()
    assert torch.equal(got, chain), (got - chain).abs().max().item()


def test_qkv_lnorm_one_launch_is_one_cuda_kernel_a_call(dev):
    """torch.profiler sees one CUDA kernel a B9a call at the XTTS shape (the
    old chain launches three)."""
    args = _b9a_args(dev, 8, 1024, 3072, torch.bfloat16, torch.float32)
    names = _profiled_kernels(lambda: qkv_lnorm_int8_stacked(*args, 1, eps=1e-5))
    assert len(names) == 1 and "dense_int8_kernel" in names[0], names
    names = _profiled_kernels(lambda: qkv_lnorm_int8_stacked(*args, 1, eps=1e-5, chain=True))
    assert len(names) == 3 and not any("dense_int8_kernel" in n for n in names), names


def test_untaken_qkv_lnorm_shapes_take_the_chain(dev):
    """33 rows, which the one launch does not take: B9a runs the old chain
    (3 CUDA kernels) within the plain version's gate, and ``tc_launches``
    stays."""
    args = _b9a_args(dev, 33, 1024, 3072, torch.bfloat16, torch.float32)
    assert not dense_takes(33, 1024, 3072, card_sms(dev))
    before = qkv_lnorm_int8_stacked.tc_launches
    names = _cuda_kernels(lambda: qkv_lnorm_int8_stacked(*args, 1, eps=1e-5))
    assert len(names) == 3 and not any("dense_int8_kernel" in n for n in names), names
    got = qkv_lnorm_int8_stacked(*args, 1, eps=1e-5)
    torch.cuda.synchronize()
    assert qkv_lnorm_int8_stacked.tc_launches == before
    _close(got, qkv_lnorm_int8_plain(*args, 1, eps=1e-5))


def _gelu_tail_args(dev, b, L, d, F, Q, dtype, bias_dtype):
    gen = _gen(dev, b + d + F + Q)
    attn = torch.randn((b, d), generator=gen, device=dev) * 0.3
    attn[0] = 0   # a zero row: its o-projection is the bias alone
    x = torch.randn((b, d), generator=gen, device=dev).to(dtype)

    def vec(n, base=0.0):
        return base + 0.1 * torch.randn((L, n), generator=gen, device=dev)

    wo, wos = _int8_weights(gen, dev, L, d, d)
    wu, su = _int8_weights(gen, dev, L, d, F)
    wd, sd = _int8_weights(gen, dev, L, F, d)
    wq, sq = _int8_weights(gen, dev, L, d, Q)
    tail = (attn, x, wo, wos, vec(d).to(bias_dtype), vec(d, 1.0), vec(d), wu, su,
            vec(F).to(bias_dtype), wd, sd, vec(d).to(bias_dtype))
    return tail, (vec(d, 1.0), vec(d), wq, sq)


@pytest.mark.parametrize("b,L,d,F,Q,layer,dtype,bias_dtype", [
    (8, 3, 1024, 4096, 3072, 2, torch.bfloat16, torch.bfloat16),  # XTTS: two tiles, clamped
    (1, 2, 1024, 4096, 3072, 0, torch.bfloat16, torch.bfloat16),  # batch 1
    (17, 3, 128, 256, 384, 1, torch.float32, torch.float32),      # one tile, two row passes
    (4, 2, 512, 8192, 1536, 1, torch.float32, torch.bfloat16),    # two 4096 tiles
])
def test_tail_gelu_int8_kernels(dev, b, L, d, F, Q, layer, dtype, bias_dtype):
    """B9b and B9c on the same inputs; B9b's x_out is B9c's."""
    tail, nxt = _gelu_tail_args(dev, b, L, d, F, Q, dtype, bias_dtype)
    before = (tail_gelu_qkv_int8_stacked.launches, tail_gelu_int8_stacked.launches)
    x_out, qkv = tail_gelu_qkv_int8_stacked(*tail, *nxt, layer, eps=1e-5)
    x_c = tail_gelu_int8_stacked(*tail, layer, eps=1e-5)
    rx, rq = tail_gelu_qkv_int8_plain(*tail, *nxt, layer, eps=1e-5)
    rc = tail_gelu_int8_plain(*tail, layer, eps=1e-5)
    torch.cuda.synchronize()
    assert (tail_gelu_qkv_int8_stacked.launches, tail_gelu_int8_stacked.launches) == (
        before[0] + 1, before[1] + 1)
    assert x_out.shape == x_c.shape == (b, d) and qkv.shape == (b, Q)
    _close(x_out, rx)
    _close(qkv, rq)
    _close(x_c, rc)
    assert torch.equal(x_out, x_c)


#: B9d's cases: (b, L, d, F, layer, row dtype, fc bias dtype, zero row)
B9D_CASES = [
    (8, 3, 1024, 4096, 2, torch.float32, torch.float32, None),   # the XTTS width: two tiles
    (8, 2, 1024, 4096, 0, torch.bfloat16, torch.bfloat16, 3),    # bf16 rows, a zero row
    (17, 2, 128, 256, 1, torch.float32, torch.bfloat16, None),   # one tile, two row passes
    (1, 2, 1024, 4096, 1, torch.bfloat16, torch.bfloat16, None),  # batch 1
    (17, 2, 1024, 4096, 1, torch.bfloat16, torch.float32, None),  # two m16 tiles
    (32, 2, 1024, 4096, 1, torch.float32, torch.bfloat16, None),  # the most rows
]


def _b9d_args(dev, b, L, d, F, dtype, bias_dtype, zero_row):
    gen = _gen(dev, b + d + F + 11)
    x = torch.randn((b, d), generator=gen, device=dev).to(dtype)
    if zero_row is not None:
        x[zero_row] = 0   # the hidden is gelu(bu) alone
    wu, su = _int8_weights(gen, dev, L, d, F)
    wd, sd = _int8_weights(gen, dev, L, F, d)
    bu = (0.1 * torch.randn((L, F), generator=gen, device=dev)).to(bias_dtype)
    return x, wu, su, bu, wd, sd


@pytest.mark.parametrize("b,L,d,F,layer,dtype,bias_dtype,zero_row", B9D_CASES)
def test_mlp_gelu_int8_kernel(dev, b, L, d, F, layer, dtype, bias_dtype, zero_row):
    """B9d's one launch (``csrc/tail_gelu.cu``, counted in ``tc_launches``)
    bit-equal to its plain version and to the old six-kernel chain
    (``chain=True``)."""
    from vocalie_tts_tpu_torch.ops.decode_dense import mlp_gelu_takes

    args = _b9d_args(dev, b, L, d, F, dtype, bias_dtype, zero_row)
    assert mlp_gelu_takes(b, d, F, card_sms(dev))
    fn = mlp_gelu_int8_stacked
    before = (fn.launches, fn.tc_launches)
    got = fn(*args, layer)
    chain = fn(*args, layer, chain=True)
    ref = mlp_gelu_int8_plain(*args, layer)
    torch.cuda.synchronize()
    assert (fn.launches, fn.tc_launches) == (before[0] + 2, before[1] + 1)
    assert got.shape == (b, d) and torch.isfinite(got).all()
    assert torch.equal(got, ref), (got - ref).abs().max().item()
    assert torch.equal(got, chain), (got - chain).abs().max().item()


def test_mlp_gelu_is_one_cuda_kernel_a_call(dev):
    """torch.profiler sees one CUDA kernel a B9d call at the XTTS layer (the
    one-launch GELU body) and six on the old chain; 50 calls in a row, layers
    0 and 1 in turn, give the same bits each (nothing of the workspace is
    carried from one call to the next)."""
    args = _b9d_args(dev, 8, 2, 1024, 4096, torch.bfloat16, torch.bfloat16, None)
    names = _profiled_kernels(lambda: mlp_gelu_int8_stacked(*args, 1))
    assert len(names) == 1 and "tail_gelu_kernel" in names[0], names
    names = _profiled_kernels(lambda: mlp_gelu_int8_stacked(*args, 1, chain=True))
    assert len(names) == 6 and not any("tail_gelu_kernel" in n for n in names), names
    want = [mlp_gelu_int8_stacked(*args, layer, chain=True) for layer in (0, 1)]
    got = [mlp_gelu_int8_stacked(*args, i % 2) for i in range(50)]
    torch.cuda.synchronize()
    bad = [i for i, y in enumerate(got) if not torch.equal(y, want[i % 2])]
    assert not bad, f"calls {bad} differ from the chain"


def test_untaken_mlp_gelu_shapes_take_the_chain(dev):
    """33 rows, which the one launch does not take (``mlp_gelu_takes``): B9d
    runs the old chain within the plain version's gate, and
    ``tc_launches`` stays."""
    from vocalie_tts_tpu_torch.ops.decode_dense import mlp_gelu_takes

    args = _b9d_args(dev, 33, 2, 1024, 4096, torch.bfloat16, torch.bfloat16, None)
    assert not mlp_gelu_takes(33, 1024, 4096, card_sms(dev))
    before = mlp_gelu_int8_stacked.tc_launches
    got = mlp_gelu_int8_stacked(*args, 1)
    torch.cuda.synchronize()
    assert mlp_gelu_int8_stacked.tc_launches == before
    _close(got, mlp_gelu_int8_plain(*args, 1))


#: B9b's one-launch body at the XTTS layer: d_model 1024, d_ff 4096 (two
#: tiles of 2048), qkv 3072; three layers, so that the last one clamps
_GELU_WEIGHTS: dict = {}


def _gelu_one_args(dev, b, dtype, layer):
    """B9b's arguments at the XTTS layer: rows and biases in ``dtype`` (bf16
    or f32), f32 LayerNorm parameters, a zero attention row."""
    L, d, F, Q = 3, 1024, 4096, 3072
    if dtype not in _GELU_WEIGHTS:
        gen = _gen(dev, 1024 + F)

        def vec(n, base=0.0):
            return base + 0.1 * torch.randn((L, n), generator=gen, device=dev)

        wo, wos = _int8_weights(gen, dev, L, d, d)
        wu, su = _int8_weights(gen, dev, L, d, F)
        wd, sd = _int8_weights(gen, dev, L, F, d)
        wq, sq = _int8_weights(gen, dev, L, d, Q)
        _GELU_WEIGHTS[dtype] = ((wo, wos, vec(d).to(dtype), vec(d, 1.0), vec(d), wu, su,
                                 vec(F).to(dtype), wd, sd, vec(d).to(dtype)),
                                (vec(d, 1.0), vec(d), wq, sq))
    w, nxt = _GELU_WEIGHTS[dtype]
    gen = _gen(dev, 100 * b + layer)
    attn = torch.randn((b, d), generator=gen, device=dev) * 0.3
    attn[b // 2] = 0
    x = torch.randn((b, d), generator=gen, device=dev).to(dtype)
    return (attn, x, *w), nxt


def _gelu_chain(tail, nxt, layer):
    """B9b on the old 12-kernel chain (``vt_tail_gelu_int8``), as B9c runs."""
    tile = pick_tile(tail[10].shape[1], TILE_BUDGET, 2 * tail[1].shape[1])
    return _tail_gelu(*tail, nxt, layer, 1e-5, tile, chain=True)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("layer", [1, 2])
@pytest.mark.parametrize("b", [1, 8, 16, 17])
def test_tail_gelu_one_launch_equals_the_chain(dev, b, layer, dtype):
    """B9b's one launch (``csrc/tail_gelu.cu``) against the old chain, bit
    for bit, and within its gate against the plain version; rows and biases
    in bf16 and in f32, the last layer's qkv clamped to it."""
    tail, nxt = _gelu_one_args(dev, b, dtype, layer)
    assert gelu_takes(b, 1024, 1024, 4096, 3072, card_sms(dev))
    before = tail_gelu_qkv_int8_stacked.launches
    x_out, qkv = tail_gelu_qkv_int8_stacked(*tail, *nxt, layer, eps=1e-5)
    cx, cq = _gelu_chain(tail, nxt, layer)
    rx, rq = tail_gelu_qkv_int8_plain(*tail, *nxt, layer, eps=1e-5)
    torch.cuda.synchronize()
    assert tail_gelu_qkv_int8_stacked.launches == before + 2
    assert x_out.shape == (b, 1024) and qkv.shape == (b, 3072)
    assert torch.equal(x_out, cx), (x_out - cx).abs().max().item()
    assert torch.equal(qkv, cq), (qkv - cq).abs().max().item()
    _close(x_out, rx)
    _close(qkv, rq)


def _profiled_kernels(call):
    """``_cuda_kernels``, once more where the profiler saw no kernel at all:
    after many profiled windows in one process it has missed a whole call
    (chip_smoke.py counts such a call again in a fresh process)."""
    return _cuda_kernels(call) or _cuda_kernels(call)


def _cuda_kernels(call):
    from torch.profiler import ProfilerActivity, profile

    call()   # builds, plans and uploads the item table outside the profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    return [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
            and "memcpy" not in e.name.lower() and "memset" not in e.name.lower()]


def test_tail_gelu_is_one_cuda_kernel_a_call(dev):
    """torch.profiler sees one CUDA kernel for a B9b call at the XTTS layer
    (the old chain launches 12: ``test_untaken_gelu_shapes_take_the_chain``)."""
    tail, nxt = _gelu_one_args(dev, 8, torch.bfloat16, 1)
    names = _cuda_kernels(lambda: tail_gelu_qkv_int8_stacked(*tail, *nxt, 1, eps=1e-5))
    assert len(names) == 1 and "tail_gelu_kernel" in names[0], names


def test_untaken_gelu_shapes_take_the_chain(dev):
    """33 rows, which the one-launch GELU body does not take
    (``gelu_takes``): the wrapper runs the old chain (12 CUDA kernels for
    B9b, 9 for B9c), which agrees with the plain version."""
    tail, nxt = _gelu_tail_args(dev, 33, 2, 1024, 4096, 3072, torch.bfloat16, torch.bfloat16)
    assert not gelu_takes(33, 1024, 1024, 4096, 3072, card_sms(dev))
    names = _cuda_kernels(lambda: tail_gelu_qkv_int8_stacked(*tail, *nxt, 1, eps=1e-5))
    assert len(names) == 12 and not any("tail_gelu_kernel" in n for n in names), names
    x_out, qkv = tail_gelu_qkv_int8_stacked(*tail, *nxt, 1, eps=1e-5)
    rx, rq = tail_gelu_qkv_int8_plain(*tail, *nxt, 1, eps=1e-5)
    torch.cuda.synchronize()
    _close(x_out, rx)
    _close(qkv, rq)
    assert not gelu_takes(33, 1024, 1024, 4096, 0, card_sms(dev))
    names = _cuda_kernels(lambda: tail_gelu_int8_stacked(*tail, 1, eps=1e-5))
    assert len(names) == 9 and not any("tail_gelu_kernel" in n for n in names), names
    _close(tail_gelu_int8_stacked(*tail, 1, eps=1e-5), tail_gelu_int8_plain(*tail, 1, eps=1e-5))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("layer", [1, 2])
@pytest.mark.parametrize("b", [1, 8, 16, 17])
def test_tail_gelu_alone_one_launch_equals_the_chain(dev, b, layer, dtype):
    """B9c (the GELU tail without the next qkv) as the Q = 0 branch of the
    one-launch body: bit-equal to the old 9-kernel chain, within its gate
    against the plain version, and one CUDA kernel a call (counted through
    ``_profiled_kernels``: the profiler once saw no kernel at all for this
    case after the many profiled windows before it, while the launch
    counter showed the call launched)."""
    tail, _ = _gelu_one_args(dev, b, dtype, layer)
    assert gelu_takes(b, 1024, 1024, 4096, 0, card_sms(dev))
    before = tail_gelu_int8_stacked.launches
    x_out = tail_gelu_int8_stacked(*tail, layer, eps=1e-5)
    tile = pick_tile(4096, TILE_BUDGET, 2 * 1024)
    cx, none = _tail_gelu(*tail, None, layer, 1e-5, tile, chain=True)
    ref = tail_gelu_int8_plain(*tail, layer, eps=1e-5)
    torch.cuda.synchronize()
    assert tail_gelu_int8_stacked.launches == before + 2 and none is None
    assert x_out.shape == (b, 1024)
    assert torch.equal(x_out, cx), (x_out - cx).abs().max().item()
    _close(x_out, ref)
    before = tail_gelu_int8_stacked.launches
    names = _profiled_kernels(lambda: tail_gelu_int8_stacked(*tail, layer, eps=1e-5))
    assert tail_gelu_int8_stacked.launches > before
    assert len(names) == 1 and "tail_gelu_kernel" in names[0], names


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("b", [8, 16, 17])
def test_tail_gelu_alone_repeats_bit_equal(dev, b, dtype):
    """50 B9c calls of the one-launch body a case, layers 1 and 2 in turn,
    each bit-equal to the old chain's output at its layer: the Q = 0 branch
    (no fourth grid barrier; the down-projection's parts meet through flags
    that each call leaves at zero) gives the same bits every call."""
    tile = pick_tile(4096, TILE_BUDGET, 2 * 1024)
    args = {layer: _gelu_one_args(dev, b, dtype, layer)[0] for layer in (1, 2)}
    want = {layer: _tail_gelu(*t, None, layer, 1e-5, tile, chain=True)[0]
            for layer, t in args.items()}
    got = [tail_gelu_int8_stacked(*args[1 + i % 2], 1 + i % 2, eps=1e-5) for i in range(50)]
    torch.cuda.synchronize()
    bad = [i for i, x in enumerate(got) if not torch.equal(x, want[1 + i % 2])]
    assert not bad, f"calls {bad} differ from the chain"


def test_gelu_kernels_reject_bad_inputs(dev):
    tail, nxt = _gelu_tail_args(dev, 2, 2, 128, 256, 384, torch.float32, torch.float32)
    bad = list(tail)
    bad[4] = bad[4].double()
    with pytest.raises(ValueError, match="bo_all"):
        tail_gelu_int8_stacked(*bad, 0, eps=1e-5)
    with pytest.raises(ValueError, match="layer"):
        tail_gelu_qkv_int8_stacked(*tail, *nxt, 2, eps=1e-5)
    with pytest.raises(ValueError, match="nb_all"):
        qkv_lnorm_int8_stacked(tail[1], nxt[0], nxt[1].to(torch.bfloat16), nxt[2], nxt[3], 0,
                               eps=1e-5)
    with pytest.raises(ValueError, match="bu_all"):
        mlp_gelu_int8_stacked(tail[1], tail[7], tail[8], tail[9].double(), tail[10], tail[11], 0)


# ── B7 ──────────────────────────────────────────────────────────────────


def _b7_args(dev, seed, L, H, d, D, F, T, valid, bias_dtype, norm_dtype=torch.float32):
    gen = _gen(dev, seed)
    q0 = torch.randn((H, 1, d), generator=gen, device=dev)
    kn0, vn0 = (torch.randn((H, d), generator=gen, device=dev) for _ in range(2))
    x = torch.randn((1, D), generator=gen, device=dev) * 0.5
    k, v = (torch.randint(-127, 128, (L, 1, H, T, d), generator=gen, device=dev,
                          dtype=torch.int8) for _ in range(2))
    ks, vs = (((torch.rand((L, 1, H, T), generator=gen, device=dev) + 0.5) / 127)
              .to(torch.bfloat16) for _ in range(2))
    bias = torch.where(torch.arange(T, device=dev) < valid, 0.0, NEG).float()[None]
    wo, wos = _int8_weights(gen, dev, L, H * d, D)
    mw = (1 + 0.1 * torch.randn((L, D), generator=gen, device=dev)).to(norm_dtype)
    wgu, sgu = _int8_weights(gen, dev, L, D, 2 * F)
    wd, sd = _int8_weights(gen, dev, L, F, D)
    nw = (1 + 0.1 * torch.randn((L, D), generator=gen, device=dev)).to(norm_dtype)
    wq, sq = _int8_weights(gen, dev, L, D, 3 * H * d)
    bq = ((0.5 * torch.randn((L, 3 * H * d), generator=gen, device=dev)).to(bias_dtype)
          if bias_dtype is not None else None)
    ang = (valid + 7) / (10000.0 ** (torch.arange(0, d, 2, device=dev).float() / d))
    c, s = torch.cos(ang)[None], torch.sin(ang)[None]
    return (q0, kn0, vn0, x, k, v, ks, vs, bias, wo, wos, mw, wgu, sgu, wd, sd, nw, wq, sq, bq,
            torch.cat([c, c], -1), torch.cat([-s, s], -1))


F32, BF16 = torch.float32, torch.bfloat16


@pytest.mark.parametrize("L,H,d,D,F,T,valid,bias_dtype,norm_dtype", [
    (3, 4, 64, 256, 512, 128, 45, F32, F32),          # the CPU test's shapes
    (1, 4, 64, 256, 512, 640, 300, None, F32),        # one layer, masked tail
    (3, 16, 64, 1024, 4096, 640, 133, F32, BF16),     # full width, bf16 norms
    (3, 16, 64, 1024, 4096, 640, 383, BF16, F32),     # the streaming request's kind: bf16 bias
    (3, 2, 128, 256, 384, 128, 0, F32, F32),          # d 128, the whole cache masked
    (1, 8, 32, 512, 1024, 256, 256, None, F32),       # d 32, no slot masked
])
def test_decode_step_kernel(dev, L, H, d, D, F, T, valid, bias_dtype, norm_dtype):
    args = _b7_args(dev, L + H + T + valid, L, H, d, D, F, T, valid, bias_dtype, norm_dtype)
    kw = dict(sm_scale=d ** -0.5, eps=1e-5)
    before = decode_step_fused_packed.launches
    got = decode_step_fused_packed(*args, **kw)
    ref = decode_step_fused_plain(*args, **kw)
    torch.cuda.synchronize()
    assert decode_step_fused_packed.launches == before + 1
    assert got[0].shape == (1, D) and got[1].shape == got[2].shape == (L, H, d)
    for g, r in zip(got, ref):
        _close(g, r)


@pytest.mark.parametrize("valid,bias_dtype,norm_dtype", [
    (256, BF16, F32),     # a valid length on the 128-slot grid, bf16 q/k/v bias
    (383, F32, BF16),     # off the grid (the streaming request's), f32 bias, bf16 norms
    (640, None, F32),     # no slot masked, no q/k/v bias
])
def test_decode_step_kernel_at_full_width(dev, valid, bias_dtype, norm_dtype):
    """B7 at the CosyVoice LM's widths (16 heads of 64, d_model 1024, d_ff
    4096, a 640-slot cache: 4 splits a head) over 4 layers against its plain
    version: x_out and every layer's k/v rows."""
    L, H, d, D, F, T = 4, 16, 64, 1024, 4096, 640
    args = _b7_args(dev, valid + 4, L, H, d, D, F, T, valid, bias_dtype, norm_dtype)
    kw = dict(sm_scale=d ** -0.5, eps=1e-5)
    got = decode_step_fused_packed(*args, **kw)
    ref = decode_step_fused_plain(*args, **kw)
    torch.cuda.synchronize()
    for g, r in zip(got, ref):
        _close(g, r)
    for layer in range(L):
        _close(got[1][layer], ref[1][layer])
        _close(got[2][layer], ref[2][layer])


def test_decode_step_kernel_refuses_a_grid_past_residency(dev):
    """A cooperative grid larger than the card keeps resident is refused
    (cudaErrorCooperativeLaunchTooLarge): the wrapper raises, no fallback."""
    L, H, d, D, F, T = 1, 4, 64, 256, 512, 128
    args = _b7_args(dev, 5, L, H, d, D, F, T, 40, F32)
    most = max_resident_blocks(H, d, D, F, T)
    assert most >= torch.cuda.get_device_properties(dev).multi_processor_count
    ok = decode_step_fused_packed(*args, sm_scale=0.125, eps=1e-5, grid=most)
    _close(ok[0], decode_step_fused_plain(*args, sm_scale=0.125, eps=1e-5)[0])
    with pytest.raises(RuntimeError, match="decode_step"):
        decode_step_fused_packed(*args, sm_scale=0.125, eps=1e-5, grid=most + 1)
    torch.cuda.synchronize()


def test_one_launch_bodies_refuse_a_misaligned_input(dev):
    """B9b's and B7's C entries refuse an input that does not start on a
    16-byte boundary (their tiles and vectors come in 16-byte copies): the
    wrappers raise, nothing is launched, and the next call runs."""
    tail, nxt = _gelu_one_args(dev, 8, torch.float32, 1)
    before = tail_gelu_qkv_int8_stacked.launches
    with pytest.raises(RuntimeError, match="16-byte boundary"):
        tail_gelu_qkv_int8_stacked(_offset(tail[0], 1), *tail[1:], *nxt, 1, eps=1e-5)
    x_out, qkv = tail_gelu_qkv_int8_stacked(*tail, *nxt, 1, eps=1e-5)
    rx, rq = tail_gelu_qkv_int8_plain(*tail, *nxt, 1, eps=1e-5)
    torch.cuda.synchronize()
    assert tail_gelu_qkv_int8_stacked.launches == before + 2
    _close(x_out, rx)
    _close(qkv, rq)
    args = list(_b7_args(dev, 6, 1, 4, 64, 256, 512, 128, 40, F32))
    kw = dict(sm_scale=0.125, eps=1e-5)
    good = args[10]
    args[10] = _offset(good, 1)   # wos_all, 4-byte aligned only
    with pytest.raises(RuntimeError, match="16-byte boundary"):
        decode_step_fused_packed(*args, **kw)
    args[10] = good
    got = decode_step_fused_packed(*args, **kw)
    ref = decode_step_fused_plain(*args, **kw)
    torch.cuda.synchronize()
    for g, r in zip(got, ref):
        _close(g, r)


# ── B12 ─────────────────────────────────────────────────────────────────


def _b12_args(dev, seed, L, b, kv, g, d, T, D, F, prompt_pad, n_dec, norm_dtype=F32,
              masked_row=False):
    """B12's positional arguments (with ``layer`` left out) and its
    valid_len: the B1 case's cache and mask, random int8 weights."""
    gen = _gen(dev, seed)
    H = kv * g
    q = torch.randn((b, kv, g, d), generator=gen, device=dev)
    x = torch.randn((b, D), generator=gen, device=dev)
    k, v = (torch.randint(-127, 128, (L, b, kv, T, d), generator=gen, device=dev,
                          dtype=torch.int8) for _ in range(2))
    ks, vs = (((torch.rand((L, b, kv, T), generator=gen, device=dev) + 0.5) / 127)
              .to(torch.bfloat16) for _ in range(2))
    kn, vn = (torch.randn((b, kv, d), generator=gen, device=dev) for _ in range(2))
    lens = torch.randint(1, prompt_pad + 1, (b,), generator=gen, device=dev)
    pos = torch.arange(T, device=dev)[None, :]
    valid_len = prompt_pad + n_dec
    valid = (pos < lens[:, None]) | ((pos >= prompt_pad) & (pos < valid_len))
    if masked_row:
        valid[0] = False       # only the current token is left to row 0
    bias = torch.where(valid, 0.0, NEG).float()
    wo, wos = _int8_weights(gen, dev, L, H * d, D)
    mw = (1 + 0.1 * torch.randn((L, D), generator=gen, device=dev)).to(norm_dtype)
    wgu, sgu = _int8_weights(gen, dev, L, D, 2 * F)
    wd, sd = _int8_weights(gen, dev, L, F, D)
    nw = (1 + 0.1 * torch.randn((L, D), generator=gen, device=dev)).to(norm_dtype)
    wq, sq = _int8_weights(gen, dev, L, D, (H + 2 * kv) * d)
    return ((q, x, k, v, ks, vs, bias, kn, vn), valid_len,
            (wo, wos, mw, wgu, sgu, wd, sd, nw, wq, sq))


@pytest.mark.parametrize("L,b,kv,g,d,T,D,F,prompt_pad,n_dec,layer,norm_dtype,masked_row", [
    (2, 4, 2, 1, 64, 384, 256, 512, 100, 28, 0, F32, False),     # packed-like, valid 128
    (2, 4, 1, 2, 128, 384, 256, 512, 200, 57, 1, F32, False),    # GQA d 128, last layer
    (2, 16, 16, 1, 64, 640, 1024, 4096, 256, 160, 1, F32, True),  # the T3 layer, a masked row
    (2, 8, 8, 2, 128, 512, 2048, 8192, 256, 96, 0, BF16, False),  # the Qwen3 layer, bf16 norms
    (1, 1, 2, 8, 32, 128, 128, 384, 3, 2, 0, F32, False),        # b 1, g 8, d 32, K slices of 128
    (2, 3, 4, 1, 64, 256, 384, 768, 200, 56, 1, F32, False),     # valid_len == T, d_model 384
])
def test_decode_layer_kernel(dev, L, b, kv, g, d, T, D, F, prompt_pad, n_dec, layer, norm_dtype,
                             masked_row):
    head, valid_len, tail = _b12_args(dev, T + D + layer, L, b, kv, g, d, T, D, F, prompt_pad,
                                      n_dec, norm_dtype, masked_row)
    kw = dict(sm_scale=d ** -0.5, eps=1e-6)
    before = layer_swiglu_qkv_int8_stacked.launches
    got = layer_swiglu_qkv_int8_stacked(*head, layer, valid_len, *tail, **kw)
    ref = layer_swiglu_qkv_int8_plain(*head, layer, valid_len, *tail, **kw)
    torch.cuda.synchronize()
    assert layer_swiglu_qkv_int8_stacked.launches == before + 1
    assert got[0].shape == (b, D) and got[1].shape == (b, (kv * g + 2 * kv) * d)
    for g_, r in zip(got, ref):
        _close(g_, r)


@pytest.mark.parametrize("label,shape", [
    ("t3", (3, 16, 16, 1, 64, 640, 1024, 4096, 256)),
    ("qwen3", (3, 8, 8, 2, 128, 512, 2048, 8192, 256)),
])
@pytest.mark.parametrize("where,n_dec", [("first block", -200), ("across blocks", 97),
                                         ("block boundary", 128)])
def test_decode_layer_valid_len_cases(dev, label, shape, where, n_dec):
    """B12 at the T3 and Qwen3 layers with valid_len in the first 128-slot
    block (one item a pair), across blocks (its items' chains start at the
    prefix max of the pair's earlier blocks, merged in block order) and on
    a block boundary, at every layer (the last one's next qkv clamped):
    within 1e-5 · max|ref| of the plain version,
    and the pairs' flags left for the next call (every layer in a row)."""
    L, b, kv, g, d, T, D, F, prompt_pad = shape
    if n_dec < 0:
        prompt_pad, n_dec = 40, 8          # valid_len 48: one block
    head, valid_len, tail = _b12_args(dev, T + n_dec, L, b, kv, g, d, T, D, F, prompt_pad, n_dec)
    kw = dict(sm_scale=d ** -0.5, eps=1e-6)
    for layer in range(L):
        got = layer_swiglu_qkv_int8_stacked(*head, layer, valid_len, *tail, **kw)
        ref = layer_swiglu_qkv_int8_plain(*head, layer, valid_len, *tail, **kw)
        torch.cuda.synchronize()
        for g_, r in zip(got, ref):
            _close(g_, r)


@pytest.mark.parametrize("label,shape", [
    ("t3", (2, 16, 16, 1, 64, 640, 1024, 4096, 256, 160)),
    ("qwen3", (2, 8, 8, 2, 128, 512, 2048, 8192, 256, 96)),
])
def test_decode_layer_is_one_cuda_kernel_a_call(dev, label, shape):
    """torch.profiler sees one CUDA kernel for a B12 call at the T3 and the
    Qwen3 layer (the attention, the o-projection and the tail in one
    cooperative launch)."""
    L, b, kv, g, d, T, D, F, prompt_pad, n_dec = shape
    head, valid_len, tail = _b12_args(dev, 5, L, b, kv, g, d, T, D, F, prompt_pad, n_dec)
    kw = dict(sm_scale=d ** -0.5, eps=1e-6)
    names = _profiled_kernels(lambda: layer_swiglu_qkv_int8_stacked(*head, 1, valid_len, *tail,
                                                                     **kw))
    assert len(names) == 1 and "decode_layer_kernel" in names[0], names


def test_decode_layer_refuses_a_split_its_layout_does_not_hold(dev, monkeypatch):
    """The C entry takes the attention's split and slot layout from the plan
    (``layer_splits``, ``LayerPlan.slot`` and ``slot_end``) and refuses one
    its own layout does not hold: a slot_end or a slot size that is not its
    own, more warps than a block has, no slot. The wrapper raises; the
    plan's own split then runs."""
    from vocalie_tts_tpu_torch.ops import decode_layer as dl

    head, valid_len, tail = _b12_args(dev, 12, 1, 2, 2, 1, 64, 128, 256, 512, 40, 8)
    kw = dict(sm_scale=0.125, eps=1e-5)
    real = dl._layer_launch
    changes = (lambda p, s: (dataclasses.replace(p, slot_end=p.slot_end + 16), s),
               lambda p, s: (dataclasses.replace(p, slot=p.slot - 16), s),
               lambda p, s: (p, ((8, 4),) * len(s)),
               lambda p, s: (p, ((0, 1),) * len(s)))
    for change in changes:
        def launch(*a, change=change):
            plan, splits, table, ws = real(*a)
            return (*change(plan, splits), table, ws)

        monkeypatch.setattr(dl, "_layer_launch", launch)
        with pytest.raises(RuntimeError, match="decode_layer"):
            layer_swiglu_qkv_int8_stacked(*head, 0, valid_len, *tail, **kw)
    monkeypatch.undo()
    got = layer_swiglu_qkv_int8_stacked(*head, 0, valid_len, *tail, **kw)
    ref = layer_swiglu_qkv_int8_plain(*head, 0, valid_len, *tail, **kw)
    torch.cuda.synchronize()
    for g_, r in zip(got, ref):
        _close(g_, r)


def test_decode_layer_kernel_refuses_bad_inputs(dev):
    """A grid past residency (cudaErrorCooperativeLaunchTooLarge), d_head 96
    (a Wo tile holds no whole number of its heads), d_model 4096 (no launch
    takes its normed rows, not even at one row) and a wrong dtype are
    refused: the wrapper raises, no fallback. 17 rows, which one launch does
    not take, run as two launches (8 and 9 rows) within the plain version's
    tolerance."""
    head, valid_len, tail = _b12_args(dev, 9, 1, 2, 2, 1, 64, 128, 256, 512, 40, 8)
    kw = dict(sm_scale=0.125, eps=1e-5)
    most = b12_max_blocks(2, 2, 1, 64, 128, 256, 512, 384)
    assert most >= torch.cuda.get_device_properties(dev).multi_processor_count
    ok = layer_swiglu_qkv_int8_stacked(*head, 0, valid_len, *tail, **kw, grid=most)
    _close(ok[0], layer_swiglu_qkv_int8_plain(*head, 0, valid_len, *tail, **kw)[0])
    with pytest.raises(RuntimeError, match="decode_layer"):
        layer_swiglu_qkv_int8_stacked(*head, 0, valid_len, *tail, **kw, grid=most + 1)
    big, valid_len17, tail17 = _b12_args(dev, 10, 1, 17, 2, 1, 64, 128, 128, 256, 40, 8)
    before = layer_swiglu_qkv_int8_stacked.launches
    got17 = layer_swiglu_qkv_int8_stacked(*big, 0, valid_len17, *tail17, **kw)
    assert layer_swiglu_qkv_int8_stacked.launches == before + 2
    for g_, r in zip(got17, layer_swiglu_qkv_int8_plain(*big, 0, valid_len17, *tail17, **kw)):
        _close(g_, r)
    wide, valid_w, tail_w = _b12_args(dev, 12, 1, 2, 2, 1, 64, 128, 4096, 256, 40, 8)
    with pytest.raises(ValueError, match="no launch takes"):
        layer_swiglu_qkv_int8_stacked(*wide, 0, valid_w, *tail_w, **kw)
    h96, valid_len96, tail96 = _b12_args(dev, 11, 1, 2, 4, 1, 96, 128, 256, 512, 40, 8)
    with pytest.raises(ValueError, match="d_head"):
        layer_swiglu_qkv_int8_stacked(*h96, 0, valid_len96, *tail96, **kw)
    bad = list(head)
    bad[1] = bad[1].to(torch.bfloat16)
    with pytest.raises(ValueError, match="x"):
        layer_swiglu_qkv_int8_stacked(*bad, 0, valid_len, *tail, **kw)
    torch.cuda.synchronize()


# ── B13 ─────────────────────────────────────────────────────────────────


def _gn_close(got, ref):
    """One bf16 ulp of the plain value plus 1e-5: the kernel and the plain
    version sum the f32 moments in another order (and the kernel's SiLU is
    a few f32 ulps off the IEEE steps), then both round once."""
    g, r = got.float(), ref.float()
    ulp = torch.exp2(torch.floor(torch.log2(r.abs().clamp(min=2.0 ** -126))) - 7)
    excess = ((g - r).abs() - ulp - 1e-5).max().item()
    assert excess <= 0, f"worst excess {excess:.3e}"


@pytest.mark.parametrize("shape,groups,eps", [
    ((128, 16, 32, 128), 32, 1e-5),    # UNet level 0, C/G 4
    ((6, 4, 8, 1024), 32, 1e-5),       # level-2 skip concat, C/G 32
    ((3, 8, 16, 256), 32, 1e-5),       # C/G 8
    ((2, 64, 128, 64), 32, 1e-6),      # the VAE's level 0: C/G 2, large spatial, eps 1e-6
    ((1, 16, 32, 384), 32, 1e-5),      # batch of 1, C/G 12
    ((5, 7, 9, 96), 32, 1e-5),         # C/G 3, odd spatial
    ((3, 5, 36), 12, 1e-5),            # C % 8 = 4: 4-wide vectors
    ((4, 3, 30), 10, 1e-6),            # C % 4 = 2: 2-wide vectors
    ((2, 11, 15), 5, 1e-5),            # C odd: scalar loads
])
@pytest.mark.parametrize("pre_add,silu", [(False, False), (True, True), (True, False),
                                          (False, True)])
def test_group_norm_kernel(dev, shape, groups, eps, pre_add, silu):
    from vocalie_tts_tpu_torch.ops.groupnorm import group_norm_fused, group_norm_fused_plain

    gen = _gen(dev, sum(shape) + groups)
    c = shape[-1]
    x = (torch.randn(shape, generator=gen, device=dev) * 2 + 0.5).to(BF16)
    g = 1 + 0.2 * torch.randn((c,), generator=gen, device=dev)
    b = 0.1 * torch.randn((c,), generator=gen, device=dev)
    e = (0.3 * torch.randn((shape[0], c), generator=gen, device=dev)).to(BF16) if pre_add else None
    before = group_norm_fused.launches
    got = group_norm_fused(x, g, b, groups=groups, eps=eps, silu=silu, pre_add=e)
    row = e if e is not None else torch.zeros((shape[0], c), dtype=BF16, device=dev)
    ref = group_norm_fused_plain(x.reshape(shape[0], -1, c), row, g, b, groups=groups, eps=eps,
                                 silu=silu).reshape(shape)
    torch.cuda.synchronize()
    assert group_norm_fused.launches == before + 1
    assert got.dtype == BF16 and got.shape == x.shape
    _gn_close(got, ref)


def test_group_norm_kernel_rejects_bad_inputs(dev):
    from vocalie_tts_tpu_torch.ops.groupnorm import group_norm_fused

    x = torch.zeros((2, 4, 64), dtype=BF16, device=dev)
    g, b = torch.ones(64, device=dev), torch.zeros(64, device=dev)
    with pytest.raises(ValueError, match="bf16"):
        group_norm_fused(x.float(), g, b, groups=32)
    with pytest.raises(ValueError, match="contiguous"):
        group_norm_fused(torch.zeros((2, 64, 4), dtype=BF16, device=dev).transpose(1, 2), g, b,
                         groups=32)
    with pytest.raises(ValueError, match="pre_add"):
        group_norm_fused(x, g, b, groups=32, pre_add=torch.zeros((2, 64), device=dev))


#: the studio path's B13 shapes (chip_smoke.py GN_CASES): (shape, eps)
GN_STUDIO = {"unet_level0": ((128, 16, 32, 128), 1e-5), "unet_level2": ((128, 4, 8, 1024), 1e-5),
             "vae_level0": ((64, 64, 128, 64), 1e-6), "unet_level1": ((128, 8, 16, 384), 1e-5)}


def _gn_args(dev, shape, pre_add, seed=0):
    gen = _gen(dev, sum(shape) + seed)
    c = shape[-1]
    x = (torch.randn(shape, generator=gen, device=dev) * 2 + 0.5).to(BF16)
    g = 1 + 0.2 * torch.randn((c,), generator=gen, device=dev)
    b = 0.1 * torch.randn((c,), generator=gen, device=dev)
    e = (0.3 * torch.randn((shape[0], c), generator=gen, device=dev)).to(BF16) if pre_add else None
    return x, g, b, e


def _gn_route(dev, shape, eps, pre_add, silu, two_pass):
    """One B13 call against its plain version; the route it took must be
    the one-pass route, or the two-pass route where ``two_pass``."""
    from vocalie_tts_tpu_torch.ops.groupnorm import group_norm_fused, group_norm_fused_plain

    x, g, b, e = _gn_args(dev, shape, pre_add)
    c = shape[-1]
    before = group_norm_fused.launches, group_norm_fused.two_pass_launches
    got = group_norm_fused(x, g, b, groups=32, eps=eps, silu=silu, pre_add=e)
    row = e if e is not None else torch.zeros((shape[0], c), dtype=BF16, device=dev)
    ref = group_norm_fused_plain(x.reshape(shape[0], -1, c), row, g, b, groups=32, eps=eps,
                                 silu=silu).reshape(shape)
    torch.cuda.synchronize()
    assert (group_norm_fused.launches, group_norm_fused.two_pass_launches) == (
        before[0] + 1, before[1] + int(two_pass))
    _gn_close(got, ref)


@pytest.mark.parametrize("pre_add,silu", [(False, False), (True, True), (True, False),
                                          (False, True)])
@pytest.mark.parametrize("case", list(GN_STUDIO))
def test_group_norm_one_pass_at_the_studio_shapes(dev, case, pre_add, silu):
    shape, eps = GN_STUDIO[case]
    _gn_route(dev, shape, eps, pre_add, silu, two_pass=False)


@pytest.mark.parametrize("shape,two_pass", [
    ((1, 2048, 1024), True),    # 4 MB a row: past 16 blocks' shared memory
    ((2, 32, 64, 1024), True),
    ((1, 1536, 1024), False),   # 3 MB: 16 blocks of 192 KB, one an SM
])
@pytest.mark.parametrize("pre_add,silu", [(False, True), (True, False)])
def test_group_norm_large_rows(dev, shape, two_pass, pre_add, silu):
    """A row past what a cluster of 16 blocks holds takes the two-pass
    route; one that 16 blocks of one an SM hold takes the one-pass route."""
    from vocalie_tts_tpu_torch.ops.groupnorm import _sm_count, gn_plan

    s = shape[1] * (shape[2] if len(shape) == 4 else 1)
    assert (gn_plan(shape[0], s, shape[-1], 32, 8, _sm_count(0)) is None) == two_pass
    _gn_route(dev, shape, 1e-5, pre_add, silu, two_pass)


@pytest.mark.parametrize("case", list(GN_STUDIO))
def test_group_norm_is_one_cuda_kernel_a_call(dev, case):
    from vocalie_tts_tpu_torch.ops.groupnorm import group_norm_fused

    shape, eps = GN_STUDIO[case]
    x, g, b, e = _gn_args(dev, shape, True)
    names = _cuda_kernels(lambda: group_norm_fused(x, g, b, groups=32, eps=eps, silu=True,
                                                   pre_add=e))
    assert len(names) == 1 and "gn_one_pass" in names[0], names


def test_group_norm_one_pass_smem_matches_the_kernel(dev):
    """The planner's shared-byte formula is the kernel's (``vt_group_norm_smem``)."""
    from vocalie_tts_tpu_torch.ops.groupnorm import gn_one_pass_smem

    fn = _build.kernel("vt_group_norm_smem", [_build.I] * 4, restype=_build.LL)
    for rows, c, groups, vec in [(256, 128, 32, 8), (16, 1024, 32, 8), (745, 64, 32, 8),
                                 (64, 384, 32, 8), (7, 36, 12, 4), (11, 15, 5, 1),
                                 (1, 4096, 32, 8)]:
        assert fn(rows, c, groups, vec) == gn_one_pass_smem(rows, c, groups, vec)


@pytest.mark.parametrize("m,k,n", [(65536 // 64, 1152, 128), (17, 24, 16), (5, 12, 20),
                                   (300, 9 * 1536, 512)])
def test_int8_matmul_exact_on_the_card(dev, m, k, n):
    """The UNet's int8 convs sum s8 x s8 in int32 through torch._int_mm
    (with zero padding to its M > 16, K % 8, N % 8 rules): equal to the
    CPU's integer product."""
    from vocalie_tts_tpu_torch.models.common.unet2d import _int8_matmul

    gen = torch.Generator().manual_seed(m + k + n)
    a = torch.randint(-127, 128, (m, k), generator=gen, dtype=torch.int8)
    w = torch.randint(-127, 128, (k, n), generator=gen, dtype=torch.int8)
    got = _int8_matmul(a.to(dev), w.to(dev)).cpu()
    assert got.dtype == torch.int32 and torch.equal(got, a.int() @ w.int())


def test_int8_conv_gpu_equals_cpu(dev):
    """``_conv2d_int8`` on the card equals the CPU on the same inputs, bf16
    in and out (the scales divide and multiply in f32 the same way)."""
    from vocalie_tts_tpu_torch.models.common.unet2d import conv2d, conv_quantize_int8

    gen = torch.Generator().manual_seed(3)
    p = conv_quantize_int8({"w": torch.randn((3, 3, 64, 96), generator=gen) * 0.05,
                            "b": torch.randn((96,), generator=gen) * 0.1})
    x = torch.randn((4, 16, 32, 64), generator=gen).to(BF16)
    for stride, padding in ((1, "SAME"), (2, ((1, 1), (1, 1)))):
        want = conv2d(p, x, stride=stride, padding=padding)
        got = conv2d({k: v.to(dev) for k, v in p.items()}, x.to(dev), stride=stride,
                     padding=padding).cpu()
        assert torch.equal(got.view(torch.int16), want.view(torch.int16))
