"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA card (the kernels have no CPU mode) and skips
without one. This file imports neither JAX nor ray_tpu, so on a machine
with a card and no JAX it runs alone, without the suite's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py

Tolerances: f32 2e-3 as the CPU parity tests (sums in another order);
bf16 2e-2 + 1.6e-2 relative, two bf16 ulps, since kernel and plain version
each round their f32 results to bf16. The lse residual is f32 in both
dtypes: 1e-4 (f32) and 1e-3 (bf16 inputs, whose scores the kernel sums in
another order).
"""

import gc
import time

import numpy as np
import pytest
import torch

from ray_tpu_torch import EngineConfig, InferenceEngine, get_config, ops
from ray_tpu_torch.models import init_params
from ray_tpu_torch.ops import attention, dispatch, norm
from ray_tpu_torch.ops import paged_attention as paged
from ray_tpu_torch.serve.programs import WARM_RUNS, CapturedProgram, read_back

D = 128
pytestmark = [pytest.mark.cuda, pytest.mark.parametrize("dtype", [torch.float32,
                                                                  torch.bfloat16])]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _rand(shape, dtype, card):
    return torch.randn(shape, device=card).to(dtype)


def _close(got, want, dtype):
    tol = dict(atol=2e-3, rtol=2e-3) if dtype == torch.float32 else dict(atol=2e-2,
                                                                         rtol=1.6e-2)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), **tol)


def test_rms_norm(card, dtype):
    x, w = _rand((37, 4136), dtype, card), _rand((4136,), dtype, card)  # D % 128 != 0
    before = dispatch.launch_counts()["rms_norm"]
    _close(ops.rms_norm(x, w, 1e-5), ops.rms_norm_reference(x, w, 1e-5), dtype)
    assert dispatch.launch_counts()["rms_norm"] == before + 1


# K1 at the paths' widths (2560 training, 4096 serving), a tiny config's
# (64), a D that is not a multiple of 128 (4136) and one whose row is not a
# multiple of 16 bytes (1030: the scalar kernels); one row, a few rows (a
# block per row) and a training block's 8192 (warps per row, and CTAs that
# walk rows in the backward). `other_w`: w in the other dtype, (bf16, f32)
# as in training and (f32, bf16).
K1_D = [64, 1030, 2560, 4096, 4136]
K1_ROWS = [1, 37, 8192]


def _k1_inputs(rows, D, dtype, other_w, card):
    wdtype = dtype if not other_w else (torch.float32 if dtype == torch.bfloat16
                                        else torch.bfloat16)
    x, g = _rand((rows, D), dtype, card), _rand((rows, D), dtype, card)
    w = (1.0 + 0.1 * torch.randn(D, device=card)).to(wdtype)
    return x, w, g


@pytest.mark.parametrize("other_w", [False, True])
@pytest.mark.parametrize("rows", K1_ROWS)
@pytest.mark.parametrize("D", K1_D)
def test_rms_norm_forward_shapes(card, dtype, D, rows, other_w):
    x, w, _g = _k1_inputs(rows, D, dtype, other_w, card)
    y = norm.rms_norm(x, w, 1e-5)
    assert y.dtype == dtype
    _close(y, norm.rms_norm_reference(x, w, 1e-5), dtype)


@pytest.mark.parametrize("other_w", [False, True])
@pytest.mark.parametrize("rows", K1_ROWS)
@pytest.mark.parametrize("D", K1_D)
def test_rms_norm_backward_shapes(card, dtype, D, rows, other_w):
    x, w, g = _k1_inputs(rows, D, dtype, other_w, card)
    dx, dw = norm.rms_norm_bwd(x, w, g, 1e-5)
    want_dx, want_dw = norm._rms_bwd(x, w, g, 1e-5)
    assert (dx.dtype, dw.dtype) == (dtype, w.dtype)
    _close(dx, want_dx, dtype)
    _close(dw, want_dw, w.dtype)


@pytest.mark.parametrize("D", [9001, 20000])
def test_rms_norm_wide_rows_stream(card, dtype, D):
    # rows wider than the registers hold (9001: scalar kernels past 8192
    # forward and 2048 backward elements; 20000: vector kernels past 2048
    # forward and 1024 backward groups) stream the rest of the row and
    # read it again after the reduction
    x, w, g = _k1_inputs(3, D, dtype, False, card)
    _close(norm.rms_norm(x, w, 1e-5), norm.rms_norm_reference(x, w, 1e-5), dtype)
    dx, dw = norm.rms_norm_bwd(x, w, g, 1e-5)
    want_dx, want_dw = norm._rms_bwd(x, w, g, 1e-5)
    _close(dx, want_dx, dtype)
    _close(dw, want_dw, dtype)


def test_rms_norm_unaligned_bases_take_the_scalar_kernels(card, dtype):
    # contiguous slices one element past a 16-byte boundary: the 16-byte
    # loads cannot take them, so the entry points pick the scalar kernels,
    # which must agree as the vector kernels do
    rows, D = 37, 4096

    def shifted(t):
        buf = torch.empty(t.numel() + 8, dtype=t.dtype, device=card)
        out = buf[1:1 + t.numel()].view(t.shape)
        out.copy_(t)
        return out

    x, w, g = (shifted(t) for t in _k1_inputs(rows, D, dtype, False, card))
    assert norm.kernel_symbol("rms_norm", x, w) == "rms_norm_fwd_scalar_kernel"
    assert norm.kernel_symbol("rms_norm_bwd", x, w, g) == "rms_norm_bwd_scalar_kernel"
    names = _cuda_kernel_names(lambda: norm.rms_norm(x, w, 1e-5))
    assert any("rms_norm_fwd_scalar_kernel" in n for n in names), names
    names = _cuda_kernel_names(lambda: norm.rms_norm_bwd(x, w, g, 1e-5))
    assert any("rms_norm_bwd_scalar_kernel" in n for n in names), names
    assert any("rms_norm_dw_kernel" in n for n in names), names
    _close(norm.rms_norm(x, w, 1e-5), norm.rms_norm_reference(x, w, 1e-5), dtype)
    dx, dw = norm.rms_norm_bwd(x, w, g, 1e-5)
    want_dx, want_dw = norm._rms_bwd(x, w, g, 1e-5)
    _close(dx, want_dx, dtype)
    _close(dw, want_dw, dtype)
    # and aligned inputs reach the vector kernels
    xa, wa, ga = (t.clone() for t in (x, w, g))
    assert norm.kernel_symbol("rms_norm_bwd", xa, wa, ga) == "rms_norm_bwd_vec_kernel"
    names = _cuda_kernel_names(lambda: norm.rms_norm(xa, wa, 1e-5))
    assert any("rms_norm_fwd_vec_kernel" in n for n in names), names
    names = _cuda_kernel_names(lambda: norm.rms_norm_bwd(xa, wa, ga, 1e-5))
    assert any("rms_norm_bwd_vec_kernel" in n for n in names), names


@pytest.mark.parametrize("rows", [37, 8192])
def test_rms_norm_bwd_dw_is_deterministic(card, dtype, rows):
    # dw sums the CTAs' partial rows in a fixed order: no atomics, the
    # same bits from call to call
    x, w, g = _k1_inputs(rows, 2560, dtype, dtype == torch.bfloat16, card)
    dx1, dw1 = norm.rms_norm_bwd(x, w, g, 1e-5)
    dx2, dw2 = norm.rms_norm_bwd(x, w, g, 1e-5)
    assert torch.equal(dw1, dw2) and torch.equal(dx1, dx2)


def test_rms_norm_backward_counts_one_launch(card, dtype):
    x, w, g = _k1_inputs(64, 256, dtype, False, card)
    x.requires_grad_(True)
    w.requires_grad_(True)
    y = ops.rms_norm(x, w, 1e-5)
    before = dispatch.launch_counts()
    y.backward(g)
    after = dispatch.launch_counts()
    assert after["rms_norm_bwd"] == before["rms_norm_bwd"] + 1
    assert {k: v for k, v in after.items() if k != "rms_norm_bwd"} == {
        k: v for k, v in before.items() if k != "rms_norm_bwd"}
    want_dx, want_dw = norm._rms_bwd(x.detach(), w.detach(), g, 1e-5)
    _close(x.grad, want_dx, dtype)
    _close(w.grad, want_dw, dtype)


def test_rms_norm_bwd_refuses_what_the_kernel_cannot_take(card, dtype):
    x, w, g = _k1_inputs(8, 256, dtype, False, card)
    before = dispatch.launch_counts()
    with pytest.raises(ValueError, match="g must match"):
        norm.rms_norm_bwd(x, w, g[:4], 1e-5)
    with pytest.raises(ValueError, match="w must be"):
        norm.rms_norm_bwd(x, w[:128], g, 1e-5)
    with pytest.raises(ValueError, match="contiguous"):
        norm.rms_norm_bwd(x.t().contiguous().t(), w, g, 1e-5)
    with pytest.raises(ValueError, match="mixed"):
        norm.rms_norm_bwd(x, w.cpu(), g, 1e-5)
    assert dispatch.launch_counts() == before


# the T of the attention tests: the 64- and 128-row tiles' edges, a ragged T,
# and the training length, which runs at batch 1 (_batch)
T_EDGES = [1, 63, 64, 65, 100, 127, 128, 129, 257]


def _batch(T):
    return 1 if T >= 2048 else 2


@pytest.mark.parametrize("T", T_EDGES + [2048])
def test_flash_attention(card, dtype, T):
    B = _batch(T)
    q = _rand((B, T, 8, D), dtype, card)
    k, v = _rand((B, T, 2, D), dtype, card), _rand((B, T, 2, D), dtype, card)
    _close(ops.flash_attention(q, k, v), ops.mha_reference(q, k, v), dtype)


def test_flash_attention_reads_strided_views(card, dtype):
    qkv = _rand((1, 100, 12, D), dtype, card)  # q, k, v as views of one tensor
    q, k, v = qkv[:, :, :8], qkv[:, :, 8:10], qkv[:, :, 10:]
    _close(ops.flash_attention(q, k, v), ops.mha_reference(q, k, v), dtype)


def test_attention_wrappers_refuse_unaligned_kv(card, dtype):
    # K/V one element past a 16-byte boundary: the kernels' 16-byte loads
    # cannot take it, so the wrappers raise before any launch
    n = 2 * 40 * 16 * D
    kp = torch.zeros(n + 1, device=card, dtype=dtype)[1:].view(2, 40, 16, D)
    table = torch.ones((4, 8), device=card, dtype=torch.int32)
    lengths = torch.full((4,), 5, device=card, dtype=torch.int32)
    kv = torch.zeros((1, 64 * 2 * D + 1), device=card, dtype=dtype)[:, 1:].view(1, 64, 2, D)
    before = dispatch.launch_counts()
    with pytest.raises(ValueError, match="16-byte"):
        ops.paged_attention_decode(_rand((4, 8, D), dtype, card), kp, kp, table, lengths)
    with pytest.raises(ValueError, match="16-byte"):
        ops.paged_attention_chunk(_rand((8, 8, D), dtype, card), kp, kp, table[0], 0, 8)
    with pytest.raises(ValueError, match="16-byte"):
        ops.flash_attention(_rand((1, 64, 8, D), dtype, card), kv, kv)
    assert dispatch.launch_counts() == before


# K5's cases: (kv heads, g, pages per sequence, lengths). K5 cuts each
# sequence's keys into splits of paged.DECODE_SPLIT_KEYS (128) and merges
# them on the card: lengths at split edges +- 1, a sequence of 1024 keys
# alone, lengths past the table (read as the table's end), and g = 1 / 8.
# name -> (kv heads, g, pages a sequence, lengths, page size)
DECODE_CASES = {
    "engine_slots": (2, 4, 8, [0, 1, 31, 128], 16),
    "split_edges": (2, 4, 40, [127, 128, 129, 255, 256, 257, 0, 383], 16),
    "one_long_sequence": (8, 4, 64, [1024], 16),
    "past_the_table": (2, 4, 40, [641, 5000, 640, 639], 16),
    "g1": (4, 1, 40, [0, 129, 300, 640], 16),
    "g8": (1, 8, 40, [1, 128, 257, 500], 16),
    "g3": (4, 3, 40, [0, 129, 300, 640], 16),  # moe-1b's 12 heads over 4
    # pages of 8 tokens, as an engine with page_size=8 decodes an import:
    # 16 pages a split; lengths off the page edges and across split edges
    "page_size_8": (2, 4, 128, [0, 3, 9, 129, 255, 701, 1001, 1023], 8),
    "page_size_8_split_edges": (2, 4, 40, [127, 128, 129, 255, 256, 257, 7, 319], 8),
}


@pytest.mark.parametrize("case", sorted(DECODE_CASES))
def test_paged_decode(card, dtype, case):
    KVH, g, pps, lens, ps = DECODE_CASES[case]
    B = len(lens)
    P = B * pps + 1
    kp, vp = _rand((KVH, P, ps, D), dtype, card), _rand((KVH, P, ps, D), dtype, card)
    q = _rand((B, KVH * g, D), dtype, card)
    table = torch.randperm(P - 1, device=card)[:B * pps].view(B, pps).to(torch.int32) + 1
    lengths = torch.tensor(lens, device=card, dtype=torch.int32)
    before = dispatch.launch_counts()["paged_attention_decode"]
    got = ops.paged_attention_decode(q, kp, vp, table, lengths)
    assert dispatch.launch_counts()["paged_attention_decode"] == before + 1
    _close(got, paged._paged_reference(q, kp, vp, table, lengths, D ** -0.5), dtype)
    assert not got[lengths == 0].any()  # a length-0 slot gives exact zeros


def test_paged_decode_back_to_back(card, dtype):
    # two calls in flight on one stream, the second with other lengths: the
    # first call's workspace goes back to the caching allocator and is the
    # second's, which stream order makes safe
    kp, vp = _rand((2, 161, 16, D), dtype, card), _rand((2, 161, 16, D), dtype, card)
    q = _rand((4, 8, D), dtype, card)
    table = torch.randperm(160, device=card)[:160].view(4, 40).to(torch.int32) + 1
    la = torch.tensor([640, 0, 129, 5], device=card, dtype=torch.int32)
    lb = torch.tensor([1, 640, 0, 300], device=card, dtype=torch.int32)
    a = ops.paged_attention_decode(q, kp, vp, table, la)
    b = ops.paged_attention_decode(q, kp, vp, table, lb)
    _close(a, paged._paged_reference(q, kp, vp, table, la, D ** -0.5), dtype)
    _close(b, paged._paged_reference(q, kp, vp, table, lb, D ** -0.5), dtype)


@pytest.mark.parametrize("start", [0, 48])
def test_paged_chunk(card, dtype, start):
    kp, vp = _rand((2, 40, 16, D), dtype, card), _rand((2, 40, 16, D), dtype, card)
    q = _rand((40, 8, D), dtype, card)
    table = torch.randint(1, 40, (8,), device=card, dtype=torch.int32)
    got = ops.paged_attention_chunk(q, kp, vp, table, start, start + 40)
    _close(got, paged._chunk_reference(q, kp, vp, table, start, start + 40, D ** -0.5), dtype)


@pytest.mark.parametrize("S,g,positions", [
    (5, 4, [0, 10, 37, 100]),     # the engine's span: 20 rows of a 64-row tile
    (1, 4, [0, 1, 30, 127]),      # S = 1 is decode
    (2, 4, [3, 16, 15, 64]),
    (65, 4, [0, 5, 40, 60]),      # the config's widest span: five row tiles
    (5, 1, [7, 8, 9, 10]),
    (5, 4, [125, 127, 120, 0]),   # spans that end past the table
])
def test_paged_verify(card, dtype, S, g, positions):
    KVH, pps = 2, 8
    kp, vp = _rand((KVH, 40, 16, D), dtype, card), _rand((KVH, 40, 16, D), dtype, card)
    q = _rand((4, S, KVH * g, D), dtype, card)
    table = torch.randint(1, 40, (4, pps), device=card, dtype=torch.int32)
    pos = torch.tensor(positions, device=card, dtype=torch.int32)
    before = dispatch.launch_counts()["paged_attention_verify"]
    got = ops.paged_attention_verify(q, kp, vp, table, pos)
    assert dispatch.launch_counts()["paged_attention_verify"] == before + 1
    _close(got, paged._verify_reference(q, kp, vp, table, pos, D ** -0.5), dtype)
    if S == 1:
        _close(got[:, 0], ops.paged_attention_decode(q[:, 0].contiguous(), kp, vp, table,
                                                     pos + 1), dtype)


def test_paged_verify_inactive_slots_and_refusals(card, dtype):
    # inactive engine slots: position 0 and an all-zero table row (the
    # trash page); the output is never read but must be finite
    kp, vp = _rand((2, 40, 16, D), dtype, card), _rand((2, 40, 16, D), dtype, card)
    q = _rand((4, 5, 8, D), dtype, card)
    table = torch.zeros((4, 8), device=card, dtype=torch.int32)
    pos = torch.zeros((4,), device=card, dtype=torch.int32)
    got = ops.paged_attention_verify(q, kp, vp, table, pos)
    torch.cuda.synchronize()
    assert torch.isfinite(got.float()).all()
    _close(got, paged._verify_reference(q, kp, vp, table, pos, D ** -0.5), dtype)
    before = dispatch.launch_counts()
    with pytest.raises(ValueError, match="positions"):
        ops.paged_attention_verify(q, kp, vp, table, pos.long())
    with pytest.raises(ValueError, match="positions"):
        ops.paged_attention_verify(q, kp, vp, table[:2].contiguous(), pos)
    with pytest.raises(ValueError, match="contiguous"):
        ops.paged_attention_verify(q.transpose(1, 2).contiguous().transpose(1, 2), kp, vp,
                                   table, pos)
    n = 2 * 40 * 16 * D
    odd = torch.zeros(n + 1, device=card, dtype=dtype)[1:].view(2, 40, 16, D)
    with pytest.raises(ValueError, match="16-byte"):
        ops.paged_attention_verify(q, odd, odd, table, pos)
    assert dispatch.launch_counts() == before


# K6 and K7 at their edges. On the tensor cores (bf16, head_dim 64/128) K7
# cuts each sequence's keys into splits of paged.VERIFY_SPLIT_KEYS (128) and
# merges them on the card. K7: (S, kv heads, g, positions, zero table), a
# table of 24 pages of 16 (384 keys) per sequence.
VERIFY_EDGE_CASES = {
    "split_edges": (5, 2, 4, [126, 127, 128, 129], False),
    "span_crosses_a_split": (5, 2, 4, [125, 255, 0, 7], False),
    "span_past_the_table": (5, 2, 4, [383, 381, 388, 379], False),
    "inactive_slots": (5, 2, 4, [0, 0, 0, 0], True),
    "g1": (5, 4, 1, [127, 128, 3, 382], False),
    "g8": (5, 1, 8, [127, 128, 3, 382], False),
    "S65": (65, 2, 4, [0, 158, 100, 320], False),
    # moe-1b's heads (g = 3): a position's query heads straddle a 64-row tile
    "g3": (5, 4, 3, [127, 128, 3, 382], False),
    "g3_S2": (2, 4, 3, [0, 15, 16, 300], False),
}
# K6: (C, kv heads, g, start, total, zero table) on one such table: key
# tiles of 64 at +- 1, a ragged C, total below start + C, keys past the
# table, no visible key at all (exact zeros), g = 1 / 8, an all-zero table,
# and a grid wide enough for 128-row CTAs
CHUNK_EDGE_CASES = {
    "tile_edges": (65, 2, 4, 63, 128, False),
    "ragged_C": (100, 2, 4, 48, 148, False),
    "total_below_start_plus_C": (100, 2, 4, 48, 120, False),
    "past_the_table": (64, 2, 4, 360, 424, False),
    "no_visible_key": (16, 2, 4, 0, 0, False),
    "g1": (100, 4, 1, 30, 130, False),
    "g8": (100, 1, 8, 30, 130, False),
    "g3": (100, 4, 3, 30, 130, False),
    "g3_tile_edges": (65, 4, 3, 63, 128, False),
    "zero_table": (64, 2, 4, 0, 64, True),
    "wide_grid": (520, 8, 4, 0, 520, False),  # 17 x 8 tiles of 128 rows, keys past the table
}
EDGE_PPS = 24


def _paged_pool(KVH, B, head_dim, dtype, card, zero_table=False):
    P = B * EDGE_PPS + 1
    kp = _rand((KVH, P, 16, head_dim), dtype, card)
    vp = _rand((KVH, P, 16, head_dim), dtype, card)
    table = torch.randperm(P - 1, device=card)[:B * EDGE_PPS].view(B, EDGE_PPS).to(torch.int32) + 1
    if zero_table:
        table.zero_()
    return kp, vp, table


@pytest.mark.parametrize("head_dim", [64, D])
@pytest.mark.parametrize("case", sorted(VERIFY_EDGE_CASES))
def test_paged_verify_edges(card, dtype, case, head_dim):
    S, KVH, g, positions, zero_table = VERIFY_EDGE_CASES[case]
    B = len(positions)
    kp, vp, table = _paged_pool(KVH, B, head_dim, dtype, card, zero_table)
    q = _rand((B, S, KVH * g, head_dim), dtype, card)
    pos = torch.tensor(positions, device=card, dtype=torch.int32)
    before = dispatch.launch_counts()["paged_attention_verify"]
    got = ops.paged_attention_verify(q, kp, vp, table, pos)
    assert dispatch.launch_counts()["paged_attention_verify"] == before + 1
    _close(got, paged._verify_reference(q, kp, vp, table, pos, head_dim ** -0.5), dtype)


@pytest.mark.parametrize("head_dim", [64, D])
@pytest.mark.parametrize("case", sorted(CHUNK_EDGE_CASES))
def test_paged_chunk_edges(card, dtype, case, head_dim):
    C, KVH, g, start, total, zero_table = CHUNK_EDGE_CASES[case]
    kp, vp, table = _paged_pool(KVH, 1, head_dim, dtype, card, zero_table)
    q = _rand((C, KVH * g, head_dim), dtype, card)
    before = dispatch.launch_counts()["paged_attention_chunk"]
    got = ops.paged_attention_chunk(q, kp, vp, table[0], start, total)
    assert dispatch.launch_counts()["paged_attention_chunk"] == before + 1
    _close(got, paged._chunk_reference(q, kp, vp, table[0], start, total, head_dim ** -0.5),
           dtype)
    if total == 0:  # every row fully masked gives exact zeros
        assert not got.any()
    # start and total as int32 tensors on the card, apart (joined there) or
    # the halves of one [2] tensor (read in place): the same launch reads
    # the same [start, total] there, bit for bit the int form's result
    apart = [torch.tensor([x], device=card, dtype=torch.int32) for x in (start, total)]
    meta = torch.tensor([start, total], device=card, dtype=torch.int32)
    for form in (apart, [meta[:1], meta[1:]]):
        assert torch.equal(ops.paged_attention_chunk(q, kp, vp, table[0], *form), got)


def test_paged_verify_back_to_back(card, dtype):
    # two calls in flight on one stream, the second with other positions: on
    # the tensor cores the first call's split workspace goes back to the
    # caching allocator and is the second's, which stream order makes safe
    kp, vp, table = _paged_pool(2, 4, D, dtype, card)
    q = _rand((4, 5, 8, D), dtype, card)
    pa = torch.tensor([379, 0, 128, 5], device=card, dtype=torch.int32)
    pb = torch.tensor([1, 300, 0, 255], device=card, dtype=torch.int32)
    a = ops.paged_attention_verify(q, kp, vp, table, pa)
    b = ops.paged_attention_verify(q, kp, vp, table, pb)
    _close(a, paged._verify_reference(q, kp, vp, table, pa, D ** -0.5), dtype)
    _close(b, paged._verify_reference(q, kp, vp, table, pb, D ** -0.5), dtype)


@pytest.mark.parametrize("T", T_EDGES + [1024, 2048])
@pytest.mark.parametrize("g", [1, 4])
def test_flash_attention_lse(card, dtype, T, g):
    B = _batch(T)
    q = _rand((B, T, 8, D), dtype, card)
    k, v = _rand((B, T, 8 // g, D), dtype, card), _rand((B, T, 8 // g, D), dtype, card)
    before = dispatch.launch_counts()
    o, lse = ops.flash_attention_with_lse(q, k, v)
    want_o, want_lse = attention._fwd_reference_with_lse(q, k, v)
    _close(o, want_o, dtype)
    tol = 1e-4 if dtype == torch.float32 else 1e-3
    torch.testing.assert_close(lse, want_lse, atol=tol, rtol=tol)
    after = dispatch.launch_counts()
    assert after["flash_attention_lse"] == before["flash_attention_lse"] + 1


@pytest.mark.parametrize("T", T_EDGES + [1024, 2048])
@pytest.mark.parametrize("g", [1, 4])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_bwd(card, dtype, T, g, causal):
    B = _batch(T)
    q = _rand((B, T, 8, D), dtype, card)
    k, v = _rand((B, T, 8 // g, D), dtype, card), _rand((B, T, 8 // g, D), dtype, card)
    do = _rand((B, T, 8, D), dtype, card)
    o, lse = attention._fwd_reference_with_lse(q, k, v, causal)
    delta = attention._attention_delta(o, do)
    before = dispatch.launch_counts()
    dq = ops.flash_attention_bwd_dq(q, k, v, do, lse, delta, causal)
    dk, dv = ops.flash_attention_bwd_dkv(q, k, v, do, lse, delta, causal)
    _close(dq, attention._dq_reference(q, k, v, do, lse, delta, causal), dtype)
    want_dk, want_dv = attention._dkv_reference(q, k, v, do, lse, delta, causal)
    _close(dk, want_dk, dtype)
    _close(dv, want_dv, dtype)
    after = dispatch.launch_counts()
    for name in ("flash_attention_bwd_dq", "flash_attention_bwd_dkv"):
        assert after[name] == before[name] + 1


@pytest.mark.parametrize("T", [65, 129, 1024])
def test_flash_attention_group_of_three(card, dtype, T):
    # moe-1b's heads, 12 over 4: K2 with lse, K3 and K4 at g = 3
    q, do = _rand((2, T, 12, D), dtype, card), _rand((2, T, 12, D), dtype, card)
    k, v = _rand((2, T, 4, D), dtype, card), _rand((2, T, 4, D), dtype, card)
    o, lse = ops.flash_attention_with_lse(q, k, v)
    want_o, want_lse = attention._fwd_reference_with_lse(q, k, v)
    _close(o, want_o, dtype)
    tol = 1e-4 if dtype == torch.float32 else 1e-3
    torch.testing.assert_close(lse, want_lse, atol=tol, rtol=tol)
    delta = attention._attention_delta(want_o, do)
    _close(ops.flash_attention_bwd_dq(q, k, v, do, want_lse, delta),
           attention._dq_reference(q, k, v, do, want_lse, delta), dtype)
    dk, dv = ops.flash_attention_bwd_dkv(q, k, v, do, want_lse, delta)
    want_dk, want_dv = attention._dkv_reference(q, k, v, do, want_lse, delta)
    _close(dk, want_dk, dtype)
    _close(dv, want_dv, dtype)


def _forward_and_dq(q, k, v, do, dtype, causal=True):
    """K2 without and with lse and K3 against their plain versions."""
    _close(ops.flash_attention(q, k, v, causal), ops.mha_reference(q, k, v, causal), dtype)
    o, lse = ops.flash_attention_with_lse(q, k, v, causal)
    want_o, want_lse = attention._fwd_reference_with_lse(q, k, v, causal)
    _close(o, want_o, dtype)
    tol = 1e-4 if dtype == torch.float32 else 1e-3
    torch.testing.assert_close(lse, want_lse, atol=tol, rtol=tol)
    delta = attention._attention_delta(want_o, do)
    _close(ops.flash_attention_bwd_dq(q, k, v, do, want_lse, delta, causal),
           attention._dq_reference(q, k, v, do, want_lse, delta, causal), dtype)
    return want_lse, delta


@pytest.mark.parametrize("T", [1, 65, 129, 300])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_head_dim_64(card, dtype, T, causal):
    # the gpt2 configs' head_dim: the bf16 tiles' D = 64 instantiation
    d = 64
    q, do = _rand((2, T, 8, d), dtype, card), _rand((2, T, 8, d), dtype, card)
    k, v = _rand((2, T, 2, d), dtype, card), _rand((2, T, 2, d), dtype, card)
    lse, delta = _forward_and_dq(q, k, v, do, dtype, causal)
    dk, dv = ops.flash_attention_bwd_dkv(q, k, v, do, lse, delta, causal)
    want_dk, want_dv = attention._dkv_reference(q, k, v, do, lse, delta, causal)
    _close(dk, want_dk, dtype)
    _close(dv, want_dv, dtype)


def test_flash_attention_wide_grid(card, dtype):
    # ceil(T / 128) * H * B >= the SM count: K2's bf16 tile takes 128 query
    # rows per CTA (two warpgroups sharing one K/V ring); a ragged T
    B, T, H, KVH = 2, 1000, 20, 5
    q, do = _rand((B, T, H, D), dtype, card), _rand((B, T, H, D), dtype, card)
    k, v = _rand((B, T, KVH, D), dtype, card), _rand((B, T, KVH, D), dtype, card)
    _forward_and_dq(q, k, v, do, dtype)


def _cuda_kernel_names(fn):
    """Names of the CUDA kernels fn() launched, as torch.profiler saw them."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        # a margin on both sides of the launch, as chip_smoke.launched_kernels
        # keeps (without it a pass late in a process recorded no kernel)
        time.sleep(0.25)
        fn()
        torch.cuda.synchronize()
        time.sleep(0.25)
    return [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]


@pytest.mark.parametrize("head_dim", [64, D])
def test_attention_calls_launch_the_tile_their_dtype_selects(card, dtype, head_dim):
    # bf16 at head_dim 64/128 must reach the tensor-core (wgmma) kernels
    # (K2, K3 and K4), f32 the FMA tiles: read from the kernel names the profiler records
    q, do = _rand((1, 256, 8, head_dim), dtype, card), _rand((1, 256, 8, head_dim), dtype, card)
    k, v = _rand((1, 256, 2, head_dim), dtype, card), _rand((1, 256, 2, head_dim), dtype, card)
    lse = attention._fwd_reference_with_lse(q, k, v)[1]
    delta = torch.zeros_like(lse)
    calls = {
        "flash_attention": ("flash_attention", lambda: ops.flash_attention(q, k, v)),
        "flash_attention_with_lse": ("flash_attention",
                                     lambda: ops.flash_attention_with_lse(q, k, v)),
        "flash_attention_bwd_dq": ("flash_attention_bwd_dq",
                                   lambda: ops.flash_attention_bwd_dq(q, k, v, do, lse, delta)),
        "flash_attention_bwd_dkv": ("flash_attention_bwd_dkv",
                                    lambda: ops.flash_attention_bwd_dkv(q, k, v, do, lse, delta)),
    }
    for name, (op, fn) in calls.items():
        want = attention.kernel_symbol(op, dtype, head_dim)
        assert ("wgmma" in want) == (dtype == torch.bfloat16)
        other = want.replace("wgmma", "fma") if "wgmma" in want else want.replace("fma", "wgmma")
        names = _cuda_kernel_names(fn)
        assert any(want in n for n in names), (name, want, names)
        assert not any(other in n for n in names), (name, other, names)


@pytest.mark.parametrize("head_dim", [64, D])
def test_paged_calls_launch_the_tile_their_dtype_selects(card, dtype, head_dim):
    # K6 and K7 in bf16 at head_dim 64/128 must reach the tensor-core (wgmma)
    # kernels, f32 the FMA tiles; K7's wgmma kernel is followed by the
    # split merge
    kp, vp, table = _paged_pool(2, 4, head_dim, dtype, card)
    q7 = _rand((4, 5, 8, head_dim), dtype, card)
    q6 = _rand((256, 8, head_dim), dtype, card)
    pos = torch.tensor([20, 100, 300, 383], device=card, dtype=torch.int32)
    calls = {
        "paged_attention_chunk": lambda: ops.paged_attention_chunk(q6, kp, vp, table[0], 100,
                                                                   356),
        "paged_attention_verify": lambda: ops.paged_attention_verify(q7, kp, vp, table, pos),
    }
    for op, fn in calls.items():
        want = paged.kernel_symbol(op, dtype, head_dim)
        assert ("wgmma" in want) == (dtype == torch.bfloat16)
        other = want.replace("wgmma", "fma") if "wgmma" in want else want.replace("fma", "wgmma")
        names = _cuda_kernel_names(fn)
        assert any(want in n for n in names), (op, want, names)
        assert not any(other in n for n in names), (op, other, names)
        merged = any("paged_combine_kernel" in n for n in names)
        assert merged == (op == "paged_attention_verify" and "wgmma" in want), (op, names)


def test_backward_wrappers_refuse_what_the_kernels_cannot_take(card, dtype):
    q, k, v, do = (_rand((1, 64, 4, D), dtype, card) for _ in range(4))
    lse = delta = torch.zeros((1, 4, 64), device=card)
    wide = _rand((1, 64, 4, 2 * D), dtype, card)
    before = dispatch.launch_counts()
    with pytest.raises(ValueError, match="head_dim"):
        ops.flash_attention_bwd_dq(wide, wide, wide, wide, lse, delta)
    with pytest.raises(TypeError, match="dtype"):
        ops.flash_attention_bwd_dkv(q, k.float() if dtype != torch.float32 else k.bfloat16(),
                                    v, do, lse, delta)
    with pytest.raises(ValueError, match="unit stride"):
        ops.flash_attention_bwd_dq(q.transpose(2, 3).contiguous().transpose(2, 3), k, v, do,
                                   lse, delta)
    with pytest.raises(ValueError, match="float32"):
        ops.flash_attention_bwd_dkv(q, k, v, do, lse.to(dtype if dtype != torch.float32
                                                        else torch.bfloat16), delta)
    assert dispatch.launch_counts() == before


def test_gradients_flow_through_the_kernels(card, dtype):
    # the card's forward kernels write into fresh tensors through ctypes:
    # without the autograd Functions around them no gradient would reach
    # x, q, k or v; the gradients must match autograd of the plain versions
    torch.manual_seed(0)  # the same inputs whatever ran before
    x0 = _rand((2, 100, 256), dtype, card)
    w0 = 1.0 + 0.1 * torch.randn(256, device=card)
    wq = 0.05 * torch.randn(256, 8 * D, device=card).to(dtype)
    wkv = 0.05 * torch.randn(256, 2 * 2 * D, device=card).to(dtype)
    gy = _rand((2, 100, 8, D), dtype, card)

    def run(norm, attend):
        x, w = x0.clone().requires_grad_(True), w0.clone().requires_grad_(True)
        h = norm(x, w, 1e-5)
        q = (h @ wq).view(2, 100, 8, D)
        k, v = (h @ wkv).view(2, 100, 2, 2 * D).split(D, dim=-1)
        (attend(q, k.contiguous(), v.contiguous()).float() * gy.float()).sum().backward()
        return x.grad, w.grad

    before = dispatch.launch_counts()
    got = run(ops.rms_norm, ops.flash_attention)
    after = dispatch.launch_counts()
    want = run(ops.rms_norm_reference, ops.mha_reference)
    assert got[0] is not None and got[1] is not None
    for name in ("rms_norm", "rms_norm_bwd", "flash_attention", "flash_attention_lse",
                 "flash_attention_bwd_dq", "flash_attention_bwd_dkv"):
        assert after[name] == before[name] + 1, name
    _close(got[0], want[0], dtype)
    # w.grad[j] sums 200 rows of terms that the two paths round to bf16 at
    # different places, so its error scales with the terms, not with the
    # sum: an element near 0 is off by as much as the largest. On the H100
    # the gap read 0.05-0.08 at max |w.grad| 22-27 over six seeds (1e-5 in
    # f32): two bf16 ulps (2^-7) of the largest element leave 2.4x room.
    atol = 2e-2 if dtype == torch.float32 else 2 ** -7 * want[1].abs().max().item()
    torch.testing.assert_close(got[1], want[1], atol=atol, rtol=2e-2)


# ----------------------------------------------------------------- graphs
# The engine's captured programs (serve/programs.py CapturedProgram) on a
# small llama (2 layers, d_model 256, 4/2 heads of 64: K7 on its wgmma tile
# in bf16), speculation in draft mode with k = 3.

def _graph_engine(card, dtype):
    name = "bfloat16" if dtype == torch.bfloat16 else "float32"
    cfg = get_config("tiny-llama", d_model=256, dtype=name)
    params = init_params(cfg, seed=0, device=card, dtype=name)
    ecfg = dict(max_batch_size=4, page_size=16, max_pages=64, max_seq_len=128,
                prefill_buckets=(16,), prefill_chunk=32, decode_span=4, busy_span=2,
                cache_dtype=name, speculation={"mode": "draft", "num_speculative_tokens": 3})
    engine = InferenceEngine(params, cfg, EngineConfig(**ecfg), device=card)
    engine.warmup(buckets=[16])
    return engine


def _graph_inputs(engine, seed, temp=0.0, top_p=1.0):
    """Host arrays of one dispatch over the engine's batch: random tokens,
    positions and page tables (pages 1.. of the pool)."""
    ecfg = engine.ecfg
    B, pps = ecfg.max_batch_size, ecfg.pages_per_seq
    rs = np.random.RandomState(seed)
    tables = (1 + np.arange(B * pps, dtype=np.int32) % (ecfg.max_pages - 1)).reshape(B, pps)
    return (rs.randint(1, engine.cfg.vocab_size, B).astype(np.int32),
            rs.randint(0, 60, B).astype(np.int32), tables, np.full(B, temp, np.float32),
            np.full(B, top_p, np.float32), np.zeros(B, np.int32))


def _on_card(arrays, card):
    return [torch.as_tensor(a).to(card) for a in arrays]


def test_captured_programs_replay_their_eager_bodies(card, dtype):
    # each program's replay, then its body called eagerly on the same
    # inputs (greedy: the body rewrites the KV the replay wrote with the
    # same values before any query reads it): tokens identical; the
    # logprobs come from the same kernels in the same order, so the
    # tolerance (1e-5 nats) only allows for a library picking another
    # algorithm under capture
    engine = _graph_engine(card, dtype)
    args = _graph_inputs(engine, 0)
    seq, logps = engine._decode_span(4, *args, advanced=False)
    want = engine._decode_span_body(*_on_card(args, card), n_steps=4, sample=False,
                                    advanced=False)
    assert np.array_equal(seq, want[0].cpu().numpy())
    np.testing.assert_allclose(logps, want[1].cpu().numpy(), atol=1e-5, rtol=0)

    tokens, positions, tables, temps, top_ps, top_ks = args
    drafts = engine._spec.proposer._dispatch(engine, tokens, tokens, positions).clone()
    want = engine._spec.proposer._propose_body(*_on_card([tokens, tokens, positions], card))[0]
    assert torch.equal(drafts, want)
    toks_bs = torch.cat([torch.as_tensor(tokens).to(card)[:, None], drafts], dim=1)
    n_draft = np.full(4, 3, np.int32)
    verify_args = [toks_bs] + _on_card([positions, tables, n_draft, temps, top_ps, top_ks],
                                       card)
    committed, n_comm = engine._spec._verify(*verify_args, advanced=False, sample=False)
    committed, n_comm = committed.clone(), n_comm.clone()
    want = engine._spec._verify_body(*verify_args, sample=False, advanced=False)
    assert torch.equal(committed, want[0]) and torch.equal(n_comm, want[1])


def test_prefill_and_chunk_replays_write_the_pages_their_eager_bodies_write(card, dtype):
    # the bucketed prefill and the chunk (start 0, then mid-prompt) of the
    # engine and of the draft: a replay, then its body on the same static
    # inputs into a copy of the pools: pages bit-identical, logits within
    # 1e-5 (the same kernels in the same order)
    engine = _graph_engine(card, dtype)
    model, draft = engine._model, engine._spec.proposer
    pps = engine.ecfg.pages_per_seq
    rs = np.random.RandomState(5)

    def check(key, args, pools):
        saved = [p.clone() for p in pools]
        program = engine._program(key)
        outs = [o.clone() for o in program(*args)]
        after = [p.clone() for p in pools]
        for p, s in zip(pools, saved):
            p.copy_(s)
        want = program.fn(*program.inputs)
        for p, a in zip(pools, after):
            assert torch.equal(p, a), key
        for o, w in zip(outs, want):
            torch.testing.assert_close(o, w, atol=1e-5, rtol=0)

    table = np.zeros((1, pps), np.int32)
    table[0, :3] = [5, 9, 2]
    toks = rs.randint(1, engine.cfg.vocab_size, (1, 16)).astype(np.int32)
    check(("prefill", 16, 1), [torch.as_tensor(a) for a in (toks, np.array([11], np.int32),
                                                            table)],
          (model.k_pages, model.v_pages))
    chunk = rs.randint(1, engine.cfg.vocab_size, 32).astype(np.int32)
    for start in (0, 32):
        check(("chunk", 32), [torch.as_tensor(a) for a in (
            chunk, np.array([start], np.int32), table[0], np.array([31], np.int32))],
            (model.k_pages, model.v_pages))
        check(("draft_chunk", 32), [torch.as_tensor(chunk),
                                    torch.as_tensor(np.array([start], np.int32)),
                                    draft._tables[1]],
              (draft.model.k_pages, draft.model.v_pages))


def test_sampled_replays_draw_fresh_numbers(card, dtype):
    engine = _graph_engine(card, dtype)
    for top_p, advanced in ((1.0, False), (0.9, True)):
        args = _graph_inputs(engine, 1, temp=1.0, top_p=top_p)
        first = engine._decode_span(4, *args, advanced=advanced)[0]
        second = engine._decode_span(4, *args, advanced=advanced)[0]
        assert not np.array_equal(first, second), (top_p, first)
    tokens, positions, tables, temps, top_ps, top_ks = _graph_inputs(engine, 2, temp=1.0)
    toks_bs = torch.as_tensor(np.stack([tokens, tokens + 1, tokens + 2, tokens + 3], axis=1))
    verify_args = [toks_bs] + [torch.as_tensor(a) for a in (
        positions, tables, np.full(4, 3, np.int32), temps, top_ps, top_ks)]
    rounds = [engine._spec._verify(*verify_args, advanced=False, sample=True)[0].clone()
              for _ in range(2)]
    assert not torch.equal(rounds[0], rounds[1])


def test_replays_count_the_eager_launches(card, dtype):
    engine = _graph_engine(card, dtype)
    # spans 4 and 2 x three sampler modes, verify S = 2..4 x three, the
    # propose, the draft chunk, the chunk and the prefill at bucket 16
    assert len(engine._programs) == 6 + 3 * 3 + 1 + 3
    for key, program in engine._programs.items():
        dispatch.reset_launches()
        program.fn(*program.inputs)
        eager = {k: n for k, n in dispatch.launch_counts().items() if n}
        dispatch.reset_launches()
        program(*program.inputs)
        torch.cuda.synchronize()
        assert {k: n for k, n in dispatch.launch_counts().items() if n} == eager, key
        assert program.launches == eager, key
    L = engine.cfg.n_layers
    assert engine._programs[("decode", 4, False, False)].launches == {
        "rms_norm": 4 * (2 * L + 1), "paged_attention_decode": 4 * L}
    assert engine._programs[("verify", 3, True, True)].launches == {
        "rms_norm": 2 * L + 1, "paged_attention_verify": L}


def test_graph_replays_show_their_kernels_to_the_profiler(card, dtype):
    engine = _graph_engine(card, dtype)
    args = _graph_inputs(engine, 3)
    names = _cuda_kernel_names(lambda: engine._decode_span(2, *args, advanced=False))
    for stem in ("rms_norm_fwd_", "paged_decode_split_kernel"):
        assert any(stem in n for n in names), (stem, names)
    verify = paged.kernel_symbol("paged_attention_verify", dtype, 64)
    tokens, positions, tables, temps, top_ps, top_ks = args
    toks_bs = torch.as_tensor(np.stack([tokens] * 3, axis=1))
    verify_args = [toks_bs] + [torch.as_tensor(a) for a in (
        positions, tables, np.full(4, 2, np.int32), temps, top_ps, top_ks)]
    names = _cuda_kernel_names(lambda: engine._spec._verify(*verify_args, advanced=False,
                                                            sample=False))
    assert any(verify in n for n in names), (verify, names)


def test_no_garbage_collection_during_a_capture(card, dtype):
    # a collection inside a capture could destroy a dropped engine's graphs,
    # which invalidates the capture (seen once on the H100: 32 graphs of two
    # earlier tests' engines reset mid-capture, cuBLAS then failed); the
    # body sees the collector off only while it is being captured
    seen = []

    def body(x):
        seen.append(gc.isenabled())
        return (x * 2,)

    program = CapturedProgram(body, (torch.ones(4, device=card, dtype=dtype),))
    assert seen == [True] * WARM_RUNS + [False] and gc.isenabled()
    assert torch.equal(program(torch.full((4,), 3.0, device=card, dtype=dtype))[0],
                       torch.full((4,), 6.0, device=card, dtype=dtype))


def test_read_back_is_pinned_and_leaves_other_threads_enqueues_free(card, dtype):
    # read_back copies into pinned memory and waits on an event: while one
    # thread waits behind ~100 ms of work, another's enqueue of copies on
    # the same stream returns at once (a pageable readback holds it until
    # the card reaches the readback)
    import threading

    src = torch.randn(8, 16, device=card).to(dtype)
    (host,) = read_back(src)
    assert host.is_pinned() and torch.equal(host, src.cpu())
    xs = [torch.randn(256, 256, device=card) for _ in range(8)]
    ys = [torch.empty_like(x) for x in xs]
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    torch.cuda._sleep(10_000_000)
    b.record()
    b.synchronize()
    torch.cuda._sleep(int(10_000_000 * 100 / a.elapsed_time(b)))
    reader = threading.Thread(target=read_back, args=(src,))
    reader.start()
    time.sleep(0.01)
    t0 = time.perf_counter()
    for x, y in zip(xs, ys):
        y.copy_(x)
    enqueue_ms = 1e3 * (time.perf_counter() - t0)
    reader.join()
    torch.cuda.synchronize()
    assert enqueue_ms < 30, enqueue_ms
    assert all(torch.equal(x, y) for x, y in zip(xs, ys))


def test_update_params_under_live_replays(card, dtype):
    # a live weight update on the card: a stream decodes (self-speculation,
    # so the draft shares the live tensors) while the seed-1 tree, as host
    # numpy float32, is staged on a side stream, cast to the engine's dtype
    # and swapped in; afterwards the live weights and the f32 head copy
    # equal a fresh engine's on the same tree bit for bit, fresh prompts
    # give its tokens, and every launch around the update came from a
    # graph replay
    from ray_tpu_torch.models import params_from_numpy
    from ray_tpu_torch.models.transformer import lm_head_weight

    engine = _graph_engine(card, dtype)
    cfg, name = engine.cfg, "bfloat16" if dtype == torch.bfloat16 else "float32"

    def to_numpy(tree):
        return {k: to_numpy(v) if isinstance(v, dict) else v.numpy() for k, v in tree.items()}

    tree = to_numpy(init_params(cfg, seed=1, device="cpu", dtype="float32"))
    fresh = InferenceEngine(params_from_numpy(tree, device=card, dtype=name), cfg, engine.ecfg,
                            device=card)
    fresh.warmup()
    rs = np.random.RandomState(9)
    prompts = [rs.randint(1, cfg.vocab_size, n).tolist() for n in (11, 50)]
    try:
        eager = dict(dispatch.eager_launch_counts())
        req, stream = engine.open_stream(prompts[0], max_tokens=40, timeout_s=60)
        got = []
        for tok in stream:
            got.append(tok)
            if len(got) == 4:
                assert engine.update_params(tree) == 1
        assert req.error is None and len(got) == 40
        assert all(0 <= t < cfg.vocab_size for t in got)
        assert engine.update_stats["staged_bytes"] == sum(a.nbytes for a in _leaves(tree))
        for p in prompts:
            want = fresh.generate(p, max_tokens=12, timeout_s=60)["token_ids"]
            assert engine.generate(p, max_tokens=12, timeout_s=60)["token_ids"] == want
        assert dispatch.eager_launch_counts() == eager
        for a, b in zip(_leaves(engine.params), _leaves(fresh.params)):
            assert torch.equal(a, b)
        assert torch.equal(engine._model.head32, lm_head_weight(engine.params, cfg).float())
    finally:
        engine.stop()
        fresh.stop()


def _leaves(tree):
    return [x for v in tree.values() for x in (_leaves(v) if isinstance(v, dict) else [v])]


# The runtime (ray_tpu_torch.api) on the card: a GPU task runs K1 on CUDA
# tensors that arrived as ObjectRefs, and a tree of CUDA tensors crosses the
# object store by reference (the deliberate difference of ROADMAP C: an
# actor that writes into what it received writes into the owner's tensors).
RUNTIME = {"worker_processes": 0, "actor_processes": False}


def test_runtime_gpu_task_runs_k1_on_cuda_refs(card, dtype):
    import ray_tpu_torch as rt

    rt.shutdown()
    rt.init(num_cpus=2, system_config=RUNTIME)
    try:
        assert rt.cluster_resources()["GPU"] == torch.cuda.device_count()
        x, w = _rand((8, 4096), dtype, card), _rand((4096,), dtype, card)

        @rt.remote(num_gpus=1)
        def norm_task(a, b):
            return ops.rms_norm(a, b, 1e-5)

        before = dispatch.launch_counts()["rms_norm"]
        got = rt.get(norm_task.remote(rt.put(x), rt.put(w)), timeout=60)
        assert dispatch.launch_counts()["rms_norm"] == before + 1
        assert got.is_cuda
        _close(got, ops.rms_norm_reference(x, w, 1e-5), dtype)
    finally:
        rt.shutdown()


def test_runtime_passes_a_cuda_tree_by_reference(card, dtype):
    import ray_tpu_torch as rt

    rt.shutdown()
    rt.init(num_cpus=2, system_config=RUNTIME)
    try:
        tree = {"w": _rand((64, 64), dtype, card), "layers": [_rand((4,), dtype, card)]}
        ref = rt.put(tree)
        got = rt.get(ref, timeout=60)
        assert got is tree and got["w"].data_ptr() == tree["w"].data_ptr()

        @rt.remote(num_gpus=1)
        class Writer:
            def zero(self, t):
                t["w"].zero_()
                return t["w"].data_ptr()

        a = Writer.remote()
        assert rt.get(a.zero.remote(ref), timeout=60) == tree["w"].data_ptr()
        torch.cuda.synchronize()
        assert int(torch.count_nonzero(tree["w"])) == 0  # the owner's copy changed
    finally:
        rt.shutdown()
