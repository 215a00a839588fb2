"""K7's split-and-merge arithmetic against ray_tpu's speculative verify.

On the tensor cores (bf16, head_dim 64/128) K7 (csrc/paged_attention.cu)
cuts each sequence's keys into splits, writes per split and query row the
unnormalised output O_i, its max m_i and its sum l_i, and merges each
row's live splits, those starting below its key count min(positions[b] +
s + 1, pps * ps), as o = sum e^(m_i - M) O_i / sum e^(m_i - M) l_i.
`ops.paged_attention._verify_split_reference` is that arithmetic in plain
PyTorch. Here it runs on the CPU at split sizes that cut inside a page and
at whole pages, at positions on split edges +- 1, spans crossing a split,
spans past the table, inactive slots, g = 1 and g = 8, S = 1 and S = 65,
held against the port's gather version `_verify_reference` and both
against the JAX package's verify: its Pallas kernel in interpret mode
(RAY_TPU_FORCE_PALLAS=1, as tests/test_torch_spec.py runs it).

Tolerance (f32): 2e-3 against JAX, as tests/test_torch_spec.py (sums in
another order); 1e-5 against the port's own gather version.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu import ops as jops
from ray_tpu_torch.ops import paged_attention as paged

D, PS, PPS = 128, 16, 12  # a table row holds 192 keys
ATTN_TOL = dict(atol=2e-3, rtol=2e-3)
SELF_TOL = dict(atol=1e-5, rtol=1e-5)
SPLITS = [24, 64, 128]  # 24 cuts inside a page of 16
CTX = PPS * PS


def _cases(k):
    """name -> (S, H, KVH, positions, zero table) for splits of k keys."""
    return {
        # row 0's key count one short of a split edge, on it, one past it
        "split_edges": (5, 8, 2, [k - 2, k - 1, k, k + 1], False),
        # the span's rows cross a split edge (counts k - 2 .. k + 2, 2k ..)
        "span_crosses_a_split": (5, 8, 2, [k - 3, 2 * k - 1, 0, 7], False),
        # a span that ends past the table: no key past the row is read
        "span_past_the_table": (5, 8, 2, [CTX - 1, CTX - 3, CTX + 4, CTX - 5], False),
        # inactive engine slots: position 0 and an all-zero table row
        "inactive_slots": (5, 8, 2, [0, 0, 0, 0], True),
        "g1": (5, 2, 2, [k - 1, k, 3, CTX - 2], False),
        "g8": (5, 8, 1, [k - 1, k, 3, CTX - 2], False),
        "S65": (65, 8, 2, [0, k + 30, 100, CTX - 64], False),
    }


@pytest.fixture
def pallas(monkeypatch):
    monkeypatch.setenv("RAY_TPU_FORCE_PALLAS", "1")


def _inputs(S, H, KVH, positions, zero_table, seed):
    rs = np.random.RandomState(seed)
    B = len(positions)
    P = B * PPS + 1
    kp = rs.randn(KVH, P, PS, D).astype(np.float32)
    vp = rs.randn(KVH, P, PS, D).astype(np.float32)
    q = rs.randn(B, S, H, D).astype(np.float32)
    table = (1 + rs.permutation(B * PPS)).reshape(B, PPS).astype(np.int32)
    if zero_table:
        table[:] = 0
    return q, kp, vp, table, np.array(positions, np.int32)


def _torch(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("case", list(_cases(1)))
@pytest.mark.parametrize("split_keys", SPLITS)
def test_split_merge_matches_pallas_verify(pallas, split_keys, case):
    S, H, KVH, positions, zero_table = _cases(split_keys)[case]
    q, kp, vp, table, pos = _inputs(S, H, KVH, positions, zero_table, seed=split_keys + S + H)
    t = _torch(q, kp, vp, table, pos)
    got = paged._verify_split_reference(*t, D ** -0.5, split_keys).numpy()
    gather = paged._verify_reference(*t, D ** -0.5).numpy()
    want = np.asarray(jops.paged_attention_verify(*(jnp.asarray(a) for a in (q, kp, vp, table,
                                                                             pos))))
    np.testing.assert_allclose(got, gather, **SELF_TOL)
    np.testing.assert_allclose(got, want, **ATTN_TOL)
    np.testing.assert_allclose(gather, want, **ATTN_TOL)


@pytest.mark.parametrize("split_keys", SPLITS)
def test_one_row_span_is_the_decode_split(split_keys):
    # S = 1: row 0 of sequence b has positions[b] + 1 keys, K5's length
    q, kp, vp, table, pos = _inputs(1, 8, 2, [0, split_keys - 1, split_keys, CTX + 3], False,
                                    seed=70 + split_keys)
    t = _torch(q, kp, vp, table, pos)
    got = paged._verify_split_reference(*t, D ** -0.5, split_keys)[:, 0]
    lengths = t[4] + 1
    want = paged._paged_split_reference(t[0][:, 0].contiguous(), t[1], t[2], t[3], lengths,
                                        D ** -0.5, split_keys)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6, rtol=1e-6)


def test_default_split_is_the_kernels():
    # the wrapper sizes K7's workspace from VERIFY_SPLIT_KEYS: it must be the
    # kernel's kVerifySplitKeys (the C entry point refuses a smaller workspace)
    src = (paged.dispatch.CSRC_DIR / "paged_attention.cu").read_text()
    assert int(re.search(r"constexpr int kVerifySplitKeys = (\d+);", src).group(1)) == \
        paged.VERIFY_SPLIT_KEYS
    q, kp, vp, table, pos = _inputs(5, 8, 2, [0, 100, 130, 191], False, seed=80)
    t = _torch(q, kp, vp, table, pos)
    np.testing.assert_allclose(paged._verify_split_reference(*t, D ** -0.5).numpy(),
                               paged._verify_reference(*t, D ** -0.5).numpy(), **SELF_TOL)


@pytest.mark.parametrize("dtype,head_dim,chunk,verify", [
    (torch.bfloat16, 128, "paged_chunk_wgmma_kernel", "paged_verify_wgmma_kernel"),
    (torch.bfloat16, 64, "paged_chunk_wgmma_kernel", "paged_verify_wgmma_kernel"),
    (torch.bfloat16, 32, "paged_chunk_fma_kernel", "paged_verify_fma_kernel"),
    (torch.float32, 128, "paged_chunk_fma_kernel", "paged_verify_fma_kernel"),
])
def test_kernel_symbol_names_the_kernels_in_the_source(dtype, head_dim, chunk, verify):
    assert paged.kernel_symbol("paged_attention_chunk", dtype, head_dim) == chunk
    assert paged.kernel_symbol("paged_attention_verify", dtype, head_dim) == verify
    src = (paged.dispatch.CSRC_DIR / "paged_attention.cu").read_text()
    for name in (chunk, verify, "paged_combine_kernel"):
        assert re.search(rf"\b{name}\(", src), name
