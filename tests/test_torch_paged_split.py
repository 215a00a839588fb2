"""K5's split-and-merge arithmetic against ray_tpu's paged decode.

K5 (csrc/paged_attention.cu) cuts each sequence's keys into splits, writes
per split the unnormalised output O_i, its max m_i and its sum l_i, and
merges them as o = sum e^(m_i - M) O_i / sum e^(m_i - M) l_i over the live
splits; a sequence with no live split gives 0.
`ops.paged_attention._paged_split_reference` is that arithmetic in plain
PyTorch. Here it runs on the CPU at split sizes that cut inside a page and
at whole pages, with the same numpy inputs (seeded) going to the JAX
package's decode: its Pallas kernel in interpret mode
(RAY_TPU_FORCE_PALLAS=1, as tests/test_torch_ops.py runs it), or its XLA
reference where the Pallas kernel reads past a table row (a length past
the table).

Tolerance (f32): 2e-3 against JAX, as tests/test_torch_ops.py (sums in
another order); 1e-5 against the port's own gather version.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu import ops as jops
from ray_tpu_torch.ops import paged_attention as paged

D, PS, PPS, P = 128, 16, 4, 24  # a table row holds 64 keys
ATTN_TOL = dict(atol=2e-3, rtol=2e-3)
SELF_TOL = dict(atol=1e-5, rtol=1e-5)
SPLITS = [7, 24, 16, 64]  # 7 and 24 cut inside a page of 16


@pytest.fixture
def pallas(monkeypatch):
    monkeypatch.setenv("RAY_TPU_FORCE_PALLAS", "1")


def _inputs(kvh, lengths, seed):
    rs = np.random.RandomState(seed)
    kp = rs.randn(kvh, P, PS, D).astype(np.float32)
    vp = rs.randn(kvh, P, PS, D).astype(np.float32)
    q = rs.randn(len(lengths), 4, D).astype(np.float32)
    table = rs.permutation(np.arange(1, P))[:len(lengths) * PPS]
    return q, kp, vp, table.reshape(len(lengths), PPS).astype(np.int32), np.array(lengths,
                                                                                  np.int32)


def _jax(q, kp, vp, table, lengths, force_xla=False):
    return np.asarray(jops.paged_attention_decode(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(table),
        jnp.asarray(lengths), force_xla=force_xla))


def _split(q, kp, vp, table, lengths, split_keys):
    t = [torch.from_numpy(np.ascontiguousarray(a)) for a in (q, kp, vp, table, lengths)]
    return paged._paged_split_reference(*t, D ** -0.5, split_keys).numpy()


def _port_gather(q, kp, vp, table, lengths):
    t = [torch.from_numpy(np.ascontiguousarray(a)) for a in (q, kp, vp, table, lengths)]
    return paged._paged_reference(*t, D ** -0.5).numpy()


@pytest.mark.parametrize("split_keys", SPLITS)
@pytest.mark.parametrize("kvh", [1, 4])  # g = 4 and g = 1
def test_split_merge_matches_pallas(pallas, split_keys, kvh):
    # lengths 0 and 1, one split and two splits exactly, the whole table
    lengths = [0, 1, split_keys, min(2 * split_keys, PPS * PS), PPS * PS]
    q, kp, vp, table, ln = _inputs(kvh, lengths, seed=split_keys + kvh)
    got = _split(q, kp, vp, table, ln, split_keys)
    np.testing.assert_allclose(got, _jax(q, kp, vp, table, ln), **ATTN_TOL)
    np.testing.assert_allclose(got, _port_gather(q, kp, vp, table, ln), **SELF_TOL)
    assert not got[0].any()  # length 0: no live split gives exact zeros


@pytest.mark.parametrize("split_keys", SPLITS)
def test_length_past_the_table_reads_to_its_end(split_keys):
    # a finished slot riding out its span: every key of its row is visible,
    # none past it (the Pallas kernel would read the next row's pages, so
    # JAX's XLA reference is the oracle here)
    lengths = [PPS * PS + 1, 1000, PPS * PS, 3]
    q, kp, vp, table, ln = _inputs(4, lengths, seed=40 + split_keys)
    got = _split(q, kp, vp, table, ln, split_keys)
    np.testing.assert_allclose(got, _jax(q, kp, vp, table, ln, force_xla=True), **ATTN_TOL)
    np.testing.assert_allclose(got, _port_gather(q, kp, vp, table, ln), **SELF_TOL)


def test_every_split_empty_gives_zeros(pallas):
    q, kp, vp, table, ln = _inputs(4, [0, 0, 0], seed=50)
    got = _split(q, kp, vp, table, ln, 24)
    assert np.isfinite(got).all() and not got.any()
    np.testing.assert_array_equal(got, _jax(q, kp, vp, table, ln))


def test_default_split_is_the_kernels():
    # the wrapper sizes K5's workspace from DECODE_SPLIT_KEYS: it must be the
    # kernel's kSplitKeys (the C entry point refuses a smaller workspace)
    src = (paged.dispatch.CSRC_DIR / "paged_attention.cu").read_text()
    assert int(re.search(r"constexpr int kSplitKeys = (\d+);", src).group(1)) == \
        paged.DECODE_SPLIT_KEYS
    q, kp, vp, table, ln = _inputs(4, [0, 5, 64, 30], seed=60)
    t = [torch.from_numpy(a) for a in (q, kp, vp, table, ln)]
    np.testing.assert_allclose(paged._paged_split_reference(*t, D ** -0.5).numpy(),
                               _port_gather(q, kp, vp, table, ln), **SELF_TOL)
