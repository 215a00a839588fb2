"""ray_tpu_torch.ops against ray_tpu.ops.

The same numpy inputs (seeded) go through the JAX function, with its Pallas
kernel forced on in interpret mode (RAY_TPU_FORCE_PALLAS=1, as
tests/test_ops.py runs it; shapes the JAX kernel refuses run through its
XLA reference), and through the port's plain version on the CPU.

Tolerances (f32): rms_norm 1e-5; attention 2e-3, as tests/test_ops.py, because
the kernels sum in another order than the plain versions; rope 1e-6.

The CUDA kernels themselves are held against the plain versions on the
card by tests/test_torch_kernels.py and chip_smoke.py.
"""

import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu import ops as jops
from ray_tpu_torch import ops as tops
from ray_tpu_torch.ops import dispatch

D = 128
ATTN_TOL = dict(atol=2e-3, rtol=2e-3)


@pytest.fixture
def pallas(monkeypatch):
    monkeypatch.setenv("RAY_TPU_FORCE_PALLAS", "1")


def _np(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _pool(KVH, P, ps, seed):
    return _np(KVH, P, ps, D, seed=seed), _np(KVH, P, ps, D, seed=seed + 1)


class TestRmsNorm:
    @pytest.mark.parametrize("rows", [16, 8])
    def test_matches_pallas(self, pallas, rows):
        x, w = _np(rows, D, seed=1), 1.0 + 0.1 * _np(D, seed=2)
        want = np.asarray(jops.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5))
        got = tops.rms_norm(_t(x), _t(w), 1e-5).numpy()
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)

    def test_default_eps_and_dtype(self):
        x = _t(_np(4, D, seed=3)).to(torch.bfloat16)
        w = torch.ones(D, dtype=torch.bfloat16)
        y = tops.rms_norm(x, w)
        assert y.dtype == torch.bfloat16
        ref = tops.rms_norm_reference(x.float(), w.float(), 1e-6).to(torch.bfloat16)
        assert torch.equal(y, ref)


class TestRope:
    @pytest.mark.parametrize("with_positions", [False, True])
    def test_matches_jax(self, with_positions):
        x = _np(2, 6, 4, D, seed=4)
        jcos, jsin = jops.rope_frequencies(D, 64, 500000.0)
        tcos, tsin = tops.rope_frequencies(D, 64, 500000.0)
        np.testing.assert_allclose(tcos.numpy(), np.asarray(jcos), atol=1e-6)
        pos = np.array([[3, 4, 5, 6, 7, 8], [0, 10, 20, 30, 40, 50]], np.int32)
        jpos = jnp.asarray(pos) if with_positions else None
        tpos = _t(pos).long() if with_positions else None
        want = np.asarray(jops.apply_rope(jnp.asarray(x), jcos, jsin, jpos))
        got = tops.apply_rope(_t(x), tcos, tsin, tpos).numpy()
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)


class TestFlashAttention:
    # T=64 and T=100 are refused by the Pallas kernel (T % block, T < 128)
    # and run through the JAX package's XLA reference; T=256 runs the kernel
    @pytest.mark.parametrize("T", [64, 100, 256])
    @pytest.mark.parametrize("kvh", [1, 4])  # g = 4 and g = 1 with H = 4
    def test_matches_pallas(self, pallas, T, kvh):
        q, k, v = _np(1, T, 4, D, seed=5), _np(1, T, kvh, D, seed=6), _np(1, T, kvh, D, seed=7)
        want = np.asarray(jax.jit(jops.flash_attention)(jnp.asarray(q), jnp.asarray(k),
                                                         jnp.asarray(v)))
        got = tops.flash_attention(_t(q), _t(k), _t(v)).numpy()
        np.testing.assert_allclose(got, want, **ATTN_TOL)

    def test_non_causal_matches_reference(self):
        q, k, v = _np(2, 40, 4, D, seed=8), _np(2, 40, 2, D, seed=9), _np(2, 40, 2, D, seed=10)
        want = np.asarray(jops.mha_reference(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                             causal=False))
        got = tops.flash_attention(_t(q), _t(k), _t(v), causal=False).numpy()
        np.testing.assert_allclose(got, want, **ATTN_TOL)


class TestPagedAttention:
    @pytest.mark.parametrize("kvh", [1, 4])
    def test_decode_matches_pallas(self, pallas, kvh):
        # a length-0 slot (inactive engine slot -> zeros) and lengths that
        # are not multiples of the page size
        B, ps, pps, P = 4, 16, 4, 20
        kp, vp = _pool(kvh, P, ps, seed=11)
        q = _np(B, 4, D, seed=13)
        table = np.random.RandomState(14).permutation(np.arange(1, P))[:B * pps]
        table = table.reshape(B, pps).astype(np.int32)
        lengths = np.array([0, 5, 37, 64], np.int32)
        want = np.asarray(jops.paged_attention_decode(
            jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(table),
            jnp.asarray(lengths)))
        got = tops.paged_attention_decode(_t(q), _t(kp), _t(vp), _t(table), _t(lengths)).numpy()
        np.testing.assert_allclose(got, want, **ATTN_TOL)
        assert not got[0].any()  # length 0 gives zeros

    @pytest.mark.parametrize("start", [0, 16])
    @pytest.mark.parametrize("kvh", [1, 4])
    def test_chunk_matches_pallas(self, pallas, start, kvh):
        C, ps, pps, P = 16, 16, 4, 12
        kp, vp = _pool(kvh, P, ps, seed=15)
        q = _np(C, 4, D, seed=17)
        table = np.array([3, 7, 1, 9], np.int32)
        total = start + C  # < pps * ps
        want = np.asarray(jops.paged_attention_chunk(
            jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(table), start, total))
        got = tops.paged_attention_chunk(_t(q), _t(kp), _t(vp), _t(table), start, total).numpy()
        np.testing.assert_allclose(got, want, **ATTN_TOL)


class TestDispatch:
    def test_cpu_tensors_take_the_plain_version(self):
        before = dispatch.launch_counts()
        x = torch.randn(3, D)
        assert torch.equal(tops.rms_norm(x, torch.ones(D)),
                           tops.rms_norm_reference(x, torch.ones(D)))
        assert dispatch.launch_counts() == before

    def test_mixed_devices_raise(self):
        with pytest.raises(ValueError, match="mixed"):
            dispatch.use_kernel(torch.zeros(2), torch.zeros(2, device="meta"))

    # the attention kernels' 16-byte K/V loads: the wrappers refuse any
    # layout they cannot take, before a launch
    @pytest.mark.parametrize("case", ["aligned", "base_offset", "head_dim", "row_stride"])
    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    def test_kv_layout_check(self, case, dtype):
        buf = torch.zeros(4, 2 * D + 2, dtype=dtype)
        t = {"aligned": torch.zeros(4, 2, D, dtype=dtype)[:, 1],
             "base_offset": buf.view(-1)[1:4 * D + 1].view(4, D),
             "head_dim": torch.zeros(4, D + 2, dtype=dtype),
             "row_stride": buf[:, :D]}[case]
        if case == "aligned":
            dispatch.check_kv_layout("attn", t)
        else:
            with pytest.raises(ValueError, match="16-byte"):
                dispatch.check_kv_layout("attn", t)

    def test_build_without_nvcc_raises(self):
        if shutil.which("nvcc") is not None:
            pytest.skip("nvcc present: the build would run")
        with pytest.raises(RuntimeError, match="nvcc"):
            dispatch.build()

    def test_build_dir_is_keyed_by_sources(self):
        d = dispatch.build_dir()
        assert d.parent == dispatch.BUILD_ROOT and len(d.name) == 16
        assert d == dispatch.build_dir()
