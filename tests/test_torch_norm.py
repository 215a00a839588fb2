"""ray_tpu_torch.ops.norm (kernel K1, forward and backward) against
ray_tpu.ops.norm on the CPU.

The same numpy inputs (seeded) go through the JAX function, with its Pallas
forward forced on in interpret mode (RAY_TPU_FORCE_PALLAS=1, as
tests/test_ops.py runs it) and its closed-form backward under jax.grad, and
through the port's `rms_norm` under autograd, which on the CPU runs the
plain versions (`rms_norm_reference`, and `_rms_bwd` through
`rms_norm_bwd`). The CUDA kernels themselves are held against those plain
versions on the card (tests/test_torch_kernels.py, chip_smoke.py).

Tolerances: f32 forward 1e-5 (tests/test_torch_ops.py), f32 gradients 1e-4
(tests/test_torch_train.py:132); both packages sum in f32 in other orders.
The training mix (bf16 x, f32 w): y and dx are rounded to bf16 by both, from
f32 values that differ by that summation order, so they may land one bf16
ulp apart (2^-8 relative; rtol 2^-7 covers an ulp at any mantissa); dw is
f32 in both, 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu import ops as jops
from ray_tpu_torch import ops as tops
from ray_tpu_torch.ops import dispatch, norm

EPS = 1e-5
F32_TOL = dict(atol=1e-5, rtol=1e-5)
GRAD_TOL = dict(atol=1e-4, rtol=1e-4)
BF16_TOL = dict(atol=1e-6, rtol=2 ** -7)
# (shape of x): 2-D rows and a 3-D [B, T, D] block, D a multiple of 128 so
# the JAX package runs its Pallas kernel
SHAPES = [(8, 128), (2, 5, 256), (3, 4, 128)]


@pytest.fixture
def pallas(monkeypatch):
    monkeypatch.setenv("RAY_TPU_FORCE_PALLAS", "1")


def _np(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _inputs(shape, seed):
    D = shape[-1]
    return _np(*shape, seed=seed), 1.0 + 0.1 * _np(D, seed=seed + 1), _np(*shape, seed=seed + 2)


def _jax_grads(x, w, gy):
    """(y, dx, dw) of the JAX package's rms_norm at x, w under cotangent gy
    (x, w as jax arrays in their own dtypes, gy f32)."""
    def loss(x, w):
        return jnp.sum(jops.rms_norm(x, w, EPS).astype(jnp.float32) * gy)

    y = jops.rms_norm(x, w, EPS)
    dx, dw = jax.grad(loss, argnums=(0, 1))(x, w)
    return np.asarray(y.astype(jnp.float32)), np.asarray(dx.astype(jnp.float32)), np.asarray(dw)


def _torch_grads(x, w, gy):
    """(y, dx, dw) of the port's rms_norm under autograd, as f32 numpy."""
    x, w = x.detach().requires_grad_(True), w.detach().requires_grad_(True)
    y = tops.rms_norm(x, w, EPS)
    (y.float() * torch.from_numpy(gy)).sum().backward()
    return y.detach().float().numpy(), x.grad.float().numpy(), w.grad.float().numpy()


@pytest.mark.parametrize("shape", SHAPES)
def test_forward_matches_the_pallas_kernel(pallas, shape):
    x, w, _gy = _inputs(shape, seed=1)
    want = np.asarray(jops.rms_norm(jnp.asarray(x), jnp.asarray(w), EPS))
    got = tops.rms_norm(torch.from_numpy(x), torch.from_numpy(w), EPS).numpy()
    np.testing.assert_allclose(got, want, **F32_TOL)


@pytest.mark.parametrize("shape", SHAPES)
def test_f32_gradients_match_jax_grad(pallas, shape):
    x, w, gy = _inputs(shape, seed=10)
    want = _jax_grads(jnp.asarray(x), jnp.asarray(w), gy)
    got = _torch_grads(torch.from_numpy(x), torch.from_numpy(w), gy)
    np.testing.assert_allclose(got[0], want[0], **F32_TOL)
    np.testing.assert_allclose(got[1], want[1], **GRAD_TOL)
    np.testing.assert_allclose(got[2], want[2], **GRAD_TOL)


@pytest.mark.parametrize("shape", SHAPES)
def test_training_mix_bf16_x_f32_w_matches_jax(pallas, shape):
    # the training path's dtypes: bf16 activations, the f32 master scale
    x, w, gy = _inputs(shape, seed=20)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    jx = jnp.asarray(xb.float().numpy()).astype(jnp.bfloat16)  # the same bf16 values
    want = _jax_grads(jx, jnp.asarray(w), gy)
    got = _torch_grads(xb, torch.from_numpy(w), gy)
    np.testing.assert_allclose(got[0], want[0], **BF16_TOL)
    np.testing.assert_allclose(got[1], want[1], **BF16_TOL)
    assert want[2].dtype == np.float32
    np.testing.assert_allclose(got[2], want[2], **GRAD_TOL)


def test_training_mix_keeps_each_dtype():
    x = torch.from_numpy(_np(2, 3, 128, seed=30)).to(torch.bfloat16).requires_grad_(True)
    w = torch.ones(128, requires_grad=True)
    y = tops.rms_norm(x, w, EPS)
    y.float().sum().backward()
    assert (y.dtype, x.grad.dtype, w.grad.dtype) == (torch.bfloat16, torch.bfloat16,
                                                     torch.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rms_norm_bwd_on_the_cpu_is_the_plain_version(dtype):
    x, w, gy = (torch.from_numpy(a).to(dtype) for a in _inputs((2, 7, 128), seed=40))
    before = dispatch.launch_counts()
    dx, dw = norm.rms_norm_bwd(x, w, gy, EPS)
    want_dx, want_dw = norm._rms_bwd(x, w, gy, EPS)
    assert torch.equal(dx, want_dx) and torch.equal(dw, want_dw)
    assert dispatch.launch_counts() == before


def test_backward_on_the_cpu_takes_rms_bwd_and_counts_no_launch(monkeypatch):
    calls = []
    plain = norm._rms_bwd

    def spy(x, w, g, eps):
        calls.append((tuple(x.shape), eps))
        return plain(x, w, g, eps)

    monkeypatch.setattr(norm, "_rms_bwd", spy)
    x, w, gy = _inputs((4, 128), seed=50)
    before = dispatch.launch_counts()
    _torch_grads(torch.from_numpy(x), torch.from_numpy(w), gy)
    assert calls == [((4, 128), EPS)]
    assert dispatch.launch_counts() == before


def test_autograd_backward_reaches_the_module_level_wrapper(monkeypatch):
    # _RMSNorm.backward looks `rms_norm_bwd` up when it runs, so a wrapper
    # planted on the module (as chip_smoke.py plants its faults) is the one
    # that computes the gradients
    seen = []

    def planted(x, w, g, eps):
        seen.append(eps)
        return torch.full_like(x, 3.0), torch.full_like(w, 5.0)

    monkeypatch.setattr(norm, "rms_norm_bwd", planted)
    x = torch.from_numpy(_np(2, 3, 128, seed=60)).requires_grad_(True)
    w = torch.ones(128, requires_grad=True)
    tops.rms_norm(x, w, 1e-3).sum().backward()
    assert seen == [1e-3]
    assert torch.equal(x.grad, torch.full_like(x, 3.0))
    assert torch.equal(w.grad, torch.full_like(w, 5.0))


def test_no_grad_and_plain_tensors_skip_the_autograd_function():
    x = torch.from_numpy(_np(4, 128, seed=70))
    w = torch.ones(128, requires_grad=True)
    assert tops.rms_norm(x, torch.ones(128)).grad_fn is None
    with torch.no_grad():
        assert tops.rms_norm(x, w).grad_fn is None
    assert type(tops.rms_norm(x, w).grad_fn).__name__.startswith("_RMSNorm")


@pytest.mark.parametrize("dtype,D,offset,want", [
    (torch.bfloat16, 4096, 0, "vec"),
    (torch.float32, 4136, 0, "vec"),
    (torch.bfloat16, 1030, 0, "scalar"),   # a row of 2060 bytes
    (torch.float32, 1030, 0, "scalar"),    # 4120 bytes
    (torch.bfloat16, 4096, 1, "scalar"),   # a base one element past 16 bytes
    (torch.float32, 4096, 2, "scalar"),
])
def test_kernel_symbol_picks_the_vector_or_scalar_kernels(dtype, D, offset, want):
    # the rule of csrc/rms_norm.cu's entry points, which the card tests hold
    # against the kernel names the profiler records
    buf = torch.zeros(3 * D + 16, dtype=dtype)
    base = buf.data_ptr() % 16 // buf.element_size()
    start = (-base) % (16 // buf.element_size()) + offset  # first aligned element, then the offset
    x = buf[start:start + 3 * D].view(3, D)
    w = torch.ones(D, dtype=torch.float32)
    assert norm.kernel_symbol("rms_norm", x, w) == f"rms_norm_fwd_{want}_kernel"
    assert norm.kernel_symbol("rms_norm_bwd", x, w, x) == f"rms_norm_bwd_{want}_kernel"


def test_the_backward_is_a_counted_kernel_with_its_entry_point():
    assert "rms_norm_bwd" in dispatch.KERNELS and dispatch.launch_counts()["rms_norm_bwd"] >= 0
    # x, w, g, dx, dw, workspace, its rows, rows, D, eps, x dtype, w dtype, stream
    assert len(dispatch._SIGNATURES["rtt_rms_norm_bwd"]) == 13
    assert "rtt_rms_norm_bwd" in (dispatch.CSRC_DIR / "rms_norm.cu").read_text()
