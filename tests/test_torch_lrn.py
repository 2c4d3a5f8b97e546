"""The port's LRN (``veles_tpu_torch.ops.lrn``), forward and backward,
against the JAX package's fused Pallas LRN (interpret mode) and its
default XLA slices form, at the shapes of ``tests/test_lrn_fused.py``.

Tolerance: the window sum of five squares and the power differ in
order and formula (banded matmul and the rsqrt chain on the JAX kernel,
shifted slices and ``pow`` here), a few float32 ulps on outputs of
order 1: atol = 1e-6, the bound ``tests/test_lrn_fused.py`` holds the
Pallas kernel to. The backward adds a second window sum and a product
of three factors, a few more ulps on dx of order 1: atol = rtol = 2e-6.
bf16 inputs are held to bf16 resolution.
"""

import jax
import jax.numpy as jnp
import numpy
import pytest

torch = pytest.importorskip("torch")

from veles_tpu.nn.normalization import _lrn_slices  # noqa: E402
from veles_tpu.ops.lrn import _call_bwd, lrn_fused  # noqa: E402
from veles_tpu_torch.ops.lrn import (LRNFunction, lrn_backward,  # noqa
                                     lrn_backward_plain, lrn_forward,
                                     lrn_forward_plain)

BWD_TOL = dict(atol=2e-6, rtol=2e-6)
#: AlexNet's constants, and a case where the cross term is large
CONSTANTS = {"alexnet": (2.0, 1e-4, 0.75, 5), "cross_term": (1.0, 0.5,
                                                             0.75, 5)}

SHAPES = [(4, 7, 7, 96), (2, 5, 5, 256), (3, 9, 9, 64), (2, 3, 3, 32)]


def _x(shape, seed=7, scale=1.0):
    return (numpy.random.RandomState(seed).randn(*shape) * scale).astype(
        numpy.float32)


@pytest.mark.parametrize("shape", SHAPES)
def test_matches_pallas_lrn_interpret(shape):
    x = _x(shape)
    want = lrn_fused(jnp.asarray(x), 2.0, 1e-4, 0.75, 5, True)
    got = lrn_forward(torch.from_numpy(x), 2.0, 1e-4, 0.75, 5)
    numpy.testing.assert_allclose(got.numpy(), numpy.asarray(want),
                                  atol=1e-6)


@pytest.mark.parametrize("shape", SHAPES)
def test_matches_xla_slices(shape):
    x = _x(shape, seed=8, scale=3.0)
    want = _lrn_slices(jnp.asarray(x))
    got = lrn_forward(torch.from_numpy(x))
    numpy.testing.assert_allclose(got.numpy(), numpy.asarray(want),
                                  atol=1e-6)


def test_generic_beta_and_window():
    """beta != 3/4 takes the exp/log form; n = 3 a narrower window."""
    x = _x((2, 4, 4, 48), seed=9, scale=2.0)
    kw = dict(k=1.0, alpha=2e-4, beta=0.5, n=3)
    got = lrn_forward(torch.from_numpy(x), **kw).numpy()
    numpy.testing.assert_allclose(
        got, numpy.asarray(lrn_fused(jnp.asarray(x), 1.0, 2e-4, 0.5, 3,
                                     True)), atol=1e-6)
    numpy.testing.assert_allclose(
        got, numpy.asarray(_lrn_slices(jnp.asarray(x), **kw)), atol=1e-6)


def test_bfloat16_in_float32_math():
    xf = _x((2, 6, 6, 96), seed=10)
    x16 = torch.from_numpy(xf).to(torch.bfloat16)
    got = lrn_forward(x16)
    assert got.dtype == torch.bfloat16
    want = lrn_fused(jnp.asarray(xf, jnp.bfloat16), 2.0, 1e-4, 0.75, 5,
                     True)
    numpy.testing.assert_allclose(
        got.float().numpy(), numpy.asarray(want.astype(jnp.float32)),
        atol=2e-2, rtol=2e-2)


def test_even_window_and_strided_input_rejected():
    x = torch.from_numpy(_x((2, 3, 3, 16)))
    with pytest.raises(ValueError, match="odd"):
        lrn_forward(x, n=4)
    with pytest.raises(ValueError, match="channels-last"):
        # NHWC shape over NCHW memory: what a conv without
        # channels_last memory would hand on
        lrn_forward(x.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1))


def test_cpu_tensors_take_the_plain_version_without_counting():
    x = torch.from_numpy(_x((2, 3, 3, 32)))
    before = lrn_forward.launches
    before_forms = dict(lrn_forward.launches_by_form)
    assert torch.equal(lrn_forward(x), lrn_forward_plain(x))
    assert lrn_forward.launches == before
    assert dict(lrn_forward.launches_by_form) == before_forms



def _xg(shape, seed, scale):
    rng = numpy.random.RandomState(seed)
    return ((rng.randn(*shape) * scale).astype(numpy.float32),
            rng.randn(*shape).astype(numpy.float32))


@pytest.mark.parametrize("constants", sorted(CONSTANTS))
@pytest.mark.parametrize("shape", SHAPES)
def test_backward_matches_pallas_bwd_interpret_and_xla_vjp(shape,
                                                           constants):
    k, alpha, beta, n = CONSTANTS[constants]
    x, g = _xg(shape, seed=11, scale=3.0 if constants == "alexnet"
               else 1.0)
    rows = int(numpy.prod(shape[:-1]))
    want = numpy.asarray(_call_bwd(jnp.asarray(x), jnp.asarray(g), k,
                                   alpha, beta, n, True, block_rows=rows))
    _, vjp = jax.vjp(lambda v: _lrn_slices(v, k, alpha, beta, n),
                     jnp.asarray(x))
    want_xla = numpy.asarray(vjp(jnp.asarray(g))[0])
    got = lrn_backward(torch.from_numpy(x), torch.from_numpy(g), k, alpha,
                       beta, n).numpy()
    numpy.testing.assert_allclose(got, want, **BWD_TOL)
    numpy.testing.assert_allclose(got, want_xla, **BWD_TOL)
    if constants == "cross_term":
        # the 2*alpha*beta*x*W(...) term must be visible: a dx that
        # dropped it would fail by at least 10% of |dx|
        half = n // 2
        padded = numpy.pad(x * x, [(0, 0)] * (x.ndim - 1) + [(half, half)])
        window = sum(padded[..., i:i + shape[-1]] for i in range(n))
        without = g * (k + alpha * window) ** -beta
        assert numpy.abs(got - without).max() >= \
            0.1 * numpy.abs(got).max()


def test_backward_bfloat16_in_float32_math():
    x, g = _xg((2, 6, 6, 96), seed=12, scale=3.0)
    x16 = torch.from_numpy(x).to(torch.bfloat16)
    g16 = torch.from_numpy(g).to(torch.bfloat16)
    got = lrn_backward(x16, g16)
    assert got.dtype == torch.bfloat16
    want = _call_bwd(jnp.asarray(x, jnp.bfloat16),
                     jnp.asarray(g, jnp.bfloat16), 2.0, 1e-4, 0.75, 5, True,
                     block_rows=72)
    numpy.testing.assert_allclose(
        got.float().numpy(), numpy.asarray(want.astype(jnp.float32)),
        atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("constants", sorted(CONSTANTS))
def test_lrn_function_gradient_matches_autograd_of_the_forward(constants):
    """LRNFunction saves x alone and recomputes d; its gradient is the
    autograd gradient of the plain forward."""
    k, alpha, beta, n = CONSTANTS[constants]
    x, g = _xg((3, 4, 4, 40), seed=13, scale=1.0)
    xa = torch.from_numpy(x).requires_grad_()
    LRNFunction.apply(xa, k, alpha, beta, n).backward(torch.from_numpy(g))
    xb = torch.from_numpy(x).requires_grad_()
    lrn_forward_plain(xb, k, alpha, beta, n).backward(torch.from_numpy(g))
    numpy.testing.assert_allclose(xa.grad.numpy(), xb.grad.numpy(),
                                  **BWD_TOL)
    xc = torch.from_numpy(x).requires_grad_()
    LRNFunction.apply(xc, k, alpha, beta, n, True).backward(
        torch.from_numpy(g))
    assert torch.equal(xc.grad, xa.grad)


def test_backward_checks_and_cpu_path_does_not_count():
    x, g = _xg((2, 3, 3, 32), seed=14, scale=1.0)
    xt, gt = torch.from_numpy(x), torch.from_numpy(g)
    before = lrn_backward.launches
    assert torch.equal(lrn_backward(xt, gt), lrn_backward_plain(xt, gt))
    assert lrn_backward.launches == before
    with pytest.raises(ValueError, match="like x"):
        lrn_backward(xt, gt[:1])
    with pytest.raises(ValueError, match="channels-last"):
        lrn_backward(xt, gt.permute(0, 3, 1, 2).contiguous().permute(
            0, 2, 3, 1))
