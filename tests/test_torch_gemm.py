"""The port's fused linear layer (``veles_tpu_torch.ops.gemm``) against
the JAX package's ``pallas_gemm`` and its XLA chain.

On the CPU the port's ``linear_act`` runs its plain PyTorch version;
the JAX side runs the Pallas kernel in interpret mode (tileable shapes)
or its XLA fallback (ragged M). The same numpy inputs, from a seed, go
through both.

Tolerance: both sides accumulate the K products in float32, in
different orders. With K = 64 and unit-scale inputs the sums are O(1)
and reordering moves them by a few float32 ulps, so atol = rtol = 1e-5
(~100 ulp at 1.0) holds with margin and still catches any wrong
epilogue constant (the smallest, 0.6666 vs 2/3, moves results ~1e-4).
The backward (``LinearActFunction`` against ``jax.vjp`` of
``fused_linear``) sums over M = 16 or N = 32 products of the same
scale: the same 1e-5. With bf16 operands both sides round dpre and the
products' results to bf16 at the same points, but a float32 sum that
lands on the other side of a rounding tie moves one value by a bf16 ulp
(2^-8 relative): atol = rtol = 1e-2 there.
"""

import jax
import jax.numpy as jnp
import numpy
import pytest

torch = pytest.importorskip("torch")

from veles_tpu.nn.activation import get_activation  # noqa: E402
from veles_tpu.ops.gemm import _DS, fused_linear, pallas_gemm  # noqa: E402
from veles_tpu_torch.ops.gemm import (EPILOGUES,  # noqa: E402
                                      LinearActFunction, linear_act,
                                      linear_act_plain)

TOL = dict(atol=1e-5, rtol=1e-5)


def _inputs(m, k, n, seed=3):
    rng = numpy.random.RandomState(seed)
    a = rng.randn(m, k).astype(numpy.float32)
    b = (rng.randn(k, n) / numpy.sqrt(k)).astype(numpy.float32)
    bias = rng.randn(n).astype(numpy.float32)
    return a, b, bias


def _port(a, b, bias, activation):
    return linear_act(torch.from_numpy(a), torch.from_numpy(b),
                      None if bias is None else torch.from_numpy(bias),
                      activation).numpy()


@pytest.mark.parametrize("with_bias", [True, False])
@pytest.mark.parametrize("activation", EPILOGUES)
def test_matches_pallas_gemm_interpret(activation, with_bias):
    a, b, bias = _inputs(16, 64, 32)
    if not with_bias:
        bias = None
    want = pallas_gemm(jnp.asarray(a), jnp.asarray(b), bm=8, bn=16, bk=32,
                       bias=None if bias is None else jnp.asarray(bias),
                       activation=activation, interpret=True)
    numpy.testing.assert_allclose(_port(a, b, bias, activation),
                                  numpy.asarray(want), **TOL)


@pytest.mark.parametrize("activation", EPILOGUES)
def test_ragged_m_matches_xla_chain(activation):
    """M = 5 does not tile: the TPU kernel falls back to the XLA chain,
    which is what All2All runs untuned. The port takes any M."""
    a, b, bias = _inputs(5, 64, 32, seed=4)
    chain = get_activation(activation)(
        jnp.dot(jnp.asarray(a), jnp.asarray(b),
                preferred_element_type=jnp.float32) + jnp.asarray(bias))
    fallback = pallas_gemm(jnp.asarray(a), jnp.asarray(b), bm=4, bn=16,
                           bk=32, bias=jnp.asarray(bias),
                           activation=activation, interpret=True)
    got = _port(a, b, bias, activation)
    numpy.testing.assert_allclose(got, numpy.asarray(chain), **TOL)
    numpy.testing.assert_allclose(got, numpy.asarray(fallback), **TOL)


def test_bfloat16_operands_accumulate_in_float32():
    """bf16 operands, f32 output: both sides multiply the same bf16
    values exactly and sum in float32."""
    a, b, bias = _inputs(8, 64, 16, seed=5)
    a16 = jnp.asarray(a, jnp.bfloat16)
    b16 = jnp.asarray(b, jnp.bfloat16)
    want = pallas_gemm(a16, b16, bm=8, bn=16, bk=32, out_dtype=jnp.float32,
                       bias=jnp.asarray(bias), activation="strict_relu",
                       interpret=True)
    ta = torch.from_numpy(numpy.array(a16.astype(jnp.float32))).to(
        torch.bfloat16)
    tb = torch.from_numpy(numpy.array(b16.astype(jnp.float32))).to(
        torch.bfloat16)
    got = linear_act(ta, tb, torch.from_numpy(bias), "strict_relu",
                     torch.float32)
    assert got.dtype == torch.float32
    numpy.testing.assert_allclose(got.numpy(), numpy.asarray(want), **TOL)


def test_cpu_tensors_take_the_plain_version_without_counting():
    a, b, bias = _inputs(4, 32, 8)
    before = linear_act.launches
    before_forms = dict(linear_act.launches_by_form)
    ta, tb, tbias = map(torch.from_numpy, (a, b, bias))
    assert torch.equal(linear_act(ta, tb, tbias, "tanh"),
                       linear_act_plain(ta, tb, tbias, "tanh"))
    assert linear_act.launches == before
    assert dict(linear_act.launches_by_form) == before_forms


@pytest.mark.parametrize("bad", ["shape", "dtype", "activation", "bias",
                                 "layout"])
def test_rejects_what_the_kernel_does_not_take(bad):
    a, b, bias = _inputs(4, 32, 8)
    ta, tb, tbias = map(torch.from_numpy, (a, b, bias))
    act = "linear"
    if bad == "shape":
        tb = tb[:16]
    elif bad == "dtype":
        tb = tb.double()
    elif bad == "activation":
        act = "sincos"
    elif bad == "bias":
        tbias = tbias[:4]
    else:
        tb = tb.t().contiguous().t()
    with pytest.raises((ValueError, TypeError)):
        linear_act(ta, tb, tbias, act)



@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("activation", EPILOGUES)
def test_backward_matches_fused_linear_vjp(activation, dtype):
    """dx, dw and db of ``LinearActFunction`` against ``jax.vjp`` of
    ``fused_linear`` (Pallas forward in interpret mode, residuals
    (x, w, y), derivatives from the output)."""
    a, b, bias = _inputs(16, 64, 32, seed=6)
    g = numpy.random.RandomState(7).randn(16, 32).astype(numpy.float32)
    jdt = getattr(jnp, dtype)
    cfg = (8, 16, 32, _DS, True)
    y, vjp = jax.vjp(
        lambda x, w, bb: fused_linear(x, w, bb, activation, jdt, cfg),
        jnp.asarray(a, jdt), jnp.asarray(b, jdt), jnp.asarray(bias))
    want = [numpy.asarray(v.astype(jnp.float32))
            for v in vjp(jnp.asarray(g, jdt))]
    tdt = getattr(torch, dtype)
    x = torch.from_numpy(a).to(tdt).requires_grad_()
    w = torch.from_numpy(b).to(tdt).requires_grad_()
    tb = torch.from_numpy(bias).requires_grad_()
    out = LinearActFunction.apply(x, w, tb, activation, tdt)
    tol = TOL if dtype == "float32" else dict(atol=1e-2, rtol=1e-2)
    numpy.testing.assert_allclose(out.detach().float().numpy(),
                                  numpy.asarray(y.astype(jnp.float32)), **tol)
    out.backward(torch.from_numpy(g).to(tdt))
    assert x.grad.dtype == tdt and w.grad.dtype == tdt
    assert tb.grad.dtype == torch.float32
    for got, ref in zip((x.grad, w.grad, tb.grad), want):
        numpy.testing.assert_allclose(got.float().numpy(), ref, **tol)


def test_backward_without_bias_and_through_plain_versions():
    a, b, _ = _inputs(4, 32, 8, seed=8)
    grads = []
    for plain in (False, True):
        x = torch.from_numpy(a).requires_grad_()
        w = torch.from_numpy(b).requires_grad_()
        LinearActFunction.apply(x, w, None, "tanh", torch.float32,
                                plain).sum().backward()
        grads.append((x.grad, w.grad))
    assert torch.equal(grads[0][0], grads[1][0])
    assert torch.equal(grads[0][1], grads[1][1])
