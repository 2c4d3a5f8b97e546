"""The layers this slice adds to the port -- ``AvgPooling``,
``MaxAbsPooling``, ``Depooling``, ``Deconv`` and ``ActivationUnit`` --
against the JAX units on the CPU: forward and the vector-Jacobian
product, the JAX side by ``jax.vjp`` of the unit's pure ``apply``, the
port's by autograd, on the same numpy inputs and cotangents.

Policies: the pooling and activation units read none (their inputs come
float32 between layers under ``float32`` and ``bfloat16_mixed``, bf16
under ``bfloat16``); ``Deconv`` casts its operands to the policy's
compute dtype.

Tolerances, each stated where it is used: the max and max-abs windows
select elements, exactly; sums of a few float32 terms in another order
1e-6; a bf16 window sum is rounded once on each side from sums taken in
different orders, so one bf16 step (2^-7 relative) apart at most.
"""

import jax
import jax.numpy as jnp
import numpy
import pytest

torch = pytest.importorskip("torch")
import torch.nn.functional as F  # noqa: E402

from veles_tpu.dummy import DummyWorkflow  # noqa: E402
from veles_tpu.nn import activation as jax_activation  # noqa: E402
from veles_tpu.nn import conv as jax_conv  # noqa: E402
from veles_tpu.nn import pooling as jax_pooling  # noqa: E402
from veles_tpu.nn import precision as jax_precision  # noqa: E402
from veles_tpu_torch.convert import (params_from_jax,  # noqa: E402
                                     params_to_jax, to_jax_layout)
from veles_tpu_torch.models.build import build_model  # noqa: E402
from veles_tpu_torch.nn import pooling  # noqa: E402
from veles_tpu_torch.nn.activation import (ACTIVATIONS,  # noqa: E402
                                           ActivationUnit)
from veles_tpu_torch.nn.conv import Deconv  # noqa: E402

#: one bf16 step relative: the most two roundings of one value apart
BF16_STEP = 2.0 ** -7


def _rng(seed):
    return numpy.random.RandomState(seed)


def _jax_vjp(fn, args, g):
    """(output, cotangents of ``args``) of ``fn`` at ``args``."""
    out, vjp = jax.vjp(fn, *[jnp.asarray(a) for a in args])
    return numpy.asarray(out.astype(jnp.float32)), [
        numpy.asarray(c.astype(jnp.float32)) for c in vjp(jnp.asarray(
            g, out.dtype))]


def _port_vjp(module, x, g):
    xt = torch.from_numpy(numpy.array(x)).requires_grad_()
    out = module(xt)
    out.backward(torch.from_numpy(numpy.array(g)).to(out.dtype))
    return out.detach().float().numpy(), xt.grad.float().numpy()


POOL_CASES = {
    "3x3_stride2": dict(kx=3, ky=3, sliding=(2, 2)),
    "3x2_stride_2_1": dict(kx=3, ky=2, sliding=(2, 1)),
    "2x2": dict(kx=2, ky=2),
}


def _pool_pair(name, kw, shape):
    return (getattr(jax_pooling, name)(DummyWorkflow(), **kw),
            getattr(pooling, name)(shape[1:], **kw))


def _ties(seed, shape):
    """Integers in [-2, 2]: windows with equal maxima, equal minima and
    +v beside -v."""
    return _rng(seed).randint(-2, 3, shape).astype(numpy.float32)


@pytest.mark.parametrize("policy", ["float32", "bfloat16_mixed"])
@pytest.mark.parametrize("case", sorted(POOL_CASES))
def test_maxabs_pooling_matches_jax_with_ties(case, policy):
    """Forward and VJP exactly equal on inputs full of ties: the larger
    of ``max`` and ``-min`` (``max`` on a tie of +v and -v), its gradient
    to the window's first max or first min."""
    kw = POOL_CASES[case]
    x = _ties(1, (2, 9, 8, 3))
    x[0, :3, :3, 0] = 2.0                     # a whole window tied at +2
    x[1, :3, :3, 1] = -2.0                    # and one at -2
    x[1, 3:6, 3:6, 2] = numpy.array([[2, -2, 0], [-2, 2, 1], [0, 0, -2]])
    theirs, ours = _pool_pair("MaxAbsPooling", kw, x.shape)
    jax_precision.set_policy(policy)
    try:
        y = theirs.apply({}, jnp.asarray(x))
        g = _rng(2).randn(*y.shape).astype(numpy.float32)
        want, (want_dx,) = _jax_vjp(lambda v: theirs.apply({}, v), [x], g)
    finally:
        jax_precision.set_policy(None)
    assert tuple(ours.output_shape()) == want.shape[1:]
    got, got_dx = _port_vjp(ours, x, g)
    numpy.testing.assert_array_equal(got, want)
    numpy.testing.assert_array_equal(got_dx, want_dx)


@pytest.mark.parametrize("case", sorted(POOL_CASES))
def test_maxabs_pooling_picks_the_larger_magnitude(case):
    """A plain statement of the rule, independent of JAX: each output is
    the window's element of largest |value|, +v over -v."""
    kw = POOL_CASES[case]
    x = _rng(3).randn(2, 7, 7, 2).astype(numpy.float32)
    ours = pooling.MaxAbsPooling(x.shape[1:], **kw)
    got = ours(torch.from_numpy(x)).numpy()
    (sh, sw), ky, kx = ours.stride, ours.ky, ours.kx
    for i in range(got.shape[1]):
        for j in range(got.shape[2]):
            win = x[:, i * sh:i * sh + ky, j * sw:j * sw + kx, :]
            flat = win.reshape(2, -1, 2)
            pick = numpy.take_along_axis(
                flat, numpy.abs(flat).argmax(axis=1)[:, None, :], 1)[:, 0]
            numpy.testing.assert_array_equal(got[:, i, j], pick)


@pytest.mark.parametrize("policy", ["float32", "bfloat16_mixed"])
@pytest.mark.parametrize("case", sorted(POOL_CASES))
def test_avg_pooling_matches_jax(case, policy):
    """float32 inputs: the window sum over kx*ky, forward and VJP within
    1e-6 (a few float32 additions in another order)."""
    kw = POOL_CASES[case]
    x = _rng(4).randn(2, 9, 8, 3).astype(numpy.float32)
    theirs, ours = _pool_pair("AvgPooling", kw, x.shape)
    jax_precision.set_policy(policy)
    try:
        y = theirs.apply({}, jnp.asarray(x))
        g = _rng(5).randn(*y.shape).astype(numpy.float32)
        want, (want_dx,) = _jax_vjp(lambda v: theirs.apply({}, v), [x], g)
    finally:
        jax_precision.set_policy(None)
    assert tuple(ours.output_shape()) == want.shape[1:]
    got, got_dx = _port_vjp(ours, x, g)
    numpy.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)
    numpy.testing.assert_allclose(got_dx, want_dx, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("case", sorted(POOL_CASES))
def test_avg_pooling_in_bfloat16_is_one_rounding_from_jax(case):
    """bf16 inputs (the ``bfloat16`` policy): JAX sums the window with a
    bf16 depthwise convolution and divides in bf16; the port sums in
    ``avg_pool2d`` (wider), rounds to bf16 and divides in bf16. Both
    round the sum once and the quotient once, so they are at most one
    bf16 step apart (2^-7 relative, plus 2^-7 of the window's |x| mean
    where the sum cancels); most outputs are equal."""
    kw = POOL_CASES[case]
    x32 = _rng(6).randn(2, 9, 8, 3).astype(numpy.float32)
    xt = torch.from_numpy(x32).to(torch.bfloat16)
    theirs, ours = _pool_pair("AvgPooling", kw, x32.shape)
    want = numpy.asarray(theirs.apply(
        {}, jnp.asarray(xt.float().numpy(), jnp.bfloat16)).astype(
        jnp.float32))
    got_t = ours(xt)
    assert got_t.dtype == torch.bfloat16
    got = got_t.float().numpy()
    scale = pooling.AvgPooling(x32.shape[1:], **kw)(
        xt.float().abs()).numpy()
    assert (numpy.abs(got - want) <=
            BF16_STEP * (numpy.abs(want) + scale)).all()
    assert (got == want).mean() > 0.9


@pytest.mark.parametrize("policy", ["float32", "bfloat16_mixed"])
@pytest.mark.parametrize("kw", [dict(kx=2, ky=2), dict(kx=3, ky=2)],
                         ids=["2x2", "3x2"])
def test_depooling_matches_jax(kw, policy):
    """Nearest-neighbour upsampling: forward exact, VJP (a block's sum
    of kx*ky cotangents) within 1e-6."""
    x = _rng(7).randn(2, 4, 5, 3).astype(numpy.float32)
    theirs, ours = _pool_pair("Depooling", kw, x.shape)
    jax_precision.set_policy(policy)
    try:
        y = theirs.apply({}, jnp.asarray(x))
        g = _rng(8).randn(*y.shape).astype(numpy.float32)
        want, (want_dx,) = _jax_vjp(lambda v: theirs.apply({}, v), [x], g)
    finally:
        jax_precision.set_policy(None)
    assert tuple(ours.output_shape()) == want.shape[1:]
    got, got_dx = _port_vjp(ours, x, g)
    numpy.testing.assert_array_equal(got, want)
    numpy.testing.assert_allclose(got_dx, want_dx, atol=1e-6, rtol=1e-6)


DECONV_CASES = {
    "valid_stride2": dict(kx=3, ky=3, sliding=(2, 2), padding="VALID"),
    "same_stride2": dict(kx=3, ky=3, sliding=(2, 2), padding="SAME"),
    "int_pad_stride2": dict(kx=3, ky=3, sliding=(2, 2), padding=1),
    "valid_4x2_stride_2_1": dict(kx=4, ky=2, sliding=(2, 1),
                                 padding="VALID"),
    "same_kernel2_stride3": dict(kx=2, ky=2, sliding=(3, 3),
                                 padding="SAME"),
}


def _deconv_pair(kw, shape, include_bias):
    ours = Deconv(shape[1:], n_kernels=4, include_bias=include_bias,
                  device="cpu", trainable=True, **kw)
    params = ours.init_jax_params(_rng(9))
    # a kernel with no spatial symmetry, so a missing flip shows
    params["weights"] = params["weights"] + numpy.arange(
        ours.ky * ours.kx, dtype=numpy.float32).reshape(
        ours.ky, ours.kx, 1, 1)
    params_from_jax([ours], [params])
    theirs = jax_conv.Deconv(DummyWorkflow(), n_kernels=4,
                             include_bias=include_bias, **kw)
    return theirs, ours, params


@pytest.mark.parametrize("bias", [False, True], ids=["no_bias", "bias"])
@pytest.mark.parametrize("case", sorted(DECONV_CASES))
def test_deconv_matches_jax_float32(case, bias):
    """``lax.conv_transpose`` (HWOI, kernel not flipped) against
    ``F.conv_transpose2d`` of the flipped kernel, cropped or padded to
    lax's padding: output, input, weight and bias gradients within 1e-5
    (a few dozen float32 products summed in another order)."""
    kw = DECONV_CASES[case]
    x = _rng(10).uniform(-1, 1, (2, 5, 4, 3)).astype(numpy.float32)
    theirs, ours, params = _deconv_pair(kw, x.shape, bias)
    names = sorted(params)
    y = theirs.apply({k: jnp.asarray(v) for k, v in params.items()},
                     jnp.asarray(x))
    g = _rng(11).randn(*y.shape).astype(numpy.float32)
    want, cots = _jax_vjp(
        lambda v, *p: theirs.apply(dict(zip(names, p)), v),
        [x] + [params[k] for k in names], g)
    assert tuple(ours.output_shape()) == want.shape[1:]
    got, got_dx = _port_vjp(ours, x, g)
    numpy.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    numpy.testing.assert_allclose(got_dx, cots[0], atol=1e-5, rtol=1e-5)
    grads = to_jax_layout({k: getattr(ours, k).grad for k in names})
    for k, want_grad in zip(names, cots[1:]):
        numpy.testing.assert_allclose(grads[k], want_grad, atol=1e-5,
                                      rtol=1e-5)
    # the control: the same call without the flip is another function
    unflipped = F.conv_transpose2d(
        torch.from_numpy(x).permute(0, 3, 1, 2), ours.weights.detach(),
        None, ours.stride)
    full = F.conv_transpose2d(
        torch.from_numpy(x).permute(0, 3, 1, 2),
        torch.flip(ours.weights.detach(), (2, 3)), None, ours.stride)
    assert (unflipped - full).abs().max() > 0.1


@pytest.mark.parametrize("case", sorted(DECONV_CASES))
def test_deconv_matches_jax_bfloat16_mixed(case):
    """Under ``bfloat16_mixed`` both sides cast x and the weights to bf16
    and round the product to bf16 before the float32 bias: outputs within
    one bf16 step of the output's scale; gradients (products of bf16
    cotangents, rounded to bf16 in JAX's VJP) within 1e-2 of each
    tensor's norm."""
    kw = DECONV_CASES[case]
    x = _rng(12).uniform(-1, 1, (2, 5, 4, 3)).astype(numpy.float32)
    theirs, _, params = _deconv_pair(kw, x.shape, True)
    ours = build_model([dict(kw, type="deconv", n_kernels=4,
                             include_bias=True)], x.shape[1:],
                       params=[params], policy="bfloat16_mixed",
                       device="cpu", trainable=True)[0]
    names = sorted(params)
    jax_precision.set_policy("bfloat16_mixed")
    try:
        y = theirs.apply({k: jnp.asarray(v) for k, v in params.items()},
                         jnp.asarray(x))
        g = _rng(13).randn(*y.shape).astype(numpy.float32)
        want, cots = _jax_vjp(
            lambda v, *p: theirs.apply(dict(zip(names, p)), v),
            [x] + [params[k] for k in names], g)
    finally:
        jax_precision.set_policy(None)
    got, got_dx = _port_vjp(ours, x, g)
    assert numpy.abs(got - want).max() <= BF16_STEP * numpy.abs(want).max()
    grads = to_jax_layout({k: getattr(ours, k).grad for k in names})
    for mine, ref in [(got_dx, cots[0])] + [
            (grads[k], c) for k, c in zip(names, cots[1:])]:
        assert numpy.linalg.norm(mine - ref) <= 1e-2 * numpy.linalg.norm(
            ref)


def test_deconv_weights_cross_both_ways_in_hwoi():
    """``params_from_jax`` / ``params_to_jax`` carry HWOI weights and the
    (n_kernels,) bias unchanged."""
    _, ours, params = _deconv_pair(DECONV_CASES["valid_stride2"],
                                   (2, 5, 4, 3), True)
    assert tuple(ours.weights.shape) == (3, 4, 3, 3)
    back = params_to_jax([ours])[0]
    for k in params:
        numpy.testing.assert_array_equal(back[k], params[k])
    with pytest.raises(ValueError):
        params_from_jax([ours], [{"weights": params["weights"],
                                  "bias": numpy.zeros(3, numpy.float32)}])


@pytest.mark.parametrize("policy", ["float32", "bfloat16_mixed"])
@pytest.mark.parametrize("name", sorted(ACTIVATIONS))
def test_activation_unit_matches_jax(name, policy):
    """Each of the eight activations as a standalone unit: forward within
    1e-6, VJP within 1e-5 (XLA's and autograd's derivative formulas
    round differently), over [-20, 20] and on an NHWC input (sincos
    alternates on the last axis)."""
    x = numpy.concatenate([numpy.linspace(-20, 20, 96),
                           _rng(14).randn(48)]).astype(
        numpy.float32).reshape(3, 4, 12)
    if name == "log":
        x = numpy.abs(x)
    theirs = jax_activation.ActivationUnit(DummyWorkflow(), activation=name)
    ours = ActivationUnit(x.shape[1:], activation=name, policy=policy)
    g = _rng(15).randn(*x.shape).astype(numpy.float32)
    jax_precision.set_policy(policy)
    try:
        want, (want_dx,) = _jax_vjp(lambda v: theirs.apply({}, v), [x], g)
    finally:
        jax_precision.set_policy(None)
    assert tuple(ours.output_shape()) == x.shape[1:]
    assert not ours.has_weights
    got, got_dx = _port_vjp(ours, x, g)
    numpy.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)
    numpy.testing.assert_allclose(got_dx, want_dx, atol=1e-5, rtol=1e-5)
