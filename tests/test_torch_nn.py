"""The port's layers (``veles_tpu_torch.nn``) against the JAX package's
units, one layer at a time, on the CPU: the same numpy weights (loaded
through ``params_from_jax``) and inputs go through the JAX unit's pure
``apply`` and the port's module.

Tolerance: convolutions and matmuls sum up to a few hundred float32
products in different orders (XLA's CPU convolution vs oneDNN), which
moves O(1) outputs by well under 1e-5; atol = rtol = 1e-5. Pooling and
the activation table are exact or within 1 ulp (1e-6).
"""

import jax
import jax.numpy as jnp
import numpy
import pytest

torch = pytest.importorskip("torch")

from veles_tpu.dummy import DummyWorkflow  # noqa: E402
from veles_tpu.nn import activation as jax_activation  # noqa: E402
from veles_tpu.nn import all2all as jax_all2all  # noqa: E402
from veles_tpu.nn import conv as jax_conv  # noqa: E402
from veles_tpu.nn.pooling import MaxPooling as JaxMaxPooling  # noqa: E402
from veles_tpu_torch.convert import params_from_jax  # noqa: E402
from veles_tpu_torch.nn import all2all, conv  # noqa: E402
from veles_tpu_torch.nn.activation import ACTIVATIONS  # noqa: E402
from veles_tpu_torch.nn.pooling import MaxPooling  # noqa: E402
from veles_tpu_torch.nn.precision import POLICIES, get_policy  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)


def _rng(seed):
    return numpy.random.RandomState(seed)


def _loaded(module, seed):
    params = module.init_jax_params(_rng(seed))
    params_from_jax([module], [params])
    return params


def _run(module, x):
    with torch.inference_mode():
        return module(torch.from_numpy(x)).numpy()


CONV_CASES = {
    # AlexNet conv1's geometry through the JAX space-to-depth path
    "s2d_conv1": (jax_conv.ConvStrictRELU, conv.ConvStrictRELU,
                  (2, 35, 35, 3),
                  dict(n_kernels=8, kx=11, ky=11, sliding=(4, 4),
                       padding=2, space_to_depth=True)),
    "int_padding": (jax_conv.ConvStrictRELU, conv.ConvStrictRELU,
                    (2, 9, 9, 5), dict(n_kernels=6, kx=3, ky=3, padding=1)),
    "tuple_padding_nonsquare_stride": (
        jax_conv.ConvTanh, conv.ConvTanh, (2, 11, 10, 4),
        dict(n_kernels=5, kx=3, ky=5, sliding=(2, 1), padding=(1, 2))),
    "valid_sigmoid": (jax_conv.ConvSigmoid, conv.ConvSigmoid,
                      (3, 8, 8, 2), dict(n_kernels=4, kx=3, ky=2,
                                         padding="VALID")),
    "grayscale_relu": (jax_conv.ConvRELU, conv.ConvRELU, (2, 7, 7),
                       dict(n_kernels=3, kx=3, ky=3)),
}


@pytest.mark.parametrize("case", sorted(CONV_CASES))
def test_conv_matches_jax(case):
    jax_cls, port_cls, shape, kw = CONV_CASES[case]
    x = _rng(1).uniform(-1, 1, shape).astype(numpy.float32)
    module = port_cls(shape[1:], device="cpu", **kw)
    params = _loaded(module, seed=2)
    want = jax_cls(DummyWorkflow(), **kw).apply(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x))
    got = _run(module, x)
    assert got.shape == want.shape
    assert tuple(module.output_shape()) == want.shape[1:]
    numpy.testing.assert_allclose(got, numpy.asarray(want), **TOL)


def test_conv_rejects_unsupported_padding_and_s2d_stride():
    with pytest.raises(ValueError):
        conv.Conv((8, 8, 3), n_kernels=2, kx=3, ky=3, padding="SAME",
                  device="cpu")
    with pytest.raises(ValueError, match="space_to_depth"):
        conv.Conv((8, 8, 3), n_kernels=2, kx=3, ky=3, sliding=(2, 1),
                  space_to_depth=True, device="cpu")


def test_conv_hands_nhwc_contiguous_output_to_the_lrn():
    module = conv.ConvStrictRELU((9, 9, 3), n_kernels=8, kx=3, ky=3,
                                 device="cpu")
    _loaded(module, seed=3)
    with torch.inference_mode():
        y = module(torch.zeros(2, 9, 9, 3))
    assert y.shape == (2, 7, 7, 8) and y.is_contiguous()


@pytest.mark.parametrize("kw", [dict(kx=3, ky=3, sliding=(2, 2)),
                                dict(kx=3, ky=2, sliding=(2, 1)),
                                dict(kx=2, ky=2)])
def test_max_pooling_matches_jax(kw):
    x = _rng(4).randn(2, 9, 8, 4).astype(numpy.float32)
    want = JaxMaxPooling(DummyWorkflow(), **kw).apply({}, jnp.asarray(x))
    module = MaxPooling(x.shape[1:], **kw)
    assert tuple(module.output_shape()) == want.shape[1:]
    numpy.testing.assert_array_equal(_run(module, x), numpy.asarray(want))


A2A_CASES = {
    "all2all": (jax_all2all.All2All, all2all.All2All),
    "all2all_tanh": (jax_all2all.All2AllTanh, all2all.All2AllTanh),
    "all2all_relu": (jax_all2all.All2AllRELU, all2all.All2AllRELU),
    "all2all_str": (jax_all2all.All2AllStrictRELU,
                    all2all.All2AllStrictRELU),
    "all2all_sigmoid": (jax_all2all.All2AllSigmoid,
                        all2all.All2AllSigmoid),
    "softmax": (jax_all2all.All2AllSoftmax, all2all.All2AllSoftmax),
}


@pytest.mark.parametrize("case", sorted(A2A_CASES))
def test_all2all_matches_jax_with_nhwc_flatten(case):
    """A 4-D NHWC input flattens in (h, w, c) order in both packages."""
    jax_cls, port_cls = A2A_CASES[case]
    x = _rng(5).uniform(-2, 2, (3, 3, 3, 8)).astype(numpy.float32)
    module = port_cls(x.shape[1:], output_sample_shape=12, device="cpu")
    params = _loaded(module, seed=6)
    want = jax_cls(DummyWorkflow(), output_sample_shape=12).apply(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x))
    numpy.testing.assert_allclose(_run(module, x), numpy.asarray(want),
                                  **TOL)


@pytest.mark.parametrize("name", sorted(ACTIVATIONS))
def test_activation_table_matches_jax(name):
    x = numpy.linspace(-20, 20, 401).astype(numpy.float32)
    want = jax_activation.get_activation(name)(jnp.asarray(x))
    got = ACTIVATIONS[name](torch.from_numpy(x)).numpy()
    numpy.testing.assert_allclose(got, numpy.asarray(want), atol=1e-6,
                                  rtol=1e-6)


def test_float32_policy_turns_tf32_off():
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        get_policy("bfloat16_mixed").configure_backends()
        assert torch.backends.cudnn.allow_tf32
        get_policy("float32").configure_backends()
        assert not torch.backends.cuda.matmul.allow_tf32
        assert not torch.backends.cudnn.allow_tf32
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def test_policies_mirror_the_jax_package():
    from veles_tpu.nn.precision import POLICIES as JAX_POLICIES
    assert sorted(POLICIES) == sorted(JAX_POLICIES)
    for name, pol in POLICIES.items():
        ref = JAX_POLICIES[name]
        for attr in ("compute_dtype", "accum_dtype", "keep_dtype"):
            assert str(getattr(pol, attr)).split(".")[-1] == \
                jnp.dtype(getattr(ref, attr)).name
    with pytest.raises(ValueError):
        get_policy("float16")


@pytest.mark.parametrize("kw", [dict(kx=3, ky=3, sliding=(2, 2)),
                                dict(kx=2, ky=2)])
def test_max_pooling_gradient_routes_ties_as_jax(kw):
    """Strict-ReLU zeros make windows of equal values. XLA's
    ``select_and_scatter`` and torch's ``max_pool2d`` backward must send
    each window's gradient to the same element: exact equality on an
    input that is half zeros, with whole windows tied, and on a window
    tied at a positive value."""
    x = numpy.maximum(_rng(7).randn(2, 9, 9, 4), 0.0).astype(numpy.float32)
    x[0, :4, :4, :] = 0.0
    x[1, 2:5, 2:5, 1] = 0.5
    g = _rng(8).randn(*JaxMaxPooling(DummyWorkflow(), **kw).apply(
        {}, jnp.asarray(x)).shape).astype(numpy.float32)
    _, vjp = jax.vjp(lambda v: JaxMaxPooling(DummyWorkflow(), **kw).apply(
        {}, v), jnp.asarray(x))
    want = numpy.asarray(vjp(jnp.asarray(g))[0])
    xt = torch.from_numpy(x).requires_grad_()
    MaxPooling(x.shape[1:], **kw)(xt).backward(torch.from_numpy(g))
    numpy.testing.assert_array_equal(xt.grad.numpy(), want)


def test_bias_add_nhwc_sums_the_gradient_over_the_channel_axis():
    """The bias gradient is the sum over every axis but the last, also
    for an upstream gradient that is not NHWC-contiguous (it is made
    contiguous first, never reduced on the wrong axis)."""
    from veles_tpu_torch.nn.base import bias_add_nhwc
    y = torch.from_numpy(_rng(9).randn(2, 3, 4, 5).astype(numpy.float32))
    g_nchw = torch.from_numpy(_rng(10).randn(2, 5, 3, 4).astype(
        numpy.float32))
    g = g_nchw.permute(0, 2, 3, 1)            # NHWC view, NCHW memory
    assert not g.is_contiguous()
    for plain in (False, True):
        bias = torch.zeros(5, requires_grad=True)
        out = bias_add_nhwc(y, bias, plain)
        torch.testing.assert_close(out, y)
        out.backward(g)
        numpy.testing.assert_allclose(
            bias.grad.numpy(), g_nchw.numpy().sum(axis=(0, 2, 3)),
            atol=1e-5, rtol=1e-5)
    assert bias_add_nhwc(y, None) is y


def test_dropout_train_forward_matches_apply_with_key():
    """Given JAX's own uniforms for a key, the port's mask and scaling
    are ``apply_with_key``'s exactly; evaluation is the identity and the
    gradient passes through the same mask."""
    from veles_tpu.nn.dropout import DropoutForward as JaxDropout
    from veles_tpu_torch.nn.dropout import DropoutForward
    x = _rng(11).randn(4, 32).astype(numpy.float32)
    key = jax.random.PRNGKey(3)
    want = JaxDropout(DummyWorkflow(), dropout_ratio=0.3).apply_with_key(
        {}, jnp.asarray(x), key)
    u = torch.from_numpy(numpy.array(jax.random.uniform(key, x.shape)))
    module = DropoutForward(x.shape[1:], dropout_ratio=0.3)
    xt = torch.from_numpy(x).requires_grad_()
    got = module.train_forward(xt, u)
    numpy.testing.assert_array_equal(got.detach().numpy(),
                                     numpy.asarray(want))
    got.sum().backward()
    numpy.testing.assert_array_equal(
        xt.grad.numpy(), ((u < 0.7).float() / 0.7).numpy())
    assert module(xt) is xt
