"""Precision policies: which dtype the matmuls and convolutions see.

The port of ``veles_tpu/nn/precision.py``. ``build_model`` and the
trainers take a policy by name; the workflow's units build and compute
under :func:`active_policy`, resolved in the JAX package's order: the
process-wide pin of :func:`set_policy`, then ``VELES_PRECISION``, then
``root.common.engine.precision_type`` (``--precision``), then
``float32``. The policies:

* ``float32``        -- everything float32;
* ``bfloat16_mixed`` -- operands cast to bfloat16 at each matmul and
  convolution, accumulation and the activations between layers float32;
* ``bfloat16``       -- as ``bfloat16_mixed``, and the activations stay
  bfloat16 between layers too.

Under ``float32`` a matmul and a convolution must run in full float32.
PyTorch's matmuls do by default, but cuDNN runs float32 convolutions in
TF32 (about three decimal digits) unless told otherwise, and under
the bf16 policies cuBLAS may reduce a bf16 product in bf16 unless
``allow_bf16_reduced_precision_reduction`` is off. These switches are
process-wide, and a caller may turn them on at any time, so the trainer
and the serving forward run each whole unit of work (a training step,
an evaluation sweep, a served batch) inside :meth:`Policy.backends`:

* ``torch.backends.cuda.matmul.allow_tf32 = False`` and
  ``allow_bf16_reduced_precision_reduction = False`` under every policy
  (the JAX package accumulates every product in float32 and rounds
  once);
* ``torch.backends.cudnn.allow_tf32 = False`` under ``float32``.

The switches are process-globals that autograd's device thread reads
too, so one entry around ``backward()`` covers the products autograd
takes. :meth:`Policy.configure_backends` sets the float32 switches once,
for callers who build a model and drive it by hand.
"""

import contextlib
import threading

import torch

from veles_tpu_torch.config import root
from veles_tpu_torch.envknob import env_knob


class SwitchGuard(object):
    """Holds process-wide backend switches at fixed values while any
    caller is inside it, and restores the values the first caller found
    when the last one leaves: depth-counted under a lock, so concurrent
    callers cannot restore a switch under each other.

    ``switches`` is a tuple of ``(owner, attribute, value)``."""

    def __init__(self, *switches):
        self._switches = switches
        self._lock = threading.Lock()
        self._depth = 0
        self._saved = None

    @contextlib.contextmanager
    def __call__(self):
        with self._lock:
            if self._depth == 0:
                self._saved = [getattr(owner, attr)
                               for owner, attr, _ in self._switches]
                for owner, attr, value in self._switches:
                    setattr(owner, attr, value)
            self._depth += 1
        try:
            yield
        finally:
            with self._lock:
                self._depth -= 1
                if self._depth == 0:
                    for (owner, attr, _), value in zip(self._switches,
                                                       self._saved):
                        setattr(owner, attr, value)


_matmul = torch.backends.cuda.matmul
#: ``with full_float32():`` -- library products inside run in full
#: float32 and accumulate bf16 in float32
full_float32 = SwitchGuard(
    (_matmul, "allow_tf32", False),
    (_matmul, "allow_bf16_reduced_precision_reduction", False))
#: ``with full_float32_convolutions():`` -- cuDNN's float32
#: convolutions inside run in full float32
full_float32_convolutions = SwitchGuard(
    (torch.backends.cudnn, "allow_tf32", False))


class Policy(object):
    """(compute, accum, keep) dtypes: operands cast to ``compute``,
    products accumulate in ``accum``, layer outputs cast to ``keep``."""

    def __init__(self, name, compute, accum, keep):
        self.name = name
        self.compute_dtype = compute
        self.accum_dtype = accum
        self.keep_dtype = keep

    def __repr__(self):
        return "<Policy %s>" % self.name

    def cast_in(self, *tensors):
        """Cast matmul/conv operands to the compute dtype."""
        out = tuple(t.to(self.compute_dtype) if t is not None else None
                    for t in tensors)
        return out if len(out) > 1 else out[0]

    def cast_out(self, y):
        """The dtype a layer hands to the next layer."""
        return y.to(self.keep_dtype)

    @contextlib.contextmanager
    def backends(self):
        """The switches of this policy held for the duration (see the
        module's docstring), the caller's restored after."""
        with contextlib.ExitStack() as stack:
            stack.enter_context(full_float32())
            if self.compute_dtype == torch.float32:
                stack.enter_context(full_float32_convolutions())
            yield

    def configure_backends(self):
        """Full float32 for matmuls and cuDNN convolutions under the
        float32 policy (TF32 off); the bf16 policies change nothing."""
        if self.compute_dtype == torch.float32:
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False


POLICIES = {
    "float32": Policy("float32", torch.float32, torch.float32,
                      torch.float32),
    "bfloat16_mixed": Policy("bfloat16_mixed", torch.bfloat16,
                             torch.float32, torch.float32),
    "bfloat16": Policy("bfloat16", torch.bfloat16, torch.float32,
                       torch.bfloat16),
}


def policy_of(model):
    """The policy a model's layers were built under (``build_model``
    gives every layer one): the first layer's that has one, float32 for
    a model without any."""
    for module in model.modules():
        policy = getattr(module, "policy", None)
        if isinstance(policy, Policy):
            return policy
    return POLICIES["float32"]


def get_policy(policy="float32"):
    """A :class:`Policy` by name (a Policy passes through)."""
    if isinstance(policy, Policy):
        return policy
    try:
        return POLICIES[policy]
    except KeyError:
        raise ValueError("unknown precision policy %r (have %s)" %
                         (policy, sorted(POLICIES)))


_forced = None


def set_policy(name):
    """Pin the process-wide policy by name; None unpins it (back to the
    environment and the configuration)."""
    global _forced
    _forced = None if name is None else get_policy(name)


def active_policy():
    """The policy the workflow's units use: the pin, else
    ``VELES_PRECISION``, else ``root.common.engine.precision_type``."""
    if _forced is not None:
        return _forced
    return get_policy(env_knob("VELES_PRECISION") or
                      root.common.engine.get("precision_type", "float32"))
