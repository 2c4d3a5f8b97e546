"""The MNIST autoencoder, BASELINE config 4's first half
(``veles_tpu/models/mnist_ae.py``).

:func:`autoencoder_layers` is ``MnistAEWorkflow``'s topology, features
-> ``bottleneck`` (LeCun tanh) -> features (linear), the output width
resolved from the data's features as the JAX workflow resolves it;
:data:`AE_TRAINING` its training defaults under the MSE loss (its
minibatch is 100). :class:`AutoencoderLoader` is an
MSE loader over a provider whose targets are a copy of the normalized
(``linear`` by default) flat inputs; :class:`MnistAEWorkflow` is the JAX
package's workflow class over it (the output width read from the
provider's data once, before the loader loads it again).
The SOM, the config's other half,
is :class:`KohonenWorkflow`, the units of ``nn/kohonen.py`` in a loop,
or its own runner ``train/som.py`` ``SOMFusedRunner``.
"""

import numpy
import torch

from veles_tpu_torch.accelerated_units import AcceleratedWorkflow
from veles_tpu_torch.loader.fullbatch import FullBatchLoaderMSE
from veles_tpu_torch.mutable import Bool
from veles_tpu_torch.nn.kohonen import KohonenForward, KohonenTrainer
from veles_tpu_torch.plumbing import Repeater
from veles_tpu_torch.standard_workflow import StandardWorkflow
from veles_tpu_torch.units import Unit

#: ``MnistAEWorkflow``'s defaults: MSE loss, SGD with these
AE_TRAINING = {"learning_rate": 0.05, "loss": "mse"}


def autoencoder_layers(features, bottleneck=100):
    """features -> bottleneck (tanh) -> features (linear)."""
    return [{"type": "all2all_tanh", "output_sample_shape": bottleneck},
            {"type": "all2all", "output_sample_shape": int(features)}]


class AutoencoderLoader(FullBatchLoaderMSE):
    """Flat (n, features) samples from a provider's images, classes
    ``[0, valid, train]``; the targets are a copy of the data after
    normalization. No labels."""

    def __init__(self, provider=None, normalization_type="linear",
                 **kwargs):
        super(AutoencoderLoader, self).__init__(
            normalization_type=normalization_type, **kwargs)
        self.provider = provider

    def load_dataset(self):
        train_x, _, valid_x, _ = self.provider()
        data = numpy.concatenate([valid_x, train_x]).astype(numpy.float32)
        self.original_data = torch.from_numpy(numpy.ascontiguousarray(
            data.reshape(len(data), -1)))
        self.class_lengths = [0, len(valid_x), len(train_x)]

    def _normalize_data(self):
        super(AutoencoderLoader, self)._normalize_data()
        self.original_targets = self.original_data.clone()


class MnistAEWorkflow(StandardWorkflow):
    """features -> ``bottleneck`` (tanh) -> features autoencoder under
    the MSE loss on the loader's ``minibatch_targets``: lr 0.05 and
    minibatches of 100 unless the keywords say otherwise. ``layers``
    replaces :func:`autoencoder_layers`; a descriptor whose
    ``output_sample_shape`` is None gets the data's feature count."""

    hide_from_registry = True

    def __init__(self, workflow=None, provider=None, bottleneck=100,
                 **kwargs):
        for key, value in AE_TRAINING.items():
            kwargs.setdefault(key, value)
        minibatch_size = kwargs.pop("minibatch_size", 100)
        layers = kwargs.pop("layers", None) or [
            {"type": "all2all_tanh", "output_sample_shape": bottleneck},
            {"type": "all2all", "output_sample_shape": None}]
        super(MnistAEWorkflow, self).__init__(
            workflow,
            loader=lambda wf: AutoencoderLoader(
                workflow=wf, provider=provider,
                minibatch_size=minibatch_size),
            layers=self._resolve_layers(layers, provider),
            mse_target_attr="minibatch_targets", **kwargs)

    @staticmethod
    def _resolve_layers(layers, provider):
        """``layers`` with each None width set to the feature count of
        the provider's training samples (the provider called at most
        once here)."""
        resolved, features = [], None
        for descr in layers:
            descr = dict(descr)
            if descr.get("output_sample_shape") is None:
                if features is None:
                    features = int(numpy.prod(provider()[0].shape[1:]))
                descr["output_sample_shape"] = features
            resolved.append(descr)
        return resolved


class EpochCounter(Unit):
    """Raises ``complete`` when an epoch ends with the loader's epoch
    number at ``epochs`` or more."""

    hide_from_registry = True

    def __init__(self, workflow, epochs=10, **kwargs):
        super(EpochCounter, self).__init__(workflow, **kwargs)
        self.epochs = epochs
        self.complete = Bool(False)
        self.demand("epoch_ended", "epoch_number")

    def initialize(self, **kwargs):
        pass

    def run(self):
        if bool(self.epoch_ended) and self.epoch_number >= self.epochs:
            self.complete <<= True


class KohonenWorkflow(AcceleratedWorkflow):
    """The SOM training loop (``veles_tpu/models/mnist_ae.py``):
    repeater -> loader (``loader_factory(workflow)``) -> trainer ->
    epoch counter -> repeater, until the counter completes; the forward
    maps the loader's minibatch to its winners after training, outside
    the loop. ``run()`` is the eager loop; :meth:`make_fused_runner`
    gives the runner of ``train/som.py``."""

    hide_from_registry = True

    def __init__(self, workflow=None, loader_factory=None, sx=8, sy=8,
                 epochs=10, **kwargs):
        super(KohonenWorkflow, self).__init__(workflow, **kwargs)
        self.repeater = Repeater(self)
        self.repeater.link_from(self.start_point)
        self.loader = loader_factory(self)
        self.loader.link_from(self.repeater)
        self.trainer = KohonenTrainer(self, sx=sx, sy=sy)
        self.trainer.link_from(self.loader)
        self.trainer.link_attrs(self.loader, ("input", "minibatch_data"))
        self.forward = KohonenForward(self)
        self.forward.link_attrs(self.loader, ("input", "minibatch_data"))
        self.forward.link_attrs(self.trainer, "weights")
        self.counter = EpochCounter(self, epochs=epochs, name="counter")
        self.counter.link_from(self.trainer)
        self.counter.link_attrs(self.loader, "epoch_ended", "epoch_number")
        self.repeater.link_from(self.counter)
        self.repeater.gate_block = self.counter.complete
        self.end_point.link_from(self.counter)
        self.end_point.gate_block = ~self.counter.complete

    def make_fused_runner(self):
        """The workflow's own runner, or None where only the eager loop
        continues the run exactly: no data loaded yet, or a snapshot
        resumed inside an epoch (the runner sweeps whole epochs)."""
        if self.loader.original_data is None:
            return None
        offset = self.loader._global_offset
        if 0 < offset < self.loader.total_samples:
            return None
        from veles_tpu_torch.train.som import SOMFusedRunner
        return SOMFusedRunner(self)
