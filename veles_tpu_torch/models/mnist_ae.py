"""The MNIST autoencoder, BASELINE config 4's first half
(``veles_tpu/models/mnist_ae.py``).

:func:`autoencoder_layers` is ``MnistAEWorkflow``'s topology, features
-> ``bottleneck`` (LeCun tanh) -> features (linear), the output width
resolved from the data's features as the JAX workflow resolves it;
:data:`AE_TRAINING` its training defaults under the MSE loss (its
minibatch is 100). :class:`AutoencoderLoader` is an
MSE loader over a provider whose targets are a copy of the normalized
(``linear`` by default) flat inputs. The SOM, the config's other half,
is ``nn/kohonen.py`` with ``train/som.py``.
"""

import numpy
import torch

from veles_tpu_torch.loader.fullbatch import FullBatchLoaderMSE

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
