"""The loader's shuffles, worked out again for the reference.

The port's loader keeps one permutation of the dataset, ``[validation,
train]``, the identity at first. At each epoch's wrap it shuffles the
training segment in place with ``numpy.random.RandomState(s).shuffle``,
``s`` being the low 32 bits of its stream's seed: numpy's legacy
Mersenne Twister and Fisher-Yates, whose stream numpy keeps fixed.
Epoch ``e`` therefore trains in the order that ``e`` such shuffles,
one after the other, make of the identity.
"""

import numpy


def train_orders(seed, n_valid, n_train, epochs):
    """The training segment's order (dataset indices, int32) in each of
    the first ``epochs`` epochs, for a loader stream seeded with
    ``seed``."""
    state = numpy.random.RandomState(seed & 0xFFFFFFFF)
    order = numpy.arange(n_valid, n_valid + n_train, dtype=numpy.int32)
    out = []
    for epoch in range(epochs):
        if epoch:
            state.shuffle(order)
        out.append(order.copy())
    return out
