"""Reproducible random streams (``veles_tpu/prng.py``).

A registry of named, seeded generators (``get(key)``): each holds a
``numpy.random.RandomState`` for the host (weight fills, the loader's
shuffles), copied from the JAX package so that the same seed gives the
same draws in both packages, bit for bit.

Where the JAX package derives device keys from a generator
(``jax_key()``: ``fold_in(PRNGKey(seed), counter)``), the port derives
the 64-bit seeds of its Philox uniform fill (:mod:`veles_tpu_torch.ops.
random`) the same way: :meth:`RandomGenerator.philox_seed` returns the
next seed of a deterministic chain of (seed, counter) and leaves the
numpy stream untouched, as ``jax_key()`` does. A restored state
continues the same chain.

Generators pickle as plain data (key, seed, numpy state, chain
counter), as the JAX package's do, so the registry rides in every
snapshot.
"""

import hashlib
import threading

import numpy

_U64 = (1 << 64) - 1


def _splitmix64(value):
    """One splitmix64 output for ``value`` (a 64-bit mixer)."""
    z = (value + 0x9E3779B97F4A7C15) & _U64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _U64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _U64
    return z ^ (z >> 31)


class RandomGenerator(object):
    """One named random stream: numpy host stream + Philox seed chain."""

    def __init__(self, key):
        self.key = key
        self._lock = threading.Lock()
        self.seed_value = None
        self.state = numpy.random.RandomState()
        self._seed_counter = 0

    def seed(self, seed, dtype=None, count=None):
        """Seed from an int, bytes, array or a file path, as the JAX
        package's generator does (same hashing, same 32-bit cut)."""
        if isinstance(seed, str):
            with open(seed, "rb") as f:
                raw = f.read((count or 16) *
                             numpy.dtype(dtype or numpy.uint8).itemsize)
            seed = numpy.frombuffer(raw, dtype=dtype or numpy.uint8)
        if isinstance(seed, numpy.ndarray):
            seed = int.from_bytes(
                hashlib.sha256(seed.tobytes()).digest()[:8], "little")
        elif isinstance(seed, (bytes, bytearray)):
            seed = int.from_bytes(
                hashlib.sha256(bytes(seed)).digest()[:8], "little")
        with self._lock:
            self.seed_value = int(seed) & 0xFFFFFFFF
            self.state = numpy.random.RandomState(self.seed_value)
            self._seed_counter = 0
        return self

    # -- host-side sampling ------------------------------------------------

    def randint(self, low, high=None, size=None):
        with self._lock:
            return self.state.randint(low, high, size)

    def rand(self, *shape):
        with self._lock:
            return self.state.rand(*shape)

    def uniform(self, low=0.0, high=1.0, size=None):
        with self._lock:
            return self.state.uniform(low, high, size)

    def normal(self, loc=0.0, scale=1.0, size=None):
        with self._lock:
            return self.state.normal(loc, scale, size)

    def shuffle(self, arr):
        with self._lock:
            self.state.shuffle(arr)

    def permutation(self, n):
        with self._lock:
            return self.state.permutation(n)

    def fill(self, arr, vmin=-1.0, vmax=1.0):
        """In-place uniform fill (the weight-filler contract)."""
        with self._lock:
            arr[...] = self.state.uniform(vmin, vmax, arr.shape).astype(
                arr.dtype)

    # -- device-side seeds --------------------------------------------------

    def philox_seed(self):
        """The next 64-bit seed of this generator's Philox chain:
        splitmix64 of (32-bit seed, counter); the numpy stream is not
        drawn from."""
        with self._lock:
            counter = self._seed_counter
            self._seed_counter += 1
        return self.philox_seed_at(counter)

    def philox_seed_at(self, counter):
        """The chain's seed at ``counter``, drawing nothing: a trainer
        draws one seed an epoch from the start, so a slave addresses
        epoch e's dropout seed as ``philox_seed_at(e)``."""
        base = (self.seed_value if self.seed_value is not None
                else 0xC0FFEE) & 0xFFFFFFFF
        return _splitmix64((base << 32) | (int(counter) & 0xFFFFFFFF))

    # -- state management ---------------------------------------------------

    def save_state(self):
        with self._lock:
            return (self.state.get_state(), self._seed_counter,
                    self.seed_value)

    def restore_state(self, saved):
        state, counter, seed_value = saved
        with self._lock:
            self.state.set_state(state)
            self._seed_counter = counter
            self.seed_value = seed_value

    def __getstate__(self):
        return {"key": self.key, "seed_value": self.seed_value,
                "numpy_state": self.state.get_state(),
                "seed_counter": self._seed_counter}

    def __setstate__(self, state):
        self.key = state["key"]
        self._lock = threading.Lock()
        self.seed_value = state["seed_value"]
        self.state = numpy.random.RandomState()
        self.state.set_state(state["numpy_state"])
        self._seed_counter = state["seed_counter"]


_generators = {}
_registry_lock = threading.Lock()


def get(key="default"):
    """The named-generator registry; a new name is seeded from the
    bytes of its name, as in the JAX package."""
    with _registry_lock:
        gen = _generators.get(key)
        if gen is None:
            gen = RandomGenerator(key).seed(str(key).encode())
            _generators[key] = gen
        return gen



def dump_states():
    """Every named generator's state as plain picklable data,
    ``{key: (numpy_state_tuple, seed_counter, seed_value)}`` -- the
    shape of the JAX package's ``dump_states`` (its counter counts
    ``jax_key()`` draws, this one Philox seeds). The master ships it in
    the mid-run join's resync, so a joining slave continues the fleet's
    streams instead of restarting them from their seeds; it rides the
    restricted wire codec (str, int, ndarray only)."""
    with _registry_lock:
        generators = dict(_generators)
    return {key: gen.save_state() for key, gen in generators.items()}


def restore_states(states):
    """Inverse of :func:`dump_states`: overwrite (or create) each named
    generator with the shipped state."""
    for key, saved in (states or {}).items():
        get(key).restore_state(saved)
