"""Chromosome and Population: the genetic-algorithm engine
(``veles_tpu/genetics/core.py``, line for line: one seed of the port's
``prng`` gives the JAX package's population, bit for bit).

Genes are fixed-point integers gray-coded with the closed form ``n ^ (n
>> 1)`` and decoded by prefix XOR: small genotype steps are small
phenotype steps.

Operators, as in the original VELES (``veles/genetics/core.py``):
* selection: roulette (:578), random (:596), tournament (:605)
* crossover: pointed (:633), uniform (:672), arithmetic (:707),
  geometric (:747)
* mutation: binary_point (:260), altering (:277), gaussian (:310),
  uniform (:346)
"""

import numpy

from veles_tpu_torch import prng
from veles_tpu_torch.distributable import Pickleable


def gray_encode(n):
    """Binary-reflected gray code of a non-negative int (or array)."""
    return n ^ (n >> 1)


def gray_decode(g):
    """Inverse of :func:`gray_encode` via the XOR-shift cascade."""
    n = numpy.array(g, dtype=numpy.int64, copy=True)
    shift = 1
    while shift < 64:
        n ^= n >> shift
        shift *= 2
    return n


class Chromosome(Pickleable):
    """One candidate: a vector of genes, each a float in [min, max].

    The genotype is the per-gene fixed-point integer
    ``round((value - min) / (max - min) * (2**bits - 1))`` stored
    gray-coded; binary operators work on that code, numeric operators on
    the float vector (the reference's dual binary/numeric representation,
    ``core.py:145-204``).
    """

    BITS = 16

    def __init__(self, min_values, max_values, values=None, codes=None,
                 rand=None):
        super(Chromosome, self).__init__()
        self.min_values = numpy.asarray(min_values, dtype=numpy.float64)
        self.max_values = numpy.asarray(max_values, dtype=numpy.float64)
        self.fitness = None
        rand = rand or prng.get()
        if codes is not None:
            self.codes = numpy.asarray(codes, dtype=numpy.int64)
        elif values is not None:
            self.codes = self._encode(numpy.asarray(values,
                                                    dtype=numpy.float64))
        else:
            span = self.max_values - self.min_values
            vals = self.min_values + rand.rand(len(span)) * span
            self.codes = self._encode(vals)

    # -- genotype <-> phenotype -------------------------------------------

    @property
    def size(self):
        return len(self.min_values)

    @property
    def full_scale(self):
        return (1 << self.BITS) - 1

    def _encode(self, values):
        span = numpy.maximum(self.max_values - self.min_values, 1e-30)
        frac = numpy.clip((values - self.min_values) / span, 0.0, 1.0)
        ints = numpy.round(frac * self.full_scale).astype(numpy.int64)
        return gray_encode(ints)

    @property
    def numeric(self):
        """Decoded float values, always inside [min, max]."""
        ints = gray_decode(self.codes).astype(numpy.float64)
        frac = numpy.clip(ints / self.full_scale, 0.0, 1.0)
        return self.min_values + frac * (self.max_values - self.min_values)

    def copy(self):
        clone = Chromosome(self.min_values, self.max_values,
                           codes=self.codes.copy())
        clone.fitness = self.fitness
        return clone

    # -- mutation (``core.py:257-369``) -----------------------------------

    def mutate(self, kind, n_points, probability, rand=None):
        getattr(self, "mutation_" + kind)(n_points, probability,
                                          rand or prng.get())
        self.fitness = None

    def mutation_binary_point(self, n_points, probability, rand):
        """Flip random bits of random genes."""
        for _ in range(n_points):
            if rand.rand() >= probability:
                continue
            gene = rand.randint(self.size)
            bit = rand.randint(self.BITS)
            self.codes[gene] ^= (1 << bit)

    def mutation_altering(self, n_points, probability, rand):
        """Swap bit values between two random (gene, bit) positions."""
        for _ in range(n_points):
            if rand.rand() >= probability:
                continue
            g1, g2 = rand.randint(self.size), rand.randint(self.size)
            b1, b2 = rand.randint(self.BITS), rand.randint(self.BITS)
            v1 = (self.codes[g1] >> b1) & 1
            v2 = (self.codes[g2] >> b2) & 1
            self.codes[g1] = (self.codes[g1] & ~(1 << b1)) | (v2 << b1)
            self.codes[g2] = (self.codes[g2] & ~(1 << b2)) | (v1 << b2)

    def mutation_gaussian(self, n_points, probability, rand):
        """Add N(0, span/10) noise to random genes (numeric domain)."""
        values = self.numeric
        span = self.max_values - self.min_values
        for _ in range(n_points):
            if rand.rand() >= probability:
                continue
            gene = rand.randint(self.size)
            values[gene] += rand.normal(0.0, max(span[gene] / 10.0, 1e-30))
        numpy.clip(values, self.min_values, self.max_values, out=values)
        self.codes = self._encode(values)

    def mutation_uniform(self, n_points, probability, rand):
        """Resample random genes uniformly in their range."""
        values = self.numeric
        for _ in range(n_points):
            if rand.rand() >= probability:
                continue
            gene = rand.randint(self.size)
            values[gene] = (self.min_values[gene] + rand.rand() *
                            (self.max_values[gene] - self.min_values[gene]))
        self.codes = self._encode(values)

    def __repr__(self):
        return "<Chromosome %s fitness=%s>" % (
            numpy.array2string(self.numeric, precision=4), self.fitness)


class Population(Pickleable):
    """A set of chromosomes evolved generation by generation.

    Mirrors ``veles/genetics/core.py:371-801``: elitism keeps the best
    half, selection picks parents, crossover + mutation refill the
    population; ``pending`` yields chromosomes awaiting fitness so the
    optimizer (or its slaves) can evaluate them out of order.
    """

    def __init__(self, min_values, max_values, size=20, rand=None,
                 crossover_rate=0.9, mutation_probability=0.3):
        super(Population, self).__init__()
        self.min_values = numpy.asarray(min_values, dtype=numpy.float64)
        self.max_values = numpy.asarray(max_values, dtype=numpy.float64)
        self.size = int(size)
        self.generation = 0
        self.crossover_rate = crossover_rate
        self.mutation_probability = mutation_probability
        self.crossovers = ("pointed", "uniform", "arithmetic", "geometric")
        self.mutations = ("binary_point", "altering", "gaussian", "uniform")
        self.rand = rand or prng.get()
        self.chromosomes = [Chromosome(self.min_values, self.max_values,
                                       rand=self.rand)
                            for _ in range(self.size)]

    # -- container --------------------------------------------------------

    def __len__(self):
        return len(self.chromosomes)

    def __getitem__(self, i):
        return self.chromosomes[i]

    def __iter__(self):
        return iter(self.chromosomes)

    @property
    def pending(self):
        """Chromosomes whose fitness is not yet known."""
        return [c for c in self.chromosomes if c.fitness is None]

    @property
    def evaluated(self):
        return [c for c in self.chromosomes if c.fitness is not None]

    @property
    def best(self):
        done = self.evaluated
        return max(done, key=lambda c: c.fitness) if done else None

    @property
    def average_fitness(self):
        done = self.evaluated
        return (sum(c.fitness for c in done) / len(done)) if done else None

    # -- selection (``core.py:573-616``) ----------------------------------

    def select_roulette(self):
        """Fitness-proportionate pick (shifted to non-negative)."""
        done = self.evaluated
        fits = numpy.array([c.fitness for c in done], dtype=numpy.float64)
        fits = fits - fits.min() + 1e-12
        wheel = numpy.cumsum(fits / fits.sum())
        return done[int(numpy.searchsorted(wheel, self.rand.rand()))]

    def select_random(self):
        return self.evaluated[self.rand.randint(len(self.evaluated))]

    def select_tournament(self, k=3):
        done = self.evaluated
        picks = [done[self.rand.randint(len(done))]
                 for _ in range(min(k, len(done)))]
        return max(picks, key=lambda c: c.fitness)

    def select(self):
        kind = ("roulette", "tournament", "random")[self.rand.randint(3)]
        return getattr(self, "select_" + kind)()

    # -- crossover (``core.py:618-786``) ----------------------------------

    def cross_pointed(self, a, b):
        """k-point crossover on the flat gray bitstring."""
        bits = Chromosome.BITS
        total = a.size * bits
        k = 1 + self.rand.randint(3)
        points = sorted(self.rand.randint(1, total, size=k).tolist())
        codes = a.codes.copy()
        src = (a, b)
        which, prev = 0, 0
        for point in points + [total]:
            if which:
                for pos in range(prev, point):
                    gene, bit = divmod(pos, bits)
                    other = (src[1].codes[gene] >> bit) & 1
                    codes[gene] = ((codes[gene] & ~(1 << bit)) |
                                   (other << bit))
            which ^= 1
            prev = point
        return Chromosome(self.min_values, self.max_values, codes=codes)

    def cross_uniform(self, a, b):
        """Each bit independently from either parent."""
        mask = numpy.asarray(
            self.rand.randint(0, 1 << Chromosome.BITS, size=a.size),
            dtype=numpy.int64)
        codes = (a.codes & mask) | (b.codes & ~mask)
        return Chromosome(self.min_values, self.max_values, codes=codes)

    def cross_arithmetic(self, a, b):
        """Per-gene convex blend in the numeric domain."""
        t = self.rand.rand(a.size)
        values = t * a.numeric + (1.0 - t) * b.numeric
        return Chromosome(self.min_values, self.max_values, values=values)

    def cross_geometric(self, a, b):
        """Per-gene geometric mean (in range-relative coordinates)."""
        span = numpy.maximum(self.max_values - self.min_values, 1e-30)
        fa = numpy.clip((a.numeric - self.min_values) / span, 1e-12, 1.0)
        fb = numpy.clip((b.numeric - self.min_values) / span, 1e-12, 1.0)
        t = self.rand.rand(a.size)
        frac = numpy.power(fa, t) * numpy.power(fb, 1.0 - t)
        values = self.min_values + frac * span
        return Chromosome(self.min_values, self.max_values, values=values)

    def cross(self, a, b):
        kind = self.crossovers[self.rand.randint(len(self.crossovers))]
        return getattr(self, "cross_" + kind)(a, b)

    # -- generation step (``core.py:525-571``) ----------------------------

    def update(self):
        """Advance one generation. All fitnesses must be known."""
        if self.pending:
            raise ValueError("%d chromosomes still pending evaluation"
                             % len(self.pending))
        ranked = sorted(self.chromosomes, key=lambda c: c.fitness,
                        reverse=True)
        survivors = ranked[:max(2, self.size // 2)]
        children = []
        while len(survivors) + len(children) < self.size:
            if self.rand.rand() < self.crossover_rate:
                child = self.cross(self.select(), self.select())
            else:
                child = self.select().copy()
            child.mutate(
                self.mutations[self.rand.randint(len(self.mutations))],
                n_points=2, probability=self.mutation_probability,
                rand=self.rand)
            children.append(child)
        self.chromosomes = survivors + children
        self.generation += 1
        return self
