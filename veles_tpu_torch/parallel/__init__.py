"""The port's ``veles_tpu/parallel``.

The master/slave control plane: ``coordinator.py``, its codec
``wire.py``, ``retry.py`` and the node spawner ``nodes.py``.

The SPMD tier over ``torch.distributed``, one process per rank with the
collectives written out: ``mesh.py`` (the rank grid, placements, the
multi-process runtime and the backend rule), ``collectives.py`` (the
collectives and their autograd transposes), ``reshard.py`` (the measured
layout moves), ``dp.py`` and ``gspmd.py`` (the data- and tensor-parallel
trainers of ``--gspmd``), ``tp.py`` (the column/row plan and forms),
``pp.py`` (the GPipe pipeline), the sharded halves of ``sequence.py``
(ring and Ulysses attention) and ``ep.py`` (the expert-parallel MoE
FFN).

The elastic tier: ``elastic.py`` (the rendezvous server, the per-host
supervisor and the worker's restore-rewind-train harness over the
snapshotter's sharded generations).

The JAX package's ``compat.py`` (its ``shard_map`` API drift) has no
counterpart; ``warm_pool.py`` comes with a later slice."""
