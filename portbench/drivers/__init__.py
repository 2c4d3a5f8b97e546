"""The drivers of the traffic mixes: one module a kind of work.

A traffic mix (``traffic/<mix>.json``) names its driver by the key
``driver``; the harness imports ``portbench.drivers.<driver>`` and runs
a cell through five functions of it:

* ``setup(cell, seed, device, phases, fault=None)``: builds the system
  under test from ``seed`` (``fault``: one of the driver's ``FAULTS``
  planted underneath), warms every shape the window will use, records
  what the comparison needs and returns the run's state; ``phases``
  (a dict) gets the seconds of its parts;
* ``window(state, seconds, traced)``: the measured window; returns the
  object the metrics' readers read, with ``attempted`` and ``failed``
  and, where ``traced``, ``profile`` (:func:`portbench.devtrace.
  summarize`'s dict); optionally ``summary()``, a line for standard
  error, and ``report()``, lines for standard output before the
  result;
* ``release(state)``: stops the system and frees its device memory;
* ``compare(state)``: after the release, the numbers that decide
  ``correct`` against the plain reference (``{name: number}``, held to
  the cell's limits by :func:`portbench.checks.verdict`);
* ``readings(cell, device, seeds, control_seeds, faults, fault_seeds,
  emit)``: the readings the cell's limits are set from
  (``calibrate.py``).

A serving, offload or snapshot cell arrives as a new driver module with
its mixes, configurations and metrics; no file of the harness changes.
"""
