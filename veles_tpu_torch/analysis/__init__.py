"""The port's static analysis plane (``veles_tpu/analysis/``'s
counterpart), over ``veles_tpu_torch/``.

Four AST checkers encode contracts the test suite cannot see — they
hold *between* runs, across threads, or between code and docs:

* :mod:`veles_tpu_torch.analysis.locks` — lock discipline, as the JAX
  package's: attributes consistently written under ``with self._lock:``
  must not be written outside it, lock acquisition order must be
  acyclic, and a non-reentrant ``threading.Lock`` must not be
  re-acquired on a path that already holds it.
* :mod:`veles_tpu_torch.analysis.tracer` — step hygiene: no host sync
  and no host RNG draw reachable from the training step, and no kernel
  called other than through ``ops/build.py`` ``launch``.
* :mod:`veles_tpu_torch.analysis.metrics_contract` — every metric
  family the port mints appears in the ``docs/torch/OBSERVABILITY.md``
  catalog, label values come from bounded sets, and every series that
  ``telemetry/alerts.py`` ``DEFAULT_RULES`` references resolves to a
  minted family.
* :mod:`veles_tpu_torch.analysis.knobs` — every ``VELES_*`` env knob is
  documented (``docs/torch/CONFIGURATION.md``) and parsed through
  :func:`veles_tpu_torch.envknob.env_knob`.

Pure stdlib ``ast``: no import of the analysed code, of ``torch`` or of
the JAX package. Findings carry ``file:line`` and a fingerprint that
does not depend on the line, so the committed baseline
(``veles_tpu_torch/analysis/baseline.json``) survives unrelated edits.
``python -m veles_tpu_torch.analysis`` runs everything;
``veles_tpu_torch/scripts/lint_gate.py`` is the gate (and its
``--self-test`` proves every rule can fire).
"""

from veles_tpu_torch.analysis.core import (  # noqa: F401
    Finding, Module, Project, load_baseline, run_all, write_baseline)
