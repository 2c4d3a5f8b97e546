"""Env-knob contract checker (the port's copy of
``veles_tpu/analysis/knobs.py``).

``VELES_*`` environment variables are the operational API of the port:
the launcher, the serving plane, the input pipeline, the elastic
supervisor and the card script all speak it. The contract (see
:mod:`veles_tpu_torch.envknob`):

* **KNOB001** — a ``VELES_*`` variable is read in code but documented
  nowhere (``docs/torch/CONFIGURATION.md`` is the port's catalog; a
  mention in any document the project loads satisfies the checker). An
  undocumented knob is one nobody can discover and everybody eventually
  collides with.
* **KNOB002** — a raw ``os.environ.get`` / ``os.getenv`` /
  ``os.environ[...]`` read of a ``VELES_*`` name outside
  ``envknob.py``. Raw reads reintroduce the empty-string crash class
  (``float(os.environ.get("X") or "")``) that
  :func:`veles_tpu_torch.envknob.env_knob` exists to kill. Membership
  tests (``"X" in os.environ``) and writes (``env["X"] = ...``,
  ``setdefault``) are fine — the hazard is parsing reads.
* **KNOB003** — a ``VELES_*`` read inside an ``add_argument(...)``
  call. An env-var buried in an argparse ``default=`` is evaluated at
  parser-build time and silently shadows later environment changes;
  resolve the knob at use time instead.

Names are resolved through module-level string constants
(``ENV_WORLD = "VELES_ELASTIC_WORLD"`` ... ``env_knob(ENV_WORLD)``).
``check(project, helpers)`` takes the helper names to recognise, the
port's by default (:data:`HELPER_CALLS`); given the JAX package's
(:data:`JAX_HELPER_CALLS`) and its documents it gives the JAX checker's
findings.
"""

import ast
import re

from veles_tpu_torch.analysis.core import (Finding, dotted_name,
                                           import_aliases, resolve_call)

KNOB_RE = re.compile(r"\bVELES_[A-Z0-9_]+\b")

RAW_READ_CALLS = frozenset(("os.environ.get", "os.getenv"))
HELPER_CALLS = frozenset((
    "env_knob", "env_flag",
    "veles_tpu_torch.envknob.env_knob", "veles_tpu_torch.envknob.env_flag"))
#: the JAX package's helper names (its checker's)
JAX_HELPER_CALLS = frozenset((
    "env_knob", "env_flag",
    "veles_tpu.envknob.env_knob", "veles_tpu.envknob.env_flag"))


def _str_consts(tree):
    """Module-level ``NAME = "VELES_..."`` constants."""
    out = {}
    for node in tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name) \
                and isinstance(node.value, ast.Constant) \
                and isinstance(node.value.value, str):
            out[node.targets[0].id] = node.value.value
    return out


def _knob_name(node, consts):
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        value = node.value
    elif isinstance(node, ast.Name):
        value = consts.get(node.id)
    else:
        return None
    if value and KNOB_RE.fullmatch(value):
        return value
    return None


def _reads(mod, aliases, consts, helpers):
    """Yield (name, line, raw, node) for every VELES_* env read."""
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.Call):
            target = resolve_call(node, aliases)
            if target in RAW_READ_CALLS and node.args:
                name = _knob_name(node.args[0], consts)
                if name:
                    yield name, node.lineno, True, node
            elif target in helpers and node.args:
                name = _knob_name(node.args[0], consts)
                if name:
                    yield name, node.lineno, False, node
        elif isinstance(node, ast.Subscript) \
                and isinstance(node.ctx, ast.Load) \
                and dotted_name(node.value) == "os.environ":
            name = _knob_name(node.slice, consts)
            if name:
                yield name, node.lineno, True, node


def check(project, helpers=HELPER_CALLS):
    findings = []
    doc_text = "\n".join(project.docs.values())
    documented = set(KNOB_RE.findall(doc_text))

    for mod in project.modules:
        if mod.tree is None:
            continue
        aliases = import_aliases(mod.tree)
        consts = _str_consts(mod.tree)
        is_helper = mod.relpath.endswith("envknob.py")

        argparse_spans = []
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Call) \
                    and isinstance(node.func, ast.Attribute) \
                    and node.func.attr == "add_argument":
                argparse_spans.append(
                    set(id(n) for n in ast.walk(node)))

        seen = set()
        for name, line, raw, node in _reads(mod, aliases, consts, helpers):
            if project.docs and name not in documented \
                    and (name, "KNOB001") not in seen:
                seen.add((name, "KNOB001"))
                findings.append(Finding(
                    "knobs", "KNOB001", mod.relpath, line,
                    "%s is read here but documented nowhere — add it "
                    "to docs/torch/CONFIGURATION.md" % name,
                    key="doc.%s" % name))
            if raw and not is_helper \
                    and (name, "KNOB002", line) not in seen:
                seen.add((name, "KNOB002", line))
                findings.append(Finding(
                    "knobs", "KNOB002", mod.relpath, line,
                    "raw environment read of %s — route it through "
                    "veles_tpu_torch.envknob.env_knob (empty-string-"
                    "safe, one parse contract)" % name,
                    key="raw.%s" % name))
            if any(id(node) in span for span in argparse_spans) \
                    and (name, "KNOB003") not in seen:
                seen.add((name, "KNOB003"))
                findings.append(Finding(
                    "knobs", "KNOB003", mod.relpath, line,
                    "%s read inside add_argument(): the value is "
                    "frozen at parser build and shadows the "
                    "environment — resolve it at use time" % name,
                    key="argparse.%s" % name))
    return findings
