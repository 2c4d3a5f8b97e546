"""Metric-contract checker: code <-> docs/torch/OBSERVABILITY.md <->
alerts (the port's copy of ``veles_tpu/analysis/metrics_contract.py``).

The port's telemetry plane has three parties that must agree on family
names: the code minting them through
:class:`veles_tpu_torch.telemetry.registry.MetricsRegistry`, the catalog
in ``docs/torch/OBSERVABILITY.md`` that operators build dashboards from,
and the ``DEFAULT_RULES`` in :mod:`veles_tpu_torch.telemetry.alerts` that
page on them. Drift between any two is silent until an alert never
fires or a dashboard panel stays blank.

Codes:

* **MET001** — a family minted in code (``registry.counter/gauge/
  histogram("veles_...")``) does not appear in the catalog.
* **MET002** — a ``.labels(...)`` value built from an f-string /
  ``%`` / ``.format`` expression: unbounded label cardinality is the
  classic way a metrics registry eats the heap. Label values must come
  from bounded sets (literals, enum-ish variables).
* **MET003** — an alert rule references a series (metric, numerator or
  denominator) whose family is never minted anywhere in the tree.
* **MET004** — a catalog row (a table row of a document whose name ends
  in ``OBSERVABILITY.md``) names a family no code mints (docs rot in the
  other direction). Only checked on a complete-tree run; the finding's
  path is the catalog's.

Family extraction is syntactic: first positional string-literal
argument of a ``.counter(...)`` / ``.gauge(...)`` / ``.histogram(...)``
call whose value starts with ``veles_``. Calls with a non-literal
first argument (e.g. ``numpy.histogram(data, bins)``) are skipped by
construction.
"""

import ast
import re

from veles_tpu_torch.analysis.core import Finding

MINTERS = frozenset(("counter", "gauge", "histogram"))

#: a family name never ends in '_' (that's a prose prefix mention
#: like ``veles_serving_cache_*``)
FAMILY_RE = re.compile(r"\bveles_[a-z0-9_]*[a-z0-9]\b")

#: doc tokens the regex matches that are not metric families
NOT_FAMILIES = frozenset(("veles_tpu", "veles_tpu_torch", "veles_cache_dir"))


def _minted_families(modules):
    """{family: (relpath, line)} across ``modules``."""
    out = {}
    for mod in modules:
        if mod.tree is None:
            continue
        for node in ast.walk(mod.tree):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr in MINTERS
                    and node.args):
                continue
            first = node.args[0]
            if isinstance(first, ast.Constant) \
                    and isinstance(first.value, str) \
                    and first.value.startswith("veles_"):
                out.setdefault(first.value, (mod.relpath, node.lineno))
    return out


def _label_calls(mod):
    """Yield (line, argnode) for every value passed to ``.labels()``."""
    for node in ast.walk(mod.tree):
        if (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "labels"):
            for arg in list(node.args) + [k.value for k in node.keywords]:
                yield node.lineno, arg


def _is_unbounded(arg):
    """Format-expression label values — the unbounded-cardinality
    shapes worth flagging."""
    if isinstance(arg, ast.JoinedStr):
        return any(isinstance(v, ast.FormattedValue) for v in arg.values)
    if isinstance(arg, ast.BinOp) and isinstance(arg.op, ast.Mod):
        return True   # "x-%s" % val
    if isinstance(arg, ast.Call) and isinstance(arg.func, ast.Attribute) \
            and arg.func.attr == "format":
        return True
    return False


def _alert_series(mod):
    """Series names referenced by ``DEFAULT_RULES`` (a pure literal —
    ``ast.literal_eval``-able by design)."""
    for node in ast.walk(mod.tree):
        if not (isinstance(node, ast.Assign) and len(node.targets) == 1):
            continue
        tgt = node.targets[0]
        if not (isinstance(tgt, ast.Name) and tgt.id == "DEFAULT_RULES"):
            continue
        try:
            rules = ast.literal_eval(node.value)
        except (ValueError, SyntaxError):
            return [(node.lineno, None,
                     "DEFAULT_RULES is no longer a pure literal — the "
                     "alert contract cannot be statically checked")]
        out = []
        for rule in rules:
            for field in ("metric", "numerator", "denominator"):
                name = rule.get(field)
                if name:
                    out.append((node.lineno,
                                "%s.%s" % (rule.get("name", "?"), field),
                                name))
        return out
    return []


def _family_of(series):
    """'veles_x_total{label="a"}' -> 'veles_x_total'."""
    return series.partition("{")[0]


def check(project):
    findings = []
    all_modules = list(project.modules) + list(project.aux)
    minted = _minted_families(all_modules)
    doc_text = "\n".join(project.docs.values())
    doc_families = set(FAMILY_RE.findall(doc_text))

    # MET001: minted but undocumented -------------------------------
    for family, (relpath, line) in sorted(minted.items()):
        if family not in doc_families:
            findings.append(Finding(
                "metrics", "MET001", relpath, line,
                "metric family %s is minted here but missing from the "
                "docs/torch/OBSERVABILITY.md catalog" % family,
                key=family))

    # MET002: unbounded label values --------------------------------
    for mod in project.modules:
        if mod.tree is None:
            continue
        for line, arg in _label_calls(mod):
            if _is_unbounded(arg):
                findings.append(Finding(
                    "metrics", "MET002", mod.relpath, line,
                    "format-expression label value: label sets must "
                    "be bounded (enum-like), not interpolated",
                    key="labels@%d" % line))

    # MET003: alert rules over unminted families --------------------
    for mod in all_modules:
        if mod.tree is None or not mod.relpath.endswith("alerts.py"):
            continue
        for line, where, series in _alert_series(mod):
            if where is None:
                findings.append(Finding(
                    "metrics", "MET003", mod.relpath, line, series,
                    key="rules-literal"))
                continue
            family = _family_of(series)
            if family not in minted:
                findings.append(Finding(
                    "metrics", "MET003", mod.relpath, line,
                    "alert rule %s references %s but no code mints "
                    "that family" % (where, family),
                    key="%s.%s" % (where, family)))

    # MET004: documented but never minted (complete runs only). Only
    # catalog TABLE rows count — prose may mention prefixes, module
    # paths and examples that are not family declarations.
    if project.complete:
        catalog = {}
        for relpath, text in sorted(project.docs.items()):
            if not relpath.endswith("OBSERVABILITY.md"):
                continue
            for docline in text.splitlines():
                if docline.lstrip().startswith("|"):
                    for family in FAMILY_RE.findall(docline):
                        catalog.setdefault(family, relpath)
        for family in sorted(set(catalog) - NOT_FAMILIES - set(minted)):
            findings.append(Finding(
                "metrics", "MET004", catalog[family], 0,
                "catalog lists %s but no code mints it" % family,
                key=family))
    return findings
