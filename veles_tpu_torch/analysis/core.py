"""Shared analyzer plumbing: findings, fingerprints, baselines.

A :class:`Finding` is one checker hit. Its *fingerprint* hashes
``checker | code | repo-relative path | key`` — deliberately NOT the
line number, so a baseline entry survives edits elsewhere in the file.
``key`` is whatever identifies the finding within the file (a
qualified function name, an attribute, a metric family, a knob name);
two distinct findings in one file must differ in ``key``.

The port's copy of ``veles_tpu/analysis/core.py``, with the same
findings, fingerprints and baseline format, so a finding of either
package's checkers over the same file has the same fingerprint.

The baseline (``veles_tpu_torch/analysis/baseline.json``) is the
ratchet: accepted debt is recorded there with a human-written reason,
anything NOT in it fails the gate. Stale entries (fingerprints no
checker produces any more) are reported by the gate so the file shrinks
as debt is paid.
"""

import ast
import hashlib
import json
import os


BASELINE_SCHEMA = "veles-lint-baseline/1"


class Finding(object):
    """One checker hit, ordered by (path, line, code)."""

    __slots__ = ("checker", "code", "path", "line", "message", "key")

    def __init__(self, checker, code, path, line, message, key):
        self.checker = checker
        self.code = code
        self.path = path        # repo-relative, '/'-separated
        self.line = int(line)
        self.message = message
        self.key = key

    @property
    def fingerprint(self):
        blob = "|".join((self.checker, self.code, self.path, self.key))
        return hashlib.sha256(blob.encode()).hexdigest()[:16]

    def render(self):
        return "%s:%d: %s %s [%s]" % (
            self.path, self.line, self.code, self.message,
            self.fingerprint)

    def sort_key(self):
        return (self.path, self.line, self.code, self.key)

    def __repr__(self):
        return "Finding(%s)" % self.render()


class Module(object):
    """One parsed source file. ``tree`` is None on a syntax error (the
    error itself becomes a CORE001 finding — an unparseable file must
    fail the gate, not vanish from it)."""

    def __init__(self, path, relpath, source, tree, error=None):
        self.path = path
        self.relpath = relpath
        self.source = source
        self.tree = tree
        self.error = error

    @classmethod
    def parse(cls, path, relpath):
        with open(path, encoding="utf-8", errors="replace") as f:
            source = f.read()
        try:
            tree = ast.parse(source, filename=path)
            return cls(path, relpath, source, tree)
        except SyntaxError as e:
            return cls(path, relpath, source, None, error=e)


class Project(object):
    """The unit the checkers run over.

    ``modules``   parsed python files under the analyzed roots.
    ``docs``      {relpath: text} of the markdown contracts.
    ``aux``       extra parsed files that may legitimately mint
                  metrics or read knobs but are not themselves being
                  linted.
    ``complete``  True when the analyzed roots cover the whole package
                  — gates the set-difference checks (doc entries with
                  no code counterpart) that would false-positive on a
                  partial file list.
    """

    def __init__(self, modules, docs=None, aux=None, complete=False):
        self.modules = modules
        self.docs = docs or {}
        self.aux = aux or []
        self.complete = complete

    @classmethod
    def load(cls, paths, repo_root, doc_paths=(), aux_paths=(),
             complete=False):
        modules = [Module.parse(p, _rel(p, repo_root))
                   for p in _expand(paths)]
        docs = {}
        for p in doc_paths:
            if os.path.isfile(p):
                with open(p, encoding="utf-8", errors="replace") as f:
                    docs[_rel(p, repo_root)] = f.read()
        aux = [Module.parse(p, _rel(p, repo_root))
               for p in _expand(aux_paths)]
        return cls(modules, docs, aux, complete=complete)

    def parse_errors(self):
        out = []
        for mod in self.modules:
            if mod.error is not None:
                out.append(Finding(
                    "core", "CORE001", mod.relpath,
                    mod.error.lineno or 0,
                    "syntax error: %s" % mod.error.msg,
                    key="syntax"))
        return out


def _rel(path, root):
    rel = os.path.relpath(os.path.abspath(path), os.path.abspath(root))
    return rel.replace(os.sep, "/")


def _expand(paths):
    """Files and directories -> sorted list of .py files."""
    out = []
    for p in paths:
        if os.path.isdir(p):
            for dirpath, dirnames, filenames in os.walk(p):
                dirnames[:] = sorted(
                    d for d in dirnames
                    if d not in ("__pycache__", ".git"))
                for name in sorted(filenames):
                    if name.endswith(".py"):
                        out.append(os.path.join(dirpath, name))
        elif p.endswith(".py") and os.path.isfile(p):
            out.append(p)
    return out


def run_all(project, checkers=None):
    """Every checker over ``project`` -> sorted finding list."""
    from veles_tpu_torch.analysis import (knobs, locks, metrics_contract,
                                          tracer)
    table = {
        "locks": locks.check,
        "tracer": tracer.check,
        "metrics": metrics_contract.check,
        "knobs": knobs.check,
    }
    names = checkers or sorted(table)
    findings = list(project.parse_errors())
    for name in names:
        findings.extend(table[name](project))
    findings.sort(key=Finding.sort_key)
    return findings


# -- baseline ----------------------------------------------------------------


def load_baseline(path):
    """{fingerprint: entry} from the committed baseline (empty when the
    file does not exist — a missing baseline suppresses nothing)."""
    if not os.path.isfile(path):
        return {}
    with open(path, encoding="utf-8") as f:
        data = json.load(f)
    if data.get("schema") != BASELINE_SCHEMA:
        raise ValueError("unrecognized baseline schema %r in %s"
                         % (data.get("schema"), path))
    out = {}
    for entry in data.get("suppressions", ()):
        fp = entry.get("fingerprint")
        if not fp:
            raise ValueError("baseline entry without fingerprint: %r"
                             % (entry,))
        if not entry.get("reason", "").strip():
            raise ValueError(
                "baseline suppression %s has no reason — every "
                "suppression must say WHY it is acceptable" % fp)
        out[fp] = entry
    return out


def write_baseline(path, findings, reason):
    """Serialize ``findings`` as suppressions (``--write-baseline``)."""
    entries = [
        {"fingerprint": f.fingerprint,
         "code": f.code,
         "location": "%s:%d" % (f.path, f.line),
         "summary": f.message[:120],
         "reason": reason}
        for f in sorted(findings, key=Finding.sort_key)]
    data = {"schema": BASELINE_SCHEMA, "suppressions": entries}
    with open(path, "w", encoding="utf-8") as f:
        json.dump(data, f, indent=1, sort_keys=False)
        f.write("\n")


def apply_baseline(findings, baseline):
    """-> (new, suppressed, stale_fingerprints)."""
    new, suppressed = [], []
    seen = set()
    for f in findings:
        fp = f.fingerprint
        if fp in baseline:
            suppressed.append(f)
            seen.add(fp)
        else:
            new.append(f)
    stale = sorted(set(baseline) - seen)
    return new, suppressed, stale


# -- small AST helpers shared by the checkers --------------------------------


def dotted_name(node):
    """``a.b.c`` for Name/Attribute chains, else None."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def import_aliases(tree):
    """{local name: canonical dotted module} for a module's imports.

    ``import numpy as np`` -> {"np": "numpy"};
    ``from torch import nn`` -> {"nn": "torch.nn"};
    ``from time import monotonic`` -> {"monotonic": "time.monotonic"}.
    """
    aliases = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                aliases[a.asname or a.name.split(".")[0]] = (
                    a.name if a.asname else a.name.split(".")[0])
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            for a in node.names:
                if a.name == "*":
                    continue
                aliases[a.asname or a.name] = (
                    node.module + "." + a.name)
    return aliases


def resolve_call(node, aliases):
    """Canonical dotted target of a Call ('time.time', 'numpy.random.
    uniform', ...) with the module's import aliases folded in."""
    name = dotted_name(node.func if isinstance(node, ast.Call) else node)
    if not name:
        return None
    head, _, rest = name.partition(".")
    canon = aliases.get(head)
    if canon:
        return canon + ("." + rest if rest else "")
    return name
