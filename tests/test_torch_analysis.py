"""The port's static analysis plane (``veles_tpu_torch/analysis/``) on the
CPU: ``tests/test_analysis.py``'s pins on the port's checkers and its
fixtures (``tests/fixtures/lint_torch/``), and the port held to the JAX
package's checkers.

* Each checker on its known-bad fixture, the clean fixture against every
  checker, a syntax error as a finding, fingerprints that survive line
  shifts, the baseline's round trip and its reason rule, the whole
  ``veles_tpu_torch/`` tree with no unsuppressed finding (and no stale
  suppression), the gate's CLI and ``--self-test``, the CLI exiting 1 on
  each bad fixture.
* Against ``veles_tpu.analysis``: the ``locks`` checker gives the JAX
  checker's findings (code, path, line, key, message, fingerprint) on
  every file of ``tests/fixtures/lint/``; ``knobs`` and
  ``metrics_contract``, given the JAX package's documents and helper
  names, give its findings on ``bad_knob.py``, ``bad_metric.py`` and
  ``bad_alerts.py``.
* No module under ``veles_tpu_torch/analysis/`` imports ``jax``, any
  ``veles_tpu`` module or ``torch``: read from their source, and in a
  fresh interpreter that runs the gate.
"""

import ast
import json
import os
import subprocess
import sys

import pytest

from veles_tpu_torch.analysis import core, knobs, locks, metrics_contract
from veles_tpu_torch.analysis.__main__ import BASELINE, build_project

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "fixtures", "lint_torch")
JAX_FIXTURES = os.path.join(REPO, "tests", "fixtures", "lint")
GATE = os.path.join(REPO, "veles_tpu_torch", "scripts", "lint_gate.py")
BAD = sorted(n for n in os.listdir(FIXTURES)
             if n.startswith("bad_") and n.endswith(".py"))


def analyze(*names, checkers=None):
    paths = [os.path.join(FIXTURES, n) for n in names]
    project = build_project(paths, REPO, complete=False)
    return core.run_all(project, checkers)


def codes(findings):
    return sorted(f.code for f in findings)


# -- per-checker pins --------------------------------------------------------


def test_lock_fixture_fires():
    findings = analyze("bad_lock.py", checkers=["locks"])
    by_code = codes(findings)
    # reset(): two unlocked writes (count assignment, items.clear())
    assert by_code.count("LOCK001") == 2
    # outer(): direct re-entry; indirect(): via helper()
    assert by_code.count("LOCK003") == 2
    keys = {f.key for f in findings}
    assert "TornCounter.reset.count" in keys
    assert "TornCounter.reset.items" in keys


def test_lock_order_cycle_fires_once():
    findings = analyze("bad_lock_order.py", checkers=["locks"])
    assert codes(findings) == ["LOCK002"]
    assert "_a" in findings[0].message and "_b" in findings[0].message


def test_tracer_fixture_fires_every_code():
    findings = analyze("bad_step.py", checkers=["tracer"])
    fired = codes(findings)
    assert fired.count("TRACE003") == 2
    # .item(), float() of a norm, .tolist(), synchronize()
    assert fired.count("TRACE004") == 4
    assert fired.count("TRACE007") == 2
    keys = {f.key for f in findings}
    # roots: an autograd Function's forward and backward, train_batch
    assert {"forward.item", "backward.cast.float",
            "train_batch.tolist", "train_batch.synchronize"} <= keys
    # taint: _jitter is reached only from the backward
    assert "_jitter.random.random" in keys
    # float() of a numpy sum is no host sync; the launch is on-stream
    assert not any(f.key == "forward.cast.float" for f in findings)
    launched = {f.line for f in findings if f.code == "TRACE007"}
    source = open(os.path.join(FIXTURES, "bad_step.py")).read()
    lines = source.splitlines()
    assert all("build.launch" not in lines[n - 1] for n in launched)
    assert len({f.fingerprint for f in findings}) == len(findings)


def test_metric_fixture():
    findings = analyze("bad_metric.py", "bad_alerts.py",
                       checkers=["metrics"])
    fired = codes(findings)
    assert "MET001" in fired          # ghost family not in the catalog
    assert fired.count("MET002") == 2  # f-string and %-format labels
    met3 = [f for f in findings if f.code == "MET003"]
    flagged = {f.key.split(".")[-1] for f in met3}
    assert "veles_fixture_never_minted_total" in flagged
    assert "veles_fixture_also_never_minted_total" in flagged
    # veles_step_ms is minted inside the fixture set -> not flagged
    assert "veles_step_ms" not in flagged
    catalog = os.path.relpath(os.path.join(FIXTURES, "bad_OBSERVABILITY.md"),
                              REPO)
    project = build_project([os.path.join(FIXTURES, "bad_metric.py")],
                            REPO, complete=True, doc_files=(catalog,))
    met4 = [f for f in core.run_all(project, ["metrics"])
            if f.code == "MET004"]
    assert [(f.key, f.path) for f in met4] == [
        ("veles_fixture_catalog_only_total", catalog)]


def test_knob_fixture():
    findings = analyze("bad_knob.py", checkers=["knobs"])
    fired = codes(findings)
    assert "KNOB001" in fired
    assert fired.count("KNOB002") == 2   # .get() and subscript reads
    assert "KNOB003" in fired
    argparse_finding = next(f for f in findings if f.code == "KNOB003")
    assert "VELES_FIXTURE_ARGPARSE_KNOB" in argparse_finding.message


def test_clean_fixture_is_clean():
    assert analyze("clean.py") == []


def test_syntax_error_is_a_finding(tmp_path):
    bad = tmp_path / "broken.py"
    bad.write_text("def f(:\n")
    project = core.Project.load([str(bad)], str(tmp_path))
    findings = core.run_all(project)
    assert [f.code for f in findings] == ["CORE001"]


# -- fingerprints & baseline -------------------------------------------------


@pytest.mark.parametrize("name", ["bad_lock.py", "bad_step.py"])
def test_fingerprint_survives_line_shifts(tmp_path, name):
    src = open(os.path.join(FIXTURES, name)).read()
    a = tmp_path / "mod.py"
    a.write_text(src)
    before = core.run_all(core.Project.load([str(a)], str(tmp_path)))
    assert before
    a.write_text("# one\n# two\n# three\n" + src)
    after = core.run_all(core.Project.load([str(a)], str(tmp_path)))
    assert [f.fingerprint for f in before] == \
        [f.fingerprint for f in after]
    assert [f.line + 3 for f in before] == [f.line for f in after]


def test_baseline_roundtrip(tmp_path):
    findings = analyze("bad_lock.py", checkers=["locks"])
    path = str(tmp_path / "baseline.json")
    core.write_baseline(path, findings, "accepted, tracked")
    baseline = core.load_baseline(path)
    new, suppressed, stale = core.apply_baseline(findings, baseline)
    assert new == [] and len(suppressed) == len(findings)
    assert stale == []
    # a fixed finding leaves its suppression stale
    new, suppressed, stale = core.apply_baseline(findings[1:], baseline)
    assert stale == [findings[0].fingerprint]


def test_baseline_requires_reason(tmp_path):
    path = tmp_path / "baseline.json"
    path.write_text(json.dumps({
        "schema": core.BASELINE_SCHEMA,
        "suppressions": [{"fingerprint": "abc123", "reason": "  "}]}))
    with pytest.raises(ValueError, match="reason"):
        core.load_baseline(str(path))
    # the CLI refuses to write one without --reason
    proc = subprocess.run(
        [sys.executable, "-m", "veles_tpu_torch.analysis",
         "--write-baseline", str(tmp_path / "out.json"),
         os.path.join(FIXTURES, "bad_lock.py")],
        capture_output=True, text=True, timeout=120, cwd=REPO)
    assert proc.returncode == 2 and "--reason" in proc.stderr
    # every committed suppression says why
    with open(os.path.join(REPO, BASELINE)) as f:
        entries = json.load(f)["suppressions"]
    assert entries and all(len(e["reason"].split()) >= 10
                           for e in entries)


def test_missing_baseline_suppresses_nothing(tmp_path):
    assert core.load_baseline(str(tmp_path / "absent.json")) == {}


# -- the whole-tree invariant ------------------------------------------------


def test_repo_tree_has_no_unsuppressed_findings():
    """``python -m veles_tpu_torch.analysis`` is clean at head, its
    baseline has no stale entry, and the catalogs have no row that
    nothing mints (the run is complete)."""
    project = build_project([os.path.join(REPO, "veles_tpu_torch")], REPO)
    assert project.complete
    assert {"docs/torch/CONFIGURATION.md", "docs/torch/OBSERVABILITY.md",
            "README.md"} <= set(project.docs)
    findings = core.run_all(project)
    baseline = core.load_baseline(os.path.join(REPO, BASELINE))
    new, _, stale = core.apply_baseline(findings, baseline)
    assert new == [], "\n".join(f.render() for f in new)
    assert stale == [], "stale suppressions: %s" % (stale,)


def test_lint_gate_cli_and_self_test():
    for extra in ([], ["--self-test"]):
        proc = subprocess.run(
            [sys.executable, GATE] + extra, capture_output=True,
            text=True, timeout=120)
        assert proc.returncode == 0, proc.stdout + proc.stderr
        assert "PASS" in proc.stdout
    assert "13 code(s) covered" in proc.stdout


@pytest.mark.parametrize("name", BAD)
def test_cli_fails_on_bad_fixture(name):
    """The gate proves it can fail: each known-bad fixture exits 1
    through the real CLI."""
    proc = subprocess.run(
        [sys.executable, "-m", "veles_tpu_torch.analysis", "--no-baseline",
         os.path.join(FIXTURES, name)],
        capture_output=True, text=True, timeout=120, cwd=REPO)
    assert proc.returncode == 1, proc.stdout + proc.stderr


# -- against the JAX package's checkers --------------------------------------


def _same(got, want):
    key = lambda f: (f.code, f.path, f.line, f.key, f.fingerprint)  # noqa
    assert [key(f) for f in got] == [key(f) for f in want]


@pytest.mark.parametrize("name", sorted(
    n for n in os.listdir(JAX_FIXTURES) if n.endswith(".py")))
def test_locks_match_jax(name):
    from veles_tpu.analysis import core as jax_core
    from veles_tpu.analysis import locks as jax_locks
    path = os.path.join(JAX_FIXTURES, name)
    got = locks.check(core.Project.load([path], REPO))
    want = jax_locks.check(jax_core.Project.load([path], REPO))
    _same(got, want)
    assert [f.message for f in got] == [f.message for f in want]


@pytest.mark.parametrize("names,checker", [
    (("bad_knob.py",), "knobs"),
    (("bad_metric.py", "bad_alerts.py"), "metrics")])
def test_knobs_and_metrics_match_jax(names, checker):
    """Given the JAX package's documents and helper names, the port's
    checkers give its findings (they differ only in what their messages
    tell the reader to edit)."""
    from veles_tpu.analysis import knobs as jax_knobs
    from veles_tpu.analysis import metrics_contract as jax_metrics
    from veles_tpu.analysis.__main__ import DOC_FILES
    from veles_tpu.analysis.__main__ import build_project as jax_project
    paths = [os.path.join(JAX_FIXTURES, n) for n in names]
    want_project = jax_project(paths, REPO, complete=False)
    project = build_project(paths, REPO, complete=False,
                            doc_files=DOC_FILES)
    assert project.docs == want_project.docs
    if checker == "knobs":
        got = knobs.check(project, helpers=knobs.JAX_HELPER_CALLS)
        want = jax_knobs.check(want_project)
        assert codes(got) == ["KNOB001"] * 4 + ["KNOB002"] * 2 + \
            ["KNOB003"]
        # with the port's helper names, the JAX helper is not recognised
        assert len(knobs.check(project)) < len(got)
    else:
        got = metrics_contract.check(project)
        want = jax_metrics.check(want_project)
        assert "MET003" in codes(got)
    _same(got, want)


# -- no JAX, no torch --------------------------------------------------------


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_analysis_imports_neither_jax_nor_the_jax_package():
    """Read from the source, then in a fresh interpreter that runs the
    whole gate: no ``jax``, no ``veles_tpu`` module and no ``torch``."""
    folder = os.path.join(REPO, "veles_tpu_torch", "analysis")
    sources = [os.path.join(folder, n) for n in sorted(os.listdir(folder))
               if n.endswith(".py")] + [GATE]
    assert len(sources) == 8
    for path in sources:
        for name in _imports(path):
            top = name.split(".")[0]
            assert top not in ("jax", "veles_tpu", "torch"), (path, name)
    code = (
        "import runpy, sys\n"
        "sys.argv = [%r]\n"
        "try:\n"
        "    runpy.run_path(%r, run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    assert e.code == 0, e.code\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'veles_tpu', 'torch'))\n"
        "print('LOADED', bad)\n"
        "sys.exit(1 if bad else 0)\n") % (GATE, GATE)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "LOADED []" in proc.stdout
