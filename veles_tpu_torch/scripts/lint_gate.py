#!/usr/bin/env python
"""The port's lint gate over its static checkers (the counterpart of
``scripts/lint_gate.py``, which gates the JAX package).

A committed baseline (``veles_tpu_torch/analysis/baseline.json``)
records the accepted findings with a human-written reason each; anything
the checkers find that is NOT in it fails the gate. Stale suppressions
(fingerprints no checker produces any more) are reported so the
baseline only shrinks.

Modes
-----
(default)          analyse veles_tpu_torch/ against the baseline; exit 1
                   on any unsuppressed finding.
--self-test        prove the gate CAN fail: run the checkers over the
                   known-bad fixtures in tests/fixtures/lint_torch/ and
                   REQUIRE every code of :data:`EXPECTED_CODES` to fire
                   (MET004 on a complete run of ``bad_metric.py`` beside
                   the fixture catalog ``bad_OBSERVABILITY.md``), and the
                   known-clean fixture to stay clean.
--update-baseline  rewrite the baseline from current findings (requires
                   --reason); for accepting or paying down debt
                   deliberately.

Run from a checkout: ``python veles_tpu_torch/scripts/lint_gate.py
[--self-test]``.
"""

import argparse
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, REPO)

from veles_tpu_torch.analysis import core  # noqa: E402
from veles_tpu_torch.analysis.__main__ import (BASELINE,  # noqa: E402
                                               PACKAGE, build_project)

FIXTURES = os.path.join(REPO, "tests", "fixtures", "lint_torch")

#: every code the self-test requires the bad fixtures to produce —
#: one per checker rule, so a silently dead rule fails the gate
EXPECTED_CODES = (
    "LOCK001", "LOCK002", "LOCK003",
    "KNOB001", "KNOB002", "KNOB003",
    "MET001", "MET002", "MET003", "MET004",
    "TRACE003", "TRACE004", "TRACE007",
)


def run_gate(baseline_path):
    project = build_project([os.path.join(REPO, PACKAGE)], REPO)
    findings = core.run_all(project)
    baseline = core.load_baseline(baseline_path)
    new, suppressed, stale = core.apply_baseline(findings, baseline)
    for f in new:
        print("FAIL %s" % f.render())
    if suppressed:
        print("     %d baseline-suppressed finding(s)" % len(suppressed))
    for fp in stale:
        print("WARN stale suppression %s — debt paid, remove it from "
              "%s" % (fp, BASELINE))
    print("lint gate: %d file(s), %d new finding(s) -> %s"
          % (len(project.modules), len(new),
             "FAIL" if new else "PASS"))
    return 1 if new else 0


def self_test_findings():
    """(findings of the bad fixtures, findings of the clean one)."""
    bad = [os.path.join(FIXTURES, name)
           for name in sorted(os.listdir(FIXTURES))
           if name.startswith("bad_") and name.endswith(".py")]
    findings = core.run_all(build_project(bad, REPO, complete=False))
    catalog = build_project(
        [os.path.join(FIXTURES, "bad_metric.py")], REPO, complete=True,
        doc_files=(os.path.relpath(os.path.join(
            FIXTURES, "bad_OBSERVABILITY.md"), REPO),))
    findings += core.run_all(catalog, ["metrics"])
    clean = core.run_all(build_project(
        [os.path.join(FIXTURES, "clean.py")], REPO, complete=False))
    return findings, clean


def run_self_test():
    findings, clean_findings = self_test_findings()
    fired = {f.code for f in findings}
    missing = [c for c in EXPECTED_CODES if c not in fired]
    ok = True
    if missing:
        ok = False
        print("SELF-TEST FAIL: known-bad fixtures did not trigger %s "
              "— those rules are dead and gate nothing"
              % ", ".join(missing))
    for f in clean_findings:
        ok = False
        print("SELF-TEST FAIL (clean fixture): %s" % f.render())
    print("lint gate self-test: %d finding(s) on bad fixtures, "
          "%d code(s) covered, clean fixture %s -> %s"
          % (len(findings), len(fired & set(EXPECTED_CODES)),
             "clean" if not clean_findings else "DIRTY",
             "PASS" if ok else "FAIL"))
    return 0 if ok else 1


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--baseline", default=os.path.join(REPO, BASELINE))
    parser.add_argument("--self-test", action="store_true")
    parser.add_argument("--update-baseline", action="store_true")
    parser.add_argument("--reason", default="")
    args = parser.parse_args(argv)
    if args.self_test:
        return run_self_test()
    if args.update_baseline:
        if not args.reason.strip():
            parser.error("--update-baseline requires --reason")
        project = build_project([os.path.join(REPO, PACKAGE)], REPO)
        findings = core.run_all(project)
        core.write_baseline(args.baseline, findings, args.reason)
        print("baseline rewritten: %d suppression(s)" % len(findings))
        return 0
    return run_gate(args.baseline)


if __name__ == "__main__":
    sys.exit(main())
