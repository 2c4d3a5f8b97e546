"""``python -m veles_tpu_torch.analysis`` — run the checkers, apply the
baseline, exit non-zero on any unsuppressed finding.

The default invocation analyses the whole ``veles_tpu_torch/`` tree
against ``veles_tpu_torch/analysis/baseline.json`` and the port's
catalogs (``docs/torch/CONFIGURATION.md``, ``docs/torch/
OBSERVABILITY.md``) and README; ``veles_tpu_torch/scripts/lint_gate.py``
adds the gate's bookkeeping on top.
"""

import argparse
import json
import os
import sys

from veles_tpu_torch.analysis import core

PACKAGE = "veles_tpu_torch"

DOC_FILES = ("docs/torch/OBSERVABILITY.md", "docs/torch/CONFIGURATION.md",
             "README.md")

#: the committed baseline, relative to the repository's root
BASELINE = os.path.join(PACKAGE, "analysis", "baseline.json")


def repo_root_of(path):
    """Nearest ancestor of ``path`` containing ``veles_tpu_torch/`` (the
    checkout the catalogs live in)."""
    path = os.path.abspath(path)
    while True:
        if os.path.isdir(os.path.join(path, PACKAGE)):
            return path
        parent = os.path.dirname(path)
        if parent == path:
            return os.getcwd()
        path = parent


def build_project(paths, repo_root, complete=None, doc_files=DOC_FILES):
    if complete is None:
        # a run over the whole package may assert set-difference
        # contracts (catalog rows naming dead code); partial runs must not
        complete = any(
            os.path.abspath(p) == os.path.join(repo_root, PACKAGE)
            for p in paths)
    return core.Project.load(
        paths, repo_root,
        doc_paths=[os.path.join(repo_root, d) for d in doc_files],
        complete=complete)


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="python -m veles_tpu_torch.analysis",
        description="the port's lock-order, step-hygiene and "
                    "contract-drift checkers")
    parser.add_argument(
        "paths", nargs="*", default=None,
        help="files/dirs to analyse (default: the veles_tpu_torch "
             "package)")
    parser.add_argument(
        "--baseline", default=None, metavar="JSON",
        help="suppression baseline (default %s)" % BASELINE)
    parser.add_argument(
        "--no-baseline", action="store_true",
        help="report every finding, suppressing nothing")
    parser.add_argument(
        "--write-baseline", metavar="JSON",
        help="write current findings as a suppression baseline "
             "(requires --reason) and exit 0")
    parser.add_argument(
        "--reason", default="",
        help="reason recorded on every suppression --write-baseline "
             "emits")
    parser.add_argument(
        "--checker", action="append", dest="checkers",
        choices=("locks", "tracer", "metrics", "knobs"),
        help="run only this checker (repeatable; default all)")
    parser.add_argument(
        "--format", choices=("text", "json"), default="text")
    args = parser.parse_args(argv)

    here = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    repo_root = repo_root_of(here)
    paths = args.paths or [os.path.join(repo_root, PACKAGE)]
    project = build_project(paths, repo_root)
    findings = core.run_all(project, args.checkers)

    if args.write_baseline:
        if not args.reason.strip():
            parser.error("--write-baseline requires --reason "
                         "(every suppression must say why)")
        core.write_baseline(args.write_baseline, findings, args.reason)
        print("wrote %d suppression(s) to %s"
              % (len(findings), args.write_baseline))
        return 0

    baseline = {}
    if not args.no_baseline:
        baseline = core.load_baseline(
            args.baseline or os.path.join(repo_root, BASELINE))
    new, suppressed, stale = core.apply_baseline(findings, baseline)

    if args.format == "json":
        print(json.dumps({
            "new": [f.render() for f in new],
            "suppressed": [f.render() for f in suppressed],
            "stale_suppressions": stale,
            "files_analyzed": len(project.modules),
        }, indent=1))
    else:
        for f in new:
            print(f.render())
        if suppressed:
            print("-- %d baseline-suppressed finding(s) not shown "
                  "(see %s)" % (len(suppressed), BASELINE))
        for fp in stale:
            print("-- stale suppression %s: no checker produces it "
                  "any more — remove it from the baseline" % fp)
        print("veles-analyze (port): %d file(s), %d finding(s), %d new"
              % (len(project.modules), len(findings), len(new)))
    return 1 if new else 0


if __name__ == "__main__":
    sys.exit(main())
