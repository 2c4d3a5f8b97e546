"""CLI entry point (``veles_tpu/__main__.py``):

    python -m veles_tpu_torch <workflow.py> [config.py] [root.a.b=value ...]

builds the workflow the file defines (its ``run(load, main)``, or else
the most derived ``Workflow`` subclass it defines), seeds the ``prng``
registry from ``-s`` (``default``, ``loader`` and ``chaos``; the keys a
short list leaves out are seeded from the first, as in the JAX
package), applies the config file and the ``root.`` overrides,
initializes the workflow on the card (``-a cpu`` for the CPU) and runs
it through ``FusedRunner``. ``-w <snapshot>`` resumes a snapshot (the
port's or the JAX package's), ``--test`` runs one forward-only epoch,
``--result-file`` writes the gathered metrics as JSON,
``--workflow-graph`` the DOT graph, ``--dry-run exec|init`` stops after
building or initializing, ``--precision`` picks the layers' precision
policy. The JAX CLI's other modes (``serve``, ``sched``, ``-l``/``-m``,
``--optimize``, the ensembles, ``-i``, ``--trace-out``) are not ported
yet.
"""

import importlib.util
import json
import logging
import os
import sys

from veles_tpu_torch import cmdline, prng
from veles_tpu_torch.config import apply_config_file, root
from veles_tpu_torch.launcher import Launcher
from veles_tpu_torch.logger import Logger, setup_logging

#: the precision policies of ``nn/precision.py``
PRECISIONS = ("float32", "bfloat16_mixed", "bfloat16")


class Main(Logger):
    """Parse args, seed, load model and config, run."""

    EXIT_SUCCESS = 0
    EXIT_FAILURE = 1

    def init_parser(self):
        parser = cmdline.init_parser(
            prog="veles_tpu_torch",
            description="the PyTorch/CUDA port of the veles_tpu workflow "
                        "platform")
        parser.add_argument("workflow", nargs="?",
                            help="path to the workflow Python file")
        parser.add_argument("config", nargs="?", default=None,
                            help="path to the config Python file "
                                 "(defaults to <workflow>_config.py)")
        parser.add_argument("overrides", nargs="*", default=[],
                            help="config overrides: root.path.to.key=value")
        parser.add_argument("-s", "--seed", default="1234",
                            help="RNG seed: INT | file:COUNT | "
                                 "comma-separated list applied to prng "
                                 "keys default,loader,chaos")
        parser.add_argument("-w", "--snapshot", default=None,
                            help="resume from a snapshot file")
        parser.add_argument("-v", "--verbosity", default="info",
                            choices=["debug", "info", "warning", "error"],
                            help="logging level")
        parser.add_argument("--dry-run", choices=["init", "exec"],
                            default=None,
                            help="stop after workflow construction (exec) "
                                 "or initialization (init)")
        parser.add_argument("--workflow-graph", default=None,
                            help="write the workflow DOT graph to this file")
        parser.add_argument("--result-file", default=None,
                            help="write gathered results JSON here")
        parser.add_argument("--precision", default=None, choices=PRECISIONS,
                            help="precision policy of the layers (default "
                                 "float32)")
        return parser

    # -- seeding -----------------------------------------------------------

    def _seed_random(self, spec):
        keys = ("default", "loader", "chaos")
        parts = str(spec).split(",")
        for key, one in zip(keys, parts):
            self._seed_one(key, one)
        # unseeded keys derive from the first
        for key in keys[len(parts):]:
            prng.get(key).seed(prng.get(keys[0]).randint(1 << 31))

    def _seed_one(self, key, spec):
        if ":" in spec:
            source, count = spec.rsplit(":", 1)
            with open(source, "rb") as f:
                data = f.read(int(count))
            seed = int.from_bytes(data[:8] or b"\x01", "little")
        else:
            seed = int(spec)
        prng.get(key).seed(seed)

    # -- model / config loading --------------------------------------------

    def _load_model(self, path):
        """Import the workflow file as a module."""
        path = os.path.abspath(path)
        if not os.path.exists(path):
            raise FileNotFoundError(path)
        name = os.path.splitext(os.path.basename(path))[0]
        sys.path.insert(0, os.path.dirname(path))
        try:
            spec = importlib.util.spec_from_file_location(name, path)
            module = importlib.util.module_from_spec(spec)
            sys.modules[name] = module
            spec.loader.exec_module(module)
        finally:
            sys.path.pop(0)
        return module

    def _override_config(self, overrides):
        """Exec positional ``root.a.b=value`` assignments."""
        for item in overrides:
            if "=" not in item:
                raise ValueError("config override %r is not key=value"
                                 % item)
            exec(item, {"root": root})  # noqa: S102 -- the JAX CLI's way

    def _find_workflow_class(self, module):
        from veles_tpu_torch.workflow import Workflow
        candidates = [
            obj for obj in vars(module).values()
            if isinstance(obj, type) and issubclass(obj, Workflow) and
            obj.__module__ == module.__name__]
        if not candidates:
            raise ValueError(
                "%s defines neither run(load, main) nor a Workflow "
                "subclass" % module.__name__)
        candidates.sort(key=lambda c: len(c.__mro__), reverse=True)
        return candidates[0]

    def _launcher_kwargs(self):
        args = self.args
        return {"backend": args.backend, "device": args.device,
                "testing": args.testing,
                "listen_address": args.listen_address,
                "master_address": args.master_address,
                "eager": args.eager, "gspmd": args.gspmd,
                "auto_resume": args.auto_resume}

    def _load(self, WorkflowClass, **kwargs):
        """Callback handed to the workflow file's run(load, main)."""
        self.launcher = Launcher(**self._launcher_kwargs())
        if self.args.snapshot:
            from veles_tpu_torch.snapshotter import SnapshotterToFile
            self.workflow = SnapshotterToFile.import_(self.args.snapshot)
            self.workflow.workflow = self.launcher
            snapshot = True
        else:
            self.workflow = WorkflowClass(self.launcher, **kwargs)
            snapshot = False
        return self.workflow, snapshot

    def _main(self, **kwargs):
        """Second callback: initialize and run under the launcher."""
        if self.args.dry_run == "exec":
            return
        self.launcher.initialize(**kwargs)
        if self.args.workflow_graph:
            with open(self.args.workflow_graph, "w") as f:
                f.write(self.workflow.generate_graph())
            self.info("wrote workflow graph to %s",
                      self.args.workflow_graph)
        if self.args.dry_run == "init":
            return
        self.launcher.run()
        self._write_results()
        self.workflow.print_stats()

    def _write_results(self):
        if not self.args.result_file:
            return
        results = self.workflow.gather_results()
        with open(self.args.result_file, "w") as f:
            json.dump(results, f, indent=2, default=str)
        self.info("wrote results to %s", self.args.result_file)

    def _run_regular(self, module):
        run_fn = getattr(module, "run", None)
        if callable(run_fn):
            run_fn(self._load, self._main)
        else:
            self._load(self._find_workflow_class(module))
            self._main()
        return self.EXIT_SUCCESS

    def run(self, argv=None):
        if argv is None:
            argv = sys.argv[1:]
        parser = self.init_parser()
        self.args = parser.parse_intermixed_args(argv)
        setup_logging(getattr(logging, self.args.verbosity.upper()))
        if not self.args.workflow:
            parser.print_usage()
            return self.EXIT_FAILURE
        # a bare k=v positional may have landed in config
        overrides = list(self.args.overrides)
        if self.args.config and "=" in self.args.config:
            overrides.insert(0, self.args.config)
            self.args.config = None
        if self.args.config is None:
            guess = os.path.splitext(self.args.workflow)[0] + "_config.py"
            self.args.config = guess if os.path.exists(guess) else None
        if self.args.precision:
            root.common.engine.precision_type = self.args.precision
        # refused flags fail before anything is built
        Launcher(**self._launcher_kwargs())
        self._seed_random(self.args.seed)
        module = self._load_model(self.args.workflow)
        if self.args.config:
            apply_config_file(self.args.config)
        self._override_config(overrides)
        return self._run_regular(module)


def main(argv=None):
    return Main().run(argv)


if __name__ == "__main__":
    sys.exit(main())
