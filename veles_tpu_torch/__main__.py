"""CLI entry point (``veles_tpu/__main__.py``):

    python -m veles_tpu_torch <workflow.py> [config.py] [root.a.b=value ...]

builds the workflow the file defines (its ``run(load, main)``, or else
the most derived ``Workflow`` subclass it defines), seeds the ``prng``
registry from ``-s`` (``default``, ``loader`` and ``chaos``; the keys a
short list leaves out are seeded from the first, as in the JAX
package), applies the config file and the ``root.`` overrides,
initializes the workflow on the card (``-a cpu`` for the CPU) and runs
it through ``FusedRunner`` (the eager per-unit scheduler with
``--eager``, or when the fused path refuses the graph). ``-w
<snapshot>`` resumes a snapshot (the port's or the JAX package's: a
file, a snapshot directory, ``http(s)://...`` or ``sqlite://<db>[#key]``),
``--test`` runs one forward-only epoch, ``--result-file`` writes the
gathered metrics as JSON, ``--workflow-graph`` the DOT graph,
``--dry-run exec|init`` stops after building or initializing,
``--precision`` picks the layers' precision policy, ``-i`` opens a
console between initializing and running (``workflow``, ``launcher``,
``units``, ``root`` and ``main()`` in scope; IPython on a terminal that
has it, ``code.interact`` otherwise; ``main()`` runs once, and leaving
the console runs it if it has not run). ``--trace-out FILE`` enables
span tracing (removing a stale FILE first) and, at exit, writes the
trace buffer there (Chrome trace-event JSON: open it in Perfetto) and,
on the card, the caching allocator's snapshot, recorded from the start,
to ``FILE.memprof``. Every run starts the memory sampler
(``VELES_MEMORY_SAMPLE_S``; 0 turns it off). ``--web-status`` posts the
run's status, logs and events to the dashboard at ``root.common.web``
(``python -m veles_tpu_torch.web_status``); with plotting on
(``root.common.disable.plotting=False`` where there is no display) the
launcher starts the graphics server that the workflow's plotters send
to, unless ``--no-graphics``.

    python -m veles_tpu_torch serve --model <snapshot | URI | package> ...

is the serving engine (``serving/frontend.py`` ``main``).

    python -m veles_tpu_torch -l HOST:PORT <workflow.py> [...]
    python -m veles_tpu_torch -m HOST:PORT <workflow.py> [...]

run the workflow as a master (no device: it holds the weights and
merges the slaves' deltas) and as a slave (on the card, or the CPU with
``-a cpu``), with the flags of ``launcher.Launcher`` (``--segment-size``,
``--no-pipeline``, ``--exchange-dtype``, ``--auto-resume``, ...); both
load the same file with the same ``-s`` seed, so their topology
checksums and initial weights agree.

    python -m veles_tpu_torch --gspmd 2x1 <workflow.py> [...]

trains through the SPMD tier: this process is rank 0 of a ``batch`` x
``model`` world and starts the other ranks itself; with
``--jax-coordinator HOST:PORT --jax-processes N --jax-process-id K`` on
every process, each joins a world of N instead (``launcher.py``). Each
rank loads the same file with the same seed; rank 0 alone writes
``--result-file`` and snapshots.

    python -m veles_tpu_torch.parallel.elastic rendezvous | supervise | worker-demo

is the elastic tier (``parallel/elastic.py``): a rendezvous server, a
per-host supervisor that restarts its SPMD worker in each new membership
generation, and a demo worker that trains from the newest complete
sharded checkpoint generation.

    python -m veles_tpu_torch --optimize GENS:POP <workflow.py> <config.py>

evolves the config's ``Tune`` leaves (``genetics/``): each chromosome's
fitness is a training run in one warm evaluator process
(``parallel/warm_pool.py``) with the chromosome's values as ``root.``
overrides, the best written to ``--result-file`` with every evaluation.

    python -m veles_tpu_torch --ensemble-train N[:RATIO] <workflow.py> [...]
    python -m veles_tpu_torch --ensemble-test RESULTS <workflow.py> [...]

train N members (seeds ``1234 + 1000 i``, each on ``RATIO`` of the train
set, default 0.8, each snapshotting under its own ``_m<i>`` tag) into
``--result-file`` (default ``ensemble.json``), and test each member from
its snapshot (``--test``) with the metrics aggregated (default
``ensemble_test.json``). ``--train-ratio R`` cuts a plain run's train
set the same way.

    python -m veles_tpu_torch sched serve | submit | status

is the gang scheduler (``sched/cli.py``): ``serve`` runs the scheduler
and its HTTP control endpoint, ``submit`` and ``status`` talk to it.
"""

import code
import importlib.util
import json
import logging
import os
import sys

from veles_tpu_torch import cmdline, prng
from veles_tpu_torch.config import apply_config_file, root
from veles_tpu_torch.envknob import env_knob
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
                            help="resume from a snapshot: a file, "
                                 "http(s)://... or sqlite://<db>[#key]")
        parser.add_argument("-i", "--interactive", action="store_true",
                            help="initialize the workflow, then drop "
                                 "into a console with it in scope; "
                                 "call main() there (or exit) to run")
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
        parser.add_argument("--trace-out", default=None, metavar="FILE",
                            help="enable span tracing and dump the trace "
                                 "buffer (Chrome trace-event JSON, open "
                                 "in Perfetto) to FILE at exit, and the "
                                 "card's memory profile to FILE.memprof")
        parser.add_argument("--optimize", default=None, metavar="GENS:POP",
                            help="run the genetic hyperparameter optimizer")
        parser.add_argument("--ensemble-train", default=None,
                            metavar="N:RATIO",
                            help="train an ensemble of N models on "
                                 "RATIO-subsampled data")
        parser.add_argument("--ensemble-test", default=None,
                            metavar="RESULTS",
                            help="evaluate the trained ensemble of the "
                                 "RESULTS file")
        parser.add_argument("--train-ratio", type=float, default=None,
                            help="fraction of the train set to use "
                                 "(root.common.ensemble.train_ratio)")
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
        return {name: getattr(args, name) for name in (
            "backend", "device", "testing", "listen_address",
            "master_address", "eager", "gspmd", "auto_resume",
            "slave_death_probability", "job_timeout", "nodes", "respawn",
            "segment_size", "pipeline", "secret_file", "max_frame_mb",
            "exchange_dtype", "exchange_eps", "straggler_drop_s",
            "reconnect_s", "graphics", "web_status", "interactive")}

    def _join_world(self, argv):
        """The SPMD world of ``--gspmd`` and the multi-process flags,
        joined before anything touches a device."""
        from veles_tpu_torch.launcher import join_world
        args = self.args
        if args.jax_coordinator and not args.jax_processes:
            # a coordinator with no process count would leave THIS rank
            # standalone while its peers block at the store
            raise SystemExit(
                "--jax-coordinator requires --jax-processes (and "
                "--jax-process-id) on every process")
        return join_world(args.gspmd or env_knob("VELES_GSPMD"),
                          args.jax_coordinator,
                          args.jax_processes, args.jax_process_id,
                          args.backend, args.device, argv)

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
        if self.args.interactive:
            self._interact()
            if self._run_error is not None:
                # the console printed the failure; the exit code must
                # still say it
                raise self._run_error
        if not self._ran:
            self._run_and_report()

    def _run_and_report(self):
        """Run and write the results, once: a second call (``main()``
        again in the console) warns and keeps the first results."""
        if self._ran:
            self.warning("main() already ran in this session; skipping "
                         "(results were already written)")
            return
        self._ran = True
        try:
            self.launcher.run()
            self._write_results()
            self.workflow.print_stats()
        except BaseException as e:
            self._run_error = e
            raise

    def _interact(self):
        """``-i``: the console, with the initialized workflow in scope;
        ``main()`` there runs it."""
        namespace = {"workflow": self.workflow, "launcher": self.launcher,
                     "units": list(self.workflow.units), "root": root,
                     "main": self._run_and_report}
        banner = ("\nveles_tpu_torch interactive mode: the workflow is "
                  "initialized, not run.\nIn scope: workflow, launcher, "
                  "units, root, main().\nmain() runs it now; leaving the "
                  "console runs it if main() has not.")
        shell = None
        if sys.stdin.isatty():
            try:
                from IPython.terminal.embed import InteractiveShellEmbed
                shell = InteractiveShellEmbed(banner1=banner)
            except ImportError:
                pass
        try:
            if shell is not None:
                shell(local_ns=namespace)
            else:
                code.interact(banner=banner, local=namespace, exitmsg="")
        except SystemExit:
            pass

    def _write_results(self):
        from veles_tpu_torch.parallel.mesh import is_rank_zero
        if not self.args.result_file or not is_rank_zero():
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

    def _run_optimize(self):
        from veles_tpu_torch.genetics import GeneticsOptimizer
        gens, _, pop = self.args.optimize.partition(":")
        GeneticsOptimizer(
            workflow_file=self.args.workflow,
            config_file=self.args.config,
            generations=int(gens or 10),
            population_size=int(pop or 20),
            result_file=self.args.result_file,
            extra_argv=self._device_argv()).run()
        return self.EXIT_SUCCESS

    def _run_ensemble_train(self):
        from veles_tpu_torch.ensemble import EnsembleTrainer
        n, _, ratio = self.args.ensemble_train.partition(":")
        EnsembleTrainer(
            workflow_file=self.args.workflow,
            config_file=self.args.config,
            size=int(n), train_ratio=float(ratio or 0.8),
            result_file=self.args.result_file or "ensemble.json",
            extra_argv=self._device_argv()).run()
        return self.EXIT_SUCCESS

    def _run_ensemble_test(self):
        from veles_tpu_torch.ensemble import EnsembleTester
        EnsembleTester(
            workflow_file=self.args.workflow,
            config_file=self.args.config,
            results_file=self.args.ensemble_test,
            result_file=self.args.result_file or "ensemble_test.json",
            extra_argv=self._device_argv()).run()
        return self.EXIT_SUCCESS

    def _device_argv(self):
        """This run's ``-a``/``-d``, passed on to each job of a meta run
        (each job runs on the card unless they ask for the CPU)."""
        argv = []
        if self.args.backend not in (None, "auto"):
            argv += ["-a", self.args.backend]
        if self.args.device not in (None, ""):
            argv += ["-d", str(self.args.device)]
        return argv

    def _meta_run(self):
        """The run of ``--optimize``, ``--ensemble-train`` or
        ``--ensemble-test``, or None for a plain run."""
        if self.args.optimize:
            return self._run_optimize
        if self.args.ensemble_train:
            return self._run_ensemble_train
        if self.args.ensemble_test:
            return self._run_ensemble_test
        return None

    def run(self, argv=None):
        if argv is None:
            argv = sys.argv[1:]
        if argv and argv[0] == "serve":
            # the serving engine has its own flags and no workflow loop
            from veles_tpu_torch.serving.frontend import main as serve_main
            return serve_main(argv[1:])
        if argv and argv[0] == "sched":
            # so has the gang scheduler's serve/submit/status
            from veles_tpu_torch.sched.cli import sched_main
            return sched_main(argv[1:])
        self._ran = False
        self._run_error = None
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
        if self.args.train_ratio is not None:
            root.common.ensemble.train_ratio = self.args.train_ratio
        # refused flags fail before anything is built
        Launcher(**self._launcher_kwargs())
        self.world = self._join_world(argv)
        failed = True
        try:
            code = self._run_in_world(overrides)
            failed = False
            return code
        finally:
            if self.world is not None:
                self.world.close(failed=failed)

    def _run_in_world(self, overrides):
        if self.world is not None and self.world.rank and \
                self.args.trace_out:
            # each rank's trace beside rank 0's
            self.args.trace_out += ".rank%d" % self.world.rank
        self._seed_random(self.args.seed)
        module = self._load_model(self.args.workflow)
        if self.args.config:
            apply_config_file(self.args.config)
        self._override_config(overrides)
        from veles_tpu_torch.telemetry import profiler
        if self.args.trace_out:
            profiler.start_trace(self.args.trace_out)
        profiler.start_memory_sampler()
        meta_run = self._meta_run()
        try:
            if meta_run is not None:
                return meta_run()
            return self._run_regular(module)
        except KeyboardInterrupt:
            self.warning("interrupted")
            return self.EXIT_FAILURE
        finally:
            if self.args.trace_out:
                profiler.dump_trace(self.args.trace_out, getattr(
                    getattr(self, "launcher", None), "mode", None) or
                    "veles_tpu_torch")


def main(argv=None):
    return Main().run(argv)


if __name__ == "__main__":
    sys.exit(main())
