"""What a run measures, found by name from ``BENCHMARK.json``.

A cell (``--workload``) is an entry of ``BENCHMARK.json``'s
``workloads``. Everything else is a file of its own, found by the name
the entry gives:

* the configuration: the ``file`` of the ``configs`` entry it names;
* the traffic mix: ``traffic/<traffic>.json`` beside this module, data
  that names its ``driver``, the module ``drivers/<driver>.py`` that
  runs every mix of its kind (``drivers/__init__.py`` says what a
  driver provides);
* the cell's limits of the comparison that decides ``correct``:
  ``workloads/<cell>.json``;
* each metric's reader: ``metrics/<metric>.py``, a module with
  ``read(run)`` that returns the number, or None where it finds nothing
  to read.

A later cell, configuration or metric is added by adding its files and
its entries in ``BENCHMARK.json``; nothing here names one.
"""

import importlib.util
import json
import os
import re

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))


class Cell(object):
    """One resolved cell: its entry, configuration, traffic, limits and
    the metrics it reports (``end_to_end`` and ``per_layer``: lists of
    metric entries, each with its ``reader``)."""

    def __init__(self, entry, config, traffic, limits, end_to_end,
                 per_layer, bench_dir=BENCH_DIR):
        self.name = entry["name"]
        self.bench_dir = bench_dir
        self.entry = entry
        self.chips = int(entry["chips"])
        self.config = config
        self.traffic = traffic
        self.limits = limits
        self.end_to_end = end_to_end
        self.per_layer = per_layer


def _load_json(path):
    with open(path) as f:
        return json.load(f)


def _module(path, name):
    module_spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(module_spec)
    module_spec.loader.exec_module(module)
    return module


def load_reader(bench_dir, name):
    """The ``read`` function of ``metrics/<name>.py``."""
    return _module(os.path.join(bench_dir, "metrics", name + ".py"),
                   "portbench_metric_" + name.replace(".", "_")
                   .replace("-", "_")).read


def load_driver(cell):
    """The driver module of ``cell``'s traffic mix: ``drivers/<driver>.py``
    of the cell's benchmark directory."""
    name = cell.traffic["driver"]
    if not re.match(r"^[A-Za-z_][A-Za-z0-9_]*$", name):
        raise ValueError("no driver %r" % name)
    return _module(os.path.join(cell.bench_dir, "drivers", name + ".py"),
                   "portbench_driver_" + name)


def _reports(metric, cell_name, reported=None):
    """Does a cell report ``metric``: listed in its ``workloads``, or,
    without that key, every cell reporting the end-to-end metric it
    moves (``reported``: that cell's end-to-end names)."""
    if "workloads" in metric:
        return cell_name in metric["workloads"]
    if reported is None:
        return True
    return metric.get("moves") in reported


def load_cell(name, root=None, bench_dir=BENCH_DIR):
    """The :class:`Cell` named ``name`` in ``<root>/BENCHMARK.json``
    (``root``: the checkout, the parent of ``bench_dir`` by default)."""
    root = root or os.path.dirname(bench_dir)
    bench = _load_json(os.path.join(root, "BENCHMARK.json"))
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise KeyError("no workload %r in BENCHMARK.json (have %s)"
                       % (name, ", ".join(sorted(entries))))
    entry = entries[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = _load_json(os.path.join(root, configs[entry["config"]]["file"]))
    traffic = _load_json(os.path.join(bench_dir, "traffic",
                                      entry["traffic"] + ".json"))
    limits = _load_json(os.path.join(bench_dir, "workloads",
                                     name + ".json"))["limits"]
    end_to_end = [dict(m, reader=load_reader(bench_dir, m["name"]))
                  for m in bench["end_to_end"] if _reports(m, name)]
    reported = {m["name"] for m in end_to_end}
    per_layer = [dict(m, reader=load_reader(bench_dir, m["name"]))
                 for m in bench["per_layer"]
                 if _reports(m, name, reported)]
    return Cell(entry, config, traffic, limits, end_to_end, per_layer,
                bench_dir)
