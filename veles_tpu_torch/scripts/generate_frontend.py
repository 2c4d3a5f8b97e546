"""The unit registry and the aggregated CLI as one JSON document
(``veles_tpu/scripts/generate_frontend.py``): the catalog behind the
web_status dashboard's ``/catalog`` and its command composer.

    python -m veles_tpu_torch.scripts.generate_frontend [-o FILE]

Walks :class:`~veles_tpu_torch.unit_registry.UnitRegistry` and the
aggregated argparse tree (``veles_tpu_torch/cmdline.py``): every unit
type (name, module, docstring, stable ``__id__``, view group) and every
CLI flag (name, default, choices, help).
"""

import argparse
import json
import sys


#: modules whose import populates the unit registry: the catalog covers
#: every unit the port ships, not only those imported already
_UNIT_MODULES = (
    "veles_tpu_torch.plumbing", "veles_tpu_torch.loader",
    "veles_tpu_torch.loader.fullbatch", "veles_tpu_torch.loader.image",
    "veles_tpu_torch.loader.pickles", "veles_tpu_torch.loader.hdf5",
    "veles_tpu_torch.loader.sound", "veles_tpu_torch.loader.saver",
    "veles_tpu_torch.loader.ensemble", "veles_tpu_torch.nn.units",
    "veles_tpu_torch.nn.decision", "veles_tpu_torch.nn.kohonen",
    "veles_tpu_torch.snapshotter", "veles_tpu_torch.plotting_units",
    "veles_tpu_torch.restful_api", "veles_tpu_torch.interaction",
    "veles_tpu_torch.downloader", "veles_tpu_torch.avatar",
    "veles_tpu_torch.loader.hdfs", "veles_tpu_torch.input_joiner",
    "veles_tpu_torch.mean_disp_normalizer", "veles_tpu_torch.zmq_loader",
    "veles_tpu_torch.genetics", "veles_tpu_torch.ensemble",
    "veles_tpu_torch.launcher", "veles_tpu_torch.publishing",
)


def describe_units():
    import importlib
    for mod in _UNIT_MODULES:
        importlib.import_module(mod)
    from veles_tpu_torch.unit_registry import UnitRegistry
    units = {}
    for name, cls in sorted(UnitRegistry.units.items()):
        units[name] = {
            "module": cls.__module__,
            "id": getattr(cls, "__id__", None),
            "doc": (cls.__doc__ or "").strip().split("\n")[0],
            "view_group": getattr(cls, "view_group", "WORKER"),
        }
    return units


def describe_arguments():
    from veles_tpu_torch.cmdline import init_parser
    parser = init_parser(prog="veles_tpu_torch")
    args = []
    for action in parser._actions:
        if isinstance(action, argparse._HelpAction):
            continue
        if isinstance(action, (argparse._StoreTrueAction,
                               argparse._StoreFalseAction)):
            kind = "flag"
        elif not action.option_strings:
            kind = "positional"
        else:
            kind = "option"
        args.append({
            "flags": list(action.option_strings) or [action.dest],
            "dest": action.dest,
            "kind": kind,
            "default": action.default
            if not callable(action.default) else None,
            "choices": list(action.choices) if action.choices else None,
            "required": bool(action.required),
            "help": action.help or "",
        })
    return args


def generate(path=None):
    doc = {"units": describe_units(), "arguments": describe_arguments()}
    text = json.dumps(doc, indent=2, default=str, sort_keys=True)
    if path:
        with open(path, "w") as f:
            f.write(text + "\n")
    return doc


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Generate the frontend unit/argument catalog")
    parser.add_argument("-o", "--output", default=None,
                        help="write JSON here (default: stdout)")
    args = parser.parse_args(argv)
    doc = generate(args.output)
    if not args.output:
        json.dump(doc, sys.stdout, indent=2, default=str, sort_keys=True)
        print()
    return 0


if __name__ == "__main__":
    sys.exit(main())
