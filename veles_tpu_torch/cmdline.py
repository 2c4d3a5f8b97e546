"""Distributed command-line argument registry (the port's copy of
``veles_tpu/cmdline.py``).

The reference's key idea (``veles/cmdline.py:61-239``): flags live next to
the code they affect. Any class whose metaclass is
:class:`CommandLineArgumentsRegistry` may define a static
``init_parser(parser)`` that adds its own arguments; the CLI entry point
aggregates every registered contribution into one ``argparse`` parser.
"""

import argparse


class CommandLineArgumentsRegistry(type):
    """Metaclass collecting per-class ``init_parser`` contributors."""

    classes = []

    def __init__(cls, name, bases, namespace):
        super(CommandLineArgumentsRegistry, cls).__init__(
            name, bases, namespace)
        # only register classes that define their own init_parser
        if "init_parser" in namespace:
            CommandLineArgumentsRegistry.classes.append(cls)


class SortingRawDescriptionHelpFormatter(argparse.RawDescriptionHelpFormatter):
    def add_arguments(self, actions):
        super(SortingRawDescriptionHelpFormatter, self).add_arguments(
            sorted(actions, key=lambda a: a.option_strings))


def init_parser(parser=None, **kwargs):
    """Build the aggregated parser from every registered class."""
    if parser is None:
        parser = argparse.ArgumentParser(
            formatter_class=SortingRawDescriptionHelpFormatter, **kwargs)
    seen = set()
    for cls in CommandLineArgumentsRegistry.classes:
        fn = cls.__dict__.get("init_parser")
        if fn is None:
            continue
        if isinstance(fn, staticmethod):
            fn = fn.__func__
        if fn in seen:
            continue
        seen.add(fn)
        result = fn(parser)
        if result is not None:
            parser = result
    return parser
