"""Registry of all Unit subclasses (``veles_tpu/unit_registry.py``).

A metaclass records every Unit subclass so the CLI and workflow
introspection can enumerate the available unit types; it also folds in
the command-line argument registry so any unit can contribute flags.
Each class gets a stable ``__id__`` UUID, the one the JAX package gives
the class of the same name. :class:`MappedUnitRegistry` adds a lookup by
a class's ``MAPPING`` name.
"""

import uuid

from veles_tpu_torch.cmdline import CommandLineArgumentsRegistry

#: Namespace for deterministic unit UUIDs (so the same class name always
#: exports the same id — the native runner keys its factory on these).
_UNIT_NAMESPACE = uuid.UUID("6ba7b812-9dad-11d1-80b4-00c04fd430c8")


class UnitRegistry(CommandLineArgumentsRegistry):
    """Metaclass: every concrete Unit subclass lands in ``units``."""

    units = {}

    def __init__(cls, name, bases, namespace):
        super(UnitRegistry, cls).__init__(name, bases, namespace)
        if namespace.get("hide_from_registry", False):
            return
        if "__id__" not in namespace:
            cls.__id__ = str(uuid.uuid5(_UNIT_NAMESPACE, name))
        UnitRegistry.units[name] = cls

    @staticmethod
    def find(name):
        return UnitRegistry.units.get(name)

    @staticmethod
    def find_by_id(uid):
        for cls in UnitRegistry.units.values():
            if getattr(cls, "__id__", None) == uid:
                return cls
        return None


class MappedUnitRegistry(UnitRegistry):
    """A registry with a user-facing key: each class that sets
    ``MAPPING`` lands in its metaclass's ``mapped`` under that name."""

    mapping = "base"
    base = object

    def __init__(cls, name, bases, namespace):
        super(MappedUnitRegistry, cls).__init__(name, bases, namespace)
        mapping = namespace.get("MAPPING")
        if mapping:
            type(cls).mapped[mapping] = cls

    mapped = {}
