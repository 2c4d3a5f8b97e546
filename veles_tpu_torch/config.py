"""Global configuration tree (the port's copy of ``veles_tpu/config.py``).

The auto-vivifying ``root`` config: attribute access creates nested
nodes on demand (``root.loader.minibatch_size = 60``), config files are
plain Python that mutates ``root``, ``update()`` deep-merges dicts and
keys can be ``protect()``-ed against further writes. An attribute that
was merely *read* (auto-vivified) is an empty node: ``validate()`` and
``get()`` treat it as undefined, so typos in workflow configs fail fast
instead of training with defaults. The port reads no site override
files: its configuration comes from the command line, the config file
and the workflow file alone.
"""

import os
import runpy
import threading

from veles_tpu_torch.envknob import env_knob


class Config(object):
    """One node of the configuration tree.

    Attribute reads auto-vivify child nodes; reading a node where a value
    was expected raises ``AttributeError`` from :meth:`validate` (the
    reference's undefined-leaf detection, ``veles/config.py:165-176``).
    """

    __slots__ = ("__dict__",)

    def __init__(self, path="root", **values):
        object.__setattr__(self, "__dict__", {
            "_path_": path, "_protected_": set()})
        for key, value in values.items():
            setattr(self, key, value)

    # -- tree construction ------------------------------------------------

    def __getattr__(self, name):
        if name.startswith("_") and name.endswith("_"):
            raise AttributeError(name)
        child = Config("%s.%s" % (self._path_, name))
        self.__dict__[name] = child
        return child

    def __setattr__(self, name, value):
        if name in self._protected_:
            raise AttributeError(
                "config key %s.%s is protected" % (self._path_, name))
        if isinstance(value, dict):
            node = self.__dict__.get(name)
            if not isinstance(node, Config):
                node = Config("%s.%s" % (self._path_, name))
                self.__dict__[name] = node
            node.update(value)
            return
        self.__dict__[name] = value

    # -- dict-ish access --------------------------------------------------

    def __getitem__(self, name):
        return getattr(self, name)

    def __setitem__(self, name, value):
        setattr(self, name, value)

    def __contains__(self, name):
        return name in self.keys()

    def keys(self):
        return [k for k, v in self.__dict__.items()
                if not (k.startswith("_") and k.endswith("_"))]

    def items(self):
        return [(k, self.__dict__[k]) for k in self.keys()]

    @staticmethod
    def _is_defined(value):
        # an empty Config child means the name was only ever *read*
        return not (isinstance(value, Config) and not value.keys())

    def get(self, name, default=None):
        """Read a leaf without vivifying it."""
        value = self.__dict__.get(name, default)
        return value if Config._is_defined(value) else default

    def update(self, tree):
        """Deep-merge a dict (or another Config) into this node."""
        if isinstance(tree, Config):
            tree = tree.to_dict()
        if not isinstance(tree, dict):
            raise TypeError("update() needs a dict, got %s" % type(tree))
        for key, value in tree.items():
            setattr(self, key, value)
        return self

    def to_dict(self):
        out = {}
        for key, value in self.items():
            out[key] = value.to_dict() if isinstance(value, Config) else value
        return out

    # -- integrity --------------------------------------------------------

    def protect(self, *names):
        """Forbid future writes to the named direct children."""
        self._protected_.update(names)

    def validate(self, *required):
        """Raise if any of the named leaves was never assigned."""
        missing = [n for n in required
                   if n not in self.__dict__ or
                   not Config._is_defined(self.__dict__[n])]
        if missing:
            raise AttributeError(
                "undefined config value(s) %s under %s" %
                (", ".join(missing), self._path_))

    def print_(self, indent=0, file=None):
        import sys
        file = file or sys.stdout
        for key, value in sorted(self.items()):
            if isinstance(value, Config):
                print("%s%s:" % ("  " * indent, key), file=file)
                value.print_(indent + 1, file)
            else:
                print("%s%s: %r" % ("  " * indent, key, value), file=file)

    def __repr__(self):
        return "<Config %s: %s>" % (self._path_, ", ".join(self.keys()))

    # Config nodes appear inside pickled workflows (snapshots).
    def __getstate__(self):
        return {"path": self._path_, "tree": self.to_dict()}

    def __setstate__(self, state):
        object.__setattr__(self, "__dict__", {
            "_path_": state["path"], "_protected_": set()})
        self.update(state["tree"])


#: The global configuration tree every workflow/config file mutates.
root = Config("root")

_config_lock = threading.Lock()


def _init_defaults():
    """The defaults the port reads (the JAX package's, cut to them)."""
    root.common.update({
        # relative: snapshots land under the working directory
        "dirs": {"snapshots": "snapshots"},
        "engine": {
            # the precision policy the workflow's layers are built under
            # (``nn/precision.py``: float32, bfloat16_mixed, bfloat16)
            "precision_type": env_knob("VELES_PRECISION", "float32"),
            # the kernel autotuner's mode (``ops/autotune.py``): off,
            # cache or search; ``VELES_AUTOTUNE`` wins over it
            "autotune": "cache",
        },
        "timings": False,
        "exceptions": {"run_after_stop": True},
        # plotting is off without a display (the JAX package's default:
        # a run on a headless host turns it on with an override)
        "disable": {"plotting": "DISPLAY" not in os.environ,
                    "publishing": False, "snapshotting": False},
        # the web_status dashboard a ``--web-status`` run posts to
        "web": {"host": "localhost", "port": 8090,
                "notification_interval": 1.0},
        # where ``restful_api.RESTfulAPI`` listens by default
        "api": {"host": "localhost", "port": 8180, "path": "/api"},
        # the ensemble member a run is (``ensemble/``): its index, the
        # ensemble's size (0 outside an ensemble) and the share of the
        # train set it trains on (``loader/base.py``)
        "ensemble": {"model_index": 0, "size": 0, "train_ratio": 1.0},
        # the model repository (``forge/``): the path of its service
        # endpoint and the file that describes a package
        "forge": {"service_name": "forge", "manifest": "manifest.json"},
    })


def apply_config_file(path, context=None):
    """Execute a Python config file that mutates ``root``.

    The reference runs config files via ``runpy`` with ``root`` injected
    (``veles/__main__.py:426-472``); same contract here.
    """
    with _config_lock:
        runpy.run_path(path, init_globals=dict(
            {"root": root}, **(context or {})))
    return root


def apply_overrides(pairs):
    """Apply ``key=value`` overrides to ``root``: each value read as a
    Python literal where it is one (else kept as the string), each key a
    dotted path with an optional leading ``root``; the nodes on the
    path are made as they are reached."""
    import ast
    for pair in pairs:
        key, sep, expr = pair.partition("=")
        if not sep:
            raise ValueError("override %r is not key=value" % pair)
        try:
            value = ast.literal_eval(expr)
        except (ValueError, SyntaxError):
            value = expr
        node = root
        parts = key.strip().split(".")
        if parts[0] == "root":
            parts = parts[1:]
        for part in parts[:-1]:
            node = getattr(node, part)
        setattr(node, parts[-1], value)


_init_defaults()
