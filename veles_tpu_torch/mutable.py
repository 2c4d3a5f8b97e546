"""Shared mutable booleans and attribute links (``veles_tpu/mutable.py``).

The port keeps its own copy of the JAX package's module, unchanged in
behaviour.

Re-designs ``veles/mutable.py``. :class:`Bool` is a mutable boolean cell
that units share by reference (gates, loop conditions); boolean operators
build a lazy expression DAG (``a & ~b``) so a gate can be defined once and
always reflect its operands' current values. Unlike the reference — which
pickles compiled closures via ``marshal`` (``veles/mutable.py:163-190``) —
expressions here are plain objects, so snapshots stay portable across
Python versions.

:func:`link` / :class:`LinkableAttribute` provide attribute "pointers":
``link(dst, "y", src, "x")`` makes ``dst.y`` an alias of ``src.x``. This
is the data-link mechanism of the unit graph (``veles/mutable.py:219-353``).
"""

import operator


class Bool(object):
    """Mutable shared boolean with a lazy expression graph.

    Literal cells are assigned with ``<<=`` (or ``.value = ...``); derived
    cells (results of ``&``, ``|``, ``^``, ``~``) recompute from their
    operands on every read and refuse direct assignment.
    """

    __slots__ = ("_value", "_op", "_operands", "on_change")

    def __init__(self, value=False):
        self._value = bool(value)
        self._op = None
        self._operands = ()
        self.on_change = None

    @classmethod
    def _derived(cls, op, *operands):
        b = cls()
        b._op = op
        b._operands = tuple(
            o if isinstance(o, Bool) else Bool(bool(o)) for o in operands)
        return b

    @property
    def derived(self):
        return self._op is not None

    @property
    def expr(self):
        """(op_name, operands) for derived cells, else None."""
        if self._op is None:
            return None
        return self._op.__name__, self._operands

    def __bool__(self):
        if self._op is None:
            return self._value
        return bool(self._op(*[bool(o) for o in self._operands]))

    @property
    def value(self):
        return bool(self)

    @value.setter
    def value(self, v):
        if self._op is not None:
            raise AttributeError("cannot assign to a derived Bool")
        changed = self._value != bool(v)
        self._value = bool(v)
        if changed and self.on_change is not None:
            self.on_change(self)

    def __ilshift__(self, value):
        """``b <<= True`` — assignment that keeps identity (shared refs)."""
        self.value = bool(value)
        return self

    def toggle(self):
        self.value = not self._value

    def __and__(self, other):
        return Bool._derived(operator.and_, self, other)

    __rand__ = __and__

    def __or__(self, other):
        return Bool._derived(operator.or_, self, other)

    __ror__ = __or__

    def __xor__(self, other):
        return Bool._derived(operator.xor, self, other)

    __rxor__ = __xor__

    def __invert__(self):
        return Bool._derived(operator.not_, self)

    def __repr__(self):
        kind = "derived:%s" % self._op.__name__ if self._op else "literal"
        return "<Bool %s %s at 0x%x>" % (bool(self), kind, id(self))

    # -- pickling: map operator functions to names -----------------------

    _OPS = {"and_": operator.and_, "or_": operator.or_,
            "xor": operator.xor, "not_": operator.not_}

    def __getstate__(self):
        return {"value": self._value,
                "op": self._op.__name__ if self._op else None,
                "operands": self._operands}

    def __setstate__(self, state):
        self._value = state["value"]
        op = state["op"]
        self._op = self._OPS[op] if op else None
        self._operands = tuple(state["operands"])
        self.on_change = None


class LinkableAttribute(object):
    """Class-level data descriptor storing per-instance attribute pointers.

    Installed on demand by :func:`link`; each instance holds its own
    ``(source_object, source_name, two_way)`` triple in ``__linked__``.
    Instances without a link fall back to a plain instance attribute kept
    under a shadow name, so linking is pay-for-what-you-use.
    """

    _MISSING = object()

    def __init__(self, name, default=_MISSING):
        self.name = name
        self.default = default

    def __get__(self, obj, objtype=None):
        if obj is None:
            return self
        ref = obj.__dict__.get("__linked__", {}).get(self.name)
        if ref is not None:
            return getattr(ref[0], ref[1])
        try:
            # data descriptors shadow the instance dict, so unlinked
            # instances keep their value right under the attribute name
            return obj.__dict__[self.name]
        except KeyError:
            if self.default is not LinkableAttribute._MISSING:
                return self.default  # preserved class-level default
            raise AttributeError(
                "%r has no attribute %r" % (obj, self.name))

    def __set__(self, obj, value):
        ref = obj.__dict__.get("__linked__", {}).get(self.name)
        if ref is not None:
            src, src_name, two_way = ref
            if not two_way:
                raise AttributeError(
                    "attribute %r of %r is one-way linked to %s.%s; "
                    "write to the source instead" %
                    (self.name, obj, src, src_name))
            setattr(src, src_name, value)
            return
        obj.__dict__[self.name] = value

    def __delete__(self, obj):
        links = obj.__dict__.get("__linked__", {})
        if self.name in links:
            del links[self.name]
        obj.__dict__.pop(self.name, None)


def link(dst, dst_name, src, src_name=None, two_way=False):
    """Make ``dst.<dst_name>`` an alias of ``src.<src_name>``.

    Works by installing a :class:`LinkableAttribute` descriptor on
    ``type(dst)`` (once per attribute name) and recording the pointer on
    the instance. Existing instance values are moved to the shadow slot of
    other instances untouched.
    """
    if src_name is None:
        src_name = dst_name
    descr = _install_descriptor(type(dst), dst_name)
    links = dst.__dict__.setdefault("__linked__", {})
    links[dst_name] = (src, src_name, two_way)
    return descr


def link_source(dst, dst_name):
    """The ``(src, src_name)`` that ``dst.<dst_name>`` is linked to, or
    None when the attribute is not linked."""
    ref = dst.__dict__.get("__linked__", {}).get(dst_name)
    return None if ref is None else ref[:2]


def _resolve_link_slot(cls, name):
    """Walk the MRO for ``name``: returns the installed
    :class:`LinkableAttribute` if any, else ``(None, default)`` where
    ``default`` is a plain class attribute to preserve as fallback.

    Raises if ``name`` is claimed by another descriptor (property etc.) —
    those cannot be transparently shadowed for other instances.
    """
    for klass in cls.__mro__:
        candidate = klass.__dict__.get(name)
        if candidate is None:
            continue
        if isinstance(candidate, LinkableAttribute):
            return candidate, LinkableAttribute._MISSING
        if hasattr(candidate, "__get__"):
            raise AttributeError(
                "cannot link over descriptor %r of %s" % (name, cls))
        return None, candidate
    return None, LinkableAttribute._MISSING


def _install_descriptor(cls, name):
    descr, default = _resolve_link_slot(cls, name)
    if descr is None:
        descr = LinkableAttribute(name, default)
        setattr(cls, name, descr)
    return descr


def ensure_descriptors(obj):
    """Re-install :class:`LinkableAttribute` descriptors for every link
    recorded on ``obj``.

    Needed after unpickling in a fresh process: links live in the
    instance (``__linked__``) but resolution needs the class-level
    descriptor that :func:`link` installed in the snapshotting process.
    """
    for name in obj.__dict__.get("__linked__", {}):
        _install_descriptor(type(obj), name)


def unlink(dst, dst_name, keep_value=True):
    """Remove an attribute pointer, optionally freezing the current value."""
    links = dst.__dict__.get("__linked__", {})
    ref = links.pop(dst_name, None)
    if ref is not None and keep_value:
        try:
            dst.__dict__[dst_name] = getattr(ref[0], ref[1])
        except AttributeError:
            pass
