"""THE reader for ``VELES_*`` environment knobs (the port's copy of
``veles_tpu/envknob.py``).

Every env knob in the tree is read through :func:`env_knob` (or the
boolean convenience :func:`env_flag`) because the raw
``float(os.environ.get("VELES_X") or ...)`` pattern crashes on
``float('')``: an exported-but-empty variable (``export VELES_X=``, a
YAML ``env: {VELES_X: }`` block, a systemd ``Environment=`` override)
means *unset*, not "the empty string is a value". ``env_knob`` folds both
``None`` and ``""`` into the default before any parsing happens.

A present-but-garbage value (``VELES_PREFETCH=banana``) raises a
``ValueError`` *naming the knob* by default — a typo'd operator
override should fail at startup with a pointed message, not deep in a
training loop with a bare conversion traceback. Knobs that must
degrade rather than raise (telemetry peaks, bench throttles — anything
whose failure must never unwind a training sweep) pass
``on_error="default"``.

The knob catalog lives in docs/CONFIGURATION.md.
"""

import os

#: lowercased values that mean "false" for :func:`env_flag`; anything
#: else present-and-non-empty is true ("1", "on", "yes", "pallas", ...)
FALSE_WORDS = frozenset(("0", "off", "no", "false"))


def env_knob(name, default=None, parse=None, on_error="raise"):
    """Read env knob ``name``; unset or empty returns ``default``.

    ``parse`` (e.g. ``int``/``float``) converts a present value; on a
    conversion failure ``on_error="raise"`` (the default) raises a
    ``ValueError`` naming the knob, ``on_error="default"`` returns
    ``default`` instead.
    """
    raw = os.environ.get(name)
    if raw is None or raw == "":
        return default
    if parse is None:
        return raw
    try:
        return parse(raw)
    except (TypeError, ValueError):
        if on_error == "default":
            return default
        raise ValueError("%s=%r is not a valid %s" % (
            name, raw, getattr(parse, "__name__", str(parse))))


def env_flag(name, default=False):
    """Boolean knob: unset/empty -> ``default``; else False only for
    the :data:`FALSE_WORDS` spellings (case/whitespace-insensitive)."""
    raw = env_knob(name)
    if raw is None:
        return default
    return raw.strip().lower() not in FALSE_WORDS
