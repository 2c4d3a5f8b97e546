"""Lock-discipline checker.

Deadlocks and torn state don't show up in tier-1 runs — they need the
right interleaving on a pod. What CAN be checked statically:

* **LOCK001** — an attribute that the class consistently writes under
  ``with self._lock:`` is also written with no lock held. The unlocked
  write is the bug surface: a reader under the lock can observe the
  torn update. ``__init__``/``__new__`` are exempt (no concurrent
  reader exists yet), as are methods named ``*_locked`` or whose
  docstring says the caller holds the lock.
* **LOCK002** — lock-order cycle: somewhere lock A is held while B is
  acquired, and elsewhere B is held while A is acquired (directly or
  through a same-module call chain). Two threads taking the two paths
  concurrently deadlock.
* **LOCK003** — re-acquisition of a non-reentrant ``threading.Lock``
  on a path that already holds it (directly nested ``with``, or a call
  to a method that takes the same lock). Self-deadlock on first
  execution of that path; ``RLock``/``Condition`` (reentrant) are
  exempt.

Acquisition tracking is lexical (``with <lock>:`` blocks) plus an
interprocedural fixpoint over same-module calls (``self.method()`` and
module-level functions), which is exactly the scope VELES' locking
actually spans — no lock in this tree is passed across modules.

The port's copy of ``veles_tpu/analysis/locks.py``: the same rules, the
same findings and fingerprints on the same file.
"""

import ast

from veles_tpu_torch.analysis.core import (
    Finding, dotted_name, import_aliases)

#: method calls that mutate their receiver (write-equivalent)
MUTATORS = frozenset((
    "append", "extend", "insert", "remove", "pop", "popitem", "clear",
    "add", "discard", "update", "setdefault", "sort", "reverse",
    "popleft", "appendleft",
))

#: constructors recognised as locks: name -> reentrant?
LOCK_TYPES = {
    "threading.Lock": False,
    "threading.RLock": True,
    "threading.Condition": True,   # default Condition wraps an RLock
    "multiprocessing.Lock": False,
    "multiprocessing.RLock": True,
}

EXEMPT_METHODS = frozenset((
    "__init__", "__new__", "__del__", "__enter__", "__exit__",
    "__getstate__", "__setstate__",
    # the VELES constructor-after-unpickle idiom: runs before any
    # other thread can see the instance, like __init__
    "init_unpickled",
))
EXEMPT_DOC_MARKERS = ("caller holds", "lock held", "holding the lock",
                      "under the lock", "not thread-safe",
                      "single-threaded")


def _lock_ctor(node, aliases):
    """'Lock'/'RLock'/... when ``node`` is a recognised lock
    constructor call, else None. Returns (name, reentrant)."""
    if not isinstance(node, ast.Call):
        return None
    target = dotted_name(node.func)
    if target is None:
        return None
    head, _, rest = target.partition(".")
    canon = aliases.get(head, head)
    full = canon + ("." + rest if rest else "")
    if full in LOCK_TYPES:
        return full, LOCK_TYPES[full]
    return None


def _self_attr(node):
    """'x' for ``self.x``, else None."""
    if (isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id == "self"):
        return node.attr
    return None


class _Unit(object):
    """One lock scope: a class (locks are ``self.attr``) or the module
    itself (locks are module-global names)."""

    def __init__(self, name, relpath):
        self.name = name          # class name or '<module>'
        self.relpath = relpath
        self.locks = {}           # lock attr/name -> reentrant?
        self.lock_lines = {}      # lock attr/name -> def line
        # per function: list of events, each
        #   ("acquire", lock, line, frozenset(held_before))
        #   ("write", attr, line, frozenset(held))
        #   ("call", callee, line, frozenset(held))
        self.events = {}
        self.exempt = set()       # function names exempt from LOCK001

    def lock_id(self, lock):
        return "%s.%s" % (self.name, lock)


def _is_exempt(func):
    if func.name in EXEMPT_METHODS or func.name.endswith("_locked"):
        return True
    # whitespace-normalized: reflowed docstrings may wrap a marker
    doc = " ".join((ast.get_docstring(func) or "").lower().split())
    return any(marker in doc for marker in EXEMPT_DOC_MARKERS)


class _FuncWalker(object):
    """Lexical walk of one function body tracking the held-lock set."""

    def __init__(self, unit, lock_names, is_method):
        self.unit = unit
        self.lock_names = lock_names   # names valid in this scope
        self.is_method = is_method
        self.events = []

    def _lock_of(self, expr):
        """Lock name acquired by a with-item / .acquire() target."""
        if self.is_method:
            attr = _self_attr(expr)
            if attr in self.lock_names:
                return attr
        elif isinstance(expr, ast.Name) and expr.id in self.lock_names:
            return expr.id
        return None

    def walk(self, body, held):
        for stmt in body:
            self.stmt(stmt, held)

    def stmt(self, node, held):
        if isinstance(node, ast.With) or isinstance(node, ast.AsyncWith):
            inner = held
            for item in node.items:
                lock = self._lock_of(item.context_expr)
                if lock is not None:
                    self.events.append(
                        ("acquire", lock, node.lineno, frozenset(inner)))
                    inner = inner | {lock}
                else:
                    self.scan_expr(item.context_expr, held)
            self.walk(node.body, inner)
            return
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            return  # nested defs run later, under their own discipline
        # writes ------------------------------------------------------
        if isinstance(node, ast.Assign):
            for tgt in node.targets:
                self.record_write(tgt, held)
            self.scan_expr(node.value, held)
        elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
            self.record_write(node.target, held)
            if node.value is not None:
                self.scan_expr(node.value, held)
        elif isinstance(node, ast.Delete):
            for tgt in node.targets:
                self.record_write(tgt, held)
        elif isinstance(node, ast.Expr):
            self.scan_expr(node.value, held)
        elif isinstance(node, ast.Return):
            if node.value is not None:
                self.scan_expr(node.value, held)
        elif isinstance(node, (ast.If, ast.While)):
            self.scan_expr(node.test, held)
            self.walk(node.body, held)
            self.walk(node.orelse, held)
        elif isinstance(node, ast.For):
            self.scan_expr(node.iter, held)
            self.walk(node.body, held)
            self.walk(node.orelse, held)
        elif isinstance(node, ast.Try):
            self.walk(node.body, held)
            for handler in node.handlers:
                self.walk(handler.body, held)
            self.walk(node.orelse, held)
            self.walk(node.finalbody, held)
        elif isinstance(node, (ast.Raise, ast.Assert)):
            for child in ast.iter_child_nodes(node):
                if isinstance(child, ast.expr):
                    self.scan_expr(child, held)

    def record_write(self, target, held):
        if isinstance(target, (ast.Tuple, ast.List)):
            for elt in target.elts:
                self.record_write(elt, held)
            return
        if isinstance(target, ast.Subscript):
            # self.d[k] = v mutates self.d
            target = target.value
        attr = _self_attr(target) if self.is_method else None
        if attr is not None and attr not in self.lock_names:
            self.events.append(
                ("write", attr, target.lineno, frozenset(held)))

    def scan_expr(self, node, held):
        """Find calls inside an expression: lock ops, receiver
        mutations, and same-scope calls for the closure."""
        for call in [n for n in ast.walk(node)
                     if isinstance(n, ast.Call)]:
            func = call.func
            if isinstance(func, ast.Attribute):
                # <lock>.acquire() — an acquisition site
                lock = self._lock_of(func.value)
                if lock is not None and func.attr == "acquire":
                    self.events.append(("acquire", lock, call.lineno,
                                        frozenset(held)))
                    continue
                if lock is not None:
                    continue  # .release()/.locked(): not a write
                # self.attr.append(...) — a mutation of self.attr
                attr = _self_attr(func.value) if self.is_method else None
                if attr is not None and func.attr in MUTATORS:
                    self.events.append(("write", attr, call.lineno,
                                        frozenset(held)))
                # self.method(...) — closure edge
                callee = _self_attr(func) if self.is_method else None
                if callee is not None:
                    self.events.append(("call", callee, call.lineno,
                                        frozenset(held)))
            elif isinstance(func, ast.Name):
                self.events.append(("call", func.id, call.lineno,
                                    frozenset(held)))


def _collect_units(mod, aliases):
    units = []
    tree = mod.tree
    # module-level unit: global locks + top-level functions ----------
    modunit = _Unit("<module>", mod.relpath)
    for node in tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name):
            ctor = _lock_ctor(node.value, aliases)
            if ctor:
                name = node.targets[0].id
                modunit.locks[name] = ctor[1]
                modunit.lock_lines[name] = node.lineno
    for node in tree.body:
        if isinstance(node, ast.FunctionDef):
            walker = _FuncWalker(modunit, set(modunit.locks), False)
            walker.walk(node.body, frozenset())
            modunit.events[node.name] = walker.events
            if _is_exempt(node):
                modunit.exempt.add(node.name)
    if modunit.locks:
        units.append(modunit)
    # class units ----------------------------------------------------
    for node in ast.walk(tree):
        if not isinstance(node, ast.ClassDef):
            continue
        unit = _Unit(node.name, mod.relpath)
        for sub in ast.walk(node):
            if isinstance(sub, ast.Assign):
                ctor = _lock_ctor(sub.value, aliases)
                if ctor:
                    for tgt in sub.targets:
                        attr = _self_attr(tgt)
                        if attr:
                            unit.locks[attr] = ctor[1]
                            unit.lock_lines[attr] = sub.lineno
        if not unit.locks:
            continue
        for sub in node.body:
            if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                walker = _FuncWalker(unit, set(unit.locks), True)
                walker.walk(sub.body, frozenset())
                unit.events[sub.name] = walker.events
                if _is_exempt(sub):
                    unit.exempt.add(sub.name)
        units.append(unit)
    return units


def _effective_acquires(unit):
    """Fixpoint: function -> every lock it may acquire, including via
    same-unit calls."""
    eff = {name: set(lock for kind, lock, _, _ in events
                     if kind == "acquire")
           for name, events in unit.events.items()}
    changed = True
    while changed:
        changed = False
        for name, events in unit.events.items():
            for kind, callee, _, _ in events:
                if kind != "call" or callee not in eff:
                    continue
                extra = eff[callee] - eff[name]
                if extra:
                    eff[name] |= extra
                    changed = True
    return eff


def _check_unit(unit, findings):
    eff = _effective_acquires(unit)

    # -- LOCK001: guarded attribute written outside the lock ---------
    guarded = {}     # attr -> lock most often held at writes
    writes = {}      # attr -> [(func, line, held)]
    for func, events in unit.events.items():
        if func in ("__init__", "__new__"):
            continue
        for kind, attr, line, held in events:
            if kind == "write":
                writes.setdefault(attr, []).append((func, line, held))
    for attr, sites in writes.items():
        locked = [s for s in sites if s[2]]
        if not locked:
            continue
        # the discipline lock: one the class actually uses for attr
        lock_votes = {}
        for _, _, held in locked:
            for lock in held:
                lock_votes[lock] = lock_votes.get(lock, 0) + 1
        lock = max(sorted(lock_votes), key=lambda k: lock_votes[k])
        for func, line, held in sites:
            if held or func in unit.exempt:
                continue
            findings.append(Finding(
                "locks", "LOCK001", unit.relpath, line,
                "%s.%s writes self.%s without holding self.%s "
                "(other writes hold it)" % (
                    unit.name, func, attr, lock),
                key="%s.%s.%s" % (unit.name, func, attr)))

    # -- LOCK002/LOCK003: ordering edges & self-deadlock -------------
    edges = {}   # (lockA, lockB) -> (line, func)
    for func, events in unit.events.items():
        for kind, what, line, held in events:
            if not held:
                continue
            if kind == "acquire":
                acquired = {what}
            elif kind == "call" and what in eff:
                acquired = eff[what]
            else:
                continue
            for b in acquired:
                for a in held:
                    if a == b:
                        if not unit.locks.get(a, True):
                            findings.append(Finding(
                                "locks", "LOCK003", unit.relpath, line,
                                "%s.%s re-acquires non-reentrant lock "
                                "self.%s while already holding it"
                                % (unit.name, func, a),
                                key="%s.%s.%s" % (unit.name, func, a)))
                    else:
                        edges.setdefault((a, b), (line, func))
    for (a, b), (line, func) in sorted(edges.items()):
        if (b, a) in edges and a < b:  # report each cycle once
            other_line, other_func = edges[(b, a)]
            findings.append(Finding(
                "locks", "LOCK002", unit.relpath, line,
                "lock-order cycle in %s: %s takes %s then %s; "
                "%s (line %d) takes %s then %s" % (
                    unit.name, func, a, b,
                    other_func, other_line, b, a),
                key="%s.%s.%s" % (unit.name, a, b)))


def check(project):
    findings = []
    for mod in project.modules:
        if mod.tree is None:
            continue
        aliases = import_aliases(mod.tree)
        for unit in _collect_units(mod, aliases):
            _check_unit(unit, findings)
    return findings
