"""Step-hygiene checker: the port's counterpart of
``veles_tpu/analysis/tracer.py``.

The JAX checker looks for host work inside functions that ``jit`` /
``pallas_call`` / ``scan`` / ``custom_vjp`` trace: such work runs once
per compile and bakes one value into the program. The port traces
nothing (no ``torch.compile``, no CUDA-graph capture): its step runs
its Python body every time. Its hazards are of another kind. A host
sync inside the step stalls the host until the card drains, so the
next launch waits and the card idles; a host RNG draw makes a step
depend on a stream no seed of the port's registry (``prng.py``)
governs; and a kernel called other than through ``ops/build.py``
``launch`` runs on whatever stream the caller's context gives, not on
the current stream the rest of the step orders against. Each would
also break a later capture of the step in a CUDA graph.

Roots (the step), found syntactically in every module:

* ``forward`` / ``backward`` of every ``torch.autograd.Function``
  subclass (the counterpart of the ``custom_vjp`` roots);
* every method ``train_batch`` (``train/step.py``
  ``FusedTrainer.train_batch`` and its subclasses' overrides);
* the solvers' ``update`` (a method ``update`` of a class that also
  defines ``init``: the rules of ``nn/optim.py``);
* the SOM's per-minibatch step (a method ``step`` of a class that also
  defines ``schedule``: ``nn/kohonen.py``, which the sweeps of
  ``train/som.py`` call once a minibatch);

then taint spreads through calls to functions defined in the same
module, by bare name, as the JAX checker's does.

Codes, with the JAX checker's meaning where they share one:

* **TRACE003** ``numpy.random.*`` / stdlib ``random.*`` in the step — a
  host RNG draw; the port draws from explicit generators
  (:mod:`veles_tpu_torch.prng`) outside the step.
* **TRACE004** a host sync in the step: ``.item()``, ``.tolist()``,
  ``.cpu()``, ``.numpy()``, ``.to("cpu")``, ``.synchronize()``
  (``torch.cuda.synchronize``, a stream's, an event's), and
  ``float()`` / ``int()`` / ``bool()`` of a value the function computed
  with ``torch`` (a ``torch.*`` call, a tensor reduction, a name bound
  to one, an element of one).
* **TRACE007** (the port's own; whole tree, not only the step) a kernel
  handle of ``ops/build.py`` — what ``build.function`` /
  ``build.binding`` / ``build.library`` or ``ctypes.CDLL`` returns, or a
  name bound to it — called other than as ``build.launch``'s first
  argument. ``launch`` hands the kernel the raw handle of the device's
  current stream; a direct call passes none of its own.

The JAX codes with no hazard in eager PyTorch: **TRACE001**
(``print``), **TRACE002** (``time.*``), **TRACE005** (mutation of
captured state) and **TRACE006** (``os.environ`` reads) all run on
every eager step, as written, and bake nothing. A CUDA-graph capture of
the step would make them hazards again (its replay runs device work
only); the checker takes them up with that capture.
"""

import ast

from veles_tpu_torch.analysis.core import (Finding, dotted_name,
                                           import_aliases, resolve_call)

#: base classes whose forward/backward are step roots
FUNCTION_BASES = frozenset(("torch.autograd.Function",
                            "torch.autograd.function.Function"))

#: canonical host-RNG call prefixes
RNG_PREFIXES = ("numpy.random.", "random.")

#: tensor methods that sync the host with the card (no arguments)
SYNC_METHODS = frozenset(("item", "tolist", "cpu", "numpy", "synchronize"))

#: builtins that read a tensor's value on the host
HOST_CASTS = frozenset(("float", "int", "bool"))

#: tensor methods whose result is a tensor (for the casts above)
TENSOR_METHODS = frozenset((
    "sum", "mean", "max", "min", "norm", "abs", "sqrt", "square", "exp",
    "log", "prod", "amax", "amin", "argmax", "argmin", "any", "all",
    "float", "double", "half", "to", "detach", "clone", "view", "reshape",
    "squeeze", "unsqueeze", "std", "var", "count_nonzero", "numel"))

#: calls that return a kernel handle of ``ops/build.py``
HANDLE_SOURCES = frozenset(("function", "binding", "library"))


def _is_handle_source(call, aliases):
    """True when ``call`` returns a kernel handle: ``build.function(...)``
    / ``build.binding(...)`` / ``build.library(...)`` (through any import
    of ``ops/build.py``) or ``ctypes.CDLL(...)``."""
    if not isinstance(call, ast.Call):
        return False
    target = resolve_call(call, aliases) or ""
    parts = target.split(".")
    return target == "ctypes.CDLL" or (
        len(parts) > 1 and parts[-2] == "build" and
        parts[-1] in HANDLE_SOURCES)


def _root_methods(cls, aliases):
    """(name, why) of ``cls``'s methods that are step roots."""
    methods = {n.name for n in cls.body
               if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}
    bases = {resolve_call(ast.Call(func=b, args=[], keywords=[]), aliases)
             for b in cls.bases}
    out = []
    if bases & FUNCTION_BASES:
        out += [(m, "autograd Function %s.%s" % (cls.name, m))
                for m in ("forward", "backward") if m in methods]
    if "train_batch" in methods:
        out.append(("train_batch", "the training step %s.train_batch"
                    % cls.name))
    if {"init", "update"} <= methods:
        out.append(("update", "the solver rule %s.update" % cls.name))
    if {"schedule", "step"} <= methods:
        out.append(("step", "the SOM step %s.step" % cls.name))
    return out


def _collect_functions(tree):
    funcs = {}
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            funcs.setdefault(node.name, []).append(node)
    return funcs


def _callable_name(node):
    if isinstance(node, ast.Name):
        return node.id
    attr = dotted_name(node)
    if attr and attr.startswith("self."):
        return attr.split(".", 1)[1]
    return None


def _taint(roots, funcs):
    """Spread step-ness through same-module calls, and through a
    function that the step names as a value (``fn = a if plain else b;
    fn(x)``)."""
    traced = dict(roots)
    queue = list(roots)
    while queue:
        name = queue.pop()
        for node in funcs.get(name, ()):
            local = _local_names(node)
            for sub in ast.walk(node):
                if isinstance(sub, ast.Call):
                    callee = _callable_name(sub.func)
                elif isinstance(sub, ast.Name) and \
                        isinstance(sub.ctx, ast.Load) and \
                        sub.id not in local:
                    callee = sub.id
                else:
                    continue
                if callee in funcs and callee not in traced:
                    traced[callee] = "called from step %s" % name
                    queue.append(callee)
    return traced


def _local_names(func):
    """Names bound inside ``func``: its parameters and assignments."""
    args = func.args
    names = {a.arg for a in args.posonlyargs + args.args + args.kwonlyargs}
    names.update(a.arg for a in (args.vararg, args.kwarg) if a)
    for node in ast.walk(func):
        if isinstance(node, ast.Name) and isinstance(node.ctx, ast.Store):
            names.add(node.id)
    return names


def _tensor_names(func, aliases):
    """Names the function binds to a value computed with ``torch``."""
    names = set()
    changed = True
    while changed:
        changed = False
        for node in ast.walk(func):
            if isinstance(node, ast.Assign) and \
                    _is_tensorish(node.value, aliases, names):
                for tgt in node.targets:
                    for sub in ast.walk(tgt):
                        if isinstance(sub, ast.Name) and \
                                sub.id not in names:
                            names.add(sub.id)
                            changed = True
    return names


def _is_tensorish(node, aliases, names):
    if isinstance(node, ast.Name):
        return node.id in names
    if isinstance(node, ast.Subscript):
        return _is_tensorish(node.value, aliases, names)
    if isinstance(node, ast.BinOp):
        return _is_tensorish(node.left, aliases, names) or \
            _is_tensorish(node.right, aliases, names)
    if isinstance(node, ast.Call):
        target = resolve_call(node, aliases) or ""
        if target.startswith("torch."):
            return True
        func = node.func
        return isinstance(func, ast.Attribute) and \
            func.attr in TENSOR_METHODS and \
            _is_tensorish(func.value, aliases, names)
    return False


def _scan_step(mod, func, why, aliases, findings):
    names = _tensor_names(func, aliases)

    def emit(code, line, what, key_tail):
        findings.append(Finding(
            "tracer", code, mod.relpath, line,
            "%s inside step %s (%s)" % (what, func.name, why),
            key="%s.%s" % (func.name, key_tail)))

    for node in ast.walk(func):
        if not isinstance(node, ast.Call) or node is func:
            continue
        target = resolve_call(node, aliases)
        if target and target.startswith(RNG_PREFIXES):
            emit("TRACE003", node.lineno,
                 "host RNG draw %s() outside the port's generators"
                 % target, target)
            continue
        if target in HOST_CASTS and len(node.args) == 1 and \
                _is_tensorish(node.args[0], aliases, names):
            emit("TRACE004", node.lineno,
                 "%s() of a tensor is a host sync" % target,
                 "cast.%s" % target)
            continue
        func_ = node.func
        if not isinstance(func_, ast.Attribute):
            continue
        if func_.attr in SYNC_METHODS and not node.args:
            emit("TRACE004", node.lineno,
                 ".%s() is a host sync" % func_.attr, func_.attr)
        elif func_.attr == "to" and any(
                isinstance(a, ast.Constant) and a.value == "cpu"
                for a in node.args):
            emit("TRACE004", node.lineno, '.to("cpu") is a host sync',
                 "to_cpu")


def _launch_first_args(tree, aliases):
    """ids of the nodes passed as ``launch``'s first argument."""
    ok = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and node.args:
            target = resolve_call(node, aliases) or ""
            if target == "launch" or target.endswith("build.launch"):
                for sub in ast.walk(node.args[0]):
                    ok.add(id(sub))
    return ok


def _off_stream_calls(mod, aliases, findings):
    """TRACE007 over every function of the module."""
    seen = _launch_first_args(mod.tree, aliases)  # and calls reported
    for func in ast.walk(mod.tree):
        if not isinstance(func, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        handles = set()
        for node in ast.walk(func):
            if isinstance(node, ast.Assign) and \
                    _is_handle_source(_handle_root(node.value), aliases):
                for tgt in node.targets:
                    if isinstance(tgt, ast.Name):
                        handles.add(tgt.id)
        for node in ast.walk(func):
            if not isinstance(node, ast.Call) or id(node) in seen:
                continue
            root = _handle_root(node.func)
            direct = _is_handle_source(root, aliases)
            named = isinstance(root, ast.Name) and root.id in handles
            if direct or named:
                seen.add(id(node))  # a nested def's walk meets it again
                findings.append(Finding(
                    "tracer", "TRACE007", mod.relpath, node.lineno,
                    "kernel called off build.launch in %s: it runs "
                    "without the device's current stream" % func.name,
                    key="%s.offstream.%s" % (func.name,
                                             ast.unparse(node.func))))


def _handle_root(node):
    """The expression a call's callee hangs off: ``h`` of
    ``h.forward``, the call itself of ``build.function(...)``."""
    while isinstance(node, ast.Attribute):
        node = node.value
    return node


def check(project):
    findings = []
    for mod in project.modules:
        if mod.tree is None:
            continue
        aliases = import_aliases(mod.tree)
        if not mod.relpath.endswith("ops/build.py"):
            _off_stream_calls(mod, aliases, findings)
        funcs = _collect_functions(mod.tree)
        roots = {}
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.ClassDef):
                for name, why in _root_methods(node, aliases):
                    roots.setdefault(name, why)
        if not roots:
            continue
        for name, why in sorted(_taint(roots, funcs).items()):
            for func in funcs[name]:
                _scan_step(mod, func, why, aliases, findings)
    return findings
