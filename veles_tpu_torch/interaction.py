"""Mid-workflow interaction (``veles_tpu/interaction.py``).

:class:`Shell` embeds an IPython console inside a running workflow:
link it into the loop and press ``i`` + Enter while it trains; the next
time the unit fires it opens a console with ``workflow`` and ``units``
in scope. Runs without a terminal, without IPython, or under ``-i``
(whose console is already open: the launcher's ``is_interactive``) are
no-ops, so the unit is safe to leave wired in.

:class:`Manhole` is a debug REPL on a private unix socket.
:func:`install_stack_dump_handler` prints every thread's stack on
``SIGUSR1`` and :func:`debug_deadlocks` names the non-daemon threads
still alive at the end of a run. The dump runs in a Python-level
``signal.signal`` handler, so it walks the frames under the interpreter
lock; ``faulthandler``'s timed dumps walk them from a thread of their
own, which can read a frame another thread is freeing.
"""

import os
import select
import shutil
import signal
import socket
import sys
import tempfile
import threading
import traceback

from veles_tpu_torch.distributable import TriviallyDistributable
from veles_tpu_torch.units import Unit


class Shell(Unit, TriviallyDistributable):
    """Runs an embedded IPython console when the user asks for it."""

    BANNER1 = "\nveles_tpu_torch interactive console"
    BANNER2 = "Type in 'workflow' or 'units' to start"

    def __init__(self, workflow, **kwargs):
        kwargs.setdefault("view_group", "SERVICE")
        super(Shell, self).__init__(workflow, **kwargs)
        #: open the console on the next run() whatever stdin is (tests,
        #: programmatic use)
        self.interact_next_run = False

    def init_unpickled(self):
        super(Shell, self).init_unpickled()
        self.shell_ = None

    @property
    def interactive(self):
        launcher = self.launcher
        return bool(launcher is not None and
                    getattr(launcher, "is_interactive", False))

    def initialize(self, **kwargs):
        if self.interactive:
            return  # already inside a console: embedding would recurse
        try:
            from IPython.terminal.embed import InteractiveShellEmbed
        except ImportError:
            self.warning("IPython is not available; Shell disabled")
            return
        self.shell_ = InteractiveShellEmbed(banner1=self.BANNER1,
                                            banner2=self.BANNER2)

    def interact(self, extra_locals=None):
        ns = {"workflow": self.workflow, "units": list(self.workflow.units)}
        ns.update(extra_locals or {})
        if self.shell_ is None:
            self.warning("no shell to interact with")
            return
        self.shell_(local_ns=ns)

    def run(self):
        if self.interact_next_run:
            self.interact_next_run = False
            self.interact()
            return
        if self.interactive or self.shell_ is None or \
                not sys.stdin.isatty():
            return
        # one non-blocking peek at stdin: "i" + Enter opens the console
        ready, _, _ = select.select([sys.stdin], [], [], 0)
        if ready and sys.stdin.readline()[:1] == "i":
            self.interact()


class Manhole(object):
    """Unix-socket debug REPL.

    ``Manhole(locals={"workflow": wf}).start()`` listens on a socket in a
    private 0700 directory (or at ``path``), mode 0600; each line a client
    sends is evaluated (an expression's repr is sent back) or executed in
    the given namespace. ``exit`` or ``quit`` ends the session. This is
    an ``eval()`` endpoint: it never listens beyond the local machine.
    """

    def __init__(self, path=None, locals=None):
        self.path = path
        self.locals = dict(locals or {})
        self._listener = None
        self._accepting = False
        self._own_dir = None

    def start(self):
        if self.path is None:
            # a world-writable /tmp path could be squatted, or reached by
            # other local users under a loose umask
            self._own_dir = tempfile.mkdtemp(prefix="veles_manhole_")
            self.path = os.path.join(self._own_dir, "manhole.sock")
        if os.path.exists(self.path):
            os.unlink(self.path)
        self._listener = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self._listener.bind(self.path)
        os.chmod(self.path, 0o600)
        self._listener.listen(2)
        self._accepting = True
        threading.Thread(target=self._accept_loop, daemon=True,
                         name="Manhole").start()
        return self

    def _accept_loop(self):
        listener = self._listener  # stop() may clear the attribute
        while self._accepting:
            try:
                sock, _ = listener.accept()
            except OSError:
                return
            threading.Thread(target=self._serve, args=(sock,),
                             daemon=True, name="Manhole-client").start()

    def _serve(self, sock):
        f = sock.makefile("rw")
        with sock:
            f.write("veles_tpu_torch manhole (%s)\n>>> " %
                    ", ".join(sorted(self.locals)))
            f.flush()
            for line in f:
                line = line.rstrip("\n")
                if line in ("exit", "quit", "exit()", "quit()"):
                    return
                try:
                    try:
                        result = eval(line, self.locals)  # noqa: S307
                        if result is not None:
                            f.write(repr(result) + "\n")
                    except SyntaxError:
                        exec(line, self.locals)  # noqa: S102
                except SystemExit:
                    return
                except BaseException as e:  # noqa: BLE001 -- answered
                    f.write("%s: %s\n" % (type(e).__name__, e))
                f.write(">>> ")
                f.flush()

    def stop(self):
        self._accepting = False
        if self._listener is not None:
            try:
                self._listener.close()
            finally:
                self._listener = None
        if self.path and os.path.exists(self.path):
            os.unlink(self.path)
        if self._own_dir is not None:
            shutil.rmtree(self._own_dir, ignore_errors=True)
            self._own_dir = None


def print_thread_stacks(file=None):
    """Every live thread's stack, each headed by its id and name."""
    file = file or sys.stderr
    names = {thr.ident: thr.name for thr in threading.enumerate()}
    for tid, stack in sys._current_frames().items():
        print("-" * 80, file=file)
        print("Thread #%d (%s):" % (tid, names.get(tid, "<unknown>")),
              file=file)
        traceback.print_stack(stack, file=file)
    file.flush()


def install_stack_dump_handler(signum=None):
    """``SIGUSR1`` (or ``signum``) prints every thread's stack to stderr.
    Callable from the main thread only (the signal module's rule);
    returns the previous handler."""
    if signum is None:
        signum = getattr(signal, "SIGUSR1", None)
        if signum is None:  # pragma: no cover - not POSIX
            return None
    return signal.signal(signum, lambda sig, frame: print_thread_stacks())


#: thread names that legitimately outlive a run
KNOWN_RUNNING_THREADS = (
    "MainThread", "pydevd", "status-notifier", "web-status",
    "graphics", "-http", "-accept", "heartbeat",
)


def debug_deadlocks(file=None):
    """The non-daemon threads still alive whose names are not known to
    outlive a run; when there are any, their names and every stack are
    printed. Returns them."""
    suspects = [
        thr for thr in threading.enumerate()
        if thr.is_alive() and not thr.daemon and
        not any(name in thr.name for name in KNOWN_RUNNING_THREADS)]
    if suspects:
        print("Possible deadlock: %d non-daemon threads still alive: %s"
              % (len(suspects), [t.name for t in suspects]),
              file=file or sys.stderr)
        print_thread_stacks(file=file)
    return suspects
