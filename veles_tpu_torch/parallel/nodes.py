"""Remote slave process spawning (``veles_tpu/parallel/nodes.py``;
re-designs ``veles/launcher.py``
``_launch_nodes``/``launch_remote_progs`` :617-660,808-842 and the
master-side ``--respawn`` backoff, ``veles/server.py:637-655``).

The reference used paramiko; here it is plain ``ssh`` via subprocess
(key-based auth assumed, like any cluster launcher), with
``localhost`` nodes exec'd directly so the path is testable without a
network. Node specs: ``host`` or ``host*N`` for N slaves per host.
"""

import shlex
import subprocess
import threading
import time

from veles_tpu_torch.logger import Logger


def parse_nodes(spec):
    """``"a,b*2,c"`` → [("a",1),("b",2),("c",1)]."""
    nodes = []
    for part in str(spec).split(","):
        part = part.strip()
        if not part:
            continue
        host, _, count = part.partition("*")
        nodes.append((host, int(count) if count else 1))
    return nodes


class NodeLauncher(Logger):
    """Spawns and babysits slave processes on a set of nodes.

    ``command`` is the slave command line with an optional ``{master}``
    placeholder (filled with host:port) and ``{index}`` (slave ordinal
    on that node).
    """

    def __init__(self, nodes, command, master_address=None, respawn=False,
                 max_respawns=5, ssh_binary="ssh", ssh_options=()):
        super(NodeLauncher, self).__init__()
        self.nodes = parse_nodes(nodes) if isinstance(nodes, str) \
            else list(nodes)
        self.command = command
        self.master_address = master_address
        self.respawn = respawn
        self.max_respawns = max_respawns
        self.ssh_binary = ssh_binary
        self.ssh_options = list(ssh_options)
        self._procs = []       # (host, index, Popen)
        self._stopping = False
        self._monitor = None

    def _render(self, index):
        command = self.command
        if self.master_address is not None:
            command = command.replace(
                "{master}", "%s:%d" % tuple(self.master_address))
        return command.replace("{index}", str(index))

    def _spawn(self, host, index):
        command = self._render(index)
        if host in ("localhost", "127.0.0.1"):
            proc = subprocess.Popen(command, shell=True)
        else:
            proc = subprocess.Popen(
                [self.ssh_binary] + self.ssh_options + [host, command])
        self.info("spawned slave %d on %s (pid %d)", index, host,
                  proc.pid)
        return proc

    def start(self):
        index = 0
        for host, count in self.nodes:
            for _ in range(count):
                self._procs.append([host, index, self._spawn(host, index),
                                    0])
                index += 1
        if self.respawn:
            self._monitor = threading.Thread(
                target=self._respawn_loop, daemon=True,
                name="node-respawn")
            self._monitor.start()
        return self

    def _respawn_loop(self):
        # per-entry next-respawn timestamps: one slave's backoff must
        # not serialize death detection/relaunch of the others
        due = {}
        while not self._stopping:
            time.sleep(0.2)
            now = time.time()
            for entry in self._procs:
                host, index, proc, respawns = entry
                if proc.poll() is None or self._stopping:
                    due.pop(index, None)
                    continue
                if respawns >= self.max_respawns:
                    continue
                if index not in due:
                    # exponential backoff like the reference's _respawn
                    delay = min(2.0 ** respawns * 0.1, 30.0)
                    self.warning("slave %d on %s died (rc %s); respawn "
                                 "in %.1fs", index, host, proc.returncode,
                                 delay)
                    due[index] = now + delay
                    continue
                if now >= due.pop(index):
                    entry[2] = self._spawn(host, index)
                    entry[3] = respawns + 1

    @property
    def alive(self):
        return sum(1 for _, _, proc, _ in self._procs
                   if proc.poll() is None)

    def wait(self, timeout=None):
        deadline = None if timeout is None else time.time() + timeout
        for _, _, proc, _ in self._procs:
            remaining = None if deadline is None \
                else max(0.0, deadline - time.time())
            try:
                proc.wait(timeout=remaining)
            except subprocess.TimeoutExpired:
                return False
        return True

    def stop(self):
        self._stopping = True
        for _, _, proc, _ in self._procs:
            if proc.poll() is None:
                proc.terminate()
        for _, _, proc, _ in self._procs:
            try:
                proc.wait(timeout=5)
            except subprocess.TimeoutExpired:
                proc.kill()
        if self._monitor is not None:
            self._monitor.join(timeout=5)
            self._monitor = None


def slave_command_from_argv(argv, master_address):
    """Build the remote slave command from this master's argv
    (the reference's ``filter_argv`` idea, ``launcher.py:75-96``):
    strip master-only flags, add ``-m host:port``."""
    import sys
    drop_with_value = {"-l", "--listen", "-n", "--nodes", "-d", "--device",
                       # master-side exchange policy: the slave's
                       # DeltaDecoder auto-detects delta pushes, so the
                       # flags would only be parsed and ignored
                       "--exchange-dtype", "--exchange-eps"}
    drop_bare = {"--respawn", "--web-status"}
    out = [sys.executable, "-m", "veles_tpu_torch"]
    i = 0
    args = list(argv)
    while i < len(args):
        arg = args[i]
        if arg in drop_with_value:
            i += 2
            continue
        if arg.split("=")[0] in drop_with_value:
            i += 1
            continue
        if arg in drop_bare:
            i += 1
            continue
        out.append(arg)
        i += 1
    out += ["-m", "%s:%d" % tuple(master_address)]
    return " ".join(shlex.quote(a) for a in out)
