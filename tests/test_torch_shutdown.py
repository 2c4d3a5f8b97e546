"""A process of the port ends without a daemon thread in a card query.

The CLI and ``serve`` start the process-wide memory sampler
(``telemetry/profiler.py``), a daemon thread that queries the card's
allocator every few seconds. A daemon thread still inside such a query
when the interpreter finalizes is made to exit from inside C++ code,
and the process aborts ("terminate called without an active
exception", exit -6). The sampler is therefore joined by an ``atexit``
handler: by the time the interpreter finalizes, it has stopped.
"""

import os
import subprocess
import sys

import pytest

pytest.importorskip("torch")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: a handler registered before the sampler starts runs after the
#: sampler's own (atexit runs the last registered first); it reports
#: whether the sampler thread is still there
EXIT_CHECK = """
import atexit, threading, time
from veles_tpu_torch.telemetry import profiler


def report():
    alive = [t.name for t in threading.enumerate()
             if t.name == "memory-sampler"]
    print("SAMPLER", profiler._sampler is None, alive)


atexit.register(report)
profiler.start_memory_sampler(interval=%r)
time.sleep(0.2)
"""


@pytest.mark.parametrize("interval", [0.01, 5.0])
def test_the_memory_sampler_is_joined_before_the_interpreter_exits(
        tmp_path, interval):
    """Sampling often (the thread mostly inside a query) or rarely (the
    thread waiting): either way the sampler has stopped before the
    interpreter finalizes, and the process exits 0."""
    proc = subprocess.run(
        [sys.executable, "-c", EXIT_CHECK % interval], cwd=str(tmp_path),
        env=dict(os.environ, PYTHONPATH=REPO), capture_output=True,
        text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "SAMPLER True []" in proc.stdout, proc.stdout + proc.stderr
