"""The stack watch that ``chip_smoke.py``'s subprocess drivers start
with: periodic dumps of every thread's stack that cannot crash the
process they watch, and the stacks of a crash (CPU, no card)."""

import importlib.util
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: a workload whose frame stack grows and shrinks across the
#: interpreter's frame chunks, which is what a dump walking the frames
#: without the interpreter lock trips on
DEEP = """
def deep(n):
    return n if n == 0 else deep(n - 1) + 1


start = _t.time()
while _t.time() - start < 1.5:
    for i in range(200):
        deep(i % 600)
"""


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_drivers", os.path.join(REPO, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("driver", ["DIST_DRIVER", "SPMD_DRIVER"])
def test_driver_starts_with_the_stack_watch(smoke, driver):
    source = getattr(smoke, driver)
    period = {"DIST_DRIVER": 60, "SPMD_DRIVER": 120}[driver]
    assert source.startswith(smoke.stack_watch(period))
    assert "dump_traceback_later" not in source
    compile(source, driver, "exec")


def test_stack_watch_dumps_without_crashing(smoke):
    run = subprocess.run(
        [sys.executable, "-c", smoke.stack_watch(0.05) + DEEP],
        capture_output=True, text=True, timeout=60)
    assert run.returncode == 0, run.stderr[-2000:]
    assert run.stderr.count("every thread's stack:") >= 5
    assert "in deep" in run.stderr


def test_stack_watch_shows_a_crash(smoke):
    run = subprocess.run(
        [sys.executable, "-c", smoke.stack_watch(60) +
         "import ctypes\nctypes.string_at(0)\n"],
        capture_output=True, text=True, timeout=60)
    assert run.returncode == -11
    assert "Fatal Python error: Segmentation fault" in run.stderr
    assert "in _stack_watch" in run.stderr
