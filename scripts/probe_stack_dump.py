#!/usr/bin/env python3
"""Whether a periodic all-threads stack dump can crash the process it
watches, on the CPU.

    python3 scripts/probe_stack_dump.py [SECONDS] [TRIALS]

Runs a child process that recurses 0-599 frames deep in a loop for
SECONDS (default 20) while its stacks are dumped every 0.5 ms to
``/dev/null``, in two ways, TRIALS times each (default 2):

* ``later``: ``faulthandler.dump_traceback_later(repeat=True)``, whose C
  watchdog thread walks the other threads' frames without the
  interpreter lock;
* ``thread``: what ``chip_smoke.py`` ``stack_watch`` does, a Python
  thread calling ``faulthandler.dump_traceback(all_threads=True)``,
  which holds the lock, so the frames cannot change under it.

Prints one JSON object: each way's exit codes (-11 is SIGSEGV).
"""

import json
import subprocess
import sys

CHILD = r"""
import faulthandler, os, sys, threading, time
way, seconds = sys.argv[1], float(sys.argv[2])
sink = open(os.devnull, "w")
if way == "later":
    faulthandler.dump_traceback_later(0.0005, repeat=True, file=sink)
else:
    def watch():
        while True:
            time.sleep(0.0005)
            faulthandler.dump_traceback(file=sink, all_threads=True)
    threading.Thread(target=watch, daemon=True).start()


def deep(n):
    return n if n == 0 else deep(n - 1) + 1


start = time.time()
while time.time() - start < seconds:
    for i in range(200):
        deep(i % 600)
"""


def main(argv):
    seconds = float(argv[0]) if argv else 20.0
    trials = int(argv[1]) if len(argv) > 1 else 2
    result = {"seconds": seconds, "python": sys.version.split()[0]}
    for way in ("later", "thread"):
        result[way] = [subprocess.run(
            [sys.executable, "-c", CHILD, way, str(seconds)],
            timeout=seconds * 3 + 30).returncode for _ in range(trials)]
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
