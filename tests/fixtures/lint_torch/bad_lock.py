"""Known-bad fixture for the lock checker: LOCK001 + LOCK003.

NEVER imported — parsed as text by tests/test_torch_analysis.py and by the
port's lint gate's self-test, which REQUIRES the gate to fail here.
"""

import threading


class TornCounter(object):
    """Writes self.count under the lock in one method, without it in
    another -> LOCK001 on the unlocked write."""

    def __init__(self):
        self._lock = threading.Lock()
        self.count = 0
        self.items = []

    def bump(self):
        with self._lock:
            self.count += 1
            self.items.append(self.count)

    def reset(self):
        self.count = 0          # LOCK001: no lock held
        self.items.clear()      # LOCK001: mutator without the lock


class SelfDeadlock(object):
    """Non-reentrant Lock re-acquired on a path that holds it ->
    LOCK003 (direct nesting and via a same-class call)."""

    def __init__(self):
        self._lock = threading.Lock()
        self.state = "idle"

    def outer(self):
        with self._lock:
            with self._lock:          # LOCK003: direct re-entry
                self.state = "dead"

    def helper(self):
        with self._lock:
            self.state = "helping"

    def indirect(self):
        with self._lock:
            self.helper()             # LOCK003: callee takes _lock
