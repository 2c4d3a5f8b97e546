"""Known-bad fixture: LOCK002 lock-order cycle. Never imported."""

import threading


class OrderCycle(object):
    """transfer() takes a then b; refund() takes b then a — two
    threads running them concurrently deadlock."""

    def __init__(self):
        self._a = threading.Lock()
        self._b = threading.Lock()
        self.balance = 0

    def transfer(self):
        with self._a:
            with self._b:
                self.balance += 1

    def refund(self):
        with self._b:
            with self._a:
                self.balance -= 1
