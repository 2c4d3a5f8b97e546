"""Write-ahead job journal: the scheduler's durable state
(``veles_tpu/sched/journal.py``, in its file format: a journal written
by either package replays in the other).

The gang scheduler keeps jobs, accounts and grants in memory; this
module makes a crash survivable. Every state-changing event (submit,
FSM transition, grant, preempt, reap) appends ONE fsync'd JSON line to
``<state_dir>/journal.jsonl`` before the scheduler acts on it — the
classic write-ahead discipline: after a crash, replaying the journal
reconstructs exactly the state the scheduler had acknowledged.

Two properties keep replay simple and safe:

* **Upsert events.** Each event carries the job's FULL record
  (:meth:`veles_tpu_torch.sched.job.Job.record`), not an increment — so
  replaying a line twice is the same as replaying it once, and replay
  order only matters per job (last write wins).
* **Torn-tail tolerance.** ``fsync`` bounds loss to the line being
  written at crash time; a half-written final line is expected, not
  corruption. Replay stops at the first undecodable line with a
  warning — it never aborts (the ``snapshotter.py`` corrupt-artifact
  fallback discipline, applied to the control plane).

On size the journal **compacts**: the full state image is written to
``snapshot.json`` via the snapshotter's ``_atomic_write`` (hidden tmp
+ rename — a crash mid-compaction never destroys the previous image),
THEN the journal truncates. A crash between the two steps leaves a
snapshot plus a journal whose events are already folded into it —
harmless, because replay-on-top is idempotent by construction.
"""

import json
import logging
import os

from veles_tpu_torch.snapshotter import _atomic_write

JOURNAL_NAME = "journal.jsonl"
SNAPSHOT_NAME = "snapshot.json"

#: compaction threshold: generous for a control plane writing ~1 KiB
#: per event, small enough that replay stays instant
DEFAULT_MAX_BYTES = 4 << 20

logger = logging.getLogger("JobJournal")


class JobJournal(object):
    """Append-only fsync'd event log + compacted snapshot image."""

    def __init__(self, state_dir, max_bytes=DEFAULT_MAX_BYTES,
                 metrics=None):
        self.state_dir = os.path.abspath(state_dir)
        os.makedirs(self.state_dir, exist_ok=True)
        self.journal_path = os.path.join(self.state_dir, JOURNAL_NAME)
        self.snapshot_path = os.path.join(self.state_dir, SNAPSHOT_NAME)
        self.max_bytes = int(max_bytes)
        self._metrics = metrics
        self._f = None

    # -- write path --------------------------------------------------------

    def append(self, event):
        """One fsync'd line; the event is durable when this returns."""
        if self._f is None:
            self._f = open(self.journal_path, "a", encoding="utf-8")
        self._f.write(json.dumps(event, sort_keys=True) + "\n")
        self._f.flush()
        os.fsync(self._f.fileno())
        return self._gauge()

    def should_compact(self):
        return self._f is not None and self._f.tell() > self.max_bytes

    def compact(self, image):
        """Fold the journal into ``snapshot.json``: atomic image write
        FIRST, journal truncate second (the crash-safe order)."""
        _atomic_write(
            self.state_dir, SNAPSHOT_NAME,
            lambda tmp: self._write_image(tmp, image))
        if self._f is not None:
            self._f.close()
        self._f = open(self.journal_path, "w", encoding="utf-8")
        self._f.flush()
        os.fsync(self._f.fileno())
        self._gauge()

    @staticmethod
    def _write_image(tmp, image):
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(image, f, sort_keys=True)
            f.flush()
            os.fsync(f.fileno())

    def _gauge(self):
        size = self._f.tell() if self._f is not None else 0
        if self._metrics is not None:
            self._metrics["journal_bytes"].set(size)
        return size

    def close(self):
        if self._f is not None:
            self._f.close()
            self._f = None

    # -- replay path -------------------------------------------------------

    def replay(self):
        """``(image, events)``: the last compacted snapshot (or None)
        plus every journal event since it. Corrupt artifacts degrade
        — a bad snapshot is ignored with a warning (the journal alone
        still replays everything since the last truncate), and a torn
        journal tail stops the scan instead of aborting it."""
        image = None
        if os.path.exists(self.snapshot_path):
            try:
                with open(self.snapshot_path, encoding="utf-8") as f:
                    image = json.load(f)
            except (ValueError, OSError) as e:
                logger.warning(
                    "ignoring corrupt journal snapshot %s: %s",
                    self.snapshot_path, e)
                image = None
        events = []
        if os.path.exists(self.journal_path):
            with open(self.journal_path, encoding="utf-8") as f:
                for lineno, line in enumerate(f, 1):
                    if not line.strip():
                        continue
                    try:
                        events.append(json.loads(line))
                    except ValueError:
                        # torn tail (or garbage) — everything after
                        # the first bad line is untrustworthy
                        logger.warning(
                            "journal %s: stopping replay at "
                            "undecodable line %d",
                            self.journal_path, lineno)
                        break
        return image, events
