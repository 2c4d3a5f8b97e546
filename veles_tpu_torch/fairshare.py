"""Weighted-fair share accounting (the port's copy of
``veles_tpu/fairshare.py``).

The serving :class:`~veles_tpu_torch.serving.admission.
AdmissionController` meters *in-flight samples* against an engine
capacity with it:

* every principal (a tenant) has a **weight** and a **QoS class**
  (``interactive`` > ``batch`` > ``best_effort``, multiplying the
  weight 4x/2x/1x by default), so interactive work displaces batch
  backfill, never the reverse;
* a principal's **guaranteed share** is ``capacity * w_i / W`` where
  ``W`` sums the effective weights of *recently active* principals —
  an idle principal's share is lendable, a returning one reclaims it
  within one ``activity_window_s``;
* allocation is **work-conserving with reservations**: under-share
  principals are always served (capacity permitting); an over-share
  principal may borrow only headroom no active peer holds a claim on
  (:func:`reserved_claim` — the sum of other active principals'
  unused shares stays reserved for them).

This module is pure accounting: no locks, no metrics, no clocks of
its own -- callers hold their own lock, pass ``now`` explicitly, and
publish whatever telemetry fits their plane.
"""

import collections

#: QoS class -> weight multiplier; order is also the shed priority
QOS_MULTIPLIER = {"interactive": 4.0, "batch": 2.0, "best_effort": 1.0}
DEFAULT_QOS = "batch"


class ShareAccount(object):
    """Accounting for one principal: outstanding units, drain rate,
    decision windows. (The serving plane calls these *tenants* and
    re-exports this class as its historical ``_Tenant`` name.)"""

    __slots__ = ("name", "weight", "qos", "outstanding", "last_active",
                 "completions", "decisions", "shed_window",
                 "admitted_total", "shed_total")

    def __init__(self, name, weight=1.0, qos=DEFAULT_QOS):
        self.name = name
        self.weight = float(weight)
        self.qos = qos
        self.outstanding = 0
        self.last_active = 0.0
        self.completions = collections.deque()   # (t,) drain window
        self.decisions = collections.deque(maxlen=256)  # 1 admit/0 shed
        self.shed_window = 0    # running count of 0s in `decisions`
        self.admitted_total = 0
        self.shed_total = 0

    @property
    def effective_weight(self):
        return self.weight * QOS_MULTIPLIER.get(self.qos, 1.0)

    def is_active(self, now, activity_window_s):
        """Holding units, or touched within the activity window —
        the set whose weights divide the capacity."""
        return (self.outstanding > 0 or
                now - self.last_active <= activity_window_s)

    def record_decision(self, admitted):
        """Window append with a running shed count — callers publish
        a shed-ratio gauge on every admit/settle under their global
        lock, so re-counting the window there would be O(window)
        hot-path work."""
        if len(self.decisions) == self.decisions.maxlen:
            self.shed_window -= 1 - self.decisions.popleft()
        self.decisions.append(1 if admitted else 0)
        if not admitted:
            self.shed_window += 1

    def drain_rate(self, now, window_s):
        horizon = now - window_s
        while self.completions and self.completions[0] < horizon:
            self.completions.popleft()
        if not self.completions:
            return 0.0
        return len(self.completions) / window_s


def guaranteed_share(capacity, account, accounts, now,
                     activity_window_s):
    """``account``'s guaranteed share (>=1) vs its active peers."""
    active_w = account.effective_weight
    for other in accounts:
        if other is account:
            continue
        if other.is_active(now, activity_window_s):
            active_w += other.effective_weight
    return max(1.0, capacity * account.effective_weight / active_w)


def reserved_claim(capacity, account, accounts, now,
                   activity_window_s):
    """Unused share active OTHER principals still hold a claim on —
    the headroom ``account`` may NOT borrow."""
    reserved = 0.0
    total_w = sum(
        a.effective_weight for a in accounts
        if a is account or a.is_active(now, activity_window_s))
    for other in accounts:
        if other is account:
            continue
        if other.is_active(now, activity_window_s):
            share = capacity * other.effective_weight / total_w
            reserved += max(0.0, share - other.outstanding)
    return reserved
