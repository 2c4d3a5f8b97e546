"""Per-tenant weighted-fair QoS admission for the serving engine (the
port of ``veles_tpu/serving/admission.py``).

* every tenant has a **weight** (share of capacity) and a **QoS
  class** -- ``interactive`` > ``batch`` > ``best_effort`` -- which
  multiplies the weight (4x / 2x / 1x by default), so an interactive
  tenant's traffic displaces batch backfill, never the reverse;
* a tenant's **guaranteed share** is ``capacity * w_i / W`` where
  ``W`` sums the weights of *recently active* tenants;
* admission is **work-conserving with reservations**: a tenant under
  its share is always admitted (global capacity permitting); a tenant
  *over* its share may borrow only headroom no active tenant has a
  claim on, so an overloaded tenant sheds onto itself;
* ``Retry-After`` on a shed is computed from **that tenant's own
  drain rate**;
* :meth:`AdmissionController.configure` sets a tenant's weight and class
  and can pin the class against a client's ``X-QoS`` promotion;
* past ``max_tenants`` buckets (after reclaiming idle auto-created
  ones; configured tenants are exempt) unknown names share the
  ``overflow`` bucket.

The default tenant (no ``X-Tenant`` header) owns the whole capacity,
which makes it a plain global outstanding-sample cap.

Telemetry (the JAX package's names, every family labeled by model):
``veles_serving_tenant_{admitted,shed}_total{model,tenant,qos}``,
``veles_serving_tenant_outstanding{model,tenant}`` and the windowed
``veles_serving_tenant_shed_ratio{model,tenant}`` gauge the
``tenant_shed_burn`` alert rule watches.
"""

import math
import threading
import time

from veles_tpu_torch.fairshare import (DEFAULT_QOS,  # noqa: F401
                                       QOS_MULTIPLIER, ShareAccount,
                                       guaranteed_share, reserved_claim)
from veles_tpu_torch.serving.engine import EngineOverloaded
from veles_tpu_torch.telemetry.registry import get_registry

DEFAULT_TENANT = "default"

#: hard bound on distinct tenant buckets: the ``X-Tenant`` header is
#: CLIENT-controlled, so without a cap a client spraying random names
#: allocates unbounded accounting state and per-tenant metric children.
#: Past the cap (after reclaiming idle auto-created buckets) unknown
#: names share one ``overflow`` bucket — the spray degrades into a
#: single tenant shedding onto itself instead of a memory leak.
MAX_TENANTS = 256
OVERFLOW_TENANT = "overflow"

#: shed-ratio gauge publishes only once this many admission decisions
#: landed in the window (mirrors the cache hit-ratio discipline)
SHED_RATIO_MIN_WINDOW = 20


class TenantOverloaded(EngineOverloaded):
    """This tenant's share is exhausted — retry after ITS drain."""

    def __init__(self, tenant, retry_after=1):
        super(TenantOverloaded, self).__init__(
            "tenant %r is over its admission share" % tenant,
            retry_after=retry_after)
        self.tenant = tenant


#: a serving tenant IS a fair-share account
_Tenant = ShareAccount


class AdmissionController(object):
    """Weighted-fair per-tenant admission over one shared capacity."""

    def __init__(self, capacity, tenants=None, default_weight=1.0,
                 default_qos=DEFAULT_QOS, activity_window_s=10.0,
                 drain_window_s=5.0, registry=None, model="default",
                 max_tenants=MAX_TENANTS):
        self.capacity = int(capacity)
        self.model = str(model)
        self.max_tenants = max(2, int(max_tenants))
        self.activity_window_s = float(activity_window_s)
        self.drain_window_s = float(drain_window_s)
        self.default_weight = float(default_weight)
        self.default_qos = default_qos
        self._lock = threading.Lock()
        self._tenants = {}
        self._pinned_qos = set()
        self._total = 0
        for spec in (tenants or {}).items():
            name, cfg = spec
            if isinstance(cfg, dict):
                self._tenants[name] = _Tenant(
                    name, weight=cfg.get("weight", 1.0),
                    qos=cfg.get("qos", default_qos))
            else:
                self._tenants[name] = _Tenant(name, weight=float(cfg),
                                              qos=default_qos)
        # operator-declared tenants are never evicted for cardinality
        self._configured = set(self._tenants)
        # every family carries the model label: multi-model serving
        # runs one controller per model, and unlabeled children would
        # merge across them (and one model's idle-eviction would reset
        # another's live counters)
        registry = registry or get_registry()
        self._m_admitted = registry.counter(
            "veles_serving_tenant_admitted_total",
            "Samples admitted per tenant",
            labels=("model", "tenant", "qos"))
        self._m_shed = registry.counter(
            "veles_serving_tenant_shed_total",
            "Samples shed per tenant (503)",
            labels=("model", "tenant", "qos"))
        self._g_outstanding = registry.gauge(
            "veles_serving_tenant_outstanding",
            "In-flight samples per tenant",
            labels=("model", "tenant"))
        self._g_shed_ratio = registry.gauge(
            "veles_serving_tenant_shed_ratio",
            "Shed fraction over the recent decision window per tenant",
            labels=("model", "tenant"))

    # -- tenant registry ---------------------------------------------------

    def _tenant(self, name, qos=None, now=None):
        tenant = self._tenants.get(name)
        if tenant is None:
            if len(self._tenants) >= self.max_tenants:
                self._evict_idle_locked(now)
            if len(self._tenants) >= self.max_tenants and \
                    name != OVERFLOW_TENANT:
                # every bucket is busy or recently active: unknown
                # names share the overflow bucket (callers must use
                # the RETURNED tenant's name for settle/metrics)
                return self._tenant(OVERFLOW_TENANT, qos=qos, now=now)
            tenant = self._tenants[name] = _Tenant(
                name, weight=self.default_weight,
                qos=qos or self.default_qos)
        elif qos and tenant.qos != qos and name not in self._pinned_qos:
            tenant.qos = qos            # client-declared class (unpinned)
        return tenant

    def _evict_idle_locked(self, now=None):
        """Reclaim auto-created buckets idle past the activity window:
        their shares are no longer reserved anyway, and dropping their
        metric children is what keeps /metrics cardinality bounded."""
        now = time.time() if now is None else now
        for name in list(self._tenants):
            if name in self._configured or name == DEFAULT_TENANT:
                continue
            tenant = self._tenants[name]
            if tenant.outstanding == 0 and \
                    now - tenant.last_active > self.activity_window_s:
                del self._tenants[name]
                self._g_outstanding.remove(model=self.model,
                                           tenant=name)
                self._g_shed_ratio.remove(model=self.model,
                                          tenant=name)
                self._m_admitted.remove(model=self.model, tenant=name)
                self._m_shed.remove(model=self.model, tenant=name)

    def configure(self, name, weight=None, qos=None, pin_qos=False):
        """Operator-set weight/class for a tenant; ``pin_qos`` stops
        clients from self-promoting via the QoS header."""
        with self._lock:
            tenant = self._tenant(name)
            self._configured.add(tenant.name)
            if weight is not None:
                tenant.weight = float(weight)
            if qos is not None:
                if qos not in QOS_MULTIPLIER:
                    raise ValueError("unknown QoS class %r (one of %s)"
                                     % (qos, sorted(QOS_MULTIPLIER)))
                tenant.qos = qos
            if pin_qos:
                self._pinned_qos.add(name)
        return self

    # -- the admission decision --------------------------------------------

    def _share_locked(self, tenant, now):
        """This tenant's guaranteed share (>=1) vs active peers."""
        return guaranteed_share(self.capacity, tenant,
                                self._tenants.values(), now,
                                self.activity_window_s)

    def _reserved_locked(self, tenant, now):
        """Unused share active OTHER tenants still hold a claim on."""
        return reserved_claim(self.capacity, tenant,
                              self._tenants.values(), now,
                              self.activity_window_s)

    def admit(self, tenant_name=None, n=1, qos=None, now=None):
        """Admit ``n`` samples for the tenant or raise
        :class:`TenantOverloaded` with its drain-derived Retry-After.
        Returns the ACCOUNTING bucket name — usually ``tenant_name``,
        but past the tenant cap an unknown name aliases to the shared
        overflow bucket, and :meth:`settle` must use the returned
        name or the outstanding count leaks."""
        now = time.time() if now is None else now
        name = tenant_name or DEFAULT_TENANT
        with self._lock:
            tenant = self._tenant(name, qos=qos, now=now)
            tenant.last_active = now
            admitted = False
            if self._total + n <= self.capacity:
                share = self._share_locked(tenant, now)
                if tenant.outstanding + n <= share:
                    admitted = True          # inside the guarantee
                else:
                    # borrowing: only headroom nobody active claims
                    reserved = self._reserved_locked(tenant, now)
                    free = self.capacity - self._total - reserved
                    admitted = n <= free
            if admitted:
                tenant.outstanding += n
                tenant.admitted_total += n
                self._total += n
                tenant.record_decision(True)
                retry_after = None
            else:
                tenant.shed_total += n
                tenant.record_decision(False)
                retry_after = self._retry_after_locked(tenant, now)
            self._publish_locked(tenant)
        if retry_after is not None:
            self._m_shed.labels(model=self.model, tenant=tenant.name,
                                qos=tenant.qos).inc(n)
            raise TenantOverloaded(tenant.name, retry_after=retry_after)
        self._m_admitted.labels(model=self.model, tenant=tenant.name,
                                qos=tenant.qos).inc(n)
        return tenant.name

    def _retry_after_locked(self, tenant, now):
        """ceil(own backlog / own drain rate), clamped to [1, 30] —
        a tenant that drains fast gets told to come right back; one
        with a dead-slow backlog is not told to hammer every second."""
        rate = tenant.drain_rate(now, self.drain_window_s)
        if rate <= 0.0:
            return 1                     # no history: optimistic
        return int(min(30, max(1, math.ceil(
            max(tenant.outstanding, 1) / rate))))

    def settle(self, tenant_name=None, n=1, now=None):
        """``n`` of the tenant's samples finished (any outcome)."""
        now = time.time() if now is None else now
        name = tenant_name or DEFAULT_TENANT
        with self._lock:
            tenant = self._tenants.get(name)
            if tenant is None:
                return
            tenant.outstanding = max(0, tenant.outstanding - n)
            self._total = max(0, self._total - n)
            for _ in range(n):
                tenant.completions.append(now)
            self._publish_locked(tenant)

    # -- reading -----------------------------------------------------------

    def _publish_locked(self, tenant):
        self._g_outstanding.labels(model=self.model,
                                   tenant=tenant.name).set(
            tenant.outstanding)
        if len(tenant.decisions) >= SHED_RATIO_MIN_WINDOW:
            self._g_shed_ratio.labels(
                model=self.model, tenant=tenant.name).set(
                tenant.shed_window / float(len(tenant.decisions)))

    def total_outstanding(self):
        with self._lock:
            return self._total

    def stats(self, now=None):
        now = time.time() if now is None else now
        with self._lock:
            return {
                "capacity": self.capacity,
                "outstanding": self._total,
                "tenants": {
                    t.name: {
                        "weight": t.weight, "qos": t.qos,
                        "outstanding": t.outstanding,
                        "admitted": t.admitted_total,
                        "shed": t.shed_total,
                        "share": round(self._share_locked(t, now), 1),
                        "drain_per_s": round(
                            t.drain_rate(now, self.drain_window_s), 2),
                    } for t in self._tenants.values()},
            }
