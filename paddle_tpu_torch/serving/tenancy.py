"""Multi-tenant serving plane: the tenant registry with token-bucket quota
admission and per-tenant isolation state (the port's own copy of
``paddle_tpu/serving/tenancy.py``).

One noisy customer must not degrade every other customer's TTFT. The
construction layers ABOVE the EDF scheduler in
``ServingFrontend.submit(tenant=...)``:

- **quota admission** — each :class:`Tenant` owns a token bucket
  (``quota_rps`` refill, ``burst`` capacity) plus an in-flight request
  cap. An over-quota submit is shed with a typed
  ``Overloaded(step="tenant_quota", tenant=..., retry_after_s=...)``
  where ``retry_after_s`` is computed from the bucket's refill deficit
  (how long until one whole token exists), not a constant — the client's
  backoff demand is exactly the server's arithmetic.
- **per-tenant isolation** — every tenant carries its OWN brownout
  ladder (labeled metric series, tenant-stamped rejections) and, via the
  frontend, its own SLO burn-rate monitor and retry budget: a storming
  tenant walks the rung ladder and burns its budget alone while the
  fleet — and every other tenant — stays green.
- **bounded identity** — tenants are DECLARED (registered) up front;
  :meth:`TenantRegistry.resolve` raises on unknown names instead of
  minting state per request-supplied string. That bound is what makes
  the ``tenant=`` metric label safe (no unbounded label cardinality —
  the ``tenant-label-bounded`` analysis rule pins the code shape) and
  the registry itself O(declared tenants) forever. Untenanted traffic
  maps to the ``"default"`` tenant, unlimited unless
  ``PADDLE_TENANCY_DEFAULT_QUOTA_RPS`` says otherwise — the pre-tenancy
  API is byte-compatible.

Policy only — no threads, no engine access, injectable clock; the
frontend consults ``admit``/``acquire_slot`` at submit time and feeds
each tenant's ladder from its monitor tick (docs/SERVING.md).
"""
import re
import threading
import time

from ..observability.metrics import registry as _registry
from ..utils.envs import env_float, env_int
from .brownout import BrownoutLadder
from .scheduler import Overloaded

__all__ = ["Tenant", "TenantRegistry", "DEFAULT_TENANT"]

#: the tenant untenanted traffic maps to (byte-compatible with the untenanted
#: submit path: unlimited quota unless the env says otherwise)
DEFAULT_TENANT = "default"

#: declared-name shape: metric-label-safe, path-safe, bounded length
_NAME_RE = re.compile(r"^[A-Za-z0-9][A-Za-z0-9_.\-]{0,63}$")


class Tenant:
    """One declared tenant: identity, quota, and isolation state.

    ``quota_rps <= 0`` means unlimited (no bucket accounting at all);
    ``burst`` defaults to ``max(1, quota_rps)`` — a tenant may always
    spend its steady-state second in one gulp. ``max_inflight`` bounds
    concurrently-running requests independently of arrival rate (a
    tenant of slow, long requests can saturate a fleet at 1 rps).
    ``adapters`` is an optional allowlist of LoRA adapter names/digests
    this tenant may request (empty = any registered adapter).
    """

    def __init__(self, name, slo_class=None, quota_rps=0.0, burst=None,
                 max_inflight=None, adapters=(), brownout=None,
                 clock=time.monotonic):
        if not _NAME_RE.match(str(name)):
            raise ValueError(
                f"tenant name {name!r} must match {_NAME_RE.pattern} "
                f"(it becomes a metric label and a report key)")
        self.name = str(name)
        self.slo_class = slo_class
        self.quota_rps = float(quota_rps)
        self.burst = (float(burst) if burst is not None
                      else max(1.0, self.quota_rps))
        if self.burst < 1.0:
            raise ValueError(f"tenant {name!r}: burst must be >= 1")
        self.max_inflight = (int(max_inflight)
                             if max_inflight is not None else None)
        self.adapters = tuple(adapters or ())
        self._clock = clock
        self._lock = threading.Lock()
        self._tokens = self.burst
        self._refill_t = self._clock()
        self._inflight = 0
        # private isolation plane: this tenant's brownout ladder (labeled
        # series + tenant-stamped Overloaded) and, via the ladder, its own
        # retry budget — a storming tenant browns out ALONE
        self.brownout = brownout or BrownoutLadder(
            labels={"tenant": self.name}, tenant=self.name, clock=clock)
        self._m_admitted = _registry.counter(
            "tenant.admitted", labels={"tenant": self.name},
            help="requests admitted past the tenant quota layer")
        self._m_shed = _registry.counter(
            "tenant.shed", labels={"tenant": self.name},
            help="submits shed by the tenant layer (quota, inflight cap, "
                 "or the tenant's private brownout ladder)")
        self._g_inflight = _registry.gauge(
            "tenant.inflight", labels={"tenant": self.name},
            help="this tenant's requests currently queued or running")

    # ---- token bucket ------------------------------------------------------
    def _refill_locked(self, now):
        if self.quota_rps <= 0:
            return
        dt = max(0.0, now - self._refill_t)
        self._refill_t = now
        self._tokens = min(self.burst, self._tokens + dt * self.quota_rps)

    def admit(self, now=None):
        """Withdraw one token or shed. The typed rejection's
        ``retry_after_s`` is the refill deficit — the exact seconds until
        one whole token exists at ``quota_rps`` — so an honoring client
        retries the moment it can succeed and not before."""
        if self.quota_rps <= 0:
            return
        now = self._clock() if now is None else now
        with self._lock:
            self._refill_locked(now)
            if self._tokens >= 1.0:
                self._tokens -= 1.0
                return
            deficit = (1.0 - self._tokens) / self.quota_rps
        self._m_shed.inc()
        raise Overloaded(
            f"tenant {self.name!r} over quota ({self.quota_rps} rps, "
            f"burst {self.burst}); retry after {deficit:.3f}s",
            retry_after_s=deficit, step="tenant_quota", tenant=self.name)

    def tokens(self, now=None):
        """Current bucket level (refilled to now) — report/test surface."""
        if self.quota_rps <= 0:
            return self.burst
        now = self._clock() if now is None else now
        with self._lock:
            self._refill_locked(now)
            return self._tokens

    # ---- inflight cap ------------------------------------------------------
    def acquire_slot(self):
        """Count one queued/running request against ``max_inflight``; the
        frontend releases at the handle's terminal transition. The shed's
        ``retry_after_s`` is one steady-state inter-arrival gap (there is
        no refill clock to derive a deficit from — a slot frees when some
        request finishes, which the quota rate approximates)."""
        with self._lock:
            if (self.max_inflight is not None
                    and self._inflight >= self.max_inflight):
                retry = (max(1.0 / self.quota_rps, 0.05)
                         if self.quota_rps > 0 else 0.5)
                inflight = self._inflight
            else:
                self._inflight += 1
                self._g_inflight.set(self._inflight)
                return
        self._m_shed.inc()
        raise Overloaded(
            f"tenant {self.name!r} at max_inflight={self.max_inflight} "
            f"({inflight} in flight); retry after {retry:.3f}s",
            retry_after_s=retry, step="tenant_inflight", tenant=self.name)

    def release_slot(self):
        with self._lock:
            self._inflight = max(0, self._inflight - 1)
            self._g_inflight.set(self._inflight)

    @property
    def inflight(self):
        return self._inflight

    def count_shed(self):
        """One shed attributed to this tenant by a layer outside this
        class (the tenant's private brownout ladder / retry budget —
        the frontend's catch site calls this)."""
        self._m_shed.inc()

    def count_admitted(self):
        self._m_admitted.inc()

    # ---- isolation plane ---------------------------------------------------
    def pressure(self):
        """This tenant's OWN pressure (0..1) for its private ladder: how
        close it runs to its declared bounds — bucket drained and/or
        inflight cap reached — not how pressed the fleet is."""
        p = 0.0
        if self.quota_rps > 0:
            p = max(p, 1.0 - self.tokens() / self.burst)
        if self.max_inflight:
            p = max(p, min(1.0, self._inflight / self.max_inflight))
        return p

    def allows_adapter(self, adapter):
        """True when ``adapter`` (a LoRAAdapter, or a name/digest) is in
        this tenant's allowlist (empty allowlist = any adapter)."""
        if not self.adapters:
            return True
        refs = {adapter} if isinstance(adapter, str) else {
            getattr(adapter, "name", None), getattr(adapter, "digest", None)}
        return bool(refs & set(self.adapters))

    def report(self):
        return {
            "slo_class": self.slo_class,
            "quota_rps": self.quota_rps,
            "burst": self.burst,
            "tokens": round(self.tokens(), 3),
            "max_inflight": self.max_inflight,
            "inflight": self._inflight,
            "adapters": list(self.adapters),
            "pressure": round(self.pressure(), 4),
            "shed": self._m_shed.value,
            "admitted": self._m_admitted.value,
            "brownout": self.brownout.report(),
        }

    def __repr__(self):
        return (f"Tenant({self.name!r}, quota_rps={self.quota_rps}, "
                f"burst={self.burst}, max_inflight={self.max_inflight})")


class TenantRegistry:
    """The bounded set of declared tenants.

    ``resolve(None)`` maps untenanted traffic to the auto-created
    ``"default"`` tenant (unlimited unless
    ``PADDLE_TENANCY_DEFAULT_QUOTA_RPS`` > 0 — byte-compatible with the
    pre-tenancy submit path); ``resolve(<unknown name>)`` raises
    ``ValueError`` — tenants are declared, never minted per request,
    which is the whole label-cardinality/bounded-state contract."""

    def __init__(self, tenants=(), default=None, max_tenants=None):
        self.max_tenants = (env_int("PADDLE_TENANCY_MAX_TENANTS", 64)
                            if max_tenants is None else int(max_tenants))
        self._lock = threading.Lock()
        self._tenants = {}
        self.default = default or Tenant(
            DEFAULT_TENANT,
            quota_rps=env_float("PADDLE_TENANCY_DEFAULT_QUOTA_RPS", 0.0))
        self.register(self.default)
        for t in tenants:
            self.register(t)

    def register(self, tenant):
        """Declare a tenant (bounded; duplicate names refused)."""
        if not isinstance(tenant, Tenant):
            raise TypeError(f"register() takes a Tenant, got {tenant!r}")
        with self._lock:
            if tenant.name in self._tenants:
                raise ValueError(f"tenant {tenant.name!r} already declared")
            if len(self._tenants) >= self.max_tenants:
                raise ValueError(
                    f"tenant registry full ({self.max_tenants}; "
                    f"PADDLE_TENANCY_MAX_TENANTS)")
            self._tenants[tenant.name] = tenant
        return tenant

    def resolve(self, tenant):
        """None | name | Tenant -> the declared Tenant (unknown raises)."""
        if tenant is None:
            return self.default
        if isinstance(tenant, Tenant):
            tenant = tenant.name
        with self._lock:
            try:
                return self._tenants[tenant]
            except KeyError:
                raise ValueError(
                    f"unknown tenant {tenant!r}; declared: "
                    f"{sorted(self._tenants)}") from None

    def names(self):
        with self._lock:
            return sorted(self._tenants)

    def tenants(self):
        with self._lock:
            return list(self._tenants.values())

    def __len__(self):
        with self._lock:
            return len(self._tenants)

    def __contains__(self, name):
        with self._lock:
            return name in self._tenants

    def report(self):
        with self._lock:
            items = sorted(self._tenants.items())
        return {name: t.report() for name, t in items}
