"""Overload brownout ladder + retry budget (the port's own copy of
``paddle_tpu/serving/brownout.py``).

Queue-bound shedding (scheduler.py) is a cliff: below the bound every
request gets full service, at the bound requests are rejected outright.
A fleet under a load swing (or recovering from a replica loss) needs the
slope between those extremes — *declared* degradation steps that buy
capacity back gradually, cheapest-first, and release in reverse order as
pressure drains:

    level 0  normal             full service
    level 1  shed_prefill_depth concurrent chunked prefills capped
                                (``prefill_depth_cap()``) — new prompt
                                work queues a little so in-flight decode
                                keeps its TPOT; nothing is rejected
    level 2  shed_peer_fetch    cluster KV-fabric peer fetches off
                                (``peer_fetch_enabled()``) — a fetch
                                spends wire bandwidth and adopt work to
                                SAVE compute, which is the wrong trade
                                once the fleet is pressed; local
                                recompute is bit-identical anyway
    level 3  clamp_tokens       batch-class max_new_tokens clamped
                                (bounded decode work per batch request)
    level 4  shed_extras        optional work off: hedged/speculative
                                extras are declared disabled
                                (``extras_enabled()``), the router skips
                                the O(prompt-bytes) prefix-affinity probe
                                and places by load alone, and no
                                per-request traces are minted
    level 5  shed_batch         batch-class submits rejected with a
                                machine-readable
                                ``Overloaded(retry_after_s=)``;
                                interactive still served
    level 6  reject             everything rejected with ``Overloaded``

Engagement is pressure-driven with hysteresis: a step engages the moment
pressure crosses its ``engage_at`` (climbing one rung per observation so
the engagement sequence is the declared order), and releases one rung at
a time only after pressure has stayed at/below the rung's ``release_at``
for ``dwell_s`` — a ladder without dwell oscillates at the threshold,
which is its own outage.

The **retry budget** (:class:`RetryBudget`) is the anti-retry-storm
valve: every *accepted* request deposits ``ratio`` tokens into its
class's bucket; a submit marked ``is_retry=True`` must withdraw a whole
token or it is rejected immediately (``brownout.retry_denied``) with a
``retry_after_s`` that grows with the brownout level. While the fleet is
healthy, accepted traffic keeps the bucket full and retries are free;
while it is browning out, acceptances dwindle, the bucket drains, and a
client herd re-submitting its rejections cannot re-saturate admission —
the budget caps retry traffic at ``ratio`` of the goodput the fleet is
actually sustaining (the Finagle/gRPC retry-budget construction).

Policy only — no threads, no engine access, injectable clock; the
frontend feeds ``observe()`` from its monitor tick and consults the
query methods at submit time (docs/SERVING.md has the operator view).
"""
import threading
import time

from ..observability.metrics import registry as _registry
from .scheduler import Overloaded

__all__ = ["BrownoutStep", "BrownoutLadder", "RetryBudget",
           "DEFAULT_STEPS", "SHED_PREFILL_DEPTH", "SHED_PEER_FETCH",
           "CLAMP_TOKENS", "SHED_EXTRAS", "SHED_BATCH", "REJECT"]

SHED_PREFILL_DEPTH = "shed_prefill_depth"
SHED_PEER_FETCH = "shed_peer_fetch"
CLAMP_TOKENS = "clamp_tokens"
SHED_EXTRAS = "shed_extras"
SHED_BATCH = "shed_batch"
REJECT = "reject"

_M_LEVEL = _registry.gauge(
    "brownout.level", help="current brownout ladder level (0 = normal)")


class BrownoutStep:
    """One declared degradation rung: a name the metrics/docs refer to,
    the pressure that engages it, and the (lower) pressure that releases
    it — ``release_at < engage_at`` is the hysteresis band."""

    __slots__ = ("name", "engage_at", "release_at")

    def __init__(self, name, engage_at, release_at):
        if not 0.0 < release_at <= engage_at:
            raise ValueError(
                f"step {name!r}: need 0 < release_at <= engage_at, got "
                f"release_at={release_at} engage_at={engage_at}")
        self.name = str(name)
        self.engage_at = float(engage_at)
        self.release_at = float(release_at)

    def __repr__(self):
        return (f"BrownoutStep({self.name!r}, engage_at={self.engage_at}, "
                f"release_at={self.release_at})")


DEFAULT_STEPS = (
    # cheapest rung first: capping concurrent chunked prefills
    # costs only prompt-admission latency — decode TPOT and every already-
    # admitted request are untouched — so it engages well before anything
    # that clamps or rejects
    BrownoutStep(SHED_PREFILL_DEPTH, engage_at=0.72, release_at=0.55),
    # peer KV fetches next: a fetch trades wire + adopt work
    # for saved prefill compute — a good trade only while there is slack.
    # Shedding it costs nothing but the cache win; recompute is
    # bit-identical, so this rung is invisible to correctness.
    BrownoutStep(SHED_PEER_FETCH, engage_at=0.76, release_at=0.58),
    BrownoutStep(CLAMP_TOKENS, engage_at=0.80, release_at=0.60),
    BrownoutStep(SHED_EXTRAS, engage_at=0.88, release_at=0.70),
    BrownoutStep(SHED_BATCH, engage_at=0.94, release_at=0.78),
    BrownoutStep(REJECT, engage_at=0.99, release_at=0.86),
)


class RetryBudget:
    """Per-SLO-class token bucket refilled by accepted requests. Starts
    full (``burst`` tokens) so a healthy fleet never penalizes the first
    retries; sustained rejection drains it faster than ``ratio`` of the
    surviving goodput refills it."""

    def __init__(self, ratio=0.1, burst=10.0):
        self.ratio = float(ratio)
        self.burst = float(burst)
        self._tokens = {}
        self._lock = threading.Lock()

    def on_accepted(self, slo_class):
        with self._lock:
            cur = self._tokens.get(slo_class, self.burst)
            self._tokens[slo_class] = min(self.burst, cur + self.ratio)

    def try_consume(self, slo_class):
        """Withdraw one token for a retry; False = over budget."""
        with self._lock:
            cur = self._tokens.get(slo_class, self.burst)
            if cur < 1.0:
                return False
            self._tokens[slo_class] = cur - 1.0
            return True

    def tokens(self, slo_class):
        with self._lock:
            return self._tokens.get(slo_class, self.burst)


class BrownoutLadder:
    """The ladder state machine + the submit-time policy queries.

    ``observe(pressure)`` advances at most one rung per call (up
    immediately, down after ``dwell_s`` at/below the release threshold);
    everything else is a read. All transitions land on the metrics
    registry (``brownout.level`` gauge, ``brownout.engaged`` /
    ``brownout.released`` counters labeled ``{step=}``) and in a bounded
    ``history`` the supervisor/statusz report.

    Per-tenant ladders: ``labels`` (e.g. the tenant label a
    :class:`~paddle_tpu_torch.serving.tenancy.Tenant` builds from its
    registry-declared name) keeps a private ladder's gauge/counter series
    distinct from the fleet ladder's, and ``tenant`` stamps the tenant
    name into every ``Overloaded`` this ladder raises."""

    def __init__(self, steps=DEFAULT_STEPS, batch_token_cap=64,
                 dwell_s=2.0, retry_after_base_s=0.5,
                 retry_budget=None, clock=time.monotonic,
                 labels=None, tenant=None):
        self.steps = list(steps)
        if not self.steps:
            raise ValueError("need at least one brownout step")
        names = [s.name for s in self.steps]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate step names in {names}")
        eng = [s.engage_at for s in self.steps]
        if eng != sorted(eng):
            raise ValueError("steps must be declared in engage_at order")
        self.batch_token_cap = int(batch_token_cap)
        self.dwell_s = float(dwell_s)
        self.retry_after_base_s = float(retry_after_base_s)
        self.retry_budget = retry_budget or RetryBudget()
        self.labels = dict(labels) if labels else {}
        self.tenant = tenant
        # a labeled (per-tenant) ladder gets its own gauge series; the
        # unlabeled fleet ladder keeps the module-level one so existing
        # dashboards read byte-identically
        self._g_level = (_M_LEVEL if not self.labels else _registry.gauge(
            "brownout.level", labels=self.labels,
            help="current brownout ladder level (0 = normal)"))
        self._clock = clock
        self._lock = threading.Lock()
        self._level = 0            # 0 = normal, i = steps[i-1] engaged
        self._below_since = None   # pressure <= release_at continuously
        self.history = []          # bounded [(t, "engage"/"release", step)]
        self.pressure = 0.0        # last observed (report convenience)

    # ---- state machine ----------------------------------------------------
    def observe(self, pressure, now=None):
        """One control-cadence sample of fleet pressure (0..1). Returns
        the (possibly changed) level. At most one rung of movement per
        call, so engagement events always fire in the declared order."""
        now = self._clock() if now is None else now
        with self._lock:
            self.pressure = float(pressure)
            lvl = self._level
            if lvl < len(self.steps) \
                    and pressure >= self.steps[lvl].engage_at:
                self._level = lvl + 1
                self._below_since = None
                step = self.steps[lvl]
                self.history.append((now, "engage", step.name))
                del self.history[:-64]
                _registry.counter(
                    "brownout.engaged",
                    labels={"step": step.name, **self.labels},
                    help="brownout rung engagements per declared step").inc()
                self._g_level.set(self._level)
                return self._level
            if lvl > 0 and pressure <= self.steps[lvl - 1].release_at:
                if self._below_since is None:
                    self._below_since = now
                elif now - self._below_since >= self.dwell_s:
                    step = self.steps[lvl - 1]
                    self._level = lvl - 1
                    self._below_since = now  # dwell again per rung
                    self.history.append((now, "release", step.name))
                    del self.history[:-64]
                    _registry.counter(
                        "brownout.released",
                        labels={"step": step.name, **self.labels},
                        help="brownout rung releases per declared step").inc()
                    self._g_level.set(self._level)
            else:
                self._below_since = None
        return self._level

    @property
    def level(self):
        return self._level

    def step_name(self, level=None):
        lvl = self._level if level is None else level
        return self.steps[lvl - 1].name if lvl else None

    def _engaged_at_least(self, step_name):
        for i, s in enumerate(self.steps):
            if s.name == step_name:
                return self._level >= i + 1
        return False

    # ---- submit-time policy queries ---------------------------------------
    def retry_after_s(self):
        """The backoff the server demands right now — grows with the
        ladder level so deeper brownout pushes clients further away."""
        return self.retry_after_base_s * (1 + self._level)

    def token_cap(self, slo, reserve_class):
        """max_new_tokens cap for this class (None = unclamped): batch
        classes are clamped from ``clamp_tokens`` up, the reserve
        (interactive) class never is."""
        if slo.name == reserve_class:
            return None
        if self._engaged_at_least(CLAMP_TOKENS):
            return self.batch_token_cap
        return None

    def extras_enabled(self):
        """False from ``shed_extras`` up: hedged/speculative extras,
        affinity probing, and per-request trace minting are off."""
        return not self._engaged_at_least(SHED_EXTRAS)

    def peer_fetch_enabled(self):
        """False from ``shed_peer_fetch`` up: the KV fabric skips the
        peer-fetch tier and falls straight through to local recompute
        (counted ``kv.fallthrough{reason=peer_fetch_shed}`` when a
        candidate actually existed)."""
        return not self._engaged_at_least(SHED_PEER_FETCH)

    def prefill_depth_cap(self):
        """Max concurrent chunked prefills per replica (None = uncapped):
        from ``shed_prefill_depth`` up, a replica already advancing
        ``prefill_depth_cap`` prompts defers admitting new prefill work,
        so queued prompts trade a little admission latency for the
        in-flight requests' decode cadence. The cap halves at each deeper
        rung (floor 1) — deeper brownout serializes prefills entirely."""
        if not self._engaged_at_least(SHED_PREFILL_DEPTH):
            return None
        for i, s in enumerate(self.steps):
            if s.name == SHED_PREFILL_DEPTH:
                return max(1, 2 >> (self._level - i - 1))
        return None

    def check_admission(self, slo, reserve_class):
        """Raise the machine-readable Overloaded for classes the current
        rung sheds (called by submit BEFORE the queue-bound check)."""
        if self._engaged_at_least(REJECT):
            shed_step = REJECT
        elif self._engaged_at_least(SHED_BATCH) \
                and slo.name != reserve_class:
            shed_step = SHED_BATCH
        else:
            return
        raise Overloaded(
            f"brownout level {self._level} ({self.step_name()}): shedding "
            f"{slo.name!r} traffic; retry after "
            f"{self.retry_after_s():.2f}s",
            retry_after_s=self.retry_after_s(), level=self._level,
            step=shed_step, slo_class=slo.name, tenant=self.tenant)

    def check_retry(self, slo):
        """A retry must withdraw a whole token from its class budget or
        be rejected on the spot — the valve that keeps a client herd's
        re-submissions from re-saturating a recovering fleet."""
        if self.retry_budget.try_consume(slo.name):
            return
        _registry.counter(
            "brownout.retry_denied",
            labels={"slo_class": slo.name, **self.labels},
            help="retries rejected because the class retry budget was "
                 "exhausted").inc()
        raise Overloaded(
            f"retry budget exhausted for class {slo.name!r}; retry after "
            f"{self.retry_after_s():.2f}s",
            retry_after_s=self.retry_after_s(), level=self._level,
            step="retry_budget", slo_class=slo.name, tenant=self.tenant)

    def on_accepted(self, slo):
        self.retry_budget.on_accepted(slo.name)

    # ---- report ------------------------------------------------------------
    def report(self):
        with self._lock:
            return {
                "level": self._level,
                "tenant": self.tenant,
                "step": self.step_name(),
                "pressure": round(self.pressure, 4),
                "steps": [{"name": s.name, "engage_at": s.engage_at,
                           "release_at": s.release_at}
                          for s in self.steps],
                "retry_after_s": round(self.retry_after_s(), 4),
                "history": [(round(t, 3), kind, name)
                            for t, kind, name in self.history[-16:]],
            }
