"""Self-healing replica lifecycle (the port's own copy of
``paddle_tpu/serving/supervisor.py``).

Everything below the supervisor exists already: the router marks replicas
DEAD off damped heartbeats, the breaker trips sick replicas into
PROBATION, ``drain()`` empties a replica without losing a request, the
fleet rollup distills burn rate and occupancy into one
``pressure``/``scale_hint`` signal, and the elastic fencing contract
(``distributed.fleet.elastic.fencing``) defines how a superseded
incarnation is kept from writing. The supervisor is the actor that closes
both loops:

**Replacement.** A DEAD replica's failure domain gets a replacement
(``engine_factory()`` -> :meth:`ServingFrontend.add_replica`) under a
per-domain restart budget with bounded exponential backoff. The budget
counts restart *intensity*, not a lifetime total: only budget-many
attempts within ``budget_window_s`` exhaust a domain, so deaths separated
by a healthy window are independent incidents. A domain that keeps dying
inside the window stops consuming spawns (``supervisor.budget_exhausted``)
instead of crash-looping. Each incarnation carries a
:class:`ReplicaFence`: the supervisor revokes the dead incarnation's
fence before the replacement exists (per incarnation: healthy siblings
sharing the failure domain keep writing), so its late heartbeat-file and
fleet-snapshot writes raise ``StaleGenerationError`` and are dropped
(``supervisor.fenced_writes``): a zombie dispatcher cannot masquerade as
its own replacement.

**Scaling.** The rollup's ``scale_hint`` drives grow and shrink with
hysteresis: grow only after the hint has held for ``grow_hold_s``, shrink
only after ``shrink_cooldown_s`` of sustained quiet, and always through
``drain()`` so no request is lost; a drain that cannot finish within its
timeout aborts the shrink and revives the replica. The actions are fenced
at the process level too: a supervisor whose elastic incarnation was
superseded (``process_fence``) stops acting for good instead of fighting
its successor.

The control loop is event-driven (``Event.wait`` on the supervisor
cadence, woken early by ``poke()``). **Default-off**:
:meth:`ReplicaSupervisor.from_env` returns None unless
``PADDLE_SUPERVISOR`` is truthy, so an unconfigured frontend gains no
thread. The chaos seams ``supervisor.decision`` (every tick) and
``serving.spawn_fail`` (every spawn) make the recovery paths drivable
from tests.
"""
import threading
import time
from collections import deque

from ..distributed.fleet.elastic.fencing import (
    StaleGenerationError,
    process_fence,
)
from ..observability.metrics import registry as _registry
from ..testing import chaos
from ..utils.envs import env_bool, env_float, env_int
from .router import DEAD, LIVE

__all__ = ["ReplicaFence", "ReplicaSupervisor"]

_M_TICKS = _registry.counter(
    "supervisor.ticks", help="supervisor control-loop decision passes")
_M_RESPAWNS = _registry.counter(
    "supervisor.respawns",
    help="dead replicas replaced with a freshly spawned incarnation")
_M_SPAWN_FAILURES = _registry.counter(
    "supervisor.spawn_failures",
    help="replacement/scale-up spawns that failed (retried under backoff)")
_M_BUDGET_EXHAUSTED = _registry.counter(
    "supervisor.budget_exhausted",
    help="failure domains whose restart budget ran out (left dead)")
_M_SCALE_UPS = _registry.counter(
    "supervisor.scale_ups", help="replicas added on a sustained grow hint")
_M_SCALE_DOWNS = _registry.counter(
    "supervisor.scale_downs",
    help="replicas drained and removed on a sustained shrink hint")
_M_GENERATION = _registry.gauge(
    "supervisor.generation",
    help="newest replica incarnation generation across failure domains")


class ReplicaFence:
    """The elastic fence's ``check()`` contract applied to replica
    incarnations: one
    (domain, generation) identity captured at spawn, revoked by the
    supervisor the moment THIS incarnation is superseded (replacement) or
    retired (scale-down). Revocation is per-incarnation — a failure
    domain may hold several healthy replicas, and replacing one must not
    fence its siblings' telemetry — and it happens BEFORE the replacement
    exists, so a superseded incarnation's ``check()`` raises
    :class:`StaleGenerationError` from that moment on.
    ReplicaHandle.fence_writable() turns that into dropped heartbeat/
    snapshot writes (``supervisor.fenced_writes``)."""

    __slots__ = ("_supervisor", "domain", "generation", "revoked")

    def __init__(self, supervisor, domain, generation):
        self._supervisor = supervisor
        self.domain = str(domain)
        self.generation = int(generation)
        self.revoked = False

    def revoke(self):
        # single writer (the supervisor loop), monotonic False->True; a
        # racing reader at worst sees one last pre-revocation write
        self.revoked = True

    def check(self, op="write"):
        if self.revoked:
            newest = self._supervisor.domain_generation(self.domain)
            raise StaleGenerationError(
                f"{op}: replica incarnation generation {self.generation} of "
                f"failure domain {self.domain!r} was superseded (domain is "
                f"at generation {newest}) — a replaced replica must not "
                f"publish telemetry its replacement's aggregator would "
                f"trust")
        return True

    def __repr__(self):
        return (f"ReplicaFence({self.domain!r}, gen={self.generation}"
                f"{', REVOKED' if self.revoked else ''})")


class _Domain:
    """Per-failure-domain restart bookkeeping: spawn attempts against the
    budget, the bounded-backoff schedule, and the incarnation generation
    the fences compare against."""

    __slots__ = ("name", "generation", "attempts", "next_attempt_t",
                 "window_start_t", "exhausted")

    def __init__(self, name):
        self.name = str(name)
        self.generation = 0
        self.attempts = 0
        self.next_attempt_t = 0.0
        self.window_start_t = 0.0   # first attempt of the current window
        self.exhausted = False


class ReplicaSupervisor:
    """Closed-loop replica lifecycle over one :class:`ServingFrontend`.

    ``engine_factory`` is the spawn recipe: a zero-arg callable returning
    a fresh engine replica (model and pools loaded; build it warm, the
    dispatcher's warmup hook covers first dispatches). Construct directly in
    tests (``start=False`` + ``tick()`` for deterministic single steps) or
    via :meth:`from_env` in production wiring — the default-off env gate.

    Every knob falls back to a ``PADDLE_SUPERVISOR_*`` variable;
    the injectable ``clock`` makes backoff/hysteresis unit-testable
    without wall-clock waits.
    """

    def __init__(self, frontend, engine_factory, min_replicas=None,
                 max_replicas=None, restart_budget=None,
                 budget_window_s=None, backoff_base_s=None,
                 backoff_max_s=None, grow_hold_s=None,
                 shrink_cooldown_s=None, interval_s=None,
                 drain_timeout_s=30.0, clock=time.monotonic, start=False,
                 min_replicas_by_role=None):
        if not callable(engine_factory):
            raise ValueError("engine_factory must be a zero-arg callable "
                             "returning a fresh engine replica")
        self.frontend = frontend
        self.engine_factory = engine_factory
        n0 = len(frontend.replicas)
        self.min_replicas = (env_int("PADDLE_SUPERVISOR_MIN_REPLICAS", 1)
                             if min_replicas is None else int(min_replicas))
        self.max_replicas = (env_int("PADDLE_SUPERVISOR_MAX_REPLICAS",
                                     max(2 * n0, 2))
                             if max_replicas is None else int(max_replicas))
        if not 1 <= self.min_replicas <= self.max_replicas:
            raise ValueError(
                f"need 1 <= min_replicas <= max_replicas, got "
                f"{self.min_replicas}..{self.max_replicas}")
        self.restart_budget = (env_int("PADDLE_SUPERVISOR_RESTART_BUDGET", 3)
                               if restart_budget is None
                               else int(restart_budget))
        self.budget_window_s = (
            env_float("PADDLE_SUPERVISOR_BUDGET_WINDOW_S", 300.0)
            if budget_window_s is None else float(budget_window_s))
        self.backoff_base_s = (env_float("PADDLE_SUPERVISOR_BACKOFF_S", 0.5)
                               if backoff_base_s is None
                               else float(backoff_base_s))
        self.backoff_max_s = (env_float("PADDLE_SUPERVISOR_BACKOFF_MAX_S",
                                        15.0)
                              if backoff_max_s is None
                              else float(backoff_max_s))
        self.grow_hold_s = (env_float("PADDLE_SUPERVISOR_GROW_HOLD_S", 3.0)
                            if grow_hold_s is None else float(grow_hold_s))
        self.shrink_cooldown_s = (
            env_float("PADDLE_SUPERVISOR_SHRINK_COOLDOWN_S", 10.0)
            if shrink_cooldown_s is None else float(shrink_cooldown_s))
        self.interval_s = (env_float("PADDLE_SUPERVISOR_INTERVAL_S", 0.25)
                           if interval_s is None else float(interval_s))
        self.drain_timeout_s = float(drain_timeout_s)
        # per-role floors: a disaggregated fleet's shrink path
        # must respect each POOL's floor, not just the fleet total — a
        # sustained lull on decode must never drain the last prefill
        # replica (or vice versa). Unlisted roles fall back to the global
        # min_replicas. env: PADDLE_SUPERVISOR_MIN_REPLICAS_<ROLE>
        self.min_replicas_by_role = dict(min_replicas_by_role or {})
        env_floors = {
            "prefill": env_int("PADDLE_SUPERVISOR_MIN_REPLICAS_PREFILL", 0),
            "decode": env_int("PADDLE_SUPERVISOR_MIN_REPLICAS_DECODE", 0),
            "blended": env_int("PADDLE_SUPERVISOR_MIN_REPLICAS_BLENDED", 0),
        }
        for role, v in env_floors.items():
            if v and role not in self.min_replicas_by_role:
                self.min_replicas_by_role[role] = v
        self._clock = clock
        self._lock = threading.Lock()
        self._domains = {}
        # hold/cooldown state PER (role, hint) — a prefill pool's grow
        # pressure must not be masked (or reset) by the decode pool's
        self._hint_since = {}
        self._scale_seq = 0
        self._events = deque(maxlen=64)
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._thread = None
        self.superseded = False
        # adopt the existing fleet: every replica joins a failure domain
        # and gets fenced at the current (zero) generation, so the very
        # first replacement already rejects its predecessor's late writes
        for rep in frontend.replicas:
            dom = self._domain(rep.domain or rep.name)
            rep.domain = dom.name
            if rep.fence is None:
                rep.fence = ReplicaFence(self, dom.name, dom.generation)
        frontend.supervisor = self
        if start:
            self.start()

    @classmethod
    def from_env(cls, frontend, engine_factory, **kw):
        """The default-off gate (a disabled supervisor adds no thread):
        returns a started supervisor only
        when ``PADDLE_SUPERVISOR`` is truthy, else None — no object, no
        fences, no thread, nothing to pay for."""
        if not env_bool("PADDLE_SUPERVISOR"):
            return None
        return cls(frontend, engine_factory, start=True, **kw)

    # ---- lifecycle ---------------------------------------------------------
    def start(self):
        if self._thread is not None:
            return self
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="paddle-serving-supervisor")
        self._thread.start()
        return self

    def stop(self, timeout=None):
        """Stop the control loop. Joins with ``timeout`` (default: long
        enough for one in-flight drain to conclude)."""
        self._stop.set()
        self._wake.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=self.drain_timeout_s + 5.0
                   if timeout is None else timeout)

    def poke(self):
        """Wake the control loop now (a death just observed, a test
        stepping the clock) instead of waiting out the cadence."""
        self._wake.set()

    def _run(self):
        while not self._stop.is_set():
            try:
                self.tick()
            except StaleGenerationError:
                # this whole incarnation was superseded (elastic re-form):
                # the successor owns the fleet now — acting would be a
                # split-brain spawn storm. Permanent, deliberate stop.
                self.superseded = True
                self._log("superseded", "")
                return
            except Exception as e:
                # a failed decision pass (chaos fault, transient rollup
                # error) must not kill the loop that exists to survive
                # failures — count it and keep going
                _registry.counter(
                    "supervisor.decision_errors",
                    help="decision passes aborted by an exception "
                         "(loop survives)").inc()
                self._log("decision_error", f"{type(e).__name__}: {e}")
            self._wake.wait(self.interval_s)
            self._wake.clear()

    # ---- the decision pass -------------------------------------------------
    def tick(self, now=None):
        """One decision pass: fence check, replace the dead, autoscale.
        Callable directly (tests, ops) — the thread is just this on a
        cadence."""
        now = self._clock() if now is None else now
        _M_TICKS.inc()
        chaos.site("supervisor.decision")
        f = process_fence()
        if f is not False:
            f.check("supervisor.tick")  # raises when superseded
        self._replace_dead(now)
        self._autoscale(now)

    def _domain(self, name):
        with self._lock:
            d = self._domains.get(name)
            if d is None:
                d = self._domains[name] = _Domain(name)
            return d

    def domain_generation(self, domain):
        """Newest incarnation generation for ``domain`` (the fences'
        comparison point)."""
        d = self._domains.get(domain)
        return d.generation if d is not None else 0

    def _bump_generation(self, domain):
        with self._lock:
            domain.generation += 1
            _M_GENERATION.set(max(d.generation
                                  for d in self._domains.values()))

    def _log(self, kind, detail):
        self._events.append((round(self._clock(), 3), kind, detail))

    def _replace_dead(self, now):
        for rep in list(self.frontend.replicas):
            if rep.state != DEAD:
                continue
            if rep.retired:
                # a scale-down victim that died mid-drain: its work was
                # already relocated and we wanted it gone — just clean up
                self.frontend.remove_replica(rep)
                self._log("retired_dead_removed", rep.name)
                continue
            domain = self._domain(rep.domain or rep.name)
            if domain.exhausted:
                continue
            if now < domain.next_attempt_t:
                continue  # backing off a recent spawn failure
            if domain.attempts and self.budget_window_s > 0 \
                    and now - domain.window_start_t >= self.budget_window_s:
                # restart INTENSITY, not a lifetime count: deaths separated
                # by a healthy window are independent incidents, not a
                # crash loop — only budget-many attempts WITHIN the window
                # exhaust the domain
                domain.attempts = 0
            if domain.attempts >= self.restart_budget:
                domain.exhausted = True
                _M_BUDGET_EXHAUSTED.inc()
                self._log("budget_exhausted", domain.name)
                continue
            if domain.attempts == 0:
                domain.window_start_t = now
            domain.attempts += 1
            # fence FIRST: from here the dead incarnation (and any zombie
            # dispatcher still wedged in a device call under its name)
            # cannot publish telemetry the replacement's view would trust.
            # Revocation is per-incarnation — healthy siblings sharing the
            # failure domain keep writing
            if rep.fence is not None:
                rep.fence.revoke()
            self._bump_generation(domain)
            # the replacement inherits the dead incarnation's pool role —
            # a prefill replica's successor serves prefill
            new = self._spawn(domain, role=rep.role)
            if new is None:
                backoff = min(self.backoff_max_s,
                              self.backoff_base_s
                              * (2 ** (domain.attempts - 1)))
                domain.next_attempt_t = now + backoff
                continue
            _M_RESPAWNS.inc()
            self._log("respawn", f"{rep.name} -> {new.name}")
            self.frontend.remove_replica(rep)

    def _spawn(self, domain, role="blended"):
        """One engine spawn + pool join for ``domain``'s current
        generation. Returns the new ReplicaHandle, or None on failure
        (counted; the caller schedules the backoff). ``role`` is offered
        to the factory (disaggregated pools may build prefill and decode
        replicas differently) and falls back to a zero-arg call for
        factories that predate roles."""
        try:
            # the chaos seam: a FaultPlan arming serving.spawn_fail makes
            # this spawn fail deterministically (budget/backoff drills)
            chaos.site("serving.spawn_fail")
            try:
                engine = self.engine_factory(role=role)
            except TypeError:
                engine = self.engine_factory()
            return self.frontend.add_replica(
                engine, name=f"{domain.name}-g{domain.generation}",
                domain=domain.name, role=role,
                fence=ReplicaFence(self, domain.name, domain.generation))
        except Exception as e:
            _M_SPAWN_FAILURES.inc()
            self._log("spawn_fail",
                      f"{domain.name}: {type(e).__name__}: {e}")
            return None

    def min_for(self, role):
        """Shrink floor for one role pool."""
        return self.min_replicas_by_role.get(role, self.min_replicas)

    def _autoscale(self, now):
        """Per-role autoscaling: each pool's pressure drives
        its own grow/shrink with its own hold/cooldown state, so a
        saturated prefill pool grows even while the decode pool idles —
        and a decode lull cannot mask a prefill grow hint (or vice
        versa). A rollup without a roles block (homogeneous fleet, stub
        signals) degrades to the single blended loop this method always
        was."""
        sig = self.frontend.fleet_signal()
        roles = sig.get("roles") or None
        if not roles:
            roles = {"blended": {"scale_hint": sig.get("scale_hint")}}
        for role in sorted(roles):
            self._autoscale_role(now, role, roles[role].get("scale_hint"))

    def _autoscale_role(self, now, role, hint):
        for h in ("grow", "shrink"):
            key = (role, h)
            if hint != h:
                self._hint_since[key] = None
            elif self._hint_since.get(key) is None:
                self._hint_since[key] = now
        live_all = [r for r in self.frontend.replicas if r.state == LIVE]
        live = [r for r in live_all if r.role == role]
        if hint == "grow" and len(live_all) < self.max_replicas:
            since = self._hint_since[(role, "grow")]
            if now - since < self.grow_hold_s:
                return  # hysteresis: pressure must SUSTAIN, not spike
            with self._lock:
                self._scale_seq += 1
                seq = self._scale_seq
            # role-tagged scale domain: a crash-looping prefill spawn
            # exhausts ITS domain's restart budget, never decode's
            domain = self._domain(f"scale-{role}{seq}")
            self._bump_generation(domain)
            new = self._spawn(domain, role=role)
            if new is not None:
                _M_SCALE_UPS.inc()
                self._log("scale_up", f"{new.name} ({role})")
            self._hint_since[(role, "grow")] = None  # re-arm either way
        elif hint == "shrink" and len(live) > self.min_for(role):
            since = self._hint_since[(role, "shrink")]
            if now - since < self.shrink_cooldown_s:
                return  # cooldown: a lull is not a trend
            victim = min(live, key=lambda r: r.load())
            if self._shrink(victim):
                self._hint_since[(role, "shrink")] = None

    def _shrink(self, rep):
        """Retire one replica, always via drain() — the no-lost-requests
        contract. A drain that cannot finish in time aborts the shrink
        (the replica revives; the cooldown re-arms)."""
        rep.retired = True
        if not self.frontend.drain(rep, timeout=self.drain_timeout_s):
            rep.retired = False
            self.frontend.revive(rep)
            self._log("shrink_aborted", f"{rep.name}: drain timed out")
            return False
        # fence the retired incarnation BEFORE removal: its dispatcher is
        # still alive in the wake-wait and must not keep publishing
        if rep.fence is not None:
            rep.fence.revoke()
        self.frontend.remove_replica(rep)
        _M_SCALE_DOWNS.inc()
        self._log("scale_down", rep.name)
        return True

    # ---- report ------------------------------------------------------------
    def report(self):
        """The ``serving_report()["supervisor"]`` / statusz block."""
        now = self._clock()
        with self._lock:
            domains = {
                d.name: {
                    "generation": d.generation,
                    "attempts": d.attempts,
                    "exhausted": d.exhausted,
                    "backoff_remaining_s": round(
                        max(0.0, d.next_attempt_t - now), 3),
                }
                for d in self._domains.values()
            }
        return {
            "running": self._thread is not None,
            "superseded": self.superseded,
            "min_replicas": self.min_replicas,
            "min_replicas_by_role": dict(self.min_replicas_by_role),
            "max_replicas": self.max_replicas,
            "restart_budget": self.restart_budget,
            "budget_window_s": self.budget_window_s,
            "interval_s": self.interval_s,
            "grow_hold_s": self.grow_hold_s,
            "shrink_cooldown_s": self.shrink_cooldown_s,
            "domains": domains,
            "events": list(self._events)[-16:],
        }
