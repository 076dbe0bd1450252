"""Deterministic fault injection for the serving stack's fragile seams (the
port's own copy of ``paddle_tpu/testing/chaos.py``).

Recovery paths (a failed prefill retiring one slot, a decode dispatch's
bounded retry, a replica dying mid-flight and its requests rerouting, a
torn handoff bundle refused) stay honest only if a test can make the
underlying operation fail on demand, deterministically, mid-flight. This
module is that switch.

1. **No cost when disarmed.** Every instrumented seam calls
   ``chaos.site("name")``: with no plan armed that is one module-attribute
   load and a ``None`` check.
2. **Deterministic.** A ``FaultRule`` fires on exact hit counts (``after``
   / ``times``), or from a seeded ``random.Random`` for soak runs.
3. **Across processes.** A child inherits the plan through the
   ``PADDLE_CHAOS`` variable (a compact spec, parsed once at the first
   site hit).

Instrumented sites of the port:

========================  ===================================================
site                      seam
========================  ===================================================
serve.prefill             inference/continuous.py per-request prefill (the
                          legacy plane's monolithic prefill and each chunk)
                          and each adoption's page insert
serve.decode              inference/continuous.py per decode or mixed
                          dispatch, inside the bounded retry
serving.replica_kill      serving/frontend.py dispatcher loop: firing kills
                          the replica mid-flight
serving.replica_slow      serving/frontend.py before a busy replica's step
                          (a ``sleep`` rule drills the breaker's verdict)
serving.handoff.send      serving/handoff.py per publish attempt
serving.handoff.adopt     serving/handoff.py per adopt attempt
serving.handoff.corrupt   serving/handoff.py between fsync and rename of a
                          bundle: a ``truncate`` rule commits a torn file
serving.decode_pool_empty serving/frontend.py decode-pool liveness check
serving.kv.fetch          serving/kvfabric.py per peer-fetch attempt
serving.kv.timeout        serving/transport.py between RPC send and receive
serving.kv.partition      serving/transport.py per RPC attempt
serving.kv.corrupt        serving/transport.py after RPC receive
obs.oom                   continuous._locked_dispatch: a synthetic
                          out-of-memory error, recognized by
                          ``observability.compilemem.is_oom``
========================  ===================================================

Fault kinds: ``exc`` (raise; default :class:`FaultInjected`, a
``ConnectionError`` so retry filters catch it), ``exit`` (``os._exit``),
``truncate`` (chop the file the site reports) and ``sleep`` (latency).

Env spec (one rule per comma-separated field)::

    PADDLE_CHAOS="serve.decode:exc:after=1:times=2,serving.replica_kill:exc"

i.e. ``site:kind[=arg][:after=N][:times=N][:p=F]``. ``PADDLE_CHAOS_SEED``
seeds the probabilistic rules.
"""
import os
import random
import threading
import time

__all__ = ["FaultInjected", "FaultRule", "FaultPlan", "site", "arm",
           "disarm", "active_plan", "env_spec"]


class FaultInjected(ConnectionError):
    """Raised by ``exc`` rules. Subclasses ConnectionError so the transport
    retry filters (store/PS/RPC) treat it exactly like a real network fault —
    the injection exercises the same except clauses production errors hit."""

    def __init__(self, site_name, hit):
        super().__init__(f"chaos: injected fault at {site_name!r} (hit {hit})")
        self.site = site_name
        self.hit = hit


class FaultRule:
    """One fault at one site (or a ``*`` suffix glob over sites).

    after:  skip the first `after` matching hits (0 = fire on the first).
    times:  fire at most `times` times (None = every matching hit).
    p:      instead of exact counting, fire with probability p per hit from
            the plan's seeded RNG (after/times still bound the window).
    kind:   "exc" | "exit" | "truncate" | "sleep".
    arg:    exc: exception instance/factory; exit: status code;
            truncate: bytes to keep (tail is dropped); sleep: seconds.
    """

    def __init__(self, site, kind="exc", arg=None, after=0, times=1, p=None):
        if kind not in ("exc", "exit", "truncate", "sleep"):
            raise ValueError(f"unknown fault kind {kind!r}")
        self.site = site
        self.kind = kind
        self.arg = arg
        self.after = int(after)
        self.times = None if times is None else int(times)
        self.p = None if p is None else float(p)
        self.hits = 0      # matching site hits seen
        self.fired = 0     # faults actually injected

    def matches(self, name):
        if self.site.endswith("*"):
            return name.startswith(self.site[:-1])
        return name == self.site

    def _should_fire(self, rng):
        self.hits += 1
        if self.hits <= self.after:
            return False
        if self.times is not None and self.fired >= self.times:
            return False
        if self.p is not None and rng.random() >= self.p:
            return False
        return True

    def spec(self):
        """Round-trippable env-spec fragment (see parse_env_spec). An exc
        rule's custom exception object cannot cross the env boundary — it
        serializes as the bare kind (the child raises FaultInjected)."""
        parts = [self.site]
        if self.kind == "exc":
            parts.append("exc")
        else:
            arg = "" if self.arg is None else f"={self.arg}"
            parts.append(f"{self.kind}{arg}")
        if self.after:
            parts.append(f"after={self.after}")
        if self.times != 1:
            parts.append(f"times={'inf' if self.times is None else self.times}")
        if self.p is not None:
            parts.append(f"p={self.p}")
        return ":".join(parts)


class FaultPlan:
    """A set of FaultRules + the seeded RNG; armed globally via `arm()` or
    as a context manager. Thread-safe: concurrent sites (PS worker pools,
    dataloader readers) count hits under one lock."""

    def __init__(self, seed=0):
        self.rules = []
        self.seed = int(seed)
        self._rng = random.Random(self.seed)
        self._lock = threading.Lock()

    # -- construction sugar -------------------------------------------------
    def fail(self, site, times=1, after=0, exc=None, p=None):
        self.rules.append(FaultRule(site, "exc", exc, after, times, p))
        return self

    def exit(self, site, code=1, after=0, times=1):
        self.rules.append(FaultRule(site, "exit", int(code), after, times))
        return self

    def truncate(self, site, keep_bytes=0, after=0, times=1):
        self.rules.append(FaultRule(site, "truncate", int(keep_bytes), after, times))
        return self

    def delay(self, site, seconds, after=0, times=1, p=None):
        self.rules.append(FaultRule(site, "sleep", float(seconds), after, times, p))
        return self

    # -- runtime ------------------------------------------------------------
    def on_site(self, name, path=None):
        for rule in self.rules:
            if not rule.matches(name):
                continue
            with self._lock:
                fire = rule._should_fire(self._rng)
                if fire:
                    rule.fired += 1
            if not fire:
                continue
            _count(f"fault.injected.{name}")
            if rule.kind == "sleep":
                time.sleep(rule.arg)
            elif rule.kind == "truncate":
                if path is not None and os.path.exists(path):
                    with open(path, "rb+") as f:
                        f.truncate(rule.arg)
            elif rule.kind == "exit":
                os._exit(rule.arg if rule.arg is not None else 1)
            else:
                exc = rule.arg
                if exc is None:
                    raise FaultInjected(name, rule.hits)
                raise exc() if callable(exc) else exc

    def env_spec(self):
        """Serialize for child processes: exc args beyond the default cannot
        cross the env boundary — rules carrying exception objects serialize
        as the default FaultInjected."""
        return ",".join(r.spec() for r in self.rules)

    def __enter__(self):
        arm(self)
        return self

    def __exit__(self, *exc_info):
        disarm()
        return False


# -- global switch ----------------------------------------------------------
# _PLAN is THE hot-path gate: `site()` bails on `_PLAN is None` before doing
# anything else. Arming parses PADDLE_CHAOS lazily exactly once per process.
_PLAN = None
_ENV_PARSED = False


def _count(name):
    try:
        from ..utils.metrics_bus import counters

        counters.bump(name)
    except Exception:
        pass


def parse_env_spec(spec, seed=0):
    """'site:kind[=arg][:after=N][:times=N|inf][:p=F],...' -> FaultPlan"""
    plan = FaultPlan(seed=seed)
    for field in spec.split(","):
        field = field.strip()
        if not field:
            continue
        parts = field.split(":")
        site_name, opts = parts[0], parts[1:]
        kind, arg, kw = "exc", None, {}
        for o in opts:
            k, _, v = o.partition("=")
            if k in ("exc", "exit", "truncate", "sleep"):
                kind = k
                if v:
                    arg = float(v) if k == "sleep" else int(v)
            elif k in ("after", "times"):
                kw[k] = None if v == "inf" else int(v)
            elif k == "p":
                kw["p"] = float(v)
            else:
                raise ValueError(f"bad chaos option {o!r} in {field!r}")
        plan.rules.append(FaultRule(site_name, kind, arg, **kw))
    return plan


def arm(plan):
    global _PLAN
    _PLAN = plan
    return plan


def disarm():
    global _PLAN, _ENV_PARSED
    _PLAN = None
    _ENV_PARSED = True  # an explicit disarm also suppresses the env plan


def active_plan():
    return _PLAN


def env_spec(plan):
    """Env dict to arm `plan` in a child process."""
    return {"PADDLE_CHAOS": plan.env_spec(),
            "PADDLE_CHAOS_SEED": str(plan.seed)}


def site(name, path=None):
    """The instrumentation hook. Disabled cost: one global load + is-None
    check + an env-var membership probe on the first call only."""
    global _ENV_PARSED
    if _PLAN is None:
        if _ENV_PARSED:
            return
        _ENV_PARSED = True
        from ..utils.envs import env_int, env_str

        spec = env_str("PADDLE_CHAOS")
        if not spec:
            return
        arm(parse_env_spec(spec, seed=env_int("PADDLE_CHAOS_SEED", 0)))
    _PLAN.on_site(name, path=path)
