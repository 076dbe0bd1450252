"""Port parity: the serving control plane's policy modules against the JAX
package's, on the CPU. Each module of ``paddle_tpu_torch`` here is the
port's own copy of the reference's (no JAX in either); the same scripted
inputs, on an injected clock where the module takes one, go through both
and the outputs must be equal (exactly: these are integer and float
bookkeeping with no rounding of their own):

- the scheduler's EDF order, virtual deadlines, expiry and the
  ``Overloaded`` fields of a queue-bound shed;
- the brownout ladder's engage/release steps with dwell hysteresis, its
  admission, token-cap, extras and prefill-depth verdicts, the retry
  budget, and its report;
- the circuit breaker's error and slow trips, probe rate limit, close and
  fail-hard verdicts;
- the tenant token bucket (admit, refill deficit in ``retry_after_s``),
  the inflight cap, the registry's bounds and refusals;
- the SLO monitor's burn rates and multi-window alerts;
- the goodput accountant's categories and split;
- ``FaultPlan``: which hits fire, the env spec round trip, the parser's
  refusals;
- the router's placement scores over stub replicas (prefix affinity,
  session hints, load, role targeting, half-open probes);
- the serving fleet rollup.
"""
import numpy as np
import pytest

from paddle_tpu.observability import fleet as ref_fleet
from paddle_tpu.observability import goodput as ref_goodput
from paddle_tpu.observability import slo as ref_slo
from paddle_tpu.serving import breaker as ref_breaker
from paddle_tpu.serving import brownout as ref_brownout
from paddle_tpu.serving import router as ref_router
from paddle_tpu.serving import scheduler as ref_scheduler
from paddle_tpu.serving import tenancy as ref_tenancy
from paddle_tpu.testing import chaos as ref_chaos
from paddle_tpu_torch.observability import fleet as port_fleet
from paddle_tpu_torch.observability import goodput as port_goodput
from paddle_tpu_torch.observability import slo as port_slo
from paddle_tpu_torch.serving import breaker as port_breaker
from paddle_tpu_torch.serving import brownout as port_brownout
from paddle_tpu_torch.serving import router as port_router
from paddle_tpu_torch.serving import scheduler as port_scheduler
from paddle_tpu_torch.serving import tenancy as port_tenancy
from paddle_tpu_torch.testing import chaos as port_chaos


class Clock:
    """A monotonic clock the test steps by hand."""

    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t


def _both(script, ref_mod, port_mod):
    """``script(module)`` on the reference and on the port: the two
    transcripts must be equal."""
    want = script(ref_mod)
    got = script(port_mod)
    assert got == want
    return got


def _exc(fn):
    """The outcome of ``fn()``: its value, or the raised error's type name,
    message and structured fields."""
    try:
        return ("ok", fn())
    except Exception as e:  # noqa: BLE001 - the transcript records it
        fields = {k: getattr(e, k) for k in ("retry_after_s", "level",
                                            "step", "slo_class", "tenant")
                  if hasattr(e, k)}
        return (type(e).__name__, str(e), fields)


# ---- scheduler ---------------------------------------------------------------
class _Entry:
    def __init__(self, t_enqueue, deadline_t, virtual_deadline):
        self.req = type("R", (), {"t_enqueue": t_enqueue})()
        self.deadline_t = deadline_t
        self.virtual_deadline = virtual_deadline


def _scheduler_script(mod):
    sched = mod.SLOScheduler(max_queue_depth=10, interactive_reserve=0.2)
    out = [sched.reserve_class, sorted(sched.classes)]
    inter, batch = sched.resolve("interactive"), sched.resolve("batch")
    out.append(_exc(lambda: sched.resolve("nope")))
    rng = np.random.RandomState(5)
    pending = []
    for i in range(12):
        t = 100.0 + 0.01 * i
        slo = inter if rng.rand() < 0.5 else batch
        dl = float(rng.choice([0.0, 0.02, 1.0])) or None
        vd = sched.virtual_deadline(t, slo, dl)
        pending.append(_Entry(t, t + dl if dl else None, vd))
        out.append(round(vd, 9))
    order = []
    while pending:
        i = sched.pick(pending, now=100.5)
        order.append(i)
        e = pending.pop(i)
        out.append(sched.expired(e, now=100.05))
    out.append(order)
    out.append(sched.pick([]))
    for depth in (0, 7, 8, 9, 10, 11):
        for slo in (inter, batch):
            out.append(_exc(lambda: sched.check_admission(depth, slo)))
    out.append(_exc(lambda: mod.SLOScheduler(max_queue_depth=0)))
    return out


def test_scheduler_edf_expiry_and_sheds_match():
    _both(_scheduler_script, ref_scheduler, port_scheduler)


# ---- brownout ----------------------------------------------------------------
def _brownout_script(mod):
    clock = Clock()
    ladder = mod.BrownoutLadder(dwell_s=2.0, clock=clock,
                                retry_budget=mod.RetryBudget(ratio=0.5,
                                                             burst=2.0))
    inter = ref_scheduler.INTERACTIVE
    batch = ref_scheduler.BATCH
    out = []
    pressures = [0.1, 0.75, 0.8, 0.85, 0.9, 0.95, 0.99, 1.0, 1.0, 0.5,
                 0.5, 0.2, 0.2, 0.2, 0.1, 0.1, 0.1, 0.0, 0.0, 0.0]
    for p in pressures:
        clock.t += 0.7
        out.append((ladder.observe(p), ladder.level, ladder.step_name()))
        out.append((ladder.extras_enabled(), ladder.peer_fetch_enabled(),
                    ladder.prefill_depth_cap(),
                    ladder.token_cap(batch, "interactive"),
                    ladder.token_cap(inter, "interactive"),
                    round(ladder.retry_after_s(), 9)))
        for slo in (inter, batch):
            out.append(_exc(lambda: ladder.check_admission(slo,
                                                           "interactive")))
            out.append(_exc(lambda: ladder.check_retry(slo)))
            ladder.on_accepted(slo)
    rep = ladder.report()
    out.append({k: v for k, v in rep.items() if k != "history"})
    out.append([(round(t - 1000.0, 6), what, step)
                for t, what, step in ladder.history])
    return out


def test_brownout_ladder_steps_hysteresis_and_retry_budget_match():
    _both(_brownout_script, ref_brownout, port_brownout)


# ---- breaker -----------------------------------------------------------------
def _breaker_script(mod):
    clock = Clock()
    br = mod.CircuitBreaker(
        mod.BreakerPolicy(window=8, error_threshold=0.5, min_samples=4,
                          slow_strikes=2, probe_interval_s=0.5,
                          probe_successes=2, probation_failures=2),
        clock=clock)
    out = []
    for ok in (True, False, True, False, False, False):
        out.append(br.record("r0", ok))
    out.append(br.tripped_reason("r0"))
    for _ in range(3):
        clock.t += 0.3
        out.append(br.allow_probe("r0"))
    out.append(br.probe_result("r0", True))
    clock.t += 1.0
    out.append(br.allow_probe("r0"))
    out.append(br.probe_result("r0", True))
    for name in ("r1", "r2"):
        out.append([br.note_slow(name) for _ in range(3)])
        out.append(br.note_on_pace(name))
    clock.t += 1.0
    out.append([br.probe_result("r1", False) for _ in range(2)])
    out.append(br.report())
    br.forget("r2")
    out.append(sorted(br.report()))
    return out


def test_breaker_trips_probes_and_verdicts_match():
    _both(_breaker_script, ref_breaker, port_breaker)


# ---- tenancy -----------------------------------------------------------------
def _tenancy_script(mod):
    clock = Clock()
    out = []
    t = mod.Tenant("parity-acme", slo_class="batch", quota_rps=2.0, burst=3.0,
                   max_inflight=2, adapters=("ad-1",), clock=clock)
    for dt in (0.0, 0.0, 0.0, 0.0, 0.1, 0.4, 0.0, 1.3, 0.0):
        clock.t += dt
        out.append(_exc(t.admit))
        out.append(round(t.tokens(), 9))
    out.append([_exc(t.acquire_slot) for _ in range(3)])
    t.release_slot()
    out.append((t.inflight, round(t.pressure(), 9)))
    out.append((t.allows_adapter("ad-1"), t.allows_adapter("other")))
    t.count_shed()
    t.count_admitted()
    rep = t.report()
    out.append({k: v for k, v in rep.items() if k != "brownout"})
    reg = mod.TenantRegistry([t], max_tenants=2)
    out.append((reg.names(), len(reg), "parity-acme" in reg,
                reg.resolve(None).name, reg.resolve("parity-acme") is t))
    out.append(_exc(lambda: reg.resolve("ghost")))
    out.append(_exc(lambda: reg.register(mod.Tenant("b", clock=clock))))
    out.append(_exc(lambda: reg.register(mod.Tenant("c", clock=clock))))
    out.append(_exc(lambda: mod.Tenant("bad name!", clock=clock)))
    out.append(_exc(lambda: mod.Tenant("x", burst=0.5, clock=clock)))
    out.append(sorted(reg.report()))
    return out


def test_tenant_bucket_inflight_and_registry_match():
    _both(_tenancy_script, ref_tenancy, port_tenancy)


# ---- SLO burn rates ----------------------------------------------------------
def _slo_script(mod):
    clock = Clock()
    mon = mod.SLOMonitor(classes=ref_scheduler.SLOScheduler()
                         .classes.values(), fast_window_s=60.0,
                         slow_window_s=600.0, clock=clock)
    out = []
    rng = np.random.RandomState(2)
    for i in range(200):
        clock.t += float(rng.uniform(0.5, 4.0))
        cls = "interactive" if i % 3 else "batch"
        mon.observe(cls, "ttft", float(rng.exponential(0.6)))
        mon.observe(cls, "tpot", float(rng.exponential(0.1)))
        mon.observe_event(cls, "deadline_miss", bool(rng.rand() < 0.03))
        if i % 25 == 0:
            out.append({k: {w: round(v, 9) for w, v in r.items()}
                        for k, r in mon.burn_rates().items()})
            out.append(mon.alerts())
    out.append(mon.report())
    return out


def test_slo_burn_rates_and_alerts_match():
    _both(_slo_script, ref_slo, port_slo)


# ---- goodput -----------------------------------------------------------------
def _goodput_script(mod):
    acct = mod.GoodputAccountant(goodput_categories=("prefill", "decode"))
    for cat, secs in (("prefill", 0.25), ("decode", 1.5), ("idle", 0.5),
                      ("compile", 2.0), ("host_emit", 0.125),
                      ("decode", 0.5)):
        acct.note(cat, secs)
    rep = acct.report()
    out = [acct.totals(), acct.goodput_categories,
           sorted(rep), mod.SERVING_CATEGORIES, mod.CATEGORIES,
           mod.serving.goodput_categories,
           # the split, with the wall clock factored out
           {k: round(v * rep["wall_s"], 9) for k, v in rep["fractions"]
            .items()},
           round(rep["goodput_fraction"] * rep["wall_s"], 9),
           sorted(rep["badput"])]
    acct.reset()
    out.append(acct.totals())
    return out


def test_goodput_split_matches():
    _both(_goodput_script, ref_goodput, port_goodput)


# ---- FaultPlan ---------------------------------------------------------------
def _chaos_script(mod):
    out = []
    plan = (mod.FaultPlan(seed=3)
            .fail("serve.decode", times=2, after=1)
            .delay("serving.replica_slow", 0.0, times=None)
            .fail("serving.kv.*", times=1)
            .fail("soak", times=None, p=0.4))
    with plan:
        for name in ("serve.decode", "serve.decode", "serve.decode",
                     "serve.decode", "serving.kv.fetch",
                     "serving.kv.corrupt", "serving.replica_slow",
                     "serve.prefill") + ("soak",) * 20:
            out.append(_exc(lambda: mod.site(name)))
        out.append(mod.active_plan() is plan)
    out.append(mod.active_plan())
    out.append([(r.site, r.kind, r.hits, r.fired) for r in plan.rules])
    out.append(plan.env_spec())
    out.append(mod.env_spec(plan))
    parsed = mod.parse_env_spec(
        "serve.decode:exc:after=1:times=2,trainer.step:exit=17:after=3,"
        "x.y:sleep=0.5:times=inf:p=0.25", seed=7)
    out.append([(r.site, r.kind, r.arg, r.after, r.times, r.p)
                for r in parsed.rules])
    out.append(parsed.env_spec())
    out.append(_exc(lambda: mod.parse_env_spec("a:bogus=1")))
    out.append(_exc(lambda: mod.FaultRule("a", kind="melt")))
    return out


def test_fault_plan_fires_and_specs_match():
    _both(_chaos_script, ref_chaos, port_chaos)


# ---- router ------------------------------------------------------------------
class _StubEngine:
    """What the router reads of an engine: pages, slots, the prefix index
    and the device adapter cache."""

    def __init__(self, active, pages, prefix_pages, adapters=()):
        self.page_size = 16
        self.max_seqs = 4
        self.num_pages = 33
        self._active = active
        self._pages = pages
        self._prefix = prefix_pages
        self._lora_device = {d: None for d in adapters}

    def active_count(self):
        return self._active

    def pages_in_use(self):
        return self._pages

    def prefix_match_pages(self, prompt):
        return self._prefix


class _Req:
    def __init__(self, prompt, adapter=None):
        self.prompt = prompt
        self.rid = 0
        self.adapter = adapter


class _RouteEntry:
    def __init__(self, prompt, role=None, adapter=None):
        self.req = _Req(prompt, adapter)
        self.target_role = role


def _router_script(mod):
    rng = np.random.RandomState(9)
    prompts = [rng.randint(1, 100, n).astype(np.int32) for n in (40, 70, 9)]
    ad = type("Ad", (), {"digest": b"d1"})()
    reps = [mod.ReplicaHandle("r0", _StubEngine(1, 4, 2)),
            mod.ReplicaHandle("r1", _StubEngine(3, 20, 0, adapters=[b"d1"]),
                              index=1),
            mod.ReplicaHandle("r2", _StubEngine(0, 0, 0), index=2,
                              role="decode")]
    out = [[(round(r.load(), 9), round(r.pool_headroom(), 9),
             round(r.prefix_fraction(prompts[0]), 9)) for r in reps]]
    for policy in ("prefix", "load", "round_robin"):
        router = mod.Router(policy=policy)
        for p in prompts * 2:
            for role, adapter in ((None, None), ("decode", None),
                                  ("prefill", None), (None, ad)):
                e = _RouteEntry(p, role, adapter)
                rep = router.place(e, reps, exclude={"r0"} if role
                                   == "prefill" else ())
                out.append((rep.name, e.route_affinity,
                            round(e.route_score, 9), e.probe,
                            e.kv_hint_deferred
                            if hasattr(e, "kv_hint_deferred") else None))
                router.committed(e, rep)
        out.append(sorted(router._hints.values()))
        router.forget_replica("r1")
        out.append(sorted(router._hints.values()))
    # half-open probes through the breaker, then nothing LIVE
    reps[1].state = mod.PROBATION
    router = mod.Router()
    router.breaker = type("B", (), {"allow_probe": lambda self, n: True})()
    e = _RouteEntry(prompts[0])
    out.append((router.place(e, reps).name, e.probe))
    for r in reps:
        r.state = mod.DEAD
    out.append(_exc(lambda: router.place(_RouteEntry(prompts[1]), reps)))
    out.append(_exc(lambda: mod.Router(policy="nope")))
    out.append([sorted(r.snapshot()) for r in reps])
    return out


def test_router_placement_scores_match():
    _both(_router_script, ref_router, port_router)


# ---- fleet rollup ------------------------------------------------------------
def _rollup_script(mod):
    snaps = {
        "replica0": {"state": "LIVE", "role": "prefill", "active": 3,
                     "max_seqs": 4, "pending": 5, "kv_resident": 2},
        "replica1": {"state": "LIVE", "role": "decode", "active": 1,
                     "max_seqs": 4, "pending": 0, "kv_resident": 0},
        "replica2": {"state": "DEAD", "role": "decode", "active": 0,
                     "max_seqs": 4, "pending": 0},
    }
    slo = {"objectives": {"a": {"fast": 20.0, "slow": 15.0},
                          "b": {"fast": 0.5, "slow": 3.0}},
           "alerts": [{"objective": "a"}]}
    good = {"fractions": {"decode": 0.41234, "idle": 0.2}}
    out = [mod.serving_rollup(snaps, slo, good)]
    out.append(mod.serving_rollup({k: v for k, v in snaps.items()
                                   if k != "replica0"},
                                  {"objectives": {}, "alerts": []}, {}))
    return out


def test_serving_rollup_matches():
    _both(_rollup_script, ref_fleet, port_fleet)
