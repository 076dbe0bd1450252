"""Port parity: the replica supervisor and the generation fences against
the JAX package's, on the CPU.

- ``GenerationFence`` verdicts (a newer generation in the store refuses, an
  unreadable store fails open, no generation variable means no fence),
  ``membership``'s readers and ``scaled_per_rank_batch``, and
  ``ReplicaFence`` (a revoked incarnation refuses, a sibling of its domain
  does not);
- ``ReplicaSupervisor.tick`` decisions over a stub frontend (no threads,
  an injected clock), the same script through both packages' supervisors,
  transcripts equal: the backoff schedule of failing spawns, the budget
  exhausted within a window and reset across windows, grow and shrink
  hysteresis, a drain that times out and revives, and the fence revoked
  before the replacement is spawned; the ``serving.spawn_fail`` and
  ``supervisor.decision`` chaos seams;
- the port's ``ServingFrontend(engine_factory=...)``: default off without
  ``PADDLE_SUPERVISOR``, attached and stopped with it;
- one end to end run: two ``llama_tiny`` CPU engines of the port behind a
  supervised frontend, replica0 killed under load: every request
  completes with the JAX package's single-engine tokens over the same
  weights (``load_paddle_tpu_state``), no error, ``replica0-g1`` replaces
  it and serves a second load, the dead incarnation's late heartbeat is
  refused.
"""
import json
import os
import threading
import time

import numpy as np
import pytest

import paddle_tpu as paddle
from paddle_tpu.distributed.fleet.elastic import fencing as ref_fencing
from paddle_tpu.distributed.fleet.elastic import membership as ref_membership
from paddle_tpu.inference.continuous import (
    ContinuousBatchingEngine as JaxEngine,
)
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.models.llama import llama_tiny as jax_tiny
from paddle_tpu.observability.metrics import registry as ref_registry
from paddle_tpu.serving import supervisor as ref_supervisor
from paddle_tpu.testing import chaos as ref_chaos
from paddle_tpu_torch.distributed.fleet.elastic import (
    fencing as port_fencing,
)
from paddle_tpu_torch.distributed.fleet.elastic import (
    membership as port_membership,
)
from paddle_tpu_torch.inference.continuous import ContinuousBatchingEngine
from paddle_tpu_torch.models.convert import load_paddle_tpu_state
from paddle_tpu_torch.models.llama import LlamaForCausalLM, llama_tiny
from paddle_tpu_torch.observability.metrics import registry as port_registry
from paddle_tpu_torch.serving import Overloaded, ServingFrontend
from paddle_tpu_torch.serving import supervisor as port_supervisor
from paddle_tpu_torch.testing import chaos as port_chaos

PACKAGES = {"ref": (ref_supervisor, ref_registry, ref_chaos,
                    ref_fencing),
            "port": (port_supervisor, port_registry, port_chaos,
                     port_fencing)}
SUP_COUNTERS = ("supervisor.respawns", "supervisor.spawn_failures",
                "supervisor.budget_exhausted", "supervisor.scale_ups",
                "supervisor.scale_downs", "supervisor.fenced_writes")


class Clock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t


def _val(reg, name):
    return int(getattr(reg.get(name), "value", 0) or 0)


# ---------------------------------------------------------------------------
# fences and membership
# ---------------------------------------------------------------------------
class _Store:
    def __init__(self, value=None, broken=False):
        self.value, self.broken = value, broken

    def check(self, key):
        if self.broken:
            raise ConnectionError("store down")
        return self.value is not None

    def get(self, key):
        return self.value


@pytest.mark.parametrize("store", [None, _Store(), _Store(b"3"), _Store("2"),
                                   _Store(b"9"), _Store(broken=True)],
                         ids=["none", "empty", "newer", "same", "much_newer",
                              "broken"])
def test_generation_fence_verdicts(store):
    verdicts = []
    for name in ("ref", "port"):
        fencing = PACKAGES[name][3]
        f = fencing.GenerationFence(store=store, generation=2)
        try:
            verdicts.append((f.newest_generation(), f.check("w")))
        except fencing.StaleGenerationError as e:
            verdicts.append((f.newest_generation(), str(e)))
    assert verdicts[0] == verdicts[1]


def test_process_fence_and_membership_follow_the_environment(monkeypatch):
    for var in ("PADDLE_ELASTIC_GENERATION", "PADDLE_TRAINER_ID",
                "PADDLE_TRAINERS_NUM", "PADDLE_ELASTIC_RANKS",
                "PADDLE_ELASTIC_ORIG_WORLD"):
        monkeypatch.delenv(var, raising=False)
    port_fencing._reset()
    assert port_fencing.process_fence() is False
    port_fencing.assert_writable()                    # free, no fence
    monkeypatch.setenv("PADDLE_ELASTIC_GENERATION", "4")
    monkeypatch.setenv("PADDLE_TRAINER_ID", "1")
    monkeypatch.setenv("PADDLE_TRAINERS_NUM", "4")
    monkeypatch.setenv("PADDLE_ELASTIC_RANKS", "0,1,3")
    monkeypatch.setenv("PADDLE_ELASTIC_ORIG_WORLD", "8")
    port_fencing._reset()
    f = port_fencing.process_fence()
    assert f.generation == 4 and f.check() is True
    for fn in ("rank", "world_size", "generation", "live_ranks",
               "original_world"):
        assert getattr(port_membership, fn)() == \
            getattr(ref_membership, fn)(), fn
    for gb, w in ((32, None), (32, 8), (30, 4), (0, 2)):
        out = []
        for mod in (ref_membership, port_membership):
            try:
                out.append(mod.scaled_per_rank_batch(gb, world=w))
            except ValueError as e:
                out.append(str(e))
        assert out[0] == out[1]
    port_fencing._reset()


def test_replica_fence_verdicts():
    """A revoked incarnation refuses with the reference's message; its
    domain's newest generation is what the message names."""
    msgs = []
    for name in ("ref", "port"):
        sup_mod, _, _, fencing = PACKAGES[name]

        class Sup:
            def domain_generation(self, domain):
                return 5

        f = sup_mod.ReplicaFence(Sup(), "hostA", 3)
        sib = sup_mod.ReplicaFence(Sup(), "hostA", 4)
        assert f.check("x") is True and repr(f) == \
            "ReplicaFence('hostA', gen=3)"
        f.revoke()
        with pytest.raises(fencing.StaleGenerationError) as e:
            f.check("serving.heartbeat[r0]")
        msgs.append((str(e.value), repr(f), sib.check()))
    assert msgs[0] == msgs[1]


# ---------------------------------------------------------------------------
# supervisor decisions over a stub frontend
# ---------------------------------------------------------------------------
class _Rep:
    def __init__(self, name, domain=None, role="blended", fence=None,
                 load=0.0):
        self.name, self.domain, self.role, self.fence = (name, domain, role,
                                                         fence)
        self.state = "LIVE"
        self.retired = False
        self._load = load

    def load(self):
        return self._load


class StubFrontend:
    """What the supervisor reads and drives of a frontend, scripted:
    ``hint`` is the scale hint ``fleet_signal`` returns, ``drains``
    the verdicts of successive ``drain`` calls. Every call is logged, with
    the fences' state at each spawn."""

    def __init__(self, n=2, loads=None):
        self.replicas = [_Rep(f"replica{i}", load=(loads or [0.0] * n)[i])
                         for i in range(n)]
        self.supervisor = None
        self.hint = "hold"
        self.drains = []
        self.log = []

    @property
    def _by_name(self):
        return {r.name: r for r in self.replicas}

    def kill(self, name):
        self._by_name[name].state = "DEAD"
        self.log.append(("kill", name))

    def add_replica(self, engine, name=None, domain=None, role="blended",
                    fence=None):
        revoked = sorted(r.name for r in self.replicas
                         if r.fence is not None and r.fence.revoked)
        self.log.append(("add", name, domain, role, fence.generation,
                         engine, revoked))
        rep = _Rep(name, domain=domain, role=role, fence=fence)
        self.replicas.append(rep)
        return rep

    def remove_replica(self, rep):
        self.log.append(("remove", rep.name, rep.fence.revoked
                         if rep.fence else None))
        self.replicas = [r for r in self.replicas if r is not rep]

    def drain(self, rep, timeout=None):
        ok = self.drains.pop(0) if self.drains else True
        self.log.append(("drain", rep.name, timeout, ok))
        if ok:
            rep.state = "DRAINING"
        return ok

    def revive(self, rep):
        rep.state = "LIVE"
        self.log.append(("revive", rep.name))

    def fleet_signal(self):
        return {"scale_hint": self.hint}


class Factory:
    """Spawns engine tokens; the calls listed in ``fail`` raise."""

    def __init__(self, fail=()):
        self.fail = set(fail)
        self.calls = 0

    def __call__(self):
        self.calls += 1
        if self.calls in self.fail:
            raise RuntimeError(f"spawn {self.calls} failed")
        return f"engine{self.calls}"


def _transcript(name, script, n=2, loads=None, fail=(), **kw):
    """Run ``script(fe, sup, clk)`` against one package's supervisor; the
    transcript: the stub's log, the supervisor's events, its domains
    report after each step, the counters' deltas."""
    sup_mod, reg, _, _ = PACKAGES[name]
    fe = StubFrontend(n, loads)
    clk = Clock()
    before = {c: _val(reg, c) for c in SUP_COUNTERS}
    sup = sup_mod.ReplicaSupervisor(fe, Factory(fail), clock=clk,
                                    start=False, **kw)
    steps = []

    def tick(dt=0.0):
        clk.t += dt
        sup.tick()
        steps.append((clk.t, [(r.name, r.state, r.domain) for r in
                              fe.replicas], sup.report()["domains"]))

    script(fe, sup, tick)
    return {"log": fe.log, "events": list(sup._events), "steps": steps,
            "counters": {c: _val(reg, c) - before[c] for c in SUP_COUNTERS},
            "report": {k: v for k, v in sup.report().items()
                       if k != "domains"}}


def _both(script, **kw):
    ref = _transcript("ref", script, **kw)
    port = _transcript("port", script, **kw)
    assert port == ref
    return port


def test_backoff_schedule_and_budget_exhaustion():
    def script(fe, sup, tick):
        fe.kill("replica0")
        tick()            # attempt 1 fails: backoff 1 s
        tick(0.5)         # inside the backoff: no attempt
        tick(0.6)         # attempt 2 fails: backoff 2 s
        tick(1.5)         # inside it
        tick(0.6)         # attempt 3 fails: backoff min(4, 3) = 3 s
        tick(3.1)         # budget (3) spent inside the window: exhausted
        tick(50.0)        # stays exhausted, stays quiet

    t = _both(script, fail=(1, 2, 3), restart_budget=3,
              backoff_base_s=1.0, backoff_max_s=3.0, budget_window_s=100.0)
    assert t["counters"]["supervisor.spawn_failures"] == 3
    assert t["counters"]["supervisor.budget_exhausted"] == 1
    assert [s[2]["replica0"]["backoff_remaining_s"] for s in t["steps"][:5]] \
        == [1.0, 0.5, 2.0, 0.5, 3.0]
    assert t["steps"][-1][2]["replica0"]["exhausted"]


def test_budget_resets_across_windows_and_exhausts_within_one():
    def script(fe, sup, tick):
        name = "replica0"
        for gen in (1, 2, 3):                 # independent incidents
            fe.kill(name)
            tick()
            name = f"replica0-g{gen}"
            tick(150.0)
        for gen in (4, 5):                    # a crash loop in one window
            fe.kill(name)
            tick(1.0)
            name = f"replica0-g{gen}"
        fe.kill(name)
        tick(1.0)                             # third in-window: exhausted

    t = _both(script, restart_budget=2, budget_window_s=100.0,
              backoff_base_s=0.1)
    assert t["counters"]["supervisor.respawns"] == 5
    assert t["counters"]["supervisor.budget_exhausted"] == 1


def test_fence_is_revoked_before_the_replacement_is_spawned():
    def script(fe, sup, tick):
        fe.kill("replica1")
        tick()

    t = _both(script)
    add = next(e for e in t["log"] if e[0] == "add")
    assert add[1] == "replica1-g1" and add[4] == 1
    assert add[6] == ["replica1"]             # revoked before the spawn
    assert t["log"][-1] == ("remove", "replica1", True)


def test_grow_needs_a_sustained_hint():
    def script(fe, sup, tick):
        fe.hint = "grow"
        tick()            # the hold starts
        fe.hint = "hold"
        tick(2.0)         # a blip: the hold resets
        fe.hint = "grow"
        tick(1.0)
        tick(4.0)         # 4 s of this streak: no spawn
        tick(2.0)         # 6 s: grow
        tick(10.0)
        tick(10.0)        # capped at max_replicas

    t = _both(script, max_replicas=3, grow_hold_s=5.0)
    assert t["counters"]["supervisor.scale_ups"] == 1
    assert [e[1] for e in t["log"] if e[0] == "add"] == [
        "scale-blended1-g1"]


def test_shrink_after_cooldown_with_a_drain_that_times_out():
    def script(fe, sup, tick):
        fe.hint = "shrink"
        fe.drains = [False, True]
        tick()            # the cooldown starts
        tick(6.0)         # drain times out: the victim revives
        tick(1.0)         # the streak holds: drained and removed
        tick(20.0)        # the floor holds

    t = _both(script, n=3, loads=[0.5, 0.1, 0.9], min_replicas=2,
              shrink_cooldown_s=5.0, drain_timeout_s=7.0)
    assert [e[0] for e in t["log"]] == ["drain", "revive", "drain", "remove"]
    assert t["log"][0][1] == "replica1"       # the least loaded
    assert t["counters"]["supervisor.scale_downs"] == 1
    assert any(e[1] == "shrink_aborted" for e in t["events"])


def test_chaos_seams_fire_the_same_way():
    """``serving.spawn_fail`` armed in each package's chaos fails its
    spawns alike; ``supervisor.decision`` raises from a direct tick."""
    results = []
    for name in ("ref", "port"):
        sup_mod, reg, chaos, _ = PACKAGES[name]

        def script(fe, sup, tick, chaos=chaos):
            fe.kill("replica0")
            with chaos.FaultPlan().fail("serving.spawn_fail", times=1):
                tick()                        # fails: backoff
                tick(1.0)                     # the plan is spent: spawns
            with chaos.FaultPlan().fail("supervisor.decision", times=1):
                with pytest.raises(chaos.FaultInjected):
                    tick()

        results.append(_transcript(name, script, backoff_base_s=0.5))
    assert results[0] == results[1]
    assert results[1]["counters"]["supervisor.respawns"] == 1
    assert results[1]["counters"]["supervisor.spawn_failures"] == 1


def test_report_shape_matches():
    def script(fe, sup, tick):
        tick()

    t = _both(script, min_replicas=1, max_replicas=4)
    assert t["report"]["running"] is False
    assert t["report"]["max_replicas"] == 4


# ---------------------------------------------------------------------------
# the port's frontend with the supervisor, end to end
# ---------------------------------------------------------------------------
ENGINE = dict(max_seqs=4, page_size=16, max_len=256, prefill_chunk=32,
              decode_block=4)
NEW = 10
WAIT = 60.0


def test_engine_factory_is_default_off(monkeypatch):
    monkeypatch.delenv("PADDLE_SUPERVISOR", raising=False)
    tm = LlamaForCausalLM(llama_tiny(num_hidden_layers=1), device="cpu")

    def mk():
        return ContinuousBatchingEngine(tm, device="cpu", **ENGINE)

    with ServingFrontend([mk()], engine_factory=mk, start=False) as fe:
        assert fe.supervisor is None
    monkeypatch.setenv("PADDLE_SUPERVISOR", "1")
    with ServingFrontend([mk()], engine_factory=mk) as fe:
        assert isinstance(fe.supervisor, port_supervisor.ReplicaSupervisor)
        assert fe.serving_report()["supervisor"]["running"]
    assert not any(t.name == "paddle-serving-supervisor"
                   for t in threading.enumerate())


def _submit_retrying(fe, prompt, timeout=60.0):
    t0 = time.monotonic()
    while True:
        try:
            return fe.submit(prompt, NEW)
        except Overloaded as e:
            assert time.monotonic() - t0 < timeout, e
            time.sleep(min(max(e.retry_after_s, 0.05), 2.0))


def _wait(cond, timeout=30.0):
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout:
        if cond():
            return True
        time.sleep(0.01)
    return cond()


def test_kill_under_load_replacement_serves_reference_tokens(
        monkeypatch, tmp_path):
    monkeypatch.setenv("PADDLE_SUPERVISOR", "1")
    monkeypatch.setenv("PADDLE_SUPERVISOR_INTERVAL_S", "0.02")
    monkeypatch.setenv("PADDLE_SUPERVISOR_BACKOFF_S", "0.05")
    monkeypatch.setenv("PADDLE_SUPERVISOR_GROW_HOLD_S", "3600")
    monkeypatch.setenv("PADDLE_SUPERVISOR_SHRINK_COOLDOWN_S", "3600")
    monkeypatch.setenv("PADDLE_TELEMETRY_DIR", str(tmp_path))
    paddle.seed(43)
    jm = JaxLlama(jax_tiny(num_hidden_layers=2, max_position_embeddings=256))
    jm.eval()
    tm = LlamaForCausalLM(
        llama_tiny(num_hidden_layers=2, max_position_embeddings=256),
        device="cpu")
    load_paddle_tpu_state(tm, {n: np.asarray(p._data)
                               for n, p in jm.named_parameters()})
    rng = np.random.RandomState(17)
    prompts = [rng.randint(1, 128, int(rng.randint(6, 120))).astype(np.int32)
               for _ in range(12)]
    oracle = JaxEngine(jm, async_decode=False, **ENGINE).serve(
        prompts, max_new_tokens=NEW)

    def mk():
        return ContinuousBatchingEngine(tm, device="cpu", **ENGINE)

    respawns0 = _val(port_registry, "supervisor.respawns")
    fenced0 = _val(port_registry, "supervisor.fenced_writes")
    with ServingFrontend([mk(), mk()], engine_factory=mk,
                         heartbeat_deadline_s=120.0,
                         monitor_interval_s=0.02, start=False) as fe:
        hs = [fe.submit(p, NEW) for p in prompts[:8]]
        dead = fe.replicas[0]
        fe.start()
        assert _wait(lambda: sum(len(h.tokens_so_far()) for h in hs) >= 4
                     and dead.inflight)
        fe.kill("replica0", reason="test: killed under load")
        outs = [h.result(timeout=WAIT) for h in hs]
        assert _wait(lambda: "replica0-g1" in fe._by_name
                     and fe._by_name["replica0-g1"].thread_ident)
        # the replacement serves (load placement over two idle replicas);
        # the first load may have left the brownout ladder up, and a client
        # retries an Overloaded submit after its retry_after_s
        hs2 = [_submit_retrying(fe, p) for p in prompts[8:]]
        outs += [h.result(timeout=WAIT) for h in hs2]
        assert any(h.replica == "replica0-g1" for h in hs2)
        # a zombie's late heartbeat is refused, its file untouched
        hb = tmp_path / "serving" / f"heartbeat.{dead.index}.json"
        stamp = hb.read_bytes()
        dead._wd_last_write = 0.0
        dead.beat()
        assert hb.read_bytes() == stamp
        assert dead.fence_writable() is False
        report = fe.serving_report()
    assert all(h.error is None for h in hs + hs2)
    for got, want in zip(outs, oracle):
        np.testing.assert_array_equal(got, want)
    assert _val(port_registry, "supervisor.respawns") == respawns0 + 1
    assert _val(port_registry, "supervisor.fenced_writes") >= fenced0 + 2
    assert report["supervisor"]["domains"]["replica0"]["generation"] == 1
    live = json.loads((tmp_path / "serving" / "heartbeat.2.json")
                      .read_text())
    assert live["pid"] == os.getpid() and live["role"] == "serving"
