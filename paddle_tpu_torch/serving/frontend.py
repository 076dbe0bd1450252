"""Online request frontend: submit/stream/cancel over N engine replicas (the
port's own copy of ``paddle_tpu/serving/frontend.py``).

This is the serving entry point that
``ContinuousBatchingEngine.serve(prompts, ...)`` is not: requests arrive
one at a time from many client threads, get an SLO class and an optional
deadline, and are placed onto one of N engine replicas by the router —
then a **per-replica dispatcher thread** drives that engine continuously
through the non-blocking hooks (``try_admit_one`` / ``step``), so slots
refill the moment they free instead of waiting for a batch boundary.

Lifecycle of one request::

    handle = frontend.submit(prompt, max_new_tokens=64,
                             slo_class="interactive", deadline_s=2.0)
    for tok in handle.stream():   # or: handle.result(timeout=...)
        ...
    handle.cancel()               # any time; frees the slot at the next
                                  # block boundary

    submit -> SLOScheduler.check_admission   (Overloaded = shed, fast)
           -> Router.place                   (prefix affinity + load)
           -> replica.pending                (EDF order, aging built in)
    dispatcher: pick -> engine.try_admit_one -> engine.step loop
           -> handle tokens stream out as each decode block lands

Failure semantics (no hangs, no lost handles — the E2E chaos test's
contract): a replica that dies mid-flight (chaos ``serving.replica_kill``,
a wedged dispatcher caught by stale heartbeats, or an engine-fatal error)
has its queued requests transparently re-routed to surviving replicas; its
in-flight requests are re-routed too when their stream has not been
consumed yet (identical output — the sampled key stream depends only on
(seed, rid, index)), and cleanly failed with the replica's death reason
when tokens were already observed (a spliced stream would be a silent
correctness bug). Every handle always reaches a terminal state.

Concurrency rules: ONE frontend lock guards routing state (pending lists,
inflight maps, replica states); each engine is touched only by its own
dispatcher thread; RequestHandle has its own condition + token queue so
result()/stream() never contend with routing. The only dispatcher sleep is
the wake-event wait when a replica is fully idle.

On the card, each engine runs its device sections on a CUDA stream of its
own, so one replica's readback waits for its own blocks only, never for
the blocks another replica's thread queued.

The operator plane: ``engine_factory=`` with ``PADDLE_SUPERVISOR=1``
attaches a :class:`ReplicaSupervisor` (serving/supervisor.py) that
replaces dead replicas through the factory and scales on the fleet
rollup's hint, each incarnation under a generation fence
(``add_replica(fence=...)``); ``statusz_port=`` starts the ``/statusz``
server (observability/statusz.py) that ``shutdown()`` stops.
"""
import itertools
import queue as _queue
import threading
import time

from ..inference.continuous import (
    _COMPILE_LOCK,
    EngineRequest,
    canonical_sampling,
)
from ..observability import compilemem as _compilemem
from ..observability import devprof as _devprof
from ..observability import fleet as _fleet
from ..observability import goodput as _goodput
from ..observability import request_trace as _rtrace
from ..observability import tracing as _tracing
from ..observability.metrics import registry as _registry
from ..observability.slo import SLOMonitor
from ..testing import chaos
from ..utils.envs import env_bool
from .adapters import AdapterRegistry
from .breaker import CircuitBreaker
from .brownout import BrownoutLadder
from .tenancy import DEFAULT_TENANT, TenantRegistry
from .handoff import (
    HandoffBundle,
    HandoffError,
    StaleHandoffError,
    page_digests,
)
from .kvfabric import KVFabric
from .transport import make_transport
from .router import (
    ADMITTING,
    DEAD,
    DRAINING,
    LIVE,
    PROBATION,
    NoLiveReplicas,
    ReplicaHandle,
    Router,
)
from .scheduler import DeadlineExceeded, Overloaded, SLOScheduler

__all__ = ["QUEUED", "RUNNING", "DONE", "FAILED", "CANCELLED",
           "RequestFailed", "RequestCancelled", "ResultTimeout",
           "RequestHandle", "ServingFrontend"]

QUEUED = "QUEUED"
RUNNING = "RUNNING"
DONE = "DONE"
FAILED = "FAILED"
CANCELLED = "CANCELLED"
_TERMINAL = (DONE, FAILED, CANCELLED)

_M_SUBMITTED = _registry.counter("serving.submitted")
_M_COMPLETED = _registry.counter("serving.completed")
_M_FAILED = _registry.counter("serving.failed")
_M_SHED = _registry.counter("serving.shed")
_M_EXPIRED = _registry.counter("serving.deadline_expired")
_M_CANCELLED = _registry.counter("serving.cancelled")
_M_REROUTED = _registry.counter("serving.rerouted")
_M_DRAIN_REQUEUED = _registry.counter("serving.drain_requeued")
_M_REPLICA_DEAD = _registry.counter("serving.replica_dead")
_M_QUEUE = _registry.gauge("serving.queue_depth")
_M_FLAPS = _registry.counter(
    "serving.replica_flaps",
    help="stale-heartbeat observations that recovered before the miss "
         "budget ran out (damped — no reroute storm)")
_M_SPARED = _registry.counter(
    "serving.replica_spared",
    help="stale-heartbeat monitor checks that spared a replica whose "
         "dispatcher held or awaited the compile lock or its engine's "
         "dispatch lock under a hold younger than the deadline")
_M_CLAMPED = _registry.counter(
    "brownout.tokens_clamped",
    help="batch-class submits whose max_new_tokens the brownout ladder "
         "clamped")
_M_HANDOFF_INITIATED = _registry.counter(
    "serving.handoff.initiated",
    help="prefill->decode KV-page handoffs initiated (bundle published and "
         "the request detached from its prefill replica)")


def _count_handoff_fallback(reason):
    """One rung of the degradation ladder fired: the request completes in
    blended mode instead of disaggregating (availability over perf)."""
    _registry.counter(
        "serving.handoff.fallback", labels={"reason": reason},
        help="requests that fell back to blended completion instead of a "
             "prefill->decode handoff, by reason").inc()


def _hist_summary(h):
    """Compact histogram rollup for serving_report()/tenant_report()."""
    return {"count": h.count, "mean": round(h.mean, 6),
            "p50": h.quantile(0.5), "p99": h.quantile(0.99)}


class RequestFailed(RuntimeError):
    """result()/stream(): the request reached FAILED; the message carries
    the per-request failure reason."""


class RequestCancelled(RuntimeError):
    """result(): the request was cancelled before completing."""


class ResultTimeout(TimeoutError):
    """result(timeout=)/stream(timeout=): the caller's wait bound expired. The REQUEST is untouched — it keeps running and
    a later result()/stream() can still observe it; only the caller's
    blocking wait is bounded, so a wedged fleet can't hold every client
    thread hostage. Subclasses TimeoutError for drop-in compatibility."""


class _Entry:
    """Routing-layer wrapper: one EngineRequest + its handle + SLO facts."""

    __slots__ = ("req", "handle", "slo", "deadline_t", "virtual_deadline",
                 "observed", "route_affinity", "route_score", "probe",
                 "trace", "attempt_span", "queue_span", "attempt_n",
                 "target_role", "needs_handoff", "handoff_gen",
                 "bundle_path", "bundle", "kv_hint_deferred", "tenant")

    def __init__(self, req, handle, slo, deadline_t, virtual_deadline,
                 tenant=None):
        self.req = req
        self.handle = handle
        self.slo = slo
        self.deadline_t = deadline_t
        self.virtual_deadline = virtual_deadline
        # multi-tenant plane: the resolved Tenant this request
        # was admitted under — per-tenant observation/report attribution
        self.tenant = tenant
        self.observed = False   # queue_wait/ttft recorded (once per request)
        self.route_affinity = False  # last place(): won by affinity/hint?
        self.route_score = 0.0       # last place(): winning blended score
        self.probe = False           # last place(): half-open breaker probe?
        # request-scoped tracing: the trace context plus the open
        # per-attempt spans — an attempt is one placement; a reroute closes
        # it and opens the next, so the trace tree shows the failover
        self.trace = None
        self.attempt_span = None
        self.queue_span = None
        self.attempt_n = 0
        # disaggregated prefill/decode handoff state: the role the
        # router should prefer, whether the prefill side still owes a KV-page
        # handoff, the generation fence that drops superseded bundles, and
        # the published bundle awaiting adoption (path on disk / loaded copy)
        self.target_role = None
        self.needs_handoff = False
        self.handoff_gen = 0
        self.bundle_path = None
        self.bundle = None
        # cluster KV fabric: a peer-residency placement defers
        # the router's session-hint write until the adoption lands
        self.kv_hint_deferred = False


class RequestHandle:
    """The caller's view of one in-flight request. Thread-safe; every
    accessor works from any thread. Exactly one terminal transition ever
    happens (DONE / FAILED / CANCELLED) — late token pushes from a replica
    that was declared dead mid-step are discarded by the generation stamp."""

    def __init__(self, frontend, req, slo):
        self._frontend = frontend
        self._req = req
        self.slo_class = slo.name
        self.replica = None          # name of the replica serving it
        self.timed_out = False
        self._trace = None           # TraceContext (None = telemetry off)
        self._cond = threading.Condition()
        self._status = QUEUED
        self._result = None
        self._error = None           # rendered failure reason (string)
        self._tokens = []            # generated tokens observed so far
        self._stream_q = _queue.Queue()
        self._stream_consumed = False
        self._gen = 0                # bumped on reroute; stale pushes drop
        # set by cancel() BEFORE the frontend scans its queues, so a request
        # in the admission transit window (in neither pending nor inflight)
        # still sees the cancel when the dispatcher re-examines it
        self._cancel_requested = False
        # multi-tenant plane: fired exactly once at the terminal
        # transition (whichever path wins) — releases the tenant's inflight
        # slot and the request's LoRA adapter pin
        self._on_terminal = None

    # ---- caller surface ---------------------------------------------------
    @property
    def rid(self):
        return self._req.rid

    @property
    def status(self):
        with self._cond:
            return self._status

    @property
    def error(self):
        """Failure reason string (None unless FAILED)."""
        with self._cond:
            return self._error

    def tokens_so_far(self):
        with self._cond:
            return list(self._tokens)

    def done(self):
        return self.status in _TERMINAL

    def result(self, timeout=None):
        """Block for the full token array (prompt + generated). Raises
        RequestFailed (with the failure reason) / RequestCancelled /
        ResultTimeout. The timeout bounds only THIS caller's wait — the
        request itself keeps running (call cancel() to abandon it), so a
        wedged fleet can't hold the caller hostage forever. (A request the
        ENGINE timed out per its own ``timeout_s`` still returns its
        partial result with ``handle.timed_out`` set.)"""
        with self._cond:
            if not self._cond.wait_for(
                    lambda: self._status in _TERMINAL, timeout):
                raise ResultTimeout(
                    f"request {self.rid} not finished within {timeout}s "
                    f"(the request is still running — not cancelled)")
            if self._status == DONE:
                return self._result
            if self._status == CANCELLED:
                raise RequestCancelled(f"request {self.rid} was cancelled")
            raise RequestFailed(
                f"request {self.rid} failed: {self._error}")

    def stream(self, timeout=None):
        """Iterator over generated token ids, yielding each one as soon as
        its decode block lands. Ends at completion/cancellation; raises
        RequestFailed on failure; ``timeout`` bounds the wait for EACH next
        token (ResultTimeout — the request is NOT cancelled; the iterator
        can be resumed by calling stream() again). Consuming the stream
        pins the request to its replica — a consumed stream cannot be
        transparently re-routed, only failed."""
        with self._cond:
            # under the lock so the flag and _reset_for_reroute's check are
            # ordered: either the reroute sees it consumed and fails the
            # handle, or this iterator only ever observes the replay
            self._stream_consumed = True
        while True:
            try:
                kind, val = self._stream_q.get(timeout=timeout)
            except _queue.Empty:
                raise ResultTimeout(
                    f"request {self.rid}: no token within {timeout}s "
                    f"(the request is still running — not cancelled)") \
                    from None
            if kind == "tok":
                yield val
            elif kind == "end":
                return
            else:  # "err"
                raise RequestFailed(f"request {self.rid} failed: {val}")

    def cancel(self):
        """Best-effort cancel: a queued request never runs; a running one
        retires at the next block boundary. Idempotent; no-op once
        terminal."""
        self._frontend._cancel(self)

    # ---- dispatcher surface (frontend internals only) ---------------------
    def _push_token(self, tok, gen):
        with self._cond:
            if gen != self._gen or self._status in _TERMINAL:
                return  # stale replica still stepping after reroute/failure
            self._tokens.append(tok)
            # the queue put stays INSIDE the lock: _reset_for_reroute drains
            # the queue under the same lock, so a push that passed the gen
            # check can't slip a stale token in after the drain
            self._stream_q.put(("tok", tok))

    def _mark_running(self, replica_name):
        with self._cond:
            if self._status == QUEUED:
                self._status = RUNNING
                self.replica = replica_name

    def _mark_queued(self):
        with self._cond:
            if self._status == RUNNING:
                self._status = QUEUED
                self.replica = None

    def _reset_for_reroute(self):
        """Forget everything the dead replica produced; returns the new
        generation stamp for the replacement on_token closure, or None when
        the stream has been consumed (checked under the same lock stream()
        sets the flag under — a replay after the consumer dequeued a token
        would duplicate output)."""
        with self._cond:
            if self._stream_consumed:
                return None
            self._gen += 1
            self._tokens = []
            while True:
                try:
                    self._stream_q.get_nowait()
                except _queue.Empty:
                    break
            self._status = QUEUED
            self.replica = None
            return self._gen

    def _complete(self, req):
        with self._cond:
            if self._status in _TERMINAL:
                return
            self._result = req.result
            self.timed_out = req.timed_out
            self._status = DONE
            self._cond.notify_all()
        self._stream_q.put(("end", None))
        self._fire_terminal()
        self._trace_finish("ok", n_generated=req.n_generated,
                           timed_out=req.timed_out)

    def _fail(self, reason):
        with self._cond:
            if self._status in _TERMINAL:
                return
            self._error = str(reason)
            self._status = FAILED
            self._cond.notify_all()
        self._stream_q.put(("err", str(reason)))
        self._fire_terminal()
        self._trace_finish("error", error=str(reason))

    def _cancelled_now(self):
        with self._cond:
            if self._status in _TERMINAL:
                return
            self._status = CANCELLED
            self._cond.notify_all()
        self._stream_q.put(("end", None))
        self._fire_terminal()
        self._trace_finish("cancelled")

    def _fire_terminal(self):
        """Run the once-only terminal hook (tenant slot / adapter pin
        release). Only the transition that WON calls this — the early
        returns above never reach it — and the swap-to-None makes even a
        double call release exactly once."""
        cb, self._on_terminal = self._on_terminal, None
        if cb is not None:
            cb()

    def _trace_finish(self, status, **attrs):
        """Terminal trace transition, tied to the handle's own once-only
        terminal transition (whichever failure/completion path won): the
        trace finishes exactly once, and finish() sweeps any spans a dead
        replica's paths left open — structurally no orphan spans."""
        tr, self._trace = self._trace, None
        if tr is not None:
            tr.finish(status, **attrs)


class ServingFrontend:
    """The online serving control plane over N ContinuousBatchingEngine
    replicas. See the module docstring for the architecture; see
    docs/SERVING.md for the operator view (SLO classes, routing policy,
    drain semantics, env vars, metrics)."""

    def __init__(self, engines, scheduler=None, router=None,
                 poll_wait_s=0.005, heartbeat_deadline_s=30.0,
                 monitor_interval_s=None, heartbeat_misses=3,
                 brownout=None, breaker=None, engine_factory=None,
                 start=True, warmup=None,
                 slo_monitor=None, statusz_port=None,
                 roles=None, handoff=None, kvfabric=None,
                 tenants=None, adapters=None):
        # heartbeat_deadline_s must outlast the longest single engine call
        # outside the compile lock (a kernel build inside it is spared),
        # and a false DEAD verdict reroutes a healthy replica's work.
        # warmup() the engines, then tighten it.
        if not engines:
            raise ValueError("need at least one engine replica")
        self.scheduler = scheduler or SLOScheduler()
        self.router = router or Router()
        self.poll_wait_s = float(poll_wait_s)
        self.heartbeat_deadline_s = float(heartbeat_deadline_s)
        # flap damping: LIVE->DEAD needs this many
        # CONSECUTIVE stale-beat monitor checks — one slow heartbeat scrape
        # is a counted flap (serving.replica_flaps), not a reroute storm
        self.heartbeat_misses = max(1, int(heartbeat_misses))
        self.monitor_interval_s = (float(monitor_interval_s)
                                   if monitor_interval_s is not None
                                   else max(0.05, self.heartbeat_deadline_s / 4))
        # a FULLY idle replica (engine empty, nothing routed) waits longer
        # than poll_wait_s — every transition that creates work sets the
        # wake event, so the only reason to wake at all is the heartbeat;
        # capped well under the deadline so idleness never reads as death
        self.idle_wait_s = min(1.0, self.heartbeat_deadline_s / 4)
        # disaggregated prefill/decode: ``roles`` assigns each
        # engine a pool ("prefill"/"decode"/"blended", default blended);
        # PADDLE_SERVING_DISAGG=0 force-disables the handoff path so a
        # roled fleet serves every request blended (byte-for-byte the
        # pre-disaggregation behavior — the keystone degradation switch)
        if roles is not None and len(roles) != len(engines):
            raise ValueError(
                f"roles has {len(roles)} entries for {len(engines)} engines")
        self.replicas = [
            ReplicaHandle(f"replica{i}", eng, index=i,
                          role=(roles[i] if roles else "blended"))
            for i, eng in enumerate(engines)]
        self._disagg_enabled = env_bool("PADDLE_SERVING_DISAGG", True)
        # KV-page handoff transport: PADDLE_KV_TRANSPORT picks
        # spool (the directory path, default) or wire
        # (transport.WireTransport); injectable for tests
        self.handoff = handoff or make_transport()
        # cluster KV fabric: tiered prefix cache + residency
        # map. Constructed even when PADDLE_KV_FABRIC=0 (it no-ops
        # internally) so /kvz and serving_report stay shaped; the wire
        # transport is shared with handoff when one is configured
        self.kvfabric = kvfabric or KVFabric(
            name="frontend",
            transport=self.handoff if hasattr(self.handoff, "fetch_blob")
            else None)
        self._by_name = {r.name: r for r in self.replicas}
        self._lock = threading.Lock()
        self._rid_counter = itertools.count()
        self._wakes = {r.name: threading.Event() for r in self.replicas}
        self._drained = {r.name: threading.Event() for r in self.replicas}
        self._stop = threading.Event()
        self._threads = []
        self._started = False
        self._class_hists = {}
        # warmup vocabulary: kwargs forwarded to each engine's warmup()
        # by ITS dispatcher thread before it serves (replicas warm in
        # parallel, serialized only on the shared compile lock), so first
        # requests don't eat the kernel builds and first dispatches. e.g.
        # warmup=dict(buckets=[64, 256, 1024], sampling=[(False,1,0,1)])
        self._warmup_kw = dict(warmup) if warmup else None
        # SLO burn-rate accounting: objectives default from the
        # scheduler's class declarations (ttft_slo_s/tpot_slo_s per class +
        # a deadline-miss objective); fed by the same observation points
        # as the per-class histograms, read via serving_report()
        self.slo = slo_monitor or SLOMonitor(
            classes=self.scheduler.classes.values())
        # overload brownout ladder: declared degradation steps
        # driven by the monitor's fleet-pressure observations; level 0
        # (no pressure ever observed) is a no-op on every submit path
        self.brownout = brownout or BrownoutLadder()
        # multi-tenant plane: the bounded tenant registry (a
        # TenantRegistry, or an iterable of Tenant declarations) and the
        # ref-counted LoRA adapter host cache. Untenanted submits resolve
        # to the registry's default tenant — byte-compatible with the
        # pre-tenancy API; per-tenant SLO burn-rate monitors are minted
        # lazily on a tenant's first observation (never for "default",
        # whose traffic stays on the fleet monitor alone)
        self.tenants = (tenants if isinstance(tenants, TenantRegistry)
                        else TenantRegistry(tenants or ()))
        self.adapters = (adapters if isinstance(adapters, AdapterRegistry)
                         else AdapterRegistry())
        self._tenant_slo = {}   # tenant name -> SLOMonitor (under _lock)
        # circuit breaker: per-replica error/latency scoring;
        # verdicts become PROBATION/LIVE/DEAD transitions under self._lock.
        # The router consults it for half-open probe placements.
        self.breaker = breaker or CircuitBreaker()
        self.router.breaker = self.breaker
        # the router scores placement against the CLUSTER-wide prefix
        # index: peer-resident prefixes become transfer-discounted
        # affinity (router.place reads fabric.resident_owners)
        self.router.fabric = self.kvfabric
        # replica index allocator for add_replica (heartbeat-file rank
        # namespace must never reuse a live index)
        self._next_index = len(self.replicas)
        # live introspection: statusz_port=0 picks a free port
        self.statusz = None
        if statusz_port is not None:
            self.statusz = self.serve_statusz(statusz_port)
        # replica lifecycle supervisor: attached by ReplicaSupervisor
        # itself; None = nobody owns spawn/scale. ``engine_factory`` with
        # PADDLE_SUPERVISOR=1 is the opt-in: the variable's default-off
        # keeps this constructor at no extra thread
        self.supervisor = None
        if start:
            self.start()
        if engine_factory is not None:
            from .supervisor import ReplicaSupervisor

            ReplicaSupervisor.from_env(self, engine_factory)

    # ---- lifecycle --------------------------------------------------------
    def start(self):
        if self._started:
            return self
        self._started = True
        # scope the (process-global) serving goodput split to this
        # frontend's lifetime: without the reset, an hour of training
        # before serving dilutes every serving fraction toward zero
        _goodput.serving.reset()
        for rep in self.replicas:
            t = threading.Thread(target=self._run_replica, args=(rep,),
                                 daemon=True,
                                 name=f"paddle-serving-{rep.name}")
            self._threads.append(t)
            t.start()
        m = threading.Thread(target=self._run_monitor, daemon=True,
                             name="paddle-serving-monitor")
        self._threads.append(m)
        m.start()
        return self

    def serve_statusz(self, port=0, host="127.0.0.1"):
        """Start (and return) a /statusz introspection server bound to this
        frontend: every route of ``StatusServer.route_names()``
        (observability/statusz.py). Stopped by shutdown()."""
        from ..observability.statusz import StatusServer

        return StatusServer(port=port, host=host, frontend=self).start()

    def shutdown(self, timeout=5.0):
        """Stop the supervisor, the status server, the dispatchers and the
        monitor. In-flight work stops at the next block boundary;
        unfinished handles are failed (never lost)."""
        if self.supervisor is not None:
            self.supervisor.stop()
            self.supervisor = None
        if self.statusz is not None:
            self.statusz.stop()
            self.statusz = None
        self._stop.set()
        for ev in self._wakes.values():
            ev.set()
        for t in self._threads:
            t.join(timeout=timeout)
        with self._lock:
            orphans = []
            for rep in self.replicas:
                orphans.extend(rep.pending)
                orphans.extend(rep.inflight.values())
                rep.pending = []
                rep.inflight = {}
        for e in orphans:
            if e.bundle_path is not None:
                self.handoff.discard(e.bundle_path)
                e.bundle_path = None
            e.handle._fail("frontend shut down")
        close = getattr(self.handoff, "close", None)
        if close is not None:
            close()

    def __enter__(self):
        return self

    def __exit__(self, *exc_info):
        self.shutdown()
        return False

    # ---- submission -------------------------------------------------------
    def submit(self, prompt, max_new_tokens, slo_class=None,
               deadline_s=None, eos_token_id=None, do_sample=False,
               temperature=1.0, top_k=0, top_p=1.0, seed=0,
               timeout_s=None, is_retry=False, tenant=None, adapter=None):
        """Enqueue one request; returns its RequestHandle immediately.

        Raises Overloaded (load shed — the request was never queued) when
        the scheduler's queue bound is hit or the brownout ladder sheds
        this class (machine-readable ``retry_after_s``/``level``/``step``
        fields), or NoLiveReplicas when every replica is draining/dead.
        ``deadline_s`` is relative to now: it tightens the EDF priority
        and, if it expires before the request starts, the request fails
        fast with DeadlineExceeded instead of wasting decode slots.
        ``is_retry=True`` declares a client re-submission of a rejected/
        failed request: it must withdraw from the per-class retry budget
        or is rejected immediately — the valve that keeps a retry storm
        from re-saturating a recovering fleet (docs/SERVING.md).

        ``tenant`` names a DECLARED tenant (or passes the
        Tenant itself); None maps to the registry's default tenant —
        byte-compatible with the pre-tenancy path. The tenant layer runs
        ABOVE the fleet ladder and the EDF queue bound: the tenant's
        private brownout ladder and retry budget, its token bucket
        (``Overloaded(step="tenant_quota", tenant=..., retry_after_s=
        <refill deficit>)``), and its inflight cap. ``slo_class=None``
        defaults to the tenant's declared class (else "interactive").

        ``adapter`` names a LoRA adapter registered in
        ``frontend.adapters`` (name, digest, or the LoRAAdapter). It is
        resolved + ref-pinned here and released at the handle's terminal
        transition; the tenant's allowlist is enforced. Adapter requests
        serve blended (never disaggregated) and co-batch with base
        traffic inside the engine."""
        t = self.tenants.resolve(tenant)   # unknown tenant -> ValueError
        slo = self.scheduler.resolve(
            slo_class or t.slo_class or "interactive")
        reserve = self.scheduler.reserve_class
        # tenant isolation layer, ABOVE every fleet-wide check:
        # the storming tenant must shed against ITS OWN ladder/bucket/cap —
        # tenant-stamped, with retry_after_s from its bucket's refill
        # deficit — before it can so much as read fleet state. The default
        # tenant's private ladder is a pass-through: untenanted traffic is
        # governed by the fleet ladder alone (running both would charge a
        # retry against two budgets — not byte-compatible with pre-tenancy)
        if t is not self.tenants.default:
            try:
                t.brownout.check_admission(slo, reserve)
                if is_retry:
                    t.brownout.check_retry(slo)
            except Overloaded:
                t.count_shed()
                _M_SHED.inc()
                raise
        try:
            t.admit()          # token bucket (counts its own shed)
            t.acquire_slot()   # inflight cap (likewise)
        except Overloaded:
            _M_SHED.inc()
            raise
        ad = None
        handle = None
        try:
            if adapter is not None:
                if not t.allows_adapter(adapter):
                    raise ValueError(
                        f"tenant {t.name!r} is not allowed adapter "
                        f"{getattr(adapter, 'name', adapter)!r}")
                ad = self.adapters.acquire(adapter)
            handle = self._submit_admitted(
                t, ad, slo, reserve, prompt, max_new_tokens, deadline_s,
                eos_token_id, do_sample, temperature, top_k, top_p, seed,
                timeout_s, is_retry)
            return handle
        except BaseException:
            # the slot/pin must not leak on ANY pre-queue failure; once a
            # handle exists its once-only terminal hook owns the release
            # (covers the window where the entry already became
            # dispatcher-visible before the raise)
            if handle is not None:
                handle._fire_terminal()
            else:
                t.release_slot()
                if ad is not None:
                    self.adapters.release(ad)
            raise

    def _submit_admitted(self, t, ad, slo, reserve, prompt, max_new_tokens,
                         deadline_s, eos_token_id, do_sample, temperature,
                         top_k, top_p, seed, timeout_s, is_retry):
        """submit() past the tenant layer: fleet brownout, queue bound,
        placement. The caller owns tenant-slot/adapter release on raise."""
        # brownout ladder: the declared degradation steps run
        # BEFORE the queue-bound check — they are cheaper (two int reads)
        # and shedding at the rung is the point of having rungs at all
        try:
            self.brownout.check_admission(slo, reserve)
            if is_retry:
                self.brownout.check_retry(slo)
        except Overloaded:
            _M_SHED.inc()
            raise
        cap = self.brownout.token_cap(slo, reserve)
        if cap is not None and max_new_tokens > cap:
            max_new_tokens = cap  # clamp_tokens rung: bounded decode work
            _M_CLAMPED.inc()
        # shed_extras rung: optional work off — no per-request trace
        # minting, no O(prompt-bytes) affinity probing in the router
        extras = self.brownout.extras_enabled()
        sampling = canonical_sampling(do_sample, temperature, top_k, top_p)
        rid = next(self._rid_counter)  # atomic under the GIL
        req = EngineRequest(rid, prompt, max_new_tokens,
                            eos_token_id=eos_token_id, sampling=sampling,
                            seed=seed, timeout_s=timeout_s, adapter=ad)
        handle = RequestHandle(self, req, slo)

        def _release_tenant():
            t.release_slot()
            if ad is not None:
                self.adapters.release(ad)

        # fired exactly once at whichever terminal transition wins (or by
        # submit()'s failure path): the tenant slot and adapter pin follow
        # the handle's lifetime, never a particular dispatcher's
        handle._on_terminal = _release_tenant
        req.on_token = self._make_on_token(handle, gen=0)
        deadline_t = (req.t_enqueue + float(deadline_s)
                      if deadline_s is not None else None)
        entry = _Entry(req, handle, slo, deadline_t,
                       self.scheduler.virtual_deadline(
                           req.t_enqueue, slo, deadline_s),
                       tenant=t)
        # disaggregated placement: with a roled fleet and a live
        # decode pool, the request targets the prefill pool and owes a
        # KV-page handoff after its first token. Token delivery is
        # suppressed until the decode side replays the bundle: TTFT must
        # span prefill queue wait + handoff transfer, so the
        # first client-visible token is stamped at decode-side delivery.
        # An empty/all-PROBATION decode pool degrades to blended here and
        # at every later checkpoint (availability over disaggregation).
        if self._disagg_active():
            if ad is not None:
                # LoRA requests complete blended: the adapter
                # delta lives in the decode program's operands, not the KV
                # bundle — a handoff would replay the prefix base-only
                _count_handoff_fallback("lora_adapter")
            elif self._decode_pool_live():
                entry.target_role = "prefill"
                entry.needs_handoff = True
                req.on_token = None
            else:
                _count_handoff_fallback("decode_pool_empty")
        # advisory fast-path shed (unlocked reads): overload traffic must
        # not pay the placement probe per rejected submit. The
        # authoritative check re-runs under the append lock below.
        try:
            self.scheduler.check_admission(
                sum(len(r.pending) for r in self.replicas), slo)
        except Overloaded:
            _M_SHED.inc()
            raise
        # request-scoped trace: minted AFTER the advisory shed —
        # a shed storm must not mint contexts — and finished by the
        # handle's terminal transition, whichever path that is. None when
        # telemetry is off (the zero-overhead contract) or the brownout
        # ladder shed extras.
        handle._trace = entry.trace = _rtrace.start(
            rid, slo=slo.name, prompt_len=len(req.prompt),
            max_new_tokens=req.max_new_tokens,
            deadline_s=float(deadline_s) if deadline_s is not None
            else None) if extras else None
        exclude = set()
        try:
            while True:
                # placement runs OUTSIDE the frontend lock: the
                # prefix-affinity probe hashes O(prompt bytes) per replica
                # (the engine's chained-digest index), and doing even that
                # under the one lock every dispatcher's admission pick needs
                # would stall all replicas behind each long-prompt submit.
                # Everything place() reads is advisory; the append below
                # re-checks the decisions that matter under the lock.
                rep = self.router.place(entry, self.replicas,
                                        exclude=exclude, cheap=not extras)
                # spans open BEFORE the entry becomes dispatcher-visible: a
                # dispatcher that pops it the instant the append lands must
                # find the queue span already open
                self._trace_commit(entry, rep)
                with self._lock:
                    # checked under the SAME lock shutdown's orphan sweep
                    # holds: an unlocked check could pass, the sweep run, and
                    # the append below then queue an entry no dispatcher will
                    # ever see — a handle that never reaches a terminal state
                    if self._stop.is_set():
                        raise RuntimeError("frontend is shut down")
                    queued = sum(len(r.pending) for r in self.replicas)
                    try:
                        # under the append lock so depth can't race past the
                        # bound (the scheduler's check+enqueue contract)
                        self.scheduler.check_admission(queued, slo)
                    except Overloaded:
                        _M_SHED.inc()
                        raise
                    # state can change between place() and here; a probe
                    # placement lands on its PROBATION target (that IS the
                    # half-open recovery signal)
                    if rep.state == LIVE or (entry.probe
                                             and rep.state == PROBATION):
                        rep.pending.append(entry)
                        _M_SUBMITTED.inc()
                        _M_QUEUE.set(queued + 1)
                        break
                self._trace_attempt_end(entry, "rerouted",
                                        reason=f"{rep.name} not LIVE")
                exclude.add(rep.name)
        except BaseException as e:
            if entry.trace is not None:
                handle._trace = None
                entry.trace.finish(
                    "shed" if isinstance(e, Overloaded) else "error",
                    error=f"{type(e).__name__}: {e}")
            raise
        self.router.committed(entry, rep)
        # accepted: deposit into the class retry budget — accepted goodput
        # is what funds future retries (the anti-retry-storm construction)
        self.brownout.on_accepted(slo)
        t.brownout.on_accepted(slo)
        t.count_admitted()
        self._wake(rep.name)
        return handle

    def _make_on_token(self, handle, gen):
        def on_token(rid, tok):
            handle._push_token(tok, gen)
        return on_token

    # ---- disaggregated prefill/decode --------------------------
    def _disagg_active(self):
        """Handoffs happen only when the operator both enabled them
        (PADDLE_SERVING_DISAGG, default on) and gave the fleet a prefill
        pool. With neither, every path below is dead code and blended
        serving is byte-for-byte the pre-disaggregation behavior."""
        return self._disagg_enabled and any(
            r.role == "prefill" and r.state in ADMITTING
            for r in self.replicas)

    def _decode_pool_live(self):
        """True when at least one decode-role replica is LIVE. The
        ``serving.decode_pool_empty`` chaos seam sits on the check itself:
        an injected fault here declares the pool empty, which is exactly
        the degradation drill (blended completion, nothing lost)."""
        try:
            chaos.site("serving.decode_pool_empty")
        except Exception:
            return False
        return any(r.role == "decode" and r.state == LIVE
                   for r in self.replicas)

    def _handoff_fallback(self, entry, reason):
        """Blended completion for a request that was slated for handoff:
        deliver the suppressed tokens to the handle (the client's first
        token is NOW: TTFT is delivery time) and stream
        normally from here. The request just keeps decoding wherever it
        already is; nothing was detached, so nothing can be lost."""
        _count_handoff_fallback(reason)
        req = entry.req
        entry.needs_handoff = False
        entry.target_role = None
        req.on_token = self._make_on_token(entry.handle, entry.handle._gen)
        if req.t_first_token is not None:
            req.t_first_token = time.monotonic()
        for tok in req.tokens[len(req.prompt):]:
            req.on_token(req.rid, tok)
        self._observe_admission(entry)

    def _initiate_handoffs(self, rep):
        """Prefill-side dispatcher hook: every in-flight request that has
        its first token and still owes a handoff gets one initiated."""
        with self._lock:
            candidates = [e for e in rep.inflight.values()
                          if e.needs_handoff
                          and e.req.t_first_token is not None
                          and not e.req.finished and not e.req.cancelled]
        moved = False
        for entry in candidates:
            moved |= self._initiate_handoff(rep, entry)
        return moved

    def _initiate_handoff(self, rep, entry):
        """Export the request's KV pages, publish the bundle, detach the
        request from the prefill engine, and requeue it toward the decode
        pool. Every failure BEFORE the detach degrades to blended (the
        request keeps decoding right here — handoff is a perf win, never
        an availability loss); after the detach the bundle on disk is the
        request, and the adopt path owns every failure from there."""
        eng, req = rep.engine, entry.req
        if not self._decode_pool_live():
            self._handoff_fallback(entry, "decode_pool_empty")
            return False
        span = None
        if entry.attempt_span is not None:
            span = entry.attempt_span.child("handoff", rid=req.rid,
                                            generation=entry.handoff_gen)
        try:
            payloads = eng.export_pages(req.slot)
        except Exception as e:
            if span is not None:
                span.end("error", error=f"{type(e).__name__}: {e}")
            self._handoff_fallback(entry, "export_failed")
            return False
        if payloads is None:
            # finished (or was retired) while settling the in-flight block:
            # nothing to hand off — _finish delivers the suppressed tokens
            if span is not None:
                span.end("skipped", reason="request already finished")
            return False
        n_pages = payloads["n_pages"]
        bundle = HandoffBundle(
            rid=req.rid, seed=req.seed, sampling=req.sampling,
            prompt=req.prompt, tokens=list(req.tokens[len(req.prompt):]),
            n_generated=req.n_generated, n_dispatched=req.n_dispatched,
            max_new_tokens=req.max_new_tokens,
            eos_token_id=req.eos_token_id, timeout_s=req.timeout_s,
            payloads=payloads,
            digests=page_digests(req.prompt, eng.page_size,
                                 min(n_pages, len(req.prompt)
                                     // eng.page_size)),
            page_size=eng.page_size, generation=entry.handoff_gen)
        try:
            path = self.handoff.publish(bundle)
        except Exception as e:
            # deadline/retries exhausted: nothing was detached, so the
            # request simply keeps decoding here in blended mode
            if span is not None:
                span.end("error", error=f"{type(e).__name__}: {e}")
            self._handoff_fallback(entry, "publish_failed")
            return False
        eng.detach_request(req.slot)
        with self._lock:
            rep.inflight.pop(req.rid, None)
        entry.needs_handoff = False
        entry.bundle_path = path
        entry.target_role = "decode"
        _M_HANDOFF_INITIATED.inc()
        if span is not None:
            span.end("ok", n_pages=n_pages,
                     n_tokens=len(bundle.tokens))
        # close the prefill attempt as handed off so _requeue's reroute
        # edge (the "attempt edge") is the only event stamped
        self._trace_attempt_end(entry, "handed_off",
                                reason="kv pages published to decode pool")
        self._requeue(entry, exclude=set(),
                      fail_reason="handoff to decode pool",
                      rerouted=False)
        return True

    def _adopt_one(self, rep, entry):
        """Decode-side admission for a bundle-carrying entry. Returns the
        try_admit_one status vocabulary ("admitted"/"deferred"/"failed")
        plus "requeued" when a corrupt/stale bundle sent the request back
        for a re-prefill. The spool file is consumed on first load; a
        deferred adopt keeps the validated bundle in memory and retries
        without re-reading."""
        eng, req = rep.engine, entry.req
        bundle = entry.bundle
        if bundle is None:
            try:
                bundle = self.handoff.load(
                    entry.bundle_path,
                    expected_generation=entry.handoff_gen)
            except StaleHandoffError as e:
                # a superseded prefill's late bundle: drop it, re-prefill
                entry.bundle_path = None
                self.kvfabric.count_fallthrough(
                    getattr(e, "reason", None) or "stale")
                self._reprefill(entry, f"stale handoff bundle: {e}")
                return "requeued"
            except HandoffError as e:
                # torn/corrupt (or unreadable) bundle: the typed-error
                # contract — never adopt, never a wrong token; re-prefill.
                # The wire transport's typed errors carry .reason
                # (timeout/partition/transport); spool corruption is
                # "corrupt" — either way the fallthrough is counted typed
                entry.bundle_path = None
                self.kvfabric.count_fallthrough(
                    getattr(e, "reason", None) or "corrupt")
                self._reprefill(entry, f"handoff bundle rejected: {e}")
                return "requeued"
            entry.bundle = bundle
            entry.bundle_path = None
            # restore the continuation state from the VALIDATED bundle (not
            # from whatever the prefill side last mutated in memory): the
            # decode replica replays exactly what was committed to disk
            req.tokens = list(req.prompt) + list(bundle.tokens)
            req.n_generated = bundle.n_generated
            req.n_dispatched = bundle.n_dispatched
            if bundle.tokens:
                req.last_token = bundle.tokens[-1]
        status = eng.adopt_request(req, bundle.payloads)
        if status == "admitted":
            entry.bundle = None
            # deliver the prefill-side tokens NOW: the client's first token
            # lands here, so serving.ttft_s spans prefill queue wait +
            # transfer + adopt (the histogram's contract), and
            # the stream continues seamlessly from the engine's next block
            gen = entry.handle._gen
            req.on_token = self._make_on_token(entry.handle, gen)
            req.t_first_token = time.monotonic()
            for tok in bundle.tokens:
                req.on_token(req.rid, tok)
        elif status == "failed":
            entry.bundle = None
        return status

    def _kv_acquire(self, rep, entry):
        """Walk the fabric's tier ladder for a reusable prefix before the
        engine prefills from scratch. Pages land via the engine's OPTIONAL
        ``adopt_prefix(prompt, payload)`` seam (duck-typed — the stock
        engine's own prefix index already covers the device tier, so only
        engines that opt in adopt fabric entries). Every failure here is
        either counted inside acquire() or swallowed into recompute — this
        call can never fail an admission."""
        fab = self.kvfabric
        eng = rep.engine
        adopt = getattr(eng, "adopt_prefix", None)
        if fab is None or not fab.enabled or adopt is None:
            return
        try:
            got = fab.acquire(entry.req.prompt, eng.page_size,
                              allow_peer=self.brownout.peer_fetch_enabled())
            if got is None:
                return
            kv_entry, _tier = got
            adopt(kv_entry["prompt"], kv_entry["payload"])
        except Exception:
            # adoption is strictly best-effort; the prefill below is the
            # unconditional, bit-identical floor
            fab.count_fallthrough("adopt_failed")

    def _kv_note_admitted(self, rep, entry):
        """The entry's pages are resident on ``rep`` now: release the
        router's deferred cluster hint (a peer-routed placement only
        re-homes session stickiness once something actually landed) and
        advertise the prompt's prefix residency into the fabric. The
        engine may also export the prefix into the host spill ring via
        the optional ``export_prefix(prompt)`` seam."""
        fab = self.kvfabric
        try:
            self.router.adoption_landed(entry, rep)
        except Exception:
            pass
        if fab is None or not fab.enabled:
            return
        eng = rep.engine
        try:
            fab.advertise_prompt(entry.req.prompt, eng.page_size, rep.name)
            export = getattr(eng, "export_prefix", None)
            if export is not None:
                payload = export(entry.req.prompt)
                if payload is not None:
                    fab.spill_prefix(entry.req.prompt, eng.page_size,
                                     payload, owner=rep.name)
        except Exception:
            pass        # residency is advisory; admission already happened

    def _reprefill(self, entry, reason):
        """A handoff failed en route to (or at) the decode pool: clone the
        request and run the prefill again — bit-identical output, because
        the sampled key stream depends only on (seed, rid, index). The
        generation fence bumps so any late bundle from the superseded
        attempt is stale on arrival. After repeated handoff failures the
        request stops disaggregating and completes blended."""
        handle = entry.handle
        if entry.req.cancelled or handle._cancel_requested:
            _M_CANCELLED.inc()
            handle._cancelled_now()
            return
        gen = handle._reset_for_reroute()
        if gen is None:
            # stream already consumed — a replayed stream would splice
            _M_FAILED.inc()
            handle._fail(reason)
            return
        entry.observed = False
        entry.req = entry.req.clone_for_retry()
        entry.handoff_gen += 1
        entry.bundle = None
        entry.bundle_path = None
        if self._disagg_active() and entry.handoff_gen < 3 \
                and self._decode_pool_live():
            entry.needs_handoff = True
            entry.target_role = "prefill"
            entry.req.on_token = None
        else:
            _count_handoff_fallback("reprefill_blended")
            entry.needs_handoff = False
            entry.target_role = None
            entry.req.on_token = self._make_on_token(handle, gen)
        self._requeue(entry, exclude=set(), fail_reason=reason,
                      rerouted=True)

    def _wake(self, name):
        # .get, not []: a remove_replica can race a late wake from a
        # request that finished on the removed replica
        ev = self._wakes.get(name)
        if ev is not None:
            ev.set()

    def _cancel(self, handle):
        # flag first: if the scan below misses the request because its
        # dispatcher holds it in transit (popped from pending, not yet in
        # inflight), the dispatcher honors the flag when it re-surfaces
        handle._cancel_requested = True
        with self._lock:
            for rep in self.replicas:
                for i, e in enumerate(rep.pending):
                    if e.handle is handle:
                        rep.pending.pop(i)
                        if e.bundle_path is not None:
                            self.handoff.discard(e.bundle_path)
                            e.bundle_path = None
                        _M_CANCELLED.inc()
                        handle._cancelled_now()
                        return
                e = rep.inflight.get(handle.rid)
                if e is not None and e.handle is handle:
                    e.req.cancelled = True  # engine retires it next block
                    self._wake(rep.name)
                    return
        # already terminal or unknown: cancel() is idempotent

    # ---- dispatcher -------------------------------------------------------
    def _run_replica(self, rep):
        eng = rep.engine
        wake = self._wakes[rep.name]
        rep.thread_ident = threading.get_ident()  # for the lock-probe
        if self._warmup_kw is not None and hasattr(eng, "warmup"):
            # replica-start warmup. The lock probe spares this thread only
            # WHILE it holds/awaits a lock; warmup has unlocked windows
            # (readbacks, host work between device sections), so a sidecar
            # beat keeps the heartbeat fresh for
            # the whole bounded warmup — otherwise a warmup longer than
            # heartbeat_deadline_s gets a healthy replica killed at start.
            warm_done = threading.Event()

            def _beat_through_warmup():
                # beats are PROGRESS-gated: each newly-warm program key
                # resets the clock, so a legitimately long multi-program
                # warmup stays covered, but a warmup wedged in one hung
                # device call stops being covered after heartbeat_deadline_s
                # and falls back to the normal watchdog + lock-probe verdict
                # (a sidecar that beat unconditionally would silence the
                # watchdog for an unbounded window)
                last_n, last_t = -1, time.monotonic()
                while not warm_done.is_set():
                    n = len(getattr(eng, "_warm", ()))
                    now = time.monotonic()
                    if n != last_n:
                        last_n, last_t = n, now
                    if now - last_t > self.heartbeat_deadline_s:
                        return  # no warmup progress: let the monitor judge
                    rep.beat()
                    warm_done.wait(1.0)

            beater = threading.Thread(target=_beat_through_warmup,
                                      daemon=True,
                                      name=f"paddle-warmup-beat-{rep.name}")
            beater.start()
            try:
                eng.warmup(**self._warmup_kw)
            except BaseException as e:
                self._replica_died(rep, e)
                return
            finally:
                warm_done.set()
                beater.join(timeout=5.0)
        while not self._stop.is_set():
            rep.beat()
            rep.publish_gauges()
            try:
                # the chaos kill switch for E2E tests: an injected fault
                # here is a replica crash (dispatcher dies mid-flight)
                chaos.site("serving.replica_kill")
            except BaseException as e:
                self._replica_died(rep, e)
                return
            if rep.state == DEAD:
                return
            progressed = False
            try:
                if rep.state in ADMITTING:
                    progressed |= self._admit_pending(rep)
                if not eng.idle():
                    # chaos stall for a BUSY replica's dispatch: a delay
                    # rule here inflates step_ewma until the breaker's
                    # slow verdict trips — the deterministic "replica is
                    # 5x slower than its peers" drill
                    chaos.site("serving.replica_slow")
                    t_step = time.monotonic()
                    for r in eng.step():
                        self._finish(rep, r)
                    rep.note_step(time.monotonic() - t_step)
                    if getattr(eng, "prefill_chunk", 0):
                        # chunk-prefilling admissions observe TTFT lazily
                        # — their first token lands in a later step() than
                        # their admission did. Gated on the engine actually
                        # chunking: non-chunked engines observe at
                        # admission, and this scan would only add frontend-
                        # lock traffic per step for nothing.
                        with self._lock:
                            pend = [e for e in rep.inflight.values()
                                    if not e.observed]
                        for e in pend:
                            self._observe_admission(e)
                    if rep.role == "prefill" and rep.inflight:
                        # disaggregation: requests with a first
                        # token owe their KV pages to the decode pool
                        progressed |= self._initiate_handoffs(rep)
                    progressed = True
                elif rep.state == DRAINING and not rep.inflight:
                    drained = self._drained.get(rep.name)
                    if drained is not None:  # vs a racing remove_replica
                        drained.set()
            except BaseException as e:
                # anything escaping the engine hooks is replica-fatal (the
                # hooks isolate request-level failures internally).
                # BaseException, not Exception: _admit_pending re-raises
                # BaseException after re-appending the in-transit entry, and
                # a SystemExit/KeyboardInterrupt on this thread must mark
                # the replica DEAD and relocate its work — a silently dead
                # dispatcher would leave the replica LIVE and its requests
                # hanging until the heartbeat deadline
                self._replica_died(rep, e)
                return
            if not progressed:
                # unlocked len() is a heuristic only: submit/_requeue append
                # BEFORE setting the wake event, so a stale empty read still
                # wakes immediately off the event
                idle = eng.idle() and not rep.pending
                if _tracing.enabled():
                    # serving goodput: dispatcher waits
                    # are the 'idle' slice of the serving wall-clock split
                    t_w = time.monotonic()
                    wake.wait(self.idle_wait_s if idle else self.poll_wait_s)
                    _goodput.serving_note("idle", time.monotonic() - t_w)
                else:
                    wake.wait(self.idle_wait_s if idle else self.poll_wait_s)
                wake.clear()

    def _admit_pending(self, rep):
        eng, moved = rep.engine, False
        while rep.state in ADMITTING and eng.has_free_slot():
            cap = self.brownout.prefill_depth_cap()
            if cap is not None:
                ap = getattr(eng, "active_prefills", None)
                if ap is not None and ap() >= cap:
                    # shed_prefill_depth rung (cheapest brownout step): a
                    # replica already advancing `cap` chunked prefills
                    # defers new admissions so in-flight decode keeps its
                    # cadence; nothing is rejected, prompts just queue
                    break
            with self._lock:
                i = self.scheduler.pick(rep.pending)
                if i is None:
                    break
                entry = rep.pending.pop(i)
                _M_QUEUE.set(sum(len(r.pending) for r in self.replicas))
            if entry.handle._cancel_requested:
                _M_CANCELLED.inc()
                entry.handle._cancelled_now()
                moved = True
                continue
            if self.scheduler.expired(entry):
                _M_EXPIRED.inc()
                _M_FAILED.inc()
                if entry.bundle_path is not None:
                    self.handoff.discard(entry.bundle_path)
                    entry.bundle_path = None
                self.slo.observe_event(entry.slo.name, "deadline_miss", True)
                mon = self._tenant_monitor(entry.tenant)
                if mon is not None:
                    mon.observe_event(entry.slo.name, "deadline_miss", True)
                entry.handle._fail(DeadlineExceeded(
                    f"request {entry.req.rid} ({entry.slo.name}) spent "
                    f"longer than its deadline queued"))
                moved = True
                continue
            # while the entry is in neither pending nor inflight, a death/
            # drain sweep cannot see it — every exit below must put it back
            # somewhere sweepable (or hand it to the relocation path) before
            # giving up the thread, or its handle would hang forever
            try:
                if entry.bundle_path is not None or entry.bundle is not None:
                    # a handed-off request: adopt its KV-page bundle into
                    # this replica's pool instead of prefilling from scratch
                    status = self._adopt_one(rep, entry)
                else:
                    # cluster KV fabric: before prefilling from
                    # scratch, try the tier ladder (host spill -> peer
                    # fetch) for a reusable prefix; any failure falls
                    # through to the recompute below, bit-identically
                    self._kv_acquire(rep, entry)
                    status = eng.try_admit_one(entry.req)
            except BaseException:
                # the raise is about to reach _run_replica, whose handler
                # calls _replica_died -> sweeps pending. That sweep is a
                # no-op if the monitor/kill() ALREADY declared the replica
                # DEAD while we were stuck in the engine call — an entry
                # re-appended then would never be swept again, so hand it
                # straight to the relocation path instead
                with self._lock:
                    already_dead = rep.state == DEAD
                    if not already_dead:
                        rep.pending.append(entry)  # swept by _replica_died
                if already_dead:
                    self._requeue(entry, exclude={rep.name},
                                  fail_reason=f"replica {rep.name} died "
                                              f"during admission: "
                                              f"{rep.death_reason}")
                raise
            if status == "requeued":
                # corrupt/stale bundle: _adopt_one already sent the entry
                # back through _requeue for a bit-identical re-prefill
                moved = True
                continue
            if status != "deferred" and entry.queue_span is not None:
                # queueing ends the moment the engine resolved the
                # admission (a deferred pick keeps waiting — span stays
                # open); the engine's own admit/prefill spans carry on
                entry.queue_span.end()
                entry.queue_span = None
            if status == "deferred":
                with self._lock:
                    stranded = rep.state not in ADMITTING
                    if not stranded:
                        rep.pending.append(entry)
                if stranded:  # the sweep ran while we held the entry
                    self._requeue(entry, exclude={rep.name},
                                  fail_reason=f"{rep.name} became "
                                              f"{rep.state} during admission")
                elif self._stop.is_set():
                    # shutdown's orphan sweep may have already swept this
                    # pending list while the entry was in transit; failing
                    # directly is idempotent with the sweep
                    entry.handle._fail("frontend shut down")
                break
            moved = True
            if status == "admitted":
                with self._lock:
                    dead = rep.state == DEAD
                    if not dead:
                        rep.inflight[entry.req.rid] = entry
                entry.handle._mark_running(rep.name)
                self._observe_admission(entry)
                self._kv_note_admitted(rep, entry)
                if entry.handle._cancel_requested:
                    entry.req.cancelled = True  # retires at next block
                if dead:  # death sweep missed the in-transit entry
                    self._relocate_inflight(entry, rep,
                                            f"replica {rep.name} died: "
                                            f"{rep.death_reason}")
                    break
                if self._stop.is_set():
                    # same transit race against shutdown's sweep
                    entry.handle._fail("frontend shut down")
                    break
            elif status == "done":
                entry.handle._mark_running(rep.name)
                self._observe_admission(entry)
                self._kv_note_admitted(rep, entry)
                self._finish(rep, entry.req, entry=entry)
            else:  # "failed"
                if entry.probe:
                    # half-open probes are diagnostic traffic (breaker.py
                    # contract): the breaker observed the failure; the
                    # caller must not eat it — an unconsumed request
                    # re-runs bit-identically on a healthy replica
                    self._breaker_outcome(rep, entry, ok=False)
                    self._relocate_inflight(
                        entry, rep, f"probe failed on {rep.name}: "
                                    f"{entry.req.error_message}")
                else:
                    _M_FAILED.inc()
                    entry.handle._fail(entry.req.error_message)
                    self._breaker_outcome(rep, entry, ok=False)
        return moved

    def _finish(self, rep, req, entry=None):
        if entry is None:
            with self._lock:
                entry = rep.inflight.pop(req.rid, None)
            if entry is None:
                return  # already resolved (reroute/cancel race)
        # a chunk-prefilling request that graduates AND retires in the same
        # engine step leaves inflight before the dispatcher's lazy TTFT
        # scan can see it — observe here (idempotent; skips entries that
        # never produced a first token)
        self._observe_admission(entry)
        if entry.needs_handoff:
            # finished before the handoff could initiate (short generation,
            # eos at the first block): blended completion — deliver the
            # suppressed tokens to the stream before the terminal transition
            if req.error is None and not req.cancelled:
                self._handoff_fallback(entry, "finished_on_prefill")
            else:
                entry.needs_handoff = False
        handle = entry.handle
        if req.error is not None:
            if entry.probe:
                # breaker.py contract: a failed probe is observed by the
                # breaker (below may even fail the replica hard) but the
                # CALLER does not eat it — unconsumed requests re-run
                # bit-identically elsewhere, consumed streams fail cleanly
                self._breaker_outcome(rep, entry, ok=False)
                self._relocate_inflight(
                    entry, rep,
                    f"probe failed on {rep.name}: {req.error_message}")
                return
            _M_FAILED.inc()
            handle._fail(req.error_message)
            self._breaker_outcome(rep, entry, ok=False)
        elif req.cancelled:
            _M_CANCELLED.inc()
            handle._cancelled_now()  # caller's choice: no breaker signal
        else:
            _M_COMPLETED.inc()
            self._observe_completion(entry)
            self.slo.observe_event(entry.slo.name, "deadline_miss", False)
            mon = self._tenant_monitor(entry.tenant)
            if mon is not None:
                mon.observe_event(entry.slo.name, "deadline_miss", False)
            handle._complete(req)
            self._breaker_outcome(rep, entry, ok=True)

    # ---- replica death / drain -------------------------------------------
    def kill(self, replica, reason="killed by operator"):
        """Declare a replica dead NOW (ops/test hook — the same path chaos
        and the heartbeat monitor take)."""
        self._replica_died(self._resolve_replica(replica),
                           RuntimeError(reason))

    def drain(self, replica, timeout=30.0):
        """Stop routing to ``replica``, finish its in-flight requests, and
        re-queue its pending (not-yet-admitted) requests onto the other
        replicas. Returns True once the replica is idle (False on timeout).
        The replica stays DRAINING — call revive() to return it to LIVE."""
        rep = self._resolve_replica(replica)
        with self._lock:
            if rep.state == DEAD:
                raise ValueError(f"{rep.name} is DEAD, nothing to drain")
            rep.state = DRAINING
            self._drained[rep.name].clear()
            pending, rep.pending = rep.pending, []
        for entry in pending:
            _M_DRAIN_REQUEUED.inc()
            self._requeue(entry, exclude={rep.name},
                          fail_reason=f"{rep.name} draining")
        self._wake(rep.name)
        # the DRAINED signal comes from the dispatcher thread only: it is
        # the one thread that can hold an entry in transit between pending
        # and inflight, so its own idle check can never fire early
        return self._drained[rep.name].wait(timeout)

    def revive(self, replica):
        """DRAINING/PROBATION -> LIVE (a drained or circuit-broken replica
        rejoining the pool by operator fiat)."""
        rep = self._resolve_replica(replica)
        with self._lock:
            if rep.state == DEAD:
                raise ValueError(f"{rep.name} is DEAD; spawn a replacement "
                                 f"(add_replica) instead of reviving")
            was_probation = rep.state == PROBATION
            rep.state = LIVE
        if was_probation:
            # fresh slate: leaving the probing state without the breaker's
            # own close verdict would otherwise leave its score stuck in
            # half-open — record()/note_slow() no-op while probing, so the
            # revived replica could never trip again
            self.breaker.forget(rep.name)
        self._wake(rep.name)

    def _resolve_replica(self, replica):
        if isinstance(replica, ReplicaHandle):
            return replica
        try:
            return self._by_name[replica]
        except KeyError:
            raise ValueError(f"unknown replica {replica!r}; have "
                             f"{sorted(self._by_name)}") from None

    def _replica_died(self, rep, exc):
        """Mark DEAD and relocate its work: queued + unconsumed in-flight
        requests re-route (identical outputs — key streams are replica-
        independent); consumed streams fail with the death reason."""
        with self._lock:
            if rep.state == DEAD:
                return
            rep.state = DEAD
            rep.death_reason = f"{type(exc).__name__}: {exc}"
            pending, rep.pending = rep.pending, []
            inflight, rep.inflight = list(rep.inflight.values()), {}
        _M_REPLICA_DEAD.inc()
        self.router.forget_replica(rep.name)
        self.breaker.forget(rep.name)
        # a corpse must neither attract fabric-aware placements nor be
        # dialed for peer fetches: drop its residency advertisements
        self.kvfabric.evict_replica(rep.name)
        reason = f"replica {rep.name} died: {rep.death_reason}"
        for entry in pending:
            self._requeue(entry, exclude={rep.name}, fail_reason=reason)
        for entry in inflight:
            self._relocate_inflight(entry, rep, reason)

    def _relocate_inflight(self, entry, rep, reason):
        """One in-flight entry whose replica just died: honor a racing
        cancel, fail a consumed stream (a restart would duplicate or reorder
        observed tokens), transparently re-route anything else (identical
        output — key streams are replica-independent)."""
        if entry.req.cancelled or entry.handle._cancel_requested:
            # the cancel raced the death: honor it now instead of rerouting
            # a request nobody wants (the clone would not carry the flag)
            _M_CANCELLED.inc()
            entry.handle._cancelled_now()
            return
        gen = entry.handle._reset_for_reroute()
        if gen is None:  # stream consumed — only a clean failure is safe
            _M_FAILED.inc()
            entry.handle._fail(reason)
            return
        # the clone keeps t_enqueue so the NEXT admission's queue_wait/ttft
        # samples span the whole journey including the dead replica's time
        # (clone_for_retry's contract) — re-arm the once-only observation
        entry.observed = False
        entry.req = entry.req.clone_for_retry()
        # disaggregation: a dead replica invalidates whatever
        # handoff state the entry carried — drop any unconsumed bundle and
        # bump the generation fence so a superseded prefill's late bundle
        # is stale on arrival, then re-arm the handoff if the fleet still
        # disaggregates (else complete blended, tokens streaming normally)
        if entry.bundle_path is not None:
            self.handoff.discard(entry.bundle_path)
        entry.bundle = None
        entry.bundle_path = None
        entry.handoff_gen += 1
        if self._disagg_active() and entry.handoff_gen < 3 \
                and self._decode_pool_live():
            entry.needs_handoff = True
            entry.target_role = "prefill"
            entry.req.on_token = None
        else:
            if entry.needs_handoff or entry.target_role is not None:
                _count_handoff_fallback("replica_died")
            entry.needs_handoff = False
            entry.target_role = None
            entry.req.on_token = self._make_on_token(entry.handle, gen)
        self._requeue(entry, exclude={rep.name}, fail_reason=reason,
                      rerouted=True)

    def _requeue(self, entry, exclude, fail_reason, rerouted=False):
        if entry.handle.done():
            return
        # status flips BEFORE the entry becomes visible in a pending list:
        # flipping after the append races the target dispatcher, whose
        # _mark_running could land first and be clobbered back to QUEUED
        # for the rest of the request's run
        entry.handle._mark_queued()
        exclude = set(exclude)
        # the trace's reroute edge: the attempt on the excluded replica is
        # over (death, drain, strand) — close it and stamp the edge before
        # the replacement attempt opens
        self._trace_reroute(entry, next(iter(exclude), None), fail_reason)
        while True:
            try:
                target = self.router.place(entry, self.replicas,
                                           exclude=exclude)
            except Exception as e:  # NoLiveReplicas, chaos faults, ...
                _M_FAILED.inc()
                entry.handle._fail(f"{fail_reason}; re-route failed: {e}")
                return
            self._trace_commit(entry, target)
            with self._lock:
                # re-check under the lock: the target can die or start
                # draining between place() and here, and an entry appended
                # to a swept pending list would never be seen again — same
                # for shutdown's orphan sweep (the monitor thread can still
                # be relocating a dead replica's work while it runs)
                if self._stop.is_set():
                    shut_down = True
                else:
                    shut_down = False
                    if target.state == LIVE or (entry.probe
                                                and target.state == PROBATION):
                        target.pending.append(entry)
                        break
            if shut_down:
                # idempotent with the sweep: _fail is once-only
                _M_FAILED.inc()
                entry.handle._fail("frontend shut down")
                return
            self._trace_attempt_end(entry, "rerouted",
                                    reason=f"{target.name} not LIVE")
            exclude.add(target.name)
        self.router.committed(entry, target)
        if rerouted:
            _M_REROUTED.inc()
        self._wake(target.name)

    def _run_monitor(self):
        """Heartbeat watchdog over the dispatcher threads: a replica whose
        dispatcher stops beating (wedged in a device call, killed by a
        chaos fault that swallowed the thread) is declared DEAD so its
        requests relocate instead of hanging their handles forever. Also
        the control cadence for the closed loops: per-replica
        dispatch-pace verdicts feed the circuit breaker, and the fleet
        pressure sample drives the brownout ladder."""
        while not self._stop.is_set():
            now = time.monotonic()
            for rep in self.replicas:
                self._check_replica_liveness(rep, now)
                # fabric residency rollup feed: stamped here so
                # the replica snapshot (and the fleet aggregator's
                # fleet.serving.kv_resident sum) tracks the fabric map
                # without a lock — single monitor writer, advisory reads
                rep.kv_resident = self.kvfabric.residency_count(rep.name)
                # capacity advertisement: the fabric
                # ranks peer fetches by this load signal and skips
                # saturated peers entirely
                try:
                    self.kvfabric.set_peer_load(rep.name, rep.load())
                except Exception:
                    pass  # a mid-death replica must not wedge the monitor
            self._check_replica_pace()
            self.brownout.observe(self._pressure())
            # per-tenant isolation: each tenant's private
            # ladder follows its OWN pressure (bucket drain, inflight
            # cap) — a storming tenant browns out alone while the fleet
            # ladder, fed above, stays wherever fleet pressure puts it
            for t in self.tenants.tenants():
                t.brownout.observe(t.pressure())
            self._stop.wait(self.monitor_interval_s)

    def _check_replica_liveness(self, rep, now):
        """One monitor verdict for one replica (factored out so tests can
        drive it with crafted lock/beat states). Flap damping: the DEAD verdict needs ``heartbeat_misses`` CONSECUTIVE
        stale observations — a beat that recovers in between was a flap
        (one slow scrape, a GC pause), counted on ``serving.replica_flaps``
        instead of triggering a full reroute storm."""
        if rep.state == DEAD:
            return
        if now - rep.last_beat <= self.heartbeat_deadline_s:
            if rep.missed_beats:
                _M_FLAPS.inc()
                rep.missed_beats = 0
            return
        # Lock decomposition: device sections serialize on the replica's
        # OWN engine lock; only first kernel builds take the shared
        # process-wide compile lock, where N serialized builds can silence
        # a dispatcher for the SUM of build times. A replica whose
        # dispatcher participates in EITHER lock (holder or blocked
        # acquirer) under a hold younger than the deadline is compiling or
        # queued behind a compile, not dead — defer the (irreversible)
        # verdict. Both conditions matter: a dispatcher wedged OUTSIDE the
        # locks (post-readback host work, a blocking user callback) must
        # not ride out its verdict on other threads' healthy compiles, and
        # a hold OLDER than the deadline is itself a hung device call —
        # deferring then would hang every handle forever, so the verdict
        # proceeds and the work relocates (or, once every blocked replica
        # is declared, fails cleanly).
        locks = [_COMPILE_LOCK]
        own = getattr(rep.engine, "dispatch_lock", None)
        if own is not None:
            locks.append(own)
        for lock in locks:
            if rep.thread_ident in lock.participants():
                held = lock.held_since()
                if held is None or now - held <= self.heartbeat_deadline_s:
                    _M_SPARED.inc()
                    return  # compiling, or queued behind a fresh hold
        rep.missed_beats += 1
        if rep.missed_beats < self.heartbeat_misses:
            return  # damped: not dead until the miss budget runs out
        self._replica_died(rep, TimeoutError(
            f"dispatcher heartbeat stale {now - rep.last_beat:.1f}s "
            f"(> {self.heartbeat_deadline_s}s) for {rep.missed_beats} "
            f"consecutive monitor checks"))

    def _check_replica_pace(self):
        """Per-tick dispatch-latency verdicts for the circuit breaker: a
        LIVE replica whose step EWMA exceeds ``slow_ratio`` x the
        cross-replica median (the compute-straggler classification
        applied to serving dispatch) collects a slow strike; enough
        consecutive strikes trip it into PROBATION."""
        reps = [r for r in self.replicas
                if r.state == LIVE and r.step_samples >= 3]
        if len(reps) < 2:
            return  # no peers to be slower than
        ewmas = sorted(r.step_ewma for r in reps)
        # LOWER median: with an even replica count the upper median IS the
        # slowest minority member (2 replicas: the straggler itself, which
        # can never exceed slow_ratio x its own pace) — the lower median
        # stays anchored on the healthy majority
        median = ewmas[(len(ewmas) - 1) // 2]
        if median <= 0.0:
            return
        ratio = self.breaker.policy.slow_ratio
        for r in reps:
            if r.step_ewma > ratio * median:
                if self.breaker.note_slow(r.name) == "trip":
                    self._trip_replica(r)
            else:
                self.breaker.note_on_pace(r.name)

    def _pressure(self):
        """The brownout ladder's input: the fleet rollup's pressure blend
        (mean LIVE occupancy vs queue/slots) without the report machinery
        — cheap enough for every monitor tick. Computed PER ROLE and the
        worst pool wins: a saturated prefill pool must engage
        the shed rungs even when an idle decode pool would dilute a
        fleet-wide mean to comfortable."""
        worst = 0.0
        for _, occs, slots, queued in self._pressure_by_role():
            queue_pressure = (min(1.0, queued / slots) if slots
                              else (1.0 if queued else 0.0))
            occupancy = sum(occs) / len(occs) if occs else 0.0
            worst = max(worst, occupancy, queue_pressure)
        return worst

    def _pressure_by_role(self):
        """[(role, live_occupancies, live_slots, queued)] per replica role
        — the shared accumulation under _pressure and the supervisor's
        per-role scale pressure."""
        by_role = {}
        for r in self.replicas:
            occs, slots, queued = by_role.get(r.role, ([], 0, 0))
            queued += len(r.pending)
            if r.state == LIVE:
                occs.append(r.engine.active_count() / r.engine.max_seqs)
                slots += r.engine.max_seqs
            by_role[r.role] = (occs, slots, queued)
        return [(role, occs, slots, queued)
                for role, (occs, slots, queued) in by_role.items()]

    # ---- circuit breaking --------------------------------------
    def _breaker_outcome(self, rep, entry, ok):
        """One request outcome lands on the breaker; its verdicts become
        replica state transitions (every state write under self._lock).
        Probe outcomes drive the half-open ladder; normal outcomes feed
        the windowed error score."""
        if entry.probe:
            verdict = self.breaker.probe_result(rep.name, ok)
            if verdict == "close":
                with self._lock:
                    if rep.state == PROBATION:
                        rep.state = LIVE
                self._wake(rep.name)
            elif verdict == "fail_hard":
                self._replica_died(rep, RuntimeError(
                    f"circuit breaker: "
                    f"{self.breaker.policy.probation_failures} consecutive "
                    f"probe failures after trip"))
            return
        if self.breaker.record(rep.name, ok) == "trip":
            self._trip_replica(rep)

    def _trip_replica(self, rep):
        """LIVE -> PROBATION: normal routing stops (the router only sends
        rate-limited probes), the pending queue re-routes to healthy
        replicas NOW — in-flight work finishes where it is (retiring it
        would waste the decode slots it already paid for)."""
        with self._lock:
            if rep.state != LIVE:
                return
            rep.state = PROBATION
            pending, rep.pending = rep.pending, []
        reason = (self.breaker.tripped_reason(rep.name)
                  or "circuit breaker tripped")
        for entry in pending:
            self._requeue(entry, exclude={rep.name},
                          fail_reason=f"{rep.name} tripped: {reason}")

    # ---- fleet membership -------
    def add_replica(self, engine, name=None, domain=None, fence=None,
                    role="blended"):
        """Grow the pool by one replica (the supervisor's spawn path; also
        an ops hook). The dispatcher starts immediately when the frontend
        is running. ``domain`` groups replicas into failure domains for
        the supervisor's restart budgets; ``fence`` is the supervisor's
        generation fence (``ReplicaFence``), refusing a superseded
        incarnation's telemetry writes; ``role`` joins the replica to a
        disaggregation pool ("prefill"/"decode"/"blended")."""
        with self._lock:
            if self._stop.is_set():
                raise RuntimeError("frontend is shut down")
            idx = self._next_index
            self._next_index += 1
            rep = ReplicaHandle(name or f"replica{idx}", engine, index=idx,
                                role=role)
            if rep.name in self._by_name:
                raise ValueError(f"replica name {rep.name!r} already exists")
            rep.domain = domain or rep.name
            rep.fence = fence
            self._wakes[rep.name] = threading.Event()
            self._drained[rep.name] = threading.Event()
            # copy-on-write: unlocked readers iterate either the old or
            # the new list, never a half-mutated one
            self.replicas = self.replicas + [rep]
            self._by_name[rep.name] = rep
            started = self._started
        if started:
            # prune exited dispatchers (removed/replaced replicas) so a
            # long-running supervisor's churn can't grow this list —
            # shutdown() joins it in full
            self._threads = [t for t in self._threads if t.is_alive()]
            t = threading.Thread(target=self._run_replica, args=(rep,),
                                 daemon=True,
                                 name=f"paddle-serving-{rep.name}")
            self._threads.append(t)
            t.start()
        return rep

    def remove_replica(self, replica):
        """Drop a DEAD (or drained DRAINING) replica from the pool and
        retire its labeled gauges — the supervisor's cleanup after a
        replacement or scale-down. Refuses replicas still holding work:
        drain() first."""
        rep = self._resolve_replica(replica)
        with self._lock:
            if rep.state not in (DEAD, DRAINING):
                raise ValueError(f"{rep.name} is {rep.state}; drain() or "
                                 f"kill() it before removing")
            if rep.pending or rep.inflight:
                raise ValueError(
                    f"{rep.name} still holds work ({len(rep.pending)} "
                    f"pending, {len(rep.inflight)} in flight) — drain() it")
            rep.state = DEAD  # a DRAINING dispatcher exits on next wake
            self.replicas = [r for r in self.replicas if r is not rep]
            self._by_name.pop(rep.name, None)
        self._wake(rep.name)
        self._wakes.pop(rep.name, None)
        self._drained.pop(rep.name, None)
        self.router.forget_replica(rep.name)
        self.breaker.forget(rep.name)
        self.kvfabric.evict_replica(rep.name)
        rep.retire_gauges()

    def fleet_signal(self):
        """The autoscaler's read: just the ``serving_report()["fleet"]``
        rollup (pressure / scale_hint / worst burn) without the rest of
        the report machinery — what the supervisor polls per tick."""
        with self._lock:
            replicas = {r.name: r.snapshot() for r in self.replicas}
        return _fleet.serving_rollup(replicas, self.slo.report(),
                                     _goodput.serving.report())

    # ---- request-scoped tracing ---------------------------------
    def _trace_commit(self, entry, rep):
        """One placement landed (or is about to): open the attempt subtree
        — attempt span, place event (replica/score/affinity), queue span —
        and hand the attempt span to the EngineRequest so the engine's
        admit/prefill/decode spans nest under it."""
        tr = entry.trace
        if tr is None:
            return
        n = entry.attempt_n
        entry.attempt_n = n + 1
        entry.attempt_span = tr.root.child("attempt", n=n, replica=rep.name)
        entry.attempt_span.event(
            "place", replica=rep.name, affinity=entry.route_affinity,
            score=round(entry.route_score, 4))
        entry.queue_span = entry.attempt_span.child(
            "queue",
            slo=entry.slo.name,
            virtual_deadline_in_s=round(
                entry.virtual_deadline - entry.req.t_enqueue, 4))
        entry.req.trace = entry.attempt_span

    def _trace_attempt_end(self, entry, status, reason=None):
        """Close the open attempt subtree (reroute, drain, lost placement
        race). Idempotent; the handle's terminal finish() sweeps anything
        this missed."""
        if entry.trace is None or entry.attempt_span is None:
            return
        if entry.queue_span is not None:
            entry.queue_span.end(status)
            entry.queue_span = None
        entry.attempt_span.end(
            status, **({"reason": str(reason)} if reason else {}))
        entry.attempt_span = None

    def _trace_reroute(self, entry, from_replica, reason):
        """The reroute edge: close the failed attempt, stamp the edge on
        the root — trace_view renders failed attempt -> reroute -> replay
        as one tree."""
        if entry.trace is None:
            return
        self._trace_attempt_end(entry, "failed", reason=reason)
        entry.trace.root.event("reroute", from_replica=from_replica,
                               reason=str(reason))

    # ---- telemetry --------------------------------------------------------
    def _class_hist(self, family, slo_name, tenant=None):
        # short kind key for serving_report's per-class section; the third
        # key element is the tenant name (None = the fleet-wide series —
        # byte-identical labels to the pre-tenancy plane)
        key = (family[len("serving."):], slo_name,
               tenant.name if tenant is not None else None)
        with self._lock:  # dispatchers insert, serving_report() iterates
            h = self._class_hists.get(key)
            if h is None:
                # labeled series: one family per kind,
                # {slo_class=...} per class — scrapers aggregate across
                # classes, which per-class metric NAMES made impossible.
                # The tenant label is BOUNDED by construction:
                # only a declared Tenant's .name ever reaches a labels
                # dict (the tenant-label-bounded analysis rule pins this)
                if tenant is not None:
                    labels = {"slo_class": slo_name, "tenant": tenant.name}
                else:
                    labels = {"slo_class": slo_name}
                h = self._class_hists[key] = _registry.histogram(
                    family, labels=labels,
                    help="per-SLO-class control-plane latency")
            return h

    def _tenant_monitor(self, tenant):
        """The tenant's lazily-minted SLO burn-rate monitor; None for the
        default tenant (its traffic stays on the fleet monitor alone —
        the pre-tenancy gauge series must not change shape)."""
        if tenant is None or tenant.name == DEFAULT_TENANT:
            return None
        with self._lock:
            mon = self._tenant_slo.get(tenant.name)
            if mon is None:
                mon = self._tenant_slo[tenant.name] = SLOMonitor(
                    classes=self.scheduler.classes.values(),
                    gauge_labels={"tenant": tenant.name})
            return mon

    def _observe_admission(self, entry):
        if entry.observed:
            return  # once per admission (reroutes re-arm the flag so the
            # failover tail lands in the histograms)
        if entry.needs_handoff or entry.bundle_path is not None \
                or entry.bundle is not None:
            return  # mid-handoff: the client has seen no
            # token yet — TTFT is observed at decode-side delivery so the
            # prefill queue wait AND the transfer land in the histogram
        if entry.req.t_first_token is None:
            return  # chunked prefill still streaming: no first token yet —
            # the dispatcher re-checks after every step()
        entry.observed = True
        req, name = entry.req, entry.slo.name
        queue_wait = req.t_admit - req.t_enqueue
        ttft = req.t_first_token - req.t_enqueue
        self._class_hist("serving.queue_wait_s", name).observe(queue_wait)
        self._class_hist("serving.ttft_s", name).observe(ttft)
        self.slo.observe(name, "ttft", ttft)
        mon = self._tenant_monitor(entry.tenant)
        if mon is not None:
            # tenant-labeled twins of the fleet series: the
            # fleet histograms above keep EVERY request, so aggregation
            # never depends on summing tenant slices
            self._class_hist("serving.queue_wait_s", name,
                             tenant=entry.tenant).observe(queue_wait)
            self._class_hist("serving.ttft_s", name,
                             tenant=entry.tenant).observe(ttft)
            mon.observe(name, "ttft", ttft)

    def _observe_completion(self, entry):
        req = entry.req
        if req.n_generated > 1 and req.t_first_token is not None:
            tpot = (req.t_done - req.t_first_token) / (req.n_generated - 1)
            self._class_hist("serving.tpot_s", entry.slo.name).observe(tpot)
            self.slo.observe(entry.slo.name, "tpot", tpot)
            mon = self._tenant_monitor(entry.tenant)
            if mon is not None:
                self._class_hist("serving.tpot_s", entry.slo.name,
                                 tenant=entry.tenant).observe(tpot)
                mon.observe(entry.slo.name, "tpot", tpot)

    def serving_report(self):
        """One structured snapshot of the whole control plane: per-replica
        health/occupancy, per-SLO-class latency summaries, and every
        serving.* counter — the operator's `kubectl describe` for the
        serving cell."""
        with self._lock:
            hists = sorted(
                self._class_hists.items(),
                key=lambda kv: tuple(str(k) for k in kv[0]))
            replicas = {r.name: r.snapshot() for r in self.replicas}
        # fleet-wide series only (tenant key None) — the tenant-labeled
        # twins land in the "tenants" section below, so this block stays
        # byte-compatible with the pre-tenancy report
        classes = {}
        for (kind, name, tname), h in hists:
            if tname is None:
                classes.setdefault(name, {})[kind] = _hist_summary(h)
        counters = {n: _registry.get(n).value for n in _registry.names("serving.")
                    if hasattr(_registry.get(n), "value")
                    and not hasattr(_registry.get(n), "hwm")}
        slo_report = self.slo.report()
        goodput_report = _goodput.serving.report()
        out = {
            "replicas": replicas,
            "slo_classes": classes,
            "counters": {k: v for k, v in counters.items() if v},
            "queue_depth": sum(len(r.pending) for r in self.replicas),
            # SLO burn rates + multi-window alerts
            "slo": slo_report,
            # serving goodput split: engine wall clock
            # classified {prefill, decode, host_emit, idle, compile};
            # populated when telemetry is enabled (the goodput gate)
            "goodput": goodput_report,
            # cluster serving rollup: live replicas, cluster
            # queue/occupancy, worst multi-window burn, and ONE blended
            # pressure/scale_hint signal — what an autoscaler reads
            "fleet": _fleet.serving_rollup(replicas, slo_report,
                                           goodput_report),
            # compile ledger + device-memory budget: first-dispatch counts,
            # churn alerts, and KV-pool/params bytes vs device capacity
            "compile": _compilemem.ledger.report(recent=8),
            "memory": _compilemem.memory.report(),
            # closed-loop state: the brownout ladder's rung +
            # history and the circuit breaker's per-replica scores
            "brownout": self.brownout.report(),
            "breaker": self.breaker.report(),
            # device-time attribution: per-program
            # device-seconds / MFU / roofline verdicts and the decode
            # device-s-per-token budget ({"enabled": False} while the
            # devprof plane is disarmed)
            "devprof": _devprof.serving_block(),
            # cluster KV fabric: tier hit/fallthrough counters,
            # spill-ring occupancy, and the residency map (/kvz's payload)
            "kv": self.kvfabric.report(),
            # multi-tenant plane: per-tenant quota/bucket/
            # inflight state, private brownout rung, lazily-minted SLO
            # burn rates, and tenant-labeled latency summaries — also
            # served standalone at /tenantz
            "tenants": self.tenant_report(),
            # LoRA adapter host cache: residency, bytes, and
            # per-adapter inflight pins
            "adapters": self.adapters.report(),
        }
        if self.supervisor is not None:
            out["supervisor"] = self.supervisor.report()
        return out

    def tenant_report(self):
        """Per-tenant rollup — ``serving_report()["tenants"]`` and the
        ``/tenantz`` payload: each declared tenant's quota/bucket/inflight
        state and private brownout ladder (``Tenant.report()``), plus its
        SLO burn-rate monitor and tenant-labeled latency summaries when
        the tenant has produced observations."""
        with self._lock:
            hists = list(self._class_hists.items())
            mons = dict(self._tenant_slo)
        latency = {}
        for (kind, name, tname), h in hists:
            if tname is not None:
                latency.setdefault(tname, {}).setdefault(
                    name, {})[kind] = _hist_summary(h)
        out = {}
        for t in self.tenants.tenants():
            rep = t.report()
            mon = mons.get(t.name)
            if mon is not None:
                rep["slo"] = mon.report()
            lat = latency.get(t.name)
            if lat:
                rep["latency"] = lat
            out[t.name] = rep
        return out
