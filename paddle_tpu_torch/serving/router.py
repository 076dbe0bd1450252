"""Multi-replica placement: prefix-cache affinity blended with load, plus
replica health (the port's own copy of ``paddle_tpu/serving/router.py``).

Above a fast attention kernel, serving throughput is won in the layer that
decides where a request runs. Two requests sharing a system prompt served
by the same replica cost one prefill and a page-table pointer; scattered
across replicas they cost two full prefills and double the pool pressure.
The router therefore scores every LIVE replica as

    score = affinity_weight * prefix_fraction        # indexed pages NOW
          + hint_weight     * session_hint           # where this prefix went
          - load_weight     * replica.load()         # slots + pages + queue

and places on the argmax. ``prefix_fraction`` probes the engine's
content-addressed prefix index (read-only dict lookups, safe against the
dispatcher thread). The *session hint* covers the race the index can't:
the second request of a new prefix usually arrives before the first
finishes prefilling, so the hint table remembers which replica the prefix
was last routed to and keeps the session sticky.

Health is a four-state ladder per replica: ``LIVE`` (routable),
``PROBATION`` (circuit-broken: only rate-limited probe traffic routes
there, see serving/breaker.py), ``DRAINING`` (finishes in-flight work,
admits nothing, receives no new placements), ``DEAD`` (gone; its queue is
rerouted). Every dispatcher loop stamps :meth:`ReplicaHandle.beat`, and
the frontend's monitor declares a replica DEAD when its beat stays stale
for ``heartbeat_misses`` consecutive monitor checks (flap damping: one slow
check is a counted flap, ``serving.replica_flaps``, not a death).

A handle's generation ``fence`` belongs to the replica supervisor, which
comes with the operator plane (ROADMAP.md, slice 16): until then it stays
None and :meth:`ReplicaHandle.fence_writable` admits every write. The
heartbeat files and fleet snapshots a replica writes under
``PADDLE_TELEMETRY_DIR`` come with that plane too.

Chaos site ``serving.route`` fires on every placement decision so tests can
inject routing outages; ``serving.replica_kill`` (in the frontend's
dispatcher loop) kills a replica mid-flight; ``serving.replica_slow`` (in
the dispatcher's step path) stalls a busy replica's dispatch.
"""
import threading
import time

from ..observability.metrics import registry as _registry
from ..testing import chaos

__all__ = ["LIVE", "PROBATION", "DRAINING", "DEAD", "NoLiveReplicas",
           "ReplicaHandle", "Router"]

LIVE = "LIVE"
PROBATION = "PROBATION"
DRAINING = "DRAINING"
DEAD = "DEAD"

#: states a dispatcher admits work from its pending list in (PROBATION
#: admits only what the breaker's probe budget routed there)
ADMITTING = (LIVE, PROBATION)

_M_ROUTED = _registry.counter("serving.routed")
_M_AFFINITY_PLACED = _registry.counter("serving.routed_by_affinity")


class NoLiveReplicas(RuntimeError):
    """Every replica is DRAINING or DEAD — nothing can take the request."""


class ReplicaHandle:
    """One engine replica as the control plane sees it: the engine, its
    pending (routed-but-not-admitted) queue, health state, and liveness
    beats. All mutable fields are guarded by the frontend's lock except
    ``last_beat`` (a monotonic float stamped only by the dispatcher and read
    by the monitor — a benign single-writer race)."""

    def __init__(self, name, engine, index=0, role="blended"):
        self.name = str(name)
        self.engine = engine
        self.index = int(index)
        # disaggregated serving role: "prefill" replicas admit
        # new prompts and hand finished prefills off, "decode" replicas
        # adopt handed-off pages and stream tokens, "blended" replicas do
        # both (the pre-disaggregation behavior, and the degradation
        # target when a pool is sick)
        self.role = str(role)
        self.state = LIVE
        self.pending = []          # routed Entry objects, scheduler-ordered
        self.inflight = {}         # rid -> Entry, admitted into the engine
        self.last_beat = time.monotonic()
        self.thread_ident = None   # stamped by the dispatcher thread itself
        self.death_reason = None
        # flap damping: consecutive monitor checks that found
        # the beat stale; written only by the monitor thread
        self.missed_beats = 0
        # supervisor bookkeeping: failure domain (restart budgets/backoff
        # are per-domain) and the generation fence a supervisor installs
        # (None until the operator plane's supervisor, ROADMAP.md)
        self.domain = None
        self.fence = None
        self.retired = False       # removed by scale-down, not a failure
        # dispatch-latency EWMA (seconds per step() call, stamped by the
        # dispatcher; read by the monitor's slow-replica classification)
        self.step_ewma = 0.0
        self.step_samples = 0
        # cluster KV fabric: advertised prefix entries owned by
        # this replica — stamped by the monitor tick from the fabric's
        # residency map, rolled up fleet-wide as fleet.serving.kv_resident
        self.kv_resident = 0
        # labeled series of one family each
        self._occ_gauge = _registry.gauge(
            "serving.replica.occupancy", labels={"replica": self.name},
            help="per-replica active slots / max_seqs")
        self._queue_gauge = _registry.gauge(
            "serving.replica.queue_depth", labels={"replica": self.name},
            help="per-replica routed-but-not-admitted requests")
        self._pages_gauge = _registry.gauge(
            "serving.replica.pages_in_use", labels={"replica": self.name},
            help="per-replica KV pool pages referenced")

    def beat(self, step=None):
        self.last_beat = time.monotonic()

    def fence_writable(self):
        """The fencing contract applied to serving telemetry: a replica the
        supervisor already superseded must not publish telemetry its
        replacement would trust. With no fence (the only state until the
        operator plane's supervisor) every write is admitted."""
        if self.fence is None:
            return True
        raise NotImplementedError(
            "replica fences belong to the replica supervisor, which comes "
            "with the operator plane (ROADMAP.md, slice 16)")

    def note_step(self, wall_s):
        """Dispatcher-side dispatch-latency sample (single writer: only
        this replica's dispatcher calls it; the monitor only reads, and a
        torn read costs one pace verdict, not correctness)."""
        self.step_samples += 1
        if self.step_samples == 1:
            self.step_ewma = wall_s
        else:
            self.step_ewma += 0.2 * (wall_s - self.step_ewma)

    def publish_gauges(self):
        eng = self.engine
        self._occ_gauge.set(eng.active_count() / eng.max_seqs)
        self._queue_gauge.set(len(self.pending))
        self._pages_gauge.set(eng.pages_in_use())

    def retire_gauges(self):
        """Remove this replica's labeled per-replica series (replacement /
        scale-down): a removed name must stop exporting — a frozen stale
        gauge reads as a live zero to a scraper."""
        for fam in ("serving.replica.occupancy",
                    "serving.replica.queue_depth",
                    "serving.replica.pages_in_use"):
            _registry.remove(fam, labels={"replica": self.name})

    def load(self):
        """0..~1 pressure blend: decode slots, pool pages, queue depth. Each
        term saturates at 1 so one exhausted resource reads as heavy load
        even when the others are idle."""
        eng = self.engine
        slots = eng.active_count() / eng.max_seqs
        pages = eng.pages_in_use() / max(1, eng.num_pages - 1)
        queue = min(1.0, len(self.pending) / max(1, eng.max_seqs * 2))
        return (slots + pages + queue) / 3.0

    def pool_headroom(self):
        """Fraction of the KV pool still free (0..1) — the decode-pool
        placement signal: an adopted request arrives with its full page
        reservation already sized, so what matters is whether the pages
        fit, not whether this replica has seen the prefix before."""
        eng = self.engine
        return 1.0 - eng.pages_in_use() / max(1, eng.num_pages - 1)

    def prefix_fraction(self, prompt):
        """Fraction of this prompt's full pages already indexed here.
        O(prompt bytes): the engine's prefix index is keyed by chained
        per-page digests, not full-prefix re-hashes."""
        total = max(1, (len(prompt) - 1) // self.engine.page_size)
        return self.engine.prefix_match_pages(prompt) / total

    def snapshot(self):
        return {
            "name": self.name,
            "role": self.role,
            "state": self.state,
            "active": self.engine.active_count(),
            "max_seqs": self.engine.max_seqs,
            "pending": len(self.pending),
            "pages_in_use": self.engine.pages_in_use(),
            "load": round(self.load(), 4),
            "death_reason": self.death_reason,
            "missed_beats": self.missed_beats,
            "domain": self.domain,
            "step_ewma_s": round(self.step_ewma, 6),
            "kv_resident": self.kv_resident,
        }

    def __repr__(self):
        return f"ReplicaHandle({self.name!r}, {self.state})"


class Router:
    """Placement policy over a replica set. ``policy='prefix'`` (default)
    scores affinity+load as in the module docstring; ``policy='round_robin'``
    is the baseline the affinity policy's hit rate is compared against;
    ``policy='load'``
    is pure least-loaded (affinity weights zeroed)."""

    #: tokens hashed for the session-hint key — one engine page is the
    #: natural sharing granularity, and 16 matches the default page_size
    HINT_TOKENS = 16

    def __init__(self, policy="prefix", affinity_weight=1.0, hint_weight=0.5,
                 load_weight=1.0, headroom_weight=1.0, max_hints=4096,
                 peer_affinity_discount=0.5, adapter_affinity_weight=0.5):
        if policy not in ("prefix", "round_robin", "load"):
            raise ValueError(f"unknown router policy {policy!r}")
        self.policy = policy
        self.affinity_weight = float(affinity_weight)
        self.hint_weight = float(hint_weight)
        self.load_weight = float(load_weight)
        # LoRA adapter affinity: a replica whose engine already
        # holds the request's adapter on device (its per-digest cache)
        # skips the host->device upload on admission — worth a bounded
        # nudge, weaker than prefix affinity (pages dwarf adapter weights)
        self.adapter_affinity_weight = float(adapter_affinity_weight)
        # cluster KV fabric: a prefix resident on a PEER is
        # worth something — the target can fetch instead of recompute —
        # but strictly less than local residency, because the fetch costs
        # a wire transfer and can fail. The discount scales the fabric's
        # resident-fraction before it competes with the local index term.
        self.peer_affinity_discount = float(peer_affinity_discount)
        # installed by the frontend when the fabric is enabled; consulted
        # read-only (one resident_owners() pass per placement, OUTSIDE
        # self._lock — the digest chain walk must not serialize submits)
        self.fabric = None
        # decode-pool placement weight: free-page fraction of
        # the candidate replica's KV pool — see place()'s role branch
        self.headroom_weight = float(headroom_weight)
        self.max_hints = int(max_hints)
        self._hints = {}   # prefix-head bytes -> replica name (insertion LRU)
        self._rr = 0
        # circuit breaker: installed by the frontend; when set,
        # PROBATION replicas receive rate-limited probe placements
        self.breaker = None
        # place() is called from the submit path (under the frontend lock)
        # AND from reroute/monitor paths (not under it) — the hint table and
        # rr cursor need their own lock or a concurrent LRU-evict can pop
        # the same head key twice (KeyError)
        self._lock = threading.Lock()

    def _hint_key(self, prompt):
        return prompt[:self.HINT_TOKENS].tobytes()

    def place(self, entry, replicas, exclude=(), cheap=False):
        """Pick a LIVE replica for ``entry`` (an object with ``.req``).
        ``exclude`` names replicas the request must avoid (the one that just
        died under it). Raises NoLiveReplicas when nothing can take it.
        ``cheap=True`` (brownout ``shed_extras``) skips the per-replica
        affinity probe and session hints — pure least-loaded placement.

        Pure decision — no hint writes, no counters. The frontend calls
        :meth:`committed` once the entry actually lands in a pending list,
        so a submission that is subsequently SHED (or loses the append
        race) cannot re-home a live session's hint to a replica it never
        reached, and the routing counters count real placements only."""
        chaos.site("serving.route")
        entry.probe = False
        # role targeting: a disaggregated entry names the pool
        # it needs ("prefill" before handoff, "decode" after); blended
        # replicas serve either. The filter is a PREFERENCE, not a fence —
        # when the targeted pool has no live replica the entry falls back
        # to the whole live set (the frontend's degradation ladder already
        # decided blended completion is acceptable before routing here).
        role = getattr(entry, "target_role", None)

        def _role_ok(r):
            return role is None or r.role in (role, "blended")

        if self.breaker is not None:
            # half-open probes win over normal scoring: a PROBATION
            # replica only ever sees traffic through this rate-limited
            # path, and without it there is no recovery signal at all
            for r in replicas:
                if r.state == PROBATION and r.name not in exclude \
                        and _role_ok(r) and self.breaker.allow_probe(r.name):
                    entry.probe = True
                    entry.route_affinity = False
                    entry.route_score = 0.0
                    return r
        live = [r for r in replicas
                if r.state == LIVE and r.name not in exclude]
        if role is not None:
            in_role = [r for r in live if _role_ok(r)]
            if in_role:
                live = in_role
        if not live:
            raise NoLiveReplicas(
                f"no LIVE replica for request {entry.req.rid} "
                f"(states: {[(r.name, r.state) for r in replicas]})")
        # no len(live)==1 shortcut for the scoring policies: the prefix
        # policy must still score (and later record the session hint)
        # while one replica has the pool to itself (a drain window), or
        # every session re-homes blind when the drained replica returns
        with self._lock:  # _hints read + rr cursor only — the affinity
            # probe below must not serialize concurrent submits
            # or make a replica-death relocation queue behind them
            if self.policy == "round_robin":
                pick = live[self._rr % len(live)]
                self._rr += 1
                entry.route_affinity = False
                entry.route_score = 0.0
                return pick
            prompt = entry.req.prompt
            hinted = (None if cheap
                      else self._hints.get(self._hint_key(prompt)))
        # cluster-wide prefix residency: one digest pass per
        # placement, outside self._lock. cheap=True (shed_extras) skips it
        # with the other affinity probes.
        peer_res = {}
        if (self.fabric is not None and not cheap
                and self.policy == "prefix" and role != "decode"):
            try:
                peer_res = self.fabric.resident_owners(
                    prompt, getattr(live[0].engine, "page_size", 16))
            except Exception:
                peer_res = {}
        # adapter-affinity probe: which replicas already hold
        # this request's LoRA adapter on device. Advisory (the engine's
        # digest-keyed device cache, read without its lock — a stale read
        # costs one re-upload, never correctness); skipped under cheap
        # like every other affinity probe.
        req_ad = getattr(entry.req, "adapter", None)
        if cheap or req_ad is None:
            req_ad = None
        best, best_score, best_aff = None, None, 0.0
        best_via_peer = False
        for r in live:
            if role == "decode":
                # decode placement scores pool HEADROOM, not prefix
                # affinity: the handed-off request brings its own KV —
                # what matters is whether its page reservation fits
                aff = hint = 0.0
                via_peer = False
                score = (self.headroom_weight * r.pool_headroom()
                         - self.load_weight * r.load())
            else:
                if self.policy == "load" or cheap:
                    aff = hint = 0.0
                    via_peer = False
                else:
                    local = r.prefix_fraction(prompt)
                    # peer-resident prefixes count as weaker, transfer-
                    # discounted affinity: the replica can FETCH the
                    # prefix over the fabric instead of recomputing it
                    peer = (self.peer_affinity_discount
                            * peer_res.get(r.name, 0.0))
                    aff = max(local, peer)
                    via_peer = peer > local
                    hint = 1.0 if r.name == hinted else 0.0
                lora = 0.0
                if req_ad is not None:
                    devs = getattr(r.engine, "_lora_device", None)
                    if devs is not None and req_ad.digest in devs:
                        lora = 1.0
                score = (self.affinity_weight * aff
                         + self.hint_weight * hint
                         + self.adapter_affinity_weight * lora
                         - self.load_weight * r.load())
            if best_score is None or score > best_score:
                best, best_score, best_aff = r, score, aff
                best_via_peer = via_peer
        entry.route_affinity = best_aff > 0.0 or hinted == best.name
        # a peer-residency placement is speculative until the fetch
        # actually lands: committed() defers the session-hint write and
        # adoption_landed() records it — a failed fetch (recompute
        # fallthrough) must not re-home session stickiness
        entry.kv_hint_deferred = best_via_peer
        # trace attribution: the request's trace records WHY it
        # landed where it did — the winning blended score and whether
        # affinity (index hit or session hint) carried the decision
        entry.route_score = best_score
        return best

    def committed(self, entry, rep):
        """The placement landed: record it. Counters here (not in place())
        so shed/raced submissions don't count, and the session hint only
        re-homes for requests that will actually warm ``rep``'s cache."""
        _M_ROUTED.inc()
        if entry.route_affinity:
            _M_AFFINITY_PLACED.inc()
        if getattr(entry, "probe", False):
            # a half-open probe is diagnostic traffic: it must not re-home
            # a live session's hint to a replica still under suspicion
            return
        if getattr(entry, "target_role", None) == "decode":
            # a decode-pool adoption placement carries its KV with it — it
            # must not re-home the prefix session hint away from the
            # prefill replica whose cache actually holds the prefix
            return
        if self.policy != "prefix":
            return
        if getattr(entry, "kv_hint_deferred", False):
            # peer-residency placement: the prefix is not on rep yet, only
            # fetchable. The hint write waits for adoption_landed() — a
            # fetch that falls through to recompute still lands (and then
            # records), but a shed/failed placement never re-homes the
            # session to a replica whose cache stayed cold
            return
        self._record_hint(self._hint_key(entry.req.prompt), rep.name)

    def adoption_landed(self, entry, rep):
        """The deferred cluster-hint write: the peer-routed entry's pages
        are actually resident on ``rep`` now (fetched and adopted, or
        recomputed locally — either way the cache is warm THERE)."""
        if not getattr(entry, "kv_hint_deferred", False):
            return
        entry.kv_hint_deferred = False
        if self.policy == "prefix":
            self._record_hint(self._hint_key(entry.req.prompt), rep.name)

    def _record_hint(self, key, name):
        # remember the session: the NEXT request with this prefix head
        # goes to the same replica even before the index has its pages
        with self._lock:
            self._hints.pop(key, None)
            self._hints[key] = name
            while len(self._hints) > self.max_hints:
                self._hints.pop(next(iter(self._hints)))

    def forget_replica(self, name):
        """Drop a dead replica's session hints so new traffic re-homes."""
        with self._lock:
            for k in [k for k, v in self._hints.items() if v == name]:
                del self._hints[k]
