"""Fleet-wide observability plane (the port's own copy of
``paddle_tpu/observability/fleet.py``): cross-rank aggregation,
straggler and skew attribution, and the serving rollup.

Every telemetry surface before this one is per process: each rank or
replica publishes into its own registry and serves its own endpoint. This
module composes them into cluster views, meeting in the shared telemetry
directory (``PADDLE_TELEMETRY_DIR``, where the heartbeats live):

- :class:`SnapshotPublisher`: every rank atomically publishes a bounded
  snapshot (structured metric series with histogram bounds, the goodput
  split, the compile ledger's counts, per-op collective wait and body
  sums, the dynamics' and devprof's blocks) to ``fleetsnap.<rank>.json``
  on the heartbeat cadence (``watchdog.maybe_beat``); serving dispatchers
  publish under ``serving/`` beside their heartbeats. Snapshots carry the
  elastic generation, so an aggregator fences out a dead incarnation's.
- :class:`FleetAggregator`: merges a snapshot set into one view: a merged
  registry (every series gains a ``rank=``/``replica=`` label, families
  stay under one ``# TYPE``), cross-rank quantiles and skew of the
  ``span.*_s`` step phases, and a straggler detector that separates "this
  rank computed slowly" from "this rank waited on a collective" through
  the wait-vs-body split of the ``collective.*`` seams, scoring ranks that
  stay slowest over a sliding window.
- :func:`serving_rollup`: the serving cell's view in
  ``serving_report()["fleet"]`` and ``/fleetz``: live replicas, queue
  depth, occupancy, goodput, the worst multi-window SLO burn, and one
  ``pressure`` signal with a ``scale_hint``, the number the replica
  supervisor reads.
- :func:`bench_block`: publish, aggregate and distill this process's
  snapshot for a bench line.

Cost: publication rides the heartbeat throttle (one snapshot per
``PADDLE_FLEET_SNAPSHOT_EVERY_S`` at most); with no telemetry directory
the whole plane is one cached ``False`` check.
"""
import collections
import json
import math
import os
import re
import statistics
import threading
import time

from ..utils.envs import env_float, env_int, env_str
from . import goodput as _goodput
from . import tracing as _tracing
from .metrics import MetricsRegistry
from .metrics import registry as _registry

__all__ = ["SnapshotPublisher", "FleetAggregator", "CollectiveStats",
           "collective_seam", "collectives", "maybe_publish",
           "serving_rollup", "snapshot_path", "load_snapshots",
           "SNAP_RE"]

#: snapshot schema version (bump on incompatible changes; the aggregator
#: skips versions it does not understand instead of mis-merging them)
SNAPSHOT_VERSION = 1

SNAP_RE = re.compile(r"^fleetsnap\.(\d+)(?:\.([A-Za-z0-9_-]+))?\.json$")

_SANITIZE_INSTANCE = re.compile(r"[^A-Za-z0-9_-]")


_PROC_INSTANCE = None


def process_instance():
    """A publisher-instance discriminator unique across the processes
    that can share one telemetry dir: short hostname + a hash of the
    FULL hostname + pid. A pid alone is NOT unique across hosts (two
    containers are both pid 1), and a truncated hostname alone is not
    unique across same-prefix pod names — the hash of the untruncated
    name keeps 'serving-frontend-…-abcde' and '…-fghij' distinct.
    Computed once per process (hostname and pid are stable)."""
    global _PROC_INSTANCE
    if _PROC_INSTANCE is None:
        import hashlib
        import socket

        raw = socket.gethostname()
        host = _SANITIZE_INSTANCE.sub("-", raw)[:12] or "host"
        tag = hashlib.blake2s(raw.encode(), digest_size=3).hexdigest()
        _PROC_INSTANCE = f"{host}-{tag}-{os.getpid()}"
    return _PROC_INSTANCE


_reg_token_lock = threading.Lock()
_reg_token_counter = 0


def _registry_token(registry):
    """A per-registry token stable for the REGISTRY OBJECT's lifetime —
    stamped on the object itself, so a freed registry's reused id()
    address can never alias two distinct registries (which would make
    the aggregator collapse two ranks into one metric source)."""
    tok = getattr(registry, "_fleet_token", None)
    if tok is None:
        global _reg_token_counter
        with _reg_token_lock:
            tok = getattr(registry, "_fleet_token", None)
            if tok is None:
                _reg_token_counter += 1
                tok = registry._fleet_token = _reg_token_counter
    return tok

#: metric-family priority for the bounded snapshot: when the series cap
#: bites, the cross-rank-interesting families survive first
_PRIORITY = ("span.", "collective.", "serving.", "serve.", "slo.",
             "train.", "data.", "fleet.", "elastic.", "goodput.",
             "compile.", "device.", "devprof.")

#: step-phase families the straggler detector reads, most specific first
_STEP_FAMILIES = ("span.train.step.dispatch_s", "span.train.step_s",
                  "span.train.run_steps.dispatch_s")


def snapshot_path(directory, rank, instance=None):
    """``fleetsnap.<rank>.json``, or ``fleetsnap.<rank>.<instance>.json``
    when an instance discriminator is given. Training ranks are globally
    unique by the launcher contract; serving replica INDEXES are only
    unique within one frontend process, so ReplicaHandle publishes with
    ``instance=process_instance()`` (host + pid) — two frontends sharing
    a telemetry dir, even across hosts, must not overwrite (or tear, via
    the shared tmp path) each other's files."""
    if instance is None:
        return os.path.join(directory, f"fleetsnap.{int(rank)}.json")
    inst = _SANITIZE_INSTANCE.sub("-", str(instance))
    return os.path.join(directory, f"fleetsnap.{int(rank)}.{inst}.json")


# ---------------------------------------------------------------------------
# collective wait vs body attribution (the collective.* span seams)
# ---------------------------------------------------------------------------
class CollectiveStats:
    """Per-op accumulators for the wait-vs-body split at the collective
    seams. ``wait_s`` is the time between entering the collective entry
    point and the collective body starting — with the optional barrier
    probe armed (``PADDLE_FLEET_COLLECTIVE_WAIT=1``, multi-process only)
    that is literally the time this rank spent waiting for its peers;
    ``body_s`` is the collective itself. The aggregator uses the split to
    separate compute-slow ranks (low wait, high compute) from ranks stuck
    waiting on a slow peer or a slow wire (high wait)."""

    def __init__(self, registry=None):
        self.registry = registry if registry is not None else _registry
        self._lock = threading.Lock()
        self._ops = {}

    def note(self, op, wait_s, body_s):
        self.registry.histogram(
            "collective.wait_s", labels={"op": op},
            help="pre-collective wait before the body dispatches, per op"
        ).observe(wait_s)
        now = time.time()
        with self._lock:
            rec = self._ops.get(op)
            if rec is None:
                rec = self._ops[op] = {"count": 0, "wait_s": 0.0,
                                       "body_s": 0.0, "last_arrive": 0.0}
            rec["count"] += 1
            rec["wait_s"] += wait_s
            rec["body_s"] += body_s
            rec["last_arrive"] = now

    def export(self):
        with self._lock:
            return {op: dict(rec) for op, rec in self._ops.items()}

    def reset(self):
        with self._lock:
            self._ops.clear()


#: the process-global accumulator the collective seams feed
collectives = CollectiveStats()


def _wait_probe():
    """The pre-collective wait body: the ``fleet.collective_wait`` chaos
    seam (deterministic wait injection). The reference can also run a
    host barrier here across processes
    (``PADDLE_FLEET_COLLECTIVE_WAIT=1``), so that the measured wait is the
    time spent waiting on peers; in one process that barrier has nothing
    to wait for, and the port's multi-process barrier comes with the
    launcher (ROADMAP.md, §1 item 7)."""
    from ..testing import chaos

    chaos.site("fleet.collective_wait")


class _CollectiveSeam:
    """Times the pre-collective wait distinctly from the collective body;
    the body runs under the existing ``collective.<op>`` span so every
    downstream consumer (ring buffer, sinks, span histograms) is
    unchanged."""

    __slots__ = ("name", "op", "_span", "_t0", "_t1")

    def __init__(self, name):
        self.name = name
        self.op = name.partition(".")[2] or name

    def __enter__(self):
        self._t0 = time.perf_counter()
        _wait_probe()
        self._t1 = time.perf_counter()
        self._span = _tracing.span(self.name)
        self._span.__enter__()
        return self

    def __exit__(self, *exc):
        self._span.__exit__(*exc)
        collectives.note(self.op, self._t1 - self._t0,
                         time.perf_counter() - self._t1)
        return False


def collective_seam(name):
    """The collective entry-point wrapper. With
    telemetry disabled this is a flag check, the chaos seam probe (the
    chaos contract: every seam fires regardless of telemetry — an armed
    ``fleet.collective_wait`` plan must inject even in a telemetry-off
    run), and the shared no-op; nothing is timed or recorded."""
    if not _tracing.enabled():
        from ..testing import chaos

        chaos.site("fleet.collective_wait")
        return _tracing._NULL
    return _CollectiveSeam(name)


# ---------------------------------------------------------------------------
# per-rank snapshot publication
# ---------------------------------------------------------------------------
class SnapshotPublisher:
    """Atomically publishes this process's telemetry as one bounded JSON
    snapshot (tmp + fsync-free rename — same contract as heartbeats: a
    reader never sees a torn file). ``role`` is ``"rank"`` for training
    ranks, ``"replica"`` for serving dispatchers (published under the
    ``serving/`` subdir by ReplicaHandle, mirroring their heartbeats).
    ``registry``/``collectives_stats`` are injectable so multi-rank tests
    can publish isolated per-rank registries from one process."""

    def __init__(self, directory, rank, role="rank", registry=None,
                 collectives_stats=None, min_interval_s=None,
                 max_series=None, generation=None, world=None,
                 extra_provider=None, instance=None, include_metrics=True):
        os.makedirs(directory, exist_ok=True)
        self.dir = directory
        self.rank = int(rank)
        self.role = str(role)
        self.registry = registry if registry is not None else _registry
        self.collectives = (collectives_stats if collectives_stats is not None
                            else collectives)
        self.min_interval_s = (float(min_interval_s)
                               if min_interval_s is not None
                               else env_float("PADDLE_FLEET_SNAPSHOT_EVERY_S",
                                              2.0))
        self.max_series = (int(max_series) if max_series is not None
                           else env_int("PADDLE_FLEET_SNAPSHOT_MAX_SERIES",
                                        512))
        self.generation = (int(generation) if generation is not None
                           else env_int("PADDLE_ELASTIC_GENERATION", 0))
        self.world = (int(world) if world is not None
                      else env_int("PADDLE_TRAINERS_NUM", 0))
        #: optional callable returning a dict merged into each snapshot
        #: (the serving ReplicaHandle attaches its control-plane state)
        self.extra_provider = extra_provider
        #: False = identity/extra-only snapshots (no registry export):
        #: N same-registry publishers in one process need exactly ONE
        #: metrics carrier — the aggregator collapses the rest anyway,
        #: so the other N-1 skip the full export+serialize per cadence
        self.include_metrics = bool(include_metrics)
        self.instance = (None if instance is None
                         else _SANITIZE_INSTANCE.sub("-", str(instance)))
        self.path = snapshot_path(directory, self.rank, instance=instance)
        self._seq = 0
        self._last_t = 0.0
        # publish() is called from the owning loop AND (for replicas)
        # potentially from tests/monitors: serialize writers so two
        # publishes can never interleave on the shared tmp file
        self._pub_lock = threading.Lock()

    def _series(self):
        """The registry export, priority-ordered and capped: when the cap
        bites, span/collective/serving families survive first and the
        snapshot says how many series were dropped (no silent truncation)."""
        recs = self.registry.export()

        def key(rec):
            fam = rec["family"]
            for i, p in enumerate(_PRIORITY):
                if fam.startswith(p):
                    return (i, rec["name"])
            return (len(_PRIORITY), rec["name"])

        recs.sort(key=key)
        dropped = max(0, len(recs) - self.max_series)
        return recs[:self.max_series], dropped

    def build(self, step=None):
        from . import compilemem as _compilemem

        if self.include_metrics:
            series, dropped = self._series()
        else:
            series, dropped = [], 0
        snap = {
            "kind": "fleet_snapshot",
            "version": SNAPSHOT_VERSION,
            "role": self.role,
            "rank": self.rank,
            "pid": os.getpid(),
            # source identity: ALWAYS host+pid-qualified — training-rank
            # publishers keep their rank-only filename, but their metric
            # SOURCE identity must survive cross-host pid collisions too
            "instance": self.instance or process_instance(),
            # registry identity: publishers sharing ONE registry (N
            # in-process replicas) publish the same series — the
            # aggregator merges each distinct registry once, not once per
            # publisher. A token stamped on the object, NOT id(): a freed
            # registry's reused address must never alias two ranks.
            "registry_id": _registry_token(self.registry),
            "generation": self.generation,
            "world": self.world,
            "step": step,
            "seq": self._seq,
            "time": time.time(),
            "metrics": series,
            "dropped_series": dropped,
            "goodput": _goodput.report(),
            "serving_goodput": _goodput.serving.report(),
            "compile": _compilemem.ledger.counts(),
            "collectives": self.collectives.export(),
            "dynamics": _dynamics_snapshot_block(),
            "devprof": _devprof_snapshot_block(),
        }
        if self.extra_provider is not None:
            try:
                snap.update(self.extra_provider() or {})
            except Exception:
                pass  # a dying engine must not break publication
        return snap

    def publish(self, step=None):
        t0 = time.perf_counter()
        snap = self.build(step=step)
        with self._pub_lock:
            self._seq += 1
            tmp = self.path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(snap, f)
            os.replace(tmp, self.path)
        self.registry.counter(
            "fleet.snapshots.published",
            help="fleet snapshots committed by this process").inc()
        self.registry.histogram(
            "fleet.snapshot.publish_s",
            help="wall cost of building + committing one fleet snapshot"
        ).observe(time.perf_counter() - t0)
        return self.path

    def maybe_publish(self, step=None):
        """Throttled publish — the heartbeat-cadence hook. OSError is
        swallowed: a full disk must not take the training step down."""
        now = time.monotonic()
        if now - self._last_t < self.min_interval_s:
            return None
        self._last_t = now
        try:
            return self.publish(step=step)
        except OSError:
            return None


def _dynamics_snapshot_block():
    """This process's last spilled dynamics summary, bounded to
    the cross-rank-interesting scalars — the aggregator reads it to flag
    grad-norm skew (a desyncing rank) before loss diverges. None when
    dynamics is off or nothing has spilled yet."""
    try:
        from . import dynamics as _dyn

        last = _dyn.fleet_block()
    except Exception:
        return None
    if not last:
        return None
    return {k: last.get(k) for k in
            ("step", "updates", "loss", "loss_ewma", "loss_z", "grad_norm",
             "nonfinite_steps", "nonfinite_first")}


def _devprof_snapshot_block():
    """This process's per-program mean device-seconds, bounded
    to the costliest programs — the aggregator medians these across ranks
    to flag the rank whose CHIP is slow (the straggler detector can only
    say a rank's step is slow; this says the same program takes longer on
    this device). None when devprof is off or nothing has sampled."""
    try:
        from . import devprof as _dp

        return _dp.fleet_block()
    except Exception:
        return None


#: cached process publisher: False = no telemetry dir (permanent no-op),
#: None = unresolved, SnapshotPublisher = publishing (same tri-state
#: pattern as watchdog._process_hb)
_process_pub = None


def _env_publisher():
    global _process_pub
    p = _process_pub
    if p is not None:
        return p
    d = env_str("PADDLE_TELEMETRY_DIR")
    if not d:
        _process_pub = False
        return False
    rank = env_str("PADDLE_TRAINER_ID", env_str("RANK", "0")) or "0"
    try:
        p = _process_pub = SnapshotPublisher(d, int(rank))
    except (OSError, ValueError):
        p = _process_pub = False
    return p


def maybe_publish(step=None):
    """The heartbeat piggyback (called from watchdog.maybe_beat): one
    cached check when no telemetry dir is configured; a throttled atomic
    snapshot write when there is."""
    p = _env_publisher()
    if p is False:
        return
    p.maybe_publish(step)


def _reset_process_publisher():
    """Test hook: forget the cached publisher so env changes take effect."""
    global _process_pub
    _process_pub = None


# ---------------------------------------------------------------------------
# snapshot loading
# ---------------------------------------------------------------------------
def load_snapshots(paths):
    """(snapshots, errors) from files / telemetry dirs. Directories are
    scanned for ``fleetsnap.*.json`` at the top level AND under
    ``serving/`` (where dispatchers publish, mirroring their heartbeats)."""
    files = []
    for p in paths:
        if os.path.isdir(p):
            for d in (p, os.path.join(p, "serving")):
                try:
                    names = sorted(os.listdir(d))
                except OSError:
                    continue
                files.extend(os.path.join(d, n) for n in names
                             if SNAP_RE.match(n))
        else:
            files.append(p)
    snaps, errors = [], []
    for f in files:
        try:
            with open(f) as fh:
                snap = json.load(fh)
        except (OSError, ValueError) as e:
            errors.append(f"{f}: {type(e).__name__}: {e}")
            continue
        if not isinstance(snap, dict) \
                or snap.get("kind") != "fleet_snapshot":
            errors.append(f"{f}: not a fleet snapshot")
            continue
        if snap.get("version", 0) > SNAPSHOT_VERSION:
            errors.append(f"{f}: snapshot version {snap.get('version')} "
                          f"newer than reader ({SNAPSHOT_VERSION})")
            continue
        snap["_path"] = f
        snaps.append(snap)
    return snaps, errors


def _median(vals):
    return statistics.median(vals) if vals else 0.0


# ---------------------------------------------------------------------------
# the aggregator
# ---------------------------------------------------------------------------
class FleetAggregator:
    """Merges per-rank/per-replica snapshots into cluster views.

    Generation fencing: only the newest generation present survives the
    merge (or ``generation=`` pins it — the launcher passes its live
    incarnation), exactly like heartbeat fencing; fenced snapshots are
    counted, never mixed in.

    Straggler scoring: per merge round, each rank's step-phase mean is
    split into compute (step − collective wait) and collective wait using
    the seam accumulators; ratios against the cross-rank median classify
    outliers as ``compute`` (this rank IS slow) or ``collective_wait``
    (this rank is stuck waiting — look at its peers). A rank flagged
    ``compute`` in a majority of the sliding window is a PERSISTENT
    straggler: ``fleet.straggler.alerts`` counts the transition and
    :meth:`straggler_advisory` renders the line the elastic launcher logs
    alongside its restart-budget decisions (advisory input — the budget
    still decides)."""

    def __init__(self, telemetry_dir=None, window=None, threshold=None,
                 expected_world=None, generation=None, interval_s=None,
                 registry=None, stale_s=None):
        dirs = telemetry_dir
        if isinstance(dirs, str):
            dirs = [dirs]
        self.dirs = list(dirs or [])
        self.window = (int(window) if window is not None
                       else env_int("PADDLE_FLEET_STRAGGLER_WINDOW", 8))
        self.threshold = (float(threshold) if threshold is not None
                          else env_float("PADDLE_FLEET_STRAGGLER_RATIO",
                                         1.5))
        # staleness fence, RELATIVE to the newest snapshot present (not
        # wall clock, so post-mortem dirs still merge): a publisher that
        # stopped publishing — a dead frontend pid, a crashed rank —
        # drops out instead of inflating members/quorum/rollups forever.
        # <= 0 disables.
        self.stale_s = (float(stale_s) if stale_s is not None
                        else env_float("PADDLE_FLEET_SNAPSHOT_STALE_S",
                                       120.0))
        self.expected_world = expected_world
        self.generation = generation
        self.interval_s = (float(interval_s) if interval_s is not None
                           else max(1.0, env_float(
                               "PADDLE_FLEET_SNAPSHOT_EVERY_S", 2.0)))
        self.registry = registry if registry is not None else _registry
        self._lock = threading.Lock()
        self._history = {}          # rank -> deque of per-round verdicts
        self._prev_totals = {}      # rank -> last advancing-round totals
        self._persistent = set()
        self._gn_flagged = set()    # ranks currently grad-norm-skew-flagged
        self._dp_flagged = set()    # ranks currently device-time-flagged
        self._scored_ranks = set()  # ranks with a live score gauge
        self._skew_phases = set()   # phases with a live skew gauge
        self._rounds = 0
        self._last_view = None
        self._stop = threading.Event()
        self._thread = None

    # ---- lifecycle (the launcher's monitor hosts this) -------------------
    def start(self):
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="paddle-fleet-aggregator")
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def _run(self):
        while not self._stop.is_set():
            try:
                self.collect()
            except Exception:
                pass  # the aggregator must never take the launcher down
            self._stop.wait(self.interval_s)

    # ---- merging ----------------------------------------------------------
    def collect(self, advance=True):
        """One aggregation round over the configured dirs: refreshes the
        ``fleet.*`` gauges and (with ``advance=True`` — the monitor
        thread's cadence) advances the straggler sliding window."""
        snaps, errors = load_snapshots(self.dirs)
        return self.merge(snaps, errors=errors, advance=advance)

    def view(self, refresh=False):
        """The last merged view (collect()s lazily on first use or when
        ``refresh=True``) — the /fleetz payload. View refreshes NEVER
        advance the straggler window: persistence must track the monitor
        cadence, not the scrape rate (a 0.5 s scraper against an 8-round
        window would otherwise fabricate persistent stragglers from two
        real slow rounds)."""
        if refresh or self._last_view is None:
            return self.collect(advance=False)
        return self._last_view

    def _fence(self, snaps):
        gens = sorted({int(s.get("generation", 0)) for s in snaps})
        gen = (int(self.generation) if self.generation is not None
               else (gens[-1] if gens else 0))
        kept = [s for s in snaps if int(s.get("generation", 0)) == gen]
        return gen, gens, kept, len(snaps) - len(kept)

    @staticmethod
    def _source_id(s):
        """The publishing process's identity: the host+pid ``instance``
        discriminator when the publisher stamped one, else the pid — a
        bare pid is not unique across hosts sharing a telemetry dir."""
        return s.get("instance") or s.get("pid", 0)

    @classmethod
    def _dedupe(cls, kept):
        """One snapshot per member identity — newest publication wins.
        Training ranks are globally unique (launcher contract) so the
        rank IS the identity; serving replica indexes repeat across
        frontend processes (and hosts), so a replica's identity is
        ``rank@<instance-or-pid>``."""
        by_id = {}
        for s in kept:
            role = s.get("role", "rank")
            rank = int(s.get("rank", 0))
            ident = (rank if role == "rank"
                     else f"{rank}@{cls._source_id(s)}")
            key = (role, ident)
            cur = by_id.get(key)
            if cur is None or s.get("time", 0) > cur.get("time", 0):
                by_id[key] = s
        return by_id

    @classmethod
    def _metric_sources(cls, by_id):
        """Snapshots whose ``metrics`` block should be merged: one per
        (source process, registry) — N in-process publishers sharing one
        registry publish the same series, and merging that registry N
        times would N-fold every counter. Distinct registries in one
        process (per-rank test harnesses) each merge once."""
        newest = {}
        for s in by_id.values():
            key = (cls._source_id(s),
                   s.get("registry_id", s.get("rank", 0)))
            cur = newest.get(key)
            # prefer the snapshot that actually carries metrics (the
            # designated per-process carrier), newest among equals —
            # an identity-only twin must not shadow the metrics payload
            rank_s = (bool(s.get("metrics")), s.get("time", 0))
            rank_c = (bool(cur.get("metrics")), cur.get("time", 0)) \
                if cur is not None else (False, -1)
            if cur is None or rank_s > rank_c:
                newest[key] = s
        chosen = {id(s) for s in newest.values()}
        return [s for s in by_id.values() if id(s) in chosen]

    def _fence_stale(self, snaps):
        """Drop snapshots older than ``stale_s`` behind the NEWEST one —
        the publisher stopped publishing (dead pid, crashed rank) and
        must not count as a live member."""
        if self.stale_s <= 0 or not snaps:
            return snaps, 0
        newest = max(s.get("time", 0) for s in snaps)
        fresh = [s for s in snaps
                 if newest - s.get("time", 0) <= self.stale_s]
        return fresh, len(snaps) - len(fresh)

    def merge(self, snaps, errors=(), advance=True):
        snaps, stale = self._fence_stale(snaps)
        gen, gens, kept, fenced = self._fence(snaps)
        by_id = self._dedupe(kept)
        sources = self._metric_sources(by_id)
        rank_snaps = {r: s for (role, r), s in by_id.items()
                      if role == "rank"}
        replica_snaps = {r: s for (role, r), s in by_id.items()
                         if role == "replica"}
        phases = self._phase_stats(
            [s for s in sources if s.get("role", "rank") == "rank"])
        straggler = self._straggler(rank_snaps, advance=advance)
        dynamics = self._dynamics_agg(rank_snaps, advance=advance)
        devprof = self._devprof_agg(rank_snaps, advance=advance)
        now = time.time()
        members = {}
        for (role, r), s in sorted(by_id.items()):
            members[f"{role}:{r}"] = {
                "role": role, "rank": r, "pid": s.get("pid"),
                "step": s.get("step"), "generation": s.get("generation", 0),
                "age_s": round(now - s.get("time", now), 3),
                "world": s.get("world"),
            }
        expected = self.expected_world
        if expected is None:
            worlds = [int(s.get("world") or 0) for s in rank_snaps.values()]
            expected = max(worlds) if worlds else 0
        present = sorted(rank_snaps)
        missing = (sorted(set(range(expected)) - set(present))
                   if expected else [])
        view = {
            "time": now,
            "generation": gen,
            "generations_seen": gens,
            "fenced_out": fenced,
            "stale_out": stale,
            "members": members,
            "quorum": {"expected_world": expected, "present": present,
                       "missing": missing},
            "phases": phases,
            "straggler": straggler,
            "dynamics": dynamics,
            "devprof": devprof,
            "serving": self._serving_agg(replica_snaps),
            "errors": list(errors),
        }
        self.registry.gauge(
            "fleet.snapshots.merged",
            help="snapshots merged into the last fleet view").set(len(by_id))
        self.registry.gauge(
            "fleet.snapshots.fenced",
            help="old-generation snapshots fenced out of the last merge"
        ).set(fenced)
        self._last_view = view
        return view

    # ---- cross-rank phase stats -------------------------------------------
    @staticmethod
    def _rank_family_stats(snap, match):
        """{family: (sum, count, bounds, counts)} for one snapshot's
        histogram series whose family ``match()`` accepts, label-sets of a
        family merged together."""
        fams = {}
        for rec in snap.get("metrics", ()):
            if rec.get("type") != "histogram" or not match(rec["family"]):
                continue
            cur = fams.get(rec["family"])
            if cur is None:
                fams[rec["family"]] = [rec.get("sum", 0.0),
                                       rec.get("count", 0),
                                       list(rec.get("bounds") or ()),
                                       list(rec.get("counts") or ())]
            else:
                cur[0] += rec.get("sum", 0.0)
                cur[1] += rec.get("count", 0)
                if cur[2] == list(rec.get("bounds") or ()):
                    cur[3] = [a + b for a, b in
                              zip(cur[3], rec.get("counts") or ())]
        return fams

    def _phase_stats(self, rank_sources):
        """Cross-rank stats per span/collective-wait family: per-rank
        means, the skew ratio (max mean / median mean), and merged-bucket
        quantiles when every rank shares the bucket ladder."""
        from .metrics import Histogram

        per_rank = {}
        for s in rank_sources:
            r = int(s.get("rank", 0))
            per_rank[r] = self._rank_family_stats(
                s, lambda f: f.startswith("span.")
                or f == "collective.wait_s")
        families = sorted({f for fams in per_rank.values() for f in fams})
        out = {}
        for fam in families:
            means, merged_bounds, merged_counts = {}, None, None
            total_sum = total_count = 0
            mergeable = True
            for r, fams in per_rank.items():
                rec = fams.get(fam)
                if rec is None:
                    continue
                s, c, bounds, counts = rec
                if c:
                    means[r] = s / c
                total_sum += s
                total_count += c
                if merged_bounds is None:
                    merged_bounds, merged_counts = bounds, list(counts)
                elif bounds == merged_bounds:
                    merged_counts = [a + b for a, b in
                                     zip(merged_counts, counts)]
                else:
                    mergeable = False
            if not means:
                continue
            med = _median(list(means.values()))
            worst = max(means, key=means.get)
            lo = min(means.values())
            entry = {
                "ranks": {str(r): round(m, 6)
                          for r, m in sorted(means.items())},
                "mean": round(total_sum / total_count, 6)
                if total_count else 0.0,
                "median_rank_mean": round(med, 6),
                "max_rank": worst,
                # skew: how much slower the worst rank is than the
                # median; spread: the full max-min range over the median
                # (catches a LOW outlier too — e.g. the one rank that
                # never waits because everyone waits on IT)
                "skew": round(means[worst] / med, 4) if med > 0 else 1.0,
                "spread": round((means[worst] - lo) / med, 4)
                if med > 0 else 0.0,
            }
            if mergeable and merged_bounds:
                h = Histogram(fam, buckets=merged_bounds)
                with h._lock:
                    for i, c in enumerate(
                            merged_counts[:len(h._counts)]):
                        h._counts[i] = int(c)
                    h._count = sum(h._counts)
                    h._sum = total_sum
                entry["p50"] = h.quantile(0.5)
                entry["p99"] = h.quantile(0.99)
            out[fam] = entry
        for fam, e in out.items():
            self.registry.gauge(
                "fleet.phase_skew", labels={"phase": fam},
                help="max-rank mean / median-rank mean per step phase"
            ).set(e["skew"])
        # phases that stopped appearing (departed ranks took their spans
        # with them, or <2 peers remain) retire from the exposition
        with self._lock:
            for fam in self._skew_phases - set(out):
                self.registry.remove("fleet.phase_skew",
                                     labels={"phase": fam})
            self._skew_phases = set(out)
        return out

    # ---- cross-rank training dynamics ---------------------------
    def _dynamics_agg(self, rank_snaps, advance=True):
        """Merge the per-rank dynamics blocks into the desync view: in
        data-parallel training every rank consumes a different shard of
        the SAME distribution, so a rank whose grad norm sits far off the
        cross-rank median is desyncing (corrupt shard, diverging local
        state) — visible here BEFORE the loss chart shows it. Ratios
        against the median reuse the straggler threshold; transitions
        count into ``fleet.dynamics.skew_alerts``."""
        per_rank = {}
        for r, s in rank_snaps.items():
            d = s.get("dynamics")
            if isinstance(d, dict) and d.get("grad_norm") is not None:
                per_rank[r] = d
        if not per_rank:
            # dynamics went away (disabled on restart, no spill yet):
            # retire the gauge and the flag state, like the straggler
            # detector's vanished-rank retirement — a stale skew must
            # not linger in the exposition, and a later re-flag must
            # still count as an off -> on transition. ADVANCING rounds
            # only: a /fleetz?refresh=1 scrape racing a re-forming world
            # must not perturb alert-transition state (the straggler
            # window keeps the same contract).
            if advance:
                with self._lock:
                    self._gn_flagged = set()
                self.registry.remove("fleet.grad_norm_skew")
            return None
        norms = {r: float(d["grad_norm"]) for r, d in per_rank.items()}
        med = _median(list(norms.values()))
        worst = max(norms, key=norms.get)
        lo = min(norms.values())
        skew = round(norms[worst] / med, 4) if med > 0 else 1.0
        self.registry.gauge(
            "fleet.grad_norm_skew",
            help="max-rank grad norm / median-rank grad norm at the last "
                 "merge (a desyncing rank shows here before loss "
                 "diverges)").set(skew)
        flagged = set()
        if len(norms) >= 2 and med > 0:
            # both tails: a rank desyncs by exploding (corrupt shard,
            # diverged local state) OR by collapsing toward zero (dead
            # shard, flat region) — the low outlier is the one a
            # high-only ratio never sees
            flagged = {r for r, v in norms.items()
                       if v >= med * self.threshold
                       or v <= med / self.threshold}
        out = {
            "ranks": {str(r): {
                "grad_norm": norms[r],
                "loss": d.get("loss"),
                "loss_z": d.get("loss_z"),
                "step": d.get("step"),
                "nonfinite_steps": d.get("nonfinite_steps"),
                "nonfinite_first": d.get("nonfinite_first"),
            } for r, d in sorted(per_rank.items())},
            "median_grad_norm": round(med, 8),
            "max_rank": worst,
            "skew": skew,
            # the full max-min range over the median: catches the LOW
            # outlier the max/median ratio cannot (same rationale as the
            # phase-stats spread)
            "spread": round((norms[worst] - lo) / med, 4) if med > 0
            else 0.0,
            "flagged": sorted(flagged),
            "nonfinite_ranks": sorted(
                r for r, d in per_rank.items()
                if (d.get("nonfinite_steps") or 0) > 0),
        }
        if advance:
            with self._lock:
                newly = flagged - self._gn_flagged
                if newly:
                    self.registry.counter(
                        "fleet.dynamics.skew_alerts",
                        help="grad-norm-skew flag transitions (off -> on) "
                             "per rank across merges").inc(len(newly))
                self._gn_flagged = flagged
        return out

    def _devprof_agg(self, rank_snaps, advance=True):
        """Merge the per-rank devprof blocks into the sick-chip
        view: every data-parallel rank runs the SAME compiled programs, so
        per-program device time off the cross-rank median is a device
        problem (thermal throttle, degraded HBM, bad chip), not a slow
        host — the exact complement of the straggler detector's
        compute-vs-wait split. A rank's score is the median over shared
        programs of (rank device time / fleet-median device time); the
        threshold reuses the straggler ratio and transitions count into
        ``fleet.devprof.skew_alerts``."""
        per_rank = {}
        for r, s in rank_snaps.items():
            d = s.get("devprof")
            if isinstance(d, dict) and d.get("programs"):
                per_rank[r] = {str(k): float(v)
                               for k, v in d["programs"].items()
                               if isinstance(v, (int, float)) and v > 0}
        per_rank = {r: p for r, p in per_rank.items() if p}
        if not per_rank:
            # devprof went away (disabled on restart, nothing sampled):
            # retire the gauge + flag state on ADVANCING rounds only —
            # same contract as the dynamics retirement above
            if advance:
                with self._lock:
                    self._dp_flagged = set()
                self.registry.remove("fleet.devprof.skew")
            return None
        # fleet-median device time per program, over the ranks that ran it
        medians = {}
        for p in per_rank.values():
            for k in p:
                medians.setdefault(k, []).append(p[k])
        medians = {k: _median(v) for k, v in medians.items()}
        scores = {}
        for r, p in per_rank.items():
            ratios = sorted(p[k] / medians[k] for k in p if medians[k] > 0)
            if ratios:
                scores[r] = round(_median(ratios), 4)
        if not scores:
            return None
        worst = max(scores, key=scores.get)
        skew = scores[worst]
        self.registry.gauge(
            "fleet.devprof.skew",
            help="max-rank per-program device time / fleet median at the "
                 "last merge (a sick chip shows here; a slow host shows "
                 "in the straggler split)").set(skew)
        flagged = set()
        if len(scores) >= 2:
            # both tails: slow = the sick chip; implausibly FAST means
            # the rank is not running the same work (sharding/config
            # divergence) — the tail a slow-only ratio never sees
            flagged = {r for r, v in scores.items()
                       if v >= self.threshold or v <= 1.0 / self.threshold}
        out = {
            "ranks": {str(r): {
                "score": scores.get(r),
                "programs": {k: round(v, 9) for k, v in
                             sorted(p.items())},
            } for r, p in sorted(per_rank.items())},
            "program_median_s": {k: round(v, 9)
                                 for k, v in sorted(medians.items())},
            "max_rank": worst,
            "skew": skew,
            "flagged": sorted(flagged),
        }
        if advance:
            with self._lock:
                newly = flagged - self._dp_flagged
                if newly:
                    self.registry.counter(
                        "fleet.devprof.skew_alerts",
                        help="per-program device-time skew flag "
                             "transitions (off -> on) per rank across "
                             "merges").inc(len(newly))
                self._dp_flagged = flagged
        return out

    # ---- straggler detection ----------------------------------------------
    @staticmethod
    def _rank_step_totals(snap):
        """Lifetime (step_sum, step_count, wait_total) for one rank's
        snapshot — wait comes from the collective seam accumulators
        (falling back to the ``collective.wait_s`` series)."""
        fams = FleetAggregator._rank_family_stats(
            snap, lambda f: f in _STEP_FAMILIES or f == "collective.wait_s")
        step = next((fams[f] for f in _STEP_FAMILIES if f in fams), None)
        if step is None or not step[1]:
            return None
        wait_total = sum(rec.get("wait_s", 0.0)
                         for rec in (snap.get("collectives") or {}).values())
        if not wait_total and "collective.wait_s" in fams:
            wait_total = fams["collective.wait_s"][0]
        return step[0], step[1], wait_total

    def _rank_step_split(self, rank, snap, advance):
        """(step_mean, wait_per_step, compute_mean, steps) for the steps
        since the PREVIOUS advancing round — histograms accumulate over
        the process lifetime, and lifetime means would dilute a rank
        that degrades mid-run past ever tripping an 8-round window.
        Falls back to lifetime means on first sight of a rank (or after
        its counters reset, e.g. a restart with a fresh registry)."""
        totals = self._rank_step_totals(snap)
        if totals is None:
            return None
        step_sum, step_count, wait_total = totals
        with self._lock:
            prev = self._prev_totals.get(rank)
            if advance:
                self._prev_totals[rank] = totals
        if prev is not None and step_count > prev[1]:
            d_steps = step_count - prev[1]
            step_mean = (step_sum - prev[0]) / d_steps
            wait_per_step = max(wait_total - prev[2], 0.0) / d_steps
        else:
            # first sight, counters reset, or no new steps this round:
            # the lifetime means are the best available estimate
            step_mean = step_sum / step_count
            wait_per_step = wait_total / step_count
        compute_mean = max(step_mean - wait_per_step, 0.0)
        return step_mean, wait_per_step, compute_mean, step_count

    def _straggler(self, rank_snaps, advance=True):
        splits = {}
        for r, snap in rank_snaps.items():
            split = self._rank_step_split(r, snap, advance)
            if split is not None:
                splits[r] = split
        result = {"window": self.window, "threshold": self.threshold,
                  "rounds": self._rounds, "ranks": {},
                  "persistent": sorted(self._persistent)}
        # departed ranks (stale-fenced, shrunk world) leave the window
        # and the persistent set even when too few peers remain to score
        if advance:
            with self._lock:
                for r in list(self._history):
                    if r not in splits:
                        self._history.pop(r)
                        self._persistent.discard(r)
                for r in list(self._prev_totals):
                    if r not in rank_snaps:
                        self._prev_totals.pop(r)
                result["persistent"] = sorted(self._persistent)
        # ... and their score gauges leave the exposition (remove() —
        # a departed rank must vanish from /varz, not report its last
        # score forever). Before the <2-peers return: a shrink to one
        # survivor still retires everyone who left.
        with self._lock:
            for r in self._scored_ranks - set(splits):
                self.registry.remove("fleet.straggler.score",
                                     labels={"rank": str(r)})
            self._scored_ranks = set(splits)
        if len(splits) < 2:
            return result  # skew needs peers to be skewed against
        med_compute = _median([s[2] for s in splits.values()])
        med_wait = _median([s[1] for s in splits.values()])
        eps = 1e-9
        verdicts = {}
        for r, (step_mean, wait, compute, _n) in sorted(splits.items()):
            compute_ratio = compute / max(med_compute, eps)
            wait_ratio = wait / max(med_wait, eps) if med_wait > eps else (
                1.0 if wait <= eps else float("inf"))
            if compute_ratio >= self.threshold:
                verdict = "compute"
            elif wait >= med_wait * self.threshold \
                    and wait > 0.1 * max(step_mean, eps):
                verdict = "collective_wait"
            else:
                verdict = "ok"
            verdicts[r] = verdict
            result["ranks"][str(r)] = {
                "step_mean_s": round(step_mean, 6),
                "collective_wait_per_step_s": round(wait, 6),
                "compute_mean_s": round(compute, 6),
                "compute_ratio": round(compute_ratio, 4),
                "wait_ratio": (round(wait_ratio, 4)
                               if math.isfinite(wait_ratio) else "inf"),
                "verdict": verdict,
            }
            self.registry.gauge(
                "fleet.straggler.score", labels={"rank": str(r)},
                help="per-rank compute mean / cross-rank median (sliding "
                     "straggler score)").set(round(compute_ratio, 4))
        # sliding window: persistence separates a one-round blip from a
        # rank that is ALWAYS the slow one. Mutated only on ADVANCING
        # rounds (the monitor cadence) — a view refresh reports the
        # current window read-only, so the verdict tracks cluster
        # behavior, never the scrape rate.
        with self._lock:
            if advance:
                self._rounds += 1
                for r, verdict in verdicts.items():
                    hist = self._history.get(r)
                    if hist is None:
                        hist = self._history[r] = collections.deque(
                            maxlen=self.window)
                    hist.append(verdict)
            result["rounds"] = self._rounds
            # STRICT majority of the full window, and the window must
            # have accumulated at least that many rounds: a rank flagged
            # in the first 2 ticks after aggregator start (cold-compile
            # warm-up skew is normal) is a blip, not persistence
            need = self.window // 2 + 1
            newly_persistent = set()
            for r, hist in self._history.items():
                flagged = sum(1 for v in hist if v == "compute")
                if str(r) in result["ranks"]:
                    result["ranks"][str(r)]["flagged_rounds"] = flagged
                if len(hist) >= need and flagged >= need:
                    newly_persistent.add(r)
            new_alerts = set()
            if advance:
                new_alerts = newly_persistent - self._persistent
                for r in new_alerts:
                    self.registry.counter(
                        "fleet.straggler.alerts",
                        help="persistent-straggler transitions (off -> on) "
                             "over the sliding window").inc()
                self._persistent = newly_persistent
            result["persistent"] = sorted(self._persistent)
        if new_alerts:
            # flight-record the alert: freeze the window
            # verdicts + per-rank splits at the transition. Outside the
            # lock — committing a bundle is file I/O.
            from . import flightrec

            flightrec.record(
                "straggler",
                payload={"new_persistent": sorted(new_alerts),
                         "persistent": result["persistent"],
                         "window": self.window,
                         "ranks": dict(result["ranks"])})
        return result

    def straggler_advisory(self):
        """One log line for the launcher (None when nothing persists):
        advisory input recorded alongside restart-budget decisions."""
        view = self._last_view
        if not view:
            return None
        strag = view.get("straggler") or {}
        parts = []
        for r in strag.get("persistent", ()):
            info = strag.get("ranks", {}).get(str(r), {})
            parts.append(
                f"rank {r} computing {info.get('compute_ratio', '?')}x the "
                f"median (flagged {info.get('flagged_rounds', '?')}/"
                f"{strag.get('window')} rounds)")
        if not parts:
            return None
        return "fleet straggler advisory: " + "; ".join(parts)

    # ---- serving aggregation (cross-process replicas) ---------------------
    def _serving_agg(self, replica_snaps):
        if not replica_snaps:
            return None
        sources = self._metric_sources(
            {("replica", r): s for r, s in replica_snaps.items()})
        # occupancy averages LIVE replicas only, matching serving_rollup:
        # a dead replica's gauge lingers in its frontend's registry at
        # zero, and averaging it in dilutes the pressure signal exactly
        # when the survivors saturate. Known handle names with a non-LIVE
        # state are excluded; unknown label values (no matching replica
        # block) stay counted.
        dead_names = {rep.get("name")
                      for s in replica_snaps.values()
                      for rep in (s.get("replica") or {},)
                      if rep.get("name") and rep.get("state") != "LIVE"}
        queue = occ = pages = 0.0
        occ_n = 0
        counters = {}
        # _metric_sources already collapsed shared-registry twins to one
        # snapshot per (pid, registry); every remaining source is an
        # independent process, so identically-named series SUM — dropping
        # them would undercount every frontend after the first
        for s in sources:
            for rec in s.get("metrics", ()):
                fam = rec["family"]
                if not fam.startswith("serving."):
                    continue
                if rec.get("type") == "counter":
                    counters[fam] = counters.get(fam, 0) + rec.get("value", 0)
                elif rec.get("type") == "gauge":
                    v = rec.get("value", 0.0)
                    if fam == "serving.replica.queue_depth":
                        queue += v
                    elif fam == "serving.replica.occupancy":
                        if (rec.get("labels") or {}).get("replica") \
                                in dead_names:
                            continue
                        occ += v
                        occ_n += 1
                    elif fam == "serving.replica.pages_in_use":
                        pages += v
        replicas = {}
        for r, s in sorted(replica_snaps.items()):
            rep = s.get("replica") or {}
            replicas[str(r)] = {
                "state": rep.get("state"),
                "pending": rep.get("pending"),
                "active": rep.get("active"),
                "load": rep.get("load"),
                "age_s": round(time.time() - s.get("time", 0), 3),
            }
        return {
            "replicas": replicas,
            "queue_depth": queue,
            "occupancy_mean": round(occ / occ_n, 4) if occ_n else 0.0,
            "pages_in_use": pages,
            "counters": counters,
        }

    # ---- Prometheus merge --------------------------------------------------
    def merged_registry(self, snaps=None):
        """A fresh MetricsRegistry holding every source series widened
        with its origin label (``rank=`` / ``replica=``): labeled
        families stay grouped under one ``# HELP``/``# TYPE`` after the
        merge, which is what a real scraper of the aggregated /varz
        requires (asserted against the strict exposition parser)."""
        if snaps is None:
            snaps, _ = load_snapshots(self.dirs)
        # same fences as merge(): the exposition and the JSON view of one
        # directory must agree — a dead publisher's gauges must not
        # outlive it in /varz-style dashboards either
        snaps, _ = self._fence_stale(snaps)
        _, _, kept, _ = self._fence(snaps)
        by_id = self._dedupe(kept)
        sources = self._metric_sources(by_id)
        merged = MetricsRegistry()
        for s in sources:
            if s.get("role") == "replica":
                # replica indexes repeat across frontend processes: the
                # origin label carries the full identity
                label_key = "replica"
                label_val = f"{s.get('rank', 0)}@{self._source_id(s)}"
            else:
                label_key = "rank"
                label_val = str(s.get("rank", 0))
            extra = {label_key: label_val}
            for rec in s.get("metrics", ()):
                labels = dict(rec.get("labels") or {})
                if label_key in labels:
                    # the record already uses the origin key as a label
                    # (e.g. serving.replica.*{replica=...}): disambiguate
                    # under a secondary key instead of dropping — replica
                    # NAMES repeat across frontend processes, and
                    # first-wins would discard every process after the
                    # first (shared-registry twins were already collapsed
                    # by _metric_sources, so a key collision here is
                    # always a distinct source)
                    extra_for_rec = {"origin": label_val}
                else:
                    extra_for_rec = extra
                merged.load_series(rec, extra_labels=extra_for_rec)
        return merged

    def to_prometheus(self, snaps=None):
        """The merged fleet /varz payload."""
        return self.merged_registry(snaps).to_prometheus()


def bench_block():
    """The ``extra.fleet`` block of a bench line: publish this process's
    snapshot (into the configured telemetry dir, or a scratch dir),
    aggregate, and distill (snapshot count, the worst cross-rank phase
    skew, straggler verdicts), so every bench run records cluster health
    next to its numbers. Never raises: a failure is an ``error`` key."""
    import tempfile

    d = env_str("PADDLE_TELEMETRY_DIR")
    scratch = None
    if not d:
        scratch = tempfile.mkdtemp(prefix="paddle_fleet_bench_")
        d = scratch
    try:
        SnapshotPublisher(d, rank=env_int("PADDLE_TRAINER_ID", 0),
                          min_interval_s=0.0).publish()
        agg = FleetAggregator(d, registry=MetricsRegistry())
        view = agg.collect()
        phases = view.get("phases") or {}
        max_skew, skew_phase = 0.0, None
        for fam, e in phases.items():
            if e["skew"] > max_skew:
                max_skew, skew_phase = e["skew"], fam
        strag = view.get("straggler") or {}
        return {
            "snapshots": len(view.get("members") or {}),
            "generation": view.get("generation"),
            "fenced_out": view.get("fenced_out"),
            "max_skew": round(max_skew, 4),
            "skew_phase": skew_phase,
            "stragglers": {r: info["verdict"]
                           for r, info in (strag.get("ranks") or {}).items()
                           if info["verdict"] != "ok"},
        }
    except Exception as e:  # the bench line must land regardless
        return {"error": f"{type(e).__name__}: {str(e)[:200]}"}
    finally:
        if scratch is not None:
            import shutil

            shutil.rmtree(scratch, ignore_errors=True)


# ---------------------------------------------------------------------------
# cluster serving rollup (live, in-frontend)
# ---------------------------------------------------------------------------
def serving_rollup(replica_snapshots, slo_report, goodput_report):
    """The ``serving_report()["fleet"]`` block: one cluster-level view —
    per-replica burn inputs are already cluster-scoped (the SLO monitor
    spans every dispatcher), so this distills replicas + burn + goodput
    into the single ``pressure``/``scale_hint`` signal an autoscaler
    reads, and publishes the ``fleet.serving.*`` gauges a scraper joins
    with the training-side fleet view."""
    states = [s.get("state") for s in replica_snapshots.values()]
    live = sum(1 for st in states if st == "LIVE")
    queue_depth = sum(s.get("pending") or 0
                      for s in replica_snapshots.values())
    # occupancy over LIVE replicas only, matching the slots accounting:
    # averaging in DEAD replicas' zero occupancy dilutes the pressure
    # signal exactly when the survivors are saturated — the moment an
    # autoscaler most needs to hear "grow"
    occs, slots = [], 0
    for s in replica_snapshots.values():
        max_seqs = s.get("max_seqs") or 0
        if max_seqs and s.get("state") == "LIVE":
            occs.append((s.get("active") or 0) / max_seqs)
            slots += max_seqs
    occupancy_mean = round(sum(occs) / len(occs), 4) if occs else 0.0
    # cluster KV fabric: advertised prefix residency summed
    # across replicas — the router scores placement against this index,
    # so the rollup is how an operator sees the cluster cache's size
    kv_resident = sum(s.get("kv_resident") or 0
                      for s in replica_snapshots.values())
    # the multi-window AND: an objective pages only when BOTH windows
    # burn, so min(fast, slow) is the page-relevant burn per objective
    worst_burn, worst_objective = 0.0, None
    for name, r in (slo_report.get("objectives") or {}).items():
        burn = min(r.get("fast", 0.0), r.get("slow", 0.0))
        if burn > worst_burn:
            worst_burn, worst_objective = burn, name
    alerts = slo_report.get("alerts") or []
    queue_pressure = (min(1.0, queue_depth / slots) if slots
                      else (1.0 if queue_depth else 0.0))
    pressure = round(max(occupancy_mean, queue_pressure), 4)
    if alerts or (live == 0 and states):
        scale_hint = "grow"
    elif pressure > 0.85:
        scale_hint = "grow"
    elif pressure < 0.15 and live > 1 and worst_burn < 1.0:
        scale_hint = "shrink"
    else:
        scale_hint = "hold"
    _registry.gauge(
        "fleet.serving.live_replicas",
        help="replicas currently LIVE in this serving cell").set(live)
    _registry.gauge(
        "fleet.serving.queue_depth",
        help="cluster-wide routed-but-not-admitted requests").set(
        queue_depth)
    _registry.gauge(
        "fleet.serving.occupancy_mean",
        help="mean decode-slot occupancy across replicas").set(
        occupancy_mean)
    _registry.gauge(
        "fleet.serving.worst_burn",
        help="worst min(fast, slow) SLO burn rate across objectives"
    ).set(round(worst_burn, 4))
    _registry.gauge(
        "fleet.serving.pressure",
        help="blended autoscaling pressure signal (0..1)").set(pressure)
    _registry.gauge(
        "fleet.serving.kv_resident",
        help="cluster KV-fabric prefix entries advertised across "
             "replicas").set(kv_resident)
    # per-role sub-rollup: a disaggregated fleet's prefill and
    # decode pools saturate independently, so each role gets its own
    # pressure + scale_hint — the supervisor scales the pools off these,
    # and a blended mean can no longer hide one saturated pool behind the
    # other's idle slots. Homogeneous fleets roll up as one "blended" role.
    by_role = {}
    for s in replica_snapshots.values():
        role = s.get("role") or "blended"
        r = by_role.setdefault(role, {"replicas": 0, "live": 0,
                                      "queue_depth": 0, "occs": [],
                                      "slots": 0})
        r["replicas"] += 1
        r["queue_depth"] += s.get("pending") or 0
        max_seqs = s.get("max_seqs") or 0
        if s.get("state") == "LIVE":
            r["live"] += 1
            if max_seqs:
                r["occs"].append((s.get("active") or 0) / max_seqs)
                r["slots"] += max_seqs
    roles = {}
    for role, r in sorted(by_role.items()):
        occ = (round(sum(r["occs"]) / len(r["occs"]), 4)
               if r["occs"] else 0.0)
        qp = (min(1.0, r["queue_depth"] / r["slots"]) if r["slots"]
              else (1.0 if r["queue_depth"] else 0.0))
        p = round(max(occ, qp), 4)
        if alerts or (r["live"] == 0 and r["replicas"]):
            hint = "grow"
        elif p > 0.85:
            hint = "grow"
        elif p < 0.15 and r["live"] > 1 and worst_burn < 1.0:
            hint = "shrink"
        else:
            hint = "hold"
        _registry.gauge(
            "serving.role.pressure", labels={"role": role},
            help="per-role autoscaling pressure (0..1) — prefill/decode "
                 "pools saturate independently").set(p)
        _registry.gauge(
            "serving.role.live_replicas", labels={"role": role},
            help="LIVE replicas per disaggregation role").set(r["live"])
        roles[role] = {"replicas": r["replicas"], "live": r["live"],
                       "queue_depth": r["queue_depth"],
                       "occupancy_mean": occ, "pressure": p,
                       "scale_hint": hint}
    return {
        "replicas": len(replica_snapshots),
        "live_replicas": live,
        "queue_depth": queue_depth,
        "occupancy_mean": occupancy_mean,
        "goodput": {k: round(v, 4) for k, v in
                    (goodput_report.get("fractions") or {}).items()},
        "slo": {
            "worst_burn": round(worst_burn, 4),
            "worst_objective": worst_objective,
            "alerting": [a.get("objective") for a in alerts],
        },
        "pressure": pressure,
        "scale_hint": scale_hint,
        "roles": roles,
        "kv_resident": kv_resident,
    }
