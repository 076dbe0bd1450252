"""Cluster KV-page fabric: a tiered prefix cache with typed degradation (the
port's own copy of ``paddle_tpu/serving/kvfabric.py``).

The engine's per-replica prefix index reuses KV pages only when
the SAME replica saw the prefix. This module widens that to the cluster
via a tier ladder — each tier strictly cheaper than the next, each
failure a typed fallthrough to the one below, recompute the
unconditional floor:

    device pool   — the engine's own prefix index (free; not this module,
                    but advertised into the residency map so peers know)
    host spill    — :class:`HostSpillRing`, a bounded LRU of framed
                    entries evicted/spilled from the device pool
    peer fetch    — :meth:`WireTransport.fetch_blob` from a replica that
                    advertised the prefix, digest-validated on arrival
    recompute     — prefill from scratch; always correct, always there

The robustness contract is the headline: **a failed fetch is strictly
cheaper than a wrong one.** Every failure mode — torn frame, digest
mismatch, fetch timeout, peer death mid-stream, partition, brownout
shed — ends in a typed ``kv.fallthrough{reason=}`` plus transparent
recompute, bit-identical to the no-fabric path (the sampled key stream
depends only on (seed, rid, index), never on where the KV pages came
from). A pure miss is not a fallthrough and is not counted.

Residency: replicas advertise which prefixes they hold
(:meth:`advertise_prompt` / :meth:`spill`); the map feeds the router's
transfer-discounted peer-affinity term (:meth:`resident_owners`), the
fleet rollup (``fleet.serving.kv_resident``), and ``/kvz``. The
supervisor evicts a dead replica's advertisements
(:meth:`evict_replica`) — a corpse must not attract placements.

Keying: an entry for the first ``n`` pages of a prompt is keyed
``digests[n-1].hex() + ":" + n`` using the chained keyed blake2b page
digests (:func:`.handoff.page_digests`). Chained digests of shared
prefixes are equal, so an n-page entry hits ANY longer prompt at n —
partial-prefix reuse with no payload slicing and no prompt-token keys
on the wire.

Chaos seam: ``serving.kv.fetch`` fires per peer-fetch attempt; the
transport adds ``serving.kv.{timeout,partition,corrupt}``. Together the
four make every fallthrough row a deterministic drill (docs/CHAOS.md).
"""
import threading
import time
from collections import OrderedDict

import numpy as np

from ..observability.metrics import registry as _registry
from ..testing import chaos
from . import wireformat
from .handoff import HandoffCorruptError, HandoffError, page_digests
from .transport import frame_blob, unframe_blob
from ..utils.envs import env_bool, env_float, env_int

__all__ = ["KVFabric", "HostSpillRing"]

_M_FALLTHROUGHS = _registry.counter(
    "kv.fallthroughs", help="total typed tier-ladder fallthroughs")
_M_FETCH_S = _registry.histogram(
    "kv.fetch_s", help="peer KV-prefix fetch latency (success only)")
_G_SPILL = _registry.gauge(
    "kv.spill_bytes", help="bytes resident in the host spill ring")
_G_RESIDENCY = _registry.gauge(
    "kv.residency", help="advertised prefix entries across the cluster")


def _hit(tier):
    _registry.counter("kv.hits", labels={"tier": tier},
                      help="prefix-cache hits by tier").inc()


class HostSpillRing:
    """Bounded LRU of framed spill entries — the host-RAM tier.

    Both bounds are hard: inserting past ``max_bytes`` or ``max_entries``
    evicts from the LRU end until the new entry fits. ``put`` returns
    the evicted keys so the fabric can retract their residency
    advertisements (a retracted lie is a miss; an unretracted one is a
    partition drill on every placement). An entry larger than the byte
    bound is refused outright — one monster prefix must not flush the
    whole ring.
    """

    def __init__(self, max_bytes=None, max_entries=None):
        self.max_bytes = (env_int("PADDLE_KV_SPILL_MB", 64) * (1 << 20)
                          if max_bytes is None else int(max_bytes))
        self.max_entries = (env_int("PADDLE_KV_SPILL_ENTRIES", 256)
                            if max_entries is None else int(max_entries))
        self._lock = threading.Lock()
        self._ring = OrderedDict()          # key -> framed bytes
        self._nbytes = 0

    def __len__(self):
        with self._lock:
            return len(self._ring)

    @property
    def nbytes(self):
        return self._nbytes

    def put(self, key, framed):
        """Insert (or refresh) an entry; returns the list of keys
        evicted to make room (empty when none, ``[key]`` itself when the
        entry is larger than the ring)."""
        size = len(framed)
        evicted = []
        with self._lock:
            old = self._ring.pop(key, None)
            if old is not None:
                self._nbytes -= len(old)
            if size > self.max_bytes:
                self._set_gauge()
                return [key]
            self._ring[key] = framed
            self._nbytes += size
            while (self._nbytes > self.max_bytes
                   or len(self._ring) > self.max_entries):
                k, v = self._ring.popitem(last=False)
                self._nbytes -= len(v)
                evicted.append(k)
            self._set_gauge()
        return evicted

    def get(self, key):
        with self._lock:
            framed = self._ring.get(key)
            if framed is not None:
                self._ring.move_to_end(key)
            return framed

    def discard(self, key):
        with self._lock:
            framed = self._ring.pop(key, None)
            if framed is not None:
                self._nbytes -= len(framed)
                self._set_gauge()

    def _set_gauge(self):
        _G_SPILL.set(self._nbytes)


def prefix_key(digests, n_pages):
    """Registry key for the first ``n_pages`` pages: the chain tail
    identifies the whole prefix (each link is keyed by the previous)."""
    return digests[n_pages - 1].hex() + ":" + str(n_pages)


class KVFabric:
    """Per-frontend view of the cluster KV-page fabric.

    ``transport`` is a :class:`.transport.WireTransport` (or None for a
    spill-ring-only fabric — still useful single-host). Peers register
    via :meth:`register_peer` with either a wire ``"host:port"``
    endpoint string or a callable ``fetcher(key) -> framed bytes|None``
    (tests inject failure shapes without a socket).

    Locking: ``_lock`` guards the residency maps and peer table only.
    Digest-chain computation, ring access, and — critically — peer
    fetches all run OUTSIDE it; candidates are snapshotted under the
    lock, then dialed after release (the blocking-under-lock contract:
    a slow peer must never stall advertise/evict).
    """

    def __init__(self, name="frontend", transport=None, spill=None,
                 clock=time.monotonic):
        self.name = name
        self.enabled = env_bool("PADDLE_KV_FABRIC", True)
        self.transport = transport
        # `is None`, not `or`: a freshly constructed ring is empty and
        # therefore falsy (__len__ == 0) — `or` would silently drop it
        self.spill = spill if spill is not None else HostSpillRing()
        self.clock = clock
        self._lock = threading.Lock()
        self._residency = {}                # key -> set of owner names
        self._by_owner = {}                 # owner -> set of keys
        self._peers = {}                    # owner -> endpoint str | callable
        # capacity-aware peer selection: advisory
        # 0..1 load per peer, stamped by the frontend monitor every tick.
        # Candidates rank least-loaded-first and peers at/above the
        # saturation threshold are skipped outright — fetching from a
        # saturated peer steals exactly the capacity it is short of.
        self._peer_load = {}                # owner -> advertised load
        self.peer_saturation = env_float("PADDLE_KV_PEER_SATURATION", 0.95)

    # ---- residency --------------------------------------------------------
    def _advertise(self, key, owner):
        with self._lock:
            self._residency.setdefault(key, set()).add(owner)
            self._by_owner.setdefault(owner, set()).add(key)
            _G_RESIDENCY.set(len(self._residency))

    def _retract(self, key, owner):
        with self._lock:
            owners = self._residency.get(key)
            if owners is not None:
                owners.discard(owner)
                if not owners:
                    self._residency.pop(key, None)
            keys = self._by_owner.get(owner)
            if keys is not None:
                keys.discard(key)
            _G_RESIDENCY.set(len(self._residency))

    def advertise_prompt(self, prompt, page_size, owner):
        """Advertise every full-page prefix of ``prompt`` as resident on
        ``owner`` (the device tier: the owner's engine indexed these
        pages — peers may fetch or route toward them)."""
        if not self.enabled:
            return
        p = np.asarray(prompt, np.int32).reshape(-1)
        n = len(p) // int(page_size)
        if n <= 0:
            return
        digs = page_digests(p, int(page_size), n)
        for j in range(1, n + 1):
            self._advertise(prefix_key(digs, j), owner)

    def evict_replica(self, owner):
        """Drop every advertisement and the peer registration for a dead
        replica — the supervisor's hook. A corpse must neither attract
        router placements nor be dialed for fetches."""
        with self._lock:
            keys = self._by_owner.pop(owner, set())
            for key in keys:
                owners = self._residency.get(key)
                if owners is not None:
                    owners.discard(owner)
                    if not owners:
                        self._residency.pop(key, None)
            self._peers.pop(owner, None)
            self._peer_load.pop(owner, None)
            _G_RESIDENCY.set(len(self._residency))
        return len(keys)

    def residency_count(self, owner):
        with self._lock:
            return len(self._by_owner.get(owner, ()))

    def resident_owners(self, prompt, page_size):
        """{owner: resident_fraction} over the cluster for ``prompt`` —
        ONE digest pass, called once per router placement, OUTSIDE the
        router lock. Fraction = longest advertised prefix / total full
        pages, so the router's peer-affinity term is comparable to the
        engine's own ``prefix_match_pages`` score."""
        if not self.enabled:
            return {}
        p = np.asarray(prompt, np.int32).reshape(-1)
        n = len(p) // int(page_size)
        if n <= 0:
            return {}
        digs = page_digests(p, int(page_size), n)
        best = {}
        with self._lock:
            for j in range(n, 0, -1):
                for owner in self._residency.get(prefix_key(digs, j), ()):
                    if owner not in best:
                        best[owner] = j / n
        return best

    def register_peer(self, owner, fetcher):
        """``fetcher``: a wire endpoint string (dialed via the
        transport) or a callable ``key -> framed bytes|None``."""
        with self._lock:
            self._peers[owner] = fetcher

    # ---- spill ------------------------------------------------------------
    def spill_prefix(self, prompt, page_size, payload, owner=None):
        """Spill ``payload`` (the engine's opaque page export for every
        full page of ``prompt``) into the host ring, publish it to the
        wire store when a transport is attached, and advertise it.
        Returns the entry key."""
        if not self.enabled:
            return None
        owner = owner or self.name
        p = np.asarray(prompt, np.int32).reshape(-1)
        n = len(p) // int(page_size)
        if n <= 0:
            return None
        digs = page_digests(p, int(page_size), n)
        key = prefix_key(digs, n)
        entry = {"n_pages": n, "page_size": int(page_size),
                 "prompt": p[:n * int(page_size)], "payload": payload}
        framed = frame_blob(wireformat.encode(entry))
        evicted = self.spill.put(key, framed)
        for k in evicted:
            if k != key:
                self._retract(k, owner)
        if key in evicted:              # larger than the whole ring
            return None
        if self.transport is not None:
            try:
                self.transport.put_blob(key, framed)
            except HandoffError:
                pass        # ring copy still serves; wire copy is best-effort
        self._advertise(key, owner)
        return key

    # ---- the tier ladder --------------------------------------------------
    def acquire(self, prompt, page_size, allow_peer=True):
        """Walk the ladder for the longest reusable prefix of ``prompt``.

        Returns ``(entry, tier)`` — ``entry`` the dict stored by
        :meth:`spill_prefix`, ``tier`` in {"host", "peer"} — or None,
        meaning: recompute (the caller's unconditional floor). The
        device tier is not visible here; the engine consults its own
        prefix index before the frontend ever calls this.

        Failure taxonomy: every PEER failure is a counted typed
        fallthrough (timeout / partition / corrupt / fetch_failed /
        peer_fetch_shed); a corrupt RING entry is discarded, counted,
        and the walk continues; a pure miss returns None uncounted.
        """
        if not self.enabled:
            return None
        p = np.asarray(prompt, np.int32).reshape(-1)
        n = len(p) // int(page_size)
        if n <= 0:
            return None
        digs = page_digests(p, int(page_size), n)

        # host tier: longest spilled prefix wins
        for j in range(n, 0, -1):
            key = prefix_key(digs, j)
            framed = self.spill.get(key)
            if framed is None:
                continue
            try:
                entry = self._validate(framed, digs, j, int(page_size))
            except HandoffCorruptError:
                self.spill.discard(key)
                self._retract(key, self.name)
                self.count_fallthrough("corrupt")
                continue
            _hit("host")
            return entry, "host"

        if not allow_peer:
            # counted only when shedding actually cost us candidates —
            # a shed miss is still just a miss
            if self._peer_candidates(digs, n):
                self.count_fallthrough("peer_fetch_shed")
            return None

        # peer tier: snapshot candidates under the lock, dial outside it
        for key, j, owner, fetcher in self._peer_candidates(
                digs, n, count_saturated=True):
            t0 = self.clock()
            try:
                chaos.site("serving.kv.fetch")
                if callable(fetcher):
                    framed = fetcher(key)
                else:
                    framed = self.transport.fetch_blob(fetcher, key)
                if framed is None:
                    raise HandoffError(f"peer {owner} no longer holds {key}")
                entry = self._validate(framed, digs, j, int(page_size))
            except Exception as e:
                self.count_fallthrough(getattr(e, "reason", None) or (
                    "corrupt" if isinstance(e, HandoffCorruptError)
                    else "fetch_failed"))
                continue
            _M_FETCH_S.observe(max(0.0, self.clock() - t0))
            # cache for the next request — mirroring spill_prefix: retract
            # whatever the insert evicted, and advertise only if the entry
            # actually stayed resident (an oversize fetch is consumed here
            # and held nowhere — advertising it would be a residency lie
            # every peer dials into a guaranteed miss)
            evicted = self.spill.put(key, framed)
            for k in evicted:
                if k != key:
                    self._retract(k, self.name)
            if key not in evicted:
                self._advertise(key, self.name)
            _hit("peer")
            return entry, "peer"
        return None

    def _peer_candidates(self, digs, n, count_saturated=False):
        """[(key, n_pages, owner, fetcher)] longest-prefix-first, peers
        with a registered fetcher only, self excluded — gathered under
        the lock so the dial loop runs lock-free.

        Capacity-aware ordering: within one prefix
        length, peers rank by advertised load ascending (name tiebreak —
        deterministic under equal load), and a peer at/above
        ``peer_saturation`` (PADDLE_KV_PEER_SATURATION) is skipped
        entirely; ``count_saturated=True`` (the real fetch walk, not the
        advisory probe) counts one ``peer_saturated`` fallthrough when
        saturation removed at least one candidate."""
        out = []
        skipped = 0
        with self._lock:
            for j in range(n, 0, -1):
                key = prefix_key(digs, j)
                ranked = []
                for owner in self._residency.get(key, ()):
                    if owner == self.name:
                        continue
                    fetcher = self._peers.get(owner)
                    if fetcher is None:
                        continue
                    load = self._peer_load.get(owner, 0.0)
                    if load >= self.peer_saturation:
                        skipped += 1
                        continue
                    ranked.append((load, owner, fetcher))
                for load, owner, fetcher in sorted(
                        ranked, key=lambda c: (c[0], c[1])):
                    out.append((key, j, owner, fetcher))
        if skipped and count_saturated:
            self.count_fallthrough("peer_saturated")
        return out

    def set_peer_load(self, owner, load):
        """Advisory 0..1 load signal for ``owner`` (the frontend monitor
        stamps every replica's blended load each tick; a cluster deploy
        would gossip it). Unknown peers read as load 0 — fetchable."""
        with self._lock:
            self._peer_load[owner] = float(load)

    def peer_load(self, owner):
        with self._lock:
            return self._peer_load.get(owner, 0.0)

    @staticmethod
    def _validate(framed, digs, n_pages, page_size):
        """The trust boundary for ring and wire entries alike: frame
        digest, a NON-EXECUTABLE decode (:mod:`.wireformat` — the wire
        has no peer auth, so the decoder must not be an interpreter),
        then an independent recomputation of the page-digest chain from
        the entry's own prompt bytes against the REQUESTED key's chain.
        Any disagreement is :class:`HandoffCorruptError` — adopting
        would risk a wrong token."""
        payload = unframe_blob(framed)
        try:
            entry = wireformat.decode(payload)
            n = int(entry["n_pages"])
            prompt = np.asarray(entry["prompt"], np.int32).reshape(-1)
        except HandoffError:
            raise
        except Exception as e:
            raise HandoffCorruptError(f"spill entry unreadable: {e}")
        if n != n_pages or int(entry.get("page_size", page_size)) != page_size:
            raise HandoffCorruptError(
                f"spill entry shape mismatch: {n} pages != {n_pages}")
        chain = page_digests(prompt, page_size, n)
        if not chain or chain[-1] != digs[n_pages - 1]:
            raise HandoffCorruptError(
                "spill entry prompt/digest chain mismatch")
        return entry

    # ---- accounting / introspection ---------------------------------------
    def count_fallthrough(self, reason):
        _M_FALLTHROUGHS.inc()
        _registry.counter("kv.fallthrough", labels={"reason": str(reason)},
                          help="tier-ladder fallthroughs by typed reason").inc()

    def report(self):
        """The ``/kvz`` payload — everything an operator needs to judge
        fabric health at a glance."""
        with self._lock:
            by_owner = {o: len(k) for o, k in self._by_owner.items() if k}
            entries = len(self._residency)
            peers = sorted(self._peers)
            peer_load = {o: round(v, 4)
                         for o, v in sorted(self._peer_load.items())}
        counters = {}
        for name in _registry.names(prefix="kv."):
            m = _registry.get(name)
            if m is not None and hasattr(m, "value"):
                counters[name] = m.value
        return {
            "enabled": self.enabled,
            "name": self.name,
            "transport": type(self.transport).__name__
            if self.transport is not None else None,
            "spill": {"entries": len(self.spill),
                      "bytes": self.spill.nbytes,
                      "max_bytes": self.spill.max_bytes,
                      "max_entries": self.spill.max_entries},
            "residency": {"entries": entries, "by_owner": by_owner},
            "peers": peers,
            "peer_load": peer_load,
            "peer_saturation": self.peer_saturation,
            "metrics": counters,
        }
