"""Per-request LoRA adapters: the host registry (counterpart of
``paddle_tpu/serving/adapters.py``).

One base model serves many tenants' low-rank deltas. This module keeps
the host side: a ref-counted, LRU-bounded, digest-keyed cache of rank-r
A/B pairs. The device side lives in ``inference/continuous.py``: the
engine gathers each batch row's adapter weights from fixed-depth stacks,
so one batch serves mixed adapters.

Adapter math (the engine's contract): the adapter updates the LM-head
projection,

    logits = base_head(h) + scale * (h @ A) @ B

with ``A [hidden, r]`` and ``B [r, vocab]`` float32. Rows without an
adapter ride the stacks' zero slot (a ``+ 0.0`` delta), and a batch with
no adapter at all runs the base path untouched.

Trust and size limits: adapter weights are tenant-supplied data, plain
float32 arrays validated by shape and dtype at registration; anything
else is a ``ValueError``. ``PADDLE_LORA_MAX_MB`` bounds one adapter and
``PADDLE_LORA_CACHE_MB`` the whole cache (read through ``utils/envs.py``);
eviction is LRU over refcount-0 entries only, so an adapter pinned by
in-flight requests is never evicted from under them.

Identity is the content digest (a keyed blake2b over A, B and the scale,
the reference's key and order, so the same arrays give the same digest in
both packages): registering identical weights under any name is
idempotent, and the digest is what the engine's device cache keys on;
names are a human alias.
"""
import hashlib
import threading
from collections import OrderedDict

import numpy as np

from ..observability.metrics import registry as _registry
from ..utils.envs import env_int

__all__ = ["LoRAAdapter", "AdapterRegistry"]

#: the environment names the registry reads (utils/envs.py), in MB
MAX_MB_ENV = "PADDLE_LORA_MAX_MB"
CACHE_MB_ENV = "PADDLE_LORA_CACHE_MB"

_G_CACHE_BYTES = _registry.gauge(
    "lora.cache_bytes", help="host bytes resident in the adapter cache")
_G_CACHE_ENTRIES = _registry.gauge(
    "lora.cache_entries", help="adapters resident in the host cache")
_M_REGISTERED = _registry.counter(
    "lora.registered", help="adapter registrations accepted (idempotent "
                            "re-registrations not counted)")
_M_EVICTED = _registry.counter(
    "lora.evicted", help="refcount-0 adapters LRU-evicted to make room")


class LoRAAdapter:
    """One immutable adapter: ``a [hidden, r]``, ``b [r, vocab]``
    float32, a scalar ``scale``, and the content digest that names it
    below the registry."""

    __slots__ = ("name", "a", "b", "scale", "rank", "digest", "nbytes")

    def __init__(self, name, a, b, scale=1.0):
        a = np.asarray(a)
        b = np.asarray(b)
        if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[0]:
            raise ValueError(
                f"adapter {name!r}: need a [hidden, r] and b [r, vocab] "
                f"with matching r, got {a.shape} / {b.shape}")
        if a.dtype != np.float32 or b.dtype != np.float32:
            # float32 data only: other dtypes are refused, not coerced
            raise ValueError(
                f"adapter {name!r}: weights must be float32, got "
                f"{a.dtype} / {b.dtype}")
        self.name = str(name)
        self.a = np.ascontiguousarray(a)
        self.b = np.ascontiguousarray(b)
        self.scale = float(scale)
        self.rank = int(a.shape[1])
        if self.rank < 1:
            raise ValueError(f"adapter {name!r}: rank must be >= 1")
        self.nbytes = self.a.nbytes + self.b.nbytes
        h = hashlib.blake2b(digest_size=16, key=b"paddle-lora-v1")
        h.update(self.a.tobytes())
        h.update(self.b.tobytes())
        h.update(np.float64(self.scale).tobytes())
        self.digest = h.hexdigest()

    def __repr__(self):
        return (f"LoRAAdapter({self.name!r}, rank={self.rank}, "
                f"scale={self.scale}, digest={self.digest[:8]}...)")


class AdapterRegistry:
    """Ref-counted LRU host cache of :class:`LoRAAdapter`.

    ``register`` validates and inserts; ``acquire``/``release`` bracket a
    request's use, and eviction only touches refcount-0 entries. Lookup
    is by name or digest."""

    def __init__(self, max_bytes=None, max_adapter_bytes=None):
        self.max_bytes = (env_int(CACHE_MB_ENV, 256) * (1 << 20)
                          if max_bytes is None else int(max_bytes))
        self.max_adapter_bytes = (
            env_int(MAX_MB_ENV, 64) * (1 << 20)
            if max_adapter_bytes is None else int(max_adapter_bytes))
        self._lock = threading.Lock()
        self._by_name = OrderedDict()   # name -> LoRAAdapter (LRU order)
        self._by_digest = {}            # digest -> LoRAAdapter
        self._refs = {}                 # digest -> in-flight refcount
        self._nbytes = 0

    def __len__(self):
        with self._lock:
            return len(self._by_name)

    @property
    def nbytes(self):
        return self._nbytes

    # ---- registration -----------------------------------------------------
    def register(self, name, a, b, scale=1.0):
        """Validate and insert; returns the LoRAAdapter. Idempotent for
        identical content under the same name; replacing a name's weights
        is allowed only while no request holds the old ones. Raises
        ``ValueError`` on malformed weights, an adapter over the
        per-adapter bound, or a cache that cannot fit it even after
        evicting every idle entry."""
        adapter = LoRAAdapter(name, a, b, scale=scale)
        if adapter.nbytes > self.max_adapter_bytes:
            raise ValueError(
                f"adapter {name!r} is {adapter.nbytes} bytes > "
                f"max_adapter_bytes={self.max_adapter_bytes} "
                f"(PADDLE_LORA_MAX_MB)")
        with self._lock:
            old = self._by_name.get(adapter.name)
            if old is not None:
                if old.digest == adapter.digest:
                    self._by_name.move_to_end(adapter.name)
                    return old          # identical content: idempotent
                if self._refs.get(old.digest, 0) > 0:
                    raise ValueError(
                        f"adapter {name!r} is held by in-flight requests; "
                        f"register the new weights under a new name")
                self._drop_locked(old)
            self._evict_for_locked(adapter.nbytes)
            if self._nbytes + adapter.nbytes > self.max_bytes:
                raise ValueError(
                    f"adapter cache full: {self._nbytes} + {adapter.nbytes}"
                    f" bytes > max_bytes={self.max_bytes} and every "
                    f"resident adapter is held by in-flight requests")
            self._by_name[adapter.name] = adapter
            self._by_digest[adapter.digest] = adapter
            self._nbytes += adapter.nbytes
            _M_REGISTERED.inc()
            self._set_gauges_locked()
        return adapter

    def _drop_locked(self, adapter):
        self._by_name.pop(adapter.name, None)
        self._by_digest.pop(adapter.digest, None)
        self._refs.pop(adapter.digest, None)
        self._nbytes -= adapter.nbytes
        self._set_gauges_locked()

    def _evict_for_locked(self, need):
        # LRU over refcount-0 entries only
        while self._nbytes + need > self.max_bytes:
            victim = next((ad for ad in self._by_name.values()
                           if self._refs.get(ad.digest, 0) == 0), None)
            if victim is None:
                return
            self._drop_locked(victim)
            _M_EVICTED.inc()

    def _set_gauges_locked(self):
        _G_CACHE_BYTES.set(self._nbytes)
        _G_CACHE_ENTRIES.set(len(self._by_name))

    # ---- lookup / refcounting ---------------------------------------------
    def _resolve_locked(self, ref):
        if isinstance(ref, LoRAAdapter):
            ref = ref.digest
        ad = self._by_digest.get(ref)
        return ad if ad is not None else self._by_name.get(ref)

    def get(self, ref):
        """Name | digest | LoRAAdapter -> LoRAAdapter | None (no ref)."""
        with self._lock:
            return self._resolve_locked(ref)

    def acquire(self, ref):
        """Resolve and pin for one in-flight request; ``ValueError`` for
        an unknown ref (requests must name registered adapters)."""
        with self._lock:
            ad = self._resolve_locked(ref)
            if ad is None:
                raise ValueError(f"unknown LoRA adapter {ref!r}")
            self._refs[ad.digest] = self._refs.get(ad.digest, 0) + 1
            self._by_name.move_to_end(ad.name)
            return ad

    def release(self, ref):
        """Unpin (idempotent past zero: a double release never pins
        negatively)."""
        with self._lock:
            ad = self._resolve_locked(ref)
            if ad is None:
                return
            n = self._refs.get(ad.digest, 0)
            if n <= 1:
                self._refs.pop(ad.digest, None)
            else:
                self._refs[ad.digest] = n - 1

    def refcount(self, ref):
        with self._lock:
            ad = self._resolve_locked(ref)
            return 0 if ad is None else self._refs.get(ad.digest, 0)

    # ---- introspection ----------------------------------------------------
    def report(self):
        with self._lock:
            return {
                "entries": len(self._by_name),
                "bytes": self._nbytes,
                "max_bytes": self.max_bytes,
                "max_adapter_bytes": self.max_adapter_bytes,
                "adapters": [
                    {"name": ad.name, "digest": ad.digest,
                     "rank": ad.rank, "scale": ad.scale,
                     "nbytes": ad.nbytes,
                     "inflight": self._refs.get(ad.digest, 0)}
                    for ad in self._by_name.values()],
            }
