"""Continuous-batching serving engine over the paged KV pool (counterpart
of ``paddle_tpu/inference/continuous.py``): greedy, sampled and
per-request sampling, float or int8 KV pools, the prefix cache,
per-request LoRA adapters, the handoff hooks and ``warmup``.

Two dispatch planes, as the reference's:

- **ragged** (``ragged=None`` or True, the default): each step is one
  device dispatch. The MIXED dispatch (``_ragged_step``) packs every
  decode row's feed token and up to ``prefill_chunk`` prompt tokens of
  mid-prefill requests into one ``[T]``-token stream, ``T =
  prefill_chunk + max_seqs``, through a ``RaggedLayerCache`` per layer
  (ragged paged attention, K4); every participant takes its first token
  from its last packed token, then ``k - 1`` decode steps run with a
  ``PagedLayerCache`` per layer (paged decode attention, K5). The DECODE
  block (``_decode_block``) runs ``k = decode_block`` steps when no
  prompt is mid-prefill.
- **legacy** (``ragged=False``): a prompt is right-padded to its
  ``prompt_bucket`` and prefilled through fixed-shape dense caches in the
  masked plain attention, the reference's own math tier (no kernel), then
  inserted into its pool pages (``_insert``; an int8 pool quantizes each
  page from f32). A prefix-cache hit gathers the shared pages
  (``_gather_prefix``) and prefills only the suffix against them; under
  ``prefill_chunk`` a long prompt lands in page-aligned chunks, one per
  slot between decode blocks (the chunk ladder). Decode blocks take the
  power-of-two ``k`` below the group's remaining budget (the largest
  under ``async_decode``, the smallest without), each step on K5.

The scheduler is plain host Python between dispatches: admission reserves
``ceil((len(prompt) + max_new_tokens) / page_size)`` pages up front (and
the legacy prefill's bucket-rounded pages; page 0 is scratch), finished
rows retire and free their pages at each readback. A row past its budget
inside a block freezes its write position at its last reserved slot (the
caps clamp). Under ``async_decode`` one block stays in flight: block k+1
is enqueued, fed from block k's device-resident last-token row, before
block k is read back (a non-blocking copy into pinned memory plus an
event), so the host's emit/retire/admit work runs under the device's.

All co-scheduled requests share one sampling tuple (``sampling_overrides``
gives each request its own; a request with another one is deferred until
the group drains). Each request draws from its own noise stream, keyed by
(seed, request id, token index) as the reference's ``fold_in(fold_in(seed,
rid), i)`` is (``generation.gumbel_noise``). An adapter (``serve(adapters=
...)``, ``serving.adapters.LoRAAdapter``) adds ``scale * (h @ A) @ B`` in
f32 to the head's logits; requests of one rank co-schedule with base
requests, which ride the stacks' zero slot; a batch with no adapter runs
the base path and does no LoRA work. ``kv_cache_dtype="int8"`` keeps the
pools as int8 codes with one f32 scale per row; ``enable_prefix_cache``
shares full prompt pages between requests with the same prefix
(content-addressed by a chained blake2b digest, refcounted, LRU-evicted);
both it and ``prefill_chunk`` refuse int8 pools with the reference's
messages.

The online hooks (``try_admit_one``, ``step``, ``drain``, ``idle``,
``active_count``, ``has_free_slot``, ``active_prefills``) and the handoff
hooks (``export_pages``, ``detach_request``, ``adopt_request``) are the
reference's. Each device section holds the engine's ``dispatch_lock`` (a
``_StampedRLock``, shareable between engines); a kernel library's first
build holds the process-wide ``_COMPILE_LOCK`` (``ops/_build.py``), so the
serving frontend's monitor spares a dispatcher that builds. On the card
every engine runs its device work on a CUDA stream of its own (entered by
each public hook), so engines driven from different threads share no
stream: a readback waits for its own engine's blocks only. Nothing crosses
between two engines' streams: a handoff's pages travel as host arrays.

The reference's telemetry seams are kept under its names: the ``serve.*``
metrics, thread spans (``serve.prefill``, ``serve.decode``,
``serve.decode.sync``, ``serve.emit``, ``serve.adopt``, ``serve.admit``),
request-trace spans under the frontend's attempt span (``req.trace``),
the chaos sites ``serve.prefill`` (a failed prefill retires its own slot
alone) and ``serve.decode`` (inside the decode dispatch's bounded retry),
the serving goodput split, the device-time plane (``PADDLE_DEVPROF``), the
compile ledger (a program family's first dispatch, keyed as the
reference's programs are) and OOM forensics.
"""
import functools
import hashlib
import threading
import time
from collections import OrderedDict, deque
from contextlib import contextmanager, nullcontext

import numpy as np
import torch

from ..device import resolve
from ..generation import (
    _make_sampler, gumbel_noise, prompt_bucket, request_keys,
)
from ..observability import compilemem as _compilemem
from ..observability import devprof as _devprof
from ..observability import goodput as _goodput
from ..observability import tracing as _trace
from ..observability.metrics import registry as _registry
from ..ops import _build
from ..ops.paged_attention import PagedLayerCache
from ..ops.quantization import QuantizedTensor, is_quantized, quantize_to_int8
from ..ops.ragged_paged_attention import RaggedLayerCache
from ..testing import chaos
from ..utils.envs import env_int
from ..utils.metrics_bus import counters
from ..utils.retry import RetryPolicy

#: the most distinct adapters a decode group holds (the stacks' depth
#: less the zero slot), read through utils/envs.py
LORA_SLOTS_ENV = "PADDLE_LORA_SLOTS"

# serving telemetry, the reference's names: TTFT = enqueue -> first token
# per request; TPOT = a decode block's dispatch-to-readback wall over its
# tokens; gauges keep their high-water marks
_M_TTFT = _registry.histogram("serve.ttft_s")
_FAST_BUCKETS = (0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025,
                 0.05, 0.1, 0.25, 0.5, 1.0, 2.5)
_M_TPOT = _registry.histogram("serve.tpot_s", buckets=_FAST_BUCKETS)
_M_QUEUE = _registry.gauge("serve.queue_depth")
_M_OCCUPANCY = _registry.gauge("serve.slot_occupancy")
_M_TOKENS = _registry.counter("serve.tokens_out")
_M_REQUESTS = _registry.counter("serve.requests")
_M_PREFIX_HIT = _registry.counter("serve.prefix.hit_pages")
_M_PREFIX_LOOKUP = _registry.counter("serve.prefix.lookup_pages")
_M_OVERLAP = _registry.histogram("serve.dispatch_overlap_s",
                                 buckets=_FAST_BUCKETS)
_M_CHUNKS = _registry.counter("serve.prefill_chunks")
_M_WARMUP = _registry.histogram("serve.compile_warmup_s")
_M_POOL_FREE = _registry.gauge(
    "serve.pool_frag_free_pages", help="KV pool pages on the free list")
_M_POOL_EVICT = _registry.gauge(
    "serve.pool_frag_evictable_pages",
    help="refcount-0 prefix-cache pages (reclaimable, LRU-evictable)")
_M_POOL_USED = _registry.gauge(
    "serve.pool_frag_used_pages",
    help="pages referenced by in-flight requests")
_M_POOL_FRAG = _registry.gauge(
    "serve.pool_frag_ratio",
    help="cache-held fraction of reclaimable pages "
         "(evictable / (free + evictable))")


class _StampedRLock:
    """RLock that remembers when its current outermost hold began
    (``held_since``) and which threads hold it or wait for it
    (``participants``), so a monitor can tell a dispatcher queued behind a
    long hold from one wedged elsewhere (the reference's lock)."""

    __slots__ = ("name", "_lock", "_depth", "_since", "_holder", "_waiters")

    def __init__(self, name=None):
        self.name = name
        self._lock = threading.RLock()
        self._depth = 0
        self._since = None     # monotonic start of the outermost hold
        self._holder = None    # thread ident of the holder
        self._waiters = set()  # thread idents blocked in acquire()

    def acquire(self, blocking=True, timeout=-1):
        me = threading.get_ident()
        if blocking and self._holder != me:  # a reentrant acquire can't block
            self._waiters.add(me)  # set ops are atomic under the GIL
            try:
                # holder bookkeeping runs inside the waiter window, so the
                # winner is never seen as neither waiter nor holder
                return self._acquired(me, self._lock.acquire(blocking,
                                                             timeout))
            finally:
                self._waiters.discard(me)
        return self._acquired(me, self._lock.acquire(blocking, timeout))

    def _acquired(self, me, ok):
        if ok:
            self._depth += 1
            if self._depth == 1:
                self._since = time.monotonic()
                self._holder = me
        return ok

    def release(self):
        # fields mutate only while the lock is held (one writer); the
        # unlocked reads below are advisory
        self._depth -= 1
        if self._depth == 0:
            self._since = None
            self._holder = None
        self._lock.release()

    __enter__ = acquire

    def __exit__(self, *exc_info):
        self.release()

    def held_since(self):
        """Monotonic time of the current outermost acquire, or None when
        free. Advisory (read without the lock)."""
        return self._since

    def participants(self):
        """Thread idents holding or blocked acquiring the lock. Advisory
        snapshot (read without the lock)."""
        out = set(self._waiters)
        holder = self._holder
        if holder is not None:
            out.add(holder)
        return out


#: Process-wide compile lock (the reference's): held around every first
#: build of a kernel library (``ops/_build.py``'s build lock sits inside
#: it). A frontend drives one engine per dispatcher thread; a build takes
#: seconds, and the frontend's liveness monitor spares a dispatcher that
#: holds or waits for this lock (or its engine's ``dispatch_lock``) under
#: a hold younger than the heartbeat deadline.
_COMPILE_LOCK = _StampedRLock(name="inference.compile_lock")


def _on_engine_stream(fn):
    """Run an engine hook's device work on the engine's own CUDA stream
    (nothing to do on the CPU)."""
    @functools.wraps(fn)
    def wrapper(self, *args, **kwargs):
        if self._stream is None:
            return fn(self, *args, **kwargs)
        with torch.cuda.stream(self._stream):
            return fn(self, *args, **kwargs)
    return wrapper


def _joined(fn):
    """An engine hook after which the caller's stream sees the engine's
    work (the batch-level calls: ``serve``, ``warmup``, ``drain``)."""
    @functools.wraps(fn)
    def wrapper(self, *args, **kwargs):
        try:
            return fn(self, *args, **kwargs)
        finally:
            if self._stream is not None:
                torch.cuda.current_stream(self.device).wait_stream(
                    self._stream)
    return wrapper


#: canonical greedy sampling tuple: every greedy request shares it,
#: whatever knob values were passed
GREEDY_SAMPLING = (False, 1.0, 0, 1.0)


def canonical_sampling(do_sample, temperature=1.0, top_k=0, top_p=1.0):
    return (GREEDY_SAMPLING if not do_sample else
            (True, float(temperature), int(top_k), float(top_p)))


def _per_request(value, n, name):
    """A scalar, a per-rid list or a complete {rid: v} dict -> a per-rid
    list of ints (the reference's ``_per_request``): ValueError for a list
    of another length or a dict missing rids."""
    if isinstance(value, dict):
        missing = [i for i in range(n) if i not in value]
        if missing:
            raise ValueError(
                f"per-request {name} dict missing rids {missing}")
        return [int(value[i]) for i in range(n)]
    if isinstance(value, (list, tuple, np.ndarray)):
        if len(value) != n:
            raise ValueError(f"per-request {name} has {len(value)} "
                             f"entries for {n} requests")
        return [int(v) for v in value]
    return [int(value)] * n


class EngineRequest:
    """One request's lifecycle state. Once ``finished``, exactly one of
    ``result`` (np.int32: prompt + generated tokens) or ``error`` (its
    rendered string: ``error_message``) is set; a ``timed_out`` request
    retires with a partial result. ``adapter`` is a resolved
    ``serving.adapters.LoRAAdapter`` or None."""

    __slots__ = ("rid", "prompt", "max_new_tokens", "eos_token_id",
                 "sampling", "seed", "timeout_s", "on_token", "adapter",
                 "tokens", "n_generated", "n_dispatched", "last_token",
                 "pages", "slot", "key_base", "t_enqueue", "t_admit",
                 "t_first_token", "t_done", "error", "result", "finished",
                 "timed_out", "cancelled", "trace")

    def __init__(self, rid, prompt, max_new_tokens, eos_token_id=None,
                 sampling=GREEDY_SAMPLING, seed=0, timeout_s=None,
                 on_token=None, adapter=None):
        self.rid = int(rid)
        self.prompt = np.asarray(prompt, np.int32).reshape(-1)
        self.max_new_tokens = int(max_new_tokens)
        if self.max_new_tokens < 1:
            raise ValueError(
                f"request {self.rid}: max_new_tokens must be >= 1, got "
                f"{self.max_new_tokens}")
        self.eos_token_id = eos_token_id
        self.sampling = tuple(sampling)
        self.seed = int(seed)
        self.timeout_s = timeout_s
        self.on_token = on_token
        self.adapter = adapter
        self.tokens = []          # prompt + generated
        self.n_generated = 0
        # tokens DISPATCHED to the device (>= n_generated while a block is
        # in flight); retired rows discard the overshoot
        self.n_dispatched = 0
        self.last_token = None
        self.pages = []
        self.slot = None
        self.key_base = None      # noise key of (seed, rid), set at admission
        self.t_enqueue = time.monotonic()
        self.t_admit = None
        self.t_first_token = None
        self.t_done = None
        self.error = None
        self.result = None
        self.finished = False
        self.timed_out = False
        self.cancelled = False    # honoured at the next step
        # request-scoped tracing: the frontend's per-attempt span; the
        # engine's admit/prefill/decode spans nest under it (a clone gets
        # the new attempt's span from the frontend)
        self.trace = None

    @property
    def error_message(self):
        """The failure as ``"Type: message"``, or None."""
        if self.error is None:
            return None
        return f"{type(self.error).__name__}: {self.error}"

    def clone_for_retry(self):
        """A fresh, unadmitted copy for another replica: the same rid and
        seed (so the same sampled stream and output) and the same
        ``t_enqueue`` (TTFT spans the whole journey)."""
        clone = EngineRequest(self.rid, self.prompt, self.max_new_tokens,
                              eos_token_id=self.eos_token_id,
                              sampling=self.sampling, seed=self.seed,
                              timeout_s=self.timeout_s,
                              on_token=self.on_token, adapter=self.adapter)
        clone.t_enqueue = self.t_enqueue
        return clone


class _PrefillState:
    """One slot mid-prefill: its page reservation (shared prefix pages
    first), the prefix-cache hit width, the prompt's page digest chain (to
    index its pages at graduation), how many prompt tokens already sit in
    the pool (ragged) or how many pages hold valid KV (the legacy chunk
    ladder; the slot's page-table row stays at scratch until it
    graduates)."""

    __slots__ = ("req", "pages", "filled_pages", "n_pre0", "digests",
                 "consumed")

    def __init__(self, req, pages, n_pre, digests, page_size):
        self.req = req
        self.pages = pages
        self.filled_pages = n_pre
        self.n_pre0 = n_pre
        self.digests = digests
        self.consumed = n_pre * page_size


class _InflightBlock:
    """A dispatched block not yet read back: its device-resident last-step
    row (the next block's feed), the slot→request rows frozen at dispatch,
    the host copy of the [k, max_seqs] token block with the event that
    marks it complete (None once complete), the dispatch time, and whether
    the dispatch ran a program family for the first time."""

    __slots__ = ("last", "k", "rows", "host", "ready", "t0", "cold")

    def __init__(self, last, k, rows, host, ready, t0, cold=False):
        self.last = last
        self.k = k
        self.rows = rows
        self.host = host
        self.ready = ready
        self.t0 = t0
        self.cold = cold   # a first dispatch: goodput counts it as compile


class ContinuousBatchingEngine:
    """Continuous-batching engine over float (the model's dtype) or int8
    (``kv_cache_dtype="int8"``) KV pools: the ragged plane by default, the
    legacy bucket ladder with ``ragged=False``.

    ``model`` is a ``models.llama.LlamaForCausalLM`` that lives on
    ``device`` (default "cuda"; raises when CUDA is missing unless
    device="cpu"). ``dispatch_lock`` (a ``_StampedRLock``) may be shared by
    engines that share a card."""

    #: bounded retry of a decode dispatch on a transient fault; other
    #: errors (a kernel's, a shape's) raise at once
    retry_policy = RetryPolicy(attempts=3, base_delay=0.05)

    def __init__(self, model, max_seqs=4, page_size=16, num_pages=None,
                 max_len=512, kv_cache_dtype=None, decode_block=8,
                 enable_prefix_cache=False, prefill_chunk=None,
                 async_decode=True, dispatch_lock=None, ragged=None,
                 device="cuda"):
        dev = resolve(device)
        # device-time profiling plane: PADDLE_DEVPROF=1 samples one timed
        # decode dispatch per cadence window; disabled, the dispatch path
        # pays one is-None check
        _devprof.arm_from_env()
        if kv_cache_dtype not in (None, "model", "int8"):
            raise ValueError(f"unsupported kv_cache_dtype {kv_cache_dtype!r}")
        if prefill_chunk and kv_cache_dtype == "int8":
            raise ValueError("prefill_chunk does not compose with "
                             "kv_cache_dtype='int8' (lossy chunk "
                             "re-reads would change outputs vs the "
                             "monolithic path)")
        if enable_prefix_cache and kv_cache_dtype == "int8":
            raise ValueError("enable_prefix_cache does not compose with "
                             "kv_cache_dtype='int8' (lossy prefix KV would "
                             "change outputs vs the uncached path)")
        param = next(model.parameters())
        if param.device.type != dev.type or (
                dev.index is not None and param.device.index != dev.index):
            raise ValueError(f"model lives on {param.device}, the engine on "
                             f"{dev}: move the model first")
        cfg = model.config
        self.model = model.eval()
        self.device = param.device
        self.max_seqs = max_seqs
        self.page_size = page_size
        self.max_len = max_len
        self.pages_per_seq = -(-max_len // page_size)  # page-table width
        self.num_pages = num_pages or (1 + max_seqs * self.pages_per_seq)
        if self.num_pages < 2:
            raise ValueError("need at least one scratch + one real page")
        self.kv_cache_dtype = kv_cache_dtype
        shape = (cfg.num_key_value_heads, self.num_pages, page_size,
                 cfg.head_dim)

        def pool():
            if kv_cache_dtype == "int8":
                # the reference's QuantizedTensor layout: int8 codes and
                # one f32 scale per (head, page, row)
                return QuantizedTensor(
                    weight=torch.zeros(shape, dtype=torch.int8,
                                       device=self.device),
                    scales=torch.ones(shape[:3] + (1,), dtype=torch.float32,
                                      device=self.device))
            return torch.zeros(shape, dtype=param.dtype, device=self.device)

        self.pools = [(pool(), pool()) for _ in range(cfg.num_hidden_layers)]
        # the engine's own stream: its device work never queues behind
        # another engine's (a replica driven by another thread). The
        # weights and the zeroed pools were written on the creating
        # stream, so the engine's stream starts after them.
        self._stream = None
        if self.device.type == "cuda":
            self._stream = torch.cuda.Stream(self.device)
            self._stream.wait_stream(torch.cuda.current_stream(self.device))
        # the analytic cost of a serve dispatch (devprof's roofline join):
        # the matmul parameters (all but the embedding table) and their
        # bytes, read once per forward pass, and the pool bytes of one
        # token's K and V across the layers
        emb = model.llama.embed_tokens.weight if getattr(
            model, "llama", None) is not None else None
        params = [p for p in model.parameters() if p is not emb]
        self._param_count = sum(p.numel() for p in params)
        self._param_bytes = sum(p.numel() * p.element_size() for p in params)
        kv_elem = (1 + 4 / cfg.head_dim if kv_cache_dtype == "int8"
                   else param.element_size())
        self._kv_token_bytes = (2 * cfg.num_hidden_layers
                                * cfg.num_key_value_heads * cfg.head_dim
                                * kv_elem)
        self._attn_dims = (cfg.num_hidden_layers * cfg.num_attention_heads
                           * cfg.head_dim)
        self.free_pages = list(range(1, self.num_pages))  # page 0 = scratch
        self.free_slots = list(range(max_seqs))
        self.page_table = np.zeros((max_seqs, self.pages_per_seq), np.int32)
        self.lengths = np.zeros(max_seqs, np.int32)
        if prefill_chunk:
            prefill_chunk = max(int(prefill_chunk) // page_size, 1) * page_size
        self.prefill_chunk = int(prefill_chunk or 0)
        self.async_decode = bool(async_decode)
        self.decode_block = max(int(decode_block), 1)
        self.dispatch_lock = dispatch_lock or _StampedRLock()
        self._warm = set()        # program keys that have run successfully
        self._ragged = (ragged is None or bool(ragged)) and getattr(
            model, "llama", None) is not None
        # token budget for prompt chunks per mixed dispatch, and the packed
        # stream width: chunk budget + one feed token per slot
        self._ragged_chunk = max(self.prefill_chunk or min(256, max_len), 1)
        self._ragged_tokens = self._ragged_chunk + max_seqs
        self.stats = {"peak_pages": 0, "deferred_admissions": 0,
                      "decode_steps": 0, "prefix_hit_pages": 0,
                      "prefix_evictions": 0, "failed_requests": 0,
                      "timed_out_requests": 0}
        self.request_errors = {}
        self._request_errors_bound = 1024
        self._active = {}         # slot -> EngineRequest (decoding)
        self._prefilling = {}     # slot -> _PrefillState
        self._inflight = None     # the ONE in-flight _InflightBlock
        # requests retired while an out-of-band readback (export_pages'
        # _settle_inflight) processed the in-flight block: the next step()
        # returns them
        self._pending_retired = []
        # the running group's sampling tuple (None when idle): requests
        # with another one are deferred until the group drains
        self._active_sampling = None
        self._samplers = {}       # sampling tuple -> sampler
        # ---- per-request LoRA: the group's adapter rank (None: a base
        # group, which runs the base path untouched), each adapter slot's
        # adapter, the device copies (LRU by digest) and the fixed-depth
        # stacks (slot 0 zeros; LRU by (rank, digests))
        self._active_lora_rank = None
        self._slot_adapter = {}
        self._lora_slots = env_int(LORA_SLOTS_ENV, 4)
        self._lora_device = OrderedDict()
        self._lora_stack_cache = OrderedDict()
        self._lora_dims = (cfg.hidden_size, cfg.vocab_size)
        self.lora_dispatches = 0  # dispatches that applied an adapter head
        # ---- prefix cache: full prompt pages indexed by the chained
        # digest of the prompt up to and including the page; refcounted
        # while in use, kept (LRU-evictable) at refcount 0. Shared pages
        # are never written: the match is capped at (true_len - 1) // bs
        # pages, so every write lands in a private page.
        self.enable_prefix_cache = bool(enable_prefix_cache)
        self._prefix_index = {}   # chained page digest -> page id
        self._page_hash = {}      # page id -> digest (indexed pages)
        self._page_refs = {}      # page id -> refcount (in-use pages)
        self._evictable = OrderedDict()  # page id -> None, LRU first
        self._pages_in_use = 0
        self._cache_weights_version = None
        self.warmup_build_s = 0.0  # the kernel builds warmup() paid
        # whether the last _locked_dispatch section ran a program family
        # for the first time (goodput counts its wall as compile)
        self._last_dispatch_cold = False
        # device-memory budget and OOM forensics: the KV pools are a
        # component of the budget, and an OOM report says what the engine
        # was serving. Both registrations are weak: a dropped engine
        # vanishes from the reports.
        _compilemem.memory.register_component_provider(
            "kv_pool", self, "pool_bytes")
        _compilemem.register_oom_context(
            "serving_engine", self, "_oom_context")

    def _oom_context(self):
        """Serving-state snapshot for the OOM report."""
        return {
            "active_slots": len(self._active),
            "prefilling_slots": len(self._prefilling),
            "max_seqs": self.max_seqs,
            "pages_in_use": self._pages_in_use,
            "free_pages": len(self.free_pages),
            "evictable_pages": len(self._evictable),
            "num_pages": self.num_pages,
            "page_size": self.page_size,
            "pool_bytes": self.pool_bytes(),
            "inflight_block": self._inflight is not None,
            "stats": dict(self.stats),
        }

    # ---- page allocator and prefix cache ----------------------------------
    def pool_bytes(self):
        """Device bytes of the KV pools (codes and scales for int8)."""
        return sum(t.numel() * t.element_size()
                   for pair in self.pools for pool in pair
                   for t in (tuple(pool) if is_quantized(pool) else (pool,)))

    def clear_prefix_cache(self):
        """Drop all cached (refcount-0) prefix pages and their index.
        In-use pages are untouched: they free normally on retire (their
        index entries are gone, so they cannot be matched again)."""
        self.free_pages.extend(self._evictable)
        self._evictable.clear()
        self._prefix_index.clear()
        self._page_hash.clear()

    def _available_pages(self):
        return len(self.free_pages) + len(self._evictable)

    def _alloc_pages(self, n):
        """Take n pages: free list first, then LRU-evict cached ones."""
        out = []
        for _ in range(n):
            if self.free_pages:
                out.append(self.free_pages.pop())
                continue
            pid, _ = self._evictable.popitem(last=False)  # LRU
            self._prefix_index.pop(self._page_hash.pop(pid), None)
            self.stats["prefix_evictions"] += 1
            out.append(pid)
        return out

    def _ref_pages(self, pages):
        for p in pages:
            n = self._page_refs.get(p, 0)
            if n == 0:
                self._pages_in_use += 1
            self._page_refs[p] = n + 1
            self._evictable.pop(p, None)

    def _unref_pages(self, pages):
        for p in pages:
            self._page_refs[p] -= 1
            if self._page_refs[p] == 0:
                del self._page_refs[p]
                self._pages_in_use -= 1
                if p in self._page_hash:  # cached: keep KV, evict lazily
                    self._evictable[p] = None
                else:
                    self.free_pages.append(p)

    def pages_in_use(self):
        """Referenced (in-flight) pages, kept O(1) at every ref/unref; equal
        to ``num_pages - 1 - len(free_pages) - len(_evictable)``."""
        return self._pages_in_use

    def _page_digests(self, prompt, n_pages):
        """Chained 16-byte blake2b digests of the first ``n_pages`` full
        pages: digest[j] = H(prompt page j, key=digest[j-1]) identifies
        prompt[:(j+1)*bs] at O(bs) per page."""
        bs = self.page_size
        out, h = [], b""
        for j in range(n_pages):
            h = hashlib.blake2b(prompt[j * bs:(j + 1) * bs].tobytes(),
                                key=h, digest_size=16).digest()
            out.append(h)
        return out

    def _match_prefix(self, prompt, true_len):
        """Longest run of indexed full pages, capped so >= 1 prompt token
        remains to prefill (its logits give the first token). Returns (n,
        shared pages, the full digest chain, reused for indexing)."""
        bs = self.page_size
        digests = self._page_digests(prompt, true_len // bs)
        shared = []
        for j in range((true_len - 1) // bs):
            pid = self._prefix_index.get(digests[j])
            if pid is None:
                break
            shared.append(pid)
        return len(shared), shared, digests

    def prefix_match_pages(self, prompt):
        """How many full prompt pages the prefix cache could serve now
        (read-only: no refcount taken)."""
        if not self.enable_prefix_cache:
            return 0
        p = np.asarray(prompt, np.int32).reshape(-1)
        return self._match_prefix(p, len(p))[0]

    def _index_prompt_pages(self, true_len, pages, start, digests):
        """Register the request's full prompt pages from page ``start`` on
        (earlier ones were matched, hence indexed); first writer wins."""
        bs = self.page_size
        for j in range(start, len(pages)):
            if (j + 1) * bs > true_len:
                break
            if digests[j] not in self._prefix_index:
                self._prefix_index[digests[j]] = pages[j]
                self._page_hash[pages[j]] = digests[j]

    def _refresh_cache_guard(self):
        """Cached prefix KV is valid only under the weights that computed
        it: a parameter changed in place (its ``_version`` counter) or
        rebound (its ``data_ptr``) since the last check clears the
        cache."""
        version = tuple((p._version, p.data_ptr())
                        for p in self.model.parameters())
        if version != self._cache_weights_version:
            if self._cache_weights_version is not None:
                self.clear_prefix_cache()
            self._cache_weights_version = version

    # ---- host <-> device ----------------------------------------------------
    def _to_device(self, a):
        """Copy a host array to the engine's device without waiting for
        the device: through pinned memory and a non-blocking copy, so an
        in-flight block keeps the device busy meanwhile."""
        t = torch.from_numpy(np.array(a))
        if self.device.type == "cpu":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    @contextmanager
    def _locked_dispatch(self, *keys):
        """A device section under the engine's ``dispatch_lock``. ``keys``
        name the reference's program families the section runs (e.g.
        ("prefill", bucket, sampling)); they join ``_warm`` once the
        section succeeds. A section that runs a family for the first time
        is a compile in the compile ledger (one event per cold family,
        under its reference program key) and sets
        ``_last_dispatch_cold``. An exception out of the section passes
        OOM forensics (the ``obs.oom`` chaos site injects one) before it
        re-raises."""
        cold = [k for k in keys if k not in self._warm]
        self._last_dispatch_cold = bool(cold)
        t0 = time.perf_counter()
        try:
            with self.dispatch_lock:
                chaos.site("obs.oom")
                yield
        except Exception as e:
            for k in cold:
                _compilemem.ledger.record(self._ledger_key(k),
                                          time.perf_counter() - t0, error=e)
            _compilemem.maybe_oom_report(
                e, program=self._ledger_key(keys[0]) if keys else None)
            raise
        wall = time.perf_counter() - t0
        for k in cold:
            _compilemem.ledger.record(self._ledger_key(k), wall)
        self._warm.update(cold)
        for family in {k[0] for k in cold}:
            _compilemem.ledger.note_cache_size(
                f"serve.{family}", sum(1 for k in self._warm
                                       if k[0] == family))

    def _ledger_key(self, key):
        """The reference's compile-ledger key of program family ``key``."""
        kind, *a = key
        fmt = {
            "prefill": lambda b, s: f"serve.prefill[b{b},s{s}]",
            "suffix": lambda n, b, s: f"serve.suffix[p{n},b{b},s{s}]",
            "gather": lambda n: f"serve.gather[p{n}]",
            "insert": lambda b: f"serve.insert[b{b}]",
            "decode": lambda s: f"serve.decode[s{s}]",
            "block": lambda s, k: f"serve.decode_block[k{k},s{s}]",
            "ragged": lambda s: f"serve.ragged[k{self.decode_block},s{s}]",
            "keys": lambda k: "serve.keys_from_base",
            "lora_prefill": lambda b, s, r:
                f"serve.lora_prefill[r{r},b{b},s{s}]",
            "lora_suffix": lambda n, b, s, r:
                f"serve.lora_suffix[r{r},p{n},b{b},s{s}]",
            "lora_decode": lambda s, r: f"serve.lora_decode[r{r},s{s}]",
            "lora_block": lambda s, r, k:
                f"serve.lora_decode_block[r{r},k{k},s{s}]",
            "lora_ragged": lambda s, r:
                f"serve.lora_ragged[r{r},k{self.decode_block},s{s}]",
        }[kind]
        return fmt(*a)

    @staticmethod
    def _rtrace_annotation(req):
        """``record_function("rtrace:<trace id>")`` while a torch profiler
        records and the request is traced: the device trace's join key to
        the request's trace (the reference's profiler annotation)."""
        if req.trace is None or not _trace._profiler_recording():
            return nullcontext()
        return torch.profiler.record_function(
            f"rtrace:{req.trace.ctx.trace_id}")

    # ---- device-time sampling -----------------------------------------------
    def _devprof_start(self):
        """The start event of a dispatch devprof may sample (recorded on
        the engine's stream), or None (disarmed, or the CPU)."""
        if _devprof._PLANE is None or self._stream is None:
            return None
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def _devprof_tick(self, key, t0, start, passes, tokens, cold):
        """Tick the devprof plane for one warm dispatch of program ``key``
        (the reference's ledger key; ``tokens`` as the reference counts
        them) after noting its analytic cost: ``passes`` lists each
        forward pass's rows as (query tokens, keys before the first)."""
        dp = _devprof._PLANE
        if dp is None or cold:
            return
        flops = nbytes = 0
        for rows in passes:
            n = sum(q for q, _ in rows)
            # query i of a row at position p0 + i sees p0 + i + 1 keys
            pairs = sum(q * p0 + q * (q + 1) // 2 for q, p0 in rows)
            kv = sum(p0 + q for q, p0 in rows)
            flops += 2 * self._param_count * n + 4 * self._attn_dims * pairs
            nbytes += self._param_bytes + self._kv_token_bytes * kv
        _compilemem.memory.note_cost(key, flops=flops, nbytes=nbytes)
        events = None
        if start is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            events = (start, end)
        dp.tick(key, t0, events, tokens=tokens, context="serve.decode")

    # ---- device programs ----------------------------------------------------
    def _draw(self, logits, sampling, keys, idx):
        """Each row's next token from its [rows, V] logits under the
        group's ``sampling``; a sampled row draws the Gumbel noise of its
        request key (``keys``) at token index ``idx`` (int64 [rows])."""
        sampler = self._samplers.get(sampling)
        if sampler is None:
            sampler = self._samplers[sampling] = _make_sampler(
                *sampling, repetition_penalty=1.0, min_length=0,
                eos_token_id=None)
        noise = (gumbel_noise(keys, idx, logits.shape[-1]) if sampling[0]
                 else None)
        return sampler(logits, noise)

    def _head(self, h, lora):
        """Logits of hidden rows ``h`` [B, S, H]: the model's own head
        (the base path's op) plus, under ``lora`` = (A [B, H, r], B [B, r,
        V], scale [B, 1, 1]) f32, each row's ``scale * (h @ A) @ B`` in
        f32 (the reference's ``_lora_base_head`` + delta; a zero-slot row
        adds +0.0)."""
        base = self.model.head(h)
        if lora is None:
            return base
        a, b, scale = lora
        delta = torch.matmul(torch.matmul(h.float(), a), b)
        return base + delta * scale

    def _decode_steps(self, toks, page_table, lengths, caps, n, sampling,
                      keys, idx, lora=None):
        """``n`` decode steps over every slot through the paged caches (the
        reference's ``lax.scan`` body), step s drawing token index
        ``idx + s``. A row's write position freezes at its cap (caps 0 park
        empty rows on the scratch page). Returns the [n] list of
        [max_seqs] int32 token rows."""
        out = []
        for s in range(n):
            lengths_e = torch.minimum(lengths, caps)
            caches = [PagedLayerCache(kp, vp, page_table, lengths_e)
                      for kp, vp in self.pools]
            if lora is None:
                logits, _ = self.model(toks, position_ids=lengths_e[:, None],
                                       past_key_values=caches)
            else:
                h, _ = self.model.llama(toks, position_ids=lengths_e[:, None],
                                        past_key_values=caches)
                logits = self._head(h, lora)
            nxt = self._draw(logits[:, -1], sampling, keys,
                             None if idx is None else idx + s)
            out.append(nxt)
            toks = nxt[:, None]
            lengths = lengths_e + 1
        return out

    @torch.no_grad()
    def _ragged_step(self, tok_block, chain_pos, chain_rows, last, cu, row_of,
                     token_pos, valid, b_idx, page_table, scan_table,
                     lengths, caps, sampling, keys, idx, lora=None):
        """The mixed program (reference ``_ragged_fn``, ``_lora_ragged_fn``
        under ``lora``): one packed pass through the ragged caches, each
        participant's first token from its last packed token (``b_idx``)
        at token index ``idx``, then ``k - 1`` decode steps over
        ``scan_table`` (non-participants routed to the scratch page). Rows
        chained off an in-flight block take their feed token from its
        device-resident ``last`` row at packed positions ``chain_pos``. The
        pools are updated in place (the reference donates them)."""
        if chain_pos is not None:
            tok_block[chain_pos] = last[chain_rows, 0]
        kv_lens = lengths + (cu[1:] - cu[:-1])  # post-write totals
        caches = [RaggedLayerCache(kp, vp, page_table, kv_lens, cu, row_of,
                                   token_pos, valid)
                  for kp, vp in self.pools]
        h, _ = self.model.llama(tok_block[None],
                                position_ids=token_pos[None],
                                past_key_values=caches)
        tok0 = self._draw(self._head(h[0, b_idx][:, None], lora)[:, 0],
                          sampling, keys, idx)
        tail = self._decode_steps(tok0[:, None], scan_table, kv_lens, caps,
                                  self.decode_block - 1, sampling, keys,
                                  None if idx is None else idx + 1, lora)
        return torch.stack([tok0, *tail])

    @torch.no_grad()
    def _decode_block(self, feed, page_table, lengths, caps, k, sampling,
                      keys, idx, lora=None):
        """The decode program (reference ``_decode_block_fn``, ``_decode``
        at k 1, their LoRA forms under ``lora``): ``k`` decode steps; pools
        updated in place (the reference donates them)."""
        return torch.stack(self._decode_steps(feed, page_table, lengths,
                                              caps, k, sampling, keys, idx,
                                              lora))

    @torch.no_grad()
    def _prefill(self, ids, true_len, sampling, key, prefix=None, lora=None):
        """The legacy bucketed prefill (reference ``_prefill``; with
        ``prefix`` = the gathered (ks, vs) of the request's first pages,
        ``_prefill_suffix``; under ``lora`` their adapter forms): ``ids``
        [1, bucket], right-padded with zeros, through fixed-shape dense
        caches of plen + bucket positions written from cache position
        plen, in the masked plain attention (the reference's math tier:
        no kernel). The first token is drawn from position true_len - 1 at
        token index 0 of ``key``. Returns (tok0 [1], ks, vs): the bucket
        positions' K/V [L, bucket, Hkv, D]."""
        model = self.model
        plen = 0 if prefix is None else prefix[0].shape[1]
        caches = model.init_cache(1, plen + ids.shape[1])
        if prefix is not None:
            for l, (kc, vc) in enumerate(caches):
                kc[0, :plen] = prefix[0][l]
                vc[0, :plen] = prefix[1][l]
        if lora is None:
            logits, _ = model(ids, past_key_values=caches,
                              cache_position=plen)
            last = logits[:, true_len - 1]
        else:
            h, _ = model.llama(ids, past_key_values=caches,
                               cache_position=plen)
            last = self._head(h[:, true_len - 1:true_len], lora)[:, 0]
        zero = None if key is None else torch.zeros_like(key)
        tok0 = self._draw(last, sampling, key, zero)
        ks = torch.stack([kc[0, plen:] for kc, _ in caches])
        vs = torch.stack([vc[0, plen:] for _, vc in caches])
        return tok0, ks, vs

    @staticmethod
    def _pages_for_bucket(bucket, bs):
        return -(-bucket // bs)  # a bucket smaller than a page needs one

    @torch.no_grad()
    def _insert(self, ks, vs, page_ids):
        """Scatter dense prefill K/V [L, n, Hkv, D] into the pool pages
        ``page_ids`` (reference ``_insert``), the positions padded up to
        whole pages (a bucket shorter than a page still writes one; the
        pad rows are masked by ``lengths``). Positions past the pages
        given are bucket padding and are dropped: an adapter request under
        ``prefill_chunk`` prefills a whole bucket into the chunk ladder's
        region, which holds its tokens but not always its bucket's pad
        (the reference clamps the page index there and writes that pad
        over the last page; ROADMAP.md §3). An int8 pool quantizes each
        page's rows from f32, as the reference's ``write_page`` does."""
        bs = self.page_size
        npg = len(page_ids)
        ks, vs = ks[:, :npg * bs], vs[:, :npg * bs]
        pad = npg * bs - ks.shape[1]
        if pad:
            ks = torch.nn.functional.pad(ks, (0, 0, 0, 0, 0, pad))
            vs = torch.nn.functional.pad(vs, (0, 0, 0, 0, 0, pad))
        ids = self._to_device(np.asarray(page_ids, np.int64))
        for l, (kp, vp) in enumerate(self.pools):
            for pool, x in ((kp, ks[l]), (vp, vs[l])):
                # [npg * bs, Hkv, D] -> [Hkv, npg, bs, D]
                chunk = x.reshape(npg, bs, *x.shape[1:]).permute(2, 0, 1, 3)
                if is_quantized(pool):
                    qt = quantize_to_int8(chunk.float())
                    pool.weight[:, ids] = qt.weight
                    pool.scales[:, ids] = qt.scales
                else:
                    pool[:, ids] = chunk.to(pool.dtype)

    @torch.no_grad()
    def _gather_prefix(self, page_ids):
        """Pools + page ids [n] -> dense K/V [L, n * bs, Hkv, D] each
        (reference ``_gather_prefix``). Float pools only: TypeError for an
        int8 pool, whose gather the reference refuses the same way."""
        if is_quantized(self.pools[0][0]):
            raise TypeError("the page gather reads float pools only: an "
                            "int8 pool's pages cannot be exported")
        ids = self._to_device(np.asarray(page_ids, np.int64))

        def read(pool):
            arr = pool[:, ids].permute(1, 2, 0, 3)   # [n, bs, Hkv, D]
            return arr.reshape(-1, *arr.shape[2:])

        return (torch.stack([read(kp) for kp, _ in self.pools]),
                torch.stack([read(vp) for _, vp in self.pools]))

    # ---- per-request LoRA ---------------------------------------------------
    def _lora_dev(self, adapter):
        """An adapter's A and B on the device, digest-keyed LRU of 32 (a
        re-registration under a new digest is a new entry)."""
        ent = self._lora_device.get(adapter.digest)
        if ent is None:
            ent = (torch.from_numpy(adapter.a).to(self.device),
                   torch.from_numpy(adapter.b).to(self.device))
            self._lora_device[adapter.digest] = ent
            while len(self._lora_device) > 32:
                self._lora_device.popitem(last=False)
        else:
            self._lora_device.move_to_end(adapter.digest)
        return ent

    def _lora_stack(self, rank, adapters):
        """(A stack, B stack, scales, digest -> index) for a digest-sorted
        working set, ``_lora_slots + 1`` deep: slot 0 zeros for rows
        without an adapter, the tail zero-padded. LRU of 8 by (rank,
        digests)."""
        digs = tuple(ad.digest for ad in adapters)
        cached = self._lora_stack_cache.get((rank, digs))
        if cached is None:
            hidden, vocab = self._lora_dims
            za = torch.zeros((hidden, rank), dtype=torch.float32,
                             device=self.device)
            zb = torch.zeros((rank, vocab), dtype=torch.float32,
                             device=self.device)
            a_list, b_list, s_list = [za], [zb], [0.0]
            for ad in adapters:
                a_dev, b_dev = self._lora_dev(ad)
                a_list.append(a_dev)
                b_list.append(b_dev)
                s_list.append(float(ad.scale))
            while len(a_list) < self._lora_slots + 1:
                a_list.append(za)
                b_list.append(zb)
                s_list.append(0.0)
            cached = (torch.stack(a_list), torch.stack(b_list),
                      torch.tensor(s_list, dtype=torch.float32,
                                   device=self.device))
            self._lora_stack_cache[(rank, digs)] = cached
            while len(self._lora_stack_cache) > 8:
                self._lora_stack_cache.popitem(last=False)
        else:
            self._lora_stack_cache.move_to_end((rank, digs))
        return cached + ({d: i + 1 for i, d in enumerate(digs)},)

    def _lora_rows(self, rows):
        """The dispatch's adapter operands (``_head``'s ``lora``): each
        slot's A, B and scale gathered from the group's stacks (rows
        without an adapter, and empty slots, take the zero slot); None
        for a base group."""
        if self._active_lora_rank is None:
            return None
        ads = sorted({a.digest: a for a in self._slot_adapter.values()}
                     .values(), key=lambda a: a.digest)
        a_stack, b_stack, scales, pos = self._lora_stack(
            self._active_lora_rank, ads)
        idx = np.zeros(self.max_seqs, np.int64)
        for slot, r in rows:
            if r.adapter is not None:
                idx[slot] = pos[r.adapter.digest]
        idx = self._to_device(idx)
        self.lora_dispatches += 1
        return a_stack[idx], b_stack[idx], scales[idx][:, None, None]

    def _lora_one(self, adapter):
        """One request's adapter operands for its legacy prefill."""
        a, b = self._lora_dev(adapter)
        self.lora_dispatches += 1
        return a[None], b[None], torch.tensor(
            adapter.scale, dtype=torch.float32, device=self.device).view(
                1, 1, 1)

    def _lora_reject(self, ad):
        """Why this adapter can never run on this engine (None: it can):
        admission fails the request alone instead of deferring forever."""
        hidden, vocab = self._lora_dims
        if ad.a.shape[0] != hidden or ad.b.shape[1] != vocab:
            return ValueError(
                f"adapter {ad.name!r} shapes {ad.a.shape}/{ad.b.shape} "
                f"do not match model hidden={hidden} vocab={vocab}")
        return None

    # ---- warmup -------------------------------------------------------------
    @_joined
    @_on_engine_stream
    def warmup(self, prompt_lens=None, do_sample=False, temperature=1.0,
               top_k=0, top_p=1.0, shared_prefix_lens=(), buckets=None,
               sampling=None, lora_ranks=()):
        """Run every program family serve() can reach for prompts of these
        lengths before latency-sensitive serving (the reference's
        contract): on the card, first build each kernel library the
        engine can launch (``ops/_build.py``'s first use, seconds in
        ``warmup_build_s``); then one dummy request per prompt bucket
        (under ``prefill_chunk`` the dummy serves walk the chunk ladder)
        and one serve of 2 * decode_block - 1 tokens that walks every
        block size (the ragged plane: one serve of decode_block + 1
        tokens). ``buckets`` is an alias for ``prompt_lens``; ``sampling``
        a list of (do_sample, temperature, top_k, top_p) tuples (or one);
        ``lora_ranks`` adds the adapter forms, served with a zero-weight
        adapter of each rank; ``shared_prefix_lens`` runs the prefix
        gather and suffix prefill a cache hit of each length would.
        ``stats`` stay as they were, the prefix cache is bypassed and
        later streams are unchanged. The wall time, builds included, goes
        into ``serve.compile_warmup_s``."""
        if buckets is not None:
            prompt_lens = buckets
        if prompt_lens is None:
            raise ValueError("warmup() needs prompt_lens= or buckets=")
        if sampling is None:
            configs = [(do_sample, temperature, top_k, top_p)]
        elif sampling and not isinstance(sampling[0], (tuple, list)):
            configs = [tuple(sampling)]
        else:
            configs = [tuple(s) for s in sampling]
        t_warm0 = time.monotonic()
        try:
            # ledger trigger scope: the builds and first dispatches inside
            # warmup are deliberate, not cold-path stalls
            with _compilemem.ledger.trigger("warmup"):
                if self.device.type == "cuda":
                    # the libraries the dispatches can launch: K5's, and
                    # K4's on the ragged plane
                    t0 = time.monotonic()
                    _build.library("paged_attention")
                    if self._ragged:
                        _build.library("ragged_paged_attention")
                    self.warmup_build_s += time.monotonic() - t0
                for cfg in configs:
                    self._warmup_one(prompt_lens, shared_prefix_lens, *cfg)
                for rank in lora_ranks:
                    for cfg in configs:
                        self._warmup_lora(prompt_lens, int(rank), *cfg)
        finally:
            _M_WARMUP.observe(time.monotonic() - t_warm0)

    def _warmup_one(self, prompt_lens, shared_prefix_lens, do_sample,
                    temperature, top_k, top_p):
        kw = dict(do_sample=do_sample, temperature=temperature,
                  top_k=top_k, top_p=top_p)
        stats_before = dict(self.stats)
        # the dummy all-ones prompts would hit each other in the prefix
        # cache (running the suffix programs instead of the full prefills
        # real misses need) and leave junk pages indexed: bypass it
        pfx, self.enable_prefix_cache = self.enable_prefix_cache, False
        try:
            self._warmup_walk(prompt_lens, kw, chunk_ladder=True)
        finally:
            self.enable_prefix_cache = pfx
            self.stats = stats_before
        if pfx and shared_prefix_lens:
            self._warmup_prefix_hits(prompt_lens, shared_prefix_lens,
                                     canonical_sampling(**kw))

    def _warmup_prefix_hits(self, prompt_lens, shared_prefix_lens, sampling):
        """For each expected shared prefix, the page gather, suffix prefill
        and insert a hit will run (the chunk ladder shifted by the hit
        width under ``prefill_chunk``), on scratch page 0: no cache state
        or live page changes."""
        bs = self.page_size
        dummy_key = (torch.zeros(1, dtype=torch.int64, device=self.device)
                     if sampling[0] else None)
        for sp in shared_prefix_lens:
            for l in prompt_lens:
                if l <= sp:
                    continue
                n_pre = min(int(sp) // bs, (int(l) - 1) // bs)
                while n_pre:
                    if n_pre + self._legacy_region(int(l) - n_pre * bs) \
                            <= self.pages_per_seq:
                        break
                    n_pre -= 1
                if not n_pre:
                    continue
                suffix_len = int(l) - n_pre * bs
                if self.prefill_chunk and suffix_len > self.prefill_chunk:
                    n_full, flen, _ = self._chunk_plan(suffix_len)
                    cpg = self.prefill_chunk // bs
                    stages = [(n_pre + j * cpg, self.prefill_chunk)
                              for j in range(n_full)]
                    stages.append((n_pre + n_full * cpg, prompt_bucket(flen)))
                else:
                    stages = [(n_pre, prompt_bucket(suffix_len))]
                for filled, cbucket in stages:
                    with self._locked_dispatch(
                            ("gather", filled),
                            ("suffix", filled, cbucket, sampling),
                            ("insert", cbucket)):
                        prefix = self._gather_prefix([0] * filled)
                        ids = torch.zeros((1, cbucket), dtype=torch.int32,
                                          device=self.device)
                        _, cks, cvs = self._prefill(ids, 1, sampling,
                                                    dummy_key, prefix)
                        self._insert(cks, cvs, [0] * self._pages_for_bucket(
                            cbucket, bs))

    def _warmup_walk(self, prompt_lens, kw, chunk_ladder):
        """The dummy serves: the decode-block ladder on a 1-token prompt
        (the ragged plane: one serve of decode_block + 1 tokens), then one
        prompt per prefill signature (bucket, or chunk ladder)."""
        if self._ragged:
            fit = min(self.max_len - 1,
                      self._available_pages() * self.page_size - 1)
            n = max(min(self.decode_block + 1, fit), 1)
            self.serve([np.ones(1, np.int32)], max_new_tokens=n, **kw)
            return
        # max_new 2 * k - 1 leaves 2k - 2 after the prefill's token, so
        # the shrinking power-of-two k visits decode_block, ..., 2; max_new
        # 2 leaves 1: the single-step program
        ladder_bucket = prompt_bucket(1)
        fit = min(self.max_len - 1,
                  self._available_pages() * self.page_size - ladder_bucket)
        runs = [2]
        if self.decode_block > 1:
            runs.append(2 * self.decode_block - 1)
        runs = sorted({min(n, fit) for n in runs if fit >= 2})
        for n in runs:
            self.serve([np.ones(1, np.int32)], max_new_tokens=n, **kw)
        # one representative length per prefill signature: a bucket, or
        # under the chunk ladder (full-chunk count, final-chunk bucket)
        rep = {}
        for l in prompt_lens:
            l = int(l)
            if chunk_ladder and self.prefill_chunk and l > self.prefill_chunk:
                n_full, flen, _ = self._chunk_plan(l)
                key = ("chunk", n_full, prompt_bucket(flen))
            else:
                key = ("mono", prompt_bucket(l))
            rep[key] = min(rep.get(key, l), l)
        for key in sorted(rep, key=str):
            if key == ("mono", ladder_bucket) and runs:
                continue  # the ladder serves above ran it
            self.serve([np.ones(rep[key], np.int32)], max_new_tokens=1, **kw)

    def _warmup_lora(self, prompt_lens, rank, do_sample, temperature,
                     top_k, top_p):
        """The adapter forms of the program families for ``rank``, served
        with a zero-weight adapter (its delta is 0). Adapter requests
        prefill monolithically, so the legacy walk takes buckets only."""
        from ..serving.adapters import LoRAAdapter

        hidden, vocab = self._lora_dims
        ad = LoRAAdapter(f"warmup-r{rank}",
                         np.zeros((hidden, rank), np.float32),
                         np.zeros((rank, vocab), np.float32))
        kw = dict(do_sample=do_sample, temperature=temperature,
                  top_k=top_k, top_p=top_p, adapters=ad)
        stats_before = dict(self.stats)
        pfx, self.enable_prefix_cache = self.enable_prefix_cache, False
        try:
            self._warmup_walk(prompt_lens, kw, chunk_ladder=False)
        finally:
            self.enable_prefix_cache = pfx
            self.stats = stats_before

    # ---- online lifecycle -------------------------------------------------
    # The serving control plane drives the engine from one dispatcher
    # thread per replica: try_admit_one(req), step(), drain(); serve() is
    # built on the same hooks. The engine is single-threaded by contract;
    # the only cross-thread write it tolerates is EngineRequest.cancelled.

    def idle(self):
        return (not self._active and not self._prefilling
                and self._inflight is None and not self._pending_retired)

    def active_count(self):
        # mid-prefill requests hold slots too
        return len(self._active) + len(self._prefilling)

    def has_free_slot(self):
        return bool(self.free_slots)

    def active_prefills(self):
        """Mid-prefill slot count."""
        return len(self._prefilling)

    # ---- handoff hooks (disaggregated prefill/decode) ----------------------
    # A prefill replica produces a request's first tokens, the frontend
    # exports its pages, detaches it without finishing its handle, and a
    # decode replica adopts the pages and continues it bit for bit. All
    # three run on the owning dispatcher's thread.

    def _settle_inflight(self):
        """Read back the in-flight block now, so every active request's
        emitted tokens equal its dispatched ones (what an export needs);
        requests it retires are returned by the next step()."""
        rec = self._inflight
        if rec is not None:
            self._inflight = None
            self._pending_retired.extend(self._process_block(rec))

    @_on_engine_stream
    def export_pages(self, slot):
        """``slot``'s KV pages on the host for a handoff bundle:
        ``{"n_pages", "ks", "vs"}`` with dense ``[L, n * bs, Hkv, D]``
        numpy arrays (bf16 pools export as float32, exactly). Float pools
        only (TypeError for int8, as the reference's). None when the
        request finished while the in-flight block settled. The arrays are
        on the host: an adopting engine copies them onto its own stream,
        so no device tensor crosses between two engines' streams."""
        self._settle_inflight()
        req = self._active.get(slot)
        if req is None or req.finished:
            return None
        ks, vs = self._gather_prefix(req.pages)

        def host(x):
            return (x.float() if x.dtype == torch.bfloat16 else x).cpu()\
                .numpy()

        return {"n_pages": len(req.pages), "ks": host(ks), "vs": host(vs)}

    def detach_request(self, slot):
        """Free ``slot`` and its pages without finishing the request (its
        tokens, dispatch count and key stream stay for the adopter). Call
        right after export_pages(), with no step() between."""
        req = self._active.pop(slot)
        self._unref_pages(req.pages)
        self.free_slots.append(slot)
        self.page_table[slot] = 0
        self.lengths[slot] = 0
        req.pages = []
        req.slot = None
        self._slot_adapter.pop(slot, None)
        self._group_done()
        return req

    @_on_engine_stream
    def adopt_request(self, req, payloads):
        """Admission twin for a handed-off request: scatter its exported
        pages into this pool and register it mid-decode. Returns
        "admitted" / "deferred" / "failed" with try_admit_one's semantics.
        Restores ``lengths[slot] = len(prompt) + n_dispatched - 1``, so the
        next block's positions, and with the request's own key stream its
        tokens, are those it would have had unmoved. Adopted pages are
        private (never prefix-indexed)."""
        if not self.free_slots:
            return "deferred"
        if (self._active or self._prefilling) \
                and self._active_sampling != req.sampling:
            return "deferred"
        n = int(payloads["n_pages"])
        if n > self.pages_per_seq:
            self._fail_request(req, ValueError(
                f"request {req.rid}: handoff bundle spans {n} pages, "
                f"page table holds {self.pages_per_seq}"))
            return "failed"
        if n > self._available_pages():
            if not self._active and not self._prefilling:
                self._fail_request(req, RuntimeError(
                    f"request {req.rid}: handoff bundle needs {n} pages, "
                    f"idle pool has {self._available_pages()}"))
                return "failed"
            self.stats["deferred_admissions"] += 1
            return "deferred"
        slot = self.free_slots.pop()
        pages = self._alloc_pages(n)
        self._ref_pages(pages)
        self.stats["peak_pages"] = max(self.stats["peak_pages"],
                                       self._pages_in_use)
        try:
            with self._locked_dispatch(("insert", n * self.page_size)), \
                    _trace.span("serve.adopt"), self._rtrace_annotation(req):
                chaos.site("serve.prefill")
                self._insert(self._to_device(payloads["ks"]),
                             self._to_device(payloads["vs"]), pages)
        except Exception as e:  # fail this request alone, free everything
            self._unref_pages(pages)
            self.free_slots.append(slot)
            self._fail_request(req, e)
            return "failed"
        if req.sampling[0] and req.key_base is None:
            req.key_base = self._key_base(req)
        row = np.zeros(self.pages_per_seq, np.int32)
        row[:n] = pages
        self.page_table[slot] = row
        self.lengths[slot] = len(req.prompt) + req.n_dispatched - 1
        req.pages = pages
        req.slot = slot
        if req.t_admit is None:
            req.t_admit = time.monotonic()
        self._active[slot] = req
        self._active_sampling = req.sampling
        self._update_gauges()
        return "admitted"

    # ---- request lifecycle --------------------------------------------------
    @staticmethod
    def _key_base(req):
        """The request's noise key of (seed, rid)."""
        return int(request_keys(torch.tensor([req.seed]),
                                torch.tensor([req.rid]))[0])

    def _fail_request(self, req, exc):
        req.error = exc
        req.result = None
        req.finished = True
        req.t_done = time.monotonic()
        self.request_errors[req.rid] = exc
        # bounded for a long-running online engine; serve() raises the
        # bound to its batch size so every failed rid keeps its entry
        while len(self.request_errors) > self._request_errors_bound:
            self.request_errors.pop(next(iter(self.request_errors)))
        self.stats["failed_requests"] += 1
        counters.bump("fault.serve.request_failed")

    def _group_done(self):
        """Forget the group's sampling and adapter rank once no request
        is left in it."""
        if not self._active and not self._prefilling:
            self._active_sampling = None
            self._active_lora_rank = None

    def _release_slot(self, slot, pages):
        self._unref_pages(pages)
        self.free_slots.append(slot)
        self.page_table[slot] = 0
        self.lengths[slot] = 0
        self._slot_adapter.pop(slot, None)
        self._group_done()

    def _retire(self, slot):
        req = self._active.pop(slot)
        req.result = np.asarray(req.tokens, np.int32)
        req.finished = True
        req.t_done = time.monotonic()
        self._release_slot(slot, req.pages)
        return req

    def _abort_prefill(self, slot, timed_out=False):
        """Cancelled/timed-out mid-prefill: retire with the prompt-only
        partial result."""
        st = self._prefilling.pop(slot)
        req = st.req
        req.result = np.asarray(req.tokens, np.int32)
        req.finished = True
        req.timed_out = timed_out
        req.t_done = time.monotonic()
        self._release_slot(slot, st.pages)
        return req

    def _update_gauges(self):
        _M_OCCUPANCY.set(self.active_count() / self.max_seqs)
        free, evict = len(self.free_pages), len(self._evictable)
        _M_POOL_FREE.set(free)
        _M_POOL_EVICT.set(evict)
        _M_POOL_USED.set(self._pages_in_use)
        _M_POOL_FRAG.set(evict / (free + evict) if free + evict else 0.0)

    def _region_for(self, suffix_len):
        """Pages the prefill of a ``suffix_len``-token suffix writes:
        token-exact on the ragged plane, the chunk ladder's pages under
        ``prefill_chunk``, else the bucket's pages."""
        if self._ragged:
            return -(-suffix_len // self.page_size)
        return self._legacy_region(suffix_len)

    def _legacy_region(self, suffix_len):
        """``_region_for`` on the legacy plane."""
        if self.prefill_chunk and suffix_len > self.prefill_chunk:
            return self._chunk_plan(suffix_len)[2]
        return self._pages_for_bucket(prompt_bucket(suffix_len),
                                      self.page_size)

    @_on_engine_stream
    def try_admit_one(self, req):
        """Non-blocking admission of one EngineRequest. Returns "admitted"
        (drive it with step()), "done" (the legacy prefill's first token
        finished it), "failed" (it alone failed: too long, larger than the
        whole pool, a mismatched adapter, or its prefill raised) or
        "deferred" (no free slot or pages yet, the running group samples
        otherwise, a base group runs, the adapter's rank differs, or the
        group holds ``PADDLE_LORA_SLOTS`` adapters already). The caller
        pops the request on every status but "deferred".

        The ragged plane reserves the pages (a prefix-cache hit's shared
        pages first) and installs the page-table row; the prompt streams
        in through the mixed dispatches. The legacy plane prefills here
        (monolithic, or the first chunk of the ladder)."""
        if not self.free_slots:
            return "deferred"
        ad = req.adapter
        if self._active or self._prefilling:
            if self._active_sampling != req.sampling:
                return "deferred"
            if ad is not None:
                if self._active_lora_rank is None:
                    # a base group runs the untouched base path: wait
                    return "deferred"
                if ad.rank != self._active_lora_rank:
                    return "deferred"
                digs = {a.digest for a in self._slot_adapter.values()}
                if ad.digest not in digs and len(digs) >= self._lora_slots:
                    return "deferred"
        _M_REQUESTS.inc()
        # request-scoped trace: the admission span nests under the
        # frontend's attempt span; every return below closes it
        adm = req.trace.child("admit") if req.trace is not None else None
        prompt = req.prompt
        true_len = len(prompt)
        bucket = prompt_bucket(true_len)
        if true_len + req.max_new_tokens > self.max_len or bucket > self.max_len:
            self._fail_request(req, ValueError(
                f"request {req.rid}: len {true_len} (bucket {bucket}) + "
                f"{req.max_new_tokens} exceeds max_len={self.max_len}"))
            if adm is not None:
                adm.end("error", error=req.error_message)
            return "failed"
        if ad is not None:
            err = self._lora_reject(ad)
            if err is not None:
                self._fail_request(req, err)
                if adm is not None:
                    adm.end("error", error=req.error_message)
                return "failed"
        bs = self.page_size
        if self.enable_prefix_cache:
            self._refresh_cache_guard()
            n_pre, shared, digests = self._match_prefix(prompt, true_len)
        else:
            n_pre, shared, digests = 0, [], None
        # shrink the hit until the prefix and the prefill's region fit the
        # page-table row (the legacy suffix bucket rounds up on its own)
        suffix_len = true_len
        while n_pre:
            suffix_len = true_len - n_pre * bs
            if n_pre + self._region_for(suffix_len) <= self.pages_per_seq:
                break
            n_pre -= 1
            shared = shared[:n_pre]
        if not n_pre:
            suffix_len = true_len
        region = self._region_for(suffix_len)
        total_need = max(n_pre + region,
                         -(-(true_len + req.max_new_tokens) // bs))
        # hold the shared pages BEFORE the availability check: evictable
        # ones would otherwise count as allocatable twice
        self._ref_pages(shared)
        if total_need - n_pre > self._available_pages():
            self._unref_pages(shared)
            if not self._active and not self._prefilling:
                self._fail_request(req, RuntimeError(
                    f"request {req.rid} needs more pages than the pool holds "
                    f"({true_len}+{req.max_new_tokens} tokens vs "
                    f"{(self.num_pages - 1) * bs} pool tokens)"))
                if adm is not None:
                    adm.end("error", error=req.error_message)
                return "failed"
            self.stats["deferred_admissions"] += 1
            if adm is not None:  # each deferred probe shows in the trace
                adm.end("deferred", need_pages=total_need - n_pre)
            return "deferred"
        if self.enable_prefix_cache:
            # the hit rate's denominator, once per admission
            _M_PREFIX_LOOKUP.inc((true_len - 1) // bs)
        slot = self.free_slots.pop()
        new_pages = self._alloc_pages(total_need - n_pre)
        self._ref_pages(new_pages)
        pages = shared + new_pages
        self.stats["peak_pages"] = max(self.stats["peak_pages"],
                                       self._pages_in_use)
        req.pages = pages
        req.slot = slot
        req.t_admit = time.monotonic()
        sampling = req.sampling
        if sampling[0] and req.key_base is None:
            req.key_base = self._key_base(req)
        if self._ragged or (self.prefill_chunk
                            and suffix_len > self.prefill_chunk
                            and ad is None):
            # reserve-then-stream: the ragged plane's mixed dispatches, or
            # the legacy chunk ladder (adapter requests prefill
            # monolithically, keeping the ladder free of adapter forms)
            req.tokens = list(prompt)  # tok0 appended at graduation
            if n_pre:
                self.stats["prefix_hit_pages"] += n_pre
                _M_PREFIX_HIT.inc(n_pre)
            self._prefilling[slot] = _PrefillState(req, pages, n_pre,
                                                   digests, bs)
            self._active_sampling = sampling
            if not self._ragged:
                if adm is not None:
                    adm.end("ok", slot=slot, pages=len(pages),
                            prefix_hit_pages=n_pre, chunked=True)
                # the first chunk dispatches here
                return self._prefill_chunk_step(slot)
            row = np.zeros(self.pages_per_seq, np.int32)
            row[:len(pages)] = pages
            self.page_table[slot] = row
            self.lengths[slot] = n_pre * bs
            if ad is not None:
                self._slot_adapter[slot] = ad
                self._active_lora_rank = ad.rank
            if adm is not None:
                adm.end("ok", slot=slot, pages=len(pages),
                        prefix_hit_pages=n_pre, ragged=True)
            return "admitted"
        sbucket = prompt_bucket(suffix_len)
        ids_p = np.zeros((1, sbucket), np.int32)
        ids_p[0, :suffix_len] = prompt[n_pre * bs:]
        if ad is None:
            progs = ([("gather", n_pre), ("suffix", n_pre, sbucket, sampling)]
                     if n_pre else [("prefill", sbucket, sampling)])
        else:
            progs = ([("gather", n_pre),
                      ("lora_suffix", n_pre, sbucket, sampling, ad.rank)]
                     if n_pre
                     else [("lora_prefill", sbucket, sampling, ad.rank)])
        t_p0 = time.monotonic()
        try:
            with self._locked_dispatch(*progs, ("insert", sbucket)), \
                    _trace.span("serve.prefill"), self._rtrace_annotation(req):
                chaos.site("serve.prefill")
                if n_pre:
                    self.stats["prefix_hit_pages"] += n_pre
                    _M_PREFIX_HIT.inc(n_pre)
                prefix = self._gather_prefix(shared) if n_pre else None
                tok0, ks, vs = self._prefill(
                    self._to_device(ids_p), suffix_len, sampling,
                    self._prefill_key(req),
                    prefix, None if ad is None else self._lora_one(ad))
                self._insert(ks, vs, new_pages[:region])
                # the prefill's readback, inside the guard: a failure here
                # fails this request alone
                tok0 = int(tok0[0])
        except Exception as e:  # fail this request alone, free everything
            self._unref_pages(pages)
            self.free_slots.append(slot)
            self._fail_request(req, e)
            if adm is not None:
                adm.end("error", error=req.error_message)
            return "failed"
        dt = time.monotonic() - t_p0
        if _trace.enabled():
            # serving goodput: a first dispatch is compile, not prefill
            _goodput.serving_note(
                "compile" if self._last_dispatch_cold else "prefill", dt)
        if adm is not None:
            adm.span_at("prefill", dt, dt, bucket=sbucket,
                        prefix_hit_pages=n_pre,
                        cold=self._last_dispatch_cold)
        if self.enable_prefix_cache:
            self._index_prompt_pages(true_len, pages, n_pre, digests)
        req.tokens = list(prompt)
        status = self._activate(slot, req, tok0)
        if adm is not None:
            adm.end("ok", slot=slot, pages=len(pages),
                    prefix_hit_pages=n_pre)
        return status

    def _prefill_key(self, req):
        """The first token's noise key ([1] int64), None when greedy."""
        if not req.sampling[0]:
            return None
        return torch.tensor([req.key_base], dtype=torch.int64,
                            device=self.device)

    def _activate(self, slot, req, tok0):
        """The legacy admission's epilogue (monolithic prefill and the
        chunk ladder's graduation): install the page-table row, stamp the
        first token, join the decode group, fire the callback, and retire
        at once on a first-token eos or an exhausted budget. Returns
        "done" or "admitted"."""
        row = np.zeros(self.pages_per_seq, np.int32)
        row[:len(req.pages)] = req.pages
        self.page_table[slot] = row
        self.lengths[slot] = len(req.prompt)
        now = time.monotonic()
        req.t_first_token = now
        _M_TTFT.observe(now - req.t_enqueue)
        if req.trace is not None:
            req.trace.event("first_token",
                            ttft_s=round(now - req.t_enqueue, 6))
        _M_TOKENS.inc()
        req.tokens.append(tok0)
        req.n_generated = 1
        req.n_dispatched = 1
        req.last_token = tok0
        # registered BEFORE the callback: if it raises, cleanup finds it
        self._active[slot] = req
        self._active_sampling = req.sampling
        if req.adapter is not None:
            self._slot_adapter[slot] = req.adapter
            self._active_lora_rank = req.adapter.rank
        if req.on_token is not None:
            req.on_token(req.rid, tok0)
        if (req.eos_token_id is not None and tok0 == req.eos_token_id) \
                or req.n_generated >= req.max_new_tokens:
            self._retire(slot)
            return "done"
        return "admitted"

    def _chunk_plan(self, suffix_len):
        """(full_chunks, final_len, region_pages) of a chunked suffix:
        non-final chunks are exactly ``prefill_chunk`` tokens (whole
        pages); the final one keeps >= 1 token (its logits give the first
        token) and pads to its own bucket."""
        c = self.prefill_chunk
        n_full = (suffix_len - 1) // c
        final_len = suffix_len - n_full * c
        region = (n_full * (c // self.page_size)
                  + self._pages_for_bucket(prompt_bucket(final_len),
                                           self.page_size))
        return n_full, final_len, region

    def _prefill_chunk_step(self, slot):
        """Land ONE chunk of ``slot``'s prompt (the legacy ladder): gather
        the pages already filled, prefill the next chunk against them,
        insert its K/V into the next pages. The final chunk graduates the
        request (its first token from the same key the monolithic path
        uses). Returns "admitted", "done" or "failed" (resources freed,
        co-tenants untouched)."""
        st = self._prefilling[slot]
        req = st.req
        bs = self.page_size
        prompt = req.prompt
        true_len = len(prompt)
        filled = st.filled_pages
        done_tokens = filled * bs
        rest = true_len - done_tokens
        final = rest <= self.prefill_chunk
        clen = rest if final else self.prefill_chunk
        cbucket = prompt_bucket(clen) if final else clen
        npg = self._pages_for_bucket(cbucket, bs)
        sampling = req.sampling
        ids = np.zeros((1, cbucket), np.int32)
        ids[0, :clen] = prompt[done_tokens:done_tokens + clen]
        progs = ([("gather", filled), ("suffix", filled, cbucket, sampling)]
                 if filled else [("prefill", cbucket, sampling)])
        t_p0 = time.monotonic()
        try:
            with self._locked_dispatch(*progs, ("insert", cbucket)), \
                    _trace.span("serve.prefill"), self._rtrace_annotation(req):
                chaos.site("serve.prefill")
                prefix = (self._gather_prefix(st.pages[:filled]) if filled
                          else None)
                # a non-final chunk's drawn token is discarded
                tok0, ks, vs = self._prefill(
                    self._to_device(ids), clen, sampling,
                    self._prefill_key(req), prefix)
                self._insert(ks, vs, st.pages[filled:filled + npg])
                tok0 = int(tok0[0])   # the chunk's readback, inside the guard
        except Exception as e:
            del self._prefilling[slot]
            self._unref_pages(st.pages)
            self.free_slots.append(slot)
            self._group_done()
            self._fail_request(req, e)
            if req.trace is not None:
                req.trace.event("prefill_chunk_failed",
                                error=req.error_message)
            return "failed"
        _M_CHUNKS.inc()
        dt = time.monotonic() - t_p0
        if _trace.enabled():
            _goodput.serving_note(
                "compile" if self._last_dispatch_cold else "prefill", dt)
        if req.trace is not None:
            req.trace.span_at("prefill_chunk", dt, dt,
                              filled_pages=filled, tokens=clen, final=final,
                              cold=self._last_dispatch_cold)
        if not final:
            st.filled_pages = filled + npg
            return "admitted"
        del self._prefilling[slot]
        if self.enable_prefix_cache:
            self._index_prompt_pages(true_len, st.pages, st.n_pre0,
                                     st.digests)
        return self._activate(slot, req, tok0)

    def _advance_prefill(self):
        """One chunk for every mid-prefill slot, between decode blocks
        (co-admitted long prompts graduate together). Returns the requests
        that reached a terminal state."""
        out = []
        for slot in list(self._prefilling):
            req = self._prefilling[slot].req
            if self._prefill_chunk_step(slot) in ("done", "failed"):
                out.append(req)
        return out

    def _admit_from(self, queue):
        """Admit from the head of ``queue`` until one defers (FIFO),
        popping every request that reached another status."""
        while queue and self.free_slots:
            if self.try_admit_one(queue[0]) == "deferred":
                break
            queue.popleft()
        self._update_gauges()

    # ---- stepping -------------------------------------------------------------
    @_on_engine_stream
    def step(self):
        """One scheduling round: sweep cancellations, (legacy) land one
        prefill chunk per mid-prefill slot, advance the dispatch pipeline,
        sweep timeouts. Returns the EngineRequests that reached a terminal
        state."""
        retired = self._pending_retired
        self._pending_retired = []
        for slot in list(self._active):
            if self._active[slot].cancelled:
                retired.append(self._retire(slot))
        for slot in list(self._prefilling):
            if self._prefilling[slot].req.cancelled:
                retired.append(self._abort_prefill(slot))
        if self._ragged:
            dispatch = self._dispatch_ragged
        else:
            retired.extend(self._advance_prefill())
            dispatch = self._dispatch_decode

        def busy():
            return self._active or (self._ragged and self._prefilling)

        if self.async_decode:
            prev = self._inflight
            if prev is not None:
                # enqueue block k+1 BEFORE block k's readback
                self._inflight = dispatch(chain=prev)
                retired.extend(self._process_block(prev))
            if self._inflight is None and busy():
                self._inflight = dispatch()
        elif busy():
            rec = dispatch()
            if rec is not None:
                retired.extend(self._process_block(rec))
        now = time.monotonic()
        for slot in list(self._active):
            r = self._active[slot]
            if r.timeout_s is not None and now - r.t_admit > r.timeout_s:
                self.stats["timed_out_requests"] += 1
                counters.bump("fault.serve.request_timeout")
                r.timed_out = True
                retired.append(self._retire(slot))
        for slot in list(self._prefilling):
            r = self._prefilling[slot].req
            if r.timeout_s is not None and now - r.t_admit > r.timeout_s:
                self.stats["timed_out_requests"] += 1
                counters.bump("fault.serve.request_timeout")
                retired.append(self._abort_prefill(slot, timed_out=True))
        self._update_gauges()
        return retired

    def _dispatch_ragged(self, chain=None):
        """The mixed dispatch while prompt chunks are pending, else the
        fixed-k decode block."""
        if self._prefilling:
            return self._dispatch_ragged_mixed(chain)
        return self._dispatch_decode(chain=chain)

    def _covered(self, chain):
        """Slots whose feed token is the in-flight block's device row: the
        slot must still hold the SAME request."""
        if chain is None:
            return set()
        return {s for s, r in chain.rows if self._active.get(s) is r}

    def _dispatch_ragged_mixed(self, chain):
        """Pack every decode row (one feed token each) and up to
        ``_ragged_chunk`` prompt tokens, shortest remaining prompt first;
        prompts landing their last chunk graduate into the decode group
        at this dispatch."""
        sampling = self._active_sampling
        k = self.decode_block
        S = self.max_seqs
        T = self._ragged_tokens
        budget = self._ragged_chunk
        sched = []
        order = sorted(self._prefilling.items(),
                       key=lambda kv: (len(kv[1].req.prompt) - kv[1].consumed,
                                       kv[0]))
        for slot, st in order:
            if budget <= 0:
                break
            rem = len(st.req.prompt) - st.consumed
            take = min(rem, budget)
            budget -= take
            sched.append((slot, st, take, take == rem))
        covered = self._covered(chain)
        chunk_rows = {slot: (st, take, final)
                      for slot, st, take, final in sched}
        tok_block = np.zeros(T, np.int32)
        row_of = np.zeros(T, np.int32)
        token_pos = np.zeros(T, np.int32)
        valid = np.zeros(T, bool)
        q_lens = np.zeros(S, np.int32)
        lengths_op = np.zeros(S, np.int32)
        caps = np.zeros(S, np.int32)   # 0 = frozen/scratch-routed in the scan
        keys = np.zeros(S, np.int64)   # sampled rows' noise keys
        idxs = np.zeros(S, np.int64)   # and the token index of their tok0
        chain_pos, chain_rows = [], []
        part = []    # decode participants: active rows + graduating rows
        grads = []   # (slot, st) graduating at THIS dispatch
        pos = 0
        for slot in range(S):
            r = self._active.get(slot)
            if r is not None:
                caps[slot] = len(r.prompt) + r.max_new_tokens - 1
                # an over-budget row's feed position stays in its pages
                base = min(int(self.lengths[slot]), int(caps[slot]))
                q_lens[slot] = 1
                lengths_op[slot] = base
                row_of[pos] = slot
                token_pos[pos] = base
                valid[pos] = True
                if slot in covered:
                    chain_pos.append(pos)
                    chain_rows.append(slot)
                else:
                    tok_block[pos] = r.last_token
                if sampling[0]:
                    keys[slot] = r.key_base
                    idxs[slot] = r.n_dispatched
                part.append((slot, r))
                pos += 1
            elif slot in chunk_rows:
                st, take, final = chunk_rows[slot]
                req = st.req
                sl = slice(pos, pos + take)
                tok_block[sl] = req.prompt[st.consumed:st.consumed + take]
                row_of[sl] = slot
                token_pos[sl] = int(self.lengths[slot]) + np.arange(take)
                valid[sl] = True
                q_lens[slot] = take
                lengths_op[slot] = self.lengths[slot]
                pos += take
                if final:
                    caps[slot] = len(req.prompt) + req.max_new_tokens - 1
                    if sampling[0]:
                        keys[slot] = req.key_base   # idx 0: first token
                    part.append((slot, req))
                    grads.append((slot, st))
        cu = np.zeros(S + 1, np.int32)
        cu[1:] = np.cumsum(q_lens)
        # non-participant rows (empty slots + still-mid-prefill prompts)
        # route their scan-step writes to the scratch page
        scan_pt = np.where((caps > 0)[:, None], self.page_table, 0)
        b_idx = np.clip(cu[1:] - 1, 0, T - 1)
        dev = self._to_device
        chained = bool(chain_pos)
        rank = self._active_lora_rank
        progs = [("ragged", sampling) if rank is None
                 else ("lora_ragged", sampling, rank)]
        if sampling[0]:
            progs.append(("keys", k))

        def dispatch():
            # the chaos site fires before the device work, so an injected
            # outage retries against intact pools
            chaos.site("serve.decode")
            return self._ragged_step(
                dev(tok_block),
                dev(np.asarray(chain_pos, np.int64)) if chained else None,
                dev(np.asarray(chain_rows, np.int64)) if chained else None,
                chain.last if chained else None,
                dev(cu), dev(row_of), dev(token_pos), dev(valid),
                dev(b_idx.astype(np.int64)), dev(self.page_table),
                dev(scan_pt), dev(lengths_op), dev(caps), sampling,
                *((dev(keys), dev(idxs)) if sampling[0] else (None, None)),
                lora)

        t0 = time.monotonic()
        with self._locked_dispatch(*progs), _trace.span("serve.decode"):
            start = self._devprof_start()
            lora = self._lora_rows(part)
            blk = self.retry_policy.run(dispatch, name="serve.decode")
            cold = self._last_dispatch_cold
            if _devprof._PLANE is not None:
                # the packed pass (each row's queries after its pool
                # length), then k - 1 decode steps over the participants
                packed = [(int(q_lens[sl]), int(lengths_op[sl]))
                          for sl in range(S) if q_lens[sl]]
                kv0 = lengths_op + q_lens
                steps = [[(1, int(kv0[sl]) + s) for sl, _ in part]
                         for s in range(k - 1)]
                n_chunk = sum(t for _, _, t, _ in sched)
                self._devprof_tick(
                    f"serve.ragged[k{k},s{sampling}]" if rank is None else
                    f"serve.lora_ragged[r{rank},k{k},s{sampling}]",
                    t0, start, [packed] + steps, k * len(part) + n_chunk,
                    cold)
            rec = self._inflight_block(blk, k, part, t0, cold)
        if _trace.enabled() and cold:
            # a first dispatch's wall is compile; its readback skips the
            # decode note (the cold flag rides the in-flight block)
            _goodput.serving_note("compile", time.monotonic() - t0)
        for slot, st, take, final in sched:
            _M_CHUNKS.inc()
            st.consumed += take
            self.lengths[slot] += take
        for slot, st in grads:
            # graduation at DISPATCH: the packed pass sampled tok0 and the
            # scan is already decoding this row; its prompt pages' KV is
            # enqueued, so later requests may share them
            del self._prefilling[slot]
            if self.enable_prefix_cache:
                self._index_prompt_pages(len(st.req.prompt), st.pages,
                                         st.n_pre0, st.digests)
            st.req.n_dispatched = 0
            self._active[slot] = st.req
        for slot, r in part:
            r.n_dispatched += k
            self.lengths[slot] += k
        for slot, st in grads:
            # decode invariant lengths = len(prompt) + n_dispatched - 1: the
            # boundary token was fed at position len(prompt)
            self.lengths[slot] -= 1
        return rec

    def _dispatch_decode(self, chain=None):
        """Dispatch ONE decode block over the active set without reading it
        back; ``chain`` is the in-flight block whose device-resident last
        row feeds every slot it covered. The ragged plane runs k =
        decode_block; the legacy ladder the power of two at most
        decode_block and the largest remaining budget (async; the smallest
        in sync mode). None when nothing can dispatch."""
        if not self._active:
            return None
        budgets = [r.max_new_tokens - r.n_dispatched
                   for r in self._active.values()]
        remaining = max(budgets) if self.async_decode else min(budgets)
        if remaining <= 0:
            return None  # every row fully dispatched: read back, retire
        sampling = self._active_sampling
        if self._ragged:
            k = self.decode_block
        else:
            k = min(self.decode_block, remaining)
            k = 1 << (k.bit_length() - 1)
        rows = list(self._active.items())
        covered = self._covered(chain)
        S = self.max_seqs
        toks = np.zeros((S, 1), np.int32)
        fresh = np.zeros((S, 1), bool)
        caps = np.zeros(S, np.int32)  # empty slots freeze at 0
        keys = np.zeros(S, np.int64)
        idxs = np.zeros(S, np.int64)
        for slot, r in rows:
            caps[slot] = len(r.prompt) + r.max_new_tokens - 1
            if slot not in covered:
                toks[slot, 0] = r.last_token
                fresh[slot, 0] = True
            if sampling[0]:
                keys[slot] = r.key_base
                idxs[slot] = r.n_dispatched
        dev = self._to_device
        rank = self._active_lora_rank
        if rank is not None:
            progs = [("lora_decode", sampling, rank) if k == 1
                     else ("lora_block", sampling, rank, k)]
        else:
            progs = [("decode", sampling) if k == 1
                     else ("block", sampling, k)]
        if sampling[0]:
            progs.append(("keys", k))

        def dispatch():
            # the chaos site fires before the device work, so an injected
            # outage retries against intact pools
            chaos.site("serve.decode")
            if chain is None:
                feed = dev(toks)
            elif fresh.any():
                feed = torch.where(dev(fresh), dev(toks), chain.last)
            else:
                feed = chain.last
            return self._decode_block(
                feed, dev(self.page_table), dev(self.lengths), dev(caps), k,
                sampling,
                *((dev(keys), dev(idxs)) if sampling[0] else (None, None)),
                lora)

        t0 = time.monotonic()  # dispatch epoch: TPOT = readback - t0 per k
        with self._locked_dispatch(*progs), _trace.span("serve.decode"):
            start = self._devprof_start()
            lora = self._lora_rows(rows)
            blk = self.retry_policy.run(dispatch, name="serve.decode")
            cold = self._last_dispatch_cold
            if _devprof._PLANE is not None:
                base = [min(int(self.lengths[sl]), int(caps[sl]))
                        for sl, _ in rows]
                if rank is not None:
                    key = (f"serve.lora_decode[r{rank},s{sampling}]"
                           if k == 1 else f"serve.lora_decode_block[r{rank},"
                           f"k{k},s{sampling}]")
                else:
                    key = (f"serve.decode[s{sampling}]" if k == 1
                           else f"serve.decode_block[k{k},s{sampling}]")
                self._devprof_tick(
                    key, t0, start, [[(1, b + s) for b in base]
                                     for s in range(k)],
                    k * len(rows), cold)
            rec = self._inflight_block(blk, k, rows, t0, cold)
        if _trace.enabled() and cold:
            _goodput.serving_note("compile", time.monotonic() - t0)
        for slot, r in rows:
            r.n_dispatched += k
            self.lengths[slot] += k
        return rec

    def _inflight_block(self, blk, k, rows, t0, cold=False):
        """Start ``blk``'s readback: a non-blocking copy into pinned memory
        and the event that marks it done, both on the engine's stream
        (waited for at once when ``async_decode`` is off; nothing to wait
        for on the CPU)."""
        last = blk[k - 1][:, None]  # the row the NEXT block chains from
        if blk.device.type == "cpu":
            return _InflightBlock(last, k, rows, blk, None, t0, cold)
        host = torch.empty(blk.shape, dtype=blk.dtype, pin_memory=True)
        host.copy_(blk, non_blocking=True)
        ready = torch.cuda.Event()
        ready.record()
        if not self.async_decode:
            ready.synchronize()
            ready = None
        return _InflightBlock(last, k, rows, host, ready, t0, cold)

    def _process_block(self, rec):
        """The readback point: block tokens reach the host, each request
        emits them, finished ones retire (mid-block EOS discards the rest
        of the block)."""
        if self.async_decode:
            # host time that ran while the device executed this block
            _M_OVERLAP.observe(time.monotonic() - rec.t0)
        with _trace.span("serve.decode.sync"):
            if rec.ready is not None:
                try:
                    rec.ready.synchronize()
                except Exception as e:
                    # an asynchronous OOM surfaces at the readback, outside
                    # the dispatch section: the same forensics seam
                    _compilemem.maybe_oom_report(
                        e, program="serve.decode_block")
                    raise
            block = rec.host.numpy()
        # wall from dispatch to readback, per token: the TPOT
        block_wall = time.monotonic() - rec.t0
        _M_TPOT.observe(block_wall / rec.k)
        if _trace.enabled() and not rec.cold:
            # serving goodput: dispatch to readback is the decode slice (a
            # first dispatch already landed in compile)
            _goodput.serving_note("decode", block_wall)
        self.stats["decode_steps"] += rec.k
        retired = []
        t_e0 = time.monotonic()
        with _trace.span("serve.emit"):
            for slot, r in rec.rows:
                if r.finished or self._active.get(slot) is not r:
                    continue  # retired while in flight: overshoot discarded
                if r.t_first_token is None:
                    # a ragged graduation's first token arrives here
                    r.t_first_token = time.monotonic()
                    _M_TTFT.observe(r.t_first_token - r.t_enqueue)
                    if r.trace is not None:
                        r.trace.event("first_token", ttft_s=round(
                            r.t_first_token - r.t_enqueue, 6))
                if r.trace is not None:
                    # the request's view of this decode dispatch
                    r.trace.span_at("decode_block", block_wall, block_wall,
                                    k=rec.k)
                emitted = 0
                for s in range(rec.k):
                    tok = int(block[s, slot])
                    r.tokens.append(tok)
                    r.n_generated += 1
                    r.last_token = tok
                    emitted += 1
                    _M_TOKENS.inc()
                    if r.on_token is not None:
                        r.on_token(r.rid, tok)
                    if r.n_generated >= r.max_new_tokens or (
                            r.eos_token_id is not None
                            and tok == r.eos_token_id):
                        retired.append(self._retire(slot))
                        break
                if r.trace is not None:
                    r.trace.event("emit", tokens=emitted,
                                  n_generated=r.n_generated)
        if _trace.enabled():
            _goodput.serving_note("host_emit", time.monotonic() - t_e0)
        return retired

    @_joined
    @_on_engine_stream
    def drain(self):
        """Finish every admitted request without admitting more; returns the
        retired EngineRequests."""
        out = []
        while (self._active or self._prefilling
               or self._inflight is not None or self._pending_retired):
            out.extend(self.step())
        return out

    @_joined
    @_on_engine_stream
    def serve(self, prompts, max_new_tokens, eos_token_id=None,
              do_sample=False, temperature=1.0, top_k=0, top_p=1.0, seed=0,
              on_token=None, request_timeout_s=None, sampling_overrides=None,
              adapters=None):
        """Serve a list of int32 prompt arrays; returns a list of
        [len(prompt) + n_generated] arrays (stops at eos or max_new_tokens;
        None for a request that failed alone, its error in
        ``request_errors``). ``max_new_tokens`` is a scalar, a per-request
        list or a complete {rid: n} dict (``_per_request``). Requests
        beyond the slot or page capacity queue and join as earlier ones
        retire.

        ``do_sample`` with ``temperature``, ``top_k`` and ``top_p`` samples
        (the reference's sampler); request ``rid`` draws token i from the
        noise of (seed, rid, i), so its tokens do not depend on its
        co-tenants. ``sampling_overrides`` (a per-request list of dicts or
        None, covering every request, or a sparse {rid: dict}) overrides
        those four per request; requests sharing a sampling tuple
        co-schedule, the others wait for the running group. ``adapters``:
        one ``LoRAAdapter`` for every request, a per-request list (None
        entries: the base model) covering every request, or a sparse {rid:
        adapter} dict."""
        if self._active or self._prefilling or self._inflight is not None:
            raise RuntimeError("serve() on an engine with active requests — "
                               "drain() first")
        default_sampling = canonical_sampling(do_sample, temperature,
                                              top_k, top_p)
        per_new = _per_request(max_new_tokens, len(prompts), "max_new_tokens")
        if (sampling_overrides is not None
                and not isinstance(sampling_overrides, dict)
                and len(sampling_overrides) != len(prompts)):
            raise ValueError(
                f"per-request sampling_overrides has "
                f"{len(sampling_overrides)} entries for "
                f"{len(prompts)} requests")
        if (adapters is not None and isinstance(adapters, (list, tuple))
                and len(adapters) != len(prompts)):
            raise ValueError(
                f"per-request adapters has {len(adapters)} entries for "
                f"{len(prompts)} requests")
        if self.enable_prefix_cache:
            self._refresh_cache_guard()
        reqs = []
        for rid, p in enumerate(prompts):
            samp = default_sampling
            if sampling_overrides is not None:
                ov = (sampling_overrides.get(rid)
                      if isinstance(sampling_overrides, dict)
                      else sampling_overrides[rid])
                if ov:
                    samp = canonical_sampling(
                        ov.get("do_sample", do_sample),
                        ov.get("temperature", temperature),
                        ov.get("top_k", top_k), ov.get("top_p", top_p))
            if adapters is None:
                ad = None
            elif isinstance(adapters, dict):
                ad = adapters.get(rid)
            elif isinstance(adapters, (list, tuple)):
                ad = adapters[rid]
            else:
                ad = adapters
            reqs.append(EngineRequest(
                rid, p, per_new[rid], eos_token_id=eos_token_id,
                sampling=samp, seed=seed, timeout_s=request_timeout_s,
                on_token=on_token, adapter=ad))
        self.request_errors = {}
        self._request_errors_bound = max(1024, len(prompts))
        queue = deque(reqs)
        _M_QUEUE.set(len(queue))
        try:
            with _trace.span("serve.admit"):
                self._admit_from(queue)
            _M_QUEUE.set(len(queue))
            while (queue or self._active or self._prefilling
                   or self._inflight is not None):
                if not (self._active or self._prefilling
                        or self._inflight is not None):
                    raise AssertionError(
                        "serve(): admission stalled with an idle engine")
                self.step()
                with _trace.span("serve.admit"):
                    self._admit_from(queue)
                _M_QUEUE.set(len(queue))
            return [r.result for r in reqs]
        finally:
            self._request_errors_bound = 1024
            # a raising on_token (or any failure) must not leak pages/slots
            self._inflight = None
            for slot in list(self._active):
                self._retire(slot)
            for slot in list(self._prefilling):
                self._abort_prefill(slot)
