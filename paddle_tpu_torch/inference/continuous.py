"""Continuous-batching serving engine over the paged KV pool, ragged mode
(counterpart of ``paddle_tpu/inference/continuous.py``, its ``ragged=True``
path): greedy and sampled decoding, float or int8 KV pools, and the prefix
cache on float pools.

Each step is one device dispatch:

- the MIXED dispatch (``_ragged_step``) packs every decode row's feed
  token and up to ``prefill_chunk`` prompt tokens of mid-prefill requests
  into one ``[T]``-token stream, ``T = prefill_chunk + max_seqs``. The
  stream runs through the model with a ``RaggedLayerCache`` per layer
  (ragged paged attention, K4); every participant takes its first token
  from its last packed token, then ``k - 1`` more decode steps run with a
  ``PagedLayerCache`` per layer (paged decode attention, K5);
- the DECODE block (``_decode_block``) runs ``k`` decode steps over the
  active rows when no prompt is mid-prefill.

The scheduler is plain host Python between dispatches: admission reserves
``ceil((len(prompt) + max_new_tokens) / page_size)`` pages up front (page
0 is scratch: rows that take no part in a step point there), prompts
stream in token-exact chunks shortest-remaining first, and finished rows
retire and free their pages at each readback.

Under ``async_decode`` one block stays in flight: block k+1 is enqueued,
fed from block k's device-resident last-token row, before block k is read
back (a non-blocking copy into pinned memory plus an event), so the host's
emit/retire/admit work runs under the device's execution.

Sampling (``serve(do_sample=True, temperature, top_k, top_p, seed)``) uses
``generation._make_sampler``; all co-scheduled requests share one sampling
tuple (a request with another one is deferred until the group drains).
Each request draws from its own noise stream, keyed by (seed, request id,
token index) as the reference's ``fold_in(fold_in(seed, rid), i)`` is, so
its tokens do not depend on its co-tenants (``generation.gumbel_noise``).

``kv_cache_dtype="int8"`` keeps the pools as int8 codes with one f32 scale
per row (``ops.quantization.QuantizedTensor``): the attention kernels' int8
variants read them. ``enable_prefix_cache`` shares full prompt pages
between requests with the same prefix (content-addressed by a chained
blake2b digest, refcounted, LRU-evicted when the allocator needs pages);
it refuses int8 pools, as ``prefill_chunk`` does, with the reference's
messages.

Left out of this slice, and raising when asked for: LoRA adapters,
``ragged=False``, per-request ``sampling_overrides``, page export and
adoption, the metrics registry (``stats`` carries the counts), tracing,
chaos sites, device profiling and the compile ledger.
"""
import hashlib
import time
from collections import OrderedDict, deque

import numpy as np
import torch

from ..device import resolve
from ..generation import (
    _make_sampler, gumbel_noise, prompt_bucket, request_keys,
)
from ..ops.paged_attention import PagedLayerCache
from ..ops.quantization import QuantizedTensor, is_quantized
from ..ops.ragged_paged_attention import RaggedLayerCache

_LATER = "comes in a later slice of the port (see ROADMAP.md)"

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
    ``result`` (np.int32: prompt + generated tokens) or ``error`` is set;
    a ``timed_out`` request retires with a partial result."""

    __slots__ = ("rid", "prompt", "max_new_tokens", "eos_token_id",
                 "sampling", "seed", "timeout_s", "on_token", "tokens",
                 "n_generated", "n_dispatched", "last_token", "pages", "slot",
                 "key_base", "t_enqueue", "t_admit", "t_first_token",
                 "t_done", "error", "result", "finished", "timed_out",
                 "cancelled")

    def __init__(self, rid, prompt, max_new_tokens, eos_token_id=None,
                 sampling=GREEDY_SAMPLING, seed=0, timeout_s=None,
                 on_token=None):
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


class _PrefillState:
    """One slot mid-prefill: its page reservation (shared prefix pages
    first), the prefix-cache hit width, the prompt's page digest chain (to
    index its pages at graduation) and how many prompt tokens already sit
    in the pool."""

    __slots__ = ("req", "pages", "n_pre0", "digests", "consumed")

    def __init__(self, req, pages, n_pre, digests, page_size):
        self.req = req
        self.pages = pages
        self.n_pre0 = n_pre
        self.digests = digests
        self.consumed = n_pre * page_size


class _InflightBlock:
    """A dispatched block not yet read back: its device-resident last-step
    row (the next block's feed), the slot→request rows frozen at dispatch,
    and the host copy of the [k, max_seqs] token block with the event that
    marks it complete (None once complete)."""

    __slots__ = ("last", "k", "rows", "host", "ready")

    def __init__(self, last, k, rows, host, ready):
        self.last = last
        self.k = k
        self.rows = rows
        self.host = host
        self.ready = ready


class ContinuousBatchingEngine:
    """Ragged continuous-batching engine: greedy or sampled decoding over
    float (the model's dtype) or int8 (``kv_cache_dtype="int8"``) KV pools,
    with the prefix cache on float pools (``enable_prefix_cache``).

    ``model`` is a ``models.llama.LlamaForCausalLM`` that lives on
    ``device`` (default "cuda"; raises when CUDA is missing unless
    device="cpu"). LoRA adapters, ``ragged=False`` and per-request sampling
    overrides raise NotImplementedError."""

    def __init__(self, model, max_seqs=4, page_size=16, num_pages=None,
                 max_len=512, kv_cache_dtype=None, decode_block=8,
                 enable_prefix_cache=False, prefill_chunk=None,
                 async_decode=True, ragged=True, device="cuda"):
        dev = resolve(device)
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
        if not ragged:
            raise NotImplementedError(f"the ragged=False ladder {_LATER}")
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
        self.free_pages = list(range(1, self.num_pages))  # page 0 = scratch
        self.free_slots = list(range(max_seqs))
        self.page_table = np.zeros((max_seqs, self.pages_per_seq), np.int32)
        self.lengths = np.zeros(max_seqs, np.int32)
        if prefill_chunk:
            prefill_chunk = max(int(prefill_chunk) // page_size, 1) * page_size
        self.prefill_chunk = int(prefill_chunk or 0)
        self.async_decode = bool(async_decode)
        self.decode_block = max(int(decode_block), 1)
        # token budget for prompt chunks per mixed dispatch, and the packed
        # stream width: chunk budget + one feed token per slot
        self._ragged_chunk = max(self.prefill_chunk or min(256, max_len), 1)
        self._ragged_tokens = self._ragged_chunk + max_seqs
        self.stats = {"peak_pages": 0, "deferred_admissions": 0,
                      "decode_steps": 0, "prefix_hit_pages": 0,
                      "prefix_evictions": 0, "failed_requests": 0,
                      "timed_out_requests": 0}
        self.request_errors = {}
        self._active = {}         # slot -> EngineRequest (decoding)
        self._prefilling = {}     # slot -> _PrefillState
        self._inflight = None     # the ONE in-flight _InflightBlock
        self._pending_retired = []
        # the running group's sampling tuple (None when idle): requests
        # with another one are deferred until the group drains
        self._active_sampling = None
        self._samplers = {}       # sampling tuple -> sampler
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

    # ---- device programs ----------------------------------------------------
    def _draw(self, logits, sampling, keys, idx):
        """Each row's next token from its [max_seqs, V] logits under the
        group's ``sampling``; a sampled row draws the Gumbel noise of its
        request key (``keys``) at token index ``idx`` (int64 [max_seqs])."""
        sampler = self._samplers.get(sampling)
        if sampler is None:
            sampler = self._samplers[sampling] = _make_sampler(
                *sampling, repetition_penalty=1.0, min_length=0,
                eos_token_id=None)
        noise = (gumbel_noise(keys, idx, logits.shape[-1]) if sampling[0]
                 else None)
        return sampler(logits, noise)

    def _decode_steps(self, toks, page_table, lengths, caps, n, sampling,
                      keys, idx):
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
            logits, _ = self.model(toks, position_ids=lengths_e[:, None],
                                   past_key_values=caches)
            nxt = self._draw(logits[:, -1], sampling, keys,
                             None if idx is None else idx + s)
            out.append(nxt)
            toks = nxt[:, None]
            lengths = lengths_e + 1
        return out

    @torch.no_grad()
    def _ragged_step(self, tok_block, chain_pos, chain_rows, last, cu, row_of,
                     token_pos, valid, b_idx, page_table, scan_table,
                     lengths, caps, sampling, keys, idx):
        """The mixed program (reference ``_ragged_fn``): one packed pass
        through the ragged caches, each participant's first token from its
        last packed token (``b_idx``) at token index ``idx``, then ``k - 1``
        decode steps over ``scan_table`` (non-participants routed to the
        scratch page). Rows chained off an in-flight block take their feed
        token from its device-resident ``last`` row at packed positions
        ``chain_pos``. The pools are updated in place (the reference
        donates them)."""
        if chain_pos is not None:
            tok_block[chain_pos] = last[chain_rows, 0]
        kv_lens = lengths + (cu[1:] - cu[:-1])  # post-write totals
        caches = [RaggedLayerCache(kp, vp, page_table, kv_lens, cu, row_of,
                                   token_pos, valid)
                  for kp, vp in self.pools]
        h, _ = self.model.llama(tok_block[None],
                                position_ids=token_pos[None],
                                past_key_values=caches)
        tok0 = self._draw(self.model.head(h[0, b_idx]), sampling, keys, idx)
        tail = self._decode_steps(tok0[:, None], scan_table, kv_lens, caps,
                                  self.decode_block - 1, sampling, keys,
                                  None if idx is None else idx + 1)
        return torch.stack([tok0, *tail])

    @torch.no_grad()
    def _decode_block(self, feed, page_table, lengths, caps, sampling, keys,
                      idx):
        """The decode program (reference ``_decode_block_fn``): ``k``
        decode steps; pools updated in place (the reference donates
        them)."""
        return torch.stack(self._decode_steps(feed, page_table, lengths,
                                              caps, self.decode_block,
                                              sampling, keys, idx))

    # ---- request lifecycle --------------------------------------------------
    def _fail_request(self, req, exc):
        req.error = exc
        req.result = None
        req.finished = True
        req.t_done = time.monotonic()
        self.request_errors[req.rid] = exc
        self.stats["failed_requests"] += 1

    def _release_slot(self, slot, pages):
        self._unref_pages(pages)
        self.free_slots.append(slot)
        self.page_table[slot] = 0
        self.lengths[slot] = 0
        if not self._active and not self._prefilling:
            self._active_sampling = None

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

    def try_admit_one(self, req):
        """Non-blocking admission of one EngineRequest: reserve its pages
        (a prefix-cache hit's shared pages first) and install its
        page-table row; the rest of the prompt streams into the pool
        through the mixed dispatches. Returns "admitted", "failed" (the
        request alone fails: too long, or larger than the whole pool) or
        "deferred" (no free slot or pages yet, or the running group samples
        otherwise)."""
        if not self.free_slots:
            return "deferred"
        if ((self._active or self._prefilling)
                and self._active_sampling != req.sampling):
            return "deferred"
        prompt = req.prompt
        true_len = len(prompt)
        bucket = prompt_bucket(true_len)
        if true_len + req.max_new_tokens > self.max_len or bucket > self.max_len:
            self._fail_request(req, ValueError(
                f"request {req.rid}: len {true_len} (bucket {bucket}) + "
                f"{req.max_new_tokens} exceeds max_len={self.max_len}"))
            return "failed"
        bs = self.page_size
        if self.enable_prefix_cache:
            self._refresh_cache_guard()
            n_pre, shared, digests = self._match_prefix(prompt, true_len)
        else:
            n_pre, shared, digests = 0, [], None
        # token-exact reservation: the prompt's pages, or its whole budget.
        # A hit always fits the page-table row: n_pre shared pages plus the
        # ceil((true_len - n_pre * bs) / bs) pages of the rest are the
        # prompt's ceil(true_len / bs) (the reference's shrink loop serves
        # its bucket-rounded ladder and never runs on the ragged path)
        total_need = max(-(-true_len // bs),
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
                return "failed"
            self.stats["deferred_admissions"] += 1
            return "deferred"
        slot = self.free_slots.pop()
        new_pages = self._alloc_pages(total_need - n_pre)
        self._ref_pages(new_pages)
        pages = shared + new_pages
        self.stats["peak_pages"] = max(self.stats["peak_pages"],
                                       self._pages_in_use)
        self.stats["prefix_hit_pages"] += n_pre
        req.pages = pages
        req.slot = slot
        req.t_admit = time.monotonic()
        req.tokens = list(prompt)  # tok0 appended at graduation
        if req.sampling[0] and req.key_base is None:
            req.key_base = int(request_keys(torch.tensor([req.seed]),
                                            torch.tensor([req.rid]))[0])
        row = np.zeros(self.pages_per_seq, np.int32)
        row[:len(pages)] = pages
        self.page_table[slot] = row
        self.lengths[slot] = n_pre * bs
        self._prefilling[slot] = _PrefillState(req, pages, n_pre, digests, bs)
        self._active_sampling = req.sampling
        return "admitted"

    def _admit_from(self, queue):
        """Admit from the head of ``queue`` until one defers (FIFO)."""
        while queue and self.free_slots:
            if self.try_admit_one(queue[0]) == "deferred":
                break
            queue.popleft()

    # ---- stepping -------------------------------------------------------------
    def step(self):
        """One scheduling round: sweep cancellations, advance the dispatch
        pipeline (one mixed or decode dispatch), sweep timeouts. Returns
        the EngineRequests that reached a terminal state."""
        retired = self._pending_retired
        self._pending_retired = []
        for slot in list(self._active):
            if self._active[slot].cancelled:
                retired.append(self._retire(slot))
        for slot in list(self._prefilling):
            if self._prefilling[slot].req.cancelled:
                retired.append(self._abort_prefill(slot))
        if self.async_decode:
            prev = self._inflight
            if prev is not None:
                # enqueue block k+1 BEFORE block k's readback
                self._inflight = self._dispatch_ragged(chain=prev)
                retired.extend(self._process_block(prev))
            if self._inflight is None and (self._active or self._prefilling):
                self._inflight = self._dispatch_ragged()
        elif self._active or self._prefilling:
            rec = self._dispatch_ragged()
            if rec is not None:
                retired.extend(self._process_block(rec))
        now = time.monotonic()
        for slot in list(self._active):
            r = self._active[slot]
            if r.timeout_s is not None and now - r.t_admit > r.timeout_s:
                self.stats["timed_out_requests"] += 1
                r.timed_out = True
                retired.append(self._retire(slot))
        for slot in list(self._prefilling):
            r = self._prefilling[slot].req
            if r.timeout_s is not None and now - r.t_admit > r.timeout_s:
                self.stats["timed_out_requests"] += 1
                retired.append(self._abort_prefill(slot, timed_out=True))
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
        blk = self._ragged_step(
            dev(tok_block),
            dev(np.asarray(chain_pos, np.int64)) if chained else None,
            dev(np.asarray(chain_rows, np.int64)) if chained else None,
            chain.last if chained else None,
            dev(cu), dev(row_of), dev(token_pos), dev(valid),
            dev(b_idx.astype(np.int64)), dev(self.page_table), dev(scan_pt),
            dev(lengths_op), dev(caps), sampling,
            *((dev(keys), dev(idxs)) if sampling[0] else (None, None)))
        rec = self._inflight_block(blk, k, part)
        for slot, st, take, final in sched:
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
        row feeds every slot it covered. None when nothing can dispatch."""
        if not self._active:
            return None
        budgets = [r.max_new_tokens - r.n_dispatched
                   for r in self._active.values()]
        remaining = max(budgets) if self.async_decode else min(budgets)
        if remaining <= 0:
            return None  # every row fully dispatched: read back, retire
        sampling = self._active_sampling
        k = self.decode_block
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
        if chain is None:
            feed = self._to_device(toks)
        elif fresh.any():
            feed = torch.where(self._to_device(fresh), self._to_device(toks),
                               chain.last)
        else:
            feed = chain.last
        dev = self._to_device
        blk = self._decode_block(
            feed, dev(self.page_table), dev(self.lengths), dev(caps), sampling,
            *((dev(keys), dev(idxs)) if sampling[0] else (None, None)))
        rec = self._inflight_block(blk, k, rows)
        for slot, r in rows:
            r.n_dispatched += k
            self.lengths[slot] += k
        return rec

    def _inflight_block(self, blk, k, rows):
        """Start ``blk``'s readback: a non-blocking copy into pinned memory
        and the event that marks it done (waited for at once when
        ``async_decode`` is off; nothing to wait for on the CPU)."""
        last = blk[k - 1][:, None]  # the row the NEXT block chains from
        if blk.device.type == "cpu":
            return _InflightBlock(last, k, rows, blk, None)
        host = torch.empty(blk.shape, dtype=blk.dtype, pin_memory=True)
        host.copy_(blk, non_blocking=True)
        ready = torch.cuda.Event()
        ready.record()
        if not self.async_decode:
            ready.synchronize()
            ready = None
        return _InflightBlock(last, k, rows, host, ready)

    def _process_block(self, rec):
        """The readback point: block tokens reach the host, each request
        emits them, finished ones retire (mid-block EOS discards the rest
        of the block)."""
        if rec.ready is not None:
            rec.ready.synchronize()
        block = rec.host.numpy()
        self.stats["decode_steps"] += rec.k
        retired = []
        for slot, r in rec.rows:
            if r.finished or self._active.get(slot) is not r:
                continue  # retired while in flight: overshoot discarded
            if r.t_first_token is None:
                r.t_first_token = time.monotonic()
            for s in range(rec.k):
                tok = int(block[s, slot])
                r.tokens.append(tok)
                r.n_generated += 1
                r.last_token = tok
                if r.on_token is not None:
                    r.on_token(r.rid, tok)
                if r.n_generated >= r.max_new_tokens or (
                        r.eos_token_id is not None
                        and tok == r.eos_token_id):
                    retired.append(self._retire(slot))
                    break
        return retired

    def drain(self):
        """Finish every admitted request without admitting more; returns the
        retired EngineRequests."""
        out = []
        while (self._active or self._prefilling
               or self._inflight is not None or self._pending_retired):
            out.extend(self.step())
        return out

    def serve(self, prompts, max_new_tokens, eos_token_id=None,
              do_sample=False, temperature=1.0, top_k=0, top_p=1.0, seed=0,
              on_token=None, request_timeout_s=None, sampling_overrides=None,
              adapters=None):
        """Serve a list of int32 prompt arrays; returns a list of
        [len(prompt) + n_generated] arrays (stops at eos or max_new_tokens;
        None for a request that failed alone, its error in
        ``request_errors``). ``max_new_tokens`` is a scalar, a
        per-request list or a complete {rid: n} dict (``_per_request``). Requests beyond the slot or page capacity queue
        and join as earlier ones retire.

        ``do_sample`` with ``temperature``, ``top_k`` and ``top_p`` samples
        (the reference's sampler); request ``rid`` draws token i from the
        noise of (seed, rid, i), so its tokens do not depend on its
        co-tenants. ``sampling_overrides`` and ``adapters`` raise
        NotImplementedError."""
        if sampling_overrides is not None:
            raise NotImplementedError(f"sampling_overrides {_LATER}")
        if adapters is not None:
            raise NotImplementedError(f"LoRA adapters {_LATER}")
        if self._active or self._prefilling or self._inflight is not None:
            raise RuntimeError("serve() on an engine with active requests — "
                               "drain() first")
        sampling = canonical_sampling(do_sample, temperature, top_k, top_p)
        per_new = _per_request(max_new_tokens, len(prompts), "max_new_tokens")
        reqs = [EngineRequest(rid, p, per_new[rid], eos_token_id=eos_token_id,
                              sampling=sampling, seed=seed,
                              timeout_s=request_timeout_s, on_token=on_token)
                for rid, p in enumerate(prompts)]
        if self.enable_prefix_cache:
            self._refresh_cache_guard()
        self.request_errors = {}
        queue = deque(reqs)
        try:
            self._admit_from(queue)
            while (queue or self._active or self._prefilling
                   or self._inflight is not None):
                if not (self._active or self._prefilling
                        or self._inflight is not None):
                    raise AssertionError(
                        "serve(): admission stalled with an idle engine")
                self.step()
                self._admit_from(queue)
            return [r.result for r in reqs]
        finally:
            # a raising on_token (or any failure) must not leak pages/slots
            self._inflight = None
            for slot in list(self._active):
                self._retire(slot)
            for slot in list(self._prefilling):
                self._abort_prefill(slot)
