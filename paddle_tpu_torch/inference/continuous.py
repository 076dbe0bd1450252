"""Continuous-batching serving engine over the paged KV pool, ragged mode
(counterpart of ``paddle_tpu/inference/continuous.py``, its ``ragged=True``
path with greedy decoding).

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

Left out of this slice, and raising when asked for: sampling, the int8 KV
pool, the prefix cache, LoRA adapters, ``ragged=False``, page export and
adoption, tracing, chaos sites, device profiling and the compile ledger.
"""
import time
from collections import deque

import numpy as np
import torch

from ..device import resolve
from ..ops.paged_attention import PagedLayerCache
from ..ops.ragged_paged_attention import RaggedLayerCache

_LATER = "comes in a later slice of the port (see ROADMAP.md)"
_MIN_BUCKET = 16


def prompt_bucket(s0):
    """Smallest power-of-two bucket >= s0 (floor 16) — the reference's
    admission limit: a prompt whose bucket exceeds max_len is refused."""
    b = _MIN_BUCKET
    while b < s0:
        b *= 2
    return b


class EngineRequest:
    """One request's lifecycle state. Once ``finished``, exactly one of
    ``result`` (np.int32: prompt + generated tokens) or ``error`` is set;
    a ``timed_out`` request retires with a partial result."""

    __slots__ = ("rid", "prompt", "max_new_tokens", "eos_token_id",
                 "timeout_s", "on_token", "tokens", "n_generated",
                 "n_dispatched", "last_token", "pages", "slot", "t_enqueue",
                 "t_admit", "t_first_token", "t_done", "error", "result",
                 "finished", "timed_out", "cancelled")

    def __init__(self, rid, prompt, max_new_tokens, eos_token_id=None,
                 timeout_s=None, on_token=None):
        self.rid = int(rid)
        self.prompt = np.asarray(prompt, np.int32).reshape(-1)
        self.max_new_tokens = int(max_new_tokens)
        if self.max_new_tokens < 1:
            raise ValueError(
                f"request {self.rid}: max_new_tokens must be >= 1, got "
                f"{self.max_new_tokens}")
        self.eos_token_id = eos_token_id
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
    """One slot mid-prefill: its page reservation and how many prompt
    tokens already sit in the pool."""

    __slots__ = ("req", "pages", "consumed")

    def __init__(self, req, pages):
        self.req = req
        self.pages = pages
        self.consumed = 0


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
    """Ragged continuous-batching engine, greedy decoding.

    ``model`` is a ``models.llama.LlamaForCausalLM`` that lives on
    ``device`` (default "cuda"; raises when CUDA is missing unless
    device="cpu")."""

    def __init__(self, model, max_seqs=4, page_size=16, num_pages=None,
                 max_len=512, kv_cache_dtype=None, decode_block=8,
                 enable_prefix_cache=False, prefill_chunk=None,
                 async_decode=True, ragged=True, device="cuda"):
        dev = resolve(device)
        if kv_cache_dtype not in (None, "model"):
            raise NotImplementedError(
                f"kv_cache_dtype={kv_cache_dtype!r} {_LATER}")
        if enable_prefix_cache:
            raise NotImplementedError(f"the prefix cache {_LATER}")
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
        self.pools = [
            (torch.zeros(shape, dtype=param.dtype, device=self.device),
             torch.zeros(shape, dtype=param.dtype, device=self.device))
            for _ in range(cfg.num_hidden_layers)]
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
                      "decode_steps": 0, "failed_requests": 0,
                      "timed_out_requests": 0}
        self.request_errors = {}
        self._active = {}         # slot -> EngineRequest (decoding)
        self._prefilling = {}     # slot -> _PrefillState
        self._inflight = None     # the ONE in-flight _InflightBlock
        self._pending_retired = []

    # ---- page allocator ---------------------------------------------------
    def _alloc_pages(self, n):
        out = [self.free_pages.pop() for _ in range(n)]
        in_use = self.num_pages - 1 - len(self.free_pages)
        self.stats["peak_pages"] = max(self.stats["peak_pages"], in_use)
        return out

    def _free_pages(self, pages):
        self.free_pages.extend(pages)

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
    def _decode_steps(self, toks, page_table, lengths, caps, n):
        """``n`` greedy decode steps over every slot through the paged
        caches (the reference's ``lax.scan`` body). A row's write position
        freezes at its cap (caps 0 park empty rows on the scratch page).
        Returns the [n] list of [max_seqs] int32 token rows."""
        out = []
        for _ in range(n):
            lengths_e = torch.minimum(lengths, caps)
            caches = [PagedLayerCache(kp, vp, page_table, lengths_e)
                      for kp, vp in self.pools]
            logits, _ = self.model(toks, position_ids=lengths_e[:, None],
                                   past_key_values=caches)
            nxt = logits[:, -1].float().argmax(dim=-1).to(torch.int32)
            out.append(nxt)
            toks = nxt[:, None]
            lengths = lengths_e + 1
        return out

    @torch.no_grad()
    def _ragged_step(self, tok_block, chain_pos, chain_rows, last, cu, row_of,
                     token_pos, valid, b_idx, page_table, scan_table,
                     lengths, caps):
        """The mixed program (reference ``_ragged_fn``): one packed pass
        through the ragged caches, each participant's first token from its
        last packed token (``b_idx``), then ``k - 1`` decode steps over
        ``scan_table`` (non-participants routed to the scratch page).
        Rows chained off an in-flight block take their feed token from its
        device-resident ``last`` row at packed positions ``chain_pos``.
        The pools are updated in place (the reference donates them)."""
        if chain_pos is not None:
            tok_block[chain_pos] = last[chain_rows, 0]
        kv_lens = lengths + (cu[1:] - cu[:-1])  # post-write totals
        caches = [RaggedLayerCache(kp, vp, page_table, kv_lens, cu, row_of,
                                   token_pos, valid)
                  for kp, vp in self.pools]
        h, _ = self.model.llama(tok_block[None],
                                position_ids=token_pos[None],
                                past_key_values=caches)
        tok0 = self.model.head(h[0, b_idx]).float().argmax(dim=-1)
        tok0 = tok0.to(torch.int32)
        tail = self._decode_steps(tok0[:, None], scan_table, kv_lens, caps,
                                  self.decode_block - 1)
        return torch.stack([tok0, *tail])

    @torch.no_grad()
    def _decode_block(self, feed, page_table, lengths, caps):
        """The decode program (reference ``_decode_block_fn``): ``k``
        decode steps; pools updated in place (the reference donates
        them)."""
        return torch.stack(self._decode_steps(feed, page_table, lengths,
                                              caps, self.decode_block))

    # ---- request lifecycle --------------------------------------------------
    def _fail_request(self, req, exc):
        req.error = exc
        req.result = None
        req.finished = True
        req.t_done = time.monotonic()
        self.request_errors[req.rid] = exc
        self.stats["failed_requests"] += 1

    def _retire(self, slot):
        req = self._active.pop(slot)
        req.result = np.asarray(req.tokens, np.int32)
        req.finished = True
        req.t_done = time.monotonic()
        self._free_pages(req.pages)
        self.free_slots.append(slot)
        self.page_table[slot] = 0
        self.lengths[slot] = 0
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
        self._free_pages(st.pages)
        self.free_slots.append(slot)
        self.page_table[slot] = 0
        self.lengths[slot] = 0
        return req

    def try_admit_one(self, req):
        """Non-blocking admission of one EngineRequest: reserve its pages
        and install its page-table row; the prompt streams into the pool
        through the mixed dispatches. Returns "admitted", "failed" (the
        request alone fails: too long, or larger than the whole pool) or
        "deferred" (no free slot or pages yet)."""
        if not self.free_slots:
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
        # token-exact reservation: the prompt's pages, or its whole budget
        total_need = max(-(-true_len // bs),
                         -(-(true_len + req.max_new_tokens) // bs))
        if total_need > len(self.free_pages):
            if not self._active and not self._prefilling:
                self._fail_request(req, RuntimeError(
                    f"request {req.rid} needs more pages than the pool holds "
                    f"({true_len}+{req.max_new_tokens} tokens vs "
                    f"{(self.num_pages - 1) * bs} pool tokens)"))
                return "failed"
            self.stats["deferred_admissions"] += 1
            return "deferred"
        slot = self.free_slots.pop()
        pages = self._alloc_pages(total_need)
        req.pages = pages
        req.slot = slot
        req.t_admit = time.monotonic()
        req.tokens = list(prompt)  # tok0 appended at graduation
        row = np.zeros(self.pages_per_seq, np.int32)
        row[:len(pages)] = pages
        self.page_table[slot] = row
        self.lengths[slot] = 0
        self._prefilling[slot] = _PrefillState(req, pages)
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
            dev(lengths_op), dev(caps))
        rec = self._inflight_block(blk, k, part)
        for slot, st, take, final in sched:
            st.consumed += take
            self.lengths[slot] += take
        for slot, st in grads:
            # graduation at DISPATCH: the packed pass sampled tok0 and the
            # scan is already decoding this row
            del self._prefilling[slot]
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
        k = self.decode_block
        rows = list(self._active.items())
        covered = self._covered(chain)
        S = self.max_seqs
        toks = np.zeros((S, 1), np.int32)
        fresh = np.zeros((S, 1), bool)
        caps = np.zeros(S, np.int32)  # empty slots freeze at 0
        for slot, r in rows:
            caps[slot] = len(r.prompt) + r.max_new_tokens - 1
            if slot not in covered:
                toks[slot, 0] = r.last_token
                fresh[slot, 0] = True
        if chain is None:
            feed = self._to_device(toks)
        elif fresh.any():
            feed = torch.where(self._to_device(fresh), self._to_device(toks),
                               chain.last)
        else:
            feed = chain.last
        blk = self._decode_block(feed, self._to_device(self.page_table),
                                 self._to_device(self.lengths),
                                 self._to_device(caps))
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
              do_sample=False, on_token=None, request_timeout_s=None):
        """Serve a list of int32 prompt arrays greedily; returns a list of
        [len(prompt) + n_generated] arrays (stops at eos or max_new_tokens;
        None for a request that failed alone, its error in
        ``request_errors``). ``max_new_tokens`` is a scalar or a
        per-request list. Requests beyond the slot or page capacity queue
        and join as earlier ones retire."""
        if do_sample:
            raise NotImplementedError(f"sampling {_LATER}")
        if self._active or self._prefilling or self._inflight is not None:
            raise RuntimeError("serve() on an engine with active requests — "
                               "drain() first")
        per_new = (list(max_new_tokens)
                   if isinstance(max_new_tokens, (list, tuple, np.ndarray))
                   else [max_new_tokens] * len(prompts))
        if len(per_new) != len(prompts):
            raise ValueError(f"per-request max_new_tokens has {len(per_new)} "
                             f"entries for {len(prompts)} requests")
        reqs = [EngineRequest(rid, p, per_new[rid], eos_token_id=eos_token_id,
                              timeout_s=request_timeout_s, on_token=on_token)
                for rid, p in enumerate(prompts)]
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
