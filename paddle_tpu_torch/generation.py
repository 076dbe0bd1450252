"""Autoregressive generation on the dense caches (counterpart of
``paddle_tpu/generation.py``): the sampler, ``prompt_bucket``, and
``GenerationMixin`` with ``generate`` (greedy or sampled, a right-padded
prompt or an ``attention_mask`` batch), ``generate_speculative`` and beam
search.

The reference compiles each path into one program (a ``lax.scan`` or
``lax.while_loop`` over fixed-shape caches); the port runs the same steps
as an eager loop on the caches' device: the prompt is right-padded to its
``prompt_bucket`` and prefilled into fixed-shape caches (``init_cache``)
by one forward, then each step writes one token's K/V at its position and
attends under the absolute-position mask (``models.llama.cache_mask``).
Every decision a step makes (eos, pad, acceptance, the beams' order) stays
on the device; only the speculative loop reads two numbers a round (how
far the batch advances, whether every row is done), where the reference's
``while_loop`` reads its condition.

The reference draws a token with ``jax.random.categorical(key, logits)``,
which is ``argmax(logits + gumbel(key))``. The port's sampler takes the
Gumbel noise as an argument instead of a key, so a caller that feeds the
same noise gets the same tokens. ``gumbel_noise`` makes that noise without
a generator: each (seed, request, token index, vocab id) is hashed to 32
bits with int64 tensor operations, mapped to a uniform in (0, 1), then to
``-log(-log(u))``. The uniforms are the same bits on the CPU and on the
card, and a request's draws depend on nothing but its own counters.
``generate`` keys its draws by (seed, row, token index) (``_draw_noise``).
"""
import numpy as np
import torch

from .device import constant

_MIN_BUCKET = 16
_M32 = 0xFFFFFFFF
_MIX = 0x45D9F3B        # multiplier of the 32-bit mixer (< 2**31)
_GOLDEN = 0x61C88647    # 2**32 - 0x9E3779B9 (< 2**31)


def prompt_bucket(s0):
    """Smallest power-of-two bucket >= s0 (floor 16)."""
    b = _MIN_BUCKET
    while b < s0:
        b *= 2
    return b


def _mix32(x):
    """A 32-bit integer mixer on int64 tensors holding values < 2**32:
    every product is of a 32-bit value and a constant below 2**31, masked
    back to 32 bits, so none overflows int64."""
    x = x ^ (x >> 16)
    x = (x * _MIX) & _M32
    x = x ^ (x >> 16)
    x = (x * _MIX) & _M32
    return x ^ (x >> 16)


def request_keys(seeds, rids):
    """Per-request 32-bit key, the port's form of the reference's
    ``fold_in(PRNGKey(seed), rid)``: int64 tensors [S] -> int64 [S]."""
    return _mix32(_mix32(seeds.long() & _M32) ^ (rids.long() & _M32))


def gumbel_noise(keys, token_idx, vocab_size):
    """Gumbel noise [S, vocab_size] (f32) for each row's request key and
    token index (int64 [S]), the port's form of
    ``gumbel(fold_in(key_base, token_idx), [vocab])``."""
    step = _mix32(keys ^ (token_idx.long() & _M32))
    v = torch.arange(vocab_size, dtype=torch.int64, device=keys.device)
    bits = _mix32((step[:, None] + v[None, :] * _GOLDEN) & _M32)
    # 23 bits -> (2k + 1) / 2**24: exact in f32, strictly inside (0, 1)
    u = ((bits >> 9) * 2 + 1).double() * 2.0 ** -24
    return (-torch.log(-torch.log(u))).float()


def _make_sampler(do_sample, temperature, top_k, top_p, repetition_penalty,
                  min_length, eos_token_id):
    """ONE sampling fn (greedy / temperature / top-k / top-p, CTRL-style
    repetition penalty over the seen-token mask, eos suppression below
    min_length), the reference's arithmetic step for step. ``noise`` is
    the Gumbel noise of the draw, logits' shape (unused when greedy)."""

    def sample(logits, noise, seen=None, n_generated=0):
        logits = logits.float()
        if repetition_penalty != 1.0 and seen is not None:
            pen = torch.where(logits > 0,
                              logits / constant(repetition_penalty, logits),
                              logits * repetition_penalty)
            logits = torch.where(seen, pen, logits)
        if min_length > 0 and eos_token_id is not None:
            vocab = torch.arange(logits.shape[-1], device=logits.device)
            below = torch.as_tensor(n_generated, device=logits.device)
            logits = torch.where(
                (below < min_length) & (vocab == eos_token_id)[None],
                -torch.inf, logits)
        if not do_sample:
            return logits.argmax(dim=-1).to(torch.int32)
        # a true division (a Python-number divisor is a reciprocal-
        # multiply on CUDA)
        logits = logits / constant(max(temperature, 1e-6), logits)
        if top_k and top_k > 0:
            kth = logits.sort(dim=-1).values[..., -top_k][..., None]
            logits = torch.where(logits < kth, -torch.inf, logits)
        if top_p < 1.0:
            # nucleus: smallest prefix of the sorted distribution reaching
            # top_p mass (the argmax token is always kept); the cut is by
            # value, so ties at the cutoff stay
            srt = logits.sort(dim=-1, descending=True).values
            probs = torch.softmax(srt, dim=-1)
            cum = probs.cumsum(dim=-1)
            keep = cum - probs < top_p
            kth_idx = keep.sum(dim=-1) - 1
            cutoff = srt.gather(-1, kth_idx[..., None])
            logits = torch.where(logits < cutoff, -torch.inf, logits)
        return (noise.to(logits.device) + logits).argmax(dim=-1).to(
            torch.int32)

    return sample


def _draw_noise(seed, rows, index, vocab, device):
    """Gumbel noise [rows, vocab] of draw ``index`` (0: the first token)
    of a sampled ``generate``: ``gumbel_noise`` keyed by (seed, row)."""
    keys = request_keys(torch.full((rows,), seed, dtype=torch.int64),
                        torch.arange(rows, dtype=torch.int64))
    return gumbel_noise(keys.to(device),
                        torch.full((rows,), index, dtype=torch.int64,
                                   device=device), vocab)


def _prompt_seen_mask(ids, valid, n_vocab):
    """[B, V] bool: the tokens present at the ``valid`` prompt positions
    (reference :82)."""
    seen = torch.zeros(ids.shape[0], n_vocab, dtype=torch.int32,
                       device=ids.device)
    return seen.scatter_add_(1, ids.long(), valid.to(torch.int32)) > 0


def _mark_seen(seen, tok):
    """``seen`` with each row's token ``tok`` marked (reference :90)."""
    if seen is not None:
        seen[torch.arange(seen.shape[0], device=seen.device),
             tok.long()] = True
    return seen


def _top_k(x, k):
    """(values, indices) of the k largest along the last dim, ties to the
    lower index first, as ``jax.lax.top_k`` breaks them (``torch.topk``
    promises no order among ties): a stable descending sort."""
    values, indices = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]


class GenerationMixin:
    """Generation for a causal LM whose ``forward(input_ids,
    past_key_values=..., cache_position=..., use_cache=True, ...)`` returns
    (logits, caches) over dense per-layer (k, v) caches, and which has a
    ``config`` (num_hidden_layers, num_key_value_heads, head_dim).
    Inputs are numpy arrays or tensors of token ids; outputs are int32
    tensors on the model's device, the prompt included."""

    def _generation_device(self):
        for t in self.parameters():
            return t.device
        for t in self.buffers():
            return t.device
        raise ValueError("generate: the model has no parameters")

    def init_cache(self, batch_size, max_length, dtype=None):
        """One zero (k, v) pair [batch_size, max_length, Hkv, D] per layer
        (reference :99), in ``dtype`` (default: the LM head's weight dtype,
        else the first parameter's), on the model's device."""
        cfg = self.config
        if dtype is None:
            head = getattr(self, "lm_head", None)
            dtype = (head.weight.dtype if head is not None
                     else next(iter(self.parameters())).dtype)
        if isinstance(dtype, str):
            dtype = getattr(torch, dtype)
        shape = (batch_size, max_length, cfg.num_key_value_heads,
                 cfg.head_dim)
        dev = self._generation_device()
        return tuple((torch.zeros(shape, dtype=dtype, device=dev),
                      torch.zeros(shape, dtype=dtype, device=dev))
                     for _ in range(cfg.num_hidden_layers))

    def _ids(self, input_ids):
        return torch.as_tensor(np.asarray(input_ids) if not isinstance(
            input_ids, torch.Tensor) else input_ids).to(
                self._generation_device(), torch.int32)

    def _fwd(self, toks, caches, pos, **kw):
        logits, _ = self(toks, past_key_values=caches, cache_position=pos,
                         use_cache=True, **kw)
        return logits

    @torch.no_grad()
    def generate(self, input_ids, max_new_tokens=32, do_sample=False,
                 temperature=1.0, top_k=0, top_p=1.0, repetition_penalty=1.0,
                 min_length=0, eos_token_id=None, pad_token_id=None, seed=0,
                 decode_strategy=None, num_beams=1, length_penalty=0.0,
                 attention_mask=None):
        """[B, S0 + max_new_tokens] int32 token ids, prompt included
        (reference :117). After eos a row emits ``pad_token_id`` (default
        eos, else 0). ``decode_strategy``: "greedy_search" (default),
        "sampling" (as ``do_sample=True``) or "beam_search" (``num_beams``
        >= 2, GNMT ``length_penalty``). ``attention_mask`` [B, S0] (1 keep,
        0 pad, pads on either side) takes ``_generate_ragged``."""
        if decode_strategy is None:
            decode_strategy = "sampling" if do_sample else (
                "beam_search" if num_beams > 1 else "greedy_search")
        if decode_strategy == "sampling":
            do_sample = True
        if decode_strategy == "beam_search":
            if num_beams < 2:
                raise ValueError("beam_search needs num_beams >= 2")
            return self._generate_beam(input_ids, max_new_tokens, num_beams,
                                       length_penalty, eos_token_id,
                                       pad_token_id)
        if attention_mask is not None:
            return self._generate_ragged(
                input_ids, attention_mask, max_new_tokens, do_sample,
                temperature, top_k, top_p, repetition_penalty, min_length,
                eos_token_id, pad_token_id, seed)
        ids = self._ids(input_ids)
        B, S0 = ids.shape
        if pad_token_id is None:
            pad_token_id = eos_token_id if eos_token_id is not None else 0
        S0b = prompt_bucket(S0)
        caches = self.init_cache(B, S0b + max_new_tokens)
        ids_p = torch.nn.functional.pad(ids, (0, S0b - S0),
                                        value=pad_token_id)
        logits = self._fwd(ids_p, caches, 0)
        valid = (torch.arange(S0b, device=ids.device) < S0)[None].expand(B, -1)
        gen = self._decode(caches, logits[:, S0 - 1], ids_p, valid, S0,
                           max_new_tokens, do_sample, temperature, top_k,
                           top_p, repetition_penalty, min_length,
                           eos_token_id, pad_token_id, seed)
        return torch.cat([ids, gen], dim=1)

    def _decode(self, caches, last, ids, valid, pos, max_new, do_sample,
                temperature, top_k, top_p, repetition_penalty, min_length,
                eos_token_id, pad_token_id, seed, step_kw=None):
        """The decode loop of ``generate`` and ``_generate_ragged``
        (reference :526-559, :231-267) after the prefill: the first token
        from ``last`` [B, V], then one forward a token at cache position
        ``pos``, ``pos + 1``, ... Returns [B, max_new] int32. ``step_kw``
        maps a cache position to the forward's extra arguments."""
        B, V = last.shape
        dev = last.device
        sample = _make_sampler(do_sample, temperature, top_k, top_p,
                               repetition_penalty, min_length, eos_token_id)
        seen = (_prompt_seen_mask(ids, valid, V)
                if repetition_penalty != 1.0 else None)

        def draw(logits, i):
            noise = (_draw_noise(seed, B, i, V, dev) if do_sample
                     else None)
            return sample(logits, noise, seen, i)

        tok = draw(last, 0)
        seen = _mark_seen(seen, tok)
        done = (tok == eos_token_id if eos_token_id is not None
                else torch.zeros(B, dtype=torch.bool, device=dev))
        out = [tok]
        pad = torch.full((), pad_token_id, dtype=torch.int32, device=dev)
        for i in range(1, max_new):
            kw = step_kw(pos) if step_kw is not None else {}
            lg = self._fwd(tok[:, None], caches, pos, **kw)
            n = torch.where(done, pad, draw(lg[:, -1], i))
            if eos_token_id is not None:
                done = done | (n == eos_token_id)
            seen = _mark_seen(seen, n)
            out.append(n)
            tok, pos = n, pos + 1
        return torch.stack(out, dim=1)

    def _generate_ragged(self, input_ids, attention_mask, max_new_tokens,
                         do_sample, temperature, top_k, top_p,
                         repetition_penalty, min_length, eos_token_id,
                         pad_token_id, seed):
        """Per-row prompt lengths in one batch (reference :172, :216). The
        batch is LEFT-aligned: every row's last real token lands in column
        S0b - 1, rows keep their own rope positions (the pad offset
        subtracted), and the left-pad cache columns are masked at every
        step."""
        ids = np.asarray(input_ids.cpu() if isinstance(
            input_ids, torch.Tensor) else input_ids).astype(np.int32)
        mask = np.asarray(attention_mask.cpu() if isinstance(
            attention_mask, torch.Tensor) else attention_mask).astype(np.int32)
        B, S0 = ids.shape
        if pad_token_id is None:
            pad_token_id = eos_token_id if eos_token_id is not None else 0
        lens = mask.sum(axis=1).astype(np.int32)
        S0b = prompt_bucket(int(lens.max()))
        aligned = np.full((B, S0b), pad_token_id, np.int32)
        for r in range(B):
            # gather by mask, not prefix-slice: callers pad on either side
            aligned[r, S0b - lens[r]:] = ids[r][mask[r].astype(bool)]
        dev = self._generation_device()
        pad_lens = torch.as_tensor(S0b - lens, device=dev)
        total = S0b + max_new_tokens
        caches = self.init_cache(B, total)
        amask = (torch.arange(total, device=dev)[None, :]
                 >= pad_lens[:, None]).float()
        cols = torch.arange(S0b, device=dev)[None, :]
        pos_prefill = torch.clamp_min(cols - pad_lens[:, None], 0)
        toks = torch.as_tensor(aligned, device=dev)
        logits = self._fwd(toks, caches, 0, attention_mask=amask,
                           position_ids=pos_prefill)
        gen = self._decode(
            caches, logits[:, -1], toks, cols >= pad_lens[:, None], S0b,
            max_new_tokens, do_sample, temperature, top_k, top_p,
            repetition_penalty, min_length, eos_token_id, pad_token_id, seed,
            step_kw=lambda pos: dict(attention_mask=amask,
                                     position_ids=(pos - pad_lens)[:, None]))
        return torch.cat([torch.as_tensor(ids, device=dev), gen], dim=1)

    @torch.no_grad()
    def generate_speculative(self, input_ids, draft_model, max_new_tokens=32,
                             gamma=4, eos_token_id=None, pad_token_id=None):
        """Speculative greedy decoding (reference :271, :311): the draft
        proposes ``gamma`` tokens one at a time, the target verifies them
        in one forward, and each row accepts its agreeing prefix plus the
        target's own next token, up to its first eos; the batch advances by
        the least acceptance of its unfinished rows. The output is the
        target's greedy continuation. Caches hold gamma + 1 positions of
        headroom; the rounds run as a host loop reading (advance, all
        done) once a round. Returns [B, S0 + max_new_tokens] ids."""
        ids = self._ids(input_ids)
        B, S0 = ids.shape
        dev = ids.device
        if pad_token_id is None:
            pad_token_id = eos_token_id if eos_token_id is not None else 0
        S0b = prompt_bucket(S0)
        total = S0b + max_new_tokens + gamma + 1
        t_caches = self.init_cache(B, total)
        d_caches = draft_model.init_cache(B, total)
        ids_p = torch.nn.functional.pad(ids, (0, S0b - S0),
                                        value=pad_token_id)
        t_logits = self._fwd(ids_p, t_caches, 0)
        draft_model._fwd(ids_p, d_caches, 0)
        first = t_logits[:, S0 - 1].float().argmax(-1).to(torch.int32)
        pad = torch.full((), pad_token_id, dtype=torch.int32, device=dev)
        out = torch.full((B, max_new_tokens + gamma + 1), pad_token_id,
                         dtype=torch.int32, device=dev)
        out[:, 0] = first
        done = (first == eos_token_id if eos_token_id is not None
                else torch.zeros(B, dtype=torch.bool, device=dev))
        idx = torch.arange(gamma, device=dev)[None, :]
        n_gen, all_done = 1, bool(done.all())
        while n_gen < max_new_tokens and not all_done:
            pos = S0 + n_gen - 1
            cur = out[:, n_gen - 1]
            tok, proposals = cur, []
            for i in range(gamma):
                lg = draft_model._fwd(tok[:, None], d_caches, pos + i)
                tok = lg[:, -1].float().argmax(-1).to(torch.int32)
                proposals.append(tok)
            proposals = torch.stack(proposals, dim=1)          # [B, gamma]
            block = torch.cat([cur[:, None], proposals[:, :-1]], dim=1)
            t_lg = self._fwd(block, t_caches, pos)
            choice = t_lg.float().argmax(-1).to(torch.int32)   # [B, gamma]
            agree = choice[:, :-1] == proposals[:, :-1]
            n_acc = torch.cat([torch.ones(B, 1, dtype=torch.bool,
                                          device=dev), agree], dim=1)
            n_acc = n_acc.long().cumprod(dim=1).sum(dim=1)
            last = choice.gather(1, (n_acc - 1)[:, None])
            round_toks = torch.where(idx < (n_acc - 1)[:, None], proposals,
                                     last)
            round_toks = torch.where(done[:, None], pad, round_toks)
            if eos_token_id is not None:
                hit = (round_toks == eos_token_id) & (idx < n_acc[:, None])
                eos_pos = torch.where(hit.any(1), hit.int().argmax(1),
                                      gamma)
                n_acc = torch.minimum(n_acc, eos_pos + 1)
                done = done | hit.any(1)
            # a row emits pad past its own acceptance
            round_toks = torch.where(idx < n_acc[:, None], round_toks, pad)
            step_n = torch.clamp_min(
                torch.where(done, gamma, n_acc).min(), 1)
            window = out[:, n_gen:n_gen + gamma]
            out[:, n_gen:n_gen + gamma] = torch.where(idx < step_n,
                                                      round_toks, window)
            step_n, all_done = torch.stack(
                [step_n, done.all().long()]).tolist()
            n_gen += step_n
        return torch.cat([ids, out[:, :max_new_tokens]], dim=1)

    def _generate_beam(self, input_ids, max_new_tokens, num_beams,
                       length_penalty, eos_token_id, pad_token_id):
        """Beam search of fixed width K (reference :401, :426): one prefill
        on [B], the caches repeated to B * K beam rows, then each step
        takes the top K of the [B, K * V] joint scores (ties to the lower
        index) and reorders the caches' rows by ``index_select``. A
        finished beam continues only with pad, at no cost; the best beam
        wins by its score over the GNMT length penalty ((5 + L) / 6) **
        ``length_penalty``."""
        ids = self._ids(input_ids)
        B, S0 = ids.shape
        K = num_beams
        dev = ids.device
        if pad_token_id is None:
            pad_token_id = eos_token_id if eos_token_id is not None else 0
        S0b = prompt_bucket(S0)
        caches = self.init_cache(B, S0b + max_new_tokens)
        ids_p = torch.nn.functional.pad(ids, (0, S0b - S0),
                                        value=pad_token_id)
        logits = self._fwd(ids_p, caches, 0)
        logp = torch.log_softmax(logits[:, S0 - 1].float(), dim=-1)
        V = logp.shape[-1]
        scores, tok0 = _top_k(logp, K)                          # [B, K]
        caches = [(k.repeat_interleave(K, dim=0),
                   v.repeat_interleave(K, dim=0)) for k, v in caches]
        toks = torch.full((B, K, max_new_tokens), pad_token_id,
                          dtype=torch.int32, device=dev)
        toks[:, :, 0] = tok0.to(torch.int32)
        done = (tok0 == eos_token_id if eos_token_id is not None
                else torch.zeros(B, K, dtype=torch.bool, device=dev))
        # finished beams: only pad continues, at zero cost
        pad_only = torch.full((V,), -1e9, device=dev)
        pad_only[pad_token_id] = 0.0
        rows = torch.arange(B, device=dev)[:, None] * K
        for t in range(1, max_new_tokens):
            cur = toks[:, :, t - 1].reshape(B * K, 1)
            lg = self._fwd(cur, caches, S0 + t - 1)
            logp = torch.log_softmax(lg[:, -1].float(), dim=-1).reshape(
                B, K, V)
            logp = torch.where(done[:, :, None], pad_only, logp)
            joint = scores[:, :, None] + logp
            scores, top_i = _top_k(joint.reshape(B, K * V), K)
            src = top_i // V
            new_tok = (top_i % V).to(torch.int32)
            flat = (rows + src).reshape(-1)
            caches = [(k.index_select(0, flat), v.index_select(0, flat))
                      for k, v in caches]
            toks = toks.gather(1, src[:, :, None].expand(-1, -1,
                                                          max_new_tokens))
            toks[:, :, t] = new_tok
            done = done.gather(1, src)
            if eos_token_id is not None:
                done = done | (new_tok == eos_token_id)
        if eos_token_id is not None:
            first_eos = (toks == eos_token_id).int().argmax(dim=2) + 1
            lengths = torch.where(done, first_eos, max_new_tokens)
        else:
            lengths = torch.full((B, K), max_new_tokens, device=dev)
        final = scores
        if length_penalty:
            norm = ((5.0 + lengths.float()) / constant(6.0, scores)) ** \
                length_penalty
            final = scores / norm
        best = final.argmax(dim=1)
        return torch.cat([ids, toks[torch.arange(B, device=dev), best]],
                         dim=1)
