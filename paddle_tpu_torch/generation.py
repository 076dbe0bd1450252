"""Sampling for generation (counterpart of ``paddle_tpu/generation.py``'s
``prompt_bucket`` and ``_make_sampler``; the dense, speculative and beam
generate paths come in a later slice of the port).

The reference draws a token with ``jax.random.categorical(key, logits)``,
which is ``argmax(logits + gumbel(key))``. The port's sampler takes the
Gumbel noise as an argument instead of a key, so a caller that feeds the
same noise gets the same tokens. ``gumbel_noise`` makes that noise without
a generator: each (seed, request, token index, vocab id) is hashed to 32
bits with int64 tensor operations, mapped to a uniform in (0, 1), then to
``-log(-log(u))``. The uniforms are the same bits on the CPU and on the
card, and a request's draws depend on nothing but its own counters.
"""
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
