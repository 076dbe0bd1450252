"""KV-page handoff between disaggregated prefill and decode replicas (the
port's own copy of ``paddle_tpu/serving/handoff.py``).

Disaggregated serving (docs/SERVING.md "Disaggregated prefill/decode")
splits the fleet into a prefill pool and a decode pool so one long
prefill can never head-of-line-block interactive decode. The seam
between the pools is this module: after a prefill replica produces a
request's first token, it exports the request's KV pages and publishes
them as a **handoff bundle**; a decode replica adopts the pages into its
own pool and continues decoding bit-identically (the sampled key stream
depends only on (seed, rid, index), and the bundle carries the exact
sampling state, generated tokens, and dispatch count).

Robustness contract (the reason this file exists):

1. **Atomic.** Bundles are written with the checkpoint tree's
   temp+fsync+rename discipline (:func:`...checkpoint.atomic.atomic_write`
   — the ckpt-atomic-write lint covers this package too), so a writer
   killed at any instruction leaves either nothing or a fully committed
   file — never a torn bundle under the real name.
2. **Validated.** The frame carries a blake2b digest over the payload
   plus the prefill engine's chained per-page prompt digests. A torn, truncated, or bit-flipped bundle raises
   a typed :class:`HandoffCorruptError` at adopt — the frontend answers
   with a clean re-prefill. The payload itself is the non-executable
   :mod:`.wireformat` encoding (bundles cross an unauthenticated wire
   under ``PADDLE_KV_TRANSPORT=wire``, so the decoder must not be able
   to express code — see wireformat's trust-model notes). A corrupt or
   hostile bundle can cost latency, never a wrong token.
3. **Fenced.** Every (re-)prefill of a request bumps its handoff
   generation; the bundle stamps the generation it was built under, and
   the adopter rejects mismatches with :class:`StaleHandoffError` — a
   superseded prefill replica's late bundle can never clobber the retry
   that replaced it.
4. **Bounded.** Publish retries under a deadline with exponential
   backoff; past the deadline the caller falls back to blended mode
   (the prefill replica finishes the request itself), so handoff is
   only ever a perf win, never an availability loss.

Chaos seams: ``serving.handoff.send`` (per publish attempt),
``serving.handoff.adopt`` (per adopt attempt), ``serving.handoff.corrupt``
(between fsync and rename — a ``truncate`` rule here commits a torn file
the digest gate must catch). See docs/CHAOS.md.
"""
import hashlib
import os
import struct
import tempfile
import time

from ..distributed.checkpoint.atomic import atomic_write
from ..observability.metrics import registry as _registry
from ..testing import chaos
from ..utils.envs import env_float, env_int, env_str
from . import wireformat

__all__ = ["HandoffError", "HandoffCorruptError", "StaleHandoffError",
           "HandoffBundle", "HandoffManager", "page_digests"]

#: frame magic ("paddle_tpu handoff v1") — a loader pointed at a foreign
#: file fails the cheap prefix check before touching the decoder
_MAGIC = b"PTHO1\n"
_LEN = struct.Struct(">Q")
_DIGEST_SIZE = 16

_M_PUBLISHED = _registry.counter("serving.handoff.published")
_M_ADOPTED = _registry.counter("serving.handoff.adopted")
_M_CORRUPT = _registry.counter("serving.handoff.corrupt")
_M_STALE = _registry.counter("serving.handoff.stale")
_M_SEND_RETRIES = _registry.counter("serving.handoff.send_retries")
_M_TRANSFER = _registry.histogram("serving.handoff.transfer_s")


class HandoffError(ConnectionError):
    """Base for handoff failures. Subclasses ConnectionError so transport
    retry filters (and chaos's FaultInjected) compose with the same except
    clauses; the frontend's answer to any of these is degradation, not a
    user-visible failure."""


class HandoffCorruptError(HandoffError):
    """Bundle failed validation (torn frame, digest mismatch, or prompt
    page-digest chain mismatch). The adopter must discard it and the
    request must re-prefill — adopting would risk a wrong token."""


class StaleHandoffError(HandoffError):
    """Bundle's generation does not match the request's current handoff
    generation: a superseded prefill attempt published late. Dropped on
    the floor; the live attempt's bundle (or blended completion) wins."""


def page_digests(prompt, page_size, n_pages):
    """Chained blake2b digests over the first ``n_pages`` full prompt
    pages — digest[j] = H(digest[j-1] || page j's token bytes), byte-for-
    byte the engine's prefix-index chain (continuous._page_digests), so
    the adopt-side recomputation is an independent check that the bundle's
    prompt and digest chain agree with what the prefill side indexed."""
    out, h = [], b""
    for j in range(n_pages):
        h = hashlib.blake2b(
            prompt[j * page_size:(j + 1) * page_size].tobytes(),
            key=h, digest_size=_DIGEST_SIZE).digest()
        out.append(h)
    return out


class HandoffBundle:
    """Everything a decode replica needs to continue a request exactly
    where prefill left off. ``payloads`` is the engine's page export
    (opaque to this module — per-layer host arrays); ``digests`` is the
    chained prompt page-digest chain; ``tokens`` already includes every
    generated token (tok0 at minimum) so the adopter can replay them to
    the client stream; ``n_dispatched`` restores the engine invariant
    ``lengths[slot] = len(prompt) + n_dispatched - 1``."""

    __slots__ = ("rid", "seed", "sampling", "prompt", "tokens",
                 "n_generated", "n_dispatched", "max_new_tokens",
                 "eos_token_id", "timeout_s", "payloads", "digests",
                 "page_size", "generation", "t_publish")

    def __init__(self, rid, seed, sampling, prompt, tokens, n_generated,
                 n_dispatched, max_new_tokens, eos_token_id, timeout_s,
                 payloads, digests, page_size, generation):
        self.rid = int(rid)
        self.seed = int(seed)
        self.sampling = tuple(sampling)
        self.prompt = prompt
        self.tokens = list(tokens)
        self.n_generated = int(n_generated)
        self.n_dispatched = int(n_dispatched)
        self.max_new_tokens = int(max_new_tokens)
        self.eos_token_id = eos_token_id
        self.timeout_s = timeout_s
        self.payloads = payloads
        self.digests = list(digests)
        self.page_size = int(page_size)
        self.generation = int(generation)
        self.t_publish = None     # stamped by publish(); transfer_s metric

    def to_bytes(self):
        payload = wireformat.encode(
            {s: getattr(self, s) for s in self.__slots__})
        digest = hashlib.blake2b(payload, digest_size=_DIGEST_SIZE).digest()
        return _MAGIC + _LEN.pack(len(payload)) + digest + payload

    @classmethod
    def from_bytes(cls, data):
        """Parse + validate a frame. Any structural defect — wrong magic,
        short read, length mismatch, digest mismatch, undecodable payload —
        raises :class:`HandoffCorruptError`; there is no partial success.
        The payload decoder is :mod:`.wireformat`: non-executable by
        construction, so a frame from a hostile wire is refused, never
        interpreted."""
        hdr = len(_MAGIC) + _LEN.size + _DIGEST_SIZE
        if len(data) < hdr or not data.startswith(_MAGIC):
            raise HandoffCorruptError("bundle frame torn or foreign")
        (n,) = _LEN.unpack(data[len(_MAGIC):len(_MAGIC) + _LEN.size])
        digest = data[len(_MAGIC) + _LEN.size:hdr]
        payload = data[hdr:]
        if len(payload) != n:
            raise HandoffCorruptError(
                f"bundle payload truncated: {len(payload)}/{n} bytes")
        if hashlib.blake2b(payload, digest_size=_DIGEST_SIZE).digest() != digest:
            raise HandoffCorruptError("bundle payload digest mismatch")
        try:
            fields = wireformat.decode(payload)
        except Exception as e:
            raise HandoffCorruptError(f"bundle payload unreadable: {e}")
        bundle = cls.__new__(cls)
        try:
            for s in cls.__slots__:
                setattr(bundle, s, fields[s])
        except (KeyError, TypeError) as e:
            raise HandoffCorruptError(f"bundle missing field {e}")
        return bundle

    def verify_prompt_digests(self):
        """Independent adopt-side check: recompute the chained page digests
        from the bundle's own prompt and compare against the chain the
        prefill engine computed. A mismatch means the prompt bytes and the
        digest chain disagree — some part of the bundle is lying — and the
        only safe answer is re-prefill."""
        import numpy as np

        p = np.asarray(self.prompt, np.int32).reshape(-1)
        n = len(self.digests)
        if n and page_digests(p, self.page_size, n) != self.digests:
            raise HandoffCorruptError(
                f"rid {self.rid}: prompt page-digest chain mismatch")


class HandoffManager:
    """Publish/adopt bundles through a spool directory with deadlines,
    bounded-backoff retry, and generation fencing. All knobs come from
    ``PADDLE_HANDOFF_*`` env vars unless passed explicitly; ``clock`` and
    ``sleep`` are injectable so tests step time instead of sleeping."""

    def __init__(self, spool_dir=None, deadline_s=None, retries=None,
                 backoff_s=None, clock=time.monotonic, sleep=time.sleep):
        self.spool_dir = (spool_dir or env_str("PADDLE_HANDOFF_DIR")
                          or os.path.join(tempfile.gettempdir(),
                                          "paddle_tpu_torch_handoff"))
        self.deadline_s = (env_float("PADDLE_HANDOFF_DEADLINE_S", 5.0)
                           if deadline_s is None else float(deadline_s))
        self.retries = (env_int("PADDLE_HANDOFF_RETRIES", 2)
                        if retries is None else int(retries))
        self.backoff_s = (env_float("PADDLE_HANDOFF_BACKOFF_S", 0.05)
                          if backoff_s is None else float(backoff_s))
        self.clock = clock
        self.sleep = sleep
        os.makedirs(self.spool_dir, exist_ok=True)

    def _path(self, bundle):
        return os.path.join(self.spool_dir,
                            f"handoff-{bundle.rid}-g{bundle.generation}.bin")

    def publish(self, bundle):
        """Write ``bundle`` atomically into the spool; returns its path.
        Each attempt fires the ``serving.handoff.send`` chaos seam; a
        transient failure retries with exponential backoff as long as both
        the attempt budget and the deadline allow. Exhaustion raises
        :class:`HandoffError` — the caller's cue to complete the request
        in blended mode (nothing was detached yet, so nothing is lost)."""
        bundle.t_publish = time.time()
        data = bundle.to_bytes()
        path = self._path(bundle)
        t0 = self.clock()
        attempt = 0
        while True:
            try:
                chaos.site("serving.handoff.send")
                atomic_write(
                    path, lambda f: f.write(data),
                    # the torn-bundle seam: a chaos `truncate` here commits
                    # a short file that from_bytes' digest gate must catch
                    before_commit=lambda tmp: chaos.site(
                        "serving.handoff.corrupt", path=tmp))
                _M_PUBLISHED.inc()
                return path
            except HandoffError:
                raise
            except Exception as e:
                attempt += 1
                delay = self.backoff_s * (2 ** (attempt - 1))
                if (attempt > self.retries
                        or self.clock() - t0 + delay > self.deadline_s):
                    raise HandoffError(
                        f"rid {bundle.rid}: publish failed after "
                        f"{attempt} attempt(s): {e}")
                _M_SEND_RETRIES.inc()
                self.sleep(delay)

    def load(self, path, expected_generation=None):
        """Read, validate, and CONSUME the bundle at ``path``. Fires the
        ``serving.handoff.adopt`` chaos seam first (an injected fault here
        models a decode replica dying mid-adopt). Validation failures
        raise :class:`HandoffCorruptError`; a generation mismatch raises
        :class:`StaleHandoffError`. The spool file is removed in every
        outcome — corrupt and stale bundles are garbage, and a validated
        bundle's pages now live in the adopter's pool."""
        chaos.site("serving.handoff.adopt")
        try:
            try:
                with open(path, "rb") as f:
                    data = f.read()
            except OSError as e:
                raise HandoffCorruptError(f"bundle unreadable: {e}")
            bundle = HandoffBundle.from_bytes(data)
            bundle.verify_prompt_digests()
            if (expected_generation is not None
                    and bundle.generation != expected_generation):
                _M_STALE.inc()
                raise StaleHandoffError(
                    f"rid {bundle.rid}: bundle generation "
                    f"{bundle.generation} != expected {expected_generation}")
        except HandoffCorruptError:
            _M_CORRUPT.inc()
            self.discard(path)
            raise
        except StaleHandoffError:
            self.discard(path)
            raise
        self.discard(path)
        _M_ADOPTED.inc()
        if bundle.t_publish is not None:
            _M_TRANSFER.observe(max(0.0, time.time() - bundle.t_publish))
        return bundle

    @staticmethod
    def discard(path):
        try:
            os.remove(path)
        except OSError:
            pass
