"""Port parity: the serving engine's hooks against the JAX reference on
the CPU, at ``llama_tiny`` sizes.

- ``sampling_overrides`` mixing greedy and sampled requests, by a list
  and by a sparse dict: token ids identical to the reference's, each
  sampled draw fed the reference's own Gumbel noise (its key schedule
  ``fold_in(fold_in(PRNGKey(seed), rid), i)``) through the port's noise
  seam, ``continuous.gumbel_noise``; the reference's shape refusals;
- ``EngineRequest.error_message`` as the reference renders it, and
  ``clone_for_retry`` (same rid and seed: the same sampled tokens on
  another engine);
- ``idle``, ``active_count``, ``has_free_slot`` and ``active_prefills``
  through an online ``try_admit_one``/``step``/``drain`` run, step by
  step equal to the reference's;
- the handoff: ``export_pages``'s payload equal to the reference's for
  the same request (f32, 1e-5); export, detach, adopt into a second
  engine gives one engine's tokens, and a reference export adopted by the
  port continues with the reference's tokens; adoption defers under a
  group that samples otherwise; an int8 export raises TypeError in both;
- ``_StampedRLock`` observed from two threads as the reference's is;
- ``warmup``: the program families it runs equal the reference's (the
  legacy ladder with the prefix cache, ``prefill_chunk`` and a shared
  prefix, greedy and sampled), and a sampled serve through the chunk
  ladder then gives the reference's tokens; after it ``stats`` are
  unchanged, the prefix cache is bypassed, and later tokens (greedy,
  sampled, through an adapter) equal an unwarmed engine's with no new
  program family.
The reference engines run ``async_decode=False`` (ROADMAP.md §3).
"""
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference import continuous as jax_continuous
from paddle_tpu.inference.continuous import (
    ContinuousBatchingEngine as JaxEngine,
)
from paddle_tpu.inference.continuous import EngineRequest as JaxRequest
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.models.llama import llama_tiny as jax_tiny
from paddle_tpu_torch.generation import request_keys
from paddle_tpu_torch.inference import continuous
from paddle_tpu_torch.inference.continuous import (
    ContinuousBatchingEngine, EngineRequest, canonical_sampling,
)
from paddle_tpu_torch.models.convert import load_paddle_tpu_state
from paddle_tpu_torch.models.llama import LlamaForCausalLM, llama_tiny
from paddle_tpu_torch.observability.metrics import registry
from paddle_tpu_torch.serving import LoRAAdapter

KW = dict(max_seqs=4, page_size=16, max_len=128, decode_block=4)
SAMPLED = dict(do_sample=True, temperature=0.8, top_p=0.9)
PROMPTS = [np.random.RandomState(21).randint(1, 128, n).astype(np.int32)
           for n in (6, 19, 11, 27)]


@pytest.fixture(scope="module")
def models():
    paddle.seed(47)
    jm = JaxLlama(jax_tiny(num_hidden_layers=2, max_position_embeddings=256))
    jm.eval()
    tm = LlamaForCausalLM(
        llama_tiny(num_hidden_layers=2, max_position_embeddings=256),
        device="cpu")
    load_paddle_tpu_state(tm, {n: np.asarray(p._data)
                               for n, p in jm.named_parameters()})
    return jm, tm


@pytest.fixture(scope="module")
def ref(models):
    """The reference's ragged engine, sync pipeline, shared by the tests
    that drive it the same way."""
    return JaxEngine(models[0], async_decode=False, **KW)


def _reference_noise(seed, n_rids):
    """``gumbel_noise`` replaced by the reference's draws: the row of
    request key request_keys(seed, rid) at token index i gets
    gumbel(fold_in(fold_in(PRNGKey(seed), rid), i), [1, V])."""
    keys = request_keys(torch.full((n_rids,), seed), torch.arange(n_rids))
    rid_of = {int(k): rid for rid, k in enumerate(keys)}

    def noise(keys, idx, vocab):
        rows = []
        for k, i in zip(keys.tolist(), idx.tolist()):
            rid = rid_of.get(k)
            if rid is None:                  # a slot that takes no part
                rows.append(np.zeros(vocab, np.float32))
                continue
            key = jax.random.fold_in(jax.random.fold_in(
                jax.random.PRNGKey(seed), rid), i)
            rows.append(np.asarray(jax.random.gumbel(
                key, (1, vocab), jnp.float32))[0])
        return torch.from_numpy(np.stack(rows))

    return noise


def _same(want, got):
    assert len(want) == len(got)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)


# ---- sampling overrides ------------------------------------------------------
@pytest.mark.parametrize("form", ["list", "dict"])
def test_sampling_overrides_tokens_identical(models, ref, monkeypatch, form):
    _, tm = models
    monkeypatch.setattr(continuous, "gumbel_noise", _reference_noise(3, 4))
    overrides = ([None, SAMPLED, {}, dict(SAMPLED, top_k=5)]
                 if form == "list" else {1: SAMPLED, 3: dict(SAMPLED,
                                                             top_k=5)})
    want = ref.serve(PROMPTS, 10, seed=3, sampling_overrides=overrides)
    eng = ContinuousBatchingEngine(tm, device="cpu", **KW)
    got = eng.serve(PROMPTS, 10, seed=3, sampling_overrides=overrides)
    _same(want, got)
    greedy = eng.serve(PROMPTS, 10)
    np.testing.assert_array_equal(got[0], greedy[0])
    np.testing.assert_array_equal(got[2], greedy[2])
    assert not np.array_equal(got[1], greedy[1])
    # a list must cover every request; a dict may be sparse
    with pytest.raises(ValueError) as g:
        eng.serve(PROMPTS, 2, sampling_overrides=[SAMPLED])
    with pytest.raises(ValueError) as w:
        ref.serve(PROMPTS, 2, sampling_overrides=[SAMPLED])
    assert str(g.value) == str(w.value)


# ---- error_message and clone_for_retry ----------------------------------------
def test_error_message_and_clone_for_retry(models, ref, monkeypatch):
    _, tm = models
    long = np.arange(1, 301, dtype=np.int32)
    got, want = EngineRequest(5, long, 4), JaxRequest(5, long, 4)
    eng = ContinuousBatchingEngine(tm, device="cpu", **KW)
    assert eng.try_admit_one(got) == ref.try_admit_one(want) == "failed"
    assert got.error_message == want.error_message
    assert got.error_message.startswith("ValueError: request 5: len 300")
    assert EngineRequest(1, long, 4).error_message is None
    monkeypatch.setattr(continuous, "gumbel_noise", _reference_noise(9, 3))
    req = EngineRequest(2, PROMPTS[1], 9, sampling=canonical_sampling(
        **SAMPLED), seed=9)
    clone = req.clone_for_retry()
    assert (clone.rid, clone.seed, clone.sampling, clone.t_enqueue) == (
        req.rid, req.seed, req.sampling, req.t_enqueue)
    assert not clone.finished and clone.tokens == []
    for r in (req, clone):
        e = ContinuousBatchingEngine(tm, device="cpu", **KW)
        assert e.try_admit_one(r) == "admitted"
        e.drain()
    np.testing.assert_array_equal(clone.result, req.result)
    jreq = JaxRequest(2, PROMPTS[1], 9, sampling=req.sampling, seed=9)
    assert ref.try_admit_one(jreq) == "admitted"
    ref.drain()
    np.testing.assert_array_equal(req.result, jreq.result)


# ---- online hooks -------------------------------------------------------------
def _online(engine, request, prompts):
    """Admit what fits, then step to the end: after each call, (idle,
    active_count, has_free_slot, active_prefills, retired rids)."""
    reqs = [request(i, p, 6) for i, p in enumerate(prompts)]
    trace = [[engine.try_admit_one(r) for r in reqs]]
    while not engine.idle():
        done = engine.step()
        trace.append((engine.idle(), engine.active_count(),
                      engine.has_free_slot(), engine.active_prefills(),
                      sorted(r.rid for r in done)))
    return trace, [r.result for r in reqs]


def test_online_hooks_step_by_step(models):
    jm, tm = models
    kw = dict(KW, max_seqs=2, prefill_chunk=32)
    prompts = [PROMPTS[0], np.random.RandomState(2).randint(1, 128, 90)
               .astype(np.int32)]
    eng = ContinuousBatchingEngine(tm, async_decode=False, device="cpu",
                                   **kw)
    assert (eng.idle(), eng.active_count(), eng.has_free_slot(),
            eng.active_prefills()) == (True, 0, True, 0)
    got, got_out = _online(eng, EngineRequest, prompts)
    want, want_out = _online(JaxEngine(jm, async_decode=False, **kw),
                             JaxRequest, prompts)
    assert got == want
    assert got[0] == ["admitted", "admitted"]
    assert max(t[3] for t in got[1:]) == 1       # the 90-token prompt
    _same(want_out, got_out)


# ---- the handoff --------------------------------------------------------------
def _started(engine, request, prompt, n=12):
    """A request admitted and one dispatch past its prefill."""
    req = request(0, prompt, n)
    assert engine.try_admit_one(req) == "admitted"
    while req.n_generated == 0:
        engine.step()
    assert not req.finished
    return req


def test_handoff_export_detach_adopt(models, ref):
    jm, tm = models
    prompt = PROMPTS[3]
    want = ref.serve([prompt], 12)[0]
    # the payload: the same pages as the reference's for the same request
    jreq = _started(ref, JaxRequest, prompt)
    a = ContinuousBatchingEngine(tm, async_decode=False, device="cpu", **KW)
    req = _started(a, EngineRequest, prompt)
    jpay, pay = ref.export_pages(jreq.slot), a.export_pages(req.slot)
    assert pay["n_pages"] == jpay["n_pages"] == len(req.pages)
    # the request's K/V: every position before its next feed token (the
    # rest of its pages is whatever the pool held)
    n = len(prompt) + req.n_dispatched - 1
    assert (n, req.tokens) == (len(prompt) + jreq.n_dispatched - 1,
                               jreq.tokens)
    for k in ("ks", "vs"):
        assert pay[k].shape == np.asarray(jpay[k]).shape
        assert pay[k].dtype == np.float32
        np.testing.assert_allclose(pay[k][:, :n], np.asarray(jpay[k])[:, :n],
                                   rtol=1e-5, atol=1e-5)
    # port -> port: detach, adopt, finish with one engine's tokens
    moved = a.detach_request(req.slot)
    assert moved is req and not req.finished and a.idle()
    assert len(a.free_pages) == a.num_pages - 1
    b = ContinuousBatchingEngine(tm, device="cpu", **KW)
    assert b.adopt_request(req, pay) == "admitted"
    assert b.lengths[req.slot] == len(prompt) + req.n_dispatched - 1
    b.drain()
    np.testing.assert_array_equal(req.result, want)
    # reference -> port: the reference's bundle continues on the port
    ref.detach_request(jreq.slot)
    cont = EngineRequest(jreq.rid, jreq.prompt, jreq.max_new_tokens)
    for f in ("tokens", "n_generated", "n_dispatched", "last_token",
              "t_first_token"):
        setattr(cont, f, getattr(jreq, f))
    cont.tokens = list(cont.tokens)
    c = ContinuousBatchingEngine(tm, device="cpu", **KW)
    assert c.adopt_request(cont, {k: np.asarray(v)
                                  for k, v in jpay.items()}) == "admitted"
    c.drain()
    np.testing.assert_array_equal(cont.result, want)


def test_adopt_defers_under_other_sampling_and_int8_export_raises(models,
                                                                   ref):
    jm, tm = models
    a = ContinuousBatchingEngine(tm, device="cpu", **KW)
    req = _started(a, EngineRequest, PROMPTS[0])
    pay = a.export_pages(req.slot)
    a.detach_request(req.slot)
    busy = ContinuousBatchingEngine(tm, device="cpu", **KW)
    sampled = EngineRequest(1, PROMPTS[1], 6,
                            sampling=canonical_sampling(**SAMPLED))
    assert busy.try_admit_one(sampled) == "admitted"
    assert busy.adopt_request(req, pay) == "deferred"
    busy.drain()
    assert busy.adopt_request(req, pay) == "admitted"
    busy.drain()
    q8 = dict(KW, kv_cache_dtype="int8")
    for engine, request in ((ContinuousBatchingEngine(tm, device="cpu",
                                                      **q8), EngineRequest),
                            (JaxEngine(jm, async_decode=False, **q8),
                             JaxRequest)):
        r = _started(engine, request, PROMPTS[2])
        with pytest.raises(TypeError):
            engine.export_pages(r.slot)


# ---- the dispatch lock --------------------------------------------------------
def _observe_lock(lock):
    """held_since/participants from a holder thread, a waiter thread and
    the main thread's non-blocking and reentrant acquires."""
    seen = []
    held, release = threading.Event(), threading.Event()

    def holder():
        with lock:
            held.set()
            release.wait(10)

    t = threading.Thread(target=holder)
    t.start()
    held.wait(10)
    seen.append(lock.held_since() is not None)
    seen.append(lock.participants() == {t.ident})
    w = threading.Thread(target=lambda: lock.acquire() and lock.release())
    w.start()
    deadline = time.monotonic() + 10
    while w.ident not in lock.participants() and time.monotonic() < deadline:
        time.sleep(0.001)
    seen.append(lock.participants() == {t.ident, w.ident})
    seen.append(lock.acquire(blocking=False))
    release.set()
    t.join()
    w.join()
    seen.append((lock.held_since(), lock.participants()))
    with lock:
        since = lock.held_since()
        with lock:
            seen.append(lock.held_since() == since)
        seen.append(lock.participants() == {threading.get_ident()})
    seen.append(lock.held_since())
    return seen


def test_stamped_rlock_from_two_threads():
    got = _observe_lock(continuous._StampedRLock())
    assert got == _observe_lock(jax_continuous._StampedRLock())
    assert got == [True, True, True, False, (None, set()), True, True, None]


def test_engines_share_an_injected_dispatch_lock(models):
    _, tm = models
    lock = continuous._StampedRLock()
    engines = [ContinuousBatchingEngine(tm, dispatch_lock=lock, device="cpu",
                                        **KW) for _ in range(2)]
    assert engines[0].dispatch_lock is engines[1].dispatch_lock is lock
    held = []
    orig = ContinuousBatchingEngine._decode_block

    def spy(self, *a, **k):
        held.append(lock.participants() == {threading.get_ident()})
        return orig(self, *a, **k)

    ContinuousBatchingEngine._decode_block = spy
    try:
        engines[0].serve(PROMPTS[:1], 6)
    finally:
        ContinuousBatchingEngine._decode_block = orig
    assert held and all(held) and lock.held_since() is None


# ---- warmup -------------------------------------------------------------------
def test_warmup_runs_the_reference_program_families(models, monkeypatch):
    """The legacy ladder with the prefix cache, ``prefill_chunk`` and a
    shared prefix, greedy and sampled: the same program families as the
    reference's warmup (chunk ladders, gathers and suffix prefills
    included); then a sampled serve through the chunk ladder gives the
    reference's tokens for its noise."""
    jm, tm = models
    kw = dict(KW, ragged=False, enable_prefix_cache=True, prefill_chunk=32)
    warm_kw = dict(shared_prefix_lens=(32,), sampling=[
        canonical_sampling(False), canonical_sampling(**SAMPLED)])
    want = JaxEngine(jm, async_decode=False, **kw)
    want.warmup([6, 19, 70], **warm_kw)
    got = ContinuousBatchingEngine(tm, async_decode=False, device="cpu",
                                   **kw)
    got.warmup([6, 19, 70], **warm_kw)
    assert sorted(map(str, got._warm)) == sorted(map(str, want._warm))
    assert ("suffix", 2, 32, canonical_sampling(**SAMPLED)) in got._warm
    assert got.stats == want.stats
    monkeypatch.setattr(continuous, "gumbel_noise", _reference_noise(5, 5))
    prompts = PROMPTS + [np.random.RandomState(4).randint(1, 128, 70)
                         .astype(np.int32)]
    _same(want.serve(prompts, 6, seed=5, **SAMPLED),
          got.serve(prompts, 6, seed=5, **SAMPLED))


@pytest.mark.parametrize("ragged", [True, False])
def test_warmup_keeps_stats_and_streams(models, ragged):
    _, tm = models
    kw = dict(KW, ragged=ragged)
    warm = ContinuousBatchingEngine(tm, device="cpu", **kw)
    cold = ContinuousBatchingEngine(tm, device="cpu", **kw)
    hist = registry.get("serve.compile_warmup_s")
    n0 = hist.count
    stats = dict(warm.stats)
    sampled = canonical_sampling(**SAMPLED)
    warm.warmup(buckets=[6, 19, 27], sampling=[canonical_sampling(False),
                                               sampled], lora_ranks=(4,))
    assert warm.stats == stats and hist.count == n0 + 1
    assert warm.idle() and len(warm.free_pages) == warm.num_pages - 1
    programs = set(warm._warm)
    rng = np.random.RandomState(8)
    ad = LoRAAdapter("tone", rng.randn(64, 4).astype(np.float32),
                     rng.randn(4, 128).astype(np.float32))
    for serve_kw in ({}, dict(SAMPLED, seed=2), dict(adapters=ad)):
        _same(cold.serve(PROMPTS, 7, **serve_kw),
              warm.serve(PROMPTS, 7, **serve_kw))
    assert set(warm._warm) == programs   # every family ran in warmup
    # the prefix cache is bypassed: the full prefills run, nothing stays
    # indexed, and the switch comes back on
    cached = ContinuousBatchingEngine(tm, enable_prefix_cache=True,
                                      device="cpu", **kw)
    cached.warmup([20, 70])
    assert cached.enable_prefix_cache
    assert not cached._prefix_index and not cached._evictable
    if not ragged:
        assert {k[1] for k in cached._warm if k[0] == "prefill"} == {
            16, 32, 128}
