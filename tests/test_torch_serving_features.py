"""Port parity: the serving engine's int8 KV pools, prefix cache and
sampling, against the JAX reference engine on the CPU (its ragged path,
math tiers) on the same weights.

- int8 pools, greedy: prompts of 3 to 41 tokens and one of 300 that
  crosses the 256-token ragged chunk; token ids identical, the pools
  smaller than the float engine's, and the reference's two refusals
  (int8 with ``prefill_chunk``, int8 with the prefix cache) raise;
- prefix cache, float pools: a shared 48-token system prompt under
  different suffixes over several ``serve()`` calls, in a pool large
  enough to keep every page and in pools small enough to force LRU
  evictions; token ids and ``prefix_hit_pages`` / ``prefix_evictions``
  identical, ``pages_in_use()`` equal to the pool scan at quiet points,
  and a parameter changed in place clears the cache;
- sampling (the port alone: the two engines' noise streams differ): a
  request's tokens are the same alone or with co-tenants, the same seed
  repeats them and another seed changes them, ``top_k=1`` equals greedy,
  and a request that samples otherwise than the running group is
  deferred; the shapes of ``sampling_overrides`` and ``adapters``.
Each reference engine is built inside its test (it holds process-wide
locks and registries).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference.continuous import (
    ContinuousBatchingEngine as JaxEngine,
)
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.models.llama import llama_tiny as jax_tiny
from paddle_tpu_torch.inference.continuous import (
    GREEDY_SAMPLING, ContinuousBatchingEngine, EngineRequest,
    canonical_sampling,
)
from paddle_tpu_torch.models.convert import load_paddle_tpu_state
from paddle_tpu_torch.models.llama import LlamaForCausalLM, llama_tiny

NEW = 8


@pytest.fixture(scope="module")
def models():
    paddle.seed(31)
    jm = JaxLlama(jax_tiny(num_hidden_layers=2, max_position_embeddings=512))
    jm.eval()
    arrays = {n: np.asarray(p._data) for n, p in jm.named_parameters()}
    tm = LlamaForCausalLM(
        llama_tiny(num_hidden_layers=2, max_position_embeddings=512),
        device="cpu")
    load_paddle_tpu_state(tm, arrays)
    return jm, tm


def _prompts(seed, lens):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, 128, n).astype(np.int32) for n in lens]


def _assert_same(want, got):
    assert len(want) == len(got)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)


# ---- int8 pools ------------------------------------------------------------
INT8 = dict(max_seqs=4, page_size=16, max_len=512, kv_cache_dtype="int8")


@pytest.mark.parametrize("async_decode", [True, False])
def test_int8_pool_greedy_tokens_identical(models, async_decode):
    jm, tm = models
    prompts = _prompts(19, (3, 17, 41, 9, 28, 300))
    want = JaxEngine(jm, **INT8).serve(prompts, max_new_tokens=NEW)
    eng = ContinuousBatchingEngine(tm, async_decode=async_decode,
                                   device="cpu", **INT8)
    assert eng._ragged_chunk == 256
    got = eng.serve(prompts, max_new_tokens=NEW)
    _assert_same(want, got)
    assert len(eng.free_pages) == eng.num_pages - 1
    k, v = eng.pools[0]
    assert k.weight.dtype == torch.int8 and k.scales.dtype == torch.float32
    assert tuple(k.scales.shape) == tuple(k.weight.shape[:3]) + (1,)
    float_eng = ContinuousBatchingEngine(
        tm, max_seqs=4, page_size=16, max_len=512, device="cpu")
    assert eng.pool_bytes() < float_eng.pool_bytes()
    # codes + one f32 scale per row of head_dim values
    d = tm.config.head_dim
    assert eng.pool_bytes() * 4 * d == float_eng.pool_bytes() * (d + 4)


def test_int8_refusals_match_reference(models):
    jm, tm = models
    for kw in (dict(prefill_chunk=64), dict(enable_prefix_cache=True)):
        with pytest.raises(ValueError) as want:
            JaxEngine(jm, **INT8, **kw)
        with pytest.raises(ValueError) as got:
            ContinuousBatchingEngine(tm, device="cpu", **INT8, **kw)
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="unsupported kv_cache_dtype"):
        ContinuousBatchingEngine(tm, device="cpu", kv_cache_dtype="fp8")


# ---- prefix cache ------------------------------------------------------------
def _prefix_batches():
    """Three serve() calls: prompts sharing a 48-token system prompt (3
    full pages) under different suffixes, unrelated prompts, then the
    first batch again."""
    rng = np.random.RandomState(5)
    system = rng.randint(1, 128, 48).astype(np.int32)

    def shared(lens):
        return [np.concatenate([system, rng.randint(1, 128, n)
                                .astype(np.int32)]) for n in lens]

    first = shared((5, 20, 9))
    return [first, shared((13, 2, 30, 7)),
            [rng.randint(1, 128, n).astype(np.int32) for n in (70, 50, 90)],
            first]


def _quiet_invariant(eng):
    assert eng.pages_in_use() == (eng.num_pages - 1 - len(eng.free_pages)
                                  - len(eng._evictable))


@pytest.mark.parametrize("num_pages", [None, 10, 14])
def test_prefix_cache_tokens_and_stats_identical(models, num_pages):
    jm, tm = models
    kw = dict(max_seqs=4, page_size=16, max_len=256, num_pages=num_pages,
              enable_prefix_cache=True)
    ref = JaxEngine(jm, **kw)
    eng = ContinuousBatchingEngine(tm, device="cpu", **kw)
    for batch in _prefix_batches():
        _assert_same(ref.serve(batch, max_new_tokens=6),
                     eng.serve(batch, max_new_tokens=6))
        for key in ("prefix_hit_pages", "prefix_evictions"):
            assert eng.stats[key] == ref.stats[key], key
        assert eng.pages_in_use() == ref.pages_in_use() == 0
        _quiet_invariant(eng)
    assert eng.stats["prefix_hit_pages"] > 0
    if num_pages is not None:
        assert eng.stats["prefix_evictions"] > 0
    else:
        assert eng.stats["prefix_evictions"] == 0
    system_prompt = _prefix_batches()[0][0]
    assert eng.prefix_match_pages(system_prompt) == \
        ref.prefix_match_pages(system_prompt)


def test_prefix_cache_cleared_when_weights_change(models):
    _, tm = models
    eng = ContinuousBatchingEngine(tm, max_seqs=4, page_size=16, max_len=256,
                                   enable_prefix_cache=True, device="cpu")
    first = _prefix_batches()[0]
    eng.serve(first, max_new_tokens=4)
    eng.serve(first, max_new_tokens=4)
    hits = eng.stats["prefix_hit_pages"]
    assert hits > 0 and eng.prefix_match_pages(first[0]) > 0
    weight = tm.llama.layers[0].mlp.up_proj.weight
    with torch.no_grad():
        weight.mul_(1.0)    # in place: the values stay, the version moves
    eng.serve(first, max_new_tokens=4)
    assert eng.stats["prefix_hit_pages"] == hits    # no hit afterwards
    _quiet_invariant(eng)


# ---- sampling ----------------------------------------------------------------
SAMPLED = dict(do_sample=True, temperature=0.8, top_p=0.9)
SMALL = dict(max_seqs=4, page_size=16, max_len=256)


@pytest.fixture(scope="module")
def sampled(models):
    _, tm = models
    prompts = _prompts(0, (12, 30, 7, 45, 20))
    eng = ContinuousBatchingEngine(tm, device="cpu", **SMALL)
    return eng, prompts, eng.serve(prompts, 16, seed=1, **SAMPLED)


def test_sampled_tokens_do_not_depend_on_co_tenants(sampled):
    eng, prompts, together = sampled
    alone = eng.serve(prompts[:1], 16, seed=1, **SAMPLED)
    np.testing.assert_array_equal(alone[0], together[0])
    # rid 0 served in the sync pipeline, beside other co-tenants
    sync = ContinuousBatchingEngine(eng.model, async_decode=False,
                                    device="cpu", **SMALL)
    mixed = sync.serve([prompts[0], prompts[3]], 16, seed=1, **SAMPLED)
    np.testing.assert_array_equal(mixed[0], together[0])


def test_sampled_seed_repeats_and_another_seed_differs(sampled):
    eng, prompts, together = sampled
    _assert_same(together, eng.serve(prompts, 16, seed=1, **SAMPLED))
    other = eng.serve(prompts, 16, seed=2, **SAMPLED)
    assert not any(np.array_equal(a, b) for a, b in zip(other, together))
    greedy = eng.serve(prompts, 16)
    assert not all(np.array_equal(a, b) for a, b in zip(greedy, together))


def test_top_k_one_equals_greedy(sampled):
    eng, prompts, _ = sampled
    _assert_same(eng.serve(prompts, 16),
                 eng.serve(prompts, 16, do_sample=True, top_k=1, seed=4))


def test_other_sampling_is_deferred_not_mixed_in(sampled):
    eng, prompts, _ = sampled
    hot = canonical_sampling(True, 0.8, 0, 0.9)
    a = EngineRequest(0, prompts[0], 4, sampling=hot, seed=1)
    b = EngineRequest(1, prompts[1], 4, sampling=GREEDY_SAMPLING)
    c = EngineRequest(2, prompts[2], 4, sampling=hot, seed=1)
    assert eng.try_admit_one(a) == "admitted"
    assert eng.try_admit_one(b) == "deferred"
    assert eng.try_admit_one(c) == "admitted"
    retired = eng.drain()
    assert {r.rid for r in retired} == {0, 2}
    assert eng.try_admit_one(b) == "admitted"   # the group drained
    assert [r.rid for r in eng.drain()] == [1]
    assert len(eng.free_pages) == eng.num_pages - 1


def test_serve_option_shapes_match_reference(models, sampled):
    """``sampling_overrides`` and ``adapters`` (held against the reference
    in tests/test_torch_serving_hooks.py and tests/test_torch_lora.py):
    a list covering every request, and empty overrides or no adapters,
    serve the default group's tokens; a short list raises the reference's
    ValueError before any admission."""
    jm, _ = models
    eng, prompts, together = sampled
    n = len(prompts)
    greedy = eng.serve(prompts, 16)
    _assert_same(greedy, eng.serve(prompts, 16, sampling_overrides=[{}] * n,
                                   adapters=[None] * n))
    _assert_same(together, eng.serve(prompts, 16, seed=1,
                                     sampling_overrides={}, **SAMPLED))
    ref = JaxEngine(jm, **SMALL)
    for kw in (dict(sampling_overrides=[{}]), dict(adapters=[None])):
        with pytest.raises(ValueError) as got:
            eng.serve(prompts, 4, **kw)
        with pytest.raises(ValueError) as want:
            ref.serve(prompts, 4, **kw)
        assert str(got.value) == str(want.value)
    assert eng.idle()


# ---- per-request max_new_tokens --------------------------------------------
def test_max_new_tokens_dict_tokens_identical(models):
    """A complete {rid: n} dict gives the reference engine's tokens, each
    request stopping at its own count; a dict missing a rid raises
    ValueError in both engines."""
    jm, tm = models
    prompts = _prompts(23, (5, 33, 12, 20))
    per = {0: 3, 1: 9, 2: 1, 3: 6}
    kw = dict(max_seqs=4, page_size=16, max_len=256)
    want = JaxEngine(jm, **kw).serve(prompts, max_new_tokens=per)
    eng = ContinuousBatchingEngine(tm, device="cpu", **kw)
    got = eng.serve(prompts, max_new_tokens=per)
    _assert_same(want, got)
    assert [len(g) - len(p) for g, p in zip(got, prompts)] == [3, 9, 1, 6]
    short = {0: 3, 1: 9, 3: 6}
    with pytest.raises(ValueError, match="missing rids"):
        JaxEngine(jm, **kw).serve(prompts, max_new_tokens=short)
    with pytest.raises(ValueError, match="missing rids"):
        eng.serve(prompts, max_new_tokens=short)
