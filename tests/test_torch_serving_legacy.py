"""Port parity: the engine's legacy ladder (``ragged=False``: the bucketed
prefill through the fixed-shape dense caches, the page insert, the
power-of-two decode blocks, the prefix cache's gather and suffix prefill,
the ``prefill_chunk`` ladder, the caps clamp) against the JAX reference's
``ragged=False`` engine on the CPU, on the same weights
(``models/convert.py``).

Every reference engine here runs ``async_decode=False``: the reference's
async pipeline gives run-to-run different tokens on the CPU (ROADMAP.md
§3), its sync pipeline does not, and the port's tokens do not depend on
the pipeline. One reference engine per configuration, module-scoped.

- float pools, greedy, the port's ``async_decode`` on and off: token ids
  identical; the program families dispatched (``_warm``) identical to the
  reference's in the sync pipeline;
- int8 pools, greedy: token ids identical, and the legacy insert's codes
  and scales identical bit for bit to the reference's on the same dense
  K/V, a bucket shorter than a page included;
- the prefix cache over two serves: tokens, ``prefix_hit_pages``,
  ``prefix_evictions`` and the ``serve.prefix.*`` counters identical;
- ``prefill_chunk``: the page-aligned rounding (40 -> 32 at page 16) and a
  three-chunk ladder: tokens, program families and ``serve.prefill_chunks``
  identical;
- per-request budgets in one block (the caps clamp): a request ending at
  ``max_len`` beside co-tenants with larger budgets, tokens identical;
- the reference's refusals (too long for ``max_len``, larger than the
  pool) carry the same messages.
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
from paddle_tpu.observability.metrics import registry as jax_registry
from paddle_tpu_torch.inference.continuous import ContinuousBatchingEngine
from paddle_tpu_torch.models.convert import load_paddle_tpu_state
from paddle_tpu_torch.models.llama import LlamaForCausalLM, llama_tiny
from paddle_tpu_torch.observability.metrics import registry

NEW = 8
BASE = dict(max_seqs=4, page_size=16, max_len=256, decode_block=4,
            ragged=False)


@pytest.fixture(scope="module")
def models():
    paddle.seed(41)
    jm = JaxLlama(jax_tiny(num_hidden_layers=2, max_position_embeddings=512))
    jm.eval()
    tm = LlamaForCausalLM(
        llama_tiny(num_hidden_layers=2, max_position_embeddings=512),
        device="cpu")
    load_paddle_tpu_state(tm, {n: np.asarray(p._data)
                               for n, p in jm.named_parameters()})
    return jm, tm


def _prompts(seed, lens):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, 128, n).astype(np.int32) for n in lens]


def _same(want, got):
    assert len(want) == len(got)
    for w, g in zip(want, got):
        if w is None:
            assert g is None
        else:
            np.testing.assert_array_equal(g, w)


def _keys(warm):
    return sorted(map(str, warm))


def _counter(reg, name):
    m = reg.get(name)
    return 0 if m is None else m.value


PROMPTS = _prompts(7, (3, 17, 41, 9, 28, 70))


@pytest.fixture(scope="module")
def float_ref(models):
    jm, _ = models
    eng = JaxEngine(jm, async_decode=False, **BASE)
    return eng, eng.serve(PROMPTS, max_new_tokens=NEW)


@pytest.mark.parametrize("async_decode", [True, False])
def test_float_greedy_tokens_identical(models, float_ref, async_decode):
    _, tm = models
    ref, want = float_ref
    eng = ContinuousBatchingEngine(tm, async_decode=async_decode,
                                   device="cpu", **BASE)
    assert eng._ragged is False
    _same(want, eng.serve(PROMPTS, max_new_tokens=NEW))
    assert len(eng.free_pages) == eng.num_pages - 1
    assert eng.stats["peak_pages"] == ref.stats["peak_pages"]
    if not async_decode:
        # the same program families: per-bucket prefill and insert, the
        # single step and the power-of-two blocks
        assert _keys(eng._warm) == _keys(ref._warm)
        assert eng.stats == ref.stats


def test_int8_greedy_tokens_and_insert_codes_identical(models):
    jm, tm = models
    kw = dict(BASE, kv_cache_dtype="int8")
    ref = JaxEngine(jm, async_decode=False, **kw)
    eng = ContinuousBatchingEngine(tm, device="cpu", **kw)
    prompts = PROMPTS[:4]
    _same(ref.serve(prompts, max_new_tokens=NEW),
          eng.serve(prompts, max_new_tokens=NEW))
    # the insert on the same dense K/V: 2 pages of a 32-token bucket
    rng = np.random.RandomState(3)
    shape = (2, 32, tm.config.num_key_value_heads, tm.config.head_dim)
    ks = (rng.randn(*shape) * 3).astype(np.float32)
    vs = rng.randn(*shape).astype(np.float32)
    ks[0, 5] = 0.0                      # an all-zero row
    pages = [3, 7]
    pools = ref._insert(32)(tuple(ref.pools), ks, vs, np.asarray(pages,
                                                                 np.int32))
    eng._insert(torch.from_numpy(ks), torch.from_numpy(vs), pages)
    for (jk, jv), (tk, tv) in zip(pools, eng.pools):
        for j, t in ((jk, tk), (jv, tv)):
            np.testing.assert_array_equal(
                t.weight[:, pages].numpy(), np.asarray(j.weight)[:, pages])
            np.testing.assert_array_equal(
                t.scales[:, pages].numpy().view(np.int32),
                np.asarray(j.scales)[:, pages].view(np.int32))


def test_int8_insert_pads_a_bucket_shorter_than_a_page(models):
    """A 16-token bucket under page_size 32 writes one whole page; the
    pad rows quantize zeros (code 0, scale 0) as the reference's do."""
    jm, tm = models
    kw = dict(max_seqs=2, page_size=32, max_len=128, ragged=False,
              kv_cache_dtype="int8")
    ref = JaxEngine(jm, async_decode=False, **kw)
    eng = ContinuousBatchingEngine(tm, device="cpu", **kw)
    rng = np.random.RandomState(4)
    shape = (2, 16, tm.config.num_key_value_heads, tm.config.head_dim)
    ks, vs = (rng.randn(*shape).astype(np.float32) for _ in range(2))
    pools = ref._insert(16)(tuple(ref.pools), ks, vs, np.asarray([2],
                                                                 np.int32))
    eng._insert(torch.from_numpy(ks), torch.from_numpy(vs), [2])
    for (jk, _), (tk, _) in zip(pools, eng.pools):
        np.testing.assert_array_equal(tk.weight[:, 2].numpy(),
                                      np.asarray(jk.weight)[:, 2])
        np.testing.assert_array_equal(
            tk.scales[:, 2].numpy().view(np.int32),
            np.asarray(jk.scales)[:, 2].view(np.int32))
        assert not tk.scales[:, 2, 16:].any()


def _prefix_batches():
    rng = np.random.RandomState(5)
    system = rng.randint(1, 128, 48).astype(np.int32)
    return [[np.concatenate([system, rng.randint(1, 128, n)
                             .astype(np.int32)]) for n in lens]
            for lens in ((5, 20, 9), (13, 2, 30))]


def test_prefix_cache_hits_and_lookups_identical(models):
    jm, tm = models
    kw = dict(BASE, max_len=128, enable_prefix_cache=True)
    ref = JaxEngine(jm, async_decode=False, **kw)
    eng = ContinuousBatchingEngine(tm, device="cpu", **kw)
    names = ("serve.prefix.hit_pages", "serve.prefix.lookup_pages")
    for batch in _prefix_batches():
        j0 = [_counter(jax_registry, n) for n in names]
        t0 = [_counter(registry, n) for n in names]
        _same(ref.serve(batch, max_new_tokens=6),
              eng.serve(batch, max_new_tokens=6))
        assert ([_counter(registry, n) - t for n, t in zip(names, t0)]
                == [_counter(jax_registry, n) - j
                    for n, j in zip(names, j0)])
        for key in ("prefix_hit_pages", "prefix_evictions"):
            assert eng.stats[key] == ref.stats[key], key
    assert eng.stats["prefix_hit_pages"] > 0
    assert _keys(eng._warm) == _keys(ref._warm)   # gather + suffix ran


def test_prefill_chunk_ladder_identical(models):
    jm, tm = models
    kw = dict(BASE, prefill_chunk=40)
    ref = JaxEngine(jm, async_decode=False, **kw)
    eng = ContinuousBatchingEngine(tm, device="cpu", **kw)
    assert eng.prefill_chunk == ref.prefill_chunk == 32   # page-aligned
    prompts = _prompts(11, (90, 12, 40))
    assert eng._chunk_plan(90) == ref._chunk_plan(90) == (2, 26, 6)
    name = "serve.prefill_chunks"
    j0, t0 = _counter(jax_registry, name), _counter(registry, name)
    _same(ref.serve(prompts, max_new_tokens=NEW),
          eng.serve(prompts, max_new_tokens=NEW))
    chunks = _counter(registry, name) - t0
    assert chunks == _counter(jax_registry, name) - j0 == 5  # 3 + 2
    assert _keys(eng._warm) == _keys(ref._warm)


def test_per_request_caps_in_one_block(models, float_ref):
    """The async pipeline sizes a block by the largest budget, so rows
    with smaller ones run past their budget inside it: their writes must
    freeze at their last reserved position. Request 1 ends exactly at
    max_len; without the clamp its overshoot would index past its
    page-table row."""
    _, tm = models
    ref, _ = float_ref
    prompts = _prompts(13, (6, 250, 20, 33))
    budgets = [9, 6, 2, 13]
    want = ref.serve(prompts, max_new_tokens=budgets)
    eng = ContinuousBatchingEngine(tm, decode_block=8, device="cpu",
                                   **{k: v for k, v in BASE.items()
                                      if k != "decode_block"})
    got = eng.serve(prompts, max_new_tokens=budgets)
    _same(want, got)
    assert [len(g) - len(p) for g, p in zip(got, prompts)] == budgets
    assert len(eng.free_pages) == eng.num_pages - 1


def test_refusals_carry_the_reference_messages(models, float_ref):
    jm, tm = models
    ref, _ = float_ref
    prompts = _prompts(17, (250, 9))
    eng = ContinuousBatchingEngine(tm, device="cpu", **BASE)
    _same(ref.serve(prompts, max_new_tokens=NEW),
          eng.serve(prompts, max_new_tokens=NEW))
    assert str(eng.request_errors[0]) == str(ref.request_errors[0])
    # a request the whole (idle) pool cannot hold fails alone
    kw = dict(BASE, num_pages=3)
    small_ref = JaxEngine(jm, async_decode=False, **kw)
    small = ContinuousBatchingEngine(tm, device="cpu", **kw)
    big = _prompts(19, (60,))
    assert small.serve(big, max_new_tokens=NEW) == [None]
    assert small_ref.serve(big, max_new_tokens=NEW) == [None]
    assert str(small.request_errors[0]) == str(small_ref.request_errors[0])
    assert small.stats["failed_requests"] == 1
